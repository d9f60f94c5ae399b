"""Host-side output emission for the whole-run device path.

Counterpart of the JAX package's `core/device_out.py`.  The whole-run
finalize (ops/sort_count.finalize_compact) leaves the passing nodes on the
device in crossing order; this module brings down what the native writers
need and feeds them, in one of two ways:

1. **Recompute path** (density scheme over reads that are already
   homopolymer-compressed): the finalize computes each node's four 128-bit
   (k-1)-overlap fingerprints and its record-relative minimizer positions
   on the device, and the native .sequences writer re-derives the minimizer
   values from the record's own bytes (native/seqwriter.cpp) — the [n, k]
   vectors never come down.  The fingerprints either come down for the host
   km_index join (64 B + 1 B per node) or stay on the device for the
   sort-join of ops/edge_join, which sends only the candidate list.  This
   path can be emitted in phases (PhasedEmitter).

2. **Vector path** (anything else, raw reads among it): the vectors come
   down in chunks, and each chunk feeds a native .sequences shard writer
   and the GFA builder's overlap keys while later chunks are still copying.

Copies to the host start when a LazyNodes is made: on a CUDA device they go
into pinned memory without blocking, each followed by an event that the
first reader waits on, so they run beside the host's formatting and
compression.

.sequences shard files map 1:1 to writer threads (`prefix.<i>.sequences`),
keeping rust-mdbg's multi-file glob contract (src/main.rs:616-630).
"""

from __future__ import annotations

import glob
import os
import sys
import threading
import time
import warnings

import numpy as np
import torch

from ..io.sequences import write_records_native
from ..ops.extract import _unpack_ext
from .graph import IncrementalGFA, _overlap_keys


def minimizer_recompute_ok(params) -> bool:
    """True when stored node sequences live in the same space the density
    hash ran over, so native/seqwriter.cpp can re-derive minimizer values
    from sequence bytes: plain density scheme (no syncmers/UHS/LCP/robust
    remap) over reads that are already homopolymer-compressed (otherwise
    device hashing is HPC-space while the stored seq is raw-space)."""
    return (getattr(params, "reads_already_hpc", False)
            and not params.use_syncmers
            and not params.uhs
            and not params.lcp
            and not params.has_lmer_counts)


#: LZ4 acceleration of the recompute path's .sequences shards
_LZ4_ACCEL = 2

#: finalize outputs that hold u32 values in int64 tensors (copied as int32)
_U32_FIELDS = ("meta", "count", "mpos")
#: finalize outputs that hold u64 bit patterns in int64 tensors
_U64_FIELDS = ("gk", "vec", "key_lo", "key_hi")


class _HostCopy:
    """One device-to-host copy, started at construction.  From a CUDA
    tensor it goes into pinned memory without blocking and numpy() waits
    for its event; a CPU tensor is handed through."""

    def __init__(self, name: str, t: torch.Tensor):
        self._name = name
        if name in _U32_FIELDS:
            t = t.to(torch.int32)
        self._ev = None
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = host.copy_(t, non_blocking=True)
            self._ev = torch.cuda.Event()
            self._ev.record()
        self._t = t

    def numpy(self) -> np.ndarray:
        if self._ev is not None:
            self._ev.synchronize()
            self._ev = None
        a = self._t.numpy()
        if self._name in _U32_FIELDS:
            return a.view(np.uint32)
        if self._name in _U64_FIELDS:
            return a.view(np.uint64)
        return a


class LazyNodes:
    """A finalize_compact result on the device, fetched piece by piece.

    Rows [0, row_lo) were emitted by an earlier phase (crossing order makes
    them an exact prefix of this result), so fetch() and vec_chunks() serve
    rows [row_lo, n_pass) only; fetch_full() serves every row.  The small
    fields (meta, count, mpos, and gflag + gk with want_gk) start their
    copies at construction; the vectors are copied in chunks of chunk_rows
    with want_vec.  want_gk=False leaves the fingerprints on the device for
    the edge join; want_vec=False is the recompute path.
    """

    def __init__(self, out: dict, row_lo: int = 0, want_vec: bool = True,
                 want_gk: bool = True, chunk_rows: int = 16384):
        self._out = out
        self.n_pass = out["n_pass"]
        self.row_lo = row_lo
        self.n_new = self.n_pass - row_lo
        self.chunk_rows = chunk_rows
        names = ["meta", "count", "mpos"]
        if want_gk:
            names += ["gflag", "gk"]
        self._pre = {name: _HostCopy(name, out[name][row_lo:])
                     for name in names if name in out}
        self._full: dict[str, _HostCopy] = {}
        self._chunks: list[tuple[int, _HostCopy]] = []
        if want_vec:
            self._stage_vec()

    def _stage_vec(self):
        for row0 in range(self.row_lo, self.n_pass, self.chunk_rows):
            self._chunks.append((row0 - self.row_lo, _HostCopy(
                "vec", self._out["vec"][row0 : row0 + self.chunk_rows])))

    def has(self, name: str) -> bool:
        return name in self._out

    def device(self, name: str) -> torch.Tensor:
        """The field as it lies on the device, every row."""
        return self._out[name]

    def fetch(self, name: str) -> np.ndarray:
        """Host array of rows [row_lo, n_pass): the phase's new nodes."""
        if name not in self._pre:
            self._pre[name] = _HostCopy(name, self._out[name][self.row_lo:])
        return self._pre[name].numpy()

    def prefetch_full(self, name: str) -> None:
        """Start the copy that fetch_full(name) will wait for."""
        if name not in self._full:
            self._full[name] = _HostCopy(name, self._out[name])

    def fetch_full(self, name: str) -> np.ndarray:
        """Host array of ALL rows [0, n_pass), whatever row_lo is (the
        whole-run abundances at the finish)."""
        self.prefetch_full(name)
        return self._full[name].numpy()

    def vec_chunks(self):
        """Yield (row0 - row_lo, vectors u64 [<= chunk_rows, k]) in row
        order.  The copies were started at construction (or start here,
        all at once, when a want_vec=False result is asked for its vectors
        after all), so later chunks copy while the caller works on this
        one."""
        if not self._chunks and self.n_new:
            self._stage_vec()
        for row0, copy in self._chunks:
            yield row0, copy.numpy()


def node_offsets(params, meta: np.ndarray, row_start_offsets: np.ndarray):
    """Decode the packed crossing meta into writer-ready arrays.

    Returns (shift0, shift1, seq_shift0, seq_shift1, rev, abs_start,
    abs_end): the first pair is the node-table/GFA pair (rust-mdbg's
    semantics), the second the exact-cut pair written to .sequences — equal
    unless the meta carries the extpack column (raw-input runs)."""
    seqlen = meta[:, 0].astype(np.int64)
    shift0 = (meta[:, 1] & 0x7FFFFFFF).astype(np.uint16)
    shift1 = (meta[:, 2] & 0x7FFFFFFF).astype(np.uint16)
    rev = (meta[:, 2] >> 31).astype(np.uint8)
    start = meta[:, 3].astype(np.int64)
    read_g = meta[:, 4].astype(np.int64)
    abs_start = row_start_offsets[read_g] + start
    abs_end = abs_start + seqlen + (params.l - 2)
    seq_shift0, seq_shift1 = shift0, shift1
    if meta.shape[1] > 5:
        ext_delta, de1 = _unpack_ext(meta[:, 5])
        abs_end = abs_end + ext_delta
        r = rev.astype(bool)
        seq_shift0 = np.where(r, shift0 + de1, shift0).astype(np.uint16)
        seq_shift1 = np.where(r, shift1, shift1 + de1).astype(np.uint16)
    return shift0, shift1, seq_shift0, seq_shift1, rev, abs_start, abs_end


def keys6_from_gk(gk: np.ndarray, gflag: np.ndarray) -> tuple:
    """(Fs, Fp, FsR, FpR, key_suf, key_pre) for the native km_index join
    from fetched overlap fingerprints gk u64 [n, 8] and their flags."""
    Fs, Fp, FsR, FpR = gk[:, 0:2], gk[:, 2:4], gk[:, 4:6], gk[:, 6:8]
    key_suf = np.where((gflag & 1).astype(bool)[:, None], Fs, FsR)
    key_pre = np.where((gflag & 2).astype(bool)[:, None], Fp, FpR)
    return Fs, Fp, FsR, FpR, key_suf, key_pre


def emit_device_outputs(prefix: str, params, nodes: LazyNodes,
                        reads_buf: np.ndarray, row_start_offsets: np.ndarray,
                        no_basespace: bool = False) -> dict:
    """Write the .sequences shards and the GFA from a LazyNodes.

    reads_buf: uint8 ASCII base buffer; node i's sequence is
    reads_buf[row_start_offsets[read_row] + start : ... + seqlen + l - 2]
    (plus the exact-cut correction for raw reads), reverse-complemented
    when the crossing occurrence was reversed.

    Returns the GFA writer's stats dict.
    """
    if nodes.has("gk") and minimizer_recompute_ok(params):
        em = PhasedEmitter(prefix, params, reads_buf, row_start_offsets,
                           no_basespace=no_basespace, cap_hint=nodes.n_pass)
        em.emit_phase(nodes)
        return em.finish(nodes.fetch_full("count"))

    meta = nodes.fetch("meta")
    count = nodes.fetch("count")
    n = nodes.n_pass
    index = np.arange(n, dtype=np.uint32)
    shift0, shift1, sq0, sq1, rev, abs_start, abs_end = node_offsets(
        params, meta, row_start_offsets)
    seqlen32 = meta[:, 0].astype(np.uint32)

    writers: list[threading.Thread] = []
    errors: list[BaseException] = []

    def write(*a):
        try:
            write_records_native(*a)
        except BaseException as e:  # raised after the join below
            errors.append(e)

    gfa = IncrementalGFA(cap_hint=n)
    try:
        for shard, (row0, vec) in enumerate(nodes.vec_chunks()):
            hi = row0 + len(vec)
            if not no_basespace:
                t = threading.Thread(
                    target=write,
                    args=(f"{prefix}.{shard}.sequences", params.k, params.l,
                          index[row0:hi], vec, reads_buf, abs_start[row0:hi],
                          abs_end[row0:hi], rev[row0:hi], sq0[row0:hi],
                          sq1[row0:hi]))
                t.start()
                writers.append(t)
            # overlap keys and the native index build for this chunk run
            # while the next chunks copy and the writer threads format
            gfa.add_chunk(index[row0:hi], count[row0:hi], seqlen32[row0:hi],
                          shift0[row0:hi], shift1[row0:hi],
                          _overlap_keys(vec))
        g = gfa.finish(f"{prefix}.gfa", presimp=params.presimp)
    finally:
        gfa.abort()
        for t in writers:
            t.join()
    if errors:
        raise errors[0]
    return g


class PhasedEmitter:
    """Recompute-path emission, one phase at a time.

    Each phase receives the nodes whose abundance CROSSING fell inside the
    phase's window range (a row range of the crossing-ordered finalize,
    ops/sort_count `prefix_rows` / `row_lo`); their .sequences records and
    GFA index rows are final at that point — only the abundance keeps
    growing, so the S-line KC values arrive late through `finish(counts)`
    (IncrementalGFA's deferred abundances).  Phases before the last run
    while the device is still counting later batches, so the emission work
    of the host (writers, LZ4, index build) hides under the construct loop
    instead of following it.

    Single-shot use (emit_device_outputs) is one emit_phase + finish."""

    def __init__(self, prefix, params, reads_buf, row_start_offsets,
                 no_basespace: bool = False, cap_hint: int = 0,
                 device_join: bool = False):
        self.prefix = prefix
        self.params = params
        self.reads_buf = reads_buf
        self.row_off = row_start_offsets
        self.no_basespace = no_basespace
        # device_join: the edges arrive as a device-joined POT list at the
        # finish (ops/edge_join); phases feed no fingerprints and build no
        # km_index
        self.device_join = device_join
        self.gfa = IncrementalGFA(cap_hint=cap_hint, defer_abundance=True)
        self.writers: list[threading.Thread] = []
        self.errors: list[BaseException] = []
        self.shard = 0
        self.id_base = 0
        self._phases: list[tuple] = []  # for the rewrite after a gate fault
        self._meta_parts: list[tuple] = []  # (seqlen32, shift0, shift1)
        self.edge_join = None  # which join made the edges, set by finish

    def _write(self, *a, **kw):
        try:
            write_records_native(*a, **kw)
        except BaseException as e:  # surfaced at finish
            self.errors.append(e)

    def emit_phase(self, nodes: LazyNodes, n_shards: int = 8,
                   reads_buf=None, row_off=None):
        """reads_buf/row_off override the constructor's (a streaming caller
        snapshots only the reads a phase can reference: a phase's crossing
        metadata never points past its own window range)."""
        p = self.params
        rb = self.reads_buf if reads_buf is None else reads_buf
        ro = self.row_off if row_off is None else row_off
        n = nodes.n_new
        if n == 0:
            return
        meta = nodes.fetch("meta")
        index = np.arange(self.id_base, self.id_base + n, dtype=np.uint32)
        self.id_base += n
        shift0, shift1, sq0, sq1, rev, abs_start, abs_end = node_offsets(
            p, meta, ro)
        seqlen32 = meta[:, 0].astype(np.uint32)

        if not self.no_basespace:
            # record-space minimizer positions from the device: the writer
            # hashes k l-mers per node instead of rolling over every base
            mpos = nodes.fetch("mpos") if nodes.has("mpos") else None
            n_shards = max(1, min(n_shards, (n + 4095) // 4096))
            bounds = np.linspace(0, n, n_shards + 1).astype(int)
            for s in range(n_shards):
                a, b = bounds[s], bounds[s + 1]
                t = threading.Thread(
                    target=self._write,
                    args=(f"{self.prefix}.{self.shard}.sequences", p.k, p.l,
                          index[a:b], None, rb, abs_start[a:b],
                          abs_end[a:b], rev[a:b], sq0[a:b], sq1[a:b]),
                    kwargs=dict(hash_bound=p.hash_bound, accel=_LZ4_ACCEL,
                                mpos=None if mpos is None else mpos[a:b]),
                )
                t.start()
                self.writers.append(t)
                self.shard += 1

        zeros = np.zeros(n, np.uint32)  # abundances arrive at the finish
        if self.device_join:
            # the keys stay on the device: S-line data only
            self.gfa.add_chunk(index, zeros, seqlen32, shift0, shift1, None)
            self._meta_parts.append((seqlen32, shift0, shift1))
        else:
            # fingerprint fetch + km_index build, beside the writer threads
            self.gfa.add_chunk(index, zeros, seqlen32, shift0, shift1,
                               keys6_from_gk(nodes.fetch("gk"),
                                             nodes.fetch("gflag")))
        # the rewrite after a gate fault needs the .sequences cut pair
        # (sq0/sq1), not the GFA pair (which _meta_parts keeps)
        self._phases.append((nodes, index, abs_start, abs_end, rev,
                             sq0, sq1, rb))

    def finish(self, counts: np.ndarray, pot=None) -> dict:
        """counts: whole-run abundances of ALL emitted nodes, in id order
        (= global crossing order = the phases' feed order concatenated).

        pot: an ops/edge_join.PotJoin when device_join is on (its list
        came down under the tail emission; resolve() waits here).  When it
        is None, or resolves to None (a key group over G_SLOTS), the edges
        come from the host km_index join on the final finalize's
        fingerprints, which cover every id."""
        detail = os.environ.get("MDBG_BENCH_DETAIL")
        t0 = time.perf_counter()
        try:
            self.gfa.set_abundance(counts)
            arrays = None
            if self.device_join and pot is not None:
                arrays = pot.resolve()
            t1 = time.perf_counter()
            if arrays is not None:
                g = self.gfa.finish_pot(f"{self.prefix}.gfa",
                                        self.params.presimp, *arrays)
            elif self.device_join:
                g = self._finish_host_join(counts)
            else:
                g = self.gfa.finish(f"{self.prefix}.gfa",
                                    presimp=self.params.presimp)
            self.edge_join = "device" if arrays is not None else "host"
        finally:
            self.gfa.abort()
            t2 = time.perf_counter()
            for t in self.writers:
                t.join()
        if detail:
            print(f"# finish: resolve={t1 - t0:.3f} gfa={t2 - t1:.3f} "
                  f"writer_join={time.perf_counter() - t2:.3f}",
                  file=sys.stderr)
        if self.errors:
            warnings.warn(
                f"minimizer recompute failed ({self.errors[0]}); rewriting "
                ".sequences shards from device vectors")
            self._rewrite_from_vec()
        return g

    def _finish_host_join(self, counts: np.ndarray) -> dict:
        """When a key group exceeds the device join's G_SLOTS (very deep
        repeats), or no join was given: fetch the FINAL finalize's
        fingerprints for all ids and run the host km_index join on a fresh
        builder.  The keys-free builder is discarded."""
        self.gfa.abort()
        final = self._phases[-1][0]
        n = len(counts)
        keys6 = keys6_from_gk(final.fetch_full("gk")[:n],
                              final.fetch_full("gflag")[:n])
        seqlen, shift0, shift1 = (
            np.concatenate([m[i] for m in self._meta_parts])
            for i in range(3))
        g = IncrementalGFA(cap_hint=n)
        try:
            g.add_chunk(np.arange(n, dtype=np.uint32), counts[:n], seqlen,
                        shift0, shift1, keys6)
            return g.finish(f"{self.prefix}.gfa",
                            presimp=self.params.presimp)
        finally:
            g.abort()

    def _rewrite_from_vec(self):
        """After a recompute-gate fault in a writer: fetch the vectors
        after all and rewrite every shard (never expected to run; the GFA
        is unaffected)."""
        shard = 0
        for nodes, index, abs_start, abs_end, rev, shift0, shift1, rb \
                in self._phases:
            for row0, vec in nodes.vec_chunks():
                hi = row0 + len(vec)
                write_records_native(
                    f"{self.prefix}.{shard}.sequences", self.params.k,
                    self.params.l, index[row0:hi], vec, rb,
                    abs_start[row0:hi], abs_end[row0:hi], rev[row0:hi],
                    shift0[row0:hi], shift1[row0:hi])
                shard += 1
        for pth in glob.glob(f"{self.prefix}.*.sequences"):
            try:
                s = int(pth.rsplit(".", 2)[-2])
            except ValueError:
                continue
            if s >= shard:
                try:
                    os.remove(pth)
                except OSError:
                    pass
