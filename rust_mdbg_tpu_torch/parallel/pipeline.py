"""Sharded mdBG construction: the streaming run over a shard mesh.

Counterpart of the JAX package's `parallel/pipeline.py`, which extends the
one-shot count step of parallel/sharded.py to a whole run:

  per round, for every shard:
    - extract windows from the shard's rows of the batch      (seq_io pool)
    - route each window (key, meta with the global read row, canonical
      vector) to owner = key_lo mod n by one all_to_all       (DashMap)
    - the owner appends what it receives to its buffers
  finalize:
    - per shard, finalize_windows (ops/sort_count): counts, the crossing
      occurrence's meta and vector, nodes in first-occurrence order
    - global ids: exclusive prefix of the per-shard node counts
      (all_gather)                                            (NODE_INDEX)

Node ids come out grouped by owner shard and in first-occurrence order
within a shard: deterministic for a given n, and graph-isomorphic to the
single-chip order.  The .sequences records and the GFA reuse the native
writers; the GFA comes from the distributed join (parallel/edges.py) or,
with MDBG_SHARDED_EDGES=0, from the gathered core/graph.build_gfa join.

What the JAX pipeline carries for XLA's static shapes has no counterpart:
the buffers grow by appending what each round delivers (no window_cap and
no growth step), routes are sized from the data (no route_cap and no
drops), and finalize_windows has no node cap — the JAX run keeps only the
first 2^20 unique keys of a shard and drops the rest without a word
(`assemble_sharded` passes node_cap=1 << 20 and no caller reads
node_overflow); here every key counts.  An extraction overflow (a read
over its minimizer capacity) raises, as in the JAX package.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from ..ops.extract import device_extract
from ..utils.timing import PhaseTimer
from .sharded import bucket_by_owner, owner_of


def meta_columns(params) -> int:
    """Meta columns routed with each window: extract's 4, the global read
    row at column 4, and on raw input the exact-cut extpack at column 5."""
    return 5 if (params.reads_already_hpc
                 or getattr(params, "seq_ref_cuts", False)) else 6


class ShardedPipeline:
    """Extraction, routing and per-shard window buffers over `mesh` for
    batches of B_local rows a shard, M minimizer slots a read.  A window
    row is int64 [2 + mc + k]: key lo, hi, meta (u32 values), canonical
    vector.  `widths` collects the staged widths the steps ran at."""

    def __init__(self, mesh, params, B_local: int, M: int):
        self.mesh = mesh
        self.params = params
        self.B_local = B_local
        self.mc = meta_columns(params)
        self.kw = dict(l=params.l, k=params.k, hash_bound=params.hash_bound,
                       M=M, already_hpc=params.reads_already_hpc,
                       compact_output=True,
                       ref_cuts=getattr(params, "seq_ref_cuts", False))
        self.blocks: list[list[torch.Tensor]] = [[] for _ in mesh.local]
        self.widths: set[int] = set()

    def _window_rows(self, codes, lengths, read_base: int, shard: int):
        out = device_extract(codes, lengths, **self.kw)
        meta = out["meta"].reshape(-1, out["meta"].shape[-1])
        idx = torch.nonzero((meta[:, 1] >> 31) & 1).flatten()
        W = out["meta"].shape[1]
        row = read_base + shard * self.B_local + idx // W
        meta = meta[idx]
        rows = torch.cat([out["keys"].reshape(-1, 2)[idx], meta[:, :4],
                          row[:, None], meta[:, 4:],
                          out["vecs"].reshape(-1, self.params.k)[idx]],
                         dim=1)
        return rows, out["overflow"].sum()

    def step(self, host: tuple, lengths: np.ndarray, read_base: int):
        """One round: host is core/fastx_feed.staged_rounds' planes
        (packed, mask) of the rows of this process's shards, lengths their
        read lengths; local shard i takes rows [i * B_local, (i + 1) *
        B_local).  read_base is the global row of the round's first read.
        Raises on an extraction overflow."""
        from ..core.fastx_feed import to_device
        from ..ops.pack import unpack_codes

        n, Bl = self.mesh.n, self.B_local
        sends, n_over = [], []
        for i, (s, dev) in enumerate(zip(self.mesh.local, self.mesh.devices)):
            rs = slice(i * Bl, (i + 1) * Bl)
            planes, lens = to_device(tuple(a[rs] for a in host),
                                     lengths[rs], dev)
            codes = unpack_codes(*planes)
            self.widths.add(int(codes.shape[1]))
            rows, over = self._window_rows(codes, lens, read_base, s)
            sends.append(bucket_by_owner(rows, owner_of(rows[:, 0], n), n))
            n_over.append(over)
        for blocks, rows in zip(self.blocks, self.mesh.all_to_all(sends)):
            blocks.append(rows)
        over = self.mesh.psum([int(o) for o in n_over])
        if over:
            raise RuntimeError(
                f"{over} reads over their minimizer capacity in the sharded "
                "run (extraction overflow)")

    def finalize(self) -> tuple[list, list]:
        """Per local shard, finalize_windows of its buffers (dict, with
        `base`, its first global id, and `windows`, its row count), and the
        n + 1 id bases.  Empties the buffers."""
        from ..ops.sort_count import finalize_windows

        mc = self.mc
        res = []
        for i, dev in enumerate(self.mesh.devices):
            blocks = self.blocks[i]
            rows = (torch.cat(blocks) if blocks else torch.zeros(
                (0, 2 + mc + self.params.k), dtype=torch.int64, device=dev))
            self.blocks[i] = []
            del blocks
            r = finalize_windows(rows[:, 0], rows[:, 1], rows[:, 2:2 + mc],
                                 rows[:, 2 + mc:],
                                 minab=self.params.min_kmer_abundance)
            r["windows"] = int(rows.shape[0])
            res.append(r)
            del rows
        n_pass = self.mesh.all_gather([r["n_pass"] for r in res])
        bases = [0]
        for m in n_pass:
            bases.append(bases[-1] + m)
        for s, r in zip(self.mesh.local, res):
            r["base"] = bases[s]
        return res, bases


def record_spans(meta: np.ndarray, read_offsets: np.ndarray,
                 local_row: np.ndarray, l: int):
    """.sequences record spans of crossing windows: (abs_start, abs_end,
    rev8, shift0, shift1) from their meta rows (u32) and the offsets of
    their reads in the raw blob; on raw input the exact-cut corrections of
    the extpack column."""
    from ..ops.extract import _unpack_ext

    abs_start = read_offsets[local_row] + meta[:, 3].astype(np.int64)
    abs_end = abs_start + meta[:, 0].astype(np.int64) + (l - 2)
    rev8 = (meta[:, 2] >> 31).astype(np.uint8)
    sq0 = (meta[:, 1] & 0x7FFFFFFF).astype(np.uint16)
    sq1 = (meta[:, 2] & 0x7FFFFFFF).astype(np.uint16)
    if meta.shape[1] > 5:
        ext_delta, de1 = _unpack_ext(meta[:, 5])
        abs_end = abs_end + ext_delta
        r = rev8.astype(bool)
        sq0 = np.where(r, sq0 + de1, sq0).astype(np.uint16)
        sq1 = np.where(r, sq1, sq1 + de1).astype(np.uint16)
    return abs_start, abs_end, rev8, sq0, sq1


class RawBlob:
    """The raw bytes of a process's reads, round by round, as the
    .sequences writers read them: a round of `rows` rows adds its feed
    tuple's blob and offsets, rows past its reads empty."""

    def __init__(self, rows: int):
        self.rows = rows
        self.blobs: list[np.ndarray] = []
        self.offsets: list[np.ndarray] = []
        self.size = 0
        self.n_reads = 0

    def add(self, blob: np.ndarray, blob_off: np.ndarray, fill: int):
        off = np.full(self.rows, self.size + int(blob_off[fill]), np.int64)
        off[:fill] = self.size + blob_off[:fill]
        self.offsets.append(off)
        self.blobs.append(blob[: int(blob_off[fill])])
        self.size += int(blob_off[fill])
        self.n_reads += fill

    def empty_round(self):
        self.add(np.zeros(0, np.uint8), np.zeros(1, np.int64), 0)

    def arrays(self):
        """(every read's bytes back to back as uint8, offsets [rows + 1])."""
        return (np.concatenate(self.blobs) if self.blobs
                else np.zeros(0, np.uint8),
                np.concatenate(self.offsets + [np.array([self.size])]))


def read_range(chunks, skip: int, take: int):
    """core/fastx_feed's tuples (codes, lengths, blob, blob_off, fill) of
    the `take` reads after the first `skip` (row slices, no copies); stops
    reading once they are out."""
    seen = 0
    try:
        for codes, lens, blob, off, fill in chunks:
            a = min(fill, max(0, skip - seen))
            b = min(fill, max(0, skip + take - seen))
            seen += fill
            if b > a:
                yield (codes[a:b], lens[a:b], blob[off[a]:off[b]],
                       off[a:b + 1] - off[a], b - a)
            if seen >= skip + take:
                return
    finally:
        close = getattr(chunks, "close", None)
        if close is not None:
            close()


def _take_rows(pend: list, n: int, B: int, L: int) -> tuple:
    """The first n reads of the pending tuples as one tuple of B rows."""
    codes0, lens0, blob0, off0, fill0 = pend[0]
    if n == fill0 == B == codes0.shape[0]:
        pend.pop(0)
        return codes0, lens0, blob0[: off0[B]], off0[: B + 1], B
    codes = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    blobs, offs, r, size = [], [np.zeros(1, np.int64)], 0, 0
    while r < n:
        c, ln, bl, of, fill = pend[0]
        m = min(fill, n - r)
        codes[r:r + m] = c[:m]
        lens[r:r + m] = ln[:m]
        blobs.append(bl[: of[m]])
        offs.append(of[1:m + 1] + size)
        size += int(of[m])
        r += m
        if m == fill:
            pend.pop(0)
        else:
            pend[0] = (c[m:], ln[m:], bl[of[m]:], of[m:] - of[m], fill - m)
    return codes, lens, np.concatenate(blobs), np.concatenate(offs), n


def exact_rounds(chunks, B: int, L: int):
    """core/fastx_feed's tuples re-cut to rounds of exactly B reads, the
    last one short: a round's rows fix the global row of every window, so
    they must be the B reads the JAX feed puts there, while the native
    reader returns a short chunk when its raw buffer fills.  Raises on a
    read over the staging width L."""
    pend: list = []
    have = 0
    for item in chunks:
        if item[0].shape[1] != L:
            raise ValueError(
                f"read of {item[0].shape[1]} bp or more exceeds the staging "
                f"width {L}; set --max-read-len")
        if item[4]:
            pend.append(item)
            have += item[4]
        while have >= B:
            yield _take_rows(pend, B, B, L)
            have -= B
    if have:
        yield _take_rows(pend, have, B, L)


def prefetched(items):
    """Iterate `items` one item ahead in a thread of its own, so that the
    host feed (parse, cut, pack) overlaps the device steps.  An error of
    the thread is raised here; leaving the loop stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=1)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def pump():
        try:
            for item in items:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # surfaced on the consumer
            put(e)
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=pump, name="sharded-feed", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=60)


def host_nodes(shards: list) -> dict:
    """count, meta (u32) and vec (u64) of this process's nodes as numpy,
    shards concatenated in shard (= id) order."""
    from ..ops import u64
    from ..ops.sort_count import _u32_to_numpy

    return dict(
        count=np.concatenate([r["count"].cpu().numpy() for r in shards]),
        meta=np.concatenate([_u32_to_numpy(r["meta"]) for r in shards]),
        vec=np.concatenate([u64.to_numpy(r["vec"]) for r in shards]))


def gathered_gfa(path: str, params, nodes: dict, index: np.ndarray) -> dict:
    """The single-host km_index join over the gathered table
    (MDBG_SHARDED_EDGES=0)."""
    from ..core.graph import build_gfa

    meta = nodes["meta"]
    return build_gfa(path, dict(
        index=index, abundance=nodes["count"].astype(np.uint32),
        seqlen=meta[:, 0].astype(np.uint32),
        shift0=(meta[:, 1] & 0x7FFFFFFF).astype(np.uint16),
        shift1=(meta[:, 2] & 0x7FFFFFFF).astype(np.uint16),
    ), nodes["vec"], presimp=params.presimp)


def sharded_edges_enabled() -> bool:
    """MDBG_SHARDED_EDGES=0 selects the gathered join, as in the JAX
    package; otherwise the distributed join makes the edges."""
    return os.environ.get("MDBG_SHARDED_EDGES", "1") != "0"


def assemble_sharded(reads_path: str, params, prefix: str,
                     n_devices: int | None = None, device=None) -> dict:
    """Whole assembly over a mesh of n_devices shards (default: one a
    card) to prefix.gfa and the prefix.<i>.sequences shards.  Runs on the
    card unless `device` names the CPU.

    Stats: the JAX function's (nb_reads, nb_windows, n_devices, nb_nodes,
    nb_edges, presimp_removed, distributed_edges with the distributed
    join), plus `phases` (seconds: job, feed, steps, finalize, sequences,
    gfa) with their `spans` and `counters` (utils/timing.PhaseTimer),
    `shard_windows` and `shard_unique_keys` (per shard: the windows it
    received and its unique keys; the JAX run keeps at most 2^20 of the
    latter), `staged_shapes` (the [rows, width] a shard's extraction ran
    at) and `device`.

    The feed is core/fastx_feed's (staging_plan, stream_chunks,
    staged_rounds): the native reader, re-cut to rounds of exactly B
    reads, each cut to the half staging width where its reads fit and
    2-bit packed, one round ahead in a thread; `feed` is the time the
    steps wait for it."""
    from ..core.fastx_feed import staged_rounds, staging_plan, stream_chunks
    from ..io.sequences import remove_stale, write_records_native_sharded
    from ..ops.kernels import build_all
    from .edges import gfa_parts
    from .mesh import make_mesh

    timer = PhaseTimer()
    with timer.job():
        if n_devices is None:
            n_devices = (torch.cuda.device_count() if device is None
                         or torch.device(device).type == "cuda" else 1)
        mesh = make_mesh(n_devices, device)
        n = mesh.n
        with timer.phase("compile"):
            if mesh.devices[0].type == "cuda":
                build_all()
        B = ((params.batch_reads + n - 1) // n) * n
        plan = staging_plan(reads_path, params)
        pipe = ShardedPipeline(mesh, params, B // n, plan["M"])

        remove_stale(prefix)
        raw = RawBlob(B)
        read_base = 0
        rounds = prefetched(staged_rounds(exact_rounds(
            stream_chunks(reads_path, B, B, plan["L"], plan["mean_len"]), B,
            plan["L"]), plan))
        try:
            while True:
                with timer.phase("feed"):
                    item = next(rounds, None)
                if item is None:
                    break
                host, lens, blob, blob_off, fill = item
                with timer.phase("steps"):
                    pipe.step(host, lens, read_base)
                raw.add(blob, blob_off, fill)
                read_base += B
        finally:
            rounds.close()
        with timer.phase("finalize"):
            shards, bases = pipe.finalize()
            nodes = host_nodes(shards)
        total = bases[-1]
        index = np.arange(total, dtype=np.uint32)
        stats = dict(nb_reads=raw.n_reads,
                     nb_windows=int(nodes["count"].sum()), n_devices=n,
                     device=str(mesh.devices[0]), staged_shapes=[
                         [B // n, w] for w in sorted(pipe.widths)],
                     shard_windows=[r["windows"] for r in shards],
                     shard_unique_keys=[r["n_unique"] for r in shards])
        with timer.phase("sequences"):
            if not params.no_basespace and total:
                blob, offsets = raw.arrays()
                meta = nodes["meta"]
                spans = record_spans(meta, offsets,
                                     meta[:, 4].astype(np.int64), params.l)
                write_records_native_sharded(
                    prefix, params.k, params.l, index, nodes["vec"], blob,
                    *spans, n_shards=params.threads)
        with timer.phase("gfa"):
            if sharded_edges_enabled():
                parts, nb_edges, n_removed = gfa_parts(mesh, shards, bases,
                                                       params.presimp)
                with open(f"{prefix}.gfa", "w", buffering=1 << 20) as f:
                    f.write("H\tVN:Z:1.0\n")
                    f.writelines(s for s, _ in parts)
                    f.writelines(l_text for _, l_text in parts)
                stats.update(nb_nodes=total, nb_edges=nb_edges,
                             presimp_removed=n_removed,
                             distributed_edges=True)
            else:
                stats.update(gathered_gfa(f"{prefix}.gfa", params, nodes,
                                          index))
    stats.update(timer.stats())
    return stats
