"""Benchmark: mdBG construction throughput on the card (read-Gbp/s).

    python -m rust_mdbg_tpu_torch.bench [--device cuda|cpu] [--profile DIR]

The port's counterpart of the repository's root `bench.py`, step for step:
synthetic HiFi-like reads (24,576 bp at 52x of a 20 Mbp genome that is 20 %
segmental duplications, one substitution per 1/0.3 % bases) at the
reference's HG002 parameters k=21, l=14, d=0.003, minabund 2, reads taken
as already homopolymer-compressed (the reference's headline runs were fed
pre-HPC'd reads).  The reads are staged on the device once; each timed rep
runs the whole-run construction there (extraction with the nthash_select
kernel, the per-batch slot append, the crossing reduction) and emits the
.sequences shards and the GFA on the host, phase 1 of the emission beside
the construct loop.  A warm-up, then the best of 3 reps by wall.  Then the
device loop alone, the host-to-device link, the 2-bit packed feed, and the
chunked driver (`core/chunked.assemble_device_chunked`) over the same reads
written as FASTA.

The last line of standard output is bench.py's JSON object (the same 22
keys, with the same meanings; times unrounded) plus `device` (the card's
name and power limit, as nvidia-smi gives them) and `peak_device_bytes`.

Environment (bench.py's names): MDBG_BENCH_ERR, MDBG_BENCH_REPEATS,
MDBG_BENCH_B (batch reads, default 128), MDBG_BENCH_BF=1 (the device --bf
screen with a 2^32-bit Bloom filter and the per-read window slots scaled by
MDBG_BF_SLOT_FRAC, default 0.5), MDBG_BENCH_PHASES (where phase emission
cuts the loop, default 0.12), MDBG_BENCH_PIPELINED=0 (skip the chunked
driver), MDBG_BENCH_DETAIL (the tail's split on standard error).

--profile DIR adds one rep traced with torch.profiler through
`PhaseTimer.phase(..., profile_dir=DIR)` (a Chrome trace in DIR) and prints,
on lines before the JSON line, the rep's seconds by stage, the ten kernels
with the most device time, the device's busy share of the rep's wall and
its five longest idle gaps with the spans open across each: the
counterpart of profiling/trace_loop.py and profile_bench.py's stage split.

It runs on the card unless --device cpu is given (the plain torch versions
of the kernels) and raises when there is no GPU and no --device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .core.chunked import assemble_device_chunked, resolve_device
from .core.device_out import PhasedEmitter, minimizer_recompute_ok
from .io.sequences import remove_stale
from .ops.extract import capacity
from .ops.pack import pack_codes_np
from .ops.sort_count import (DeviceNodeCounter, construct_batches,
                             counter_flags, window_slot_capacity)
from .params import Params
from .utils.seq import CODE_BASE
from .utils.timing import PhaseTimer, card_info, trace_us

BASELINE_GBPS = 114.4 / 411.0  # HG002 52x HPC input / 6m51s (8 threads)
ERR_RATE = float(os.environ.get("MDBG_BENCH_ERR", "0.003"))
REPEAT_FRAC = float(os.environ.get("MDBG_BENCH_REPEATS", "0.2"))

#: trace categories that occupy the device
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def synth_genome(rng, G, repeat_frac=REPEAT_FRAC):
    """Random genome whose last repeat_frac is exact copies of 10-100 kb
    segments of the unique part (segmental duplications): bench.py's draws,
    in its order."""
    core = rng.integers(0, 4, int(G * (1 - repeat_frac))).astype(np.uint8)
    parts = [core]
    rem = G - core.size
    while rem > 0:
        seg = int(min(rem, rng.integers(10_000, 100_000)))
        src = int(rng.integers(0, core.size - seg))
        parts.append(core[src : src + seg])
        rem -= seg
    return np.concatenate(parts)


def synth_reads(genome_mbp=20, coverage=52, read_len=24576, seed=0):
    """(genome codes, read starts, read length): bench.py's corpus."""
    rng = np.random.default_rng(seed)
    G = int(genome_mbp * 1_000_000)
    genome = synth_genome(rng, G)
    n_reads = int(G * coverage) // read_len
    starts = rng.integers(0, G - read_len, n_reads)
    return genome, starts, read_len


def error_model(n_reads: int, L: int, err_rate: float = ERR_RATE):
    """Substitutions, one per L/E-base segment (E = round(err_rate * L)):
    positions int32 [n_reads, E], distinct within a row, so the host and
    the device scatter agree whatever the order of their updates, and
    offsets u8 [n_reads, E] in 1..3 (code -> (code + offset) % 4)."""
    rng = np.random.default_rng(7)
    E = max(1, int(round(err_rate * L)))
    seg = L // E
    err_pos = (np.arange(E, dtype=np.int32)[None, :] * seg
               + rng.integers(0, seg, (n_reads, E)).astype(np.int32))
    err_off = rng.integers(1, 4, (n_reads, E)).astype(np.uint8)
    return err_pos, err_off


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Phases:
    """The emission phases before the last: each is resolved (the prefix
    reduction, which blocks its thread in `torch.nonzero`) and emitted on a
    helper thread, one after another, while the main thread goes on
    launching the construct loop.  Each step is a span on `timer`."""

    def __init__(self, counter, em, t0: float, timer: PhaseTimer):
        self.counter, self.em, self.t0, self.timer = counter, em, t0, timer
        self.row_lo = 0
        self.emit1 = 0.0  # seconds from t0 to the end of phase 1's emit
        self._thread = None
        self._error = None
        self._n = 0

    def start(self, pending):
        prior = self._thread
        self._n += 1
        n = self._n

        def run():
            if prior is not None:
                prior.join()
            if self._error is not None:
                return
            try:
                with self.timer.phase(f"phase-{n} finalize"):
                    ph = self.counter.finalize_resolve(
                        pending, lazy=True, row_lo=self.row_lo,
                        gk_mode="none")
                with self.timer.phase(f"phase-{n} emit"):
                    self.em.emit_phase(ph)
                self.row_lo = ph.n_pass
                if n == 1:
                    self.emit1 = time.perf_counter() - self.t0
            except BaseException as e:  # raised on the main thread
                self._error = e

        self._thread = threading.Thread(target=run, name=f"bench-phase{n}")
        self._thread.start()

    def join(self):
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error


class Bench:
    """bench.py's corpus staged on `device`, its counter and its steps.

    genome_mbp, coverage and read_len size the corpus (bench.py's defaults);
    use_bf and batch_reads default to MDBG_BENCH_BF and MDBG_BENCH_B;
    outputs go to workdir (default: mdbg_bench_torch under the temporary
    directory)."""

    def __init__(self, device=None, genome_mbp=20, coverage=52,
                 read_len=24576, workdir: str | None = None,
                 use_bf: bool | None = None, batch_reads: int | None = None):
        self.dev = resolve_device(device)
        if use_bf is None:
            use_bf = os.environ.get("MDBG_BENCH_BF", "0") == "1"
        if batch_reads is None:
            batch_reads = int(os.environ.get("MDBG_BENCH_B", "128"))
        self.use_bf = use_bf
        self.params = p = Params(
            k=21, l=14, density=0.003, min_kmer_abundance=2, use_bf=use_bf,
            bloom_log2_bits=32, batch_reads=batch_reads,
            reads_already_hpc=True)
        if self.dev.type == "cuda":
            from .ops.kernels import build_all

            build_all()
        genome, starts, L = synth_reads(genome_mbp, coverage, read_len)
        B = self.B = p.batch_reads
        n_reads = self.n_reads = len(starts) - (len(starts) % B)
        self.total_bases = n_reads * L
        self.n_batches = n_reads // B
        self.workdir = workdir or os.path.join(tempfile.gettempdir(),
                                               "mdbg_bench_torch")
        os.makedirs(self.workdir, exist_ok=True)
        self.prefix = os.path.join(self.workdir, "bench")

        self.M = capacity(p, L)
        W_slot = window_slot_capacity(p, B, L, self.M)
        self.slot_frac = None
        if use_bf:
            # surviving windows = total - first sightings (~36 % at 0.3 %
            # errors, 52x); an overflowing slot fails the rep (n_over)
            self.slot_frac = float(os.environ.get("MDBG_BF_SLOT_FRAC", "0.5"))
            W_slot = max(8, (int(W_slot * self.slot_frac) + 7) & ~7)
        self.W_slot = W_slot
        flags = counter_flags(p)
        self.counter = DeviceNodeCounter(
            k=p.k, M=self.M, read_cap=n_reads, w_slot=W_slot, chunk_slots=1,
            device=self.dev, minab=p.min_kmer_abundance,
            emit_overlap_keys=minimizer_recompute_ok(p), **flags)

        # the reads on the device: one gather of rows out of the genome's
        # sliding-window view (1 B a base; an index of start + arange would
        # take 8 B a base), then the error scatter
        err_pos, err_off = error_model(n_reads, L)
        g = torch.from_numpy(genome).to(self.dev)
        st = torch.from_numpy(starts[:n_reads].astype(np.int64)).to(self.dev)
        codes = g.unfold(0, L, 1)[st]
        rows = torch.arange(n_reads, device=self.dev)[:, None]
        ep = torch.from_numpy(err_pos.astype(np.int64)).to(self.dev)
        eo = torch.from_numpy(err_off).to(self.dev)
        codes[rows, ep] = (codes[rows, ep] + eo) % 4
        del g, st, rows, ep, eo
        self.all_codes = codes
        self.all_lengths = torch.full((n_reads,), L, dtype=torch.int32,
                                      device=self.dev)

        # the host twin (the emitters slice node sequences out of it) must
        # equal the device copy
        rc = np.lib.stride_tricks.sliding_window_view(genome, L)[
            starts[:n_reads]]
        rr = np.arange(n_reads)[:, None]
        rc[rr, err_pos] = (rc[rr, err_pos] + err_off) % 4
        if not np.array_equal(codes.cpu().numpy(), rc):
            raise RuntimeError("device/host error application diverged")
        self.reads_codes = rc
        self.reads_ascii = CODE_BASE[rc]
        self.row_off = np.arange(n_reads, dtype=np.int64) * L

        fracs = [float(x) for x in os.environ.get(
            "MDBG_BENCH_PHASES", "0.12").split(",")]
        nb = self.n_batches
        self.bounds = sorted({max(1, min(nb - 1, int(nb * f)))
                              for f in fracs} - {nb}) + [nb]

    def _construct(self, lo: int, hi: int):
        return construct_batches(
            self.params, self.all_codes, self.all_lengths,
            self.counter.buffers, B=self.B, M=self.M, w_slot=self.W_slot,
            batch_lo=lo, batch_hi=hi)

    def reset_bf(self):
        """Zero the --bf Bloom words between reps: a filled filter would
        pass every window (and overflow the shrunken slots); each rep sees
        it fresh, like a fresh run."""
        if self.use_bf:
            self.counter.buffers[-1].zero_()

    def run_once(self) -> dict:
        """One phased construction, a `job` span with a span a stage.
        Returns the rep's timings (bench.py's wall, loop, construct, seqw,
        emit1 seconds, `stages`: the seconds of each span name) and the
        span record (`spans`, `clock`: utils/timing.PhaseTimer's), the GFA
        stats `g`, `windows`, `uniques` and the edge join that made the
        edges."""
        B, counter = self.B, self.counter
        self.reset_bf()
        remove_stale(self.prefix)
        _sync(self.dev)
        timer = PhaseTimer()
        with timer.job():
            t0 = time.perf_counter()
            em = PhasedEmitter(self.prefix, self.params,
                               self.reads_ascii.reshape(-1), self.row_off,
                               cap_hint=1 << 18, device_join=True)
            phases = _Phases(counter, em, t0, timer)
            overs = []
            prev = 0
            try:
                with timer.phase("loop"):
                    try:
                        for hi in self.bounds:
                            overs.append(self._construct(prev, hi)[1])
                            if hi < self.n_batches:
                                # bound to the prefix as it stands; later
                                # constructs write only rows past it (ops/
                                # sort_count's invariant)
                                phases.start(counter.finalize_dispatch(
                                    prefix_rows=hi * B * self.W_slot))
                            prev = hi
                    finally:
                        phases.join()
                    n_over = sum(int(o) for o in overs)
                t_loop = time.perf_counter() - t0
                with timer.phase("final finalize"):
                    nodes = counter.finalize_resolve(
                        counter.finalize_dispatch(), lazy=True,
                        row_lo=phases.row_lo, gk_mode="device")
                t_construct = time.perf_counter() - t0
                if n_over:
                    raise RuntimeError(
                        f"{n_over} reads or batches overflowed their "
                        "minimizer or window slots")
                t_host0 = time.perf_counter()
                with timer.phase("tail emit"):
                    # the counts come down under the tail emission
                    nodes.prefetch_full("count")
                    pot = counter.edge_join(nodes)
                    em.emit_phase(nodes)
                t_tail_emit = time.perf_counter() - t_host0
                with timer.phase("counts"):
                    counts = nodes.fetch_full("count")
                t_counts = time.perf_counter() - t_host0 - t_tail_emit
                with timer.phase("finish+join"):
                    g = em.finish(counts, pot=pot)
                    n_windows = int(counts.sum())
            except BaseException:
                em.gfa.abort()
                for t in em.writers:
                    t.join()
                raise
            t_seqw = time.perf_counter() - t_host0
            t1 = time.perf_counter()
        if os.environ.get("MDBG_BENCH_DETAIL"):
            print(f"# tail: n_tail={nodes.n_new} emit_phase={t_tail_emit:.3f}"
                  f" counts={t_counts:.3f}"
                  f" finish+join={t_seqw - t_tail_emit - t_counts:.3f}",
                  file=sys.stderr)
        rec = timer.stats()
        return dict(wall=t1 - t0, loop=t_loop, construct=t_construct,
                    seqw=t_seqw, emit1=phases.emit1, stages=rec["phases"],
                    spans=rec["spans"], clock=timer.clock, g=g,
                    windows=n_windows, uniques=nodes.n_unique,
                    edge_join=em.edge_join, n_over=n_over)

    def device_loop(self) -> float:
        """Seconds of the construct loop alone over every batch, on refilled
        key planes (and a zeroed Bloom filter), with no reduction and no
        host emission in the window."""
        self.counter.reset_chunk()
        self.reset_bf()
        _sync(self.dev)
        t0 = time.perf_counter()
        _n, n_over = self._construct(0, self.n_batches)
        _sync(self.dev)
        t = time.perf_counter() - t0
        if int(n_over):
            raise RuntimeError(f"device loop: {int(n_over)} overflows")
        return t

    def h2d(self) -> float:
        """Host-to-device GB/s of one batch of codes, copied four times
        from pageable memory."""
        codes_host = np.ascontiguousarray(self.reads_codes[: self.B])
        t0 = time.perf_counter()
        for _ in range(4):
            torch.from_numpy(codes_host).to(self.dev, copy=True)
            _sync(self.dev)
        return 4 * codes_host.nbytes / (time.perf_counter() - t0) / 1e9

    def feed(self) -> float:
        """Seconds to copy the whole corpus, packed to 2 bits a base plus
        its invalid-base mask (the chunked driver's feed), to the device."""
        pk, mk = pack_codes_np(self.reads_codes)
        t0 = time.perf_counter()
        staged = tuple(torch.from_numpy(a).to(self.dev, copy=True)
                       for a in (pk, mk))
        _sync(self.dev)
        t = time.perf_counter() - t0
        del staged
        return t

    def write_fasta(self) -> str:
        """The errored reads as FASTA (>r<i>), the chunked leg's input."""
        fa = os.path.join(self.workdir, "bench_reads.fa")
        with open(fa, "wb", buffering=1 << 22) as f:
            for i in range(self.n_reads):
                f.write(b">r%d\n" % i)
                f.write(self.reads_ascii[i].tobytes())
                f.write(b"\n")
        return fa

    def pipelined(self) -> tuple[float, dict]:
        """The chunked driver over the same reads from a FASTA on disk
        (parse, pack and copy of chunk N+1 beside chunk N's construct):
        (seconds, its stats).  Its outputs are workdir/pipe.*."""
        fa = self.write_fasta()
        t0 = time.perf_counter()
        st = assemble_device_chunked(fa, self.params,
                                     os.path.join(self.workdir, "pipe"),
                                     PhaseTimer(), {}, device=self.dev)
        _sync(self.dev)
        return time.perf_counter() - t0, st

    def profile_rep(self, profile_dir: str) -> dict:
        """One more rep under torch.profiler (PhaseTimer.phase with
        profile_dir, which writes the Chrome trace), read back by
        trace_breakdown against the rep's own spans."""
        with PhaseTimer().phase("bench_rep", profile_dir=profile_dir):
            rep = self.run_once()
            _sync(self.dev)
        trace = max(glob.glob(os.path.join(profile_dir,
                                           "bench_rep.*.pt.trace.json")),
                    key=os.path.getmtime)
        out = trace_breakdown(trace, rep["spans"], rep["clock"])
        out["stages_s"] = rep["stages"]
        out["wall_s"] = rep["wall"]
        out["trace"] = trace
        return out


def short_kernel_name(name: str, width: int = 120) -> str:
    """A kernel's name without the namespaces and templates' noise, cut to
    `width` characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::cuda::detail::"):
        name = name.replace(junk, "")
    return name[:width]


def trace_breakdown(trace_path: str, spans, clock: tuple,
                    n_kernels: int = 10, n_gaps: int = 5) -> dict:
    """Device time of a Chrome trace over the window the spans cover.

    spans: a PhaseTimer's span dicts, and clock its `clock` pair, which
    with the trace's baseTimeNanoseconds places them on the trace's clock
    (utils/timing.trace_us).  Returns the `n_kernels` kernels with the
    most device time (name, us, launches) and the count of every kernel
    launch in the window, the device's busy microseconds (the union of
    kernels, copies and fills) and share of the window, and the `n_gaps`
    longest idle gaps (us, their start in seconds into the window, and the
    spans open across them)."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    base = int(trace["baseTimeNanoseconds"])
    spans_us = [(sp["name"], trace_us(clock, sp["start_ns"], base),
                 trace_us(clock, sp["end_ns"], base)) for sp in spans]
    lo = min(s for _, s, _ in spans_us)
    hi = max(t for _, _, t in spans_us)

    by_name: dict = {}
    busy = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0))
        if s + d <= lo or s >= hi:
            continue
        busy.append((s, s + d))
        if e["cat"] == "kernel":
            r = by_name.setdefault(e["name"], [0.0, 0])
            r[0] += d
            r[1] += 1
    merged: list = []
    for s, t in sorted(busy):
        s, t = max(s, lo), min(t, hi)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_us = sum(t - s for s, t in merged)
    edges = [lo] + [x for st in merged for x in st] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def open_at(s, t):
        return [name for name, a, b in spans_us if a < t and b > s]

    wall_us = hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_kernels]
    return dict(
        window_us=wall_us, device_events=len(busy), busy_us=busy_us,
        busy_share=busy_us / wall_us if wall_us > 0 else None,
        kernels=[dict(name=short_kernel_name(k), us=us, launches=n)
                 for k, (us, n) in top],
        kernel_launches=sum(n for _, n in by_name.values()),
        idle_gaps=[dict(us=t - s, at_s=(s - lo) / 1e6, stages=open_at(s, t))
                   for s, t in gaps[:n_gaps]])


def run_protocol(bench: Bench, repeats: int = 3,
                 pipelined: bool | None = None,
                 profile_dir: str | None = None) -> dict:
    """bench.py's protocol on a staged Bench: a warm-up rep, the best of
    `repeats` by wall, the device loop, the link rate, the packed feed and
    (unless pipelined is False, default MDBG_BENCH_PIPELINED) the chunked
    driver; with profile_dir one more rep, traced.  Returns the JSON
    line's dict (`line`), the best rep, the chunked driver's stats and the
    profile's breakdown."""
    if pipelined is None:
        pipelined = os.environ.get("MDBG_BENCH_PIPELINED", "1") != "0"
    dev = bench.dev
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    bench.run_once()  # warm-up
    best = min((bench.run_once() for _ in range(repeats)),
               key=lambda r: r["wall"])
    t_dev_loop = bench.device_loop()
    h2d_gbps = bench.h2d()
    t_feed = bench.feed()
    t_pipe, pipe_stats = bench.pipelined() if pipelined else (None, None)
    profile = None
    if profile_dir:
        profile = bench.profile_rep(profile_dir)

    total = bench.total_bases
    gbps = total / best["wall"] / 1e9
    line = {
        "metric": "mdbg_construction_throughput",
        "value": gbps,
        "unit": "read-Gbp/s per chip",
        "vs_baseline": gbps / BASELINE_GBPS,
        "total_gbp": round(total / 1e9, 3),
        "err_rate": ERR_RATE,
        "repeat_frac": REPEAT_FRAC,
        "wall_s": best["wall"],
        "construct_s": best["construct"],
        "loop_s": best["loop"],
        "seqwrite_s": best["seqw"],
        "phase1_emit_s": best["emit1"],
        "nodes": best["g"]["nb_nodes"],
        "edges": best["g"]["nb_edges"],
        "windows": best["windows"],
        "uniques": best["uniques"],
        "h2d_gbps": h2d_gbps,
        "feed_s": t_feed,
        "feed_incl_gbps": total / (best["wall"] + t_feed) / 1e9,
        "feed_pipelined_gbps": total / t_pipe / 1e9 if t_pipe else 0.0,
        "device_loop_s": t_dev_loop,
        "device_loop_gbps": total / t_dev_loop / 1e9,
        "device": card_info(dev),
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }
    return dict(line=line, best=best, pipe_stats=pipe_stats,
                profile=profile)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rust_mdbg_tpu_torch.bench")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace one more rep into DIR and print its "
                         "breakdown before the JSON line")
    a = ap.parse_args(argv)
    res = run_protocol(Bench(a.device), profile_dir=a.profile)
    prof = res["profile"]
    if prof is not None:
        print(f"# stages (s): {json.dumps(prof['stages_s'])}")
        print(f"# top kernels of {prof['kernel_launches']} launches: "
              f"{json.dumps(prof['kernels'])}")
        print(f"# device busy: {prof['busy_us']} us of "
              f"{prof['window_us']} us traced, share {prof['busy_share']}")
        print(f"# idle gaps: {json.dumps(prof['idle_gaps'])}")
        print(f"# trace: {prof['trace']}")
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
