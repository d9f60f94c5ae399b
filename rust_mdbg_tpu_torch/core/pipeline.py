"""The assembly entry point and the whole-run device driver.

Counterpart of the device half of the JAX package's `core/pipeline.py`.
`assemble` routes a run as `python -m rust_mdbg_tpu` does: to the chunked
driver (core/chunked, bounded memory at any input size) whenever
`chunked_eligible`, and to `assemble_device_table` for --minabund beyond
the chunk-slot ceiling, where the crossing occurrence is selected on the
device by one reduction over every window of the run.

The JAX `assemble` goes on to its host streaming engine when a device run
raises.  That engine is not ported and the port hides no device failure:
a path outside the port raises NotPortedError, anything else its own error.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ..io import fastx
from ..io.sequences import remove_stale
from ..params import Params, staging_width
from ..utils.timing import PhaseTimer
from .chunked import (NotPortedError, assemble_device_chunked, check_ported,
                      chunked_eligible, resolve_device)
from .device_out import (PhasedEmitter, emit_device_outputs,
                         minimizer_recompute_ok)

#: batches per staged chunk of the whole-run driver
CHUNK_BATCHES = 16

#: whole-run buffer budget on the CPU, bytes (the JAX package's figure, so
#: both route alike in the parity tests)
CPU_MEM_BUDGET = 4_000_000_000

#: share of the card's free memory the whole-run buffers may take: the
#: reduction's temporaries (three stable sort passes over 8-byte keys with
#: index planes, the sorted planes, head positions) come to several times
#: the 24 B per key row that the buffers hold
CUDA_BUDGET_SHARE = 0.2


def _device_table_eligible(params: Params, read_stats_path) -> bool:
    return (
        params.engine in ("auto", "device", "pallas")
        and not params.error_correct
        and not params.reference
        and not (params.uhs or params.lcp or params.has_lmer_counts)
        and read_stats_path is None
    )


def assemble(reads_path: str, params: Params, prefix: str,
             read_stats_path: str | None = None, device=None,
             mem_budget: int | None = None) -> dict:
    """Run the single-k assembly on `device` (CUDA unless named); writes
    prefix.gfa and the prefix.*.sequences shards, returns the stats dict."""
    dev = resolve_device(device)
    check_ported(params)
    if read_stats_path is not None:
        raise NotPortedError("--read-stats")
    if not _device_table_eligible(params, read_stats_path):
        raise NotPortedError(f"--engine {params.engine} (the host streaming "
                             "engine)")
    timer = PhaseTimer()
    stats: dict = {}
    if chunked_eligible(params):
        return assemble_device_chunked(reads_path, params, prefix, timer,
                                       stats, chunk_reads=params.chunk_reads,
                                       device=dev)
    return assemble_device_table(reads_path, params, prefix, timer, stats,
                                 device=dev, mem_budget=mem_budget)


def whole_run_budget(dev: torch.device) -> int:
    """Bytes the whole-run counter buffers may take on `dev`."""
    if dev.type != "cuda":
        return CPU_MEM_BUDGET
    free, _total = torch.cuda.mem_get_info(dev)
    return int(CUDA_BUDGET_SHARE * free)


def plan_table(reads_path: str, params: Params) -> dict:
    """The sizes a whole-run pass stages and allocates by: staging width L,
    batch B, minimizer slots M, window slots per read, the estimated read
    capacity, the counter flags, whether the feed is 2-bit packed, and the
    buffer bytes per read that the budget is held against."""
    from ..ops.extract import capacity
    from ..ops.sort_count import counter_flags, window_slot_capacity

    mean_len, mx = fastx.read_first_n_reads(reads_path, 100)
    L = params.max_read_len or staging_width(mx)
    B = params.batch_reads
    M = capacity(params, L)
    fsize = os.path.getsize(reads_path)
    if str(reads_path).endswith((".gz", ".lz4")):
        fsize *= 6  # DNA text compresses ~3.5-4x; headroom on top
    est_reads = max(1024, int(1.5 * fsize / max(1, mean_len)))
    w_slot = window_slot_capacity(params, B, L, M)
    flags = counter_flags(params)
    if flags["use_bf"]:
        frac = float(os.environ.get("MDBG_BF_SLOT_FRAC", "1.0"))
        w_slot = max(8, (int(w_slot * frac) + 7) & ~7)
    return dict(
        L=L, B=B, M=M, w_slot=w_slot, mean_len=mean_len, flags=flags,
        read_cap=((est_reads + B - 1) // B) * B,
        chunk_reads=CHUNK_BATCHES * B,
        packed=L % 8 == 0,  # 2-bit + mask feed (ops/pack)
        # three int64 key planes per window row; mh int64 + mp int32
        # (+ mpe int32) per minimizer slot
        per_read=24 * w_slot + (16 if flags["with_ext"] else 12) * M)


def new_table_counter(params: Params, plan: dict, dev: torch.device):
    """The device counter that holds every window of a whole-run pass."""
    from ..ops.sort_count import DeviceNodeCounter

    return DeviceNodeCounter(
        k=params.k, M=plan["M"], read_cap=plan["read_cap"],
        w_slot=plan["w_slot"], chunk_slots=1, device=dev,
        minab=params.min_kmer_abundance,
        emit_overlap_keys=minimizer_recompute_ok(params), **plan["flags"])


def construct_table_chunk(params: Params, plan: dict, counter, codes, lens,
                          fill: int, read_base: int):
    """One parsed chunk of `fill` reads, packed, copied to the counter's
    device and appended to its buffers at read row read_base (growing them
    when they are full).  Returns construct_batches' overflow count, a
    device scalar."""
    from ..ops.pack import pack_codes_np
    from ..ops.sort_count import construct_batches

    if codes.shape[1] != plan["L"]:
        raise RuntimeError("read longer than staging width")
    if read_base + plan["chunk_reads"] > counter.read_cap:
        counter.grow(read_base + plan["chunk_reads"])
    dev = counter.buffers[0].device
    host = pack_codes_np(codes) if plan["packed"] else (codes,)
    staged = tuple(torch.from_numpy(a).to(dev) for a in host)
    B = plan["B"]
    _n, n_over = construct_batches(
        params, staged if plan["packed"] else staged[0],
        torch.from_numpy(lens).to(dev), counter.buffers, B=B, M=plan["M"],
        w_slot=plan["w_slot"], batch_lo=0,
        batch_hi=min(CHUNK_BATCHES, (fill + B - 1) // B),
        read_base=read_base)
    return n_over


def assemble_device_table(reads_path: str, params: Params, prefix: str,
                          timer: PhaseTimer | None = None,
                          stats: dict | None = None, device=None,
                          mem_budget: int | None = None) -> dict:
    """Whole-run device construction: every window key of the run stays on
    the device, one sort/segment-reduce selects the crossing occurrence of
    every key (exact for any --minabund), and the native writers emit the
    .sequences shards and the GFA.

    The raw read bytes stay in host memory for the whole run (a crossing
    may reference any read), so `assemble` sends here only what the chunked
    driver cannot take.  An input whose buffers would pass `mem_budget`
    bytes (default: whole_run_budget) goes to the chunked driver when it is
    chunked_eligible, and raises otherwise.

    With --bf (counter_flags' use_bf) the Bloom screen runs on the device
    and drops each key's first sighting before the counter, so the reduction
    sorts post-filter rows only.  How many survive depends on the input
    (error rate x coverage), so shrinking the per-batch slot with them is
    opt-in: MDBG_BF_SLOT_FRAC scales W_slot, and an overflowing slot aborts
    the run (n_over) rather than truncating.

    Recompute mode (pre-HPC'd reads) emits in two phases: at a power-of-two
    chunk count near a quarter of the estimated input a reduction over the
    filled prefix finds the nodes that have crossed already, and a helper
    thread writes their records and GFA rows while the main thread goes on
    constructing.  The stats say so: `phase1_nodes` (0 when the phase never
    fired) with the helper's `phase1_finalize_s` and `phase1_emit_s`,
    `edge_join`, `n_over`, `read_cap`, `w_slot`, `mem_budget`.
    """
    from ..ops.kernels import build_all
    from .fastx_feed import stream_chunks

    dev = resolve_device(device)
    check_ported(params)
    timer = timer or PhaseTimer()
    stats = stats if stats is not None else {}

    plan = plan_table(reads_path, params)
    if mem_budget is None:
        mem_budget = whole_run_budget(dev)
    if plan["read_cap"] * plan["per_read"] > mem_budget:
        if chunked_eligible(params):
            return assemble_device_chunked(reads_path, params, prefix, timer,
                                           stats, device=dev)
        raise NotPortedError(
            f"an input over the whole-run device budget ({mem_budget} B) at "
            "--minabund beyond the chunk slots (the host streaming engine)")

    with timer.phase("compile"):
        if dev.type == "cuda":
            build_all()
    rec_ok = minimizer_recompute_ok(params)
    counter = new_table_counter(params, plan, dev)

    remove_stale(prefix)
    nb_reads = 0
    read_base = 0
    n_over_acc = []
    CH = plan["chunk_reads"]
    # global read row -> offset of its raw bytes in the resident blob
    blob_parts: list[np.ndarray] = []
    row_off_parts: list[np.ndarray] = []
    bytes_base = 0

    est_chunks = max(1, plan["read_cap"] // CH)
    trigger_chunks = 4
    while trigger_chunks * 4 < est_chunks:
        trigger_chunks *= 2
    phase: dict = {}

    def start_phase1():
        # the reduction is bound to the planes as they are now, in this
        # thread; the helper runs it beside the following constructs,
        # which write only rows past read_base (ops/sort_count's invariant)
        pending = counter.finalize_dispatch(
            prefix_rows=read_base * plan["w_slot"])
        em = PhasedEmitter(prefix, params, np.concatenate(blob_parts),
                           np.concatenate(row_off_parts),
                           no_basespace=params.no_basespace,
                           device_join=True)

        def run():
            try:
                t0 = time.perf_counter()
                ph1 = counter.finalize_resolve(pending, lazy=True,
                                               gk_mode="none")
                t1 = time.perf_counter()
                em.emit_phase(ph1)
                phase.update(ph1=ph1, finalize_s=t1 - t0,
                             emit_s=time.perf_counter() - t1)
            except BaseException as e:  # raised on the main thread
                phase["error"] = e

        t = threading.Thread(target=run)
        t.start()
        phase.update(em=em, thread=t)

    try:
        with timer.phase("extract+count(device)"):
            chunks_flushed = 0
            for codes, lens, cblob, cblob_off, fill in stream_chunks(
                    reads_path, CH, plan["B"], plan["L"], plan["mean_len"]):
                if fill == 0:
                    continue
                n_over_acc.append(construct_table_chunk(
                    params, plan, counter, codes, lens, fill, read_base))
                read_base += CH
                # rows past fill are never referenced: length-0 rows
                # produce no windows
                ro = np.full(CH, bytes_base, dtype=np.int64)
                ro[:fill] += cblob_off[:fill]
                blob_parts.append(cblob)
                row_off_parts.append(ro)
                bytes_base += int(cblob.size)
                nb_reads += fill
                chunks_flushed += 1
                if (chunks_flushed == trigger_chunks and "em" not in phase
                        and rec_ok):
                    start_phase1()
            if "thread" in phase:
                phase["thread"].join()  # phase 1 ran under the stream
                if "error" in phase:
                    raise phase["error"]
            row_lo = phase["ph1"].n_pass if "ph1" in phase else 0
            with timer.phase("finalize"):
                nodes = counter.finalize(lazy=True, row_lo=row_lo,
                                         gk_mode="device" if "em" in phase
                                         else "host")
            blob = (np.concatenate(blob_parts) if blob_parts
                    else np.zeros(0, dtype=np.uint8))
            row_off = (np.concatenate(row_off_parts) if row_off_parts
                       else np.zeros(0, dtype=np.int64))
            n_over = sum(int(x) for x in n_over_acc)
            if n_over:
                raise RuntimeError(
                    f"{n_over} reads or batches overflowed minimizer or "
                    "window-slot capacity")

        stats["nb_reads"] = nb_reads
        with timer.phase("sequences+gfa"):
            nodes.prefetch_full("count")  # comes down under the tail emission
            if "em" in phase:
                em = phase["em"]
                pot = counter.edge_join(nodes)
                em.emit_phase(nodes, reads_buf=blob, row_off=row_off)
                counts = nodes.fetch_full("count")
                g = em.finish(counts, pot=pot)
                stats["edge_join"] = em.edge_join
            else:
                g = emit_device_outputs(prefix, params, nodes, blob, row_off,
                                        no_basespace=params.no_basespace)
                counts = nodes.fetch_full("count")
            stats["nb_windows"] = int(counts.sum())
    except BaseException:
        if "thread" in phase:
            phase["thread"].join()
        if "em" in phase:
            phase["em"].gfa.abort()
        raise
    stats.update(g)
    stats.update(phase1_nodes=row_lo, n_over=n_over, read_cap=counter.read_cap,
                 w_slot=plan["w_slot"], mem_budget=int(mem_budget),
                 nb_chunks=chunks_flushed)
    if "ph1" in phase:
        # host seconds of the helper thread, beside the construct loop
        stats.update(phase1_finalize_s=phase["finalize_s"],
                     phase1_emit_s=phase["emit_s"])
    stats["phases"] = timer.report()
    return stats
