"""The assembly entry point, the streaming engine and the whole-run driver.

Counterpart of the JAX package's `core/pipeline.py`.  `assemble` routes a
run as `python -m rust_mdbg_tpu` does.  Density and syncmer runs go to the
device drivers: the chunked driver (core/chunked, bounded memory at any
input size) whenever `chunked_eligible`, and `assemble_device_table` for
--minabund beyond the chunk-slot ceiling, where the crossing occurrence is
selected on the device by one reduction over every window of the run.
Everything else (--error-correct, --lmer-counts, --uhs, --lcp, --reference,
--read-stats, --engine host) is the streaming engine: batches of reads
through an extraction engine (ops/extract.DeviceExtractor on the device,
or the numpy host engine of core/extract), the native node table,
.sequences records at the abundance-crossing occurrence, the abundance
filter, the GFA.  Under --error-correct the first pass writes the
per-read records (.ec_data) instead of .sequences, models/correct corrects
them (the triage scorer or the lockstep POA DP on the device), and the
node table is rebuilt from the corrected reads (`error-correct` and
`reingest` phases, main.rs:846-914).

The JAX `assemble` drops to its host engine when the device engine cannot
be made, and to its streaming half when a device driver raises (a read
past the staging width, reads over their minimizer or window slots, an
input over the whole-run budget at --minabund beyond the chunk slots).
The port catches no device failure.  Its drivers re-plan on the same
device instead: an over-long read or an overflowing chunk is re-staged at
its own width or at doubled slots (core/chunked), the whole run restarts
at the wider width or the doubled slots, and an over-budget run that the
chunked driver cannot take is sent to the streaming engine before any
device work.  Every route writes the JAX package's bytes.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ..io import fastx
from ..io.ec_data import EcWriter
from ..io.sequences import SequencesWriter, remove_stale
from ..params import Params
from ..utils.seq import normalize_vec, revcomp
from ..utils.timing import PhaseTimer
from .chunked import (assemble_device_chunked, check_device_driver,
                      chunked_eligible, resolve_device)
from .device_out import (PhasedEmitter, emit_device_outputs,
                         minimizer_recompute_ok)
from .extract import extract_windows_host
from .fastx_feed import StagedFeed, staging_plan
from .graph import build_gfa
from .nodetable import NodeTable

#: batches per staged chunk of the whole-run driver
CHUNK_BATCHES = 16

#: whole-run buffer budget on the CPU, bytes: the JAX package's figure, but
#: held against another count.  The port's buffers come to read_cap x (24 x
#: w_slot + 12 or 16 x M) bytes (plan_table's per_read), the JAX package
#: counts read_cap x (20 x W_slot + 12 x M), so near the threshold the two
#: packages can take different routes.  Every route writes the same bytes;
#: only the route differs.
CPU_MEM_BUDGET = 4_000_000_000

#: share of the card's free memory the whole-run buffers may take: the
#: reduction's temporaries (three stable sort passes over 8-byte keys with
#: index planes, the sorted planes, head positions) come to several times
#: the 24 B per key row that the buffers hold
CUDA_BUDGET_SHARE = 0.2


def _device_table_eligible(params: Params, read_stats_path) -> bool:
    return (
        params.engine != "host"
        and not params.error_correct
        and not params.reference
        and not (params.uhs or params.lcp or params.has_lmer_counts)
        and read_stats_path is None
    )


def _pick_engine(params: Params, dev: torch.device, minimizer_to_int=None,
                 uhs_filter=None, lcp_filter=None):
    """The extraction engine of a streaming run: the DeviceExtractor on
    `dev`, or None for --engine host (the numpy engine of core/extract)."""
    if params.engine == "host":
        return None
    from ..ops.extract import make_device_extractor

    return make_device_extractor(params, dev, minimizer_to_int, uhs_filter,
                                 lcp_filter)


def assemble(reads_path: str, params: Params, prefix: str,
             read_stats_path: str | None = None, device=None,
             mem_budget: int | None = None) -> dict:
    """Run the single-k assembly on `device` (CUDA unless named); writes
    prefix.gfa and the prefix.*.sequences shards, returns the stats dict.

    With read_stats_path the run mirrors the reference's read_stats mode
    (main.rs:938-1004): after the abundance filter it writes the per-read
    k-min-mer abundances of that file's reads to `<file>.read_stats` and
    returns WITHOUT writing a GFA.

    Whatever the route, the run is one `job` span (utils/timing.PhaseTimer)
    and the stats end with its record: `phases`, `spans` and `counters`
    (`rss_start_bytes`, `rss_high_bytes`, and `nthash_positions`, the
    positions the nthash_select kernel's launches covered)."""
    from ..ops import kernels

    timer = PhaseTimer()
    stats: dict = {}
    with timer.job():
        dev = resolve_device(device)
        if params.engine not in ("device", "host"):
            raise ValueError(f"engine {params.engine!r}: device or host")
        positions = kernels.nthash_select.positions
        if not _device_table_eligible(params, read_stats_path):
            stats = assemble_streaming(reads_path, params, prefix,
                                       read_stats_path, dev, timer, stats)
        elif chunked_eligible(params):
            stats = assemble_device_chunked(
                reads_path, params, prefix, timer, stats,
                chunk_reads=params.chunk_reads, device=dev)
        else:
            stats = assemble_device_table(reads_path, params, prefix, timer,
                                          stats, device=dev,
                                          mem_budget=mem_budget)
        timer.count("nthash_positions",
                    kernels.nthash_select.positions - positions)
    stats.update(timer.stats())
    return stats


def assemble_streaming(reads_path: str, params: Params, prefix: str,
                       read_stats_path: str | None, dev: torch.device,
                       timer: PhaseTimer, stats: dict) -> dict:
    """The streaming engine: fixed-shape read batches through the
    extraction engine and the native node table.  The stats carry the
    extractor's counts (`host_rows`, `tiled_rows`, `tile_host_rows`) and
    its filter's fill (`filter_fill`: set Bloom bits, or the exact set's
    size)."""
    # --- parameter-dependent preparation ---------------------------------
    minimizer_to_int = int_to_minimizer = None
    if params.has_lmer_counts or params.error_correct:
        from ..ops.minimizers import minimizers_preparation

        lmer_counts = {}
        if params.has_lmer_counts and getattr(params, "_lmer_counts_path",
                                              None):
            lmer_counts = load_lmer_counts(params._lmer_counts_path)
        minimizer_to_int, int_to_minimizer, _ = minimizers_preparation(
            params, lmer_counts)

    uhs_filter = lcp_filter = None
    if params.uhs and getattr(params, "_uhs_path", None):
        from ..models.schemes import uhs_preparation

        uhs_filter = uhs_preparation(params, params._uhs_path)
    if params.lcp and getattr(params, "_lcp_path", None):
        from ..models.schemes import lcp_preparation

        lcp_filter = lcp_preparation(params, params._lcp_path)

    remove_stale(prefix)

    table = NodeTable(
        min_abundance=params.min_kmer_abundance,
        use_bf=params.use_bf,
        bloom_log2_bits=params.bloom_log2_bits,
        keep_all=params.reference,
    )

    with timer.phase("compile"):
        if dev.type == "cuda" and (params.engine != "host"
                                   or params.error_correct):
            from ..ops.kernels import build_all

            build_all()
    device_extract = _pick_engine(params, dev, minimizer_to_int, uhs_filter,
                                  lcp_filter)

    seq_writer = None
    ec_writer = (EcWriter(prefix) if params.reference or params.error_correct
                 else None)
    # error correction: .sequences come from the corrected reads
    # (reingest), and every read's record is kept for the correction pass
    write_seqs_first_pass = not params.error_correct
    buckets: dict[tuple, list[str]] = {}
    reads_by_id: dict = {}

    max_len = params.max_read_len
    if max_len <= 0:
        _mean_len, mx = fastx.read_first_n_reads(reads_path, 100)
        max_len = max(1024, 2 * mx)
    nb_reads = 0
    nb_windows = 0

    use_compact = device_extract is not None and ec_writer is None

    with timer.phase("extract+count"):
        for batch in fastx.batches(reads_path, params.batch_reads, max_len):
            if use_compact:
                wb = device_extract.extract_compact(batch)
                get_vecs = wb.vecs_for
            elif device_extract is not None:
                wb = device_extract(batch)
                get_vecs = lambda idx: wb.vecs[idx]  # noqa: E731
            else:
                wb = extract_windows_host(batch, params, minimizer_to_int,
                                          uhs_filter, lcp_filter)
                get_vecs = lambda idx: wb.vecs[idx]  # noqa: E731
            nb_reads += batch.n_reads
            nb_windows += wb.n_windows
            if params.debug and getattr(wb, "minimizers", None):
                # per-read minimizer-space representation (the reference's
                # debug display, main.rs:802-807)
                for row, m in enumerate(wb.minimizers):
                    if m is not None and batch.ids[row]:
                        print(batch.ids[row],
                              " ".join(str(int(x)) for x in m[1]))
            flags, index = table.add_batch(
                wb.key_lo, wb.key_hi, wb.seqlen, wb.shift0, wb.shift1
            )
            # record .sequences lines for crossing occurrences
            hit = np.nonzero(flags)[0]
            if hit.size:
                vecs = get_vecs(hit)
                for vi, j in enumerate(hit):
                    table.vectors[int(index[j])] = vecs[vi].copy()
                if write_seqs_first_pass and not params.no_basespace:
                    if seq_writer is None:
                        seq_writer = SequencesWriter(prefix, 0, params.k,
                                                     params.l)
                    for vi, j in enumerate(hit):
                        row = int(wb.read_row[j])
                        raw = batch.raw[row]
                        s = raw[int(wb.start[j]) : int(wb.end[j])].decode()
                        if wb.reversed_[j]:
                            s = revcomp(s)
                        seq_writer.record(
                            int(index[j]), vecs[vi], s, "*",
                            (int(wb.seq_shift0[j]), int(wb.seq_shift1[j])),
                        )

            if ec_writer is not None:
                for row in range(batch.codes.shape[0]):
                    m = wb.minimizers[row] if row < len(wb.minimizers) else None
                    if m is None:
                        continue
                    pos, hashes = m
                    if len(hashes) < params.n:
                        continue
                    rid = batch.ids[row]
                    seq_str = batch.raw[row].decode()
                    if params.reference:
                        seq_str = seq_str.replace("\n", "").replace("\r",
                                                                     "")
                    ec_writer.record(rid, seq_str, hashes, [], pos)
                    if params.error_correct:
                        t = [int(x) for x in hashes]
                        reads_by_id[rid] = dict(
                            id=rid, seq=seq_str, transformed=t,
                            pos=[int(x) for x in pos])
                        for i in range(len(t) - params.n + 1):
                            buckets.setdefault(
                                normalize_vec(t[i : i + params.n]), []
                            ).append(rid)

    if ec_writer is not None:
        ec_writer.flush()
    stats["nb_reads"] = nb_reads
    stats["nb_windows"] = nb_windows
    if device_extract is not None:
        stats.update(device_extract.stats)
        stats["filter_fill"] = device_extract.filter_fill()

    # --- error correction pass ------------------------------------------
    if params.error_correct:
        from ..models.correct import reingest_postcor, run_error_correction

        with timer.phase("error-correct"):
            run_error_correction(prefix, params, int_to_minimizer, buckets,
                                 reads_by_id, device=dev)
        with timer.phase("reingest"):
            table.clear()
            seq_writer = reingest_postcor(prefix, params, table, seq_writer)
    if seq_writer is not None:
        seq_writer.close()

    # --- abundance filter -----------------------------------------------
    stats["nb_nodes_prefilter"] = len(table)
    if params.min_kmer_abundance > 1:
        table.retain(params.min_kmer_abundance)

    if read_stats_path is not None:
        with timer.phase("read-stats"):
            run_read_stats(reads_path, read_stats_path, params, table,
                           f"{read_stats_path}.read_stats")
        stats["phases"] = timer.report()
        return stats

    with timer.phase("gfa"):
        nodes = table.dump()
        g = build_gfa(f"{prefix}.gfa", nodes, table.vectors,
                      presimp=params.presimp)
    stats.update(g)
    stats["phases"] = timer.report()
    return stats


def load_lmer_counts(path: str) -> dict[str, int]:
    """Parse k-mer-counter output: `<lmer> <count>` lines, canonicalized
    (main.rs:546-566)."""
    counts: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            lmer = parts[0]
            lrev = revcomp(lmer)
            counts[min(lmer, lrev)] = int(parts[1])
    return counts


def run_read_stats(reads_path: str, stats_path: str, params: Params,
                   table: NodeTable, out_path: str):
    """Second input pass writing per-read k-min-mer abundances
    (read_stats mode, main.rs:938-1004 + read_stats.rs)."""
    max_len = max(1024, 2 * fastx.read_first_n_reads(stats_path, 100)[1])
    with open(out_path, "w") as out:
        for batch in fastx.batches(stats_path, params.batch_reads, max_len,
                                   keep_raw=False):
            wb = extract_windows_host(batch, params)
            ab = table.lookup_batch(wb.key_lo, wb.key_hi)
            for row in range(batch.codes.shape[0]):
                if batch.lengths[row] == 0:
                    continue
                sel = wb.read_row == row
                counts = "".join(f"{int(a)} " for a in ab[sel])
                out.write(f"{batch.ids[row]}: {counts}\n")


def whole_run_budget(dev: torch.device) -> int:
    """Bytes the whole-run counter buffers may take on `dev`."""
    if dev.type != "cuda":
        return CPU_MEM_BUDGET
    free, _total = torch.cuda.mem_get_info(dev)
    return int(CUDA_BUDGET_SHARE * free)


def plan_table(reads_path: str, params: Params, L: int = 0,
               m_mult: int = 1) -> dict:
    """core/fastx_feed.staging_plan with the whole-run pass's own sizes:
    the estimated read capacity, the counter flags, reads per staged chunk,
    and the buffer bytes per read that the budget is held against.

    A re-planned pass names its width L (an over-long read came) or
    multiplies the minimizer and window slots by m_mult (reads overflowed
    them), each capped where it holds every position and window."""
    from ..ops.sort_count import counter_flags, window_slot_capacity

    plan = staging_plan(reads_path, params, L=L)
    B, L = plan["B"], plan["L"]
    M = min(L, plan["M"] * m_mult)
    est_reads = max(1024, int(1.5 * plan["input_bytes"]
                              / max(1, plan["mean_len"])))
    w_slot = window_slot_capacity(params, B, L, M)
    flags = counter_flags(params)
    if flags["use_bf"]:
        frac = float(os.environ.get("MDBG_BF_SLOT_FRAC", "1.0"))
        w_slot = max(8, (int(w_slot * frac) + 7) & ~7)
    if m_mult > 1:
        w_slot = max(8, min(M - params.k + 1, w_slot * m_mult))
    return dict(
        plan, M=M, w_slot=w_slot, m_mult=m_mult, flags=flags,
        read_cap=((est_reads + B - 1) // B) * B,
        chunk_reads=CHUNK_BATCHES * B,
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
    bytes (default: whole_run_budget) goes, before any device work, to the
    chunked driver when it is chunked_eligible and to the streaming engine
    on the same device otherwise (stats `route`: "streaming (over whole-run
    budget)").

    A read longer than the staging width, or reads or batches over their
    minimizer or window slots, restart the pass on the same device at
    staging_width of that read or at doubled slots (plan_table); the stats
    count the restarts in `replans`, and a re-planned run is held against
    the budget again.

    With --bf (counter_flags' use_bf) the Bloom screen runs on the device
    and drops each key's first sighting before the counter, so the reduction
    sorts post-filter rows only.  How many survive depends on the input
    (error rate x coverage), so shrinking the per-batch slot with them is
    opt-in: MDBG_BF_SLOT_FRAC scales W_slot, and an overflowing slot aborts
    the pass (a re-plan at doubled slots) rather than truncating.

    Recompute mode (pre-HPC'd reads) emits in two phases: at a power-of-two
    chunk count near a quarter of the estimated input a reduction over the
    filled prefix finds the nodes that have crossed already, and a helper
    thread writes their records and GFA rows while the main thread goes on
    constructing.  The stats say so: `phase1_nodes` (0 when the phase never
    fired) with the helper's `phase1_finalize_s` and `phase1_emit_s`,
    `edge_join`, `read_cap`, `w_slot`, `mem_budget`, `replans`.
    """
    from ..ops.kernels import build_all

    dev = resolve_device(device)
    check_device_driver(params)
    timer = timer or PhaseTimer()
    stats = stats if stats is not None else {}
    if mem_budget is None:
        mem_budget = whole_run_budget(dev)

    plan = plan_table(reads_path, params)
    replans = 0
    while plan["read_cap"] * plan["per_read"] <= mem_budget:
        with timer.phase("compile"):
            if dev.type == "cuda":
                build_all()
        plan = _table_pass(reads_path, params, prefix, plan, dev, timer,
                           stats)
        if plan is None:
            stats.update(mem_budget=int(mem_budget), replans=replans)
            stats["phases"] = timer.report()
            return stats
        replans += 1
    if chunked_eligible(params):
        stats = assemble_device_chunked(reads_path, params, prefix, timer,
                                        stats, device=dev)
    else:
        stats["route"] = "streaming (over whole-run budget)"
        stats = assemble_streaming(reads_path, params, prefix, None, dev,
                                   timer, stats)
    stats["replans"] = stats.get("replans", 0) + replans
    return stats


def _table_pass(reads_path: str, params: Params, prefix: str, plan: dict,
                dev: torch.device, timer: PhaseTimer, stats: dict):
    """One whole-run pass under `plan`, fed by core/fastx_feed.StagedFeed:
    None when it wrote the outputs and filled `stats`, or the plan to
    restart under when a read is longer than the staging width or reads
    overflowed their slots (whatever the pass had written is abandoned; the
    restart rewrites it)."""
    from ..ops.sort_count import construct_batches

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

    def abandon():
        if "thread" in phase:
            phase["thread"].join()
        if "em" in phase:
            phase["em"].gfa.abort()

    longest = 0  # the widest staging width an over-long read asked for
    B = plan["B"]
    try:
        with timer.phase("extract+count(device)"):
            chunks_flushed = 0
            with StagedFeed(reads_path, params, plan, dev, timer) as feed:
                for chunk in feed:
                    if chunk.plan is not plan:
                        # an over-long read (the feed stages it alone at its
                        # own width): the pass will restart at the widest
                        # such width, so the rest of the input is only fed
                        longest = max(longest, chunk.plan["L"])
                    if not longest:
                        if read_base + CH > counter.read_cap:
                            counter.grow(read_base + CH)
                        n_over_acc.append(construct_batches(
                            params, chunk.planes, chunk.lens,
                            counter.buffers, B=B, M=plan["M"],
                            w_slot=plan["w_slot"], batch_lo=0,
                            batch_hi=min(CHUNK_BATCHES,
                                         (chunk.fill + B - 1) // B),
                            read_base=read_base)[1])
                    fill, cblob, cblob_off = (chunk.fill, chunk.blob,
                                              chunk.blob_off)
                    del chunk  # its staged tensors, before the slot frees
                    feed.release()
                    if longest:
                        continue
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
                    if (chunks_flushed == trigger_chunks
                            and "em" not in phase and rec_ok):
                        start_phase1()
            if "thread" in phase:
                phase["thread"].join()  # phase 1 ran under the stream
                if "error" in phase:
                    raise phase["error"]
            if longest:
                abandon()
                return plan_table(reads_path, params, L=longest,
                                  m_mult=plan["m_mult"])
            if sum(int(x) for x in n_over_acc):
                # reads or batches over their minimizer or window slots:
                # restart at doubled slots
                abandon()
                grown = plan_table(reads_path, params, L=plan["L"],
                                   m_mult=2 * plan["m_mult"])
                if (grown["M"], grown["w_slot"]) == (plan["M"],
                                                    plan["w_slot"]):
                    raise RuntimeError(
                        "reads overflowed every minimizer and window slot "
                        "of the staging width")
                return grown
            row_lo = phase["ph1"].n_pass if "ph1" in phase else 0
            with timer.phase("finalize"):
                nodes = counter.finalize(lazy=True, row_lo=row_lo,
                                         gk_mode="device" if "em" in phase
                                         else "host")
            blob = (np.concatenate(blob_parts) if blob_parts
                    else np.zeros(0, dtype=np.uint8))
            row_off = (np.concatenate(row_off_parts) if row_off_parts
                       else np.zeros(0, dtype=np.int64))

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
        abandon()
        raise
    stats.update(g)
    stats.update(phase1_nodes=row_lo, read_cap=counter.read_cap,
                 w_slot=plan["w_slot"], nb_chunks=chunks_flushed)
    if "ph1" in phase:
        # host seconds of the helper thread, beside the construct loop
        stats.update(phase1_finalize_s=phase["finalize_s"],
                     phase1_emit_s=phase["emit_s"])
    return None
