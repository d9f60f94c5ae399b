"""Chunked construction: device reduction per chunk, native C++ global merge.

Counterpart of the JAX package's `core/chunked.assemble_device_chunked`
(density and syncmer schemes, --minabund up to MAX_CHUNK_SLOTS;
core/pipeline.assemble sends larger ones to the whole-run path), in
recompute mode for pre-HPC'd reads under the density scheme and in vector
mode for everything else.  With --bf the device construct does
not screen: the Bloom filter is the host merge's (nt_merge_chunk marks a
key's first global sighting and counts from the second).  The input streams
in fixed-size chunks:

  per chunk (device):   unpack -> HPC -> ntHash + density select (the
                        nthash_select kernel) -> compaction -> window keys
                        -> slot append -> per-chunk sort/segment reduce
  host merge (C++):     nt_merge_chunk accumulates global abundances,
                        assigns node ids and reports which keys crossed the
                        min abundance in this chunk, and on which in-chunk
                        appearance (rust-mdbg src/main.rs:680-707)
  device gather:        vec + metadata of exactly the crossing occurrences
  host write:           the chunk's .sequences shard, then the GFA at the end

Recompute mode (core/device_out.minimizer_recompute_ok: reads already
homopolymer-compressed): the gather computes each node's four
(k-1)-overlap fingerprints on the device, 65 B/node instead of the
8k B/node vectors, and the .sequences writer re-derives the minimizer
values from the record's own bytes at device-given positions.  The
fingerprints stay on the device in a bounded DeviceKeyCatalog and the GFA
edge join runs there (ops/edge_join), the host receiving only the candidate
list; when the catalog overflows, or a key group exceeds the join's
G_SLOTS, the run falls back to the host join on fetched fingerprints.

A chunk that does not fit the run's plan is re-planned on the same device
and counted in the stats' `replans`, where the JAX package's driver raises
and its `assemble` re-runs the input through streaming: a read longer than
the staging width (the feed hands it over alone) is staged at its own
staging width with its own slots (core/fastx_feed.long_read_plan), and a
chunk whose reads overflow their minimizer or window slots is re-run at
doubled slots before anything of it reaches the merge
(construct_accepted).  Such a chunk is reduced in a counter of its own and
merged into the same node table.

Node ids follow crossing-occurrence order, so the .gfa is byte-identical
to the JAX package's on the same input and Params.

The feed is core/fastx_feed.StagedFeed: the staging thread stages each
chunk's planes on the device once the previous chunk's construct has ended
(the device slot), so that at most one chunk's staged tensors are alive
during a construct, and the next chunk's copy overlaps the merge and the
writers of the last.

Spans (utils/timing.PhaseTimer), a chunk's marked with its index in the
feed: on the main thread `plan`, `compile`, `setup`, `stream` (in it, a
chunk's `feed-wait`, `construct`, `merge`, `gather`, `meta`, `sequences`,
`reset`) and `gfa`; the feed's threads' spans and counters are
core/fastx_feed's.  Counters of its own: `sequences.frames`, the LZ4
frames of the run's .sequences shards, and `sequences.workers_high`, the
most threads one shard's writer ran (io/sequences.write_records_native).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.sequences import remove_stale, write_records_native
from ..ops import u64
from ..params import Params
from ..utils.timing import PhaseTimer
from .device_out import keys6_from_gk, minimizer_recompute_ok, node_offsets
# host_feed: tests/test_fastx_native.py holds the parser's planes against
# the feed's host packer under this module's name
from .fastx_feed import StagedFeed, host_feed, staging_plan  # noqa: F401
from .graph import IncrementalGFA, build_gfa, build_gfa_precomputed
from .nodetable import NodeTable

#: rows of the device key catalog (ops/edge_join.DeviceKeyCatalog, 65 B a
#: row); a run with more crossing keys spills it and joins on the host
CATALOG_ROWS = 1 << 22

#: occurrence-slot ceiling (the JAX package's MAX_CHUNK_SLOTS): slots =
#: minab are carried per unique key, so crossing capture is exact for any
#: --minabund up to this
MAX_CHUNK_SLOTS = 16


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another; with no GPU and no explicit device this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain torch versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def chunked_eligible(params: Params) -> bool:
    """The chunk emission carries min_abundance occurrence slots, which
    makes the crossing capture exact for any min_abundance up to
    MAX_CHUNK_SLOTS (the merge's selector never exceeds min_abundance).
    Beyond the ceiling core/pipeline.assemble takes the whole-run path."""
    return params.min_kmer_abundance <= MAX_CHUNK_SLOTS or params.reference


def check_device_driver(params: Params):
    """The device drivers (chunked and whole-run) count density and syncmer
    minimizers of reads; everything else is the streaming engine's."""
    if params.error_correct or params.uhs or params.lcp \
            or params.has_lmer_counts or params.reference:
        raise ValueError(
            "error correction, --uhs, --lcp, --lmer-counts and --reference "
            "run through the streaming engine (core/pipeline.assemble)")


def plan_chunks(reads_path: str, params: Params, chunk_reads: int = 0) -> dict:
    """core/fastx_feed.staging_plan with the chunked run's own sizes: reads
    per chunk and batches per chunk."""
    B = min(params.batch_reads, chunk_reads) if chunk_reads > 0 else 0
    plan = staging_plan(reads_path, params, B=B)
    B = plan["B"]
    if chunk_reads > 0:
        # small forced chunks (tests): the batch shrunk to fit the chunk
        chunk_reads = (chunk_reads // B) * B
    else:
        # target ~0.15 GB of window/minimizer buffers per chunk; host
        # staging RSS scales with chunk size, and the chunk is never sized
        # past the input itself (+10%, power-of-2 rounded)
        per_read = 20 * plan["w_slot"] + 12 * plan["M"]
        chunk_reads = max(B, int(1.5e8 / per_read) // B * B)
        est = max(B, int(1.1 * plan["input_bytes"]
                         / max(1, plan["mean_len"])))
        cap2 = B
        while cap2 < est:
            cap2 *= 2
        chunk_reads = min(chunk_reads, cap2)
    return dict(plan, chunk_reads=chunk_reads, n_batches=chunk_reads // B)


def doubled_plan(params: Params, plan: dict, width: int) -> dict:
    """The plan that re-runs a chunk whose reads overflowed: twice the
    minimizer slots (at most the staged width, where the compaction keeps
    every position) and twice the window slots (at most the windows a read
    can have).  Raises when the plan is at both limits already."""
    M = min(2 * plan["M"], width)
    w_slot = max(8, min(M - params.k + 1, 2 * plan["w_slot"]))
    if M == plan["M"] and w_slot == plan["w_slot"]:
        raise RuntimeError(
            "a chunk overflowed its capacity at every minimizer and window "
            "slot of its staged width")
    return dict(plan, M=M, w_slot=w_slot)


def new_counter(params: Params, plan: dict, dev: torch.device):
    """The device counter that every chunk of a run is reduced into."""
    from ..ops.sort_count import DeviceNodeCounter, counter_flags

    return DeviceNodeCounter(
        k=params.k, M=plan["M"], read_cap=plan["chunk_reads"],
        w_slot=plan["w_slot"],
        chunk_slots=min(params.min_kmer_abundance, MAX_CHUNK_SLOTS),
        device=dev, with_ext=counter_flags(params)["with_ext"])


def construct_accepted(params: Params, plan: dict, counter, staged: tuple,
                       lens_d: torch.Tensor, fill: int, width: int) -> tuple:
    """construct_chunk, re-run on the same staged chunk (planes of `width`
    columns) at doubled_plan with a counter of its own until no read
    overflows its minimizer or window slots.  Nothing of a rejected attempt
    leaves the counter it was made in.  Returns (finalize_chunk's result,
    the accepted plan, its counter, the re-plans made)."""
    replans = 0
    while True:
        res, n_over = construct_chunk(params, plan, counter, staged, lens_d,
                                      fill)
        if not n_over:
            return res, plan, counter, replans
        counter.reset_chunk()
        plan = doubled_plan(params, plan, width)
        counter = new_counter(params, plan, lens_d.device)
        replans += 1


def construct_chunk(params: Params, plan: dict, counter, staged: tuple,
                    lens_d: torch.Tensor, fill: int) -> tuple:
    """One staged chunk of `fill` reads (its planes and read lengths on the
    device) through construct_batches and the per-chunk reduction:
    (finalize_chunk's result, the reads and batches
    over their minimizer or window slots).  A chunk with any of those, or
    one that fills every window slot of the counter (the reduction keeps
    one row spare), is not reduced: the result is None."""
    from ..ops.sort_count import construct_batches

    B = plan["B"]
    n_win, n_over = construct_batches(
        params, staged, lens_d, counter.buffers, B=B, M=plan["M"],
        w_slot=plan["w_slot"],
        batch_lo=0, batch_hi=min(plan["n_batches"], (fill + B - 1) // B),
        bf=False)  # --bf is screened by the host merge (nt_merge_chunk)
    n_over = int(n_over) + (int(n_win) >= counter.window_cap)
    if n_over:
        return None, n_over
    return counter.finalize_chunk(), 0


def _host_join_gfa(prefix, params, nodes, gk: np.ndarray, gf: np.ndarray):
    """Host km_index join from id-ordered fingerprints (the path without a
    catalog, after a spill, and the G_SLOTS-overflow fallback)."""
    return build_gfa_precomputed(f"{prefix}.gfa", nodes,
                                 keys6_from_gk(gk, gf),
                                 presimp=params.presimp)


def assemble_device_chunked(reads_path: str, params: Params, prefix: str,
                            timer: PhaseTimer | None = None,
                            stats: dict | None = None,
                            chunk_reads: int = 0, device=None) -> dict:
    """Bounded-memory chunked construction; writes prefix.gfa and the
    prefix.<chunk>.sequences shards and returns the run's stats.  In
    recompute mode the stats also say which join made the edges
    (`edge_join`: "device" or "host") and, for the device join, its
    `catalog_rows`, `n_pot`, `join_device_ms`, `join_dispatch_s` and
    `join_wall_s` (ops/edge_join.PotJoin says what each covers)."""
    from ..ops.edge_join import DeviceKeyCatalog
    from ..ops.kernels import build_all
    from ..ops.sort_count import CLIPPED_MSG

    dev = resolve_device(device)
    check_device_driver(params)
    if not chunked_eligible(params):
        raise RuntimeError(
            f"chunked counting carries at most {MAX_CHUNK_SLOTS} occurrence "
            f"slots; --minabund > {MAX_CHUNK_SLOTS} takes the whole-run path "
            "(core/pipeline.assemble)")
    timer = timer or PhaseTimer()
    stats = stats if stats is not None else {}

    with timer.phase("plan"):
        plan = plan_chunks(reads_path, params, chunk_reads)
    # the kernel build is this port's compile phase (nvcc, first use only)
    with timer.phase("compile"):
        if dev.type == "cuda":
            build_all()
    rec_ok = minimizer_recompute_ok(params)
    with timer.phase("setup"):
        counter = new_counter(params, plan, dev)
        table = NodeTable(
            min_abundance=params.min_kmer_abundance,
            use_bf=params.use_bf,
            bloom_log2_bits=params.bloom_log2_bits,
            keep_all=params.reference,
            capacity_hint=1 << 22,
        )
        remove_stale(prefix)
        # device edge join: the crossing keys accumulate in a bounded
        # device catalog instead of being fetched per chunk; at GFA time
        # the id-order permutation goes up and only the POT list comes down
        catalog = DeviceKeyCatalog(CATALOG_ROWS) if rec_ok else None
        timer.count("sequences.frames", 0)
        timer.high("sequences.workers_high", 0)
        feed = StagedFeed(reads_path, params, plan, dev, timer)
    nb_reads = 0
    nb_windows = 0
    chunk_i = 0
    replans = 0
    vec_ids: list[np.ndarray] = []
    vec_arrs: list[np.ndarray] = []   # [n, k] u64 vectors (vector mode)
    gk_arrs: list[np.ndarray] = []    # [n, 8] u64 fingerprints (recompute)
    gf_arrs: list[np.ndarray] = []    # [n] u8 orientation flags

    def spill_catalog():
        """Move the device catalog to the host arrays (append order kept);
        the run goes on with the host join."""
        nonlocal catalog
        gk_sp, gf_sp = catalog.spill()
        if len(gk_sp):
            gk_arrs.append(gk_sp)
            gf_arrs.append(gf_sp)
        catalog = None

    def flush_chunk(res, ccounter, blob, blob_off, cid):
        """A reduced chunk through: native merge -> crossing gather ->
        .sequences shard, into the run's one node table."""
        nonlocal chunk_i, nb_windows
        with timer.phase("merge", cid):
            sel, _ = table.merge_chunk(
                res["key_lo"], res["key_hi"], res["count"])
            nb_windows += int(res["count"].sum())
        cross = np.nonzero(sel)[0]
        if cross.size:
            occs = ccounter.occ_at_chunk(cross, sel[cross])
            # node ids are assigned in crossing-OCCURRENCE order
            order = np.argsort(occs, kind="stable")
            cross = cross[order]
            occs = occs[order]
            with timer.phase("gather", cid):
                vec = mpos = gk = gflag = None
                n_clipped = 0
                if catalog is not None:
                    gk_d, gf_d, meta, mpos = \
                        ccounter.gather_crossing_keys_dev(occs)
                    if catalog.fits(len(occs)):
                        catalog.append(gk_d, gf_d)
                    else:  # bounded catalog full: spill, go host from here
                        spill_catalog()
                        gk = u64.to_numpy(gk_d)
                        gflag = gf_d.cpu().numpy()
                elif rec_ok:
                    gk, gflag, meta, mpos = ccounter.gather_crossing_keys(
                        occs)
                else:
                    vec, meta, n_clipped = ccounter.gather_crossing(occs)
            if n_clipped:
                raise RuntimeError(CLIPPED_MSG.format(n_clipped))
            seqlen = meta[:, 0].astype(np.uint32)
            shift0, shift1, seq_shift0, seq_shift1, rev, abs_start, \
                abs_end = node_offsets(params, meta, blob_off)
            with timer.phase("meta", cid):
                index_c = table.set_meta_batch(res["key_lo"][cross],
                                               res["key_hi"][cross],
                                               seqlen, shift0, shift1)
                vec_ids.append(index_c)
                if not rec_ok:
                    vec_arrs.append(vec)
                elif gk is not None:  # host mode (no catalog, or spilled)
                    gk_arrs.append(gk)
                    gf_arrs.append(gflag)
            if not params.no_basespace:
                with timer.phase("sequences", cid):
                    wrote = write_records_native(
                        f"{prefix}.{chunk_i}.sequences", params.k, params.l,
                        index_c, vec, blob, abs_start, abs_end, rev,
                        seq_shift0, seq_shift1,
                        hash_bound=params.hash_bound if rec_ok else 0,
                        mpos=mpos)
                timer.count("sequences.frames", wrote["frames"])
                timer.high("sequences.workers_high", wrote["workers"])
        with timer.phase("reset", cid):
            if ccounter is counter:
                counter.reset_chunk()
        chunk_i += 1

    with feed, timer.phase("stream"):
        for chunk in feed:
            nb_reads += chunk.fill
            # a chunk under another plan than the run's (an over-long read)
            # is reduced in a counter of its own, as is one whose reads
            # overflow their slots (construct_accepted)
            own = chunk.plan is not plan
            ccounter = new_counter(params, chunk.plan, dev) if own else counter
            with timer.phase("construct", chunk.cid):
                res, _cplan, ccounter, n_re = construct_accepted(
                    params, chunk.plan, ccounter, chunk.planes, chunk.lens,
                    chunk.fill, chunk.width)
            replans += n_re + own
            blob, blob_off, cid = chunk.blob, chunk.blob_off, chunk.cid
            # free the chunk's staged tensors, then let the stager copy the
            # next one
            del chunk
            feed.release()
            flush_chunk(res, ccounter, blob, blob_off, cid)

    stats["nb_reads"] = nb_reads
    stats["nb_windows"] = nb_windows
    stats["nb_nodes_prefilter"] = len(table)
    stats["nb_chunks"] = chunk_i
    stats["h2d_bytes"] = feed.h2d_bytes
    stats["replans"] = replans

    with timer.phase("gfa"):
        if params.min_kmer_abundance > 1:
            table.retain(params.min_kmer_abundance)
        nodes = table.dump(params.min_kmer_abundance)
        order = (np.argsort(np.concatenate(vec_ids), kind="stable")
                 if vec_ids else np.zeros(0, dtype=np.int64))
        if len(order) != len(nodes["index"]):
            raise RuntimeError("crossing set diverged from passing set")
        if catalog is not None and catalog.n > 0:
            # device join: permute the catalog into id order on the device,
            # feed the S lines while the POT list comes down, then let the
            # native writer apply presimp and the symmetric drop
            stats["catalog_rows"] = catalog.n
            stats["h2d_bytes"] = feed.h2d_bytes + 8 * len(order)
            pot, gk_p, gf_p = catalog.join(order)
            gfa = IncrementalGFA(cap_hint=len(nodes["index"]))
            try:
                gfa.add_chunk(nodes["index"], nodes["abundance"],
                              nodes["seqlen"], nodes["shift0"],
                              nodes["shift1"], None)
                arrays = pot.resolve()
                if arrays is None:  # a key group exceeded G_SLOTS
                    g = _host_join_gfa(prefix, params, nodes,
                                       u64.to_numpy(gk_p),
                                       gf_p.cpu().numpy())
                else:
                    g = gfa.finish_pot(f"{prefix}.gfa", params.presimp,
                                       *arrays)
            finally:
                gfa.abort()
            stats.update(edge_join="host" if arrays is None else "device",
                         n_pot=pot.n_pot, join_device_ms=pot.device_ms,
                         join_dispatch_s=pot.dispatch_s,
                         join_wall_s=pot.wall_s)
        elif rec_ok:
            gk = (np.concatenate(gk_arrs) if gk_arrs
                  else np.zeros((0, 8), dtype=np.uint64))[order]
            gf = (np.concatenate(gf_arrs) if gf_arrs
                  else np.zeros(0, dtype=np.uint8))[order]
            g = _host_join_gfa(prefix, params, nodes, gk, gf)
            stats["edge_join"] = "host"
        else:
            varr = (np.concatenate(vec_arrs) if vec_arrs
                    else np.zeros((0, params.k), dtype=np.uint64))[order]
            g = build_gfa(f"{prefix}.gfa", nodes, varr,
                          presimp=params.presimp)
    stats.update(g)
    stats.update(timer.stats())
    return stats
