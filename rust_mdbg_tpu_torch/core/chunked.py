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
Two environment switches, read once per run, keep the JAX package's names:
MDBG_CHUNK_DEVICE_JOIN=0 takes the host join from the start, and
MDBG_CHUNK_CAT_CAP bounds the catalog's rows (default 2^22).

A chunk that does not fit the run's plan is re-planned on the same device
and counted in the stats' `replans`, where the JAX package's driver raises
and its `assemble` re-runs the input through streaming: a read longer than
the staging width (the feed hands it over alone) is staged at its own
staging width with its own slots (long_read_plan), and a chunk whose reads
overflow their minimizer or window slots is re-run at doubled slots
before anything of it reaches the merge (construct_accepted).  Such a
chunk is reduced in a counter of its own and merged into the same node
table.

Node ids follow crossing-occurrence order, so the .gfa is byte-identical
to the JAX package's on the same input and Params.

The feed: the native parser (core/fastx_feed with the run's packed plan)
writes each chunk's staged planes itself, 2-bit values and invalid mask at
the half width where the chunk's reads fit it, in its parallel encode; the
staging thread takes them and copies them to the device.  An over-long
read's singleton chunk and the pure-Python fallback (.lz4) arrive as codes
and are packed there by host_feed.  A chunk is copied only once the
previous chunk's construct has ended (the device slot): at most one
chunk's staged tensors are alive during a construct, and the next chunk's
copy overlaps the merge and the writers of the last.

Spans (utils/timing.PhaseTimer), a chunk's marked with its index in the
feed: on the main thread `plan`, `compile`, `setup`, `stream` (in it, a
chunk's `feed-wait`, `construct`, `merge`, `gather`, `meta`, `sequences`,
`reset`) and `gfa`; on the staging thread (STAGER_THREAD) a chunk's
`feed.next-wait`, `feed.pack` (taking the parser's planes, or host_feed),
`feed.slot-wait`, `feed.copy` and `feed.put-wait`; on the native parser's
thread (io/fastx_native.PUMP_THREAD) `feed.token-wait` and `feed.parse`
(the planes' pack included).  Counters: `feed.parser_packed_chunks` and
`feed.host_packed_chunks`, the chunks whose planes the parser wrote and
those host_feed packed, `feed.staged_high`, the most chunks whose
staged tensors were alive at once, `sequences.frames`, the LZ4 frames of
the run's .sequences shards, and `sequences.workers_high`, the most
threads one shard's writer ran (io/sequences.write_records_native).
"""

from __future__ import annotations

import os
import queue
import threading
import weakref

import numpy as np
import torch

from ..io import fastx
from ..io.sequences import remove_stale, write_records_native
from ..ops import u64
from ..params import Params, staging_width
from ..utils.timing import PhaseTimer
from .device_out import keys6_from_gk, minimizer_recompute_ok, node_offsets
from .graph import IncrementalGFA, build_gfa, build_gfa_precomputed
from .nodetable import NodeTable

#: name of assemble_device_chunked's staging thread (planes and copy)
STAGER_THREAD = "feed-stager"

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
    """The sizes a chunked run stages and allocates by: staging width L,
    batch B, minimizer slots M, reads per chunk, batches per chunk, window
    slots per read, whether the feed is 2-bit packed, and the half width
    (0 = none) that chunks of short reads are fed at."""
    from ..ops.extract import capacity
    from ..ops.sort_count import window_slot_capacity

    mean_len, mx = fastx.read_first_n_reads(reads_path, 100)
    L = params.max_read_len or staging_width(mx)
    B = params.batch_reads
    M = capacity(params, L)

    if chunk_reads <= 0:
        # target ~0.15 GB of window/minimizer buffers per chunk; host
        # staging RSS scales with chunk size, and the chunk is never sized
        # past the input itself (+10%, power-of-2 rounded)
        per_read = 20 * window_slot_capacity(params, B, L, M) + 12 * M
        chunk_reads = max(B, int(1.5e8 / per_read) // B * B)
        fsize = os.path.getsize(reads_path)
        if str(reads_path).endswith((".gz", ".lz4")):
            fsize *= 6
        est = max(B, int(1.1 * fsize / max(1, mean_len)))
        cap2 = B
        while cap2 < est:
            cap2 *= 2
        chunk_reads = min(chunk_reads, cap2)
    else:
        # small forced chunks (tests): shrink the batch to fit the chunk
        B = min(B, chunk_reads)
        chunk_reads = (chunk_reads // B) * B
    return dict(
        L=L, B=B, M=M, chunk_reads=chunk_reads, n_batches=chunk_reads // B,
        w_slot=window_slot_capacity(params, B, L, M), mean_len=mean_len,
        # 2-bit+mask feed (ops/pack); L is 512-aligned
        packed=L % 8 == 0,
        # chunks whose longest read fits L/2 feed at half width (L carries
        # 2x headroom over the sampled max read length)
        L_half=L // 2 if (L // 2) % 512 == 0 and L // 2 >= 1024 else 0)


def long_read_plan(params: Params, plan: dict, length: int) -> dict:
    """The plan of an over-long read's singleton chunk (the feed hands a
    read longer than the staging width over on its own): one batch of one
    read at the width staging_width(length), with its own minimizer and
    window slots."""
    from ..ops.extract import capacity
    from ..ops.sort_count import window_slot_capacity

    L = staging_width(length)
    M = capacity(params, L)
    return dict(plan, L=L, B=1, M=M, chunk_reads=1, n_batches=1,
                w_slot=window_slot_capacity(params, 1, L, M),
                packed=L % 8 == 0, L_half=0)


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


def host_feed(codes: np.ndarray, lens: np.ndarray, fill: int,
              plan: dict) -> tuple:
    """A parsed chunk's codes as the host arrays copied to the device: cut
    to the half width where its reads fit, then 2-bit packed (packed,
    mask) or left as (codes,).  The chunked driver's native feed gets the
    same planes from the parser (fastx_feed.stream_chunks' packed_half);
    this packs the codes of every other feed."""
    from ..ops.pack import pack_codes_np

    if codes.shape[1] != plan["L"]:
        raise ValueError(f"codes of width {codes.shape[1]} for a plan of "
                         f"staging width {plan['L']}")
    L_half = plan["L_half"]
    if L_half and int(lens[:fill].max()) <= L_half:
        codes = np.ascontiguousarray(codes[:, :L_half])
    return pack_codes_np(codes) if plan["packed"] else (codes,)


def to_device(host: tuple, lens: np.ndarray, dev: torch.device) -> tuple:
    """host_feed's arrays and the read lengths copied to dev:
    (staged tuple, lengths)."""
    return (tuple(torch.from_numpy(a).to(dev) for a in host),
            torch.from_numpy(lens).to(dev))


def new_counter(params: Params, plan: dict, dev: torch.device):
    """The device counter that every chunk of a run is reduced into."""
    from ..ops.sort_count import DeviceNodeCounter, counter_flags

    return DeviceNodeCounter(
        k=params.k, M=plan["M"], read_cap=plan["chunk_reads"],
        w_slot=plan["w_slot"],
        chunk_slots=min(params.min_kmer_abundance, MAX_CHUNK_SLOTS),
        device=dev, with_ext=counter_flags(params)["with_ext"])


def construct_accepted(params: Params, plan: dict, counter, staged: tuple,
                       lens_d: torch.Tensor, fill: int) -> tuple:
    """construct_chunk, re-run on the same staged chunk at doubled_plan
    with a counter of its own until no read overflows its minimizer or
    window slots.  Nothing of a rejected attempt leaves the counter it was
    made in.  Returns (finalize_chunk's result, the accepted plan, its
    counter, the re-plans made)."""
    # the staged columns (host_feed may have cut the chunk to L_half)
    width = staged[0].shape[1] * (4 if plan["packed"] else 1)
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
    """One staged chunk of `fill` reads through construct_batches and the
    per-chunk reduction: (finalize_chunk's result, the reads and batches
    over their minimizer or window slots).  A chunk with any of those, or
    one that fills every window slot of the counter (the reduction keeps
    one row spare), is not reduced: the result is None."""
    from ..ops.sort_count import construct_batches

    B = plan["B"]
    n_win, n_over = construct_batches(
        params, staged if plan["packed"] else staged[0], lens_d,
        counter.buffers, B=B, M=plan["M"], w_slot=plan["w_slot"],
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
        catalog = None
        if rec_ok and os.environ.get("MDBG_CHUNK_DEVICE_JOIN", "1") != "0":
            catalog = DeviceKeyCatalog(
                int(os.environ.get("MDBG_CHUNK_CAT_CAP", 1 << 22)))
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    nb_reads = 0
    nb_windows = 0
    h2d_bytes = 0
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

    def construct(staged, lens_d, ready, fill, cplan, cid):
        """A chunk staged by the chunk plan `cplan` through the device
        reduce: (finalize_chunk's result, the counter it was reduced in).
        A chunk under another plan than the run's (an over-long read, or
        reads over their slots) is reduced in a counter of its own.  `cid`,
        the chunk's index in the feed, marks its spans."""
        nonlocal replans
        own = cplan is not plan
        ccounter = new_counter(params, cplan, dev) if own else counter
        with timer.phase("construct", cid):
            if ready is not None:
                # the stager copied on its own stream: wait for it, and
                # tell the allocator these tensors are used on this stream
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(ready)
                for t in (*staged, lens_d):
                    t.record_stream(cur)
            res, cplan, ccounter, n_re = construct_accepted(
                params, cplan, ccounter, staged, lens_d, fill)
            replans += n_re + own
        return res, ccounter

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

    from .fastx_feed import stream_chunks

    it = iter(stream_chunks(
        reads_path, plan["chunk_reads"], plan["B"], plan["L"],
        plan["mean_len"], timer=timer,
        packed_half=plan["L_half"] if plan["packed"] else None))
    n_pulled = 0

    # the device slot: the stager copies a chunk only once main's construct
    # of the last one has ended and dropped its staged tensors
    device_slot = threading.Semaphore(1)
    live_lock = threading.Lock()
    n_live = 0
    for name in ("feed.parser_packed_chunks", "feed.host_packed_chunks",
                 "sequences.frames"):
        timer.count(name, 0)
    for name in ("feed.staged_high", "sequences.workers_high"):
        timer.high(name, 0)

    def track_staged(t: torch.Tensor):
        """Count a staged chunk alive until its 2-bit plane `t` is freed
        (main drops the chunk's tensors together); the most alive at once
        is the counter feed.staged_high."""
        nonlocal n_live

        def freed():
            nonlocal n_live
            with live_lock:
                n_live -= 1

        with live_lock:
            n_live += 1
            timer.high("feed.staged_high", n_live)
        weakref.finalize(t, freed).atexit = False

    def fetch_and_stage():
        """Pull the next parsed chunk, take the planes the parser wrote (or
        pack its codes), wait for the device slot and copy it to the device
        (on the side stream for CUDA, recording an event the consumer waits
        on); the chunk's index in the feed ends the tuple.  None at the end
        of the input, or when the run stops while the stager waits."""
        nonlocal h2d_bytes, n_pulled
        while True:
            cid = n_pulled
            with timer.phase("feed.next-wait") as span:
                tup = next(it, None)
                if tup is not None:
                    span["chunk"] = cid
            if tup is None:
                return None
            n_pulled += 1
            codes, lens, blob, blob_off, fill = tup
            del tup
            if fill == 0:
                continue
            with timer.phase("feed.pack", cid):
                cplan = plan
                if isinstance(codes, tuple):  # the parser wrote the planes
                    host = codes
                    timer.count("feed.parser_packed_chunks", 1)
                else:
                    if codes.shape[1] != plan["L"]:  # an over-long read
                        cplan = long_read_plan(params, plan, int(lens[0]))
                        wide = np.full((1, cplan["L"]), 4, dtype=np.uint8)
                        wide[:, : codes.shape[1]] = codes
                        codes = wide
                    host = host_feed(codes, lens, fill, cplan)
                    if cplan["packed"]:
                        timer.count("feed.host_packed_chunks", 1)
                del codes
            h2d_bytes += sum(a.nbytes for a in host) + lens.nbytes
            with timer.phase("feed.slot-wait", cid):
                while not device_slot.acquire(timeout=0.5):
                    if stop_feed.is_set():
                        return None
            with timer.phase("feed.copy", cid):
                ready = None
                if side is not None:
                    with torch.cuda.stream(side):
                        staged, lens_d = to_device(host, lens, dev)
                        ready = torch.cuda.Event()
                        ready.record(side)
                else:
                    staged, lens_d = to_device(host, lens, dev)
                track_staged(staged[0])
            return staged, lens_d, ready, blob, blob_off, fill, cplan, cid

    # Double-buffered feed: the staging thread takes chunk N+1's planes and,
    # once chunk N's construct has ended, copies them while the main thread
    # runs chunk N's host merge and writers.
    q: "queue.Queue" = queue.Queue(maxsize=1)
    stop_feed = threading.Event()

    def _stager():
        while not stop_feed.is_set():
            try:
                item = fetch_and_stage()
            except BaseException as e:  # surfaced on the main thread
                item = e
            # bounded put that notices a consumer abort
            with timer.phase("feed.put-wait",
                             item[-1] if isinstance(item, tuple) else None):
                while not stop_feed.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
            if item is None or isinstance(item, BaseException):
                return
            del item  # main alone holds a queued chunk's staged tensors

    stager = threading.Thread(target=_stager, name=STAGER_THREAD,
                              daemon=True)
    stager.start()
    try:
        with timer.phase("stream"):
            while True:
                with timer.phase("feed-wait") as span:
                    item = q.get()
                    if isinstance(item, tuple):
                        span["chunk"] = item[-1]
                if isinstance(item, BaseException):
                    raise item
                if item is None:
                    break
                staged, lens_d, ready, blob, blob_off, fill, cplan, cid = item
                del item
                nb_reads += fill
                res, ccounter = construct(staged, lens_d, ready, fill, cplan,
                                          cid)
                # free the chunk's staged tensors, then let the stager copy
                # the next one
                del staged, lens_d, ready
                device_slot.release()
                flush_chunk(res, ccounter, blob, blob_off, cid)
    finally:
        stop_feed.set()
        stager.join(timeout=60)

    stats["nb_reads"] = nb_reads
    stats["nb_windows"] = nb_windows
    stats["nb_nodes_prefilter"] = len(table)
    stats["nb_chunks"] = chunk_i
    stats["h2d_bytes"] = h2d_bytes
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
            stats["h2d_bytes"] = h2d_bytes + 8 * len(order)
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
