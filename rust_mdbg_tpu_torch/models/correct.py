"""Minimizer-space error correction with POA consensus.

Counterpart of the JAX package's `models/correct.py`, with the same
drivers and the same bytes out.  What runs on the device: the triage
scorer of the sequential driver (ops/align, the semiglobal_scores kernel on
the card) and the POA DP of the lockstep driver (ops/poa_device, the
poa_dp kernel).  Neither is wrapped in a fall-back: the JAX package's
`poa_correct` drops its triage on any exception and its lockstep driver
takes the host DP when a graph overflows its bucket; here a failing kernel
raises out of the run, and the DP takes any graph.  The forked
`--ec-procs` workers run the numpy twin of the scorer (CUDA does not
survive fork) and the host DP, as the JAX package's do.

Driver parity with the reference's EC path:

- `dist`: Jaccard / containment / Mash distance between reads in minimizer
  space (rust-mdbg src/minimizers.rs:22-42)
- `poa_correct`: bucket lookup by n-consecutive-minimizer normalized tuples,
  recruitment below distance 0.15, candidate cap 80, fwd+rev semiglobal POA
  alignment with the better direction re-aligned and woven into the graph,
  heaviest-path consensus, template-boundary trim, consensus labeling up to
  correction_threshold (rust-mdbg src/read.rs:414-557)
- `run_error_correction`: chunked pass over the .ec_data records writing
  `.postcor.ec_data` and `.poa.ec_data` (main.rs:846-897)
- `reingest_postcor`: rebuild the node table from corrected reads, with
  read_to_kmers seqlen semantics (true slice length, read.rs:358-413) and
  single-writer .sequences emission (main.rs:903-914)
"""

from __future__ import annotations

import contextlib
import gc
import math
import os

import numpy as np
import torch

from ..io import ec_data
from ..io.sequences import SequencesWriter
from ..utils.seq import normalize_vec, revcomp
from .poa import PoaGraph, consensus_boundary

DIST_THRESHOLD = 0.15
MAX_POA_READS = 80


def _c0_rate(n, dt):
    return n / dt if dt > 0 else 0.0


def dist(a_transformed, b_transformed, params, sets=None) -> float:
    """sets: optional (set_a, set_b) precomputed (EcRead.tset) — the values
    are ignored for membership, only |∩| / |∪| are taken, so passing cached
    sets is exact."""
    s1, s2 = sets if sets is not None else (set(a_transformed),
                                            set(b_transformed))
    inter = len(s1 & s2)
    union = len(s1) + len(s2) - inter
    if params.distance == 0:
        return 1.0 - inter / union
    if params.distance == 1:
        return 1.0 - inter / len(s1)
    jac = inter / union
    if jac == 0.0:
        return float("inf")
    return -1.0 * math.log((2.0 * jac) / (1.0 + jac)) / params.l


class EcRead:
    __slots__ = ("id", "seq", "transformed", "pos", "corrected", "_tset")

    def __init__(self, rid, seq, transformed, pos):
        self.id = rid
        self.seq = seq
        self.transformed = [int(x) for x in transformed]
        self.pos = [int(x) for x in pos]
        self.corrected = False
        self._tset = None

    @property
    def tset(self) -> frozenset:
        """Cached minimizer set — the recruit distance filter touches every
        (template, candidate) pair, and rebuilding both sets per pair was
        the top EC profile line (634k set constructions per 0.3 Mbp)."""
        if self._tset is None:
            self._tset = frozenset(self.transformed)
        return self._tset


@contextlib.contextmanager
def _frozen_heap():
    """At genome scale the resident structures (reads_by_id, buckets, the
    parsed records) hold 10^8+ Python objects; every generational GC pass
    walks them all, which collapsed throughput ~100x at 100 Mbp.  They are
    acyclic (refcounting frees them), so they are frozen into the permanent
    generation: collections walk only the loop's transients, and forked
    workers inherit a frozen heap.  The collector stays enabled."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def _recruit(read: EcRead, buckets, params, reads_by_id):
    """Bucket lookup (read.rs:437-448) + distance filter/sort/cap
    (read.rs:450-456) -> [(candidate EcRead, dist)]."""
    n = params.n
    template = read.transformed
    # skip degenerate buckets during the count: low-complexity n-tuples
    # hold a constant FRACTION of all reads (heavy tail), so iterating them
    # makes recruit O(corpus)/read; genuine dist<0.15 neighbors share ~1e2
    # windows through NORMAL buckets, so the cap leaves their counts >= m.
    cap, m = params.ec_bucket_cap, params.ec_min_shared
    # count shared windows per candidate (dict preserves first-appearance
    # order, so the downstream distance-sort tie order is unchanged)
    counts: dict = {}
    get = counts.get
    for i in range(len(template) - n + 1):
        key = normalize_vec(template[i : i + n])
        lst = buckets.get(key, ())
        if cap and len(lst) > cap:
            continue
        for rid in lst:  # noqa: B905
            counts[rid] = get(rid, 0) + 1
    rid_self = read.id
    bucket_reads = [reads_by_id[rid] for rid, c in counts.items()
                    if c >= m and rid != rid_self]
    tset = read.tset
    with_dist = [
        (q, dist(template, q.transformed, params, sets=(tset, q.tset)))
        for q in bucket_reads
    ]
    with_dist = [t for t in with_dist if t[1] < DIST_THRESHOLD]
    with_dist.sort(key=lambda t: t[1])
    return with_dist[:MAX_POA_READS]


def _rev_candidate(q: EcRead, params):
    rev_t = q.transformed[::-1]
    rev_seq = revcomp(q.seq)
    rev_pos = [len(q.seq) - params.l - p for p in q.pos[::-1]]
    return rev_t, rev_seq, rev_pos


def poa_correct(read: EcRead, int_to_minimizer, buckets, params, corrected_map,
                reads_by_id, poa_map, *, device):
    template = read.transformed
    graph = PoaGraph(template, read.seq, read.pos)
    with_dist = _recruit(read, buckets, params, reads_by_id)

    # device pre-triage: score all candidates fwd+rev against the LINEAR
    # template in one launch (2B queries); when the margin is decisive,
    # skip one of the two per-candidate graph alignments.  (The reference
    # scores against the growing graph, read.rs:485-519; margins within
    # TRIAGE_MARGIN take the exact double graph alignment.)  A scorer
    # failure raises: no try, so a failing kernel is never a silently
    # slower run.
    TRIAGE_MARGIN = 4
    triage = None
    if getattr(params, "ec_fast_triage", True) and with_dist:
        from ..ops.align import semiglobal_scores_batch

        qs = [q.transformed for q, _ in with_dist]
        s = semiglobal_scores_batch(template, qs + [q[::-1] for q in qs],
                                    device=device).astype(int)
        triage = s[: len(qs)] - s[len(qs):]

    poa_ids = []
    for ci, (q, _d) in enumerate(with_dist):
        poa_ids.append(q.id)
        if triage is not None and triage[ci] > TRIAGE_MARGIN:
            use_fwd = True
        elif triage is not None and triage[ci] < -TRIAGE_MARGIN:
            use_fwd = False
        else:
            use_fwd = (graph.semiglobal(q.transformed).score
                       > graph.semiglobal(q.transformed[::-1]).score)
        if use_fwd:
            aln = graph.semiglobal(q.transformed)
            graph.add_alignment(aln, q.transformed, q.seq, q.pos)
        else:
            rev_t, rev_seq, rev_pos = _rev_candidate(q, params)
            aln = graph.semiglobal(rev_t)
            graph.add_alignment(aln, rev_t, rev_seq, rev_pos)

    return _finish(read, graph, with_dist, params, int_to_minimizer,
                   corrected_map, poa_map, poa_ids)


def _finish(read, graph, with_dist, params, int_to_minimizer, corrected_map,
            poa_map, poa_ids):
    """Consensus + boundary trim + correction labeling + template mutation
    (the tail of the reference's poa_correct, read.rs:520-557)."""
    template = read.transformed
    cns, cns_es = graph.consensus(params.t)
    cns, cns_es = consensus_boundary(cns, cns_es, template)
    if not cns:
        return None
    consensus_read = [int_to_minimizer[m] for m in cns] if int_to_minimizer \
        else ["" for _ in cns]
    cns_str = ""
    cns_pos = []
    idx = 0
    for insert in cns_es:
        cns_pos.append(idx)
        cns_str += insert
        idx += len(insert)
    cns_pos.append(idx)
    cns_str += int_to_minimizer[cns[-1]] if int_to_minimizer else ""

    threshold = params.correction_threshold
    corrected_count = 0
    for q, _d in with_dist:
        if corrected_count >= threshold:
            break
        if not q.corrected:
            corrected_map[q.id] = (cns_str, consensus_read, cns_pos, cns)
            corrected_count += 1
    poa_map[read.id] = poa_ids
    read.seq = cns_str
    read.pos = cns_pos
    read.transformed = [int(x) for x in cns]
    read._tset = None  # invalidate the cached minimizer set
    read.corrected = True
    return read


def run_error_correction_lockstep(prefix, params, int_to_minimizer, buckets,
                                  reads_by_id_raw, *, device):
    """Device-batched EC: templates advance through their candidates in
    LOCKSTEP chunks, each round aligning every active template's next
    candidate (fwd AND rev) in one launch of the POA DP
    (ops/poa_device, the poa_dp kernel on the card) — the device analog of
    the reference's crossbeam thread-chunks (main.rs:855-883), which also
    run one template per thread concurrently.  Per-template results equal
    the sequential driver with exact double alignment (ec_fast_triage
    off); the only divergence is WHICH templates get skipped as
    already-corrected: the sequential driver checks before every template,
    this one at chunk boundaries — a deterministic instance of the
    reference's thread-racy corrected map.
    """
    records = ec_data.load(prefix)
    reads_by_id = {
        rid: EcRead(rid, r["seq"], r["transformed"], r["pos"])
        for rid, r in reads_by_id_raw.items()
    }
    postcor = ec_data.EcWriter(f"{prefix}.postcor")
    poa_file = ec_data.EcWriter(f"{prefix}.poa")
    with _frozen_heap():
        _lockstep_rounds(records, postcor, poa_file, params,
                         int_to_minimizer, buckets, reads_by_id, device)


def _lockstep_rounds(records, postcor, poa_file, params, int_to_minimizer,
                     buckets, reads_by_id, device):
    from ..ops.poa_device import poa_semiglobal_device

    corrected_map: dict = {}
    poa_map: dict = {}
    CH = max(1, int(getattr(params, "ec_chunk", 32)))
    recs = list(records)
    import os as _os
    import sys as _sys
    import time as _time

    _prog = _os.environ.get("MDBG_EC_PROGRESS")
    _t0 = _time.perf_counter()
    _tlast = _t0
    _nlast = 0
    for c0 in range(0, len(recs), CH):
        if _prog and c0 and c0 % (CH * 8) == 0:
            _now = _time.perf_counter()
            print(f"# ec {c0}/{len(recs)} "
                  f"inst={_c0_rate(c0 - _nlast, _now - _tlast):.1f} r/s "
                  f"avg={_c0_rate(c0, _now - _t0):.1f} r/s "
                  f"ncorr={len(corrected_map)}", file=_sys.stderr, flush=True)
            _tlast, _nlast = _now, c0
        states = []  # [read, graph, with_dist, poa_ids]
        for rec in recs[c0 : c0 + CH]:
            if rec.seq_id in corrected_map:
                continue
            read = EcRead(rec.seq_id, rec.seq_str, rec.read_transformed,
                          rec.read_minimizers_pos)
            graph = PoaGraph(read.transformed, read.seq, read.pos)
            states.append([read, graph,
                           _recruit(read, buckets, params, reads_by_id), []])
        max_c = max((len(s[2]) for s in states), default=0)
        for ci in range(max_c):
            act = [s for s in states if ci < len(s[2])]
            if not act:
                break
            graphs, queries = [], []
            for s in act:
                q = s[2][ci][0]
                graphs += [s[1], s[1]]
                queries += [q.transformed, q.transformed[::-1]]
            alns = poa_semiglobal_device(graphs, queries, device=device)
            for t, s in enumerate(act):
                q = s[2][ci][0]
                s[3].append(q.id)
                fwd, bwd = alns[2 * t], alns[2 * t + 1]
                if fwd.score > bwd.score:
                    s[1].add_alignment(fwd, q.transformed, q.seq, q.pos)
                else:
                    rev_t, rev_seq, rev_pos = _rev_candidate(q, params)
                    s[1].add_alignment(bwd, rev_t, rev_seq, rev_pos)
        for read, graph, with_dist, poa_ids in states:
            out = _finish(read, graph, with_dist, params, int_to_minimizer,
                          corrected_map, poa_map, poa_ids)
            if out is None:
                continue
            postcor.record(out.id, out.seq, out.transformed,
                           [int_to_minimizer.get(x, "")
                            for x in out.transformed]
                           if int_to_minimizer else [],
                           out.pos)
    for temp, ids in poa_map.items():
        poa_file.record_poa(temp, ids)
    postcor.flush()
    postcor.close()
    poa_file.flush()
    poa_file.close()


def _ec_pass(recs, out_prefix, params, int_to_minimizer, buckets,
             reads_by_id, tag="", *, device):
    """One sequential host-path EC pass over `recs`, writing
    {out_prefix}.postcor.ec_data / {out_prefix}.poa.ec_data — the loop body
    shared by the in-process driver and each forked shard worker
    (main.rs:846-897)."""
    import sys as _sys
    import time as _time

    postcor = ec_data.EcWriter(f"{out_prefix}.postcor")
    poa_file = ec_data.EcWriter(f"{out_prefix}.poa")
    corrected_map: dict = {}
    poa_map: dict = {}
    prog = os.environ.get("MDBG_EC_PROGRESS")
    t0 = _time.perf_counter()
    tlast, nlast = t0, 0
    for i, rec in enumerate(recs):
        if prog and i and i % 256 == 0:
            now = _time.perf_counter()
            print(f"# ec{tag} {i}/{len(recs)} "
                  f"inst={_c0_rate(i - nlast, now - tlast):.1f} r/s "
                  f"avg={_c0_rate(i, now - t0):.1f} r/s "
                  f"ncorr={len(corrected_map)}", file=_sys.stderr, flush=True)
            tlast, nlast = now, i
        if rec.seq_id in corrected_map:
            continue
        read = EcRead(rec.seq_id, rec.seq_str, rec.read_transformed,
                      rec.read_minimizers_pos)
        out = poa_correct(read, int_to_minimizer, buckets, params,
                          corrected_map, reads_by_id, poa_map, device=device)
        if out is None:
            continue
        postcor.record(out.id, out.seq, out.transformed,
                       [int_to_minimizer.get(x, "") for x in out.transformed]
                       if int_to_minimizer else [],
                       out.pos)
    for temp, ids in poa_map.items():
        poa_file.record_poa(temp, ids)
    postcor.flush()
    postcor.close()
    poa_file.flush()
    poa_file.close()


def _ec_shard_worker(w, records, lo, hi, prefix, params, int_to_minimizer,
                     buckets, reads_by_id):
    """Forked child: records/buckets/reads_by_id are inherited copy-on-write
    pages — nothing is pickled.  CUDA must not be touched in the child (a
    CUDA context does not survive fork, and the parent's extraction has
    made one on the card), so the triage scorer is pinned to its numpy
    twin (`device=None`): the one place a non-kernel scorer runs with a
    card present."""
    _ec_pass(records[lo:hi], f"{prefix}.part{w}", params, int_to_minimizer,
             buckets, reads_by_id, tag=f"[w{w}]", device=None)


def run_error_correction_procs(prefix, params, int_to_minimizer, buckets,
                               reads_by_id_raw, nprocs):
    """Process-parallel EC: fork `nprocs` workers over contiguous template
    shards — the process analog of the reference's crossbeam thread-chunks
    (main.rs:855-883).  Each worker runs the exact sequential host path over
    its shard and writes {prefix}.part{w}.postcor/.poa part files; the
    parent concatenates them in shard order.

    Parity: with correction_threshold == 0 (the default) the corrected map
    never populates, so the concatenated output is BYTE-IDENTICAL to the
    sequential driver (tests/test_ec_procs.py) — assuming unique read ids
    (sequential poa_map dedups duplicate-id templates into one .poa line,
    while duplicate ids split across shards would emit one line each).
    With a threshold > 0 the already-corrected skips are per-shard — a
    deterministic instance of the reference's thread-racy corrected map
    (read.rs:529-543 under main.rs:855-883's concurrent chunks)."""
    import multiprocessing as mp
    import shutil

    if "fork" not in mp.get_all_start_methods():
        raise RuntimeError(
            "--ec-procs needs the 'fork' start method (workers inherit the "
            "parsed corpus copy-on-write); unavailable on this platform — "
            "drop --ec-procs to run the sequential driver")
    if torch.cuda.is_initialized():
        import warnings

        warnings.warn(
            "--ec-procs forking with a live CUDA context in the parent; "
            "CUDA does not support fork — workers avoid the card "
            "(numpy scorer) but inherited context state can still "
            "deadlock on some drivers")

    records = ec_data.load(prefix)
    reads_by_id = {
        rid: EcRead(rid, r["seq"], r["transformed"], r["pos"])
        for rid, r in reads_by_id_raw.items()
    }
    # freeze before forking: children inherit a permanent-generation heap,
    # so no worker's GC ever walks the 10^8-object resident structures
    with _frozen_heap():
        bounds = [len(records) * i // nprocs for i in range(nprocs + 1)]
        ctx = mp.get_context("fork")
        try:
            procs = []
            for w in range(nprocs):
                pr = ctx.Process(
                    target=_ec_shard_worker,
                    args=(w, records, bounds[w], bounds[w + 1], prefix,
                          params, int_to_minimizer, buckets, reads_by_id))
                pr.start()
                procs.append(pr)
            fails = []
            for w, pr in enumerate(procs):
                pr.join()
                if pr.exitcode != 0:
                    fails.append((w, pr.exitcode))
            if fails:
                raise RuntimeError("EC shard workers failed (worker, "
                                   f"exitcode): {fails}")
            for kind in ("postcor", "poa"):
                with open(f"{prefix}.{kind}.ec_data", "w") as out:
                    for w in range(nprocs):
                        part = f"{prefix}.part{w}.{kind}.ec_data"
                        with open(part) as f:
                            shutil.copyfileobj(f, out)
        finally:
            # success or failure, no stale part files survive (a later run
            # would silently re-concatenate them on a name collision)
            for kind in ("postcor", "poa"):
                for w in range(nprocs):
                    try:
                        os.remove(f"{prefix}.part{w}.{kind}.ec_data")
                    except OSError:
                        pass


def run_error_correction(prefix, params, int_to_minimizer, buckets,
                         reads_by_id_raw, *, device):
    """Correct all reads from prefix.ec_data; write .postcor/.poa files.
    The device stages (the triage scorer, the lockstep DP) run on
    `device`; None is the forked workers' numpy scorer, never a
    driver's, so it raises here."""
    device = torch.device(device)
    nprocs = int(getattr(params, "ec_procs", 0))
    if nprocs >= 1:
        # >= 1, not > 1: --ec-procs takes precedence over --ec-device-poa
        # (params.py doc), so --ec-procs 1 runs one forked shard worker
        # (tests/test_ec_procs.py::test_ec_procs_single_worker_identical)
        return run_error_correction_procs(
            prefix, params, int_to_minimizer, buckets, reads_by_id_raw,
            nprocs)
    if getattr(params, "ec_device_poa", False):
        return run_error_correction_lockstep(
            prefix, params, int_to_minimizer, buckets, reads_by_id_raw,
            device=device)
    records = ec_data.load(prefix)
    reads_by_id = {
        rid: EcRead(rid, r["seq"], r["transformed"], r["pos"])
        for rid, r in reads_by_id_raw.items()
    }
    with _frozen_heap():
        _ec_pass(records, prefix, params, int_to_minimizer, buckets,
                 reads_by_id, device=device)


def read_to_kmers_postcor(read: EcRead, params):
    """read_to_kmers over a corrected read (read.rs:358-413): seqlen is the
    TRUE slice length here, unlike the main path's approximation."""
    from ..ops.kminmer import window_kminmers_np

    k, l = params.k, params.l
    pos = np.asarray(read.pos, dtype=np.int64)
    hashes = np.asarray(read.transformed, dtype=np.uint64)
    out = []
    for w in window_kminmers_np(pos, hashes, k, l):
        seq = read.seq[w["start"] : w["end"]]
        if w["reversed"]:
            seq = revcomp(seq)
        w = dict(w)
        w["seq"] = seq
        w["seqlen"] = len(seq)
        out.append(w)
    return out


def reingest_postcor(prefix, params, table, seq_writer):
    """Rebuild the mdBG from prefix.postcor.ec_data (main.rs:903-914)."""
    from ..ops.kminmer import fingerprint128_np

    records = ec_data.load(f"{prefix}.postcor")
    if seq_writer is None:
        seq_writer = SequencesWriter(prefix, 0, params.k, params.l)
    for rec in records:
        read = EcRead(rec.seq_id, rec.seq_str, rec.read_transformed,
                      rec.read_minimizers_pos)
        if len(read.transformed) <= params.k:
            continue
        windows = read_to_kmers_postcor(read, params)
        if not windows:
            continue
        vecs = np.asarray([w["vec"] for w in windows], dtype=np.uint64)
        fp = fingerprint128_np(vecs)
        flags, index = table.add_batch(
            fp[:, 0], fp[:, 1],
            np.asarray([w["seqlen"] for w in windows], dtype=np.uint32),
            np.asarray([w["shift"][0] for w in windows], dtype=np.uint16),
            np.asarray([w["shift"][1] for w in windows], dtype=np.uint16),
        )
        for j in np.nonzero(flags)[0]:
            idx = int(index[j])
            table.vectors[idx] = vecs[j].copy()
            if not params.no_basespace:
                w = windows[j]
                seq_writer.record(idx, w["vec"], w["seq"], "*", w["shift"])
    return seq_writer


def assemble_from_postcor(params, prefix):
    """--restart-from-postcor: skip extraction+correction (main.rs:338,903-914)."""
    from ..core.graph import build_gfa
    from ..core.nodetable import NodeTable
    from ..io.sequences import remove_stale

    remove_stale(prefix)
    table = NodeTable(min_abundance=params.min_kmer_abundance)
    writer = reingest_postcor(prefix, params, table, None)
    writer.close()
    stats = {"nb_reads": 0, "nb_nodes_prefilter": len(table)}
    if params.min_kmer_abundance > 1:
        table.retain(params.min_kmer_abundance)
    nodes = table.dump()
    stats.update(build_gfa(f"{prefix}.gfa", nodes, table.vectors,
                           presimp=params.presimp))
    return stats
