#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mbp 20]

(`--multihost-worker` is the multihost legs' own worker mode: phase 16
starts two processes of this script with it.  `--construct-ab TREE ...`
times only the construct kernels of each checkout root given, in that
order (e.g. a parent tree, this one, this one, the parent), on the one
card.  `--cards 4` runs, on four
cards, only `four_card_phase`: `--mesh 4` with a shard a card and four
multihost processes of one card each over NCCL, against the one-device
runs; the default run needs one card.)

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (nvidia-smi), and the nvcc build of
   every kernel under rust_mdbg_tpu_torch/csrc/ (one nvcc per source, all
   started together);
2. each kernel against its plain torch version on the card, with exact
   (integer) comparison: at the shape the main path gives it, timed with
   CUDA events after warm-up (the EC kernels in phase 15, at their legs'
   own shapes), and at small ragged shapes (nthash_select: l
   from 1 to 64, odd L, an unaligned row slice, edge rows, N and code 5 in
   the tile halos; syncmer_select: s = 0, l = 32, w = 1, odd L, B = 1, L
   below w, an unaligned row slice, and rows of one base, short repeats
   and two-letter noise where the incumbent walk's fix-up runs long;
   compact_minimizers: the main path's [512, 24576] on nthash_select's
   selection and on adversarial rows (none selected, every column, a
   chunk over its capacity, C + 1 in one chunk so that the slots past the
   kept minimizers read column L - 1, the last column alone), the bench's
   [128, 24576], the sharded [256, 24576], M = 4,192 under --syncmers,
   the tiler's [8, 1049088], odd L, an unaligned row slice, nch * C < M
   and M == L, with rows whose runs cross the warps' chunk boundaries,
   and B = 1, 2, 100 and 133; window_keys:
   both modes, the keys plane and the slot append with its counters, at
   the main path's [512, 256], the bench's [128, 256], M = 4,192, odd M,
   k = 1, 2, 7, 21, a slot too small for the batch, window coordinates
   past 2^32 before their u32 mask, B = 1, 13 and 1,500, rows of M
   windows beside rows of none and rows of three window groups.  The two
   construct kernels are timed as bare launches queued behind a spin
   kernel (their device time; L2 warm, and cold with the cache flushed
   before each launch) at the main path's and the bench's shapes, beside
   the launch floor (an empty kernel of the same grid and block shape);
   as bare launches; through their wrappers, with the wrappers' host time
   by piece.
   (`--construct-ab TREE...` runs only those timings, of each source tree
   in turn, one process a tree);
3. slice parity: a small synthetic corpus through the port on "cuda" and on
   "cpu" — the .gfa must be byte-identical and the .sequences records equal;
   then the same corpus as pre-HPC'd input (reads_already_hpc=True,
   recompute mode) on "cuda", on "cpu", and on "cuda" with the device edge
   join switched off: all three .gfa byte-identical, records equal, the
   device join not bypassed, the kernel launched;
4. the main path at users' scale: the bench.py corpus shape (20 Mbp genome,
   20% segmental duplications, 52x of 24,576 bp reads, 0.3% substitutions,
   ~1.04 Gbp) at the reference's HG002 parameters k=21, l=14, d=0.003,
   minabund 2, through `assemble_device_chunked(device="cuda")`, twice:
   as raw reads (vector mode) and as pre-HPC'd reads (bench.py's own
   configuration: recompute mode, the device key catalog and the device
   edge join).  Kernel launch counts are set to 0 just before each leg and
   read just after; every kernel of the path must have launched in each
   (nthash_select, compact_minimizers and window_keys);
5. the construct breakdown: torch.profiler over one chunk of that corpus
   (construct_batches + finalize_chunk, after a warm-up), device time by
   kernel name, kernel launches a batch, and the device's busy time over
   the profiled window (beside the same chunk's unprofiled wall time);
6. whole-run parity: the parity corpus through `assemble_device_table` on
   "cuda" and on "cpu" as raw reads, as pre-HPC'd reads (in batches of 16
   reads, so that enough chunks flow for phase 1 to fire) and as pre-HPC'd
   reads with --bf: .gfa bytes and .sequences records equal between the
   devices, and the whole-run graph's (LN, KC) node multiset and edge
   count equal to the chunked leg's on the same input (for --bf a chunked
   run whose Bloom filter is the host table's);
7. the whole-run main path on the same main.fa at [512, 24576] batches
   (max_read_len = 24,576, bench.py's staging width), three legs:
   pre-HPC'd reads at minabund 2 through `assemble_device_table` (bench.py's
   configuration: phased emission, the device join), raw reads at minabund
   17 through `core/pipeline.assemble` (the route a user reaches), and the
   first leg again with --bf;
8. the finalize breakdown: torch.profiler over one `finalize_compact` of
   the whole pre-HPC'd main corpus, device time by torch op;
9. scheme parity on the parity corpus, cuda = cpu in .gfa bytes and
   .sequences records: --syncmers raw and pre-HPC'd through the chunked
   driver and, on a 120x corpus of its own, at minabund 17 through the
   whole-run table; through the streaming engine --lmer-counts, --uhs, --uhs --bf, --lcp (reads with N),
   --reference on a 1.3 + 0.2 Mbp genome (tiled extraction, .ec_data bytes
   too) and --read-stats (.read_stats bytes); every streaming leg and the
   raw syncmer leg also against the numpy host engine (--engine host);
10. three scheme legs over main.fa at [512, 24576] batches: (d) --syncmers
    -s 4 raw through `assemble` (the chunked driver), (e) --uhs --bf
    through the streaming engine, (f) --reference on the corpus's own
    genome as one record; each with its wall, phases, graph, peak device
    memory, rows re-extracted on the host, filter fill and the launches of
    both kernels; a leg fails when more than 1 % of its rows were
    re-extracted on the host (parity legs too) or a tile was;
11. the fault legs (after the scheme parity legs): cuda = cpu on the runs
    the JAX package finishes only through its streaming fall-back, each
    with its re-plans or route: a read three times the sampled length after
    read 100 (chunked and whole run), a forced small minimizer capacity
    (chunked and whole run), an over-budget run at minabund 17 (streaming,
    density and syncmers), and a chunk re-planned until its minimizer
    slots equal its staged width (M == L == 4,096: the compaction's flat
    branch at a two-level width, seen on the card);
12. the syncmer breakdown: torch.profiler over one [512, 24576] batch of
    the count-path extraction under --syncmers, device time by torch op
    and the fused kernel's share;
13. the branch legs: branches the CPU tests force, forced on the card
    with existing knobs, cuda = cpu, each with the stat that shows it was
    taken: the device key catalog's spill, `DeviceNodeCounter.grow`, rows
    re-extracted on the host by the streaming engine, a tile over its
    capacity, and a key group over the device join's G_SLOTS;
14. the tools (the reference's second binary and utils/ scripts):
    magic-simplify of the raw parity leg's cuda and cpu graphs (equal
    contig bytes), of the raw chunked main leg step by step on the native
    gfa_asm engine (contig count, N50, size against the genome), and
    multik through the CLI: on the card over the parity corpus (rounds k =
    10, 15, 20, 25, each launching nthash_select; the launch count is set
    to 0 just before and read just after), and on a 2 Mbp corpus whose
    103 kb contig is fed back, on the card and with --device cpu, the same
    final contigs;
15. error correction: the EC kernels against their plain versions in
    phase 2 (semiglobal_scores: T = 0 and 1, Q = 1, empty queries,
    queries past the template, Q + 1 at each strip edge up to 513
    columns, queries of 5,000 in register tiles; poa_dp: 24 grown graphs,
    in-degree > 8, more than 1,024 nodes, queries of 1,500 in register
    tiles, m + 1 at each strip edge, a one-node graph, B = 1, the widest
    pair beside the smallest, 140 pairs (more pairs than
    multiprocessors), each batch with the default ring, no ring
    and a two-row ring so that the kernel's count shows every
    predecessor route taken, and the Alignments against the host DP);
    EC parity legs cuda = cpu in
    .ec_data, .postcor.ec_data, .poa.ec_data, .gfa and .sequences bytes
    (the sequential driver with triage, the lockstep driver, --ec-procs
    2, --restart-from-postcor);
    then two EC main legs through `ec-scale` on the card (10 kb reads,
    30x, 0.3 % substitutions, k=8 l=10 d=0.02): the sequential driver
    with triage on a 0.1 Mbp genome and the lockstep driver
    (--device-poa, --ec-chunk 64) on 1 Mbp, each with its identity before
    and after, error-correct and reingest seconds, reads/s, the shapes
    each kernel saw and its launches; each kernel timed at the widest
    launch of its leg, against its plain version there: launch_ms (the
    bare launch, the table's ms) and wrapper_ms (checks, host sync and
    allocation included);
16. multi-device construction (parallel/): sharded parity on the parity
    corpus at --mesh 4 (four shards on the one card), cuda = cpu in .gfa
    bytes and .sequences records, the distributed join = the gathered join
    (MDBG_SHARDED_EDGES=0), the (KC, LN, shift) node map equal to the
    chunked raw leg's, and again at presimp 0.6 (removals counted); the
    sharded main legs, main.fa through `assemble_sharded` at --mesh 4 and
    --mesh 2, each with its wall, phases (feed, steps, finalize,
    sequences, gfa), windows and unique keys a shard (the JAX run keeps at
    most 2^20 a shard), peak device memory and nthash_select launches, the
    (LN, KC) node multiset and edge count equal to the chunked raw leg's;
    and the multihost legs, two processes of this script on the card
    joined over gloo (--multihost-worker): 1,500 parity reads in two equal
    shares, whose .gfa bytes and records equal `assemble_sharded` at
    --mesh 2 on the interleaved order, and main.fa, whose node set, KC
    values and edge count equal the chunked raw leg's; then nthash_select
    against its plain version at every [rows, width] shape these legs'
    shard steps ran at (their `staged_shapes`).  With `--cards 4` the
    kernel is held against its plain version at the four-card legs'
    shapes on each of the four cards.
17. the experiments phase (run right after phase 14; experiments/,
    eval/, utils/timing): (a) quality-n50's three error legs (err 0.003,
    0.0003, 0) at its protocol (k=35, l=12, d=0.002, --bf, minabund 2,
    pre-HPC'd 24,576 bp reads at 100x, 20 % repeats) on a genome cut
    from 100 to QUALITY_GENOME_MBP = 10 Mbp (1.0 Gbp a leg), each with
    its record (nodes, edges, contigs, N50, largest, seconds) and
    nthash_select launches, and one leg at 1 Mbp x 10 on the card and on
    the CPU, the same record and contig bytes; (b) experiments/scaling at
    its protocol, meshes of 1, 2, 4 and 8 shards on the card and two gloo
    processes, one graph across them; (c) scale_demo.parity_check at its
    0.52 Gbp, whole run = chunked in GFA bytes over at least four chunks;
    (d) eval/recovery_grid, one point (k=21, l=12, d=0.003) on the parity
    corpus and its genome, the same recovery on the card and on the CPU;
    (e) the relay_diag loops (RSS after each of 8 copies of 100 MB: H2D
    from pageable and from pinned memory, D2H); (f) one chunk inside
    PhaseTimer.phase(..., profile_dir=...), whose trace must hold the
    nthash_select kernel; then nthash_select against its plain version
    at every (l, hash bound, rows, width) these parts launched it at on
    the card (recorded in-process by NthashShapes, and the scaling
    processes' `staged_shapes`).
18. the benchmark entry (rust_mdbg_tpu_torch/bench.py, the port's
    bench.py; run last): (a) bench.py's corpus (20 Mbp genome, 52x of
    24,576 bp reads, 1.038 Gbp, staged on the card) through the module's
    functions, a warm-up and one timed rep, the device loop, the link
    rate, the packed feed and the chunked driver over the same reads as
    FASTA; the JSON line printed, its nodes, edges, windows and unique
    keys equal to the JAX package's on the same corpus (BENCH_r03-r05),
    the bench's graph equal to the chunked driver's (gfa_signature); (b)
    the --bf mode (2^32-bit Bloom filter, window slots scaled by
    MDBG_BF_SLOT_FRAC, default 0.5) on a 5 Mbp genome at 52x: every read
    within its slots and the graph equal to the chunked driver's with
    --bf; then nthash_select against its plain version at every shape
    the phase launched it at, [128, 24576] among them.  The main leg
    traces one more rep: its kernel launches, launches a batch, busy time
    and top kernels.  compact_minimizers and window_keys launch on every
    chunked, whole-run and bench leg, the compaction alone on the sharded
    and streaming legs (the kernels line's launches_by_leg).

It prints the kernel table as one JSON line, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}}.  Generated inputs and outputs
live in .smoke_tmp/ beside this script and are removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

#: where the port's entry points run; a rehearsal of this script's control
#: flow on a machine without a card may set it to "cpu" from outside, the
#: script itself never does
DEVICE = "cuda"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the non-tensor
#: 32-bit rate used for integer lane operations
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


#: the share of a streaming leg's reads that may overflow their compaction
#: slots and be re-extracted on the host before the leg fails
HOST_ROW_SHARE = 0.01


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _nthash_batch(np, seed: int, B: int, L: int, l: int):
    """Codes with N (4) sprinkled in, ragged lengths with the edge rows 0,
    1, l-1 and L, HPC padding (4) past each length, code 5 in the last
    columns of a row, and N and code 5 in every tile's halo (the l-1
    columns past each 4,096-position tile)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.001] = 4
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lengths[:4] = [0, 1, min(max(0, l - 1), L), L][:B]
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    codes[-1, -7:] = 5
    for t0 in range(4096, L, 4096):
        halo = codes[4:, t0 : t0 + l - 1]
        halo[rng.random(halo.shape) < 0.2] = 4
        halo[rng.random(halo.shape) < 0.2] = 5
    return codes, lengths


def _mismatches(torch, got, want) -> int:
    return int(((got[0] != want[0]) | (got[1] != want[1])).sum())


def check_nthash_select(torch, np, hash_bound: int) -> dict:
    """The kernel vs its plain version: at the main path's batch shape,
    timed, and at small ragged shapes for l from 1 to 64, odd L, and a row
    slice at an unaligned offset, and the tiler's [8, 1049088]."""
    from rust_mdbg_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    cases = {}
    small = [((24, 12291), l, 0) for l in (1, 12, 13, 14, 31, 32, 64)]
    small += [((25, 12291), 14, 3), ((25, 4099), 64, 3), ((9, 37), 14, 0),
              ((9, 37), 64, 0), ((16, 5008), 31, 0),
              # the long-sequence tiler's shape (ops/extract)
              ((8, 1_049_088), 14, 0)]
    for (B, L), l, skip in small:
        codes, lengths = _nthash_batch(np, 100 + l, B, L, l)
        # a row slice of a contiguous tensor: rows start at skip * L bytes
        c = torch.from_numpy(codes).to(dev)[skip:]
        n = torch.from_numpy(lengths).to(dev)[skip:]
        want = kernels.nthash_select_plain(c, l, hash_bound, n)
        key = f"[{B - skip}, {L}] l={l}" + (f" rows {skip}:" if skip else "")
        cases[key] = _mismatches(
            torch, kernels.nthash_select(c, l, hash_bound, n), want)

    B, L, l = 512, 24576, 14
    codes, lengths = _nthash_batch(np, 7, B, L, l)
    c = torch.from_numpy(codes).to(dev)
    n = torch.from_numpy(lengths).to(dev)
    canon_p, sel_p = kernels.nthash_select_plain(c, l, hash_bound, n)
    canon_k, sel_k = kernels.nthash_select(c, l, hash_bound, n)
    torch.cuda.synchronize()
    bad = (canon_k != canon_p) | (sel_k != sel_p)
    main_mismatches = int(bad.sum())
    max_abs_err = 0.0
    if main_mismatches:
        ck = canon_k[bad].cpu().numpy().view(np.uint64).astype(object)
        cp = canon_p[bad].cpu().numpy().view(np.uint64).astype(object)
        max_abs_err = float(max(abs(int(a) - int(b)) for a, b in zip(ck, cp)))
    n_sel = int(sel_k.sum())
    del canon_k, sel_k, canon_p, sel_p

    ms = cuda_time_ms(lambda: kernels.nthash_select(c, l, hash_bound, n), 50)
    plain_ms = cuda_time_ms(
        lambda: kernels.nthash_select_plain(c, l, hash_bound, n), 5)
    # a streaming yardstick, not the same function: torch's fill of the
    # kernel's two outputs, the write stream alone (9 B/position)
    out64 = torch.empty((B, L), dtype=torch.int64, device=dev)
    out8 = torch.empty((B, L), dtype=torch.bool, device=dev)
    fill_ms = cuda_time_ms(lambda: (out64.fill_(0), out8.fill_(False)), 50)
    fill_bytes = B * L * (8 + 1)
    del out64, out8
    # least time: each input read once (codes 1 B + lengths 4 B/row), each
    # output written once (canon 8 B + sel 1 B); the bound is the bytes.
    # Operations, printed beside it for information only: the rolling
    # design issues ~35 thread instructions per position (one roll step of
    # 2 byte extracts, a 16-byte table load, 2 64-bit rotates by 1 and
    # XORs, the unsigned 64-bit min and the sel test, plus l/16 warm-up
    # steps and the staging), an estimate counted as 32-bit lane operations
    nbytes = B * L * (1 + 8 + 1) + B * 4
    nops = B * L * 35
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return dict(
        name="nthash_select", route="cuda",
        source="rust_mdbg_tpu_torch/csrc/nthash_select.cu",
        replaces="rust_mdbg_tpu/ops/pallas_kernels.py:103",
        launches=0, max_abs_err=max_abs_err,
        mismatches=main_mismatches + sum(cases.values()),
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        bound_share=bound_ms / ms, ops_bound_ms=t_ops, library_ms=None,
        gbytes_per_s=nbytes / ms / 1e6, fill_ms=fill_ms,
        fill_gbytes_per_s=fill_bytes / fill_ms / 1e6,
        shape=[B, L], l=l, selected=n_sel, cases=cases)


def check_nthash_at(torch, np, hash_bound: int, shapes, devices,
                    l: int = 14) -> dict:
    """The kernel vs its plain version at the [rows, width] shapes a leg's
    shard steps ran at (the legs' `staged_shapes`), on tensors on each of
    `devices`: mismatches by case."""
    from rust_mdbg_tpu_torch.ops import kernels

    cases = {}
    for B, L in shapes:
        codes, lengths = _nthash_batch(np, 200 + B, B, L, l)
        for dev in devices:
            c = torch.from_numpy(codes).to(dev)
            n = torch.from_numpy(lengths).to(dev)
            want = kernels.nthash_select_plain(c, l, hash_bound, n)
            cases[f"[{B}, {L}] l={l} on {dev}"] = _mismatches(
                torch, kernels.nthash_select(c, l, hash_bound, n), want)
    return cases


def _syncmer_batch(np, seed: int, B: int, L: int, l: int,
                   adversarial: bool = True):
    """_nthash_batch's codes plus a few N runs per row and, in rows 4 to 7
    unless `adversarial` is false, the adversarial rows of the incumbent
    walk: all one base (every s-mer hash equal: no forced column, and traces
    out of phase never meet, so the walk is sequential along the row), a
    period-2 and a period-3 repeat, and two-letter noise (ties everywhere
    at small s)."""
    Bb = max(B, 8)  # below 8 rows, the last B (random, ragged) are kept
    codes, lengths = _nthash_batch(np, seed, Bb, L, l)
    rng = np.random.default_rng(seed + 1)
    for r in range(Bb):
        for j in rng.integers(0, max(1, L - 8), 3):
            codes[r, j : j + int(rng.integers(1, 8))] = 4
    rows = [np.zeros(L, np.uint8), np.arange(L) % 2, np.arange(L) % 3,
            rng.integers(0, 2, L)]
    for r, row in zip(range(4, 8 if adversarial else 4), rows):
        codes[r] = row
        lengths[r] = L
    return codes[Bb - B :], lengths[Bb - B :]


def check_syncmer_select(torch, np) -> dict:
    """The fused kernel vs its plain version (the torch planes, then the
    column scan), hl and sel exactly: at the main path's [512, 24576]
    (l = 14, s = 4, d = 0.05), timed, and at s = 0, l = 32, w = 1, odd L,
    B = 1, L below w, an unaligned row slice and full-width adversarial
    rows (timed too, for information)."""
    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.ops.syncmers_device import syncmer_planes

    dev = torch.device(DEVICE)
    cases = {}
    small = [((25, 6147), 14, 4, 0), ((25, 6147), 14, 0, 0),
             ((25, 6147), 32, 8, 0), ((25, 6147), 12, 12, 0),
             ((25, 6147), 12, 2, 3), ((9, 37), 12, 11, 0),
             ((9, 5), 10, 4, 0), ((1, 24576), 14, 4, 0),
             ((1, 30011), 16, 16, 0), ((12, 4099), 31, 15, 1),
             ((8, 24576), 14, 4, 0)]
    for (B, L), l, s, skip in small:
        codes, lengths = _syncmer_batch(np, 300 + l + s, B, L, l)
        c = torch.from_numpy(codes).to(dev)[skip:]
        n = torch.from_numpy(lengths).to(dev)[skip:]
        bound = int(0.2 * 4 ** l)
        key = f"[{B - skip}, {L}] l={l} s={s}" + (f" rows {skip}:" if skip
                                                   else "")
        cases[key] = _mismatches(
            torch, kernels.syncmer_select(c, n, l=l, s=s, bound=bound),
            kernels.syncmer_select_plain(c, n, l=l, s=s, bound=bound))

    # the timed batch has no adversarial row: one such row makes its block
    # walk its 24,576 columns in order and sets the time of the launch,
    # where HPC'd reads (no homopolymer) and short repeats never do
    B, L, l, s = 512, 24576, 14, 4
    bound = int(0.05 * 4 ** l)
    codes, lengths = _syncmer_batch(np, 9, B, L, l, adversarial=False)
    c = torch.from_numpy(codes).to(dev)
    n = torch.from_numpy(lengths).to(dev)
    kw = dict(l=l, s=s, bound=bound)
    t0 = time.perf_counter()
    hl_p, sel_p = kernels.syncmer_select_plain(c, n, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3  # one call: L column steps
    hl_k, sel_k = kernels.syncmer_select(c, n, **kw)
    torch.cuda.synchronize()
    bad = (hl_k != hl_p) | (sel_k != sel_p)
    main_mismatches = int(bad.sum())
    max_abs_err = 0.0
    if main_mismatches:
        hk = hl_k[bad].cpu().numpy().view(np.uint64).astype(object)
        hp = hl_p[bad].cpu().numpy().view(np.uint64).astype(object)
        max_abs_err = float(max(abs(int(a) - int(b)) for a, b in zip(hk, hp)))
    n_sel = int(sel_k.sum())
    del hl_k, sel_k, hl_p, sel_p
    ms = cuda_time_ms(lambda: kernels.syncmer_select(c, n, **kw), 50)
    # the torch front half that the retired incumbent kernel followed
    planes_ms = cuda_time_ms(lambda: syncmer_planes(c, n, **kw), 5)
    # the walk's worst case, for information: the four adversarial rows
    # (one of them a single base) among eight
    ac, an = (torch.from_numpy(x).to(dev)
              for x in _syncmer_batch(np, 10, 8, L, l))
    adversarial_ms = cuda_time_ms(
        lambda: kernels.syncmer_select(ac, an, **kw), 10)
    # least time: codes 1 B + lengths 4 B/row read once, hl 8 B + sel 1 B
    # written once.  Operations, for information: ~150 32-bit lane
    # operations a position (two invertible hashes, an 11-way argmin, the
    # rolls, the walk), an estimate
    nbytes = B * L * (1 + 8 + 1) + B * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(
        name="syncmer_select", route="cuda",
        source="rust_mdbg_tpu_torch/csrc/syncmer_select.cu",
        replaces="rust_mdbg_tpu/ops/syncmers_device.py:182 "
                 "(syncmer_select_jax, XLA; no pallas_call)",
        launches=0, max_abs_err=max_abs_err,
        mismatches=main_mismatches + sum(cases.values()),
        ms=ms, plain_ms=plain_ms, planes_ms=planes_ms,
        adversarial_8_rows_ms=adversarial_ms, bound_ms=bound_ms,
        bound_by="bytes", bound_share=bound_ms / ms,
        ops_bound_ms=B * L * 150 / INT32_OPS_PER_S * 1e3, library_ms=None,
        gbytes_per_s=nbytes / ms / 1e6, shape=[B, L], l=l, s=s,
        selected=n_sel, cases=cases)


# --- the construct body's kernels (compaction, window keys) -----------------

#: the construct body's two kernels, counted on every leg that runs it
CONSTRUCT_KERNELS = ("compact_minimizers", "window_keys")


def zero_construct_launches():
    from rust_mdbg_tpu_torch.ops import kernels

    for name in CONSTRUCT_KERNELS:
        getattr(kernels, name).launches = 0


def construct_launches() -> dict:
    from rust_mdbg_tpu_torch.ops import kernels

    return {name: getattr(kernels, name).launches
            for name in CONSTRUCT_KERNELS}


class CompactShapes:
    """Records (rows, width, M, device type) of every compaction the
    extraction launches inside the block: ops.extract.compact_minimizers
    wrapped, the kernels' own counts untouched."""

    def __enter__(self):
        from rust_mdbg_tpu_torch.ops import extract

        self._orig = orig = extract.compact_minimizers
        self.seen = []

        def record(sel, *args, M, **kw):
            self.seen.append((int(sel.shape[0]), int(sel.shape[1]), M,
                              sel.device.type))
            return orig(sel, *args, M=M, **kw)

        extract.compact_minimizers = record
        return self

    def __exit__(self, *exc):
        from rust_mdbg_tpu_torch.ops import extract

        extract.compact_minimizers = self._orig


def require_construct(what: str, counts: dict, names) -> None:
    """Fail the leg when a construct kernel it runs never launched (on the
    card; a rehearsal on the CPU runs the plain versions)."""
    missing = [n for n in names if counts[n] <= 0]
    if DEVICE == "cuda" and missing:
        raise SystemExit(f"{what}: {', '.join(missing)} never launched "
                         f"({counts})")


def queued_kernel_ms(torch, fn, iters: int) -> float:
    """Device time of one call of fn (a bare launch): the `iters` launches
    are queued behind a spin kernel (torch.cuda._sleep) and timed by CUDA
    events once the card reaches them, so they run back to back and the
    host's enqueue of each (longer than a kernel of a few microseconds)
    is not in the time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms: longer than the enqueue
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def queued_cold_ms(torch, fn, iters: int) -> float:
    """queued_kernel_ms of fn with the 50 MB L2 flushed before each launch
    (a 64 MB buffer zeroed), less the flush's own queued time: the launch's
    device time when its inputs come from device memory."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def both():
        flush.zero_()
        fn()

    t = (queued_kernel_ms(torch, both, iters)
         - queued_kernel_ms(torch, flush.zero_, iters))
    del flush
    return t


def host_us(fn, iters: int = 300) -> float:
    """Host time of one call of fn, in microseconds, by the host clock over
    `iters` calls after three warm-up calls (no synchronisation: the host's
    own cost of checks, allocation and the enqueue)."""
    for _ in range(3):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def _max_abs_err(np, got, want) -> float:
    """The largest |kernel - plain| over the entries that differ, as
    unsigned 64-bit values for int64 tensors."""
    bad = got != want
    if not bool(bad.any()):
        return 0.0
    g, w = got[bad].cpu().numpy(), want[bad].cpu().numpy()
    if g.dtype == np.int64:
        g, w = g.view(np.uint64), w.view(np.uint64)
    return float(max(abs(int(a) - int(b)) for a, b in zip(g, w)))


def _compare(np, got, want) -> tuple[int, float]:
    """(mismatching entries, max_abs_err) over tuples of tensors (None
    where both lack one)."""
    n, err = 0, 0.0
    for g, w in zip(got, want):
        if g is None or w is None:
            n += (g is None) != (w is None)
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            n += max(g.numel(), w.numel())
            continue
        n += int((g != w).sum())
        err = max(err, _max_abs_err(np, g, w))
    return n, err


def _compact_inputs(torch, np, seed: int, B: int, L: int, rate: float, C: int,
                    maps: bool):
    """A selection plane at `rate` with adversarial rows (none selected;
    every column, so every chunk over C and n_raw = L; the first chunk
    full, its row over C there with n_raw above M; C + 1 in one chunk and
    nothing else, so slot C reads column L - 1 with n_min = C + 1; only the
    last column; every 7th column), and from 12 rows on the edges of the
    row's split over warps (C + 1 in the chunk that opens the second half,
    and in the one that opens the second quarter, each a warp's first at
    48 chunks; 16 columns on both sides of the halves' boundary, a warp
    boundary there; C + 1 in the last chunk only, so the tail fill writes
    slot C from column L - 1 after the last warp's gathers), canon over
    the whole u64 range (at and above 2^63), and random pos_map / pme when
    `maps`: CUDA tensors."""
    rng = np.random.default_rng(seed)
    sel = rng.random((B, L)) < rate
    if B >= 8:
        sel[0] = False
        sel[1] = True
        sel[2, : min(L, 512)] = True
        sel[3] = False
        c0 = min(3, (L - 1) // 512) * 512
        sel[3, c0 : c0 + min(C + 1, L - c0)] = True
        sel[4] = False
        sel[4, -1] = True
        sel[5, ::7] = True
    if B >= 12:
        nch = -(-L // 512)
        for r, c in ((8, nch // 2), (11, nch // 4)):
            c0 = c * 512
            sel[r, c0 : c0 + min(C + 1, L - c0)] = True
        half = (nch // 2) * 512
        sel[9, max(0, half - 8) : half + 8] = True
        sel[10] = False
        c0 = (nch - 1) * 512
        sel[10, c0 : c0 + min(C + 1, L - c0)] = True
    canon = rng.integers(0, 1 << 64, (B, L), dtype=np.uint64).view(np.int64)
    out = [torch.from_numpy(sel).cuda(), torch.from_numpy(canon).cuda()]
    if maps:
        pos = rng.integers(0, 1 << 30, (B, L)).astype(np.int32)
        out += [torch.from_numpy(pos).cuda(),
                torch.from_numpy(pos + rng.integers(0, 90, (B, L)).astype(
                    np.int32)).cuda()]
    else:
        out += [None, None]
    return out


def _compact_timing(torch, kernels, args, kw, cold: bool) -> dict:
    """Queued device time of the compaction (L2 warm: the same inputs
    launch after launch; cold: L2 flushed before each), beside the launch
    floor (an empty kernel of the same grid and block shape)."""
    B, L = args[0].shape
    launch, _ = kernels.compact_minimizers_launcher(*args, **kw)
    out = dict(shape=[B, L], ms=queued_kernel_ms(torch, launch, 50),
               l2="warm")
    if cold:
        out["cold_ms"] = queued_cold_ms(torch, launch, 50)
    out["floor_ms"] = queued_kernel_ms(
        torch, kernels.compact_floor_launcher(B, "cuda"), 50)
    return out


def check_compact_minimizers(torch, np, hash_bound: int) -> dict:
    """The compaction kernel vs its plain version, every output exactly, at
    the shapes its legs give it: the main path's [512, 24576] (M = 256,
    raw: positions and extent ends; the selection of nthash_select on
    _nthash_batch's codes, timed, and a batch of adversarial rows), the
    bench's [128, 24576] and the sharded legs' [256, 24576], M = 4,192
    under --syncmers, the tiler's [8, 1049088], odd L and an unaligned row
    slice, nch * C < M, and M == L at a two-level width (a chunk
    re-planned by core/chunked.doubled_plan) and at odd L; B = 1, 2, 100
    and 133 (fewer and more rows than the card has multiprocessors); 12
    rows whose runs cross the warps' chunk boundaries.  Timed (queued
    device time) at the main path's and the bench's shapes, L2 warm and
    cold, beside the launch floor."""
    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.ops.extract import capacity
    from rust_mdbg_tpu_torch.params import Params

    p = Params(k=21, l=14, density=0.003)
    C = kernels.chunk_slot_capacity(hash_bound)
    kw = dict(hash_bound=hash_bound)
    cases = {}
    shapes = [("bench", 128, 24576, 256, False, 0),
              ("sharded", 256, 24576, 256, True, 0),
              ("syncmers", 512, 24576, 4192, True, 0),
              ("tiler", 8, 1_049_088,
               capacity(p, 1_049_088, ignore_override=True), False, 0),
              ("odd_L", 25, 6147, capacity(p, 6147), True, 0),
              ("odd_L_rows_3:", 25, 6147, capacity(p, 6147), True, 3),
              ("nch_C_below_M", 16, 3072, 2048, True, 0),
              ("M_eq_L_two_level_width", 16, 4096, 4096, True, 0),
              ("M_eq_L_odd", 9, 1027, 1027, False, 0),
              ("B1", 1, 24576, 256, True, 0),
              ("B2", 2, 24576, 256, False, 0),
              ("B100", 100, 24576, 256, True, 0),
              ("B133", 133, 24576, 256, False, 0),
              ("warp_edges", 12, 24576, 256, True, 0)]
    for seed, (name, B, L, M, maps, skip) in enumerate(shapes):
        args = [None if a is None else a[skip:] for a in _compact_inputs(
            torch, np, 40 + seed, B, L, 0.006, C, maps)]
        want = kernels.compact_minimizers_plain(*args, M=M, **kw)
        got = kernels.compact_minimizers(*args, M=M, **kw)
        cases[f"{name} [{B - skip}, {L}] M={M}"] = _compare(np, got, want)[0]
        del args, want, got

    B, L, M = 512, 24576, capacity(p, 24576)
    adv = _compact_inputs(torch, np, 5, B, L, 0.006, C, True)
    want = kernels.compact_minimizers_plain(*adv, M=M, **kw)
    cases[f"adversarial [{B}, {L}] M={M}"] = _compare(
        np, kernels.compact_minimizers(*adv, M=M, **kw), want)[0]
    del adv, want
    codes, lengths = _nthash_batch(np, 7, B, L, 14)
    canon, sel = kernels.nthash_select(torch.from_numpy(codes).cuda(), 14,
                                       hash_bound,
                                       torch.from_numpy(lengths).cuda())
    _, _, pos, pme = _compact_inputs(torch, np, 6, B, L, 0.0, C, True)
    args = (sel, canon, pos, pme)
    want = kernels.compact_minimizers_plain(*args, M=M, **kw)
    got = kernels.compact_minimizers(*args, M=M, **kw)
    torch.cuda.synchronize()
    main_mismatches, max_abs_err = _compare(np, got, want)
    n_gathered = int(got[3].sum())
    overflow_rows = int(got[4].sum())
    launch, _ = kernels.compact_minimizers_launcher(*args, M=M, **kw)
    main_t = _compact_timing(torch, kernels, args, dict(M=M, **kw), True)
    ms = main_t["ms"]
    launch_ms = cuda_time_ms(launch, 50)
    wrapper_ms = cuda_time_ms(
        lambda: kernels.compact_minimizers(*args, M=M, **kw), 50)
    plain_ms = cuda_time_ms(
        lambda: kernels.compact_minimizers_plain(*args, M=M, **kw), 5)
    dev = sel.device
    fn = kernels._lib("compact_minimizers").compact_minimizers_launch
    cargs, _ = kernels._compact_args(sel, canon, pos, pme, hash_bound, M)

    def alloc():      # the wrapper's outputs: four allocations
        return (sel.new_empty((B, M), dtype=torch.int64),
                *sel.new_empty((2, B, M), dtype=torch.int32).unbind(0),
                sel.new_empty(B, dtype=torch.int32),
                sel.new_empty(B, dtype=torch.bool))

    def alloc_five():  # PR 13's five torch.empty
        return (torch.empty((B, M), dtype=torch.int64, device=dev),
                torch.empty((B, M), dtype=torch.int32, device=dev),
                torch.empty((B, M), dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev))

    def checks():
        for t, dt in ((sel, torch.bool), (canon, torch.int64),
                      (pos, torch.int32), (pme, torch.int32)):
            kernels._check_cuda(t, dt, "t")

    # the wrapper's host time by piece: the dtype / device / contiguity
    # checks, the output allocations (and PR 13's five), the slot capacity,
    # the stream
    # lookup, the ctypes call alone (15 arguments), the whole launch()
    host = dict(
        checks_alloc_us=host_us(lambda: kernels._compact_args(
            sel, canon, pos, pme, hash_bound, M)),
        check_us=host_us(checks), alloc_us=host_us(alloc),
        alloc_five_us=host_us(alloc_five),
        capacity_us=host_us(lambda: kernels.chunk_slot_capacity(hash_bound)),
        stream_us=host_us(lambda: kernels._stream(dev)),
        ctypes_us=host_us(lambda: fn(*cargs)),
        launch_us=host_us(launch),
        wrapper_us=host_us(
            lambda: kernels.compact_minimizers(*args, M=M, **kw)))
    torch.cuda.synchronize()
    # least time: the selection read once (1 B a position), canon, pos_map
    # and pme read only at the n_min columns gathered (16 B each), the
    # three [B, M] outputs (16 B a slot) and n_min, overflow (5 B a row)
    # written once; a few integer operations a position, far below
    nbytes = B * L + 16 * n_gathered + 16 * B * M + 5 * B
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_bound_ms = 8 * B * L / INT32_OPS_PER_S * 1e3
    del args, want, got, codes, canon, sel, pos, pme

    # the bench's shape: pre-HPC'd reads, no position or extent plane
    Bb = 128
    codes, lengths = _nthash_batch(np, 8, Bb, L, 14)
    bc, bs = kernels.nthash_select(torch.from_numpy(codes).cuda(), 14,
                                   hash_bound,
                                   torch.from_numpy(lengths).cuda())
    bargs = (bs, bc, None, None)
    bgot = kernels.compact_minimizers(*bargs, M=M, **kw)
    cases[f"bench_timed [{Bb}, {L}] M={M}"] = _compare(
        np, bgot, kernels.compact_minimizers_plain(*bargs, M=M, **kw))[0]
    bench_t = _compact_timing(torch, kernels, bargs, dict(M=M, **kw), True)
    bench_gathered = int(bgot[3].sum())
    bench_bytes = Bb * L + 8 * bench_gathered + 12 * Bb * M + 5 * Bb
    bench_t["bound_ms"] = bench_bytes / HBM_BYTES_PER_S * 1e3
    bench_t["bound_share"] = bench_t["bound_ms"] / bench_t["ms"]
    bench_t["wrapper_ms"] = cuda_time_ms(
        lambda: kernels.compact_minimizers(*bargs, M=M, **kw), 50)
    del codes, bc, bs, bargs, bgot
    return dict(
        name="compact_minimizers", route="cuda",
        source="rust_mdbg_tpu_torch/csrc/compact_minimizers.cu",
        replaces="rust_mdbg_tpu/ops/extract.py:137 (_device_extract's "
                 "two-level sort compaction :137-178 and its gathers, XLA; "
                 "no pallas_call)",
        launches=0, max_abs_err=max_abs_err,
        mismatches=main_mismatches + sum(cases.values()),
        ms=ms, launch_ms=launch_ms, wrapper_ms=wrapper_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        bound_share=bound_ms / ms, ops_bound_ms=ops_bound_ms,
        library_ms=None, gbytes_per_s=nbytes / ms / 1e6, shape=[B, L], M=M,
        chunk_cap=C, minimizers=n_gathered,
        overflow_rows=overflow_rows, main=main_t, bench=bench_t, host=host,
        cases=cases)


def _window_rows(torch, np, seed: int, B: int, M: int, k: int, mean: float):
    """Minimizer rows as the compaction leaves them: n_min drawn around
    `mean` (capped at M) with rows of 0, k, k + 1 and M minimizers, zeros
    past n_min; u64 values over the whole range with a palindromic window,
    a row of one value, a period-2 row and top-bit values: CUDA tensors."""
    rng = np.random.default_rng(seed)
    mh = rng.integers(0, 1 << 64, (B, M), dtype=np.uint64)
    n_min = np.minimum(rng.poisson(mean, B), M).astype(np.int32)
    if B >= 8:
        n_min[:4] = [0, k, k + 1, M]
        mh[3, :k] = np.concatenate([mh[3, : (k + 1) // 2],
                                    mh[3, : k // 2][::-1]])
        mh[4] = mh[4, 0]
        n_min[4] = M
        mh[5, ::2] = mh[5, 0]
        mh[6] |= np.uint64(1 << 63)
    mh[np.arange(M)[None, :] >= n_min[:, None]] = 0
    return (torch.from_numpy(mh.view(np.int64)).cuda(),
            torch.from_numpy(n_min).cuda())


def _append_pair(torch, kernels, mh, n_min, k, S, row0, plain: bool):
    """window_keys_append (or its plain version) into fresh planes of S +
    64 slots at slot0 = 32, the counters starting at 3: (lo, hi, occ,
    n_win, n_over)."""
    dev = mh.device
    planes = [torch.full((S + 64,), -5, dtype=torch.int64, device=dev)
              for _ in range(3)]
    cnt = [torch.full((), 3, dtype=torch.int64, device=dev)
           for _ in range(2)]
    kw = dict(row0=row0, slot0=32, S=S, n_win=cnt[0], n_over=cnt[1])
    if plain:
        kernels.slot_append_plain(kernels.window_keys_plain(mh, n_min, k),
                                  kernels.windows_per_read(n_min, k),
                                  *planes, **kw)
    else:
        kernels.window_keys_append(mh, n_min, k, *planes, **kw)
    return planes + cnt


def _window_timing(torch, kernels, mh, n_min, k, S, cold: bool) -> dict:
    """Queued device time of the slot append and of the keys plane at
    [B, M] (L2 warm; cold: flushed before each launch) beside the launch
    floor (an empty kernel of the same grid and block shape)."""
    B, M = mh.shape
    planes = [torch.empty(S + 64, dtype=torch.int64, device="cuda")
              for _ in range(3)]
    cnt = [torch.zeros((), dtype=torch.int64, device="cuda")
           for _ in range(2)]
    append = dict(zip(("b_lo", "b_hi", "b_occ", "n_win", "n_over"),
                      planes + cnt), row0=0, slot0=32, S=S)
    launch, _ = kernels.window_keys_launcher(mh, n_min, k, append)
    keys_launch, _ = kernels.window_keys_launcher(mh, n_min, k)
    out = dict(shape=[B, M], slot=S, l2="warm",
               ms=queued_kernel_ms(torch, launch, 50),
               keys_plane_ms=queued_kernel_ms(torch, keys_launch, 50),
               floor_ms=queued_kernel_ms(
                   torch, kernels.window_keys_floor_launcher(B, "cuda"), 50))
    if cold:
        out["cold_ms"] = queued_cold_ms(torch, launch, 50)
        out["keys_plane_cold_ms"] = queued_cold_ms(torch, keys_launch, 50)
    out["wrapper_ms"] = cuda_time_ms(lambda: kernels.window_keys_append(
        mh, n_min, k, *planes, row0=0, slot0=32, S=S, n_win=cnt[0],
        n_over=cnt[1]), 50)
    return out


def check_window_keys(torch, np) -> dict:
    """The window-keys kernel vs its plain versions, both modes exactly:
    the keys plane (mode i) and the slot append (mode ii, planes and
    counters) at the main path's [512, 256] (k = 21, its window slots;
    timed), the bench's [128, 256] (timed), M = 4,192 under --syncmers,
    odd M, k from 1 to 21, a slot too small for the batch, a read base
    whose window coordinates pass 2^32 before the u32 mask; and at the
    edges of the split (a row a 128-thread block, two windows a lane):
    B = 1, B = 13, rows of M windows beside rows of none, rows of three
    window groups (more than 512 windows), B = 1,500 (more than one
    16-byte n_min load a thread).  Timed (queued device time) L2 warm and
    cold, beside the launch floor."""
    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.ops.sort_count import window_slot_capacity
    from rust_mdbg_tpu_torch.params import Params

    p = Params(k=21, l=14, density=0.003)
    ps = Params(k=21, l=14, density=0.05, use_syncmers=True, s=4)
    cases = {}
    shapes = [("bench", 128, 256, 21, window_slot_capacity(p, 128, 24576,
                                                            256), 0),
              ("syncmers", 512, 4192, 21,
               window_slot_capacity(ps, 512, 24576, 4192), 0),
              ("odd_M", 37, 97, 21, 40, 0), ("k1", 16, 33, 1, 33, 0),
              ("k2", 16, 33, 2, 32, 0), ("k7", 16, 70, 7, 64, 0),
              ("tight_slot", 64, 256, 21, 20, 0),
              ("row0_past_2^32", 64, 256, 21, 160, 18_000_000),
              ("B1", 1, 256, 21, 240, 0),
              ("B13_odd", 13, 256, 21, 160, 0),
              ("full_beside_empty", 16, 256, 21, 240, 0),
              ("three_groups", 24, 600, 21, 560, 0),
              ("B1500", 1500, 256, 21, 160, 0)]
    for name, B, M, k, ws, row0 in shapes:
        mh, n_min = _window_rows(torch, np, len(name), B, M, k,
                                 M if name in ("tight_slot", "three_groups")
                                 else 0.6 * M)
        if name == "full_beside_empty":
            n_min[0::2], n_min[1::2] = M, 0
            mh[1::2] = 0
        n = _compare(np, (kernels.window_keys(mh, n_min, k),),
                     (kernels.window_keys_plain(mh, n_min, k),))[0]
        n += _compare(np, _append_pair(torch, kernels, mh, n_min, k, B * ws,
                                       row0, False),
                      _append_pair(torch, kernels, mh, n_min, k, B * ws,
                                   row0, True))[0]
        cases[f"{name} [{B}, {M}] k={k} slot {B * ws}"] = n

    B, M, k = 512, 256, 21
    ws = window_slot_capacity(p, B, 24576, M)
    S = B * ws
    mh, n_min = _window_rows(torch, np, 21, B, M, k, 147.5)
    keys_mis, keys_err = _compare(np, (kernels.window_keys(mh, n_min, k),),
                                  (kernels.window_keys_plain(mh, n_min, k),))
    got = _append_pair(torch, kernels, mh, n_min, k, S, 0, False)
    want = _append_pair(torch, kernels, mh, n_min, k, S, 0, True)
    torch.cuda.synchronize()
    app_mis, app_err = _compare(np, got, want)
    n_valid = int(kernels.windows_per_read(n_min, k).sum())
    append = dict(zip(("b_lo", "b_hi", "b_occ", "n_win", "n_over"), got),
                  row0=0, slot0=32, S=S)
    launch, _ = kernels.window_keys_launcher(mh, n_min, k, append)
    main_t = _window_timing(torch, kernels, mh, n_min, k, S, True)
    ms = main_t["ms"]
    launch_ms = cuda_time_ms(launch, 50)
    wrapper_ms = main_t["wrapper_ms"]
    plain_ms = cuda_time_ms(lambda: _append_pair(
        torch, kernels, mh, n_min, k, S, 0, True), 5)
    wfn = kernels._lib("window_keys").window_keys_launch
    wargs, _ = kernels._window_keys_args(mh, n_min, k, append)
    host = dict(
        checks_alloc_us=host_us(lambda: kernels._window_keys_args(
            mh, n_min, k, append)),
        ctypes_us=host_us(lambda: wfn(*wargs)),
        launch_us=host_us(launch),
        wrapper_us=host_us(lambda: kernels.window_keys_append(
            mh, n_min, k, *got[:3], row0=0, slot0=32, S=S, n_win=got[3],
            n_over=got[4])))
    torch.cuda.synchronize()
    # least time of the append (the main path's mode): the minimizer rows
    # (8 B a slot) and n_min read once, the three slot planes (24 B a
    # slot) written once; operations: ~10 k 32-bit operations a valid
    # window (two 64-bit multiply-adds a Horner step, emulated in IMADs,
    # and the reversal test)
    nbytes = 8 * B * M + 4 * B + 24 * S + 16
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * k * n_valid / INT32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)

    # the bench's shape: [128, 256], its window slots
    Bb = 128
    Sb = Bb * window_slot_capacity(p, Bb, 24576, M)
    bmh, bn = _window_rows(torch, np, 22, Bb, M, k, 147.5)
    cases[f"bench_timed [{Bb}, {M}] k={k} slot {Sb}"] = _compare(
        np, _append_pair(torch, kernels, bmh, bn, k, Sb, 0, False),
        _append_pair(torch, kernels, bmh, bn, k, Sb, 0, True))[0]
    bench_t = _window_timing(torch, kernels, bmh, bn, k, Sb, True)
    bv = int(kernels.windows_per_read(bn, k).sum())
    bench_t["bound_ms"] = max(
        (8 * Bb * M + 4 * Bb + 24 * Sb + 16) / HBM_BYTES_PER_S * 1e3,
        10 * k * bv / INT32_OPS_PER_S * 1e3)
    bench_t["bound_share"] = bench_t["bound_ms"] / bench_t["ms"]
    return dict(
        name="window_keys", route="cuda",
        source="rust_mdbg_tpu_torch/csrc/window_keys.cu",
        replaces="rust_mdbg_tpu/ops/extract.py:489 (_window_keys_poly) and "
                 "rust_mdbg_tpu/ops/sort_count.py:637 (make_fused_construct's "
                 "batch-slot compaction :637-669), XLA; no pallas_call",
        launches=0, max_abs_err=max(keys_err, app_err),
        mismatches=keys_mis + app_mis + sum(cases.values()),
        ms=ms, launch_ms=launch_ms, wrapper_ms=wrapper_ms,
        keys_plane_ms=main_t["keys_plane_ms"], plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_share=bound_ms / ms, bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
        library_ms=None, shape=[B, M], k=k, slot=S, valid_windows=n_valid,
        main=main_t, bench=bench_t, host=host, cases=cases)


def construct_times(torch, np) -> dict:
    """Queued device time, bare launch and wrapper time of the construct
    kernels of the tree this process imported (the same inputs in every
    tree: chip_smoke.py's generators at fixed seeds), through the
    launcher and wrapper API every version has: the compaction at the main
    path's [512, 24576] (raw: position and extent planes) and the bench's
    [128, 24576] (pre-HPC'd: none), the slot append at [512, 256] and
    [128, 256] and the keys plane at [512, 256]; every output checked
    against the plain version.  Run by --construct-ab in one process a
    tree."""
    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.ops.sort_count import window_slot_capacity
    from rust_mdbg_tpu_torch.params import Params

    kernels.build_all(["nthash_select", "compact_minimizers", "window_keys"])
    p = Params(k=21, l=14, density=0.003)
    hb, L, M, k = p.hash_bound, 24576, 256, 21
    C = kernels.chunk_slot_capacity(hb)
    out, bad = {"tree": os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(kernels.__file__))))}, 0
    for name, B, seed, maps in (("compact [512, 24576]", 512, 7, True),
                                ("compact [128, 24576]", 128, 8, False)):
        codes, lengths = _nthash_batch(np, seed, B, L, 14)
        canon, sel = kernels.nthash_select(torch.from_numpy(codes).cuda(),
                                           14, hb,
                                           torch.from_numpy(lengths).cuda())
        _, _, pos, pme = _compact_inputs(torch, np, 6, B, L, 0.0, C, True)
        args = (sel, canon, pos, pme) if maps else (sel, canon, None, None)
        launch, got = kernels.compact_minimizers_launcher(*args, M=M,
                                                          hash_bound=hb)
        launch()
        bad += _compare(np, got, kernels.compact_minimizers_plain(
            *args, M=M, hash_bound=hb))[0]
        out[name] = dict(
            ms=queued_kernel_ms(torch, launch, 50),
            launch_ms=cuda_time_ms(launch, 50),
            wrapper_ms=cuda_time_ms(lambda: kernels.compact_minimizers(
                *args, M=M, hash_bound=hb), 50))
    for B, seed in ((512, 21), (128, 22)):
        S = B * window_slot_capacity(p, B, L, M)
        mh, n_min = _window_rows(torch, np, seed, B, M, k, 147.5)
        got = _append_pair(torch, kernels, mh, n_min, k, S, 0, False)
        bad += _compare(np, got, _append_pair(torch, kernels, mh, n_min, k,
                                              S, 0, True))[0]
        append = dict(zip(("b_lo", "b_hi", "b_occ", "n_win", "n_over"),
                          got), row0=0, slot0=32, S=S)
        launch, _ = kernels.window_keys_launcher(mh, n_min, k, append)
        out[f"append [{B}, {M}]"] = dict(
            ms=queued_kernel_ms(torch, launch, 50),
            launch_ms=cuda_time_ms(launch, 50),
            wrapper_ms=cuda_time_ms(lambda: kernels.window_keys_append(
                mh, n_min, k, *got[:3], row0=0, slot0=32, S=S, n_win=got[3],
                n_over=got[4]), 50))
        if B == 512:
            keys_launch, _ = kernels.window_keys_launcher(mh, n_min, k)
            bad += _compare(np, (kernels.window_keys(mh, n_min, k),),
                            (kernels.window_keys_plain(mh, n_min, k),))[0]
            out[f"keys [{B}, {M}]"] = dict(
                ms=queued_kernel_ms(torch, keys_launch, 50),
                launch_ms=cuda_time_ms(keys_launch, 50))
    out["mismatches"] = bad
    return out


def construct_ab(trees) -> list:
    """construct_times of each tree in turn, each in a process of its own
    with that tree first on sys.path (give the order, e.g. parent, change,
    change, parent): the list of their results."""
    res = []
    for tree in trees:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--construct-times-of", os.path.abspath(tree)],
            capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise SystemExit(f"construct times of {tree} failed:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        res.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(f"construct times: {json.dumps(res[-1])}", flush=True)
    return res


def read_records(prefix: str):
    from rust_mdbg_tpu_torch.io.sequences import iter_sequences

    return sorted(json.dumps(r, sort_keys=True, default=str)
                  for r in iter_sequences(prefix))


def slice_parity(tmp: str, Params) -> dict:
    """Small corpus through the port on the card and on the CPU."""
    from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
    from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
    from rust_mdbg_tpu_torch.ops import kernels

    reads = os.path.join(tmp, "parity.fa")
    write_synthetic_reads(reads, genome_mbp=0.5, coverage=30,
                          read_len=10_000, error_rate=0.003, seed=3)
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2)
    before = kernels.nthash_select.launches
    sg = assemble_device_chunked(reads, p, os.path.join(tmp, "pg"),
                                 device="cuda")
    launched = kernels.nthash_select.launches - before
    sc = assemble_device_chunked(reads, p, os.path.join(tmp, "pc"),
                                 device="cpu")
    gfa_g = open(os.path.join(tmp, "pg.gfa"), "rb").read()
    gfa_c = open(os.path.join(tmp, "pc.gfa"), "rb").read()
    if gfa_g != gfa_c:
        raise SystemExit("slice parity: .gfa differs between cuda and cpu")
    if read_records(os.path.join(tmp, "pg")) != \
            read_records(os.path.join(tmp, "pc")):
        raise SystemExit("slice parity: .sequences differ between cuda/cpu")
    if launched <= 0:
        raise SystemExit("slice parity: the cuda run launched no kernel")
    if sg["nb_nodes"] <= 0 or sg["nb_edges"] <= 0:
        raise SystemExit(f"slice parity: empty graph {sg}")
    return dict(nodes=sg["nb_nodes"], edges=sg["nb_edges"],
                reads=sg["nb_reads"], gfa_bytes=len(gfa_g),
                kernel_launches=launched, cpu_nodes=sc["nb_nodes"])


def prehpc_parity(tmp: str, Params) -> dict:
    """The parity corpus taken as pre-HPC'd input: recompute mode on the
    card, on the CPU, and on the card with the host edge join."""
    from rust_mdbg_tpu_torch.core import chunked
    from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
    from rust_mdbg_tpu_torch.ops import kernels

    reads = os.path.join(tmp, "parity.fa")
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2,
               reads_already_hpc=True)
    before = kernels.nthash_select.launches
    sg = assemble_device_chunked(reads, p, os.path.join(tmp, "hg"),
                                 device="cuda")
    launched = kernels.nthash_select.launches - before
    sc = assemble_device_chunked(reads, p, os.path.join(tmp, "hc"),
                                 device="cpu")
    # a catalog of no rows spills at the first crossing: the host join
    rows, chunked.CATALOG_ROWS = chunked.CATALOG_ROWS, 0
    try:
        sh = assemble_device_chunked(reads, p, os.path.join(tmp, "hh"),
                                     device="cuda")
    finally:
        chunked.CATALOG_ROWS = rows
    gfa = {x: open(os.path.join(tmp, f"{x}.gfa"), "rb").read()
           for x in ("hg", "hc", "hh")}
    if gfa["hg"] != gfa["hc"]:
        raise SystemExit("pre-HPC parity: .gfa differs between cuda and cpu")
    if gfa["hg"] != gfa["hh"]:
        raise SystemExit("pre-HPC parity: .gfa differs between the device "
                         "join and the host join")
    rec = read_records(os.path.join(tmp, "hg"))
    if rec != read_records(os.path.join(tmp, "hc")) \
            or rec != read_records(os.path.join(tmp, "hh")):
        raise SystemExit("pre-HPC parity: .sequences records differ")
    if sg.get("edge_join") != "device" or sc.get("edge_join") != "device" \
            or sh.get("edge_join") != "host":
        raise SystemExit(
            "pre-HPC parity: wrong join made the edges: cuda "
            f"{sg.get('edge_join')}, cpu {sc.get('edge_join')}, switched "
            f"off {sh.get('edge_join')}")
    if launched <= 0:
        raise SystemExit("pre-HPC parity: the cuda run launched no kernel")
    if sg["nb_nodes"] <= 0 or sg["nb_edges"] <= 0 \
            or sg["catalog_rows"] != sg["nb_nodes"]:
        raise SystemExit(f"pre-HPC parity: bad graph {sg}")
    return dict(nodes=sg["nb_nodes"], edges=sg["nb_edges"],
                reads=sg["nb_reads"], gfa_bytes=len(gfa["hg"]),
                catalog_rows=sg["catalog_rows"], n_pot=sg["n_pot"],
                join_device_ms=sg["join_device_ms"],
                kernel_launches=launched)


def write_main_corpus(tmp: str, genome_mbp: float) -> dict:
    """main.fa, read by every main-path leg and the breakdowns, and its
    genome as one record (genome.fa, the --reference leg's input)."""
    from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads

    t0 = time.perf_counter()
    syn = write_synthetic_reads(os.path.join(tmp, "main.fa"),
                                genome_mbp=genome_mbp, coverage=52,
                                read_len=24_576, error_rate=0.003, seed=0,
                                repeat_frac=0.2,
                                genome_out=os.path.join(tmp, "genome.fa"))
    syn["fasta_write_s"] = time.perf_counter() - t0
    return syn


def main_path(tmp: str, Params, syn: dict, genome_mbp: float,
              already_hpc: bool) -> dict:
    """One leg over main.fa: as raw reads, or as pre-HPC'd reads."""
    import torch

    from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
    from rust_mdbg_tpu_torch.ops import kernels

    reads = os.path.join(tmp, "main.fa")
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2,
               reads_already_hpc=already_hpc)
    prefix = os.path.join(tmp, "main_hpc" if already_hpc else "main")
    torch.cuda.reset_peak_memory_stats()
    kernels.nthash_select.launches = 0
    zero_construct_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = assemble_device_chunked(reads, p, prefix, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.nthash_select.launches
    cl = construct_launches()
    if launches <= 0:
        raise SystemExit(f"main path (already_hpc={already_hpc}): "
                         "nthash_select never launched")
    require_construct(f"main path (already_hpc={already_hpc})", cl,
                      CONSTRUCT_KERNELS)
    n_s = n_l = 0
    with open(prefix + ".gfa") as f:
        for line in f:
            n_s += line.startswith("S\t")
            n_l += line.startswith("L\t")
    n_rec = len(read_records(prefix))
    if not (n_s == st["nb_nodes"] == n_rec and n_l == st["nb_edges"]
            and n_s > 0 and n_l > 0):
        raise SystemExit(f"main path (already_hpc={already_hpc}): "
                         f"inconsistent outputs S={n_s} "
                         f"L={n_l} records={n_rec} stats={st}")
    out = dict(
        genome_mbp=genome_mbp, read_gbp=syn["total_bases"] / 1e9,
        reads=st["nb_reads"], nodes=st["nb_nodes"], edges=st["nb_edges"],
        windows=st["nb_windows"], chunks=st["nb_chunks"],
        wall_s=wall, read_gbp_per_s=syn["total_bases"] / 1e9 / wall,
        fasta_write_s=syn["fasta_write_s"], phases=st["phases"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        nthash_select_launches=launches, construct_launches=cl)
    if already_hpc:
        if st.get("edge_join") != "device" \
                or st["catalog_rows"] != st["nb_nodes"]:
            raise SystemExit("pre-HPC main path: the device join did not "
                             f"make the edges: {st.get('edge_join')}, "
                             f"catalog rows {st.get('catalog_rows')}")
        out.update(catalog_rows=st["catalog_rows"], n_pot=st["n_pot"],
                   join_device_ms=st["join_device_ms"],
                   join_dispatch_s=st["join_dispatch_s"],
                   join_wall_s=st["join_wall_s"])
    # device-to-host bytes of the crossing gathers and the join, counted
    # from this run's shapes: vector mode fetches the k-vector (8k) and six
    # meta columns per node; recompute mode five meta columns and k
    # positions per node, and 9 B per POT candidate at the end
    k = p.k
    out["gather_d2h_bytes_per_node"] = (
        20 + 4 * k + 9 * st["n_pot"] / st["nb_nodes"] if already_hpc
        else 8 * k + 24)
    return out


def first_staged_chunk(reads: str, p, plan: dict, dev):
    """The first chunk of `reads` as core/fastx_feed.StagedFeed stages it
    under `plan` on `dev`, ready for the current stream."""
    from rust_mdbg_tpu_torch.core.fastx_feed import StagedFeed
    from rust_mdbg_tpu_torch.utils.timing import PhaseTimer

    with StagedFeed(reads, p, plan, dev, PhaseTimer()) as feed:
        return next(feed)


def construct_breakdown(tmp: str, Params) -> dict:
    """Device time by kernel over one chunk of the main-path corpus:
    construct_batches + finalize_chunk under torch.profiler, after a
    warm-up run of the same chunk.  Planned, staged and run through the
    driver's own steps (plan_chunks, the feed's first staged chunk,
    new_counter, construct_chunk), outside assemble_device_chunked.

    The busy share is over the profiled window, which tracing the host's
    ~7,000 op launches stretches, so it reads low; the median unprofiled
    wall time of the same chunk is given beside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rust_mdbg_tpu_torch.bench import short_kernel_name
    from rust_mdbg_tpu_torch.core.chunked import (construct_chunk,
                                                  new_counter, plan_chunks)

    reads = os.path.join(tmp, "main.fa")
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2)
    plan = plan_chunks(reads, p)
    dev = torch.device("cuda")
    c = first_staged_chunk(reads, p, plan, dev)
    staged, lens_d, fill = c.planes, c.lens, c.fill
    counter = new_counter(p, plan, dev)

    def chunk():
        construct_chunk(p, plan, counter, staged, lens_d, fill)
        counter.reset_chunk()

    chunk()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    unprofiled_us = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += b - a
        t[1] += 1
    busy = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    # the same device time by the torch op that launched it
    ops = sorted(((a.key, a.self_device_time_total, a.count)
                  for a in prof.key_averages()
                  if a.device_type == DeviceType.CPU
                  and a.self_device_time_total > 0), key=lambda r: -r[1])
    B = plan["B"]
    batches = min(plan["n_batches"], (fill + B - 1) // B)
    # kernel launches (copies and fills aside) over the chunk's batches
    launches = sum(n for k, (_, n) in by_name.items()
                   if not k.startswith(("Memcpy", "Memset")))
    return dict(
        reads=int(fill), batches=batches, kernel_launches=launches,
        launches_a_batch=launches / batches,
        width=int(plan["L"]), fed_width=int(c.width),
        window_us=wall_us, unprofiled_us=unprofiled_us,
        device_events=len(spans),
        device_us=sum(t for t, _ in by_name.values()), busy_us=busy,
        busy_share=busy / wall_us if spans else None,
        nthash_select_us=sum(t for k, (t, _) in by_name.items()
                             if "nthash_select" in k),
        top=[dict(name=short_kernel_name(k), us=t, calls=c)
             for k, (t, c) in top],
        top_ops=[dict(op=k, us=t, calls=c) for k, t, c in ops[:12]])


def gfa_signature(prefix: str):
    """(LN, KC) multiset and edge count: the id-free graph comparison."""
    nodes, edges = [], 0
    with open(prefix + ".gfa") as f:
        for line in f:
            if line.startswith("S\t"):
                v = line.split("\t")
                nodes.append((v[3], v[4].strip()))
            elif line.startswith("L\t"):
                edges += 1
    return sorted(nodes), edges


def whole_run_parity(tmp: str, Params) -> dict:
    """The parity corpus through the whole-run path on the card and on the
    CPU, and against the chunked driver's graph on the same input:
    slice_parity's pg and prehpc_parity's hg, still on disk, and for --bf a
    chunked run made here, whose Bloom filter is the host table's — so the
    device screen is held against the host one at the same bit count."""
    from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
    from rust_mdbg_tpu_torch.core.pipeline import assemble_device_table
    from rust_mdbg_tpu_torch.ops import kernels

    reads = os.path.join(tmp, "parity.fa")
    kw = dict(k=21, l=14, density=0.003, min_kmer_abundance=2,
              batch_reads=16)
    legs = {"raw": (dict(), "pg"),
            "prehpc": (dict(reads_already_hpc=True), "hg"),
            "prehpc_bf": (dict(reads_already_hpc=True, use_bf=True,
                               bloom_log2_bits=28), "hg_bf")}
    out = {}
    for leg, (extra, chunked) in legs.items():
        p = Params(**kw, **extra)
        if p.use_bf:
            assemble_device_chunked(reads, p.replace(batch_reads=512),
                                    os.path.join(tmp, chunked), device=DEVICE)
        before = kernels.nthash_select.launches
        sg = assemble_device_table(reads, p, os.path.join(tmp, f"w{leg}_g"),
                                   device=DEVICE)
        launched = kernels.nthash_select.launches - before
        sc = assemble_device_table(reads, p, os.path.join(tmp, f"w{leg}_c"),
                                   device="cpu")
        g = open(os.path.join(tmp, f"w{leg}_g.gfa"), "rb").read()
        if g != open(os.path.join(tmp, f"w{leg}_c.gfa"), "rb").read():
            raise SystemExit(f"whole-run parity ({leg}): .gfa differs "
                             "between cuda and cpu")
        if read_records(os.path.join(tmp, f"w{leg}_g")) != \
                read_records(os.path.join(tmp, f"w{leg}_c")):
            raise SystemExit(f"whole-run parity ({leg}): .sequences differ "
                             "between cuda and cpu")
        if launched <= 0:
            raise SystemExit(f"whole-run parity ({leg}): no kernel launch")
        if sg["nb_nodes"] <= 0 or sg["nb_edges"] <= 0 or sg["replans"]:
            raise SystemExit(f"whole-run parity ({leg}): bad graph {sg}")
        fired = sg["phase1_nodes"] > 0
        if fired != ("prehpc" in leg) or fired != (sc["phase1_nodes"] > 0):
            raise SystemExit(f"whole-run parity ({leg}): phase 1 "
                             f"{sg['phase1_nodes']} / {sc['phase1_nodes']}")
        if "prehpc" in leg and sg.get("edge_join") != "device":
            raise SystemExit(f"whole-run parity ({leg}): edges came from "
                             f"the {sg.get('edge_join')} join")
        if gfa_signature(os.path.join(tmp, f"w{leg}_g")) \
                != gfa_signature(os.path.join(tmp, chunked)):
            raise SystemExit(f"whole-run parity ({leg}): node multiset or "
                             "edge count differs from the chunked leg's")
        out[leg] = dict(nodes=sg["nb_nodes"], edges=sg["nb_edges"],
                        chunks=sg["nb_chunks"], gfa_bytes=len(g),
                        phase1_nodes=sg["phase1_nodes"],
                        kernel_launches=launched,
                        same_graph_as_chunked=True)
    return out


def whole_run_main(tmp: str, Params, syn: dict, leg: str, chunked=None):
    """One whole-run leg over main.fa at [512, 24576] batches.  `chunked`
    is the chunked leg of the same input (its stats and prefix), whose
    graph the result must equal."""
    import torch

    from rust_mdbg_tpu_torch.core import pipeline
    from rust_mdbg_tpu_torch.ops import kernels

    reads = os.path.join(tmp, "main.fa")
    kw = dict(k=21, l=14, density=0.003, max_read_len=24_576)
    prefix = os.path.join(tmp, f"whole_{leg}")
    torch.cuda.reset_peak_memory_stats()
    kernels.nthash_select.launches = 0
    zero_construct_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if leg == "raw17":
        st = pipeline.assemble(reads, Params(min_kmer_abundance=17, **kw),
                               prefix, device=DEVICE)
    else:
        st = pipeline.assemble_device_table(
            reads, Params(min_kmer_abundance=2, reads_already_hpc=True,
                          use_bf=leg == "prehpc_bf", **kw),
            prefix, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.nthash_select.launches
    cl = construct_launches()
    if launches <= 0:
        raise SystemExit(f"whole-run main path ({leg}): nthash_select never "
                         "launched")
    require_construct(f"whole-run main path ({leg})", cl, CONSTRUCT_KERNELS)
    if "phase1_nodes" not in st:
        raise SystemExit(f"whole-run main path ({leg}): the run did not "
                         "take the whole-run path")
    (nodes, n_l) = gfa_signature(prefix)
    n_rec = len(read_records(prefix))
    if not (len(nodes) == st["nb_nodes"] == n_rec and n_l == st["nb_edges"]
            and (n_rec > 0 or leg == "raw17")) or st["replans"]:
        raise SystemExit(f"whole-run main path ({leg}): inconsistent "
                         f"outputs S={len(nodes)} L={n_l} records={n_rec} "
                         f"stats={st}")
    # phase 1 starts after the fourth chunk of 8,192 reads (a cut-down
    # corpus may never get there, and then emits in one shot)
    if leg != "raw17" and st["nb_chunks"] > 4 and not (
            st["phase1_nodes"] > 0 and st.get("edge_join") == "device"):
        raise SystemExit(f"whole-run main path ({leg}): phase 1 emitted "
                         f"{st['phase1_nodes']} nodes, edges from the "
                         f"{st.get('edge_join')} join")
    out = dict(
        read_gbp=syn["total_bases"] / 1e9, reads=st["nb_reads"],
        nodes=st["nb_nodes"], edges=st["nb_edges"], chunks=st["nb_chunks"],
        wall_s=wall, read_gbp_per_s=syn["total_bases"] / 1e9 / wall,
        phases=st["phases"], peak_mem_bytes=torch.cuda.max_memory_allocated(),
        nthash_select_launches=launches, construct_launches=cl,
        phase1_fired=st["phase1_nodes"] > 0,
        phase1_nodes=st["phase1_nodes"],
        phase1_finalize_s=st.get("phase1_finalize_s"),
        phase1_emit_s=st.get("phase1_emit_s"), replans=st["replans"],
        edge_join=st.get("edge_join"), read_cap=st["read_cap"],
        w_slot=st["w_slot"], mem_budget=st["mem_budget"])
    if chunked is not None:
        cst, cprefix = chunked
        if (nodes, n_l) != gfa_signature(cprefix):
            raise SystemExit(
                f"whole-run main path ({leg}): {len(nodes)} nodes / {n_l} "
                f"edges, the chunked leg has {cst['nodes']} / "
                f"{cst['edges']} or another (LN, KC) multiset")
        out["same_graph_as_chunked"] = True
        out["gfa_identical_to_chunked"] = (
            open(prefix + ".gfa", "rb").read()
            == open(cprefix + ".gfa", "rb").read())
    return out


def finalize_breakdown(tmp: str, Params) -> dict:
    """Device time by torch op over one finalize_compact of the whole
    pre-HPC'd main corpus: the buffers are filled through the whole-run
    driver's own steps (plan_table, new_table_counter, the feed's staged
    chunks through construct_batches), then the reduction runs once to
    warm up, three times unprofiled (median wall) and three times under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rust_mdbg_tpu_torch.core.fastx_feed import StagedFeed
    from rust_mdbg_tpu_torch.core.pipeline import (CHUNK_BATCHES,
                                                   new_table_counter,
                                                   plan_table)
    from rust_mdbg_tpu_torch.ops.sort_count import construct_batches
    from rust_mdbg_tpu_torch.utils.timing import PhaseTimer

    reads = os.path.join(tmp, "main.fa")
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2,
               reads_already_hpc=True, max_read_len=24_576)
    plan = plan_table(reads, p)
    dev = torch.device(DEVICE)
    counter = new_table_counter(p, plan, dev)
    read_base = 0
    B, CH = plan["B"], plan["chunk_reads"]
    with StagedFeed(reads, p, plan, dev, PhaseTimer()) as feed:
        for c in feed:
            if read_base + CH > counter.read_cap:
                counter.grow(read_base + CH)
            construct_batches(p, c.planes, c.lens, counter.buffers, B=B,
                              M=plan["M"], w_slot=plan["w_slot"], batch_lo=0,
                              batch_hi=min(CHUNK_BATCHES,
                                           (c.fill + B - 1) // B),
                              read_base=read_base)
            read_base += CH
            del c
            feed.release()
    pending = counter.finalize_dispatch()
    torch.cuda.synchronize()
    out = pending()
    rows = int(((counter.buffers[0] != -1) | (counter.buffers[1] != -1))
               .sum())
    res = dict(rows=counter.window_cap, filled_rows=rows,
               n_pass=out["n_pass"], n_unique=out["n_unique"])
    del out
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the tracer was seen to drop device records of a window this short (78
    # of 174 events in one run of three): profile three times and keep the
    # attempt with the most device events
    attempts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pending()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        attempts.append((len(spans), window_ms, spans, prof))
    _n, window_ms, spans, prof = max(attempts, key=lambda a: a[0])
    busy = 0.0
    end = float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    ops = sorted(((a.key, a.self_device_time_total, a.count)
                  for a in prof.key_averages()
                  if a.device_type == DeviceType.CPU
                  and a.self_device_time_total > 0), key=lambda r: -r[1])
    res.update(
        unprofiled_ms=sorted(walls)[1], window_ms=window_ms,
        device_events=len(spans),
        device_events_by_attempt=[a[0] for a in attempts],
        busy_ms=busy / 1e3,
        temporaries_peak_bytes=torch.cuda.max_memory_allocated() - base,
        buffers_bytes=base,
        top_ops=[dict(op=k, us=t, calls=c) for k, t, c in ops[:12]])
    return res


#: the syncmer legs' scheme: s = 4 and a density at which a read keeps
#: within 2x of the density legs' minimizers (d / w of its HPC positions,
#: w = l - s + 1 = 11, against 2 * 0.003)
SYNC_KW = dict(use_syncmers=True, s=4, density=0.05)


def _set_paths(p, **paths):
    for attr, path in paths.items():
        object.__setattr__(p, attr, path)
    return p


def _same_outputs(what: str, a: str, b: str, records: bool = True):
    if open(a + ".gfa", "rb").read() != open(b + ".gfa", "rb").read():
        raise SystemExit(f"{what}: .gfa differs")
    if records and read_records(a) != read_records(b):
        raise SystemExit(f"{what}: .sequences records differ")


def write_scheme_inputs(tmp: str, np) -> dict:
    """Seeded inputs of the scheme parity legs, beside parity.fa: the reads
    with a few N, an lmer-count file (the 14-mers of the first 12 reads
    after homopolymer compression, as a k-mer counter prints them, every
    seventh with an outlier count above lmer_counts_max), UHS and LCP files
    of random 14-mers, and a two-record genome of 1.3 + 0.2 Mbp."""
    import re
    from collections import Counter

    rng = np.random.default_rng(5)
    reads = os.path.join(tmp, "parity.fa")
    out = dict(reads=reads, reads_n=os.path.join(tmp, "parity_n.fa"),
               lmers=os.path.join(tmp, "lmers.txt"),
               uhs=os.path.join(tmp, "uhs.txt"),
               lcp=os.path.join(tmp, "lcp.txt"),
               genome=os.path.join(tmp, "genome2.fa"))
    cnt: Counter = Counter()
    n_reads = 0
    with open(reads) as f, open(out["reads_n"], "w") as fn:
        for line in f:
            if line.startswith(">"):
                fn.write(line)
                continue
            s = bytearray(line.rstrip("\n").encode())
            if n_reads % 3 == 0:
                for j in rng.integers(0, len(s), 4):
                    s[j] = ord("N")
            fn.write(s.decode() + "\n")
            if n_reads < 12:
                h = re.sub(r"(.)\1+", r"\1", line.strip())
                for j in range(len(h) - 13):
                    cnt[h[j : j + 14]] += 1
            n_reads += 1
    with open(out["lmers"], "w") as f:
        for i, lm in enumerate(sorted(cnt)):
            f.write(f"{lm} {10 ** 6 if i % 7 == 0 else 50}\n")
    for key, n in (("uhs", 50_000), ("lcp", 2_000)):
        lm = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, (n, 14))]
        with open(out[key], "wb") as f:
            f.write(b"\n".join(r.tobytes() for r in lm) + b"\n")
    with open(out["genome"], "wb") as f:
        for name, n in ((b"chrA", 1_300_000), (b"chrB", 200_000)):
            f.write(b">" + name + b"\n" + np.frombuffer(
                b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)].tobytes()
                + b"\n")
    out["lmer_keys"] = len(cnt)
    return out


def scheme_parity(tmp: str, Params, np) -> dict:
    """Every minimizer scheme and streaming flag on the parity corpus:
    cuda = cpu in .gfa bytes and .sequences records (and .ec_data /
    .read_stats bytes), and --engine device = --engine host."""
    from rust_mdbg_tpu_torch.core.pipeline import assemble
    from rust_mdbg_tpu_torch.ops import kernels

    f = write_scheme_inputs(tmp, np)
    base = dict(k=21, l=14, density=0.003, min_kmer_abundance=2)
    out = {"lmer_keys": f["lmer_keys"]}

    # the device drivers under --syncmers: chunked raw and pre-HPC (vector
    # mode both), the whole-run table at minabund 2 (its graph held against
    # the chunked leg's) and, through `assemble`, at minabund 17.  The 30x
    # parity corpus leaves no window with 17 sightings, so that leg reads a
    # deeper corpus of its own: 120x of a 0.05 Mbp genome.  Batches of 64
    # reads: the CPU side walks every batch column by column
    from rust_mdbg_tpu_torch.core.pipeline import assemble_device_table
    from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads

    deep = os.path.join(tmp, "parity_deep.fa")
    write_synthetic_reads(deep, genome_mbp=0.05, coverage=120,
                          read_len=10_000, error_rate=0.003, seed=7)
    for leg, extra in (
            ("syncmers_raw", {}),
            ("syncmers_prehpc", dict(reads_already_hpc=True)),
            ("syncmers_table", dict(batch_reads=64)),
            ("syncmers_table17", dict(min_kmer_abundance=17,
                                      batch_reads=64))):
        t0 = time.perf_counter()
        p = Params(**{**base, **SYNC_KW, **extra})
        run = assemble_device_table if leg == "syncmers_table" else assemble
        reads = deep if leg == "syncmers_table17" else f["reads"]
        before = (kernels.syncmer_select.launches,
                  kernels.nthash_select.launches)
        sg = run(reads, p, os.path.join(tmp, f"{leg}_g"), device=DEVICE)
        launched = kernels.syncmer_select.launches - before[0]
        if launched <= 0 or kernels.nthash_select.launches != before[1]:
            raise SystemExit(f"scheme parity ({leg}): syncmer_select "
                             f"launched {launched} times")
        run(reads, p, os.path.join(tmp, f"{leg}_c"), device="cpu")
        _same_outputs(f"scheme parity ({leg}), cuda vs cpu",
                      os.path.join(tmp, f"{leg}_g"),
                      os.path.join(tmp, f"{leg}_c"))
        if ("phase1_nodes" in sg) != leg.startswith("syncmers_table") \
                or sg["nb_nodes"] <= 0 or sg["nb_edges"] <= 0:
            raise SystemExit(f"scheme parity ({leg}): wrong driver or empty "
                             f"graph: {sg}")
        if leg == "syncmers_table" and gfa_signature(
                os.path.join(tmp, f"{leg}_g")) != gfa_signature(
                os.path.join(tmp, "syncmers_raw_g")):
            raise SystemExit("scheme parity (syncmers_table): node multiset "
                             "or edge count differs from the chunked leg's")
        out[leg] = dict(nodes=sg["nb_nodes"], edges=sg["nb_edges"],
                        windows=sg["nb_windows"], kernel_launches=launched)
        if leg == "syncmers_raw":
            # the numpy host engine (streaming) writes the same graph
            assemble(f["reads"], p.replace(engine="host"),
                     os.path.join(tmp, f"{leg}_h"), device=DEVICE)
            _same_outputs(f"scheme parity ({leg}), device vs host engine",
                          os.path.join(tmp, f"{leg}_g"),
                          os.path.join(tmp, f"{leg}_h"))
            out[leg]["same_as_host_engine"] = True
        out[leg]["seconds"] = time.perf_counter() - t0
        print(f"scheme parity leg {leg}: {json.dumps(out[leg])}", flush=True)

    # the streaming engine
    legs = {
        "lmer_counts": (dict(has_lmer_counts=True),
                        dict(_lmer_counts_path=f["lmers"]), f["reads"]),
        "uhs": (dict(uhs=True), dict(_uhs_path=f["uhs"]), f["reads"]),
        "uhs_bf": (dict(uhs=True, use_bf=True, bloom_log2_bits=26),
                   dict(_uhs_path=f["uhs"]), f["reads"]),
        "lcp": (dict(lcp=True), dict(_lcp_path=f["lcp"]), f["reads_n"]),
        # a genome keeps every k-min-mer: --minabund 1
        "reference": (dict(reference=True, min_kmer_abundance=1,
                           batch_reads=2), {}, f["genome"]),
    }
    for leg, (extra, paths, reads) in legs.items():
        t0 = time.perf_counter()
        st = {}
        for tag, engine, dev in (("g", "device", DEVICE), ("c", "device", "cpu"),
                                 ("h", "host", DEVICE)):
            p = _set_paths(Params(**{**base, **extra, "engine": engine}),
                           **paths)
            before = kernels.nthash_select.launches
            st[tag] = assemble(reads, p, os.path.join(tmp, f"{leg}_{tag}"),
                               device=dev)
            if tag == "g":
                launched = kernels.nthash_select.launches - before
        for tag, what in (("c", "cuda vs cpu"),
                          ("h", "device vs host engine")):
            _same_outputs(f"scheme parity ({leg}), {what}",
                          os.path.join(tmp, f"{leg}_g"),
                          os.path.join(tmp, f"{leg}_{tag}"))
            if leg == "reference" and \
                    open(os.path.join(tmp, f"{leg}_g.ec_data"), "rb").read() \
                    != open(os.path.join(tmp, f"{leg}_{tag}.ec_data"),
                            "rb").read():
                raise SystemExit(f"scheme parity ({leg}), {what}: .ec_data "
                                 "differs")
        sg = st["g"]
        if launched <= 0 or sg["nb_nodes"] <= 0 or sg["nb_edges"] <= 0:
            raise SystemExit(f"scheme parity ({leg}): {launched} launches, "
                             f"{sg}")
        if leg == "reference" and not (
                sg["tiled_rows"] == st["c"]["tiled_rows"] == 2
                and sg["tile_host_rows"] == 0):
            raise SystemExit(f"scheme parity ({leg}): the tiler took "
                             f"{sg['tiled_rows']} rows, "
                             f"{sg['tile_host_rows']} on the host")
        if sg["host_rows"] > HOST_ROW_SHARE * sg["nb_reads"]:
            raise SystemExit(f"scheme parity ({leg}): {sg['host_rows']} of "
                             f"{sg['nb_reads']} rows re-extracted on the "
                             "host")
        if sg["filter_fill"] != st["c"]["filter_fill"]:
            raise SystemExit(f"scheme parity ({leg}): filter fill "
                             f"{sg['filter_fill']} on the card, "
                             f"{st['c']['filter_fill']} on the CPU")
        out[leg] = dict(nodes=sg["nb_nodes"], edges=sg["nb_edges"],
                        windows=sg["nb_windows"], host_rows=sg["host_rows"],
                        tiled_rows=sg["tiled_rows"],
                        tile_host_rows=sg["tile_host_rows"],
                        filter_fill=sg["filter_fill"],
                        kernel_launches=launched,
                        seconds=time.perf_counter() - t0)
        print(f"scheme parity leg {leg}: {json.dumps(out[leg])}", flush=True)

    # --read-stats writes beside its input: every run gets its own copy
    t0 = time.perf_counter()
    blobs = {}
    for tag, engine, dev in (("g", "device", DEVICE), ("c", "device", "cpu"),
                             ("h", "host", DEVICE)):
        rs = os.path.join(tmp, f"stats_input_{tag}.fa")
        shutil.copy(f["reads"], rs)
        st = assemble(f["reads"], Params(**base, engine=engine),
                      os.path.join(tmp, f"rs_{tag}"), read_stats_path=rs,
                      device=dev)
        if "nb_nodes" in st or os.path.exists(
                os.path.join(tmp, f"rs_{tag}.gfa")):
            raise SystemExit("scheme parity (read_stats): a GFA was written")
        blobs[tag] = open(rs + ".read_stats", "rb").read()
    if not (blobs["g"] == blobs["c"] == blobs["h"]) or not blobs["g"]:
        raise SystemExit("scheme parity (read_stats): .read_stats differ")
    out["read_stats"] = dict(bytes=len(blobs["g"]), reads=st["nb_reads"],
                             seconds=time.perf_counter() - t0)
    return out


def fault_legs(tmp: str, Params) -> dict:
    """The three cures of runs the JAX package finishes only through its
    streaming fall-back, cuda = cpu in .gfa bytes and .sequences records,
    each with its re-plans or route: (a) a read three times the sampled
    length after read 100 (the chunked driver stages it alone, the whole
    run restarts), (b) a forced small minimizer capacity (chunks re-run at
    doubled slots, the whole run restarts), (c) an over-budget run at
    minabund 17 (the streaming engine on the card), density and syncmers;
    and (d) a chunk re-planned until its minimizer slots equal its staged
    width (core/chunked.doubled_plan's M == L, the compaction's flat branch
    at a two-level width): pre-HPC'd 4,096 bp reads staged at 4,096, d =
    0.9 (nearly every l-mer a minimizer), M from 1,024 to 4,096, with the
    construct kernels' launches and the compaction seen at M == L on the
    card."""
    from rust_mdbg_tpu_torch.core.pipeline import assemble
    from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
    from rust_mdbg_tpu_torch.ops import kernels

    base = os.path.join(tmp, "fault_base.fa")
    write_synthetic_reads(base, genome_mbp=0.1, coverage=100, read_len=5000,
                          error_rate=0.002, seed=13)
    with open(base) as f:
        lines = f.read().split("\n")
    lines[2 * 149 + 1] = "".join(lines[1:7:2])
    long = os.path.join(tmp, "fault_long.fa")
    with open(long, "w") as f:
        f.write("\n".join(lines))
    wide = os.path.join(tmp, "fault_wide.fa")
    write_synthetic_reads(wide, genome_mbp=0.05, coverage=5, read_len=4096,
                          error_rate=0.002, seed=17)
    kw = dict(k=21, l=14, density=0.003, batch_reads=64)
    legs = [("long_read_chunked", long, dict(min_kmer_abundance=2), None),
            ("long_read_whole17", long, dict(min_kmer_abundance=17), None),
            ("doubled_m_chunked", base,
             dict(min_kmer_abundance=2, max_minimizers_per_read=24), None),
            ("doubled_m_whole17", base,
             dict(min_kmer_abundance=17, max_minimizers_per_read=24), None),
            ("over_budget17", base, dict(min_kmer_abundance=17), 1),
            # k = 7: open syncmers at d = 0.05 keep ~1 % of positions;
            # batches of 512: the CPU side walks each column by column
            ("over_budget17_syncmers", base,
             dict(min_kmer_abundance=17, k=7, batch_reads=512, **SYNC_KW),
             1),
            ("doubled_m_to_width", wide,
             dict(min_kmer_abundance=2, k=7, l=10, density=0.9,
                  max_minimizers_per_read=1024, max_read_len=4096,
                  reads_already_hpc=True), None)]
    out = {}
    for leg, reads, extra, budget in legs:
        t0 = time.perf_counter()
        p = Params(**{**kw, **extra})
        before = (kernels.nthash_select.launches,
                  kernels.syncmer_select.launches)
        zero_construct_launches()
        with CompactShapes() as shapes:
            sg = assemble(reads, p, os.path.join(tmp, f"{leg}_g"),
                          device=DEVICE, mem_budget=budget)
        launched = (kernels.nthash_select.launches - before[0],
                    kernels.syncmer_select.launches - before[1])
        cl = construct_launches()
        sc = assemble(reads, p, os.path.join(tmp, f"{leg}_c"), device="cpu",
                      mem_budget=budget)
        _same_outputs(f"fault leg ({leg}), cuda vs cpu",
                      os.path.join(tmp, f"{leg}_g"),
                      os.path.join(tmp, f"{leg}_c"))
        route = sg.get("route")
        if budget is not None:
            ok = route == sc.get("route") == \
                "streaming (over whole-run budget)"
        else:
            ok = route is None and sg["replans"] == sc["replans"] >= 1
        if not ok or launched[1 if p.use_syncmers else 0] <= 0 \
                or sg["nb_nodes"] <= 0:
            raise SystemExit(f"fault leg ({leg}): route {route}, re-plans "
                             f"{sg.get('replans')} / {sc.get('replans')}, "
                             f"launches {launched}, {sg['nb_nodes']} nodes")
        if leg == "doubled_m_to_width":
            require_construct(f"fault leg ({leg})", cl, CONSTRUCT_KERNELS)
            at_width = {(d, L, M) for _, L, M, d in shapes.seen}
            if (DEVICE, 4096, 4096) not in at_width or sg["replans"] < 2:
                raise SystemExit(f"fault leg ({leg}): no compaction at M == "
                                 f"L == 4096 on {DEVICE}: {sorted(at_width)}"
                                 f", re-plans {sg['replans']}")
        out[leg] = dict(nodes=sg["nb_nodes"], edges=sg["nb_edges"],
                        reads=sg["nb_reads"], replans=sg.get("replans"),
                        construct_launches=cl,
                        compaction_shapes=sorted(
                            {s[1:3] for s in shapes.seen}),
                        route=route or ("whole run" if "phase1_nodes" in sg
                                        else "chunked"),
                        nthash_select_launches=launched[0],
                        syncmer_select_launches=launched[1],
                        seconds=time.perf_counter() - t0)
        print(f"fault leg {leg}: {json.dumps(out[leg])}", flush=True)
    return out


def scheme_main(tmp: str, Params, syn: dict, leg: str, np) -> dict:
    """One of the three scheme legs over main.fa at [512, 24576] batches,
    k = 21, l = 14: (d) --syncmers raw through assemble (the chunked
    driver), (e) --uhs --bf through the streaming engine, (f) --reference
    on the corpus's genome as one record (tiled extraction)."""
    import torch

    from rust_mdbg_tpu_torch.core import pipeline
    from rust_mdbg_tpu_torch.ops import kernels

    kw = dict(k=21, l=14, density=0.003, min_kmer_abundance=2)
    reads = os.path.join(tmp, "main.fa")
    if leg == "syncmers":
        p = Params(**{**kw, **SYNC_KW})
    elif leg == "uhs_bf":
        uhs = os.path.join(tmp, "uhs.txt")  # scheme_parity's 50,000 14-mers
        p = _set_paths(Params(**kw, uhs=True, use_bf=True,
                              max_read_len=24_576), _uhs_path=uhs)
    else:
        reads = os.path.join(tmp, "genome.fa")
        p = Params(**{**kw, "min_kmer_abundance": 1}, reference=True,
                   batch_reads=1)
    prefix = os.path.join(tmp, f"scheme_{leg}")
    torch.cuda.reset_peak_memory_stats()
    kernels.nthash_select.launches = 0
    kernels.syncmer_select.launches = 0
    zero_construct_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = pipeline.assemble(reads, p, prefix, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(nthash_select=kernels.nthash_select.launches,
                    syncmer_select=kernels.syncmer_select.launches)
    cl = construct_launches()
    # the chunked driver runs both construct kernels; the streaming engine
    # (--uhs --bf, the --reference tiler) the compaction alone
    require_construct(f"scheme main path ({leg})", cl,
                      CONSTRUCT_KERNELS if leg == "syncmers"
                      else CONSTRUCT_KERNELS[:1])
    wanted = "syncmer_select" if leg == "syncmers" else "nthash_select"
    if launches[wanted] <= 0:
        raise SystemExit(f"scheme main path ({leg}): {wanted} never "
                         "launched")
    (nodes, n_l) = gfa_signature(prefix)
    n_rec = len(read_records(prefix))
    if not (len(nodes) == st["nb_nodes"] == n_rec and n_l == st["nb_edges"]
            and n_rec > 0 and n_l > 0):
        raise SystemExit(f"scheme main path ({leg}): inconsistent outputs "
                         f"S={len(nodes)} L={n_l} records={n_rec} "
                         f"stats={st}")
    bases = syn["genome_size"] if leg == "reference" else syn["total_bases"]
    out = dict(
        input_gbp=bases / 1e9, reads=st["nb_reads"], nodes=st["nb_nodes"],
        edges=st["nb_edges"], windows=st["nb_windows"], wall_s=wall,
        input_gbp_per_s=bases / 1e9 / wall, phases=st["phases"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        host_rows=st.get("host_rows", 0),
        nthash_select_launches=launches["nthash_select"],
        syncmer_select_launches=launches["syncmer_select"],
        construct_launches=cl, replans=st.get("replans"))
    if leg == "syncmers":
        if "nb_chunks" not in st:
            raise SystemExit("scheme main path (syncmers): the run did not "
                             "take the chunked driver")
        out.update(density=p.density, s=p.s, chunks=st["nb_chunks"],
                   minimizers_per_read=(st["nb_windows"] / st["nb_reads"]
                                        + p.k - 1))
    else:
        # a leg where more than a few rows went round the card fails
        if st["host_rows"] > HOST_ROW_SHARE * st["nb_reads"] or (
                leg == "reference"
                and (st["tiled_rows"] != 1 or st["tile_host_rows"])):
            raise SystemExit(f"scheme main path ({leg}): rows taken on the "
                             f"host: {st}")
        out.update(filter_fill=st["filter_fill"],
                   tiled_rows=st["tiled_rows"],
                   tile_host_rows=st["tile_host_rows"])
    return out


def syncmer_breakdown(tmp: str, Params) -> dict:
    """Device time by torch op over one [512, 24576] batch of main.fa
    through the count-path extraction under --syncmers (what the chunked
    driver runs per batch), under torch.profiler after a warm-up; the hand
    kernel's share, and the unprofiled wall beside the profiled window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rust_mdbg_tpu_torch.core.chunked import plan_chunks
    from rust_mdbg_tpu_torch.ops.extract import extract_count
    from rust_mdbg_tpu_torch.ops.pack import unpack_codes

    reads = os.path.join(tmp, "main.fa")
    p = Params(k=21, l=14, min_kmer_abundance=2, **SYNC_KW)
    plan = plan_chunks(reads, p)
    dev = torch.device("cuda")
    c = first_staged_chunk(reads, p, plan, dev)
    staged, lens_d = c.planes, c.lens
    B = plan["B"]

    def batch():
        codes = unpack_codes(staged[0][:B], staged[1][:B])
        return extract_count(codes, lens_d[:B], l=p.l, k=p.k,
                             hash_bound=p.hash_bound, M=plan["M"],
                             syncmer=(p.s, p.syncmer_hash_bound))

    out = batch()
    n_min = float((out["nw"].float().mean() + p.k - 1))
    width = c.width
    del out
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    unprofiled_us = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, kernel_us = [], 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if "syncmer_select" in e.name:
            kernel_us += e.time_range.end - e.time_range.start
    busy = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    ops = sorted(((a.key, a.self_device_time_total, a.count)
                  for a in prof.key_averages()
                  if a.device_type == DeviceType.CPU
                  and a.self_device_time_total > 0), key=lambda r: -r[1])
    return dict(
        shape=[B, width], M=plan["M"], w_slot=plan["w_slot"],
        chunk_reads=plan["chunk_reads"], minimizers_per_read=n_min,
        window_us=wall_us, unprofiled_us=unprofiled_us,
        device_events=len(spans), busy_us=busy,
        device_us=sum(b - a for a, b in spans),
        syncmer_select_us=kernel_us,
        syncmer_select_share=kernel_us / busy if busy else None,
        top_ops=[dict(op=k, us=t, calls=c) for k, t, c in ops[:12]])


def _write_fasta(path: str, seqs) -> str:
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">r%d\n" % i + s + b"\n")
    return path


def _sample_reads(np, rng, genome, n: int, read_len: int):
    """n error-free reads of read_len bases at uniform starts of genome
    (uint8 codes 0..3), as ASCII bytes."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    starts = rng.integers(0, genome.size - read_len, n)
    return [acgt[genome[s0 : s0 + read_len]].tobytes() for s0 in starts]


def write_branch_inputs(tmp: str, np, p) -> dict:
    """Seeded inputs of the branch legs.  cap.fa: 100 reads of 4 kb, then
    2,000 of 1.5 kb of the same 0.02 Mbp genome (the whole run sizes its
    counter from the first hundred reads' mean length, so the estimate
    falls short of the input).  hub.fa: 30x of 10 kb reads over 24 copies
    of one 8 kb hub, each followed by its own 4 kb branch (one overlap key
    with 24 successors, over the join's 16 group slots).  tandem.fa: one
    1.35 Mbp record whose 0.25 Mbp tandem repeat of a 24-base unit selects
    a minimizer of `p` every few bases (its tile overflows)."""
    rng = np.random.default_rng(17)
    out = {}
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    out["cap"] = _write_fasta(
        os.path.join(tmp, "cap.fa"),
        _sample_reads(np, rng, genome, 100, 4_000)
        + _sample_reads(np, rng, genome, 2_000, 1_500))
    hub = rng.integers(0, 4, 8_000).astype(np.uint8)
    genome = np.concatenate([np.concatenate(
        [hub, rng.integers(0, 4, 4_000).astype(np.uint8)])
        for _ in range(24)])
    out["hub"] = _write_fasta(
        os.path.join(tmp, "hub.fa"),
        _sample_reads(np, rng, genome, 30 * genome.size // 10_000, 10_000))
    # a unit without homopolymers (also across its wrap), so HPC leaves the
    # tandem as it is, that holds a selected l-mer
    from rust_mdbg_tpu_torch.ops.minimizers import extract_density_np

    while True:
        unit = np.cumsum(rng.integers(1, 4, 24)).astype(np.uint8) % 4
        if unit[0] != unit[-1] and len(extract_density_np(
                np.tile(unit, 4), p.l, p.hash_bound)[0]):
            break
    region = np.tile(unit, 250_000 // 24)
    genome = np.concatenate([rng.integers(0, 4, 800_000).astype(np.uint8),
                             region,
                             rng.integers(0, 4, 300_000).astype(np.uint8)])
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out["tandem"] = os.path.join(tmp, "tandem.fa")
    with open(out["tandem"], "wb") as f:
        f.write(b">tandem\n" + acgt[genome].tobytes() + b"\n")
    return out


def branch_legs(tmp: str, Params, np) -> dict:
    """Branches the CPU tests force and the card had not run, each forced
    with knobs that exist and held cuda = cpu in .gfa bytes and .sequences
    records, with the stat that shows the branch was taken:

    - catalog_spill: core/chunked.CATALOG_ROWS at half the pre-HPC parity
      graph's nodes, chunks of 256 reads: the device key catalog fills and spills
      to the host join (no `catalog_rows` in the stats); against
      prehpc_parity's CPU run;
    - counter_grow: the whole run at k = 7, minabund 17 on cap.fa, whose read
      estimate is below its reads: `DeviceNodeCounter.grow` (the stats'
      `read_cap` above the plan's);
    - host_rows: the --lmer-counts streaming leg with
      max_minimizers_per_read 32: rows over their slots re-extracted on the
      host (`host_rows` > 0); against scheme_parity's CPU run;
    - tile_overflow: --reference on tandem.fa: a tile over its capacity
      takes the exact host row (`tile_host_rows` 1);
    - g_slots: pre-HPC hub.fa: a key group over G_SLOTS, the host join from
      the permuted device catalog (`edge_join` host, `catalog_rows` set).
    """
    from rust_mdbg_tpu_torch.core import chunked, pipeline
    from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
    from rust_mdbg_tpu_torch.ops import kernels

    base = dict(k=21, l=14, density=0.003, min_kmer_abundance=2)
    f = write_branch_inputs(tmp, np, Params(**base))
    pre = Params(**base, reads_already_hpc=True)
    out = {}

    def leg(name, run, ref=None, catalog_rows=None):
        """run(device, prefix) -> stats, on the card and (without `ref`,
        the prefix of a CPU run of the same input) on the CPU."""
        t0 = time.perf_counter()
        g, c = os.path.join(tmp, f"{name}_g"), os.path.join(tmp, f"{name}_c")
        rows = chunked.CATALOG_ROWS
        if catalog_rows is not None:
            chunked.CATALOG_ROWS = catalog_rows
        try:
            before = kernels.nthash_select.launches
            sg = run(DEVICE, g)
            launched = kernels.nthash_select.launches - before
            sc = run("cpu", c) if ref is None else None
        finally:
            chunked.CATALOG_ROWS = rows
        _same_outputs(f"branch leg ({name}), cuda vs cpu", g, ref or c)
        if launched <= 0 or sg["nb_nodes"] <= 0:
            raise SystemExit(f"branch leg ({name}): {launched} launches, "
                             f"{sg['nb_nodes']} nodes")
        out[name] = dict(nodes=sg["nb_nodes"], edges=sg["nb_edges"],
                         kernel_launches=launched)
        return sg, sc, out[name], t0

    cap = max(1, len(read_records(os.path.join(tmp, "hc"))) // 2)
    sg, _, o, t0 = leg(
        "catalog_spill",
        lambda dev, pfx: assemble_device_chunked(
            os.path.join(tmp, "parity.fa"), pre, pfx, chunk_reads=256,
            device=dev),
        ref=os.path.join(tmp, "hc"), catalog_rows=cap)
    o.update(cat_cap=cap, chunks=sg["nb_chunks"],
             edge_join=sg.get("edge_join"),
             catalog_rows=sg.get("catalog_rows"))
    if sg.get("edge_join") != "host" or "catalog_rows" in sg:
        raise SystemExit(f"branch leg (catalog_spill): no spill: {o}")
    o["seconds"] = time.perf_counter() - t0
    print(f"branch leg catalog_spill: {json.dumps(o)}", flush=True)

    # k = 7: a window spans ~1.2 kb at this density, so the short reads
    # hold windows
    p17 = Params(**{**base, "k": 7, "min_kmer_abundance": 17})
    planned = pipeline.plan_table(f["cap"], p17)["read_cap"]
    sg, sc, o, t0 = leg("counter_grow", lambda dev, pfx: pipeline.assemble(
        f["cap"], p17, pfx, device=dev))
    o.update(reads=sg["nb_reads"], planned_read_cap=planned,
             read_cap=sg.get("read_cap"), cpu_read_cap=sc.get("read_cap"))
    if "phase1_nodes" not in sg or not (
            planned < sg["nb_reads"] <= sg["read_cap"] == sc["read_cap"]):
        raise SystemExit(f"branch leg (counter_grow): no grow: {o}")
    o["seconds"] = time.perf_counter() - t0
    print(f"branch leg counter_grow: {json.dumps(o)}", flush=True)

    p = _set_paths(Params(**base, has_lmer_counts=True,
                          max_minimizers_per_read=32),
                   _lmer_counts_path=os.path.join(tmp, "lmers.txt"))
    sg, _, o, t0 = leg("host_rows", lambda dev, pfx: pipeline.assemble(
        os.path.join(tmp, "parity.fa"), p, pfx, device=dev),
        ref=os.path.join(tmp, "lmer_counts_c"))
    o.update(reads=sg["nb_reads"], host_rows=sg["host_rows"])
    if not 0 < sg["host_rows"] < sg["nb_reads"]:
        raise SystemExit(f"branch leg (host_rows): {o}")
    o["seconds"] = time.perf_counter() - t0
    print(f"branch leg host_rows: {json.dumps(o)}", flush=True)

    pref = Params(**{**base, "min_kmer_abundance": 1}, reference=True,
                  batch_reads=1)
    sg, sc, o, t0 = leg("tile_overflow", lambda dev, pfx: pipeline.assemble(
        f["tandem"], pref, pfx, device=dev))
    o.update(tiled_rows=sg["tiled_rows"], tile_host_rows=sg["tile_host_rows"])
    if not (sg["tiled_rows"] == sc["tiled_rows"] == 1
            and sg["tile_host_rows"] == sc["tile_host_rows"] == 1):
        raise SystemExit(f"branch leg (tile_overflow): {o}")
    o["seconds"] = time.perf_counter() - t0
    print(f"branch leg tile_overflow: {json.dumps(o)}", flush=True)

    sg, sc, o, t0 = leg("g_slots", lambda dev, pfx: assemble_device_chunked(
        f["hub"], pre, pfx, device=dev))
    o.update(edge_join=sg.get("edge_join"),
             catalog_rows=sg.get("catalog_rows"))
    if not (sg.get("edge_join") == sc.get("edge_join") == "host"
            and sg.get("catalog_rows") == sg["nb_nodes"]):
        raise SystemExit(f"branch leg (g_slots): no G_SLOTS fall-back: {o}")
    o["seconds"] = time.perf_counter() - t0
    print(f"branch leg g_slots: {json.dumps(o)}", flush=True)
    return out


def contig_stats(fa: str, genome_size: int) -> dict:
    """Contig count, N50, total and longest length of a FASTA of contigs,
    and the total against the genome's size."""
    from rust_mdbg_tpu_torch.io.fastx import read_records as fasta_records

    lens = sorted((len(s) for _, s in fasta_records(fa)), reverse=True)
    total, acc, n50 = sum(lens), 0, 0
    for n in lens:
        acc += n
        if 2 * acc >= total:
            n50 = n
            break
    return dict(contigs=len(lens), n50=n50, total_bp=total,
                longest=lens[0] if lens else 0,
                total_over_genome=total / genome_size)


def timed_magic_simplify(prefix: str) -> dict:
    """tools/magic_simplify on prefix, with the seconds of each step (the
    module's own step functions, wrapped for the call) and the gfa_asm
    engine each simplification round ran on."""
    from rust_mdbg_tpu_torch.tools import gfa_asm
    from rust_mdbg_tpu_torch.tools import magic_simplify as ms

    steps: list = []
    engines: list = []
    names = dict(run_ops_file="round", break_loops="break_loops",
                 to_basespace="to_basespace", gfa2fasta="gfa2fasta")
    orig = {name: getattr(ms, name) for name in names}

    def timed(name):
        def call(*args, **kw):
            if name == "run_ops_file":
                engines.append(gfa_asm.engine_choice(kw.get("engine")))
            t0 = time.perf_counter()
            res = orig[name](*args, **kw)
            label = names[name]
            if label == "round":
                label = f"round{len(engines)}"
            steps.append((label, time.perf_counter() - t0))
            return res
        return call

    for name in names:
        setattr(ms, name, timed(name))
    t0 = time.perf_counter()
    try:
        ms.magic_simplify(prefix)
    finally:
        for name, fn in orig.items():
            setattr(ms, name, fn)
    wall = time.perf_counter() - t0
    if engines != ["native"] * len(engines) or not engines:
        raise SystemExit(f"magic-simplify: gfa_asm ran on {engines}, not the "
                         "native engine")
    return dict(seconds=wall, steps=steps, gfa_asm_engines=engines)


def multik_cli(workdir: str, reads: str, device: str | None) -> dict:
    """`python -m rust_mdbg_tpu_torch multik READS mk 8 [--device cpu]`
    through the CLI's main in workdir (multik's clean-up globs the cwd),
    with each round's k, seconds and nthash_select launches."""
    from rust_mdbg_tpu_torch import cli
    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.tools import multik

    rounds: list = []
    orig = multik._assemble_round

    def counted(cur_reads, k, *args, **kw):
        before = kernels.nthash_select.launches
        t0 = time.perf_counter()
        orig(cur_reads, k, *args, **kw)
        rounds.append(dict(k=k, seconds=time.perf_counter() - t0,
                           nthash_select_launches=(
                               kernels.nthash_select.launches - before)))

    os.makedirs(workdir)
    cwd = os.getcwd()
    multik._assemble_round = counted
    os.chdir(workdir)
    t0 = time.perf_counter()
    try:
        argv = ["multik", os.path.abspath(reads), "mk", "8"]
        rc = cli.main(argv + (["--device", device] if device else []))
    finally:
        os.chdir(cwd)
        multik._assemble_round = orig
    if rc != 0:
        raise SystemExit(f"multik ({device or 'cuda'}): exit code {rc}")
    return dict(seconds=time.perf_counter() - t0, rounds=rounds,
                final=os.path.join(workdir, "mk-final.msimpl.fa"))


def tools_phase(tmp: str, syn: dict) -> dict:
    """The tool subcommands on the port's graphs: (1) magic-simplify of
    the raw parity leg's cuda and cpu outputs, byte-equal contigs; (2)
    magic-simplify of the raw chunked main leg, step by step, on the native
    gfa_asm engine, with the port's first assembly numbers; (3) multik
    through the CLI on the card over the parity corpus (rounds k = 10, 15,
    20, 25), nthash_select launched in every round, and on a small corpus
    on the card and with --device cpu, the same final contigs."""
    from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
    from rust_mdbg_tpu_torch.ops import kernels

    out = {}
    t0 = time.perf_counter()
    for side in ("pg", "pc"):
        timed_magic_simplify(os.path.join(tmp, side))
    for ext in ("msimpl.gfa", "msimpl.fa"):
        a, b = (open(os.path.join(tmp, f"{side}.{ext}"), "rb").read()
                for side in ("pg", "pc"))
        if a != b or not a:
            raise SystemExit(f"tools (parity): {ext} differs between cuda "
                             "and cpu")
    out["parity"] = contig_stats(os.path.join(tmp, "pg.msimpl.fa"), 500_000)
    out["parity"]["seconds"] = time.perf_counter() - t0
    print(f"tools parity magic-simplify: {json.dumps(out['parity'])}",
          flush=True)

    ms = timed_magic_simplify(os.path.join(tmp, "main"))
    ms.update(contig_stats(os.path.join(tmp, "main.msimpl.fa"),
                           syn["genome_size"]))
    ms["genome_bp"] = syn["genome_size"]
    out["main"] = ms
    print(f"tools main magic-simplify: {json.dumps(ms)}", flush=True)

    # no --device: the CLI's default, the card (a CPU rehearsal of this
    # script names its DEVICE)
    card = None if DEVICE == "cuda" else DEVICE
    kernels.nthash_select.launches = 0
    mk = multik_cli(os.path.join(tmp, "multik_parity"),
                    os.path.join(tmp, "parity.fa"), card)
    launches = kernels.nthash_select.launches
    mk.update(contig_stats(mk.pop("final"), 500_000),
              nthash_select_launches=launches)
    if [r["k"] for r in mk["rounds"]] != [10, 15, 20, 25] or \
            min(r["nthash_select_launches"] for r in mk["rounds"]) <= 0:
        raise SystemExit(f"multik (parity): rounds {mk['rounds']}")
    out["multik"] = mk
    print(f"tools multik: {json.dumps(mk)}", flush=True)

    t0 = time.perf_counter()
    small = os.path.join(tmp, "multik_small.fa")
    write_synthetic_reads(small, genome_mbp=0.105, coverage=20,
                          read_len=6000, error_rate=0, seed=3)
    runs = {name: multik_cli(os.path.join(tmp, f"multik_{name}"), small,
                             dev)
            for name, dev in (("cuda", card), ("cpu", "cpu"))}
    fa = {dev: open(r["final"], "rb").read() for dev, r in runs.items()}
    if fa["cuda"] != fa["cpu"] or not fa["cuda"]:
        raise SystemExit("multik (small): -final.msimpl.fa differs between "
                         "cuda and cpu")
    if len(runs["cuda"]["rounds"]) != 2 or min(
            r["nthash_select_launches"] for r in runs["cuda"]["rounds"]) <= 0:
        raise SystemExit(f"multik (small): rounds {runs['cuda']['rounds']}")
    out["multik_small"] = dict(
        contig_stats(runs["cuda"]["final"], 105_000),
        rounds={dev: r["rounds"] for dev, r in runs.items()},
        seconds=time.perf_counter() - t0)
    print(f"tools multik cuda = cpu: {json.dumps(out['multik_small'])}",
          flush=True)
    return out


# --- experiments (experiments/, eval/, the profiler hook) -----------------

#: quality-n50's genome, cut from its 100 Mbp default to hold the phase
#: near 200 s: 100x of it is 1.0 Gbp a leg, the main corpus's size
QUALITY_GENOME_MBP = 10
#: quality-n50's protocol (experiments/quality_n50.py defaults)
QUALITY_KW = dict(k=35, l=12, d=0.002, minab=2, seed=11)
QUALITY_ERRS = (0.003, 0.0003, 0.0)


def _quality_leg(workdir: str, err: float, genome_mbp: int, coverage: int,
                 device: str) -> dict:
    """quality_n50.run_leg with its nthash_select launches (the count set
    to 0 just before, read just after) and the contig bytes' length; the
    leg's assembly outputs are removed after it."""
    import glob

    from rust_mdbg_tpu_torch.experiments import quality_n50
    from rust_mdbg_tpu_torch.ops import kernels

    os.makedirs(workdir, exist_ok=True)
    kernels.nthash_select.launches = 0
    leg = quality_n50.run_leg(workdir, err, genome_mbp, coverage,
                              QUALITY_KW["k"], QUALITY_KW["l"],
                              QUALITY_KW["d"], QUALITY_KW["minab"],
                              QUALITY_KW["seed"], device=device)
    leg["nthash_select_launches"] = kernels.nthash_select.launches
    (fa,) = glob.glob(os.path.join(workdir, "*.msimpl.fa"))
    with open(fa, "rb") as f:
        leg["_contigs"] = f.read()
    for path in glob.glob(os.path.join(workdir, "asm_*")):
        os.remove(path)
    return leg


def quality_phase(tmp: str, genome_mbp: int = QUALITY_GENOME_MBP,
                  small_mbp: int = 1) -> dict:
    """(a) quality-n50's three error legs at its protocol on the card, each
    launching nthash_select; then one leg at small_mbp x 10 on the card
    and on the CPU: the same record (its seconds aside) and contig bytes."""
    legs = {}
    for err in QUALITY_ERRS:
        leg = _quality_leg(os.path.join(tmp, "quality"), err, genome_mbp,
                           100, DEVICE)
        leg.pop("_contigs")
        print(f"experiments quality leg (err {err:g}, {genome_mbp} Mbp x "
              f"100): {json.dumps(leg)}", flush=True)
        if leg["nthash_select_launches"] <= 0 or not leg["nodes"] \
                or not leg["n_contigs"]:
            raise SystemExit(f"quality leg err {err:g}: {leg}")
        legs[f"{err:g}"] = leg
    small = {dev: _quality_leg(os.path.join(tmp, f"quality_{dev}"), 0.003,
                               small_mbp, 10, dev)
             for dev in (DEVICE, "cpu")}
    times = ("synth_s", "asm_s", "msimpl_s", "nthash_select_launches")
    a, b = ({k: v for k, v in small[dev].items() if k not in times}
            for dev in (DEVICE, "cpu"))
    if a != b or not a["_contigs"]:
        raise SystemExit(f"quality leg ({small_mbp} Mbp): cuda and cpu "
                         "differ")
    a.pop("_contigs")
    return dict(genome_mbp=genome_mbp, coverage=100, legs=legs,
                small=dict(a, genome_mbp=small_mbp, coverage=10,
                           seconds={dev: {k: small[dev][k] for k in times}
                                    for dev in small}))


def scaling_phase(tmp: str, genome_bp: int | None = None) -> dict:
    """(b) experiments/scaling at its protocol (400 kb x 12 of 4 kb reads,
    k=12 l=12 d=0.003): meshes of 1, 2, 4 and 8 shards on the card and
    the two gloo processes; one graph across every row."""
    from rust_mdbg_tpu_torch.experiments import scaling
    from rust_mdbg_tpu_torch.ops import kernels

    os.makedirs(os.path.join(tmp, "scaling"))
    reads = os.path.join(tmp, "scaling", "reads.fa")
    total = scaling.synth(reads, genome_bp=genome_bp or scaling.GENOME_BP)
    rows = []
    for n in (1, 2, 4, 8):
        kernels.nthash_select.launches = 0
        r = scaling.run_mesh(reads, n, device=DEVICE)
        r["nthash_select_launches"] = kernels.nthash_select.launches
        rows.append(r)
    rows.append(scaling.run_multihost(reads, device=DEVICE,
                                      timeout=MH_TIMEOUT_S))
    graphs = {(r["nodes"], r["edges"]) for r in rows}
    if len(graphs) != 1 or rows[0]["nodes"] <= 0 or min(
            r["nthash_select_launches"] for r in rows[:4]) <= 0:
        raise SystemExit(f"scaling: rows {rows}")
    return dict(read_gbp=total / 1e9, rows=rows)


def parity_check_phase(tmp: str, genome_bp: int = 10_000_000,
                       chunk_reads: int = 4096) -> dict:
    """(c) scale_demo.parity_check on the card at the JAX package's size
    (10 Mbp x 52, 0.52 Gbp, --minabund 3, err 0.002): whole run = chunked
    in GFA bytes over at least four chunks."""
    from rust_mdbg_tpu_torch.experiments import scale_demo
    from rust_mdbg_tpu_torch.ops import kernels

    d = os.path.join(tmp, "scale_parity")
    os.makedirs(d)
    kernels.nthash_select.launches = 0
    t0 = time.perf_counter()
    rec = scale_demo.parity_check(d, 0.002, 3, device=DEVICE,
                                  genome_bp=genome_bp,
                                  chunk_reads=chunk_reads)
    rec["seconds"] = time.perf_counter() - t0
    rec["nthash_select_launches"] = kernels.nthash_select.launches
    shutil.rmtree(d)
    if rec["nthash_select_launches"] <= 0:
        raise SystemExit("scale_demo parity: no nthash_select launch")
    return rec


def recovery_phase(tmp: str) -> dict:
    """(d) eval/recovery_grid, one point (k=21, l=12, d=0.003) on the
    parity corpus and its genome (the streaming tiler, then the chunked
    driver), on the card and on the CPU: the same recovery_pct."""
    import contextlib
    import io

    from rust_mdbg_tpu_torch.eval import recovery_grid
    from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
    from rust_mdbg_tpu_torch.ops import kernels

    reads = os.path.join(tmp, "parity.fa")
    genome = os.path.join(tmp, "parity_genome.fa")
    again = os.path.join(tmp, "parity_again.fa")
    # slice_parity's corpus, written again with its genome (same seed)
    write_synthetic_reads(again, genome_mbp=0.5, coverage=30,
                          read_len=10_000, error_rate=0.003, seed=3,
                          genome_out=genome)
    with open(reads, "rb") as f, open(again, "rb") as g:
        if f.read() != g.read():
            raise SystemExit("recovery: the parity corpus did not repeat")
    os.remove(again)
    out = {}
    for dev in (DEVICE, "cpu"):
        kernels.nthash_select.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the histograms
            series = recovery_grid.sweep(
                reads, genome, os.path.join(tmp, f"recovery_{dev}"),
                densities=[0.003], k=21, l=12, device=dev)
        (point,) = series["density"]
        out[dev] = dict(recovery_pct=point[1],
                        seconds=time.perf_counter() - t0,
                        nthash_select_launches=kernels.nthash_select.launches)
    if out[DEVICE]["recovery_pct"] != out["cpu"]["recovery_pct"] \
            or not out["cpu"]["recovery_pct"]:
        raise SystemExit(f"recovery: cuda and cpu differ: {out}")
    if DEVICE == "cuda" and out[DEVICE]["nthash_select_launches"] <= 0:
        raise SystemExit("recovery: no nthash_select launch on the card")
    return out


def profiled_chunk(tmp: str, Params) -> dict:
    """(f) PhaseTimer.phase(..., profile_dir=...) around one chunk of the
    parity corpus (the chunked driver's own steps): the trace it writes
    must hold the nthash_select kernel."""
    import torch

    from rust_mdbg_tpu_torch.core.chunked import (construct_chunk,
                                                  new_counter, plan_chunks)
    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.utils.timing import PhaseTimer

    reads = os.path.join(tmp, "parity.fa")
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2)
    plan = plan_chunks(reads, p)
    dev = torch.device(DEVICE)
    c = first_staged_chunk(reads, p, plan, dev)
    staged, lens_d = c.planes, c.lens
    counter = new_counter(p, plan, dev)
    prof_dir = os.path.join(tmp, "profile")
    timer = PhaseTimer()
    kernels.nthash_select.launches = 0
    with timer.phase("construct", profile_dir=prof_dir):
        construct_chunk(p, plan, counter, staged, lens_d, c.fill)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    launches = kernels.nthash_select.launches
    (trace,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, trace)) as f:
        events = json.load(f)["traceEvents"]
    hits = [e for e in events if "nthash_select" in e.get("name", "")
            and e.get("cat") == "kernel"]
    rec = dict(trace=trace, trace_events=len(events),
               nthash_select_kernels=len(hits),
               nthash_select_us=sum(e.get("dur", 0) for e in hits),
               nthash_select_launches=launches,
               phase_s=timer.report()["construct"])
    shutil.rmtree(prof_dir)
    if DEVICE == "cuda" and (not hits or launches <= 0):
        raise SystemExit(f"profiled chunk: no nthash_select in {rec}")
    return rec


class NthashShapes:
    """While entered, records the [rows, width], l and hash bound of every
    nthash_select launch on the card through ops/extract (the port's one
    caller of the wrapper), so that the kernel can be held against its
    plain version at the shapes a phase really ran.  The launch count
    stays the wrapper's own."""

    def __init__(self):
        self.seen = set()  # (l, hash_bound, rows, width)

    def __enter__(self):
        from rust_mdbg_tpu_torch.ops import extract

        self._orig = orig = extract.nthash_select

        def recorded(codes, l, hash_bound, *rest):
            if codes.is_cuda:
                self.seen.add((int(l), int(hash_bound), *codes.shape))
            return orig(codes, l, hash_bound, *rest)

        extract.nthash_select = recorded
        return self

    def __exit__(self, *exc):
        from rust_mdbg_tpu_torch.ops import extract

        extract.nthash_select = self._orig


def check_nthash_seen(torch, np, seen) -> dict:
    """check_nthash_at at every (l, hash_bound, rows, width) in `seen`, on
    DEVICE: mismatches by case."""
    cases = {}
    for l, hb in sorted({(l, hb) for l, hb, _, _ in seen}):
        shapes = sorted((B, L) for l2, hb2, B, L in seen
                        if (l2, hb2) == (l, hb))
        got = check_nthash_at(torch, np, hb, shapes, [torch.device(DEVICE)],
                              l=l)
        cases.update({f"{k} bound={hb}": v for k, v in got.items()})
    return cases


def experiments_phase(tmp: str, Params, quality_mbp: int = QUALITY_GENOME_MBP
                      ) -> dict:
    """Phase 17: (a) quality-n50, (b) scaling, (c) scale_demo's parity
    check, (d) recovery_grid, (e) the relay_diag loops, (f) the profiler
    hook; each part's seconds in `seconds`.  Then nthash_select against
    its plain version at every shape the parts launched it at (the
    in-process launches, and the scaling processes' staged shapes):
    `nthash_select_cases`."""
    import numpy as np
    import torch

    from rust_mdbg_tpu_torch.experiments import relay_diag, scaling

    out, seconds = {}, {}
    with NthashShapes() as log:
        for name, fn in (
                ("quality", lambda: quality_phase(tmp, quality_mbp)),
                ("scaling", lambda: scaling_phase(tmp)),
                ("scale_parity", lambda: parity_check_phase(tmp)),
                ("recovery", lambda: recovery_phase(tmp)),
                ("relay_diag", lambda: relay_diag.run(DEVICE)),
                ("profiled_chunk", lambda: profiled_chunk(tmp, Params))):
            t0 = time.perf_counter()
            out[name] = fn()
            seconds[name] = time.perf_counter() - t0
            print(f"experiments {name}: {json.dumps(out[name])}", flush=True)
    seen = set(log.seen)
    if DEVICE == "cuda":
        p = scaling.scaling_params(16)
        seen |= {(p.l, p.hash_bound, B, L) for r in out["scaling"]["rows"]
                 for B, L in r.get("staged_shapes", ())}
        if not seen:
            raise SystemExit("experiments: no nthash_select shape recorded")
    t0 = time.perf_counter()
    cases = check_nthash_seen(torch, np, seen)
    seconds["nthash_select_check"] = time.perf_counter() - t0
    print(f"nthash_select at the experiments' shapes: {json.dumps(cases)}",
          flush=True)
    if sum(cases.values()):
        raise SystemExit(f"nthash_select: {sum(cases.values())} mismatches "
                         "at the experiments' shapes")
    out["nthash_select_cases"] = cases
    out["seconds"] = seconds
    return out


# --- error correction (the EC drivers and their two kernels) ---------------

#: ec-scale's parameters (experiments/ec_scale.py)
EC_KW = dict(k=8, l=10, density=0.02, min_kmer_abundance=2, n=2,
             error_correct=True)

#: genome sizes of the EC main legs (10 kb reads at 30x): the lockstep
#: driver at 1 Mbp (3,000 reads), the sequential driver, whose host DP per
#: candidate is slower, at 0.1 Mbp
EC_GENOME_MBP = 1.0
EC_SEQ_GENOME_MBP = 0.1


def _ec_alphabet(np, rng, n: int):
    """n distinct u64 symbols (as Python ints), some above 2^63."""
    return [int(x) for x in rng.integers(1, 1 << 64, n, dtype=np.uint64)]


def _scores_case(np, torch, seed: int, T: int, lens, n_sym: int):
    """Template and ragged queries (uint64 padded) on the card: a small
    alphabet makes ties everywhere; half the queries copy a stretch of the
    template with substitutions, so real alignments occur."""
    from rust_mdbg_tpu_torch.ops import align, u64

    rng = np.random.default_rng(seed)
    sym = _ec_alphabet(np, rng, n_sym)
    tmpl = [sym[i] for i in rng.integers(0, n_sym, T)]
    queries = []
    for i, n in enumerate(lens):
        if i % 2 and T:
            a = int(rng.integers(0, T))
            q = (tmpl[a:] + tmpl[:a])[:n]
            q += [sym[j] for j in rng.integers(0, n_sym, n - len(q))]
            for j in rng.integers(0, max(1, n), max(1, n // 20)):
                if j < len(q):
                    q[j] = sym[int(rng.integers(0, n_sym))]
        else:
            q = [sym[j] for j in rng.integers(0, n_sym, n)]
        queries.append(q)
    qs, qlens = align.pad_queries(queries)
    return (u64.from_numpy(np.asarray(tmpl, dtype=np.uint64), "cuda"),
            u64.from_numpy(qs, "cuda"),
            torch.from_numpy(qlens.astype(np.int32)).cuda())


def check_semiglobal_scores(torch, np) -> dict:
    """The triage scorer against its plain version at small and edge
    shapes, every score exactly: T = 1, Q = 1, empty queries, queries
    longer than the template, B not a multiple of the block's four warps,
    T = 0, the EC shape (B = 160, T and Q near 300), Q + 1 at each strip
    edge (31, 32, 33, 64, 65, 512 and 513 columns) and queries of 5,000
    (ten register tiles: the tile boundaries in global scratch); the bare
    launch and the counting wrapper both."""
    from rust_mdbg_tpu_torch.ops import align, kernels

    cases = {}
    specs = [(1, 1, [1, 0, 3], 4), (7, 2, [1, 9, 20, 0, 7], 3),
             (3, 40, [1, 40, 100, 0, 2], 6), (4, 300, [300] * 160, 50),
             (5, 260, list(range(1, 321, 2)), 9), (6, 17, [5000, 17, 4], 5),
             (8, 0, [3, 0], 4)]
    specs += [(20 + q, 40, [q, q // 2, 0, 1, q], 5)
              for q in (30, 31, 32, 63, 64, 511, 512)]
    for seed, T, lens, n_sym in specs:
        args = _scores_case(np, torch, seed, T, lens, n_sym)
        launch, got, plan = kernels.semiglobal_scores_launcher(*args)
        launch()
        want = align.semiglobal_scores_plain(*args)
        wrapped = kernels.semiglobal_scores(*args)
        cases[f"T={T} B={len(lens)} Q={max(lens)} alphabet={n_sym} "
              f"strip={plan['strip']} tiles={plan['tiles']}"] = \
            int((got != want).sum()) + int((wrapped != want).sum())
    return dict(name="semiglobal_scores", mismatches=sum(cases.values()),
                cases=cases)


def _grow_poa(np, rng, sym, tlen: int, n_weave: int, p_sub=0.15,
              p_ind=0.08, hub=False):
    """A POA graph grown as tests/test_poa_device.py grows them: a random
    template woven with mutated copies (hub: short queries ending in one
    of three symbols, so a node collects many predecessors)."""
    from rust_mdbg_tpu_torch.models.poa import PoaGraph

    def mut(seq):
        out = []
        for x in seq:
            r = rng.random()
            if r < p_sub:
                out.append(sym[int(rng.integers(len(sym)))])
            elif r < p_sub + p_ind / 2:
                continue
            elif r < p_sub + p_ind:
                out += [x, sym[int(rng.integers(len(sym)))]]
            else:
                out.append(x)
        return out or [sym[0]]

    template = [sym[int(rng.integers(len(sym)))] for _ in range(tlen)]
    g = PoaGraph(template, "A" * (4 * tlen + 8), list(range(0, 4 * tlen, 4)))
    for w in range(n_weave):
        q = mut(template)
        if hub:
            q = [sym[int(rng.integers(len(sym)))] for _ in range(3)] + \
                [sym[w % 3]] + q[-2:]
        g.add_alignment(g.semiglobal(q), q, "C" * (4 * len(q) + 8),
                        list(range(0, 4 * len(q), 4)))
    return g, template, mut


def _dp_mismatches(torch, got, want) -> int:
    return sum(int((a != b).sum()) + abs(a.numel() - b.numel())
               for a, b in zip(got, want))


def _dp_args(batch: dict):
    return [batch[k] for k in ("node_off", "wts", "topo", "pred_off",
                               "pred_idx", "term", "q_off", "queries")]


def check_poa_dp(torch, np) -> dict:
    """The POA DP kernel against its plain version, every output exactly
    (scores, ystart, op counts, op rows): 24 grown graphs in one launch
    (the JAX package's fuzz), a node of in-degree > 8, a graph of more
    than 1,024 nodes with queries of 1,500 (three register tiles), a
    one-node graph, B = 1, m + 1 at each strip edge (31, 32, 33, 64, 65,
    512 and 513 columns), the widest pair beside the smallest, 140 pairs;
    each batch through the counting wrapper, and as bare launches with the
    default ring, with no ring (every read past the previous row from
    global memory) and with a ring of two rows, whose count of
    predecessor reads by route (the kernel's own) shows each route
    (registers, ring, global) taken; and each graph's Alignment against
    the host DP (PoaGraph.semiglobal)."""
    from rust_mdbg_tpu_torch.ops import kernels, poa_device

    rng = np.random.default_rng(3)
    sym = _ec_alphabet(np, rng, 40)
    fuzz, fq = [], []
    for _ in range(24):
        g, t, mut = _grow_poa(np, rng, sym, int(rng.integers(4, 60)),
                              int(rng.integers(0, 6)))
        fuzz.append(g)
        fq.append(mut(t))
    hub, ht, hmut = _grow_poa(np, rng, sym[:12], 12, 40, hub=True)
    big, bt, bmut = _grow_poa(np, rng, sym, 400, 12, p_sub=0.3)
    one, _, _ = _grow_poa(np, rng, sym, 1, 0)
    batches = {
        "fuzz B=24": (fuzz, fq),
        "hub": ([hub, hub], [hmut(ht), ht * 3]),
        "big": ([big, big, big], [bmut(bt), bt, (bt * 4)[:1500]]),
        "one node B=1": ([one], [[one.weights[0]]]),
        "one node, other symbol": ([one], [[sym[5], sym[6]]]),
        "widest beside smallest": ([big, one], [(bt * 4)[:1500], [sym[1]]]),
        "fuzz B=140": ((fuzz * 6)[:140], (fq * 6)[:140]),
    }
    for m in (30, 31, 32, 63, 64, 511, 512):
        g, t, mut = _grow_poa(np, rng, sym, max(4, m), 3)
        batches[f"m={m}"] = ([g, g], [(mut(t) * 3)[:m], (t * 2)[:m]])
    cases, host = {}, 0
    routes = [0, 0, 0]
    shapes = dict(max_nodes=len(big.weights),
                  max_in_degree=max(len(p) for p in hub.pred))
    for name, (gs, qs) in batches.items():
        t = poa_device.batch_to_device(poa_device.export_batch(gs, qs),
                                       "cuda")
        want = poa_device.poa_dp_plain(*_dp_args(t))
        cases[f"{name}, wrapper"] = _dp_mismatches(
            torch, kernels.poa_dp(*_dp_args(t)), want)
        for ring in (None, 0, 2):
            launch, got, plan = kernels.poa_dp_launcher(
                *_dp_args(t), ring_rows=ring, count_routes=True)
            launch()
            cases[f"{name}, ring {plan['ring']}"] = \
                _dp_mismatches(torch, got, want)
            routes = [x + y for x, y in zip(routes, launch.routes.tolist())]
        alns = poa_device.poa_semiglobal_device(gs, qs, device="cuda")
        host += sum((a.score, a.ystart, a.operations) !=
                    (h.score, h.ystart, h.operations)
                    for a, h in zip(alns, (g.semiglobal(q)
                                           for g, q in zip(gs, qs))))
    cases["Alignments against the host DP"] = host
    routes = dict(zip(("registers", "ring", "global"), routes))
    if shapes["max_nodes"] <= 1024 or shapes["max_in_degree"] <= 8 or \
            min(routes.values()) <= 0:
        raise SystemExit(f"poa_dp check: graphs too small or a route "
                         f"not taken {shapes} {routes}")
    return dict(name="poa_dp", mismatches=sum(cases.values()),
                cases=cases, routes=routes, **shapes)


class EcKernelLog:
    """Wraps the two EC kernels' wrappers for one leg: records the shape
    of every launch and keeps the inputs of the widest one (for the
    timing and the check at the leg's own shapes).  The launch counts
    stay the wrappers' own.  Also sums the host seconds of the EC
    driver's stages (each kernel call synchronised: launch and device
    time; the lockstep DP's CSR export and op decoding; the host DP,
    weave, recruitment and consensus) — the breakdown of the
    `error-correct` phase."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.scores = []   # (B, T, Q, sum of query lengths)
        self.dp = []       # (G, nodes list, max in-degree list, m list)
        self.widest = {}
        self.seconds = {}
        self._patched = []

    def _patch(self, owner, attr, key, record=None):
        import torch

        orig = getattr(owner, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            if isinstance(out, tuple) and out and \
                    isinstance(out[0], torch.Tensor) and out[0].is_cuda or \
                    isinstance(out, torch.Tensor) and out.is_cuda:
                torch.cuda.synchronize()
            self.seconds[key] = self.seconds.get(key, 0.0) + \
                time.perf_counter() - t0
            if record is not None:
                record(*a)
            return out

        self._patched.append((owner, attr, orig))
        setattr(owner, attr, timed)
        return timed

    def _record_scores(self, template, queries, qlens, *rest):
        B, Q = queries.shape
        self.scores.append((B, template.shape[0], Q, int(qlens.sum())))
        if B >= self.widest.get("scores_B", -1):
            self.widest.update(scores_B=B, scores=(template, queries, qlens))

    def _record_dp(self, *args):
        node_off, pred_off, q_off = (args[0].cpu(), args[3].cpu(),
                                     args[6].cpu())
        n = (node_off[1:] - node_off[:-1]).tolist()
        m = (q_off[1:] - q_off[:-1]).tolist()
        deg = (pred_off[1:] - pred_off[:-1]).tolist()
        pmax = [max(deg[a:b]) for a, b in zip(node_off[:-1].tolist(),
                                               node_off[1:].tolist())]
        self.dp.append((len(n), n, pmax, m))
        cells = sum(x * y for x, y in zip(n, m))
        if cells >= self.widest.get("dp_cells", -1):
            self.widest.update(dp_cells=cells, dp=args)

    def __enter__(self):
        from rust_mdbg_tpu_torch.models import correct
        from rust_mdbg_tpu_torch.models.poa import PoaGraph
        from rust_mdbg_tpu_torch.ops import poa_device

        k = self.kernels
        # the wrappers' bodies count into the module-level name, which is
        # the recorder while the leg runs: the counts carry over both ways
        for name, rec in (("semiglobal_scores", self._record_scores),
                          ("poa_dp", self._record_dp)):
            orig = getattr(k, name)
            self._patch(k, name, name, rec).launches = orig.launches
        for owner, attr, key in (
                (poa_device, "export_batch", "dp_export"),
                (poa_device, "decode_ops", "dp_decode"),
                (PoaGraph, "semiglobal", "host_dp"),
                (PoaGraph, "add_alignment", "weave"),
                (correct, "_recruit", "recruit"),
                (correct, "_finish", "consensus_finish")):
            self._patch(owner, attr, key)
        return self

    def __exit__(self, *exc):
        k = self.kernels
        for owner, attr, orig in reversed(self._patched):
            if owner is k:
                orig.launches = getattr(k, attr).launches
            setattr(owner, attr, orig)
        self._patched = []

    def summary(self) -> dict:
        import numpy as np

        def dist(xs):
            if not xs:
                return None
            a = np.asarray(xs)
            return dict(min=int(a.min()), p50=float(np.median(a)),
                        p90=float(np.percentile(a, 90)), max=int(a.max()),
                        mean=float(a.mean()))

        return dict(
            scores_launches=len(self.scores),
            scores_B=dist([s[0] for s in self.scores]),
            scores_T=dist([s[1] for s in self.scores]),
            scores_Q=dist([s[2] for s in self.scores]),
            dp_launches=len(self.dp),
            dp_pairs=dist([d[0] for d in self.dp]),
            dp_N=dist([x for d in self.dp for x in d[1]]),
            dp_P=dist([x for d in self.dp for x in d[2]]),
            dp_M=dist([x for d in self.dp for x in d[3]]))


def time_semiglobal_scores(torch, np, args) -> dict:
    """The scorer at the widest launch of the sequential EC leg: bare
    launch = wrapper = plain there, and CUDA-event times of the bare launch (launch_ms: the
    ctypes call alone on outputs allocated once) and of the wrapper
    (wrapper_ms: its checks, host sync, allocation and launch), and its
    bound against launch_ms.  Bytes: the template (8 B a symbol), the
    padded queries (8 B a slot) and lengths (4 B) read once, 4 B a score
    written.  Operations: T x sum(qlen) cells, ~6 32-bit operations a
    cell (two adds, two maxes for the candidates, the keyed subtract and
    the scan's max)."""
    from rust_mdbg_tpu_torch.ops import align, kernels

    template, queries, qlens = args
    launch, got, plan = kernels.semiglobal_scores_launcher(*args)
    launch()
    want = align.semiglobal_scores_plain(*args)
    mism = int((got != want).sum()) + \
        int((kernels.semiglobal_scores(*args) != want).sum())
    launch_ms = cuda_time_ms(launch, 200)
    wrapper_ms = cuda_time_ms(lambda: kernels.semiglobal_scores(*args), 200)
    plain_ms = cuda_time_ms(lambda: align.semiglobal_scores_plain(*args), 3)
    B, Q = queries.shape
    T = template.shape[0]
    cells = T * int(qlens.sum())
    nbytes = 8 * T + 8 * B * Q + 4 * B + 4 * B
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * cells / INT32_OPS_PER_S * 1e3
    return dict(shape=dict(B=B, T=T, Q=Q, cells=cells), plan=plan,
                mismatches=mism,
                max_abs_err=float((got - want).abs().max()) if B else 0.0,
                ms=launch_ms, launch_ms=launch_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
                bound_share=max(t_bytes, t_ops) / launch_ms)


def time_poa_dp(torch, np, args) -> dict:
    """The POA DP at the widest launch of the lockstep EC leg: bare
    launch = wrapper = plain there (the bare launch also counts its
    predecessor reads by route), CUDA-event times of the bare launch (launch_ms: the
    ctypes call alone on outputs and scratch allocated once) and of the
    wrapper (wrapper_ms), the plain version's time (one call: N steps of
    torch ops and a host traceback), and its bound against launch_ms.
    Bytes: the CSR inputs read once (8 B a weight and query symbol, 4 B a
    topo entry, pred offset and pred, 1 B a terminal flag, 4 B offsets),
    the outputs written once (12 B a pair, 12 B an op row).  Operations:
    each cell of each pair, (n x m), takes ~6 32-bit operations a
    predecessor (two loads' adds, two compares, two selects) plus ~8 for
    the scan and the writes."""
    from rust_mdbg_tpu_torch.ops import kernels, poa_device

    counted, got, plan = kernels.poa_dp_launcher(*args, count_routes=True)
    counted()
    want = poa_device.poa_dp_plain(*args)
    mism = _dp_mismatches(torch, got, want) + \
        _dp_mismatches(torch, kernels.poa_dp(*args), want)
    routes = dict(zip(("registers", "ring", "global"),
                      counted.routes.tolist()))
    launch, _, _ = kernels.poa_dp_launcher(*args)
    launch_ms = cuda_time_ms(launch, 50)
    wrapper_ms = cuda_time_ms(lambda: kernels.poa_dp(*args), 50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poa_device.poa_dp_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    node_off, wts, topo, pred_off, pred_idx, term, q_off, queries = \
        (a.cpu() for a in args)
    G = node_off.numel() - 1
    n = (node_off[1:] - node_off[:-1]).long()
    m = (q_off[1:] - q_off[:-1]).long()
    deg = (pred_off[1:] - pred_off[:-1]).long().clamp(min=1)
    gid = torch.repeat_interleave(torch.arange(G), n)
    ops = int(((6 * deg + 8) * m[gid]).sum())
    nbytes = (8 * wts.numel() + 4 * topo.numel() + 4 * pred_off.numel()
              + 4 * pred_idx.numel() + term.numel() + 8 * queries.numel()
              + 8 * (G + 1) + 12 * G + 12 * int((n + m + 1).sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return dict(shape=dict(G=G, cells=int((n * m).sum()),
                           max_n=int(n.max()), max_m=int(m.max())),
                plan=plan, routes=routes,
                mismatches=mism, max_abs_err=float(
                    (got[0] - want[0]).abs().max()) if G else 0.0,
                ms=launch_ms, launch_ms=launch_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
                bound_share=max(t_bytes, t_ops) / launch_ms)


def _noisy_reads(np, path: str, seed: int, n_reads: int, genome_len: int,
                 read_len: int, n_err: int) -> str:
    """tests/test_ec_procs.py's generator: reads at random starts of a
    random genome, n_err random substitutions each."""
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, genome_len))
    with open(path, "w") as f:
        for i in range(n_reads):
            start = int(rng.integers(0, genome_len - read_len))
            read = list(genome[start : start + read_len])
            for _ in range(n_err):
                p = int(rng.integers(0, len(read)))
                read[p] = "ACGT"[int(rng.integers(0, 4))]
            f.write(f">r{i}\n{''.join(read)}\n")
    return path


def _ec_outputs(prefix: str) -> dict:
    """Bytes of an EC run's .ec_data, .postcor.ec_data, .poa.ec_data, .gfa
    and .sequences shards (those that exist)."""
    d, base = os.path.split(prefix)
    out = {}
    for f in sorted(os.listdir(d)):
        ext = f[len(base):]
        if f.startswith(base + ".") and ext in (
                ".ec_data", ".postcor.ec_data", ".poa.ec_data", ".gfa") \
                or f.startswith(base + ".") and f.endswith(".sequences"):
            out[ext] = open(os.path.join(d, f), "rb").read()
    return out


def ec_parity(tmp: str, Params, np) -> dict:
    """EC legs cuda = cpu in .ec_data, .postcor.ec_data, .poa.ec_data,
    .gfa and .sequences bytes, on 80 reads of 5 kb over a 20 kb genome
    (20x, 0.2 % substitutions; ec-scale's k, l, d): the sequential driver
    with triage (the scorer on the card), the lockstep driver (--ec-chunk
    8, the POA DP on the card), --ec-procs 2 (forked workers: the numpy
    scorer and the host DP after the parent's extraction on the card) and
    --restart-from-postcor through the CLI.  Launch counts are set to 0
    just before each cuda run and read just after."""
    from rust_mdbg_tpu_torch import cli
    from rust_mdbg_tpu_torch.core.pipeline import assemble
    from rust_mdbg_tpu_torch.ops import kernels

    reads = _noisy_reads(np, os.path.join(tmp, "ec_parity.fa"), 9, 80,
                         20_000, 5_000, 10)
    legs = {"sequential": {}, "lockstep": dict(ec_device_poa=True,
                                               ec_chunk=8),
            "procs2": dict(ec_procs=2)}
    names = ("nthash_select", "semiglobal_scores", "poa_dp")
    out = {}
    for leg, kw in legs.items():
        p = Params(**EC_KW, **kw)
        res = {}
        for dev in ("cuda", "cpu"):
            prefix = os.path.join(tmp, f"ec_{leg}_{dev}")
            run_on = DEVICE if dev == "cuda" else dev
            for n in names:
                getattr(kernels, n).launches = 0
            t0 = time.perf_counter()
            st = assemble(reads, p, prefix, device=run_on)
            res[dev] = dict(seconds=time.perf_counter() - t0,
                            phases=st["phases"], nodes=st["nb_nodes"],
                            launches={n: getattr(kernels, n).launches
                                      for n in names})
        a, b = (_ec_outputs(os.path.join(tmp, f"ec_{leg}_{d}"))
                for d in ("cuda", "cpu"))
        if a != b or len(a) < 5:
            raise SystemExit(f"EC parity ({leg}): outputs differ between "
                             f"cuda and cpu: {sorted(a)} / {sorted(b)}")
        want = {"sequential": "semiglobal_scores", "lockstep": "poa_dp",
                "procs2": "nthash_select"}[leg]
        if any(res["cpu"]["launches"].values()) or DEVICE == "cuda" and (
                res["cuda"]["launches"][want] <= 0
                or res["cuda"]["launches"]["nthash_select"] <= 0):
            raise SystemExit(f"EC parity ({leg}): launches {res}")
        if leg == "procs2" and res["cuda"]["launches"]["semiglobal_scores"]:
            raise SystemExit("EC parity (procs2): a forked worker launched "
                             "the scorer")
        res["bytes"] = {k: len(v) for k, v in a.items()}
        out[leg] = res
    # --restart-from-postcor through the CLI, from the sequential leg's
    # corrected reads (host only; the default device is never touched)
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        src = os.path.join(tmp, f"ec_sequential_{dev}")
        dst = os.path.join(tmp, f"ec_restart_{dev}")
        shutil.copy(src + ".postcor.ec_data", dst + ".postcor.ec_data")
        if cli.main([reads, "-k", "8", "-l", "10", "-d", "0.02", "-n", "2",
                     "--restart-from-postcor", "--prefix", dst]) != 0:
            raise SystemExit("EC parity (restart): CLI failed")
    a, b = (_ec_outputs(os.path.join(tmp, f"ec_restart_{d}"))
            for d in ("cuda", "cpu"))
    seq = _ec_outputs(os.path.join(tmp, "ec_sequential_cuda"))
    if a != b or a[".gfa"] != seq[".gfa"] or not a[".gfa"]:
        raise SystemExit("EC parity (restart): outputs differ")
    out["restart"] = dict(seconds=time.perf_counter() - t0,
                          bytes={k: len(v) for k, v in a.items()})
    return out


def ec_main(tmp: str, device_poa: bool, genome_mbp: float) -> dict:
    """ec-scale through the CLI on the card (no --device: the default),
    10 kb reads at 30x with 0.3 % substitutions, ec-scale's k=8 l=10
    d=0.02: the lockstep driver (--device-poa, --ec-chunk 64) or the
    sequential driver with triage.  Launch counts are set to 0 just before
    and read just after; every EC kernel's launch is logged
    (EcKernelLog)."""
    from rust_mdbg_tpu_torch import cli
    from rust_mdbg_tpu_torch.ops import kernels

    wd = os.path.join(tmp, "ec_main_" + ("lockstep" if device_poa
                                         else "sequential"))
    out_json = wd + ".json"
    argv = ["ec-scale", "--genome-mbp", str(genome_mbp), "--coverage", "30",
            "--read-len", "10000", "--error-rate", "0.003", "--ec-chunk",
            "64", "--workdir", wd, "--out", out_json]
    if device_poa:
        argv.append("--device-poa")
    if DEVICE != "cuda":
        argv += ["--device", DEVICE]
    names = ("nthash_select", "semiglobal_scores", "poa_dp")
    for n in names:
        getattr(kernels, n).launches = 0
    t0 = time.perf_counter()
    with EcKernelLog(kernels) as log:
        if cli.main(argv) != 0:
            raise SystemExit(f"EC main ({argv}): CLI failed")
    wall = time.perf_counter() - t0
    launches = {n: getattr(kernels, n).launches for n in names}
    rep = json.loads(open(out_json).read())
    fa = os.path.join(wd, f"ec_{genome_mbp:g}mbp.fa")
    with open(fa) as f:
        n_reads = sum(line.startswith(">") for line in f)
    ec_s = rep["phases"].get("error-correct", 0.0)
    need = "poa_dp" if device_poa else "semiglobal_scores"
    if DEVICE == "cuda" and (launches[need] <= 0
                             or launches["nthash_select"] <= 0):
        raise SystemExit(f"EC main: launches {launches}")
    if rep["ec_after_identity"] <= rep["ec_before_identity"] or \
            not rep["nb_nodes"]:
        raise SystemExit(f"EC main: no correction {rep}")
    res = dict(report=rep, reads=n_reads, cli_wall_s=wall,
               error_correct_s=ec_s,
               reingest_s=rep["phases"].get("reingest", 0.0),
               reads_per_s=n_reads / ec_s if ec_s else None,
               launches=launches, shapes=log.summary(),
               stage_seconds=log.seconds)
    res["_widest"] = log.widest
    return res


#: the multihost legs' processes: two on the one card, gloo by the rule
MH_PROCS = 2
MH_TIMEOUT_S = 400


def node_map(prefix: str, with_meta: bool = True) -> dict:
    """minimizer list (the record's text) -> (KC, LN, shift text) of every
    node (with_meta=False: KC alone), from the .gfa and the .sequences
    records.  Only the record's first two fields and its last are read:
    the node sequences, most of the bytes, are never split."""
    import glob

    from rust_mdbg_tpu_torch.io.lz4f import decompress

    meta = {}
    with open(prefix + ".gfa") as f:
        for line in f:
            if line.startswith("S\t"):
                v = line.rstrip().split("\t")
                meta[int(v[1])] = (int(v[4][5:]), int(v[3][5:]))
    out = {}
    for path in sorted(glob.glob(f"{prefix}.*.sequences")):
        with open(path, "rb") as f:
            text = decompress(f.read())
        for line in text.split(b"\n"):
            if not line or line.startswith(b"#"):
                continue
            idx, mins, _ = line.split(b"\t", 2)
            m = meta[int(idx)]
            out[mins] = (m + (line.rsplit(b"\t", 1)[1],) if with_meta
                         else m[0])
    return out


def sharded_parity(tmp: str, Params) -> dict:
    """The parity corpus through `assemble_sharded` at --mesh 4: on the
    card and on the CPU (same .gfa bytes and records), with the gathered
    join (MDBG_SHARDED_EDGES=0, same bytes), its (KC, LN, shift) node map
    against the chunked raw leg's (pg, still on disk), and again at presimp
    0.6, where removals fire, on both devices."""
    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.parallel.pipeline import assemble_sharded

    reads = os.path.join(tmp, "parity.fa")
    out = {}
    for leg, presimp in (("presimp_0.01", 0.01), ("presimp_0.6", 0.6)):
        p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2,
                   presimp=presimp)
        pre = {d: os.path.join(tmp, f"sh_{leg}_{d}")
               for d in ("cuda", "cpu", "gathered")}
        before = kernels.nthash_select.launches
        sg = assemble_sharded(reads, p, pre["cuda"], n_devices=4,
                              device=DEVICE)
        launched = kernels.nthash_select.launches - before
        sc = assemble_sharded(reads, p, pre["cpu"], n_devices=4,
                              device="cpu")
        os.environ["MDBG_SHARDED_EDGES"] = "0"
        try:
            sh = assemble_sharded(reads, p, pre["gathered"], n_devices=4,
                                  device=DEVICE)
        finally:
            del os.environ["MDBG_SHARDED_EDGES"]
        gfa = {d: open(x + ".gfa", "rb").read() for d, x in pre.items()}
        if gfa["cuda"] != gfa["cpu"]:
            raise SystemExit(f"sharded parity ({leg}): .gfa differs between "
                             "cuda and cpu")
        if gfa["cuda"] != gfa["gathered"]:
            raise SystemExit(f"sharded parity ({leg}): the distributed and "
                             "the gathered join wrote different .gfa bytes")
        rec = read_records(pre["cuda"])
        if rec != read_records(pre["cpu"]) \
                or rec != read_records(pre["gathered"]):
            raise SystemExit(f"sharded parity ({leg}): .sequences differ")
        if not sg.get("distributed_edges") or "distributed_edges" in sh:
            raise SystemExit(f"sharded parity ({leg}): wrong join made the "
                             "edges")
        if launched <= 0 or sg["nb_nodes"] <= 0 or sg["nb_edges"] <= 0:
            raise SystemExit(f"sharded parity ({leg}): launches {launched}, "
                             f"graph {sg}")
        if presimp > 0.5 and not sg["presimp_removed"]:
            raise SystemExit("sharded parity: presimp 0.6 removed nothing")
        out[leg] = dict(nodes=sg["nb_nodes"], edges=sg["nb_edges"],
                        presimp_removed=sg["presimp_removed"],
                        cpu_presimp_removed=sc["presimp_removed"],
                        shard_windows=sg["shard_windows"],
                        shard_unique_keys=sg["shard_unique_keys"],
                        staged_shapes=sg["staged_shapes"],
                        phases=sg["phases"], kernel_launches=launched)
    if node_map(os.path.join(tmp, "sh_presimp_0.01_cuda")) \
            != node_map(os.path.join(tmp, "pg")):
        raise SystemExit("sharded parity: the (KC, LN, shift) node map "
                         "differs from the chunked raw leg's")
    out["node_map_equals_chunked"] = True
    return out


def sharded_main(tmp: str, Params, syn: dict, n: int, chunked: dict):
    """main.fa (raw reads, minabund 2) through `assemble_sharded` on the
    card at --mesh n: wall, phases, windows and unique keys a shard (the
    JAX run keeps at most 2^20 of them a shard), peak device memory and
    nthash_select's launches; the (LN, KC) node multiset and the edge
    count must equal the chunked raw leg's."""
    import torch

    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.parallel.pipeline import assemble_sharded

    reads = os.path.join(tmp, "main.fa")
    prefix = os.path.join(tmp, f"sharded{n}")
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2)
    torch.cuda.reset_peak_memory_stats()
    kernels.nthash_select.launches = 0
    zero_construct_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = assemble_sharded(reads, p, prefix, n_devices=n, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.nthash_select.launches
    cl = construct_launches()
    # the sharded step extracts the compact output: compaction only
    require_construct(f"sharded main (mesh {n})", cl, CONSTRUCT_KERNELS[:1])
    if launches <= 0:
        raise SystemExit(f"sharded main (mesh {n}): nthash_select never "
                         "launched")
    sig = gfa_signature(prefix)
    if sig != gfa_signature(os.path.join(tmp, "main")):
        raise SystemExit(
            f"sharded main (mesh {n}): {len(sig[0])} nodes / {sig[1]} edges "
            f"against the chunked leg's {chunked['nodes']} / "
            f"{chunked['edges']}, or another (LN, KC) multiset")
    keys = st["shard_unique_keys"]
    return dict(
        mesh=n, read_gbp=syn["total_bases"] / 1e9, reads=st["nb_reads"],
        nodes=st["nb_nodes"], edges=st["nb_edges"],
        windows=sum(st["shard_windows"]), wall_s=wall,
        read_gbp_per_s=syn["total_bases"] / 1e9 / wall, phases=st["phases"],
        shard_windows=st["shard_windows"], shard_unique_keys=keys,
        shards_over_jax_node_cap=sum(k > (1 << 20) for k in keys),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        staged_shapes=st["staged_shapes"],
        nthash_select_launches=launches, construct_launches=cl,
        same_graph_as_chunked=True)


def multihost_worker(out_json: str, reads: str, prefix: str,
                     batch_reads: int, device: str) -> int:
    """One process of a multihost leg (MDBG_COORD, MDBG_NPROCS and
    MDBG_PROC_ID name the group) on `device` (the parent's DEVICE): its
    stats, wall, peak device memory and nthash_select launches into
    out_json."""
    import torch

    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.parallel.multihost import (assemble_multihost,
                                                        init_distributed)
    from rust_mdbg_tpu_torch.params import Params

    init_distributed()
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2,
               batch_reads=batch_reads)
    torch.cuda.reset_peak_memory_stats()
    kernels.nthash_select.launches = 0
    t0 = time.perf_counter()
    st = assemble_multihost(reads, p, prefix, device=device)
    torch.cuda.synchronize()
    st.update(wall_s=time.perf_counter() - t0,
              peak_mem_bytes=torch.cuda.max_memory_allocated(),
              nthash_select_launches=kernels.nthash_select.launches)
    with open(out_json, "w") as f:
        json.dump(st, f)
    return 0


def run_multihost(tmp: str, reads: str, prefix: str, batch_reads: int,
                  nproc: int = MH_PROCS, card_each: bool = False):
    """nproc processes of this script in worker mode joined over
    127.0.0.1 (card_each: process p sees card p alone); each is killed if
    it outlives MH_TIMEOUT_S.  Returns their stats and the wall time of the
    whole group."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, outs = [], []
    t0 = time.perf_counter()
    for pid in range(nproc):
        outs.append(os.path.join(tmp, f"{os.path.basename(prefix)}.{pid}"
                                 ".json"))
        env = dict(os.environ, MDBG_COORD=f"127.0.0.1:{port}",
                   MDBG_NPROCS=str(nproc), MDBG_PROC_ID=str(pid))
        if card_each:
            env["CUDA_VISIBLE_DEVICES"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-worker",
             outs[-1], reads, prefix, str(batch_reads), DEVICE], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise SystemExit(f"multihost worker failed ({p.returncode}):\n"
                             f"{log[-4000:]}")
    wall = time.perf_counter() - t0
    return [json.load(open(o)) for o in outs], wall


def write_even_corpus(src: str, path: str, n_reads: int) -> str:
    """The first n_reads records of src (reads of one length) renamed to
    names of one width: every record has the same bytes, so p byte-range
    shares hold n_reads / p reads each."""
    from rust_mdbg_tpu_torch.io.fastx import read_records

    with open(path, "wb") as f:
        for i, (_name, seq) in enumerate(read_records(src)):
            if i == n_reads:
                break
            f.write(b">m%07d\n" % i + seq + b"\n")
    return path


def write_interleaved(reads: str, path: str, B_host: int,
                      nproc: int = MH_PROCS) -> str:
    """The multihost global row order as one FASTA: round by round, each
    of nproc processes' block of B_host reads of its byte-range share."""
    from rust_mdbg_tpu_torch.parallel.multihost import fasta_range_records

    size = os.path.getsize(reads)
    step = -(-size // nproc)
    shares = [list(fasta_range_records(reads, p * step,
                                       min(size, (p + 1) * step)))
              for p in range(nproc)]
    with open(path, "wb") as f:
        for r in range(0, max(len(s) for s in shares), B_host):
            for share in shares:
                for name, seq in share[r: r + B_host]:
                    f.write(b">" + name.encode() + b"\n" + seq + b"\n")
    return path


def _mh_summary(stats: list, wall: float) -> dict:
    return dict(
        processes=len(stats), backend=stats[0]["backend"],
        backend_rule=stats[0]["backend_rule"], rounds=stats[0]["rounds"],
        nodes=stats[0]["nb_nodes"], edges=stats[0]["nb_edges"],
        reads=sum(s["nb_reads"] for s in stats), wall_s=wall,
        process_wall_s=[s["wall_s"] for s in stats],
        phases=[s["phases"] for s in stats],
        shard_windows=[w for s in stats for w in s["shard_windows"]],
        shard_unique_keys=[w for s in stats for w in s["shard_unique_keys"]],
        peak_mem_bytes=[s["peak_mem_bytes"] for s in stats],
        staged_shapes=sorted({tuple(x) for s in stats
                              for x in s["staged_shapes"]}),
        nthash_select_launches=sum(s["nthash_select_launches"]
                                   for s in stats))


def multihost_parity(tmp: str, Params) -> dict:
    """Two processes on the card over gloo on 1,500 parity reads with
    names of one width (750 a share, 3 rounds of B_host = 250): the .gfa
    bytes and records of `assemble_sharded` at --mesh 2 on the interleaved
    order."""
    from rust_mdbg_tpu_torch.parallel.pipeline import assemble_sharded

    batch, B_host = 500, 250
    reads = write_even_corpus(os.path.join(tmp, "parity.fa"),
                              os.path.join(tmp, "mh_parity.fa"), 1500)
    prefix = os.path.join(tmp, "mhp")
    stats, wall = run_multihost(tmp, reads, prefix, batch)
    inter = write_interleaved(reads, os.path.join(tmp, "mh_inter.fa"),
                              B_host)
    ref = os.path.join(tmp, "mhp_mesh2")
    rst = assemble_sharded(inter, Params(k=21, l=14, density=0.003,
                                         min_kmer_abundance=2,
                                         batch_reads=batch),
                           ref, n_devices=2, device=DEVICE)
    if stats[0]["backend"] != "gloo" or stats[0]["rounds"] != 3:
        raise SystemExit(f"multihost parity: backend {stats[0]['backend']}"
                         f", {stats[0]['rounds']} rounds")
    if open(prefix + ".gfa", "rb").read() != open(ref + ".gfa", "rb").read():
        raise SystemExit("multihost parity: .gfa differs from --mesh 2 on "
                         "the interleaved order")
    if read_records(prefix) != read_records(ref):
        raise SystemExit("multihost parity: .sequences records differ from "
                         "--mesh 2 on the interleaved order")
    out = _mh_summary(stats, wall)
    if out["nthash_select_launches"] <= 0 or rst["nb_nodes"] <= 0:
        raise SystemExit(f"multihost parity: no launch or empty graph {out}")
    out["gfa_equals_mesh2_interleaved"] = True
    return out


def multihost_main(tmp: str, chunked: dict) -> dict:
    """Two processes on the card over gloo on main.fa (raw reads, minabund
    2): the node set, each node's KC and the edge count equal the chunked
    raw leg's.  A repeat node may record another occurrence (LN, shift):
    the global row order interleaves the two shares."""
    prefix = os.path.join(tmp, "mhm")
    stats, wall = run_multihost(tmp, os.path.join(tmp, "main.fa"), prefix,
                                512)
    out = _mh_summary(stats, wall)
    if out["nthash_select_launches"] <= 0:
        raise SystemExit("multihost main: nthash_select never launched")
    if out["edges"] != chunked["edges"] or out["nodes"] != chunked["nodes"]:
        raise SystemExit(f"multihost main: {out['nodes']} nodes / "
                         f"{out['edges']} edges against the chunked leg's "
                         f"{chunked['nodes']} / {chunked['edges']}")
    t0 = time.perf_counter()
    if node_map(prefix, with_meta=False) \
            != node_map(os.path.join(tmp, "main"), with_meta=False):
        raise SystemExit("multihost main: node set or KC differs from the "
                         "chunked leg's")
    out["node_compare_s"] = time.perf_counter() - t0
    out["same_nodes_kc_edges_as_chunked"] = True
    return out


def four_card_phase(tmp: str, Params, np) -> dict:
    """`--cards 4`: what one card cannot show.  `--mesh 4` with a shard a
    card (rows cross between cards) and four `--multihost` processes of
    one card each (the backend rule picks NCCL): on 1,024 parity reads in
    four equal shares, the .gfa bytes and records of `--mesh 4` on the CPU
    and on the interleaved order; on main.fa, the chunked raw leg's graph
    (node multiset and edges; for the processes node set, KC, edges)."""
    import torch

    from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
    from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.parallel.pipeline import assemble_sharded

    if torch.cuda.device_count() < 4:
        raise SystemExit(f"--cards 4 needs four cards, found "
                         f"{torch.cuda.device_count()}")
    par = os.path.join(tmp, "parity.fa")
    write_synthetic_reads(par, genome_mbp=0.5, coverage=30, read_len=10_000,
                          error_rate=0.003, seed=3)
    even = write_even_corpus(par, os.path.join(tmp, "even4.fa"), 1024)
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2)
    out = {}
    pre = {d: os.path.join(tmp, f"four_{d}") for d in ("cards", "cpu",
                                                        "inter")}
    t0 = time.perf_counter()
    st = assemble_sharded(even, p, pre["cards"], n_devices=4, device=DEVICE)
    out["parity_mesh4_s"] = time.perf_counter() - t0
    shapes = {tuple(x) for x in st["staged_shapes"]}
    assemble_sharded(even, p, pre["cpu"], n_devices=4, device="cpu")
    stats, wall = run_multihost(tmp, even, os.path.join(tmp, "four_mh"),
                                512, nproc=4, card_each=True)
    assemble_sharded(write_interleaved(even, os.path.join(tmp, "i4.fa"),
                                       128, nproc=4),
                     p, pre["inter"], n_devices=4, device="cpu")
    gfa = {d: open(x + ".gfa", "rb").read() for d, x in pre.items()}
    mh = os.path.join(tmp, "four_mh")
    if gfa["cards"] != gfa["cpu"] or read_records(pre["cards"]) \
            != read_records(pre["cpu"]):
        raise SystemExit("four cards: --mesh 4 over the cards differs from "
                         "the CPU")
    if open(mh + ".gfa", "rb").read() != gfa["inter"] \
            or read_records(mh) != read_records(pre["inter"]):
        raise SystemExit("four cards: four processes differ from --mesh 4 "
                         "on the interleaved order")
    if stats[0]["backend"] != "nccl":
        raise SystemExit(f"four cards: backend {stats[0]['backend']}")
    out.update(parity_nodes=st["nb_nodes"], parity_edges=st["nb_edges"],
               parity_devices=sorted({s["device"] for s in stats}),
               parity_multihost=_mh_summary(stats, wall))
    syn = write_main_corpus(tmp, 20)
    main = os.path.join(tmp, "main.fa")
    chunked = assemble_device_chunked(main, p, os.path.join(tmp, "main"),
                                      device=DEVICE)
    torch.cuda.synchronize()
    kernels.nthash_select.launches = 0
    t0 = time.perf_counter()
    st = assemble_sharded(main, p, os.path.join(tmp, "four_sh"),
                          n_devices=4, device=DEVICE)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    if gfa_signature(os.path.join(tmp, "four_sh")) \
            != gfa_signature(os.path.join(tmp, "main")):
        raise SystemExit("four cards: --mesh 4 over the cards changed the "
                         "main graph")
    out["main_mesh4"] = dict(
        wall_s=wall4, phases=st["phases"],
        shard_unique_keys=st["shard_unique_keys"],
        staged_shapes=st["staged_shapes"],
        nthash_select_launches=kernels.nthash_select.launches,
        read_gbp=syn["total_bases"] / 1e9, same_graph_as_chunked=True)
    cases = check_nthash_at(
        torch, np, p.hash_bound,
        sorted(shapes | {tuple(x) for x in st["staged_shapes"]}),
        [torch.device("cuda", d) for d in range(4)])
    out["nthash_select_cases"] = cases
    if sum(cases.values()):
        raise SystemExit(f"four cards: nthash_select disagrees with its "
                         f"plain version: {cases}")
    stats, wall = run_multihost(tmp, main, os.path.join(tmp, "four_mhm"),
                                512, nproc=4, card_each=True)
    m = _mh_summary(stats, wall)
    if m["edges"] != chunked["nb_edges"] \
            or node_map(os.path.join(tmp, "four_mhm"), with_meta=False) \
            != node_map(os.path.join(tmp, "main"), with_meta=False):
        raise SystemExit("four cards: four processes changed the main "
                         "graph's nodes, KC or edges")
    m["same_nodes_kc_edges_as_chunked"] = True
    out["main_multihost"] = m
    return out


# --- the benchmark entry (rust_mdbg_tpu_torch/bench.py) ---------------------

#: nodes, edges, windows and unique keys of bench.py's corpus: the JAX
#: package's output on the same seeded reads (BENCH_r03, r04, r05)
BENCH_COUNTS = dict(nodes=245_869, edges=469_112, windows=1_299_837,
                    uniques=4_408_813)
BENCH_TOTAL_GBP = 1.038
#: the --bf leg's genome: at 52x it gives the full corpus's survival share
BENCH_BF_GENOME_MBP = 5


def bench_leg(tmp: str, leg: str, genome_mbp: int, use_bf: bool) -> dict:
    """The bench's protocol through the module's functions, with a warm-up
    and one timed rep, then the device loop, the link, the packed feed and
    the chunked driver over the same reads: the JSON line, the bench's
    graph against the chunked driver's (gfa_signature), and the launches
    of both kernels over the protocol (counts set to 0 just before)."""
    import torch

    from rust_mdbg_tpu_torch import bench
    from rust_mdbg_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    b = bench.Bench(DEVICE, genome_mbp=genome_mbp,
                    workdir=os.path.join(tmp, f"bench_{leg}"), use_bf=use_bf)
    setup_s = time.perf_counter() - t0
    kernels.nthash_select.launches = 0
    kernels.syncmer_select.launches = 0
    zero_construct_launches()
    t0 = time.perf_counter()
    res = bench.run_protocol(
        b, repeats=1, pipelined=True,
        profile_dir=(os.path.join(tmp, f"bench_{leg}_trace")
                     if DEVICE == "cuda" else None))
    seconds = time.perf_counter() - t0
    launches = kernels.nthash_select.launches
    cl = construct_launches()
    require_construct(f"bench ({leg})", cl, CONSTRUCT_KERNELS)
    line = res["line"]
    print(f"bench ({leg}): {json.dumps(line)}", flush=True)
    if launches <= 0 or kernels.syncmer_select.launches:
        raise SystemExit(f"bench ({leg}): nthash_select launched {launches} "
                         f"times, syncmer_select "
                         f"{kernels.syncmer_select.launches}")
    sig = gfa_signature(b.prefix)
    if sig != gfa_signature(os.path.join(b.workdir, "pipe")):
        raise SystemExit(f"bench ({leg}): the bench's graph differs from "
                         "the chunked driver's on the same reads")
    best, pipe = res["best"], res["pipe_stats"]
    if len(sig[0]) != line["nodes"] or sig[1] != line["edges"] \
            or line["nodes"] <= 0:
        raise SystemExit(f"bench ({leg}): the .gfa holds {len(sig[0])} "
                         f"nodes, {sig[1]} edges against {line}")
    out = dict(line=line, setup_s=setup_s, protocol_s=seconds,
               stages=best["stages"], edge_join=best["edge_join"],
               n_over=best["n_over"],
               n_batches=b.n_batches, w_slot=b.W_slot,
               slot_frac=b.slot_frac, pipe_phases=pipe["phases"],
               pipe_nodes=pipe["nb_nodes"], pipe_edges=pipe["nb_edges"],
               nthash_select_launches=launches, construct_launches=cl)
    prof = res["profile"]
    if prof is not None:
        # every kernel launch of one traced rep, by batch (launches a batch
        # of the construct loop, with the rep's reductions and join)
        out.update(rep_kernel_launches=prof["kernel_launches"],
                   launches_a_batch=prof["kernel_launches"] / b.n_batches,
                   rep_busy_us=prof["busy_us"],
                   rep_kernels=prof["kernels"])
    del b, res
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def bench_phase(tmp: str) -> dict:
    """Phase 18: (a) bench.py's corpus (1.038 Gbp) through the port's
    bench, its counts equal to the JAX package's and its graph to the
    chunked driver's; (b) the --bf mode (MDBG_BF_SLOT_FRAC's slots, 0.5
    unless set) on a 5 Mbp genome at 52x, every read within its slots and
    the graph equal to the chunked driver's with --bf; then nthash_select
    against its plain version at every shape the phase launched it at,
    [128, 24576] among them."""
    import numpy as np
    import torch

    from rust_mdbg_tpu_torch.params import Params

    out = {}
    with NthashShapes() as log:
        for leg, mbp, bf in (("main", 20, False),
                             ("bf", BENCH_BF_GENOME_MBP, True)):
            out[leg] = bench_leg(tmp, leg, mbp, bf)
            print(f"bench {leg}: " + json.dumps(
                {k: v for k, v in out[leg].items() if k != "line"}),
                flush=True)
    line = out["main"]["line"]
    got = {k: line[k] for k in BENCH_COUNTS}
    if got != BENCH_COUNTS or line["total_gbp"] != BENCH_TOTAL_GBP:
        raise SystemExit(f"bench: {got}, {line['total_gbp']} Gbp against "
                         f"{BENCH_COUNTS}, {BENCH_TOTAL_GBP}")
    if out["bf"]["slot_frac"] is None:
        raise SystemExit("bench (bf): the window slots were not scaled")
    seen = set(log.seen)
    hb = Params(k=21, l=14, density=0.003).hash_bound
    if DEVICE == "cuda" and (14, hb, 128, 24576) not in seen:
        raise SystemExit(f"bench: nthash_select never ran at [128, 24576]: "
                         f"{sorted(seen)}")
    cases = check_nthash_seen(torch, np, seen)
    print(f"nthash_select at the bench's shapes: {json.dumps(cases)}",
          flush=True)
    if sum(cases.values()):
        raise SystemExit(f"nthash_select: {sum(cases.values())} mismatches "
                         "at the bench's shapes")
    out["nthash_select_cases"] = cases
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=20,
                    help="genome size of the main-path leg (cut only if "
                         "the time limit forces it)")
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: only the four-card phase (needs four cards)")
    ap.add_argument("--construct-ab", nargs="+", default=None,
                    metavar="TREE",
                    help="only time the construct kernels of each source "
                         "tree (a checkout's root) in the order given, one "
                         "process a tree, on the one card")
    ap.add_argument("--construct-times-of", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--multihost-worker", nargs=5, default=None,
                    metavar=("OUT_JSON", "READS", "PREFIX", "BATCH_READS",
                             "DEVICE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.multihost_worker:
        out_json, reads, prefix, batch, device = args.multihost_worker
        return multihost_worker(out_json, reads, prefix, int(batch), device)

    if args.construct_times_of:
        # that tree's package in place of this one's
        sys.path.insert(0, args.construct_times_of)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import numpy as np

    if args.construct_times_of:
        print(json.dumps(construct_times(torch, np)), flush=True)
        return 0
    if args.construct_ab:
        print(nvidia_smi(), flush=True)
        res = construct_ab(args.construct_ab)
        print(nvidia_smi(), flush=True)
        return 1 if any(r["mismatches"] for r in res) else 0

    from rust_mdbg_tpu_torch.ops import kernels
    from rust_mdbg_tpu_torch.params import Params

    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s", flush=True)
    for name, (sec, log) in logs.items():
        print(f"# nvcc {name} ({sec:.3f} s):\n{log.strip()}", flush=True)
    if args.cards == 4:
        tmp = os.path.join(HERE, ".smoke_tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            four = four_card_phase(tmp, Params, np)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"four cards: {json.dumps(four)}", flush=True)
        print(nvidia_smi(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    hash_bound = Params(k=21, l=14, density=0.003).hash_bound
    rows = [check_nthash_select(torch, np, hash_bound),
            check_syncmer_select(torch, np),
            check_compact_minimizers(torch, np, hash_bound),
            check_window_keys(torch, np)]
    t0 = time.perf_counter()
    ec_checks = [check_semiglobal_scores(torch, np), check_poa_dp(torch, np)]
    for r in rows + ec_checks:
        print(f"kernel check: {json.dumps(r)}", flush=True)
        if r["mismatches"]:
            raise SystemExit(f"{r['name']}: {r['mismatches']} mismatches "
                             "against the plain version")
    print(f"EC kernel checks: {time.perf_counter() - t0:.3f} s", flush=True)

    tmp = os.path.join(HERE, ".smoke_tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        t0 = time.perf_counter()
        par = slice_parity(tmp, Params)
        par["seconds"] = time.perf_counter() - t0
        print(f"slice parity: {json.dumps(par)}", flush=True)
        t0 = time.perf_counter()
        hpar = prehpc_parity(tmp, Params)
        hpar["seconds"] = time.perf_counter() - t0
        print(f"pre-HPC slice parity: {json.dumps(hpar)}", flush=True)

        syn = write_main_corpus(tmp, args.genome_mbp)
        if args.genome_mbp != 20:
            print(f"main path: genome cut to {args.genome_mbp} Mbp "
                  "(20 Mbp is the bench shape)", flush=True)
        mp = main_path(tmp, Params, syn, args.genome_mbp, already_hpc=False)
        print(f"main path: {json.dumps(mp)}", flush=True)
        hp = main_path(tmp, Params, syn, args.genome_mbp, already_hpc=True)
        print(f"pre-HPC main path: {json.dumps(hp)}", flush=True)
        bd = construct_breakdown(tmp, Params)
        print(f"construct breakdown: {json.dumps(bd)}", flush=True)

        t0 = time.perf_counter()
        wpar = whole_run_parity(tmp, Params)
        wpar["seconds"] = time.perf_counter() - t0
        print(f"whole-run parity: {json.dumps(wpar)}", flush=True)
        whole = {}
        for leg, chunked in (("prehpc", (hp, os.path.join(tmp, "main_hpc"))),
                             ("raw17", None), ("prehpc_bf", None)):
            whole[leg] = whole_run_main(tmp, Params, syn, leg, chunked)
            print(f"whole-run main path ({leg}): {json.dumps(whole[leg])}",
                  flush=True)
        fb = finalize_breakdown(tmp, Params)
        print(f"finalize breakdown: {json.dumps(fb)}", flush=True)

        t0 = time.perf_counter()
        spar = scheme_parity(tmp, Params, np)
        spar["seconds"] = time.perf_counter() - t0
        print(f"scheme parity: {json.dumps(spar)}", flush=True)
        t0 = time.perf_counter()
        faults = fault_legs(tmp, Params)
        faults["seconds"] = time.perf_counter() - t0
        print(f"fault legs: {json.dumps(faults)}", flush=True)
        scheme = {}
        for leg in ("syncmers", "uhs_bf", "reference"):
            scheme[leg] = scheme_main(tmp, Params, syn, leg, np)
            print(f"scheme main path ({leg}): {json.dumps(scheme[leg])}",
                  flush=True)
        sb = syncmer_breakdown(tmp, Params)
        print(f"syncmer breakdown: {json.dumps(sb)}", flush=True)

        t0 = time.perf_counter()
        branches = branch_legs(tmp, Params, np)
        branches["seconds"] = time.perf_counter() - t0
        print(f"branch legs: {json.dumps(branches)}", flush=True)
        t0 = time.perf_counter()
        kernels.syncmer_select.launches = 0
        tools = tools_phase(tmp, syn)
        tools["seconds"] = time.perf_counter() - t0
        if kernels.syncmer_select.launches:
            raise SystemExit("tools: syncmer_select launched off its path")
        print(f"tools: {json.dumps(tools)}", flush=True)

        t0 = time.perf_counter()
        exps = experiments_phase(tmp, Params)
        exps["seconds"]["total"] = time.perf_counter() - t0
        print(f"experiments: {json.dumps(exps['seconds'])}", flush=True)
        rows[0]["cases"].update(exps["nthash_select_cases"])

        t0 = time.perf_counter()
        ecp = ec_parity(tmp, Params, np)
        ecp["seconds"] = time.perf_counter() - t0
        print(f"EC parity: {json.dumps(ecp)}", flush=True)
        ec_legs = {}
        for leg, device_poa, mbp in (
                ("sequential", False, EC_SEQ_GENOME_MBP),
                ("lockstep", True, EC_GENOME_MBP)):
            ec_legs[leg] = ec_main(tmp, device_poa, mbp)
            widest = ec_legs[leg].pop("_widest")
            print(f"EC main ({leg}): {json.dumps(ec_legs[leg])}",
                  flush=True)
            if leg == "sequential":
                sg_t = time_semiglobal_scores(torch, np, widest["scores"])
            else:
                dp_t = time_poa_dp(torch, np, widest["dp"])
        for r in (sg_t, dp_t):
            print(f"EC kernel timing: {json.dumps(r)}", flush=True)
            if r["mismatches"]:
                raise SystemExit(f"EC kernel timing: {r['mismatches']} "
                                 "mismatches at the leg's own shapes")

        t0 = time.perf_counter()
        shp = sharded_parity(tmp, Params)
        shp["seconds"] = time.perf_counter() - t0
        print(f"sharded parity: {json.dumps(shp)}", flush=True)
        sharded = {}
        for n in (4, 2):
            sharded[n] = sharded_main(tmp, Params, syn, n, mp)
            print(f"sharded main (mesh {n}): {json.dumps(sharded[n])}",
                  flush=True)
        t0 = time.perf_counter()
        mhp = multihost_parity(tmp, Params)
        mhp["seconds"] = time.perf_counter() - t0
        print(f"multihost parity: {json.dumps(mhp)}", flush=True)
        mhm = multihost_main(tmp, mp)
        print(f"multihost main: {json.dumps(mhm)}", flush=True)
        shapes = sorted({tuple(x) for leg in (
            shp["presimp_0.01"], *sharded.values(), mhp, mhm)
            for x in leg["staged_shapes"]})
        cases = check_nthash_at(torch, np, hash_bound, shapes,
                                [torch.device("cuda")])
        print(f"nthash_select at the sharded legs' shapes: "
              f"{json.dumps(cases)}", flush=True)
        rows[0]["cases"].update(cases)
        rows[0]["mismatches"] += sum(cases.values())
        if rows[0]["mismatches"]:
            raise SystemExit(f"nthash_select: {sum(cases.values())} "
                             "mismatches at the sharded legs' shapes")

        t0 = time.perf_counter()
        bp = bench_phase(tmp)
        print(f"bench phase: {time.perf_counter() - t0:.3f} s", flush=True)
        rows[0]["cases"].update(bp["nthash_select_cases"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rows[0]["launches_by_leg"] = dict(
        raw=mp["nthash_select_launches"], prehpc=hp["nthash_select_launches"],
        **{f"whole_{leg}": w["nthash_select_launches"]
           for leg, w in whole.items()},
        **{f"scheme_{leg}": w["nthash_select_launches"]
           for leg, w in scheme.items()},
        multik=tools["multik"]["nthash_select_launches"],
        **{f"ec_main_{leg}": w["launches"]["nthash_select"]
           for leg, w in ec_legs.items()},
        **{f"sharded_mesh{n}": w["nthash_select_launches"]
           for n, w in sharded.items()},
        multihost_main=mhm["nthash_select_launches"],
        **{f"quality_err{err}": leg["nthash_select_launches"]
           for err, leg in exps["quality"]["legs"].items()},
        **{f"scaling_mesh{r['n']}": r["nthash_select_launches"]
           for r in exps["scaling"]["rows"] if "nthash_select_launches" in r},
        scale_demo_parity=exps["scale_parity"]["nthash_select_launches"],
        recovery=exps["recovery"][DEVICE]["nthash_select_launches"],
        profiled_chunk=exps["profiled_chunk"]["nthash_select_launches"],
        **{f"bench_{leg}": bp[leg]["nthash_select_launches"]
           for leg in ("main", "bf")})
    rows[1]["launches_by_leg"] = {
        f"scheme_{leg}": w["syncmer_select_launches"]
        for leg, w in scheme.items()}
    # the construct body: the chunked, whole-run and bench legs run both
    # kernels, the sharded and streaming legs the compaction alone
    for r in rows[2:4]:
        name = r["name"]
        r["launches_by_leg"] = {
            leg: w["construct_launches"][name] for leg, w in (
                ("raw", mp), ("prehpc", hp),
                *((f"whole_{leg}", w) for leg, w in whole.items()),
                *((f"scheme_{leg}", w) for leg, w in scheme.items()),
                *((f"sharded_mesh{n}", w) for n, w in sharded.items()),
                ("fault_doubled_m_to_width",
                 faults["doubled_m_to_width"]),
                *((f"bench_{leg}", bp[leg]) for leg in ("main", "bf")))}
    for check, timing, name, leg, src, replaces in (
            (ec_checks[0], sg_t, "semiglobal_scores", "sequential",
             "semiglobal_scores.cu",
             "rust_mdbg_tpu/ops/align.py:30 (_make_scores_fn, XLA "
             "lax.scan; no pallas_call)"),
            (ec_checks[1], dp_t, "poa_dp", "lockstep", "poa_dp.cu",
             "rust_mdbg_tpu/ops/poa_device.py:79 (_dp_single, vmapped by "
             "_dp_batched :195, XLA; no pallas_call)")):
        rows.append(dict(
            name=name, route="cuda",
            source=f"rust_mdbg_tpu_torch/csrc/{src}", replaces=replaces,
            launches=0, max_abs_err=timing["max_abs_err"],
            mismatches=check["mismatches"] + timing["mismatches"],
            ms=timing["ms"], launch_ms=timing["launch_ms"],
            wrapper_ms=timing["wrapper_ms"], plain_ms=timing["plain_ms"],
            bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
            bound_share=timing["bound_share"],
            bytes_bound_ms=timing["bytes_bound_ms"],
            ops_bound_ms=timing["ops_bound_ms"], library_ms=None,
            shape=timing["shape"], cases=check["cases"],
            launches_by_leg={
                f"ec_parity_{leg}": ecp[leg]["cuda"]["launches"][name],
                f"ec_main_{leg}": ec_legs[leg]["launches"][name]}))
    for r in rows:
        r["launches"] = sum(r["launches_by_leg"].values())
        if r["launches"] <= 0:
            raise SystemExit(f"{r['name']}: no launch on any main-path leg")
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
