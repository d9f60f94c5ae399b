#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mbp 20]

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (nvidia-smi), and the nvcc build of
   every kernel under rust_mdbg_tpu_torch/csrc/ (one nvcc per source, all
   started together);
2. each kernel against its plain torch version on the card, with exact
   (integer) comparison: at the shape the main path gives it, timed with
   CUDA events after warm-up, and at small ragged shapes (nthash_select: l
   from 1 to 64, odd L, an unaligned row slice, edge rows, N and code 5 in
   the tile halos; syncmer_select: s = 0, l = 32, w = 1, odd L, B = 1, L
   below w, an unaligned row slice, and rows of one base, short repeats
   and two-letter noise where the incumbent walk's fix-up runs long);
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
   read just after; every kernel of the path must have launched in each;
5. the construct breakdown: torch.profiler over one chunk of that corpus
   (construct_batches + finalize_chunk, after a warm-up), device time by
   kernel name, and the device's busy time over the profiled window and
   over the same chunk's unprofiled wall time;
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
    density and syncmers);
12. the syncmer breakdown: torch.profiler over one [512, 24576] batch of
    the count-path extraction under --syncmers, device time by torch op
    and the fused kernel's share.

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
    lengths[:4] = [0, 1, min(max(0, l - 1), L), L]
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
    small = [((24, 12291), l, 0) for l in (1, 13, 14, 31, 32, 64)]
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
    os.environ["MDBG_CHUNK_DEVICE_JOIN"] = "0"
    try:
        sh = assemble_device_chunked(reads, p, os.path.join(tmp, "hh"),
                                     device="cuda")
    finally:
        del os.environ["MDBG_CHUNK_DEVICE_JOIN"]
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = assemble_device_chunked(reads, p, prefix, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.nthash_select.launches
    if launches <= 0:
        raise SystemExit(f"main path (already_hpc={already_hpc}): "
                         "nthash_select never launched")
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
        nthash_select_launches=launches)
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


def construct_breakdown(tmp: str, Params) -> dict:
    """Device time by kernel over one chunk of the main-path corpus:
    construct_batches + finalize_chunk under torch.profiler, after a
    warm-up run of the same chunk.  Planned, staged and run through the
    driver's own steps (plan_chunks, host_feed, to_device, new_counter,
    construct_chunk), outside assemble_device_chunked.

    The busy share is given twice: over the profiled window, which tracing
    the host's ~7,000 op launches stretches, so it reads low; and over the
    median unprofiled wall time of the same chunk."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rust_mdbg_tpu_torch.core.chunked import (construct_chunk,
                                                  host_feed, new_counter,
                                                  plan_chunks, to_device)
    from rust_mdbg_tpu_torch.io.fastx_native import NativeReader

    reads = os.path.join(tmp, "main.fa")
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2)
    plan = plan_chunks(reads, p)
    rdr = NativeReader(reads, plan["chunk_reads"], plan["L"],
                       mean_len_hint=plan["mean_len"])
    try:
        c = rdr.next_chunk()
    finally:
        rdr.close()
    codes, lens, fill = c.codes, c.lengths, c.n
    dev = torch.device("cuda")
    host = host_feed(codes, lens, fill, plan)
    fed_width = host[0].shape[1] * (4 if plan["packed"] else 1)
    staged, lens_d = to_device(host, lens, dev)
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
    return dict(
        reads=int(fill), batches=min(plan["n_batches"], (fill + B - 1) // B),
        width=int(codes.shape[1]), fed_width=int(fed_width),
        window_us=wall_us, unprofiled_us=unprofiled_us,
        device_events=len(spans),
        device_us=sum(t for t, _ in by_name.values()), busy_us=busy,
        busy_share=busy / wall_us if spans else None,
        busy_share_unprofiled=busy / unprofiled_us if spans else None,
        nthash_select_us=sum(t for k, (t, _) in by_name.items()
                             if "nthash_select" in k),
        top=[dict(name=_short(k), us=t, calls=c) for k, (t, c) in top],
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
    if launches <= 0:
        raise SystemExit(f"whole-run main path ({leg}): nthash_select never "
                         "launched")
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
        nthash_select_launches=launches, phase1_fired=st["phase1_nodes"] > 0,
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
    driver's own steps (plan_table, new_table_counter,
    construct_table_chunk), then the reduction runs once to warm up, three
    times unprofiled (median wall) and three times under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rust_mdbg_tpu_torch.core.fastx_feed import stream_chunks
    from rust_mdbg_tpu_torch.core.pipeline import (construct_table_chunk,
                                                   new_table_counter,
                                                   plan_table)

    reads = os.path.join(tmp, "main.fa")
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2,
               reads_already_hpc=True, max_read_len=24_576)
    plan = plan_table(reads, p)
    counter = new_table_counter(p, plan, torch.device(DEVICE))
    read_base = 0
    for codes, lens, _blob, _off, fill in stream_chunks(
            reads, plan["chunk_reads"], plan["B"], plan["L"],
            plan["mean_len"]):
        if fill:
            construct_table_chunk(p, plan, counter, codes, lens, fill,
                                  read_base)
            read_base += plan["chunk_reads"]
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
    minabund 17 (the streaming engine on the card), density and syncmers."""
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
             1)]
    out = {}
    for leg, reads, extra, budget in legs:
        t0 = time.perf_counter()
        p = Params(**{**kw, **extra})
        before = (kernels.nthash_select.launches,
                  kernels.syncmer_select.launches)
        sg = assemble(reads, p, os.path.join(tmp, f"{leg}_g"), device=DEVICE,
                      mem_budget=budget)
        launched = (kernels.nthash_select.launches - before[0],
                    kernels.syncmer_select.launches - before[1])
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
        out[leg] = dict(nodes=sg["nb_nodes"], edges=sg["nb_edges"],
                        reads=sg["nb_reads"], replans=sg.get("replans"),
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = pipeline.assemble(reads, p, prefix, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(nthash_select=kernels.nthash_select.launches,
                    syncmer_select=kernels.syncmer_select.launches)
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
        replans=st.get("replans"))
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
    kernel's share, and the busy share of the unprofiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rust_mdbg_tpu_torch.core.chunked import (host_feed, plan_chunks,
                                                  to_device)
    from rust_mdbg_tpu_torch.io.fastx_native import NativeReader
    from rust_mdbg_tpu_torch.ops.extract import extract_count
    from rust_mdbg_tpu_torch.ops.pack import unpack_codes

    reads = os.path.join(tmp, "main.fa")
    p = Params(k=21, l=14, min_kmer_abundance=2, **SYNC_KW)
    plan = plan_chunks(reads, p)
    rdr = NativeReader(reads, plan["chunk_reads"], plan["L"],
                       mean_len_hint=plan["mean_len"])
    try:
        c = rdr.next_chunk()
    finally:
        rdr.close()
    dev = torch.device("cuda")
    staged, lens_d = to_device(host_feed(c.codes, c.lengths, c.n, plan),
                               c.lengths, dev)
    B = plan["B"]

    def batch():
        codes = (unpack_codes(staged[0][:B], staged[1][:B])
                 if plan["packed"] else staged[0][:B])
        return extract_count(codes, lens_d[:B], l=p.l, k=p.k,
                             hash_bound=p.hash_bound, M=plan["M"],
                             syncmer=(p.s, p.syncmer_hash_bound))

    out = batch()
    n_min = float((out["nw"].float().mean() + p.k - 1))
    width = int(staged[0].shape[1] * (4 if plan["packed"] else 1))
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
        busy_share_unprofiled=busy / unprofiled_us if spans else None,
        syncmer_select_us=kernel_us,
        syncmer_select_share=kernel_us / busy if busy else None,
        top_ops=[dict(op=k, us=t, calls=c) for k, t, c in ops[:12]])


def _short(kernel: str) -> str:
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::cuda::detail::"):
        kernel = kernel.replace(junk, "")
    return kernel[:120]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=20,
                    help="genome size of the main-path leg (cut only if "
                         "the time limit forces it)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import numpy as np

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

    hash_bound = Params(k=21, l=14, density=0.003).hash_bound
    rows = [check_nthash_select(torch, np, hash_bound),
            check_syncmer_select(torch, np)]
    for r in rows:
        print(f"kernel check: {json.dumps(r)}", flush=True)
        if r["mismatches"]:
            raise SystemExit(f"{r['name']}: {r['mismatches']} mismatches "
                             "against the plain version")

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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rows[0]["launches_by_leg"] = dict(
        raw=mp["nthash_select_launches"], prehpc=hp["nthash_select_launches"],
        **{f"whole_{leg}": w["nthash_select_launches"]
           for leg, w in whole.items()},
        **{f"scheme_{leg}": w["nthash_select_launches"]
           for leg, w in scheme.items()})
    rows[1]["launches_by_leg"] = {
        f"scheme_{leg}": w["syncmer_select_launches"]
        for leg, w in scheme.items()}
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
