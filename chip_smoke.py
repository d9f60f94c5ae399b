#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mbp 20]

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (nvidia-smi), and the nvcc build of
   every kernel under rust_mdbg_tpu_torch/csrc/ (one nvcc per source, all
   started together);
2. each kernel against its plain torch version on the card, with exact
   (integer) comparison: at the shape the main path gives it, timed with
   CUDA events after warm-up, and at small ragged shapes (l from 1 to 64,
   odd L, an unaligned row slice, edge rows, N and code 5 in the tile
   halos);
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
   the whole pre-HPC'd main corpus, device time by torch op.

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
    slice at an unaligned offset."""
    from rust_mdbg_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    cases = {}
    small = [((24, 12291), l, 0) for l in (1, 13, 14, 31, 32, 64)]
    small += [((25, 12291), 14, 3), ((25, 4099), 64, 3), ((9, 37), 14, 0),
              ((9, 37), 64, 0), ((16, 5008), 31, 0)]
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
    """main.fa, read by both main-path legs and the construct breakdown."""
    from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads

    t0 = time.perf_counter()
    syn = write_synthetic_reads(os.path.join(tmp, "main.fa"),
                                genome_mbp=genome_mbp, coverage=52,
                                read_len=24_576, error_rate=0.003, seed=0,
                                repeat_frac=0.2)
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
        if sg["nb_nodes"] <= 0 or sg["nb_edges"] <= 0 or sg["n_over"]:
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
            and (n_rec > 0 or leg == "raw17")) or st["n_over"]:
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
        phase1_emit_s=st.get("phase1_emit_s"), n_over=st["n_over"],
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
    rows = [check_nthash_select(torch, np, hash_bound)]
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rows[0]["launches_by_leg"] = dict(
        raw=mp["nthash_select_launches"], prehpc=hp["nthash_select_launches"],
        **{f"whole_{leg}": w["nthash_select_launches"]
           for leg, w in whole.items()})
    rows[0]["launches"] = sum(rows[0]["launches_by_leg"].values())
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
