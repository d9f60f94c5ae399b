#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mbp 20]

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (nvidia-smi), and the nvcc build of
   every kernel under rust_mdbg_tpu_torch/csrc/ (one nvcc per source, all
   started together);
2. each kernel against its plain torch version on the card, at the shape
   the main path gives it, with exact (integer) comparison, and timed with
   CUDA events after warm-up;
3. slice parity: a small synthetic corpus through the port on "cuda" and on
   "cpu" — the .gfa must be byte-identical and the .sequences records equal;
4. the main path at users' scale: the bench.py corpus shape (20 Mbp genome,
   20% segmental duplications, 52x of 24,576 bp reads, 0.3% substitutions,
   ~1.04 Gbp) at the reference's HG002 parameters k=21, l=14, d=0.003,
   minabund 2, through `assemble_device_chunked(device="cuda")`.  Kernel
   launch counts are set to 0 just before and read just after; every
   kernel of the path must have launched.

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


def check_nthash_select(torch, np, hash_bound: int) -> dict:
    """The kernel vs its plain version at the main path's batch shape."""
    from rust_mdbg_tpu_torch.ops import kernels

    B, L, l = 512, 24576, 14
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.001] = 4            # some N
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lengths[:4] = [0, 1, l - 1, L]                   # edge rows
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4   # HPC padding
    codes[-1, -7:] = 5
    dev = torch.device("cuda")
    c = torch.from_numpy(codes).to(dev)
    n = torch.from_numpy(lengths).to(dev)

    canon_k, sel_k = kernels.nthash_select(c, l, hash_bound, n)
    canon_p, sel_p = kernels.nthash_select_plain(c, l, hash_bound, n)
    torch.cuda.synchronize()
    bad = (canon_k != canon_p) | (sel_k != sel_p)
    mismatches = int(bad.sum())
    max_abs_err = 0.0
    if mismatches:
        ck = canon_k[bad].cpu().numpy().view(np.uint64).astype(object)
        cp = canon_p[bad].cpu().numpy().view(np.uint64).astype(object)
        max_abs_err = float(max(abs(int(a) - int(b)) for a, b in zip(ck, cp)))
    n_sel = int(sel_k.sum())

    ms = cuda_time_ms(lambda: kernels.nthash_select(c, l, hash_bound, n), 50)
    plain_ms = cuda_time_ms(
        lambda: kernels.nthash_select_plain(c, l, hash_bound, n), 5)
    # least time: each input read once (codes 1 B + lengths 4 B/row), each
    # output written once (canon 8 B + sel 1 B); or the operations: per
    # position and window term, two 64-bit rotates (2 funnel shifts each)
    # and two 64-bit XORs (2 lane ops each), all as 32-bit lane ops
    nbytes = B * L * (1 + 8 + 1) + B * 4
    nops = B * L * l * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return dict(
        name="nthash_select", route="cuda",
        source="rust_mdbg_tpu_torch/csrc/nthash_select.cu",
        replaces="rust_mdbg_tpu/ops/pallas_kernels.py:103",
        launches=0, max_abs_err=max_abs_err, mismatches=mismatches,
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, shape=[B, L], l=l, selected=n_sel)


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


def main_path(tmp: str, Params, genome_mbp: float) -> dict:
    import torch

    from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
    from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
    from rust_mdbg_tpu_torch.ops import kernels

    reads = os.path.join(tmp, "main.fa")
    t0 = time.perf_counter()
    syn = write_synthetic_reads(reads, genome_mbp=genome_mbp, coverage=52,
                                read_len=24_576, error_rate=0.003, seed=0,
                                repeat_frac=0.2)
    t_write = time.perf_counter() - t0
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=2)
    prefix = os.path.join(tmp, "main")
    torch.cuda.reset_peak_memory_stats()
    kernels.nthash_select.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = assemble_device_chunked(reads, p, prefix, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.nthash_select.launches
    if launches <= 0:
        raise SystemExit("main path: nthash_select never launched")
    n_s = n_l = 0
    with open(prefix + ".gfa") as f:
        for line in f:
            n_s += line.startswith("S\t")
            n_l += line.startswith("L\t")
    n_rec = len(read_records(prefix))
    if not (n_s == st["nb_nodes"] == n_rec and n_l == st["nb_edges"]
            and n_s > 0 and n_l > 0):
        raise SystemExit(f"main path: inconsistent outputs S={n_s} "
                         f"L={n_l} records={n_rec} stats={st}")
    return dict(
        genome_mbp=genome_mbp, read_gbp=syn["total_bases"] / 1e9,
        reads=st["nb_reads"], nodes=st["nb_nodes"], edges=st["nb_edges"],
        windows=st["nb_windows"], chunks=st["nb_chunks"],
        wall_s=wall, read_gbp_per_s=syn["total_bases"] / 1e9 / wall,
        fasta_write_s=t_write, phases=st["phases"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        nthash_select_launches=launches)


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

        mp = main_path(tmp, Params, args.genome_mbp)
        if args.genome_mbp != 20:
            print(f"main path: genome cut to {args.genome_mbp} Mbp "
                  "(20 Mbp is the bench shape)", flush=True)
        print(f"main path: {json.dumps(mp)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rows[0]["launches"] = mp["nthash_select_launches"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
