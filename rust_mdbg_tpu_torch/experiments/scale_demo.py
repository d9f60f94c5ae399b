"""HG002-representative bounded-memory construction demo.

Counterpart of the JAX package's `experiments/scale_demo.py`.  Synthesizes
an HG002-like workload -- 52x HiFi-length reads with per-base substitution
errors over a 20%-segmental-duplication genome (the reference's headline
run is 114 Gbp over a 2.2 Gbp HPC genome in <=10.1 GB RAM, rust-mdbg
README.md:128) -- writes it as plain FASTA, then drives the chunked
hierarchical counting path (core/chunked.py) through the port's CLI at
--minabund 3 on `--device` (the card unless named) and reports wall time,
throughput and maximum RSS.  The card holds one chunk, host RAM holds the
node table and one chunk of raw bytes whatever the input size, and the
crossing capture is exact for any minabund.  A smaller parity leg re-runs
chunked against the whole-run device finalize and asserts byte-identical
GFA.

The record names the card (nvidia-smi's name and power limit) and carries
`h2d_gb`, the bytes the run copied to the device; the JAX record's relay
fields describe a TPU development relay that retains its H2D staging, and
`experiments/relay_diag.py` measures whether the card's copies do.

Usage:  python -m rust_mdbg_tpu_torch.experiments.scale_demo [--gbp 20.8]
            [--device cpu] [--dir D] [--out scale_demo_torch.json]
By default the FASTA and the outputs go to a directory under the system's
temporary directory, and the record to scale_demo_torch.json in the
current directory; only the files the run made are removed afterwards.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..utils.seq import CODE_BASE

READ_LEN = 24576


def synth_genome(rng, genome_bp: int, repeat_frac: float) -> np.ndarray:
    """Random genome whose last repeat_frac is copies of 10-100 kb segments
    of the unique part (multi-locus k-min-mers, like bench.py)."""
    core = rng.integers(0, 4, int(genome_bp * (1 - repeat_frac))) \
        .astype(np.uint8)
    parts = [core]
    rem = genome_bp - core.size
    while rem > 0:
        seg = int(min(rem, rng.integers(10_000, 100_000)))
        src = int(rng.integers(0, core.size - seg))
        parts.append(core[src : src + seg])
        rem -= seg
    return np.concatenate(parts)


def synth_fasta(path: str, genome_bp: int, coverage: int, seed: int = 0,
                read_len: int = READ_LEN, err: float = 0.0,
                repeat_frac: float = 0.0) -> int:
    """Write ~genome_bp*coverage bases of reads (err = substitution rate,
    one error per read_len*err segment); returns bases.  The bytes are the
    JAX function's for the same arguments."""
    rng = np.random.default_rng(seed)
    genome = synth_genome(rng, genome_bp, repeat_frac)
    n_reads = (genome_bp * coverage) // read_len
    starts = rng.integers(0, genome_bp - read_len, n_reads)
    E = max(0, int(round(err * read_len)))
    seg = read_len // E if E else 0
    t0 = time.perf_counter()
    with open(path, "wb", buffering=1 << 22) as f:
        for i, s in enumerate(starts):
            r = genome[s : s + read_len]
            if E:
                r = r.copy()
                pos = (np.arange(E) * seg
                       + rng.integers(0, seg, E)).astype(np.int64)
                r[pos] = (r[pos] + rng.integers(1, 4, E)) % 4
            f.write(b">r%d\n" % i)
            f.write(CODE_BASE[r].tobytes())
            f.write(b"\n")
    dt = time.perf_counter() - t0
    total = n_reads * read_len
    print(f"synth: {total/1e9:.2f} Gbp (err={err}, repeats={repeat_frac}) "
          f"in {dt:.0f}s -> {path}", flush=True)
    return total


def parity_check(workdir: str, err: float, minab: int, device=None,
                 genome_bp: int = 10_000_000, coverage: int = 52,
                 chunk_reads: int = 4096) -> dict:
    """Chunked vs whole-run device finalize at --minabund `minab` on a
    slice of the same corpus model (by default 10 Mbp x 52, ~0.52 Gbp, as
    in the JAX package), both on `device`: byte-identical GFA over at
    least four chunks."""
    from ..core.chunked import assemble_device_chunked, resolve_device
    from ..core.pipeline import assemble_device_table
    from ..params import Params
    from ..utils.timing import PhaseTimer

    dev = resolve_device(device)
    reads = os.path.join(workdir, "parity.fa")
    total = synth_fasta(reads, genome_bp=genome_bp, coverage=coverage,
                        seed=3, err=err, repeat_frac=0.2)
    p = Params(k=21, l=14, density=0.003, min_kmer_abundance=minab,
               engine="device", reads_already_hpc=True, batch_reads=128)
    pa = os.path.join(workdir, "whole")
    pb = os.path.join(workdir, "chunk")
    assemble_device_table(reads, p, pa, PhaseTimer(), {}, device=dev)
    s = assemble_device_chunked(reads, p, pb, chunk_reads=chunk_reads,
                                device=dev)
    with open(pa + ".gfa", "rb") as f:
        ga = f.read()
    with open(pb + ".gfa", "rb") as f:
        gb = f.read()
    if s["nb_chunks"] < 4:
        raise RuntimeError(f"parity: {s['nb_chunks']} chunks, not >= 4")
    if ga != gb:
        raise RuntimeError("chunked GFA diverged from the whole-run "
                           "finalize")
    return {"parity_gbp": round(total / 1e9, 2), "parity_minabund": minab,
            "parity_chunks": s["nb_chunks"],
            "parity": "byte-identical GFA (chunked == whole-run device)"}


def main(argv=None) -> int:
    from ..core.chunked import resolve_device
    from ..utils.timing import card_info

    ap = argparse.ArgumentParser(prog="scale_demo")
    ap.add_argument("--gbp", type=float, default=20.8,
                    help="total read gigabases to synthesize")
    ap.add_argument("--err", type=float, default=0.002,
                    help="per-base substitution error rate")
    ap.add_argument("--repeats", type=float, default=0.2)
    ap.add_argument("--minabund", type=int, default=3)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "mdbg_scale_torch"))
    ap.add_argument("--keep", action="store_true",
                    help="keep the FASTA + outputs afterwards")
    ap.add_argument("--chunk-reads", type=int, default=0,
                    help="force a chunk size (0 = pipeline auto-detect)")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--out", default="scale_demo_torch.json",
                    help="record filename")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain torch versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    os.makedirs(args.dir, exist_ok=True)
    before = set(os.listdir(args.dir))
    coverage = 52
    genome_bp = int(args.gbp * 1e9 / coverage)
    reads = os.path.join(args.dir, "reads.fa")
    n_reads = (genome_bp * coverage) // READ_LEN
    expect = n_reads * (READ_LEN + len(b">r%d\n\n" % n_reads) + 4)
    if os.path.exists(reads) and abs(os.path.getsize(reads)
                                     - expect) < expect * 0.02:
        total = n_reads * READ_LEN
        print(f"reusing existing {reads} ({total/1e9:.2f} Gbp)", flush=True)
    else:
        total = synth_fasta(reads, genome_bp, coverage, err=args.err,
                            repeat_frac=args.repeats)

    prefix = os.path.join(args.dir, "asm")
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "rust_mdbg_tpu_torch", reads,
           "-k", "21", "-l", "14", "--density", "0.003",
           "--minabund", str(args.minabund),
           "--engine", "device", "--skiphpc", "--prefix", prefix]
    if args.chunk_reads:
        cmd += ["--chunk-reads", str(args.chunk_reads)]
    if args.device is not None:
        cmd += ["--device", args.device]
    env = dict(os.environ,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(cmd, env=env, cwd=args.dir,
                          capture_output=True, text=True)
    wall = time.perf_counter() - t0
    sys.stdout.write(proc.stdout[-4000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        return proc.returncode
    child_rss_gb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1e6

    n_nodes = n_edges = -1
    h2d_bytes = 0
    phases = None
    for line in proc.stdout.splitlines():
        if "mdBG nodes" in line:
            n_nodes = int(line.split()[-1])
        if "mdBG edges" in line:
            n_edges = int(line.split()[-1])
        if line.startswith("H2D bytes:"):
            h2d_bytes = int(line.split()[-1])
        if line.startswith("PHASES "):
            phases = line[7:]
    rec = {
        "demo": f"chunked_{args.gbp:g}gbp",
        "device": str(dev),
        "card": card_info(dev),
        "err_rate": args.err,
        "repeat_frac": args.repeats,
        "minabund": args.minabund,
        "total_gbp": round(total / 1e9, 2),
        "wall_s": round(wall, 1),
        "gbp_per_s": round(total / 1e9 / wall, 4),
        "max_rss_gb": round(child_rss_gb, 2),
        "h2d_gb": round(h2d_bytes / 1e9, 2),
        "nodes": n_nodes,
        "edges": n_edges,
        "phases": phases,
    }
    if not args.skip_parity:
        rec.update(parity_check(args.dir, args.err, args.minabund,
                                device=dev))
    print(json.dumps(rec), flush=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    if not args.keep:
        for fn in set(os.listdir(args.dir)) - before:
            os.unlink(os.path.join(args.dir, fn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
