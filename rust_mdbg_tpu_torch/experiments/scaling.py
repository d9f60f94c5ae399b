"""Multi-device scaling measurement -> a Markdown table.

Counterpart of the JAX package's `experiments/scaling.py`.  Runs the full
sharded assembly (extraction -> all_to_all key routing -> per-shard
accumulation -> sharded finalize -> GFA; parallel/pipeline.assemble_sharded)
over meshes of 1/2/4/8 shards on a fixed synthetic read set, plus the
two-process `--multihost` flow over torch.distributed (gloo, wired by
MDBG_COORD / MDBG_NPROCS / MDBG_PROC_ID; parallel/multihost.py), and
writes a scaling table.

Every shard runs on `--device` (the card unless named; on one card all
shards of a mesh live on it, and the two processes share it).  So the
table shows that per-shard work and the all_to_all partition cleanly --
node and edge counts identical across mesh sizes and processes -- and
records the wall times of each row, with the device they were taken on.

Run: python -m rust_mdbg_tpu_torch.experiments.scaling [--device cpu]
         [--out scaling_torch.md]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

GENOME_BP = 400_000
COVERAGE = 12
READ_LEN = 4_000

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synth(path: str, seed: int = 5, genome_bp: int = GENOME_BP,
          coverage: int = COVERAGE, read_len: int = READ_LEN) -> int:
    """Error-free reads of a random genome; the JAX function's bytes for
    the same sizes and seed.  Returns the read bases."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACTG", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, genome_bp)]
    n_reads = genome_bp * coverage // read_len
    with open(path, "wb") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, genome_bp - read_len))
            f.write(b">r%d\n" % i)
            f.write(genome[s : s + read_len].tobytes())
            f.write(b"\n")
    return n_reads * read_len


def scaling_params(batch_reads: int):
    from ..params import Params

    return Params(k=12, l=12, density=0.003, min_kmer_abundance=2,
                  engine="device", batch_reads=batch_reads)


def run_mesh(reads: str, n: int, device=None) -> dict:
    """Two assemble_sharded runs over n shards on `device`: the first
    (cold: it builds the kernels on a card) and the second (warm)."""
    from ..parallel.pipeline import assemble_sharded

    p = scaling_params(8 * n)
    t0 = time.perf_counter()
    stats = assemble_sharded(reads, p, reads + f".mesh{n}", n_devices=n,
                             device=device)
    t1 = time.perf_counter()
    assemble_sharded(reads, p, reads + f".mesh{n}", n_devices=n,
                     device=device)
    t2 = time.perf_counter()
    return dict(n=n, wall_s=round(t2 - t1, 2), wall_cold_s=round(t1 - t0, 2),
                nodes=stats["nb_nodes"], edges=stats["nb_edges"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_worker(reads: str, device: str) -> int:
    """One process of run_multihost: joins the group the MDBG_* variables
    name, assembles twice (cold, warm) and prints its walls, graph and the
    [rows, width] its extraction steps ran at."""
    from ..parallel.multihost import (assemble_multihost, close_distributed,
                                      init_distributed)

    init_distributed()
    p = scaling_params(16)
    dev = None if device == "cuda" else device
    t0 = time.perf_counter()
    assemble_multihost(reads, p, reads + ".mh", device=dev)
    t1 = time.perf_counter()
    stats = assemble_multihost(reads, p, reads + ".mh", device=dev)
    t2 = time.perf_counter()
    close_distributed()
    print("WALLS", round(t1 - t0, 2), round(t2 - t1, 2))
    print("NODES", stats.get("nb_nodes"), "EDGES", stats.get("nb_edges"))
    print("SHAPES", json.dumps(stats["staged_shapes"]))
    return 0


def run_multihost(reads: str, device=None, timeout: float = 1800) -> dict:
    """Two processes over torch.distributed (gloo), each assembling twice
    in the same process: the second run is the warm wall, comparable to
    the mesh rows'.  `staged_shapes` holds every [rows, width] the
    processes' extraction steps ran at.  Raises when a process fails."""
    procs = []
    coord = f"127.0.0.1:{_free_port()}"
    for pid in range(2):
        env = dict(os.environ, MDBG_COORD=coord, MDBG_NPROCS="2",
                   MDBG_PROC_ID=str(pid),
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rust_mdbg_tpu_torch.experiments.scaling",
             "--worker", reads, str(device or "cuda")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"multihost process failed:\n{out[-1500:]}")
    nodes = edges = -1
    cold = warm = None
    shapes = set()
    for out in outs:
        for line in out.splitlines():
            if line.startswith("NODES") and "None" not in line:
                nodes, edges = int(line.split()[1]), int(line.split()[3])
            if line.startswith("WALLS"):
                cold, warm = float(line.split()[1]), float(line.split()[2])
            if line.startswith("SHAPES"):
                shapes |= {tuple(x) for x in json.loads(line[len("SHAPES"):])}
    return dict(n="2 processes", wall_s=warm, wall_cold_s=cold,
                nodes=nodes, edges=edges,
                staged_shapes=[list(x) for x in sorted(shapes)])


def table(rows: list, total: int, device: str, card: str | None) -> str:
    """The Markdown table of the rows, with the device they ran on."""
    base = rows[0]["wall_s"]
    lines = [
        "# Multi-device scaling (rust_mdbg_tpu_torch)",
        "",
        f"Full sharded assembly (`assemble_sharded` / `--mesh N`) of a fixed "
        f"{total/1e6:.1f} Mbp synthetic read set (k=12, l=12, d=0.003) on "
        f"{device}" + (f" ({card})" if card else "") + ", every shard of a "
        "mesh on that device.  Warm wall excludes the kernels' build.  "
        "Node/edge counts must be identical across rows (exactness under "
        "sharding); the speedup column compares shards that share one "
        "device, not devices.",
        "",
        "| mesh | warm wall (s) | cold wall (s) | speedup | nodes | edges |",
        "|------|---------------|---------------|---------|-------|-------|",
    ]
    for r in rows:
        sp = f"{base / r['wall_s']:.2f}x" if r["wall_s"] else "-"
        lines.append(
            f"| {r['n']} | {r['wall_s']} | {r['wall_cold_s'] or '-'} | {sp} "
            f"| {r['nodes']} | {r['edges']} |")
    lines += [
        "",
        "Multi-process row: two OS processes joined by torch.distributed "
        "(gloo), per-process byte-range sharded FASTA reading "
        "(`--multihost`; parallel/multihost.py), on the same device.",
        "",
    ]
    return "\n".join(lines)


def main(argv=None) -> int:
    from ..core.chunked import resolve_device
    from ..utils.timing import card_info

    ap = argparse.ArgumentParser(prog="scaling")
    ap.add_argument("--out", default="scaling_torch.md")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain torch versions)")
    ap.add_argument("--worker", nargs=2, metavar=("READS", "DEVICE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return multihost_worker(*args.worker)

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as td:
        reads = os.path.join(td, "reads.fa")
        total = synth(reads)
        rows = []
        for n in (1, 2, 4, 8):
            r = run_mesh(reads, n, device=dev)
            print(json.dumps(r), flush=True)
            rows.append(r)
        mh = run_multihost(reads, device=dev.type)
        print(json.dumps(mh), flush=True)
        rows.append(mh)
    with open(args.out, "w") as f:
        f.write(table(rows, total, str(dev), card_info(dev)))
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
