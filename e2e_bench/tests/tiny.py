"""A checkout for the tests: the benchmark's files with every genome cut to
a few tens of kilobases, and one cell more, `<config>.tiny`, whose traffic
mix (`nowarm`, a file of its own) has no warm-up job."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = os.path.join(REPO, "e2e_bench")
GENOME_MBP = 0.05


def make_root(tmp: str, genome_mbp: float = GENOME_MBP) -> str:
    """A copy of BENCHMARK.json and e2e_bench/ under tmp/root, with the
    configurations' genomes cut to genome_mbp; each `<config>.tiny` cell
    reads the per-layer metrics that `<config>.fasta` reads."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(PKG, os.path.join(root, "e2e_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        cfg = load_json(os.path.join(REPO, c["file"]))
        cfg["genome_mbp"] = genome_mbp
        dump_json(os.path.join(root, c["file"]), cfg)
        bench["workloads"].append(dict(
            name=f"{c['name']}.tiny", config=c["name"], traffic="nowarm",
            chips=1, why="tests"))
        for m in bench["per_layer"]:
            if f"{c['name']}.fasta" in m.get("workloads", ()):
                m["workloads"].append(f"{c['name']}.tiny")
    dump_json(os.path.join(root, "e2e_bench", "traffic", "nowarm.json"),
              dict(load_json(os.path.join(PKG, "traffic", "fasta.json")),
                   name="nowarm", warmup_jobs=0))
    dump_json(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def dump_json(path: str, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run_cell(root: str, workload: str, seed: int = 2**31 + 11,
             trace: int = 0, seconds: float = 0.01,
             device: str | None = "cpu") -> tuple[int, dict]:
    """e2e_bench.run in this process, on the CPU unless `device` is None
    (the card): (exit code, the result's JSON object, or None where it
    printed none)."""
    from e2e_bench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device=device, root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
