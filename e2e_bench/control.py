"""The readings that set the limits of check.py, at a cell's own size.

    python -m e2e_bench.control --workload <cell> --seeds <n> [<n> ...]
        [--program]

For each seed: the cell's corpus; with --program one job of the program
checked as a run checks its last job (the lower readings); then the
control, the reference with one of the configuration's guarantees broken
(reference.assemble's `control`), put in the program's place and checked
against the sound reference (the upper readings).  One JSON line a seed.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from . import check, generator, reference
from .run import HERE, load_cell, load_module

#: the guarantee the control breaks (reference.assemble's `control`)
CONTROL = "bloom24"


def control_numbers(graph, bad, reads, seed: int) -> dict:
    """check.compare() of the control `bad` in the program's place: a
    record for each of its nodes, of which as many are compared as a
    run's check decodes (drawn by node id)."""
    rng = np.random.default_rng(seed)
    n = bad.vec.shape[0]
    ids = rng.choice(n, min(n, 4000), replace=False) if n else []
    records = [(int(i), bad.record(reads, int(i))) for i in ids]
    return check.compare(bad.gfa_lines, records, np.arange(n), graph, reads)


def main(argv=None, device=None, root: str | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m e2e_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    a = ap.parse_args(argv)
    root = root or os.path.dirname(HERE)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        c = load_cell(json.load(f), a.workload, root)
    cfg = c["cfg"]

    import torch

    dev = torch.device(device or "cuda")
    entry = load_module("entries", cfg["entry"],
                        os.path.join(root, "e2e_bench"))
    for seed in a.seeds:
        work_dir = tempfile.mkdtemp(prefix="e2e_bench.")
        try:
            fasta = os.path.join(work_dir, "reads.fa")
            generator.write_corpus(cfg, seed, fasta)
            out = dict(seed=seed)
            if a.program:
                prefix = os.path.join(work_dir, "job")
                t = time.time()
                entry.run_job(fasta, cfg, prefix, dev)
                out["job_s"] = time.time() - t
            t = time.time()
            reads = reference.parse_fasta(fasta)
            graph = reference.assemble(reads, cfg["params"], dev)
            out["reference_s"] = time.time() - t
            out["counts"] = graph.counts
            if a.program:
                out["program"], out["records_checked"] = check.check_job(
                    prefix, seed, graph, reads)
            bad = reference.assemble(reads, cfg["params"], dev,
                                     control=CONTROL)
            out["control"] = control_numbers(graph, bad, reads, seed)
            out["control_nodes"] = bad.counts["nodes"]
            print(json.dumps(out), flush=True)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
