"""Experiments harness: timed dataset runs, N50, parameter grids, tables.

Counterpart of the JAX package's `experiments/harness.py` (the reference's
experiments/ scripts: run_hg002, run_dmel, run_*_grid, make_table.py): a
run = assemble at fixed params on `--device` (the card unless named) +
magic_simplify + wall-clock + assembly stats (contig count, size, largest,
N50), a grid = the cartesian K x L x density sweep, and make_table
aggregates run results to CSV.  `--engine` takes the JAX package's names;
`auto` and `pallas` are the port's device engine, as in the CLI.

Run:
  python -m rust_mdbg_tpu_torch.experiments.harness run <reads> <prefix> \
      [-k K] [-l L] [-d D] [--minabund N] [--bf] [--engine E] [--device D]
  python -m rust_mdbg_tpu_torch.experiments.harness grid <reads> <org> \
      --k 8,11,17 --l 12 --d 0.001,0.003 [--device D]
  python -m rust_mdbg_tpu_torch.experiments.harness table <dir>
"""

from __future__ import annotations

import glob as _glob
import json
import os
import sys
import time


def assembly_stats(fasta_path: str) -> dict:
    """Contig stats incl. N50 (the reference pipes through an `n50` tool)."""
    lens = []
    cur = 0
    with open(fasta_path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    lens.append(cur)
                cur = 0
            else:
                cur += len(line.strip())
    if cur:
        lens.append(cur)
    lens.sort(reverse=True)
    total = sum(lens)
    acc = 0
    n50 = 0
    for x in lens:
        acc += x
        if acc * 2 >= total:
            n50 = x
            break
    return dict(n_contigs=len(lens), assembly_size=total,
                largest=lens[0] if lens else 0, n50=n50)


def run_experiment(reads: str, prefix: str, params, simplify=True,
                   device=None) -> dict:
    from ..core.pipeline import assemble
    from ..tools.magic_simplify import magic_simplify
    from ..utils.timing import max_rss_bytes

    t0 = time.time()
    stats = assemble(reads, params, prefix, device=device)
    t_asm = time.time() - t0
    result = dict(prefix=prefix, k=params.k, l=params.l, d=params.density,
                  assemble_s=round(t_asm, 2), **{
                      k: v for k, v in stats.items() if isinstance(v, (int, float))
                  })
    if simplify:
        t1 = time.time()
        fa = magic_simplify(prefix)
        result["simplify_s"] = round(time.time() - t1, 2)
        result.update(assembly_stats(fa))
    result["total_s"] = round(time.time() - t0, 2)
    result["max_rss_gb"] = round(max_rss_bytes() / 1024**3, 3)
    with open(prefix + ".result.json", "w") as f:
        json.dump(result, f)
    return result


def run_grid(reads: str, org: str, ks, ls, ds, minabund=2, engine="auto",
             use_bf=False, device=None) -> list[dict]:
    """K x L x density sweep (run_mouse_grid:5-40 pattern)."""
    from ..cli import _engine
    from ..core.chunked import resolve_device
    from ..params import Params

    device = resolve_device(device)  # raises before the sweep, not per cell
    results = []
    for d in ds:
        for l in ls:
            for k in ks:
                prefix = f"{org}-K{k}-L{l}-D{d}"
                p = Params(k=k, l=l, density=d, min_kmer_abundance=minabund,
                           use_bf=use_bf, engine=_engine(engine))
                print(f"[grid] {prefix}", file=sys.stderr)
                try:
                    results.append(run_experiment(reads, prefix, p,
                                                  device=device))
                except Exception as e:  # a bad cell shouldn't kill the sweep
                    print(f"[grid] {prefix} failed: {e}", file=sys.stderr)
    return results


def make_table(directory: str = ".") -> str:
    """Aggregate *.result.json to CSV (make_table.py equivalent)."""
    rows = []
    for path in sorted(_glob.glob(os.path.join(directory, "*.result.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    if not rows:
        return "k,l,d,n50\n"
    cols = ["prefix", "k", "l", "d", "n_contigs", "assembly_size", "largest",
            "n50", "total_s", "max_rss_gb"]
    out = [",".join(cols)]
    for r in rows:
        out.append(",".join(str(r.get(c, "")) for c in cols))
    return "\n".join(out) + "\n"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    cmd = argv[0]
    if cmd == "table":
        sys.stdout.write(make_table(argv[1] if len(argv) > 1 else "."))
        return 0
    from ..cli import _engine
    from ..params import Params

    def opt(name, default=None, cast=str):
        for i, a in enumerate(argv):
            if a == name and i + 1 < len(argv):
                return cast(argv[i + 1])
            if a.startswith(name + "="):
                return cast(a.split("=", 1)[1])
        return default

    device = opt("--device")
    if cmd == "run":
        p = Params(
            k=opt("-k", 21, int), l=opt("-l", 14, int),
            density=opt("-d", 0.003, float),
            min_kmer_abundance=opt("--minabund", 2, int),
            use_bf="--bf" in argv, engine=_engine(opt("--engine", "auto")),
        )
        r = run_experiment(argv[1], argv[2], p, device=device)
        print(json.dumps(r))
        return 0
    if cmd == "grid":
        ks = [int(x) for x in opt("--k", "10").split(",")]
        ls = [int(x) for x in opt("--l", "12").split(",")]
        ds = [float(x) for x in opt("--d", "0.003").split(",")]
        rs = run_grid(argv[1], argv[2], ks, ls, ds,
                      engine=opt("--engine", "auto"), device=device)
        print(json.dumps(rs))
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
