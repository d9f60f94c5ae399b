"""k-min-mer recovery curves over a parameter grid.

Counterpart of the JAX package's `eval/recovery_grid.py`; both assemblies
of a point run on `--device` (the card unless named): the genome through
the streaming engine and its long-sequence tiler, the reads through the
chunked driver.  Capability parity with the reference's
utils/recovery_grid.py (which plots hard-coded
recovery-vs-density and recovery-vs-k series from past runs): this version
computes the series live — for each parameter point it assembles the reads
and the reference genome (`--reference --minabund 1` semantics) and
set-compares their k-min-mers (eval/compare_kmers), then plots recovery (%)
against the swept parameter (matplotlib when available, ASCII otherwise).

Run: python -m rust_mdbg_tpu_torch.eval.recovery_grid reads.fa genome.fa out/
         [--densities=0.001,0.002] [--ks=7,14,21] [--l=12] [--k=21]
         [--d=0.003] [--device=cpu]
Library use: sweep(...) -> list of (x, recovery_pct); plot_series(...).
"""

from __future__ import annotations

import os
import sys


def _recovery(reads: str, genome: str, outdir: str, tag: str, k: int, l: int,
              d: float, device=None) -> float:
    from ..core.pipeline import assemble
    from ..params import Params
    from .compare_kmers import compare

    pg = os.path.join(outdir, f"genome-{tag}")
    pr = os.path.join(outdir, f"reads-{tag}")
    # batch_reads=1: the streaming engine's batches have a fixed number
    # of rows, and a genome of one record would otherwise be padded to 512
    # rows of twice its length (same outputs, 1/512 of the work)
    assemble(genome, Params(k=k, l=l, density=d, min_kmer_abundance=1,
                            reference=True, batch_reads=1), pg,
             device=device)
    assemble(reads, Params(k=k, l=l, density=d, min_kmer_abundance=2), pr,
             device=device)
    return compare(pg, pr)["recovery_pct"]


def sweep(reads: str, genome: str, outdir: str, *, densities=None, ks=None,
          k: int = 21, l: int = 12, d: float = 0.003, device=None):
    """Returns {"density": [(d, pct)...], "k": [(k, pct)...]} for the
    requested sweeps (either list may be omitted)."""
    from ..core.chunked import resolve_device

    device = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    series = {}
    if densities:
        series["density"] = [
            (di, _recovery(reads, genome, outdir, f"d{di}", k, l, di, device))
            for di in densities
        ]
    if ks:
        series["k"] = [
            (ki, _recovery(reads, genome, outdir, f"k{ki}", ki, l, d, device))
            for ki in ks
        ]
    return series


def plot_series(xs, ys, xlabel: str, out_png: str | None = None) -> str:
    """Plot recovery (%) vs parameter; PNG via matplotlib (Agg) when
    available, ASCII fallback otherwise.  Returns the path or the ASCII."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        plt.plot(xs, ys)
        plt.xlabel(xlabel)
        plt.ylabel("K-min-mer recovery (%)")
        out_png = out_png or f"recovery_{xlabel}.png"
        plt.savefig(out_png, dpi=120)
        plt.close()
        return out_png
    except Exception:
        lines = [f"K-min-mer recovery (%) vs {xlabel}"]
        for x, y in zip(xs, ys):
            lines.append(f"{x:>10} | " + "#" * int(y / 2) + f" {y:.2f}")
        return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    if len(args) < 3:
        print("usage: recovery_grid reads.fa genome.fa outdir "
              "[--densities=..] [--ks=..] [--l=N] [--k=N] [--d=F] "
              "[--device=D]",
              file=sys.stderr)
        return 2
    kw = dict(k=21, l=12, d=0.003, densities=None, ks=None, device=None)
    for a in argv:
        if a.startswith("--densities="):
            kw["densities"] = [float(x) for x in a.split("=")[1].split(",")]
        elif a.startswith("--ks="):
            kw["ks"] = [int(x) for x in a.split("=")[1].split(",")]
        elif a.startswith("--l="):
            kw["l"] = int(a.split("=")[1])
        elif a.startswith("--k="):
            kw["k"] = int(a.split("=")[1])
        elif a.startswith("--d="):
            kw["d"] = float(a.split("=")[1])
        elif a.startswith("--device="):
            kw["device"] = a.split("=")[1]
    series = sweep(args[0], args[1], args[2], **kw)
    for name, pts in series.items():
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        out = plot_series(xs, ys, name,
                          os.path.join(args[2], f"recovery_{name}.png"))
        print(out if "\n" in out else f"wrote {out}")
        for x, y in pts:
            print(f"  {name}={x}: {y:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
