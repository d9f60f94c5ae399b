"""magic_simplify: the full graph-simplification pipeline to contigs.

Driver parity with utils/magic_simplify (and the --meta variant,
utils/magic_simplify_meta): the same simplification schedule, run against the
framework's native gfa-asm instead of external gfatools:

  round 1: -t 10,50000 x2, -b 100000 x2, -t 10,50000, -b 100000 x3,
           -t 10,50000, -b 100000, -t 10,50000, -b 1000000, -t 10,150000,
           -b 1000000, -u                       (magic_simplify:29)
  break loops, to_basespace, then size-gated extra rounds (>1 MB, >100 MB)
  (magic_simplify:42-57), final gfa2fasta -> <prefix>.msimpl.fa.
"""

from __future__ import annotations

import os
import sys

from .gfa_asm import run_ops_file
from .gfa2fasta import gfa2fasta
from .gfa_break_loops import break_loops
from .to_basespace import to_basespace

ROUND1 = [
    ("t", 10, 50000), ("t", 10, 50000), ("b", 100000), ("b", 100000),
    ("t", 10, 50000), ("b", 100000), ("b", 100000), ("b", 100000),
    ("t", 10, 50000), ("b", 100000), ("t", 10, 50000), ("b", 1000000),
    ("t", 10, 150000), ("b", 1000000), ("u",),
]
ROUND2 = [
    ("t", 10, 50000), ("b", 100000), ("t", 10, 100000), ("b", 1000000),
    ("t", 10, 150000), ("b", 1000000), ("u",),
]
ROUND3 = [
    ("t", 10, 50000), ("b", 100000), ("t", 10, 100000), ("b", 1000000),
    ("t", 10, 200000), ("b", 1000000), ("u",),
]


def magic_simplify(base: str, meta: bool = False, keep: bool = False,
                   exact_junctions: bool = False,
                   engine: str | None = None) -> str:
    tmp1 = base + ".tmp1.gfa"
    run_ops_file(base + ".gfa", ROUND1, tmp1, engine=engine, verbose=True)
    tmp2 = base + ".tmp2.gfa"
    break_loops(tmp1, tmp2)
    complete = to_basespace(tmp2, base, exact=exact_junctions)
    os.replace(complete, tmp2)

    current = tmp2
    if not meta:
        filesize = os.path.getsize(tmp2)
        if filesize > 1_000_000:
            tmp3 = base + ".tmp3.gfa"
            run_ops_file(current, ROUND2, tmp3, engine=engine, verbose=True)
            current = tmp3
        if filesize > 100_000_000:
            tmp4 = base + ".tmp4.gfa"
            break_loops(current, tmp4)
            run_ops_file(tmp4, ROUND3, base + ".msimpl.gfa", engine=engine,
                         verbose=True)
        else:
            os.replace(current, base + ".msimpl.gfa")
    else:
        os.replace(current, base + ".msimpl.gfa")

    if not keep:
        for t in ("tmp1", "tmp2", "tmp3", "tmp4"):
            p = f"{base}.{t}.gfa"
            if os.path.exists(p):
                os.remove(p)
    gfa2fasta(base + ".msimpl")
    return base + ".msimpl.fa"


def main(argv) -> int:
    args = [a for a in argv if not a.startswith("--")]
    if not args:
        print("usage: magic-simplify <prefix> [--meta] [--keep]", file=sys.stderr)
        return 2
    fa = magic_simplify(args[0], meta="--meta" in argv, keep="--keep" in argv,
                        exact_junctions="--exact-junctions" in argv)
    print(f"Wrote {fa}")
    return 0
