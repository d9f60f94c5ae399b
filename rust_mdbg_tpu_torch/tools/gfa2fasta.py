"""GFA S-lines -> FASTA (the reference's utils/gfa2fasta.sh:
`awk '/^S/{print ">"$2"\\n"$3}' | fold`, i.e. 80-column wrapping)."""

from __future__ import annotations

import sys


def gfa2fasta(base: str):
    """base.gfa -> base.fa"""
    with open(base + ".gfa") as f, open(base + ".fa", "w") as out:
        for line in f:
            if not line.startswith("S"):
                continue
            v = line.rstrip("\n").split("\t")
            out.write(f">{v[1]}\n")
            seq = v[2]
            for i in range(0, max(1, len(seq)), 80):
                out.write(seq[i : i + 80] + "\n")


def main(argv) -> int:
    if len(argv) < 1:
        print("usage: gfa2fasta <base>  (reads base.gfa, writes base.fa)",
              file=sys.stderr)
        return 2
    gfa2fasta(argv[0])
    return 0
