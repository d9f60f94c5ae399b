"""Fraction of distinct k-min-mers seen only once (utils/mappability.py).

A host copy of the JAX package's `eval/mappability.py`.

Run: python -m rust_mdbg_tpu_torch.eval.mappability <prefix>
(abundances from <prefix>.gfa KC tags; exit code 1 when 100% singletons,
matching the reference script's contract)
"""

from __future__ import annotations

import sys

from .compare_kmers import parse_gfa_abundance


def mappability(prefix: str) -> float:
    ab = parse_gfa_abundance(prefix)
    if not ab:
        return 100.0
    unique = sum(1 for v in ab.values() if v == 1)
    return 100.0 * unique / len(ab)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    pct = mappability(argv[0])
    print(f"percentage of distinct k-min-mers seen only once: {pct:.2f}")
    return 1 if pct == 100.0 else 0


if __name__ == "__main__":
    sys.exit(main())
