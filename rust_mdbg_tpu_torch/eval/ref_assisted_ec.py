"""Reference-assisted EC diagnostic in minimizer space.

A host copy of the JAX package's `eval/ref_assisted_ec.py` (same output).
Capability parity with the reference's utils/ref_assisted_ec.py: count canonical l-tuples
(tuples of `l` consecutive minimizers, normalized against their reversal,
ref_assisted_ec.py:33-44) across a read set, build a successor table keyed by
the (l-1)-prefix, then flag "weak" tuples (abundance below a threshold —
likely sequencing errors) in each read together with the successor counts a
corrector could substitute (ref_assisted_ec.py:47-52).

Run: python -m rust_mdbg_tpu_torch.eval.ref_assisted_ec ref.ec_data reads.ec_data
         [--l=3] [--weak=20]
"""

from __future__ import annotations

import sys
from collections import Counter, defaultdict

from ..io import ec_data


def normalize(t: tuple) -> tuple:
    return min(t, t[::-1])


def build_tables(reads, l: int = 3):
    """Canonical l-tuple abundances + successor counts per (l-1)-prefix."""
    lmers: Counter = Counter()
    successors: dict[tuple, Counter] = defaultdict(Counter)
    for read in reads:
        for i in range(len(read) - l + 1):
            lmer = normalize(tuple(read[i : i + l]))
            lmers[lmer] += 1
            if i < len(read) - l:
                successors[lmer[:-1]][lmer[-1]] += 1
    return lmers, successors


def weak_positions(read, lmers, successors, l: int = 3, weak: int = 20):
    """(position, abundance, successor-counter) for each weak l-tuple."""
    out = []
    for i in range(len(read) - l + 1):
        lmer = normalize(tuple(read[i : i + l]))
        if lmers[lmer] < weak:
            out.append((i, lmers[lmer], dict(successors[lmer[1:]])))
    return out


def evaluate(ref_path: str, reads_path: str, l: int = 3, weak: int = 20):
    ref = ec_data.load(ref_path.replace(".ec_data", ""))
    if len(ref) != 1:
        raise SystemExit("reference .ec_data must hold exactly one record")
    reads = [r.read_transformed
             for r in ec_data.load(reads_path.replace(".ec_data", ""))]
    lmers, successors = build_tables(reads, l)
    # ground truth: l-tuples present in the reference genome's sequence
    ref_lmers = {
        normalize(tuple(ref[0].read_transformed[i : i + l]))
        for i in range(len(ref[0].read_transformed) - l + 1)
    }
    per_read = []
    n_weak = n_weak_genomic = 0
    for read in reads:
        wp = weak_positions(read, lmers, successors, l, weak)
        per_read.append(wp)
        for i, _ab, _succ in wp:
            n_weak += 1
            if normalize(tuple(read[i : i + l])) in ref_lmers:
                n_weak_genomic += 1  # weak but real: would be a bad fix
    return dict(n_reads=len(reads), n_lmers=len(lmers), n_weak=n_weak,
                n_weak_genomic=n_weak_genomic, per_read=per_read)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    l, weak = 3, 20
    for a in argv:
        if a.startswith("--l="):
            l = int(a.split("=")[1])
        if a.startswith("--weak="):
            weak = int(a.split("=")[1])
    if len(args) < 2:
        print("usage: ref_assisted_ec ref.ec_data reads.ec_data "
              "[--l=N] [--weak=N]", file=sys.stderr)
        return 2
    res = evaluate(args[0], args[1], l, weak)
    print(f"loaded 1 reference, {res['n_reads']} reads; "
          f"{res['n_lmers']} distinct {l}-tuples")
    for idx, wp in enumerate(res["per_read"]):
        for i, ab, succ in wp:
            print(f"read {idx} pos {i} weak (abundance {ab}), "
                  f"successors {succ}")
    print(f"{res['n_weak']} weak positions, "
          f"{res['n_weak_genomic']} of them genomic")
    return 0


if __name__ == "__main__":
    sys.exit(main())
