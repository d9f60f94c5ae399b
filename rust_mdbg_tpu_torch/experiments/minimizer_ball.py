"""Levenshtein-ball minimizer experiment.

A host copy of the JAX package's `experiments/minimizer_ball.py` (same
output), over the port's own `ops/minimizers.invertible_hash_np`; its
`density_minimizers` casts the selected l-mers to uint64 before the
shifts, which the JAX copy's int64 indices fail under numpy 2.

Capability parity with utils/minimizer_ball_experiments.py: on a random
genome, compare the mean spacing of (a) a plain density-selected minimizer
set, (b) the set expanded by the Levenshtein ball of radius 1 around each
minimizer (substitutions/deletions/insertions at interior positions,
minimizer_ball_experiments.py:50-64), and (c) a greedily ball-inserted set
(only add a ball if none of its members is taken, :79-86).  Selection uses
the framework's invertible mix hash over 2-bit packed l-mers instead of
Python's string hash; the l-1/l/l+1 window scan (:27-44) is preserved.

Run: python -m rust_mdbg_tpu_torch.experiments.minimizer_ball [--l=11]
         [--density=0.0005] [--genome=1000] [--seed=0]
"""

from __future__ import annotations

import sys

import numpy as np

BASES = "ACTG"


def random_genome(n: int, rng) -> str:
    return "".join(rng.choice(list(BASES), n))


def density_minimizers(l: int, density: float) -> set[str]:
    """All l-mers whose invertible-mix hash of the 2-bit packing falls under
    density * 4^l (vectorized enumeration of the full 4^l space)."""
    from ..ops.minimizers import invertible_hash_np

    space = 4**l
    ints = np.arange(space, dtype=np.uint64)
    h = invertible_hash_np(ints, np.uint64(space - 1))
    # nonzero gives int64, which numpy 2 will not shift by uint64
    sel = np.nonzero(h < np.uint64(int(density * space)))[0] \
        .astype(np.uint64)
    lut = np.array(list("ACGT"))
    shifts = np.arange(l - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
    codes = (sel[:, None] >> shifts[None, :]) & np.uint64(3)
    return {"".join(row) for row in lut[codes.astype(np.int64)]}


def levenshtein_ball(lmer: str):
    """Radius-1 neighbors: interior substitutions, interior deletions,
    interior insertions (matches the reference's position ranges)."""
    l = len(lmer)
    for pos in range(1, l):
        for c in BASES:
            if lmer[pos] != c:
                yield lmer[:pos] + c + lmer[pos + 1:]
    for pos in range(1, l - 1):
        yield lmer[:pos] + lmer[pos + 1:]
    for pos in range(1, l - 1):
        for c in BASES:
            yield lmer[:pos] + c + lmer[pos:]


def minimizer_spacing(genome: str, minimizer_set: set[str], l: int) -> float:
    """Mean gap between selected positions, scanning windows of length
    l-1, l, and l+1 at every offset (minimizer_ball_experiments.py:27-44)."""
    positions = []
    for i in range(len(genome)):
        for width in (l, l - 1, l + 1):
            if genome[i : i + width] in minimizer_set and \
                    len(genome[i : i + width]) == width:
                positions.append(i)
    if not positions:
        return -1.0
    return sum(positions[i + 1] - positions[i]
               for i in range(len(positions) - 1)) / len(positions)


def greedy_ball_set(minimizers: set[str]) -> set[str]:
    out: set[str] = set()
    for m in sorted(minimizers):
        ball = list(levenshtein_ball(m))
        if all(x not in out for x in ball):
            out.update(ball)
    return out


def run(l: int = 11, density: float = 0.0005, genome_len: int = 1000,
        seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    genome = random_genome(genome_len, rng)
    space = 4**l
    reg = density_minimizers(l, density)
    balled = reg | {x for m in reg for x in levenshtein_ball(m)}
    greedy = greedy_ball_set(reg)
    return dict(
        n_regular=len(reg), pct_regular=100.0 * len(reg) / space,
        n_balled=len(balled), pct_balled=100.0 * len(balled) / space,
        n_greedy=len(greedy), pct_greedy=100.0 * len(greedy) / space,
        spacing_regular=minimizer_spacing(genome, reg, l),
        spacing_balled=minimizer_spacing(genome, balled, l),
        spacing_greedy=minimizer_spacing(genome, greedy, l),
    )


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kw = dict(l=11, density=0.0005, genome_len=1000, seed=0)
    for a in argv:
        if a.startswith("--l="):
            kw["l"] = int(a.split("=")[1])
        elif a.startswith("--density="):
            kw["density"] = float(a.split("=")[1])
        elif a.startswith("--genome="):
            kw["genome_len"] = int(a.split("=")[1])
        elif a.startswith("--seed="):
            kw["seed"] = int(a.split("=")[1])
    r = run(**kw)
    print(f"kept {r['n_regular']} regular minimizers "
          f"({r['pct_regular']:.02f}%)")
    print(f"mean distance between regular minimizers: "
          f"{r['spacing_regular']:.2f}")
    print(f"now {r['n_balled']} balled minimizers ({r['pct_balled']:.02f}%)")
    print(f"mean distance between balled minimizers: "
          f"{r['spacing_balled']:.2f}")
    print(f"now {r['n_greedy']} greedily inserted balled minimizers "
          f"({r['pct_greedy']:.02f}%)")
    print(f"mean distance between balled minimizers: "
          f"{r['spacing_greedy']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
