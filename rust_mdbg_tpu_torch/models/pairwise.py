"""Pairwise affine-gap alignment over the minimizer (u64) alphabet.

Host copy of the JAX package's `models/pairwise.py`.

Capability parity with the reference's vendored rust-bio aligner generalized
to u64 symbols (rust-mdbg src/pairwise.rs): custom clip penalties,
`semiglobal` mode (x fully aligned, y clips free — pairwise.rs:1005-1073),
affine gaps (first gap char costs open+extend, then extend per char).

Used by consensus_boundary (poa.rs:548-582) and the evaluation tooling.
Sequences here are short (reads in minimizer space, ~50-300 tokens), so a
plain DP with traceback is adequate; ops/align.py provides the batched
device scorer for the fwd/rev direction triage in EC.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MIN_SCORE = -(2**30)


@dataclasses.dataclass
class Alignment:
    score: int
    xstart: int
    xend: int
    ystart: int
    yend: int
    xlen: int
    ylen: int
    operations: list


class Aligner:
    def __init__(self, gap_open: int, gap_extend: int, match_fn,
                 match_scores: tuple[int, int] | None = None):
        """match_scores: when the caller's match_fn is the plain
        (match, mismatch) comparator, passing the pair here lets the DP rows
        vectorize; pass None for an arbitrary match_fn."""
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.match_fn = match_fn
        self.match_scores = match_scores

    @classmethod
    def with_capacity(cls, _m, _n, gap_open, gap_extend, match_fn,
                      match_scores=None):
        return cls(gap_open, gap_extend, match_fn, match_scores)

    def semiglobal(self, x, y) -> Alignment:
        """x aligned end-to-end; y prefix/suffix clipped free."""
        x = [int(v) for v in x]
        y = [int(v) for v in y]
        m, n = len(x), len(y)
        o, e = self.gap_open, self.gap_extend
        NEG = MIN_SCORE
        yarr = np.array(y, dtype=np.uint64) if self.match_scores else None
        # DP matrices: best score ending in match (M), gap-in-y consuming x
        # (Ix), gap-in-x consuming y (Iy)
        M = np.full((m + 1, n + 1), NEG, dtype=np.int64)
        Ix = np.full((m + 1, n + 1), NEG, dtype=np.int64)
        Iy = np.full((m + 1, n + 1), NEG, dtype=np.int64)
        M[0, :] = 0  # free y-prefix clip
        for i in range(1, m + 1):
            Ix[i, 0] = o + e * i
        cols = np.arange(n + 1, dtype=np.int64)
        for i in range(1, m + 1):
            xi = x[i - 1]
            prev_best = np.maximum(np.maximum(M[i - 1], Ix[i - 1]), Iy[i - 1])
            # Ix: vertical (consume x)
            Ix[i, :] = np.maximum(Ix[i - 1] + e, prev_best + o + e)
            if yarr is not None:
                mt, mm = self.match_scores
                sub = np.where(yarr == np.uint64(xi), mt, mm)
            else:
                sub = np.fromiter(
                    (self.match_fn(xi, yj) for yj in y), dtype=np.int64,
                    count=n,
                )
            M[i, 1:] = prev_best[:-1] + sub
            # Iy: horizontal (consume y): affine prefix-max closure
            #   Iy[j] = max_{j'<j} rbc[j'] + o + e*(j-j')
            rbc = np.maximum(M[i], Ix[i])
            keyed = rbc + o - e * cols
            run = np.maximum.accumulate(keyed)
            Iy[i, 1:] = run[:-1] + e * cols[1:]

        final = np.maximum(np.maximum(M[m], Ix[m]), Iy[m])
        yend = int(final.argmax())
        score = int(final[yend])

        # traceback from (m, yend); deterministic preference M > Ix > Iy on
        # ties, gap extension preferred over (equal-scoring) gap open
        ops: list = []
        i, j = m, yend
        vals = [M[m, yend], Ix[m, yend], Iy[m, yend]]
        state = vals.index(max(vals))
        oe = o + e
        while i > 0:
            if state == 0:  # M: diagonal
                sub = self.match_fn(x[i - 1], y[j - 1])
                ops.append("Match" if x[i - 1] == y[j - 1] else "Subst")
                target = M[i, j] - sub
                i, j = i - 1, j - 1
                for s, v in ((0, M[i, j]), (1, Ix[i, j]), (2, Iy[i, j])):
                    if v == target:
                        state = s
                        break
            elif state == 1:  # Ix: consume x (Del wrt y)
                ops.append("Del")
                cur = Ix[i, j]
                i -= 1
                if Ix[i, j] + e == cur:
                    state = 1
                elif M[i, j] + oe == cur:
                    state = 0
                else:
                    state = 2
            else:  # Iy: consume y (Ins wrt x)
                ops.append("Ins")
                cur = Iy[i, j]
                j -= 1
                if Iy[i, j] + e == cur:
                    state = 2
                elif M[i, j] + oe == cur:
                    state = 0
                else:
                    state = 1
        ystart = j
        ops.reverse()
        return Alignment(score=score, xstart=0, xend=m, ystart=ystart,
                         yend=yend, xlen=m, ylen=n, operations=ops)
