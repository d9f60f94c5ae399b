"""extreme-simplify: N rounds of aggressive gfa-asm simplification.

Driver parity with utils/extreme_gfaview: each round runs the gfatools-asm
recipe `-r 1000 -t 200000 -b 200000 -u` (short-overlap drop, long tip cut,
deep bubble pop, unitig condensation) against the built-in graph engine,
then retraces minimizer chains and per-unitig sequences from the run's
`.sequences` sidecar (extreme_gfaview:25-32 via eval/retrace_minimizers),
keeping only the newest round's files (extreme_gfaview:37-44).  Unitig
A-lines compose across rounds (gfa_asm.unitigs), so every round's GFA
still references ORIGINAL node ids and retraces from the original
sidecar.

Run: python -m rust_mdbg_tpu_torch extreme-simplify PREFIX N_ROUNDS
"""

from __future__ import annotations

import glob
import os
import sys

from .gfa import Gfa
from .gfa_asm import cut_tips, drop_short, pop_bubbles, unitigs


def extreme_simplify(prefix: str, rounds: int, verbose: bool = True) -> str:
    cur_gfa = prefix + ".gfa"
    if not os.path.exists(cur_gfa):
        raise SystemExit(f"Input GFA file not found: {cur_gfa}")
    have_seq = bool(glob.glob(f"{prefix}.*.sequences"))
    prev_round: list[str] = []  # previous round's outputs (never the input)
    for i in range(1, rounds + 1):
        g = Gfa.parse(cur_gfa)
        drop_short(g, 1000)
        cut_tips(g, 10, 200000)
        pop_bubbles(g, 200000)
        g = unitigs(g)
        nxt_gfa = f"{prefix}.{i}.gfa"
        g.write(nxt_gfa)
        made = [nxt_gfa]
        if have_seq:
            from ..eval.retrace_minimizers import main as retrace_main

            retrace_main([prefix, nxt_gfa, f"{prefix}.{i}"])
            made += [f"{prefix}.{i}.sequences.txt", f"{prefix}.{i}.fa"]
        # keep only the newest round on disk (extreme_gfaview:37-44)
        for f in prev_round:
            if os.path.exists(f):
                os.unlink(f)
        prev_round = made
        cur_gfa = nxt_gfa
        if verbose:
            print(f"iteration {i} done ({len(g.segments)} segments)",
                  file=sys.stderr)
    print(f"done, result in: {cur_gfa}")
    return cur_gfa


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print("usage: extreme-simplify PREFIX N_ROUNDS", file=sys.stderr)
        return 2
    extreme_simplify(argv[0], int(argv[1]))
    return 0
