"""Remove duplicate and self-loop L-lines from a GFA.

Behavioral port of utils/gfa_break_loops.py: for each L line, the unordered
(source, sink) segment pair is tracked; the second and later lines on the same
pair are dropped (regardless of orientation), and self loops (source == sink)
are always dropped.
"""

from __future__ import annotations

import sys


def break_loops(in_path: str, out_path: str):
    seen: set[tuple[str, str]] = set()
    with open(in_path) as f, open(out_path, "w") as out:
        for line in f:
            if not line.startswith("L"):
                out.write(line.rstrip("\n") + "\n")
                continue
            v = line.split()
            e = tuple(sorted([v[1], v[3]]))
            dup = e in seen or v[1] == v[3]
            seen.add(e)
            if not dup:
                out.write(line.rstrip("\n") + "\n")


def main(argv) -> int:
    if len(argv) < 1:
        print("usage: break-loops <in.gfa> [out.gfa]", file=sys.stderr)
        return 2
    out = argv[1] if len(argv) > 1 else "/dev/stdout"
    break_loops(argv[0], out)
    return 0
