"""Bidirected assembly-graph model + GFA1 parse/write.

This is the framework's native replacement for the external `gfatools asm`
dependency of the reference pipeline (utils/magic_simplify:29 runs
`gfatools asm -t 10,50000 ... -b 1000000 -u`).  gfatools is not part of this
framework's runtime; the simplification passes (tip cutting, radius-bounded
bubble popping, unitig condensation with A-lines) are implemented here on a
bidirected graph in the style of miniasm's published algorithms.

Graph model: vertex = (segment, orientation).  An L-line `a ao b bo ovM`
induces arc (a,ao)->(b,bo) and its complement (b,!bo)->(a,!ao), both with
overlap ov.  Segments may carry sequences or `*` + LN tag (the mdBG GFA has
no sequences before to_basespace).
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

from ..utils.seq import revcomp


@dataclasses.dataclass
class Segment:
    name: str
    seq: str | None          # None if '*'
    length: int              # LN tag or len(seq)
    tags: list               # unparsed extra tags (order preserved)

    def kc(self) -> int | None:
        for t in self.tags:
            if t.startswith("KC:i:"):
                return int(t[5:])
        return None


def _flip(o: str) -> str:
    return "-" if o == "+" else "+"


class Gfa:
    def __init__(self):
        self.segments: dict[str, Segment] = {}
        self.links: list[tuple[str, str, str, str, int]] = []
        self.a_lines: list[tuple] = []  # (utg, off, ori, name, x, y)
        self.header = "H\tVN:Z:1.0"

    # ---------------- IO ----------------
    @classmethod
    def parse(cls, path: str) -> "Gfa":
        g = cls()
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                t = line[0]
                v = line.split("\t")
                if t == "H":
                    g.header = line
                elif t == "S":
                    seq = None if v[2] == "*" else v[2]
                    length = len(seq) if seq is not None else 0
                    tags = v[3:]
                    for tag in tags:
                        if tag.startswith("LN:i:"):
                            length = int(tag[5:])
                    g.segments[v[1]] = Segment(v[1], seq, length, tags)
                elif t == "L":
                    # leading digits of the CIGAR; '*' (GFA1 unknown) -> 0
                    m = re.match(r"(\d+)", v[5]) if len(v) > 5 else None
                    ov = int(m.group(1)) if m else 0
                    g.links.append((v[1], v[2], v[3], v[4], ov))
                elif t == "A":
                    g.a_lines.append(tuple(v[1:]))
        return g

    def write(self, path: str):
        a_by_seg: dict[str, list] = defaultdict(list)
        for a in self.a_lines:
            a_by_seg[a[0]].append(a)
        with open(path, "w") as f:
            f.write(self.header + "\n")
            for s in self.segments.values():
                seq = s.seq if s.seq is not None else "*"
                tags = [t for t in s.tags if not t.startswith("LN:i:")]
                f.write(
                    "\t".join(["S", s.name, seq, f"LN:i:{s.length}"] + tags) + "\n"
                )
                for a in a_by_seg.get(s.name, ()):
                    f.write("A\t" + "\t".join(str(x) for x in a) + "\n")
            for a, ao, b, bo, ov in self.links:
                if a in self.segments and b in self.segments:
                    f.write(f"L\t{a}\t{ao}\t{b}\t{bo}\t{ov}M\n")

    # ---------------- adjacency ----------------
    def adjacency(self):
        """arcs[(name, ori)] = list of ((name2, ori2), ov), deduplicated,
        deterministic order."""
        arcs: dict[tuple, list] = defaultdict(list)
        seen = set()
        for a, ao, b, bo, ov in self.links:
            if a not in self.segments or b not in self.segments:
                continue
            for (va, vb) in (
                ((a, ao), (b, bo)),
                ((b, _flip(bo)), (a, _flip(ao))),
            ):
                key = (va, vb)
                if key not in seen:
                    seen.add(key)
                    arcs[va].append((vb, ov))
        for v in arcs:
            arcs[v].sort(key=lambda x: (x[0], x[1]))
        return arcs

    def drop_segments(self, names: set[str]):
        for n in names:
            self.segments.pop(n, None)
        self.links = [
            ln for ln in self.links
            if ln[0] not in names and ln[2] not in names
        ]

    def drop_links(self, dead: set[tuple]):
        """dead contains (a, ao, b, bo) vertex-pair arcs; drop matching L-lines
        in either written direction."""
        def gone(ln):
            a, ao, b, bo, _ = ln
            return ((a, ao, b, bo) in dead
                    or (b, _flip(bo), a, _flip(ao)) in dead)
        self.links = [ln for ln in self.links if not gone(ln)]
