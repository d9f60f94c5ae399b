"""Base-space reconstruction: unitig GFA + .sequences -> .complete.gfa.

Behavioral port target: the reference's second binary
(src/to_basespace.rs), three passes:

1. simplified/unitig GFA -> unitigs{name -> [(node, ori)]}, node2unitig
   (to_basespace.rs:81-127, A-lines at 102-110)
1.5 per-node LoadKind {Entire, EntireRc, Left, Right, LeftLast, RightLast}
   from position/orientation in its unitig (132-153; last assignment wins)
1.75 original `<prefix>.gfa` KC tags summed per unitig (156-193)
2. stream `<prefix>.*.sequences` (LZ4F), keep only the needed part of each
   node's sequence: Entire / revcomp / left cut (revcomp'd) / right cut,
   where the cut sizes come from the recorded shift pair (200-243)
3. re-stream the simplified GFA writing `.complete.gfa`: concatenated unitig
   sequences, fixed LN, mean-abundance mc:f tag, overlap clamped to
   min(len-1) (245-339).
"""

from __future__ import annotations

import sys

from ..io.sequences import iter_sequences
from ..utils.seq import revcomp


def to_basespace(gfa_path: str, sequences_prefix: str,
                 out_path: str | None = None, exact: bool = False) -> str:
    """exact=False reproduces the reference's shift-based cuts exactly
    (approximate by a few bases at junctions where raw homopolymer extents
    differ between the recording reads — see tests/test_to_basespace.py).
    exact=True additionally refines each junction by locating the running
    unitig tail inside the next node's oriented sequence, which makes
    junctions byte-exact wherever the two node sequences genuinely overlap
    — strictly better reconstructions than the reference."""
    out_path = out_path or (gfa_path + ".complete.gfa")

    # Pass 1: unitig composition
    unitigs: dict[str, list[tuple[int, bool]]] = {}
    node2unitig: dict[int, str] = {}
    order: list[str] = []
    with open(gfa_path) as f:
        cur_name = None
        for line in f:
            if line.startswith("S"):
                cur_name = line.split("\t")[1]
                unitigs.setdefault(cur_name, [])
                order.append(cur_name)
            elif line.startswith("A"):
                v = line.rstrip("\n").split("\t")
                node = int(v[4])
                name = v[1]
                unitigs.setdefault(name, []).append((node, v[3] == "+"))
                node2unitig[node] = name
    print(f"Done parsing unitigs GFA, got {len(unitigs)} unitigs.")

    # Pass 1.5: LoadKind per node
    ENTIRE, ENTIRE_RC, LEFT, RIGHT, LEFT_LAST, RIGHT_LAST = range(6)
    load_node: dict[int, int] = {}
    for name, vec in unitigs.items():
        for i, (node, ori) in enumerate(vec):
            if i == 0:
                load_node[node] = ENTIRE if ori else ENTIRE_RC
            else:
                last = i == len(vec) - 1
                if ori:
                    load_node[node] = RIGHT_LAST if last else RIGHT
                else:
                    load_node[node] = LEFT_LAST if last else LEFT

    # Pass 1.75: abundances from the original GFA
    unitig_abundance: dict[str, int] = {}
    nb_kminmers = 0
    with open(f"{sequences_prefix}.gfa") as f:
        for line in f:
            if not line.startswith("S"):
                continue
            v = line.rstrip("\n").split("\t")
            node = int(v[1])
            ab = 0
            for elt in v:
                if elt.startswith("KC:"):
                    ab = int(elt.split(":")[2])
            name = node2unitig.get(node)
            if name is None:
                continue
            unitig_abundance[name] = unitig_abundance.get(name, 0) + ab
            nb_kminmers += 1
    print(f"Done parsing original GFA, with {nb_kminmers} k-min-mers.")

    # Pass 2: needed sequence parts (exact mode also keeps full sequences)
    sequences: dict[int, str] = {}
    full: dict[int, str] = {}
    for rec in iter_sequences(sequences_prefix):
        node = rec["index"]
        if node not in node2unitig:
            continue
        kind = load_node.get(node)
        if kind is None:
            continue
        seq = rec["seq"]
        cut0, cut1 = rec["shift"]
        if exact:
            full[node] = seq
        if kind == ENTIRE:
            sequences[node] = seq
        elif kind == ENTIRE_RC:
            sequences[node] = revcomp(seq)
        elif kind in (LEFT, LEFT_LAST):
            sequences[node] = revcomp(seq[:cut0])
        elif kind in (RIGHT, RIGHT_LAST):
            sequences[node] = seq[len(seq) - cut1:]
    print(f"Done parsing .sequences file, recorded {len(sequences)} sequences.")

    # Pass 3: write complete GFA
    def reconstruct(name: str) -> str:
        parts = []
        for node, _ori in unitigs[name]:
            if node not in sequences:
                raise KeyError(
                    f"node {node} of unitig {name} missing from .sequences "
                    f"(was the run --no-basespace?)"
                )
            parts.append(sequences[node])
        return "".join(parts)

    T = 48  # junction anchor length for exact mode

    def reconstruct_exact(name: str) -> str:
        out = []
        cur_tail = ""
        for i, (node, ori) in enumerate(unitigs[name]):
            if node not in full:
                raise KeyError(f"node {node} missing from .sequences")
            oriented = full[node] if ori else revcomp(full[node])
            if i == 0:
                out.append(oriented)
            else:
                piece = None
                if len(cur_tail) >= T:
                    idx = oriented.find(cur_tail[-T:])
                    if idx >= 0:
                        piece = oriented[idx + T:]
                if piece is None:
                    piece = sequences[node]  # shift-based fallback
                out.append(piece)
            cur_tail = (cur_tail + out[-1])[-T:]
        return "".join(out)

    seq_lens: dict[str, int] = {}
    with open(gfa_path) as f, open(out_path, "w") as out:
        out.write("H\tVN:Z:1.0\n")
        for line in f:
            if line.startswith("S"):
                v = line.rstrip("\n").split("\t")
                name = v[1]
                seq = reconstruct_exact(name) if exact else reconstruct(name)
                seq_lens[name] = len(seq)
                mean_ab = unitig_abundance.get(name, 0) / max(1, len(unitigs[name]))
                out.write(
                    f"S\t{name}\t{seq}\tLN:i:{len(seq)}\tmc:f:{mean_ab:.1f}\n"
                )
            elif line.startswith("L"):
                v = line.rstrip("\n").split("\t")
                ov = int(v[5][:-1])
                src, snk = v[1], v[3]
                if ov > seq_lens[src] or ov > seq_lens[snk]:
                    ov = min(seq_lens[src] - 1, seq_lens[snk] - 1)
                    v[5] = f"{ov}M"
                out.write("\t".join(v[:6]) + "\n")
    return out_path


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="to-basespace")
    ap.add_argument("-g", "--gfa", required=True)
    ap.add_argument("-s", "--sequences", required=True,
                    help="rust_mdbg output prefix (with .gfa and .*.sequences)")
    ap.add_argument("-d", "--debug", action="store_true")
    ap.add_argument("--exact-junctions", action="store_true",
                    help="refine junction cuts by overlap matching "
                         "(byte-exact where node sequences truly overlap; "
                         "improvement over the reference's shift cuts)")
    a = ap.parse_args(argv)
    out = to_basespace(a.gfa, a.sequences, exact=a.exact_junctions)
    print(f"Wrote {out}")
    return 0
