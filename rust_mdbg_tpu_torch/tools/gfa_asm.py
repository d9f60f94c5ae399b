"""Assembly-graph simplification: tip cutting, bubble popping, unitig output.

Native replacement for `gfatools asm -t N,L -b D -u` as driven by the
reference's utils/magic_simplify:29-57.  Algorithms follow the miniasm paper's
published graph-cleaning procedures (tip trimming; radius-bounded superbubble
popping via the Kahn-style single-sink search) on the bidirected graph of
tools/gfa.py.  One deliberate improvement over gfatools: bubble path choice is
coverage-aware (keeps the path maximizing summed KC abundance, then bp length)
— the reference's main.rs:1139-1141 comment calls gfatools' simplifications
"naive coverage-oblivious", and presimp exists to compensate; keeping coverage
here strictly helps.

CLI:  python -m rust_mdbg_tpu_torch gfa-asm in.gfa -t 10,50000 -b 100000 -u -o out.gfa
Flags apply IN ORDER like gfatools (each -t/-b is one pass).

Two engines produce byte-identical files (tests/test_torch_tools.py):
this module's readable Python passes (the oracle) and native/gfa_asm.cpp
(the production engine, gfatools-class speed; gfatools runs HG002's full
graph in 1m48s per the reference's README.md:130-131 and the native engine
is what lets magic_simplify keep that budget).  `run_ops_file` dispatches:
MDBG_GFA_ASM=python|native overrides, default prefers native.
"""

from __future__ import annotations

import os
import sys

from ..utils.seq import revcomp
from .gfa import Gfa, Segment, _flip


def _oriented_seq(seg: Segment, ori: str) -> str | None:
    if seg.seq is None:
        return None
    return seg.seq if ori == "+" else revcomp(seg.seq)


def _comp(v):
    return (v[0], _flip(v[1]))


def cut_tips(g: Gfa, max_ext: int, max_bp: int) -> int:
    """Remove dead-end paths of <= max_ext segments and < max_bp bases that
    attach to a junction.  Returns number of segments removed.

    Candidates are enumerated against the pass-start graph, then cut
    shortest-first with live revalidation — so at a Y junction the short
    erroneous branch goes first and the surviving main line is then no longer
    a tip.  (gfatools' sequential in-id-order cutting resolves this
    arbitrarily by segment id; shortest-first is deterministic and strictly
    safer.)"""
    arcs = g.adjacency()
    removed: set[str] = set()

    def walk(v):
        """Extend a dead-end start; returns (path, bp, attached) vs live graph."""
        path = [v]
        bp = g.segments[v[0]].length
        cur = v
        attached = False
        while len(path) <= max_ext:
            out = [(w, ov) for (w, ov) in arcs.get(cur, [])
                   if w[0] not in removed]
            if len(out) != 1:
                break
            w, ov = out[0]
            if w[0] in {p[0] for p in path}:
                break  # loop
            w_preds = {
                u[0] for (u, _o) in arcs.get(_comp(w), [])
                if u[0] not in removed
            }
            if len(w_preds) >= 2:
                attached = True
                break
            path.append(w)
            bp += max(0, g.segments[w[0]].length - ov)
            cur = w
        return path, bp, attached

    candidates = []
    for name in sorted(g.segments):
        for o in "+-":
            v = (name, o)
            if arcs.get(_comp(v), []):
                continue  # has predecessors: not a dead-end start
            path, bp, attached = walk(v)
            if attached and len(path) <= max_ext and bp < max_bp:
                candidates.append((bp, len(path), v))

    for _bp, _n, v in sorted(candidates):
        if v[0] in removed:
            continue
        if any(u[0] not in removed for (u, _o) in arcs.get(_comp(v), [])):
            continue  # no longer a dead-end (shouldn't happen: arcs only shrink)
        path, bp, attached = walk(v)
        if attached and len(path) <= max_ext and bp < max_bp:
            removed |= {p[0] for p in path}
    g.drop_segments(removed)
    return len(removed)


def drop_short(g: Gfa, min_ovlp: int) -> int:
    """Remove links whose overlap is below min_ovlp bases (gfatools asm -r,
    as used by utils/extreme_gfaview:25 `-r 1000`).  Returns links removed."""
    before = len(g.links)
    g.links = [lk for lk in g.links if lk[4] >= min_ovlp]
    return before - len(g.links)


def pop_bubbles(g: Gfa, max_dist: int) -> int:
    """One pass of radius-bounded bubble popping from every branching vertex.
    Returns number of segments removed."""
    arcs = g.adjacency()
    removed: set[str] = set()

    def live_arcs(v):
        return [(w, ov) for (w, ov) in arcs.get(v, []) if w[0] not in removed]

    def weight(name):
        s = g.segments[name]
        kc = s.kc()
        return kc if kc is not None else s.length

    popped = 0
    for name in sorted(g.segments):
        for o in "+-":
            v0 = (name, o)
            if name in removed or len(live_arcs(v0)) < 2:
                continue
            result = _find_bubble(g, v0, max_dist, live_arcs, weight)
            if result is None:
                continue
            visited, keep_path = result
            drop = {w[0] for w in visited} - {p[0] for p in keep_path} - {v0[0]}
            if drop:
                removed |= drop
                popped += 1
    g.drop_segments(removed)
    return len(removed)


def _find_bubble(g, v0, max_dist, live_arcs, weight):
    """Kahn-style single-sink superbubble search from v0 (miniasm alg. 6).

    Returns (visited_vertices, kept_path) or None."""
    dist = {v0: 0}
    score = {v0: 0}
    pred = {}
    remaining: dict = {}
    S = [v0]
    n_pending = 0
    visited = []
    steps = 0
    while S:
        steps += 1
        if steps > 10000:
            return None
        v = S.pop()
        out = live_arcs(v)
        if not out:  # dead end inside the bubble (the sink is never popped)
            return None
        for (w, ov) in out:
            if w == v0 or w == _comp(v0):
                return None  # loop back to source
            d = dist[v] + max(1, g.segments[w[0]].length - ov)
            if d > max_dist:
                return None
            sc = score[v] + weight(w[0])
            if w not in dist:
                dist[w] = d
                score[w] = sc
                pred[w] = v
                remaining[w] = len(live_arcs(_comp(w)))  # in-degree
                n_pending += 1
                visited.append(w)
            else:
                if (sc, w) > (score[w], w):
                    score[w] = sc
                    pred[w] = v
                if d < dist[w]:
                    dist[w] = d
            remaining[w] -= 1
            if remaining[w] == 0:
                S.append(w)
                n_pending -= 1
        if len(S) == 1 and n_pending == 0:
            sink = S[0]
            path = [sink]
            cur = sink
            while cur != v0:
                cur = pred[cur]
                path.append(cur)
            return visited, path
    return None


def unitigs(g: Gfa) -> Gfa:
    """Condense maximal simple paths into a unitig graph (gfatools -u).

    Output: S utgNNNNNNl with merged sequence (or * + LN), A-lines
    `A <utg> <offset> <ori> <seg> 0 <len>` (consumed by to_basespace.rs:102-110),
    and L-lines between unitig extremities.
    """
    arcs = g.adjacency()

    def succ(v):
        return arcs.get(v, [])

    def single_succ(v):
        out = arcs.get(v, [])
        return out[0] if len(out) == 1 else None

    used: set[str] = set()
    paths: list[tuple[list, bool]] = []  # (vertices, circular)
    for name in sorted(g.segments):
        if name in used:
            continue
        v = (name, "+")
        # walk backward to the path start
        start = v
        seen = {name}
        circular = False
        while True:
            pin = succ(_comp(start))
            if len(pin) != 1:
                break
            u = _comp(pin[0][0])  # unique predecessor
            if len(succ(u)) != 1:
                break
            if u[0] in seen:
                circular = u == v  # wrapped around to the walk origin
                break
            start = u
            seen.add(u[0])
        # walk forward collecting the path
        path = [start]
        used.add(start[0])
        cur = start
        while True:
            nx = single_succ(cur)
            if nx is None:
                break
            w, ov = nx
            if len(succ(_comp(w))) != 1:
                break
            if w[0] in used or w[0] == start[0]:
                break
            path.append(w)
            used.add(w[0])
            cur = w
        paths.append((path, circular))

    out = Gfa()
    # per-input-segment nested A-lines (composed through repeated unitig
    # rounds; tuple layout: (utg, offset, ori, seg, 0, len))
    sub_alines: dict[str, list] = {}
    for (seg, aoff, aori, orig, _z, aln) in g.a_lines:
        # parsed-from-file tuples carry strings (gfa.py keeps A fields raw)
        sub_alines.setdefault(seg, []).append(
            (int(aoff), aori, orig, int(str(aln).strip())))
    # vertex -> (utg, ori) maps for link stitching
    start_of: dict[tuple, tuple] = {}
    end_of: dict[tuple, tuple] = {}
    arcs_ov: dict[tuple, int] = {}
    for v, lst in arcs.items():
        for (w, ov) in lst:
            arcs_ov[(v, w)] = ov

    for i, (path, circular) in enumerate(paths):
        name = f"utg{i + 1:07d}{'c' if circular else 'l'}"
        segs = [g.segments[v[0]] for v in path]
        seqs = [_oriented_seq(s, v[1]) for s, v in zip(segs, path)]
        have_seq = all(s is not None for s in seqs)
        offs = [0]
        total = segs[0].length
        merged = [seqs[0]] if have_seq else None
        for j in range(1, len(path)):
            ov = arcs_ov[(path[j - 1], path[j])]
            ov = min(ov, segs[j].length - 1) if segs[j].length > 0 else 0
            offs.append(total - ov)
            total += segs[j].length - ov
            if have_seq:
                merged.append(seqs[j][ov:] if ov <= len(seqs[j]) else "")
        seq = "".join(merged) if have_seq else None
        out.segments[name] = Segment(name, seq, total if seq is None else len(seq), [])
        for v, off, s in zip(path, offs, segs):
            nested = sub_alines.get(v[0])
            if nested:
                # input segment is itself a unitig: compose its A-lines so
                # the output always references ORIGINAL segments (repeated
                # `-u` rounds, extreme-simplify flow)
                for (aoff, aori, orig, aln) in nested:
                    if v[1] == "+":
                        coff, cori = off + aoff, aori
                    else:
                        coff = off + s.length - (aoff + aln)
                        cori = "-" if aori == "+" else "+"
                    out.a_lines.append((name, coff, cori, orig, 0, aln))
            else:
                out.a_lines.append((name, off, v[1], v[0], 0, s.length))
        start_of[path[0]] = (name, "+")
        start_of[_comp(path[-1])] = (name, "-")
        end_of[path[-1]] = (name, "+")
        end_of[_comp(path[0])] = (name, "-")

    emitted = set()
    for (v, w), ov in sorted(arcs_ov.items()):
        if v not in end_of or w not in start_of:
            continue  # interior arc
        ua, oa = end_of[v]
        ub, ob = start_of[w]
        key = (ua, oa, ub, ob)
        ckey = (ub, _flip(ob), ua, _flip(oa))
        if key in emitted or ckey in emitted:
            continue
        emitted.add(key)
        out.links.append((ua, oa, ub, ob, ov))
    return out


def run_ops(g: Gfa, ops, verbose=False, err=sys.stderr) -> Gfa:
    """Apply an op schedule to an in-memory graph (Python engine)."""
    for op in ops:
        if op[0] == "t":
            n = cut_tips(g, op[1], op[2])
            if verbose and n:
                print(f"  cut {n} tip segments", file=err)
        elif op[0] == "b":
            n = pop_bubbles(g, op[1])
            if verbose and n:
                print(f"  popped {n} bubble segments", file=err)
        elif op[0] == "r":
            n = drop_short(g, op[1])
            if verbose and n:
                print(f"  dropped {n} short links", file=err)
        elif op[0] == "u":
            g = unitigs(g)
            if verbose:
                print(f"  {len(g.segments)} unitigs", file=err)
    return g


def _native_lib():
    import ctypes

    from ..native import load

    lib = load("gfa_asm")
    if not getattr(lib, "_gfa_asm_ready", False):
        lib.gfa_asm_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_long,
        ]
        lib.gfa_asm_file.restype = ctypes.c_int
        lib._gfa_asm_ready = True
    return lib


def engine_choice(engine: str | None = None) -> str:
    e = engine or os.environ.get("MDBG_GFA_ASM", "native")
    if e == "native":
        try:
            _native_lib()
        except Exception:
            e = "python"
    return e


def run_ops_file(in_path: str, ops, out_path: str, engine: str | None = None,
                 verbose: bool = False) -> list[tuple[str, int]]:
    """Apply an op schedule file -> file; returns [(op_kind, count), ...].

    Counts: t/b = segments removed, r = links removed, u = unitigs emitted.
    Native and Python engines are byte-identical by test.
    """
    eng = engine_choice(engine)
    if eng == "native":
        import ctypes

        lib = _native_lib()
        spec = ";".join(",".join(str(x) for x in op) for op in ops)
        buf = ctypes.create_string_buffer(1 << 16)
        rc = lib.gfa_asm_file(in_path.encode(), spec.encode(),
                              out_path.encode(), buf, len(buf))
        if rc != 0:
            raise RuntimeError(
                f"gfa_asm_file rc={rc}: {buf.value.decode(errors='replace')}")
        stats = []
        for line in buf.value.decode().splitlines():
            kind, _, count = line.partition(" ")
            stats.append((kind, int(count)))
    else:
        g = Gfa.parse(in_path)
        stats = []
        for op in ops:
            if op[0] == "t":
                stats.append(("t", cut_tips(g, op[1], op[2])))
            elif op[0] == "b":
                stats.append(("b", pop_bubbles(g, op[1])))
            elif op[0] == "r":
                stats.append(("r", drop_short(g, op[1])))
            elif op[0] == "u":
                g = unitigs(g)
                stats.append(("u", len(g.segments)))
        g.write(out_path)
    if verbose:
        names = {"t": "cut tip segments", "b": "popped bubble segments",
                 "r": "dropped short links", "u": "unitigs"}
        for kind, count in stats:
            if count or kind == "u":
                print(f"  [{eng}] {count} {names[kind]}", file=sys.stderr)
    return stats


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="gfa-asm")
    ap.add_argument("gfa")
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("ops", nargs="*", help="(parsed manually)")
    # manual in-order parse of -t/-b/-u like gfatools
    args_in = list(argv)
    path = None
    outp = "-"
    ops = []
    i = 0
    while i < len(args_in):
        a = args_in[i]
        if a == "-t":
            i += 1
            parts = args_in[i].split(",")
            ops.append(("t", int(parts[0]), int(parts[1]) if len(parts) > 1 else 1 << 62))
        elif a == "-b":
            i += 1
            ops.append(("b", int(args_in[i])))
        elif a == "-r":
            i += 1
            ops.append(("r", int(args_in[i])))
        elif a == "-u":
            ops.append(("u",))
        elif a in ("-o", "--out"):
            i += 1
            outp = args_in[i]
        else:
            path = a
        i += 1
    if path is None:
        print("usage: gfa-asm <in.gfa> [-t N,L] [-b D] [-u] [-o out.gfa]",
              file=sys.stderr)
        return 2
    tmp = None
    target = outp
    if outp == "-":
        import tempfile

        fd, tmp = tempfile.mkstemp(suffix=".gfa")
        os.close(fd)
        target = tmp
    stats = run_ops_file(path, ops, target)
    names = {"t": "cut tip segments", "b": "popped bubble segments",
             "r": "dropped short links", "u": "unitigs"}
    for kind, count in stats:
        print(f"[gfa-asm] {count} {names[kind]}", file=sys.stderr)
    if tmp is not None:
        sys.stdout.write(open(tmp).read())
        os.remove(tmp)
    return 0
