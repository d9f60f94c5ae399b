"""Partial-order alignment (POA) in minimizer space.

Host copy of the JAX package's `models/poa.py`.  The device DP of the
port (ops/poa_device, csrc/poa_dp.cu) matches `_semiglobal_vec` and
`_traceback_vec` bit for bit, tie-breaks included.

Capability parity with the reference's POA module (rust-mdbg src/poa.rs):

- graph: DAG with u64 node labels and (weight, inter-minimizer sequence)
  edge labels, seeded from the template as a linear path (poa.rs:617-637)
- `semiglobal(query)`: topological-order DP over (graph nodes) x (query),
  free start anywhere in the graph (column 0 score 0, poa.rs:786-806), query
  prefix gaps cost j*gap_open (poa.rs:800-805); gap open/extend chosen from
  the predecessor cell's operation (determine_gap_penalty, poa.rs:639-689)
- `alignment()`: traceback from the best-scoring terminal (out-degree-0) node
  in the last column (poa.rs:459-513)
- `add_alignment`: weave the query into the graph — matches bump edge weights,
  mismatches/insertions add nodes, carrying inter-minimizer sequence on new
  edges (poa.rs:994-1054)
- `consensus` / `consensus_path`: heaviest path by (edge weight with weights
  < t zeroed, downstream path weight), reverse-topological scoring
  (poa.rs:909-986)
- `consensus_boundary`: trim the consensus to the template extent via a
  pairwise semiglobal alignment (poa.rs:548-582)

Tie-breaking in the DP and traceback is deterministic but intentionally NOT
bit-matched to the reference (whose ties depend on petgraph edge-list order
and enum Ord); corrections can differ on exact ties, which perturbs nothing
downstream structurally.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import pairwise

MIN_SCORE = -858_993_459


@dataclasses.dataclass
class Alignment:
    score: int
    ystart: int
    operations: list  # ("M", pred_node|None, node|None) / ("I", node|None) / ("D", ...)


class PoaGraph:
    def __init__(self, template, seq_str: str, minim_pos, gap_open=-1,
                 gap_extend=-1, match=1, mismatch=-1):
        self.weights: list[int] = []          # node -> u64 label
        self.succ: list[list[int]] = []       # node -> successor nodes
        self.pred: list[list[int]] = []
        self.edges: dict[tuple[int, int], list] = {}  # (u,v) -> [weight, seq]
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.match = match
        self.mismatch = mismatch
        prev = self.add_node(int(template[0]))
        for i in range(1, len(template)):
            node = self.add_node(int(template[i]))
            between = seq_str[minim_pos[i - 1] : minim_pos[i]]
            self.add_edge(prev, node, between)
            prev = node

    def add_node(self, w: int) -> int:
        self.weights.append(int(w))
        self.succ.append([])
        self.pred.append([])
        return len(self.weights) - 1

    def add_edge(self, u: int, v: int, seq: str):
        key = (u, v)
        if key in self.edges:
            self.edges[key][0] += 1
        else:
            self.edges[key] = [1, seq]
            self.succ[u].append(v)
            self.pred[v].append(u)

    def _score(self, a: int, b: int) -> int:
        return self.match if a == b else self.mismatch

    def topo_order(self) -> list[int]:
        n = len(self.weights)
        indeg = [len(self.pred[v]) for v in range(n)]
        stack = [v for v in range(n) if indeg[v] == 0]
        order = []
        while stack:
            v = stack.pop()
            order.append(v)
            for w in self.succ[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
        return order

    # ---------------- alignment ----------------
    def semiglobal(self, query) -> Alignment:
        """Dispatch: vectorized row-sweep when gap open == extend (the
        reference's and our default scoring), else the general loop.  Both
        produce identical Alignments (tie-break parity tested in
        tests/test_poa.py)."""
        if self.gap_open == self.gap_extend:
            return self._semiglobal_vec(query)
        return self._semiglobal_loop(query)

    def _semiglobal_vec(self, query) -> Alignment:
        """Row-sweep DP: one wavefront per topo node, vectorized over query
        columns.  With gap open == extend the predecessor-op-dependent gap
        penalty (poa.rs:639-689) is a constant, so the within-row insertion
        recurrence closes into a prefix max and each candidate row is pure
        vector work.  Tie-breaking matches _semiglobal_loop exactly: the
        first strictly-greater candidate in [M(p0), D(p0), M(p1), D(p1), ...]
        order wins, and I wins only when strictly greater."""
        m = len(query)
        n = len(self.weights)
        ge = self.gap_extend
        qarr = np.asarray([int(q) for q in query], dtype=np.uint64)
        cols = np.arange(m + 1, dtype=np.int32)
        # kind codes: 0=M, 1=D, 2=I; pred -1 encodes None
        score = np.empty((n + 1, m + 1), dtype=np.int32)
        kind = np.empty((n + 1, m + 1), dtype=np.int8)
        pred = np.full((n + 1, m + 1), -1, dtype=np.int32)
        score[0] = cols * ge          # query prefix gap (poa.rs:800-805)
        kind[0] = 2                   # ("I", None)
        kind[0, 0] = 0                # ("M", None, None)
        score[:, 0] = 0               # start anywhere in the graph
        kind[1:, 0] = 1               # ("D", None, None)

        base = np.empty(m + 1, dtype=np.int32)
        for node in self.topo_order():
            i = node + 1
            r = self.weights[node]
            prevs = self.pred[node]
            sub = np.where(qarr == np.uint64(r), self.match, self.mismatch) \
                .astype(np.int32)
            if not prevs:
                cand = score[0, :m] + sub      # ("M", None, None) only
                k_md = np.zeros(m, dtype=np.int8)
                p_md = np.full(m, -1, dtype=np.int32)
            else:
                stack = np.empty((2 * len(prevs), m), dtype=np.int32)
                for t, p in enumerate(prevs):
                    stack[2 * t] = score[p + 1, :m] + sub
                    stack[2 * t + 1] = score[p + 1, 1:] + ge
                arg = stack.argmax(axis=0)     # first max = loop's tie-break
                cand = stack[arg, np.arange(m)]
                k_md = (arg & 1).astype(np.int8)
                p_md = np.asarray(prevs, dtype=np.int32)[arg >> 1]
            # insertion closure: row[j] = max(cand[j], row[j-1] + ge)
            base[0] = 0
            base[1:] = cand
            keyed = base - cols * ge
            np.maximum.accumulate(keyed, out=keyed)
            row = keyed + cols * ge
            is_ins = row[1:] > cand            # I wins only strictly
            score[i] = row
            kind[i, 1:] = np.where(is_ins, np.int8(2), k_md)
            pred[i, 1:] = np.where(is_ins, np.int32(node), p_md)

        self._tb_arrays = (score, kind, pred, m)
        return self._traceback_vec()

    def _traceback_vec(self) -> Alignment:
        score, kind, pred, m = self._tb_arrays
        terminals = [v for v in range(len(self.weights)) if not self.succ[v]]
        best_i, best_s = None, None
        for v in terminals:  # last max wins (Rust max_by semantics)
            s = score[v + 1][m]
            if best_s is None or s >= best_s:
                best_s, best_i = int(s), v + 1
        i, j = best_i, m

        def tup(i, j):
            k = int(kind[i, j])
            p = int(pred[i, j])
            if k == 0:
                return ("M", None, None) if p < 0 else ("M", p, i - 1)
            if k == 1:
                return ("D", None, None) if p < 0 else ("D", p, i - 1)
            return ("I", None) if p < 0 else ("I", p)

        ops = []
        while i > 0 and j > 0:
            o = tup(i, j)
            ops.append(o)
            k = o[0]
            if k == "M" and o[1] is not None:
                i = o[1] + 1
                j -= 1
            elif k == "D" and o[1] is not None:
                i = o[1] + 1
            elif k == "I" and o[1] is not None:
                i = o[1] + 1
                j -= 1
            elif k == "M":
                j -= 1
                break
            elif k == "D":
                break
            else:  # ("I", None)
                i -= 1
                j -= 1
        return Alignment(score=int(score[best_i][m]), ystart=j,
                         operations=ops[::-1])

    def _semiglobal_loop(self, query) -> Alignment:
        query = [int(q) for q in query]
        n = len(self.weights)
        m = len(query)
        go, ge = self.gap_open, self.gap_extend
        # cell: (score, op); op = ("M", ip|None, node) | ("D", ip|None, node)
        #                        | ("I", node|None)
        score = [[0] * (m + 1) for _ in range(n + 1)]
        op = [[None] * (m + 1) for _ in range(n + 1)]
        for i in range(1, n + 1):
            score[i][0] = 0              # start anywhere in the graph
            op[i][0] = ("D", None, None)
        for j in range(1, m + 1):
            score[0][j] = j * go         # query prefix gap (poa.rs:800-805)
            op[0][j] = ("I", None)
        op[0][0] = ("M", None, None)

        def gap_pen(prev_op, cur_kind):
            # determine_gap_penalty (poa.rs:639-689)
            if prev_op is None:
                return go
            k = prev_op[0]
            if k == "M":
                return go
            if k == "I":
                return ge if cur_kind == "I" else go
            # k == "D"
            return ge if cur_kind == "D" else go

        for node in self.topo_order():
            r = self.weights[node]
            i = node + 1
            prevs = self.pred[node]
            for j in range(1, m + 1):
                q = query[j - 1]
                if not prevs:
                    # source-node match: the reference records Match(None),
                    # losing the node identity (poa.rs:829-834); mirrored here
                    best = (score[0][j - 1] + self._score(r, q),
                            ("M", None, None))
                else:
                    best = (MIN_SCORE, ("M", None, node))
                    for p in prevs:
                        ip = p + 1
                        s_m = score[ip][j - 1] + self._score(r, q)
                        if s_m > best[0]:
                            best = (s_m, ("M", p, node))
                        s_d = score[ip][j] + gap_pen(op[ip][j], "D")
                        if s_d > best[0]:
                            best = (s_d, ("D", p, node))
                s_i = score[i][j - 1] + gap_pen(op[i][j - 1], "I")
                if s_i > best[0]:
                    best = (s_i, ("I", node))
                score[i][j], op[i][j] = best
        self._tb_score, self._tb_op, self._tb_m = score, op, m
        return self._traceback()

    def _traceback(self) -> Alignment:
        score, op, m = self._tb_score, self._tb_op, self._tb_m
        terminals = [v for v in range(len(self.weights)) if not self.succ[v]]
        best_i, best_s = None, None
        for v in terminals:  # last max wins (Rust max_by semantics)
            s = score[v + 1][m]
            if best_s is None or s >= best_s:
                best_s, best_i = s, v + 1
        i, j = best_i, m
        ops = []
        while i > 0 and j > 0:
            o = op[i][j]
            ops.append(o)
            k = o[0]
            if k == "M" and o[1] is not None:
                i = o[1] + 1
                j -= 1
            elif k == "D" and o[1] is not None:
                i = o[1] + 1
            elif k == "I" and o[1] is not None:
                i = o[1] + 1
                j -= 1
            elif k == "M":
                j -= 1
                break
            elif k == "D":
                break
            else:  # ("I", None)
                i -= 1
                j -= 1
        return Alignment(score=score[best_i][m], ystart=j, operations=ops[::-1])

    # ---------------- graph growth ----------------
    def add_alignment(self, aln: Alignment, seq, seq_str: str, minim_pos):
        seq = [int(s) for s in seq]
        prev = 0
        prev_i = 0
        i = aln.ystart
        for o in aln.operations:
            k = o[0]
            if k == "M" and o[2] is not None:
                p = o[2]
                between = seq_str[minim_pos[prev_i] : minim_pos[i]]
                if seq[i] != self.weights[p]:
                    node = self.add_node(seq[i])
                    self.add_edge(prev, node, between)
                    prev = node
                else:
                    self.add_edge(prev, p, between)
                    prev = p
                prev_i = i
                i += 1
            elif k == "M":
                i += 1
            elif k == "I" and o[1] is None:
                i += 1
            elif k == "I":
                node = self.add_node(seq[i])
                between = seq_str[minim_pos[prev_i] : minim_pos[i]]
                self.add_edge(prev, node, between)
                prev = node
                prev_i = i
                i += 1
            # "D": skip deleted nodes
        return self

    # ---------------- consensus ----------------
    def consensus_path(self, t: int = 0) -> list[int]:
        order = self.topo_order()
        scores = {}
        nxt = {}
        for node in reversed(order):
            best_n = None
            best_w = (0, 0)
            for v in self.succ[node]:
                w = self.edges[(node, v)][0]
                if w < t:
                    w = 0
                cand = (w, scores.get(v, 0))
                if cand > best_w:
                    best_w = cand
                    best_n = v
            scores[node] = best_w[0] + best_w[1]
            nxt[node] = best_n
        start, best = None, 0
        for node, s in scores.items():
            if s > best:
                start, best = node, s
        path = []
        cur = start
        while cur is not None:
            path.append(cur)
            cur = nxt[cur]
        return path

    def consensus(self, t: int = 0):
        path = self.consensus_path(t)
        cns = [self.weights[v] for v in path]
        edge_seqs = [
            self.edges[(path[i], path[i + 1])][1] for i in range(len(path) - 1)
        ]
        return cns, edge_seqs


def consensus_boundary(cns, cns_es, orig):
    """Trim consensus to the template extent (poa.rs:548-582)."""
    if not cns:
        return [], []
    score = lambda a, b: 1 if a == b else -1  # noqa: E731
    aligner = pairwise.Aligner.with_capacity(len(orig), len(cns), -1, -1,
                                            score, match_scores=(1, -1))
    aln = aligner.semiglobal(list(orig), list(cns))
    if aln.yend - aln.ystart < 2:
        return [], []
    return list(cns[aln.ystart : aln.yend]), list(cns_es[aln.ystart : aln.yend - 1])
