"""Batched POA semiglobal DP + traceback over many (graph, query) pairs.

Counterpart of the JAX package's `ops/poa_device.py`.  The reference's
hottest error-correction code is the per-candidate POA graph alignment
(rust-mdbg src/poa.rs:781-874): a topological-order DP of (graph nodes) x
(query minimizers), run forward and reversed for up to 80 candidates per
template.  models/poa.PoaGraph runs one pair as a host numpy row-sweep;
this module runs a batch of independent pairs at once, and returns compact
op codes (the score, kind and predecessor matrices never leave the
device).

Layout.  The JAX package pads every pair to power-of-two [N, P] buckets
for XLA's static shapes; here a batch is exported as CSR with exact sizes
(`export_batch`): node offsets per pair, the node weights, each pair's
topological order, predecessor offsets and lists per node, terminal flags,
query offsets and the queries.  `kernels.poa_dp` runs the DP on it: the
CUDA kernel csrc/poa_dp.cu on the card, `poa_dp_plain` below for CPU
tensors.  Any in-degree and any graph size are taken as they come: there
is no bucket to overflow and no host DP to fall back to.

Exactness: Alignments bit-equal to PoaGraph._semiglobal_vec — the same
candidate order [M(p0), D(p0), M(p1), D(p1), ...] with the first maximum
winning, an insertion only when strictly greater, the last maximum among
terminals.  Only gap open == gap extend scoring (the default) is taken.

Graphs grow between the candidates of one template (add_alignment), so a
batch runs ACROSS templates: models/correct.run_error_correction_lockstep
aligns every active template's next candidate, forward and reversed, in
one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import u64

MIN_SCORE = -858_993_459

#: op kinds of the traceback codes
K_MATCH, K_DEL, K_INS = 0, 1, 2


def export_batch(graphs, queries) -> dict:
    """Pairs (PoaGraph, query) -> the CSR arrays `kernels.poa_dp` takes, as
    numpy: node_off int32 [G+1], wts uint64 [Ntot] (by node id), topo int32
    [Ntot] (each pair's topological order, local ids), pred_off int32
    [Ntot+1] (offsets into pred_idx by global node), pred_idx int32
    [Etot] (local ids, in the graph's pred list order), term uint8 [Ntot]
    (out-degree 0), q_off int32 [G+1], queries uint64 [Mtot]."""
    wts, topo, pdeg, pidx, term, qs = [], [], [], [], [], []
    node_off, q_off = [0], [0]
    for g, q in zip(graphs, queries):
        wts.extend(g.weights)
        topo.extend(g.topo_order())
        for pv, sv in zip(g.pred, g.succ):
            pdeg.append(len(pv))
            pidx.extend(pv)
            term.append(not sv)
        node_off.append(len(wts))
        qs.extend(int(x) for x in q)
        q_off.append(len(qs))
    pred_off = np.zeros(len(pdeg) + 1, dtype=np.int32)
    np.cumsum(pdeg, out=pred_off[1:])
    return dict(
        node_off=np.asarray(node_off, dtype=np.int32),
        wts=np.asarray(wts, dtype=np.uint64),
        topo=np.asarray(topo, dtype=np.int32),
        pred_off=pred_off,
        pred_idx=np.asarray(pidx, dtype=np.int32),
        term=np.asarray(term, dtype=np.uint8),
        q_off=np.asarray(q_off, dtype=np.int32),
        queries=np.asarray(qs, dtype=np.uint64))


def batch_to_device(batch: dict, device) -> dict:
    """export_batch's arrays as tensors on `device` (u64 as int64 bits)."""
    return {k: (u64.from_numpy(v, device) if v.dtype == np.uint64
                else torch.from_numpy(v).to(device))
            for k, v in batch.items()}


def ops_offsets(node_off: torch.Tensor, q_off: torch.Tensor
                ) -> torch.Tensor:
    """int64 [G+1] offsets of each pair's op rows: n + m + 1 rows a pair,
    the longest traceback (each M or I consumes a query symbol, each D
    steps to an earlier node in topological order, one final stop)."""
    rows = (node_off[1:] - node_off[:-1] + q_off[1:] - q_off[:-1] + 1)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=rows.device),
                      torch.cumsum(rows.long(), 0)])


def poa_dp_plain(node_off, wts, topo, pred_off, pred_idx, term, q_off,
                 queries, *, ge: int = -1, match: int = 1,
                 mismatch: int = -1):
    """Plain torch version of csrc/poa_dp.cu on export_batch's tensors.

    The pairs advance together over topological positions (the JAX
    package's vmapped `_dp_single`): each step gathers the predecessor
    rows of every pair's node, takes the first maximum over the
    interleaved match / delete candidates, closes insertions with a
    cummax, and writes the pair's score, kind and predecessor row.  Then
    per pair the last maximum among terminals at column m and the
    traceback.  Returns (best int32 [G], ystart int32 [G], nops int32
    [G], ops int32 [ops_offsets[-1], 3]): a pair's op rows (kind, pred,
    node; -1 for None) in traceback order, -1 past nops."""
    dev = wts.device
    G = node_off.numel() - 1
    noff, qoff = node_off.cpu().numpy(), q_off.cpu().numpy()
    po, pi = pred_off.cpu().numpy(), pred_idx.cpu().numpy()
    n, m = np.diff(noff), np.diff(qoff)
    N, M = int(n.max(initial=0)), int(m.max(initial=0))
    deg = np.diff(po)
    P = max(1, int(deg.max(initial=0)))
    # padded per-pair views (numpy, then one copy each): pred code -1 =
    # the virtual source row (a node without predecessors), -2 = padding
    gid = np.repeat(np.arange(G), n)
    loc = np.arange(len(gid)) - np.repeat(noff[:-1], n)
    W_ = np.zeros((G, max(N, 1)), dtype=np.int64)
    W_[gid, loc] = wts.cpu().numpy()
    T_ = np.zeros((G, max(N, 1)), dtype=np.int32)
    T_[gid, loc] = topo.cpu().numpy()
    PV = np.full((G, max(N, 1), P), -2, dtype=np.int32)
    PV[gid[deg == 0], loc[deg == 0], 0] = -1
    en = np.repeat(np.arange(len(deg)), deg)
    PV[gid[en], loc[en], np.arange(len(pi)) - po[en]] = pi
    Q_ = np.zeros((G, M), dtype=np.int64)
    qg = np.repeat(np.arange(G), m)
    Q_[qg, np.arange(len(qg)) - np.repeat(qoff[:-1], m)] = \
        queries.cpu().numpy()
    i32 = dict(dtype=torch.int32, device=dev)
    W_, T_, PV, Q_ = (torch.from_numpy(a).to(dev) for a in (W_, T_, PV, Q_))
    n, m, noff = n.tolist(), m.tolist(), noff.tolist()
    cols = torch.arange(M + 1, **i32)
    # rows: 0 = virtual source, 1..N = nodes, N+1 = MIN sentinel
    score = torch.zeros((G, N + 2, M + 1), **i32)
    score[:, 0] = cols * ge
    score[:, N + 1] = MIN_SCORE
    kind = torch.full((G, N + 1, M + 1), K_DEL, dtype=torch.int8,
                      device=dev)
    kind[:, 0] = K_INS
    kind[:, 0, 0] = K_MATCH
    predm = torch.full((G, N + 1, M + 1), -1, **i32)
    gix = torch.arange(G, device=dev)
    nt = torch.tensor(n, **i32)
    slot = torch.arange(2 * P, **i32)
    for t in range(N):
        act = gix[nt > t]
        node = T_[act, t].long()
        r = W_[act, node]
        sub = torch.where(Q_[act] == r[:, None], match, mismatch).to(
            torch.int32)
        pv = PV[act, node]                                  # [A, P]
        rowix = torch.where(pv == -1, 0,
                            torch.where(pv == -2, N + 1, pv + 1)).long()
        prows = score[act[:, None], rowix]                  # [A, P, M+1]
        m_cand = prows[:, :, :M] + sub[:, None, :]
        d_cand = prows[:, :, 1:] + ge
        m_cand = torch.where((pv == -2)[:, :, None], MIN_SCORE, m_cand)
        d_cand = torch.where((pv < 0)[:, :, None], MIN_SCORE, d_cand)
        stack = torch.stack([m_cand, d_cand], dim=2).reshape(
            len(act), 2 * P, M)
        best = stack.max(dim=1, keepdim=True).values
        arg = torch.where(stack == best, slot[None, :, None],
                          2 * P).min(dim=1).values          # first max
        cand = best[:, 0]
        k_md = (arg & 1).to(torch.int8)
        psel = pv.gather(1, (arg >> 1).long())
        p_md = torch.where(psel < 0, -1, psel)
        base = torch.cat([torch.zeros((len(act), 1), **i32), cand], dim=1)
        row = torch.cummax(base - cols * ge, dim=1).values + cols * ge
        is_ins = row[:, 1:] > cand
        ni = (node + 1)
        score[act, ni] = row
        kind[act, ni, 1:] = torch.where(is_ins, K_INS, k_md).to(torch.int8)
        predm[act, ni, 1:] = torch.where(is_ins, node[:, None].to(
            torch.int32), p_md)

    ooff = ops_offsets(node_off, q_off).tolist()
    ops = torch.full((ooff[-1], 3), -1, **i32)
    best_s = torch.zeros(G, **i32)
    ystart = torch.zeros(G, **i32)
    nops = torch.zeros(G, **i32)
    term_l = term.tolist()
    sc, kd, pr = score.cpu(), kind.cpu(), predm.cpu()
    for g in range(G):
        a = noff[g]
        last = sc[g, 1 : n[g] + 1, m[g]].tolist()
        bi, bs = -1, None
        for v in range(n[g]):  # last max wins (Rust max_by semantics)
            if term_l[a + v] and (bs is None or last[v] >= bs):
                bi, bs = v, last[v]
        i, j = bi + 1, m[g]
        rows = []
        while i > 0 and j > 0:
            k, p = int(kd[g, i, j]), int(pr[g, i, j])
            rows.append((k, p, p if k == K_INS else i - 1))
            if p >= 0:
                i = p + 1
                if k != K_DEL:
                    j -= 1
            elif k == K_MATCH:
                j -= 1
                break
            elif k == K_DEL:
                break
            else:
                i -= 1
                j -= 1
        if rows:
            ops[ooff[g] : ooff[g] + len(rows)] = torch.tensor(rows, **i32)
        best_s[g], ystart[g], nops[g] = bs, j, len(rows)
    return best_s, ystart, nops, ops


def decode_ops(best_s, ystart, nops, ops, ooff) -> list:
    """kernels.poa_dp's outputs (numpy) -> models.poa.Alignment per pair."""
    from ..models.poa import Alignment

    res = []
    for g in range(len(best_s)):
        out = []
        base = int(ooff[g])
        for t in range(int(nops[g]) - 1, -1, -1):
            k, p, nd = (int(x) for x in ops[base + t])
            if k == K_MATCH:
                out.append(("M", None, None) if p < 0 else ("M", p, nd))
            elif k == K_DEL:
                out.append(("D", None, None) if p < 0 else ("D", p, nd))
            else:
                out.append(("I", None) if p < 0 else ("I", p))
        res.append(Alignment(score=int(best_s[g]), ystart=int(ystart[g]),
                             operations=out))
    return res


def poa_semiglobal_device(graphs, queries, *, device, ge=-1, match=1,
                          mismatch=-1) -> list:
    """Align queries[i] against graphs[i] (all pairs independent) on
    `device`; returns the models.poa.Alignment equal to
    graph.semiglobal(query) for each pair."""
    from . import kernels

    if len(graphs) != len(queries):
        raise ValueError(f"{len(graphs)} graphs for {len(queries)} queries")
    if not graphs:
        return []
    t = batch_to_device(export_batch(graphs, queries), torch.device(device))
    best_s, ystart, nops, ops = kernels.poa_dp(
        t["node_off"], t["wts"], t["topo"], t["pred_off"], t["pred_idx"],
        t["term"], t["q_off"], t["queries"], ge=ge, match=match,
        mismatch=mismatch)
    ooff = ops_offsets(t["node_off"], t["q_off"]).cpu().numpy()
    return decode_ops(best_s.cpu().numpy(), ystart.cpu().numpy(),
                      nops.cpu().numpy(), ops.cpu().numpy(), ooff)
