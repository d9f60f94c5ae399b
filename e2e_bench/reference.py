"""The plain reference: an assembly's graph and records from its FASTA.

What rust-mdbg computes for the density scheme (src/read.rs:157-211,
src/main.rs:595-781, 1006-1121), written again in plain PyTorch on the
run's device (the hashing of every position, the windows, the counting)
and NumPy (the nodes' edges and lines).  It imports nothing of the
program and takes nothing the program made: only the FASTA both sides
read, and the configuration's parameters.

- Homopolymer compression: a base equal to the one before it in its read
  is dropped (reads fed HPC'd are taken as they are); minimizer positions
  are raw positions of run starts.
- Minimizers: the canonical ntHash v1 of every l-mer of a read's HPC
  sequence, min(forward, reverse complement), kept when at most
  int(density * 2^64).
- k-min-mers: every k consecutive minimizers of a read that has more than
  k; the canonical vector is the lesser of the vector and its reversal
  (a palindrome counts as reversed).  Its seqlen is
  pos[k-1] - pos[0] + 2 and its shifts the first and last gaps (swapped
  when reversed).  The record spans the read from pos[0] to the end of
  the last l-mer's HPC extent (pos[k-1] + l for HPC'd reads), reverse
  complemented when reversed, with the last gap taken between extent ends.
- Counting: occurrences in read order then window order.  The `--bf`
  screen is one bit a key in a filter of 2^bloom_bits bits, at
  (lo ^ hi * 0x9E3779B97F4A7C15) mod 2^bloom_bits of the key's 128-bit
  Horner fingerprint (lo, hi): a key's first sighting only sets its bit,
  unless another key set it before, in which case the key counts from
  that sighting with one earlier occurrence.  A node is a key whose
  abundance reaches minabund; its id is the rank of the occurrence at
  which it did (the crossing occurrence), whose seqlen, shifts and span
  the node keeps.
- Edges: every node under the canonical forms of its (k-1)-prefix and
  suffix; for each node, for its suffix key and then its prefix key, each
  node indexed there (in id order, prefix before suffix) tried for the
  four orientation cases; presimp drops, within one key's candidates of
  two or more, an edge to a node of abundance under presimp x min(the
  highest candidate abundance, the node's own), and every edge whose
  reverse was dropped.

`control` names a guarantee to break, for the control run that shows the
comparison fails: "bloom24" screens with a 2^24-bit filter in place of the
configuration's 2^32 bits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

#: ntHash v1 seeds of A, C, G, T (N and other bases hash as 0)
SEEDS = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
         0x295549F54BE24456)
#: ASCII -> base code: A C G T -> 0..3, N -> 4, anything else -> 5
ASCII_CODE = np.full(256, 5, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    ASCII_CODE[_c] = _i
    ASCII_CODE[ord(chr(_c).lower())] = _i
ASCII_CODE[ord("N")] = ASCII_CODE[ord("n")] = 4
COMPLEMENT = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
#: Horner lanes of the node key: (multiplier, offset)
FP_LANES = ((0x100000001B3, 0xCBF29CE484222325),
            (0xC2B2AE3D27D4EB4F, 0x9E3779B97F4A7C15))
BLOOM_MUL = 0x9E3779B97F4A7C15
#: positions hashed at once on the device
HASH_BLOCK = 1 << 26
_MIN64 = -(1 << 63)


def _s64(x: int) -> int:
    """The int64 with the bits of the unsigned 64-bit x."""
    return x - (1 << 64) if x >= 1 << 63 else x


@dataclass
class Reads:
    """Reads end to end: ASCII bases and the offsets of each read."""
    seq: np.ndarray   # uint8 [bases]
    off: np.ndarray   # int64 [reads + 1]


def parse_fasta(path: str) -> Reads:
    """A FASTA of one header line and one sequence line a record."""
    with open(path, "rb") as f:
        buf = f.read()
    nl = np.flatnonzero(np.frombuffer(buf, dtype=np.uint8) == 10)
    if not buf.startswith(b">") or nl.size % 2:
        raise ValueError(f"{path}: not two lines a record")
    starts, ends = nl[0::2] + 1, nl[1::2]
    view = memoryview(buf)
    seq = b"".join(view[s:e] for s, e in zip(starts.tolist(), ends.tolist()))
    off = np.zeros(starts.size + 1, dtype=np.int64)
    np.cumsum(ends - starts, out=off[1:])
    return Reads(np.frombuffer(seq, dtype=np.uint8), off)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int64-held 64-bit words left by r."""
    r %= 64
    if r == 0:
        return x
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def minimizers(reads: Reads, l: int, density: float, already_hpc: bool,
               device) -> dict:
    """Every read's selected minimizers in read order, then position, as
    tensors on `device`: read index, raw position, raw end of the l-mer's
    HPC extent, hash (the 64 bits in an int64); and the positions hashed
    (the HPC bases)."""
    bound = min(int(float(density) * 18446744073709551616.0), 2**64 - 1)
    bound_s = torch.tensor(_s64(bound) ^ _MIN64, device=device)
    codes = torch.from_numpy(ASCII_CODE[reads.seq]).to(device)
    off = torch.from_numpy(reads.off).to(device)
    n = codes.numel()
    if already_hpc:
        hpos, hc, hoff = None, codes, off
    else:
        keep = torch.ones(n, dtype=torch.bool, device=device)
        keep[1:] = codes[1:] != codes[:-1]
        keep |= codes == 5
        keep[off[:-1][off[:-1] < n]] = True
        hpos = torch.nonzero(keep).squeeze(1)
        del keep
        hc = codes[hpos]
        hoff = torch.searchsorted(hpos, off)
    P = hc.numel()
    fseed = torch.tensor([_s64(s) for s in SEEDS] + [0, 0], device=device)
    rseed = torch.tensor([_s64(s) for s in SEEDS[::-1]] + [0, 0],
                         device=device)
    sel_idx, sel_hash = [], []
    for s in range(0, P, HASH_BLOCK):
        e = min(P, s + HASH_BLOCK)
        m = e - s
        win = torch.full((m + l - 1,), 4, dtype=torch.uint8, device=device)
        tail = min(P, e + l - 1)
        win[: tail - s] = hc[s:tail]
        fx, rx = fseed[win.long()], rseed[win.long()]
        fh = torch.zeros(m, dtype=torch.int64, device=device)
        rh = torch.zeros(m, dtype=torch.int64, device=device)
        for j in range(l):
            fh ^= _rotl(fx[j : j + m], l - 1 - j)
            rh ^= _rotl(rx[j : j + m], j)
        del fx, rx, win
        fu, ru = fh ^ _MIN64, rh ^ _MIN64
        canon_u = torch.minimum(fu, ru)
        idx = torch.arange(s, e, device=device)
        rid = torch.searchsorted(hoff, idx, right=True) - 1
        ok = (idx + l <= hoff[rid + 1]) & (canon_u <= bound_s)
        sel_idx.append(idx[ok])
        sel_hash.append(canon_u[ok] ^ _MIN64)
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    idx = torch.cat(sel_idx) if sel_idx else empty
    hsh = torch.cat(sel_hash) if sel_hash else empty
    rid = torch.searchsorted(hoff, idx, right=True) - 1
    if already_hpc:
        pos = idx - off[rid]
        ext = pos + l
    else:
        pos = hpos[idx] - off[rid]
        nxt = idx + l
        ext = torch.where(nxt < hoff[rid + 1],
                          hpos[torch.clamp(nxt, max=P - 1)],
                          off[rid + 1]) - off[rid]
    return dict(read=rid, pos=pos, ext=ext, hash=hsh, hpc_positions=int(P))


def fingerprint(vecs: torch.Tensor) -> tuple:
    """The 128-bit Horner fingerprint (lo, hi) of rows of uint64 held in
    int64, as int64 tensors (the node key, and the Bloom bit's input)."""
    out = []
    for mul, start in FP_LANES:
        h = torch.full((vecs.shape[0],), _s64(start), dtype=torch.int64,
                       device=vecs.device)
        for j in range(vecs.shape[1]):
            h = h * _s64(mul) + vecs[:, j]
        out.append(h)
    return out[0], out[1]


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b, lexicographically over rows of uint64 held in
    int64."""
    ne = a != b
    first = ne.to(torch.int32).argmax(dim=1, keepdim=True)
    x = torch.gather(a, 1, first)[:, 0] ^ _MIN64
    y = torch.gather(b, 1, first)[:, 0] ^ _MIN64
    return ne.any(dim=1) & (x < y)


def _groups(keys: tuple, by: int) -> tuple[np.ndarray, np.ndarray]:
    """Stable order of the rows by the keys (first key primary) and the
    start of each run of rows equal in the first `by` keys."""
    order = np.lexsort(keys[::-1])
    if order.size == 0:
        return order, np.zeros(0, dtype=np.int64)
    new = np.zeros(order.size, dtype=bool)
    new[0] = True
    for k in keys[:by]:
        ks = k[order]
        new[1:] |= ks[1:] != ks[:-1]
    return order, np.flatnonzero(new)


@dataclass
class Graph:
    """The reference's nodes, in id order, and its GFA text."""
    k: int
    vec: np.ndarray       # uint64 [nodes, k] canonical vectors
    abundance: np.ndarray
    seqlen: np.ndarray
    shift0: np.ndarray    # the GFA's pair
    shift1: np.ndarray
    seq_shift0: np.ndarray  # the record's pair
    seq_shift1: np.ndarray
    rev: np.ndarray
    start: np.ndarray     # absolute offsets into the reads' bases
    end: np.ndarray
    gfa_lines: list
    counts: dict
    seconds: dict

    def record(self, reads: Reads, i: int) -> str:
        """Node i's .sequences line, without its newline."""
        seq = reads.seq[self.start[i] : self.end[i]].tobytes()
        if self.rev[i]:
            seq = seq.translate(COMPLEMENT)[::-1]
        mins = ", ".join(str(v) for v in self.vec[i].tolist())
        return (f"{i}\t[{mins}]\t{seq.decode()}\t*\t*\t"
                f"({self.seq_shift0[i]}, {self.seq_shift1[i]})")


def assemble(reads: Reads, params: dict, device="cpu",
             control: str | None = None) -> Graph:
    """The graph and records of `reads` under the configuration's
    params (k, l, density, min_kmer_abundance, use_bf,
    reads_already_hpc; presimp 0.01 and 2^32 Bloom bits unless given)."""
    k, l = params["k"], params["l"]
    minab = params["min_kmer_abundance"]
    already = params.get("reads_already_hpc", False)
    bloom_bits = params.get("bloom_log2_bits", 32)
    if control == "bloom24":
        bloom_bits = 24
    elif control is not None:
        raise ValueError(f"control {control!r}")
    presimp = params.get("presimp", 0.01)

    t = [time.perf_counter()]
    mz = minimizers(reads, l, params["density"], already, device)
    t.append(time.perf_counter())
    # the windows: k consecutive minimizers of a read with more than k
    read, pos, ext = mz["read"], mz["pos"], mz["ext"]
    R = reads.off.size - 1
    off = torch.from_numpy(reads.off).to(device)
    n_per = torch.bincount(read, minlength=R)
    first = torch.zeros(R + 1, dtype=torch.int64, device=device)
    first[1:] = torch.cumsum(n_per, 0)
    j = torch.arange(read.numel(), device=device) - first[read]
    nr = n_per[read]
    ws = torch.nonzero((nr > k) & (j <= nr - k)).squeeze(1)
    W = ws.numel()
    vec = mz["hash"][ws[:, None] + torch.arange(k, device=device)]
    rvec = vec.flip(1)
    rev = ~lex_less(vec, rvec)
    canon = torch.where(rev[:, None], rvec, vec)
    del vec, rvec
    p0, p1 = pos[ws], pos[ws + 1]
    pl, pl2 = pos[ws + k - 1], pos[ws + k - 2]
    d_first, d_last = p1 - p0, pl - pl2
    seqlen = pl - p0 + 2
    if already:
        end, d_last_e = pl + l, d_last
    else:
        end, d_last_e = ext[ws + k - 1], ext[ws + k - 1] - ext[ws + k - 2]
    start = off[read[ws]] + p0
    t.append(time.perf_counter())

    # count the keys in occurrence order (window order is read order, then
    # position), with the Bloom screen on each key's first sighting
    lo, hi = fingerprint(canon)
    order = torch.argsort(lo, stable=True)
    order = order[torch.argsort(hi[order], stable=True)]
    new = torch.ones(W, dtype=torch.bool, device=device)
    new[1:] = (hi[order][1:] != hi[order][:-1]) | (lo[order][1:]
                                                   != lo[order][:-1])
    gstart = torch.nonzero(new).squeeze(1)
    gcount = torch.diff(gstart, append=torch.tensor([W], device=device))
    gfirst = order[gstart]  # a stable order keeps each key's window order
    hit = torch.zeros_like(gstart)
    if params.get("use_bf", False) and minab > 1:
        bit = (lo[gfirst] ^ (hi[gfirst] * _s64(BLOOM_MUL))) & (
            (1 << bloom_bits) - 1)
        o = torch.argsort(gfirst)
        o = o[torch.argsort(bit[o], stable=True)]
        earliest = torch.ones_like(o, dtype=torch.bool)
        earliest[1:] = bit[o][1:] != bit[o][:-1]
        hit[o] = 1
        hit[o[earliest]] = 0
    abundance = gcount + hit
    crossing = minab - hit  # 1-based occurrence at which it crosses
    node = abundance >= minab
    cross_w = order[gstart[node] + crossing[node] - 1]
    w, ids = torch.sort(cross_w)
    ab = abundance[node][ids]
    rw = rev[w]

    def host(x):
        return x.cpu().numpy()

    g = Graph(k=k, vec=host(canon[w]).view(np.uint64), abundance=host(ab),
              seqlen=host(seqlen[w]),
              shift0=host(torch.where(rw, d_last[w], d_first[w])),
              shift1=host(torch.where(rw, d_first[w], d_last[w])),
              seq_shift0=host(torch.where(rw, d_last_e[w], d_first[w])),
              seq_shift1=host(torch.where(rw, d_first[w], d_last_e[w])),
              rev=host(rw), start=host(start[w]),
              end=host(start[w] - p0[w] + end[w]),
              gfa_lines=[], counts={}, seconds={})
    t.append(time.perf_counter())
    g.gfa_lines = gfa_lines(g, presimp)
    t.append(time.perf_counter())
    g.seconds = dict(zip(("minimizers", "windows", "count", "edges"),
                         np.diff(t).tolist()))
    g.counts = dict(reads=R, bases=int(reads.off[-1]),
                    hpc_positions=mz["hpc_positions"],
                    minimizers=int(read.numel()), windows=int(W),
                    keys=int(gstart.numel()), nodes=int(w.numel()),
                    edges=len(g.gfa_lines) - 1 - int(w.numel()))
    return g


def gfa_lines(g: Graph, presimp: float) -> list:
    """The GFA's lines: the header, S lines in id order, L lines in the
    order the node loop finds them."""
    N = g.vec.shape[0]
    lines = ["H\tVN:Z:1.0"]
    lines += [f"S\t{i}\t*\tLN:i:{s}\tKC:i:{a}" for i, (s, a) in
              enumerate(zip(g.seqlen.tolist(), g.abundance.tolist()))]
    if N == 0:
        return lines
    v = torch.from_numpy(g.vec.view(np.int64))
    suf, pre = v[:, 1:], v[:, :-1]

    def host(pair):
        return [x.numpy() for x in pair]

    fs, fsr = host(fingerprint(suf)), host(fingerprint(suf.flip(1)))
    fp, fpr = host(fingerprint(pre)), host(fingerprint(pre.flip(1)))
    s_fwd = (~lex_less(suf.flip(1), suf)).numpy()  # suffix <= its reversal
    p_fwd = (~lex_less(pre.flip(1), pre)).numpy()
    key_s = [np.where(s_fwd, a, b) for a, b in zip(fs, fsr)]
    key_p = [np.where(p_fwd, a, b) for a, b in zip(fp, fpr)]
    # index entries (key, node, slot): slot 0 the prefix, 1 the suffix
    node = np.repeat(np.arange(N), 2)
    slot = np.tile(np.array([0, 1]), N)
    klo = np.stack([key_p[0], key_s[0]], axis=1).ravel()
    khi = np.stack([key_p[1], key_s[1]], axis=1).ravel()
    order, gstart = _groups((khi, klo, node, slot), 2)
    gsize = np.diff(np.append(gstart, order.size))
    gid = np.repeat(np.arange(gstart.size), gsize)
    # every (entry a, entry b) of one key: a is node i's query by that
    # key, b a candidate
    ea = np.repeat(order, gsize[gid])
    rank = np.arange(ea.size) - np.repeat(
        np.cumsum(np.append(0, gsize[gid][:-1])), gsize[gid])
    eb = order[np.repeat(gstart[gid], gsize[gid]) + rank]
    i, qa = node[ea], slot[ea]
    jn, sb = node[eb], slot[eb]
    same = lambda x, y, a, b: (x[0][a] == y[0][b]) & (x[1][a] == y[1][b])
    tests = [same(fs, fp, i, jn), same(fs, fsr, i, jn),
             same(fpr, fp, i, jn), same(fpr, fsr, i, jn)]
    ii = np.concatenate([i] * 4)
    jj = np.concatenate([jn] * 4)
    t = np.repeat(np.arange(4), i.size)
    hit = np.concatenate(tests)
    ii, jj, t = ii[hit], jj[hit], t[hit]
    q = np.concatenate([1 - qa] * 4)[hit]  # the suffix key first
    sbb = np.concatenate([sb] * 4)[hit]
    emit = np.lexsort((t, sbb, jj, q, ii))
    ii, jj, t, q = ii[emit], jj[emit], t[emit], q[emit]
    ab = g.abundance.astype(np.int64)
    # presimp within each (node, key) group of candidates
    grp_new = np.ones(ii.size, dtype=bool)
    grp_new[1:] = (ii[1:] != ii[:-1]) | (q[1:] != q[:-1])
    gs = np.flatnonzero(grp_new)
    gn = np.diff(np.append(gs, ii.size))
    ab_max = np.maximum.reduceat(ab[jj], gs) if gs.size else gs
    ab_ref = np.minimum(ab_max, ab[ii[gs]])
    gsz = np.repeat(gn, gn)
    drop = ((presimp > 0.0) & (gsz >= 2)
            & (ab[jj] < presimp * np.repeat(ab_ref, gn).astype(np.float64)))
    if drop.any():
        removed = np.unique(ii[drop] * N + jj[drop])
        keep = ~drop & ~np.isin(ii * N + jj, removed) & ~np.isin(
            jj * N + ii, removed)
    else:
        keep = np.ones(ii.size, dtype=bool)
    ii, jj, t = ii[keep], jj[keep], t[keep]
    plus1 = t < 2
    shift = np.where(plus1, g.shift0[ii], g.shift1[ii])
    overlap = np.minimum(g.seqlen[ii] - shift, g.seqlen[jj] - 1) % (1 << 32)
    o1 = np.where(plus1, "+", "-")
    o2 = np.where(t % 2 == 0, "+", "-")
    lines += [f"L\t{a}\t{b}\t{c}\t{d}\t{e}M" for a, b, c, d, e in
              zip(ii.tolist(), o1.tolist(), jj.tolist(), o2.tolist(),
                  overlap.tolist())]
    return lines
