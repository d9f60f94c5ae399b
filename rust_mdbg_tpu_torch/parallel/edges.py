"""Distributed mdBG edge construction and GFA emission over a shard mesh.

Counterpart of the JAX package's `parallel/edges.py`: the edge phase of
rust-mdbg (src/main.rs:1014-1117) without ever holding the whole node
table, or a global km_index, on one shard.  Two all_to_all rounds replace
the shared hash join:

  round 1 (key owner): every shard emits 4 records per node it holds — 2
    km_index entries (normalized prefix key at order 2j, suffix at 2j + 1;
    main.rs:1023-1032) and 2 probes (suffix key at order 2i, prefix at
    2i + 1; main.rs:1041-1056) — each with the node's global id, the
    fingerprints its side of the 4 orientation tests needs and (entries
    only in use) abundance and seqlen.  Records route to owner = key_lo mod
    n; each owner sorts them by (key, probe flag, order), so every probe
    lands behind the entries of its key in insertion order, and tests the
    probe against them G_SLOTS at a time: a G_SLOTS x 4 case bitmask per
    block, its bit-sliced popcount, and a binary bit-select give each POT
    candidate with its rank in the probe's emission order.

  round 2 (probe owner): POT records route to the shard whose id range
    holds the probe's node (ids are contiguous per shard); sorted by
    (probe order, rank) they are the single-chip host join's emission
    order, so per-shard L lines concatenate, after the per-shard S lines,
    into the GFA the gathered join writes, byte for byte.

  host (per shard): presimp (main.rs:1086-1090) is per (probe, key) group,
    local after round 2, and compares in float64.  The deferred symmetric
    drop (main.rs:1107-1117) is the one global datum: the removed (i, j)
    pairs are exchanged and every shard filters its writes against their
    union.

What the JAX join carries for XLA's static shapes has no counterpart:
record and POT routes are sized from the data, and a probe with more than
G_SLOTS candidates takes as many bitmask blocks as it needs, so nothing
overflows and nothing falls back to the gathered join.  The JAX records tag
a probe by OR-ing 1 << 32 onto its order, which collides with real orders
past 2^31 nodes; here the probe flag is a column of its own.

Records and POT rows are int64 matrices, one row each, so that one
all_to_all moves every plane.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import u64
from ..ops.kminmer import fingerprint128, le_rev
from .sharded import bucket_by_owner, owner_of

G_SLOTS = 16  # candidates per bitmask block: 16 x 4 cases = 64 bits

# record columns
_KLO, _KHI, _PROBE, _ORD, _ALO, _AHI, _BLO, _BHI, _GID, _AB, _LEN = range(11)
# POT columns
_PORD, _PRANK, _PJ, _PC, _PAB, _PLEN = range(6)


def overlap_key_planes(vec: torch.Tensor):
    """Per-node (k-1)-overlap fingerprints of canonical k-vectors [m, k]:
    (Fs, Fp, FsR, FpR, ksuf, kpre), each int64 [m, 2] — the suffix, the
    prefix, both reversed, and the normalized suffix and prefix keys."""
    suf, pre = vec[:, 1:], vec[:, :-1]
    Fs, Fp = fingerprint128(suf), fingerprint128(pre)
    FsR, FpR = fingerprint128(suf.flip(1)), fingerprint128(pre.flip(1))
    ksuf = torch.where(le_rev(suf)[:, None], Fs, FsR)
    kpre = torch.where(le_rev(pre)[:, None], Fp, FpR)
    return Fs, Fp, FsR, FpR, ksuf, kpre


def join_records(vec, count, seqlen, base: int) -> torch.Tensor:
    """One shard's round-1 records, int64 [4m, 11]: entries (kpre @ 2g,
    ksuf @ 2g + 1; A, B = Fp, FsR) then probes (ksuf @ 2g, kpre @ 2g + 1;
    A, B = Fs, FpR), for the nodes of global ids base + [0, m)."""
    m = vec.shape[0]
    dev = vec.device
    Fs, Fp, FsR, FpR, ksuf, kpre = overlap_key_planes(vec)
    gid = base + torch.arange(m, dtype=torch.int64, device=dev)
    tail = torch.stack([gid, count.to(torch.int64),
                        seqlen.to(torch.int64)], dim=1)

    def block(key, ki, probe, A, B):
        cols = torch.empty((m, 2), dtype=torch.int64, device=dev)
        cols[:, 0] = probe
        cols[:, 1] = 2 * gid + ki
        return torch.cat([key, cols, A, B, tail], dim=1)

    return torch.cat([block(kpre, 0, 0, Fp, FsR), block(ksuf, 1, 0, Fp, FsR),
                      block(ksuf, 0, 1, Fs, FpR), block(kpre, 1, 1, Fs, FpR)])


def _select_bit(mask: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Index of the r-th (0-based) set bit of each 64-bit mask, by binary
    search on popcounts of the low half, quarter, ...  lane + w never
    passes 64, so an arithmetic shift masked to w bits is exact."""
    lane = torch.zeros_like(r)
    w = 32
    while w >= 1:
        c = u64.popcount((mask >> lane) & ((1 << w) - 1))
        go = r >= c
        r = torch.where(go, r - c, r)
        lane = torch.where(go, lane + w, lane)
        w //= 2
    return lane


def local_join(rec: torch.Tensor) -> torch.Tensor:
    """The key owner's sort-join of its received records -> POT rows int64
    [P, 6] (probe order, rank in the probe's emission order, candidate id,
    (ki << 2) | case, candidate abundance, candidate seqlen)."""
    dev = rec.device
    perm = u64.lexsort([rec[:, _KLO], rec[:, _KHI], rec[:, _PROBE],
                        rec[:, _ORD]], [True, True, False, False])
    s = rec[perm]
    del perm
    N = s.shape[0]
    pos = torch.arange(N, device=dev)
    head = torch.ones(N, dtype=torch.bool, device=dev)
    head[1:] = (s[1:, _KLO] != s[:-1, _KLO]) | (s[1:, _KHI] != s[:-1, _KHI])
    glo = torch.cummax(torch.where(head, pos, 0), dim=0).values
    is_entry = (s[:, _PROBE] == 0).long()
    ent_before = torch.cumsum(is_entry, dim=0) - is_entry
    # a probe's candidates: its group's entries, all sorted in front of it
    gcount = ent_before - ent_before[glo]
    probes = torch.nonzero((s[:, _PROBE] == 1) & (gcount > 0)).flatten()
    nblk = (gcount[probes] + G_SLOTS - 1) // G_SLOTS
    # one virtual row per block of G_SLOTS candidates of a probe
    vp = torch.repeat_interleave(probes, nblk)
    v_first = torch.repeat_interleave(torch.cumsum(nblk, 0) - nblk, nblk)
    blk = torch.arange(vp.shape[0], device=dev) - v_first
    g = torch.arange(G_SLOTS, device=dev)
    slot = blk[:, None] * G_SLOTS + g[None, :]
    ok = slot < gcount[vp][:, None]
    epos = torch.where(ok, glo[vp][:, None] + slot, 0)
    ea, eb = s[epos, _ALO:_AHI + 1], s[epos, _BLO:_BHI + 1]
    pa = s[vp, _ALO:_AHI + 1][:, None, :]
    pb = s[vp, _BLO:_BHI + 1][:, None, :]
    # fs1 == fp2 (++), fs1 == fsr2 (+-), fpr1 == fp2 (-+), fpr1 == fsr2 (--)
    cases = torch.stack([(pa == ea).all(-1), (pa == eb).all(-1),
                         (pb == ea).all(-1), (pb == eb).all(-1)], dim=-1)
    cases &= ok[..., None]
    bit = g[:, None] * 4 + torch.arange(4, device=dev)[None, :]
    # distinct bits: the sum is their OR (bit 63 wraps to the sign bit)
    mask = torch.where(cases, torch.ones((), dtype=torch.int64, device=dev)
                       << bit, 0).sum(dim=(1, 2))
    cnt = u64.popcount(mask)
    cum = torch.cumsum(cnt, 0)
    n_pot = int(cnt.sum())
    if n_pot == 0:
        return torch.zeros((0, 6), dtype=torch.int64, device=dev)
    sidx = torch.arange(n_pot, device=dev)
    v_of = torch.searchsorted(cum, sidx, right=True)
    excl = cum - cnt
    lane = _select_bit(mask[v_of], sidx - excl[v_of])
    prow = vp[v_of]
    erow = epos[v_of, lane >> 2]
    ordv = s[prow, _ORD]
    # rank: position among the POT rows of the probe's first block on
    rank = sidx - excl[v_first[v_of]]
    return torch.stack([ordv, rank, s[erow, _GID],
                        (lane & 3) | ((ordv & 1) << 2), s[erow, _AB],
                        s[erow, _LEN]], dim=1)


def sharded_edge_join(mesh, shards: list, bases: list) -> list:
    """The two-round join.  shards[i] (this process's shard i): dict of
    vec [m, k], count [m], meta [m, mc] (seqlen in column 0) on the
    shard's device and its id base; bases: the n + 1 id bases (the last
    is the node total).  Returns per local shard its POT rows int64
    [P, 6] in emission order for its own id range."""
    n = mesh.n
    sends = []
    for sh in shards:
        rec = join_records(sh["vec"], sh["count"], sh["meta"][:, 0],
                           sh["base"])
        sends.append(bucket_by_owner(rec, owner_of(rec[:, _KLO], n), n))
    recv = mesh.all_to_all(sends)
    del sends
    sends = []
    for rec, dev in zip(recv, mesh.devices):
        pot = local_join(rec)
        starts = torch.tensor(bases[:-1], dtype=torch.int64, device=dev)
        owner = torch.searchsorted(starts, pot[:, _PORD] >> 1, right=True) - 1
        sends.append(bucket_by_owner(pot, owner, n))
    del recv
    out = []
    for pot in mesh.all_to_all(sends):
        perm = u64.lexsort([pot[:, _PORD], pot[:, _PRANK]], [False, False])
        out.append(pot[perm])
    return out


def presimp_pass(pot_ord, pot_j, pot_ab, local_ab, id_base, presimp: float):
    """Per-(probe, key) presimp rule (main.rs:1086-1090) over a shard's
    emission-ordered POT -> (removed pairs as u64 i << 32 | j, keep mask).
    The symmetric drop comes later, against the global removed union."""
    m = len(pot_ord)
    if m == 0:
        return np.zeros((0,), dtype=np.uint64), np.zeros(0, dtype=bool)
    i_gid = (pot_ord >> 1).astype(np.int64)
    ab_i = local_ab[i_gid - id_base]
    heads = np.concatenate([[True], pot_ord[1:] != pot_ord[:-1]])
    gidx = np.cumsum(heads) - 1
    n_g = int(gidx[-1]) + 1
    gmax = np.zeros(n_g, dtype=np.int64)
    np.maximum.at(gmax, gidx, pot_ab.astype(np.int64))
    gsize = np.bincount(gidx, minlength=n_g)
    ab_ref = np.minimum(gmax[gidx], ab_i.astype(np.int64)).astype(np.float64)
    removed = (presimp > 0.0) & (gsize[gidx] >= 2) \
        & (pot_ab.astype(np.float64) < presimp * ab_ref)
    pairs = (i_gid.astype(np.uint64) << np.uint64(32)) \
        | pot_j.astype(np.uint64)
    return np.unique(pairs[removed]), ~removed


def emit_l_lines(pot, keep, removed_union, local_seqlen, local_shift0,
                 local_shift1, id_base) -> tuple[str, int]:
    """A shard's L lines in emission order, the symmetric drop applied
    against the global removed union (main.rs:1107-1117) -> (text, edges
    written)."""
    if len(pot) == 0:
        return "", 0
    pot_j = pot[:, _PJ]
    i_gid = pot[:, _PORD] >> 1
    loc = i_gid - id_base
    fwd = (i_gid.astype(np.uint64) << np.uint64(32)) | pot_j.astype(np.uint64)
    rev = (pot_j.astype(np.uint64) << np.uint64(32)) | i_gid.astype(np.uint64)
    drop = np.isin(fwd, removed_union) | np.isin(rev, removed_union)
    write = keep & ~drop
    case = pot[:, _PC] & 3
    shift = np.where(case < 2, local_shift0[loc], local_shift1[loc]) \
        .astype(np.int64)
    overlap = np.minimum(local_seqlen[loc].astype(np.int64) - shift,
                         pot[:, _PLEN] - 1)
    ori1 = np.where(case < 2, "+", "-")
    ori2 = np.where((case & 1) == 0, "+", "-")
    text = "".join(
        f"L\t{i_gid[t]}\t{ori1[t]}\t{pot_j[t]}\t{ori2[t]}\t{overlap[t]}M\n"
        for t in np.nonzero(write)[0])
    return text, int(write.sum())


def s_lines(base: int, seqlen: np.ndarray, count: np.ndarray) -> str:
    return "".join(f"S\t{base + i}\t*\tLN:i:{int(sl)}\tKC:i:{int(ab)}\n"
                   for i, (sl, ab) in enumerate(zip(seqlen.tolist(),
                                                    count.tolist())))


def gfa_parts(mesh, shards: list, bases: list, presimp: float):
    """The distributed edge phase: the join, presimp per shard, the removed
    pairs exchanged, and per local shard its S-line and L-line text.
    shards[i] holds vec, count, meta (u32 values, int64) on the device and
    its id base.  Returns ([(s_text, l_text)] per local shard, edges
    written here, presimp removals here)."""
    pots = sharded_edge_join(mesh, shards, bases)
    host = []
    removed_parts = []
    for sh, pot in zip(shards, pots):
        pot = pot.cpu().numpy()
        meta = sh["meta"].cpu().numpy()
        count = sh["count"].cpu().numpy()
        rem, keep = presimp_pass(pot[:, _PORD], pot[:, _PJ], pot[:, _PAB],
                                 count, sh["base"], presimp)
        removed_parts.append(rem)
        host.append((pot, keep, meta, count))
    mine = (np.concatenate(removed_parts) if removed_parts
            else np.zeros(0, np.uint64))
    union = np.unique(np.concatenate(mesh.gather_objects(mine)))
    parts = []
    nb_edges = n_removed = 0
    for sh, (pot, keep, meta, count) in zip(shards, host):
        l_text, ne = emit_l_lines(pot, keep, union, meta[:, 0],
                                  meta[:, 1] & 0x7FFFFFFF,
                                  meta[:, 2] & 0x7FFFFFFF, sh["base"])
        parts.append((s_lines(sh["base"], meta[:, 0], count), l_text))
        nb_edges += ne
        n_removed += int((~keep).sum())
    return parts, nb_edges, n_removed


def route_records(mesh, shards: list, B: int, B_host: int, d_local: int):
    """Route each node's .sequences payload (gid, meta, vec) to a shard of
    the process that loaded its crossing read: meta[:, 4] is the global
    read row, and within a round a process's rows are contiguous, so its
    process is (row mod B) // B_host; records spread over that process's
    shards by gid.  Each record crosses once, to one process, so no process
    holds another's node payloads.  Returns per local shard its received
    rows int64 [r, 1 + mc + k], in source shard order."""
    n = mesh.n
    sends = []
    for sh in shards:
        m = sh["vec"].shape[0]
        gid = sh["base"] + torch.arange(m, device=sh["vec"].device)
        host = (sh["meta"][:, 4] % B) // B_host
        owner = host * d_local + gid % d_local
        rows = torch.cat([gid[:, None], sh["meta"], sh["vec"]], dim=1)
        sends.append(bucket_by_owner(rows, owner, n))
    return mesh.all_to_all(sends)
