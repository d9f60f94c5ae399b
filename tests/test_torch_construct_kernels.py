"""Port parity: the construct body's two hand kernels, by their plain
versions and by numpy models of their work split.

- compaction (csrc/compact_minimizers.cu; plain kernels.
  compact_minimizers_plain) against the JAX `_device_extract` count and
  compact outputs;
- window keys (csrc/window_keys.cu mode i; plain kernels.window_keys_plain,
  window_keys_poly_plain) against `_window_keys_poly` and the count path's
  keys;
- the slot append (csrc/window_keys.cu mode ii; plain
  kernels.slot_append_plain) against `make_fused_construct`'s buffers.

The numpy models follow each kernel's split of the work (16-column lane
masks, a warp scan of their popcounts, capped chunk counts and their
offsets; one window a thread with the half-window reversal test and the
Horner lanes; slot offsets from each read's window count) and are put in
the wrappers' place, so the extraction and the construct with them must
give the JAX package's outputs too.  Inputs come from numpy with fixed
seeds; every comparison is exact.  The two `cuda` tests hold each kernel
against its plain version on the card and skip here.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_mdbg_tpu.ops.extract import _device_extract, _window_keys_poly
from rust_mdbg_tpu.ops.sort_count import (DeviceNodeCounter as JaxCounter,
                                          make_fused_construct)
from rust_mdbg_tpu_torch.ops import extract as extract_mod
from rust_mdbg_tpu_torch.ops import kernels
from rust_mdbg_tpu_torch.ops import sort_count as sort_count_mod
from rust_mdbg_tpu_torch.ops import u64
from rust_mdbg_tpu_torch.ops.extract import (capacity, device_extract,
                                             extract_count)
from rust_mdbg_tpu_torch.ops.pack import pack_codes_np
from rust_mdbg_tpu_torch.ops.sort_count import (buffers_from_numpy,
                                                buffers_to_numpy,
                                                construct_batches,
                                                window_slot_capacity)
from rust_mdbg_tpu_torch.params import Params

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

MASK64 = (1 << 64) - 1
_A = (0x100000001B3, 0xC2B2AE3D27D4EB4F)
_OFF = (0xCBF29CE484222325, 0x9E3779B97F4A7C15)


# --- inputs -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dense_unit(l: int, hash_bound: int) -> str:
    """A homopolymer-free 4-base unit whose tandem repeat selects at least
    one of every four positions: a 512-column chunk of it holds 128 or more
    minimizers, over the chunk capacity of a low density (64 at d = 0.02),
    and its minimizer row repeats with a period of at most 4 (palindromic
    windows at odd k)."""
    for unit in itertools.product(range(4), repeat=4):
        if any(unit[i] == unit[(i + 1) % 4] for i in range(4)):
            continue
        row = np.tile(np.array(unit, dtype=np.uint8), 64)[None, :]
        _, sel = kernels.nthash_select_plain(
            torch.from_numpy(row), l, hash_bound,
            torch.tensor([256], dtype=torch.int32))
        if int(sel[0, 64:192].sum()) >= 32:
            return "".join("ACGT"[c] for c in unit)
    raise AssertionError("no dense unit at this bound")


def _reads(seed, B, L, *, hp=0.3, already_hpc=False, plant=None,
           short=True, plant_at=512):
    """Raw reads (homopolymer runs with probability hp, N and 'other'
    bases) or, with already_hpc, reads with no two equal neighbours; ragged
    lengths with rows of 0 and 5 bases and a row of L (and, with `short`,
    rows too short for one window); code 5 past each length.  `plant` =
    (l, hash_bound) writes a tandem repeat of _dense_unit over columns
    [plant_at, plant_at + 1024) of rows 3 and 4 (row 4 ends with it)."""
    rng = np.random.default_rng(seed)
    if already_hpc:
        step = rng.integers(1, 4, (B, L)).astype(np.uint8)
        step[:, 0] = rng.integers(0, 4, B)
        codes = (np.cumsum(step, axis=1) % 4).astype(np.uint8)
        codes[rng.random((B, L)) < 0.004] = 4
    else:
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        rep = rng.random((B, L)) < hp
        for j in range(1, L):
            codes[:, j] = np.where(rep[:, j], codes[:, j - 1], codes[:, j])
        codes[rng.random((B, L)) < 0.01] = 4
        codes[rng.random((B, L)) < 0.003] = 5
    lengths = rng.integers(L // 3, L + 1, B).astype(np.int32)
    lengths[:3] = [0, 5, L]
    if short:
        lengths[5:7] = [12, 16]       # at most 7 l-mers: n_min <= k = 7
    if plant is not None:
        unit = np.array(["ACGT".index(c) for c in _dense_unit(*plant)],
                        dtype=np.uint8)
        codes[3:5, plant_at : plant_at + 1024] = np.tile(unit, 256)
        lengths[3:5] = [L, plant_at + 1024]
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


#: (id, L, Params keywords, reads keywords): the two-level branch at
#: L = 4096 with rows over a chunk's capacity (their slots past the kept
#: minimizers read column L - 1), every chunk over it (d = 0.5, where also
#: nch * C < M), hashes at or above 2^63 (d = 0.9), nch * C < M by the
#: per-read override, pre-HPC'd reads, the flat branch at odd L, and
#: M == L where the JAX package also takes the flat branch (L = 2048)
CASES = [
    ("two_level_chunk_over", 4096, dict(density=0.02), dict(plant=True)),
    ("two_level_every_chunk_over", 4096, dict(density=0.5), {}),
    ("two_level_top_bit", 4096, dict(density=0.9), {}),
    ("nch_c_below_m", 2560, dict(density=0.02, max_minimizers_per_read=400),
     dict(plant=True)),
    ("two_level_prehpc", 3072, dict(density=0.02, reads_already_hpc=True),
     dict(plant=True)),
    ("flat_odd_l", 1027, dict(density=0.05), {}),
    ("flat_m_eq_l", 2048, dict(density=0.9, max_minimizers_per_read=2048),
     {}),
]
IDS = [c[0] for c in CASES]


def _case(name, B=12):
    _, L, pkw, rkw = next(c for c in CASES if c[0] == name)
    p = Params(k=7, l=10, **pkw)
    plant = (p.l, p.hash_bound) if rkw.get("plant") else None
    codes, lengths = _reads(L + len(name), B, L, plant=plant,
                            already_hpc=p.reads_already_hpc)
    return p, capacity(p, L), codes, lengths


def _jax_extract(p, M, codes, lengths, **kw):
    fn = jax.jit(functools.partial(
        _device_extract, l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
        already_hpc=p.reads_already_hpc, use_pallas=False, **kw))
    return fn(jnp.asarray(codes), jnp.asarray(lengths))


# --- numpy models of the kernels' work split ----------------------------------

def _chunk_warp(c, nch):
    """The warp that ranks chunk c of a row of nch chunks, numbered over the
    row's passes: 16 p + w for warp w of pass p, whose chunks are
    [p0 + w n_p // 16, p0 + (w + 1) n_p // 16) of the pass's n_p."""
    p = c // 48
    n_p = min(48, nch - 48 * p)
    return 16 * p + max(w for w in range(16) if w * n_p // 16 <= c - 48 * p)


#: the writer of the slots that csrc/compact_minimizers.cu's tail fill
#: writes (the block's threads in turn, after every pass)
TAIL = 99


def model_compact(sel, canon, pos_map, pme, hash_bound, M, trace=None):
    """csrc/compact_minimizers.cu's split.  A block ranks a row in passes
    of 48 chunks; a pass splits its chunks evenly over 16 warps, at most 3
    a warp, and a lane holds a 16-bit mask of each.  One warp scan of the
    lane's popcounts packed 10 bits apart (three chunks a word) ranks the
    warp's chunks; each warp's capped and raw totals and over-C flag, read
    in (pass, warp) order, give its offset; each lane keeps the bits ranked
    below C and placed below M.  The block then fills slots [min(kept, M),
    n_min) from column L - 1 and zeros above.  numpy in, numpy out; also
    returns the kept count of each row.  `trace`, a dict, receives `writer`
    [B, M]: the warp that wrote each slot (_chunk_warp's numbering), TAIL
    for the tail fill."""
    B, L = sel.shape
    two = kernels.compaction_two_level(L, M)
    C = kernels.chunk_slot_capacity(hash_bound) if two else 512
    nch = -(-L // 512)
    mh = np.zeros((B, M), np.uint64)
    mp = np.zeros((B, M), np.int32)
    mpe = None if pme is None else np.zeros((B, M), np.int32)
    n_min = np.zeros(B, np.int32)
    over = np.zeros(B, bool)
    kept_rows = np.zeros(B, np.int64)
    writer = np.full((B, M), -1, np.int16)
    bits = 1 << np.arange(16)

    def put(b, j, col, r):
        mh[b, j] = canon[b, col]
        mp[b, j] = col if pos_map is None else pos_map[b, col]
        if mpe is not None:
            mpe[b, j] = pme[b, col]
        writer[b, j] = r

    for b in range(B):
        cols = np.zeros(nch * 512, bool)
        cols[:L] = sel[b]
        lanes = cols.reshape(nch, 32, 16)
        masks = (lanes * bits).sum(axis=2)               # [nch, 32]
        cnt = lanes.sum(axis=2)
        # every warp of every pass, in order
        warps = []
        for ps in range(max(1, -(-nch // 48))):
            p0 = 48 * ps
            n_p = min(48, nch - p0)
            for w in range(16):
                q0 = p0 + w * n_p // 16
                chunks = list(range(q0, p0 + (w + 1) * n_p // 16))
                assert len(chunks) <= 3
                packed = np.zeros((1, 32), np.int64)   # one scan word
                for q, c in enumerate(chunks):
                    packed[q // 3] += (cnt[c].astype(np.int64)
                                       << (10 * (q % 3)))
                incl = np.cumsum(packed, axis=1)       # the warp scans
                t = [(int(incl[q // 3, -1]) >> (10 * (q % 3))) & 1023
                     for q in range(len(chunks))]
                warps.append(dict(warp=16 * ps + w, chunks=chunks,
                                  excl=incl - packed, t=t,
                                  kept=sum(min(x, C) for x in t),
                                  raw=sum(t),
                                  over=any(x > C for x in t)))
        before = 0
        for wp in warps:
            o = before
            for q, c in enumerate(wp["chunks"]):
                for lane in range(32):
                    rk = (int(wp["excl"][q // 3, lane]) >> (10 * (q % 3))
                          ) & 1023
                    s_q = o + rk
                    lim = min(C - rk, M - s_q)
                    m = int(masks[c, lane])
                    for _ in range(max(lim, 0)):
                        if not m:
                            break
                        put(b, s_q, c * 512 + lane * 16
                            + (m & -m).bit_length() - 1, wp["warp"])
                        m &= m - 1
                        s_q += 1
                o += min(wp["t"][q], C)
            before += wp["kept"]
        raw = sum(wp["raw"] for wp in warps)
        n_min[b] = min(raw, M)
        kept_rows[b] = before
        for j in range(min(before, M), M):
            if j < n_min[b]:
                put(b, j, L - 1, TAIL)
            else:
                writer[b, j] = TAIL
        over[b] = raw > M or (two and any(wp["over"] for wp in warps))
    if trace is not None:
        trace["writer"] = writer
    return mh, mp, mpe, n_min, over, kept_rows


#: csrc/window_keys.cu's layout: a block a row, whose four warps take
#: KEY_GROUP windows at once, KEY_LANE_WINDOWS a lane
KEY_GROUP = 256
KEY_LANE_WINDOWS = 2


def model_window_keys(mh, n_min, k, trace=None):
    """csrc/window_keys.cu's split, mode i: a block a row; lane l of the
    row's warp i computes the windows G g + 32 (LW i + h) + l (h < LW, LW
    = KEY_LANE_WINDOWS windows a lane, interleaved) of group g (G =
    KEY_GROUP), only below the row's valid windows: the
    reversal flag from the first difference among the first k // 2 pairs
    (unsigned; a palindrome is reversed), the two Horner lanes over the
    window or its reverse; the sentinel elsewhere.  `trace`, a dict, receives
    `groups` [B] (the groups each row's warps computed)."""
    B, M = mh.shape
    W = M - k + 1
    LW = KEY_LANE_WINDOWS
    keys = np.full((B, W, 2), MASK64, np.uint64)
    groups = np.zeros(B, np.int64)
    with np.errstate(over="ignore"):
        for b in range(B):
            nw = n_min[b] - k + 1 if n_min[b] > k else 0
            for g in range(-(-nw // KEY_GROUP)):
                groups[b] += 1
                w = (KEY_GROUP * g
                     + 32 * LW * np.arange(KEY_GROUP // (32 * LW))[
                         :, None, None]
                     + 32 * np.arange(LW)[None, :, None]
                     + np.arange(32)[None, None, :]).ravel()  # [i, h, lane]
                w = w[w < nw]
                v = mh[b, w[:, None] + np.arange(k)[None, :]]
                rev = np.ones(len(w), bool)
                decided = np.zeros(len(w), bool)
                for j in range(k // 2):
                    a, c = v[:, j], v[:, k - 1 - j]
                    now = ~decided & (a != c)
                    rev[now] = a[now] > c[now]
                    decided |= now
                win = np.where(rev[:, None], v[:, ::-1], v)
                for lane in (0, 1):
                    h = np.full(len(w), _OFF[lane], np.uint64)
                    for j in range(k):
                        h = h * np.uint64(_A[lane]) + win[:, j]
                    keys[b, w, lane] = h
    if trace is not None:
        trace["groups"] = groups
    return keys


def model_append(mh, n_min, k, b_lo, b_hi, b_occ, row0, slot0, S,
                 trace=None):
    """csrc/window_keys.cu's split, mode ii, in place on numpy planes: a
    block a row, T = KEY_GROUP / KEY_LANE_WINDOWS threads; thread t
    of every block reads the rows [t R, t R + R) of n_min (R = 4 ceil(B /
    (4 T))), a warp scan and the warps' totals give the block's row its
    offset and the batch total; each row's windows at slot offs[b] + w
    below S; the slot's tail [min(nv, S), S) strided over the grid (block
    b's thread t from min(nv, S) + b T + t, step B T).  Returns the
    (windows, over-slot) counts the kernel adds.  `trace`, a dict,
    receives `offs` and `fillers` (the blocks that wrote the tail)."""
    B, M = mh.shape
    W = M - k + 1
    keys = model_window_keys(mh, n_min, k)
    nw = np.where(n_min > k, n_min - k + 1, 0).astype(np.int64)
    T = KEY_GROUP // KEY_LANE_WINDOWS
    R = 4 * -(-B // (4 * T))
    mine = np.zeros(T, np.int64)
    for t in range(T):
        mine[t] = nw[t * R : t * R + R].sum()
    wt = mine.reshape(-1, 32).sum(axis=1)                # s_wt
    incl = np.cumsum(mine.reshape(-1, 32), axis=1).ravel()
    offs = np.zeros(B, np.int64)
    for b in range(B):
        t = b // R
        part = incl[t] - mine[t] + nw[t * R : b].sum()   # s_part
        offs[b] = wt[: t // 32].sum() + part
    nv = int(wt.sum())
    assert np.array_equal(offs, np.concatenate([[0], np.cumsum(nw)[:-1]]))
    for b in range(B):
        limit = int(max(0, min(nw[b], S - offs[b])))
        w = np.arange(limit)
        p = slot0 + offs[b] + w
        b_lo[p] = keys[b, w, 0]
        b_hi[p] = keys[b, w, 1]
        b_occ[p] = ((row0 + b) * W + w) & 0xFFFFFFFF
    fill0 = min(nv, S)
    tail = np.arange(fill0, S)
    fillers = sorted(set(((tail - fill0) // T % B).tolist()))
    b_lo[slot0 + tail] = MASK64
    b_hi[slot0 + tail] = MASK64
    b_occ[slot0 + tail] = 0xFFFFFFFF
    if trace is not None:
        trace.update(offs=offs, fillers=fillers, threads=T)
    return fill0, int(nv > S)


def _np(t):
    if t is None:
        return None
    return u64.to_numpy(t) if t.dtype == torch.int64 else t.numpy()


def _torch_compact(sel, canon, pos_map=None, pme=None, *, hash_bound, M):
    mh, mp, mpe, n_min, over, _ = model_compact(
        sel.numpy(), _np(canon), _np(pos_map), _np(pme), hash_bound, M)
    return (u64.from_numpy(mh, "cpu"), torch.from_numpy(mp),
            None if mpe is None else torch.from_numpy(mpe),
            torch.from_numpy(n_min), torch.from_numpy(over))


def _torch_window_keys(mh, n_min, k):
    return u64.from_numpy(model_window_keys(_np(mh), n_min.numpy(), k),
                          "cpu")


def _torch_append(mh, n_min, k, b_lo, b_hi, b_occ, *, row0, slot0, S, n_win,
                  n_over):
    planes = [u64.to_numpy(t).copy() for t in (b_lo, b_hi, b_occ)]
    nw, no = model_append(_np(mh), n_min.numpy(), k, *planes, row0, slot0, S)
    for t, a in zip((b_lo, b_hi, b_occ), planes):
        t.copy_(u64.from_numpy(a, "cpu"))
    n_win += nw
    n_over += no


@pytest.fixture
def models(monkeypatch):
    """The numpy models in the wrappers' place, where the extraction and
    the construct call them."""
    monkeypatch.setattr(extract_mod, "compact_minimizers", _torch_compact)
    monkeypatch.setattr(extract_mod, "window_keys", _torch_window_keys)
    monkeypatch.setattr(sort_count_mod, "window_keys_append", _torch_append)


# --- the compaction -------------------------------------------------------------

def _check_count_path(p, M, codes, lengths):
    oj = _jax_extract(p, M, codes, lengths, count_output=True)
    ot = extract_count(torch.from_numpy(codes), torch.from_numpy(lengths),
                       l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
                       already_hpc=p.reads_already_hpc)
    assert sorted(oj) == sorted(ot)
    for name in oj:
        got = (u64.to_numpy(ot[name]) if ot[name].dtype == torch.int64
               else ot[name].numpy())
        assert np.array_equal(np.asarray(oj[name]), got), name
    return ot


@pytest.mark.parametrize("case", IDS)
def test_compaction_plain_matches_jax(case):
    """The plain compaction, through the count path and the compact path,
    against the JAX package's: minimizer rows, positions, extent ends,
    n_min, the overflow flag, and the count path's window counts."""
    p, M, codes, lengths = _case(case)
    ot = _check_count_path(p, M, codes, lengths)
    oj = _jax_extract(p, M, codes, lengths, compact_output=True)
    oc = device_extract(torch.from_numpy(codes), torch.from_numpy(lengths),
                        l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
                        already_hpc=p.reads_already_hpc, compact_output=True)
    assert np.array_equal(np.asarray(oj["minim_hash"]),
                          u64.to_numpy(oc["minim_hash"]))
    for name in ("minim_pos", "n_min", "overflow"):
        assert np.array_equal(np.asarray(oj[name]), oc[name].numpy()), name
    assert int(ot["nw"].sum()) > 0 and (ot["nw"][5:7] == 0).all()
    if case.startswith(("two_level", "nch")):
        assert kernels.compaction_two_level(codes.shape[1], M)
        assert ot["overflow"].any()


def _selection(p, M, codes, lengths):
    """The compaction's inputs on the count path, captured from the plain
    extraction: (sel, canon, pos_map, pme) as numpy."""
    seen = {}

    def record(sel, canon, pos_map=None, pme=None, **kw):
        seen.update(sel=sel, canon=canon, pos_map=pos_map, pme=pme)
        return kernels.compact_minimizers_plain(sel, canon, pos_map, pme,
                                                **kw)

    orig = extract_mod.compact_minimizers
    extract_mod.compact_minimizers = record
    try:
        extract_count(torch.from_numpy(codes), torch.from_numpy(lengths),
                      l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
                      already_hpc=p.reads_already_hpc)
    finally:
        extract_mod.compact_minimizers = orig
    return {k: _np(v) for k, v in seen.items()}


@pytest.mark.parametrize("case", IDS)
def test_compaction_model_matches_jax(case, models):
    """The kernel's work split in numpy, in the wrapper's place: the count
    path equals the JAX package's.  On the rows over a chunk's capacity the
    slots between the kept minimizers and n_min read column L - 1."""
    p, M, codes, lengths = _case(case)
    _check_count_path(p, M, codes, lengths)
    s = _selection(p, M, codes, lengths)
    *_, n_min, over, kept = model_compact(s["sel"], s["canon"], s["pos_map"],
                                          s["pme"], p.hash_bound, M)
    if case in ("two_level_chunk_over", "two_level_every_chunk_over",
                "nch_c_below_m", "two_level_prehpc"):
        assert (kept < n_min).any() and over[kept < n_min].all()
    if case == "two_level_top_bit":
        assert (s["canon"][s["sel"]] >= np.uint64(1 << 63)).any()


@pytest.mark.parametrize("L,M", [(4096, 4096), (3072, 3072), (2048, 2048),
                                 (1027, 1027)])
def test_compaction_m_eq_l_model_matches_plain(L, M):
    """M == L (a chunk re-planned to keep every position,
    core/chunked.doubled_plan): the flat branch with no chunk cap, no
    overflow, every selected position kept.  At L % 512 == 0 and L > 2048
    the JAX package has no such branch, so the model is held against the
    plain version."""
    p = Params(k=7, l=10, density=0.9)
    codes, lengths = _reads(L, 6, L, short=False)
    canon, sel = (x.numpy() for x in kernels.nthash_select_plain(
        torch.from_numpy(codes), p.l, p.hash_bound,
        torch.from_numpy(lengths)))
    canon = canon.view(np.uint64)
    pm = np.random.default_rng(L).integers(0, 1 << 30, (6, L), np.int32)
    got = model_compact(sel, canon, pm, pm + 3, p.hash_bound, M)
    want = kernels.compact_minimizers_plain(
        torch.from_numpy(sel), u64.from_numpy(canon, "cpu"),
        torch.from_numpy(pm), torch.from_numpy(pm + 3),
        hash_bound=p.hash_bound, M=M)
    for g, w in zip(got, want):
        assert np.array_equal(g, _np(w))
    assert not got[4].any() and (got[3] == sel.sum(axis=1)).all()
    assert not kernels.compaction_two_level(L, M)


# --- the compaction's warp edges --------------------------------------------

#: (id, L, density, plant_at or None, rows kept of _reads' 12): kept columns
#: of one row on both sides of a warp boundary; a chunk over C ranked by a
#: warp past the first (chunk 5 of 8, a chunk a warp); a chunk over C as
#: the third of a warp's three chunks (the main path's width, where every
#: warp holds three); slots [kept, n_min) from column L - 1 written by the
#: tail fill; B = 1 and B = 2; a row of 49 chunks in two passes; the flat
#: branch at odd L (three chunks over three warps)
WARP_EDGES = [
    ("straddle_warps", 4096, 0.02, None, slice(None)),
    ("over_c_later_warp", 4096, 0.02, 2560, slice(None)),
    ("over_c_third_of_warp", 48 * 512, 0.02, 1024, slice(2, 6)),
    ("l_minus_1_tail", 4096, 0.02, 512, slice(None)),
    ("b1", 4096, 0.02, 512, slice(3, 4)),
    ("b2", 4096, 0.02, 512, slice(2, 4)),
    ("main_width_tail", 48 * 512, 0.02, 512, slice(2, 6)),
    ("two_passes", 49 * 512, 0.02, 512, slice(2, 6)),
    ("flat_odd_l", 1027, 0.05, None, slice(None)),
]


@pytest.mark.parametrize("edge", WARP_EDGES, ids=[e[0] for e in WARP_EDGES])
def test_compaction_warp_edges_match_jax(edge, models):
    """The compaction model at the edges of its split of a row over warps
    and passes, in the wrapper's place: the count path equals the JAX
    package's, and the edge the case names is there."""
    name, L, d, plant_at, rows = edge
    # planted rows are pre-HPC'd, so that the repeat stays at its columns
    p = Params(k=7, l=10, density=d, reads_already_hpc=plant_at is not None)
    plant = None if plant_at is None else (p.l, p.hash_bound)
    codes, lengths = _reads(L + len(name), 12, L, plant=plant,
                            plant_at=plant_at or 512,
                            already_hpc=p.reads_already_hpc)
    codes, lengths = codes[rows].copy(), lengths[rows].copy()
    M = capacity(p, L)
    _check_count_path(p, M, codes, lengths)
    s = _selection(p, M, codes, lengths)
    trace = {}
    *_, n_min, over, kept = model_compact(s["sel"], s["canon"], s["pos_map"],
                                          s["pme"], p.hash_bound, M,
                                          trace=trace)
    writer = trace["writer"]
    B = codes.shape[0]
    nch = -(-L // 512)
    two = kernels.compaction_two_level(L, M)
    C = kernels.chunk_slot_capacity(p.hash_bound) if two else 512
    counts = np.zeros((B, nch * 512), bool)
    counts[:, :L] = s["sel"]
    counts = counts.reshape(B, nch, 512).sum(axis=2)
    if name.startswith(("straddle", "flat")):
        assert any(len(set(writer[b, : min(kept[b], M)])) > 1
                   for b in range(B))
    if name.startswith("over_c"):
        rb, cb = np.nonzero(counts > C)
        assert len(cb) > 0 and over[rb].all()
        if name == "over_c_later_warp":
            assert all(_chunk_warp(c, nch) > _chunk_warp(0, nch) for c in cb)
        else:
            # every warp holds three chunks; the repeat's first chunk over
            # C is a warp's third, its second the next warp's first
            assert any(_chunk_warp(c, nch) == _chunk_warp(c - 2, nch)
                       for c in cb)
            assert len({_chunk_warp(c, nch) for c in cb}) > 1
    if name.startswith(("l_minus_1", "b1", "b2", "main_width", "two_passes")):
        short = np.nonzero(kept < n_min)[0]
        assert len(short) > 0
        for b in short:
            assert (writer[b, kept[b] : n_min[b]] == TAIL).all()
    if name.startswith("two_passes"):
        assert nch > 48 and (writer >= 16).any()


# --- the window keys ------------------------------------------------------------

def _minimizer_rows(seed, B, M, k):
    """u64 rows with values at and above 2^63, palindromic windows,
    repeated values, zeros and all-ones, and n_min from 0 past k to M."""
    rng = np.random.default_rng(seed)
    mh = rng.integers(0, 1 << 64, (B, M), dtype=np.uint64)
    mh[0, :k] = np.concatenate([mh[0, : (k + 1) // 2],
                                mh[0, : k // 2][::-1]])   # a palindrome
    mh[1] = mh[1, 0]                                       # one value
    mh[2, ::2] = mh[2, 0]                                  # period 2
    mh[3, 1::3] = np.uint64(MASK64)
    mh[4, : M // 2] = 0
    mh[5] |= np.uint64(1 << 63)
    n_min = rng.integers(0, M + 1, B).astype(np.int32)
    n_min[:6] = M
    n_min[6:9] = [0, k, k + 1]
    mh[np.arange(M)[None, :] >= n_min[:, None]] = 0
    return mh, n_min


@pytest.mark.parametrize("k,M", [(1, 12), (2, 17), (7, 64), (21, 96)])
def test_window_keys_plain_matches_jax(k, M):
    """window_keys_poly_plain against `_window_keys_poly` on every window,
    and window_keys_plain (the sentinel where invalid) against it masked as
    the count path masks it."""
    mh, n_min = _minimizer_rows(k, 12, M, k)
    kj = np.asarray(jax.jit(_window_keys_poly, static_argnums=(1, 2))(
        jnp.asarray(mh), k, M))
    t = u64.from_numpy(mh, "cpu")
    assert np.array_equal(kj, u64.to_numpy(
        kernels.window_keys_poly_plain(t, k, M)))
    W = M - k + 1
    valid = (n_min[:, None] > k) & (np.arange(W)[None, :] < n_min[:, None]
                                    - k + 1)
    want = np.where(valid[..., None], kj, np.uint64(MASK64))
    got = kernels.window_keys(t, torch.from_numpy(n_min), k)
    assert np.array_equal(want, u64.to_numpy(got))
    assert np.array_equal(want, model_window_keys(mh, n_min, k))


@pytest.mark.parametrize("case", ["two_level_chunk_over", "flat_odd_l",
                                  "two_level_top_bit"])
def test_window_keys_on_reads(case, models):
    """The count path's keys with both models in place, on reads with
    tandem repeats (repeated minimizers, palindromic windows), short rows
    and top-bit hashes."""
    p, M, codes, lengths = _case(case)
    ot = _check_count_path(p, M, codes, lengths)
    mh = u64.to_numpy(ot["mh"])
    W = M - p.k + 1
    vecs = np.lib.stride_tricks.sliding_window_view(mh, p.k, axis=1)[:, :W]
    pal = (vecs == vecs[..., ::-1]).all(axis=-1)
    valid = np.arange(W)[None, :] < ot["nw"].numpy()[:, None]
    if "plant" in dict(next(c for c in CASES if c[0] == case)[3]):
        assert (pal & valid).any()


#: (id, B, M, k, n_min pattern): an odd B; rows of M windows beside rows of
#: none; B = 1; k = 1; rows of three groups of 256 windows; rows whose
#: n_min a thread past the first warp reads (B > 128); two 16-byte n_min
#: loads a thread (B > 512)
WINDOW_EDGES = [
    ("b13_odd", 13, 64, 7, None),
    ("full_beside_empty", 16, 96, 21, "alternate"),
    ("b1", 1, 40, 7, "full"),
    ("k1_b9", 9, 12, 1, None),
    ("three_groups", 10, 700, 21, "full"),
    ("owner_past_first_warp", 264, 40, 7, None),
    ("two_loads_a_thread", 600, 24, 7, None),
]


def _edge_rows(edge):
    name, B, M, k, pattern = edge
    mh, n_min = _minimizer_rows(len(name), max(B, 9), M, k)
    mh, n_min = mh[:B].copy(), n_min[:B].copy()
    if pattern == "alternate":
        n_min[0::2], n_min[1::2] = M, 0
    elif pattern == "full":
        n_min[:] = M
    mh[np.arange(M)[None, :] >= n_min[:, None]] = 0
    return mh, n_min


@pytest.mark.parametrize("slot", ["roomy", "tight"])
@pytest.mark.parametrize("edge", WINDOW_EDGES, ids=[e[0] for e in WINDOW_EDGES])
def test_window_keys_edges_match_jax(edge, slot):
    """The window-key models at the new split's edges against the JAX
    package: the keys plane against `_window_keys_poly` masked as the count
    path masks it, and the slot append against those keys placed by the
    function's rule (each read's windows at its offset, the tail emptied,
    the counts); the plain append equal too."""
    name, B, M, k, _ = edge
    mh, n_min = _edge_rows(edge)
    W = M - k + 1
    kj = np.asarray(jax.jit(_window_keys_poly, static_argnums=(1, 2))(
        jnp.asarray(mh), k, M))
    nw = np.where(n_min > k, n_min - k + 1, 0)
    valid = np.arange(W)[None, :] < nw[:, None]
    want = np.where(valid[..., None], kj, np.uint64(MASK64))
    trace = {}
    assert np.array_equal(want, model_window_keys(mh, n_min, k, trace))
    assert np.array_equal(trace["groups"], -(-nw // KEY_GROUP))
    if name == "three_groups":
        assert (trace["groups"] == 3).all()

    nv = int(nw.sum())
    S = nv + 37 if slot == "roomy" else max(nv // 2, 1)
    slot0, row0, N = 5, 3 << 30, S + 12
    exp = [np.full(N, 7, np.uint64) for _ in range(3)]
    offs = np.concatenate([[0], np.cumsum(nw)[:-1]])
    for b in range(B):
        for w in range(nw[b]):
            q = offs[b] + w
            if q < S:
                exp[0][slot0 + q], exp[1][slot0 + q] = kj[b, w]
                exp[2][slot0 + q] = ((row0 + b) * W + w) & 0xFFFFFFFF
    exp[0][slot0 + min(nv, S) : slot0 + S] = MASK64
    exp[1][slot0 + min(nv, S) : slot0 + S] = MASK64
    exp[2][slot0 + min(nv, S) : slot0 + S] = 0xFFFFFFFF
    got = [np.full(N, 7, np.uint64) for _ in range(3)]
    trace = {}
    counts = model_append(mh, n_min, k, *got, row0, slot0, S, trace)
    assert counts == (min(nv, S), int(nv > S))
    for g, e in zip(got, exp):
        assert np.array_equal(g, e)
    tail = S - min(nv, S)
    assert len(trace["fillers"]) == min(B, -(-tail // trace["threads"]))

    planes = [u64.from_numpy(np.full(N, 7, np.uint64), "cpu")
              for _ in range(3)]
    cnt = [torch.zeros((), dtype=torch.int64) for _ in range(2)]
    t, n = u64.from_numpy(mh, "cpu"), torch.from_numpy(n_min)
    kernels.window_keys_append(t, n, k, *planes, row0=row0, slot0=slot0,
                               S=S, n_win=cnt[0], n_over=cnt[1])
    for g, e in zip(planes, exp):
        assert np.array_equal(u64.to_numpy(g), e)
    assert (int(cnt[0]), int(cnt[1])) == counts


# --- the slot append ------------------------------------------------------------

def _chunk_reads(seed, B, L, NB, p):
    plant = (p.l, p.hash_bound)
    parts = [_reads(seed + i, B, L, plant=plant if i % 2 else None,
                    already_hpc=p.reads_already_hpc) for i in range(NB)]
    return (np.concatenate([c for c, _ in parts]),
            np.concatenate([n for _, n in parts]))


@pytest.mark.parametrize("already_hpc", [False, True])
@pytest.mark.parametrize("slot", ["sized", "tight"])
@pytest.mark.parametrize("with_models", [False, True])
def test_slot_append_matches_jax(already_hpc, slot, with_models,
                                 monkeypatch):
    """construct_batches' slot append (plain, or the numpy models of both
    kernels in their wrappers' place) against `make_fused_construct`'s
    buffers and counts, over two chunks at a read base past 0: reads with
    repeats over a chunk's capacity and rows without windows; `tight`
    window slots, too few for some batches (counted in the overflow, the
    slot cut short)."""
    if with_models:
        monkeypatch.setattr(extract_mod, "compact_minimizers",
                            _torch_compact)
        monkeypatch.setattr(sort_count_mod, "window_keys_append",
                            _torch_append)
    B, L, NB = 12, 3072, 3
    p = Params(k=7, l=10, density=0.02, min_kmer_abundance=2,
               reads_already_hpc=already_hpc)
    M = capacity(p, L)
    ws = window_slot_capacity(p, B, L, M) if slot == "sized" else 16
    jc = JaxCounter(k=p.k, M=M, read_cap=2 * B * NB, node_cap=1 << 20,
                    minab=2, w_slot=ws, chunk_slots=2,
                    with_ext=not already_hpc)
    fn = make_fused_construct(p, B, L, M, NB, packed=True, w_slot=ws,
                              bf=False)
    tb = buffers_from_numpy(tuple(np.asarray(b) for b in jc.buffers), "cpu")
    counts = []
    for chunk, read_base in ((0, 0), (1, B * NB)):
        codes, lengths = _chunk_reads(10 * chunk + len(slot), B, L, NB, p)
        pk, mk = pack_codes_np(codes)
        bufs, nw, no = fn((jnp.asarray(pk), jnp.asarray(mk)),
                          jnp.asarray(lengths), jc.buffers, read_base, 0, NB)
        jc.buffers = bufs
        tw, to = construct_batches(
            p, (torch.from_numpy(pk), torch.from_numpy(mk)),
            torch.from_numpy(lengths), tb, B=B, M=M, w_slot=ws, batch_lo=0,
            batch_hi=NB, read_base=read_base)
        counts.append(((int(nw), int(no)), (int(tw), int(to))))
    for jn, tn in counts:
        assert jn == tn and tn[0] > 0 and tn[1] > 0
    for a, b in zip((np.asarray(x) for x in jc.buffers),
                    buffers_to_numpy(tb)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if slot == "tight":
        # every batch over its slot, and the reads over a chunk's capacity
        assert all(tn[1] > NB for _, tn in counts), counts


# --- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_compact_minimizers_kernel_on_card():
    """csrc/compact_minimizers.cu against its plain version (run on the
    card: `python -m pytest tests/test_torch_construct_kernels.py -m
    cuda`): every case above, a row slice, and M == L at a two-level
    width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for case in IDS + ["m_eq_l"]:
        if case == "m_eq_l":
            p, M = Params(k=7, l=10, density=0.9), 4096
            codes, lengths = _reads(7, 8, 4096)
        else:
            p, M, codes, lengths = _case(case)
        s = _selection(p, M, codes, lengths)
        args = [None if s[n] is None else torch.from_numpy(
            s[n].view(np.int64) if n == "canon" else s[n]).cuda()
            for n in ("sel", "canon", "pos_map", "pme")]
        kw = dict(hash_bound=p.hash_bound, M=M)
        want = kernels.compact_minimizers_plain(*args, **kw)
        before = kernels.compact_minimizers.launches
        got = kernels.compact_minimizers(*args, **kw)
        assert kernels.compact_minimizers.launches == before + 1
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w), case
        sliced = [None if a is None else a[1:] for a in args]
        for g, w in zip(kernels.compact_minimizers(*sliced, **kw),
                        kernels.compact_minimizers_plain(*sliced, **kw)):
            assert (g is None and w is None) or torch.equal(g, w), case
        # one row alone, through the launcher
        part = [None if a is None else a[3:4] for a in args]
        launch, got = kernels.compact_minimizers_launcher(*part, **kw)
        launch()
        for g, w in zip(got, kernels.compact_minimizers_plain(*part, **kw)):
            assert (g is None and w is None) or torch.equal(g, w), case


@pytest.mark.cuda
def test_window_keys_kernel_on_card():
    """csrc/window_keys.cu against its plain versions, the keys plane and
    the slot append (a roomy slot, one too small and an empty one), at k =
    1 to 21, at the edges of the split (WINDOW_EDGES) and at B > 1,024."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rows = [_minimizer_rows(k + 100, 40, M, k) + (k,)
            for k, M in [(1, 12), (2, 17), (7, 64), (21, 96), (21, 600)]]
    rows += [_edge_rows(e) + (e[3],) for e in WINDOW_EDGES]
    rows += [_minimizer_rows(7, 1500, 64, 7) + (7,)]   # B > 1,024
    for mh, n_min, k in rows:
        M = mh.shape[1]
        t, n = u64.from_numpy(mh, "cuda"), torch.from_numpy(n_min).cuda()
        assert torch.equal(kernels.window_keys(t, n, k),
                           kernels.window_keys_plain(t, n, k)), (k, M)
        W = M - k + 1
        for S in (len(n_min) * W, 7 * W + 3, 0):
            res = []
            for fn in (kernels.window_keys_append, None):
                planes = [torch.full((S + 50 * W,), -7, dtype=torch.int64,
                                     device="cuda") for _ in range(3)]
                cnt = [torch.full((), 5, dtype=torch.int64, device="cuda")
                       for _ in range(2)]
                kw = dict(row0=9, slot0=25, S=S, n_win=cnt[0],
                          n_over=cnt[1])
                if fn is None:
                    kernels.slot_append_plain(
                        kernels.window_keys_plain(t, n, k),
                        kernels.windows_per_read(n, k), *planes, **kw)
                else:
                    fn(t, n, k, *planes, **kw)
                res.append(planes + cnt)
            for g, w in zip(*res):
                assert torch.equal(g, w), (k, M, S)
