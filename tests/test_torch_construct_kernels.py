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
           short=True):
    """Raw reads (homopolymer runs with probability hp, N and 'other'
    bases) or, with already_hpc, reads with no two equal neighbours; ragged
    lengths with rows of 0 and 5 bases and a row of L (and, with `short`,
    rows too short for one window); code 5 past each length.  `plant` =
    (l, hash_bound) writes a tandem repeat of _dense_unit over columns
    [512, 1536) of rows 3 and 4 (row 4 ends with it)."""
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
        codes[3:5, 512:1536] = np.tile(unit, 256)
        lengths[3:5] = [L, 1536]
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

def model_compact(sel, canon, pos_map, pme, hash_bound, M):
    """csrc/compact_minimizers.cu's split: per row, per 512-column chunk, a
    16-bit mask a lane, the warp's inclusive scan of the masks' popcounts,
    the chunk counts capped at C and their exclusive scan (the chunk
    offsets); each lane's set bits written at offset + chunk rank while the
    rank is below C and the slot below M; then slots [min(kept, M), n_min)
    from column L - 1 and zeros above.  numpy in, numpy out; also returns
    the kept count of each row."""
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
    bits = 1 << np.arange(16)

    def put(b, j, col):
        mh[b, j] = canon[b, col]
        mp[b, j] = col if pos_map is None else pos_map[b, col]
        if mpe is not None:
            mpe[b, j] = pme[b, col]

    for b in range(B):
        cols = np.zeros(nch * 512, bool)
        cols[:L] = sel[b]
        lanes = cols.reshape(nch, 32, 16)
        masks = (lanes * bits).sum(axis=2)               # [nch, 32]
        cnt = lanes.sum(axis=2)
        incl = np.cumsum(cnt, axis=1)                    # the warp scan
        total = incl[:, -1]
        kept = np.minimum(total, C)
        offs = np.concatenate([[0], np.cumsum(kept)[:-1]])
        for c in range(nch):
            for lane in range(32):
                m, r = int(masks[c, lane]), int(incl[c, lane] - cnt[c, lane])
                while m and r < C:
                    j = int(offs[c]) + r
                    if j >= M:
                        break
                    put(b, j, c * 512 + lane * 16 + (m & -m).bit_length() - 1)
                    m &= m - 1
                    r += 1
        raw = int(total.sum())
        n_min[b] = min(raw, M)
        kept_rows[b] = int(kept.sum())
        for j in range(min(kept_rows[b], M), n_min[b]):
            put(b, j, L - 1)
        over[b] = raw > M or (two and bool((total > C).any()))
    return mh, mp, mpe, n_min, over, kept_rows


def model_window_keys(mh, n_min, k):
    """csrc/window_keys.cu's split, mode i: one window a thread; the
    reversal flag from the first difference among the first k // 2 pairs
    (unsigned; a palindrome is reversed), the two Horner lanes over the
    window or its reverse; the sentinel past each read's valid windows."""
    B, M = mh.shape
    W = M - k + 1
    keys = np.full((B, W, 2), MASK64, np.uint64)
    with np.errstate(over="ignore"):
        for b in range(B):
            nw = n_min[b] - k + 1 if n_min[b] > k else 0
            if not nw:
                continue
            v = np.lib.stride_tricks.sliding_window_view(mh[b], k)[:nw]
            rev = np.ones(nw, bool)
            decided = np.zeros(nw, bool)
            for j in range(k // 2):
                a, c = v[:, j], v[:, k - 1 - j]
                now = ~decided & (a != c)
                rev[now] = a[now] > c[now]
                decided |= now
            win = np.where(rev[:, None], v[:, ::-1], v)
            for lane in (0, 1):
                h = np.full(nw, _OFF[lane], np.uint64)
                for j in range(k):
                    h = h * np.uint64(_A[lane]) + win[:, j]
                keys[b, :nw, lane] = h
    return keys


def model_append(mh, n_min, k, b_lo, b_hi, b_occ, row0, slot0, S):
    """csrc/window_keys.cu's split, mode ii, in place on numpy planes:
    offsets from each read's window count (exclusive sum), each window at
    slot offs[b] + w below S, the rest of the slot emptied.  Returns the
    (windows, over-slot) counts the kernel adds."""
    B, M = mh.shape
    W = M - k + 1
    keys = model_window_keys(mh, n_min, k)
    nw = np.where(n_min > k, n_min - k + 1, 0).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(nw)[:-1]])
    nv = int(nw.sum())
    for b in range(B):
        w = np.arange(nw[b])
        p = offs[b] + w
        keep = p < S
        b_lo[slot0 + p[keep]] = keys[b, w[keep], 0]
        b_hi[slot0 + p[keep]] = keys[b, w[keep], 1]
        b_occ[slot0 + p[keep]] = ((row0 + b) * W + w[keep]) & 0xFFFFFFFF
    fill = slice(slot0 + min(nv, S), slot0 + S)
    b_lo[fill] = MASK64
    b_hi[fill] = MASK64
    b_occ[fill] = 0xFFFFFFFF
    return min(nv, S), int(nv > S)


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


@pytest.mark.cuda
def test_window_keys_kernel_on_card():
    """csrc/window_keys.cu against its plain versions, the keys plane and
    the slot append (a roomy slot and one too small), at k = 1 to 21."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for k, M in [(1, 12), (2, 17), (7, 64), (21, 96), (21, 600)]:
        mh, n_min = _minimizer_rows(k + 100, 40, M, k)
        t, n = u64.from_numpy(mh, "cuda"), torch.from_numpy(n_min).cuda()
        assert torch.equal(kernels.window_keys(t, n, k),
                           kernels.window_keys_plain(t, n, k)), (k, M)
        W = M - k + 1
        for S in (40 * W, 7 * W + 3):
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
