"""Fused extraction: base codes -> k-min-mer windows, and the engine wrapper.

Counterpart of the JAX package's `ops/extract.py`: the TPU replacement for
the reference's per-read worker loops (Read::extract_density, rust-mdbg
src/read.rs:176-211, and the windowing loop main.rs:756-781) as torch ops
over a [B, L] uint8 batch:

  HPC compaction -> hash + selection (the nthash_select kernel under the
  density scheme, the syncmer_select kernel under --syncmers) -> optional
  lmer-count remap and UHS/LCP check_and_add filter -> compaction of the
  selected positions into [B, M] rows -> k-windowing -> canonicalization
  -> shifts/offsets -> 128-bit fingerprints

`device_extract` has three outputs: the count path (`count_output`: window
keys from prefix sums plus the minimizer rows, what the device counters
take), the full path (every per-window field, what the streaming engine's
WindowBatch is made of) and the compact path (`compact_output`: keys plus
a packed meta row, the low-traffic fetch of the non-EC pipeline).
`DeviceExtractor` wraps it for the streaming engine of core/pipeline:
ReadBatch in, WindowBatch / CompactWindows out, the filter state threaded
from batch to batch, and the rows that overflow the compacted capacity
re-extracted exactly on the host.

u64 values are int64 tensors with the same bits (ops/u64.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import u64
from .hpc import hpc
from .kernels import nthash_select, syncmer_select
from .kminmer import canonicalize, fingerprint128, poly_fp_tables

_I64_MAX = (1 << 63) - 1


def capacity(params, L: int, ignore_override: bool = False) -> int:
    """Compacted minimizer slots M per read (the JAX package's
    `DeviceExtractor.capacity`)."""
    p = params
    if p.max_minimizers_per_read > 0 and not ignore_override:
        return p.max_minimizers_per_read
    # canonical hash = min(fh, rh): selection rate ~ 2*density.  Headroom:
    # +8 binomial sigmas (overflowing reads are flagged, never dropped).
    # syncmers: selection needs the offset-(t-1) minimum AND hash <= d*4^l,
    # so the rate is below d; 1.5x margin guards tie-induced clustering
    rate = (min(1.0, p.density * 2) if not p.use_syncmers
            else min(1.0, p.density * 1.5 + 8.0 / max(64, L)))
    expect = L * rate
    sigma = math.sqrt(max(1.0, expect * (1 - rate)))
    m = int(max(p.k + 33, expect + 8 * sigma))
    return (m + 31) & ~31


def _chunk_slot_capacity(hash_bound: int, chunk: int = 512) -> int:
    """Per-chunk slot count for two-level compaction: selection rate ~= 2x
    density, +8 binomial sigmas, rounded up to a multiple of 8, clamped to
    [16, 256].  Chunks exceeding this set the overflow flag."""
    rate = min(1.0, 2.0 * hash_bound / 2.0 ** 64)
    expect = chunk * rate
    sigma = math.sqrt(max(1.0, expect * (1.0 - rate)))
    c = int(expect + 8 * sigma + 4)
    return max(16, min(256, (c + 7) & ~7))


def _compact_positions(sel: torch.Tensor, hash_bound: int, M: int):
    """First M selected positions per row (ascending; L where absent) and
    the overflow flag, by the same two compaction branches as the JAX
    package: two-level per-512-chunk sorts for L % 512 == 0 and L > 2048,
    one flat row sort otherwise.  At M == L (a chunk re-planned to keep
    every position, core/chunked.doubled_plan) the flat sort, which has no
    per-chunk cap, so that the overflow flag stays clear."""
    B, L = sel.shape
    dev = sel.device
    n_min_raw = sel.sum(dim=1, dtype=torch.int32)
    if L % 512 == 0 and L > 2048 and M != L:
        C = _chunk_slot_capacity(hash_bound)
        nch = L // 512
        selc = sel.reshape(B * nch, 512)
        iot = torch.arange(512, dtype=torch.int32, device=dev)
        sck = torch.sort(torch.where(selc, iot, 512), dim=1).values
        base = (torch.arange(B * nch, dtype=torch.int32, device=dev)
                % nch)[:, None] * 512
        cval = torch.where(sck == 512, L, sck + base)
        l2s = torch.sort(cval[:, :C].reshape(B, nch * C), dim=1).values
        if nch * C < M:
            l2s = torch.cat([l2s, torch.full((B, M - nch * C), L,
                                             dtype=l2s.dtype, device=dev)],
                            dim=1)
        chunk_over = (selc.sum(dim=1) > C).reshape(B, nch).any(dim=1)
        overflow = (n_min_raw > M) | chunk_over
        first = l2s[:, :M]
    else:
        iot = torch.arange(L, dtype=torch.int32, device=dev)
        first = torch.sort(torch.where(sel, iot, L), dim=1).values[:, :M]
        overflow = n_min_raw > M
    return first, torch.clamp(n_min_raw, max=M), overflow


@functools.lru_cache(maxsize=None)
def _poly_tables_cached(k: int, M: int):
    return poly_fp_tables(k, M)


def window_keys_poly(mh: torch.Tensor, k: int, M: int) -> torch.Tensor:
    """Canonical 128-bit window fingerprints [B, W, 2] from the compacted
    minimizer rows mh [B, M] via prefix sums (no [B, W, k] tensor).  Equals
    fingerprint128(canonicalize(window)) exactly; sums wrap mod 2^64."""
    W = M - k + 1
    tables = _poly_tables_cached(k, M)
    dev = mh.device

    # KmerVec::normalize reversal flag: lexicographic first difference of
    # v[w+j] vs v[w+k-1-j]; palindromes report True
    rev_flag = torch.ones(mh.shape[:-1] + (W,), dtype=torch.bool, device=dev)
    for j in range(k - 1, -1, -1):
        a = mh[..., j : j + W]
        b = mh[..., k - 1 - j : k - 1 - j + W]
        rev_flag = torch.where(a != b, u64.gt(a, b), rev_flag)

    zero = torch.zeros(mh.shape[:-1] + (1,), dtype=torch.int64, device=dev)
    lanes = []
    for lane in (0, 1):
        t = tables[lane]
        apow = u64.from_numpy(t["apow"], dev)
        ainvpow = u64.from_numpy(t["ainvpow"], dev)
        off_ak = u64.s64(int(t["off_ak"]))
        S = torch.cat([zero, torch.cumsum(mh * ainvpow[:M], dim=-1)], dim=-1)
        T = torch.cat([zero, torch.cumsum(mh * apow[:M], dim=-1)], dim=-1)
        fwd = off_ak + apow[k - 1 : k - 1 + W] * (S[..., k : k + W] - S[..., :W])
        rev = off_ak + ainvpow[:W] * (T[..., k : k + W] - T[..., :W])
        lanes.append(torch.where(rev_flag, rev, fwd))
    return torch.stack(lanes, dim=-1)


# --- scheme stages ------------------------------------------------------------

def _packed_lmers(hpc_codes: torch.Tensor, l: int) -> torch.Tensor:
    """Base-8 packed forward l-mer starting at each position: [B, L] int64.

    3 bits/base keeps codes 0..4 (A C G T N) distinct, so packing is a
    bijection on l-mers for l <= 21; positions within l-1 of the row end pack
    trailing padding codes but are masked invalid by the caller's selection.
    Code 5 ('other') is clamped to 4 ('N'): the host lookup key is
    decode_bases(), which renders both as 'N'."""
    c64 = torch.clamp(hpc_codes.to(torch.int64), max=4)
    L = c64.shape[1]
    pk = torch.zeros_like(c64)
    for j in range(l):
        plane = torch.full_like(c64, 4)
        if j < L:
            plane[:, : L - j] = c64[:, j:]
        pk = pk | (plane << (3 * (l - 1 - j)))
    return pk


def _sorted_member(table_f: torch.Tensor, q_f: torch.Tensor):
    """(index, found) of sign-flipped queries in a sign-flipped sorted
    table."""
    ix = torch.clamp(torch.searchsorted(table_f, q_f), 0,
                     table_f.shape[0] - 1)
    return ix, table_f[ix] == q_f


def _filter_skip_n(sel: torch.Tensor, hpc_codes: torch.Tensor, l: int):
    """extract_lcp skips minimizers whose l-mer contains a non-ACGT code
    (read.rs:115: contains('N'))."""
    B, L = hpc_codes.shape
    ncum = torch.cumsum((hpc_codes >= 4).to(torch.int32), dim=1,
                        dtype=torch.int32)
    has_n = torch.ones((B, L), dtype=torch.bool, device=sel.device)
    if L >= l:
        before = torch.zeros((B, L - l + 1), dtype=torch.int32,
                             device=sel.device)
        before[:, 1:] = ncum[:, : L - l]
        has_n[:, : L - l + 1] = (ncum[:, l - 1:] - before) > 0
    return sel & ~has_n


def _mix64(h: torch.Tensor) -> torch.Tensor:
    """The invertible 64-bit mix (read.rs:43-52 constants): equals
    models/schemes.BloomCheckAndAddFilter._idx bit for bit."""
    h = ~h + (h << 21)
    h = h ^ u64.shr(h, 24)
    h = h + (h << 3) + (h << 8)
    h = h ^ u64.shr(h, 14)
    return h


def bloom_check_and_add(bidx: torch.Tensor, valid: torch.Tensor,
                        bits: torch.Tensor) -> torch.Tensor:
    """Stream-order check-and-add of bit indices against Bloom words.

    A valid row is KEPT iff its bit was set before the batch or by an
    earlier valid row of the batch; every valid row sets its bit.  Order
    within the batch comes from one stable sort of the valid rows' bit
    indices: the first row of a bit keeps only if the bit was already set,
    later rows always keep.  The first rows of bits not yet set are added
    into `bits`: every (word, bit) arrives at most once and the bits of a
    word are disjoint, so the wrapping int32 add equals an or, in any order.

    bidx int64 [N] in [0, 32 * len(bits)), valid bool [N], bits int32 words
    (bit 31 included), updated in place.  Returns keep bool [N]."""
    one = torch.ones((), dtype=torch.int32, device=bits.device)
    mem = (bits[bidx >> 5] & (one << (bidx & 31).to(torch.int32))) != 0

    vi = torch.nonzero(valid).flatten()
    order = torch.sort(bidx[vi], stable=True)
    sb, si = order.values, vi[order.indices]
    first = torch.ones_like(sb, dtype=torch.bool)
    first[1:] = sb[1:] != sb[:-1]
    dup = torch.zeros_like(valid)
    dup[si] = ~first
    keep = valid & (mem | dup)
    ins = sb[first & ~mem[si]]
    bits.index_add_(0, ins >> 5, one << (ins & 31).to(torch.int32))
    return keep


def _stream_filter_bloom(canon, sel, hpc_codes, bits, *, l: int,
                         skip_n: bool):
    """UHS/LCP check_and_add selection through a Bloom filter (the
    reference's memory model, minimizers.rs:115-161, and the --bf mode of
    models/schemes.BloomCheckAndAddFilter) as a data-parallel pass.

    State is a fixed tensor of Bloom words: constant memory at any input
    scale.  Semantics equal the host Bloom filter exactly (same mix hash,
    same power-of-two modulo, same preloaded bits): a candidate is kept iff
    its bit was set by the preload, an earlier batch, or an earlier
    candidate of this batch in stream order; every candidate sets its bit.

    `bits` is left as it was.  Returns (sel', new_bits)."""
    B, L = canon.shape
    if skip_n:
        sel = _filter_skip_n(sel, hpc_codes, l)
    new_bits = bits.clone()
    bidx = _mix64(canon.reshape(-1)) & (bits.shape[0] * 32 - 1)
    keep = bloom_check_and_add(bidx, sel.reshape(-1), new_bits)
    return keep.reshape(B, L), new_bits


def _stream_filter(canon, sel, hpc_codes, preload, seen, delta, *, l: int,
                   skip_n: bool):
    """UHS/LCP check_and_add selection (read.rs:125-156 / 93-124) as a
    data-parallel pass over one batch.

    The host semantics (models/schemes.CheckAndAddFilter, exact-set mode):
    a density-selected candidate is KEPT iff its canonical hash is already
    in the filter set: preloaded (UHS file hashes; LCP preloads strings,
    which never equal an int hash) or inserted by an earlier candidate
    anywhere in the stream.  Every candidate inserts its hash.  Batch form:

      keep = member(preload) | member(seen) | duplicate-of-earlier-in-batch

    where "earlier" is stream order (row-major position), from one stable
    sort of the candidates by hash.

    Two-tier state: `seen` is the big sorted base (merged rarely), `delta`
    a small sorted buffer that the batch's first-occurrence non-member
    hashes merge into.  preload, seen, delta are u64 bits in unsigned
    order, seen and delta padded with all ones; none is modified.

    Returns (sel', (new_delta, new_delta_n, state_overflow)).  On overflow
    the caller must retry the SAME batch after merging delta into the base:
    the returned delta is truncated and must not be committed."""
    B, L = canon.shape
    if skip_n:
        sel = _filter_skip_n(sel, hpc_codes, l)
    cand = sel.reshape(-1)
    tabs = [u64.flip(t) for t in (preload, seen, delta)]

    # candidates only, sign-flipped: unsigned order as int64 order.  No
    # candidate equals the all-ones pad (hashes are <= the density bound)
    vi = torch.nonzero(cand).flatten()
    order = torch.sort(u64.flip(canon.reshape(-1)[vi]), stable=True)
    sk, si = order.values, vi[order.indices]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    mem = torch.zeros_like(first)
    for t in tabs:
        mem |= _sorted_member(t, sk)[1]
    keep = torch.zeros_like(cand)
    keep[si] = mem | ~first

    # inserts: first in-batch occurrence of each candidate hash not already
    # in the set, merged into the small sorted padded delta buffer
    merged = torch.sort(torch.cat([tabs[2], sk[first & ~mem]])).values
    new_n = (merged != _I64_MAX).sum().to(torch.int32)
    S = delta.shape[0]
    return keep.reshape(B, L), (u64.flip(merged[:S]), new_n, new_n > S)


# --- the extraction -----------------------------------------------------------

def device_extract(codes: torch.Tensor, lengths: torch.Tensor, *tables,
                   l: int, k: int, hash_bound: int, M: int,
                   already_hpc: bool = False, compact_output: bool = False,
                   count_output: bool = False, syncmer=None,
                   lmer: bool = False, filter_mode: str | None = None,
                   filter_bloom: bool = False, ref_cuts: bool = False,
                   minimizers_only: bool = False) -> dict:
    """Extraction of one [B, L] batch of reads; the keywords are those of
    the JAX package's `_device_extract`.

    Optional scheme tables follow `lengths` in this order: with `lmer` the
    sorted packed-l-mer keys and their remap values (int64 u64 bits [T]);
    with `filter_mode` ("uhs" / "lcp") the exact-set state (preload, seen,
    delta) or, with `filter_bloom`, the Bloom words (int32 [m / 32]).
    `syncmer` is (s, bound) for --syncmers.  `minimizers_only` returns after
    the compaction with the minimizer rows alone (what the long-sequence
    tiler reads; under jit the JAX package gets the same by dead-code
    elimination)."""
    ti = 0
    if lmer:
        lmer_keys, lmer_vals = tables[0], tables[1]
        ti = 2
    B, L = codes.shape
    dev = codes.device
    idx = torch.arange(L, dtype=torch.int32, device=dev)

    if already_hpc:
        hpc_codes, pos_map, hpc_len = codes, None, lengths
    else:
        hpc_codes, pos_map, hpc_len = hpc(codes, lengths)
    if filter_mode is not None:
        # reference quirk (read.rs:119-120,151-152): UHS/LCP extraction
        # pushes the HPC-space index as the position, not the raw position
        pos_map = None
    # full-HPC-extent end map for exact .sequences record spans:
    # pme[b, j] = raw start of HPC base j+l (the extent end of the l-mer at
    # HPC index j), or the raw read length when the l-mer runs to the read
    # end.  Not needed when hashing space == sequence space (already_hpc,
    # the UHS/LCP quirk) or under ref_cuts: there pos + l is the end.
    want_ext = not (already_hpc or filter_mode is not None or ref_cuts)
    if want_ext:
        in_range = (idx[None, :] + l) < hpc_len[:, None]
        shifted = torch.zeros_like(pos_map)
        shifted[:, : max(0, L - l)] = pos_map[:, l:]
        pme = torch.where(in_range, shifted, lengths[:, None])

    # hash + select
    if syncmer is not None:
        canon, sel = syncmer_select(hpc_codes, hpc_len, l=l, s=syncmer[0],
                                    bound=syncmer[1])
    else:
        canon, sel = nthash_select(hpc_codes, l, hash_bound, hpc_len)

    fstate_out = None
    if lmer:
        # robust-minimizer remap (read.rs:200-204 / extract_density_np): the
        # l-mer must be a key of minimizer_to_int; the hash becomes its
        # value.  One searchsorted + gather per position against the sorted
        # table of packed forward l-mers
        q = u64.flip(_packed_lmers(hpc_codes, l).reshape(-1))
        tix, found = _sorted_member(u64.flip(lmer_keys), q)
        found = found.reshape(B, L)
        sel = sel & found
        canon = torch.where(found, lmer_vals[tix].reshape(B, L), canon)
    if filter_mode is not None:
        skip_n = filter_mode == "lcp"
        if filter_bloom:
            sel, new_bits = _stream_filter_bloom(
                canon, sel, hpc_codes, tables[ti], l=l, skip_n=skip_n)
            # same arity as the exact path; Bloom never overflows
            fstate_out = (new_bits,
                          torch.zeros((), dtype=torch.int32, device=dev),
                          torch.zeros((), dtype=torch.bool, device=dev))
        else:
            sel, fstate_out = _stream_filter(
                canon, sel, hpc_codes, tables[ti], tables[ti + 1],
                tables[ti + 2], l=l, skip_n=skip_n)

    first, n_min, overflow = _compact_positions(sel, hash_bound, M)
    perm_m = torch.clamp(first, max=L - 1).long()
    in_m = torch.arange(M, device=dev)[None, :] < n_min[:, None]
    minim_hash = torch.where(in_m, torch.gather(canon, 1, perm_m), 0)
    if pos_map is None:  # a minimizer's position is its column
        minim_pos = torch.where(in_m, perm_m.to(torch.int32), 0)
    else:
        minim_pos = torch.where(in_m, torch.gather(pos_map, 1, perm_m), 0)
    if minimizers_only:
        return dict(minim_hash=minim_hash, minim_pos=minim_pos, n_min=n_min,
                    overflow=overflow)

    W = M - k + 1
    widx = torch.arange(W, device=dev)
    valid_w = (n_min[:, None] > k) & (widx[None, :] < n_min[:, None] - k + 1)

    if count_output:
        # Counting path: per-window 128-bit canonical fingerprints in O(1)
        # per window from prefix sums over the compacted minimizer row; no
        # [B, W, k] window tensor.  Invalid windows get the all-ones
        # sentinel key so the counter drops them; the per-window metadata
        # is reconstructed from (mh, mp) at finalize.
        keys = torch.where(valid_w[..., None],
                           window_keys_poly(minim_hash, k, M), u64.SENTINEL)
        nw = torch.where(n_min > k, n_min - k + 1, 0).to(torch.int32)
        out = dict(keys=keys, mh=minim_hash, mp=minim_pos, nw=nw,
                   overflow=overflow)
        if want_ext:
            out["mpe"] = torch.where(in_m, torch.gather(pme, 1, perm_m), 0)
        if fstate_out is not None:
            out["fstate"] = fstate_out
        return out

    if want_ext:
        minim_end = torch.where(in_m, torch.gather(pme, 1, perm_m), 0)
    else:
        minim_end = torch.where(in_m, minim_pos + l, 0)

    # k-min-mer windows [B, W, k]
    vecs = torch.stack([minim_hash[:, j : j + W] for j in range(k)], dim=-1)
    canon_vecs, reversed_ = canonicalize(vecs)
    p_first, p_second = minim_pos[:, :W], minim_pos[:, 1 : 1 + W]
    p_prev, p_last = (minim_pos[:, k - 2 : k - 2 + W],
                      minim_pos[:, k - 1 : k - 1 + W])
    d_first = p_second - p_first
    d_last = p_last - p_prev
    shift0 = torch.where(reversed_, d_last, d_first)
    shift1 = torch.where(reversed_, d_first, d_last)
    seqlen = p_last - p_first + 2
    start = p_first
    end = p_last + l
    # exact record-span end and .sequences cut pair from the boundary
    # l-mers' extents (== end / the shift pair whenever pme is pos + l)
    end_ext = minim_end[:, k - 1 : k - 1 + W]
    d_last_e = end_ext - minim_end[:, k - 2 : k - 2 + W]
    seq_shift0 = torch.where(reversed_, d_last_e, d_first)
    seq_shift1 = torch.where(reversed_, d_first, d_last_e)
    fp = fingerprint128(canon_vecs)

    if not compact_output:
        out = dict(
            key_lo=fp[..., 0], key_hi=fp[..., 1], vecs=canon_vecs,
            reversed_=reversed_, shift0=shift0, shift1=shift1, seqlen=seqlen,
            start=start, end=end, end_ext=end_ext,
            seq_shift0=seq_shift0, seq_shift1=seq_shift1, valid_w=valid_w,
            minim_hash=minim_hash, minim_pos=minim_pos, n_min=n_min,
            overflow=overflow)
        if fstate_out is not None:
            out["fstate"] = fstate_out
        return out

    # Compact path: the least device-to-host bytes.
    # keys:  [B, W, 2] u64 bits
    # meta:  [B, W, 4] u32 values in int64 = (seqlen, shift0 | valid<<31,
    #        shift1 | rev<<31, start); end = start + seqlen + l - 2.
    # vecs and the minimizer rows stay on the device; crossing rows are
    # gathered later.
    def clean(x):
        # invalid windows can carry negative deltas (padding positions);
        # zero them so the packed high bits stay trustworthy
        return torch.where(valid_w, x, 0).to(torch.int64) & u64.U32_MAX

    cols = [
        clean(seqlen),
        clean(shift0) | (valid_w.to(torch.int64) << 31),
        clean(shift1) | (reversed_.to(torch.int64) << 31),
        clean(start),
    ]
    if want_ext:
        # 5th column: the exact-cut corrections packed as
        # (end_ext - end) << 16 | (d_last_e - d_last + 0x8000); both small
        # by construction (the homopolymer-run excess of one l-mer).  A
        # value past u16 / s16 sets the per-read overflow flag (exact host
        # re-extraction)
        ext_delta = end_ext - end
        de1 = d_last_e - d_last
        bad = ((ext_delta > 0xFFFF) | (de1 > 0x7FFF) | (de1 < -0x8000)) \
            & valid_w
        overflow = overflow | bad.any(dim=1)
        cols.append((clean(torch.clamp(ext_delta, max=0xFFFF)) << 16)
                    | clean(torch.clamp(de1 + 0x8000, 0, 0xFFFF)))
    out = dict(keys=fp, meta=torch.stack(cols, dim=-1), vecs=canon_vecs,
               minim_hash=minim_hash, minim_pos=minim_pos, n_min=n_min,
               overflow=overflow)
    if fstate_out is not None:
        out["fstate"] = fstate_out
    return out


def extract_count(codes: torch.Tensor, lengths: torch.Tensor, *, l: int,
                  k: int, hash_bound: int, M: int, already_hpc: bool = False,
                  syncmer=None, ref_cuts: bool = False) -> dict:
    """Count-path extraction of one [B, L] batch of reads: `keys` [B, W, 2]
    (invalid windows hold the all-ones sentinel), `mh` [B, M], `mp` [B, M]
    int32, `mpe` [B, M] int32 (raw reads without ref_cuts only), `nw` [B]
    int32 and the per-read `overflow` flag."""
    return device_extract(codes, lengths, l=l, k=k, hash_bound=hash_bound,
                          M=M, already_hpc=already_hpc, count_output=True,
                          syncmer=syncmer, ref_cuts=ref_cuts)


# --- the engine wrapper ---------------------------------------------------------

def _unpack_ext(extpack: np.ndarray):
    """Decode the compact meta extpack column -> (ext_delta i64 >= 0,
    de1 i64 = d_last_e - d_last, sign-restored)."""
    ext_delta = (extpack >> 16).astype(np.int64)
    de1 = (extpack & 0xFFFF).astype(np.int64) - 0x8000
    return ext_delta, de1


class CompactWindows:
    """Valid windows of one batch, fetched with the least device-to-host
    traffic.

    Scalar per-window fields are host numpy arrays; the canonical vectors
    stay on the device until `vecs_for(indices)` gathers just the requested
    rows (the rare abundance-crossing windows)."""

    __slots__ = ("key_lo", "key_hi", "seqlen", "shift0", "shift1", "reversed_",
                 "read_row", "start", "end", "seq_shift0", "seq_shift1",
                 "n_windows", "_dev_vecs", "_win_index")

    def vecs_for(self, indices: np.ndarray) -> np.ndarray:
        """Canonical minimizer vectors for flattened window positions
        (indices into this object's arrays)."""
        k = self._dev_vecs.shape[-1]
        if len(indices) == 0:
            return np.zeros((0, k), dtype=np.uint64)
        flat = torch.from_numpy(self._win_index[indices]).to(
            self._dev_vecs.device)
        return u64.to_numpy(self._dev_vecs.reshape(-1, k)[flat])


class _HostCompact(CompactWindows):
    """CompactWindows view over a host WindowBatch."""

    __slots__ = ("_host_vecs",)

    def vecs_for(self, indices):
        return self._host_vecs[np.asarray(indices, dtype=np.int64)]


def _compact_from_windowbatch(wb) -> CompactWindows:
    cw = _HostCompact()
    cw.key_lo = wb.key_lo
    cw.key_hi = wb.key_hi
    cw.seqlen = wb.seqlen.astype(np.uint32)
    cw.shift0 = wb.shift0
    cw.shift1 = wb.shift1
    cw.reversed_ = wb.reversed_
    cw.read_row = wb.read_row
    cw.start = wb.start
    cw.end = wb.end
    cw.seq_shift0 = wb.seq_shift0
    cw.seq_shift1 = wb.seq_shift1
    cw.n_windows = len(wb.key_lo)
    cw._dev_vecs = cw._win_index = None
    cw._host_vecs = wb.vecs
    return cw


LONG_SEQ_MIN = 1 << 20   # rows at/above this length take the tiled path
TILE_DEFAULT = 1 << 20   # hpc bases per tile row

_U64_ONES = ~np.uint64(0)


class DeviceExtractor:
    """Engine wrapper: ReadBatch -> WindowBatch / CompactWindows through
    device_extract on `device`.

    Reads whose minimizer count exceeds the compacted capacity M (rare;
    flagged by device_extract) are re-extracted with the host engine to
    preserve exactness.  `stats` counts them (`host_rows`), the long rows
    that went through the tiler (`tiled_rows`) and those of them whose tile
    overflowed and took the host extraction instead (`tile_host_rows`).
    """

    def __init__(self, params, device, lmer_table=None,
                 filter_mode: str | None = None, filter_preload=None,
                 m2i: dict | None = None, filter_bloom_bits=None):
        self.params = params
        self.device = torch.device(device)
        self.stats = dict(host_rows=0, tiled_rows=0, tile_host_rows=0)
        # scheme tables (see make_device_extractor)
        self._m2i = m2i
        self._lmer = None
        if lmer_table is not None:
            self._lmer = tuple(u64.from_numpy(a, self.device)
                               for a in lmer_table)
        self.filter_mode = filter_mode
        self._filter_bloom = filter_bloom_bits is not None
        self._m_mult = 1  # M growth factor (filter mode re-runs batches)
        if self._filter_bloom:
            # --bf UHS/LCP: Bloom words seeded from the host filter's
            # preloaded bits (models/schemes.BloomCheckAndAddFilter's bit
            # layout is the little-endian u32 view); constant memory at any
            # input scale, false positives identical to the host filter
            self._bits = torch.from_numpy(
                np.ascontiguousarray(filter_bloom_bits).view(np.int32)
            ).to(self.device, copy=True)
        elif filter_mode is not None:
            pre = (np.zeros(0, dtype=np.uint64) if filter_preload is None
                   else np.asarray(filter_preload, dtype=np.uint64))
            if pre.size == 0:
                # the all-ones pad keeps membership lookups index-safe (no
                # query hash equals it: candidates are <= the density bound)
                pre = np.array([_U64_ONES], dtype=np.uint64)
            self._preload = u64.from_numpy(np.sort(pre), self.device)
            self._seen_cap = 1 << 16
            self._seen = self._pad(self._seen_cap)
            self.seen_n = 0
            self._delta_cap = 1 << 14
            self._delta = self._pad(self._delta_cap)
            self.delta_n = 0

    def _pad(self, n: int) -> torch.Tensor:
        return torch.full((n,), u64.SENTINEL, dtype=torch.int64,
                          device=self.device)

    # -- state carried across ---------------------------------------------

    def filter_state_to_numpy(self) -> dict:
        """The scheme state as numpy arrays in the JAX extractor's layout:
        `lmer_keys` / `lmer_vals` (u64), and either `bits` (u32 Bloom words)
        or the exact set `preload`, `seen`, `delta` (u64, unsigned order,
        all-ones padded) with `seen_n`, `delta_n`."""
        st: dict = {}
        if self._lmer is not None:
            st.update(lmer_keys=u64.to_numpy(self._lmer[0]),
                      lmer_vals=u64.to_numpy(self._lmer[1]))
        if self._filter_bloom:
            st["bits"] = self._bits.cpu().numpy().view(np.uint32)
        elif self.filter_mode is not None:
            st.update(preload=u64.to_numpy(self._preload),
                      seen=u64.to_numpy(self._seen), seen_n=self.seen_n,
                      delta=u64.to_numpy(self._delta), delta_n=self.delta_n)
        return st

    def filter_state_from_numpy(self, st: dict):
        """Take the state that filter_state_to_numpy gives (or the same
        arrays read off the JAX extractor)."""
        if "lmer_keys" in st:
            self._lmer = (u64.from_numpy(st["lmer_keys"], self.device),
                          u64.from_numpy(st["lmer_vals"], self.device))
        if "bits" in st:
            self._bits = torch.from_numpy(np.ascontiguousarray(
                st["bits"], dtype=np.uint32).view(np.int32)).to(
                    self.device, copy=True)
        if "seen" in st:
            self._preload = u64.from_numpy(st["preload"], self.device)
            self._seen = u64.from_numpy(st["seen"], self.device)
            self._delta = u64.from_numpy(st["delta"], self.device)
            self._seen_cap = int(self._seen.shape[0])
            self._delta_cap = int(self._delta.shape[0])
            self.seen_n = int(st["seen_n"])
            self.delta_n = int(st["delta_n"])

    def filter_fill(self) -> int:
        """Set Bloom bits, or the exact set's size (seen_n + delta_n)."""
        if self._filter_bloom:
            # per-word popcount by masked pair / nibble / byte sums (the
            # masks clear what the arithmetic shift of an int32 brings in)
            x = self._bits
            x = x - ((x >> 1) & 0x55555555)
            x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
            x = (x + (x >> 4)) & 0x0F0F0F0F
            return int((((x * 0x01010101) >> 24) & 0xFF).sum())
        if self.filter_mode is not None:
            return self.seen_n + self.delta_n
        return 0

    # -- device calls --------------------------------------------------------

    def _extra_args(self) -> tuple:
        extra = ()
        if self._lmer is not None:
            extra += self._lmer
        if self._filter_bloom:
            extra += (self._bits,)
        elif self.filter_mode is not None:
            extra += (self._preload, self._seen, self._delta)
        return extra

    def _to_dev(self, codes: np.ndarray, lengths: np.ndarray):
        return (torch.from_numpy(np.ascontiguousarray(codes)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(
                    lengths, dtype=np.int32)).to(self.device))

    def _kw(self, M: int, compact: bool) -> dict:
        p = self.params
        return dict(
            l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
            already_hpc=p.reads_already_hpc, compact_output=compact,
            syncmer=(p.s, p.syncmer_hash_bound) if p.use_syncmers else None,
            lmer=self._lmer is not None, filter_mode=self.filter_mode,
            filter_bloom=self._filter_bloom,
            ref_cuts=p.seq_ref_cuts)

    def _run(self, codes, lengths, M: int, compact: bool = False) -> dict:
        return device_extract(*self._to_dev(codes, lengths),
                              *self._extra_args(), **self._kw(M, compact))

    def _run_tile(self, codes: np.ndarray, lengths: np.ndarray) -> dict:
        """Minimizer rows at the fixed tile shape (extract_minimizers_tiled);
        always already_hpc: the tiler HPC-compresses on the host to keep
        the raw-position map exact.  Per-read minimizer caps do not apply to
        a tile of a longer sequence."""
        p = self.params
        return device_extract(
            *self._to_dev(codes, lengths), l=p.l, k=p.k,
            hash_bound=p.hash_bound,
            M=self.capacity(codes.shape[1], ignore_override=True),
            already_hpc=True, minimizers_only=True)

    def _tiled_ok(self) -> bool:
        p = self.params
        return (not p.use_syncmers and self.filter_mode is None
                and self._lmer is None and self._m2i is None)

    def _extract_long(self, batch):
        """Long-row batches ([1, L] overflow staging from io.fastx.batches):
        device-tiled minimizer selection + host windowing.  A row whose tile
        overflows its capacity takes the exact host extraction, and is
        counted."""
        from ..core.extract import (extract_minimizers_host,
                                    extract_windows_host)

        p = self.params

        def mfn(codes):
            self.stats["tiled_rows"] += 1
            try:
                return extract_minimizers_tiled(codes, p, self)
            except TileOverflow:
                self.stats["tile_host_rows"] += 1
                return extract_minimizers_host(codes, p, self._m2i)

        return extract_windows_host(batch, p, minimizer_fn=mfn)

    def _merge_delta(self):
        """Fold the committed delta into the sorted base (growing the base
        to the next power of two when needed) and reset the delta.  Called
        on delta overflow: rare, so the big base re-sort is amortized over
        ~delta_cap inserts.  A delta too small for ONE batch's inserts
        doubles instead."""
        if self.delta_n == 0:
            self._delta_cap *= 2
            self._delta = self._pad(self._delta_cap)
            return
        need = self.seen_n + self.delta_n
        while self._seen_cap < need:
            self._seen_cap *= 2
        both = torch.cat([self._seen, self._delta,
                          self._pad(max(0, self._seen_cap
                                        - self._seen.shape[0]))])
        self._seen = u64.flip(torch.sort(u64.flip(both)).values[
            : self._seen_cap])
        self.seen_n = need
        self._delta = self._pad(self._delta_cap)
        self.delta_n = 0

    def extract_device(self, codes: torch.Tensor, lengths: torch.Tensor):
        """Compact extraction of tensors on the extractor's device, with no
        host transfer."""
        if self.filter_mode is not None:
            raise RuntimeError(
                "extract_device cannot thread UHS/LCP filter state; "
                "use __call__ / extract_compact")
        return device_extract(
            codes, lengths, *self._extra_args(),
            **self._kw(self.capacity(codes.shape[1]), True))

    def extract_compact(self, batch) -> CompactWindows:
        """Low-traffic path for the non-EC pipeline (keys + meta only;
        vectors gathered on demand).  Overflow rows go through the full
        path and its host re-extraction."""
        p = self.params
        if self.filter_mode is not None:
            # stateful UHS/LCP runs through the full path (which commits
            # the filter state exactly once per batch)
            return _compact_from_windowbatch(self(batch))
        B, L = batch.codes.shape
        if L >= LONG_SEQ_MIN and self._tiled_ok():
            return _compact_from_windowbatch(self._extract_long(batch))
        out = self._run(batch.codes, batch.lengths, self.capacity(L),
                        compact=True)
        if bool(out["overflow"].any()):
            # rare: take the exact full path for the whole batch
            return _compact_from_windowbatch(self(batch))
        keys = u64.to_numpy(out["keys"])            # [B, W, 2] u64
        meta = out["meta"].cpu().numpy().astype(np.uint32)  # [B, W, 4(+1)]
        valid = (meta[..., 1] >> 31) > 0
        rows, wins = np.nonzero(valid)
        W = valid.shape[1]
        cw = CompactWindows()
        cw.key_lo = keys[rows, wins, 0]
        cw.key_hi = keys[rows, wins, 1]
        m = meta[rows, wins]
        cw.seqlen = m[:, 0]
        cw.shift0 = (m[:, 1] & 0x7FFFFFFF).astype(np.uint16)
        cw.shift1 = (m[:, 2] & 0x7FFFFFFF).astype(np.uint16)
        cw.reversed_ = (m[:, 2] >> 31) > 0
        cw.read_row = rows.astype(np.int32)
        cw.start = m[:, 3].astype(np.int64)
        cw.end = cw.start + cw.seqlen.astype(np.int64) + (p.l - 2)
        cw.seq_shift0, cw.seq_shift1 = cw.shift0, cw.shift1
        if meta.shape[-1] > 4:
            # exact-cut corrections (extpack column, see device_extract)
            ext_delta, de1 = _unpack_ext(m[:, 4])
            cw.end = cw.end + ext_delta
            cw.seq_shift0 = np.where(cw.reversed_, cw.shift0 + de1,
                                     cw.shift0).astype(np.uint16)
            cw.seq_shift1 = np.where(cw.reversed_, cw.shift1,
                                     cw.shift1 + de1).astype(np.uint16)
        cw.n_windows = len(rows)
        cw._dev_vecs = out["vecs"]
        cw._win_index = (rows * W + wins).astype(np.int64)
        return cw

    def capacity(self, L: int, ignore_override: bool = False) -> int:
        return capacity(self.params, L, ignore_override)

    def __call__(self, batch):
        from ..core.extract import WindowBatch

        p = self.params
        B, L = batch.codes.shape
        if L >= LONG_SEQ_MIN and self._tiled_ok():
            return self._extract_long(batch)
        if self.filter_mode is not None:
            out = self._call_filtered(batch)
        else:
            out = self._run(batch.codes, batch.lengths, self.capacity(L))
        u64_fields = ("key_lo", "key_hi", "vecs", "minim_hash")
        out = {k: (u64.to_numpy(v) if k in u64_fields else v.cpu().numpy())
               for k, v in out.items() if k != "fstate"}

        valid = out["valid_w"]
        # host re-extraction rows: capacity overflow
        overflow_rows = np.nonzero(out["overflow"])[0]
        if overflow_rows.size:
            valid = valid.copy()
            valid[overflow_rows] = False

        rows, wins = np.nonzero(valid)
        wb = WindowBatch(
            key_lo=out["key_lo"][rows, wins],
            key_hi=out["key_hi"][rows, wins],
            seqlen=out["seqlen"][rows, wins].astype(np.uint32),
            shift0=out["shift0"][rows, wins].astype(np.uint16),
            shift1=out["shift1"][rows, wins].astype(np.uint16),
            reversed_=out["reversed_"][rows, wins],
            read_row=rows.astype(np.int32),
            start=out["start"][rows, wins].astype(np.int64),
            end=out["end_ext"][rows, wins].astype(np.int64),
            seq_shift0=out["seq_shift0"][rows, wins].astype(np.uint16),
            seq_shift1=out["seq_shift1"][rows, wins].astype(np.uint16),
            vecs=out["vecs"][rows, wins],
            minimizers=[
                (
                    out["minim_pos"][b, : out["n_min"][b]].astype(np.int64),
                    out["minim_hash"][b, : out["n_min"][b]],
                )
                if batch.lengths[b] > 0
                else None
                for b in range(B)
            ],
        )
        if overflow_rows.size:
            self.stats["host_rows"] += int(overflow_rows.size)
            wb = _merge_host_rows(wb, batch, overflow_rows, p, self._m2i)
        return wb

    def _call_filtered(self, batch):
        """Full-path extraction under UHS/LCP: re-runs the batch with
        doubled minimizer capacity on overflow (a host re-extraction cannot
        replicate the device-resident filter state), merges the delta on
        state overflow, and commits the new state exactly once.  Every
        attempt reads the committed state and returns new tensors, so a
        discarded attempt leaves nothing behind."""
        B, L = batch.codes.shape
        while True:
            M = min(L, self.capacity(L) * self._m_mult)
            out = self._run(batch.codes, batch.lengths, M)
            new_state, new_n, state_over = out["fstate"]
            if not self._filter_bloom and bool(state_over):
                self._merge_delta()
                continue
            if bool(out["overflow"].any()):
                if M < L:
                    self._m_mult *= 2
                    continue
                raise RuntimeError(
                    "UHS/LCP device extraction overflowed per-512-window "
                    "compaction slots even at full capacity; rerun with "
                    "--engine host")
            if self._filter_bloom:
                self._bits = new_state
            else:
                self._delta = new_state
                self.delta_n = int(new_n)
            return out


class TileOverflow(RuntimeError):
    """A tile of extract_minimizers_tiled selected more minimizers than its
    compacted capacity holds."""


def extract_minimizers_tiled(codes: np.ndarray, params, extractor,
                             tile: int = TILE_DEFAULT):
    """Minimizer selection for one Mbp-scale sequence via fixed-shape device
    tiles (density scheme: --reference genomes, multik contig feedback).

    Density selection is per-l-mer local (read.rs:176-211 applies the hash
    bound to each l-mer independently), so tiling the HPC-compressed
    sequence into rows of `tile` bases with an (l-1)-base halo stitches
    exactly: tile row i covers hpc[i*tile : i*tile + tile + l - 1] and keeps
    minimizers starting in [0, tile).  One (8, tile+512) shape whatever the
    sequence length, where the padded [1, L] staging would make one huge
    live tensor.  Windowing over the ~2·density·L surviving minimizers
    stays on the host (core/extract.window_kminmers flow).

    Returns (pos int64[N] raw coords, hashes uint64[N]), identical to the
    host oracle ops.minimizers.extract_density_np.  Raises TileOverflow when
    a tile selects more than its capacity."""
    from .hpc import encode_rle_np

    l = params.l
    if l - 1 > 512:
        raise ValueError("tiled extraction requires l <= 513")
    if params.reads_already_hpc:
        hpc_codes = np.ascontiguousarray(codes)
        posmap = None
    else:
        hpc_codes, posmap = encode_rle_np(codes)
    n = int(hpc_codes.shape[0])
    if n < l:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64)
    halo = 512  # >= l-1, keeps the row width a multiple of 512
    TB = 8
    Lt = tile + halo
    n_tiles = (n + tile - 1) // tile
    pos_chunks: list[np.ndarray] = []
    hash_chunks: list[np.ndarray] = []
    buf = np.full((TB, Lt), 5, dtype=np.uint8)
    for t0 in range(0, n_tiles, TB):
        rows = min(TB, n_tiles - t0)
        buf[:] = 5
        lens = np.zeros(TB, dtype=np.int32)
        for r in range(rows):
            a = (t0 + r) * tile
            b = min(n, a + tile + (l - 1))
            buf[r, : b - a] = hpc_codes[a:b]
            lens[r] = b - a
        out = extractor._run_tile(buf, lens)
        if bool(out["overflow"][:rows].any()):
            raise TileOverflow("tiled extraction minimizer-capacity overflow")
        nm = out["n_min"].cpu().numpy()
        mh = u64.to_numpy(out["minim_hash"])
        mp = out["minim_pos"].cpu().numpy()
        for r in range(rows):
            p = mp[r, : nm[r]]
            keep = p < tile  # halo starts belong to the next tile
            pos_chunks.append(p[keep].astype(np.int64) + (t0 + r) * tile)
            hash_chunks.append(mh[r, : nm[r]][keep])
    pos = np.concatenate(pos_chunks)
    hashes = np.concatenate(hash_chunks)
    if posmap is not None:
        pos = posmap[pos]
    return pos, hashes


def _merge_host_rows(wb, batch, rows, params, m2i=None):
    """Re-extract overflow rows on the host and splice them in, preserving
    the deterministic (read_row, window) order.

    The device batch has NO windows for the overflow rows (masked out), and
    both pieces are internally sorted by (read_row, window), so a stable
    sort on read_row alone restores the global order."""
    from ..core.extract import WindowBatch, extract_windows_host

    class _View:
        codes = batch.codes[rows]
        lengths = batch.lengths[rows]
        ids = [batch.ids[r] for r in rows]
        raw = [batch.raw[r] for r in rows] if batch.raw else []
        start_index = batch.start_index

    hb = extract_windows_host(_View, params, m2i)
    hb_rows = rows[hb.read_row].astype(np.int32)
    order = np.argsort(np.concatenate([wb.read_row, hb_rows]), kind="stable")

    def cat(a, b):
        return np.concatenate([a, b])[order]

    minims = list(wb.minimizers)
    for i, r in enumerate(rows):
        minims[r] = hb.minimizers[i]
    return WindowBatch(
        key_lo=cat(wb.key_lo, hb.key_lo), key_hi=cat(wb.key_hi, hb.key_hi),
        seqlen=cat(wb.seqlen, hb.seqlen), shift0=cat(wb.shift0, hb.shift0),
        shift1=cat(wb.shift1, hb.shift1),
        reversed_=cat(wb.reversed_, hb.reversed_),
        read_row=cat(wb.read_row, hb_rows),
        start=cat(wb.start, hb.start), end=cat(wb.end, hb.end),
        seq_shift0=cat(wb.seq_shift0, hb.seq_shift0),
        seq_shift1=cat(wb.seq_shift1, hb.seq_shift1),
        vecs=np.concatenate([wb.vecs, hb.vecs])[order],
        minimizers=minims,
    )


def _build_lmer_table(m2i: dict, l: int):
    """Sorted (packed-lmer keys, values) arrays for the device remap lookup.

    Keys not in decoded-normal form (uppercase ACGT/N, the only strings
    decode_bases can produce) are unreachable by the host lookup and are
    skipped; the remaining keys pack injectively (base-8 over codes 0..4)."""
    from ..utils.seq import BASE_CODE, CODE_BASE

    items = [(s, v) for s, v in m2i.items() if len(s) == l and s.isascii()]
    raw = np.frombuffer("".join(s for s, _ in items).encode(),
                        dtype=np.uint8).reshape(len(items), l)
    codes = np.minimum(BASE_CODE[raw], 4)
    # host decode_bases can never produce a key that does not decode back
    ok = (CODE_BASE[codes] == raw).all(axis=1)
    shifts = np.arange(3 * (l - 1), -1, -3, dtype=np.uint64)
    keys = np.bitwise_or.reduce(codes[ok].astype(np.uint64) << shifts,
                                axis=1)
    vals = np.fromiter((v for _, v in items), dtype=np.uint64,
                       count=len(items))[ok]
    if not keys.size:
        # all-ones pad: no packed l-mer (< 2^63 at l <= 21) equals it, so
        # lookups on a degenerate table never match (and never index empty)
        return (np.array([_U64_ONES], dtype=np.uint64),
                np.zeros(1, dtype=np.uint64))
    order = np.argsort(keys)
    return keys[order], vals[order]


def make_device_extractor(params, device, minimizer_to_int=None,
                          uhs_filter=None, lcp_filter=None):
    """The DeviceExtractor of a run on `device`, with the scheme tables its
    Params ask for taken from the host preparation's results."""
    lmer_table = m2i = None
    if params.has_lmer_counts or params.error_correct:
        # the remap of minimizers_preparation's table (read.rs:200-204):
        # --lmer-counts' robust minimizers, and error correction, whose
        # records carry the table's values (the JAX package's EC runs the
        # host engine for it; here it is the device lookup)
        if minimizer_to_int is None or params.l > 21:
            raise NotImplementedError(
                "device minimizer remap (--lmer-counts, error correction) "
                "needs the prepared table and l <= 21")
        lmer_table = _build_lmer_table(minimizer_to_int, params.l)
        m2i = minimizer_to_int
    filter_mode = preload = bloom_bits = None
    if params.uhs or params.lcp:
        f = uhs_filter if params.uhs else lcp_filter
        if f is None:
            raise NotImplementedError("UHS/LCP filter not prepared")
        filter_mode = "uhs" if params.uhs else "lcp"
        if hasattr(f, "_bits"):
            # --bf mode: mirror the host Bloom filter's preloaded bit array
            # (same mix hash + power-of-two modulo -> identical FP pattern)
            bloom_bits = np.asarray(f._bits, dtype=np.uint8).view(np.uint32)
        elif hasattr(f, "_set"):
            # exact-set mode; int entries only: LCP preloads STRINGS, which
            # an int-hash query can never equal (models/schemes.py)
            preload = np.fromiter(
                (x for x in f._set if isinstance(x, (int, np.integer))),
                dtype=np.uint64)
        else:
            raise NotImplementedError("unrecognized UHS/LCP filter")
    return DeviceExtractor(params, device, lmer_table=lmer_table,
                           filter_mode=filter_mode, filter_preload=preload,
                           m2i=m2i, filter_bloom_bits=bloom_bits)
