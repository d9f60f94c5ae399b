"""Fused extraction, count path: base codes -> window keys + minimizer rows.

Counterpart of the `count_output=True` path of the JAX package's
`ops/extract._device_extract` under the density scheme:

  HPC compaction -> extent-end plane -> ntHash + density selection (the
  nthash_select kernel) -> compaction of the selected positions into
  [B, M] rows -> O(1) 128-bit window keys from prefix sums

Reads that are already homopolymer-compressed skip the first two steps:
the codes are hashed as they are and a minimizer's position is its column.

Outputs match the JAX function key for key: `keys` [B, W, 2] (invalid
windows hold the all-ones sentinel), `mh` [B, M] (u64 bits), `mp` [B, M]
int32, `mpe` [B, M] int32 (raw reads only), `nw` [B] int32 and the per-read
`overflow` flag.
"""

from __future__ import annotations

import functools
import math

import torch

from . import u64
from .hpc import hpc
from .kernels import nthash_select
from .kminmer import poly_fp_tables


def capacity(params, L: int) -> int:
    """Compacted minimizer slots M per read (the JAX package's
    `DeviceExtractor.capacity` for the density scheme)."""
    p = params
    if p.max_minimizers_per_read > 0:
        return p.max_minimizers_per_read
    # canonical hash = min(fh, rh): selection rate ~ 2*density.  Headroom:
    # +8 binomial sigmas (overflowing reads are flagged, never dropped)
    rate = min(1.0, p.density * 2)
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
    one flat row sort otherwise."""
    B, L = sel.shape
    dev = sel.device
    n_min_raw = sel.sum(dim=1, dtype=torch.int32)
    if L % 512 == 0 and L > 2048:
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


def extract_count(codes: torch.Tensor, lengths: torch.Tensor, *, l: int,
                  k: int, hash_bound: int, M: int,
                  already_hpc: bool = False) -> dict:
    """Count-path extraction of one [B, L] batch of reads.  With
    already_hpc the hashing space is the sequence space: no HPC pass, and no
    extent plane `mpe` in the result (an l-mer's extent ends at pos + l)."""
    B, L = codes.shape
    dev = codes.device

    if already_hpc:
        hpc_codes, hpc_len = codes, lengths
    else:
        idx = torch.arange(L, dtype=torch.int32, device=dev)
        hpc_codes, pos_map, hpc_len = hpc(codes, lengths)
        # full-HPC-extent end map: pme[b, j] = raw start of HPC base j+l
        # (the extent end of the l-mer at HPC index j), or the raw read
        # length when the l-mer runs to the read end
        in_range = (idx[None, :] + l) < hpc_len[:, None]
        shifted = torch.zeros_like(pos_map)
        shifted[:, : max(0, L - l)] = pos_map[:, l:]
        pme = torch.where(in_range, shifted, lengths[:, None])

    canon, sel = nthash_select(hpc_codes, l, hash_bound, hpc_len)

    first, n_min, overflow = _compact_positions(sel, hash_bound, M)
    perm_m = torch.clamp(first, max=L - 1).long()
    in_m = torch.arange(M, device=dev)[None, :] < n_min[:, None]
    mh = torch.where(in_m, torch.gather(canon, 1, perm_m), 0)
    out = {}
    if already_hpc:
        mp = torch.where(in_m, perm_m.to(torch.int32), 0)
    else:
        mp = torch.where(in_m, torch.gather(pos_map, 1, perm_m), 0)
        out["mpe"] = torch.where(in_m, torch.gather(pme, 1, perm_m), 0)

    # invalid windows get the all-ones sentinel key so the counter drops them
    keys = window_keys_poly(mh, k, M)
    Wn = M - k + 1
    widx = torch.arange(Wn, device=dev)
    valid_w = (n_min[:, None] > k) & (widx[None, :] < n_min[:, None] - k + 1)
    keys = torch.where(valid_w[..., None], keys, u64.SENTINEL)
    nw = torch.where(n_min > k, n_min - k + 1, 0).to(torch.int32)
    out.update(keys=keys, mh=mh, mp=mp, nw=nw, overflow=overflow)
    return out
