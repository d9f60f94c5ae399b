"""k-min-mer canonicalization and 128-bit fingerprints.

Parity targets:
- `KmerVec::normalize` (rust-mdbg src/kmer_vec.rs:34-39): canonical form is
  the lexicographic min of the vector and its reversal; `reversed` is true
  iff NOT (vec < reversed) — a palindromic vector reports reversed=True.
- the JAX package's `fingerprint128_np/_jax` Horner lanes, the node key.

Vectors are u64 bit patterns in int64 tensors (ops/u64.py), so every order
test goes through the unsigned helpers.
"""

from __future__ import annotations

import numpy as np
import torch

from . import u64

_FNV1 = np.uint64(0x100000001B3)
_FNV2 = np.uint64(0xC2B2AE3D27D4EB4F)
_OFF1 = np.uint64(0xCBF29CE484222325)
_OFF2 = np.uint64(0x9E3779B97F4A7C15)


def window_kminmers_np(
    pos: np.ndarray, hashes: np.ndarray, k: int, l: int,
    pos_end: np.ndarray | None = None,
) -> list[dict]:
    """All k-min-mer windows for one read's selected minimizers.

    Returns a list of dicts with keys: vec (canonical tuple), reversed,
    shift (pair), seq_shift (pair), start, end, seqlen.  Empty unless
    len(hashes) > k.

    `shift`/`seqlen` are the reference's node-table semantics — raw
    START-distances and pos[i+k-1]-pos[i]+2 (main.rs:769-778) — and feed
    the GFA L-line overlap arithmetic unchanged.

    `pos_end` (ops/hpc.extent_ends_np) switches the RECORDED span to the
    full HPC extent of the boundary l-mers: `end` becomes pos_end[i+k-1]
    (instead of pos[i+k-1]+l) and `seq_shift` is the cut pair written to
    .sequences — left cut from raw START-distance of the first two
    minimizers, right cut from raw extent-END-distance of the last two.
    With these, to_basespace's cut rule (to_basespace.rs:213-243) lands on
    the same genomic boundary from both sides of every junction regardless
    of recording orientation — exact reconstruction on raw inputs, where
    the reference's pos+l spans are a few bases off whenever a boundary
    l-mer spans a homopolymer run.  pos_end=None keeps the reference's
    semantics (seq_shift == shift).
    """
    n = hashes.shape[0]
    if n <= k:
        return []
    out = []
    for i in range(n - k + 1):
        vec = tuple(int(x) for x in hashes[i : i + k])
        rev = vec[::-1]
        reversed_ = not (vec < rev)
        canon = rev if reversed_ else vec
        d_first = int(pos[i + 1] - pos[i])
        d_last = int(pos[i + k - 1] - pos[i + k - 2])
        shift = (d_last, d_first) if reversed_ else (d_first, d_last)
        if pos_end is None:
            end = int(pos[i + k - 1]) + l
            seq_shift = shift
        else:
            end = int(pos_end[i + k - 1])
            d_last_e = int(pos_end[i + k - 1] - pos_end[i + k - 2])
            seq_shift = ((d_last_e, d_first) if reversed_
                         else (d_first, d_last_e))
        out.append(
            dict(
                vec=canon,
                reversed=reversed_,
                shift=shift,
                seq_shift=seq_shift,
                start=int(pos[i]),
                end=end,
                seqlen=int(pos[i + k - 1]) - int(pos[i]) + 2,
            )
        )
    return out


def fingerprint128_np(vecs: np.ndarray) -> np.ndarray:
    """Order-dependent 128-bit fingerprint of u64 vectors.

    vecs: uint64 [..., k] -> uint64 [..., 2].  Two independent polynomial
    (Horner) lanes mod 2^64: h = h*A + x, seeded with a lane offset so the
    value is length-dependent.  The key the node table counts under.
    """
    vecs = np.asarray(vecs, dtype=np.uint64)
    h1 = np.full(vecs.shape[:-1], _OFF1, dtype=np.uint64)
    h2 = np.full(vecs.shape[:-1], _OFF2, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(vecs.shape[-1]):
            x = vecs[..., j]
            h1 = h1 * _FNV1 + x
            h2 = h2 * _FNV2 + x
    return np.stack([h1, h2], axis=-1)


def _first_diff(vecs: torch.Tensor):
    """(vec, reversed vec) at their first differing index, and whether any
    index differs."""
    rev = vecs.flip(-1)
    ne = vecs != rev
    first = ne.to(torch.uint8).argmax(dim=-1, keepdim=True)
    a = torch.gather(vecs, -1, first)[..., 0]
    b = torch.gather(rev, -1, first)[..., 0]
    return rev, a, b, ne.any(dim=-1)


def canonicalize(vecs: torch.Tensor):
    """Batched KmerVec::normalize.

    vecs: int64 [..., k] u64 bits -> (canon [..., k], reversed bool [...]).
    """
    rev, a, b, any_ne = _first_diff(vecs)
    reversed_ = torch.where(any_ne, u64.gt(a, b), True)
    canon = torch.where(reversed_[..., None], rev, vecs)
    return canon, reversed_


def le_rev(vecs: torch.Tensor) -> torch.Tensor:
    """vec <= reversed(vec) per row (palindrome: True)."""
    _, a, b, any_ne = _first_diff(vecs)
    return torch.where(any_ne, u64.lt(a, b), True)


def fingerprint128(vecs: torch.Tensor) -> torch.Tensor:
    """Torch form of fingerprint128_np: int64 [..., k] -> int64 [..., 2]."""
    shape = vecs.shape[:-1]
    h1 = torch.full(shape, u64.s64(int(_OFF1)), dtype=torch.int64,
                    device=vecs.device)
    h2 = torch.full(shape, u64.s64(int(_OFF2)), dtype=torch.int64,
                    device=vecs.device)
    m1, m2 = u64.s64(int(_FNV1)), u64.s64(int(_FNV2))
    for j in range(vecs.shape[-1]):
        x = vecs[..., j]
        h1 = h1 * m1 + x
        h2 = h2 * m2 + x
    return torch.stack([h1, h2], dim=-1)


def poly_fp_tables(k: int, M: int):
    """Precomputed power tables for the O(1)-per-window device fingerprint.

    fingerprint128 is the Horner polynomial h = OFF·A^k + Σ_j A^(k-1-j)·v[j]
    (mod 2^64, per lane).  Over a compacted minimizer row v[0..M) the key of
    every width-k window w is recoverable from two prefix sums:

      fwd(w)   = OFF·A^k + A^(k-1+w) · (S[w+k] − S[w]),  S[i] = Σ_{t<i} A^-t·v[t]
      rev(w)   = OFF·A^k + A^-w     · (T[w+k] − T[w]),  T[i] = Σ_{t<i} A^t ·v[t]

    (rev(w) is the fingerprint of the REVERSED window — the canonical key when
    KmerVec::normalize picks the reversal).  A is odd so A^-1 mod 2^64 exists.

    Returns a dict of numpy uint64 arrays keyed per lane.
    """
    mask = (1 << 64) - 1
    out = {}
    for lane, (a, off) in enumerate(((int(_FNV1), int(_OFF1)),
                                     (int(_FNV2), int(_OFF2)))):
        ainv = pow(a, -1, 1 << 64)
        apow = np.empty(M + k, dtype=np.uint64)
        ainvpow = np.empty(M + k, dtype=np.uint64)
        x = y = 1
        for t in range(M + k):
            apow[t] = x
            ainvpow[t] = y
            x = (x * a) & mask
            y = (y * ainv) & mask
        out[lane] = dict(
            apow=apow, ainvpow=ainvpow,
            off_ak=np.uint64((off * pow(a, k, 1 << 64)) & mask),
        )
    return out
