"""ntHash v1 canonical rolling hash in closed form.

Parity target: the `nthash` crate used by the reference (rust-mdbg
src/read.rs:2,196), i.e. ntHash v1:

    fh(i) = XOR_{j=0..l-1} rotl(H[s[i+j]], l-1-j)
    rh(i) = XOR_{j=0..l-1} rotl(RC[s[i+j]], j)
    canonical(i) = min(fh(i), rh(i))

with the published per-base seeds.  For fixed l each hash is an XOR of l
constant rotations of the per-base seed array, each shifted by j: no
loop-carried state.  `nthash_windows_np` is the numpy oracle (a copy of the
JAX package's); `nthash_windows` is the torch form over padded batches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import u64

# ntHash v1 per-base seeds (the published constants from the ntHash paper /
# C++ release, as used by the nthash crate the reference links against).
# Pinned by an external oracle vector in tests/test_torch_nthash.py:
# ntf64(b"TGCAG", 0, 5) == 0x0bafa6728fc6dabf — a 5-mer covering all four
# bases, so a wrong seed or rotation schedule cannot reproduce it.
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
SEED_N = 0

# Indexed by base code (A=0 C=1 G=2 T=3 N=4 other=5). `other` hashes like N;
# the reference's nthash crate panics on non-ACGTN input instead, so this only
# diverges on inputs the reference cannot process at all.
H_BY_CODE = np.array([SEED_A, SEED_C, SEED_G, SEED_T, SEED_N, SEED_N], dtype=np.uint64)
# Complement seeds: RC[x] = H[complement(x)].
RC_BY_CODE = np.array([SEED_T, SEED_G, SEED_C, SEED_A, SEED_N, SEED_N], dtype=np.uint64)

_U64 = np.uint64


def _rotl_np(x: np.ndarray, r: int) -> np.ndarray:
    r &= 63
    if r == 0:
        return x
    return (x << _U64(r)) | (x >> _U64(64 - r))


def nthash_windows_np(codes: np.ndarray, l: int) -> tuple[np.ndarray, np.ndarray]:
    """(fh, rh) for every l-window of a 1-D base-code array.

    Returns arrays of length n-l+1 (empty if n < l).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    if n < l:
        e = np.zeros(0, dtype=_U64)
        return e, e
    h = H_BY_CODE[codes]
    rc = RC_BY_CODE[codes]
    m = n - l + 1
    fh = np.zeros(m, dtype=_U64)
    rh = np.zeros(m, dtype=_U64)
    for j in range(l):
        fh ^= _rotl_np(h[j : j + m], l - 1 - j)
        rh ^= _rotl_np(rc[j : j + m], j)
    return fh, rh


def ntc64(seq: str | bytes, l: int | None = None) -> int:
    """Canonical ntHash of a whole string (nthash crate's `ntc64(s, 0, l)`)."""
    from ..utils.seq import encode_bases

    codes = encode_bases(seq)
    if l is None:
        l = len(codes)
    fh, rh = nthash_windows_np(codes[:l], l)
    return int(min(fh[0], rh[0]))


def nthash_windows(codes: torch.Tensor, l: int):
    """Batched (fh, rh) over padded code tensors, as int64 bit patterns.

    codes: uint8 [B, L]. Returns (fh, rh) int64 [B, L]; entry i is the hash
    of window [i, i+l), with zero seeds past the row end (the JAX twin's
    padding), so positions with i+l > L hold a partial hash that the caller
    masks against the true sequence length.
    """
    idx = codes.long()
    h = u64.from_numpy(H_BY_CODE, codes.device)[idx]
    rc = u64.from_numpy(RC_BY_CODE, codes.device)[idx]
    fh = torch.zeros_like(h)
    rh = torch.zeros_like(h)
    L = codes.shape[-1]
    for j in range(min(l, L)):
        fh[..., : L - j] ^= u64.rotl(h[..., j:], l - 1 - j)
        rh[..., : L - j] ^= u64.rotl(rc[..., j:], j)
    return fh, rh
