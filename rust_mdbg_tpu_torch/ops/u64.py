"""Unsigned 64-bit values in int64 tensors.

torch's uint64 dtype lacks compares, shifts, `minimum` and `searchsorted`,
so the port stores every u64 as the int64 with the same bits.  Wrapping
add and multiply then give the same bits as the unsigned op.  Three rules
follow, and this module is where they live:

- an unsigned compare or sort flips the sign bit of both sides first;
- a right shift masks after `>>` (int64 shift is arithmetic);
- the all-ones sentinel `~uint64(0)` is -1 as int64 and must still sort
  last, which the sign flip gives (it becomes int64 max).
"""

from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)          # int64 with only the top bit set
SENTINEL = -1              # ~uint64(0) as int64
U32_MAX = 0xFFFFFFFF       # the u32 sentinel, held in int64 tensors


def s64(v: int) -> int:
    """Python int in [0, 2^64) -> the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def flip(x: torch.Tensor) -> torch.Tensor:
    """Map u64 order onto int64 order (an involution)."""
    return x ^ SIGN


def lt(a: torch.Tensor, b) -> torch.Tensor:
    return flip(a) < _flip_any(b)


def le(a: torch.Tensor, b) -> torch.Tensor:
    return flip(a) <= _flip_any(b)


def gt(a: torch.Tensor, b) -> torch.Tensor:
    return flip(a) > _flip_any(b)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(lt(a, b), a, b)


def _flip_any(b):
    if isinstance(b, torch.Tensor):
        return flip(b)
    return s64(b) ^ SIGN


def shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by a constant 0 <= r < 64."""
    if r == 0:
        return x
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    r &= 63
    if r == 0:
        return x
    return (x << r) | shr(x, 64 - r)


def lexsort(keys: list[torch.Tensor], unsigned: list[bool]) -> torch.Tensor:
    """Permutation that sorts 1-D `keys` lexicographically, the first key
    most significant.  Stable passes run least-significant key first, so
    ties on every key keep input order.  Keys flagged `unsigned` hold u64
    bit patterns and are compared as unsigned."""
    perm = None
    for key, uns in zip(reversed(keys), reversed(unsigned)):
        k = key if perm is None else key[perm]
        if uns:
            k = flip(k)
        idx = torch.sort(k, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint64 -> int64 tensor with the same bits on `device` (always
    a copy: the tensor never aliases the array)."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return torch.from_numpy(a.view(np.int64)).to(device, copy=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of u64 bit patterns -> numpy uint64."""
    return t.detach().cpu().numpy().astype(np.int64, copy=False).view(np.uint64)


def mod_small(x: torch.Tensor, n: int) -> torch.Tensor:
    """Unsigned remainder of u64 bit patterns by a constant 0 < n < 2^31.

    int64 `%` reads a pattern at or above 2^63 as negative, which gives the
    wrong class whenever n is not a power of two.  The halves hi * 2^32 +
    lo are each below 2^32, so (hi % n) * (2^32 % n) + lo % n stays far
    below 2^63."""
    if not 0 < n < (1 << 31):
        raise ValueError(f"modulus {n} outside (0, 2^31)")
    hi = shr(x, 32)
    lo = x & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


_M1 = s64(0x5555555555555555)
_M2 = s64(0x3333333333333333)
_M4 = s64(0x0F0F0F0F0F0F0F0F)
_H01 = s64(0x0101010101010101)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u64 bit pattern (bit-sliced: pairs, nibbles, bytes,
    then one multiply sums the bytes into the top byte)."""
    x = x - (shr(x, 1) & _M1)
    x = (x & _M2) + (shr(x, 2) & _M2)
    x = (x + shr(x, 4)) & _M4
    return shr(x * _H01, 56)
