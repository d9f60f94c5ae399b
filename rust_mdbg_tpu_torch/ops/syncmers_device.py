"""Open-syncmer selection on the device: exact parity with the host state
machine in ops/minimizers.extract_syncmers_np (rust-mdbg src/read.rs:215-352).

Counterpart of the JAX package's `ops/syncmers_device.py`.  The reference
tracks the sliding-window minimum s-mer with a queue whose tie-breaking is
path-dependent (s-mer hashes are masked to 2s bits, so ties are common):
the first full window takes the leftmost minimum; when the incumbent is
evicted the rescan lands on the rightmost minimum; an incoming equal value
never displaces the incumbent.  Writing i_a for the tracked position at
window a, the transition is

    i_a = lpos[a]    if window a is the first full window of an N-free run
          rpos[a]    if i_{a-1} < a (incumbent evicted) or the entering
                     s-mer is the strict minimum of the window
          i_{a-1}    otherwise

where lpos / rpos are the leftmost / rightmost argmins of each window: O(w)
shifted elementwise passes over [B, L].  This module holds those planes in
plain torch (`syncmer_planes`); the selection itself is
ops/kernels.syncmer_select: on a CUDA tensor the fused kernel
csrc/syncmer_select.cu, which computes the hash, the planes and the
recurrence in one pass and writes none of the planes, and on a CPU tensor
its plain version `syncmer_select_plain` (these planes, then the column
scan `syncmer_incumbent_plain`).  The JAX package's three-pass
transfer-table form exists because a per-lane loop is slow on a TPU;
nothing here needs it, and no switch puts a plain form in the kernel's
place on the card.

Selection: window a is emitted iff the incumbent sits at window offset t-1
and the canonical l-mer's invertible hash passes the density bound
(read.rs:217).

Hashes are u64 bit patterns in int64 tensors (ops/u64.py).
"""

from __future__ import annotations

import torch

from . import u64

_I64_MAX = (1 << 63) - 1


def invertible_hash(key: torch.Tensor, mask_bits: int) -> torch.Tensor:
    """64-bit invertible mix hash (read.rs:43-52) masked to `mask_bits`."""
    mask = u64.s64((1 << mask_bits) - 1)
    key = (~key + (key << 21)) & mask
    key = key ^ u64.shr(key, 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ u64.shr(key, 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ u64.shr(key, 28)
    key = (key + (key << 31)) & mask
    return key


def _shl(x: torch.Tensor, j: int, fill) -> torch.Tensor:
    """x[:, a+j] as a [B, L] tensor (tail filled)."""
    if j == 0:
        return x
    out = torch.full_like(x, fill)
    if j < x.shape[1]:
        out[:, : x.shape[1] - j] = x[:, j:]
    return out


def _packed_canonical_hash(c, ok_prefix, width: int, hpc_len):
    """Invertible hash of min(2-bit fwd packing, rc packing) of every
    width-window; all ones where the window has an N or runs past the end."""
    B, L = c.shape
    idx = torch.arange(L, dtype=torch.int32, device=c.device)
    fwd = torch.zeros((B, L), dtype=torch.int64, device=c.device)
    rev = torch.zeros((B, L), dtype=torch.int64, device=c.device)
    for j in range(width):
        cj = _shl(c, j, 0)
        fwd = (fwd << 2) | cj
        rev = rev | ((3 - cj) << (2 * j))
    mask = u64.s64((1 << (2 * width)) - 1)
    h = invertible_hash(u64.minimum(fwd & mask, rev & mask), 2 * width)
    # window valid iff no invalid base in [a, a+width-1] and in-bounds
    before = _shl_right1(ok_prefix)
    upto = _shl(ok_prefix, width - 1, 2 ** 30)
    win_ok = ((upto - before) == 0) & (idx[None, :] + width <= hpc_len[:, None])
    return torch.where(win_ok, h, u64.SENTINEL), win_ok


def _shl_right1(x: torch.Tensor) -> torch.Tensor:
    """x[:, a-1] with a zero first column."""
    out = torch.zeros_like(x)
    out[:, 1:] = x[:, :-1]
    return out


def syncmer_planes(hpc_codes: torch.Tensor, hpc_len: torch.Tensor, *, l: int,
                   s: int, bound: int) -> dict:
    """The data-parallel front half of kernels.syncmer_select_plain: the
    canonical l-mer hash `hl`, its validity `valid_l` and density pass
    `passed`, and (for s > 0) the four planes of the incumbent recurrence: `lpos`, `rpos`
    int32 and `run_start`, `strict_new` bool, all [B, L]."""
    B, L = hpc_codes.shape
    dev = hpc_codes.device
    idx = torch.arange(L, dtype=torch.int32, device=dev)
    ok = (hpc_codes < 4) & (idx[None, :] < hpc_len[:, None])
    c = torch.where(ok, hpc_codes, 0).to(torch.int64)
    ok_prefix = torch.cumsum((~ok).to(torch.int32), dim=1, dtype=torch.int32)

    hl, valid_l = _packed_canonical_hash(c, ok_prefix, l, hpc_len)
    out = dict(hl=hl, valid_l=valid_l, passed=u64.le(hl, bound))
    if s == 0:
        return out

    hs, _ = _packed_canonical_hash(c, ok_prefix, s, hpc_len)
    w = l - s + 1
    # sliding stats over the w s-mers of each l-mer window, on sign-flipped
    # hashes: unsigned order as plain int64 order, the all-ones fill last
    hsf = u64.flip(hs)
    best = torch.full((B, L), _I64_MAX, dtype=torch.int64, device=dev)
    lpos = torch.zeros((B, L), dtype=torch.int32, device=dev)
    rpos = torch.zeros((B, L), dtype=torch.int32, device=dev)
    best_w1 = None  # min over the first w-1 elements
    for j in range(w):
        if j == w - 1:
            best_w1 = best
        hj = _shl(hsf, j, _I64_MAX)
        posj = idx[None, :] + j
        lpos = torch.where(hj < best, posj, lpos)
        rpos = torch.where(hj <= best, posj, rpos)
        best = torch.minimum(best, hj)
    strict_new = _shl(hsf, w - 1, _I64_MAX) < best_w1

    # first window of each N-free run: incumbent = leftmost argmin
    run_start = valid_l & ~_shl_right1(valid_l)
    out.update(lpos=lpos, rpos=rpos, run_start=run_start,
               strict_new=strict_new)
    return out
