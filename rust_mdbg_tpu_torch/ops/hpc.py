"""Homopolymer compression (HPC) with raw-position maps.

Parity target: `Read::encode_rle` (rust-mdbg src/read.rs:157-174): a char
is dropped iff it equals the previous char AND is in "ACTGactgNn"; the kept
position map records the raw index of each run start.  With base codes
(A..T, N in the set; code 5 = other, never compresses) the keep mask is a
shifted compare, and compaction is a row prefix sum plus one scatter.
"""

from __future__ import annotations

import torch


def hpc(codes: torch.Tensor, lengths: torch.Tensor):
    """Batched HPC compaction.

    codes: uint8 [B, L] (padded); lengths: int32 [B].
    Returns (hpc_codes u8 [B, L], pos_map int32 [B, L], hpc_len int32 [B]).
    Padding positions hold code 4 (N) and pos_map L-1, masked downstream by
    hpc_len — the same outputs as the JAX package's `hpc_jax`.
    """
    B, L = codes.shape
    dev = codes.device
    idx = torch.arange(L, dtype=torch.int32, device=dev)
    valid = idx[None, :] < lengths[:, None]
    keep = torch.ones_like(valid)
    keep[:, 1:] = codes[:, 1:] != codes[:, :-1]
    keep = (keep | (codes == 5)) & valid
    hpc_len = keep.sum(dim=1, dtype=torch.int32)
    # kept bases go to their rank; dropped ones to the spare column L
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, L)
    hpc_codes = torch.full((B, L + 1), 4, dtype=torch.uint8, device=dev)
    pos_map = torch.full((B, L + 1), L - 1, dtype=torch.int32, device=dev)
    hpc_codes.scatter_(1, dest, codes)
    pos_map.scatter_(1, dest, idx.expand(B, L).contiguous())
    return (hpc_codes[:, :L].contiguous(), pos_map[:, :L].contiguous(),
            hpc_len)
