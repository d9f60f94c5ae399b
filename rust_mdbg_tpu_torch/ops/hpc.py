"""Homopolymer compression (HPC) with raw-position maps.

Parity target: `Read::encode_rle` (rust-mdbg src/read.rs:157-174): a char
is dropped iff it equals the previous char AND is in "ACTGactgNn"; the kept
position map records the raw index of each run start.  With base codes
(A..T, N in the set; code 5 = other, never compresses) the keep mask is a
shifted compare, and compaction is a row prefix sum plus one scatter.
"""

from __future__ import annotations

import numpy as np
import torch


def hpc_mask_np(codes: np.ndarray) -> np.ndarray:
    """Boolean keep-mask over a 1-D base-code array."""
    n = codes.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    keep = np.empty(n, dtype=bool)
    keep[0] = True
    keep[1:] = codes[1:] != codes[:-1]
    keep |= codes == 5  # non-HPC characters never compress
    return keep


def encode_rle_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(hpc_codes, pos_map): compacted codes + raw index of each kept char."""
    keep = hpc_mask_np(codes)
    pos = np.nonzero(keep)[0]
    return codes[pos], pos


def extent_ends_np(codes: np.ndarray, pos: np.ndarray, l: int,
                   already_hpc: bool = False) -> np.ndarray:
    """Raw END of the full HPC extent of each minimizer l-mer.

    `pos` holds raw-sequence starts of selected l-mers (HPC run starts, as
    extract_density_np returns).  The l-mer covers l HPC bases; its raw
    extent ends at the raw start of the NEXT HPC base (= the end of the last
    base's homopolymer run), or at the raw read end when the run reaches it.

    This is the datum the reference's span cut `minimizers_pos[i+k-1] + l`
    (main.rs:778) approximates: +l truncates mid-run whenever the l-mer
    contains homopolymers, which makes to_basespace junctions inexact on raw
    (non-pre-HPC'd) inputs when adjacent nodes were recorded in different
    orientations.  Recording full-extent spans (and end-distance shifts)
    makes the cut rule exact by construction; on already-HPC'd inputs every
    run has length 1, so extent == l and this reduces to pos + l.
    """
    pos = np.asarray(pos, dtype=np.int64)
    if already_hpc:
        return pos + l
    _, pos_map = encode_rle_np(codes)
    ext_map = np.concatenate(
        [pos_map, np.asarray([codes.shape[0]], dtype=pos_map.dtype)])
    hpc_idx = np.searchsorted(pos_map, pos)
    return ext_map[np.minimum(hpc_idx + l, ext_map.shape[0] - 1)]


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
