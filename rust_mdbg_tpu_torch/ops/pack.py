"""2-bit base packing for the host->device feed.

Read codes are 0..3 (A/C/G/T), 4 (N) or 5 (pad).  The feed packs 4 codes per
byte plus a 1 bit/base invalid mask (N or pad), 0.375 B/base on the wire
instead of 1.  Packing runs on the host before the transfer: the native
parser writes these planes itself, in its parallel encode (native/fastx.cpp
fx_next_packed); pack_codes_np packs codes everywhere else, through
core/fastx_feed.host_feed (an over-long read, the pure-Python reader, the
sharded drivers' rounds) and in the bench.  Unpacking runs on the device per batch
inside the construct loop, so the full-width [chunk, L] byte tensor never
exists in device memory.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_codes_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[N, L] u8 codes -> (packed [N, L//4] u8, invalid-mask [N, L//8] u8).

    L must be a multiple of 8 (the staging width is always a multiple of
    512).  Invalid positions (code > 3) set the mask bit; their 2-bit plane
    encodes WHICH invalid code: 0 -> N (code 4), 1 -> pad/other (code 5).
    N must round-trip exactly — it is a real base to the HPC rule
    (rust-mdbg src/read.rs:163 compresses N runs) while 'other' is
    not, so collapsing the two shifts minimizer positions on any read with
    an NN run."""
    N, L = codes.shape
    assert L % 8 == 0, L
    bad = codes > 3
    c = np.where(bad, (codes != 4).astype(np.uint8), codes).astype(np.uint8)
    packed = (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
              | (c[:, 3::4] << 6))
    mask = np.packbits(bad, axis=1, bitorder="little")
    return packed, mask


def unpack_codes(packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Device inverse of pack_codes_np: -> [B, L] u8 (4 = N, 5 = pad)."""
    B, L4 = packed.shape
    dev = packed.device
    sh = torch.arange(0, 8, 2, dtype=torch.uint8, device=dev)
    codes = ((packed[:, :, None] >> sh) & 3).reshape(B, L4 * 4)
    bits = torch.arange(8, dtype=torch.uint8, device=dev)
    bad = ((mask[:, :, None] >> bits) & 1).reshape(B, L4 * 4)
    return torch.where(bad == 1, codes + 4, codes)
