"""Read -> k-min-mer window extraction engines.

All engines produce the same `WindowBatch` contract so the pipeline, node
table, and outputs are engine-agnostic:

- host engine (here): numpy per-read reference implementation, the numerics
  oracle (mirrors Read::extract + the main.rs:756-781 windowing loop).
- device engine (ops/extract.py): the torch implementation over padded
  batch tensors; identical outputs, tested against this one.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.kminmer import fingerprint128_np, window_kminmers_np
from ..ops.minimizers import extract_density_np, extract_syncmers_np


@dataclasses.dataclass
class WindowBatch:
    """Flattened k-min-mer windows for one read batch, in (read, window) order."""

    key_lo: np.ndarray      # uint64 [N]
    key_hi: np.ndarray      # uint64 [N]
    seqlen: np.ndarray      # uint32 [N]  (pos[i+k-1]-pos[i]+2, main.rs:778)
    shift0: np.ndarray      # uint16 [N]  (orientation-adjusted, node-table/GFA)
    shift1: np.ndarray      # uint16 [N]
    reversed_: np.ndarray   # bool   [N]
    read_row: np.ndarray    # int32  [N]  row in the ReadBatch
    start: np.ndarray       # int64  [N]  raw seq slice start (pos[i])
    end: np.ndarray         # int64  [N]  raw record span end: full HPC extent
    #                         of the last l-mer (ops/hpc.extent_ends_np), or
    #                         pos[i+k-1]+l under seq_ref_cuts / quirk schemes
    # .sequences cut pair (exact junctions; == shift0/1 when spans are pos+l)
    seq_shift0: np.ndarray  # uint16 [N]
    seq_shift1: np.ndarray  # uint16 [N]
    vecs: np.ndarray        # uint64 [N, k]  canonical minimizer vectors
    # per-read minimizer data (for EC / ec_data): row -> (positions, hashes)
    minimizers: list

    @property
    def n_windows(self) -> int:
        return len(self.key_lo)


def extract_minimizers_host(codes: np.ndarray, params, minimizer_to_int=None,
                            uhs_filter=None, lcp_filter=None):
    """Scheme dispatch for one read (Read::extract, read.rs:85-90)."""
    remap = (
        minimizer_to_int
        if (params.error_correct or params.has_lmer_counts)
        else None
    )
    if params.uhs and uhs_filter is not None:
        from ..ops.minimizers import extract_filtered_np

        return extract_filtered_np(
            codes, params.l, params.hash_bound, uhs_filter,
            already_hpc=params.reads_already_hpc, minimizer_to_int=remap,
        )
    if params.lcp and lcp_filter is not None:
        from ..ops.minimizers import extract_filtered_np

        return extract_filtered_np(
            codes, params.l, params.hash_bound, lcp_filter,
            already_hpc=params.reads_already_hpc, minimizer_to_int=remap,
            skip_n=True,
        )
    if params.use_syncmers:
        return extract_syncmers_np(
            codes, params.l, params.s, params.syncmer_hash_bound,
            already_hpc=params.reads_already_hpc,
        )
    return extract_density_np(
        codes, params.l, params.hash_bound,
        already_hpc=params.reads_already_hpc,
        minimizer_to_int=remap,
    )


def extract_windows_host(batch, params, minimizer_to_int=None,
                         uhs_filter=None, lcp_filter=None,
                         minimizer_fn=None) -> WindowBatch:
    """minimizer_fn: optional per-read (codes) -> (pos, hashes) override of
    extract_minimizers_host — the device-tiled long-sequence path
    (ops/extract.extract_minimizers_tiled) plugs in here so Mbp-scale
    sequences hash on device while the (cheap) windowing stays host-side."""
    k, l = params.k, params.l
    key_lo, key_hi = [], []
    seqlen, s0, s1, rev, rows, starts, ends = [], [], [], [], [], [], []
    q0, q1 = [], []
    vecs = []
    minims = []
    # exact-junction record spans need full HPC extents; the UHS/LCP quirk
    # schemes carry HPC-space positions (pos + l is self-consistent there)
    # and seq_ref_cuts pins the reference's raw+l semantics (parity oracle)
    want_ends = not (params.uhs or params.lcp
                     or getattr(params, "seq_ref_cuts", False))
    if want_ends:
        from ..ops.hpc import extent_ends_np
    B = batch.codes.shape[0]
    for row in range(B):
        n = int(batch.lengths[row])
        if n == 0:
            minims.append(None)
            continue
        codes = batch.codes[row, :n]
        if minimizer_fn is not None:
            pos, hashes = minimizer_fn(codes)
        else:
            pos, hashes = extract_minimizers_host(
                codes, params, minimizer_to_int, uhs_filter, lcp_filter
            )
        minims.append((pos, hashes))
        if hashes.shape[0] <= k:  # strict: main.rs:756
            continue
        pos_end = (extent_ends_np(codes, pos, l,
                                  already_hpc=params.reads_already_hpc)
                   if want_ends else None)
        for w in window_kminmers_np(pos, hashes, k, l, pos_end=pos_end):
            vecs.append(w["vec"])
            seqlen.append(w["seqlen"])
            s0.append(w["shift"][0])
            s1.append(w["shift"][1])
            q0.append(w["seq_shift"][0])
            q1.append(w["seq_shift"][1])
            rev.append(w["reversed"])
            rows.append(row)
            starts.append(w["start"])
            ends.append(w["end"])
    if vecs:
        va = np.asarray(vecs, dtype=np.uint64)
        fp = fingerprint128_np(va)
        klo, khi = fp[:, 0], fp[:, 1]
    else:
        va = np.zeros((0, k), dtype=np.uint64)
        klo = khi = np.zeros(0, dtype=np.uint64)
    return WindowBatch(
        key_lo=klo, key_hi=khi,
        seqlen=np.asarray(seqlen, dtype=np.uint32),
        shift0=np.asarray(s0, dtype=np.uint16),
        shift1=np.asarray(s1, dtype=np.uint16),
        reversed_=np.asarray(rev, dtype=bool),
        read_row=np.asarray(rows, dtype=np.int32),
        start=np.asarray(starts, dtype=np.int64),
        end=np.asarray(ends, dtype=np.int64),
        seq_shift0=np.asarray(q0, dtype=np.uint16),
        seq_shift1=np.asarray(q1, dtype=np.uint16),
        vecs=va,
        minimizers=minims,
    )
