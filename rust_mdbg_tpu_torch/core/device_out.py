"""The gate of recompute mode (the JAX package's `core/device_out.py` also
holds the whole-run path's lazy fetch, which is not ported yet)."""

from __future__ import annotations


def minimizer_recompute_ok(params) -> bool:
    """True when stored node sequences live in the same space the density
    hash ran over, so native/seqwriter.cpp can re-derive minimizer values
    from sequence bytes: plain density scheme (no syncmers/UHS/LCP/robust
    remap) over reads that are already homopolymer-compressed (otherwise
    device hashing is HPC-space while the stored seq is raw-space)."""
    return (getattr(params, "reads_already_hpc", False)
            and not params.use_syncmers
            and not params.uhs
            and not params.lcp
            and not params.has_lmer_counts)
