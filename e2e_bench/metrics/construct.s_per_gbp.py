"""The chunked driver's construct phase a read-Gbp: the card's unpack,
HPC, minimizer selection, compaction, window keys and the per-chunk
reduction, timed on the host (it includes waiting for the card)."""

from . import phase_s_per_gbp


def read(ctx):
    return phase_s_per_gbp(ctx, ("construct",))
