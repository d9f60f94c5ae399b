"""The .sequences writer and the GFA phase (abundance filter, edge join,
GFA writer) a read-Gbp."""

from . import phase_s_per_gbp


def read(ctx):
    return phase_s_per_gbp(ctx, ("sequences", "gfa"))
