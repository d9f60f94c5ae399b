"""The chunked driver's merge phase a read-Gbp: the native node table's
merge of each chunk's unique keys (abundances, the Bloom screen, the
crossing selection)."""

from . import phase_s_per_gbp


def read(ctx):
    return phase_s_per_gbp(ctx, ("merge",))
