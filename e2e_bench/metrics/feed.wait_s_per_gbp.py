"""The chunked driver's wait for the next staged chunk (its feed-wait
phase: parse, 2-bit pack and copy to the card run ahead in a thread), a
read-Gbp."""

from . import phase_s_per_gbp


def read(ctx):
    return phase_s_per_gbp(ctx, ("feed-wait",))
