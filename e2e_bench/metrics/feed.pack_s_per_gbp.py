"""The feed's pack (the `feed.pack` spans on the staging thread: the cut to
the half width and the 2-bit pack, an over-long read widened first), a
read-Gbp."""

from . import phase_s_per_gbp


def read(ctx):
    return phase_s_per_gbp(ctx, ("feed.pack",))
