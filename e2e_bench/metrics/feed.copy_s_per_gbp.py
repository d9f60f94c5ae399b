"""The feed's copy to the card (the `feed.copy` spans on the staging
thread: the chunk's arrays copied on the side stream, its event recorded),
a read-Gbp."""

from . import phase_s_per_gbp


def read(ctx):
    return phase_s_per_gbp(ctx, ("feed.copy",))
