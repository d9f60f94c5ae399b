"""The feed's parse (the native parser's `feed.parse` spans on its
prefetch thread: chunk buffers allocated, records parsed and encoded), a
read-Gbp."""

from . import phase_s_per_gbp


def read(ctx):
    return phase_s_per_gbp(ctx, ("feed.parse",))
