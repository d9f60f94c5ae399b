"""compact_minimizers's share of the card's memory roofline in one profiled job: the
least time its bytes need (rooflines/compact_minimizers.py) over its summed device
time."""

from ..rooflines import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "compact_minimizers")
