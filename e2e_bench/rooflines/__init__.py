"""Each module here gives one kernel's least bytes for a job's work: the
bytes the job's inputs need, each input byte read once and each output
byte written once, counted from the reads (not from the launched shapes,
so padding counts as waste).  `roofline_pct` turns them into a share of
the card's memory roofline over the kernel's device time."""

from __future__ import annotations

from ..peaks import peaks
from ..run import load_module
from ..trace import kernel_seconds


def roofline_pct(ctx: dict, kernel: str) -> float | None:
    """100 x (the kernel's least bytes / the card's bytes per second) / its
    summed device seconds in the profiled job; None where the job ran no
    such kernel, the card is not in the table of peaks, or there was no
    profile."""
    prof, work = ctx.get("profile"), ctx.get("work")
    pk = peaks(ctx.get("device_name", ""))
    if not prof or not work or pk is None:
        return None
    mod = load_module("rooflines", kernel)
    s, n = kernel_seconds(prof, mod.FUNCTION)
    if n == 0 or s <= 0:
        return None
    least_s = mod.least_bytes(work, ctx["config"]) / pk["hbm_bytes_per_s"]
    return 100.0 * least_s / s
