"""Reading a torch.profiler Chrome trace: device busy time, kernel time by
name, and the idle gaps.

The arithmetic is a copy of the port's `bench.trace_breakdown`: the device
is busy while a kernel, a copy or a fill runs on it (the union of those
events), over the window of the host-side range named `anchor`.
"""

from __future__ import annotations

import json

#: trace categories that occupy the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host-side categories an idle gap is named by
HOST_CATS = ("user_annotation", "cpu_op", "python_function")


def short_name(name: str, width: int = 96) -> str:
    """A kernel's or operation's name without namespaces, templates'
    noise and arguments, cut to `width` characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::cuda::detail::"):
        name = name.replace(junk, "")
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:width].strip()


def read_trace(path: str, anchor: str, n_top: int = 10) -> dict:
    """The device's activity over the host range `anchor`: the window's
    seconds, the busy seconds (union of device events clipped to the
    window), device seconds and launches by kernel name, and the longest
    idle gaps named by the innermost host event open across each."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    a = next(e for e in events if e.get("name") == anchor
             and e.get("cat") in HOST_CATS)
    lo = float(a["ts"])
    hi = lo + float(a["dur"])
    by_name: dict = {}
    busy = []
    dev_events = []
    host = []
    for e in events:
        s, d = float(e["ts"]), float(e.get("dur", 0))
        cat = e.get("cat")
        if cat in HOST_CATS and e is not a:
            host.append((s, s + d, e["name"]))
        if cat not in DEVICE_CATS or s + d <= lo or s >= hi:
            continue
        busy.append((max(s, lo), min(s + d, hi)))
        dev_events.append((s, s + d, e["name"]))
        if cat == "kernel":
            r = by_name.setdefault(e["name"], [0.0, 0])
            r[0] += d
            r[1] += 1
    merged: list = []
    for s, t in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_us = sum(t - s for s, t in merged)
    edges = [lo] + [x for st in merged for x in st] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    dev_events.sort()

    def gap_name(s, t):
        open_ = [(b - a_, n) for a_, b, n in host if a_ <= s and b >= t]
        inner = min(open_)[1] if open_ else anchor
        before = [n for a_, b, n in dev_events if b <= s]
        after = f" after {short_name(before[-1])}" if before else ""
        return f"{short_name(inner)}{after}"

    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]
    return dict(
        window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
        kernels={k: dict(s=us / 1e6, launches=n)
                 for k, (us, n) in by_name.items()},
        device_ops=[[short_name(k), us / 1e6] for k, (us, _) in top],
        idle_gaps=[[gap_name(s, t), (t - s) / 1e6]
                   for s, t in gaps[:n_top]])


def kernel_seconds(profile: dict, kernel: str) -> tuple[float, int]:
    """Summed device seconds and launches of the kernels whose function
    name is `kernel` (templates and arguments aside)."""
    s = n = 0
    for name, r in profile["kernels"].items():
        if short_name(name, 10_000).split("<")[0].strip() == kernel:
            s += r["s"]
            n += r["launches"]
    return s, n
