"""Phase timing and RSS reporting.

The reference's observability is a progress bar + total wall clock + max RSS
(rust-mdbg src/main.rs:543,1157-1159); this adds structured per-phase
timing, which the bench harness and experiment scripts consume.
"""

from __future__ import annotations

import contextlib
import resource
import time


def max_rss_bytes() -> int:
    """Peak resident set size in bytes (getrusage, like main.rs:139-148)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class PhaseTimer:
    def __init__(self):
        self.phases: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.phases.append((name, time.perf_counter() - t0))

    def report(self) -> dict:
        """Total seconds per phase name (phases may repeat, e.g. per chunk)."""
        out: dict[str, float] = {}
        for name, dt in self.phases:
            out[name] = out.get(name, 0.0) + dt
        return {name: round(dt, 4) for name, dt in out.items()}

    def report_stats(self) -> dict:
        """Per-phase {n, total, mean, max} for repeated phases (chunk loops):
        the max exposes stragglers that a sum hides."""
        acc: dict[str, list[float]] = {}
        for name, dt in self.phases:
            acc.setdefault(name, []).append(dt)
        return {
            name: dict(n=len(v), total=round(sum(v), 4),
                       mean=round(sum(v) / len(v), 4), max=round(max(v), 4))
            for name, v in acc.items()
        }

    def total(self) -> float:
        return sum(dt for _, dt in self.phases)
