"""Phase timing, RSS reporting and the (optional) torch.profiler hook.

The reference's observability is a progress bar + total wall clock + max RSS
(rust-mdbg src/main.rs:543,1157-1159); this adds structured per-phase
timing, which the bench harness and experiment scripts consume.
"""

from __future__ import annotations

import contextlib
import os
import resource
import subprocess
import time


def max_rss_bytes() -> int:
    """Peak resident set size in bytes (getrusage, like main.rs:139-148)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def card_info(device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them
    (`name, power.limit`) for a CUDA device, None for the CPU.  The
    device's index is taken as nvidia-smi's (they differ only under
    CUDA_VISIBLE_DEVICES)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


@contextlib.contextmanager
def _profiled(profile_dir: str, name: str):
    """torch.profiler around the block, CPU activity plus CUDA activity
    when a card is present; the Chrome trace is written to
    profile_dir/<name>.<pid>.<ns>.pt.trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


class PhaseTimer:
    def __init__(self):
        self.phases: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str, profile_dir: str | None = None):
        """Time the block as phase `name`; with profile_dir, trace it with
        torch.profiler into that directory (the counterpart of the JAX
        package's jax.profiler.trace)."""
        t0 = time.perf_counter()
        ctx = (_profiled(profile_dir, name) if profile_dir
               else contextlib.nullcontext())
        with ctx:
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
