"""The port's span record, RSS reporting and the torch.profiler hook.

The reference's observability is a progress bar + total wall clock + max RSS
(rust-mdbg src/main.rs:543,1157-1159); this adds spans: each phase of a
run, on whichever thread runs it, with its start, end, CPU seconds, chunk
and parent, as a `record_function` range beside it.  `stats["phases"]`
sums them by name; the bench harness and experiment scripts consume both.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import resource
import subprocess
import threading
import time

from torch.profiler import record_function

#: the root span of a whole run (core.pipeline.assemble, the sharded
#: drivers, a bench rep)
JOB = "job"


def max_rss_bytes() -> int:
    """Peak resident set size in bytes (getrusage, like main.rs:139-148)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def vm_rss_bytes() -> int:
    """The process's resident set size now, in bytes (VmRSS of
    /proc/self/status); 0 where the kernel gives none."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


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
    """torch.profiler around the block, on every thread of the process
    (the feed threads' spans too), CPU activity plus CUDA activity when a
    card is present; the Chrome trace is written to
    profile_dir/<name>.<pid>.<ns>.pt.trace.json."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def trace_us(clock: tuple, ns: int, base_ns: int) -> float:
    """A span's perf_counter_ns time on a Chrome trace's clock (µs), from
    its timer's `clock` pair and the trace's baseTimeNanoseconds: the
    trace's `ts` plus base / 1000 is the wall clock in µs."""
    return (clock[0] + ns - clock[1] - base_ns) / 1e3


class PhaseTimer:
    """The port's span record.

    A span keeps its `name`, its `thread`'s name, `start_ns` and `end_ns`
    (time.perf_counter_ns), `cpu_s` (the thread's CPU seconds over it),
    the `chunk` it worked on (None outside one), its `id` and its
    `parent`: the span open on the same thread, else the open JOB span.
    Each span also opens a torch.profiler `record_function` range of its
    name on its thread.  `clock` is one (time.time_ns, perf_counter_ns)
    pair read together: it puts a span on the wall clock, and so on a
    trace's (trace_us).  Spans close and counters count from any thread."""

    def __init__(self):
        self.clock = (time.time_ns(), time.perf_counter_ns())
        self.spans: list[dict] = []
        self.counters: dict = {}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._open = threading.local()
        self._job: int | None = None

    @contextlib.contextmanager
    def phase(self, name: str, chunk: int | None = None,
              profile_dir: str | None = None):
        """Record the block as span `name` of chunk `chunk`; with
        profile_dir, trace it with torch.profiler into that directory (the
        counterpart of the JAX package's jax.profiler.trace).  Yields the
        span's dict: the block may set its `chunk`."""
        stack = self._open.__dict__.setdefault("stack", [])
        span = dict(id=next(self._ids), name=name,
                    thread=threading.current_thread().name,
                    parent=stack[-1] if stack else self._job, chunk=chunk)
        ctx = (_profiled(profile_dir, name) if profile_dir
               else contextlib.nullcontext())
        with ctx, record_function(name):
            t0, cpu0 = time.perf_counter_ns(), time.thread_time()
            stack.append(span["id"])
            try:
                yield span
            finally:
                span.update(start_ns=t0, end_ns=time.perf_counter_ns(),
                            cpu_s=time.thread_time() - cpu0)
                stack.pop()
                with self._lock:
                    self.spans.append(span)
                if self._job is not None:
                    self.high("rss_high_bytes", vm_rss_bytes())

    @contextlib.contextmanager
    def job(self):
        """The root span JOB around a whole run.  Counters: VmRSS at its
        start (`rss_start_bytes`) and the highest VmRSS read at the end of
        any span while it is open, its own included (`rss_high_bytes`)."""
        rss = vm_rss_bytes()
        with self._lock:
            self.counters.update(rss_start_bytes=rss, rss_high_bytes=rss)
        try:
            with self.phase(JOB) as span:
                self._job = span["id"]
                yield span
        finally:
            self._job = None

    def count(self, name: str, n: int):
        """Add n to the counter `name`."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def high(self, name: str, n: int):
        """Raise the counter `name` to n where n is above it: a high-water
        mark (0 before the first reading)."""
        with self._lock:
            self.counters[name] = max(self.counters.get(name, 0), n)

    @property
    def phases(self) -> list[tuple[str, float]]:
        """(name, seconds) of every span, in the order they closed."""
        with self._lock:
            return [(s["name"], (s["end_ns"] - s["start_ns"]) / 1e9)
                    for s in self.spans]

    def report(self) -> dict:
        """Total seconds per span name (spans may repeat, e.g. per chunk)."""
        out: dict[str, float] = {}
        for name, dt in self.phases:
            out[name] = out.get(name, 0.0) + dt
        return {name: round(dt, 4) for name, dt in out.items()}

    def stats(self) -> dict:
        """A run's stats from the record: `phases` (report), `spans` (a
        copy of each, in the order they closed), `counters` and
        `span_clock` (the clock pair, as a list)."""
        with self._lock:
            spans = [dict(s) for s in self.spans]
            counters = dict(self.counters)
        return dict(phases=self.report(), spans=spans, counters=counters,
                    span_clock=list(self.clock))
