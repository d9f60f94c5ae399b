"""The driver's self time a read-Gbp: each window job's `job` span less
the union of its direct children on the job's own thread (plan, compile,
setup, stream, gfa), summed over the jobs that report one."""


def self_ns(spans) -> int | None:
    """The root `job` span's nanoseconds that none of its children on its
    thread covers; None without such a span."""
    job = next((s for s in spans
                if s["name"] == "job" and s["parent"] is None), None)
    if job is None:
        return None
    lo, hi = job["start_ns"], job["end_ns"]
    covered, end = 0, lo
    for a, b in sorted((s["start_ns"], s["end_ns"]) for s in spans
                       if s["parent"] == job["id"]
                       and s["thread"] == job["thread"]):
        a, b = max(a, end), min(b, hi)
        if b > a:
            covered += b - a
            end = b
    return hi - lo - covered


def read(ctx):
    jobs = [(j["bases"], self_ns(j["stats"].get("spans", ())))
            for j in ctx.get("jobs", ())]
    jobs = [(bases, ns) for bases, ns in jobs if ns is not None]
    if not jobs:
        return None
    return sum(ns for _, ns in jobs) / 1e9 / (
        sum(bases for bases, _ in jobs) / 1e9)
