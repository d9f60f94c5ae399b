"""Each module here reads one per-layer metric, named as the file is, from
a traced run: `read(ctx)` returns the value or None where the run gives
it nothing to read.  Its unit, layer and the end-to-end metric it should
move are BENCHMARK.json's.

ctx holds `jobs` (each window job's read bases, seconds and the program's
stats, whose `phases` are the driver's PhaseTimer sums), `profile` (the
profiled job's trace: trace.read_trace), `work` (the reference's counts
of the corpus: reads, bases, hpc_positions, minimizers, ...), `config`
and `device_name`."""

from __future__ import annotations


def phase_s_per_gbp(ctx: dict, names: tuple) -> float | None:
    """Seconds of the named driver phases, summed over the window's jobs,
    a read-Gbp of those jobs; None where no job reported them."""
    jobs = [j for j in ctx.get("jobs", ()) if "phases" in j["stats"]]
    if not jobs or not any(n in j["stats"]["phases"]
                           for j in jobs for n in names):
        return None
    s = sum(j["stats"]["phases"].get(n, 0.0) for j in jobs for n in names)
    return s / (sum(j["bases"] for j in jobs) / 1e9)
