"""The readers of the program's spans and counters on hand-made window
jobs: the feed's parse, pack and copy, the driver's self time, the launched
positions a read position and a job's rise in resident memory; each None
where the jobs report nothing (a program without the span record)."""

import pytest

from e2e_bench import run
from e2e_bench.tests.tiny import PKG

GIB = 1 << 30
NAMES = ("feed.parse_s_per_gbp", "feed.pack_s_per_gbp",
         "feed.copy_s_per_gbp", "driver.self_s_per_gbp",
         "construct.launched_per_position", "driver.job_rss_rise_gib")


def metric(name):
    return run.load_module("metrics", name, PKG)


def span(i, name, start, end, parent, thread="MainThread", chunk=None):
    return dict(id=i, name=name, thread=thread, start_ns=start, end_ns=end,
                parent=parent, chunk=chunk, cpu_s=0.0)


def job_stats(scale: int, rise: int, positions: int) -> dict:
    """A job of 10 s (x scale): plan 1, setup 1, stream 6 (with its
    feed-wait and construct nested), gfa 1 on the main thread; the feed
    threads' spans run beside them; 1 s of self time."""
    s = 10**9 * scale
    spans = [
        span(1, "plan", 0, s, 0),
        span(2, "setup", s, 2 * s, 0),
        span(4, "feed-wait", 2 * s, 5 * s, 3, chunk=0),
        span(5, "construct", 5 * s, 6 * s, 3, chunk=0),
        span(3, "stream", 2 * s, 8 * s, 0),
        span(6, "feed.parse", 2 * s, 4 * s, 0, "fastx-prefetch", 0),
        span(7, "feed.pack", 4 * s, 4 * s + s // 2, 0, "feed-stager", 0),
        span(8, "feed.copy", 4 * s + s // 2, 5 * s, 0, "feed-stager", 0),
        span(9, "gfa", 9 * s, 10 * s, 0),
        span(0, "job", 0, 10 * s, None),
    ]
    phases = {}
    for sp in spans:
        phases[sp["name"]] = phases.get(sp["name"], 0.0) + (
            sp["end_ns"] - sp["start_ns"]) / 1e9
    return dict(phases=phases, spans=spans, counters=dict(
        rss_start_bytes=8 * GIB, rss_high_bytes=8 * GIB + rise,
        nthash_positions=positions))


def jobs():
    return [dict(bases=500_000_000, seconds=10.0,
                 stats=job_stats(1, GIB, 3_000_000)),
            dict(bases=500_000_000, seconds=20.0,
                 stats=job_stats(2, 2 * GIB, 5_000_000))]


@pytest.mark.parametrize("name,want", [
    ("feed.parse_s_per_gbp", 6.0), ("feed.pack_s_per_gbp", 1.5),
    ("feed.copy_s_per_gbp", 1.5),
    # the main thread's children cover 9 of each job's 10 s (x scale);
    # the feed threads' spans and the nested ones are not subtracted
    ("driver.self_s_per_gbp", 3.0),
    ("construct.launched_per_position", 2.0),
    ("driver.job_rss_rise_gib", 1.5)])
def test_program_span_metrics(name, want):
    ctx = dict(jobs=jobs(), work=dict(hpc_positions=2_000_000))
    assert metric(name).read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    """No jobs, or jobs whose stats hold only the phases a program without
    the span record gives: no value, and no error."""
    work = dict(hpc_positions=2_000_000)
    old = [dict(bases=500_000_000, seconds=10.0,
                stats=dict(phases={"feed-wait": 2.0, "construct": 1.0}))]
    assert metric(name).read(dict(jobs=[], work=work)) is None
    assert metric(name).read(dict(jobs=old, work=work)) is None


def test_launched_positions_need_a_launch_and_the_reads():
    """A job that launched no kernel (the plain versions on the CPU), or a
    run without the reference's counts, gives no ratio."""
    cpu = [dict(j, stats=dict(j["stats"], counters=dict(
        j["stats"]["counters"], nthash_positions=0))) for j in jobs()]
    m = metric("construct.launched_per_position")
    assert m.read(dict(jobs=cpu, work=dict(hpc_positions=10))) is None
    assert m.read(dict(jobs=jobs(), work={})) is None
