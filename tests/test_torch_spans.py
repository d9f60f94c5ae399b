"""The port's span record (utils/timing.PhaseTimer): what a span keeps, the
`job` root and its counters, closes from many threads, the profiler hook
on every thread, and the spans of a chunked `assemble` on the CPU (the
feed threads' spans a chunk, their chunk ids, the main thread's tree and
their twins in a torch.profiler trace)."""

import json
import mmap
import os
import sys
import threading
import time

import pytest
import torch

from rust_mdbg_tpu_torch.core.fastx_feed import STAGER_THREAD
from rust_mdbg_tpu_torch.core.pipeline import assemble
from rust_mdbg_tpu_torch.io.fastx_native import PUMP_THREAD
from rust_mdbg_tpu_torch.params import Params
from rust_mdbg_tpu_torch.parallel.pipeline import assemble_sharded
from rust_mdbg_tpu_torch.utils.timing import (JOB, PhaseTimer, trace_us,
                                              vm_rss_bytes)

from torch_corpus import write_raw_reads

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

KW = dict(k=7, l=12, density=0.01, min_kmer_abundance=2)
#: 400 reads in chunks of 64: seven chunks, the last short
CHUNK_READS = 64
FEED = ("feed.parse", "feed.pack", "feed.copy")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return write_raw_reads(str(tmp_path_factory.mktemp("spans") / "r.fa"))


@pytest.fixture(scope="module")
def chunked(reads, tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("chunked") / "out")
    return assemble(reads, Params(**KW, chunk_reads=CHUNK_READS), prefix,
                    device="cpu")


def by_id(spans):
    return {s["id"]: s for s in spans}


def named(spans, name):
    return [s for s in spans if s["name"] == name]


# --- the record --------------------------------------------------------------

def test_span_keeps_thread_parent_chunk_and_times():
    t = PhaseTimer()
    with t.phase("outer") as outer:
        with t.phase("inner", chunk=3) as inner:
            time.sleep(0.002)
        inner_seen = dict(inner)

    def side():
        with t.phase("side"):
            pass

    th = threading.Thread(target=side, name="other")
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    (o,) = named(t.spans, "outer")
    (i,) = named(t.spans, "inner")
    assert inner_seen == i and outer is o
    assert i["parent"] == o["id"] and o["parent"] is None
    assert i["chunk"] == 3 and o["chunk"] is None
    assert i["thread"] == o["thread"] == threading.current_thread().name
    assert o["start_ns"] <= i["start_ns"] < i["end_ns"] <= o["end_ns"]
    assert i["end_ns"] - i["start_ns"] >= 2_000_000
    assert 0 <= i["cpu_s"] < 0.002
    # another thread's first span: no job is open, so no parent
    (sd,) = named(t.spans, "side")
    assert sd["thread"] == "other" and sd["parent"] is None
    assert sd["start_ns"] > o["end_ns"]


def test_a_block_may_set_its_chunk_and_a_raising_block_is_kept():
    t = PhaseTimer()
    with t.phase("wait") as sp:
        sp["chunk"] = 7
    with pytest.raises(ValueError):
        with t.phase("fails"):
            raise ValueError
    with t.phase("after"):
        pass
    assert [s["chunk"] for s in t.spans] == [7, None, None]
    # the failed span left its thread's stack: the next has no parent
    assert named(t.spans, "after")[0]["parent"] is None


def test_report_sums_by_name_and_phases_are_pairs():
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("chunk"):
            time.sleep(0.001)
    with t.phase("gfa"):
        pass
    assert [n for n, _ in t.phases] == ["chunk", "chunk", "chunk", "gfa"]
    rep = t.report()
    assert set(rep) == {"chunk", "gfa"}
    assert rep["chunk"] == round(sum(d for n, d in t.phases
                                     if n == "chunk"), 4)
    assert rep["chunk"] >= 0.003


def test_job_is_every_threads_root_and_reads_rss():
    t = PhaseTimer()
    got = []

    def feed():
        with t.phase("feed.parse", 0):
            # a fresh mapping, written through, so the job's resident
            # memory rises whatever free pages the heap holds
            m = mmap.mmap(-1, 8 << 20)
            for off in range(0, len(m), mmap.PAGESIZE):
                m[off] = 1
            got.append(m)

    with t.job() as job:
        with t.phase("plan"):
            pass
        th = threading.Thread(target=feed, name="pump")
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    with t.phase("outside"):
        pass
    sp = by_id(t.spans)
    (parse,) = named(t.spans, "feed.parse")
    assert job["name"] == JOB and job["parent"] is None
    assert named(t.spans, "plan")[0]["parent"] == job["id"]
    assert parse["parent"] == job["id"] and parse["thread"] == "pump"
    assert named(t.spans, "outside")[0]["parent"] is None
    assert sp[job["id"]]["end_ns"] >= parse["end_ns"]
    c = t.counters
    assert 0 < c["rss_start_bytes"] <= c["rss_high_bytes"]
    assert c["rss_high_bytes"] >= c["rss_start_bytes"] + (4 << 20)
    assert vm_rss_bytes() > 0
    st = t.stats()
    assert set(st) == {"phases", "spans", "counters", "span_clock"}
    assert st["counters"] == c and st["span_clock"] == list(t.clock)
    assert st["phases"] == t.report() and st["spans"] == t.spans
    assert st["spans"][0] is not t.spans[0]


def test_closes_and_counts_from_many_threads():
    """Sixteen threads on eight cores, each closing nested spans and
    counting, with a short switch interval: no span or count is lost,
    ids are unique and each inner span's parent is its own thread's."""
    t = PhaseTimer()
    n_threads, n_spans = 16, 200

    def work(k):
        for i in range(n_spans):
            with t.phase("outer", chunk=i):
                with t.phase("inner", chunk=i):
                    t.count("n", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with t.job():
            ths = [threading.Thread(target=work, args=(k,), name=f"w{k}")
                   for k in range(n_threads)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    spans = t.spans
    assert len(spans) == 2 * n_threads * n_spans + 1
    assert len({s["id"] for s in spans}) == len(spans)
    assert t.counters["n"] == n_threads * n_spans
    sp = by_id(spans)
    job = named(spans, JOB)[0]
    for s in named(spans, "inner"):
        p = sp[s["parent"]]
        assert p["name"] == "outer" and p["thread"] == s["thread"]
        assert p["chunk"] == s["chunk"] and p["parent"] == job["id"]


def test_profile_dir_records_every_thread(tmp_path):
    """PhaseTimer.phase(name, profile_dir): the trace holds a span opened
    on another thread inside the block, as a user_annotation."""
    t = PhaseTimer()

    def side():
        with t.phase("side-span"):
            torch.arange(1 << 10).cumsum(0)

    with t.phase("traced", profile_dir=str(tmp_path)):
        th = threading.Thread(target=side, name="side")
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    (trace,) = tmp_path.iterdir()
    ev = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in ev if e.get("cat") == "user_annotation"}
    assert {"traced", "side-span"} <= names


# --- the chunked driver's spans ----------------------------------------------

def test_chunked_feed_spans_a_chunk(chunked):
    """One feed.parse, feed.pack and feed.copy a chunk, on the pump and the
    stager, with the chunk's id: the id of its construct span."""
    spans = chunked["spans"]
    n = chunked["nb_chunks"]
    assert n == 7
    ids = sorted(s["chunk"] for s in named(spans, "construct"))
    assert ids == list(range(n))
    for name in FEED:
        got = [s["chunk"] for s in named(spans, name)
               if s["chunk"] is not None]
        assert sorted(got) == ids, name
    # the pump's EOF parse and the stager's last wait belong to no chunk
    assert [s["chunk"] for s in named(spans, "feed.parse")].count(None) == 1
    assert all(s["thread"] == PUMP_THREAD
               for s in named(spans, "feed.parse")
               + named(spans, "feed.token-wait"))
    assert all(s["thread"] == STAGER_THREAD
               for n_ in ("feed.pack", "feed.copy", "feed.next-wait",
                          "feed.put-wait") for s in named(spans, n_))
    for name in ("merge", "reset", "feed-wait"):
        assert sorted(s["chunk"] for s in named(spans, name)
                      if s["chunk"] is not None) == ids, name
    assert len(named(spans, "sequences")) == n


def test_chunked_job_encloses_the_main_thread(chunked):
    spans = chunked["spans"]
    sp = by_id(spans)
    (job,) = named(spans, JOB)
    main = [s for s in spans if s["thread"] == job["thread"]]
    assert all(job["start_ns"] <= s["start_ns"] <= s["end_ns"]
               <= job["end_ns"] for s in main)
    kids = [s for s in main if s["parent"] == job["id"]]
    assert [s["name"] for s in sorted(kids, key=lambda s: s["start_ns"])] \
        == ["plan", "compile", "setup", "stream", "gfa"]
    # the direct children do not overlap: the job is their sum and its
    # self time, by construction
    ends = sorted((s["start_ns"], s["end_ns"]) for s in kids)
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    for s in spans:
        if s["name"] in ("construct", "merge", "feed-wait", "sequences"):
            assert sp[s["parent"]]["name"] == "stream"
        if s["thread"] != job["thread"]:
            assert s["parent"] == job["id"]
    # every span's chain of parents ends at the job
    for s in spans:
        while s["parent"] is not None:
            s = sp[s["parent"]]
        assert s is job


def test_chunked_stats_carry_phases_and_counters(chunked):
    ph = chunked["phases"]
    assert {"job", "plan", "setup", "compile", "stream", "feed-wait",
            "construct", "merge", "gather", "meta", "sequences", "reset",
            "gfa"} | set(FEED) <= set(ph)
    assert ph["construct"] == round(sum(
        (s["end_ns"] - s["start_ns"]) / 1e9
        for s in named(chunked["spans"], "construct")), 4)
    c = chunked["counters"]
    # the plain versions on the CPU launch no kernel
    assert c["nthash_positions"] == 0
    assert 0 < c["rss_start_bytes"] <= c["rss_high_bytes"]
    assert "phase_stats" not in chunked
    json.dumps(chunked["spans"])


def test_main_thread_spans_have_profiler_twins(reads, tmp_path):
    """Under torch.profiler every main-thread span of a chunked run is a
    user_annotation of the trace, its start put on the trace's clock by
    the stats' span_clock and the trace's baseTimeNanoseconds within 1 ms
    of the twin's ts; the feed threads' spans are there too (the hook
    records every thread).  A short switch interval keeps a feed thread
    from holding the interpreter lock between a range's start and its
    span's clock read, which is scheduling, not the clocks' mapping."""
    out = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        with PhaseTimer().phase("run", profile_dir=str(tmp_path / "prof")):
            out.update(assemble(reads, Params(**KW, chunk_reads=CHUNK_READS),
                                str(tmp_path / "out"), device="cpu"))
    finally:
        sys.setswitchinterval(old)
    (path,) = (tmp_path / "prof").iterdir()
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    twins: dict = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            twins.setdefault(e["name"], []).append(float(e["ts"]))
    clock = tuple(out["span_clock"])
    job = named(out["spans"], JOB)[0]
    main = [s for s in out["spans"] if s["thread"] == job["thread"]]
    assert len(main) > 40
    for s in main:
        at = trace_us(clock, s["start_ns"], base)
        assert min(abs(ts - at) for ts in twins[s["name"]]) < 1000, s
    for name in FEED:
        assert len(twins[name]) >= out["nb_chunks"]


@pytest.mark.parametrize("route,kw,last", [
    ("whole-run", dict(min_kmer_abundance=17), "sequences+gfa"),
    ("streaming", dict(engine="host"), "gfa")])
def test_every_route_is_one_job(reads, tmp_path, route, kw, last):
    """The whole-run and streaming routes: one root `job`, every span under
    it, and the job's counters."""
    st = assemble(reads, Params(**{**KW, **kw}), str(tmp_path / route),
                  device="cpu")
    sp = by_id(st["spans"])
    (job,) = named(st["spans"], JOB)
    assert st["phases"]["job"] >= st["phases"][last] > 0
    for s in st["spans"]:
        while s["parent"] is not None:
            s = sp[s["parent"]]
        assert s is job
    assert {"rss_start_bytes", "rss_high_bytes",
            "nthash_positions"} <= set(st["counters"])


def test_sharded_driver_is_one_job(reads, tmp_path):
    st = assemble_sharded(reads, Params(**KW), str(tmp_path / "sh"),
                          n_devices=2, device="cpu")
    (job,) = named(st["spans"], JOB)
    kids = {s["name"] for s in st["spans"] if s["parent"] == job["id"]}
    assert {"compile", "feed", "steps", "finalize", "sequences",
            "gfa"} <= kids
    assert st["counters"]["rss_high_bytes"] >= \
        st["counters"]["rss_start_bytes"] > 0
