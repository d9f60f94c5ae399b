"""The per-layer readers on hand-made inputs: the driver's phases, a Chrome
trace (busy time as a union, idle share, kernel time by name, idle gaps)
and the roofline arithmetic; and BENCHMARK.json's metrics against their
reader files."""

import json
import os
import re

import pytest

from e2e_bench import run, trace
from e2e_bench.rooflines import roofline_pct
from e2e_bench.tests.tiny import PKG, REPO, load_json

H100 = "NVIDIA H100 80GB HBM3"


def metric(name):
    return run.load_module("metrics", name, PKG)


def jobs():
    return [dict(bases=500_000_000, seconds=4.0,
                 stats=dict(phases={"feed-wait": 2.0, "construct": 0.25,
                                    "merge": 0.5, "sequences": 1.0,
                                    "gfa": 0.25})),
            dict(bases=500_000_000, seconds=4.0,
                 stats=dict(phases={"feed-wait": 3.0, "construct": 0.75,
                                    "merge": 0.5, "sequences": 0.5,
                                    "gfa": 0.5}))]


@pytest.mark.parametrize("name,want", [
    ("feed.wait_s_per_gbp", 5.0), ("construct.s_per_gbp", 1.0),
    ("merge.s_per_gbp", 1.0), ("writers.s_per_gbp", 2.25)])
def test_phase_metrics(name, want):
    assert metric(name).read(dict(jobs=jobs())) == pytest.approx(want)
    assert metric(name).read(dict(jobs=[])) is None


def write_trace(path):
    ev = [
        dict(ph="X", cat="user_annotation", name="e2e_job", ts=1000.0,
             dur=1000.0),
        dict(ph="X", cat="cpu_op", name="aten::copy_", ts=1550.0,
             dur=400.0),
        dict(ph="X", cat="kernel", ts=1100.0, dur=100.0,
             name="void nthash_select_kernel<14>(unsigned char const*, "
                  "int)"),
        dict(ph="X", cat="kernel", ts=1150.0, dur=150.0,
             name="compact_minimizers_kernel(unsigned char const*)"),
        dict(ph="X", cat="gpu_memcpy", ts=1500.0, dur=100.0,
             name="Memcpy HtoD (Pageable -> Device)"),
        dict(ph="X", cat="kernel", ts=1900.0, dur=200.0,
             name="void nthash_select_kernel<14>(unsigned char const*, "
                  "int)"),
        dict(ph="X", cat="kernel", ts=500.0, dur=50.0, name="before"),
    ]
    with open(path, "w") as f:
        json.dump(dict(traceEvents=ev), f)


def test_read_trace(tmp_path):
    path = str(tmp_path / "t.json")
    write_trace(path)
    p = trace.read_trace(path, "e2e_job")
    # busy: [1100, 1300] + [1500, 1600] + [1900, 2000] (clipped) = 400 us
    assert p["window_s"] == pytest.approx(1000e-6)
    assert p["busy_s"] == pytest.approx(400e-6)
    assert trace.kernel_seconds(p, "nthash_select_kernel") == (
        pytest.approx(300e-6), 2)
    assert trace.kernel_seconds(p, "compact_minimizers_kernel") == (
        pytest.approx(150e-6), 1)
    assert p["device_ops"][0] == ["nthash_select_kernel<14>",
                                  pytest.approx(300e-6)]
    gaps = dict((n, s) for n, s in p["idle_gaps"])
    assert sorted(gaps.values(), reverse=True) == [
        pytest.approx(300e-6), pytest.approx(200e-6),
        pytest.approx(100e-6)]
    assert gaps["aten::copy_ after Memcpy HtoD"] == pytest.approx(300e-6)
    assert metric("device.idle_pct").read(dict(profile=p)) == \
        pytest.approx(60.0)


def test_rooflines(tmp_path):
    path = str(tmp_path / "t.json")
    write_trace(path)
    p = trace.read_trace(path, "e2e_job")
    work = dict(hpc_positions=10**6, minimizers=3000, reads=50)
    hpc_cfg = dict(params=dict(reads_already_hpc=True))
    raw_cfg = dict(params=dict(reads_already_hpc=False))
    ctx = dict(profile=p, work=work, config=hpc_cfg, device_name=H100)
    want = 100 * (10 * 10**6 / 3.35e12) / 300e-6
    assert metric("nthash_select_roofline").read(ctx) == pytest.approx(want)
    nbytes = 10**6 + 20 * 3000 + 5 * 50
    assert metric("compact_minimizers_roofline").read(ctx) == \
        pytest.approx(100 * nbytes / 3.35e12 / 150e-6)
    nbytes = 10**6 + 32 * 3000 + 5 * 50
    assert roofline_pct(dict(ctx, config=raw_cfg), "compact_minimizers") \
        == pytest.approx(100 * nbytes / 3.35e12 / 150e-6)
    # nothing to read: no profile, an unknown card, no such kernel
    assert roofline_pct(dict(ctx, profile=None), "nthash_select") is None
    assert roofline_pct(dict(ctx, device_name="cpu"), "nthash_select") \
        is None
    assert roofline_pct(dict(ctx, profile=dict(p, kernels={})),
                        "nthash_select") is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_matches_its_files():
    bench = load_json(os.path.join(REPO, "BENCHMARK.json"))
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["e2e_bench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        cfg = load_json(os.path.join(REPO, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(PKG, "entries",
                                           f"{cfg['entry']}.py"))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(PKG, "traffic",
                                           f"{w['traffic']}.json"))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert callable(metric(m["name"]).read)
        assert m["moves"] in e2e
