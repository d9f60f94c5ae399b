"""The harness end to end on the CPU at a tiny size: the result line's
keys, cells made of files added beside the benchmark's, the refusals (no
card, the JAX package imported, no program beside the benchmark) and the
modules a run leaves loaded."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from e2e_bench import run
from e2e_bench.tests.tiny import (REPO, dump_json, load_json, make_root,
                                  run_cell)

torch.set_num_threads(2)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("e2e"))


@pytest.mark.parametrize("workload", ["hg002-k21.tiny", "hg002-k21-raw.tiny"])
def test_result_line(root, workload):
    rc, res = run_cell(root, workload)
    assert rc == 0
    # the compared numbers come last, under a key of their own
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"read_gbps", "peak_device_gib",
                                   "peak_host_rss_gib", "setup_s"}
    assert res["metrics"]["read_gbps"]["unit"] == "read-Gbp/s"
    assert res["metrics"]["read_gbps"]["value"] > 0
    assert res["metrics"]["peak_host_rss_gib"]["value"] > 0
    assert res["checks"] == {"gfa_lines_differ": {"value": 0, "limit": 0},
                             "record_ids_differ": {"value": 0, "limit": 0},
                             "records_differ": {"value": 0, "limit": 0}}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}


def test_traced_result_line(root):
    rc, res = run_cell(root, "hg002-k21.tiny", trace=1)
    assert rc == 0 and res["correct"] is True
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    # the phases are read on the CPU too; the device's metrics are not
    assert set(res["metrics"]) == {"feed.wait_s_per_gbp",
                                   "construct.s_per_gbp", "merge.s_per_gbp",
                                   "writers.s_per_gbp"}


def test_cell_from_new_files_only(root, tmp_path):
    """A configuration, a traffic mix, an entry and a per-layer metric,
    each a new file, and new BENCHMARK.json entries: found and run."""
    new = str(tmp_path / "new")
    shutil.copytree(root, new)
    pkg = os.path.join(new, "e2e_bench")
    cfg = load_json(os.path.join(pkg, "configs", "hg002-k21.json"))
    cfg.update(name="hg002-k19", entry="assemble_again",
               params=dict(cfg["params"], k=19))
    dump_json(os.path.join(pkg, "configs", "hg002-k19.json"), cfg)
    dump_json(os.path.join(pkg, "traffic", "twice.json"),
              dict(name="twice", warmup_jobs=2, why="tests"))
    with open(os.path.join(pkg, "entries", "assemble_again.py"), "w") as f:
        f.write("from .pipeline_assemble import counters, outputs, run_job\n")
    with open(os.path.join(pkg, "metrics", "jobs.count.py"), "w") as f:
        f.write('def read(ctx):\n    return len(ctx["jobs"])\n')
    bench = load_json(os.path.join(new, "BENCHMARK.json"))
    bench["configs"].append(dict(name="hg002-k19", source="tests",
                                 file="e2e_bench/configs/hg002-k19.json",
                                 reduced=["genome_mbp"], why="tests"))
    bench["workloads"].append(dict(name="hg002-k19.twice",
                                   config="hg002-k19", traffic="twice",
                                   chips=1, why="tests"))
    bench["per_layer"].append(dict(
        name="jobs.count", unit="jobs", better="higher",
        source="program_counter", layer="harness", moves="read_gbps",
        workloads=["hg002-k19.twice"]))
    dump_json(os.path.join(new, "BENCHMARK.json"), bench)
    rc, res = run_cell(new, "hg002-k19.twice", trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["jobs.count"] == dict(value=1, unit="jobs")
    # the metric is read only in the cells it names
    rc, res = run_cell(new, "hg002-k21.tiny", trace=1)
    assert rc == 0 and "jobs.count" not in res["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_card_run(root, trace):
    """A tiny cell on the card, as `python -m e2e_bench.run` runs one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rc, res = run_cell(root, "hg002-k21-raw.tiny", trace=trace, device=None)
    assert rc == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert res["device"]["busy_s"] > 0
        assert {"device.idle_pct", "nthash_select_roofline",
                "compact_minimizers_roofline"} <= set(res["metrics"])


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "hg002-k21.fasta", "--seed", "1",
                   "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_jax_imported_no_result(root, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res = run_cell(root, "hg002-k21.tiny")
    assert rc == 3 and res is None
    assert "jax" in capsys.readouterr().err


def test_no_program_no_result(root, tmp_path):
    """Only BENCHMARK.json and the benchmark's files: the run fails."""
    lone = str(tmp_path / "lone")
    shutil.copytree(root, lone)
    code = ("import sys\nfrom e2e_bench import run\n"
            "sys.exit(run.main(['--workload', 'hg002-k21.tiny', '--seed', "
            "'1', '--seconds', '0.01'], device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=lone,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=lone))
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "rust_mdbg_tpu_torch" in p.stderr


def test_modules_a_run_loads(root):
    """A run of a cell in a fresh process imports no module whose
    top-level name is jax, jaxlib, flax or rust_mdbg_tpu (the port's name
    begins with the last, so names are compared whole); the reference
    and the check import nothing of the program."""
    code = (
        "import json, sys\nfrom e2e_bench import run\n"
        f"rc = run.main(['--workload', 'hg002-k21-raw.tiny', '--seed', '7', "
        f"'--seconds', '0.01'], device='cpu', root={root!r})\n"
        "print(json.dumps(dict(rc=rc, top=sorted({m.split('.')[0] "
        "for m in sys.modules}))))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0
    assert "rust_mdbg_tpu_torch" in out["top"]
    assert not {"jax", "jaxlib", "flax", "rust_mdbg_tpu"} & set(out["top"])
    code = ("import json, sys\n"
            "from e2e_bench import check, control, generator, lz4frame, "
            "reference\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "rust_mdbg_tpu",
                "rust_mdbg_tpu_torch"} & top
