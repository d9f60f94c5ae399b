"""Port parity: error correction through its other entry points.

`--restart-from-postcor` (models/correct.assemble_from_postcor), the CLI
(`--error-correct --ec-device-poa`, then `--restart-from-postcor`) and
the `ec-scale` subcommand against the JAX package's, byte for byte or
field for field; and a failing scorer or POA DP raises out of the run
instead of being swallowed.  Corpora as in tests/test_torch_ec_runs.py.
"""

import json
import os
import shutil

import pytest
import torch

from rust_mdbg_tpu import cli as jax_cli
from rust_mdbg_tpu.experiments import ec_scale as jax_ec_scale
from rust_mdbg_tpu.models.correct import \
    assemble_from_postcor as jax_from_postcor
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch import cli
from rust_mdbg_tpu_torch.core.pipeline import assemble
from rust_mdbg_tpu_torch.experiments import ec_scale
from rust_mdbg_tpu_torch.models.correct import assemble_from_postcor
from rust_mdbg_tpu_torch.ops import kernels
from rust_mdbg_tpu_torch.params import Params

from torch_corpus import ec_outputs, ec_params, write_noisy_reads

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """20x over 4 kb at 0.15 % errors (test_torch_ec_runs' deep corpus)."""
    d = tmp_path_factory.mktemp("ec_cli")
    return write_noisy_reads(d / "deep.fa", 9, 40, 4000, 2000, 3)


def test_restart_from_postcor_matches_jax(tmp_path, deep):
    """--restart-from-postcor rebuilds the graph from a .postcor.ec_data
    alone, as the JAX package does, and reproduces the EC run's graph."""
    reads = deep
    run = str(tmp_path / "run")
    assemble(reads, ec_params(Params, {}, True, "device"), run, device="cpu")
    p = ec_params(Params, {}, True, "device")
    for side, fn in (("port", assemble_from_postcor),
                     ("jax", jax_from_postcor)):
        prefix = str(tmp_path / side)
        shutil.copy(run + ".postcor.ec_data", prefix + ".postcor.ec_data")
        st = fn(p if side == "port" else ec_params(JaxParams, {}, True,
                                                 "host"), prefix)
        assert st["nb_nodes"] > 0
    port, jax = ec_outputs(str(tmp_path / "port")), \
        ec_outputs(str(tmp_path / "jax"))
    assert port == jax
    assert port[".gfa"] == open(run + ".gfa", "rb").read()


def test_cli_error_correct_and_restart_match_jax(tmp_path, deep,
                                                 capsys):
    """The CLI: --error-correct --ec-device-poa, then
    --restart-from-postcor, equal bytes to the JAX CLI's."""
    reads = deep
    flags = ["-k", "4", "-l", "8", "-d", "0.05", "-n", "2",
             "--error-correct", "--ec-device-poa", "--ec-chunk", "8"]
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.main([reads] + flags + ["--engine", "host",
                                           "--prefix", pj]) == 0
    assert cli.main([reads] + flags + ["--device", "cpu",
                                       "--prefix", pt]) == 0
    out = capsys.readouterr().out
    assert "Number of mdBG nodes" in out and "error-correct" in out
    assert ec_outputs(pt) == ec_outputs(pj)
    for prefix in (pj, pt):
        os.remove(prefix + ".gfa")
    assert jax_cli.main([reads] + flags + ["--engine", "host",
                                           "--restart-from-postcor",
                                           "--prefix", pj]) == 0
    assert cli.main([reads] + flags + ["--restart-from-postcor",
                                       "--prefix", pt]) == 0
    assert ec_outputs(pt) == ec_outputs(pj)
    assert os.path.getsize(pt + ".gfa") > 0


def test_ec_scale_matches_jax(tmp_path, monkeypatch):
    """ec-scale on a tiny genome: the JAX package's report fields, with
    equal accuracy and graph numbers (timings aside)."""
    monkeypatch.setenv("HOME", str(tmp_path))  # the JAX compile cache
    kw = dict(genome_mbp=0.01, coverage=12, read_len=2000,
              error_rate=0.003, device_poa=False)
    want = jax_ec_scale.run_ec_scale(**kw, workdir=str(tmp_path / "jax"),
                                     platform="cpu")
    got = ec_scale.run_ec_scale(**kw, workdir=str(tmp_path / "port"),
                                device="cpu")
    assert set(got) == set(want)
    timed = {"synth_s", "wall_s", "ec_s", "phases", "max_rss_gb"}
    assert {k: got[k] for k in set(got) - timed} == \
        {k: want[k] for k in set(want) - timed}
    assert got["ec_sampled_reads"] > 0 and got["nb_nodes"] > 0
    assert {"error-correct", "reingest"} <= set(got["phases"])


def test_ec_scale_cli_device_poa(tmp_path, capsys):
    """The ec-scale subcommand through the CLI, lockstep driver, --device
    cpu: one JSON report line, also written to --out."""
    out = str(tmp_path / "ec.json")
    assert cli.main(["ec-scale", "--genome-mbp", "0.01", "--coverage", "8",
                     "--read-len", "2000", "--error-rate", "0.003",
                     "--device-poa", "--ec-chunk", "16", "--workdir",
                     str(tmp_path / "w"), "--out", out,
                     "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep == json.loads(open(out).read())
    assert rep["device_poa"] is True and rep["ec_sampled_reads"] > 0


@pytest.mark.parametrize("driver", ["sequential", "lockstep"])
def test_device_stage_failure_raises(tmp_path, deep, monkeypatch, driver):
    """A failing scorer (sequential driver) or POA DP (lockstep) raises out
    of the run: no fall-back turns it into a silently different run."""
    def boom(*a, **k):
        raise RuntimeError("device stage failed")

    if driver == "sequential":
        monkeypatch.setattr(kernels, "semiglobal_scores_plain", boom)
        fields = {}
    else:
        monkeypatch.setattr(kernels, "poa_dp_plain", boom)
        fields = dict(ec_device_poa=True, ec_chunk=8)
    with pytest.raises(RuntimeError, match="device stage failed"):
        assemble(deep, ec_params(Params, fields, True, "device"),
                 str(tmp_path / "x"), device="cpu")
