"""The port's experiment modules (experiments/scale_demo, harness,
quality_n50, scaling, relay_diag) and the profiler hook of utils/timing,
against the JAX package's, on the CPU.  Tolerance: exact equality (FASTA,
GFA and contig bytes, record fields other than wall-clock seconds).

Corpora are generated from a seed, at sizes far below the scripts'
defaults (1 Mbp x 10 for a quality leg, 0.1 Mbp for the scaling corpus)."""

import glob
import json
import os

import pytest
import torch

import rust_mdbg_tpu.cli as jax_cli
import rust_mdbg_tpu.experiments.harness as jax_harness
import rust_mdbg_tpu.experiments.quality_n50 as jax_quality
import rust_mdbg_tpu.experiments.scale_demo as jax_scale_demo
import rust_mdbg_tpu.experiments.scaling as jax_scaling
from rust_mdbg_tpu.parallel.pipeline import \
    assemble_sharded as jax_assemble_sharded
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch.experiments import (harness, quality_n50,
                                             relay_diag, scale_demo, scaling)
from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
from rust_mdbg_tpu_torch.utils.timing import PhaseTimer

torch.set_num_threads(2)

#: the fields of a quality leg that are wall-clock seconds
LEG_TIMES = ("synth_s", "asm_s", "msimpl_s")
#: the fields of run_experiment's record that are seconds or RSS, and the
#: bytes copied to the device (the two packages stage differently)
RESULT_TIMES = ("assemble_s", "simplify_s", "total_s", "max_rss_gb",
                "h2d_bytes")


def _drop(rec: dict, keys) -> dict:
    return {k: v for k, v in rec.items() if k not in keys}


@pytest.mark.parametrize("err", [0.0, 0.003])
@pytest.mark.parametrize("repeats", [0.0, 0.2])
def test_synth_fasta_matches_jax(tmp_path, err, repeats):
    paths = [str(tmp_path / f"{side}.fa") for side in ("jax", "port")]
    for fn, path in zip((jax_scale_demo.synth_fasta, scale_demo.synth_fasta),
                        paths):
        assert fn(path, genome_bp=150_000, coverage=4, seed=7, err=err,
                  repeat_frac=repeats) == (150_000 * 4 // 24576) * 24576
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and a.count(b">") == 150_000 * 4 // 24576


@pytest.mark.parametrize("err", [0.003, 0.0])
def test_quality_leg_matches_jax(tmp_path, err):
    """One quality-n50 leg at 1 Mbp x 10 (the protocol's k, l, d, --bf,
    minabund 2, pre-HPC'd reads): the record less its seconds, and the
    contig bytes, equal JAX run_leg's."""
    legs, contigs = {}, {}
    for side, fn, kw in (("jax", jax_quality.run_leg, {}),
                         ("port", quality_n50.run_leg, dict(device="cpu"))):
        d = tmp_path / side
        d.mkdir()
        legs[side] = fn(str(d), err, 1, 10, 35, 12, 0.002, 2, 11, **kw)
        (fa,) = glob.glob(str(d / "*.msimpl.fa"))
        contigs[side] = open(fa, "rb").read()
        assert not glob.glob(str(d / "reads_*.fa"))
    assert _drop(legs["port"], LEG_TIMES) == _drop(legs["jax"], LEG_TIMES)
    assert set(legs["port"]) == set(legs["jax"])
    assert legs["port"]["nodes"] > 0 and legs["port"]["n_contigs"] > 0
    assert contigs["port"] == contigs["jax"]


def test_quality_cli_writes_a_new_record_name(tmp_path, monkeypatch):
    """Without --out the record goes to quality_n50_torch.json in the
    current directory (never the JAX package's QUALITY_N50.json), with the
    protocol and the device; and without a card and without --device the
    run raises before it writes anything."""
    from rust_mdbg_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    argv = ["quality-n50", "--genome-mbp", "1", "--coverage", "2",
            "--errs", "0", "--workdir", str(tmp_path / "w")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not os.listdir(tmp_path)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["quality_n50_torch.json", "w"]
    rec = json.loads((tmp_path / "quality_n50_torch.json").read_text())
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["protocol"]["k"] == 35 and len(rec["legs"]) == 1


@pytest.fixture(scope="module")
def harness_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("harness")
    path = str(d / "reads.fa")
    write_synthetic_reads(path, genome_mbp=0.1, coverage=20, read_len=5000,
                          error_rate=0.001, seed=2)
    return path


def test_assembly_stats_and_table_match_jax(tmp_path):
    fa = tmp_path / "a.fa"
    fa.write_text(">a\n" + "A" * 100 + "\n>b\n" + "C" * 120 + "\nCC\n>c\n"
                  + "G" * 50 + "\n>d\n\n")
    assert harness.assembly_stats(str(fa)) == \
        jax_harness.assembly_stats(str(fa))
    empty = tmp_path / "e.fa"
    empty.write_text("")
    assert harness.assembly_stats(str(empty)) == \
        jax_harness.assembly_stats(str(empty))
    d = tmp_path / "runs"
    d.mkdir()
    assert harness.make_table(str(d)) == jax_harness.make_table(str(d))
    for i, rec in enumerate([dict(prefix="x", k=21, l=14, d=0.003, n50=7,
                                  total_s=1.5),
                             dict(prefix="y", k=8, l=12, d=0.01,
                                  n_contigs=3, max_rss_gb=0.2)]):
        (d / f"r{i}.result.json").write_text(json.dumps(rec))
    assert harness.make_table(str(d)) == jax_harness.make_table(str(d))
    assert harness.make_table(str(d)).count("\n") == 3


def test_run_experiment_matches_jax(tmp_path, harness_reads, monkeypatch,
                                    capsys):
    """`harness run` with the JAX package's default engine name (auto): the
    .result.json less its seconds equals the JAX harness's; the port's
    record may carry more stats than the JAX one."""
    res = {}
    for side, main, extra in (("jax", jax_harness.main, []),
                              ("port", harness.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        assert main(["run", harness_reads, "asm", "-k", "12", "-l", "12",
                     "-d", "0.01"] + extra) == 0
        res[side] = json.loads((d / "asm.result.json").read_text())
        assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
            res[side]
    want = _drop(res["jax"], RESULT_TIMES)
    assert {k: res["port"][k] for k in want} == want
    assert want["n_contigs"] > 0 and want["nb_nodes"] > 0


def test_run_grid_takes_jax_engine_names(tmp_path, harness_reads,
                                         monkeypatch):
    """run_grid builds its Params from the JAX package's engine names
    (auto, pallas); each cell's record less its seconds equals the JAX
    grid's cell."""
    res = {}
    for side, fn, kw in (
            ("jax", jax_harness.run_grid, dict(engine="auto")),
            ("auto", harness.run_grid, dict(engine="auto", device="cpu")),
            ("pallas", harness.run_grid, dict(engine="pallas",
                                              device="cpu"))):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        res[side] = fn(harness_reads, "g", [12], [12], [0.01], **kw)
    assert [len(r) for r in res.values()] == [1, 1, 1]
    want = _drop(res["jax"][0], RESULT_TIMES)
    for side in ("auto", "pallas"):
        assert {k: res[side][0][k] for k in want} == want


def test_parity_check_small_matches_jax(tmp_path):
    """parity_check on a 0.2 Mbp genome at 52x in chunks of 100 reads: at
    least four chunks, chunked = whole run, and both GFAs equal the JAX
    package's whole-run and chunked GFAs on the same corpus."""
    from rust_mdbg_tpu.core.chunked import \
        assemble_device_chunked as jax_chunked
    from rust_mdbg_tpu.core.pipeline import \
        assemble_device_table as jax_table
    from rust_mdbg_tpu.utils.timing import PhaseTimer as JaxTimer

    rec = scale_demo.parity_check(str(tmp_path), 0.002, 3, device="cpu",
                                  genome_bp=200_000, chunk_reads=100)
    assert rec["parity_chunks"] >= 4 and rec["parity_minabund"] == 3
    p = JaxParams(k=21, l=14, density=0.003, min_kmer_abundance=3,
                  engine="device", reads_already_hpc=True, batch_reads=128)
    reads = str(tmp_path / "parity.fa")
    jax_table(reads, p, str(tmp_path / "jw"), JaxTimer(), {})
    s = jax_chunked(reads, p, str(tmp_path / "jc"), chunk_reads=100)
    assert s["nb_chunks"] == rec["parity_chunks"]
    port_gfa = (tmp_path / "whole.gfa").read_bytes()
    assert port_gfa.count(b"\nS\t") > 0
    for jax_prefix in ("jw", "jc"):
        assert (tmp_path / f"{jax_prefix}.gfa").read_bytes() == port_gfa


def test_scale_demo_main_on_the_cpu(tmp_path, monkeypatch):
    """scale_demo's main at 0.01 Gbp with --device cpu (its CLI run in a
    subprocess): the record lands in scale_demo_torch.json in the current
    directory, its graph equals the JAX CLI's on the same FASTA, and
    without --keep only the files the run made are removed from --dir."""
    monkeypatch.chdir(tmp_path)
    kept, work = tmp_path / "kept", tmp_path / "w"
    work.mkdir()
    (work / "keep.txt").write_text("not the demo's")
    assert scale_demo.main(["--gbp", "0.01", "--device", "cpu",
                            "--skip-parity", "--keep", "--dir",
                            str(kept)]) == 0
    rec = json.loads((tmp_path / "scale_demo_torch.json").read_text())
    assert rec["device"] == "cpu" and rec["card"] is None
    assert "rss_less_relay_gb" not in rec and rec["h2d_gb"] >= 0
    jp = str(tmp_path / "jax")
    assert jax_cli.main([str(kept / "reads.fa"), "-k", "21", "-l", "14",
                         "--density", "0.003", "--minabund", "3",
                         "--skiphpc", "--engine", "device",
                         "--prefix", jp]) == 0
    gfa = (kept / "asm.gfa").read_bytes()
    assert gfa == open(jp + ".gfa", "rb").read()
    assert rec["nodes"] == gfa.count(b"S\t") > 0
    assert scale_demo.main(["--gbp", "0.01", "--device", "cpu",
                            "--skip-parity", "--dir", str(work)]) == 0
    assert os.listdir(work) == ["keep.txt"]


@pytest.fixture(scope="module")
def scaling_reads(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scaling") / "reads.fa")
    scaling.synth(path, genome_bp=100_000)
    return path


def test_scaling_synth_matches_jax(tmp_path, scaling_reads, monkeypatch):
    monkeypatch.setattr(jax_scaling, "GENOME_BP", 100_000)
    jax_scaling.synth(str(tmp_path / "jax.fa"))
    assert (tmp_path / "jax.fa").read_bytes() == \
        open(scaling_reads, "rb").read()


def test_scaling_meshes_match_jax(scaling_reads, tmp_path):
    """run_mesh at 1, 2 and 4 CPU shards: one graph, equal to JAX
    assemble_sharded's on the same corpus over the virtual CPU devices."""
    rows = [scaling.run_mesh(scaling_reads, n, device="cpu")
            for n in (1, 2, 4)]
    assert [r["n"] for r in rows] == [1, 2, 4]
    for n in (1, 4):
        p = JaxParams(k=12, l=12, density=0.003, min_kmer_abundance=2,
                      engine="device", batch_reads=8 * n)
        s = jax_assemble_sharded(scaling_reads, p, str(tmp_path / f"j{n}"),
                                 n_devices=n)
        assert s["n_devices"] == n
        for r in rows:
            assert (r["nodes"], r["edges"]) == (s["nb_nodes"],
                                                s["nb_edges"])
    assert rows[0]["nodes"] > 0 and rows[0]["edges"] > 0
    text = scaling.table(rows, 1_200_000, "cpu", None)
    assert text.count("\n| ") == 4 and "TPU" not in text


def test_scaling_multihost_matches_meshes(scaling_reads):
    """run_multihost: two gloo processes of the port, each assembling
    twice; the graph equals the single-process mesh's, and the processes'
    staged [rows, width] are returned (16 reads a round, 8 a process)."""
    mh = scaling.run_multihost(scaling_reads, device="cpu", timeout=300)
    one = scaling.run_mesh(scaling_reads, 1, device="cpu")
    assert (mh["nodes"], mh["edges"]) == (one["nodes"], one["edges"])
    assert mh["wall_s"] is not None and mh["wall_cold_s"] is not None
    assert mh["staged_shapes"] and all(
        B == 8 and L > 0 for B, L in mh["staged_shapes"])


def test_phase_timer_profile_dir_writes_a_trace(tmp_path):
    """PhaseTimer.phase(name, profile_dir) traces the block with
    torch.profiler into profile_dir (a Chrome trace naming the block's
    ops); without profile_dir nothing is written.  Both time the phase."""
    t = PhaseTimer()
    x = torch.arange(1 << 12, dtype=torch.int64)
    with t.phase("plain"):
        torch.cumsum(x, 0)
    prof = tmp_path / "prof"
    with t.phase("traced", profile_dir=str(prof)):
        torch.cumsum(x, 0)
    assert [name for name, _ in t.phases] == ["plain", "traced"]
    (trace,) = prof.iterdir()
    assert trace.name.startswith("traced.")
    assert trace.name.endswith(".pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert sorted(os.listdir(tmp_path)) == ["prof"]


def test_relay_diag_loops_on_the_cpu(monkeypatch, capsys):
    rec = relay_diag.run("cpu", mb=2, iters=3)
    assert rec["device"] == "cpu" and "h2d_pinned" not in rec
    assert len(rec["h2d_pageable"]) == len(rec["d2h"]) == 3
    assert "H2D 2 MB x3, pageable" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        relay_diag.run(mb=2, iters=1)
