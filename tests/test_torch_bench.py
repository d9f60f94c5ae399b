"""Port parity for the benchmark entry (rust_mdbg_tpu_torch/bench.py): its
corpus against the root bench.py's draws, its phased run against the JAX
package's `core/pipeline.assemble` on the same errored reads (.gfa bytes,
.sequences records; with and without --bf), its JSON line against
bench.py's keys, the trace breakdown of --profile, and the device rule."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as root_bench
from rust_mdbg_tpu.core.pipeline import assemble as jax_assemble
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch import bench
from rust_mdbg_tpu_torch.utils.seq import CODE_BASE

from torch_corpus import gfa_bytes, records

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: 0.2 Mbp at 10x of bench.py's 24,576 bp reads: 80 reads, ten batches of 8
SMALL = dict(genome_mbp=0.2, coverage=10, read_len=24576, batch_reads=8)


def _bench(tmp_path, **kw):
    return bench.Bench("cpu", workdir=str(tmp_path / "bench"),
                       **{**SMALL, **kw})


def test_synth_reads_matches_root_bench():
    g1, s1, L1 = root_bench.synth_reads(genome_mbp=1, coverage=6,
                                        read_len=4096)
    g2, s2, L2 = bench.synth_reads(genome_mbp=1, coverage=6, read_len=4096)
    assert L1 == L2 == 4096
    assert g1.dtype == g2.dtype and g1.tobytes() == g2.tobytes()
    assert np.array_equal(s1, s2) and len(s2) == 1464


def test_staged_reads_carry_the_error_model(tmp_path):
    """The staged codes equal the host twin (checked at staging), and the
    twin is the genome's windows with E = round(0.003 * L) substitutions
    a read, one in each L/E segment."""
    b = _bench(tmp_path)
    genome, starts, L = bench.synth_reads(0.2, 10, 24576)
    clean = np.stack([genome[s : s + L] for s in starts[: b.n_reads]])
    diff = clean != b.reads_codes
    E = round(0.003 * L)
    assert (diff.sum(axis=1) == E).all()
    seg = L // E
    assert (np.nonzero(diff[0])[0] // seg == np.arange(E)).all()
    assert np.array_equal(b.all_codes.numpy(), b.reads_codes)
    assert np.array_equal(CODE_BASE[b.reads_codes], b.reads_ascii)


@pytest.mark.parametrize("use_bf,phases,engine", [
    (False, "0.12", "host"),
    (False, "0.12", "device"),
    (False, "0.3,0.6", "host"),
    (True, "0.12", "host")])
def test_run_once_matches_jax(tmp_path, monkeypatch, use_bf, phases,
                              engine):
    """The bench's phased whole-run construction writes the .gfa bytes and
    .sequences records of the JAX package's assemble over the same reads
    as FASTA, pre-HPC'd, minabund 2 (with --bf: a 2^32-bit filter on both
    sides)."""
    monkeypatch.setenv("MDBG_BENCH_PHASES", phases)
    b = _bench(tmp_path, use_bf=use_bf)
    assert len(b.bounds) == len(phases.split(",")) + 1
    rep = b.run_once()
    pj = str(tmp_path / "jax")
    sj = jax_assemble(b.write_fasta(), JaxParams(
        k=21, l=14, density=0.003, min_kmer_abundance=2,
        reads_already_hpc=True, use_bf=use_bf, bloom_log2_bits=32,
        engine=engine, batch_reads=8), pj)
    assert gfa_bytes(b.prefix) == gfa_bytes(pj)
    assert records(b.prefix) == records(pj)
    assert rep["g"]["nb_nodes"] == sj["nb_nodes"] > 300
    assert rep["g"]["nb_edges"] == sj["nb_edges"] > 300
    assert rep["n_over"] == 0 and rep["edge_join"] == "device"
    assert rep["windows"] > rep["g"]["nb_nodes"]
    assert rep["emit1"] > 0 and set(rep["stages"]) >= {
        "loop", "phase-1 finalize", "phase-1 emit", "final finalize",
        "tail emit", "counts", "finish+join"}
    # a second rep (a fresh Bloom filter under --bf) writes the same bytes
    first = gfa_bytes(b.prefix)
    assert b.run_once()["uniques"] == rep["uniques"]
    assert gfa_bytes(b.prefix) == first


def test_protocol_line_has_bench_py_keys(tmp_path):
    """run_protocol's line has bench.py's 22 keys in its order, plus the
    card and peak-memory keys; the chunked leg's graph is the bench's."""
    src = open(os.path.join(REPO, "bench.py")).read()
    block = src[src.index("print(json.dumps({"):]
    block = block[: block.index("}))")]
    root_keys = tuple(re.findall(r'^\s*"(\w+)":', block, re.M))
    assert len(root_keys) == 22
    res = bench.run_protocol(_bench(tmp_path), repeats=1, pipelined=True)
    line = res["line"]
    assert tuple(line) == root_keys + ("device", "peak_device_bytes")
    assert line["metric"] == "mdbg_construction_throughput"
    assert line["total_gbp"] == round(80 * 24576 / 1e9, 3)
    assert line["device"] is None and line["peak_device_bytes"] is None
    for k in ("value", "wall_s", "loop_s", "device_loop_s", "feed_s",
              "feed_pipelined_gbps", "h2d_gbps"):
        assert line[k] > 0
    assert res["pipe_stats"]["nb_nodes"] == line["nodes"]
    assert res["pipe_stats"]["nb_edges"] == line["edges"]
    json.dumps(line)


def test_overflowing_slots_raise(tmp_path, monkeypatch):
    """Reads over their (scaled) window slots fail the rep: nothing is
    truncated and nothing falls back."""
    monkeypatch.setenv("MDBG_BF_SLOT_FRAC", "0.01")
    b = _bench(tmp_path, use_bf=True)
    assert b.W_slot == 8
    with pytest.raises(RuntimeError, match="overflowed"):
        b.run_once()


def test_trace_breakdown_reads_busy_share_and_gaps(tmp_path):
    """A hand-made trace: the timer's clock pair and the trace's
    baseTimeNanoseconds put perf_counter 10.0 s at 5,000 us on the trace's
    clock; kernels and a copy occupy 300 of the 1,000 us window (a kernel
    past it is not counted); the longest gap lies in the second stage."""
    clock = (1_700_000_000_000_000_000, 10_000_000_000)
    ev = [dict(ph="X", cat="user_annotation", name="rep", ts=5000.0,
               dur=1000.0),
          dict(ph="X", cat="gpu_user_annotation", name="rep", ts=0.0,
               dur=1.0),
          dict(ph="X", cat="kernel", name="k1", ts=5000.0, dur=100.0),
          dict(ph="X", cat="kernel", name="k1", ts=5050.0, dur=100.0),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy", ts=5200.0, dur=50.0),
          dict(ph="X", cat="kernel", name="k2", ts=5900.0, dur=100.0),
          dict(ph="X", cat="kernel", name="k3", ts=6500.0, dur=10.0),
          dict(ph="X", cat="cpu_op", name="aten::sort", ts=5100.0, dur=9.0)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(dict(traceEvents=ev,
                                    baseTimeNanoseconds=clock[0] - 5_000_000)))
    spans = [dict(name=name, start_ns=clock[1] + a, end_ns=clock[1] + b)
             for name, a, b in [("loop", 0, 400_000),
                                ("phase-1 emit", 100_000, 240_000),
                                ("tail", 400_000, 1_000_000)]]
    out = bench.trace_breakdown(str(path), spans, clock)
    assert out["window_us"] == pytest.approx(1000.0)
    assert out["busy_us"] == pytest.approx(300.0)
    assert out["busy_share"] == pytest.approx(0.3)
    assert [k["name"] for k in out["kernels"]] == ["k1", "k2"]
    assert out["kernels"][0]["launches"] == 2
    assert out["kernels"][0]["us"] == pytest.approx(200.0)
    assert out["kernel_launches"] == 3 and out["device_events"] == 4
    gaps = out["idle_gaps"]
    assert [round(g["us"]) for g in gaps] == [650, 50]
    assert gaps[0]["stages"] == ["loop", "tail"]
    assert gaps[1]["stages"] == ["loop", "phase-1 emit"]
    assert gaps[1]["at_s"] == pytest.approx(150e-6)


def test_profile_rep_on_the_cpu(tmp_path):
    """--profile's rep: the Chrome trace is written and read back against
    the rep's stages (no device events on the CPU)."""
    b = _bench(tmp_path)
    b.run_once()
    prof = b.profile_rep(str(tmp_path / "prof"))
    assert os.path.dirname(prof["trace"]) == str(tmp_path / "prof")
    assert prof["window_us"] == pytest.approx(prof["wall_s"] * 1e6,
                                              rel=0.01)
    assert prof["busy_us"] == 0 and prof["kernels"] == []
    (gap,) = prof["idle_gaps"]
    assert gap["us"] == pytest.approx(prof["window_us"])
    assert "loop" in gap["stages"] and "finish+join" in gap["stages"]
    assert "finish+join" in prof["stages_s"]


def test_import_loads_no_jax():
    code = ("import sys, rust_mdbg_tpu_torch.bench\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'rust_mdbg_tpu.')) "
            "or m in ('rust_mdbg_tpu', 'bench')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("fn", [lambda: bench.Bench(),
                                lambda: bench.main([])])
def test_no_gpu_without_device_raises(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
