"""Port parity for the sharded pipeline: `assemble_sharded` against the JAX
package's on its 8 virtual CPU devices, in .gfa bytes and .sequences
records, on tests/test_sharded_stress.py's corpora: errored reads on both
strands with presimp off (0), at its default and at 0.6 (where removals
fire), raw and pre-HPC'd, uneven reads with a short last batch, rounds
staged at the half and at the full width, the
gathered join (MDBG_SHARDED_EDGES=0), the CLI, and the two runs the JAX
package also refuses (a read over its minimizer capacity, a read over the
staging width).  The JAX outputs are made once per module."""

import numpy as np
import pytest
import torch

from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu.parallel.pipeline import assemble_sharded as jax_sharded
from rust_mdbg_tpu_torch.cli import main as cli_main
from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
from rust_mdbg_tpu_torch.parallel.pipeline import assemble_sharded
from rust_mdbg_tpu_torch.params import Params
from test_sharded_stress import _node_map, _synth, _synth_err
from torch_corpus import gfa_bytes, records, write_hpc_reads

torch.set_num_threads(2)

KW = dict(k=5, l=8, density=0.05, min_kmer_abundance=2, batch_reads=8)

#: (name, n, presimp, pre-HPC'd reads)
CASES = [("err4", 4, 0.01, False), ("err8", 8, 0.6, False),
         ("off8", 8, 0.0, False), ("hpc4", 4, 0.01, True),
         ("uneven4", 4, 0.01, False)]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    err = _synth_err(d, n_reads=220, rl=700, seed=3)
    (d / "u").mkdir()
    return dict(err=err, hpc=write_hpc_reads(err, str(d / "err_hpc.fa")),
                uneven=_synth(d / "u", n_reads=37, rl=1500, skew=True,
                              seed=7),
                dir=d)


def _case_input(corpora, name):
    return corpora["uneven" if name.startswith("uneven") else
                   "hpc" if name.startswith("hpc") else "err"]


@pytest.fixture(scope="module")
def jax_runs(corpora):
    """JAX assemble_sharded of every case: prefix and stats."""
    out = {}
    for name, n, presimp, hpc in CASES:
        prefix = str(corpora["dir"] / f"jax_{name}")
        st = jax_sharded(_case_input(corpora, name),
                         JaxParams(engine="device", presimp=presimp,
                                   reads_already_hpc=hpc, **KW),
                         prefix, n_devices=n)
        out[name] = (prefix, st)
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_assemble_sharded_matches_jax(tmp_path, corpora, jax_runs, case):
    name, n, presimp, hpc = case
    prefix = str(tmp_path / "port")
    st = assemble_sharded(_case_input(corpora, name),
                          Params(presimp=presimp, reads_already_hpc=hpc,
                                 **KW), prefix, n_devices=n, device="cpu")
    jp, jst = jax_runs[name]
    assert gfa_bytes(prefix) == gfa_bytes(jp)
    assert records(prefix) == records(jp) and records(prefix)
    for key in ("nb_reads", "nb_windows", "n_devices", "nb_nodes",
                "nb_edges", "presimp_removed", "distributed_edges"):
        assert st[key] == jst[key], key
    assert st["nb_nodes"] > 0 and st["device"] == "cpu"
    assert len(st["shard_unique_keys"]) == n
    assert sum(st["shard_windows"]) >= st["nb_windows"]
    if presimp > 0.5:
        assert st["presimp_removed"] > 0


@pytest.mark.parametrize("n", [4, 8])
def test_gathered_join_writes_the_same_graph(tmp_path, monkeypatch, corpora,
                                             jax_runs, n):
    """MDBG_SHARDED_EDGES=0 selects the gathered build_gfa join; its bytes
    are the distributed join's (and the JAX run's)."""
    name = "err4" if n == 4 else "err8"
    presimp = 0.01 if n == 4 else 0.6
    monkeypatch.setenv("MDBG_SHARDED_EDGES", "0")
    prefix = str(tmp_path / "gathered")
    st = assemble_sharded(corpora["err"], Params(presimp=presimp, **KW),
                          prefix, n_devices=n, device="cpu")
    assert "distributed_edges" not in st
    assert gfa_bytes(prefix) == gfa_bytes(jax_runs[name][0])
    assert st["presimp_removed"] == jax_runs[name][1]["presimp_removed"]


def test_sharded_graph_equals_the_chunked_graph(tmp_path, corpora,
                                                jax_runs):
    """Node ids differ (grouped by owner shard), the graph does not: the
    (KC, LN, shift) node map and the edge count equal those of
    core/chunked's run."""
    prefix = str(tmp_path / "chunked")
    st = assemble_device_chunked(corpora["err"], Params(**KW), prefix,
                                 device="cpu")
    jp, jst = jax_runs["err4"]
    assert _node_map(prefix) == _node_map(jp)
    assert st["nb_edges"] == jst["nb_edges"]


def test_cli_mesh(tmp_path, monkeypatch, corpora, jax_runs):
    monkeypatch.chdir(tmp_path)
    assert cli_main([corpora["err"], "-k", "5", "-l", "8", "-d", "0.05",
                     "--batch-reads", "8", "--mesh", "4", "--device", "cpu",
                     "--prefix", "cli"]) == 0
    assert gfa_bytes("cli") == gfa_bytes(jax_runs["err4"][0])
    assert records("cli") == records(jax_runs["err4"][0])


def test_rounds_at_both_widths_match_jax(tmp_path):
    """Reads of 1,000 bp, then past the length sample reads of 1,800 bp:
    the feed stages the short rounds at the half width and the others at
    the full width, and the run writes the JAX run's bytes."""
    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), 12_000))
    path = tmp_path / "widths.fa"
    with open(path, "w") as f:
        for i, rl in enumerate([1000] * 104 + [1800] * 20):
            at = int(rng.integers(0, len(genome) - rl))
            f.write(f">w{i}\n{genome[at:at + rl]}\n")
    prefix, jprefix = str(tmp_path / "port"), str(tmp_path / "jax")
    st = assemble_sharded(str(path), Params(**KW), prefix, n_devices=4,
                          device="cpu")
    jax_sharded(str(path), JaxParams(engine="device", **KW), jprefix,
                n_devices=4)
    assert st["staged_shapes"] == [[2, 1024], [2, 2048]]
    assert gfa_bytes(prefix) == gfa_bytes(jprefix)
    assert records(prefix) == records(jprefix) and records(prefix)


def test_extraction_overflow_raises(tmp_path, corpora):
    """Reads over their minimizer slots: the JAX run raises after its
    loop, the port at the round; neither re-plans."""
    p = Params(max_minimizers_per_read=12, **KW)
    with pytest.raises(RuntimeError, match="minimizer capacity"):
        assemble_sharded(corpora["err"], p, str(tmp_path / "x"),
                         n_devices=4, device="cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        jax_sharded(corpora["err"], JaxParams(engine="device",
                                              max_minimizers_per_read=12,
                                              **KW),
                    str(tmp_path / "j"), n_devices=4)


def test_read_over_the_staging_width_raises(tmp_path):
    """A read past the staging width cannot be split over the shards'
    rows: a clear error, as the multihost feed gives."""
    rng = np.random.default_rng(0)
    path = tmp_path / "long.fa"
    with open(path, "w") as f:
        for i in range(3):
            f.write(f">r{i}\n" + "".join(rng.choice(list("ACGT"), 900))
                    + "\n")
        f.write(">long\n" + "".join(rng.choice(list("ACGT"), 5000)) + "\n")
    with pytest.raises(ValueError, match="staging width"):
        assemble_sharded(str(path), Params(max_read_len=1024, **KW),
                         str(tmp_path / "x"), n_devices=2, device="cpu")


def test_no_device_and_no_card_raises(tmp_path, corpora):
    """Without a card and without device="cpu" the run refuses to start:
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assemble_sharded(corpora["err"], Params(**KW), str(tmp_path / "x"),
                         n_devices=2)
