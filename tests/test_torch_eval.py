"""The port's evaluation copies (eval/compare_kmers, mappability,
ref_assisted_ec, recovery_grid) and the host experiments pangenome and
minimizer_ball, against the JAX package's, on the CPU.  Tolerance: exact
equality of each tool's exit code and standard output on the same inputs.

The inputs are generated from a seed: a 40 kb genome read at 20x in 4 kb
reads with 0.2 % substitutions, assembled by the port on the CPU (the
reads, and the genome with --reference --minabund 1), and minimizer-space
files drawn from the genome's .ec_data."""

import os

import numpy as np
import pytest
import torch

import rust_mdbg_tpu.eval.compare_kmers as jax_compare_kmers
import rust_mdbg_tpu.eval.mappability as jax_mappability
import rust_mdbg_tpu.eval.recovery_grid as jax_recovery_grid
import rust_mdbg_tpu.eval.ref_assisted_ec as jax_ref_assisted_ec
import rust_mdbg_tpu.experiments.minimizer_ball as jax_minimizer_ball
import rust_mdbg_tpu.experiments.pangenome as jax_pangenome
from rust_mdbg_tpu_torch.core.pipeline import assemble
from rust_mdbg_tpu_torch.eval import (compare_kmers, mappability,
                                      recovery_grid, ref_assisted_ec)
from rust_mdbg_tpu_torch.experiments import minimizer_ball, pangenome
from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
from rust_mdbg_tpu_torch.io import ec_data
from rust_mdbg_tpu_torch.params import Params

torch.set_num_threads(2)

KLD = dict(k=21, l=12, density=0.003)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    reads, genome = str(d / "reads.fa"), str(d / "genome.fa")
    write_synthetic_reads(reads, genome_mbp=0.04, coverage=20,
                          read_len=4000, error_rate=0.002, seed=4,
                          genome_out=genome)
    assemble(reads, Params(min_kmer_abundance=2, **KLD), str(d / "r"),
             device="cpu")
    assemble(genome, Params(min_kmer_abundance=1, reference=True,
                            batch_reads=1, **KLD), str(d / "g"),
             device="cpu")
    # every KC at 1: mappability's "100 % singletons" exit code
    with open(d / "r.gfa") as f, open(d / "single.gfa", "w") as g:
        for line in f:
            g.write(line.replace("\tKC:i:", "\tKC:i:1\tX:i:"))
    # minimizer-space reads: noisy slices of the genome's minimizers
    rng = np.random.default_rng(9)
    (ref,) = ec_data.load(str(d / "g"))
    mins = ref.read_transformed
    w = ec_data.EcWriter(str(d / "ms"))
    lines = []
    for i in range(40):
        s = int(rng.integers(0, len(mins) - 12))
        read = list(mins[s : s + 12])
        if i % 3 == 0:
            read[int(rng.integers(0, 12))] = int(rng.integers(1, 1 << 40))
        w.record(f"r{i}", "*", read, ["m"] * len(read), range(len(read)))
        lines.append(f"s{i} " + " ".join(map(str, read)))
    w.close()
    (d / "corpus.txt").write_text("\n".join(lines) + "\n")
    (d / "targets.txt").write_text(
        "geneA " + " ".join(map(str, mins[5:25])) + "\n"
        "[geneB] [" + ", ".join(map(str, mins[40:46][::-1])) + "]\n"
        "short 1 2\n")
    (d / "hits.txt").write_text("s1\tgeneA\t0\ns2\tgeneA\t3\ns9\tgeneB\t1\n")
    return d


#: (port main, JAX main, argv with {d} for the inputs' directory)
CASES = {
    "compare_kmers": (compare_kmers.main, jax_compare_kmers.main,
                      ["{d}/g", "{d}/r"]),
    "mappability": (mappability.main, jax_mappability.main, ["{d}/r"]),
    "mappability_singletons": (mappability.main, jax_mappability.main,
                               ["{d}/single"]),
    "ref_assisted_ec": (ref_assisted_ec.main, jax_ref_assisted_ec.main,
                        ["{d}/g.ec_data", "{d}/ms.ec_data", "--l=3",
                         "--weak=3"]),
    "pangenome_components": (pangenome.main, jax_pangenome.main,
                             ["components", "{d}/r.gfa"]),
    "pangenome_scan": (pangenome.main, jax_pangenome.main,
                       ["scan", "{d}/targets.txt", "{d}/corpus.txt",
                        "-k", "4"]),
    "pangenome_gene_coverage": (pangenome.main, jax_pangenome.main,
                                ["gene-coverage", "{d}/targets.txt",
                                 "{d}/hits.txt", "-k4"]),
    "minimizer_ball": (minimizer_ball.main, jax_minimizer_ball.main,
                       ["--l=8", "--density=0.01", "--genome=3000",
                        "--seed=3"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_copy_matches_jax(case, inputs, capsys, monkeypatch):
    port_main, jax_main, argv = CASES[case]
    argv = [a.format(d=inputs) for a in argv]
    if case == "minimizer_ball":
        # the JAX copy's density_minimizers raises under numpy 2 (int64
        # >> uint64); test_density_minimizers_match_jax_hash holds the
        # port's against the JAX hash, and the rest of the run is JAX's
        monkeypatch.setattr(jax_minimizer_ball, "density_minimizers",
                            minimizer_ball.density_minimizers)
    got = []
    for main in (jax_main, port_main):
        rc = main(list(argv))
        got.append((rc, capsys.readouterr().out))
    assert got[1] == got[0]
    assert got[1][1].strip()
    if case == "mappability_singletons":
        assert got[1][0] == 1 and "100.00" in got[1][1]
    else:
        assert got[1][0] == 0


@pytest.mark.parametrize("l, density", [(5, 0.05), (8, 0.01)])
def test_density_minimizers_match_jax_hash(l, density):
    """The port's selected l-mers are those whose JAX-package invertible
    hash of the 2-bit packing falls under density * 4^l."""
    from rust_mdbg_tpu.ops.minimizers import invertible_hash_np

    space = 4**l
    h = invertible_hash_np(np.arange(space, dtype=np.uint64),
                           np.uint64(space - 1))
    want = {"".join("ACGT"[(int(x) >> (2 * (l - 1 - i))) & 3]
                    for i in range(l))
            for x in np.nonzero(h < np.uint64(int(density * space)))[0]}
    assert minimizer_ball.density_minimizers(l, density) == want
    assert want


def test_recovery_grid_matches_jax(inputs, tmp_path, monkeypatch, capsys):
    """One recovery point (k=21, l=12, d=0.003) through each package's
    main, the port's with --device=cpu: the same output (the compare
    histograms, the plot or its ASCII form, the recovery percentage) and
    the same .gfa of both assemblies.  Without a card and without
    --device the port raises before it assembles."""
    argv = [str(inputs / "reads.fa"), str(inputs / "genome.fa"), "out",
            "--densities=0.003"]
    got = {}
    for side, main, extra in (("jax", jax_recovery_grid.main, []),
                              ("port", recovery_grid.main,
                               ["--device=cpu"])):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        assert main(argv + extra) == 0
        got[side] = capsys.readouterr().out
    assert got["port"] == got["jax"] and "density=0.003: " in got["port"]
    for name in ("genome-d0.003.gfa", "reads-d0.003.gfa"):
        assert (tmp_path / "port" / "out" / name).read_bytes() == \
            (tmp_path / "jax" / "out" / name).read_bytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recovery_grid.main(argv)
    assert sorted(os.listdir(tmp_path)) == ["jax", "port"]
