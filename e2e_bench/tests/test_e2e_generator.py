"""The corpus generator: the same seed gives the same FASTA, every seed the
same read lengths in another order, the reads follow each configuration's
lengths and error model, and a configuration that feeds compressed reads
gets the compression of the raw reads of the same seed."""

import filecmp
import os

import numpy as np
import pytest

from e2e_bench import generator
from e2e_bench.tests.tiny import PKG, load_json

CONFIGS = ["hg002-k21", "hg002-k21-raw"]


def config(name, genome_mbp=0.2):
    cfg = load_json(os.path.join(PKG, "configs", f"{name}.json"))
    cfg["genome_mbp"] = genome_mbp
    return cfg


def fasta_reads(path):
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    assert all(h.startswith(b">r") for h in lines[0:-1:2])
    return lines[1::2]


def hpc(s: bytes) -> bytes:
    a = np.frombuffer(s, dtype=np.uint8)
    keep = np.ones(a.size, dtype=bool)
    keep[1:] = a[1:] != a[:-1]
    return a[keep].tobytes()


@pytest.mark.parametrize("name", CONFIGS)
def test_deterministic_per_seed(tmp_path, name):
    cfg = config(name)
    paths = [str(tmp_path / f"{i}.fa") for i in range(3)]
    a = generator.write_corpus(cfg, 2**31 + 5, paths[0])
    b = generator.write_corpus(cfg, 2**31 + 5, paths[1])
    c = generator.write_corpus(cfg, 2**32 + 9, paths[2])
    assert a == b and filecmp.cmp(paths[0], paths[1], shallow=False)
    assert not filecmp.cmp(paths[0], paths[2], shallow=False)
    assert a["reads"] == c["reads"]
    assert abs(a["bases"] - c["bases"]) < 0.01 * a["bases"]
    # the seed draws the order of the reads, not their lengths
    la, lc = (np.array([len(r) for r in fasta_reads(p)])
              for p in (paths[0], paths[2]))
    assert (la != lc).mean() > 0.5
    assert abs(np.median(la) - np.median(lc)) < 0.01 * np.median(la)


@pytest.mark.parametrize("name", CONFIGS)
def test_lengths_follow_the_configuration(tmp_path, name):
    cfg = config(name, genome_mbp=1.0)
    rl = cfg["read_len"]
    lens = generator.read_lengths(cfg)
    assert lens.size == round(cfg["coverage"] * 1e6 / rl["mean"])
    assert lens.min() >= rl["min"] and lens.max() <= rl["max"]
    assert abs(lens.mean() - rl["mean"]) < 0.03 * rl["mean"]
    assert abs(lens.std() - rl["sd"]) < 0.1 * rl["sd"]


def test_share_marks_the_first_reads(tmp_path):
    cfg = config("hg002-k21-raw")
    path = str(tmp_path / "r.fa")
    c = generator.write_corpus(cfg, 2**31 + 5, path, share=0.25)
    with open(path, "rb") as f:
        head = f.read(c["share_bytes"])
    assert head.count(b">") == int(np.ceil(0.25 * c["reads"]))
    assert head.endswith(b"\n")


def test_hpc_reads_are_the_raw_reads_compressed(tmp_path):
    """The two configurations share a library: the same seed gives the
    compressed configuration the raw one's reads, compressed."""
    raw, comp = config("hg002-k21-raw"), config("hg002-k21")
    assert raw["length_seed"] == comp["length_seed"]
    pr, pc = str(tmp_path / "raw.fa"), str(tmp_path / "hpc.fa")
    cr = generator.write_corpus(raw, 2**31 + 3, pr)
    cc = generator.write_corpus(comp, 2**31 + 3, pc)
    rr, rc = fasta_reads(pr), fasta_reads(pc)
    assert cr["reads"] == cc["reads"] == len(rr) == len(rc)
    assert all(hpc(a) == b for a, b in zip(rr, rc))
    assert 0.70 < cc["bases"] / cr["bases"] < 0.80
    assert cc["bases"] == sum(map(len, rc))


def test_substitutions():
    cfg = config("hg002-k21-raw")
    cfg["errors"] = dict(substitution=0.003, homopolymer=0.0)
    rng = np.random.default_rng(3)
    fwd = generator.make_genome(cfg, rng)
    rc = fwd.translate(generator.COMPLEMENT)[::-1]
    lens = np.full(40, 20_000)
    seq, out_lens, starts, rev = generator._block(cfg, rng, fwd, rc, lens)
    assert (out_lens == lens).all()
    diffs = 0
    a = 0
    for m, s, r in zip(out_lens.tolist(), starts.tolist(), rev.tolist()):
        read = seq[a : a + m].tobytes()
        src = fwd[s : s + m]
        if r:
            src = src.translate(generator.COMPLEMENT)[::-1]
        diffs += sum(x != y for x, y in zip(read, src))
        a += m
    want = 40 * round(cfg["errors"]["substitution"] * 20_000)
    assert 0.9 * want <= diffs <= 1.1 * want


def test_raw_homopolymer_changes_keep_the_hpc_sequence():
    cfg = config("hg002-k21-raw")
    cfg["errors"] = dict(substitution=0.0, homopolymer=0.002)
    rng = np.random.default_rng(4)
    fwd = generator.make_genome(cfg, rng)
    assert hpc(fwd) != fwd  # a raw genome has runs
    rc = fwd.translate(generator.COMPLEMENT)[::-1]
    lens = np.full(40, 20_000)
    seq, out_lens, starts, rev = generator._block(cfg, rng, fwd, rc, lens)
    assert int(out_lens.sum()) == seq.size
    assert (out_lens != lens).any()
    same = 0
    a = 0
    for m, s, r, m0 in zip(out_lens.tolist(), starts.tolist(), rev.tolist(),
                           lens.tolist()):
        src = fwd[s : s + m0]
        if r:
            src = src.translate(generator.COMPLEMENT)[::-1]
        same += hpc(seq[a : a + m].tobytes()) == hpc(src)
        a += m
    # two changes in one run of two bases can remove the run: rare
    assert same >= 38
