"""The port's streaming engine as a whole, on the CPU, against the JAX
package's `assemble`: every scheme and flag that runs through it
(--lmer-counts, --uhs with the exact set and with --bf, --lcp, --reference,
--read-stats, --engine host, reference cuts) writes the same .gfa bytes,
.sequences records, .ec_data and .read_stats bytes, with the device engine
and with the host engine.  Every input is generated from a seed; nothing
outside the test's own directory is read or written.
"""

import shutil
from collections import Counter

import numpy as np
import pytest
import torch

from rust_mdbg_tpu.core.pipeline import assemble as jax_assemble
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch.cli import main as cli_main
from rust_mdbg_tpu_torch.core.chunked import NotPortedError
from rust_mdbg_tpu_torch.core.pipeline import assemble, load_lmer_counts
from rust_mdbg_tpu_torch.params import Params

from torch_corpus import gfa_bytes, records, write_hpc_reads, write_raw_reads

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

KW = dict(k=5, l=10, density=0.08, min_kmer_abundance=2, batch_reads=32)


def _lmers(path, seed, n, l=10):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            f.write("".join("ACGT"[j] for j in rng.integers(0, 4, l)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_corpus")
    raw = write_raw_reads(str(d / "raw.fa"), genome_mbp=0.02, coverage=15)
    # an lmer-count file as a k-mer counter writes it: the 10-mers of the
    # first hundred reads, every fifth with an outlier count above
    # lmer_counts_max, and a line the parser skips
    cnt = Counter()
    with open(raw) as f:
        for i, line in enumerate(f):
            s = line.strip()
            if line[0] == ">" or i > 200:
                continue
            for j in range(0, len(s) - 10, 3):
                if set(s[j : j + 10]) <= set("ACGT"):
                    cnt[s[j : j + 10]] += 1
    lm = str(d / "lmers.txt")
    with open(lm, "w") as f:
        f.write("malformed\n")
        for i, s in enumerate(sorted(cnt)):
            f.write(f"{s} {10 ** 6 if i % 5 == 0 else 50}\n")
    # a two-record genome for --reference
    rng = np.random.default_rng(5)
    genome = str(d / "genome.fa")
    with open(genome, "w") as f:
        for name, n in (("chrA", 60_000), ("chrB", 9_000)):
            f.write(f">{name}\n")
            f.write("".join("ACGT"[j] for j in rng.integers(0, 4, n)) + "\n")
    return dict(raw=raw, hpc=write_hpc_reads(raw, str(d / "hpc.fa")),
                uhs=_lmers(d / "uhs.txt", 3, 3000),
                lcp=_lmers(d / "lcp.txt", 4, 50), lmers=lm, genome=genome)


#: name -> (Params keywords, path attributes by corpus key, reads)
FLAGS = {
    "uhs": (dict(uhs=True), {"_uhs_path": "uhs"}, "raw"),
    "uhs_bf": (dict(uhs=True, use_bf=True, bloom_log2_bits=20),
               {"_uhs_path": "uhs"}, "raw"),
    "lcp": (dict(lcp=True), {"_lcp_path": "lcp"}, "raw"),
    "lcp_bf_hpc": (dict(lcp=True, use_bf=True, bloom_log2_bits=18,
                        reads_already_hpc=True), {"_lcp_path": "lcp"}, "hpc"),
    "lmer_counts": (dict(has_lmer_counts=True, density=0.3),
                    {"_lmer_counts_path": "lmers"}, "raw"),
    "lmer_counts_uhs": (dict(has_lmer_counts=True, density=0.3, uhs=True),
                        {"_lmer_counts_path": "lmers", "_uhs_path": "uhs"},
                        "raw"),
    "reference": (dict(reference=True, min_kmer_abundance=1), {}, "genome"),
    "reference_reads": (dict(reference=True), {}, "raw"),
    "ref_cuts_uhs": (dict(seq_ref_cuts=True, uhs=True), {"_uhs_path": "uhs"},
                     "raw"),
    # density scheme on raw reads: reference cuts alone switch the extent
    # plane off in the extractor
    "ref_cuts_reference": (dict(seq_ref_cuts=True, reference=True), {},
                           "raw"),
    "no_basespace": (dict(uhs=True, no_basespace=True), {"_uhs_path": "uhs"},
                     "raw"),
}


def _params(cls, corpus, kw, paths, engine):
    p = cls(**{**KW, **kw, "engine": engine})
    for attr, key in paths.items():
        object.__setattr__(p, attr, corpus[key])
    return p


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_streaming_matches_jax(tmp_path, corpus, flag, engine):
    kw, paths, reads = FLAGS[flag]
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_assemble(corpus[reads],
                      _params(JaxParams, corpus, kw, paths, engine), pj)
    st = assemble(corpus[reads], _params(Params, corpus, kw, paths, engine),
                  pt, device="cpu")
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)
    assert bool(records(pt)) != bool(kw.get("no_basespace"))
    assert st["nb_nodes"] == sj["nb_nodes"] > 20
    assert st["nb_edges"] == sj["nb_edges"] > 20
    assert st["nb_windows"] == sj["nb_windows"]
    if kw.get("reference"):
        with open(pj + ".ec_data", "rb") as a, open(pt + ".ec_data",
                                                    "rb") as b:
            ec = b.read()
            assert a.read() == ec and len(ec) > 1000
    if engine == "device":
        assert st["host_rows"] == 0 and st["tile_host_rows"] == 0
        assert (st["filter_fill"] > 0) == bool(kw.get("uhs") or kw.get("lcp"))
    else:
        assert "host_rows" not in st


@pytest.mark.parametrize("engine", ["device", "host"])
def test_read_stats_matches_jax(tmp_path, corpus, engine):
    """--read-stats writes <file>.read_stats beside its input and no GFA;
    the input is copied into the test's directory first."""
    outs = {}
    for name, fn, cls, extra in (("jax", jax_assemble, JaxParams, {}),
                                 ("torch", assemble, Params,
                                  dict(device="cpu"))):
        rs = str(tmp_path / f"{name}_stats_input.fa")
        shutil.copy(corpus["raw"], rs)
        st = fn(corpus["raw"], cls(**KW, engine=engine),
                str(tmp_path / name), read_stats_path=rs, **extra)
        assert "nb_nodes" not in st and st["nb_reads"] > 100
        assert not (tmp_path / f"{name}.gfa").exists()
        with open(rs + ".read_stats", "rb") as f:
            outs[name] = f.read()
    assert outs["jax"] == outs["torch"] and len(outs["torch"]) > 10_000


def test_reference_long_record_takes_the_tiler(tmp_path, corpus, monkeypatch):
    """With the long-row threshold lowered to the test's size, the genome's
    rows go through extract_minimizers_tiled (five tiles for the first
    record) and the files equal the untiled run's and the JAX package's."""
    from rust_mdbg_tpu_torch.ops import extract as xt

    kw, paths, reads = FLAGS["reference"]
    p = _params(Params, corpus, kw, paths, "device").replace(batch_reads=2)
    plain, tiled, pj = (str(tmp_path / x) for x in ("plain", "tiled", "jax"))
    s0 = assemble(corpus[reads], p, plain, device="cpu")
    monkeypatch.setattr(xt, "LONG_SEQ_MIN", 1 << 16)
    monkeypatch.setattr(xt, "TILE_DEFAULT", 1 << 14)
    s1 = assemble(corpus[reads], p, tiled, device="cpu")
    assert s0["tiled_rows"] == 0 and s1["tiled_rows"] == 2
    assert s1["tile_host_rows"] == 0
    jax_assemble(corpus[reads], _params(JaxParams, corpus, kw, paths,
                                        "device").replace(batch_reads=2), pj)
    for other in (plain, pj):
        assert gfa_bytes(tiled) == gfa_bytes(other)
        assert records(tiled) == records(other)
        with open(tiled + ".ec_data", "rb") as a, \
                open(other + ".ec_data", "rb") as b:
            assert a.read() == b.read()


def test_host_rows_are_counted_and_exact(tmp_path, corpus):
    """A tiny minimizer capacity sends most reads through the per-row host
    re-extraction: same files as the host engine, rows counted."""
    kw = dict(KW, max_minimizers_per_read=48, has_lmer_counts=True,
              density=0.3)
    ps = {e: Params(**kw, engine=e) for e in ("device", "host")}
    for p in ps.values():
        object.__setattr__(p, "_lmer_counts_path", corpus["lmers"])
    pd, ph = str(tmp_path / "dev"), str(tmp_path / "host")
    sd = assemble(corpus["raw"], ps["device"], pd, device="cpu")
    assemble(corpus["raw"], ps["host"], ph, device="cpu")
    assert 0 < sd["host_rows"] < sd["nb_reads"]
    assert gfa_bytes(pd) == gfa_bytes(ph)
    assert records(pd) == records(ph)


def test_streaming_equals_chunked_driver(tmp_path, corpus):
    """--engine host (streaming, numpy) and --engine device (the chunked
    device driver) write the same graph bytes for a density run."""
    pa, ph = str(tmp_path / "auto"), str(tmp_path / "host")
    sa = assemble(corpus["raw"], Params(**KW), pa, device="cpu")
    sh = assemble(corpus["raw"], Params(**KW, engine="host"), ph,
                  device="cpu")
    assert "nb_chunks" in sa and "nb_chunks" not in sh
    assert gfa_bytes(pa) == gfa_bytes(ph)
    assert records(pa) == records(ph)


def test_load_lmer_counts_canonicalizes(corpus, tmp_path):
    from rust_mdbg_tpu.core.pipeline import load_lmer_counts as jax_load

    assert load_lmer_counts(corpus["lmers"]) == jax_load(corpus["lmers"])
    f = tmp_path / "c.txt"
    f.write_text("TTTTTTTTTT 7\nshort\nACGTACGTAC 3 extra\n")
    assert load_lmer_counts(str(f)) == {"AAAAAAAAAA": 7, "ACGTACGTAC": 3}


#: CLI flags -> the FLAGS entry whose function-level run they must equal
CLI = {
    "uhs": ["--uhs", "{uhs}"],
    "uhs_bf": ["--uhs", "{uhs}", "--bf", "--bf-bits", "20"],
    "lcp": ["--lcp", "{lcp}"],
    "lmer_counts": ["--lmer-counts", "{lmers}", "-d", "0.3"],
    "reference_reads": ["--reference"],
}


@pytest.mark.parametrize("flag", list(CLI))
def test_cli_runs_the_streaming_flags(tmp_path, corpus, flag, capsys):
    kw, paths, reads = FLAGS[flag]
    p, q = str(tmp_path / "cli"), str(tmp_path / "fn")
    argv = [corpus[reads], "-k", "5", "-l", "10", "-d", "0.08", "--prefix",
            p, "--device", "cpu", "--batch-reads", "32", "--engine", "auto"]
    argv += [a.format(**corpus) for a in CLI[flag]]
    assert cli_main(argv) == 0
    assert "Number of mdBG nodes" in capsys.readouterr().out
    assemble(corpus[reads], _params(Params, corpus, kw, paths, "device"), q,
             device="cpu")
    assert gfa_bytes(p) == gfa_bytes(q)
    assert records(p) == records(q)


def test_cli_read_stats_debug_and_missing_files(tmp_path, corpus, capsys):
    rs = str(tmp_path / "stats_input.fa")
    with open(corpus["raw"]) as f, open(rs, "w") as out:
        out.writelines(f.readlines()[:40])
    base = ["-k", "5", "-l", "10", "-d", "0.08", "--device", "cpu",
            "--batch-reads", "32", "--prefix", str(tmp_path / "x")]
    assert cli_main([rs, "--read-stats", rs, "--debug", "--engine", "host"]
                    + base) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("Read stats written, exiting.")
    assert "Number of mdBG nodes" not in out
    assert any(line.startswith("r0_") for line in out.splitlines())  # --debug
    assert (tmp_path / "stats_input.fa.read_stats").stat().st_size > 0
    assert not (tmp_path / "x.gfa").exists()
    for flag in ("--uhs", "--lcp"):
        assert cli_main([rs, flag, str(tmp_path / "absent.txt")] + base) == 2
        assert "file not found" in capsys.readouterr().err


def test_streaming_needs_a_device(tmp_path, corpus, monkeypatch):
    """Without --device and without a GPU every streaming flag raises
    before anything is written; error correction is still a later slice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag in ("uhs", "reference", "lmer_counts"):
        kw, paths, reads = FLAGS[flag]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            assemble(corpus[reads], _params(Params, corpus, kw, paths,
                                            "auto"), str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assemble(corpus["raw"], Params(**KW), str(tmp_path / "x"),
                 read_stats_path=corpus["raw"])
    assert not list(tmp_path.iterdir())
    with pytest.raises(NotPortedError, match="error correction"):
        assemble(corpus["raw"], Params(**KW, error_correct=True),
                 str(tmp_path / "x"), device="cpu")
