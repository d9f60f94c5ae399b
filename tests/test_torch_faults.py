"""The port's cures for runs the JAX package finishes only through its
streaming fall-back, on the CPU against that package: an over-long read
after the sampled ones, reads over their minimizer slots, and an input
over the whole-run budget at --minabund beyond the chunk slots.  The
reference is the JAX package's streaming half on the same command (what
its `assemble` ends up running when a device driver raises); the port
must write the same .gfa bytes and .sequences records on its own routes,
with the re-plan or route counted in its stats.  Also the CLI: every
command line of the JAX package's parser gives the same Params in the
port's."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import rust_mdbg_tpu.cli as jax_cli
import rust_mdbg_tpu.core.pipeline as jax_pipeline
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch import cli
from rust_mdbg_tpu_torch.core import pipeline
from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
from rust_mdbg_tpu_torch.io import fastx_native
from rust_mdbg_tpu_torch.params import Params, staging_width

from torch_corpus import gfa_bytes, records, write_hpc_reads, write_raw_reads

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

KW = dict(k=7, l=12, density=0.01, batch_reads=16)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """raw.fa (torch_corpus' reads, 1.5 kb at most), long.fa: the same
    with its 150th read replaced by three full-length reads end to end
    (4.5 kb, past the staging width of the 100 sampled reads), and the
    pre-HPC'd form of long.fa."""
    d = tmp_path_factory.mktemp("fault_corpus")
    raw = write_raw_reads(str(d / "raw.fa"))
    with open(raw) as f:
        lines = f.read().split("\n")
    full = [x for x in lines[1::2] if len(x) == 1500]
    lines[2 * 149 + 1] = "".join(full[:3])
    long = str(d / "long.fa")
    with open(long, "w") as f:
        f.write("\n".join(lines))
    return dict(raw=raw, long=long,
                long_hpc=write_hpc_reads(long, str(d / "long_hpc.fa")))


@pytest.fixture(scope="module")
def odd_width_reads(tmp_path_factory):
    """torch_corpus' reads at 30x and 1,004 bp at most, the 150th replaced
    by three full-length reads end to end (3,012 bp)."""
    d = tmp_path_factory.mktemp("odd_width")
    raw = write_raw_reads(str(d / "raw.fa"), coverage=30, read_len=1004)
    with open(raw) as f:
        lines = f.read().split("\n")
    full = [x for x in lines[1::2] if len(x) == 1004]
    lines[2 * 149 + 1] = "".join(full[:3])
    path = str(d / "odd.fa")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def _jax_streaming(path, prefix, monkeypatch, **kw):
    """The JAX package's streaming half on `path`: its `assemble` with the
    device drivers ruled out, which is what it runs after one raises."""
    monkeypatch.setattr(jax_pipeline, "_device_table_eligible",
                        lambda *a: False)
    return jax_pipeline.assemble(path, JaxParams(engine="device", **kw),
                                 prefix)


@pytest.mark.parametrize("minab", [2, 17])
@pytest.mark.parametrize("kind,extra", [
    ("long", {}), ("long_hpc", dict(reads_already_hpc=True)),
    ("raw", dict(max_minimizers_per_read=12)),
    ("long", dict(max_minimizers_per_read=12))])
def test_replans_match_jax_fallback(tmp_path, corpora, monkeypatch, kind,
                                    extra, minab):
    """An over-long read past the sampled ones and a forced small minimizer
    capacity: the chunked driver (minabund 2) re-stages the read or the
    chunk, the whole run (minabund 17) restarts; both write the JAX
    package's bytes."""
    kw = dict(KW, min_kmer_abundance=minab, **extra)
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = _jax_streaming(corpora[kind], pj, monkeypatch, **kw)
    st = pipeline.assemble(corpora[kind], Params(**kw), pt, device="cpu")
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 40
    assert st["nb_reads"] == sj["nb_reads"] == 400
    assert st["replans"] >= 1
    assert ("nb_chunks" in st) and (("phase1_nodes" in st) == (minab == 17))


@pytest.mark.parametrize("minab", [2, 17])
def test_max_read_len_off_the_byte_grid_matches_jax(tmp_path, monkeypatch,
                                                    odd_width_reads, minab):
    """--max-read-len 1001, not a multiple of 8, stages at 1,008: the reads
    of 1,002-1,004 bp fit that width (the JAX package's 1,001 hands each
    over alone) and only the 3,012 bp read is over-long, packed on the
    host.  The chunked driver (minabund 2) and the whole run (17) write
    the JAX package's bytes."""
    kw = dict(KW, min_kmer_abundance=minab, max_read_len=1001)
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = _jax_streaming(odd_width_reads, pj, monkeypatch, **kw)
    st = pipeline.assemble(odd_width_reads, Params(**kw), pt, device="cpu")
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 40
    assert st["nb_reads"] == sj["nb_reads"]
    assert st["replans"] == 1
    c = st["counters"]
    assert c["feed.host_packed_chunks"] == 1
    assert c["feed.parser_packed_chunks"] >= st["nb_chunks"] - 1


def test_long_read_chunk_is_its_own(tmp_path, corpora):
    """The over-long read is one singleton chunk of its own, between the
    chunks before and after it, and counts one re-plan."""
    p = Params(**dict(KW, min_kmer_abundance=2))
    st = assemble_device_chunked(corpora["long"], p, str(tmp_path / "a"),
                                 chunk_reads=64, device="cpu")
    ref = assemble_device_chunked(corpora["raw"], p, str(tmp_path / "b"),
                                  chunk_reads=64, device="cpu")
    assert st["replans"] == 1 and ref["replans"] == 0
    # the feed ends the chunk at the read before it, and the next chunk
    # starts after it: 400 reads in chunks of 64 make 7, with it 8
    assert ref["nb_chunks"] == 7 and st["nb_chunks"] == 8


@pytest.mark.parametrize("side", ["over", "at"])
@pytest.mark.parametrize("kind", ["raw", "long_hpc"])
def test_over_budget_route_at_minabund_17(tmp_path, corpora, monkeypatch,
                                          side, kind):
    """The route is decided from the plan: one byte under the whole-run
    buffers' size the run goes to the streaming engine, at their size it
    stays whole; both write the JAX package's streaming bytes."""
    kw = dict(KW, min_kmer_abundance=17,
              reads_already_hpc=kind == "long_hpc")
    plan = pipeline.plan_table(corpora[kind], Params(**kw))
    if kind == "long_hpc":  # the size the re-planned run is held against
        with open(corpora[kind]) as f:
            longest = max(len(x) for x in f.read().split("\n")[1::2])
        plan = pipeline.plan_table(corpora[kind], Params(**kw),
                                   L=staging_width(longest))
    need = plan["read_cap"] * plan["per_read"]
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    _jax_streaming(corpora[kind], pj, monkeypatch, **kw)
    st = pipeline.assemble(corpora[kind], Params(**kw), pt, device="cpu",
                           mem_budget=need - 1 if side == "over" else need)
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)
    if side == "over":
        assert st["route"] == "streaming (over whole-run budget)"
        assert "phase1_nodes" not in st
    else:
        assert "route" not in st and "phase1_nodes" in st
    assert st["replans"] == (kind == "long_hpc")


#: command lines of the JAX package's parser, each a list of flags after
#: the reads file
JAX_COMMANDS = [
    [],
    ["-k", "21", "-l", "14", "-d", "0.003", "--minabund", "3"],
    ["-k", "7", "-n", "4", "-t", "3", "--distance", "1",
     "--correction-threshold", "5", "--threads", "16"],
    ["-k", "7", "--distance", "9"],
    ["-k", "7", "--reference", "--error-correct"],
    ["-k", "7", "--ec-procs", "3", "--ec-chunk", "8", "--ec-device-poa",
     "--reference"],
    ["-k", "7", "--syncmers", "-s", "5", "--skiphpc", "--bf", "--bf-bits",
     "24", "--presimp", "0.2", "--no-basespace"],
    ["-k", "7", "--lmer-counts", "c.txt", "--lmer-counts-min", "3",
     "--lmer-counts-max", "90", "--engine", "pallas", "--batch-reads", "64",
     "--max-read-len", "4096", "--chunk-reads", "128"],
    ["-k", "7", "--uhs", "u.txt", "--engine", "host", "--debug",
     "-p", "out"],
    ["-k", "7", "--lcp", "c.txt", "--engine", "auto", "--read-stats", "r"],
]


@pytest.mark.parametrize("argv", JAX_COMMANDS,
                         ids=[" ".join(a) or "defaults" for a in JAX_COMMANDS])
def test_cli_parses_jax_command_lines(tmp_path, corpora, argv):
    """Each JAX command line gives equal Params (and side fields, and the
    prefix) in both parsers; --engine auto and pallas are the port's
    device."""
    argv = [corpora["raw"]] + argv
    pj, prefix_j = jax_cli.params_from_args(
        jax_cli.build_parser().parse_args(argv))
    pt, prefix_t = cli.params_from_args(cli.build_parser().parse_args(argv))
    want = dataclasses.asdict(pj)
    want["engine"] = cli._engine(want["engine"])
    assert dataclasses.asdict(pt) == want
    assert prefix_t == prefix_j
    for side in ("_lmer_counts_path", "_uhs_path", "_lcp_path"):
        assert getattr(pt, side, None) == getattr(pj, side, None)
    assert not pt.error_correct


def test_cli_error_correct_alone_is_refused(tmp_path, corpora):
    """The name is from the slices before error correction: --error-correct
    without --reference now runs, and its outputs are the JAX CLI's bytes."""
    argv = [corpora["raw"], "-k", "7", "-l", "12", "-d", "0.01",
            "--error-correct"]
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.main(argv + ["--engine", "host", "--prefix", pj]) == 0
    assert cli.main(argv + ["--device", "cpu", "--prefix", pt]) == 0
    for ext in (".ec_data", ".postcor.ec_data", ".poa.ec_data"):
        assert open(pj + ext, "rb").read() == open(pt + ext, "rb").read()
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)


def test_cli_reference_with_error_correct_runs(tmp_path, corpora, capsys):
    """--error-correct beside --reference runs with EC off, as in the JAX
    CLI, and the CLI prints the H2D bytes of a device driver."""
    p = str(tmp_path / "ref")
    assert cli.main([corpora["raw"], "-k", "7", "-l", "12", "-d", "0.01",
                     "--reference", "--error-correct", "--minabund", "1",
                     "--device", "cpu", "--prefix", p]) == 0
    assert os.path.exists(p + ".gfa")
    q = str(tmp_path / "chunked")
    assert cli.main([corpora["raw"], "-k", "7", "-l", "12", "-d", "0.01",
                     "--device", "cpu", "--prefix", q]) == 0
    out = capsys.readouterr().out
    assert "H2D bytes: " in out
    assert int(out.split("H2D bytes: ")[1].split()[0]) > 0


def test_cli_synth_reads_matches_jax(tmp_path):
    """synth-reads is the port's experiments/synth: the same FASTA as the
    JAX package's for the same seed."""
    a, b = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    flags = ["--genome-mbp", "0.02", "--coverage", "3", "--read-len", "900",
             "--seed", "4"]
    assert cli.main(["synth-reads", a] + flags) == 0
    assert jax_cli.main(["synth-reads", b] + flags) == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        data = fa.read()
        assert data == fb.read() and data.count(b">") == 66


def _pump_threads():
    return [t for t in threading.enumerate()
            if t.name == fastx_native.PUMP_THREAD]


def _leave_early(path, how):
    """Take one chunk of `path` from the prefetcher and leave the loop by
    `how`; returns the pump thread that ran and the first chunk's reads."""
    gen = fastx_native.chunks_prefetched(path, 8, 1500)
    first = next(gen)
    (t,) = _pump_threads()
    if how == "break":
        gen.close()  # what a `for ... break` does once the loop lets go
    else:
        with pytest.raises(KeyError):
            try:
                raise KeyError("consumer fault")
            finally:
                gen.close()
    return t, first.n


@pytest.mark.parametrize("how", ["break", "raise"])
def test_prefetcher_joins_its_parse_thread(corpora, how):
    """Leaving chunks_prefetched early by a break or an exception stops and
    joins the parse thread before the native reader closes; fifty such
    loops in a row do not crash the process."""
    if not fastx_native.native_ingest_supported(corpora["raw"]):
        pytest.fail("native FASTA ingest unavailable")
    for _ in range(50):
        t, n = _leave_early(corpora["raw"], how)
        assert n == 8
        assert not t.is_alive()
        assert not _pump_threads()


def test_prefetcher_break_and_raise_in_a_for_loop(corpora):
    """The same through real for-loops: a `break` after the first chunk,
    and an exception raised in the loop body."""
    for _ in range(50):
        for c in fastx_native.chunks_prefetched(corpora["raw"], 8, 1500):
            (t,) = _pump_threads()
            break
        t.join(timeout=10)  # the generator is closed when it is collected
        assert not t.is_alive()
        with pytest.raises(KeyError):
            for c in fastx_native.chunks_prefetched(corpora["raw"], 8, 1500):
                (t,) = _pump_threads()
                raise KeyError("consumer fault")
        t.join(timeout=10)
        assert not t.is_alive()


def test_prefetcher_full_pass_unchanged(corpora):
    """The normal end: every chunk in order, the same reads as the plain
    reader, and the thread gone once the sentinel is reached."""
    plain = fastx_native.NativeReader(corpora["raw"], 8, 1500)
    want = [(c.n, c.lengths.tolist(), bytes(c.raw)) for c in plain]
    plain.close()
    got = [(c.n, c.lengths.tolist(), bytes(c.raw))
           for c in fastx_native.chunks_prefetched(corpora["raw"], 8, 1500)]
    assert got == want and len(want) > 40
    assert not _pump_threads()
