"""The port's whole-run slice on the CPU against the JAX package:
`assemble_device_table` and the `assemble` dispatcher on generated FASTA
(.gfa bytes and .sequences records equal), the routing between the two
device drivers, the CLI flags that came with the slice, and the device
guard."""

import numpy as np
import pytest
import torch

from rust_mdbg_tpu.core.pipeline import assemble as jax_assemble
from rust_mdbg_tpu.core.pipeline import assemble_device_table as jax_table
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu.utils.timing import PhaseTimer
from rust_mdbg_tpu_torch.cli import main as cli_main
from rust_mdbg_tpu_torch.core import pipeline
from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
from rust_mdbg_tpu_torch.core.pipeline import assemble, assemble_device_table
from rust_mdbg_tpu_torch.params import Params

from torch_corpus import gfa_bytes, records, write_hpc_reads, write_raw_reads

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

#: 400 reads in batches of 4: seven chunks of 16 batches, phase 1 after the
#: fourth
KW = dict(k=7, l=12, density=0.01, min_kmer_abundance=2, batch_reads=4)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("whole_corpus")
    raw = write_raw_reads(str(d / "raw.fa"))
    # 100x over 8 kb, so that about a hundred keys reach 17 sightings
    deep = write_raw_reads(str(d / "deep.fa"), genome_mbp=0.008,
                           coverage=100, error_rate=0.001, seed=31)
    many = write_hpc_reads(write_raw_reads(str(d / "many.fa"), coverage=70,
                                           seed=41), str(d / "many_hpc.fa"))
    top = str(d / "top_heavy_hpc.fa")
    with open(many) as f, open(top, "w") as out:
        for i, line in enumerate(f):
            out.write(line if i < 200 or line.startswith(">")
                      else line[:600].rstrip("\n") + "\n")
    return dict(raw=raw, hpc=write_hpc_reads(raw, str(d / "hpc.fa")),
                top_heavy_hpc=top,
                deep=deep,
                deep_hpc=write_hpc_reads(deep, str(d / "deep_hpc.fa")))


def _graph_signature(prefix):
    """(LN, KC) multiset and edge count: the id-free comparison the JAX
    package makes between its chunked and whole-run paths."""
    nodes, edges = [], 0
    with open(prefix + ".gfa") as f:
        for line in f:
            if line.startswith("S"):
                v = line.split("\t")
                nodes.append((v[3], v[4].strip()))
            elif line.startswith("L"):
                edges += 1
    return sorted(nodes), edges


@pytest.mark.parametrize("kind,minab", [("raw", 2), ("hpc", 2), ("raw", 3),
                                        ("hpc", 1), ("deep_hpc", 17)])
def test_table_matches_jax(tmp_path, corpora, kind, minab):
    hpc = kind.endswith("hpc")
    kw = {**KW, "min_kmer_abundance": minab, "reads_already_hpc": hpc}
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_table(corpora[kind], JaxParams(engine="device", **kw), pj,
                   PhaseTimer(), {})
    st = assemble_device_table(corpora[kind], Params(**kw), pt, device="cpu")
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 50
    assert st["nb_edges"] == sj["nb_edges"] > 50
    assert st["nb_reads"] == sj["nb_reads"]
    assert st["nb_windows"] == sj["nb_windows"]
    assert st["nb_chunks"] >= 5 and st["replans"] == 0
    # recompute mode emits in two phases and joins on the device
    assert (st["phase1_nodes"] > 0) == hpc
    assert st.get("edge_join") == ("device" if hpc else None)


def test_table_grows_its_buffers(tmp_path, corpora, monkeypatch):
    """1,400 reads of which only the first hundred (the sampled ones) are
    long, so the read-cap estimate is too low: phase 1 starts after four
    chunks of 256 reads and the fifth makes the counter grow while the
    helper thread may still read the old planes."""
    from rust_mdbg_tpu_torch.ops.sort_count import DeviceNodeCounter

    caps = []
    grow = DeviceNodeCounter.grow

    def spy(self, min_read_cap):
        before = self.read_cap
        grow(self, min_read_cap)
        caps.append((before, self.read_cap))

    monkeypatch.setattr(DeviceNodeCounter, "grow", spy)
    p = Params(**dict(KW, batch_reads=16, reads_already_hpc=True))
    pa, pb = str(tmp_path / "whole"), str(tmp_path / "chunk")
    st = assemble_device_table(corpora["top_heavy_hpc"], p, pa, device="cpu")
    assert st["nb_reads"] == 1400
    assert len(caps) == 1 and caps[0][0] < 1400 < caps[0][1] == st["read_cap"]
    assert 0 < st["phase1_nodes"] < st["nb_nodes"]
    assemble_device_chunked(corpora["top_heavy_hpc"], p, pb, chunk_reads=512,
                            device="cpu")
    assert gfa_bytes(pa) == gfa_bytes(pb)
    assert records(pa) == records(pb)


@pytest.mark.parametrize("kind", ["raw", "hpc"])
def test_table_matches_chunked(tmp_path, corpora, kind):
    """Whole run = chunked: the same node multiset and edge count, and
    (ids follow crossing order on both) the same bytes."""
    p = Params(**{**KW, "reads_already_hpc": kind == "hpc"})
    pa, pb = str(tmp_path / "whole"), str(tmp_path / "chunk")
    assemble_device_table(corpora[kind], p, pa, device="cpu")
    s = assemble_device_chunked(corpora[kind], p, pb, chunk_reads=96,
                                device="cpu")
    assert s["nb_chunks"] >= 3
    assert _graph_signature(pa) == _graph_signature(pb)
    assert gfa_bytes(pa) == gfa_bytes(pb)
    assert records(pa) == records(pb)


@pytest.mark.parametrize("kind", ["deep", "deep_hpc"])
def test_assemble_minabund_17_routes_to_table(tmp_path, corpora, kind):
    """--minabund 17 is past the chunk slots: `assemble` takes the whole-run
    path, as the JAX dispatcher does, and writes the same files."""
    kw = dict(KW, min_kmer_abundance=17, batch_reads=8,
              reads_already_hpc=kind == "deep_hpc")
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_assemble(corpora[kind], JaxParams(engine="device", **kw), pj)
    st = assemble(corpora[kind], Params(**kw), pt, device="cpu")
    assert "phase1_nodes" in st and "catalog_rows" not in st
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 50
    assert st["nb_edges"] == sj["nb_edges"] > 50
    # every chunk staged from the parser's planes, as the chunked driver's
    c = st["counters"]
    assert c["feed.parser_packed_chunks"] == st["nb_chunks"] > 1
    assert c["feed.host_packed_chunks"] == 0
    assert c["feed.staged_high"] == 1


def test_assemble_minabund_2_routes_to_chunked(tmp_path, corpora):
    kw = dict(KW, batch_reads=64, chunk_reads=128)
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_assemble(corpora["raw"], JaxParams(engine="device", **kw), pj)
    st = assemble(corpora["raw"], Params(**kw), pt, device="cpu")
    assert st["nb_chunks"] >= 3 and "h2d_bytes" in st
    assert "phase1_nodes" not in st
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)


def test_over_budget_routes_to_chunked_or_raises(tmp_path, corpora):
    """An input whose buffers would pass the budget goes to the chunked
    driver when that can take it; past the chunk slots no device driver
    can, and the run goes to the streaming engine on the same device (it
    no longer raises, and it does not drop to the host engine)."""
    p = Params(**dict(KW, batch_reads=64))
    st = assemble_device_table(corpora["raw"], p, str(tmp_path / "a"),
                               device="cpu", mem_budget=100_000)
    assert "h2d_bytes" in st and "phase1_nodes" not in st
    assemble_device_chunked(corpora["raw"], p, str(tmp_path / "b"),
                            device="cpu")
    assert gfa_bytes(str(tmp_path / "a")) == gfa_bytes(str(tmp_path / "b"))
    p17 = p.replace(min_kmer_abundance=17)
    st = assemble(corpora["raw"], p17, str(tmp_path / "c"), device="cpu",
                  mem_budget=100_000)
    assert st["route"] == "streaming (over whole-run budget)"
    assert "host_rows" in st and st["replans"] == 0
    assemble_device_table(corpora["raw"], p17, str(tmp_path / "e"),
                          device="cpu")
    assert gfa_bytes(str(tmp_path / "c")) == gfa_bytes(str(tmp_path / "e"))
    assert records(str(tmp_path / "c")) == records(str(tmp_path / "e"))
    fits = assemble_device_table(corpora["raw"], p, str(tmp_path / "d"),
                                 device="cpu")
    assert fits["mem_budget"] == pipeline.CPU_MEM_BUDGET
    assert fits["read_cap"] * (24 * fits["w_slot"]) < fits["mem_budget"]


def test_chunked_minabund_gate(tmp_path, corpora):
    """The chunked driver refuses what is not chunked_eligible."""
    with pytest.raises(RuntimeError, match="occurrence slots"):
        assemble_device_chunked(corpora["raw"],
                                Params(**dict(KW, min_kmer_abundance=17)),
                                str(tmp_path / "x"), device="cpu")


@pytest.mark.parametrize("flags,kind", [
    (["--bf", "--bf-bits", "24"], "raw"),
    (["--bf", "--bf-bits", "24", "--skiphpc"], "hpc"),
    (["--minabund", "17"], "deep"),
    (["--minabund", "17", "--bf", "--bf-bits", "24", "--skiphpc"],
     "deep_hpc")])
def test_cli_runs_bf_and_minabund_17(tmp_path, corpora, flags, kind):
    p, q = str(tmp_path / "cli"), str(tmp_path / "fn")
    assert cli_main([corpora[kind], "-k", "7", "-l", "12", "-d", "0.01",
                     "--prefix", p, "--device", "cpu", "--batch-reads", "8"]
                    + flags) == 0
    minab = 17 if "--minabund" in flags else 2
    st = assemble(corpora[kind],
                  Params(k=7, l=12, density=0.01, min_kmer_abundance=minab,
                         batch_reads=8, use_bf="--bf" in flags,
                         bloom_log2_bits=24,
                         reads_already_hpc="--skiphpc" in flags),
                  q, device="cpu")
    assert ("phase1_nodes" in st) == (minab == 17)
    assert st["nb_nodes"] > 50
    assert gfa_bytes(p) == gfa_bytes(q)
    assert records(p) == records(q)


@pytest.mark.parametrize("kw,what", [
    (dict(reference=True), "streaming engine"),
    (dict(uhs=True), "streaming engine"),
    (dict(error_correct=True), "streaming engine")])
def test_assemble_rejects_unported_paths(tmp_path, corpora, kw, what):
    """The streaming engine's paths, error correction among them, are
    refused by the whole-run driver when it is called directly; `assemble`
    routes error correction to the streaming engine, which writes the JAX
    package's bytes."""
    with pytest.raises(ValueError, match=what):
        assemble_device_table(corpora["raw"], Params(**{**KW, **kw}),
                              str(tmp_path / "x"), device="cpu")
    if "error_correct" in kw:
        pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
        jax_assemble(corpora["raw"],
                     JaxParams(**{**KW, **kw, "engine": "host"}), pj)
        st = assemble(corpora["raw"], Params(**{**KW, **kw}), pt,
                      device="cpu")
        for ext in (".ec_data", ".postcor.ec_data", ".poa.ec_data"):
            assert open(pj + ext, "rb").read() == open(pt + ext, "rb").read()
        assert gfa_bytes(pj) == gfa_bytes(pt)
        assert records(pj) == records(pt)
        assert st["nb_nodes"] > 0 and "reingest" in st["phases"]


def test_read_stats_is_not_ported(tmp_path, corpora):
    """The name is from the slice before the streaming engine: --read-stats
    now runs, writes <file>.read_stats beside its (copied) input and
    returns without a GFA."""
    import shutil

    rs = str(tmp_path / "copy.fa")
    shutil.copy(corpora["raw"], rs)
    st = assemble(corpora["raw"], Params(**dict(KW, batch_reads=64)),
                  str(tmp_path / "x"), read_stats_path=rs, device="cpu")
    assert "nb_nodes" not in st and not (tmp_path / "x.gfa").exists()
    lines = open(rs + ".read_stats").read().splitlines()
    assert len(lines) == st["nb_reads"] == 400
    assert all(": " in ln or ln.endswith(":") for ln in lines)


#: syncmers on the whole-run path (vector mode): raw reads and pre-HPC'd
SYNC = dict(k=5, l=10, density=0.1, use_syncmers=True, s=4, batch_reads=8)


@pytest.mark.parametrize("kind,minab", [("deep", 17), ("deep_hpc", 17),
                                        ("raw", 2)])
def test_syncmers_table_matches_jax(tmp_path, corpora, kind, minab):
    kw = dict(SYNC, min_kmer_abundance=minab,
              reads_already_hpc=kind.endswith("hpc"))
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_table(corpora[kind], JaxParams(engine="device", **kw), pj,
                   PhaseTimer(), {})
    st = assemble_device_table(corpora[kind], Params(**kw), pt, device="cpu")
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 20
    assert st["nb_edges"] == sj["nb_edges"] > 20
    assert st["nb_windows"] == sj["nb_windows"]
    # never recompute mode: one shot, the host join
    assert st["phase1_nodes"] == 0 and st.get("edge_join") is None


def test_assemble_routes_syncmers_to_the_device_drivers(tmp_path, corpora):
    """`assemble` under --syncmers: the chunked driver at minabund 2, the
    whole run at 17, the same files as the JAX dispatcher."""
    for minab, kind, key in ((2, "raw", "nb_chunks"),
                             (17, "deep", "phase1_nodes")):
        kw = dict(SYNC, min_kmer_abundance=minab, chunk_reads=128)
        pj, pt = str(tmp_path / f"jax{minab}"), str(tmp_path / f"t{minab}")
        jax_assemble(corpora[kind], JaxParams(engine="device", **kw), pj)
        st = assemble(corpora[kind], Params(**kw), pt, device="cpu")
        assert key in st and st["nb_nodes"] > 20
        assert gfa_bytes(pj) == gfa_bytes(pt)
        assert records(pj) == records(pt)


@pytest.mark.parametrize("fn", [assemble, assemble_device_table])
def test_no_device_without_cuda_raises(tmp_path, corpora, monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(corpora["raw"], Params(**KW), str(tmp_path / "x"))
    assert not (tmp_path / "x.gfa").exists()


def test_overflow_aborts(tmp_path, corpora):
    """A read with more minimizers than the compacted rows hold no longer
    aborts the whole run: it restarts at doubled slots, drops no window,
    and writes what the run without the cap writes."""
    st = assemble_device_table(
        corpora["raw"], Params(**dict(KW, max_minimizers_per_read=12)),
        str(tmp_path / "x"), device="cpu")
    assert st["replans"] >= 1
    ref = assemble_device_table(corpora["raw"], Params(**KW),
                                str(tmp_path / "y"), device="cpu")
    assert ref["replans"] == 0 and st["nb_windows"] == ref["nb_windows"]
    assert gfa_bytes(str(tmp_path / "x")) == gfa_bytes(str(tmp_path / "y"))
    assert records(str(tmp_path / "x")) == records(str(tmp_path / "y"))
