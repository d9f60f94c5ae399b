"""The port's slice as a whole: chunked construction on the CPU against the
JAX package's `assemble_device_chunked`, plus the port's import and device
guards.

The corpus is generated here (synthetic raw reads with homopolymers, N runs
and ragged lengths), never read from an external example; the pre-HPC
corpus is the same reads with every homopolymer run collapsed.  The .gfa
must be byte-identical and the .sequences records equal.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rust_mdbg_tpu.cli import main as jax_cli_main
from rust_mdbg_tpu.core.chunked import assemble_device_chunked as jax_chunked
from rust_mdbg_tpu.io.sequences import iter_sequences
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch.cli import main as cli_main
from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
from rust_mdbg_tpu_torch.params import Params

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(k=7, l=12, density=0.01, min_kmer_abundance=2)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """~600 kbp of 1.5 kb reads over a 30 kb genome with 20% segmental
    duplications; a third of the reads are cut short and some carry N runs
    or an 'other' base."""
    d = tmp_path_factory.mktemp("corpus")
    raw = str(d / "raw.fa")
    write_synthetic_reads(raw, genome_mbp=0.03, coverage=20, read_len=1500,
                          error_rate=0.003, seed=11, repeat_frac=0.2)
    rng = np.random.default_rng(12)
    out = []
    with open(raw) as f:
        lines = f.read().split("\n")
    for name, seq in zip(lines[0::2], lines[1::2]):
        s = bytearray(seq.encode())
        if rng.random() < 0.33:
            s = s[: int(rng.integers(300, 1500))]
        if rng.random() < 0.1:
            j = int(rng.integers(0, len(s) - 4))
            s[j : j + 3] = b"NNN"
        if rng.random() < 0.05:
            s[int(rng.integers(0, len(s)))] = ord("R")
        out.append(f"{name}\n{s.decode()}\n")
    path = str(d / "reads.fa")
    with open(path, "w") as f:
        f.write("".join(out))
    return path


@pytest.fixture(scope="module")
def hpc_reads(reads, tmp_path_factory):
    """The corpus above with homopolymer runs collapsed: input for
    reads_already_hpc=True (recompute mode)."""
    path = str(tmp_path_factory.mktemp("hpc") / "hpc.fa")
    with open(reads) as f, open(path, "w") as out:
        for line in f:
            out.write(line if line.startswith(">")
                      else re.sub(r"(.)\1+", r"\1", line))
    return path


def _records(prefix):
    return sorted(json.dumps(r, sort_keys=True, default=str)
                  for r in iter_sequences(prefix))


@pytest.mark.parametrize("chunk_reads", [64, 256])
def test_chunked_matches_jax(tmp_path, reads, chunk_reads):
    pj = str(tmp_path / "jax")
    pt = str(tmp_path / "torch")
    sj = jax_chunked(reads, JaxParams(engine="device", **KW), pj,
                     chunk_reads=chunk_reads)
    st = assemble_device_chunked(reads, Params(**KW), pt,
                                 chunk_reads=chunk_reads, device="cpu")
    gj = open(pj + ".gfa", "rb").read()
    assert gj == open(pt + ".gfa", "rb").read()
    assert _records(pj) == _records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 100
    assert st["nb_edges"] == sj["nb_edges"] > 100
    assert st["nb_chunks"] == sj["nb_chunks"] > 1
    assert st["nb_windows"] == sj["nb_windows"]


#: how the recompute-mode run makes its edges: the device join, the host
#: join from the start, or a catalog too small for the run (424 nodes),
#: which spills to the host at the first or at a later chunk
JOINS = {"device": {}, "host": {"MDBG_CHUNK_DEVICE_JOIN": "0"},
         "spill_first": {"MDBG_CHUNK_CAT_CAP": "10"},
         "spill_later": {"MDBG_CHUNK_CAT_CAP": "300"}}


@pytest.fixture(scope="module")
def jax_hpc_runs(hpc_reads, tmp_path_factory):
    """The JAX package's pre-HPC runs (device join), one per chunk size."""
    out = {}
    for chunk_reads in (64, 256):
        pj = str(tmp_path_factory.mktemp(f"jax{chunk_reads}") / "jax")
        sj = jax_chunked(hpc_reads,
                         JaxParams(engine="device", reads_already_hpc=True,
                                   **KW), pj, chunk_reads=chunk_reads)
        out[chunk_reads] = (pj, sj)
    return out


@pytest.mark.parametrize("join", list(JOINS))
@pytest.mark.parametrize("chunk_reads", [64, 256])
def test_prehpc_chunked_matches_jax(tmp_path, monkeypatch, hpc_reads,
                                    jax_hpc_runs, chunk_reads, join):
    pj, sj = jax_hpc_runs[chunk_reads]
    for name, value in JOINS[join].items():
        monkeypatch.setenv(name, value)
    pt = str(tmp_path / "torch")
    st = assemble_device_chunked(hpc_reads,
                                 Params(reads_already_hpc=True, **KW), pt,
                                 chunk_reads=chunk_reads, device="cpu")
    assert open(pj + ".gfa", "rb").read() == open(pt + ".gfa", "rb").read()
    assert _records(pj) == _records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 100
    assert st["nb_edges"] == sj["nb_edges"] > 100
    assert st["nb_chunks"] == sj["nb_chunks"] > 1
    assert st["nb_windows"] == sj["nb_windows"]
    assert st["edge_join"] == ("device" if join == "device" else "host")
    if join == "device":
        assert st["catalog_rows"] == st["nb_nodes"]
        assert st["n_pot"] >= st["nb_edges"]


def test_prehpc_join_overflow_falls_back_to_host(tmp_path, monkeypatch,
                                                 hpc_reads, jax_hpc_runs):
    """A key group over G_SLOTS (forced here by shrinking the limit to one
    candidate) makes the device join report overflow; the run then joins
    on the host from the permuted catalog and writes the same file."""
    from rust_mdbg_tpu_torch.ops import edge_join

    monkeypatch.setattr(edge_join, "G_SLOTS", 1)
    pj, sj = jax_hpc_runs[256]
    pt = str(tmp_path / "torch")
    st = assemble_device_chunked(hpc_reads,
                                 Params(reads_already_hpc=True, **KW), pt,
                                 chunk_reads=256, device="cpu")
    assert st["edge_join"] == "host" and st["n_pot"] is None
    assert st["catalog_rows"] == st["nb_nodes"] == sj["nb_nodes"]
    assert open(pj + ".gfa", "rb").read() == open(pt + ".gfa", "rb").read()


def test_recompute_mode_equals_vector_mode_on_hpc_input(tmp_path, hpc_reads):
    """On reads with no homopolymer run left, HPC is the identity and an
    extent ends at pos + l, so the raw path (vector mode: k-vectors
    fetched, edges joined on the host from them) and the pre-HPC path
    (recompute mode) must write the same files."""
    a = assemble_device_chunked(hpc_reads, Params(**KW), str(tmp_path / "a"),
                                chunk_reads=256, device="cpu")
    b = assemble_device_chunked(hpc_reads,
                                Params(reads_already_hpc=True, **KW),
                                str(tmp_path / "b"), chunk_reads=256,
                                device="cpu")
    assert "edge_join" not in a and b["edge_join"] == "device"
    assert (tmp_path / "a.gfa").read_bytes() == (tmp_path / "b.gfa") \
        .read_bytes()
    assert _records(str(tmp_path / "a")) == _records(str(tmp_path / "b"))


def test_clipped_extent_correction_raises(tmp_path):
    """A homopolymer run of 70 kb inside a crossing window's last l-mer
    puts its exact-cut correction outside 16 bits: the port's run raises,
    naming the count, where the JAX package clips silently."""
    rng = np.random.default_rng(21)

    def rnd(n):
        return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])

    path = tmp_path / "hp.fa"
    path.write_text(f">r0\n{rnd(600)}{'A' * 70_000}{rnd(600)}\n"
                    f">r1\n{rnd(1500)}\n")
    p = Params(k=7, l=12, density=0.2, min_kmer_abundance=1)
    with pytest.raises(RuntimeError, match=r"\d+ crossing windows .* 16 bits"):
        assemble_device_chunked(str(path), p, str(tmp_path / "hp"),
                                chunk_reads=2, device="cpu")


def test_cli_runs_the_slice(tmp_path, reads):
    p = str(tmp_path / "cli")
    q = str(tmp_path / "fn")
    assert cli_main([reads, "-k", "7", "-l", "12", "-d", "0.01",
                     "--minabund", "2", "--prefix", p, "--device", "cpu",
                     "--chunk-reads", "128"]) == 0
    assemble_device_chunked(reads, Params(**KW), q, chunk_reads=128,
                            device="cpu")
    assert open(p + ".gfa", "rb").read() == open(q + ".gfa", "rb").read()


def test_cli_skiphpc(tmp_path, hpc_reads):
    p = str(tmp_path / "cli")
    q = str(tmp_path / "fn")
    assert cli_main([hpc_reads, "-k", "7", "-l", "12", "-d", "0.01",
                     "--minabund", "2", "--prefix", p, "--device", "cpu",
                     "--chunk-reads", "128", "--skiphpc"]) == 0
    st = assemble_device_chunked(hpc_reads,
                                 Params(reads_already_hpc=True, **KW), q,
                                 chunk_reads=128, device="cpu")
    assert st["edge_join"] == "device"
    assert open(p + ".gfa", "rb").read() == open(q + ".gfa", "rb").read()
    assert _records(p) == _records(q)


@pytest.mark.parametrize("flag", [["--mesh", "4"], ["--error-correct"],
                                  ["--multihost"],
                                  ["--restart-from-postcor"]])
def test_cli_rejects_unported_paths(tmp_path, reads, flag):
    """No path of these flags is refused any more.  --mesh 4 writes the
    JAX CLI's --mesh 4 .gfa bytes and records; --multihost with no process
    group runs this process alone, one shard on the CPU, which is the JAX
    CLI's --mesh 1.  --error-correct runs and writes the JAX CLI's bytes
    (.ec_data, .postcor.ec_data, .poa.ec_data, .gfa, .sequences);
    --restart-from-postcor then rebuilds the same graph from the corrected
    reads alone, as the JAX CLI does."""
    if flag[0] in ("--mesh", "--multihost"):
        base = [reads, "-k", "7", "-l", "12", "-d", "0.01"]
        pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
        jflag = ["--mesh", "1"] if flag == ["--multihost"] else flag
        assert jax_cli_main(base + jflag + ["--prefix", pj]) == 0
        assert cli_main(base + flag + ["--device", "cpu",
                                       "--prefix", pt]) == 0
        assert open(pj + ".gfa", "rb").read() == open(pt + ".gfa",
                                                      "rb").read()
        assert _records(pj) == _records(pt) and _records(pt)
        return
    base = [reads, "-k", "7", "-l", "12", "-d", "0.01", "--error-correct"]
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli_main(base + ["--engine", "host", "--prefix", pj]) == 0
    assert cli_main(base + ["--device", "cpu", "--prefix", pt]) == 0
    exts = [".ec_data", ".postcor.ec_data", ".poa.ec_data", ".gfa"]
    if flag == ["--restart-from-postcor"]:
        for p in (pj, pt):
            os.remove(p + ".gfa")
        assert jax_cli_main(base + flag + ["--prefix", pj]) == 0
        assert cli_main(base + flag + ["--prefix", pt]) == 0
    for ext in exts:
        assert open(pj + ext, "rb").read() == open(pt + ext, "rb").read()
    assert _records(pj) == _records(pt) and _records(pt)


@pytest.mark.parametrize("tool", ["to-basespace", "magic-simplify", "multik",
                                  "gfa-asm", "gfa2fasta", "ec-scale",
                                  "quality-n50"])
def test_cli_rejects_tool_subcommands(tmp_path, reads, monkeypatch, tool):
    """Every tool subcommand of the JAX package runs (the name is from the
    slices that refused some): the assembly tools on a tiny assembly of
    `reads`, ec-scale on a genome of its own, and quality-n50 with its
    error-free leg at 1 Mbp x 4, whose record equals the JAX CLI's, the
    leg's seconds, the RSS and the device aside."""
    if tool == "ec-scale":
        out = tmp_path / "ec.json"
        assert cli_main([tool, "--genome-mbp", "0.005", "--coverage", "6",
                         "--read-len", "1500", "--device", "cpu",
                         "--workdir", str(tmp_path), "--out",
                         str(out)]) == 0
        assert '"ec_after_identity"' in out.read_text()
        return
    if tool == "quality-n50":
        recs = {}
        monkeypatch.setattr("sys.argv", ["pytest"])  # the JAX dispatch sets it
        for side, main, extra in (("jax", jax_cli_main, []),
                                  ("port", cli_main, ["--device", "cpu"])):
            out = tmp_path / f"{side}.json"
            main([tool, "--genome-mbp", "1", "--coverage", "4", "--errs",
                  "0", "--workdir", str(tmp_path / side), "--out", str(out)]
                 + extra)
            recs[side] = json.loads(out.read_text())
        for rec in recs.values():
            for leg in rec["legs"]:
                for key in ("synth_s", "asm_s", "msimpl_s"):
                    leg.pop(key)
            del rec["max_rss_gb"]
        assert recs["port"].pop("device") == "cpu"
        assert recs["port"].pop("card") is None
        assert recs["port"] == recs["jax"]
        assert recs["port"]["legs"][0]["n_contigs"] > 0
        return
    monkeypatch.chdir(tmp_path)
    assert cli_main([reads, "-k", "7", "-l", "12", "-d", "0.01",
                     "--device", "cpu", "--prefix", "a"]) == 0
    argv, made = {
        "to-basespace": (["-g", "a.gfa", "-s", "a"], "a.gfa.complete.gfa"),
        "magic-simplify": (["a"], "a.msimpl.fa"),
        "multik": ([reads, "m", "--device", "cpu"], "m-final.msimpl.fa"),
        "gfa-asm": (["a.gfa", "-u", "-o", "u.gfa"], "u.gfa"),
        "gfa2fasta": (["a"], "a.fa"),
    }[tool]
    assert cli_main([tool] + argv) == 0
    assert os.path.getsize(made) > 0


def test_unported_params_raise(tmp_path, reads):
    # ported, but the streaming engine's: the device drivers refuse them
    for kw in (dict(error_correct=True), dict(reference=True),
               dict(uhs=True), dict(lcp=True), dict(has_lmer_counts=True)):
        with pytest.raises(ValueError, match="streaming engine"):
            assemble_device_chunked(reads, Params(**{**KW, **kw}),
                                    str(tmp_path / "x"), device="cpu")
    # --bf and --minabund > 16 are ported: the first runs here (the Bloom
    # is the host merge's), the second is the whole-run path's and the
    # chunked driver refuses it by the JAX package's own gate
    st = assemble_device_chunked(reads, Params(**{**KW, "use_bf": True,
                                                  "bloom_log2_bits": 24}),
                                 str(tmp_path / "bf"), device="cpu")
    assert st["nb_nodes"] > 100
    with pytest.raises(RuntimeError, match="occurrence slots"):
        assemble_device_chunked(reads,
                                Params(**{**KW, "min_kmer_abundance": 17}),
                                str(tmp_path / "x"), device="cpu")


def test_import_pulls_in_no_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package."""
    code = (
        "import importlib, pathlib, sys\n"
        "root = pathlib.Path('rust_mdbg_tpu_torch')\n"
        "for f in sorted(root.rglob('*.py')):\n"
        "    importlib.import_module('.'.join(f.with_suffix('').parts))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rust_mdbg_tpu' or m.startswith('rust_mdbg_tpu.')]\n"
        "assert 'rust_mdbg_tpu_torch.core.chunked' in sys.modules\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_device_without_cuda_raises(tmp_path, reads, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assemble_device_chunked(reads, Params(**KW), str(tmp_path / "x"))


#: syncmers stay on the device drivers, in vector mode whatever the input
#: (minimizer_recompute_ok is false for them): raw reads with the extent
#: plane, pre-HPC'd reads without it (the column is the position)
SYNC = dict(k=5, l=10, density=0.1, min_kmer_abundance=2, use_syncmers=True)


@pytest.mark.parametrize("kind,s,chunk_reads", [
    ("raw", 4, 64), ("raw", 4, 256), ("hpc", 4, 64), ("hpc", 4, 256),
    ("raw", 9, 128), ("hpc", 0, 128)])
def test_syncmers_chunked_matches_jax(tmp_path, reads, hpc_reads, kind, s,
                                      chunk_reads):
    path = reads if kind == "raw" else hpc_reads
    kw = dict(SYNC, s=s, reads_already_hpc=kind == "hpc",
              density=0.02 if s == 0 else 0.1)
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_chunked(path, JaxParams(engine="device", **kw), pj,
                     chunk_reads=chunk_reads)
    st = assemble_device_chunked(path, Params(**kw), pt,
                                 chunk_reads=chunk_reads, device="cpu")
    assert open(pj + ".gfa", "rb").read() == open(pt + ".gfa", "rb").read()
    assert _records(pj) == _records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 50
    assert st["nb_edges"] == sj["nb_edges"] > 50
    assert st["nb_windows"] == sj["nb_windows"]
    assert "edge_join" not in st  # vector mode: no catalog, no device join


def test_syncmers_plan_uses_the_syncmer_rate(reads):
    """M and W_slot are sized by the syncmer selection rate (below the
    density), not by twice the density."""
    from rust_mdbg_tpu.ops.extract import DeviceExtractor
    from rust_mdbg_tpu.ops.sort_count import window_slot_capacity as wsc_jax
    from rust_mdbg_tpu_torch.core.chunked import plan_chunks

    plan = plan_chunks(reads, Params(**SYNC), 128)
    dens = plan_chunks(reads, Params(**dict(SYNC, use_syncmers=False)), 128)
    pj = JaxParams(**SYNC)
    assert plan["M"] == DeviceExtractor(pj).capacity(plan["L"]) < dens["M"]
    assert plan["w_slot"] == wsc_jax(pj, plan["B"], plan["L"], plan["M"]) \
        < dens["w_slot"]


@pytest.mark.parametrize("kind", ["raw", "hpc"])
def test_seq_ref_cuts_chunked_matches_jax(tmp_path, reads, hpc_reads, kind):
    """Reference cuts (record spans end at pos + l, no extent plane) through
    the chunked driver, on raw reads and in recompute mode."""
    path = reads if kind == "raw" else hpc_reads
    kw = dict(KW, seq_ref_cuts=True, reads_already_hpc=kind == "hpc")
    pj, pt, pe = (str(tmp_path / x) for x in ("jax", "torch", "exact"))
    jax_chunked(path, JaxParams(engine="device", **kw), pj, chunk_reads=128)
    assemble_device_chunked(path, Params(**kw), pt, chunk_reads=128,
                            device="cpu")
    assert open(pj + ".gfa", "rb").read() == open(pt + ".gfa", "rb").read()
    assert _records(pj) == _records(pt)
    # on raw reads the cuts differ from the default exact-extent records
    assemble_device_chunked(path, Params(**dict(kw, seq_ref_cuts=False)), pe,
                            chunk_reads=128, device="cpu")
    assert (_records(pe) != _records(pt)) == (kind == "raw")
