"""The tool subcommands of the port (tools/, eval/retrace_minimizers,
native/gfa_asm.cpp) against the JAX package's, on the CPU.  Tolerance:
exact equality throughout (file bytes, op statistics).

Graphs are built in the tests; reads come from the port's
experiments/synth.  The stand-in for the reference's example corpus
(error-free 23 kb substrings of a 0.1 Mbp region at ~150x, 657 reads) is a
seeded random 0.1 Mbp genome read the same way, assembled at the
example's Params by both packages."""

import os
import random
import re
import shutil
import types
from pathlib import Path

import pytest
import torch

import rust_mdbg_tpu.cli as jax_cli
import rust_mdbg_tpu.core.pipeline as jax_pipeline
import rust_mdbg_tpu.tools.gfa as jax_gfa
import rust_mdbg_tpu.tools.gfa_asm as jax_gfa_asm
import rust_mdbg_tpu.tools.magic_simplify as jax_ms
import rust_mdbg_tpu.tools.multik as jax_multik
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch import cli
from rust_mdbg_tpu_torch.core import pipeline
from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads
from rust_mdbg_tpu_torch.io.fastx import read_records
from rust_mdbg_tpu_torch.params import Params
from rust_mdbg_tpu_torch.tools import gfa, gfa_asm, magic_simplify, multik
from rust_mdbg_tpu_torch.tools.gfa_break_loops import break_loops
from rust_mdbg_tpu_torch.tools.to_basespace import to_basespace
from rust_mdbg_tpu_torch.utils.seq import revcomp

from test_gfa_asm_native import SCHEDULES, _bubble_chain_gfa, _random_gfa

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

PORT = types.SimpleNamespace(Gfa=gfa.Gfa, Segment=gfa.Segment,
                             cut_tips=gfa_asm.cut_tips,
                             pop_bubbles=gfa_asm.pop_bubbles,
                             unitigs=gfa_asm.unitigs)
JAX = types.SimpleNamespace(Gfa=jax_gfa.Gfa, Segment=jax_gfa.Segment,
                            cut_tips=jax_gfa_asm.cut_tips,
                            pop_bubbles=jax_gfa_asm.pop_bubbles,
                            unitigs=jax_gfa_asm.unitigs)


# --- gfa_asm, the Python engine: the synthetic cases of test_gfa_asm.py ----

def _mkgfa(m, segs, links):
    g = m.Gfa()
    for name, ln, kc in segs:
        tags = [f"KC:i:{kc}"] if kc is not None else []
        g.segments[name] = m.Segment(name, None, ln, tags)
    g.links = list(links)
    return g


def _path_graph(m, n, ln=1000, ov=100):
    return _mkgfa(m, [(f"s{i}", ln, 10) for i in range(n)],
                  [(f"s{i}", "+", f"s{i+1}", "+", ov) for i in range(n - 1)])


_BUBBLE = ([("s0", 1000, 100), ("b1", 800, 50), ("b2", 800, 2),
            ("s3", 1000, 100)],
           [("s0", "+", "b1", "+", 10), ("s0", "+", "b2", "+", 10),
            ("b1", "+", "s3", "+", 10), ("b2", "+", "s3", "+", 10)])


def _tip_short(m):
    g = _path_graph(m, 5)
    g.segments["t0"] = m.Segment("t0", None, 500, [])
    g.links.append(("t0", "+", "s2", "+", 100))
    n = m.cut_tips(g, max_ext=10, max_bp=50000)
    assert n == 1 and "t0" not in g.segments and len(g.segments) == 5
    return n, g


def _tip_long(m):
    g = _path_graph(m, 5)
    g.segments["t0"] = m.Segment("t0", None, 90000, [])
    g.links.append(("t0", "+", "s2", "+", 100))
    n = m.cut_tips(g, 10, 50000)
    assert n == 2 and "t0" in g.segments and "s0" not in g.segments
    return n, g


def _tip_isolated(m):
    g = _path_graph(m, 3)
    n = m.cut_tips(g, 10, 50000)
    assert n == 0 and len(g.segments) == 3
    return n, g


def _tip_multi(m):
    g = _path_graph(m, 5)
    g.segments["t0"] = m.Segment("t0", None, 300, [])
    g.segments["t1"] = m.Segment("t1", None, 300, [])
    g.links += [("t0", "+", "t1", "+", 50), ("t1", "+", "s2", "+", 50)]
    n = m.cut_tips(g, 10, 50000)
    assert n == 2 and "t0" not in g.segments and "t1" not in g.segments
    return n, g


def _bubble_pop(m):
    g = _mkgfa(m, *_BUBBLE)
    n = m.pop_bubbles(g, max_dist=100000)
    assert n == 1 and "b2" not in g.segments and "b1" in g.segments
    return n, g


def _bubble_radius(m):
    g = _mkgfa(m, *_BUBBLE)
    n = m.pop_bubbles(g, max_dist=100)
    assert n == 0 and len(g.segments) == 4
    return n, g


def _unitig_linear(m):
    u = m.unitigs(_path_graph(m, 4, ln=1000, ov=100))
    (name, seg), = u.segments.items()
    assert name.startswith("utg") and name.endswith("l")
    assert seg.length == 3700 and not u.links
    assert [a[1] for a in u.a_lines] == [0, 900, 1800, 2700]
    return len(u.segments), u


def _unitig_branches(m):
    g = _mkgfa(m, [("s0", 100, 1), ("s1", 100, 1), ("s2", 100, 1),
                   ("s3", 100, 1)],
               [("s0", "+", "s1", "+", 10), ("s3", "+", "s1", "+", 10),
                ("s1", "+", "s2", "+", 10)])
    u = m.unitigs(g)
    assert sorted(s.length for s in u.segments.values()) == [100, 100, 190]
    assert len(u.links) == 2
    return len(u.segments), u


def _unitig_orientation(m):
    g = m.Gfa()
    g.segments["a"] = m.Segment("a", "AACCGGTT", 8, [])
    g.segments["b"] = m.Segment("b", "CCGG", 4, [])
    g.links = [("a", "+", "b", "-", 2)]
    u = m.unitigs(g)
    (seg,) = u.segments.values()
    assert seg.seq == "AACCGGTTGG"
    return len(u.segments), u


def _aline_composition(m):
    """Two unitig rounds compose A-lines back to the original segments."""
    g = m.Gfa()
    for name, seq in (("a", "ACGTACGT"), ("b", "GTACCCC"), ("c", "CCCTTT")):
        g.segments[name] = m.Segment(name, seq, len(seq), [])
    g.links += [("a", "+", "b", "+", 2), ("b", "+", "c", "+", 3)]
    u1 = m.unitigs(g)
    u2 = m.unitigs(u1)
    (utg,), (utg2,) = u1.segments.values(), u2.segments.values()
    assert utg2.seq == utg.seq
    a1 = sorted((a[3], int(a[1]), a[2]) for a in u1.a_lines)
    a2 = sorted((a[3], int(a[1]), a[2]) for a in u2.a_lines)
    assert a1 == a2 == [("a", 0, "+"), ("b", 6, "+"), ("c", 10, "+")]
    return len(u2.segments), u2


PY_CASES = [_tip_short, _tip_long, _tip_isolated, _tip_multi, _bubble_pop,
            _bubble_radius, _unitig_linear, _unitig_branches,
            _unitig_orientation, _aline_composition]


@pytest.mark.parametrize("case", PY_CASES, ids=lambda c: c.__name__[1:])
def test_python_engine_matches_jax(tmp_path, case):
    """Each case holds its own assertions in both packages, and the port's
    count and written graph equal the JAX package's."""
    out = {}
    for side, m in (("port", PORT), ("jax", JAX)):
        n, g = case(m)
        g.write(str(tmp_path / f"{side}.gfa"))
        out[side] = (n, (tmp_path / f"{side}.gfa").read_bytes())
    assert out["port"] == out["jax"]


# --- gfa_asm, the native engine: the synthetic cases of test_gfa_asm_native --

_SMALL_GFAS = {
    "crlf": "H\tVN:Z:1.0\r\nS\ta\tACGT\r\nS\tb\tGTTT\r\n"
            "L\ta\t+\tb\t+\t2M\r\n",
    "aline_extra": "H\tVN:Z:1.0\nS\ta\t*\tLN:i:100\n"
                   "A\ta\t0\t+\torig1\t0\t100\tXT:i:5\n",
    "revcomp_unusual": "H\tVN:Z:1.0\nS\ta\tACGTACG\nS\tb\tTTnU\n"
                       "L\ta\t+\tb\t-\t1M\n",
    "star_cigar": "H\tVN:Z:1.0\nS\ta\tACGT\nS\tb\tGTTT\nL\ta\t+\tb\t+\t*\n",
    "circular": "H\tVN:Z:1.0\nS\ta\t*\tLN:i:100\nS\tb\t*\tLN:i:100\n"
                "S\tc\t*\tLN:i:100\nL\ta\t+\tb\t+\t10M\n"
                "L\tb\t+\tc\t+\t10M\nL\tc\t+\ta\t+\t10M\n",
    "chain": "H\tVN:Z:1.0\nS\ta\tACGTACGT\nS\tb\tGTACCCC\nS\tc\tCCCTTT\n"
             "L\ta\t+\tb\t+\t2M\nL\tb\t+\tc\t+\t3M\n",
}


def _graph_text(case: str) -> str:
    kind, _, seed = case.partition("-")
    if kind == "random":
        rng = random.Random(int(seed))
        return _random_gfa(rng, n_seg=rng.randrange(5, 60),
                           n_link=rng.randrange(5, 120),
                           with_seq=int(seed) % 2 == 0,
                           with_alines=int(seed) % 3 == 0)
    if kind == "bubbles":
        return _bubble_chain_gfa(random.Random(1000 + int(seed)), n_bub=12)
    return _SMALL_GFAS[kind]


#: every schedule applies to these; A-lines with extra fields take no
#: unitig round (test_native_engine_keeps_aline_extra_fields)
NATIVE_CASES = ([f"random-{s}" for s in range(6)]
                + [f"bubbles-{s}" for s in range(4)]
                + [c for c in _SMALL_GFAS if c != "aline_extra"])


def _run_engines(src, ops, tag):
    """{engine: (stats, bytes)} for the port's native and Python engines
    and the JAX package's native engine on one schedule."""
    out = {}
    for name, run, eng in (("port-native", gfa_asm.run_ops_file, "native"),
                           ("port-python", gfa_asm.run_ops_file, "python"),
                           ("jax-native", jax_gfa_asm.run_ops_file,
                            "native")):
        dst = src.with_name(f"{tag}.{name}.gfa")
        stats = run(str(src), ops, str(dst), engine=eng)
        out[name] = (stats, dst.read_bytes())
    return out


def test_native_engine_is_chosen():
    assert gfa_asm.engine_choice() == "native"


@pytest.mark.parametrize("case", NATIVE_CASES)
def test_native_engine_matches_python_and_jax(tmp_path, case):
    """Every schedule: the port's native engine = its Python engine = the
    JAX package's native engine, in stats and file bytes; then each small
    graph's own property of test_gfa_asm_native (a second unitig round over
    the chain changes nothing, no CR is written, ...)."""
    src = tmp_path / "in.gfa"
    src.write_bytes(_graph_text(case).encode())
    for i, ops in enumerate(SCHEDULES):
        out = _run_engines(src, ops, f"s{i}")
        assert out["port-native"] == out["port-python"] == out["jax-native"]
        assert out["port-native"][1]
    once = tmp_path / "s0.port-native.gfa"
    again = tmp_path / "again.gfa"
    gfa_asm.run_ops_file(str(once), [("u",)], str(again), engine="native")
    if case == "chain":
        assert again.read_bytes() == once.read_bytes()
    if case == "crlf":
        assert b"\r" not in once.read_bytes()
    if case == "revcomp_unusual":
        assert b"ACGTACGNAA" in once.read_bytes()
    if case == "star_cigar":
        assert once.read_bytes().count(b"S\t") == 1
    if case == "circular":
        assert b"utg0000001c" in once.read_bytes()


def test_native_engine_keeps_aline_extra_fields(tmp_path):
    src = tmp_path / "in.gfa"
    src.write_text(_SMALL_GFAS["aline_extra"])
    out = _run_engines(src, [("t", 10, 50000)], "t")
    assert out["port-native"] == out["port-python"] == out["jax-native"]
    assert b"XT:i:5" in out["port-native"][1]


# --- the generated stand-in for the example corpus --------------------------

EXAMPLE = dict(k=7, l=10, density=0.0008, min_kmer_abundance=2)


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    """A 0.1 Mbp random genome, 150x of error-free 23 kb reads (652 reads),
    assembled and magic-simplified by both packages (the port on the CPU,
    the JAX package on its host engine)."""
    d = tmp_path_factory.mktemp("example")
    reads = str(d / "reads.fa")
    write_synthetic_reads(reads, genome_mbp=0.1, coverage=150,
                          read_len=23000, error_rate=0, seed=0)
    out = {"reads": reads, "dir": d}
    for side in ("port", "jax"):
        (d / side).mkdir()
        prefix = str(d / side / "ex")
        if side == "port":
            pipeline.assemble(reads, Params(**EXAMPLE), prefix, device="cpu")
            magic_simplify.magic_simplify(prefix)
        else:
            jax_pipeline.assemble(reads, JaxParams(engine="host", **EXAMPLE),
                                  prefix)
            jax_ms.magic_simplify(prefix)
        out[side] = prefix
    return out


def _contigs(fa):
    return [s.decode() for _, s in read_records(fa)]


def _read_blob(reads):
    seqs = _contigs(reads)
    return " ".join(seqs) + " " + " ".join(revcomp(r) for r in seqs)


@pytest.mark.parametrize("ext", ["gfa", "msimpl.gfa", "msimpl.fa"])
def test_example_magic_simplify_matches_jax(example, ext):
    a = Path(f"{example['port']}.{ext}").read_bytes()
    assert a and a == Path(f"{example['jax']}.{ext}").read_bytes()


def test_example_single_contig_covers_region(example):
    contigs = _contigs(example["port"] + ".msimpl.fa")
    assert len(contigs) == 1
    assert 90000 < len(contigs[0]) < 105000


def test_example_contig_is_exact(example):
    """Every 500 bp window of the contig is found verbatim in a read or its
    reverse complement."""
    (contig,) = _contigs(example["port"] + ".msimpl.fa")
    blob = _read_blob(example["reads"])
    windows = [contig[i : i + 500] for i in range(0, len(contig) - 500, 499)]
    assert windows and all(w in blob for w in windows)


def test_example_msimpl_gfa_has_sequences(example):
    s_lines = [x for x in open(example["port"] + ".msimpl.gfa")
               if x.startswith("S")]
    assert s_lines
    for line in s_lines:
        v = line.split("\t")
        assert v[2] != "*" and set(v[2]) <= set("ACGTN")
        assert "mc:f:" in line


def test_example_exact_junctions_is_invariant(example, tmp_path):
    """to_basespace(exact=True) after ROUND1 and break_loops gives the
    default path's contig, and it is exact."""
    g = gfa_asm.run_ops(gfa.Gfa.parse(example["port"] + ".gfa"),
                        magic_simplify.ROUND1, verbose=False)
    t1, t2 = str(tmp_path / "t1.gfa"), str(tmp_path / "t2.gfa")
    g.write(t1)
    break_loops(t1, t2)
    out = to_basespace(t2, example["port"], out_path=str(tmp_path / "x.gfa"),
                       exact=True)
    contig = next(x.split("\t")[2] for x in open(out) if x.startswith("S"))
    assert len(contig) > 90000
    blob = _read_blob(example["reads"])
    assert all(contig[i : i + 500] in blob
               for i in range(0, len(contig) - 500, 997))
    (default,) = _contigs(example["port"] + ".msimpl.fa")
    assert contig in (default, revcomp(default))


def test_example_round1_leaves_one_segment(example, tmp_path):
    """ROUND1 over the port's .gfa: one segment whose A-lines name every
    node, native engine = Python engine."""
    src = Path(example["port"] + ".gfa")
    n_nodes = sum(1 for x in open(src) if x.startswith("S"))
    g = gfa_asm.run_ops(gfa.Gfa.parse(str(src)), magic_simplify.ROUND1,
                        verbose=False)
    assert len(g.segments) == 1 and len(g.a_lines) == n_nodes
    out = {eng: gfa_asm.run_ops_file(str(src), magic_simplify.ROUND1,
                                     str(tmp_path / f"{eng}.gfa"), engine=eng)
           for eng in ("native", "python")}
    assert out["native"] == out["python"]
    assert ((tmp_path / "native.gfa").read_bytes()
            == (tmp_path / "python.gfa").read_bytes())


# --- multik ------------------------------------------------------------------

def test_multik_matches_jax(tmp_path, monkeypatch):
    """Two rounds (k = 10, 15) over 6 kb reads of a 0.105 Mbp genome; round
    1's 103 kb contig goes into round 2 twice.  The port on the CPU and the
    JAX host engine write the same final files."""
    reads = str(tmp_path / "reads.fa")
    write_synthetic_reads(reads, genome_mbp=0.105, coverage=20,
                          read_len=6000, error_rate=0, seed=3)
    assert multik.avg_readlen(reads) == 6000  # max_k 17: rounds 10 and 15
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)  # the clean-up globs the cwd
        if side == "port":
            multik.multik(reads, "m", device="cpu")
        else:
            jax_multik.multik(reads, "m", engine="host")
    fed = [n for n, _ in read_records(str(tmp_path / "port" /
                                          "m.multik_reads.fa"))]
    assert fed[:2] == ["utg0000001l_1", "utg0000001l_2"]
    for ext in ("msimpl.fa", "msimpl.gfa", "gfa"):
        a = (tmp_path / "port" / f"m-final.{ext}").read_bytes()
        assert a and a == (tmp_path / "jax" / f"m-final.{ext}").read_bytes()


# --- the CLI -----------------------------------------------------------------

def _tool_argv(tool, d):
    """argv of `tool` in directory d, which holds the stand-in's assembly
    (ex.gfa, ex.*.sequences), its ROUND1 output (r1.gfa), its .msimpl.gfa
    (ms.gfa), the reads (reads.fa) and a tiny corpus (tiny.fa)."""
    return {
        "to-basespace": ["-g", "r1.gfa", "-s", "ex"],
        "gfa-asm": ["ex.gfa", "-t", "10,50000", "-b", "100000", "-u",
                    "-o", "out.gfa"],
        "magic-simplify": ["ex", "--keep"],
        "simplify-meta": ["ex"],
        "multik": ["tiny.fa", "mk"],
        "gfa2fasta": ["ms"],
        "break-loops": ["ex.gfa", "out.gfa"],
        "gfa-complete": ["ex"],
        "hpc-compress": ["reads.fa", "out.fa"],
        "gfa-strip": ["ms.gfa", "out.gfa"],
        "extreme-simplify": ["ex", "2"],
        "synth-reads": ["out.fa", "--genome-mbp", "0.01", "--coverage", "2",
                        "--read-len", "900"],
        "ec-scale": ["--genome-mbp", "0.008", "--coverage", "10",
                     "--read-len", "1600", "--error-rate", "0.003",
                     "--workdir", "."],
    }[tool]


@pytest.fixture(scope="module")
def tool_inputs(example, tmp_path_factory):
    d = tmp_path_factory.mktemp("tool_inputs")
    src = Path(example["port"])
    for f in src.parent.iterdir():
        if re.fullmatch(r"ex\.(gfa|\d+\.sequences)", f.name):
            shutil.copy(f, d / f.name)
    shutil.copy(example["port"] + ".msimpl.gfa", d / "ms.gfa")
    shutil.copy(example["reads"], d / "reads.fa")
    gfa_asm.run_ops_file(str(d / "ex.gfa"), magic_simplify.ROUND1,
                         str(d / "r1.gfa"))
    write_synthetic_reads(str(d / "tiny.fa"), genome_mbp=0.03, coverage=10,
                          read_len=1500, error_rate=0, seed=5)
    return d


@pytest.mark.parametrize("tool", cli._TOOLS)
def test_cli_tool_matches_jax(tmp_path, tool_inputs, monkeypatch, tool):
    """`python -m rust_mdbg_tpu_torch TOOL ...` runs the port's tool (multik
    and ec-scale with --device cpu) and leaves the same files, byte for
    byte, as `python -m rust_mdbg_tpu TOOL ...` (multik with --engine host)
    on the same inputs."""
    monkeypatch.setenv("HOME", str(tmp_path))  # the JAX compile cache
    made = {}
    cpu = ["--device", "cpu"]
    for side, main, extra in (("port", cli.main,
                               {"multik": cpu, "ec-scale": cpu}),
                              ("jax", jax_cli.main,
                               {"multik": ["--engine", "host"]})):
        d = tmp_path / side
        shutil.copytree(tool_inputs, d)
        before = set(os.listdir(d))
        monkeypatch.chdir(d)
        argv = [tool] + _tool_argv(tool, d)
        assert main(argv + extra.get(tool, [])) == 0
        made[side] = {f: (d / f).read_bytes()
                      for f in sorted(set(os.listdir(d)) - before)}
    assert made["port"] and made["port"] == made["jax"]


@pytest.mark.parametrize("tool", ["ec-scale", "quality-n50"])
def test_cli_refuses_unported_tools(tool, tmp_path, monkeypatch):
    """quality-n50 is still refused.  The name is from the slices before
    error correction: ec-scale now runs (its report is held against the
    JAX package's in test_torch_ec_cli.py::test_ec_scale_matches_jax),
    and what it still refuses is a run without a card when no --device
    is named: the CPU is taken only when asked for, before any input is
    generated."""
    if tool == "quality-n50":
        with pytest.raises(SystemExit, match=f"{tool} is not ported yet"):
            cli.main([tool])
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = tmp_path / "w"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([tool, "--genome-mbp", "0.008", "--coverage", "10",
                  "--workdir", str(work), "--out", str(tmp_path / "r.json")])
    assert not work.exists() and not (tmp_path / "r.json").exists()


def test_port_sources_import_no_jax():
    """No source of the port, and not chip_smoke.py, imports jax or the JAX
    package, at the top or inside a function."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|rust_mdbg_tpu)(\.|\s|$)",
                     re.M)
    files = sorted((REPO / "rust_mdbg_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert any(f.parent.name == "tools" for f in files)
    bad = [(str(f), m.group(0)) for f in files
           for m in pat.finditer(f.read_text())]
    assert not bad
