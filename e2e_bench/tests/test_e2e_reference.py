"""The plain reference against the program on a tiny corpus on the CPU:
the same .gfa and every .sequences record; the comparison catches a
changed GFA line, a changed record, and records dropped or written twice;
the control (the reference with a
2^24-bit Bloom filter) fails it."""

import glob
import os
import struct

import pytest
import torch

from e2e_bench import check, control, generator, lz4frame, reference
from e2e_bench.tests.test_e2e_generator import config

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["hg002-k21", "hg002-k21-raw"])
def job(request, tmp_path_factory):
    """The program's outputs and the reference's graph for one corpus."""
    from rust_mdbg_tpu_torch.core.pipeline import assemble
    from rust_mdbg_tpu_torch.params import Params

    tmp = tmp_path_factory.mktemp(request.param)
    cfg = config(request.param, genome_mbp=0.05)
    fasta = str(tmp / "reads.fa")
    generator.write_corpus(cfg, 2**31 + 17, fasta)
    prefix = str(tmp / "asm")
    stats = assemble(fasta, Params(**cfg["params"]), prefix, device="cpu")
    reads = reference.parse_fasta(fasta)
    graph = reference.assemble(reads, cfg["params"], "cpu")
    return dict(cfg=cfg, prefix=prefix, stats=stats, reads=reads,
                graph=graph, fasta=fasta)


def all_records(prefix):
    """(node id, line) of every record of the prefix.*.sequences files."""
    paths = sorted(glob.glob(f"{prefix}.*.sequences"))
    out = []
    for p in paths:
        with open(p, "rb") as f:
            for ln in lz4frame.decode(f.read()).decode().splitlines():
                if ln and not ln.startswith("#"):
                    out.append((int(ln.split("\t", 1)[0]), ln))
    return out, len(paths)


def stored_frame(text: bytes) -> bytes:
    """An LZ4 frame of one block stored as is."""
    return (struct.pack("<IBBB", lz4frame.MAGIC, 0x60, 0x70, 0)
            + struct.pack("<I", len(text) | 0x80000000) + text
            + struct.pack("<I", 0))


def test_reference_equals_program(job):
    g = job["graph"]
    assert g.counts["nodes"] == job["stats"]["nb_nodes"] > 0
    assert g.counts["edges"] == job["stats"]["nb_edges"] > 0
    records, n_files = all_records(job["prefix"])
    assert len(records) == g.counts["nodes"]
    numbers, n = check.check_job(job["prefix"], 5, g, job["reads"])
    assert numbers == dict(gfa_lines_differ=0, record_ids_differ=0,
                           records_differ=0)
    assert n > 0 and check.passed(numbers)
    with open(job["prefix"] + ".gfa") as f:
        assert f.read().splitlines() == g.gfa_lines


def test_changed_gfa_line_is_caught(job):
    with open(job["prefix"] + ".gfa") as f:
        lines = f.read().splitlines()
    i = next(i for i, ln in enumerate(lines) if ln.startswith("L"))
    lines[i] = lines[i].replace("+", "-", 1) if "+" in lines[i] else \
        lines[i].replace("-", "+", 1)
    records, n_files = all_records(job["prefix"])
    ids = [i for i, _ in records]
    numbers = check.compare(lines, records, ids, job["graph"], job["reads"])
    assert numbers["gfa_lines_differ"] == 1 and not check.passed(numbers)
    numbers = check.compare(lines[:-1], records, ids, job["graph"],
                            job["reads"])
    assert numbers["gfa_lines_differ"] == 2


def test_changed_record_is_caught(job, tmp_path):
    paths = sorted(glob.glob(job["prefix"] + ".*.sequences"))
    with open(paths[0], "rb") as f:
        text = lz4frame.decode(f.read())
    lines = text.split(b"\n")
    i = next(i for i, ln in enumerate(lines) if ln[:1].isdigit())
    f = lines[i].split(b"\t")
    f[2] = f[2][:-1] + (b"A" if f[2][-1:] != b"A" else b"C")
    lines[i] = b"\t".join(f)
    prefix = str(tmp_path / "asm")
    for j, p in enumerate(paths):
        with open(p, "rb") as src, open(f"{prefix}.{j}.sequences",
                                        "wb") as dst:
            dst.write(stored_frame(b"\n".join(lines)) if j == 0
                      else src.read())
    os.symlink(job["prefix"] + ".gfa", prefix + ".gfa")
    records, n_files = all_records(prefix)
    numbers = check.compare(job["graph"].gfa_lines, records,
                            [i for i, _ in records], job["graph"],
                            job["reads"])
    assert numbers == dict(gfa_lines_differ=0, record_ids_differ=0,
                           records_differ=1)
    # no .sequences at all: every node's record is missing
    numbers = check.compare(job["graph"].gfa_lines, [], [], job["graph"],
                            job["reads"])
    assert numbers["record_ids_differ"] == job["graph"].counts["nodes"]


@pytest.mark.parametrize("change", ["drop_half", "twice", "stray_id"])
def test_records_dropped_or_doubled_are_caught(job, tmp_path, change):
    """Every record is counted, not only the sampled ones: half of them
    left out, some written twice, or one under no node's id."""
    paths = sorted(glob.glob(job["prefix"] + ".*.sequences"))
    text = b"".join(lz4frame.decode(open(p, "rb").read()) for p in paths)
    lines = text.rstrip(b"\n").split(b"\n")
    head = [ln for ln in lines if ln.startswith(b"#")]
    recs = [ln for ln in lines if not ln.startswith(b"#")]
    if change == "drop_half":
        recs = recs[::2]
    elif change == "twice":
        recs = recs + recs[:3]
    else:
        recs[0] = b"%d" % (10**9) + recs[0][recs[0].index(b"\t"):]
    prefix = str(tmp_path / "asm")
    with open(f"{prefix}.0.sequences", "wb") as f:
        f.write(stored_frame(b"\n".join(head + recs) + b"\n"))
    os.symlink(job["prefix"] + ".gfa", prefix + ".gfa")
    numbers, _ = check.check_job(prefix, 5, job["graph"], job["reads"])
    n = job["graph"].counts["nodes"]
    want = dict(drop_half=n - len(recs), twice=3, stray_id=2)[change]
    assert numbers["record_ids_differ"] == want
    assert not check.passed(numbers)


def test_control_fails(job):
    g = job["graph"]
    bad = reference.assemble(job["reads"], job["cfg"]["params"], "cpu",
                             control=control.CONTROL)
    numbers = control.control_numbers(g, bad, job["reads"], 3)
    assert numbers["gfa_lines_differ"] > 0 and not check.passed(numbers)
    assert bad.counts["nodes"] > g.counts["nodes"]
    assert numbers["record_ids_differ"] == (bad.counts["nodes"]
                                            - g.counts["nodes"])
