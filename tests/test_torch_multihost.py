"""Port parity for --multihost: the byte-range input split against the JAX
package's (and a share read through the native reader against it), the
process mesh's all_to_all over two gloo processes of two
shards each against the single-process mesh, and two CLI processes joined
over gloo on the CPU against JAX `assemble_sharded(n_devices=2)`.

The multihost run's global row order interleaves the two processes'
byte-range shares in blocks of B_host reads a round.  On a corpus whose
shares hold the same number of reads, a multiple of B_host, the JAX run
over that interleaved order sees every round's rows exactly as the two
processes feed them: the .gfa bytes and the records must be equal, and the
(KC, LN, shift) node map equal to the JAX host engine's on that order, as
the JAX package's own two-process test checks.  Every subprocess has its
own timeout and is killed when it runs out."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rust_mdbg_tpu.core.pipeline import assemble as jax_assemble
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu.parallel.multihost import (
    count_range_records as jax_count_range,
    fasta_range_records as jax_range_records)
from rust_mdbg_tpu.parallel.pipeline import assemble_sharded as jax_sharded
from rust_mdbg_tpu_torch.parallel.mesh import ShardMesh
from rust_mdbg_tpu_torch.parallel.multihost import (count_range_records,
                                                    fasta_range_records)
from test_sharded_stress import _node_map
from torch_corpus import gfa_bytes, records

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 240
BATCH, B_HOST = 8, 4          # two processes, one CPU shard each


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(argvs, tmp_path, extra_env=None):
    """Start one process per argv joined as a group over 127.0.0.1; wait
    for each within PROC_TIMEOUT_S, killing the rest on a timeout.
    Returns their outputs; fails on a non-zero exit."""
    port = _free_port()
    procs = []
    for pid, argv in enumerate(argvs):
        env = dict(os.environ, MDBG_COORD=f"127.0.0.1:{port}",
                   MDBG_NPROCS=str(len(argvs)), MDBG_PROC_ID=str(pid),
                   OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable] + argv, env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _fasta(tmp_path, n_reads=83):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "r.fa")
    recs = []
    with open(path, "w") as f:
        for i in range(n_reads):
            seq = "".join("ACGT"[c] for c in rng.integers(
                0, 4, rng.integers(5, 300)))
            recs.append((f"x{i}", seq.encode()))
            f.write(f">x{i} descr\n")
            for j in range(0, len(seq), 50):
                f.write(seq[j: j + 50] + "\n")
    return path, recs


def test_fasta_range_records_partition(tmp_path):
    """Any split into 1, 2, 3 or 7 byte ranges, and cuts on and beside a
    record's '>': every record exactly once, the counts equal to the
    parse, both equal to the JAX package's functions."""
    path, recs = _fasta(tmp_path)
    size = os.path.getsize(path)
    data = open(path, "rb").read()
    starts = [0] + [i + 1 for i in range(len(data)) if data[i:i + 2]
                    == b"\n>"]
    cuts = [[(pid * -(-size // k), min(size, (pid + 1) * -(-size // k)))
             for pid in range(k)] for k in (1, 2, 3, 7)]
    cuts += [[(0, c), (c, size)] for c in (starts[3], starts[3] - 1,
                                           starts[3] + 1, starts[40],
                                           starts[-1])]
    for ranges in cuts:
        got = []
        for lo, hi in ranges:
            part = list(fasta_range_records(path, lo, hi))
            assert part == list(jax_range_records(path, lo, hi))
            assert len(part) == count_range_records(path, lo, hi) \
                == jax_count_range(path, lo, hi)
            got.extend(part)
        assert got == recs, ranges


def test_first_record_at_finds_the_first_owned_record(tmp_path):
    """For every start, the first record whose '>' lies at or after it (a
    line of 2^20 - 4 bases puts one '\\n>' across the scan's read
    boundary); nothing before the end: the file's size."""
    from rust_mdbg_tpu_torch.parallel.multihost import first_record_at

    path = tmp_path / "b.fa"
    data = (b">a\n" + b"A" * ((1 << 20) - 4) + b"\n>b\nACGT\n>c\nGG\n")
    path.write_bytes(data)
    heads = [0] + [i + 1 for i in range(len(data) - 1)
                   if data[i:i + 2] == b"\n>"]
    assert heads[1] == 1 << 20
    for start in [0, 1, 2, (1 << 20) - 1, 1 << 20, (1 << 20) + 1,
                  heads[2], heads[2] + 1, len(data) - 1]:
        want = min([h for h in heads if h >= start] + [len(data)])
        assert first_record_at(str(path), start) == want, start


@pytest.mark.parametrize("B", [1, 5, 16])
def test_share_chunks_read_the_range_records(tmp_path, B):
    """A process's share through the native reader (chunks of 4 reads)
    re-cut by exact_rounds into rounds of B reads: for splits into 1, 2
    and 3 byte ranges, each share's reads, codes and lengths are those of
    fasta_range_records's records, every round but the last holds B."""
    from rust_mdbg_tpu_torch.parallel.multihost import share_chunks
    from rust_mdbg_tpu_torch.parallel.pipeline import exact_rounds
    from rust_mdbg_tpu_torch.utils.seq import BASE_CODE

    path, _recs = _fasta(tmp_path)
    size, L = os.path.getsize(path), 512
    for k in (1, 2, 3):
        step = -(-size // k)
        for pid in range(k):
            share = (path, pid * step, min(size, (pid + 1) * step))
            want = [seq for _, seq in fasta_range_records(*share)]
            rounds = list(exact_rounds(share_chunks([share], 4, L), B, L))
            assert [r[4] for r in rounds[:-1]] == [B] * (len(rounds) - 1)
            got = []
            for codes, lens, blob, off, fill in rounds:
                assert codes.shape == (B, L) and not lens[fill:].any()
                for i in range(fill):
                    seq = bytes(blob[off[i]:off[i + 1]])
                    assert lens[i] == len(seq)
                    np.testing.assert_array_equal(
                        codes[i, :len(seq)],
                        BASE_CODE[np.frombuffer(seq, np.uint8)])
                    got.append(seq)
            assert got == want, (k, pid)


_MESH_WORKER = r"""
import json, sys, torch
from rust_mdbg_tpu_torch.parallel.multihost import (
    ProcessMesh, close_distributed, init_distributed)
pid, nproc = init_distributed()
mesh = ProcessMesh(["cpu", "cpu"])
sends = []
for s in mesh.local:
    counts = [(3 * s + d) % 4 for d in range(mesh.n)]
    rows = torch.arange(sum(counts))[:, None] * 10 + 1000 * s
    sends.append((torch.cat([rows, rows + 1], dim=1), counts))
recv = mesh.all_to_all(sends)
json.dump(dict(local=mesh.local, backend=mesh.backend,
               recv=[r.tolist() for r in recv],
               gathered=mesh.all_gather([10 * s for s in mesh.local]),
               psum=mesh.psum([1, 2]), objs=mesh.gather_objects(pid)),
          open(sys.argv[1], "w"))
close_distributed()
"""


def test_process_mesh_all_to_all(tmp_path):
    """Two gloo processes of two CPU shards each: every shard receives
    what the single-process ShardMesh(4) gives it for the same sends;
    all_gather, psum and the object gather span both processes."""
    outs = [str(tmp_path / f"m{p}.json") for p in range(2)]
    _run_group([["-c", _MESH_WORKER, outs[p]] for p in range(2)], tmp_path)
    sends = []
    for s in range(4):
        counts = [(3 * s + d) % 4 for d in range(4)]
        rows = torch.arange(sum(counts))[:, None] * 10 + 1000 * s
        sends.append((torch.cat([rows, rows + 1], dim=1), counts))
    want = [r.tolist() for r in ShardMesh(4, ["cpu"] * 4).all_to_all(sends)]
    for p in range(2):
        got = json.load(open(outs[p]))
        assert got["local"] == [2 * p, 2 * p + 1]
        assert got["backend"] == "gloo"
        assert got["recv"] == want[2 * p: 2 * p + 2]
        assert got["gathered"] == [0, 10, 20, 30]
        assert got["psum"] == 6 and got["objs"] == [0, 1]


def _even_corpus(path, n_reads=96, rl=700, seed=5, err=0.01,
                 genome_bp=9000):
    """Errored reads on both strands (test_sharded_stress._synth_err's
    model) of one length with names of one width: every record has the
    same bytes, so the two byte-range shares hold n_reads / 2 reads each,
    a multiple of B_HOST."""
    assert n_reads % (2 * B_HOST) == 0
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACTG", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, genome_bp)]
    comp = {65: 84, 67: 71, 71: 67, 84: 65}
    with open(path, "wb") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, genome_bp - rl))
            r = genome[s: s + rl].copy()
            e = rng.random(rl) < err
            r[e] = bases[rng.integers(0, 4, int(e.sum()))]
            if rng.random() < 0.5:
                r = np.array([comp[c] for c in r[::-1]], dtype=np.uint8)
            f.write(b">e%04d\n" % i + r.tobytes() + b"\n")
    return path


def _interleaved(reads, path):
    """The multihost global row order as one FASTA: round by round, each
    process's block of B_HOST reads."""
    size = os.path.getsize(reads)
    step = -(-size // 2)
    shares = [list(fasta_range_records(reads, p * step,
                                       min(size, (p + 1) * step)))
              for p in range(2)]
    assert len(shares[0]) == len(shares[1])
    with open(path, "wb") as f:
        for r in range(0, len(shares[0]), B_HOST):
            for share in shares:
                for name, seq in share[r: r + B_HOST]:
                    f.write(b">" + name.encode() + b"\n" + seq + b"\n")
    return path


@pytest.fixture(scope="module")
def even(tmp_path_factory):
    """The even corpus, its interleaved order, and the JAX references on
    that order: assemble_sharded at n = 2 and the host engine."""
    d = tmp_path_factory.mktemp("multihost")
    reads = _even_corpus(str(d / "even.fa"))
    inter = _interleaved(reads, str(d / "inter.fa"))
    kw = dict(k=5, l=8, density=0.05, min_kmer_abundance=2,
              batch_reads=BATCH, presimp=0.6)
    jp = str(d / "jax_mesh2")
    jst = jax_sharded(inter, JaxParams(engine="device", **kw), jp,
                      n_devices=2)
    hp = str(d / "jax_host")
    hst = jax_assemble(inter, JaxParams(engine="host", **kw), hp)
    return dict(reads=reads, jax=jp, jax_stats=jst, host=hp,
                host_stats=hst)


@pytest.mark.parametrize("edges", ["1", "0"])
def test_multihost_cli_matches_jax(tmp_path, even, edges):
    """Two CLI processes, gloo, one CPU shard each, with the distributed
    join and with the gathered one (MDBG_SHARDED_EDGES=0): the JAX n = 2
    run's .gfa bytes and records, and the host engine's node map."""
    argv = ["-m", "rust_mdbg_tpu_torch", even["reads"], "-k", "5", "-l",
            "8", "-d", "0.05", "--batch-reads", str(BATCH), "--presimp",
            "0.6", "--multihost", "--device", "cpu", "--prefix", "mh"]
    outs = _run_group([argv, argv], tmp_path,
                      {"MDBG_SHARDED_EDGES": edges})
    prefix = str(tmp_path / "mh")
    assert gfa_bytes(prefix) == gfa_bytes(even["jax"])
    assert records(prefix) == records(even["jax"]) and records(prefix)
    assert _node_map(prefix) == _node_map(even["host"])
    nodes = even["jax_stats"]["nb_nodes"]
    assert nodes == even["host_stats"]["nb_nodes"] > 0
    assert f"Number of mdBG nodes: {nodes}" in outs[0]
    removed = even["jax_stats"]["presimp_removed"]
    assert removed > 0
    assert f"Pre-simp = 0.6: {removed} edges removed." in outs[0]
    assert not any(p.name.startswith("mh.gfapart") for p in tmp_path.iterdir())
