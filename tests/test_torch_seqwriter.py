"""The .sequences writer's worker threads (io/sequences.write_records_native,
native/seqwriter.cpp): a file written on 2, 3 or 8 workers holds the same
bytes as one written on one, in each of the three record modes (vectors
given, values recomputed at given positions, values recomputed by a rolling
scan), and as the JAX package's single-thread writer; a recompute mismatch
in the last task fails the call and leaves no file; and each caller bounds
its workers by the CPU set it shares.

One read blob serves every record: random bases around a 4.3 Mbp periodic
run that holds no minimizer, so that one record (k minimizers spanning the
run) is longer than a frame's 4 MiB.  The records are spans of k
consecutive minimizers, so the three modes write the same text."""

import ast
import inspect
import os

import numpy as np
import pytest

from rust_mdbg_tpu.io.sequences import \
    write_records_native as jax_write_records_native
from rust_mdbg_tpu_torch.io import sequences
from rust_mdbg_tpu_torch.io.sequences import (FRAME_TEXT, iter_sequences,
                                              write_records_native,
                                              writer_workers)
from rust_mdbg_tpu_torch.ops.nthash import nthash_windows_np
from rust_mdbg_tpu_torch.utils.seq import CODE_BASE

K, L, DENSITY = 5, 12, 0.02
BOUND = int(DENSITY * 2**64)
RUN = 4_300_000
HEADER = (f"# k = {K}\n# l = {L}\n# Structure of remaining of the file:\n"
          "# [node name]\t[list of minimizers]\t[sequence of node]\t"
          "[abundance]\t[origin]\t[shift]\n")
MODES = ("vecs", "positions", "rolling")
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _canonical(codes):
    fh, rh = nthash_windows_np(codes, L)
    return np.minimum(fh, rh)


@pytest.fixture(scope="module")
def blob():
    """(bases, minimizer positions, their values): 150 kbp random, the
    periodic run, 150 kbp random."""
    rng = np.random.default_rng(5)
    for motif in ("ACGT", "AACCGGTT", "ACAGTCTG", "AAGCTTGC"):
        unit = np.frombuffer(motif.encode(), np.uint8)
        codes_unit = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), unit)
        run = np.tile(codes_unit, RUN // len(unit) + 1)[:RUN]
        if (_canonical(run[:4 * L]) > BOUND).all():
            break
    codes = np.concatenate([rng.integers(0, 4, 150_000), run,
                            rng.integers(0, 4, 150_000)]).astype(np.uint8)
    canon = _canonical(codes)
    sel = np.nonzero(canon <= np.uint64(BOUND))[0]
    assert not ((sel > 150_000 + L) & (sel < 150_000 + RUN - L)).any()
    return CODE_BASE[codes].copy(), sel, canon[sel]


def _records(blob, n, with_long):
    """n records drawn from the random parts (each a span of K consecutive
    minimizers, a third reversed), and with_long the one across the run
    in the middle."""
    bases, sel, vals = blob
    rng = np.random.default_rng(n)
    js = rng.integers(0, len(sel) - K + 1, n)
    gaps = sel[K - 1:] - sel[:len(sel) - K + 1]
    long_j = int(np.argmax(gaps))
    js = js[gaps[js] < 100_000]
    if with_long:
        js = np.insert(js, len(js) // 2, long_j)
    n = len(js)
    rev = (rng.random(n) < 0.33).astype(np.uint8)
    start = sel[js].astype(np.int64)
    end = sel[js + K - 1].astype(np.int64) + L
    rel = sel[js[:, None] + np.arange(K)] - sel[js][:, None]
    vecs = vals[js[:, None] + np.arange(K)]
    m = (end - start)[:, None]
    mpos = np.where(rev[:, None], (m - L) - rel[:, ::-1], rel)
    vecs = np.where(rev[:, None], vecs[:, ::-1], vecs).astype(np.uint64)
    index = rng.permutation(n).astype(np.uint32)
    s0 = rng.integers(0, 65536, n).astype(np.uint16)
    s1 = rng.integers(0, 65536, n).astype(np.uint16)
    return dict(index=index, vecs=vecs, start=start, end=end, rev=rev,
                s0=s0, s1=s1, mpos=mpos.astype(np.uint32))


def _expected(bases, r):
    """The records as dicts (iter_sequences' form) and the frames the text
    makes, from the format contract."""
    raw = bases.tobytes()
    out, sizes, cur = [], [], len(HEADER)
    for i in range(len(r["index"])):
        seq = raw[r["start"][i]:r["end"][i]]
        if r["rev"][i]:
            seq = seq.translate(COMP)[::-1]
        mins = tuple(int(v) for v in r["vecs"][i])
        shift = (int(r["s0"][i]), int(r["s1"][i]))
        out.append(dict(index=int(r["index"][i]), minimizers=mins,
                        seq=seq.decode(), abundance="*", origin="*",
                        shift=shift))
        cur += len(f"{r['index'][i]}\t[{', '.join(map(str, mins))}]\t"
                   f"{seq.decode()}\t*\t*\t({shift[0]}, {shift[1]})\n")
        if cur >= FRAME_TEXT:
            sizes.append(cur)
            cur = 0
    if cur:
        sizes.append(cur)
    return out, len(sizes)


INPUTS = {"frames": (44_000, True), "one_frame": (50, False),
          "empty": (0, False)}


@pytest.fixture(scope="module")
def inputs(blob):
    out = {}
    for name, (n, with_long) in INPUTS.items():
        r = _records(blob, n, with_long)
        out[name] = (r,) + _expected(blob[0], r)
    return out


def _write(path, mode, blob, r, write=write_records_native, **kw):
    args = (r["index"], r["vecs"] if mode == "vecs" else None, blob[0],
            r["start"], r["end"], r["rev"], r["s0"], r["s1"])
    if mode != "vecs":
        kw.update(hash_bound=BOUND)
    if mode == "positions":
        kw.update(mpos=r["mpos"])
    return write(path, K, L, *args, **kw)


@pytest.fixture(scope="module")
def one_worker(blob, inputs, tmp_path_factory):
    """(bytes, stats, prefix) of each input written on one worker in each
    mode, and the JAX package's file of it in vector mode."""
    d = tmp_path_factory.mktemp("one")
    out = {}
    for name, (r, _, _) in inputs.items():
        jax = str(d / f"jax_{name}.0.sequences")
        _write(jax, "vecs", blob, r, write=jax_write_records_native)
        out[name, "jax"] = open(jax, "rb").read()
        for mode in MODES:
            prefix = str(d / f"{mode}_{name}")
            stats = _write(prefix + ".0.sequences", mode, blob, r,
                           workers=1)
            out[name, mode] = (open(prefix + ".0.sequences", "rb").read(),
                               stats, prefix)
    return out


@pytest.mark.parametrize("workers", [2, 3, 8])
@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("mode", MODES)
def test_workers_write_the_one_worker_bytes(tmp_path, blob, inputs,
                                            one_worker, mode, name, workers):
    r, expected, n_frames = inputs[name]
    one, one_stats, one_prefix = one_worker[name, mode]
    assert one == one_worker[name, "jax"]
    assert one_stats == dict(frames=n_frames, workers=1)
    prefix = str(tmp_path / "w")
    stats = _write(prefix + ".0.sequences", mode, blob, r, workers=workers)
    assert open(prefix + ".0.sequences", "rb").read() == one
    assert stats["frames"] == n_frames
    if name == "frames":
        assert n_frames >= 4 and 1 < stats["workers"] <= workers
        assert max(len(e["seq"]) for e in expected) > FRAME_TEXT
    else:
        assert n_frames == 1 and stats["workers"] == 1
    decoded = list(iter_sequences(prefix))
    assert decoded == list(iter_sequences(one_prefix)) == expected


@pytest.fixture(scope="module")
def many_frames(blob, tmp_path_factory):
    """Records whose text makes sixteen frames or more, and the bytes one
    worker writes for them."""
    r = _records(blob, 300_000, False)
    one = str(tmp_path_factory.mktemp("many") / "one.0.sequences")
    _write(one, "vecs", blob, r, workers=1)
    with open(one, "rb") as f:
        return r, f.read()


def _slow_reader(path, out):
    """Read the pipe at `path` 64 KiB at a time, a millisecond apart."""
    import time

    with open(path, "rb") as f:
        while chunk := f.read(1 << 16):
            out.append(chunk)
            time.sleep(0.001)


@pytest.mark.parametrize("target,workers", [("file", 16), ("slow_pipe", 3)])
def test_frames_stay_in_order_under_load(tmp_path, blob, many_frames, target,
                                         workers):
    """Three calls, each within a time limit: on sixteen workers, twice the
    cores of a small host, into a file; and on three into a pipe read
    slowly, so that the workers run a ring of slots ahead of the calling
    thread's writes and wait for them.  The one-worker bytes every time."""
    import threading

    r, want = many_frames
    for rep in range(3):
        path = str(tmp_path / f"many{rep}.0.sequences")
        got, read = [], []
        # daemons: a call that never returns fails the test, not the run
        threads = [threading.Thread(target=lambda: got.append(
            _write(path, "vecs", blob, r, workers=workers)), daemon=True)]
        if target == "slow_pipe":
            os.mkfifo(path)
            threads.append(threading.Thread(target=_slow_reader, daemon=True,
                                            args=(path, read)))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        assert got[0]["frames"] >= 16 and got[0]["workers"] == workers
        if target == "file":
            with open(path, "rb") as f:
                read.append(f.read())
        assert b"".join(read) == want


def _threads():
    return len(os.listdir("/proc/self/task"))


@pytest.mark.parametrize("mode", ["positions", "rolling"])
def test_mismatch_in_the_last_task_fails_and_leaves_no_file(
        tmp_path, blob, inputs, mode):
    r = {key: a.copy() for key, a in inputs["frames"][0].items()}
    if mode == "positions":
        r["mpos"][-1, 1] = r["mpos"][-1, 0]
    else:
        r["start"][-1] += 1
    path = str(tmp_path / "bad.0.sequences")
    with open(path, "w") as f:
        f.write("an older file")
    before = _threads()
    with pytest.raises(RuntimeError, match="recompute"):
        _write(path, mode, blob, r, workers=4)
    assert not os.path.exists(path)
    assert _threads() == before


@pytest.mark.parametrize("budget,n_shards", [(1, 4), (3, 2), (8, 4),
                                             (8, 3), (16, 4)])
def test_sharded_writer_divides_the_cpu_set(monkeypatch, budget, n_shards):
    """Each shard's call takes at most max(1, budget // n_shards) workers,
    and that many where its text makes enough frames."""
    calls = []
    monkeypatch.setattr(sequences, "cpu_set_size", lambda: budget)
    monkeypatch.setattr(sequences, "write_records_native",
                        lambda *a, workers: calls.append(workers))
    n, seq = 4096 * n_shards, 20_000
    start = np.arange(n, dtype=np.int64) * 7
    sequences.write_records_native_sharded(
        "unused", K, L, np.arange(n, dtype=np.uint32),
        np.zeros((n, K), np.uint64), b"", start, start + seq,
        np.zeros(n, np.uint8), np.zeros(n, np.uint16), np.zeros(n, np.uint16),
        n_shards=n_shards)
    share = max(1, budget // n_shards)
    assert calls == [share] * n_shards
    assert writer_workers(4096, K, 4096 * seq, share) == share


def test_one_frame_gets_one_worker():
    assert writer_workers(50, 21, 50 * 300, 64) == 1
    assert writer_workers(0, 21, 0) == 1
    assert writer_workers(10_000, 21, 10_000 * 3_000, 64) > 1


def test_multihost_writes_on_one_worker():
    """The processes of a multihost group share their host's cores: every
    .sequences write of assemble_multihost passes workers=1."""
    from rust_mdbg_tpu_torch.parallel import multihost

    tree = ast.parse(inspect.getsource(multihost.assemble_multihost))
    calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
             and getattr(c.func, "id", None) == "write_records_native"]
    assert len(calls) == 2
    for c in calls:
        kw = {k.arg: k.value for k in c.keywords}
        assert isinstance(kw.get("workers"), ast.Constant)
        assert kw["workers"].value == 1
