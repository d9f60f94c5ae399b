""".sequences sidecar files (LZ4F-compressed, per-shard).

Format parity (rust-mdbg src/main.rs:616-630, 696-707):

    # k = <k>
    # l = <l>
    # Structure of remaining of the file:
    # [node name]\t[list of minimizers]\t[sequence of node]\t[abundance]\t[origin]\t[shift]
    <index>\t[h0, h1, ...]\t<seq>\t*\t<origin>\t(s0, s1)

The reference writes one file per worker thread (`prefix.<tid>.sequences`);
we write one per pipeline shard/host with the same naming contract so
to_basespace-style globbing (`prefix.*.sequences`, to_basespace.rs:233) works.
"""

from __future__ import annotations

import glob as _glob
import os

from .lz4f import LZ4FWriter, open_text


def sequences_path(prefix: str, shard: int) -> str:
    return f"{prefix}.{shard}.sequences"


def remove_stale(prefix: str):
    """Delete all previous `prefix*.sequences` (main.rs:608-613)."""
    for p in _glob.glob(f"{prefix}*.sequences"):
        try:
            os.remove(p)
        except OSError:
            pass


class SequencesWriter:
    def __init__(self, prefix: str, shard: int, k: int, l: int):
        self._w = LZ4FWriter(sequences_path(prefix, shard))
        self._w.write(f"# k = {k}\n")
        self._w.write(f"# l = {l}\n")
        self._w.write("# Structure of remaining of the file:\n")
        self._w.write(
            "# [node name]\t[list of minimizers]\t[sequence of node]\t[abundance]\t[origin]\t[shift]\n"
        )

    def record(self, index: int, minimizers, seq: str, origin: str, shift):
        mins = "[" + ", ".join(str(int(m)) for m in minimizers) + "]"
        self._w.write(
            f"{index}\t{mins}\t{seq}\t*\t{origin}\t({shift[0]}, {shift[1]})\n"
        )

    def close(self):
        self._w.close()


#: a .sequences frame ends after the record that brings its text to this
#: many bytes (native/seqwriter.cpp FRAME_TEXT)
FRAME_TEXT = 4 << 20

#: a record's bytes besides its sequence, at most: the index (10 digits),
#: k values of up to 20 digits and ", " between them, two shifts of 5
#: digits and the separators
_RECORD_MAX_BYTES = 10 + 5 + 5 + 14


def cpu_set_size() -> int:
    """The CPUs this process may run on (its affinity mask)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count() or 1


def writer_workers(n: int, k: int, seq_bytes: int,
                   budget: int | None = None) -> int:
    """Threads for one `write_records_native` call: the frames its text can
    make at most, bounded by `budget` (default: the CPU set's size).  A
    text under one frame gets one worker, the single-thread path."""
    budget = cpu_set_size() if budget is None else budget
    text = seq_bytes + n * (_RECORD_MAX_BYTES + 22 * k)
    return max(1, min(budget, text // FRAME_TEXT + 1))


def write_records_native(path: str, k: int, l: int, index, vecs, reads_buf,
                         abs_start, abs_end, rev, shift0, shift1,
                         hash_bound: int = 0, accel: int = 1, mpos=None,
                         workers: int | None = None) -> dict:
    """Bulk-write node records with the native C++ writer (slice + revcomp
    + format + LZ4F).  `reads_buf` is a bytes-like buffer of raw ASCII
    bases; per node the sequence is reads_buf[abs_start:abs_end],
    reverse-complemented where rev is set.

    vecs=None: the writer RE-DERIVES each node's k minimizer values from the
    record's own sequence bytes (ntHash + density rule hash_bound),
    skipping the [n, k] u64 device->host transfer — only valid when hashing
    space == sequence space (see native/seqwriter.cpp header + the
    minimizer_recompute_ok gate in core/device_out.py).  With `mpos`
    ([n, k] u32 record-space positions, stored orientation) the writer hashes
    only the k l-mers at those positions instead of rolling over every base
    (~10x less hashing).  `accel` is the LZ4 skip-acceleration factor
    (1 = max ratio).

    The writer measures the records and encodes the file's 4 MiB frames on
    worker threads: at most `workers` (default: the CPU set's size), and
    no more than the frames the text can make (writer_workers).  The
    file's bytes are the same for every count.  Returns {"frames": frames
    written, "workers": the most threads a pass of the call ran}."""
    import ctypes

    import numpy as np

    from ..native import load

    lib = load("seqwriter")
    lib.seqs_write.restype = ctypes.c_int64
    lib.seqs_write.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ] + [ctypes.c_void_p] * 8 + [ctypes.c_uint64, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]

    index = np.ascontiguousarray(index, dtype=np.uint32)
    n = len(index)
    if vecs is None:
        k_ = k
        vec_ptr = None
        if not hash_bound:
            raise ValueError("vecs=None requires hash_bound")
    else:
        vecs = np.ascontiguousarray(vecs, dtype=np.uint64)
        n, k_ = vecs.shape
        vec_ptr = vecs.ctypes.data_as(ctypes.c_void_p)
    abs_start = np.ascontiguousarray(abs_start, dtype=np.int64)
    abs_end = np.ascontiguousarray(abs_end, dtype=np.int64)
    rev = np.ascontiguousarray(rev, dtype=np.uint8)
    shift0 = np.ascontiguousarray(shift0, dtype=np.uint16)
    shift1 = np.ascontiguousarray(shift1, dtype=np.uint16)
    if not isinstance(reads_buf, (bytes, bytearray, memoryview, np.ndarray)):
        raise TypeError("reads_buf must be bytes-like")
    if isinstance(reads_buf, np.ndarray):
        reads_buf = np.ascontiguousarray(reads_buf, dtype=np.uint8)
        buf_ptr = reads_buf.ctypes.data_as(ctypes.c_void_p)
    else:
        buf_ptr = ctypes.cast(
            (ctypes.c_char * len(reads_buf)).from_buffer_copy(reads_buf),
            ctypes.c_void_p,
        )

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    mpos_ptr = None
    if mpos is not None:
        mpos = np.ascontiguousarray(mpos, dtype=np.uint32)
        mpos_ptr = mpos.ctypes.data_as(ctypes.c_void_p)
    workers = writer_workers(n, k_, int((abs_end - abs_start).sum()),
                             workers)
    out = np.zeros(2, dtype=np.int64)
    r = lib.seqs_write(
        str(path).encode(), n, k_, k, l,
        ptr(index), vec_ptr, buf_ptr, ptr(abs_start), ptr(abs_end),
        ptr(rev), ptr(shift0), ptr(shift1),
        ctypes.c_uint64(int(hash_bound)), int(accel), mpos_ptr,
        int(workers), ptr(out),
    )
    if r == -2:
        raise RuntimeError(
            f"seqs_write minimizer recompute mismatch for {path} "
            "(recompute gate violated)")
    if r != 0:
        raise RuntimeError(f"seqs_write failed for {path}")
    return dict(frames=int(out[0]), workers=int(out[1]))


def write_records_native_sharded(prefix: str, k: int, l: int, index, vecs,
                                 reads_buf, abs_start, abs_end, rev,
                                 shift0, shift1, n_shards: int = 4):
    """Parallel bulk write across `prefix.<i>.sequences` shards (the
    reference's per-thread multi-file contract, main.rs:616-630); the C++
    writer releases the GIL so shards write concurrently, and the CPU set
    is shared among them: each shard's call takes at most its share of
    workers."""
    import threading

    import numpy as np

    n = len(index)
    n_shards = max(1, min(n_shards, max(1, n // 1024)))
    share = max(1, cpu_set_size() // n_shards)
    bounds = np.linspace(0, n, n_shards + 1).astype(int)
    threads = []
    for s in range(n_shards):
        a, b = bounds[s], bounds[s + 1]
        t = threading.Thread(
            target=write_records_native,
            args=(sequences_path(prefix, s), k, l, index[a:b], vecs[a:b],
                  reads_buf, abs_start[a:b], abs_end[a:b], rev[a:b],
                  shift0[a:b], shift1[a:b]),
            kwargs=dict(workers=share),
        )
        t.start()
        threads.append(t)
    for t in threads:
        t.join()


def iter_sequences(prefix: str):
    """Yield parsed records from all `prefix.*.sequences` shards.

    Yields dicts: index, minimizers (tuple[int]), seq (str), origin, shift (pair).
    Mirrors utils/parse_sequences_file.py + to_basespace.rs:200-243.
    """
    for path in sorted(_glob.glob(f"{prefix}.*.sequences")):
        with open_text(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                v = line.rstrip("\n").split("\t")
                mins = tuple(
                    int(x) for x in v[1].strip("[]").split(",") if x.strip()
                )
                sh = v[5].strip("()").split(",")
                yield dict(
                    index=int(v[0]),
                    minimizers=mins,
                    seq=v[2],
                    abundance=v[3],
                    origin=v[4],
                    shift=(int(sh[0]), int(sh[1])),
                )
