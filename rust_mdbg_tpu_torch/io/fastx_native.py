"""Native chunked FASTX ingest with prefetch: the parallel read pump.

Wraps native/fastx.cpp (mmap / zlib-streamed parsing, multithreaded base
encoding) and overlaps parsing with device compute via a one-chunk-deep
prefetch thread (the ctypes call releases the GIL), replacing the
single-threaded pure-Python line parser on the hot ingest path — the
TPU-side equivalent of the reference's seq_io parser thread + worker pool
(rust-mdbg src/main.rs:834-838).

Yields NativeChunk objects: fixed-shape code tensors (or, in packed mode,
the feed's staged 2-bit and mask planes, written by the parser's
encode threads) plus the concatenated raw-byte blob and offsets (no
per-read Python objects — at 114 Gbp scale, object churn IS the parser
bottleneck).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import os
import queue
import threading

import numpy as np

from ..utils.alloc import full_fast

from ..native import load
from ..utils.timing import PhaseTimer
from .fastx import is_fasta

_STATUS_MORE = 0
_STATUS_EOF = 1
_STATUS_LONG = 2
_STATUS_BAD = 3


def native_ingest_supported(path: str) -> bool:
    """Plain and .gz files parse natively; .lz4 falls back to Python."""
    return not str(path).endswith(".lz4")


@dataclasses.dataclass
class NativeChunk:
    """One parsed chunk.

    codes:   uint8 [cap, L]; only the first lengths[i] bytes of each row are
             meaningful (callers mask by length).  None in packed mode,
             but for an over-long read's singleton chunk.
    planes:  packed mode: (packed uint8 [cap, W/4], mask uint8 [cap, W/8]),
             core/fastx_feed.host_feed's arrays for these reads, W the half
             width where every read fits it, else L; None otherwise.
    lengths: int32 [cap]; rows >= n are 0.
    raw:     concatenated sequence bytes of the n reads.
    raw_off: int64 [n+1] offsets into raw.
    ids:     raw header-token bytes, offsets in ids_off (decode lazily).
    start_index: global index of the chunk's first read.
    """

    codes: np.ndarray | None
    lengths: np.ndarray
    raw: np.ndarray
    raw_off: np.ndarray
    ids: np.ndarray
    ids_off: np.ndarray
    n: int
    start_index: int
    planes: tuple | None = None

    def id_str(self, i: int) -> str:
        return bytes(self.ids[self.ids_off[i]:self.ids_off[i + 1]]).decode()


class NativeReader:
    """Chunk iterator over a FASTX file via the native parser."""

    def __init__(self, path: str, chunk_reads: int, max_len: int,
                 nthreads: int | None = None, mean_len_hint: int = 0,
                 start: int = 0, packed_half: int | None = None):
        """`start`: the byte offset of the first record to parse (plain
        files only).  `packed_half`: None reads codes; an int reads packed
        planes (fx_next_packed), at that half width (0 = none) where a
        chunk's reads fit it; max_len and it are then multiples of 8."""
        if packed_half is not None and (max_len % 8 or packed_half % 8):
            raise ValueError(f"packed planes need widths divisible by 8, "
                             f"not {max_len} and {packed_half}")
        lib = load("fastx")
        lib.fx_open.restype = ctypes.c_void_p
        lib.fx_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.fx_next.restype = ctypes.c_int64
        lib.fx_next.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int64] + [ctypes.c_void_p] * 8
        lib.fx_next_packed.restype = ctypes.c_int64
        lib.fx_next_packed.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64] \
            + [ctypes.c_void_p] * 11
        lib.fx_long_len.restype = ctypes.c_int64
        lib.fx_long_len.argtypes = [ctypes.c_void_p]
        lib.fx_long.restype = ctypes.c_int64
        lib.fx_long.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.fx_close.argtypes = [ctypes.c_void_p]
        lib.fx_seek.restype = ctypes.c_int
        lib.fx_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        self._lib = lib
        if nthreads is None:
            nthreads = max(1, (os.cpu_count() or 2) - 1)
        self._h = lib.fx_open(str(path).encode(), int(is_fasta(path)),
                              nthreads)
        if not self._h:
            raise FileNotFoundError(path)
        if start and lib.fx_seek(self._h, start) != 0:
            self.close()
            raise ValueError(f"cannot start {path} at byte {start}: only a "
                             "plain file within its size can")
        self.chunk_reads = chunk_reads
        self.max_len = max_len
        self.packed_half = packed_half
        # raw blob sized to the worst case the codes buffer admits would be
        # cap*L; reads are typically much shorter than the padded width, so
        # size to the observed mean with headroom and let the parser return
        # short chunks if a pathological input overflows
        mean = mean_len_hint or max_len
        # modest headroom: the parser returns a short chunk when the blob
        # fills, so over-allocating here only inflates resident memory
        self._raw_cap = max(1 << 20, int(chunk_reads * min(max_len,
                                                           int(mean * 1.25))))
        self._ids_cap = max(1 << 16, chunk_reads * 64)
        self._count = 0

    @staticmethod
    def _ptr(a: np.ndarray):
        return a.ctypes.data_as(ctypes.c_void_p)

    def next_chunk(self) -> NativeChunk | None:
        """Parse the next chunk; None at EOF.  Over-long reads come back as
        singleton chunks with row shape [1, padded_len] (same contract as
        fastx.batches overflow batches)."""
        cap, L = self.chunk_reads, self.max_len
        # np.zeros, NOT np.empty: on this platform first-touch page faults
        # of malloc'd (empty) memory run ~100x slower than the calloc/zero
        # path (20 s vs 0.2 s for a 400 MB chunk buffer) and dominate the
        # whole ingest otherwise
        lengths = np.zeros(cap, dtype=np.int32)
        raw = np.zeros(self._raw_cap, dtype=np.uint8)
        raw_off = np.zeros(cap + 1, dtype=np.int64)
        ids = np.zeros(self._ids_cap, dtype=np.uint8)
        ids_off = np.zeros(cap + 1, dtype=np.int32)
        status = np.zeros(1, dtype=np.int32)
        tail = (self._ptr(raw), self._raw_cap, self._ptr(raw_off),
                self._ptr(ids), self._ids_cap, self._ptr(ids_off),
                self._ptr(status))
        codes = planes = None
        if self.packed_half is None:
            codes = np.zeros((cap, L), dtype=np.uint8)
            n = self._lib.fx_next(self._h, cap, L, self._ptr(codes),
                                  self._ptr(lengths), *tail)
        else:
            # both planes at width L; the parser lays them out at the width
            # it chose from the buffers' start
            packed = np.zeros(cap * L // 4, dtype=np.uint8)
            mask = np.zeros(cap * L // 8, dtype=np.uint8)
            width = np.zeros(1, dtype=np.int64)
            n = self._lib.fx_next_packed(
                self._h, cap, L, self.packed_half, self._ptr(packed),
                self._ptr(mask), self._ptr(width), self._ptr(lengths), *tail)
            W = int(width[0])
            planes = (packed[: cap * W // 4].reshape(cap, W // 4),
                      mask[: cap * W // 8].reshape(cap, W // 8))
        st = int(status[0])
        if st == _STATUS_BAD:
            raise ValueError("malformed FASTX record in native parser")
        if n == 0:
            if st == _STATUS_LONG:
                return self._long_chunk()
            return None
        chunk = NativeChunk(
            codes=codes, lengths=lengths,
            raw=raw[: raw_off[n]], raw_off=raw_off[: n + 1],
            ids=ids[: ids_off[n]], ids_off=ids_off[: n + 1],
            n=int(n), start_index=self._count, planes=planes,
        )
        self._count += int(n)
        return chunk

    def _long_chunk(self) -> NativeChunk:
        ln = self._lib.fx_long_len(self._h)
        if ln < 0:
            raise ValueError("truncated over-long FASTX record")
        Lp = ((int(ln) + self.max_len - 1) // self.max_len) * self.max_len
        raw = np.zeros(int(ln), dtype=np.uint8)
        codes = full_fast((1, Lp), 5, np.uint8)
        idb = np.empty(4096, dtype=np.uint8)
        idl = np.zeros(1, dtype=np.int32)
        got = self._lib.fx_long(self._h, self._ptr(raw), self._ptr(codes),
                                self._ptr(idb), self._ptr(idl))
        assert got == ln, (got, ln)
        chunk = NativeChunk(
            codes=codes, lengths=np.array([ln], dtype=np.int32),
            raw=raw, raw_off=np.array([0, ln], dtype=np.int64),
            ids=idb[: idl[0]],
            ids_off=np.array([0, idl[0]], dtype=np.int32),
            n=1, start_index=self._count,
        )
        self._count += 1
        return chunk

    def close(self):
        if self._h:
            self._lib.fx_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        while True:
            c = self.next_chunk()
            if c is None:
                return
            yield c


#: name of chunks_prefetched's parse thread
PUMP_THREAD = "fastx-prefetch"


def chunks_prefetched(path: str, chunk_reads: int, max_len: int,
                      mean_len_hint: int = 0, depth: int = 1,
                      start: int = 0, timer: PhaseTimer | None = None,
                      packed_half: int | None = None):
    """Iterate NativeChunks with a background parse thread so file parsing
    overlaps device compute (from byte `start`, a record's first byte).

    Chunk CONSTRUCTION is token-gated: the pump allocates chunk N+1 only
    after the consumer has taken chunk N off the queue.  This bounds live
    chunks to two (one being consumed, one being built) instead of
    1 + depth + 1 — at HiFi scale each chunk is ~2 GB of codes+raw, so the
    extra buffered chunk was pure RSS with no overlap benefit (the native
    parse is faster than chunk consumption).

    However the consumer leaves (the end of the input, a `break`, an
    exception), the parse thread (named PUMP_THREAD) is stopped and joined
    before the native reader is closed: closing it under a running parse
    crashes the process.

    The pump's spans go to `timer`, marked with the chunk's index in the
    file: `feed.token-wait` (for chunk i's build token) and `feed.parse`
    (buffer allocation and the native parse, in packed mode the planes'
    pack too; the parse that finds the end of the input marks none).
    `packed_half` is NativeReader's."""
    timer = timer or PhaseTimer()
    rdr = NativeReader(path, chunk_reads, max_len,
                       mean_len_hint=mean_len_hint, start=start,
                       packed_half=packed_half)
    q: queue.Queue = queue.Queue(maxsize=depth)
    build_tokens = threading.Semaphore(depth)
    stop = threading.Event()
    _SENTINEL = object()

    def pump():
        try:
            for i in itertools.count():
                with timer.phase("feed.token-wait", i):
                    build_tokens.acquire()
                if stop.is_set():
                    return
                with timer.phase("feed.parse") as span:
                    c = rdr.next_chunk()
                    if c is not None:
                        span["chunk"] = i
                if c is None:
                    q.put(_SENTINEL)
                    return
                q.put(c)
        except BaseException as e:  # surface parse errors on the consumer
            q.put(e)

    t = threading.Thread(target=pump, name=PUMP_THREAD, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            build_tokens.release()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # tokens bound the queue to `depth` items, so the pump never blocks
        # in put(); the extra token wakes it if it waits for one
        stop.set()
        build_tokens.release()
        while not q.empty():
            q.get_nowait()
        t.join()
        rdr.close()
