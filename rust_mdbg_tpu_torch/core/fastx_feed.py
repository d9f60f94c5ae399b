"""The feed: how reads reach the device, for every device driver.

`staging_plan` sizes a run from its first 100 reads; `stream_chunks` parses
chunks (the C++ parser, native/fastx.cpp, behind a one-chunk-deep prefetch
thread: the stand-in for the reference's seq_io parser thread and worker
pool, rust-mdbg src/main.rs:834-838; .lz4 falls back to the pure-Python
batcher); `StagedFeed` stages them on the device one chunk ahead, for the
chunked driver and the whole-run pass; `staged_rounds` and `to_device` pack
and copy the sharded drivers' rounds (parallel/pipeline.exact_rounds).

A staged chunk is two planes (ops/pack): 2-bit values [rows, W/4] and the
invalid mask [rows, W/8], W the half width L_half where every read of the
chunk fits it, else L.  L is a multiple of 8 on every route.  The native
parser writes the planes in its parallel encode (`packed_half`); host_feed
packs every other chunk's codes (an over-long read, the .lz4 fallback, the
sharded rounds).

stream_chunks' tuples: (codes uint8 [chunk_reads, max_len], or the native
parser's planes with `packed_half`; lengths int32 [chunk_reads], 0 past
fill; blob, the fill reads' raw bytes; blob_off int64 [fill + 1]; fill).
An over-long read comes alone, as codes [1, width > max_len].

StagedFeed's spans, a chunk's marked with its index in the feed: on the
staging thread (STAGER_THREAD) `feed.next-wait`, `feed.pack` (taking the
parser's planes, or host_feed), `feed.slot-wait`, `feed.copy`,
`feed.put-wait`; on the consumer's `feed-wait`; on the parser's
(io/fastx_native.PUMP_THREAD) `feed.token-wait` and `feed.parse`.
Counters: `feed.parser_packed_chunks` and `feed.host_packed_chunks` (who
packed a chunk) and `feed.staged_high` (the most chunks alive on the
device at once).
"""

from __future__ import annotations

import os
import queue
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..io import fastx
from ..params import Params, staging_width
from ..utils.alloc import full_fast
from ..utils.timing import PhaseTimer

#: name of StagedFeed's staging thread (planes and copy)
STAGER_THREAD = "feed-stager"


def staging_plan(reads_path: str, params: Params, L: int = 0,
                 B: int = 0) -> dict:
    """The sizes every device driver stages and allocates by: the first
    100 reads' `mean_len` and `longest`; staging width L (the caller's,
    else --max-read-len rounded up to a multiple of 8, else staging_width
    of the longest); batch B (the caller's, else --batch-reads); slots M
    and w_slot a read; `input_bytes`, the file's size (x6 for .gz and .lz4,
    DNA text compressing ~3.5-4x) to estimate read counts from; L_half."""
    from ..ops.extract import capacity
    from ..ops.sort_count import window_slot_capacity

    mean_len, mx = fastx.read_first_n_reads(reads_path, 100)
    L = L or -(-params.max_read_len // 8) * 8 or staging_width(mx)
    B = B or params.batch_reads
    M = capacity(params, L)
    size = os.path.getsize(reads_path)
    if str(reads_path).endswith((".gz", ".lz4")):
        size *= 6
    return dict(
        L=L, B=B, M=M, w_slot=window_slot_capacity(params, B, L, M),
        mean_len=mean_len, longest=mx, input_bytes=size,
        # chunks whose longest read fits L/2 stage at half width (L carries
        # 2x headroom over the sampled max read length)
        L_half=L // 2 if (L // 2) % 512 == 0 and L // 2 >= 1024 else 0)


def long_read_plan(params: Params, plan: dict, length: int) -> dict:
    """The plan of an over-long read's singleton chunk (the parser hands a
    read longer than the staging width over on its own): one batch of one
    read at the width staging_width(length), with its own minimizer and
    window slots."""
    from ..ops.extract import capacity
    from ..ops.sort_count import window_slot_capacity

    L = staging_width(length)
    M = capacity(params, L)
    return dict(plan, L=L, B=1, M=M, chunk_reads=1, n_batches=1,
                w_slot=window_slot_capacity(params, 1, L, M), L_half=0)


def host_feed(codes: np.ndarray, lens: np.ndarray, fill: int,
              plan: dict) -> tuple:
    """A parsed chunk's codes as the staged planes (packed, mask) on the
    host: cut to the half width where its reads fit, then 2-bit packed.
    The native parser writes the same planes for its chunks (`packed_half`);
    this is the one host packer of every other chunk."""
    from ..ops.pack import pack_codes_np

    if codes.shape[1] != plan["L"]:
        raise ValueError(f"codes of width {codes.shape[1]} for a plan of "
                         f"staging width {plan['L']}")
    L_half = plan["L_half"]
    if L_half and int(lens[:fill].max()) <= L_half:
        codes = np.ascontiguousarray(codes[:, :L_half])
    return pack_codes_np(codes)


def to_device(planes: tuple, lens: np.ndarray, dev: torch.device) -> tuple:
    """Staged host planes and the read lengths copied to dev: (planes,
    lengths)."""
    return (tuple(torch.from_numpy(a).to(dev) for a in planes),
            torch.from_numpy(lens).to(dev))


def staged_rounds(rounds, plan: dict):
    """Rounds of stream_chunks' tuples (parallel/pipeline.exact_rounds) as
    (host planes, lengths, blob, blob_off, fill): cut to the plan's half
    width where the round's reads fit and 2-bit packed, as a chunk is
    staged."""
    for codes, lens, blob, blob_off, fill in rounds:
        yield (host_feed(codes, lens, len(lens), plan), lens, blob,
               blob_off, fill)


class StagedChunk(NamedTuple):
    """One chunk on the device: its planes and read lengths, the copy's
    CUDA event (None off CUDA), stream_chunks' blob, blob_off and fill,
    its plan (the run's, or an over-long read's own), its staged width
    and its index in the feed."""

    planes: tuple
    lens: torch.Tensor
    ready: object
    blob: np.ndarray
    blob_off: np.ndarray
    fill: int
    plan: dict
    width: int
    cid: int


class StagedFeed:
    """The chunks of `reads_path` under `plan` (chunk_reads a chunk),
    staged on `dev` one ahead of the consumer by the staging thread: the
    parser's planes or host_feed's (an over-long read widened to
    long_read_plan's width), copied on a side stream for CUDA once the
    device slot is free.  Iterating yields StagedChunk, the consumer's
    stream already waiting for its copy.  The consumer drops a chunk and
    calls release() when its construct has ended: at most one chunk is
    alive on the device during a construct, and the next copy overlaps
    what follows it.  `h2d_bytes` counts the bytes copied; leaving the
    `with` block stops the thread."""

    def __init__(self, reads_path: str, params: Params, plan: dict,
                 dev: torch.device, timer: PhaseTimer):
        self.h2d_bytes = 0
        self._params, self._plan, self._dev, self._timer = (params, plan,
                                                            dev, timer)
        self._chunks = iter(stream_chunks(
            reads_path, plan["chunk_reads"], plan["B"], plan["L"],
            plan["mean_len"], timer=timer, packed_half=plan["L_half"]))
        self._n_pulled = 0
        self._side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._slot = threading.Semaphore(1)
        # each staged chunk's 2-bit plane until the consumer frees it
        self._live: weakref.WeakSet = weakref.WeakSet()
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        for name in ("feed.parser_packed_chunks", "feed.host_packed_chunks"):
            timer.count(name, 0)
        timer.high("feed.staged_high", 0)
        self._thread = threading.Thread(target=self._run,
                                        name=STAGER_THREAD, daemon=True)
        self._thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)

    def release(self):
        """The consumer's construct of its chunk has ended and it holds the
        chunk's staged tensors no more: the stager may copy the next."""
        self._slot.release()

    def __iter__(self):
        return self

    def __next__(self) -> StagedChunk:
        with self._timer.phase("feed-wait") as span:
            item = self._q.get()
            if isinstance(item, StagedChunk):
                span["chunk"] = item.cid
        if isinstance(item, BaseException):
            raise item
        if item is None:
            raise StopIteration
        if item.ready is not None:
            # the stager copied on its own stream: wait for it, and tell
            # the allocator these tensors are used on this stream
            cur = torch.cuda.current_stream(self._dev)
            cur.wait_event(item.ready)
            for t in (*item.planes, item.lens):
                t.record_stream(cur)
        return item

    def _stage_next(self) -> StagedChunk | None:
        """The next chunk staged; None at the end of the input, or when the
        feed stops while the stager waits for the slot."""
        timer, plan = self._timer, self._plan
        while True:
            cid = self._n_pulled
            with timer.phase("feed.next-wait") as span:
                tup = next(self._chunks, None)
                if tup is not None:
                    span["chunk"] = cid
            if tup is None:
                return None
            self._n_pulled += 1
            codes, lens, blob, blob_off, fill = tup
            del tup
            if fill == 0:
                continue
            with timer.phase("feed.pack", cid):
                cplan = plan
                if isinstance(codes, tuple):  # the parser wrote the planes
                    host = codes
                    timer.count("feed.parser_packed_chunks", 1)
                else:
                    if codes.shape[1] != plan["L"]:  # an over-long read
                        cplan = long_read_plan(self._params, plan,
                                               int(lens[0]))
                        wide = np.full((1, cplan["L"]), 4, dtype=np.uint8)
                        wide[:, : codes.shape[1]] = codes
                        codes = wide
                    host = host_feed(codes, lens, fill, cplan)
                    timer.count("feed.host_packed_chunks", 1)
                del codes
            self.h2d_bytes += sum(a.nbytes for a in host) + lens.nbytes
            with timer.phase("feed.slot-wait", cid):
                while not self._slot.acquire(timeout=0.5):
                    if self._stop.is_set():
                        return None
            with timer.phase("feed.copy", cid):
                ready = None
                if self._side is not None:
                    with torch.cuda.stream(self._side):
                        planes, lens_d = to_device(host, lens, self._dev)
                        ready = torch.cuda.Event()
                        ready.record(self._side)
                else:
                    planes, lens_d = to_device(host, lens, self._dev)
                self._live.add(planes[0])
                timer.high("feed.staged_high", len(self._live))
            return StagedChunk(planes, lens_d, ready, blob, blob_off, fill,
                               cplan, host[0].shape[1] * 4, cid)

    def _run(self):
        """The staging thread: chunks into the queue of depth 1 until the
        input ends, an error (raised to the consumer) or stop."""
        while not self._stop.is_set():
            try:
                item = self._stage_next()
            except BaseException as e:  # surfaced on the consumer's thread
                item = e
            # bounded put that notices a consumer abort
            with self._timer.phase(
                    "feed.put-wait",
                    item.cid if isinstance(item, StagedChunk) else None):
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
            if not isinstance(item, StagedChunk):
                return
            del item  # the consumer alone holds a queued chunk's tensors


def stream_chunks(path: str, chunk_reads: int, batch_reads: int,
                  max_len: int, mean_len: int = 0, start: int = 0,
                  timer: PhaseTimer | None = None,
                  packed_half: int | None = None):
    """Yield chunk tuples for `path`; native parser when supported.
    `start` (native parser only): the byte offset of the first record.
    `timer` records the native parse thread's spans.  `packed_half`, a
    plan's half width (io/fastx_native.NativeReader), has the native parser
    yield the staged planes."""
    rdr = None
    from ..io import fastx_native

    if fastx_native.native_ingest_supported(path):
        try:
            rdr = fastx_native.NativeReader(
                path, chunk_reads, max_len, mean_len_hint=mean_len)
            rdr.close()  # probe only; the prefetcher reopens
        except (OSError, ImportError):
            rdr = None
    if rdr is not None:
        for c in fastx_native.chunks_prefetched(
                path, chunk_reads, max_len, mean_len_hint=mean_len,
                start=start, timer=timer, packed_half=packed_half):
            yield (c.codes if c.planes is None else c.planes, c.lengths,
                   c.raw, c.raw_off, c.n)
        return
    if start:
        raise ValueError(f"{path}: a byte offset needs the native reader")
    yield from _python_chunks(path, chunk_reads, batch_reads, max_len)


def _python_chunks(path: str, chunk_reads: int, batch_reads: int,
                   max_len: int):
    """Fallback: accumulate fixed-shape Python batches into chunk arrays."""

    def empty():
        return (full_fast((chunk_reads, max_len), 5, np.uint8),
                np.zeros(chunk_reads, dtype=np.int32), [], 0)

    def finish():
        off = np.zeros(len(raw_list) + 1, dtype=np.int64)
        np.cumsum([len(r) for r in raw_list], out=off[1:])
        blob = np.frombuffer(b"".join(raw_list), dtype=np.uint8)
        return codes, lens, blob, off, fill

    codes, lens, raw_list, fill = empty()
    for batch in fastx.batches(path, batch_reads, max_len):
        if batch.codes.shape[1] != max_len:
            # over-long singleton batch: flush, then pass it through
            if fill:
                yield finish()
                codes, lens, raw_list, fill = empty()
            blob = np.frombuffer(batch.raw[0], dtype=np.uint8) \
                if batch.raw else np.zeros(0, dtype=np.uint8)
            yield (batch.codes, batch.lengths, blob,
                   np.array([0, blob.size], dtype=np.int64), 1)
            continue
        n = batch.n_reads
        codes[fill : fill + n] = batch.codes[:n]
        lens[fill : fill + n] = batch.lengths[:n]
        raw_list.extend(batch.raw[:n])
        fill += n
        if fill == chunk_reads:
            yield finish()
            codes, lens, raw_list, fill = empty()
    if fill:
        yield finish()
