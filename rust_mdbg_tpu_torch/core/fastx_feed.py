"""Chunk feed for the chunked device driver: native parse + prefetch.

Produces (codes, lengths, blob, blob_off, fill) tuples sized for one device
chunk.  The fast path is the C++ parser (native/fastx.cpp) driven through a
one-chunk-deep prefetch thread so file parsing and base encoding overlap
device compute — the TPU-side stand-in for the reference's seq_io parser
thread + worker pool (rust-mdbg src/main.rs:834-838).  Inputs the
native parser does not handle (.lz4) fall back to the pure-Python batcher.

Tuple contract (consumed by core/chunked.assemble_device_chunked):
  codes    uint8 [chunk_reads, width] base codes; width == max_len except for
           over-long reads, which arrive as singleton [1, width > max_len]
           tuples so the caller can detect them.  With `packed_half` and
           the native parser, the staged planes (packed, mask) in its
           place, as core/chunked.host_feed would make them from the codes,
           written by the parser's encode threads; over-long reads and the
           pure-Python fallback still give codes
  lengths  int32 [chunk_reads]; rows >= fill are 0
  blob     uint8 concatenated raw sequence bytes of the fill reads
  blob_off int64 [fill+1] per-row offsets into blob
  fill     number of real reads (dense prefix of the rows)
"""

from __future__ import annotations

import numpy as np

from ..utils.alloc import full_fast
from ..utils.timing import PhaseTimer

from ..io import fastx


def stream_chunks(path: str, chunk_reads: int, batch_reads: int,
                  max_len: int, mean_len: int = 0, start: int = 0,
                  timer: PhaseTimer | None = None,
                  packed_half: int | None = None):
    """Yield chunk tuples for `path`; native parser when supported.
    `start` (native parser only): the byte offset of the first record.
    `timer` records the native parse thread's spans.  `packed_half`, a
    packed plan's half width (0 = none; io/fastx_native.NativeReader), has
    the native parser yield the staged planes (the module's tuple
    contract)."""
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
    codes = full_fast((chunk_reads, max_len), 5, np.uint8)
    lens = np.zeros(chunk_reads, dtype=np.int32)
    raw_list: list[bytes] = []
    fill = 0

    def finish():
        off = np.zeros(len(raw_list) + 1, dtype=np.int64)
        np.cumsum([len(r) for r in raw_list], out=off[1:])
        blob = np.frombuffer(b"".join(raw_list), dtype=np.uint8)
        return codes, lens, blob, off, fill

    for batch in fastx.batches(path, batch_reads, max_len):
        if batch.codes.shape[1] != max_len:
            # over-long singleton batch: flush, then pass it through
            if fill:
                yield finish()
                codes = full_fast((chunk_reads, max_len), 5, np.uint8)
                lens = np.zeros(chunk_reads, dtype=np.int32)
                raw_list = []
                fill = 0
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
            codes = full_fast((chunk_reads, max_len), 5, np.uint8)
            lens = np.zeros(chunk_reads, dtype=np.int32)
            raw_list = []
            fill = 0
    if fill:
        yield finish()
