"""FASTA/FASTQ input: streaming readers and fixed-shape device batches.

Parity targets:
- reader construction by extension (.gz / .lz4 / plain),
  rust-mdbg src/main.rs:163-178
- format sniffing by filename, main.rs:461-467
- `read_first_n_reads` mean/max length sampling, main.rs:180-212
- reference mode strips newlines from multi-line FASTA (handled naturally by
  whole-record parsing here; main.rs:737-739)

The TPU replacement for the reference's seq_io parallel record pump
(main.rs:834-838) is `batches()`: reads are packed into fixed-shape uint8
code tensors [B, L] + length vectors, ready for device transfer; raw bytes and
ids ride along for host-side sequence extraction.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Iterator

import numpy as np

from ..utils.alloc import full_fast

from ..utils.seq import BASE_CODE


def is_fasta(path: str) -> bool:
    """Filename-based format sniff (main.rs:461-467)."""
    name = os.path.basename(str(path))
    return (
        ".fasta." in name or ".fa." in name
        or name.endswith(".fa") or name.endswith(".fasta")
    )


def open_stream(path: str):
    """Binary stream for plain / .gz / .lz4 files (main.rs:163-178)."""
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rb")
    if p.endswith(".lz4"):
        import io as _io
        from . import lz4f

        with open(p, "rb") as f:
            return _io.BytesIO(lz4f.decompress(f.read()))
    return open(p, "rb")


def read_records(path: str) -> Iterator[tuple[str, bytes]]:
    """Yield (id, seq_bytes). FASTA records may span lines; FASTQ is 4-line.

    The id is the header token up to the first whitespace (seq_io's record.id()).
    """
    fasta = is_fasta(path)
    with open_stream(path) as f:
        if fasta:
            name = None
            chunks: list[bytes] = []
            for line in f:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        yield name, b"".join(chunks)
                    name = line[1:].split()[0].decode() if len(line) > 1 else ""
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None:
                yield name, b"".join(chunks)
        else:
            while True:
                hdr = f.readline()
                if not hdr:
                    break
                seq = f.readline().rstrip(b"\r\n")
                f.readline()  # +
                f.readline()  # quals
                yield hdr[1:].split()[0].decode(), seq


def read_first_n_reads(path: str, max_reads: int = 100) -> tuple[int, int]:
    """(mean_length, max_length) over the first max_reads records (main.rs:180-212)."""
    mean = 0
    mx = 0
    n = 0
    for _, seq in read_records(path):
        mean += len(seq)
        mx = max(mx, len(seq))
        n += 1
        if n == max_reads:
            break
    if n == 0:
        raise ValueError(f"no records in {path}")
    return mean // n, mx


@dataclasses.dataclass
class ReadBatch:
    """A fixed-shape batch of reads.

    codes: uint8 [B, L] base codes (padded with 5 = 'other')
    lengths: int32 [B] true lengths (0 rows are padding)
    ids: list of read names (len B, padding rows have "")
    raw: list of raw sequence bytes (for host-side .sequences extraction)
    start_index: global index of first read in this batch
    """

    codes: np.ndarray
    lengths: np.ndarray
    ids: list
    raw: list
    start_index: int

    @property
    def n_reads(self) -> int:
        return int((self.lengths > 0).sum())


def batches(
    path: str,
    batch_reads: int,
    max_len: int,
    keep_raw: bool = True,
) -> Iterator[ReadBatch]:
    """Pack records into fixed-shape batches.

    Reads longer than max_len are carried in overflow batches of shape [1, len]
    rounded up to a multiple of max_len (rare; keeps the common-path shapes
    static for XLA compilation caching).
    """
    buf_ids: list[str] = []
    buf_raw: list[bytes] = []
    start = 0
    count = 0

    def flush():
        nonlocal buf_ids, buf_raw, start
        if not buf_ids:
            return None
        B = batch_reads
        codes = full_fast((B, max_len), 5, np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        for i, s in enumerate(buf_raw):
            c = BASE_CODE[np.frombuffer(s, dtype=np.uint8)]
            codes[i, : len(c)] = c
            lengths[i] = len(c)
        ids = buf_ids + [""] * (B - len(buf_ids))
        raw = buf_raw + [b""] * (B - len(buf_raw))
        b = ReadBatch(codes, lengths, ids, raw if keep_raw else [], start)
        buf_ids, buf_raw = [], []
        start = count
        return b

    for name, seq in read_records(path):
        if len(seq) > max_len:
            b = flush()
            if b is not None:
                yield b
            L = ((len(seq) + max_len - 1) // max_len) * max_len
            codes = full_fast((1, L), 5, np.uint8)
            c = BASE_CODE[np.frombuffer(seq, dtype=np.uint8)]
            codes[0, : len(c)] = c
            yield ReadBatch(
                codes,
                np.array([len(c)], dtype=np.int32),
                [name],
                [seq] if keep_raw else [],
                count,
            )
            count += 1
            start = count
            continue
        buf_ids.append(name)
        buf_raw.append(seq)
        count += 1
        if len(buf_ids) == batch_reads:
            b = flush()
            if b is not None:
                yield b
    b = flush()
    if b is not None:
        yield b
