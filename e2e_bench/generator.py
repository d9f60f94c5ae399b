"""Seeded HiFi-like read corpora, written as FASTA.

A copy of the port's `experiments/synth.py` (the segmental-duplication
genome of `bench.py`), extended with what a configuration file states: a
read-length distribution, and an error model of substitutions and
homopolymer run-length changes.  Reads are drawn raw, from a raw genome;
where the configuration feeds them homopolymer-compressed
(`params.reads_already_hpc`), each read is compressed as a user's
preprocessing would, so that both kinds of cell share one model of the
sequencer.  It reads only the configuration's numbers, so a new
configuration is a new file under `configs/`.

The multiset of read lengths and the segment sizes of the duplications
come from the configuration's own `length_seed`; `--seed` draws the
genome's bases, where each duplication is copied from, the order of the
reads in the file, their starts, strands and errors.  Every seed
therefore gives the same amount of work in another arrangement, as two
runs of one library would.  The program plans its staging width from the
first reads of a file, so the order can change its plan: the run prints
the bytes it staged a read base.

Reads are cut from the genome and its reverse complement as bytes and
changed in place, a block of reads at a time, so that a gigabase is
written in seconds.
"""

from __future__ import annotations

import os

import numpy as np

#: the four bases, in code order
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
#: ASCII -> base code (A C G T -> 0..3)
ASCII_CODE = np.zeros(256, dtype=np.uint8)
ASCII_CODE[BASES] = np.arange(4, dtype=np.uint8)
COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")
#: reads per block changed at once (bounds the generator's memory)
BLOCK_READS = 4096


def read_lengths(cfg: dict) -> np.ndarray:
    """The configuration's raw read lengths, in the order `length_seed`
    draws them: as many reads as its coverage of its genome asks for at
    the mean length, each drawn from the clipped normal."""
    rl = cfg["read_len"]
    G = int(cfg["genome_mbp"] * 1_000_000)
    n = int(round(cfg["coverage"] * G / rl["mean"]))
    rng = np.random.default_rng(cfg["length_seed"])
    lens = np.rint(rng.normal(rl["mean"], rl["sd"], n))
    return np.clip(lens, rl["min"], rl["max"]).astype(np.int64)


def make_genome(cfg: dict, rng) -> bytes:
    """ASCII bases of a raw genome of `genome_mbp` whose last
    `repeat_frac` is copies of segments of the unique part."""
    G = int(cfg["genome_mbp"] * 1_000_000)
    n_core = int(G * (1 - cfg["repeat_frac"]))
    core = rng.integers(0, 4, n_core).astype(np.uint8)
    lo, hi = cfg["segdup_bp"]
    seg_rng = np.random.default_rng(cfg["length_seed"] + 1)
    parts = [core]
    rem = G - n_core
    while rem > 0:
        seg = int(min(rem, seg_rng.integers(lo, hi)))
        src = int(rng.integers(0, n_core - seg))
        parts.append(core[src : src + seg])
        rem -= seg
    return BASES[np.concatenate(parts)].tobytes()


def _block(cfg: dict, rng, fwd: bytes, rc: bytes, lens: np.ndarray):
    """One block of reads: the ASCII bases of the reads end to end and
    their lengths, after strands and errors; and where each was cut from
    (start on the genome, reverse strand or not)."""
    G = len(fwd)
    n = lens.size
    starts = rng.integers(0, G - lens + 1)
    rev = rng.random(n) < 0.5
    seq = np.frombuffer(bytearray(b"".join(
        rc[G - s - m : G - s] if r else fwd[s : s + m]
        for s, m, r in zip(starts.tolist(), lens.tolist(), rev.tolist()))),
        dtype=np.uint8)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])

    def positions(rate):
        count = np.rint(rate * lens).astype(np.int64)
        rid = np.repeat(np.arange(n), count)
        return rid, off[rid] + (rng.random(rid.size) * lens[rid]).astype(
            np.int64)

    err = cfg["errors"]
    _, at = positions(err["substitution"])
    seq[at] = BASES[(ASCII_CODE[seq[at]] + rng.integers(1, 4, at.size)) % 4]
    if err["homopolymer"]:
        rid, at = positions(err["homopolymer"])
        at, keep = np.unique(at, return_index=True)
        rid = rid[keep]
        grow = rng.random(at.size) < 0.5
        # a deletion only where the base has a twin beside it in its read,
        # so that the HPC sequence keeps it; a copy of the base otherwise
        twin_prev = (at > off[rid]) & (seq[np.maximum(at - 1, 0)] == seq[at])
        nxt = np.minimum(at + 1, seq.size - 1)
        twin_next = (at + 1 < off[rid + 1]) & (seq[nxt] == seq[at])
        shrink = ~grow & (twin_prev | twin_next)
        lens = lens + np.bincount(rid, weights=np.where(shrink, -1, 1),
                                  minlength=n).astype(np.int64)
        seq = np.delete(seq, at[shrink])
        # positions in the shortened sequence of the bases to copy
        ins = at[~shrink] - np.searchsorted(at[shrink], at[~shrink])
        seq = np.insert(seq, ins + 1, seq[ins])
    return seq, lens, starts, rev


def hpc_reads(seq: np.ndarray, lens: np.ndarray):
    """Reads end to end, homopolymer-compressed one by one: a base equal
    to the one before it in its read is dropped.  The bases and the new
    lengths."""
    keep = np.empty(seq.size, dtype=bool)
    keep[0] = True
    np.not_equal(seq[1:], seq[:-1], out=keep[1:])
    off = np.zeros(lens.size + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    keep[off[:-1]] = True
    at = np.flatnonzero(keep)
    return seq.take(at), np.diff(np.searchsorted(at, off))


def write_corpus(cfg: dict, seed: int, path: str,
                 share: float = 1.0) -> dict:
    """Write the configuration's reads for `seed` to `path` as FASTA (a
    header line `>r<i>` and one sequence line a read).  Returns the
    corpus's counts: reads, bases, bytes, and the bytes of the file's
    first `share` of reads."""
    rng = np.random.default_rng(seed)
    fwd = make_genome(cfg, rng)
    rc = fwd.translate(COMPLEMENT)[::-1]
    lens_all = rng.permutation(read_lengths(cfg))
    hpc = cfg["params"]["reads_already_hpc"]
    mark = int(np.ceil(share * lens_all.size))
    share_bytes = None
    bases = 0
    with open(path, "wb", buffering=1 << 22) as f:
        for b0 in range(0, lens_all.size, BLOCK_READS):
            seq, lens, _, _ = _block(cfg, rng, fwd, rc,
                                     lens_all[b0 : b0 + BLOCK_READS])
            if hpc:
                seq, lens = hpc_reads(seq, lens)
            bases += int(lens.sum())
            view = memoryview(seq)
            a = 0
            for i, m in enumerate(lens.tolist()):
                if b0 + i == mark:
                    share_bytes = f.tell()
                f.write(b">r%d\n" % (b0 + i))
                f.write(view[a : a + m])
                f.write(b"\n")
                a += m
        size = f.tell()
        share_bytes = size if share_bytes is None else share_bytes
        # on disk before the jobs start, so that its writeback does not
        # fall into the measured window
        f.flush()
        os.fsync(f.fileno())
    return dict(reads=int(lens_all.size), bases=bases, fasta_bytes=size,
                share_bytes=share_bytes)
