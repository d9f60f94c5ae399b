"""The comparison that decides `correct`: a job's .gfa and .sequences
records against the plain reference's, at the limits below.

Every GFA line is compared in place (header, S lines in id order, L lines
in the order the node loop finds them).  The .sequences files are decoded
whole and the node id of every record counted: each of the reference's
nodes has to have exactly one record, and no record another id.  The
records themselves are compared on a sample drawn from the seed: whole
LZ4 blocks of the job's .sequences files, every complete record in them
against the reference's record of its node id.
"""

from __future__ import annotations

import glob

import numpy as np

from . import lz4frame

#: each compared number and the most it may read (exact comparisons)
LIMITS = {"gfa_lines_differ": 0, "record_ids_differ": 0,
          "records_differ": 0}
#: the most digits a node id has
ID_DIGITS = 12
#: LZ4 blocks of .sequences decoded a check
SAMPLE_BLOCKS = 12


def lines_differ(act: list, exp: list) -> int:
    """Lines that differ in place, and lines one side has and the other
    has not."""
    return (sum(a != b for a, b in zip(act, exp))
            + abs(len(act) - len(exp)))


def record_ids(text: bytes) -> np.ndarray:
    """The node id that begins each record line of a decoded .sequences
    file (-1 where a line does not begin with digits and a tab)."""
    a = np.frombuffer(text, dtype=np.uint8)
    starts = np.flatnonzero(a == 10) + 1
    starts = np.concatenate([[0], starts[starts < a.size]])
    starts = starts[a[starts] != ord("#")]
    pad = np.concatenate([a, np.zeros(ID_DIGITS + 1, dtype=np.uint8)])
    ids = np.zeros(starts.size, dtype=np.int64)
    open_ = np.ones(starts.size, dtype=bool)
    ok = np.zeros(starts.size, dtype=bool)
    for j in range(ID_DIGITS + 1):
        c = pad[starts + j].astype(np.int64)
        ok |= open_ & (c == 9) & (j > 0)
        open_ &= (c >= 48) & (c <= 57)
        ids = np.where(open_, ids * 10 + c - 48, ids)
    return np.where(ok, ids, -1)


def ids_differ(ids: np.ndarray, n: int) -> int:
    """Records whose id is no node's, nodes without a record, and records
    past a node's first."""
    ids = np.asarray(ids, dtype=np.int64)
    inside = (ids >= 0) & (ids < n)
    count = np.bincount(ids[inside], minlength=n)
    return int((~inside).sum() + np.abs(count - 1).sum())


def read_sequences(prefix: str) -> dict:
    """The bytes of each of the prefix.*.sequences files, by path."""
    data = {}
    for p in sorted(glob.glob(f"{prefix}.*.sequences")):
        with open(p, "rb") as f:
            data[p] = f.read()
    return data


def all_record_ids(data: dict) -> np.ndarray:
    """The node ids of every record of the files."""
    ids = [record_ids(lz4frame.decode(d)) for d in data.values()]
    return np.concatenate(ids) if ids else np.zeros(0, dtype=np.int64)


def sampled_records(data: dict, seed: int, n_blocks: int = SAMPLE_BLOCKS):
    """(node id, line) of every complete record in `n_blocks` blocks drawn
    by `seed` from the files."""
    found = []
    for p in data:
        found += [(p, fr, b) for fr, b, *_ in lz4frame.blocks(data[p])]
    rng = np.random.default_rng(seed)
    pick = sorted(rng.choice(len(found), min(n_blocks, len(found)),
                             replace=False).tolist()) if found else []
    out = []
    for i in pick:
        path, fr, b = found[i]
        lines = _block_text(data[path], fr, b).split(b"\n")
        # a record cut by the block's start or end is not whole
        for line in lines[(0 if b == 0 else 1) : -1]:
            if line and not line.startswith(b"#"):
                out.append((int(line.split(b"\t", 1)[0]), line.decode()))
    return out


def _block_text(data: bytes, frame: int, block: int) -> bytes:
    """The decoded bytes of one block (decoding its frame up to it where
    the frame's blocks are linked)."""
    prev = b""
    for fr, b, independent, stored, payload in lz4frame.blocks(data):
        if fr != frame or (independent and b != block):
            continue
        text = payload if stored else lz4frame.decode_block(
            payload, b"" if independent else prev[-65536:])
        if b == block:
            return text
        prev = text
    raise ValueError("block not found")


def compare(gfa_lines: list, records: list, ids, graph, reads) -> dict:
    """The compared numbers: GFA lines that differ from the reference's,
    record ids (`ids`, of every record) that are not one a node, and
    sampled records that differ from (or are not) a reference node's."""
    n = graph.vec.shape[0]
    rec_bad = 0
    for i, line in records:
        if not 0 <= i < n or line != graph.record(reads, i):
            rec_bad += 1
    return dict(gfa_lines_differ=lines_differ(gfa_lines, graph.gfa_lines),
                record_ids_differ=ids_differ(ids, n),
                records_differ=rec_bad)


def check_job(prefix: str, seed: int, graph, reads) -> tuple[dict, int]:
    """compare() on the files of the job written to `prefix`; also the
    number of records checked."""
    try:
        with open(f"{prefix}.gfa") as f:
            act = f.read().splitlines()
    except FileNotFoundError:
        act = []
    data = read_sequences(prefix)
    records = sampled_records(data, seed)
    ids = all_record_ids(data)
    return compare(act, records, ids, graph, reads), len(records)


def passed(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
