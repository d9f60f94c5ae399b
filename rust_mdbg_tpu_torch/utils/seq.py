"""Base-space and minimizer-space sequence helpers.

Behavioral parity targets:
- `revcomp` — rust-mdbg src/utils.rs:3-24 (unknown bases map to 'N',
  'u'/'U' map to 'a'/'A'-complement style: U -> A).
- `normalize_vec` — rust-mdbg src/utils.rs:36-40 (lexicographic min of a
  u64 vector and its reversal; used for EC bucketing keys).
- `pretty_minvec` — rust-mdbg src/utils.rs:27-33 (debug display).
"""

from __future__ import annotations

import numpy as np

_COMP = {
    "a": "t", "c": "g", "t": "a", "g": "c", "u": "a",
    "A": "T", "C": "G", "T": "A", "G": "C", "U": "A",
}

_COMP_TABLE = bytes(
    ord(_COMP.get(chr(b), "N")) for b in range(256)
)


def revcomp(dna: str) -> str:
    """Reverse complement; any unrecognized character becomes 'N'."""
    return dna.translate(_TRANS)[::-1]


_TRANS = str.maketrans({chr(b): chr(_COMP_TABLE[b]) for b in range(256)})


def normalize_vec(seq) -> tuple:
    """Canonical form of an arbitrary-length minimizer vector: min(seq, reversed)."""
    s = tuple(int(x) for x in seq)
    r = s[::-1]
    return s if s <= r else r


def pretty_minvec(seq) -> str:
    """First two digits of each minimizer hash, space-separated."""
    return "".join(f"{str(int(x))[:2]} " for x in seq)


# --- base codes ------------------------------------------------------------
# Codes: A=0 C=1 G=2 T=3 N=4 other=5.  Matches the 2-bit layout of the
# reference's SEQ_NT4_TABLE (rust-mdbg src/read.rs:23-39) for ACGT;
# lowercase maps to the same codes (the reference's ntHash panics on lowercase,
# so valid reference inputs are uppercase-only and parity is unaffected).
BASE_CODE = np.full(256, 5, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    BASE_CODE[ord(_c)] = _i
    BASE_CODE[ord(_c.lower())] = _i
BASE_CODE[ord("N")] = 4
BASE_CODE[ord("n")] = 4

CODE_BASE = np.frombuffer(b"ACGTNN", dtype=np.uint8)


def encode_bases(seq: bytes | str) -> np.ndarray:
    """Byte string -> uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode()
    return BASE_CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode_bases(codes: np.ndarray) -> str:
    return CODE_BASE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()
