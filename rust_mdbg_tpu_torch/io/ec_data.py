""".ec_data serde: 5 plain-text lines per read (id, seq, transformed,
minimizer strings, positions).

Parity: rust-mdbg src/ec_reads.rs:33-39 (write), 52-76 (load).
Used for EC checkpointing (`--restart-from-postcor`) and evaluation tooling.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EcRecord:
    seq_id: str
    seq_str: str
    read_transformed: list
    read_minimizers: list
    read_minimizers_pos: list


def make_filename(prefix: str) -> str:
    return f"{prefix}.ec_data"


class EcWriter:
    def __init__(self, prefix: str):
        self._f = open(make_filename(prefix), "w")

    def record(self, seq_id, seq_str, transformed, minimizers, positions):
        f = self._f
        f.write(f"{seq_id}\n{seq_str}\n")
        f.write(" ".join(str(int(x)) for x in transformed) + "\n")
        f.write(" ".join(str(x) for x in minimizers) + "\n")
        f.write(" ".join(str(int(x)) for x in positions) + "\n")

    def record_poa(self, seq_id: str, poa_ids: list):
        self._f.write(seq_id + "\t" + "\t".join(poa_ids) + "\n")

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def load(prefix: str) -> list[EcRecord]:
    res = []
    with open(make_filename(prefix)) as f:
        while True:
            seq_id = f.readline()
            if not seq_id:
                break
            seq_id = seq_id.strip()
            seq_str = f.readline().strip()
            transformed = [int(x) for x in f.readline().split()]
            minimizers = f.readline().split()
            positions = [int(x) for x in f.readline().split()]
            res.append(EcRecord(seq_id, seq_str, transformed, minimizers, positions))
    return res
