"""Generated corpora shared by the port's whole-slice tests (no test reads
an external file): synthetic raw reads with ragged lengths, N runs and an
'other' base, and the same reads with every homopolymer run collapsed."""

import json
import re

import numpy as np

from rust_mdbg_tpu.io.sequences import iter_sequences
from rust_mdbg_tpu_torch.experiments.synth import write_synthetic_reads


def write_raw_reads(path: str, genome_mbp=0.03, coverage=20, read_len=1500,
                    error_rate=0.003, seed=11) -> str:
    """Reads over a genome with 20% segmental duplications; a third are cut
    short and some carry N runs or an 'other' base."""
    write_synthetic_reads(path + ".tmp", genome_mbp=genome_mbp,
                          coverage=coverage, read_len=read_len,
                          error_rate=error_rate, seed=seed, repeat_frac=0.2)
    rng = np.random.default_rng(seed + 1)
    out = []
    with open(path + ".tmp") as f:
        lines = f.read().split("\n")
    for name, seq in zip(lines[0::2], lines[1::2]):
        s = bytearray(seq.encode())
        if rng.random() < 0.33:
            s = s[: int(rng.integers(read_len // 5, read_len))]
        if rng.random() < 0.1:
            j = int(rng.integers(0, len(s) - 4))
            s[j : j + 3] = b"NNN"
        if rng.random() < 0.05:
            s[int(rng.integers(0, len(s)))] = ord("R")
        out.append(f"{name}\n{s.decode()}\n")
    with open(path, "w") as f:
        f.write("".join(out))
    return path


def write_hpc_reads(raw_path: str, path: str) -> str:
    """raw_path with homopolymer runs collapsed: input for
    reads_already_hpc=True (recompute mode)."""
    with open(raw_path) as f, open(path, "w") as out:
        for line in f:
            out.write(line if line.startswith(">")
                      else re.sub(r"(.)\1+", r"\1", line))
    return path


def records(prefix: str) -> list:
    return sorted(json.dumps(r, sort_keys=True, default=str)
                  for r in iter_sequences(prefix))


def gfa_bytes(prefix: str) -> bytes:
    with open(prefix + ".gfa", "rb") as f:
        return f.read()
