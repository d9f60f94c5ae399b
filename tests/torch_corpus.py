"""Generated corpora shared by the port's whole-slice tests (no test reads
an external file): synthetic raw reads with ragged lengths, N runs and an
'other' base, and the same reads with every homopolymer run collapsed."""

import json
import os
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


#: the per-read files of an error-correction run
EC_FILES = (".ec_data", ".postcor.ec_data", ".poa.ec_data")

#: the EC tests' Params (tests/test_ec_procs.py's)
EC_KW = dict(k=4, l=8, density=0.05, min_kmer_abundance=2,
             error_correct=True, n=2)


def ec_params(cls, fields: dict, triage: bool, engine: str):
    """EC Params of `cls` (the port's or the JAX package's) with `fields`;
    triage False sets ec_fast_triage off (exact double alignment), as
    tests/test_poa_device.py does."""
    p = cls(**{"engine": engine, **EC_KW, **fields})
    if not triage:
        object.__setattr__(p, "ec_fast_triage", False)
    return p


def write_noisy_reads(path, seed, n_reads, genome_len, read_len, n_err):
    """tests/test_ec_procs.py's generator: reads at random starts of a
    random genome, n_err random substitutions each."""
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, genome_len))
    with open(path, "w") as f:
        for i in range(n_reads):
            start = int(rng.integers(0, genome_len - read_len))
            read = list(genome[start : start + read_len])
            for _ in range(n_err):
                p = int(rng.integers(0, len(read)))
                read[p] = "ACGT"[int(rng.integers(0, 4))]
            f.write(f">r{i}\n{''.join(read)}\n")
    return str(path)


def ec_outputs(prefix: str) -> dict:
    """Bytes of every output of an EC run: the three EC files, the GFA and
    the .sequences shards."""
    d, base = os.path.split(prefix)
    out = {ext: open(prefix + ext, "rb").read()
           for ext in EC_FILES + (".gfa",) if os.path.exists(prefix + ext)}
    for f in sorted(os.listdir(d)):
        if f.startswith(base + ".") and f.endswith(".sequences"):
            out[f[len(base):]] = open(os.path.join(d, f), "rb").read()
    return out
