"""Homopolymer-compress a FASTA/FASTQ file (utils/remove_homopoly.py).

The reference's headline benchmark protocol feeds pre-HPC'd reads
(README.md:133-135); this produces them.  Also `gfa-strip` (the reference's
utils/gfa_strip_sequences): replace S-line sequences with '*' + LN tag.

Run: python -m rust_mdbg_tpu_torch hpc-compress <in.fa[.gz]> <out.fa>
     python -m rust_mdbg_tpu_torch gfa-strip <in.gfa> <out.gfa>
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.fastx import read_records
from ..ops.hpc import hpc_mask_np
from ..utils.seq import encode_bases


def hpc_compress(in_path: str, out_path: str):
    with open(out_path, "w") as out:
        for name, seq in read_records(in_path):
            codes = encode_bases(seq)
            keep = hpc_mask_np(codes)
            hpc = np.frombuffer(seq, dtype=np.uint8)[keep].tobytes().decode()
            out.write(f">{name}\n{hpc}\n")


def gfa_strip(in_path: str, out_path: str):
    with open(in_path) as f, open(out_path, "w") as out:
        for line in f:
            if line.startswith("S"):
                v = line.rstrip("\n").split("\t")
                if v[2] != "*":
                    ln = f"LN:i:{len(v[2])}"
                    tags = [t for t in v[3:] if not t.startswith("LN:i:")]
                    v = [v[0], v[1], "*", ln] + tags
                out.write("\t".join(v) + "\n")
            else:
                out.write(line.rstrip("\n") + "\n")


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__)
        return 2
    hpc_compress(argv[0], argv[1])
    return 0


def main_strip(argv) -> int:
    if len(argv) < 2:
        print(__doc__)
        return 2
    gfa_strip(argv[0], argv[1])
    return 0
