"""Synthetic HiFi-like read sets at arbitrary scale.

Generates a random genome and coverage-sampled reads with a residual
substitution error model (what remains of HiFi errors after HPC), written as
FASTA fast enough to build 10-100 Gbp benchmark inputs: reads are synthesized
in vectorized numpy blocks and written as one buffer per block.

CLI: python -m rust_mdbg_tpu_torch.experiments.synth out.fa --genome-mbp 200 --coverage 50
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.seq import CODE_BASE


def segdup_genome(rng, G: int, repeat_frac: float) -> np.ndarray:
    """Random genome whose last repeat_frac is exact copies of 10-100 kb
    segments of the unique part (segmental duplications: multi-locus
    k-min-mers, as in bench.py's corpus)."""
    core = rng.integers(0, 4, int(G * (1 - repeat_frac))).astype(np.uint8)
    parts = [core]
    rem = G - core.size
    while rem > 0:
        seg = int(min(rem, rng.integers(10_000, 100_000)))
        src = int(rng.integers(0, core.size - seg))
        parts.append(core[src : src + seg])
        rem -= seg
    return np.concatenate(parts)


def write_synthetic_reads(path: str, genome_mbp: float = 20,
                          coverage: float = 52, read_len: int = 24000,
                          error_rate: float = 0.0005, seed: int = 0,
                          block_reads: int = 2048,
                          repeat_frac: float = 0.0,
                          genome_out: str | None = None) -> dict:
    """Write a synthetic FASTA; returns {n_reads, total_bases, genome_size}.

    repeat_frac > 0 makes that share of the genome segmental duplications
    (segdup_genome).  genome_out also writes the genome itself, as one FASTA
    record (an input for --reference)."""
    rng = np.random.default_rng(seed)
    G = int(genome_mbp * 1_000_000)
    if repeat_frac > 0:
        genome = segdup_genome(rng, G, repeat_frac)
    else:
        genome = rng.integers(0, 4, G, dtype=np.int64).astype(np.uint8)
    if genome_out is not None:
        with open(genome_out, "wb") as f:
            f.write(b">genome\n" + CODE_BASE[genome].tobytes() + b"\n")
    n_reads = int(G * coverage) // read_len
    total = 0
    with open(path, "wb", buffering=1 << 22) as f:
        for b0 in range(0, n_reads, block_reads):
            nb = min(block_reads, n_reads - b0)
            starts = rng.integers(0, G - read_len, nb)
            block = genome[starts[:, None]
                           + np.arange(read_len, dtype=np.int64)[None, :]]
            if error_rate > 0:
                nerr = int(nb * read_len * error_rate)
                er = rng.integers(0, nb, nerr)
                ec = rng.integers(0, read_len, nerr)
                block[er, ec] = (block[er, ec]
                                 + rng.integers(1, 4, nerr).astype(np.uint8)) % 4
            ascii_block = CODE_BASE[block]
            out = bytearray()
            for i in range(nb):
                out += b">r%d_%d\n" % (b0 + i, starts[i])
                out += ascii_block[i].tobytes()
                out += b"\n"
            f.write(out)
            total += nb * read_len
    return dict(n_reads=n_reads, total_bases=total, genome_size=G)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="synth-reads")
    ap.add_argument("out")
    ap.add_argument("--genome-mbp", type=float, default=20)
    ap.add_argument("--coverage", type=float, default=52)
    ap.add_argument("--read-len", type=int, default=24000)
    ap.add_argument("--error-rate", type=float, default=0.0005)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    s = write_synthetic_reads(a.out, a.genome_mbp, a.coverage, a.read_len,
                              a.error_rate, a.seed)
    print(f"wrote {s['n_reads']} reads, {s['total_bases']/1e9:.3f} Gbp "
          f"(genome {s['genome_size']/1e6:.1f} Mbp)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
