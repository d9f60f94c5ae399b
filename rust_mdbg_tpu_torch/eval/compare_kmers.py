"""k-min-mer recovery: set-compare two runs' .sequences files.

A host copy of the JAX package's `eval/compare_kmers.py` (same output).
Capability parity with the reference's utils/compare_kmers.py: run the assembler on a genome
(`--reference --minabund 1`) and on reads, then compare the canonical
k-min-mer sets (genomic vs erroneous recovery), with ASCII abundance
histograms (abundances read from each prefix's .gfa KC tags).

Run: python -m rust_mdbg_tpu_torch.eval.compare_kmers <genome_prefix> <reads_prefix>
"""

from __future__ import annotations

import sys

from ..io.sequences import iter_sequences


def parse_gfa_abundance(prefix: str) -> dict[int, int]:
    ab = {}
    with open(prefix + ".gfa") as f:
        for line in f:
            if line.startswith("S"):
                v = line.rstrip("\n").split("\t")
                for t in v:
                    if t.startswith("KC:i:"):
                        ab[int(v[1])] = int(t[5:])
    return ab


def load_kmers(prefix: str):
    """{canonical minimizer tuple -> node index} from .sequences shards."""
    return {r["minimizers"]: r["index"] for r in iter_sequences(prefix)}


def ascii_histogram(samples, bins=20, width=50, lo=0, hi=500):
    if not samples:
        return
    step = max(1, (hi - lo) // bins)
    counts = [0] * bins
    for s in samples:
        b = min(bins - 1, max(0, (s - lo) // step))
        counts[b] += 1
    mx = max(counts)
    for i, c in enumerate(counts):
        bar = "#" * (c * width // max(1, mx))
        print(f"{lo + i * step:5d}-{lo + (i + 1) * step - 1:<5d} {c:8d} {bar}")


def compare(prefix1: str, prefix2: str):
    k1 = load_kmers(prefix1)
    k2 = load_kmers(prefix2)
    set1, set2 = set(k1), set(k2)
    inter = set1 & set2
    print(f"{len(set1)} kmers in {prefix1}")
    print(f"{len(set2)} kmers in {prefix2}")
    pct = 100.0 * len(inter) / max(1, len(set1))
    print(f"kmers from {prefix1} found in {prefix2}: {len(inter)} "
          f"({pct:.2f}%), {len(set1) - len(inter)} missing")
    ab2 = parse_gfa_abundance(prefix2)
    genomic = [ab2[k2[m]] for m in inter if k2[m] in ab2]
    erroneous = [ab2[k2[m]] for m in (set2 - set1) if k2[m] in ab2]
    print("\nabundance of genomic k-min-mers in", prefix2)
    ascii_histogram(genomic)
    print("\nabundance of non-genomic k-min-mers in", prefix2)
    ascii_histogram(erroneous)
    return dict(n1=len(set1), n2=len(set2), shared=len(inter),
                recovery_pct=pct)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    compare(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
