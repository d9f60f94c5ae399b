"""Pangenome graph applications: components, k-min-mer search, gene coverage.

A host copy of the JAX package's `experiments/pangenome.py` (same output).

Capability parity with the reference's 661k-genomes and AMR experiment
tooling (experiments/661k_genomes/*, experiments/amr/*):

- `components`: weakly connected components of a GFA (separate_components.py
  used networkx; this is a plain union-find), with per-component segment
  lists and size ranking
- `scan`: find which target sequences' k-min-mers occur in a collection of
  minimizer-space sequences (scan_genomes_minmers.py: both orientations of
  every k-window)
- `gene-coverage`: fraction of each target gene's k-min-mers hit
  (amr/parse_hits.py's covered-percentage output)

Run:
  python -m rust_mdbg_tpu_torch.experiments.pangenome components graph.gfa
  python -m rust_mdbg_tpu_torch.experiments.pangenome scan targets.minspace.txt corpus.txt -k 10
  python -m rust_mdbg_tpu_torch.experiments.pangenome gene-coverage targets.minspace.txt hits.txt
"""

from __future__ import annotations

import sys
from collections import defaultdict


class UnionFind:
    def __init__(self):
        self.parent: dict = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        while p != self.parent[p]:
            self.parent[p] = self.parent[self.parent[p]]
            p = self.parent[p]
        self.parent[x] = p
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def components(gfa_path: str):
    """Weakly connected components: [(size, [segments])] largest first."""
    uf = UnionFind()
    with open(gfa_path) as f:
        for line in f:
            if line.startswith("S"):
                uf.find(line.split("\t")[1])
            elif line.startswith("L"):
                v = line.split("\t")
                uf.union(v[1], v[3])
    groups = defaultdict(list)
    for seg in list(uf.parent):
        groups[uf.find(seg)].append(seg)
    comps = sorted(groups.values(), key=len, reverse=True)
    return comps


def parse_minspace(path: str):
    """Lines `[seq_id] [minimizers...]` (brackets/commas tolerated)."""
    out = []
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        line = line.replace("[", "").replace("]", "").replace(",", " ")
        parts = line.split()
        if len(parts) < 2:
            continue
        out.append((parts[0], tuple(int(x) for x in parts[1:])))
    return out


def scan(targets_path: str, corpus_path: str, k: int = 10):
    """For each corpus line, report targets sharing a k-min-mer (both
    orientations, scan_genomes_minmers.py semantics)."""
    kminmers = defaultdict(list)
    for seq_id, mins in parse_minspace(targets_path):
        if len(mins) < k:
            continue
        for i in range(len(mins) - k + 1):
            w = mins[i : i + k]
            kminmers[w].append((seq_id, i))
            kminmers[w[::-1]].append((seq_id, i))
    hits = []
    for seq_id, mins in parse_minspace(corpus_path):
        for i in range(max(0, len(mins) - k + 1)):
            w = mins[i : i + k]
            if w in kminmers:
                for t, ti in kminmers[w]:
                    hits.append((seq_id, t, ti))
    return hits


def gene_coverage(targets_path: str, hits, k: int = 10):
    """Per-target: (n_kminmers, covered %) — amr/parse_hits.py output."""
    n_kminmers = {}
    for seq_id, mins in parse_minspace(targets_path):
        n_kminmers[seq_id] = max(0, len(mins) - k + 1)
    covered = defaultdict(set)
    for _genome, target, ti in hits:
        covered[target].add(ti)
    out = {}
    for t, n in n_kminmers.items():
        pct = 100.0 * len(covered.get(t, ())) / n if n else 0.0
        out[t] = (n, pct)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    cmd = argv[0]
    k = 10
    for a in argv:
        if a.startswith("-k"):
            k = int(argv[argv.index(a) + 1]) if a == "-k" else int(a[2:])
    if cmd == "components":
        comps = components(argv[1])
        print(f"{len(comps)} components")
        for i, c in enumerate(comps[:20]):
            print(f"component {i}: {len(c)} segments "
                  f"({' '.join(sorted(c)[:5])}{'...' if len(c) > 5 else ''})")
        return 0
    if cmd == "scan":
        for g, t, ti in scan(argv[1], argv[2], k):
            print(f"{g}\t{t}\t{ti}")
        return 0
    if cmd == "gene-coverage":
        with open(argv[2]) as f:
            hits = [tuple(line.split("\t")) for line in f]
        hits = [(g, t, int(ti)) for g, t, ti in hits]
        for t, (n, pct) in gene_coverage(argv[1], hits, k).items():
            print(f"{t}\t{n}\t{pct:.1f}")
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
