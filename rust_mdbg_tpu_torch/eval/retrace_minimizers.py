"""Legacy unitig retracing: rebuild minimizer chains from A-lines.

Capability parity with the reference's utils/retrace_minimizers.py +
output_basic_sequences.py + sequences_file_to_fasta.py chain (the pre-
to_basespace 'simplify' pipeline, SURVEY C28): given a unitig GFA with
A-lines and the original .sequences, chain each unitig's k-min-mer minimizer
vectors by (k-1)-overlap with orientation fixing, and rebuild unitig
sequences by stitching node sequences.

Run: python -m rust_mdbg_tpu_torch.eval.retrace_minimizers <prefix> <unitigs.gfa> <out_prefix>
Writes <out_prefix>.sequences-style text (uncompressed) and <out_prefix>.fa.
"""

from __future__ import annotations

import sys

from ..io.sequences import iter_sequences
from ..utils.seq import revcomp


def chain_minimizers(nodes, by_index, k):
    """Chain node minimizer vectors along a unitig path; returns the merged
    minimizer chain (orientation fixed per element like
    retrace_minimizers.py:19-78)."""
    chain: list[int] = []
    for num, (node_id, _ori) in enumerate(nodes):
        if node_id not in by_index:
            return []
        ms = list(by_index[node_id]["minimizers"])
        if chain:
            if chain[-(k - 1):] == ms[: k - 1]:
                pass
            elif chain[-(k - 1):] == ms[::-1][: k - 1]:
                ms = ms[::-1]
            else:
                ok = False
                if num == 1:  # may flip the first element once
                    chain = chain[::-1]
                    if chain[-(k - 1):] == ms[: k - 1]:
                        ok = True
                    elif chain[-(k - 1):] == ms[::-1][: k - 1]:
                        ms = ms[::-1]
                        ok = True
                if not ok:
                    continue
            chain += ms[k - 1:]
        else:
            chain = ms
    return chain


def retrace(prefix: str, gfa_path: str, out_prefix: str, k: int, l: int):
    by_index = {r["index"]: r for r in iter_sequences(prefix)}
    unitigs: dict[str, list] = {}
    order: list[str] = []
    for line in open(gfa_path):
        if line.startswith("A"):
            v = line.rstrip("\n").split("\t")
            name = v[1]
            if name not in unitigs:
                unitigs[name] = []
                order.append(name)
            unitigs[name].append((int(v[4]), v[3] == "+"))
    seq_out = open(out_prefix + ".sequences.txt", "w")
    fa_out = open(out_prefix + ".fa", "w")
    seq_out.write(f"# k = {k}\n# l = {l}\n")
    for name in order:
        chain = chain_minimizers(unitigs[name], by_index, k)
        if not chain:
            continue
        # stitch sequences: first node entire (oriented), then novel parts
        parts = []
        for i, (node_id, ori) in enumerate(unitigs[name]):
            r = by_index.get(node_id)
            if r is None:
                continue
            s = r["seq"]
            if i == 0:
                parts.append(s if ori else revcomp(s))
            else:
                cut = r["shift"][1] if ori else r["shift"][0]
                parts.append(s[len(s) - cut:] if ori else revcomp(s[:cut]))
        seq = "".join(parts)
        mins = "[" + ", ".join(str(m) for m in chain) + "]"
        seq_out.write(f"{name}\t{mins}\t{seq}\t*\t*\t(0, 0)\n")
        fa_out.write(f">{name}\n{seq}\n")
    seq_out.close()
    fa_out.close()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 2
    # k, l from the sequences header
    import glob as g

    from ..io.lz4f import open_text

    k = l = None
    for p in sorted(g.glob(f"{argv[0]}.*.sequences")):
        with open_text(p) as f:
            for line in f:
                if line.startswith("# k ="):
                    k = int(line.split("=")[1])
                elif line.startswith("# l ="):
                    l = int(line.split("=")[1])
                else:
                    break
        break
    retrace(argv[0], argv[1], argv[2], k or 10, l or 12)
    return 0


if __name__ == "__main__":
    sys.exit(main())
