"""No-simplification base-space GFA: node sequences straight from .sequences.

Capability parity with utils/complete_gfa.py: for every L line of the raw
mdBG GFA, emit S lines carrying each node's sequence (LN fixed, KC from the
GFA) and an L line whose overlap is len(source) - shift (shift0 for '+',
shift1 for '-'), clamped to len(sink) - 1.  Used when skipping gfatools-style
simplification entirely.

Run: python -m rust_mdbg_tpu_torch gfa-complete <prefix>   (reads <prefix>.gfa +
<prefix>.*.sequences, writes <prefix>.gfa.complete.gfa)
"""

from __future__ import annotations

import sys

from ..io.sequences import iter_sequences


def complete_gfa(prefix: str) -> str:
    recs = {r["index"]: r for r in iter_sequences(prefix)}
    out_path = f"{prefix}.gfa.complete.gfa"
    kc = {}
    with open(f"{prefix}.gfa") as f, open(out_path, "w") as out:
        out.write("H\tVN:Z:1.0\n")
        lines = f.readlines()
        for line in lines:
            if line.startswith("S"):
                v = line.rstrip("\n").split("\t")
                for t in v:
                    if t.startswith("KC:i:"):
                        kc[int(v[1])] = int(t[5:])
        for line in lines:
            if not line.startswith("L"):
                continue
            v = line.rstrip("\n").split("\t")
            a, ao, b, bo = int(v[1]), v[2], int(v[3]), v[4]
            if a not in recs or b not in recs:
                continue
            ra, rb = recs[a], recs[b]
            shift = ra["shift"][0] if ao == "+" else ra["shift"][1]
            ov = len(ra["seq"]) - shift
            ov = min(ov, len(rb["seq"]) - 1)
            for idx, r in ((a, ra), (b, rb)):
                out.write(
                    f"S\t{idx}\t{r['seq']}\tLN:i:{len(r['seq'])}\t"
                    f"KC:i:{kc.get(idx, 0)}\n"
                )
            out.write(f"L\t{a}\t{ao}\t{b}\t{bo}\t{ov}M\n")
    return out_path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    print(f"Wrote {complete_gfa(argv[0])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
