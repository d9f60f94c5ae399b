"""POA read-recruitment accuracy from synthetic ground truth.

Host copy of the JAX package's module of the same name.

Capability parity with utils/evaluate_poa.py: reads named
`SYN_<i>_<start>_<end>_...` carry their genomic interval; for each template in
a `.poa.ec_data` file (template\tread1\tread2...), score recruited reads
against the set of reads truly overlapping the template by > min_overlap bp
(TP/FP/FN, precision/recall).

Run: python -m rust_mdbg_tpu_torch.eval.evaluate_poa prefix.poa.ec_data [--min-overlap N]
"""

from __future__ import annotations

import sys

MIN_OVERLAP = 1000


def syn_interval(name: str):
    parts = name.split("_")
    return int(parts[2]), int(parts[3])


def overlap_len(a, b, s, e) -> int:
    return max(0, min(b, e) - max(a, s))


def parse_poa(poa_path: str):
    """Parse a `.poa.ec_data` file (template\tread1\tread2..., one line per
    template, utils/evaluate_poa.py parse_file) into (recruited, all_reads)."""
    recruited: dict[str, list[str]] = {}
    all_reads: dict[str, tuple[int, int]] = {}
    for line in open(poa_path):
        parts = line.split()
        if not parts:
            continue
        template = parts[0]
        all_reads[template] = syn_interval(template)
        recruited[template] = parts[1:]
        for r in parts[1:]:
            all_reads.setdefault(r, syn_interval(r))
    return recruited, all_reads


def eval_template(template: str, recruited, all_reads,
                  min_overlap: int = MIN_OVERLAP):
    """TP/FP/FN read-id lists for one POA template (eval_poa semantics:
    truth = reads overlapping the template interval by > min_overlap)."""
    ts, te = all_reads[template]
    truth = {
        r for r, (s, e) in all_reads.items()
        if r != template and overlap_len(ts, te, s, e) > min_overlap
    }
    got = set(recruited[template])
    return sorted(got & truth), sorted(got - truth), sorted(truth - got)


def evaluate(poa_path: str, min_overlap: int = MIN_OVERLAP):
    recruited, all_reads = parse_poa(poa_path)

    totals = dict(tp=0, fp=0, fn=0)
    per_template = {}
    for template in recruited:
        tpl, fpl, fnl = eval_template(template, recruited, all_reads,
                                      min_overlap)
        tp, fp, fn = len(tpl), len(fpl), len(fnl)
        per_template[template] = (tp, fp, fn)
        totals["tp"] += tp
        totals["fp"] += fp
        totals["fn"] += fn
    tp, fp, fn = totals["tp"], totals["fp"], totals["fn"]
    return dict(
        tp=tp, fp=fp, fn=fn,
        precision=tp / max(1, tp + fp),
        recall=tp / max(1, tp + fn),
        per_template=per_template,
    )


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    mo = MIN_OVERLAP
    args = []
    for a in argv:
        if a.startswith("--min-overlap="):
            mo = int(a.split("=")[1])
        else:
            args.append(a)
    r = evaluate(args[0], mo)
    print(f"TP={r['tp']} FP={r['fp']} FN={r['fn']} "
          f"precision={r['precision']:.3f} recall={r['recall']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
