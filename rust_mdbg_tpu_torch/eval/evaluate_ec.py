"""Error-correction accuracy in minimizer space.

Host copy of the JAX package's module of the same name.

Capability parity with utils/evaluate_ec.py: align each read's minimizer
sequence to a reference genome's minimizer sequence (both from .ec_data
files), semiglobal NW with linear -1 gaps and +1/-1 match scoring, both
orientations, BLAST identity (matches / alignment columns); optionally
compare two versions of the same read set (e.g. raw vs corrected) with
per-read better/unchanged/worse tallies and alignment-string display
(evaluate_ec.py:239-284); optionally score POA recruitment per template
from a `.poa.ec_data` file with mean Jaccard / Mash distances of the
TP/FP/FN read groups against the template (evaluate_ec.py:174-196,254-261).

Run: python -m rust_mdbg_tpu_torch.eval.evaluate_ec ref.ec_data reads.ec_data
         [corrected.ec_data] [poa.ec_data] [--max-reads N]
"""

from __future__ import annotations

import math
import sys

from ..io import ec_data
from ..models import pairwise
from . import evaluate_poa

# reference's alignment-string alphabet (evaluate_ec.py:101-114): M match,
# X mismatch, '-' gap in the reference (read base consumed), 'i' gap in the
# read (reference base consumed)
_OP_CHAR = {"Match": "M", "Subst": "X", "Del": "-", "Ins": "i"}


def _align(reference, read):
    """Best-of-fwd/rev semiglobal alignment; returns (identity, aln_str)."""
    score = lambda a, b: 1 if a == b else -1  # noqa: E731
    # linear gap -1/char: gap_open=0, gap_extend=-1
    aligner = pairwise.Aligner(0, -1, score, match_scores=(1, -1))

    def one(query):
        aln = aligner.semiglobal(list(query), list(reference))
        cols = len(aln.operations)
        matches = sum(1 for o in aln.operations if o == "Match")
        ident = 100.0 * matches / cols if cols else 0.0
        return aln.score, ident, "".join(_OP_CHAR[o] for o in aln.operations)

    fwd = one(read)
    rev = one(read[::-1])
    best = max(fwd, rev, key=lambda t: t[0])
    return best[1], best[2]


def blast_identity(reference, read) -> float:
    """Best of fwd/rev semiglobal identity of `read` against `reference`."""
    return _align(reference, read)[0]


def jaccard_distance(template: set, groups: dict, read_ids) -> float:
    """1 - mean Jaccard similarity of each read's minimizer set vs the
    template's (evaluate_ec.py:174-183)."""
    sims = [
        len(template & groups[r]) / len(template | groups[r])
        for r in read_ids if r in groups
    ]
    return 1 - (sum(sims) / len(sims)) if sims else 1.0


def mash_distance(template: set, groups: dict, read_ids) -> float:
    """Mean Mash distance -1/10 * ln(2j/(1+j)) vs the template
    (evaluate_ec.py:185-196; 1.0 when j == 0)."""
    vals = []
    for r in read_ids:
        if r not in groups:
            continue
        j = len(template & groups[r]) / len(template | groups[r])
        vals.append(1.0 if j == 0.0 else -0.1 * math.log(2.0 * j / (1.0 + j)))
    return sum(vals) / len(vals) if vals else 0.0


def evaluate(ref_path: str, reads_path: str, corrected_path: str | None = None,
             poa_path: str | None = None, max_reads: int = 50,
             min_overlap: int | None = None):
    ref = ec_data.load(ref_path.replace(".ec_data", ""))
    if not ref:
        raise SystemExit(f"no records in {ref_path}")
    reference = ref[0].read_transformed
    reads = ec_data.load(reads_path.replace(".ec_data", ""))[:max_reads]
    results = {}
    alns = {}
    minim_sets = {r.seq_id: set(r.read_transformed) for r in reads}
    for rec in reads:
        results[rec.seq_id], alns[rec.seq_id] = _align(
            reference, rec.read_transformed)
    out = {"mean_identity": sum(results.values()) / max(1, len(results)),
           "n_reads": len(results), "per_read": results, "aln": alns}
    if corrected_path:
        cor = ec_data.load(corrected_path.replace(".ec_data", ""))
        cor_by_id = {r.seq_id: r for r in cor}
        cres, calns = {}, {}
        nb_better = nb_nochange = nb_worse = 0
        for rid in results:
            if rid not in cor_by_id:
                continue
            cres[rid], calns[rid] = _align(
                reference, cor_by_id[rid].read_transformed)
            if results[rid] < cres[rid]:
                nb_better += 1
            elif cres[rid] < results[rid]:
                nb_worse += 1
            else:
                nb_nochange += 1
        out["mean_identity_corrected"] = (
            sum(cres.values()) / max(1, len(cres))
        )
        out["per_read_corrected"] = cres
        out["aln_corrected"] = calns
        out["nb_better"] = nb_better
        out["nb_nochange"] = nb_nochange
        out["nb_worse"] = nb_worse
    if poa_path:
        recruited, all_reads = evaluate_poa.parse_poa(poa_path)
        mo = evaluate_poa.MIN_OVERLAP if min_overlap is None else min_overlap
        poa_stats = {}
        for rid in results:
            if rid not in recruited:
                continue
            template = minim_sets[rid]
            tp, fp, fn = evaluate_poa.eval_template(
                rid, recruited, all_reads, mo)
            poa_stats[rid] = {
                group_name: dict(
                    n=len(ids),
                    jac=jaccard_distance(template, minim_sets, ids),
                    mash=mash_distance(template, minim_sets, ids),
                    reads=ids,
                )
                for group_name, ids in (("tp", tp), ("fp", fp), ("fn", fn))
            }
        out["poa"] = poa_stats
    return out


def _short(read_id: str, max_len: int = 25) -> str:
    return read_id[:max_len] + ".." if len(read_id) > max_len else read_id


def report(res: dict, show_aln: bool = True, file=sys.stdout):
    """Human-readable report in the reference's display format
    (evaluate_ec.py:239-284)."""
    w = file.write
    w(f"reads aligned: {res['n_reads']}\n")
    w(f"mean BLAST identity: {res['mean_identity']:.2f}%\n")
    if "mean_identity_corrected" not in res:
        return
    w(f"mean BLAST identity (corrected): "
      f"{res['mean_identity_corrected']:.2f}%\n")
    for rid, ir1 in res["per_read"].items():
        if rid not in res["per_read_corrected"]:
            continue
        ir2 = res["per_read_corrected"][rid]
        w(f"read {_short(rid)} uncor: {ir1:0.2f} cor: {ir2:0.2f}\n")
        if "poa" in res and rid in res["poa"]:
            g = res["poa"][rid]
            w("POA retrieval TP: %d (Jac %.2f) (Mash %.2f)    "
              "FP: %d (Jac %.2f) (Mash %.2f)   FN: %d (Jac %.2f) (Mash %.2f)\n"
              % (g["tp"]["n"], g["tp"]["jac"], g["tp"]["mash"],
                 g["fp"]["n"], g["fp"]["jac"], g["fp"]["mash"],
                 g["fn"]["n"], g["fn"]["jac"], g["fn"]["mash"]))
        if show_aln:
            w(f"alignment of uncorrected read {_short(rid)} to ref:\n")
            w(res["aln"][rid] + "\n")
            w("and now the corrected read alignment:\n")
            w(res["aln_corrected"][rid] + "\n")
            w("---\n")
    w(f"{res['nb_better']} reads improved\n")
    w(f"{res['nb_nochange']} reads unchanged\n")
    w(f"{res['nb_worse']} reads made worse\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    max_reads = 50
    show_aln = True
    for a in argv:
        if a.startswith("--max-reads"):
            max_reads = int(a.split("=")[1])
        if a == "--no-aln":
            show_aln = False
    if len(args) < 2:
        print("usage: evaluate_ec ref.ec_data reads.ec_data "
              "[corrected.ec_data] [poa.ec_data] [--max-reads=N] [--no-aln]",
              file=sys.stderr)
        return 2
    res = evaluate(args[0], args[1],
                   args[2] if len(args) > 2 else None,
                   args[3] if len(args) > 3 else None,
                   max_reads)
    report(res, show_aln=show_aln)
    return 0


if __name__ == "__main__":
    sys.exit(main())
