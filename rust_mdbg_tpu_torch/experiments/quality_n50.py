"""Assembly-quality A/B: contig N50 vs the input error model at scale.

Counterpart of the JAX package's `experiments/quality_n50.py`, with the
same protocol, legs and record fields; the assembly runs on `--device`
(the card unless named).

Protocol (the reference's D. mel-class best-params run, rust-mdbg
README.md:126: k=35, l=12, d=0.002, 100x, N50 6.0 Mbp): a >=100 Mbp
synthetic genome with 20% segmental duplications, 100x coverage of 24 kb
reads, assembled single-k with --bf --minabund 2 and simplified with
magic_simplify (native gfa_asm engine).  Three error legs:

  err = 0.003   the raw HiFi substitution rate.  A k=35 window spans ~420
                minimizer bases + ~8.75 kb of creation surface, so window
                survival is ~8% and coverage gaps fragment the graph:
                kb-class N50 expected.
  err = 0.0003  the post-HPC residual rate of real HiFi (QV25-30 reads are
                dominated by homopolymer indels, which homopolymer
                compression removes; the reference's published runs are
                all on HPC'd inputs, README.md:133-135).  Window survival
                ~80%: Mbp-class N50 expected.
  err = 0       control.

If the 0.0003 leg reaches Mbp-class N50 while 0.003 stays kb-class on the
same genome/coverage/params/simplifier, the fragmentation is the error
model's, and the assembler and simplifier are not the binding constraint.

Run: python -m rust_mdbg_tpu_torch quality-n50 [--genome-mbp 100]
         [--device cpu] [--workdir D] [--out quality_n50_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

from .harness import assembly_stats
from .scale_demo import synth_fasta


def run_leg(workdir: str, err: float, genome_mbp: int, coverage: int,
            k: int, l: int, d: float, minab: int, seed: int,
            engine: str = "device", repeat_frac: float = 0.2,
            device=None) -> dict:
    from ..core.chunked import resolve_device
    from ..core.pipeline import assemble
    from ..params import Params
    from ..tools.magic_simplify import magic_simplify

    dev = resolve_device(device)
    tag = f"e{err:g}_r{repeat_frac:g}".replace(".", "p")
    reads = os.path.join(workdir, f"reads_{tag}.fa")
    t0 = time.perf_counter()
    total = synth_fasta(reads, genome_bp=genome_mbp * 1_000_000,
                        coverage=coverage, seed=seed, err=err,
                        repeat_frac=repeat_frac)
    t_synth = time.perf_counter() - t0
    prefix = os.path.join(workdir, f"asm_{tag}")
    p = Params(k=k, l=l, density=d, min_kmer_abundance=minab,
               use_bf=True, engine=engine, reads_already_hpc=True,
               batch_reads=128)
    t1 = time.perf_counter()
    stats = assemble(reads, p, prefix, device=dev)
    t_asm = time.perf_counter() - t1
    t2 = time.perf_counter()
    fa = magic_simplify(prefix)
    t_msimpl = time.perf_counter() - t2
    contigs = assembly_stats(fa)
    try:
        os.remove(reads)
    except OSError:
        pass
    return dict(
        err=err, repeat_frac=repeat_frac, total_gbp=round(total / 1e9, 2),
        nodes=stats.get("nb_nodes"), edges=stats.get("nb_edges"),
        synth_s=round(t_synth, 1), asm_s=round(t_asm, 1),
        msimpl_s=round(t_msimpl, 1), **contigs,
    )


def main(argv=None) -> int:
    from ..core.chunked import resolve_device
    from ..utils.timing import card_info

    ap = argparse.ArgumentParser(prog="quality-n50")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "mdbg_quality_torch"))
    ap.add_argument("--genome-mbp", type=int, default=100)
    ap.add_argument("--coverage", type=int, default=100)
    ap.add_argument("--errs", default="0.003,0.0003,0")
    ap.add_argument("-k", type=int, default=35)
    ap.add_argument("-l", type=int, default=12)
    ap.add_argument("-d", type=float, default=0.002)
    ap.add_argument("--minabund", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default="quality_n50_torch.json")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain torch versions)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    os.makedirs(a.workdir, exist_ok=True)
    legs = []
    for err in (float(x) for x in a.errs.split(",")):
        leg = run_leg(a.workdir, err, a.genome_mbp, a.coverage,
                      a.k, a.l, a.d, a.minabund, a.seed, device=dev)
        print(json.dumps(leg), flush=True)
        legs.append(leg)
    out = dict(
        protocol=dict(genome_mbp=a.genome_mbp, coverage=a.coverage,
                      read_len=24576, repeat_frac=0.2, k=a.k, l=a.l,
                      density=a.d, minabund=a.minabund, bf=True,
                      note="err models the POST-HPC residual substitution "
                           "rate; reference D.mel best-params anchor: "
                           "k=35 l=12 d=0.002 100x -> N50 6.0 Mbp "
                           "(README.md:126)"),
        legs=legs,
        max_rss_gb=round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        device=str(dev), card=card_info(dev),
    )
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
