"""Command-line interface of the port.

    python -m rust_mdbg_tpu_torch reads.fa -k K -l L --density D \
        --minabund N --prefix P [--skiphpc] [--bf [--bf-bits N]]
        [--device cuda|cpu]

The run goes through core/pipeline.assemble, which takes the chunked driver
for --minabund up to 16 and the whole-run device path above it, as
`python -m rust_mdbg_tpu` does.  The flags of the JAX package's CLI that
select paths this port does not run yet are accepted and rejected with a
"not ported yet" error naming ROADMAP.md, so a command line written for
`python -m rust_mdbg_tpu` fails clearly instead of running something else.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .params import Params, autodetect_k_l_d, default_prefix

#: flags of the JAX package's CLI whose paths are later slices
_NOT_PORTED = {
    "syncmers": "--syncmers", "lmer_counts": "--lmer-counts",
    "uhs": "--uhs", "lcp": "--lcp", "error_correct": "--error-correct",
    "restart_from_postcor": "--restart-from-postcor",
    "reference": "--reference", "read_stats": "--read-stats",
    "mesh": "--mesh", "multihost": "--multihost",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rust_mdbg_tpu_torch",
        description="Minimizer-space de Bruijn graph (mdBG) assembler, "
                    "PyTorch/CUDA port.")
    p.add_argument("reads", help="input FASTA/FASTQ (.gz/.lz4 ok)")
    p.add_argument("-p", "--prefix", default=None)
    p.add_argument("-k", type=int, default=None, help="k-min-mer length")
    p.add_argument("-l", type=int, default=None, help="minimizer length")
    p.add_argument("-d", "--density", type=float, default=None)
    p.add_argument("--minabund", type=int, default=2)
    p.add_argument("--presimp", type=float, default=0.01)
    p.add_argument("--no-basespace", action="store_true")
    p.add_argument("--skiphpc", action="store_true",
                   help="reads are already homopolymer-compressed")
    p.add_argument("--bf", action="store_true",
                   help="Bloom filter: count a k-min-mer from its second "
                        "sighting on")
    p.add_argument("--bf-bits", type=int, default=32,
                   help="log2 Bloom filter bits for --bf (default 32)")
    p.add_argument("--batch-reads", type=int, default=512)
    p.add_argument("--max-read-len", type=int, default=0)
    p.add_argument("--chunk-reads", type=int, default=0,
                   help="reads per device chunk (0 = auto by input size)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain torch versions)")
    for dest, _ in _NOT_PORTED.items():
        flag = "--" + dest.replace("_", "-")
        if dest in ("lmer_counts", "uhs", "lcp", "read_stats"):
            p.add_argument(flag, default=None, help=argparse.SUPPRESS)
        elif dest == "mesh":
            p.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
        else:
            p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    return p


def params_from_args(args) -> tuple[Params, str]:
    for dest, label in _NOT_PORTED.items():
        if getattr(args, dest):
            raise SystemExit(
                f"error: {label} is not ported yet (see ROADMAP.md)")
    k, l, density = 10, 12, 0.10
    if args.k is None and args.l is None and args.density is None:
        from .io.fastx import read_first_n_reads

        print("Autodetecting values for k, l, and density.")
        mean_len, _ = read_first_n_reads(args.reads, 100)
        k, l, density = autodetect_k_l_d(mean_len)
        print(f"Setting k = {k} l = {l} density = {density}.")
    else:
        k = args.k if args.k is not None else k
        l = args.l if args.l is not None else l
        density = args.density if args.density is not None else density
    params = Params(
        k=k, l=l, density=density, min_kmer_abundance=args.minabund,
        presimp=args.presimp, no_basespace=bool(args.no_basespace),
        reads_already_hpc=bool(args.skiphpc),
        use_bf=bool(args.bf), bloom_log2_bits=args.bf_bits,
        batch_reads=args.batch_reads, max_read_len=args.max_read_len,
        chunk_reads=args.chunk_reads)
    prefix = args.prefix if args.prefix is not None else default_prefix(params)
    return params, prefix


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.reads):
        print(f"error: input reads file not found: {args.reads}",
              file=sys.stderr)
        return 2
    params, prefix = params_from_args(args)
    from .core.pipeline import assemble
    from .utils.timing import max_rss_bytes

    t0 = time.time()
    stats = assemble(args.reads, params, prefix, device=args.device)
    print(f"Number of reads: {stats.get('nb_reads', 0)}")
    print(f"Number of mdBG nodes: {stats.get('nb_nodes', 0)}")
    print(f"Number of mdBG edges: {stats.get('nb_edges', 0)}")
    if params.presimp > 0.0:
        print(f"Pre-simp = {params.presimp}: "
              f"{stats.get('presimp_removed', 0)} edges removed.")
    print(f"PHASES {stats['phases']}")
    print(f"Total execution time: {time.time() - t0:.2f}s")
    print(f"Maximum RSS: {max_rss_bytes() / 1024**3:.3f}GB")
    return 0
