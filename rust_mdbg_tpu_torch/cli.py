"""Command-line interface of the port.

    python -m rust_mdbg_tpu_torch reads.fa -k K -l L --density D \
        --minabund N --prefix P [--skiphpc] [--bf [--bf-bits N]]
        [--syncmers [-s S]] [--lmer-counts F] [--uhs F] [--lcp F]
        [--reference] [--read-stats F] [--engine device|host]
        [--error-correct [--ec-device-poa] [--ec-procs N] [--ec-chunk N]]
        [--restart-from-postcor] [--mesh N | --multihost]
        [--device cuda|cpu]
    python -m rust_mdbg_tpu_torch TOOL ...

The parser takes every flag of `python -m rust_mdbg_tpu` and maps it onto
the same Params: -n, -t, --distance, --correction-threshold, --threads,
--ec-device-poa, --ec-procs and --ec-chunk are read as there, and
--error-correct beside --reference runs with error correction off, as
there.  The run goes through core/pipeline.assemble, which routes as the
JAX package does: density and syncmer runs to the chunked driver
(--minabund up to 16) or the whole-run device path (above it), everything
else, error correction included, to the streaming engine.
--restart-from-postcor rebuilds the graph from prefix.postcor.ec_data
(models/correct.assemble_from_postcor, host only).  --mesh N runs the
sharded pipeline over N shards (parallel/pipeline.assemble_sharded; on one
card, N shards on it), and --multihost the same pipeline over the
processes that MDBG_COORD, MDBG_NPROCS and MDBG_PROC_ID name
(parallel/multihost.py), as the JAX package routes them.

TOOL is one of the JAX package's subcommands (tools/): to-basespace,
gfa-asm, magic-simplify, simplify-meta, multik (which assembles on the card
unless given --device cpu), gfa2fasta, break-loops, gfa-complete,
hpc-compress, gfa-strip, extreme-simplify, synth-reads, ec-scale and
quality-n50 (both on the card unless given --device cpu).  Every
subcommand of the JAX package is dispatched (tools.dispatch), so every
command line of the JAX package runs here.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .params import Params, autodetect_k_l_d, default_prefix

#: subcommands of the JAX package's CLI, run by tools.dispatch
_TOOLS = (
    "to-basespace", "gfa-asm", "magic-simplify", "multik", "gfa2fasta",
    "break-loops", "simplify-meta", "gfa-complete", "hpc-compress",
    "gfa-strip", "extreme-simplify", "synth-reads", "ec-scale",
    "quality-n50",
)


def _engine(name: str) -> str:
    """An --engine value; the JAX package's three names for its device
    engine are one engine here."""
    return "device" if name in ("auto", "pallas") else name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rust_mdbg_tpu_torch",
        description="Minimizer-space de Bruijn graph (mdBG) assembler, "
                    "PyTorch/CUDA port.",
        epilog="Subcommands: " + ", ".join(_TOOLS) + ".")
    p.add_argument("reads", help="input FASTA/FASTQ (.gz/.lz4 ok)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("-p", "--prefix", default=None)
    p.add_argument("-k", type=int, default=None, help="k-min-mer length")
    p.add_argument("-l", type=int, default=None, help="minimizer length")
    p.add_argument("-n", type=int, default=None,
                   help="EC bucketing tuple length")
    p.add_argument("-t", type=int, default=None,
                   help="POA path weight threshold")
    p.add_argument("-d", "--density", type=float, default=None)
    p.add_argument("--minabund", type=int, default=2)
    p.add_argument("--distance", type=int, default=None,
                   help="0: Jaccard, 1: containment, 2: Mash")
    p.add_argument("--correction-threshold", type=int, default=None)
    p.add_argument("--presimp", type=float, default=0.01)
    p.add_argument("--no-basespace", action="store_true")
    p.add_argument("--skiphpc", action="store_true",
                   help="reads are already homopolymer-compressed")
    p.add_argument("--bf", action="store_true",
                   help="Bloom filter: count a k-min-mer from its second "
                        "sighting on")
    p.add_argument("--bf-bits", type=int, default=32,
                   help="log2 Bloom filter bits for --bf (default 32)")
    p.add_argument("--reference", action="store_true")
    p.add_argument("--read-stats", default=None)
    p.add_argument("--syncmers", action="store_true")
    p.add_argument("-s", type=int, default=None,
                   help="syncmer substring length")
    p.add_argument("--lmer-counts", default=None)
    p.add_argument("--lmer-counts-min", type=int, default=None)
    p.add_argument("--lmer-counts-max", type=int, default=None)
    p.add_argument("--uhs", default=None, help="universal k-mer file")
    p.add_argument("--lcp", default=None, help="core substring file")
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--engine", default="device", type=_engine,
                   choices=["device", "host"],
                   help="extraction engine: the device's, or the numpy host "
                        "engine (the JAX package's auto and pallas are read "
                        "as device)")
    p.add_argument("--batch-reads", type=int, default=512)
    p.add_argument("--max-read-len", type=int, default=0)
    p.add_argument("--chunk-reads", type=int, default=0,
                   help="reads per device chunk (0 = auto by input size)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain torch versions)")
    p.add_argument("--ec-device-poa", action="store_true")
    p.add_argument("--ec-procs", type=int, default=0)
    p.add_argument("--ec-chunk", type=int, default=32)
    p.add_argument("--error-correct", action="store_true")
    p.add_argument("--restart-from-postcor", action="store_true")
    p.add_argument("--mesh", type=int, default=0,
                   help="shards of the sharded pipeline (0: off)")
    p.add_argument("--multihost", action="store_true",
                   help="the sharded pipeline over the processes of "
                        "MDBG_COORD / MDBG_NPROCS / MDBG_PROC_ID")
    return p


def params_from_args(args) -> tuple[Params, str]:
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
        k=k, l=l, density=density,
        n=args.n if args.n is not None else 2,
        t=args.t if args.t is not None else 0,
        min_kmer_abundance=args.minabund,
        distance=min(args.distance, 2) if args.distance is not None else 0,
        correction_threshold=(args.correction_threshold
                              if args.correction_threshold is not None
                              else 0),
        error_correct=bool(args.error_correct) and not args.reference,
        presimp=args.presimp, no_basespace=bool(args.no_basespace),
        reads_already_hpc=bool(args.skiphpc),
        use_bf=bool(args.bf), bloom_log2_bits=args.bf_bits,
        reference=bool(args.reference),
        use_syncmers=bool(args.syncmers),
        s=args.s if args.s is not None else 4,
        has_lmer_counts=args.lmer_counts is not None,
        lmer_counts_min=(args.lmer_counts_min
                         if args.lmer_counts_min is not None else 2),
        lmer_counts_max=(args.lmer_counts_max
                         if args.lmer_counts_max is not None else 100000),
        uhs=args.uhs is not None, lcp=args.lcp is not None,
        debug=bool(args.debug),
        threads=args.threads if args.threads is not None else 8,
        engine=args.engine,
        batch_reads=args.batch_reads, max_read_len=args.max_read_len,
        chunk_reads=args.chunk_reads,
        ec_device_poa=bool(args.ec_device_poa), ec_chunk=args.ec_chunk,
        ec_procs=args.ec_procs)
    if args.lmer_counts is not None:
        object.__setattr__(params, "_lmer_counts_path", args.lmer_counts)
    if args.uhs is not None:
        object.__setattr__(params, "_uhs_path", args.uhs)
    if args.lcp is not None:
        object.__setattr__(params, "_lcp_path", args.lcp)
    prefix = args.prefix if args.prefix is not None else default_prefix(params)
    return params, prefix


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _TOOLS:
        from .tools import dispatch

        return dispatch(argv[0], argv[1:])
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.reads):
        print(f"error: input reads file not found: {args.reads}",
              file=sys.stderr)
        return 2
    for attr, label in (("uhs", "--uhs"), ("lcp", "--lcp")):
        path = getattr(args, attr, None)
        if path and not os.path.exists(path):
            print(f"error: {label} file not found: {path}", file=sys.stderr)
            return 2
    params, prefix = params_from_args(args)
    from .core.pipeline import assemble
    from .utils.timing import max_rss_bytes

    t0 = time.time()
    if args.restart_from_postcor:
        from .models.correct import assemble_from_postcor

        stats = assemble_from_postcor(params, prefix)
    elif args.multihost:
        from .parallel.multihost import (assemble_multihost,
                                         close_distributed, init_distributed)

        init_distributed()
        stats = assemble_multihost(args.reads, params, prefix,
                                   device=args.device)
        close_distributed()
    elif args.mesh:
        from .parallel.pipeline import assemble_sharded

        stats = assemble_sharded(args.reads, params, prefix,
                                 n_devices=args.mesh, device=args.device)
    else:
        stats = assemble(args.reads, params, prefix,
                         read_stats_path=args.read_stats, device=args.device)
    print(f"Number of reads: {stats.get('nb_reads', 0)}")
    if args.read_stats:
        print("Read stats written, exiting.")
        return 0
    print(f"Number of mdBG nodes: {stats.get('nb_nodes', 0)}")
    print(f"Number of mdBG edges: {stats.get('nb_edges', 0)}")
    if params.presimp > 0.0:
        print(f"Pre-simp = {params.presimp}: "
              f"{stats.get('presimp_removed', 0)} edges removed.")
    if stats.get("phases"):
        print(f"PHASES {stats['phases']}")
    if stats.get("h2d_bytes"):
        print(f"H2D bytes: {stats['h2d_bytes']}")
    print(f"Total execution time: {time.time() - t0:.2f}s")
    print(f"Maximum RSS: {max_rss_bytes() / 1024**3:.3f}GB")
    return 0
