"""Multi-k iterative assembly driver.

Driver parity with utils/multik: fixed density 0.003 and l=12; max_k =
round(0.95 * avg_readlen * density) from the first 10k reads (multik:32-37,
seqtk replaced by the framework's own FASTX reader); assemble k=10 first, then
k=15,20,...,max_k, where each round's input is the previous round's contigs
>= 100kb included TWICE plus the raw reads (multik:70-78); every round runs
`--minabund 2 --bf` on `device` (CUDA unless named) then magic_simplify;
final results copied to <prefix>-final.msimpl.{fa,gfa} (multik:80-83).  A
`restart_from` k resumes the ladder (the reference's checkpoint mechanism,
multik:57-67).
"""

from __future__ import annotations

import glob as _glob
import os
import shutil
import sys

from ..io.fastx import read_records
from ..params import Params
from .magic_simplify import magic_simplify

DENSITY = 0.003
L = 12


def avg_readlen(reads: str, max_reads: int = 10000) -> int:
    total = n = 0
    for _, seq in read_records(reads):
        total += len(seq)
        n += 1
        if n >= max_reads:
            break
    return total // max(1, n)


def _assemble_round(cur_reads: str, k: int, tprefix: str, threads: int,
                    engine: str = "auto", device=None):
    from ..cli import _engine
    from ..core.pipeline import assemble

    p = Params(k=k, l=L, density=DENSITY, min_kmer_abundance=2, use_bf=True,
               threads=threads, engine=_engine(engine))
    print(f"assembly with k={k}", file=sys.stderr)
    assemble(cur_reads, p, tprefix, device=device)
    magic_simplify(tprefix)


def _write_multik_reads(prev_msimpl_fa: str, raw_reads: str, out_path: str,
                        min_contig: int = 100000):
    """Previous contigs >= min_contig twice + raw reads (multik:72-73)."""
    with open(out_path, "w") as out:
        name = None
        seq: list[str] = []

        def emit():
            if name is not None:
                s = "".join(seq)
                if len(s) >= min_contig:
                    for rep in (1, 2):
                        out.write(f">{name}_{rep}\n{s}\n")

        for line in open(prev_msimpl_fa):
            if line.startswith(">"):
                emit()
                name = line[1:].split()[0].strip()
                seq = []
            else:
                seq.append(line.strip())
        emit()
        for rid, s in read_records(raw_reads):
            out.write(f">{rid}\n{s.decode()}\n")


def multik(reads: str, prefix: str, threads: int = 8,
           restart_from: int | None = None, max_k: int | None = None,
           engine: str = "auto", device=None) -> str:
    avg = avg_readlen(reads)
    if max_k is None:
        max_k = round(0.95 * avg * DENSITY)
    print(f"avg readlen: {avg}, max k: {max_k}", file=sys.stderr)

    if restart_from is None:
        tprefix = f"{prefix}-k10"
        _assemble_round(reads, 10, tprefix, threads, engine, device)
        start_k = 15
    else:
        start_k = restart_from
        tprefix = f"{prefix}-k{start_k - 5}"

    last_k = 10
    for k in range(start_k, max_k + 1, 5):
        multik_reads = f"{prefix}.multik_reads.fa"
        _write_multik_reads(f"{tprefix}.msimpl.fa", reads, multik_reads)
        tprefix = f"{prefix}-k{k}"
        _assemble_round(multik_reads, k, tprefix, threads, engine, device)
        last_k = k
        for p in _glob.glob("*.sequences"):
            os.remove(p)

    for ext in ("msimpl.fa", "msimpl.gfa", "gfa"):
        src = f"{tprefix}.{ext}"
        if os.path.exists(src):
            shutil.move(src, f"{prefix}-final.{ext}")
    print(f"assembly done, final results (k={last_k}) are in: "
          f"{prefix}-final.msimpl.fa", file=sys.stderr)
    return f"{prefix}-final.msimpl.fa"


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="multik")
    ap.add_argument("reads")
    ap.add_argument("prefix")
    ap.add_argument("threads", type=int, nargs="?", default=8)
    ap.add_argument("restart_from", type=int, nargs="?", default=None)
    ap.add_argument("max_k", type=int, nargs="?", default=None)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain torch versions)")
    a = ap.parse_args(argv)
    multik(a.reads, a.prefix, a.threads, a.restart_from, a.max_k, a.engine,
           a.device)
    return 0
