"""Minimizer-space error-correction at scale: timed POA EC runs.

Counterpart of the JAX package's `experiments/ec_scale.py`, with the same
report fields.  Measures the full `--error-correct` pipeline (extraction
-> EC bucket recruit -> POA graph weave -> reingest -> abundance filter ->
GFA) on a synthetic noisy corpus at arbitrary genome scale, the workload
the reference drives through its crossbeam thread-chunks (rust-mdbg
src/main.rs:855-883, poa.rs:781-874).  The run is on `--device` (CUDA
unless named): the extraction goes through the DeviceExtractor, and the
device driver (`--device-poa`) aligns every active template's next
fwd+rev candidate in one launch of the POA DP kernel (ops/poa_device;
models/correct.run_error_correction_lockstep).  The JAX package's
`--platform` and compile-cache lines have no counterpart: `--device cpu`
runs the plain torch versions.

CLI: python -m rust_mdbg_tpu_torch ec-scale --genome-mbp 1 --device-poa \
         --error-rate 0.003 --out ec.json
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import tempfile
import time


def run_ec_scale(genome_mbp: float, coverage: float = 30,
                 read_len: int = 10000, error_rate: float = 0.01,
                 device_poa: bool = True, ec_chunk: int = 64,
                 workdir: str | None = None, seed: int = 0,
                 device=None, ec_procs: int = 0) -> dict:
    from ..core.chunked import resolve_device
    from ..core.pipeline import assemble
    from ..params import Params
    from .synth import write_synthetic_reads

    dev = resolve_device(device)
    workdir = workdir or os.path.join(tempfile.gettempdir(), "mdbg_ec_scale")
    os.makedirs(workdir, exist_ok=True)
    reads = os.path.join(workdir, f"ec_{genome_mbp:g}mbp.fa")
    t0 = time.perf_counter()
    info = write_synthetic_reads(reads, genome_mbp=genome_mbp,
                                 coverage=coverage, read_len=read_len,
                                 error_rate=error_rate, seed=seed)
    t_synth = time.perf_counter() - t0

    # minimizer-space EC wants dense-enough minimizers per read for the POA
    # graph to capture errors (the reference's EC experiments ran small-l,
    # higher-density settings than assembly; utils/magic_simplify EC configs)
    p = Params(k=8, l=10, density=0.02, min_kmer_abundance=2,
               error_correct=True, engine="device",
               ec_device_poa=device_poa, ec_procs=ec_procs)
    if device_poa:
        object.__setattr__(p, "ec_chunk", ec_chunk)
    prefix = os.path.join(workdir, f"ec_{genome_mbp:g}mbp")
    t1 = time.perf_counter()
    stats = assemble(reads, p, prefix, device=dev)
    t_run = time.perf_counter() - t1
    phases = stats.get("phases", {})
    acc = accuracy_summary(prefix, p, genome_mbp, read_len, seed=seed)
    return dict(
        **acc,
        genome_mbp=genome_mbp, coverage=coverage, read_len=read_len,
        # effective mode: ec_procs >= 1 overrides the device-POA driver
        # (models/correct.run_error_correction dispatch)
        error_rate=error_rate, device_poa=device_poa and ec_procs < 1,
        ec_procs=ec_procs,
        total_gbp=round(info["total_bases"] / 1e9, 4),
        synth_s=round(t_synth, 1), wall_s=round(t_run, 1),
        ec_s=round(phases.get("error-correct", 0.0), 1),
        phases={k: round(v, 1) for k, v in phases.items()},
        nb_nodes=stats.get("nb_nodes"), nb_edges=stats.get("nb_edges"),
        max_rss_gb=round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
    )


def _stream_ec(path):
    """(id, transformed-hash list) per record of a 5-line .ec_data file."""
    with open(path) as f:
        while True:
            rid = f.readline()
            if not rid:
                return
            f.readline()  # seq
            tr = f.readline()
            f.readline()  # minimizer strings
            f.readline()  # positions
            yield rid.strip(), [int(x) for x in tr.split()]


def accuracy_summary(prefix: str, p, genome_mbp: float, read_len: int,
                     sample: int = 200, seed: int = 0) -> dict:
    """Before/after EC identity (the evaluate_ec metric) on a read sample.

    Each sampled read's RAW (pre-correction, prefix.ec_data) and CORRECTED
    (prefix.postcor.ec_data) minimizer-hash sequence is semiglobal-NW
    aligned (eval/evaluate_ec.blast_identity) against the TRUE read's
    minimizer sequence — the error-free genome slice at the start position
    embedded in the synthetic read id (experiments/synth.py id format
    r<i>_<start>).  Reference metric: utils/evaluate_ec.py BLAST identity."""
    import numpy as np

    from ..core.extract import extract_windows_host
    from ..eval.evaluate_ec import blast_identity

    cor = {}
    for rid, tr in _stream_ec(f"{prefix}.postcor.ec_data"):
        if len(cor) >= sample:
            break
        cor[rid] = tr
    raw = {}
    for rid, tr in _stream_ec(f"{prefix}.ec_data"):
        if rid in cor:
            raw[rid] = tr
            if len(raw) == len(cor):
                break

    # true reads: same seed => same genome draw (experiments/synth.py)
    rng = np.random.default_rng(seed)
    G = int(genome_mbp * 1_000_000)
    genome = rng.integers(0, 4, G, dtype=np.int64).astype(np.uint8)
    ids = sorted(raw)
    starts = [int(r.rsplit("_", 1)[1]) for r in ids]
    codes = np.stack([genome[s : s + read_len] for s in starts])

    class _B:
        pass

    b = _B()
    b.codes = codes
    b.lengths = np.full(len(ids), read_len, dtype=np.int32)
    b.ids = ids
    b.raw = []
    b.start_index = 0
    wb = extract_windows_host(b, p)

    before = []
    after = []
    for row, rid in enumerate(ids):
        m = wb.minimizers[row]
        if m is None:
            continue
        true_h = [int(x) for x in m[1]]
        before.append(blast_identity(true_h, raw[rid]))
        after.append(blast_identity(true_h, cor[rid]))
    return dict(
        ec_sampled_reads=len(before),
        ec_before_identity=round(float(np.mean(before)), 2),
        ec_after_identity=round(float(np.mean(after)), 2),
    )


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="ec-scale")
    ap.add_argument("--genome-mbp", type=float, default=100)
    ap.add_argument("--coverage", type=float, default=30)
    ap.add_argument("--read-len", type=int, default=10000)
    ap.add_argument("--error-rate", type=float, default=0.01)
    ap.add_argument("--device-poa", action="store_true")
    ap.add_argument("--ec-chunk", type=int, default=64)
    ap.add_argument("--ec-procs", type=int, default=0,
                    help="fork N EC worker processes (host path; overrides "
                         "--device-poa)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain torch versions)")
    a = ap.parse_args(argv)
    res = run_ec_scale(a.genome_mbp, a.coverage, a.read_len, a.error_rate,
                       a.device_poa, a.ec_chunk, a.workdir,
                       device=a.device, ec_procs=a.ec_procs)
    line = json.dumps(res)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
