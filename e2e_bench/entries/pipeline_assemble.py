"""The one-card entry: `rust_mdbg_tpu_torch.core.pipeline.assemble`, the
command users run as `python -m rust_mdbg_tpu_torch reads.fa -k K -l L -d
D --minabund N`.  A job is one assembly of a FASTA into prefix.gfa and
prefix.*.sequences."""

from __future__ import annotations

import glob

from rust_mdbg_tpu_torch.core.pipeline import assemble
from rust_mdbg_tpu_torch.ops import kernels
from rust_mdbg_tpu_torch.params import Params


def run_job(fasta: str, cfg: dict, prefix: str, device) -> dict:
    """Assemble `fasta` with the configuration's params; the program's
    stats (its driver's phases among them)."""
    return assemble(fasta, Params(**cfg["params"]), prefix, device=device)


def outputs(prefix: str) -> list:
    """The files a job wrote."""
    return [f"{prefix}.gfa"] + sorted(glob.glob(f"{prefix}.*.sequences"))


def counters() -> dict:
    """The hand kernels' launch counters (cumulative in the process)."""
    return {name: getattr(kernels, name).launches
            for name in ("nthash_select", "compact_minimizers",
                         "window_keys")}
