"""nthash_select: every HPC position of the job's reads read once (1 B
of base code) and its hash and selection flag written once (8 + 1 B)."""

FUNCTION = "nthash_select_kernel"


def least_bytes(work: dict, cfg: dict) -> int:
    return 10 * work["hpc_positions"]
