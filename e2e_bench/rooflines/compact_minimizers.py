"""compact_minimizers: the selection plane read once (1 B an HPC
position); at each selected minimizer its hash gathered (8 B), and on raw
reads its raw position and extent end too (4 + 4 B); each minimizer
written once as hash and position (8 + 4 B), and on raw reads its extent
end (4 B); a row's minimizer count and overflow flag (4 + 1 B) a read."""

FUNCTION = "compact_minimizers_kernel"


def least_bytes(work: dict, cfg: dict) -> int:
    raw = not cfg["params"].get("reads_already_hpc", False)
    per_min = (16 + 16) if raw else (8 + 12)
    return (work["hpc_positions"] + per_min * work["minimizers"]
            + 5 * work["reads"])
