"""The positions the nthash_select kernel's launches covered in a window
job (rows x width, the program's `nthash_positions` counter) over the
HPC positions the job's reads hold (the reference's `hpc_positions`):
1 where no launched position is padding.  The mean over the jobs that
report the counter; None where none launched the kernel."""


def read(ctx):
    hpc = (ctx.get("work") or {}).get("hpc_positions")
    launched = [j["stats"]["counters"]["nthash_positions"]
                for j in ctx.get("jobs", ())
                if "nthash_positions" in j["stats"].get("counters", {})]
    if not hpc or not launched or not sum(launched):
        return None
    return sum(launched) / (len(launched) * hpc)
