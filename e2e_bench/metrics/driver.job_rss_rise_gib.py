"""How far a window job raises the process's resident memory over what it
held when the job began: the program's highest VmRSS read at a span's end
(`rss_high_bytes`) less its VmRSS at the job's start (`rss_start_bytes`),
in GiB, the mean over the jobs that report both."""


def read(ctx):
    rises = [c["rss_high_bytes"] - c["rss_start_bytes"]
             for c in (j["stats"].get("counters", {})
                       for j in ctx.get("jobs", ()))
             if "rss_high_bytes" in c and "rss_start_bytes" in c]
    if not rises:
        return None
    return sum(rises) / len(rises) / float(1 << 30)
