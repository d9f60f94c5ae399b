"""The port's end-to-end benchmark: whole assembly jobs through the program
on the card, one cell of BENCHMARK.json a run.

    python -m e2e_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell is made of is found by name: its configuration
(`BENCHMARK.json`'s `file`, under configs/), its traffic mix
(traffic/<name>.json), the entry that runs a job (entries/<entry>.py, named
by the configuration), each per-layer metric (metrics/<name>.py) and each
kernel's byte count (rooflines/<kernel>.py).  A cell, configuration, mix,
entry or metric is added by adding files and BENCHMARK.json entries.

A run: the seeded reads written once as FASTA under a new directory in
TMPDIR; the traffic's warm-up jobs, on the file's first `warmup_share` of
reads (the same first reads, so the program plans the same staging
shapes); then jobs back to back, each to a fresh prefix, the previous
job's outputs deleted first, until --seconds has passed (the job running
then is finished and counted); the last job's outputs are checked
against the plain reference (reference.py, check.py) once the window has
closed and the peaks have been read.  With --trace 1 one more job runs
under torch.profiler and the per-layer metrics are printed in place of
the end-to-end ones.  Each job's line on standard error gives its phases,
the bytes the program staged a read base (which tell its plan) and the
process's CPU seconds.

The last line of standard output is the result's JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.  Without a CUDA card, or with fewer
cards than the cell asks for, the run exits 2 and prints no result.  It
exits 3, with no result, if jax, jaxlib, flax or the JAX package was
imported.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level module names the run must not have imported
FORBIDDEN = ("jax", "jaxlib", "flax", "rust_mdbg_tpu")
#: seconds between two readings of the process's resident memory
RSS_PERIOD = 0.05
GIB = float(1 << 30)


def process_start() -> float:
    """The wall-clock time this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(float(ln.split()[1]) for ln in f
                     if ln.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def load_module(kind: str, name: str, root: str = HERE):
    """root/<kind>/<name>.py as a module of the package e2e_bench.<kind>."""
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"e2e_bench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(bench: dict, workload: str, root: str) -> dict:
    """The cell's configuration, traffic and metrics; `root` is the
    checkout (BENCHMARK.json's paths are relative to it)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload named {workload!r}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "e2e_bench", "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(cell=cell, cfg=cfg, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


class RssSampler:
    """The process's highest VmRSS, read every RSS_PERIOD seconds by a
    thread between start() and stop()."""

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _read(self) -> int:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) * 1024
        return 0

    def _run(self):
        while True:
            self.peak = max(self.peak, self._read())
            if self._stop.wait(RSS_PERIOD):
                return

    def start(self):
        self._t.start()

    def stop(self) -> int:
        self._stop.set()
        self._t.join(timeout=10)
        self.peak = max(self.peak, self._read())
        return self.peak


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def job_line(i: int, job: dict, c0, c1) -> str:
    """One window job's seconds, its phases, the bytes the program staged
    a read base, and the process's CPU seconds meanwhile (os.times at
    the job's start and end)."""
    st = job["stats"]
    ph = st.get("phases", {})
    return (f"job {i}: {job['seconds']} s, feed-wait {ph.get('feed-wait')}"
            f", sequences {ph.get('sequences')}, staged "
            f"{st.get('h2d_bytes', 0) / job['bases']} B a base in "
            f"{st.get('nb_chunks')} chunks, {st.get('replans')} re-plans; "
            f"process CPU {(c1.user + c1.system) - (c0.user + c0.system)} s")


def out_bytes(paths) -> int:
    return sum(os.path.getsize(p) for p in paths if os.path.exists(p))


def remove(paths):
    for p in paths:
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, device=None, root: str | None = None) -> int:
    """One run of one cell.  `device` and `root` are for the tests: a CPU
    device skips the look for a card, and `root` is a checkout other than
    this one (holding BENCHMARK.json and e2e_bench/)."""
    t_proc = process_start()
    ap = argparse.ArgumentParser(prog="python -m e2e_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    root = root or os.path.dirname(HERE)
    pkg = os.path.join(root, "e2e_bench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    c = load_cell(bench, a.workload, root)
    cfg, traffic = c["cfg"], c["traffic"]

    import torch

    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA card: this benchmark runs only on one")
            return 2
        if torch.cuda.device_count() < c["cell"]["chips"]:
            log(f"{torch.cuda.device_count()} CUDA cards, the cell asks for "
                f"{c['cell']['chips']}")
            return 2
        device = "cuda"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
        log(f"card: {card_line()}")
    entry = load_module("entries", cfg["entry"], pkg)
    from . import check, generator, reference
    t_init = time.time()

    work_dir = tempfile.mkdtemp(prefix="e2e_bench.")
    try:
        fasta = os.path.join(work_dir, "reads.fa")
        share = traffic.get("warmup_share", 1.0)
        corpus = generator.write_corpus(cfg, a.seed, fasta, share)
        warm = fasta
        if corpus["share_bytes"] < corpus["fasta_bytes"]:
            warm = os.path.join(work_dir, "warm.fa")
            with open(fasta, "rb") as src, open(warm, "wb") as dst:
                dst.write(src.read(corpus["share_bytes"]))
        t_corpus = time.time()
        written = corpus["fasta_bytes"] + os.path.getsize(warm) * (
            warm != fasta)
        for w in range(traffic["warmup_jobs"]):
            prefix = os.path.join(work_dir, f"warm{w}")
            ts = time.time()
            entry.run_job(warm, cfg, prefix, dev)
            log(f"warm-up job {w}: {time.time() - ts} s")
            written += out_bytes(entry.outputs(prefix))
            remove(entry.outputs(prefix))
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        launches0 = entry.counters()
        rss = RssSampler()
        rss.start()

        # the window: whole jobs back to back
        jobs, failed, last, last_ok = [], 0, None, False
        t0 = time.time()
        while time.time() - t0 < a.seconds:
            prefix = os.path.join(work_dir, f"job{len(jobs) + failed}")
            if last is not None:
                remove(entry.outputs(last))
            ts, c0 = time.time(), os.times()
            try:
                stats = entry.run_job(fasta, cfg, prefix, dev)
                if cuda:
                    torch.cuda.synchronize(dev)
            except Exception:
                failed += 1
                log(traceback.format_exc())
                last, last_ok = prefix, False
                continue
            jobs.append(dict(bases=corpus["bases"],
                             seconds=time.time() - ts, stats=stats))
            log(job_line(len(jobs), jobs[-1], c0, os.times()))
            written += out_bytes(entry.outputs(prefix))
            last, last_ok = prefix, True
        t1 = time.time()
        peak_rss = rss.stop()
        peak_dev = torch.cuda.max_memory_allocated(dev) if cuda else 0
        launches = {k: v - launches0[k] for k, v in entry.counters().items()}

        profile = None
        if a.trace:
            profile = profiled_job(entry, fasta, cfg, work_dir, dev, cuda)
            written += profile.pop("written")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the check, once the window has closed and the peaks are read
        t_ref = time.time()
        reads = reference.parse_fasta(fasta)
        t_parse = time.time() - t_ref
        graph = reference.assemble(reads, cfg["params"], dev)
        ref_s = dict(parse=t_parse, **graph.seconds)
        if last_ok:
            numbers, n_checked = check.check_job(last, a.seed, graph, reads)
        else:
            numbers = {k: 1 for k in check.LIMITS}
            n_checked = 0
        correct = check.passed(numbers) and failed == 0 and bool(jobs)
        t_ref = time.time() - t_ref
        work = dict(graph.counts)
        del reads, graph
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    bad = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if bad:
        log(f"the run imported {', '.join(bad)}")
        return 3

    done = sum(j["bases"] for j in jobs)
    e2e = dict(read_gbps=done / 1e9 / (t1 - t0) if jobs else 0.0,
               peak_device_gib=peak_dev / GIB,
               peak_host_rss_gib=peak_rss / GIB,
               setup_s=t0 - t_proc)
    ctx = dict(jobs=jobs, profile=profile, work=work, config=cfg,
               device_name=torch.cuda.get_device_name(dev) if cuda else "")
    if a.trace:
        metrics = {}
        for m in c["per_layer"]:
            v = load_module("metrics", m["name"], pkg).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        metrics = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                   for m in c["end_to_end"]}

    log(f"setup_s {e2e['setup_s']}: imports and CUDA start "
        f"{t_init - t_proc}, corpus and FASTA {t_corpus - t_init}, warm-up "
        f"jobs {t0 - t_corpus}")
    log(f"corpus {json.dumps(corpus)}; work {json.dumps(work)}")
    log(f"window {t1 - t0} s, {len(jobs)} jobs of "
        f"{[j['seconds'] for j in jobs]} s, {failed} failed; launches "
        f"{json.dumps(launches)}; bytes written {written}; reference and "
        f"check {t_ref} s ({json.dumps(ref_s)}), {n_checked} records "
        f"checked")
    if jobs:
        st = jobs[-1]["stats"]
        log(f"last job's phases {json.dumps(st.get('phases'))}; "
            + "; ".join(f"{k} {st[k]}" for k in (
                "nb_chunks", "h2d_bytes", "replans", "nb_nodes", "nb_edges")
                if k in st))
    for k, lim in check.LIMITS.items():
        log(f"check {k} {numbers[k]} limit {lim}")
    result = dict(correct=correct, attempted=len(jobs) + failed,
                  failed=failed, metrics=metrics,
                  device=dict(platform="gpu" if cuda else "cpu",
                              kind=ctx["device_name"] or "cpu",
                              count=c["cell"]["chips"],
                              memory_peak_bytes=peak_dev))
    if profile is not None:
        result["device"].update(busy_s=profile["busy_s"],
                                window_s=profile["window_s"])
        result["breakdown"] = dict(device_ops=profile["device_ops"],
                                   idle_gaps=profile["idle_gaps"])
    result["checks"] = {k: dict(value=numbers[k], limit=lim)
                        for k, lim in check.LIMITS.items()}
    print(json.dumps(result), flush=True)
    return 0


def profiled_job(entry, fasta, cfg, work_dir, dev, cuda) -> dict:
    """One more job under torch.profiler, read back by trace.read_trace;
    its outputs and the trace are deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import read_trace

    prefix = os.path.join(work_dir, "profiled")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function("e2e_job"):
            entry.run_job(fasta, cfg, prefix, dev)
            if cuda:
                torch.cuda.synchronize(dev)
    path = os.path.join(work_dir, "trace.json")
    prof.export_chrome_trace(path)
    del prof
    written = out_bytes(entry.outputs(prefix)) + out_bytes([path])
    remove(entry.outputs(prefix))
    try:
        return dict(read_trace(path, "e2e_job"), written=written)
    finally:
        remove([path])


if __name__ == "__main__":
    sys.exit(main())
