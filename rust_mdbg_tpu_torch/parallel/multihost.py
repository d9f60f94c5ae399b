"""Multi-process mdBG construction over torch.distributed.

Counterpart of the JAX package's `parallel/multihost.py`: the sharded
pipeline of parallel/pipeline.py over a mesh that spans every process of a
torch.distributed group.  A process holds its shards as a JAX process
holds its local devices: one shard a visible card, or one shard on the CPU.
Global shard p * d_local + j is process p's local shard j, so a process's
rows of a round are a contiguous slice of the round's global rows.

Input (the reference's per-thread seq_io partitioning, main.rs:834-838):
a comma-separated file list is dealt round-robin over the processes; a
single plain FASTA is split by byte range, a record belonging to the range
that holds its '>' (fasta_range_records).  A process reads its share
through core/fastx_feed's native reader, which starts at the first
record of its range and stops after the range's last (counted by a byte
scan, count_range_records), and stages it as the sharded pipeline does.  Every process runs the same number of rounds
(one up-front exchange of record counts) and feeds empty rows past its own
end.

Output: each process writes the .sequences records of the nodes whose
crossing read it loaded (`prefix.h<pid>x<j>.sequences`: the record router
sends each node's payload to one of that process's shards), the S and L
lines of its shards as `prefix.gfapart.{s,l}<shard>`, and process 0
concatenates the parts in shard (= id) order into prefix.gfa.  With
MDBG_SHARDED_EDGES=0 every process gathers the node table, writes
`prefix.h<pid>.sequences` for its reads, and process 0 writes the GFA
through the gathered join, as the JAX package does.

Backend, by one rule and never as a fall-back: NCCL when every rank runs
on cards and no card serves two ranks, gloo otherwise (on the CPU, and for
two processes on one card, where NCCL refuses two ranks on one GPU).  The
default group is always gloo (counts, objects, barriers); the rule picks
the group that moves the window, record and POT rows.  Every collective
waits at most DEFAULT_TIMEOUT_S.

Launch recipe (one command per process):

  MDBG_COORD=host0:29500 MDBG_NPROCS=2 MDBG_PROC_ID=<0..1> \\
      python -m rust_mdbg_tpu_torch reads.fa -k 21 -l 14 -d 0.003 \\
          --multihost --prefix out [--device cpu]
"""

from __future__ import annotations

import datetime
import glob
import os
import shutil
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..params import Params
from ..utils.alloc import full_fast
from .mesh import ShardMesh

#: seconds any collective may wait before it raises
DEFAULT_TIMEOUT_S = 600

BACKEND_RULE = ("nccl when every rank runs on cards and no card serves two "
                "ranks; gloo otherwise")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the process group named by the arguments or by MDBG_COORD
    (host:port), MDBG_NPROCS and MDBG_PROC_ID; returns (process id, process
    count).  With nothing configured this process runs alone: (0, 1), no
    group."""
    coordinator = coordinator or os.environ.get("MDBG_COORD")
    if num_processes is None and os.environ.get("MDBG_NPROCS"):
        num_processes = int(os.environ["MDBG_NPROCS"])
    if process_id is None and os.environ.get("MDBG_PROC_ID"):
        process_id = int(os.environ["MDBG_PROC_ID"])
    if coordinator is None and num_processes is None:
        return 0, 1
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("multihost needs MDBG_COORD, MDBG_NPROCS and "
                         "MDBG_PROC_ID together")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def close_distributed():
    """Leave the process group after a run: a barrier, so that no process
    exits (taking down process 0's store) while another still finishes a
    collective, then destroy_process_group.  Nothing to do without a
    group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _card_id(dev: torch.device) -> str:
    if dev.type != "cuda":
        return ""
    uuid = torch.cuda.get_device_properties(dev).uuid
    return f"{socket.gethostname()}:{uuid}"


class ProcessMesh(ShardMesh):
    """This process's shards of a mesh over every process of the default
    torch.distributed group (or of this process alone when there is none).
    """

    def __init__(self, devices: list):
        self.nproc = dist.get_world_size() if dist.is_initialized() else 1
        self.pid = dist.get_rank() if dist.is_initialized() else 0
        self.d_local = len(devices)
        self.n = self.nproc * self.d_local
        self.local = [self.pid * self.d_local + j
                      for j in range(self.d_local)]
        self.devices = [torch.device(d) for d in devices]
        self.backend = "local"
        if self.nproc == 1:
            return
        cards = [_card_id(d) for d in self.devices]
        every = self.gather_objects(cards)
        if any(len(c) != self.d_local for c in every):
            raise RuntimeError("uneven shard counts per process: "
                               f"{[len(c) for c in every]}")
        flat = [c for cs in every for c in cs]
        self.backend = ("nccl" if all(flat) and len(set(flat)) == len(flat)
                        else "gloo")
        self.group = None
        self.transport = torch.device("cpu")
        if self.backend == "nccl":
            self.transport = self.devices[0]
            torch.cuda.set_device(self.transport)
            self.group = dist.new_group(
                backend="nccl",
                timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))

    def gather_objects(self, obj) -> list:
        if self.nproc == 1:
            return [obj]
        out = [None] * self.nproc
        dist.all_gather_object(out, obj)
        return out

    def barrier(self):
        if self.nproc > 1:
            dist.barrier()

    def _all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[d_local, w] int64 from every process -> [n, w]."""
        t = t.to(self.transport)
        out = [torch.empty_like(t) for _ in range(self.nproc)]
        dist.all_gather(out, t, group=self.group)
        return torch.cat(out).cpu()

    def all_gather(self, vals: list) -> list:
        if self.nproc == 1:
            return super().all_gather(vals)
        t = torch.tensor([int(v) for v in vals], dtype=torch.int64)[:, None]
        return self._all_gather_rows(t)[:, 0].tolist()

    def all_to_all(self, sends: list) -> list:
        if self.nproc == 1:
            return super().all_to_all(sends)
        n, dl, P = self.n, self.d_local, self.nproc
        cnt = self._all_gather_rows(torch.tensor(
            [list(c) for _, c in sends], dtype=torch.int64))   # [n src, n dst]
        width = sends[0][0].shape[1]
        blocks = [rows.split(list(c)) for rows, c in sends]
        # to process q: for each of its shards d, every local source's block
        send = torch.cat([blocks[i][d].to(self.transport)
                          for d in range(n) for i in range(dl)])
        me = slice(self.pid * dl, (self.pid + 1) * dl)
        in_splits = [int(cnt[me, q * dl:(q + 1) * dl].sum())
                     for q in range(P)]
        out_splits = [int(cnt[q * dl:(q + 1) * dl, me].sum())
                      for q in range(P)]
        recv = torch.empty((sum(out_splits), width), dtype=send.dtype,
                           device=self.transport)
        dist.all_to_all_single(recv, send, out_splits, in_splits,
                               group=self.group)
        # from process q: for each of my shards j, each of q's sources i
        parts = [[] for _ in range(dl)]
        off = 0
        for q in range(P):
            for j in range(dl):
                for i in range(dl):
                    c = int(cnt[q * dl + i, self.pid * dl + j])
                    parts[j].append(recv[off:off + c])
                    off += c
        return [torch.cat(p).to(dev) for p, dev in zip(parts, self.devices)]


def fasta_range_records(path: str, start: int, end: int):
    """Yield (id, seq_bytes) for records whose '>' byte lies in [start, end).

    Plain (uncompressed) FASTA only: a process seeks to `start`, scans to
    the next record boundary, and parses past `end` until its last record
    completes — the byte split that keeps every record exactly once across
    processes."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        fsize = f.tell()
        if start >= fsize:
            return
        buf = b""
        if start > 0:
            # discard the (possibly partial) record the range starts inside;
            # scan from start - 1 so that a record whose '>' sits exactly AT
            # the boundary (newline at start - 1) is found and kept here
            # (the previous range excludes it by its line_start >= end test)
            start -= 1
            f.seek(start)
            chunk = f.read(1 << 20)
            while chunk:
                i = chunk.find(b"\n>")
                if i >= 0:
                    buf = chunk[i + 1:]
                    start += i + 1
                    break
                start += len(chunk)
                chunk = f.read(1 << 20)
            if not chunk:
                return
        else:
            f.seek(start)
        pos = start  # byte offset of buf[0]
        name = None
        seq_parts: list[bytes] = []
        while True:
            if not buf:
                buf = f.read(1 << 20)
                if not buf:
                    break
            nl = buf.find(b"\n")
            if nl < 0:
                more = f.read(1 << 20)
                if not more:
                    nl = len(buf)
                    buf += b"\n"
                else:
                    buf += more
                    continue
            line, buf = buf[:nl], buf[nl + 1:]
            line_start = pos
            pos += nl + 1
            line = line.rstrip(b"\r")
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(seq_parts)
                if line_start >= end:
                    return  # the next record belongs to the following range
                name = line[1:].split()[0].decode()
                seq_parts = []
            elif line:
                seq_parts.append(line)
        if name is not None:
            yield name, b"".join(seq_parts)


def count_range_records(path: str, start: int, end: int) -> int:
    """Number of FASTA records whose '>' byte lies in [start, end) — the
    ownership rule of fasta_range_records, by a raw byte scan."""
    n = 0
    with open(path, "rb") as f:
        f.seek(0, 2)
        fsize = f.tell()
        if start >= fsize:
            return 0
        lo = max(0, start - 1)
        f.seek(lo)
        prev = b""   # a '>' at byte 0 is counted by the test below
        pos = lo
        while pos < end:
            chunk = f.read(min(1 << 20, end - pos))
            if not chunk:
                break
            n += (prev + chunk).count(b"\n>")
            prev = chunk[-1:]
            pos += len(chunk)
        if start == 0:
            f.seek(0)
            if f.read(1) == b">":
                n += 1
    return n


def host_inputs(reads_path: str, pid: int, nproc: int) -> list:
    """This process's input share: a list of (path, start, end)."""
    if "," in str(reads_path):
        files = [p for p in str(reads_path).split(",") if p]
        bad = [f for f in files if f.endswith((".gz", ".lz4"))]
        if bad:
            raise ValueError(
                f"multihost file-list sharding needs plain FASTA: {bad[0]}")
        return [(f, 0, os.path.getsize(f)) for i, f in enumerate(files)
                if i % nproc == pid]
    p = str(reads_path)
    if p.endswith((".gz", ".lz4")):
        raise ValueError(
            "multihost byte-range splitting needs plain FASTA; pass a "
            "comma-separated list of files to shard compressed inputs")
    fsize = os.path.getsize(p)
    step = (fsize + nproc - 1) // nproc
    return [(p, pid * step, min(fsize, (pid + 1) * step))]


def first_record_at(path: str, start: int) -> int:
    """Byte offset of the first record whose '>' lies at or after `start`
    (the ownership rule of count_range_records), or the file's size."""
    size = os.path.getsize(path)
    if start <= 0:
        return 0
    with open(path, "rb") as f:
        pos, prev = start - 1, b""
        f.seek(pos)
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return size
            i = (prev + chunk).find(b"\n>")
            if i >= 0:
                return pos - len(prev) + i + 1
            prev, pos = chunk[-1:], pos + len(chunk)


def share_chunks(inputs: list, B_host: int, L: int, mean_len: int = 0):
    """This process's share (host_inputs) as core/fastx_feed's tuples,
    through the native reader: of each (path, start, end), the records
    count_range_records places in [start, end) — the records
    fasta_range_records yields — parsed from the first of them on."""
    from ..core.fastx_feed import stream_chunks
    from .pipeline import read_range

    for path, start, end in inputs:
        take = count_range_records(path, start, end)
        if take:
            yield from read_range(
                stream_chunks(path, B_host, B_host, L, mean_len,
                              start=first_record_at(path, start)), 0, take)


def local_devices(device=None) -> list:
    """A process's shard devices: its visible cards, or the CPU when the
    caller asks for it."""
    from ..core.chunked import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", j)
                for j in range(torch.cuda.device_count())]
    return [dev]


def assemble_multihost(reads_path: str, params: Params, prefix: str,
                       device=None) -> dict:
    """Whole assembly over every process of the group; each process calls
    this (after init_distributed).  Stats as the JAX function's (nb_reads
    counts this process's reads), plus the backend, its rule, `phases`
    (with `spans` and `counters`: utils/timing.PhaseTimer's record of this
    process's `job`) and the per-shard windows and unique keys of this
    process's shards."""
    from ..core.fastx_feed import staged_rounds, staging_plan
    from ..io.sequences import remove_stale, write_records_native
    from ..ops import u64
    from ..ops.kernels import build_all
    from ..utils.timing import PhaseTimer
    from .edges import gfa_parts, route_records
    from .pipeline import (RawBlob, ShardedPipeline, exact_rounds,
                           gathered_gfa, host_nodes, prefetched,
                           record_spans, sharded_edges_enabled)

    timer = PhaseTimer()
    with timer.job():
        mesh = ProcessMesh(local_devices(device))
        pid, nproc, n, dl = mesh.pid, mesh.nproc, mesh.n, mesh.d_local
        with timer.phase("compile"):
            if mesh.devices[0].type == "cuda":
                build_all()
        inputs = host_inputs(reads_path, pid, nproc)
        B = ((params.batch_reads + n - 1) // n) * n
        B_host, B_local = B // nproc, B // n
        # sizes must agree on every process: take them from the whole input
        plan = staging_plan([p for p in str(reads_path).split(",") if p][0],
                            params)
        pipe = ShardedPipeline(mesh, params, B_local, plan["M"])

        if pid == 0:
            remove_stale(prefix)
        mesh.barrier()
        # one up-front exchange replaces a per-round liveness collective
        my_reads = sum(count_range_records(p, s, e) for p, s, e in inputs)
        rounds = max(1, -(-max(mesh.gather_objects(my_reads)) // B_host))
        raw = RawBlob(B_host)   # this process's reads, local row order
        feed = prefetched(staged_rounds(exact_rounds(
            share_chunks(inputs, B_host, plan["L"], plan["mean_len"]), B_host,
            plan["L"]), plan))
        lens0 = np.zeros(B_host, dtype=np.int32)
        ((empty, *_),) = staged_rounds(
            [(full_fast((B_host, plan["L"]), 5, np.uint8), lens0, None, None,
              0)], plan)
        read_base = 0
        try:
            for _ in range(rounds):
                with timer.phase("feed"):
                    item = next(feed, None)
                if item is None:
                    host, lens = empty, lens0
                    raw.empty_round()
                else:
                    host, lens, blob, blob_off, fill = item
                    raw.add(blob, blob_off, fill)
                with timer.phase("steps"):
                    pipe.step(host, lens, read_base)
                read_base += B
        finally:
            feed.close()
        with timer.phase("finalize"):
            shards, bases = pipe.finalize()
        total = bases[-1]
        stats = dict(nb_reads=raw.n_reads, n_devices=n,
                     n_hosts=nproc, rounds=rounds, backend=mesh.backend,
                     backend_rule=BACKEND_RULE, device=str(mesh.devices[0]),
                     staged_shapes=[[B_local, w] for w in sorted(pipe.widths)],
                     shard_windows=[r["windows"] for r in shards],
                     shard_unique_keys=[r["n_unique"] for r in shards])
        mc = pipe.mc

        if sharded_edges_enabled() and total:
            with timer.phase("sequences"):
                if not params.no_basespace:
                    blob, offsets = raw.arrays()
                    recv = route_records(mesh, shards, B, B_host, dl)
                    for j, r in enumerate(recv):
                        if not r.shape[0]:
                            continue
                        gid = r[:, 0].to(torch.int32).cpu().numpy().view(
                            np.uint32)
                        meta = r[:, 1:1 + mc].to(torch.int32).cpu().numpy() \
                            .view(np.uint32)
                        rows = meta[:, 4].astype(np.int64)
                        # the host's processes share its cores: one
                        # writer thread a process
                        write_records_native(
                            f"{prefix}.h{pid}x{j}.sequences", params.k,
                            params.l, gid, u64.to_numpy(r[:, 1 + mc:]), blob,
                            *record_spans(meta, offsets,
                                          (rows // B) * B_host + rows % B_host,
                                          params.l), workers=1)
            with timer.phase("gfa"):
                parts, nb_edges, n_removed = gfa_parts(mesh, shards, bases,
                                                       params.presimp)
                for s, (s_text, l_text) in zip(mesh.local, parts):
                    with open(f"{prefix}.gfapart.s{s:04d}", "w") as f:
                        f.write(s_text)
                    with open(f"{prefix}.gfapart.l{s:04d}", "w") as f:
                        f.write(l_text)
                mesh.barrier()
                win = sum(int(r["count"].sum()) for r in shards)
                tot = np.sum(mesh.gather_objects([win, nb_edges, n_removed]),
                             axis=0)
                if pid == 0:
                    _concat_parts(prefix, n)
            stats.update(nb_windows=int(tot[0]), nb_edges=int(tot[1]),
                         presimp_removed=int(tot[2]), nb_nodes=total,
                         distributed_edges=True)
        else:
            # gathered single-host table (MDBG_SHARDED_EDGES=0)
            nodes = mesh.gather_objects(host_nodes(shards))
            nodes = {key: np.concatenate([t[key] for t in nodes])
                     for key in ("count", "meta", "vec")}
            index = np.arange(total, dtype=np.uint32)
            with timer.phase("sequences"):
                meta = nodes["meta"]
                rows = meta[:, 4].astype(np.int64)
                mine = np.nonzero((rows % B) // B_host == pid)[0]
                if not params.no_basespace and mine.size:
                    blob, offsets = raw.arrays()
                    write_records_native(
                        f"{prefix}.h{pid}.sequences", params.k, params.l,
                        index[mine], nodes["vec"][mine], blob,
                        *record_spans(meta[mine], offsets,
                                      (rows[mine] // B) * B_host
                                      + rows[mine] % B_host, params.l),
                        workers=1)
            stats["nb_windows"] = int(nodes["count"].sum())
            with timer.phase("gfa"):
                if pid == 0:
                    stats.update(gathered_gfa(f"{prefix}.gfa", params, nodes,
                                              index))
        mesh.barrier()
    stats.update(timer.stats())
    return stats


def _concat_parts(prefix: str, n: int):
    """Process 0: H, then every shard's S part, then every shard's L part,
    in shard order, into prefix.gfa.  Without a shared file system the
    parts of other hosts are missing here and stay as they are."""
    s_parts = sorted(glob.glob(f"{prefix}.gfapart.s*"))
    l_parts = sorted(glob.glob(f"{prefix}.gfapart.l*"))
    if len(s_parts) != n or len(l_parts) != n:
        print(f"[multihost] GFA parts left as {prefix}.gfapart.* (no shared "
              "file system); concatenate H + s* + l*")
        return
    with open(f"{prefix}.gfa", "w", buffering=1 << 20) as out:
        out.write("H\tVN:Z:1.0\n")
        for p in s_parts + l_parts:
            with open(p) as f:
                shutil.copyfileobj(f, out)
            os.remove(p)
