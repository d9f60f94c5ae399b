"""A 1-D mesh of shards and the three collectives the sharded stages use.

Counterpart of the JAX package's `parallel/mesh.py`.  There a `shard_map`
body runs once per device and calls `all_to_all`, `all_gather` and `psum`
inside; here each body is written as phases over the list of this
process's shards, split at its collectives, and the mesh carries the
exchange.  Two meshes share the phase code:

- `ShardMesh`: every shard in this process.  Shard s lives on
  cuda:(s mod device_count) or, when the caller asks for it, on the CPU; on
  one card `--mesh 4` is four shards on cuda:0, as the JAX tests run four
  virtual CPU devices, and the output is a function of n alone.
- `parallel/multihost.ProcessMesh`: this process's shards of a mesh that
  spans processes joined by torch.distributed.

Shard order is global: the shards of process p are p * d_local + j.
"""

from __future__ import annotations

import torch


class ShardMesh:
    """n shards, all held by this process: `local` lists their global
    indices and `devices` their devices, in the same order."""

    def __init__(self, n: int, devices: list):
        if n < 1 or len(devices) != n:
            raise ValueError(f"{n} shards need {n} devices, got "
                             f"{len(devices)}")
        self.n = n
        self.local = list(range(n))
        self.devices = [torch.device(d) for d in devices]

    def all_to_all(self, sends: list) -> list:
        """sends[i] = (rows, counts) for local shard i: rows a 2-D tensor
        grouped by destination shard in shard order, counts[d] (ints) the
        rows bound for shard d.  Returns, for each local shard, the rows it
        receives: every source's block for it, concatenated in source
        order (the JAX all_to_all's tiled layout without its padding)."""
        blocks = [rows.split(list(counts)) for rows, counts in sends]
        return [torch.cat([b[d].to(dev) for b in blocks])
                for d, dev in zip(self.local, self.devices)]

    def all_gather(self, vals: list) -> list:
        """One int per local shard -> the n values in shard order."""
        return [int(v) for v in vals]

    def psum(self, vals: list) -> int:
        return sum(self.all_gather(vals))

    def gather_objects(self, obj) -> list:
        """One object per process -> the objects of every process, in
        process order."""
        return [obj]


def make_mesh(n: int, device=None) -> ShardMesh:
    """n shards on the card(s) (shard s on cuda:(s mod device_count)), or
    all on `device` when that names the CPU.  With no device and no card
    this raises, as every entry point of the port does."""
    from ..core.chunked import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        return ShardMesh(n, [torch.device("cuda", s % count)
                             for s in range(n)])
    return ShardMesh(n, [dev] * n)
