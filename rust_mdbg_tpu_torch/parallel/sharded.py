"""Routing by key owner: the route of the sharded pipeline.

Counterpart of the routing half of the JAX package's `parallel/sharded.py`,
the TPU-native form of the reference's shared-memory concurrency
(rust-mdbg src/main.rs: the seq_io worker pool, the DashMap counter): every
shard extracts windows from its rows and routes each to owner = key_lo mod
n by one all_to_all.  The extraction, the route and the owner's count are
those of parallel/pipeline.ShardedPipeline; the JAX package's one-shot
count step has no second copy here.

The owner rule reads key_lo as an unsigned 64-bit value
(`u64.mod_small`): int64 `%` gives the wrong owner for every key at or
above 2^63 when n is not a power of two.

Routes are sized from the data: a shard sends each destination exactly its
rows (no route_cap, no drops).  Within a destination's block the rows keep
their order, which a stable sort by owner gives; the JAX code ranks rows by
a [N, n + 1] one-hot cumsum instead.
"""

from __future__ import annotations

import torch

from ..ops import u64


def owner_of(key_lo: torch.Tensor, n: int) -> torch.Tensor:
    """Owner shard of each key: unsigned key_lo mod n (int64)."""
    return u64.mod_small(key_lo, n)


def bucket_by_owner(rows: torch.Tensor, owner: torch.Tensor, n: int):
    """Group rows by owner shard for `mesh.all_to_all`: (rows ordered by
    owner, rows keeping their order within an owner; the count bound for
    each shard, as ints)."""
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=n)
    return rows[order], counts.tolist()
