"""Device-side GFA (k-1)-overlap edge join.

Counterpart of the JAX package's `ops/edge_join.py`.  It replaces the host
km_index hash join (native/gfawriter.cpp finish_impl, rust-mdbg
src/main.rs:1014-1106) with one sort-based equality join on the device, so
the per-node overlap fingerprints (gk, 65 B/node) never leave it: the host
receives only the POT list (the candidate edges before presimp), 9 B per
candidate.

The POT list comes out in the host join's emission order:

  km_index insertion order   entry e = 2j + {0: prefix key, 1: suffix key},
                             e ascending == (node, pre-before-suf)
  probe order                p = 2i + {0: suffix key, 1: prefix key}
  per candidate j            the four orientation cases in fixed order
                             (++, +-, -+, --)

The catalog entries and the probes are concatenated, entries first, and
sorted stably by their 128-bit key, so every probe lands behind the run of
entries that share its key, in insertion order.  Each probe is expanded to
its (probe, candidate) pairs, the four case tests are made per pair, and
`torch.nonzero` of the [pairs, 4] case tensor returns the hits in row-major
order, which is that emission order.  A probe with more than G_SLOTS
candidates is reported as overflow and no list is made: the caller falls
back to the host join, as it does after the JAX join.

Rows are addressed by int64 indices throughout, so no tag bit shares a word
with an order and no node count below 2^32 (the u32 ids of the native
writer) can collide.

presimp (main.rs:1086-1090) stays on the host (native gfa_finish_pot): it
needs whole-run abundances and f64 arithmetic.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import u64

G_SLOTS = 16  # candidates per probe, the JAX join's u64 bitmask width / 4

#: probes per extraction block: bounds the pair gathers (at most
#: G_SLOTS * 128 B per probe) whatever the catalog holds
_PROBE_BLOCK = 1 << 18


def edge_join(gk: torch.Tensor, gflag: torch.Tensor):
    """Sort-join the per-node overlap keys into the POT candidate list.

    gk    int64 [n, 8]  (Fs, Fp, FsR, FpR) as (lo, hi) pairs of u64 bits,
                        rows in node-id order (overlap_keys_device's layout)
    gflag uint8 [n]     bit 0: suffix already canonical, bit 1: prefix

    Returns (pot_i, pot_j, pot_c, g_overflow): candidate edge endpoints as
    int64 node ids, pot_c = (ki << 2) | case as uint8 (case 0 ++, 1 +-,
    2 -+, 3 --; ki 0 = probed by the suffix key), and the number of probes
    with more than G_SLOTS candidates.  With g_overflow > 0 the three lists
    are None.
    """
    n = gk.shape[0]
    dev = gk.device
    Fs, Fp, FsR, FpR = gk[:, 0:2], gk[:, 2:4], gk[:, 4:6], gk[:, 6:8]
    ksuf = torch.where((gflag & 1).bool()[:, None], Fs, FsR)
    kpre = torch.where((gflag & 2).bool()[:, None], Fp, FpR)

    # rows [0, 2n): catalog entries e = 2j + kc; rows [2n, 4n): probes
    # p = 2i + ki.  A stable sort by key keeps entries before probes and
    # both in their own order.
    keys = torch.cat([torch.stack([kpre, ksuf], dim=1).reshape(2 * n, 2),
                      torch.stack([ksuf, kpre], dim=1).reshape(2 * n, 2)])
    perm = u64.lexsort([keys[:, 1], keys[:, 0]], [True, True])
    skeys = keys[perm]
    is_probe = perm >= 2 * n

    pos = torch.arange(4 * n, device=dev)
    head = torch.ones(4 * n, dtype=torch.bool, device=dev)
    head[1:] = (skeys[1:] != skeys[:-1]).any(dim=1)
    run_lo = torch.cummax(torch.where(head, pos, 0), dim=0).values
    ent_before = torch.cumsum(~is_probe, dim=0) - (~is_probe).long()
    # a probe's candidates: the entries of its run, all in front of it
    p_of = perm[is_probe] - 2 * n
    p_lo = torch.empty(2 * n, dtype=torch.int64, device=dev)
    p_cnt = torch.empty(2 * n, dtype=torch.int64, device=dev)
    p_lo[p_of] = run_lo[is_probe]
    p_cnt[p_of] = (ent_before - ent_before[run_lo])[is_probe]
    g_over = int((p_cnt > G_SLOTS).sum())
    if g_over:
        return None, None, None, g_over
    node_at = perm >> 1     # the catalog node of a sorted entry row

    out_i, out_j, out_c = [], [], []
    for b0 in range(0, 2 * n, _PROBE_BLOCK):
        cnt = p_cnt[b0 : b0 + _PROBE_BLOCK]
        lo = p_lo[b0 : b0 + _PROBE_BLOCK]
        # (probe, candidate) pairs, probe-major, candidates in entry order
        local = torch.repeat_interleave(
            torch.arange(cnt.shape[0], device=dev), cnt)
        first = torch.cumsum(cnt, dim=0) - cnt
        g = torch.arange(local.shape[0], device=dev) - first[local]
        p = local + b0
        j = node_at[lo[local] + g]
        a, b = gk[p >> 1], gk[j]
        # fs1 == fp2 (++), fs1 == fsr2 (+-), fpr1 == fp2 (-+),
        # fpr1 == fsr2 (--)
        cases = torch.stack([
            (a[:, 0:2] == b[:, 2:4]).all(dim=1),
            (a[:, 0:2] == b[:, 4:6]).all(dim=1),
            (a[:, 6:8] == b[:, 2:4]).all(dim=1),
            (a[:, 6:8] == b[:, 4:6]).all(dim=1)], dim=1)
        pair, case = torch.nonzero(cases, as_tuple=True)
        out_i.append(p[pair] >> 1)
        out_j.append(j[pair])
        out_c.append((((p[pair] & 1) << 2) | case).to(torch.uint8))
    if not out_i:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z, z.to(torch.uint8), 0
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_c), 0


class PotJoin:
    """Handle of one device edge join, the counterpart of the JAX package's
    `ops/sort_count.PotJoin` (kept here, beside the join it wraps).  The
    join runs and its copies to the host start at construction; resolve()
    waits for the copies.  The torch join sizes its result from the data,
    so there is no edge capacity and no re-run.

    device_ms is the join's time on the card between two CUDA events (None
    on the CPU); dispatch_s the host time of the construction, with the
    join's own host syncs (`nonzero`, `repeat_interleave`); wall_s the host
    time from dispatch to the fetched list, with whatever the caller did in
    between.  device_ms and wall_s are set by resolve()."""

    def __init__(self, gk: torch.Tensor, gflag: torch.Tensor):
        self._t0 = time.perf_counter()
        self.device_ms = None
        self.wall_s = None
        self.n_pot = None
        self._events = None
        if gk.device.type == "cuda":
            self._events = tuple(torch.cuda.Event(enable_timing=True)
                                 for _ in range(3))
            self._events[0].record()
        pot_i, pot_j, pot_c, self.g_overflow = edge_join(gk, gflag)
        if self._events:
            self._events[1].record()
        self._host = None
        if not self.g_overflow:
            # node ids fit u32 (the native writer's width)
            self._host = (pot_i.to(torch.int32), pot_j.to(torch.int32), pot_c)
            if self._events:
                # non-blocking copies into pinned memory: core/chunked feeds
                # the S lines to the GFA writer while they land
                self._host = tuple(
                    torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    .copy_(t, non_blocking=True) for t in self._host)
                self._events[2].record()
        self.dispatch_s = time.perf_counter() - self._t0

    def resolve(self):
        """(pot_i, pot_j, pot_c) as numpy u32, u32, u8 in host-join emission
        order, or None when some key group exceeded G_SLOTS."""
        if self._events:
            self._events[2 if self._host is not None else 1].synchronize()
            self.device_ms = self._events[0].elapsed_time(self._events[1])
        self.wall_s = time.perf_counter() - self._t0
        if self._host is None:
            return None
        pot_i, pot_j, pot_c = (t.numpy() for t in self._host)
        self.n_pot = len(pot_i)
        return pot_i.view(np.uint32), pot_j.view(np.uint32), pot_c


class DeviceKeyCatalog:
    """Bounded device-resident overlap-key catalog for core/chunked.

    Each chunk's crossing keys are appended on the device (rows arrive in
    crossing-occurrence order, the order node ids are assigned in within a
    chunk); at GFA time the host uploads the id-order permutation and the
    sort-join ships only the POT list.

    Bounded: `cap` rows of 65 B.  When a chunk would not fit, the caller
    spills the catalog to the host (one bulk fetch) and goes on with the
    host join — exactness is never at stake, only transfer volume.  Blocks
    are kept as appended, exactly n_new rows each, and concatenated once.
    """

    def __init__(self, cap: int):
        self.cap = int(cap)
        self.n = 0
        self._gk: list[torch.Tensor] = []
        self._gf: list[torch.Tensor] = []

    def fits(self, n_new: int) -> bool:
        return self.n + n_new <= self.cap

    def append(self, gk: torch.Tensor, gflag: torch.Tensor) -> None:
        """gk int64 [n_new, 8], gflag uint8 [n_new] on the device.  The
        caller has checked fits(n_new)."""
        self._gk.append(gk)
        self._gf.append(gflag)
        self.n += gk.shape[0]

    def _take(self):
        """The catalog's rows in append order; empties the catalog."""
        if self._gk:
            gk, gf = torch.cat(self._gk), torch.cat(self._gf)
        else:
            gk = torch.zeros((0, 8), dtype=torch.int64)
            gf = torch.zeros((0,), dtype=torch.uint8)
        self._gk, self._gf, self.n = [], [], 0
        return gk, gf

    def spill(self):
        """Fetch the catalog to the host: (gk u64 [n, 8], gflag u8 [n]) in
        append order.  The catalog is empty afterwards."""
        gk, gf = self._take()
        return u64.to_numpy(gk), gf.cpu().numpy()

    def join(self, order: np.ndarray):
        """Permute the catalog into node-id order (order[r] = append row of
        the node with id rank r) and run the device edge join.  Returns
        (PotJoin, gk, gflag): the permuted device tensors serve the host
        join if the device join overflows G_SLOTS."""
        gk, gf = self._take()
        o = torch.from_numpy(np.asarray(order, dtype=np.int64)).to(gk.device)
        gk, gf = gk[o], gf[o]
        return PotJoin(gk, gf), gk, gf


def catalog_from_numpy(gk: np.ndarray, gflag: np.ndarray, cap: int,
                       device) -> DeviceKeyCatalog:
    """A catalog holding the given rows (gk u64 [n, 8], gflag u8 [n]) —
    the contents of a JAX `DeviceKeyCatalog` fetched to numpy — so that
    both packages join from the same state."""
    cat = DeviceKeyCatalog(cap)
    cat.append(u64.from_numpy(gk, device),
               torch.from_numpy(np.ascontiguousarray(gflag, dtype=np.uint8))
               .to(device, copy=True))
    return cat
