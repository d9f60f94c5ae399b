"""Port parity for the whole-run output emission (core/device_out): the
recompute path against the vector path, single-shot against phased against
the device join and its host-join fallback, each also against the JAX
package's run on the same arrays (.gfa bytes, .sequences records), plus the
deferred-abundance GFA builder and LazyNodes' row ranges."""

import glob

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rust_mdbg_tpu.core.device_out import (
    emit_device_outputs as jax_emit)
from rust_mdbg_tpu.ops.extract import DeviceExtractor
from rust_mdbg_tpu.ops.sort_count import (
    DeviceNodeCounter as JaxCounter, counter_flags as jax_flags,
    make_fused_construct)
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch.core.device_out import (
    LazyNodes, PhasedEmitter, emit_device_outputs, keys6_from_gk)
from rust_mdbg_tpu_torch.core.graph import IncrementalGFA
from rust_mdbg_tpu_torch.ops import edge_join
from rust_mdbg_tpu_torch.ops.extract import capacity
from rust_mdbg_tpu_torch.ops.sort_count import (DeviceNodeCounter,
                                                construct_batches)
from rust_mdbg_tpu_torch.params import Params
from rust_mdbg_tpu_torch.utils.seq import CODE_BASE

from torch_corpus import gfa_bytes, records

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

KW = dict(k=5, l=8, density=0.05, min_kmer_abundance=2, batch_reads=8,
          reads_already_hpc=True)
P = Params(**KW)
L, B, N_READS = 2048, 8, 48
NB = N_READS // B


def _arrays():
    rng = np.random.default_rng(7)
    G = 60000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = rng.integers(0, G - L, N_READS)
    codes = np.stack([genome[s : s + L] for s in starts]).astype(np.uint8)
    lengths = np.full(N_READS, L, dtype=np.int32)
    return CODE_BASE[genome], starts.astype(np.int64), codes, lengths


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's single-shot outputs on the arrays, by the vector
    path and by the recompute path: {emit_keys: prefix}."""
    blob, starts, codes, lengths = _arrays()
    p = JaxParams(engine="device", **KW)
    M = DeviceExtractor(p).capacity(L)
    out = {}
    for emit_keys in (False, True):
        c = JaxCounter(k=p.k, M=M, read_cap=N_READS, node_cap=1 << 12,
                       minab=2, emit_overlap_keys=emit_keys, **jax_flags(p))
        bufs, _n, n_over = make_fused_construct(p, B, L, M, NB)(
            jnp.asarray(codes), jnp.asarray(lengths), c.buffers)
        c.buffers = bufs
        assert int(n_over) == 0
        prefix = str(tmp_path_factory.mktemp("jax") / f"keys{emit_keys}")
        jax_emit(prefix, p, c.finalize(lazy=True), blob, starts)
        out[emit_keys] = prefix
    return out


def _counter(emit_keys):
    M = capacity(P, L)
    return DeviceNodeCounter(k=P.k, M=M, read_cap=N_READS, w_slot=M - P.k + 1,
                             chunk_slots=1, device="cpu", minab=2,
                             with_ext=False, emit_overlap_keys=emit_keys)


def _construct(c, codes, lengths, lo, hi):
    _n, n_over = construct_batches(
        P, torch.from_numpy(codes), torch.from_numpy(lengths), c.buffers,
        B=B, M=c.M, w_slot=c.W_slot, batch_lo=lo, batch_hi=hi)
    assert int(n_over) == 0


@pytest.mark.parametrize("emit_keys", [False, True])
def test_single_shot_matches_jax(tmp_path, jax_run, emit_keys):
    """The vector path (k-vectors fetched in chunks) and the recompute path
    (fingerprints and record positions from the device, minimizers
    re-derived by the writer)."""
    blob, starts, codes, lengths = _arrays()
    c = _counter(emit_keys)
    _construct(c, codes, lengths, 0, NB)
    nodes = c.finalize(lazy=True)
    assert nodes.has("gk") == nodes.has("mpos") == emit_keys
    prefix = str(tmp_path / "t")
    g = emit_device_outputs(prefix, P, nodes, blob, starts)
    assert g["nb_nodes"] == nodes.n_pass > 20 and g["nb_edges"] > 20
    assert gfa_bytes(prefix) == gfa_bytes(jax_run[emit_keys])
    assert records(prefix) == records(jax_run[emit_keys])
    # recompute path = vector path, on both sides
    assert gfa_bytes(jax_run[False]) == gfa_bytes(jax_run[True])
    assert records(jax_run[False]) == records(jax_run[True])


def test_recompute_without_positions_matches(tmp_path, jax_run, monkeypatch):
    """MDBG_NO_MPOS=1: no position plane; the writer rolls over each
    record instead."""
    monkeypatch.setenv("MDBG_NO_MPOS", "1")
    blob, starts, codes, lengths = _arrays()
    c = _counter(True)
    _construct(c, codes, lengths, 0, NB)
    nodes = c.finalize(lazy=True)
    assert nodes.has("gk") and not nodes.has("mpos")
    prefix = str(tmp_path / "t")
    emit_device_outputs(prefix, P, nodes, blob, starts)
    assert gfa_bytes(prefix) == gfa_bytes(jax_run[True])
    assert records(prefix) == records(jax_run[True])


@pytest.mark.parametrize("mode", ["phased", "device_join",
                                  "device_join_fallback", "g_slots_overflow"])
def test_phased_matches_single_shot(tmp_path, jax_run, monkeypatch, mode):
    """Two-phase emission — a reduction over the first two batches bound
    BEFORE the rest is constructed in place and run after it — writes the
    bytes of the single shot: with the host join per phase, with the device
    join at the finish, and with the host join standing in for a device
    join that was not made or that overflowed G_SLOTS."""
    blob, starts, codes, lengths = _arrays()
    c = _counter(True)
    n1 = 2
    _construct(c, codes, lengths, 0, n1)
    pending = c.finalize_dispatch(prefix_rows=n1 * B * c.W_slot)
    _construct(c, codes, lengths, n1, NB)
    dj = mode != "phased"
    ph1 = c.finalize_resolve(pending, lazy=True,
                             gk_mode="none" if dj else "host")
    assert ph1.has("gk") == (not dj)
    prefix = str(tmp_path / "t")
    em = PhasedEmitter(prefix, P, blob, starts, device_join=dj)
    em.emit_phase(ph1)
    nodes = c.finalize(lazy=True, row_lo=ph1.n_pass,
                       gk_mode="device" if dj else "host")
    assert nodes.n_pass > ph1.n_pass > 0 and nodes.n_new > 0
    if mode == "g_slots_overflow":
        monkeypatch.setattr(edge_join, "G_SLOTS", 0)
    pot = c.edge_join(nodes) if dj else None
    assert (pot is not None) == dj
    if mode == "device_join_fallback":
        pot = None
    em.emit_phase(nodes)
    g = em.finish(nodes.fetch_full("count"), pot=pot)
    assert em.edge_join == ("device" if mode == "device_join" else "host")
    assert g["nb_nodes"] == nodes.n_pass
    assert gfa_bytes(prefix) == gfa_bytes(jax_run[True])
    assert records(prefix) == records(jax_run[True])
    # shard files stay glob-compatible, one or more per phase
    assert len(glob.glob(prefix + ".*.sequences")) >= 2


def test_deferred_abundance_writes_the_eager_bytes(tmp_path):
    """IncrementalGFA(defer_abundance=True) fed in two chunks with zero
    abundances + set_abundance == the eager builder fed the counts."""
    _blob, _starts, codes, lengths = _arrays()
    c = _counter(True)
    _construct(c, codes, lengths, 0, NB)
    res = c.finalize()
    n = len(res["index"])
    meta = res["meta"]
    cols = (meta[:, 0], (meta[:, 1] & 0x7FFFFFFF).astype(np.uint16),
            (meta[:, 2] & 0x7FFFFFFF).astype(np.uint16))
    keys6 = keys6_from_gk(res["gk"], res["gflag"])

    eager = IncrementalGFA(cap_hint=n)
    eager.add_chunk(res["index"], res["count"], *cols, keys6)
    ge = eager.finish(str(tmp_path / "eager.gfa"), presimp=0.01)

    late = IncrementalGFA(defer_abundance=True)
    h = n // 3
    for s in (slice(0, h), slice(h, n)):
        late.add_chunk(res["index"][s], np.zeros(len(res["index"][s])),
                       *(a[s] for a in cols), tuple(a[s] for a in keys6))
    with pytest.raises(ValueError, match="abundances"):
        late.set_abundance(res["count"][:-1])
    late.set_abundance(res["count"])
    gl = late.finish(str(tmp_path / "late.gfa"), presimp=0.01)
    assert ge == gl and ge["nb_edges"] > 20
    assert (tmp_path / "eager.gfa").read_bytes() \
        == (tmp_path / "late.gfa").read_bytes()
    assert b"KC:i:0" not in (tmp_path / "late.gfa").read_bytes()


def test_lazy_nodes_row_ranges():
    """fetch() and vec_chunks() serve rows [row_lo, n_pass), fetch_full()
    every row; u32 and u64 fields come back in their unsigned types."""
    n, k = 100, 5
    rng = np.random.default_rng(3)
    vec = rng.integers(0, 1 << 64, (n, k), dtype=np.uint64)
    out = dict(n_pass=n, n_unique=n,
               vec=torch.from_numpy(vec.view(np.int64)),
               meta=torch.arange(n * 5).reshape(n, 5) + (1 << 31),
               count=torch.arange(n) + 2,
               gflag=torch.arange(n, dtype=torch.uint8) & 3)
    nodes = LazyNodes(out, row_lo=37, chunk_rows=16)
    assert nodes.n_new == 63 and not nodes.has("gk")
    meta = nodes.fetch("meta")
    assert meta.dtype == np.uint32 and meta.shape == (63, 5)
    assert meta[0, 0] == 37 * 5 + (1 << 31)
    assert np.array_equal(nodes.fetch("count"), np.arange(37, n) + 2)
    assert np.array_equal(nodes.fetch_full("count"), np.arange(n) + 2)
    assert np.array_equal(nodes.fetch("gflag"), np.arange(37, n) & 3)
    chunks = list(nodes.vec_chunks())
    assert [r for r, _ in chunks] == [0, 16, 32, 48]
    got = np.concatenate([v for _, v in chunks])
    assert got.dtype == np.uint64 and np.array_equal(got, vec[37:])
    # vectors asked of a result that staged none are staged on demand
    late = LazyNodes(out, want_vec=False)
    assert np.array_equal(np.concatenate([v for _, v in late.vec_chunks()]),
                          vec)
    assert nodes.device("vec") is out["vec"]
