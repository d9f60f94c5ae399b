"""Port parity for the sharded stages: `finalize_windows` against
`jax.jit(_finalize)` (random padded buffers, and the buffers of one JAX
sharded pipeline step carried across with window_buffers_from_numpy), a
round of the port's sharded pipeline against `make_sharded_count_step` on
the 8 virtual CPU devices, the unsigned owner rule against numpy's uint64
`%`, the mesh's all_to_all layout, and the distributed join's bitmask
blocks past G_SLOTS against the JAX package's gathered join.  Integers
throughout: every comparison is exact."""

import functools

import numpy as np
import pytest
import torch

import jax

from rust_mdbg_tpu.ops.sort_count import _finalize
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rust_mdbg_tpu.parallel.pipeline import make_sharded_pipeline
from rust_mdbg_tpu.parallel.sharded import (
    make_sharded_count_step as jax_count_step,
    sharded_counts_to_host as jax_counts_to_host)
from rust_mdbg_tpu.core.graph import build_gfa as jax_build_gfa
from rust_mdbg_tpu_torch.core.graph import build_gfa
from rust_mdbg_tpu_torch.ops import u64
from rust_mdbg_tpu_torch.ops.pack import pack_codes_np
from rust_mdbg_tpu_torch.ops.sort_count import (finalize_windows,
                                                window_buffers_from_numpy)
from rust_mdbg_tpu_torch.parallel import edges
from rust_mdbg_tpu_torch.parallel.mesh import ShardMesh
from rust_mdbg_tpu_torch.parallel.pipeline import ShardedPipeline
from rust_mdbg_tpu_torch.parallel.sharded import owner_of
from rust_mdbg_tpu_torch.params import Params

torch.set_num_threads(2)

N_ROWS, K = 2000, 5


def _padded_buffers(seed: int, n_keys: int):
    """Window buffers as the sharded pipeline leaves them: keys drawn with
    repeats from a pool (half of the lo halves at or above 2^63, a few keys
    sighted 20+ times), a fifth of the rows empty (valid bit clear, zero
    keys), random meta and vectors."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64, (n_keys, 2), dtype=np.uint64)
    pool[: n_keys // 2, 0] |= np.uint64(1 << 63)
    weights = np.ones(n_keys)
    weights[:5] = 60.0
    pick = rng.choice(n_keys, N_ROWS, p=weights / weights.sum())
    lo, hi = pool[pick, 0].copy(), pool[pick, 1].copy()
    meta = rng.integers(0, 2**31, (N_ROWS, 6), dtype=np.uint64).astype(
        np.uint32)
    valid = rng.random(N_ROWS) >= 0.2
    meta[:, 1] |= np.uint32(1 << 31)
    meta[~valid] = 0
    lo[~valid] = 0
    hi[~valid] = 0
    vecs = rng.integers(0, 2**64, (N_ROWS, K), dtype=np.uint64)
    return lo, hi, meta, vecs


@functools.lru_cache(maxsize=None)
def _jax_finalize(minab: int, node_cap: int):
    return jax.jit(functools.partial(_finalize, minab=minab,
                                     node_cap=node_cap, keep_all=False))


def _jax_nodes(bufs, minab: int, node_cap: int) -> dict:
    res = _jax_finalize(minab, node_cap)(*bufs)
    m = int(res["n_pass"])
    out = {key: np.asarray(res[key])[:m]
           for key in ("key_lo", "key_hi", "count", "meta", "vec")}
    out.update(n_pass=m, n_unique=int(res["n_unique"]),
               node_overflow=int(res["node_overflow"]))
    return out


def _port_nodes(bufs, minab: int) -> dict:
    res = finalize_windows(*window_buffers_from_numpy(*bufs, "cpu"),
                           minab=minab)
    return dict(key_lo=u64.to_numpy(res["key_lo"]),
                key_hi=u64.to_numpy(res["key_hi"]),
                count=res["count"].numpy().astype(np.uint32),
                meta=res["meta"].numpy().astype(np.uint32),
                vec=u64.to_numpy(res["vec"]), n_pass=res["n_pass"],
                n_unique=res["n_unique"], first_occ=res["first_occ"])


def _assert_same_nodes(got: dict, want: dict):
    assert got["n_pass"] == want["n_pass"] > 0
    for key in ("key_lo", "key_hi", "count", "meta", "vec"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("minab", [1, 2, 17])
def test_finalize_windows_matches_jax(minab):
    """Counts, crossing meta and vector, first-occurrence order: equal to
    `_finalize` with node_cap above the unique count."""
    bufs = _padded_buffers(seed=minab, n_keys=300)
    want = _jax_nodes(bufs, minab, N_ROWS - 1)
    assert want["node_overflow"] == 0
    got = _port_nodes(bufs, minab)
    _assert_same_nodes(got, want)
    assert got["n_unique"] == want["n_unique"]
    assert bool((got["first_occ"][1:] > got["first_occ"][:-1]).all())


def test_finalize_windows_keeps_keys_past_the_jax_node_cap():
    """At node_cap 1 << 7 JAX keeps the first 128 unique keys in key order
    and reports the rest as node_overflow; the port keeps every key, and
    equals JAX run with a cap that fits them all."""
    bufs = _padded_buffers(seed=5, n_keys=600)
    capped = _jax_nodes(bufs, 1, 1 << 7)
    assert capped["node_overflow"] > 0
    got = _port_nodes(bufs, 1)
    assert got["n_pass"] == got["n_unique"] == capped["n_unique"]
    assert got["n_pass"] > capped["n_pass"]
    _assert_same_nodes(got, _jax_nodes(bufs, 1, N_ROWS - 1))


@pytest.mark.parametrize("hpc", [False, True])
def test_finalize_windows_on_a_jax_pipeline_step(hpc):
    """One round of the JAX sharded pipeline on 4 devices; each shard's
    buffers, carried across, reduce to the JAX `fin` output of that
    shard."""
    n, B, L, M, cap = 4, 16, 1024, 96, 4096
    jp = JaxParams(k=K, l=8, density=0.05, min_kmer_abundance=2,
                   engine="device", reads_already_hpc=hpc)
    step, fin, make_buffers, shardings, _recv = make_sharded_pipeline(
        jax_make_mesh(n), jp, B, L, M, window_cap=cap, node_cap=cap - 1)
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[B // 2:] = codes[: B // 2]
    lengths = np.full(B, L, dtype=np.int32)
    lengths[3] = L // 3
    bufs = step(jax.device_put(codes, shardings[0]),
                jax.device_put(lengths, shardings[1]), *make_buffers(),
                np.int32(0), np.uint32(0))[:4]
    res = fin(*bufs)
    host = [np.asarray(b).reshape((n, cap) + np.asarray(b).shape[1:])
            for b in bufs]
    n_pass = np.asarray(res["n_pass"]).reshape(-1)
    for s in range(n):
        got = _port_nodes(tuple(h[s] for h in host), 2)
        m = int(n_pass[s])
        want = {key: np.asarray(res[key]).reshape(
            (n, -1) + np.asarray(res[key]).shape[1:])[s, :m]
            for key in ("key_lo", "key_hi", "count", "meta", "vec")}
        want["n_pass"] = m
        _assert_same_nodes(got, want)


def _random_batch(B, L, seed=0):
    """tests/test_parallel.py's batch: random rows, the second half a copy
    of the first, one row cut to half length."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[B // 2:] = codes[: B - B // 2]
    lengths = np.full((B,), L, dtype=np.int32)
    lengths[1] = L // 2
    return codes, lengths


@pytest.mark.parametrize("n", [4, 8])
def test_count_step_matches_jax(n):
    """One round of the port's sharded pipeline (extract, route by owner,
    finalize_windows at minab 1, the id bases) against the JAX count step:
    per shard the same unique keys with the same counts, the same unique
    count and id base.  The JAX step lists a shard's keys in (lo, hi)
    order, the port in first-occurrence order."""
    B, L, M = 2 * n, 1024, 160
    fn, shardings, _cap = jax_count_step(
        jax_make_mesh(n), JaxParams(k=4, l=8, density=0.05), B, L, M)
    codes, lengths = _random_batch(B, L)
    want = fn(jax.device_put(codes, shardings[0]),
              jax.device_put(lengths, shardings[1]))
    pipe = ShardedPipeline(
        ShardMesh(n, ["cpu"] * n),
        Params(k=4, l=8, density=0.05, min_kmer_abundance=1), B // n, M)
    pipe.step(pack_codes_np(codes), lengths, 0)
    res, bases = pipe.finalize()
    w_n = np.asarray(want["n_unique"]).reshape(-1)
    assert [r["n_unique"] for r in res] == [r["n_pass"] for r in res] \
        == w_n.tolist()
    assert bases[:-1] == np.asarray(want["id_base"]).reshape(-1).tolist()
    assert pipe.widths == {L}
    got = {}
    for s, r in enumerate(res):
        m = int(w_n[s])
        lo, hi = u64.to_numpy(r["key_lo"]), u64.to_numpy(r["key_hi"])
        order = np.lexsort((hi, lo))
        for key, mine in (("unique_lo", lo[order]), ("unique_hi", hi[order]),
                          ("counts", r["count"].numpy()[order])):
            np.testing.assert_array_equal(
                mine, np.asarray(want[key]).reshape(n, -1)[s, :m],
                err_msg=key)
        got.update(zip(zip(lo.tolist(), hi.tolist()), r["count"].tolist()))
    assert got == jax_counts_to_host(want, n)


@pytest.mark.parametrize("n", [3, 5])
def test_owner_rule_is_unsigned(n):
    """owner_of(key) == key % n on numpy uint64 for keys at and above 2^63,
    where int64 `%` (here the wrong rule) disagrees."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**64, 4096, dtype=np.uint64) | np.uint64(1 << 63)
    keys[:3] = [2**63, 2**64 - 1, 2**63 + n]
    t = u64.from_numpy(keys, "cpu")
    want = (keys % np.uint64(n)).astype(np.int64)
    np.testing.assert_array_equal(owner_of(t, n).numpy(), want)
    assert (t % n).numpy().tolist() != want.tolist()


def test_popcount_and_bit_select():
    """u64.popcount and the join's binary bit-select against bin() on
    random 64-bit masks, bit 63 included."""
    rng = np.random.default_rng(0)
    masks = rng.integers(1, 2**64, 500, dtype=np.uint64)
    masks[:2] = [2**64 - 1, 2**63]
    t = u64.from_numpy(masks, "cpu")
    counts = [bin(int(v)).count("1") for v in masks]
    assert u64.popcount(t).tolist() == counts
    r = torch.tensor([int(rng.integers(0, c)) for c in counts])
    got = edges._select_bit(t, r).tolist()
    for v, ri, lane in zip(masks.tolist(), r.tolist(), got):
        bits = [b for b in range(64) if (v >> b) & 1]
        assert lane == bits[ri]


def test_mesh_all_to_all_layout():
    """Shard d receives every source's rows for d, sources in shard order,
    each block in its own order; empty blocks included."""
    mesh = ShardMesh(3, ["cpu"] * 3)
    sends = []
    for s in range(3):
        counts = [s, 0, 2]
        rows = torch.arange(sum(counts))[:, None] + 100 * s
        sends.append((rows, counts))
    got = [r[:, 0].tolist() for r in mesh.all_to_all(sends)]
    assert got == [[100, 200, 201], [], [0, 1, 101, 102, 202, 203]]
    assert mesh.all_gather([4, 5, 6]) == [4, 5, 6] and mesh.psum([1, 2]) == 3


def _star_nodes(n_tail: int):
    """Canonical k = 3 vectors where one (k-1)-overlap key is shared by
    n_tail + 2 nodes: probes of that key see more than G_SLOTS candidates
    once n_tail > 16."""
    a, b = 5, 9
    vecs = [[1, a, b], [a, b, 2]] + [[a, b, 100 + i] for i in range(n_tail)]
    vecs += [[200 + i, a, b] for i in range(3)]
    arr = np.array(vecs, dtype=np.uint64)
    rev = arr[:, ::-1]
    flip = np.array([tuple(r) > tuple(q) for r, q in zip(arr, rev)])
    arr[flip] = rev[flip]
    return arr


@pytest.mark.parametrize("n_tail,n,presimp", [(6, 2, 0.01), (40, 3, 0.01),
                                               (40, 4, 0.6)])
def test_distributed_join_past_g_slots(tmp_path, n_tail, n, presimp):
    """The distributed GFA (every bitmask block of a key group over
    G_SLOTS, presimp removals) equals the bytes of the JAX package's
    gathered join, and the port's gathered join writes them too: the JAX
    distributed join overflows there and falls back to its gathered
    join."""
    vec = _star_nodes(n_tail)
    m = len(vec)
    rng = np.random.default_rng(n_tail)
    count = rng.integers(2, 30, m).astype(np.int64)
    meta = np.zeros((m, 6), dtype=np.int64)
    meta[:, 0] = rng.integers(20, 90, m)
    meta[:, 1] = rng.integers(1, 10, m)
    meta[:, 2] = rng.integers(1, 10, m)
    table = dict(index=np.arange(m, dtype=np.uint32),
                 abundance=count.astype(np.uint32),
                 seqlen=meta[:, 0].astype(np.uint32),
                 shift0=meta[:, 1].astype(np.uint16),
                 shift1=meta[:, 2].astype(np.uint16))
    path = str(tmp_path / "g.gfa")
    jax_build_gfa(path, table, vec, presimp=presimp)
    port_path = str(tmp_path / "port.gfa")
    build_gfa(port_path, table, vec, presimp=presimp)
    assert open(port_path).read() == open(path).read()
    bounds = np.linspace(0, m, n + 1).astype(int).tolist()
    shards = [dict(vec=u64.from_numpy(vec[a:b], "cpu"),
                   count=torch.from_numpy(count[a:b]),
                   meta=torch.from_numpy(meta[a:b]), base=a)
              for a, b in zip(bounds[:-1], bounds[1:])]
    parts, nb_edges, n_removed = edges.gfa_parts(
        ShardMesh(n, ["cpu"] * n), shards, bounds, presimp)
    text = "H\tVN:Z:1.0\n" + "".join(s for s, _ in parts) \
        + "".join(l_text for _, l_text in parts)
    assert text == open(path).read()
    assert nb_edges == text.count("\nL\t") > n_tail
    assert (n_removed > 0) == (presimp > 0.5)
