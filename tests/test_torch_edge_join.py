"""Port parity: the device edge join, the overlap keys, the key catalog and
the POT-list GFA finish against the JAX package's, on the node sets of
tests/test_edge_join.py (chains, repeats with multi-candidate groups,
presimp drops, palindromic overlaps, garbage padding rows and a key group
larger than G_SLOTS).  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_mdbg_tpu.core.graph import _overlap_keys
from rust_mdbg_tpu.ops.edge_join import (
    DeviceKeyCatalog as JaxCatalog, G_SLOTS as JAX_G_SLOTS, edge_join_device)
from rust_mdbg_tpu.ops.sort_count import _overlap_keys_device
from rust_mdbg_tpu_torch.core.graph import IncrementalGFA
from rust_mdbg_tpu_torch.ops import edge_join as tj
from rust_mdbg_tpu_torch.ops import u64
from rust_mdbg_tpu_torch.ops.sort_count import overlap_keys_device


def _canon_rows(varr):
    """Host KmerVec::normalize over rows."""
    out = np.empty_like(varr)
    for t, v in enumerate(varr):
        r = v[::-1]
        out[t] = r if tuple(v) >= tuple(r) else v
    return out


def _windows(walk, k):
    n = len(walk) - k + 1
    return _canon_rows(np.stack([walk[t : t + k] for t in range(n)]))


def _chain(seed, n, k, repeat_every=0):
    """Chain walk with optional repeated segments (shared overlap keys)."""
    rng = np.random.default_rng(seed)
    walk = rng.integers(1, 1 << 62, n + k - 1, dtype=np.uint64)
    if repeat_every:
        for t in range(repeat_every, n, repeat_every):
            src = rng.integers(0, max(1, t - 1))
            walk[t : t + k] = walk[src : src + k]
    # top-bit values: the join's key order is unsigned
    walk[::5] |= np.uint64(1 << 63)
    return _windows(walk, k)


def _palindromic(seed, k=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 1 << 62, 4, dtype=np.uint64)
    pal = np.concatenate([base[:2], base[:2][::-1]])  # suffix == its reverse
    walk = np.concatenate([rng.integers(1, 1 << 62, 3, dtype=np.uint64),
                           pal, rng.integers(1, 1 << 62, 8, dtype=np.uint64)])
    return _windows(walk, k)


def _overflowing(seed, k=5):
    """One window repeated far beyond G_SLOTS: its key group overflows."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(1, 1 << 62, k, dtype=np.uint64)
    walk = np.concatenate([np.tile(seg, tj.G_SLOTS + 4),
                           rng.integers(1, 1 << 62, 8, dtype=np.uint64)])
    return _windows(walk, k)


#: name -> (canonical vectors [n, k], rows of garbage padding for the JAX
#: join's n_pass mask)
NODE_SETS = {
    "chain": (_chain(1, 500, 7), 0),
    "repeats": (_chain(2, 400, 5, repeat_every=13), 112),
    "dense_repeats": (_chain(3, 300, 5, repeat_every=7), 0),
    "palindromic": (_palindromic(4), 0),
}


def _jax_keys(varr, pad=0):
    v = varr
    if pad:  # garbage rows that the JAX join must mask out by n_pass
        v = np.concatenate([varr, np.arange(
            1, pad * varr.shape[1] + 1, dtype=np.uint64).reshape(pad, -1)])
    return jax.jit(_overlap_keys_device)(jnp.asarray(v))


def _jax_pot(gk, gflag, n):
    cap = 64
    while True:
        out = edge_join_device(gk, gflag, jnp.int32(n), edge_cap=cap)
        n_pot, g_over = (int(x) for x in np.asarray(out["stats2"]))
        if n_pot <= cap or g_over:
            break
        cap *= 2
    return tuple(np.asarray(out[name])[:n_pot]
                 for name in ("pot_i", "pot_j", "pot_c")), g_over


def _torch_keys(varr):
    return overlap_keys_device(u64.from_numpy(varr, "cpu"))


def _torch_pot(gk, gflag):
    pot_i, pot_j, pot_c, g_over = tj.edge_join(gk, gflag)
    if g_over:
        return None, g_over
    return (pot_i.numpy(), pot_j.numpy(), pot_c.numpy()), 0


def test_g_slots_equal():
    assert tj.G_SLOTS == JAX_G_SLOTS == 16


@pytest.mark.parametrize("name", list(NODE_SETS) + ["overflowing"])
def test_overlap_keys_match_jax_and_numpy(name):
    varr = NODE_SETS[name][0] if name in NODE_SETS else _overflowing(5)
    gk_j, gf_j = _jax_keys(varr)
    gk_t, gf_t = _torch_keys(varr)
    assert np.array_equal(np.asarray(gk_j), u64.to_numpy(gk_t))
    assert np.array_equal(np.asarray(gf_j), gf_t.numpy())
    Fs, Fp, FsR, FpR, key_suf, key_pre = _overlap_keys(varr)
    gk = u64.to_numpy(gk_t)
    gf = gf_t.numpy()
    assert np.array_equal(gk, np.concatenate([Fs, Fp, FsR, FpR], axis=1))
    assert np.array_equal(np.where((gf & 1).astype(bool)[:, None], Fs, FsR),
                          key_suf)
    assert np.array_equal(np.where((gf & 2).astype(bool)[:, None], Fp, FpR),
                          key_pre)


@pytest.mark.parametrize("name", list(NODE_SETS))
def test_pot_list_matches_jax(name):
    varr, pad = NODE_SETS[name]
    n = len(varr)
    gk_j, gf_j = _jax_keys(varr, pad)
    want, g_over_j = _jax_pot(gk_j, gf_j, n)
    gk_t, gf_t = _torch_keys(varr)
    got, g_over_t = _torch_pot(gk_t, gf_t)
    assert g_over_j == g_over_t == 0
    assert len(got[0]) == len(want[0]) >= n - 1
    for a, b in zip(got, want):
        assert np.array_equal(a, b.astype(a.dtype))
    if "repeats" in name:   # some probe has several candidates
        probes = set(zip(got[0].tolist(), (got[2] >> 2).tolist()))
        assert len(got[0]) > len(probes)


def test_pot_list_same_in_small_probe_blocks(monkeypatch):
    """Walking the probes in blocks keeps probe order."""
    gk, gf = _torch_keys(NODE_SETS["repeats"][0])
    want, _ = _torch_pot(gk, gf)
    monkeypatch.setattr(tj, "_PROBE_BLOCK", 37)
    got, _ = _torch_pot(gk, gf)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_g_overflow_verdict_matches_jax():
    varr = _overflowing(5)
    gk_j, gf_j = _jax_keys(varr)
    _, g_over_j = _jax_pot(gk_j, gf_j, len(varr))
    got, g_over_t = _torch_pot(*_torch_keys(varr))
    assert g_over_j > 0 and g_over_t == g_over_j
    assert got is None
    assert tj.PotJoin(*_torch_keys(varr)).resolve() is None


def test_empty_join():
    gk = torch.zeros((0, 8), dtype=torch.int64)
    pot = tj.PotJoin(gk, torch.zeros(0, dtype=torch.uint8)).resolve()
    assert [len(a) for a in pot] == [0, 0, 0]


def _pow2(n):
    cap = 8
    while cap < n:
        cap <<= 1
    return cap


@pytest.mark.parametrize("name", ["repeats", "dense_repeats"])
def test_catalog_append_spill_join_match_jax(name):
    """Three chunks appended in a shuffled node order and joined through
    the id-order permutation, in both packages; then a spill in both, and
    the JAX catalog's contents loaded into the port's."""
    varr, _ = NODE_SETS[name]
    n = len(varr)
    rng = np.random.default_rng(8)
    append_row = rng.permutation(n)          # append row r holds node ...
    order = np.argsort(append_row, kind="stable")   # ... found again here
    gk_all, gf_all = _torch_keys(varr[append_row])
    bounds = [0, n // 3, n // 2, n]

    jc = JaxCatalog(1024)
    tc = tj.DeviceKeyCatalog(1024)
    for a, b in zip(bounds, bounds[1:]):
        blk = b - a
        p = _pow2(blk)
        gk_np = np.zeros((p, 8), dtype=np.uint64)
        gf_np = np.zeros(p, dtype=np.uint8)
        gk_np[:blk] = u64.to_numpy(gk_all[a:b])
        gf_np[:blk] = gf_all[a:b].numpy()
        assert jc.fits(p) and tc.fits(blk)
        jc.append(jnp.asarray(gk_np), jnp.asarray(gf_np), blk)
        tc.append(gk_all[a:b], gf_all[a:b])
    assert jc.n == tc.n == n
    assert not tc.fits(1024 - n + 1) and tc.fits(1024 - n)

    pot_j, gk_pj, gf_pj = jc.join(order.astype(np.int32))
    want = pot_j.resolve()
    pot_t, gk_pt, gf_pt = tc.join(order)
    got = pot_t.resolve()
    assert pot_t.n_pot == len(want[0]) > 0
    for a, b in zip(got, want):
        assert np.array_equal(a, b.astype(a.dtype))
    assert np.array_equal(np.asarray(gk_pj)[:n], u64.to_numpy(gk_pt))
    assert np.array_equal(np.asarray(gf_pj)[:n], gf_pt.numpy())
    # permuted back into id order, the catalog holds the nodes' own keys
    gk_id, gf_id = _torch_keys(varr)
    assert torch.equal(gk_pt, gk_id) and torch.equal(gf_pt, gf_id)

    # spill: append order, exactly n rows, in both packages
    jc2 = JaxCatalog(1024)
    p = _pow2(n)
    gk_np = np.zeros((p, 8), dtype=np.uint64)
    gf_np = np.zeros(p, dtype=np.uint8)
    gk_np[:n] = u64.to_numpy(gk_all)
    gf_np[:n] = gf_all.numpy()
    jc2.append(jnp.asarray(gk_np), jnp.asarray(gf_np), n)
    gk_sj, gf_sj = jc2.spill()
    tc2 = tj.catalog_from_numpy(gk_sj, gf_sj, 1024, "cpu")
    assert tc2.n == n
    gk_st, gf_st = tc2.spill()
    assert tc2.n == 0 and gk_st.shape == (n, 8)
    assert gk_st.dtype == np.uint64 and gf_st.dtype == np.uint8
    assert np.array_equal(gk_sj, gk_st) and np.array_equal(gf_sj, gf_st)
    # and the loaded catalog joins to the same list
    got2 = tj.catalog_from_numpy(gk_sj, gf_sj, 1024, "cpu").join(order)[0] \
        .resolve()
    for a, b in zip(got2, want):
        assert np.array_equal(a, b.astype(a.dtype))


@pytest.mark.parametrize("name,presimp", [
    ("chain", 0.01), ("repeats", 0.01), ("dense_repeats", 0.2),
    ("palindromic", 0.01), ("dense_repeats", 0.0)])
def test_finish_pot_gfa_equals_host_finish(tmp_path, name, presimp):
    """The native writer fed the device join's POT list writes the bytes
    the host km_index join writes."""
    varr, _ = NODE_SETS[name]
    n = len(varr)
    rng = np.random.default_rng(6)
    ab = rng.integers(1, 2000 if presimp > 0.1 else 60, n).astype(np.uint32)
    seqlen = rng.integers(varr.shape[1] + 2, 4000, n).astype(np.uint32)
    s0 = rng.integers(0, 300, n).astype(np.uint16)
    s1 = rng.integers(0, 300, n).astype(np.uint16)
    idx = np.arange(n, dtype=np.uint32)

    host = IncrementalGFA(cap_hint=n)
    host.add_chunk(idx, ab, seqlen, s0, s1, _overlap_keys(varr))
    sh = host.finish(str(tmp_path / "h.gfa"), presimp)

    pot = tj.PotJoin(*_torch_keys(varr)).resolve()
    dev = IncrementalGFA(cap_hint=n)
    dev.add_chunk(idx, ab, seqlen, s0, s1, None)
    sd = dev.finish_pot(str(tmp_path / "d.gfa"), presimp, *pot)

    assert sh == sd and sd["nb_nodes"] == n and sd["nb_edges"] > 0
    if presimp > 0.1:
        assert sd["presimp_removed"] > 0
    assert (tmp_path / "h.gfa").read_bytes() == (tmp_path / "d.gfa") \
        .read_bytes()


def test_finish_pot_rejects_unknown_node(tmp_path):
    g = IncrementalGFA()
    one = np.ones(2, dtype=np.uint32)
    g.add_chunk(np.arange(2), one, one * 50, one, one, None)
    with pytest.raises(ValueError, match="never fed"):
        g.finish_pot(str(tmp_path / "x.gfa"), 0.0, [0], [2], [0])
    g.abort()
    g.abort()   # idempotent
