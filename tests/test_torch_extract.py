"""Port parity: feed unpacking, HPC and the count-path extraction.

Each port function runs on the CPU (plain torch) against the JAX package's
function on the same numpy inputs; every comparison is exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_mdbg_tpu.ops.extract import _device_extract
from rust_mdbg_tpu.ops.hpc import hpc_jax
from rust_mdbg_tpu.ops.kminmer import (canonicalize_jax, fingerprint128_jax,
                                       le_rev_jax)
from rust_mdbg_tpu.ops.pack import unpack_codes_jax
from rust_mdbg_tpu_torch.ops import u64
from rust_mdbg_tpu_torch.ops.extract import capacity, extract_count
from rust_mdbg_tpu_torch.ops.hpc import hpc
from rust_mdbg_tpu_torch.ops.kernels import window_keys_poly_plain
from rust_mdbg_tpu_torch.ops.kminmer import (canonicalize, fingerprint128,
                                             le_rev)
from rust_mdbg_tpu_torch.ops.pack import pack_codes_np, unpack_codes
from rust_mdbg_tpu_torch.params import Params

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)


def _reads(seed, B, L, hp=0.3):
    """Raw reads with homopolymer runs (each base repeats the previous one
    with probability hp), N runs, 'other' bases and ragged lengths; code 5
    pads each row past its length, as the FASTX batcher does."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    rep = rng.random((B, L)) < hp
    for j in range(1, L):
        codes[:, j] = np.where(rep[:, j], codes[:, j - 1], codes[:, j])
    codes[rng.random((B, L)) < 0.01] = 4
    codes[:, 5:8] = 4                                   # an NN run per read
    codes[rng.random((B, L)) < 0.003] = 5
    lengths = rng.integers(L // 3, L + 1, B).astype(np.int32)
    lengths[:3] = [0, 5, L]
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


def test_unpack_round_trip():
    codes, _ = _reads(0, 16, 1024)
    pk, mk = pack_codes_np(codes)
    got = unpack_codes(torch.from_numpy(pk), torch.from_numpy(mk)).numpy()
    assert np.array_equal(got, codes)
    assert np.array_equal(got, np.asarray(unpack_codes_jax(pk, mk)))
    assert (got == 4).any() and (got == 5).any()


@pytest.mark.parametrize("L", [512, 2048])
def test_hpc_matches_jax(L):
    codes, lengths = _reads(L, 16, L)
    hj = jax.jit(hpc_jax)(jnp.asarray(codes), jnp.asarray(lengths))
    ht = hpc(torch.from_numpy(codes), torch.from_numpy(lengths))
    for a, b in zip(hj, ht):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(ht[2].max()) < L  # runs were compressed


# (L, density, max_minimizers_per_read): the flat compaction branch
# (L <= 2048), the two-level one (L % 512 == 0 and L > 2048), chunk
# overflow in the two-level branch (d = 0.5 selects ~75% of positions,
# above the 256-slot chunk cap), per-read M overflow in the flat one, and
# d = 0.9, whose minimizer hashes often have the top bit set (unsigned
# order in the canonical-orientation test)
CASES = [(1024, 0.02, 0), (3072, 0.02, 0), (3072, 0.5, 0), (1024, 0.05, 40),
         (1024, 0.9, 200)]


@pytest.mark.parametrize("L,density,mmax", CASES)
def test_count_path_matches_jax(L, density, mmax):
    p = Params(k=7, l=10, density=density, max_minimizers_per_read=mmax)
    M = capacity(p, L)
    codes, lengths = _reads(L + int(density * 100), 16, L)
    fn = jax.jit(functools.partial(
        _device_extract, l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
        already_hpc=False, count_output=True))
    oj = fn(jnp.asarray(codes), jnp.asarray(lengths))
    ot = extract_count(torch.from_numpy(codes), torch.from_numpy(lengths),
                       l=p.l, k=p.k, hash_bound=p.hash_bound, M=M)
    assert np.array_equal(np.asarray(oj["keys"]), u64.to_numpy(ot["keys"]))
    assert np.array_equal(np.asarray(oj["mh"]), u64.to_numpy(ot["mh"]))
    for name in ("mp", "mpe", "nw", "overflow"):
        assert np.array_equal(np.asarray(oj[name]), ot[name].numpy()), name
    assert int(ot["nw"].sum()) > 0
    if density >= 0.5 or mmax:
        assert ot["overflow"].any()
    else:
        assert not ot["overflow"][3:].any()


def _hpc_reads(seed, B, L):
    """Reads with no two equal neighbours (already homopolymer-compressed),
    N and 'other' bases and ragged lengths."""
    rng = np.random.default_rng(seed)
    step = rng.integers(1, 4, (B, L)).astype(np.uint8)
    step[:, 0] = rng.integers(0, 4, B)
    codes = (np.cumsum(step, axis=1) % 4).astype(np.uint8)
    codes[rng.random((B, L)) < 0.004] = 4
    codes[rng.random((B, L)) < 0.002] = 5
    lengths = rng.integers(L // 3, L + 1, B).astype(np.int32)
    lengths[:3] = [0, 5, L]
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


@pytest.mark.parametrize("L,density,mmax", [CASES[0], CASES[1], CASES[3],
                                            CASES[4]])
def test_count_path_already_hpc_matches_jax(L, density, mmax):
    """Pre-HPC'd input: the codes are hashed as they are, positions are
    columns and neither side makes an extent plane."""
    p = Params(k=7, l=10, density=density, max_minimizers_per_read=mmax,
               reads_already_hpc=True)
    M = capacity(p, L)
    codes, lengths = _hpc_reads(L + int(density * 100), 16, L)
    fn = jax.jit(functools.partial(
        _device_extract, l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
        already_hpc=True, count_output=True))
    oj = fn(jnp.asarray(codes), jnp.asarray(lengths))
    ot = extract_count(torch.from_numpy(codes), torch.from_numpy(lengths),
                       l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
                       already_hpc=True)
    assert sorted(oj) == sorted(ot) and "mpe" not in ot
    assert np.array_equal(np.asarray(oj["keys"]), u64.to_numpy(ot["keys"]))
    assert np.array_equal(np.asarray(oj["mh"]), u64.to_numpy(ot["mh"]))
    for name in ("mp", "nw", "overflow"):
        assert np.array_equal(np.asarray(oj[name]), ot[name].numpy()), name
        assert oj[name].dtype == ot[name].numpy().dtype, name
    assert int(ot["nw"].sum()) > 0
    assert bool(ot["overflow"].any()) == bool(mmax)


def test_kminmer_ops_match_jax():
    """canonicalize / le_rev / fingerprint128 against the JAX functions on
    vectors with top-bit values, palindromes and near-palindromes; and the
    O(1) window keys equal fingerprint128(canonicalize(window))."""
    rng = np.random.default_rng(9)
    k, M = 6, 40
    v = rng.integers(0, 1 << 64, (64, k), dtype=np.uint64)
    v[8:16] = np.concatenate([v[8:16, :3], v[8:16, :3][:, ::-1]], axis=1)
    v[16:24, 0] = v[16:24, -1] ^ np.uint64(1 << 63)
    t = u64.from_numpy(v, "cpu")
    cj, rj = canonicalize_jax(jnp.asarray(v))
    ct, rt = canonicalize(t)
    assert np.array_equal(np.asarray(cj), u64.to_numpy(ct))
    assert np.array_equal(np.asarray(rj), rt.numpy())
    assert np.array_equal(np.asarray(le_rev_jax(jnp.asarray(v))),
                          le_rev(t).numpy())
    assert np.array_equal(np.asarray(fingerprint128_jax(jnp.asarray(v))),
                          u64.to_numpy(fingerprint128(t)))
    assert rt[8:16].all()                           # palindromes: reversed

    mh = u64.from_numpy(rng.integers(0, 1 << 64, (4, M), dtype=np.uint64),
                        "cpu")
    keys = window_keys_poly_plain(mh, k, M)
    wins = mh.unfold(1, k, 1)                       # [4, M-k+1, k]
    assert torch.equal(keys, fingerprint128(canonicalize(wins)[0]))


@pytest.mark.parametrize("kw", [
    dict(density=0.003), dict(density=0.05, use_syncmers=True, s=4),
    dict(density=0.0005, use_syncmers=True, s=4),
    dict(density=0.7), dict(density=0.003, max_minimizers_per_read=48)])
@pytest.mark.parametrize("L", [64, 1024, 24_576, 1_049_088])
def test_capacity_matches_jax(kw, L):
    """M by the density rate and by the syncmer rate, with and without the
    per-read override (the tiler ignores it)."""
    from rust_mdbg_tpu.ops.extract import DeviceExtractor
    from rust_mdbg_tpu.params import Params as JaxParams

    dj = DeviceExtractor(JaxParams(k=21, l=14, **kw))
    p = Params(k=21, l=14, **kw)
    assert capacity(p, L) == dj.capacity(L)
    assert capacity(p, L, ignore_override=True) == \
        dj.capacity(L, ignore_override=True)


@pytest.mark.parametrize("L,density,mmax", [CASES[0], CASES[1]])
def test_count_path_ref_cuts_matches_jax(L, density, mmax):
    """Reference cuts on raw reads: HPC runs, positions are raw, and no
    extent plane is made (a record ends at pos + l)."""
    p = Params(k=7, l=10, density=density, seq_ref_cuts=True)
    M = capacity(p, L)
    codes, lengths = _reads(L + 7, 16, L)
    oj = jax.jit(functools.partial(
        _device_extract, l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
        already_hpc=False, count_output=True, ref_cuts=True))(
        jnp.asarray(codes), jnp.asarray(lengths))
    ot = extract_count(torch.from_numpy(codes), torch.from_numpy(lengths),
                       l=p.l, k=p.k, hash_bound=p.hash_bound, M=M,
                       ref_cuts=True)
    assert sorted(oj) == sorted(ot) and "mpe" not in ot
    assert np.array_equal(np.asarray(oj["keys"]), u64.to_numpy(ot["keys"]))
    for name in ("mp", "nw", "overflow"):
        assert np.array_equal(np.asarray(oj[name]), ot[name].numpy()), name
    # positions are raw: past the column wherever a run was compressed
    first = extract_count(torch.from_numpy(codes), torch.from_numpy(lengths),
                          l=p.l, k=p.k, hash_bound=p.hash_bound, M=M)
    assert torch.equal(first["mp"], ot["mp"]) and int(ot["nw"].sum()) > 0


@pytest.mark.parametrize("already_hpc", [False, True])
@pytest.mark.parametrize("s", [4, 0])
def test_count_path_syncmers_matches_jax(already_hpc, s):
    """The count path under --syncmers, raw (with the extent plane) and
    pre-HPC'd (vector mode without it: the column is the position)."""
    L, l, k, M = 1024, 10, 5, 160
    codes, lengths = (_hpc_reads if already_hpc else _reads)(s + 40, 16, L)
    common = dict(l=l, k=k, hash_bound=0, M=M, already_hpc=already_hpc,
                  syncmer=(s, int((0.02 if s == 0 else 0.2) * 4 ** l)))
    oj = jax.jit(functools.partial(_device_extract, count_output=True,
                                   **common))(
        jnp.asarray(codes), jnp.asarray(lengths))
    ot = extract_count(torch.from_numpy(codes), torch.from_numpy(lengths),
                       **common)
    assert sorted(oj) == sorted(ot) and ("mpe" in ot) != already_hpc
    for name in oj:
        got = (u64.to_numpy(ot[name]) if name in ("keys", "mh")
               else ot[name].numpy())
        assert np.array_equal(np.asarray(oj[name]), got), name
    assert int(ot["nw"].sum()) > 0 and not ot["overflow"].any()
