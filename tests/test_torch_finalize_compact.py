"""Port parity: the whole-run reduction `finalize_compact` against
`jax.jit(_finalize_compact)` on counter buffers built once by the JAX
construct and carried across with buffers_from_numpy.  Integers throughout:
every comparison is exact, over rows [0, n_pass)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_mdbg_tpu.ops.sort_count import (
    DeviceNodeCounter as JaxCounter, _finalize_compact, counter_flags,
    make_fused_construct)
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch.ops import u64
from rust_mdbg_tpu_torch.ops.extract import capacity
from rust_mdbg_tpu_torch.ops.sort_count import (
    DeviceNodeCounter, buffers_from_numpy, buffers_to_numpy,
    construct_batches, finalize_compact, window_slot_capacity)
from rust_mdbg_tpu_torch.params import Params

B, L, NB = 16, 1024, 6
KW = dict(k=5, l=9, density=0.03, batch_reads=B)


def _reads(seed=0):
    """Reads sampled from a 2.5 kb genome (about 30x), so many keys repeat
    17 times and more; homopolymers, an N run, substitutions and ragged
    lengths included."""
    rng = np.random.default_rng(seed)
    G = 2500
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[rng.random(G) < 0.15] = 0
    genome[700:704] = 4
    starts = rng.integers(0, G - L, B * NB)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    codes[rng.random(codes.shape) < 0.002] = 2
    lengths = rng.integers(L // 2, L + 1, B * NB).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


@functools.lru_cache(maxsize=None)
def _jax_buffers(hpc: bool, bf: bool):
    """(numpy buffers of the JAX counter after its construct, M, W_slot)."""
    p = JaxParams(engine="device", min_kmer_abundance=2,
                  reads_already_hpc=hpc, use_bf=bf, bloom_log2_bits=16, **KW)
    M = capacity(Params(**KW), L)
    ws = window_slot_capacity(Params(**KW), B, L, M)
    jc = JaxCounter(k=p.k, M=M, read_cap=B * NB, node_cap=1 << 14, minab=2,
                    w_slot=ws, **counter_flags(p))
    codes, lengths = _reads()
    fn = make_fused_construct(p, B, L, M, NB, w_slot=ws)
    bufs, n_win, n_over = fn(jnp.asarray(codes), jnp.asarray(lengths),
                             jc.buffers)
    assert int(n_over) == 0 and int(n_win) > 0
    return tuple(np.asarray(b) for b in bufs), M, ws


def _both(hpc, bf, minab, emit_mpos=False, prefix_rows=None):
    """(JAX result cut to n_pass rows, port result as numpy)."""
    bufs, M, _ = _jax_buffers(hpc, bf)
    n_fin = 5 if hpc else 6
    oj = jax.jit(functools.partial(
        _finalize_compact, k=KW["k"], M=M, minab=minab, node_cap=1 << 14,
        pass_cap=1 << 14, emit_mpos=emit_mpos, prefix_rows=prefix_rows,
        bf=bf))(*(jnp.asarray(b) for b in bufs[:n_fin]))
    n_pass, n_unique, over = (int(x) for x in np.asarray(oj["stats3"]))
    assert over == 0
    want = {name: np.asarray(oj[name])[:n_pass]
            for name in ("key_lo", "key_hi", "count", "vec", "meta", "mpos")
            if name in oj}
    want.update(n_pass=n_pass, n_unique=n_unique)
    ot = finalize_compact(*buffers_from_numpy(bufs, "cpu")[:n_fin],
                          k=KW["k"], M=M, minab=minab, emit_mpos=emit_mpos,
                          prefix_rows=prefix_rows, bf=bf)
    assert int(ot["n_clipped"]) == 0
    got = dict(n_pass=ot["n_pass"], n_unique=ot["n_unique"])
    for name in ("key_lo", "key_hi", "vec"):
        got[name] = u64.to_numpy(ot[name])
    for name in ("count", "meta", "mpos"):
        if name in ot:
            got[name] = ot[name].numpy().astype(np.uint32)
    return want, got


def _assert_same(want, got):
    assert set(want) == set(got)
    for name, w in want.items():
        if isinstance(w, int):
            assert got[name] == w, name
        else:
            assert got[name].shape == w.shape, name
            assert np.array_equal(got[name].astype(w.dtype), w), name


@pytest.mark.parametrize("minab", [1, 2, 3, 17])
@pytest.mark.parametrize("hpc", [False, True])
def test_finalize_compact_matches_jax(minab, hpc):
    """Raw reads (six planes, extpack meta column) and pre-HPC'd reads
    (five planes, record positions asked for)."""
    want, got = _both(hpc, False, minab, emit_mpos=hpc)
    assert want["meta"].shape[1] == (5 if hpc else 6)
    assert ("mpos" in want) == hpc
    assert want["n_pass"] > (5 if minab == 17 else 50)
    assert want["n_unique"] >= want["n_pass"]
    _assert_same(want, got)


@pytest.mark.parametrize("minab", [2, 3, 17])
@pytest.mark.parametrize("hpc", [False, True])
def test_finalize_compact_bf_matches_jax(minab, hpc):
    """Buffers screened by the JAX device Bloom: the crossing row shifts
    one earlier and the count adds the dropped first sighting back."""
    want, got = _both(hpc, True, minab, emit_mpos=hpc)
    assert want["n_pass"] > 5
    _assert_same(want, got)
    # every unscreened node is there; a Bloom false positive can only add
    # a node or a sighting
    plain, _ = _both(hpc, False, minab, emit_mpos=hpc)
    screened = dict(zip(zip(got["key_lo"], got["key_hi"]), got["count"]))
    for lo, hi, c in zip(plain["key_lo"], plain["key_hi"], plain["count"]):
        assert c <= screened[(lo, hi)] <= c + 1


@pytest.mark.parametrize("bf", [False, True])
def test_finalize_compact_prefix_rows_matches_jax(bf):
    _, _, ws = _jax_buffers(True, bf)
    want, got = _both(True, bf, 2, emit_mpos=True, prefix_rows=2 * B * ws)
    assert want["n_pass"] > 20
    _assert_same(want, got)


@pytest.mark.parametrize("minab", [1, 2, 3])
def test_prefix_result_is_exact_prefix_of_full_result(minab):
    """What phased emission rests on: a reduction over a longer prefix of
    the buffers reproduces an earlier one's rows as an exact prefix of its
    own; only the counts grow."""
    bufs, M, ws = _jax_buffers(True, False)
    tb = buffers_from_numpy(bufs, "cpu")
    kw = dict(k=KW["k"], M=M, minab=minab, emit_mpos=True)
    prev = None
    for nb in (1, 3, NB):
        cur = finalize_compact(*tb, prefix_rows=nb * B * ws, **kw)
        if prev is not None:
            n = prev["n_pass"]
            assert 0 < n < cur["n_pass"]
            for name in ("key_lo", "key_hi", "vec", "meta", "mpos"):
                assert torch.equal(cur[name][:n], prev[name]), name
            assert (cur["count"][:n] >= prev["count"]).all()
            assert (cur["count"][:n] > prev["count"]).any()
        prev = cur
    full = finalize_compact(*tb, **kw)
    for name in ("key_lo", "key_hi", "count", "vec", "meta", "mpos"):
        assert torch.equal(full[name], prev[name]), name


def _port_counter(hpc, w_slot=None, bf=False, minab=2):
    p = Params(min_kmer_abundance=minab, reads_already_hpc=hpc, use_bf=bf,
               bloom_log2_bits=16, **KW)
    M = capacity(p, L)
    ws = w_slot or window_slot_capacity(p, B, L, M)
    c = DeviceNodeCounter(k=p.k, M=M, read_cap=B * NB, w_slot=ws,
                          chunk_slots=1, device="cpu", minab=minab,
                          with_ext=not hpc, emit_overlap_keys=hpc,
                          use_bf=bf, bloom_log2_bits=16)
    codes, lengths = _reads()
    n_win, n_over = construct_batches(
        p, torch.from_numpy(codes), torch.from_numpy(lengths), c.buffers,
        B=B, M=M, w_slot=ws, batch_lo=0, batch_hi=NB)
    return c, int(n_win), int(n_over)


@pytest.mark.parametrize("bf", [False, True])
@pytest.mark.parametrize("hpc", [False, True])
def test_port_construct_fills_the_same_buffers(hpc, bf):
    """The port's own construct (with its Bloom screen under bf) leaves
    the planes the JAX construct leaves, the Bloom words included."""
    c, n_win, n_over = _port_counter(hpc, bf=bf)
    assert n_over == 0 and n_win > 0
    want, _, _ = _jax_buffers(hpc, bf)
    got = buffers_to_numpy(c.buffers)
    assert len(got) == len(want) == 5 + (not hpc) + bf
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if bf:
        assert got[-1].dtype == np.uint32 and got[-1].any()


@pytest.mark.parametrize("hpc", [False, True])
def test_grow_keeps_results_unchanged(hpc):
    c, _, _ = _port_counter(hpc, bf=hpc)
    pending = c.finalize_dispatch()     # bound to the planes before grow
    before = c.finalize()
    old = c.buffers
    c.grow(B * NB + 1)
    assert c.read_cap == 2 * B * NB and c.window_cap == 2 * B * NB * c.W_slot
    assert c.buffers[0].shape[0] == c.window_cap
    assert all(a is not b for a, b in zip(old[: c._n_fin], c.buffers))
    if hpc:
        assert c.buffers[-1] is old[-1]     # the Bloom words pass through
    c.grow(B * NB)                          # already large enough: no-op
    assert c.read_cap == 2 * B * NB
    after = c.finalize()
    held = c.finalize_resolve(pending)
    assert set(before) == set(after) == set(held)
    assert ("gk" in before) == hpc and len(before["index"]) > 50
    for name in before:
        assert np.array_equal(before[name], after[name]), name
        assert np.array_equal(before[name], held[name]), name


def test_batch_slot_compaction_matches_padded():
    """w_slot < W gives the same reduction as the full padded layout, and a
    slot too small for a batch's windows is counted as overflow."""
    M = capacity(Params(**KW), L)
    W = M - KW["k"] + 1
    full_c, full_win, full_over = _port_counter(False, w_slot=W)
    slot_c, slot_win, slot_over = _port_counter(False)
    assert slot_c.W_slot < W
    assert full_over == 0 and slot_over == 0
    assert full_win == slot_win > 0
    full, slot = full_c.finalize(), slot_c.finalize()
    for name in ("key_lo", "key_hi", "count", "vec", "meta"):
        assert np.array_equal(full[name], slot[name]), name
    _, _, n_over = _port_counter(False, w_slot=8)
    assert n_over > 0


def test_occ_past_32_bits_raises():
    p = Params(min_kmer_abundance=2, **KW)
    M = capacity(p, L)
    c = DeviceNodeCounter(k=p.k, M=M, read_cap=B, w_slot=8, chunk_slots=1,
                          device="cpu")
    codes, lengths = _reads()
    with pytest.raises(ValueError, match="32 bits"):
        construct_batches(p, torch.from_numpy(codes[:B]),
                          torch.from_numpy(lengths[:B]), c.buffers, B=B, M=M,
                          w_slot=8, batch_lo=0, batch_hi=1,
                          read_base=(1 << 32) // (M - p.k + 1))


def test_bf_needs_minab_above_one():
    bufs, M, _ = _jax_buffers(True, False)
    with pytest.raises(ValueError, match="minab > 1"):
        finalize_compact(*buffers_from_numpy(bufs, "cpu"), k=KW["k"], M=M,
                         minab=1, bf=True)
