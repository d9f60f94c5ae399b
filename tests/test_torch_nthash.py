"""Port parity: ntHash + density selection and the u64 helpers.

The plain torch `nthash_select` (what the CUDA kernel is held against on
the card) must equal the numpy oracle and the JAX package's Pallas kernel
run in interpret mode, bit for bit.  Inputs come from numpy with fixed
seeds; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rust_mdbg_tpu.ops.pallas_kernels import nthash_select_pallas
from rust_mdbg_tpu_torch.ops import u64
from rust_mdbg_tpu_torch.ops.kernels import (nthash_select,
                                             nthash_select_plain)
from rust_mdbg_tpu_torch.ops.nthash import (H_BY_CODE, ntc64,
                                            nthash_windows_np)
from rust_mdbg_tpu_torch.utils.seq import encode_bases

MASK64 = (1 << 64) - 1


def _batch(seed, B, L, l):
    """Codes with N (4) and other (5) sprinkled in, ragged lengths with the
    edge cases 0, l-1, l and L, and pad code 5 past each length."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    codes[rng.random((B, L)) < 0.01] = 5
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:4] = [0, l - 1, l, L]
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


def _bound(density):
    return min(int(float(density) * 18446744073709551616.0), MASK64)


@pytest.mark.parametrize("density", [0.01, 0.5])
def test_plain_matches_numpy_oracle(density):
    l = 11
    codes, lengths = _batch(0, 8, 300, l)
    hb = _bound(density)
    canon, sel = nthash_select(torch.from_numpy(codes), l, hb,
                               torch.from_numpy(lengths))
    canon = u64.to_numpy(canon)
    sel = sel.numpy()
    for b in range(codes.shape[0]):
        n = int(lengths[b])
        fh, rh = nthash_windows_np(codes[b, :n], l)
        want = np.minimum(fh, rh)
        m = len(want)
        assert np.array_equal(canon[b, :m], want)
        assert np.array_equal(sel[b, :m], want <= np.uint64(hb))
        assert not sel[b, m:].any()


@pytest.mark.parametrize("shape", [(8, 1024), (16, 2048)])
def test_plain_matches_pallas_interpret(shape):
    B, L = shape
    l = 14
    codes, lengths = _batch(B, B, L, l)
    hb = _bound(0.02)
    cj, sj = nthash_select_pallas(jnp.asarray(codes), l, hb,
                                  jnp.asarray(lengths), interpret=True)
    ct, st = nthash_select_plain(torch.from_numpy(codes), l, hb,
                                 torch.from_numpy(lengths))
    assert np.array_equal(np.asarray(sj), st.numpy())
    # canon agrees wherever the window lies inside the row (past the row
    # end the Pallas kernel reads its clamped neighbour block)
    inside = np.arange(L) + l <= L
    assert np.array_equal(np.asarray(cj)[:, inside],
                          u64.to_numpy(ct)[:, inside])
    assert st.numpy().any()


def test_external_oracle_vector():
    """Published vector of the `nthash` crate: ntf64(b"TGCAG", 0, 5)."""
    f, r = nthash_windows_np(encode_bases("TGCAG"), 5)
    assert int(f[0]) == 0x0BAFA6728FC6DABF
    assert int(r[0]) == 0x8CF2D4072CCA480E
    assert ntc64("TGCAG") == 0x0BAFA6728FC6DABF
    canon, sel = nthash_select(
        torch.from_numpy(encode_bases("TGCAG"))[None, :], 5, MASK64,
        torch.tensor([5], dtype=torch.int32))
    assert int(u64.to_numpy(canon)[0, 0]) == 0x0BAFA6728FC6DABF
    assert sel.tolist() == [[True, False, False, False, False]]


def test_u64_sort_puts_high_values_and_sentinel_last():
    vals = np.array([MASK64, 1 << 63, 5, (1 << 63) - 1, 0, MASK64 - 1,
                     (1 << 63) + 7], dtype=np.uint64)
    t = u64.from_numpy(vals, "cpu")
    perm = u64.lexsort([t], [True])
    assert np.array_equal(u64.to_numpy(t[perm]), np.sort(vals))
    assert int(u64.to_numpy(t[perm])[-1]) == MASK64
    assert u64.SENTINEL == u64.s64(MASK64)


def test_u64_lexsort_is_lexicographic_and_stable():
    rng = np.random.default_rng(1)
    hi = rng.choice(np.array([0, 1 << 63, MASK64, 3], dtype=np.uint64), 200)
    lo = rng.choice(np.array([MASK64, 2, (1 << 63) + 1], dtype=np.uint64),
                    200)
    occ = rng.integers(0, 5, 200)
    perm = u64.lexsort(
        [u64.from_numpy(hi, "cpu"), u64.from_numpy(lo, "cpu"),
         torch.from_numpy(occ)], [True, True, False]).numpy()
    want = np.lexsort((np.arange(200), occ, lo, hi))
    assert np.array_equal(perm, want)


def test_u64_compare_shift_rotate_match_numpy():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 64, 500, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, 500, dtype=np.uint64)
    a[:3] = [MASK64, 1 << 63, 0]
    b[:3] = [0, (1 << 63) - 1, MASK64]
    ta, tb = u64.from_numpy(a, "cpu"), u64.from_numpy(b, "cpu")
    assert np.array_equal(u64.lt(ta, tb).numpy(), a < b)
    assert np.array_equal(u64.le(ta, tb).numpy(), a <= b)
    assert np.array_equal(u64.gt(ta, tb).numpy(), a > b)
    assert np.array_equal(u64.to_numpy(u64.minimum(ta, tb)), np.minimum(a, b))
    assert np.array_equal(u64.le(ta, 1 << 63).numpy(), a <= np.uint64(1 << 63))
    for r in (1, 17, 63):
        assert np.array_equal(u64.to_numpy(u64.shr(ta, r)), a >> np.uint64(r))
        want = (a << np.uint64(r)) | (a >> np.uint64(64 - r))
        assert np.array_equal(u64.to_numpy(u64.rotl(ta, r)), want)
    assert int(u64.to_numpy(u64.rotl(u64.from_numpy(H_BY_CODE, "cpu"),
                                     64))[0]) == int(H_BY_CODE[0])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """csrc/nthash_select.cu against the plain version (run on the card:
    `python -m pytest tests/test_torch_nthash.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    l = 14
    codes, lengths = _batch(3, 64, 4096, l)
    c = torch.from_numpy(codes).cuda()
    n = torch.from_numpy(lengths).cuda()
    hb = _bound(0.01)
    before = nthash_select.launches
    ck, sk = nthash_select(c, l, hb, n)
    cp, sp = nthash_select_plain(c, l, hb, n)
    assert nthash_select.launches == before + 1
    assert torch.equal(ck, cp) and torch.equal(sk, sp)
