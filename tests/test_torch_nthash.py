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
from rust_mdbg_tpu_torch.ops.nthash import (H_BY_CODE, RC_BY_CODE, ntc64,
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


def _rotl(x, r):
    """u64 rotation by a runtime count, as the kernel writes it: r & 63,
    with r == 0 apart (a shift by 64 is undefined in C)."""
    r &= 63
    return x if r == 0 else (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _rotr(x, r):
    return _rotl(x, 64 - (r & 63))


def rolling_model(codes, lengths, l, hb, P):
    """numpy model of csrc/nthash_select.cu's work split: every run of P
    positions starts at a multiple of P; its thread rolls its first window
    in from an all-N window (the closed form in Horner form, l steps), then
    rolls P-1 times.  Each step is one lookup of the combined (outgoing,
    incoming) terms, built once per l for codes 0..3 and the zero code 4;
    codes past L read 4 and every code above 4 is clamped to 4."""
    B, L = codes.shape
    runs = -(-L // P)
    c = np.full((B, runs * P + l), 4, dtype=np.int64)
    c[:, :L] = np.minimum(codes, 4)
    h = np.append(H_BY_CODE[:4], np.uint64(0))
    rc = np.append(RC_BY_CODE[:4], np.uint64(0))
    tf = _rotl(h, l)[:, None] ^ h[None, :]            # [outgoing, incoming]
    tr = _rotr(rc, 1)[:, None] ^ _rotl(rc, l - 1)[None, :]
    one = np.uint64(1)
    fh = np.zeros((B, runs), dtype=np.uint64)
    rh = np.zeros((B, runs), dtype=np.uint64)
    canon = np.zeros((B, runs, P), dtype=np.uint64)
    start = np.arange(runs) * P
    def step(fh, rh, co, ci):
        return ((fh << one) | (fh >> np.uint64(63))) ^ tf[co, ci], \
               ((rh >> one) | (rh << np.uint64(63))) ^ tr[co, ci]
    for s in range(l):
        fh, rh = step(fh, rh, 4, c[:, start + s])
    for i in range(P):
        if i:
            fh, rh = step(fh, rh, c[:, start + i - 1], c[:, start + i - 1 + l])
        canon[:, :, i] = np.minimum(fh, rh)
    canon = canon.reshape(B, runs * P)[:, :L]
    valid = np.arange(L)[None, :] + l <= lengths[:, None]
    return canon, (canon <= np.uint64(hb)) & valid


@pytest.mark.parametrize("P", [16, 32])
@pytest.mark.parametrize("l", [1, 5, 14, 31, 32, 64])
def test_rolling_model_matches_closed_form(l, P):
    """The kernel's rolling work split gives the closed form's bits at
    every position: against the plain version everywhere (windows past L
    read the zero code) and against nthash_windows_np inside each length.
    L = 291 is odd and leaves a run start at 288, inside the last l-1
    columns for l >= 4; lengths include 0, 1, l-1, l and L; N and the
    other code 5 are sprinkled in, also in the last columns."""
    L = 291
    codes, lengths = _batch(40 + l, 12, L, l)
    lengths[4:6] = [1, L - 2]
    codes[5, L - 2:] = 5
    codes[6, ::7] = 5
    hb = _bound(0.3)
    canon, sel = rolling_model(codes, lengths, l, hb, P)
    cp, sp = nthash_select_plain(torch.from_numpy(codes), l, hb,
                                 torch.from_numpy(lengths))
    assert np.array_equal(canon, u64.to_numpy(cp))
    assert np.array_equal(sel, sp.numpy())
    assert sel.any() and not sel.all()
    for b in range(codes.shape[0]):
        n = int(lengths[b])
        fh, rh = nthash_windows_np(codes[b, :n], l)
        assert np.array_equal(canon[b, : len(fh)], np.minimum(fh, rh))
    # codes above 5 hash like N in the model (the plain version's table
    # has no entry for them)
    high = codes.copy()
    high[high == 4] = 200
    assert np.array_equal(rolling_model(high, lengths, l, hb, P)[0], canon)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """csrc/nthash_select.cu against the plain version
    (run on the card: `python -m pytest tests/test_torch_nthash.py -m
    cuda`): a shape of whole 4,096-position tiles, odd L with edge rows,
    an unaligned row slice, and l from 1 to 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    hb = _bound(0.01)
    for shape, l, skip in [((64, 4096), 14, 0), ((24, 4099), 1, 0),
                           ((24, 4099), 13, 0), ((24, 8195), 32, 0),
                           ((24, 4099), 64, 0), ((27, 4099), 14, 3),
                           ((9, 37), 31, 1)]:
        codes, lengths = _batch(3 + l, *shape, l)
        c = torch.from_numpy(codes).cuda()[skip:]
        n = torch.from_numpy(lengths).cuda()[skip:]
        cp, sp = nthash_select_plain(c, l, hb, n)
        before = nthash_select.launches
        ck, sk = nthash_select(c, l, hb, n)
        assert nthash_select.launches == before + 1
        assert torch.equal(ck, cp) and torch.equal(sk, sp), (shape, l, skip)
