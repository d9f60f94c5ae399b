"""Port parity: open-syncmer selection (ops/syncmers_device).

The same numpy inputs go through the JAX package's `syncmer_select_jax`,
the port's `syncmer_select` (on CPU tensors: the kernel's plain version),
and the host state machine `extract_syncmers_np` row by row.  Every comparison is exact
(integers and bools).  The CUDA kernel of the incumbent trace has no CPU
form: its test is marked `cuda` and skips without a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_mdbg_tpu.ops.syncmers_device import (_incumbent_blocked,
                                               invertible_hash_jax,
                                               syncmer_select_jax)
from rust_mdbg_tpu_torch.ops import kernels, u64
from rust_mdbg_tpu_torch.ops.minimizers import (extract_syncmers_np,
                                                invertible_hash_np)
from rust_mdbg_tpu_torch.ops.syncmers_device import (invertible_hash,
                                                     syncmer_planes,
                                                     syncmer_select)

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

# the (l, s, density) grid of the JAX package's device-syncmer tests, plus
# w = 2 at a larger l, w = 1 (s == l) and
# l = 32, where the l-mer mask is all 64 bits
GRID = [(10, 4, 0.05), (12, 2, 0.2), (8, 7, 0.1), (10, 0, 0.01),
        (12, 11, 0.3), (12, 12, 0.3), (32, 8, 0.2), (14, 4, 0.1)]


def _batch(seed, B=12, L=1100, n_rate=0.01):
    """Random codes with N bases (run restarts), an N run, an 'other' base
    and ragged lengths with an empty row and one shorter than l."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < n_rate] = 4
    codes[2, 100:140] = 4
    codes[3, 7] = 5
    lengths = rng.integers(L // 3, L + 1, B).astype(np.int32)
    lengths[:3] = [0, 5, L]
    return codes, lengths


def _bound(l, density):
    return int(density * 4 ** l)


@pytest.mark.parametrize("bits", [8, 20, 28, 64])
def test_invertible_hash_matches_jax_and_numpy(bits):
    rng = np.random.default_rng(bits)
    mask = np.uint64((1 << bits) - 1)
    keys = rng.integers(0, 1 << 63, 4000, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, 4000).astype(np.uint64)
    keys &= mask
    want = np.asarray(invertible_hash_jax(jnp.asarray(keys), bits))
    got = u64.to_numpy(invertible_hash(u64.from_numpy(keys, "cpu"), bits))
    assert np.array_equal(got, want)
    assert np.array_equal(got, invertible_hash_np(keys, mask))
    assert bits < 64 or (got >> np.uint64(63)).any()  # top bit exercised


@pytest.mark.parametrize("ragged", ["ragged", "full", "short"])
@pytest.mark.parametrize("l,s,density", GRID)
def test_syncmer_select_matches_jax(l, s, density, ragged):
    """Against the JAX function, on ragged rows with N runs, on full rows
    without N, and on rows narrower than the JAX form's chunk width."""
    B, L, n_rate = {"ragged": (12, 1100, 0.01), "full": (6, 1100, 0.0),
                    "short": (9, 300, 0.03)}[ragged]
    codes, lengths = _batch(l * 100 + s, B=B, L=L, n_rate=n_rate)
    if ragged == "full":
        lengths[:] = L
    bound = _bound(l, density)
    cj, sj = syncmer_select_jax(jnp.asarray(codes), jnp.asarray(lengths),
                                l=l, s=s, bound=bound)
    ct, st = syncmer_select(torch.from_numpy(codes),
                            torch.from_numpy(lengths), l=l, s=s, bound=bound)
    assert np.array_equal(u64.to_numpy(ct), np.asarray(cj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert st.any()


@pytest.mark.parametrize("l,s,density", GRID)
def test_syncmer_select_matches_host_rows(l, s, density):
    """Row by row against the host state machine on pre-HPC'd codes: the
    selected columns are its positions, their hashes its hashes."""
    codes, lengths = _batch(l * 100 + s + 1, B=6, L=700)
    bound = _bound(l, density)
    ct, st = syncmer_select(torch.from_numpy(codes),
                            torch.from_numpy(lengths), l=l, s=s, bound=bound)
    canon, sel = u64.to_numpy(ct), st.numpy()
    n = 0
    for b in range(codes.shape[0]):
        pos, hashes = extract_syncmers_np(codes[b, : lengths[b]], l, s, bound,
                                          already_hpc=True)
        cols = np.nonzero(sel[b])[0]
        assert np.array_equal(cols, pos)
        assert np.array_equal(canon[b, cols], hashes)
        n += len(pos)
    assert n > 0


def test_no_switch_replaces_the_kernel(monkeypatch):
    """The JAX package's MDBG_SYNCMER_ENGINE has no counterpart: the port
    reads no environment on the way to the incumbent trace."""
    codes, lengths = _batch(1, B=4, L=256)
    args = (torch.from_numpy(codes), torch.from_numpy(lengths))
    kw = dict(l=10, s=4, bound=_bound(10, 0.1))
    want = syncmer_select(*args, **kw)
    for value in ("scan", "blocked", "lifting"):
        monkeypatch.setenv("MDBG_SYNCMER_ENGINE", value)
        got = syncmer_select(*args, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("l,s", [(10, 4), (12, 2), (8, 7), (14, 4)])
@pytest.mark.parametrize("B,L", [(24, 300), (8, 1700), (5, 512), (4, 1025)])
def test_incumbent_forms_agree(l, s, B, L):
    """The plain version = the JAX blocked form on the port's own planes;
    sizes below, at and off that form's chunk width of 512."""
    codes, lengths = _batch(B * L + l, B=B, L=L, n_rate=0.02)
    pl = syncmer_planes(torch.from_numpy(codes), torch.from_numpy(lengths),
                        l=l, s=s, bound=_bound(l, 0.1))
    planes = tuple(pl[x] for x in ("lpos", "rpos", "run_start", "strict_new"))
    scan = kernels.syncmer_incumbent_plain(*planes)
    assert torch.equal(kernels.syncmer_incumbent(*planes), scan)
    want = jax.jit(_incumbent_blocked, static_argnums=4)(
        *(jnp.asarray(x.numpy()) for x in planes), l - s + 1)
    assert np.array_equal(scan.numpy(), np.asarray(want))
    assert kernels.syncmer_incumbent.launches == 0  # CPU tensors: no launch


def test_kernel_wrapper_refuses_bad_cuda_input():
    """On anything but a CPU tensor the wrapper launches or raises; the
    shape and dtype checks come before the build, so they show here."""
    meta = torch.device("meta")
    x = torch.empty((2, 8), dtype=torch.int32, device=meta)
    b = torch.empty((2, 8), dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.syncmer_incumbent(x, x, b, b)


@pytest.mark.cuda
def test_kernel_matches_plain_versions_on_the_card():
    """csrc/syncmer_incumbent.cu = its plain version, element by element (run
    with `pytest -m cuda` on a machine with a GPU and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    for (l, s), (B, L), skip in [((14, 4), (25, 6147), 0),
                                 ((12, 11), (25, 6147), 3),
                                 ((8, 7), (9, 37), 0)]:
        codes, lengths = _batch(l + s, B=B, L=L, n_rate=0.02)
        pl = syncmer_planes(torch.from_numpy(codes).cuda(),
                            torch.from_numpy(lengths).cuda(), l=l, s=s,
                            bound=_bound(l, 0.1))
        planes = tuple(pl[x][skip:] for x in ("lpos", "rpos", "run_start",
                                              "strict_new"))
        before = kernels.syncmer_incumbent.launches
        got = kernels.syncmer_incumbent(*planes)
        assert kernels.syncmer_incumbent.launches == before + 1
        assert torch.equal(got, kernels.syncmer_incumbent_plain(*planes))
