"""Port parity: open-syncmer selection (ops/kernels.syncmer_select and the
planes of ops/syncmers_device).

The same numpy inputs go through the JAX package's `syncmer_select_jax`,
the port's `kernels.syncmer_select` (on CPU tensors: the kernel's plain
version) and the host state machine `extract_syncmers_np` row by row.  A
numpy model of the fused kernel's warp-parallel incumbent walk
(speculative sub-chunks, the exits of sub-chunks with a forced column,
the chain of those without, then the fix-ups) is held against the column
scan on adversarial planes.  Every comparison is exact (integers
and bools).  The CUDA kernel has no CPU form: its test is marked `cuda` and
skips without a card.
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
from rust_mdbg_tpu_torch.ops.kernels import syncmer_select
from rust_mdbg_tpu_torch.ops.syncmers_device import (invertible_hash,
                                                     syncmer_planes)

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


def _folded(pl):
    """The kernel's two folded planes: x = run_start ? lpos : rpos, and
    thr = INT_MAX at a forced column (a run start, a strict new minimum, or
    no valid l-mer), the column itself elsewhere; a step is inc = inc < thr
    ? x : inc.  The trace then equals the column scan's wherever the l-mer
    is valid, the only columns a selection reads."""
    L = pl["lpos"].shape[1]
    x = torch.where(pl["run_start"], pl["lpos"], pl["rpos"]).numpy()
    forced = (pl["run_start"] | pl["strict_new"] | ~pl["valid_l"]).numpy()
    thr = np.where(forced, np.iinfo(np.int32).max,
                   np.arange(L, dtype=np.int32))
    return x.astype(np.int64), thr.astype(np.int64)


def warp_walk_model(x, thr, lanes=32, sub=64):
    """numpy model of csrc/syncmer_select.cu's incumbent walk.  Each row
    goes in tiles of lanes * sub columns; in a tile every lane walks its
    sub-chunk from INC_START, as if the incumbent entering it were already
    evicted, and notes whether the sub-chunk holds a forced column (thr at
    INT_MAX), past which its trace is exact whatever the entry; the lanes
    without one re-walk in order, each from the exit of the lane before;
    then every lane whose true entering incumbent is not below its first
    column re-walks (on the card, in parallel) until its value equals the
    speculative trace's.  Returns the trace and the columns re-walked."""
    B, L = x.shape
    out = np.empty((B, L), dtype=np.int64)
    rewalked = 0
    tile = lanes * sub
    force = np.iinfo(np.int32).max
    for b in range(B):
        carry = kernels.INC_START
        for t0 in range(0, L, tile):
            n = min(tile, L - t0)
            xs, ts = x[b, t0 : t0 + n], thr[b, t0 : t0 + n]
            tr = np.empty(n, dtype=np.int64)
            edges = [(c0, min(n, c0 + sub)) for c0 in range(0, n, sub)]
            forced, ex = [], []
            for c0, c1 in edges:  # the lanes, in parallel on the card
                v = kernels.INC_START
                for c in range(c0, c1):
                    v = xs[c] if v < ts[c] else v
                    tr[c] = v
                forced.append(bool((ts[c0:c1] == force).any()))
                ex.append(v)

            def rewalk(i, u):
                nonlocal rewalked
                c0, c1 = edges[i]
                for c in range(c0, c1):
                    rewalked += 1
                    u = xs[c] if u < ts[c] else u
                    if u == tr[c]:
                        return ex[i]
                    tr[c] = u
                return u

            def entry(i):
                return carry if i == 0 else ex[i - 1]

            for i in range(len(edges)):  # the chain, in order
                if not forced[i] and entry(i) >= t0 + edges[i][0]:
                    ex[i] = rewalk(i, entry(i))
            for i in range(len(edges)):  # the fix-ups, in parallel
                if forced[i] and entry(i) >= t0 + edges[i][0]:
                    rewalk(i, entry(i))
            carry = ex[-1]
            out[b, t0 : t0 + n] = tr
    return out, rewalked


def _adversarial(L, seed):
    """Rows that stress the walk: one base throughout (every s-mer hash
    equal, so two traces out of phase never meet), period-2 and period-3
    repeats, two-letter noise (ties everywhere at s = 2), N runs of every
    length up to 40 and an N every few columns, a row shorter than l and an
    empty one."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(L), np.arange(L) % 2, np.arange(L) % 3,
            rng.integers(0, 2, L), rng.integers(0, 4, L),
            rng.integers(0, 4, L), rng.integers(0, 2, L), np.zeros(L)]
    codes = np.stack(rows).astype(np.uint8)
    j = 0
    for n in range(1, 41):  # N runs in row 4
        if j + n >= L:
            break
        codes[4, j + 3 : j + 3 + n] = 4
        j += n + 3 + n % 5
    codes[5, ::7] = 4
    lengths = np.full(len(rows), L, dtype=np.int32)
    lengths[6] = min(L, 9)  # shorter than l
    lengths[7] = 0
    return codes, lengths


@pytest.mark.parametrize("lanes,sub", [(4, 8), (3, 5), (32, 64)])
@pytest.mark.parametrize("l,s,L", [(12, 2, 700), (14, 4, 700), (8, 7, 700),
                                   (12, 12, 300), (14, 4, 5), (16, 2, 900)])
def test_warp_walk_model_matches_column_scan(l, s, L, lanes, sub):
    """The kernel's walk, modelled in numpy, = the column scan wherever the
    l-mer is valid, on the adversarial planes, with sub-chunk edges inside
    runs and ties, L below w, and (at 4 x 8) many tiles a row."""
    codes, lengths = _adversarial(L, l * 10 + s)
    pl = syncmer_planes(torch.from_numpy(codes), torch.from_numpy(lengths),
                        l=l, s=s, bound=_bound(l, 0.3))
    scan = kernels.syncmer_incumbent_plain(
        pl["lpos"], pl["rpos"], pl["run_start"], pl["strict_new"]).numpy()
    got, rewalked = warp_walk_model(*_folded(pl), lanes=lanes, sub=sub)
    valid = pl["valid_l"].numpy()
    assert np.array_equal(got[valid], scan[valid])
    if L > lanes * sub and s == 2:
        assert rewalked > 0  # the fix-up ran


@pytest.mark.parametrize("l,s", [(10, 4), (12, 2), (8, 7), (14, 4)])
@pytest.mark.parametrize("B,L", [(24, 300), (8, 1700), (5, 512), (4, 1025)])
def test_incumbent_forms_agree(l, s, B, L):
    """The wrapper's (hl, sel) on CPU tensors = its plain version; the
    plain version's column scan = the JAX blocked form on the port's own
    planes = the kernel's walk modelled in numpy; sizes below, at and off
    that form's chunk width of 512."""
    codes, lengths = _batch(B * L + l, B=B, L=L, n_rate=0.02)
    args = (torch.from_numpy(codes), torch.from_numpy(lengths))
    kw = dict(l=l, s=s, bound=_bound(l, 0.1))
    got = kernels.syncmer_select(*args, **kw)
    want = kernels.syncmer_select_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    pl = syncmer_planes(*args, **kw)
    planes = tuple(pl[x] for x in ("lpos", "rpos", "run_start", "strict_new"))
    scan = kernels.syncmer_incumbent_plain(*planes)
    blocked = jax.jit(_incumbent_blocked, static_argnums=4)(
        *(jnp.asarray(x.numpy()) for x in planes), l - s + 1)
    assert np.array_equal(scan.numpy(), np.asarray(blocked))
    valid = pl["valid_l"].numpy()
    walk = warp_walk_model(*_folded(pl), lanes=4, sub=16)[0]
    assert np.array_equal(walk[valid], scan.numpy()[valid])
    assert kernels.syncmer_select.launches == 0  # CPU tensors: no launch


def test_kernel_wrapper_refuses_bad_cuda_input():
    """On anything but a CPU tensor the wrapper launches or raises; the
    device, dtype, shape and (l, s) checks come before the build, so they
    show here."""
    meta = torch.device("meta")
    c = torch.empty((2, 8), dtype=torch.uint8, device=meta)
    n = torch.empty((2,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.syncmer_select(c, n, l=10, s=4, bound=1)


@pytest.mark.cuda
def test_syncmer_select_kernel_matches_plain_on_the_card():
    """csrc/syncmer_select.cu = its plain version, hl and sel element by
    element (run with `pytest -m cuda` on a machine with a GPU and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    for (l, s), (B, L), skip in [((14, 4), (25, 6147), 0),
                                 ((12, 11), (25, 6147), 3),
                                 ((8, 7), (9, 37), 0), ((32, 8), (6, 2100), 0),
                                 ((14, 0), (6, 2100), 1)]:
        codes, lengths = _batch(l + s, B=B, L=L, n_rate=0.02)
        c = torch.from_numpy(codes).cuda()[skip:]
        n = torch.from_numpy(lengths).cuda()[skip:]
        kw = dict(l=l, s=s, bound=_bound(l, 0.1))
        before = kernels.syncmer_select.launches
        got = kernels.syncmer_select(c, n, **kw)
        assert kernels.syncmer_select.launches == before + 1
        want = kernels.syncmer_select_plain(c, n, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    codes, lengths = _adversarial(3000, 7)
    c, n = torch.from_numpy(codes).cuda(), torch.from_numpy(lengths).cuda()
    for l, s in ((12, 2), (14, 4), (16, 16)):
        kw = dict(l=l, s=s, bound=_bound(l, 0.3))
        got = kernels.syncmer_select(c, n, **kw)
        want = kernels.syncmer_select_plain(c, n, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
