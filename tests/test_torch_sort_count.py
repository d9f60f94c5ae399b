"""Port parity: the chunk construct, the per-chunk reduction and the
crossing gather against the JAX package's, on identical counter state
carried across with buffers_from_numpy / buffers_to_numpy.  Exact."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_mdbg_tpu.ops.sort_count import (
    DeviceNodeCounter as JaxCounter, _finalize_chunk, _gather_window_meta,
    _overlap_keys_device, make_fused_construct)
from rust_mdbg_tpu_torch.ops import u64
from rust_mdbg_tpu_torch.ops.extract import capacity
from rust_mdbg_tpu_torch.ops.pack import pack_codes_np
from rust_mdbg_tpu_torch.ops.sort_count import (
    DeviceNodeCounter, buffers_from_numpy, buffers_to_numpy,
    construct_batches, finalize_chunk, gather_window_meta,
    overlap_keys_device, window_slot_capacity)
from rust_mdbg_tpu_torch.params import Params

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

B, L, NB = 16, 1024, 4
P = Params(k=5, l=9, density=0.03, min_kmer_abundance=2)
#: the same reads taken as already homopolymer-compressed: five buffer
#: planes, recompute-mode gathers
P_HPC = Params(k=5, l=9, density=0.03, min_kmer_abundance=2,
               reads_already_hpc=True)


def _chunk(seed):
    """A chunk of reads sampled from a small genome, so keys repeat across
    reads; homopolymers, N runs and ragged lengths included."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    genome[rng.random(3000) < 0.15] = 0             # A homopolymers
    genome[1000:1004] = 4
    starts = rng.integers(0, 3000 - L, B * NB)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    codes[rng.random(codes.shape) < 0.003] = 2       # substitutions
    lengths = rng.integers(L // 2, L + 1, B * NB).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


def _sizes():
    M = capacity(P, L)
    return M, window_slot_capacity(P, B, L, M)


def _run_both(seeds_and_batches, P=P):
    """Run chunks through both constructs (with a reset between chunks) and
    return (jax counter, torch buffers, per-chunk [(jax nw/over, torch)])."""
    M, ws = _sizes()
    jc = JaxCounter(k=P.k, M=M, read_cap=B * NB, node_cap=1 << 20,
                    minab=2, w_slot=ws, chunk_slots=2,
                    with_ext=not P.reads_already_hpc)
    fn = make_fused_construct(P, B, L, M, NB, packed=True, w_slot=ws,
                              bf=False)
    tbufs = buffers_from_numpy(tuple(np.asarray(b) for b in jc.buffers),
                               "cpu")
    counts = []
    for i, (seed, nbat) in enumerate(seeds_and_batches):
        if i:
            jc.reset_chunk()
            tbufs[0].fill_(u64.SENTINEL)
            tbufs[1].fill_(u64.SENTINEL)
        codes, lengths = _chunk(seed)
        pk, mk = pack_codes_np(codes)
        bufs, nw, no = fn((jnp.asarray(pk), jnp.asarray(mk)),
                          jnp.asarray(lengths), jc.buffers, 0, 0, nbat)
        jc.buffers = bufs
        tw, to = construct_batches(
            P, (torch.from_numpy(pk), torch.from_numpy(mk)),
            torch.from_numpy(lengths), tbufs, B=B, M=M, w_slot=ws,
            batch_lo=0, batch_hi=nbat)
        counts.append(((int(nw), int(no)), (int(tw), int(to))))
    return jc, tbufs, counts


@pytest.mark.parametrize("batches", [[(0, NB)], [(1, NB), (2, 2)]])
def test_construct_matches_jax(batches):
    """Full chunk, and a full chunk followed by a partial one after a reset
    (stale occ/mh rows stay, as in the JAX counter)."""
    jc, tbufs, counts = _run_both(batches)
    for (jn, tn) in counts:
        assert jn == tn and tn[0] > 0
    jb = tuple(np.asarray(b) for b in jc.buffers)
    tb = buffers_to_numpy(tbufs)
    assert len(jb) == len(tb) == 6
    for a, b in zip(jb, tb):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("batches", [[(0, NB)], [(1, NB), (2, 2)]])
def test_five_plane_construct_matches_jax(batches):
    """Pre-HPC'd input: no extent plane on either side."""
    jc, tbufs, counts = _run_both(batches, P_HPC)
    for (jn, tn) in counts:
        assert jn == tn and tn[0] > 0
    jb = tuple(np.asarray(b) for b in jc.buffers)
    tb = buffers_to_numpy(tbufs)
    assert len(jb) == len(tb) == 5
    for a, b in zip(jb, tb):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_construct_rejects_mismatched_planes():
    _, tbufs, _ = _run_both([(0, 1)], P_HPC)
    codes, lengths = _chunk(0)
    M, ws = _sizes()
    with pytest.raises(ValueError, match="5 buffer planes"):
        construct_batches(P, torch.from_numpy(codes),
                          torch.from_numpy(lengths), tbufs, B=B, M=M,
                          w_slot=ws, batch_lo=0, batch_hi=1)


def test_record_pos_gather_and_overlap_keys_match_jax():
    """The recompute-mode gather: meta (five columns), record-relative
    minimizer positions flipped for reversed crossings, and the overlap
    fingerprints of the gathered vectors."""
    jc, tbufs, _ = _run_both([(1, NB), (4, 3)], P_HPC)
    M, _ = _sizes()
    lo, hi, cnt, occs = finalize_chunk(*tbufs[:3], slots=2)
    sel = np.where(cnt.numpy() >= 2, 1, 0)
    qo = occs.numpy()[np.arange(lo.shape[0]), sel]

    def jax_gather(b_mh, b_mp, o):
        vec, meta, mpos = _gather_window_meta(
            b_mh, b_mp, o, k=P.k, M=M, with_record_pos=True, pos_u16=True)
        return (vec, meta, mpos) + _overlap_keys_device(vec)

    vj, mj, pj, gkj, gfj = jax.jit(jax_gather)(
        jc.buffers[3], jc.buffers[4], jnp.asarray(qo.astype(np.uint32)))
    vt, mt, clipped, pt = gather_window_meta(
        tbufs[3], tbufs[4], torch.from_numpy(qo), k=P.k, M=M,
        with_record_pos=True)
    gkt, gft = overlap_keys_device(vt)
    assert np.array_equal(np.asarray(vj), u64.to_numpy(vt))
    assert np.array_equal(np.asarray(mj), mt.numpy().astype(np.uint32))
    assert mt.shape[1] == 5 and int(clipped) == 0
    assert np.array_equal(np.asarray(pj).astype(np.int64), pt.numpy())
    assert np.array_equal(np.asarray(gkj), u64.to_numpy(gkt))
    assert np.array_equal(np.asarray(gfj), gft.numpy())
    rev = (mt[:, 2] >> 31).bool()
    assert rev.any() and (~rev).any()
    # positions ascend along a forward record and start at 0
    assert (pt[~rev][:, 0] == 0).all() and (pt.diff(dim=1) > 0).all()

    # the counter class returns the same through both of its gathers
    c = DeviceNodeCounter(k=P.k, M=M, read_cap=B * NB, w_slot=_sizes()[1],
                          chunk_slots=2, device="cpu", with_ext=False)
    c.buffers = tbufs
    gk_d, gf_d, meta, mpos = c.gather_crossing_keys_dev(qo)
    assert torch.equal(gk_d, gkt) and torch.equal(gf_d, gft)
    assert meta.dtype == np.uint32 and mpos.dtype == np.uint32
    assert np.array_equal(meta, np.asarray(mj))
    assert np.array_equal(mpos, np.asarray(pj).astype(np.uint32))
    gk, gf, meta2, mpos2 = c.gather_crossing_keys(qo)
    assert gk.dtype == np.uint64 and gf.dtype == np.uint8
    assert np.array_equal(gk, np.asarray(gkj))
    assert np.array_equal(gf, np.asarray(gfj))
    assert np.array_equal(meta2, meta) and np.array_equal(mpos2, mpos)
    vec, meta5, n_clipped = c.gather_crossing(qo)
    assert meta5.shape[1] == 5 and n_clipped == 0
    assert np.array_equal(vec, np.asarray(vj))


def test_buffers_round_trip():
    M, ws = _sizes()
    jc = JaxCounter(k=P.k, M=M, read_cap=8, node_cap=64, minab=2,
                    w_slot=ws, with_ext=True)
    rng = np.random.default_rng(5)
    jb = [np.asarray(b).copy() for b in jc.buffers]
    jb[0][:7] = rng.integers(0, 1 << 64, 7, dtype=np.uint64)
    jb[2][:3] = [0, 7, 0xFFFFFFFE]
    back = buffers_to_numpy(buffers_from_numpy(tuple(jb), "cpu"))
    for a, b in zip(jb, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("slots", [2, 3])
def test_finalize_chunk_and_gather_match_jax(slots):
    jc, tbufs, _ = _run_both([(1, NB), (4, 3)])
    M, _ = _sizes()
    N = jc.window_cap
    oj = jax.jit(functools.partial(_finalize_chunk, node_cap=N,
                                   slots=slots))(*jc.buffers[:3])
    n_unique = int(np.asarray(oj["stats2"])[0])
    lo, hi, cnt, occs = finalize_chunk(*tbufs[:3], slots=slots)
    assert lo.shape[0] == n_unique > 0
    assert np.array_equal(np.asarray(oj["key_lo"])[:n_unique],
                          u64.to_numpy(lo))
    assert np.array_equal(np.asarray(oj["key_hi"])[:n_unique],
                          u64.to_numpy(hi))
    assert np.array_equal(np.asarray(oj["count"])[:n_unique],
                          cnt.numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(oj["occs"])[:n_unique],
                          occs.numpy().astype(np.uint32))
    assert int(cnt.max()) >= slots  # some keys repeat within the chunk

    # crossing gather at each key's slots-th appearance where it has one,
    # else its first: exactly what the chunked driver asks for
    sel = np.where(cnt.numpy() >= slots, slots - 1, 0)
    qo = occs.numpy()[np.arange(n_unique), sel]
    vj, mj = jax.jit(functools.partial(_gather_window_meta, k=P.k, M=M))(
        jc.buffers[3], jc.buffers[4], jnp.asarray(qo.astype(np.uint32)),
        b_mpe=jc.buffers[5])
    vt, mt, clipped = gather_window_meta(
        tbufs[3], tbufs[4], torch.from_numpy(qo), k=P.k, M=M, b_mpe=tbufs[5])
    assert np.array_equal(np.asarray(vj), u64.to_numpy(vt))
    assert np.array_equal(np.asarray(mj), mt.numpy().astype(np.uint32))
    assert mt.shape[1] == 6
    assert int(clipped) == 0


def test_counter_reduces_and_resets():
    """The counter class drives the same functions; after reset_chunk a
    reduction sees no keys."""
    M, ws = _sizes()
    c = DeviceNodeCounter(k=P.k, M=M, read_cap=B * NB, w_slot=ws,
                          chunk_slots=2, device="cpu")
    codes, lengths = _chunk(0)
    construct_batches(P, torch.from_numpy(codes), torch.from_numpy(lengths),
                      c.buffers, B=B, M=M, w_slot=ws, batch_lo=0,
                      batch_hi=NB)
    res = c.finalize_chunk()
    rows = np.nonzero(res["count"] >= 2)[0]
    occ = c.occ_at_chunk(rows, np.full(len(rows), 2))
    vec, meta, clipped = c.gather_crossing(occ)
    assert vec.shape == (len(rows), P.k) and meta.shape == (len(rows), 6)
    assert clipped == 0
    assert (meta[:, 1] >> 31).all()
    c.reset_chunk()
    assert c.finalize_chunk()["n_unique"] == 0


def _meta_buffers(case):
    """Hand-built compact minimizer rows (k=3, M=8, l=9): 4 reads whose
    minimizers sit 40 bases apart with extents 12 bases long, and the
    window occurrences of every read's windows 0 and 5.  `case` pushes one
    window's extent corrections out of 16 bits: ext_delta = extent end -
    (last l-mer start + l) past 0xFFFF, or de1 = the last two extents'
    end difference minus their start difference past +-0x8000."""
    k, M, l = 3, 8, 9
    rng = np.random.default_rng(6)
    mh = rng.integers(0, 1 << 64, (4, M), dtype=np.uint64)
    mp = (np.arange(M, dtype=np.int32) * 40 + 100)[None, :].repeat(4, 0)
    mpe = mp + 12 - l                   # extent end - l (the biased plane)
    if case == "ext_delta":
        mpe[1, 7] = mp[1, 7] + 0x10000  # ext_delta = 0x10000
    elif case == "de1_high":
        mpe[2, 7] = mpe[2, 6] + 40 + 0x8000
    elif case == "de1_low":
        mpe[2, 6] = mpe[2, 7] - 40 + 0x8001
    W = M - k + 1
    occs = np.array([r * W + w for r in range(4) for w in (0, W - 1)],
                    dtype=np.int64)
    return k, M, mh, mp.astype(np.int32), mpe.astype(np.int32), occs


@pytest.mark.parametrize("case,want", [("in_range", 0), ("ext_delta", 1),
                                       ("de1_high", 1), ("de1_low", 1)])
def test_gather_window_meta_counts_clipped_rows(case, want):
    """The port counts the rows whose 16-bit extent corrections would clip;
    its meta stays equal to the JAX gather's (which clips silently)."""
    k, M, mh, mp, mpe, occs = _meta_buffers(case)
    vt, mt, clipped = gather_window_meta(
        u64.from_numpy(mh, "cpu"), torch.from_numpy(mp),
        torch.from_numpy(occs), k=k, M=M, b_mpe=torch.from_numpy(mpe))
    assert int(clipped) == want
    vj, mj = jax.jit(functools.partial(_gather_window_meta, k=k, M=M))(
        jnp.asarray(mh), jnp.asarray(mp),
        jnp.asarray(occs.astype(np.uint32)), b_mpe=jnp.asarray(mpe))
    assert np.array_equal(np.asarray(vj), u64.to_numpy(vt))
    assert np.array_equal(np.asarray(mj), mt.numpy().astype(np.uint32))
    _, _, none = gather_window_meta(
        u64.from_numpy(mh, "cpu"), torch.from_numpy(mp),
        torch.from_numpy(occs), k=k, M=M)
    assert int(none) == 0
