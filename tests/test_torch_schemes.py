"""Port parity: the scheme stages of ops/extract and the DeviceExtractor.

Stage by stage (`_packed_lmers`, `_filter_skip_n`, `_mix64`,
`_stream_filter`, `_stream_filter_bloom`), then `device_extract`'s full
and compact outputs against `jax.jit(_device_extract)` field by field, then
the port's `DeviceExtractor` against the JAX package's WindowBatch by
WindowBatch over three batches for every scheme, and the long-sequence
tiler.  The same numpy inputs go through both; every comparison is exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_mdbg_tpu.io import fastx as fastx_jax
from rust_mdbg_tpu.ops import extract as xj
from rust_mdbg_tpu.params import Params as ParamsJ
from rust_mdbg_tpu_torch.core.extract import extract_windows_host
from rust_mdbg_tpu_torch.io import fastx
from rust_mdbg_tpu_torch.models.schemes import (CheckAndAddFilter,
                                                lcp_preparation,
                                                uhs_preparation)
from rust_mdbg_tpu_torch.ops import extract as xt
from rust_mdbg_tpu_torch.ops import u64
from rust_mdbg_tpu_torch.ops.minimizers import (extract_density_np,
                                                minimizers_preparation)
from rust_mdbg_tpu_torch.params import Params
from rust_mdbg_tpu_torch.utils.seq import decode_bases

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

ONES = ~np.uint64(0)


def _codes(seed, B=8, L=600, n_rate=0.01, hp=0.0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    if hp:
        rep = rng.random((B, L)) < hp
        for j in range(1, L):
            codes[:, j] = np.where(rep[:, j], codes[:, j - 1], codes[:, j])
    codes[rng.random((B, L)) < n_rate] = 4
    codes[1, 50:55] = 4
    codes[2, 9] = 5
    lengths = rng.integers(L // 3, L + 1, B).astype(np.int32)
    lengths[:3] = [0, 5, L]
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


def _t64(a):
    return u64.from_numpy(np.asarray(a, dtype=np.uint64), "cpu")


# --- stages ---------------------------------------------------------------------

@pytest.mark.parametrize("l", [1, 8, 21])
def test_packed_lmers_matches_jax(l):
    codes, _ = _codes(l)
    want = np.asarray(xj._packed_lmers(jnp.asarray(codes), l))
    got = u64.to_numpy(xt._packed_lmers(torch.from_numpy(codes), l))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("l", [1, 9, 14])
def test_filter_skip_n_matches_jax(l):
    codes, _ = _codes(l + 50, n_rate=0.03)
    sel = np.random.default_rng(l).random(codes.shape) < 0.5
    want = np.asarray(xj._filter_skip_n(jnp.asarray(sel), jnp.asarray(codes),
                                        l))
    got = xt._filter_skip_n(torch.from_numpy(sel), torch.from_numpy(codes),
                            l).numpy()
    assert np.array_equal(got, want)
    assert got.any() and (sel & ~got).any()


def test_mix64_matches_jax_and_host_filter():
    from rust_mdbg_tpu_torch.models.schemes import BloomCheckAndAddFilter

    rng = np.random.default_rng(5)
    h = rng.integers(0, 1 << 63, 5000, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, 5000).astype(np.uint64)
    want = np.asarray(xj._mix64_jax(jnp.asarray(h)))
    got = u64.to_numpy(xt._mix64(_t64(h)))
    assert np.array_equal(got, want)
    f = BloomCheckAndAddFilter(16)
    assert [int(x) & 0xFFFF for x in got[:50]] == \
        [f._idx(int(x)) for x in h[:50]]


def _filter_inputs(seed, B=6, L=400, rate=0.3, pool=300):
    """canon drawn from a small pool (so duplicates within and across
    batches abound), with some values above 2^63."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 1 << 62, pool, dtype=np.uint64) * np.uint64(3)
    canon = values[rng.integers(0, pool, (B, L))]
    sel = rng.random((B, L)) < rate
    codes, _ = _codes(seed, B, L, n_rate=0.02)
    return values, canon, sel, codes


@pytest.mark.parametrize("skip_n", [False, True])
@pytest.mark.parametrize("delta_cap,overflows", [(512, False), (64, True)])
def test_stream_filter_matches_jax(skip_n, delta_cap, overflows):
    values, canon, sel, codes = _filter_inputs(3)
    preload = np.sort(values[::7])
    seen = np.full(256, ONES, dtype=np.uint64)
    seen[:30] = np.sort(values[1::9])[:30]
    delta = np.full(delta_cap, ONES, dtype=np.uint64)
    delta[:10] = np.sort(values[2::11])[:10]
    sj, (dj, nj, oj) = jax.jit(functools.partial(
        xj._stream_filter, l=9, skip_n=skip_n))(
        jnp.asarray(canon), jnp.asarray(sel), jnp.asarray(codes),
        jnp.asarray(preload), jnp.asarray(seen), jnp.asarray(delta))
    st, (dt, nt, ot) = xt._stream_filter(
        _t64(canon), torch.from_numpy(sel), torch.from_numpy(codes),
        _t64(preload), _t64(seen), _t64(delta), l=9, skip_n=skip_n)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(u64.to_numpy(dt), np.asarray(dj))
    assert int(nt) == int(nj) and bool(ot) == bool(oj) == overflows
    assert st.any() and (sel & ~st.numpy()).any()


@pytest.mark.parametrize("skip_n", [False, True])
def test_stream_filter_bloom_matches_jax(skip_n):
    _values, canon, sel, codes = _filter_inputs(4, pool=3000)
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 1 << 32, 1 << 9, dtype=np.uint64).astype(np.uint32)
    bits &= rng.integers(0, 1 << 32, 1 << 9, dtype=np.uint64).astype(np.uint32)
    sj, bj = jax.jit(functools.partial(
        xj._stream_filter_bloom, l=9, skip_n=skip_n))(
        jnp.asarray(canon), jnp.asarray(sel), jnp.asarray(codes),
        jnp.asarray(bits))
    bits_t = torch.from_numpy(bits.view(np.int32).copy())
    st, bt = xt._stream_filter_bloom(
        _t64(canon), torch.from_numpy(sel), torch.from_numpy(codes), bits_t,
        l=9, skip_n=skip_n)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(bt.numpy().view(np.uint32), np.asarray(bj))
    # the input words are left as they were: a discarded attempt commits
    # nothing
    assert np.array_equal(bits_t.numpy().view(np.uint32), bits)
    assert (np.asarray(bj) != bits).any() and (bits >> 31).any()


# --- device_extract, field by field ----------------------------------------------

_U64_FIELDS = {"key_lo", "key_hi", "vecs", "minim_hash", "keys", "mh"}


def _assert_out_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        if name == "fstate":
            continue
        g = got[name]
        g = u64.to_numpy(g) if name in _U64_FIELDS else g.numpy()
        assert np.array_equal(g, np.asarray(w)), name


def _tables(kind, l):
    """Scheme tables as numpy arrays in the JAX layout."""
    rng = np.random.default_rng(17)
    if kind == "lmer":
        keys = np.unique(rng.integers(0, 1 << (3 * l), 4000,
                                      dtype=np.uint64))
        vals = rng.integers(0, 1 << 40, keys.size, dtype=np.uint64)
        return [keys, vals]
    if kind == "bloom":
        return [rng.integers(0, 1 << 32, 1 << 8,
                             dtype=np.uint64).astype(np.uint32)]
    pre = np.sort(rng.integers(0, 1 << 63, 50, dtype=np.uint64))
    return [pre, np.full(64, ONES, dtype=np.uint64),
            np.full(4096, ONES, dtype=np.uint64)]


def _to_torch_tables(kind, tabs):
    if kind == "bloom":
        return [torch.from_numpy(tabs[0].view(np.int32).copy())]
    return [_t64(t) for t in tabs]


# (L, already_hpc, ref_cuts, scheme keywords, tables): the flat and the
# two-level compaction branch; raw reads with the extent column, pre-HPC'd
# ones and reference cuts without it; syncmers; the lmer remap on l-mers
# that really occur; both filters
EXTRACT_CASES = [
    (1024, False, False, {}, None),
    (3072, False, False, {}, None),
    (1024, True, False, {}, None),
    (1024, False, True, {}, None),
    (1024, False, False, dict(syncmer=(4, int(0.2 * 4 ** 10))), None),
    (1024, True, False, dict(syncmer=(4, int(0.2 * 4 ** 10))), None),
    (1024, False, False, dict(filter_mode="uhs"), "exact"),
    (1024, False, False, dict(filter_mode="lcp", filter_bloom=True), "bloom"),
    (1024, False, False, dict(lmer=True), "lmer"),
]


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("L,already_hpc,ref_cuts,kw,tabkind", EXTRACT_CASES)
def test_device_extract_matches_jax(L, already_hpc, ref_cuts, kw, tabkind,
                                    compact):
    from rust_mdbg_tpu_torch.ops.hpc import hpc
    from rust_mdbg_tpu_torch.ops.kernels import nthash_select_plain

    l, k = 10, 5
    codes, lengths = _codes(L + 3, B=8, L=L, hp=0.0 if already_hpc else 0.3)
    p = Params(k=k, l=l, density=0.3 if tabkind == "lmer" else 0.04)
    tabs = _tables(tabkind, l) if tabkind else []
    hc, _pm, hl = hpc(torch.from_numpy(codes), torch.from_numpy(lengths))
    if tabkind == "lmer":
        # keys that occur: the packed HPC-space l-mers of half the positions
        keys = np.unique(u64.to_numpy(xt._packed_lmers(hc, l))[:, ::2])
        tabs = [keys, np.arange(keys.size, dtype=np.uint64) * np.uint64(977)]
    if tabkind == "exact":
        # a preload that hits: half of the hashes the reads really select
        canon, sel = nthash_select_plain(hc, l, p.hash_bound, hl)
        tabs[0] = np.unique(u64.to_numpy(canon[sel]))[::2]
    common = dict(l=l, k=k, hash_bound=p.hash_bound, M=128,
                  already_hpc=already_hpc, compact_output=compact,
                  ref_cuts=ref_cuts, **kw)
    want = jax.jit(functools.partial(xj._device_extract, **common))(
        jnp.asarray(codes), jnp.asarray(lengths),
        *(jnp.asarray(t) for t in tabs))
    got = xt.device_extract(torch.from_numpy(codes),
                            torch.from_numpy(lengths),
                            *_to_torch_tables(tabkind, tabs), **common)
    _assert_out_equal(got, want)
    if "fstate" in want:
        ws, wn, wo = want["fstate"]
        gs, gn, go = got["fstate"]
        gs = (gs.numpy().view(np.uint32) if tabkind == "bloom"
              else u64.to_numpy(gs))
        assert np.array_equal(gs, np.asarray(ws))
        assert int(gn) == int(wn) and bool(go) == bool(wo)
    valid = (got["meta"][..., 1] >> 31) > 0 if compact else got["valid_w"]
    assert valid.any()
    if compact:
        # the extent column exists exactly for raw reads outside the
        # filter quirk and reference cuts
        assert got["meta"].shape[-1] == 4 + (
            not (already_hpc or ref_cuts or "filter_mode" in kw))


def test_count_output_under_syncmers_matches_jax():
    codes, lengths = _codes(77, B=8, L=1024, hp=0.3)
    common = dict(l=10, k=5, hash_bound=0, M=128, already_hpc=False,
                  count_output=True, syncmer=(4, int(0.2 * 4 ** 10)))
    want = jax.jit(functools.partial(xj._device_extract, **common))(
        jnp.asarray(codes), jnp.asarray(lengths))
    got = xt.device_extract(torch.from_numpy(codes),
                            torch.from_numpy(lengths), **common)
    _assert_out_equal(got, want)
    assert int(got["nw"].sum()) > 0


# --- the extractor, batch by batch ------------------------------------------------

def _synth_fasta(path, seed, n_reads=48, length=1500, with_n=False):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n_reads):
            seq = bases[rng.integers(0, 4, length)].copy()
            # homopolymer runs, so that raw and HPC coordinates differ
            for j in rng.integers(1, length, length // 6):
                seq[j] = seq[j - 1]
            if with_n and i % 3 == 0:
                seq[rng.integers(0, length, 5)] = ord("N")
            f.write(b">r%d\n" % i + seq.tobytes() + b"\n")
    return path


def _lmer_file(path, seed, l, n=400):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            f.write("".join("ACGT"[j] for j in rng.integers(0, 4, l)) + "\n")
    return str(path)


def _counts(reads, l, step):
    from rust_mdbg_tpu_torch.ops.hpc import encode_rle_np

    batch = next(iter(fastx.batches(reads, 16, 2048)))
    counts = {}
    for row in range(batch.codes.shape[0]):
        # l-mers of the HPC'd read: the space the minimizers are hashed in
        cd, _ = encode_rle_np(batch.codes[row, : batch.lengths[row]])
        for i in range(0, len(cd) - l, step):
            counts[decode_bases(cd[i : i + l])] = 50
    for s in sorted(counts)[::5]:
        counts[s] = 10 ** 6  # above lmer_counts_max: skipped
    return counts


def assert_wb_equal(a, b):
    for f in ("key_lo", "key_hi", "seqlen", "shift0", "shift1", "read_row",
              "start", "end", "seq_shift0", "seq_shift1", "reversed_",
              "vecs"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert len(a.minimizers) == len(b.minimizers)
    for ma, mb in zip(a.minimizers, b.minimizers):
        assert (ma is None) == (mb is None)
        if ma is not None:
            assert np.array_equal(ma[0], mb[0])
            assert np.array_equal(ma[1], mb[1])


def _scheme_setup(tmp_path, scheme):
    """(reads, Params keywords, attribute paths, with m2i)."""
    with_n = scheme in ("lcp", "lcp_bf", "lmer")
    reads = _synth_fasta(str(tmp_path / "r.fa"), 7, with_n=with_n)
    kw = dict(k=4, l=10, density=0.05)
    paths = {}
    if scheme in ("uhs", "uhs_bf", "lmer_uhs", "uhs_tiny_m"):
        kw["uhs"] = True
        paths["_uhs_path"] = _lmer_file(tmp_path / "u.txt", 1, 10)
    if scheme in ("lcp", "lcp_bf"):
        kw.update(lcp=True, l=9, density=0.08)
        paths["_lcp_path"] = _lmer_file(tmp_path / "c.txt", 2, 9, n=60)
    if scheme.endswith("_bf"):
        # a small filter, so that false positives occur and must match
        kw.update(use_bf=True, bloom_log2_bits=16)
    if scheme in ("lmer", "lmer_uhs", "lmer_tiny_m"):
        kw.update(has_lmer_counts=True, density=0.3)
    if scheme.endswith("tiny_m"):
        kw["max_minimizers_per_read"] = 16
    if scheme == "syncmers":
        kw.update(use_syncmers=True, s=4, density=0.2)
    return reads, kw, paths


def _extractors(reads, kw, paths):
    """The JAX extractor, the port's, and a fresh host engine's filters,
    each with its own filter instances (they are stateful)."""
    pj, pt = ParamsJ(engine="device", **kw), Params(engine="device", **kw)
    m2i = None
    if kw.get("has_lmer_counts"):
        m2i, _, _ = minimizers_preparation(pt, _counts(reads, kw["l"], 7))
        assert m2i

    def filters():
        u = c = None
        if "_uhs_path" in paths:
            u = uhs_preparation(pt, paths["_uhs_path"])
        if "_lcp_path" in paths:
            c = lcp_preparation(pt, paths["_lcp_path"])
        return u, c

    dj = xj.make_device_extractor(pj, m2i, *filters())
    dt = xt.make_device_extractor(pt, "cpu", m2i, *filters())
    return pj, pt, m2i, dj, dt, filters()


SCHEMES = ["density", "syncmers", "uhs", "lcp", "lmer", "lmer_uhs", "uhs_bf",
           "lcp_bf", "uhs_tiny_m", "lmer_tiny_m"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_extractor_matches_jax_over_three_batches(tmp_path, scheme):
    reads, kw, paths = _scheme_setup(tmp_path, scheme)
    pj, pt, m2i, dj, dt, (uh, lc) = _extractors(reads, kw, paths)
    n = 0
    for bj, bt in zip(fastx_jax.batches(reads, 16, 2048),
                      fastx.batches(reads, 16, 2048)):
        wj, wt = dj(bj), dt(bt)
        assert_wb_equal(wj, wt)
        # and the port's own host engine on the same stream
        assert_wb_equal(extract_windows_host(bt, pt, m2i, uh, lc), wt)
        n += wt.n_windows
    assert n > 0
    if scheme.endswith("tiny_m") and not kw.get("uhs"):
        assert dt.stats["host_rows"] > 0  # overflow rows re-extracted
    if kw.get("uhs") or kw.get("lcp"):
        assert dt.filter_fill() > 0
        sj, st = _jax_state(dj), dt.filter_state_to_numpy()
        for name, w in sj.items():
            assert np.array_equal(st[name], w), name


def _jax_state(dj) -> dict:
    """The JAX extractor's scheme state as numpy arrays."""
    st = {}
    if dj._lmer is not None:
        st.update(lmer_keys=np.asarray(dj._lmer[0]),
                  lmer_vals=np.asarray(dj._lmer[1]))
    if dj._filter_bloom:
        st["bits"] = np.asarray(dj._bits)
    elif dj.filter_mode is not None:
        st.update(preload=np.asarray(dj._preload), seen=np.asarray(dj._seen),
                  seen_n=dj.seen_n, delta=np.asarray(dj._delta),
                  delta_n=dj.delta_n)
    return st


@pytest.mark.parametrize("scheme", ["uhs", "lcp_bf", "lmer_uhs"])
def test_filter_state_hand_over(tmp_path, scheme):
    """Batches 1..2 through the JAX extractor, its state moved into a fresh
    port extractor, batch 3 must agree (and differ from a cold start)."""
    reads, kw, paths = _scheme_setup(tmp_path, scheme)
    _pj, _pt, _m2i, dj, dt, _f = _extractors(reads, kw, paths)
    bj = list(fastx_jax.batches(reads, 16, 2048))
    bt = list(fastx.batches(reads, 16, 2048))
    for b in bj[:2]:
        dj(b)
    cold = dt(bt[2])
    _pj, _pt, _m2i, _dj, dt2, _f = _extractors(reads, kw, paths)
    dt2.filter_state_from_numpy(_jax_state(dj))
    want, got = dj(bj[2]), dt2(bt[2])
    assert_wb_equal(want, got)
    assert got.n_windows != cold.n_windows
    back = dt2.filter_state_to_numpy()
    for name, w in _jax_state(dj).items():
        assert np.array_equal(back[name], w), name


def test_compact_path_matches_full_path(tmp_path):
    """extract_compact's CompactWindows = the WindowBatch of __call__, raw
    reads (the extent column) and pre-HPC'd, and the vectors it gathers."""
    reads = _synth_fasta(str(tmp_path / "r.fa"), 9)
    for hpc_in in (False, True):
        p = Params(k=4, l=10, density=0.05, reads_already_hpc=hpc_in)
        pj = ParamsJ(k=4, l=10, density=0.05, reads_already_hpc=hpc_in)
        dt, dj = xt.DeviceExtractor(p, "cpu"), xj.DeviceExtractor(pj)
        for bj, bt in zip(fastx_jax.batches(reads, 16, 2048),
                          fastx.batches(reads, 16, 2048)):
            cw, wb, cj = dt.extract_compact(bt), dt(bt), dj.extract_compact(bj)
            assert type(cw) is xt.CompactWindows and cw.n_windows > 0
            for f in ("key_lo", "key_hi", "seqlen", "shift0", "shift1",
                      "reversed_", "read_row", "start", "end", "seq_shift0",
                      "seq_shift1"):
                assert np.array_equal(getattr(cw, f), getattr(wb, f)), f
                assert np.array_equal(getattr(cw, f), getattr(cj, f)), f
            idx = np.arange(0, cw.n_windows, 3)
            assert np.array_equal(cw.vecs_for(idx), wb.vecs[idx])
            assert cw.vecs_for(idx[:0]).shape == (0, 4)


def test_forced_delta_merge(tmp_path):
    """A delta overflow forces the merge-into-base-and-retry path; results
    still match the host oracle and the JAX extractor, and the discarded
    attempt committed nothing (the state equals the JAX extractor's)."""
    reads = _synth_fasta(str(tmp_path / "r.fa"), 23, n_reads=32, length=2000)
    kw = dict(k=4, l=13, density=0.1, lcp=True)
    pt, pj = Params(engine="device", **kw), ParamsJ(engine="device", **kw)
    dt = xt.make_device_extractor(pt, "cpu", None, None, CheckAndAddFilter())
    dj = xj.make_device_extractor(pj, None, None, CheckAndAddFilter())
    # a base of 128 and a delta of 2048: batch 0 doubles the empty delta
    # until its inserts fit, batch 1 overflows the committed one
    dt._seen_cap, dt._seen = 128, dt._pad(128)
    dt._delta_cap, dt._delta = 2048, dt._pad(2048)
    dj._seen_cap = 128
    dj._seen = jnp.full((128,), ONES, dtype=jnp.uint64)
    dj._delta_cap = 2048
    dj._delta = jnp.full((2048,), ONES, dtype=jnp.uint64)
    host_f = CheckAndAddFilter()
    for bj, bt in zip(fastx_jax.batches(reads, 16, 4096),
                      fastx.batches(reads, 16, 4096)):
        wt = dt(bt)
        assert_wb_equal(extract_windows_host(bt, pt, None, None, host_f), wt)
        assert_wb_equal(dj(bj), wt)
    assert dt.seen_n > 0 and dt._seen_cap > 128
    assert (dt.seen_n, dt.delta_n) == (dj.seen_n, dj.delta_n)
    st = dt.filter_state_to_numpy()
    assert np.array_equal(st["seen"], np.asarray(dj._seen))
    assert np.array_equal(st["delta"], np.asarray(dj._delta))
    assert dt.filter_fill() == len(host_f._set)


@pytest.mark.parametrize("already_hpc", [False, True])
def test_tiled_minimizers_match_jax_and_host(already_hpc):
    """extract_minimizers_tiled at tile = 2^16 over a 300 kbp sequence with
    homopolymer runs and N: five tiles with halos = the JAX function = the
    host oracle."""
    rng = np.random.default_rng(3)
    n = 300_000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    rep = rng.random(n) < 0.3
    for j in range(1, n):
        if rep[j]:
            codes[j] = codes[j - 1]
    codes[rng.integers(0, n, 40)] = 4
    kw = dict(k=5, l=12, density=0.01, reads_already_hpc=already_hpc)
    pt, pj = Params(**kw), ParamsJ(**kw)
    dt, dj = xt.DeviceExtractor(pt, "cpu"), xj.DeviceExtractor(pj)
    pos, hashes = xt.extract_minimizers_tiled(codes, pt, dt, tile=1 << 16)
    pos_j, hashes_j = xj.extract_minimizers_tiled(codes, pj, dj,
                                                  tile=1 << 16)
    pos_h, hashes_h = extract_density_np(codes, 12, pt.hash_bound,
                                         already_hpc=already_hpc)
    assert pos.dtype == np.int64 and hashes.dtype == np.uint64
    assert np.array_equal(pos, pos_j) and np.array_equal(hashes, hashes_j)
    assert np.array_equal(pos, pos_h) and np.array_equal(hashes, hashes_h)
    assert len(pos) > 1000


def test_tile_overflow_takes_the_host_row_and_is_counted(monkeypatch):
    """A tile that selects more than its capacity raises TileOverflow;
    _extract_long then extracts that row on the host, exactly, and counts
    it."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, (1, 70_000)).astype(np.uint8)
    p = Params(k=5, l=12, density=0.01, reads_already_hpc=True)
    dt = xt.DeviceExtractor(p, "cpu")
    monkeypatch.setattr(xt, "LONG_SEQ_MIN", 1 << 16)
    monkeypatch.setattr(xt, "TILE_DEFAULT", 1 << 14)
    batch = fastx.ReadBatch(codes, np.array([70_000], dtype=np.int32),
                            ["g"], [b""], 0)
    want = extract_windows_host(batch, p)
    assert_wb_equal(want, dt(batch))
    assert dt.stats == dict(host_rows=0, tiled_rows=1, tile_host_rows=0)
    monkeypatch.setattr(xt, "capacity", lambda *a, **k: 40)
    with pytest.raises(xt.TileOverflow):
        xt.extract_minimizers_tiled(codes[0], p, dt, tile=1 << 14)
    assert_wb_equal(want, dt(batch))
    assert dt.stats == dict(host_rows=0, tiled_rows=2, tile_host_rows=1)


def test_make_device_extractor_refusals():
    p = Params(k=4, l=10, density=0.05)
    with pytest.raises(NotImplementedError, match="error-correction"):
        xt.make_device_extractor(p.replace(error_correct=True), "cpu")
    with pytest.raises(NotImplementedError, match="l <= 21"):
        xt.make_device_extractor(p.replace(has_lmer_counts=True, l=22),
                                 "cpu", {"A" * 22: 1})
    with pytest.raises(NotImplementedError, match="not prepared"):
        xt.make_device_extractor(p.replace(uhs=True), "cpu")
    dt = xt.make_device_extractor(p.replace(uhs=True), "cpu", None,
                                  CheckAndAddFilter())
    with pytest.raises(RuntimeError, match="filter state"):
        dt.extract_device(torch.zeros((1, 64), dtype=torch.uint8),
                          torch.zeros(1, dtype=torch.int32))
