"""Port parity for --bf: the device Bloom screen `bloom_pass` against a
sequential model and against the JAX `_bloom_pass`; the whole-run --bf path
against the port's host NodeTable(use_bf=True) fed in stream order and
against the JAX whole-run path; chunked --bf against the JAX chunked
driver.  All comparisons are exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_mdbg_tpu.core.chunked import assemble_device_chunked as jax_chunked
from rust_mdbg_tpu.core.pipeline import assemble_device_table as jax_table
from rust_mdbg_tpu.ops.sort_count import _bloom_pass
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu.utils.timing import PhaseTimer
from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
from rust_mdbg_tpu_torch.core.nodetable import NodeTable
from rust_mdbg_tpu_torch.core.pipeline import assemble_device_table
from rust_mdbg_tpu_torch.ops import u64
from rust_mdbg_tpu_torch.ops.extract import capacity, extract_count
from rust_mdbg_tpu_torch.ops.sort_count import (
    DeviceNodeCounter, bloom_pass, construct_batches, gather_window_meta,
    window_slot_capacity)
from rust_mdbg_tpu_torch.params import Params

from torch_corpus import gfa_bytes, records, write_hpc_reads, write_raw_reads

# the suite runs in several worker processes on one machine: a small
# intra-op pool per process keeps them from oversubscribing its cores
torch.set_num_threads(2)

MUL = 0x9E3779B97F4A7C15


def _model(lo, hi, valid, bitset):
    """The host table's filter, one window after the other: a window keeps
    iff its bit is set already; every valid window sets its bit."""
    mask = len(bitset) - 1
    keep = np.zeros(len(lo), dtype=bool)
    for i in range(len(lo)):
        if valid[i]:
            bit = (int(lo[i]) ^ ((int(hi[i]) * MUL) & (2**64 - 1))) & mask
            keep[i] = bitset[bit]
            bitset[bit] = True
    return keep


def _words(bitset):
    return np.packbits(bitset.reshape(-1, 32), axis=1, bitorder="little") \
        .view(np.uint32).ravel()


def _batches(seed, n_batches, n, distinct, last_invalid=False):
    """Batches of n keys drawn from `distinct` values (heavily duplicated
    when distinct << n), a fifth of the rows invalid."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 64, (distinct, 2), dtype=np.uint64)
    for _ in range(n_batches):
        k = pool[rng.integers(0, distinct, n)]
        valid = rng.random(n) < 0.8
        if last_invalid:
            valid[-1] = False
        yield k[:, 0].copy(), k[:, 1].copy(), valid


@pytest.mark.parametrize("distinct,log2_bits", [(100_000, 16), (40, 12),
                                                (3000, 10), (1, 5)])
def test_bloom_pass_matches_sequential_model(distinct, log2_bits):
    """Random keys, heavily duplicated keys, a filter that fills up (many
    false positives) and a single key; the words carry over three
    batches."""
    bitset = np.zeros(1 << log2_bits, dtype=bool)
    bits = torch.zeros((1 << log2_bits) // 32, dtype=torch.int32)
    kept = 0
    for lo, hi, valid in _batches(log2_bits, 3, 5000, distinct):
        want = _model(lo, hi, valid, bitset)
        got = bloom_pass(u64.from_numpy(lo, "cpu"), u64.from_numpy(hi, "cpu"),
                         torch.from_numpy(valid), bits)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(bits.numpy().view(np.uint32), _words(bitset))
        kept += int(want.sum())
    assert 0 < kept < 3 * 5000
    if log2_bits == 5:
        assert bits.count_nonzero() == 1
    if log2_bits == 10:   # the top bit of a word is set: int32 sign bit
        assert (bits < 0).any()


@pytest.mark.parametrize("distinct", [100_000, 40])
def test_bloom_pass_matches_jax(distinct):
    """Against the JAX screen on batches whose last row is invalid (its
    scatter of padding rows to row N-1 cannot change a valid row there)."""
    jfn = jax.jit(_bloom_pass)
    jbits = jnp.zeros((1 << 14) // 32, dtype=jnp.uint32)
    bits = torch.zeros((1 << 14) // 32, dtype=torch.int32)
    for lo, hi, valid in _batches(distinct, 3, 4096, distinct,
                                  last_invalid=True):
        jkeep, jbits = jfn(jnp.asarray(lo), jnp.asarray(hi),
                           jnp.asarray(valid), jbits)
        keep = bloom_pass(u64.from_numpy(lo, "cpu"),
                          u64.from_numpy(hi, "cpu"), torch.from_numpy(valid),
                          bits)
        assert np.array_equal(np.asarray(jkeep), keep.numpy())
        assert np.array_equal(np.asarray(jbits),
                              bits.numpy().view(np.uint32))
    assert keep.any() and not keep.all()


@pytest.mark.parametrize("minab,log2_bits", [(2, 24), (2, 11), (3, 11),
                                             (17, 24)])
def test_device_bf_matches_host_table(minab, log2_bits):
    """The whole-run counter under --bf against the host table fed the same
    windows in stream order: the same keys pass with the same abundance and
    the same crossing sighting (seqlen, shifts), also where a small filter
    gives many false positives."""
    B, L, NB = 16, 1024, 6
    p = Params(k=5, l=9, density=0.03, min_kmer_abundance=minab,
               batch_reads=B, use_bf=True, bloom_log2_bits=log2_bits)
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 2500).astype(np.uint8)
    starts = rng.integers(0, 2500 - L, B * NB)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    codes[rng.random(codes.shape) < 0.002] = 1
    lengths = rng.integers(L // 2, L + 1, B * NB).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    M = capacity(p, L)
    W = M - p.k + 1
    ws = window_slot_capacity(p, B, L, M)

    c = DeviceNodeCounter(k=p.k, M=M, read_cap=B * NB, w_slot=ws,
                          chunk_slots=1, device="cpu", minab=minab,
                          use_bf=True, bloom_log2_bits=log2_bits)
    _n, n_over = construct_batches(
        p, torch.from_numpy(codes), torch.from_numpy(lengths), c.buffers,
        B=B, M=M, w_slot=ws, batch_lo=0, batch_hi=NB)
    assert int(n_over) == 0
    res = c.finalize()
    got = {(int(lo), int(hi)): (int(n), int(m[0]), int(m[1] & 0x7FFFFFFF),
                                int(m[2] & 0x7FFFFFFF))
           for lo, hi, n, m in zip(res["key_lo"], res["key_hi"],
                                   res["count"], res["meta"])}

    table = NodeTable(min_abundance=minab, use_bf=True,
                      bloom_log2_bits=log2_bits)
    for i in range(NB):
        r = slice(i * B, (i + 1) * B)
        out = extract_count(torch.from_numpy(codes[r]),
                            torch.from_numpy(lengths[r]), l=p.l, k=p.k,
                            hash_bound=p.hash_bound, M=M)
        rows, wins = torch.nonzero(
            torch.arange(W)[None, :] < out["nw"][:, None], as_tuple=True)
        keys = out["keys"][rows, wins]
        _vec, meta, _clip = gather_window_meta(out["mh"], out["mp"],
                                               rows * W + wins, k=p.k, M=M)
        meta = meta.numpy()
        table.add_batch(u64.to_numpy(keys[:, 0]), u64.to_numpy(keys[:, 1]),
                        meta[:, 0], meta[:, 1] & 0x7FFFFFFF,
                        meta[:, 2] & 0x7FFFFFFF)
    table.retain(minab)
    d = table.dump()
    want = {(int(lo), int(hi)): (int(a), int(s), int(s0), int(s1))
            for lo, hi, a, s, s0, s1 in zip(
                d["key_lo"], d["key_hi"], d["abundance"], d["seqlen"],
                d["shift0"], d["shift1"])}
    assert len(want) > (5 if minab == 17 else 50)
    assert got == want


KW = dict(k=7, l=12, density=0.01, min_kmer_abundance=2, use_bf=True,
          bloom_log2_bits=24)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf_corpus")
    raw = write_raw_reads(str(d / "raw.fa"))
    return dict(raw=raw, hpc=write_hpc_reads(raw, str(d / "hpc.fa")))


@pytest.mark.parametrize("kind", ["raw", "hpc"])
def test_whole_run_bf_matches_jax(tmp_path, corpora, kind):
    """Seven chunks of 16 batches of 4 reads; the pre-HPC run emits in two
    phases.  No Bloom slot differs here: bytes and records are equal."""
    extra = dict(reads_already_hpc=kind == "hpc", batch_reads=4)
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_table(corpora[kind], JaxParams(engine="device", **KW, **extra),
                   pj, PhaseTimer(), {})
    st = assemble_device_table(corpora[kind], Params(**KW, **extra), pt,
                               device="cpu")
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 100
    assert st["nb_edges"] == sj["nb_edges"] > 100
    assert st["nb_windows"] == sj["nb_windows"]
    assert st["nb_chunks"] >= 5
    assert (st["phase1_nodes"] > 0) == (kind == "hpc")


def test_bf_slot_frac_shrinks_the_slot_or_aborts(tmp_path, corpora,
                                                 monkeypatch):
    """MDBG_BF_SLOT_FRAC scales W_slot; a slot too small for the surviving
    windows never truncates: the run restarts at doubled slots (it no
    longer aborts) and writes the same bytes."""
    p = Params(reads_already_hpc=True, batch_reads=4, **KW)
    full = assemble_device_table(corpora["hpc"], p, str(tmp_path / "a"),
                                 device="cpu")
    monkeypatch.setenv("MDBG_BF_SLOT_FRAC", "0.9")
    st = assemble_device_table(corpora["hpc"], p, str(tmp_path / "b"),
                               device="cpu")
    assert st["w_slot"] < full["w_slot"] and st["replans"] == 0
    assert gfa_bytes(str(tmp_path / "a")) == gfa_bytes(str(tmp_path / "b"))
    monkeypatch.setenv("MDBG_BF_SLOT_FRAC", "0.05")
    st = assemble_device_table(corpora["hpc"], p, str(tmp_path / "c"),
                               device="cpu")
    assert st["replans"] >= 1
    assert gfa_bytes(str(tmp_path / "a")) == gfa_bytes(str(tmp_path / "c"))
    assert records(str(tmp_path / "a")) == records(str(tmp_path / "c"))


@pytest.mark.parametrize("kind,minab", [("raw", 2), ("hpc", 2), ("raw", 3)])
def test_chunked_bf_matches_jax(tmp_path, corpora, kind, minab):
    """Chunked --bf: the construct does not screen, the host merge's Bloom
    does."""
    kw = {**KW, "min_kmer_abundance": minab,
          "reads_already_hpc": kind == "hpc"}
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_chunked(corpora[kind], JaxParams(engine="device", **kw), pj,
                     chunk_reads=64)
    st = assemble_device_chunked(corpora[kind], Params(**kw), pt,
                                 chunk_reads=64, device="cpu")
    assert gfa_bytes(pj) == gfa_bytes(pt)
    assert records(pj) == records(pt)
    assert st["nb_nodes"] == sj["nb_nodes"] > 50
    assert st["nb_chunks"] == sj["nb_chunks"] > 1
