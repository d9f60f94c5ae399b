"""Port parity: the error-correction scorer and the POA DP.

The plain torch forms that the CUDA kernels are held against on the card
must equal the JAX package's: the triage scorer (`semiglobal_scores`)
against the numpy twin `_scores_np` and the jitted scan, the batched POA
DP (`poa_dp`) against `poa_semiglobal_device` (JAX CPU backend) and
`PoaGraph.semiglobal`, on graphs grown by weaving.  Inputs come from numpy
with fixed seeds; every comparison is exact.  The kernels themselves have
no CPU form: their tests are marked `cuda` and skip here.
"""

import numpy as np
import pytest
import torch

from rust_mdbg_tpu.models.poa import PoaGraph as JaxPoaGraph
from rust_mdbg_tpu.ops import align as jax_align
from rust_mdbg_tpu.ops.poa_device import \
    poa_semiglobal_device as jax_poa_device
from rust_mdbg_tpu_torch.models.poa import PoaGraph
from rust_mdbg_tpu_torch.ops import align, kernels, poa_device, u64

torch.set_num_threads(2)


def _scores_inputs(seed):
    """A template and ragged queries over a small alphabet (many ties),
    with the edge cases T = 1, Q = 1, an empty query and queries longer
    than the template."""
    rng = np.random.default_rng(seed)
    T = [1, 7, 60, 130][seed % 4]
    template = [int(x) for x in rng.integers(0, 9, T)]
    lens = list(rng.integers(0, 2 * T + 3, 14)) + [1, 0, 2 * T + 5]
    queries = [[int(x) for x in rng.integers(0, 9, int(n))] for n in lens]
    # a near copy of a template stretch, so real alignments occur
    queries.append(template[T // 3 :] + [3, 4])
    return template, queries


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scores_plain_matches_numpy_twin_and_jax_scan(seed):
    template, queries = _scores_inputs(seed)
    got = align.semiglobal_scores_batch(template, queries, device="cpu")
    qs, qlens = align.pad_queries(queries)
    twin = jax_align._scores_np(np.asarray(template, dtype=np.uint64), qs,
                                qlens, -1, 1, -1)
    cut = jax_align._NP_CUTOFF
    try:
        jax_align._NP_CUTOFF = 0  # force the jitted scan
        scan = jax_align.semiglobal_scores_batch(template, queries)
    finally:
        jax_align._NP_CUTOFF = cut
    assert got.dtype == np.int32
    assert np.array_equal(got, twin)
    assert np.array_equal(got, scan)
    assert kernels.semiglobal_scores.launches == 0  # CPU tensors: no launch


def test_scores_match_poa_graph_on_linear_template():
    """The triage score is the POA semiglobal score of the linear
    template (tests/test_poa.py's model), u64 symbols included."""
    rng = np.random.default_rng(8)
    alphabet = [int(x) for x in rng.integers(1, 1 << 63, 50,
                                             dtype=np.uint64)]
    template = [alphabet[i] for i in rng.integers(0, 50, 40)]
    g = PoaGraph(template, "A" * 420, [i * 10 for i in range(40)])
    queries = []
    for _ in range(6):
        q = list(template[5:30])
        for _ in range(3):
            q[int(rng.integers(0, len(q)))] = alphabet[int(rng.integers(50))]
        queries.append(q)
    queries += [template[::-1][:20], template[3:9] * 3]
    got = align.semiglobal_scores_batch(template, queries, device="cpu")
    assert [int(x) for x in got] == [g.semiglobal(q).score for q in queries]


def test_scores_numpy_twin_under_force_np(monkeypatch):
    """device=None (what the forked --ec-procs workers pass) takes the
    numpy twin, which reaches no torch form and gives the same scores; no
    environment setting forces it, so the JAX package's
    MDBG_ALIGN_FORCE_NP leaves a device's call on the wrapper."""
    template, queries = _scores_inputs(2)
    want = align.semiglobal_scores_batch(template, queries, device="cpu")
    monkeypatch.setenv("MDBG_ALIGN_FORCE_NP", "1")
    calls = []
    wrapper = kernels.semiglobal_scores
    monkeypatch.setattr(kernels, "semiglobal_scores",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    again = align.semiglobal_scores_batch(template, queries, device="cpu")
    assert calls == [1] and np.array_equal(again, want)
    monkeypatch.setattr(kernels, "semiglobal_scores", None)
    got = align.semiglobal_scores_batch(template, queries, device=None)
    assert np.array_equal(got, want)


def _mut(rng, seq, alphabet, p_sub=0.15, p_ind=0.08):
    out = []
    for x in seq:
        r = rng.random()
        if r < p_sub:
            out.append(int(alphabet[rng.integers(len(alphabet))]))
        elif r < p_sub + p_ind / 2:
            continue
        elif r < p_sub + p_ind:
            out.append(int(x))
            out.append(int(alphabet[rng.integers(len(alphabet))]))
        else:
            out.append(int(x))
    return out or [int(alphabet[0])]


def _grow(cls, rng, alphabet, tlen, n_weave, hub=False):
    """A template graph of class `cls` (the port's or the JAX package's
    PoaGraph) grown by weaving mutated copies (tests/test_poa_device.py's
    recipe); `hub` also weaves queries that all end in one symbol, so a
    node collects many predecessors."""
    template = [int(alphabet[rng.integers(len(alphabet))])
                for _ in range(tlen)]
    g = cls(template, "A" * (4 * tlen + 8), list(range(0, 4 * tlen, 4)))
    for w in range(n_weave):
        q = _mut(rng, template, alphabet)
        if hub:
            q = [int(alphabet[rng.integers(len(alphabet))])
                 for _ in range(3)] + [int(alphabet[w % 3])] + q[-2:]
        aln = g.semiglobal(q)
        g.add_alignment(aln, q, "C" * (4 * len(q) + 8),
                        list(range(0, 4 * len(q), 4)))
    return g, template


def _twin_graphs(seed, trials, **kw):
    """The same grown graphs as the port's and as the JAX package's
    PoaGraph (same seed), with one query each."""
    out = []
    for cls in (PoaGraph, JaxPoaGraph):
        rng = np.random.default_rng(seed)
        alphabet = rng.integers(1, 1 << 60, 40).astype(np.uint64)
        gs, qs = [], []
        for _ in range(trials):
            tlen = int(rng.integers(4, 60))
            g, template = _grow(cls, rng, alphabet, tlen,
                                int(rng.integers(0, 6)), **kw)
            gs.append(g)
            qs.append(_mut(rng, template, alphabet))
        out.append((gs, qs))
    return out


def _triple(a):
    return a.score, a.ystart, a.operations


@pytest.mark.parametrize("seed", [3, 17])
def test_poa_dp_plain_matches_jax_and_host(seed):
    (gs, qs), (jgs, jqs) = _twin_graphs(seed, 24)
    assert qs == jqs
    got = poa_device.poa_semiglobal_device(gs, qs, device="cpu")
    want_jax = jax_poa_device(jgs, jqs)
    for g, q, a, b in zip(gs, qs, got, want_jax):
        assert _triple(a) == _triple(b) == _triple(g.semiglobal(q))
    assert kernels.poa_dp.launches == 0


def test_poa_dp_plain_edge_shapes():
    """A one-node graph, B = 1, a one-symbol query, in-degree above 8 (the
    JAX lockstep's host fall-back case), a query longer than its graph."""
    rng = np.random.default_rng(5)
    alphabet = rng.integers(1, 1 << 60, 12).astype(np.uint64)
    one = PoaGraph([int(alphabet[0])], "ACGT", [0])
    for q in ([int(alphabet[0])], [int(alphabet[1])],
              [int(alphabet[0])] * 5):
        (a,) = poa_device.poa_semiglobal_device([one], [q], device="cpu")
        assert _triple(a) == _triple(one.semiglobal(q))
    hub, template = _grow(PoaGraph, rng, alphabet, 12, 40, hub=True)
    assert max(len(p) for p in hub.pred) > 8
    qs = [_mut(rng, template, alphabet) for _ in range(3)] + [template * 3]
    got = poa_device.poa_semiglobal_device([hub] * len(qs), qs,
                                           device="cpu")
    for q, a in zip(qs, got):
        assert _triple(a) == _triple(hub.semiglobal(q))


def test_export_batch_layout():
    g = PoaGraph([7, 8, 9], "AAAAAAAAAA", [0, 3, 6])
    g.add_alignment(g.semiglobal([7, 5, 9]), [7, 5, 9], "CCCCCCCCCC",
                    [0, 3, 6])
    b = poa_device.export_batch([g, g], [[7, 5, 9], [9]])
    assert b["node_off"].tolist() == [0, 4, 8]
    assert b["q_off"].tolist() == [0, 3, 4]
    assert b["wts"].tolist() == [7, 8, 9, 5] * 2
    # node 2 (9) has two predecessors (8, then the woven 5)
    assert b["pred_off"].tolist() == [0, 0, 1, 3, 4, 4, 5, 7, 8]
    assert b["pred_idx"].tolist() == [0, 1, 3, 0] * 2
    assert b["term"].tolist() == [0, 0, 1, 0] * 2
    off = poa_device.ops_offsets(torch.from_numpy(b["node_off"]),
                                 torch.from_numpy(b["q_off"]))
    assert off.tolist() == [0, 8, 14]


def test_kernel_wrappers_refuse_bad_cuda_input():
    """Off the CPU the wrappers launch or raise; the device and dtype
    checks come before the build, so they show here."""
    meta = torch.device("meta")
    t = torch.empty(4, dtype=torch.int64, device=meta)
    q = torch.empty((2, 3), dtype=torch.int64, device=meta)
    n = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.semiglobal_scores(t, q, n)
    i32 = torch.empty(3, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.poa_dp(i32, t, i32, i32, i32,
                       torch.empty(4, dtype=torch.uint8, device=meta), i32,
                       t)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
def test_semiglobal_scores_kernel_matches_plain_on_the_card():
    """csrc/semiglobal_scores.cu = its plain version (run with `pytest -m
    cuda` on a machine with a GPU and nvcc); a long query takes the
    global-row path."""
    _cuda_or_skip()
    cases = [_scores_inputs(s) for s in range(4)]
    cases.append(([5] * 40, [[5] * 13000, [5, 6] * 3000]))
    for template, queries in cases:
        qs, qlens = align.pad_queries(queries)
        args = (u64.from_numpy(np.asarray(template, dtype=np.uint64),
                               "cuda"),
                u64.from_numpy(qs, "cuda"),
                torch.from_numpy(qlens.astype(np.int32)).cuda())
        before = kernels.semiglobal_scores.launches
        got = kernels.semiglobal_scores(*args)
        assert kernels.semiglobal_scores.launches == before + 1
        assert torch.equal(got, align.semiglobal_scores_plain(*args))


@pytest.mark.cuda
def test_poa_dp_kernel_matches_plain_on_the_card():
    """csrc/poa_dp.cu = its plain version, every output (run with `pytest
    -m cuda` on a machine with a GPU and nvcc)."""
    _cuda_or_skip()
    (gs, qs), _ = _twin_graphs(3, 24)
    rng = np.random.default_rng(5)
    alphabet = rng.integers(1, 1 << 60, 12).astype(np.uint64)
    hub, template = _grow(PoaGraph, rng, alphabet, 12, 40, hub=True)
    one = PoaGraph([int(alphabet[0])], "ACGT", [0])
    for batch in ((gs, qs), ([hub, one], [template * 30, [7]]),
                  ([one], [[int(alphabet[0])]])):
        t = poa_device.batch_to_device(poa_device.export_batch(*batch),
                                       "cuda")
        args = [t[k] for k in ("node_off", "wts", "topo", "pred_off",
                               "pred_idx", "term", "q_off", "queries")]
        before = kernels.poa_dp.launches
        got = kernels.poa_dp(*args)
        assert kernels.poa_dp.launches == before + 1
        want = poa_device.poa_dp_plain(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
