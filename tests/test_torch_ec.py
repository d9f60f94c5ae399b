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


#: the scorer's edge shapes: Q + 1 at each strip edge of the kernel (31,
#: 32, 33, 64, 65 columns, 32 x 16 = 512 and 513), T = 0, every qlen 0
SCORES_EDGES = [f"Q{q}" for q in (30, 31, 32, 63, 64, 511, 512)] + \
    ["T0", "qlen0"]


def _scores_inputs(seed):
    """A template and ragged queries over a small alphabet (many ties),
    with the edge cases T = 1, Q = 1, an empty query and queries longer
    than the template; or, for a name of SCORES_EDGES, that edge shape
    (the widest query exactly Q long, an empty one beside it)."""
    if isinstance(seed, str):
        rng = np.random.default_rng(len(seed) * 7 + ord(seed[-1]))
        T = 0 if seed == "T0" else 40
        template = [int(x) for x in rng.integers(0, 5, T)]
        if seed == "qlen0":
            return template, [[], []]
        q = 5 if seed == "T0" else int(seed[1:])
        lens = [q, q // 2, 0, 1, q]
        queries = [[int(x) for x in rng.integers(0, 5, n)] for n in lens]
        if T:
            queries[-1] = (template * (q // T + 1))[:q]
        return template, queries
    rng = np.random.default_rng(seed)
    T = [1, 7, 60, 130][seed % 4]
    template = [int(x) for x in rng.integers(0, 9, T)]
    lens = list(rng.integers(0, 2 * T + 3, 14)) + [1, 0, 2 * T + 5]
    queries = [[int(x) for x in rng.integers(0, 9, int(n))] for n in lens]
    # a near copy of a template stretch, so real alignments occur
    queries.append(template[T // 3 :] + [3, 4])
    return template, queries


@pytest.mark.parametrize("seed", [0, 1, 2, 3] + SCORES_EDGES)
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


#: the POA DP's edge shapes: m + 1 at each strip edge of the kernel (31,
#: 32, 33, 64, 65, 512, 513 columns), a one-node graph, a hub (in-degree
#: 0 at the sources and above 8 at the hub) and the widest pair of the
#: batch beside the smallest
POA_EDGES = [f"m{m}" for m in (30, 31, 32, 63, 64, 511, 512)] + \
    ["n1", "hub", "widest_with_smallest"]


def _twin_edge(case):
    """The graphs and queries of a POA_EDGES case, as the port's and as
    the JAX package's PoaGraph (same seed)."""
    out = []
    for cls in (PoaGraph, JaxPoaGraph):
        rng = np.random.default_rng(len(case) * 11 + ord(case[-1]))
        alphabet = rng.integers(1, 1 << 60, 40).astype(np.uint64)
        if case.startswith("m"):
            m = int(case[1:])
            g, t = _grow(cls, rng, alphabet, max(4, m), 3)
            gs = [g, g]
            qs = [(_mut(rng, t, alphabet) * 3)[:m], (t * 2)[:m]]
        elif case == "n1":
            one = cls([int(alphabet[0])], "ACGT", [0])
            gs = [one] * 3
            qs = [[int(alphabet[0])], [int(alphabet[1])],
                  [int(alphabet[0])] * 5]
        elif case == "hub":
            hub, t = _grow(cls, rng, alphabet[:12], 12, 40, hub=True)
            gs = [hub, hub]
            qs = [_mut(rng, t, alphabet[:12]), t * 3]
        else:
            big, t = _grow(cls, rng, alphabet, 300, 4)
            one = cls([int(alphabet[0])], "ACGT", [0])
            gs = [big, one, big]
            qs = [(t * 2)[:600], [int(alphabet[1])], _mut(rng, t, alphabet)]
        out.append((gs, qs))
    return out


@pytest.mark.parametrize("seed", [3, 17] + POA_EDGES)
def test_poa_dp_plain_matches_jax_and_host(seed):
    """The plain batched DP = the JAX package's device DP = the host DP,
    on 24 grown graphs a seed and on each edge shape."""
    (gs, qs), (jgs, jqs) = (_twin_graphs(seed, 24) if isinstance(seed, int)
                            else _twin_edge(seed))
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


@pytest.mark.parametrize("width, strip", [
    (1, 1), (31, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4),
    (129, 6), (192, 6), (193, 8), (256, 8), (257, 9), (288, 9), (289, 10),
    (320, 10), (321, 11), (352, 11), (353, 12), (384, 12), (385, 16),
    (512, 16), (513, 16), (5001, 16)])
def test_strip_for_covers_the_width(width, strip):
    """The narrowest strip whose 32 lanes cover the width; past 32 x 16
    columns the widest (register tiles)."""
    assert kernels.strip_for(width) == strip


@pytest.mark.parametrize("B, T, Q", [(16, 279, 281), (1, 0, 0), (3, 17, 5000),
                                     (160, 300, 300), (5, 40, 511),
                                     (5, 40, 512)])
def test_semiglobal_scores_plan(B, T, Q):
    """Queries a block (four, or B when fewer), blocks for all B, one
    register tile up to Q + 1 = 512 columns, and the boundary scratch (2 x
    (T + 1) ints a query) only past it."""
    plan = kernels.semiglobal_scores_plan(B, T, Q)
    assert plan["strip"] == kernels.strip_for(Q + 1)
    assert plan["warps"] == min(4, max(B, 1))
    assert plan["blocks"] * plan["warps"] >= B > (plan["blocks"] - 1) * \
        plan["warps"] or B == 0
    assert plan["tiles"] == -(-(Q + 1) // (32 * plan["strip"]))
    assert plan["scratch"] == (2 * (T + 1) * B if Q + 1 > 512 else 0)


@pytest.mark.parametrize("n_max, m_max, ring_rows, want", [
    # the lockstep leg's widest launch: a 16-row ring
    (330, 327, None, dict(strip=11, Wp=352, ring=16, far=True)),
    (330, 1500, None, dict(strip=16, Wp=1536, ring=16, far=True)),
    # rows too wide for 16 ring rows: the ring shrunk to the block's 227 KB
    (330, 4000, None, dict(strip=16, Wp=4096, ring=8, far=True)),
    (10, 40, None, dict(strip=2, Wp=64, ring=16, far=False)),
    (10, 200, None, dict(strip=8, Wp=256, ring=16, far=False)),
    (1200, 1500, 0, dict(strip=16, Wp=1536, ring=0, far=True)),
    (1200, 1500, 1, dict(strip=16, Wp=1536, ring=0, far=True)),
    (1200, 1500, 3, dict(strip=16, Wp=1536, ring=2, far=True)),
    (1, 0, None, dict(strip=1, Wp=32, ring=16, far=False)),
    # rows too wide for two ring rows: no ring
    (50, 60000, None, dict(strip=16, Wp=60416, ring=0, far=True)),
])
def test_poa_dp_plan(n_max, m_max, ring_rows, want):
    plan = kernels.poa_dp_plan(n_max, m_max, ring_rows)
    assert {k: plan[k] for k in want} == want
    assert plan["smem"] == kernels.POA_META_BYTES + \
        4 * plan["ring"] * plan["Wp"]
    assert plan["smem"] <= kernels.SMEM_PER_BLOCK


def test_poa_dp_plan_refuses_what_the_packed_word_cannot_hold():
    """pred + 1 sits above 2 bits of kind in an int32 word: n < 2^29."""
    kernels.poa_dp_plan((1 << 29) - 1, 10)
    for n in (0, 1 << 29):
        with pytest.raises(ValueError, match="2\\^29"):
            kernels.poa_dp_plan(n, 10)


def _route_walk(gs, qs, plan) -> list:
    """Predecessor reads by the route csrc/poa_dp.cu takes under `plan`,
    from a direct walk of the graphs: registers at topological distance 1
    (one register tile only), the ring below R, else global."""
    want = [0, 0, 0]
    for g, q in zip(gs, qs):
        rank = {v: i for i, v in enumerate(g.topo_order())}
        for v, preds in enumerate(g.pred):
            for p in preds:
                d = rank[v] - rank[p]
                if d == 1 and len(q) + 1 <= 32 * plan["strip"]:
                    want[0] += 1
                elif d < plan["ring"]:
                    want[1] += 1
                else:
                    want[2] += 1
    return want


@pytest.mark.cuda
def test_semiglobal_scores_kernel_matches_plain_on_the_card():
    """csrc/semiglobal_scores.cu = its plain version (run with `pytest -m
    cuda` on a machine with a GPU and nvcc): the seeded cases, every edge
    shape of SCORES_EDGES, and long queries (register tiles with their
    boundary scratch)."""
    _cuda_or_skip()
    cases = [_scores_inputs(s) for s in [0, 1, 2, 3] + SCORES_EDGES]
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
    -m cuda` on a machine with a GPU and nvcc): the fuzz, a hub beside a
    one-node graph, B = 1, 140 pairs (more than the multiprocessors) and
    every POA_EDGES shape, each with the default ring, no ring and a
    two-row ring; the kernel's count of predecessor reads by route equals
    a direct walk of the graphs, and every route (registers, ring,
    global) is taken."""
    _cuda_or_skip()
    (gs, qs), _ = _twin_graphs(3, 24)
    rng = np.random.default_rng(5)
    alphabet = rng.integers(1, 1 << 60, 12).astype(np.uint64)
    hub, template = _grow(PoaGraph, rng, alphabet, 12, 40, hub=True)
    one = PoaGraph([int(alphabet[0])], "ACGT", [0])
    batches = [(gs, qs), ([hub, one], [template * 30, [7]]),
               ([one], [[int(alphabet[0])]]),
               ((gs * 6)[:140], (qs * 6)[:140])]
    batches += [_twin_edge(case)[0] for case in POA_EDGES]
    routes = [0, 0, 0]
    for batch in batches:
        b = poa_device.export_batch(*batch)
        t = poa_device.batch_to_device(b, "cuda")
        args = [t[k] for k in ("node_off", "wts", "topo", "pred_off",
                               "pred_idx", "term", "q_off", "queries")]
        want = poa_device.poa_dp_plain(*args)
        before = kernels.poa_dp.launches
        for a, w in zip(kernels.poa_dp(*args), want):
            assert torch.equal(a, w)
        assert kernels.poa_dp.launches == before + 1
        for ring in (None, 0, 2):
            launch, got, plan = kernels.poa_dp_launcher(
                *args, ring_rows=ring, count_routes=True)
            launch()
            for a, w in zip(got, want):
                assert torch.equal(a, w)
            taken = launch.routes.tolist()
            assert taken == _route_walk(*batch, plan)
            routes = [x + y for x, y in zip(routes, taken)]
    assert min(routes) > 0, routes
