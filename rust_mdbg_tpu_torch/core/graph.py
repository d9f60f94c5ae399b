"""mdBG edge construction, presimp filtering and GFA emission.

A copy of the parts of the JAX package's core/graph.py that the device
drivers need: `build_gfa` from k-vectors (vector mode), for recompute
mode `build_gfa_precomputed` from overlap fingerprints (the host join) and
`IncrementalGFA.finish_pot` from a device-joined candidate list, and for
the whole-run path's phased emission the deferred abundances.

Parity target: rust-mdbg src/main.rs:1006-1121.

- S lines: `S\t<index>\t*\tLN:i:<seqlen>\tKC:i:<abundance>` (main.rs:1021)
- km_index: every node indexed under normalize(prefix) and normalize(suffix)
  (main.rs:1023-1032)
- edge enumeration per node, per key in [normalize(suffix), normalize(prefix)]:
  candidates = km_index[key], each tested with the four orientation cases
  (main.rs:1056-1075); this includes the reference's duplicate-emission
  behavior when a candidate satisfies a test in both key groups.
- presimp (main.rs:1086-1090): within a candidate group of >= 2 edges, drop the
  edge to n2 if n2.abundance < presimp * min(max group abundance, n1.abundance);
  deferred symmetric write drops an edge if its reverse was dropped
  (main.rs:1107-1117).
- overlap = min(n1.seqlen - shift, n2.seqlen - 1) with shift = shift0 for '+',
  shift1 for '-' (main.rs:1091-1092).
"""

from __future__ import annotations

import numpy as np

from ..ops.kminmer import fingerprint128_np


def _fp_pair(vecs: np.ndarray):
    """(F(x), F(reverse(x))) fingerprints for an array of u64 vectors."""
    f = fingerprint128_np(vecs)
    r = fingerprint128_np(vecs[:, ::-1])
    return f, r


def _le_rev(x: np.ndarray):
    """vec <= reversed(vec) per row, via first-difference (palindrome: True)."""
    r = x[:, ::-1]
    ne = x != r
    first = ne.argmax(axis=1)
    a = x[np.arange(len(x)), first]
    b = r[np.arange(len(x)), first]
    return np.where(ne.any(axis=1), a < b, True)


def _overlap_keys(varr: np.ndarray):
    """Per-node fingerprints (Fs, Fp, FsR, FpR) and normalized keys."""
    suf = varr[:, 1:]
    pre = varr[:, :-1]
    Fs, FsR = _fp_pair(suf)
    Fp, FpR = _fp_pair(pre)
    key_suf = np.where(_le_rev(suf)[:, None], Fs, FsR)
    key_pre = np.where(_le_rev(pre)[:, None], Fp, FpR)
    return Fs, Fp, FsR, FpR, key_suf, key_pre


def build_gfa_precomputed(path, nodes: dict, keys6: tuple,
                          presimp: float) -> dict:
    """Native GFA write from pre-computed overlap keys (Fs, Fp, FsR, FpR,
    key_suf, key_pre), rows in the order of `nodes`."""
    return _build_gfa_native(
        path, nodes["index"], nodes["abundance"], nodes["seqlen"],
        nodes["shift0"], nodes["shift1"], None, presimp, keys6=keys6,
    )


class IncrementalGFA:
    """Chunk-fed native GFA writer (gfa_begin/add_chunk/finish).

    Chunks must arrive in node-id order — S lines and km_index insertion
    order follow feed order (main.rs:1023-1032).  `finish` enumerates edges
    with the host km_index join; `finish_pot` takes them from a device
    join.  With defer_abundance the S lines are rendered at the finish,
    from the abundances that set_abundance supplied: phased feeding knows a
    node's whole-run count only after the last phase.  One that is neither
    finished nor aborted leaks its native state."""

    def __init__(self, cap_hint: int = 0, defer_abundance: bool = False):
        import ctypes

        from ..native import load

        self._lib = load("gfawriter")
        self._lib.gfa_begin.restype = ctypes.c_void_p
        self._lib.gfa_begin.argtypes = [ctypes.c_int64]
        self._lib.gfa_add_chunk.restype = None
        self._lib.gfa_add_chunk.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 11)
        self._lib.gfa_finish.restype = ctypes.c_int64
        self._lib.gfa_finish.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_void_p]
        self._lib.gfa_finish_pot.restype = ctypes.c_int64
        self._lib.gfa_finish_pot.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        self._lib.gfa_abort.restype = None
        self._lib.gfa_abort.argtypes = [ctypes.c_void_p]
        self._lib.gfa_defer_s.restype = None
        self._lib.gfa_defer_s.argtypes = [ctypes.c_void_p]
        self._lib.gfa_set_abundance.restype = None
        self._lib.gfa_set_abundance.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        self._h = self._lib.gfa_begin(int(cap_hint))
        if defer_abundance:
            self._lib.gfa_defer_s(self._h)
        self._ctypes = ctypes
        self.n_nodes = 0

    def set_abundance(self, abundance):
        """Overwrite the abundances of every node fed so far, in feed
        order, before the finish."""
        ab = np.ascontiguousarray(abundance, dtype=np.uint32)
        if len(ab) != self.n_nodes:
            raise ValueError(f"{len(ab)} abundances for {self.n_nodes} nodes")
        self._lib.gfa_set_abundance(
            self._h, ab.ctypes.data_as(self._ctypes.c_void_p), len(ab))

    def add_chunk(self, index, abundance, seqlen, shift0, shift1, keys6):
        """keys6=None: keys-free feeding — the edge join runs on the device
        (ops/edge_join.py) and arrives via finish_pot; no km_index here."""
        arrs = [
            np.ascontiguousarray(index, dtype=np.uint32),
            np.ascontiguousarray(abundance, dtype=np.uint32),
            np.ascontiguousarray(seqlen, dtype=np.uint32),
            np.ascontiguousarray(shift0, dtype=np.uint16),
            np.ascontiguousarray(shift1, dtype=np.uint16),
        ]
        n = len(arrs[0])
        if keys6 is not None:
            arrs += [np.ascontiguousarray(a, dtype=np.uint64) for a in keys6]
        if any(len(a) != n for a in arrs):
            raise ValueError("add_chunk arrays differ in length")
        ptrs = [a.ctypes.data_as(self._ctypes.c_void_p) for a in arrs]
        if keys6 is None:
            ptrs += [None] * 6
        self._lib.gfa_add_chunk(self._h, n, *ptrs)
        self.n_nodes += n

    def _done(self, nb: int, removed, what: str, path) -> dict:
        self._h = None
        if nb < 0:
            raise RuntimeError(f"{what} failed for {path}")
        return dict(nb_nodes=self.n_nodes, nb_edges=int(nb),
                    presimp_removed=int(removed.value))

    def finish(self, path, presimp: float) -> dict:
        removed = self._ctypes.c_int64(0)
        nb = self._lib.gfa_finish(self._h, str(path).encode(), float(presimp),
                                  self._ctypes.byref(removed))
        return self._done(nb, removed, "gfa_finish", path)

    def finish_pot(self, path, presimp: float, pot_i, pot_j, pot_c) -> dict:
        """Finish from a device-joined POT candidate list (ops/edge_join):
        applies presimp + the symmetric-drop rule and writes the file."""
        pot_i = np.ascontiguousarray(pot_i, dtype=np.uint32)
        pot_j = np.ascontiguousarray(pot_j, dtype=np.uint32)
        pot_c = np.ascontiguousarray(pot_c, dtype=np.uint32)
        if not len(pot_i) == len(pot_j) == len(pot_c):
            raise ValueError("POT arrays differ in length")
        if len(pot_i) and max(int(pot_i.max()), int(pot_j.max())) \
                >= self.n_nodes:
            raise ValueError("POT entry names a node that was never fed")
        removed = self._ctypes.c_int64(0)
        cp = self._ctypes.c_void_p
        nb = self._lib.gfa_finish_pot(
            self._h, str(path).encode(), float(presimp),
            pot_i.ctypes.data_as(cp), pot_j.ctypes.data_as(cp),
            pot_c.ctypes.data_as(cp), len(pot_i),
            self._ctypes.byref(removed))
        return self._done(nb, removed, "gfa_finish_pot", path)

    def abort(self):
        if self._h is not None:
            self._lib.gfa_abort(self._h)
            self._h = None


def _build_gfa_native(path, index, abundance, seqlen, shift0, shift1, varr,
                      presimp, keys6=None) -> dict:
    import ctypes

    from ..native import load

    lib = load("gfawriter")
    lib.gfa_write.restype = ctypes.c_int64
    lib.gfa_write.argtypes = (
        [ctypes.c_char_p, ctypes.c_int64] + [ctypes.c_void_p] * 11
        + [ctypes.c_double, ctypes.c_void_p]
    )
    Fs, Fp, FsR, FpR, key_suf, key_pre = (
        keys6 if keys6 is not None else _overlap_keys(varr))

    def ptr(a, dt):
        return np.ascontiguousarray(a, dtype=dt).ctypes.data_as(ctypes.c_void_p)

    arrs = [
        np.ascontiguousarray(index, dtype=np.uint32),
        np.ascontiguousarray(abundance, dtype=np.uint32),
        np.ascontiguousarray(seqlen, dtype=np.uint32),
        np.ascontiguousarray(shift0, dtype=np.uint16),
        np.ascontiguousarray(shift1, dtype=np.uint16),
        np.ascontiguousarray(Fs, dtype=np.uint64),
        np.ascontiguousarray(Fp, dtype=np.uint64),
        np.ascontiguousarray(FsR, dtype=np.uint64),
        np.ascontiguousarray(FpR, dtype=np.uint64),
        np.ascontiguousarray(key_suf, dtype=np.uint64),
        np.ascontiguousarray(key_pre, dtype=np.uint64),
    ]
    removed = ctypes.c_int64(0)
    nb = lib.gfa_write(
        str(path).encode(), len(index),
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrs],
        float(presimp), ctypes.byref(removed),
    )
    if nb < 0:
        raise RuntimeError(f"gfa_write failed for {path}")
    return dict(nb_nodes=len(index), nb_edges=int(nb),
                presimp_removed=int(removed.value))


def build_gfa(
    path: str,
    nodes: dict,
    vectors,
    presimp: float = 0.01,
    native: bool = True,
) -> dict:
    """Write the mdBG GFA.  `nodes` is NodeTable.dump() output (post abundance
    filter); `vectors` is either {index: vec} or a dense [n, k] u64 array in
    row order matching nodes.

    Equality of (k-1)-overlaps is tested via 128-bit fingerprints of the raw
    and reversed prefix/suffix vectors (the reference compares full vectors,
    main.rs:1062-1074; collision probability is ~2^-128 per pair).

    Returns stats: nb_nodes, nb_edges, presimp_removed.
    """
    index = nodes["index"]
    abundance = nodes["abundance"]
    seqlen = nodes["seqlen"]
    shift0 = nodes["shift0"]
    shift1 = nodes["shift1"]
    n = len(index)

    if isinstance(vectors, dict):
        if n:
            varr = np.stack([vectors[int(i)] for i in index]).astype(np.uint64)
        else:
            varr = np.zeros((0, 2), dtype=np.uint64)
    else:
        varr = np.asarray(vectors, dtype=np.uint64)

    if native and n:
        try:
            return _build_gfa_native(
                path, index, abundance, seqlen, shift0, shift1, varr, presimp
            )
        except Exception:
            pass  # python fallback below

    out = open(path, "w", buffering=1 << 20)
    out.write("H\tVN:Z:1.0\n")

    # S lines
    s_chunks = [
        f"S\t{int(index[i])}\t*\tLN:i:{int(seqlen[i])}\tKC:i:{int(abundance[i])}\n"
        for i in range(n)
    ]
    out.write("".join(s_chunks))

    if n == 0:
        out.close()
        return dict(nb_nodes=0, nb_edges=0, presimp_removed=0)

    # fingerprints: Fs=F(suffix), Fp=F(prefix), FsR=F(rev suffix), FpR=F(rev prefix)
    suf = varr[:, 1:]
    pre = varr[:, :-1]
    Fs, FsR = _fp_pair(suf)
    Fp, FpR = _fp_pair(pre)
    # normalized keys: min(F, F_rev) componentwise is NOT a valid normalize —
    # must pick the fingerprint of the lexicographically smaller vector.
    # vec <= reversed(vec)?  compute via first-difference on the raw vectors.
    def le_rev(x):
        r = x[:, ::-1]
        ne = x != r
        first = ne.argmax(axis=1)
        a = x[np.arange(len(x)), first]
        b = r[np.arange(len(x)), first]
        return np.where(ne.any(axis=1), a < b, True)

    suf_is_canon = le_rev(suf)
    pre_is_canon = le_rev(pre)
    key_suf = np.where(suf_is_canon[:, None], Fs, FsR)
    key_pre = np.where(pre_is_canon[:, None], Fp, FpR)

    # km_index: node i inserted under key_pre[i] and key_suf[i] (main.rs:1023-1032)
    km_index: dict[tuple, list[int]] = {}
    kp = [(int(key_pre[i, 0]), int(key_pre[i, 1])) for i in range(n)]
    ks = [(int(key_suf[i, 0]), int(key_suf[i, 1])) for i in range(n)]
    for i in range(n):
        km_index.setdefault(kp[i], []).append(i)
        km_index.setdefault(ks[i], []).append(i)

    FsT = [(int(Fs[i, 0]), int(Fs[i, 1])) for i in range(n)]
    FpT = [(int(Fp[i, 0]), int(Fp[i, 1])) for i in range(n)]
    FsRT = [(int(FsR[i, 0]), int(FsR[i, 1])) for i in range(n)]
    FpRT = [(int(FpR[i, 0]), int(FpR[i, 1])) for i in range(n)]

    nb_edges = 0
    presimp_removed = 0
    removed_edges: set[tuple[int, int]] = set()
    vec_edges: list[tuple] = []

    for i in range(n):
        n1_ab = int(abundance[i])
        n1_idx = int(index[i])
        n1_seqlen = int(seqlen[i])
        fs1, fpr1 = FsT[i], FpRT[i]
        for key in (ks[i], kp[i]):
            cands = km_index.get(key)
            if not cands:
                continue
            potential: list[tuple[int, str, str]] = []  # (j, ori1, ori2)
            for j in cands:
                fp2, fsr2 = FpT[j], FsRT[j]
                if fs1 == fp2:
                    potential.append((j, "+", "+"))
                if fs1 == fsr2:
                    potential.append((j, "+", "-"))
                if fpr1 == fp2:
                    potential.append((j, "-", "+"))
                if fpr1 == fsr2:
                    potential.append((j, "-", "-"))
            if not potential:
                continue
            ab_max = max(int(abundance[j]) for j, _, _ in potential)
            ab_ref = min(ab_max, n1_ab)
            for j, ori1, ori2 in potential:
                n2_ab = int(abundance[j])
                n2_idx = int(index[j])
                n2_seqlen = int(seqlen[j])
                if presimp > 0.0 and len(potential) >= 2 and n2_ab < presimp * ab_ref:
                    presimp_removed += 1
                    removed_edges.add((n1_idx, n2_idx))
                    continue
                shift = int(shift0[i]) if ori1 == "+" else int(shift1[i])
                overlap = min(n1_seqlen - shift, n2_seqlen - 1)
                if presimp == 0.0:
                    out.write(f"L\t{n1_idx}\t{ori1}\t{n2_idx}\t{ori2}\t{overlap}M\n")
                    nb_edges += 1
                else:
                    vec_edges.append((n1_idx, ori1, n2_idx, ori2, overlap))

    if presimp > 0.0:
        for n1_idx, ori1, n2_idx, ori2, overlap in vec_edges:
            if (n1_idx, n2_idx) in removed_edges or (n2_idx, n1_idx) in removed_edges:
                continue
            out.write(f"L\t{n1_idx}\t{ori1}\t{n2_idx}\t{ori2}\t{overlap}M\n")
            nb_edges += 1
    out.close()
    return dict(nb_nodes=n, nb_edges=nb_edges, presimp_removed=presimp_removed)
