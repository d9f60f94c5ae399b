"""Minimizer selection schemes (host/numpy reference implementations).

These are the numerics oracles for the device kernels and the fallback engine.

Schemes and parity targets:
- density (default): `Read::extract_density` rust-mdbg src/read.rs:176-211 —
  canonical ntHash of every l-mer of the HPC sequence, keep iff hash <= d*2^64;
  positions map back to raw-sequence run starts.
- robust/weighted (lmer-counts): `minimizers_preparation`
  rust-mdbg src/minimizers.rs:53-113 — frequent/rare l-mers are skipped by
  remapping via an explicit minimizer_to_int table.
- uhs / lcp: rust-mdbg src/read.rs:125-156, 93-124 — density rule AND
  membership in a universal-hitting-set / core-substring filter.
- syncmers: `Read::extract_syncmers` rust-mdbg src/read.rs:215-352 —
  open syncmers on 2-bit packed l-/s-mers with an invertible mix hash,
  downsampled by hash <= d*4^l.
"""

from __future__ import annotations

import numpy as np

from .hpc import encode_rle_np
from .nthash import nthash_windows_np
from ..utils.seq import encode_bases


def extract_density_np(
    codes: np.ndarray,
    l: int,
    hash_bound: int,
    already_hpc: bool = False,
    minimizer_to_int: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(positions, hashes) of selected minimizers for one read.

    `codes` is the raw base-code array; positions are raw-sequence indices
    (HPC run starts) exactly as read.rs:206-207.  When `minimizer_to_int` is
    given (EC / lmer-counts modes, read.rs:200-204), hashes are remapped through
    it and l-mers absent from the table are dropped.
    """
    if already_hpc:
        hpc, pos_map = codes, np.arange(codes.shape[0], dtype=np.int64)
    else:
        hpc, pos_map = encode_rle_np(codes)
    if hpc.shape[0] < l:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64)
    fh, rh = nthash_windows_np(hpc, l)
    canon = np.minimum(fh, rh)
    sel = canon <= np.uint64(hash_bound)
    idx = np.nonzero(sel)[0]
    hashes = canon[idx]
    if minimizer_to_int is not None:
        from ..utils.seq import CODE_BASE

        keep = np.ones(idx.shape[0], dtype=bool)
        remapped = hashes.copy()
        # decode every selected l-mer in one vectorized gather (a per-l-mer
        # decode_bases call was a top line of the EC profile)
        if idx.size:
            win = hpc[idx[:, None] + np.arange(l, dtype=np.int64)[None, :]]
            ascii_all = CODE_BASE[win].tobytes().decode()
            get = minimizer_to_int.get
            for j in range(idx.shape[0]):
                v = get(ascii_all[j * l : (j + 1) * l])
                if v is None:
                    keep[j] = False
                else:
                    remapped[j] = np.uint64(v)
        idx, hashes = idx[keep], remapped[keep]
    return pos_map[idx], hashes


# --- syncmers --------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def invertible_hash(key: int, mask: int) -> int:
    """64-bit invertible mix hash (rust-mdbg src/read.rs:43-52)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def invertible_hash_np(key: np.ndarray, mask: np.ndarray) -> np.ndarray:
    key = key.astype(np.uint64)
    mask = np.uint64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint64(21))) & mask
        key = key ^ (key >> np.uint64(24))
        key = (key + (key << np.uint64(3)) + (key << np.uint64(8))) & mask
        key = key ^ (key >> np.uint64(14))
        key = (key + (key << np.uint64(2)) + (key << np.uint64(4))) & mask
        key = key ^ (key >> np.uint64(28))
        key = (key + (key << np.uint64(31))) & mask
    return key


def extract_syncmers_np(
    codes: np.ndarray,
    l: int,
    s: int,
    hash_bound: int,
    already_hpc: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Open-syncmer selection (read.rs:215-352).

    An l-mer window is selected iff the tracked minimum s-mer hash position sits
    at offset t-1 (t = ceil((l-s+1)/2)) AND the canonical l-mer hash passes the
    density downsampling bound.  The reference tracks the window minimum with a
    queue whose tie-breaking is PATH-DEPENDENT (s-mer hashes are masked to 2s
    bits, so ties are common): the first full window takes the leftmost minimum
    (forward scan, strict '<', read.rs:283-288); when the current minimum is
    evicted the rescan runs right-to-left with strict '<' and therefore lands on
    the RIGHTMOST minimum (read.rs:63-73); an incoming equal value never
    displaces the incumbent (strict '<', read.rs:74).  We replicate that state
    machine exactly, per maximal N-free run (state resets on N, read.rs:341-348).
    The s-/l-mer packing and invertible hash are vectorized.
    """
    if already_hpc:
        hpc, pos_map = codes, np.arange(codes.shape[0], dtype=np.int64)
    else:
        hpc, pos_map = encode_rle_np(codes)
    n = hpc.shape[0]
    if n < l:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64)
    smask = np.uint64((1 << (2 * s)) - 1)
    lmask = np.uint64((1 << (2 * l)) - 1)
    ok = hpc < 4
    c = np.where(ok, hpc, 0).astype(np.uint64)

    def packed_canonical(width, mask):
        """Canonical (min of 2-bit fwd packing, rc packing) of every window."""
        m = n - width + 1
        if m <= 0:
            return np.zeros(0, dtype=np.uint64)
        fwd = np.zeros(m, dtype=np.uint64)
        rev = np.zeros(m, dtype=np.uint64)
        for j in range(width):
            fwd = ((fwd << np.uint64(2)) | c[j : j + m]) & mask
            rev |= (np.uint64(3) - c[j : j + m]) << np.uint64(2 * j)
        return np.minimum(fwd, rev)

    hs = invertible_hash_np(packed_canonical(s, smask), smask)
    hl = invertible_hash_np(packed_canonical(l, lmask), lmask)

    bound = np.uint64(hash_bound)
    out_pos: list[int] = []
    out_hash: list[int] = []

    # maximal runs of non-N bases
    run_starts = np.nonzero(ok & ~np.concatenate(([False], ok[:-1])))[0]
    run_ends = np.nonzero(ok & ~np.concatenate((ok[1:], [False])))[0]

    if s == 0:
        # "kminmer" mode (read.rs:324-339): every N-free l-mer, density-filtered
        for rs, re in zip(run_starts, run_ends):
            for win_start in range(rs, re - l + 2):
                h = hl[win_start]
                if h <= bound:
                    out_pos.append(int(pos_map[win_start]))
                    out_hash.append(int(h))
        return np.asarray(out_pos, dtype=np.int64), np.asarray(out_hash, dtype=np.uint64)

    t = int(np.ceil((l - s + 1) / 2.0))
    w = l - s + 1  # s-mers per l-mer window
    for rs, re in zip(run_starts, run_ends):
        run_len = re - rs + 1
        if run_len < l:
            continue
        # queue over s-mer hash positions rs .. re-s+1
        q_vals: list[int] = []
        q_pos: list[int] = []
        min_val, min_pos = (1 << 64) - 1, -1
        for p in range(rs, re - s + 2):
            v = int(hs[p])
            if len(q_vals) < w - 1:
                q_vals.append(v)
                q_pos.append(p)
                continue
            if len(q_vals) == w - 1:
                q_vals.append(v)
                q_pos.append(p)
                for j in range(w):  # forward scan: leftmost minimum
                    if q_vals[j] < min_val:
                        min_val, min_pos = q_vals[j], q_pos[j]
            else:
                popped = q_pos[0]
                q_vals.pop(0)
                q_pos.pop(0)
                q_vals.append(v)
                q_pos.append(p)
                if min_pos == popped:
                    min_val, min_pos = (1 << 64) - 1, p
                    for j in range(w - 1, -1, -1):  # reverse scan: rightmost min
                        if q_vals[j] < min_val:
                            min_val, min_pos = q_vals[j], q_pos[j]
                elif v < min_val:
                    min_val, min_pos = v, p
            win_start = p - (w - 1)  # l-mer start
            if min_pos == win_start + t - 1:
                h = hl[win_start]
                if h <= bound:
                    out_pos.append(int(pos_map[win_start]))
                    out_hash.append(int(h))
    return np.asarray(out_pos, dtype=np.int64), np.asarray(out_hash, dtype=np.uint64)


# --- robust minimizers preparation ----------------------------------------

def minimizers_preparation(params, lmer_counts: dict[str, int]):
    """Build minimizer_to_int / int_to_minimizer maps (minimizers.rs:53-113).

    Enumerates canonical l-mers (from lmer_counts keys if given, else all 4^l),
    marks l-mers with counts outside [min,max] as 'skip' (hash forced above the
    density bound), and keeps those whose ntHash/2^64 <= density.
    """
    from .nthash import ntc64
    from ..utils.seq import revcomp
    import itertools

    l, density = params.l, params.density
    list_minimizers: list[str] = []
    skip: set[str] = set()
    if lmer_counts:
        for x in lmer_counts:
            list_minimizers.append(min(x, revcomp(x)))
        for x, cnt in lmer_counts.items():
            if cnt >= params.lmer_counts_max or cnt <= params.lmer_counts_min:
                skip.add(x)
                skip.add(revcomp(x))
    elif l > 8:
        # vectorized enumeration: 4^l l-mers is millions of strings; compute
        # canonical hashes in numpy chunks and materialize strings only for
        # the ~density * 4^l selected ones
        return _minimizers_preparation_dense(params)
    else:
        for tup in itertools.product("ACTG", repeat=l):
            lmer = "".join(tup)
            if lmer > revcomp(lmer):
                continue
            list_minimizers.append(lmer)

    minimizer_to_int: dict[str, int] = {}
    int_to_minimizer: dict[int, str] = {}
    skips = 0
    for lmer in list_minimizers:
        hash_ = ntc64(lmer, l)
        hash_new = hash_ / 18446744073709551615.0  # u64::MAX as f64
        if lmer in skip:
            hash_new = 1.0
            skips += 1
        if hash_new <= density:
            minimizer_to_int[lmer] = hash_
            int_to_minimizer[hash_] = lmer
            lmer_rev = revcomp(lmer)
            minimizer_to_int[lmer_rev] = hash_
            int_to_minimizer[hash_] = lmer_rev
    return minimizer_to_int, int_to_minimizer, skips


def _minimizers_preparation_dense(params):
    """All-4^l enumeration, vectorized (semantics of minimizers.rs:53-113
    with no lmer counts: canonical l-mers whose ntHash/u64::MAX <= density).

    int_to_minimizer maps hash -> revcomp(canonical l-mer), matching the
    reference's double-insert order (minimizers.rs:100-106: the revcomp
    insert wins)."""
    from .nthash import H_BY_CODE, RC_BY_CODE
    from ..utils.seq import decode_bases, revcomp

    l = params.l
    total = 4 ** l
    chunk = 1 << 20
    minimizer_to_int: dict[str, int] = {}
    int_to_minimizer: dict[int, str] = {}
    comp = np.array([3, 2, 1, 0], dtype=np.uint8)  # complement in code space
    u64max = 18446744073709551615.0
    for start in range(0, total, chunk):
        ids = np.arange(start, min(start + chunk, total), dtype=np.uint64)
        codes = np.empty((len(ids), l), dtype=np.uint8)
        for j in range(l):
            codes[:, j] = (
                (ids >> np.uint64(2 * (l - 1 - j))) & np.uint64(3)
            ).astype(np.uint8)
        rc = comp[codes[:, ::-1]]
        # canonical filter: lmer <= revcomp(lmer); base chars A<C<G<T sort
        # exactly like codes 0..3
        diff = codes != rc
        first = diff.argmax(axis=1)
        r_idx = np.arange(len(ids))
        is_canon = np.where(
            diff.any(axis=1), codes[r_idx, first] < rc[r_idx, first], True
        )
        h = np.zeros(len(ids), dtype=np.uint64)
        hr = np.zeros(len(ids), dtype=np.uint64)
        for j in range(l):
            hj = H_BY_CODE[codes[:, j]]
            rj = RC_BY_CODE[codes[:, j]]
            r1 = (l - 1 - j) % 64
            if r1:
                hj = (hj << np.uint64(r1)) | (hj >> np.uint64(64 - r1))
            h ^= hj
            if j:
                rj = (rj << np.uint64(j)) | (rj >> np.uint64(64 - j))
            hr ^= rj
        canon_hash = np.minimum(h, hr)
        sel = is_canon & ((canon_hash.astype(np.float64) / u64max)
                          <= params.density)
        for i in np.nonzero(sel)[0]:
            lmer = decode_bases(codes[i])
            hv = int(canon_hash[i])
            lrev = revcomp(lmer)
            minimizer_to_int[lmer] = hv
            minimizer_to_int[lrev] = hv
            int_to_minimizer[hv] = lrev
    return minimizer_to_int, int_to_minimizer, 0


def extract_filtered_np(
    codes: np.ndarray,
    l: int,
    hash_bound: int,
    filter_,
    already_hpc: bool = False,
    minimizer_to_int: dict | None = None,
    skip_n: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """UHS / LCP selection (read.rs:125-156 / 93-124): density rule AND a
    check_and_add filter.  Faithful quirk: positions are HPC-space indices
    (the reference pushes `i` directly, not the raw-position map — read.rs:
    119-120, 151-152).  `skip_n` mirrors extract_lcp's contains('N') skip."""
    from ..utils.seq import decode_bases

    if already_hpc:
        hpc = codes
    else:
        hpc, _ = encode_rle_np(codes)
    if hpc.shape[0] < l:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64)
    fh, rh = nthash_windows_np(hpc, l)
    canon = np.minimum(fh, rh)
    sel = np.nonzero(canon <= np.uint64(hash_bound))[0]
    out_pos, out_hash = [], []
    for i in sel:
        if skip_n and (hpc[i : i + l] >= 4).any():
            continue
        h = int(canon[i])
        if minimizer_to_int is not None:
            v = minimizer_to_int.get(decode_bases(hpc[i : i + l]))
            if v is None:
                continue
            h = v
        if filter_.check_and_add(h):
            out_pos.append(int(i))
            out_hash.append(h)
    return (np.asarray(out_pos, dtype=np.int64),
            np.asarray(out_hash, dtype=np.uint64))
