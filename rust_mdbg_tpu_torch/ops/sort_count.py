"""Device-resident k-min-mer counting: construct -> sort -> segment-reduce.

Counterpart of the JAX package's `ops/sort_count.py`: the chunked half
(`finalize_chunk`, one reduction per chunk, merged on the host) and the
whole-run half (`finalize_compact`, one reduction over every window of the
run, the crossing selected on the device for any --minabund).
Every batch's VALID window keys (128-bit canonical fingerprints from
ops/extract) are compacted into fixed per-batch slots of the counter
buffers, beside their window coordinate occ = read_row * W + w and the
compacted per-read minimizer rows mh/mp (and mpe for raw reads).  Per
chunk, one reduction sorts the keys with occ as the last sort key, finds
segment heads and returns the unique keys with their counts in
first-occurrence order; the window metadata of a node's crossing occurrence
is rebuilt later by gathering k-slices of mh/mp.  For pre-HPC'd input
(recompute mode) the gather returns the node's four (k-1)-overlap
fingerprints and its record-relative minimizer positions instead of the
k-vector.

Buffers (a tuple of tensors on the counter's device; u64 and u32 values
are held as int64 bit patterns, see ops/u64.py):

  b_lo, b_hi  int64 [read_cap * W_slot]  key halves, all-ones = empty
  b_occ       int64 [read_cap * W_slot]  occ, 0xFFFFFFFF = empty
  b_mh        int64 [read_cap, M]        minimizer hashes
  b_mp        int32 [read_cap, M]        raw minimizer positions
  b_mpe       int32 [read_cap, M]        extent ends minus l (raw reads
                                         only: counter_flags' with_ext)
  bits        int32 [2^bloom_log2 / 32]  the --bf Bloom filter as u32 words
                                         held as int32 bit patterns (whole
                                         run with counter_flags' use_bf
                                         only); always the last plane

Buffers are updated in place (the JAX package donates and replaces them).
The whole-run driver relies on one invariant of that: batch i of a run
writes key rows [read_base * W_slot, ...) and minimizer rows [read_base,
...) of ITS reads only, so a reduction over the rows below an earlier
read_base (finalize_compact's prefix_rows) reads nothing a later construct
writes, and may run beside it.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from . import u64
from .extract import bloom_check_and_add, extract_count
from .kernels import window_keys_append
from .kminmer import canonicalize, fingerprint128, le_rev
from .pack import unpack_codes


def counter_flags(params) -> dict:
    """Buffer-layout flags a counter shares with the construct: the
    exact-cut extent plane (raw inputs) and the --bf bit tensor."""
    return dict(
        with_ext=not (params.reads_already_hpc
                      or getattr(params, "seq_ref_cuts", False)),
        use_bf=(params.use_bf and params.min_kmer_abundance > 1
                and not params.reference),
        bloom_log2_bits=params.bloom_log2_bits,
    )


def window_slot_capacity(params, B: int, L: int, M: int) -> int:
    """Per-read compacted window slots W_slot for the batch-slot layout.

    Valid windows per read are a PREFIX (window w needs minimizers w..w+k-1),
    so per-batch compaction packs sum(nw) rows into a fixed B*W_slot slot.
    Batch sums concentrate: sigma(sum)/B = sigma_read/sqrt(B), so W_slot =
    E[nw] + 8*sigma_read/sqrt(B) (+pad) is ~1.1x the mean while overflow
    probability is ~1e-15 per batch; overflowing batches are counted and the
    driver raises."""
    W = M - params.k + 1
    rate = (min(1.0, params.density * 2) if not params.use_syncmers
            else min(1.0, params.density * 1.5 + 8.0 / max(64, L)))
    expect = max(0.0, L * rate - (params.k - 1))
    sigma = math.sqrt(max(1.0, L * rate * (1 - rate)))
    w = int(expect + 8.0 * sigma / math.sqrt(max(1, B)) + 9)
    return max(8, min(W, (w + 7) & ~7))


def no_mpos() -> bool:
    """MDBG_NO_MPOS=1 drops the per-node record-position plane from the
    whole-run finalize output: the native .sequences writer then re-derives
    the minimizers by rolling ntHash over each record, trading 4k B/node of
    device-to-host transfer for host hashing."""
    return os.environ.get("MDBG_NO_MPOS", "0") == "1"


#: the multiplier of the native table's single-hash Bloom
#: (native/mdbg_core.cpp nt_add), as int64 bits
_BLOOM_MUL = u64.s64(0x9E3779B97F4A7C15)


def bloom_pass(key_lo, key_hi, valid, bits):
    """--bf screen over one batch's window keys, in stream order.

    Device twin of the native table's single-hash Bloom (bit = (lo ^ (hi *
    0x9E3779B97F4A7C15)) & mask; the wrapping int64 multiply gives the same
    bits): a window is KEPT iff its bit was set by an earlier batch or by an
    earlier window of this batch; every valid window sets its bit.  Same bit
    indices as the host filter, so the same false positives.

    Order within the batch and the insert are extract.bloom_check_and_add's.

    key_lo, key_hi int64 [N] (u64 bits), valid bool [N], bits int32 [m / 32]
    with m a power of two, updated in place.  Returns keep bool [N].
    """
    m_bits = bits.shape[0] * 32
    bidx = (key_lo ^ (key_hi * _BLOOM_MUL)) & (m_bits - 1)
    return bloom_check_and_add(bidx, valid, bits)


def construct_batches(params, all_codes, all_lengths, buffers, *, B: int,
                      M: int, w_slot: int, batch_lo: int, batch_hi: int,
                      read_base: int = 0, bf: bool | None = None):
    """Extract batches [batch_lo, batch_hi) of a staged chunk and append
    their window keys and minimizer rows to `buffers` (in place).

    all_codes is either the codes tensor [n*B, L] u8 or the packed feed
    (packed [n*B, L//4], mask [n*B, L//8]) from ops.pack.pack_codes_np,
    unpacked per batch.  read_base is the global row of the chunk's first
    read.  Returns device scalars (n_windows, n_overflow); n_overflow counts
    minimizer-capacity reads plus window-slot batches.

    bf (default: counter_flags' use_bf) screens every batch through
    bloom_pass before the slot append, so the counter holds each key's
    sightings from the second on; the Bloom words are the last plane of
    `buffers`.  The chunked driver passes bf=False: its Bloom lives in the
    host merge and must not screen twice.
    """
    b_lo, b_hi, b_occ, b_mh, b_mp = buffers[:5]
    flags = counter_flags(params)
    with_ext = flags["with_ext"]
    bf_on = flags["use_bf"] if bf is None else bf
    if len(buffers) != 5 + with_ext + bf_on:
        raise ValueError(
            f"{len(buffers)} buffer planes for with_ext={with_ext}, "
            f"bf={bf_on}")
    dev = b_lo.device
    W = M - params.k + 1
    S = B * w_slot
    if (read_base + batch_hi * B) * W > u64.U32_MAX:
        raise ValueError("window coordinates (read row * W + w) pass 32 bits")
    syncmer = ((params.s, params.syncmer_hash_bound) if params.use_syncmers
               else None)
    pos = torch.arange(S, device=dev) if bf_on else None
    n_win = torch.zeros((), dtype=torch.int64, device=dev)
    n_over = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(batch_lo, batch_hi):
        r = slice(i * B, (i + 1) * B)
        if isinstance(all_codes, tuple):
            codes = unpack_codes(all_codes[0][r], all_codes[1][r])
        else:
            codes = all_codes[r]
        out = extract_count(codes, all_lengths[r], l=params.l, k=params.k,
                            hash_bound=params.hash_bound, M=M,
                            already_hpc=params.reads_already_hpc,
                            syncmer=syncmer, ref_cuts=params.seq_ref_cuts,
                            keys=bf_on)
        row0 = read_base + i * B
        slot0 = row0 * w_slot
        if bf_on:
            # the kept windows are no per-read prefix any more: their flat
            # positions, ascending, are the slot's rows
            keys_flat = out["keys"].reshape(B * W, 2)
            valid_w = (torch.arange(W, device=dev)[None, :]
                       < out["nw"][:, None]).reshape(B * W)
            kept = torch.nonzero(bloom_pass(
                keys_flat[:, 0], keys_flat[:, 1], valid_w,
                buffers[-1])).flatten()
            nv = torch.tensor(kept.shape[0], device=dev)
            src = torch.zeros(S, dtype=torch.int64, device=dev)
            src[: min(S, kept.shape[0])] = kept[:S]
            row = src // W
            w = src - row * W
            valid = pos < min(S, kept.shape[0])
            b_lo[slot0 : slot0 + S] = torch.where(valid, keys_flat[src, 0],
                                                  u64.SENTINEL)
            b_hi[slot0 : slot0 + S] = torch.where(valid, keys_flat[src, 1],
                                                  u64.SENTINEL)
            b_occ[slot0 : slot0 + S] = torch.where(
                valid, ((row0 + row) * W + w) & u64.U32_MAX, u64.U32_MAX)
            n_over += nv > S
            n_win += torch.clamp(nv, max=S)
        else:
            # batch-slot compaction: valid windows are a per-read prefix,
            # so each lands at its read's offset in the slot (the
            # window_keys kernel's mode ii; slot_append_plain on the CPU)
            window_keys_append(out["mh"], out["n_min"], params.k, b_lo, b_hi,
                               b_occ, row0=row0, slot0=slot0, S=S,
                               n_win=n_win, n_over=n_over)
        b_mh[row0 : row0 + B] = out["mh"]
        b_mp[row0 : row0 + B] = out["mp"]
        if with_ext:
            # extent plane biased by -l (see gather_window_meta)
            buffers[5][row0 : row0 + B] = out["mpe"] - params.l
        n_over += out["overflow"].sum()
    return n_win, n_over


def finalize_chunk(b_lo, b_hi, b_occ, *, slots: int):
    """Per-chunk reduction: the chunk's unique keys in first-occurrence
    order, with per-chunk counts and the occurrences of their first `slots`
    in-chunk appearances (valid where count >= j).

    Keys sort by (lo, hi) unsigned, then occ; node ids downstream follow
    crossing-occurrence order, so only the order within a key (by occ)
    matters, and occ is unique per valid row.

    Returns (key_lo, key_hi, count, occs) on the buffers' device, n_unique
    rows each; raises if the unique keys exceed the buffer (the JAX
    package's node_cap = N - 1 overflow).
    """
    N = b_lo.shape[0]
    perm = u64.lexsort([b_lo, b_hi, b_occ], [True, True, False])
    slo, shi, socc = b_lo[perm], b_hi[perm], b_occ[perm]
    sval = ~((slo == u64.SENTINEL) & (shi == u64.SENTINEL))
    n_valid = sval.sum()
    head = sval.clone()
    head[1:] &= (slo[1:] != slo[:-1]) | (shi[1:] != shi[:-1])
    head_pos = torch.nonzero(head).flatten()
    n_unique = head_pos.shape[0]
    if n_unique > N - 1:
        raise RuntimeError("chunk unique keys exceeded window capacity")
    next_head = torch.cat([head_pos[1:], n_valid.reshape(1)])
    counts = next_head - head_pos
    occ_idx = torch.clamp(
        head_pos[:, None] + torch.arange(slots, device=b_lo.device)[None, :],
        max=N - 1)
    occs = socc[occ_idx]
    order = torch.argsort(socc[head_pos], stable=True)
    return (slo[head_pos][order], shi[head_pos][order], counts[order],
            occs[order])


def finalize_compact(b_lo, b_hi, b_occ, b_mh, b_mp, b_mpe=None, *, k: int,
                     M: int, minab: int, emit_mpos: bool = False,
                     prefix_rows: int | None = None, bf: bool = False) -> dict:
    """Whole-run reduction: the keys that reach `minab` sightings, in
    crossing-occurrence order, with their counts and the window metadata of
    the crossing sighting (gathered from b_mh/b_mp at occ // W, occ % W).

    Node ids follow the crossing occurrence (the order in which rust-mdbg
    writes .sequences records, src/main.rs:693-707; first-occurrence order
    for minab == 1).  That order is monotone in the window stream, so a
    reduction over a longer prefix of the buffers (`prefix_rows`, a multiple
    of a batch's slot) reproduces an earlier one's rows as an exact prefix
    of its own — a key's crossing sighting never changes once crossed; only
    its count grows.  Phased emission rests on this.

    Under `bf` the buffers hold each key's sightings from the second on
    (bloom_pass dropped the first, src/main.rs:639-662), so the crossing row
    is the (minab - 1)-th of its run and the count adds the dropped one back.

    What the JAX function carries for XLA's static shapes has no
    counterpart here: `torch.nonzero` gives the run heads and the crossing
    rows exactly, so there is no pass_cap or node_cap, no searchsorted
    compaction, no overflow re-run and no power-of-two fetch slice; its two
    log-step scans (distance to the run head, run length) reduce to
    differences of consecutive head positions; and the 16-bit `meta16`
    wire packing is dropped: `meta` is always the canonical u32 layout.
    Empty rows are dropped before the sort, which they would only trail.

    Returns tensors on the buffers' device, n_pass rows each: key_lo, key_hi
    (int64 u64 bits), count, vec [n, k], meta [n, 5 or 6] (see
    gather_window_meta), mpos [n, k] with emit_mpos; and n_pass, n_unique
    (ints) and n_clipped (device scalar, see gather_window_meta).
    """
    if prefix_rows is not None:
        b_lo, b_hi, b_occ = (b[:prefix_rows] for b in (b_lo, b_hi, b_occ))
    filled = torch.nonzero((b_lo != u64.SENTINEL)
                           | (b_hi != u64.SENTINEL)).flatten()
    lo, hi, occ = b_lo[filled], b_hi[filled], b_occ[filled]
    del filled
    # keys sort by (lo, hi) unsigned, then occ: any total order of the keys
    # serves, only the order within a key (by occ, unique per row) matters
    perm = u64.lexsort([lo, hi, occ], [True, True, False])
    slo, shi, socc = lo[perm], hi[perm], occ[perm]
    del lo, hi, occ, perm
    n_valid = slo.shape[0]
    head = torch.ones(n_valid, dtype=torch.bool, device=slo.device)
    head[1:] = (slo[1:] != slo[:-1]) | (shi[1:] != shi[:-1])
    head_pos = torch.nonzero(head).flatten()
    n_unique = head_pos.shape[0]
    run = torch.diff(head_pos, append=head_pos.new_tensor([n_valid]))
    minab_sel = minab - 1 if bf else minab
    if minab_sel < 1:
        raise ValueError("bf needs minab > 1 (counter_flags' use_bf)")
    crossed = run >= minab_sel
    cpos = head_pos[crossed] + (minab_sel - 1)
    cross_occ, order = torch.sort(socc[cpos])
    cpos = cpos[order]
    gw = gather_window_meta(b_mh, b_mp, cross_occ, k=k, M=M, b_mpe=b_mpe,
                            with_record_pos=emit_mpos)
    out = dict(key_lo=slo[cpos], key_hi=shi[cpos],
               count=run[crossed][order] + int(bf), vec=gw[0], meta=gw[1],
               n_clipped=gw[2], n_pass=int(cpos.shape[0]), n_unique=n_unique)
    if emit_mpos:
        out["mpos"] = gw[3]
    return out


def finalize_windows(b_lo, b_hi, b_meta, b_vecs=None, *, minab: int) -> dict:
    """Sort and segment-reduce windows that carry explicit meta and vec
    rows: the counterpart of the JAX package's `_finalize`, the reduction
    of the sharded pipeline (parallel/pipeline.py), where windows are
    routed across shards and no occ -> (read, window) mapping holds.

    A row is a window where meta[:, 1] has bit 31 set; its occurrence
    index is its row.  Per unique key: the count, the first occurrence,
    and the meta and vec rows of its minab-th occurrence; the keys sighted
    at least minab times are the nodes, in first-occurrence order.

    The JAX function keeps only the first node_cap unique keys in key
    order and counts the rest as node_overflow; here every output is sized
    from the data, so no key is dropped.

    Returns tensors on the buffers' device, n_pass rows each: key_lo,
    key_hi, count, first_occ, meta, vec (with b_vecs); and n_pass,
    n_unique (ints).
    """
    rows = torch.nonzero(u64.shr(b_meta[:, 1], 31) & 1).flatten()
    lo, hi = b_lo[rows], b_hi[rows]
    # rows are unique and ascending, so as the last key they order each
    # key's sightings by occurrence
    perm = u64.lexsort([lo, hi, rows], [True, True, False])
    slo, shi, socc = lo[perm], hi[perm], rows[perm]
    del lo, hi, rows, perm
    n_valid = slo.shape[0]
    head = torch.ones(n_valid, dtype=torch.bool, device=slo.device)
    head[1:] = (slo[1:] != slo[:-1]) | (shi[1:] != shi[:-1])
    head_pos = torch.nonzero(head).flatten()
    run = torch.diff(head_pos, append=head_pos.new_tensor([n_valid]))
    passing = run >= minab
    hp = head_pos[passing]
    first_occ, order = torch.sort(socc[hp])
    hp = hp[order]
    cross_occ = socc[hp + (minab - 1)]
    out = dict(key_lo=slo[hp], key_hi=shi[hp], count=run[passing][order],
               first_occ=first_occ, meta=b_meta[cross_occ],
               n_pass=int(hp.shape[0]), n_unique=int(head_pos.shape[0]))
    if b_vecs is not None:
        out["vec"] = b_vecs[cross_occ]
    return out


def gather_window_meta(b_mh, b_mp, occs, *, k: int, M: int, b_mpe=None,
                       with_record_pos: bool = False):
    """Reconstruct (canonical vec, meta) for chunk-local window occurrences
    by gathering k-slices of the compact minimizer rows.

    meta int64 [n, 5] holds u32 values: (seqlen, shift0 | 1<<31,
    shift1 | rev<<31, start, row); with b_mpe (raw inputs) a 6th column
    packs the exact-cut corrections (end_ext - end) << 16 |
    (d_last_e - d_last + 0x8000), both clipped to 16 bits as in the JAX
    package.  Returns (canon_vec, meta, n_clipped): n_clipped (a device
    scalar, 0 without b_mpe) counts the rows where either correction lies
    outside [0, 0xFFFF], whose clipped value would cut the record wrong.

    with_record_pos=True appends mpos int64 [n, k]: each minimizer's
    position within the node's stored record sequence, flipped into stored
    orientation for reversed crossings (the .sequences writer re-derives the
    minimizer values by hashing the k l-mers there)."""
    W = M - k + 1
    rows = occs // W
    wins = occs % W
    base = rows * M + wins
    gidx = base[:, None] + torch.arange(k, device=occs.device)[None, :]
    vec_f = b_mh.reshape(-1)[gidx]
    pos_f = b_mp.reshape(-1)[gidx].long()
    canon_vec, rev = canonicalize(vec_f)
    d_first = pos_f[:, 1] - pos_f[:, 0]
    d_last = pos_f[:, k - 1] - pos_f[:, k - 2]
    shift0 = torch.where(rev, d_last, d_first)
    shift1 = torch.where(rev, d_first, d_last)
    seqlen = pos_f[:, k - 1] - pos_f[:, 0] + 2
    cols = [seqlen, shift0 | (1 << 31), shift1 | (rev.long() << 31),
            pos_f[:, 0], rows]
    if b_mpe is not None:
        pe = b_mpe.reshape(-1)[base[:, None] + torch.tensor(
            [k - 2, k - 1], device=occs.device)[None, :]].long()
        # b_mpe holds extent_end - l, so ext_delta = end_ext - (pos + l)
        ext_delta = pe[:, 1] - pos_f[:, k - 1]
        de1 = (pe[:, 1] - pe[:, 0]) - d_last + 0x8000
        ext = torch.clamp(ext_delta, 0, 0xFFFF)
        d16 = torch.clamp(de1, 0, 0xFFFF)
        n_clipped = ((ext != ext_delta) | (d16 != de1)).sum()
        cols.append((ext << 16) | d16)
    else:
        n_clipped = torch.zeros((), dtype=torch.int64, device=occs.device)
    meta = torch.stack(cols, dim=-1) & u64.U32_MAX
    if not with_record_pos:
        return canon_vec, meta, n_clipped
    # the record is span + l long, so its last l-mer starts at span =
    # rel[k-1]; a reversed record stores revcomp(seq), where the l-mer at
    # forward offset r starts at span - r
    rel = pos_f - pos_f[:, :1]
    mpos = torch.where(rev[:, None], rel[:, -1:] - rel.flip(1), rel)
    return canon_vec, meta, n_clipped, mpos


def overlap_keys_device(canon_vec):
    """GFA (k-1)-overlap fingerprints of canonical k-vectors [n, k]: gk
    int64 [n, 8] holds (Fs, Fp, FsR, FpR) as (lo, hi) pairs — suffix,
    prefix, reversed suffix, reversed prefix, the twins of
    core/graph._overlap_keys — and gflag uint8 [n] has bit 0 set where the
    suffix is its own canonical orientation and bit 1 for the prefix.  With
    these the edge join never needs the vectors."""
    suf = canon_vec[:, 1:]
    pre = canon_vec[:, :-1]
    gk = torch.cat([fingerprint128(suf), fingerprint128(pre),
                    fingerprint128(suf.flip(1)), fingerprint128(pre.flip(1))],
                   dim=-1)
    gflag = le_rev(suf).to(torch.uint8) | (le_rev(pre).to(torch.uint8) << 1)
    return gk, gflag


def _u32_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of u32 values -> numpy uint32, 4 B per value over the
    device-to-host copy."""
    return t.to(torch.int32).cpu().numpy().view(np.uint32)


def buffers_from_numpy(bufs, device) -> tuple:
    """The JAX counter's buffers as numpy (u64 lo/hi, u32 occ, u64 mh,
    i32 mp[, i32 mpe][, u32 Bloom words]) -> this module's tensors on
    `device` (copies: the construct updates them in place)."""
    lo, hi, occ, mh, mp = bufs[:5]

    def i_plane(a, dt):
        return torch.from_numpy(np.asarray(a, dtype=dt)).to(device, copy=True)

    def tail(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:    # the Bloom words: same bits as int32
            a = np.ascontiguousarray(a).view(np.int32)
        return i_plane(a, np.int32)

    out = (u64.from_numpy(lo, device), u64.from_numpy(hi, device),
           i_plane(occ, np.int64), u64.from_numpy(mh, device),
           i_plane(mp, np.int32))
    return out + tuple(tail(b) for b in bufs[5:])


def window_buffers_from_numpy(lo, hi, meta, vecs, device) -> tuple:
    """One shard of the JAX sharded pipeline's buffers as numpy (u64 lo,
    hi [N], u32 meta [N, mc], u64 vecs [N, k]) -> the int64 tensors
    finalize_windows reduces, on `device`."""
    m = torch.from_numpy(np.asarray(meta, dtype=np.uint32).astype(np.int64))
    return (u64.from_numpy(lo, device), u64.from_numpy(hi, device),
            m.to(device), u64.from_numpy(vecs, device))


def buffers_to_numpy(bufs) -> tuple:
    """Inverse of buffers_from_numpy (a 1-D plane past the fifth is the
    Bloom words and comes back as u32)."""
    lo, hi, occ, mh, mp = bufs[:5]
    out = (u64.to_numpy(lo), u64.to_numpy(hi),
           occ.cpu().numpy().astype(np.uint32), u64.to_numpy(mh),
           mp.cpu().numpy())
    return out + tuple(
        b.cpu().numpy().view(np.uint32) if b.dim() == 1 else b.cpu().numpy()
        for b in bufs[5:])


CLIPPED_MSG = ("{} crossing windows have an extent correction outside 16 "
               "bits (a homopolymer run of 64 KB at a window's last l-mer)")


class DeviceNodeCounter:
    """Counter buffers on one device, for one chunk of reads (core/chunked:
    finalize_chunk, occ_at_chunk, the crossing gathers, reset_chunk) or for
    a whole run (core/pipeline: grow, finalize_dispatch / finalize_resolve /
    finalize, edge_join).  with_ext (raw inputs) carries the extent plane;
    use_bf (whole run only) the Bloom words, always the last plane.

    emit_overlap_keys (recompute mode, pre-HPC'd reads) makes the whole-run
    finalize return record positions and the overlap fingerprints instead
    of shipping the k-vectors; it never combines with with_ext."""

    def __init__(self, k: int, M: int, read_cap: int, w_slot: int,
                 chunk_slots: int, device, with_ext: bool = True,
                 minab: int = 2, emit_overlap_keys: bool = False,
                 use_bf: bool = False, bloom_log2_bits: int = 30):
        if with_ext and emit_overlap_keys:
            raise ValueError("recompute mode has no extent plane")
        self.k = k
        self.M = M
        self.W_slot = w_slot
        self.read_cap = read_cap
        self.minab = minab
        self.emit_overlap_keys = emit_overlap_keys
        self.use_bf = use_bf
        self.chunk_slots = max(1, chunk_slots)
        self._n_fin = 5 + int(with_ext)  # planes the reductions read
        dev = torch.device(device)
        n = read_cap * w_slot
        self.buffers = (
            torch.full((n,), u64.SENTINEL, dtype=torch.int64, device=dev),
            torch.full((n,), u64.SENTINEL, dtype=torch.int64, device=dev),
            torch.full((n,), u64.U32_MAX, dtype=torch.int64, device=dev),
            torch.zeros((read_cap, M), dtype=torch.int64, device=dev),
            torch.zeros((read_cap, M), dtype=torch.int32, device=dev),
        )
        if with_ext:
            self.buffers += (
                torch.zeros((read_cap, M), dtype=torch.int32, device=dev),)
        if use_bf:
            self.buffers += (torch.zeros((1 << bloom_log2_bits) // 32,
                                         dtype=torch.int32, device=dev),)
        self._chunk_occs = None  # [n_unique, slots] of the last chunk

    @property
    def window_cap(self) -> int:
        return self.read_cap * self.W_slot

    # --- whole-run path (core/pipeline.assemble_device_table) ------------

    def grow(self, min_read_cap: int):
        """Double the read capacity until it holds min_read_cap reads,
        copying the filled planes into new ones.  The old planes are not
        touched: a reduction taken with finalize_dispatch before the call
        keeps its references and goes on reading them."""
        new_cap = self.read_cap
        while new_cap < min_read_cap:
            new_cap *= 2
        if new_cap == self.read_cap:
            return
        n_old, n_new = self.window_cap, new_cap * self.W_slot
        grown = []
        for i, b in enumerate(self.buffers[: self._n_fin]):
            if i < 3:
                g = torch.full((n_new,), u64.SENTINEL if i < 2
                               else u64.U32_MAX, dtype=b.dtype,
                               device=b.device)
                g[:n_old] = b
            else:
                g = torch.zeros((new_cap, self.M), dtype=b.dtype,
                                device=b.device)
                g[: self.read_cap] = b
            grown.append(g)
        # the Bloom words do not depend on the input size
        self.buffers = tuple(grown) + self.buffers[self._n_fin :]
        self.read_cap = new_cap

    def finalize_dispatch(self, prefix_rows: int | None = None):
        """The reduction over the buffers as they stand (or their first
        prefix_rows key rows), bound but not run: finalize_resolve runs it.
        `torch.nonzero` blocks the host, so a caller that wants the
        reduction beside its next construct resolves it on another thread.
        That is safe because the planes are captured here — a later grow()
        leaves them alone — and later constructs write only rows past the
        prefix (the module docstring's invariant)."""
        return functools.partial(
            finalize_compact, *self.buffers[: self._n_fin], k=self.k,
            M=self.M, minab=self.minab,
            emit_mpos=self.emit_overlap_keys and not no_mpos(),
            prefix_rows=prefix_rows, bf=self.use_bf)

    def finalize_resolve(self, pending, lazy: bool = False, row_lo: int = 0,
                         gk_mode: str = "host"):
        """Run a finalize_dispatch reduction and package its result.

        row_lo: the first row the caller still needs (an earlier phase
        emitted the rows below); a LazyNodes fetches only [row_lo, n_pass).

        gk_mode (recompute mode): "host" computes the overlap fingerprints
        and stages their copy to the host, for the host km_index join;
        "device" computes them and keeps them on the device, for
        edge_join; "none" skips them (a phase before the last needs no
        keys under the device join).

        lazy=False returns numpy arrays for every row: key_lo, key_hi,
        count, meta, vec, index (and gk, gflag, mpos in recompute mode).
        """
        out = pending()
        n_clipped = int(out.pop("n_clipped"))
        if n_clipped:
            raise RuntimeError(CLIPPED_MSG.format(n_clipped))
        if self.emit_overlap_keys and gk_mode != "none":
            out["gk"], out["gflag"] = overlap_keys_device(out["vec"])
        if lazy:
            from ..core.device_out import LazyNodes

            return LazyNodes(out, row_lo=row_lo,
                             want_vec=not self.emit_overlap_keys,
                             want_gk=gk_mode == "host")
        res = dict(index=np.arange(out["n_pass"], dtype=np.uint32))
        for name in ("key_lo", "key_hi", "vec", "gk"):
            if name in out:
                res[name] = u64.to_numpy(out[name])
        for name in ("count", "meta", "mpos"):
            if name in out:
                res[name] = _u32_to_numpy(out[name])
        if "gflag" in out:
            res["gflag"] = out["gflag"].cpu().numpy()
        return res

    def finalize(self, lazy: bool = False, prefix_rows: int | None = None,
                 row_lo: int = 0, gk_mode: str = "host"):
        """finalize_dispatch + finalize_resolve in one call."""
        return self.finalize_resolve(self.finalize_dispatch(prefix_rows),
                                     lazy=lazy, row_lo=row_lo,
                                     gk_mode=gk_mode)

    def edge_join(self, nodes):
        """Start the device edge join (ops/edge_join.PotJoin) on the final
        reduction's overlap keys; its list comes down while the caller
        emits the tail.  None when the reduction carried no keys."""
        from .edge_join import PotJoin

        if not nodes.has("gk"):
            return None
        return PotJoin(nodes.device("gk"), nodes.device("gflag"))

    # --- chunked path (core/chunked.py) -----------------------------------

    def finalize_chunk(self) -> dict:
        """Reduce the current chunk: unique keys (numpy u64) with per-chunk
        counts (u32) in first-occurrence order.  The occurrence matrix stays
        on the device for occ_at_chunk."""
        lo, hi, cnt, occs = finalize_chunk(*self.buffers[:3],
                                           slots=self.chunk_slots)
        self._chunk_occs = occs
        return dict(key_lo=u64.to_numpy(lo), key_hi=u64.to_numpy(hi),
                    count=cnt.cpu().numpy().astype(np.uint32),
                    n_unique=int(lo.shape[0]))

    def occ_at_chunk(self, rows: np.ndarray, sel: np.ndarray) -> np.ndarray:
        """Window occurrences of the sel-th (1-based) in-chunk appearance of
        the given unique-key rows of the last finalize_chunk."""
        dev = self._chunk_occs.device
        r = torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(dev)
        s = torch.from_numpy(np.asarray(sel, dtype=np.int64) - 1).to(dev)
        return self._chunk_occs[r, s].cpu().numpy().astype(np.uint32)

    def _occs(self, occs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(occs, dtype=np.int64)).to(
            self.buffers[0].device)

    def gather_crossing(self, occs: np.ndarray):
        """(canonical vec u64 [n, k], meta u32 [n, 5 or 6], n_clipped) for
        chunk-local window occurrences, gathered on the device; n_clipped
        counts rows whose extent corrections were clipped to 16 bits (0
        without the extent plane, where meta has five columns)."""
        vec, meta, n_clipped = gather_window_meta(
            self.buffers[3], self.buffers[4], self._occs(occs), k=self.k,
            M=self.M, b_mpe=self.buffers[5] if self._n_fin > 5 else None)
        return u64.to_numpy(vec), _u32_to_numpy(meta), int(n_clipped)

    def gather_crossing_keys_dev(self, occs: np.ndarray):
        """Recompute-mode gather (five-plane counters): (gk int64 [n, 8],
        gflag uint8 [n], meta u32 [n, 5], mpos u32 [n, k]).  The overlap
        fingerprints stay on the device, for a DeviceKeyCatalog append;
        meta and mpos come to the host, where the .sequences writer needs
        them now."""
        vec, meta, _, mpos = gather_window_meta(
            self.buffers[3], self.buffers[4], self._occs(occs), k=self.k,
            M=self.M, with_record_pos=True)
        gk, gflag = overlap_keys_device(vec)
        return gk, gflag, _u32_to_numpy(meta), _u32_to_numpy(mpos)

    def gather_crossing_keys(self, occs: np.ndarray):
        """gather_crossing_keys_dev with gk (u64 [n, 8]) and gflag fetched
        to the host as well: 65 B/node of fingerprints instead of the
        8k B/node vectors, for the host edge join."""
        gk, gflag, meta, mpos = self.gather_crossing_keys_dev(occs)
        return u64.to_numpy(gk), gflag.cpu().numpy(), meta, mpos

    def reset_chunk(self):
        """Refill the key planes with the empty sentinel (stale occ/mh/mp
        rows are unreachable: gathers only follow valid keys)."""
        self._chunk_occs = None
        self.buffers[0].fill_(u64.SENTINEL)
        self.buffers[1].fill_(u64.SENTINEL)
