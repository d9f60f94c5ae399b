"""Hand-written Hopper kernels and their plain torch versions.

Counterpart of rust_mdbg_tpu/ops/pallas_kernels.py.  Each kernel has:

- a CUDA C++ source under `csrc/`, compiled by nvcc for sm_90a into
  `csrc/build/` on first use and loaded with ctypes;
- a plain torch version of the same function in this module, used for CPU
  tensors (the CPU tests) and as the reference `chip_smoke.py` holds the
  kernel against on the card;
- a wrapper that launches the kernel for CUDA tensors (or raises) and takes
  the plain version only for CPU tensors, counting its launches in the
  wrapper's `launches` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import subprocess
import threading
import time

import torch

from . import u64
from .align import semiglobal_scores_plain
from .kminmer import poly_fp_tables
from .nthash import nthash_windows
from .poa_device import poa_dp_plain
from .syncmers_device import syncmer_planes

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

#: kernel name -> CUDA source file under csrc/
SOURCES = {"nthash_select": "nthash_select.cu",
           "syncmer_select": "syncmer_select.cu",
           "semiglobal_scores": "semiglobal_scores.cu",
           "poa_dp": "poa_dp.cu",
           "compact_minimizers": "compact_minimizers.cu",
           "window_keys": "window_keys.cu"}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _so_path(name)
    src = os.path.join(CSRC, SOURCES[name])
    return not os.path.exists(so) or os.path.getmtime(src) > os.path.getmtime(so)


def build_all(names=None) -> dict:
    """Compile the named kernels (all by default) that are missing or stale,
    one nvcc per source, all started together.  Returns {name: (seconds,
    compiler output)}; raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        tmp = _so_path(name) + f".{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    out = {}
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, _so_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


#: C entry points of each library: name -> argument types (a launch returns
#: int, its cudaGetLastError()), or (argument types, return type)
_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY_POINTS = {
    "nthash_select": {
        "nthash_select_launch":
            [_P] * 4 + [_I] * 3 + [ctypes.c_ulonglong, _P],
    },
    "syncmer_select": {
        "syncmer_select_launch":
            [_P] * 4 + [_I] * 4 + [ctypes.c_ulonglong, _P],
    },
    "semiglobal_scores": {
        "semiglobal_scores_launch":
            [_P, _I, _P, _P, _I, _I, _P, _P] + [_I] * 5 + [_P],
    },
    "poa_dp": {
        "poa_dp_launch": [_P] * 17 + [_I] * 7 + [_P],
    },
    "compact_minimizers": {
        "compact_minimizers_launch": [_P] * 9 + [_I] * 5 + [_P],
    },
    "window_keys": {
        "window_keys_launch": [_P, _P] + [_I] * 3 + [_P] * 4
                              + [ctypes.c_longlong] * 2 + [_P] * 3,
    },
}


def _lib(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_so_path(name))
            for fn, sig in _ENTRY_POINTS[name].items():
                argtypes, restype = (sig if isinstance(sig, tuple)
                                     else (sig, ctypes.c_int))
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def _check_cuda(t: torch.Tensor, dtype, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# --- nthash_select ----------------------------------------------------------

def nthash_select_plain(codes: torch.Tensor, l: int, hash_bound: int,
                        lengths: torch.Tensor):
    """Plain torch version: (canon int64 [B, L] u64 bits, sel bool [B, L])."""
    fh, rh = nthash_windows(codes, l)
    canon = u64.minimum(fh, rh)
    idx = torch.arange(codes.shape[1], device=codes.device)
    valid = idx[None, :] + l <= lengths[:, None]
    return canon, u64.le(canon, hash_bound) & valid


def nthash_select(codes: torch.Tensor, l: int, hash_bound: int,
                  lengths: torch.Tensor):
    """Canonical ntHash + density selection over a code batch.

    codes uint8 [B, L], lengths int32 [B] (HPC lengths).  Returns
    (canon int64 [B, L] holding u64 bits, sel bool [B, L]).  CPU tensors take
    the plain version; CUDA tensors launch csrc/nthash_select.cu."""
    if codes.device.type == "cpu":
        return nthash_select_plain(codes, l, hash_bound, lengths)
    _check_cuda(codes, torch.uint8, "codes")
    _check_cuda(lengths, torch.int32, "lengths")
    if codes.dim() != 2 or lengths.shape != (codes.shape[0],):
        raise ValueError(f"bad shapes {tuple(codes.shape)} / "
                         f"{tuple(lengths.shape)}")
    if lengths.device != codes.device:
        raise ValueError("codes and lengths on different devices")
    B, L = codes.shape
    canon = torch.empty((B, L), dtype=torch.int64, device=codes.device)
    sel = torch.empty((B, L), dtype=torch.bool, device=codes.device)
    lib = _lib("nthash_select")
    # the runtime launches on the current device: make it the tensors'
    with torch.cuda.device(codes.device):
        err = lib.nthash_select_launch(
            codes.data_ptr(), lengths.data_ptr(), canon.data_ptr(),
            sel.data_ptr(), B, L, l, hash_bound & ((1 << 64) - 1),
            _stream(codes.device))
    if err != 0:
        raise RuntimeError(f"nthash_select launch failed: CUDA error {err}")
    nthash_select.launches += 1
    return canon, sel


nthash_select.launches = 0


# --- syncmer_select -----------------------------------------------------------

#: the incumbent before the first column: below every position
INC_START = -(1 << 30)


def syncmer_incumbent_plain(lpos: torch.Tensor, rpos: torch.Tensor,
                            run_start: torch.Tensor,
                            strict_new: torch.Tensor) -> torch.Tensor:
    """The incumbent trace of the open-syncmer sliding minimum, column by
    column with a [B] carry: inc[a] = run_start[a] ? lpos[a] :
    ((strict_new[a] or inc[a-1] < a) ? rpos[a] : inc[a-1]), inc[-1] =
    INC_START.  lpos, rpos int32 [B, L]; run_start, strict_new bool."""
    B, L = lpos.shape
    inc = torch.full((B,), INC_START, dtype=torch.int32, device=lpos.device)
    out = torch.empty_like(lpos)
    for a in range(L):
        inc = torch.where(run_start[:, a], lpos[:, a],
                          torch.where(strict_new[:, a] | (inc < a),
                                      rpos[:, a], inc))
        out[:, a] = inc
    return out


def syncmer_select_plain(hpc_codes: torch.Tensor, hpc_len: torch.Tensor, *,
                         l: int, s: int, bound: int):
    """Plain torch version: the planes of syncmers_device.syncmer_planes,
    then the column scan syncmer_incumbent_plain and the selection."""
    pl = syncmer_planes(hpc_codes, hpc_len, l=l, s=s, bound=bound)
    hl, valid_l, passed = pl["hl"], pl["valid_l"], pl["passed"]
    if s == 0:
        # "kminmer" mode (read.rs:324-339): every N-free l-mer, density only
        return hl, valid_l & passed
    t = math.ceil((l - s + 1) / 2.0)
    inc = syncmer_incumbent_plain(pl["lpos"], pl["rpos"], pl["run_start"],
                                  pl["strict_new"])
    idx = torch.arange(hl.shape[1], dtype=torch.int32, device=hl.device)
    return hl, valid_l & (inc == idx[None, :] + (t - 1)) & passed


def syncmer_select(hpc_codes: torch.Tensor, hpc_len: torch.Tensor, *, l: int,
                   s: int, bound: int):
    """Canonical l-mer hash + open-syncmer selection over HPC codes.

    hpc_codes uint8 [B, L], hpc_len int32 [B].  Returns (hl int64 [B, L]
    holding u64 bits, sel bool [B, L]): hl the invertible hash of the
    canonical 2-bit l-mer (all ones where the window holds an N or runs past
    the length), sel the open-syncmer selection (s > 0) or the density pass
    (s == 0) of ops/syncmers_device.  CPU tensors take the plain version;
    CUDA tensors launch csrc/syncmer_select.cu (l <= 32)."""
    if hpc_codes.device.type == "cpu":
        return syncmer_select_plain(hpc_codes, hpc_len, l=l, s=s, bound=bound)
    _check_cuda(hpc_codes, torch.uint8, "hpc_codes")
    _check_cuda(hpc_len, torch.int32, "hpc_len")
    if hpc_codes.dim() != 2 or hpc_len.shape != (hpc_codes.shape[0],):
        raise ValueError(f"bad shapes {tuple(hpc_codes.shape)} / "
                         f"{tuple(hpc_len.shape)}")
    if hpc_len.device != hpc_codes.device:
        raise ValueError("hpc_codes and hpc_len on different devices")
    if not (1 <= l <= 32 and 0 <= s <= l):
        raise ValueError(f"syncmer_select takes 1 <= l <= 32 and "
                         f"0 <= s <= l, got l={l}, s={s}")
    B, L = hpc_codes.shape
    hl = torch.empty((B, L), dtype=torch.int64, device=hpc_codes.device)
    sel = torch.empty((B, L), dtype=torch.bool, device=hpc_codes.device)
    lib = _lib("syncmer_select")
    with torch.cuda.device(hpc_codes.device):
        err = lib.syncmer_select_launch(
            hpc_codes.data_ptr(), hpc_len.data_ptr(), hl.data_ptr(),
            sel.data_ptr(), B, L, l, s, bound & ((1 << 64) - 1),
            _stream(hpc_codes.device))
    if err != 0:
        raise RuntimeError(f"syncmer_select launch failed: CUDA error {err}")
    syncmer_select.launches += 1
    return hl, sel


syncmer_select.launches = 0


# --- compact_minimizers -------------------------------------------------------

#: columns of a chunk of the two-level compaction
COMPACT_CHUNK = 512


def chunk_slot_capacity(hash_bound: int, chunk: int = COMPACT_CHUNK) -> int:
    """Per-chunk slot count for two-level compaction: selection rate ~= 2x
    density, +8 binomial sigmas, rounded up to a multiple of 8, clamped to
    [16, 256].  Chunks exceeding this set the overflow flag."""
    rate = min(1.0, 2.0 * hash_bound / 2.0 ** 64)
    expect = chunk * rate
    sigma = math.sqrt(max(1.0, expect * (1.0 - rate)))
    c = int(expect + 8 * sigma + 4)
    return max(16, min(256, (c + 7) & ~7))


def compaction_two_level(L: int, M: int) -> bool:
    """The JAX package's rule for the two-level branch (L % 512 == 0 and L >
    2048), and M != L: a chunk re-planned to keep every position
    (core/chunked.doubled_plan) takes the flat branch, which has no
    per-chunk cap, so that the overflow flag stays clear."""
    return L % COMPACT_CHUNK == 0 and L > 2048 and M != L


def compact_positions_plain(sel: torch.Tensor, hash_bound: int, M: int):
    """First M selected positions per row (ascending; L where absent) and
    the overflow flag, by the same two compaction branches as the JAX
    package: two-level per-512-chunk sorts (compaction_two_level), one
    flat row sort otherwise."""
    B, L = sel.shape
    dev = sel.device
    n_min_raw = sel.sum(dim=1, dtype=torch.int32)
    if compaction_two_level(L, M):
        C = chunk_slot_capacity(hash_bound)
        nch = L // COMPACT_CHUNK
        selc = sel.reshape(B * nch, COMPACT_CHUNK)
        iot = torch.arange(COMPACT_CHUNK, dtype=torch.int32, device=dev)
        sck = torch.sort(torch.where(selc, iot, COMPACT_CHUNK), dim=1).values
        base = (torch.arange(B * nch, dtype=torch.int32, device=dev)
                % nch)[:, None] * COMPACT_CHUNK
        cval = torch.where(sck == COMPACT_CHUNK, L, sck + base)
        l2s = torch.sort(cval[:, :C].reshape(B, nch * C), dim=1).values
        if nch * C < M:
            l2s = torch.cat([l2s, torch.full((B, M - nch * C), L,
                                             dtype=l2s.dtype, device=dev)],
                            dim=1)
        chunk_over = (selc.sum(dim=1) > C).reshape(B, nch).any(dim=1)
        overflow = (n_min_raw > M) | chunk_over
        first = l2s[:, :M]
    else:
        iot = torch.arange(L, dtype=torch.int32, device=dev)
        first = torch.sort(torch.where(sel, iot, L), dim=1).values[:, :M]
        overflow = n_min_raw > M
    return first, torch.clamp(n_min_raw, max=M), overflow


def compact_minimizers_plain(sel: torch.Tensor, canon: torch.Tensor,
                             pos_map: torch.Tensor | None = None,
                             pme: torch.Tensor | None = None, *,
                             hash_bound: int, M: int):
    """Plain torch version: compact_positions_plain, then the gathers of
    canon, pos_map (the column itself without one) and pme at the first M
    positions (L - 1 where a position is absent), zero past n_min."""
    L = sel.shape[1]
    first, n_min, overflow = compact_positions_plain(sel, hash_bound, M)
    perm_m = torch.clamp(first, max=L - 1).long()
    in_m = torch.arange(M, device=sel.device)[None, :] < n_min[:, None]
    minim_hash = torch.where(in_m, torch.gather(canon, 1, perm_m), 0)
    if pos_map is None:  # a minimizer's position is its column
        minim_pos = torch.where(in_m, perm_m.to(torch.int32), 0)
    else:
        minim_pos = torch.where(in_m, torch.gather(pos_map, 1, perm_m), 0)
    mpe = (None if pme is None
           else torch.where(in_m, torch.gather(pme, 1, perm_m), 0))
    return minim_hash, minim_pos, mpe, n_min, overflow


def compact_minimizers_launcher(sel: torch.Tensor, canon: torch.Tensor,
                                pos_map: torch.Tensor | None = None,
                                pme: torch.Tensor | None = None, *,
                                hash_bound: int, M: int):
    """Checks one launch of csrc/compact_minimizers.cu (CUDA tensors),
    allocates its outputs and returns (launch, outputs): launch() runs the
    kernel on them (no allocation, no host sync, no count) and raises if
    the launch fails.  The outputs are compact_minimizers'."""
    _check_cuda(sel, torch.bool, "sel")
    _check_cuda(canon, torch.int64, "canon")
    if sel.dim() != 2 or canon.shape != sel.shape:
        raise ValueError(f"bad shapes {tuple(sel.shape)} / "
                         f"{tuple(canon.shape)}")
    for t, name in ((pos_map, "pos_map"), (pme, "pme")):
        if t is not None:
            _check_cuda(t, torch.int32, name)
            if t.shape != sel.shape:
                raise ValueError(f"{name} of shape {tuple(t.shape)} for "
                                 f"{tuple(sel.shape)}")
    if any(t is not None and t.device != sel.device
           for t in (canon, pos_map, pme)):
        raise ValueError("compact_minimizers' inputs on different devices")
    if M < 1:
        raise ValueError(f"compact_minimizers needs M >= 1, got {M}")
    B, L = sel.shape
    dev = sel.device
    two_level = compaction_two_level(L, M)
    C = chunk_slot_capacity(hash_bound) if two_level else COMPACT_CHUNK
    outs = (torch.empty((B, M), dtype=torch.int64, device=dev),
            torch.empty((B, M), dtype=torch.int32, device=dev),
            None if pme is None
            else torch.empty((B, M), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev))
    lib = _lib("compact_minimizers")
    args = tuple(None if t is None else t.data_ptr()
                 for t in (sel, canon, pos_map, pme) + outs) + (
        B, L, M, C, int(two_level), _stream(dev))

    def launch():
        with torch.cuda.device(dev):
            err = lib.compact_minimizers_launch(*args)
        if err != 0:
            raise RuntimeError(f"compact_minimizers launch failed: CUDA "
                               f"error {err}")

    return launch, outs


def compact_minimizers(sel: torch.Tensor, canon: torch.Tensor,
                       pos_map: torch.Tensor | None = None,
                       pme: torch.Tensor | None = None, *, hash_bound: int,
                       M: int):
    """Ordered compaction of the selected minimizers of a batch into [B, M]
    rows, with their gathers: the compaction of the JAX package's
    `_device_extract` (two-level when compaction_two_level(L, M), with
    chunk_slot_capacity(hash_bound) slots a chunk; flat otherwise).

    sel bool [B, L], canon int64 [B, L] (u64 bits), pos_map and pme int32
    [B, L] or None.  Returns (minim_hash int64 [B, M], minim_pos int32
    [B, M], mpe int32 [B, M] or None, n_min int32 [B], overflow bool [B]).
    CPU tensors take the plain version; CUDA tensors launch
    csrc/compact_minimizers.cu."""
    if sel.device.type == "cpu":
        return compact_minimizers_plain(sel, canon, pos_map, pme,
                                        hash_bound=hash_bound, M=M)
    launch, outs = compact_minimizers_launcher(
        sel, canon, pos_map, pme, hash_bound=hash_bound, M=M)
    launch()
    compact_minimizers.launches += 1
    return outs


compact_minimizers.launches = 0


# --- window_keys ----------------------------------------------------------------

#: shared memory of a window_keys block: (256 + k - 1) words, at most 48 KB
WINDOW_KEYS_MAX_K = 48 * 1024 // 8 - 255


@functools.lru_cache(maxsize=None)
def _poly_tables_cached(k: int, M: int):
    return poly_fp_tables(k, M)


def window_keys_poly_plain(mh: torch.Tensor, k: int, M: int) -> torch.Tensor:
    """Canonical 128-bit window fingerprints [B, W, 2] from the compacted
    minimizer rows mh [B, M] via prefix sums (no [B, W, k] tensor), every
    window, valid or not: the JAX package's `_window_keys_poly`.  Equals
    fingerprint128(canonicalize(window)) exactly; sums wrap mod 2^64."""
    W = M - k + 1
    tables = _poly_tables_cached(k, M)
    dev = mh.device

    # KmerVec::normalize reversal flag: lexicographic first difference of
    # v[w+j] vs v[w+k-1-j]; palindromes report True
    rev_flag = torch.ones(mh.shape[:-1] + (W,), dtype=torch.bool, device=dev)
    for j in range(k - 1, -1, -1):
        a = mh[..., j : j + W]
        b = mh[..., k - 1 - j : k - 1 - j + W]
        rev_flag = torch.where(a != b, u64.gt(a, b), rev_flag)

    zero = torch.zeros(mh.shape[:-1] + (1,), dtype=torch.int64, device=dev)
    lanes = []
    for lane in (0, 1):
        t = tables[lane]
        apow = u64.from_numpy(t["apow"], dev)
        ainvpow = u64.from_numpy(t["ainvpow"], dev)
        off_ak = u64.s64(int(t["off_ak"]))
        S = torch.cat([zero, torch.cumsum(mh * ainvpow[:M], dim=-1)], dim=-1)
        T = torch.cat([zero, torch.cumsum(mh * apow[:M], dim=-1)], dim=-1)
        fwd = off_ak + apow[k - 1 : k - 1 + W] * (S[..., k : k + W] - S[..., :W])
        rev = off_ak + ainvpow[:W] * (T[..., k : k + W] - T[..., :W])
        lanes.append(torch.where(rev_flag, rev, fwd))
    return torch.stack(lanes, dim=-1)


def windows_per_read(n_min: torch.Tensor, k: int) -> torch.Tensor:
    """Valid windows of each read, a prefix of its row: n_min - k + 1 where
    n_min > k, else 0 (int32)."""
    return torch.where(n_min > k, n_min - k + 1, 0).to(torch.int32)


def window_keys_plain(mh: torch.Tensor, n_min: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Plain torch version of the keys plane: window_keys_poly_plain, the
    all-ones sentinel where a window is not valid (w >= n_min - k + 1, or
    n_min <= k)."""
    M = mh.shape[1]
    W = M - k + 1
    widx = torch.arange(W, device=mh.device)
    valid_w = (n_min[:, None] > k) & (widx[None, :] < n_min[:, None] - k + 1)
    return torch.where(valid_w[..., None], window_keys_poly_plain(mh, k, M),
                       u64.SENTINEL)


def slot_append_plain(keys: torch.Tensor, nw: torch.Tensor, b_lo, b_hi,
                      b_occ, *, row0: int, slot0: int, S: int, n_win, n_over):
    """Plain torch version of the batch-slot append: valid windows are a
    per-read prefix, so output position p of the slot maps to (row, w) by
    the rank of p in the cumulative per-read window counts.  keys [B, W, 2]
    (window_keys_plain), nw int32 [B]; writes b_lo, b_hi, b_occ [slot0,
    slot0 + S) (occ = (row0 + row) * W + w, u32) and adds min(nv, S) to
    n_win and nv > S to n_over (device scalars), in place."""
    B, W = keys.shape[:2]
    dev = keys.device
    pos = torch.arange(S, device=dev)
    keys_flat = keys.reshape(B * W, 2)
    offs = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(nw, dim=0)
    nv = offs[B]
    row = torch.clamp(torch.searchsorted(offs[1:], pos, right=True),
                      max=B - 1)
    w = pos - offs[row]
    valid = pos < torch.clamp(nv, max=S)
    src = torch.clamp(row * W + w, 0, B * W - 1)
    b_lo[slot0 : slot0 + S] = torch.where(valid, keys_flat[src, 0],
                                          u64.SENTINEL)
    b_hi[slot0 : slot0 + S] = torch.where(valid, keys_flat[src, 1],
                                          u64.SENTINEL)
    b_occ[slot0 : slot0 + S] = torch.where(
        valid, ((row0 + row) * W + w) & u64.U32_MAX, u64.U32_MAX)
    n_over += nv > S
    n_win += torch.clamp(nv, max=S)


def window_keys_launcher(mh: torch.Tensor, n_min: torch.Tensor, k: int,
                         append: dict | None = None):
    """Checks one launch of csrc/window_keys.cu (CUDA tensors) and returns
    (launch, keys): launch() runs the kernel (no allocation, no host sync,
    no count) and raises if the launch fails.  Without `append`, mode i:
    keys is the [B, W, 2] plane allocated here.  With `append` (the
    keywords of window_keys_append: b_lo, b_hi, b_occ, row0, slot0, S,
    n_win, n_over), mode ii into those tensors: keys is None."""
    _check_cuda(mh, torch.int64, "mh")
    _check_cuda(n_min, torch.int32, "n_min")
    if mh.dim() != 2 or n_min.shape != (mh.shape[0],):
        raise ValueError(f"bad shapes {tuple(mh.shape)} / "
                         f"{tuple(n_min.shape)}")
    if n_min.device != mh.device:
        raise ValueError("mh and n_min on different devices")
    B, M = mh.shape
    if not 1 <= k <= min(M, WINDOW_KEYS_MAX_K):
        raise ValueError(f"window_keys takes 1 <= k <= min(M, "
                         f"{WINDOW_KEYS_MAX_K}), got k={k}, M={M}")
    dev = mh.device
    keys = None
    if append is None:
        keys = torch.empty((B, M - k + 1, 2), dtype=torch.int64, device=dev)
        planes = (keys.data_ptr(), None, None, None, 0, 0, None, None)
    else:
        a = append
        for name in ("b_lo", "b_hi", "b_occ", "n_win", "n_over"):
            _check_cuda(a[name], torch.int64, name)
            if a[name].device != dev:
                raise ValueError(f"{name} on {a[name].device}, mh on {dev}")
        if a["n_win"].numel() != 1 or a["n_over"].numel() != 1:
            raise ValueError("n_win and n_over must be scalars")
        slot0, S = a["slot0"], a["S"]
        if not (all(a[n].dim() == 1 and slot0 + S <= a[n].shape[0]
                    for n in ("b_lo", "b_hi", "b_occ")) and slot0 >= 0):
            raise ValueError(f"slot [{slot0}, {slot0 + S}) outside the "
                             f"buffers")
        planes = (None,) + tuple(a[n].data_ptr() + 8 * slot0
                                 for n in ("b_lo", "b_hi", "b_occ")) + (
            a["row0"], S, a["n_win"].data_ptr(), a["n_over"].data_ptr())
    lib = _lib("window_keys")
    args = (mh.data_ptr(), n_min.data_ptr(), B, M, k) + planes + (
        _stream(dev),)

    def launch():
        with torch.cuda.device(dev):
            err = lib.window_keys_launch(*args)
        if err != 0:
            raise RuntimeError(f"window_keys launch failed: CUDA error "
                               f"{err}")

    return launch, keys


def window_keys(mh: torch.Tensor, n_min: torch.Tensor,
                k: int) -> torch.Tensor:
    """Canonical 128-bit keys of every window of k consecutive minimizers,
    the all-ones sentinel where the window is not valid: the JAX package's
    `_window_keys_poly` and the sentinel `where` of its count path.

    mh int64 [B, M] (u64 bits), n_min int32 [B].  Returns int64 [B, M - k +
    1, 2].  CPU tensors take the plain version; CUDA tensors launch
    csrc/window_keys.cu (mode i)."""
    if mh.device.type == "cpu":
        return window_keys_plain(mh, n_min, k)
    launch, keys = window_keys_launcher(mh, n_min, k)
    launch()
    window_keys.launches += 1
    return keys


window_keys.launches = 0


def window_keys_append(mh: torch.Tensor, n_min: torch.Tensor, k: int, b_lo,
                       b_hi, b_occ, *, row0: int, slot0: int, S: int, n_win,
                       n_over):
    """The batch's window keys appended to the counter's batch slot: each
    valid window's key and occ = ((row0 + b) * W + w) & 0xFFFFFFFF at slot
    slot0 + offs[b] + w (offs the exclusive sum of the valid windows over
    the batch's rows), [min(nv, S), S) of the slot emptied, min(nv, S)
    added to n_win and nv > S to n_over (int64 device scalars), all in
    place: the batch-slot compaction of the JAX package's
    `make_fused_construct`.

    mh int64 [B, M], n_min int32 [B]; b_lo, b_hi, b_occ int64 [N] with
    slot0 + S <= N.  CPU tensors take the plain version (window_keys_plain,
    slot_append_plain); CUDA tensors launch csrc/window_keys.cu (mode ii),
    which counts on window_keys.launches."""
    kw = dict(row0=row0, slot0=slot0, S=S, n_win=n_win, n_over=n_over)
    if mh.device.type == "cpu":
        slot_append_plain(window_keys_plain(mh, n_min, k),
                          windows_per_read(n_min, k), b_lo, b_hi, b_occ,
                          **kw)
        return
    launch, _ = window_keys_launcher(
        mh, n_min, k, dict(b_lo=b_lo, b_hi=b_hi, b_occ=b_occ, **kw))
    launch()
    window_keys.launches += 1


# --- planning of the two EC kernels ------------------------------------------

#: strip widths the EC kernels are built for: columns a lane holds
STRIPS = (1, 2, 4, 6, 8, 9, 10, 11, 12, 16)
#: shared memory a block may have on an H100 (227 KB)
SMEM_PER_BLOCK = 232_448
#: POA DP: rows of the shared-memory ring (the rest are read from global)
POA_RING_ROWS = 16
#: POA DP: bytes of one step's metadata, and of the 32 in shared memory
POA_STEP_META = 64
POA_META_BYTES = 32 * POA_STEP_META
#: scorer: queries a block
SCORES_WARPS = 4
#: the POA DP packs pred + 1 above 2 bits of kind in an int32 word
POA_MAX_NODES = 1 << 29


def strip_for(width: int) -> int:
    """The narrowest strip whose warp (32 lanes) covers `width` columns;
    the widest strip when none does (the kernel then walks register tiles
    of 32 x 16 columns)."""
    for c in STRIPS:
        if 32 * c >= width:
            return c
    return STRIPS[-1]


def semiglobal_scores_plan(B: int, T: int, Q: int) -> dict:
    """Launch plan of csrc/semiglobal_scores.cu: the strip (from the padded
    width Q + 1), queries a block, blocks, and the int32 count of the tile
    boundary scratch (2 x (T + 1) a query, only when Q + 1 needs more than
    one register tile)."""
    strip = strip_for(Q + 1)
    warps = max(1, min(SCORES_WARPS, B))
    tiles = -(-(Q + 1) // (32 * strip))
    return dict(strip=strip, warps=warps, blocks=-(-B // warps),
                tiles=tiles, scratch=2 * (T + 1) * B if tiles > 1 else 0)


def poa_dp_plan(n_max: int, m_max: int,
                ring_rows: int | None = None) -> dict:
    """Launch plan of csrc/poa_dp.cu (one warp a pair and a block) for
    pairs of at most n_max nodes and m_max query symbols: the strip, the
    words a matrix row (Wp, whole register tiles), the shared-memory ring
    (rows R: a power of two, at most `ring_rows`, that fits a block's
    shared memory; 0 sends every predecessor read to global), whether the
    global score matrix is needed (some pair has n > R), and the block's
    shared memory."""
    if not 0 < n_max < POA_MAX_NODES:
        raise ValueError(f"poa_dp takes 1 <= n < 2^29 nodes a pair, got "
                         f"{n_max}")
    strip = strip_for(m_max + 1)
    tile = 32 * strip
    Wp = -(-(m_max + 1) // tile) * tile
    want = POA_RING_ROWS if ring_rows is None else ring_rows
    fit = (SMEM_PER_BLOCK - POA_META_BYTES) // (4 * Wp)
    cap = min(want, fit)
    R = 1 << (cap.bit_length() - 1) if cap >= 2 else 0
    return dict(strip=strip, Wp=Wp, ring=R, far=n_max > R,
                smem=POA_META_BYTES + 4 * R * Wp)


# --- semiglobal_scores --------------------------------------------------------

def semiglobal_scores_launcher(template: torch.Tensor, queries: torch.Tensor,
                               qlens: torch.Tensor, *, gap: int = -1,
                               match: int = 1, mismatch: int = -1):
    """Checks and plans one launch of csrc/semiglobal_scores.cu (CUDA
    tensors), allocates its output and scratch, and returns (launch, out,
    plan): launch() runs the kernel on them (no allocation, no host sync,
    no count) and raises if the launch fails."""
    _check_cuda(template, torch.int64, "template")
    _check_cuda(queries, torch.int64, "queries")
    _check_cuda(qlens, torch.int32, "qlens")
    if (template.dim() != 1 or queries.dim() != 2
            or qlens.shape != (queries.shape[0],)):
        raise ValueError(f"bad shapes {tuple(template.shape)} / "
                         f"{tuple(queries.shape)} / {tuple(qlens.shape)}")
    if not template.device == queries.device == qlens.device:
        raise ValueError("template, queries and qlens on different devices")
    B, Q = queries.shape
    T = template.shape[0]
    if B:
        lo, hi = torch.stack(torch.aminmax(qlens)).tolist()
        if not 0 <= lo <= hi <= Q:
            raise ValueError(f"qlens outside [0, {Q}]")
    plan = semiglobal_scores_plan(B, T, Q)
    out = torch.empty(B, dtype=torch.int32, device=queries.device)
    scratch = (torch.empty(plan["scratch"], dtype=torch.int32,
                           device=queries.device)
               if plan["scratch"] else None)
    lib = _lib("semiglobal_scores")
    args = (template.data_ptr(), T, queries.data_ptr(), qlens.data_ptr(), B,
            Q, out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            plan["strip"], plan["warps"], gap, match, mismatch,
            _stream(queries.device))

    def launch():
        with torch.cuda.device(queries.device):
            err = lib.semiglobal_scores_launch(*args)
        if err != 0:
            raise RuntimeError(f"semiglobal_scores launch failed: CUDA "
                               f"error {err}")

    launch.keep = (scratch,)
    return launch, out, plan


def semiglobal_scores(template: torch.Tensor, queries: torch.Tensor,
                      qlens: torch.Tensor, *, gap: int = -1, match: int = 1,
                      mismatch: int = -1) -> torch.Tensor:
    """Semiglobal score of each query against the linear template (free
    start in the template, the query consumed whole).

    template int64 [T], queries int64 [B, Q] (u64 bits), qlens int32 [B]
    (0 <= qlens <= Q).  Returns int32 [B].  CPU tensors take the plain
    version (ops/align.semiglobal_scores_plain); CUDA tensors launch
    csrc/semiglobal_scores.cu."""
    if queries.device.type == "cpu":
        return semiglobal_scores_plain(template, queries, qlens, gap=gap,
                                       match=match, mismatch=mismatch)
    launch, out, _ = semiglobal_scores_launcher(
        template, queries, qlens, gap=gap, match=match, mismatch=mismatch)
    launch()
    semiglobal_scores.launches += 1
    return out


semiglobal_scores.launches = 0


# --- poa_dp -------------------------------------------------------------------

def poa_dp_launcher(node_off: torch.Tensor, wts: torch.Tensor,
                    topo: torch.Tensor, pred_off: torch.Tensor,
                    pred_idx: torch.Tensor, term: torch.Tensor,
                    q_off: torch.Tensor, queries: torch.Tensor, *,
                    ge: int = -1, match: int = 1, mismatch: int = -1,
                    ring_rows: int | None = None,
                    count_routes: bool = False):
    """Checks and plans one launch of csrc/poa_dp.cu (CUDA tensors in
    export_batch's layout), allocates its outputs and scratch, and returns
    (launch, (best, ystart, nops, ops), plan): launch() runs the kernel on
    them (no allocation, no host sync, no count) and raises if the launch
    fails.  `ring_rows` caps the shared-memory ring (0: every predecessor
    row from global memory); the result does not depend on it.  With
    `count_routes`, launch.routes is an int32 [3] that each launch adds
    its predecessor reads to, by the route the kernel took (registers,
    ring, global).

    The matrix scratch is (Ntot + G) rows of Wp int32 words (twice that
    when some pair has n > R), Wp set by the batch's widest query: a
    batch that puts one long query beside many long graphs pays max(m)
    columns for every node (112 pairs of 330 nodes beside one query of
    5,000 symbols: about 1.5 GB).  The EC legs' batches have m <= 349."""
    for t, dtype, name in ((node_off, torch.int32, "node_off"),
                           (wts, torch.int64, "wts"),
                           (topo, torch.int32, "topo"),
                           (pred_off, torch.int32, "pred_off"),
                           (pred_idx, torch.int32, "pred_idx"),
                           (term, torch.uint8, "term"),
                           (q_off, torch.int32, "q_off"),
                           (queries, torch.int64, "queries")):
        _check_cuda(t, dtype, name)
        if t.device != wts.device or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D on {wts.device}")
    G = node_off.shape[0] - 1
    dev = wts.device
    ntot, mtot = wts.shape[0], queries.shape[0]
    if (topo.shape[0] != ntot or term.shape[0] != ntot
            or pred_off.shape[0] != ntot + 1 or q_off.shape[0] != G + 1):
        raise ValueError("inconsistent poa_dp batch: topo, term, pred_off "
                         "one entry a node, q_off one a pair")
    best = torch.empty(G, dtype=torch.int32, device=dev)
    ystart = torch.empty(G, dtype=torch.int32, device=dev)
    nops = torch.empty(G, dtype=torch.int32, device=dev)
    ops = torch.empty((ntot + mtot + G, 3), dtype=torch.int32, device=dev)
    outs = (best, ystart, nops, ops)
    if G <= 0:
        return (lambda: None), outs, None
    n = node_off[1:] - node_off[:-1]
    m = q_off[1:] - q_off[:-1]
    n_min, n_max, m_min, m_max, n_first, q_first, n_last, q_last = \
        torch.stack([n.min(), n.max(), m.min(), m.max(), node_off[0],
                     q_off[0], node_off[-1], q_off[-1]]).tolist()
    if (n_min < 1 or m_min < 0 or n_first != 0 or q_first != 0
            or n_last != ntot or q_last != mtot):
        raise ValueError("inconsistent poa_dp batch: every pair needs a "
                         "node, and the offsets run from 0 to the totals")
    plan = poa_dp_plan(n_max, m_max, ring_rows)
    cells = (ntot + G) * plan["Wp"]
    words = torch.empty(cells, dtype=torch.int32, device=dev)
    score = (torch.empty(cells, dtype=torch.int32, device=dev)
             if plan["far"] else None)
    rank = torch.empty(ntot, dtype=torch.int32, device=dev)
    meta = torch.empty((ntot, POA_STEP_META // 4), dtype=torch.int32,
                       device=dev)
    routes = (torch.zeros(3, dtype=torch.int32, device=dev)
              if count_routes else None)
    lib = _lib("poa_dp")
    args = (node_off.data_ptr(), wts.data_ptr(), topo.data_ptr(),
            pred_off.data_ptr(), pred_idx.data_ptr(), term.data_ptr(),
            q_off.data_ptr(), queries.data_ptr(), rank.data_ptr(),
            meta.data_ptr(), score.data_ptr() if score is not None else None,
            words.data_ptr(),
            routes.data_ptr() if routes is not None else None,
            best.data_ptr(), ystart.data_ptr(), nops.data_ptr(),
            ops.data_ptr(), G, plan["strip"], plan["Wp"], plan["ring"], ge,
            match, mismatch, _stream(dev))

    def launch():
        with torch.cuda.device(dev):
            err = lib.poa_dp_launch(*args)
        if err != 0:
            raise RuntimeError(f"poa_dp launch failed: CUDA error {err}")

    launch.keep = (words, score, rank, meta)
    launch.routes = routes
    return launch, outs, plan


def poa_dp(node_off: torch.Tensor, wts: torch.Tensor, topo: torch.Tensor,
           pred_off: torch.Tensor, pred_idx: torch.Tensor,
           term: torch.Tensor, q_off: torch.Tensor, queries: torch.Tensor,
           *, ge: int = -1, match: int = 1, mismatch: int = -1):
    """POA semiglobal DP and traceback of a batch of (graph, query) pairs
    in ops/poa_device.export_batch's CSR layout: node_off int32 [G+1], wts
    int64 [Ntot], topo int32 [Ntot], pred_off int32 [Ntot+1], pred_idx
    int32 [Etot], term uint8 [Ntot], q_off int32 [G+1], queries int64
    [Mtot].  Returns (best int32 [G], ystart int32 [G], nops int32 [G],
    ops int32 [R, 3]): each pair's op rows (kind, pred, node) in traceback
    order from ops_offsets(node_off, q_off)[g], -1 past nops.  CPU tensors
    take the plain version (ops/poa_device.poa_dp_plain); CUDA tensors
    launch csrc/poa_dp.cu (plan: poa_dp_plan)."""
    if wts.device.type == "cpu":
        return poa_dp_plain(node_off, wts, topo, pred_off, pred_idx, term,
                            q_off, queries, ge=ge, match=match,
                            mismatch=mismatch)
    launch, outs, _ = poa_dp_launcher(
        node_off, wts, topo, pred_off, pred_idx, term, q_off, queries,
        ge=ge, match=match, mismatch=mismatch)
    launch()
    if node_off.shape[0] > 1:
        poa_dp.launches += 1
    return outs


poa_dp.launches = 0
