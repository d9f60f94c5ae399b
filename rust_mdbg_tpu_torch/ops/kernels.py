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
import math
import os
import subprocess
import threading
import time

import torch

from . import u64
from .nthash import nthash_windows
from .syncmers_device import syncmer_planes

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

#: kernel name -> CUDA source file under csrc/
SOURCES = {"nthash_select": "nthash_select.cu",
           "syncmer_select": "syncmer_select.cu"}

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


#: C entry points of each library: name -> argument types (all return int,
#: the launch's cudaGetLastError())
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
}


def _lib(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_so_path(name))
            for fn, argtypes in _ENTRY_POINTS[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def _check_cuda(t: torch.Tensor, dtype, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = lib.nthash_select_launch(
        codes.data_ptr(), lengths.data_ptr(), canon.data_ptr(),
        sel.data_ptr(), B, L, l, hash_bound & ((1 << 64) - 1), stream)
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
    stream = torch.cuda.current_stream(hpc_codes.device).cuda_stream
    err = lib.syncmer_select_launch(
        hpc_codes.data_ptr(), hpc_len.data_ptr(), hl.data_ptr(),
        sel.data_ptr(), B, L, l, s, bound & ((1 << 64) - 1), stream)
    if err != 0:
        raise RuntimeError(f"syncmer_select launch failed: CUDA error {err}")
    syncmer_select.launches += 1
    return hl, sel


syncmer_select.launches = 0
