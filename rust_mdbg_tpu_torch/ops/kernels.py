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
import os
import subprocess
import threading
import time

import torch

from . import u64
from .nthash import nthash_windows

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

#: kernel name -> CUDA source file under csrc/
SOURCES = {"nthash_select": "nthash_select.cu"}

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
