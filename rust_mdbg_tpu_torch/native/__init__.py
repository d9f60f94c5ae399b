"""Native (C++) components, built on demand with the in-repo Makefile."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """Load lib{name}.so, building it with make if missing/stale."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        so = os.path.join(_DIR, f"lib{name}.so")
        src = os.path.join(_DIR, f"{name}.cpp")
        if not os.path.exists(so) or (
            os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)
        ):
            subprocess.run(["make", f"lib{name}.so"], cwd=_DIR, check=True,
                           capture_output=True)
        lib = ctypes.CDLL(so)
        _CACHE[name] = lib
        return lib
