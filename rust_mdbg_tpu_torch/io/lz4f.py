"""LZ4 frame codec binding (native C++ implementation in native/lz4f.cpp).

Gives the framework the same .sequences on-disk format as the reference's
lzzzz LZ4F writer/reader (rust-mdbg src/main.rs:61-76,
to_basespace.rs:62-66) without any external lz4 dependency.
"""

from __future__ import annotations

import ctypes
import io

import numpy as np

from ..native import load


def _lib():
    lib = load("lz4f")
    lib.lz4f_compress_frame.restype = ctypes.c_int64
    lib.lz4f_compress_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.lz4f_compress_frame_accel.restype = ctypes.c_int64
    lib.lz4f_compress_frame_accel.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.lz4f_decompress_frame.restype = ctypes.c_int64
    lib.lz4f_decompress_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    return lib


def compress(data: bytes, accel: int = 1) -> bytes:
    """accel > 1 = LZ4 skip-acceleration (faster, slightly larger output)."""
    lib = _lib()
    cap = len(data) + len(data) // 255 + 4096
    out = ctypes.create_string_buffer(cap)
    n = lib.lz4f_compress_frame_accel(data, len(data), out, cap, int(accel))
    if n < 0:
        raise RuntimeError("lz4f compression failed")
    return out.raw[:n]


def decompress(data: bytes, size_hint: int = 0) -> bytes:
    lib = _lib()
    cap = max(size_hint, 4 * len(data) + 65536)
    while True:
        out = ctypes.create_string_buffer(cap)
        n = lib.lz4f_decompress_frame(data, len(data), out, cap)
        if n >= 0:
            return out.raw[:n]
        if cap > (len(data) + 1) * 256 + (1 << 26):
            raise RuntimeError("lz4f decompression failed (malformed input?)")
        cap *= 4


class LZ4FWriter:
    """Buffered streaming writer emitting one frame per ~4MB chunk.

    Concatenated frames are valid LZ4F streams; lzzzz/liblz4 readers accept them.
    """

    def __init__(self, path: str, chunk: int = 4 * 1024 * 1024):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self._chunk = chunk

    def write(self, data: bytes | str):
        if isinstance(data, str):
            data = data.encode()
        self._buf += data
        if len(self._buf) >= self._chunk:
            self._flush_frame()

    def _flush_frame(self):
        if self._buf:
            self._f.write(compress(bytes(self._buf)))
            self._buf.clear()

    def close(self):
        self._flush_frame()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open_text(path: str) -> io.TextIOBase:
    """Read an entire .lz4 file as text (frames decompressed natively)."""
    with open(path, "rb") as f:
        raw = f.read()
    return io.StringIO(decompress(raw).decode())
