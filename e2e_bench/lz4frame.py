"""Reading LZ4 frames (the .sequences files) without the program.

The frame and block formats of the public LZ4 specification: a frame is
the magic 0x184D2204, a descriptor (FLG, BD, optional content size and
dictionary id, a header checksum), blocks of a 32-bit size (bit 31: stored
as is) with an optional 4-byte checksum, and an end mark with an optional
content checksum.  A block is sequences of a token, literals, a 16-bit
offset and a match length, decoded by csrc/lz4block.cpp, which is built
with g++ into build/ beside it the first time a checkout needs it.
Checksums are skipped, not verified: the check compares the decoded text
itself.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "csrc", "lz4block.cpp")
LIB = os.path.join(HERE, "build", "liblz4block.so")
#: the largest block the frame format allows (4 MiB)
BLOCK_MAX = 4 << 20
_lib = None
_lock = threading.Lock()


def _decoder():
    """The built decoder (built, or rebuilt where its source is newer)."""
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIB)
                    or os.path.getmtime(LIB) < os.path.getmtime(SRC)):
                os.makedirs(os.path.dirname(LIB), exist_ok=True)
                tmp = f"{LIB}.{os.getpid()}"
                subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", tmp,
                                SRC], check=True)
                os.replace(tmp, LIB)
            lib = ctypes.CDLL(LIB)
            lib.lz4_block_decode.restype = ctypes.c_int64
            lib.lz4_block_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64]
            _lib = lib
    return _lib

MAGIC = 0x184D2204
SKIPPABLE = 0x184D2A50


def blocks(data: bytes):
    """(frame number, block number, independent, stored, payload) of every
    block of every frame in `data`, in order."""
    p = 0
    frame = 0
    while p < len(data):
        (magic,) = struct.unpack_from("<I", data, p)
        if magic & 0xFFFFFFF0 == SKIPPABLE:
            (size,) = struct.unpack_from("<I", data, p + 4)
            p += 8 + size
            continue
        if magic != MAGIC:
            raise ValueError(f"not an LZ4 frame at byte {p}")
        flg = data[p + 4]
        p += 6 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0) + 1
        independent = bool(flg & 0x20)
        b = 0
        while True:
            (size,) = struct.unpack_from("<I", data, p)
            p += 4
            if size == 0:
                break
            stored = bool(size & 0x80000000)
            size &= 0x7FFFFFFF
            yield frame, b, independent, stored, data[p : p + size]
            p += size + (4 if flg & 0x10 else 0)
            b += 1
        p += 4 if flg & 0x04 else 0
        frame += 1


def decode_block(src: bytes, prefix: bytes = b"") -> bytes:
    """One LZ4 block's bytes; `prefix` is what came before it in its frame
    when blocks are linked."""
    buf = np.empty(len(prefix) + BLOCK_MAX, dtype=np.uint8)
    buf[: len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
    n = _decoder().lz4_block_decode(src, len(src), buf.ctypes.data,
                                    len(prefix), BLOCK_MAX)
    if n < 0:
        raise ValueError("malformed LZ4 block")
    return buf[len(prefix) : len(prefix) + n].tobytes()


def decode(data: bytes) -> bytes:
    """All of the frames' bytes."""
    out = []
    prev = b""
    for _, b, independent, stored, payload in blocks(data):
        if b == 0:
            prev = b""
        chunk = payload if stored else decode_block(
            payload, b"" if independent else prev[-65536:])
        out.append(chunk)
        prev = chunk
    return b"".join(out)
