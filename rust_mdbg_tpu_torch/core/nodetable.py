"""k-min-mer node table: Python wrapper over the native C++ core.

The counting/crossing semantics live in native/mdbg_core.cpp (see its header
comment for the main.rs parity map).  This wrapper adds the full-vector store:
the canonical minimizer vector of every node that crossed min_abundance is kept
host-side, keyed by node index — it is what the .sequences record and the GFA
edge builder need (the reference keeps every full Kmer as the DashMap key; we
only pay that memory for surviving nodes).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load


class NodeTable:
    def __init__(
        self,
        min_abundance: int = 2,
        use_bf: bool = False,
        bloom_log2_bits: int = 32,
        keep_all: bool = False,
        capacity_hint: int = 1 << 20,
    ):
        self._lib = load("mdbg_core")
        lib = self._lib
        lib.nt_create.restype = ctypes.c_void_p
        lib.nt_create.argtypes = [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int,
                                  ctypes.c_uint64, ctypes.c_int]
        lib.nt_destroy.argtypes = [ctypes.c_void_p]
        lib.nt_size.restype = ctypes.c_uint64
        lib.nt_size.argtypes = [ctypes.c_void_p]
        lib.nt_clear.argtypes = [ctypes.c_void_p]
        lib.nt_add_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.nt_lookup_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.nt_dump.restype = ctypes.c_int64
        lib.nt_dump.argtypes = [ctypes.c_void_p, ctypes.c_uint32] + [ctypes.c_void_p] * 7
        lib.nt_retain.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.nt_merge_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.nt_set_meta_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        self._t = lib.nt_create(
            capacity_hint, min_abundance, int(use_bf), bloom_log2_bits, int(keep_all)
        )
        self.min_abundance = min_abundance
        self.vectors: dict[int, np.ndarray] = {}

    def __del__(self):
        if getattr(self, "_t", None):
            self._lib.nt_destroy(self._t)
            self._t = None

    def __len__(self):
        return int(self._lib.nt_size(self._t))

    def clear(self):
        self._lib.nt_clear(self._t)
        self.vectors.clear()

    @staticmethod
    def _ptr(a: np.ndarray):
        return a.ctypes.data_as(ctypes.c_void_p)

    def add_batch(self, key_lo, key_hi, seqlen, shift0, shift1):
        """Returns (crossed_flags uint8[N], node_index uint32[N])."""
        n = len(key_lo)
        key_lo = np.ascontiguousarray(key_lo, dtype=np.uint64)
        key_hi = np.ascontiguousarray(key_hi, dtype=np.uint64)
        seqlen = np.ascontiguousarray(seqlen, dtype=np.uint32)
        shift0 = np.ascontiguousarray(shift0, dtype=np.uint16)
        shift1 = np.ascontiguousarray(shift1, dtype=np.uint16)
        flags = np.zeros(n, dtype=np.uint8)
        index = np.zeros(n, dtype=np.uint32)
        self._lib.nt_add_batch(
            self._t, n, self._ptr(key_lo), self._ptr(key_hi), self._ptr(seqlen),
            self._ptr(shift0), self._ptr(shift1), self._ptr(flags), self._ptr(index),
        )
        return flags, index

    def retain(self, min_abund: int):
        """Drop entries with abundance < min_abund (main.rs:922-933)."""
        self._lib.nt_retain(self._t, min_abund)

    def merge_chunk(self, key_lo, key_hi, count):
        """Merge one chunk's (unique key, in-chunk count) pairs — must be in
        first-occurrence order.  Returns (sel uint8[N], node_index uint32[N]):
        sel=j > 0 means the min_abundance crossing fell on this chunk's j-th
        occurrence of the key (write its .sequences record now).  sel never
        exceeds min_abundance, so a chunk emission carrying min_abundance
        occurrence slots makes the capture exact for any --minabund."""
        n = len(key_lo)
        key_lo = np.ascontiguousarray(key_lo, dtype=np.uint64)
        key_hi = np.ascontiguousarray(key_hi, dtype=np.uint64)
        count = np.ascontiguousarray(count, dtype=np.uint32)
        sel = np.zeros(n, dtype=np.uint8)
        index = np.zeros(n, dtype=np.uint32)
        self._lib.nt_merge_chunk(
            self._t, n, self._ptr(key_lo), self._ptr(key_hi),
            self._ptr(count), self._ptr(sel), self._ptr(index),
        )
        return sel, index

    def set_meta_batch(self, key_lo, key_hi, seqlen, shift0, shift1):
        """Record crossing-occurrence seqlen/shift AND assign node ids, in
        call order — the chunked driver calls this with keys sorted by their
        crossing occurrence, reproducing the whole-run engines' id order
        (byte-identical GFA).  Returns the assigned ids."""
        n = len(key_lo)
        key_lo = np.ascontiguousarray(key_lo, dtype=np.uint64)
        key_hi = np.ascontiguousarray(key_hi, dtype=np.uint64)
        seqlen = np.ascontiguousarray(seqlen, dtype=np.uint32)
        shift0 = np.ascontiguousarray(shift0, dtype=np.uint16)
        shift1 = np.ascontiguousarray(shift1, dtype=np.uint16)
        index = np.zeros(n, dtype=np.uint32)
        self._lib.nt_set_meta_batch(
            self._t, n, self._ptr(key_lo), self._ptr(key_hi),
            self._ptr(seqlen), self._ptr(shift0), self._ptr(shift1),
            self._ptr(index),
        )
        return index

    def lookup_batch(self, key_lo, key_hi) -> np.ndarray:
        n = len(key_lo)
        key_lo = np.ascontiguousarray(key_lo, dtype=np.uint64)
        key_hi = np.ascontiguousarray(key_hi, dtype=np.uint64)
        ab = np.zeros(n, dtype=np.uint32)
        self._lib.nt_lookup_batch(self._t, n, self._ptr(key_lo), self._ptr(key_hi),
                                  self._ptr(ab))
        return ab

    def dump(self, min_filter: int = 0):
        """All entries with abundance >= min_filter, sorted by node index.

        Indexes are crossing-occurrence order.  Entries that never crossed
        min_abundance (reachable only with min_filter below it) carry a
        provisional 0x80000000|insertion-rank index in the native table;
        they sort after the crossed entries and are renumbered here to a
        compact id range following them.

        Returns dict of arrays: key_lo, key_hi, index, abundance, seqlen,
        shift0, shift1.
        """
        cap = len(self)
        key_lo = np.zeros(cap, dtype=np.uint64)
        key_hi = np.zeros(cap, dtype=np.uint64)
        index = np.zeros(cap, dtype=np.uint32)
        abundance = np.zeros(cap, dtype=np.uint32)
        seqlen = np.zeros(cap, dtype=np.uint32)
        shift0 = np.zeros(cap, dtype=np.uint16)
        shift1 = np.zeros(cap, dtype=np.uint16)
        n = self._lib.nt_dump(
            self._t, min_filter, self._ptr(key_lo), self._ptr(key_hi),
            self._ptr(index), self._ptr(abundance), self._ptr(seqlen),
            self._ptr(shift0), self._ptr(shift1),
        )
        order = np.argsort(index[:n], kind="stable")
        idx = index[:n][order]
        flagged = idx >= np.uint32(0x80000000)
        if flagged.any():
            idx = idx.copy()
            base = int(np.count_nonzero(~flagged))
            idx[flagged] = base + np.arange(int(flagged.sum()),
                                            dtype=np.uint32)
        return dict(
            key_lo=key_lo[:n][order], key_hi=key_hi[:n][order],
            index=idx, abundance=abundance[:n][order],
            seqlen=seqlen[:n][order], shift0=shift0[:n][order],
            shift1=shift1[:n][order],
        )
