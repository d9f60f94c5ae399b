"""Minimizer scheme registry and auxiliary selection filters.

UHS / LCP filters (reference: minimizers.rs:115-161, read.rs:93-156):

The reference preloads a Bloom filter from the universal-kmer / core-substring
file, then during extraction keeps a minimizer iff `check_and_add(hash)`
returns true (= already present).  Two faithful quirks:

- `uhs_preparation` inserts ntc64 hashes of each file line, so UHS membership
  is hash equality against the line's first l characters;
- `lcp_preparation` inserts the core STRINGS but extraction queries with the
  minimizer HASH (read.rs:118 vs minimizers.rs:153), so preloaded entries can
  never match a query — the effective behavior is keep-from-second-occurrence.

By default we use an exact hash set instead of a Bloom filter: no false
positives, strictly reproducible.  The divergence this introduces vs the
reference is quantified (tests/test_tools_misc.py
test_uhs_bloom_divergence_quantified): a 1-hash Bloom at load factor a =
n_inserted/m_bits admits each first-seen non-UHS minimizer with probability
~1-exp(-a) — with the reference's 500M bits and realistic UHS sizes
(1-30M entries) that is 0.2-5.8% extra minimizers, hash-uniform, i.e. a
small effective density increase rather than a topology distortion.
`--bf` switches to `BloomCheckAndAddFilter`, which reproduces the
reference's memory behavior AND its FP semantics exactly
(minimizers.rs:115-161: preload + check_and_add insert-on-miss).
"""

from __future__ import annotations

from ..ops.nthash import ntc64


class CheckAndAddFilter:
    """xx_bloomfilter's check_and_add contract: True iff already present,
    else insert and return False."""

    def __init__(self):
        self._set: set = set()

    def add(self, item):
        self._set.add(item)

    def check_and_add(self, item) -> bool:
        if item in self._set:
            return True
        self._set.add(item)
        return False


class BloomCheckAndAddFilter:
    """1-hash Bloom with the reference's check_and_add semantics
    (xx_bloomfilter via minimizers.rs:115-161): constant memory, false
    positives at ~load-factor rate, never false negatives."""

    def __init__(self, log2_bits: int = 29):  # 2^29 ~ the reference's 500M
        import numpy as np

        self.m = 1 << log2_bits
        self._bits = np.zeros(self.m // 8, dtype=np.uint8)

    def _idx(self, item) -> int:
        if isinstance(item, str):
            item = ntc64(item, len(item))
        # invertible 64-bit mix (read.rs:43-52 constants) for uniformity
        h = int(item) & 0xFFFFFFFFFFFFFFFF
        h = (~h + (h << 21)) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 24
        h = (h + (h << 3) + (h << 8)) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 14
        return h % self.m

    def add(self, item):
        i = self._idx(item)
        self._bits[i >> 3] |= 1 << (i & 7)

    def check_and_add(self, item) -> bool:
        i = self._idx(item)
        mask = 1 << (i & 7)
        present = bool(self._bits[i >> 3] & mask)
        self._bits[i >> 3] |= mask
        return present


def _make_filter(params):
    if getattr(params, "use_bf", False):
        return BloomCheckAndAddFilter(getattr(params, "bloom_log2_bits", 29))
    return CheckAndAddFilter()


def uhs_preparation(params, uhs_path: str) -> CheckAndAddFilter:
    """Load universal k-mers, keyed by ntc64 of the first l chars
    (minimizers.rs:115-136)."""
    f = _make_filter(params)
    with open(uhs_path) as fh:
        for line in fh:
            if len(line.rstrip("\n")) >= params.l:
                f.add(ntc64(line.rstrip("\n")[: params.l], params.l))
    return f


def lcp_preparation(params, lcp_path: str) -> CheckAndAddFilter:
    """Load core substrings AS STRINGS (minimizers.rs:138-161) — queries are
    hashes, so these entries act as inert preload (see module docstring)."""
    f = _make_filter(params)
    with open(lcp_path) as fh:
        for line in fh:
            core = line.rstrip("\n")
            if len(core) == params.l:
                f.add(core)
    return f
