"""Assembly parameters and auto-detection.

Mirrors the reference's `Params` struct (rust-mdbg src/main.rs:92-114), its
defaults (main.rs:434-455) and `autodetect_k_l_d` (main.rs:214-226), but as an
immutable dataclass threaded through the pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Params:
    # core mdBG parameters (reference defaults: main.rs:434-455)
    l: int = 12
    k: int = 10
    n: int = 2                 # bucketing tuple length for EC (main.rs:436)
    t: int = 0                 # POA path weight threshold (main.rs:437)
    density: float = 0.10
    min_kmer_abundance: int = 2
    presimp: float = 0.01

    # minimizer scheme switches
    use_syncmers: bool = False
    s: int = 4                 # syncmer mini-kmer size (main.rs:438)
    uhs: bool = False
    lcp: bool = False

    # lmer-counts / robust minimizers (main.rs:446-448)
    has_lmer_counts: bool = False
    lmer_counts_min: int = 2
    lmer_counts_max: int = 100000

    # error correction
    error_correct: bool = False
    correction_threshold: int = 0
    distance: int = 0          # 0: Jaccard, 1: containment, 2: Mash (main.rs:486)

    # modes
    reference: bool = False    # input is genome(s), keep all k-min-mers (main.rs:342-348)
    use_bf: bool = False
    bloom_log2_bits: int = 32  # Bloom size (reference hardcodes ~2^32 slots, main.rs:597)
    reads_already_hpc: bool = False
    no_basespace: bool = False
    debug: bool = False
    # write .sequences spans/shifts with the reference's raw-position + l
    # cut semantics (main.rs:769-778) instead of the default full-HPC-extent
    # exact cuts (ops/hpc.extent_ends_np).  The two are identical whenever
    # reads_already_hpc (every published reference protocol); on raw inputs
    # the default makes to_basespace junctions exact where the reference's
    # are a few bases off.  Used by the transliteration-oracle parity tests.
    seq_ref_cuts: bool = False

    # execution (not in the reference Params; TPU-framework additions)
    threads: int = 8
    engine: str = "auto"       # "host" (numpy), "device" (JAX/XLA), "pallas", "auto"
    batch_reads: int = 512     # reads per device batch
    max_read_len: int = 0      # 0 = auto from input scan
    max_minimizers_per_read: int = 0  # 0 = auto (capacity of compacted tensor)
    chunk_reads: int = 0       # >0: force chunked >HBM counting (core/chunked.py)
    ec_device_poa: bool = False  # batched device POA DP over lockstep chunks
    ec_chunk: int = 32         # templates per lockstep chunk (device EC)
    # >1: fork that many EC worker processes over contiguous template shards
    # (the process analog of the reference's crossbeam thread-chunks,
    # main.rs:855-883).  Workers run the exact host path (numpy triage only;
    # no JAX post-fork) and write part files the parent concatenates in shard
    # order.  Byte-identical to the sequential driver when
    # correction_threshold == 0 (the default: the corrected map never
    # populates); with a threshold, already-corrected skips are per-shard —
    # the deterministic analog of the reference's thread-racy corrected map.
    # Takes precedence over ec_device_poa (one TPU client cannot be forked).
    ec_procs: int = 0
    # minimum shared n-minimizer windows for a bucket candidate to reach the
    # distance filter.  Low-complexity HPC patterns create buckets holding a
    # constant FRACTION of all reads (heavy-tailed n-tuple occurrence
    # counts), and iterating them made recruit O(corpus) per read; a
    # dist < 0.15 (Jaccard > 0.85) neighbor shares long runs of consecutive
    # minimizers, i.e. >> 2 windows, so 2 prunes only hopeless candidates.
    # 1 restores the exhaustive scan.  (The reference's shipped bucket
    # insert is commented out — main.rs:819 — so its EC recruits nothing;
    # the populated-bucket path is this framework's extension.)
    ec_min_shared: int = 2
    # recruit skips buckets larger than this during the shared-window count
    # (degenerate low-complexity n-tuples; see ec_min_shared).  ~17x the
    # default coverage; a genuine neighbor's count survives via its many
    # normal-bucket windows.  0 disables the cap.
    ec_bucket_cap: int = 512

    @property
    def hash_bound(self) -> int:
        """Density rule threshold: keep l-mer iff canonical ntHash <= bound.

        Exactly the reference's `((density as f64) * (u64::max_value() as f64)) as u64`
        (rust-mdbg src/read.rs:183): u64::MAX as f64 rounds up to 2^64, the
        product truncates toward zero, and the cast saturates at u64::MAX.
        """
        b = int(float(self.density) * 18446744073709551616.0)  # 2^64 as f64
        return min(b, 2**64 - 1)

    @property
    def syncmer_hash_bound(self) -> int:
        """Syncmer downsampling bound: density * 4^l (rust-mdbg src/read.rs:217)."""
        return int(float(self.density) * float(4 ** self.l))

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)


def staging_width(mx: int) -> int:
    """Device staging width L for reads whose sampled max length is mx.

    Carries 2x headroom over the sample (unsampled longer reads would be
    fatal), quantized to the coarse bucket ladder {2^n, 1.5*2^n} so that
    datasets with slightly different read lengths reuse the SAME compiled
    shapes — XLA compiles are keyed on L, and through this environment's
    remote-compile relay each distinct L costs tens of seconds.  Every
    bucket is 512-aligned, preserving the packed-feed (L % 8) invariant."""
    L = max(1024, 2 * mx)
    p = 1024
    while p < L:
        p *= 2
    c = (3 * p) // 4
    return c if L <= c and c >= 1024 else p


def autodetect_k_l_d(mean_read_length: int) -> tuple[int, int, float]:
    """k, l, density from mean read length (rust-mdbg src/main.rs:214-226).

    The reference samples the first 100 reads for the mean; callers pass that mean in.
    """
    d = 0.003
    k = int(d * float(mean_read_length))
    l = 12
    return k, l, d


def default_prefix(p: Params) -> str:
    """Default output prefix `graph-k{k}-d{d}-l{l}` (rust-mdbg src/main.rs:498).

    Rust's `{}` float formatting prints 0.003 as "0.003" and 0.1 as "0.1"; Python's
    repr of these f64 values matches for the short-decimal cases used here.
    """
    d = repr(float(p.density))
    if d.endswith(".0"):
        d = d[:-2] + ".0"  # keep Rust-like "1.0" style (not "1")
    return f"graph-k{p.k}-d{d}-l{p.l}"
