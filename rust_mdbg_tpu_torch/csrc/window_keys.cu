// Canonical 128-bit keys of the k-minimizer windows of compacted minimizer
// rows, written as the [B, W, 2] keys plane or appended to the counter's
// batch slot.
//
// Replaces (XLA): rust_mdbg_tpu/ops/extract.py _window_keys_poly (:489)
// with the sentinel `where` of _device_extract's count path, and the
// batch-slot compaction of rust_mdbg_tpu/ops/sort_count.py
// make_fused_construct (:637-669).  In the port their plain torch versions
// are ops/kernels.window_keys_plain and slot_append_plain.
//
// Function, for window w < W = M - k + 1 of row b, v = minim_hash[b]:
//   valid    n_min[b] > k and w < nw[b] = n_min[b] - k + 1
//   rev      at the first j with v[w+j] != v[w+k-1-j], v[w+j] > v[w+k-1-j]
//            as unsigned 64-bit values; true for a palindrome
//            (KmerVec::normalize)
//   key      per lane (A, OFF) = (0x100000001B3, 0xCBF29CE484222325) and
//            (0xC2B2AE3D27D4EB4F, 0x9E3779B97F4A7C15): h = OFF, then
//            h = h * A + x over the window, or over its reverse when rev
//            (ops/kminmer.fingerprint128_np), mod 2^64.  The JAX function's
//            prefix sums give the same value: A is odd, so the powers of
//            A^-1 it uses exist and the sums telescope exactly in Z/2^64.
//   mode (i)  keys[b, w] = key, or all ones (the sentinel) where invalid
//   mode (ii) window w < nw[b] lands at slot p = offs[b] + w, offs the
//            exclusive sum of nw over the batch's rows: lo[p], hi[p] the
//            key, occ[p] = ((row0 + b) * W + w) & 0xFFFFFFFF, for p < S;
//            slots [min(nv, S), S) take the sentinel and 0xFFFFFFFF, nv the
//            sum of nw; then n_win += min(nv, S), n_over += nv > S
//
// Bound on the card: memory.  A window costs about 10 k 32-bit operations
// (two 64-bit multiply-adds a step, each a few IMADs on this card, which
// has no 64-bit multiplier), ~210 at k = 21: at the main path's 512 rows
// of ~150 windows that is ~16 M operations, ~0.25 us at 67 T/s, against
// ~1 MB of minimizer rows read and ~1.8 MB of slots written (~0.9 us at
// 3.35 TB/s).
//
// Design:
// - One block a row, one thread a window.  The block stages the minimizer
//   values of 256 windows (256 + k - 1 of them) in shared memory and each
//   thread reads its window there: neighbouring threads read neighbouring
//   words.  Rows of any M take as many tiles as they need.
// - The reversal flag compares the window's two halves only (the first
//   difference lies in the first k / 2 pairs or nowhere); the Horner loop
//   reads index j or k - 1 - j by the flag, one loop for both orientations.
// - Mode (ii): each block sums nw over the batch's rows (n_min is a [B]
//   int32 vector) for its own offset and the batch total, so the append
//   needs no scan launch and no host sync.  Rows write their windows' slots
//   in place, the tail of the slot is filled by all blocks with a
//   grid-stride loop, and block 0 adds to the two device counters.  Windows
//   past the slot (nv > S) are not written, as in the plain version.
//
// No single PyTorch call computes this function, so it has no library
// yardstick.
//
// Interface: plain C, loaded with ctypes (ops/kernels.py).  The launch goes
// on the caller's stream, does not synchronise and allocates nothing; the
// return value is cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // windows a tile
constexpr uint64_t kA1 = 0x100000001B3ull;
constexpr uint64_t kA2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kOff1 = 0xCBF29CE484222325ull;
constexpr uint64_t kOff2 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kSentinel = ~0ull;
constexpr uint64_t kOccEmpty = 0xFFFFFFFFull;

__device__ __forceinline__ int windows_of(int n_min, int k) {
    return n_min > k ? n_min - k + 1 : 0;
}

// canonical key of the window v[0 .. k)
__device__ __forceinline__ void window_key(const uint64_t* v, int k,
                                           uint64_t& lo, uint64_t& hi) {
    bool rev = true;
    for (int j = 0; j < k / 2; ++j) {
        const uint64_t a = v[j], b = v[k - 1 - j];
        if (a != b) {
            rev = a > b;
            break;
        }
    }
    uint64_t h1 = kOff1, h2 = kOff2;
    for (int j = 0; j < k; ++j) {
        const uint64_t x = v[rev ? k - 1 - j : j];
        h1 = h1 * kA1 + x;
        h2 = h2 * kA2 + x;
    }
    lo = h1;
    hi = h2;
}

// (sum of a over the block, sum of b over the block), every thread
__device__ __forceinline__ void block_sums(long long& a, long long& b,
                                           long long* scratch) {
    for (int d = 16; d > 0; d >>= 1) {
        a += __shfl_down_sync(0xFFFFFFFFu, a, d);
        b += __shfl_down_sync(0xFFFFFFFFu, b, d);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        scratch[2 * warp] = a;
        scratch[2 * warp + 1] = b;
    }
    __syncthreads();
    a = b = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
        a += scratch[2 * w];
        b += scratch[2 * w + 1];
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
window_keys_kernel(const uint64_t* __restrict__ mh,
                   const int32_t* __restrict__ n_min, int B, int M, int k,
                   uint64_t* __restrict__ keys, uint64_t* __restrict__ b_lo,
                   uint64_t* __restrict__ b_hi, uint64_t* __restrict__ b_occ,
                   long long row0, long long S, long long* n_win,
                   long long* n_over) {
    extern __shared__ uint64_t tile[];   // kThreads + k - 1 values
    __shared__ long long scratch[2 * (kThreads / 32)];

    const int tid = threadIdx.x;
    const int row = blockIdx.x;
    const int W = M - k + 1;
    const int nw = windows_of(n_min[row], k);
    const uint64_t* hrow = mh + static_cast<int64_t>(row) * M;

    long long offs = 0, nv = 0;
    int limit = W;                        // windows this block visits
    if (!keys) {
        long long before = 0, all = 0;
        for (int r = tid; r < B; r += kThreads) {
            const long long x = windows_of(n_min[r], k);
            before += r < row ? x : 0;
            all += x;
        }
        block_sums(before, all, scratch);
        offs = before;
        nv = all;
        const long long room = S - offs;
        limit = room <= 0 ? 0 : static_cast<int>(nw < room ? nw : room);
    }

    const int span = kThreads + k - 1;
    for (int w0 = 0; w0 < limit; w0 += kThreads) {
        const bool any_valid = w0 < nw;   // the same in the whole block
        if (any_valid) {
            __syncthreads();              // the last tile has been read
            for (int i = tid; i < span; i += kThreads)
                tile[i] = w0 + i < M ? hrow[w0 + i] : 0ull;
            __syncthreads();
        }
        const int w = w0 + tid;
        if (w >= limit) continue;
        uint64_t lo = kSentinel, hi = kSentinel;
        if (w < nw) window_key(tile + tid, k, lo, hi);
        if (keys) {
            reinterpret_cast<ulonglong2*>(keys)[
                static_cast<int64_t>(row) * W + w] = make_ulonglong2(lo, hi);
        } else {
            const long long p = offs + w;
            b_lo[p] = lo;
            b_hi[p] = hi;
            b_occ[p] = static_cast<uint64_t>((row0 + row) * W + w) &
                       kOccEmpty;
        }
    }

    if (!keys) {
        const long long fill0 = min(nv, S);
        for (long long p = fill0 + static_cast<long long>(blockIdx.x) *
                                       kThreads + tid;
             p < S; p += static_cast<long long>(gridDim.x) * kThreads) {
            b_lo[p] = kSentinel;
            b_hi[p] = kSentinel;
            b_occ[p] = kOccEmpty;
        }
        if (row == 0 && tid == 0) {
            *n_win += fill0;
            *n_over += nv > S;
        }
    }
}

}  // namespace

extern "C" int window_keys_launch(const void* mh, const void* n_min, int B,
                                  int M, int k, void* keys, void* b_lo,
                                  void* b_hi, void* b_occ, long long row0,
                                  long long S, void* n_win, void* n_over,
                                  void* stream) {
    if (B <= 0) return 0;
    if (k < 1 || M < k || (!keys && !(b_lo && b_hi && b_occ && n_win &&
                                      n_over)))
        return cudaErrorInvalidValue;
    const size_t smem = sizeof(uint64_t) * (kThreads + k - 1);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    window_keys_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(mh), static_cast<const int32_t*>(n_min),
        B, M, k, static_cast<uint64_t*>(keys), static_cast<uint64_t*>(b_lo),
        static_cast<uint64_t*>(b_hi), static_cast<uint64_t*>(b_occ), row0, S,
        static_cast<long long*>(n_win), static_cast<long long*>(n_over));
    return static_cast<int>(cudaGetLastError());
}
