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
// 3.35 TB/s).  At these sizes a launch is its launch floor (~2 us), one
// load round trip, the k-step Horner chain and the stores' drain.
//
// Design:
// - A block a row; its four warps take 256 windows at once, two windows a
//   lane, whose Horner chains run interleaved.
// - A warp stages the row words of its windows (64 + k - 1 of them)
//   in its own shared-memory tile with __syncwarp only; their loads, and
//   the row's n_min, are issued at once, before n_min is known.
// - The reversal flag compares the window's two halves only (the first
//   difference lies in the first k / 2 pairs or nowhere); the Horner loop
//   reads index j or k - 1 - j by the flag, one loop for both orientations.
// - Mode (i) crosses no barrier: each row's keys depend on its own n_min.
// - Mode (ii): every block reads the batch's n_min vector (a 16-byte load a
//   thread up to B = 512 rows) together with its row's tile,
//   scans it with warp shuffles after the keys are computed, and crosses
//   one barrier to add the warps' totals: its row's offset and the batch
//   total nv, with no loop over B, no block reduction before the tile and
//   no scan launch or host sync.  The slot's tail [min(nv, S), S) is
//   strided over the whole grid, as in the first version: at the main
//   path's ~8 K tail slots and 512 rows that is at most one store a thread,
//   where the few blocks past the last row with windows would each take
//   tens.  Block 0 adds to the two counters.  Windows past
//   the slot (nv > S) are not written, as in the plain version.
//
// Measured (chip_smoke.py --construct-ab, PR 13's kernel and this one in
// turns in one call, NVIDIA H100 80GB HBM3, 700 W): queued device time of
// the append 0.00549 / 0.00550 ms at [512, 256], k = 21 (PR 13's:
// 0.00575 / 0.00578), the keys plane 0.00456 / 0.00472 (0.00461 /
// 0.00461), but 0.00505 / 0.00507 ms at the bench's [128, 256] (0.00437 /
// 0.00435), where four warps a row leave an SM four warps to hide the
// chain with; against launch floors of ~0.002 ms.  PERF.md section 6 has
// every call's numbers.
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

// a block is one row; its four warps take 256 windows at once, two windows
// a lane, interleaved
constexpr int kLaneWin = 2;               // windows a lane takes at once
constexpr int kWarpWin = 32 * kLaneWin;   // windows a warp takes at once
constexpr int kRowWin = 256;              // windows a row's warps take at once
constexpr int kWarps = kRowWin / kWarpWin;
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemMax = 48 * 1024;       // the staged tiles' limit
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kA1 = 0x100000001B3ull;
constexpr uint64_t kA2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kOff1 = 0xCBF29CE484222325ull;
constexpr uint64_t kOff2 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kSentinel = ~0ull;
constexpr uint64_t kOccEmpty = 0xFFFFFFFFull;

// words of a warp's tile a lane holds in registers on their way to shared
// memory: tiles of up to 32 * kPre words (k up to 65) take one round trip
constexpr int kPre = 4;

__device__ __forceinline__ int windows_of(int n_min, int k) {
    return n_min > k ? n_min - k + 1 : 0;
}

// the lane's words [base, base + 32 * kPre) of the tile that starts at row
// word w0: words w0 + x, zeros past the tile's span or past M
__device__ __forceinline__ void tile_load(uint64_t (&r)[kPre],
                                          const uint64_t* __restrict__ v,
                                          int w0, int M, int span, int base,
                                          int lane) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
        const int x = base + lane + 32 * i;
        r[i] = x < span && w0 + x < M ? v[w0 + x] : 0ull;
    }
}

__device__ __forceinline__ void tile_store(uint64_t* tile,
                                           const uint64_t (&r)[kPre],
                                           int span, int base, int lane) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
        const int x = base + lane + 32 * i;
        if (x < span) tile[x] = r[i];
    }
}

// the warp's tile of row words [w0, w0 + kWarpWin + k - 1) into shared
// memory: every load of a round issued before its stores; `first` holds
// the first round's words, loaded already.  A warp-wide step, no block
// barrier.
__device__ __forceinline__ void stage(uint64_t* tile,
                                      const uint64_t* __restrict__ v, int w0,
                                      int M, int span, int lane,
                                      const uint64_t (&first)[kPre]) {
    __syncwarp();                         // the last tile's reads are done
    tile_store(tile, first, span, 0, lane);
    for (int base = 32 * kPre; base < span; base += 32 * kPre) {
        uint64_t r[kPre];
        tile_load(r, v, w0, M, span, base, lane);
        tile_store(tile, r, span, base, lane);
    }
    __syncwarp();
}

// the keys of the lane's windows at src + 32 i (i < kLaneWin), those with
// act[i] (act[0] set); the others get the sentinel and read the first
// window, so nothing past it is read.  Per window: the reversal flag from
// the first differing pair of its halves, then both Horner lanes over the
// window or its reverse; the windows' chains run interleaved.
__device__ __forceinline__ void window_keys_of(const uint64_t* src, int k,
                                               const bool (&act)[kLaneWin],
                                               uint64_t (&lo)[kLaneWin],
                                               uint64_t (&hi)[kLaneWin]) {
    const uint64_t* at[kLaneWin];
    bool rev[kLaneWin], open[kLaneWin];
#pragma unroll
    for (int i = 0; i < kLaneWin; ++i) {
        at[i] = act[i] ? src + 32 * i : src;
        rev[i] = true;
        open[i] = true;
    }
    for (int j = 0; j < k / 2; ++j) {
        bool any = false;
#pragma unroll
        for (int i = 0; i < kLaneWin; ++i) {
            if (open[i]) {
                const uint64_t a = at[i][j], b = at[i][k - 1 - j];
                if (a != b) {
                    rev[i] = a > b;
                    open[i] = false;
                }
            }
            any |= open[i];
        }
        if (!any) break;
    }
    int d[kLaneWin], step[kLaneWin];
    uint64_t h1[kLaneWin], h2[kLaneWin];
#pragma unroll
    for (int i = 0; i < kLaneWin; ++i) {
        d[i] = rev[i] ? k - 1 : 0;
        step[i] = rev[i] ? -1 : 1;
        h1[i] = kOff1;
        h2[i] = kOff2;
    }
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
#pragma unroll
        for (int i = 0; i < kLaneWin; ++i) {
            const uint64_t x = at[i][d[i] + step[i] * j];
            h1[i] = h1[i] * kA1 + x;
            h2[i] = h2[i] * kA2 + x;
        }
    }
#pragma unroll
    for (int i = 0; i < kLaneWin; ++i) {
        lo[i] = act[i] ? h1[i] : kSentinel;
        hi[i] = act[i] ? h2[i] : kSentinel;
    }
}

// the keys of the lane's windows w0 + lane + 32 i (i < kLaneWin) of the
// row v (valid below nw; the sentinel elsewhere), read from the warp's
// tile at w0 when `staged` (its first round of words in `first`, loaded
// already), else from the row
__device__ __forceinline__ void keys_at(uint64_t* tile,
                                        const uint64_t* __restrict__ v,
                                        int w0, int M, int k, int nw,
                                        int span, bool staged, int lane,
                                        const uint64_t (&first)[kPre],
                                        uint64_t (&lo)[kLaneWin],
                                        uint64_t (&hi)[kLaneWin]) {
    bool act[kLaneWin];
#pragma unroll
    for (int i = 0; i < kLaneWin; ++i) {
        lo[i] = hi[i] = kSentinel;
        act[i] = w0 + lane + 32 * i < nw;
    }
    if (staged) {
        stage(tile, v, w0, M, span, lane, first);
        if (act[0]) window_keys_of(tile + lane, k, act, lo, hi);
    } else if (act[0]) {                  // unstaged: k past the tiles' limit
        window_keys_of(v + w0 + lane, k, act, lo, hi);
    }
}

__global__ void __launch_bounds__(kThreads)
window_keys_kernel(const uint64_t* __restrict__ mh,
                   const int32_t* __restrict__ n_min, int B, int M, int k,
                   uint64_t* __restrict__ keys, uint64_t* __restrict__ b_lo,
                   uint64_t* __restrict__ b_hi, uint64_t* __restrict__ b_occ,
                   long long row0, long long S, long long* n_win,
                   long long* n_over) {
    // mode ii: the warps' window totals, and the row's offset within its
    // owner warp
    __shared__ long long s_wt[kWarps];
    __shared__ long long s_part;
    // each warp's tile of its windows, when the block's tiles fit kSmemMax;
    // else the row is read where it lies
    extern __shared__ uint64_t s_tiles[];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int row = blockIdx.x;
    const int sub = warp;                 // the warp's windows in a group
    const int W = M - k + 1;
    const int nw = windows_of(n_min[row], k);
    const uint64_t* v = mh + static_cast<int64_t>(row) * M;
    const int span = kWarpWin + k - 1;
    const bool staged = kWarps * span * 8 <= kSmemMax;
    uint64_t* tile = s_tiles + warp * span;
    const int wfirst = kWarpWin * sub;    // the warp's first window
    // the first group's tile, loaded before the row's n_min is known
    uint64_t first[kPre];
    if (staged) tile_load(first, v, wfirst, M, span, 0, lane);
    long long nv = 0, offs = 0;
    // mode ii: the batch's window counts, rows [tid * R, tid * R + R) a
    // thread; the first 16-byte load is issued before the row's first
    // group, the rest (B > 4 * kThreads) after it
    int R = 0, r0 = 0;
    bool vec = false;
    int4 x0 = make_int4(0, 0, 0, 0);
    if (!keys) {
        R = 4 * ((B + 4 * kThreads - 1) / (4 * kThreads));
        r0 = tid * R;
        vec = (reinterpret_cast<uintptr_t>(n_min) & 15) == 0;
        if (vec && r0 + 3 < B) {
            x0 = __ldg(reinterpret_cast<const int4*>(n_min + r0));
        } else {
            int e[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                e[i] = r0 + i < B ? __ldg(n_min + r0 + i) : 0;
            x0 = make_int4(e[0], e[1], e[2], e[3]);
        }
    }

    // the first group's keys, before the barrier
    uint64_t lo[kLaneWin], hi[kLaneWin];
#pragma unroll
    for (int i = 0; i < kLaneWin; ++i) lo[i] = hi[i] = kSentinel;
    if (wfirst < nw)
        keys_at(tile, v, wfirst, M, k, nw, span, staged, lane,
                          first, lo, hi);

    if (!keys) {
        // the thread's rows' windows; the first four from x0
        const int c[4] = {windows_of(x0.x, k), windows_of(x0.y, k),
                          windows_of(x0.z, k), windows_of(x0.w, k)};
        long long mine = c[0] + c[1] + c[2] + c[3];
        for (int q = 4; q < R; q += 4) {
            const int r = r0 + q;
            if (vec && r + 3 < B) {
                const int4 x = __ldg(reinterpret_cast<const int4*>(n_min + r));
                mine += windows_of(x.x, k) + windows_of(x.y, k) +
                        windows_of(x.z, k) + windows_of(x.w, k);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (r + e < B) mine += windows_of(__ldg(n_min + r + e), k);
            }
        }
        long long incl = mine;
#pragma unroll
        for (int dd = 1; dd < 32; dd <<= 1) {
            const long long t = __shfl_up_sync(kFull, incl, dd);
            if (lane >= dd) incl += t;
        }
        if (lane == 31) s_wt[warp] = incl;
        // the row's owner writes its offset within the owner's warp
        if (row >= r0 && row < r0 + R) {
            long long part = incl - mine;
            for (int x = r0; x < row; ++x)
                part += x - r0 < 4 ? c[x - r0]
                                   : windows_of(__ldg(n_min + x), k);
            s_part = part;
        }
        __syncthreads();
        // the row's owner warp: (row / R) / 32
        long long before = 0, all = 0;
        if (lane < kWarps) {
            const long long t = s_wt[lane];
            all = t;
            before = lane < (row / R) / 32 ? t : 0;
        }
#pragma unroll
        for (int dd = 16; dd > 0; dd >>= 1) {
            all += __shfl_xor_sync(kFull, all, dd);
            before += __shfl_xor_sync(kFull, before, dd);
        }
        nv = all;
        offs = before + s_part;
    }

    if (keys) {
        ulonglong2* krow = reinterpret_cast<ulonglong2*>(keys) +
                           static_cast<int64_t>(row) * W;
        for (int w0 = wfirst; w0 < W; w0 += kRowWin) {
            if (w0 != wfirst) {
#pragma unroll
                for (int i = 0; i < kLaneWin; ++i) lo[i] = hi[i] = kSentinel;
                if (w0 < nw) {
                    if (staged) tile_load(first, v, w0, M, span, 0, lane);
                    keys_at(tile, v, w0, M, k, nw, span,
                                      staged, lane, first, lo, hi);
                }
            }
#pragma unroll
            for (int i = 0; i < kLaneWin; ++i) {
                const int w = w0 + lane + 32 * i;
                if (w < W) krow[w] = make_ulonglong2(lo[i], hi[i]);
            }
        }
        return;
    }

    // mode ii: the row's windows that fit the slot
    const long long room = S - offs;
    const int limit = room <= 0 ? 0 : static_cast<int>(nw < room ? nw : room);
    const uint64_t occ0 = static_cast<uint64_t>((row0 + row) * W);
    for (int w0 = wfirst; w0 < limit; w0 += kRowWin) {
        if (w0 != wfirst) {
            if (staged) tile_load(first, v, w0, M, span, 0, lane);
            keys_at(tile, v, w0, M, k, nw, span, staged, lane,
                              first, lo, hi);
        }
#pragma unroll
        for (int i = 0; i < kLaneWin; ++i) {
            const int w = w0 + lane + 32 * i;
            if (w < limit) {
                const long long p = offs + w;
                b_lo[p] = lo[i];
                b_hi[p] = hi[i];
                b_occ[p] = (occ0 + static_cast<uint64_t>(w)) & kOccEmpty;
            }
        }
    }

    // the slot's tail, strided over the grid
    const long long fill0 = nv < S ? nv : S;
    for (long long p = fill0 + static_cast<long long>(blockIdx.x) * kThreads +
                       tid;
         p < S; p += static_cast<long long>(gridDim.x) * kThreads) {
        b_lo[p] = kSentinel;
        b_hi[p] = kSentinel;
        b_occ[p] = kOccEmpty;
    }
    if (blockIdx.x == 0 && tid == 0) {
        *n_win += fill0;
        *n_over += nv > S;
    }
}

// an empty kernel of the same grid and block shape: the card's cost of
// launching that grid, the floor of the kernel's queued time
__global__ void __launch_bounds__(kThreads) window_keys_floor_kernel() {}

}  // namespace

extern "C" int window_keys_launch(const void* mh, const void* n_min, int B,
                                  int M, int k, void* keys, void* b_lo,
                                  void* b_hi, void* b_occ, long long row0,
                                  long long S, void* n_win, void* n_over,
                                  void* stream) {
    if (B <= 0) return 0;
    if (k < 1 || M < k || S < 0 || (!keys && !(b_lo && b_hi && b_occ &&
                                                n_win && n_over)))
        return cudaErrorInvalidValue;
    const size_t tiles = sizeof(uint64_t) * kWarps * (kWarpWin + k - 1);
    window_keys_kernel<<<B, kThreads, tiles <= kSmemMax ? tiles : 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(mh), static_cast<const int32_t*>(n_min),
        B, M, k, static_cast<uint64_t*>(keys), static_cast<uint64_t*>(b_lo),
        static_cast<uint64_t*>(b_hi), static_cast<uint64_t*>(b_occ), row0, S,
        static_cast<long long*>(n_win), static_cast<long long*>(n_over));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int window_keys_floor_launch(int B, void* stream) {
    if (B <= 0) return 0;
    window_keys_floor_kernel<<<B, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
