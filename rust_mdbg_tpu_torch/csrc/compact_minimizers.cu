// Ordered compaction of the selected minimizers of a [B, L] batch into
// [B, M] rows, with the gathers of their hash, position and extent end.
//
// Replaces: the compaction of rust_mdbg_tpu/ops/extract.py _device_extract
// (:137-178, XLA): a two-level sort of the selected positions (per
// 512-column chunk, then across the chunks' first C slots) or one flat row
// sort, then take_along_axis gathers of canon, pos_map and pme.  In the
// port its plain torch version is ops/kernels.compact_minimizers_plain.
//
// Function, per row (C: the chunk slot capacity on the two-level branch,
// 512 on the flat one, where no chunk is capped):
//   kept     the first min(count, C) selected columns of each 512-column
//            chunk, chunk after chunk: ascending
//   n_raw    the selected columns of the row
//   n_min    min(n_raw, M), not capped by the chunk rule
//   slot j   column kept[j] for j < min(|kept|, M); column L - 1 (the
//            sort's padding L, clamped) for j in [|kept|, n_min); zero in
//            every output for j >= n_min
//   outputs  minim_hash[j] = canon[col], minim_pos[j] = pos_map[col] (col
//            itself without a position map), mpe[j] = pme[col] (with an
//            extent plane), n_min, overflow = n_raw > M or, on the
//            two-level branch, some chunk with more than C selected
// The L - 1 slots are the JAX function's: a row that overflows a chunk
// keeps n_min = min(n_raw, M) and so reads its padding there.
//
// Bound on the card: memory.  The function reads the selection plane once
// (1 B a position) and canon, pos_map and pme only at the columns it
// gathers, and writes the three [B, M] planes and two [B] vectors; at the
// main path's [512, 24576], M = 256, that is ~15 MB, ~4.5 us at 3.35 TB/s.
// The work is a few integer operations a position.
//
// Design (no sort):
// - One block a row, 16 warps.  A warp ranks one 512-column chunk: each
//   lane loads 16 selection bytes as one 16-byte vector, packs them into a
//   16-bit mask, and a warp scan of the masks' __popc counts (five
//   __shfl_up_sync) gives each lane the chunk rank of its first selected
//   column.
// - The block takes 16 chunks at a time.  Each warp publishes its chunk's
//   capped and raw counts in shared memory; after one barrier every thread
//   sums the capped counts of the warps before its own (the chunk's output
//   offset) and of all 16 (the running base of the next 16 chunks).
// - A lane walks the set bits of its mask (__ffs) and writes each column
//   whose chunk rank is below C and whose slot is below M straight to its
//   slot, with its three gathered values.  The next 16 chunks' masks are
//   loaded before this walk, so their loads overlap it.
// - After the last chunk the block fills slots [min(|kept|, M), M): the
//   L - 1 column below n_min, zeros above; thread 0 writes n_min and the
//   flag.
// Rows whose base is not 16-byte aligned (odd L) and the row's last chunk
// past L take byte loads; nothing past L is read.
//
// No single PyTorch call computes this function, so it has no library
// yardstick.
//
// Interface: plain C, loaded with ctypes (ops/kernels.py).  The launch goes
// on the caller's stream, does not synchronise and allocates nothing; the
// return value is cudaGetLastError() right after the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;               // columns a warp ranks
constexpr int kWarps = 16;                // chunks a block ranks at once
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneCols = kChunk / 32;    // 16 columns a lane
constexpr unsigned kFull = 0xFFFFFFFFu;

// the 16-bit mask of columns col0 .. col0 + 15 selected in the row
__device__ __forceinline__ uint32_t lane_mask(const uint8_t* srow, int col0,
                                              int L, bool vec) {
    uint32_t m = 0;
    if (col0 >= L) return 0;
    if (vec && col0 + kLaneCols <= L) {
        const uint4 v = __ldcs(reinterpret_cast<const uint4*>(srow + col0));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int b = 0; b < 4; ++b)
                m |= uint32_t(((w[e] >> (8 * b)) & 0xFFu) != 0)
                     << (4 * e + b);
    } else {
#pragma unroll
        for (int i = 0; i < kLaneCols; ++i)
            if (col0 + i < L && srow[col0 + i]) m |= 1u << i;
    }
    return m;
}

__global__ void __launch_bounds__(kThreads)
compact_minimizers_kernel(const uint8_t* __restrict__ sel,
                          const uint64_t* __restrict__ canon,
                          const int32_t* __restrict__ pos_map,
                          const int32_t* __restrict__ pme,
                          uint64_t* __restrict__ minim_hash,
                          int32_t* __restrict__ minim_pos,
                          int32_t* __restrict__ mpe,
                          int32_t* __restrict__ n_min_out,
                          uint8_t* __restrict__ overflow,
                          int L, int M, int C, int two_level) {
    __shared__ int s_kept[kWarps];
    __shared__ int s_raw[kWarps];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int64_t row = blockIdx.x;
    const uint8_t* srow = sel + row * L;
    const uint64_t* crow = canon + row * L;
    const int32_t* prow = pos_map ? pos_map + row * L : nullptr;
    const int32_t* erow = pme ? pme + row * L : nullptr;
    uint64_t* hrow = minim_hash + row * M;
    int32_t* mprow = minim_pos + row * M;
    int32_t* merow = mpe ? mpe + row * M : nullptr;

    auto put = [&](int j, int col) {
        hrow[j] = crow[col];
        mprow[j] = prow ? prow[col] : col;
        if (merow) merow[j] = erow[col];
    };

    const bool vec = (reinterpret_cast<uintptr_t>(srow) & 15) == 0;
    const int nch = (L + kChunk - 1) / kChunk;
    int base = 0, raw = 0;
    bool chunk_over = false;
    uint32_t m_next = lane_mask(srow, warp * kChunk + lane * kLaneCols, L,
                                vec);
    for (int c0 = 0; c0 < nch; c0 += kWarps) {
        const int col0 = (c0 + warp) * kChunk + lane * kLaneCols;
        uint32_t m = m_next;
        m_next = lane_mask(srow, col0 + kWarps * kChunk, L, vec);
        const int cnt = __popc(m);
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += t;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        if (lane == 0) {
            s_kept[warp] = min(total, C);
            s_raw[warp] = total;
        }
        __syncthreads();
        int off = base, kept_all = 0, raw_all = 0;
        bool over = false;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int kw = s_kept[w], rw = s_raw[w];
            off += w < warp ? kw : 0;
            kept_all += kw;
            raw_all += rw;
            over |= rw > C;
        }
        // the lane's selected columns in order, from its chunk rank
        for (int r = incl - cnt; m && r < C; ++r) {
            const int j = off + r;
            if (j >= M) break;
            put(j, col0 + __ffs(m) - 1);
            m &= m - 1;
        }
        base += kept_all;
        raw += raw_all;
        chunk_over |= over;
        __syncthreads();  // s_kept / s_raw are rewritten next round
    }

    const int n_min = min(raw, M);
    for (int j = min(base, M) + tid; j < M; j += kThreads) {
        if (j < n_min) {
            put(j, L - 1);
        } else {
            hrow[j] = 0;
            mprow[j] = 0;
            if (merow) merow[j] = 0;
        }
    }
    if (tid == 0) {
        n_min_out[row] = n_min;
        overflow[row] = (raw > M) || (two_level && chunk_over);
    }
}

}  // namespace

extern "C" int compact_minimizers_launch(
        const void* sel, const void* canon, const void* pos_map,
        const void* pme, void* minim_hash, void* minim_pos, void* mpe,
        void* n_min, void* overflow, int B, int L, int M, int C,
        int two_level, void* stream) {
    if (B <= 0 || M <= 0) return 0;
    if (L < 0 || L > INT_MAX - 2 * kWarps * kChunk || C < 1)
        return cudaErrorInvalidValue;
    compact_minimizers_kernel<<<B, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sel), static_cast<const uint64_t*>(canon),
        static_cast<const int32_t*>(pos_map),
        static_cast<const int32_t*>(pme), static_cast<uint64_t*>(minim_hash),
        static_cast<int32_t*>(minim_pos), static_cast<int32_t*>(mpe),
        static_cast<int32_t*>(n_min), static_cast<uint8_t*>(overflow), L, M,
        C, two_level);
    return static_cast<int>(cudaGetLastError());
}
