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
// The work is a few integer operations a position.  At these sizes a
// launch is a chain of latencies (the selection load, a barrier, the
// gathers), so the design keeps that chain to one link of each.
//
// Design (no sort; one load-scan-gather pass a row on the main shapes):
// - A 512-thread block (16 warps) ranks up to 48 chunks in one pass.  Its
//   chunks are split evenly over the warps, at most three a warp; a lane
//   loads its 16 selection bytes of each of its chunks as 16-byte vectors,
//   all of them before anything waits, and packs each into a 16-bit mask.
// - One warp scan ranks all of a lane's chunks at once: the lane's three
//   popcounts are packed 10 bits apart into one word (a chunk holds at
//   most 512), so five __shfl_up_sync give every chunk rank and total.
// - Each warp publishes its capped and raw totals and its over-C flag; one
//   barrier; then every warp reads the 16 entries and takes its offset,
//   the row's totals and the flag with __reduce_add_sync /
//   __reduce_or_sync.  No other barrier is crossed.
// - A lane trims each mask to the columns under C and under M and issues
//   the loads of all its kept columns (canon, pos_map, pme; four in flight
//   at a time) before their stores.
// - The block then fills slots [min(|kept|, M), M): the L - 1 column
//   below n_min, zeros above; it writes n_min and the flag.
// - Rows of more than 48 chunks (the tiler's [8, 1049088]) take as many
//   passes as they need, one barrier a pass (double-buffered totals), with
//   a running base.
// - One block a row at every batch size: a row's load is one latency
//   whatever its size, so a split of the row over a thread-block cluster
//   of 2 or 4 blocks (the warps' totals traded through distributed shared
//   memory) measured slower at every batch from 1 to 512 rows, paying the
//   cluster's launch and barrier on top (PERF.md section 6).
// Rows whose base is not 16-byte aligned (odd L) and the row's last chunk
// past L take byte loads; nothing past L is read.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): queued device
// time 0.0109-0.0115 ms at [512, 24576] (PR 13's three-round kernel:
// 0.0191-0.0196 in the same calls), 0.0047-0.0050 ms at [128, 24576]
// (0.0073-0.0077), against launch floors of 0.0020-0.0022 and
// 0.0018-0.0020 ms; PERF.md section 6 has every call's numbers.
//
// No single PyTorch call computes this function, so it has no library
// yardstick.
//
// Interface: plain C, loaded with ctypes (ops/kernels.py).  The launch goes
// on the caller's stream, does not synchronise and allocates nothing; the
// return value is the launch's error, else cudaGetLastError() right after.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;               // columns a warp ranks a chunk
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneCols = kChunk / 32;    // 16 columns a lane a chunk
constexpr int kPer = 3;                   // chunks a warp holds in a pass
constexpr int kPass = kWarps * kPer;      // chunks a block ranks in a pass
constexpr int kBatch = 4;                 // gathers a lane keeps in flight
constexpr unsigned kFull = 0xFFFFFFFFu;

// the 16 selection bytes of a lane at col0, as loaded (vector) or packed
// at once (byte loads: odd L, an unaligned row, the row's last chunk)
struct LaneLoad {
    uint4 v;
    uint32_t m;
    bool vec;
};

__device__ __forceinline__ LaneLoad lane_load(const uint8_t* srow, int col0,
                                              int L, bool aligned) {
    LaneLoad r{make_uint4(0, 0, 0, 0), 0, false};
    if (col0 >= L) return r;
    if (aligned && col0 + kLaneCols <= L) {
        r.v = __ldcs(reinterpret_cast<const uint4*>(srow + col0));
        r.vec = true;
    } else {
#pragma unroll
        for (int i = 0; i < kLaneCols; ++i)
            if (col0 + i < L && srow[col0 + i]) r.m |= 1u << i;
    }
    return r;
}

__device__ __forceinline__ uint32_t lane_mask(const LaneLoad& r) {
    if (!r.vec) return r.m;
    const uint32_t w[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
    uint32_t m = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int b = 0; b < 4; ++b)
            m |= uint32_t(((w[e] >> (8 * b)) & 0xFFu) != 0) << (4 * e + b);
    return m;
}

// m with only its lowest `lim` set bits kept
__device__ __forceinline__ uint32_t low_bits(uint32_t m, int lim) {
    if (lim <= 0) return 0;
    while (__popc(m) > lim) m &= ~(0x80000000u >> __clz(m));
    return m;
}

__global__ void __launch_bounds__(kThreads, 2)
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
    // each warp's capped count, raw count and over-C flag, by pass parity
    __shared__ int s_kept[2][kWarps];
    __shared__ int s_raw[2][kWarps];
    __shared__ int s_over[2][kWarps];

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

    const bool aligned = (reinterpret_cast<uintptr_t>(srow) & 15) == 0;
    const int nch = (L + kChunk - 1) / kChunk;
    const int npass = max(1, (nch + kPass - 1) / kPass);

    // kept and raw counts and the over-C flag of the passes done
    int base = 0, raw = 0, over = 0;
    for (int pass = 0; pass < npass; ++pass) {
        const int buf = pass & 1;
        const int p0 = pass * kPass;
        const int np = min(kPass, nch - p0);
        const int q0 = p0 + warp * np / kWarps;
        const int nq = p0 + (warp + 1) * np / kWarps - q0;   // 0 .. kPer
        const int col0 = q0 * kChunk + lane * kLaneCols;

        // every selection load of the pass before anything waits
        LaneLoad ld[kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q)
            ld[q] = q < nq ? lane_load(srow, col0 + q * kChunk, L, aligned)
                           : LaneLoad{make_uint4(0, 0, 0, 0), 0, false};
        uint32_t m[kPer];
        uint32_t cnt = 0;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
            m[q] = lane_mask(ld[q]);
            cnt |= uint32_t(__popc(m[q])) << (10 * q);
        }
        // one warp scan ranks the warp's chunks together
        uint32_t incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t t = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += t;
        }
        const uint32_t tot = __shfl_sync(kFull, incl, 31);
        const uint32_t excl = incl - cnt;
        int t[kPer], kq[kPer], w_kept = 0, w_raw = 0, w_over = 0;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
            t[q] = (tot >> (10 * q)) & 1023;
            kq[q] = min(t[q], C);
            w_kept += kq[q];
            w_raw += t[q];
            w_over |= t[q] > C;
        }
        if (lane == 0) {
            s_kept[buf][warp] = w_kept;
            s_raw[buf][warp] = w_raw;
            s_over[buf][warp] = w_over;
        }

        // the one barrier of the pass, then every warp's totals
        int before = 0, all_kept = 0, all_raw = 0, any_over = 0;
        __syncthreads();
        if (lane < kWarps) {
            const int kw = s_kept[buf][lane];
            before = lane < warp ? kw : 0;
            all_kept = kw;
            all_raw = s_raw[buf][lane];
            any_over = s_over[buf][lane];
        }
        before = __reduce_add_sync(kFull, before);
        all_kept = __reduce_add_sync(kFull, all_kept);
        all_raw = __reduce_add_sync(kFull, all_raw);
        any_over = __reduce_or_sync(kFull, any_over);

        // the lane's kept columns: chunk rank below C, slot below M
        int sl[kPer];
        uint64_t kept_bits = 0;
        int o = base + before;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
            const int r = (excl >> (10 * q)) & 1023;
            sl[q] = o + r;
            const uint32_t kb = low_bits(m[q], min(C - r, M - sl[q]));
            kept_bits |= uint64_t(kb) << (16 * q);
            o += kq[q];
        }
        // their loads, kBatch at a time, before their stores
        uint64_t bits = kept_bits;
        while (bits) {
            uint64_t hv[kBatch];
            int32_t pv[kBatch], ev[kBatch];
            int jv[kBatch];
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
                jv[i] = -1;
                if (bits) {
                    const int b = __ffsll(static_cast<long long>(bits)) - 1;
                    bits &= bits - 1;
                    const int q = b >> 4, c = b & 15;
                    const uint32_t mq =
                        static_cast<uint32_t>(kept_bits >> (16 * q)) & 0xFFFFu;
                    const int sq = q == 0 ? sl[0] : (q == 1 ? sl[1] : sl[2]);
                    const int col = col0 + q * kChunk + c;
                    jv[i] = sq + __popc(mq & ((1u << c) - 1));
                    hv[i] = crow[col];
                    pv[i] = prow ? prow[col] : col;
                    ev[i] = erow ? erow[col] : 0;
                }
            }
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
                if (jv[i] < 0) continue;
                hrow[jv[i]] = hv[i];
                mprow[jv[i]] = pv[i];
                if (merow) merow[jv[i]] = ev[i];
            }
        }
        base += all_kept;
        raw += all_raw;
        over |= any_over;
    }

    const int n_min = min(raw, M);
    for (int j = min(base, M) + tid; j < M; j += kThreads) {
        if (j < n_min) {
            hrow[j] = crow[L - 1];
            mprow[j] = prow ? prow[L - 1] : L - 1;
            if (merow) merow[j] = erow[L - 1];
        } else {
            hrow[j] = 0;
            mprow[j] = 0;
            if (merow) merow[j] = 0;
        }
    }
    if (tid == 0) {
        n_min_out[row] = n_min;
        overflow[row] = (raw > M) || (two_level && over);
    }
}

// an empty kernel of the same grid and block shape: the card's
// cost of launching that grid, the floor of the kernel's queued time
__global__ void __launch_bounds__(kThreads) compact_floor_kernel() {}

}  // namespace

extern "C" int compact_minimizers_launch(
        const void* sel, const void* canon, const void* pos_map,
        const void* pme, void* minim_hash, void* minim_pos, void* mpe,
        void* n_min, void* overflow, int B, int L, int M, int C,
        int two_level, void* stream) {
    if (B <= 0 || M <= 0) return 0;
    if (L < 0 || L > INT_MAX - kPass * kChunk || C < 1)
        return cudaErrorInvalidValue;
    compact_minimizers_kernel<<<B, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sel), static_cast<const uint64_t*>(canon),
        static_cast<const int32_t*>(pos_map), static_cast<const int32_t*>(pme),
        static_cast<uint64_t*>(minim_hash), static_cast<int32_t*>(minim_pos),
        static_cast<int32_t*>(mpe), static_cast<int32_t*>(n_min),
        static_cast<uint8_t*>(overflow), L, M, C, two_level);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int compact_minimizers_floor_launch(int B, void* stream) {
    if (B <= 0) return 0;
    compact_floor_kernel<<<B, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
