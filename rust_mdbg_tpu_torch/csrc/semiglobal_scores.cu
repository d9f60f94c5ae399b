// Semiglobal scores of a batch of queries against one linear template, in
// minimizer space: the EC driver's direction triage.
//
// Takes the place of: the XLA scan of rust_mdbg_tpu/ops/align.py,
// _make_scores_fn (lax.scan over template positions with an
// associative_scan per row; no Pallas kernel there).  Same function as the
// port's plain version (ops/align.semiglobal_scores_plain):
//   row_0[j]  = j * gap                                  (j = 0..Q)
//   for each template symbol t:
//     sub[j]  = j-1 < qlen ? (q[j-1] == t ? match : mismatch) : NEG
//     base[0] = 0,  base[j] = max(row[j-1] + sub[j], row[j] + gap)
//     row'[j] = max(base[j], max_{k <= j}(base[k] - k*gap) + j*gap)
//     row'[0] = 0
//   score     = row_T[qlen]
// (free start anywhere in the template, the query consumed whole), with
// NEG = -2^20 and 32-bit arithmetic: |row| stays below T + Q + 1 on the
// columns computed here.
//
// Bound on the card: operations.  The DP needs T x qlen cells per query,
// ~6 32-bit operations a cell, against 8 B a query symbol and a template
// symbol read once and 4 B a score written.  What sets the time in
// practice is the dependence: T sequential rows, each closed by a prefix
// max across the row, and a launch of the EC legs holds 2-16 queries.
//
// Design: one warp per query, no block barrier after the template is
// staged.  Column j of row_T depends on columns <= j only, so a query
// computes its qlen + 1 columns and never the NEG ones.  Lane l keeps the
// row as a strip of C contiguous columns (l*C .. l*C + C - 1) in
// registers, beside its C query symbols; C is a template parameter (1, 2,
// 4, 6, 8 to 12, 16), the smallest strip that covers the launch's Q + 1.
// The row is kept in the keyed domain, K[j] = row[j] - j*gap, so the
// insertion closure is a plain prefix max and no column adds j*gap: a
// template row costs one __shfl_up_sync for the diagonal neighbour of the
// strip's first column (the left lane's last old value), a serial max
// along the strip, a 6-step shuffle scan of the lane totals (one shift,
// five max steps: the exclusive prefix) and a max with it: about 7
// shuffle latencies a row instead of ten 32-column segments of 8.  The
// scan identity is INT_MIN, and every lane's own prefix is a real value,
// so nothing overflows; the score is K_T[qlen] + qlen*gap.  A query wider
// than 32 x 16 columns is taken in register tiles of 512 columns, tile
// after tile: each tile hands the next its last column's K, row by row,
// through a boundary of T + 1 ints per query in global scratch (ping-pong
// between tiles, read 32 rows at a time).  The template is staged in
// shared memory once per block, 8 B a symbol, up to 6,144 symbols (48
// KB); rows past that read it through the cache.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageMax = 6144;  // template symbols staged a block

// One register tile of a query (columns s .. s + 32*C - 1) through all T
// template rows.  The row is kept in the keyed domain, K[j] = row[j] -
// j*gap: the base of column j is max(K[j-1] + sub - gap, K[j] + gap), the
// insertion closure is the plain prefix max, row_0 is all zeros, and a
// tile's boundary for the next one is its last column's K, row by row.
template <int C>
__device__ __forceinline__ void scores_tile(
    const long long* __restrict__ tsh, int staged,
    const long long* __restrict__ tmpl, int T,
    const long long* __restrict__ q, int qlen, int s, bool first,
    bool last, const int* bin, int* bout, int* __restrict__ out_b, int gap,
    int match, int mismatch) {
    const int lane = threadIdx.x & 31;
    const int j0 = s + lane * C;
    const int msub = match - gap, xsub = mismatch - gap;
    long long qs[C];
    int row[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        qs[c] = (j >= 1 && j <= qlen) ? q[j - 1] : 0;
        row[c] = 0;  // row_0
    }
    if (!last && lane == 31) bout[0] = 0;
    int bl = 0, bp = INT_MIN;  // incoming boundary, 32 rows at a time
    long long ts = T > 0 ? (staged > 0 ? tsh[0] : tmpl[0]) : 0;
    for (int t = 0; t < T; ++t) {
        if (!first && (t & 31) == 0) {
            const int tr = t + lane;
            if (tr < T) {
                bl = bin[tr];      // row_tr at column s - 1
                bp = bin[tr + 1];  // and row_tr+1, its prefix max
            }
        }
        const long long tcur = ts;
        if (t + 1 < T) ts = t + 1 < staged ? tsh[t + 1] : tmpl[t + 1];
        // the diagonal neighbour of column j0: old value of column j0 - 1
        int left = __shfl_up_sync(kFull, row[C - 1], 1);
        int inP = INT_MIN;
        if (!first) {
            const int inL = __shfl_sync(kFull, bl, t & 31);
            inP = __shfl_sync(kFull, bp, t & 31);
            if (lane == 0) left = inL;
        }
        int pre[C];
        pre[0] = j0 == 0 ? 0
                         : max(left + (qs[0] == tcur ? msub : xsub),
                               row[0] + gap);
#pragma unroll
        for (int c = 1; c < C; ++c)
            pre[c] = max(pre[c - 1],
                         max(row[c - 1] + (qs[c] == tcur ? msub : xsub),
                             row[c] + gap));
        // exclusive prefix over the lanes, the carry from earlier tiles
        // entering at lane 0
        int x = __shfl_up_sync(kFull, pre[C - 1], 1);
        if (lane == 0) x = inP;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(kFull, x, o);
            if (lane >= o) x = max(x, u);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) row[c] = max(pre[c], x);
        if (!last && lane == 31) bout[t + 1] = row[C - 1];
    }
    if (!last) {
        __syncwarp();  // the boundary is read by the next tile
        return;
    }
    const int jj = qlen - j0;
    if (jj >= 0 && jj < C) {
        int v = 0;
#pragma unroll
        for (int c = 0; c < C; ++c)
            if (c == jj) v = row[c];
        *out_b = v + qlen * gap;
    }
}

template <int C>
__global__ void semiglobal_scores_kernel(
    const long long* __restrict__ tmpl, int T,
    const long long* __restrict__ queries, const int* __restrict__ qlens,
    int B, int Q, int* __restrict__ out, int* bnd, int gap, int match,
    int mismatch) {
    extern __shared__ long long tsh[];
    const int staged = min(T, kStageMax);
    for (int i = threadIdx.x; i < staged; i += blockDim.x) tsh[i] = tmpl[i];
    __syncthreads();  // the only block barrier
    const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= B) return;
    const long long* q = queries + static_cast<size_t>(b) * Q;
    const int qlen = qlens[b];
    constexpr int kTile = 32 * C;
    const int ntiles = (qlen + 1 + kTile - 1) / kTile;
    int* b0 = ntiles > 1 ? bnd + static_cast<size_t>(b) * 2 * (T + 1)
                         : nullptr;
    int* b1 = ntiles > 1 ? b0 + (T + 1) : nullptr;
    for (int k = 0; k < ntiles; ++k) {
        scores_tile<C>(tsh, staged, tmpl, T, q, qlen, k * kTile, k == 0,
                       k == ntiles - 1, (k & 1) ? b0 : b1, (k & 1) ? b1 : b0,
                       out + b, gap, match, mismatch);
    }
}

template <int C>
int launch(const void* tmpl, int T, const void* queries, const void* qlens,
           int B, int Q, void* out, void* scratch, int warps, int gap,
           int match, int mismatch, cudaStream_t stream) {
    const size_t smem = sizeof(long long) * min(T, kStageMax);
    const int blocks = (B + warps - 1) / warps;
    semiglobal_scores_kernel<C><<<blocks, 32 * warps, smem, stream>>>(
        static_cast<const long long*>(tmpl), T,
        static_cast<const long long*>(queries),
        static_cast<const int*>(qlens), B, Q, static_cast<int*>(out),
        static_cast<int*>(scratch), gap, match, mismatch);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strip: columns a lane holds (1, 2, 4, 6, 8 to 12, or 16); warps:
// queries a block; scratch: 2 x (T + 1) int32 a query when a query's
// qlen + 1 passes 32 x strip (the tile boundaries), else may be null.
extern "C" int semiglobal_scores_launch(const void* tmpl, int T,
                                        const void* queries,
                                        const void* qlens, int B, int Q,
                                        void* out, void* scratch, int strip,
                                        int warps, int gap, int match,
                                        int mismatch, void* stream) {
    if (B <= 0) return 0;
    if (T < 0 || Q < 0 || warps < 1 || warps > 32)
        return static_cast<int>(cudaErrorInvalidValue);
    if (Q + 1 > 32 * strip && scratch == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (strip) {
        case 1: return launch<1>(tmpl, T, queries, qlens, B, Q, out, scratch,
                                 warps, gap, match, mismatch, s);
        case 2: return launch<2>(tmpl, T, queries, qlens, B, Q, out, scratch,
                                 warps, gap, match, mismatch, s);
        case 4: return launch<4>(tmpl, T, queries, qlens, B, Q, out, scratch,
                                 warps, gap, match, mismatch, s);
#define SCORES_LAUNCH(CC)                                                    \
    return launch<CC>(tmpl, T, queries, qlens, B, Q, out, scratch, warps,    \
                      gap, match, mismatch, s)
        case 6: SCORES_LAUNCH(6);
        case 8: SCORES_LAUNCH(8);
        case 9: SCORES_LAUNCH(9);
        case 10: SCORES_LAUNCH(10);
        case 11: SCORES_LAUNCH(11);
        case 12: SCORES_LAUNCH(12);
        case 16: SCORES_LAUNCH(16);
#undef SCORES_LAUNCH
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
