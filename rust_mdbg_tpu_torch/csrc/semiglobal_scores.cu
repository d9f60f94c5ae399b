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
// NEG = -2^20 and 32-bit arithmetic: |row| stays below 2^20 + T + Q.
//
// Bound on the card: operations.  The DP needs T x qlen cells per query,
// ~6 32-bit operations a cell, against 8 B a query symbol and a template
// symbol read once and 4 B a score written.  What sets the time in
// practice is the dependence: T sequential rows, each with a prefix max
// across the row.
//
// Design: one warp per query, so no block-wide barrier is ever needed.
// The row lives in shared memory (Q + 1 int32 per warp, four warps a
// block) when it fits in 48 KB, else in global scratch the wrapper
// allocates.  Each template step walks the row in segments of 32 columns,
// lane i on column s + i (coalesced, no bank conflicts): the diagonal
// neighbour comes from the lane to the left by a shuffle (from the
// previous segment's lane 31 for lane 0), the in-row prefix max is a
// five-step shuffle scan carried from segment to segment.  The template
// symbol is a broadcast load each step.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kNeg = -(1 << 20);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps (queries) per block
constexpr int kSmemLimit = 48 * 1024;

__global__ void semiglobal_scores_kernel(
    const long long* __restrict__ tmpl, int T,
    const long long* __restrict__ queries, const int* __restrict__ qlens,
    int B, int Q, int* __restrict__ out, int* gscratch, int gap, int match,
    int mismatch) {
    extern __shared__ int smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + warp;
    if (b >= B) return;  // a whole warp leaves: no barrier below
    const int W = Q + 1;
    int* row = gscratch != nullptr ? gscratch + static_cast<size_t>(b) * W
                                   : smem + warp * W;
    const long long* q = queries + static_cast<size_t>(b) * Q;
    const int qlen = qlens[b];

    for (int j = lane; j < W; j += 32) row[j] = j * gap;
    __syncwarp();

    for (int t = 0; t < T; ++t) {
        const long long ts = tmpl[t];
        int left_carry = 0;       // old row value of the column before s
        int run_carry = INT_MIN;  // prefix max of keyed before s
        for (int s = 0; s < W; s += 32) {
            const int j = s + lane;
            const bool in = j < W;
            const int old = in ? row[j] : 0;
            int left = __shfl_up_sync(kFull, old, 1);
            if (lane == 0) left = left_carry;
            const int seg_last_old = __shfl_sync(kFull, old, 31);
            int base = 0;
            if (in && j > 0) {
                const int sub = (j - 1 < qlen)
                                    ? (q[j - 1] == ts ? match : mismatch)
                                    : kNeg;
                base = max(left + sub, old + gap);
            }
            int keyed = in ? base - j * gap : INT_MIN;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(kFull, keyed, o);
                if (lane >= o) keyed = max(keyed, v);
            }
            keyed = max(keyed, run_carry);
            if (in) row[j] = (j == 0) ? 0 : max(base, keyed + j * gap);
            run_carry = __shfl_sync(kFull, keyed, 31);
            left_carry = seg_last_old;
        }
        __syncwarp();
    }
    if (lane == 0) out[b] = row[qlen];
}

}  // namespace

// The row storage the launch needs: 0 when the rows fit in shared memory,
// else the int32 count of global scratch (B x (Q + 1)) to pass.
extern "C" long long semiglobal_scores_scratch(int B, int Q) {
    const long long smem = 4LL * kWarps * (Q + 1);
    return smem <= kSmemLimit ? 0 : static_cast<long long>(B) * (Q + 1);
}

extern "C" int semiglobal_scores_launch(const void* tmpl, int T,
                                        const void* queries,
                                        const void* qlens, int B, int Q,
                                        void* out, void* scratch, int gap,
                                        int match, int mismatch,
                                        void* stream) {
    if (B <= 0) return 0;
    if (T < 0 || Q < 0) return static_cast<int>(cudaErrorInvalidValue);
    const bool global_rows = semiglobal_scores_scratch(B, Q) > 0;
    if (global_rows && scratch == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem =
        global_rows ? 0 : sizeof(int) * kWarps * static_cast<size_t>(Q + 1);
    const int blocks = (B + kWarps - 1) / kWarps;
    semiglobal_scores_kernel<<<blocks, 32 * kWarps, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(tmpl), T,
        static_cast<const long long*>(queries),
        static_cast<const int*>(qlens), B, Q, static_cast<int*>(out),
        global_rows ? static_cast<int*>(scratch) : nullptr, gap, match,
        mismatch);
    return static_cast<int>(cudaGetLastError());
}
