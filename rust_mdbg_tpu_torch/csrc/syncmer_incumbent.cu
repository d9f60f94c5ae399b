// Incumbent trace of the open-syncmer sliding minimum over a [B, L] batch.
//
// Counterpart of the three lax.scan passes of
// rust_mdbg_tpu/ops/syncmers_device.py (_incumbent_blocked) and of its
// column-by-column `scan` oracle.  Same function, row by row:
//   inc[-1] = -2^30
//   inc[a]  = run_start[a] ? lpos[a]
//           : (strict_new[a] || inc[a-1] < a) ? rpos[a] : inc[a-1]
// lpos / rpos are the leftmost / rightmost argmin of the w s-mers of l-mer
// window a, run_start marks the first full window of an N-free run and
// strict_new says that the entering s-mer is the window's strict minimum.
// The TPU form exists because a per-lane sequential loop is poison there;
// on Hopper the recurrence is a short loop in one thread.
//
// Design (simple and right; not the transfer-table form carried over):
// - One warp owns one row and walks it in tiles of kTile columns.
// - All 32 lanes load the tile's four planes with coalesced scalar loads
//   and fold them into two int32 planes in shared memory:
//     x[a]   = run_start ? lpos : rpos        (the value a forced column takes)
//     thr[a] = (run_start || strict_new) ? INT_MAX : a
//   so that the loop-carried step is one compare and one select,
//     inc = inc < thr[a] ? x[a] : inc,
//   with every load independent of inc.
// - Lane 0 walks the tile in register groups of 8 columns (16-byte shared
//   loads started one group ahead), overwriting x with the trace; all lanes
//   store it back coalesced.  The first version walked shared memory
//   column by column and took 1.007 ms at [512, 24576] (chip_smoke.py's
//   kernel check on an NVIDIA H100 80GB HBM3 at 700 W): two shared loads
//   sat on the loop-carried path of every column.
// Scalar loads and stores throughout, so odd L and unaligned row slices
// need no special case; nothing past L is read or written.
//
// Bound on the card: memory, 10 B read + 4 B written per position.  The
// walk is a dependent chain of ~2 instructions per column in one lane per
// row, so the kernel's time is set by that chain's latency times L, not by
// the bytes: the state matters only through `inc < a`, so a chunk's
// transfer is fixed by its first forced column, which would let the lanes
// of a warp walk sub-chunks in parallel.  That is left for later; PERF.md
// has the measured time beside the bound.
//
// No single PyTorch call computes this recurrence, so it has no library
// yardstick.
//
// Interface: plain C, loaded with ctypes (ops/kernels.py).  The launch goes
// on the caller's stream, does not synchronise and allocates nothing; the
// return value is cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;          // columns staged per step
constexpr int kGroup = 8;            // columns per register group of the walk
constexpr int kIncStart = -(1 << 30);
constexpr int kForce = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads)
syncmer_incumbent_kernel(const int32_t* __restrict__ lpos,
                         const int32_t* __restrict__ rpos,
                         const uint8_t* __restrict__ run_start,
                         const uint8_t* __restrict__ strict_new,
                         int32_t* __restrict__ incumbent, int B, int L) {
    __shared__ __align__(16) int32_t s_x[kWarps][kTile];
    __shared__ __align__(16) int32_t s_thr[kWarps][kTile];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    if (row >= B) return;  // whole warp leaves; only __syncwarp below

    const size_t base = static_cast<size_t>(row) * L;
    const int32_t* lp = lpos + base;
    const int32_t* rp = rpos + base;
    const uint8_t* st = run_start + base;
    const uint8_t* sn = strict_new + base;
    int32_t* out = incumbent + base;
    int32_t* x = s_x[warp];
    int32_t* thr = s_thr[warp];

    int inc = kIncStart;  // live in lane 0 only
    for (int t0 = 0; t0 < L; t0 += kTile) {
        const int n = min(kTile, L - t0);
        for (int j = lane; j < n; j += 32) {
            const int a = t0 + j;
            const bool s = st[a] != 0;
            x[j] = s ? lp[a] : rp[a];
            thr[j] = (s || sn[a] != 0) ? kForce : a;
        }
        __syncwarp();
        if (lane == 0) {
            // groups of kGroup columns: both planes come into registers as
            // 16-byte vectors, the next group's loads started before this
            // group's chain, so that no shared-memory latency sits on the
            // loop-carried path (columns past n hold stale data; their
            // results are never stored to global memory and inc is not
            // taken from them)
            const int4* xv = reinterpret_cast<const int4*>(x);
            const int4* tv = reinterpret_cast<const int4*>(thr);
            int4* ov = reinterpret_cast<int4*>(x);
            const int groups = (n + kGroup - 1) / kGroup;
            int4 xa = xv[0], xb = xv[1], ta = tv[0], tb = tv[1];
            for (int g = 0; g < groups; ++g) {
                const int gn = min(g + 1, groups - 1);
                const int4 nxa = xv[2 * gn], nxb = xv[2 * gn + 1];
                const int4 nta = tv[2 * gn], ntb = tv[2 * gn + 1];
                int xs[kGroup] = {xa.x, xa.y, xa.z, xa.w,
                                  xb.x, xb.y, xb.z, xb.w};
                const int ts[kGroup] = {ta.x, ta.y, ta.z, ta.w,
                                        tb.x, tb.y, tb.z, tb.w};
                const int live = min(kGroup, n - g * kGroup);
#pragma unroll
                for (int i = 0; i < kGroup; ++i) {
                    if (i < live) inc = inc < ts[i] ? xs[i] : inc;
                    xs[i] = inc;
                }
                ov[2 * g] = make_int4(xs[0], xs[1], xs[2], xs[3]);
                ov[2 * g + 1] = make_int4(xs[4], xs[5], xs[6], xs[7]);
                xa = nxa; xb = nxb; ta = nta; tb = ntb;
            }
        }
        __syncwarp();
        for (int j = lane; j < n; j += 32) out[t0 + j] = x[j];
        __syncwarp();
    }
}

}  // namespace

extern "C" int syncmer_incumbent_launch(const void* lpos, const void* rpos,
                                        const void* run_start,
                                        const void* strict_new,
                                        void* incumbent, int B, int L,
                                        void* stream) {
    if (B <= 0 || L <= 0) return 0;
    const int grid = (B + kWarps - 1) / kWarps;
    syncmer_incumbent_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(lpos), static_cast<const int32_t*>(rpos),
        static_cast<const uint8_t*>(run_start),
        static_cast<const uint8_t*>(strict_new),
        static_cast<int32_t*>(incumbent), B, L);
    return static_cast<int>(cudaGetLastError());
}
