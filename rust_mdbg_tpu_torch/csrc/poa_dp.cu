// POA semiglobal DP and traceback over a batch of (graph, query) pairs, in
// minimizer space: the lockstep EC driver's graph alignment.
//
// Takes the place of: the XLA code of rust_mdbg_tpu/ops/poa_device.py,
// _dp_single vmapped by _dp_batched (a fori_loop over topological
// positions, a log-step cummax, a bounded traceback; no Pallas kernel
// there).  Same function as the port's plain version
// (ops/poa_device.poa_dp_plain) and as models/poa.PoaGraph._semiglobal_vec
// with _traceback_vec, tie-breaks included:
//   rows i = 0 (virtual source), node + 1; columns j = 0..m
//   S[0][j] = j*ge, kind I (M at j = 0), pred none
//   S[i][0] = 0, kind D, pred none
//   for node in topological order, i = node + 1, for j >= 1:
//     sub     = q[j-1] == w[node] ? match : mismatch
//     no preds: cand = S[0][j-1] + sub, kind M, pred none
//     else:     the FIRST maximum over [M(p0), D(p0), M(p1), D(p1), ...]
//               in pred list order, M(p) = S[p+1][j-1] + sub,
//               D(p) = S[p+1][j] + ge
//     S[i][j] = max_{k <= j}(base[k] - k*ge) + j*ge, base = (0, cand...)
//     an insertion (kind I, pred node) only where S[i][j] > cand
//   best = the LAST maximum of S[v+1][m] over terminals v (out-degree 0)
//   traceback from (best + 1, m) into op rows (kind, pred, node)
//
// Bound on the card: operations, and in practice the dependence.  A pair
// needs (n x m) cells, each in-degree x 4 operations plus the scan, and
// writes 9 B a cell (score int32, kind int8, pred int32) that the
// traceback reads back; the n node steps of a pair are sequential.
//
// Design: one block per pair, looping over the pair's n topological
// positions.  A step walks the node's row in segments of blockDim
// columns, thread i on column s + i (coalesced): it gathers the
// predecessor rows from the score matrix in global scratch (written by
// earlier steps, in L1/L2), takes the first maximum of the interleaved
// candidates, and closes insertions by a block-wide inclusive max scan
// (warp shuffles, then a scan of the warp totals), carried from segment to
// segment.  The score, kind and pred rows go to global scratch the
// wrapper allocates at the pair's exact size ((n + 1) x (m + 1) cells);
// a barrier per step orders them before the next node reads them.  The
// terminal choice is a block reduction of (score, node) pairs; one thread
// walks the traceback.  Any in-degree and any n, m are taken: the pred
// lists are CSR, nothing is bucketed.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMatch = 0, kDel = 1, kIns = 2;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive max scan of v over the block (blockDim.x a multiple of 32);
// *total receives the block's maximum.  Three barriers; `warp_max` holds
// 32 ints.
__device__ int block_scan_max(int v, int* warp_max, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v = max(v, u);
    }
    if (lane == 31) warp_max[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int x = lane < nwarps ? warp_max[lane] : INT_MIN;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(kFull, x, o);
            if (lane >= o) x = max(x, u);
        }
        if (lane < nwarps) warp_max[lane] = x;
    }
    __syncthreads();
    if (warp > 0) v = max(v, warp_max[warp - 1]);
    *total = warp_max[nwarps - 1];
    __syncthreads();
    return v;
}

__global__ void poa_dp_kernel(
    const int* __restrict__ node_off, const long long* __restrict__ wts,
    const int* __restrict__ topo, const int* __restrict__ pred_off,
    const int* __restrict__ pred_idx, const unsigned char* __restrict__ term,
    const int* __restrict__ q_off, const long long* __restrict__ queries,
    const long long* __restrict__ cell_off,
    const long long* __restrict__ ops_off, int* score, signed char* kind,
    int* predm, int* __restrict__ best_out, int* __restrict__ ystart_out,
    int* __restrict__ nops_out, int* __restrict__ ops, int ge, int match,
    int mismatch) {
    __shared__ int warp_max[32];
    __shared__ long long red[32];
    const int g = blockIdx.x;
    const int tid = threadIdx.x, bd = blockDim.x;
    const int n0 = node_off[g], n = node_off[g + 1] - n0;
    const int m = q_off[g + 1] - q_off[g];
    const int W = m + 1;
    const long long* w = wts + n0;
    const int* tp = topo + n0;
    const int* po = pred_off + n0;
    const unsigned char* te = term + n0;
    const long long* q = queries + q_off[g];
    int* S = score + cell_off[g];
    signed char* K = kind + cell_off[g];
    int* Pm = predm + cell_off[g];

    for (int j = tid; j < W; j += bd) {
        S[j] = j * ge;
        K[j] = j == 0 ? kMatch : kIns;
        Pm[j] = -1;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
        const int node = tp[t];
        const long long r = w[node];
        const int e0 = po[node], e1 = po[node + 1];
        const size_t ro = static_cast<size_t>(node + 1) * W;
        int run_carry = INT_MIN;
        for (int s = 0; s < W; s += bd) {
            const int j = s + tid;
            const bool in = j < W;
            int cand = 0, kmd = kDel, pmd = -1, base = 0;
            if (in && j > 0) {
                const int sub = q[j - 1] == r ? match : mismatch;
                if (e0 == e1) {
                    cand = S[j - 1] + sub;  // the virtual source row
                    kmd = kMatch;
                } else {
                    for (int e = e0; e < e1; ++e) {
                        const int p = pred_idx[e];
                        const int* pr = S + static_cast<size_t>(p + 1) * W;
                        const int sm = pr[j - 1] + sub;
                        if (e == e0 || sm > cand) {
                            cand = sm;
                            kmd = kMatch;
                            pmd = p;
                        }
                        const int sd = pr[j] + ge;
                        if (sd > cand) {
                            cand = sd;
                            kmd = kDel;
                            pmd = p;
                        }
                    }
                }
                base = cand;
            }
            int total;
            int keyed = block_scan_max(in ? base - j * ge : INT_MIN,
                                       warp_max, &total);
            keyed = max(keyed, run_carry);
            run_carry = max(run_carry, total);
            if (in) {
                if (j == 0) {
                    S[ro] = 0;
                    K[ro] = kDel;
                    Pm[ro] = -1;
                } else {
                    const int v = keyed + j * ge;
                    const bool ins = v > cand;
                    S[ro + j] = v;
                    K[ro + j] = static_cast<signed char>(ins ? kIns : kmd);
                    Pm[ro + j] = ins ? node : pmd;
                }
            }
        }
        __syncthreads();  // the row is read by later nodes
    }

    // terminal choice: the last maximum = the largest (score, node)
    long long key = LLONG_MIN;
    for (int v = tid; v < n; v += bd) {
        if (te[v]) {
            const int sv = S[static_cast<size_t>(v + 1) * W + m];
            key = max(key, static_cast<long long>(sv) * 4294967296LL + v);
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        key = max(key, __shfl_down_sync(kFull, key, o));
    if ((tid & 31) == 0) red[tid >> 5] = key;
    __syncthreads();
    if (tid != 0) return;
    for (int i = 1; i < (bd >> 5); ++i) key = max(key, red[i]);
    const int best = static_cast<int>(key & 0xffffffffLL);   // the node
    const int best_s = static_cast<int>((key - best) / 4294967296LL);

    int* o = ops + 3 * ops_off[g];
    int i = best + 1, j = m, nops = 0;
    while (i > 0 && j > 0) {
        const size_t c = static_cast<size_t>(i) * W + j;
        const int k = K[c], p = Pm[c];
        o[3 * nops] = k;
        o[3 * nops + 1] = p;
        o[3 * nops + 2] = k == kIns ? p : i - 1;
        ++nops;
        if (p >= 0) {
            i = p + 1;
            if (k != kDel) --j;
        } else if (k == kMatch) {
            --j;
            break;
        } else if (k == kDel) {
            break;
        } else {
            --i;
            --j;
        }
    }
    best_out[g] = best_s;
    ystart_out[g] = j;
    nops_out[g] = nops;
}

}  // namespace

extern "C" int poa_dp_launch(const void* node_off, const void* wts,
                             const void* topo, const void* pred_off,
                             const void* pred_idx, const void* term,
                             const void* q_off, const void* queries,
                             const void* cell_off, const void* ops_off,
                             void* score, void* kind, void* predm,
                             void* best, void* ystart, void* nops, void* ops,
                             int G, int threads, int ge, int match,
                             int mismatch, void* stream) {
    if (G <= 0) return 0;
    if (threads < 32 || threads > 1024 || threads % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    poa_dp_kernel<<<G, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(node_off), static_cast<const long long*>(wts),
        static_cast<const int*>(topo), static_cast<const int*>(pred_off),
        static_cast<const int*>(pred_idx),
        static_cast<const unsigned char*>(term),
        static_cast<const int*>(q_off),
        static_cast<const long long*>(queries),
        static_cast<const long long*>(cell_off),
        static_cast<const long long*>(ops_off), static_cast<int*>(score),
        static_cast<signed char*>(kind), static_cast<int*>(predm),
        static_cast<int*>(best), static_cast<int*>(ystart),
        static_cast<int*>(nops), static_cast<int*>(ops), ge, match, mismatch);
    return static_cast<int>(cudaGetLastError());
}
