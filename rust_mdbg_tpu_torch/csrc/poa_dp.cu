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
// Bound on the card: operations on paper ((6 x in-degree + 8) 32-bit
// operations a cell, the inputs and op rows read and written once), and in
// practice the chain: a pair's n node steps are sequential, each closed
// by a prefix max across the row, and its traceback is up to n + m
// dependent steps.  The EC legs launch 2-112 pairs, so at most 112 warps
// run on the card, each alone on its scheduler: a step costs its latency.
//
// Design: one warp a pair and a block, no block barrier.  The warps of a
// block would share nothing: one-warp blocks already share a
// multiprocessor as far as its shared memory allows (2 KB + 4 x R x Wp B a
// block), and a block of several pairs would need as many bytes a pair.
// Lane l owns a strip
// of C contiguous columns (l*C .. l*C + C - 1), C a template parameter
// (1, 2, 4, 6, 8 to 12, 16: the smallest that covers the launch's widest
// m + 1); a wider query is taken in register tiles of 32 x C columns, one
// after the other within each step, the prefix max carried from tile to
// tile.  Rows are kept in the keyed domain, K[j] = S[j] - j*ge, so that
// M(p) = K_p[j-1] + sub - ge, D(p) = K_p[j] + ge and the insertion
// closure is a plain prefix max: no column adds j*ge.  A step takes, for
// each predecessor in CSR order, its row at the strip and at the column
// left of it, keeps the first maximum (straight-line code for the common
// step whose one predecessor is the previous row), then closes
// insertions: a serial max along the strip, the exclusive prefix of the
// lane totals (the left neighbour's total while the totals never
// decrease from lane to lane, a warp vote away; else a 5-step shuffle
// scan), and a max with it.  The scan's identity is INT_MIN and every
// lane's own prefix is a real value, so nothing overflows.  Instruction
// count sets the pace of a lone warp: each of these choices was kept
// because it measured faster on the card.
//
// Where a predecessor's row comes from (its route), by its distance d in
// topological order: d = 1, the previous step's row, still in registers
// (one tile only; every predecessor on the EC legs' widest launch); d < R,
// a ring of rows in shared memory (R a power of two, 16 when the block's
// shared memory holds it); else the score matrix in global memory.  A
// pass before the DP (lane-parallel: ranks, each step's metadata into
// global scratch, 64 B a step, read back 32 steps at a time) flags the
// rows some later step reads from the ring or from global memory, and
// only those rows are written there; __syncwarp() orders such a row
// before later steps.  Rows are stored strip-major (column j of a tile at
// (j % C) * 32 + j / C), so each load and store is one 128 B line a warp.
// The three routes live in this one kernel; R = 0 sends every read past
// d = 1 to global memory.  When asked (a non-null `routes`), the pass also
// counts the predecessor reads of each route, the same rule the DP then
// follows, so that a check on the card sees which routes were taken.
//
// Traceback.  Kind and pred are packed in one 32-bit word a cell (kind in
// 2 bits, pred + 1 above: n < 2^29, asserted by the wrapper), 4 B a cell
// in global scratch instead of 9.  The terminal is chosen during the DP
// by the lane that owns column m (the largest (score, node)).  The warp
// walks the traceback in rounds: lane k reads the word k cells down the
// diagonal through the nodes that precede in topological order, and the
// round takes every cell up to the first that is not a match from the
// next of them (a vote), so a run of matches costs one load latency.  The
// warp then fills the pair's op rows past nops with -1.  A pair's matrix
// starts (node_off[g] + g) rows of Wp words into the scratch, its op rows
// at node_off[g] + q_off[g] + g.  The launch asks for the smallest
// shared-memory carveout, so the rest of the SM stays L1 for the words.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMatch = 0, kDel = 1, kIns = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPB = 4;             // predecessors kept in a step's metadata
// rank flags: the row is read back from the ring / from global memory
constexpr int kRing = 1 << 29, kFar = 1 << 30;
constexpr int kRankMask = kRing - 1;
// where a step finds a predecessor's row
constexpr int kRouteReg = 0, kRouteRing = 1, kRouteGlobal = 2;
// StepMeta flags
constexpr int kTerm = 1, kKeepGlobal = 2, kKeepRing = 4;

struct alignas(16) StepMeta {
    int node, e0, e1, flags;
    long long w;
    int pad0, pad1;
    int p[kPB];
    int r[kPB];
};  // 64 B

// The route of a predecessor d = t - rank(p) steps back: the previous
// step's row is still in registers (one tile only), the ring holds the
// last R rows, the rest is in global memory.
__device__ __forceinline__ int route_of(int d, bool reg, int R) {
    return reg && d == 1 ? kRouteReg : d < R ? kRouteRing : kRouteGlobal;
}

// Before the DP, lane-parallel over the pair's topological positions:
// ranks, then every step's metadata (in global scratch, read back 32 steps
// at a time) and which rows a later step reads from the ring or from
// global memory (only those rows are written there).
__device__ void prepare_pair(const long long* __restrict__ w,
                             const int* __restrict__ tp,
                             const int* __restrict__ po,
                             const int* __restrict__ pred_idx,
                             const unsigned char* __restrict__ te, int n,
                             int R, bool reg, int* rk, StepMeta* gm,
                             int* routes) {
    const int lane = threadIdx.x & 31;
    int taken[3] = {0, 0, 0};  // predecessor reads by route
    for (int t = lane; t < n; t += 32) rk[tp[t]] = t;
    __syncwarp();
    for (int t0 = 0; t0 < n; t0 += 128) {  // four steps a lane in flight
        int node[4], e0[4], e1[4], p[4][kPB];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int t = t0 + u * 32 + lane;
            node[u] = t < n ? tp[t] : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const bool in = t0 + u * 32 + lane < n;
            e0[u] = in ? po[node[u]] : 0;
            e1[u] = in ? po[node[u] + 1] : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int k = 0; k < kPB; ++k)
                p[u][k] = e0[u] + k < e1[u] ? pred_idx[e0[u] + k] : 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int t = t0 + u * 32 + lane;
            if (t >= n) continue;
            StepMeta md;
            md.node = node[u];
            md.e0 = e0[u];
            md.e1 = e1[u];
            md.flags = te[node[u]] ? kTerm : 0;
            md.w = w[node[u]];
            md.pad0 = md.pad1 = 0;
#pragma unroll
            for (int k = 0; k < kPB; ++k) {
                const bool has = e0[u] + k < e1[u];
                md.p[k] = p[u][k];
                md.r[k] = has ? rk[p[u][k]] & kRankMask : 0;
                const int route = route_of(t - md.r[k], reg, R);
                if (has) ++taken[route];
                if (has && route == kRouteRing) atomicOr(rk + p[u][k], kRing);
                if (has && route == kRouteGlobal) atomicOr(rk + p[u][k], kFar);
            }
            for (int e = e0[u] + kPB; e < e1[u]; ++e) {  // in-degree > 4
                const int q = pred_idx[e];
                const int route = route_of(t - (rk[q] & kRankMask), reg, R);
                ++taken[route];
                if (route == kRouteRing) atomicOr(rk + q, kRing);
                if (route == kRouteGlobal) atomicOr(rk + q, kFar);
            }
            gm[t] = md;
        }
    }
    if (routes != nullptr)
        for (int k = 0; k < 3; ++k)
            if (taken[k]) atomicAdd(routes + k, taken[k]);
    __syncwarp();
    for (int t = lane; t < n; t += 32) {
        const int f = rk[gm[t].node];
        gm[t].flags |= (f & kFar ? kKeepGlobal : 0) |
                       (f & kRing ? kKeepRing : 0);
    }
    __syncwarp();
}

struct Pair {
    int n, m, ntiles, Wp, R, ge, match, mismatch, tm, lm, cm;
    const long long* q;
    const int* pred_idx;
    int* rk;
    const StepMeta* gm;
    int* K;
    int* S;
};

// The DP rows of one pair, step after step; returns the terminal key
// (held by lane a.lm).  kOne: one register tile covers the query, so its
// symbols stay in registers and the previous row is a register route.
template <int C, bool kOne>
__device__ __forceinline__ long long dp_rows(const Pair& a) {
    // query symbols of the lane's strip: loaded once when one tile covers
    // the query, else again at every tile
    constexpr int kTile = 32 * C;
    const int lane = threadIdx.x & 31;
    const int rmask = a.R - 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    StepMeta* meta = reinterpret_cast<StepMeta*>(smem_raw);
    int* ring = reinterpret_cast<int*>(smem_raw + 32 * sizeof(StepMeta));
    long long key = LLONG_MIN;
    long long qs[C];
    auto load_strip = [&](int tile) {
        const int j0 = tile * kTile + lane * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = j0 + c;
            qs[c] = (j >= 1 && j <= a.m) ? a.q[j - 1] : 0;
        }
    };
    const int msub = a.match - a.ge, xsub = a.mismatch - a.ge;
    load_strip(0);
    int prev[C];  // the previous step's row (one tile only)
#pragma unroll
    for (int c = 0; c < C; ++c) prev[c] = 0;
    int prev_left = 0;

    for (int t0 = 0; t0 < a.n; t0 += 32) {
        if (t0 + lane < a.n) meta[lane] = a.gm[t0 + lane];
        __syncwarp();
        const int steps = min(32, a.n - t0);
        StepMeta md = meta[0];
        for (int s = 0; s < steps; ++s) {
            const StepMeta nmd = meta[s + 1 < steps ? s + 1 : s];
            const int t = t0 + s;
            const int i = md.node + 1;
            const int insw = (i << 2) | kIns;
            int run = INT_MIN;  // keyed prefix max of the earlier tiles
            for (int tile = 0; tile < (kOne ? 1 : a.ntiles); ++tile) {
                const int base = tile * kTile;
                if (!kOne) load_strip(tile);
                const int j0 = base + lane * C;
                const int li = lane > 0 ? (C - 1) * 32 + lane - 1 : -1;
                const bool has_left = j0 > 0;
                int sub[C], cand[C], word[C];
#pragma unroll
                for (int c = 0; c < C; ++c)
                    sub[c] = qs[c] == md.w ? msub : xsub;  // sub - ge
                if (md.e0 == md.e1) {  // the virtual source row: K = 0
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        cand[c] = sub[c];
                        word[c] = kMatch;
                    }
                }
                // one predecessor, the previous row: straight-line code
                const bool one_reg = kOne && md.e1 - md.e0 == 1 &&
                                     t - md.r[0] == 1;
                if (one_reg) {
                    const int pw = (md.p[0] + 1) << 2;
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        const int sm = (c == 0 ? prev_left : prev[c - 1]) +
                                       sub[c];
                        const int sd = prev[c] + a.ge;
                        cand[c] = max(sm, sd);
                        word[c] = pw | (sd > sm ? kDel : kMatch);
                    }
                }
                // the first maximum over [M(p0), D(p0), M(p1), ...]
                for (int e = one_reg ? md.e1 : md.e0; e < md.e1; ++e) {
                    const int k = e - md.e0;
                    int p, r;
                    if (k < kPB) {
                        p = k == 0 ? md.p[0] : k == 1 ? md.p[1]
                          : k == 2 ? md.p[2] : md.p[3];
                        r = k == 0 ? md.r[0] : k == 1 ? md.r[1]
                          : k == 2 ? md.r[2] : md.r[3];
                    } else {
                        p = a.pred_idx[e];
                        r = a.rk[p] & kRankMask;
                    }
                    const int route = route_of(t - r, kOne, a.R);
                    int lv, v[C];
                    if (route == kRouteReg) {
                        lv = prev_left;
#pragma unroll
                        for (int c = 0; c < C; ++c) v[c] = prev[c];
                    } else if (route == kRouteRing) {
                        const int* row = ring + (r & rmask) * a.Wp + base;
                        lv = has_left ? row[li] : 0;
#pragma unroll
                        for (int c = 0; c < C; ++c) v[c] = row[c * 32 + lane];
                    } else {
                        const int* row =
                            a.S + static_cast<size_t>(p + 1) * a.Wp + base;
                        lv = has_left ? row[li] : 0;
#pragma unroll
                        for (int c = 0; c < C; ++c) v[c] = row[c * 32 + lane];
                    }
                    const int pw = (p + 1) << 2;
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        const int sm = (c == 0 ? lv : v[c - 1]) + sub[c];
                        if (k == 0 || sm > cand[c]) {
                            cand[c] = sm;
                            word[c] = pw | kMatch;
                        }
                        const int sd = v[c] + a.ge;
                        if (sd > cand[c]) {
                            cand[c] = sd;
                            word[c] = pw | kDel;
                        }
                    }
                }
                // insertions: the prefix max of the keyed candidates
                if (j0 == 0) cand[0] = 0;  // column 0: base 0
                int val[C];
#pragma unroll
                for (int c = 0; c < C; ++c)
                    val[c] = c == 0 ? cand[0] : max(val[c - 1], cand[c]);
                // the exclusive prefix over the lanes: the left neighbour's
                // total (the carry for lane 0) while the totals never
                // decrease from lane to lane, else a 5-step shuffle scan
                int x = __shfl_up_sync(kFull, val[C - 1], 1);
                if (lane == 0) x = run;
                if (__any_sync(kFull, x > val[C - 1])) {
#pragma unroll
                    for (int o = 1; o < 32; o <<= 1) {
                        const int u = __shfl_up_sync(kFull, x, o);
                        if (lane >= o) x = max(x, u);
                    }
                }
                if (!kOne) run = __shfl_sync(kFull, max(x, val[C - 1]), 31);
                int* Kp = a.K + static_cast<size_t>(i) * a.Wp + base + lane;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    val[c] = max(val[c], x);
                    int wd = val[c] > cand[c] ? insw : word[c];
                    if (c == 0 && j0 == 0) wd = kDel;  // S = 0, kind D
                    Kp[c * 32] = wd;
                    prev[c] = val[c];
                }
                if (md.flags & kKeepRing) {
                    int* Rp = ring + (t & rmask) * a.Wp + base + lane;
#pragma unroll
                    for (int c = 0; c < C; ++c) Rp[c * 32] = val[c];
                }
                if (md.flags & kKeepGlobal) {
                    int* Sp = a.S + static_cast<size_t>(i) * a.Wp + base +
                              lane;
#pragma unroll
                    for (int c = 0; c < C; ++c) Sp[c * 32] = val[c];
                }
                if ((md.flags & kTerm) && tile == a.tm) {
                    int vm = val[0];
#pragma unroll
                    for (int c = 1; c < C; ++c)
                        if (c == a.cm) vm = val[c];
                    if (lane == a.lm)
                        key = max(key, static_cast<long long>(vm + a.m *
                                                              a.ge) *
                                           4294967296LL + md.node);
                }
            }
            // a row read back from memory is ordered before later steps
            if (md.flags & (kKeepRing | kKeepGlobal)) __syncwarp();
            prev_left = __shfl_up_sync(kFull, prev[C - 1], 1);
            md = nmd;
        }
        __syncwarp();  // meta is overwritten by the next chunk
    }
    return key;
}

template <int C>
__global__ void poa_dp_kernel(
    const int* __restrict__ node_off, const long long* __restrict__ wts,
    const int* __restrict__ topo, const int* __restrict__ pred_off,
    const int* __restrict__ pred_idx, const unsigned char* __restrict__ term,
    const int* __restrict__ q_off, const long long* __restrict__ queries,
    int* rank, StepMeta* gmeta, int* score, int* words, int* routes,
    int* __restrict__ best_out, int* __restrict__ ystart_out,
    int* __restrict__ nops_out, int* __restrict__ ops, int G, int Wp, int R,
    int ge, int match, int mismatch) {
    constexpr int kTile = 32 * C;
    const int lane = threadIdx.x;
    const int g = blockIdx.x;
    const int n0 = node_off[g], n = node_off[g + 1] - n0;
    const int q0 = q_off[g], m = q_off[g + 1] - q0;
    const int ntiles = (m + 1 + kTile - 1) / kTile;
    const bool reg = ntiles == 1;
    const long long* q = queries + q0;
    const int* tp = topo + n0;
    int* rk = rank + n0;
    StepMeta* gm = gmeta + n0;
    const size_t mat = static_cast<size_t>(n0 + g) * Wp;
    int* K = words + mat;
    int* S = score != nullptr ? score + mat : nullptr;

    prepare_pair(wts + n0, tp, pred_off + n0, pred_idx, term + n0, n, R, reg,
                 rk, gm, routes);

    // the owner of column m keeps the terminal key (score, node)
    const int tm = m / kTile, jm = m - tm * kTile;
    const int lm = jm / C, cm = jm - lm * C;
    Pair a{n, m, ntiles, Wp, R, ge, match, mismatch, tm, lm, cm, q,
           pred_idx, rk, gm, K, S};
    long long key = reg ? dp_rows<C, true>(a) : dp_rows<C, false>(a);
    __syncwarp();  // the traceback reads every lane's words

    key = __shfl_sync(kFull, key, lm);
    const int best = static_cast<int>(key & 0xffffffffLL);  // the node
    int* o = ops + 3 * static_cast<size_t>(n0 + q0 + g);

    // Traceback, a warp at a time: lane k reads the cell k steps down the
    // diagonal through the previous node in topological order; the path
    // follows that diagonal while each cell is a match from that node, so
    // one round of loads takes the whole run (at least one cell).
    int i = best + 1, j = m, nops = 0;
    bool done = false;
    while (!done && i > 0 && j > 0) {
        const int rr = (rk[i - 1] & kRankMask) - lane, jj = j - lane;
        const bool in = rr >= 0 && jj >= 1;
        const int nd = in ? tp[rr] : -1;
        int wd = 0;
        if (in) {
            const int tile = jj / kTile, x = jj - tile * kTile;
            wd = K[static_cast<size_t>(nd + 1) * Wp + tile * kTile +
                   (x % C) * 32 + x / C];
        }
        const int kd = wd & 3, p = (wd >> 2) - 1;
        const int nd_next = __shfl_down_sync(kFull, nd, 1);
        const bool cont = in && lane < 31 && kd == kMatch && p >= 0 &&
                          p == nd_next && jj > 1;
        const int f = __ffs(__ballot_sync(kFull, !cont)) - 1;
        if (lane <= f) {
            int* row = o + 3 * (nops + lane);
            row[0] = kd;
            row[1] = p;
            row[2] = kd == kIns ? p : nd;
        }
        nops += f + 1;
        const int wf = __shfl_sync(kFull, wd, f);
        const int kf = wf & 3, pf = (wf >> 2) - 1;
        i = __shfl_sync(kFull, nd, f) + 1;
        j -= f;
        if (pf >= 0) {
            i = pf + 1;
            if (kf != kDel) --j;
        } else if (kf == kMatch) {
            --j;
            done = true;
        } else if (kf == kDel) {
            done = true;
        } else {
            --i;
            --j;
        }
    }
    if (lane == 0) {
        best_out[g] = static_cast<int>((key - best) / 4294967296LL);
        ystart_out[g] = j;
        nops_out[g] = nops;
    }
    const int rows = n + m + 1;
    for (int x = 3 * nops + lane; x < 3 * rows; x += 32) o[x] = -1;
}

template <int C>
int launch(const void* node_off, const void* wts, const void* topo,
           const void* pred_off, const void* pred_idx, const void* term,
           const void* q_off, const void* queries, void* rank, void* meta,
           void* score, void* words, void* routes, void* best, void* ystart,
           void* nops, void* ops, int G, int Wp, int R, int ge, int match,
           int mismatch, cudaStream_t stream) {
    const size_t smem = 32 * sizeof(StepMeta) +
                        sizeof(int) * static_cast<size_t>(R) * Wp;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            poa_dp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    // the rest of the SM's 256 KB stays L1, which holds the traceback's
    // words
    const cudaError_t err = cudaFuncSetAttribute(
        poa_dp_kernel<C>, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxL1));
    if (err != cudaSuccess) return static_cast<int>(err);
    poa_dp_kernel<C><<<G, 32, smem, stream>>>(
        static_cast<const int*>(node_off), static_cast<const long long*>(wts),
        static_cast<const int*>(topo), static_cast<const int*>(pred_off),
        static_cast<const int*>(pred_idx),
        static_cast<const unsigned char*>(term),
        static_cast<const int*>(q_off),
        static_cast<const long long*>(queries), static_cast<int*>(rank),
        static_cast<StepMeta*>(meta), static_cast<int*>(score),
        static_cast<int*>(words), static_cast<int*>(routes),
        static_cast<int*>(best), static_cast<int*>(ystart),
        static_cast<int*>(nops), static_cast<int*>(ops), G, Wp, R, ge, match,
        mismatch);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strip: columns a lane holds (1, 2, 4, 6, 8 to 12, or 16); Wp: words a
// matrix row (a multiple of 32 x strip covering every pair's m + 1); R:
// ring rows in shared memory (0 or a power of two).  Scratch: rank (one
// int a node), meta (64 B a node), words ((Ntot + G) x Wp ints), score
// (the same size; may be null when no pair has n > R).  routes: null, or
// three zeroed ints that the launch adds its predecessor reads to by route
// (registers, ring, global).
extern "C" int poa_dp_launch(const void* node_off, const void* wts,
                             const void* topo, const void* pred_off,
                             const void* pred_idx, const void* term,
                             const void* q_off, const void* queries,
                             void* rank, void* meta, void* score,
                             void* words, void* routes,
                             void* best, void* ystart, void* nops, void* ops,
                             int G, int strip, int Wp, int R,
                             int ge, int match, int mismatch, void* stream) {
    if (G <= 0) return 0;
    if (R < 0 || (R & (R - 1)) != 0 || Wp <= 0 || Wp % (32 * strip) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define POA_LAUNCH(CC)                                                      \
    return launch<CC>(node_off, wts, topo, pred_off, pred_idx, term, q_off, \
                      queries, rank, meta, score, words, routes, best,     \
                      ystart, nops, ops, G, Wp, R, ge, match, mismatch, s)
    switch (strip) {
        case 1: POA_LAUNCH(1);
        case 2: POA_LAUNCH(2);
        case 4: POA_LAUNCH(4);
        case 6: POA_LAUNCH(6);
        case 8: POA_LAUNCH(8);
        case 9: POA_LAUNCH(9);
        case 10: POA_LAUNCH(10);
        case 11: POA_LAUNCH(11);
        case 12: POA_LAUNCH(12);
        case 16: POA_LAUNCH(16);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef POA_LAUNCH
}
