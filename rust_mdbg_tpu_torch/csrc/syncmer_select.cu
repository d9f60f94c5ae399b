// Fused open-syncmer selection over a [B, L] batch of HPC base codes: the
// canonical l-mer hash and the selection in one pass.
//
// Takes the place of: the XLA code of rust_mdbg_tpu/ops/syncmers_device.py,
// syncmer_select_jax with its _packed_canonical_hash and _incumbent_blocked
// (no Pallas kernel there).  Same function as the port's plain version
// (ops/kernels.syncmer_select_plain: syncmer_planes, then the column scan):
//   ok[a]    = a < len && code[a] < 4
//   hl[a]    = invhash_{2l}(min(fwd_l(a), rc_l(a)))   if ok on [a, a+l-1]
//            = all ones                               otherwise
//   hs[a]    = the same at width s (all ones past L too)
//   s == 0:  sel[a] = valid_l[a] && hl[a] <= bound    ("kminmer" mode)
//   s > 0:   over the w = l - s + 1 s-mers of l-mer window a,
//            lpos / rpos = leftmost / rightmost argmin (0 / a+w-1 when all
//            are all ones), strict_new = hs[a+w-1] < min(hs[a..a+w-2]),
//            run_start = valid_l[a] && !valid_l[a-1], and the incumbent
//              inc[-1] = -2^30
//              inc[a]  = run_start ? lpos
//                      : (strict_new || inc[a-1] < a) ? rpos : inc[a-1]
//            sel[a] = valid_l[a] && hl[a] <= bound && inc[a] == a + t - 1,
//            t = ceil(w / 2)
// with fwd_l the 2-bit forward packing of the l-mer, rc_l that of its
// reverse complement and invhash the masked invertible mix of
// rust-mdbg src/read.rs:43-52.
//
// Bound on the card: memory.  1 B of codes read and 8 B of hl + 1 B of sel
// written per position, as nthash_select.cu: 0.0376 ms at the main path's
// [512, 24576] on an H100 SXM (3.35 TB/s).  Against that stand ~150 integer
// instructions a position (two invertible hashes, a w-way argmin) and a
// recurrence that is sequential along the row.
//
// Design:
// - One block of 256 threads owns one row and walks it in tiles of 2,048
//   columns.  A tile's codes, with 16 columns before it (the run-start test
//   reads column a-1) and a 48-column halo after it (l-1 <= 31 codes), are
//   staged in shared memory with 16-byte vector loads; codes >= 4 and
//   columns outside [0, len) are staged as 4.
// - Each thread owns 8 consecutive columns.  It rolls the forward and
//   reverse-complement packings of the l-mer and of the s-mer in registers
//   (one shift and one or per step) and tracks the latest bad code, so a
//   window is valid iff that code lies before it.  The hashes are computed in
//   32-bit words when 2l (2s) fits, in 64-bit words otherwise.  The s-mer
//   hashes go to shared memory (plus the w-1 halo columns after the tile).
// - From them each thread takes the argmins and strict_new of 8 columns
//   strided over the block (neighbouring threads on neighbouring words) and
//   folds each column into two int32 values:
//     x[a] = run_start ? lpos : rpos, thr[a] = forced ? INT_MAX : a,
//   so that a step of the recurrence is inc = inc < thr[a] ? x[a] : inc.
//   A column is forced at a run start or a strict new minimum (its value
//   does not depend on the incumbent before it), and where it has no valid
//   l-mer: such a column is never selected, and the valid column after it
//   is a run start, so the trace there is never read.  Without that rule
//   the tail of a row past its length (all s-mer hashes "none", all tied)
//   has no forced column, and traces out of phase never meet there.
// - Warp 0 walks the tile: lane i takes the 64-column sub-chunk i and walks
//   it speculatively from -2^30, as if the incumbent entering it were already
//   evicted.  That trace is exact whenever the true entering incumbent is
//   below the sub-chunk's first column, and exact from the sub-chunk's first
//   forced column on whatever the entry, so the exit of a sub-chunk with a
//   forced column is known at once.  The few lanes without one resolve in
//   order, each from the exit of the lane before (or of the tile before);
//   then every lane whose true entering incumbent is still in its window
//   re-walks in parallel from its first column until its value equals the
//   speculative trace's, after which the two are the same (at its first
//   forced column at the latest).  The result is exact for any data; long
//   fix-ups (all s-mer hashes equal: no forced column, and two traces out
//   of phase never meet) cost time, never correctness.  The 64-column rows
//   of the folded planes are padded to 65 words so that the 32 lanes read
//   distinct banks.
//   The first version resolved every lane in order, and neither it nor the
//   second forced the columns without a valid l-mer: the part of a row
//   past its HPC length walked in order at ~90 cycles a column, 1.28 ms a
//   launch at [512, 24576].  This version: 0.2587 ms, 14.5 % of the byte
//   bound (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W); what is left is
//   mostly warp 0 walking while the rest of its block waits.  A row of one
//   base (all s-mer hashes equal, which HPC'd reads never are) still walks
//   in order: 1.3577 ms for the check's eight adversarial rows.
// - hl goes out through shared memory as coalesced 16-byte stores, sel as
//   8 bytes per thread; rows whose base is not aligned (odd L, a row slice)
//   and the row tail take scalar stores.  Nothing past L is read or written.
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

constexpr int kP = 8;                       // columns per thread
constexpr int kThreads = 256;
constexpr int kTile = kP * kThreads;        // columns per step of a block
constexpr int kLead = 16;                   // staged columns before the tile
constexpr int kStage = kLead + kTile + 48;  // a multiple of 16
constexpr int kSub = kTile / 32;            // columns of a lane's sub-chunk
constexpr int kPadded = kTile + kTile / kSub;
constexpr int kHlStride = kP + 2;           // u64 per thread in the hl stage
constexpr int kMaxL = 32;
constexpr int kIncStart = -(1 << 30);
constexpr int kForce = 0x7FFFFFFF;

static_assert(kSub == 64, "pad() assumes 64-column sub-chunks");
static_assert(kThreads * kHlStride >= kTile + 32,
              "the hl stage aliases the s-mer hashes");

__device__ __forceinline__ int pad(int c) { return c + (c >> 6); }

template <typename T>
__device__ __forceinline__ T width_mask(int width) {
    return 2 * width >= 8 * static_cast<int>(sizeof(T))
        ? ~T(0) : (T(1) << (2 * width)) - 1;
}

// the invertible mix of rust-mdbg src/read.rs:43-52, masked to 2*width bits;
// for 2*width <= 32 the 32-bit form gives the same bits as the 64-bit one
template <typename T>
__device__ __forceinline__ T inv_hash(T key, T mask) {
    key = (~key + (key << 21)) & mask;
    key = key ^ (key >> 24);
    key = (key + (key << 3) + (key << 8)) & mask;
    key = key ^ (key >> 14);
    key = (key + (key << 2) + (key << 4)) & mask;
    key = key ^ (key >> 28);
    key = (key + (key << 31)) & mask;
    return key;
}

// forward and reverse-complement 2-bit packings of a sliding window, and
// the latest column that holds a bad code (4)
template <typename T>
struct Packer {
    T f = 0, r = 0;
    int bad = -(1 << 30);

    __device__ __forceinline__ void push(uint32_t c, int col, int width,
                                         T mask) {
        if (c > 3) bad = col;
        const T cc = static_cast<T>(c & 3);
        f = ((f << 2) | cc) & mask;
        r = (r >> 2) | (static_cast<T>(3 - (c & 3)) << (2 * (width - 1)));
    }
    __device__ __forceinline__ T canon() const { return f < r ? f : r; }
};

template <typename TL, typename TS>
__global__ void __launch_bounds__(kThreads)
syncmer_select_kernel(const uint8_t* __restrict__ codes,
                      const int32_t* __restrict__ lengths,
                      uint64_t* __restrict__ canon,
                      uint8_t* __restrict__ sel,
                      int L, int l, int s, uint64_t bound) {
    __shared__ __align__(16) uint8_t st[kStage];
    // s-mer hashes of the tile and its halo; later the hl stage
    __shared__ __align__(16) uint64_t hbuf[kThreads * kHlStride];
    __shared__ int32_t sx[kPadded], sthr[kPadded], str_[kPadded];
    // run-start and valid-l-mer bits, 8 columns a byte
    __shared__ uint8_t s_rs[kThreads], s_vl[kThreads];
    TS* hs = reinterpret_cast<TS*>(hbuf);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * L;
    const uint8_t* crow = codes + base;
    uint64_t* orow = canon + base;
    uint8_t* srow = sel + base;
    const int len = min(max(lengths[blockIdx.x], 0), L);
    const int w = l - s + 1;
    const int t = (w + 1) / 2;
    const TL lmask = width_mask<TL>(l);
    const TS smask = width_mask<TS>(s);
    const TS kNone = ~TS(0);
    const bool vec_in = (reinterpret_cast<uintptr_t>(crow) & 15) == 0;
    const bool vec_out = (reinterpret_cast<uintptr_t>(orow) & 15) == 0;
    const uint8_t* sc = st + kLead;   // sc[j]: code of tile column j
    const int p0 = tid * kP;

    int carry = kIncStart;  // warp 0: the incumbent entering the tile

    for (int t0 = 0; t0 < L; t0 += kTile) {
        // 1. stage the codes of columns [t0 - kLead, t0 - kLead + kStage)
        for (int q = tid; q < kStage / 16; q += kThreads) {
            const int c0 = t0 - kLead + q * 16;
            uint4 v;
            if (vec_in && c0 >= 0 && c0 + 16 <= len) {
                v = __ldcs(reinterpret_cast<const uint4*>(crow + c0));
            } else {
                uint32_t wd[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    uint32_t x = 0;
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const int c = c0 + 4 * e + b;
                        const uint32_t code =
                            (c >= 0 && c < len) ? crow[c] : 4u;
                        x |= code << (8 * b);
                    }
                    wd[e] = x;
                }
                v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
            }
            v.x = __vminu4(v.x, 0x04040404u);
            v.y = __vminu4(v.y, 0x04040404u);
            v.z = __vminu4(v.z, 0x04040404u);
            v.w = __vminu4(v.w, 0x04040404u);
            *reinterpret_cast<uint4*>(st + q * 16) = v;
        }
        __syncthreads();

        // 2. the thread's l-mer windows p0-1 .. p0+kP-1 (the first only
        //    for the run-start test) and s-mer windows p0 .. p0+kP-1
        uint64_t hl[kP];
        uint32_t vp = 0, rs = 0, vl = 0;
        {
            Packer<TL> pk;
            for (int j = 0; j < l - 1; ++j)
                pk.push(sc[p0 - 1 + j], p0 - 1 + j, l, lmask);
            bool prev_valid = false;
#pragma unroll
            for (int i = -1; i < kP; ++i) {
                const int a = p0 + i;
                pk.push(sc[a + l - 1], a + l - 1, l, lmask);
                const bool valid = pk.bad < a;
                if (i >= 0) {
                    const uint64_t h = valid
                        ? static_cast<uint64_t>(inv_hash<TL>(pk.canon(), lmask))
                        : ~0ull;
                    hl[i] = h;
                    vp |= uint32_t(valid && h <= bound) << i;
                    rs |= uint32_t(valid && !prev_valid) << i;
                    vl |= uint32_t(valid) << i;
                }
                prev_valid = valid;
            }
            s_rs[tid] = rs;
            s_vl[tid] = vl;
        }
        if (s > 0) {
            Packer<TS> pk;
            for (int j = 0; j < s - 1; ++j)
                pk.push(sc[p0 + j], p0 + j, s, smask);
#pragma unroll
            for (int i = 0; i < kP; ++i) {
                const int a = p0 + i;
                pk.push(sc[a + s - 1], a + s - 1, s, smask);
                hs[a] = pk.bad < a ? inv_hash<TS>(pk.canon(), smask) : kNone;
            }
            if (tid < w - 1) {  // halo: the s-mers after the tile
                const int a = kTile + tid;
                Packer<TS> ph;
                for (int j = 0; j < s; ++j)
                    ph.push(sc[a + j], a + j, s, smask);
                hs[a] = ph.bad < a ? inv_hash<TS>(ph.canon(), smask) : kNone;
            }
        }
        __syncthreads();

        // 3. fold each column into (x, thr); columns strided over the
        //    threads, so that neighbouring threads read neighbouring words
        if (s > 0) {
#pragma unroll
            for (int i = 0; i < kP; ++i) {
                const int a = tid + i * kThreads;
                TS best = kNone, best_w1 = kNone;
                int lp = 0, rp = 0;
                for (int j = 0; j < w; ++j) {
                    if (j == w - 1) best_w1 = best;
                    const TS h = hs[a + j];
                    if (h < best) lp = t0 + a + j;
                    if (h <= best) rp = t0 + a + j;
                    best = h < best ? h : best;
                }
                const bool strict_new = hs[a + w - 1] < best_w1;
                const bool run_start = (s_rs[a >> 3] >> (a & 7)) & 1;
                const bool valid = (s_vl[a >> 3] >> (a & 7)) & 1;
                sx[pad(a)] = run_start ? lp : rp;
                // a column without a valid l-mer is forced too: it is never
                // selected, and the valid column after it is a run start,
                // so the incumbent it carries is never read
                sthr[pad(a)] = (run_start || strict_new || !valid)
                    ? kForce : t0 + a;
            }
        }
        __syncthreads();

        // 4. hl into its stage (the s-mer hashes are dead); warp 0 walks
#pragma unroll
        for (int i = 0; i < kP; i += 2)
            *reinterpret_cast<ulonglong2*>(hbuf + tid * kHlStride + i) =
                make_ulonglong2(hl[i], hl[i + 1]);
        if (s > 0 && warp == 0) {
            // a. every lane walks its sub-chunk from an evicted incumbent,
            //    noting whether it holds a forced column: past one, the
            //    trace is the same whatever the entering incumbent was
            const int c0 = lane * kSub;
            int v = kIncStart;
            bool forced = false;
#pragma unroll 8
            for (int j = 0; j < kSub; ++j) {
                const int c = pad(c0 + j);
                const int th = sthr[c];
                forced |= th == kForce;
                v = v < th ? sx[c] : v;
                str_[c] = v;
            }
            const int spec_exit = v;
            // re-walk from the true entering incumbent u until the value
            // equals the speculative trace's (from there on the two are
            // the same); returns the sub-chunk's exit
            auto rewalk = [&](int u) {
                for (int j = 0; j < kSub; ++j) {
                    const int c = pad(c0 + j);
                    u = u < sthr[c] ? sx[c] : u;
                    if (u == str_[c]) return spec_exit;
                    str_[c] = u;
                }
                return u;
            };
            int ex = spec_exit;  // exact for a lane with a forced column
            // b. lanes without one carry their entry through: in order
            unsigned chain = __ballot_sync(0xFFFFFFFFu, !forced);
            while (chain) {
                const int i = __ffs(chain) - 1;
                chain &= chain - 1;
                int entry = __shfl_sync(0xFFFFFFFFu, ex, (i + 31) & 31);
                if (i == 0) entry = carry;
                if (lane == i && entry >= t0 + c0) ex = rewalk(entry);
            }
            // c. the lanes with one fix their heads in parallel
            int entry = __shfl_up_sync(0xFFFFFFFFu, ex, 1);
            if (lane == 0) entry = carry;
            if (forced && entry >= t0 + c0) rewalk(entry);
            carry = __shfl_sync(0xFFFFFFFFu, ex, 31);
        }
        __syncthreads();

        // 5. sel, 8 bytes per thread
        {
            uint32_t lo = 0, hi = 0;
#pragma unroll
            for (int i = 0; i < kP; ++i) {
                const int a = p0 + i;
                uint32_t b = (vp >> i) & 1;
                if (s > 0) b &= uint32_t(str_[pad(a)] == t0 + a + t - 1);
                if (i < 4) lo |= b << (8 * i);
                else hi |= b << (8 * (i - 4));
            }
            const int cs = t0 + p0;
            if ((reinterpret_cast<uintptr_t>(srow + cs) & 7) == 0 &&
                cs + kP <= L) {
                *reinterpret_cast<uint2*>(srow + cs) = make_uint2(lo, hi);
            } else {
#pragma unroll
                for (int i = 0; i < kP; ++i)
                    if (cs + i < L)
                        srow[cs + i] = ((i < 4 ? lo : hi) >> (8 * (i & 3))) & 1;
            }
        }
        // 6. hl: 16-byte chunks, neighbouring threads on neighbouring chunks
        for (int g = tid; g < kTile / 2; g += kThreads) {
            const int owner = g / (kP / 2), j = g % (kP / 2);
            const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(
                hbuf + owner * kHlStride + 2 * j);
            const int c = t0 + 2 * g;
            if (vec_out && c + 2 <= L) {
                __stcs(reinterpret_cast<ulonglong2*>(orow + c), v);
            } else {
                if (c < L) orow[c] = v.x;
                if (c + 1 < L) orow[c + 1] = v.y;
            }
        }
        __syncthreads();
    }
}

template <typename TL, typename TS>
cudaError_t launch(const void* codes, const void* lengths, void* canon,
                   void* sel, int B, int L, int l, int s, uint64_t bound,
                   cudaStream_t stream) {
    syncmer_select_kernel<TL, TS><<<B, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(lengths), static_cast<uint64_t*>(canon),
        static_cast<uint8_t*>(sel), L, l, s, bound);
    return cudaGetLastError();
}

}  // namespace

extern "C" int syncmer_select_launch(const void* codes, const void* lengths,
                                     void* canon, void* sel, int B, int L,
                                     int l, int s, unsigned long long bound,
                                     void* stream) {
    if (B <= 0 || L <= 0) return 0;
    if (l < 1 || l > kMaxL || s < 0 || s > l) return cudaErrorInvalidValue;
    const auto st = static_cast<cudaStream_t>(stream);
    const uint64_t b = static_cast<uint64_t>(bound);
    // 32-bit words where the masked values fit; the s-mer word also holds
    // the all-ones "none", which must stay above every valid hash
    const bool l32 = l <= 16, s32 = s <= 15;
    cudaError_t err;
    if (l32 && s32)
        err = launch<uint32_t, uint32_t>(codes, lengths, canon, sel, B, L, l,
                                         s, b, st);
    else if (l32)
        err = launch<uint32_t, uint64_t>(codes, lengths, canon, sel, B, L, l,
                                         s, b, st);
    else if (s32)
        err = launch<uint64_t, uint32_t>(codes, lengths, canon, sel, B, L, l,
                                         s, b, st);
    else
        err = launch<uint64_t, uint64_t>(codes, lengths, canon, sel, B, L, l,
                                         s, b, st);
    return static_cast<int>(err);
}
