// Fused canonical ntHash v1 + density selection over a [B, L] base-code batch.
//
// Replaces: rust_mdbg_tpu/ops/pallas_kernels.py, nthash_select_pallas (the
// Pallas body _kernel).  Same function:
//   fh(i)  = XOR_j rotl(H[c[i+j]], l-1-j)      j = 0..l-1
//   rh(i)  = XOR_j rotl(RC[c[i+j]], j)
//   canon  = min(fh, rh)                       (unsigned)
//   sel    = canon <= hash_bound && i + l <= len[row]
// Codes 4 (N) and 5 (other/pad) hash to 0, and so does any code above 5.
// Windows that run past the row end read code 4 (zero seed), like the plain
// torch version, so canon agrees bit for bit at every position, selected or
// not.
//
// Bound on the card: memory.  Each position reads 1 B of codes and writes
// 8 B of canon + 1 B of sel, ~10 B/position: at the main path's shape
// [512, 24576] that is ~126 MB, 0.0376 ms at 3.35 TB/s (H100 SXM).
//
// Why the closed form missed it (the first version of this file, 0.2591 ms
// on an H100 80GB HBM3 at 700 W, chip_smoke.py): it evaluated the l-term
// XOR at every position, each term a chain of dependent shared loads (the
// code byte, then two 64-bit seeds indexed by it) and two 64-bit rotates by
// a runtime count.  At l = 14 that is ~200 thread instructions and 42
// shared loads per position: the issue rate, not the bytes, set its time.
//
// The rolling design:
// - A thread owns a run of P = 16 consecutive positions of one row.  It
//   evaluates the first window in Horner form, l roll steps from an all-N
//   window, then rolls P-1 times:
//     fh(i+1) = rotl(fh(i), 1) ^ rotl(H[c[i]], l)    ^ H[c[i+l]]
//     rh(i+1) = rotr(rh(i), 1) ^ rotr(RC[c[i]], 1)   ^ rotl(RC[c[i+l]], l-1)
//   so a position costs one step plus l/P warm-up steps, not l terms.
// - Every runtime rotation is hoisted out: per block, the combined
//   (outgoing, incoming) terms {rotl(H[o], l) ^ H[i], rotr(RC[o], 1) ^
//   rotl(RC[i], l-1)} for codes 0..4 (4 = zero seed) sit in a 25-entry
//   shared table, one 16-byte load per step.  Every shift in the loop is
//   by 1.
// - A block covers one row tile of 4,096 positions.  It stages the tile's
//   codes plus an 80-byte halo in shared memory with 16-byte vector loads
//   (clamped to 4 with one byte-SIMD min per word); the thread reads its
//   outgoing codes as 16-byte vectors and its incoming ones as words
//   aligned with a funnel shift.  canon goes back through shared memory,
//   P values plus a 16-byte pad per thread so that neither the per-thread
//   writes nor the coalesced reads conflict on a bank, and out as 16-byte
//   stores; sel is packed P bytes per thread and stored as 16-byte vectors.
// - Rows whose base is not 16-byte aligned (odd L, a row slice at an odd
//   offset) and the row tail take byte loads and stores; nothing past L is
//   read or written.
//
// Measured at [512, 24576], l = 14 (chip_smoke.py, CUDA events over 50
// launches, NVIDIA H100 80GB HBM3 at 700 W): 0.0494 ms, 76 % of the byte
// bound.  P = 32, and a select chain on the code in registers in place of
// the table (as the Pallas _seed_lookup does), were slower at every l the
// main path runs (l <= 31); PERF.md keeps those numbers.
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

constexpr int kMaxL = 64;        // largest l the halo holds
constexpr int kP = 16;           // positions per thread
constexpr int kTile = 4096;      // positions per block
constexpr int kThreads = kTile / kP;
// codes staged per block: the tile, the l-1 halo, and the word the roll
// loop reads past its last incoming code; a multiple of 16
constexpr int kCodesBytes = kTile + kMaxL + 16;
constexpr int kCodes = 5;        // codes 0..3 plus the zero-seed code 4

// ntHash v1 seeds by code A C G T (ops/nthash.py H_BY_CODE); the reverse
// seed of code c is the forward seed of its complement, H[3 - c]
__device__ __forceinline__ uint64_t seed(int c) {
    return c == 0 ? 0x3C8BFBB395C60474ull
         : c == 1 ? 0x3193C18562A02B4Cull
         : c == 2 ? 0x20323ED082572324ull
         : c == 3 ? 0x295549F54BE24456ull : 0ull;
}

__device__ __forceinline__ uint64_t rev_seed(int c) {
    return c < 4 ? seed(3 - c) : 0ull;
}

// rotations by a runtime count: a shift by 64 is undefined in C, and
// l = 1 (rotl by l-1 = 0) and l = 64 (rotl by l = 64) both reach it
__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
    r &= 63;
    return r == 0 ? x : (x << r) | (x >> (64 - r));
}
__device__ __forceinline__ uint64_t rotr(uint64_t x, int r) {
    r &= 63;
    return r == 0 ? x : (x >> r) | (x << (64 - r));
}

__device__ __forceinline__ uint64_t umin(uint64_t a, uint64_t b) {
    return a < b ? a : b;
}

// one roll step: out the outgoing code co, in the incoming code ci
__device__ __forceinline__ void roll(uint64_t& fh, uint64_t& rh, uint32_t co,
                                     uint32_t ci, const ulonglong2* table) {
    const ulonglong2 e = table[co * kCodes + ci];
    fh = ((fh << 1) | (fh >> 63)) ^ e.x;
    rh = ((rh >> 1) | (rh << 63)) ^ e.y;
}

__global__ void __launch_bounds__(kThreads)
nthash_select_kernel(const uint8_t* __restrict__ codes,
                     const int32_t* __restrict__ lengths,
                     uint64_t* __restrict__ canon,
                     uint8_t* __restrict__ sel,
                     int L, int l, uint64_t bound) {
    constexpr int P = kP;
    constexpr int kStride = P + 2;   // u64 per thread in the canon stage
    static_assert(P % 16 == 0, "P packs whole 16-byte vectors");
    __shared__ __align__(16) uint8_t tile[kCodesBytes];
    __shared__ __align__(16) uint64_t stage[kThreads * kStride];
    __shared__ ulonglong2 table[kCodes * kCodes];

    const int tid = threadIdx.x;
    const int col0 = blockIdx.x * kTile;
    const int64_t base = static_cast<int64_t>(blockIdx.y) * L;
    const uint8_t* crow = codes + base;

    if (tid < kCodes * kCodes) {
        const int co = tid / kCodes, ci = tid % kCodes;
        table[tid] = make_ulonglong2(
            rotl(seed(co), l) ^ seed(ci),
            rotr(rev_seed(co), 1) ^ rotl(rev_seed(ci), l - 1));
    }

    // 1. stage codes [col0, col0 + kCodesBytes), code 4 past L, every code
    //    clamped to 4 (all of 4 and above hash to 0)
    const bool vec_in = (reinterpret_cast<uintptr_t>(crow) & 15) == 0;
    for (int q = tid; q < kCodesBytes / 16; q += kThreads) {
        const int c0 = col0 + q * 16;
        uint4 v;
        if (vec_in && c0 + 16 <= L) {
            v = __ldcs(reinterpret_cast<const uint4*>(crow + c0));
        } else {
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                uint32_t x = 0;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const int c = c0 + 4 * e + b;
                    x |= uint32_t(c < L ? crow[c] : uint8_t(4)) << (8 * b);
                }
                w[e] = x;
            }
            v = make_uint4(w[0], w[1], w[2], w[3]);
        }
        v.x = __vminu4(v.x, 0x04040404u);
        v.y = __vminu4(v.y, 0x04040404u);
        v.z = __vminu4(v.z, 0x04040404u);
        v.w = __vminu4(v.w, 0x04040404u);
        *reinterpret_cast<uint4*>(tile + q * 16) = v;
    }
    __syncthreads();

    // 2. the thread's run: positions p0 .. p0+P-1 of the tile
    const int p0 = tid * P;
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(tile);
    uint64_t fh = 0, rh = 0;
    // first window in Horner form: l steps in from an all-N window
    for (int s = 0; s < l; s += 4) {
        const uint32_t w = tw[(p0 + s) >> 2];
#pragma unroll
        for (int b = 0; b < 4; ++b)
            if (s + b < l)
                roll(fh, rh, 4, (w >> (8 * b)) & 0xFF, table);
    }
    // outgoing codes c[p0 + i] and incoming codes c[p0 + l + i], i < P
    uint32_t out_w[P / 4], in_w[P / 4];
#pragma unroll
    for (int m = 0; m < P / 16; ++m) {
        const uint4 v = *reinterpret_cast<const uint4*>(tile + p0 + 16 * m);
        out_w[4 * m] = v.x;
        out_w[4 * m + 1] = v.y;
        out_w[4 * m + 2] = v.z;
        out_w[4 * m + 3] = v.w;
    }
    {
        const int b0 = p0 + l;
        const int sh = 8 * (b0 & 3);
        uint32_t w[P / 4 + 1];
#pragma unroll
        for (int j = 0; j <= P / 4; ++j) w[j] = tw[(b0 >> 2) + j];
#pragma unroll
        for (int j = 0; j < P / 4; ++j)
            in_w[j] = __funnelshift_r(w[j], w[j + 1], sh);
    }

    const int len = lengths[blockIdx.y];
    const int cs = col0 + p0;          // row column of the run's start
    uint32_t sel_w[P / 4];
    uint64_t prev = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
        if (i > 0) {
            const int sh = 8 * ((i - 1) & 3);
            roll(fh, rh, (out_w[(i - 1) >> 2] >> sh) & 0xFF,
                 (in_w[(i - 1) >> 2] >> sh) & 0xFF, table);
        }
        const uint64_t cn = umin(fh, rh);
        if (i & 1) {
            *reinterpret_cast<ulonglong2*>(stage + tid * kStride + i - 1) =
                make_ulonglong2(prev, cn);
        } else {
            prev = cn;
        }
        const uint32_t s = (cn <= bound) && (cs + i + l <= len);
        if ((i & 3) == 0)
            sel_w[i >> 2] = s;
        else
            sel_w[i >> 2] |= s << (8 * (i & 3));
    }

    // 3. sel: P packed bytes per thread
    uint8_t* srow = sel + base;
    if ((reinterpret_cast<uintptr_t>(srow + cs) & 15) == 0 && cs + P <= L) {
#pragma unroll
        for (int m = 0; m < P / 16; ++m)
            __stcs(reinterpret_cast<uint4*>(srow + cs + 16 * m),
                   make_uint4(sel_w[4 * m], sel_w[4 * m + 1],
                              sel_w[4 * m + 2], sel_w[4 * m + 3]));
    } else {
#pragma unroll
        for (int i = 0; i < P; ++i)
            if (cs + i < L) srow[cs + i] = (sel_w[i >> 2] >> (8 * (i & 3))) & 1;
    }
    __syncthreads();

    // 4. canon: 16-byte chunks of the tile, neighbouring threads on
    //    neighbouring chunks
    uint64_t* orow = canon + base;
    const bool vec_out = (reinterpret_cast<uintptr_t>(orow) & 15) == 0;
    for (int g = tid; g < kTile / 2; g += kThreads) {
        const int owner = g / (P / 2), j = g % (P / 2);
        const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(
            stage + owner * kStride + 2 * j);
        const int c = col0 + 2 * g;
        if (vec_out && c + 2 <= L) {
            __stcs(reinterpret_cast<ulonglong2*>(orow + c), v);
        } else {
            if (c < L) orow[c] = v.x;
            if (c + 1 < L) orow[c + 1] = v.y;
        }
    }
}

}  // namespace

extern "C" int nthash_select_launch(const void* codes, const void* lengths,
                                    void* canon, void* sel, int B, int L,
                                    int l, unsigned long long bound,
                                    void* stream) {
    if (B <= 0 || L <= 0) return 0;
    if (l < 1 || l > kMaxL || B > 65535) return cudaErrorInvalidValue;
    const dim3 grid((L + kTile - 1) / kTile, B);
    nthash_select_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(lengths), static_cast<uint64_t*>(canon),
        static_cast<uint8_t*>(sel), L, l, static_cast<uint64_t>(bound));
    return static_cast<int>(cudaGetLastError());
}
