// Fused canonical ntHash v1 + density selection over a [B, L] base-code batch.
//
// Replaces: rust_mdbg_tpu/ops/pallas_kernels.py, nthash_select_pallas (the
// Pallas body _kernel).  Same function:
//   fh(i)  = XOR_j rotl(H[c[i+j]], l-1-j)      j = 0..l-1
//   rh(i)  = XOR_j rotl(RC[c[i+j]], j)
//   canon  = min(fh, rh)                       (unsigned)
//   sel    = canon <= hash_bound && i + l <= len[row]
// Codes 4 (N) and 5 (other/pad) hash to 0.  Windows that run past the row
// end read code 4 (zero seed), like the plain torch version, so canon agrees
// bit for bit at every position, selected or not.
//
// Bound on the card: memory.  Each position reads 1 B of codes and writes
// 8 B of canon + 1 B of sel, ~10 B/position.  At the main path's shape
// [512, 24576] that is ~126 MB, ~38 us at 3.35 TB/s (H100 SXM).  The closed
// form costs 2l rotations per position (l = 14: ~28 64-bit rotates plus the
// XORs), far below the integer rate, so the design only has to keep the
// traffic at one pass: a block stages one row tile of codes plus an l-1
// halo in shared memory, each thread evaluates the closed form for its
// positions from shared memory, and canon/sel are stored coalesced.  The
// rolling update fh(i+1) = rotl(fh(i),1) ^ rotl(H[c[i]],l) ^ H[c[i+l]] would
// cut the arithmetic to O(1) per base; it is a later optimisation.
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

constexpr int kTile = 1024;     // positions per block
constexpr int kThreads = 256;
constexpr int kMaxL = 64;       // largest l the halo buffer holds

__global__ void __launch_bounds__(kThreads)
nthash_select_kernel(const uint8_t* __restrict__ codes,
                     const int32_t* __restrict__ lengths,
                     uint64_t* __restrict__ canon,
                     uint8_t* __restrict__ sel,
                     int L, int l, uint64_t bound) {
    __shared__ uint8_t tile[kTile + kMaxL];
    __shared__ uint64_t seed_f[6];
    __shared__ uint64_t seed_r[6];

    if (threadIdx.x < 6) {
        // indexed by code: A C G T N other (ops/nthash.py H_BY_CODE/RC_BY_CODE)
        const uint64_t h[6] = {0x3C8BFBB395C60474ull, 0x3193C18562A02B4Cull,
                               0x20323ED082572324ull, 0x295549F54BE24456ull,
                               0ull, 0ull};
        seed_f[threadIdx.x] = h[threadIdx.x];
        seed_r[threadIdx.x] = threadIdx.x < 4 ? h[3 - threadIdx.x] : 0ull;
    }
    const int row = blockIdx.y;
    const int64_t base = static_cast<int64_t>(row) * L;
    const int col0 = blockIdx.x * kTile;
    for (int t = threadIdx.x; t < kTile + l - 1; t += kThreads) {
        const int c = col0 + t;
        const uint8_t v = c < L ? codes[base + c] : uint8_t(4);
        tile[t] = v > 5 ? uint8_t(5) : v;
    }
    __syncthreads();

    const int len = lengths[row];
    for (int t = threadIdx.x; t < kTile; t += kThreads) {
        const int col = col0 + t;
        if (col >= L) break;
        uint64_t fh = 0, rh = 0;
        for (int j = 0; j < l; ++j) {
            const int c = tile[t + j];
            const int rf = l - 1 - j;
            const uint64_t hf = seed_f[c];
            const uint64_t hr = seed_r[c];
            fh ^= rf ? (hf << rf) | (hf >> (64 - rf)) : hf;
            rh ^= j ? (hr << j) | (hr >> (64 - j)) : hr;
        }
        const uint64_t cn = fh < rh ? fh : rh;
        canon[base + col] = cn;
        sel[base + col] = (cn <= bound) && (col + l <= len);
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
        static_cast<const int32_t*>(lengths),
        static_cast<uint64_t*>(canon), static_cast<uint8_t*>(sel), L, l,
        static_cast<uint64_t>(bound));
    return static_cast<int>(cudaGetLastError());
}
