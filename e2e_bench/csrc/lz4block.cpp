// One LZ4 block decoded, as the public LZ4 block format defines it: a
// sequence is a token (literal length high nibble, match length low
// nibble, 15 meaning more bytes follow), the literals, a 16-bit offset
// and the match, at least 4 bytes, copied a byte at a time so that it may
// overlap itself.  `dst` holds `prefix` bytes of what came before the
// block in its frame (linked blocks) and room for `cap` more.  Returns
// the bytes decoded, or -1 where the block is malformed.
#include <stdint.h>

extern "C" int64_t lz4_block_decode(const uint8_t* src, int64_t n,
                                    uint8_t* dst, int64_t prefix,
                                    int64_t cap) {
    int64_t i = 0, o = prefix, end = prefix + cap;
    while (i < n) {
        int token = src[i++];
        int64_t lit = token >> 4;
        if (lit == 15) {
            int b;
            do {
                if (i >= n) return -1;
                b = src[i++];
                lit += b;
            } while (b == 255);
        }
        if (i + lit > n || o + lit > end) return -1;
        for (int64_t j = 0; j < lit; j++) dst[o++] = src[i++];
        if (i >= n) break;
        if (i + 2 > n) return -1;
        int64_t off = src[i] | (src[i + 1] << 8);
        i += 2;
        int64_t ml = token & 15;
        if (ml == 15) {
            int b;
            do {
                if (i >= n) return -1;
                b = src[i++];
                ml += b;
            } while (b == 255);
        }
        ml += 4;
        if (off <= 0 || off > o || o + ml > end) return -1;
        for (int64_t j = 0; j < ml; j++, o++) dst[o] = dst[o - off];
    }
    return o - prefix;
}
