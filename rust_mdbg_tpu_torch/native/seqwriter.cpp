// Native .sequences sidecar writer.
//
// Formats and LZ4F-compresses the per-node records (format contract:
// rust-mdbg src/main.rs:696-707, see io/sequences.py) directly from the
// raw read buffer: slice [start, end), reverse-complement when the crossing
// occurrence was reversed, emit
//   <index>\t[h0, h1, ...]\t<seq>\t*\t*\t(s0, s1)\n
// The Python loop doing this was ~50 us/node; this does the whole table in
// one pass at memory speed.
//
// Minimizer recompute mode (vecs == NULL): the node's k minimizer values are
// re-derived from the record's own sequence bytes with a rolling ntHash v1
// (closed form in ops/nthash.py; rolling recurrences below are algebraically
// identical) + the density rule `canonical <= hash_bound`
// (rust-mdbg src/read.rs:183).  Valid because the stored sequence spans
// exactly minimizer_0 .. minimizer_{k-1}+l (in canonical orientation), and
// the read's minimizers are ALL positions passing the rule — so the selected
// set within the span is exactly the canonical k-min-mer vector.  This lets
// the device->host path skip the [n, k] u64 vector transfer entirely (the
// dev-environment relay moves ~20 MB/s; 168 B/node was the dominant cost).
// Only correct when hashing space == sequence space (reads already HPC'd,
// plain density scheme) — callers gate on that (core/device_out.py).

#include "lz4f.cpp"  // self-contained codec (extern "C" but distinct .so)

#include <cstdio>
#include <cinttypes>
#include <string>
#include <vector>

extern "C" {
int64_t lz4f_compress_frame_accel(const uint8_t*, int64_t, uint8_t*, int64_t,
                                  int);
}

namespace {

char comp_table[256];
// ntHash v1 per-base seeds (ops/nthash.py; pinned by the external oracle
// vector in tests/test_nthash.py).  Non-ACGT bases hash as N (seed 0).
uint64_t h_tab[256];
uint64_t rc_tab[256];
struct TablesInit {
    TablesInit() {
        for (int i = 0; i < 256; i++) comp_table[i] = 'N';
        comp_table['A'] = 'T'; comp_table['C'] = 'G';
        comp_table['G'] = 'C'; comp_table['T'] = 'A';
        comp_table['a'] = 't'; comp_table['c'] = 'g';
        comp_table['g'] = 'c'; comp_table['t'] = 'a';
        comp_table['U'] = 'A'; comp_table['u'] = 'a';
        const uint64_t SA = 0x3C8BFBB395C60474ULL, SC = 0x3193C18562A02B4CULL,
                       SG = 0x20323ED082572324ULL, ST = 0x295549F54BE24456ULL;
        for (int i = 0; i < 256; i++) { h_tab[i] = 0; rc_tab[i] = 0; }
        h_tab['A'] = h_tab['a'] = SA; rc_tab['A'] = rc_tab['a'] = ST;
        h_tab['C'] = h_tab['c'] = SC; rc_tab['C'] = rc_tab['c'] = SG;
        h_tab['G'] = h_tab['g'] = SG; rc_tab['G'] = rc_tab['g'] = SC;
        h_tab['T'] = h_tab['t'] = ST; rc_tab['T'] = rc_tab['t'] = SA;
    }
} tables_init;

inline uint64_t rotl64(uint64_t x, int r) {
    r &= 63;
    return r ? (x << r) | (x >> (64 - r)) : x;
}

inline char* u64toa(uint64_t v, char* p) {
    char tmp[20];
    int i = 0;
    do { tmp[i++] = (char)('0' + (v % 10)); v /= 10; } while (v);
    while (i) *p++ = tmp[--i];
    return p;
}

// Per-l pre-rotated seed tables for the rolling recurrences (2 rotl64 per
// base saved; the l is fixed per writer call).
struct RollTables {
    uint64_t h_l[256];    // rotl(H[x], l)
    uint64_t rc_l1[256];  // rotl(RC[x], l-1)
    explicit RollTables(int l) {
        for (int i = 0; i < 256; i++) {
            h_l[i] = rotl64(h_tab[i], l);
            rc_l1[i] = rotl64(rc_tab[i], l - 1);
        }
    }
};

// Append the k selected minimizer values of seq[0..m) to buf as
// "v0, v1, ...".  Returns 0 on success, -1 if the density selection over the
// span does not reproduce exactly k minimizers anchored at both ends (which
// would mean the caller's gate was wrong — never expected).
int recompute_minimizers(const uint8_t* seq, int64_t m, int l, int k,
                         uint64_t bound, const RollTables& rt,
                         std::string& buf) {
    if (m < l) return -1;
    uint64_t fh = 0, rh = 0;
    for (int j = 0; j < l; j++) {
        fh ^= rotl64(h_tab[seq[j]], l - 1 - j);
        rh ^= rotl64(rc_tab[seq[j]], j);
    }
    int found = 0;
    int64_t first = -1, last = -1;
    char num[24];
    const int64_t nwin = m - l;
    for (int64_t i = 0;; i++) {
        uint64_t c = fh < rh ? fh : rh;
        if (c <= bound) {
            if (found) { buf += ", "; } else { first = i; }
            last = i;
            found++;
            if (found > k) return -1;
            buf.append(num, u64toa(c, num) - num);
        }
        if (i == nwin) break;
        // rolling ntHash v1 (derivation in ops/nthash.py docstring form):
        //   fh' = rotl(fh,1) ^ rotl(H[s_i], l) ^ H[s_{i+l}]
        //   rh' = rotr(rh ^ RC[s_i], 1) ^ rotl(RC[s_{i+l}], l-1)
        fh = rotl64(fh, 1) ^ rt.h_l[seq[i]] ^ h_tab[seq[i + l]];
        rh = rotl64(rh ^ rc_tab[seq[i]], 63) ^ rt.rc_l1[seq[i + l]];
    }
    if (found != k || first != 0 || last != nwin) return -1;
    return 0;
}

// Positions mode: the device supplies each node's k minimizer positions
// within the stored record sequence (already in stored orientation), so the
// value re-derivation hashes exactly k l-mers instead of rolling over every
// base (~10x less hashing; the rolling scan dominated writer CPU).  Same
// validation posture: anchored at both ends, strictly increasing, and every
// value must pass the density rule — a hashing-space mismatch (wrong caller
// gate) fails the bound check exactly like the rolling mode would.
int positions_minimizers(const uint8_t* seq, int64_t m, int l, int k,
                         uint64_t bound, const uint32_t* mp,
                         std::string& buf) {
    if (m < l || mp[0] != 0 || (int64_t)mp[k - 1] != m - l) return -1;
    char num[24];
    for (int j = 0; j < k; j++) {
        int64_t p = mp[j];
        if (p + l > m || (j && mp[j] <= mp[j - 1])) return -1;
        uint64_t fh = 0, rh = 0;
        for (int t = 0; t < l; t++) {
            fh ^= rotl64(h_tab[seq[p + t]], l - 1 - t);
            rh ^= rotl64(rc_tab[seq[p + t]], t);
        }
        uint64_t c = fh < rh ? fh : rh;
        if (c > bound) return -1;
        if (j) buf += ", ";
        buf.append(num, u64toa(c, num) - num);
    }
    return 0;
}

void flush_frame(FILE* f, std::string& buf, std::vector<uint8_t>& scratch,
                 int accel) {
    if (buf.empty()) return;
    size_t cap = buf.size() + buf.size() / 255 + 4096;
    if (scratch.size() < cap) scratch.resize(cap);
    int64_t n = lz4f_compress_frame_accel(
        reinterpret_cast<const uint8_t*>(buf.data()), buf.size(),
        scratch.data(), cap, accel);
    if (n > 0) fwrite(scratch.data(), 1, n, f);
    buf.clear();
}

}  // namespace

extern "C" {

// Writes n node records to `path` (appending after a header).  Returns 0 on
// success, -2 if minimizer recompute failed (file is removed).  reads_buf
// holds raw ASCII bases; per node the slice is [abs_start[i], abs_end[i]).
// vecs may be NULL: minimizers are then recomputed from the sequence (see
// header comment) with window l = header_l and the density bound hash_bound —
// at positions mpos[i*k..] (record space, stored orientation) when mpos is
// non-NULL, else by a rolling scan over every base.
int64_t seqs_write(const char* path, int64_t n, int k, int header_k,
                   int header_l,
                   const uint32_t* index, const uint64_t* vecs,
                   const uint8_t* reads_buf,
                   const int64_t* abs_start, const int64_t* abs_end,
                   const uint8_t* rev,
                   const uint16_t* s0, const uint16_t* s1,
                   uint64_t hash_bound, int accel, const uint32_t* mpos) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    RollTables rt(header_l);
    std::string buf;
    buf.reserve(8 << 20);
    std::vector<uint8_t> scratch;
    std::vector<uint8_t> seqv;
    char tmp[32];
    snprintf(tmp, sizeof tmp, "# k = %d\n", header_k);
    buf += tmp;
    snprintf(tmp, sizeof tmp, "# l = %d\n", header_l);
    buf += tmp;
    buf += "# Structure of remaining of the file:\n";
    buf += "# [node name]\t[list of minimizers]\t[sequence of node]\t"
           "[abundance]\t[origin]\t[shift]\n";
    for (int64_t i = 0; i < n; i++) {
        int64_t a = abs_start[i], b = abs_end[i];
        const uint8_t* seq;
        if (rev[i]) {
            seqv.resize(b - a);
            uint8_t* dst = seqv.data();
            for (int64_t p = b - 1; p >= a; p--)
                *dst++ = (uint8_t)comp_table[reads_buf[p]];
            seq = seqv.data();
        } else {
            seq = reads_buf + a;
        }
        char num[24];
        buf.append(num, u64toa(index[i], num) - num);
        buf += "\t[";
        if (vecs) {
            for (int j = 0; j < k; j++) {
                buf.append(num, u64toa(vecs[i * k + j], num) - num);
                if (j + 1 < k) buf += ", ";
            }
        } else {
            int rc = mpos
                ? positions_minimizers(seq, b - a, header_l, k, hash_bound,
                                       mpos + i * k, buf)
                : recompute_minimizers(seq, b - a, header_l, k, hash_bound,
                                       rt, buf);
            if (rc != 0) {
                fclose(f);
                remove(path);
                return -2;
            }
        }
        buf += "]\t";
        buf.append(reinterpret_cast<const char*>(seq), b - a);
        char tail[48];
        snprintf(tail, sizeof tail, "\t*\t*\t(%u, %u)\n",
                 (unsigned)s0[i], (unsigned)s1[i]);
        buf += tail;
        if (buf.size() >= (4u << 20)) flush_frame(f, buf, scratch, accel);
    }
    flush_frame(f, buf, scratch, accel);
    fclose(f);
    return 0;
}

}  // extern "C"
