// Native .sequences sidecar writer.
//
// Formats and LZ4F-compresses the per-node records (format contract:
// rust-mdbg src/main.rs:696-707, see io/sequences.py) directly from the
// raw read buffer: slice [start, end), reverse-complement when the crossing
// occurrence was reversed, emit
//   <index>\t[h0, h1, ...]\t<seq>\t*\t*\t(s0, s1)\n
// The Python loop doing this was ~50 us/node.  The text is cut into LZ4
// frames of >= 4 MiB (FRAME_TEXT), each compressed on its own, so a call
// measures every record first, places the frame boundaries, and then
// formats and compresses the frames on worker threads, writing them in
// order: the file's bytes are those of one thread writing record after
// record, whatever the worker count.
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

#include <algorithm>
#include <atomic>
#include <cinttypes>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

#include <sys/mman.h>

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

// The k selected minimizer values of seq[0..m), into out[0..k).  Returns 0
// on success, -1 if the density selection over the span does not reproduce
// exactly k minimizers anchored at both ends (which would mean the caller's
// gate was wrong — never expected).
int recompute_minimizers(const uint8_t* seq, int64_t m, int l, int k,
                         uint64_t bound, const RollTables& rt,
                         uint64_t* out) {
    if (m < l) return -1;
    uint64_t fh = 0, rh = 0;
    for (int j = 0; j < l; j++) {
        fh ^= rotl64(h_tab[seq[j]], l - 1 - j);
        rh ^= rotl64(rc_tab[seq[j]], j);
    }
    int found = 0;
    int64_t first = -1, last = -1;
    const int64_t nwin = m - l;
    for (int64_t i = 0;; i++) {
        uint64_t c = fh < rh ? fh : rh;
        if (c <= bound) {
            if (!found) first = i;
            last = i;
            if (found == k) return -1;
            out[found++] = c;
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
                         uint64_t bound, const uint32_t* mp, uint64_t* out) {
    if (m < l || mp[0] != 0 || (int64_t)mp[k - 1] != m - l) return -1;
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
        out[j] = c;
    }
    return 0;
}

inline int64_t ndigits(uint64_t v) {
    int64_t d = 1;
    while (v >= 10) { v /= 10; d++; }
    return d;
}

// An array of T mapped from the kernel and unmapped when it goes or grows:
// the writer's buffers (tens of MB while a call runs) are never left in the
// allocator's arenas, where freed memory can stay resident after the call.
template <class T>
class Mapped {
  public:
    Mapped() = default;
    Mapped(const Mapped&) = delete;
    Mapped& operator=(const Mapped&) = delete;
    ~Mapped() { release(); }
    // Room for n elements (the contents are not kept when it grows).
    T* fit(int64_t n) {
        if (n > n_) {
            release();
            size_t bytes = std::max<size_t>(1, (size_t)n * sizeof(T));
            void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                           MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
            if (p == MAP_FAILED) throw std::bad_alloc();
            p_ = static_cast<T*>(p);
            n_ = n;
        }
        return p_;
    }
    T* get() const { return p_; }
    T& operator[](int64_t i) const { return p_[i]; }

  private:
    void release() {
        if (p_) munmap(p_, std::max<size_t>(1, (size_t)n_ * sizeof(T)));
        p_ = nullptr;
        n_ = 0;
    }
    T* p_ = nullptr;
    int64_t n_ = 0;
};

// A frame ends after the first record that brings its text to this size;
// the final frame takes the rest (the header lines open the first).
constexpr int64_t FRAME_TEXT = 4 << 20;
// Records a pass-1 task measures.
constexpr int64_t BLOCK_RECORDS = 256;
// A record's bytes besides its numbers and its sequence:
// "\t[" "]\t" "\t*\t*\t(" ", " ")\n"
constexpr int64_t RECORD_FIXED = 14;

// One seqs_write call.  Pass 1 measures every record's text (recomputing
// its minimizer values where the call gives none) on parallel tasks of
// BLOCK_RECORDS records; a serial scan of the lengths places the frame
// boundaries; pass 2 formats and compresses each frame on a worker, into a
// ring of workers + 2 slots, and the calling thread writes the slots out
// in frame order.  Every frame holds exactly the text one thread writing
// the records in order would have flushed there, so the file's bytes do
// not depend on the worker count.
struct Call {
    int64_t n;
    int k, l;
    const uint32_t* index;
    const uint8_t* reads;
    const int64_t *abs_start, *abs_end;
    const uint8_t* rev;
    const uint16_t *s0, *s1;
    uint64_t bound;
    int accel;
    const uint32_t* mpos;
    bool recompute;  // no vectors given: values from the sequence
    Mapped<uint64_t> recomputed;  // [n, k] in that case
    const uint64_t* vals;         // [n, k]: given or recomputed
    Mapped<int64_t> text_len;     // [n]
    std::string header;
    std::vector<int64_t> frame_end;    // record after each frame's last
    std::vector<int64_t> frame_bytes;  // each frame's text

    // Record i's sequence in stored orientation (reverse-complemented
    // into seqv where the occurrence was reversed).
    const uint8_t* stored(int64_t i, std::vector<uint8_t>& seqv) const {
        int64_t a = abs_start[i], b = abs_end[i];
        if (!rev[i]) return reads + a;
        seqv.resize(b - a);
        uint8_t* dst = seqv.data();
        for (int64_t p = b - 1; p >= a; p--)
            *dst++ = (uint8_t)comp_table[reads[p]];
        return seqv.data();
    }

    // Pass 1 over records [lo, hi): false on a recompute mismatch.
    bool measure(int64_t lo, int64_t hi, const RollTables& rt,
                 std::vector<uint8_t>& seqv) {
        for (int64_t i = lo; i < hi; i++) {
            int64_t m = abs_end[i] - abs_start[i];
            if (recompute) {
                const uint8_t* seq = stored(i, seqv);
                uint64_t* out = recomputed.get() + i * k;
                int rc = mpos ? positions_minimizers(seq, m, l, k, bound,
                                                     mpos + i * k, out)
                              : recompute_minimizers(seq, m, l, k, bound, rt,
                                                     out);
                if (rc != 0) return false;
            }
            const uint64_t* v = vals + i * k;
            int64_t len = ndigits(index[i]) + RECORD_FIXED + m +
                          ndigits(s0[i]) + ndigits(s1[i]) +
                          (k > 1 ? 2 * (k - 1) : 0);
            for (int j = 0; j < k; j++) len += ndigits(v[j]);
            text_len[i] = len;
        }
        return true;
    }

    void place_frames() {
        int64_t cur = (int64_t)header.size();
        for (int64_t i = 0; i < n; i++) {
            cur += text_len[i];
            if (cur >= FRAME_TEXT) {
                frame_end.push_back(i + 1);
                frame_bytes.push_back(cur);
                cur = 0;
            }
        }
        if (cur > 0) {
            frame_end.push_back(n);
            frame_bytes.push_back(cur);
        }
    }

    // Frame f's text into p; returns its length.
    int64_t format(int64_t f, char* p0) const {
        char* p = p0;
        if (f == 0) {
            memcpy(p, header.data(), header.size());
            p += header.size();
        }
        for (int64_t i = f ? frame_end[f - 1] : 0; i < frame_end[f]; i++) {
            int64_t a = abs_start[i], b = abs_end[i];
            p = u64toa(index[i], p);
            *p++ = '\t'; *p++ = '[';
            const uint64_t* v = vals + i * k;
            for (int j = 0; j < k; j++) {
                if (j) { *p++ = ','; *p++ = ' '; }
                p = u64toa(v[j], p);
            }
            *p++ = ']'; *p++ = '\t';
            if (rev[i]) {
                for (int64_t q = b - 1; q >= a; q--)
                    *p++ = comp_table[reads[q]];
            } else {
                memcpy(p, reads + a, b - a);
                p += b - a;
            }
            memcpy(p, "\t*\t*\t(", 6);
            p += 6;
            p = u64toa(s0[i], p);
            *p++ = ','; *p++ = ' ';
            p = u64toa(s1[i], p);
            *p++ = ')'; *p++ = '\n';
        }
        return p - p0;
    }
};

// A frame's compressed bytes, held until the calling thread writes them.
struct Slot {
    Mapped<uint8_t> buf;
    int64_t frame = -1;  // the frame it holds, once compressed
    int64_t size = 0;    // its bytes; <= 0: nothing to write
    bool fault = false;  // the text's length was not the measured one
};

// Formats frame f into text and compresses it into s; a failure (no memory,
// or a text whose length is not the measured one) marks s.fault.
void encode(const Call& c, int64_t f, Mapped<char>& text, Slot& s) noexcept {
    s.size = 0;
    s.fault = true;
    try {
        int64_t want = c.frame_bytes[f];
        int64_t len = c.format(f, text.fit(want));
        if (len != want) return;
        int64_t cap = len + len / 255 + 4096;
        s.size = lz4f_compress_frame_accel(
            reinterpret_cast<const uint8_t*>(text.get()), len,
            s.buf.fit(cap), cap, c.accel);
        s.fault = false;
    } catch (const std::bad_alloc&) {
    }
}

// Runs fn() on the calling thread and on up to w - 1 new threads; returns
// how many ran it.  A thread that cannot start is not waited for.
template <class Fn>
int run_on(int64_t w, Fn fn) {
    std::vector<std::thread> ts;
    for (int64_t t = 1; t < w; t++) {
        try {
            ts.emplace_back(fn);
        } catch (const std::system_error&) {
            break;
        }
    }
    fn();
    for (auto& t : ts) t.join();
    return 1 + (int)ts.size();
}

}  // namespace

extern "C" {

// Writes n node records to `path` (appending after a header).  Returns 0 on
// success, -2 if minimizer recompute failed (file is removed), -1 on any
// other failure (file is removed).  reads_buf holds raw ASCII bases; per
// node the slice is [abs_start[i], abs_end[i]).  vecs may be NULL: minimizers
// are then recomputed from the sequence (see header comment) with window
// l = header_l and the density bound hash_bound — at positions mpos[i*k..]
// (record space, stored orientation) when mpos is non-NULL, else by a
// rolling scan over every base.  Up to `workers` threads measure the records
// and encode the frames (no more than there are frames); the bytes are the
// same for every worker count.  stats, if non-NULL, receives the frames
// written and the most threads one pass ran.
int64_t seqs_write(const char* path, int64_t n, int k, int header_k,
                   int header_l,
                   const uint32_t* index, const uint64_t* vecs,
                   const uint8_t* reads_buf,
                   const int64_t* abs_start, const int64_t* abs_end,
                   const uint8_t* rev,
                   const uint16_t* s0, const uint16_t* s1,
                   uint64_t hash_bound, int accel, const uint32_t* mpos,
                   int workers, int64_t* stats) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    auto fail = [&](int64_t rc) {
        fclose(f);
        remove(path);
        return rc;
    };
    if (workers < 1) workers = 1;
    Call c;
    c.n = n; c.k = k; c.l = header_l;
    c.index = index; c.reads = reads_buf;
    c.abs_start = abs_start; c.abs_end = abs_end; c.rev = rev;
    c.s0 = s0; c.s1 = s1; c.bound = hash_bound; c.accel = accel;
    c.mpos = mpos;
    c.recompute = vecs == nullptr;
    char tmp[32];
    snprintf(tmp, sizeof tmp, "# k = %d\n", header_k);
    c.header += tmp;
    snprintf(tmp, sizeof tmp, "# l = %d\n", header_l);
    c.header += tmp;
    c.header += "# Structure of remaining of the file:\n";
    c.header += "# [node name]\t[list of minimizers]\t[sequence of node]\t"
                "[abundance]\t[origin]\t[shift]\n";
    int used = 1;
    try {
        c.vals = c.recompute ? c.recomputed.fit(n * k) : vecs;
        c.text_len.fit(n);

        // pass 1: each record's text length (and recomputed values)
        const RollTables rt(header_l);
        const int64_t blocks = (n + BLOCK_RECORDS - 1) / BLOCK_RECORDS;
        std::atomic<int64_t> next_block{0};
        std::atomic<bool> mismatch{false}, no_memory{false};
        used = run_on(std::min<int64_t>(workers, blocks), [&]() {
            std::vector<uint8_t> seqv;
            try {
                for (int64_t b; !mismatch && (b = next_block++) < blocks;) {
                    int64_t lo = b * BLOCK_RECORDS;
                    if (!c.measure(lo, std::min(n, lo + BLOCK_RECORDS), rt,
                                   seqv))
                        mismatch = true;
                }
            } catch (const std::bad_alloc&) {
                no_memory = mismatch = true;
            }
        });
        if (mismatch) return fail(no_memory ? -1 : -2);
        c.place_frames();
        const int64_t frames = (int64_t)c.frame_end.size();

        // pass 2: frames encoded on workers, written here in order
        bool fault = false;
        auto write_slot = [&](const Slot& s) {
            fault |= s.fault;
            if (s.size > 0) fwrite(s.buf.get(), 1, s.size, f);
        };
        const int64_t w2 = std::min<int64_t>(workers, frames);
        // a frame a worker, and two encoded ahead of the one being written
        const int64_t ring = w2 + 2;
        std::vector<Slot> slots(std::max<int64_t>(ring, 1));
        std::vector<std::thread> ts;
        std::mutex mu;
        std::condition_variable work_cv, done_cv;
        int64_t next = 0, written = 0;
        auto worker = [&]() {
            Mapped<char> text;
            for (;;) {
                int64_t fr;
                {
                    std::unique_lock<std::mutex> lk(mu);
                    work_cv.wait(lk, [&] {
                        return next >= frames || next < written + ring;
                    });
                    if (next >= frames) return;
                    fr = next++;
                }
                // the slot's last frame, fr - ring, is written
                Slot& s = slots[fr % ring];
                encode(c, fr, text, s);
                {
                    std::lock_guard<std::mutex> lk(mu);
                    s.frame = fr;
                }
                done_cv.notify_one();
            }
        };
        for (int64_t t = 0; w2 > 1 && t < w2; t++) {
            try {
                ts.emplace_back(worker);
            } catch (const std::system_error&) {
                break;
            }
        }
        if (ts.empty()) {  // one frame or no thread: encode them here
            Mapped<char> text;
            for (int64_t fr = 0; fr < frames; fr++) {
                encode(c, fr, text, slots[0]);
                write_slot(slots[0]);
            }
        } else {
            for (int64_t fr = 0; fr < frames; fr++) {
                Slot& s = slots[fr % ring];
                {
                    std::unique_lock<std::mutex> lk(mu);
                    done_cv.wait(lk, [&] { return s.frame == fr; });
                }
                write_slot(s);
                {
                    std::lock_guard<std::mutex> lk(mu);
                    written = fr + 1;
                }
                work_cv.notify_all();
            }
            for (auto& t : ts) t.join();
        }
        used = std::max<int>(used, std::max<int>(1, (int)ts.size()));
        if (fault) return fail(-1);
        if (stats) {
            stats[0] = frames;
            stats[1] = used;
        }
    } catch (const std::exception&) {
        return fail(-1);
    }
    if (fclose(f) != 0) {
        remove(path);
        return -1;
    }
    return 0;
}

}  // extern "C"
