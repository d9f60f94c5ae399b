// Native FASTA/FASTQ chunk loader: the throughput replacement for the
// reference's seq_io parser thread + worker pool (main.rs:834-838).
//
// Plain files are mmap'd; .gz streams through zlib.  Each fx_next() call
// scans record boundaries sequentially (memchr-bound, GB/s) and then
// copies+encodes sequence bytes into the caller's fixed-shape chunk buffers
// with a small worker pool (base->code table lookup is the hot byte loop
// that pure-Python parsing serialized; VERDICT round-1 item 7).
//
// Two encodings: fx_next writes one code byte a base into [cap, max_len]
// rows; fx_next_packed writes the chunked driver's staged planes (2-bit
// values and an invalid mask, ops/pack.pack_codes_np's layout) at the
// chunk's staging width, touching only the reads' own bases, so that no
// single-threaded pass over padded code rows follows the parse.
//
// Python drives this from io/fastx_native.py with a double-buffer prefetch
// thread, so parsing overlaps device compute (ctypes releases the GIL).
//
// Contract per record (matches io/fastx.py read_records):
//   FASTA: '>' header, id = token to first whitespace; seq may span lines.
//   FASTQ: 4-line records.
//   codes: A/a=0 C/c=1 G/g=2 T/t=3 N/n=4 other=5 (utils/seq.py BASE_CODE).
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
#include <thread>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

struct Seg { size_t start; uint32_t len; };  // one sequence line

struct Rec {
    size_t id_start; uint32_t id_len;
    uint32_t seg_begin, seg_count;   // into Fx::segs
    int64_t raw_off;                 // output offset in the raw blob
    uint32_t seq_len;
};

struct Fx {
    int fd = -1;
    const uint8_t* map = nullptr;    // plain: whole file
    size_t map_size = 0;
    size_t dropped = 0;              // consumed mmap prefix already discarded
    gzFile gz = nullptr;             // .gz: streamed window
    std::vector<uint8_t> win;        // gz window storage
    size_t win_len = 0;              // valid bytes in win
    bool gz_eof = false;
    bool fasta = true;
    size_t pos = 0;                  // parse cursor into current window
    int nthreads = 1;
    // scratch (reused across calls)
    std::vector<Seg> segs;
    std::vector<Rec> recs;
};

uint8_t CODE[256];
// the packed planes' bits of a byte: invalid (code > 3), and its 2-bit
// value (the code; 0 for N, 1 for any other invalid byte)
uint8_t BAD[256], VAL2[256];
struct CodeInit {
    CodeInit() {
        memset(CODE, 5, sizeof(CODE));
        CODE[(int)'A'] = CODE[(int)'a'] = 0;
        CODE[(int)'C'] = CODE[(int)'c'] = 1;
        CODE[(int)'G'] = CODE[(int)'g'] = 2;
        CODE[(int)'T'] = CODE[(int)'t'] = 3;
        CODE[(int)'N'] = CODE[(int)'n'] = 4;
        for (int b = 0; b < 256; b++) {
            BAD[b] = CODE[b] > 3;
            VAL2[b] = CODE[b] < 4 ? CODE[b] : CODE[b] == 5;
        }
    }
} code_init;

inline const uint8_t* window(Fx* f, size_t* len) {
    if (f->gz) { *len = f->win_len; return f->win.data(); }
    *len = f->map_size;
    return f->map;
}

// Pull more compressed data into the gz window; returns false at EOF with
// nothing added.  Consumed prefix [0, f->pos) is compacted away first.
bool gz_refill(Fx* f) {
    if (f->gz_eof) return false;
    if (f->pos > 0) {
        memmove(f->win.data(), f->win.data() + f->pos, f->win_len - f->pos);
        f->win_len -= f->pos;
        f->pos = 0;
    }
    size_t want = f->win.size() - f->win_len;
    if (want < (1u << 20)) {
        f->win.resize(std::max(f->win.size() * 2, (size_t)(8u << 20)));
        want = f->win.size() - f->win_len;
    }
    int n = gzread(f->gz, f->win.data() + f->win_len, (unsigned)want);
    if (n <= 0) { f->gz_eof = true; return false; }
    f->win_len += (size_t)n;
    return true;
}

inline bool at_eof(Fx* f) {
    size_t len; window(f, &len);
    return f->pos >= len && (f->gz == nullptr || f->gz_eof);
}

// Discard resident pages of the consumed mmap prefix so a multi-GB input
// never counts against the process RSS (the reference streams with buffered
// reads and stays <=10 GB at 114 Gbp input; an mmap'd parse would otherwise
// retain every touched page).  Keeps a 64 MB guard behind the cursor and
// drops in 256 MB strides.
inline void drop_consumed(Fx* f) {
    if (!f->map) return;
    const size_t keep = 64ull << 20, step = 256ull << 20;
    if (f->pos < f->dropped + step + keep) return;
    size_t end = (f->pos - keep) & ~((size_t)4095);
    if (end > f->dropped) {
        madvise((void*)(f->map + f->dropped), end - f->dropped,
                MADV_DONTNEED);
        f->dropped = end;
    }
}

// memchr '\n' from p; returns len (one past data end) if absent.
inline size_t find_nl(const uint8_t* w, size_t len, size_t p) {
    const void* q = memchr(w + p, '\n', len - p);
    return q ? (size_t)((const uint8_t*)q - w) : len;
}

// Scan up to max_reads complete records whose lengths are <= max_len and
// whose raw bytes fit raw_cap into f->recs / f->segs; fills lengths, raw_off
// (raw_off[0]=0 .. raw_off[n]) and the id blob + offsets.  The sequence bytes
// are copied later, by the encode phase.  Returns the number of records.
int64_t scan_records(Fx* f, int64_t max_reads, int64_t max_len,
                     int32_t* lengths, int64_t raw_cap, int64_t* raw_off,
                     uint8_t* ids, int64_t ids_cap, int32_t* ids_off,
                     int32_t* status) {
    f->segs.clear();
    f->recs.clear();
    drop_consumed(f);
    *status = 0;
    int64_t raw_used = 0, ids_used = 0;
    ids_off[0] = 0;
    raw_off[0] = 0;

    while ((int64_t)f->recs.size() < max_reads) {
        size_t len;
        const uint8_t* w = window(f, &len);
        size_t save = f->pos;
        // ---- try to parse one complete record from the window ----
        size_t p = f->pos;
        // skip blank lines
        while (p < len && (w[p] == '\n' || w[p] == '\r')) p++;
        if (p >= len) {
            if (f->gz && !f->gz_eof) {
                // refilling compacts the window, which would dangle the
                // completed records' segments — flush them first
                if (!f->recs.empty()) break;
                gz_refill(f);
                continue;
            }
            *status = 1;
            break;
        }
        uint8_t mark = f->fasta ? '>' : '@';
        if (w[p] != mark) { *status = 3; break; }
        size_t hdr_end = find_nl(w, len, p);
        if (hdr_end >= len && f->gz && !f->gz_eof) {
            if (!f->recs.empty()) { f->pos = save; break; }
            gz_refill(f);
            continue;
        }
        // id = token up to first whitespace
        size_t id_s = p + 1, id_e = id_s;
        while (id_e < hdr_end && w[id_e] != ' ' && w[id_e] != '\t'
               && w[id_e] != '\r') id_e++;
        Rec r;
        r.id_start = id_s;
        r.id_len = (uint32_t)(id_e - id_s);
        r.seg_begin = (uint32_t)f->segs.size();
        r.seg_count = 0;
        r.seq_len = 0;
        bool incomplete = false;
        size_t q = hdr_end + 1;
        if (f->fasta) {
            while (q < len && w[q] != '>') {
                size_t e = find_nl(w, len, q);
                if (e >= len && f->gz && !f->gz_eof) { incomplete = true; break; }
                size_t sl = e - q;
                while (sl > 0 && (w[q + sl - 1] == '\r')) sl--;
                if (sl > 0) {
                    f->segs.push_back({q, (uint32_t)sl});
                    r.seg_count++;
                    r.seq_len += (uint32_t)sl;
                }
                q = e + 1;
            }
            if (q >= len && f->gz && !f->gz_eof && !incomplete)
                incomplete = true;  // next record may continue this seq
        } else {
            // 4-line FASTQ: seq, '+', quals
            size_t e1 = find_nl(w, len, q);
            size_t p2 = e1 + 1;
            size_t e2 = p2 < len ? find_nl(w, len, p2) : len;
            size_t p3 = e2 + 1;
            size_t e3 = p3 < len ? find_nl(w, len, p3) : len;
            if (e3 >= len && f->gz && !f->gz_eof) {
                incomplete = true;  // quals line may be cut by the window
            } else if (e1 >= len || p2 >= len || w[p2] != '+') {
                if (f->gz && !f->gz_eof) incomplete = true;
                else { *status = 3; break; }
            } else {
                size_t sl = e1 - q;
                while (sl > 0 && w[q + sl - 1] == '\r') sl--;
                f->segs.push_back({q, (uint32_t)sl});
                r.seg_count = 1;
                r.seq_len = (uint32_t)sl;
                q = (e3 < len) ? e3 + 1 : len;
            }
        }
        if (incomplete) {
            f->segs.resize(r.seg_begin);
            f->pos = save;
            if (!f->recs.empty()) break;  // flush before the window moves
            // refill and re-parse; at EOF the refill fails but gz_eof is now
            // set, so the re-parse completes the final record
            gz_refill(f);
            continue;
        }
        // record complete: gate on caps
        if ((int64_t)r.seq_len > max_len) {
            f->segs.resize(r.seg_begin);
            f->pos = save;
            *status = 2;
            break;
        }
        if (raw_used + (int64_t)r.seq_len > raw_cap ||
            ids_used + (int64_t)r.id_len > ids_cap) {
            f->segs.resize(r.seg_begin);
            f->pos = save;
            *status = 0;
            break;
        }
        r.raw_off = raw_used;
        raw_used += r.seq_len;
        int64_t i = (int64_t)f->recs.size();
        lengths[i] = (int32_t)r.seq_len;
        raw_off[i + 1] = raw_used;
        memcpy(ids + ids_used, w + r.id_start, r.id_len);
        ids_used += r.id_len;
        ids_off[i + 1] = (int32_t)ids_used;
        f->recs.push_back(r);
        f->pos = q;
    }
    return (int64_t)f->recs.size();
}

// The copy + encode phase: copy each scanned record's sequence into the raw
// blob, then call encode(i, bytes, len) on it, in parallel over records on
// f->nthreads threads.
template <class Encode>
void copy_and_encode(Fx* f, uint8_t* raw, Encode encode) {
    size_t wlen;
    const uint8_t* w = window(f, &wlen);
    int64_t n = (int64_t)f->recs.size();
    int T = (int)std::min<int64_t>(f->nthreads, std::max<int64_t>(1, n));
    auto work = [&](int t) {
        for (int64_t i = t; i < n; i += T) {
            const Rec& r = f->recs[i];
            uint8_t* rb = raw + r.raw_off;
            size_t o = 0;
            for (uint32_t s = 0; s < r.seg_count; s++) {
                const Seg& sg = f->segs[r.seg_begin + s];
                memcpy(rb + o, w + sg.start, sg.len);
                o += sg.len;
            }
            encode(i, rb, (size_t)r.seq_len);
        }
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> th;
        for (int t = 1; t < T; t++) th.emplace_back(work, t);
        work(0);
        for (auto& x : th) x.join();
    }
}

// One read's bases into its rows of the 2-bit plane and the invalid-mask
// plane (ops/pack.pack_codes_np's layout): base j is bits 2*(j%4) of
// packed[j/4] and bit j%8 of mask[j/8].  The rows are zeroed by the caller
// and hold the pad.
inline void pack_read(const uint8_t* s, size_t n, uint8_t* packed,
                      uint8_t* mask) {
    size_t j = 0;
    for (; j + 8 <= n; j += 8) {
        const uint8_t* b = s + j;
        packed[j >> 2] = (uint8_t)(VAL2[b[0]] | VAL2[b[1]] << 2
                                   | VAL2[b[2]] << 4 | VAL2[b[3]] << 6);
        packed[(j >> 2) + 1] = (uint8_t)(VAL2[b[4]] | VAL2[b[5]] << 2
                                         | VAL2[b[6]] << 4 | VAL2[b[7]] << 6);
        mask[j >> 3] = (uint8_t)(BAD[b[0]] | BAD[b[1]] << 1 | BAD[b[2]] << 2
                                 | BAD[b[3]] << 3 | BAD[b[4]] << 4
                                 | BAD[b[5]] << 5 | BAD[b[6]] << 6
                                 | BAD[b[7]] << 7);
    }
    for (; j < n; j++) {
        packed[j >> 2] |= (uint8_t)(VAL2[s[j]] << (2 * (j & 3)));
        mask[j >> 3] |= (uint8_t)(BAD[s[j]] << (j & 7));
    }
}

}  // namespace

extern "C" {

void* fx_open(const char* path, int is_fasta, int nthreads) {
    Fx* f = new Fx();
    f->fasta = is_fasta != 0;
    f->nthreads = nthreads > 0 ? nthreads : 1;
    size_t n = strlen(path);
    bool gz = n > 3 && strcmp(path + n - 3, ".gz") == 0;
    if (gz) {
        f->gz = gzopen(path, "rb");
        if (!f->gz) { delete f; return nullptr; }
        gzbuffer(f->gz, 1u << 20);
        f->win.resize(16u << 20);
    } else {
        f->fd = open(path, O_RDONLY);
        if (f->fd < 0) { delete f; return nullptr; }
        struct stat st;
        fstat(f->fd, &st);
        f->map_size = (size_t)st.st_size;
        f->map = (const uint8_t*)mmap(nullptr, f->map_size, PROT_READ,
                                      MAP_PRIVATE, f->fd, 0);
        if (f->map == MAP_FAILED) { close(f->fd); delete f; return nullptr; }
        madvise((void*)f->map, f->map_size, MADV_SEQUENTIAL);
    }
    return f;
}

// Parse up to max_reads records whose lengths are <= max_len and whose raw
// bytes fit raw_cap.  Fills codes[max_reads*max_len] rows (only the first
// lengths[i] bytes of each row are written), lengths, the concatenated raw
// sequence blob + offsets (raw_off[0]=0 .. raw_off[n]), and the id blob +
// offsets.  Returns the number of records delivered.
//
// *status: 0 = more input remains, 1 = clean EOF, 2 = stopped BEFORE a
// record longer than max_len (fetch it with fx_long / fx_long_len),
// 3 = parse error (malformed record).
int64_t fx_next(void* h, int64_t max_reads, int64_t max_len,
                uint8_t* codes, int32_t* lengths,
                uint8_t* raw, int64_t raw_cap, int64_t* raw_off,
                uint8_t* ids, int64_t ids_cap, int32_t* ids_off,
                int32_t* status) {
    Fx* f = (Fx*)h;
    int64_t n = scan_records(f, max_reads, max_len, lengths, raw_cap,
                             raw_off, ids, ids_cap, ids_off, status);
    copy_and_encode(f, raw, [&](int64_t i, const uint8_t* rb, size_t len) {
        uint8_t* cb = codes + i * max_len;
        for (size_t j = 0; j < len; j++) cb[j] = CODE[rb[j]];
    });
    return n;
}

// fx_next's packed mode: the same records, lengths, raw blob and ids, but
// in place of codes the staged planes of the chunk, written by the encode
// phase straight from each read's bytes (no codes, no pass over the pad):
// the 2-bit plane packed[max_reads, W/4] and the invalid-mask plane
// mask[max_reads, W/8], both zeroed by the caller and each laid out at width
// W from the buffer's start.  W = half_len when half_len > 0 and every read
// of the chunk fits it, else max_len; *width returns it.  The bytes are
// core/chunked.host_feed's for fx_next's codes: N -> mask 1, value 0; any
// other non-ACGT byte -> mask 1, value 1; the pad and the rows past the
// chunk's reads zero.  max_len and half_len are multiples of 8.
int64_t fx_next_packed(void* h, int64_t max_reads, int64_t max_len,
                       int64_t half_len, uint8_t* packed, uint8_t* mask,
                       int64_t* width, int32_t* lengths,
                       uint8_t* raw, int64_t raw_cap, int64_t* raw_off,
                       uint8_t* ids, int64_t ids_cap, int32_t* ids_off,
                       int32_t* status) {
    Fx* f = (Fx*)h;
    int64_t n = scan_records(f, max_reads, max_len, lengths, raw_cap,
                             raw_off, ids, ids_cap, ids_off, status);
    int64_t longest = 0;
    for (int64_t i = 0; i < n; i++)
        longest = std::max<int64_t>(longest, lengths[i]);
    int64_t W = half_len > 0 && longest <= half_len ? half_len : max_len;
    *width = W;
    copy_and_encode(f, raw, [&](int64_t i, const uint8_t* rb, size_t len) {
        pack_read(rb, len, packed + i * (W / 4), mask + i * (W / 8));
    });
    return n;
}

// Length of the pending over-long record (after fx_next status=2), without
// consuming it.
int64_t fx_long_len(void* h) {
    Fx* f = (Fx*)h;
    size_t len;
    const uint8_t* w = window(f, &len);
    // re-parse the single record at f->pos, growing the gz window as needed
    for (;;) {
        w = window(f, &len);
        size_t p = f->pos;
        while (p < len && (w[p] == '\n' || w[p] == '\r')) p++;
        size_t hdr_end = find_nl(w, len, p);
        size_t q = hdr_end + 1;
        int64_t total = 0;
        bool incomplete = hdr_end >= len && f->gz && !f->gz_eof;
        if (!incomplete) {
            if (f->fasta) {
                while (q < len && w[q] != '>') {
                    size_t e = find_nl(w, len, q);
                    if (e >= len && f->gz && !f->gz_eof) { incomplete = true; break; }
                    size_t sl = e - q;
                    while (sl > 0 && w[q + sl - 1] == '\r') sl--;
                    total += (int64_t)sl;
                    q = e + 1;
                }
                if (q >= len && f->gz && !f->gz_eof) incomplete = true;
            } else {
                size_t e1 = find_nl(w, len, q);
                if (e1 >= len && f->gz && !f->gz_eof) incomplete = true;
                else {
                    size_t sl = e1 - q;
                    while (sl > 0 && w[q + sl - 1] == '\r') sl--;
                    total = (int64_t)sl;
                }
            }
        }
        if (!incomplete) return total;
        gz_refill(f);  // at EOF gz_eof flips and the re-parse completes
    }
}

// Consume the pending over-long record into caller buffers (sized via
// fx_long_len).  Returns seq length, fills id_len.
int64_t fx_long(void* h, uint8_t* raw_out, uint8_t* codes_out,
                uint8_t* id_out, int32_t* id_len) {
    Fx* f = (Fx*)h;
    size_t len;
    const uint8_t* w = window(f, &len);
    size_t p = f->pos;
    while (p < len && (w[p] == '\n' || w[p] == '\r')) p++;
    size_t hdr_end = find_nl(w, len, p);
    size_t id_s = p + 1, id_e = id_s;
    while (id_e < hdr_end && w[id_e] != ' ' && w[id_e] != '\t'
           && w[id_e] != '\r') id_e++;
    *id_len = (int32_t)(id_e - id_s);
    memcpy(id_out, w + id_s, id_e - id_s);
    size_t q = hdr_end + 1;
    int64_t o = 0;
    if (f->fasta) {
        while (q < len && w[q] != '>') {
            size_t e = find_nl(w, len, q);
            size_t sl = (e > q ? e - q : 0);
            while (sl > 0 && w[q + sl - 1] == '\r') sl--;
            memcpy(raw_out + o, w + q, sl);
            o += (int64_t)sl;
            q = (e < len) ? e + 1 : len;
        }
    } else {
        size_t e1 = find_nl(w, len, q);
        size_t sl = e1 - q;
        while (sl > 0 && w[q + sl - 1] == '\r') sl--;
        memcpy(raw_out, w + q, sl);
        o = (int64_t)sl;
        size_t p2 = e1 + 1;
        size_t e2 = p2 < len ? find_nl(w, len, p2) : len;
        size_t p3 = e2 + 1;
        size_t e3 = p3 < len ? find_nl(w, len, p3) : len;
        q = (e3 < len) ? e3 + 1 : len;
    }
    for (int64_t j = 0; j < o; j++) codes_out[j] = CODE[raw_out[j]];
    f->pos = q;
    return o;
}

// Start parsing a plain file at byte `offset`, the first byte of a record
// (or the file's end): a process reads its byte-range share of a FASTA
// without parsing what lies before it.  Returns 0, or -1 for a .gz input
// (streamed: no offsets) or an offset outside the file.
int fx_seek(void* h, int64_t offset) {
    Fx* f = (Fx*)h;
    if (f->gz || offset < 0 || (size_t)offset > f->map_size) return -1;
    f->pos = (size_t)offset;
    f->dropped = f->pos & ~((size_t)4095);
    return 0;
}

void fx_close(void* h) {
    Fx* f = (Fx*)h;
    if (f->map) munmap((void*)f->map, f->map_size);
    if (f->fd >= 0) close(f->fd);
    if (f->gz) gzclose(f->gz);
    delete f;
}

}  // extern "C"
