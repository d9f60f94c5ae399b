// Native mdBG GFA writer: S lines, (k-1)-overlap edge enumeration with the
// four orientation cases, presimp filtering and deferred symmetric L lines.
//
// Semantics parity: rust-mdbg src/main.rs:1006-1121 (see
// core/graph.py, whose Python implementation this replaces on the hot path;
// both are kept and tested against each other).  Overlap equality is tested
// on 128-bit fingerprints of the raw/reversed prefix & suffix vectors,
// supplied by the caller.
//
// Two entry styles share one Builder:
//   gfa_write                          — one-shot over complete arrays
//   gfa_begin/gfa_add_chunk/gfa_finish — incremental: the pipelined
//     device-output path (core/device_out.py) feeds each fetched node chunk
//     while the next device->host transfer is in flight, so the S-line
//     formatting and km_index hash build overlap the relay instead of
//     serializing after it; finish only enumerates edges and writes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct U128 {
    uint64_t lo, hi;
    bool operator==(const U128& o) const { return lo == o.lo && hi == o.hi; }
};
struct U128Hash {
    size_t operator()(const U128& k) const {
        return k.lo ^ (k.hi * 0x9E3779B97F4A7C15ULL);
    }
};
struct PairHash {
    size_t operator()(const std::pair<uint32_t, uint32_t>& p) const {
        return ((uint64_t)p.first << 32 | p.second) * 0x9E3779B97F4A7C15ULL;
    }
};

struct Builder {
    std::string s_lines;  // S lines, formatted as chunks arrive
    std::vector<uint32_t> index, abundance, seqlen;
    std::vector<uint16_t> shift0, shift1;
    // per-node fingerprints and normalized probe keys, [n, 2] u64 flattened
    std::vector<uint64_t> fs, fp, fsr, fpr, ksuf, kpre;
    std::unordered_map<U128, std::vector<uint32_t>, U128Hash> km_index;
    // phased feeding: chunks arrive before final abundances are known (the
    // counts of early-crossing nodes keep growing while later batches are
    // still being counted), so S-line formatting is deferred to finish and
    // gfa_set_abundance supplies the whole-run counts late.
    bool defer_s = false;
};

void add_chunk_impl(Builder* b, int64_t n,
                    const uint32_t* index, const uint32_t* abundance,
                    const uint32_t* seqlen,
                    const uint16_t* shift0, const uint16_t* shift1,
                    const uint64_t* fs, const uint64_t* fp_,
                    const uint64_t* fsr, const uint64_t* fpr,
                    const uint64_t* ksuf, const uint64_t* kpre) {
    // fs == nullptr: keys-free feeding — the edge join happens on DEVICE
    // (ops/edge_join.py) and arrives later as a POT list via
    // gfa_finish_pot, so no fingerprints cross and no km_index is built.
    char line[128];
    int64_t base = (int64_t)b->index.size();
    b->index.insert(b->index.end(), index, index + n);
    b->abundance.insert(b->abundance.end(), abundance, abundance + n);
    b->seqlen.insert(b->seqlen.end(), seqlen, seqlen + n);
    b->shift0.insert(b->shift0.end(), shift0, shift0 + n);
    b->shift1.insert(b->shift1.end(), shift1, shift1 + n);
    if (fs) {
        b->fs.insert(b->fs.end(), fs, fs + 2 * n);
        b->fp.insert(b->fp.end(), fp_, fp_ + 2 * n);
        b->fsr.insert(b->fsr.end(), fsr, fsr + 2 * n);
        b->fpr.insert(b->fpr.end(), fpr, fpr + 2 * n);
        b->ksuf.insert(b->ksuf.end(), ksuf, ksuf + 2 * n);
        b->kpre.insert(b->kpre.end(), kpre, kpre + 2 * n);
    }
    for (int64_t i = 0; i < n; i++) {
        if (!b->defer_s) {
            snprintf(line, sizeof line, "S\t%u\t*\tLN:i:%u\tKC:i:%u\n",
                     index[i], seqlen[i], abundance[i]);
            b->s_lines += line;
        }
        if (!fs) continue;
        // insertion order parity: pre then suf per node (main.rs:1023-1032)
        b->km_index[U128{kpre[2 * i], kpre[2 * i + 1]}].push_back(
            (uint32_t)(base + i));
        b->km_index[U128{ksuf[2 * i], ksuf[2 * i + 1]}].push_back(
            (uint32_t)(base + i));
    }
}

int64_t finish_impl(Builder* b, const char* path, double presimp,
                    int64_t* out_presimp_removed) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    std::string buf;
    buf.reserve(16 << 20);
    buf += "H\tVN:Z:1.0\n";
    if (b->defer_s) {
        char line_[128];
        for (size_t i = 0; i < b->index.size(); i++) {
            snprintf(line_, sizeof line_, "S\t%u\t*\tLN:i:%u\tKC:i:%u\n",
                     b->index[i], b->seqlen[i], b->abundance[i]);
            buf += line_;
        }
    } else {
        buf += b->s_lines;
    }
    b->s_lines.clear();
    b->s_lines.shrink_to_fit();
    char line[128];
    int64_t n = (int64_t)b->index.size();
    const uint32_t* index = b->index.data();
    const uint32_t* abundance = b->abundance.data();
    const uint32_t* seqlen = b->seqlen.data();
    const uint16_t* shift0 = b->shift0.data();
    const uint16_t* shift1 = b->shift1.data();

    auto get = [](const std::vector<uint64_t>& a, int64_t i) {
        return U128{a[2 * i], a[2 * i + 1]};
    };

    struct Edge { uint32_t a, b; char oa, ob; uint32_t ov; };
    int64_t presimp_removed = 0;
    int64_t nb_edges = 0;

    // Edge enumeration parallelized over contiguous node ranges — km_index
    // is read-only here, each worker appends to its own vectors, and
    // range-ordered concatenation reproduces the sequential emission order
    // exactly (node-ascending, suffix key group before prefix,
    // main.rs:1056-1075).  presimp drops are LOCAL decisions (group +
    // own/other abundance), so workers mark them independently; only the
    // deferred symmetric-drop pass below needs the merged removed set.
    struct Part {
        std::vector<Edge> edges;
        std::vector<std::pair<uint32_t, uint32_t>> removed;
        int64_t presimp_removed = 0;
    };
    int nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 8) nthreads = 8;
    if (n < 4096) nthreads = 1;
    std::vector<Part> parts(nthreads);
    auto work = [&](int t) {
        Part& P = parts[t];
        int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
        struct Pot { uint32_t j; char oa, ob; };
        std::vector<Pot> pot;
        for (int64_t i = lo; i < hi; i++) {
            U128 fs1 = get(b->fs, i), fpr1 = get(b->fpr, i);
            U128 keys[2] = {get(b->ksuf, i), get(b->kpre, i)};
            for (int ki = 0; ki < 2; ki++) {
                auto it = b->km_index.find(keys[ki]);
                if (it == b->km_index.end()) continue;
                pot.clear();
                for (uint32_t j : it->second) {
                    U128 fp2 = get(b->fp, j), fsr2 = get(b->fsr, j);
                    if (fs1 == fp2) pot.push_back({j, '+', '+'});
                    if (fs1 == fsr2) pot.push_back({j, '+', '-'});
                    if (fpr1 == fp2) pot.push_back({j, '-', '+'});
                    if (fpr1 == fsr2) pot.push_back({j, '-', '-'});
                }
                if (pot.empty()) continue;
                uint32_t ab_max = 0;
                for (const Pot& p : pot)
                    if (abundance[p.j] > ab_max) ab_max = abundance[p.j];
                uint32_t ab_ref =
                    ab_max < abundance[i] ? ab_max : abundance[i];
                for (const Pot& p : pot) {
                    if (presimp > 0.0 && pot.size() >= 2 &&
                        (double)abundance[p.j] < presimp * (double)ab_ref) {
                        P.presimp_removed++;
                        P.removed.push_back({index[i], index[p.j]});
                        continue;
                    }
                    uint32_t sh = p.oa == '+' ? shift0[i] : shift1[i];
                    uint32_t ov1 = seqlen[i] - sh;  // u32 wrap like the ref
                    uint32_t ov2 = seqlen[p.j] - 1;
                    uint32_t ov = ov1 < ov2 ? ov1 : ov2;
                    P.edges.push_back({(uint32_t)index[i], index[p.j], p.oa,
                                       p.ob, ov});
                }
            }
        }
    };
    if (nthreads == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nthreads; t++) ts.emplace_back(work, t);
        for (auto& t : ts) t.join();
    }
    std::unordered_set<std::pair<uint32_t, uint32_t>, PairHash> removed;
    for (const Part& P : parts) {
        presimp_removed += P.presimp_removed;
        for (const auto& r : P.removed) removed.insert(r);
    }
    for (const Part& P : parts) {
        for (const Edge& e : P.edges) {
            if (presimp > 0.0 &&
                (removed.count({e.a, e.b}) || removed.count({e.b, e.a})))
                continue;
            snprintf(line, sizeof line, "L\t%u\t%c\t%u\t%c\t%uM\n",
                     e.a, e.oa, e.b, e.ob, e.ov);
            buf += line;
            nb_edges++;
            if (buf.size() > (8u << 20)) {
                fwrite(buf.data(), 1, buf.size(), f); buf.clear();
            }
        }
    }
    fwrite(buf.data(), 1, buf.size(), f);
    fclose(f);
    *out_presimp_removed = presimp_removed;
    return nb_edges;
}

// POT-list finish: the orientation-case join already ran on device
// (ops/edge_join.py); pot arrives ordered exactly as finish_impl would
// enumerate it — probe-major (node i ascending, suffix key group before
// prefix), candidates in km_index insertion order, the four cases in fixed
// order.  This pass only applies presimp (which needs whole-run abundances
// and f64 arithmetic, main.rs:1086-1090), the deferred symmetric-drop rule,
// and formats the file.  pot_c = (ki << 2) | case with case order
// ++, +-, -+, -- (matching finish_impl's pot push order).
int64_t finish_pot_impl(Builder* b, const char* path, double presimp,
                        const uint32_t* pot_i, const uint32_t* pot_j,
                        const uint32_t* pot_c, int64_t n_pot,
                        int64_t* out_presimp_removed) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    std::string buf;
    buf.reserve(16 << 20);
    buf += "H\tVN:Z:1.0\n";
    char line[128];
    if (b->defer_s) {
        for (size_t i = 0; i < b->index.size(); i++) {
            snprintf(line, sizeof line, "S\t%u\t*\tLN:i:%u\tKC:i:%u\n",
                     b->index[i], b->seqlen[i], b->abundance[i]);
            buf += line;
        }
    } else {
        buf += b->s_lines;
    }
    b->s_lines.clear();
    b->s_lines.shrink_to_fit();

    struct Edge { uint32_t a, b; char oa, ob; uint32_t ov; };
    std::vector<Edge> edges;
    edges.reserve((size_t)n_pot);
    std::unordered_set<std::pair<uint32_t, uint32_t>, PairHash> removed;
    int64_t presimp_removed = 0;
    static const char OA[4] = {'+', '+', '-', '-'};
    static const char OB[4] = {'+', '-', '+', '-'};
    int64_t g0 = 0;
    while (g0 < n_pot) {
        uint32_t i = pot_i[g0];
        uint32_t ki = pot_c[g0] >> 2;
        int64_t g1 = g0;
        while (g1 < n_pot && pot_i[g1] == i && (pot_c[g1] >> 2) == ki) g1++;
        uint32_t ab_max = 0;
        for (int64_t t = g0; t < g1; t++)
            if (b->abundance[pot_j[t]] > ab_max)
                ab_max = b->abundance[pot_j[t]];
        uint32_t ab_ref =
            ab_max < b->abundance[i] ? ab_max : b->abundance[i];
        int64_t potsize = g1 - g0;
        for (int64_t t = g0; t < g1; t++) {
            uint32_t j = pot_j[t];
            int c = (int)(pot_c[t] & 3);
            if (presimp > 0.0 && potsize >= 2 &&
                (double)b->abundance[j] < presimp * (double)ab_ref) {
                presimp_removed++;
                removed.insert({b->index[i], b->index[j]});
                continue;
            }
            uint32_t sh = OA[c] == '+' ? b->shift0[i] : b->shift1[i];
            uint32_t ov1 = b->seqlen[i] - sh;  // u32 wrap like the ref
            uint32_t ov2 = b->seqlen[j] - 1;
            edges.push_back({b->index[i], b->index[j], OA[c], OB[c],
                             ov1 < ov2 ? ov1 : ov2});
        }
        g0 = g1;
    }
    int64_t nb_edges = 0;
    for (const Edge& e : edges) {
        if (presimp > 0.0 &&
            (removed.count({e.a, e.b}) || removed.count({e.b, e.a})))
            continue;
        snprintf(line, sizeof line, "L\t%u\t%c\t%u\t%c\t%uM\n",
                 e.a, e.oa, e.b, e.ob, e.ov);
        buf += line;
        nb_edges++;
        if (buf.size() > (8u << 20)) {
            fwrite(buf.data(), 1, buf.size(), f);
            buf.clear();
        }
    }
    fwrite(buf.data(), 1, buf.size(), f);
    fclose(f);
    *out_presimp_removed = presimp_removed;
    return nb_edges;
}

}  // namespace

extern "C" {

void* gfa_begin(int64_t cap_hint) {
    Builder* b = new Builder();
    if (cap_hint > 0) {
        b->index.reserve(cap_hint);
        b->abundance.reserve(cap_hint);
        b->seqlen.reserve(cap_hint);
        b->shift0.reserve(cap_hint);
        b->shift1.reserve(cap_hint);
        b->fs.reserve(2 * cap_hint);
        b->fp.reserve(2 * cap_hint);
        b->fsr.reserve(2 * cap_hint);
        b->fpr.reserve(2 * cap_hint);
        b->ksuf.reserve(2 * cap_hint);
        b->kpre.reserve(2 * cap_hint);
        b->km_index.reserve(2 * cap_hint);
    }
    return b;
}

void gfa_add_chunk(void* h, int64_t n,
                   const uint32_t* index, const uint32_t* abundance,
                   const uint32_t* seqlen,
                   const uint16_t* shift0, const uint16_t* shift1,
                   const uint64_t* fs, const uint64_t* fp_,
                   const uint64_t* fsr, const uint64_t* fpr,
                   const uint64_t* ksuf, const uint64_t* kpre) {
    add_chunk_impl((Builder*)h, n, index, abundance, seqlen, shift0, shift1,
                   fs, fp_, fsr, fpr, ksuf, kpre);
}

int64_t gfa_finish(void* h, const char* path, double presimp,
                   int64_t* out_presimp_removed) {
    Builder* b = (Builder*)h;
    int64_t r = finish_impl(b, path, presimp, out_presimp_removed);
    delete b;
    return r;
}

// POT-list finish (device edge join): see finish_pot_impl.
int64_t gfa_finish_pot(void* h, const char* path, double presimp,
                       const uint32_t* pot_i, const uint32_t* pot_j,
                       const uint32_t* pot_c, int64_t n_pot,
                       int64_t* out_presimp_removed) {
    Builder* b = (Builder*)h;
    int64_t r = finish_pot_impl(b, path, presimp, pot_i, pot_j, pot_c,
                                n_pot, out_presimp_removed);
    delete b;
    return r;
}

void gfa_abort(void* h) { delete (Builder*)h; }

// Phased feeding: defer S-line formatting until finish (final abundances
// arrive late via gfa_set_abundance).  Call before the first add_chunk.
void gfa_defer_s(void* h) { ((Builder*)h)->defer_s = true; }

// Overwrite the first n abundance values (row order = feed order).
void gfa_set_abundance(void* h, const uint32_t* ab, int64_t n) {
    Builder* b = (Builder*)h;
    if (n > (int64_t)b->abundance.size()) n = (int64_t)b->abundance.size();
    memcpy(b->abundance.data(), ab, (size_t)n * sizeof(uint32_t));
}

// fp arrays are [n, 2] u64 (lo, hi): fs = F(suffix), fp_ = F(prefix),
// fsr = F(rev suffix), fpr = F(rev prefix), ksuf/kpre = normalized keys.
// Returns number of edges written, or -1 on error.
int64_t gfa_write(const char* path, int64_t n,
                  const uint32_t* index, const uint32_t* abundance,
                  const uint32_t* seqlen,
                  const uint16_t* shift0, const uint16_t* shift1,
                  const uint64_t* fs, const uint64_t* fp_,
                  const uint64_t* fsr, const uint64_t* fpr,
                  const uint64_t* ksuf, const uint64_t* kpre,
                  double presimp, int64_t* out_presimp_removed) {
    Builder b;
    add_chunk_impl(&b, n, index, abundance, seqlen, shift0, shift1,
                   fs, fp_, fsr, fpr, ksuf, kpre);
    return finish_impl(&b, path, presimp, out_presimp_removed);
}

}  // extern "C"
