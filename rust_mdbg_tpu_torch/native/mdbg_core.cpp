// Native host core for the TPU mdBG pipeline: the k-min-mer node table.
//
// Plays the role of the reference's `dbg_nodes: DashMap<Kmer, DbgEntry>` +
// `NODE_INDEX` atomic + optional racy Bloom (rust-mdbg src/main.rs:595-709),
// with the exact `add_kminmer` semantics:
//   - abundance counting per canonical k-min-mer
//   - node index assigned in CROSSING-occurrence order (the order the
//     reference writes .sequences records, main.rs:693-707) — the
//     deterministic stand-in for its thread-arrival atomic, and the same
//     order the device sort/segment counter uses (ops/sort_count.py), so
//     host and device engines emit byte-identical GFA/.sequences.  Entries
//     that have not yet crossed min_abundance carry a provisional
//     0x80000000|insertion-rank index (nodetable.py dump renumbers them
//     after the crossed ones; they only surface via dump(min_filter=0))
//   - seqlen/shift recorded from the occurrence that crosses min_abundance
//     (main.rs:680-684), and that occurrence is flagged back to the caller so
//     the host can emit the .sequences line exactly once (main.rs:693-707)
//   - optional single-hash Bloom pre-filter that keeps abundance-1 k-min-mers
//     out of the table (main.rs:639-655); ours is race-free since adds are
//     sequential per shard.
//
// Keys are 128-bit fingerprints of the canonical minimizer vector (the Python
// side keeps full vectors for the surviving nodes; see core/nodetable.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

struct Entry {
    uint64_t key_lo;
    uint64_t key_hi;
    uint32_t index;      // crossing order; 0x80000000|insertion rank until crossed
    uint32_t seqlen;
    uint32_t abundance;  // saturating (reference u16 would wrap in release)
    uint16_t shift0, shift1;
};

struct Table {
    std::vector<Entry> slots;
    std::vector<uint8_t> used;
    uint64_t mask = 0;
    uint64_t count = 0;
    uint32_t next_index = 0;  // crossing-order id counter
    uint32_t next_ins = 0;    // provisional insertion-rank counter
    uint32_t min_abund = 2;
    // bloom
    std::vector<uint64_t> bloom;
    uint64_t bloom_mask = 0;  // in bits
    bool use_bf = false;
    bool keep_all = false;    // params.reference: no bf screening

    void init(uint64_t cap_hint) {
        uint64_t cap = 1024;
        while (cap < cap_hint * 2) cap <<= 1;
        slots.resize(cap);
        used.assign(cap, 0);
        mask = cap - 1;
    }
    void grow() {
        std::vector<Entry> old = std::move(slots);
        std::vector<uint8_t> oldu = std::move(used);
        uint64_t ncap = (mask + 1) * 2;
        slots.assign(ncap, Entry{});
        used.assign(ncap, 0);
        mask = ncap - 1;
        for (uint64_t i = 0; i <= (oldu.size() - 1); i++) {
            if (!oldu[i]) continue;
            const Entry& e = old[i];
            uint64_t h = e.key_lo & mask;
            while (used[h]) h = (h + 1) & mask;
            slots[h] = e;
            used[h] = 1;
        }
    }
    // returns slot of key, inserting if absent (insert=true); found flag out
    uint64_t find(uint64_t lo, uint64_t hi, bool* found) {
        uint64_t h = lo & mask;
        while (used[h]) {
            if (slots[h].key_lo == lo && slots[h].key_hi == hi) { *found = true; return h; }
            h = (h + 1) & mask;
        }
        *found = false;
        return h;
    }
};

}  // namespace

extern "C" {

void* nt_create(uint64_t cap_hint, uint32_t min_abund, int use_bf, uint64_t bloom_log2_bits,
                int keep_all) {
    Table* t = new Table();
    t->init(cap_hint ? cap_hint : 1 << 20);
    t->min_abund = min_abund;
    t->use_bf = use_bf != 0;
    t->keep_all = keep_all != 0;
    if (t->use_bf) {
        uint64_t bits = 1ULL << bloom_log2_bits;
        t->bloom.assign(bits / 64, 0);
        t->bloom_mask = bits - 1;
    }
    return t;
}

void nt_destroy(void* p) { delete static_cast<Table*>(p); }

uint64_t nt_size(void* p) { return static_cast<Table*>(p)->count; }

void nt_clear(void* p) {
    Table* t = static_cast<Table*>(p);
    std::fill(t->used.begin(), t->used.end(), 0);
    t->count = 0;
    t->next_index = 0;
    t->next_ins = 0;
    if (t->use_bf) std::fill(t->bloom.begin(), t->bloom.end(), 0);
}

// Batched add_kminmer. out_flags[i]=1 iff this occurrence crossed min_abund
// (the caller should write its .sequences record); out_index[i] = node index
// (0xFFFFFFFF when the occurrence was swallowed by the Bloom pre-filter).
void nt_add_batch(void* p, int64_t n,
                  const uint64_t* key_lo, const uint64_t* key_hi,
                  const uint32_t* seqlen,
                  const uint16_t* shift0, const uint16_t* shift1,
                  uint8_t* out_flags, uint32_t* out_index) {
    Table* t = static_cast<Table*>(p);
    const uint32_t minab = t->min_abund;
    for (int64_t i = 0; i < n; i++) {
        uint64_t lo = key_lo[i], hi = key_hi[i];
        out_flags[i] = 0;
        out_index[i] = 0xFFFFFFFFu;
        if (t->use_bf && !t->keep_all && minab > 1) {
            // single-hash bloom: first sighting only marks the filter
            uint64_t bit = (lo ^ (hi * 0x9E3779B97F4A7C15ULL)) & t->bloom_mask;
            uint64_t word = bit >> 6, m = 1ULL << (bit & 63);
            if (!(t->bloom[word] & m)) {
                t->bloom[word] |= m;
                continue;
            }
        }
        bool found;
        uint64_t slot = t->find(lo, hi, &found);
        if (found) {
            Entry& e = t->slots[slot];
            uint32_t prev = e.abundance;
            if (prev == minab - 1) {
                e.seqlen = seqlen[i];
                e.shift0 = shift0[i];
                e.shift1 = shift1[i];
                e.index = t->next_index++;  // crossing occurrence: assign id
                out_flags[i] = 1;
            }
            if (e.abundance < 0xFFFFFFFFu) e.abundance++;
            out_index[i] = e.index;
        } else {
            uint32_t prev = (t->use_bf && !t->keep_all && minab > 1) ? 1u : 0u;
            Entry e;
            e.key_lo = lo; e.key_hi = hi;
            e.seqlen = seqlen[i];
            e.shift0 = shift0[i]; e.shift1 = shift1[i];
            e.abundance = prev + 1;
            if (prev == minab - 1) {
                e.index = t->next_index++;  // crosses at insertion
                out_flags[i] = 1;
            } else {
                e.index = 0x80000000u | t->next_ins++;
            }
            t->slots[slot] = e;
            t->used[slot] = 1;
            t->count++;
            out_index[i] = e.index;
            if (t->count * 10 >= (t->mask + 1) * 7) t->grow();
        }
    }
}

// Chunked hierarchical merge (core/chunked.py): one call per input chunk.
// Inputs are the chunk's unique keys in first-occurrence order with their
// in-chunk occurrence counts.  Updates global abundances and reports for each
// key whether the min_abund crossing occurrence (main.rs:680-707) falls in
// this chunk: out_sel[i] = 0 (no) or j > 0 (use the chunk's j-th occurrence).
// j = min_abund - prior_global_count (+1 when the Bloom consumed the chunk's
// 1st appearance), so j <= min_abund always — the device emission carries
// min_abund occurrence slots, making the capture exact for ANY --minabund.
// Node ids are NOT assigned here: crossing entries stay provisional until
// nt_set_meta_batch, which the driver calls in crossing-OCCURRENCE order —
// reproducing the whole-run engines' id order exactly (byte-identical GFA).
// out_index[i] = provisional id, or 0xFFFFFFFF for a Bloom-swallowed
// singleton.
void nt_merge_chunk(void* p, int64_t n,
                    const uint64_t* key_lo, const uint64_t* key_hi,
                    const uint32_t* count,
                    uint8_t* out_sel, uint32_t* out_index) {
    Table* t = static_cast<Table*>(p);
    const uint32_t minab = t->min_abund;
    const bool plain = t->keep_all || minab <= 1;
    const bool bf = !plain && t->use_bf;
    for (int64_t i = 0; i < n; i++) {
        uint64_t lo = key_lo[i], hi = key_hi[i];
        uint64_t c = count[i];
        out_sel[i] = 0;
        out_index[i] = 0xFFFFFFFFu;
        bool found;
        uint64_t slot = t->find(lo, hi, &found);
        if (found) {
            Entry& e = t->slots[slot];
            uint64_t a = e.abundance;
            if (a < minab && a + c >= minab) {
                out_sel[i] = (uint8_t)(minab - a);  // id assigned at set_meta
            }
            uint64_t na = a + c;
            e.abundance = na > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)na;
            out_index[i] = e.index;
            continue;
        }
        uint64_t prev = 0;  // occurrences counted before this chunk
        if (bf) {
            uint64_t bit = (lo ^ (hi * 0x9E3779B97F4A7C15ULL)) & t->bloom_mask;
            uint64_t word = bit >> 6, m = 1ULL << (bit & 63);
            if (!(t->bloom[word] & m)) {
                // first global sighting: the chunk's 1st occurrence only
                // marks the filter (main.rs:639-655 semantics)
                t->bloom[word] |= m;
                if (c == 1) continue;  // swallowed singleton
                // chunk has >= 2 occurrences: insert now; the marked
                // occurrence is counted via the prev=1 convention of
                // nt_add_batch, so abundance comes out to c
                prev = 1;
                c -= 1;
            } else {
                prev = 1;  // bloom hit: one earlier (marked) occurrence
            }
        }
        Entry e;
        e.key_lo = lo; e.key_hi = hi;
        e.seqlen = 0; e.shift0 = 0; e.shift1 = 0;  // set via nt_set_meta_batch
        uint64_t na = prev + c;
        e.abundance = na > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)na;
        e.index = 0x80000000u | t->next_ins++;  // real id at nt_set_meta_batch
        t->slots[slot] = e;
        t->used[slot] = 1;
        t->count++;
        out_index[i] = e.index;
        if (plain) {
            out_sel[i] = 1;
        } else if (prev < minab && prev + c >= minab) {
            // crossing occurrence is the (minab - prev)-th of this chunk's
            // appearances; under the Bloom branch above the 1st appearance
            // was consumed by the filter, shifting the selector by one
            uint64_t sel = minab - prev;
            if (bf && prev == 1 && count[i] > c) sel += 1;  // marked here
            out_sel[i] = (uint8_t)sel;
        }
        if (t->count * 10 >= (t->mask + 1) * 7) t->grow();
    }
}

// Fill seqlen/shift of entries whose crossing fell in this chunk, AND assign
// their node ids: the driver calls this in crossing-OCCURRENCE order (it
// sorts the chunk's crossing keys by the occurrence the merge selected), so
// ids match the whole-run engines' crossing order exactly.  out_index gets
// the assigned (or existing) id per key.
void nt_set_meta_batch(void* p, int64_t n,
                       const uint64_t* key_lo, const uint64_t* key_hi,
                       const uint32_t* seqlen,
                       const uint16_t* shift0, const uint16_t* shift1,
                       uint32_t* out_index) {
    Table* t = static_cast<Table*>(p);
    for (int64_t i = 0; i < n; i++) {
        bool found;
        uint64_t slot = t->find(key_lo[i], key_hi[i], &found);
        if (!found) { out_index[i] = 0xFFFFFFFFu; continue; }
        Entry& e = t->slots[slot];
        e.seqlen = seqlen[i];
        e.shift0 = shift0[i];
        e.shift1 = shift1[i];
        if (e.index & 0x80000000u) e.index = t->next_index++;
        out_index[i] = e.index;
    }
}

// Abundance filter: delete entries below min_abund (main.rs:922-933 retain).
void nt_retain(void* p, uint32_t min_abund) {
    Table* t = static_cast<Table*>(p);
    std::vector<Entry> keep;
    keep.reserve(t->count);
    for (uint64_t i = 0; i <= t->mask; i++) {
        if (t->used[i] && t->slots[i].abundance >= min_abund) keep.push_back(t->slots[i]);
    }
    std::fill(t->used.begin(), t->used.end(), 0);
    t->count = 0;
    for (const Entry& e : keep) {
        uint64_t h = e.key_lo & t->mask;
        while (t->used[h]) h = (h + 1) & t->mask;
        t->slots[h] = e;
        t->used[h] = 1;
        t->count++;
    }
}

// Read-only lookup of abundances (read_stats mode, main.rs:938-1004).
void nt_lookup_batch(void* p, int64_t n,
                     const uint64_t* key_lo, const uint64_t* key_hi,
                     uint32_t* out_abundance) {
    Table* t = static_cast<Table*>(p);
    for (int64_t i = 0; i < n; i++) {
        bool found;
        uint64_t slot = t->find(key_lo[i], key_hi[i], &found);
        out_abundance[i] = found ? t->slots[slot].abundance : 0;
    }
}

// Dump entries with abundance >= min_filter, in index order is NOT guaranteed
// here (hash order); caller sorts by index. Returns number written.
int64_t nt_dump(void* p, uint32_t min_filter,
                uint64_t* key_lo, uint64_t* key_hi, uint32_t* index,
                uint32_t* abundance, uint32_t* seqlen,
                uint16_t* shift0, uint16_t* shift1) {
    Table* t = static_cast<Table*>(p);
    int64_t w = 0;
    for (uint64_t i = 0; i <= t->mask; i++) {
        if (!t->used[i]) continue;
        const Entry& e = t->slots[i];
        if (e.abundance < min_filter) continue;
        key_lo[w] = e.key_lo; key_hi[w] = e.key_hi;
        index[w] = e.index; abundance[w] = e.abundance;
        seqlen[w] = e.seqlen; shift0[w] = e.shift0; shift1[w] = e.shift1;
        w++;
    }
    return w;
}

}  // extern "C"
