// hicio — native IO runtime for hichap_master_tpu.
//
// The heaviest host-side stages of the pipeline are external sorts and
// merge-joins over multi-GB bed text (the reference spends its time in
// Python string splits + heapq merges, HiCHap/filtering.py:77-121,451-499).
// This module provides the native equivalents, exposed through a plain C ABI
// consumed via ctypes (no pybind11 dependency):
//
//   hicio_sort_file(in, out, mode)   — external-memory line sort
//        mode 0: whole-line lexicographic (pair-name sort for the allelic
//                merge-join; byte order == Python str order for ASCII)
//        mode 1: HiC dedup key (chr1, strand1, pos1, chr2, strand2, pos2) =
//                columns 1,2,3,8,9,10 with numeric positions
//   hicio_merge_sorted(files, n, out) — k-way merge of sorted files
//   hicio_sam_sort_merge(files, n, out) — merge SAM bodies from n files
//        (headers dropped) globally sorted by query name, stable in
//        (file, line) order — the `samtools merge -n` + name-sort step of
//        alignment integration (HiCHap/bamProcess.py:730,1498)
//   hicio_count_lines(path)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC hicio.cpp -o libhicio.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <queue>
#include <string>
#include <vector>

namespace {

struct Key6 {
    std::string c1, c2;
    int s1 = 0, s2 = 0;
    long p1 = 0, p2 = 0;
};

// Extract tab-separated field [begin,end) for column `col` of `line`.
static bool field(const std::string& line, int col, size_t* b, size_t* e) {
    size_t pos = 0;
    for (int c = 0; c < col; ++c) {
        pos = line.find('\t', pos);
        if (pos == std::string::npos) return false;
        ++pos;
    }
    size_t end = line.find('\t', pos);
    if (end == std::string::npos) end = line.size();
    *b = pos;
    *e = end;
    return true;
}

static Key6 key6(const std::string& line) {
    Key6 k;
    size_t b, e;
    if (field(line, 1, &b, &e)) k.c1.assign(line, b, e - b);
    if (field(line, 2, &b, &e)) k.s1 = std::atoi(line.c_str() + b);
    if (field(line, 3, &b, &e)) k.p1 = std::atol(line.c_str() + b);
    if (field(line, 8, &b, &e)) k.c2.assign(line, b, e - b);
    if (field(line, 9, &b, &e)) k.s2 = std::atoi(line.c_str() + b);
    if (field(line, 10, &b, &e)) k.p2 = std::atol(line.c_str() + b);
    return k;
}

static bool less_k6(const Key6& ka, const Key6& kb) {
    if (ka.c1 != kb.c1) return ka.c1 < kb.c1;
    if (ka.s1 != kb.s1) return ka.s1 < kb.s1;
    if (ka.p1 != kb.p1) return ka.p1 < kb.p1;
    if (ka.c2 != kb.c2) return ka.c2 < kb.c2;
    if (ka.s2 != kb.s2) return ka.s2 < kb.s2;
    return ka.p2 < kb.p2;
}

static bool less_key6(const std::string& a, const std::string& b) {
    return less_k6(key6(a), key6(b));
}

// Decorate-sort-undecorate: key6() allocates two strings and parses four
// ints; inside a comparator it runs ~2 n log n times (measured as the
// wall of the 20M-record filtering sort).  Extract each key ONCE.
static void sort_lines(std::vector<std::string>& lines, int mode) {
    if (mode == 0) {
        std::sort(lines.begin(), lines.end());
        return;
    }
    const size_t n = lines.size();
    std::vector<std::pair<Key6, uint32_t>> keyed;
    keyed.reserve(n);
    for (size_t i = 0; i < n; ++i)
        keyed.emplace_back(key6(lines[i]), static_cast<uint32_t>(i));
    std::sort(keyed.begin(), keyed.end(),
              [](const std::pair<Key6, uint32_t>& x,
                 const std::pair<Key6, uint32_t>& y) {
                  return less_k6(x.first, y.first);
              });
    std::vector<std::string> out(n);
    for (size_t i = 0; i < n; ++i) out[i] = std::move(lines[keyed[i].second]);
    lines.swap(out);
}

// spill threshold; HICIO_CHUNK_BYTES overrides (exercises the
// external-memory path in tests)
static size_t chunk_bytes() {
    const char* e = std::getenv("HICIO_CHUNK_BYTES");
    return e ? std::strtoull(e, nullptr, 10) : (512ull << 20);
}

// k-way merge of hic_key-sorted streams with the key parsed ONCE per
// line (the comparator form re-parsed both lines on every heap sift).
static void merge_streams_k6(std::vector<std::ifstream>& streams,
                             std::ofstream& out) {
    struct KHead {
        Key6 key;
        std::string line;
        size_t idx;
    };
    auto cmp = [](const KHead& a, const KHead& b) {
        return less_k6(b.key, a.key);
    };
    std::priority_queue<KHead, std::vector<KHead>, decltype(cmp)> pq(cmp);
    for (size_t i = 0; i < streams.size(); ++i) {
        std::string l;
        if (std::getline(streams[i], l)) {
            Key6 k = key6(l);
            pq.push({std::move(k), std::move(l), i});
        }
    }
    while (!pq.empty()) {
        KHead h = pq.top();
        pq.pop();
        out << h.line << '\n';
        std::string l;
        if (std::getline(streams[h.idx], l)) {
            Key6 k = key6(l);
            pq.push({std::move(k), std::move(l), h.idx});
        }
    }
}

}  // namespace

extern "C" {

long hicio_count_lines(const char* path) {
    std::ifstream in(path);
    if (!in) return -1;
    long n = 0;
    std::string line;
    while (std::getline(in, line)) ++n;
    return n;
}

// Returns 0 on success.  Spills sorted chunks to <out>.chk<i> when the input
// exceeds the in-memory threshold, then k-way merges.
int hicio_sort_file(const char* in_path, const char* out_path, int mode) {
    std::ifstream in(in_path);
    if (!in) return 1;

    std::vector<std::string> chunk_files;
    std::vector<std::string> lines;
    size_t bytes = 0;
    std::string line;

    auto spill = [&](bool final_chunk) -> int {
        sort_lines(lines, mode);
        if (final_chunk && chunk_files.empty()) {
            std::ofstream out(out_path);
            if (!out) return 1;
            for (auto& l : lines) out << l << '\n';
            return 0;
        }
        std::string name = std::string(out_path) + ".chk" +
                           std::to_string(chunk_files.size());
        std::ofstream out(name);
        if (!out) return 1;
        for (auto& l : lines) out << l << '\n';
        chunk_files.push_back(name);
        lines.clear();
        bytes = 0;
        return 0;
    };

    while (std::getline(in, line)) {
        bytes += line.size() + 1;
        lines.push_back(std::move(line));
        if (bytes >= chunk_bytes()) {
            if (spill(false)) return 1;
        }
    }
    if (chunk_files.empty()) return spill(true);
    if (!lines.empty() && spill(false)) return 1;

    // k-way merge of spilled chunks
    struct Head {
        std::string line;
        size_t idx;
    };
    auto cmp_whole = [](const Head& a, const Head& b) { return a.line > b.line; };
    auto cmp_k6 = [](const Head& a, const Head& b) {
        return less_key6(b.line, a.line);
    };

    std::vector<std::ifstream> streams;
    streams.reserve(chunk_files.size());
    for (auto& f : chunk_files) streams.emplace_back(f);

    std::ofstream out(out_path);
    if (!out) return 1;

    auto merge = [&](auto cmp) {
        std::priority_queue<Head, std::vector<Head>, decltype(cmp)> pq(cmp);
        for (size_t i = 0; i < streams.size(); ++i) {
            std::string l;
            if (std::getline(streams[i], l)) pq.push({std::move(l), i});
        }
        while (!pq.empty()) {
            Head h = pq.top();
            pq.pop();
            out << h.line << '\n';
            std::string l;
            if (std::getline(streams[h.idx], l)) pq.push({std::move(l), h.idx});
        }
    };
    if (mode == 0) merge(cmp_whole);
    else merge_streams_k6(streams, out);

    for (auto& f : chunk_files) std::remove(f.c_str());
    return 0;
}

// SAM body merge-sort: lines from all inputs (headers skipped), globally
// sorted by query name (field 0), ties broken by global (file, line)
// sequence — identical to appending the files and running a stable sort.
// External-memory: spills sorted chunks with a zero-padded sequence prefix
// and k-way merges, so multi-GB alignment sets never load whole.
int hicio_sam_sort_merge(const char** paths, int n, const char* out_path) {
    struct Rec {
        std::string line;
        uint64_t seq;
    };
    auto qname_end = [](const std::string& l) {
        size_t e = l.find('\t');
        return e == std::string::npos ? l.size() : e;
    };
    auto less_rec = [&](const Rec& a, const Rec& b) {
        int c = std::strncmp(a.line.c_str(), b.line.c_str(),
                             std::min(qname_end(a.line), qname_end(b.line)));
        if (c != 0) return c < 0;
        size_t la = qname_end(a.line), lb = qname_end(b.line);
        if (la != lb) return la < lb;
        return a.seq < b.seq;
    };

    std::vector<std::string> chunk_files;
    std::vector<Rec> recs;
    size_t bytes = 0;
    uint64_t seq = 0;

    auto spill_name = [&]() {
        return std::string(out_path) + ".schk" +
               std::to_string(chunk_files.size());
    };
    auto spill = [&]() -> int {
        std::sort(recs.begin(), recs.end(), less_rec);
        std::string name = spill_name();
        std::ofstream out(name);
        if (!out) return 1;
        char pre[32];
        for (auto& r : recs) {
            std::snprintf(pre, sizeof pre, "%020llu\t",
                          (unsigned long long)r.seq);
            out << pre << r.line << '\n';
        }
        chunk_files.push_back(name);
        recs.clear();
        bytes = 0;
        return 0;
    };

    for (int i = 0; i < n; ++i) {
        std::ifstream in(paths[i]);
        if (!in) return 1;
        std::string line;
        while (std::getline(in, line)) {
            if (!line.empty() && line[0] == '@') continue;
            bytes += line.size() + 1;
            recs.push_back({std::move(line), seq++});
            if (bytes >= chunk_bytes()) {
                if (spill()) return 1;
            }
        }
    }

    if (chunk_files.empty()) {
        std::sort(recs.begin(), recs.end(), less_rec);
        std::ofstream out(out_path);
        if (!out) return 1;
        for (auto& r : recs) out << r.line << '\n';
        return 0;
    }
    if (!recs.empty() && spill()) return 1;

    // merge: chunk lines are "seq\tSAMLINE" — compare (qname, seq)
    auto chunk_rec = [&](const std::string& l) -> Rec {
        size_t t = l.find('\t');
        return {l.substr(t + 1), std::strtoull(l.c_str(), nullptr, 10)};
    };
    struct Head {
        Rec rec;
        size_t idx;
    };
    auto cmp = [&](const Head& a, const Head& b) {
        return less_rec(b.rec, a.rec);
    };
    std::vector<std::ifstream> streams;
    streams.reserve(chunk_files.size());
    for (auto& f : chunk_files) streams.emplace_back(f);
    std::ofstream out(out_path);
    if (!out) return 1;
    std::priority_queue<Head, std::vector<Head>, decltype(cmp)> pq(cmp);
    for (size_t i = 0; i < streams.size(); ++i) {
        std::string l;
        if (std::getline(streams[i], l)) pq.push({chunk_rec(l), i});
    }
    while (!pq.empty()) {
        Head h = pq.top();
        pq.pop();
        out << h.rec.line << '\n';
        std::string l;
        if (std::getline(streams[h.idx], l)) pq.push({chunk_rec(l), h.idx});
    }
    for (auto& f : chunk_files) std::remove(f.c_str());
    return 0;
}

// Parse a block of valid-bed text (complete lines) into columnar arrays.
// Consumes tab-separated columns 1, 6, 8, 13 (0-indexed) = chrom1,
// fragment-mid1, chrom2, fragment-mid2 (HiCHap/matrixBuilding.py:575-586).
// Chromosome fields strip a "chr" prefix and match the label table
// verbatim (the io/bedio._chrom_index rule); rows with an unknown chrom
// or a missing/non-numeric position are dropped.  Returns kept rows.
long hicio_parse_valid_chunk(const char* buf, long nbytes,
                             const char* const* labels, int n_labels,
                             int32_t* c1, int64_t* p1,
                             int32_t* c2, int64_t* p2) {
    std::vector<size_t> llen(n_labels);
    for (int i = 0; i < n_labels; ++i) llen[i] = std::strlen(labels[i]);
    auto lookup = [&](const char* b, const char* e) -> int {
        if (e - b >= 3 && b[0] == 'c' && b[1] == 'h' && b[2] == 'r') b += 3;
        const size_t n = static_cast<size_t>(e - b);
        for (int i = 0; i < n_labels; ++i)
            if (llen[i] == n && std::memcmp(labels[i], b, n) == 0) return i;
        return -1;
    };
    auto num = [](const char* b, const char* e, int64_t* out) -> bool {
        if (b == e || e - b > 18) return false;  // >18 digits: overflow
        const bool neg = (*b == '-');
        if (neg && ++b == e) return false;
        int64_t v = 0;
        for (; b < e; ++b) {
            if (*b < '0' || *b > '9') return false;
            v = v * 10 + (*b - '0');
        }
        *out = neg ? -v : v;
        return true;
    };
    long out = 0;
    const char* p = buf;
    const char* const end = buf + nbytes;
    while (p < end) {
        const char* nl =
            static_cast<const char*>(std::memchr(p, '\n', end - p));
        const char* eol = nl ? nl : end;
        if (eol > p && eol[-1] == '\r') --eol;  // CRLF beds
        const char* fb[4] = {nullptr, nullptr, nullptr, nullptr};
        const char* fe[4] = {nullptr, nullptr, nullptr, nullptr};
        int col = 0;
        const char* fs = p;
        for (const char* q = p; q <= eol && col <= 13; ++q) {
            if (q == eol || *q == '\t') {
                switch (col) {
                    case 1: fb[0] = fs; fe[0] = q; break;
                    case 6: fb[1] = fs; fe[1] = q; break;
                    case 8: fb[2] = fs; fe[2] = q; break;
                    case 13: fb[3] = fs; fe[3] = q; break;
                    default: break;
                }
                ++col;
                fs = q + 1;
            }
        }
        p = nl ? nl + 1 : end;
        if (!fb[3]) continue;  // short row: no column 13
        const int a = lookup(fb[0], fe[0]);
        const int b = lookup(fb[2], fe[2]);
        if (a < 0 || b < 0) continue;
        int64_t v1, v2;
        if (!num(fb[1], fe[1], &v1) || !num(fb[3], fe[3], &v2)) continue;
        c1[out] = a;
        p1[out] = v1;
        c2[out] = b;
        p2[out] = v2;
        ++out;
    }
    return out;
}

// Parse a block of allelic-bed text (complete lines): tab-separated
// columns 0-3 = chrom1, pos1, chrom2, pos2, optional column 4 = side tag
// ("Both"/"R1"/"R2" → 0/1/2, anything else → -1) — the five-class
// haplotype ingestion format (HiCHap/matrixBuilding.py:1081-1094).  Same
// chromosome rule as the valid-bed scanner ("chr" prefix stripped,
// verbatim label match, unknown dropped).  Returns kept rows.
long hicio_parse_allelic_chunk(const char* buf, long nbytes,
                               const char* const* labels, int n_labels,
                               int with_tag,
                               int32_t* c1, int64_t* p1,
                               int32_t* c2, int64_t* p2, int8_t* tag) {
    std::vector<size_t> llen(n_labels);
    for (int i = 0; i < n_labels; ++i) llen[i] = std::strlen(labels[i]);
    auto lookup = [&](const char* b, const char* e) -> int {
        if (e - b >= 3 && b[0] == 'c' && b[1] == 'h' && b[2] == 'r') b += 3;
        const size_t n = static_cast<size_t>(e - b);
        for (int i = 0; i < n_labels; ++i)
            if (llen[i] == n && std::memcmp(labels[i], b, n) == 0) return i;
        return -1;
    };
    auto num = [](const char* b, const char* e, int64_t* out) -> bool {
        if (b == e || e - b > 18) return false;  // >18 digits: overflow
        const bool neg = (*b == '-');
        if (neg && ++b == e) return false;
        int64_t v = 0;
        for (; b < e; ++b) {
            if (*b < '0' || *b > '9') return false;
            v = v * 10 + (*b - '0');
        }
        *out = neg ? -v : v;
        return true;
    };
    const int want = with_tag ? 5 : 4;  // tag column optional: see below
    long out = 0;
    const char* p = buf;
    const char* const end = buf + nbytes;
    while (p < end) {
        const char* nl =
            static_cast<const char*>(std::memchr(p, '\n', end - p));
        const char* eol = nl ? nl : end;
        if (eol > p && eol[-1] == '\r') --eol;  // CRLF beds
        const char* fb[5];
        const char* fe[5];
        int col = 0;
        const char* fs = p;
        for (const char* q = p; q <= eol && col < want; ++q) {
            if (q == eol || *q == '\t') {
                fb[col] = fs;
                fe[col] = q;
                ++col;
                fs = q + 1;
            }
        }
        p = nl ? nl + 1 : end;
        if (col < 4) continue;  // short row
        const int a = lookup(fb[0], fe[0]);
        const int b = lookup(fb[2], fe[2]);
        if (a < 0 || b < 0) continue;
        int64_t v1, v2;
        if (!num(fb[1], fe[1], &v1) || !num(fb[3], fe[3], &v2)) continue;
        if (with_tag) {
            // rows without a tag column keep -1 (the Python fallback's
            // unmapped-tag code)
            int8_t t = -1;
            if (col == 5) {
                const size_t tl = static_cast<size_t>(fe[4] - fb[4]);
                if (tl == 4 && std::memcmp(fb[4], "Both", 4) == 0) t = 0;
                else if (tl == 2 && fb[4][0] == 'R' && fb[4][1] == '1') t = 1;
                else if (tl == 2 && fb[4][0] == 'R' && fb[4][1] == '2') t = 2;
            }
            tag[out] = t;
        }
        c1[out] = a;
        p1[out] = v1;
        c2[out] = b;
        p2[out] = v2;
        ++out;
    }
    return out;
}

int hicio_merge_sorted(const char** paths, int n, const char* out_path,
                       int mode) {
    std::vector<std::ifstream> streams;
    for (int i = 0; i < n; ++i) streams.emplace_back(paths[i]);
    std::ofstream out(out_path);
    if (!out) return 1;

    struct Head {
        std::string line;
        size_t idx;
    };
    auto cmp_whole = [](const Head& a, const Head& b) { return a.line > b.line; };
    auto cmp_k6 = [](const Head& a, const Head& b) {
        return less_key6(b.line, a.line);
    };
    auto merge = [&](auto cmp) {
        std::priority_queue<Head, std::vector<Head>, decltype(cmp)> pq(cmp);
        for (size_t i = 0; i < streams.size(); ++i) {
            std::string l;
            if (std::getline(streams[i], l)) pq.push({std::move(l), i});
        }
        while (!pq.empty()) {
            Head h = pq.top();
            pq.pop();
            out << h.line << '\n';
            std::string l;
            if (std::getline(streams[h.idx], l)) pq.push({std::move(l), h.idx});
        }
    };
    if (mode == 0) merge(cmp_whole);
    else merge_streams_k6(streams, out);
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Genome-wide COO accumulator.
//
// The matrix stage streams O(10^8) binned contact keys (lo * S + hi) and
// needs the O(10^7) unique pixels with their counts, sorted, at the end
// (the layout coolers are written in).  The former numpy path sorted each
// 16M-key pending block and merge-inserted it into the sorted-unique
// accumulation — O(n log n) comparisons plus a full reallocating merge
// per block, measured as the dominant wall of the 50M-pair end-to-end
// stream at 10 kb.  This is the O(n) replacement: an open-addressing
// linear-probe hash table (splitmix64 finalizer, load <= 0.5) keyed by
// the int64 pixel key, one fused multiply-add per occurrence, with a
// single sort of the unique survivors at export.  Memory is
// O(unique pixels), same as the numpy path.
namespace {

struct GwAcc {
    std::vector<int64_t> key;  // slot -> pixel key, -1 = empty
    std::vector<double> cnt;
    uint64_t mask = 0;
    int64_t used = 0;

    static uint64_t mix(uint64_t x) {  // splitmix64 finalizer
        x += 0x9e3779b97f4a7c15ull;
        x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
        x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
        return x ^ (x >> 31);
    }

    bool init(size_t cap) {
        key.assign(cap, -1);
        cnt.assign(cap, 0.0);
        mask = cap - 1;
        used = 0;
        return true;
    }

    bool grow() {
        // allocate the bigger table FIRST: if this throws, the current
        // table is untouched and the accumulator stays fully usable
        // (the hicio_gwacc_add contract on allocation failure)
        const uint64_t ocap = mask + 1;
        const uint64_t ncap = ocap * 2;
        std::vector<int64_t> nk(ncap, -1);
        std::vector<double> nc(ncap, 0.0);
        const uint64_t nmask = ncap - 1;
        for (uint64_t i = 0; i < ocap; ++i) {
            if (key[i] < 0) continue;
            uint64_t j = mix(static_cast<uint64_t>(key[i])) & nmask;
            while (nk[j] >= 0) j = (j + 1) & nmask;
            nk[j] = key[i];
            nc[j] = cnt[i];
        }
        key.swap(nk);
        cnt.swap(nc);
        mask = nmask;
        return true;
    }

    inline void add1(int64_t k, double w) {
        uint64_t i = mix(static_cast<uint64_t>(k)) & mask;
        for (;;) {
            const int64_t cur = key[i];
            if (cur == k) {
                cnt[i] += w;
                return;
            }
            if (cur < 0) {
                key[i] = k;
                cnt[i] = w;
                ++used;
                return;
            }
            i = (i + 1) & mask;
        }
    }
};

// LSD radix sort of (key, count) pairs by key, 16-bit digits — ~3 passes
// for genome-wide pixel keys (< S^2 ≈ 2^39 at diploid hg19 10 kb) vs
// log2(33M) ≈ 25 comparison levels for std::sort; measured ~3x faster at
// the 30M-pixel export.
static void radix_sort_pairs(std::vector<std::pair<int64_t, double>>& a) {
    if (a.size() < (1u << 15)) {
        std::sort(a.begin(), a.end(),
                  [](const std::pair<int64_t, double>& x,
                     const std::pair<int64_t, double>& y) {
                      return x.first < y.first;
                  });
        return;
    }
    int64_t mx = 0;
    for (const auto& p : a) mx = std::max(mx, p.first);
    std::vector<std::pair<int64_t, double>> b(a.size());
    std::vector<size_t> hist(1 << 16);
    int shift = 0;
    while ((mx >> shift) != 0) {
        std::fill(hist.begin(), hist.end(), 0);
        for (const auto& p : a)
            ++hist[(static_cast<uint64_t>(p.first) >> shift) & 0xFFFF];
        size_t run = 0;
        for (auto& h : hist) {
            const size_t c = h;
            h = run;
            run += c;
        }
        for (const auto& p : a)
            b[hist[(static_cast<uint64_t>(p.first) >> shift) & 0xFFFF]++] = p;
        a.swap(b);
        shift += 16;
    }
}

}  // namespace

extern "C" {

void* hicio_gwacc_new(void) {
    auto* a = new (std::nothrow) GwAcc();
    if (a == nullptr) return nullptr;
    try {
        a->init(1 << 16);
    } catch (...) {
        delete a;
        return nullptr;
    }
    return a;
}

// Accumulate n keys; weights w may be NULL (each occurrence counts 1.0).
// Negative keys are skipped (callers bound-filter, this is a backstop).
// Returns 0; 1 on allocation failure (the accumulator stays usable with
// whatever was inserted before the failure).
int hicio_gwacc_add(void* h, const int64_t* keys, const double* w,
                    int64_t n) {
    auto* a = static_cast<GwAcc*>(h);
    for (int64_t i = 0; i < n; ++i) {
        if (keys[i] < 0) continue;
        if (static_cast<uint64_t>(a->used) * 2 > a->mask) {
            try {
                if (!a->grow()) return 1;
            } catch (...) {
                return 1;
            }
        }
        a->add1(keys[i], w ? w[i] : 1.0);
    }
    return 0;
}

int64_t hicio_gwacc_size(void* h) {
    return static_cast<GwAcc*>(h)->used;
}

double hicio_gwacc_total(void* h) {
    auto* a = static_cast<GwAcc*>(h);
    double t = 0.0;
    const uint64_t cap = a->mask + 1;
    for (uint64_t i = 0; i < cap; ++i)
        if (a->key[i] >= 0) t += a->cnt[i];
    return t;
}

// Write the unique (key, count) pairs sorted ascending by key into
// caller-allocated arrays of hicio_gwacc_size() elements.  Non-destructive.
int hicio_gwacc_export(void* h, int64_t* keys_out, double* cnts_out) {
    auto* a = static_cast<GwAcc*>(h);
    const uint64_t cap = a->mask + 1;
    std::vector<std::pair<int64_t, double>> items;
    try {
        items.reserve(static_cast<size_t>(a->used));
        for (uint64_t i = 0; i < cap; ++i)
            if (a->key[i] >= 0) items.emplace_back(a->key[i], a->cnt[i]);
        radix_sort_pairs(items);
    } catch (...) {
        return 1;
    }
    for (size_t i = 0; i < items.size(); ++i) {
        keys_out[i] = items[i].first;
        cnts_out[i] = items[i].second;
    }
    return 0;
}

// Sorted export straight to COO: rows = key / S, cols = key %% S computed
// in the same pass (the Python-side divmod over tens of millions of int64
// was a measured multi-second wall of coo()).  Non-destructive.
int hicio_gwacc_export_coo(void* h, int64_t S, int64_t* rows_out,
                           int64_t* cols_out, double* cnts_out) {
    auto* a = static_cast<GwAcc*>(h);
    if (S <= 0) return 1;
    const uint64_t cap = a->mask + 1;
    std::vector<std::pair<int64_t, double>> items;
    try {
        items.reserve(static_cast<size_t>(a->used));
        for (uint64_t i = 0; i < cap; ++i)
            if (a->key[i] >= 0) items.emplace_back(a->key[i], a->cnt[i]);
        radix_sort_pairs(items);
    } catch (...) {
        return 1;
    }
    for (size_t i = 0; i < items.size(); ++i) {
        rows_out[i] = items[i].first / S;
        cols_out[i] = items[i].first % S;
        cnts_out[i] = items[i].second;
    }
    return 0;
}

void hicio_gwacc_free(void* h) {
    delete static_cast<GwAcc*>(h);
}

// In-place radix sort of parallel (key, value) arrays by NON-NEGATIVE
// int64 key — the SparseU build sorts ~2x nnz symmetric pixels and
// numpy's lexsort was a measured multi-ten-second wall there.
int hicio_radix_sort_kv(int64_t* keys, double* vals, int64_t n) {
    try {
        std::vector<std::pair<int64_t, double>> a(
            static_cast<size_t>(n < 0 ? 0 : n));
        for (int64_t i = 0; i < n; ++i) a[i] = {keys[i], vals[i]};
        radix_sort_pairs(a);
        for (int64_t i = 0; i < n; ++i) {
            keys[i] = a[i].first;
            vals[i] = a[i].second;
        }
    } catch (...) {
        return 1;
    }
    return 0;
}

}  // extern "C"

// ------------------------------------------------------------------ abed
// Columnizer for the 15/23-column allelic valid beds consumed by
// aFiltering (HiCHap/filtering.py:989-1291): one native pass turns the
// tab text into typed columns — read names as fixed-width bytes, chrom
// fields as small-int codes into a per-file label table, numeric fields
// as int64, the candidate tag as 0/1/2 (none/R1/R2).  A typed parse in
// Python spends its wall constructing millions of str objects; this one
// does not, and the assignment then runs on memcmp/int compares.
//
// Strictness: every row must have exactly 15 or 23 tab-separated fields
// with integer columns 3,5,6,7,10,12,13,14 (+17,19,20,21 and an R1/R2
// column 22 on candidate rows); anything else fails the whole parse
// (rows() returns -1) and the caller falls back to the ragged-tolerant
// Python reader.

namespace {

struct ABed {
    std::string buf;                 // whole file (name spans point here)
    long rows = -1;                  // -1: parse failed
    int name_w = 1;
    std::vector<std::string> labels;
    std::vector<const char*> name_b;
    std::vector<uint32_t> name_n;
    std::vector<int32_t> c1, c8, c15;
    std::vector<int64_t> i3, i5, i6, i7, i10, i12, i13, i14;
    std::vector<int64_t> i17, i19, i20, i21;
    std::vector<uint8_t> tag;
};

static bool abed_num(const char* b, const char* e, int64_t* out) {
    if (b == e || e - b > 18) return false;
    const bool neg = (*b == '-');
    if (neg && ++b == e) return false;
    int64_t v = 0;
    for (; b < e; ++b) {
        if (*b < '0' || *b > '9') return false;
        v = v * 10 + (*b - '0');
    }
    *out = neg ? -v : v;
    return true;
}

static int abed_label(ABed* a, const char* b, const char* e) {
    const size_t n = static_cast<size_t>(e - b);
    for (size_t i = 0; i < a->labels.size(); ++i)
        if (a->labels[i].size() == n &&
            std::memcmp(a->labels[i].data(), b, n) == 0)
            return static_cast<int>(i);
    a->labels.emplace_back(b, n);
    return static_cast<int>(a->labels.size() - 1);
}

static bool abed_parse(ABed* a) {
    const char* p = a->buf.data();
    const char* const end = p + a->buf.size();
    while (p < end) {
        const char* nl =
            static_cast<const char*>(std::memchr(p, '\n', end - p));
        const char* eol = nl ? nl : end;
        if (eol > p && eol[-1] == '\r') --eol;
        if (eol == p) {  // blank line: only legal as the trailing newline
            p = nl ? nl + 1 : end;
            if (p >= end) break;
            return false;
        }
        const char* fb[24];
        const char* fe[24];
        int col = 0;
        const char* fs = p;
        for (const char* q = p; q <= eol; ++q) {
            if (q == eol || *q == '\t') {
                if (col >= 24) return false;
                fb[col] = fs;
                fe[col] = q;
                ++col;
                fs = q + 1;
            }
        }
        p = nl ? nl + 1 : end;
        if (col != 15 && col != 23) return false;
        int64_t v[8];
        static const int icols[8] = {3, 5, 6, 7, 10, 12, 13, 14};
        for (int k = 0; k < 8; ++k)
            if (!abed_num(fb[icols[k]], fe[icols[k]], &v[k])) return false;
        const uint32_t nn = static_cast<uint32_t>(fe[0] - fb[0]);
        if (static_cast<int>(nn) > a->name_w) a->name_w = nn;
        a->name_b.push_back(fb[0]);
        a->name_n.push_back(nn);
        a->c1.push_back(abed_label(a, fb[1], fe[1]));
        a->c8.push_back(abed_label(a, fb[8], fe[8]));
        a->i3.push_back(v[0]);
        a->i5.push_back(v[1]);
        a->i6.push_back(v[2]);
        a->i7.push_back(v[3]);
        a->i10.push_back(v[4]);
        a->i12.push_back(v[5]);
        a->i13.push_back(v[6]);
        a->i14.push_back(v[7]);
        if (col == 23) {
            int64_t w[4];
            static const int ccols[4] = {17, 19, 20, 21};
            for (int k = 0; k < 4; ++k)
                if (!abed_num(fb[ccols[k]], fe[ccols[k]], &w[k]))
                    return false;
            const size_t tn = static_cast<size_t>(fe[22] - fb[22]);
            uint8_t t;
            if (tn == 2 && fb[22][0] == 'R' && fb[22][1] == '1')
                t = 1;
            else if (tn == 2 && fb[22][0] == 'R' && fb[22][1] == '2')
                t = 2;
            else
                return false;
            a->c15.push_back(abed_label(a, fb[15], fe[15]));
            a->i17.push_back(w[0]);
            a->i19.push_back(w[1]);
            a->i20.push_back(w[2]);
            a->i21.push_back(w[3]);
            a->tag.push_back(t);
        } else {
            a->c15.push_back(-1);
            a->i17.push_back(0);
            a->i19.push_back(0);
            a->i20.push_back(0);
            a->i21.push_back(0);
            a->tag.push_back(0);
        }
    }
    a->rows = static_cast<long>(a->name_b.size());
    return true;
}

}  // namespace

extern "C" {

void* hicio_abed_open(const char* path) {
    ABed* a = new (std::nothrow) ABed;
    if (!a) return nullptr;
    try {
        std::ifstream in(path, std::ios::binary);
        if (!in) {
            delete a;
            return nullptr;
        }
        in.seekg(0, std::ios::end);
        const std::streamoff sz = in.tellg();
        in.seekg(0);
        a->buf.resize(static_cast<size_t>(sz < 0 ? 0 : sz));
        if (sz > 0) in.read(&a->buf[0], sz);
        if (!abed_parse(a)) a->rows = -1;
    } catch (...) {
        a->rows = -1;
    }
    return a;
}

long hicio_abed_rows(void* h) { return static_cast<ABed*>(h)->rows; }

int hicio_abed_name_width(void* h) {
    return static_cast<ABed*>(h)->name_w;
}

int hicio_abed_n_labels(void* h) {
    return static_cast<int>(static_cast<ABed*>(h)->labels.size());
}

int hicio_abed_label_bytes(void* h) {
    int n = 0;
    for (const auto& s : static_cast<ABed*>(h)->labels)
        n += static_cast<int>(s.size()) + 1;
    return n;
}

// NUL-joined label table (label_bytes() bytes).
int hicio_abed_labels(void* h, char* out) {
    for (const auto& s : static_cast<ABed*>(h)->labels) {
        std::memcpy(out, s.data(), s.size());
        out += s.size();
        *out++ = '\0';
    }
    return 0;
}

// Fill caller-allocated arrays (rows() elements each; names is
// rows()*name_width() bytes, NUL-padded).
int hicio_abed_export(void* h, char* names, int32_t* c1, int32_t* c8,
                      int32_t* c15, int64_t* i3, int64_t* i5, int64_t* i6,
                      int64_t* i7, int64_t* i10, int64_t* i12, int64_t* i13,
                      int64_t* i14, int64_t* i17, int64_t* i19, int64_t* i20,
                      int64_t* i21, uint8_t* tag) {
    ABed* a = static_cast<ABed*>(h);
    if (a->rows < 0) return 1;
    const size_t n = static_cast<size_t>(a->rows);
    const size_t w = static_cast<size_t>(a->name_w);
    std::memset(names, 0, n * w);
    for (size_t i = 0; i < n; ++i)
        std::memcpy(names + i * w, a->name_b[i], a->name_n[i]);
    std::memcpy(c1, a->c1.data(), n * sizeof(int32_t));
    std::memcpy(c8, a->c8.data(), n * sizeof(int32_t));
    std::memcpy(c15, a->c15.data(), n * sizeof(int32_t));
    std::memcpy(i3, a->i3.data(), n * sizeof(int64_t));
    std::memcpy(i5, a->i5.data(), n * sizeof(int64_t));
    std::memcpy(i6, a->i6.data(), n * sizeof(int64_t));
    std::memcpy(i7, a->i7.data(), n * sizeof(int64_t));
    std::memcpy(i10, a->i10.data(), n * sizeof(int64_t));
    std::memcpy(i12, a->i12.data(), n * sizeof(int64_t));
    std::memcpy(i13, a->i13.data(), n * sizeof(int64_t));
    std::memcpy(i14, a->i14.data(), n * sizeof(int64_t));
    std::memcpy(i17, a->i17.data(), n * sizeof(int64_t));
    std::memcpy(i19, a->i19.data(), n * sizeof(int64_t));
    std::memcpy(i20, a->i20.data(), n * sizeof(int64_t));
    std::memcpy(i21, a->i21.data(), n * sizeof(int64_t));
    std::memcpy(tag, a->tag.data(), n * sizeof(uint8_t));
    return 0;
}

void hicio_abed_free(void* h) { delete static_cast<ABed*>(h); }

}  // extern "C"
