// Native columnar conversion kernels — the C++ runtime piece of the
// interchange layer (role of the reference's Rust arrow-interop crate,
// record_batch_convert.rs).
//
// Exposed via a C ABI consumed through ctypes (no pybind11 in this image).
// Operates directly on Arrow string-array buffers (offsets + data) so the
// Python layer never loops over rows.
//
// Copy of gpu_olap_tpu/native/fastconv.cpp.
//
// Functions:
//   fnv1a_hash64      — 64-bit FNV-1a of each string (the reference's string
//                       hash, record_batch_convert.rs:123-130, kept for
//                       compatibility paths / hash partitioning)
//   dict_encode_utf8  — dictionary-encode a string column: codes into a
//                       *lexicographically sorted* unique-string dictionary
//                       (sorted dictionaries make code order == string order,
//                       which the device executor relies on)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

// 64-bit FNV-1a over [offsets[i], offsets[i+1]) slices of data.
void fnv1a_hash64(const uint8_t* data, const int64_t* offsets, int64_t n,
                  int64_t* out) {
    constexpr uint64_t kBasis = 14695981039346656037ULL;
    constexpr uint64_t kPrime = 1099511628211ULL;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h = kBasis;
        for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
            h ^= data[j];
            h *= kPrime;
        }
        out[i] = static_cast<int64_t>(h & 0x7FFFFFFFFFFFFFFFULL);
    }
}

// Dictionary-encode n strings given as Arrow offsets+data (+ optional
// validity byte mask, 1 = valid).  Writes int64 codes (0 for nulls).
//
// Two-phase protocol so the caller can allocate exact output buffers:
//   phase 1 (dict_out == null): returns dict count, fills dict_total_bytes.
//   phase 2: fills codes, dict_offsets (dict_n+1) and dict_bytes.
// State is kept in a handle between the phases.
struct DictEncodeState {
    std::vector<std::string_view> uniques_sorted;
    std::vector<int64_t> codes;   // already remapped to sorted order
    int64_t total_bytes = 0;
};

void* dict_encode_utf8_build(const uint8_t* data, const int64_t* offsets,
                             const uint8_t* validity, int64_t n,
                             int64_t* out_dict_n, int64_t* out_dict_bytes) {
    auto* st = new DictEncodeState();
    std::unordered_map<std::string_view, int64_t> index;
    index.reserve(static_cast<size_t>(n) / 4 + 8);
    std::vector<std::string_view> uniques;
    std::vector<int64_t> first_codes(static_cast<size_t>(n));

    for (int64_t i = 0; i < n; ++i) {
        if (validity != nullptr && validity[i] == 0) {
            first_codes[static_cast<size_t>(i)] = 0;
            continue;
        }
        std::string_view sv(reinterpret_cast<const char*>(data + offsets[i]),
                            static_cast<size_t>(offsets[i + 1] - offsets[i]));
        auto [it, inserted] = index.try_emplace(sv, static_cast<int64_t>(uniques.size()));
        if (inserted) uniques.push_back(sv);
        first_codes[static_cast<size_t>(i)] = it->second;
    }
    // empty column / all nulls still needs one dictionary slot for code 0
    if (uniques.empty()) uniques.push_back(std::string_view("", 0));

    // sort dictionary, build old-code -> sorted-code remap
    std::vector<int64_t> order(uniques.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = static_cast<int64_t>(i);
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return uniques[static_cast<size_t>(a)] < uniques[static_cast<size_t>(b)];
    });
    std::vector<int64_t> remap(uniques.size());
    st->uniques_sorted.resize(uniques.size());
    int64_t total = 0;
    for (size_t rank = 0; rank < order.size(); ++rank) {
        remap[static_cast<size_t>(order[rank])] = static_cast<int64_t>(rank);
        st->uniques_sorted[rank] = uniques[static_cast<size_t>(order[rank])];
        total += static_cast<int64_t>(st->uniques_sorted[rank].size());
    }
    st->codes.resize(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        st->codes[static_cast<size_t>(i)] =
            remap[static_cast<size_t>(first_codes[static_cast<size_t>(i)])];
    }
    st->total_bytes = total;
    *out_dict_n = static_cast<int64_t>(st->uniques_sorted.size());
    *out_dict_bytes = total;
    return st;
}

void dict_encode_utf8_finish(void* handle, int64_t* codes_out,
                             int64_t* dict_offsets_out, uint8_t* dict_bytes_out) {
    auto* st = static_cast<DictEncodeState*>(handle);
    std::memcpy(codes_out, st->codes.data(), st->codes.size() * sizeof(int64_t));
    int64_t off = 0;
    for (size_t i = 0; i < st->uniques_sorted.size(); ++i) {
        dict_offsets_out[i] = off;
        const auto& sv = st->uniques_sorted[i];
        std::memcpy(dict_bytes_out + off, sv.data(), sv.size());
        off += static_cast<int64_t>(sv.size());
    }
    dict_offsets_out[st->uniques_sorted.size()] = off;
    delete st;
}

// Validity bitmap (Arrow packed bits) -> byte mask.
void unpack_bitmap(const uint8_t* bits, int64_t bit_offset, int64_t n,
                   uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t b = bit_offset + i;
        out[i] = (bits[b >> 3] >> (b & 7)) & 1;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Zone-map statistics (catalog.rs has no statistics at all; ours drive the
// int32-narrowing / direct-address / lookup-join kernel selection, so the
// registration-time scan over every int column is a host hot loop).
// ---------------------------------------------------------------------------

#include <thread>

namespace {

void minmax_range(const int64_t* data, int64_t lo, int64_t hi,
                  int64_t* out_min, int64_t* out_max) {
    int64_t mn = data[lo], mx = data[lo];
    for (int64_t i = lo + 1; i < hi; ++i) {
        int64_t v = data[i];
        if (v < mn) mn = v;
        if (v > mx) mx = v;
    }
    *out_min = mn;
    *out_max = mx;
}

}  // namespace

extern "C" {

// Parallel min/max of an int64 column (no validity; caller pre-filters or
// accepts sentinel contamination like the numpy path would).
void int64_minmax(const int64_t* data, int64_t n, int64_t* out_min,
                  int64_t* out_max) {
    if (n <= 0) return;
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthreads = static_cast<int64_t>(hw == 0 ? 4 : hw);
    if (nthreads > n / (1 << 20)) nthreads = n / (1 << 20);
    if (nthreads < 1) nthreads = 1;
    std::vector<int64_t> mins(static_cast<size_t>(nthreads));
    std::vector<int64_t> maxs(static_cast<size_t>(nthreads));
    std::vector<std::thread> ts;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
        ts.emplace_back(minmax_range, data, lo, hi,
                        &mins[static_cast<size_t>(t)],
                        &maxs[static_cast<size_t>(t)]);
    }
    for (auto& th : ts) th.join();
    int64_t mn = mins[0], mx = maxs[0];
    for (int64_t t = 1; t < nthreads; ++t) {
        if (mins[static_cast<size_t>(t)] < mn) mn = mins[static_cast<size_t>(t)];
        if (maxs[static_cast<size_t>(t)] > mx) mx = maxs[static_cast<size_t>(t)];
    }
    *out_min = mn;
    *out_max = mx;
}

// Uniqueness of an int64 column with a known [lo, hi] range, via a bitmap
// with duplicate early-exit — O(n) against np.unique's O(n log n) sort.
// Returns 1 = unique, 0 = duplicate found, -1 = span too large for a bitmap.
int int64_unique_bounded(const int64_t* data, int64_t n, int64_t lo,
                         int64_t hi) {
    if (n <= 0) return 1;
    // span is bounded by the caller's direct_join_max_range check, but be
    // defensive: cap the bitmap at 512 MB of bits.
    unsigned __int128 span128 =
        static_cast<unsigned __int128>(hi) - static_cast<unsigned __int128>(lo) + 1;
    if (span128 > (static_cast<unsigned __int128>(1) << 32)) return -1;
    int64_t span = static_cast<int64_t>(span128);
    if (n > span) return 0;  // pigeonhole
    std::vector<uint64_t> bits(static_cast<size_t>((span + 63) / 64), 0);
    for (int64_t i = 0; i < n; ++i) {
        int64_t rel = data[i] - lo;
        if (rel < 0 || rel >= span) return 0;  // outside claimed range
        uint64_t& w = bits[static_cast<size_t>(rel >> 6)];
        uint64_t m = 1ULL << (rel & 63);
        if (w & m) return 0;
        w |= m;
    }
    return 1;
}

}  // extern "C"
