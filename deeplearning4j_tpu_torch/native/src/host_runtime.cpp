// Native host runtime for deeplearning4j_tpu_torch.
//
// The device math runs on the GPU, so the native seam sits on the
// HOST-bound hot paths that feed it: corpus tokenization/counting for
// vocab builds, skip-gram pair generation and GloVe's co-occurrence
// counts (the per-token Python loops dominate word2vec wall-clock
// otherwise), and the svmlight and CSV parsers.  Exposed as a C ABI for
// ctypes (``native/runtime.py``); the results are byte for byte those of
// the JAX package's copy of this file.
//
// Build: python -m deeplearning4j_tpu_torch.native.build   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- tokenizer
// Tokenize text (sentences separated by '\n'), lowercasing and stripping
// non-alphanumeric bytes (ASCII fast path; multi-byte UTF-8 kept verbatim).
// Returns a malloc'd buffer "word\tcount\n..." and its length; caller frees
// via drt_free.
char* drt_count_tokens(const char* text, int64_t len, int64_t* out_len) {
    std::unordered_map<std::string, int64_t> counts;
    std::string cur;
    cur.reserve(32);
    for (int64_t i = 0; i <= len; ++i) {
        unsigned char c = (i < len) ? static_cast<unsigned char>(text[i]) : ' ';
        bool is_space = (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                         c == '\v' || c == '\f');  // match Python \S+
        if (is_space) {
            if (!cur.empty()) {
                ++counts[cur];
                cur.clear();
            }
            continue;
        }
        // ASCII-only fast path (the ctypes binding routes any non-ASCII
        // corpus to the Python tokenizer so semantics never diverge):
        // keep [A-Za-z0-9_] lowercased — exactly Python's \w for ASCII.
        if (std::isalnum(c) || c == '_') {
            cur.push_back(static_cast<char>(std::tolower(c)));
        }
        // punctuation stripped
    }
    std::string out;
    out.reserve(counts.size() * 16);
    for (const auto& kv : counts) {
        out += kv.first;
        out += '\t';
        out += std::to_string(kv.second);
        out += '\n';
    }
    char* buf = static_cast<char*>(std::malloc(out.size()));
    std::memcpy(buf, out.data(), out.size());
    *out_len = static_cast<int64_t>(out.size());
    return buf;
}

void drt_free(void* p) { std::free(p); }

// ---------------------------------------------------------------- skipgram
// Generate skip-gram (center, context) pairs with per-position random
// window shrink (word2vec's `b = rand % window`).
// tokens: concatenated sentence word-indices; offsets: sentence starts
// (n_sentences+1 entries).  Returns number of pairs written; call first with
// centers=nullptr to get the required capacity.
int64_t drt_skipgram_pairs(const int32_t* tokens, const int64_t* offsets,
                           int64_t n_sentences, int32_t window, uint64_t seed,
                           int32_t* centers, int32_t* contexts,
                           int64_t capacity) {
    uint64_t state = seed ? seed : 0x9E3779B97F4A7C15ull;
    auto next_rand = [&state]() {
        state ^= state << 13;
        state ^= state >> 7;
        state ^= state << 17;
        return state;
    };
    int64_t n = 0;
    for (int64_t s = 0; s < n_sentences; ++s) {
        int64_t lo = offsets[s], hi = offsets[s + 1];
        int64_t len = hi - lo;
        for (int64_t pos = 0; pos < len; ++pos) {
            int32_t b = window > 0 ? static_cast<int32_t>(next_rand() % window) : 0;
            int32_t w = window - b;
            int64_t jlo = pos - w < 0 ? 0 : pos - w;
            int64_t jhi = pos + w + 1 > len ? len : pos + w + 1;
            for (int64_t j = jlo; j < jhi; ++j) {
                if (j == pos) continue;
                if (centers != nullptr) {
                    if (n >= capacity) return -1;  // caller under-allocated
                    centers[n] = tokens[lo + pos];
                    contexts[n] = tokens[lo + j];
                }
                ++n;
            }
        }
    }
    return n;
}

// ---------------------------------------------------------------- glove
// Window-weighted co-occurrence accumulation (GloVe's host-side hot loop:
// increment by 1/distance within the forward window, symmetrized).
// Returns a malloc'd packed buffer: int64 n, then n records of
// (int32 row, int32 col, float val).  Caller frees via drt_free.
char* drt_cooccurrence(const int32_t* tokens, const int64_t* offsets,
                       int64_t n_sentences, int32_t window,
                       int64_t* out_bytes) {
    std::unordered_map<int64_t, float> counts;
    for (int64_t s = 0; s < n_sentences; ++s) {
        int64_t lo = offsets[s], hi = offsets[s + 1];
        int64_t len = hi - lo;
        for (int64_t pos = 0; pos < len; ++pos) {
            int64_t jmax = pos + window + 1 < len ? pos + window + 1 : len;
            int32_t wi = tokens[lo + pos];
            for (int64_t j = pos + 1; j < jmax; ++j) {
                float inc = 1.0f / static_cast<float>(j - pos);
                int32_t wj = tokens[lo + j];
                counts[(static_cast<int64_t>(wi) << 32) |
                       static_cast<uint32_t>(wj)] += inc;
                counts[(static_cast<int64_t>(wj) << 32) |
                       static_cast<uint32_t>(wi)] += inc;
            }
        }
    }
    int64_t n = static_cast<int64_t>(counts.size());
    int64_t bytes = 8 + n * 12;
    char* buf = static_cast<char*>(std::malloc(bytes));
    std::memcpy(buf, &n, 8);
    char* p = buf + 8;
    for (const auto& kv : counts) {
        int32_t row = static_cast<int32_t>(kv.first >> 32);
        int32_t col = static_cast<int32_t>(kv.first & 0xFFFFFFFF);
        std::memcpy(p, &row, 4);
        std::memcpy(p + 4, &col, 4);
        std::memcpy(p + 8, &kv.second, 4);
        p += 12;
    }
    *out_bytes = bytes;
    return buf;
}

// ---------------------------------------------------------------- svmlight
// Parse svmlight text ("<label> <idx>:<val> ... # comment", 1-based indices)
// into dense row-major features + a label vector.  feats must be PRE-ZEROED
// (rows are sparse); text must be NUL-terminated (ctypes c_char_p is).
// Returns rows parsed; -1 on malformed input (caller falls back to the
// Python parser for exact error semantics); -2 when max_rows is too small.
// Indices beyond num_features are skipped and counted into *skipped (the
// Python caller turns that into its out-of-range warning).
int64_t drt_parse_svmlight(const char* text, int64_t len, int32_t nf,
                           float* feats, float* labels, int64_t max_rows,
                           int64_t* skipped) {
    int64_t row = 0;
    *skipped = 0;
    const char* p = text;
    const char* end = text + len;
    while (p < end) {
        const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
        const char* le = nl ? nl : end;
        const char* hash = static_cast<const char*>(std::memchr(p, '#', le - p));
        const char* ce = hash ? hash : le;     // parse stops at the comment
        const char* q = p;
        while (q < ce && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
        if (q >= ce) { p = le + 1; continue; } // blank / comment-only line
        if (row >= max_rows) return -2;
        char* nxt = nullptr;
        float lab = std::strtof(q, &nxt);      // stops at ' ', '#', '\n'
        if (nxt == q || nxt > ce) return -1;   // no leading label
        labels[row] = lab;
        float* frow = feats + row * static_cast<int64_t>(nf);
        q = nxt;
        while (q < ce) {
            while (q < ce && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
            if (q >= ce) break;
            char* c1 = nullptr;
            long idx = std::strtol(q, &c1, 10);
            if (c1 == q || c1 >= ce || *c1 != ':') return -1;
            // value must start right after ':' — strtof skips leading
            // whitespace (incl. '\n'), which would silently consume a
            // number from beyond the token/line; Python raises there
            const char* vs = c1 + 1;
            if (vs >= ce || *vs == ' ' || *vs == '\t' || *vs == '\r' ||
                *vs == '\n') return -1;
            char* c2 = nullptr;
            float v = std::strtof(vs, &c2);
            if (c2 == vs || c2 > ce) return -1;
            if (idx <= 0) return -1;           // svmlight text is 1-based
            if (idx <= nf) frow[idx - 1] = v;
            else ++*skipped;
            q = c2;
        }
        ++row;
        p = le + 1;
    }
    return row;
}

// ---------------------------------------------------------------- csv
// Parse a float CSV buffer into a dense row-major array. Returns rows
// written, or -1 on ragged rows. out must hold max_rows*n_cols floats.
int64_t drt_parse_csv_floats(const char* text, int64_t len, int32_t n_cols,
                             float* out, int64_t max_rows) {
    int64_t row = 0, col = 0;
    const char* p = text;
    const char* end = text + len;
    while (p < end && row < max_rows) {
        char c = *p;
        if (c == '\n') {  // newline handled BEFORE strtof (which would
                          // swallow it as leading whitespace)
            if (col != 0) {
                if (col != n_cols) return -1;
                col = 0;
                ++row;
            }
            ++p;
            continue;
        }
        if (c == ',' || c == ' ' || c == '\t' || c == '\r') {
            ++p;
            continue;
        }
        char* next = nullptr;
        float v = std::strtof(p, &next);
        if (next == p) return -1;  // non-numeric garbage
        if (col >= n_cols) return -1;
        out[row * n_cols + col] = v;
        ++col;
        p = next;
    }
    if (col == n_cols) ++row;
    else if (col != 0) return -1;
    return row;
}

}  // extern "C"
