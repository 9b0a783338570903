// Native WordPiece tokenizer: the text front-end of the BERT pipeline.
//
// The reference has no text processing at all (flat feature vectors only —
// SURVEY.md §5 "Long-context"); this supplies the missing front-end for the
// transformer families: basic tokenization (lowercase, punctuation split)
// followed by greedy longest-match WordPiece with "##" continuations, the
// standard BERT scheme. Runs GIL-free on executor threads via ctypes
// (sparkflow_tpu/utils/text.py binds it; a pure-python fallback mirrors the
// semantics bit-for-bit when no C++ toolchain is available).
//
// C API (all extern "C", plain buffers):
//   sft_create(vocab_blob, blob_len, n)   vocab: n '\n'-joined tokens; the
//                                         index in the blob IS the token id
//   sft_encode(t, text, out_ids, out_mask, max_len, unk_id, pad_id)
//                                         -> number of real tokens written
//   sft_destroy(t)

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct SfTokenizer {
    std::unordered_map<std::string, int32_t> vocab;
    size_t max_token_len = 1;
};

inline bool is_punct(unsigned char c) {
    return std::ispunct(c) != 0;
}

// basic tokenize: lowercase, split on whitespace, punctuation becomes its
// own token (BERT BasicTokenizer semantics, ASCII scope)
void basic_split(const char* text, std::vector<std::string>* out) {
    std::string cur;
    for (const unsigned char* p = (const unsigned char*)text; *p; ++p) {
        unsigned char c = *p;
        if (std::isspace(c)) {
            if (!cur.empty()) { out->push_back(cur); cur.clear(); }
        } else if (is_punct(c)) {
            if (!cur.empty()) { out->push_back(cur); cur.clear(); }
            out->push_back(std::string(1, (char)std::tolower(c)));
        } else {
            cur.push_back((char)std::tolower(c));
        }
    }
    if (!cur.empty()) out->push_back(cur);
}

}  // namespace

extern "C" {

SfTokenizer* sft_create(const char* vocab_blob, int64_t blob_len, int64_t n) {
    auto* t = new SfTokenizer();
    t->vocab.reserve((size_t)n * 2);
    int32_t id = 0;
    const char* start = vocab_blob;
    const char* end = vocab_blob + blob_len;
    for (const char* p = vocab_blob; p <= end; ++p) {
        if (p == end || *p == '\n') {
            if (p > start) {
                std::string tok(start, (size_t)(p - start));
                t->vocab.emplace(tok, id);
                if (tok.size() > t->max_token_len)
                    t->max_token_len = tok.size();
            }
            ++id;
            start = p + 1;
        }
    }
    return t;
}

// Greedy longest-match WordPiece on one text. Writes up to max_len ids
// (pad_id beyond the real tokens, mask 1.0/0.0) and returns the real count.
int64_t sft_encode(SfTokenizer* t, const char* text, int32_t* out_ids,
                   float* out_mask, int64_t max_len, int32_t unk_id,
                   int32_t pad_id) {
    std::vector<std::string> words;
    basic_split(text, &words);

    int64_t w = 0;
    for (const std::string& word : words) {
        if (w >= max_len) break;
        size_t pos = 0;
        std::vector<int32_t> pieces;
        bool bad = false;
        while (pos < word.size()) {
            size_t try_len = word.size() - pos;
            if (try_len > t->max_token_len) try_len = t->max_token_len;
            int32_t found = -1;
            size_t found_len = 0;
            for (size_t L = try_len; L >= 1; --L) {
                std::string cand = (pos == 0 ? "" : "##")
                                   + word.substr(pos, L);
                auto it = t->vocab.find(cand);
                if (it != t->vocab.end()) {
                    found = it->second;
                    found_len = L;
                    break;
                }
            }
            if (found < 0) { bad = true; break; }
            pieces.push_back(found);
            pos += found_len;
        }
        if (bad) {
            out_ids[w] = unk_id;
            out_mask[w] = 1.0f;
            ++w;
        } else {
            for (int32_t p : pieces) {
                if (w >= max_len) break;
                out_ids[w] = p;
                out_mask[w] = 1.0f;
                ++w;
            }
        }
    }
    for (int64_t i = w; i < max_len; ++i) {
        out_ids[i] = pad_id;
        out_mask[i] = 0.0f;
    }
    return w;
}

// Whole-batch entry point: texts arrive as one '\n'-joined blob (texts must
// not contain '\n'; the python binding strips them) and rows write straight
// into the caller's [n, max_len] buffers — ONE ctypes crossing per batch.
int64_t sft_encode_batch(SfTokenizer* t, const char* blob, int64_t blob_len,
                         int64_t n, int32_t* out_ids, float* out_mask,
                         int64_t max_len, int32_t unk_id, int32_t pad_id) {
    int64_t row = 0;
    const char* start = blob;
    const char* end = blob + blob_len;
    std::string tmp;
    for (const char* p = blob; p <= end && row < n; ++p) {
        if (p == end || *p == '\n') {
            tmp.assign(start, (size_t)(p - start));
            sft_encode(t, tmp.c_str(), out_ids + row * max_len,
                       out_mask + row * max_len, max_len, unk_id, pad_id);
            ++row;
            start = p + 1;
        }
    }
    return row;
}

void sft_destroy(SfTokenizer* t) { delete t; }

}  // extern "C"
