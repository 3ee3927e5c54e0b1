// Native tokenizer + vocab counter + corpus encoder for the NLP pipeline
// (the port's copy of deeplearning4j_tpu/native/fastvocab.cpp, unchanged in
// what it computes).
//
// One pass over the host-side corpus: tokenize (whitespace, optional
// CommonPreprocessor), count, filter by min frequency, sort by (-freq, word)
// EXACTLY like `nlp/vocab.py::VocabCache.finalize_vocab` (byte-wise UTF-8
// comparison equals Python's code-point string order), and encode every
// sentence as int32 vocab indices with OOV tokens skipped.
// deeplearning4j_tpu_torch/native/__init__.py builds this file with g++ at
// first use into build/native/ and loads it with ctypes (no pybind11).
//
// Exactness contract with the Python fallback (enforced by the wrapper's
// guards + tests): identical vocab order, counts, and encoded id streams,
// or the fast path is refused (vocab_build returns -2):
// - mode 1 (CommonPreprocessor) requires ASCII input — Python lower() is
//   unicode-aware, bytewise tolower is not;
// - strict_ascii additionally rejects non-ASCII in mode 0 for RAW text
//   (Python str.split also splits on unicode whitespace);
// - the wrapper cross-checks sentence/token counts to catch tokens that
//   contain separator bytes.
//
// Protocol (ctypes, handle-based like nothing else here needs to be —
// the dump/encode buffers are sized from vocab_stats):
//   h = vocab_build(buf, len, mode, strict_ascii, min_freq)
//   vocab_stats(h, &n_words, &words_bytes, &n_seqs, &n_idx, &n_raw)
//   vocab_dump(h, words_buf, counts)       // '\n'-joined words, doubles
//   vocab_encode(h, idx_out, seq_offsets)  // int32 ids + int64[n_seqs+1]
//   vocab_free(h)

#include <algorithm>
#include <cctype>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct VocabState {
    std::vector<std::string> words;     // vocab words in final index order
    std::vector<double> counts;         // parallel to words
    std::vector<int> ids;               // encoded corpus (OOV dropped)
    std::vector<long long> seq_off;     // n_seqs + 1 offsets into ids
    long n_raw_tokens = 0;              // tokens seen before OOV filtering
    long words_bytes = 0;               // sum(len(w) + 1) for the dump
};

std::mutex g_mu;
std::unordered_map<long, VocabState*> g_states;
long g_next = 1;

inline bool is_space(unsigned char c) {
    // Python str.split()'s ASCII whitespace set minus '\n' (the sentence
    // separator): \t \v \f \r space and the file/group/record/unit
    // separators \x1c-\x1f ('a\x1cb'.split() == ['a', 'b']).
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f' ||
           (c >= 0x1c && c <= 0x1f);
}

inline bool strip_char(unsigned char c) {
    // CommonPreprocessor's strip set: [\d\.:,"'\(\)\[\]|/?!;]
    return (c >= '0' && c <= '9') || c == '.' || c == ':' || c == ',' ||
           c == '"' || c == '\'' || c == '(' || c == ')' || c == '[' ||
           c == ']' || c == '|' || c == '/' || c == '?' || c == '!' ||
           c == ';';
}

}  // namespace

extern "C" {

long vocab_build(const char* buf, long len, int mode, int strict_ascii,
                 double min_freq) {
    if (!buf || len < 0) return -1;
    if (mode == 1 || strict_ascii) {
        for (long i = 0; i < len; ++i)
            if (static_cast<unsigned char>(buf[i]) >= 0x80) return -2;
    }

    // Pass 1: tokenize + count; record each sentence as first-seen ids.
    std::unordered_map<std::string, long> seen;  // word -> first-seen id
    std::vector<double> freq;                    // by first-seen id
    std::vector<std::vector<int>> sent_tokens;   // first-seen ids per line
    sent_tokens.emplace_back();
    std::string tok;
    long n_raw = 0;

    auto flush_token = [&]() {
        if (tok.empty()) return;
        std::string t;
        if (mode == 1) {
            t.reserve(tok.size());
            for (unsigned char c : tok)
                if (!strip_char(c))
                    t.push_back(static_cast<char>(std::tolower(c)));
        } else {
            t = tok;
        }
        tok.clear();
        ++n_raw;
        if (t.empty()) return;  // preprocessor stripped it entirely
        auto it = seen.find(t);
        long id;
        if (it == seen.end()) {
            id = static_cast<long>(freq.size());
            seen.emplace(std::move(t), id);
            freq.push_back(0.0);
        } else {
            id = it->second;
        }
        freq[id] += 1.0;
        sent_tokens.back().push_back(static_cast<int>(id));
    };

    for (long i = 0; i < len; ++i) {
        unsigned char c = static_cast<unsigned char>(buf[i]);
        if (c == '\n') {
            flush_token();
            sent_tokens.emplace_back();
        } else if (is_space(c)) {
            flush_token();
        } else {
            tok.push_back(static_cast<char>(c));
        }
    }
    flush_token();
    // Note: mode 1 counts tokens that preprocess to "" toward n_raw only;
    // they join no sentence, matching the Python `if t` filter.

    // Sort kept words by (-freq, word) — finalize_vocab order.
    std::vector<long> kept;
    kept.reserve(freq.size());
    std::vector<const std::string*> word_of(freq.size(), nullptr);
    for (const auto& kv : seen) word_of[kv.second] = &kv.first;
    for (long id = 0; id < static_cast<long>(freq.size()); ++id)
        if (freq[id] >= min_freq) kept.push_back(id);
    std::sort(kept.begin(), kept.end(), [&](long a, long b) {
        if (freq[a] != freq[b]) return freq[a] > freq[b];
        return *word_of[a] < *word_of[b];
    });

    auto* st = new VocabState();
    std::vector<int> final_of(freq.size(), -1);
    st->words.reserve(kept.size());
    st->counts.reserve(kept.size());
    for (long rank = 0; rank < static_cast<long>(kept.size()); ++rank) {
        long id = kept[rank];
        final_of[id] = static_cast<int>(rank);
        st->words.push_back(*word_of[id]);
        st->counts.push_back(freq[id]);
        st->words_bytes += static_cast<long>(word_of[id]->size()) + 1;
    }

    // Pass 2 (in-memory): encode sentences, dropping OOV.
    st->seq_off.push_back(0);
    for (const auto& sent : sent_tokens) {
        for (int id : sent) {
            int f = final_of[id];
            if (f >= 0) st->ids.push_back(f);
        }
        st->seq_off.push_back(static_cast<long long>(st->ids.size()));
    }
    st->n_raw_tokens = n_raw;

    std::lock_guard<std::mutex> lock(g_mu);
    long h = g_next++;
    g_states[h] = st;
    return h;
}

long vocab_stats(long h, long* n_words, long* words_bytes, long* n_seqs,
                 long* n_idx, long* n_raw_tokens) {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_states.find(h);
    if (it == g_states.end()) return -1;
    VocabState* st = it->second;
    *n_words = static_cast<long>(st->words.size());
    *words_bytes = st->words_bytes;
    *n_seqs = static_cast<long>(st->seq_off.size()) - 1;
    *n_idx = static_cast<long>(st->ids.size());
    *n_raw_tokens = st->n_raw_tokens;
    return 0;
}

long vocab_dump(long h, char* words_buf, double* counts) {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_states.find(h);
    if (it == g_states.end()) return -1;
    VocabState* st = it->second;
    char* p = words_buf;
    for (size_t i = 0; i < st->words.size(); ++i) {
        std::memcpy(p, st->words[i].data(), st->words[i].size());
        p += st->words[i].size();
        *p++ = '\n';
        counts[i] = st->counts[i];
    }
    return 0;
}

long vocab_encode(long h, int* idx_out, long long* seq_off) {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_states.find(h);
    if (it == g_states.end()) return -1;
    VocabState* st = it->second;
    if (!st->ids.empty())
        std::memcpy(idx_out, st->ids.data(), st->ids.size() * sizeof(int));
    std::memcpy(seq_off, st->seq_off.data(),
                st->seq_off.size() * sizeof(long long));
    return 0;
}

void vocab_free(long h) {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_states.find(h);
    if (it == g_states.end()) return;
    delete it->second;
    g_states.erase(it);
}

}  // extern "C"
