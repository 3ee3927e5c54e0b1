"""Word-vector serialization (counterpart of
`deeplearning4j_tpu/nlp/serializer.py`, host code that writes the same
bytes for the same vectors: each package reads the other's files).

Equivalent of the reference's `models/embeddings/loader/
WordVectorSerializer.java:111-226` — Google word2vec binary format
(`loadGoogleModel`/`readBinaryModel`: ASCII "<vocab> <dim>" header, then
per word the whitespace-terminated token followed by <dim> little-endian
float32s), Google/DL4J text format (`readTextModel`/`writeWordVectors`),
and a full-model save that round-trips training state (syn0/syn1/syn1neg +
vocab with Huffman codes), analog of `writeFullModel`/`loadFullModel`.
"""

from __future__ import annotations

import json
import struct
import zipfile

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, WordVectors, host


def _vocab_from_words(words) -> VocabCache:
    cache = VocabCache()
    for i, w in enumerate(words):
        vw = VocabWord(word=w, frequency=1.0, index=i)
        cache._words[w] = vw
        cache._by_index.append(vw)
    cache.total_word_count = float(len(cache._by_index))
    return cache


# ------------------------------------------------------------ text format

def write_word_vectors(vectors: WordVectors, path: str,
                       header: bool = True) -> None:
    """Google text format: optional "<vocab> <dim>" header then one
    "word v1 v2 ..." line per word (the reference's `writeWordVectors`
    omits the header; `loadGoogleModel(..., binary=false)` accepts both)."""
    syn0 = np.asarray(host(vectors.syn0), np.float32)
    with open(path, "w", encoding="utf-8") as f:
        if header:
            f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n")
        for i, row in enumerate(syn0):
            word = vectors.vocab.word_at_index(i).word
            f.write(word + " " + " ".join(f"{x:.8g}" for x in row) + "\n")


def load_txt_vectors(path: str) -> WordVectors:
    """Reads DL4J/Google text vectors, with or without the header line
    (reference: `loadTxtVectors`/`readTextModel`)."""
    words, rows = [], []
    with open(path, encoding="utf-8") as f:
        first = f.readline().rstrip("\n")
        parts = first.split(" ")
        if not (len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit()):
            words.append(parts[0])
            rows.append(np.asarray([float(x) for x in parts[1:]], np.float32))
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            words.append(parts[0])
            rows.append(np.asarray([float(x) for x in parts[1:]], np.float32))
    return WordVectors(_vocab_from_words(words), np.stack(rows))


# ---------------------------------------------------------- binary format

def write_google_binary(vectors: WordVectors, path: str) -> None:
    """Google word2vec .bin layout (reference `readBinaryModel` reads this
    back: header "<vocab> <dim>\\n", then per word the UTF-8 token, a
    space, <dim> LE float32s, and a trailing newline)."""
    syn0 = np.asarray(host(vectors.syn0), np.float32)
    V, D = syn0.shape
    with open(path, "wb") as f:
        f.write(f"{V} {D}\n".encode("utf-8"))
        for i in range(V):
            word = vectors.vocab.word_at_index(i).word
            f.write(word.encode("utf-8") + b" ")
            f.write(struct.pack(f"<{D}f", *syn0[i]))
            f.write(b"\n")


def load_google_binary(path: str) -> WordVectors:
    """Reference: `WordVectorSerializer.readBinaryModel` — tolerate both
    "word<SP>floats<NL>" and "word<SP>floats" packing."""
    words, rows = [], []
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            c = f.read(1)
            if not c:
                raise ValueError("truncated binary word-vector file")
            header += c
        V, D = (int(x) for x in header.decode("utf-8").split())
        for _ in range(V):
            token = b""
            while True:
                c = f.read(1)
                if not c:
                    raise ValueError("truncated binary word-vector file")
                if c == b" ":
                    break
                if c != b"\n":  # skip the previous entry's trailing newline
                    token += c
            vec = np.frombuffer(f.read(4 * D), np.float32).copy()
            words.append(token.decode("utf-8"))
            rows.append(vec)
    return WordVectors(_vocab_from_words(words), np.stack(rows))


def load_google_model(path: str, binary: bool = True) -> WordVectors:
    """Reference dispatch `loadGoogleModel(file, binary)`."""
    return load_google_binary(path) if binary else load_txt_vectors(path)


# ------------------------------------------------------------- full model

def write_full_model(model: Word2Vec, path: str) -> None:
    """Round-trips TRAINING state, not just vectors (reference
    `writeFullModel`: config + vocab incl. Huffman codes + syn0/syn1).
    Zip of config.json, vocab.json, and arrays.npz."""
    config = {
        "layer_size": model.layer_size,
        "window_size": model.window_size,
        "min_word_frequency": model.min_word_frequency,
        "negative": model.negative,
        "sample": model.sample,
        "cbow": model.cbow,
        "learning_rate": model.learning_rate,
        "min_learning_rate": model.min_learning_rate,
        "seed": model.seed,
    }
    vocab = [
        {"word": w.word, "frequency": w.frequency, "index": w.index,
         "codes": list(w.codes), "points": list(w.points)}
        for w in model.vocab._by_index
    ]
    arrays = {"syn0": np.asarray(host(model.syn0), np.float32)}
    if model.syn1 is not None:
        arrays["syn1"] = np.asarray(host(model.syn1), np.float32)
    if model.syn1neg is not None:
        arrays["syn1neg"] = np.asarray(host(model.syn1neg), np.float32)
    import io
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("config.json", json.dumps(config))
        z.writestr("vocab.json", json.dumps(vocab))
        z.writestr("arrays.npz", buf.getvalue())


def load_full_model(path: str, device="cuda") -> Word2Vec:
    """A model written by `write_full_model` (of either package), ready for
    queries and for `fit` to train further on `device` (the resume path)."""
    import io
    with zipfile.ZipFile(path) as z:
        config = json.loads(z.read("config.json"))
        vocab_entries = json.loads(z.read("vocab.json"))
        arrays = np.load(io.BytesIO(z.read("arrays.npz")))
        model = Word2Vec(**{k: v for k, v in config.items()}, device=device)
        cache = VocabCache()
        for e in vocab_entries:
            vw = VocabWord(word=e["word"], frequency=e["frequency"],
                           index=e["index"], codes=list(e["codes"]),
                           points=list(e["points"]))
            cache._words[vw.word] = vw
            cache._by_index.append(vw)
        cache.total_word_count = sum(w.frequency for w in cache._by_index)
        model.vocab = cache
        model.syn0 = arrays["syn0"]
        model.syn1 = arrays["syn1"] if "syn1" in arrays else None
        model.syn1neg = arrays["syn1neg"] if "syn1neg" in arrays else None
        WordVectors.__init__(model, cache, model.syn0)
    return model
