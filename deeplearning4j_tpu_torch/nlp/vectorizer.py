"""Bag-of-words / TF-IDF text vectorizers.

The port's copy of `deeplearning4j_tpu/nlp/vectorizer.py`, which is host code
(Python and numpy) and computes the same.

Reference: `deeplearning4j-nlp/.../bagofwords/vectorizer/BagOfWordsVectorizer.java`
(raw per-document word counts) and `TfidfVectorizer.java:113-134` with
`util/MathUtils.java:257-283` semantics: tf = count/docLength,
idf = log10(totalDocs/docFreq), weight = tf*idf. `vectorize(text, label)`
returns a DataSet of (feature vector, one-hot label) exactly like the
reference's `TextVectorizer.vectorize`.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp.tokenization import TokenizerFactory


class BagOfWordsVectorizer:
    """Count vectorizer (reference: `BagOfWordsVectorizer.java`)."""

    def __init__(self, *, min_word_frequency: int = 1,
                 labels: Optional[Sequence[str]] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.min_word_frequency = min_word_frequency
        self.labels = list(labels) if labels else []
        self.tf = tokenizer_factory or TokenizerFactory()
        self.vocab: List[str] = []
        self._index: dict = {}
        self._doc_freq: Optional[np.ndarray] = None
        self.n_docs = 0

    # ------------------------------------------------------------------ fit

    def _tokens(self, text: str) -> List[str]:
        return self.tf.create(text).get_tokens()

    def fit(self, docs: Iterable[str]) -> "BagOfWordsVectorizer":
        """Build the vocabulary (+ document frequencies) over the corpus."""
        counts: dict = {}
        doc_sets: List[set] = []
        self.n_docs = 0
        for text in docs:
            toks = self._tokens(text)
            self.n_docs += 1
            doc_sets.append(set(toks))
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
        self.vocab = sorted(w for w, c in counts.items()
                            if c >= self.min_word_frequency)
        self._index = {w: i for i, w in enumerate(self.vocab)}
        df = np.zeros(len(self.vocab), np.float64)
        for s in doc_sets:
            for w in s:
                i = self._index.get(w)
                if i is not None:
                    df[i] += 1
        self._doc_freq = df
        return self

    # ------------------------------------------------------------ transform

    def _counts(self, text: str):
        v = np.zeros(len(self.vocab), np.float64)
        toks = self._tokens(text)
        for t in toks:
            i = self._index.get(t)
            if i is not None:
                v[i] += 1
        return v, len(toks)

    def transform(self, text: str) -> np.ndarray:
        """Feature vector for one document (raw counts)."""
        return self._counts(text)[0]

    def fit_transform(self, docs: Sequence[str]) -> np.ndarray:
        self.fit(docs)
        return np.stack([self.transform(d) for d in docs])

    def vectorize(self, text: str, label: str) -> DataSet:
        """(features, one-hot label) pair (reference
        `TextVectorizer.vectorize`); `label` must be in `self.labels`."""
        if label not in self.labels:
            raise ValueError(f"unknown label {label!r} (labels={self.labels})")
        y = np.zeros((1, len(self.labels)), np.float64)
        y[0, self.labels.index(label)] = 1.0
        return DataSet(self.transform(text)[None], y)


class TfidfVectorizer(BagOfWordsVectorizer):
    """TF-IDF vectorizer (reference: `TfidfVectorizer.java` +
    `MathUtils.tfidf`): tf = count/docLength, idf = log10(nDocs/docFreq)."""

    def transform(self, text: str) -> np.ndarray:
        counts, doc_len = self._counts(text)
        if doc_len == 0 or self.n_docs == 0:
            return counts
        tf = counts / doc_len
        with np.errstate(divide="ignore"):
            idf = np.where(self._doc_freq > 0,
                           np.log10(self.n_docs / np.maximum(self._doc_freq, 1)),
                           0.0)
        return tf * idf
