"""Vocabulary construction + Huffman coding.

The port's copy of `deeplearning4j_tpu/nlp/vocab.py`, which is host code
(Python and numpy) and computes the same.

Equivalent of the reference's `models/word2vec/wordstore/` — `VocabWord`,
`VocabCache`, `VocabConstructor.buildJointVocabulary`
(`VocabConstructor.java:161`) and the `Huffman` tree builder whose codes/points
drive hierarchical softmax.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.util.huffman import huffman_codes


@dataclass
class VocabWord:
    word: str
    frequency: float = 0.0
    index: int = -1
    codes: List[int] = field(default_factory=list)  # Huffman code bits
    points: List[int] = field(default_factory=list)  # inner-node indices


class VocabCache:
    """In-memory vocab (reference: `InMemoryLookupCache`/`AbstractCache`)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0.0

    def add_token(self, word: str, count: float = 1.0):
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word=word, frequency=0.0)
            self._words[word] = vw
        vw.frequency += count
        self.total_word_count += count

    def finalize_vocab(self, min_word_frequency: int = 1):
        kept = [w for w in self._words.values() if w.frequency >= min_word_frequency]
        kept.sort(key=lambda w: (-w.frequency, w.word))
        self._words = {w.word: w for w in kept}
        self._by_index = kept
        for i, w in enumerate(kept):
            w.index = i
        self.total_word_count = sum(w.frequency for w in kept)

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_at_index(self, index: int) -> VocabWord:
        return self._by_index[index]

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def num_words(self) -> int:
        return len(self._by_index)

    def words(self) -> List[str]:
        return [w.word for w in self._by_index]


def build_huffman(cache: VocabCache, max_code_length: int = 40) -> int:
    """Assign Huffman codes/points (reference: `Huffman.java`, MAX_CODE_LENGTH
    40). Returns the number of inner nodes (= syn1 rows needed). The tree
    itself comes from the shared `util/huffman.py` core (also used
    degree-keyed by DeepWalk's GraphHuffman equivalent)."""
    n = cache.num_words()
    if n == 0:
        return 0
    freqs = [w.frequency for w in cache._by_index]
    codes, points, n_inner = huffman_codes(freqs, max_code_length)
    for w, c, p in zip(cache._by_index, codes, points):
        w.codes = c
        w.points = p
    return n_inner


def vocab_from_arrays(words: List[str], counts) -> VocabCache:
    """Assemble a finalized VocabCache from pre-sorted (word, count) arrays
    — the native `fastvocab` builder's output (already in finalize_vocab
    order). Huffman codes are NOT assigned; call `build_huffman`."""
    cache = VocabCache()
    total = 0.0
    for i, (w, c) in enumerate(zip(words, counts)):
        vw = VocabWord(word=w, frequency=float(c), index=i)
        cache._words[w] = vw
        cache._by_index.append(vw)
        total += float(c)
    cache.total_word_count = total
    return cache


class VocabConstructor:
    """Build a vocab from token-sequence sources (reference:
    `VocabConstructor.buildJointVocabulary`)."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency

    def build(self, sequences: Iterable[List[str]]) -> VocabCache:
        cache = VocabCache()
        for seq in sequences:
            for tok in seq:
                cache.add_token(tok)
        cache.finalize_vocab(self.min_word_frequency)
        build_huffman(cache)
        return cache


def make_unigram_table(cache: VocabCache, table_size: int = 100_000,
                       power: float = 0.75) -> np.ndarray:
    """Negative-sampling table (reference: `InMemoryLookupTable.resetWeights`
    negative table): word index drawn proportional to freq^0.75."""
    n = cache.num_words()
    freqs = np.array([w.frequency for w in cache._by_index], np.float64) ** power
    probs = freqs / freqs.sum()
    return np.repeat(np.arange(n), np.maximum((probs * table_size).astype(np.int64), 1))
