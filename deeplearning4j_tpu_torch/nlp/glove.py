"""GloVe — Global Vectors for word representation (counterpart of
`deeplearning4j_tpu/nlp/glove.py`).

The reference's `models/glove/Glove.java:41` with
`AbstractCoOccurrences.java` (windowed cooccurrence counting with
1/distance weighting, symmetric option) and `GloVe.java` (AdaGrad regression
on log-cooccurrence, xMax=100, alpha=0.75). Counting is one host-side pass
producing a COO triple array (the reference's, unchanged); training is
shuffled fixed-size batches through `ops/glove.glove_step` on the tables'
device. Each batch uploads only its rows, cols, counts and mask (pinned
staging, `ops.skipgram.Uploader`); its loss stays on the device until the
epoch ends, so an epoch makes one synchronizing read.

The port keeps the AdaGrad histories after `fit` (`hist_w`, `hist_b`, on the
device) and, beyond the reference, resumes: a model whose vocab and syn0 are
set (`interop.embeddings_from_numpy`) trains further on `fit`'s corpus,
restricted to that vocab, from its syn0, bias and histories. A resumed fit
draws no init from its `RandomState(seed)`, so its shuffles are the
generator's first draws.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nlp.tokenization import (
    TokenizerFactory, tokenize_corpus,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache, VocabConstructor, vocab_from_arrays,
)
from deeplearning4j_tpu_torch.nlp.word2vec import WordVectors, host, to_table
from deeplearning4j_tpu_torch.ops.glove import glove_step
from deeplearning4j_tpu_torch.ops.skipgram import Uploader


class CoOccurrences:
    """Windowed cooccurrence counter (reference:
    `AbstractCoOccurrences.java:321-372` — weight 1/distance within the
    window; `symmetric` also credits the mirrored pair)."""

    def __init__(self, window_size: int = 5, symmetric: bool = True):
        self.window_size = window_size
        self.symmetric = symmetric

    def count(self, sequences: Iterable[np.ndarray]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns DIRECTED COO arrays (rows, cols, weights): each in-window
        pair is credited (x, j); `symmetric` also credits the mirrored
        (j, x) entry, exactly the reference's storage
        (`AbstractCoOccurrences.java:364-372`)."""
        counts: Dict[Tuple[int, int], float] = {}
        for seq in sequences:
            n = len(seq)
            for x in range(n):
                wx = int(seq[x])
                stop = min(x + self.window_size + 1, n)
                for j in range(x + 1, stop):
                    wj = int(seq[j])
                    w = 1.0 / (j - x)
                    counts[(wx, wj)] = counts.get((wx, wj), 0.0) + w
                    if self.symmetric:
                        counts[(wj, wx)] = counts.get((wj, wx), 0.0) + w
        if not counts:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        rows = np.fromiter((k[0] for k in counts), np.int32, len(counts))
        cols = np.fromiter((k[1] for k in counts), np.int32, len(counts))
        vals = np.fromiter(counts.values(), np.float32, len(counts))
        return rows, cols, vals


class Glove(WordVectors):
    """GloVe trainer (builder-parameter parity with `Glove.Builder`:
    min_word_frequency, layer_size/vector length, window_size, epochs,
    xMax, alpha, learning_rate, shuffle, symmetric, seed, batch_size).
    `device`: the card unless the caller asks for the CPU."""

    def __init__(
        self,
        sentences: Optional[Iterable] = None,
        *,
        min_word_frequency: int = 1,
        layer_size: int = 100,
        window_size: int = 5,
        epochs: int = 5,
        seed: int = 12345,
        learning_rate: float = 0.05,
        x_max: float = 100.0,
        alpha: float = 0.75,
        shuffle: bool = True,
        symmetric: bool = True,
        batch_size: int = 4096,
        tokenizer_factory: Optional[TokenizerFactory] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window_size = window_size
        self.epochs = epochs
        self.seed = seed
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.shuffle = shuffle
        self.symmetric = symmetric
        self.batch_size = batch_size
        self.tokenizer_factory = tokenizer_factory or TokenizerFactory()
        self._sentences = sentences
        self.vocab: Optional[VocabCache] = None
        self.syn0 = None
        self.bias = None
        self.hist_w: Optional[torch.Tensor] = None
        self.hist_b: Optional[torch.Tensor] = None
        self.error_per_epoch: List[float] = []

    def fit(self, sentences: Optional[Iterable] = None) -> "Glove":
        if sentences is not None:
            self._sentences = sentences
        sentences = (self._sentences
                     if isinstance(self._sentences, (list, tuple))
                     else list(self._sentences))
        dev = self.device
        resume = self.vocab is not None and self.syn0 is not None
        if resume:
            corpus = tokenize_corpus(sentences, self.tokenizer_factory)
            seqs = [
                np.asarray([self.vocab.index_of(t) for t in seq
                            if self.vocab.contains_word(t)], np.int32)
                for seq in corpus
            ]
        else:
            # Native tokenize+count+encode (exactness-guarded), or the
            # Python path for a corpus it refuses.
            from deeplearning4j_tpu_torch import native as native_mod

            fast = native_mod.build_vocab_corpus(
                sentences, self.min_word_frequency, self.tokenizer_factory)
            if fast is not None:
                words, counts, seqs = fast
                self.vocab = vocab_from_arrays(words, counts)
            else:
                corpus = tokenize_corpus(sentences, self.tokenizer_factory)
                self.vocab = VocabConstructor(
                    self.min_word_frequency).build(corpus)
                seqs = [
                    np.asarray([self.vocab.index_of(t) for t in seq
                                if self.vocab.contains_word(t)], np.int32)
                    for seq in corpus
                ]
        V, D = self.vocab.num_words(), self.layer_size
        rng = np.random.RandomState(self.seed)
        rows, cols, vals = CoOccurrences(
            self.window_size, self.symmetric).count(seqs)
        if len(rows) == 0:
            raise ValueError("empty cooccurrence matrix — corpus too small")

        if resume:
            syn0 = to_table(self.syn0, dev)
            bias = to_table(self.bias, dev)
            hist_w = (torch.zeros_like(syn0) if self.hist_w is None
                      else to_table(self.hist_w, dev))
            hist_b = (torch.zeros_like(bias) if self.hist_b is None
                      else to_table(self.hist_b, dev))
        else:
            # Reference init (GloveWeightLookupTable.resetWeights): syn0
            # uniform scaled by layer size, bias zero; AdaGrad history zero.
            syn0 = to_table(((rng.rand(V, D) - 0.5) / D).astype(np.float32),
                            dev)
            bias = torch.zeros((V,), dtype=torch.float32, device=dev)
            hist_w = torch.zeros((V, D), dtype=torch.float32, device=dev)
            hist_b = torch.zeros((V,), dtype=torch.float32, device=dev)

        B = min(self.batch_size, max(len(rows), 1))
        n_pairs = len(rows)
        lr = float(np.float32(self.learning_rate))
        x_max = float(np.float32(self.x_max))
        alpha = float(np.float32(self.alpha))
        up = Uploader(dev)

        for _ in range(self.epochs):
            order = rng.permutation(n_pairs) if self.shuffle else np.arange(n_pairs)
            batch_losses = []
            for start in range(0, n_pairs, B):
                take = order[start:start + B]
                fill = len(take)
                br = np.zeros(B, np.int32)
                bc = np.zeros(B, np.int32)
                bv = np.ones(B, np.float32)
                pm = np.zeros(B, np.float32)
                br[:fill] = rows[take]
                bc[:fill] = cols[take]
                bv[:fill] = vals[take]
                pm[:fill] = 1.0
                loss = glove_step(syn0, bias, hist_w, hist_b,
                                  *up.put(br, bc, bv, pm), lr, x_max,
                                  alpha)[-1]
                up.done()
                batch_losses.append(loss)
            # The epoch's one read of the device.
            epoch_err = float(torch.stack(batch_losses).sum())
            self.error_per_epoch.append(epoch_err / max(n_pairs, 1))

        self.hist_w, self.hist_b = hist_w, hist_b
        self.bias = host(bias)
        WordVectors.__init__(self, self.vocab, syn0)
        return self
