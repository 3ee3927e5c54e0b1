"""ParagraphVectors (doc2vec) (counterpart of
`deeplearning4j_tpu/nlp/paragraph_vectors.py`).

The reference's `models/paragraphvectors/ParagraphVectors.java`: PV-DBOW
(the label vector predicts words — skip-gram with the doc label as the
context) and PV-DM (label + context words predict the word), plus
`infer_vector` for unseen documents (word/softmax weights frozen, a fresh
doc vector fitted). The doc vectors and syn0 are one combined table [L + V,
D] on the device for the fit, updated by `ops/skipgram.py`'s HS steps K = 8
flushes a dispatch, each flush uploading only its index, mask and lr arrays
through pinned staging (`skipgram.Uploader`). The host side (vocab, Huffman
coding, example assembly, the RandomState draws) is the reference's.

`infer_vector` seeds the new vector from `abs(hash(text))`, as the
reference does; Python salts `str` hashes per process, so both packages
start from the same vector within one process only (ROADMAP C).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nlp.sentence_iterator import LabelledDocument
from deeplearning4j_tpu_torch.nlp.tokenization import TokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache, VocabConstructor, build_huffman, vocab_from_arrays,
)
from deeplearning4j_tpu_torch.nlp.word2vec import (
    K_SCAN, host, huffman_tables, to_table,
)
from deeplearning4j_tpu_torch.ops import skipgram as kernels


class ParagraphVectors:
    def __init__(
        self,
        documents: Iterable,
        *,
        dm: bool = False,  # False = DBOW (reference default DBOW for labels)
        min_word_frequency: int = 1,
        layer_size: int = 100,
        window_size: int = 5,
        epochs: int = 1,
        seed: int = 12345,
        learning_rate: float = 0.025,
        min_learning_rate: float = 1e-4,
        batch_size: int = 1024,
        tokenizer_factory: Optional[TokenizerFactory] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.dm = dm
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window_size = window_size
        self.epochs = epochs
        self.seed = seed
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.batch_size = batch_size
        self.tf = tokenizer_factory or TokenizerFactory()
        self._docs: List[LabelledDocument] = [
            d if isinstance(d, LabelledDocument) else LabelledDocument(content=d)
            for d in documents
        ]
        for i, d in enumerate(self._docs):
            if not d.labels:
                d.labels = [f"DOC_{i}"]
        self.vocab: Optional[VocabCache] = None

    # ------------------------------------------------------------------ fit

    def fit(self) -> "ParagraphVectors":
        from deeplearning4j_tpu_torch import native as native_mod

        dev = self.device
        fast = native_mod.build_vocab_corpus(
            [d.content for d in self._docs], self.min_word_frequency, self.tf)
        if fast is not None:
            words, counts, fast_seqs = fast
            self.vocab = vocab_from_arrays(words, counts)
            corpus = None
        else:
            corpus = [self.tf.create(d.content).get_tokens()
                      for d in self._docs]
            self.vocab = VocabConstructor(self.min_word_frequency).build(corpus)
        n_inner = build_huffman(self.vocab)
        V, D = self.vocab.num_words(), self.layer_size

        self.labels = sorted({l for d in self._docs for l in d.labels})
        self._label_index = {l: i for i, l in enumerate(self.labels)}
        L = len(self.labels)

        rng = np.random.RandomState(self.seed)
        syn0 = ((rng.rand(V, D) - 0.5) / D).astype(np.float32)
        doc_vectors = ((rng.rand(L, D) - 0.5) / D).astype(np.float32)
        self.syn1 = torch.zeros((max(n_inner, 1), D), dtype=torch.float32,
                                device=dev)
        self._codes_tbl, self._points_tbl, self._cmask_tbl = huffman_tables(
            self.vocab._by_index)

        if fast is not None:
            seqs = [(s, [self._label_index[l] for l in d.labels])
                    for s, d in zip(fast_seqs, self._docs)]
        else:
            seqs = [
                (np.asarray([self.vocab.index_of(t) for t in toks
                             if self.vocab.contains_word(t)], np.int32),
                 [self._label_index[l] for l in d.labels])
                for toks, d in zip(corpus, self._docs)
            ]
        # Doc ids are the first L rows of one combined table [L + V, D];
        # doc rows use DBOW/DM pairing.
        combined = to_table(np.concatenate([doc_vectors, syn0]), dev)
        B = self.batch_size
        codes_dev, points_dev, cmask_dev = (
            kernels.to_device(t, dev) for t in (
                self._codes_tbl, self._points_tbl, self._cmask_tbl))
        total = sum(len(s) for s, _ in seqs) * self.epochs
        done = 0
        up = kernels.Uploader(dev)

        def _one(q):
            c, w, pm, lr = q
            c_d, w_d, pm_d = up.put(c, w, pm)
            kernels.hs_skipgram_step_tbl(combined, self.syn1, c_d, w_d,
                                         codes_dev, points_dev, cmask_dev,
                                         pm_d, float(lr))
            up.done()

        def _many(qs):
            c_d, w_d, pm_d, lrs_d = up.put(
                np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs]),
                np.stack([q[2] for q in qs]),
                np.asarray([q[3] for q in qs], np.float32))
            kernels.hs_skipgram_scan_tbl(combined, self.syn1, c_d, w_d,
                                         codes_dev, points_dev, cmask_dev,
                                         pm_d, lrs_d)
            up.done()

        queue = kernels.ScanDispatchQueue(K_SCAN, _many, _one)

        def flush(centers, words, count, lr):
            buf_center = np.zeros(B, np.int32)
            buf_word = np.zeros(B, np.int32)
            pm = np.zeros(B, np.float32)
            buf_center[:count] = centers
            buf_word[:count] = words
            pm[:count] = 1.0
            queue.add((buf_center, buf_word, pm, np.float32(lr)))

        pend: List = []
        n_pend = 0

        def drain(final=False):
            nonlocal pend, n_pend
            if not pend or (not final and n_pend < B):
                return
            c = np.concatenate([p[0] for p in pend])
            w = np.concatenate([p[1] for p in pend])
            k = 0
            while n_pend - k >= B:
                flush(c[k:k + B], w[k:k + B], B, self._lr(done, total))
                k += B
            if final and n_pend > k:
                flush(c[k:], w[k:], n_pend - k, self._lr(done, total))
                k = n_pend
            pend = [(c[k:], w[k:])] if n_pend > k else []
            n_pend -= k

        W = self.window_size
        offsets = np.concatenate([np.arange(-W, 0), np.arange(1, W + 1)])
        for _ in range(self.epochs):
            for seq, label_ids in seqs:
                n = len(seq)
                if n == 0 or not label_ids:
                    done += n
                    continue
                lids = np.asarray(label_ids, np.int32)
                # DBOW: every doc label predicts every word (pos-major, as
                # the reference's per-position loop visits them).
                pend.append((np.tile(lids, n),
                             np.repeat(seq, len(lids)).astype(np.int32)))
                n_pend += n * len(lids)
                if self.dm:
                    # DM: context words (offset rows into the combined
                    # table) predict the word too.
                    ctx_pos = np.arange(n)[:, None] + offsets[None, :]
                    valid = (ctx_pos >= 0) & (ctx_pos < n)
                    centers = (L + seq[np.clip(ctx_pos, 0, n - 1)])[valid]
                    words = np.broadcast_to(seq[:, None], valid.shape)[valid]
                    pend.append((centers.astype(np.int32),
                                 words.astype(np.int32)))
                    n_pend += int(valid.sum())
                drain()
                done += n
        drain(final=True)
        queue.drain()  # leftover queued flushes
        self.doc_vectors = combined[:L]
        self.syn0 = combined[L:]
        self._set_doc_unit()
        return self

    def _set_doc_unit(self):
        dv = host(self.doc_vectors)
        self._doc_unit = dv / np.maximum(
            np.linalg.norm(dv, axis=1, keepdims=True), 1e-12)

    def _lr(self, done, total):
        return max(self.min_learning_rate,
                   self.learning_rate * (1 - done / max(total, 1)))

    # ---------------------------------------------------------------- query

    def get_doc_vector(self, label: str) -> np.ndarray:
        return host(self.doc_vectors)[self._label_index[label]]

    def similarity(self, a: str, b: str) -> float:
        ia, ib = self._label_index[a], self._label_index[b]
        return float(self._doc_unit[ia] @ self._doc_unit[ib])

    def nearest_labels(self, vec_or_label, top: int = 5) -> List[str]:
        if isinstance(vec_or_label, str):
            v = self._doc_unit[self._label_index[vec_or_label]]
        else:
            v = np.asarray(vec_or_label, np.float64)
            v = v / max(np.linalg.norm(v), 1e-12)
        sims = self._doc_unit @ v
        return [self.labels[i] for i in np.argsort(-sims)[:top]]

    def infer_vector(self, text: str, steps: int = 20,
                     learning_rate: float = 0.025) -> np.ndarray:
        """Fit a fresh doc vector against frozen word/softmax weights
        (reference: `ParagraphVectors.inferVector`)."""
        toks = [self.vocab.index_of(t) for t in self.tf.create(text).get_tokens()
                if self.vocab.contains_word(t)]
        if not toks:
            return np.zeros(self.layer_size, np.float32)
        dev = self.syn1.device
        rng = np.random.RandomState(abs(hash(text)) % (2 ** 31))
        vec = to_table(((rng.rand(1, self.layer_size) - 0.5)
                        / self.layer_size).astype(np.float32), dev)
        words = np.asarray(toks, np.int32)
        B = len(words)
        codes, points, cmask = (kernels.to_device(t[words], dev) for t in (
            self._codes_tbl, self._points_tbl, self._cmask_tbl))
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        ones = torch.ones(B, dtype=torch.float32, device=dev)
        lr = float(np.float32(learning_rate))
        for _ in range(steps):
            # One HS step where the only trainable row is the doc vector,
            # against a COPY of syn1 (the step updates its tables in place):
            # the model's softmax weights stay as they are.
            kernels.hs_skipgram_step(vec, self.syn1.clone(), zeros, codes,
                                     points, cmask, ones, lr)
        return host(vec)[0]
