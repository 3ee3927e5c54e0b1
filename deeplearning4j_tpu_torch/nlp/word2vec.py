"""Word2Vec / SequenceVectors (counterpart of
`deeplearning4j_tpu/nlp/word2vec.py`).

The reference's `models/word2vec/Word2Vec.java` + `SequenceVectors.java`
(builder API, vocab construction, subsampling, dynamic windows, linear LR
decay) and `InMemoryLookupTable.java` (syn0/syn1/syn1neg + negative table).
Training is batched updates (`ops/skipgram.py`) on the tables' device in
place of the reference's Hogwild threads.

The host side is the reference's, step for step: the native vocab builder
or the Python path, Huffman coding, the same `np.random.RandomState(seed)`
draws in the same order (keep-probabilities, window shrinks, negative-table
draws), the same example assembly and flush batches. So both packages build
the same batches from the same seed. The tables, the Huffman tables and the
NS label constant live on the device for the whole fit; each flush uploads
only its index, mask and lr arrays, through pinned staging buffers
(`skipgram.Uploader`), K = 8 flushes a dispatch (`ScanDispatchQueue`), so a
fit makes no synchronizing call per flush. After `fit`, `syn0` is a host
numpy copy for the query API (as in the reference); `syn1` / `syn1neg` stay
on the device.

`mesh=` (data parallelism over several cards) is not in the port yet
(ROADMAP A.13) and is refused.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nlp.tokenization import (
    TokenizerFactory, tokenize_corpus,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache,
    VocabConstructor,
    vocab_from_arrays,
    build_huffman,
    make_unigram_table,
)
from deeplearning4j_tpu_torch.ops import skipgram as kernels

K_SCAN = 8  # flushes a dispatch (the reference's scan length)


def host(a) -> np.ndarray:
    """A host numpy array of `a` (a tensor on any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_table(a, device) -> torch.Tensor:
    """A float32 copy of `a` on `device`, for a fit to update in place."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def huffman_tables(vocab_words):
    """codes / points / mask tables [V, L] of a vocab's Huffman paths."""
    V = len(vocab_words)
    max_code = max((len(w.codes) for w in vocab_words), default=1) or 1
    codes_tbl = np.zeros((V, max_code), np.int32)
    points_tbl = np.zeros((V, max_code), np.int32)
    cmask_tbl = np.zeros((V, max_code), np.float32)
    for w in vocab_words:
        L = len(w.codes)
        codes_tbl[w.index, :L] = w.codes
        points_tbl[w.index, :L] = w.points
        cmask_tbl[w.index, :L] = 1.0
    return codes_tbl, points_tbl, cmask_tbl


class WordVectors:
    """Query API over trained vectors (reference: `wordvectors/WordVectors.java`)."""

    def __init__(self, vocab: VocabCache, syn0):
        self.vocab = vocab
        self.syn0 = host(syn0)
        norms = np.linalg.norm(self.syn0, axis=1, keepdims=True)
        self._unit = self.syn0 / np.maximum(norms, 1e-12)

    def has_word(self, word: str) -> bool:
        return self.vocab.contains_word(word)

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return self.syn0[i] if i >= 0 else None

    def similarity(self, a: str, b: str) -> float:
        ia, ib = self.vocab.index_of(a), self.vocab.index_of(b)
        if ia < 0 or ib < 0:
            return float("nan")
        return float(self._unit[ia] @ self._unit[ib])

    def words_nearest(self, word_or_vec, top: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            i = self.vocab.index_of(word_or_vec)
            if i < 0:
                return []
            v = self._unit[i]
            exclude = {i}
        else:
            v = np.asarray(word_or_vec, np.float64)
            v = v / max(np.linalg.norm(v), 1e-12)
            exclude = set()
        sims = self._unit @ v
        order = np.argsort(-sims)
        out = []
        for j in order:
            if int(j) in exclude:
                continue
            out.append(self.vocab.word_at_index(int(j)).word)
            if len(out) >= top:
                break
        return out


class Word2Vec(WordVectors):
    """Skip-gram / CBOW embedding trainer (see module docstring).

    Builder-parameter parity with the reference's `Word2Vec.Builder`:
    min_word_frequency, layer_size, window_size, iterations/epochs, seed,
    learning_rate/min_learning_rate, negative (0 = hierarchical softmax),
    sample (subsampling threshold), cbow flag. `device` is where the tables
    live and the updates run: the card unless the caller asks for the CPU.
    """

    def __init__(
        self,
        sentences: Optional[Iterable] = None,
        *,
        min_word_frequency: int = 1,
        layer_size: int = 100,
        window_size: int = 5,
        iterations: int = 1,
        epochs: int = 1,
        seed: int = 12345,
        learning_rate: float = 0.025,
        min_learning_rate: float = 1e-4,
        negative: int = 0,
        sample: float = 0.0,
        cbow: bool = False,
        batch_size: int = 2048,
        tokenizer_factory: Optional[TokenizerFactory] = None,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None:
            raise ValueError(
                "Word2Vec(mesh=...) shards the flushes over several cards, "
                "which is not in the port yet (ROADMAP A.13); train on one "
                "device")
        self.device = resolve_device(device)
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window_size = window_size
        self.iterations = iterations
        self.epochs = epochs
        self.seed = seed
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.sample = sample
        self.cbow = cbow
        self.batch_size = batch_size
        self.tokenizer_factory = tokenizer_factory or TokenizerFactory()
        self._sentences = sentences
        self.vocab: Optional[VocabCache] = None
        self.syn0 = None
        self.syn1 = None
        self.syn1neg = None
        self.flushes = 0  # flushes of the last fit
        self.uploader: Optional[kernels.Uploader] = None  # the last fit's

    # ------------------------------------------------------------------ fit

    def fit(self, sentences: Optional[Iterable] = None) -> "Word2Vec":
        if sentences is not None:
            self._sentences = sentences
        if self._sentences is None:
            raise ValueError(
                "no sentences to train on — pass them to the constructor or "
                "to fit(sentences=...)")
        sentences = (self._sentences
                     if isinstance(self._sentences, (list, tuple))
                     else list(self._sentences))
        dev = self.device
        rng = np.random.RandomState(self.seed)
        # RESUME path (reference :149, :177-191): a model restored by
        # `nlp/serializer.load_full_model` (or carried over by
        # `interop.embeddings_from_numpy`) keeps its vocab and weights and
        # trains further on the new corpus, restricted to that vocab.
        resume = self.vocab is not None and self.syn0 is not None
        fast = None
        if not resume:
            from deeplearning4j_tpu_torch import native as native_mod

            fast = native_mod.build_vocab_corpus(
                sentences, self.min_word_frequency, self.tokenizer_factory)
        corpus = (None if fast is not None
                  else tokenize_corpus(sentences, self.tokenizer_factory))
        if not resume:
            if fast is not None:
                words, counts, fast_seqs = fast
                self.vocab = vocab_from_arrays(words, counts)
            else:
                self.vocab = VocabConstructor(
                    self.min_word_frequency).build(corpus)
            n_inner = build_huffman(self.vocab)
            V, D = self.vocab.num_words(), self.layer_size
            # Reference init: syn0 ~ U(-0.5/D, 0.5/D), syn1 zeros.
            syn0 = ((rng.rand(V, D) - 0.5) / D).astype(np.float32)
            syn0 = to_table(syn0, dev)
            if self.negative > 0:
                self.syn1neg = torch.zeros((V, D), dtype=torch.float32,
                                           device=dev)
            else:
                self.syn1 = torch.zeros((max(n_inner, 1), D),
                                        dtype=torch.float32, device=dev)
        else:
            V, D = self.vocab.num_words(), self.layer_size
            syn0 = to_table(self.syn0, dev)
            if self.negative > 0:
                self.syn1neg = (torch.zeros_like(syn0)
                                if self.syn1neg is None
                                else to_table(self.syn1neg, dev))
            else:
                if self.syn1 is None:
                    raise ValueError(
                        "resumed HS model has no syn1 table (was it trained "
                        "with negative sampling?)")
                self.syn1 = to_table(self.syn1, dev)
        self.syn0 = syn0
        if self.negative > 0:
            self._neg_table = make_unigram_table(self.vocab)
            # Constant labels (positive first), made on the device once.
            labels_dev = torch.zeros((self.batch_size, 1 + self.negative),
                                     dtype=torch.float32, device=dev)
            labels_dev[:, 0] = 1.0

        if fast is not None:
            seqs = fast_seqs  # already index-encoded with OOV dropped
        else:
            seqs = [
                np.asarray([self.vocab.index_of(t) for t in seq
                            if self.vocab.contains_word(t)], np.int32)
                for seq in corpus
            ]
        seqs = [s for s in seqs if len(s) >= 1]
        total_words = sum(len(s) for s in seqs) * self.epochs * self.iterations
        words_done = 0

        # Device-resident Huffman tables: HS flushes gather the paths on the
        # device and upload only [B] indices.
        codes_dev, points_dev, cmask_dev = (
            kernels.to_device(t, dev)
            for t in huffman_tables(self.vocab._by_index))

        freqs = np.array([w.frequency for w in self.vocab._by_index], np.float64)
        total_count = freqs.sum()
        if self.sample > 0:
            # Reference subsampling: keep probability per word occurrence.
            ratio = self.sample * total_count / np.maximum(freqs, 1)
            keep_prob = np.minimum(np.sqrt(ratio) + ratio, 1.0)
        else:
            keep_prob = np.ones(V)

        B = self.batch_size
        W = 2 * self.window_size
        up = kernels.Uploader(dev)
        self.uploader = up
        self.flushes = 0

        def flush(buf_center, buf_word, buf_ctx, buf_ctx_mask, fill, lr):
            if fill == 0:
                return
            self.flushes += 1
            pm = np.zeros(B, np.float32)
            pm[:fill] = 1.0
            if self.negative > 0:
                # Positive word first, then K unigram-table draws.
                K = self.negative
                targets = np.zeros((B, 1 + K), np.int32)
                targets[:, 0] = buf_word
                targets[:, 1:] = self._neg_table[
                    rng.randint(0, len(self._neg_table), (B, K))]
                scan_queue.add((buf_ctx if self.cbow else buf_center,
                                buf_ctx_mask, targets, pm, np.float32(lr)))
            else:
                scan_queue.add((buf_ctx if self.cbow else buf_center,
                                buf_ctx_mask, buf_word, pm, np.float32(lr)))

        # Vectorized training-example assembly, the reference's: per-position
        # dynamic window b ~ U[0, window), half-window = window - b, linear
        # lr decay by words consumed, a whole sequence at once.
        offsets = np.concatenate([np.arange(-self.window_size, 0),
                                  np.arange(1, self.window_size + 1)])
        pend: List = []  # per-mode tuples of example arrays awaiting flush
        n_pend = 0

        def lr_now():
            return max(self.min_learning_rate,
                       self.learning_rate * (1 - words_done / max(total_words, 1)))

        def _dispatch_one(q):
            ctx_or_c, cm, tw, pm, lr = q
            lr = float(lr)
            if self.cbow:
                ctx_d, cm_d, tw_d, pm_d = up.put(ctx_or_c, cm, tw, pm)
            else:
                ctx_d, tw_d, pm_d = up.put(ctx_or_c, tw, pm)
            if self.negative > 0:
                if self.cbow:
                    kernels.ns_cbow_step(self.syn0, self.syn1neg, ctx_d, cm_d,
                                         tw_d, labels_dev, pm_d, lr)
                else:
                    kernels.ns_skipgram_step(self.syn0, self.syn1neg, ctx_d,
                                             tw_d, labels_dev, pm_d, lr)
            elif self.cbow:
                kernels.hs_cbow_step_tbl(self.syn0, self.syn1, ctx_d, cm_d,
                                         tw_d, codes_dev, points_dev,
                                         cmask_dev, pm_d, lr)
            else:
                kernels.hs_skipgram_step_tbl(self.syn0, self.syn1, ctx_d, tw_d,
                                             codes_dev, points_dev, cmask_dev,
                                             pm_d, lr)
            up.done()

        def _dispatch_many(qs):
            stacked = [np.stack([q[0] for q in qs]),
                       np.stack([q[2] for q in qs]),
                       np.stack([q[3] for q in qs]),
                       np.asarray([q[-1] for q in qs], np.float32)]
            if self.cbow:
                stacked.append(np.stack([q[1] for q in qs]))
                ctx_d, tw_d, pm_d, lrs_d, cm_d = up.put(*stacked)
            else:
                ctx_d, tw_d, pm_d, lrs_d = up.put(*stacked)
            if self.negative > 0:
                if self.cbow:
                    kernels.ns_cbow_scan(self.syn0, self.syn1neg, ctx_d, cm_d,
                                         tw_d, labels_dev, pm_d, lrs_d)
                else:
                    kernels.ns_skipgram_scan(self.syn0, self.syn1neg, ctx_d,
                                             tw_d, labels_dev, pm_d, lrs_d)
            elif self.cbow:
                kernels.hs_cbow_scan_tbl(self.syn0, self.syn1, ctx_d, cm_d,
                                         tw_d, codes_dev, points_dev,
                                         cmask_dev, pm_d, lrs_d)
            else:
                kernels.hs_skipgram_scan_tbl(self.syn0, self.syn1, ctx_d, tw_d,
                                             codes_dev, points_dev, cmask_dev,
                                             pm_d, lrs_d)
            up.done()

        scan_queue = kernels.ScanDispatchQueue(K_SCAN, _dispatch_many,
                                               _dispatch_one)

        def flush_slice(cols, k, count, lr):
            """Pad examples [k:k+count] into fixed-B buffers and flush."""
            if self.cbow:
                ctx, cmask, word = (c[k:k + count] for c in cols)
                buf_ctx = np.zeros((B, W), np.int32)
                buf_cm = np.zeros((B, W), np.float32)
                buf_word = np.zeros(B, np.int32)
                buf_ctx[:count, :ctx.shape[1]] = ctx
                buf_cm[:count, :cmask.shape[1]] = cmask
                buf_word[:count] = word
                flush(None, buf_word, buf_ctx, buf_cm, count, lr)
            else:
                center, word = (c[k:k + count] for c in cols)
                buf_center = np.zeros(B, np.int32)
                buf_word = np.zeros(B, np.int32)
                buf_center[:count] = center
                buf_word[:count] = word
                flush(buf_center, buf_word, None, None, count, lr)

        def drain(final=False):
            """Flush pending examples in exact B-sized batches."""
            nonlocal pend, n_pend
            if not pend or (not final and n_pend < B):
                return  # defer concatenation until a full batch exists
            cols = [np.concatenate(c) for c in zip(*pend)]
            k = 0
            while n_pend - k >= B:
                flush_slice(cols, k, B, lr_now())
                k += B
            if final and n_pend > k:
                flush_slice(cols, k, n_pend - k, lr_now())
                k = n_pend
            pend = [tuple(c[k:] for c in cols)] if n_pend > k else []
            n_pend -= k

        for _ in range(self.epochs * self.iterations):
            for seq in seqs:
                if self.sample > 0:
                    keep = rng.rand(len(seq)) < keep_prob[seq]
                    seq = seq[keep]
                n = len(seq)
                if n == 0:
                    continue
                b = rng.randint(0, self.window_size, n)
                half = self.window_size - b  # dynamic half-window, 1..window
                ctx_pos = np.arange(n)[:, None] + offsets[None, :]  # [n, W]
                valid = ((np.abs(offsets)[None, :] <= half[:, None])
                         & (ctx_pos >= 0) & (ctx_pos < n))
                ctx_ids = seq[np.clip(ctx_pos, 0, n - 1)]
                if self.cbow:
                    rows = valid.any(axis=1)
                    pend.append((
                        np.ascontiguousarray(
                            np.where(valid, ctx_ids, 0)[rows], np.int32),
                        valid[rows].astype(np.float32),
                        seq[rows].astype(np.int32),
                    ))
                    n_pend += int(rows.sum())
                else:
                    # skip-gram: predict seq[pos] from each context seq[j];
                    # the row-major flatten keeps the (pos, j) visit order.
                    pend.append((
                        ctx_ids[valid].astype(np.int32),
                        np.broadcast_to(seq[:, None], valid.shape)[valid]
                        .astype(np.int32),
                    ))
                    n_pend += int(valid.sum())
                drain()
                words_done += n
        drain(final=True)
        scan_queue.drain()  # leftover queued flushes
        WordVectors.__init__(self, self.vocab, self.syn0)
        return self
