"""Distributed corpus pipeline: per-process tokenization, vocab build and
cooccurrence counting (counterpart of
`deeplearning4j_tpu/nlp/distributed_corpus.py`).

Reference analog: `dl4j-spark-nlp`'s `TextPipeline.java` (map-reduce word
counting over corpus partitions) and
`spark/models/embeddings/glove/cooccurrences/`. Each PROCESS counts its own
corpus shard with the native tokenizer/counter (`native/fastvocab.cpp`), and
the partial results merge through `torch.distributed` `all_gather` when a
process group is initialised (gloo between CPU processes); with none, the
one local shard is the whole corpus. So the same code runs everywhere:

- `distributed_vocab(shard)` returns the IDENTICAL VocabCache on every
  process — counts are summed globally before the min-frequency filter
  and the (-freq, word) finalize ordering — plus the local shard encoded
  against that global vocab (local ids remapped to global ids with one
  gather).
- `distributed_cooccurrences(seqs_shard)` merges per-shard windowed COO
  counts (1/distance weighting, `nlp/glove.py` semantics) into the same
  (rows, cols, weights) every process would get counting the whole corpus
  alone.

The rest of the reference's parallel package is not in the port yet
(ROADMAP A.13).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import TokenizerFactory, tokenize_corpus
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache,
    build_huffman,
    vocab_from_arrays,
)


def _allgather_bytes(buf: bytes) -> List[bytes]:
    """Gather one variable-length byte string from every process of the
    default `torch.distributed` group, in rank order; with no group, this
    process's own."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return [buf]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    n = dist.get_world_size()
    lens = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(buf)], dtype=torch.int64,
                                       device=dev))
    lens = [int(x.item()) for x in lens]
    L = max(1, max(lens))
    padded = np.zeros((L,), np.uint8)
    if buf:
        padded[: len(buf)] = np.frombuffer(buf, np.uint8)
    out = [torch.zeros(L, dtype=torch.uint8, device=dev) for _ in range(n)]
    dist.all_gather(out, torch.from_numpy(padded).to(dev))
    return [out[i][: lens[i]].cpu().numpy().tobytes() for i in range(n)]


def _local_counts(sentences, tokenizer_factory):
    """(words, counts, local_seqs) for THIS shard, unfiltered (min_freq=1 —
    the global filter applies after the merge). Native when eligible."""
    from deeplearning4j_tpu_torch import native as native_mod

    sentences = (sentences if isinstance(sentences, (list, tuple))
                 else list(sentences))
    fast = native_mod.build_vocab_corpus(sentences, 1.0, tokenizer_factory)
    if fast is not None:
        words, counts, seqs = fast
        return list(words), np.asarray(counts, np.float64), seqs
    corpus = tokenize_corpus(sentences,
                             tokenizer_factory or TokenizerFactory())
    order: List[str] = []
    idx = {}
    counts: List[float] = []
    seqs = []
    for seq in corpus:
        enc = np.empty(len(seq), np.int32)
        for i, tok in enumerate(seq):
            j = idx.get(tok)
            if j is None:
                j = len(order)
                idx[tok] = j
                order.append(tok)
                counts.append(0.0)
            counts[j] += 1.0
            enc[i] = j
        seqs.append(enc)
    # Match the native path's output convention (first-seen local ids).
    return order, np.asarray(counts, np.float64), seqs


def distributed_vocab(
    sentences_shard,
    min_word_frequency: float = 1.0,
    tokenizer_factory: Optional[TokenizerFactory] = None,
    huffman: bool = True,
) -> Tuple[VocabCache, List[np.ndarray]]:
    """Build ONE global vocab from every process's corpus shard and encode
    this process's shard against it.

    Returns (vocab, encoded_seqs): `vocab` is identical on all processes
    (globally summed counts, global min-frequency filter, finalize_vocab
    ordering, Huffman codes when `huffman`); `encoded_seqs` are THIS
    shard's sentences as int32 global-vocab indices with OOV dropped.
    """
    words, counts, local_seqs = _local_counts(sentences_shard,
                                              tokenizer_factory)
    payload = "\n".join(words).encode("utf-8")
    gathered_words = _allgather_bytes(payload)
    gathered_counts = _allgather_bytes(counts.tobytes())

    merged = {}
    for wbuf, cbuf in zip(gathered_words, gathered_counts):
        ws = wbuf.decode("utf-8").split("\n") if wbuf else []
        cs = np.frombuffer(cbuf, np.float64)
        for w, c in zip(ws, cs):
            merged[w] = merged.get(w, 0.0) + float(c)
    kept = [(w, c) for w, c in merged.items() if c >= min_word_frequency]
    kept.sort(key=lambda t: (-t[1], t[0]))
    vocab = vocab_from_arrays([w for w, _ in kept], [c for _, c in kept])
    if huffman:
        build_huffman(vocab)

    # Remap the shard's local-id encoding to global ids with ONE gather:
    # per-VOCAB-WORD Python, per-TOKEN numpy.
    remap = np.asarray([vocab.index_of(w) for w in words], np.int32)
    out = []
    for s in local_seqs:
        g = remap[s] if len(s) else np.zeros((0,), np.int32)
        out.append(g[g >= 0].astype(np.int32))
    return vocab, out


def distributed_cooccurrences(
    seqs_shard: Iterable[np.ndarray],
    window_size: int = 5,
    symmetric: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge per-shard windowed cooccurrence counts into the global COO
    (rows, cols, weights) — `nlp/glove.py::CoOccurrences` semantics, every
    process receiving the same merged result."""
    from deeplearning4j_tpu_torch.nlp.glove import CoOccurrences

    rows, cols, vals = CoOccurrences(window_size, symmetric).count(seqs_shard)
    payload = np.concatenate([
        rows.astype(np.int64), cols.astype(np.int64),
    ]).tobytes() + vals.astype(np.float64).tobytes()
    header = np.asarray([len(rows)], np.int64).tobytes()
    gathered = _allgather_bytes(header + payload)

    all_r, all_c, all_v = [], [], []
    for buf in gathered:
        n = int(np.frombuffer(buf[:8], np.int64)[0])
        ints = np.frombuffer(buf[8: 8 + 16 * n], np.int64)
        all_r.append(ints[:n])
        all_c.append(ints[n: 2 * n])
        all_v.append(np.frombuffer(buf[8 + 16 * n:], np.float64))
    r = np.concatenate(all_r) if all_r else np.zeros(0, np.int64)
    if r.size == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    c = np.concatenate(all_c)
    v = np.concatenate(all_v)
    # Vectorized merge (GloVe-scale shards carry millions of pairs): one
    # composite sort key, np.unique for the deterministic merged order,
    # np.add.at to sum duplicate pairs.
    V = int(max(r.max(), c.max())) + 1
    key = r * V + c
    uniq, inverse = np.unique(key, return_inverse=True)
    out_v = np.zeros(len(uniq), np.float64)
    np.add.at(out_v, inverse, v)
    return ((uniq // V).astype(np.int32), (uniq % V).astype(np.int32),
            out_v.astype(np.float32))
