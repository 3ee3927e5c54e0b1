"""Carry weights between the two packages as numpy.

`params_from_numpy` takes a params tree as the JAX package holds it
(`cg.params_tree` with every leaf turned into a numpy array: nested
`{vertex: {name: array}}`) and returns the port's tree, name for name, for
`ComputationGraph.init(params=...)`. The port checks names and shapes
against its conf there, so both packages compute the same function.
HWIO conv kernels travel as they are (the port keeps the layout); so do
a quantized tree's int8 weights and their f32 `__scale` companions
(`checkpoint/quantize.py`), at their own dtypes.
`state_from_numpy` carries declared layer state the same way (`cg.state`:
the BatchNorm running means and variances) for `init(state=...)`.
`embeddings_from_numpy` carries a trained embedding model (Word2Vec, GloVe,
ParagraphVectors, DeepWalk) as numpy tables plus its vocab, and returns the
port's model, ready for queries and to train further."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no numpy-native view
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree: Mapping[str, Mapping[str, object]]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    return {str(v): {str(k): _tensor(a) for k, a in p.items()}
            for v, p in tree.items()}


def state_from_numpy(tree: Mapping[str, Mapping[str, object]]
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    return params_from_numpy(tree)


def updater_state_from_numpy(opt_state: Mapping[str, object],
                             iteration: int) -> Dict[str, object]:
    """The reference's `opt_state` (numpy leaves) for `init(updater_state=
    ...)`: `{vertex: {field: {name: tensor}}}`, with its reserved keys, the
    f32 masters `_master` (`{vertex: {name: tensor}}`) and the loss-scale
    pair `_ls` (a tuple of two scalars)."""
    def node(fields):
        if isinstance(fields, Mapping):
            return {str(f): {str(k): _tensor(a) for k, a in leaves.items()}
                    for f, leaves in fields.items()}
        if isinstance(fields, (tuple, list)) and fields:
            return tuple(_tensor(a) for a in fields)
        return {}

    tree = {str(v): node(fields) for v, fields in opt_state.items()}
    return {"opt_state": tree, "iteration": int(iteration)}


def vocab_entries(vocab) -> List[dict]:
    """A vocab as `[{"word", "frequency", "codes", "points"}]` in index
    order (the full-model zip's `vocab.json`): from such a list, or from any
    vocab cache with `_by_index` entries carrying those attributes (the
    reference's `VocabCache`)."""
    if hasattr(vocab, "_by_index"):
        return [{"word": w.word, "frequency": float(w.frequency),
                 "codes": [int(c) for c in w.codes],
                 "points": [int(q) for q in w.points]}
                for w in vocab._by_index]
    return [dict(e) for e in vocab]


def _vocab_cache(entries: Sequence[dict]):
    from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord

    cache = VocabCache()
    for i, e in enumerate(entries):
        vw = VocabWord(word=e["word"], frequency=float(e["frequency"]),
                       index=i, codes=list(e.get("codes", [])),
                       points=list(e.get("points", [])))
        cache._words[vw.word] = vw
        cache._by_index.append(vw)
    cache.total_word_count = sum(w.frequency for w in cache._by_index)
    return cache


def embeddings_from_numpy(kind: str, arrays: Mapping[str, object], *,
                          vocab=None, labels: Optional[Sequence[str]] = None,
                          degrees=None, walk_rng_state=None, device="cuda",
                          **config):
    """The port's model of kind "word2vec", "glove", "paragraph_vectors" or
    "deepwalk" from a trained model's numpy tables (`arrays`) and its
    builder settings (`config`, the constructor's keywords).

    - word2vec: `syn0` and `syn1` (HS) or `syn1neg` (NS); `vocab` with the
      Huffman codes and points. `fit(sentences)` then resumes.
    - glove: `syn0`, `bias`, `hist_w`, `hist_b` (the AdaGrad histories);
      `vocab`. `fit(sentences)` then resumes from the histories.
    - paragraph_vectors: `doc_vectors`, `syn0`, `syn1`; `vocab` with the
      codes and points; `labels` in doc-vector row order. Queries and
      `infer_vector` then run on `device`.
    - deepwalk: `syn0`, `syn1`; `degrees`, the vertex degrees its Huffman
      tree was built from; `walk_rng_state` (`RandomState.get_state()` of
      the model's walk generator) to draw the same walks next. `fit(graph)`
      then trains further.
    """
    import numpy as _np

    from deeplearning4j_tpu_torch.nlp.word2vec import (
        WordVectors, huffman_tables, to_table,
    )

    def arr(name):
        return _np.asarray(arrays[name], _np.float32)

    if kind in ("word2vec", "glove", "paragraph_vectors"):
        if vocab is None:
            raise ValueError(f"{kind}: the model's vocab is needed")
        cache = _vocab_cache(vocab_entries(vocab))
    if kind == "word2vec":
        from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

        model = Word2Vec(device=device, **config)
        model.vocab = cache
        model.syn1 = arr("syn1") if "syn1" in arrays else None
        model.syn1neg = arr("syn1neg") if "syn1neg" in arrays else None
        WordVectors.__init__(model, cache, arr("syn0"))
        return model
    if kind == "glove":
        from deeplearning4j_tpu_torch.nlp.glove import Glove

        model = Glove(device=device, **config)
        model.vocab = cache
        model.bias = arr("bias")
        model.hist_w, model.hist_b = arr("hist_w"), arr("hist_b")
        WordVectors.__init__(model, cache, arr("syn0"))
        return model
    if kind == "paragraph_vectors":
        from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
            ParagraphVectors,
        )

        if labels is None:
            raise ValueError("paragraph_vectors: the doc labels are needed")
        model = ParagraphVectors([], device=device, **config)
        model.vocab = cache
        model.labels = list(labels)
        model._label_index = {l: i for i, l in enumerate(model.labels)}
        model.syn0 = to_table(arr("syn0"), model.device)
        model.doc_vectors = to_table(arr("doc_vectors"), model.device)
        model.syn1 = to_table(arr("syn1"), model.device)
        model._codes_tbl, model._points_tbl, model._cmask_tbl = \
            huffman_tables(cache._by_index)
        model._set_doc_unit()
        return model
    if kind == "deepwalk":
        from deeplearning4j_tpu_torch.graph.deepwalk import (
            DeepWalk, GraphVectors,
        )

        if degrees is None:
            raise ValueError("deepwalk: the vertex degrees are needed")
        model = DeepWalk(device=device, **config)
        model.initialize(_np.asarray(degrees))
        model._syn0 = to_table(arr("syn0"), model.device)
        model._syn1 = to_table(arr("syn1"), model.device)
        if walk_rng_state is not None:
            model._walk_rng.set_state(walk_rng_state)
        GraphVectors.__init__(model, model._syn0)
        return model
    raise ValueError(f"unknown embedding model kind {kind!r}: word2vec, "
                     "glove, paragraph_vectors or deepwalk")
