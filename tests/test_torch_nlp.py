"""The port's NLP slice against the JAX package, on the CPU: the same
numpy-seeded inputs through both.

- `ops/skipgram.py` and `ops/glove.py`: every step, the `_tbl` forms and the
  scans, with repeated indices (so the row-norm cap binds) and logits past
  +-6 (so the MAX_EXP cut-offs bind): max|d| / max|ref| <= 1e-5 per op; a
  port scan equals its K single steps bit for bit.
- The host pipeline exactly: Huffman codes and points, tokenization, vocab
  words and counts, the unigram table, the native vocab builder (against
  the reference's native builder and the Python path, its guard refusals,
  \\x1c-\\x1f as separators; a failed build raises), encoded sequences,
  negative draws and the flushes' batches, cooccurrence triples.
- Whole fits: `Word2Vec` in the four modes with subsampling and its resume
  path, `Glove` (tables and `error_per_epoch`), `ParagraphVectors` DBOW
  and DM with `infer_vector` (which leaves syn1 bit for bit), the
  vectorizers: tables within 1e-4 of the reference's.
- Serializers: text and binary files byte-equal across the packages and
  read in both directions; the full-model zip's members.
- `interop.embeddings_from_numpy`: a reference-trained model continued in
  the port.
- `distributed_corpus` with one process and with two gloo processes.

Small sizes: V of 50 to 200, D = 16.
"""

import os
import socket
import subprocess
import sys
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu import native as jax_native
from deeplearning4j_tpu.nlp import glove as jax_glove
from deeplearning4j_tpu.nlp import paragraph_vectors as jax_pv
from deeplearning4j_tpu.nlp import serializer as jax_ser
from deeplearning4j_tpu.nlp import tokenization as jax_tok
from deeplearning4j_tpu.nlp import vectorizer as jax_vec
from deeplearning4j_tpu.nlp import vocab as jax_vocab
from deeplearning4j_tpu.nlp import word2vec as jax_w2v
from deeplearning4j_tpu.nlp.distributed_corpus import (
    distributed_cooccurrences as jax_dist_cooc,
    distributed_vocab as jax_dist_vocab,
)
from deeplearning4j_tpu.ops import glove as jax_glove_op
from deeplearning4j_tpu.ops import skipgram as J
from deeplearning4j_tpu.util.huffman import huffman_codes as jax_huffman
from deeplearning4j_tpu_torch import interop, native
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp import glove, paragraph_vectors as pv
from deeplearning4j_tpu_torch.nlp import serializer, tokenization as tok
from deeplearning4j_tpu_torch.nlp import vectorizer, vocab, word2vec
from deeplearning4j_tpu_torch.nlp.distributed_corpus import (
    distributed_cooccurrences, distributed_vocab,
)
from deeplearning4j_tpu_torch.ops import glove as glove_op
from deeplearning4j_tpu_torch.ops import skipgram as P
from deeplearning4j_tpu_torch.util.huffman import huffman_codes

ROOT = Path(__file__).resolve().parents[1]
OP_TOL = 1e-5    # one op, or the first 8 flushes
FIT_TOL = 1e-4   # a whole fit


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package (see
    `tests/test_torch_rnn_slice.py`)."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


@pytest.fixture(autouse=True)
def own_native_libs(monkeypatch):
    """Libraries loaded by a test stay out of the module's own table, which
    `test_torch_port_rules.py` checks is empty after an import."""
    monkeypatch.setattr(native, "_libs", {})


def rel(got, want):
    """max|got - want| / max|want| over a table."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------ the ops

V, I, D, B, L, W, NEG = 60, 59, 16, 96, 7, 6, 4


def _op_inputs(seed):
    """Tables large enough that logits pass +-6; indices drawn from a few
    rows so that many pairs collide and the aggregated update's cap binds."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return dict(
        syn0=(rng.randn(V, D) * 1.5).astype(f32),
        syn1=(rng.randn(I, D) * 1.5).astype(f32),
        centers=rng.randint(0, 6, B).astype(np.int32),
        words=rng.randint(0, V, B).astype(np.int32),
        codes=rng.randint(0, 2, (B, L)).astype(np.int32),
        points=rng.randint(0, 8, (B, L)).astype(np.int32),
        code_mask=(rng.rand(B, L) < .8).astype(f32),
        pair_mask=(rng.rand(B) < .85).astype(f32),
        context=rng.randint(0, 6, (B, W)).astype(np.int32),
        context_mask=(rng.rand(B, W) < .7).astype(f32),
        targets=rng.randint(0, 8, (B, 1 + NEG)).astype(np.int32),
        labels=np.tile(np.r_[1.0, np.zeros(NEG)], (B, 1)).astype(f32),
        codes_tbl=rng.randint(0, 2, (V, L)).astype(np.int32),
        points_tbl=rng.randint(0, 8, (V, L)).astype(np.int32),
        cmask_tbl=(rng.rand(V, L) < .8).astype(f32),
    )


STEPS = {
    "hs_skipgram_step": ("centers", "codes", "points", "code_mask",
                         "pair_mask"),
    "ns_skipgram_step": ("centers", "targets", "labels", "pair_mask"),
    "ns_cbow_step": ("context", "context_mask", "targets", "labels",
                     "pair_mask"),
    "hs_cbow_step": ("context", "context_mask", "codes", "points",
                     "code_mask", "pair_mask"),
    "hs_skipgram_step_tbl": ("centers", "words", "codes_tbl", "points_tbl",
                             "cmask_tbl", "pair_mask"),
    "hs_cbow_step_tbl": ("context", "context_mask", "words", "codes_tbl",
                         "points_tbl", "cmask_tbl", "pair_mask"),
}


def _second_table(name, x):
    return x["syn1"] if name.startswith("hs") else x["syn1"][:8]


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_matches_reference(name):
    x = _op_inputs(1)
    args = [x[k] for k in STEPS[name]]
    s1 = _second_table(name, x)
    lr = 0.9
    want0, want1 = getattr(J, name)(jnp.asarray(x["syn0"]), jnp.asarray(s1),
                                    *args, jnp.float32(lr))
    syn0, syn1 = t(x["syn0"]), t(s1)
    out = getattr(P, name)(syn0, syn1, *map(t, args), lr)
    assert out[0] is syn0 and out[1] is syn1  # updated in place
    assert rel(syn0, want0) <= OP_TOL
    assert rel(syn1, want1) <= OP_TOL
    # The cap bound: some row's update was cut to norm 1.
    for before, after in ((x["syn0"], syn0), (s1, syn1)):
        step = np.linalg.norm(after.numpy() - before, axis=1)
        assert step.max() == pytest.approx(1.0, abs=1e-5)


def test_logits_pass_the_cutoffs():
    # The inputs above reach the MAX_EXP branches of both output steps.
    x = _op_inputs(1)
    h = x["syn0"][x["centers"]]
    hs = np.einsum("bd,bld->bl", h, x["syn1"][x["points"]])
    ns = np.einsum("bd,bkd->bk", h, x["syn1"][x["targets"]])
    assert (hs > 6).any() and (hs < -6).any()
    assert (ns > 6).any() and (ns < -6).any()


def test_padding_pairs_contribute_nothing():
    x = _op_inputs(2)
    pm = np.zeros(B, np.float32)
    for name in sorted(STEPS):
        args = [pm if k == "pair_mask" else x[k] for k in STEPS[name]]
        s1 = _second_table(name, x)
        syn0, syn1 = t(x["syn0"]), t(s1)
        getattr(P, name)(syn0, syn1, *map(t, args), 0.5)
        assert torch.equal(syn0, t(x["syn0"])), name
        assert torch.equal(syn1, t(s1)), name


def test_clip_rows_matches_reference():
    rng = np.random.RandomState(3)
    u = (rng.randn(40, D) * rng.choice([0.01, 0.5, 3.0], (40, 1))).astype(
        np.float32)
    u[5] = 0.0
    want = np.asarray(J._clip_rows(jnp.asarray(u)))
    got = P._clip_rows(t(u)).numpy()
    assert rel(got, want) <= OP_TOL
    assert np.linalg.norm(got, axis=1).max() <= 1.0 + 1e-6


K = 3
SCANS = {
    "hs_skipgram_scan_tbl": ("hs_skipgram_step_tbl",
                             ("centers", "words"), ("codes_tbl",
                                                    "points_tbl",
                                                    "cmask_tbl")),
    "hs_cbow_scan_tbl": ("hs_cbow_step_tbl",
                         ("context", "context_mask", "words"),
                         ("codes_tbl", "points_tbl", "cmask_tbl")),
    "ns_skipgram_scan": ("ns_skipgram_step", ("centers", "targets"),
                         ("labels",)),
    "ns_cbow_scan": ("ns_cbow_step", ("context", "context_mask", "targets"),
                     ("labels",)),
}


@pytest.mark.parametrize("name", sorted(SCANS))
def test_scan_is_k_steps(name):
    step, stacked, shared = SCANS[name]
    xs = [_op_inputs(10 + k) for k in range(K)]
    x = xs[0]
    s1 = _second_table(name, x)
    st = {k: np.stack([xi[k] for xi in xs]) for k in stacked + ("pair_mask",)}
    lrs = np.asarray([0.9, 0.5, 0.2], np.float32)
    args = [st[k] for k in stacked] + [x[k] for k in shared]
    args.append(st["pair_mask"])
    want0, want1 = getattr(J, name)(jnp.asarray(x["syn0"]), jnp.asarray(s1),
                                    *args, jnp.asarray(lrs))
    syn0, syn1 = t(x["syn0"]), t(s1)
    getattr(P, name)(syn0, syn1, *map(t, args), t(lrs))
    assert rel(syn0, want0) <= OP_TOL
    assert rel(syn1, want1) <= OP_TOL
    # The scan is the K single steps, in order, bit for bit.
    a0, a1 = t(x["syn0"]), t(s1)
    names = STEPS[step]
    for k in range(K):
        one = [st[n][k] if n in st else x[n] for n in names]
        getattr(P, step)(a0, a1, *map(t, one), t(lrs)[k])
    assert torch.equal(a0, syn0) and torch.equal(a1, syn1)


def test_scan_dispatch_queue():
    got = []
    q = P.ScanDispatchQueue(3, lambda qs: got.append(("many", list(qs))),
                            lambda i: got.append(("one", i)))
    for i in range(7):
        q.add(i)
    q.drain()
    assert got == [("many", [0, 1, 2]), ("many", [3, 4, 5]), ("one", 6)]
    got.clear()
    for i in range(3):
        q.add(i)
    q.drain()
    assert got == [("many", [0, 1, 2])]


def test_uploader_on_the_cpu_counts_and_shares():
    up = P.Uploader("cpu")
    a = np.arange(6, dtype=np.int32)
    (ta, tb) = up.put(a, np.ones(3, np.float32))
    up.done()
    assert ta.dtype == torch.int32 and ta.tolist() == a.tolist()
    assert up.uploads == 2 and up.bytes == 24 + 12


def test_glove_step_matches_reference():
    rng = np.random.RandomState(4)
    Vg, Bg = 50, 80
    syn0 = (rng.randn(Vg, D) * 0.3).astype(np.float32)
    bias = (rng.randn(Vg) * 0.1).astype(np.float32)
    hw = (rng.rand(Vg, D) * 0.1).astype(np.float32)
    hb = (rng.rand(Vg) * 0.1).astype(np.float32)
    rows = rng.randint(0, 7, Bg).astype(np.int32)
    cols = rng.randint(0, Vg, Bg).astype(np.int32)
    counts = (rng.rand(Bg) * 200).astype(np.float32)  # some above x_max
    mask = (rng.rand(Bg) < .9).astype(np.float32)
    want = jax_glove_op.glove_step(
        *map(jnp.asarray, (syn0, bias, hw, hb)), rows, cols, counts, mask,
        jnp.float32(0.05), jnp.float32(100.0), jnp.float32(0.75))
    tabs = [t(a) for a in (syn0, bias, hw, hb)]
    got = glove_op.glove_step(*tabs, t(rows), t(cols), t(counts), t(mask),
                              0.05, 100.0, 0.75)
    for g, w, tab in zip(got[:4], want[:4], tabs):
        assert g is tab
        assert rel(g, w) <= OP_TOL
    assert abs(float(got[4]) - float(want[4])) <= OP_TOL * abs(float(want[4]))


# ------------------------------------------------------ the host pipeline

def _zipf_corpus(seed, n_sent, v=80, length=(5, 30)):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    return [[f"w{j}" for j in rng.choice(v, rng.randint(*length), p=p)]
            for _ in range(n_sent)]


def test_huffman_codes_equal():
    rng = np.random.RandomState(5)
    for freqs in (rng.randint(1, 500, 150), [3], [], [2, 2, 2, 2, 1]):
        assert huffman_codes(list(freqs)) == jax_huffman(list(freqs))
    freqs = list(rng.randint(1, 9, 200))
    assert huffman_codes(freqs, 5) == jax_huffman(freqs, 5)


def test_tokenization_equal():
    texts = ["The QUICK brown fox, 42 times!", "jumped; over (the) lazy dogs",
             "  passes\tpassing  classes studied  "]
    for pre_p, pre_j in ((None, None),
                         (tok.CommonPreprocessor(), jax_tok.CommonPreprocessor()),
                         (tok.EndingPreProcessor(), jax_tok.EndingPreProcessor())):
        fp, fj = tok.TokenizerFactory(pre_p), jax_tok.TokenizerFactory(pre_j)
        for s in texts:
            assert fp.create(s).get_tokens() == fj.create(s).get_tokens()
        assert tok.tokenize_corpus(texts + [["a", "b"]], fp) == \
            jax_tok.tokenize_corpus(texts + [["a", "b"]], fj)


def _vocab_rows(cache):
    return [(w.word, w.frequency, w.index, w.codes, w.points)
            for w in cache._by_index]


def test_vocab_and_unigram_table_equal():
    corpus = _zipf_corpus(6, 60, v=150)
    for mf in (1, 2):
        p = vocab.VocabConstructor(mf).build(corpus)
        j = jax_vocab.VocabConstructor(mf).build(corpus)
        assert _vocab_rows(p) == _vocab_rows(j)
        assert p.total_word_count == j.total_word_count
        assert np.array_equal(vocab.make_unigram_table(p),
                              jax_vocab.make_unigram_table(j))
    words, counts = p.words(), [w.frequency for w in p._by_index]
    a = vocab.vocab_from_arrays(words, counts)
    b = jax_vocab.vocab_from_arrays(words, counts)
    assert vocab.build_huffman(a) == jax_vocab.build_huffman(b)
    assert _vocab_rows(a) == _vocab_rows(b)


# ------------------------------------------------- the native vocab builder

def _python_path(sentences, min_freq, factory=None):
    corpus = tok.tokenize_corpus(sentences, factory or tok.TokenizerFactory())
    v = vocab.VocabConstructor(min_freq).build(corpus)
    seqs = [[v.index_of(x) for x in s if v.contains_word(x)] for s in corpus]
    return v.words(), [w.frequency for w in v._by_index], seqs


def _same(got, want):
    assert got is not None and want is not None
    assert got[0] == list(want[0])
    assert list(got[1]) == list(want[1])
    assert [list(s) for s in got[2]] == [list(s) for s in want[2]]


CORPORA = {
    "presplit": ([["b", "a", "b", "c"], ["a", "b"], [], ["zz", "a", "a"],
                  ["tie1", "tie2"], ["é", "a"]], None),
    "raw_preprocessed": (["The QUICK brown fox, 42 times!",
                          "the (quick) dog...   and\tthe fox",
                          "1234 ,,, !!!"], "common"),
    "raw_separators": (["a\x1cb c", "b\x1d\x1e a\x1f", "c\x0bd\x0c a"],
                       None),
    "zipf": (_zipf_corpus(7, 40), None),
}


@pytest.mark.parametrize("case", sorted(CORPORA))
@pytest.mark.parametrize("min_freq", [1, 2])
def test_native_builder_matches_reference_and_python(case, min_freq):
    sents, pre = CORPORA[case]
    fp = tok.TokenizerFactory(tok.CommonPreprocessor() if pre else None)
    fj = jax_tok.TokenizerFactory(jax_tok.CommonPreprocessor() if pre
                                  else None)
    native.reset_counts()
    got = native.build_vocab_corpus(sents, float(min_freq), fp)
    assert native.corpus_paths == {"native": 1, "python": 0}
    _same(got, jax_native.build_vocab_corpus(sents, float(min_freq), fj))
    _same(got, _python_path(sents, min_freq, fp))
    assert all(s.dtype == np.int32 for s in got[2])


REFUSED = {
    "non_ascii_preprocessed": (["Füchse sind schlau"], "common"),
    "other_preprocessor": (["plain text"], "ending"),
    "token_with_space": ([["ok", "bad token"]], None),
    "token_with_separator": ([["a\x1cb"]], None),
    "raw_newline": (["a b\nc d"], None),
    "mixed": (["a b", ["c"]], None),
    "non_ascii_raw": (["naïve text"], None),
    "generator": ((s for s in ["a b"]), None),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_native_builder_refuses_what_the_reference_refuses(case):
    sents, pre = REFUSED[case]
    if case == "generator":
        sents_j = (s for s in ["a b"])
    else:
        sents_j = sents
    make = {None: lambda m: m.TokenizerFactory(),
            "common": lambda m: m.TokenizerFactory(m.CommonPreprocessor()),
            "ending": lambda m: m.TokenizerFactory(m.EndingPreProcessor())}
    native.reset_counts()
    assert native.build_vocab_corpus(sents, 1.0, make[pre](tok)) is None
    assert native.corpus_paths == {"native": 0, "python": 1}
    assert jax_native.build_vocab_corpus(sents_j, 1.0,
                                         make[pre](jax_tok)) is None


def test_refused_corpus_trains_through_the_python_path():
    # A refused corpus still trains, to the reference's vocab.
    sents = ["Füchse sind schlau und Füchse sind schnell"] * 3
    kw = dict(layer_size=8, window_size=2, seed=1, batch_size=16,
              tokenizer_factory=None)
    native.reset_counts()
    m = word2vec.Word2Vec(device="cpu", **kw).fit(sents)
    assert native.corpus_paths == {"native": 0, "python": 1}
    j = jax_w2v.Word2Vec(**kw).fit(sents)
    assert m.vocab.words() == j.vocab.words()
    assert rel(m.syn0, j.syn0) <= FIT_TOL


def test_failed_native_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "fastvocab.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_vocab_corpus([["a", "b"]], 1.0)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        word2vec.Word2Vec(device="cpu", layer_size=4).fit([["a", "b"]])


# ------------------------------------------------------------- Word2Vec

MODES = {"hs_skipgram": dict(negative=0, cbow=False),
         "ns_skipgram": dict(negative=4, cbow=False),
         "hs_cbow": dict(negative=0, cbow=True),
         "ns_cbow": dict(negative=4, cbow=True)}
W2V_KW = dict(layer_size=16, window_size=3, min_word_frequency=1,
              sample=0.05, seed=3, batch_size=128, learning_rate=0.05)
SCAN_NAMES = ("hs_skipgram_scan_tbl", "hs_cbow_scan_tbl", "ns_skipgram_scan",
              "ns_cbow_scan", "hs_skipgram_step_tbl", "hs_cbow_step_tbl",
              "ns_skipgram_step", "ns_cbow_step")


def _record_batches(monkeypatch, module, record):
    """Record every dispatch's arguments after the two tables (host
    copies); the port's scans call its steps, which are not recorded."""
    busy = []

    for name in SCAN_NAMES:
        real = getattr(module, name)

        def wrapped(*a, _real=real, _name=name):
            if busy:
                return _real(*a)
            record.append((_name, [np.array(x.detach().numpy()
                                            if isinstance(x, torch.Tensor)
                                            else x)
                                   for x in a[2:]]))
            busy.append(1)
            try:
                return _real(*a)
            finally:
                busy.pop()
        # The reference's scans call their steps' `__wrapped__` bodies.
        wrapped.__wrapped__ = getattr(real, "__wrapped__", real)
        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_word2vec_fit_matches_reference(mode, monkeypatch):
    sents = _zipf_corpus(8, 50, v=120)
    kw = dict(W2V_KW, batch_size=64, **MODES[mode])
    got_b, want_b = [], []
    _record_batches(monkeypatch, P, got_b)
    _record_batches(monkeypatch, J, want_b)
    m = word2vec.Word2Vec(device="cpu", **kw).fit(sents)
    j = jax_w2v.Word2Vec(**kw).fit(sents)
    assert _vocab_rows(m.vocab) == _vocab_rows(j.vocab)
    # The same batches: indices, masks, negative draws and lrs exactly
    # (the port's Huffman tables and labels come from the host too).
    assert [n for n, _ in got_b] == [n for n, _ in want_b]
    # K-flush scans ran (and, in the CBOW modes, leftover single steps).
    assert got_b[0][0].endswith(("scan", "scan_tbl"))
    for (_, g), (_, w) in zip(got_b, want_b):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.array_equal(a, np.asarray(b))
    assert m.flushes == sum(len(g[0]) if n.endswith(("scan", "scan_tbl"))
                            else 1 for n, g in got_b)
    assert rel(m.syn0, j.syn0) <= FIT_TOL
    second = "syn1neg" if kw["negative"] else "syn1"
    assert rel(getattr(m, second), np.asarray(getattr(j, second))) <= FIT_TOL
    assert getattr(m, second).device.type == "cpu"


def test_word2vec_fast_path_equals_python_path(monkeypatch):
    sents = _zipf_corpus(9, 30)
    kw = dict(W2V_KW, negative=0, sample=0.0)
    native.reset_counts()
    a = word2vec.Word2Vec(device="cpu", **kw).fit(sents)
    monkeypatch.setattr(native, "build_vocab_corpus", lambda *x, **k: None)
    b = word2vec.Word2Vec(device="cpu", **kw).fit(sents)
    assert a.vocab.words() == b.vocab.words()
    assert np.array_equal(a.syn0, b.syn0)


def test_word2vec_resume_matches_reference(tmp_path):
    s1, s2 = _zipf_corpus(10, 30), _zipf_corpus(11, 30)
    for mode in ("hs_skipgram", "ns_cbow"):
        kw = dict(W2V_KW, **MODES[mode])
        j = jax_w2v.Word2Vec(**kw).fit(s1)
        path = str(tmp_path / f"{mode}.zip")
        jax_ser.write_full_model(j, path)
        m = serializer.load_full_model(path, device="cpu")
        assert _vocab_rows(m.vocab) == _vocab_rows(j.vocab)
        m.fit(s2)
        j2 = jax_ser.load_full_model(path).fit(s2)
        assert rel(m.syn0, j2.syn0) <= FIT_TOL
        second = "syn1neg" if kw["negative"] else "syn1"
        assert rel(getattr(m, second),
                   np.asarray(getattr(j2, second))) <= FIT_TOL


def test_word2vec_needs_sentences():
    with pytest.raises(ValueError, match="no sentences"):
        word2vec.Word2Vec(device="cpu").fit()


# ----------------------------------------------------------- serializers

def _trained(neg=0):
    sents = _zipf_corpus(12, 20, v=50)
    kw = dict(W2V_KW, negative=neg, sample=0.0)
    return (word2vec.Word2Vec(device="cpu", **kw).fit(sents),
            jax_w2v.Word2Vec(**kw).fit(sents))


def test_text_and_binary_files_byte_equal(tmp_path):
    m, _ = _trained()
    # The same vectors through both writers: the same bytes.
    jv = jax_w2v.WordVectors(jax_vocab.vocab_from_arrays(
        m.vocab.words(), [w.frequency for w in m.vocab._by_index]), m.syn0)
    for header in (True, False):
        a, b = tmp_path / f"p{header}.txt", tmp_path / f"j{header}.txt"
        serializer.write_word_vectors(m, str(a), header=header)
        jax_ser.write_word_vectors(jv, str(b), header=header)
        assert a.read_bytes() == b.read_bytes()
        # Each package reads the other's file.
        for got in (serializer.load_txt_vectors(str(b)),
                    jax_ser.load_txt_vectors(str(a))):
            assert got.vocab.words() == m.vocab.words()
            assert rel(got.syn0, m.syn0) <= 1e-7
    a, b = tmp_path / "p.bin", tmp_path / "j.bin"
    serializer.write_google_binary(m, str(a))
    jax_ser.write_google_binary(jv, str(b))
    assert a.read_bytes() == b.read_bytes()
    for got in (serializer.load_google_model(str(b)),
                jax_ser.load_google_model(str(a))):
        assert got.vocab.words() == m.vocab.words()
        assert np.array_equal(got.syn0, m.syn0)
    assert np.array_equal(
        serializer.load_google_model(str(a), binary=True).syn0, m.syn0)


@pytest.mark.parametrize("neg", [0, 4])
def test_full_model_zip_across_packages(tmp_path, neg):
    m, j = _trained(neg)
    a, b = tmp_path / "p.zip", tmp_path / "j.zip"
    serializer.write_full_model(m, str(a))
    jax_ser.write_full_model(j, str(b))
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        assert za.read("config.json") == zb.read("config.json")
        assert za.read("vocab.json") == zb.read("vocab.json")
    # Each package loads the other's zip, and the arrays are the writer's.
    mp = serializer.load_full_model(str(b), device="cpu")
    mj = jax_ser.load_full_model(str(a))
    assert np.array_equal(mp.syn0, np.asarray(j.syn0))
    assert np.array_equal(mj.syn0, m.syn0)
    second = "syn1neg" if neg else "syn1"
    assert np.array_equal(np.asarray(getattr(mj, second)),
                          getattr(m, second).numpy())
    assert _vocab_rows(mp.vocab) == _vocab_rows(j.vocab)


# ---------------------------------------------------------------- GloVe

TOPICS = [["cat", "dog", "pet", "fur", "paw"],
          ["car", "road", "wheel", "drive", "engine"],
          ["sun", "moon", "star", "sky", "orbit"]]


def topic_sentences(n, seed=0, length=12):
    rng = np.random.RandomState(seed)
    return [[t[i] for i in rng.randint(0, 5, length)]
            for t in (TOPICS[rng.randint(3)] for _ in range(n))]


def _mixed_corpus(seed):
    # The three topics over a larger vocab: 3 x 20 words.
    rng = np.random.RandomState(seed)
    return [[f"t{k}w{i}" for i in rng.randint(0, 20, 15)]
            for k in rng.randint(0, 3, 80)]


def test_cooccurrences_equal():
    seqs = [np.asarray(s, np.int32) for s in
            np.random.RandomState(13).randint(0, 30, (25, 14))]
    for win, sym in ((3, True), (5, False)):
        got = glove.CoOccurrences(win, sym).count(seqs)
        want = jax_glove.CoOccurrences(win, sym).count(seqs)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_glove_fit_matches_reference():
    sents = _mixed_corpus(14)
    kw = dict(layer_size=16, window_size=4, epochs=4, seed=5,
              batch_size=256, learning_rate=0.05)
    m = glove.Glove(sents, device="cpu", **kw).fit()
    j = jax_glove.Glove(sents, **kw).fit()
    assert m.vocab.words() == j.vocab.words()
    assert rel(m.syn0, j.syn0) <= FIT_TOL
    assert rel(m.bias, j.bias) <= FIT_TOL
    assert len(m.error_per_epoch) == 4
    assert np.allclose(m.error_per_epoch, j.error_per_epoch, rtol=FIT_TOL,
                       atol=0)
    assert m.error_per_epoch[-1] < m.error_per_epoch[0]
    assert m.hist_w.shape == m.syn0.shape and m.hist_b.shape == m.bias.shape


# ------------------------------------------------------ ParagraphVectors

def _documents(seed, n=45):
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n):
        k = i % 3
        words = [TOPICS[k][j] for j in rng.randint(0, 5, rng.randint(8, 20))]
        docs.append(" ".join(words))
    return docs


@pytest.mark.parametrize("dm", [False, True])
def test_paragraph_vectors_match_reference(dm):
    docs = _documents(15)
    kw = dict(dm=dm, layer_size=16, window_size=3, epochs=2, seed=7,
              batch_size=64, learning_rate=0.05)
    m = pv.ParagraphVectors(docs, device="cpu", **kw).fit()
    j = jax_pv.ParagraphVectors(docs, **kw).fit()
    assert m.labels == j.labels and m.vocab.words() == j.vocab.words()
    assert rel(m.doc_vectors, np.asarray(j.doc_vectors)) <= FIT_TOL
    assert rel(m.syn0, np.asarray(j.syn0)) <= FIT_TOL
    assert rel(m.syn1, np.asarray(j.syn1)) <= FIT_TOL
    assert m.nearest_labels("DOC_0", 3) == j.nearest_labels("DOC_0", 3)
    # infer_vector: the reference's vector, and syn1 bit for bit as it was.
    syn1 = m.syn1.clone()
    text = "cat dog pet fur paw cat"
    got = m.infer_vector(text)
    assert torch.equal(m.syn1, syn1)
    assert rel(got, j.infer_vector(text)) <= OP_TOL
    assert np.array_equal(m.infer_vector("unknown words only"),
                          np.zeros(16, np.float32))


# ---------------------------------------------------------- vectorizers

def test_vectorizers_match_reference():
    docs = [" ".join(s) for s in topic_sentences(30, seed=16)]
    labels = ["a", "b"]
    for pcls, jcls in ((vectorizer.BagOfWordsVectorizer,
                        jax_vec.BagOfWordsVectorizer),
                       (vectorizer.TfidfVectorizer,
                        jax_vec.TfidfVectorizer)):
        p = pcls(min_word_frequency=2, labels=labels)
        j = jcls(min_word_frequency=2, labels=labels)
        assert np.array_equal(p.fit_transform(docs), j.fit_transform(docs))
        assert p.vocab == j.vocab
        ds = p.vectorize(docs[0], "b")
        assert isinstance(ds, DataSet)
        want = j.vectorize(docs[0], "b")
        assert np.array_equal(ds.features, want.features)
        assert np.array_equal(ds.labels, want.labels)
        with pytest.raises(ValueError, match="unknown label"):
            p.vectorize(docs[0], "zz")


# ------------------------------------------------------ carried across

def test_word2vec_carried_from_the_reference_continues():
    s1, s2 = _zipf_corpus(17, 30), _zipf_corpus(18, 30)
    for mode in ("ns_skipgram", "hs_cbow"):
        kw = dict(W2V_KW, **MODES[mode])
        j = jax_w2v.Word2Vec(**kw).fit(s1)
        second = "syn1neg" if kw["negative"] else "syn1"
        m = interop.embeddings_from_numpy(
            "word2vec", {"syn0": np.asarray(j.syn0),
                         second: np.asarray(getattr(j, second))},
            vocab=j.vocab, device="cpu", **kw)
        assert m.words_nearest("w1", 4) == j.words_nearest("w1", 4)
        m.fit(s2)
        j.fit(s2)  # the reference resumes too
        assert rel(m.syn0, j.syn0) <= FIT_TOL
        assert rel(getattr(m, second), np.asarray(getattr(j, second))) \
            <= FIT_TOL


def _glove_batches(rows, cols, vals, B):
    for start in range(0, len(rows), B):
        sl = slice(start, start + B)
        fill = len(rows[sl])
        br, bc = np.zeros(B, np.int32), np.zeros(B, np.int32)
        bv, pm = np.ones(B, np.float32), np.zeros(B, np.float32)
        br[:fill], bc[:fill], bv[:fill], pm[:fill] = (
            rows[sl], cols[sl], vals[sl], 1.0)
        yield br, bc, bv, pm


def test_glove_carried_from_the_reference_continues():
    # The reference's Glove keeps no AdaGrad state after fit, so its
    # trained state comes from its own glove_step over its own batches.
    sents = _mixed_corpus(19)
    j = jax_glove.Glove(sents, layer_size=16, epochs=1, seed=2,
                        batch_size=128).fit()
    seqs = [np.asarray([j.vocab.index_of(x) for x in s], np.int32)
            for s in sents]
    r, c, v = jax_glove.CoOccurrences(5, True).count(seqs)
    state = [jnp.asarray(np.asarray(j.syn0)), jnp.asarray(j.bias),
             jnp.zeros_like(jnp.asarray(np.asarray(j.syn0))),
             jnp.zeros_like(jnp.asarray(j.bias))]
    args = (jnp.float32(0.05), jnp.float32(100.0), jnp.float32(0.75))
    for batch in _glove_batches(r, c, v, 128):
        state = list(jax_glove_op.glove_step(*state, *batch, *args)[:4])
    arrays = dict(zip(("syn0", "bias", "hist_w", "hist_b"),
                      (np.array(a) for a in state)))
    m = interop.embeddings_from_numpy(
        "glove", arrays, vocab=j.vocab, device="cpu", layer_size=16,
        epochs=1, seed=2, batch_size=128, shuffle=False)
    m.fit(sents)  # resumes: the same batches in order, from the histories
    for batch in _glove_batches(r, c, v, 128):
        state = list(jax_glove_op.glove_step(*state, *batch, *args)[:4])
    assert rel(m.syn0, state[0]) <= FIT_TOL
    assert rel(m.bias, state[1]) <= FIT_TOL
    assert rel(m.hist_w, state[2]) <= FIT_TOL
    assert rel(m.hist_b, state[3]) <= FIT_TOL


def test_paragraph_vectors_carried_from_the_reference():
    docs = _documents(20)
    kw = dict(layer_size=16, window_size=3, epochs=1, seed=8, batch_size=64)
    j = jax_pv.ParagraphVectors(docs, **kw).fit()
    m = interop.embeddings_from_numpy(
        "paragraph_vectors",
        {"doc_vectors": np.asarray(j.doc_vectors),
         "syn0": np.asarray(j.syn0), "syn1": np.asarray(j.syn1)},
        vocab=j.vocab, labels=j.labels, device="cpu", **kw)
    assert m.nearest_labels("DOC_3", 5) == j.nearest_labels("DOC_3", 5)
    text = "sun moon star sky"
    assert rel(m.infer_vector(text), j.infer_vector(text)) <= OP_TOL
    assert np.array_equal(m.get_doc_vector("DOC_1"),
                          np.asarray(j.get_doc_vector("DOC_1")))


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown embedding"):
        interop.embeddings_from_numpy("fasttext", {}, device="cpu")


# ------------------------------------------------- the distributed corpus

def test_distributed_corpus_one_process():
    sents = [["b", "a", "b"], ["c", "a", "d", "a"], ["rare"]] + \
        _zipf_corpus(21, 10, v=30)
    pv_, ps = distributed_vocab(sents, min_word_frequency=2)
    jv, js = jax_dist_vocab(sents, min_word_frequency=2)
    assert _vocab_rows(pv_) == _vocab_rows(jv)
    assert [s.tolist() for s in ps] == [s.tolist() for s in js]
    ref = vocab.VocabConstructor(2).build(sents)
    assert _vocab_rows(pv_) == _vocab_rows(ref)
    got = distributed_cooccurrences(ps, window_size=3)
    want = jax_dist_cooc(js, window_size=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CORPUS_WORKER = """
import sys
import numpy as np
import torch.distributed as dist
sys.modules["jax"] = None
sys.modules["deeplearning4j_tpu"] = None
from deeplearning4j_tpu_torch.nlp.distributed_corpus import (
    distributed_cooccurrences, distributed_vocab,
)
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        world_size=2, rank=pid)
corpus = [[f"w{j}" for j in np.random.RandomState(s).randint(0, 20, 12)]
          for s in range(8)]
shard = corpus[pid * 4:(pid + 1) * 4]
if pid == 1:
    shard = [" ".join(s) for s in shard]  # raw text on one rank
vocab, seqs = distributed_vocab(shard, min_word_frequency=2)
r, c, v = distributed_cooccurrences(seqs, window_size=3)
np.savez(out + f".{pid}.npz", words=np.array(vocab.words()),
         freqs=np.array([w.frequency for w in vocab._by_index]),
         codes=np.array([len(w.codes) for w in vocab._by_index]),
         rows=r, cols=c, vals=v, seq0=seqs[0])
dist.destroy_process_group()
"""


def test_distributed_corpus_two_gloo_processes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(CORPUS_WORKER)
    out = str(tmp_path / "out")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), port,
                               out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for pid in (0, 1)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = [np.load(out + f".{pid}.npz") for pid in (0, 1)]
    # One process over the whole corpus: the same vocab and triples on
    # every rank.
    corpus = [[f"w{j}" for j in np.random.RandomState(s).randint(0, 20, 12)]
              for s in range(8)]
    ref, ref_seqs = distributed_vocab(corpus, min_word_frequency=2)
    rr, cc, vv = distributed_cooccurrences(ref_seqs, window_size=3)
    for pid, g in enumerate(got):
        assert g["words"].tolist() == ref.words()
        assert g["freqs"].tolist() == [w.frequency for w in ref._by_index]
        assert g["codes"].tolist() == [len(w.codes) for w in ref._by_index]
        assert g["seq0"].tolist() == ref_seqs[pid * 4].tolist()
        assert np.array_equal(g["rows"], rr) and np.array_equal(g["cols"], cc)
        assert np.allclose(g["vals"], vv, rtol=1e-6, atol=0)
