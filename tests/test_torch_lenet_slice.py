"""The port's LeNet / MNIST-MLP slice against the JAX package, on the CPU:
cnn input types and the input preprocessors, the shape inference that
inserts them, `zoo.lenet_mnist` / `zoo.mlp_mnist`, `MultiLayerNetwork`
`output`, `fit` over an iterator with listeners, `evaluate`, the flat
updater view and `clone`, `Evaluation`, the MNIST and list iterators, and
`load_model` of the reference's model zip.

Small sizes: B=8 (LeNet and the MLP at full width; 3 `fit` steps), MNIST
cut to 300 examples. Params are copied across from the JAX net as numpy
(xavier draws: no symmetry a permuted flatten could hide behind); inputs
are the synthetic MNIST images or seeded numpy draws.

Tolerances: preprocessors 1e-7 (reshapes: equal); `output` rtol = atol =
1e-5 (the same ops, sums in another order); training, f32, per step:
score rtol 2e-4, atol 2e-5, params and the Nesterovs velocity rtol 2e-4,
atol 1e-5, as the earlier training slices. `Evaluation` on identical
arrays is held exactly; `evaluate` on the two nets' outputs only after
checking that the reference's smallest top-1 / top-2 margin exceeds 1e-4
(a near-tie fails loudly instead of flaking). MNIST batches bit for bit.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets import builtin as jax_builtin
from deeplearning4j_tpu.datasets import iterators as jax_iterators
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.eval.evaluation import Evaluation as JaxEvaluation
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf import preprocessors as jax_pre
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize import listeners as jax_listeners
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets import builtin, iterators
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.conf import layers, preprocessors
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    GlobalConf,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import listeners
from deeplearning4j_tpu_torch.util import model_serializer

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
EXACT = dict(rtol=1e-7, atol=1e-7)
FWD = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=2e-4, atol=2e-5)
PARAMS = dict(rtol=2e-4, atol=1e-5)
B, STEPS = 8, 3
MODELS = {"lenet": (jax_zoo.lenet_mnist, zoo.lenet_mnist, False),
          "mlp": (jax_zoo.mlp_mnist, zoo.mlp_mnist, True)}


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package (see
    `tests/test_torch_rnn_slice.py`), and no MNIST files in either
    package's search: both build the synthetic set."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    monkeypatch.delenv("MNIST_DIR", raising=False)
    monkeypatch.setattr(jax_builtin, "_MNIST_SEARCH", [])
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


def _np_tree(tree):
    # np.array copies: the JAX step donates its buffers.
    return {k: ({f: {n: np.array(a) for n, a in s.items()}
                 for f, s in p.items()}
                if isinstance(next(iter(p.values()), None), dict)
                else {n: np.array(a) for n, a in p.items()})
            for k, p in tree.items() if isinstance(p, dict)}


def _nets(model):
    jfn, pfn, _ = MODELS[model]
    jnet = JaxMLN(jfn()).init()
    pnet = MultiLayerNetwork(pfn(), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    return jnet, pnet


def _mnist(model, n=B, seed=0, train=True):
    ds = builtin.load_mnist(train=train, num_examples=n, seed=123 + seed,
                            flat=MODELS[model][2])
    return ds.features, ds.labels


def _assert_trees(port_tree, jax_tree, what, tol):
    for k, p in jax_tree.items():
        for n, a in p.items():
            np.testing.assert_allclose(port_tree[k][n].detach().numpy(), a,
                                       err_msg=f"{what} {k}/{n}", **tol)


def _types_equal(port_type, jax_type):
    return port_type.to_dict() == jax_type.to_dict()


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("model", sorted(MODELS))
def test_zoo_conf_matches_the_reference_json(model):
    jfn, pfn, _ = MODELS[model]
    jconf = jfn()
    ref = MultiLayerConfiguration.from_json(jconf.to_json())
    got = pfn()
    assert got == ref
    assert [(type(x).__name__, getattr(x, "n_in", None),
             getattr(x, "n_out", None)) for x in got.layers] == [
        (type(x).__name__, getattr(x, "n_in", None),
         getattr(x, "n_out", None)) for x in jconf.layers]
    assert {i: p.to_dict() for i, p in got.input_preprocessors.items()} == {
        i: p.to_dict() for i, p in jconf.input_preprocessors.items()}
    assert MultiLayerNetwork(got, device="cpu").num_params() == \
        JaxMLN(jconf).num_params() == {"lenet": 431080, "mlp": 795010}[model]


def test_lenet_gets_one_cnn_to_feed_forward_preprocessor():
    conf = zoo.lenet_mnist()
    assert conf.input_preprocessors == {
        4: preprocessors.CnnToFeedForwardPreProcessor(4, 4, 50)}
    assert conf.layers[4].n_in == 800
    assert [x.convolution_mode for x in conf.layers[:4]] == ["truncate"] * 4


@pytest.mark.parametrize("kind", ["ff", "rnn", "cnn", "cnnflat"])
def test_input_types_match_the_reference(kind):
    make = {"ff": ("feed_forward", (7,)), "rnn": ("recurrent", (7, 9)),
            "cnn": ("convolutional", (5, 6, 3)),
            "cnnflat": ("convolutional_flat", (5, 6, 3))}[kind]
    got = getattr(InputType, make[0])(*make[1])
    want = getattr(JaxInputType, make[0])(*make[1])
    assert _types_equal(got, want)
    assert got.flat_size() == want.flat_size()
    assert _types_equal(InputType.from_dict(want.to_dict()),
                        JaxInputType.from_dict(want.to_dict()))


_PRE_CASES = [  # (class, kwargs, input shape, input type)
    ("CnnToFeedForwardPreProcessor", (4, 3, 5), (2, 4, 3, 5),
     JaxInputType.convolutional(4, 3, 5)),
    ("FeedForwardToCnnPreProcessor", (4, 3, 5), (2, 60),
     JaxInputType.convolutional_flat(4, 3, 5)),
    ("FeedForwardToRnnPreProcessor", (), (2, 6, 7),
     JaxInputType.feed_forward(7)),
    ("RnnToFeedForwardPreProcessor", (), (2, 6, 7),
     JaxInputType.recurrent(7, 6)),
    ("CnnToRnnPreProcessor", (4, 3, 5), (2, 4, 3, 5),
     JaxInputType.convolutional(4, 3, 5)),
    ("CnnToRnnPreProcessor", (4, 3, 5), (2, 6, 4, 3, 5),
     JaxInputType.convolutional(4, 3, 5)),
    ("RnnToCnnPreProcessor", (4, 3, 5), (2, 6, 60),
     JaxInputType.recurrent(60, 6)),
    ("ReshapePreProcessor", ((3, 20),), (2, 60),
     JaxInputType.feed_forward(60)),
]


@pytest.mark.parametrize("case", range(len(_PRE_CASES)))
def test_preprocessor_forward_and_output_type_match_jax(case):
    name, args, shape, itype = _PRE_CASES[case]
    jp = getattr(jax_pre, name)(*args)
    pp = preprocessors.preprocessor_from_dict(jp.to_dict())
    assert type(pp).__name__ == name and pp.to_dict() == jp.to_dict()
    rng = np.random.RandomState(case)
    x = rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(2, 6) > 0.3).astype(np.float32)
    want, wmask = jp(x, mask)
    got, gmask = pp(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    port_type = InputType.from_dict(itype.to_dict())
    assert _types_equal(pp.get_output_type(port_type),
                        jp.get_output_type(itype))


def test_composable_preprocessor_matches_jax():
    jp = jax_pre.ComposableInputPreProcessor(
        jax_pre.CnnToFeedForwardPreProcessor(4, 3, 5),
        jax_pre.ReshapePreProcessor((5, 12)))
    pp = preprocessors.preprocessor_from_dict(jp.to_dict())
    assert pp.to_dict() == jp.to_dict()
    assert pp == preprocessors.ComposableInputPreProcessor(
        preprocessors.CnnToFeedForwardPreProcessor(4, 3, 5),
        preprocessors.ReshapePreProcessor((5, 12)))
    x = np.random.RandomState(3).randn(2, 4, 3, 5).astype(np.float32)
    np.testing.assert_allclose(pp(torch.tensor(x))[0].numpy(),
                               np.asarray(jp(x)[0]), **EXACT)
    itype = JaxInputType.convolutional(4, 3, 5)
    assert _types_equal(
        pp.get_output_type(InputType.from_dict(itype.to_dict())),
        jp.get_output_type(itype))
    with pytest.raises(ValueError, match="unknown preprocessor"):
        preprocessors.preprocessor_from_dict({"@class": "Nope"})


_SHAPE_CASES = [  # (layer class, kwargs, input type)
    ("ConvolutionLayer", dict(kernel_size=(5, 5), n_out=20),
     JaxInputType.convolutional(28, 28, 1)),
    ("ConvolutionLayer", dict(kernel_size=(3, 3), stride=(2, 2), n_out=8,
                              convolution_mode="same"),
     JaxInputType.convolutional(15, 9, 4)),
    ("ConvolutionLayer", dict(kernel_size=(3, 3), stride=(2, 1),
                              padding=(1, 0), n_out=8,
                              convolution_mode="truncate"),
     JaxInputType.convolutional(16, 9, 4)),
    ("ConvolutionLayer", dict(kernel_size=(5, 5), n_out=6),
     JaxInputType.convolutional_flat(28, 28, 1)),
    ("SubsamplingLayer", dict(kernel_size=(2, 2), stride=(2, 2)),
     JaxInputType.convolutional(24, 24, 20)),
    ("SubsamplingLayer", dict(kernel_size=(3, 3), stride=(2, 2),
                              convolution_mode="same"),
     JaxInputType.convolutional(13, 13, 7)),
    ("DenseLayer", dict(n_out=500), JaxInputType.convolutional(4, 4, 50)),
    ("DenseLayer", dict(n_out=5), JaxInputType.recurrent(7, 9)),
    ("OutputLayer", dict(n_out=10), JaxInputType.feed_forward(500)),
    ("RnnOutputLayer", dict(n_out=10), JaxInputType.feed_forward(30)),
    ("BatchNormalization", dict(), JaxInputType.convolutional(6, 6, 12)),
    ("BatchNormalization", dict(), JaxInputType.feed_forward(12)),
    ("GravesLSTM", dict(n_out=8), JaxInputType.feed_forward(5)),
    ("GravesLSTM", dict(n_out=8), JaxInputType.convolutional(3, 2, 4)),
    ("GravesLSTM", dict(n_out=8), JaxInputType.recurrent(5, 11)),
    ("GlobalPoolingLayer", dict(), JaxInputType.convolutional(7, 7, 9)),
    ("ActivationLayer", dict(), JaxInputType.feed_forward(9)),
    ("LayerNormalization", dict(), JaxInputType.recurrent(16, 4)),
    ("SelfAttentionLayer", dict(n_out=16, n_heads=2),
     JaxInputType.feed_forward(16)),
]


@pytest.mark.parametrize("case", range(len(_SHAPE_CASES)))
def test_layer_shape_inference_matches_the_reference(case):
    cls, kwargs, itype = _SHAPE_CASES[case]
    jl = getattr(jax_layers, cls)(**kwargs)
    pl = layers.layer_from_dict(jl.to_dict())
    ptype = InputType.from_dict(itype.to_dict())
    jpre, ppre = jl.default_preprocessor(itype), pl.default_preprocessor(ptype)
    assert (None if jpre is None else jpre.to_dict()) == (
        None if ppre is None else ppre.to_dict())
    if jpre is not None:
        itype = jpre.get_output_type(itype)
        ptype = ppre.get_output_type(ptype)
    jl.set_n_in(itype, override=True)
    pl.set_n_in(ptype, override=True)
    assert (getattr(pl, "n_in", None), getattr(pl, "n_out", None)) == (
        getattr(jl, "n_in", None), getattr(jl, "n_out", None))
    assert _types_equal(pl.get_output_type(ptype), jl.get_output_type(itype))


def test_strict_convolution_mode_refuses_what_does_not_tile():
    conv = layers.ConvolutionLayer(kernel_size=(3, 3), stride=(2, 2),
                                   n_out=4, convolution_mode="strict")
    assert conv.get_output_type(InputType.convolutional(9, 9, 1)) == \
        InputType.convolutional(4, 4, 4)
    with pytest.raises(ValueError, match="STRICT"):
        conv.get_output_type(InputType.convolutional(8, 8, 1))


def test_build_with_an_explicit_preprocessor_matches_the_reference():
    # An explicit preprocessor wins over the automatic one, and its output
    # type sizes the layer.
    jconf = (NeuralNetConfiguration.builder().seed(3).l2(1e-3).list()
             .layer(jax_layers.DenseLayer(n_out=6, activation="tanh"))
             .layer(jax_layers.GravesLSTM(n_out=5, activation="tanh"))
             .layer(jax_layers.RnnOutputLayer(n_out=4, activation="softmax"))
             .input_preprocessor(0, jax_pre.CnnToFeedForwardPreProcessor(
                 3, 3, 2))
             .input_preprocessor(1, jax_pre.FeedForwardToRnnPreProcessor())
             .set_input_type(JaxInputType.convolutional(3, 3, 2))
             .build())
    got = MultiLayerConfiguration.build(
        GlobalConf(seed=3, l2=1e-3),
        [layers.DenseLayer(n_out=6, activation="tanh"),
         layers.GravesLSTM(n_out=5, activation="tanh"),
         layers.RnnOutputLayer(n_out=4, activation="softmax")],
        InputType.convolutional(3, 3, 2),
        input_preprocessors={
            0: preprocessors.CnnToFeedForwardPreProcessor(3, 3, 2),
            1: preprocessors.FeedForwardToRnnPreProcessor()})
    assert got == MultiLayerConfiguration.from_json(jconf.to_json())
    assert [x.n_in for x in got.layers] == [18, 6, 5]


# ------------------------------------------------------------ network


@pytest.mark.parametrize("model", sorted(MODELS))
def test_output_matches_jax(model):
    jnet, pnet = _nets(model)
    x, _ = _mnist(model, seed=1)
    kernels.reset_counts()
    got = pnet.output(x)
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    for g, w in zip(pnet.feed_forward(x), jnet.feed_forward(x)):
        np.testing.assert_allclose(g, np.asarray(w), **FWD)
    assert not any(kernels.counts()["launches"].values())


class _ChwFlatten(preprocessors.InputPreProcessor):
    """A CnnToFeedForward that flattens (c, h, w): the NCHW view's order."""

    def __call__(self, x, mask=None):
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1), mask


def test_lenet_flattens_h_w_c_as_the_reference():
    # The dense layer's 800 W rows follow the reference's (h, w, c)
    # flatten; the (c, h, w) order of the NCHW view would permute them.
    jnet, pnet = _nets("lenet")
    x = np.random.RandomState(2).rand(B, 28, 28, 1).astype(np.float32)
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(pnet.output(x), want, **FWD)
    pnet.conf.input_preprocessors[4] = _ChwFlatten()
    assert float(np.abs(pnet.output(x) - want).max()) > 1e-3


@pytest.fixture(scope="module")
def fit_run():
    """Three `fit` steps of each model at B=8 on the same nets, each step's
    score, params and Nesterovs velocity recorded on both sides."""
    out = {}
    for model in sorted(MODELS):
        jnet, pnet = _nets(model)
        rec = []
        kernels.reset_counts()
        for i in range(STEPS):
            x, y = _mnist(model, seed=10 + i)
            jnet.fit(JaxDataSet(x, y))
            pnet.fit(DataSet(x, y))
            rec.append((jnet.score_value, pnet.score_value,
                        _np_tree(jnet.params_tree),
                        {k: s["v"] for k, s in _np_tree(jnet.opt_state).items()
                         if "v" in s},
                        {k: {n: a.detach().clone() for n, a in p.items()}
                         for k, p in pnet.params_tree.items()},
                        {k: {n: a.clone() for n, a in s["v"].items()}
                         for k, s in pnet.opt_state.items()}))
        out[model] = dict(jnet=jnet, pnet=pnet, rec=rec,
                          counts=kernels.counts())
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fit_matches_jax_step_by_step(fit_run, model):
    r = fit_run[model]
    for i, (js, ps, jp, jv, pp, pv) in enumerate(r["rec"]):
        np.testing.assert_allclose(ps, js, err_msg=f"score {i}", **F32)
        _assert_trees(pp, jp, f"params after step {i}", PARAMS)
        _assert_trees(pv, jv, f"velocity after step {i}", PARAMS)
    assert r["pnet"].iteration == r["jnet"].iteration == STEPS


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fit_update_calls_and_flat_updater_view(fit_run, model):
    # One plain update per layer with params per step on the CPU (the card
    # launches one kernel for all of them); the flat updater view in the
    # reference's leaf order.
    r = fit_run[model]
    n_layers = {"lenet": 4, "mlp": 2}[model]
    assert r["counts"]["plain_calls"]["fused_update"] == STEPS * n_layers
    assert not any(r["counts"]["launches"].values())
    flat = r["pnet"].updater_state_flat()
    np.testing.assert_allclose(flat, np.asarray(r["jnet"].updater_state_flat()),
                               **PARAMS)
    assert flat.dtype == np.float32 and flat.size == r["pnet"].num_params()


def test_set_updater_state_flat_writes_the_reference_order():
    jnet, pnet = _nets("lenet")
    x, y = _mnist("lenet", seed=4)
    jnet.fit(JaxDataSet(x, y))
    flat = np.asarray(jnet.updater_state_flat())
    pnet.set_updater_state_flat(flat)
    np.testing.assert_array_equal(pnet.updater_state_flat(), flat)
    jv = {k: s["v"] for k, s in _np_tree(jnet.opt_state).items() if "v" in s}
    _assert_trees({k: s["v"] for k, s in pnet.opt_state.items()}, jv,
                  "velocity", EXACT)
    with pytest.raises(ValueError, match="updater state length"):
        pnet.set_updater_state_flat(flat[:-1])


def test_clone_copies_and_never_aliases():
    _, pnet = _nets("mlp")
    x, y = _mnist("mlp", seed=5)
    pnet.fit(DataSet(x, y))
    twin = pnet.clone()
    assert twin.iteration == pnet.iteration == 1 and twin.epoch == 1
    np.testing.assert_array_equal(twin.params(), pnet.params())
    np.testing.assert_array_equal(twin.updater_state_flat(),
                                  pnet.updater_state_flat())
    before = twin.output(x)
    pnet.fit(DataSet(x, y))
    np.testing.assert_array_equal(twin.output(x), before)
    assert not np.array_equal(pnet.output(x), before)
    twin.fit(DataSet(x, y))
    np.testing.assert_array_equal(twin.params(), pnet.params())
    assert "Total params: 795010" in twin.summary()


# ----------------------------------------------------------- evaluation


def _eval_cases():
    rng = np.random.RandomState(7)
    probs = rng.dirichlet(np.ones(5), size=40).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 40)]
    seq = rng.dirichlet(np.ones(4), size=(6, 7)).astype(np.float32)
    seq_ids = rng.randint(0, 4, (6, 7))
    seq_mask = (rng.rand(6, 7) > 0.3).astype(np.float32)
    row_mask = (rng.rand(40) > 0.2).astype(np.float32)
    return {
        "onehot": [(onehot, probs, None)],
        "sparse": [(onehot.argmax(-1), probs, None)],
        "masked_rows": [(onehot, probs, row_mask)],
        "sequence": [(np.eye(4, dtype=np.float32)[seq_ids], seq, seq_mask)],
        "sparse_sequence": [(seq_ids, seq, seq_mask)],
        "two_batches": [(onehot[:25], probs[:25], None),
                        (onehot[25:], probs[25:], None)],
    }


@pytest.mark.parametrize("top_n", [1, 3])
@pytest.mark.parametrize("case", sorted(_eval_cases()))
def test_evaluation_counts_and_stats_equal_the_reference(case, top_n):
    got, want = Evaluation(top_n=top_n), JaxEvaluation(top_n=top_n)
    for labels, preds, mask in _eval_cases()[case]:
        got.eval(labels, preds, mask=mask)
        want.eval(labels, preds, mask=mask)
    np.testing.assert_array_equal(got.confusion.matrix,
                                  want.confusion.matrix)
    assert (got.total, got.top_n_correct) == (want.total, want.top_n_correct)
    assert got.stats() == want.stats()
    for c in range(got.num_classes):
        assert (got.precision(c), got.recall(c), got.f1(c),
                got.false_positive_rate(c)) == (
            want.precision(c), want.recall(c), want.f1(c),
            want.false_positive_rate(c))
    merged, jmerged = Evaluation().merge(got), JaxEvaluation().merge(want)
    assert merged.accuracy() == jmerged.accuracy() == got.accuracy()


def test_evaluation_takes_tensors_and_refuses_bad_ids():
    ev = Evaluation()
    ev.eval(torch.tensor([0, 2]), torch.tensor([[0.9, 0.05, 0.05],
                                                [0.2, 0.3, 0.5]]))
    assert ev.accuracy() == 1.0 and ev.total == 2
    with pytest.raises(ValueError, match="class ids"):
        Evaluation().eval(np.array([3]), np.ones((1, 3), np.float32))


def _min_margin(probs):
    s = np.sort(probs, axis=-1)
    return float((s[:, -1] - s[:, -2]).min())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_evaluate_counts_equal_the_reference(model):
    jnet, pnet = _nets(model)
    flat = MODELS[model][2]
    it = builtin.MnistDataSetIterator(16, num_examples=64, train=False,
                                      flat=flat)
    jit = jax_builtin.MnistDataSetIterator(16, num_examples=64, train=False,
                                           flat=flat)
    for ds in jit:  # the near-tie guard, on the reference's outputs
        assert _min_margin(np.asarray(jnet.output(ds.features))) > 1e-4
    got, want = pnet.evaluate(it, top_n=2), jnet.evaluate(jit, top_n=2)
    np.testing.assert_array_equal(got.confusion.matrix,
                                  want.confusion.matrix)
    assert (got.total, got.top_n_correct) == (want.total,
                                              want.top_n_correct) == (
        64, want.top_n_correct)
    one = pnet.evaluate(DataSet(*_mnist(model, n=16, train=False)))
    assert one.total == 16


# ------------------------------------------------------------- datasets


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_mnist_batches_are_bit_equal_to_the_reference(train, flat):
    got = builtin.MnistDataSetIterator(128, num_examples=300, train=train,
                                       flat=flat)
    want = jax_builtin.MnistDataSetIterator(128, num_examples=300,
                                            train=train, flat=flat)
    gb, wb = list(got), list(want)
    assert [b.num_examples() for b in gb] == [128, 128, 44]
    assert len(gb) == len(wb)
    for g, w in zip(gb, wb):
        assert g.features.dtype == w.features.dtype == np.float32
        np.testing.assert_array_equal(g.features, w.features)
        np.testing.assert_array_equal(g.labels, w.labels)
    assert got.total_examples() == 300 and got.batch_size() == 128


def test_mnist_full_sets_match_the_reference_in_size_and_sum():
    for train, n in ((True, 60000), (False, 10000)):
        got = builtin.load_mnist(train=train)
        want = jax_builtin.load_mnist(train=train)
        assert got.features.shape == want.features.shape == (n, 28, 28, 1)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert float(got.features.sum(dtype=np.float64)) == float(
            want.features.sum(dtype=np.float64))


def test_mnist_reads_idx_files_from_mnist_dir(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, 5).astype(np.uint8)

    def write(name, magic, arr):
        with open(tmp_path / name, "wb") as f:
            f.write(magic.to_bytes(4, "big"))
            for d in arr.shape:
                f.write(int(d).to_bytes(4, "big"))
            f.write(arr.tobytes())

    write("t10k-images-idx3-ubyte", 0x0803, imgs)
    write("t10k-labels-idx1-ubyte", 0x0801, labs)
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    ds = builtin.load_mnist(train=False, flat=True)
    np.testing.assert_array_equal(
        ds.features, imgs.reshape(5, -1).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(ds.labels.argmax(-1), labs)
    np.testing.assert_array_equal(
        builtin._read_idx(str(tmp_path / "t10k-images-idx3-ubyte")),
        jax_builtin._read_idx(str(tmp_path / "t10k-images-idx3-ubyte")))


@pytest.mark.parametrize("source", ["dataset", "list"])
def test_list_iterator_shuffles_as_the_reference(source):
    rng = np.random.RandomState(1)
    x = rng.randn(50, 3).astype(np.float32)
    y = rng.randn(50, 2).astype(np.float32)
    m = (rng.rand(50, 4) > 0.5).astype(np.float32)
    if source == "dataset":
        got = iterators.ListDataSetIterator(DataSet(x, y, m, m), 16,
                                            shuffle=True, seed=9)
        want = jax_iterators.ListDataSetIterator(JaxDataSet(x, y, m, m), 16,
                                                 shuffle=True, seed=9)
    else:
        got = iterators.ListDataSetIterator(
            DataSet(x, y).batch_by(7), shuffle=True, seed=9)
        want = jax_iterators.ListDataSetIterator(
            JaxDataSet(x, y).batch_by(7), shuffle=True, seed=9)
    for _ in range(2):  # a new permutation each pass, the same on both
        for g, w in zip(list(got), list(want), strict=True):
            np.testing.assert_array_equal(g.features, w.features)
            np.testing.assert_array_equal(g.labels, w.labels)
            if source == "dataset":
                np.testing.assert_array_equal(g.features_mask,
                                              w.features_mask)
    assert got.total_examples() == want.total_examples() == 50


def test_iris_matches_the_reference():
    got, want = builtin.load_iris(), jax_builtin.load_iris()
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    batches = list(builtin.IrisDataSetIterator(batch_size=50,
                                               num_examples=120))
    assert [b.num_examples() for b in batches] == [50, 50, 20]


def test_maybe_reset():
    class NoReset:
        def reset(self):
            raise NotImplementedError

    class Broken:
        def reset(self):
            raise RuntimeError("half-run")

    assert iterators.maybe_reset(iterators.ListDataSetIterator([]))
    assert not iterators.maybe_reset([])
    assert not iterators.maybe_reset(NoReset())
    assert not iterators.maybe_reset(Broken())


# ------------------------------------------------------------ listeners


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.events = []

        def iteration_done(self, model, iteration):
            self.events.append(("iteration", iteration))

        def on_epoch_start(self, model):
            self.events.append(("start", model.epoch))

        def on_epoch_end(self, model):
            self.events.append(("end", model.epoch))

    return Recorder()


def _small_conf(iterations):
    jconf = (NeuralNetConfiguration.builder().seed(5).learning_rate(0.05)
             .updater("nesterovs").momentum(0.9).iterations(iterations)
             .list()
             .layer(jax_layers.DenseLayer(n_out=6, activation="tanh"))
             .layer(jax_layers.OutputLayer(n_out=3, activation="softmax",
                                           loss_function="mcxent"))
             .set_input_type(JaxInputType.feed_forward(4))
             .build())
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


@pytest.mark.parametrize("iterations", [1, 2])
def test_listener_hooks_fire_as_the_reference(iterations):
    jconf, pconf = _small_conf(iterations)
    jnet = JaxMLN(jconf).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    ds = builtin.load_iris()
    x, y = ds.features[:60, :4], ds.labels[:60]
    jrec, prec = _recorder(jax_listeners.IterationListener), _recorder(
        listeners.IterationListener)
    jcol = jax_listeners.CollectScoresIterationListener(1)
    pcol = listeners.CollectScoresIterationListener(1)
    jlog, plog = [], []
    jnet.set_listeners(jax_listeners.ComposableIterationListener(
        jrec, jcol, jax_listeners.ScoreIterationListener(2, out=jlog.append)))
    assert pnet.set_listeners(listeners.ComposableIterationListener(
        prec, pcol, listeners.ScoreIterationListener(2, out=plog.append))) \
        is pnet
    for _ in range(2):
        jnet.fit(jax_iterators.ListDataSetIterator(JaxDataSet(x, y), 25))
        pnet.fit(iterators.ListDataSetIterator(DataSet(x, y), 25))
    assert prec.events == jrec.events
    assert prec.events[0] == ("start", 0) and prec.events[-1] == ("end", 2)
    assert [i for i, _ in pcol.scores] == [i for i, _ in jcol.scores] == \
        list(range(1, 6 * iterations + 1))
    np.testing.assert_allclose([s for _, s in pcol.scores],
                               [s for _, s in jcol.scores], **F32)
    assert [line.split(" is ")[0] for line in plog] == \
        [line.split(" is ")[0] for line in jlog]
    assert pnet.iteration == jnet.iteration and pnet.epoch == jnet.epoch


def test_performance_listener_reports_each_interval():
    _, pconf = _small_conf(1)
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    out = []
    perf = listeners.PerformanceListener(2, report_score=True, out=out.append,
                                         sync=True)
    pnet.set_listeners(perf)
    ds = builtin.load_iris()
    pnet.fit(iterators.ListDataSetIterator(
        DataSet(ds.features[:50], ds.labels[:50]), 10))
    # Iteration 1 starts the clock; 3 and 5 end an interval each.
    assert len(out) == 2 and out[0].startswith("iteration 3: ")
    assert "score" in out[0] and perf.last_batches_per_sec > 0
    assert np.isnan(perf.last_samples_per_sec)


# ------------------------------------------------------------ model zip


def _golden_data():
    r = np.random.RandomState(77)
    return r.randn(12, 5).astype("float32")


def test_load_model_reproduces_the_golden_zip():
    # The reference's committed zip: Adam state, dropout 0.8 on layer 0
    # (inference ignores it), iteration 5.
    with open(os.path.join(FIXTURES, "golden_expect_v1.json")) as f:
        exp = json.load(f)
    net = model_serializer.load_model(
        os.path.join(FIXTURES, "golden_model_v1.zip"), device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    assert net.iteration == exp["iteration"] and net.epoch == 5
    assert net.params().size == exp["params_sha_len"]
    np.testing.assert_allclose(net.params()[:16], exp["params_first16"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(net.updater_state_flat()[:16],
                               exp["updater_first16"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(net.output(_golden_data()),
                               np.asarray(exp["output"]), rtol=1e-5,
                               atol=1e-6)
    fresh = model_serializer.load_model(
        os.path.join(FIXTURES, "golden_model_v1.zip"), load_updater=False,
        device="cpu")
    assert not fresh.updater_state_flat().any()


def _bn_conf():
    return (NeuralNetConfiguration.builder().seed(11).learning_rate(0.05)
            .updater("nesterovs").momentum(0.9).l2(1e-3).list()
            .layer(jax_layers.ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                               activation="identity"))
            .layer(jax_layers.BatchNormalization(activation="relu"))
            .layer(jax_layers.SubsamplingLayer(kernel_size=(2, 2),
                                               stride=(2, 2)))
            .layer(jax_layers.OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"))
            .set_input_type(JaxInputType.convolutional_flat(8, 8, 1))
            .build())


@pytest.mark.parametrize("model", ["lenet", "bn"])
def test_load_model_of_a_reference_zip_after_two_steps(tmp_path, model):
    # The reference trains 2 steps and writes its zip; the port loads
    # params, updater state, BatchNorm running statistics (state.npz) and
    # the counters, and computes the same output.
    if model == "lenet":
        jnet = JaxMLN(jax_zoo.lenet_mnist()).init()
        x, y = _mnist("lenet", seed=6)
    else:
        jnet = JaxMLN(_bn_conf()).init()
        rng = np.random.RandomState(6)
        x = rng.rand(B, 64).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, B)]
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y))
    path = str(tmp_path / "model.zip")
    jax_serializer.save_model(jnet, path)
    net = model_serializer.load_model(path, device="cpu")
    assert (net.iteration, net.epoch) == (2, 2)
    np.testing.assert_array_equal(net.params(), np.asarray(jnet.params()))
    np.testing.assert_array_equal(net.updater_state_flat(),
                                  np.asarray(jnet.updater_state_flat()))
    if model == "bn":
        assert set(net.state) == {"layer_1"}
        _assert_trees(net.state, _np_tree(jnet.state), "running stats",
                      EXACT)
        assert net.conf.input_preprocessors == {
            0: preprocessors.FeedForwardToCnnPreProcessor(8, 8, 1),
            3: preprocessors.CnnToFeedForwardPreProcessor(3, 3, 4)}
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **FWD)


def test_save_model_raises_and_writes_nothing(tmp_path):
    # A net without params is refused before the zip is opened.
    path = tmp_path / "model.zip"
    with pytest.raises(RuntimeError, match="init"):
        model_serializer.save_model(
            MultiLayerNetwork(zoo.mlp_mnist(), device="cpu"), str(path))
    assert not path.exists()


@pytest.mark.parametrize("model", ["lenet", "bn"])
def test_save_model_writes_a_zip_the_reference_loads(tmp_path, model):
    # Two port steps, then the port's zip: the reference reads params,
    # updater state, running statistics and counters, and computes the
    # same output within 1e-6.
    if model == "lenet":
        _, pnet = _nets("lenet")
        x, y = _mnist("lenet", seed=8)
    else:
        pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            _bn_conf().to_json()), device="cpu").init()
        rng = np.random.RandomState(8)
        x = rng.rand(B, 64).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, B)]
    for _ in range(2):
        pnet.fit(DataSet(x, y))
    path = str(tmp_path / "model.zip")
    model_serializer.save_model(pnet, path)
    jnet = jax_serializer.load_model(path)
    assert (jnet.iteration, jnet.epoch) == (2, 2)
    np.testing.assert_array_equal(np.asarray(jnet.params()), pnet.params())
    np.testing.assert_array_equal(np.asarray(jnet.updater_state_flat()),
                                  pnet.updater_state_flat())
    if model == "bn":
        _assert_trees(pnet.state, _np_tree(jnet.state), "running stats",
                      EXACT)
    np.testing.assert_allclose(np.asarray(jnet.output(x)), pnet.output(x),
                               rtol=1e-6, atol=1e-6)


def test_load_model_refuses_a_graph_zip(tmp_path):
    # A graph zip whose coefficients do not fit its configuration.
    net = ComputationGraph(zoo.transformer_lm(16, t=8, d_model=8, n_heads=2,
                                              n_blocks=1),
                           device="cpu").init()
    path = str(tmp_path / "graph.zip")
    model_serializer.save_model(net, path)
    cut = str(tmp_path / "cut.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(cut, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            dst.writestr(name, data[:-8] if name == "coefficients.bin"
                         else data)
    with pytest.raises(ValueError, match="flat param length"):
        model_serializer.load_model(cut, device="cpu")
