"""The rest of the layers (dropout, DropConnect, `DropoutLayer`, LRN,
dilation, masked global pooling) and the train-time key chain, in the port
against the JAX package, on the CPU.

Dropout is held two ways:

- exactly, with the port's one draw function (`nn/layers/common.py`
  `draw_keep`) swapped for one that returns the reference's own masks,
  `jax.random.bernoulli` at the reference's key for that layer: then the
  train-mode forward and the gradients of each layer, and whole `fit`
  steps, must equal the reference's. That pins where a mask applies
  (input against W, none on W under DropConnect's input, never RW).
- statistically, on the port's own generator: keep share, scaling,
  independence across layers and steps, nothing drawn at inference, and a
  resumed run equal to the uninterrupted one bit for bit.

Small sizes, inputs and params from seeded numpy, f32. Tolerances: a
layer's forward and gradients rtol 2e-4, atol 1e-6; `fit` steps rtol
2e-4, atol 1e-5 (as the earlier training slices); LRN, dilation and
pooling rtol = atol = 1e-5; the keys and the resume exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.nn import layers as jax_impls
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import layers as impls
from deeplearning4j_tpu_torch.nn import prng
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import common
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

LAYER = dict(rtol=2e-4, atol=1e-6)
STEP = dict(rtol=2e-4, atol=1e-5)
FWD = dict(rtol=1e-5, atol=1e-5)
RETAIN = 0.6


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


def jax_draw(key, retain, shape, device):
    """The reference's mask for the layer `key` names."""
    keep = jax.random.bernoulli(jnp.asarray(key.words), retain, tuple(shape))
    return torch.from_numpy(np.array(keep)).to(device)


@pytest.fixture
def reference_masks(monkeypatch):
    monkeypatch.setattr(common, "draw_keep", jax_draw)


def _np_tree(tree):
    # np.array copies: the JAX step donates its buffers.
    return {k: ({f: {n: np.array(a) for n, a in s.items()}
                 for f, s in p.items()}
                if isinstance(next(iter(p.values()), None), dict)
                else {n: np.array(a) for n, a in p.items()})
            for k, p in tree.items() if isinstance(p, dict)}


def jax_key(jnet):
    """The reference's key continuation (its device clock holds it between
    steps)."""
    return np.asarray(jnet._train_rng if jnet._clock is None
                      else jnet._clock[1])


def _assert_trees(port_tree, jax_tree, what, tol):
    for k, p in jax_tree.items():
        for n, a in p.items():
            got = port_tree[k][n]
            if isinstance(got, dict):
                _assert_trees({n: got}, {n: a}, f"{what} {k}", tol)
                continue
            np.testing.assert_allclose(got.detach().numpy(), a,
                                       err_msg=f"{what} {k}/{n}", **tol)


# ------------------------------------------------------------ the key chain

@pytest.mark.parametrize("seed", [0, 123, 12345, 2 ** 32 + 3])
def test_key_chain_is_jax_random_split(seed):
    key, jkey = prng.prng_key(seed ^ 0x5EED), jax.random.PRNGKey(
        seed ^ 0x5EED)
    for _ in range(4):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(key, np.asarray(jkey))
        np.testing.assert_array_equal(sub, np.asarray(jsub))
        for i in (0, 1, 5, 31):
            lk = prng.LayerKey(sub, i)
            want = jax.random.fold_in(jsub, i)
            np.testing.assert_array_equal(lk.words, np.asarray(want))
            f, b = lk.split()
            jf, jb = jax.random.split(want)
            np.testing.assert_array_equal(f.words, np.asarray(jf))
            np.testing.assert_array_equal(b.words, np.asarray(jb))


# ------------------------------------------------- one layer, exact masks

def _layer(kind, mode):
    """(JAX conf, port conf, input shape) of one layer case."""
    dc = dict(dropout=RETAIN, use_drop_connect=mode == "drop_connect")
    lstm = dict(n_in=4, n_out=5, **dc)
    cases = {
        "dense": ("DenseLayer", dict(n_in=6, n_out=5, activation="tanh",
                                     **dc), (4, 6)),
        "output": ("OutputLayer", dict(n_in=6, n_out=3, **dc), (4, 6)),
        "conv": ("ConvolutionLayer", dict(
            n_in=3, n_out=4, kernel_size=(3, 3), stride=(1, 1),
            convolution_mode="same", activation="relu", **dc),
            (2, 7, 7, 3)),
        "graves_lstm": ("GravesLSTM", lstm, (3, 5, 4)),
        "lstm": ("LSTM", lstm, (3, 5, 4)),
        "bidirectional": ("GravesBidirectionalLSTM", lstm, (3, 5, 4)),
        "simple_rnn": ("SimpleRnn", dict(n_in=4, n_out=5,
                                         activation="tanh", **dc),
                       (3, 5, 4)),
        "attention": ("SelfAttentionLayer", dict(
            n_in=8, n_out=8, n_heads=2, causal=False, dropout=RETAIN),
            (2, 6, 8)),
        "layernorm": ("LayerNormalization", dict(n_in=6, n_out=6,
                                                 dropout=RETAIN), (4, 6)),
        "dropout_layer": ("DropoutLayer", dict(n_in=6, n_out=6,
                                               dropout=RETAIN), (4, 6)),
    }
    name, kw, shape = cases[kind]
    return getattr(jax_layers, name)(**kw), getattr(layers, name)(**kw), shape


LAYER_CASES = [(k, m) for k in ("dense", "output", "conv", "graves_lstm",
                                "lstm", "bidirectional", "simple_rnn")
               for m in ("dropout", "drop_connect")] + [
    ("attention", "dropout"), ("layernorm", "dropout"),
    ("dropout_layer", "dropout")]


@pytest.mark.parametrize("kind,mode", LAYER_CASES,
                         ids=[f"{k}-{m}" for k, m in LAYER_CASES])
def test_train_forward_and_gradients_under_the_reference_masks(
        kind, mode, reference_masks):
    jconf, pconf, shape = _layer(kind, mode)
    rng = np.random.RandomState(LAYER_CASES.index((kind, mode)))
    params = {k: (0.4 * rng.randn(*s)).astype(np.float32)
              for k, s in jconf.param_shapes().items()}
    x = rng.randn(*shape).astype(np.float32)
    step_key, index = prng.prng_key(77), 3
    jkey = jax.random.fold_in(jnp.asarray(step_key), index)

    def jax_fwd(p, xx):
        out, _, _ = jax_impls.get_impl(jconf)(jconf, p, {}, xx, rng=jkey,
                                              train=True)
        return out

    jout, vjp = jax.vjp(jax_fwd, {k: jnp.asarray(a) for k, a in
                                  params.items()}, jnp.asarray(x))
    cot = rng.randn(*jout.shape).astype(np.float32)
    jgrads, jgx = vjp(jnp.asarray(cot))

    p = {k: torch.tensor(a, requires_grad=True) for k, a in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, _ = impls.get_impl(pconf)(pconf, p, {}, xt, train=True,
                                   rng=prng.LayerKey(step_key, index))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **LAYER)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **LAYER)
    for k in params:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jgrads[k]),
                                   err_msg=k, **LAYER)
    # The draw changed the result: an inference forward differs.
    plain, _ = impls.get_impl(pconf)(pconf, p, {}, xt, train=False)
    assert not torch.allclose(plain, out)


# ----------------------------------------------------- whole steps, exact

def _mln_conf(builder, L, input_type):
    return (builder().seed(11).learning_rate(0.05).updater("adam").list()
            .layer(L.DenseLayer(n_out=10, activation="tanh", dropout=0.7))
            .layer(L.DenseLayer(n_out=8, activation="relu", dropout=0.8,
                                use_drop_connect=True))
            .layer(L.DropoutLayer(dropout=0.5))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent", dropout=0.9))
            .set_input_type(input_type.feed_forward(6)).build())


def _graph_conf(builder, L, input_type):
    return (builder().seed(5).learning_rate(0.02).updater("adam")
            .graph_builder().add_inputs("in")
            .add_layer("ln", L.LayerNormalization(dropout=0.8), "in")
            .add_layer("att", L.SelfAttentionLayer(n_out=8, n_heads=2,
                                                   dropout=0.7), "ln")
            .add_layer("lstm", L.GravesLSTM(n_out=6, dropout=0.6,
                                            use_drop_connect=True), "att")
            .add_layer("out", L.RnnOutputLayer(n_out=4, activation="softmax",
                                               loss_function="mcxent",
                                               dropout=0.9), "lstm")
            .set_outputs("out")
            .set_input_types(input_type.recurrent(8, 6)).build())


def _data(kind, seed):
    r = np.random.RandomState(seed)
    if kind == "mln":
        return (r.randn(8, 6).astype(np.float32),
                np.eye(3, dtype=np.float32)[r.randint(0, 3, 8)])
    return (r.randn(4, 6, 8).astype(np.float32),
            np.eye(4, dtype=np.float32)[r.randint(0, 4, (4, 6))])


def _pair(kind):
    if kind == "mln":
        jnet = JaxMLN(_mln_conf(JaxNNC.builder, jax_layers,
                                JaxInputType)).init()
        pnet = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration.builder,
                                           layers, InputType), device="cpu")
    else:
        jnet = JaxGraph(_graph_conf(JaxNNC.builder, jax_layers,
                                    JaxInputType)).init()
        pnet = ComputationGraph(_graph_conf(NeuralNetConfiguration.builder,
                                            layers, InputType), device="cpu")
    pnet.init(params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    return jnet, pnet


def _fit_both(jnet, pnet, kind, seed):
    x, y = _data(kind, seed)
    if kind == "mln":
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
    else:
        jnet.fit(JaxMDS([x], [y]))
        pnet.fit(MultiDataSet([x], [y]))


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_steps_under_the_reference_masks(kind, reference_masks):
    jnet, pnet = _pair(kind)
    for step in range(3):
        _fit_both(jnet, pnet, kind, step)
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   **STEP)
        np.testing.assert_array_equal(pnet._train_rng, jax_key(jnet))
    _assert_trees(pnet.params_tree, _np_tree(jnet.params_tree), "params",
                  STEP)
    _assert_trees(pnet.opt_state, _np_tree(
        {k: v for k, v in jnet.opt_state.items() if isinstance(v, dict)}),
        "adam", STEP)
    # A train-mode output draws from the next key, as the reference's.
    x, _ = _data(kind, 9)
    if kind == "mln":
        got, want = pnet.output(x, train=True), jnet.output(x, train=True)
    else:
        got, want = (pnet.output(x, train=True)[0],
                     jnet.output(x, train=True)[0])
    np.testing.assert_allclose(got, np.asarray(want), **STEP)
    np.testing.assert_array_equal(pnet._train_rng, jax_key(jnet))


def test_feed_forward_train_under_the_reference_masks(reference_masks):
    jnet, pnet = _pair("mln")
    x, _ = _data("mln", 4)
    got, want = pnet.feed_forward(x, train=True), jnet.feed_forward(
        x, train=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **STEP)


# ------------------------------------------ the port's own draws, by law

def test_keep_share_and_scaling_on_the_port_generator():
    x = torch.full((256, 1024), 3.0)
    key = prng.LayerKey(prng.prng_key(1), 0)
    out = common.inverted_dropout(x, 0.5, key, True)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.005
    assert torch.equal(out[kept], torch.full((int(kept.sum()),), 6.0))
    # The same key gives the same mask; the next layer's another one,
    # uncorrelated with the first.
    assert torch.equal(common.inverted_dropout(x, 0.5, key, True), out)
    other = common.inverted_dropout(x, 0.5, prng.LayerKey(
        prng.prng_key(1), 1), True) != 0
    assert not torch.equal(other, kept)
    a, b = kept.float().flatten(), other.float().flatten()
    corr = float(((a - a.mean()) * (b - b.mean())).mean()
                 / (a.std() * b.std()))
    assert abs(corr) < 0.01
    # Nothing is drawn at inference, with no key, or at retain 0 or 1.
    for retain, k, train in ((0.5, key, False), (0.5, None, True),
                             (1.0, key, True), (0.0, key, True),
                             (None, key, True)):
        assert common.inverted_dropout(x, retain, k, train) is x


def test_bf16_dropout_divides_in_bf16():
    x = torch.linspace(-3, 3, 4096).to(torch.bfloat16)
    out = common.inverted_dropout(x, 0.7, prng.LayerKey(prng.prng_key(2), 0),
                                  True)
    assert out.dtype == torch.bfloat16
    kept = out != 0
    assert torch.equal(out[kept], x[kept] / 0.7)


def test_successive_steps_draw_new_masks():
    net = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration.builder,
                                      layers, InputType), device="cpu").init()
    x, _ = _data("mln", 0)
    infer = net.output(x)
    np.testing.assert_array_equal(net.output(x), infer)
    key0 = net._train_rng.copy()
    a, b = net.output(x, train=True), net.output(x, train=True)
    assert not np.allclose(a, infer) and not np.allclose(a, b)
    want = prng.split(prng.split(key0)[0])[0]
    np.testing.assert_array_equal(net._train_rng, want)


def test_dropout_resume_equals_the_uninterrupted_run(tmp_path):
    def run(net, steps):
        for s in steps:
            net.fit(DataSet(*_data("mln", s)))
        return net

    conf = _mln_conf(NeuralNetConfiguration.builder, layers, InputType)
    full = run(MultiLayerNetwork(conf, device="cpu").init(), range(6))
    first = run(MultiLayerNetwork(conf, device="cpu").init(), range(3))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False,
                            device="cpu")
    mgr.save(first)
    resumed = run(mgr.restore(), range(3, 6))
    np.testing.assert_array_equal(resumed._train_rng, full._train_rng)
    assert resumed.iteration == full.iteration == 6
    for k, p in full.params_tree.items():
        for n, t in p.items():
            assert torch.equal(resumed.params_tree[k][n], t), (k, n)
    assert resumed.score_value == full.score_value
    x, _ = _data("mln", 9)
    np.testing.assert_array_equal(resumed.output(x, train=True),
                                  full.output(x, train=True))


# ------------------------------------------------ LRN, dilation, pooling

@pytest.mark.parametrize("kw", [{}, dict(n=3.0), dict(n=4.0, k=1.0,
                                                     alpha=1e-2, beta=0.5)],
                         ids=["defaults", "n3", "n4"])
def test_lrn_is_the_references(kw):
    x = np.random.RandomState(3).randn(2, 5, 4, 11).astype(np.float32) * 4
    jconf = jax_layers.LocalResponseNormalization(**kw)
    want, _, _ = jax_impls.get_impl(jconf)(jconf, {}, {}, jnp.asarray(x))
    conf = layers.LocalResponseNormalization(**kw)
    got, _ = impls.get_impl(conf)(conf, {}, {}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("mode", ["same", "truncate"])
def test_conv_dilation_2_is_the_references(mode):
    kw = dict(n_in=3, n_out=5, kernel_size=(3, 3), stride=(1, 1),
              dilation=(2, 2), convolution_mode=mode, activation="relu")
    if mode == "truncate":
        kw.update(stride=(2, 1), padding=(1, 2))
    jconf, conf = jax_layers.ConvolutionLayer(**kw), layers.ConvolutionLayer(
        **kw)
    r = np.random.RandomState(4)
    params = {k: r.randn(*s).astype(np.float32)
              for k, s in jconf.param_shapes().items()}
    x = r.randn(2, 11, 9, 3).astype(np.float32)
    want, _, _ = jax_impls.get_impl(jconf)(
        jconf, {k: jnp.asarray(a) for k, a in params.items()}, {},
        jnp.asarray(x))
    got, _ = impls.get_impl(conf)(
        conf, {k: torch.from_numpy(a) for k, a in params.items()}, {},
        torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("ptype", ["max", "sum", "avg", "pnorm"])
def test_masked_global_pooling_is_the_references(ptype):
    r = np.random.RandomState(6)
    x = r.randn(4, 7, 5).astype(np.float32)
    mask = (r.rand(4, 7) < 0.6).astype(np.float32)
    mask[1] = 0.0  # a fully masked row
    mask[2] = 1.0
    jconf = jax_layers.GlobalPoolingLayer(pooling_type=ptype, pnorm=3)
    want, _, wmask = jax_impls.get_impl(jconf)(
        jconf, {}, {}, jnp.asarray(x), mask=jnp.asarray(mask))
    conf = layers.GlobalPoolingLayer(pooling_type=ptype, pnorm=3)
    got, _ = impls.get_impl(conf)(conf, {}, {}, torch.from_numpy(x),
                                  mask=torch.from_numpy(mask))
    assert wmask is None and impls.mask_after(conf, mask) is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    if ptype == "max":
        assert np.isneginf(got.numpy()[1]).all()
    # The mask is consumed; every other layer hands it on.
    assert impls.mask_after(layers.DenseLayer(n_out=3), mask) is mask


def test_the_update_gets_contiguous_kernel_gradients():
    # A convolution's kernel gradient comes back through the HWIO permute
    # in the layout the backward wrote (on the CPU, and for some shapes on
    # the card, not HWIO-contiguous); the update kernel takes contiguous
    # tensors only, so the engine hands it contiguous ones.
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(layers.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                           convolution_mode="same"))
            .layer(layers.OutputLayer(n_out=3))
            .set_input_type(InputType.convolutional(6, 6, 3)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = torch.randn(2, 6, 6, 3)
    y = torch.eye(3)[[0, 2]]
    loss, _ = net._train_forward(x, y, None, None, False, None)
    grads, _ = net._train_backward(loss)
    assert all(g.is_contiguous() for p in grads.values() for g in p.values())
    w = net.params_tree["layer_0"]["W"]
    raw, = torch.autograd.grad(net._train_forward(x, y, None, None, False,
                                                  None)[0], w)
    assert not raw.is_contiguous()  # what the engine repairs
    torch.testing.assert_close(grads["layer_0"]["W"], raw, rtol=0, atol=0)
