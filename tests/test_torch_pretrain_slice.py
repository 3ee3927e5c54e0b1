"""Layerwise pretraining and the last conf-only layers in the port against
the JAX package, on the CPU: the VAE (`nn/layers/variational.py`: every
reconstruction distribution, the loss wrapper and the composite, the
negative ELBO, the reconstruction probability), the AutoEncoder and the
RBM (`nn/layers/feedforward.py`), `MultiLayerNetwork.pretrain` and `fit`
with `pretrain(True)`, `CenterLossOutputLayer` and `LossLayer` in both
engines, and their zips.

The port's draws (`nn/layers/common.py` `draw_normal` for the VAE's
epsilon, `draw_bernoulli` for the RBM's Gibbs samples and the
AutoEncoder's corruption) are swapped for `jax.random.normal` /
`jax.random.bernoulli` at the reference's keys, so both packages see the
same noise; the port's own draws are held statistically. Inputs and
params from seeded numpy, f32. Tolerances: values and gradients rtol 2e-4,
atol 1e-6; `fit` and pretraining steps (params, updater state, scores)
rtol 2e-4, atol 1e-5, as the earlier training slices; keys exactly.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import feedforward as jax_ff
from deeplearning4j_tpu.nn.layers import variational as jax_vae
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import prng
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import common, feedforward
from deeplearning4j_tpu_torch.nn.layers import variational
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.util import model_serializer

F32 = dict(rtol=2e-4, atol=1e-6)
STEP = dict(rtol=2e-4, atol=1e-5)


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


def _jkey(key):
    return jnp.asarray(common.key_words(key))


def jax_normal(key, shape, dtype, device):
    """The reference's epsilon at the key the port draws at."""
    eps = jax.random.normal(_jkey(key), tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(eps)).to(device, dtype)


def jax_bernoulli(key, p, shape, device):
    if isinstance(p, torch.Tensor):
        p = jnp.asarray(p.detach().cpu().float().numpy())
    draw = jax.random.bernoulli(_jkey(key), p, tuple(shape))
    return torch.from_numpy(np.array(draw)).to(device)


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(common, "draw_normal", jax_normal)
    monkeypatch.setattr(common, "draw_bernoulli", jax_bernoulli)


def _np_tree(tree):
    # np.array copies: the JAX step donates its buffers.
    return {k: ({f: {n: np.array(a) for n, a in s.items()}
                 for f, s in p.items()}
                if isinstance(next(iter(p.values()), None), dict)
                else {n: np.array(a) for n, a in p.items()})
            for k, p in tree.items() if isinstance(p, dict)}


def jax_key(jnet):
    """The reference's key continuation (its device clock holds it)."""
    return np.asarray(jnet._train_rng if jnet._clock is None
                      else jnet._clock[1])


def _assert_nets(pnet, jnet, tol=STEP):
    np.testing.assert_allclose(pnet.score_value, float(jnet.score_value),
                               **tol)
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               **tol)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **tol)
    np.testing.assert_array_equal(pnet._train_rng, jax_key(jnet))
    assert pnet.iteration == jnet.iteration


# ------------------------------------------------------- the distributions

DISTS = {
    "gaussian": "gaussian",
    "bernoulli": "bernoulli",
    "exponential": "exponential",
    "loss_mse": ["loss", "mse"],
    "loss_xent_sigmoid": ["loss", "xent", "sigmoid"],
    "composite": [["gaussian", 3], ["bernoulli", 2], ["exponential", 1]],
    "composite_with_loss": [["bernoulli", 4], [["loss", "mse"], 2]],
}


def _vae(m, dist, **kw):
    return m.VariationalAutoencoder(
        n_in=6, n_out=2, encoder_layer_sizes=(7, 5), decoder_layer_sizes=(5,),
        reconstruction_distribution=dist, activation="tanh", **kw)


def _vae_params(rng, conf):
    return {k: (rng.randn(*s) * 0.4).astype(np.float32)
            for k, s in conf.param_shapes().items()}


def _vae_input(rng, name):
    x = rng.rand(5, 6).astype(np.float32)
    if name in ("bernoulli", "composite_with_loss", "loss_xent_sigmoid"):
        x = (x > 0.5).astype(np.float32)
    return x


@pytest.mark.parametrize("name", list(DISTS))
def test_neg_log_prob_matches_the_reference(name):
    rng = np.random.RandomState(1)
    dist = DISTS[name]
    x = _vae_input(rng, name)
    width = layers.dist_input_size(dist, 6)
    assert width == jax_vae.dist_input_size(dist, 6)
    pre = rng.randn(5, width).astype(np.float32)
    want = jax_vae.neg_log_prob(dist, jnp.asarray(x), jnp.asarray(pre))
    got = variational.neg_log_prob(dist, torch.tensor(x), torch.tensor(pre))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("name", list(DISTS))
def test_vae_elbo_and_gradients_match_the_reference(name, reference_draws):
    # The negative ELBO over two samples (epsilon from fold_in(key, s)),
    # its gradient to every param, the reconstruction probability and the
    # supervised forward (the encoder's mean).
    rng = np.random.RandomState(2)
    dist = DISTS[name]
    conf = _vae(layers, dist, num_samples=2, pzx_activation="identity")
    jconf = _vae(jax_layers, dist, num_samples=2, pzx_activation="identity")
    p = _vae_params(rng, conf)
    x = _vae_input(rng, name)
    key = jax.random.PRNGKey(5)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jloss, jg = jax.value_and_grad(
        lambda q: jax_vae.vae_pretrain_loss(jconf, q, jnp.asarray(x), key))(
        jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    loss = variational.vae_pretrain_loss(conf, tp, torch.tensor(x),
                                         np.asarray(key))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   err_msg=k, **F32)
    want = jax_vae.vae_reconstruction_prob(jconf, jp, jnp.asarray(x), key, 3)
    with torch.no_grad():
        got = variational.vae_reconstruction_prob(
            conf, tp, torch.tensor(x), np.asarray(key), 3)
        mean, _ = variational.vae_apply(conf, tp, {}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    jmean, _, _ = jax_vae.vae_apply(jconf, jp, {}, jnp.asarray(x))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **F32)


# ------------------------------------------------- the AutoEncoder and RBM

@pytest.mark.parametrize("hidden", ["binary", "gaussian", "rectified",
                                    "softmax"])
def test_rbm_forward_matches_the_reference(hidden):
    rng = np.random.RandomState(3)
    conf = layers.RBM(n_in=6, n_out=4, hidden_unit=hidden)
    jconf = jax_layers.RBM(n_in=6, n_out=4, hidden_unit=hidden)
    p = {k: rng.randn(*s).astype(np.float32)
         for k, s in conf.param_shapes().items()}
    x = rng.rand(5, 6).astype(np.float32)
    want, _, _ = jax_ff.rbm_apply(jconf, {k: jnp.asarray(v)
                                          for k, v in p.items()}, {},
                                  jnp.asarray(x))
    got, _ = feedforward.rbm_apply(conf, {k: torch.tensor(v)
                                          for k, v in p.items()}, {},
                                   torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _unit_case(kind, visible="binary"):
    rng = np.random.RandomState(4)
    if kind == "ae":
        mk = (lambda m: m.AutoEncoder(n_in=6, n_out=4, activation="sigmoid",
                                      corruption_level=0.3))
        impl, jimpl = (feedforward.autoencoder_pretrain_loss,
                       jax_ff.autoencoder_pretrain_loss)
    else:
        mk = (lambda m: m.RBM(n_in=6, n_out=4, visible_unit=visible, k=2))
        impl, jimpl = feedforward.rbm_pretrain_loss, jax_ff.rbm_pretrain_loss
    conf, jconf = mk(layers), mk(jax_layers)
    p = {k: (rng.randn(*s) * 0.5).astype(np.float32)
         for k, s in conf.param_shapes().items()}
    x = rng.rand(5, 6).astype(np.float32)
    if visible == "binary":
        x = (x > 0.5).astype(np.float32)
    return conf, jconf, impl, jimpl, p, x


@pytest.mark.parametrize("kind,visible", [("ae", "binary"),
                                          ("rbm", "binary"),
                                          ("rbm", "gaussian")],
                         ids=["ae", "rbm_binary", "rbm_gaussian"])
def test_pretrain_objectives_match_the_reference(kind, visible,
                                                 reference_draws):
    # The denoising AE's loss (corruption drawn at the key) and CD-2 (the
    # Gibbs chain at fold_in(key, 2j), fold_in(key, 2j + 1)), values and
    # gradients; the AE's supervised forward is the dense encode.
    conf, jconf, impl, jimpl, p, x = _unit_case(kind, visible)
    key = jax.random.PRNGKey(9)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jloss, jg = jax.value_and_grad(
        lambda q: jimpl(jconf, q, jnp.asarray(x), key))(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    loss = impl(conf, tp, torch.tensor(x), np.asarray(key))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   err_msg=k, **F32)
    if kind == "ae":
        want, _, _ = jax_ff.autoencoder_apply(jconf, jp, {}, jnp.asarray(x))
        got, _ = feedforward.autoencoder_apply(conf, tp, {}, torch.tensor(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **F32)


# --------------------------------------------------- pretraining a network

class _Ns:
    def __init__(self, mod, nnc, input_type):
        self.L, self.NNC, self.I = mod, nnc, input_type


PORT = _Ns(layers, NeuralNetConfiguration, InputType)
JAX = _Ns(jax_layers, JaxNNC, JaxInputType)


def _net_conf(ns, case, backprop=False):
    L = ns.L
    b = (ns.NNC.builder().seed(12).learning_rate(0.01).l2(1e-3)
         .updater("rmsprop" if case == "vae" else "nesterovs").list())
    if case == "vae":
        b = b.layer(L.VariationalAutoencoder(
            n_out=2, encoder_layer_sizes=(8, 8), decoder_layer_sizes=(8,),
            reconstruction_distribution="bernoulli", activation="leakyrelu"))
    elif case == "ae_rbm":
        b = (b.layer(L.AutoEncoder(n_out=7, corruption_level=0.3,
                                   activation="sigmoid"))
             .layer(L.RBM(n_out=5, activation="sigmoid")))
    elif case == "rbm_gaussian":
        b = b.layer(L.RBM(n_out=5, visible_unit="gaussian", k=2,
                          activation="sigmoid"))
    b = b.layer(L.OutputLayer(n_out=3, activation="softmax",
                              loss_function="mcxent"))
    return (b.pretrain(True).backprop(backprop)
            .set_input_type(ns.I.feed_forward(10)).build())


def _batches(n, seed=20):
    rng = np.random.RandomState(seed)
    return [((rng.rand(6, 10) > 0.5).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, 6)])
            for _ in range(n)]


def _pair(case, backprop=False):
    jnet = JaxMLN(_net_conf(JAX, case, backprop)).init()
    pnet = MultiLayerNetwork(_net_conf(PORT, case, backprop),
                             device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    return jnet, pnet


@pytest.mark.parametrize("case", ["vae", "ae_rbm", "rbm_gaussian"])
def test_pretrain_steps_match_the_reference(case, reference_draws):
    # `fit` with pretrain(True), backprop(False): every pretrainable layer
    # in order, one step per batch, its own updater (RMSProp, Nesterovs)
    # and no l2; the output layer untouched; the key split once a step.
    jnet, pnet = _pair(case)
    batches = _batches(3)
    jnet.fit([JaxDataSet(x, y) for x, y in batches])
    pnet.fit([DataSet(x, y) for x, y in batches])
    _assert_nets(pnet, jnet)
    n_pre = {"vae": 1, "ae_rbm": 2, "rbm_gaussian": 1}[case]
    assert pnet.iteration == 3 * n_pre
    assert pnet.epoch == jnet.epoch == 1


NET_DISTS = {
    "gaussian": "gaussian",
    "bernoulli": "bernoulli",
    "exponential": "exponential",
    "loss_mse": ["loss", "mse"],
    "loss_xent_sigmoid": ["loss", "xent", "sigmoid"],
    "composite": [["gaussian", 4], ["bernoulli", 4], ["exponential", 2]],
    "composite_with_loss": [["bernoulli", 6], [["loss", "mse"], 4]],
}


@pytest.mark.parametrize("name", list(NET_DISTS))
def test_vae_pretrain_steps_match_the_reference(name, reference_draws):
    # A VAE net of each reconstruction distribution pretrained three steps
    # (two samples a step): params, RMSProp state, the key, the iteration.
    def conf(ns):
        return (ns.NNC.builder().seed(13).learning_rate(0.01)
                .updater("rmsprop").list()
                .layer(ns.L.VariationalAutoencoder(
                    n_out=3, encoder_layer_sizes=(8,),
                    decoder_layer_sizes=(8, 6), num_samples=2,
                    reconstruction_distribution=NET_DISTS[name],
                    activation="tanh"))
                .layer(ns.L.OutputLayer(n_out=3))
                .pretrain(True).backprop(False)
                .set_input_type(ns.I.feed_forward(10)).build())

    jnet = JaxMLN(conf(JAX)).init()
    pnet = MultiLayerNetwork(conf(PORT), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    batches = _batches(3, seed=23)
    jnet.fit([JaxDataSet(x, y) for x, y in batches])
    pnet.fit([DataSet(x, y) for x, y in batches])
    _assert_nets(pnet, jnet)
    assert pnet.iteration == 3


def test_pretrain_then_backprop_as_the_reference(reference_draws):
    # The AE + RBM stack pretrained layer by layer, then backprop over the
    # same batches: the key and iteration carry on from pretraining.
    jnet, pnet = _pair("ae_rbm", backprop=True)
    batches = _batches(2, seed=21)
    jnet.fit([JaxDataSet(x, y) for x, y in batches])
    pnet.fit([DataSet(x, y) for x, y in batches])
    _assert_nets(pnet, jnet)
    assert pnet.iteration == 2 * 2 + 2
    x = batches[0][0]
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)),
                               **STEP)


def test_pretrain_epochs_and_listeners(reference_draws):
    # `pretrain(iterator, epochs=2)` directly: two passes per layer, a
    # listener call per step.
    class Count(IterationListener):
        def __init__(self):
            self.seen = []

        def iteration_done(self, net, iteration):
            self.seen.append(iteration)

    jnet, pnet = _pair("vae")
    count = Count()
    pnet.set_listeners(count)
    batches = _batches(2, seed=22)
    jnet.pretrain([JaxDataSet(x, y) for x, y in batches], epochs=2)
    pnet.pretrain([DataSet(x, y) for x, y in batches], epochs=2)
    _assert_nets(pnet, jnet)
    assert count.seen == [1, 2, 3, 4]


def test_vae_init_fans():
    # Every VAE weight is drawn with its own matrix's fans (xavier:
    # sqrt(2 / (fan_in + fan_out))), as the reference's override says.
    def conf(ns):
        return (ns.NNC.builder().seed(3).weight_init("xavier").list()
                .layer(ns.L.VariationalAutoencoder(
                    n_out=64, encoder_layer_sizes=(512,),
                    decoder_layer_sizes=(256,)))
                .layer(ns.L.OutputLayer(n_out=3))
                .pretrain(True).backprop(False)
                .set_input_type(ns.I.feed_forward(784)).build())

    port = MultiLayerNetwork(conf(PORT), device="cpu").init()
    ref = JaxMLN(conf(JAX)).init()
    for k, a in ref.params_tree["layer_0"].items():
        got = port.params_tree["layer_0"][k].detach().numpy()
        assert got.shape == a.shape
        if got.ndim == 1:
            assert not got.any()
            continue
        want = (2.0 / (got.shape[0] + got.shape[1])) ** 0.5
        np.testing.assert_allclose(got.std(), want, rtol=0.03, err_msg=k)
        np.testing.assert_allclose(np.asarray(a).std(), want, rtol=0.03,
                                   err_msg=k)


def test_the_ports_own_draws():
    # Seeded from the key's words on the tensor's device: the same key
    # the same draw, another key another; normal mean 0 and std 1,
    # Bernoulli share p (a float or per element), uniform inside its range.
    k1, k2 = prng.split(prng.prng_key(7))
    n = 200_000
    a = common.draw_normal(k1, (n,), torch.float32, "cpu")
    assert torch.equal(a, common.draw_normal(k1, (n,), torch.float32, "cpu"))
    assert not torch.equal(a, common.draw_normal(k2, (n,), torch.float32,
                                                 "cpu"))
    assert abs(float(a.mean())) < 0.01 and abs(float(a.std()) - 1) < 0.01
    b = common.draw_bernoulli(k1, 0.3, (n,), "cpu")
    assert b.dtype == torch.bool and abs(float(b.float().mean()) - 0.3) < 0.005
    p = torch.linspace(0.0, 1.0, n)
    b = common.draw_bernoulli(prng.fold_in(k1, 3), p, (n,), "cpu")
    assert abs(float(b[: n // 2].float().mean()) - 0.25) < 0.01
    assert abs(float(b[n // 2:].float().mean()) - 0.75) < 0.01
    u = common.draw_uniform(prng.LayerKey(k2, 4), 0.99, 1.01, (n,),
                            torch.float64, "cpu")
    assert u.dtype == torch.float64
    assert float(u.min()) >= 0.99 and float(u.max()) < 1.01
    assert abs(float(u.mean()) - 1.0) < 1e-4


# --------------------------------------------- center loss and LossLayer

def _center_mln(ns):
    return (ns.NNC.builder().seed(4).updater("adam").learning_rate(0.01)
            .list()
            .layer(ns.L.DenseLayer(n_out=5, activation="tanh"))
            .layer(ns.L.CenterLossOutputLayer(
                n_out=3, activation="softmax", loss_function="mcxent",
                alpha=0.3, lambda_=0.05))
            .set_input_type(ns.I.feed_forward(4)).build())


def _center_graph(ns):
    return (ns.NNC.builder().seed(4).updater("adam").learning_rate(0.01)
            .graph_builder().add_inputs("in")
            .add_layer("h", ns.L.DenseLayer(n_out=5, activation="tanh"), "in")
            .add_layer("out", ns.L.CenterLossOutputLayer(
                n_out=3, activation="softmax", loss_function="mcxent",
                alpha=0.3, lambda_=0.05), "h")
            .set_outputs("out")
            .set_input_types(ns.I.feed_forward(4)).build())


def _loss_mln(ns):
    return (ns.NNC.builder().seed(4).updater("adam").learning_rate(0.01)
            .list()
            .layer(ns.L.DenseLayer(n_out=3, activation="identity"))
            .layer(ns.L.LossLayer(activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(ns.I.feed_forward(4)).build())


def _loss_graph(ns):
    return (ns.NNC.builder().seed(4).updater("adam").learning_rate(0.01)
            .graph_builder().add_inputs("in")
            .add_layer("h", ns.L.DenseLayer(n_out=3), "in")
            .add_layer("out", ns.L.LossLayer(activation="softmax",
                                             loss_function="mcxent"), "h")
            .set_outputs("out")
            .set_input_types(ns.I.feed_forward(4)).build())


OUTPUT_CASES = {"center_mln": _center_mln, "center_graph": _center_graph,
                "loss_mln": _loss_mln, "loss_graph": _loss_graph}


@pytest.mark.parametrize("case", list(OUTPUT_CASES))
def test_output_layers_train_as_the_reference(case):
    # Three steps (the second batch with int labels and a labels mask for
    # the center loss): score, params, Adam state and the centers; then
    # `score` and `output`.
    mk = OUTPUT_CASES[case]
    graph = case.endswith("graph")
    jnet = (JaxGraph if graph else JaxMLN)(mk(JAX)).init()
    pnet = (ComputationGraph if graph else MultiLayerNetwork)(
        mk(PORT), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
        state=interop.state_from_numpy(_np_tree(jnet.state)))
    rng = np.random.RandomState(30)
    for step in range(3):
        x = rng.randn(8, 4).astype(np.float32)
        cls = rng.randint(0, 3, 8)
        y = (cls.astype(np.int32) if step == 1
             else np.eye(3, dtype=np.float32)[cls])
        lm = (np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
              if step == 2 else None)
        if graph:
            jnet.fit(JaxMDS(features=[x], labels=[y],
                            labels_masks=None if lm is None else [lm]))
            pnet.fit(MultiDataSet([x], [y], labels_masks=None if lm is None
                                  else [lm]))
        else:
            jnet.fit(JaxDataSet(x, y, labels_mask=lm))
            pnet.fit(DataSet(x, y, labels_mask=lm))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   **STEP)
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               **STEP)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **STEP)
    if case.startswith("center"):
        (name, st), = pnet.state.items()
        np.testing.assert_allclose(st["centers"].numpy(), np.asarray(
            jnet.state[name]["centers"]), **STEP)
        assert st["centers"].abs().sum() > 0  # the centers moved
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)]
    if graph:
        np.testing.assert_allclose(
            pnet.score(MultiDataSet([x], [y])),
            float(jnet.score(JaxMDS(features=[x], labels=[y]))), **STEP)
        np.testing.assert_allclose(pnet.output(x)[0],
                                   np.asarray(jnet.output(x)[0]), **STEP)
    else:
        np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                                   float(jnet.score(JaxDataSet(x, y))),
                                   **STEP)
        np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)),
                                   **STEP)


# ------------------------------------------------------------------ zips

ZIP_CASES = {"vae": lambda ns: _net_conf(ns, "vae"),
             "ae_rbm": lambda ns: _net_conf(ns, "ae_rbm", backprop=True),
             "center_mln": _center_mln, "center_graph": _center_graph}


@pytest.mark.parametrize("case", list(ZIP_CASES))
def test_zips_round_trip_in_both_packages(case, tmp_path):
    # A trained port net's zip loads in both packages (params, updater
    # state, the centers); the reference's zip of it loads back in the
    # port bit for bit.
    mk = ZIP_CASES[case]
    graph = case.endswith("graph")
    pnet = (ComputationGraph if graph else MultiLayerNetwork)(
        mk(PORT), device="cpu").init()
    x, y = _batches(1, seed=40)[0]
    x = x[:, :4] if case.startswith("center") else x
    pnet.fit(MultiDataSet([x], [y]) if graph else DataSet(x, y))
    path = str(tmp_path / "net.zip")
    model_serializer.save_model(pnet, path)
    back = model_serializer.load_model(path, device="cpu")
    np.testing.assert_array_equal(back.params(), pnet.params())
    np.testing.assert_array_equal(back.updater_state_flat(),
                                  pnet.updater_state_flat())
    assert json.loads(back.conf.to_json()) == json.loads(pnet.conf.to_json())
    jnet = jax_serializer.load_model(path)
    np.testing.assert_array_equal(np.asarray(jnet.params()), pnet.params())
    for name, st in pnet.state.items():
        np.testing.assert_array_equal(np.asarray(jnet.state[name]["centers"]),
                                      st["centers"].numpy())
        np.testing.assert_array_equal(back.state[name]["centers"].numpy(),
                                      st["centers"].numpy())
    jpath = str(tmp_path / "ref.zip")
    jax_serializer.save_model(jnet, jpath)
    again = model_serializer.load_model(jpath, device="cpu")
    np.testing.assert_array_equal(again.params(), pnet.params())
    for name, st in pnet.state.items():
        np.testing.assert_array_equal(again.state[name]["centers"].numpy(),
                                      st["centers"].numpy())
