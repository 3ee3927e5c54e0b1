"""The port's ResNet slice as a whole against the JAX package, on the CPU:
`models/resnet.py` configurations, the convolution and pooling layers'
SAME padding, relu init, and `ComputationGraph.fit` / `output` with
BatchNorm running statistics, for both graph forms (per-layer vertices and
fused `BottleneckBlock`s).

- `resnet50(...)` builds the reference's graph: the port's configuration
  equals `from_json` of the reference's `to_json()`, vertex for vertex.
- A small graph from the helpers `_conv_bn`, `_bottleneck` and
  `_bottleneck_fused` (7x7/2 stem, 3x3/2 max pool, one projecting stride-2
  block and one identity block at 2 filters, image 16, B=4, 5 classes,
  Nesterovs at lr 0.1, l2 1e-4): three f32 `fit` steps from the same
  params hold the score, params, Nesterovs state and running statistics to
  the JAX package's at rtol 2e-4, atol 1e-5 (sums in another order,
  carried through three momentum steps), then `output`. The float64
  policy (the CPU reference for the card's gradients in `chip_smoke.py`)
  trains the same small graph to the f32 result.
- The full-depth `resnet50(n_classes=5, image=32)` `output` (running
  statistics) at B=2, for both flags, f32, at the same tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.nn.conf.enums import Updater
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (
    ConvolutionLayer as JaxConv,
    GlobalPoolingLayer as JaxGlobalPool,
    OutputLayer as JaxOutput,
    SubsamplingLayer as JaxSubsampling,
)
from deeplearning4j_tpu.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import convolution as jax_conv
from deeplearning4j_tpu.nn.layers import pooling as jax_pooling
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models import resnet
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNormalization,
    BottleneckBlock,
    ConvolutionLayer,
    GlobalPoolingLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as PortInputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    NeuralNetConfiguration as PortNeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import convolution, pooling

F32 = dict(rtol=2e-4, atol=1e-5)
IMAGE, B, CLASSES = 16, 4, 5


def _np_tree(tree):
    # np.array copies: the JAX step donates its buffers.
    return {v: ({f: {k: np.array(a) for k, a in s.items()}
                 for f, s in p.items()}
                if isinstance(next(iter(p.values()), None), dict)
                else {k: np.array(a) for k, a in p.items()})
            for v, p in tree.items()}


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("fused", [False, True])
def test_resnet50_matches_the_reference_json(fused):
    ref = ComputationGraphConfiguration.from_json(
        jax_resnet.resnet50(n_classes=1000, image=224,
                            fused_blocks=fused).to_json())
    got = resnet.resnet50(n_classes=1000, image=224, fused_blocks=fused)
    assert len(got.vertices) == (21 if fused else 141)
    assert got.vertex_inputs == ref.vertex_inputs
    assert got.network_inputs == ref.network_inputs == ["input"]
    assert got.network_outputs == ref.network_outputs == ["fc"]
    for name, v in ref.vertices.items():
        assert got.vertices[name] == v, name
    assert dataclasses.asdict(got.global_conf) == dataclasses.asdict(
        ref.global_conf)
    assert got.topological_order() == ref.topological_order()
    layers = [v.layer for v in got.vertices.values() if hasattr(v, "layer")]
    n_bn = sum(isinstance(x, BatchNormalization) for x in layers)
    n_blocks = sum(isinstance(x, BottleneckBlock) for x in layers)
    assert (n_bn, n_blocks) == ((1, 16) if fused else (53, 0))
    # Layer vertices that carry params: one Nesterovs dispatch each.
    assert sum(bool(x.param_shapes()) for x in layers) == (19 if fused
                                                            else 107)


# ------------------------------------------------------- padding, init


@pytest.mark.parametrize("size", [7, 8, 15, 16])
@pytest.mark.parametrize("kernel,stride", [(7, 2), (3, 2), (1, 2), (3, 1)])
def test_same_conv_padding_matches_jax(size, kernel, stride):
    rng = np.random.RandomState(size + kernel)
    x = rng.randn(2, size, size + 1, 3).astype(np.float32)
    w = rng.randn(kernel, kernel, 3, 4).astype(np.float32)
    kw = dict(kernel_size=(kernel, kernel), stride=(stride, stride), n_in=3,
              n_out=4, convolution_mode="same", activation="identity",
              has_bias=False)
    want, _, _ = jax_conv.conv2d_apply(JaxConv(**kw), {"W": w}, {}, x)
    got, _ = convolution.conv2d_apply(ConvolutionLayer(**kw),
                                      {"W": torch.tensor(w)}, {},
                                      torch.tensor(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("size", [7, 8, 112])
@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
def test_same_pooling_padding_matches_jax(size, ptype):
    rng = np.random.RandomState(size)
    x = rng.randn(1, size, size, 2).astype(np.float32) - 3.0  # all < 0
    kw = dict(pooling_type=ptype, kernel_size=(3, 3), stride=(2, 2),
              convolution_mode="same")
    want, _, _ = jax_conv.subsampling_apply(JaxSubsampling(**kw), {}, {}, x)
    got, _ = convolution.subsampling_apply(SubsamplingLayer(**kw), {}, {},
                                           torch.tensor(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_matches_jax(ptype):
    x = np.random.RandomState(4).randn(2, 5, 3, 6).astype(np.float32)
    want, _, _ = jax_pooling.global_pooling_apply(
        JaxGlobalPool(pooling_type=ptype), {}, {}, x)
    got, _ = pooling.global_pooling_apply(
        GlobalPoolingLayer(pooling_type=ptype), {}, {}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_the_stem_pads_two_before_and_three_after():
    assert convolution.same_pads(224, 7, 2) == (2, 3)
    assert convolution.same_pads(112, 3, 2) == (0, 1)
    assert convolution.same_pads(56, 3, 1) == (1, 1)


def test_relu_init_statistics_and_initial_state():
    gen = torch.Generator().manual_seed(0)
    conv = ConvolutionLayer(kernel_size=(3, 3), n_in=64, n_out=128,
                            weight_init="relu", has_bias=False)
    w = params_mod.init_layer_params(conv, gen)["W"]
    assert tuple(w.shape) == (3, 3, 64, 128)
    want_std = (2.0 / (3 * 3 * 64)) ** 0.5   # N(0, sqrt(2 / fan_in))
    assert abs(float(w.std()) / want_std - 1) < 0.02
    assert abs(float(w.mean())) < 0.05 * want_std
    block = BottleneckBlock(n_in=256, filters=64, project=True,
                            weight_init="relu", bias_init=0.0)
    p = params_mod.init_layer_params(block, gen)
    assert list(p) == list(block.param_shapes())
    assert abs(float(p["W_b"].std()) / (2.0 / (9 * 64)) ** 0.5 - 1) < 0.02
    assert abs(float(p["W_proj"].std()) / (2.0 / 256) ** 0.5 - 1) < 0.02
    assert torch.equal(p["gamma_a"], torch.ones(64))
    assert torch.equal(p["beta_proj"], torch.zeros(256))
    bn = BatchNormalization(n_in=8, n_out=8, gamma=1.5, beta=0.5)
    bp = params_mod.init_layer_params(bn, gen)
    assert torch.equal(bp["gamma"], torch.full((8,), 1.5))
    assert torch.equal(bp["beta"], torch.full((8,), 0.5))
    st = params_mod.init_layer_state(block)
    assert list(st) == list(block.state_shapes())
    assert all(torch.equal(t, torch.ones_like(t) if k.startswith("var")
                           else torch.zeros_like(t)) for k, t in st.items())


# ---------------------------------------------------------- small graph


def _jax_small(fused, dtype="float32"):
    b = (NeuralNetConfiguration.builder().seed(7).learning_rate(0.1)
         .updater(Updater.NESTEROVS).momentum(0.9).weight_init("relu")
         .l2(1e-4).dtype(dtype).graph_builder().add_inputs("input"))
    x = jax_resnet._conv_bn(b, "stem", "input", 8, (7, 7), (2, 2))
    b.add_layer("stem_pool", JaxSubsampling(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), x)
    block = jax_resnet._bottleneck_fused if fused else jax_resnet._bottleneck
    x = block(b, "s0_b0", "stem_pool", 2, (2, 2), project=True)
    x = block(b, "s0_b1", x, 2, (1, 1), project=False)
    b.add_layer("avgpool", JaxGlobalPool(pooling_type="avg"), x)
    b.add_layer("fc", JaxOutput(n_out=CLASSES, activation="softmax",
                                loss_function="mcxent",
                                weight_init="xavier"), "avgpool")
    return (b.set_outputs("fc")
            .set_input_types(InputType.convolutional(IMAGE, IMAGE, 3))
            .build())


def _port_small(fused, dtype="float32"):
    b = (PortNeuralNetConfiguration.builder().seed(7).learning_rate(0.1)
         .updater("nesterovs").momentum(0.9).weight_init("relu")
         .l2(1e-4).dtype(dtype).graph_builder().add_inputs("input"))
    x = resnet._conv_bn(b, "stem", "input", 8, (7, 7), (2, 2))
    b.add_layer("stem_pool", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), x)
    block = resnet._bottleneck_fused if fused else resnet._bottleneck
    x = block(b, "s0_b0", "stem_pool", 2, (2, 2), project=True)
    x = block(b, "s0_b1", x, 2, (1, 1), project=False)
    b.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    b.add_layer("fc", OutputLayer(n_out=CLASSES, activation="softmax",
                                  loss_function="mcxent",
                                  weight_init="xavier"), "avgpool")
    return (b.set_outputs("fc")
            .set_input_types(PortInputType.convolutional(IMAGE, IMAGE, 3))
            .build())


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(2):
        x = rng.randn(B, IMAGE, IMAGE, 3).astype(np.float32)
        y = np.eye(CLASSES, dtype=np.float32)[rng.randint(0, CLASSES, B)]
        out.append((x, y))
    return out


@pytest.fixture(scope="module", params=[False, True],
                ids=["unfused", "fused"])
def small_run(request):
    fused = request.param
    jconf = _jax_small(fused)
    pconf = _port_small(fused)
    assert pconf.vertices == ComputationGraphConfiguration.from_json(
        jconf.to_json()).vertices
    jnet = JaxGraph(jconf).init()
    pnet = ComputationGraph(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
        state=interop.state_from_numpy(_np_tree(jnet.state)))
    batches = _batches()
    out = {"fused": fused, "jnet": jnet, "pnet": pnet, "batches": batches,
           "jax_scores": [], "port_scores": []}
    kernels.reset_counts()
    for step in range(3):
        x, y = batches[step % 2]
        jnet.fit(JaxMDS([x], [y]))
        pnet.fit(MultiDataSet([x], [y]))
        out["jax_scores"].append(jnet.score_value)
        out["port_scores"].append(pnet.score_value)
    out["counts"] = kernels.counts()
    return out


def _assert_trees(port_tree, jax_tree, what):
    for v, p in jax_tree.items():
        for k, a in p.items():
            got = port_tree[v][k]
            np.testing.assert_allclose(
                (got.detach() if isinstance(got, torch.Tensor)
                 else got).numpy(), a, err_msg=f"{what} {v}/{k}", **F32)


def test_small_graph_fit_matches_jax_step_by_step(small_run):
    r = small_run
    np.testing.assert_allclose(r["port_scores"], r["jax_scores"], **F32)
    assert r["port_scores"][-1] < r["port_scores"][0]
    jnet, pnet = r["jnet"], r["pnet"]
    _assert_trees(pnet.params_tree, _np_tree(jnet.params_tree), "params")
    _assert_trees(pnet.state, _np_tree(jnet.state), "running stats")
    jopt = _np_tree(jnet.opt_state)
    _assert_trees({v: s["v"] for v, s in pnet.opt_state.items()},
                  {v: s["v"] for v, s in jopt.items()}, "nesterovs v")
    assert all(t.dtype == torch.float32 for s in pnet.state.values()
               for t in s.values())


def test_small_graph_launch_counts_per_step(small_run):
    plain = small_run["counts"]["plain_calls"]
    # Per step: one plain BatchNorm per BN layer (the stem's only, when the
    # blocks are fused), one block per BottleneckBlock, one update per
    # layer vertex that has params.
    if small_run["fused"]:
        assert plain["batchnorm_norm_act"] == 3 * 1
        assert plain["bottleneck_train"] == 3 * 2
        assert plain["fused_update"] == 3 * 5
    else:
        assert plain["batchnorm_norm_act"] == 3 * 8
        assert plain["bottleneck_train"] == 0
        assert plain["fused_update"] == 3 * 17
    assert plain["bottleneck_infer"] == 0
    assert not any(small_run["counts"]["launches"].values())


def test_small_graph_output_after_fit_matches_jax(small_run):
    x, _ = small_run["batches"][1]
    kernels.reset_counts()
    got = small_run["pnet"].output(x)[0]
    want = small_run["jnet"].output(x)[0]
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    if small_run["fused"]:
        assert kernels.counts()["plain_calls"]["bottleneck_infer"] == 2


def test_float64_policy_trains_the_small_graph_like_f32():
    nets = {}
    for dtype in ("float32", "float64"):
        conf = _port_small(False)
        conf.global_conf.dtype = dtype
        nets[dtype] = ComputationGraph(conf, device="cpu").init()
    for step in range(2):
        x, y = _batches()[step]
        for net in nets.values():
            net.fit(MultiDataSet([x], [y]))
        np.testing.assert_allclose(nets["float64"].score_value,
                                   nets["float32"].score_value, rtol=1e-5)
    f64 = nets["float64"]
    assert f64.dtype_policy.compute_dtype == torch.float64
    assert all(t.dtype == torch.float64 for tree in (f64.params_tree,
                                                     f64.state)
               for p in tree.values() for t in p.values())
    _assert_trees(f64.params_tree, _np_tree(
        {v: {k: t.detach().double() for k, t in p.items()}
         for v, p in nets["float32"].params_tree.items()}), "f64 params")


def test_init_checks_the_given_state():
    net = ComputationGraph(_port_small(True), device="cpu")
    with pytest.raises(ValueError, match="state of vertex"):
        net.init(state={"stem_bn": {"mean": torch.zeros(3)}})
    net.init()
    assert set(net.state) == {"stem_bn", "s0_b0_block", "s0_b1_block"}
    assert torch.equal(net.state["s0_b0_block"]["var_proj"], torch.ones(8))


# ----------------------------------------------------------- full depth


@pytest.mark.parametrize("fused", [False, True])
def test_full_depth_resnet50_output_matches_jax(fused):
    jnet = JaxGraph(jax_resnet.resnet50(n_classes=5, image=32,
                                        dtype="float32",
                                        fused_blocks=fused)).init()
    rng = np.random.RandomState(3)
    state = _np_tree(jnet.state)
    for s in state.values():  # running stats away from their init
        for k in s:
            s[k] = (rng.rand(*s[k].shape) + 0.5 if k.startswith("var")
                    else rng.randn(*s[k].shape) * 0.1).astype(np.float32)
    jnet.state = {v: dict(s) for v, s in state.items()}
    pnet = ComputationGraph(
        resnet.resnet50(n_classes=5, image=32, dtype="float32",
                        fused_blocks=fused), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
        state=interop.state_from_numpy(state))
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    want = jnet.output(x)[0]
    got = pnet.output(x)[0]
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, **F32)
