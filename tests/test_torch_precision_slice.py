"""Precision policies and int8 serving checkpoints of the port against the
JAX package, on the CPU.

The same confs (JSON), the same params (numpy through
`interop.params_from_numpy`) and the same batches go through both
packages:

- the policy object: `to_dict` of every preset and of overrides, and the
  legacy `GlobalConf.dtype` strings resolved as the reference resolves
  them (its `resolve_policy`: "bfloat16" is mixed_bfloat16, "float64"
  float64, any other string the float32 default);
- three steps of the reference's own MLP (`tests/test_dtype_policy.py`
  `mlp_conf`) under mixed_bfloat16, bfloat16, mixed_float16 and float16,
  with Adam and Nesterovs: params, masters, updater state, the loss-scale
  pair and the score;
- the loss-scale sequences: a step forced non-finite is skipped in both
  (everything bit-equal to before, the scale halved), and the scale
  grows after its interval, equal to the reference's at every step;
- a small LM (`ComputationGraph.fit`) under mixed_float16 and bfloat16,
  and a small char-RNN (`MultiLayerNetwork.fit`, truncated BPTT) under
  mixed_float16;
- the refusals left: pretraining under a master-copy or loss-scaling
  policy (the reference's ValueError), superstep and solvers (A.10);
- int8 quantization: `quantize_array` / `quantize_tree` bit for bit, a
  checkpoint quantized in either package restored in the other, and
  `output` from a quantized checkpoint (a graph with a projecting
  bottleneck block and a dense output, and LeNet);
- `transfer_dtype`: a batch's host bytes halve and `fit` equals the
  reference's;
- checkpoints under a bfloat16 and a mixed_float16 policy, saved in each
  package (sharded store and zip) and restored in the other, `_master`
  and `_ls` included;
- the plain versions of rows 1, 3, 5 and 6 in f16 against the reference's
  functions, and row 9's plain skip and low-precision write.

Tolerances. The two frameworks round low-precision compute at different
places (XLA keeps f32 between fused elementwise ops, PyTorch rounds after
each op), so a low-precision step differs in the compute dtype's last bit
here and there. With u the compute dtype's unit roundoff (2^-8 bf16,
2^-11 f16), n the steps and lr the learning rate:
- f32 leaves (params under mixed policies, masters): rtol 2e-4 and atol
  2 n lr u, the drift that n updates of gradients u apart allow;
- updater state: rtol 2e-4 and atol 4 u of the field's largest value
  over the layer's params (a bias's gradient sums terms as large as the
  weights'; 1.35 u was the largest seen);
- bf16 / f16 stored params: each package's equal, bit for bit, to the
  cast of its own masters, and the two within the f32 limit plus one ulp
  of the stored dtype;
- the score: rtol 4 u; the loss-scale pair: equal.
f32 compute (the quantized `output`, the transfer-dtype run in f32 parts)
is held at rtol 1e-4 / 2e-4, bf16 compute at 4e-2, as the other slices
hold them.
"""

import json
import types
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.checkpoint import quantize as jax_quantize
from deeplearning4j_tpu.checkpoint import store as jax_store
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDS
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.kernels import flash_attention as jax_fa
from deeplearning4j_tpu.kernels import norm_act as jax_norm_act
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import dtype_policy as jax_policy
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.checkpoint import quantize, store
from deeplearning4j_tpu_torch.datasets import staging
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.kernels import fused_update, norm_act
from deeplearning4j_tpu_torch.nn.conf import dtype_policy
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer

U = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11, "float32": 0.0}
STEPS, LR = 3, 0.05
LOW = ("mixed_bfloat16", "bfloat16", "mixed_float16", "float16")


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package (see
    `tests/test_torch_model_zip.py`)."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


def _np(a) -> np.ndarray:
    """A leaf of either package as f32 (or its own integer) numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name == "bfloat16" else np.array(a)


def _tree(tree):
    """A reference tree (nested dicts, tuples) as nested numpy, copied:
    the JAX step donates its buffers."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree(v) for v in tree)
    return np.array(tree)


def _compute_of(policy) -> str:
    return dtype_policy.DtypePolicy.of(policy).resolved()[1]


def _stored_of(policy) -> str:
    return dtype_policy.DtypePolicy.of(policy).resolved()[0]


def _close_f32(got, want, u, what, lr=LR, steps=STEPS):
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4,
                               atol=2 * steps * lr * u + 1e-7,
                               err_msg=what)


def _close_state(got, want, u, scale, what):
    """`scale`: the largest value of the field over the layer's params (a
    bias's gradient sums terms as large as the weights' do)."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4,
                               atol=4 * u * scale + 1e-12, err_msg=what)


def _ulp(a: np.ndarray, dtype: str) -> np.ndarray:
    """One ulp of `dtype` at |a|."""
    bits = 8 if dtype == "bfloat16" else 11
    tiny = 2.0 ** (-126 if dtype == "bfloat16" else -14)
    mag = np.maximum(np.abs(a), tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - (bits - 1))


def _close_stored(got, want, u, dtype, what, steps=STEPS):
    g, w = _np(got), _np(want)
    lim = 2 * steps * LR * u + _ulp(np.maximum(np.abs(g), np.abs(w)), dtype)
    assert np.all(np.abs(g - w) <= lim), (what, float(np.abs(g - w).max()))


# ------------------------------------------------------------- the policy

PRESETS = ["float32", "float64", "mixed_bfloat16", "mixed_float16",
           "bfloat16", "float16"]
OVERRIDES = [
    {"name": "mixed_float16", "initial_loss_scale": 1024.0,
     "loss_scale_growth_interval": 7, "loss_scale_growth_factor": 4.0,
     "loss_scale_backoff_factor": 0.25},
    {"name": "float32", "compute_dtype": "bfloat16",
     "output_dtype": "bfloat16"},
    {"name": "mixed_bfloat16", "transfer_dtype": "bfloat16"},
    {"name": "bfloat16", "param_dtype": "float16",
     "dynamic_loss_scale": True},
    {"name": "float16", "dynamic_loss_scale": False},
]


@pytest.mark.parametrize("policy", PRESETS + OVERRIDES,
                         ids=PRESETS + [f"override{i}"
                                        for i in range(len(OVERRIDES))])
def test_policy_to_dict_and_resolution_are_the_references(policy):
    mine = dtype_policy.DtypePolicy.of(policy)
    ref = jax_policy.DtypePolicy.of(policy)
    assert mine.to_dict() == ref.to_dict()
    assert mine.resolved() == (ref.resolved_param_dtype,
                               ref.resolved_compute_dtype,
                               ref.resolved_output_dtype)
    assert mine.low_precision_params == ref.low_precision_params
    assert mine.uses_loss_scaling == ref.uses_loss_scaling
    prec = dtype_policy.resolve_policy(types.SimpleNamespace(
        dtype_policy=policy))
    assert str(prec.param_dtype) == f"torch.{ref.resolved_param_dtype}"
    assert str(prec.compute_dtype) == f"torch.{ref.resolved_compute_dtype}"
    assert str(prec.output_dtype) == f"torch.{ref.resolved_output_dtype}"
    assert prec.low_precision_params == ref.low_precision_params
    assert prec.loss_scaling == ref.uses_loss_scaling
    assert (prec.initial_loss_scale, prec.growth_interval,
            prec.growth_factor, prec.backoff_factor) == (
        ref.initial_loss_scale, ref.loss_scale_growth_interval,
        ref.loss_scale_growth_factor, ref.loss_scale_backoff_factor)
    assert (prec.transfer_dtype is None) == (ref.transfer_dtype is None)


@pytest.mark.parametrize("legacy", ["float32", "float64", "bfloat16",
                                    "float16"])
def test_legacy_dtype_string_resolves_as_the_reference(legacy):
    g = types.SimpleNamespace(dtype=legacy, dtype_policy=None)
    assert dtype_policy.conf_policy(g).to_dict() == \
        jax_policy.resolve_policy(g).to_dict()
    # The char-RNN built with the legacy string trains at the reference's
    # policy: f32 params and no reserved updater keys under "float16".
    conf = jax_zoo.char_rnn(vocab_size=10, hidden=8, dtype=legacy)
    jnet = JaxMLN(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    assert net.dtype_policy.name == jnet.dtype_policy.name
    assert {k for k in net.opt_state if k.startswith("_")} == \
        {k for k in jnet.opt_state if k.startswith("_")}
    assert str(net.params_tree["layer_0"]["W"].dtype) == \
        f"torch.{jnet.params_tree['layer_0']['W'].dtype}"


# ----------------------------------------------------------- the MLP steps


def _mlp(mod, policy, updater="adam", lr=LR):
    NNC, Dense, Out, IT = mod
    return (NNC.builder().seed(7).learning_rate(lr).updater(updater)
            .weight_init("xavier").dtype_policy(policy).list()
            .layer(Dense(n_out=8, activation="tanh"))
            .layer(Out(n_out=3, activation="softmax",
                       loss_function="mcxent"))
            .set_input_type(IT.feed_forward(4)).build())


JAX_MOD = (JaxNNC, jax_layers.DenseLayer, jax_layers.OutputLayer,
           JaxInputType)
PORT_MOD = (NeuralNetConfiguration, layers.DenseLayer, layers.OutputLayer,
            InputType)


def _batches(n=STEPS, seed=0, b=6):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, 4).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, b)])
            for _ in range(n)]


def _pair(policy, updater="adam", lr=LR):
    """The reference's MLP and the port's from its params (its masters
    where it keeps them, so both start from the same f32 values)."""
    jnet = JaxMLN(_mlp(JAX_MOD, policy, updater, lr)).init()
    src = jnet.opt_state.get("_master", jnet.params_tree)
    net = MultiLayerNetwork(_mlp(PORT_MOD, policy, updater, lr),
                            device="cpu").init(
        params=interop.params_from_numpy(_tree(src)))
    return jnet, net


def _assert_like_reference(net, jnet, policy, what="", steps=STEPS):
    u = U[_compute_of(policy)]
    stored = _stored_of(policy)
    for lk, p in jnet.params_tree.items():
        for k, a in p.items():
            if stored in ("bfloat16", "float16"):
                _close_stored(net.params_tree[lk][k], a, u, stored,
                              f"{what} params {lk}/{k}", steps)
            else:
                _close_f32(net.params_tree[lk][k], a, u,
                           f"{what} params {lk}/{k}", steps=steps)
    if "_master" in jnet.opt_state:
        for lk, p in jnet.opt_state["_master"].items():
            for k, a in p.items():
                m = net.opt_state["_master"][lk][k]
                assert m.dtype == torch.float32
                _close_f32(m, a, u, f"{what} master {lk}/{k}", steps=steps)
                # Stored params are the cast of the masters, bit for bit,
                # in each package.
                assert torch.equal(m.to(net.params_tree[lk][k].dtype),
                                   net.params_tree[lk][k].detach())
                np.testing.assert_array_equal(
                    np.asarray(jnp.asarray(a).astype(
                        jnet.params_tree[lk][k].dtype)).astype(np.float32),
                    _np(jnet.params_tree[lk][k]))
    else:
        assert "_master" not in net.opt_state
    for lk, fields in jnet.opt_state.items():
        if lk.startswith("_"):
            continue
        for f, s in fields.items():
            scale = max(float(np.abs(_np(a)).max()) for a in s.values())
            for k, a in s.items():
                st = net.opt_state[lk][f][k]
                assert st.dtype == torch.float32
                _close_state(st, a, u, scale, f"{what} {f} {lk}/{k}")
    if "_ls" in jnet.opt_state:
        assert [float(t) for t in net.opt_state["_ls"]] == \
            [float(t) for t in jnet.opt_state["_ls"]]
    else:
        assert "_ls" not in net.opt_state
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=4 * u + 1e-6)


@pytest.mark.parametrize("updater", ["adam", "nesterovs"])
@pytest.mark.parametrize("policy", LOW)
def test_mlp_steps_match_the_reference(policy, updater):
    jnet, net = _pair(policy, updater)
    for x, y in _batches():
        jnet.fit(JaxDS(x, y))
        net.fit(DataSet(x, y))
    assert net.params_tree["layer_0"]["W"].dtype == getattr(
        torch, _stored_of(policy))
    _assert_like_reference(net, jnet, policy)
    out = net.output(_batches(1, seed=9)[0][0])
    want = np.asarray(jnet.output(_batches(1, seed=9)[0][0]))
    assert out.dtype == np.float32 or str(out.dtype) == str(want.dtype) \
        or policy in ("bfloat16",)
    np.testing.assert_allclose(_np(out), _np(want),
                               atol=8 * U[_compute_of(policy)])


@pytest.mark.parametrize("policy", ["bfloat16", "mixed_float16"])
def test_reference_updater_state_with_masters_and_scale_through_interop(
        policy):
    pol = {"name": policy, "initial_loss_scale": 64.0,
           "loss_scale_growth_interval": 2} if policy == "mixed_float16" \
        else policy
    jnet, _ = _pair(pol)
    for x, y in _batches(2):
        jnet.fit(JaxDS(x, y))
    net = MultiLayerNetwork(_mlp(PORT_MOD, pol), device="cpu").init(
        params=interop.params_from_numpy(_tree(jnet.params_tree)),
        updater_state=interop.updater_state_from_numpy(
            _tree(jnet.opt_state), jnet.iteration))
    assert net.iteration == 2
    if "_master" in jnet.opt_state:
        np.testing.assert_array_equal(
            _np(net.opt_state["_master"]["layer_0"]["W"]),
            _np(jnet.opt_state["_master"]["layer_0"]["W"]))
    if "_ls" in jnet.opt_state:
        assert [float(t) for t in net.opt_state["_ls"]] == \
            [float(t) for t in jnet.opt_state["_ls"]] == [128.0, 0.0]
    x, y = _batches(1, seed=8)[0]
    jnet.fit(JaxDS(x, y))
    net.fit(DataSet(x, y))
    _assert_like_reference(net, jnet, pol, steps=1)


# ---------------------------------------------------------- loss scaling


def _snapshot(net):
    return ({lk: {k: t.detach().clone() for k, t in p.items()}
             for lk, p in net.params_tree.items()},
            {k: (tuple(t.clone() for t in v) if k == "_ls" else
                 {a: ({b: t.clone() for b, t in s.items()}
                      if isinstance(s, dict) else s.clone())
                  for a, s in v.items()})
             for k, v in net.opt_state.items()})


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("updater", ["adam", "nesterovs", "sgd"])
@pytest.mark.parametrize("policy", ["mixed_float16", "float16"])
def test_a_nonfinite_step_is_skipped_as_in_the_reference(policy, updater):
    pol = {"name": policy, "initial_loss_scale": 2.0 ** 100}
    jnet, net = _pair(pol, updater)
    before = _snapshot(net)
    jbefore = _tree(jnet.params_tree), _tree(jnet.opt_state)
    x, y = _batches(1)[0]
    jnet.fit(JaxDS(x, y))
    net.fit(DataSet(x, y))
    # Both skipped: everything bit-equal to before, the scale halved.
    assert _same(before[0], _snapshot(net)[0])
    after = _snapshot(net)[1]
    for k in before[1]:
        if k != "_ls":
            assert _same(before[1][k], after[k]), k
    assert float(net.opt_state["_ls"][0]) == 2.0 ** 99
    assert float(net.opt_state["_ls"][1]) == 0.0
    assert [float(t) for t in jnet.opt_state["_ls"]] == [2.0 ** 99, 0.0]
    for lk, p in jbefore[0].items():
        for k, a in p.items():
            np.testing.assert_array_equal(_np(jnet.params_tree[lk][k]),
                                          _np(a))
    assert net.iteration == jnet.iteration == 1
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=4 * U["float16"])


def test_the_scale_grows_after_its_interval_as_in_the_reference():
    pol = {"name": "mixed_float16", "initial_loss_scale": 8.0,
           "loss_scale_growth_interval": 2}
    jnet, net = _pair(pol)
    seq = []
    for x, y in _batches(5, seed=3):
        jnet.fit(JaxDS(x, y))
        net.fit(DataSet(x, y))
        mine = [float(t) for t in net.opt_state["_ls"]]
        assert mine == [float(t) for t in jnet.opt_state["_ls"]]
        seq.append(mine)
    assert seq == [[8.0, 1.0], [16.0, 0.0], [16.0, 1.0], [32.0, 0.0],
                   [32.0, 1.0]]
    _assert_like_reference(net, jnet, pol)


def test_the_scale_is_updated_on_the_device_without_a_host_read(monkeypatch):
    # The step never reads the scale or the finite flag back: a `.item()`
    # or `float()` of a tensor during `fit` would show here.
    _, net = _pair("mixed_float16")
    x, y = _batches(1)[0]
    net.fit(DataSet(x, y))  # the first step builds what it keeps
    reads = []
    for name in ("item", "__float__", "__bool__", "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    net.fit(DataSet(x, y))
    monkeypatch.undo()
    assert reads == []


# ----------------------------------------------------- the LM and char-RNN

LM = dict(t=32, d_model=32, n_heads=4, n_blocks=2)
LM_V = 64


def _lm_pool(n=STEPS, b=2):
    rng = np.random.RandomState(4)
    out = []
    for _ in range(n):
        ids = rng.randint(0, LM_V, (b, LM["t"] + 1))
        out.append((ids[:, :-1, None].astype(np.float32),
                    ids[:, 1:].astype(np.int32)))
    return out


# The LM's loss sums over T, so at the preset's 2^15 the f16 backward
# overflows and the first steps are skipped (in both packages alike); 2^8
# lets them update.
LM_POLICIES = {"mixed_float16": {"name": "mixed_float16",
                                 "initial_loss_scale": 256.0},
               "bfloat16": "bfloat16"}


@pytest.mark.parametrize("name", ["mixed_float16", "bfloat16"])
def test_small_lm_fit_matches_the_reference(name):
    policy = LM_POLICIES[name]
    jconf = jax_zoo.transformer_lm(LM_V, **LM)
    jconf.global_conf.dtype_policy = jax_policy.DtypePolicy.of(policy)
    jnet = JaxGraph(jconf).init()
    src = jnet.opt_state.get("_master", jnet.params_tree)
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init(
        params=interop.params_from_numpy(_tree(src)))
    assert net.dtype_policy.name == name
    kernels.reset_counts()
    for x, y in _lm_pool():
        jnet.fit(JaxMDS([x], [y]))
        net.fit(MultiDataSet([x], [y]))
    plain = kernels.counts()["plain_calls"]
    assert plain["layernorm_norm_act"] == STEPS * (2 * LM["n_blocks"] + 1)
    assert plain["flash_attention_fwd_lse"] == STEPS * LM["n_blocks"]
    u = U[_compute_of(policy)]
    lr = float(jconf.global_conf.learning_rate)
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=4 * u)
    if "_ls" in jnet.opt_state:
        got = [float(t) for t in net.opt_state["_ls"]]
        assert got == [float(t) for t in jnet.opt_state["_ls"]]
        assert got == [256.0, 3.0]  # three finite steps
    diffs = []
    for lk, p in (jnet.opt_state.get("_master") or jnet.params_tree).items():
        for k, a in p.items():
            mine = (net.opt_state["_master"] if "_master" in jnet.opt_state
                    else net.params_tree)[lk][k]
            if "_master" in jnet.opt_state:
                assert torch.equal(mine.to(torch.bfloat16),
                                   net.params_tree[lk][k].detach())
            diffs.append(np.abs(_np(mine) - _np(a)).reshape(-1))
    # Low-precision compute: Adam's early steps are about lr * sign(g), and
    # the sign of a gradient near 0 (the attention projections' are) may
    # differ between the frameworks (the train slice's reason for
    # comparing no bf16 params). So each f32 leaf is held within the 2 n lr
    # that sign flips allow, and the mean difference within a tenth of one
    # step.
    d = np.concatenate(diffs)
    assert d.max() <= 2 * STEPS * lr
    assert d.mean() <= 0.1 * lr, d.mean()


def test_small_lm_skips_the_reference_s_steps_at_the_preset_scale():
    # At the preset's 2^15 the LM's f16 backward overflows (its loss sums
    # over T): both packages skip the same first steps, the port through
    # its plain versions, with the same scale pair after every step.
    jconf = jax_zoo.transformer_lm(LM_V, **LM)
    jconf.global_conf.dtype_policy = jax_policy.DtypePolicy.of(
        "mixed_float16")
    jnet = JaxGraph(jconf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init(
        params=interop.params_from_numpy(_tree(jnet.params_tree)))
    scales = [float(net.opt_state["_ls"][0])]
    for x, y in _lm_pool():
        jnet.fit(JaxMDS([x], [y]))
        net.fit(MultiDataSet([x], [y]))
        mine = [float(t) for t in net.opt_state["_ls"]]
        assert mine == [float(t) for t in jnet.opt_state["_ls"]]
        scales.append(mine[0])
    assert scales[:2] == [2.0 ** 15, 2.0 ** 14], scales  # the first skipped


def test_char_rnn_tbptt_under_mixed_float16_matches_the_reference():
    jconf = jax_zoo.char_rnn(vocab_size=11, hidden=16, tbptt_length=5)
    jconf.global_conf.dtype_policy = jax_policy.DtypePolicy.of(
        {"name": "mixed_float16", "initial_loss_scale": 16.0,
         "loss_scale_growth_interval": 3})
    jnet = JaxMLN(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init(
        params=interop.params_from_numpy(_tree(jnet.params_tree)))
    rng = np.random.RandomState(6)
    for _ in range(2):
        ids = rng.randint(0, 11, (3, 13))
        x = np.eye(11, dtype=np.float32)[ids]
        y = np.eye(11, dtype=np.float32)[np.roll(ids, -1, axis=1)]
        jnet.fit(JaxDS(x, y))
        net.fit(DataSet(x, y))
        # One scale update per chunk (3 chunks of 5, 5, 3 steps).
        assert [float(t) for t in net.opt_state["_ls"]] == \
            [float(t) for t in jnet.opt_state["_ls"]]
    assert net.iteration == jnet.iteration == 2
    assert float(net.opt_state["_ls"][0]) == 64.0  # 6 finite chunks
    u = U["float16"]
    lr = float(jconf.global_conf.learning_rate)
    np.testing.assert_allclose(net.score_value, jnet.score_value, rtol=4 * u)
    # RMSProp's first steps are about lr g / sqrt(0.05 g^2), 4.5 lr sign(g)
    # at lr 0.1: a gradient near 0 whose sign differs between the two
    # frameworks' f16 sums moves its weight by up to twice that (the LM's
    # reason). So each param is held within one such flip and the mean
    # difference within a quarter of lr (0.125 lr seen; in f32 the same
    # run differs by 1e-4 lr).
    d = np.concatenate([np.abs(_np(net.params_tree[lk][k]) - _np(a))
                        .reshape(-1) for lk, p in jnet.params_tree.items()
                        for k, a in p.items()])
    assert d.max() <= 2 * lr / np.sqrt(1 - 0.95)
    assert d.mean() <= 0.25 * lr, d.mean()


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("policy", ["bfloat16", "mixed_float16"])
def test_pretraining_under_masters_or_scaling_raises_the_references_error(
        policy):
    def conf(mod):
        NNC, L, IT = mod
        return (NNC.builder().seed(3).updater("adam").dtype_policy(policy)
                .list().layer(L.AutoEncoder(n_out=4))
                .layer(L.OutputLayer(n_out=3, activation="softmax",
                                     loss_function="mcxent"))
                .set_input_type(IT.feed_forward(6)).pretrain(True).build())

    x = np.random.RandomState(0).rand(5, 6).astype(np.float32)
    jnet = JaxMLN(conf((JaxNNC, jax_layers, JaxInputType))).init()
    with pytest.raises(ValueError) as want:
        jnet.pretrain([JaxDS(x, None)])
    net = MultiLayerNetwork(conf((NeuralNetConfiguration, layers,
                                  InputType)), device="cpu").init()
    with pytest.raises(ValueError) as got:
        net.pretrain([DataSet(x, None)])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("what", ["superstep", "solver"])
def test_superstep_and_solvers_still_name_a10_under_a_policy(what):
    b = (NeuralNetConfiguration.builder().seed(7).updater("adam")
         .dtype_policy("mixed_float16"))
    b = b.superstep_k(4) if what == "superstep" else b.optimization_algo(
        "lbfgs")
    conf = (b.list().layer(layers.OutputLayer(
        n_out=3, activation="softmax", loss_function="mcxent"))
        .set_input_type(InputType.feed_forward(4)).build())
    x, y = _batches(1)[0]
    net = MultiLayerNetwork(conf, device="cpu").init()
    if what == "superstep":
        # Superstep training is in and runs loss-scaled steps: a lone
        # batch is a block of one, one step.
        net.fit(DataSet(x, y))
        assert net.iteration == 1
        return
    # A solver refuses loss scaling as the reference does, before a step.
    with pytest.raises(ValueError, match="does not support dtype policy"):
        net.fit(DataSet(x, y))
    assert net.iteration == 0


# ----------------------------------------------------------- quantization


@pytest.mark.parametrize("shape", [(5, 7), (3, 3, 4, 6), (8, 1), (2, 3)])
def test_quantize_array_is_the_references_bit_for_bit(shape):
    w = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel: scale 1
    q, s = quantize.quantize_array(w)
    jq, js = jax_quantize.quantize_array(w)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert s[0] == 1.0


def test_quantize_tree_is_the_references_bit_for_bit():
    jnet = JaxMLN(_mlp(JAX_MOD, "float32")).init()
    tree = _tree(jnet.params_tree)
    got = quantize.quantize_tree(interop.params_from_numpy(tree))
    want = jax_quantize.quantize_tree(tree)
    assert got.keys() == want.keys()
    for lk in want:
        assert got[lk].keys() == want[lk].keys()
        for k in want[lk]:
            assert np.asarray(got[lk][k]).dtype == np.asarray(
                want[lk][k]).dtype
            np.testing.assert_array_equal(got[lk][k], want[lk][k])


def _small_bottleneck(mod):
    """A graph of a conv+BN stem, one projecting fused BottleneckBlock and
    a dense output, the shape `resnet50`'s fused form uses."""
    NNC, L, IT, helpers = mod
    b = (NNC.builder().seed(11).learning_rate(0.05).updater("nesterovs")
         .momentum(0.9).weight_init("relu")
         .graph_builder().add_inputs("input"))
    x = helpers._conv_bn(b, "stem", "input", 8, (3, 3), (2, 2))
    x = helpers._bottleneck_fused(b, "s0_b0", x, 4, (2, 2), project=True)
    b.add_layer("avgpool", L.GlobalPoolingLayer(pooling_type="avg"), x)
    b.add_layer("fc", L.OutputLayer(n_out=5, activation="softmax",
                                    loss_function="mcxent"), "avgpool")
    return (b.set_outputs("fc")
            .set_input_types(IT.convolutional(12, 12, 3)).build())


def _train_ref_graph(jconf, steps=2):
    jnet = JaxGraph(jconf).init()
    rng = np.random.RandomState(8)
    for _ in range(steps):
        x = rng.randn(4, 12, 12, 3).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 4)]
        jnet.fit(JaxMDS([x], [y]))
    return jnet


@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
def test_quantized_bottleneck_graph_output_is_the_references(tmp_path,
                                                            policy):
    jconf = _small_bottleneck((JaxNNC, jax_layers, JaxInputType,
                               jax_resnet))
    jconf.global_conf.dtype_policy = jax_policy.DtypePolicy.of(policy)
    jnet = _train_ref_graph(jconf)
    src = jax_store.save_checkpoint(jnet, str(tmp_path / "f"))
    q = jax_quantize.quantize_checkpoint(src, str(tmp_path / "q"))
    jq = jax_store.restore_checkpoint(q)
    net = store.restore_checkpoint(q, device="cpu")
    blk = net.params_tree["s0_b0_block"]
    assert blk["W_a"].dtype == torch.int8 and "W_a__scale" in blk
    assert net.params_tree["fc"]["W"].dtype == torch.int8
    x = np.random.RandomState(2).randn(3, 12, 12, 3).astype(np.float32)
    kernels.reset_counts()
    got = net.output(x)[0]
    want = np.asarray(jq.output(x)[0], np.float32)
    tol = dict(rtol=1e-4, atol=1e-6) if policy == "float32" else \
        dict(rtol=4e-2, atol=4e-2)
    np.testing.assert_allclose(_np(got), want, **tol)
    assert kernels.counts()["plain_calls"]["bottleneck_infer"] == 1
    with pytest.raises(ValueError, match="quantized int8"):
        net.fit(MultiDataSet([x], [np.eye(5, dtype=np.float32)[:3]]))


def test_quantized_lenet_output_is_the_references(tmp_path):
    jconf = jax_zoo.lenet_mnist()
    jnet = JaxMLN(jconf).init()
    src = jax_store.save_checkpoint(jnet, str(tmp_path / "f"))
    q = jax_quantize.quantize_checkpoint(src, str(tmp_path / "q"))
    net = store.restore_checkpoint(q, device="cpu")
    jq = jax_store.restore_checkpoint(q)
    assert net.params_tree["layer_0"]["W"].dtype == torch.int8
    x = np.random.RandomState(3).rand(4, 28, 28, 1).astype(np.float32)
    np.testing.assert_allclose(net.output(x), np.asarray(jq.output(x)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_quantized_checkpoint_restores_in_the_other_package(tmp_path,
                                                             writer):
    jnet = JaxMLN(_mlp(JAX_MOD, "float32")).init()
    for x, y in _batches(2):
        jnet.fit(JaxDS(x, y))
    src = jax_store.save_checkpoint(jnet, str(tmp_path / "f"))
    mod = quantize if writer == "port" else jax_quantize
    q = mod.quantize_checkpoint(src, str(tmp_path / "q"))
    other = quantize if writer != "port" else jax_quantize
    q2 = other.quantize_checkpoint(src, str(tmp_path / "q2"))
    # Both packages write the same leaves, bit for bit.
    ia, ib = store.read_index(q), store.read_index(q2)
    assert ia["leaves"].keys() == ib["leaves"].keys()
    for key, e in ia["leaves"].items():
        assert e["dtype"] == ib["leaves"][key]["dtype"]
        np.testing.assert_array_equal(
            store.read_full(q, e), store.read_full(q2, ib["leaves"][key]))
    ma, mb = store.read_meta(q), store.read_meta(q2)
    assert ma["quantization"] == mb["quantization"]
    assert "dtype_policy" not in ma
    net = store.restore_checkpoint(q, device="cpu")
    jq = jax_store.restore_checkpoint(q)
    for lk, p in jq.params_tree.items():
        for k, a in p.items():
            np.testing.assert_array_equal(_np(net.params_tree[lk][k]),
                                          _np(a))
    x = _batches(1, seed=5)[0][0]
    np.testing.assert_allclose(net.output(x), np.asarray(jq.output(x)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("engine", ["mln", "graph"])
def test_quantized_params_through_interop_give_the_references_output(engine):
    if engine == "mln":
        jnet = JaxMLN(_mlp(JAX_MOD, "float32")).init()
        make = lambda: MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jnet.conf.to_json()), device="cpu")
        x = _batches(1, seed=6)[0][0]
    else:
        jnet = JaxGraph(_small_bottleneck((JaxNNC, jax_layers, JaxInputType,
                                           jax_resnet))).init()
        make = lambda: ComputationGraph(
            ComputationGraphConfiguration.from_json(jnet.conf.to_json()),
            device="cpu")
        x = np.random.RandomState(6).randn(2, 12, 12, 3).astype(np.float32)
    q = jax_quantize.quantize_tree(_tree(jnet.params_tree))
    net = make().init(params=interop.params_from_numpy(q),
                      state=None if not jnet.state else
                      interop.state_from_numpy(_tree(jnet.state)))
    assert any(t.dtype == torch.int8 for p in net.params_tree.values()
               for t in p.values())
    # The port's own in-place quantization of the f32 params gives the
    # same tree.
    own = quantize.quantize_net(make().init(
        params=interop.params_from_numpy(_tree(jnet.params_tree)),
        state=None if not jnet.state else
        interop.state_from_numpy(_tree(jnet.state))))
    for v, p in net.params_tree.items():
        for k, t in p.items():
            assert torch.equal(own.params_tree[v][k], t)
    jax_quantize.quantize_net(jnet)
    want = jnet.output(x)
    got, mine = net.output(x), own.output(x)
    if engine == "graph":
        got, want, mine = got[0], want[0], mine[0]
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(_np(mine), _np(got))
    with pytest.raises(ValueError, match="per-channel scale"):
        bad = interop.params_from_numpy(q)
        v, w = next((v, k) for v, p in bad.items() for k in p
                    if k + "__scale" in p)
        bad[v][w + "__scale"] = torch.ones(bad[v][w].shape[-1] + 1)
        make().init(params=bad)


def test_quantize_cli_writes_the_int8_checkpoint(tmp_path, capsys):
    net = MultiLayerNetwork(_mlp(PORT_MOD, "float32"), device="cpu").init()
    src = store.save_checkpoint(net, str(tmp_path / "step_00000000"))
    assert quantize.main([src, str(tmp_path / "q")]) == 0
    assert capsys.readouterr().out.strip() == str(tmp_path / "q")
    back = store.restore_checkpoint(str(tmp_path / "q"), device="cpu")
    assert back.params_tree["layer_1"]["W"].dtype == torch.int8
    assert back.params_tree["layer_1"]["b"].dtype == torch.float32


# ---------------------------------------------------------- transfer dtype


def test_transfer_dtype_halves_host_bytes_and_fit_is_the_references():
    pol = {"name": "mixed_bfloat16", "transfer_dtype": "bfloat16"}
    jnet, net = _pair(pol)
    x, y = _batches(1)[0]
    ds = DataSet(x, y)
    cast = staging.transfer_cast(ds, net.dtype_policy.transfer_dtype)
    assert cast.features.dtype == cast.labels.dtype == torch.bfloat16
    assert (cast.features.numel() + cast.labels.numel()) * 2 * 2 == \
        ds.features.nbytes + ds.labels.nbytes
    jnet.fit(JaxDS(x, y))
    net.fit(ds)
    _assert_like_reference(net, jnet, pol)
    # Integer parts and masks pass through.
    ids = np.arange(6).reshape(2, 3)
    mask = np.ones((2, 3), np.float32)
    m = staging.transfer_cast(MultiDataSet([ids], [ids], [mask], None),
                              torch.bfloat16)
    assert m.features[0] is ids and m.features_masks[0] is mask


# ------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("policy", ["bfloat16", "mixed_float16"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_policy_checkpoints_cross_packages(tmp_path, policy, writer):
    jnet, net = _pair(policy)
    for x, y in _batches(2):
        jnet.fit(JaxDS(x, y))
        net.fit(DataSet(x, y))
    if writer == "port":
        path = store.save_checkpoint(net, str(tmp_path / "c"))
        back = jax_store.restore_checkpoint(path)
        src = net
        index = store.read_index(path)
        assert ("updater/_master/layer_0/W" in index["leaves"]) == \
            (policy == "bfloat16")
        assert ("updater/_ls/0" in index["leaves"]) == \
            (policy == "mixed_float16")
        for lk, p in src.params_tree.items():
            for k, t in p.items():
                np.testing.assert_array_equal(_np(back.params_tree[lk][k]),
                                              _np(t))
        mine, theirs = src.opt_state, back.opt_state
    else:
        path = jax_store.save_checkpoint(jnet, str(tmp_path / "c"))
        back = store.restore_checkpoint(path, device="cpu")
        for lk, p in jnet.params_tree.items():
            for k, a in p.items():
                np.testing.assert_array_equal(_np(back.params_tree[lk][k]),
                                              _np(a))
        mine, theirs = back.opt_state, jnet.opt_state
    assert back.dtype_policy.name == policy
    if policy == "bfloat16":
        for lk, p in theirs["_master"].items():
            for k, a in p.items():
                np.testing.assert_array_equal(_np(mine["_master"][lk][k]),
                                              _np(a))
    else:
        assert [float(t) for t in mine["_ls"]] == \
            [float(t) for t in theirs["_ls"]]
    if writer == "reference":
        # The port trains on from the restored state as the reference's
        # net does from its own (a restored reference net is not trained
        # here: its AOT-cached step hits this sandbox's compile-cache
        # fault, ROADMAP C).
        x, y = _batches(1, seed=4)[0]
        back.fit(DataSet(x, y))
        jnet.fit(JaxDS(x, y))
        _assert_like_reference(back, jnet, policy, writer)


@pytest.mark.parametrize("policy", ["bfloat16", "mixed_float16"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_policy_zips_cross_packages(tmp_path, policy, writer):
    jnet, net = _pair(policy)
    for x, y in _batches(2):
        jnet.fit(JaxDS(x, y))
        net.fit(DataSet(x, y))
    path = str(tmp_path / "m.zip")
    if writer == "port":
        model_serializer.save_model(net, path)
        back = jax_serializer.load_model(path)
        src_p, src_u = net.params(), net.updater_state_flat()
        got_p = np.asarray(back.params(), np.float64)
        got_u = np.asarray(back.updater_state_flat(), np.float64)
    else:
        jax_serializer.save_model(jnet, path)
        back = model_serializer.load_model(path, device="cpu")
        src_p = np.asarray(jnet.params(), np.float64)
        src_u = np.asarray(jnet.updater_state_flat(), np.float64)
        got_p, got_u = back.params(), back.updater_state_flat()
    with zipfile.ZipFile(path) as z:
        assert json.loads(z.read("configuration.json"))["global_conf"][
            "dtype_policy"]["name"] == policy
    np.testing.assert_array_equal(np.asarray(got_p, np.float64),
                                  np.asarray(src_p, np.float64))
    np.testing.assert_array_equal(np.asarray(got_u, np.float64),
                                  np.asarray(src_u, np.float64))
    # The flat updater views of both packages line up leaf for leaf
    # (`_ls` and `_master` where the reference's tree_leaves put them).
    u = U[_compute_of(policy)]
    np.testing.assert_allclose(net.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat(),
                                          np.float32),
                               rtol=2e-4, atol=2 * 2 * LR * u)


# ----------------------------------------------------- kernels on the CPU


def test_layernorm_plain_in_f16_is_the_references():
    rng = np.random.RandomState(1)
    x = rng.randn(6, 48)
    g, b = 1 + 0.1 * rng.randn(48), 0.1 * rng.randn(48)
    want = jax_norm_act.layernorm_xla(
        jnp.asarray(x, jnp.float16), jnp.asarray(g, jnp.float16),
        jnp.asarray(b, jnp.float16), 1e-5, "relu")
    kernels.reset_counts()
    got = norm_act.layernorm_norm_act(
        torch.tensor(x, dtype=torch.float16),
        torch.tensor(g, dtype=torch.float16),
        torch.tensor(b, dtype=torch.float16), 1e-5, "relu")
    assert got.dtype == torch.float16
    assert kernels.counts()["plain_calls"]["layernorm_norm_act"] == 1
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=4 * U["float16"], atol=4 * U["float16"])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_versions_in_f16_are_the_references(causal):
    rng = np.random.RandomState(7)
    arrs = [rng.randn(2, 128, 2, 16) for _ in range(4)]
    jq, jk, jv, jg = (jnp.asarray(a, jnp.float16) for a in arrs)
    q, k, v, g = (torch.tensor(a, dtype=torch.float16) for a in arrs)

    def loss(q_, k_, v_):
        o = jax_fa._flash_attention_pallas(q_, k_, v_, causal, None, 64, 64)
        return jnp.sum(o.astype(jnp.float32) * jg.astype(jnp.float32))

    wo = jax_fa._flash_attention_pallas(jq, jk, jv, causal, None, 64, 64)
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tol = dict(rtol=8 * U["float16"], atol=8 * U["float16"])
    o3 = fa.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(o3), _np(wo), **tol)
    for a in (q, k, v):
        a.requires_grad_(True)
    kernels.reset_counts()
    o = fa.flash_attention(q, k, v, causal=causal)
    assert o.dtype == torch.float16
    got = torch.autograd.grad(o, (q, k, v), g)
    plain = kernels.counts()["plain_calls"]
    assert (plain["flash_attention_fwd_lse"], plain["flash_attention_bwd_dq"],
            plain["flash_attention_bwd_dkv"]) == (1, 1, 1)
    np.testing.assert_allclose(_np(o), _np(wo), **tol)
    for a, b in zip(got, want):
        assert a.dtype == torch.float16
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("lp", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind,fields,hyper", [
    ("adam", ("m", "v"), (0.9, 0.999, 1e-8)),
    ("nesterovs", ("v",), (0.9,)),
    ("rmsprop", ("g2",), (0.95, 1e-8))])
def test_update_plain_skip_and_low_precision_write(kind, fields, hyper, lp):
    gen = torch.Generator().manual_seed(3)

    def item(low):
        ps = {"W": torch.randn(7, 5, generator=gen),
              "b": torch.randn(5, generator=gen)}
        gs = {k: torch.randn(t.shape, generator=gen) for k, t in ps.items()}
        st = {f: {k: torch.rand(t.shape, generator=gen) * 0.1
                  for k, t in ps.items()} for f in fields}
        return fused_update.UpdateItem(
            ps, st, gs, 0.01, {"b": 2.0},
            {k: t.to(lp) for k, t in ps.items()} if low else None)

    gen.manual_seed(3)
    free = item(False)
    gen.manual_seed(3)
    low = item(True)
    gen.manual_seed(3)
    held = item(True)
    before = ({k: t.clone() for k, t in held.params.items()},
              {f: {k: t.clone() for k, t in s.items()}
               for f, s in held.state.items()},
              {k: t.clone() for k, t in held.lowp.items()})
    st_free, = fused_update.apply_step(kind, hyper, [free], 1, 1.0)
    st_low, = fused_update.apply_step(
        kind, hyper, [low], 1, 1.0,
        skip=torch.zeros((), dtype=torch.int32))
    st_held, = fused_update.apply_step(
        kind, hyper, [held], 1, 1.0,
        skip=torch.ones((), dtype=torch.int32))
    for k in free.params:
        # A clear flag: the f32 masters are the f32 update, bit for bit,
        # and the stored params their round-to-nearest cast.
        assert torch.equal(low.params[k], free.params[k])
        assert torch.equal(low.lowp[k], free.params[k].to(lp))
        for f in fields:
            assert torch.equal(st_low[f][k], st_free[f][k])
        # A set flag: nothing moves.
        assert torch.equal(held.params[k], before[0][k])
        assert torch.equal(held.lowp[k], before[2][k])
        for f in fields:
            assert torch.equal(st_held[f][k], before[1][f][k])
        assert not torch.equal(free.params[k], before[0][k])
