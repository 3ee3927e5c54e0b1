"""The port's training slice as a whole against the JAX package, on the CPU:
`ComputationGraph.fit` on `transformer_lm` (Adam, sparse int labels).

A JAX `transformer_lm(V=64, t=256, d_model=32, n_heads=4, n_blocks=2)` is
carried over with `to_json()` -> `from_json` and `params_from_numpy`; at
T = 256 the JAX step runs its Pallas flash forward-with-lse and backward
in interpret mode, the port its plain versions behind the same autograd
seams. Both packages train on one 2-batch pool (B = 2, float32 id
features, int32 labels, as `bench.py:1131-1134` feeds them).

Tolerances: f32 scores, params and Adam m/v rtol 2e-4, atol 2e-5 (the
flash tolerance: attention's sums run in another order, and three Adam
steps carry that through); bf16 scores 4e-2 relative. bf16 params are not
compared: Adam's first step is about lr * sign(g), and the sign of a
near-zero gradient may flip between the two frameworks.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import prng
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

V, T, D, H, NB, B = 64, 256, 32, 4, 2, 2
F32 = dict(rtol=2e-4, atol=2e-5)


def _pool():
    rng = np.random.RandomState(0)
    pool = []
    for _ in range(2):
        ids = rng.randint(0, V, (B, T + 1))
        pool.append((ids[:, :-1, None].astype(np.float32),
                     ids[:, 1:].astype(np.int32)))
    return pool


def _np_tree(tree):
    # np.array copies: the JAX step donates its buffers.
    return {v: ({f: {k: np.array(a) for k, a in s.items()}
                 for f, s in p.items()} if isinstance(next(iter(p.values()),
                                                           None), dict)
                else {k: np.array(a) for k, a in p.items()})
            for v, p in tree.items()}


def _port(jconf, params, **kw):
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    return ComputationGraph(conf, device="cpu").init(
        params=interop.params_from_numpy(params), **kw)


def _assert_trees(port_tree, jax_tree, what):
    for v, p in jax_tree.items():
        for k, a in p.items():
            np.testing.assert_allclose(
                port_tree[v][k].detach().numpy(), a,
                err_msg=f"{what} {v}/{k}", **F32)


@pytest.fixture(scope="module")
def f32_run():
    """3 JAX steps and 3 port steps from the same params, with every
    score, the state after step 2 and after step 3."""
    jconf = jax_zoo.transformer_lm(V, t=T, d_model=D, n_heads=H, n_blocks=NB)
    jnet = JaxGraph(jconf).init()
    params0 = _np_tree(jnet.params_tree)
    pnet = _port(jconf, params0)
    pool = _pool()
    out = {"jconf": jconf, "jnet": jnet, "pnet": pnet, "pool": pool,
           "jax_scores": [], "port_scores": []}
    kernels.reset_counts()
    for step in range(3):
        x, y = pool[step % 2]
        if step == 2:
            out["jax_params_2"] = _np_tree(jnet.params_tree)
            out["jax_opt_2"] = _np_tree(jnet.opt_state)
        jnet.fit(JaxMDS([x], [y]))
        pnet.fit(MultiDataSet([x], [y]))
        out["jax_scores"].append(jnet.score_value)
        out["port_scores"].append(pnet.score_value)
    out["counts"] = kernels.counts()
    return out


def test_f32_fit_matches_jax_step_by_step(f32_run):
    r = f32_run
    np.testing.assert_allclose(r["port_scores"], r["jax_scores"], **F32)
    # ~T * ln V at the start: the score sums over time, divides by B only.
    assert abs(r["jax_scores"][0] / (T * np.log(V)) - 1) < 0.1
    jnet, pnet = r["jnet"], r["pnet"]
    assert pnet.iteration == jnet.iteration == 3
    _assert_trees(pnet.params_tree, _np_tree(jnet.params_tree), "params")
    jopt = _np_tree(jnet.opt_state)
    for f in ("m", "v"):
        _assert_trees({v: s[f] for v, s in pnet.opt_state.items()},
                      {v: s[f] for v, s in jopt.items()}, f)
    # Per step: 2*NB+1 LayerNorms, NB attentions forward and backward, one
    # fused update per layer vertex (24 at 4 blocks; 14 here).
    plain = r["counts"]["plain_calls"]
    assert plain["layernorm_norm_act"] == 3 * (2 * NB + 1)
    assert plain["flash_attention_fwd_lse"] == 3 * NB
    assert plain["flash_attention_bwd_dq"] == 3 * NB
    assert plain["flash_attention_bwd_dkv"] == 3 * NB
    assert plain["fused_update"] == 3 * len(pnet.layer_vertices) == 3 * 14
    assert plain["flash_attention"] == 0
    assert not any(r["counts"]["launches"].values())


def test_output_after_fit_matches_jax(f32_run):
    x, _ = f32_run["pool"][1]
    want = f32_run["jnet"].output(x)[0]
    got = f32_run["pnet"].output(x)[0]
    np.testing.assert_allclose(got, want, **F32)


def test_resume_from_jax_state(f32_run):
    r = f32_run
    pnet = _port(r["jconf"], r["jax_params_2"],
                 updater_state=interop.updater_state_from_numpy(
                     r["jax_opt_2"], 2))
    assert pnet.iteration == 2
    x, y = r["pool"][0]
    pnet.fit(DataSet(x, y))
    np.testing.assert_allclose(pnet.score_value, r["jax_scores"][2], **F32)
    _assert_trees(pnet.params_tree, _np_tree(r["jnet"].params_tree),
                  "resumed params")
    with pytest.raises(ValueError, match="updater state"):
        _port(r["jconf"], r["jax_params_2"],
              updater_state=interop.updater_state_from_numpy(
                  {"emb": {"m": {}}}, 2))


def test_bf16_fit_scores_match_jax_and_refresh_the_compute_copy():
    jconf = jax_zoo.transformer_lm(V, t=T, d_model=D, n_heads=H, n_blocks=NB,
                                   dtype="bfloat16")
    jnet = JaxGraph(jconf).init()
    pnet = _port(jconf, _np_tree(jnet.params_tree))
    assert pnet.dtype_policy.name == "mixed_bfloat16"
    pool = _pool()
    before = pnet.output(pool[0][0])[0]
    for step in range(3):
        x, y = pool[step % 2]
        jnet.fit(JaxMDS([x], [y]))
        pnet.fit(MultiDataSet([x], [y]))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   rtol=4e-2)
    # Grads reached the f32 params through the bf16 compute cast, and the
    # inference copy is rebuilt from them: a fresh net loaded with the
    # trained params gives the same output, bit for bit.
    assert all(t.dtype.is_floating_point and t.dtype.itemsize == 4
               for p in pnet.params_tree.values() for t in p.values())
    after = pnet.output(pool[0][0])[0]
    assert np.abs(after - before).max() > 1e-3
    trained = {v: {k: t.detach() for k, t in p.items()}
               for v, p in pnet.params_tree.items()}
    fresh = ComputationGraph(pnet.conf, device="cpu").init(params=trained)
    assert np.array_equal(fresh.output(pool[0][0])[0], after)


def test_fit_refuses_what_it_does_not_run():
    # Dropout trains now (one step, one key advanced); solvers and graph
    # truncated BPTT are still refused, and a refused fit takes no step.
    conf = zoo.transformer_lm(V, t=16, d_model=D, n_heads=H, n_blocks=1)
    conf.vertices["ff1_0"].layer.dropout = 0.5
    net = ComputationGraph(conf, device="cpu").init()
    x = np.zeros((1, 16, 1), np.float32)
    y = np.zeros((1, 16), np.int32)
    key = net._train_rng.copy()
    net.fit(x, y)
    assert net.iteration == 1 and np.isfinite(net.score_value)
    np.testing.assert_array_equal(net._train_rng, prng.split(key)[0])
    conf.vertices["ff1_0"].layer.dropout = 0.0
    conf.global_conf.optimization_algo = "lbfgs"
    with pytest.raises(NotImplementedError, match="solvers"):
        net.fit(x, y)
    conf.global_conf.optimization_algo = "stochastic_gradient_descent"
    conf.backprop_type = "truncatedbptt"
    with pytest.raises(NotImplementedError, match="truncated BPTT"):
        net.fit(x, y)
    assert net.iteration == 1


def test_port_zoo_trains_and_scores():
    conf = zoo.transformer_lm(V, t=32, d_model=D, n_heads=H, n_blocks=1)
    net = ComputationGraph(conf, device="cpu").init()
    rng = np.random.RandomState(1)
    ids = rng.randint(0, V, (2, 33))
    x, y = ids[:, :-1, None], ids[:, 1:].astype(np.int32)   # int64 ids
    first = net.score(x, y)
    for _ in range(5):
        net.fit([MultiDataSet([x], [y])])
    assert net.epoch == 5 and net.iteration == 5
    assert net.score(x, y) < first
    assert np.isfinite(net.score_value)
