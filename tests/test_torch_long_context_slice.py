"""The port's long-context slice as a whole against the JAX package, on the
CPU: `ComputationGraph.fit` and `output` of `transformer_lm` through the
streamed attention rows (4 and 7) in both packages.

The streamed rows take over where the K/V of one (batch, head) outgrow
`_RESIDENT_KV_LIMIT` (T > 24,576 at D = 64 in bf16); here both packages'
limits are patched to 0, so a small model takes the same path. A JAX
`transformer_lm(V=64, t=768, d_model=32, n_heads=4, n_blocks=2)` in f32 is
carried over with `to_json()` -> `from_json` and `params_from_numpy`. T =
768 is a multiple of the JAX package's 256-row block (at any other T it
goes dense) and no other test traces it, so the JAX step reads the patched
limit when it traces. Counting spies on `_flash_fwd_stream_bhtd` and
`_flash_bwd_stream_bhtd` show that the JAX side streamed; the port's
counts show its plain streamed versions ran and its resident rows did not.

Tolerances: f32 scores, params and Adam m/v rtol 2e-4, atol 2e-5, as the
training slice's tests (`tests/test_torch_train_slice.py`).
"""

import numpy as np
import pytest

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.kernels import flash_attention as jax_fa
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

V, T, D, H, NB, B = 64, 768, 32, 4, 2, 2
F32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package (see
    `tests/test_torch_rnn_slice.py`): an executable from the AOT store
    would neither read the patched limit nor call the spies, and a
    deserialised one refuses its arguments on the 8-device CPU mesh."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


@pytest.fixture
def streamed_everywhere(monkeypatch):
    """Both limits at 0, and counting spies on the JAX streamed passes
    (called when the JAX step traces them)."""
    monkeypatch.setattr(jax_fa, "_RESIDENT_KV_LIMIT", 0)
    monkeypatch.setattr(fa, "_RESIDENT_KV_LIMIT", 0)
    calls = {"fwd": 0, "bwd": 0}

    def spy(name, key):
        orig = getattr(jax_fa, name)

        def counted(*args, **kw):
            calls[key] += 1
            return orig(*args, **kw)

        monkeypatch.setattr(jax_fa, name, counted)

    spy("_flash_fwd_stream_bhtd", "fwd")
    spy("_flash_bwd_stream_bhtd", "bwd")
    return calls


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
    return {v: {k: np.array(a) for k, a in p.items()}
            for v, p in tree.items()}


def _assert_trees(port_tree, jax_tree, what):
    for v, p in jax_tree.items():
        for k, a in p.items():
            np.testing.assert_allclose(
                port_tree[v][k].detach().numpy(), a,
                err_msg=f"{what} {v}/{k}", **F32)


def test_long_context_fit_and_output_match_jax(streamed_everywhere):
    jconf = jax_zoo.transformer_lm(V, t=T, d_model=D, n_heads=H, n_blocks=NB)
    jnet = JaxGraph(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    pnet = ComputationGraph(conf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    pool = _pool()
    jax_scores, port_scores = [], []
    kernels.reset_counts()
    for step in range(3):
        x, y = pool[step % 2]
        jnet.fit(JaxMDS([x], [y]))
        pnet.fit(MultiDataSet([x], [y]))
        jax_scores.append(jnet.score_value)
        port_scores.append(pnet.score_value)
    fit_counts = kernels.counts()
    np.testing.assert_allclose(port_scores, jax_scores, **F32)
    assert abs(jax_scores[0] / (T * np.log(V)) - 1) < 0.1
    assert pnet.iteration == jnet.iteration == 3
    _assert_trees(pnet.params_tree, _np_tree(jnet.params_tree), "params")
    for f in ("m", "v"):
        _assert_trees({v: s[f] for v, s in pnet.opt_state.items()},
                      {v: _np_tree({"_": s[f]})["_"]
                       for v, s in jnet.opt_state.items()}, f)
    # The JAX step traced its streamed forward and backward.
    assert streamed_everywhere["fwd"] >= 1 and streamed_everywhere["bwd"] >= 1
    # The port: NB streamed attentions forward and backward per step, no
    # resident row, no launch (CPU).
    plain = fit_counts["plain_calls"]
    assert plain["flash_attention_stream"] == 3 * NB
    assert plain["flash_attention_bwd_dq_stream"] == 3 * NB
    assert plain["flash_attention_bwd_dkv_stream"] == 3 * NB
    for name in ("flash_attention", "flash_attention_fwd_lse",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert plain[name] == 0, name
    assert plain["layernorm_norm_act"] == 3 * (2 * NB + 1)
    assert not any(fit_counts["launches"].values())

    fwd_traces = streamed_everywhere["fwd"]
    x, _ = pool[1]
    kernels.reset_counts()
    got = pnet.output(x)[0]
    want = jnet.output(x)[0]
    np.testing.assert_allclose(got, want, **F32)
    assert streamed_everywhere["fwd"] > fwd_traces
    plain = kernels.counts()["plain_calls"]
    assert plain["flash_attention_stream"] == NB
    assert plain["flash_attention"] == 0
