"""Adapter checkpoints in the port (`checkpoint/adapters.py`) against the
JAX package, on the CPU: the base fingerprint is the reference's 32 hex
digits for f32, bf16 and int8 bases (and ignores adapter leaves); an
adapter that either package saves loads in the other bit for bit, with
the same meta; a base whose fingerprint differs is refused in both
directions; saving a net with no LoRA leaves is an error. Every check is
exact (no tolerance): the files and the hashes are bytes.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.checkpoint import adapters as jax_adapters
from deeplearning4j_tpu.checkpoint import quantize as jax_quantize
from deeplearning4j_tpu.checkpoint.array_store import (
    CheckpointError as JaxCheckpointError,
)
from deeplearning4j_tpu.nn import transfer as jax_transfer
from deeplearning4j_tpu.nn.conf import inputs as jax_inputs
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf import neural_net as jax_nn
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import checkpoint, interop
from deeplearning4j_tpu_torch.checkpoint import adapters, quantize, store
from deeplearning4j_tpu_torch.checkpoint.array_store import CheckpointError
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import lora
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.transfer import TransferLearning


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


def _jax_mlp(seed=7, policy=None):
    b = (jax_nn.NeuralNetConfiguration.builder().seed(seed)
         .learning_rate(0.1).updater("adam"))
    if policy is not None:
        b = b.dtype_policy(policy)
    conf = (b.list()
            .layer(jax_layers.DenseLayer(n_out=8, activation="tanh"))
            .layer(jax_layers.OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"))
            .set_input_type(jax_inputs.InputType.feed_forward(4)).build())
    return JaxMLN(conf).init()


def _np_tree(tree):
    return {k: {n: np.array(a) for n, a in p.items()}
            for k, p in tree.items() if isinstance(p, dict)}


def _port_of(jnet):
    return MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))


def _trained(net, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)]
    net.fit(DataSet(x, y))
    return net


@pytest.mark.parametrize("base", ["float32", "bfloat16", "int8"])
def test_fingerprint_equals_the_reference(base):
    jnet = _jax_mlp(policy="bfloat16" if base == "bfloat16" else None)
    pnet = _port_of(jnet)
    if base == "bfloat16":
        assert pnet.params_tree["layer_0"]["W"].dtype == torch.bfloat16
    if base == "int8":
        jax_quantize.quantize_net(jnet)
        quantize.quantize_net(pnet)
        assert pnet.params_tree["layer_0"]["W"].dtype == torch.int8
    fp = adapters.base_fingerprint(pnet)
    assert len(fp) == 32 and fp == jax_adapters.base_fingerprint(jnet)
    assert fp == adapters.base_fingerprint(pnet.params_tree)
    # Adapter leaves are not the base's: the tuned net fingerprints as its
    # base, in both packages.
    jtuned = jax_transfer.TransferLearning(jnet).add_lora(rank=2).build()
    ptuned = TransferLearning(pnet).add_lora(rank=2).build()
    assert adapters.base_fingerprint(ptuned) == fp
    assert jax_adapters.base_fingerprint(jtuned) == fp
    assert adapters.base_fingerprint(_port_of(_jax_mlp(seed=8))) != fp


def test_reference_adapter_loads_in_the_port(tmp_path):
    jbase = _jax_mlp()
    jtuned = jax_transfer.TransferLearning(jbase).add_lora(
        rank=2, alpha=8).build()
    path = str(tmp_path / "tenant")
    jax_adapters.save_adapter(jtuned, path, name="tenant-a")
    pbase = _port_of(jbase)
    assert adapters.is_adapter_checkpoint(path)
    assert not adapters.is_adapter_checkpoint(str(tmp_path / "nope"))
    assert adapters.adapter_meta(path) == jax_adapters.adapter_meta(path)
    got = adapters.load_adapter(path, base_net=pbase)
    want = jax_transfer.lora_mod.extract_adapter(jtuned.params_tree)
    assert {k: sorted(v) for k, v in got.items()} == {
        k: sorted(v) for k, v in want.items()}
    for lk, leaves in want.items():
        for k, a in leaves.items():
            t = got[lk][k]
            assert t.device.type == "cpu" and str(t.dtype) == (
                "torch." + str(np.asarray(a).dtype))
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_port_adapter_loads_in_the_reference(tmp_path):
    jbase = _jax_mlp()
    pbase = _port_of(jbase)
    ptuned = _trained(TransferLearning(pbase).add_lora(rank=3,
                                                       alpha=6).build())
    path = str(tmp_path / "tenant")
    assert checkpoint.save_adapter(ptuned, path, name="t") == path
    meta = jax_adapters.adapter_meta(path)
    assert (meta["name"], meta["rank"], meta["alpha"], meta["engine"]) == (
        "t", 3, 6.0, "MultiLayerNetwork")
    assert meta["base_fingerprint"] == jax_adapters.base_fingerprint(jbase)
    got = jax_adapters.load_adapter(path, base_net=jbase)
    want = lora.extract_adapter(ptuned.params_tree)
    for lk, leaves in want.items():
        assert sorted(got[lk]) == sorted(leaves)
        for k, t in leaves.items():
            np.testing.assert_array_equal(np.asarray(got[lk][k]),
                                          t.detach().numpy())
    # And back into the port: the same bits, merged onto the base, give
    # the tuned net's function.
    back = adapters.load_adapter(path, base_net=pbase)
    merged = lora.merge_adapter(pbase.params_tree, back)
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    np.testing.assert_array_equal(pbase.output(x, params=merged),
                                  ptuned.output(x))


def test_mismatched_base_is_refused_both_ways(tmp_path):
    jbase, other = _jax_mlp(seed=1), _jax_mlp(seed=2)
    jpath, ppath = str(tmp_path / "j"), str(tmp_path / "p")
    jax_adapters.save_adapter(
        jax_transfer.TransferLearning(jbase).add_lora(rank=2).build(), jpath)
    adapters.save_adapter(
        TransferLearning(_port_of(jbase)).add_lora(rank=2).build(), ppath)
    for path in (jpath, ppath):
        with pytest.raises(CheckpointError, match="refusing"):
            adapters.load_adapter(path, base_net=_port_of(other))
        with pytest.raises(JaxCheckpointError, match="refusing"):
            jax_adapters.load_adapter(path, base_net=other)
        assert adapters.load_adapter(path)  # no base to check against


def test_saving_without_lora_leaves_is_an_error(tmp_path):
    with pytest.raises(CheckpointError, match="LoRA"):
        adapters.save_adapter(_port_of(_jax_mlp()), str(tmp_path / "x"))
    # A model checkpoint is no adapter.
    store.save_checkpoint(_port_of(_jax_mlp()), str(tmp_path / "m"))
    assert not adapters.is_adapter_checkpoint(str(tmp_path / "m"))
    with pytest.raises(CheckpointError, match="not a LoRA adapter"):
        adapters.adapter_meta(str(tmp_path / "m"))
