"""Persistence and recovery of the port against the JAX package, on the
CPU: the sharded checkpoint store (`checkpoint/`), the zip checkpoints and
their listener (`util/checkpoint.py`), rollback on divergence
(`util/failure.py`) and the listeners of `ComputationGraph.fit`.

- Checkpoints written by either package restore in the other, for both
  engines: params, updater state, layer state, iteration and epoch equal;
  for the same net state the index (keys, shapes, dtypes, chunk files),
  the meta (less the RNG key, which the reference splits at every step and
  the port never advances) and the f32 chunk bytes are the reference's.
- The port's resume equals its uninterrupted run bit for bit, through the
  zip listener, the sharded listener and the manager; a reference run and
  a port run continued from one checkpoint agree at rtol 2e-4 after 3
  steps (the training tolerance of the other slices).
- The store's refusals (corruption, dtype and policy guards, a mesh: A.13,
  a quantized checkpoint: A.7) and the failure listener's rollback are
  held to the port itself; the golden fixtures load as the reference
  recorded them.

Small sizes: the LM at V=64, T=32, d=32, 2 blocks; a ResNet graph of one
stem, one projecting and one identity block at 2 filters (BatchNorm
layers, running statistics) on 16x16 images; an MLP 4-12-3 on
`MultiLayerNetwork`. B=4 (the MLP 16), Adam or Nesterovs.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.checkpoint import quantize as jax_quantize
from deeplearning4j_tpu.checkpoint import store as jax_store
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize.listeners import (
    IterationListener as JaxListener,
)
from deeplearning4j_tpu.parallel import mesh as jax_mesh
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu.util import checkpoint as jax_ckpt
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    CheckpointError,
    CheckpointManager,
    is_sharded_checkpoint,
    load_any,
    migrate_zip,
    restore_checkpoint,
)
from deeplearning4j_tpu_torch.checkpoint import array_store, store
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models import resnet, zoo
from deeplearning4j_tpu_torch.nn import engine
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.util import checkpoint as ckpt
from deeplearning4j_tpu_torch.util import model_serializer, retry
from deeplearning4j_tpu_torch.util.failure import (
    FailureDetectionListener,
    TrainingDivergedError,
    _checkpoint_healthy,
    restore_in_place,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
F32 = dict(rtol=2e-4, atol=1e-6)
KINDS = ["lm", "resnet", "mlp"]
V, T, IMAGE, CLASSES = 64, 32, 16, 5


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


# ------------------------------------------------------------- the nets

def _small_resnet(builder, helpers, L, input_type):
    b = (builder().seed(7).learning_rate(0.05).updater("nesterovs")
         .momentum(0.9).weight_init("relu").l2(1e-4)
         .graph_builder().add_inputs("input"))
    x = helpers._conv_bn(b, "stem", "input", 8, (3, 3), (2, 2))
    x = helpers._bottleneck(b, "s0_b0", x, 2, (2, 2), project=True)
    x = helpers._bottleneck(b, "s0_b1", x, 2, (1, 1), project=False)
    b.add_layer("avgpool", L.GlobalPoolingLayer(pooling_type="avg"), x)
    b.add_layer("fc", L.OutputLayer(n_out=CLASSES, activation="softmax",
                                    loss_function="mcxent"), "avgpool")
    return (b.set_outputs("fc")
            .set_input_types(input_type.convolutional(IMAGE, IMAGE, 3))
            .build())


def _mlp(builder, L, input_type, width=12, dtype="float32"):
    return (builder().seed(3).learning_rate(0.1).updater("adam")
            .dtype(dtype).list()
            .layer(L.DenseLayer(n_out=width, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(input_type.feed_forward(4))
            .build())


def _confs(kind):
    """(port conf, reference conf)."""
    if kind == "lm":
        kw = dict(t=T, d_model=32, n_heads=4, n_blocks=2)
        return zoo.transformer_lm(V, **kw), jax_zoo.transformer_lm(V, **kw)
    if kind == "resnet":
        return (_small_resnet(NeuralNetConfiguration.builder, resnet, layers,
                              InputType),
                _small_resnet(JaxNNC.builder, jax_resnet, jax_layers,
                              JaxInputType))
    return (_mlp(NeuralNetConfiguration.builder, layers, InputType),
            _mlp(JaxNNC.builder, jax_layers, JaxInputType))


def _batch(kind, step):
    """One batch as (features list, labels list), seeded by the step."""
    rng = np.random.RandomState(500 + step)
    if kind == "lm":
        ids = rng.randint(0, V, (4, T + 1))
        return ([ids[:, :-1, None].astype(np.float32)],
                [np.eye(V, dtype=np.float32)[ids[:, 1:]]])
    if kind == "resnet":
        return ([rng.randn(4, IMAGE, IMAGE, 3).astype(np.float32)],
                [np.eye(CLASSES, dtype=np.float32)[
                    rng.randint(0, CLASSES, 4)]])
    return ([rng.randn(16, 4).astype(np.float32)],
            [np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]])


def _fit(net, kind, step):
    xs, ys = _batch(kind, step)
    if isinstance(net, (MultiLayerNetwork, JaxMLN)):
        net.fit(xs[0], ys[0])
    elif isinstance(net, ComputationGraph):
        net.fit(MultiDataSet(features=xs, labels=ys))
    else:
        net.fit(JaxMDS(features=xs, labels=ys))


def _np_tree(tree):
    return {k: {n: np.array(a) for n, a in p.items()}
            for k, p in tree.items() if isinstance(p, dict)}


def _ref_net(kind):
    _, jconf = _confs(kind)
    return (JaxMLN if kind == "mlp" else JaxGraph)(jconf).init()


def _port_net(kind, jnet=None):
    """The port's net on the CPU, from the reference net's params (and
    running statistics) when one is given, else from its own seed."""
    pconf, _ = _confs(kind)
    cls = MultiLayerNetwork if kind == "mlp" else ComputationGraph
    if jnet is None:
        return cls(pconf, device="cpu").init()
    return cls(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
        state=interop.state_from_numpy(_np_tree(jnet.state)))


def _arr(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor)
                      else a)


def _assert_same_state(got, want, exact=True, epoch_lag=0):
    check = (np.testing.assert_array_equal if exact else
             lambda a, b: np.testing.assert_allclose(a, b, **F32))
    check(_arr(got.params()), _arr(want.params()))
    check(_arr(got.updater_state_flat()), _arr(want.updater_state_flat()))
    assert set(got.state or {}) == set(want.state or {})
    for lk, sub in (want.state or {}).items():
        assert set(got.state[lk]) == set(sub)
        for k, v in sub.items():
            check(_arr(got.state[lk][k]), _arr(v))
    assert (got.iteration, got.epoch) == (want.iteration,
                                          want.epoch - epoch_lag)


def _ref_trained(kind, steps=2):
    jnet = _ref_net(kind)
    for s in range(steps):
        _fit(jnet, kind, s)
    return jnet


# ------------------------------------------------ cross-package restores

@pytest.mark.parametrize("kind", KINDS)
def test_port_sharded_checkpoint_restores_in_the_reference(tmp_path, kind):
    pnet = _port_net(kind, _ref_net(kind))
    for s in range(2):
        _fit(pnet, kind, s)
    path = store.save_checkpoint(pnet, str(tmp_path / "step_00000002"))
    back = jax_store.restore_checkpoint(path)
    assert type(back).__name__ == type(pnet).__name__
    _assert_same_state(back, pnet)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_sharded_checkpoint_restores_in_the_port(tmp_path, kind):
    jnet = _ref_trained(kind)
    path = jax_store.save_checkpoint(jnet, str(tmp_path / "step_00000002"))
    back = restore_checkpoint(path, device="cpu")
    assert type(back).__name__ == type(jnet).__name__
    _assert_same_state(back, jnet)
    np.testing.assert_array_equal(back._train_rng,
                                  store.read_meta(path)["rng"])
    # Into a net the caller built, in place: the same tensor objects.
    into = _port_net(kind)
    leaves = [t for p in into.params_tree.values() for t in p.values()]
    assert restore_checkpoint(path, net=into) is into
    assert [t for p in into.params_tree.values()
            for t in p.values()] == leaves
    _assert_same_state(into, jnet)


@pytest.mark.parametrize("kind", KINDS)
def test_index_meta_and_chunks_are_the_references(tmp_path, kind):
    jnet = _ref_trained(kind)
    ref = jax_store.save_checkpoint(jnet, str(tmp_path / "ref" / "step_2"))
    pnet = restore_checkpoint(ref, device="cpu")
    port = store.save_checkpoint(pnet, str(tmp_path / "port" / "step_2"))
    ri, pi = store.read_index(ref), store.read_index(port)
    assert list(pi["leaves"]) == list(ri["leaves"])
    assert {k: e["shape"] for k, e in pi["leaves"].items()} == \
        {k: e["shape"] for k, e in ri["leaves"].items()}
    assert {k: e["dtype"] for k, e in pi["leaves"].items()} == \
        {k: e["dtype"] for k, e in ri["leaves"].items()}
    assert pi == ri  # file names and chunk regions too
    n_f32 = 0
    for entry in ri["leaves"].values():
        if entry["dtype"] != "float32":
            continue
        for chunk in entry["chunks"]:
            with open(os.path.join(ref, chunk["file"]), "rb") as a, \
                    open(os.path.join(port, chunk["file"]), "rb") as b:
                assert a.read() == b.read(), chunk["file"]
            n_f32 += 1
    assert n_f32 > 0
    rm, pm = store.read_meta(ref), store.read_meta(port)
    assert json.loads(pm.pop("conf_json")) == json.loads(rm.pop("conf_json"))
    pm.pop("rng"), rm.pop("rng")
    assert pm == rm
    with open(os.path.join(port, store.COMMIT)) as f:
        commit = json.load(f)
    assert commit["format"] == store.FORMAT and commit["step"] == 2


def test_lm_meta_names_the_mixed_bfloat16_policy(tmp_path):
    kw = dict(t=T, d_model=32, n_heads=4, n_blocks=2, dtype="bfloat16")
    jnet = JaxGraph(jax_zoo.transformer_lm(V, **kw)).init()
    pnet = ComputationGraph(zoo.transformer_lm(V, **kw), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    ref = jax_store.save_checkpoint(jnet, str(tmp_path / "ref"))
    port = store.save_checkpoint(pnet, str(tmp_path / "port"))
    assert store.read_meta(port)["dtype_policy"] == \
        store.read_meta(ref)["dtype_policy"] == {"name": "mixed_bfloat16"}
    _assert_same_state(restore_checkpoint(ref, device="cpu"), jnet)


def test_reference_mesh_checkpoint_restores_in_the_port(tmp_path):
    """Saved from a (4, 2) CPU mesh with the dense W split on the model
    axis: two chunks for that leaf, assembled whole by the port."""
    mesh42 = jax_mesh.create_mesh((4, 2), ("data", "model"))
    jconf = _mlp(JaxNNC.builder, jax_layers, JaxInputType, width=512)
    jnet = JaxMLN(jconf).init()
    w = ParallelWrapper(jnet, mesh=mesh42, model_axis="model")
    for s in range(3):
        w.fit(JaxDataSet(*(a[0] for a in _batch("mlp", s))))
    assert jnet.params_tree["layer_0"]["W"].sharding.spec[-1] == "model"
    path = w.save_checkpoint(str(tmp_path / "c"))
    entry = store.read_index(path)["leaves"]["params/layer_0/W"]
    assert len(entry["chunks"]) == 2
    back = restore_checkpoint(path, device="cpu")
    _assert_same_state(back, jnet)
    region = array_store.read_region(path, entry, (slice(1, 3),
                                                   slice(200, 300)))
    np.testing.assert_array_equal(
        region, np.asarray(jnet.params_tree["layer_0"]["W"])[1:3, 200:300])


def test_array_store_reads_a_sharded_leaf_by_region(tmp_path):
    mesh = jax_mesh.create_mesh((4, 2), ("data", "model"))
    x = jax.device_put(np.arange(8 * 64, dtype=np.float32).reshape(8, 64),
                       NamedSharding(mesh, P(None, "model")))
    from deeplearning4j_tpu.checkpoint import array_store as jax_as

    os.makedirs(tmp_path / array_store.CHUNK_DIR)
    entry = jax_as.write_leaf(str(tmp_path), 0, "params/l/W",
                              list(jax_as.leaf_chunks(x)), x.shape,
                              str(x.dtype), {})
    assert len(entry["chunks"]) == 2
    np.testing.assert_array_equal(array_store.read_full(str(tmp_path), entry),
                                  np.asarray(x))
    entry["chunks"] = entry["chunks"][:1]
    with pytest.raises(CheckpointCorruptError, match="cover only"):
        array_store.read_full(str(tmp_path), entry)


# ------------------------------------------------------- zip checkpoints

@pytest.mark.parametrize("kind", KINDS)
def test_port_zip_checkpoint_loads_in_the_reference(tmp_path, kind):
    pnet = _port_net(kind, _ref_net(kind))
    for s in range(2):
        _fit(pnet, kind, s)
    sync = ckpt.save_checkpoint(pnet, str(tmp_path / "sync.zip"))
    lst = ckpt.CheckpointListener(str(tmp_path / "l"), frequency=1)
    lst.iteration_done(pnet, pnet.iteration)
    for path in (sync, lst.last_checkpoint()):
        back = jax_ckpt.load_checkpoint(path)
        _assert_same_state(back, pnet)
        np.testing.assert_array_equal(np.asarray(back._train_rng),
                                      pnet._train_rng)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_zip_checkpoint_loads_in_the_port(tmp_path, kind):
    jnet = _ref_trained(kind)
    path = str(tmp_path / "c.zip")
    jax_ckpt.save_checkpoint(jnet, path)
    back = ckpt.load_checkpoint(path, device="cpu")
    _assert_same_state(back, jnet)
    rng = np.asarray(jnet._clock[1] if jnet._clock is not None
                     else jnet._train_rng)
    np.testing.assert_array_equal(back._train_rng, rng)


def test_migrate_zip_and_load_any(tmp_path):
    pnet = _port_net("resnet", _ref_net("resnet"))
    for s in range(2):
        _fit(pnet, "resnet", s)
    zpath = ckpt.save_checkpoint(pnet, str(tmp_path / "c.zip"))
    step = migrate_zip(zpath, str(tmp_path / "store"), device="cpu")
    assert os.path.basename(step) == "step_00000002"
    assert is_sharded_checkpoint(step)
    for path in (zpath, step, str(tmp_path / "store")):
        _assert_same_state(load_any(path, device="cpu"), pnet)
    # The reference reads the migrated step as its own.
    _assert_same_state(jax_store.restore_checkpoint(step), pnet)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(CheckpointError, match="no committed"):
        load_any(str(tmp_path / "empty"), device="cpu")
    (tmp_path / "junk.bin").write_bytes(b"not a zip")
    with pytest.raises(CheckpointError, match="neither"):
        load_any(str(tmp_path / "junk.bin"), device="cpu")


# ---------------------------------------------------------- exact resume

RESUME_MODES = ["zip_listener", "sharded_listener", "manager"]


@pytest.mark.parametrize("mode", RESUME_MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_port_resume_equals_its_uninterrupted_run(tmp_path, kind, mode):
    a = _port_net(kind)
    mgr = lst = None
    if mode == "manager":
        mgr = CheckpointManager(str(tmp_path), keep_last=3, save_every=3,
                                device="cpu")
    else:
        lst = ckpt.CheckpointListener(
            str(tmp_path), frequency=3, keep_last=2,
            format="zip" if mode == "zip_listener" else "sharded")
        a.set_listeners(lst)
    for s in range(6):
        _fit(a, kind, s)
        if mgr is not None:
            mgr.maybe_save(a)
    if mgr is not None:
        mgr.flush()
        assert mgr.latest() == 6 and mgr.all_steps() == [3, 6]
        b = mgr.restore(step=3)
    else:
        assert len(lst.last_checkpoint() and lst.saved_paths) == 2
        b = ckpt.load_checkpoint(lst.saved_paths[0], device="cpu")
    assert b.iteration == 3
    for s in range(3, 6):
        _fit(b, kind, s)
    # A listener saves inside the epoch (at the iteration's end), before
    # `fit` counts the epoch: its checkpoint's epoch is one behind.
    _assert_same_state(b, a, epoch_lag=0 if mgr is not None else 1)
    assert b.score_value == a.score_value


@pytest.mark.parametrize("kind", KINDS)
def test_reference_and_port_continue_from_one_checkpoint(tmp_path, kind):
    jnet = _ref_trained(kind)
    path = jax_store.save_checkpoint(jnet, str(tmp_path / "step_00000002"))
    pnet = restore_checkpoint(path, device="cpu")
    for s in range(2, 5):
        _fit(jnet, kind, s)
        _fit(pnet, kind, s)
        np.testing.assert_allclose(pnet.score_value,
                                   float(jnet.score_value), rtol=2e-4)
    _assert_same_state(pnet, jnet, exact=False)


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_is_not_changed_by_the_next_step(kind):
    net = _port_net(kind)
    _fit(net, kind, 0)
    snap = store.snapshot_net(net)
    zsnap = model_serializer.host_snapshot(net)
    before = {leaf["key"]: leaf["chunks"][0][1].copy()
              for leaf in snap["leaves"]}
    zbefore = [a.copy() for a in zsnap["params"] + zsnap["updater"]]
    live = dict(store._flat_items(net.params_tree, "params"))
    _fit(net, kind, 1)
    for leaf in snap["leaves"]:
        np.testing.assert_array_equal(leaf["chunks"][0][1],
                                      before[leaf["key"]])
    for got, want in zip(zsnap["params"] + zsnap["updater"], zbefore):
        np.testing.assert_array_equal(got, want)
    moved = [k for k, t in live.items()
             if not np.array_equal(t.detach().numpy(), before[k])]
    assert moved  # the step did change the live params
    chunks = {leaf["key"]: leaf["chunks"][0][1] for leaf in snap["leaves"]}
    for k, t in live.items():
        assert not np.shares_memory(t.detach().numpy(), chunks[k])


def test_zip_widens_a_bf16_host_copy_by_value():
    t = torch.tensor([1.5, -2.25, 3.0e-3, 6.5e4]).to(torch.bfloat16)
    host, = array_store.host_copies([t])
    assert host.dtype == np.dtype("<u2")  # the raw bits
    got = model_serializer._flat64([host, np.float32([7.0])])
    np.testing.assert_array_equal(
        got, np.append(t.float().numpy(), 7.0).astype(np.float64))


# --------------------------------------------- corruption and retention

def _committed(tmp_path, steps=(5, 10)):
    net = _port_net("mlp")
    _fit(net, "mlp", 0)
    mgr = CheckpointManager(str(tmp_path), keep_last=0, async_save=False,
                            device="cpu")
    for s in steps:
        mgr.save(net, step=s)
    return net, mgr


def test_truncated_chunk_clean_error_and_fallback(tmp_path):
    net, mgr = _committed(tmp_path)
    step10 = mgr.step_path(10)
    chunk = os.path.join(step10, store.read_index(step10)["leaves"][
        "params/layer_0/W"]["chunks"][0]["file"])
    with open(chunk, "r+b") as f:
        f.truncate(8)
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        store.verify_checkpoint(step10)
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(step=10)
    assert mgr.all_steps() == [5] and mgr.latest() == 5
    with pytest.warns(RuntimeWarning, match="step 10 failed corruption"):
        back = mgr.restore()
    assert back.iteration == net.iteration
    assert mgr.stats["restore_fallback"] == 1
    np.testing.assert_array_equal(back.params(), net.params())


def test_missing_commit_and_tmp_ignored(tmp_path):
    _, mgr = _committed(tmp_path)
    os.remove(os.path.join(mgr.step_path(10), store.COMMIT))
    with pytest.raises(CheckpointCorruptError, match="no COMMIT"):
        store.verify_checkpoint(mgr.step_path(10))
    assert not is_sharded_checkpoint(mgr.step_path(10))
    shutil.copytree(mgr.step_path(5), mgr.step_path(20) + ".tmp")
    assert mgr.all_steps() == [5]
    assert mgr.candidate_steps() == [10, 5]
    with pytest.warns(RuntimeWarning):
        assert mgr.restore().iteration == 1


def test_empty_store_raises_clean(tmp_path):
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    assert mgr.latest() is None and mgr.latest_path() is None
    with pytest.raises(CheckpointError, match="no committed"):
        mgr.restore()
    with pytest.raises(CheckpointError, match="no checkpoint directory"):
        store.verify_checkpoint(str(tmp_path / "nothing"))


def test_keep_last_plus_keep_every(tmp_path):
    net = _port_net("mlp")
    mgr = CheckpointManager(str(tmp_path), keep_last=2, keep_every=4,
                            async_save=False, device="cpu")
    for s in range(1, 10):
        mgr.save(net, step=s)
    assert mgr.all_steps() == [4, 8, 9]
    assert mgr.stats["dl4j_checkpoint_saves_total"] == 9
    assert mgr.stats["dl4j_checkpoint_bytes_written_total"] == 9 * sum(
        t.numel() * 4 for _, t in store._flat_items(
            {"p": net.params_tree, "u": net.opt_state}, "x"))


def test_background_write_error_raised_at_flush(tmp_path, monkeypatch):
    net = _port_net("mlp")
    mgr = CheckpointManager(str(tmp_path), device="cpu")

    def broken(snap, path):
        raise ValueError("disk on fire")

    monkeypatch.setattr(store, "write_snapshot", broken)
    mgr.save(net, step=1)
    with pytest.raises(ValueError, match="disk on fire"):
        mgr.flush()
    mgr.flush()  # raised once
    assert mgr.all_steps() == []
    assert mgr.stats["dl4j_checkpoint_queue_depth"] == 0


@pytest.mark.parametrize("fmt", ["zip", "sharded"])
def test_listener_write_error_raised_at_flush(tmp_path, monkeypatch, fmt):
    net = _port_net("mlp")
    lst = ckpt.CheckpointListener(str(tmp_path), frequency=1, format=fmt)
    lst.iteration_done(net, 1)
    assert lst.last_checkpoint() is not None

    def broken(*args):
        raise ValueError("disk on fire")

    monkeypatch.setattr(store, "write_snapshot", broken)
    monkeypatch.setattr(ckpt, "_write_zip", broken)
    lst.iteration_done(net, 2)
    with pytest.raises(ValueError, match="disk on fire"):
        lst.last_checkpoint()
    # Raised once; the failed write never joins `saved_paths`.
    assert len(lst.saved_paths) == 1
    assert lst.last_checkpoint() == lst.saved_paths[0]


def test_write_retried_after_a_transient_os_error(tmp_path, monkeypatch):
    net = _port_net("mlp")
    mgr = CheckpointManager(str(tmp_path), async_save=False, device="cpu")
    real, calls = store.write_snapshot, []

    def flaky(snap, path):
        calls.append(path)
        if len(calls) == 1:
            raise OSError("transient")
        return real(snap, path)

    monkeypatch.setattr(retry, "BASE_S", 0.001)
    monkeypatch.setattr(store, "write_snapshot", flaky)
    mgr.save(net, step=2)
    assert len(calls) == 2 and mgr.all_steps() == [2]


# ------------------------------------------------ dtype, policy, refusals

def test_float64_checkpoint_restores_onto_float32_net(tmp_path):
    pconf, _ = _confs("mlp")
    wide = MultiLayerNetwork(_mlp(NeuralNetConfiguration.builder, layers,
                                  InputType, dtype="float64"),
                             device="cpu").init()
    path = store.save_checkpoint(wide, str(tmp_path / "c"))
    assert store.read_index(path)["leaves"]["params/layer_0/W"]["dtype"] \
        == "float64"
    assert store.read_meta(path)["dtype_policy"] == {"name": "float64"}
    narrow = MultiLayerNetwork(pconf, device="cpu").init()
    with pytest.raises(CheckpointError, match="dtype policy 'float64'"):
        restore_checkpoint(path, net=narrow)
    back = restore_checkpoint(path, device="cpu")  # its own policy
    assert back.params_tree["layer_0"]["W"].dtype == torch.float64
    np.testing.assert_array_equal(back.params(), wide.params())


def test_leaf_dtype_guard(tmp_path):
    net = _port_net("mlp")
    path = store.save_checkpoint(net, str(tmp_path / "c"))
    index = store.read_index(path)
    store._check_leaf_dtype("k", {"dtype": "float64"}, "float32")
    for saved in ("bfloat16", "int8"):
        with pytest.raises(CheckpointError, match=f"stores {saved}"):
            store._check_leaf_dtype("k", {"dtype": saved}, "float32")
    entry = index["leaves"]["params/layer_0/W"]
    entry["shape"] = [5, 12]
    with pytest.raises(CheckpointError, match="shape mismatch"):
        store._read_leaf(path, index, "params/layer_0/W", (4, 12), "float32")
    with pytest.raises(CheckpointError, match="no leaf"):
        store._read_leaf(path, index, "params/nope/W", (4, 12), "float32")


def test_bf16_param_policy_is_refused(tmp_path):
    b = (JaxNNC.builder().seed(3).learning_rate(0.1).updater("adam")
         .dtype_policy("bfloat16").list()
         .layer(jax_layers.DenseLayer(n_out=12, activation="tanh"))
         .layer(jax_layers.OutputLayer(n_out=3, activation="softmax",
                                       loss_function="mcxent"))
         .set_input_type(JaxInputType.feed_forward(4)).build())
    jnet = JaxMLN(b).init()
    path = jax_store.save_checkpoint(jnet, str(tmp_path / "c"))
    entry = store.read_index(path)["leaves"]["params/layer_0/W"]
    assert entry["dtype"] == "bfloat16"
    got = array_store.to_tensor(array_store.read_full(path, entry),
                                "bfloat16")
    want = np.asarray(jnet.params_tree["layer_0"]["W"]).astype(np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    with pytest.raises(CheckpointError, match="dtype policy 'bfloat16'"):
        restore_checkpoint(path, net=_port_net("mlp"))
    with pytest.raises(NotImplementedError, match="A.7"):
        restore_checkpoint(path, device="cpu")


def test_mesh_context_and_quantized_refusals(tmp_path):
    jnet = _ref_trained("mlp", steps=1)
    path = jax_store.save_checkpoint(jnet, str(tmp_path / "c"))
    for kw in (dict(mesh=object()), dict(context=object())):
        with pytest.raises(NotImplementedError, match="A.13"):
            restore_checkpoint(path, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="A.13"):
            CheckpointManager(str(tmp_path / "m"), **kw)
    with pytest.raises(TypeError, match="model_axis"):
        restore_checkpoint(path, device="cpu", model_axis="model")
    with pytest.raises(TypeError, match="model_axis"):
        CheckpointManager(str(tmp_path / "m"), model_axis="model")
    with pytest.raises(NotImplementedError, match="A.13"):
        ckpt.load_checkpoint(str(tmp_path / "x.zip"), mesh=object())
    q = jax_quantize.quantize_checkpoint(path, str(tmp_path / "q"))
    with pytest.raises(NotImplementedError, match="A.7"):
        restore_checkpoint(q, device="cpu")


# ------------------------------------------------------- failure recovery

def _poison(net):
    lk = net._param_layer_order()[0]
    with torch.no_grad():
        next(iter(net.params_tree[lk].values())).mul_(float("nan"))


@pytest.mark.parametrize("fmt", ["zip", "sharded"])
def test_detects_and_rolls_back(tmp_path, fmt):
    net = _port_net("mlp")
    ckpts = ckpt.CheckpointListener(str(tmp_path / "c"), frequency=2,
                                    keep_last=3, format=fmt)
    watchdog = FailureDetectionListener(ckpts, check_frequency=1)
    net.set_listeners(ckpts, watchdog)
    for s in range(6):
        _fit(net, "mlp", s)
    good_iter = net.iteration
    assert good_iter == 6
    tables = dict(net._update_tables)
    leaves = [t for p in net.params_tree.values() for t in p.values()]
    _poison(net)
    # Detection lags one check: the watchdog reads the previous score.
    _fit(net, "mlp", 98)
    _fit(net, "mlp", 99)
    assert watchdog.recoveries == 1
    assert net.iteration <= good_iter
    assert np.all(np.isfinite(net.params()))
    # Restored in place: the same tensors; the next step moves them.
    assert [t for p in net.params_tree.values() for t in p.values()] == \
        leaves
    assert set(net._update_tables) == set(tables)
    restored = net.params().copy()
    _fit(net, "mlp", 6)
    assert not np.array_equal(net.params(), restored)
    for s in range(7, 10):
        _fit(net, "mlp", s)
    assert np.isfinite(net.score_value)
    assert watchdog.recovery_log[0]["restored_iteration"] <= good_iter


def test_rollback_then_replay_equals_the_clean_run(tmp_path):
    clean = _port_net("lm")
    for s in range(6):
        _fit(clean, "lm", s)
    net = _port_net("lm")
    ckpts = ckpt.CheckpointListener(str(tmp_path), frequency=2,
                                    format="sharded")
    watchdog = FailureDetectionListener(ckpts, check_frequency=1)
    net.set_listeners(ckpts, watchdog)
    for s in range(4):
        _fit(net, "lm", s)
    _poison(net)
    _fit(net, "lm", 4)
    _fit(net, "lm", 5)
    assert watchdog.recoveries == 1 and net.iteration == 4
    for s in range(4, 6):
        _fit(net, "lm", s)
    # The fit that rolled back still counts its epoch at its end.
    _assert_same_state(net, clean)


def test_skips_poisoned_checkpoint(tmp_path):
    net = _port_net("mlp")
    ckpts = ckpt.CheckpointListener(str(tmp_path / "c"), frequency=2,
                                    keep_last=4)
    net.set_listeners(ckpts)
    for s in range(4):
        _fit(net, "mlp", s)
    ckpts.flush()
    healthy = list(ckpts.saved_paths)
    _poison(net)
    _fit(net, "mlp", 98)
    _fit(net, "mlp", 99)
    ckpts.flush()
    assert len(ckpts.saved_paths) > len(healthy)
    bad = [p for p in ckpts.saved_paths if p not in healthy]
    assert any(not _checkpoint_healthy(p) for p in bad)
    watchdog = FailureDetectionListener(ckpts, check_frequency=1)
    watchdog._recover(net, net.iteration, float("nan"))
    assert watchdog.recovery_log[0]["restored_from"] in healthy
    assert watchdog.recovery_log[0]["dropped_checkpoints"] == bad
    assert np.all(np.isfinite(net.params()))


def test_gives_up_after_max_recoveries(tmp_path):
    net = _port_net("mlp")
    ckpts = ckpt.CheckpointListener(str(tmp_path / "c"), frequency=1)
    watchdog = FailureDetectionListener(ckpts, check_frequency=1,
                                        max_recoveries=0)
    net.set_listeners(ckpts, watchdog)
    _fit(net, "mlp", 0)
    _poison(net)
    with pytest.raises(TrainingDivergedError):
        _fit(net, "mlp", 1)
        _fit(net, "mlp", 2)


def test_sharded_health_check_and_in_place_restore(tmp_path):
    net = _port_net("resnet")
    _fit(net, "resnet", 0)
    mgr = CheckpointManager(str(tmp_path), async_save=False, device="cpu")
    good = mgr.save(net, step=1)
    assert _checkpoint_healthy(good)
    want = net.clone()
    net.set_params(np.full(net.num_params(), np.nan))
    bad = mgr.save(net, step=2)
    assert not _checkpoint_healthy(bad)
    restore_in_place(net, good)
    _assert_same_state(net, want)
    assert np.isnan(net.score_value)


# -------------------------------------------------------------- fixtures

def _golden_expect():
    with open(os.path.join(FIXTURES, "golden_expect_v1.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["golden_model_v1.zip",
                                  "golden_checkpoint_v1.zip"])
def test_golden_fixtures_load(name):
    exp = _golden_expect()
    net = load_any(os.path.join(FIXTURES, name), device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    assert net.iteration == exp["iteration"] == 5
    assert net.params().size == exp["params_sha_len"]
    np.testing.assert_allclose(net.params()[:16], exp["params_first16"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(net.updater_state_flat()[:16],
                               exp["updater_first16"], rtol=1e-6, atol=1e-7)
    r = np.random.RandomState(exp["input_seed"])
    x = r.randn(12, 5).astype("float32")
    np.testing.assert_allclose(net.output(x), np.asarray(exp["output"]),
                               rtol=1e-5, atol=1e-6)
    if name == "golden_checkpoint_v1.zip":
        # The checkpoint trains with dropout 0.8: the port's fit draws from
        # the checkpoint's key, advanced as jax.random.split advances it
        # (the masks themselves are not JAX's: no RNG-stream parity).
        key = net._train_rng.copy()
        before = net.params()
        net.fit(x, np.eye(3, dtype=np.float32)[r.randint(0, 3, 12)])
        assert net.iteration == 6 and np.isfinite(net.score_value)
        assert not np.array_equal(net.params(), before)
        np.testing.assert_array_equal(
            net._train_rng, np.asarray(jax.random.split(key)[0]))


# ----------------------------------------------- listeners and the RNG key

class _Record(IterationListener):
    def __init__(self):
        self.calls = []

    def on_epoch_start(self, model):
        self.calls.append(("start", model.iteration))

    def iteration_done(self, model, iteration):
        self.calls.append(("iter", iteration))

    def on_epoch_end(self, model):
        self.calls.append(("end", model.iteration))


class _JaxRecord(JaxListener):
    def __init__(self):
        self.calls = []

    def on_epoch_start(self, model):
        self.calls.append(("start", model.iteration))

    def iteration_done(self, model, iteration):
        self.calls.append(("iter", iteration))

    def on_epoch_end(self, model):
        self.calls.append(("end", model.iteration))


def _graph_mlp(builder, L, G, input_type, iterations):
    return (builder().seed(3).learning_rate(0.1).updater("adam")
            .iterations(iterations).graph_builder().add_inputs("in")
            .add_layer("d", L.DenseLayer(n_out=6, activation="tanh"), "in")
            .add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                            loss_function="mcxent"), "d")
            .set_outputs("out").set_input_types(input_type.feed_forward(4))
            .build())


@pytest.mark.parametrize("iterations", [1, 2])
def test_graph_listener_cadence_is_the_references(iterations):
    from deeplearning4j_tpu.nn.conf import graph as jax_graph
    from deeplearning4j_tpu_torch.nn.conf import graph

    jnet = JaxGraph(_graph_mlp(JaxNNC.builder, jax_layers, jax_graph,
                               JaxInputType, iterations)).init()
    pnet = ComputationGraph(_graph_mlp(NeuralNetConfiguration.builder,
                                       layers, graph, InputType, iterations),
                            device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    jrec, prec = _JaxRecord(), _Record()
    jnet.set_listeners(jrec)
    assert pnet.set_listeners(prec) is pnet
    batches = [_batch("mlp", s) for s in range(3)]
    for net, mds in ((jnet, JaxMDS), (pnet, MultiDataSet)):
        net.fit([mds(features=xs, labels=ys) for xs, ys in batches])
        xs, ys = batches[0]
        net.fit(mds(features=xs, labels=ys))
    assert prec.calls == jrec.calls
    assert prec.calls[0] == ("start", 0)
    assert prec.calls.count(("end", 3 * iterations)) == 1
    assert len([c for c in prec.calls if c[0] == "iter"]) == 4 * iterations
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               **F32)


@pytest.mark.parametrize("seed", [0, 3, 7, 123, 12345, 2 ** 31 + 5,
                                  2 ** 32 + 3, -1])
def test_prng_key_is_the_references(seed):
    np.testing.assert_array_equal(engine.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("kind", KINDS)
def test_init_sets_the_references_train_rng(kind):
    # `init` sets the reference's key, and each fit step advances it as the
    # reference's does (`key, sub = split(key)`), so the two chains agree
    # after the same fits.
    jnet, pnet = _ref_net(kind), _port_net(kind)
    np.testing.assert_array_equal(pnet._train_rng,
                                  np.asarray(jnet._train_rng))
    for step in range(2):
        _fit(pnet, kind, step)
        _fit(jnet, kind, step)
        np.testing.assert_array_equal(pnet._train_rng, np.asarray(
            jnet._clock[1] if jnet._clock is not None
            else jnet._train_rng))
    assert not np.array_equal(pnet._train_rng, engine.prng_key(
        int(pnet.conf.global_conf.seed) ^ 0x5EED))
    np.testing.assert_array_equal(pnet.clone()._train_rng, pnet._train_rng)
