"""The rest of the port's serving tier against the JAX package, on the CPU.

Small models, f32: a `transformer_lm` (V=64, d=32, 2 blocks, decode cache
64, pages of 4), a twin of it and a narrower draft; a 2-conv graph (conv,
BatchNorm relu, conv, BatchNorm, average pool, softmax) over 8x8x3
images. Both packages get the same params (`interop.params_from_numpy`).

- `/predict` through the shape-bucket batcher equals the port's own
  `output` row for row (1e-6) at every bucket and over a split, and that
  `output` equals the reference's (1e-5); the ladders and the feature
  policy equal the reference's functions;
- admission: shedding (503 + `Retry-After`), cancelled and expired
  requests dropped before the forward (the plain-call counter does not
  move), the caller's timeout, concurrent predicts;
- `/health`, `/healthz` from "warming" to "ready", a warmup failure kept
  as "failed" and raised by `wait_ready()`; serving from a port
  `CheckpointManager` root, from a sharded checkpoint the reference
  wrote, and from a zip;
- sampling and decoding: `_sample_tokens` (exact draws), `generate_lm_batch`
  (greedy ids), `step_k` and `rewind_all` of both steppers (1e-5) and
  `KVPagePool.rewind` op for op; drain mode; speculative decoding (greedy
  ids equal to the non-speculative scheduler's and to the reference
  scheduler's, the clamp near capacity, the sampled draw order, a twin
  draft that accepts, the knob refusals); warmup that leaves nothing
  behind;
- the scrape: every ported family's name, kind, help, buckets and label
  names equal the reference's declaration, and one `/metrics` scrape
  counts the requests sent.

Tests that run the JAX package take a fresh compile cache
(`fresh_compile_cache`).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu import observability as jax_obs
from deeplearning4j_tpu.checkpoint import store as jax_store
from deeplearning4j_tpu.models import kv_pool as jax_kv_pool
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import inputs as jax_inputs
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf import neural_net as jax_nn
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.serving import batcher as jax_batcher
from deeplearning4j_tpu.serving import errors as jax_errors
from deeplearning4j_tpu.serving import metrics as jax_metrics
from deeplearning4j_tpu.serving import scheduler as jax_scheduler
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch import observability as obs
from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager
from deeplearning4j_tpu_torch.models import kv_pool, zoo
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.transfer import TransferLearning
from deeplearning4j_tpu_torch.serving import (
    InferenceServer,
    InputValidationError,
    ModelNotReadyError,
    ServerOverloadedError,
    ShapeBucketBatcher,
    bucket_ladder,
    canonicalize_features,
    prompt_bucket_ladder,
)
from deeplearning4j_tpu_torch.serving import metrics as port_metrics
from deeplearning4j_tpu_torch.serving.scheduler import GenerationScheduler
from deeplearning4j_tpu_torch.util import model_serializer

V, T, D, H, NB, CAP, PAGE = 64, 16, 32, 4, 2, 64, 4
IMG, CLASSES = 8, 5
F32 = dict(rtol=1e-5, atol=1e-5)
ROWS = dict(rtol=1e-6, atol=1e-6)


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


def _np_tree(tree):
    return {k: {n: np.array(a) for n, a in p.items()}
            for k, p in tree.items() if isinstance(p, dict)}


def _port(jnet, conf_cls=ComputationGraphConfiguration):
    conf = conf_cls.from_json(jnet.conf.to_json())
    return ComputationGraph(conf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
        state=interop.state_from_numpy(_np_tree(jnet.state or {})))


def _jax_lm(d_model=D, seed=12345):
    conf = jax_zoo.transformer_lm(V, t=T, d_model=d_model, n_heads=H,
                                  n_blocks=NB, decode_cache_length=CAP,
                                  seed=seed)
    return JaxGraph(conf).init()


@pytest.fixture(scope="module")
def lms():
    """(jax target, port target, port twin, jax draft, port draft)."""
    jnet, jdraft = _jax_lm(), _jax_lm(d_model=16, seed=999)
    return jnet, _port(jnet), _port(jnet), jdraft, _port(jdraft)


def _conv_conf(builder, L, I):
    b = (builder().seed(7).learning_rate(0.1).weight_init("relu")
         .graph_builder().add_inputs("in"))
    b.add_layer("c1", L.ConvolutionLayer(kernel_size=(3, 3), n_out=8,
                                         convolution_mode="same",
                                         activation="identity"), "in")
    b.add_layer("bn1", L.BatchNormalization(activation="relu"), "c1")
    b.add_layer("c2", L.ConvolutionLayer(kernel_size=(3, 3), n_out=8,
                                         convolution_mode="same",
                                         activation="identity"), "bn1")
    b.add_layer("bn2", L.BatchNormalization(), "c2")
    b.add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"), "bn2")
    b.add_layer("out", L.OutputLayer(n_out=CLASSES, activation="softmax",
                                     loss_function="mcxent"), "pool")
    return (b.set_outputs("out")
            .set_input_types(I.convolutional(IMG, IMG, 3)).build())


@pytest.fixture(scope="module")
def convs():
    """(jax 2-conv graph, port copy) with seeded running statistics."""
    jnet = JaxGraph(_conv_conf(jax_nn.NeuralNetConfiguration.builder,
                               jax_layers, jax_inputs.InputType)).init()
    rng = np.random.RandomState(3)
    jnet.state = {v: {"mean": jnp.asarray(rng.randn(8).astype(np.float32)
                                          * 0.2),
                      "var": jnp.asarray(rng.rand(8).astype(np.float32)
                                         + 0.5)}
                  for v in ("bn1", "bn2")}
    return jnet, _port(jnet)


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, IMG, IMG, 3).astype(
        np.float32)


def _post(url, route, body, timeout=60):
    req = urllib.request.Request(url + route, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, route):
    with urllib.request.urlopen(url + route, timeout=30) as r:
        return r.read(), r.headers


# ------------------------------------------------------------------ ladders


@pytest.mark.parametrize("kind,args", [
    ("batch", (32, None)), ("batch", (12, (4, 8))), ("batch", (1, None)),
    ("batch", (5, (9, 2, 3))), ("prompt", (64, None)),
    ("prompt", (24, (8,))), ("prompt", (1024, None)),
    ("prompt", (16, (4, 32))),
])
def test_ladders_equal_the_reference(kind, args):
    port_fn, jax_fn = ((bucket_ladder, jax_batcher.bucket_ladder)
                       if kind == "batch" else
                       (prompt_bucket_ladder,
                        jax_scheduler.prompt_bucket_ladder))
    assert port_fn(*args) == jax_fn(*args)


@pytest.mark.parametrize("case", [
    "ids_ints", "ids_int_floats", "ids_grid3", "ids_fraction", "ids_nan",
    "values_list", "values_ints", "strings", "scalar",
])
def test_canonicalize_features_equals_the_reference(lms, convs, case):
    jlm, plm = lms[0], lms[1]
    jconv, pconv = convs
    data = {"ids_ints": [[1, 2, 3], [4, 5, 6]],
            "ids_int_floats": [[1.0, 2.0, 63.0]],
            "ids_grid3": np.arange(6).reshape(2, 3, 1),
            "ids_fraction": [[1.5, 2.0, 3.0]],
            "ids_nan": [[1.0, float("nan")]],
            "values_list": _images(2).tolist(),
            "values_ints": np.ones((1, IMG, IMG, 3), np.int64),
            "strings": "definitely not features",
            "scalar": 3.0}[case]
    pnet, jnet = (plm, jlm) if case.startswith("ids") else (pconv, jconv)
    try:
        want = jax_batcher.canonicalize_features(jnet, data)
    except jax_errors.InputValidationError as e:
        with pytest.raises(InputValidationError) as got:
            canonicalize_features(pnet, data)
        assert got.value.status == e.status == 400
        return
    got = canonicalize_features(pnet, data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ predict


def test_conv_graph_output_equals_the_reference(convs):
    jnet, pnet = convs
    x = _images(6)
    np.testing.assert_allclose(pnet.output(x)[0],
                               np.asarray(jnet.output(x)[0]), **F32)


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 11])
def test_predict_equals_output_at_every_bucket(convs, rows):
    # Buckets 1, 2, 4: 3 rows pad to 4, 11 rows split into 4 + 4 + 3. Each
    # batch is one forward: one plain BatchNorm call per BatchNorm layer.
    _, pnet = convs
    x = _images(rows, seed=rows)
    want = pnet.output(x)[0]
    server = InferenceServer(pnet, device="cpu", max_batch_size=4,
                             max_delay_ms=1.0)
    try:
        batcher = server.get(None).batcher
        assert batcher.buckets == (1, 2, 4)
        kernels.reset_counts()
        got = server.predict(x)
        batches = dict(batcher.stats)
    finally:
        server.stop()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **ROWS)
    assert batches["batches"] == -(-rows // 4)
    assert batches["rows"] == rows
    assert kernels.counts()["plain_calls"]["batchnorm_norm_act"] \
        == 2 * batches["batches"]


def test_ids_predict_keeps_integer_precision(lms):
    _, plm = lms[:2]
    server = InferenceServer(plm, device="cpu", max_batch_size=4,
                             kv_cache="paged", kv_page_size=PAGE)
    try:
        ids = np.array([[1, 2, 3, 60, 5, 6, 7, 8]], np.int64)
        got = server.predict(ids)
        with pytest.raises(InputValidationError) as e:
            server.predict([[1.5, 2.0, 3.0]])
        assert e.value.status == 400
    finally:
        server.stop()
    np.testing.assert_allclose(got, plm.output(ids[..., None])[0], **ROWS)


class _Counting:
    """A model that only has `output`: records each batch's rows."""

    def __init__(self, delay=0.0, n_out=2):
        self.delay, self.n_out, self.batches = delay, n_out, []

    def output(self, x):
        time.sleep(self.delay)
        x = np.asarray(x)
        self.batches.append(x.shape[0])
        return np.zeros((x.shape[0], self.n_out), np.float32)


def _timeouts(model):
    fam = obs.metrics.get_family("dl4j_requests_total")
    return sum(c.get() for c in fam.children()
               if c.labels == {"model": model, "route": "predict",
                               "outcome": "timeout"})


def test_full_queue_sheds_with_503_and_retry_after():
    batcher = ShapeBucketBatcher(_Counting(), model_name="shed",
                                 max_batch_size=2, queue_depth=2,
                                 warmup_shape=(3,))
    row = np.zeros((1, 3), np.float32)
    batcher.submit(row)
    batcher.submit(row)
    with pytest.raises(ServerOverloadedError) as e:
        batcher.submit(row)
    assert e.value.status == 503 and e.value.retry_after == 1
    server = InferenceServer(_Counting(), device="cpu", queue_depth=1,
                             warmup_shape=(3,)).start()
    try:
        served = server.get(None)
        served.batcher.stop()  # freeze the loop so that the queue fills
        served.batcher.submit(row)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url, "/predict", {"data": [[0.0, 0.0, 0.0]]})
        assert e.value.code == 503
        assert e.value.headers.get("Retry-After") == "1"
    finally:
        server.stop()


def test_cancelled_and_expired_requests_never_reach_the_forward(convs):
    _, pnet = convs
    batcher = ShapeBucketBatcher(pnet, model_name="drop", max_batch_size=4)
    before = _timeouts("drop")
    kernels.reset_counts()
    abandoned = batcher.submit(_images(1))
    abandoned.cancelled = True
    expired = batcher.submit(_images(2), time.monotonic() - 1.0)
    batcher._run_batch([abandoned, expired])
    assert kernels.counts()["plain_calls"]["batchnorm_norm_act"] == 0
    assert abandoned.event.is_set() and expired.event.is_set()
    assert abandoned.result is None and expired.error == "__deadline__"
    assert _timeouts("drop") == before + 2
    live = batcher.submit(_images(3))
    batcher._run_batch([live])
    assert kernels.counts()["plain_calls"]["batchnorm_norm_act"] == 2
    assert batcher.stats == {"batches": 1, "rows": 3, "padded_rows": 4,
                             "dropped": 2}


def test_caller_timeout_drops_its_request():
    net = _Counting(delay=0.25)
    server = InferenceServer(net, device="cpu", max_delay_ms=1.0,
                             warmup_shape=(3,))
    try:
        row = [[0.0, 0.0, 0.0]]
        first = threading.Thread(target=server.predict, args=(row,))
        first.start()
        time.sleep(0.05)  # the first batch is in its forward
        with pytest.raises(TimeoutError, match="predict_timeout_s"):
            server.predict(row, timeout_s=0.05)
        first.join()
        time.sleep(0.4)  # the loop drops the cancelled request
        assert net.batches == [1]
    finally:
        server.stop()


def test_concurrent_predicts_all_complete(convs):
    _, pnet = convs
    x = _images(12, seed=4)
    want = pnet.output(x)[0]
    server = InferenceServer(pnet, device="cpu", max_batch_size=4,
                             max_delay_ms=5.0)
    results = {}
    try:
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, server.predict(x[i:i + 1]))) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stats = dict(server.get(None).batcher.stats)
    finally:
        server.stop()
    assert stats["rows"] == 12 and stats["batches"] <= 12
    for i in range(12):
        np.testing.assert_allclose(results[i][0], want[i], **ROWS)


# ---------------------------------------------------------- health, warmup


class _Gated:
    """Wraps a net; its forwards wait until `gate` is set (or raise)."""

    def __init__(self, net, fail=False):
        self.net, self.fail = net, fail
        self.gate = threading.Event()
        self.conf, self.device = net.conf, net.device
        self._uint8_policies = net._uint8_policies

    def output(self, x):
        self.gate.wait(30)
        if self.fail:
            raise RuntimeError("the kernel did not launch")
        return self.net.output(x)


def test_health_and_warming_to_ready(convs):
    _, pnet = convs
    gated = _Gated(pnet)
    server = InferenceServer(gated, device="cpu", max_batch_size=2,
                             warmup=True).start()
    try:
        body, _ = _get(server.url, "/healthz")
        assert json.loads(body) == {"status": "warming",
                                    "models": {"default": "warming"}}
        assert json.loads(_get(server.url, "/health")[0]) == {
            "status": "ok", "model": "_Gated", "models": ["default"]}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url, "/predict", {"data": _images(1).tolist()})
        assert e.value.code == 503
        assert e.value.headers.get("Retry-After") == "1"
        with pytest.raises(ModelNotReadyError) as e:
            server.predict(_images(1))
        assert e.value.state == "warming" and e.value.retry_after == 1
        assert not server.wait_ready(timeout=0.05)
        gated.gate.set()
        assert server.wait_ready(timeout=30)
        body, _ = _get(server.url, "/healthz")
        assert json.loads(body) == {"status": "ready",
                                    "models": {"default": "ready"}}
        got = _post(server.url, "/predict", {"data": _images(1).tolist()})
        np.testing.assert_allclose(np.asarray(got["predictions"]),
                                   pnet.output(_images(1))[0], **ROWS)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.url, "/nope")
        assert e.value.code == 404
        assert json.loads(e.value.read())["routes"] == [
            "/health", "/healthz", "/metrics", "/api/trace", "/v1/models",
            "/v1/tenants", "/predict", "/generate", "/admin/flight-dump"]
    finally:
        server.stop()


def test_warmup_failure_is_kept_and_raised(convs):
    _, pnet = convs
    gated = _Gated(pnet, fail=True)
    gated.gate.set()
    server = InferenceServer(gated, device="cpu", warmup=True).start()
    try:
        with pytest.raises(RuntimeError, match="did not launch"):
            server.wait_ready(timeout=30)
        body, _ = _get(server.url, "/healthz")
        assert json.loads(body) == {"status": "failed",
                                    "models": {"default": "failed"}}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url, "/predict", {"data": _images(1).tolist()})
        assert e.value.code == 503 and "Retry-After" not in e.value.headers
        assert json.loads(e.value.read())["status"] == "failed"
        with pytest.raises(ModelNotReadyError, match="did not launch") as e:
            server.predict(_images(1))
        assert e.value.state == "failed" and e.value.retry_after is None
    finally:
        server.stop()


@pytest.mark.parametrize("source", ["manager_root", "reference_sharded",
                                    "zip"])
def test_serving_from_disk(convs, tmp_path, source):
    jnet, pnet = convs
    path = str(tmp_path / source)
    if source == "manager_root":
        CheckpointManager(path, async_save=False, device="cpu").save(pnet)
    elif source == "reference_sharded":
        jax_store.save_checkpoint(jnet, path)
    else:
        path += ".zip"
        model_serializer.save_model(pnet, path)
    x = _images(3, seed=9)
    if source == "zip":
        server = InferenceServer(device="cpu", max_batch_size=4)
        server.add_model("conv", path=path)
        name = "conv"
    else:
        server = InferenceServer.from_checkpoint(path, device="cpu",
                                                 max_batch_size=4)
        name = None
    try:
        served = server.get(name)
        assert served.scheduler is None and served.path == path
        np.testing.assert_allclose(server.predict(x, model=name),
                                   pnet.output(x)[0], **ROWS)
    finally:
        server.stop()


# --------------------------------------------------------- sampling, steps


@pytest.mark.parametrize("temperature,top_k", [
    (0.0, 0), (0.8, 0), (0.8, 5), (1.5, 3), (1.0, V)])
def test_sample_tokens_draws_as_the_reference(temperature, top_k):
    probs = np.random.RandomState(11).dirichlet(np.ones(V) * 0.3, size=6)
    got = zoo._sample_tokens(probs, np.random.RandomState(5), temperature,
                             top_k)
    want = jax_zoo._sample_tokens(probs, np.random.RandomState(5),
                                  temperature, top_k)
    np.testing.assert_array_equal(got, want)


def test_generate_lm_batch_greedy_equals_the_reference(lms):
    jnet, pnet = lms[:2]
    prompts = np.random.RandomState(2).randint(0, V, (3, 5))
    got = zoo.generate_lm_batch(pnet, prompts, 8, temperature=0.0)
    want = jax_zoo.generate_lm_batch(jnet, prompts, 8, temperature=0.0)
    assert got.shape == (3, 13)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        zoo.generate_lm_batch(pnet, prompts, CAP, temperature=0.0)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_step_k_and_rewind_all_equal_the_reference(lms, kv):
    jnet, pnet = lms[:2]
    mk = {"dense": (zoo.DecodeStepper, jax_zoo.DecodeStepper),
          "paged": (zoo.PagedDecodeStepper, jax_zoo.PagedDecodeStepper)}[kv]
    kw = {} if kv == "dense" else {"page_size": PAGE}
    steppers = [cls(net, 3, **kw) for cls, net in zip(mk, (pnet, jnet))]
    prompts = {0: [3, 14, 15, 9, 2], 2: [27, 18]}
    for st in steppers:
        for slot, p in prompts.items():
            _, state, n = st.prefill(p, pad_to=8)
            st.install(slot, state, n)
    tok = np.random.RandomState(4).randint(0, V, (3, 4))
    got, want = (np.asarray(st.step_k(tok)) for st in steppers)
    assert got.shape == (3, 4, V)
    for slot in prompts:
        np.testing.assert_allclose(got[slot], want[slot], **F32)
    # Keep 2 of slot 0's 4 rows and 1 of slot 2's, then step on.
    lengths = [len(prompts[0]) + 2, 0, len(prompts[2]) + 1]
    for st in steppers:
        st.rewind_all(lengths)
    nxt = [tok[0, 2], 0, tok[2, 1]]
    got, want = (np.asarray(st.step(nxt)) for st in steppers)
    for slot in prompts:
        np.testing.assert_allclose(got[slot], want[slot], **F32)
    if kv == "paged":
        p, j = steppers[0].pool, steppers[1].pool
        np.testing.assert_array_equal(p.table, j.table)
        assert p.counts() == j.counts()


def test_kv_pool_rewind_matches_the_reference():
    pools = [m.KVPagePool(slots=3, capacity=32, page_size=4)
             for m in (kv_pool, jax_kv_pool)]
    caches = [m.PrefixCache(p) for m, p in zip((kv_pool, jax_kv_pool),
                                                pools)]

    def both(fn):
        out = [fn(p, c) for p, c in zip(pools, caches)]
        assert out[0] == out[1]
        np.testing.assert_array_equal(pools[0].table, pools[1].table)
        for f in ("counts", "tracked", "free_count"):
            a, b = (getattr(p, f) for p in pools)
            assert (a() if callable(a) else a) == (b() if callable(b) else b)
        for s in range(3):
            assert pools[0].length_of(s) == pools[1].length_of(s)
            assert pools[0].pages_of(s) == pools[1].pages_of(s)

    both(lambda p, c: p.install_slot(0, 10))
    both(lambda p, c: c.admit([1, 2, 3], p.pages_of(0), 10, np.zeros(4)))
    both(lambda p, c: p.install_shared(1, p.pages_of(0), 10))
    both(lambda p, c: p.plan_appends(5))
    both(lambda p, c: p.rewind(0, 11))
    both(lambda p, c: p.rewind(1, 9))
    both(lambda p, c: p.rewind(2, 3))          # untracked: a no-op
    both(lambda p, c: p.plan_appends(3))
    both(lambda p, c: p.rewind(0, 0))
    both(lambda p, c: p.free_slot(1))
    both(lambda p, c: c.clear())
    both(lambda p, c: p.free_slot(0))
    assert pools[0].free_count == pools[0].num_pages - 1


# ------------------------------------------------------ drain, speculative


def _ids(net, prompt, n, **kw):
    return zoo.generate_lm(net, prompt, n, window=T, use_cache=True, **kw)


PROMPTS = [[1, 5, 2, 9, 4], [7, 7, 3], [12, 40, 41, 8, 9, 10], [2, 4, 6]]


def _concurrent(sched, bodies):
    results, errors = {}, []

    def run(i, prompt, n, kw):
        try:
            results[i] = sched.generate(prompt, n, timeout_s=120, **kw)
        except Exception as e:  # surfaced by the assert below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i, *b))
               for i, b in enumerate(bodies)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    return [results[i] for i in range(len(bodies))]


def test_drain_mode_equals_continuous_and_never_admits_mid_flight(lms):
    _, pnet = lms[:2]
    bodies = [(p, 5 + i, {"temperature": 0.0}) for i, p in
              enumerate(PROMPTS)]
    out = {}
    for mode in ("continuous", "drain"):
        sched = GenerationScheduler(pnet, model_name=f"m_{mode}", slots=2,
                                    mode=mode, kv="paged", page_size=PAGE)
        admitted, waves = {}, []
        real = sched._admit

        def spy(slot, req, sched=sched, admitted=admitted, waves=waves,
                real=real):
            step = sched.stats["decode_steps"]
            waves.append([admitted[s] for s in sched.stepper.pool.tracked()
                          if admitted.get(s) != step])
            admitted[slot] = step
            return real(slot, req)

        sched._admit = spy
        sched.start()
        try:
            out[mode] = _concurrent(sched, bodies)
        finally:
            sched.stop()
        if mode == "drain":
            # Every admission found the bank holding only requests admitted
            # in its own wave (at the same decode step).
            assert waves and all(not w for w in waves)
    assert out["drain"] == out["continuous"]
    for (p, n, _), got in zip(bodies, out["drain"]):
        assert got == _ids(pnet, p, n, temperature=0.0)


def test_speculative_greedy_equals_plain_and_the_reference(lms):
    jnet, pnet, _, jdraft, pdraft = lms
    prompt = PROMPTS[0]
    plain = _ids(pnet, prompt, 10, temperature=0.0)
    sched = GenerationScheduler(pnet, model_name="spec", slots=2,
                                kv="paged", page_size=PAGE, draft=pdraft,
                                spec_k=3).start()
    try:
        assert sched.generate(prompt, 10, temperature=0.0,
                              timeout_s=120) == plain
        proposals = (sched.stats["spec_accepted"],
                     sched.stats["spec_rejected"])
        # Near capacity k clamps to what is left.
        edge = [3, 3, 8]
        assert sched.generate(edge, CAP - 3, temperature=0.0,
                              timeout_s=120) == _ids(pnet, edge, CAP - 3,
                                                     temperature=0.0)
        # Sampled requests keep the sequential draw order (one token a
        # round, from the verify's row 0).
        assert sched.generate(prompt, 8, temperature=1.0, seed=5,
                              timeout_s=120) == _ids(pnet, prompt, 8,
                                                     temperature=1.0, seed=5)
    finally:
        sched.stop()
    ref = jax_scheduler.GenerationScheduler(
        jnet, model_name="port_spec_ref", slots=2, kv="paged",
        page_size=PAGE, draft=jdraft, spec_k=3).start()
    counters = [jax_metrics.SPECULATIVE_TOKENS.labels(
        model="port_spec_ref", outcome=o) for o in ("accepted", "rejected")]
    before = [c.get() for c in counters]
    try:
        assert ref.generate(prompt, 10, temperature=0.0,
                            timeout_s=120) == plain
    finally:
        ref.stop()
    # The same proposals accepted and rejected: the draft is rewound as
    # the reference rewinds it.
    assert proposals == tuple(c.get() - b for c, b in zip(counters, before))
    assert proposals[1] > 0


def test_twin_draft_accepts_tokens(lms):
    _, pnet, twin = lms[:3]
    acc = port_metrics.SPECULATIVE_TOKENS.labels(model="port_twin",
                                                 outcome="accepted")
    before = acc.get()
    sched = GenerationScheduler(pnet, model_name="port_twin", slots=2,
                                kv="paged", page_size=PAGE, draft=twin,
                                spec_k=3).start()
    try:
        bodies = [(p, 12, {"temperature": 0.0}) for p in PROMPTS[:3]]
        got = _concurrent(sched, bodies)
        stats = dict(sched.stats)
    finally:
        sched.stop()
    for (p, n, _), ids in zip(bodies, got):
        assert ids == _ids(pnet, p, n, temperature=0.0)
    # Identical weights: the target agrees with its draft; what counts as
    # rejected are the proposals past a request's last token.
    assert stats["spec_accepted"] > stats["spec_rejected"]
    assert acc.get() - before == stats["spec_accepted"]
    assert stats["decode_steps"] < 3 * 11


@pytest.mark.parametrize("case", ["spec_k_0", "spec_k_past_kernel", "mode",
                                  "kv", "dense_prefix_cache", "hbm_budget",
                                  "model_parallel", "adapter"])
def test_knob_refusals(lms, case, tmp_path):
    _, pnet, twin = lms[:3]
    err, match = ValueError, None
    if case == "hbm_budget":
        # The budget holds (no refusal since A.12): under a budget below
        # one model, adding a second model from disk evicts the first, a
        # request for the first reloads it and evicts the second, and both
        # answer as the net they were saved from.
        path = str(tmp_path / "lm.zip")
        model_serializer.save_model(pnet, path)
        server = InferenceServer(device="cpu", kv_cache="paged",
                                 kv_page_size=PAGE, hbm_budget_bytes=1)
        try:
            server.add_model("a", path=path)
            server.add_model("b", path=path)
            rows = {r["name"]: r for r in server.snapshot()}
            assert (rows["a"]["status"], rows["b"]["resident"]) == (
                "evicted", True)
            got = server.generate([1, 2, 3], 5, model="a", temperature=0)
            rows = {r["name"]: r for r in server.snapshot()}
            assert rows["a"]["resident"] and not rows["b"]["resident"]
            assert got == server.generate([1, 2, 3], 5, model="b",
                                          temperature=0)
            assert got == zoo.generate_lm(pnet.clone(), [1, 2, 3], 5, window=T,
                                          temperature=0, use_cache=True)
        finally:
            server.stop()
        return
    if case == "adapter":
        # `adapter=` serves (no refusal since A.12): a LoRA delta beside
        # the resident base answers as the fine-tuned net; an unknown name
        # is a 400, and a model with a draft refuses adapters.
        tuned = TransferLearning(pnet).add_lora(rank=2, alpha=4).build()
        for lp in tuned.params_tree.values():
            for k, t in lp.items():
                if k.endswith("__lora_b"):
                    t.data.normal_(0.0, 0.5,
                                   generator=torch.Generator().manual_seed(3))
        tuned.set_params(tuned.params())  # drops the stale inference copy
        server = InferenceServer(pnet, device="cpu", kv_cache="paged",
                                 kv_page_size=PAGE)
        server.add_model("spec", twin, draft=lms[4], spec_k=2)
        try:
            server.load_adapter("tenant", net=tuned)
            server.load_adapter("tenant", net=tuned, model="spec")
            x = np.array([[1, 2, 3, 4]])
            np.testing.assert_allclose(
                server.predict(x, adapter="tenant"),
                tuned.output(x[..., None])[0], **ROWS)
            with pytest.raises(InputValidationError, match="no adapter"):
                server.predict(x, adapter="nope")
            with pytest.raises(InputValidationError, match="draft"):
                server.generate([1, 2], 3, model="spec", adapter="tenant")
        finally:
            server.stop()
        return
    if case == "spec_k_0":
        def call():
            GenerationScheduler(pnet, kv="paged", draft=twin, spec_k=0)
    elif case == "spec_k_past_kernel":
        match = "query rows"

        def call():
            GenerationScheduler(pnet, kv="paged", page_size=PAGE,
                                draft=twin, spec_k=8)
    elif case == "mode":
        def call():
            GenerationScheduler(pnet, mode="nope")
    elif case == "kv":
        def call():
            GenerationScheduler(pnet, kv="nope")
    elif case == "dense_prefix_cache":
        def call():
            GenerationScheduler(pnet, kv="dense", prefix_cache=True)
    else:
        err, match = NotImplementedError, "A.13"

        def call():
            InferenceServer(device="cpu", model_parallel=2)
    with pytest.raises(err, match=match):
        call()


def test_generate_during_warmup_is_refused(lms):
    """While the LM warms (slot 0 and the pool's pages in use on the
    warmup thread), `generate` in process and over HTTP is refused and
    admits nothing; after warmup the same request is served."""
    _, pnet = lms[:2]
    server = InferenceServer(pnet, device="cpu", kv_cache="paged",
                             kv_page_size=PAGE, decode_slots=2, warmup=True,
                             max_batch_size=2)
    sched = server.get(None).scheduler
    gate, warming = threading.Event(), threading.Event()
    warm = sched.warmup

    def gated_warmup():
        warming.set()
        gate.wait(30)
        warm()

    sched.warmup = gated_warmup
    server.start()
    try:
        assert warming.wait(30)
        with pytest.raises(ModelNotReadyError) as e:
            server.generate(PROMPTS[0], 4, temperature=0.0)
        assert e.value.state == "warming"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url, "/generate", {"prompt_ids": PROMPTS[0],
                                            "n_steps": 4})
        assert e.value.code == 503
        assert e.value.headers.get("Retry-After") == "1"
        assert sched.stats["prefills"] == 0
        assert not sched.stepper.pool.tracked()
        gate.set()
        assert server.wait_ready(timeout=60)
        assert server.generate(PROMPTS[0], 4, temperature=0.0) == _ids(
            pnet, PROMPTS[0], 4, temperature=0.0)
    finally:
        gate.set()
        server.stop()


def test_free_list_kept_restores_order_and_raises_on_a_leak():
    pool = kv_pool.KVPagePool(slots=2, capacity=16, page_size=4)
    free0 = list(pool._free)
    with pool.free_list_kept():
        pool.install_slot(0, 9)
        pool.plan_appends(4)
        pool.free_slot(0)
    assert pool._free == free0
    with pytest.raises(RuntimeError, match="free pages changed"):
        with pool.free_list_kept():
            pool.install_slot(1, 5)


def test_warmup_leaves_slot_pool_and_prefix_cache_as_they_were(lms):
    _, pnet, twin = lms[:3]
    prompt, want = PROMPTS[2], None
    for warm in (False, True):
        server = InferenceServer(pnet, device="cpu", kv_cache="paged",
                                 kv_page_size=PAGE, decode_slots=2,
                                 draft=twin, spec_k=3, warmup=warm,
                                 max_batch_size=2)
        sched = server.get(None).scheduler
        free0 = list(sched.stepper.pool._free)
        kernels.reset_counts()
        server.start()
        try:
            assert server.wait_ready(timeout=60)
            warm_calls = kernels.counts()["plain_calls"]
            pool = sched.stepper.pool
            assert pool._free == free0 and not pool.tracked()
            assert len(sched.prefix_cache) == 0
            assert sched.stats["prefills"] == 0
            cursors = [int(c[k].abs().max()) for c, k in
                       sched.stepper._cursors()] if warm else [0]
            assert cursors == [0] * len(cursors)
            got = server.generate(prompt, 9, temperature=0.0)
        finally:
            server.stop()
        if warm:
            # Every prompt bucket's prefill (4 buckets), target and draft,
            # and the predict path's forward at batch buckets 1 and 2.
            assert warm_calls["flash_attention"] == NB * (2 * 4 + 2)
            assert warm_calls["paged_decode_attention"] == NB * (1 + 3)
            assert got == want
        else:
            assert not any(warm_calls.values())
            want = got


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("name", port_metrics.FAMILIES)
def test_family_declared_as_the_reference(name):
    port, ref = (reg.get_family(name) for reg in (obs.metrics,
                                                  jax_obs.metrics))
    assert ref is not None and port is not None
    assert (port.kind, port.label_names, port.help, port._buckets) == (
        ref.kind, ref.label_names, ref.help, ref._buckets)


def _requests_total(model, route, outcome):
    fam = obs.metrics.get_family("dl4j_requests_total")
    return sum(c.get() for c in fam.children()
               if c.labels == {"model": model, "route": route,
                               "outcome": outcome})


def test_one_scrape_counts_the_requests(lms, convs):
    _, plm, twin = lms[:3]
    _, pconv = convs
    server = InferenceServer(device="cpu", max_batch_size=4,
                             max_delay_ms=1.0, kv_cache="paged",
                             kv_page_size=PAGE)
    server.add_model("scrape_lm", plm, draft=twin, spec_k=2)
    server.add_model("scrape_conv", pconv)
    before = {(m, r, o): _requests_total(m, r, o) for m, r, o in (
        ("scrape_lm", "generate", "ok"), ("scrape_conv", "predict", "ok"),
        ("scrape_conv", "predict", "invalid"))}
    server.start()
    try:
        for _ in range(2):  # the second one hits the prefix cache
            _post(server.url, "/generate", {"prompt_ids": [1, 2, 3, 4],
                                            "n_steps": 6, "temperature": 0,
                                            "model": "scrape_lm"})
        for n in (1, 3, 6):
            _post(server.url, "/predict", {"data": _images(n).tolist(),
                                           "model": "scrape_conv"})
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url, "/predict", {"data": "bad",
                                           "model": "scrape_conv"})
        assert e.value.code == 400
        body, headers = _get(server.url, "/metrics")
        scrape = body.decode()
        jbody, jheaders = _get(
            server.url, "/metrics?format=json&names=dl4j_requests_total,"
            "dl4j_kv_pages")
    finally:
        server.stop()
    assert headers.get("Content-Type").startswith("text/plain")
    for name in port_metrics.FAMILIES:
        assert f"# TYPE {name} " in scrape, name
    for needle in (
            'dl4j_kv_pages{model="scrape_lm",state="shared"}',
            'dl4j_prefix_cache_hits_total{model="scrape_lm"} 1',
            'dl4j_speculative_tokens_total{model="scrape_lm",'
            'outcome="accepted"}',
            'dl4j_serving_ttft_seconds_bucket{model="scrape_lm"',
            'dl4j_serving_request_seconds_bucket{model="scrape_conv",'
            'route="predict"',
            'dl4j_serving_model_dtype{model="scrape_conv",dtype="float32"} 1',
            'dl4j_serving_model_queue_depth{model="scrape_conv",'
            'route="predict"} 0'):
        assert needle in scrape, needle
    after = {k: _requests_total(*k) for k in before}
    assert {k: after[k] - before[k] for k in before} == {
        ("scrape_lm", "generate", "ok"): 2,
        ("scrape_conv", "predict", "ok"): 3,
        ("scrape_conv", "predict", "invalid"): 1}
    assert jheaders.get_content_type() == "application/json"
    doc = json.loads(jbody)
    assert set(doc) == {"dl4j_requests_total", "dl4j_kv_pages"}
    assert doc["dl4j_kv_pages"]["type"] == "gauge"
