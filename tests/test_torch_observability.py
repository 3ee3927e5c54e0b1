"""The port's observability (`deeplearning4j_tpu_torch/observability/`)
against the JAX package's, on the CPU, from seeded numpy inputs.

- Propagation: each package parses the other's `X-DL4J-Trace` header,
  `to_header` round-trips exactly, malformed headers are None in both.
- Tracing: one scripted sequence of nested spans, `complete`s and
  `instant`s gives the same `export_chrome` events in both (span ids
  renamed by first appearance; `ts`, `dur`, `pid`, `tid` apart), and the
  same `since` cursors.
- The engines, stager, iterators and checkpoint manager: after the same
  work in both packages, the families the reference registers are equal
  in name, kind, help and labels, and in counts (the compile and capture
  counters excepted: they count what compiles in each, ROADMAP C), and
  `host_nbytes` is equal.
- Flight recorder: bundles of the same three steps have the same
  `MANIFEST.json` keys and `steps.jsonl` iterations, losses within 1e-6;
  each package's inspector reads the other's bundle; a K=4 superstep
  dumps K distinct losses equal to its per-batch run; a malformed batch
  raises its own exception and leaves an exception bundle.
- SLO: the same exposition series gives the same document (burn rates,
  severities, pages) in both, exactly.
- Memory: the leaf bytes by prefix equal the reference's
  `live_buffer_report` for an f32 net.
- Profiler: `summary()` has the reference's keys and step counts; the
  FLOPs of a dense MLP step are within ±25% of the reference's XLA
  `cost_analysis` (found: 0.976 of it; the port counts the matrix
  products only, XLA every op).

Small sizes: an MLP 4-8-3 (B=6) and 784-512-256-10 for the FLOP count
(B=128); the LM at V=64, T=16, d=32, 2 blocks (B=2).
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_classification_data
from deeplearning4j_tpu import compilation
from deeplearning4j_tpu import observability as jobs
from deeplearning4j_tpu.checkpoint.manager import (
    CheckpointManager as JaxManager,
)
from deeplearning4j_tpu.datasets import staging as jax_staging
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.neural_net import NeuralNetConfiguration as JN
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.observability import memory as jmem
from deeplearning4j_tpu.observability import profiler as jprof
from deeplearning4j_tpu.observability import propagate as jprop
from deeplearning4j_tpu.observability import slo as jslo
from deeplearning4j_tpu.observability.tracing import Tracer as JTracer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import observability as obs
from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager
from deeplearning4j_tpu_torch.datasets import staging
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DeviceCacheDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import memory as pmem
from deeplearning4j_tpu_torch.observability import profiler as pprof
from deeplearning4j_tpu_torch.observability import propagate as pprop
from deeplearning4j_tpu_torch.observability import slo as pslo
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.observability.tracing import Tracer as PTracer

pflight_mod = importlib.import_module(
    "deeplearning4j_tpu_torch.observability.flight")
jflight_mod = importlib.import_module(
    "deeplearning4j_tpu.observability.flight")

N_IN, N_OUT, B = 4, 3, 6
V, T, D, H, NB = 64, 16, 32, 4, 2
LOSS = dict(rtol=1e-6, atol=1e-6)


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
    return {v: {k: np.array(a) for k, a in p.items()}
            for v, p in tree.items() if isinstance(p, dict)}


def mlp_conf(nn, Ls, it, k=0, updater="adam", dtype="float32"):
    return (nn.builder().seed(7).learning_rate(0.05).updater(updater)
            .weight_init("xavier").superstep_k(k).dtype(dtype).list()
            .layer(Ls.DenseLayer(n_out=8, activation="relu"))
            .layer(Ls.OutputLayer(n_out=N_OUT, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(it.feed_forward(N_IN)).build())


def mlp_pair(k=0, **kw):
    """The reference's MLP and the port's, from the same params."""
    jnet = JaxMLN(mlp_conf(JN, JL, JInputType, k, **kw)).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init(
            params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    return jnet, pnet


def lm_pair():
    jconf = jax_zoo.transformer_lm(V, t=T, d_model=D, n_heads=H,
                                   n_blocks=NB)
    jnet = JaxGraph(jconf).init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init(
            params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    return jnet, pnet


def mlp_batches(seed, n=3):
    rng = np.random.RandomState(seed)
    return [make_classification_data(rng, n=B, n_features=N_IN,
                                     n_classes=N_OUT) for _ in range(n)]


def lm_batches(seed, n=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, V, (2, T + 1))
        out.append((ids[:, :-1, None].astype(np.float32),
                    ids[:, 1:].astype(np.int32)))
    return out


# -------------------------------------------------------------- propagation


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("seed", range(3))
def test_each_package_parses_the_others_header(writer, seed):
    rng = np.random.RandomState(seed)
    trace_id = "".join(rng.choice(list("0123456789abcdef"), 32))
    span_id = "".join(rng.choice(list("0123456789abcdef"), 16))
    mods = (pprop, jprop) if writer == "port" else (jprop, pprop)
    header = mods[0].TraceContext(trace_id, span_id).to_header()
    assert header == f"00-{trace_id}-{span_id}-01"
    got = mods[1].parse(header)
    assert (got.trace_id, got.span_id) == (trace_id, span_id)
    assert got.to_header() == header  # round-trips exactly
    # A minted context too, and the header names are the same.
    minted = mods[0].mint()
    again = mods[1].parse(minted.to_header())
    assert (again.trace_id, again.span_id) == (minted.trace_id,
                                               minted.span_id)
    assert pprop.TRACE_HEADER == jprop.TRACE_HEADER == "X-DL4J-Trace"


@pytest.mark.parametrize("header", [
    None, "", "junk", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "01-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "B" * 16 + "-01",
    "  00-" + "c" * 32 + "-" + "d" * 16 + "-ff  "])
def test_malformed_and_odd_headers_parse_alike(header):
    got, want = pprop.parse(header), jprop.parse(header)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)


def test_bound_current_and_trace_headers():
    ctx = pprop.mint()
    assert pprop.current() is None
    with pprop.bound(ctx):
        assert pprop.current() is ctx
        assert pprop.trace_headers({"a": "b"}) == {
            "a": "b", pprop.TRACE_HEADER: ctx.to_header()}
        with pprop.bound(None):
            assert pprop.current() is None
        assert pprop.current() is ctx
    assert pprop.current() is None
    assert pprop.trace_headers() == {}
    child = ctx.child()
    assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id


# ------------------------------------------------------------------ tracing


def _script(tracer, prop):
    """One sequence of spans, completes and instants, with fixed contexts
    where the ids would otherwise be random."""
    root = prop.TraceContext("a" * 32, "b" * 16)
    remote = prop.TraceContext("c" * 32, "d" * 16)
    with tracer.span("outer", cat="train", epoch=0):
        with tracer.span("inner", k=1):
            tracer.instant("mark", step=3)
        try:
            with tracer.span("fails"):
                raise ValueError("boom")
        except ValueError:
            pass
    with tracer.span("replica", span_ctx=root, route="predict"):
        with tracer.span("child"):
            pass
    with tracer.span("remote_child", parent_ctx=remote):
        with tracer.span("grandchild"):
            pass
    tracer.complete("done", 1000, 500, cat="serving", parent_ctx=root,
                    rows=4)
    tracer.complete("fixed", 1000, -5, span_ctx=root, parent_ctx=remote)

    @tracer.trace("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2


def _normalized(doc):
    """Events without ts / dur / pid / tid, span ids renamed in order of
    appearance (child spans draw fresh random ids)."""
    names = {}
    out = []
    for ev in doc["traceEvents"]:
        ev = {k: v for k, v in ev.items()
              if k not in ("ts", "dur", "pid", "tid")}
        args = dict(ev.get("args", {}))
        for key in ("span_id", "parent_span_id"):
            if key in args:
                args[key] = names.setdefault(args[key], f"s{len(names)}")
        ev["args"] = args
        out.append(ev)
    return out


def test_scripted_trace_exports_the_same_events():
    pt, jt = PTracer(max_events=64), JTracer(max_events=64)
    _script(pt, pprop)
    _script(jt, jprop)
    pdoc, jdoc = pt.export_chrome(), jt.export_chrome()
    assert _normalized(pdoc) == _normalized(jdoc)
    assert set(pdoc) == set(jdoc)
    assert pdoc["seq"] == jdoc["seq"] == len(pdoc["traceEvents"])
    assert pdoc["displayTimeUnit"] == "ms"
    assert abs(pdoc["epochUnixUs"] - jdoc["epochUnixUs"]) < 60e6


@pytest.mark.parametrize("since", [None, 0, 3, 7, 100])
def test_since_cursor_and_ring_agree(since):
    docs = []
    for tracer_cls, prop in ((PTracer, pprop), (JTracer, jprop)):
        tr = tracer_cls(max_events=16)
        for i in range(20):
            tr.instant(f"e{i}")
        docs.append(tr.export_chrome(since=since))
    p, j = docs
    assert [e["name"] for e in p["traceEvents"]] == [
        e["name"] for e in j["traceEvents"]]
    assert p["seq"] == j["seq"] == 20


def test_disabled_tracer_and_sampled_iterations_are_noops(monkeypatch):
    tr = PTracer(enabled=False)
    with tr.span("x") as sp:
        assert sp.ctx() is None
    tr.complete("y", 0, 1)
    tr.instant("z")
    assert tr.events() == []
    monkeypatch.setattr(obs.config, "sample_every", 3)
    assert obs.iteration_span("graph", 4) is obs.NOOP_SPAN
    assert obs.iteration_span("graph", 3) is not obs.NOOP_SPAN
    tr = PTracer(max_events=16)
    for i in range(40):
        tr.instant(f"e{i}")
    tr.resize(20)
    assert len(tr.events()) == 16
    tr.clear()
    assert tr.events() == [] and tr.export_chrome()["seq"] == 40


def test_enable_disable_switch_the_registry_and_tracer():
    fam = obs.metrics.counter("dl4j_test_switch_total", "a test counter")
    try:
        obs.disable()
        fam.inc()
        assert fam.get() == 0 and obs.tracer.span("x") is obs.NOOP_SPAN
    finally:
        obs.enable()
    fam.inc()
    assert fam.get() == 1


# ------------------------------------------------------- engine families


ENGINE_FAMILIES = ("dl4j_train_iterations_total", "dl4j_train_epochs_total",
                   "dl4j_step_dispatch_seconds",
                   "dl4j_host_to_device_bytes_total",
                   "dl4j_input_wait_seconds")
# Declared as the reference's; counted for what compiles in each package.
COMPILE_FAMILIES = ("dl4j_jit_cache_hits_total",
                    "dl4j_jit_cache_misses_total")
STAGING_FAMILIES = ("dl4j_staging_inflight_bytes", "dl4j_staging_depth",
                    "dl4j_staging_wait_seconds", "dl4j_staging_bytes_total",
                    "dl4j_staging_put_seconds_total",
                    "dl4j_device_cache_bytes")
CHECKPOINT_FAMILIES = ("dl4j_checkpoint_saves_total",
                       "dl4j_checkpoint_restores_total",
                       "dl4j_checkpoint_bytes_written_total",
                       "dl4j_checkpoint_bytes_read_total",
                       "dl4j_checkpoint_queue_depth")
HOOK_FAMILIES = ("dl4j_xla_compiles_total", "dl4j_xla_compile_seconds_total",
                 "dl4j_compile_cache_hits_total",
                 "dl4j_compile_cache_misses_total", "dl4j_compile_seconds")


def _counts(reg, name):
    """{labels: value or observations} of a family (None if absent)."""
    fam = reg.get_family(name)
    if fam is None:
        return None
    out = {}
    for c in fam.children():
        key = tuple(sorted(c.labels.items()))
        out[key] = (c.histogram_state()[3] if fam.kind == "histogram"
                    else c.get())
    return out


def _delta(before, after):
    return {k: v - (before or {}).get(k, 0) for k, v in after.items()
            if v - (before or {}).get(k, 0)}


@pytest.mark.parametrize("name", ENGINE_FAMILIES + COMPILE_FAMILIES
                         + STAGING_FAMILIES + CHECKPOINT_FAMILIES
                         + HOOK_FAMILIES + ("dl4j_program_hbm_bytes",
                                            "dl4j_build_info"))
def test_family_declared_as_the_reference(name):
    obs.install_compile_hook()
    jobs.install_jax_compile_hook()
    port, ref = obs.metrics.get_family(name), jobs.metrics.get_family(name)
    assert port is not None and ref is not None
    assert (port.kind, port.label_names, port.help, port._buckets) == (
        ref.kind, ref.label_names, ref.help, ref._buckets)


def test_build_info_labels():
    text = obs.metrics.to_prometheus()
    assert ('dl4j_build_info{version="0.1.0",jax="unloaded",'
            'backend="cpu",device_kind="cpu"} 1') in text


@pytest.mark.parametrize("engine", ["mln", "graph"])
def test_fit_counts_equal_the_references(engine, monkeypatch):
    """The same fits (a two-batch epoch, then one batch) count the same
    iterations, epochs, dispatches by k, host->device bytes and input
    waits in both packages. The reference stages the epoch through a
    DeviceStager on the CPU (whose bytes it counts), the port dispatches
    the host arrays (whose bytes the dispatch counts): the sums agree."""
    if engine == "mln":
        jnet, pnet = mlp_pair()
        data = mlp_batches(0)
        jitems = [JDataSet(x, y) for x, y in data]
        pitems = [DataSet(x, y) for x, y in data]
    else:
        jnet, pnet = lm_pair()
        data = lm_batches(0, 3)
        jitems = [JMDS([x], [y]) for x, y in data]
        pitems = [MultiDataSet([x], [y]) for x, y in data]
    before = {n: (_counts(obs.metrics, n), _counts(jobs.metrics, n))
              for n in ENGINE_FAMILIES}
    jnet.fit(jitems[:2])
    jnet.fit(jitems[2])
    pnet.fit(pitems[:2])
    pnet.fit(pitems[2])
    for name in ENGINE_FAMILIES:
        pb, jb = before[name]
        got = _delta(pb, _counts(obs.metrics, name))
        want = _delta(jb, _counts(jobs.metrics, name))
        assert got == want, name
    assert pnet.iteration == jnet.iteration == 3
    parts = [data[0][0], data[0][1], None, [data[1][0]]]
    assert obs.host_nbytes(*parts) == jobs.host_nbytes(*parts) > 0
    # A tensor already on the batch's device counts 0, a CPU tensor bound
    # for another device its bytes.
    t = torch.from_numpy(data[0][0])
    assert obs.host_nbytes(t, device="cpu") == 0
    assert obs.host_nbytes(t) == data[0][0].nbytes


def test_stager_and_cache_counts_equal_the_references():
    data = mlp_batches(1, 4)
    names = STAGING_FAMILIES + ("dl4j_host_to_device_bytes_total",)
    before = {n: (_counts(obs.metrics, n), _counts(jobs.metrics, n))
              for n in names}
    pitems = list(staging.DeviceStager(
        [DataSet(x, y) for x, y in data], device="cpu", engine="mln"))
    jitems = list(jax_staging.DeviceStager(
        [JDataSet(x, y) for x, y in data], engine="mln"))
    assert len(pitems) == len(jitems) == 4
    pcache = DeviceCacheDataSetIterator([DataSet(x, y) for x, y in data],
                                        device="cpu")
    list(pcache)
    from deeplearning4j_tpu.datasets.iterators import (
        DeviceCacheDataSetIterator as JCache,
    )
    jcache = JCache([JDataSet(x, y) for x, y in data])
    list(jcache)
    for name in names:
        pb, jb = before[name]
        got = _delta(pb, _counts(obs.metrics, name))
        want = _delta(jb, _counts(jobs.metrics, name))
        if name == "dl4j_staging_put_seconds_total":
            # Seconds differ; the modes that took puts are the same.
            assert set(got) == set(want), name
        else:
            assert got == want, name
    pcache.invalidate()
    jcache.invalidate()


def test_checkpoint_counts_equal_the_references(tmp_path):
    jnet, pnet = mlp_pair()
    (x, y), = mlp_batches(2, 1)
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    before = {n: (_counts(obs.metrics, n), _counts(jobs.metrics, n))
              for n in CHECKPOINT_FAMILIES}
    pm = CheckpointManager(str(tmp_path / "port"), async_save=True,
                           device="cpu")
    jm = JaxManager(str(tmp_path / "jax"), async_save=True)
    for m, net in ((pm, pnet), (jm, jnet)):
        m.save(net)
        m.flush()
        m.restore(net=net)
    for name in CHECKPOINT_FAMILIES:
        pb, jb = before[name]
        got = _delta(pb, _counts(obs.metrics, name))
        want = _delta(jb, _counts(jobs.metrics, name))
        if name.startswith("dl4j_checkpoint_bytes"):
            assert set(got) == set(want) and all(
                v > 0 for v in got.values()), name
        else:
            assert got == want, name
    # The manager's own view, read-only, and its spans.
    assert pm.stats["dl4j_checkpoint_saves_total"] == 1
    assert pm.stats["dl4j_checkpoint_restores_total"] == 1
    with pytest.raises(TypeError):
        pm.stats["dl4j_checkpoint_saves_total"] = 5
    assert set(pm.timings) == {"checkpoint.snapshot", "checkpoint.write",
                               "checkpoint.restore"}
    names = {e["name"] for e in obs.tracer.events()}
    assert {"checkpoint.snapshot", "checkpoint.write",
            "checkpoint.restore"} <= names


def test_fit_spans_nest_as_the_references():
    obs.tracer.clear()
    jobs.tracer.clear()
    jnet, pnet = mlp_pair()
    data = mlp_batches(3, 2)
    jnet.fit([JDataSet(x, y) for x, y in data])
    pnet.fit([DataSet(x, y) for x, y in data])

    def shape(events):
        return sorted((e["name"], e["args"].get("parent"),
                       e["args"].get("iteration"))
                      for e in events if e["name"].startswith("mln."))
    assert shape(obs.tracer.events()) == shape(jobs.tracer.events())
    assert ("mln.iteration", "mln.fit", 2) in shape(obs.tracer.events())


def test_compile_hook_counts_a_build_and_a_load():
    from deeplearning4j_tpu_torch.kernels import _build

    reg = MetricsRegistry()
    obs.install_compile_hook(reg)
    for fn in list(_build.build_listeners):
        fn("trace", 2.5)
        fn("persistent", 0.25)
    assert reg.get_family("dl4j_xla_compiles_total").get() == 1
    phase = reg.get_family("dl4j_xla_compile_seconds_total")
    assert phase.labels(phase="nvcc").get() == 2.5
    assert reg.get_family("dl4j_compile_cache_hits_total").labels(
        source="persistent").get() == 1
    assert reg.get_family("dl4j_compile_cache_misses_total").labels(
        source="persistent").get() == 1
    secs = reg.get_family("dl4j_compile_seconds")
    assert secs.labels(source="trace").histogram_state()[3] == 1
    assert secs.labels(source="persistent").histogram_state()[3] == 1


def test_bench_snapshot_has_the_references_keys():
    jnet, pnet = mlp_pair()
    (x, y), = mlp_batches(4, 1)
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    got, want = obs.bench_snapshot(), jobs.bench_snapshot()
    assert "engine=mln,k=1" in got["dl4j_step_dispatch_seconds"]
    assert "engine=mln,k=1" in want["dl4j_step_dispatch_seconds"]
    assert got["dl4j_step_dispatch_seconds"]["engine=mln,k=1"][
        "count"] >= 1
    json.dumps(got)


# -------------------------------------------------------------- flight


@pytest.fixture
def recorders(tmp_path, monkeypatch):
    """Both packages' process-global recorders, emptied, dumping under
    tmp_path, with no rate limit."""
    out = []
    for rec, name in ((obs.flight, "port"), (jobs.flight, "jax")):
        rec.clear()
        monkeypatch.setattr(rec, "dump_dir", str(tmp_path / name))
        monkeypatch.setattr(rec, "min_interval_s", 0.0)
        out.append(rec)
    return out


def _steps(bundle):
    with open(os.path.join(bundle, "steps.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_bundles_agree_and_each_inspector_reads_the_other(recorders,
                                                          capsys):
    prec, jrec = recorders
    jnet, pnet = mlp_pair()
    for x, y in mlp_batches(5, 3):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    pb, jb = prec.dump(reason="manual"), jrec.dump(reason="manual")
    for b in (pb, jb):
        for f in ("MANIFEST.json", "steps.jsonl", "trace.json",
                  "metrics.json"):
            assert os.path.isfile(os.path.join(b, f)), (b, f)
    pman = json.load(open(os.path.join(pb, "MANIFEST.json")))
    jman = json.load(open(os.path.join(jb, "MANIFEST.json")))
    assert set(pman) == set(jman)
    assert pman["reason"] == jman["reason"] == "manual"
    psteps, jsteps = _steps(pb), _steps(jb)
    assert [s["iteration"] for s in psteps] == [
        s["iteration"] for s in jsteps] == [1, 2, 3]
    np.testing.assert_allclose([s["loss"] for s in psteps],
                               [s["loss"] for s in jsteps], **LOSS)
    assert [s["k"] for s in psteps] == [s["k"] for s in jsteps]
    assert [s["h2d_bytes"] for s in psteps] == [
        s["h2d_bytes"] for s in jsteps]
    trace = json.load(open(os.path.join(pb, "trace.json")))
    assert sum(e["name"] == "mln.step" for e in trace["traceEvents"]) == 3
    capsys.readouterr()
    assert pflight_mod.main([jb]) == 0
    assert "3 step records" in capsys.readouterr().out
    assert jflight_mod.main([pb]) == 0
    assert "3 step records" in capsys.readouterr().out
    assert pflight_mod.main([str(pb) + "-missing"]) == 2


def test_superstep_bundle_holds_k_distinct_losses(recorders):
    prec, _ = recorders
    data = mlp_batches(6, 8)
    ref = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        mlp_conf(NeuralNetConfiguration, L, InputType).to_json()),
        device="cpu").init()
    scores = []
    for x, y in data:
        ref.fit(DataSet(x, y))
        scores.append(ref.score_value)
    prec.clear()
    net = MultiLayerNetwork(mlp_conf(NeuralNetConfiguration, L, InputType,
                                     k=4), device="cpu").init()
    net.fit([DataSet(x, y) for x, y in data])
    steps = [s for s in _steps(prec.dump(reason="manual"))
             if s["type"] == "step"]
    assert [(s["k"], s["iteration"]) for s in steps] == [(4, 4), (4, 8)]
    losses = [v for s in steps for v in s["losses"]]
    assert losses == scores  # bit for bit the per-batch run's
    assert len(set(losses[:4])) == 4 and len(set(losses[4:])) == 4
    assert [s["loss"] for s in steps] == [scores[3], scores[7]]


def test_a_malformed_batch_raises_its_own_error_and_leaves_a_bundle(
        recorders):
    prec, _ = recorders
    _, pnet = mlp_pair()
    (x, y), = mlp_batches(7, 1)
    with pytest.raises(RuntimeError) as e:
        pnet.fit(DataSet(x[:, :2], y))
    bundles = [b for b in prec.status()["dumps"]
               if b.startswith(prec.dump_dir)]
    assert len(bundles) == 1 and "crash-mln.dispatch" in bundles[0]
    man = json.load(open(os.path.join(bundles[0], "MANIFEST.json")))
    assert man["exception"]["type"] == type(e.value).__name__
    assert man["reason"] == "crash:mln.dispatch"
    crash = [s for s in _steps(bundles[0]) if s["type"] == "crash"]
    assert crash and crash[0]["where"] == "mln.dispatch"


def test_automatic_dumps_are_rate_limited(tmp_path):
    rec = pflight_mod.FlightRecorder(dump_dir=str(tmp_path))
    rec.min_interval_s = 60.0
    assert rec.on_crash("x", ValueError("a")) is not None
    assert rec.on_crash("x", ValueError("b")) is None
    assert rec.dump(reason="crash:x") is not None  # explicit: forced
    rec.record_step("mln", 1, loss=torch.tensor(float("nan")))
    assert rec.snapshot()[-1]["loss"] == "nan"


# --------------------------------------------------------------------- SLO


def _exposition(reg, ok, bad, fast, slow):
    req = reg.counter("dl4j_requests_total", "requests",
                      label_names=("model", "route", "outcome"))
    req.labels(model="m", route="generate", outcome="ok").inc(ok)
    req.labels(model="m", route="generate", outcome="error").inc(bad)
    ttft = reg.histogram("dl4j_serving_ttft_seconds", "ttft",
                         label_names=("model",),
                         buckets=obs.WIDE_BUCKETS)
    for _ in range(fast):
        ttft.labels(model="m").observe(0.05)
    for _ in range(slow):
        ttft.labels(model="m").observe(3.0)
    return reg.to_prometheus()


@pytest.mark.parametrize("scenario", [
    [(100, 0, 50, 0)] * 6,
    [(100, 0, 50, 0), (90, 10, 40, 10), (90, 10, 40, 10), (90, 10, 40, 10),
     (100, 0, 50, 0), (100, 0, 50, 0)],
    [(100, 2, 50, 1)] * 6,
    [(10, 10, 1, 5), (0, 0, 0, 0), (10, 10, 1, 5), (10, 10, 1, 5),
     (0, 0, 0, 0), (10, 10, 1, 5)],
])
def test_burn_rates_and_pages_equal_the_references(scenario):
    pages = ([], [])
    engines = [pslo.BurnRateEngine(window_scale=1 / 600,
                                   on_page=lambda n, w: pages[0].append(n)),
               jslo.BurnRateEngine(window_scale=1 / 600,
                                   on_page=lambda n, w: pages[1].append(n))]
    reg = MetricsRegistry()
    docs = ([], [])
    for i, step in enumerate(scenario):
        text = _exposition(reg, *step)
        assert pslo.parse_prometheus(text) == jslo.parse_prometheus(text)
        for e, out in zip(engines, docs):
            out.append(e.report(text, now=float(i)))
    assert docs[0] == docs[1]
    assert pages[0] == pages[1]


def test_objectives_equal_the_references():
    assert [o.to_dict() for o in pslo.default_objectives()] == [
        o.to_dict() for o in jslo.default_objectives()]
    for bad in (dict(kind="nope"), dict(kind="latency"),
                dict(kind="availability", target=1.5)):
        kw = dict(dict(name="x", family="f", target=0.9), **bad)
        with pytest.raises(ValueError):
            pslo.Objective(**kw)
        with pytest.raises(ValueError):
            jslo.Objective(**kw)


# ------------------------------------------------------------------ memory


@pytest.mark.parametrize("updater", ["adam", "nesterovs", "sgd"])
def test_leaf_bytes_by_prefix_equal_the_references(updater):
    jnet, pnet = mlp_pair(updater=updater)
    (x, y), = mlp_batches(8, 1)
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    jmem.register_tree("obs_test_mlp", jnet)
    pmem.register_tree("obs_test_mlp", pnet)
    try:
        got = pmem.live_buffer_report()["models"]["obs_test_mlp"]
        want = jmem.live_buffer_report()["models"]["obs_test_mlp"]
    finally:
        jmem.unregister_tree("obs_test_mlp")
        pmem.unregister_tree("obs_test_mlp")

    def kept(groups):
        return {g: b for g, b in groups.items()
                if g.startswith(("params_tree/", "state/"))
                or updater != "sgd"}
    assert kept(got["groups"]) == kept(want["groups"])
    assert got["bytes"] == pmem.leaf_bytes(pnet)
    # Off the card there is no measured footprint: the caller keeps its
    # estimate.
    assert pmem.measured_model_bytes(pnet) is None
    assert pmem.report()["live"]["unattributed_bytes"] == 0


def test_record_program_memory_sets_the_gauges():
    stats = pmem.record_program_memory("obs_test.step", before=100,
                                       peak=1100, after=300)
    assert stats["output"] == 200 and stats["temp"] == 800
    fam = obs.metrics.get_family("dl4j_program_hbm_bytes")
    assert fam.labels(program="obs_test.step", kind="temp").get() == 800
    assert pmem.program_memory_snapshot()["obs_test.step"]["total"] == 1000
    assert pmem.program_label("output", {"model": "lm"}) == \
        jmem.program_label("output", {"model": "lm"}) == "output[model=lm]"
    with pmem.program_memory("obs_test.cpu", device="cpu"):
        pass  # off the card: nothing recorded
    assert "obs_test.cpu" not in pmem.program_memory_snapshot()


# ---------------------------------------------------------------- profiler


REQUIRED_SUMMARY = {"steps", "first_call_steps", "compile_seconds",
                    "execute_seconds_median", "host_to_device_bytes",
                    "step_latency", "flops_per_step", "flops_per_sec"}


@pytest.mark.parametrize("sync", [True, False])
def test_profiler_summary_matches_the_references(sync):
    jnet, pnet = mlp_pair()
    data = mlp_batches(9, 5)
    summaries = []
    for net, prof_cls, ds_cls in ((pnet, obs.StepProfiler, DataSet),
                                  (jnet, jobs.StepProfiler, JDataSet)):
        with prof_cls(net, sync=sync) as prof:
            for x, y in data:
                net.fit(ds_cls(x, y))
            net.output(data[0][0])
        summaries.append(prof.summary())
    got, want = summaries
    assert REQUIRED_SUMMARY <= set(got) and REQUIRED_SUMMARY <= set(want)
    assert set(got) - {"window_short", "compile_cache"} == set(want) - {
        "compile_cache"}
    assert (got["steps"], got["first_call_steps"]) == (
        want["steps"], want["first_call_steps"]) == (5, 1)
    assert got["host_to_device_bytes"] == want["host_to_device_bytes"]
    assert got["window_short"] is None  # no trace on the CPU
    assert got["infer_latency"]["count"] == 1
    # The engine's own methods again after the block.
    assert "_fit_dispatch" not in pnet.__dict__
    assert "output" not in pnet.__dict__


def test_flops_of_a_dense_mlp_step_within_the_stated_ratio():
    conf = (JN.builder().seed(3).learning_rate(0.01).updater("adam").list()
            .layer(JL.DenseLayer(n_out=512, activation="relu"))
            .layer(JL.DenseLayer(n_out=256, activation="relu"))
            .layer(JL.OutputLayer(n_out=10, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(JInputType.feed_forward(784)).build())
    jnet = JaxMLN(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init(
            params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    rng = np.random.RandomState(0)
    x = rng.rand(128, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 128)]
    want = jprof.estimate_step_cost(jnet, JDataSet(x, y))["flops"]
    got = pprof.estimate_step_cost(pnet, DataSet(x, y))
    assert got["bytes"] is None
    ratio = got["flops"] / want
    assert 0.75 <= ratio <= 1.25, ratio  # found 0.976
    # Exactly the matrix products: forward, the weight gradients, and the
    # input gradients of all but the first layer.
    fwd = 2 * 128 * (784 * 512 + 512 * 256 + 256 * 10)
    assert got["flops"] == 2 * fwd + 2 * 128 * (512 * 256 + 256 * 10)
    # The count leaves the net as it was.
    before = pnet.params()
    pprof.estimate_step_cost(pnet, DataSet(x, y))
    np.testing.assert_array_equal(pnet.params(), before)
    assert pnet.iteration == 0


def test_flops_of_the_lm_step_count_attention_and_the_head():
    _, pnet = lm_pair()
    x, y = lm_batches(10, 1)[0]
    flops = pprof.estimate_step_flops(pnet, MultiDataSet([x], [y]))
    tokens = 2 * T
    # At least 6 x params x tokens for the dense layers and the head.
    dense = sum(t.numel() for v in pnet.params_tree.values()
                for k, t in v.items() if t.ndim == 2 and k == "W")
    assert flops >= 4 * dense * tokens


def test_peaks_read_the_table_and_the_environment(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("BENCH_PEAK_FLOPS", raising=False)
    assert obs.chip_peak_flops() is None  # the CPU: no peak, no MFU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, flops, bw in (("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
                            ("NVIDIA H100 PCIe", 756e12, 2.0e12),
                            ("Some Other Card", None, None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a, n=name: n)
        assert obs.chip_peak_flops() == flops
        assert obs.chip_peak_hbm_bw() == bw
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DL4J_TPU_PEAK_HBM_BW", "2e9")
    assert obs.chip_peak_flops() == 1e12 and obs.chip_peak_hbm_bw() == 2e9


def test_kernel_symbols_name_the_library_kernels():
    syms = pprof.kernel_symbols()
    assert "batchnorm_kernel" in syms and len(syms) > 10
