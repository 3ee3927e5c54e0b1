"""The port's serving-tier observability against the JAX package's, on the
CPU: the request ledger and `/v1/tenants`, trace context across HTTP and
the serving threads, `/api/trace`, `/admin/flight-dump`, the SLO engine
over `/metrics` scrapes, memory attribution of hosted models, and the
KV pool's copy-on-write counts.

The LM and its two tenants are the adapter tests' (the reference's
`tests/test_transfer_lora.py` sizes: V=17, t=16, d=32, 2 heads, 1 block,
a decode cache of 32, pages of 8), the same params in both packages.

- The same requests through a server of each package give equal
  `/v1/tenants` rows: requests, tokens in and out, outcomes.
- The tenants' device-seconds add up to
  `dl4j_serving_dispatch_seconds_total` (1e-9 relative): they are the
  same measured intervals, split.
- A request sent with `X-DL4J-Trace` runs in `replica.<route>`, the
  header's child, and its `serving.prefill` / `serving.batch` spans are
  the replica span's children; the reference's span names under the
  trace are a subset of the port's (its batch span has no trace
  identity).
"""

import importlib
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu import observability as jobs
from deeplearning4j_tpu.models import kv_pool as jax_kv_pool
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn import lora as jax_lora
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.transfer import TransferLearning as JaxTL
from deeplearning4j_tpu.observability import ledger as jledger_mod
from deeplearning4j_tpu.observability import slo as jslo
from deeplearning4j_tpu.serving import InferenceServer as JaxServer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import observability as obs
from deeplearning4j_tpu_torch.models import kv_pool
from deeplearning4j_tpu_torch.nn import lora
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.observability import ledger as pledger_mod
from deeplearning4j_tpu_torch.observability import memory as pmem
from deeplearning4j_tpu_torch.observability import propagate as pprop
from deeplearning4j_tpu_torch.observability import slo as pslo
from deeplearning4j_tpu_torch.serving import InferenceServer
from deeplearning4j_tpu_torch.serving import host as host_mod
from deeplearning4j_tpu_torch.serving import metrics as port_metrics
from deeplearning4j_tpu_torch.serving.host import ModelHost
from deeplearning4j_tpu_torch.serving.scheduler import GenerationScheduler

V, T, D, H, CAP = 17, 16, 32, 2, 32
TENANTS = ("tenant-a", "tenant-b")
REL = 1e-9

pflight_mod = importlib.import_module(
    "deeplearning4j_tpu_torch.observability.flight")


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


def _jax_tenant(jbase, seed):
    import jax.numpy as jnp

    tuned = JaxTL(jbase).add_lora(rank=2, alpha=4).build()
    rng = np.random.RandomState(seed)
    for lp in tuned.params_tree.values():
        for name in list(lp):
            if name.endswith((jax_lora.LORA_A, jax_lora.LORA_B)):
                lp[name] = jnp.asarray(rng.normal(
                    0.0, 0.5, lp[name].shape).astype(np.float32))
    return tuned


@pytest.fixture(scope="module")
def lm():
    """(jax base, {tenant: jax tenant net}, port base, {tenant: port
    delta tree})."""
    conf = jax_zoo.transformer_lm(vocab_size=V, t=T, d_model=D, n_heads=H,
                                  n_blocks=1, decode_cache_length=CAP)
    jbase = JaxGraph(conf).init()
    jten = {t: _jax_tenant(jbase, i + 1) for i, t in enumerate(TENANTS)}
    pbase = ComputationGraph(
        ComputationGraphConfiguration.from_json(conf.to_json()),
        device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jbase.params_tree)))
    pdelta = {t: interop.params_from_numpy(_np_tree(
        jax_lora.extract_adapter(n.params_tree))) for t, n in jten.items()}
    return jbase, jten, pbase, pdelta


def _tuned_net(tree, base):
    class _Net:
        params_tree = lora.merge_adapter(base.params_tree, tree)
    return _Net()


def _port_server(lm, **kw):
    _, _, pbase, pdelta = lm
    server = InferenceServer(pbase, device="cpu", max_batch_size=4,
                             decode_slots=2, kv_cache="paged",
                             kv_page_size=8, **kw)
    for t, tree in pdelta.items():
        server.load_adapter(t, net=_tuned_net(tree, pbase))
    return server


def _jax_server(lm, **kw):
    jbase, jten, _, _ = lm
    server = JaxServer(jbase, max_batch_size=4, decode_slots=2,
                       kv_cache="paged", kv_page_size=8, **kw)
    for t in TENANTS:
        server.load_adapter(t, net=jten[t])
    return server


def _post(url, route, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        url + route, json.dumps(payload).encode(),
        dict({"Content-Type": "application/json"}, **(headers or {})))
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, route):
    with urllib.request.urlopen(url + route, timeout=30) as r:
        return json.loads(r.read())


X = [[[t % 7] for t in range(16)]]
# (route, args, adapter): the same script for both packages.
SCRIPT = (
    ("generate", ([1, 2, 3], 6), None),
    ("generate", ([4, 5], 4), "tenant-a"),
    ("generate", ([1, 2, 3], 5), "tenant-b"),
    ("generate", ([1, 2, 3], 6), None),  # a prefix-cache hit
    ("predict", (X,), None),
    ("predict", (X * 3,), "tenant-a"),
    ("generate", ([2, 2], 3), "nope"),   # unknown adapter: invalid
    ("predict", (X,), "nope"),
)


def _run_script(server):
    for route, args, adapter in SCRIPT:
        try:
            if route == "generate":
                server.generate(*args, temperature=0.0, adapter=adapter)
            else:
                server.predict(*args, adapter=adapter)
        except Exception as e:
            assert adapter == "nope", e


def _dispatch_total(reg, model):
    fam = reg.get_family("dl4j_serving_dispatch_seconds_total")
    return sum(c.get() for c in fam.children()
               if c.labels["model"] == model)


TENANT_KEYS = ("model", "adapter", "requests", "tokens_in", "tokens_out",
               "outcomes")


def test_tenant_rows_equal_the_references_and_add_up(lm):
    obs.request_ledger.clear()
    jobs.request_ledger.clear()
    pserver, jserver = _port_server(lm), _jax_server(lm)
    p0 = _dispatch_total(obs.metrics, "default")
    try:
        _run_script(pserver)
        _run_script(jserver)
        got, want = pserver.tenant_snapshot(), jserver.tenant_snapshot()
    finally:
        pserver.stop()
        jserver.stop()
    assert [{k: r[k] for k in TENANT_KEYS} for r in got] == [
        {k: r[k] for k in TENANT_KEYS} for r in want]
    assert {r["adapter"] for r in got} == {"", "nope", *TENANTS}
    assert sum(r["requests"] for r in got) == len(SCRIPT)
    by = {r["adapter"]: r for r in got}
    assert by["tenant-a"]["hbm_bytes"] > 0
    assert 0 < by["tenant-a"]["hbm_share"] < 1
    assert by[""]["hbm_bytes"] is None
    spent = sum(r["device_seconds"] for r in got)
    total = _dispatch_total(obs.metrics, "default") - p0
    assert total > 0 and abs(spent - total) <= REL * total
    # The records: per-request marks, tokens and outcomes.
    recs = obs.request_ledger.snapshot()
    assert [r["outcome"] for r in recs].count("invalid") == 2
    gen = [r for r in recs if r["route"] == "generate"
           and r["outcome"] == "ok"]
    assert [r["tokens_out"] for r in gen] == [6, 4, 5, 6]
    assert [r["prefix_hit"] for r in gen] == [False, False, False, True]
    assert {"admitted", "first_token"} <= set(gen[0]["marks"])
    assert "prefill" in gen[0]["marks"] and "prefix_hit" in gen[3]["marks"]
    assert all(r["device_seconds"] > 0 for r in gen)


def test_a_decode_round_splits_evenly_across_its_slots(lm):
    """Concurrent requests on two adapter groups: the rounds' wall time,
    every group's dispatch in it, adds up over the records."""
    _, _, pbase, pdelta = lm
    sched = GenerationScheduler(pbase, model_name="split_lm", slots=2,
                                kv="paged", page_size=8)
    sched.adapter_params = lambda name: lora.merge_adapter(
        pbase.params_tree, pdelta[name])
    sched.start()
    d0 = _dispatch_total(obs.metrics, "split_lm")
    led = pledger_mod.RequestLedger(capacity=64, enabled=True,
                                    spool_path="")
    recs, errs = [], []

    def run(adapter, n):
        rec = led.open(route="generate", model="split_lm",
                       adapter=adapter or "", tokens_in=3)
        recs.append(rec)
        try:
            sched.generate([1, 2, 3], n, temperature=0.0, adapter=adapter,
                           ledger_rec=rec)
        except Exception as e:  # pragma: no cover - diagnostic
            errs.append(e)
        led.close(rec)

    try:
        ts = [threading.Thread(target=run, args=a)
              for a in (("tenant-a", 9), ("tenant-b", 6))]
        [t.start() for t in ts]
        [t.join() for t in ts]
    finally:
        sched.stop()
    assert not errs
    total = _dispatch_total(obs.metrics, "split_lm") - d0
    spent = sum(r["device_seconds"] for r in led.tenants())
    assert abs(spent - total) <= REL * total
    assert sched.stats["decode_dispatches"] > sched.stats["decode_steps"]


# ----------------------------------------------------------- trace context


def _spans(events, trace_id):
    return [e for e in events if e.get("args", {}).get("trace_id")
            == trace_id]


def test_trace_context_rides_http_and_the_serving_threads(lm):
    server = _port_server(lm)
    server.start()
    ref = _jax_server(lm)
    ref.start()
    try:
        names = []
        for srv in (server, ref):
            tid, sid = pprop.new_trace_id(), pprop.new_span_id()
            hdr = {pprop.TRACE_HEADER: f"00-{tid}-{sid}-01"}
            _post(srv.url, "/generate", {"prompt_ids": [3, 4, 5],
                                         "n_steps": 4, "temperature": 0.0,
                                         "adapter": "tenant-a"}, hdr)
            _post(srv.url, "/predict", {"data": X}, hdr)
            doc = _get(srv.url, "/api/trace")
            spans = _spans(doc["traceEvents"], tid)
            names.append({e["name"] for e in spans})
            if srv is server:
                port_spans, port_doc, port_ids = spans, doc, (tid, sid)
        pnames, jnames = names
    finally:
        server.stop()
        ref.stop()
    tid, sid = port_ids
    by = {}
    for e in port_spans:
        by.setdefault(e["name"], []).append(e["args"])
    gen, pred = by["replica.generate"][0], by["replica.predict"][0]
    assert gen["parent_span_id"] == pred["parent_span_id"] == sid
    assert by["serving.prefill"][0]["parent_span_id"] == gen["span_id"]
    assert by["serving.batch"][0]["parent_span_id"] == pred["span_id"]
    assert by["serving.decode_step"] and all(
        a["parent_span_id"] == gen["span_id"]
        for a in by["serving.decode_step"])
    assert jnames <= pnames and pnames - jnames <= {"serving.batch"}
    assert {"replica.generate", "replica.predict", "serving.prefill",
            "serving.queue_wait", "serving.device_dispatch",
            "serving.admission_wait"} <= jnames
    # The ledger's records carry the header's trace id.
    assert sum(r["trace_id"] == tid
               for r in obs.request_ledger.snapshot()) == 2
    # The incremental cursor.
    assert port_doc["seq"] >= len(port_doc["traceEvents"])


def test_api_trace_since_cursor(lm):
    server = _port_server(lm)
    server.start()
    try:
        first = _get(server.url, "/api/trace")
        server.predict(X)
        later = _get(server.url, f"/api/trace?since={first['seq']}")
        assert later["seq"] > first["seq"]
        assert len(later["traceEvents"]) == later["seq"] - first["seq"]
        assert {"epochUnixUs", "pid", "seq", "displayTimeUnit"} <= set(
            later)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.url, "/api/trace?since=x")
        assert e.value.code == 400
    finally:
        server.stop()


# ----------------------------------------------------------------- bundles


def test_flight_dump_route_is_rate_limited_and_carries_the_ledger(
        lm, tmp_path, monkeypatch):
    rec = obs.flight
    monkeypatch.setattr(rec, "dump_dir", str(tmp_path))
    monkeypatch.setattr(rec, "min_interval_s", 60.0)
    monkeypatch.setattr(rec, "_last_dump_at", {})
    server = _port_server(lm)
    server.start()
    try:
        server.generate([1, 2], 3, temperature=0.0)
        first = _post(server.url, "/admin/flight-dump", {"reason": "slo"})
        second = _post(server.url, "/admin/flight-dump", {"reason": "slo"})
        tenants = _get(server.url, "/v1/tenants")["tenants"]
    finally:
        server.stop()
    assert first["path"] is not None and second["path"] is None
    names = set(os.listdir(first["path"]))
    assert {"MANIFEST.json", "steps.jsonl", "trace.json", "metrics.json",
            "ledger.jsonl"} <= names
    with open(os.path.join(first["path"], "ledger.jsonl")) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    assert lines and lines[-1]["route"] == "generate"
    assert any(r["adapter"] == "" and r["requests"] >= 1 for r in tenants)
    assert pflight_mod.main([first["path"]]) == 0


def test_a_failing_batch_and_a_dying_loop_leave_bundles(
        lm, tmp_path, monkeypatch):
    rec = obs.flight
    monkeypatch.setattr(rec, "dump_dir", str(tmp_path))
    monkeypatch.setattr(rec, "min_interval_s", 0.0)
    _, _, pbase, _ = lm
    server = InferenceServer(device="cpu", max_batch_size=2)
    served = server.add_model("default", pbase, lm=False)

    def broken(*a, **kw):
        raise ArithmeticError("planted")

    monkeypatch.setattr(served.batcher, "_forward", broken)
    try:
        with pytest.raises(RuntimeError, match="planted"):
            server.predict(X)
    finally:
        server.stop()
    sched = GenerationScheduler(pbase, model_name="dying", slots=2)
    monkeypatch.setattr(sched, "_decode_round",
                        lambda active: (_ for _ in ()).throw(
                            ArithmeticError("planted decode")))
    sched.start()
    with pytest.raises(RuntimeError, match="planted decode"):
        sched.generate([1, 2], 4, temperature=0.0, timeout_s=30)
    sched._thread.join(timeout=10)
    reasons = sorted(json.load(open(os.path.join(b, "MANIFEST.json")))[
        "reason"] for b in rec.status()["dumps"]
        if b.startswith(str(tmp_path)))
    assert reasons == ["crash:serving.batch", "crash:serving.decode_loop"]


# --------------------------------------------------------------------- SLO


def test_burn_rate_pages_below_the_measured_ttft_and_not_above(lm):
    server = _port_server(lm)
    server.start()
    try:
        first = urllib.request.urlopen(server.url + "/metrics",
                                       timeout=30).read().decode()
        for a in (None,) + TENANTS:
            server.generate([1, 2, 3], 4, temperature=0.0, adapter=a)
        second = urllib.request.urlopen(server.url + "/metrics",
                                        timeout=30).read().decode()
        ttft = min(server.get(None).scheduler.ttft_s)
    finally:
        server.stop()
    assert ttft > 0.001
    docs, pages = [], []
    for mod in (pslo, jslo):
        objectives = [
            mod.Objective("ttft_tight", "latency",
                          "dl4j_serving_ttft_seconds", target=0.99,
                          threshold_s=0.001, labels={"model": "default"}),
            mod.Objective("ttft_loose", "latency",
                          "dl4j_serving_ttft_seconds", target=0.99,
                          threshold_s=600.0, labels={"model": "default"})]
        paged = []
        eng = mod.BurnRateEngine(objectives, window_scale=1 / 300,
                                 on_page=lambda n, w, p=paged: p.append(n))
        eng.ingest(first, now=0.0)
        docs.append(eng.report(second, now=1.0))
        pages.append(paged)
    assert docs[0] == docs[1]
    assert pages[0] == pages[1] == ["ttft_tight"]
    sev = {o["name"]: o["severity"] for o in docs[0]["objectives"]}
    assert sev == {"ttft_tight": "page", "ttft_loose": "ok"}


# ------------------------------------------------------------------ memory


def test_hosted_nets_are_attributed_and_estimated_on_the_cpu(lm):
    server = _port_server(lm)
    server.start()
    try:
        server.predict(X)
        rows = _get(server.url, "/v1/models")["models"]
        report = pmem.live_buffer_report()
    finally:
        server.stop()
    assert rows[0]["hbm_source"] == "estimated"  # no card, no measurement
    net = server.get(None).net
    got = report["models"]["default"]
    assert got["bytes"] == pmem.leaf_bytes(net)
    assert sum(v for g, v in got["groups"].items()
               if g.startswith("params_tree/")) == sum(
        t.numel() * t.element_size() for p in net.params_tree.values()
        for t in p.values())


class _Fake:
    """A stand-in engine: one param tensor of `n` f32 elements."""

    def __init__(self, n):
        import torch

        self.params_tree = {"layer_0": {"W": torch.zeros(n)}}
        self.state = {}
        self.opt_state = None


def test_the_host_budgets_on_measured_bytes(monkeypatch):
    """Where a model's footprint is measured (on the card: leaves plus the
    largest transient of its warmup), the budget counts it; the
    transient is kept through an eviction, so a reload is measured too."""
    measured = {}
    monkeypatch.setattr(
        pmem, "measured_model_bytes",
        lambda net, transient=None: (None if transient is None else
                                     pmem.leaf_bytes(net) + transient))
    monkeypatch.setattr(pmem, "largest_transient",
                        lambda net: measured.get(id(net)))
    host = ModelHost()
    a, b = _Fake(1000), _Fake(1000)
    # Paths make them evictable (nothing reloads them in this test).
    ma = host.add("a", a, path="/nonexistent/a")
    assert (ma.hbm_source, ma.hbm_bytes) == ("estimated", 4000)
    measured[id(a)] = 6000
    host_mod._measure_hbm(ma)
    assert (ma.hbm_source, ma.hbm_bytes) == ("measured", 10000)
    assert ma.row()["hbm_source"] == "measured"
    mb = host.add("b", b, path="/nonexistent/b")
    host.set_budget(12000)  # the estimates (8,000) fit, the measured not
    assert not ma.resident and mb.resident
    assert ma.hbm_source == "estimated" and ma.transient_bytes == 6000
    ma.net = a  # as a reload publishes it: measured again at once
    host_mod._measure_hbm(ma)
    assert (ma.hbm_source, ma.hbm_bytes) == ("measured", 10000)


def test_eviction_unregisters_the_net(lm, tmp_path):
    from deeplearning4j_tpu_torch.util import model_serializer

    _, _, pbase, _ = lm
    path = str(tmp_path / "lm.zip")
    model_serializer.save_model(pbase, path)
    host = ModelHost(device="cpu")
    host.add("evictable", model_serializer.load_model(path, device="cpu"),
             path=path)
    assert "evictable" in pmem.live_buffer_report()["models"]
    host.add("other", pbase)
    host.set_budget(1)
    assert "evictable" not in pmem.live_buffer_report()["models"]
    host.get("evictable")  # reloaded: registered again
    assert "evictable" in pmem.live_buffer_report()["models"]
    host.stop()


# ---------------------------------------------------------------- KV pool


def test_cow_counts_equal_the_references():
    pools = [kv_pool.KVPagePool(3, 32, 4), jax_kv_pool.KVPagePool(3, 32, 4)]
    caches = [kv_pool.PrefixCache(pools[0]), jax_kv_pool.PrefixCache(
        pools[1])]
    for pool, cache in zip(pools, caches):
        pages = pool.install_slot(0, 10)
        cache.admit(list(range(10)), pages, 10, None)
        pool.install_shared(1, pages, 10)
        pool.install_shared(2, pages, 10)
    for t in (1, 3, 1, 4):
        got = pools[0].plan_appends(t)
        want = pools[1].plan_appends(t)
        assert got == want
        assert [pools[0].cow_count(s) for s in range(3)] == [
            pools[1].cow_count(s) for s in range(3)]
    assert pools[0].cow_count(1) > 0
    pools[0].free_slot(1)
    assert pools[0].cow_count(1) == 0


# ------------------------------------------------------------ ledger units


def _both(**kw):
    return (pledger_mod.RequestLedger(**kw),
            jledger_mod.RequestLedger(**kw))


@pytest.mark.parametrize("capacity,closes", [(16, 5), (16, 40), (32, 33)])
def test_ring_and_rollups_equal_the_references(capacity, closes):
    docs = []
    for led in _both(capacity=capacity, enabled=True, spool_path="",
                     sample=1.0):
        for i in range(closes):
            rec = led.open(route="predict" if i % 3 else "generate",
                           model="unit", adapter=("a", "")[i % 2],
                           trace_id=f"{i:032x}", tokens_in=i)
            rec.add_tokens_out(i % 4)
            rec.add_device_seconds(0.125 * (i % 3))
            rec.add_speculative(i % 2, 1)
            rec.add_cow_copies(i % 5)
            led.close(rec, outcome=("ok", "shed", "timeout")[i % 3])
        snap = [{k: v for k, v in d.items()
                 if k not in ("t_wall", "marks", "duration_s")}
                for d in led.snapshot()]
        docs.append((snap, led.tenants(), {
            k: v for k, v in led.status().items()}))
    assert docs[0] == docs[1]


@pytest.mark.parametrize("sample,want", [(1.0, 6), (0.5, 3), (0.01, 0),
                                         (0.0, 0)])
def test_spool_sampling_equals_the_references(tmp_path, sample, want):
    counts = []
    for i, cls in enumerate((pledger_mod.RequestLedger,
                             jledger_mod.RequestLedger)):
        led = cls(capacity=64, enabled=True, sample=sample,
                  spool_path=str(tmp_path / f"s{i}" / "spool.jsonl"))
        for j in range(6):
            led.close(led.open(route="generate", model="m", tokens_in=j))
        path = led.spool_path
        counts.append(len(open(path).read().splitlines())
                      if os.path.exists(path) else 0)
    assert counts == [want, want]


def test_disabled_ledger_hands_out_the_noop():
    led = pledger_mod.RequestLedger(enabled=False)
    rec = led.open(route="predict", model="m")
    assert rec is pledger_mod.NOOP_RECORD
    rec.mark("x")
    rec.add_device_seconds(1.0)
    led.close(rec)
    assert led.snapshot() == [] and led.tenants() == []
    assert led.status()["enabled"] is False


def test_accounting_families_declared_as_the_references():
    for name in port_metrics.ACCOUNTING_FAMILIES:
        port = obs.metrics.get_family(name)
        ref = jobs.metrics.get_family(name)
        assert port is not None and ref is not None, name
        assert (port.kind, port.label_names, port.help) == (
            ref.kind, ref.label_names, ref.help), name
