"""LoRA adapters on the port's serving tier and multi-model hosting under a
memory budget (`serving/host.py`, `server.load_adapter`, `adapter=`), on
the CPU, against the JAX package where it serves the same thing (the
reference's `tests/test_transfer_lora.py:222-326` at its sizes: V=17,
t=16, d=32, 2 heads, 1 block, a decode cache of 32, pages of 8 or 4).

- Two tenants over one resident base, over HTTP: `/predict` equals the
  reference's `output(params=merged)` (F32: rtol 1e-5, atol 1e-6), greedy
  `/generate` ids equal the reference server's (exact), tenants differ
  from each other and from the base, an unknown adapter is a 400 on both
  routes, `/v1/models` lists each adapter with its leaves' bytes beside
  the base's estimated `hbm_bytes` (the reference's 10% bound on their
  share is held at the LM's full width on the card, by `chip_smoke.py`:
  here rank-2 factors of 17- and 32-wide tables are a fifth of a model
  this small).
- Mixed-adapter decode rounds on the paged pool equal each request run
  alone, through rounds where a slot's cursor sits at a page boundary,
  and the pool's free pages come back to their start.
- The prefix cache keeps entries per adapter; a draft refuses adapters;
  the hosting and adapter metric families are declared as the
  reference's and counted.
- `ModelHost`: LRU eviction and reload under a tiny budget, answers bit
  for bit those before eviction, 503 to callers while a reload runs, a
  failed reload rolled back.
"""

import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu import observability as jax_obs
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn import lora as jax_lora
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.transfer import TransferLearning as JaxTL
from deeplearning4j_tpu.serving import InferenceServer as JaxServer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import observability as obs
from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager
from deeplearning4j_tpu_torch.checkpoint import adapters, store
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import lora
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.transfer import TransferLearning
from deeplearning4j_tpu_torch.serving import (
    InferenceServer,
    InputValidationError,
    ModelNotReadyError,
)
from deeplearning4j_tpu_torch.serving import metrics as port_metrics
from deeplearning4j_tpu_torch.serving.host import ModelHost
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationRequest,
    GenerationScheduler,
)
from deeplearning4j_tpu_torch.util import model_serializer

V, T, D, H, CAP = 17, 16, 32, 2, 32
F32 = dict(rtol=1e-5, atol=1e-6)
TENANTS = ("tenant-a", "tenant-b")


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
    """A strongly distinct tenant, as the reference's test makes one: the
    public TransferLearning path, the factors overwritten by a seeded
    draw."""
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


def _post(url, route, payload, timeout=60):
    req = urllib.request.Request(url + route, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


# ------------------------------------------------------------------ HTTP

def _tuned_net(tree, base):
    """A stand-in fine-tuned net for `load_adapter(net=...)`: the base's
    params with a tenant's delta laid over them."""
    class _Net:
        params_tree = lora.merge_adapter(base.params_tree, tree)
    return _Net()


def test_two_tenants_over_one_base_over_http(lm):
    jbase, jten, pbase, pdelta = lm
    server = InferenceServer(pbase, device="cpu", warmup=True,
                             max_batch_size=4, decode_slots=2,
                             kv_cache="paged", kv_page_size=8)
    for t, tree in pdelta.items():
        server.load_adapter(t, net=_tuned_net(tree, pbase))
    server.start()
    try:
        assert server.wait_ready(600)
        assert server.get(None).scheduler.stepper.params_override is None
        url = server.url
        x = [[[t % 7] for t in range(16)]]
        p = {a: np.asarray(_post(url, "/predict", {"data": x, "adapter": a}
                                 if a else {"data": x})["predictions"])
             for a in (None,) + TENANTS}
        xa = np.asarray(x, np.int32)
        for t in TENANTS:
            merged = jax_lora.merge_adapter(
                jbase.params_tree,
                jax_lora.extract_adapter(jten[t].params_tree))
            np.testing.assert_allclose(
                p[t], np.asarray(jbase.output(xa, params=merged)[0]), **F32)
        np.testing.assert_allclose(p[None], np.asarray(jbase.output(xa)[0]),
                                   **F32)
        assert not np.allclose(p["tenant-a"], p["tenant-b"])
        assert not np.allclose(p["tenant-a"], p[None])

        gen = {a: _post(url, "/generate",
                        dict({"prompt_ids": [1, 2, 3], "n_steps": 6,
                              "temperature": 0.0},
                             **({"adapter": a} if a else {})))["ids"]
               for a in (None,) + TENANTS}
        ref = JaxServer(jbase, max_batch_size=4, decode_slots=2,
                        kv_cache="paged", kv_page_size=8)
        try:
            for t in TENANTS:
                ref.load_adapter(t, net=jten[t])
            want = {a: ref.generate([1, 2, 3], 6, temperature=0.0,
                                    adapter=a)
                    for a in (None,) + TENANTS}
        finally:
            ref.stop()
        assert gen == want
        assert gen["tenant-a"] != gen["tenant-b"] != gen[None]

        res, errs = {}, []

        def run(a):
            try:
                res[a] = _post(url, "/generate",
                               {"prompt_ids": [1, 2, 3], "n_steps": 6,
                                "temperature": 0.0, "adapter": a})["ids"]
            except Exception as e:  # pragma: no cover - diagnostic
                errs.append(e)

        ts = [threading.Thread(target=run, args=(a,)) for a in TENANTS]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert not errs and res == {t: gen[t] for t in TENANTS}

        with urllib.request.urlopen(url + "/v1/models", timeout=30) as r:
            row = json.loads(r.read())["models"][0]
        assert {a["name"] for a in row["adapters"]} == set(TENANTS)
        for a in row["adapters"]:
            assert a["rank"] == 2 and a["bytes"] > 0 and a["pinned"]
        assert [a["bytes"] for a in row["adapters"]] == [
            sum(4 * t.numel() for leaves in pdelta[n].values()
                for t in leaves.values()) for n in TENANTS]
        assert row["hbm_bytes"] == sum(
            4 * t.numel() for p in pbase.params_tree.values()
            for t in p.values())
        assert row["resident"] and row["hbm_source"] == "estimated"

        for route, payload in (("/predict", {"data": x}),
                               ("/generate", {"prompt_ids": [1],
                                              "n_steps": 1})):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, route, dict(payload, adapter="nope"))
            assert ei.value.code == 400
            assert "no adapter 'nope'" in json.loads(
                ei.value.read())["error"]
    finally:
        server.stop()


def test_load_adapter_from_a_checkpoint_and_refusals(lm, tmp_path):
    jbase, jten, pbase, pdelta = lm
    path = str(tmp_path / "tenant-a")
    from deeplearning4j_tpu.checkpoint import adapters as jax_adapters
    jax_adapters.save_adapter(jten["tenant-a"], path, name="tenant-a")
    server = InferenceServer(pbase, device="cpu", kv_cache="paged",
                             kv_page_size=8)
    try:
        entry = server.load_adapter("a", path=path)
        for lk, leaves in pdelta["tenant-a"].items():
            for k, t in leaves.items():
                assert torch.equal(entry["tree"][lk][k], t)
        other = ComputationGraph(pbase.conf, device="cpu").init()
        server.add_model("other", other)
        from deeplearning4j_tpu_torch.checkpoint import CheckpointError
        with pytest.raises(CheckpointError, match="refusing"):
            server.load_adapter("a", path=path, model="other")
        with pytest.raises(ValueError, match="exactly one"):
            server.load_adapter("b")
        with pytest.raises(ValueError, match="no LoRA adapter leaves"):
            server.load_adapter("b", net=pbase)
    finally:
        server.stop()


# ------------------------------------------------------- mixed decode

@pytest.mark.parametrize("prefix_cache", [False, True])
def test_mixed_adapter_rounds_equal_sequential_runs(lm, prefix_cache):
    """Four slots on three trees (the base and two tenants), admitted
    together so every round is mixed; prompts of 3 to 8 tokens and 9 new
    tokens each, so over pages of 4 every slot's cursor sits at a page
    boundary in some round while the other groups dispatch."""
    _, _, pbase, pdelta = lm
    prompts = [([1, 2, 3], None), ([4, 5, 6, 7], "tenant-a"),
               ([2, 3, 4, 5, 6], "tenant-b"), ([7, 8, 1, 2, 3, 4, 5, 6],
                                               "tenant-a")]
    trees = {t: lora.merge_adapter(pbase.params_tree, d)
             for t, d in pdelta.items()}

    def scheduler():
        s = GenerationScheduler(pbase, slots=4, kv="paged", page_size=4,
                                prefix_cache=prefix_cache)
        s.adapter_params = trees.__getitem__
        s.adapter_names = lambda: sorted(trees)
        return s

    sched = scheduler()
    free0 = sched.stepper.pool.counts()["free"]
    reqs = [GenerationRequest(p, 9, temperature=0.0, adapter=a)
            for p, a in prompts]
    for r in reqs:
        sched.submit(r)
    sched.start()
    try:
        for r in reqs:
            assert r.event.wait(120) and r.error is None
    finally:
        sched.stop()
    assert sched.stats["decode_dispatches"] > sched.stats["decode_steps"]
    assert sched.stats["decode_dispatches"] <= 3 * sched.stats[
        "decode_steps"]
    if sched.prefix_cache is not None:
        sched.prefix_cache.clear()
    assert sched.stepper.pool.counts()["free"] == free0
    for (p, a), r in zip(prompts, reqs):
        alone = scheduler().start()
        try:
            want = alone.generate(p, 9, temperature=0.0, adapter=a,
                                  timeout_s=120)
        finally:
            alone.stop()
        assert r.ids == want, (p, a)


def test_prefix_entries_are_kept_per_adapter(lm):
    _, _, pbase, pdelta = lm
    server = InferenceServer(pbase, device="cpu", kv_cache="paged",
                             kv_page_size=8, decode_slots=2)
    try:
        for t, tree in pdelta.items():
            server.get(None).add_adapter(t, tree)
        sched = server.get(None).scheduler
        runs = [(a, server.generate([3, 4, 5, 6], 4, temperature=0.0,
                                    adapter=a))
                for a in ("tenant-a", "tenant-b", None, "tenant-a")]
        assert sched.stats["prefix_hits"] == 1  # tenant-a's second run
        assert sched.stats["prefills"] == 3
        assert runs[3][1] == runs[0][1] and runs[0][1] != runs[1][1]
        keys = {k[0] for k in sched.prefix_cache._entries}
        assert keys == {"tenant-a", "tenant-b", None}
    finally:
        server.stop()


def test_adapters_with_a_draft_are_refused(lm):
    _, _, pbase, pdelta = lm
    draft = ComputationGraph(pbase.conf, device="cpu").init()
    server = InferenceServer(pbase, device="cpu", decode_slots=2,
                             draft=draft, spec_k=2)
    try:
        server.get(None).add_adapter("t", pdelta["tenant-a"])
        with pytest.raises(InputValidationError, match="draft"):
            server.generate([1, 2], 2, adapter="t")
        with pytest.raises(InputValidationError, match="no adapter"):
            server.predict(np.array([[1, 2]]), adapter="nope")
    finally:
        server.stop()


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("name", port_metrics.HOSTING_FAMILIES)
def test_hosting_family_declared_as_the_reference(name):
    port, ref = (reg.get_family(name) for reg in (obs.metrics,
                                                  jax_obs.metrics))
    assert ref is not None and port is not None
    assert (port.kind, port.label_names, port.help, port._buckets) == (
        ref.kind, ref.label_names, ref.help, ref._buckets)


def _sample(name, **labels):
    fam = obs.metrics.get_family(name)
    return sum(c.get() for c in fam.children() if c.labels == labels)


def test_adapter_metrics_count(lm):
    _, _, pbase, pdelta = lm
    server = InferenceServer(device="cpu", max_batch_size=2)
    server.add_model("metered", pbase, lm=False)
    try:
        for t, tree in pdelta.items():
            server.get("metered").add_adapter(t, tree)
        assert _sample("dl4j_adapters_resident", model="metered") == 2
        ok0 = _sample("dl4j_adapter_requests_total", model="metered",
                      adapter="tenant-a", outcome="ok")
        bad0 = _sample("dl4j_adapter_requests_total", model="metered",
                       adapter="nope", outcome="failed")
        x = np.array([[1, 2, 3]])
        for _ in range(2):
            server.predict(x, model="metered", adapter="tenant-a")
        with pytest.raises(InputValidationError):
            server.predict(x, model="metered", adapter="nope")
        assert _sample("dl4j_adapter_requests_total", model="metered",
                       adapter="tenant-a", outcome="ok") == ok0 + 2
        assert _sample("dl4j_adapter_requests_total", model="metered",
                       adapter="nope", outcome="failed") == bad0 + 1
        scrape = obs.metrics.to_prometheus()
        for name in ("dl4j_serving_model_hbm_bytes",
                     "dl4j_serving_models_resident", "dl4j_adapters_resident",
                     "dl4j_adapter_requests_total"):
            assert f"# TYPE {name} " in scrape, name
    finally:
        server.stop()


# ---------------------------------------------------------------- hosting

@pytest.fixture
def disk_models(lm, tmp_path):
    """The base LM from a zip, a sharded step and a manager root."""
    _, _, pbase, _ = lm
    paths = {"zip": str(tmp_path / "lm.zip"),
             "sharded": str(tmp_path / "step"),
             "root": str(tmp_path / "root")}
    model_serializer.save_model(pbase, paths["zip"])
    store.save_checkpoint(pbase, paths["sharded"])
    CheckpointManager(paths["root"], async_save=False, device="cpu").save(
        pbase)
    return paths


def _resident(server):
    return {r["name"]: r["resident"] for r in server.snapshot()}


def test_host_evicts_lru_and_reloads_bit_for_bit(lm, disk_models):
    _, _, pbase, pdelta = lm
    one = sum(t.numel() * t.element_size()
              for p in pbase.params_tree.values() for t in p.values())
    server = InferenceServer(device="cpu", max_batch_size=2,
                             kv_cache="paged", kv_page_size=8,
                             hbm_budget_bytes=2 * one + 1)
    ev0 = {n: _sample("dl4j_serving_evictions_total", model=n)
           for n in disk_models}
    x = np.array([[1, 2, 3, 4]])
    try:
        for name, path in disk_models.items():
            server.add_model(name, path=path)
        # Three models, room for two: the first added went.
        assert _resident(server) == {"zip": False, "sharded": True,
                                     "root": True}
        row = {r["name"]: r for r in server.snapshot()}["zip"]
        assert row["status"] == "evicted" and row["hbm_bytes"] == (
            os.path.getsize(disk_models["zip"]))
        server.get("root").add_adapter("t", pdelta["tenant-a"])
        before = {n: server.predict(x, model=n)
                  for n in ("sharded", "root")}
        tenant = server.predict(x, model="root", adapter="t")
        # "sharded" was used longest ago once "root" answered: it goes
        # when "zip" comes back.
        got_zip = server.predict(x, model="zip")
        assert _resident(server) == {"zip": True, "sharded": False,
                                     "root": True}
        np.testing.assert_array_equal(got_zip, before["root"])
        server.predict(x, model="zip")
        np.testing.assert_array_equal(server.predict(x, model="sharded"),
                                      before["sharded"])
        assert _resident(server) == {"zip": True, "sharded": True,
                                     "root": False}
        # An adapter survives its base's eviction and merges again.
        np.testing.assert_array_equal(
            server.predict(x, model="root", adapter="t"), tenant)
        assert server.generate([1, 2, 3], 4, model="root", temperature=0,
                               adapter="t") == server.generate(
            [1, 2, 3], 4, model="root", temperature=0, adapter="t")
        ev = {n: _sample("dl4j_serving_evictions_total", model=n) - ev0[n]
              for n in disk_models}
        # zip went twice (at the third add, and for "root"'s reload).
        assert ev == {"zip": 2, "sharded": 1, "root": 1}
        assert _resident(server) == {"zip": False, "sharded": True,
                                     "root": True}
        assert all(m.net is None or m.net.device.type == "cpu"
                   for m in server.models.models())
    finally:
        server.stop()


def test_host_pins_live_nets_and_serves_one_over_budget(lm, disk_models):
    _, _, pbase, _ = lm
    server = InferenceServer(pbase, device="cpu", max_batch_size=2,
                             hbm_budget_bytes=1)
    try:
        server.add_model("zip", path=disk_models["zip"])
        # The live default is pinned; the checkpoint model just loaded is
        # kept (a budget below one model still serves it).
        assert _resident(server) == {"default": True, "zip": True}
        server.add_model("sharded", path=disk_models["sharded"])
        assert _resident(server) == {"default": True, "zip": False,
                                     "sharded": True}
        assert [r["pinned"] for r in server.snapshot()] == [True, False,
                                                            False]
    finally:
        server.stop()


def test_reload_answers_503_while_loading_and_rolls_back(lm, disk_models,
                                                         tmp_path):
    _, _, pbase, _ = lm
    path = str(tmp_path / "moving.zip")
    shutil.copy(disk_models["zip"], path)
    host = ModelHost(hbm_budget_bytes=1, device="cpu")
    a = host.add("a", net=pbase, path=path)
    host.add("b", net=pbase, path=disk_models["sharded"])
    assert not a.resident
    a.loading = True
    with pytest.raises(ModelNotReadyError, match="reloading"):
        host.get("a")
    a.loading = False
    os.remove(path)
    from deeplearning4j_tpu_torch.util.retry import RetryError
    with pytest.raises((RetryError, OSError, ValueError, RuntimeError)):
        host.get("a")
    assert not a.resident and not a.loading
    shutil.copy(disk_models["zip"], path)
    assert host.get("a").resident
    assert {m.name: m.resident for m in host.models()} == {"a": True,
                                                           "b": False}
    host.stop()
