"""The port's serving slice as a whole against the JAX package, on the CPU.

A small `transformer_lm` is built in JAX, carried over through `to_json()`
-> the port's `from_json` and `interop.params_from_numpy`, and both
packages are held to each other: `output` (f32 1e-5; bf16 4e-2),
`generate_lm` ids, and the port's HTTP server (paged and dense KV,
continuous batching, a prefix-cache hit, a seeded sample) against JAX
`generate_lm(use_cache=True)`. Also the copied KV-pool bookkeeping against
the reference's, op for op, and the port's own init."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import kv_pool as jax_kv_pool
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.models import kv_pool, zoo
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.serving import InferenceServer

V, T, D, H, NB, CAP = 64, 16, 32, 4, 2, 64
PROMPT_A = [3, 14, 15, 9, 2]
PROMPT_B = [27, 18, 28, 1, 8]
STEPS = 8


def _jax_net(dtype):
    conf = jax_zoo.transformer_lm(V, t=T, d_model=D, n_heads=H, n_blocks=NB,
                                  decode_cache_length=CAP, dtype=dtype)
    return JaxGraph(conf).init()


def _port_net(jnet):
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    tree = {v: {k: np.asarray(a) for k, a in p.items()}
            for v, p in jnet.params_tree.items()}
    return ComputationGraph(conf, device="cpu").init(
        params=interop.params_from_numpy(tree))


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_net("float32")
    return jnet, _port_net(jnet)


@pytest.fixture(scope="module")
def jax_ids(nets):
    """JAX generate_lm(use_cache=True): greedy on A, seeded sample on B."""
    jnet, _ = nets
    return {
        "greedy": jax_zoo.generate_lm(jnet, PROMPT_A, STEPS, window=T,
                                      use_cache=True, temperature=0.0),
        "sampled": jax_zoo.generate_lm(jnet, PROMPT_B, STEPS, window=T,
                                       use_cache=True, temperature=0.8,
                                       seed=7),
    }


def test_port_builder_matches_reference_json():
    jconf = jax_zoo.transformer_lm(V, t=T, d_model=D, n_heads=H, n_blocks=NB,
                                   decode_cache_length=CAP, dtype="bfloat16")
    read = ComputationGraphConfiguration.from_json(jconf.to_json())
    built = zoo.transformer_lm(V, t=T, d_model=D, n_heads=H, n_blocks=NB,
                               decode_cache_length=CAP, dtype="bfloat16")
    assert built.vertices == read.vertices
    assert built.vertex_inputs == read.vertex_inputs
    assert built.topological_order() == list(
        JaxGraph(jconf).topo_order)
    assert ComputationGraph(built, device="cpu").dtype_policy.name \
        == "mixed_bfloat16"


def test_output_matches_jax(nets):
    jnet, pnet = nets
    x = np.random.RandomState(0).randint(0, V, (2, T, 1)).astype(np.float32)
    want = jnet.output(x)[0]
    got = pnet.output(x)[0]
    assert got.shape == (2, T, V)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_generate_lm_matches_jax(nets, jax_ids):
    _, pnet = nets
    got = zoo.generate_lm(pnet, PROMPT_A, STEPS, window=T, use_cache=True,
                          temperature=0.0)
    assert got == jax_ids["greedy"]
    # The windowed (no-cache) path decodes the same greedy ids.
    assert zoo.generate_lm(pnet, PROMPT_A, STEPS, window=T,
                           temperature=0.0) == got


def _post(url, body):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["ids"]


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_http_server_matches_jax_generate(nets, jax_ids, kv):
    _, pnet = nets
    server = InferenceServer(pnet, device="cpu", kv_cache=kv,
                             kv_page_size=8, decode_slots=2)
    assert not server.wait_ready(timeout=0)
    server.start()
    try:
        assert server.wait_ready(timeout=0)
        sched = server.get(None).scheduler
        kernels.reset_counts()
        bodies = [
            {"prompt_ids": PROMPT_A, "n_steps": STEPS, "temperature": 0},
            {"prompt_ids": PROMPT_B, "n_steps": STEPS, "temperature": 0.8,
             "seed": 7},
            {"prompt_ids": PROMPT_A, "n_steps": STEPS, "temperature": 0},
        ]
        results, errors = {}, []

        def send(i):
            try:
                results[i] = _post(server.url, bodies[i])
            except Exception as e:  # surfaced by the assert below
                errors.append(repr(e))

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errors and len(results) == 3
        assert results[0] == jax_ids["greedy"]
        assert results[2] == jax_ids["greedy"]
        assert results[1] == jax_ids["sampled"]
        stats = dict(sched.stats)
        if kv == "paged":
            # One of the two identical prompts prefilled, the other hit.
            assert stats["prefills"] == 2 and stats["prefix_hits"] == 1
            assert sched.prefix_cache.hits == 1
        else:
            assert stats["prefills"] == 3 and stats["prefix_hits"] == 0
        # Every forward went through the wrappers: prefill 2*NB+1 norms and
        # NB attentions; each decode step 2*NB+1 norms and NB attentions.
        plain = kernels.counts()["plain_calls"]
        assert plain["layernorm_norm_act"] == (2 * NB + 1) * (
            stats["prefills"] + stats["decode_steps"])
        assert plain["flash_attention"] == NB * stats["prefills"]
        assert plain["paged_decode_attention"] == (
            NB * stats["decode_steps"] if kv == "paged" else 0)
        with urllib.request.urlopen(server.url + "/v1/models") as r:
            row = json.loads(r.read())["models"][0]
        assert row["kv_cache"] == kv and row["device"] == "cpu"
        with urllib.request.urlopen(server.url + "/healthz") as r:
            assert json.loads(r.read())["status"] == "ready"
    finally:
        server.stop()


def test_http_server_rejects_bad_requests(nets):
    _, pnet = nets
    server = InferenceServer(pnet, device="cpu", kv_cache="paged",
                             kv_page_size=8, decode_slots=2).start()
    try:
        for body, code in (({"prompt_ids": [V], "n_steps": 2}, 400),
                           ({"prompt_ids": [1.5], "n_steps": 2}, 400),
                           ({"prompt_ids": [1] * CAP, "n_steps": 2}, 400),
                           ({"prompt_ids": [1], "n_steps": 2,
                             "model": "nope"}, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.url, body)
            assert e.value.code == code
    finally:
        server.stop()


def test_timed_out_request_frees_its_slot(nets, jax_ids):
    _, pnet = nets
    server = InferenceServer(pnet, device="cpu", kv_cache="paged",
                             kv_page_size=8, decode_slots=1).start()
    try:
        with pytest.raises(TimeoutError):
            server.generate(PROMPT_B, STEPS, timeout_s=0.0)
        # The cancelled request is dropped at a step boundary; the one slot
        # then serves the next request, unharmed.
        assert server.generate(PROMPT_A, STEPS, temperature=0.0) \
            == jax_ids["greedy"]
    finally:
        server.stop()


def test_bf16_output_matches_jax():
    jnet = _jax_net("bfloat16")
    pnet = _port_net(jnet)
    assert pnet._compute_params["attn0"]["Wq"].dtype == torch.bfloat16
    x = np.random.RandomState(1).randint(0, V, (2, T, 1)).astype(np.float32)
    want = jnet.output(x)[0]
    got = pnet.output(x)[0]
    assert got.dtype == np.float32  # mixed_bfloat16 outputs f32
    np.testing.assert_allclose(got, want, rtol=4e-2, atol=4e-2)


def test_kv_pool_bookkeeping_matches_reference():
    rng = np.random.RandomState(0)
    slots, cap, page = 3, 32, 4
    pools = [jax_kv_pool.KVPagePool(slots, cap, page, pages=14),
             kv_pool.KVPagePool(slots, cap, page, pages=14)]
    caches = [jax_kv_pool.PrefixCache(pools[0], max_entries=3),
              kv_pool.PrefixCache(pools[1], max_entries=3)]
    for p, c in zip(pools, caches):
        p.reclaim = c.evict_one
    for _ in range(300):
        op, slot = rng.randint(4), rng.randint(slots)
        prompt = tuple(rng.randint(0, 3, rng.randint(1, 3)))
        outcomes = []
        for p, c in zip(pools, caches):
            try:
                if op == 0:
                    n = int(rng.randint(1, cap // 2)) if p is pools[0] else n
                    p.install_slot(slot, n)
                    c.admit(prompt, p.pages_of(slot), n, np.zeros(2))
                    out = p.pages_of(slot)
                elif op == 1:
                    hit = c.get(prompt)
                    if hit is not None:
                        p.install_shared(slot, hit[0], hit[1])
                    out = None if hit is None else hit[:2]
                elif op == 2:
                    out = p.plan_appends(1)
                else:
                    out = p.free_slot(slot)
            except Exception as e:  # both pools must fail alike
                out = type(e).__name__
            outcomes.append(out)
            if op == 2 and p.table.max() >= p.num_pages:
                raise AssertionError("table points past the pool")
        assert outcomes[0] == outcomes[1]
        assert np.array_equal(pools[0].table, pools[1].table)
        assert pools[0].free_count == pools[1].free_count


def test_init_is_seeded_xavier():
    conf = zoo.transformer_lm(V, d_model=64, n_heads=4, n_blocks=1,
                              decode_cache_length=CAP, seed=5)
    a = ComputationGraph(conf, device="cpu").init().params_tree
    b = ComputationGraph(conf, device="cpu").init().params_tree
    assert all(torch.equal(a[v][k], b[v][k]) for v in a for k in a[v])
    w = a["ff1_0"]["W"]                                   # [64, 256]
    assert abs(float(w.std()) / (2.0 / (64 + 256)) ** 0.5 - 1) < 0.05
    assert abs(float(w.mean())) < 0.01
    assert torch.equal(a["ln_a0"]["gamma"], torch.ones(64))
    assert torch.equal(a["ln_a0"]["beta"], torch.zeros(64))
    assert torch.equal(a["attn0"]["qB"], torch.zeros(64))
    conf.global_conf.seed = 6
    c = ComputationGraph(conf, device="cpu").init().params_tree
    assert not torch.equal(a["ff1_0"]["W"], c["ff1_0"]["W"])
