#!/usr/bin/env python3
"""Prove on one NVIDIA GPU that the PyTorch/CUDA port starts and is right.

    python3 chip_smoke.py

Phases, each printing one JSON line that carries the card's name and power
limit (as `nvidia-smi --query-gpu=name,power.limit` reports them):

1. build    - nvcc builds every kernel of `deeplearning4j_tpu_torch/kernels/
              csrc` for sm_90a (one nvcc per source, all at once).
2. kernels  - each hand-written kernel at its main path's shapes (serving:
              the prefill and decode shapes; training: B=16, T=1024, 8
              heads of 64, and the 24 layer vertices' Adam state), in bf16
              and f32 (the update kernel takes f32 only), against its plain
              PyTorch version on the card (rtol = atol = 4e-2 in bf16, 1e-4
              in f32 with TF32 off), timed with CUDA events (median of 25
              after 5 warm-up runs) beside the plain version, the least
              time the card could take (`bound_ms`) and one PyTorch library
              call where one computes the same function (`library_ms`, a
              yardstick the port never calls).
3. serve    - the widest `transformer_lm` the repo runs (V=8192, d=512, 8
              heads, 4 blocks, bf16 compute over f32 params, seeded random
              weights) behind the port's `InferenceServer` with paged KV
              (64-token pages, 4 slots, prefix cache): eight concurrent
              `POST /generate`, one a repeated prompt that must hit the
              prefix cache. Every response is checked, and every kernel's
              launch count must match the work the scheduler did, with 0
              calls of any plain version and 0 launches of the training
              kernels.
4. parity   - the same weights on the CPU through the plain versions: the
              first-token distribution and 4 decode steps of one prompt
              agree with the card's within 4e-2.
5. train    - the same model (no decode cache) trained with
              `ComputationGraph.fit` at `bench.py:1116`'s batch: B=16,
              T=1024, Adam, int64 ids whose next id is a fixed permutation
              of the current one (learnable), int32 labels; 3 warm-up and
              20 timed steps over 2 batches. Scores finite and falling (the
              last 3 average at least 5% under the first), and per step
              exactly 9 LayerNorm, 4 flash forward-with-lse, 4 dq, 4 dk/dv
              and 24 fused-update launches, 0 inference-flash launches, 0
              plain calls.
6. train_parity - one `fit` step of the same model at B=2 on the card and
              on the CPU (plain versions): scores within 4e-2 relative and,
              per layer vertex, Adam's m (= 0.1 * grad) within 4e-2 of the
              CPU's largest |m| there (a kernel wrapper that cut the
              gradient would show here).
7. trace    - where one decode step's, one 1024-token prefill's and one
              training step's (forward, backward, update) time goes: host
              wall time, kernel time on the card (torch.profiler), the
              card's idle share and the top kernels.

Then the card line, the `{"kernels": [...]}` line and, last, the result
line. With no GPU, without the package beside it, or when any phase
fails, it exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

PEAK_BYTES_S = 3.35e12                      # H100 SXM HBM3
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16; f32 w/o TF32
TOL = {"bfloat16": 4e-2, "float32": 1e-4}

VOCAB, D_MODEL, HEADS, BLOCKS, CACHE = 8192, 512, 8, 4, 1024
SLOTS, PAGE = 4, 64
ROOT = "deeplearning4j_tpu_torch/kernels/csrc/"
TRAIN_B, WARMUP, TIMED = 16, 3, 20
FA = "deeplearning4j_tpu/kernels/flash_attention.py:"
KERNEL_INFO = {
    "layernorm_norm_act": (ROOT + "norm_act.cu",
                           "deeplearning4j_tpu/kernels/norm_act.py:101"),
    "flash_attention": (ROOT + "flash_attention.cu", FA + "99"),
    "paged_decode_attention": (ROOT + "paged_attention.cu", FA + "733"),
    "flash_attention_fwd_lse": (ROOT + "flash_attention.cu", FA + "376"),
    "flash_attention_bwd_dq": (ROOT + "flash_attention_bwd.cu", FA + "386"),
    "flash_attention_bwd_dkv": (ROOT + "flash_attention_bwd.cu", FA + "426"),
    "fused_update": (ROOT + "fused_update.cu",
                     "deeplearning4j_tpu/kernels/fused_update.py:109"),
}
SERVING_KERNELS = ("layernorm_norm_act", "flash_attention",
                   "paged_decode_attention")
# Launches per training step of the smoke model: 2 LayerNorms per block and
# the final one; one attention per block; one update per layer vertex.
TRAIN_LAUNCHES = {"layernorm_norm_act": 2 * BLOCKS + 1,
                  "flash_attention_fwd_lse": BLOCKS,
                  "flash_attention_bwd_dq": BLOCKS,
                  "flash_attention_bwd_dkv": BLOCKS,
                  "fused_update": 2 + 5 * BLOCKS + 2}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def emit(card, **obj):
    print(json.dumps({**obj, "card": card}), flush=True)


def time_ms(fn, reps=25, warmup=5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(torch, fn, reps):
    """Kernel executions on the card while `fn` runs `reps` times, from
    torch.profiler (CUPTI): [(name, start_us, end_us)], or None when the
    profiler reports no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return out or None


def device_ms(torch, fn, reps=20):
    """Summed kernel time on the card per call of `fn` (no launch gaps)."""
    ev = device_kernels(torch, fn, reps)
    return None if ev is None else sum(e - s for _, s, e in ev) / reps / 1e3


def compare(got, want, dtype):
    """Max abs error and whether every element is within rtol = atol =
    TOL[dtype]; `got`/`want` are tensors or equal-length sequences."""
    if isinstance(got, (tuple, list)):
        res = [compare(g, w, dtype) for g, w in zip(got, want)]
        return max(e for e, _ in res), all(ok for _, ok in res)
    diff = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()), ok


def bound(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_cases(torch, dev, dtype_name):
    """(name, shape label, kernel fn, plain fn, library fn or None, bytes,
    ops) at the serving path's shapes."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import norm_act

    dt = getattr(torch, dtype_name)
    es = torch.tensor([], dtype=dt).element_size()
    rng = np.random.RandomState(0)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.randn(*shape) * scale + shift, dtype=dt,
                            device=dev)

    cases = []
    for rows in (4, 1024):  # a decode step's 4 slots; the widest prefill
        x = t(rows, D_MODEL, scale=2.0, shift=0.5)
        g, b = t(D_MODEL, scale=0.3, shift=1.0), t(D_MODEL)
        cases.append((
            "layernorm_norm_act", f"[{rows},{D_MODEL}]",
            lambda x=x, g=g, b=b: norm_act.layernorm_norm_act(
                x, g, b, 1e-5, "identity"),
            lambda x=x, g=g, b=b: norm_act.layernorm_plain(
                x, g, b, 1e-5, "identity"),
            lambda x=x, g=g, b=b: F.layer_norm(x, (D_MODEL,), g, b, 1e-5),
            (2 * rows * D_MODEL + 2 * D_MODEL) * es, 8 * rows * D_MODEL))

    T, dh = CACHE, D_MODEL // HEADS
    q, k, v = (t(1, T, HEADS, dh) for _ in range(3))
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    cases.append((
        "flash_attention", f"[1,{T},{HEADS},{dh}] causal",
        lambda: fa.flash_attention(q, k, v, causal=True),
        lambda: fa.dense_attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
        4 * T * HEADS * dh * es, 4 * dh * HEADS * T * (T + 1) // 2))

    n_pages, pool = CACHE // PAGE, SLOTS * (CACHE // PAGE) + 1
    pos = np.asarray([1000, 700, 330, 40], np.int32)  # slots mid-generation
    perm = rng.permutation(np.arange(1, pool))
    table = np.zeros((SLOTS, n_pages), np.int32)
    for s in range(SLOTS):
        n = -(-(int(pos[s]) + 1) // PAGE)
        table[s, :n] = perm[s * n_pages: s * n_pages + n]
    qd = t(SLOTS, 1, HEADS, dh)
    kp, vp = t(pool, PAGE, HEADS, dh), t(pool, PAGE, HEADS, dh)
    table_t = torch.tensor(table, device=dev)
    pos_t = torch.tensor(pos, device=dev)
    keys = int(np.minimum(pos + 1, n_pages * PAGE).sum())
    cases.append((
        "paged_decode_attention",
        f"q[{SLOTS},1,{HEADS},{dh}] pool[{pool},{PAGE},{HEADS},{dh}] "
        f"pos={pos.tolist()}",
        lambda: fa.paged_decode_attention(qd, kp, vp, table_t, pos_t, True),
        lambda: fa.paged_gather_dense(qd, kp, vp, table_t, pos_t, True),
        None,
        2 * keys * HEADS * dh * es + 2 * SLOTS * HEADS * dh * es
        + table.nbytes + pos.nbytes,
        4 * dh * HEADS * keys))
    return cases


def train_kernel_cases(torch, dev, dtype_name, conf):
    """The training kernels at the train phase's shapes, in the same tuple
    form as `kernel_cases`; a library entry that is a pair is timed as the
    first call less the second (SDPA's backward: forward + backward less
    the forward)."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import fused_update

    dt = getattr(torch, dtype_name)
    es = torch.tensor([], dtype=dt).element_size()
    rng = np.random.RandomState(1)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.randn(*shape) * scale, dtype=dt, device=dev)

    B, T, dh = TRAIN_B, CACHE, D_MODEL // HEADS
    n, rows = B * T * HEADS * dh, B * HEADS * T
    pairs = B * HEADS * T * (T + 1) // 2        # (q, k) pairs, causal half
    scale = dh ** -0.5
    shape = f"[{B},{T},{HEADS},{dh}] causal"
    q, k, v, do = (t(B, T, HEADS, dh) for _ in range(4))
    qh, kh, vh, doh = (a.transpose(1, 2).contiguous() for a in (q, k, v, do))
    qg, kg, vg = (a.detach().requires_grad_(True) for a in (qh, kh, vh))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), doh)

    o, lse = fa.dense_attention_lse(q, k, v, True)
    drow = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, drow, True, scale)
    cases = [
        ("flash_attention_fwd_lse", shape,
         lambda: fa.flash_attention_fwd_lse(q, k, v, True),
         lambda: fa.dense_attention_lse(q, k, v, True),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
         4 * n * es + 4 * rows, 4 * dh * pairs),
        ("flash_attention_bwd_dq", shape,
         lambda: fa.flash_attention_bwd_dq(*bwd),
         lambda: fa.flash_bwd_dq_plain(*bwd), (sdpa_fwd_bwd, sdpa_fwd),
         5 * n * es + 8 * rows, 6 * dh * pairs),
        ("flash_attention_bwd_dkv", shape,
         lambda: fa.flash_attention_bwd_dkv(*bwd),
         lambda: fa.flash_bwd_dkv_plain(*bwd), (sdpa_fwd_bwd, sdpa_fwd),
         6 * n * es + 8 * rows, 8 * dh * pairs),
    ]
    if dtype_name != "float32":
        return cases
    # Adam over the 24 layer vertices' f32 params, one dispatch each, as a
    # training step runs it (lr 3e-3, step 5).
    hyper, lr, step = (0.9, 0.999, 1e-8), 3e-3, 5
    shapes = {name: v.layer.param_shapes() for name, v in conf.vertices.items()
              if hasattr(v, "layer")}
    grads = {v: {k: t(*s) for k, s in p.items()} for v, p in shapes.items()}
    init = {v: {"m": {k: t(*s, scale=0.01) for k, s in p.items()},
                "v": {k: t(*s, scale=0.01) ** 2 for k, s in p.items()}}
            for v, p in shapes.items()}

    def copy_state():
        return {v: {f: {k: a.clone() for k, a in s.items()}
                    for f, s in st.items()} for v, st in init.items()}

    kstate, pstate, lstate = copy_state(), copy_state(), copy_state()

    def run(update, state):
        out = []
        for v in shapes:
            st, deltas = update(state[v], grads[v])
            out += [*st["m"].values(), *st["v"].values(), *deltas.values()]
        return out

    fg = [a for p in grads.values() for a in p.values()]
    fparams = [torch.zeros_like(a) for a in fg]
    fm, fv = ([a for st in lstate.values() for a in st[f].values()]
              for f in ("m", "v"))
    steps = [torch.tensor(float(step + 1), device=dev) for _ in fg]
    elems = sum(a.numel() for a in fg)
    cases.append((
        "fused_update", f"adam over {len(shapes)} layer vertices, "
        f"{elems} f32 params",
        lambda: run(lambda st, g: fused_update.dispatch(
            "adam", st, g, lr, step, hyper), kstate),
        lambda: run(lambda st, g: fused_update.adam_xla(
            st, g, lr, step, *hyper), pstate),
        lambda: torch._fused_adam_(
            fparams, fg, fm, fv, [], steps, amsgrad=False, lr=lr,
            beta1=hyper[0], beta2=hyper[1], weight_decay=0.0, eps=hyper[2],
            maximize=False, grad_scale=None, found_inf=None),
        24 * elems, 15 * elems))
    return cases


def _lib_ms(torch, lib):
    """(event-timed ms, profiler ms) of a library yardstick, or Nones."""
    if lib is None:
        return None, None
    if isinstance(lib, tuple):
        full, part = lib
        dev_full, dev_part = device_ms(torch, full), device_ms(torch, part)
        return (time_ms(full) - time_ms(part),
                None if None in (dev_full, dev_part) else dev_full - dev_part)
    return time_ms(lib), device_ms(torch, lib)


def phase_kernels(card, torch, dev, train_conf):
    rows = []
    for dtype in ("bfloat16", "float32"):
        cases = (kernel_cases(torch, dev, dtype)
                 + train_kernel_cases(torch, dev, dtype, train_conf))
        for name, shape, kern, plain, lib, nbytes, ops in cases:
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            err, ok = compare(got, want, dtype)
            bound_ms, bound_by = bound(nbytes, ops, dtype)
            lib_ms, lib_dev_ms = _lib_ms(torch, lib)
            rows.append({
                "name": name, "dtype": dtype, "shape": shape,
                "max_abs_err": err, "tolerance": f"rtol=atol={TOL[dtype]}",
                "ok": ok, "ms": time_ms(kern), "plain_ms": time_ms(plain),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms,
                # Kernel time alone (profiler): `ms` above is one call as
                # the card's clock sees it, launch gaps included.
                "device_ms": device_ms(torch, kern),
                "plain_device_ms": device_ms(torch, plain),
                "library_device_ms": lib_dev_ms})
            emit(card, phase="kernels", **rows[-1])
            del got, want
        del cases
        torch.cuda.empty_cache()
    return rows


def post(url, body, timeout=300):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serve(card, torch, kernels, cg):
    from deeplearning4j_tpu_torch.serving import InferenceServer

    rng = np.random.RandomState(7)
    p = {n: rng.randint(0, VOCAB, n).tolist() for n in (40, 300, 700, 1000)}
    extra = {n: rng.randint(0, VOCAB, n).tolist() for n in (41, 301, 701)}
    bodies = [
        {"prompt_ids": p[40], "n_steps": 16, "temperature": 0},
        {"prompt_ids": p[300], "n_steps": 20, "temperature": 0},
        {"prompt_ids": p[700], "n_steps": 24, "temperature": 0},
        {"prompt_ids": p[1000], "n_steps": 24, "temperature": 0},
        {"prompt_ids": extra[41], "n_steps": 18, "temperature": 0.8,
         "seed": 11},
        {"prompt_ids": extra[301], "n_steps": 16, "temperature": 0},
        {"prompt_ids": extra[701], "n_steps": 20, "temperature": 0},
        # The repeat of the 300-token prompt: a prefix-cache hit.
        {"prompt_ids": p[300], "n_steps": 20, "temperature": 0},
    ]
    server = InferenceServer(cg, device=cg.device, kv_cache="paged",
                             kv_page_size=PAGE, decode_slots=SLOTS).start()
    try:
        sched = server.get(None).scheduler
        kernels.reset_counts()
        results, errors = {}, []

        def send(i):
            try:
                results[i] = post(server.url, bodies[i])["ids"]
            except Exception as e:  # reported below; the phase fails
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(bodies))]
        # The 300-token prompt goes first and alone until it is prefilled
        # (and so in the prefix cache); then the rest, its repeat among them.
        threads[1].start()
        while sched.stats["prefills"] < 1 and time.perf_counter() - t0 < 120:
            time.sleep(0.005)
        for i, th in enumerate(threads):
            if i != 1:
                th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.counts()
        stats = dict(sched.stats)
        ttft = sorted(sched.ttft_s)
    finally:
        server.stop()

    for i, body in enumerate(bodies):
        ids = results.get(i)
        if ids is None:
            continue
        prompt, n = body["prompt_ids"], body["n_steps"]
        if len(ids) != len(prompt) + n or ids[:len(prompt)] != prompt:
            errors.append(f"request {i}: {len(ids)} ids, want "
                          f"{len(prompt)} + {n} starting with the prompt")
        if not all(0 <= t < VOCAB for t in ids):
            errors.append(f"request {i}: an id outside [0, {VOCAB})")
    if results.get(1) != results.get(7):
        errors.append("the prefix-cache hit decoded other ids than the "
                      "fresh prefill of the same greedy prompt")
    pf, steps = stats["prefills"], stats["decode_steps"]
    want = {name: 0 for name in KERNEL_INFO}  # training kernels: none
    want.update({"layernorm_norm_act": (2 * BLOCKS + 1) * (pf + steps),
                 "flash_attention": BLOCKS * pf,
                 "paged_decode_attention": BLOCKS * steps})
    if stats["prefix_hits"] < 1:
        errors.append("no prefix-cache hit")
    if counts["launches"] != want:
        errors.append(f"launches {counts['launches']} != expected {want}")
    if any(counts["plain_calls"].values()):
        errors.append(f"plain versions ran on the card: "
                      f"{counts['plain_calls']}")
    if any(counts["launches"][k] == 0 for k in SERVING_KERNELS):
        errors.append(f"a kernel never launched: {counts['launches']}")
    emit(card, phase="serve", ok=not errors, errors=errors,
         requests=len(bodies), completed=len(results), wall_s=wall,
         prefills=pf, prefix_hits=stats["prefix_hits"], decode_steps=steps,
         launches=counts["launches"], plain_calls=counts["plain_calls"],
         expected_launches=want,
         ttft_s={"median": statistics.median(ttft) if ttft else None,
                 "max": ttft[-1] if ttft else None, "all": ttft},
         decode_tokens=stats["decode_tokens"],
         decode_seconds=stats["decode_seconds"],
         decode_tok_s=(stats["decode_tokens"] / stats["decode_seconds"]
                       if stats["decode_seconds"] else None),
         decode_step_ms=(1e3 * stats["decode_seconds"] / steps
                         if steps else None))
    return not errors, counts["launches"]


def phase_parity(card, torch, cg, conf):
    from deeplearning4j_tpu_torch.models.zoo import PagedDecodeStepper
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    cpu = ComputationGraph(conf, device="cpu").init(params={
        v: {k: a.cpu() for k, a in p.items()}
        for v, p in cg.params_tree.items()})
    prompt = np.random.RandomState(3).randint(0, VOCAB, 300).tolist()
    steppers = [PagedDecodeStepper(net, SLOTS, page_size=PAGE)
                for net in (cg, cpu)]
    probs = []
    for st in steppers:
        pr, state, n = st.prefill(prompt, pad_to=512)
        st.install(0, state, n)
        probs.append(pr)
    diffs = [float(np.abs(probs[0] - probs[1]).max())]
    agree = [int(probs[0].argmax()) == int(probs[1].argmax())]
    for _ in range(4):
        tok = int(probs[0].argmax())  # both sides fed the card's choice
        probs = [st.step([tok] + [0] * (SLOTS - 1))[0] for st in steppers]
        diffs.append(float(np.abs(probs[0] - probs[1]).max()))
        agree.append(int(probs[0].argmax()) == int(probs[1].argmax()))
    ok = max(diffs) <= 4e-2 and all(np.isfinite(diffs))
    emit(card, phase="parity", ok=ok, tolerance=4e-2,
         max_abs_prob_diff=diffs, argmax_agrees=agree, prompt_len=300)
    return ok


def lm_batches(seed, b, t, n):
    """n batches of a learnable id rule: each next id is a fixed
    permutation of the current one, from a random first id per row.
    Features are int64 ids [b, t, 1], labels int32 [b, t]."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(VOCAB)
    out = []
    for _ in range(n):
        ids = np.empty((b, t + 1), np.int64)
        ids[:, 0] = rng.randint(0, VOCAB, b)
        for j in range(t):
            ids[:, j + 1] = perm[ids[:, j]]
        out.append((ids[:, :-1, None], ids[:, 1:].astype(np.int32)))
    return out


def phase_train(card, torch, kernels, conf, dev):
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = ComputationGraph(conf, device=dev).init()
    # Batches staged on the card once, as a device-side input pipeline
    # would hold them: a step then copies nothing from the host.
    batches = [MultiDataSet([torch.as_tensor(x, device=dev)],
                            [torch.as_tensor(y, device=dev)])
               for x, y in lm_batches(17, TRAIN_B, CACHE, 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    scores, wall = [], []
    for i in range(WARMUP + TIMED):
        t0 = time.perf_counter()
        net.fit(batches[i % 2])
        scores.append(net.score_value)  # reads the loss: syncs the step
        wall.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.counts()
    steps = WARMUP + TIMED
    errors = []
    want = {name: 0 for name in KERNEL_INFO}
    want.update({k: n * steps for k, n in TRAIN_LAUNCHES.items()})
    if counts["launches"] != want:
        errors.append(f"launches {counts['launches']} != expected {want}")
    if any(counts["plain_calls"].values()):
        errors.append(f"plain versions ran on the card: "
                      f"{counts['plain_calls']}")
    if not all(np.isfinite(scores)):
        errors.append(f"non-finite score: {scores}")
    last3 = float(np.mean(scores[-3:]))
    if not last3 <= 0.95 * scores[0]:
        errors.append(f"scores did not fall 5%: first {scores[0]}, mean of "
                      f"the last 3 {last3}")
    timed = wall[WARMUP:]
    ms = statistics.mean(timed)
    emit(card, phase="train", ok=not errors, errors=errors,
         model=f"transformer_lm V={VOCAB} T={CACHE} d={D_MODEL} "
               f"heads={HEADS} blocks={BLOCKS} mixed_bfloat16 Adam",
         batch=TRAIN_B, tokens_per_step=TRAIN_B * CACHE, steps=steps,
         scores=scores, first_score=scores[0], last3_mean=last3,
         ms_per_step=ms, ms_per_step_median=statistics.median(timed),
         ms_per_step_all=wall, tokens_per_s=TRAIN_B * CACHE / ms * 1e3,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches=counts["launches"], expected_launches=want,
         plain_calls=counts["plain_calls"])
    return not errors, counts["launches"], net, batches


def _m_errors(got, want):
    """Per layer vertex: max |m_got - m_want| over max |m_want| (Adam's m
    after one step is 0.1 * grad)."""
    out = {}
    for name, st in want.opt_state.items():
        ref = max(float(a.abs().max()) for a in st["m"].values())
        err = max(float((got.opt_state[name]["m"][k].cpu() - a.cpu())
                        .abs().max()) for k, a in st["m"].items())
        out[name] = err / ref if ref else float("inf")
    return out


def phase_train_parity(card, torch, dev):
    """One fit step at B=2 from the same seeded params, on the card and on
    the CPU (plain versions), in f32 and in the smoke model's bf16.

    f32 is the gate that catches a kernel wrapper that cut the gradient:
    scores within 4e-2 relative and, per layer vertex, Adam's m within
    4e-2 * max|m_cpu|. In bf16 the scores are held to 4e-2; the m of each
    bf16 path is measured against the CPU's f32 m, and the card's may be
    no further from it than 4e-2 or twice the CPU bf16 path's own
    distance, whichever is larger (both paths round to bf16 at other
    places, and the gradients of the layers deepest from the loss carry
    the most rounding)."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    (x, y), = lm_batches(23, 2, CACHE, 1)
    t0 = time.perf_counter()
    nets = {}
    for dtype, short in (("bfloat16", "bf16"), ("float32", "f32")):
        conf = zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL,
                                  n_heads=HEADS, n_blocks=BLOCKS, dtype=dtype)
        for where, d in (("card", dev), ("cpu", "cpu")):
            net = ComputationGraph(conf, device=d).init()  # same seed
            net.fit(MultiDataSet([x], [y]))
            nets[f"{where}_{short}"] = net
    seconds = time.perf_counter() - t0
    score = {k: n.score_value for k, n in nets.items()}

    def rel(a, b):
        return abs(score[a] - score[b]) / abs(score[b])

    m_f32 = _m_errors(nets["card_f32"], nets["cpu_f32"])
    m_bf16 = _m_errors(nets["card_bf16"], nets["cpu_bf16"])
    card_vs_f32 = _m_errors(nets["card_bf16"], nets["cpu_f32"])
    cpu_vs_f32 = _m_errors(nets["cpu_bf16"], nets["cpu_f32"])
    errors = []
    if not (rel("card_f32", "cpu_f32") <= 4e-2
            and rel("card_bf16", "cpu_bf16") <= 4e-2):
        errors.append(f"scores differ: {score}")
    if max(m_f32.values()) > 4e-2:
        errors.append(f"f32 m differs: {m_f32}")
    over = {v: e for v, e in card_vs_f32.items()
            if e > max(4e-2, 2 * cpu_vs_f32[v])}
    if over:
        errors.append(f"bf16 m of the card further from f32 than allowed: "
                      f"{over}")
    emit(card, phase="train_parity", ok=not errors, errors=errors, batch=2,
         tolerance=4e-2, scores=score,
         score_rel_diff={"f32": rel("card_f32", "cpu_f32"),
                         "bf16": rel("card_bf16", "cpu_bf16")},
         m_err_over_max_f32_card_vs_cpu=m_f32,
         m_err_over_max_bf16_card_vs_cpu=m_bf16,
         m_err_over_max_card_bf16_vs_cpu_f32=card_vs_f32,
         m_err_over_max_cpu_bf16_vs_cpu_f32=cpu_vs_f32, seconds=seconds)
    return not errors


def _kernel_summary(torch, events, wall_ms, reps=1):
    busy_ms = sum(e - s for _, s, e in events) / reps / 1e3
    by_name = {}
    for name, s, e in events:
        n_us = by_name.setdefault(name[:90], [0, 0.0])
        n_us[0] += 1
        n_us[1] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernels_per_call": len(events) / reps,
            "top": [{"kernel": k, "per_call": c / reps,
                     "ms_per_call": us / reps / 1e3}
                    for k, (c, us) in top]}


def trace_train_step(torch, net, batch):
    """One fit step with its three parts (`_train_forward`,
    `_train_backward`, `_train_update`) wrapped on the instance: each part
    runs alone on the card (synchronized before and after) under its own
    profiler, so its host wall time and kernel time are its own."""
    from torch.profiler import ProfilerActivity, profile

    parts = {}

    def wrap(part, fn):
        def run(*args):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            parts[part] = (wall, [
                (e.name, e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA])
            return out
        return run

    names = (("_train_forward", "forward"), ("_train_backward", "backward"),
             ("_train_update", "update"))
    for attr, part in names:
        setattr(net, attr, wrap(part, getattr(net, attr)))
    try:
        net.fit(batch)
    finally:
        for attr, _ in names:
            delattr(net, attr)
    out = {}
    for part, (wall, ev) in parts.items():
        out[part] = ({"wall_ms": wall, "device_ms": "not measured"}
                     if not ev else _kernel_summary(torch, ev, wall))
    return out


def phase_trace(card, torch, cg, train_net, train_batch):
    """Where the time of one decode step (4 slots at depths 1000, 700, 300,
    40), of one 1024-token prefill and of one training step's three parts
    goes: host wall time per call, kernel time on the card, the card's idle
    share, and the top kernels."""
    from deeplearning4j_tpu_torch.models.zoo import PagedDecodeStepper
    from deeplearning4j_tpu_torch.serving.scheduler import (
        prompt_bucket_ladder,
    )

    rng = np.random.RandomState(5)
    ladder = prompt_bucket_ladder(CACHE)
    st = PagedDecodeStepper(cg, SLOTS, page_size=PAGE)
    for slot, n in enumerate((1000, 700, 300, 40)):
        _, state, length = st.prefill(rng.randint(0, VOCAB, n).tolist(),
                                      pad_to=next(b for b in ladder if b >= n))
        st.install(slot, state, length)
    prompt = rng.randint(0, VOCAB, 1000).tolist()
    reps = {"decode_step": 8, "prefill_1024": 3}
    calls = {"decode_step": lambda: st.step([1] * SLOTS),
             "prefill_1024": lambda: st.prefill(prompt, pad_to=CACHE)}
    out = {}
    for what, fn in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps[what]):
            fn()  # ends in a host copy of the distributions: synchronous
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps[what]
        ev = device_kernels(torch, fn, reps[what])
        out[what] = ({"wall_ms": wall_ms, "device_ms": "not measured"}
                     if ev is None
                     else _kernel_summary(torch, ev, wall_ms, reps[what]))
    out["train_step"] = trace_train_step(torch, train_net, train_batch)
    emit(card, phase="trace", **out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    try:
        from deeplearning4j_tpu_torch import kernels
        from deeplearning4j_tpu_torch.kernels import _build
        from deeplearning4j_tpu_torch.models import zoo
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    failed = []

    _build.load(force=True)
    b = _build.last_build
    emit(card, phase="build", seconds=b["seconds"], commands=b["commands"],
         ptxas=b["ptxas"])

    train_conf = zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL,
                                    n_heads=HEADS, n_blocks=BLOCKS,
                                    dtype="bfloat16")
    rows = phase_kernels(card, torch, dev, train_conf)
    if not all(r["ok"] for r in rows):
        failed.append("kernels")

    conf = zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL, n_heads=HEADS,
                              n_blocks=BLOCKS, dtype="bfloat16",
                              decode_cache_length=CACHE)
    cg = ComputationGraph(conf, device=dev).init()
    ok, serve_launches = phase_serve(card, torch, kernels, cg)
    if not ok:
        failed.append("serve")
    if not phase_parity(card, torch, cg, conf):
        failed.append("parity")
    ok, train_launches, train_net, batches = phase_train(
        card, torch, kernels, train_conf, dev)
    if not ok:
        failed.append("train")
    if not phase_train_parity(card, torch, dev):
        failed.append("train_parity")
    phase_trace(card, torch, cg, train_net, batches[0])

    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    # The kernels line: each kernel at the shape most of its main-path
    # launches have (bf16; the update kernel's state is f32), with this
    # run's launches on the two main paths, the serve phase's and the train
    # phase's 23 steps (each counted from 0), summed and by path.
    main_shape = {"layernorm_norm_act": f"[4,{D_MODEL}]"}
    main_dtype = {"fused_update": "float32"}
    entries = []
    for name, (source, replaces) in KERNEL_INFO.items():
        dtype = main_dtype.get(name, "bfloat16")
        r = next(r for r in rows if r["name"] == name and r["dtype"] == dtype
                 and r["shape"] == main_shape.get(name, r["shape"]))
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": serve_launches[name] + train_launches[name],
            "launches_by_path": {"serve": serve_launches[name],
                                 "train": train_launches[name]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "dtype": dtype,
            "shape": r["shape"], "card": card})
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
