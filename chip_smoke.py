#!/usr/bin/env python3
"""Prove on one NVIDIA GPU that the PyTorch/CUDA port starts and is right.

    python3 chip_smoke.py

Phases, each printing one JSON line that carries the card's name and power
limit (as `nvidia-smi --query-gpu=name,power.limit` reports them):

1. build    - nvcc builds every kernel of `deeplearning4j_tpu_torch/kernels/
              csrc` for sm_90a (one nvcc per source, all at once).
2. kernels  - each hand-written kernel at the serving path's shapes, in bf16
              and f32, against its plain PyTorch version on the card
              (rtol = atol = 4e-2 in bf16, 1e-4 in f32 with TF32 off), timed
              with CUDA events (median of 25 after 5 warm-up runs) beside
              the plain version, the least time the card could take
              (`bound_ms`) and one PyTorch library call where one computes
              the same function (`library_ms`, a yardstick the port never
              calls).
3. serve    - the widest `transformer_lm` the repo runs (V=8192, d=512, 8
              heads, 4 blocks, bf16 compute over f32 params, seeded random
              weights) behind the port's `InferenceServer` with paged KV
              (64-token pages, 4 slots, prefix cache): eight concurrent
              `POST /generate`, one a repeated prompt that must hit the
              prefix cache. Every response is checked, and every kernel's
              launch count must match the work the scheduler did, with 0
              calls of any plain version.
4. parity   - the same weights on the CPU through the plain versions: the
              first-token distribution and 4 decode steps of one prompt
              agree with the card's within 4e-2.
5. trace    - where one decode step's and one 1024-token prefill's time
              goes: host wall time, kernel time on the card (torch.profiler),
              the card's idle share and the top kernels.

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
KERNEL_INFO = {
    "layernorm_norm_act": (ROOT + "norm_act.cu",
                           "deeplearning4j_tpu/kernels/norm_act.py:101"),
    "flash_attention": (ROOT + "flash_attention.cu",
                        "deeplearning4j_tpu/kernels/flash_attention.py:99"),
    "paged_decode_attention": (ROOT + "paged_attention.cu",
                               "deeplearning4j_tpu/kernels/flash_attention.py:733"),
}


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


def phase_kernels(card, torch, dev):
    rows = []
    for dtype in ("bfloat16", "float32"):
        for name, shape, kern, plain, lib, nbytes, ops in kernel_cases(
                torch, dev, dtype):
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            err, ok = compare(got, want, dtype)
            bound_ms, bound_by = bound(nbytes, ops, dtype)
            rows.append({
                "name": name, "dtype": dtype, "shape": shape,
                "max_abs_err": err, "tolerance": f"rtol=atol={TOL[dtype]}",
                "ok": ok, "ms": time_ms(kern), "plain_ms": time_ms(plain),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None if lib is None else time_ms(lib),
                # Kernel time alone (profiler): `ms` above is one call as
                # the card's clock sees it, launch gaps included.
                "device_ms": device_ms(torch, kern),
                "plain_device_ms": device_ms(torch, plain),
                "library_device_ms": (None if lib is None
                                      else device_ms(torch, lib))})
            emit(card, phase="kernels", **rows[-1])
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
    want = {"layernorm_norm_act": (2 * BLOCKS + 1) * (pf + steps),
            "flash_attention": BLOCKS * pf,
            "paged_decode_attention": BLOCKS * steps}
    if stats["prefix_hits"] < 1:
        errors.append("no prefix-cache hit")
    if counts["launches"] != want:
        errors.append(f"launches {counts['launches']} != expected {want}")
    if any(counts["plain_calls"].values()):
        errors.append(f"plain versions ran on the card: "
                      f"{counts['plain_calls']}")
    if any(v == 0 for v in counts["launches"].values()):
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


def phase_trace(card, torch, cg):
    """Where the time of one decode step (4 slots at depths 1000, 700, 300,
    40) and of one 1024-token prefill goes: host wall time per call, kernel
    time on the card, the card's idle share, and the top kernels."""
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
        if ev is None:
            out[what] = {"wall_ms": wall_ms, "device_ms": "not measured"}
            continue
        busy_ms = sum(e - s for _, s, e in ev) / reps[what] / 1e3
        by_name = {}
        for name, s, e in ev:
            n_us = by_name.setdefault(name[:90], [0, 0.0])
            n_us[0] += 1
            n_us[1] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        out[what] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernels_per_call": len(ev) / reps[what],
            "top": [{"kernel": k, "per_call": c / reps[what],
                     "ms_per_call": us / reps[what] / 1e3}
                    for k, (c, us) in top]}
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

    rows = phase_kernels(card, torch, dev)
    if not all(r["ok"] for r in rows):
        failed.append("kernels")

    conf = zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL, n_heads=HEADS,
                              n_blocks=BLOCKS, dtype="bfloat16",
                              decode_cache_length=CACHE)
    cg = ComputationGraph(conf, device=dev).init()
    ok, launches = phase_serve(card, torch, kernels, cg)
    if not ok:
        failed.append("serve")
    if not phase_parity(card, torch, cg, conf):
        failed.append("parity")
    phase_trace(card, torch, cg)

    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    # The kernels line: each kernel at the shape most of its serving
    # launches have (bf16), with this run's serving launch count.
    main_shape = {"layernorm_norm_act": f"[4,{D_MODEL}]"}
    entries = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = next(r for r in rows if r["name"] == name
                 and r["dtype"] == "bfloat16"
                 and r["shape"] == main_shape.get(name, r["shape"]))
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "dtype": "bfloat16",
            "shape": r["shape"], "card": card})
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
