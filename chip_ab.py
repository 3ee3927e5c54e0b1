#!/usr/bin/env python3
"""Time the port's host-bound paths on one NVIDIA GPU, in this tree or
against another checkout of the port in alternating processes.

    python3 chip_ab.py                        # this tree, one JSON line
    python3 chip_ab.py --tree DIR             # the port found in DIR
    python3 chip_ab.py --against DIR --pairs 10

The paths, at `chip_smoke.py`'s shapes and seeds:
- decode_step: `PagedDecodeStepper.step` of the serving LM
  (`transformer_lm(8192, t=1024, d_model=512, n_heads=8, n_blocks=4,
  dtype="bfloat16", decode_cache_length=1024)`, 64-token pages, 4 slots
  prefilled to 1000, 700, 300 and 40 tokens), host wall per step (each
  step ends in a host copy of the distributions, so it is synchronous);
- rnn_fit: `MultiLayerNetwork.fit` of the char-RNN (`char_rnn(77, hidden=
  256)`, f32, RMSProp) at B=32 x 100 characters in tBPTT chunks of 50,
  synchronized wall per call;
- rnn_char: one `rnn_time_step` of that net, one stream, per character;
- lm_train: `ComputationGraph.fit` of that LM without a decode cache at
  B=16 x T=1024 (Adam, int64 ids, int32 labels), synchronized wall per
  step;
- lenet_fit: `MultiLayerNetwork.fit` of `zoo.lenet_mnist()` on one
  B=128 batch of the synthetic MNIST images (host numpy, copied inside
  `fit`), synchronized wall per step; left out for a tree without it.

`--against DIR` runs 2 x `--pairs` processes, this tree and DIR in turn
(this, DIR, DIR, this, ...), each one of the runs above, and prints every
run's line and, last, the medians of each path by tree. Each process
builds the kernels of its own tree (`build/kernels` under it; a tree whose
sources did not change loads what is there). Needs a GPU: without one it
exits non-zero and prints no result.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

VOCAB, D_MODEL, HEADS, BLOCKS, CACHE = 8192, 512, 8, 4, 1024
SLOTS, PAGE = 4, 64
DEPTHS = (1000, 700, 300, 40)
RNN_V, RNN_H, RNN_B, RNN_T, RNN_CHUNK = 77, 256, 32, 100, 50
TRAIN_B, MNIST_B = 16, 128
REPS = {"decode_step": 20, "rnn_fit": 5, "rnn_char": 100, "lm_train": 10,
        "lenet_fit": 50}
WARMUP = {"decode_step": 3, "rnn_fit": 2, "rnn_char": 5, "lm_train": 3,
          "lenet_fit": 20}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def timed(torch, fn, warmup, reps):
    """Host wall ms of each of `reps` calls after `warmup`, the card
    synchronized after each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def run_tree() -> dict:
    import torch

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.zoo import PagedDecodeStepper
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.scheduler import (
        prompt_bucket_ladder,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    rng = np.random.RandomState(5)
    out = {}

    conf = zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL,
                              n_heads=HEADS, n_blocks=BLOCKS,
                              dtype="bfloat16", decode_cache_length=CACHE)
    cg = ComputationGraph(conf, device=dev).init()
    ladder = prompt_bucket_ladder(CACHE)
    st = PagedDecodeStepper(cg, SLOTS, page_size=PAGE)
    for slot, n in enumerate(DEPTHS):
        _, state, length = st.prefill(rng.randint(0, VOCAB, n).tolist(),
                                      pad_to=next(b for b in ladder
                                                  if b >= n))
        st.install(slot, state, length)
    out["decode_step"] = timed(torch, lambda: st.step([1] * SLOTS),
                               WARMUP["decode_step"], REPS["decode_step"])
    del st, cg

    net = MultiLayerNetwork(zoo.char_rnn(vocab_size=RNN_V, hidden=RNN_H,
                                         tbptt_length=RNN_CHUNK),
                            device=dev).init()
    eye = torch.eye(RNN_V, device=dev)
    ids = torch.as_tensor(rng.randint(0, RNN_V, (RNN_B, RNN_T + 1)),
                          device=dev)
    batch = DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]])
    out["rnn_fit"] = timed(torch, lambda: net.fit(batch), WARMUP["rnn_fit"],
                           REPS["rnn_fit"])
    net.rnn_clear_previous_state()
    char = np.eye(RNN_V, dtype=np.float32)[[3]]
    out["rnn_char"] = timed(torch, lambda: net.rnn_time_step(char),
                            WARMUP["rnn_char"], REPS["rnn_char"])
    del net, batch

    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    lm = ComputationGraph(zoo.transformer_lm(
        VOCAB, t=CACHE, d_model=D_MODEL, n_heads=HEADS, n_blocks=BLOCKS,
        dtype="bfloat16"), device=dev).init()
    ids = torch.as_tensor(rng.randint(0, VOCAB, (TRAIN_B, CACHE + 1)),
                          device=dev)
    mds = MultiDataSet([ids[:, :-1, None]], [ids[:, 1:].to(torch.int32)])
    out["lm_train"] = timed(torch, lambda: lm.fit(mds), WARMUP["lm_train"],
                            REPS["lm_train"])
    del lm, mds

    if hasattr(zoo, "lenet_mnist"):
        from deeplearning4j_tpu_torch.datasets.builtin import load_mnist

        lenet = MultiLayerNetwork(zoo.lenet_mnist(), device=dev).init()
        ds = load_mnist(train=True, num_examples=MNIST_B)
        out["lenet_fit"] = timed(torch, lambda: lenet.fit(ds),
                                 WARMUP["lenet_fit"], REPS["lenet_fit"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--against")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    card = card_line()
    if args.against is None:
        sys.path.insert(0, os.path.abspath(args.tree))
        try:
            res = run_tree()
        except ImportError as e:
            print(f"chip_ab: no port in {args.tree} ({e})", file=sys.stderr)
            return 1
        print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                          **res}), flush=True)
        return 0
    trees = [os.path.abspath(args.tree), os.path.abspath(args.against)]
    order = [trees[(i + 1) // 2 % 2] for i in range(2 * args.pairs)]
    runs = {t: [] for t in trees}
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree],
            capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(line)
        print(json.dumps(line), flush=True)
    summary = {
        tree: {path: {"median_of_run_medians": statistics.median(
                          statistics.median(r[path]) for r in rs),
                      "run_medians": [statistics.median(r[path])
                                      for r in rs]}
               for path in REPS if all(path in r for r in rs)}
        for tree, rs in runs.items()}
    print(json.dumps({"order": order, "card": card, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
