"""The port's observability on the card: what the CPU tests cannot reach.

Marked `cuda`: these skip where `torch.cuda.is_available()` is false. On a
machine with an H100:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_observability.py -q

- The instruments add no host sync to a step: the engine's dispatch and
  the flight ring under `torch.cuda.set_sync_debug_mode("error")`.
- `StepProfiler` times steps by CUDA events read once at the end, keeps
  the first dispatch apart, and reads a traced window (`window_short`).
- The first dispatch of a signature records its device memory
  (`dl4j_program_hbm_bytes`), and a measured footprint is the leaves plus
  that transient; `live_buffer_report` attributes the card's storages.
- A superstep's flight record keeps its K losses (the replay's copies),
  equal bit for bit to the per-batch run's scores.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import observability as obs
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import memory as pmem

pytestmark = pytest.mark.cuda

B, N_IN, N_OUT = 64, 32, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _net(dev, k=0):
    conf = (NeuralNetConfiguration.builder().seed(5).learning_rate(0.05)
            .updater("adam").superstep_k(k).list()
            .layer(L.DenseLayer(n_out=64, activation="relu"))
            .layer(L.OutputLayer(n_out=N_OUT, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    return MultiLayerNetwork(conf, device=dev).init()


def _batches(dev, n, seed=0):
    rng = np.random.RandomState(seed)
    return [DataSet(torch.as_tensor(rng.rand(B, N_IN).astype(np.float32),
                                    device=dev),
                    torch.as_tensor(np.eye(N_OUT, dtype=np.float32)[
                        rng.randint(0, N_OUT, B)], device=dev))
            for _ in range(n)]


def test_a_step_and_its_record_add_no_sync(cuda, tmp_path):
    net = _net(cuda)
    data = _batches(cuda, 3)
    net.fit(data[0])  # the first: builds, records memory
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ds in data[1:]:
            net.fit(ds)
        obs.flight.record_step("mln", net.iteration, loss=net._score)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert obs.flight.snapshot(limit=1)[0]["loss"] == net.score_value


def test_profiler_times_by_events_and_reads_a_traced_window(cuda):
    net = _net(cuda)
    data = _batches(cuda, 6, seed=1)
    with obs.StepProfiler(net, trace=True) as prof:
        for ds in data:
            net.fit(ds)
    s = prof.summary()
    assert (s["steps"], s["first_call_steps"]) == (6, 1)
    assert s["execute_seconds_median"] > 0
    assert s["window_short"] in (True, False)
    assert s["counted_launches"] == 6  # one fused update a step
    assert s["flops_per_step"] > 0


def test_first_dispatch_records_memory_and_footprint(cuda):
    net = _net(cuda)
    (ds,) = _batches(cuda, 1, seed=2)
    net.fit(ds)
    rec = pmem.program_memory_snapshot()["mln.train_step"]
    assert rec["argument"] == pmem.leaf_bytes(net, "cuda")
    transient = pmem.largest_transient(net)
    assert transient is not None and transient > 0
    assert pmem.measured_model_bytes(net) == rec["argument"] + transient
    pmem.register_tree("cuda_obs_test", net)
    try:
        got = pmem.live_buffer_report()
    finally:
        pmem.unregister_tree("cuda_obs_test")
    assert got["models"]["cuda_obs_test"]["bytes"] == pmem.leaf_bytes(net)
    assert got["unattributed_bytes"] >= 0


def test_superstep_record_keeps_k_losses(cuda):
    data = _batches(cuda, 8, seed=3)
    ref = _net(cuda)
    scores = []
    for ds in data:
        ref.fit(ds)
        scores.append(ref._score)
    obs.flight.clear()
    net = _net(cuda, k=4)
    net.fit(data)
    steps = [r for r in obs.flight.snapshot() if r["type"] == "step"]
    assert [(r["k"], r["iteration"]) for r in steps] == [(4, 4), (4, 8)]
    assert [v for r in steps for v in r["losses"]] == [
        float(s) for s in scores]
