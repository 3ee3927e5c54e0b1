"""ResNet-50 at 32 px on the synthetic CIFAR-10: why the card's CIFAR
epoch (`chip_smoke.py`'s `records` phase) trains at lr 0.001 and not at
the configuration's default, 0.1.

`resnet50(10, image=32, fused_blocks=True)` under its default "bfloat16"
policy (bf16 params and activations, f32 masters), Nesterovs, B=128: the
port from its own init (seed 123, the params the card's epoch starts
from) and the JAX package from the same f32 values, both on the CPU, on
the same batches (the two packages' synthetic sets are equal bit for bit).

- lr 0.1: both packages' scores turn non-finite within 10 steps. The
  reference diverges with the port, so the card's lower lr hides no fault
  of the port.
- lr 0.001: both stay finite for 20 steps, and the mean of the last 3
  scores is under the first.

`PYTHONPATH=. python tests/test_torch_cifar_lr.py [lr ...]` prints each
package's scores at each lr (default 0.1 0.01 0.001), from the port's init
and from the reference's own.
"""

import json
import sys
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import records as jax_records
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import records
from deeplearning4j_tpu_torch.models import resnet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

B = 128


def _batches(n_steps):
    ref = jax_records.load_cifar10(num_examples=B * n_steps).batch_by(B)
    port = records.load_cifar10(num_examples=B * n_steps).batch_by(B)
    for a, b in zip(ref, port):
        assert np.array_equal(np.asarray(a.features), np.asarray(b.features))
        assert np.array_equal(np.asarray(a.labels), np.asarray(b.labels))
    return ref, port


def _conf(pkg, lr, dtype="bfloat16"):
    return pkg.resnet50(10, image=32, fused_blocks=True, lr=lr, dtype=dtype)


def _np_tree(tree):
    return {v: ({f: {k: np.array(a) for k, a in s.items()}
                 for f, s in p.items()}
                if isinstance(next(iter(p.values()), None), dict)
                else {k: np.array(a) for k, a in p.items()})
            for v, p in tree.items()}


def _nets(lr, init):
    """(reference, port) at `lr`, from the port's init ("port") or the
    reference's ("reference")."""
    import jax.numpy as jnp

    if init == "port":
        f32 = ComputationGraph(_conf(resnet, lr, "float32"),
                               device="cpu").init()
        p32 = {v: {k: a.detach().numpy().copy() for k, a in p.items()}
               for v, p in f32.params_tree.items()}
        port = ComputationGraph(_conf(resnet, lr), device="cpu").init()
        ref = JaxGraph(_conf(jax_resnet, lr)).init(params={
            v: {k: jnp.asarray(a) for k, a in p.items()}
            for v, p in p32.items()})
        return ref, port
    ref = JaxGraph(_conf(jax_resnet, lr)).init()
    port = ComputationGraph(_conf(resnet, lr), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(ref.params_tree)),
        state=interop.state_from_numpy(_np_tree(ref.state)))
    return ref, port


def _scores(net, batches):
    """Scores step by step, up to the first that is not finite."""
    out = []
    for b in batches:
        net.fit(b)
        out.append(float(net.score_value))
        if not np.isfinite(out[-1]):
            break
    return out


@pytest.mark.parametrize("lr,steps", [(0.1, 10), (0.001, 20)])
def test_the_reference_and_the_port_agree_on_where_bf16_diverges(lr, steps):
    torch.manual_seed(0)
    ref_batches, port_batches = _batches(steps)
    ref, port = _nets(lr, "port")
    got = {"reference": _scores(ref, ref_batches),
           "port": _scores(port, port_batches)}
    # One bf16 forward from the same params.
    assert abs(got["port"][0] - got["reference"][0]) <= 5e-2 * abs(
        got["reference"][0]), got
    for name, scores in got.items():
        if lr == 0.1:
            assert not np.isfinite(scores[-1]), (name, scores)
        else:
            assert len(scores) == steps and np.all(np.isfinite(scores)), (
                name, scores)
            assert np.mean(scores[-3:]) < scores[0], (name, scores)


if __name__ == "__main__":
    lrs = [float(a) for a in sys.argv[1:]] or [0.1, 0.01, 0.001]
    torch.set_num_threads(6)
    ref_batches, port_batches = _batches(20)
    for init in ("port", "reference"):
        for lr in lrs:
            ref, port = _nets(lr, init)
            for name, net, batches in (("reference", ref, ref_batches),
                                       ("port", port, port_batches)):
                t0 = time.time()
                scores = _scores(net, batches)
                print(json.dumps({"init": init, "lr": lr, "package": name,
                                  "steps": len(scores),
                                  "s": round(time.time() - t0, 1),
                                  "scores": scores}), flush=True)
