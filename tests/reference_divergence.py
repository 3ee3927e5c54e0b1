"""CPU runs behind what PERF.md and ROADMAP.md say about training the zoo's
AlexNet and VGG-16 from their random inits (a script, not a test: pytest
does not collect it):

    JAX_PLATFORMS=cpu python tests/reference_divergence.py vgg16 [scale]
    JAX_PLATFORMS=cpu python tests/reference_divergence.py alexnet

`vgg16`: `zoo.vgg16(n_classes=1000, dtype="float32")` in the JAX package
and in the port from the same params, 6 `fit` steps (Nesterovs 0.9 at the
zoo's lr 0.01) at B=4 on seeded images, each its class's template plus
noise at half its scale, times `scale` (default 1), labels from 10
classes: both packages' scores per step. `alexnet`: the port's
`zoo.alexnet(n_classes=1000, image=224, dtype="float32")`, 13 `fit` steps
at B=32 on `chip_smoke.py`'s `rn_batches` images made on the CPU: its
scores per step. Prints one JSON line. Needs a few GB of host memory and a
few minutes.
"""

import json
import os
import sys

os.environ.setdefault("DL4J_TPU_COMPILE_CACHE", "0")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def vgg16(scale: float, b: int = 4, steps: int = 6):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    from deeplearning4j_tpu.models import zoo as jax_zoo
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
    from deeplearning4j_tpu_torch import interop
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    jnet = JaxMLN(jax_zoo.vgg16(n_classes=1000, dtype="float32")).init()
    pnet = MultiLayerNetwork(zoo.vgg16(n_classes=1000, dtype="float32"),
                             device="cpu").init(
        params=interop.params_from_numpy(
            {k: {n: np.array(a) for n, a in p.items()}
             for k, p in jnet.params_tree.items() if isinstance(p, dict)}))
    rng = np.random.RandomState(0)
    templates = rng.randn(10, 224, 224, 3).astype(np.float32)

    def batch():
        c = rng.randint(0, 10, b)
        x = scale * (templates[c] + 0.5 * rng.randn(b, 224, 224, 3))
        return x.astype(np.float32), np.eye(1000, dtype=np.float32)[c]

    pool = [batch(), batch()]
    scores = {"reference": [], "port": []}
    for i in range(steps):
        x, y = pool[i % 2]
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
        scores["reference"].append(float(jnet.score_value))
        scores["port"].append(pnet.score_value)
    return {"model": "vgg16", "batch": b, "scale": scale, **scores}


def alexnet(b: int = 32, steps: int = 13):
    import chip_smoke
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(zoo.alexnet(n_classes=1000, image=224,
                                        dtype="float32"), device="cpu").init()
    batches = chip_smoke._image_batches(torch, "cpu", b, 2, 91)
    scores = []
    for i in range(steps):
        net.fit(batches[i % 2])
        scores.append(net.score_value)
    return {"model": "alexnet", "batch": b, "port": scores}


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "vgg16"
    out = (vgg16(float(sys.argv[2]) if len(sys.argv) > 2 else 1.0)
           if which == "vgg16" else alexnet())
    print(json.dumps(out))
