"""Rules of the PyTorch port that no later slice may break quietly.

- The port, `chip_smoke.py` and `chip_ab.py` import neither JAX, nor
  `ml_dtypes`, nor the JAX package: every port module imports in a fresh
  interpreter where `jax`, `ml_dtypes` and `deeplearning4j_tpu` cannot be
  imported, and no source file names them in an import statement; in such
  an interpreter the port reads a bf16 leaf of a checkpoint the reference
  wrote.
- Entry points run on the card unless the caller asks for the CPU: given
  no device on a machine without a GPU they raise, never falling back.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.models import resnet, zoo
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import InferenceServer
from deeplearning4j_tpu_torch.util.model_serializer import load_model

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="deeplearning4j_tpu_torch."))


def _forbidden_imports(path: Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "ml_dtypes",
                       "deeplearning4j_tpu"):
                bad.append(f"{path.name}:{node.lineno} imports {n}")
    return bad


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert {"deeplearning4j_tpu_torch.serving.server",
            "deeplearning4j_tpu_torch.kernels.fused_update",
            "deeplearning4j_tpu_torch.kernels._diff",
            "deeplearning4j_tpu_torch.ops.updaters",
            "deeplearning4j_tpu_torch.ops.schedules",
            "deeplearning4j_tpu_torch.ops.grad_norm",
            "deeplearning4j_tpu_torch.nn.losses",
            "deeplearning4j_tpu_torch.datasets.dataset",
            "deeplearning4j_tpu_torch.kernels.bottleneck_block",
            "deeplearning4j_tpu_torch.models.resnet",
            "deeplearning4j_tpu_torch.nn.conf.enums",
            "deeplearning4j_tpu_torch.nn.layers.bottleneck",
            "deeplearning4j_tpu_torch.nn.layers.convolution",
            "deeplearning4j_tpu_torch.nn.layers.pooling",
            "deeplearning4j_tpu_torch.kernels.lstm_cell",
            "deeplearning4j_tpu_torch.nn.conf.inputs",
            "deeplearning4j_tpu_torch.nn.engine",
            "deeplearning4j_tpu_torch.nn.layers.recurrent",
            "deeplearning4j_tpu_torch.nn.multilayer",
            "deeplearning4j_tpu_torch.nn.conf.preprocessors",
            "deeplearning4j_tpu_torch.optimize.listeners",
            "deeplearning4j_tpu_torch.eval.evaluation",
            "deeplearning4j_tpu_torch.datasets.iterators",
            "deeplearning4j_tpu_torch.datasets.builtin",
            "deeplearning4j_tpu_torch.util.model_serializer",
            "deeplearning4j_tpu_torch.nn.conf.distributions",
            "deeplearning4j_tpu_torch.nn.conf.neural_net",
            "deeplearning4j_tpu_torch.nn.conf.graph",
            "deeplearning4j_tpu_torch.nn.conf.dtype_policy",
            "deeplearning4j_tpu_torch.nn.weights",
            "deeplearning4j_tpu_torch.nn.graph",
            "deeplearning4j_tpu_torch.util.retry",
            "deeplearning4j_tpu_torch.util.checkpoint",
            "deeplearning4j_tpu_torch.util.failure",
            "deeplearning4j_tpu_torch.checkpoint",
            "deeplearning4j_tpu_torch.checkpoint.array_store",
            "deeplearning4j_tpu_torch.checkpoint.store",
            "deeplearning4j_tpu_torch.checkpoint.manager",
            "deeplearning4j_tpu_torch.checkpoint.legacy",
            "deeplearning4j_tpu_torch.earlystopping",
            "deeplearning4j_tpu_torch.earlystopping.config",
            "deeplearning4j_tpu_torch.earlystopping.scorecalc",
            "deeplearning4j_tpu_torch.earlystopping.termination",
            "deeplearning4j_tpu_torch.earlystopping.saver",
            "deeplearning4j_tpu_torch.earlystopping.trainer",
            "deeplearning4j_tpu_torch.parallel.expert",
            "deeplearning4j_tpu_torch.nn.layers.moe",
            "deeplearning4j_tpu_torch.nn.layers.variational",
            "deeplearning4j_tpu_torch.nn.layers.common",
            "deeplearning4j_tpu_torch.nn.prng"} <= set(mods)
    code = (
        "import sys\n"
        "for blocked in ('jax', 'jaxlib', 'ml_dtypes', "
        "'deeplearning4j_tpu'):\n"
        "    sys.modules[blocked] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', "
        "'ml_dtypes')) and sys.modules[m] is not None]\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_reads_a_reference_bf16_leaf_without_ml_dtypes(tmp_path):
    # The reference writes bf16 through ml_dtypes; the port reads the same
    # bytes as raw <u2 viewed as torch.bfloat16, with ml_dtypes blocked.
    import jax.numpy as jnp
    import numpy as np

    from deeplearning4j_tpu.checkpoint import array_store as jax_as

    x = jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6),
                    jnp.bfloat16)
    (tmp_path / "chunks").mkdir()
    entry = jax_as.write_leaf(str(tmp_path), 0, "params/l/W",
                              list(jax_as.leaf_chunks(x)), x.shape,
                              str(x.dtype), {})
    assert entry["dtype"] == "bfloat16"
    want = np.asarray(x.astype(jnp.float32)).tolist()
    code = (
        "import sys, json\n"
        "for blocked in ('jax', 'jaxlib', 'ml_dtypes', "
        "'deeplearning4j_tpu'):\n"
        "    sys.modules[blocked] = None\n"
        "import torch\n"
        "from deeplearning4j_tpu_torch.checkpoint import array_store\n"
        f"entry = json.loads({json.dumps(json.dumps(entry))})\n"
        f"arr = array_store.read_full({str(tmp_path)!r}, entry)\n"
        "t = array_store.to_tensor(arr, entry['dtype'])\n"
        "assert t.dtype == torch.bfloat16, t.dtype\n"
        "print(json.dumps(t.float().tolist()))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == want


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    assert _forbidden_imports(path) == []


def test_importing_the_port_builds_nothing():
    # Kernels build at first launch, never at import.
    from deeplearning4j_tpu_torch.kernels import _build

    assert _build._lib is None
    assert deeplearning4j_tpu_torch.__doc__


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU refusal is what is "
                    "under test")
    conf = zoo.transformer_lm(16, d_model=8, n_heads=2, n_blocks=1,
                              decode_cache_length=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(resnet.resnet50(n_classes=5, image=32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(zoo.char_rnn(vocab_size=11, hidden=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(zoo.lenet_mnist())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(ROOT / "tests" / "fixtures" / "golden_model_v1.zip")
    with pytest.raises(ValueError, match="not supported"):
        ComputationGraph(conf, device="meta")
