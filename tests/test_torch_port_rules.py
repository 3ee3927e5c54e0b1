"""Rules of the PyTorch port that no later slice may break quietly.

- The port, `chip_smoke.py` and `chip_ab.py` import neither JAX, nor
  `ml_dtypes`, nor the JAX package: every port module imports in a fresh
  interpreter where `jax`, `ml_dtypes` and `deeplearning4j_tpu` cannot be
  imported, and no source file names them in an import statement; in such
  an interpreter the port reads a bf16 leaf of a checkpoint the reference
  wrote.
- Entry points run on the card unless the caller asks for the CPU: given
  no device on a machine without a GPU they raise, never falling back.
- The native components build outside the package; `Word2Vec(mesh=...)`
  (several cards) is refused, naming ROADMAP A.13.
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
from deeplearning4j_tpu_torch.graph import DeepWalk
from deeplearning4j_tpu_torch.models import resnet, zoo
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
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
            "deeplearning4j_tpu_torch.nn.prng",
            "deeplearning4j_tpu_torch.checkpoint.quantize",
            "deeplearning4j_tpu_torch.datasets.staging",
            "deeplearning4j_tpu_torch.datasets.records",
            "deeplearning4j_tpu_torch.native",
            "deeplearning4j_tpu_torch.nn.lora",
            "deeplearning4j_tpu_torch.nn.transfer",
            "deeplearning4j_tpu_torch.checkpoint.adapters",
            "deeplearning4j_tpu_torch.serving.host",
            "deeplearning4j_tpu_torch.util.huffman",
            "deeplearning4j_tpu_torch.nlp.tokenization",
            "deeplearning4j_tpu_torch.nlp.vocab",
            "deeplearning4j_tpu_torch.ops.skipgram",
            "deeplearning4j_tpu_torch.ops.glove",
            "deeplearning4j_tpu_torch.nlp.word2vec",
            "deeplearning4j_tpu_torch.nlp.serializer",
            "deeplearning4j_tpu_torch.nlp.sentence_iterator",
            "deeplearning4j_tpu_torch.nlp.glove",
            "deeplearning4j_tpu_torch.nlp.paragraph_vectors",
            "deeplearning4j_tpu_torch.nlp.vectorizer",
            "deeplearning4j_tpu_torch.nlp.distributed_corpus",
            "deeplearning4j_tpu_torch.graph.api",
            "deeplearning4j_tpu_torch.graph.data",
            "deeplearning4j_tpu_torch.graph.iterators",
            "deeplearning4j_tpu_torch.graph.deepwalk"} <= set(mods)
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
    # Kernels build at first launch, never at import; the native CSV
    # parser at its first parse.
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import records  # noqa: F401
    from deeplearning4j_tpu_torch.kernels import _build

    assert _build._lib is None
    assert native._libs == {}
    assert deeplearning4j_tpu_torch.__doc__


def _package_files():
    return {p: p.stat().st_mtime_ns for p in PORT.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_native_build_writes_nothing_under_the_package(tmp_path,
                                                       monkeypatch):
    # The CSV parser and the vocab builder build into build/native/ at the
    # repository's root (the reference writes its .so beside its source); a
    # fresh build directory forces a compile here.
    from deeplearning4j_tpu_torch import native

    assert PORT not in native.BUILD_DIR.parents
    assert native.BUILD_DIR == ROOT / "build" / "native"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(native, "_libs", {})
    before = _package_files()
    csv = tmp_path / "m.csv"
    csv.write_text("1,2\n3,4\n")
    m = native.parse_numeric_csv(str(csv))
    assert m.tolist() == [[1.0, 2.0], [3.0, 4.0]]
    assert native.library_path("fastcsv").is_file()
    words, counts, seqs = native.build_vocab_corpus(["b a b", "c b"])
    assert words == ["b", "a", "c"] and counts.tolist() == [3.0, 1.0, 1.0]
    assert [s.tolist() for s in seqs] == [[0, 1, 0], [2, 0]]
    assert native.library_path("fastvocab").is_file()
    assert _package_files() == before


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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Word2Vec([["a", "b"]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParagraphVectors(["a b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Glove([["a", "b"]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepWalk()
    with pytest.raises(ValueError, match="not supported"):
        ComputationGraph(conf, device="meta")


def test_word2vec_mesh_is_refused_naming_a13():
    # Data parallelism over several cards is not in the port yet.
    with pytest.raises(ValueError, match="A.13"):
        Word2Vec(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="A.13"):
        Word2Vec(mesh=object())  # refused before the device is resolved
