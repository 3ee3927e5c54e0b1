"""The port's solvers (`deeplearning4j_tpu_torch/optimize/solvers.py`) and
the engines' solver path (`_fit_solver`) against the JAX package's, on the
CPU.

- `minimize` for each algorithm from the same start, on a convex quadratic
  (4 iterations: past its optimum the two drift by a few 1e-9 as the
  curvature pairs vanish) and on Rosenbrock (12) in float64: the same
  iterates to 1e-9 relative (both run the same arithmetic in float64; the
  gradients come from two autodiff systems, which round differently in
  the last bits).
- `backtrack_line_search`: the reference's Armijo and failure cases.
- MultiLayerNetwork and ComputationGraph `fit` through each solver, in
  float64 from the reference's params: params and score to 1e-8
  relative, and the iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize import solvers as jax_solvers
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import solvers

ALGOS = ["lbfgs", "conjugate_gradient", "line_gradient_descent"]
F64 = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package (see
    tests/test_torch_rnn_slice.py)."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


A = np.array([[3.0, 1.0], [1.0, 2.0]])
B = np.array([1.0, -1.0])


def _quadratic(xp):
    a, b = xp(A), xp(B)
    return lambda w: 0.5 * (w @ a @ w) - b @ w


def _rosenbrock(w):
    return (1 - w[0]) ** 2 + 100.0 * (w[1] - w[0] ** 2) ** 2


PROBLEMS = {
    "quadratic": (lambda: _quadratic(jnp.asarray),
                  lambda: _quadratic(torch.tensor), np.zeros(2), 4),
    "rosenbrock": (lambda: _rosenbrock, lambda: _rosenbrock,
                   np.array([-1.2, 1.0]), 12),
}


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("mls", [5, 20])
def test_minimize_matches_the_reference(algo, problem, mls):
    jf, tf, w0, iters = PROBLEMS[problem]
    jw, jl = jax_solvers.minimize(algo, jf(), jnp.asarray(w0),
                                  iterations=iters, max_line_search=mls)
    w, loss = solvers.minimize(algo, tf(), torch.tensor(w0),
                               iterations=iters, max_line_search=mls)
    assert w.dtype == torch.float64
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **F64)
    np.testing.assert_allclose(float(loss), float(jl), **F64)


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient"])
def test_minimize_converges_on_rosenbrock(algo):
    w, loss = solvers.minimize(algo, _rosenbrock,
                               torch.tensor([-1.2, 1.0]), iterations=200,
                               max_line_search=20)
    assert float(loss) < 1e-3


def test_lbfgs_reaches_the_quadratics_optimum():
    w, _ = solvers.minimize("lbfgs", _quadratic(torch.tensor),
                            torch.zeros(2, dtype=torch.float64),
                            iterations=30, max_line_search=20)
    np.testing.assert_allclose(w.numpy(), np.linalg.solve(A, B), atol=1e-4)


def test_line_search_armijo_and_failure():
    f = lambda w: 0.5 * torch.dot(w, w)  # noqa: E731
    w = torch.tensor([2.0, 2.0], dtype=torch.float64)
    w_new, loss_new, step = solvers.backtrack_line_search(
        f, w, f(w), w, -w, max_iters=8)
    assert float(step) > 0 and float(loss_new) < float(f(w))
    assert float(loss_new) <= float(f(w) + 1e-4 * step * torch.dot(-w, w))
    w = torch.tensor([1.0, 1.0], dtype=torch.float64)
    w_new, loss_new, step = solvers.backtrack_line_search(
        f, w, f(w), w, w, max_iters=4)
    assert float(step) == 0.0 and torch.equal(w_new, w)
    with pytest.raises(ValueError, match="SGD"):
        solvers.minimize("stochastic_gradient_descent", f, w)


def _mlp(nnc, L, it, algo, iterations, dtype="float64"):
    return (nnc.builder().seed(3).optimization_algo(algo)
            .iterations(iterations).max_num_line_search_iterations(10)
            .dtype(dtype).list()
            .layer(L.DenseLayer(n_out=12, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(it.feed_forward(4)).build())


def _data(seed=0, n=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4)
    y = np.eye(3)[rng.randint(0, 3, n)]
    return x, y


def _np_params(tree):
    return {k: {n: np.array(a) for n, a in p.items()}
            for k, p in tree.items()}


@pytest.mark.parametrize("algo", ALGOS)
def test_multilayer_fit_through_the_solver_matches_the_reference(algo):
    jnet = JaxMLN(_mlp(JaxNNC, jax_layers, JaxInputType, algo, 6)).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu")
    pnet.init(params=interop.params_from_numpy(_np_params(jnet.params_tree)))
    x, y = _data()
    key = pnet._train_rng.copy()
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    assert pnet.iteration == jnet.iteration == 6
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pnet.score_value, float(jnet.score_value),
                               rtol=1e-8)
    # The objective is deterministic: the solver draws no key.
    np.testing.assert_array_equal(pnet._train_rng, key)
    assert pnet.last_training_stats == {}


def _graph(nnc, L, it, algo):
    gb = (nnc.builder().seed(3).optimization_algo(algo).iterations(5)
          .dtype("float64").graph_builder().add_inputs("in")
          .add_layer("d", L.DenseLayer(n_out=8, activation="tanh"), "in")
          .add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"), "d")
          .set_outputs("out"))
    gb.set_input_types(it.feed_forward(4))
    return gb.build()


@pytest.mark.parametrize("algo", ALGOS)
def test_graph_fit_through_the_solver_matches_the_reference(algo):
    jnet = JaxCG(_graph(JaxNNC, jax_layers, JaxInputType, algo)).init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu")
    pnet.init(params=interop.params_from_numpy(_np_params(jnet.params_tree)))
    x, y = _data(1, 24)
    s0 = pnet.score(DataSet(x, y))
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    assert pnet.iteration == jnet.iteration == 5
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               rtol=1e-8, atol=1e-10)
    assert pnet.score(DataSet(x, y)) < s0


def test_solver_refuses_masters_and_loss_scaling():
    for policy in ("mixed_float16", "bfloat16"):
        conf = (JaxNNC.builder().seed(3).optimization_algo("lbfgs")
                .dtype_policy(policy).list()
                .layer(jax_layers.OutputLayer(n_out=3, activation="softmax"))
                .set_input_type(JaxInputType.feed_forward(4)).build())
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf.to_json()), device="cpu").init()
        x, y = _data()
        with pytest.raises(ValueError, match="does not support dtype policy"):
            net.fit(DataSet(x.astype(np.float32), y.astype(np.float32)))
        assert net.iteration == 0


def test_solver_jax_parity_in_float32_first_iteration():
    # f32 as chip_smoke holds the card: after one L-BFGS iteration the
    # loss and params agree with the reference to f32 roundoff.
    jnet = JaxMLN(_mlp(JaxNNC, jax_layers, JaxInputType, "lbfgs", 1,
                       "float32")).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu")
    pnet.init(params=interop.params_from_numpy(_np_params(jnet.params_tree)))
    x, y = (a.astype(np.float32) for a in _data())
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pnet.score_value, float(jnet.score_value),
                               rtol=1e-5)
