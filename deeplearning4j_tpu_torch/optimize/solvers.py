"""Line-search and second-order solvers (counterpart of
`deeplearning4j_tpu/optimize/solvers.py`, the reference's
`optimize/solvers/`: `BackTrackLineSearch`, `LineGradientDescent`,
`ConjugateGradient`, `LBFGS`).

Each works on one flat parameter vector `w` (a tensor on the engine's
device, in the reference's flat order: `nn/engine.py` `_fit_solver`) and a
`loss_fn(w)` that returns a 0-d tensor. The reference writes its loops as
XLA structure (`lax.scan` over iterations, `lax.while_loop` for the line
search, fixed-size masked loops over the L-BFGS history); here they are
host loops over device tensors with the same arithmetic, in the same
order, and the same decisions. A decision (the Armijo test, whether a
curvature pair is stored) reads one device bool back, so a solver
iteration syncs a few times with the device; the gradients come from
autograd (`value_and_grad`).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.enums import OptimizationAlgorithm

LossFn = Callable[[torch.Tensor], torch.Tensor]


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def value_and_grad(loss_fn: LossFn, w: torch.Tensor):
    """`(loss, d loss / d w)` at `w`, both detached."""
    with torch.inference_mode(False), torch.enable_grad():
        leaf = w.detach().clone().requires_grad_(True)
        loss = loss_fn(leaf)
        (g,) = torch.autograd.grad(loss, [leaf])
    return loss.detach(), g.detach()


def _value(loss_fn: LossFn, w: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return loss_fn(w).detach()


def backtrack_line_search(loss_fn: LossFn, w, loss0, grad, direction,
                          max_iters: int = 5, step0: float = 1.0,
                          rho: float = 0.5, c1: float = 1e-4
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Armijo backtracking (reference `backtrack_line_search`, :29): from
    `step0`, shrink the step by `rho` until loss(w + a d) <= loss0 + c1 a
    (d . grad), at most `max_iters` times. Returns (w_new, loss_new, step);
    if no step passes, the unchanged point, loss0 and step 0."""
    slope = _vdot(direction, grad)
    alpha = torch.tensor(step0, dtype=w.dtype, device=w.device)
    w_new = w + alpha * direction
    loss_new = _value(loss_fn, w_new)
    it = 0
    while it < max_iters and bool(loss_new > loss0 + c1 * alpha * slope):
        alpha = alpha * rho
        it += 1
        w_new = w + alpha * direction
        loss_new = _value(loss_fn, w_new)
    ok = loss_new <= loss0 + c1 * alpha * slope
    return (torch.where(ok, w_new, w), torch.where(ok, loss_new, loss0),
            torch.where(ok, alpha, torch.zeros_like(alpha)))


def _line_gradient_descent(loss_fn, w0, iterations, max_line_search):
    """Steepest descent along the normalized gradient, with the line
    search (reference :63)."""
    w, loss = w0, _value(loss_fn, w0)
    for _ in range(iterations):
        loss, g = value_and_grad(loss_fn, w)
        d = -g / (torch.linalg.norm(g) + 1e-12)
        w, loss, _ = backtrack_line_search(loss_fn, w, loss, g, d,
                                           max_iters=max_line_search)
    return w, loss


def _conjugate_gradient(loss_fn, w0, iterations, max_line_search):
    """Nonlinear conjugate gradient, Polak-Ribiere+, restarting on a
    negative beta, a failed line search or a direction that does not
    descend (reference :82)."""
    loss, g = value_and_grad(loss_fn, w0)
    w, d = w0, -g
    for _ in range(iterations):
        w_new, loss_new, alpha = backtrack_line_search(
            loss_fn, w, loss, g, d, max_iters=max_line_search)
        loss_new, g_new = value_and_grad(loss_fn, w_new)
        beta = _vdot(g_new, g_new - g) / (_vdot(g, g) + 1e-30)
        zero = torch.zeros_like(beta)
        beta = torch.maximum(beta, zero)
        beta = torch.where(alpha > 0.0, beta, zero)
        d_new = -g_new + beta * d
        d_new = torch.where(_vdot(d_new, g_new) < 0.0, d_new, -g_new)
        w, loss, g, d = w_new, loss_new, g_new, d_new
    return w, loss


def _lbfgs(loss_fn, w0, iterations, max_line_search, history=10):
    """L-BFGS: the two-loop recursion over the last `history` curvature
    pairs (s, y) with s . y > 1e-12, newest first, scaled by s.y / y.y of
    the newest; a rejected pair (or a failed line search) drops the
    history, so the next direction is steepest descent (reference :107).
    The reference masks the history slots not yet filled; here the loops
    run over the filled ones only, which adds the same terms."""
    m = history
    n = w0.shape[0]
    loss, g = value_and_grad(loss_fn, w0)
    w = w0
    S = torch.zeros((m, n), dtype=w0.dtype, device=w0.device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((m,), dtype=w0.dtype, device=w0.device)
    k = 0
    for _ in range(iterations):
        valid = min(k, m)
        q = g
        alphas = {}
        for i in range(valid):
            idx = (k - 1 - i) % m
            a = rho[idx] * _vdot(S[idx], q)
            q = q - a * Y[idx]
            alphas[idx] = a
        if k > 0:
            newest = (k - 1) % m
            gamma = _vdot(S[newest], Y[newest]) / (
                _vdot(Y[newest], Y[newest]) + 1e-30)
        else:
            gamma = torch.ones((), dtype=w.dtype, device=w.device)
        r = gamma * q
        for i in range(valid):
            idx = (k - valid + i) % m
            b = rho[idx] * _vdot(Y[idx], r)
            r = r + S[idx] * (alphas[idx] - b)
        d = -r
        d = torch.where(_vdot(d, g) < 0.0, d,
                        -g / (torch.linalg.norm(g) + 1e-12))
        w_new, _, alpha = backtrack_line_search(
            loss_fn, w, loss, g, d, max_iters=max_line_search)
        loss_new, g_new = value_and_grad(loss_fn, w_new)
        s = w_new - w
        y = g_new - g
        sy = _vdot(s, y)
        if bool((alpha > 0.0) & (sy > 1e-12)):
            slot = k % m
            S[slot] = s
            Y[slot] = y
            rho[slot] = 1.0 / (sy + 1e-30)
            k += 1
        else:
            k = 0
        w, loss, g = w_new, loss_new, g_new
    return w, loss


def minimize(algo, loss_fn: LossFn, w0: torch.Tensor, iterations: int = 10,
             max_line_search: int = 5,
             history: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run `iterations` iterations of `algo` from `w0`; returns (w, loss)
    (reference `minimize`, :184)."""
    algo = OptimizationAlgorithm.of(algo)
    if algo == OptimizationAlgorithm.LINE_GRADIENT_DESCENT:
        return _line_gradient_descent(loss_fn, w0, iterations,
                                      max_line_search)
    if algo == OptimizationAlgorithm.CONJUGATE_GRADIENT:
        return _conjugate_gradient(loss_fn, w0, iterations, max_line_search)
    if algo == OptimizationAlgorithm.LBFGS:
        return _lbfgs(loss_fn, w0, iterations, max_line_search, history)
    raise ValueError(f"minimize() does not handle {algo!r} (SGD uses the "
                     "engines' train step)")
