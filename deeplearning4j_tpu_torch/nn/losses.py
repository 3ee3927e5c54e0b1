"""Loss functions (counterpart of `deeplearning4j_tpu/nn/losses.py`).

Each loss takes the output layer's PRE-activation and its activation name,
so softmax + mcxent lowers to a log-softmax (or, for sparse ids,
logsumexp(z) - z[id]). Features on the last axis: [B, F] or [B, T, F]
(one-hot or soft labels of the same shape, or integer ids without the
last axis); masks [B] or [B, T], 1 = keep. `score` sums every entry (every timestep
too) and divides by the minibatch size only, as the reference's
`BaseOutputLayer.computeScore` does: a sequence's loss scales with its
length.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import activations

_EPS = 1e-7


def _act_name(activation) -> str:
    return activation.lower() if isinstance(activation, str) else ""


def _xent(out, labels):
    return -(labels * torch.log(out) + (1.0 - labels) * torch.log(1.0 - out))


def compute_per_example(loss, labels: torch.Tensor, preout: torch.Tensor,
                        activation="identity",
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example loss, feature axis reduced; a mask zeroes masked steps."""
    key = str(loss).lower()
    act = _act_name(activation)

    if (not labels.is_floating_point() and not labels.is_complex()
            and labels.dim() == preout.dim() - 1):
        # Sparse class-id labels ([B] / [B, T] ints), cross-entropy only.
        if key not in ("mcxent", "negativeloglikelihood"):
            raise ValueError(
                f"integer class-id labels are only supported for "
                f"mcxent/negativeloglikelihood, not {key!r}")
        ids = labels.long()[..., None]
        if act == "softmax":
            picked = torch.gather(preout, -1, ids)[..., 0]
            per = torch.logsumexp(preout, dim=-1) - picked
        else:
            out = activations.resolve(activation)(preout)
            logp = torch.log(out.clamp(_EPS, 1.0))
            per = -torch.gather(logp, -1, ids)[..., 0]
        return per * mask if mask is not None else per

    def out_():
        return activations.resolve(activation)(preout)

    if key in ("mcxent", "negativeloglikelihood"):
        if act == "softmax":
            logp = torch.log_softmax(preout, dim=-1)
        else:
            logp = torch.log(out_().clamp(_EPS, 1.0))
        per = -(labels * logp).sum(-1)
    elif key == "xent":
        if act == "sigmoid":
            # Stable binary cross-entropy from logits.
            per = (preout.clamp(min=0) - preout * labels
                   + torch.log1p(torch.exp(-preout.abs()))).sum(-1)
        else:
            per = _xent(out_().clamp(_EPS, 1.0 - _EPS), labels).sum(-1)
    elif key == "reconstruction_crossentropy":
        per = _xent(out_().clamp(_EPS, 1.0 - _EPS), labels).sum(-1)
    elif key in ("mse", "squared_loss", "l2"):
        per = ((out_() - labels) ** 2).sum(-1)
        if key == "mse":
            per = per / labels.shape[-1]
    elif key in ("l1", "mean_absolute_error"):
        per = (out_() - labels).abs().sum(-1)
        if key == "mean_absolute_error":
            per = per / labels.shape[-1]
    elif key == "mean_absolute_percentage_error":
        den = torch.where(labels.abs() < _EPS,
                          torch.full_like(labels, _EPS), labels)
        per = 100.0 * ((labels - out_()) / den).abs().mean(-1)
    elif key == "mean_squared_logarithmic_error":
        per = ((torch.log1p(out_().clamp(min=-1 + _EPS))
                - torch.log1p(labels.clamp(min=-1 + _EPS))) ** 2).mean(-1)
    elif key == "cosine_proximity":
        out = out_()
        num = (labels * out).sum(-1)
        den = (torch.linalg.vector_norm(labels, dim=-1)
               * torch.linalg.vector_norm(out, dim=-1))
        per = -num / den.clamp(min=_EPS)
    elif key == "hinge":
        per = (1.0 - labels * out_()).clamp(min=0.0).sum(-1)
    elif key == "squared_hinge":
        per = ((1.0 - labels * out_()).clamp(min=0.0) ** 2).sum(-1)
    elif key == "kl_divergence":
        out = out_().clamp(_EPS, 1.0)
        lab = labels.clamp(_EPS, 1.0)
        per = (lab * (torch.log(lab) - torch.log(out))).sum(-1)
    elif key == "poisson":
        out = out_().clamp(min=_EPS)
        per = (out - labels * torch.log(out)).sum(-1)
    elif key == "rmse_xent":
        xent = _xent(out_().clamp(_EPS, 1.0 - _EPS), labels)
        per = torch.sqrt((xent ** 2).sum(-1))
    else:
        raise ValueError(f"Unknown loss function: {loss!r}")
    return per * mask if mask is not None else per


def effective_batch_size(labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None):
    """The rows that take part in the loss: the minibatch size, less rows
    whose mask is entirely zero (data-parallel padding)."""
    if mask is None:
        return float(labels.shape[0])
    m = mask != 0
    if m.dim() > 1:
        m = m.flatten(1).any(dim=1)
    return m.float().sum().clamp(min=1.0)


def score(loss, labels, preout, activation="identity", mask=None,
          average: bool = True, eb=None) -> torch.Tensor:
    """Scalar score: per-entry losses summed, divided by the minibatch size
    (never by time length or the unmasked count). `eb` overrides the
    divisor: a truncated-BPTT chunk divides by the rows of the whole
    sequence (reference `multilayer.py:562-571`), so a row that one chunk
    masks out entirely still counts."""
    total = compute_per_example(loss, labels, preout, activation, mask).sum()
    if not average:
        return total
    return total / (effective_batch_size(labels, mask) if eb is None else eb)
