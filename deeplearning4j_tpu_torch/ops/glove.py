"""Batched GloVe AdaGrad update (counterpart of
`deeplearning4j_tpu/ops/glove.py`, a `jax.jit` program with no Pallas
kernel; here the same ops as PyTorch ops on the tables' device).

The reference's per-pair GloVe step (`GloVe.java:180-220` `iterateSample`:
prediction = w_i.w_j + b_i + b_j - log X_ij, weighted by f(X) =
(X/xMax)^alpha capped at 1, per-element AdaGrad) over a BATCH of (row, col,
count) triples: gather -> weighted residual -> scatter-add (`index_add_`)
-> AdaGrad, the tables updated in place. Duplicate indices in a batch are
summed before the AdaGrad state update: H += (sum g)^2, then w -= lr *
(sum g) / sqrt(H + eps).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.skipgram import _segment_sum

ADAGRAD_EPS = 1e-6


def glove_step(syn0, bias, hist_w, hist_b, rows, cols, counts, mask,
               lr, x_max, alpha):
    """One batched GloVe update (reference :29).

    syn0 [V, D] (one table for both roles, `GloVe.java:216`), bias [V],
    hist_w / hist_b their AdaGrad accumulators, all updated in place.
    rows / cols [B] pair indices, counts [B] cooccurrence weights, mask [B]
    the real (non-padding) pairs; lr, x_max, alpha floats or 0-d tensors.

    Returns (syn0, bias, hist_w, hist_b, batch_loss): batch_loss, a 0-d
    tensor on the tables' device, is the summed 0.5 * f(X) * pred^2 over
    the real pairs."""
    V = syn0.shape[0]
    wi = syn0.index_select(0, rows)                    # [B, D]
    wj = syn0.index_select(0, cols)
    pred = ((wi * wj).sum(dim=-1) + bias.index_select(0, rows)
            + bias.index_select(0, cols)
            - torch.log(torch.clamp(counts, min=1e-12)))  # [B]
    f = torch.where(counts > x_max, torch.ones_like(counts),
                    (counts / x_max) ** alpha)
    fdiff = f * pred * mask                            # [B]

    # d pred / d wi = wj (and vice versa); the biases get fdiff.
    idx = torch.cat([rows, cols])                      # [2B]
    agg = _segment_sum(torch.cat([fdiff[:, None] * wj, fdiff[:, None] * wi]),
                       idx, V)                         # [V, D]
    agg_b = _segment_sum(torch.cat([fdiff, fdiff]), idx, V)  # [V]

    hist_w.add_(agg * agg)
    hist_b.add_(agg_b * agg_b)
    syn0.sub_(lr * agg / torch.sqrt(hist_w + ADAGRAD_EPS))
    bias.sub_(lr * agg_b / torch.sqrt(hist_b + ADAGRAD_EPS))
    loss = 0.5 * (f * pred * pred * mask).sum()
    return syn0, bias, hist_w, hist_b, loss
