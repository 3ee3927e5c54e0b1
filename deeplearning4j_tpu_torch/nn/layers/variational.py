"""The variational autoencoder (counterpart of
`deeplearning4j_tpu/nn/layers/variational.py`): encoder and decoder MLP
stacks, a reconstruction distribution, the reparameterisation trick. The
supervised forward is the encoder's mean; `vae_pretrain_loss`, the
negative ELBO, is what layerwise pretraining minimises.

A distribution is one of:

- "gaussian" | "bernoulli" | "exponential";
- a loss wrapper `("loss", loss_function[, activation])`: the wrapped
  loss's per-example score stands in for -log p(x|z) (activation identity
  by default);
- a composite, a list of `(distribution, data_size)` pairs that partition
  the feature axis (entries may be loss wrappers).

Epsilon is drawn by `common.draw_normal` from `fold_in(key, s)` for sample
s, the reference's keys."""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf.layers import (
    _is_loss_wrapper,
    dist_input_size,
)
from deeplearning4j_tpu_torch.nn.layers import common
from deeplearning4j_tpu_torch.nn.prng import fold_in


def neg_log_prob(dist, x, pre):
    """Per-example -log p(x | z) [B] from the decoder's output `pre` (the
    reference's `neg_log_prob`)."""
    if _is_loss_wrapper(dist):
        from deeplearning4j_tpu_torch.nn import losses

        activation = dist[2] if len(dist) > 2 else "identity"
        return losses.compute_per_example(dist[1], x, pre, activation)
    if isinstance(dist, (list, tuple)):
        total, x_off, p_off = 0.0, 0, 0
        for name, size in dist:
            p_size = dist_input_size(name, size)
            total = total + neg_log_prob(name, x[:, x_off:x_off + size],
                                         pre[:, p_off:p_off + p_size])
            x_off += size
            p_off += p_size
        return total
    if dist == "bernoulli":
        p = torch.sigmoid(pre).clamp(1e-7, 1 - 1e-7)
        return -(x * torch.log(p) + (1 - x) * torch.log(1 - p)).sum(-1)
    if dist == "gaussian":
        mean, log_var = torch.chunk(pre, 2, dim=-1)
        return 0.5 * (log_var + (x - mean) ** 2 / torch.exp(log_var)
                      + math.log(2 * math.pi)).sum(-1)
    if dist == "exponential":
        # gamma = pre, lambda = exp(gamma), log p(x) = gamma - lambda * x.
        return -(pre - torch.exp(pre) * x).sum(-1)
    raise ValueError(f"unknown reconstruction distribution {dist!r}")


def _mlp(x, params, prefix, n_layers, act):
    for i in range(n_layers):
        x = act(x @ params[f"{prefix}W{i}"] + params[f"{prefix}b{i}"])
    return x


def vae_encode(conf, params, x):
    """(mean, log variance) of q(z | x)."""
    h = _mlp(x, params, "e", len(conf.encoder_layer_sizes),
             activations.resolve(conf.activation))
    mean = activations.resolve(conf.pzx_activation)(
        h @ params["pZXMeanW"] + params["pZXMeanB"])
    return mean, h @ params["pZXLogStd2W"] + params["pZXLogStd2B"]


def vae_decode(conf, params, z):
    h = _mlp(z, params, "d", len(conf.decoder_layer_sizes),
             activations.resolve(conf.activation))
    return h @ params["pXZW"] + params["pXZB"]


def vae_apply(conf, params, state, x, train=False, mask=None, rng=None):
    """The supervised forward: the encoder's mean."""
    return vae_encode(conf, params, x)[0], state


def _samples(conf, params, x, key, n):
    """-log p(x | z_s) for s < n, z_s = mean + exp(log_var / 2) * eps_s,
    and the encoder's (mean, log_var)."""
    mean, log_var = vae_encode(conf, params, x)
    out = []
    for s in range(n):
        eps = common.draw_normal(fold_in(common.key_words(key), s),
                                 mean.shape, mean.dtype, mean.device)
        z = mean + torch.exp(0.5 * log_var) * eps
        out.append(neg_log_prob(conf.reconstruction_distribution, x,
                                vae_decode(conf, params, z)))
    return out, mean, log_var


def vae_pretrain_loss(conf, params, x, key):
    """The negative ELBO averaged over the batch: the reconstruction's
    -log p averaged over `num_samples` draws, plus KL(q(z|x) || N(0, I))."""
    nlp, mean, log_var = _samples(conf, params, x, key, conf.num_samples)
    recon = sum(nlp[1:], nlp[0]) / conf.num_samples
    kl = -0.5 * (1 + log_var - mean ** 2 - torch.exp(log_var)).sum(-1)
    return (recon + kl).mean()


def vae_reconstruction_prob(conf, params, x, key, num_samples=None):
    """Per-example log p(x) estimate, logsumexp over the samples less
    log(n) (reference `vae_reconstruction_prob`)."""
    n = num_samples or conf.num_samples
    nlp, _, _ = _samples(conf, params, x, key, n)
    return torch.logsumexp(-torch.stack(nlp), dim=0) - math.log(float(n))
