"""The mixture-of-experts FFN on one device (counterpart of
`deeplearning4j_tpu/parallel/expert.py`): top-1 or top-2 routing with a
capacity per expert, the load-balance auxiliary loss and router jitter,
with the reference's semantics exactly:

- capacity C = max(1, int(capacity_factor * top_k * N / E)) over all N
  tokens, with no mask;
- a token's slot is its first-come rank among the same expert's tokens, in
  row-major token order; a token past C is dropped (its output is 0);
- top-2 takes the second choice by the highest remaining LOGIT (the first
  choice set to -inf); second choices queue behind every first choice; the
  two gates are renormalised with +1e-9;
- aux = E * sum_e(frac_e * mean_prob_e) over first choices only;
- jitter multiplies the router input by a uniform in [1 - eps, 1 + eps],
  in training only (`nn/layers/common.py` `draw_uniform`);
- the router and both expert matmuls run in at least f32 (the reference's
  `promote_types(x.dtype, f32)`): under `mixed_bfloat16` on the params the
  engine has already rounded to bf16; only y goes back to x's dtype.

The reference dispatches through dense [N, E, C] one-hot tensors and
einsums; each (token, expert) pair owns at most one slot, so an index
dispatch computes the same values without them: ranks from a cumsum over
the [N, E] one-hot, the kept tokens copied into an [E * C, D] buffer, two
`torch.bmm`s with w1 [E, D, H] and w2 [E, H, D], and y gathered back as
g1 * out[slot1] + g2 * out[slot2]. Autograd carries the gradients through
the copy and the gather. The same code runs on the CPU and on the card:
the reference computes this FFN outside Pallas too. Expert parallelism
over a mesh needs several cards (ROADMAP A.13) and is refused.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.nn.layers import common


def init_moe_params(generator: torch.Generator, d_model: int, d_hidden: int,
                    n_experts: int, dtype=torch.float32):
    """The reference's standalone init: He-normal tables with a leading [E]
    axis, zero biases (`torch.Generator` draws, not the reference's
    stream)."""
    s1 = (2.0 / d_model) ** 0.5
    s2 = (2.0 / d_hidden) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype)

    return {
        "gate_w": normal(d_model, n_experts) * s1,
        "w1": normal(n_experts, d_model, d_hidden) * s1,
        "b1": torch.zeros(n_experts, d_hidden, dtype=dtype),
        "w2": normal(n_experts, d_hidden, d_model) * s2,
        "b2": torch.zeros(n_experts, d_model, dtype=dtype),
    }


class Routing(NamedTuple):
    """Where each token goes. `expert` [k, N] its choices, `slot` [k, N]
    its row in the [E * C, D] expert buffer (e * C + rank), `keep` [k, N]
    whether the rank is under C, `gate` [k, N] its combine weight; `aux`
    the load-balance loss; `capacity` C."""
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor
    capacity: int


def capacity(n_tokens: int, n_experts: int, capacity_factor: float,
             top_k: int) -> int:
    return max(1, int(capacity_factor * top_k * n_tokens / n_experts))


def _ranks(expert: torch.Tensor, n_experts: int, base=None):
    """Each token's first-come rank among the tokens of its expert, after
    `base` [E] earlier claims."""
    onehot = torch.nn.functional.one_hot(expert, n_experts)
    rank = (torch.cumsum(onehot, dim=0) - 1).gather(1, expert[:, None])[:, 0]
    if base is not None:
        rank = rank + base[expert]
    return rank, onehot


def route(gate_w: torch.Tensor, x: torch.Tensor, *,
          capacity_factor: float = 1.25, top_k: int = 1, rng=None,
          jitter_eps: float = 0.0) -> Routing:
    """The router: x [N, D] at the accumulation dtype, gate_w [D, E]."""
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    n = x.shape[0]
    e = gate_w.shape[1]
    c = capacity(n, e, capacity_factor, top_k)
    x_router = x
    if rng is not None and jitter_eps > 0.0:
        x_router = x * common.draw_uniform(
            rng, 1.0 - jitter_eps, 1.0 + jitter_eps, x.shape, x.dtype,
            x.device)
    logits = x_router @ gate_w.to(x.dtype)                       # [N, E]
    probs = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(logits, dim=-1)
    gate1 = probs.gather(1, idx1[:, None])[:, 0]
    rank1, onehot1 = _ranks(idx1, e)
    frac = onehot1.to(probs.dtype).mean(0)
    aux = e * (frac * probs.mean(0)).sum()
    if top_k == 1:
        expert, rank, gate = idx1[None], rank1[None], gate1[None]
    else:
        logits2 = logits.masked_fill(onehot1.bool(), float("-inf"))
        idx2 = torch.argmax(logits2, dim=-1)
        gate2 = probs.gather(1, idx2[:, None])[:, 0]
        denom = gate1 + gate2 + 1e-9
        rank2, _ = _ranks(idx2, e, base=onehot1.sum(0))
        expert = torch.stack([idx1, idx2])
        rank = torch.stack([rank1, rank2])
        gate = torch.stack([gate1 / denom, gate2 / denom])
    keep = rank < c
    slot = expert * c + rank.clamp(max=c - 1)
    return Routing(expert, slot, keep, gate, aux, c)


def moe_ffn(params, x: torch.Tensor, *, capacity_factor: float = 1.25,
            mesh=None, expert_axis: str = "expert", top_k: int = 1,
            rng=None, jitter_eps: float = 0.0, return_aux: bool = False,
            routing: Optional[list] = None):
    """Top-1 / top-2 routed MoE FFN, x [N, D] -> [N, D_out] (see the module
    docstring); `params` holds gate_w [D, E], w1 [E, D, H], b1 [E, H], w2
    [E, H, D_out], b2 [E, D_out]. With `return_aux`, (y, aux). A list
    given as `routing` gets this call's `Routing` appended."""
    if mesh is not None:
        raise NotImplementedError(
            f"moe_ffn: expert parallelism over a mesh (axis {expert_axis!r})"
            " needs several cards and is not in the port yet (ROADMAP A.13)")
    acc = torch.promote_types(x.dtype, torch.float32)
    xa = x.to(acc)
    r = route(params["gate_w"], xa, capacity_factor=capacity_factor,
              top_k=top_k, rng=rng, jitter_eps=jitter_eps)
    if routing is not None:
        routing.append(r)
    e, c = params["gate_w"].shape[1], r.capacity
    d = xa.shape[1]
    # Every kept (token, choice) owns one slot: copy the tokens in. A
    # dropped one goes to a spare row past the buffer, which no expert
    # reads (so it gets no gradient), and no host sync compacts the list.
    rows = torch.where(r.keep, r.slot, e * c).reshape(-1)
    expert_in = xa.new_zeros(e * c + 1, d).index_copy(
        0, rows, xa.repeat(r.slot.shape[0], 1))[:e * c]
    h = torch.relu(torch.bmm(expert_in.view(e, c, d), params["w1"].to(acc))
                   + params["b1"].to(acc)[:, None, :])
    out = (torch.bmm(h, params["w2"].to(acc))
           + params["b2"].to(acc)[:, None, :]).reshape(e * c, -1)
    weight = r.gate * r.keep.to(acc)
    y = weight[0, :, None] * out[r.slot[0]]
    for k in range(1, r.slot.shape[0]):
        y = y + weight[k, :, None] * out[r.slot[k]]
    y = y.to(x.dtype)
    return (y, r.aux) if return_aux else y

