"""Superstep training on the card: K train steps captured as one CUDA graph
and replayed (counterpart of `deeplearning4j_tpu/nn/superstep.py`, whose
K steps are one `lax.scan` dispatch).

`run(net, block)` trains a stacked block (`datasets/iterators.py`
`Superbatch` or `MultiSuperbatch`, K batches of one signature) and returns
its K losses as device scalars. The first block of a `(K, signature)` is
captured: one step of its first batch runs eagerly on a side stream and is
undone (params, state, updater state and key put back), so every kernel is
built and every cuBLAS and cuDNN handle made before capture; then the K
steps, forward, backward, the fused update (row 9) and the loss-scale
pair, are captured into one `torch.cuda.CUDAGraph` reading the block from
static input tensors, and the graph is replayed, for that block and every
later one of the signature: the block is copied into the static inputs
and the graph replayed. A net keeps the graphs of the last `KEEP`
signatures it trained; a further signature drops the graph (and its
memory pool) used longest ago. So epochs of full blocks and a shorter
tail capture two graphs in the first epoch and only replay after it.

This module is the one that knows about capture. It hands the steps it
warms up or captures a step context (`net._step_ctx`, `_StepContext`),
which the engine consults at two points: `_next_rng` has it wrap each step
key, and the fused update takes its scalar slots.

What a replay would otherwise get wrong, and what is done about it:
- Row 9's step scalars (Adam's bias corrections, the scheduled lrs) are
  host values that a launch bakes in. The captured launches take them
  from a device buffer instead (`fused_update.ScalarSlots`, the kernel's
  device-scalar form), which the host fills for the K steps of the block
  with one copy before each replay, with the values the host form would
  compute.
- Dropout draws come from a generator seeded on the host from the step's
  key. A captured step's key carries the context as its draw route
  (`nn/layers/common.py`): each draw takes a generator registered with
  the graph (`CUDAGraph.register_generator_state`), seeded before a replay
  from the key the per-batch path would use for that draw (the K step
  keys are split on the host, `nn/prng.py`), so the masks are the
  per-batch path's.
- The layer and updater state a step replaces (BatchNorm running
  statistics) is copied back into the tensors the first step read, inside
  the graph, so each replay starts from the last one's end.
- The launch counts (`kernels.launches`) tick when a wrapper launches;
  under capture nothing runs, so the capture's counts are taken back and
  every replay adds them again (`kernels.shift_counts`): a replay counts K
  steps' launches. These counts are the capture's; `chip_smoke.py`
  profiles a replay and holds the kernels it ran to them.
- A net the graph cannot hold (an updater without the fused body, whose
  step arithmetic runs as host floats; a draw keyed otherwise than by a
  layer key; state a step adds) runs its blocks step by step on the card
  (`run` returns None): the same steps, launched one by one.

The step has no host sync (`engine.py`): the loss stays on the device, the
loss scale's decisions are device selects, the fused update reads its
skip flag on the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.datasets.iterators import MultiSuperbatch
from deeplearning4j_tpu_torch.kernels import fused_update
from deeplearning4j_tpu_torch.nn.prng import LayerKey, split


class _Uncapturable(Exception):
    pass


def _layout(sb):
    if isinstance(sb, MultiSuperbatch):
        return ("mds", len(sb.features), len(sb.labels),
                None if sb.features_masks is None else len(sb.features_masks),
                None if sb.labels_masks is None else len(sb.labels_masks))
    return ("ds",)


def _parts(sb) -> list:
    if isinstance(sb, MultiSuperbatch):
        return (list(sb.features) + list(sb.labels)
                + list(sb.features_masks or []) + list(sb.labels_masks or []))
    return [sb.features, sb.labels, sb.features_mask, sb.labels_mask]


def _with_parts(sb, parts):
    if isinstance(sb, MultiSuperbatch):
        _, nf, nl, nfm, nlm = _layout(sb)
        at = [0]

        def take(n):
            if n is None:
                return None
            out = parts[at[0]:at[0] + n]
            at[0] += n
            return out
        return MultiSuperbatch(take(nf), take(nl), take(nfm), take(nlm),
                               k=sb.k)
    return type(sb)(*parts, k=sb.k)


def _signature(sb) -> tuple:
    return (sb.k, _layout(sb), tuple(
        None if a is None else (tuple(a.shape), str(a.dtype))
        for a in _parts(sb)))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _copy_back(start, end) -> None:
    """Copy every leaf of `end` that is not `start`'s leaf at its path into
    that leaf (inside the capture: the graph ends where it began)."""
    have = dict(_leaves(start))
    for path, t in _leaves(end):
        s = have.get(path)
        if s is None:
            raise _Uncapturable(f"a step adds state {path}")
        if t is not s:
            s.copy_(t)


def _shallow(tree):
    return {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


def _trained(net):
    """The params a step writes: its frozen leaves (`nn/transfer.py`)
    it never touches, so the warm-up neither copies nor restores them."""
    spec = net._frozen_spec
    return {v: {k: t for k, t in p.items() if k not in spec.get(v, ())}
            for v, p in net.params_tree.items()}


def _snapshot(net):
    values = [t for tree in (_trained(net), net.state, net.opt_state)
              for _, t in _leaves(tree)]
    with torch.no_grad():
        return (_shallow(net.state), _shallow(net.opt_state),
                net._train_rng.copy(), net._score,
                [(t, t.clone()) for t in values])


def _restore(net, snap) -> None:
    state, opt, rng, score, values = snap
    net.state, net.opt_state = _shallow(state), _shallow(opt)
    with torch.no_grad():
        for t, v in values:
            t.copy_(v)
    net._train_rng, net._score = rng, score
    net._compute_params = None


def _capturable(net) -> bool:
    """Every layer that trains (one with a trainable leaf: frozen leaves
    never reach the update) has the fused update, whose scalars the
    replay refills; another updater's step arithmetic is host floats the
    graph would bake in."""
    trained = _trained(net)
    return all(not trained.get(name)
               or net._updaters[name].fused is not None
               for name in net._layer_confs)


# Graphs a net keeps: a full-K block's and a tail's.
KEEP = 2


class _StepKey(np.ndarray):
    """A captured step's key (`uint32[2]`, as `split` makes it) that
    carries its step context as the draw route (`draws`, read by
    `nn/layers/common.py`) and the step's place in the block (`step`)."""


class _StepContext:
    """What the engine consults while a superstep's steps are warmed up or
    captured (`net._step_ctx`): `step_key` wraps each step key, `slots` is
    the fused update's `ScalarSlots` (None in the warm-up). As a draw route
    it notes each layer-keyed draw in `draws` as `(generator, step, layer
    index, split path)` and gives it its generator: under capture the next
    of `gens`; in the warm-up none (the draw takes a fresh one). A draw
    from a key derived on the host no replay could seed: the warm-up notes
    it in `refused`, the capture stops."""

    def __init__(self, slots=None, gens=None):
        self.slots, self.steps = slots, 0
        self.gens = None if gens is None else iter(gens)
        self.draws, self.refused = [], None

    def step_key(self, sub) -> _StepKey:
        key = np.asarray(sub).view(_StepKey)
        key.draws, key.step = self, self.steps
        self.steps += 1
        return key

    def _refuse(self, why: str) -> None:
        if self.gens is not None:
            raise _Uncapturable(why)
        self.refused = self.refused or why

    def derived(self, key) -> None:
        self._refuse("a draw from a key derived on the host")

    def generator(self, key, device) -> Optional[torch.Generator]:
        if not isinstance(key, LayerKey):
            self._refuse("a draw from a step key itself")
            return None
        gen = None
        if self.gens is not None:
            gen = next(self.gens, None)
            if gen is None:
                raise _Uncapturable("more draws than the warm-up made")
        self.draws.append((gen, key.step_key.step, key.index, key.path))
        return gen


class _Block:
    """One captured signature: the graph, its static inputs and losses,
    its dropout generators `(gen, step, layer index, split path)`, its
    scalar slots, the launch counts of one replay, the iteration it was
    captured at, how often it was captured and replayed. A dropped block
    keeps its counts only."""

    def __init__(self, graph, statics, losses, draws, slots, delta, base):
        self.graph, self.statics, self.losses = graph, statics, losses
        self.draws, self.slots, self.delta = draws, slots, delta
        self.base, self.k = base, len(losses)
        self.captures, self.replays = 1, 0

    def drop(self) -> None:
        self.graph = self.statics = self.losses = None
        self.draws = self.slots = None


def run(net, sb, hit=None, miss=None) -> Optional[List[torch.Tensor]]:
    """Train block `sb` on the card (see the module docstring); returns its
    K losses, or None when the net cannot be captured (the caller then
    runs the steps one by one). The iteration is left where it was.
    `miss` and `hit` (counters: the engine's `dl4j_jit_cache_*_total`)
    count a capture and a replay of a kept graph."""
    blocks = net.__dict__.setdefault("_superstep_blocks", {})
    sig = _signature(sb)
    if sig in blocks:
        blk = blocks.pop(sig)
        if blk is not None and hit is not None:
            hit.inc()
    else:
        while len(blocks) >= KEEP:
            old = next(iter(blocks))
            _retire(net, old, blocks.pop(old))
        blk = _capture(net, sb)
        if blk is not None and miss is not None:
            miss.inc()
    blocks[sig] = blk  # the last one used, last
    return None if blk is None else _replay(net, blk, sb)


def _retire(net, sig, blk) -> None:
    """Free a block's graph and memory pool; its counts join those of the
    signature's earlier blocks."""
    if blk is None:
        return
    blk.drop()
    done = net.__dict__.setdefault("_superstep_done", {})
    old = done.get(sig)
    if old is None:
        done[sig] = blk
    else:
        old.captures += blk.captures
        old.replays += blk.replays


def captured(net) -> List[_Block]:
    """The net's captured blocks: the dropped ones (graph freed, counts
    kept, one a signature) first, then those it keeps, the last used last
    (for tests and `chip_smoke.py`)."""
    return list(getattr(net, "_superstep_done", {}).values()) + [
        b for b in getattr(net, "_superstep_blocks", {}).values()
        if b is not None]


def _capture(net, sb) -> Optional[_Block]:
    if not _capturable(net):
        return None
    dev = net.device
    statics = [None if a is None else torch.as_tensor(a, device=dev).clone()
               for a in _parts(sb)]
    static_sb = _with_parts(sb, statics)
    k = int(sb.k)

    # The warm-up step, undone: builds the kernels and handles, makes the
    # update tables, and counts the draws a step makes.
    snap = _snapshot(net)
    warm = _StepContext()
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    net._step_ctx = warm
    try:
        with torch.cuda.stream(side):
            net._sgd_step(static_sb.batch(0))
    finally:
        net._step_ctx = None
    cur.wait_stream(side)
    torch.cuda.synchronize(dev)
    _restore(net, snap)
    if warm.refused:
        return None

    gens = [torch.Generator(device=dev) for _ in range(k * len(warm.draws))]
    graph = torch.cuda.CUDAGraph()
    for gen in gens:
        graph.register_generator_state(gen)
    slots = fused_update.ScalarSlots(
        k * sum(fused_update.launch_scalars_floats(t)
                for t in net._update_tables.values()), dev)
    ctx = _StepContext(slots, gens)
    base, key0 = net.iteration, net._train_rng.copy()
    start_state, start_opt = _shallow(net.state), _shallow(net.opt_state)
    before = kernels.counts()
    net._step_ctx = ctx
    ok = False
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            scores = []
            for j in range(k):
                net.iteration = base + j
                net._sgd_step(static_sb.batch(j))
                scores.append(net._score.reshape(()))
            losses = torch.stack(scores)
            _copy_back(start_state, net.state)
            _copy_back(start_opt, net.opt_state)
        ok = len(ctx.draws) == len(gens)
    except _Uncapturable:
        ok = False
    finally:
        net._step_ctx = None
        net.iteration = base
        net.state, net.opt_state = start_state, start_opt
        net._train_rng = key0
        net._compute_params = None
        delta = kernels.count_delta(before, kernels.counts())
        kernels.shift_counts(delta, -1)
    if not ok:
        return None
    return _Block(graph, statics, losses, ctx.draws, slots, delta, base)


def _replay(net, blk: _Block, sb) -> List[torch.Tensor]:
    dev = net.device
    for s, a in zip(blk.statics, _parts(sb)):
        if s is not None:
            s.copy_(torch.as_tensor(a, device=dev), non_blocking=True)
    subs = []
    for _ in range(int(sb.k)):
        net._train_rng, sub = split(net._train_rng)
        subs.append(sub)
    for gen, step, index, path in blk.draws:
        w0, w1 = (int(w) for w in LayerKey(subs[step], index, path).words)
        gen.manual_seed((w0 << 32) | w1)
    blk.slots.fill(net.iteration - blk.base)
    blk.graph.replay()
    blk.replays += 1
    kernels.shift_counts(blk.delta, 1)
    net._compute_params = None
    return list(blk.losses.clone().unbind(0))
