"""Batched skip-gram / CBOW updates (counterpart of
`deeplearning4j_tpu/ops/skipgram.py`).

The reference's programs here are `jax.jit` graphs of gathers, einsums,
`segment_sum` scatter-adds and elementwise ops, with no Pallas kernel; the
port runs the same ops as PyTorch ops on the tables' device. A BATCH of
(center, target) pairs is one update: gather -> sigmoid cross-entropy ->
scatter-add (`index_add_`) of the per-row updates, each row's AGGREGATED
update capped in norm (`_clip_rows`) before it is added. The tables are
updated in place (the reference donates them) and returned.

Every batch is padded to a fixed size; `pair_mask` marks the real pairs, and
a padding pair contributes nothing. A scan of K batches (`*_scan*`) is the
K single steps applied in order on the device, from one upload of the
stacked [K, B] arrays, with the same result as K single steps.

On CUDA `index_add_` adds in an order that varies between runs, so a card's
tables equal the CPU's within a tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_EXP = 6.0  # word2vec exp-table range; gradients are cut off beyond it
MAX_ROW_UPDATE_NORM = 1.0  # L2 cap on a row's AGGREGATED per-batch update


def _clip_rows(update: torch.Tensor) -> torch.Tensor:
    """Cap each row's aggregated update norm (the reference's `_clip_rows`:
    a batched scatter-add applies all collided updates against the same
    stale state, which diverges when one row collects many contributions;
    normal aggregates sit far below the cap)."""
    norm = torch.linalg.vector_norm(update, dim=-1, keepdim=True)
    return update * torch.clamp(
        MAX_ROW_UPDATE_NORM / torch.clamp(norm, min=1e-12), max=1.0)


def _segment_sum(src: torch.Tensor, idx: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """`jax.ops.segment_sum(src, idx, num_segments=n)` for [N, D] rows."""
    out = torch.zeros((n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    return out.index_add_(0, idx, src)


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for an index tensor of any shape (no host sync)."""
    return table.index_select(0, idx.reshape(-1)).view(
        *idx.shape, table.shape[-1])


def _apply(table: torch.Tensor, contrib: torch.Tensor,
           idx: torch.Tensor) -> None:
    """table += clip(segment_sum(contrib, idx)), over all of table's rows."""
    table.add_(_clip_rows(_segment_sum(contrib, idx.reshape(-1),
                                       table.shape[0])))


def _hs_grad(h, nodes, codes, mask, lr):
    """HS output step: g [B, L] with the word2vec cut-off (a node whose
    |logit| reaches MAX_EXP contributes no update)."""
    logits = torch.einsum("bd,bld->bl", h, nodes)
    f = torch.sigmoid(logits)
    g = (1.0 - codes.to(h.dtype) - f) * lr * mask
    return torch.where(logits.abs() < MAX_EXP, g, torch.zeros_like(g))


def _ns_grad(h, tv, labels, pair_mask, lr):
    """NS output step: g [B, 1+K] with word2vec's saturation: (label-1)*lr
    above +MAX_EXP, label*lr below -MAX_EXP."""
    logits = torch.einsum("bd,bkd->bk", h, tv)
    f = torch.sigmoid(logits)
    lab = labels.to(h.dtype)
    pm = pair_mask[:, None]
    g = (lab - f) * lr * pm
    g = torch.where(logits > MAX_EXP, (lab - 1.0) * lr * pm, g)
    return torch.where(logits < -MAX_EXP, lab * lr * pm, g)


def _context_mean(syn0, context, context_mask, pair_mask):
    """CBOW's h = mean of the real context vectors, and the mask used."""
    cm = context_mask * pair_mask[:, None]
    counts = torch.clamp(cm.sum(dim=1, keepdim=True), min=1.0)
    ctx = _gather(syn0, context) * cm[:, :, None]
    return ctx.sum(dim=1) / counts, cm


def _outer(g, h):
    """Per-(pair, node) row updates g[b, l] * h[b], flattened [B*L, D]."""
    return (g[:, :, None] * h[:, None, :]).reshape(-1, h.shape[-1])


def hs_skipgram_step(syn0, syn1, centers, codes, points, code_mask,
                     pair_mask, lr):
    """Hierarchical-softmax skip-gram update (reference :38).

    syn0 [V, D] word vectors, syn1 [I, D] inner-node vectors, updated in
    place. centers [B]: the word whose vector is updated; codes / points /
    code_mask [B, L]: the Huffman paths of the predicted word; pair_mask
    [B]; lr a float or a 0-d tensor."""
    m = code_mask * pair_mask[:, None]
    h = syn0.index_select(0, centers)
    nodes = _gather(syn1, points)
    g = _hs_grad(h, nodes, codes, m, lr)
    # dL/dh from the old syn1 (word2vec's update order).
    h_grad = torch.einsum("bl,bld->bd", g, nodes)
    _apply(syn1, _outer(g, h), points)
    _apply(syn0, h_grad, centers)
    return syn0, syn1


def ns_skipgram_step(syn0, syn1neg, centers, targets, labels, pair_mask, lr):
    """Negative-sampling skip-gram update (reference :74). targets [B, 1+K]
    (the positive word first, then K negatives); labels [B, 1+K] 1/0."""
    h = syn0.index_select(0, centers)
    tv = _gather(syn1neg, targets)
    g = _ns_grad(h, tv, labels, pair_mask, lr)
    h_grad = torch.einsum("bk,bkd->bd", g, tv)
    _apply(syn1neg, _outer(g, h), targets)
    _apply(syn0, h_grad, centers)
    return syn0, syn1neg


def ns_cbow_step(syn0, syn1neg, context, context_mask, targets, labels,
                 pair_mask, lr):
    """Negative-sampling CBOW update (reference :102): h = mean of the
    context vectors, trained against the positive word and K negatives;
    every context word gets the full input gradient. context /
    context_mask [B, W]."""
    h, cm = _context_mean(syn0, context, context_mask, pair_mask)
    tv = _gather(syn1neg, targets)
    g = _ns_grad(h, tv, labels, pair_mask, lr)
    h_grad = torch.einsum("bk,bkd->bd", g, tv)
    _apply(syn1neg, _outer(g, h), targets)
    _apply(syn0, _outer(cm, h_grad), context)
    return syn0, syn1neg


def hs_cbow_step(syn0, syn1, context, context_mask, codes, points, code_mask,
                 pair_mask, lr):
    """Hierarchical-softmax CBOW update (reference :141): h = mean of the
    context vectors; each context word gets the full input gradient."""
    h, cm = _context_mean(syn0, context, context_mask, pair_mask)
    nodes = _gather(syn1, points)
    g = _hs_grad(h, nodes, codes, code_mask * pair_mask[:, None], lr)
    h_grad = torch.einsum("bl,bld->bd", g, nodes)
    _apply(syn1, _outer(g, h), points)
    _apply(syn0, _outer(cm, h_grad), context)
    return syn0, syn1


def hs_skipgram_step_tbl(syn0, syn1, centers, words, codes_tbl, points_tbl,
                         cmask_tbl, pair_mask, lr):
    """HS skip-gram with device-resident Huffman tables [V, L] (reference
    :176): the [B, L] paths are gathered on the tables' device, so a flush
    uploads only its [B] indices."""
    return hs_skipgram_step(
        syn0, syn1, centers, codes_tbl.index_select(0, words),
        points_tbl.index_select(0, words), cmask_tbl.index_select(0, words),
        pair_mask, lr)


def hs_cbow_step_tbl(syn0, syn1, context, context_mask, words, codes_tbl,
                     points_tbl, cmask_tbl, pair_mask, lr):
    """HS CBOW with device-resident Huffman tables (reference :189)."""
    return hs_cbow_step(
        syn0, syn1, context, context_mask, codes_tbl.index_select(0, words),
        points_tbl.index_select(0, words), cmask_tbl.index_select(0, words),
        pair_mask, lr)


def hs_skipgram_scan_tbl(syn0, syn1, centers, words, codes_tbl, points_tbl,
                         cmask_tbl, pair_mask, lrs):
    """K stacked HS skip-gram batches (reference :198): centers / words /
    pair_mask [K, B], lrs [K]; the K steps in order."""
    for k in range(centers.shape[0]):
        hs_skipgram_step_tbl(syn0, syn1, centers[k], words[k], codes_tbl,
                             points_tbl, cmask_tbl, pair_mask[k], lrs[k])
    return syn0, syn1


def hs_cbow_scan_tbl(syn0, syn1, context, context_mask, words, codes_tbl,
                     points_tbl, cmask_tbl, pair_mask, lrs):
    """K stacked HS CBOW batches (reference :220): context / context_mask
    [K, B, W]; words / pair_mask [K, B]; lrs [K]."""
    for k in range(context.shape[0]):
        hs_cbow_step_tbl(syn0, syn1, context[k], context_mask[k], words[k],
                         codes_tbl, points_tbl, cmask_tbl, pair_mask[k],
                         lrs[k])
    return syn0, syn1


def ns_skipgram_scan(syn0, syn1neg, centers, targets, labels, pair_mask,
                     lrs):
    """K stacked NS skip-gram batches (reference :237): centers / pair_mask
    [K, B], targets [K, B, 1+K']; labels [B, 1+K'] shared by the K
    batches (a constant, uploaded once); lrs [K]."""
    for k in range(centers.shape[0]):
        ns_skipgram_step(syn0, syn1neg, centers[k], targets[k], labels,
                         pair_mask[k], lrs[k])
    return syn0, syn1neg


def ns_cbow_scan(syn0, syn1neg, context, context_mask, targets, labels,
                 pair_mask, lrs):
    """K stacked NS CBOW batches (reference :255); labels shared."""
    for k in range(context.shape[0]):
        ns_cbow_step(syn0, syn1neg, context[k], context_mask[k], targets[k],
                     labels, pair_mask[k], lrs[k])
    return syn0, syn1neg


class ScanDispatchQueue:
    """The K-flush dispatch protocol shared by Word2Vec and ParagraphVectors
    (reference :272): enqueue flush batches; at `k` of them, hand the whole
    list to `dispatch_many` (one upload, K steps); a leftover short of `k`
    goes through `dispatch_one` per batch."""

    def __init__(self, k: int, dispatch_many, dispatch_one):
        self.k = int(k)
        self._many = dispatch_many
        self._one = dispatch_one
        self._q = []

    def add(self, item) -> None:
        self._q.append(item)
        if len(self._q) == self.k:
            self._many(self._q)
            self._q.clear()

    def drain(self) -> None:
        """Dispatch whatever is queued (call once at end of training)."""
        if not self._q:
            return
        if len(self._q) == self.k:
            self._many(self._q)
        else:
            for item in self._q:
                self._one(item)
        self._q.clear()


class Uploader:
    """Host arrays to the tables' device for the fits' flushes.

    On the CPU an array becomes a tensor over the same memory. On the card
    each upload goes through a ring of `depth` slots of pinned staging
    buffers, copied with `non_blocking=True`, so a flush makes no
    synchronizing call: `put` fills the next slot (waiting first for the
    event recorded behind the last step that read it, which has long run
    by then), and `done` records that event behind the steps just
    enqueued. `uploads` and `bytes` count what went over."""

    def __init__(self, device, depth: int = 4):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._slots = [{"bufs": {}, "event": None} for _ in range(depth)]
        self._next = 0
        self._open = None
        self._pos = 0  # arrays put into the open slot so far
        self.uploads = 0
        self.bytes = 0

    def put(self, *arrays):
        """Device tensors of `arrays` (numpy), uploaded in one slot."""
        if self._open is None:
            self._open = self._slots[self._next]
            self._next = (self._next + 1) % len(self._slots)
            if self._open["event"] is not None:
                self._open["event"].synchronize()
            self._pos = 0
        out = []
        for a in arrays:
            a = np.ascontiguousarray(a)
            self.uploads += 1
            self.bytes += a.nbytes
            if not self.cuda:
                out.append(torch.from_numpy(a))
                continue
            key = (self._pos, a.shape, a.dtype.str)
            self._pos += 1
            host = self._open["bufs"].get(key)
            if host is None:
                host = torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                   pin_memory=True)
                self._open["bufs"][key] = host
            host.numpy()[...] = a
            out.append(host.to(self.device, non_blocking=True))
        return out

    def done(self) -> None:
        """Mark the open slot read by the steps enqueued since `put`."""
        if self._open is None:
            return
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self._open["event"] = ev
        self._open = None


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A one-time upload (tables, constants) of numpy `a`."""
    t = torch.as_tensor(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)
