"""Model zoo (counterpart of `deeplearning4j_tpu/models/zoo.py`), every
conf built through the config DSL as the reference builds it:
`transformer_lm` (dense or with MoE FFNs), the GravesLSTM
`char_rnn`, the MNIST models `mlp_mnist` and `lenet_mnist`, `vgg16`,
`alexnet` (LRN, dropout 0.5) and `transformer_classifier` (ragged batches
under features masks); token sampling (one sequence or a
batch), `generate_lm`, `generate_lm_batch`, and the step-granular decode
steppers the serving scheduler drives (dense per-slot KV caches, or a paged
KV pool), with the speculative verify step `step_k` and `rewind_all`.

Ids travel as int64 tensors: the reference feeds its steppers float32 ids,
which a bf16 compute policy rounds (ids above 256 stop being exact); the
port's integer ids reach the embedding gather untouched.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.kv_pool import KVPagePool
from deeplearning4j_tpu_torch.nn import rnn_state as rnn_mod
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer,
    DenseLayer,
    EmbeddingLayer,
    GlobalPoolingLayer,
    GravesLSTM,
    LayerNormalization,
    LocalResponseNormalization,
    MoELayer,
    OutputLayer,
    PositionalEmbeddingLayer,
    RnnOutputLayer,
    SelfAttentionLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.engine import to_numpy


def _add_transformer_block(gb, prev, i, d_model, n_heads, *, causal,
                           moe=False, n_experts=4,
                           decode_cache_length=None):
    """One pre-LN block, x + Attn(LN(x)); x + FFN(LN(x)), with the
    reference's vertex names. The FFN is a DenseLayer pair, or a MoELayer
    when `moe` (top-2 of `n_experts` experts of 4 * d_model, jitter
    1e-2)."""
    gb.add_layer(f"ln_a{i}", LayerNormalization(), prev)
    gb.add_layer(f"attn{i}", SelfAttentionLayer(
        n_out=d_model, n_heads=n_heads, causal=causal,
        decode_cache_length=decode_cache_length), f"ln_a{i}")
    gb.add_vertex(f"res_a{i}", ElementWiseVertex(op="add"), prev, f"attn{i}")
    gb.add_layer(f"ln_f{i}", LayerNormalization(), f"res_a{i}")
    if moe:
        gb.add_layer(f"ffn{i}", MoELayer(
            n_out=d_model, n_experts=n_experts, expert_hidden=4 * d_model,
            top_k=2, router_jitter=1e-2), f"ln_f{i}")
    else:
        gb.add_layer(f"ff1_{i}", DenseLayer(n_out=4 * d_model,
                                            activation="relu"), f"ln_f{i}")
        gb.add_layer(f"ffn{i}", DenseLayer(n_out=d_model,
                                           activation="identity"),
                     f"ff1_{i}")
    gb.add_vertex(f"res_f{i}", ElementWiseVertex(op="add"), f"res_a{i}",
                  f"ffn{i}")
    return f"res_f{i}"


def _transformer_start(d_model, seed, lr, dtype, max_length,
                       stateful=False):
    return (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(lr).updater("adam").dtype(dtype)
            .weight_init("xavier")
            .graph_builder()
            .add_inputs("tokens")
            .add_layer("emb", EmbeddingLayer(
                n_out=d_model, has_bias=False, input_format="ids",
                activation="identity"), "tokens")
            .add_layer("pos", PositionalEmbeddingLayer(
                max_length=max_length, stateful=stateful), "emb"))


def transformer_lm(vocab_size: int, *, t: int = 64, d_model: int = 64,
                   n_heads: int = 4, n_blocks: int = 2, moe: bool = False,
                   n_experts: int = 4, seed: int = 123, lr: float = 3e-3,
                   dtype: str = "float32",
                   decode_cache_length: Optional[int] = None
                   ) -> ComputationGraphConfiguration:
    """Decoder-only pre-LN transformer LM, built through the graph builder
    as the reference builds it: embedding + learned positions, `n_blocks`
    of x + Attn(LN(x)); x + FFN(LN(x)), a final LN and a softmax mcxent
    output; Adam at `lr`. `decode_cache_length=N` sizes every attention
    layer's KV cache (and the positional table) for stateful decode. `t`
    only sets the positional table's floor and the input type."""
    gb = _transformer_start(d_model, seed, lr, dtype,
                            max(t, 16, decode_cache_length or 0),
                            stateful=decode_cache_length is not None)
    prev = "pos"
    for i in range(n_blocks):
        prev = _add_transformer_block(
            gb, prev, i, d_model, n_heads, causal=True, moe=moe,
            n_experts=n_experts, decode_cache_length=decode_cache_length)
    gb.add_layer("ln_out", LayerNormalization(), prev)
    gb.add_layer("out", RnnOutputLayer(n_out=vocab_size, activation="softmax",
                                       loss_function="mcxent"), "ln_out")
    return (gb.set_outputs("out")
            .set_input_types(InputType.recurrent(vocab_size, t)).build())


def transformer_classifier(vocab_size: int, n_classes: int, *, t: int = 64,
                           d_model: int = 64, n_heads: int = 4,
                           n_blocks: int = 2, seed: int = 123,
                           lr: float = 3e-3, dtype: str = "float32"
                           ) -> ComputationGraphConfiguration:
    """The LM's bidirectional sibling: non-causal blocks, mean pooling over
    time, a softmax mcxent head. Ragged batches run under a features mask:
    attention leaves the padded keys out, pooling the padded steps
    (`examples/text_classifier.py`)."""
    gb = _transformer_start(d_model, seed, lr, dtype, max(t, 16))
    prev = "pos"
    for i in range(n_blocks):
        prev = _add_transformer_block(gb, prev, i, d_model, n_heads,
                                      causal=False)
    gb.add_layer("ln_out", LayerNormalization(), prev)
    gb.add_layer("pool", GlobalPoolingLayer(pooling_type="avg"), "ln_out")
    gb.add_layer("out", OutputLayer(n_out=n_classes, activation="softmax",
                                    loss_function="mcxent"), "pool")
    return (gb.set_outputs("out")
            .set_input_types(InputType.recurrent(vocab_size, t)).build())


def char_rnn(vocab_size: int = 77, hidden: int = 200, layers: int = 2,
             tbptt_length: int = 50, seed: int = 12345,
             dtype: str = "float32") -> MultiLayerConfiguration:
    """The reference's GravesLSTM character model (its example is
    GravesLSTMCharModellingExample): `layers` GravesLSTMs of `hidden` units
    (tanh cell, sigmoid gates, peepholes) and a softmax mcxent
    RnnOutputLayer over `vocab_size`; RMSProp at lr 0.1 with rms_decay
    0.95, l2 1e-3, xavier init; truncated BPTT in chunks of
    `tbptt_length` steps."""
    builder = (NeuralNetConfiguration.builder()
               .seed(seed).learning_rate(0.1).updater("rmsprop")
               .rms_decay(0.95).weight_init("xavier").l2(0.001).dtype(dtype)
               .list())
    for _ in range(layers):
        builder.layer(GravesLSTM(n_out=hidden, activation="tanh"))
    builder.layer(RnnOutputLayer(n_out=vocab_size, activation="softmax",
                                 loss_function="mcxent"))
    return (builder.backprop_type("truncatedbptt")
            .t_bptt_forward_length(tbptt_length)
            .t_bptt_backward_length(tbptt_length)
            .set_input_type(InputType.recurrent(vocab_size)).build())


def mlp_mnist(seed: int = 123, lr: float = 0.006) -> MultiLayerConfiguration:
    """The reference's two-layer MLP on flat 28x28 images: dense 1000
    relu, softmax 10 (negative log-likelihood); Nesterovs 0.9 at `lr`, l2
    1e-4, xavier init."""
    return (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(lr).updater("nesterovs").momentum(0.9)
            .weight_init("xavier").l2(1e-4)
            .list()
            .layer(DenseLayer(n_out=1000, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss_function="negativeloglikelihood"))
            .set_input_type(InputType.feed_forward(784))
            .build())


def lenet_mnist(seed: int = 123, lr: float = 0.01,
                dtype: str = "float32") -> MultiLayerConfiguration:
    """The reference's LeNet (dl4j-examples LenetMnistExample) on 28x28x1
    NHWC images: conv 5x5x20, max-pool 2x2, conv 5x5x50, max-pool 2x2 (the
    builder puts a CnnToFeedForward preprocessor before the dense layer),
    dense 500 relu, softmax 10; Nesterovs 0.9 at `lr`, l2 5e-4, xavier
    init, identity activations by default."""
    return (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(lr).updater("nesterovs").momentum(0.9)
            .weight_init("xavier").l2(5e-4).activation("identity")
            .dtype(dtype)
            .list()
            .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                    n_out=20, activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                    n_out=50, activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss_function="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())


def vgg16(n_classes: int = 1000, seed: int = 123,
          dtype: str = "bfloat16") -> MultiLayerConfiguration:
    """VGG-16 as the reference configures it (the Keras VGG16 it imports):
    13 3x3 SAME relu convolutions in 5 blocks with 2x2 max pools, two dense
    4096 relu, softmax; Nesterovs 0.9 at lr 0.01, relu init."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).learning_rate(0.01).updater("nesterovs").momentum(0.9)
         .weight_init("relu").dtype(dtype)
         .list())
    for n, reps in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        for _ in range(reps):
            b.layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                     convolution_mode="same", n_out=n,
                                     activation="relu"))
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                 stride=(2, 2)))
    b.layer(DenseLayer(n_out=4096, activation="relu"))
    b.layer(DenseLayer(n_out=4096, activation="relu"))
    b.layer(OutputLayer(n_out=n_classes, activation="softmax",
                        loss_function="mcxent"))
    return b.set_input_type(InputType.convolutional(224, 224, 3)).build()


def alexnet(n_classes: int = 1000, seed: int = 123, image: int = 224,
            dtype: str = "bfloat16") -> MultiLayerConfiguration:
    """AlexNet as the reference configures it: conv 11x11/4 + LRN + pool,
    conv 5x5 + LRN + pool, three 3x3 convs, pool, two dense 4096 with
    dropout 0.5 (retain), softmax; Nesterovs 0.9 at lr 0.01, l2 5e-4."""
    conv = ConvolutionLayer
    pool = dict(pooling_type="max", kernel_size=(3, 3), stride=(2, 2))
    return (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(0.01).updater("nesterovs")
            .momentum(0.9).weight_init("xavier").l2(5e-4).dtype(dtype)
            .list()
            .layer(conv(kernel_size=(11, 11), stride=(4, 4), n_out=96,
                        activation="relu", convolution_mode="truncate"))
            .layer(LocalResponseNormalization())
            .layer(SubsamplingLayer(**pool))
            .layer(conv(kernel_size=(5, 5), stride=(1, 1), n_out=256,
                        activation="relu", convolution_mode="same"))
            .layer(LocalResponseNormalization())
            .layer(SubsamplingLayer(**pool))
            .layer(conv(kernel_size=(3, 3), stride=(1, 1), n_out=384,
                        activation="relu", convolution_mode="same"))
            .layer(conv(kernel_size=(3, 3), stride=(1, 1), n_out=384,
                        activation="relu", convolution_mode="same"))
            .layer(conv(kernel_size=(3, 3), stride=(1, 1), n_out=256,
                        activation="relu", convolution_mode="same"))
            .layer(SubsamplingLayer(**pool))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=n_classes, activation="softmax",
                               loss_function="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(image, image, 3))
            .build())


def _sample_token(probs, rng, temperature: float, top_k: int, top_p: float):
    """Sample one id from a [V] distribution (greedy at temperature <= 0;
    top-k / nucleus restrictions compose, applied before temperature;
    excluded tokens are masked to -inf so re-tempering cannot re-admit
    them). Same draws as the reference for the same `rng`."""
    probs = np.asarray(probs, np.float64)
    if temperature <= 0:
        return int(probs.argmax())
    if top_k:
        kth = np.sort(probs)[-min(top_k, len(probs))]
        probs = np.where(probs >= kth, probs, 0.0)
    if top_p:
        order = np.argsort(-probs)
        csum = np.cumsum(probs[order]) - probs[order]
        cut = order[csum >= top_p * probs.sum()]
        probs = probs.copy()
        probs[cut] = 0.0
    logits = np.log(np.maximum(probs, 1e-12)) / temperature
    logits[probs <= 0] = -np.inf
    p = np.exp(logits - logits.max())
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


def _sample_tokens(probs, rng, temperature: float, top_k: int):
    """Batched `_sample_token`: [B, V] probabilities -> [B] ids, one rng
    draw per row in row order (a Python loop over rows draws the same), so
    seeded generations are reproducible. Excluded tokens are masked to
    -inf as on the single-sequence path."""
    probs = np.asarray(probs, np.float64)
    if temperature <= 0:
        return probs.argmax(-1)
    if top_k:
        kth = np.sort(probs, axis=-1)[:, -min(top_k, probs.shape[-1])]
        probs = np.where(probs >= kth[:, None], probs, 0.0)
    logits = np.log(np.maximum(probs, 1e-12)) / temperature
    logits[probs <= 0] = -np.inf
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.asarray([rng.choice(p.shape[-1], p=p[i])
                       for i in range(p.shape[0])])


def decode_cache_capacity(cg) -> int:
    """Smallest `decode_cache_length` across the attention layers: the
    per-sequence step budget. Raises for a model without a KV cache."""
    caps = [v.layer.decode_cache_length
            for v in cg.layer_vertices.values()
            if isinstance(v.layer, SelfAttentionLayer)]
    if not caps or any(c is None for c in caps):
        raise ValueError(
            "model has no KV cache; build it with "
            "transformer_lm(..., decode_cache_length=N)")
    return min(caps)


def generate_lm(cg, prompt_ids, n_steps: int, *, window: int,
                temperature: float = 1.0, seed: int = 0,
                use_cache: bool = False, top_k: int = 0,
                top_p: float = 0.0) -> List[int]:
    """Autoregressive sampling; returns prompt + generated ids.
    `use_cache=False` re-reads the right-padded `window` each token;
    `use_cache=True` primes the KV cache with the prompt and then takes
    single-token `rnn_time_step`s."""
    rng = np.random.RandomState(seed)
    ids = [int(i) for i in prompt_ids]
    if not ids:
        raise ValueError("need at least one prompt token")

    def pick(probs):
        return _sample_token(probs, rng, temperature, top_k, top_p)

    if use_cache:
        cap = decode_cache_capacity(cg)
        if len(ids) + n_steps > cap:
            raise ValueError(
                f"prompt ({len(ids)}) + n_steps ({n_steps}) exceeds the "
                f"decode cache capacity {cap}")
        if n_steps == 0:
            return ids
        cg.rnn_clear_previous_state()
        out = cg.rnn_time_step(np.asarray(ids, np.int64)[None, :, None])[0]
        ids.append(pick(out[0, -1]))
        for _ in range(n_steps - 1):
            out = cg.rnn_time_step(np.asarray([[[ids[-1]]]], np.int64))[0]
            ids.append(pick(out[0, -1]))
        return ids

    for _ in range(n_steps):
        ctx = ids[-window:]
        x = np.zeros((1, window, 1), np.int64)
        x[0, :len(ctx), 0] = ctx
        out = cg.output_single(x)
        ids.append(pick(out[0, len(ctx) - 1]))
    return ids


def generate_lm_batch(cg, prompts, n_steps: int, *, temperature: float = 1.0,
                      seed: int = 0, top_k: int = 0) -> np.ndarray:
    """KV-cached batched generation: `prompts` is [B, Tp] (equal-length
    int prompts) and every sequence decodes in the same single-token
    `rnn_time_step`s, int64 ids throughout. Returns [B, Tp + n_steps] ids.
    Needs `decode_cache_length >= Tp + n_steps`."""
    rng = np.random.RandomState(seed)
    prompts = np.asarray(prompts, np.int64)
    if prompts.ndim != 2 or prompts.shape[1] < 1:
        raise ValueError("prompts must be [B, Tp] with Tp >= 1")
    tp = prompts.shape[1]
    try:
        cap = decode_cache_capacity(cg)
    except ValueError:
        raise ValueError("generate_lm_batch needs decode_cache_length")
    if tp + n_steps > cap:
        raise ValueError(
            f"Tp ({tp}) + n_steps ({n_steps}) exceeds the decode cache "
            f"capacity {cap}")
    out = [prompts]
    cg.rnn_clear_previous_state()
    step_out = cg.rnn_time_step(prompts[:, :, None])[0]  # [B, Tp, V]
    for _ in range(n_steps):
        nxt = np.asarray(_sample_tokens(step_out[:, -1], rng, temperature,
                                        top_k), np.int64)
        out.append(nxt[:, None])
        step_out = cg.rnn_time_step(nxt[:, None, None])[0]  # [B, 1, V]
    return np.concatenate(out, axis=1)


class DecodeStepper:
    """Step-granular decode over a fixed bank of `slots` for a
    `transformer_lm` graph: the seam the continuous-batching scheduler
    drives. Per-slot KV caches and [slots] int32 cursors live in one
    batched state overlay, so sequences at different depths advance in one
    forward and a finished slot is recycled at the next step boundary.

    - `prefill(ids, pad_to)`: one prompt through a fresh batch-1 forward,
      right-padded to a bucket; returns the next-token distribution and the
      slot's primed cache;
    - `install(slot, slot_state, length)`: copy that cache into the bank;
    - `step(tokens)`: advance every slot one token ([slots, V] out); free
      slots ride along on a dummy token, masked by their own cursors;
    - `step_k(tokens)`: advance every slot T tokens in one forward (the
      speculative verify shape), [slots, T, V] out;
    - `rewind_all(lengths)`: set every slot's cursors at once (the
      truncation after a verify);
    - `clear(slot)`: retire a sequence.
    """

    def __init__(self, cg, slots: int):
        if slots < 1:
            raise ValueError("need at least one decode slot")
        self.cg = cg
        self.slots = int(slots)
        self.capacity = decode_cache_capacity(cg)
        self._declared = cg._declared_state()
        self._state: Optional[Dict[str, Dict]] = None

    @torch.inference_mode()
    def prefill(self, ids, pad_to: Optional[int] = None):
        """Returns `(probs [V], slot_state, length)`. Causal attention: the
        distribution at the last real position never sees the pad tail,
        whose cache rows sit beyond the rewound cursor."""
        ids = [int(i) for i in ids]
        n = len(ids)
        if not n:
            raise ValueError("need at least one prompt token")
        pad_to = int(pad_to or n)
        if pad_to < n:
            raise ValueError(f"pad_to ({pad_to}) < prompt length ({n})")
        if pad_to > self.capacity:
            raise ValueError(
                f"prompt bucket {pad_to} (prompt length {n}) exceeds the "
                f"decode cache capacity {self.capacity}")
        x = np.zeros((1, pad_to, 1), np.int64)
        x[0, :n, 0] = ids
        outs, new_state = self.cg.forward_state(
            self.cg.state, [torch.as_tensor(x, device=self.cg.device)])
        rnn = rnn_mod.split_rnn_state(new_state, self._declared)
        # Rewind every scalar cursor from pad_to to the real length.
        rnn = {layer: {k: (n if isinstance(v, int) else v)
                       for k, v in s.items()}
               for layer, s in rnn.items()}
        return to_numpy(outs[0][0, n - 1]), rnn, n

    def _zeros_like_slot(self, v):
        if isinstance(v, int):
            return torch.zeros(self.slots, dtype=torch.int32,
                               device=self.cg.device)
        return torch.zeros((self.slots,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=self.cg.device)

    def _alloc(self, template):
        self._state = {layer: {k: self._zeros_like_slot(v)
                               for k, v in s.items()}
                       for layer, s in template.items()}

    @torch.inference_mode()
    def install(self, slot: int, slot_state, length: int) -> None:
        if self._state is None:
            self._alloc(slot_state)
        for layer, s in slot_state.items():
            dst = self._state[layer]
            for k, v in s.items():
                dst[k][slot] = length if isinstance(v, int) else v[0]

    def _cursors(self):
        for s in self._state.values():
            for k, v in s.items():
                if v.dim() == 1 and not v.is_floating_point():
                    yield s, k

    @torch.inference_mode()
    def clear(self, slot: int) -> None:
        """Cursor to 0: the next occupant writes from row 0 and stale rows
        are never visible."""
        if self._state is None:
            return
        for s, k in self._cursors():
            s[k][slot] = 0

    def warm_page_copies(self) -> None:
        """Run the page-maintenance ops before traffic. The dense stepper
        has none; the paged stepper copies page 0 onto itself."""

    def _before_dispatch(self, t: int) -> None:
        """Hook before every decode forward (the paged stepper allocates
        and copies-on-write pool pages here)."""

    def _dispatch(self, x):
        state = rnn_mod.merge_rnn_state(self.cg.state, self._state)
        outs, new_state = self.cg.forward_state(state, [x])
        self._state = rnn_mod.split_rnn_state(new_state, self._declared)
        out = to_numpy(outs[0])
        return out if out.ndim == 3 else out[:, None, :]

    @torch.inference_mode()
    def step(self, tokens) -> np.ndarray:
        """Advance every slot one token; `tokens` is [slots] ints (free
        slots take any dummy). Returns [slots, V] distributions."""
        if self._state is None:
            raise RuntimeError("no sequence installed; call prefill/install")
        x = torch.as_tensor(np.asarray(tokens, np.int64).reshape(
            self.slots, 1, 1), device=self.cg.device)
        self._before_dispatch(1)
        return self._dispatch(x)[:, -1]

    @torch.inference_mode()
    def step_k(self, tokens) -> np.ndarray:
        """Advance every slot T tokens in one forward: `tokens` is
        [slots, T] ints and the result [slots, T, V], row j the
        distribution after tokens[:, :j+1]. Rows a verify rejects are
        dropped by `rewind_all`; their cache rows sit beyond the rewound
        cursor, masked until overwritten. On the card the attention is the
        paged kernel with T query rows (T <= 8)."""
        if self._state is None:
            raise RuntimeError("no sequence installed; call prefill/install")
        tok = np.asarray(tokens)
        if tok.ndim != 2 or tok.shape[0] != self.slots:
            raise ValueError(
                f"tokens must be [slots={self.slots}, T]; got {tok.shape}")
        x = torch.as_tensor(tok.astype(np.int64)[:, :, None],
                            device=self.cg.device)
        self._before_dispatch(tok.shape[1])
        return self._dispatch(x)

    @torch.inference_mode()
    def rewind_all(self, lengths) -> None:
        """Set every slot's cursors (KV and positional) to
        `lengths[slot]`: the truncation after a speculative verify."""
        if self._state is None:
            return
        cur = torch.as_tensor(np.asarray(lengths, np.int32).reshape(
            self.slots), device=self.cg.device)
        for s, k in self._cursors():
            s[k].copy_(cur)


class PagedDecodeStepper(DecodeStepper):
    """`DecodeStepper` over a paged KV pool: every attention layer's bank
    holds `k_pages`/`v_pages` ([pages, page_size, H, D]) plus the [slots]
    cursors, and one int32 page table ([slots, pages_per_seq], kept by
    the host pool) is shipped to the device before each step and shared by
    all layers. `install` copies a prefilled prompt into fresh pages;
    `install_shared` points a slot at resident pages (prefix-cache hit: no
    forward, no KV writes); `_before_dispatch` advances the pool and does
    the planned copy-on-write page copies, so the step's scatter never
    collides."""

    def __init__(self, cg, slots: int, page_size: int = 64,
                 pages: Optional[int] = None):
        super().__init__(cg, slots)
        self.pool = KVPagePool(slots=self.slots, capacity=self.capacity,
                               page_size=page_size, pages=pages)
        self.page_size = self.pool.page_size
        self._attn_layers: List[str] = []

    def _alloc(self, template):
        dev = self.cg.device
        shape = (self.pool.num_pages, self.page_size)
        self._state, self._attn_layers = {}, []
        for layer, s in template.items():
            if "k_cache" in s:
                k = s["k_cache"]
                self._state[layer] = {
                    "k_pages": torch.zeros(shape + tuple(k.shape[2:]),
                                           dtype=k.dtype, device=dev),
                    "v_pages": torch.zeros(shape + tuple(k.shape[2:]),
                                           dtype=k.dtype, device=dev),
                    "kv_pos": torch.zeros(self.slots, dtype=torch.int32,
                                          device=dev),
                }
                self._attn_layers.append(layer)
            else:
                self._state[layer] = {k: self._zeros_like_slot(v)
                                      for k, v in s.items()}

    @torch.inference_mode()
    def install(self, slot: int, slot_state, length: int) -> None:
        """Allocate pages for a prefilled prompt and copy its cache into
        them; the tail page's rows beyond `length` hold prefill-pad
        garbage, masked until overwritten."""
        if self._state is None:
            self._alloc(slot_state)
        pages = self.pool.install_slot(slot, length)
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.cg.device)
        page, npg = self.page_size, len(pages)
        for layer, s in slot_state.items():
            dst = self._state[layer]
            if "k_cache" in s:
                for src_k, dst_k in (("k_cache", "k_pages"),
                                     ("v_cache", "v_pages")):
                    src = s[src_k]
                    dst[dst_k][idx] = src[0, :npg * page].reshape(
                        (npg, page) + tuple(src.shape[2:]))
                dst["kv_pos"][slot] = length
            else:
                for k, v in s.items():
                    dst[k][slot] = length if isinstance(v, int) else v[0]

    @torch.inference_mode()
    def install_shared(self, slot: int, pages, length: int) -> None:
        """Prefix-cache hit: point `slot` at resident pages (+1 ref each)
        and set its cursors."""
        if self._state is None:
            raise RuntimeError(
                "no paged state allocated yet; the first prompt must go "
                "through prefill/install")
        self.pool.install_shared(slot, pages, length)
        for s, k in self._cursors():
            s[k][slot] = length

    def clear(self, slot: int) -> None:
        self.pool.free_slot(slot)
        super().clear(slot)

    @torch.inference_mode()
    def warm_page_copies(self) -> None:
        """The copy-on-write page copy of `_before_dispatch`, as a page-0
        self-copy."""
        if self._state is None:
            return
        for layer in self._attn_layers:
            s = self._state[layer]
            s["k_pages"][0] = s["k_pages"][0]
            s["v_pages"][0] = s["v_pages"][0]

    def rewind_all(self, lengths) -> None:
        for slot, n in enumerate(np.asarray(lengths).reshape(self.slots)):
            self.pool.rewind(slot, int(n))
        super().rewind_all(lengths)

    def _before_dispatch(self, t: int) -> None:
        for src, dst in self.pool.plan_appends(t):
            for layer in self._attn_layers:
                s = self._state[layer]
                s["k_pages"][dst] = s["k_pages"][src]
                s["v_pages"][dst] = s["v_pages"][src]
        table = torch.tensor(self.pool.table, device=self.cg.device)  # a copy
        for layer in self._attn_layers:
            self._state[layer]["page_table"] = table
