"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip where
`torch.cuda.is_available()` is false. On a machine with an H100 (the JAX
package need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances, as rtol = atol (|got - want| <= tol + tol * |want|): f32 1e-4
(f32 sums in another order, TF32 off for the plain version's matmuls);
bf16 4e-2 (the plain version rounds its intermediates to bf16 where the
kernels keep f32), as the JAX package's own parity matrix. The ResNet
kernels (BatchNorm apply, the bottleneck block) are held to 6e-2 in bf16,
the JAX package's bottleneck tolerance (tests/test_bottleneck_block.py):
the plain block rounds each conv output and its statistics to bf16.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import bottleneck_block as bb
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.kernels import norm_act

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}
RESNET_TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dtype, dev):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype, device=dev)


def _close(got, want, dtype, tols=TOL):
    torch.cuda.synchronize()
    tol = tols[dtype]
    diff = (got.float() - want.float()).abs()
    excess = diff - (tol + tol * want.float().abs())
    assert float(excess.max()) <= 0, (
        f"max abs err {float(diff.max())}, rtol=atol={tol}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,feats", [(4, 512), (1024, 512), (7, 24),
                                        (3, 1024)])
@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "sigmoid"])
def test_layernorm_kernel_matches_plain(cuda, dtype, rows, feats, act):
    rng = np.random.RandomState(0)
    x = _t(rng.randn(rows, feats) * 2 + 0.5, dtype, cuda)
    g = _t(rng.rand(feats) + 0.5, dtype, cuda)
    b = _t(rng.randn(feats), dtype, cuda)
    before = kernels.launches["layernorm_norm_act"].value
    got = norm_act.layernorm_norm_act(x, g, b, 1e-5, act)
    assert kernels.launches["layernorm_norm_act"].value == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, norm_act.layernorm_plain(x, g, b, 1e-5, act), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,causal", [
    ((1, 1024, 8, 64), True),    # the serving prefill at its widest bucket
    ((1, 8, 8, 64), True),       # the narrowest bucket
    ((2, 37, 3, 8), True),       # ragged T, tiny D
    ((2, 100, 2, 128), False),   # full attention, widest D
    ((1, 70, 2, 24), True),      # D that is no power of two
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, shape, causal):
    rng = np.random.RandomState(1)
    q, k, v = (_t(rng.randn(*shape), dtype, cuda) for _ in range(3))
    before = kernels.launches["flash_attention"].value
    got = fa.flash_attention(q, k, v, causal=causal)
    assert kernels.launches["flash_attention"].value == before + 1
    want = fa.dense_attention(q, k, v, causal=causal)
    assert got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 3])
def test_paged_kernel_matches_plain_small(cuda, dtype, t):
    # The JAX package's paged-kernel geometry: a pad tail, zero-page rows
    # and an empty slot (tests/test_kernels.py).
    rng = np.random.RandomState(9)
    B, H, D, page, P = 3, 2, 8, 4, 7
    q = _t(rng.randn(B, t, H, D), dtype, cuda)
    kp = _t(rng.randn(P, page, H, D), dtype, cuda)
    vp = _t(rng.randn(P, page, H, D), dtype, cuda)
    table = torch.tensor([[1, 2, 3, 0], [4, 0, 0, 0], [0, 0, 0, 0]],
                         dtype=torch.int32, device=cuda)
    pos = torch.tensor([9, 2, 0], dtype=torch.int32, device=cuda)
    for causal in (True, False):
        got = fa.paged_decode_attention(q, kp, vp, table, pos, causal)
        want = fa.paged_gather_dense(q, kp, vp, table, pos, causal)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_matches_plain_serving_shape(cuda, dtype):
    # 4 slots x 8 heads x 64 dims, 64-row pages, 16 pages per sequence, a
    # 65-page pool; one slot near full depth, one free (all-zero table).
    rng = np.random.RandomState(2)
    B, H, D, page, NP, P = 4, 8, 64, 64, 16, 65
    q = _t(rng.randn(B, 1, H, D), dtype, cuda)
    kp = _t(rng.randn(P, page, H, D), dtype, cuda)
    vp = _t(rng.randn(P, page, H, D), dtype, cuda)
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, NP), np.int32)
    pos = np.asarray([1022, 300, 0, 40], np.int32)
    for b in range(B):
        n = -(-(int(pos[b]) + 1) // page) if b != 2 else 0
        table[b, :n] = perm[b * NP: b * NP + n]
    table = torch.tensor(table, device=cuda)
    pos = torch.tensor(pos, device=cuda)
    before = kernels.launches["paged_decode_attention"].value
    got = fa.paged_decode_attention(q, kp, vp, table, pos, True)
    assert kernels.launches["paged_decode_attention"].value == before + 1
    want = fa.paged_gather_dense(q, kp, vp, table, pos, True)
    _close(got, want, dtype)


def _paged_case(rng, dtype, dev, pos, b=4, h=8, d=64, page=64, n_pages=16,
                t=1, free=()):
    """A pool of b * n_pages + 1 pages (page 0 the zero page), each slot's
    pages below its cursor drawn at random from it, slots in `free` with an
    all-zero table; q [b, t, h, d]."""
    pool = b * n_pages + 1
    q = _t(rng.randn(b, t, h, d), dtype, dev)
    kp = _t(rng.randn(pool, page, h, d), dtype, dev)
    vp = _t(rng.randn(pool, page, h, d), dtype, dev)
    perm = rng.permutation(np.arange(1, pool))
    table = np.zeros((b, n_pages), np.int32)
    for s in range(b):
        n = min(n_pages, -(-(int(pos[s]) + t) // page))
        if s not in free:
            table[s, :n] = perm[s * n_pages: s * n_pages + n]
    return (q, kp, vp, torch.tensor(table, device=dev),
            torch.tensor(np.asarray(pos, np.int32), device=dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [[0, 0, 0, 0], [63, 0, 5, 1], [64, 63, 0, 2],
                                 [65, 1, 64, 63], [1023, 40, 0, 700],
                                 [1023] * 4])
def test_paged_split_kernel_over_a_pos_sweep(cuda, dtype, pos):
    # The serving shape (4 slots x 8 heads x 64, pages of 64, one page a
    # split): cursors at 0, page - 1, page, page + 1 and 1023, all slots at
    # 1023; the third slot of the mixed rows is free (all-zero table).
    free = () if pos == [1023] * 4 else (2,)
    args = _paged_case(np.random.RandomState(sum(pos)), dtype, cuda, pos,
                       free=free)
    plan = fa.paged_split_plan(4, 8, 16, 64, 64, args[0].element_size(),
                               fa._sm_count(args[0].get_device()))
    assert plan.pages_per_split == 1 and plan.n_splits == 16
    for causal in (True, False):
        got = fa.paged_decode_attention(*args, causal)
        _close(got, fa.paged_gather_dense(*args, causal), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 64, 128])
@pytest.mark.parametrize("t", range(1, 9))
def test_paged_split_kernel_query_widths_and_head_dims(cuda, dtype, d, t):
    # 16-key pages, 8 a row: a multi-split row near the end of its table
    # (cursor + t past it for t > 2), one in its second page, a free slot.
    args = _paged_case(np.random.RandomState(10 * t + d), dtype, cuda,
                       [122, 17, 0], b=3, h=2, d=d, page=16, n_pages=8, t=t,
                       free=(2,))
    for causal in (True, False):
        got = fa.paged_decode_attention(*args, causal)
        assert got.shape == args[0].shape and got.dtype == dtype
        _close(got, fa.paged_gather_dense(*args, causal), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,offset", [(6, 0), (12, 0), (64, 1), (8, 1)])
def test_paged_split_kernel_copies_unaligned_rows_by_element(cuda, dtype, d,
                                                            offset):
    # Rows that are no multiple of 16 bytes, or pools at an address that
    # is not, take the element-by-element copy.
    rng = np.random.RandomState(d + offset)
    q, kp, vp, table, pos = _paged_case(rng, dtype, cuda, [70, 5, 33], b=3,
                                        h=3, d=d, page=8, n_pages=12, t=2)
    if offset:
        kp, vp = (torch.cat([a.new_zeros(offset), a.flatten()])[offset:]
                  .view(a.shape) for a in (kp, vp))
        assert kp.data_ptr() % 16 and kp.is_contiguous()
    for causal in (True, False):
        got = fa.paged_decode_attention(q, kp, vp, table, pos, causal)
        _close(got, fa.paged_gather_dense(q, kp, vp, table, pos, causal),
               dtype)


def test_paged_split_kernel_is_bitwise_repeatable(cuda):
    args = _paged_case(np.random.RandomState(4), torch.bfloat16, cuda,
                       [1000, 700, 330, 40])
    first = fa.paged_decode_attention(*args, True)
    for _ in range(3):
        assert torch.equal(fa.paged_decode_attention(*args, True), first)


def test_paged_wrapper_never_syncs_the_host(cuda):
    # Neither pos nor the table is read on the host: the wrapper (workspace
    # included, on a fresh stream) runs under the sync debug mode "error".
    args = _paged_case(np.random.RandomState(5), torch.bfloat16, cuda,
                       [1000, 700, 330, 40])
    fa.paged_decode_attention(*args, True)  # builds and binds first
    stream = torch.cuda.Stream()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream):
            got = fa.paged_decode_attention(*args, True)
            got = fa.paged_decode_attention(*args, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.current_stream().wait_stream(stream)
    _close(got, fa.paged_gather_dense(*args, True), torch.bfloat16)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 10, device=cuda)  # 10 % 4 != 0: no 16-byte rows
    g = torch.ones(10, device=cuda)
    with pytest.raises(ValueError):
        norm_act.layernorm_norm_act(x, g, g, 1e-5, "identity")
    q = torch.zeros(1, 8, 2, 160, device=cuda)  # D > 128
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())


TRAIN_SHAPES = [
    ((16, 1024, 8, 64), True),   # the training step of transformer_lm
    ((2, 100, 3, 64), True),     # T no multiple of 64
    ((2, 37, 2, 16), False),     # ragged T, full attention
    ((1, 130, 2, 128), True),    # widest D
    ((1, 70, 2, 24), False),     # D that is no power of two
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,causal", TRAIN_SHAPES)
def test_flash_fwd_lse_kernel_matches_plain(cuda, dtype, shape, causal):
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(*shape), dtype, cuda) for _ in range(3))
    before = kernels.launches["flash_attention_fwd_lse"].value
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
    assert kernels.launches["flash_attention_fwd_lse"].value == before + 1
    want_o, want_lse = fa.dense_attention_lse(q, k, v, causal)
    _close(o, want_o, dtype)
    _close(lse, want_lse, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,causal", TRAIN_SHAPES)
def test_flash_bwd_kernels_match_plain(cuda, dtype, shape, causal):
    rng = np.random.RandomState(4)
    q, k, v, do = (_t(rng.randn(*shape), dtype, cuda) for _ in range(4))
    o, lse = fa.dense_attention_lse(q, k, v, causal)
    drow = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    scale = shape[-1] ** -0.5
    before = (kernels.launches["flash_attention_bwd_dq"].value,
              kernels.launches["flash_attention_bwd_dkv"].value)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert (kernels.launches["flash_attention_bwd_dq"].value,
            kernels.launches["flash_attention_bwd_dkv"].value) \
        == (before[0] + 1, before[1] + 1)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, drow, causal,
                                              scale)
    _close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, drow, causal, scale),
           dtype)
    _close(dk, want_dk, dtype)
    _close(dv, want_dv, dtype)


def test_flash_attention_fn_trains_through_the_kernels(cuda):
    rng = np.random.RandomState(5)
    q, k, v, g = (_t(rng.randn(2, 96, 2, 32), torch.float32, cuda)
                  for _ in range(4))
    ref = [a.detach().cpu().requires_grad_(True) for a in (q, k, v)]
    ts = [a.requires_grad_(True) for a in (q, k, v)]
    kernels.reset_counts()
    got = torch.autograd.grad(fa.flash_attention(*ts), ts, g)
    c = kernels.counts()
    assert c["launches"]["flash_attention_fwd_lse"] == 1
    assert c["launches"]["flash_attention_bwd_dq"] == 1
    assert c["launches"]["flash_attention_bwd_dkv"] == 1
    assert c["launches"]["flash_attention"] == 0
    assert not any(c["plain_calls"].values())
    want = torch.autograd.grad(fa.flash_attention(*ref), ref, g.cpu())
    for a, b in zip(got, want):
        _close(a, b.to(cuda), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_fn_gradients_match_plain(cuda, dtype):
    rng = np.random.RandomState(6)
    x, g, b = (_t(a, dtype, cuda).requires_grad_(True) for a in
               (rng.randn(64, 512), rng.rand(512) + 0.5, rng.randn(512)))
    w = _t(rng.randn(64, 512), dtype, cuda)
    kernels.reset_counts()
    got = torch.autograd.grad(
        norm_act.layernorm_norm_act(x, g, b, 1e-5, "relu"), (x, g, b), w)
    assert kernels.counts()["launches"]["layernorm_norm_act"] == 1
    want = torch.autograd.grad(norm_act.layernorm_plain(x, g, b, 1e-5,
                                                        "relu"), (x, g, b), w)
    for a, c in zip(got, want):
        _close(a, c, dtype)


def test_kernel_wrappers_refuse_to_cut_the_gradient(cuda):
    q = torch.zeros(1, 8, 2, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        fa.flash_attention_fwd_lse(q, q, q)
    x = torch.zeros(4, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        norm_act._layernorm_forward(x, x[0], x[0], 1e-5, "identity")


@pytest.mark.parametrize("kind", ["adam", "nesterovs", "rmsprop"])
@pytest.mark.parametrize("step", [0, 5])
def test_fused_update_kernel_matches_plain(cuda, kind, step):
    from deeplearning4j_tpu_torch.kernels import fused_update

    rng = np.random.RandomState(7)
    shapes = {"W": (512, 2048), "b": (2048,), "g": (3, 1025), "z": (1,)}
    for i in range(14):  # 18 tensors: one launch (the table holds 256)
        shapes[f"x{i}"] = (97 + i,)
    fields = fused_update.FIELDS[kind]
    hyper = {"adam": (0.9, 0.999, 1e-8), "nesterovs": (0.9,),
             "rmsprop": (0.95, 1e-8)}[kind]

    def tree(scale, positive=False):
        return {k: _t(np.abs(a) if positive else a, torch.float32, cuda)
                for k, a in ((k, rng.randn(*s) * scale)
                             for k, s in shapes.items())}

    grads = tree(1.0)
    state = {f: tree(0.01, positive=(f != "m" and kind != "nesterovs"))
             for f in fields}
    plain_state = {f: {k: t.clone() for k, t in s.items()}
                   for f, s in state.items()}
    want_state, want_d = fused_update._PLAIN[kind](plain_state, grads, 3e-3,
                                                   step, *hyper)
    before = kernels.launches["fused_update"].value
    got_state, got_d = fused_update.dispatch(kind, state, grads, 3e-3, step,
                                             hyper)
    assert kernels.launches["fused_update"].value == before + 1
    for f in fields:
        for k in shapes:
            assert got_state[f][k] is state[f][k]  # updated in place
            torch.testing.assert_close(got_state[f][k], want_state[f][k],
                                       rtol=1e-5, atol=1e-6)
    for k in shapes:
        torch.testing.assert_close(got_d[k], want_d[k], rtol=1e-5, atol=1e-6)


UPDATE_HYPER = {"adam": (0.9, 0.999, 1e-8), "nesterovs": (0.9,),
                "rmsprop": (0.95, 1e-8)}


def _update_layers(rng, kind, dev, sizes, misaligned=()):
    """Two layers of f32 params, state and grads of the given sizes, each
    name in `misaligned` a view 4 bytes into a larger tensor (contiguous,
    not 16-byte aligned)."""
    from deeplearning4j_tpu_torch.kernels import fused_update

    def t(name, n, scale, positive=False):
        a = rng.randn(n + 1) * scale
        a = torch.tensor(np.abs(a) if positive else a, dtype=torch.float32,
                         device=dev)
        return a[1:] if name in misaligned else a[:n].clone()

    out = []
    for _ in range(2):
        params = {k: t(k, n, 1.0) for k, n in sizes.items()}
        grads = {k: t(k, n, 1.0) for k, n in sizes.items()}
        state = {f: {k: t(k, n, 0.1 if f == "m" or kind == "nesterovs"
                          else 0.01, positive=f in ("v", "g2")
                          and kind != "nesterovs")
                     for k, n in sizes.items()}
                 for f in fused_update.FIELDS[kind]}
        out.append((params, state, grads))
    return out


def _clone_tree(tree, device=None):
    """A copy of nested dicts / tuples / lists of tensors (on `device`)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(v, device) for v in tree)
    return tree.to(device or tree.device, copy=True)


def _dispatch_factor_sub(kind, layers, lrs, factors, step, sign):
    """The per-layer card path `apply_step` replaces: `dispatch` (the
    kernel's deltas mode), `d * factor`, then `sub_` / `add_`."""
    from deeplearning4j_tpu_torch.kernels import fused_update

    for (params, state, grads), lr, fac in zip(layers, lrs, factors):
        _, deltas = fused_update.dispatch(kind, state, grads, lr, step,
                                          UPDATE_HYPER[kind])
        for k, p in params.items():
            d = deltas[k] * fac[k] if fac and k in fac else deltas[k]
            p.sub_(d) if sign > 0 else p.add_(d)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("kind", ["adam", "nesterovs", "rmsprop"])
def test_apply_step_is_bit_identical_to_dispatch_factor_sub(cuda, kind,
                                                            sign):
    # Tensors of 1, 3, 1025 and 512 x 2048 elements (the vector path, its
    # scalar tail, a tail alone) and a misaligned view (the scalar path),
    # two layers at different lr, one with bias-rate factors; 3 steps, one
    # launch each; equal bit for bit to the per-layer path.
    from deeplearning4j_tpu_torch.kernels import fused_update

    sizes = {"one": 1, "b": 3, "g": 1025, "W": 512 * 2048, "view": 1031}
    layers = _update_layers(np.random.RandomState(11), kind, cuda, sizes,
                            misaligned=("view",))
    assert layers[0][0]["view"].data_ptr() % 16
    ref = _clone_tree(layers)
    lrs = (3e-3, 7e-4)
    factors = (None, {"b": 2.5, "view": 0.5, "one": 3.0})
    for step in range(3):
        before = kernels.launches["fused_update"].value
        fused_update.apply_step(kind, UPDATE_HYPER[kind], [
            fused_update.UpdateItem(p, s, g, lr, fac)
            for (p, s, g), lr, fac in zip(layers, lrs, factors)], step, sign)
        assert kernels.launches["fused_update"].value == before + 1
        _dispatch_factor_sub(kind, ref, lrs, factors, step, sign)
        torch.cuda.synchronize()
        for (p, s, _), (rp, rs, _) in zip(layers, ref):
            for k in sizes:
                assert torch.equal(p[k], rp[k]), (step, k)
                for f in s:
                    assert torch.equal(s[f][k], rs[f][k]), (step, f, k)


def test_apply_step_reuses_its_table_until_a_param_moves(cuda):
    # With a `tables` dict (as the engine keeps one), a step after the first
    # reuses the packed table and renews only grads, lrs and factors; a
    # param given new storage, or a new state tensor, makes it pack anew.
    # Every step equals the per-layer path bit for bit.
    from deeplearning4j_tpu_torch.kernels import fused_update

    sizes = {"b": 3, "g": 1025, "W": 512 * 2048, "view": 1031}
    layers = _update_layers(np.random.RandomState(16), "adam", cuda, sizes,
                            misaligned=("view",))
    ref = _clone_tree(layers)
    lrs, factors = [3e-3, 7e-4], (None, {"b": 2.5})
    rng = np.random.RandomState(17)
    tables, seen = {}, []
    for step in range(5):
        if step == 3:  # new storage for a param, on both sides
            for p, _, _ in (layers[1], ref[1]):
                p["W"].set_(p["W"].clone())
        if step == 4:  # a new tensor for a state field
            layers[0][1]["v"]["g"] = layers[0][1]["v"]["g"].clone()
        grads = [{k: torch.tensor(rng.randn(n), dtype=torch.float32,
                                  device=cuda) for k, n in sizes.items()}
                 for _ in layers]
        lrs[1] *= 0.5
        before = kernels.launches["fused_update"].value
        fused_update.apply_step("adam", UPDATE_HYPER["adam"], [
            fused_update.UpdateItem(p, s, g, lr, fac)
            for (p, s, _), g, lr, fac in zip(layers, grads, lrs, factors)],
            step, 1.0, tables)
        assert kernels.launches["fused_update"].value == before + 1
        seen.append(tables[("adam", UPDATE_HYPER["adam"])])
        _dispatch_factor_sub("adam", [(p, s, g) for (p, s, _), g in
                                      zip(ref, grads)], lrs, factors, step,
                             1.0)
        torch.cuda.synchronize()
        for (p, s, _), (rp, rs, _) in zip(layers, ref):
            for k in sizes:
                assert torch.equal(p[k], rp[k]), (step, k)
                for f in s:
                    assert torch.equal(s[f][k], rs[f][k]), (step, f, k)
    assert seen[1] is seen[0] and seen[2] is seen[0]
    assert seen[3] is not seen[2] and seen[4] is not seen[3]
    # A grad the kernel cannot take is refused on a reused table too.
    bad = dict(grads[0], g=grads[0]["g"].to(torch.bfloat16))
    before = kernels.launches["fused_update"].value
    with pytest.raises(TypeError, match="float32"):
        fused_update.apply_step("adam", UPDATE_HYPER["adam"], [
            fused_update.UpdateItem(*layers[0][:2], bad, 1e-3),
            fused_update.UpdateItem(*layers[1][:2], grads[1], 1e-3)],
            5, 1.0, tables)
    assert kernels.launches["fused_update"].value == before


def test_apply_step_launches_again_past_the_table_and_matches_plain(cuda):
    # 300 tensors: the table holds 256, so two launches; the result equals
    # the per-layer card path bit for bit and the plain version (rtol 1e-5).
    from deeplearning4j_tpu_torch.kernels import _build, fused_update

    assert (_build.load().dl4j_fused_update_capacity()
            == fused_update._MAX_TENSORS == 256)
    sizes = {f"t{i}": 1 + (i * 37) % 301 for i in range(150)}
    layers = _update_layers(np.random.RandomState(12), "adam", cuda, sizes)
    ref, cpu = _clone_tree(layers), _clone_tree(layers, "cpu")
    kernels.reset_counts()
    items = [fused_update.UpdateItem(p, s, g, 1e-3) for p, s, g in layers]
    fused_update.apply_step("adam", UPDATE_HYPER["adam"], items, 2, 1.0)
    assert kernels.counts()["launches"]["fused_update"] == 2
    _dispatch_factor_sub("adam", ref, (1e-3, 1e-3), (None, None), 2, 1.0)
    cpu_states = fused_update.apply_step("adam", UPDATE_HYPER["adam"], [
        fused_update.UpdateItem(p, s, g, 1e-3) for p, s, g in cpu], 2, 1.0)
    torch.cuda.synchronize()
    for (p, s, _), (rp, _, _), (cp, _, _), cs in zip(layers, ref, cpu,
                                                      cpu_states):
        for k in sizes:
            assert torch.equal(p[k], rp[k]), k
            torch.testing.assert_close(p[k].cpu(), cp[k], rtol=1e-5,
                                       atol=1e-6)
            for f in s:
                torch.testing.assert_close(s[f][k].cpu(), cs[f][k],
                                           rtol=1e-5, atol=1e-6)


def test_apply_step_bumps_the_version_counter(cuda):
    # The kernel writes through raw pointers; a graph that saved a param
    # before the update must fail at backward as it would after `sub_`.
    from deeplearning4j_tpu_torch.kernels import fused_update

    (params, state, grads), _ = _update_layers(
        np.random.RandomState(13), "adam", cuda, {"W": 1024, "b": 8})
    w = params["W"].requires_grad_(True)
    loss = (w * w).sum()  # saves w
    versions = {k: t._version for k, t in
                [("W", w), ("m", state["m"]["W"]), ("v", state["v"]["W"])]}
    with torch.no_grad():
        fused_update.apply_step("adam", UPDATE_HYPER["adam"], [
            fused_update.UpdateItem(params, state, grads, 1e-3)], 0, 1.0)
    assert w._version > versions["W"]
    assert state["m"]["W"]._version > versions["m"]
    assert state["v"]["W"]._version > versions["v"]
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        loss.backward()


def test_apply_step_refuses_what_the_kernel_does_not_take(cuda):
    from deeplearning4j_tpu_torch.kernels import fused_update

    (params, state, grads), _ = _update_layers(
        np.random.RandomState(14), "rmsprop", cuda, {"W": 64, "b": 64})

    def step(**swap):
        g = dict(grads, **swap)
        fused_update.apply_step("rmsprop", UPDATE_HYPER["rmsprop"], [
            fused_update.UpdateItem(params, state, g, 1e-3)], 0, 1.0)

    kernels.reset_counts()
    with pytest.raises(TypeError, match="float32"):
        step(W=grads["W"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        step(W=torch.zeros(128, device=cuda)[::2])
    with pytest.raises(ValueError, match="lies on"):
        step(b=torch.zeros(64))  # the second grad on the CPU
    # A layer wholly on the CPU ahead of one on the card: the first grad
    # picks the CPU path, which must refuse the card layer, not run the
    # plain version on it.
    (cp, cs, cg), _ = _update_layers(np.random.RandomState(14), "rmsprop",
                                     "cpu", {"W": 64, "b": 64})
    with pytest.raises(ValueError, match="devices"):
        fused_update.apply_step("rmsprop", UPDATE_HYPER["rmsprop"], [
            fused_update.UpdateItem(cp, cs, cg, 1e-3),
            fused_update.UpdateItem(params, state, grads, 1e-3)], 0, 1.0)
    c = kernels.counts()
    assert c["launches"]["fused_update"] == 0
    assert c["plain_calls"]["fused_update"] == 0


def test_engine_update_on_the_card_equals_the_per_layer_path(cuda):
    # A small LM whose layers mix Adam, Nesterovs, RMSProp and sgd, rates,
    # bias rates and a schedule, maximizing: one launch per fused group a
    # step, params and state equal bit for bit to the per-layer card path
    # (`dispatch`, factor, `sub_`/`add_`) from the same grads.
    from deeplearning4j_tpu_torch.kernels import fused_update
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.conf.layers import is_bias_param
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = zoo.transformer_lm(64, t=32, d_model=32, n_heads=4, n_blocks=1)
    for name, upd, lr, bias_lr in (("attn0", None, None, 0.009),
                                   ("ff1_0", "nesterovs", 0.02, 0.01),
                                   ("ffn0", "nesterovs", 0.02, 0.02),
                                   ("ln_f0", "sgd", 0.05, 0.05),
                                   ("out", "rmsprop", 0.004, 0.002)):
        layer = conf.vertices[name].layer
        layer.updater = upd or layer.updater
        layer.learning_rate = lr or layer.learning_rate
        layer.bias_learning_rate = bias_lr
    conf.global_conf.minimize = False
    conf.global_conf.lr_policy = "exponential"
    conf.global_conf.lr_policy_decay_rate = 0.9
    nets = [ComputationGraph(conf, device=cuda).init() for _ in range(2)]
    rng = np.random.RandomState(15)
    for step in range(3):
        grads = {v: {k: torch.tensor(rng.randn(*p.shape), dtype=p.dtype,
                                     device=cuda) for k, p in ps.items()}
                 for v, ps in nets[0].params_tree.items()}
        kernels.reset_counts()
        nets[0]._train_update(grads)
        assert kernels.counts()["launches"]["fused_update"] == 3
        ref = nets[1]
        with torch.no_grad():
            for name, layer in ref._layer_confs.items():
                lr = ref._schedules[name](ref.iteration)
                st, d = ref._updaters[name].update(
                    ref.opt_state[name], grads[name], lr, ref.iteration)
                base = float(layer.learning_rate)
                fac = (None if layer.bias_learning_rate == base else
                       {k: layer.bias_learning_rate / base
                        for k in d if is_bias_param(k)})
                fused_update.apply_deltas(ref.params_tree[name], d, fac,
                                          -1.0)
                ref.opt_state[name] = st
        for net in nets:
            net.iteration += 1
    torch.cuda.synchronize()
    for v, ps in nets[1].params_tree.items():
        for k, p in ps.items():
            assert torch.equal(nets[0].params_tree[v][k], p), (v, k)
        for f, s in nets[1].opt_state[v].items():
            for k, a in s.items():
                assert torch.equal(nets[0].opt_state[v][f][k], a), (v, f, k)


def test_launch_counts_from_two_threads_add_up(cuda):
    # Two threads launch LayerNorm at once (as the decode thread does
    # beside a caller): every launch is counted.
    import threading

    x = torch.randn(4, 512, device=cuda, dtype=torch.bfloat16)
    g = torch.ones(512, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(512, device=cuda, dtype=torch.bfloat16)
    kernels.reset_counts()

    def work():
        for _ in range(300):
            norm_act.layernorm_norm_act(x, g, b, 1e-5, "identity")

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert kernels.counts()["launches"]["layernorm_norm_act"] == 600


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,chans", [(2 * 112 * 112, 64), (7, 2048),
                                        (3, 8), (64, 256)])
@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "sigmoid"])
def test_batchnorm_kernel_matches_plain(cuda, dtype, rows, chans, act):
    rng = np.random.RandomState(10)
    x = _t(rng.randn(rows, chans) * 2 + 0.5, dtype, cuda)
    m, g, b = (_t(rng.randn(chans), dtype, cuda) for _ in range(3))
    v = _t(rng.rand(chans) + 0.2, dtype, cuda)
    before = kernels.launches["batchnorm_norm_act"].value
    got = norm_act.batchnorm_norm_act(x, m, v, g, b, 1e-5, act)
    assert kernels.launches["batchnorm_norm_act"].value == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, norm_act.batchnorm_plain(x, m, v, g, b, 1e-5, act), dtype,
           RESNET_TOL)


def test_batchnorm_kernel_casts_running_stats_and_constants(cuda):
    # Inference under mixed bf16: f32 running stats, bf16 x; the kernel
    # casts the stats to bf16 (the Pallas path's `_vec`) where the plain
    # version promotes to f32. lock_gamma_beta passes floats.
    rng = np.random.RandomState(11)
    x = _t(rng.randn(4, 6, 6, 64), torch.bfloat16, cuda)
    m = _t(rng.randn(64) * 0.1, torch.float32, cuda)
    v = _t(rng.rand(64) + 0.5, torch.float32, cuda)
    got = norm_act.batchnorm_norm_act(x, m, v, 1.0, 0.0, 1e-5, "relu")
    assert got.dtype == torch.bfloat16
    want = norm_act.batchnorm_plain(x, m, v, 1.0, 0.0, 1e-5, "relu")
    assert want.dtype == torch.float32
    _close(got, want, torch.bfloat16, RESNET_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batchnorm_fn_gradients_match_plain(cuda, dtype):
    # The gradient reaches x through the batch statistics too.
    rng = np.random.RandomState(12)
    x, g, b = (_t(a, dtype, cuda).requires_grad_(True) for a in
               (rng.randn(2, 8, 8, 64), rng.rand(64) + 0.5, rng.randn(64)))
    w = _t(rng.randn(2, 8, 8, 64), dtype, cuda)

    def run(fn):
        mean = x.mean(dim=(0, 1, 2))
        var = (x * x).mean(dim=(0, 1, 2)) - mean * mean
        return torch.autograd.grad(fn(x, mean, var, g, b, 1e-5, "relu"),
                                   (x, g, b), w)

    kernels.reset_counts()
    got = run(norm_act.batchnorm_norm_act)
    assert kernels.counts()["launches"]["batchnorm_norm_act"] == 1
    want = run(norm_act.batchnorm_plain)
    for a, c in zip(got, want):
        _close(a, c, dtype, RESNET_TOL)


def _block(rng, b, h, cin, f1, project, dtype, dev, int8=False):
    f3 = 4 * f1
    x = _t(rng.randn(b, h, h, cin), dtype, dev)
    params, state = {}, {}
    dims = {"a": (1, 1, cin, f1), "b": (3, 3, f1, f1), "c": (1, 1, f1, f3)}
    if project:
        dims["proj"] = (1, 1, cin, f3)
    for n, shape in dims.items():
        w = rng.randn(*shape) * (2.0 / (shape[0] * shape[1] * shape[2])) ** .5
        f = shape[-1]
        if int8:
            scale = np.abs(w).reshape(-1, f).max(0) / 127.0
            params[f"W_{n}"] = torch.tensor(np.round(w / scale),
                                            dtype=torch.int8, device=dev)
            params[f"W_{n}__scale"] = _t(scale, torch.float32, dev)
        else:
            params[f"W_{n}"] = _t(w, dtype, dev)
        params[f"gamma_{n}"] = _t(rng.rand(f) + 0.5, dtype, dev)
        params[f"beta_{n}"] = _t(rng.randn(f) * 0.1, dtype, dev)
        state[f"mean_{n}"] = _t(rng.randn(f) * 0.1, torch.float32, dev)
        state[f"var_{n}"] = _t(rng.rand(f) + 0.5, torch.float32, dev)
    return x, params, state


BLOCK_SHAPES = [  # (B, H, Cin, F1, stride, project)
    (2, 8, 16, 4, 1, True),
    (2, 9, 16, 8, 2, True),      # odd H: SAME with stride 2
    (2, 8, 32, 8, 1, False),
    (4, 16, 64, 16, 2, True),
    (8, 16, 256, 64, 1, False),  # T2's stage-0 identity block, B=8
]


def _plain_block(x, params, state, stride, project, train):
    names = ("a", "b", "c") + (("proj",) if project else ())
    flat = [t for n in names for t in (params[f"W_{n}"], params[f"gamma_{n}"],
                                       params[f"beta_{n}"])]
    if train:
        y, stats = bb.bottleneck_train_plain(x, *flat, stride=stride,
                                             eps=1e-5, act="relu")
        return y, dict(zip(bb.stat_keys(project), stats))
    return bb.bottleneck_infer_plain(x, *flat, stats=state, stride=stride,
                                     eps=1e-5, act="relu"), None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BLOCK_SHAPES)
@pytest.mark.parametrize("train", [True, False])
def test_bottleneck_kernel_matches_plain(cuda, dtype, shape, train):
    b, h, cin, f1, s, project = shape
    x, params, state = _block(np.random.RandomState(13), b, h, cin, f1,
                              project, dtype, cuda)
    name = "bottleneck_train" if train else "bottleneck_infer"
    before = kernels.launches[name].value
    y, stats = bb.bottleneck_forward(x, params, state, stride=(s, s),
                                     project=project, eps=1e-5,
                                     activation="relu", train=train)
    assert kernels.launches[name].value == before + 1
    assert y.dtype == dtype and y.shape == (b, -(-h // s), -(-h // s), 4 * f1)
    want_y, want_stats = _plain_block(x, params, state, (s, s), project,
                                      train)
    _close(y, want_y, dtype, RESNET_TOL)
    if train:
        assert set(stats) == set(bb.stat_keys(project))
        for k in stats:
            assert stats[k].dtype == torch.float32
            _close(stats[k], want_stats[k], dtype, RESNET_TOL)


def test_bottleneck_kernel_int8_matches_plain(cuda):
    x, params, state = _block(np.random.RandomState(14), 2, 8, 64, 16, True,
                              torch.bfloat16, cuda, int8=True)
    before = kernels.launches["bottleneck_infer"].value
    y, _ = bb.bottleneck_forward(x, params, state, stride=(2, 2),
                                 project=True, eps=1e-5, activation="relu",
                                 train=False)
    assert kernels.launches["bottleneck_infer"].value == before + 1
    deq = {k: (bb._dequant(a, params[k + "__scale"], x.dtype)
               if a.dtype == torch.int8 else a) for k, a in params.items()}
    want, _ = _plain_block(x, deq, state, (2, 2), True, False)
    _close(y, want, torch.bfloat16, RESNET_TOL)
    with pytest.raises(ValueError, match="int8"):
        bb.bottleneck_forward(x, params, state, stride=(2, 2), project=True,
                              eps=1e-5, activation="relu", train=True)


def test_bottleneck_fn_gradients_match_plain(cuda):
    # f32: the kernel forward with the plain composite's VJP, through the
    # batch statistics, against autograd through the plain composite.
    x, params, state = _block(np.random.RandomState(15), 2, 8, 16, 4, True,
                              torch.float32, cuda)
    leaves = [x] + [params[k] for k in sorted(params)]
    for t in leaves:
        t.requires_grad_(True)
    w = _t(np.random.RandomState(16).randn(2, 4, 4, 16), torch.float32, cuda)

    def grads(fn):
        y, _ = fn(x, params, state, (2, 2), True, True)
        return torch.autograd.grad((y * w).sum(), leaves)

    kernels.reset_counts()
    got = grads(lambda *a: bb.bottleneck_forward(
        a[0], a[1], a[2], stride=a[3], project=a[4], eps=1e-5,
        activation="relu", train=a[5]))
    c = kernels.counts()
    assert c["launches"]["bottleneck_train"] == 1
    assert not any(c["plain_calls"].values())
    want = grads(_plain_block)
    for a, b in zip(got, want):
        _close(a, b, torch.float32, RESNET_TOL)


# ------------------------------------- the block on the tensor cores (wgmma)


def _resnet50_block_shapes(image):
    """The distinct (H, Cin, F1, stride, project) of ResNet-50's 16 blocks
    at `image` (after the stride-2 stem and the stride-2 pool)."""
    h, cin, out = -(-(-(-image // 2)) // 2), 64, []
    for filters, blocks, first in ((64, 3, 1), (128, 4, 2), (256, 6, 2),
                                   (512, 3, 2)):
        for i in range(blocks):
            stride = first if i == 0 else 1
            key = (h, cin, filters, stride, i == 0)
            if key not in out:
                out.append(key)
            h, cin = -(-h // stride), 4 * filters
    return out


def _wgmma_block(x, params, state, stride, project, train,
                 activation="relu"):
    """The block in bf16 on the tensor-core form (counted), and its plain
    version run in f32 on the same inputs (bf16 values are exact in f32)."""
    name = "bottleneck_train" if train else "bottleneck_infer"
    kernels.reset_counts()
    y, stats = bb.bottleneck_forward(x, params, state, stride=stride,
                                     project=project, eps=1e-5,
                                     activation=activation, train=train)
    counts = kernels.counts()
    assert counts["launches"][name] == 1
    assert counts["variants"][name] == {"wgmma": 1, "cuda_cores": 0}
    names = ("a", "b", "c") + (("proj",) if project else ())
    flat = [params[f"{k}_{n}"].float() for n in names
            for k in ("W", "gamma", "beta")]
    if train:
        want = bb.bottleneck_train_plain(x.float(), *flat, stride=stride,
                                         eps=1e-5, act=activation)
        return (y, stats), (want[0], dict(zip(bb.stat_keys(project),
                                              want[1])))
    want = bb.bottleneck_infer_plain(x.float(), *flat, stats=state,
                                     stride=stride, eps=1e-5, act=activation)
    return (y, None), (want, None)


def _close_block(got, want):
    (y, stats), (want_y, want_stats) = got, want
    assert y.dtype == torch.bfloat16 and y.shape == want_y.shape
    _close(y, want_y, torch.bfloat16, RESNET_TOL)
    if stats is not None:
        assert set(stats) == set(want_stats)
        for k in stats:
            assert stats[k].dtype == torch.float32
            _close(stats[k], want_stats[k], torch.bfloat16, RESNET_TOL)


@pytest.mark.parametrize("image,train", [(224, False), (64, True)])
@pytest.mark.parametrize("index", range(8))
def test_bottleneck_wgmma_matches_plain_in_f32_at_every_resnet50_shape(
        cuda, image, train, index):
    # I1's 8 block shapes (inference at 224) and T2's (training at 64), B=2.
    h, cin, f1, s, project = _resnet50_block_shapes(image)[index]
    x, params, state = _block(np.random.RandomState(40 + index), 2, h, cin,
                              f1, project, torch.bfloat16, cuda)
    _close_block(*_wgmma_block(x, params, state, (s, s), project, train))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("b,h,cin,f1,s,project", [
    (3, 7, 256, 64, 1, False),   # M = 147: a last tile of 19 rows
    (3, 7, 256, 64, 2, True),    # M = 48: one tile, 16 rows past M
    (1, 9, 128, 128, 2, True),   # M = 25, odd H under stride 2, N = 512
])
def test_bottleneck_wgmma_ragged_m(cuda, train, b, h, cin, f1, s, project):
    x, params, state = _block(np.random.RandomState(50), b, h, cin, f1,
                              project, torch.bfloat16, cuda)
    _close_block(*_wgmma_block(x, params, state, (s, s), project, train))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("activation", ["relu", "identity"])
def test_bottleneck_wgmma_pads_the_normalized_activation(cuda, train,
                                                         activation):
    # act(BN(0)) is far from 0 (means below 0, betas at 1): a tap outside
    # the image must read 0 after the prologue, not BN(0). At H = 4 most
    # of the 3x3 conv's outputs read a padded tap.
    x, params, state = _block(np.random.RandomState(51), 2, 4, 256, 64,
                              False, torch.bfloat16, cuda)
    for n in ("a", "b"):
        params[f"beta_{n}"] = torch.ones_like(params[f"beta_{n}"])
        state[f"mean_{n}"] = torch.full_like(state[f"mean_{n}"], -1.5)
    got, want = _wgmma_block(x, params, state, (1, 1), False, train,
                             activation)
    _close_block(got, want)
    # The same block with BN(0) where the padding is: off by far more.
    a = bb._conv(x.float(), params["W_a"].float(), (1, 1))
    mean_a = a.mean(dim=(0, 1, 2)) if train else state["mean_a"]
    bn0 = (params["beta_a"].float() - params["gamma_a"].float() * mean_a
           / torch.sqrt((a.var(dim=(0, 1, 2), unbiased=False) if train
                         else state["var_a"]) + 1e-5))
    assert float(bn0.abs().min()) > 0.25


def test_bottleneck_wgmma_statistics_are_bitwise_repeatable(cuda):
    x, params, state = _block(np.random.RandomState(52), 4, 16, 256, 64,
                              True, torch.bfloat16, cuda)
    runs = [bb.bottleneck_forward(x, params, state, stride=(2, 2),
                                  project=True, eps=1e-5, activation="relu",
                                  train=True) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for k in bb.stat_keys(True):
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.parametrize("dtype,int8,cin,f1,want", [
    (torch.bfloat16, False, 256, 64, "wgmma"),
    (torch.float32, False, 256, 64, "cuda_cores"),
    (torch.bfloat16, True, 256, 64, "cuda_cores"),
    (torch.bfloat16, False, 64, 16, "cuda_cores"),   # F1 not a multiple of 64
])
def test_bottleneck_variant_launches_count_each_form(cuda, dtype, int8, cin,
                                                     f1, want):
    x, params, state = _block(np.random.RandomState(53), 2, 8, cin, f1, True,
                              dtype, cuda, int8=int8)
    for train in ([False] if int8 else [True, False]):
        name = "bottleneck_train" if train else "bottleneck_infer"
        kernels.reset_counts()
        bb.bottleneck_forward(x, params, state, stride=(2, 2), project=True,
                              eps=1e-5, activation="relu", train=train)
        counts = kernels.counts()
        assert counts["launches"][name] == 1
        assert counts["variants"][name] == {
            k: int(k == want) for k in ("wgmma", "cuda_cores")}
        assert not any(counts["plain_calls"].values())


def test_bottleneck_wgmma_refuses_what_it_cannot_take(cuda):
    x, params, state = _block(np.random.RandomState(54), 2, 8, 256, 64,
                              False, torch.bfloat16, cuda)
    # A misaligned x: refused before any launch, never handed to the
    # CUDA-core form.
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    kernels.reset_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        bb.bottleneck_forward(shifted, params, state, stride=(1, 1),
                              project=False, eps=1e-5, activation="relu",
                              train=False)
    counts = kernels.counts()
    assert not any(counts["launches"].values())
    assert counts["variants"]["bottleneck_infer"] == {"wgmma": 0,
                                                      "cuda_cores": 0}
    # The C entry's tensor-core form refuses an operand it cannot read (f32
    # x with no prologue, int8 weights): an error, not the other form.
    stream = torch.cuda.current_stream().cuda_stream
    w = params["W_a"].reshape(256, 64)
    for inp, wt in ((x.float(), w), (x, w.to(torch.int8))):
        with pytest.raises(RuntimeError, match="dl4j_bottleneck_conv"):
            bb._launch_conv(stream, inp, wt, None, 1, (1, 1), 0, None, 1e-5,
                            0, False, "wgmma")


# ------------------------------------------------------------- LSTM cell


def _cell_inputs(rng, b, n, peephole, masked, dtype, dev, t=3):
    """One step's operands; xw_t is a time step of a [b, t, 4n] tensor, so
    its rows are strided as the layer's scan hands them over."""
    xw = _t(rng.randn(b, t, 4 * n), dtype, dev).unbind(1)[1]
    h, c = (_t(rng.randn(b, n), dtype, dev) for _ in range(2))
    rw = _t(rng.randn(n, 4 * n) * n ** -0.5, dtype, dev)
    pw = _t(rng.randn(3 * n) * 0.3, dtype, dev) if peephole else None
    m = _t(rng.rand(b) < 0.6, dtype, dev) if masked else None
    return xw, h, c, rw, pw, m


def _f32(args):
    return [None if a is None else a.float() for a in args]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("peephole,masked", [
    (True, False), (False, False), (True, True), (False, True)])
@pytest.mark.parametrize("b,n", [(32, 256), (1, 256), (3, 200), (5, 7)])
def test_lstm_cell_kernel_matches_plain(cuda, dtype, peephole, masked, b, n):
    # bf16: against the plain version run in f32 on the same inputs (the
    # kernel, like the TPU body, keeps z and the gates in f32).
    from deeplearning4j_tpu_torch.kernels import lstm_cell as lc

    args = _cell_inputs(np.random.RandomState(b + n), b, n, peephole, masked,
                        dtype, cuda)
    before = kernels.launches["lstm_cell"].value
    got = lc.lstm_cell(*args, "sigmoid", "tanh")
    assert kernels.launches["lstm_cell"].value == before + 1
    want = lc.lstm_cell_plain(*_f32(args), "sigmoid", "tanh")
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (b, n)
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "sigmoid"])
def test_lstm_cell_kernel_cell_activations(cuda, dtype, act):
    from deeplearning4j_tpu_torch.kernels import lstm_cell as lc

    args = _cell_inputs(np.random.RandomState(9), 4, 40, True, True, dtype,
                        cuda)
    got = lc.lstm_cell(*args, "sigmoid", act)
    want = lc.lstm_cell_plain(*_f32(args), "sigmoid", act)
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_lstm_cell_fn_gradients_match_plain(cuda):
    from deeplearning4j_tpu_torch.kernels import lstm_cell as lc

    rng = np.random.RandomState(10)
    args = list(_cell_inputs(rng, 6, 24, True, True, torch.float32, cuda))
    leaves = args[:5]
    for a in leaves:
        a.requires_grad_(True)
    ws = [_t(rng.randn(6, 24), torch.float32, cuda) for _ in range(3)]

    def grads(fn):
        outs = fn(*args, "sigmoid", "tanh")
        loss = sum((o * w).sum() for o, w in zip(outs, ws))
        return torch.autograd.grad(loss, leaves)

    kernels.reset_counts()
    got = grads(lc.lstm_cell)
    c = kernels.counts()
    assert c["launches"]["lstm_cell"] == 1
    assert not any(c["plain_calls"].values())
    for a, b in zip(got, grads(lc.lstm_cell_plain)):
        _close(a, b, torch.float32)


def test_lstm_cell_wrapper_refuses(cuda):
    from deeplearning4j_tpu_torch.kernels import lstm_cell as lc

    xw, h, c, rw, pw, m = _cell_inputs(np.random.RandomState(11), 2, 8, True,
                                       False, torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP A.19"):
        lc.lstm_cell(xw, h, c, rw, pw, m, "hardsigmoid", "tanh")
    with pytest.raises(NotImplementedError, match="ROADMAP A.19"):
        lc.lstm_cell(xw, h, c, rw, pw, m, "sigmoid", "softsign")
    with pytest.raises(ValueError, match="RW"):
        lc.lstm_cell(xw, h, c, rw[:, :8], pw, m)
    with pytest.raises(RuntimeError, match="no gradient"):
        lc._cell_forward(xw, h, c, rw.requires_grad_(True), pw, m, "sigmoid",
                         "tanh")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [7, 200, 256, 512])
@pytest.mark.parametrize("b", [1, 3, 32, 64])
def test_lstm_cell_kernel_over_rows_and_widths(cuda, dtype, b, n):
    # Rows below, at and past one block's 32, widths that are no multiple
    # of 16 bytes (7), of the 128-wide stage (200) and of several stages
    # (512); xw_t strided as the scan hands it over; masked at odd b.
    from deeplearning4j_tpu_torch.kernels import lstm_cell as lc

    args = _cell_inputs(np.random.RandomState(b * n), b, n, True, b % 2 == 1,
                        dtype, cuda, t=5)
    assert args[0].stride(0) == 5 * 4 * n
    got = lc.lstm_cell(*args, "sigmoid", "tanh")
    want = lc.lstm_cell_plain(*_f32(args), "sigmoid", "tanh")
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (b, n)
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lstm_cell_kernel_is_bitwise_repeatable(cuda, dtype):
    from deeplearning4j_tpu_torch.kernels import lstm_cell as lc

    args = _cell_inputs(np.random.RandomState(13), 32, 256, True, False,
                        dtype, cuda)
    first = lc.lstm_cell(*args, "sigmoid", "tanh")
    for _ in range(3):
        for g, f in zip(lc.lstm_cell(*args, "sigmoid", "tanh"), first):
            assert torch.equal(g, f)


def _char_rnn_pair(dev, dtype):
    """A small char-RNN (V=11, 2 x 24 units, tBPTT 5) on the card and an
    f32 one on the CPU with the same params, and one batch at T=12 (two
    chunks of 5 and a 2-step remainder)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    cpu = MultiLayerNetwork(zoo.char_rnn(vocab_size=11, hidden=24,
                                         tbptt_length=5),
                            device="cpu").init()
    card = MultiLayerNetwork(
        zoo.char_rnn(vocab_size=11, hidden=24, tbptt_length=5, dtype=dtype),
        device=dev).init(params={k: {n: a.detach() for n, a in p.items()}
                                 for k, p in cpu.params_tree.items()})
    ids = np.random.RandomState(12).randint(0, 11, (4, 13))
    eye = np.eye(11, dtype=np.float32)
    return card, cpu, DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]])


def test_char_rnn_fit_on_the_card_matches_the_cpu(cuda):
    # f32: two tBPTT fit calls, every cell through the kernel (2 layers x
    # 12 steps per call), the scores within 1e-3 relative, then `output`.
    card, cpu, ds = _char_rnn_pair(cuda, "float32")
    kernels.reset_counts()
    for _ in range(2):
        card.fit(ds)
        cpu.fit(ds)
        assert abs(card.score_value - cpu.score_value) <= 1e-3 * abs(
            cpu.score_value)
    c = kernels.counts()
    assert c["launches"]["lstm_cell"] == 2 * 2 * 12
    # One update launch per chunk (5, 5 and 2 steps) for all three layers.
    assert c["launches"]["fused_update"] == 2 * 3
    np.testing.assert_allclose(card.output(ds.features),
                               cpu.output(ds.features), atol=1e-3)


def test_char_rnn_bf16_on_the_card(cuda):
    # bf16 compute: `output` against the CPU's f32 net on the same params
    # within 4e-2; then fit runs through the kernels to a finite score (a
    # bf16 step's gradients differ from f32 by rounding, and RMSProp's
    # normalized step turns that into visible parameter changes, so the
    # trajectories are not compared).
    card, cpu, ds = _char_rnn_pair(cuda, "bfloat16")
    np.testing.assert_allclose(card.output(ds.features),
                               cpu.output(ds.features), atol=4e-2)
    kernels.reset_counts()
    card.fit(ds)
    assert np.isfinite(card.score_value)
    assert kernels.counts()["launches"]["lstm_cell"] == 2 * 12


def test_lenet_fit_step_on_the_card_matches_the_cpu(cuda):
    # f32 LeNet at B=32 from the same params: one `fit` step on each
    # device; the card's step is one update launch (all 8 tensors) and no
    # plain call; scores within 1e-4 relative, params and the Nesterovs
    # velocity within rtol 2e-4, atol 1e-5 (chip_smoke's lenet_parity),
    # then `output` within 1e-4.
    from deeplearning4j_tpu_torch.datasets.builtin import load_mnist
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    cpu = MultiLayerNetwork(zoo.lenet_mnist(), device="cpu").init()
    card = MultiLayerNetwork(zoo.lenet_mnist(), device=cuda).init(
        params={k: {n: a.detach() for n, a in p.items()}
                for k, p in cpu.params_tree.items()})
    ds = load_mnist(train=True, num_examples=32)
    kernels.reset_counts()
    card.fit(ds)
    c = kernels.counts()
    assert c["launches"]["fused_update"] == 1
    assert sum(c["launches"].values()) == 1
    assert not any(c["plain_calls"].values())
    cpu.fit(ds)
    assert abs(card.score_value - cpu.score_value) <= 1e-4 * abs(
        cpu.score_value)
    for lk, p in cpu.params_tree.items():
        for k, a in p.items():
            np.testing.assert_allclose(
                card.params_tree[lk][k].detach().cpu().numpy(),
                a.detach().numpy(), rtol=2e-4, atol=1e-5, err_msg=lk + k)
            np.testing.assert_allclose(
                card.opt_state[lk]["v"][k].cpu().numpy(),
                cpu.opt_state[lk]["v"][k].numpy(), rtol=2e-4, atol=1e-5,
                err_msg=lk + k)
    x = load_mnist(train=False, num_examples=64).features
    np.testing.assert_allclose(card.output(x), cpu.output(x), atol=1e-4)


# ------------------------------------------------ streamed (rows 4 and 7)

STREAM_SHAPES = [  # (shape, causal, unit_tiles): units of 1-3 tiles make
    ((2, 320, 2, 64), True, 2),   # runs of several units at small T
    ((1, 300, 3, 64), True, 3),   # ragged T
    ((2, 37, 2, 16), False, 1),   # ragged T, full attention, one tile
    ((1, 130, 2, 128), True, 1),  # widest D
    ((1, 200, 2, 24), False, 2),  # D that is no power of two
    ((1, 4096, 2, 64), True, 64),  # the slice's unit size: rows of 1-64 tiles
    ((2, 200, 2, 64), True, 1),   # B >= 2, ragged T, units of one tile
    ((2, 250, 3, 128), False, 2),  # B >= 2, widest D, ragged, full attention
]
# In bf16, the shapes at D = 64 and 128 take row 4's tensor-core kernel
# and row 7's (`fa.stream_fwd_variant`, `fa.stream_bwd_variant`), the
# others their CUDA-core kernels.
# Each shape with each list it takes: the triangle only under causal masking.
STREAM_CASES = [(shape, causal, unit_tiles, pairs)
                for shape, causal, unit_tiles in STREAM_SHAPES
                for pairs in (("triangle", "rectangle") if causal
                              else ("rectangle",))]
STREAM_NAMES = ("flash_attention_stream", "flash_attention_bwd_dq_stream",
                "flash_attention_bwd_dkv_stream")


# Row 4's o is held row by row as well, ||o - o_plain|| / ||o_plain|| over
# D: a row's |o| falls as 1/sqrt(keys), so rtol = atol = 4e-2 alone lets a
# fault of several percent of a long row pass.
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Row 7's dq, dk and dv too, over max(||w_row||, ROW_FLOOR * the median row
# norm). A causal dq row 0 (one key: ds = p (dp - D) with D = dp) is 0 in
# exact arithmetic, rounding noise in f32 (~1e-6 on both sides), so it is
# held elementwise only. bf16's limit is about twice the largest error its
# rounding of p and ds (to bf16, before the products) gives (PERF.md §6).
BWD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.2e-2}
ROW_FLOOR = 0.1


def _close_rows(got, want, dtype, tols=ROW_TOL, floor=None):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    norm = w.norm(dim=-1)
    if floor is not None:
        norm = norm.clamp(min=floor * float(norm.median()))
    err = float(((g - w).norm(dim=-1) / norm).max())
    assert err <= tols[dtype], f"max row error {err}, limit {tols[dtype]}"


def _stream_case(rng, shape, dtype, dev):
    q, k, v, do = (_t(rng.randn(*shape), dtype, dev) for _ in range(4))
    return q, k, v, do


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,causal,unit_tiles,pairs", STREAM_CASES)
def test_stream_fwd_kernel_matches_plain(cuda, monkeypatch, dtype, shape,
                                         causal, unit_tiles, pairs):
    monkeypatch.setattr(fa, "_UNIT_TILES", unit_tiles)
    q, k, v, _ = _stream_case(np.random.RandomState(11), shape, dtype, cuda)
    before = kernels.launches["flash_attention_stream"].value
    forms = kernels.counts()["variants"]["flash_attention_stream"]
    o, lse = fa.flash_attention_stream(q, k, v, causal, pairs=pairs)
    o_only = fa.flash_attention_stream(q, k, v, causal, pairs=pairs,
                                       with_lse=False)
    assert kernels.launches["flash_attention_stream"].value == before + 2
    variant = fa.stream_fwd_variant(dtype, shape[-1])
    forms[variant] += 2
    assert kernels.counts()["variants"]["flash_attention_stream"] == forms
    want_o, want_lse = fa.flash_stream_fwd_plain(q, k, v, causal,
                                                 shape[-1] ** -0.5)
    _close(o, want_o, dtype)
    _close_rows(o, want_o, dtype)
    _close(lse, want_lse, torch.float32)
    assert torch.equal(o_only, o)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.bfloat16, 64)])
def test_stream_fwd_unit_above_the_diagonal_weighs_zero(cuda, monkeypatch,
                                                        dtype, d):
    # The rectangular list in units of one tile: every unit above the
    # diagonal ends at m = -1e30 and its merge weight must be exactly 0;
    # the result is then the triangle's, to the rounding of the merge (the
    # lse, f32, at 1e-4 in both forms of the unit kernel).
    monkeypatch.setattr(fa, "_UNIT_TILES", 1)
    q, k, v, _ = _stream_case(np.random.RandomState(12), (1, 256, 2, d),
                              dtype, cuda)
    tri, tri_lse = fa.flash_attention_stream(q, k, v, True)
    rect, rect_lse = fa.flash_attention_stream(q, k, v, True,
                                               pairs="rectangle")
    _close(rect, tri, dtype)
    _close_rows(rect, tri, dtype)
    _close(rect_lse, tri_lse, torch.float32)
    assert torch.isfinite(rect).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,causal,unit_tiles,pairs", STREAM_CASES)
def test_stream_bwd_kernels_match_plain(cuda, monkeypatch, dtype, shape,
                                        causal, unit_tiles, pairs):
    monkeypatch.setattr(fa, "_UNIT_TILES", unit_tiles)
    q, k, v, do = _stream_case(np.random.RandomState(13), shape, dtype, cuda)
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_stream_fwd_plain(q, k, v, causal, scale)
    drow = fa._drow(o, do)
    before = [kernels.launches[n].value for n in STREAM_NAMES[1:]]
    forms = kernels.counts()["variants"]
    dq = fa.flash_attention_bwd_dq_stream(q, k, v, do, lse, drow, causal,
                                          scale, pairs=pairs)
    dk, dv = fa.flash_attention_bwd_dkv_stream(q, k, v, do, lse, drow,
                                               causal, scale, pairs=pairs)
    assert [kernels.launches[n].value for n in STREAM_NAMES[1:]] == \
        [b + 1 for b in before]
    for name in STREAM_NAMES[1:]:
        forms[name][fa.stream_bwd_variant(dtype, shape[-1])] += 1
        assert kernels.counts()["variants"][name] == forms[name]
    want_dq = fa.flash_stream_bwd_dq_plain(q, k, v, do, lse, drow, causal,
                                           scale)
    want_dk, want_dv = fa.flash_stream_bwd_dkv_plain(q, k, v, do, lse, drow,
                                                     causal, scale)
    rows = slice(1 if causal else 0, None)
    for got, want in ((dq[:, rows], want_dq[:, rows]), (dk, want_dk),
                      (dv, want_dv)):
        _close_rows(got, want, dtype, BWD_ROW_TOL, ROW_FLOOR)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        _close(got, want, dtype)


def _repeat_is_equal(dev, shape):
    q, k, v, do = _stream_case(np.random.RandomState(14), shape,
                               torch.bfloat16, dev)
    kernels.reset_counts()
    runs = []
    for _ in range(2):
        o, lse = fa.flash_attention_stream(q, k, v, True)
        runs.append((o, lse, *fa.flash_attention_bwd_stream(
            q, k, v, o, lse, do, True)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    return kernels.counts()["variants"]


def test_stream_kernels_are_deterministic(cuda, monkeypatch):
    # bf16 at D = 64: every unit kernel in its tensor-core form.
    monkeypatch.setattr(fa, "_UNIT_TILES", 3)
    forms = _repeat_is_equal(cuda, (1, 1000, 2, 64))
    assert all(forms[n] == {"wgmma": 2, "cuda_cores": 0}
               for n in STREAM_NAMES)


def test_stream_kernels_are_deterministic_at_d128(cuda, monkeypatch):
    monkeypatch.setattr(fa, "_UNIT_TILES", 3)
    forms = _repeat_is_equal(cuda, (2, 700, 2, 128))
    assert all(forms[n] == {"wgmma": 2, "cuda_cores": 0}
               for n in STREAM_NAMES)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.bfloat16, 64)])
def test_flash_attention_fn_streams_past_the_limit(cuda, monkeypatch, dtype,
                                                   d):
    # In bf16 at D = 64 the forward is the tensor-core kernel, and its lse
    # feeds row 7's backward: the gradients hold it against the CPU's.
    monkeypatch.setattr(fa, "_RESIDENT_KV_LIMIT", 0)
    rng = np.random.RandomState(15)
    q, k, v, g = (_t(rng.randn(2, 200, 2, d), dtype, cuda)
                  for _ in range(4))
    ref = [a.detach().cpu().requires_grad_(True) for a in (q, k, v)]
    ts = [a.requires_grad_(True) for a in (q, k, v)]
    kernels.reset_counts()
    got = torch.autograd.grad(fa.flash_attention(*ts), ts, g)
    with torch.no_grad():
        fa.flash_attention(*ts)
    c = kernels.counts()
    assert [c["launches"][n] for n in STREAM_NAMES] == [2, 1, 1]
    variant = fa.stream_fwd_variant(dtype, d)
    assert c["variants"]["flash_attention_stream"][variant] == 2
    for name in STREAM_NAMES[1:]:
        assert c["variants"][name][fa.stream_bwd_variant(dtype, d)] == 1
    assert not any(c["launches"][n] for n in (
        "flash_attention", "flash_attention_fwd_lse",
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
    assert not any(c["plain_calls"].values())
    want = torch.autograd.grad(fa.flash_attention(*ref), ref, g.cpu())
    for a, b in zip(got, want):
        _close(a, b.to(cuda), dtype)


def test_stream_wrappers_refuse_to_cut_the_gradient(cuda):
    q = torch.zeros(1, 8, 2, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        fa.flash_attention_stream(q, q, q)
    with pytest.raises(ValueError):
        z = torch.zeros(1, 8, 2, 160, device=cuda)  # D > 128
        fa.flash_attention_stream(z, z, z)


def test_stream_wgmma_refuses_what_tma_cannot_take(cuda):
    # TMA reads through a map over a contiguous layout from a 16-byte
    # aligned base: a bf16 D = 64 tensor that is neither raises before any
    # launch, and nothing reroutes it to the CUDA-core kernel.
    buf = torch.zeros(1 * 128 * 2 * 64 + 1, dtype=torch.bfloat16,
                      device=cuda)
    shifted = buf[1:].view(1, 128, 2, 64)  # contiguous, 2 bytes off
    ok = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16, device=cuda)
    strided = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16,
                          device=cuda).transpose(1, 2)
    kernels.reset_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_stream(shifted, ok, ok)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_stream(ok, strided, ok)
    c = kernels.counts()
    assert c["launches"]["flash_attention_stream"] == 0
    assert c["variants"]["flash_attention_stream"] == {"wgmma": 0,
                                                       "cuda_cores": 0}


def test_stream_bwd_wgmma_refuses_what_tma_cannot_take(cuda):
    # Row 7's tensor-core form reads q, k, v and do by TMA: any of them at
    # an address that is not 16-byte aligned raises before a launch, and
    # nothing reroutes it to the CUDA-core kernels.
    shape = (1, 128, 2, 64)
    buf = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16,
                      device=cuda)
    shifted = buf[1:].view(shape)
    ok = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(1, 2, 128, device=cuda)
    kernels.reset_counts()
    for i in range(4):
        args = [ok] * 4
        args[i] = shifted
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_bwd_dq_stream(*args, lse, lse, True, 0.125)
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_bwd_dkv_stream(*args, lse, lse, True, 0.125)
    c = kernels.counts()
    for name in STREAM_NAMES[1:]:
        assert c["launches"][name] == 0
        assert c["variants"][name] == {"wgmma": 0, "cuda_cores": 0}


def test_flash_attention_fn_copies_a_misaligned_do_on_the_card(
        cuda, monkeypatch):
    # An incoming gradient at an odd address reaches the tensor-core
    # backward as an aligned copy, and gives the aligned gradient's result.
    monkeypatch.setattr(fa, "_RESIDENT_KV_LIMIT", 0)
    shape = (1, 200, 2, 64)
    rng = np.random.RandomState(18)
    q, k, v = (_t(rng.randn(*shape), torch.bfloat16, cuda)
               .requires_grad_(True) for _ in range(3))
    buf = _t(rng.randn(int(np.prod(shape)) + 1), torch.bfloat16, cuda)
    g = buf[1:].view(shape)
    assert g.data_ptr() % 16
    kernels.reset_counts()
    got = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v),
                               g.clone())
    c = kernels.counts()
    for name in STREAM_NAMES[1:]:
        assert c["variants"][name] == {"wgmma": 2, "cuda_cores": 0}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_long_context_lm_fits_on_the_card_as_on_the_cpu(cuda, monkeypatch):
    # The slice at a small size, every attention streamed: one f32 step on
    # the card and on the CPU from the same params. Adam's m (0.1 * grad)
    # per vertex within 4e-2 of the CPU's largest |m|, as chip_smoke.py's
    # train_parity holds an f32 step: two f32 implementations of a step
    # through relu layers and sums over every token differ there by up to
    # ~1e-2 (a cut gradient is off by about 1).
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    monkeypatch.setattr(fa, "_RESIDENT_KV_LIMIT", 0)
    conf = zoo.transformer_lm(64, t=300, d_model=64, n_heads=2, n_blocks=2)
    cpu = ComputationGraph(conf, device="cpu").init()
    card = ComputationGraph(conf, device=cuda).init(params={
        v: {k: a.detach() for k, a in p.items()}
        for v, p in cpu.params_tree.items()})
    rng = np.random.RandomState(16)
    ids = rng.randint(0, 64, (2, 301))
    batch = MultiDataSet([ids[:, :-1, None]], [ids[:, 1:].astype(np.int32)])
    kernels.reset_counts()
    card.fit(batch)
    c = kernels.counts()
    assert [c["launches"][n] for n in STREAM_NAMES] == [2, 2, 2]
    assert not any(c["plain_calls"].values())
    cpu.fit(batch)
    assert abs(card.score_value - cpu.score_value) <= 1e-4 * abs(
        cpu.score_value)
    for name, st in cpu.opt_state.items():
        for key, m in st["m"].items():
            tol = 4e-2 * float(m.abs().max()) + 1e-12
            assert float((card.opt_state[name]["m"][key].cpu() - m).abs()
                         .max()) <= tol, (name, key)


# ------------------------------- resident rows 3, 5, 6 on the tensor cores

RESIDENT_NAMES = ("flash_attention", "flash_attention_fwd_lse",
                  "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# bf16 at D = 64 and 128 takes the tensor-core form (`fa.resident_variant`):
# less than one tile (T = 1, and 40 as a prompt suffix after a prefix-cache
# hit), one tile, one row into a second, and the training step's T less 24
# and whole; B = 16 is the training step's batch.
RESIDENT_T = [1, 40, 64, 65, 1000, 1024]
WGMMA_ONCE = {"wgmma": 1, "cuda_cores": 0}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("t", RESIDENT_T)
def test_resident_fwd_wgmma_matches_plain(cuda, t, b, d, causal):
    q, k, v, _ = _stream_case(np.random.RandomState(31), (b, t, 2, d),
                              torch.bfloat16, cuda)
    kernels.reset_counts()
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
    o_only = fa.flash_attention(q, k, v, causal)
    c = kernels.counts()
    for name in RESIDENT_NAMES[:2]:
        assert c["launches"][name] == 1
        assert c["variants"][name] == WGMMA_ONCE
    want_o, want_lse = fa.dense_attention_lse(q, k, v, causal)
    _close_rows(o, want_o, torch.bfloat16)
    _close(lse, want_lse, torch.float32)
    _close(o, want_o, torch.bfloat16)
    assert torch.equal(o_only, o)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("t", RESIDENT_T)
def test_resident_bwd_wgmma_matches_plain(cuda, t, b, d, causal):
    q, k, v, do = _stream_case(np.random.RandomState(32), (b, t, 2, d),
                               torch.bfloat16, cuda)
    scale = d ** -0.5
    o, lse = fa.dense_attention_lse(q, k, v, causal)
    drow = fa._drow(o, do)
    kernels.reset_counts()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, drow, causal, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, drow, causal,
                                        scale)
    c = kernels.counts()
    for name in RESIDENT_NAMES[2:]:
        assert c["launches"][name] == 1
        assert c["variants"][name] == WGMMA_ONCE
    want_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, drow, causal, scale)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, drow,
                                              causal, scale)
    # A query that sees one key has ds = p (dp - D) with D = dp: its dq
    # row is 0 in exact arithmetic (the causal row 0), and at T = 1 so is
    # the one dk row. Those rows are held elementwise only.
    held = [(dv, want_dv)]
    if t > 1:
        rows = slice(1 if causal else 0, None)
        held += [(dq[:, rows], want_dq[:, rows]), (dk, want_dk)]
    for got, want in held:
        _close_rows(got, want, torch.bfloat16, BWD_ROW_TOL, ROW_FLOOR)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128])
def test_resident_wgmma_kernels_are_deterministic(cuda, d):
    q, k, v, do = _stream_case(np.random.RandomState(33), (2, 1000, 2, d),
                               torch.bfloat16, cuda)
    kernels.reset_counts()
    runs = []
    for _ in range(2):
        o, lse = fa.flash_attention_fwd_lse(q, k, v, True)
        runs.append((fa.flash_attention(q, k, v), o, lse,
                     *fa.flash_attention_bwd(q, k, v, o, lse, do, True)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    forms = kernels.counts()["variants"]
    assert all(forms[n] == {"wgmma": 2, "cuda_cores": 0}
               for n in RESIDENT_NAMES)


def test_resident_wgmma_refuses_what_tma_cannot_take(cuda):
    # The tensor-core form reads q, k, v (and do) by TMA: any of them at an
    # address that is not 16-byte aligned raises before a launch, and
    # nothing reroutes it to the CUDA-core kernels.
    shape = (2, 100, 2, 64)
    buf = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16,
                      device=cuda)
    shifted = buf[1:].view(shape)
    ok = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(2, 2, 100, device=cuda)
    kernels.reset_counts()
    for i in range(3):
        args = [ok] * 3
        args[i] = shifted
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention(*args)
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_fwd_lse(*args)
    for i in range(4):
        args = [ok] * 4
        args[i] = shifted
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_bwd_dq(*args, lse, lse, True, 0.125)
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_bwd_dkv(*args, lse, lse, True, 0.125)
    c = kernels.counts()
    for name in RESIDENT_NAMES:
        assert c["launches"][name] == 0
        assert c["variants"][name] == {"wgmma": 0, "cuda_cores": 0}


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_fn_trains_through_the_resident_wgmma_form(cuda, d):
    # The training seam in bf16: forward with lse, dq and dk/dv all on the
    # tensor-core form, the gradients held against the CPU's plain path.
    rng = np.random.RandomState(34)
    q, k, v, g = (_t(rng.randn(2, 300, 2, d), torch.bfloat16, cuda)
                  for _ in range(4))
    ref = [a.detach().cpu().requires_grad_(True) for a in (q, k, v)]
    ts = [a.requires_grad_(True) for a in (q, k, v)]
    kernels.reset_counts()
    got = torch.autograd.grad(fa.flash_attention(*ts), ts, g)
    with torch.no_grad():
        fa.flash_attention(*ts)
    c = kernels.counts()
    for name in RESIDENT_NAMES:
        assert c["launches"][name] == 1
        assert c["variants"][name] == WGMMA_ONCE
    assert not any(c["launches"][n] for n in STREAM_NAMES)
    assert not any(c["plain_calls"].values())
    want = torch.autograd.grad(fa.flash_attention(*ref), ref, g.cpu())
    for a, b in zip(got, want):
        _close(a, b.to(cuda), torch.bfloat16)


def test_flash_attention_fn_copies_a_misaligned_do_when_resident(cuda):
    # An incoming gradient at an odd address reaches the resident
    # tensor-core backward as an aligned copy, and gives the aligned
    # gradient's result.
    shape = (2, 200, 2, 64)
    rng = np.random.RandomState(35)
    q, k, v = (_t(rng.randn(*shape), torch.bfloat16, cuda)
               .requires_grad_(True) for _ in range(3))
    buf = _t(rng.randn(int(np.prod(shape)) + 1), torch.bfloat16, cuda)
    g = buf[1:].view(shape)
    assert g.data_ptr() % 16
    kernels.reset_counts()
    got = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v),
                               g.clone())
    c = kernels.counts()
    for name in RESIDENT_NAMES[2:]:
        assert c["variants"][name] == {"wgmma": 2, "cuda_cores": 0}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_lm_resumes_bit_for_bit_and_rolls_back_in_place(cuda, tmp_path):
    # A small LM (bf16 compute, D = 64: rows 1, 5, 6 and 9 on the card)
    # resumed from a sharded checkpoint equals its uninterrupted run bit
    # for bit; a rollback restores in place, and the step after it moves
    # the restored params.
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.util.failure import (
        FailureDetectionListener,
    )

    conf = lambda: zoo.transformer_lm(256, t=128, d_model=128, n_heads=2,
                                      n_blocks=2, dtype="bfloat16")
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(2):
        ids = rng.randint(0, 256, (4, 129))
        batches.append(MultiDataSet(
            [torch.as_tensor(ids[:, :-1, None], device=cuda)],
            [torch.as_tensor(ids[:, 1:].astype(np.int32), device=cuda)]))
    ref = ComputationGraph(conf(), device=cuda).init()
    mgr = CheckpointManager(str(tmp_path / "m"), save_every=3, device=cuda)
    for k in range(6):
        ref.fit(batches[k % 2])
        mgr.maybe_save(ref)
    mgr.flush()
    kernels.reset_counts()
    net = mgr.restore(step=3)
    assert net.device.type == "cuda" and net.iteration == 3
    for k in range(3, 6):
        net.fit(batches[k % 2])
    assert kernels.counts()["launches"]["fused_update"] == 3
    assert not any(kernels.counts()["plain_calls"].values())
    for (v, p) in ref.params_tree.items():
        for k, t in p.items():
            assert torch.equal(net.params_tree[v][k], t), (v, k)
    assert ref.updater_state_flat().tobytes() == \
        net.updater_state_flat().tobytes()
    assert net.score_value == ref.score_value

    ckpts = CheckpointListener(str(tmp_path / "l"), frequency=2,
                               format="sharded")
    watchdog = FailureDetectionListener(ckpts, check_frequency=1)
    net.set_listeners(ckpts, watchdog)
    net.fit(batches[0])  # iteration 7
    net.fit(batches[1])  # iteration 8: saved
    leaf = net.params_tree["emb"]["W"]
    with torch.no_grad():
        leaf.mul_(float("nan"))
    net.fit(batches[0])
    net.fit(batches[1])
    assert watchdog.recoveries == 1 and net.iteration == 8
    assert net.params_tree["emb"]["W"] is leaf
    assert bool(leaf.isfinite().all())
    restored = leaf.detach().clone()
    net.fit(batches[0])
    assert not torch.equal(leaf, restored)
    assert np.isfinite(net.score_value)


# ---------------------------------------------------------- serving tier


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,n_pages,pos", [
    (5, 16, [1000, 700, 330, 40]),            # the speculative verify shape
    (1, 512, [29990, 30000, 30008, 30016]),   # a 32,768-token cache
    (5, 512, [29990, 30000, 30008, 30016]),
])
def test_paged_split_kernel_verify_rows_and_long_cursors(cuda, dtype, t,
                                                         n_pages, pos):
    # q [4, t, 8, 64] over 64-key pages: t = spec_k + 1 query rows, causal
    # among themselves; and 512 pages a slot from a pool of 2,049 (the
    # long server's), at cursors past 29,000. Past a few hundred keys a
    # row's |o| is below the elementwise limit, so rows are held too.
    args = _paged_case(np.random.RandomState(t + n_pages), dtype, cuda, pos,
                       n_pages=n_pages, t=t)
    plan = fa.paged_split_plan(4, 8, n_pages, 64, 64,
                               args[0].element_size(),
                               fa._sm_count(args[0].get_device()))
    assert plan.n_splits * plan.pages_per_split >= n_pages
    for causal in (True, False):
        got = fa.paged_decode_attention(*args, causal)
        want = fa.paged_gather_dense(*args, causal)
        assert got.shape == (4, t, 8, 64)
        _close(got, want, dtype)
        _close_rows(got, want, dtype)


@pytest.mark.parametrize("index", range(8))
def test_bottleneck_wgmma_at_batch_one_every_i1_shape(cuda, index):
    # I1's 8 block shapes at B = 1 (the smallest /predict bucket): the last
    # stage has M = 49 output rows, less than one 64-row tile.
    h, cin, f1, s, project = _resnet50_block_shapes(224)[index]
    x, params, state = _block(np.random.RandomState(70 + index), 1, h, cin,
                              f1, project, torch.bfloat16, cuda)
    _close_block(*_wgmma_block(x, params, state, (s, s), project, False))


def test_resnet50_predict_of_three_rows_equals_output(cuda):
    # /predict pads 3 rows to the bucket of 4 and runs I1's fused graph
    # through rows 12 and 2; each row equals `output` of the same 3 rows.
    from deeplearning4j_tpu_torch.models import resnet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.serving import InferenceServer

    net = ComputationGraph(resnet.resnet50(image=224, dtype="bfloat16",
                                           fused_blocks=True),
                           device=cuda).init()
    x = np.random.RandomState(0).randn(3, 224, 224, 3).astype(np.float32)
    want = net.output(x)[0]
    server = InferenceServer(net, device=cuda, max_batch_size=4).start()
    try:
        kernels.reset_counts()
        got = server.predict(x)
        counts = kernels.counts()
    finally:
        server.stop()
    assert counts["launches"]["bottleneck_infer"] == 16
    assert counts["launches"]["batchnorm_norm_act"] == 1
    assert not any(counts["plain_calls"].values())
    _close(torch.as_tensor(got), torch.as_tensor(want), torch.bfloat16,
           RESNET_TOL)


# ------------------------------- the rest of the layers and the masks

@pytest.mark.parametrize("dtype", DTYPES)
def test_training_rows_non_causal_at_the_classifier_shape(cuda, dtype):
    # Rows 5 and 6 at the transformer classifier's unmasked step, [16,
    # 1024, 8, 64] non-causal: bf16 on the tensor cores, f32 on the CUDA
    # cores, held elementwise and row by row as the causal rows are.
    q, k, v, do = _stream_case(np.random.RandomState(40), (16, 1024, 8, 64),
                               dtype, cuda)
    scale = 64 ** -0.5
    want_o, want_lse = fa.dense_attention_lse(q, k, v, False)
    drow = fa._drow(want_o, do)
    kernels.reset_counts()
    o, lse = fa.flash_attention_fwd_lse(q, k, v, False)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, drow, False, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, drow, False, scale)
    c = kernels.counts()
    form = "wgmma" if dtype == torch.bfloat16 else "cuda_cores"
    for name in RESIDENT_NAMES[1:]:
        assert c["launches"][name] == 1
        assert c["variants"][name][form] == 1
    _close(o, want_o, dtype)
    _close_rows(o, want_o, dtype)
    _close(lse, want_lse, torch.float32)
    want_dq = fa.flash_bwd_dq_plain(q, k, v, do, want_lse, drow, False,
                                    scale)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, want_lse, drow,
                                              False, scale)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        _close(got, want, dtype)
        _close_rows(got, want, dtype, BWD_ROW_TOL, ROW_FLOOR)


@pytest.mark.parametrize("shape,kw", [
    ((8, 54, 54, 96), {}),                       # AlexNet's first LRN
    ((8, 26, 26, 256), {}),                      # and its second
    ((3, 5, 7, 11), dict(n=4.0, alpha=1e-2, beta=0.5, k=1.0)),
])
def test_lrn_on_the_card_matches_the_cpu(cuda, shape, kw):
    # LRN is plain PyTorch (the JAX package has no kernel for it): the
    # card's result holds to the CPU's in f32.
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        LocalResponseNormalization)
    from deeplearning4j_tpu_torch.nn.layers.convolution import lrn_apply

    conf = LocalResponseNormalization(**kw)
    x = torch.tensor(np.random.RandomState(41).randn(*shape) * 3,
                     dtype=torch.float32)
    want, _ = lrn_apply(conf, {}, {}, x)
    got, _ = lrn_apply(conf, {}, {}, x.to(cuda))
    assert got.is_cuda
    _close(got.cpu(), want, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_masked_attention_on_the_card_matches_the_cpu(cuda, dtype, causal):
    # The masked dense attention (plain PyTorch, f32 at least, as the
    # reference's XLA path) on the card against the CPU, a fully masked
    # row included (zeros).
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        _masked_dense_attention)

    rng = np.random.RandomState(42)
    q, k, v = (torch.tensor(rng.randn(4, 256, 8, 64), dtype=dtype)
               for _ in range(3))
    mask = torch.tensor(rng.rand(4, 256) < 0.7, dtype=torch.float32)
    mask[2] = 0.0
    want = _masked_dense_attention(q, k, v, mask, causal, 0.125)
    got = _masked_dense_attention(*(a.to(cuda) for a in (q, k, v)),
                                  mask.to(cuda), causal, 0.125)
    assert got.is_cuda and got.dtype == dtype
    assert not got[2].any()
    _close(got.cpu(), want, dtype)


def test_dropout_draws_on_a_cuda_generator(cuda):
    # The draw function on a card tensor draws on the card (a CUDA
    # generator seeded from the layer's key): keep share, scaling, the same
    # key the same mask, another key another, uncorrelated.
    from deeplearning4j_tpu_torch.nn import prng
    from deeplearning4j_tpu_torch.nn.layers import common

    x = torch.ones(128, 6400, device=cuda)
    key = prng.LayerKey(prng.prng_key(7), 0)
    out = common.inverted_dropout(x, 0.5, key, True)
    assert out.is_cuda
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.005
    assert bool((out[kept] == 2.0).all())
    assert torch.equal(common.inverted_dropout(x, 0.5, key, True), out)
    other = common.draw_keep(prng.LayerKey(prng.prng_key(7), 1), 0.5,
                             x.shape, x.device)
    assert other.is_cuda and not torch.equal(other, kept)
    a, b = kept.float().flatten(), other.float().flatten()
    corr = float(((a - a.mean()) * (b - b.mean())).mean()
                 / (a.std() * b.std()))
    assert abs(corr) < 0.01


@pytest.fixture
def shared_draws(monkeypatch):
    """The port's draws made on the CPU and moved, so the card and the CPU
    see the same noise."""
    from deeplearning4j_tpu_torch.nn.layers import common

    was = {k: getattr(common, k) for k in (
        "draw_keep", "draw_uniform", "draw_normal", "draw_bernoulli")}
    monkeypatch.setattr(common, "draw_keep", lambda key, r, shape, d: was[
        "draw_keep"](key, r, shape, "cpu").to(d))
    monkeypatch.setattr(common, "draw_uniform", lambda key, lo, hi, shape,
                        dt, d: was["draw_uniform"](key, lo, hi, shape, dt,
                                                   "cpu").to(d))
    monkeypatch.setattr(common, "draw_normal", lambda key, shape, dt, d: was[
        "draw_normal"](key, shape, dt, "cpu").to(d))
    monkeypatch.setattr(common, "draw_bernoulli", lambda key, p, shape, d: was[
        "draw_bernoulli"](key, p.cpu() if isinstance(p, torch.Tensor) else p,
                          shape, "cpu").to(d))


def _rel_close(got, want, tol=1e-4):
    want = want.detach().float().cpu()
    err = float((got.detach().float().cpu() - want).abs().max())
    assert err <= tol * float(want.abs().max()), (err, tol)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, shared_draws, top_k):
    # The MoE FFN (plain PyTorch on both devices, f32 inside, as the
    # reference's XLA path): the same routing exactly (choices, slots,
    # kept), y and the gradients within 1e-4 of their largest value, under
    # capacity pressure and jitter.
    from deeplearning4j_tpu_torch.nn import prng
    from deeplearning4j_tpu_torch.parallel import expert

    rng = np.random.RandomState(43)
    p = {"gate_w": rng.randn(64, 4), "w1": rng.randn(4, 64, 256) * 0.1,
         "b1": rng.randn(4, 256) * 0.1, "w2": rng.randn(4, 256, 64) * 0.1,
         "b2": rng.randn(4, 64) * 0.1}
    x = rng.randn(4096, 64)
    dy = torch.tensor(rng.randn(4096, 64), dtype=torch.float32)
    key = prng.LayerKey(prng.prng_key(5), 1)
    out = {}
    for dev in ("cpu", cuda):
        px = {k: torch.tensor(v, dtype=torch.float32, device=dev,
                              requires_grad=True) for k, v in p.items()}
        xx = torch.tensor(x, dtype=torch.float32, device=dev,
                          requires_grad=True)
        routing = []
        y, aux = expert.moe_ffn(px, xx, capacity_factor=0.9, top_k=top_k,
                                rng=key, jitter_eps=0.05, return_aux=True,
                                routing=routing)
        ((y * dy.to(dev)).sum() + aux).backward()
        out[str(dev)] = (y, aux, routing[0], xx.grad,
                         {k: a.grad for k, a in px.items()})
    (yc, ac, rc, dxc, gc), (yp, ap, rp, dxp, gp) = out["cuda"], out["cpu"]
    assert yc.is_cuda
    for f in ("expert", "slot", "keep"):
        assert torch.equal(getattr(rc, f).cpu(), getattr(rp, f)), f
    assert not bool(rp.keep.all())  # capacity pressure drops tokens
    for got, want in ((yc, yp), (ac, ap), (rc.gate, rp.gate), (dxc, dxp),
                      *((gc[k], gp[k]) for k in p)):
        _rel_close(got, want)


def test_moe_lm_step_launches_what_the_dense_lm_step_does(cuda):
    # A bf16 MoE LM step on the card: 2 * blocks + 1 LayerNorm, blocks
    # each of rows 5, 6 dq and 6 dk/dv (tensor cores), one update launch,
    # no plain version; the score finite.
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = ComputationGraph(zoo.transformer_lm(
        256, t=128, d_model=128, n_heads=2, n_blocks=2, moe=True,
        dtype="bfloat16"), device=cuda).init()
    ids = torch.randint(0, 256, (2, 129), device=cuda)
    batch = MultiDataSet([ids[:, :-1, None]], [ids[:, 1:].int()])
    net.fit(batch)
    kernels.reset_counts()
    net.fit(batch)
    torch.cuda.synchronize()
    got = kernels.counts()
    want = {n: 0 for n in kernels.KERNELS}
    want.update(layernorm_norm_act=5, flash_attention_fwd_lse=2,
                flash_attention_bwd_dq=2, flash_attention_bwd_dkv=2,
                fused_update=1)
    assert got["launches"] == want
    assert not any(got["plain_calls"].values())
    assert np.isfinite(net.score_value)


def _pretrain_net_conf(kind):
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        NeuralNetConfiguration)

    b = (NeuralNetConfiguration.builder().seed(3).learning_rate(1e-3)
         .updater("rmsprop" if kind == "vae" else "adam").list())
    if kind == "vae":
        b = b.layer(L.VariationalAutoencoder(
            n_out=2, encoder_layer_sizes=(64, 64), decoder_layer_sizes=(64,),
            reconstruction_distribution="bernoulli", activation="leakyrelu"))
    elif kind == "ae_rbm":
        b = (b.layer(L.AutoEncoder(n_out=48, corruption_level=0.3,
                                   activation="sigmoid"))
             .layer(L.RBM(n_out=32, k=1)))
    else:
        b = b.layer(L.DenseLayer(n_out=32, activation="tanh"))
    last = (L.CenterLossOutputLayer(n_out=10, activation="softmax",
                                    loss_function="mcxent", alpha=0.3)
            if kind == "center_loss" else
            L.LossLayer(activation="softmax", loss_function="mcxent")
            if kind == "loss_layer" else
            L.OutputLayer(n_out=10, activation="softmax",
                          loss_function="mcxent"))
    if kind == "loss_layer":
        b = b.layer(L.DenseLayer(n_out=10))
    return (b.layer(last).pretrain(kind in ("vae", "ae_rbm"))
            .backprop(kind != "vae")
            .set_input_type(InputType.feed_forward(100)).build())


@pytest.mark.parametrize("kind", ["vae", "ae_rbm", "center_loss",
                                  "loss_layer"])
def test_pretrain_and_last_layers_on_the_card_match_the_cpu(cuda,
                                                            shared_draws,
                                                            kind):
    # One `fit` call (pretraining steps first where the conf says so) from
    # the same params with the same draws: one update launch a step, no
    # plain version; scores, updater state and declared state (the
    # centers) within 1e-3 of their largest value (f32; the normalised
    # updaters' first step is about lr * sign(g)).
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.RandomState(44)
    x = (rng.rand(32, 100) > 0.5).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 32)]
    conf = _pretrain_net_conf(kind)
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    card = MultiLayerNetwork(conf, device=cuda).init(params={
        k: {n: a.detach() for n, a in p.items()}
        for k, p in cpu.params_tree.items()})
    cpu.fit(DataSet(x, y))
    kernels.reset_counts()
    card.fit(DataSet(x, y))
    torch.cuda.synchronize()
    got = kernels.counts()
    assert got["launches"]["fused_update"] == card.iteration > 0
    assert not any(got["plain_calls"].values())
    assert card.iteration == cpu.iteration
    np.testing.assert_allclose(card.score_value, cpu.score_value, rtol=1e-3)
    for lk, st in cpu.opt_state.items():
        for f, s in st.items():
            for k, a in s.items():
                _rel_close(card.opt_state[lk][f][k], a, 1e-3)
    for lk, st in cpu.state.items():
        for k, a in st.items():
            _rel_close(card.state[lk][k], a, 1e-3)
            assert a.abs().max() > 0  # the centers moved


def test_the_new_draws_on_a_cuda_generator(cuda):
    # The jitter, epsilon and Gibbs draws on a card tensor are made on the
    # card from the key: the same key the same draw, another key another,
    # the distributions as named.
    from deeplearning4j_tpu_torch.nn import prng
    from deeplearning4j_tpu_torch.nn.layers import common

    k1, k2 = prng.split(prng.prng_key(9))
    n = 1 << 20
    u = common.draw_uniform(prng.LayerKey(k1, 2), 0.99, 1.01, (n,),
                            torch.float32, cuda)
    assert u.is_cuda and float(u.min()) >= 0.99 and float(u.max()) < 1.01
    assert torch.equal(u, common.draw_uniform(prng.LayerKey(k1, 2), 0.99,
                                              1.01, (n,), torch.float32,
                                              cuda))
    z = common.draw_normal(k1, (n,), torch.float32, cuda)
    assert z.is_cuda and abs(float(z.mean())) < 0.01
    assert abs(float(z.std()) - 1.0) < 0.01
    assert not torch.equal(z, common.draw_normal(k2, (n,), torch.float32,
                                                 cuda))
    p = torch.full((n,), 0.3, device=cuda)
    b = common.draw_bernoulli(prng.fold_in(k1, 1), p, (n,), cuda)
    assert b.is_cuda and abs(float(b.float().mean()) - 0.3) < 0.005
