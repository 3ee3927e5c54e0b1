"""The bottleneck block's tensor-core form, checked without a card.

- `bottleneck_variant`, the dispatch rule: "wgmma" for every ResNet-50
  block shape in bf16, "cuda_cores" for f32, int8 weights, mixed weight
  dtypes and widths that are not multiples of 64.
- The wrapper's plumbing: the form each conv entry is handed, its count in
  `kernels.variant_launches`, and a misaligned operand refused before any
  launch (the C calls recorded instead of made).
- The form's rounding, emulated here in PyTorch on the CPU (BatchNorm +
  act in f32, A rounded to bf16 after it and after the SAME padding, bf16
  weights, f32 sums, f32 intermediates, y rounded once), held to the JAX
  package's `_train_body` / `_infer_body` run in interpret mode as its own
  tests run them (tests/test_bottleneck_block.py), at the block's bf16
  tolerance, rtol = atol = 6e-2: the rounding the kernel adds fits the
  tolerance it is held to on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.kernels import bottleneck_block as jax_bb
from deeplearning4j_tpu.kernels import registry
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import bottleneck_block as bb

TOL = dict(rtol=6e-2, atol=6e-2)
EPS = 1e-5
# ResNet-50's stages: (filters, blocks, first stride).
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def resnet50_block_shapes(image):
    """The distinct (H, Cin, F1, stride, project) of ResNet-50's 16 blocks
    at `image` (after the stride-2 stem and the stride-2 pool)."""
    h, cin, out = -(-(-(-image // 2)) // 2), 64, []
    for filters, blocks, first in STAGES:
        for i in range(blocks):
            stride = first if i == 0 else 1
            key = (h, cin, filters, stride, i == 0)
            if key not in out:
                out.append(key)
            h, cin = -(-h // stride), 4 * filters
    return out


@pytest.mark.parametrize("image", [224, 64])
def test_every_resnet50_block_takes_the_tensor_cores_in_bf16(image):
    shapes = resnet50_block_shapes(image)
    assert len(shapes) == 8
    for _, cin, f1, _, _ in shapes:
        assert bb.bottleneck_variant(torch.bfloat16, torch.bfloat16, cin, f1,
                                     4 * f1) == "wgmma"
        assert bb.bottleneck_variant(torch.float16, torch.float16, cin, f1,
                                     4 * f1) == "wgmma"
        assert bb.bottleneck_variant(torch.float32, torch.float32, cin, f1,
                                     4 * f1) == "cuda_cores"
        assert bb.bottleneck_variant(torch.bfloat16, torch.int8, cin, f1,
                                     4 * f1) == "cuda_cores"


@pytest.mark.parametrize("x_dtype,w_dtype,cin,f1,f3", [
    (torch.float32, torch.float32, 256, 64, 256),
    (torch.bfloat16, torch.float32, 256, 64, 256),
    (torch.float32, torch.bfloat16, 256, 64, 256),
    (torch.bfloat16, torch.int8, 256, 64, 256),
    (torch.bfloat16, None, 256, 64, 256),       # weights of mixed dtypes
    (torch.bfloat16, torch.bfloat16, 96, 64, 256),
    (torch.bfloat16, torch.bfloat16, 256, 32, 128),
    (torch.bfloat16, torch.bfloat16, 64, 64, 96),
    (torch.float16, torch.int8, 256, 64, 256),     # int8 served under f16
    (torch.float16, torch.float32, 256, 64, 256),
    (torch.float16, torch.bfloat16, 256, 64, 256),
    (torch.bfloat16, torch.float16, 256, 64, 256),
    (torch.float16, torch.float16, 256, 32, 128),
])
def test_other_dtypes_and_widths_keep_the_cuda_cores(x_dtype, w_dtype, cin,
                                                     f1, f3):
    assert bb.bottleneck_variant(x_dtype, w_dtype, cin, f1, f3) == \
        "cuda_cores"


# ------------------------------------------------ the wrapper's plumbing


def _torch_block(seed, b, h, cin, f1, project, dtype):
    rng = np.random.RandomState(seed)
    f3 = 4 * f1
    dims = {"a": (1, 1, cin, f1), "b": (3, 3, f1, f1), "c": (1, 1, f1, f3),
            "proj": (1, 1, cin, f3)}
    names = ("a", "b", "c") + (("proj",) if project else ())
    x = torch.tensor(rng.randn(b, h, h, cin), dtype=dtype)
    flat, running = [], {}
    for n in names:
        f = dims[n][-1]
        flat += [torch.tensor(rng.randn(*dims[n]) * 0.1, dtype=dtype),
                 torch.tensor(rng.rand(f) + 0.5, dtype=dtype),
                 torch.tensor(rng.randn(f) * 0.1, dtype=dtype)]
        running[f"mean_{n}"] = torch.tensor(rng.randn(f) * 0.1,
                                            dtype=torch.float32)
        running[f"var_{n}"] = torch.tensor(rng.rand(f) + 0.5,
                                           dtype=torch.float32)
    return x, flat, running


@pytest.fixture
def recorded(monkeypatch):
    """The C calls `_kernel_block` makes, recorded as (name, args) instead
    of launched."""
    from deeplearning4j_tpu_torch.kernels import _build

    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda d: torch.no_grad())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    return calls


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"),
                                           (torch.float16, "wgmma"),
                                           (torch.float32, "cuda_cores")])
@pytest.mark.parametrize("train,project", [(True, True), (False, False)])
def test_each_conv_is_handed_the_form_of_the_rule(recorded, dtype, variant,
                                                  train, project):
    x, flat, running = _torch_block(31, 2, 4, 256, 64, project, dtype)
    name = "bottleneck_train" if train else "bottleneck_infer"
    kernels.reset_counts()
    bb._kernel_block(x, flat, None, None if train else running,
                     (2, 2) if project else (1, 1), EPS, "relu", train)
    convs = [args for n, args in recorded if n == "dl4j_bottleneck_conv"]
    assert len(convs) == (4 if project else 3)
    # The variant code is the second-to-last argument (the stream is last).
    assert {args[-2] for args in convs} == {bb._VARIANTS[variant]}
    counts = kernels.counts()
    assert counts["launches"][name] == 1
    assert counts["variants"][name] == {
        "wgmma": int(variant == "wgmma"),
        "cuda_cores": int(variant == "cuda_cores"), "f64": 0}


def test_a_misaligned_operand_is_refused_before_any_launch(recorded):
    x, flat, running = _torch_block(32, 2, 4, 256, 64, False, torch.bfloat16)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    kernels.reset_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        bb._kernel_block(shifted, flat, None, running, (1, 1), EPS, "relu",
                         False)
    assert recorded == []
    assert kernels.counts()["variants"]["bottleneck_infer"] == {
        "wgmma": 0, "cuda_cores": 0, "f64": 0}


# ------------------------------------------------ the rounding, emulated


def _round(t):
    return t.to(torch.bfloat16).float()


def _conv(a, w, stride, pad):
    """f32 sums over bf16 operands: a NHWC (values on the bf16 grid), w HWIO
    bf16; the raw f32 output, NHWC."""
    out = F.conv2d(a.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1)


def _bn(v, mean, var, gamma, beta, act):
    y = gamma.float() * ((v - mean) / torch.sqrt(var + EPS)) + beta.float()
    return torch.relu(y) if act else y


def _stats(v):
    mean = v.mean(dim=(0, 1, 2))
    return mean, (v * v).mean(dim=(0, 1, 2)) - mean * mean


def wgmma_emulation(x, params, running, stride, project, train):
    """What the tensor-core form computes: A rounded to bf16 after the
    previous branch's BatchNorm + act (a 3x3 tap outside the image is a
    zero of the normalized activation: padded after the prologue), f32 sums,
    the raw conv outputs and statistics f32, y rounded once to bf16."""
    xs = x.float()[:, ::stride, ::stride]
    stats = {}

    def norm(v, n, act):
        if train:
            stats[f"mean_{n}"], stats[f"var_{n}"] = _stats(v)
        src = stats if train else running
        return _bn(v, src[f"mean_{n}"], src[f"var_{n}"], params[f"gamma_{n}"],
                   params[f"beta_{n}"], act)

    a = norm(_conv(xs, params["W_a"], 1, 0), "a", True)
    h = norm(_conv(_round(a), params["W_b"], 1, 1), "b", True)
    c = norm(_conv(_round(h), params["W_c"], 1, 0), "c", False)
    shortcut = (norm(_conv(xs, params["W_proj"], 1, 0), "proj", False)
                if project else x.float())
    y = torch.relu(c + shortcut).to(torch.bfloat16)
    return y, (stats if train else None)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_KERNEL_BOTTLENECK_BLOCK", "pallas")
    registry.clear_cache()
    yield
    registry.clear_cache()


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("project,stride", [(False, 1), (True, 2)])
def test_the_forms_rounding_fits_the_tolerance_against_the_tpu_body(
        pallas, train, project, stride):
    b, h, cin, f1 = 2, 7, 256, 64
    x, flat, running = _torch_block(33, b, h, cin, f1, project,
                                    torch.bfloat16)
    names = ("a", "b", "c") + (("proj",) if project else ())
    params = {f"{k}_{n}": flat[3 * i + j] for i, n in enumerate(names)
              for j, k in enumerate(("W", "gamma", "beta"))}
    want_y, want_stats = jax_bb.bottleneck_forward(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
         for k, v in params.items()},
        {k: jnp.asarray(v.numpy()) for k, v in running.items()},
        stride=(stride, stride), project=project, eps=EPS,
        activation="relu", train=train)
    y, stats = wgmma_emulation(x, params, running, stride, project, train)
    assert tuple(y.shape) == want_y.shape
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32), **TOL)
    if train:
        assert set(stats) == set(want_stats) == set(bb.stat_keys(project))
        for k, v in want_stats.items():
            np.testing.assert_allclose(stats[k].numpy(),
                                       np.asarray(v, np.float32), **TOL)
