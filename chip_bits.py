#!/usr/bin/env python3
"""Hold this tree's norm_act kernels bit for bit against an older build of
`csrc/norm_act.cu`, on one NVIDIA GPU.

    python3 chip_bits.py OLD_CSRC_DIR

OLD_CSRC_DIR holds the older `norm_act.cu` and the `common.cuh` beside it
(`git show REV:deeplearning4j_tpu_torch/kernels/csrc/norm_act.cu` and the
same for `common.cuh`), from a tree whose BatchNorm entry takes mean, var,
gamma and beta as contiguous [C] tensors already at the kernel's dtype
(x's; f32 for an f16 x: its wrapper cast them before the launch) and whose
LayerNorm entry has this tree's signature. The script builds that source
alone, with this tree's nvcc flags, into `build/bits/`, builds this tree's
kernels, and then compares y with `torch.equal`:

- BatchNorm apply on every `chip_smoke.rn_bn_inputs` case (T1's stem, s0
  and s3 BatchNorms at B=256; bf16, f16 and f32; training and inference
  vectors), each under its own activation, and the s0 training case under
  all four; the older kernel gets the vectors cast as its wrapper cast
  them;
- LayerNorm at widths both builds take: [4, 512], [16384, 512], [7, 24],
  [3, 1024] and, in bf16 and f16, [5, 2048] (rows of at most 4,096
  bytes), under the four activations.

Each BatchNorm case also carries its times on the card, both builds in
the same process: by CUDA events (`chip_smoke.time_ms`) this tree's
wrapper call, the older kernel alone on vectors cast beforehand, and the
older wrapper's whole call (the casts its `_vec` made, then the kernel);
by the profiler (`chip_smoke.device_ms`) each kernel alone. The summary
line carries the `-Xptxas -v` lines of this tree's norm_act kernels.

One JSON line per case, then a summary line. Exits 1 on any difference,
2 without a GPU.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ACTS = ("identity", "relu", "tanh", "sigmoid")
LN_SHAPES = ((4, 512), (16384, 512), (7, 24), (3, 1024), (5, 2048))


def x_bytes(dtype) -> int:
    import torch

    return torch.tensor([], dtype=dtype).element_size()


def build_old(build, old_dir: Path) -> ctypes.CDLL:
    out = HERE / "build" / "bits"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libold_norm_act.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared",
           str(old_dir / "norm_act.cu"), "-o", str(so)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dl4j_batchnorm_norm_act.argtypes = [p] * 6 + [i, i, f, i, i, p]
    lib.dl4j_layernorm_norm_act.argtypes = [p] * 4 + [i, i, f, i, i, p]
    for fn in (lib.dl4j_batchnorm_norm_act, lib.dl4j_layernorm_norm_act):
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_bits: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke
    from deeplearning4j_tpu_torch.kernels import _build, norm_act

    card = chip_smoke.card_line()
    dev = torch.device("cuda", 0)
    _build.load(force=True)
    old = build_old(_build, Path(sys.argv[1]).resolve())
    stream = _build.current_stream(0)
    results = []

    def report(kernel, label, dtype, act, new, was, **times):
        torch.cuda.synchronize()
        same = torch.equal(new, was)
        diff = float((new.float() - was.float()).abs().max())
        results.append(same)
        print(json.dumps({"kernel": kernel, "case": label, "dtype": dtype,
                          "act": act, "bit_equal": same,
                          "max_abs_diff": diff, **times, "card": card}),
              flush=True)

    for dtype in ("bfloat16", "float16", "float32"):
        for label, x, vecs, act in chip_smoke.rn_bn_inputs(
                torch, dev, dtype, chip_smoke.RN_PATHS["t1"][2]):
            rows, ch = x.shape
            sdt = torch.float32 if x.dtype == torch.float16 else x.dtype
            cast = [a.to(sdt).contiguous() for a in vecs]
            acts = ACTS if label.startswith("s0") and "infer" not in label \
                else (act,)
            for a in acts:
                new = norm_act.batchnorm_norm_act(x, *vecs, 1e-5, a)
                was = torch.empty_like(x)

                def older(cast=cast, a=a, out=was):
                    rc = old.dl4j_batchnorm_norm_act(
                        x.data_ptr(), *(c.data_ptr() for c in cast),
                        out.data_ptr(), rows, ch, 1e-5,
                        norm_act._act_code(a),
                        norm_act.DTYPE_CODES[x.dtype], stream)
                    if rc:
                        raise RuntimeError(f"older BatchNorm entry: CUDA "
                                           f"error {rc}")

                older()
                times = {}
                if a == act:
                    def mine(a=a):
                        norm_act.batchnorm_norm_act(x, *vecs, 1e-5, a)

                    def older_call(a=a):
                        older([v.to(sdt).contiguous() for v in vecs], a,
                              torch.empty_like(x))

                    times = dict(
                        ms=chip_smoke.time_ms(mine),
                        older_kernel_ms=chip_smoke.time_ms(older),
                        older_call_ms=chip_smoke.time_ms(older_call),
                        device_ms=chip_smoke.device_ms(torch, mine),
                        older_device_ms=chip_smoke.device_ms(torch, older),
                        vectors=[str(v.dtype) for v in vecs])
                report("batchnorm_norm_act", label, dtype, a, new, was,
                       **times)
                del new, was
            del x, vecs, cast
        torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(32)
    for dtype in ("bfloat16", "float16", "float32"):
        dt = getattr(torch, dtype)
        for rows, feats in LN_SHAPES:
            if feats * x_bytes(dt) > 4096:
                continue  # past the older kernel's widest row
            x = (torch.randn(rows, feats, generator=g, device=dev) * 2
                 + 0.5).to(dt)
            gamma = (torch.rand(feats, generator=g, device=dev)
                     + 0.5).to(dt)
            beta = torch.randn(feats, generator=g, device=dev).to(dt)
            for a in ACTS:
                new = norm_act.layernorm_norm_act(x, gamma, beta, 1e-5, a)
                was = torch.empty_like(x)
                rc = old.dl4j_layernorm_norm_act(
                    x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    was.data_ptr(), rows, feats, 1e-5,
                    norm_act._act_code(a), norm_act.DTYPE_CODES[dt], stream)
                if rc:
                    raise RuntimeError(f"older LayerNorm entry: CUDA error "
                                       f"{rc}")
                report("layernorm_norm_act", f"[{rows},{feats}]", dtype, a,
                       new, was)
    ptxas = {k: v for k, v in _build.last_build.get("ptxas", {}).items()
             if "batchnorm_kernel" in k or "layernorm" in k}
    print(json.dumps({"cases": len(results), "bit_equal": sum(results),
                      "older_source": str(Path(sys.argv[1]).resolve()),
                      "ptxas": ptxas, "card": card}), flush=True)
    return 0 if all(results) else 1


if __name__ == "__main__":
    os.chdir(HERE)
    sys.exit(main())
