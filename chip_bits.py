#!/usr/bin/env python3
"""Hold this tree's norm_act and LSTM-cell kernels bit for bit against an
older build of `csrc/norm_act.cu` (and `csrc/lstm_cell.cu`), on one
NVIDIA GPU.

    python3 chip_bits.py OLD_CSRC_DIR

OLD_CSRC_DIR holds the older `norm_act.cu` and the `common.cuh` beside it
(`git show REV:deeplearning4j_tpu_torch/kernels/csrc/norm_act.cu` and the
same for `common.cuh`), and may hold the older `lstm_cell.cu`. The older
BatchNorm entry either takes this tree's arguments (each vector by pointer
and kind, or by value: a tree at or after the redesign of row 2), or
mean, var, gamma and beta as contiguous [C] tensors already at the
kernel's dtype (x's; f32 for an f16 x: its wrapper cast them before the
launch); the LayerNorm entry has this tree's signature. The script builds
those sources, with this tree's nvcc flags, into `build/bits/`, builds
this tree's kernels, and then compares y with `torch.equal`:

- BatchNorm apply on every `chip_smoke.rn_bn_inputs` case (T1's stem, s0
  and s3 BatchNorms at B=256; bf16, f16 and f32; training and inference
  vectors), each under its own activation, and the s0 training case under
  all four; the older kernel gets the vectors cast as its wrapper cast
  them;
- LayerNorm at widths both builds take: [4, 512], [16384, 512], [7, 24],
  [3, 1024] and, in bf16 and f16, [5, 2048] (rows of at most 4,096
  bytes), under the four activations;
- with an older `lstm_cell.cu` (whose entry takes the 6-field
  `CellParams` of xw_stride, b, n, act, gate and dtype), the LSTM cell's
  h, c and out at the char-RNN's shapes (`chip_smoke.rnn_cell_cases`:
  B=32 n=256 with peepholes, B=1, n=200, masked, no peepholes) in f32,
  bf16 and f16, under sigmoid / tanh and four other gate / cell pairs.

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


def same_bn_entry(old_dir: Path) -> bool:
    """Whether the older BatchNorm entry takes this tree's arguments."""
    return "kByValue" in (old_dir / "norm_act.cu").read_text()


def build_old(build, old_dir: Path) -> ctypes.CDLL:
    out = HERE / "build" / "bits"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libold_kernels.so"
    srcs = [str(old_dir / n) for n in ("norm_act.cu", "lstm_cell.cu")
            if (old_dir / n).is_file()]
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", *srcs, "-o", str(so)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dl4j_batchnorm_norm_act.argtypes = (
        build._SIGNATURES["dl4j_batchnorm_norm_act"]
        if same_bn_entry(old_dir) else [p] * 6 + [i, i, f, i, i, p])
    lib.dl4j_layernorm_norm_act.argtypes = [p] * 4 + [i, i, f, i, i, p]
    fns = [lib.dl4j_batchnorm_norm_act, lib.dl4j_layernorm_norm_act]
    if (old_dir / "lstm_cell.cu").is_file():
        lib.dl4j_lstm_cell.argtypes = [p] * 11
        fns.append(lib.dl4j_lstm_cell)
    for fn in fns:
        fn.restype = ctypes.c_int
    return lib


class OldCellParams(ctypes.Structure):
    """The older LSTM entry's scalars (before the "z out" field)."""
    _fields_ = [("xw_stride", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("b", "n", "act", "gate", "dtype")]


LSTM_ACTS = (("sigmoid", "tanh"), ("hardsigmoid", "tanh"),
             ("sigmoid", "softsign"), ("tanh", "relu"), ("swish", "elu"))


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
    old_dir = Path(sys.argv[1]).resolve()
    old = build_old(_build, old_dir)
    same_entry = same_bn_entry(old_dir)
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
                    if same_entry:  # this tree's arguments, vectors as given
                        args = [norm_act._vector_arg(v, ch, 0, n) for v, n
                                in zip(vecs, ("mean", "var", "gamma",
                                              "beta"))]
                        kinds = 0
                        for j, (_, kind, _) in enumerate(args):
                            kinds |= kind << (4 * j)
                        rc = old.dl4j_batchnorm_norm_act(
                            x.data_ptr(), *(q for q, _, _ in args),
                            out.data_ptr(), rows, ch, 1e-5,
                            norm_act._act_code(a),
                            norm_act.DTYPE_CODES[x.dtype], kinds,
                            *(v for _, _, v in args), stream)
                    else:
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
    if (old_dir / "lstm_cell.cu").is_file():
        from deeplearning4j_tpu_torch.kernels import lstm_cell as lc

        for dtype in ("float32", "bfloat16", "float16"):
            for case in chip_smoke.rnn_cell_cases(torch, dev, dtype):
                label, kern = case[1], case[2]
                xw, h, c, rw, pw, m = kern.__defaults__[0]
                for gate, act in LSTM_ACTS:
                    new = lc.lstm_cell(xw, h, c, rw, pw, m, gate, act)
                    b, n = h.shape
                    prm = OldCellParams(xw.stride(0), b, n,
                                        lc.ACT_CODES[act], lc.ACT_CODES[gate],
                                        lc.DTYPE_CODES[xw.dtype])
                    was = [torch.empty_like(h) for _ in range(3)]
                    mm = None if m is None else m.to(xw.dtype).contiguous()
                    rc = old.dl4j_lstm_cell(
                        xw.data_ptr(), h.data_ptr(), c.data_ptr(),
                        rw.data_ptr(), None if pw is None else pw.data_ptr(),
                        None if mm is None else mm.data_ptr(),
                        was[0].data_ptr(), was[1].data_ptr(),
                        None if mm is None else was[2].data_ptr(),
                        ctypes.addressof(prm), stream)
                    if rc:
                        raise RuntimeError(f"older LSTM entry: CUDA error "
                                           f"{rc}")
                    if mm is None:
                        was[2] = was[0]
                    for part, a_new, a_was in zip(("h", "c", "out"), new,
                                                  was):
                        report("lstm_cell", f"{label} {part}", dtype,
                               f"{gate}/{act}", a_new, a_was)
    ptxas = {k: v for k, v in _build.last_build.get("ptxas", {}).items()
             if "batchnorm_kernel" in k or "layernorm" in k
             or "lstm_cell_kernel" in k}
    print(json.dumps({"cases": len(results), "bit_equal": sum(results),
                      "older_source": str(Path(sys.argv[1]).resolve()),
                      "ptxas": ptxas, "card": card}), flush=True)
    return 0 if all(results) else 1


if __name__ == "__main__":
    os.chdir(HERE)
    sys.exit(main())
