"""Build and load the hand-written Hopper kernels.

`csrc/*.cu` compile with `nvcc -gencode arch=compute_90a,code=sm_90a` into
one shared library with a plain C interface, bound with ctypes (pointers and
the CUDA stream as `c_void_p`, so nothing is cut to 32 bits). The build runs
at first use, never at import: one `nvcc -c` per source, all started
together, then one link. The library lands in `build/kernels/` beside the
package, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads what is there. Only the repository's
sources and the CUDA toolkit are used.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SCHED = [_P, _P, _P, _I, _P, _I]  # a visit list cut into units
_SIGNATURES = {
    "dl4j_layernorm_norm_act": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    # ... | dtype, variant (0 CUDA cores, 1 tensor cores), stream.
    "dl4j_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                 _I, _P],
    # q, k, v, table, pos, o, partials, counters, params (the shape, plan,
    # mask, dtype and scale: `flash_attention._PagedParams`), stream.
    "dl4j_paged_decode_attention": [_P] * 10,
    "dl4j_flash_attention_fwd_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _F, _I, _I, _P],
    "dl4j_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _F, _I, _I, _P],
    "dl4j_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _F, _I, _I, _P],
    # kind, mode, count | ptrs, sizes, lrs, factors, scalars, stream.
    "dl4j_fused_update": [_I, _I, _I] + [_P] * 6,
    "dl4j_fused_update_capacity": [],
    "dl4j_batchnorm_norm_act": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I,
                                _P],
    # ... | out, psum, psq, variant (0 CUDA cores, 1 tensor cores), stream.
    "dl4j_bottleneck_conv": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P, _P, _I, _F, _P, _I, _P, _I, _P, _P,
                             _P, _I, _P],
    "dl4j_bottleneck_stats": [_P, _P, _I, _I, _I, _P, _P, _P],
    "dl4j_bottleneck_tail": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _F, _I, _P, _P],
    # xw, h, c, rw, pw, m, h_out, c_out, out, params (xw_stride, b, n,
    # act, dtype: `lstm_cell._CellParams`), stream.
    "dl4j_lstm_cell": [_P] * 11,
    # q, k, v, o, lse | pair_i, pair_j, units, n_units, merges, n_merges |
    # partials | n_slots, batch, seq, heads, dim, causal | scale, dtype,
    # variant, stream.
    "dl4j_flash_attention_stream_fwd": [_P] * 5 + _SCHED + [_P] * 2
    + [_I] * 6 + [_F, _I, _I, _P],
    "dl4j_flash_attention_stream_bwd_dq": [_P] * 7 + _SCHED + [_P]
    + [_I] * 6 + [_F, _I, _I, _P],
    "dl4j_flash_attention_stream_bwd_dkv": [_P] * 8 + _SCHED + [_P] * 2
    + [_I] * 6 + [_F, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Each entry point's bound function object, filled at the first launch.
_fns: Dict[str, ctypes._CFuncPtr] = {}
_NO_GUARD = contextlib.nullcontext()
# What the last build did: command lines, seconds, ptxas resource lines by
# kernel.
last_build: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from deeplearning4j_tpu_torch/kernels/"
        "csrc at first use and need the CUDA toolkit")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(force: bool) -> Path:
    target = BUILD_DIR / f"libdl4j_kernels-{_digest()}.so"
    if target.is_file() and not force:
        last_build.update(cached=True, path=str(target))
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds, procs = [], [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            cmds.append(cmd)
            objs.append(obj)
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        logs = [p.communicate()[0] for p in procs]
        for cmd, p, log in zip(cmds, procs, logs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
        tmp_so = Path(tmp) / target.name
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                *map(str, objs), "-o", str(tmp_so)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(link)}\n{res.stdout}")
        os.replace(tmp_so, target)  # atomic: a concurrent loader sees all or nothing
    last_build.update(
        cached=False, path=str(target), seconds=time.perf_counter() - t0,
        commands=[" ".join(c) for c in cmds + [link]],
        ptxas=_ptxas_by_kernel(logs))
    return target


def _ptxas_by_kernel(logs) -> Dict[str, List[str]]:
    """`-Xptxas -v`'s resource lines (registers, shared memory, spills)
    under the (mangled) name of the kernel they describe."""
    out: Dict[str, List[str]] = {}
    for log in logs:
        name = None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                name = m.group(1)
            elif name and ("registers" in line or "spill" in line):
                out.setdefault(name, []).append(line.strip())
    return out


def load(force: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use (or anew with `force`)."""
    global _lib
    lib = _lib
    if lib is not None and not force:
        return lib
    with _lock:
        if _lib is None or force:
            lib = ctypes.CDLL(str(_compile(force)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dl4j_error_string.argtypes = [ctypes.c_int]
            lib.dl4j_error_string.restype = ctypes.c_char_p
            _fns.clear()
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point and raise on the CUDA error it returns (a
    refused launch never runs, and a later synchronize does not report
    it). The entry is bound once; later calls take no lock."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns.setdefault(name, getattr(load(), name))
    rc = fn(*args)
    if rc:
        raise RuntimeError(
            f"{name} failed: CUDA error {rc} "
            f"({_lib.dl4j_error_string(rc).decode()})")


def on_device(index: int):
    """`torch.cuda.device(index)` where `index` is not the current device,
    else a context that does nothing (switching costs two device sets)."""
    if index == torch.cuda.current_device():
        return _NO_GUARD
    return torch.cuda.device(index)


def current_stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on card `index`, without
    building a `torch.cuda.Stream`. `_cuda_getCurrentRawStream` is private
    to PyTorch (Triton's launcher reads the stream the same way)."""
    return torch._C._cuda_getCurrentRawStream(index)
