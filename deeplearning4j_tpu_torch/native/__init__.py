"""Native (C++) runtime components of the port (counterpart of
`deeplearning4j_tpu/native/__init__.py`).

- `fastcsv` (`fastcsv.cpp`): numeric CSV -> float32 matrix
  (`parse_numeric_csv`), used by `datasets/records.py`'s
  `CSVRecordReader.numeric_matrix`.

A component is built with `g++` at its first use, never at import, from the
source beside this file into `build/native/` at the repository's root (the
directory the CUDA kernels build into, `build/kernels/`, is its sibling):
the package directory is never written. The library is named by a hash of
its source and flags, so an edited source rebuilds and an unchanged one
loads what is there. A build that fails raises `RuntimeError` with the
compiler's output; nothing falls back quietly. What does go to the Python
reader is a file the parser does not take by design: one that is not
uniformly numeric, or a delimiter longer than one byte (`parse_numeric_csv`
returns None, and the reader parses the file in Python, to the same
matrix). `file_paths` counts the files each path parsed, so a run shows
that the parser ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Files parsed by the native parser and by the Python reader
# (`datasets/records.py` counts its own).
file_paths: Dict[str, int] = {"native": 0, "python": 0}


def reset_counts() -> None:
    for k in file_paths:
        file_paths[k] = 0


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("g++ not found on PATH: the port's native CSV parser "
                       "is built from deeplearning4j_tpu_torch/native/"
                       "fastcsv.cpp at first use and needs a C++ compiler")


def library_path(name: str) -> Path:
    """Where the library of component `name` is (or will be) built."""
    src = SRC_DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"_{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    target = library_path(name)
    if target.is_file():
        return target
    cxx = _compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / target.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(out), str(SRC_DIR / f"{name}.cpp")]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, timeout=300)
        if res.returncode:
            raise RuntimeError(f"g++ failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}")
        # Atomic: a concurrent loader sees all of the library or nothing.
        os.replace(out, target)
    return target


def _configure_fastcsv(lib: ctypes.CDLL) -> None:
    lib.csv_dims.restype = ctypes.c_long
    lib.csv_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
    lib.csv_parse.restype = ctypes.c_long
    lib.csv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long]


_CONFIGURE = {"fastcsv": _configure_fastcsv}


def load(name: str = "fastcsv") -> ctypes.CDLL:
    """Component `name`'s library, built on first use; raises if it cannot
    be built or loaded."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_build(name)))
            _CONFIGURE[name](lib)
            _libs[name] = lib
        return _libs[name]


def parse_numeric_csv(path: str, delimiter: str = ",",
                      skip: int = 0) -> Optional[np.ndarray]:
    """Parse an all-numeric CSV into a float32 [rows, cols] matrix with the
    native parser (every line counts toward `skip`, blank lines are
    dropped, as `records._read_csv_rows` reads). Returns None for a file
    the parser does not take (a delimiter longer than one byte, a field
    that is not a number, ragged rows, a quote in the skipped lines, a
    file it cannot open): the caller reads it in Python, to the same
    matrix. A parser that cannot be built raises."""
    if len(delimiter.encode()) != 1:
        return None
    lib = load("fastcsv")
    rows, cols = ctypes.c_long(), ctypes.c_long()
    p, d = os.fsencode(path), delimiter.encode()
    if lib.csv_dims(p, d, skip, ctypes.byref(rows), ctypes.byref(cols)) != 0:
        return None
    if rows.value == 0 or cols.value == 0:
        out = np.zeros((rows.value, cols.value), np.float32)
    else:
        out = np.empty((rows.value, cols.value), np.float32)
        if lib.csv_parse(p, d, skip,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         rows.value, cols.value) != 0:
            return None
    file_paths["native"] += 1
    return out
