"""Native (C++) runtime components of the port (counterpart of
`deeplearning4j_tpu/native/__init__.py`).

- `fastcsv` (`fastcsv.cpp`): numeric CSV -> float32 matrix
  (`parse_numeric_csv`), used by `datasets/records.py`'s
  `CSVRecordReader.numeric_matrix`.
- `fastvocab` (`fastvocab.cpp`): tokenizer + vocab counter + corpus encoder
  (`build_vocab_corpus`), used by the embedding trainers (`nlp/word2vec.py`,
  `nlp/glove.py`, `nlp/paragraph_vectors.py`) and
  `nlp/distributed_corpus.py`.

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
that the parser ran. Likewise a corpus the vocab builder refuses by design
(`build_vocab_corpus` returns None: a tokenizer it has no equivalent of,
non-ASCII raw text, a token holding whitespace) goes to the Python path,
which builds the same vocab, and `corpus_paths` counts the corpora each
path took.
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
# Corpora whose vocab the native builder and the Python path built.
corpus_paths: Dict[str, int] = {"native": 0, "python": 0}


def reset_counts() -> None:
    for counts in (file_paths, corpus_paths):
        for k in counts:
            counts[k] = 0


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("g++ not found on PATH: the port's native components "
                       "(the CSV parser, the vocab builder) are built from "
                       "deeplearning4j_tpu_torch/native/*.cpp at first use "
                       "and need a C++ compiler")


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


def _configure_fastvocab(lib: ctypes.CDLL) -> None:
    L = ctypes.c_long
    lib.vocab_build.restype = L
    lib.vocab_build.argtypes = [ctypes.c_char_p, L, ctypes.c_int,
                                ctypes.c_int, ctypes.c_double]
    lib.vocab_stats.restype = L
    lib.vocab_stats.argtypes = [L] + [ctypes.POINTER(L)] * 5
    lib.vocab_dump.restype = L
    lib.vocab_dump.argtypes = [L, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_double)]
    lib.vocab_encode.restype = L
    lib.vocab_encode.argtypes = [L, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_longlong)]
    lib.vocab_free.restype = None
    lib.vocab_free.argtypes = [L]


_CONFIGURE = {"fastcsv": _configure_fastcsv,
              "fastvocab": _configure_fastvocab}


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


def _refused():
    corpus_paths["python"] += 1
    return None


def build_vocab_corpus(sentences, min_word_frequency: float = 1.0,
                       tokenizer_factory=None):
    """Native tokenize + vocab count + encode for the embedding trainers.

    Returns (words, counts, seqs): the vocab words in `finalize_vocab`
    order, their float64 counts, and each sentence as an int32 index array
    with OOV tokens dropped. Returns None for a corpus whose result the
    byte-level builder cannot guarantee to be Python's (the reference's
    guards: a tokenizer other than the default whitespace one, bare or with
    `CommonPreprocessor`; non-ASCII raw text; a raw sentence holding a
    newline; a pre-split token holding whitespace; a corpus mixing strings
    and token lists; one that is not a list or tuple): the caller then
    builds the vocab in Python, to the same result. A builder that cannot
    be built, or fails on a corpus it took, raises."""
    from deeplearning4j_tpu_torch.nlp.tokenization import (
        CommonPreprocessor, TokenizerFactory,
    )

    if not isinstance(sentences, (list, tuple)):
        return _refused()
    # Only the default whitespace tokenizer, bare or with
    # CommonPreprocessor, has a native equivalent.
    mode = 0
    if tokenizer_factory is not None:
        if type(tokenizer_factory) is not TokenizerFactory:
            return _refused()
        pre = tokenizer_factory.preprocessor
        if type(pre) is CommonPreprocessor:
            mode = 1
        elif pre is not None:
            return _refused()
    if all(isinstance(s, str) for s in sentences):
        raw = True
        try:
            buf = "\n".join(sentences).encode("utf-8")
        except UnicodeError:
            return _refused()
        # str.split also splits on Unicode whitespace: raw text must be
        # ASCII, so that splitting bytes cannot diverge.
        strict_ascii = 1
    elif all(isinstance(s, (list, tuple)) for s in sentences):
        raw = False
        try:
            buf = "\n".join(" ".join(s) for s in sentences).encode("utf-8")
        except (TypeError, UnicodeError):
            return _refused()
        # Token lists are used as they are (no preprocessor); UTF-8 byte
        # order is code-point order, so non-ASCII tokens sort the same.
        mode = 0
        strict_ascii = 0
    else:
        return _refused()

    lib = load("fastvocab")
    h = lib.vocab_build(buf, len(buf), mode, strict_ascii,
                        float(min_word_frequency))
    if h == -2:
        return _refused()  # non-ASCII where the mode needs ASCII
    if h < 0:
        raise RuntimeError(f"fastvocab: vocab_build failed ({h})")
    try:
        n_words, words_bytes, n_seqs, n_idx, n_raw = (
            ctypes.c_long() for _ in range(5))
        if lib.vocab_stats(h, ctypes.byref(n_words), ctypes.byref(words_bytes),
                           ctypes.byref(n_seqs), ctypes.byref(n_idx),
                           ctypes.byref(n_raw)) != 0:
            raise RuntimeError("fastvocab: vocab_stats lost its handle")
        if n_seqs.value != len(sentences):
            return _refused()  # a raw sentence held a newline, or a token
        if not raw and n_raw.value != sum(len(s) for s in sentences):
            return _refused()  # a token held whitespace
        wb = ctypes.create_string_buffer(max(1, words_bytes.value))
        counts = np.zeros((n_words.value,), np.float64)
        ids = np.zeros((max(1, n_idx.value),), np.int32)
        offs = np.zeros((n_seqs.value + 1,), np.int64)
        if (lib.vocab_dump(h, wb, counts.ctypes.data_as(
                ctypes.POINTER(ctypes.c_double))) != 0
                or lib.vocab_encode(
                    h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
                != 0):
            raise RuntimeError("fastvocab: vocab_dump/encode lost its handle")
    finally:
        lib.vocab_free(h)
    words = (wb.raw[:words_bytes.value].decode("utf-8").split("\n")[:-1]
             if words_bytes.value else [])
    ids = ids[:n_idx.value]
    corpus_paths["native"] += 1
    return words, counts, [ids[offs[i]:offs[i + 1]]
                           for i in range(n_seqs.value)]
