"""Record readers and record-reader dataset iterators (counterpart of
`deeplearning4j_tpu/datasets/records.py`, which is pure numpy; the port
keeps its own copy, as it keeps `dataset.py`).

The reference's DataVec bridge: CSV, CSV-sequence and image record readers
feeding `RecordReaderDataSetIterator`, `SequenceRecordReaderDataSetIterator`
and `RecordReaderMultiDataSetIterator` (deeplearning4j-core's
`datasets/datavec/*`), and the CIFAR-10, LFW and Curves sets with the
reference's deterministic synthetic stand-ins. Batches come out as the
port's host `DataSet` / `MultiDataSet` (numpy), which the engines move to
their device, and which compose with `AsyncDataSetIterator`,
`DeviceCacheDataSetIterator` and `DeviceStager` (`datasets/iterators.py`,
`datasets/staging.py`).

`CSVRecordReader.numeric_matrix` parses with the native parser
(`deeplearning4j_tpu_torch/native`, built with g++ at first use into
build/native/), and reads in Python the files the parser does not take
(not uniformly numeric, a delimiter longer than one byte), to the same
matrix; `native.file_paths` counts the files each path read.

Archives are read only from the directory the caller names in `CIFAR_DIR`,
`LFW_DIR` or `CURVES_DIR` (the reference also looks in directories of its
own); without one the synthetic sets stand in, the same arrays as the
reference's at the same seed. PIL is imported only when an image file is
decoded (`ImageRecordReader._load`).
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    ListDataSetIterator,
)

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


# --------------------------------------------------------------- readers

class RecordReader:
    """Record-reader SPI (reference: DataVec `RecordReader`: initialize
    with a source, then iterate records)."""

    def records(self) -> Iterator[List]:
        raise NotImplementedError

    def reset(self) -> None:
        """Re-read from the start (records() restarts by default)."""

    def __iter__(self):
        return self.records()


def _read_csv_rows(path: str, delimiter: str,
                   skip: int) -> Iterator[List[str]]:
    """The one definition of the CSV row rules: every line counts toward
    `skip`, blank rows are dropped. The readers and `numeric_matrix`'s
    Python path share it, so they cannot drift apart."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=delimiter)
        for i, row in enumerate(reader):
            if i < skip or not row:
                continue
            yield row


class CSVRecordReader(RecordReader):
    """CSV lines -> lists of string values (reference: DataVec
    `CSVRecordReader(skipNumLines, delimiter)`)."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ","):
        self.skip_num_lines = skip_num_lines
        self.delimiter = delimiter
        self._paths: List[str] = []

    def initialize(self, path) -> "CSVRecordReader":
        self._paths = [path] if isinstance(path, str) else list(path)
        return self

    def records(self) -> Iterator[List[str]]:
        for path in self._paths:
            yield from _read_csv_rows(path, self.delimiter,
                                      self.skip_num_lines)

    def numeric_matrix(self) -> np.ndarray:
        """All rows as one float32 [n, cols] matrix: the native parser for
        each file it takes, the Python reader for the others (the same
        matrix)."""
        mats = []
        for path in self._paths:
            m = native.parse_numeric_csv(path, self.delimiter,
                                         self.skip_num_lines)
            if m is None:  # a file the parser does not take
                native.file_paths["python"] += 1
                rows = [[float(v) for v in row] for row in _read_csv_rows(
                    path, self.delimiter, self.skip_num_lines)]
                m = (np.asarray(rows, np.float32) if rows
                     else np.zeros((0, 0), np.float32))
            if m.shape[0]:
                mats.append(m)
        if not mats:
            return np.zeros((0, 0), np.float32)
        return mats[0] if len(mats) == 1 else np.concatenate(mats, axis=0)


class CSVSequenceRecordReader(RecordReader):
    """One CSV file per sequence (reference: DataVec
    `CSVSequenceRecordReader`). `sequence_records()` yields [T, cols]
    string arrays."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ","):
        self.skip_num_lines = skip_num_lines
        self.delimiter = delimiter
        self._paths: List[str] = []

    def initialize(self, paths) -> "CSVSequenceRecordReader":
        if isinstance(paths, str):
            if os.path.isdir(paths):
                self._paths = sorted(
                    os.path.join(paths, f) for f in os.listdir(paths)
                    if f.endswith(".csv") or f.endswith(".txt"))
            else:
                self._paths = [paths]
        else:
            self._paths = list(paths)
        return self

    def sequence_records(self) -> Iterator[np.ndarray]:
        for path in self._paths:
            rows = list(_read_csv_rows(path, self.delimiter,
                                       self.skip_num_lines))
            yield np.asarray(rows, dtype=object)

    def records(self) -> Iterator[List]:
        return self.sequence_records()


class ImageRecordReader(RecordReader):
    """Image files -> (NHWC float32 array, label index) records (reference:
    DataVec `ImageRecordReader(height, width, channels)` with
    `ParentPathLabelGenerator`: the label is the parent directory's name).
    Decoded and resized with PIL, imported at the first decode; grayscale
    when channels == 1."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 normalize: bool = True):
        self.height = height
        self.width = width
        self.channels = channels
        self.normalize = normalize
        self.labels: List[str] = []
        self._files: List[Tuple[str, int]] = []

    def initialize(self, parent_dir: str) -> "ImageRecordReader":
        """Scan `parent_dir/<label>/<image files>` (the reference's
        parent-path label layout)."""
        self.labels = sorted(
            d for d in os.listdir(parent_dir)
            if os.path.isdir(os.path.join(parent_dir, d)))
        if not self.labels:
            raise ValueError(f"no class subdirectories under {parent_dir}")
        self._files = []
        for li, label in enumerate(self.labels):
            d = os.path.join(parent_dir, label)
            for fname in sorted(os.listdir(d)):
                if fname.lower().endswith(IMAGE_EXTENSIONS):
                    self._files.append((os.path.join(d, fname), li))
        return self

    def num_labels(self) -> int:
        return len(self.labels)

    def _load(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("L" if self.channels == 1 else "RGB")
            if im.size != (self.width, self.height):
                im = im.resize((self.width, self.height))
            arr = np.asarray(im, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.normalize:
            arr = arr / 255.0
        return arr  # [H, W, C]

    def records(self) -> Iterator[Tuple[np.ndarray, int]]:
        for path, label in self._files:
            yield self._load(path), label


# ------------------------------------------------------------- iterators

def _to_float(rows: List[List[str]]) -> np.ndarray:
    return np.asarray(rows, np.float64).astype(np.float32)


class RecordReaderDataSetIterator(DataSetIterator):
    """Record reader -> DataSet batches (reference:
    `RecordReaderDataSetIterator.java:52`).

    Classification: `(reader, batch_size, label_index, num_classes)`, the
    label column one-hot encoded, the other columns the features.
    Regression: `(reader, batch_size, label_index, label_index_to=...,
    regression=True)`, label columns [label_index, label_index_to] as they
    are. Image readers need only `(reader, batch_size)`; num_classes
    defaults to the reader's label count. With `pad_batches` the last,
    short batch is padded with zero rows to `batch_size` and carries a
    per-example [B] labels mask (1 for the real rows).
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None,
                 pad_batches: bool = False):
        self.reader = reader
        self._batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to
        self.pad_batches = pad_batches
        if isinstance(reader, ImageRecordReader) and num_classes is None:
            self.num_classes = reader.num_labels()
        if not regression and self.num_classes is None and not isinstance(
                reader, ImageRecordReader):
            raise ValueError(
                "classification mode needs num_classes (or pass "
                "regression=True)")

    def _emit(self, feats: List[np.ndarray], labels: List[np.ndarray]):
        f = np.stack(feats)
        lab = np.stack(labels)
        if self.pad_batches and len(f) < self._batch_size:
            n_real = len(f)
            pad = self._batch_size - n_real
            f = np.concatenate([f, np.zeros((pad,) + f.shape[1:], f.dtype)])
            mask = np.zeros((self._batch_size,), np.float32)
            mask[:n_real] = 1.0
            lab = np.concatenate([lab, np.zeros((pad,) + lab.shape[1:],
                                                lab.dtype)])
            return DataSet(f, lab, labels_mask=mask)
        return DataSet(f, lab)

    def __iter__(self) -> Iterator[DataSet]:
        feats: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        for rec in self.reader.records():
            if isinstance(self.reader, ImageRecordReader):
                img, li = rec
                feats.append(img)
                labels.append(np.eye(self.num_classes, dtype=np.float32)[li])
            else:
                row = np.asarray(rec)
                if self.label_index is None:
                    raise ValueError("label_index required for CSV records")
                if self.regression:
                    hi = (self.label_index_to
                          if self.label_index_to is not None
                          else self.label_index)
                    lab = row[self.label_index:hi + 1].astype(np.float32)
                    feat = np.concatenate(
                        [row[: self.label_index], row[hi + 1:]]
                    ).astype(np.float32)
                else:
                    cls = int(float(row[self.label_index]))
                    lab = np.eye(self.num_classes, dtype=np.float32)[cls]
                    feat = np.concatenate(
                        [row[: self.label_index],
                         row[self.label_index + 1:]]).astype(np.float32)
                feats.append(feat)
                labels.append(lab)
            if len(feats) == self._batch_size:
                yield self._emit(feats, labels)
                feats, labels = [], []
        if feats:
            yield self._emit(feats, labels)

    def batch_size(self):
        return self._batch_size


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence readers -> padded [B, T, F] DataSets with [B, T] masks
    (reference: `SequenceRecordReaderDataSetIterator.java:33`; its
    variable-length handling is the mask arrays the engines read).

    Two-reader form: `features_reader` and `labels_reader` give aligned
    sequences. Single-reader form: the label column is sliced out of each
    sequence (`label_index`). Without `max_length` T is each batch's
    longest sequence; with it every batch is cut or padded to it.
    """

    def __init__(self, features_reader: CSVSequenceRecordReader,
                 labels_reader: Optional[CSVSequenceRecordReader] = None,
                 batch_size: int = 32,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index: Optional[int] = None,
                 max_length: Optional[int] = None):
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self._batch_size = batch_size
        self.num_classes = num_classes
        self.regression = regression
        self.label_index = label_index
        self.max_length = max_length
        if not regression and num_classes is None:
            raise ValueError(
                "classification mode needs num_classes (or pass "
                "regression=True)")

    def _pairs(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.labels_reader is not None:
            for fseq, lseq in zip(self.features_reader.sequence_records(),
                                  self.labels_reader.sequence_records()):
                yield (_to_float(fseq.tolist()), _to_float(lseq.tolist()))
        else:
            if self.label_index is None:
                raise ValueError(
                    "single-reader mode needs label_index to split the "
                    "label column out of each sequence")
            for seq in self.features_reader.sequence_records():
                arr = _to_float(seq.tolist())
                lab = arr[:, self.label_index:self.label_index + 1]
                feat = np.concatenate(
                    [arr[:, : self.label_index],
                     arr[:, self.label_index + 1:]], axis=1)
                yield feat, lab

    def _emit(self, batch: List[Tuple[np.ndarray, np.ndarray]]) -> DataSet:
        t_max = max(f.shape[0] for f, _ in batch)
        if self.max_length is not None:
            t_max = self.max_length
            batch = [(f[:t_max], lab[:t_max]) for f, lab in batch]
        b = len(batch)
        n_feat = batch[0][0].shape[1]
        n_lab = batch[0][1].shape[1] if self.regression else self.num_classes
        feats = np.zeros((b, t_max, n_feat), np.float32)
        labels = np.zeros((b, t_max, n_lab), np.float32)
        mask = np.zeros((b, t_max), np.float32)
        for i, (f, lab) in enumerate(batch):
            t = f.shape[0]
            feats[i, :t] = f
            mask[i, :t] = 1.0
            if self.regression:
                labels[i, :t] = lab
            else:
                cls = lab[:, 0].astype(np.int64)
                labels[i, :t] = np.eye(n_lab, dtype=np.float32)[cls]
        return DataSet(feats, labels, features_mask=mask, labels_mask=mask)

    def __iter__(self) -> Iterator[DataSet]:
        batch: List[Tuple[np.ndarray, np.ndarray]] = []
        for pair in self._pairs():
            batch.append(pair)
            if len(batch) == self._batch_size:
                yield self._emit(batch)
                batch = []
        if batch:
            yield self._emit(batch)

    def batch_size(self):
        return self._batch_size


class _SubsetDetails:
    """One input or output slot: a reader name, a column subset, and an
    optional one-hot encoding (reference:
    RecordReaderMultiDataSetIterator.SubsetDetails)."""

    def __init__(self, reader_name: str, col_first: Optional[int] = None,
                 col_last: Optional[int] = None, one_hot: bool = False,
                 num_classes: Optional[int] = None):
        self.reader_name = reader_name
        self.col_first = col_first
        self.col_last = col_last
        self.one_hot = one_hot
        self.num_classes = num_classes

    def extract(self, row: np.ndarray) -> np.ndarray:
        """row: [cols] (a record) or [T, cols] (a sequence) of strings or
        numbers -> the float32 subset as [T, n] (T = 1 for a record),
        one-hot encoded where configured."""
        vals = np.asarray(row, dtype=np.float64)
        if vals.ndim == 1:
            vals = vals[None, :]
        if self.col_first is not None:
            hi = self.col_last if self.col_last is not None else self.col_first
            vals = vals[:, self.col_first:hi + 1]
        if self.one_hot:
            cls = vals[:, 0].astype(np.int64)
            if np.any(cls < 0) or np.any(cls >= self.num_classes):
                raise ValueError(
                    f"one-hot column for reader {self.reader_name!r} has "
                    f"class ids outside [0, {self.num_classes})")
            return np.eye(self.num_classes, dtype=np.float32)[cls]
        return vals.astype(np.float32)


class RecordReaderMultiDataSetIterator:
    """Several inputs and outputs from one or more record readers ->
    `MultiDataSet` batches for `ComputationGraph.fit` (reference:
    `RecordReaderMultiDataSetIterator.java:57` and its Builder:
    addReader / addSequenceReader, then addInput / addInputOneHot /
    addOutput / addOutputOneHot with column subsets).

    Sequence readers give [B, T, F] arrays with [B, T] masks; sequences of
    several lengths are padded to the batch's longest from the start
    (align="start", the reference's ALIGN_START) or right-aligned
    (align="end", ALIGN_END); "equal_length" refuses lengths that differ.

        it = (RecordReaderMultiDataSetIterator.builder(batch_size=16)
              .add_reader("in", CSVRecordReader().initialize(path_a))
              .add_reader("out", CSVRecordReader().initialize(path_b))
              .add_input("in", 0, 3)
              .add_output_one_hot("out", 0, num_classes=5)
              .build())
    """

    class Builder:
        def __init__(self, batch_size: int):
            self.batch_size = batch_size
            self.readers = {}
            self.seq_readers = {}
            self.inputs: List[_SubsetDetails] = []
            self.outputs: List[_SubsetDetails] = []
            self.align = "start"

        def add_reader(self, name: str, reader: RecordReader):
            self.readers[name] = reader
            return self

        def add_sequence_reader(self, name: str,
                                reader: "CSVSequenceRecordReader"):
            self.seq_readers[name] = reader
            return self

        def sequence_alignment_mode(self, align: str):
            if align not in ("start", "end", "equal_length"):
                raise ValueError(f"align must be start|end|equal_length, "
                                 f"got {align!r}")
            self.align = align
            return self

        def add_input(self, name: str, col_first: Optional[int] = None,
                      col_last: Optional[int] = None):
            self.inputs.append(_SubsetDetails(name, col_first, col_last))
            return self

        def add_input_one_hot(self, name: str, column: int,
                              num_classes: int):
            self.inputs.append(_SubsetDetails(
                name, column, column, one_hot=True, num_classes=num_classes))
            return self

        def add_output(self, name: str, col_first: Optional[int] = None,
                       col_last: Optional[int] = None):
            self.outputs.append(_SubsetDetails(name, col_first, col_last))
            return self

        def add_output_one_hot(self, name: str, column: int,
                               num_classes: int):
            self.outputs.append(_SubsetDetails(
                name, column, column, one_hot=True, num_classes=num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            return RecordReaderMultiDataSetIterator(self)

    @staticmethod
    def builder(batch_size: int) -> "RecordReaderMultiDataSetIterator.Builder":
        return RecordReaderMultiDataSetIterator.Builder(batch_size)

    def __init__(self, b: "RecordReaderMultiDataSetIterator.Builder"):
        if not b.inputs or not b.outputs:
            raise ValueError("need at least one add_input and one add_output")
        for sd in b.inputs + b.outputs:
            if sd.reader_name not in b.readers and \
                    sd.reader_name not in b.seq_readers:
                raise ValueError(f"subset references unknown reader "
                                 f"{sd.reader_name!r}")
        self._b = b

    def _record_streams(self):
        return (
            {n: iter(r.records()) for n, r in self._b.readers.items()},
            {n: iter(r.sequence_records())
             for n, r in self._b.seq_readers.items()},
        )

    def _emit(self, rows_by_reader, seqs_by_reader) -> MultiDataSet:
        def assemble(subsets):
            arrays, masks, any_mask = [], [], False
            for sd in subsets:
                if sd.reader_name in rows_by_reader:
                    rows = rows_by_reader[sd.reader_name]
                    arrays.append(np.stack(
                        [sd.extract(r)[0] for r in rows]))
                    masks.append(None)
                    continue
                seqs = [sd.extract(s) for s in seqs_by_reader[sd.reader_name]]
                t_max = max(s.shape[0] for s in seqs)
                if self._b.align == "equal_length" and \
                        any(s.shape[0] != t_max for s in seqs):
                    raise ValueError(
                        "equal_length alignment but sequence lengths differ")
                b, n = len(seqs), seqs[0].shape[1]
                out = np.zeros((b, t_max, n), np.float32)
                m = np.zeros((b, t_max), np.float32)
                for i, s in enumerate(seqs):
                    t = s.shape[0]
                    if self._b.align == "end":
                        out[i, t_max - t:], m[i, t_max - t:] = s, 1.0
                    else:
                        out[i, :t], m[i, :t] = s, 1.0
                arrays.append(out)
                masks.append(m)
                any_mask = True
            return arrays, (masks if any_mask else None)

        feats, fmasks = assemble(self._b.inputs)
        labels, lmasks = assemble(self._b.outputs)
        return MultiDataSet(features=feats, labels=labels,
                            features_masks=fmasks, labels_masks=lmasks)

    def __iter__(self) -> Iterator[MultiDataSet]:
        streams, seq_streams = self._record_streams()
        while True:
            rows_by_reader, seqs_by_reader, n = {}, {}, None
            for kind, group, out in (("reader", streams, rows_by_reader),
                                     ("sequence reader", seq_streams,
                                      seqs_by_reader)):
                for name, it in group.items():
                    got = []
                    for _ in range(self._b.batch_size):
                        try:
                            got.append(next(it))
                        except StopIteration:
                            break
                    out[name] = got
                    n = len(got) if n is None else n
                    if len(got) != n:
                        raise ValueError(
                            f"{kind} {name!r} ran out of records before the "
                            f"others (got {len(got)}, expected {n})")
            if not n:
                return
            yield self._emit(rows_by_reader, seqs_by_reader)

    def batch_size(self):
        return self._b.batch_size

    def reset(self):
        """The streams restart at each __iter__; kept for the iterator
        API."""


# ----------------------------------------------------------------- CIFAR

_CIFAR_LABELS = ["airplane", "automobile", "bird", "cat", "deer", "dog",
                 "frog", "horse", "ship", "truck"]


def load_cifar10(train: bool = True, num_examples: Optional[int] = None,
                 seed: int = 123) -> DataSet:
    """CIFAR-10 in its binary format (reference: `CifarDataSetIterator`'s
    CifarLoader over `data_batch_*.bin`: each record one label byte and
    3,072 channel-major pixel bytes), read from the directory `CIFAR_DIR`
    names (read at call time). Without it, the reference's deterministic
    synthetic 10-class set: a class-dependent mean colour and oriented
    grating over noise. Images NHWC float32 in [0, 1], labels one-hot."""
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)]
             if train else ["test_batch.bin"])
    d = os.environ.get("CIFAR_DIR", "")
    if d and all(os.path.exists(os.path.join(d, n)) for n in names):
        imgs, labels, loaded = [], [], 0
        for n in names:
            rec = np.fromfile(os.path.join(d, n), np.uint8).reshape(-1, 3073)
            labels.append(rec[:, 0])
            imgs.append(rec[:, 1:].reshape(-1, 3, 32, 32))
            loaded += len(rec)
            if num_examples is not None and loaded >= num_examples:
                break  # enough records: the other files stay unread
        x = np.concatenate(imgs)
        y = np.concatenate(labels)
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        # The file's NCHW -> NHWC.
        x = np.transpose(x.astype(np.float32) / 255.0, (0, 2, 3, 1))
    else:
        rng = np.random.RandomState(seed)
        n = num_examples or (2000 if train else 400)
        y = rng.randint(0, 10, n)
        x = rng.rand(n, 32, 32, 3).astype(np.float32) * 0.25
        grid = np.arange(32)
        for cls in range(10):
            idx = np.flatnonzero(y == cls)
            phase = np.sin(grid * (cls + 1) * np.pi / 16.0) * 0.25 + 0.5
            x[idx, :, :, cls % 3] += phase[None, None, :]
        x = np.clip(x, 0.0, 1.0)
    if num_examples is not None:
        x, y = x[:num_examples], y[:num_examples]
    return DataSet(x, np.eye(10, dtype=np.float32)[y])


class LFWDataSetIterator(RecordReaderDataSetIterator):
    """Labeled Faces in the Wild (reference: `LFWDataSetIterator.java` over
    `LFWLoader`: person labels from the parent path, the image dims, the
    example count and the train/test split configurable).

    Reads the `<person>/<image>` layout under the directory `LFW_DIR`
    names; without it, `_SyntheticFaceReader`, the reference's
    deterministic face-like stand-in, so the pipeline stays drivable.
    """

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 image_shape: Tuple[int, int, int] = (250, 250, 3),
                 num_labels: Optional[int] = None, train: bool = True,
                 split_train_test: float = 1.0, seed: int = 123):
        h, w, c = image_shape
        d = os.environ.get("LFW_DIR", "")
        if d and os.path.isdir(d) and any(
                os.path.isdir(os.path.join(d, s)) for s in os.listdir(d)):
            reader = ImageRecordReader(h, w, c).initialize(d)
            if num_labels is not None:
                # The label space is cut too, so the one-hot width is
                # num_labels (the kept labels are a prefix of the sorted
                # list, so their indices stay).
                reader.labels = reader.labels[:num_labels]
                reader._files = [(p, li) for p, li in reader._files
                                 if li < num_labels]
            self._synthetic = False
        else:
            reader = _SyntheticFaceReader(h, w, c, num_labels or 5,
                                          num_examples or 200, seed)
            self._synthetic = True
        files = reader._files
        order = np.random.RandomState(seed).permutation(len(files))
        if num_examples is not None:
            order = order[:num_examples]
        split = int(len(order) * split_train_test)
        order = order[:split] if train else order[split:]
        reader._files = [files[i] for i in order]
        super().__init__(reader, batch_size)

    def total_examples(self) -> int:
        return len(self.reader._files)


class _SyntheticFaceReader(ImageRecordReader):
    """The deterministic stand-in for the LFW archive (see
    LFWDataSetIterator)."""

    def __init__(self, h, w, c, n_labels, n_examples, seed):
        self.height, self.width, self.channels = h, w, c
        self.normalize = True
        self.labels = [f"person_{i}" for i in range(n_labels)]
        self._files = [(f"synthetic_{i}", i % n_labels)
                       for i in range(n_examples)]
        self._seed = seed

    def _load(self, path: str) -> np.ndarray:
        i = int(path.rsplit("_", 1)[1])
        li = i % len(self.labels)
        rng = np.random.RandomState(self._seed + i)
        img = rng.rand(self.height, self.width, self.channels) * 0.2
        # A "face": a bright ellipse placed by class, and identity stripes.
        yy, xx = np.mgrid[0:self.height, 0:self.width]
        cy = self.height * (0.3 + 0.05 * li)
        cx = self.width * 0.5
        r = ((yy - cy) / (0.3 * self.height)) ** 2 + \
            ((xx - cx) / (0.22 * self.width)) ** 2
        img[r < 1.0] += 0.5
        img[:, :: max(2, li + 2), :] += 0.15
        return np.clip(img, 0.0, 1.0).astype(np.float32)


def load_curves(num_examples: Optional[int] = None,
                seed: int = 123) -> DataSet:
    """The "curves" set (reference: `CurvesDataFetcher.java`, the 28x28
    synthetic-curve images of deep-autoencoder pretraining; the features
    are their own reconstruction targets). Reads `curves.npz` (key "x",
    [N, 784]) from the directory `CURVES_DIR` names; without it, the
    reference's stand-in: random cubic Bezier curves rasterized onto
    28x28."""
    d = os.environ.get("CURVES_DIR", "")
    p = os.path.join(d, "curves.npz") if d else ""
    if p and os.path.exists(p):
        x = np.load(p)["x"].astype(np.float32)
    else:
        rng = np.random.RandomState(seed)
        n = num_examples or 2000
        ts = np.linspace(0.0, 1.0, 64)[:, None]
        b0 = (1 - ts) ** 3
        b1 = 3 * ts * (1 - ts) ** 2
        b2 = 3 * ts ** 2 * (1 - ts)
        b3 = ts ** 3
        ctrl = rng.rand(n, 4, 2) * 24 + 2  # 4 control points in [2, 26)
        pts = (b0[None] * ctrl[:, None, 0] + b1[None] * ctrl[:, None, 1]
               + b2[None] * ctrl[:, None, 2] + b3[None] * ctrl[:, None, 3])
        x = np.zeros((n, 28, 28), np.float32)
        idx = np.clip(pts.round().astype(int), 0, 27)
        rows = np.repeat(np.arange(n), 64)
        x[rows, idx[:, :, 1].ravel(), idx[:, :, 0].ravel()] = 1.0
        x = x.reshape(n, 784)
    if num_examples is not None:
        x = x[:num_examples]
    return DataSet(x, x.copy())


class CurvesDataSetIterator(DataSetIterator):
    """Reference: `CurvesDataFetcher` behind the fetcher-backed iterator
    (BaseDatasetIterator)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 seed: int = 123, shuffle: bool = False):
        ds = load_curves(num_examples=num_examples, seed=seed)
        self._impl = ListDataSetIterator(ds, batch_size=batch_size,
                                         shuffle=shuffle, seed=seed)

    def __iter__(self):
        return iter(self._impl)

    def reset(self):
        self._impl.reset()

    def batch_size(self):
        return self._impl.batch_size()

    def total_examples(self):
        return self._impl.total_examples()


class Cifar10DataSetIterator(DataSetIterator):
    """Reference: `CifarDataSetIterator` (deeplearning4j-core)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, seed: int = 123, shuffle: bool = False):
        ds = load_cifar10(train=train, num_examples=num_examples, seed=seed)
        self._impl = ListDataSetIterator(ds, batch_size=batch_size,
                                         shuffle=shuffle, seed=seed)
        self.labels = list(_CIFAR_LABELS)

    def __iter__(self):
        return iter(self._impl)

    def reset(self):
        self._impl.reset()

    def batch_size(self):
        return self._impl.batch_size()

    def total_examples(self):
        return self._impl.total_examples()
