"""The port's record readers, their iterators and the native CSV parser
(`deeplearning4j_tpu_torch/datasets/records.py`, `.../native`) against the
JAX package's (`deeplearning4j_tpu/datasets/records.py`, `.../native`), on
the same files written to `tmp_path`, on the CPU.

Every reader and iterator gives the reference's arrays bit for bit: CSV
rows (skip lines, delimiters, blank rows, quoted fields), numeric matrices
from the native parser and from the Python reader (which the parser hands
every file it does not take), sequences in both reader forms with
`max_length` and masks, PNG directories (1 and 3 channels, resized),
every `RecordReaderMultiDataSetIterator` builder method, `pad_batches`, a
CIFAR binary file, and the CIFAR, LFW and Curves synthetic sets. The
reference's end-to-end cases (`tests/test_records.py` `TestEndToEnd`) run
in both packages from copied params: scores within 2e-4 relative (f32,
sums in another order, as the earlier training slices hold them).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu import native as jax_native
from deeplearning4j_tpu.datasets import records as jr
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import (
    AsyncDataSetIterator as JaxAsync,
)
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import datasets as pd_api
from deeplearning4j_tpu_torch import interop, native
from deeplearning4j_tpu_torch.datasets import records as pr
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator,
    DeviceCacheDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

SCORE = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def no_archives(tmp_path, monkeypatch):
    """No archive directories in either package's search, a compile-cache
    root of each test's own for the JAX package, and fresh path counts."""
    for var in ("CIFAR_DIR", "LFW_DIR", "CURVES_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jr, "_cifar_search_dirs", lambda: [""])
    monkeypatch.setattr(jr, "_lfw_search_dirs", lambda: [""])
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    native.reset_counts()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


def _write(path, text):
    path.write_text(text)
    return str(path)


def _csv(path, rows, fmt="{}"):
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(fmt.format(x) for x in r) + "\n")
    return str(path)


def _same_ds(got, want):
    for a, b in ((got.features, want.features), (got.labels, want.labels),
                 (got.features_mask, want.features_mask),
                 (got.labels_mask, want.labels_mask)):
        assert (a is None) == (b is None)
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _same_batches(port_it, jax_it):
    got, want = list(port_it), list(jax_it)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same_ds(g, w)
    return got


# ----------------------------------------------------------------- CSV

CSV_CASES = {
    "skip_and_semicolon": ("header;x\n1;2\n\n3;4\n", 1, ";"),
    "tab_and_blank_rows": ("1\t2\t3\n\n\n4\t5\t6\n7\t8\t9\n", 0, "\t"),
    "quoted_fields": ('"a,b",2,"x"\n"c",4,"y"\n', 0, ","),
    "crlf": ("h1,h2\r\n1.5,2e-3\r\n-3,4\r\n", 1, ","),
    "quoted_header_lines": ('"multi\nline header",x\n1,2\n3,4\n', 1, ","),
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_rows_match_reference(tmp_path, case):
    text, skip, delim = CSV_CASES[case]
    path = _write(tmp_path / "d.csv", text)
    got = list(pr.CSVRecordReader(skip, delim).initialize(path))
    want = list(jr.CSVRecordReader(skip, delim).initialize(path))
    assert got == want and got


NUMERIC_CASES = {
    "plain": ("1,2,3\n4,5,6\n", 0, ","),
    "skip_blank_crlf": ("a,b\r\n\r\n1.25,-2\r\n\r\n3e2,4.5\r\n", 1, ","),
    "semicolon": ("x;y\n0.1;0.2\n0.3;0.4\n", 1, ";"),
    "spaces_after": ("1 ,2\n3 ,4\n", 0, ","),
    # Python's float takes these, the parser does not: the Python path.
    "underscores": ("1_0,2\n3,4\n", 0, ","),
    "two_byte_delimiter": ("1é2\n3é4\n", 0, "é"),
}


@pytest.mark.parametrize("case", sorted(NUMERIC_CASES))
def test_numeric_matrix_matches_reference(tmp_path, case):
    text, skip, delim = NUMERIC_CASES[case]
    path = str(tmp_path / "m.csv")
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write(text)
    got = pr.CSVRecordReader(skip, delim).initialize(path).numeric_matrix()
    want = jr.CSVRecordReader(skip, delim).initialize(path).numeric_matrix()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    python = case in ("underscores", "two_byte_delimiter")
    assert native.file_paths == {"native": int(not python),
                                 "python": int(python)}


def test_native_parser_equals_both_reference_paths(tmp_path):
    data = np.random.RandomState(0).randn(300, 9).astype(np.float32)
    path = str(tmp_path / "big.csv")
    np.savetxt(path, data, delimiter=",", fmt="%.9g", header="c" * 9,
               comments="")
    got = native.parse_numeric_csv(path, ",", 1)
    ref_native = jax_native.parse_numeric_csv(path, ",", 1)
    rows = [[float(v) for v in r] for r in pr._read_csv_rows(path, ",", 1)]
    np.testing.assert_array_equal(got, ref_native)
    np.testing.assert_array_equal(got, np.asarray(rows, np.float32))
    np.testing.assert_array_equal(got, data)
    two = pr.CSVRecordReader(1).initialize([path, path]).numeric_matrix()
    np.testing.assert_array_equal(two, np.concatenate([data, data]))


def test_native_quoted_skip_region_falls_back(tmp_path):
    # The reference's case: a quoted header spanning lines is one logical
    # row to csv.reader and two lines to the parser, so the parser refuses
    # the file and the Python reader starts the data at the same row.
    path = _write(tmp_path / "q.csv", '"multi\nline header",x\n1,2\n3,4\n')
    assert native.parse_numeric_csv(path, ",", 1) is None
    m = pr.CSVRecordReader(skip_num_lines=1).initialize(path).numeric_matrix()
    np.testing.assert_array_equal(m, [[1, 2], [3, 4]])
    np.testing.assert_array_equal(
        m, jr.CSVRecordReader(skip_num_lines=1).initialize(path)
        .numeric_matrix())
    assert native.file_paths == {"native": 0, "python": 1}


def test_empty_and_ragged_files(tmp_path):
    empty = _write(tmp_path / "e.csv", "")
    ragged = _write(tmp_path / "r.csv", "1,2\n3\n")
    assert pr.CSVRecordReader().initialize(empty).numeric_matrix().shape == \
        jr.CSVRecordReader().initialize(empty).numeric_matrix().shape
    assert native.parse_numeric_csv(ragged) is None
    with pytest.raises(ValueError):
        pr.CSVRecordReader().initialize(ragged).numeric_matrix()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_compiler", lambda: "/bin/false")
    path = _write(tmp_path / "d.csv", "1,2\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pr.CSVRecordReader().initialize(path).numeric_matrix()
    assert native.file_paths == {"native": 0, "python": 0}


def test_native_library_lands_in_build_dir(tmp_path):
    path = _write(tmp_path / "d.csv", "1,2\n")
    native.parse_numeric_csv(path)
    lib = native.library_path("fastcsv")
    assert lib.is_file() and lib.parent == native.BUILD_DIR
    assert lib.parent.parent.name == "build"


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("mode", ["classification", "regression"])
def test_record_reader_iterator_matches_reference(tmp_path, pad, mode):
    rows = [[i * 0.1, i * 0.2, i % 3, i * 0.5] for i in range(10)]
    path = _csv(tmp_path / "d.csv", rows)
    kw = (dict(label_index=2, num_classes=3) if mode == "classification"
          else dict(label_index=1, label_index_to=2, regression=True))
    got = _same_batches(
        pr.RecordReaderDataSetIterator(pr.CSVRecordReader().initialize(path),
                                       4, pad_batches=pad, **kw),
        jr.RecordReaderDataSetIterator(jr.CSVRecordReader().initialize(path),
                                       4, pad_batches=pad, **kw))
    assert [b.features.shape[0] for b in got] == ([4, 4, 4] if pad
                                                  else [4, 4, 2])
    if pad:
        np.testing.assert_array_equal(got[-1].labels_mask, [1, 1, 0, 0])


def test_record_reader_iterator_errors():
    with pytest.raises(ValueError, match="num_classes"):
        pr.RecordReaderDataSetIterator(pr.CSVRecordReader(), 4,
                                       label_index=0)


# ----------------------------------------------------------- sequences

def _sequences(tmp_path, lengths, n_feat=3, n_cls=4, label_col=None):
    rng = np.random.RandomState(len(lengths))
    fdir, ldir = tmp_path / "f", tmp_path / "l"
    fdir.mkdir()
    ldir.mkdir()
    for i, t in enumerate(lengths):
        feats = rng.randn(t, n_feat).round(4)
        labels = rng.randint(0, n_cls, (t, 1))
        if label_col is not None:
            feats = np.concatenate([feats[:, :label_col], labels,
                                    feats[:, label_col:]], axis=1)
        _csv(fdir / f"{i:03d}.csv", feats.tolist())
        _csv(ldir / f"{i:03d}.csv", labels.tolist())
    return str(fdir), str(ldir)


@pytest.mark.parametrize("max_length", [None, 4])
def test_sequence_iterator_two_readers_matches_reference(tmp_path,
                                                         max_length):
    fdir, ldir = _sequences(tmp_path, [5, 3, 7, 2, 6])
    got = _same_batches(
        pr.SequenceRecordReaderDataSetIterator(
            pr.CSVSequenceRecordReader().initialize(fdir),
            pr.CSVSequenceRecordReader().initialize(ldir), 2, num_classes=4,
            max_length=max_length),
        jr.SequenceRecordReaderDataSetIterator(
            jr.CSVSequenceRecordReader().initialize(fdir),
            jr.CSVSequenceRecordReader().initialize(ldir), 2, num_classes=4,
            max_length=max_length))
    assert got[0].features_mask.shape == got[0].features.shape[:2]


@pytest.mark.parametrize("regression", [False, True])
def test_sequence_iterator_label_index_matches_reference(tmp_path,
                                                         regression):
    fdir, _ = _sequences(tmp_path, [4, 6, 1], label_col=1)
    kw = (dict(regression=True) if regression else dict(num_classes=4))
    _same_batches(
        pr.SequenceRecordReaderDataSetIterator(
            pr.CSVSequenceRecordReader().initialize(fdir), None, 2,
            label_index=1, **kw),
        jr.SequenceRecordReaderDataSetIterator(
            jr.CSVSequenceRecordReader().initialize(fdir), None, 2,
            label_index=1, **kw))


def test_sequence_reader_paths_forms(tmp_path):
    fdir, _ = _sequences(tmp_path, [2, 3])
    files = sorted(os.path.join(fdir, f) for f in os.listdir(fdir))
    for src in (fdir, files, files[0]):
        got = list(pr.CSVSequenceRecordReader().initialize(src))
        want = list(jr.CSVSequenceRecordReader().initialize(src))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- images

def _png_dir(tmp_path, mode, size=(10, 12)):
    r = np.random.RandomState(0)
    root = tmp_path / f"imgs_{mode}"
    for label, base in (("bright", 210), ("dark", 45), ("mid", 128)):
        d = root / label
        d.mkdir(parents=True)
        for i in range(3):
            shape = (size[1], size[0]) + ((3,) if mode == "RGB" else ())
            arr = np.clip(base + r.randn(*shape) * 20, 0, 255)
            Image.fromarray(arr.astype(np.uint8), mode).save(
                str(d / f"{i}.png"))
        (d / "notes.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3),
                                           ("RGB", 1), ("L", 3)])
@pytest.mark.parametrize("hw", [(12, 10), (6, 5)])
def test_image_reader_matches_reference(tmp_path, mode, channels, hw):
    root = _png_dir(tmp_path, mode)
    p = pr.ImageRecordReader(*hw, channels=channels).initialize(root)
    j = jr.ImageRecordReader(*hw, channels=channels).initialize(root)
    assert p.labels == j.labels and p.num_labels() == 3
    got = _same_batches(pr.RecordReaderDataSetIterator(p, 4),
                        jr.RecordReaderDataSetIterator(j, 4))
    assert got[0].features.shape == (4, hw[0], hw[1], channels)


def test_image_reader_needs_class_dirs(tmp_path):
    with pytest.raises(ValueError, match="no class subdirectories"):
        pr.ImageRecordReader(4, 4).initialize(str(tmp_path))


# --------------------------------------------------- multi data sets

def _multi_files(tmp_path):
    rng = np.random.RandomState(5)
    a = _csv(tmp_path / "a.csv", rng.randn(7, 4).round(3).tolist())
    b = _csv(tmp_path / "b.csv",
             np.concatenate([rng.randint(0, 3, (7, 1)),
                             rng.randn(7, 2).round(3)], 1).tolist())
    fdir, ldir = _sequences(tmp_path, [3, 5, 2, 4, 4, 1, 2])
    return a, b, fdir, ldir


def _multi(mod, files, align, batch=3):
    a, b, fdir, ldir = files
    builder = (mod.RecordReaderMultiDataSetIterator.builder(batch)
               .add_reader("a", mod.CSVRecordReader().initialize(a))
               .add_reader("b", mod.CSVRecordReader().initialize(b))
               .add_sequence_reader(
                   "sf", mod.CSVSequenceRecordReader().initialize(fdir))
               .add_sequence_reader(
                   "sl", mod.CSVSequenceRecordReader().initialize(ldir))
               .sequence_alignment_mode(align)
               .add_input("a", 0, 2)
               .add_input("b", 1)
               .add_input("a")
               .add_input_one_hot("b", 0, 3)
               .add_input("sf")
               .add_output("b", 1, 2)
               .add_output_one_hot("b", 0, 3)
               .add_output_one_hot("sl", 0, 4))
    return builder.build()


@pytest.mark.parametrize("align", ["start", "end"])
def test_multi_iterator_every_builder_method_matches_reference(tmp_path,
                                                               align):
    files = _multi_files(tmp_path)
    got, want = list(_multi(pr, files, align)), list(_multi(jr, files, align))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for part in ("features", "labels", "features_masks",
                     "labels_masks"):
            ga, wa = getattr(g, part), getattr(w, part)
            assert (ga is None) == (wa is None)
            for x, y in zip(ga or [], wa or []):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    assert _multi(pr, files, align).batch_size() == 3


def test_multi_iterator_refusals(tmp_path):
    files = _multi_files(tmp_path)
    with pytest.raises(ValueError, match="differ"):
        list(_multi(pr, files, "equal_length"))
    with pytest.raises(ValueError, match="align"):
        pr.RecordReaderMultiDataSetIterator.builder(2) \
            .sequence_alignment_mode("middle")
    with pytest.raises(ValueError, match="unknown reader"):
        pr.RecordReaderMultiDataSetIterator.builder(2).add_input("x") \
            .add_output("x").build()
    with pytest.raises(ValueError, match="add_input"):
        pr.RecordReaderMultiDataSetIterator.builder(2).build()
    a, b, _, _ = files
    short = _csv(tmp_path / "short.csv", [[1, 2]])
    it = (pr.RecordReaderMultiDataSetIterator.builder(4)
          .add_reader("a", pr.CSVRecordReader().initialize(a))
          .add_reader("s", pr.CSVRecordReader().initialize(short))
          .add_input("a").add_output("s").build())
    with pytest.raises(ValueError, match="ran out"):
        list(it)
    bad = (pr.RecordReaderMultiDataSetIterator.builder(4)
           .add_reader("b", pr.CSVRecordReader().initialize(b))
           .add_input("b", 1, 2).add_output_one_hot("b", 0, 2).build())
    with pytest.raises(ValueError, match="outside"):
        list(bad)


# --------------------------------------------------------------- CIFAR

def test_cifar_binary_file_matches_reference(tmp_path, monkeypatch):
    rng = np.random.RandomState(7)
    d = tmp_path / "cifar"
    d.mkdir()
    for name, n in [(f"data_batch_{i}.bin", 6) for i in range(1, 6)] + \
            [("test_batch.bin", 5)]:
        rec = np.concatenate([rng.randint(0, 10, (n, 1)),
                              rng.randint(0, 256, (n, 3072))], 1)
        rec.astype(np.uint8).tofile(str(d / name))
    monkeypatch.setenv("CIFAR_DIR", str(d))
    monkeypatch.setattr(jr, "_cifar_search_dirs", lambda: [str(d)])
    for kw in (dict(train=True), dict(train=True, num_examples=8),
               dict(train=False)):
        got, want = pr.load_cifar10(**kw), jr.load_cifar10(**kw)
        _same_ds(got, want)
    assert pr.load_cifar10().features.shape == (30, 32, 32, 3)


@pytest.mark.parametrize("kw", [dict(), dict(num_examples=300, seed=5),
                                dict(train=False)])
def test_cifar_synthetic_set_is_the_reference_bit_for_bit(kw):
    _same_ds(pr.load_cifar10(**kw), jr.load_cifar10(**kw))


def test_cifar_iterator_matches_reference():
    got = _same_batches(pr.Cifar10DataSetIterator(16, num_examples=48,
                                                  shuffle=True, seed=3),
                        jr.Cifar10DataSetIterator(16, num_examples=48,
                                                  shuffle=True, seed=3))
    assert got[0].features.shape == (16, 32, 32, 3)
    it = pr.Cifar10DataSetIterator(16, num_examples=48)
    assert it.batch_size() == 16 and it.total_examples() == 48
    assert it.labels[0] == "airplane"


@pytest.mark.parametrize("kw", [dict(), dict(num_examples=40,
                                             image_shape=(20, 16, 3),
                                             num_labels=4, seed=9),
                                dict(num_examples=30, image_shape=(8, 8, 1),
                                     split_train_test=0.5, train=False)])
def test_lfw_synthetic_set_is_the_reference_bit_for_bit(kw):
    if not kw:
        kw = dict(num_examples=12, image_shape=(25, 25, 3))
    p, j = pr.LFWDataSetIterator(4, **kw), jr.LFWDataSetIterator(4, **kw)
    assert p._synthetic and j._synthetic
    assert p.total_examples() == j.total_examples()
    _same_batches(p, j)


def test_lfw_directory_matches_reference(tmp_path, monkeypatch):
    root = _png_dir(tmp_path, "RGB", size=(8, 8))
    monkeypatch.setenv("LFW_DIR", root)
    monkeypatch.setattr(jr, "_lfw_search_dirs", lambda: [root])
    kw = dict(num_examples=7, image_shape=(8, 8, 3), num_labels=2)
    p, j = pr.LFWDataSetIterator(3, **kw), jr.LFWDataSetIterator(3, **kw)
    assert not p._synthetic and not j._synthetic
    _same_batches(p, j)


@pytest.mark.parametrize("kw", [dict(), dict(num_examples=50, seed=4)])
def test_curves_synthetic_set_is_the_reference_bit_for_bit(kw):
    _same_ds(pr.load_curves(**kw), jr.load_curves(**kw))
    _same_batches(pr.CurvesDataSetIterator(32, **kw),
                  jr.CurvesDataSetIterator(32, **kw))


def test_curves_file_matches_reference(tmp_path, monkeypatch):
    x = np.random.RandomState(1).rand(10, 784)
    np.savez(str(tmp_path / "curves.npz"), x=x)
    monkeypatch.setenv("CURVES_DIR", str(tmp_path))
    _same_ds(pr.load_curves(num_examples=6), jr.load_curves(num_examples=6))


def test_datasets_package_exports_the_readers():
    for name in ("CSVRecordReader", "CSVSequenceRecordReader",
                 "ImageRecordReader", "RecordReaderDataSetIterator",
                 "SequenceRecordReaderDataSetIterator",
                 "RecordReaderMultiDataSetIterator", "LFWDataSetIterator",
                 "Cifar10DataSetIterator", "CurvesDataSetIterator",
                 "load_cifar10", "load_curves"):
        assert getattr(pd_api, name) is getattr(pr, name)


# -------------------------------------------- staging and end to end

def test_records_compose_with_the_staging_iterators(tmp_path):
    path = _csv(tmp_path / "d.csv",
                [[i * 0.1, i % 2, i * 0.3] for i in range(9)])

    def base():
        return pr.RecordReaderDataSetIterator(
            pr.CSVRecordReader().initialize(path), 4, label_index=1,
            num_classes=2)

    want = list(base())
    for wrapped in (AsyncDataSetIterator(base(), device="cpu"),
                    DeviceCacheDataSetIterator(base(), device="cpu")):
        got = list(wrapped)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert isinstance(g.features, torch.Tensor)
            np.testing.assert_array_equal(g.features.numpy(), w.features)
            np.testing.assert_array_equal(g.labels.numpy(), w.labels)


def _pair(jconf):
    jnet = JaxMLN(jconf).init()
    params = {k: {n: np.array(a) for n, a in p.items()}
              for k, p in jnet.params_tree.items() if isinstance(p, dict)}
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jconf.to_json()),
        device="cpu").init(params=interop.params_from_numpy(params))
    return jnet, pnet


def test_end_to_end_conv_net_from_png_directory(tmp_path):
    r = np.random.RandomState(0)
    for label, base in (("bright", 210), ("dark", 45)):
        d = tmp_path / "imgs" / label
        d.mkdir(parents=True)
        for i in range(16):
            arr = np.clip(base + r.randn(10, 10) * 20, 0, 255)
            Image.fromarray(arr.astype(np.uint8), "L").save(
                str(d / f"{i}.png"))
    root = str(tmp_path / "imgs")
    jconf = (JaxNNC.builder().seed(3).learning_rate(0.05).updater("adam")
             .list()
             .layer(JL.ConvolutionLayer(n_out=4, kernel_size=3, stride=1,
                                        activation="relu"))
             .layer(JL.SubsamplingLayer(kernel_size=2, stride=2))
             .layer(JL.DenseLayer(n_out=16, activation="relu"))
             .layer(JL.OutputLayer(n_out=2, activation="softmax",
                                   loss_function="mcxent"))
             .set_input_type(JaxInputType.convolutional(10, 10, 1))
             .build())
    jnet, pnet = _pair(jconf)
    jreader = jr.ImageRecordReader(10, 10, channels=1).initialize(root)
    preader = pr.ImageRecordReader(10, 10, channels=1).initialize(root)
    for _ in range(8):
        jnet.fit(JaxAsync(jr.RecordReaderDataSetIterator(jreader, 8)))
        pnet.fit(AsyncDataSetIterator(
            pr.RecordReaderDataSetIterator(preader, 8), device="cpu"))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   **SCORE)
    jev = jnet.evaluate(jr.RecordReaderDataSetIterator(jreader, 8))
    pev = pnet.evaluate(pr.RecordReaderDataSetIterator(preader, 8))
    assert pev.accuracy() == jev.accuracy() > 0.9


def test_end_to_end_csv_regression(tmp_path):
    r = np.random.RandomState(0)
    x = r.rand(128, 3)
    y = (2.0 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2])[:, None]
    path = _csv(tmp_path / "reg.csv",
                np.concatenate([x, y], axis=1).round(6).tolist())
    jconf = (JaxNNC.builder().seed(3).learning_rate(0.05).updater("adam")
             .list()
             .layer(JL.DenseLayer(n_out=16, activation="tanh"))
             .layer(JL.OutputLayer(n_out=1, activation="identity",
                                   loss_function="mse"))
             .set_input_type(JaxInputType.feed_forward(3))
             .build())
    jnet, pnet = _pair(jconf)
    xs, ys = x.astype("float32"), y.astype("float32")
    first = pnet.score(DataSet(xs, ys))
    np.testing.assert_allclose(first, jnet.score(JaxDataSet(xs, ys)),
                               **SCORE)
    jit = jr.RecordReaderDataSetIterator(jr.CSVRecordReader().initialize(
        path), batch_size=32, label_index=3, regression=True)
    pit = pr.RecordReaderDataSetIterator(pr.CSVRecordReader().initialize(
        path), batch_size=32, label_index=3, regression=True)
    for _ in range(60):
        jnet.fit(jit)
        pnet.fit(pit)
    final = pnet.score(DataSet(xs, ys))
    np.testing.assert_allclose(final, jnet.score(JaxDataSet(xs, ys)),
                               **SCORE)
    assert final < first * 0.1, (first, final)


def test_end_to_end_padded_batch_trains_and_evaluates(tmp_path):
    path = _csv(tmp_path / "d.csv",
                [[i * 0.3, (3 - i) * 0.2, i % 2] for i in range(5)])
    jconf = (JaxNNC.builder().seed(3).learning_rate(0.1)
             .list()
             .layer(JL.DenseLayer(n_out=8, activation="tanh"))
             .layer(JL.OutputLayer(n_out=2, activation="softmax",
                                   loss_function="mcxent"))
             .set_input_type(JaxInputType.feed_forward(2))
             .build())
    jnet, pnet = _pair(jconf)
    jit = jr.RecordReaderDataSetIterator(jr.CSVRecordReader().initialize(
        path), batch_size=4, label_index=2, num_classes=2, pad_batches=True)
    pit = pr.RecordReaderDataSetIterator(pr.CSVRecordReader().initialize(
        path), batch_size=4, label_index=2, num_classes=2, pad_batches=True)
    jnet.fit(jit)
    pnet.fit(pit)
    np.testing.assert_allclose(pnet.score_value, jnet.score_value, **SCORE)
    jev, pev = jnet.evaluate(jit), pnet.evaluate(pit)
    # Only the 5 real rows are counted, not the 3 padding rows.
    assert int(pev.confusion.matrix.sum()) == \
        int(jev.confusion.matrix.sum()) == 5
