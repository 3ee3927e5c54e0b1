"""The port's iterators (`deeplearning4j_tpu_torch/datasets/iterators.py`)
and device staging (`datasets/staging.py`) against the JAX package's, on
the CPU (the port stages to the CPU when asked; on the card the copies go
through pinned buffers and a side stream, which the card tests and
`chip_smoke.py`'s superstep phase run). Each iterator yields the
reference's batches, value for value, from the same seeded data; errors in
a worker reach the consumer; the stager's byte budget, passthroughs and
clean-up behave as the reference's."""

import time

import numpy as np
import pytest
import torch

from conftest import make_classification_data
from deeplearning4j_tpu.datasets import iterators as jit
from deeplearning4j_tpu.datasets import staging as jst
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu_torch.datasets import iterators as it
from deeplearning4j_tpu_torch.datasets import staging as st
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet


def _pairs(rng, n=40, batch=8):
    x, y = make_classification_data(rng, n=n, dtype="float32")
    return (JDataSet(x, y), DataSet(x, y), batch)


def _values(items):
    out = []
    for d in items:
        out.append(tuple(None if a is None else np.asarray(
            a.float() if isinstance(a, torch.Tensor)
            and a.dtype == torch.bfloat16 else a)
            for a in (d.features, d.labels, d.features_mask,
                      d.labels_mask)))
    return out


def _same(got, want):
    got, want = _values(got), _values(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_fast_forward_matches_the_reference(rng):
    jd, pd, b = _pairs(rng)
    jbase = jit.ListDataSetIterator(jd, b, shuffle=True, seed=4)
    pbase = it.ListDataSetIterator(pd, b, shuffle=True, seed=4)
    for n in (0, 2, 9):
        _same(list(it.fast_forward(pbase, n)),
              list(jit.fast_forward(jbase, n)))


@pytest.mark.parametrize("prefetch", [True, False])
def test_async_iterator_yields_the_references_batches(rng, prefetch):
    jd, pd, b = _pairs(rng)
    want = list(jit.AsyncDataSetIterator(jit.ListDataSetIterator(jd, b),
                                         device_prefetch=prefetch))
    got_it = it.AsyncDataSetIterator(it.ListDataSetIterator(pd, b),
                                     device_prefetch=prefetch, device="cpu")
    got = list(got_it)
    _same(got, want)
    if prefetch:
        assert all(isinstance(d.features, torch.Tensor) for d in got)
    got_it.reset()  # no live worker left
    _same(list(got_it), want)


def test_async_iterator_passes_a_workers_error_to_the_consumer():
    def bad():
        yield DataSet(np.zeros((2, 2), np.float32))
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(it.AsyncDataSetIterator(bad(), device_prefetch=False))
    with pytest.raises(RuntimeError, match="boom"):
        list(it.AsyncDataSetIterator(bad(), device="cpu"))


@pytest.mark.parametrize("tdt", [None, "bfloat16"])
def test_device_cache_replays_the_references_batches(rng, tdt):
    jd, pd, b = _pairs(rng)
    want = list(jit.DeviceCacheDataSetIterator(jd.batch_by(b),
                                               transfer_dtype=tdt))
    cache = it.DeviceCacheDataSetIterator(pd.batch_by(b), transfer_dtype=tdt,
                                          device="cpu")
    first = list(cache)
    _same(first, want)
    assert cache.total_examples() == 40
    second = list(cache)
    assert all(a is b for a, b in zip(first, second))  # replayed, not staged
    if tdt:
        assert first[0].features.dtype == torch.bfloat16
    cache.invalidate()
    assert cache.total_examples() is None
    _same(list(cache), want)


def test_device_cache_budget_refuses_and_drops(rng):
    _, pd, b = _pairs(rng)
    per = pd.batch_by(b)[0]
    cap = (per.features.nbytes + per.labels.nbytes) * 2
    cache = it.DeviceCacheDataSetIterator(pd.batch_by(b), max_bytes=cap,
                                          device="cpu")
    with pytest.raises(MemoryError, match="max_bytes"):
        list(cache)
    assert cache._cache is None and cache.cache_bytes == 0


def test_multiple_epochs_sampling_existing_and_rebatching(rng):
    jd, pd, b = _pairs(rng, n=30)
    _same(list(it.MultipleEpochsIterator(3, it.ListDataSetIterator(pd, 8))),
          list(jit.MultipleEpochsIterator(3, jit.ListDataSetIterator(jd, 8))))
    _same(list(it.SamplingDataSetIterator(pd, 7, 5, seed=3)),
          list(jit.SamplingDataSetIterator(jd, 7, 5, seed=3)))
    ex = it.ExistingDataSetIterator(pd.batch_by(8))
    _same(list(ex), list(jit.ExistingDataSetIterator(jd.batch_by(8))))
    assert ex.total_examples() == 30
    _same(list(it.IteratorDataSetIterator(pd.batch_by(7), 10)),
          list(jit.IteratorDataSetIterator(jd.batch_by(7), 10)))


def _mds(rng, n=6, masks=True):
    x1, x2 = rng.randn(n, 3), rng.randn(n, 4, 2)
    y = np.eye(2)[rng.randint(0, 2, n)]
    fm = (rng.rand(n, 4) < 0.8).astype(np.float32) if masks else None
    return ([x1, x2], [y], [None, fm] if masks else None, None)


def test_batch_signature_and_nbytes_match_the_reference(rng):
    for pd, jd in ((DataSet(np.zeros((4, 3), np.float32),
                            np.zeros((4, 2), np.float32)),
                    JDataSet(np.zeros((4, 3), np.float32),
                             np.zeros((4, 2), np.float32))),):
        assert it.batch_signature(pd) == jit.batch_signature(jd)
        assert it.batch_nbytes(pd) == jit.batch_nbytes(jd)
    f, l, fm, lm = _mds(rng)
    p, j = MultiDataSet(f, l, fm, lm), JMultiDataSet(f, l, fm, lm)
    assert it.batch_signature(p) == jit.batch_signature(j)
    assert it.batch_nbytes(p) == jit.batch_nbytes(j)
    assert st.host_item_nbytes(p) == jst.host_item_nbytes(j)


@pytest.mark.parametrize("n,k", [(7, 3), (8, 4), (5, 1), (1, 3)])
def test_superbatch_blocks_match_the_reference(rng, n, k):
    batches = [make_classification_data(rng, n=6, dtype="float32")
               for _ in range(n)]
    want = list(jit.SuperbatchIterator([JDataSet(*b) for b in batches], k))
    got = list(it.SuperbatchIterator([DataSet(*b) for b in batches], k,
                                     stage=False))
    assert [type(g).__name__ for g in got] == [type(w).__name__
                                               for w in want]
    for g, w in zip(got, want):
        assert getattr(g, "k", 1) == getattr(w, "k", 1)
        np.testing.assert_array_equal(np.asarray(g.features),
                                      np.asarray(w.features))
        np.testing.assert_array_equal(np.asarray(g.labels),
                                      np.asarray(w.labels))


def test_superbatch_signature_flush_and_byte_budget(rng):
    small = [DataSet(np.zeros((4, 3), np.float32), np.zeros((4, 2),
                                                            np.float32))
             for _ in range(3)]
    wide = [DataSet(np.zeros((5, 3), np.float32), np.zeros((5, 2),
                                                           np.float32))
            for _ in range(2)]
    blocks = list(it.SuperbatchIterator(small + wide, 4, stage=False))
    assert [getattr(b, "k", 1) for b in blocks] == [3, 2]
    jblocks = list(jit.SuperbatchIterator(
        [JDataSet(b.features, b.labels) for b in small + wide], 4))
    assert [getattr(b, "k", 1) for b in jblocks] == [3, 2]
    per = it.batch_nbytes(small[0])
    limited = list(it.SuperbatchIterator(small * 2, 4, max_bytes=2 * per,
                                         stage=False))
    assert [getattr(b, "k", 1) for b in limited] == [2, 2, 2]


def test_multidataset_blocks_and_stage_item(rng):
    items = [MultiDataSet(*_mds(np.random.RandomState(i))) for i in range(3)]
    jitems = [JMultiDataSet(*_mds(np.random.RandomState(i)))
              for i in range(3)]
    got = it.stack_superbatch(items, stage=True, device="cpu")
    want = jit.stack_superbatch(jitems, stage=False)
    assert isinstance(got, it.MultiSuperbatch) and got.k == 3
    for g, w in zip(got.features + got.labels, want.features + want.labels):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.features_masks[0] is None
    np.testing.assert_array_equal(got.features_masks[1].numpy(),
                                  np.asarray(want.features_masks[1]))
    one = got.batch(1)
    np.testing.assert_array_equal(one.features[1].numpy(),
                                  items[1].features[1])
    staged = st.stage_item(items[0], "cpu")
    assert isinstance(staged, MultiDataSet)
    assert st.host_item_nbytes(staged) == st.host_item_nbytes(items[0])


def test_device_cached_blocks_stack_once(rng):
    batches = [DataSet(*make_classification_data(rng, n=4, dtype="float32"))
               for _ in range(4)]
    cache = it.DeviceCacheDataSetIterator(batches, device="cpu")
    sbi = it.SuperbatchIterator(cache, 2, device="cpu")
    first, second = list(sbi), list(sbi)
    assert all(a is b for a, b in zip(first, second))
    cache.invalidate()
    assert list(sbi)[0] is not first[0]


# ----------------------------------------------------------------- staging

def _batches(rng, n=6, batch=8):
    return [DataSet(*make_classification_data(rng, n=batch, dtype="float32"))
            for _ in range(n)]


def test_stager_same_data_same_order_and_host_mode(rng):
    batches = _batches(rng)
    got = list(st.DeviceStager(batches, device="cpu"))
    _same(got, batches)
    assert all(isinstance(g.features, torch.Tensor) for g in got)
    host = list(st.DeviceStager(batches, device_stage=False, device="cpu"))
    assert all(a is b for a, b in zip(host, batches))


def test_stager_casts_and_transforms(rng):
    batches = _batches(rng, n=3)
    got = list(st.DeviceStager(batches, transfer_dtype="bfloat16",
                               transform=lambda d: DataSet(d.features * 2,
                                                           d.labels),
                               device="cpu"))
    assert got[0].features.dtype == torch.bfloat16
    want = [jst.transfer_cast(JDataSet(b.features * 2, b.labels),
                              "bfloat16") for b in batches]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.features.float().numpy(),
                                      np.asarray(w.features, np.float32))


def test_maybe_stage_passthroughs_match_the_reference(rng, monkeypatch):
    batches = _batches(rng)
    single = [batches[0]]
    assert st.maybe_stage(single, device="cpu") is single
    async_it = it.AsyncDataSetIterator(batches, device="cpu")
    assert st.maybe_stage(async_it) is async_it
    sbi = it.SuperbatchIterator(batches, 2)
    assert st.maybe_stage(sbi) is sbi
    monkeypatch.setenv("DL4J_TPU_STAGING", "0")
    assert not st.staging_enabled()
    assert st.maybe_stage(batches) is batches
    monkeypatch.delenv("DL4J_TPU_STAGING")
    wrapped = st.maybe_stage(batches, device="cpu")
    assert isinstance(wrapped, st.DeviceStager)
    st.close_stager(wrapped)
    st.close_stager(batches)  # not a stager: nothing to do


def test_budget_depth_and_switches(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_STAGE_BYTES", "12345")
    assert st.staging_budget_bytes() == jst.staging_budget_bytes() == 12345
    monkeypatch.delenv("DL4J_TPU_STAGE_BYTES")
    assert st.staging_budget_bytes(device="cpu") == 256 << 20
    monkeypatch.setenv("DL4J_TPU_STAGE_DEPTH", "5")
    assert st.staging_depth() == jst.staging_depth() == 5
    monkeypatch.setenv("DL4J_TPU_STAGE_DEPTH", "x")
    assert st.staging_depth() == jst.staging_depth() == 2


def test_inflight_never_exceeds_the_budget(rng, monkeypatch):
    batches = _batches(rng, n=8, batch=16)
    per = st.host_item_nbytes(batches[0])
    assert per == jst.host_item_nbytes(JDataSet(batches[0].features,
                                                batches[0].labels))
    monkeypatch.setenv("DL4J_TPU_STAGE_BYTES", str(2 * per + per // 2))
    stager = st.DeviceStager(batches, depth=8, device="cpu")
    seen = 0
    for _ in stager:
        time.sleep(0.02)
        seen += 1
    assert seen == 8
    assert 0 < stager.max_inflight_bytes <= 2 * per + per // 2
    assert stager.staged_bytes == 8 * per


def test_an_oversized_item_is_admitted_alone(rng, monkeypatch):
    batches = _batches(rng, n=4, batch=16)
    per = st.host_item_nbytes(batches[0])
    monkeypatch.setenv("DL4J_TPU_STAGE_BYTES", str(per // 4))
    stager = st.DeviceStager(batches, depth=8, device="cpu")
    assert len(list(stager)) == 4
    assert stager.max_inflight_bytes == per


def test_a_producer_error_and_an_abandoned_epoch(rng):
    batches = _batches(rng, n=3)

    def boom():
        yield batches[0]
        yield batches[1]
        raise RuntimeError("boom mid-stream")

    stager = st.DeviceStager(boom(), depth=2, device="cpu")
    with pytest.raises(RuntimeError, match="boom mid-stream"):
        for _ in stager:
            pass
    stager.close()
    stager = st.DeviceStager(_batches(rng), depth=4, device="cpu")
    next(iter(stager))
    stager.close()
    stager.close()  # idempotent
    assert list(stager) == []
    assert stager._inflight == 0


def test_fit_takes_a_staged_epoch_and_an_async_iterator(rng):
    # The engines take staged and prefetched batches as they take host
    # ones: the same params after one epoch each way.
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(3).updater("adam").list()
            .layer(L.DenseLayer(n_out=8, activation="relu"))
            .layer(L.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    batches = _batches(rng)
    nets = [MultiLayerNetwork(conf, device="cpu").init() for _ in range(3)]
    nets[0].fit(batches)
    nets[1].fit(st.DeviceStager(batches, device="cpu"))
    nets[2].fit(it.AsyncDataSetIterator(batches, device="cpu"))
    for net in nets[1:]:
        np.testing.assert_array_equal(net.params(), nets[0].params())
        assert net.iteration == 6
