"""The port's data pipeline against the JAX package's, on the CPU: the
counterparts of ``tests/test_data_pipeline.py``'s dataset, loader, cache
and uint8 cases.

- ``flowers``, ``cifar``, ``mnist`` and ``uci_housing``: the port's
  synthetic samples equal the reference's, shapes, dtypes and values.
- ``DeviceLoader``: its batches equal ``batch(reader)``'s, stacked per
  field; an iterator abandoned mid-epoch stops its producer thread; the
  producer stages batch k+1 while the consumer holds batch k (held by
  ordering, no wall-clock bar); it feeds a training loop.
- ``DeviceDatasetCache``: each epoch covers every sample once in a new
  order (the same seed gives the same orders), the budget raises
  ``DatasetExceedsBudget`` (a ``ValueError`` naming ``max_bytes``).
- ResNet's uint8 input (cast and scaled on the device) gives the float
  input's loss within 1e-4, and the reference's uint8 loss from the
  reference's parameters within rtol 1e-4.
- A ``CUDAPlace`` without a card raises: no loader carries on on the
  host.
"""
import itertools
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu import dataset as jdataset
from paddle_tpu_torch import dataset as tdataset
from paddle_tpu_torch import reader
from paddle_tpu_torch.fluid.io import set_scope_arrays


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# (module, creator, samples compared; None: all)
DATASETS = [("flowers", "train", 48), ("flowers", "test", None),
            ("cifar", "train10", 256), ("cifar", "test10", None),
            ("cifar", "train100", 256), ("cifar", "test100", 64),
            ("mnist", "train", None), ("mnist", "test", None),
            ("uci_housing", "train", None), ("uci_housing", "test", None)]


@pytest.mark.parametrize("mod,fn,n", DATASETS,
                         ids=["%s.%s" % d[:2] for d in DATASETS])
def test_dataset_samples_are_the_references(mod, fn, n):
    assert getattr(tdataset, mod).is_synthetic()
    want = list(itertools.islice(getattr(getattr(jdataset, mod), fn)()(), n))
    got = list(itertools.islice(getattr(getattr(tdataset, mod), fn)()(), n))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, int):
                assert isinstance(a, int) and a == b
            else:
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_dataset_shapes():
    img, lab = next(tdataset.mnist.train()())
    assert img.shape == (784,) and img.dtype == np.float32
    assert -1.0 <= img.min() and img.max() <= 1.0 and 0 <= lab < 10
    img, lab = next(tdataset.cifar.train100()())
    assert img.shape == (3072,) and 0 <= lab < 100
    img, lab = next(tdataset.flowers.train()())
    assert img.shape == (3, 224, 224) and 0 <= lab < 102
    x, y = next(tdataset.uci_housing.train()())
    assert x.shape == (13,) and y.shape == (1,)


def _labeled_reader(n, dim=4):
    def r():
        for i in range(n):
            yield (np.full((dim,), i, np.float32),
                   np.asarray([i], np.int64))

    return r


def test_device_loader_batches_equal_batch_reader():
    base = reader.map_readers(lambda s: (s[0], np.asarray([s[1]], np.int64)),
                              tdataset.mnist.test())
    batched = reader.batch(base, 64)
    loader = reader.DeviceLoader(batched, ["img", "label"], tfluid.CPUPlace(),
                                 capacity=2)
    got = list(loader)
    want = list(batched())
    assert len(got) == len(want) == 512 // 64
    for g, w in zip(got, want):
        assert sorted(g) == ["img", "label"]
        assert isinstance(g["img"], torch.Tensor)
        assert g["img"].device.type == "cpu"
        np.testing.assert_array_equal(g["img"].numpy(),
                                      np.stack([s[0] for s in w]))
        np.testing.assert_array_equal(g["label"].numpy(),
                                      np.stack([s[1] for s in w]))
        assert g["label"].dtype == torch.int64


def test_device_loader_field_count_must_match():
    loader = reader.DeviceLoader(reader.batch(_labeled_reader(4), 2), ["x"],
                                 tfluid.CPUPlace())
    with pytest.raises(ValueError, match="2 fields"):
        list(loader)


def test_device_loader_early_break_stops_producer():
    def slow_reader():
        for i in range(100):
            yield [(np.zeros(4, np.float32),) for _ in range(2)]

    before = threading.active_count()
    loader = reader.DeviceLoader(slow_reader, ["x"], tfluid.CPUPlace(),
                                 capacity=2)
    it = iter(loader)
    next(it)
    it.close()  # generator finally -> stop event
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_device_loader_stages_the_next_batch_while_one_is_held():
    """The double-buffer contract, by ordering: while the consumer holds
    batch k, the producer is already inside batch k+1 (it asked the
    reader for it).  The reader blocks in batch k+1 until the consumer
    says it has batch k, so neither side can run ahead by luck."""
    n = 6
    asked = [threading.Event() for _ in range(n + 1)]
    consumed = [threading.Event() for _ in range(n)]

    def gated():
        for i in range(n):
            asked[i].set()
            if i > 0:   # batch i is produced only once i - 1 is held
                assert consumed[i - 1].wait(10)
            yield [(np.full(3, i, np.float32),)]
        asked[n].set()

    loader = reader.DeviceLoader(gated, ["x"], tfluid.CPUPlace(), capacity=2)
    for k, feed in enumerate(loader):
        assert int(feed["x"][0, 0]) == k
        # held: the producer has asked for batch k + 1 already
        assert asked[k + 1].wait(10), k
        consumed[k].set()
    assert k == n - 1


def test_device_loader_feeds_training():
    main, startup = tfluid.Program(), tfluid.Program()
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope), tfluid.program_guard(main, startup), \
            tfluid.unique_name.guard():
        img = tfluid.layers.data(name="img", shape=[784], dtype="float32")
        lab = tfluid.layers.data(name="label", shape=[1], dtype="int64")
        pred = tfluid.layers.fc(img, size=10, act="softmax")
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(pred, lab))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        r = reader.batch(reader.shuffle(reader.map_readers(
            lambda s: (s[0], np.asarray([s[1]], np.int64)),
            tdataset.mnist.train()), buf_size=256), batch_size=64)
        losses = [float(np.ravel(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0])[0])
                  for feed in reader.DeviceLoader(r, ["img", "label"],
                                                  tfluid.CPUPlace())]
    assert len(losses) == 2048 // 64
    # learnable synthetic blobs: one epoch must cut loss in half
    assert np.mean(losses[-4:]) < losses[0] * 0.5


def test_device_dataset_cache_epoch_coverage_and_reshuffle():
    n, bs = 20, 5
    cache = reader.DeviceDatasetCache(
        _labeled_reader(n), ["x", "y"], tfluid.CPUPlace(), bs, seed=7)
    assert cache.nbytes == n * (4 * 4 + 8)

    def epoch_ids(c):
        ids = []
        for d in c:
            assert tuple(d["x"].shape) == (bs, 4)
            assert tuple(d["y"].shape) == (bs, 1)
            # field alignment: the label matches the image fill value
            assert torch.equal(d["x"][:, 0].long(), d["y"][:, 0])
            ids.extend(d["y"][:, 0].tolist())
        assert len(ids) == n // bs * bs
        return ids

    e0, e1 = epoch_ids(cache), epoch_ids(cache)
    # every sample exactly once per epoch, different order across epochs
    assert sorted(e0) == list(range(n)) and sorted(e1) == list(range(n))
    assert e0 != e1
    # the order is a function of (seed, epoch)
    again = reader.DeviceDatasetCache(
        _labeled_reader(n), ["x", "y"], tfluid.CPUPlace(), bs, seed=7)
    assert epoch_ids(again) == e0 and epoch_ids(again) == e1


def test_device_dataset_cache_drops_the_partial_batch():
    cache = reader.DeviceDatasetCache(
        _labeled_reader(23), ["x", "y"], tfluid.CPUPlace(), 5, seed=1)
    ids = [i for d in cache for i in d["y"][:, 0].tolist()]
    assert len(ids) == 20 and len(set(ids)) == 20


def test_device_dataset_cache_budget_and_small_dataset():
    with pytest.raises(reader.DatasetExceedsBudget, match="max_bytes"):
        reader.DeviceDatasetCache(_labeled_reader(8), ["x", "y"],
                                  tfluid.CPUPlace(), 2, max_bytes=16)
    assert issubclass(reader.DatasetExceedsBudget, ValueError)
    with pytest.raises(ValueError, match="smaller than one batch"):
        reader.DeviceDatasetCache(_labeled_reader(3), ["x", "y"],
                                  tfluid.CPUPlace(), 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("what", ["loader", "cache", "double_buffer"])
def test_a_cuda_place_without_a_card_raises(what):
    place = tfluid.CUDAPlace(0)
    if what == "loader":
        with pytest.raises(RuntimeError, match="CUDA"):
            next(iter(reader.DeviceLoader(reader.batch(_labeled_reader(4), 2),
                                          ["x", "y"], place)))
    elif what == "cache":
        with pytest.raises(RuntimeError, match="CUDA"):
            reader.DeviceDatasetCache(_labeled_reader(4), ["x", "y"], place,
                                      2)
    else:
        from paddle_tpu_torch.core.executor_impl import EOFException
        from paddle_tpu_torch.ops import reader_ops

        class Two(reader_ops._ReaderBase):
            def next(self):
                raise EOFException("two")

            def reset(self):
                pass

        db = reader_ops._DoubleBufferReader(Two(), place=place)
        with pytest.raises(RuntimeError, match="CUDA"):
            db.next()


def _resnet_loss(fluid, dt, feed_img, lab, scope, arrays=None):
    main, startup = fluid.Program(), fluid.Program()
    models = __import__(fluid.__name__.split(".")[0] + ".models",
                        fromlist=["resnet"])
    with fluid.scope_guard(scope), fluid.program_guard(main, startup), \
            fluid.unique_name.guard():
        avg_cost, (data, label), _ = models.resnet.get_model(
            data_set="cifar10", depth=8, input_dtype=dt, is_test=True)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if arrays is not None:
            set_scope_arrays(scope, arrays, "cpu")
        loss, = exe.run(main, feed={data.name: feed_img, label.name: lab},
                        fetch_list=[avg_cost])
        persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                         if v.persistable)
    return float(np.asarray(loss).ravel()[0]), persist


def test_resnet_uint8_input_matches_float_and_the_reference():
    from paddle_tpu.core.scope import Scope as JScope

    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (2, 3, 32, 32)).astype(np.uint8)
    lab = rng.randint(0, 10, (2, 1)).astype(np.int64)
    jscope = JScope()
    jloss, persist = _resnet_loss(jfluid, "uint8", u8, lab, jscope)
    arrays = {n: np.asarray(jscope.find_var(n)) for n in persist}
    losses = {dt: _resnet_loss(tfluid, dt, u8 if dt == "uint8" else
                               u8.astype(np.float32) / 255.0, lab,
                               tfluid.Scope(), arrays)[0]
              for dt in ("uint8", "float32")}
    assert np.isfinite(losses["uint8"])
    assert abs(losses["uint8"] - losses["float32"]) < 1e-4
    np.testing.assert_allclose(losses["uint8"], jloss, rtol=1e-4)
