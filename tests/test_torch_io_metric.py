"""The port's data iterators, metrics and callbacks against the JAX
package: the iterator cases of ``tests/test_io.py`` (LibSVMIter's CSR
batches with CSVIter's case) and the 9 cases of ``tests/test_metric.py
mirrored, each run in both packages on the same numpy inputs.

Batches are equal (the same numpy rows, the same shuffle stream);
metric values agree at rtol 1e-6 (the port sums on the predictions'
device in float64, the reference in numpy float32 or float64).
"""

import gzip
import logging
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

PKGS = {"jax": jmx, "port": tmx}
MTOL = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread, so that the parallel test
    run does not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn):
    return {k: fn(mx) for k, mx in PKGS.items()}


def _nd(mx, x):
    return mx.nd.array(x, ctx=mx.cpu())


def _write_idx(tmp_path, n=50, rows=8, cols=8, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, rows, cols), dtype=np.uint8)
    labels = rng.randint(0, 10, (n,), dtype=np.uint8)
    img_path = str(tmp_path / "train-images-idx3-ubyte")
    lbl_path = str(tmp_path / "train-labels-idx1-ubyte")
    with open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols))
        f.write(images.tobytes())
    with open(lbl_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    return img_path, lbl_path, images, labels


def _arrays(batches):
    return [[a.asnumpy() for a in b.data] + [a.asnumpy() for a in b.label]
            for b in batches]


# -- iterators ----------------------------------------------------------------

@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter(handle):
    data = np.arange(40).reshape(10, 4).astype(np.float32)
    label = np.arange(10).astype(np.float32)

    def run(mx):
        it = mx.io.NDArrayIter(data, label, batch_size=3,
                               last_batch_handle=handle)
        first = list(it)
        it.reset()
        return first, list(it)
    got = _both(run)
    first, second = got["port"]
    if handle == "pad":
        assert len(first) == 4 and first[-1].pad == 2
        assert len(second) == 4
    elif handle == "discard":
        assert len(first) == 3
    assert first[0].data[0].shape == (3, 4)
    assert first[0].data[0].context == tmx.cpu()
    assert [b.pad for b in first] == [b.pad for b in got["jax"][0]]
    for t, j in zip(_arrays(first), _arrays(got["jax"][0])):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_ndarray_iter_shuffle():
    data = np.arange(20).reshape(20, 1).astype(np.float32)

    def run(mx):
        np.random.seed(7)
        it = mx.io.NDArrayIter(data, data[:, 0], batch_size=5, shuffle=True)
        epochs = [np.concatenate([b.data[0].asnumpy()[:, 0] for b in it])]
        it.reset()
        epochs.append(np.concatenate([b.data[0].asnumpy()[:, 0]
                                      for b in it]))
        return epochs
    got = _both(run)
    for seen in got["port"]:
        assert sorted(seen.tolist()) == list(range(20))
    assert not np.array_equal(got["port"][0], got["port"][1])
    # the same private shuffle stream as the JAX package
    for t, j in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(t, j)


def test_provide_data_label():
    def run(mx):
        it = mx.io.NDArrayIter(np.zeros((8, 3)), np.zeros(8), batch_size=4)
        return [(d.name, d.shape) for d in it.provide_data], \
            [(d.name, d.shape) for d in it.provide_label]
    got = _both(run)
    assert got["port"] == ([("data", (4, 3))], [("softmax_label", (4,))])
    assert got["port"] == got["jax"]


def test_mnist_iter(tmp_path):
    img, lbl, images, labels = _write_idx(tmp_path)

    def run(mx):
        batch = next(iter(mx.io.MNISTIter(image=img, label=lbl,
                                          batch_size=10, shuffle=False)))
        flat = next(iter(mx.io.MNISTIter(image=img, label=lbl,
                                         batch_size=10, flat=True,
                                         shuffle=False)))
        return batch.data[0].asnumpy(), batch.label[0].asnumpy(), \
            flat.data[0].shape
    got = _both(run)
    data, label, flat_shape = got["port"]
    assert data.shape == (10, 1, 8, 8)
    np.testing.assert_allclose(data[0, 0], images[0] / 255.0, rtol=1e-6)
    np.testing.assert_allclose(label, labels[:10])
    assert flat_shape == (10, 64)
    np.testing.assert_array_equal(data, got["jax"][0])


def test_mnist_iter_gz(tmp_path):
    img, lbl, _, _ = _write_idx(tmp_path)
    for p in (img, lbl):
        with open(p, "rb") as fin, gzip.open(p + ".gz", "wb") as fout:
            fout.write(fin.read())
        os.remove(p)
    it = tmx.io.MNISTIter(image=img + ".gz", label=lbl + ".gz",
                          batch_size=5, shuffle=False)
    assert next(iter(it)).data[0].shape == (5, 1, 8, 8)


def test_csv_iter(tmp_path):
    data = np.random.RandomState(0).rand(12, 3).astype(np.float32)
    label = np.arange(12).astype(np.float32)
    dpath, lpath = str(tmp_path / "data.csv"), str(tmp_path / "label.csv")
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")

    def run(mx):
        it = mx.io.CSVIter(data_csv=dpath, data_shape=(3,), label_csv=lpath,
                           batch_size=4)
        return _arrays(list(it))
    got = _both(run)
    np.testing.assert_allclose(got["port"][0][0], data[:4], rtol=1e-5)
    for t, j in zip(got["port"], got["jax"]):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    # LibSVMIter is ported: a LibSVM file gives the JAX package's batches
    spath = str(tmp_path / "d.libsvm")
    with open(spath, "w") as f:
        for r in range(6):
            f.write("%d %d:%g %d:1.5\n" % (r % 2, r % 3, r + 0.5, 3))

    def run_svm(mx):
        it = mx.io.LibSVMIter(data_libsvm=spath, data_shape=(4,),
                              batch_size=4)
        return [[b.data[0].asnumpy(), b.data[0].indptr.asnumpy(),
                 b.label[0].asnumpy(), np.array(b.pad)] for b in it]
    got = _both(run_svm)
    for t, j in zip(got["port"], got["jax"]):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_resize_iter():
    def run(mx):
        it = mx.io.NDArrayIter(np.zeros((10, 2)), np.zeros(10), batch_size=5)
        resized = mx.io.ResizeIter(it, 5)
        n = len(list(resized))
        resized.reset()
        return n, len(list(resized))
    got = _both(run)
    assert got["port"] == (5, 5) == got["jax"]


def test_prefetching_iter():
    data = np.arange(40).reshape(20, 2).astype(np.float32)
    it = tmx.io.NDArrayIter(data, np.zeros(20), batch_size=5)
    pre = tmx.io.PrefetchingIter(it)
    batches = []
    while True:
        try:
            batches.append(pre.next())
        except StopIteration:
            break
    assert len(batches) == 4
    np.testing.assert_array_equal(
        np.concatenate([b.data[0].asnumpy() for b in batches]), data)
    pre.reset()
    assert pre.iter_next() and pre.getdata()[0].shape == (5, 2)
    assert len(list(pre)) == 4      # the peeked batch is not dropped

    class Dying(tmx.io.NDArrayIter):
        served = 0

        def next(self):
            if Dying.served == 2:
                Dying.served += 1
                raise RuntimeError("worker died")
            Dying.served += 1
            return super().next()

    pre = tmx.io.PrefetchingIter(Dying(data, np.zeros(20), batch_size=5))
    pre.next(), pre.next()
    with pytest.raises(RuntimeError, match="worker died"):
        pre.next()
    with pytest.raises(StopIteration):
        pre.next()
    pre.reset()
    assert len(list(pre)) == 4
    pre.close()


# -- metrics --------------------------------------------------------------------

def _metric(mx, name, labels, preds, **kw):
    m = mx.metric.create(name, **kw)
    m.update([_nd(mx, l) for l in labels], [_nd(mx, p) for p in preds])
    return m.get()


def _check_metric(name, labels, preds, want=None, **kw):
    got = _both(lambda mx: _metric(mx, name, labels, preds, **kw))
    assert got["port"][0] == got["jax"][0]
    np.testing.assert_allclose(got["port"][1], got["jax"][1], **MTOL)
    if want is not None:
        np.testing.assert_allclose(got["port"][1], want, rtol=1e-5)
    return got["port"]


def test_accuracy():
    name, _ = _check_metric("acc", [np.array([1, 0, 0], np.float32)],
                            [np.array([[0.3, 0.7], [0.9, 0.1], [0.4, 0.6]],
                                      np.float32)], 2.0 / 3)
    assert name == "accuracy"


def test_topk():
    _check_metric("top_k_accuracy", [np.array([1, 1], np.float32)],
                  [np.array([[0.1, 0.2, 0.7], [0.8, 0.05, 0.15]],
                            np.float32)], 0.5, top_k=2)


def test_mse_mae_rmse():
    pred = np.array([[1.0], [2.0]], np.float32)
    label = np.array([1.5, 1.0], np.float32)
    _check_metric("mse", [label], [pred], (0.25 + 1.0) / 2)
    _check_metric("mae", [label], [pred], (0.5 + 1.0) / 2)
    _check_metric("rmse", [label], [pred])


def test_perplexity():
    rs = np.random.RandomState(0)
    _check_metric("Perplexity", [np.array([0, 0], np.float32)],
                  [np.array([[0.5, 0.5], [0.9, 0.1]], np.float32)],
                  np.exp(-(np.log(0.5) + np.log(0.9)) / 2),
                  ignore_label=None)
    # an LM's (batch, seq, vocab) probabilities with an ignored label
    p = rs.rand(2, 5, 7).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    label = rs.randint(0, 7, (2, 5)).astype(np.float32)
    label[0, :2] = 3
    _check_metric("perplexity", [label], [p], ignore_label=3)
    _check_metric("perplexity", [label], [p])


def test_composite():
    m = tmx.metric.create(["acc", "mse"])
    assert isinstance(m, tmx.metric.CompositeEvalMetric)
    names, values = m.get()
    assert len(names) == 2
    jnames, _ = jmx.metric.create(["acc", "mse"]).get()
    assert names == jnames


def test_custom_metric():
    def my_metric(label, pred):
        return float(np.abs(label - pred).sum())

    got = _both(lambda mx: (lambda m: (m.update([_nd(mx, [1.0])],
                                                [_nd(mx, [0.0])]),
                                       m.get())[1])(mx.metric.np(my_metric)))
    assert got["port"] == got["jax"] == ("my_metric", 1.0)


def test_cross_entropy():
    _check_metric("ce", [np.array([1], np.float32)],
                  [np.array([[0.25, 0.75]], np.float32)], -np.log(0.75))
    _check_metric("nll_loss", [np.array([1, 0], np.float32)],
                  [np.array([[0.25, 0.75], [0.5, 0.5]], np.float32)])


def test_f1():
    _, v = _check_metric("f1", [np.array([1, 0, 0], np.float32)],
                         [np.array([[0.2, 0.8], [0.8, 0.2], [0.3, 0.7]],
                                   np.float32)])
    assert 0 < v <= 1.0


def test_column_vector_labels_all_classifiers():
    rs = np.random.RandomState(0)
    preds = rs.rand(6, 2).astype(np.float32)
    lab_col = rs.randint(0, 2, (6, 1)).astype(np.float32)
    for name in ("acc", "f1", "mcc"):
        _, v = _check_metric(name, [lab_col], [preds])
        assert np.isfinite(v) and abs(v) <= 1.0, (name, v)
    _, v = _check_metric("top_k_accuracy", [lab_col],
                         [rs.rand(6, 5).astype(np.float32)], top_k=2)
    assert 0.0 <= v <= 1.0
    _check_metric("pearsonr", [rs.rand(6).astype(np.float32)],
                  [rs.rand(6).astype(np.float32)])
    _check_metric("loss", [], [rs.rand(3, 2).astype(np.float32)])


def test_metric_reduces_on_the_predictions_device():
    """The sums are taken where the predictions are: a CPU label meets a
    prediction on its device (here the CPU), and only sums come back."""
    m = tmx.metric.Perplexity()
    p = torch.softmax(torch.randn(2, 3, 5), -1)
    m.update([tmx.nd.array([[0, 1, 2], [3, 4, 0]], ctx=tmx.cpu())],
             [tmx.nd.NDArray(p)])
    picked = p.reshape(-1, 5)[torch.arange(6), torch.tensor(
        [0, 1, 2, 3, 4, 0])].double()
    np.testing.assert_allclose(m.get()[1],
                               float(torch.exp(-picked.log().mean())),
                               rtol=1e-12)


# -- callbacks ------------------------------------------------------------------

def test_callbacks(tmp_path, caplog):
    from mxnet_tpu_torch.model import BatchEndParam
    m = tmx.metric.create("acc")
    m.update([_nd(tmx, np.array([1, 0], np.float32))],
             [_nd(tmx, np.array([[0.1, 0.9], [0.2, 0.8]], np.float32))])
    caplog.set_level(logging.INFO)
    speed = tmx.callback.Speedometer(4, frequent=2)
    for i in range(5):
        speed(BatchEndParam(epoch=0, nbatch=i, eval_metric=m, locals=None))
    assert speed.rate is not None and speed.rate > 0
    assert "samples/sec" in caplog.text and "accuracy=0.5" in caplog.text
    assert m.num_inst == 0          # auto_reset after the log
    m.update([_nd(tmx, np.array([1], np.float32))],
             [_nd(tmx, np.array([[0.1, 0.9]], np.float32))])
    tmx.callback.log_train_metric(1, auto_reset=True)(
        BatchEndParam(epoch=1, nbatch=3, eval_metric=m, locals=None))
    assert "Train-accuracy=1.000000" in caplog.text and m.num_inst == 0
    tmx.callback.ProgressBar(10, length=10)(
        BatchEndParam(epoch=0, nbatch=5, eval_metric=None, locals=None))
    assert "[=====-----] 50%" in caplog.text
    # the checkpoint callbacks write what both packages load
    sym = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=2,
                                 name="fc")
    arg = {"fc_weight": _nd(tmx, np.ones((2, 3), np.float32)),
           "fc_bias": _nd(tmx, np.zeros(2, np.float32))}
    prefix = str(tmp_path / "cb")
    cb = tmx.callback.do_checkpoint(prefix, period=2)
    cb(0, sym, arg, {})
    assert not os.path.exists(prefix + "-0001.params")
    cb(1, sym, arg, {})
    for a in (jmx.model.load_checkpoint(prefix, 2)[1],
              tmx.model.load_checkpoint(prefix, 2, ctx=tmx.cpu())[1]):
        np.testing.assert_array_equal(a["fc_weight"].asnumpy(),
                                      np.ones((2, 3)))
    saved = []

    class FakeModule:
        def save_checkpoint(self, prefix, epoch, states):
            saved.append((prefix, epoch, states))
    tmx.callback.module_checkpoint(FakeModule(), "p", 1, True)(2)
    assert saved == [("p", 3, True)]
