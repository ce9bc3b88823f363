"""gluon.data in the PyTorch port (datasets, samplers, DataLoader,
vision datasets and transforms) against the JAX package on the same
inputs.  Process workers are spawned with no card visible and build
their samples on the CPU; each spawn imports torch, so few tests use
them."""

import os
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as JT
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data import (ArrayDataset, BatchSampler,
                                        DataLoader, ElasticBatchSampler,
                                        RandomSampler, SequentialSampler,
                                        SimpleDataset)
from mxnet_tpu_torch.gluon.data.vision import transforms as TT

cv2 = pytest.importorskip("cv2")


def _field(h, w, seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([(yy * 0.5 + seed * 9) % 256, (xx * 0.4) % 256,
                    ((yy + xx) * 0.3) % 256], -1)
    img += rs.randint(0, 24, img.shape)
    return img.clip(0, 255).astype(np.uint8)


def _as_np(x):
    if isinstance(x, (list, tuple)):
        return [_as_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _as_np(g), _as_np(w)
        if isinstance(w, list):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def test_datasets_equal_to_the_reference():
    x = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    y = np.arange(10).astype(np.float32)
    for mod in (jdata, tdata):
        ds = mod.ArrayDataset(x, y)
        assert len(ds) == 10
    tds, jds = tdata.ArrayDataset(x, y), jdata.ArrayDataset(x, y)
    for i in (0, 4, 9):
        np.testing.assert_array_equal(tds[i][0], jds[i][0])
        assert tds[i][1] == jds[i][1]
    t2 = tdata.SimpleDataset(list(range(10))).transform(_double)
    j2 = jdata.SimpleDataset(list(range(10))).transform(_double)
    assert [t2[i] for i in range(10)] == [j2[i] for i in range(10)]
    t3 = tds.transform_first(_double, lazy=False)
    j3 = jds.transform_first(_double, lazy=False)
    for i in range(10):
        np.testing.assert_array_equal(t3[i][0], j3[i][0])
        assert t3[i][1] == j3[i][1]
    assert len(tds.filter(lambda s: s[1] > 4)) == \
        len(jds.filter(lambda s: s[1] > 4)) == 5
    with pytest.raises(AssertionError, match="same length"):
        tdata.ArrayDataset(x, y[:3])


def test_transform_first_pickles():
    ds = tdata.ArrayDataset(np.arange(6).astype(np.float32),
                            np.arange(6)).transform_first(_double)
    ds2 = pickle.loads(pickle.dumps(ds))
    assert ds2[3] == ds[3] == (6.0, 3)


def test_record_file_dataset_equal_to_the_reference(tmp_path):
    from mxnet_tpu_torch import recordio
    prefix = str(tmp_path / "r")
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(7):
        w.write_idx(i, b"rec-%d" % i * (i + 1))
    w.close()
    tds = tdata.RecordFileDataset(prefix + ".rec")
    jds = jdata.RecordFileDataset(prefix + ".rec")
    assert len(tds) == len(jds) == 7
    assert [tds[i] for i in range(7)] == [jds[i] for i in range(7)]


def _double(x):
    return x * 2


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_batch_sampler_equal_to_the_reference(last):
    for n, b in ((10, 3), (12, 4), (7, 8)):
        t = BatchSampler(SequentialSampler(n), b, last)
        j = jdata.BatchSampler(jdata.SequentialSampler(n), b, last)
        for _ in range(3):
            assert list(t) == list(j)
            assert len(t) == len(j)


def test_random_sampler_equal_to_the_reference_and_resumable():
    t, j = RandomSampler(20, seed=5), jdata.RandomSampler(20, seed=5)
    for _ in range(3):
        assert list(t) == list(j)
    st = t.state_dict()
    want = list(t)
    t2 = RandomSampler(20, seed=0)
    t2.load_state(st)
    assert list(t2) == want
    t2.load_state(t.state_dict(), in_progress=True)
    assert list(t2) == want
    np.random.seed(3)
    a = list(RandomSampler(20))
    np.random.seed(3)
    assert a == list(jdata.RandomSampler(20))


@pytest.mark.parametrize("start,mid", [(3, 2), (2, 3)])
def test_elastic_batch_sampler_exactly_once(start, mid):
    N, B = 24, 2
    samplers = [ElasticBatchSampler(N, B, part_index=p, num_parts=start,
                                    seed=11, last_batch="keep")
                for p in range(start)]
    its = [iter(s) for s in samplers]
    seen = []
    for _ in range(3):
        for it in its:
            seen.extend(next(it))
    if mid < start:
        samplers, its = samplers[:mid], its[:mid]
    else:
        st = samplers[0].state_dict()
        for p in range(start, mid):
            s = ElasticBatchSampler(N, B, seed=11, last_batch="keep")
            s.load_state(st, in_progress=True)
            samplers.append(s)
            its.append(iter(s))
    for i, s in enumerate(samplers):
        s.repartition(i, mid)
    while True:
        done = False
        for it in its:
            try:
                seen.extend(next(it))
            except StopIteration:
                done = True
        if done:
            break
    counts = {}
    for i in seen:
        counts[i] = counts.get(i, 0) + 1
    assert sorted(counts) == list(range(N))
    assert all(v == 1 for v in counts.values())


def test_elastic_batch_sampler_keep_tail_and_state():
    N, B = 22, 2
    seen = []
    for p in range(3):
        s = ElasticBatchSampler(N, B, part_index=p, num_parts=3, seed=2,
                                last_batch="keep")
        j = jdata.ElasticBatchSampler(N, B, part_index=p, num_parts=3,
                                      seed=2, last_batch="keep")
        got = list(s)
        assert got == list(j)
        for b in got:
            seen.extend(b)
    assert sorted(seen) == list(range(N))
    a = ElasticBatchSampler(N, B, part_index=1, num_parts=2, seed=9)
    ia = iter(a)
    consumed = [next(ia), next(ia)]
    st = a.state_dict()
    rest_a = list(ia)
    b2 = ElasticBatchSampler(N, B, seed=9)
    b2.load_state(st, in_progress=True)
    b2.repartition(1, 2)
    assert list(iter(b2)) == rest_a
    assert consumed[0] != consumed[1]
    with pytest.raises(ValueError, match="last_batch"):
        ElasticBatchSampler(N, B, last_batch="rollover")
    with pytest.raises(ValueError, match="exceed"):
        ElasticBatchSampler(4, 3, num_parts=2)


def test_elastic_batch_sampler_len_matches_yields_keep():
    for part in range(2):
        s = ElasticBatchSampler(10, 4, part_index=part, num_parts=2,
                                seed=1, last_batch="keep")
        assert len(list(iter(s))) == len(s), "part %d" % part
    assert len(ElasticBatchSampler(10, 4, part_index=0, num_parts=2,
                                   seed=1, last_batch="keep")) == 2
    assert len(ElasticBatchSampler(10, 4, part_index=1, num_parts=2,
                                   seed=1, last_batch="keep")) == 1


def test_dataloader_elastic_repartition_and_resume():
    N, B = 24, 2
    ds = ArrayDataset(np.arange(N).astype(np.float32))

    def mk(p, k):
        return DataLoader(ds, batch_sampler=ElasticBatchSampler(
            N, B, part_index=p, num_parts=k, seed=21))

    with mx.cpu():
        loaders = [mk(p, 2) for p in range(2)]
        its = [iter(dl) for dl in loaders]
        seen = []
        for _ in range(3):
            for it in its:
                seen.extend(int(v) for v in next(it).asnumpy())
        st = loaders[0].state_dict()
        j = mk(0, 1)
        j.load_state(st)
        j.repartition(2, 3)
        for i, dl in enumerate(loaders):
            dl.repartition(i, 3)
        its.append(iter(j))
        while True:
            done = False
            for it in its:
                try:
                    seen.extend(int(v) for v in next(it).asnumpy())
                except StopIteration:
                    done = True
            if done:
                break
    counts = {}
    for i in seen:
        counts[i] = counts.get(i, 0) + 1
    assert sorted(counts) == list(range(N))
    assert all(v == 1 for v in counts.values())


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------

def _loader_batches(mod, ds, **kw):
    if mod is tdata:
        with mx.cpu():
            return [b for b in mod.DataLoader(ds, **kw)]
    return [b for b in mod.DataLoader(ds, **kw)]


@pytest.mark.parametrize("mode", ["serial", "threads"])
@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_dataloader_equal_to_the_reference(mode, last):
    x = np.random.RandomState(1).rand(22, 3).astype(np.float32)
    y = np.arange(22).astype(np.int64)
    kw = dict(batch_size=4, shuffle=True, last_batch=last)
    if mode == "threads":
        kw.update(num_workers=3, thread_workers=True)
    np.random.seed(4)
    want = _loader_batches(jdata, jdata.ArrayDataset(x, y), **kw)
    np.random.seed(4)
    got = _loader_batches(tdata, ArrayDataset(x, y), **kw)
    _assert_batches_equal(got, want)
    assert all(b[0].context == mx.cpu() for b in got)


def test_dataloader_process_workers_equal_batches_pinned():
    """Two spawned workers: the batches, in order, equal the serial
    loader's, for two epochs (a fresh worker pool each); host tensors,
    pinned only where CUDA is there to pin for."""
    x = np.arange(60).reshape(20, 3).astype(np.float32)
    y = np.arange(20).astype(np.float32)
    ds = ArrayDataset(x, y)
    want = _loader_batches(tdata, ds, batch_size=4)
    dl = DataLoader(ds, batch_size=4, num_workers=2, pin_memory=True)
    assert dl._mp_ok
    for _ in range(2):
        got = list(dl)
        _assert_batches_equal(got, want)
        assert got[0][0].context == mx.cpu()
        import torch
        assert got[0][0]._data.is_pinned() == torch.cuda.is_available()


def test_dataloader_worker_exception_reaches_the_caller():
    """A sampler past the dataset's end: index 6 fails in a worker."""
    short = SimpleDataset([np.float32(i) for i in range(6)])

    def loader(**kw):
        return DataLoader(short, batch_sampler=BatchSampler(
            SequentialSampler(10), 4), num_workers=2, **kw)

    with pytest.raises(RuntimeError, match="list index out of range"):
        list(loader())
    with pytest.raises(IndexError):
        with mx.cpu():
            list(loader(thread_workers=True))


def test_dataloader_unpicklable_falls_back_to_threads():
    ds = ArrayDataset(np.arange(12).astype(np.float32)).transform(
        lambda x: x + 1)
    with pytest.warns(UserWarning, match="not picklable"):
        dl = DataLoader(ds, batch_size=3, num_workers=2)
    with mx.cpu():
        out = list(dl)
    assert len(out) == 4
    np.testing.assert_allclose(out[0].asnumpy(), [1, 2, 3], rtol=1e-6)


def test_dataloader_state_resumes_shuffle_order_and_cursor():
    data = [np.full((2,), i, np.float32) for i in range(32)]
    with mx.cpu():
        dl = DataLoader(data, batch_size=4, shuffle=True)
        it = iter(dl)
        [next(it) for _ in range(3)]
        st = dl.state_dict()
        assert st["cursor"] == 3
        rest = [b.asnumpy() for b in it]
        dl2 = DataLoader(data, batch_size=4, shuffle=True)
        dl2.load_state(st)
        rest2 = [b.asnumpy() for b in dl2]
    assert len(rest) == len(rest2) == 5
    for a, b in zip(rest, rest2):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not a DataLoader state"):
        dl2.load_state({"type": "NDArrayIter", "cursor": 0})


def test_dataloader_rollover_resume_keeps_leftovers():
    data = [np.full((1,), i, np.float32) for i in range(10)]
    with mx.cpu():
        np.random.seed(77)
        dl = DataLoader(data, batch_size=4, shuffle=True,
                        last_batch="rollover")
        list(iter(dl))
        it = iter(dl)
        next(it)
        st = dl.state_dict()
        rest = [b.asnumpy() for b in it]
        np.random.seed(77)
        dl2 = DataLoader(data, batch_size=4, shuffle=True,
                         last_batch="rollover")
        list(iter(dl2))
        dl2.load_state(st)
        rest2 = [b.asnumpy() for b in dl2]
    assert len(rest) == len(rest2)
    for a, b in zip(rest, rest2):
        np.testing.assert_array_equal(a, b)


def test_dataloader_argument_errors():
    ds = ArrayDataset(np.arange(8).astype(np.float32))
    with pytest.raises(ValueError, match="batch_size must be specified"):
        DataLoader(ds)
    with pytest.raises(ValueError, match="shuffle must not"):
        DataLoader(ds, batch_size=2, shuffle=True,
                   sampler=SequentialSampler(8))
    with pytest.raises(ValueError, match="must not be specified"):
        DataLoader(ds, batch_size=2,
                   batch_sampler=BatchSampler(SequentialSampler(8), 2))
    with pytest.raises(AttributeError, match="repartition"):
        DataLoader(ds, batch_size=2).repartition(0, 2)


def test_image_record_dataset_process_workers_bit_equal(tmp_path):
    """Phase 12 (g)'s check at small size: deterministic transforms over
    JPEG records through two spawned workers give the serial loader's
    batches bit for bit."""
    from mxnet_tpu_torch import recordio
    prefix = str(tmp_path / "img")
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(12):
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 3), i, 0),
            _field(30 + i, 26 + 2 * i, i), quality=90))
    w.close()
    tf = TT.Compose([TT.Resize(20), TT.ToTensor(),
                     TT.Normalize((0.485, 0.456, 0.406),
                                  (0.229, 0.224, 0.225))])
    ds = tdata.vision.ImageRecordDataset(prefix + ".rec").transform_first(tf)
    want = _loader_batches(tdata, ds, batch_size=4, last_batch="discard")
    got = list(DataLoader(ds, batch_size=4, num_workers=2, pin_memory=True,
                          last_batch="discard"))
    _assert_batches_equal(got, want)
    assert got[0][0].shape == (4, 3, 20, 20)
    jds = jdata.vision.ImageRecordDataset(prefix + ".rec").transform_first(
        JT.Compose([JT.ToTensor(),
                    JT.Normalize((0.485, 0.456, 0.406),
                                 (0.229, 0.224, 0.225))]))
    ttf = TT.Compose([TT.ToTensor(),
                      TT.Normalize((0.485, 0.456, 0.406),
                                   (0.229, 0.224, 0.225))])
    with mx.cpu():
        tds = tdata.vision.ImageRecordDataset(prefix + ".rec")
        for i in (0, 5, 11):
            img, label = tds.transform_first(ttf)[i]
            jimg, jlabel = jds[i]
            assert label == jlabel
            np.testing.assert_allclose(img.asnumpy(), jimg.asnumpy(),
                                       rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# vision datasets
# ---------------------------------------------------------------------------

def _write_idx_files(root, train=True, n=12):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rs.randint(0, 10, (n,), dtype=np.uint8)
    base = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte") if train \
        else ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, base[0]), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(images.tobytes())
    with open(os.path.join(root, base[1]), "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST"])
def test_idx_datasets_equal_to_the_reference(tmp_path, name):
    root = str(tmp_path / name)
    _write_idx_files(root, train=True)
    _write_idx_files(root, train=False, n=5)
    for train, n in ((True, 12), (False, 5)):
        with mx.cpu():
            t = getattr(tdata.vision, name)(root=root, train=train)
            got = [t[i] for i in range(n)]
        j = getattr(jdata.vision, name)(root=root, train=train)
        assert len(t) == len(j) == n
        for (gi, gl), i in zip(got, range(n)):
            ji, jl = j[i]
            assert gi.dtype == np.uint8 and gi.shape == (28, 28, 1)
            np.testing.assert_array_equal(gi.asnumpy(), ji.asnumpy())
            assert gl == jl
    with pytest.raises(IOError, match="not found"):
        getattr(tdata.vision, name)(root=str(tmp_path / "none"))


def _write_cifar(root, kind):
    rs = np.random.RandomState(1)
    os.makedirs(root, exist_ok=True)
    if kind == 10:
        for name in ["data_batch_%d" % i for i in range(1, 6)] + \
                ["test_batch"]:
            with open(os.path.join(root, name), "wb") as f:
                pickle.dump({b"data": rs.randint(0, 256, (4, 3072),
                                                 dtype=np.uint8),
                             b"labels": list(rs.randint(0, 10, 4))}, f)
    else:
        for name in ("train", "test"):
            with open(os.path.join(root, name), "wb") as f:
                pickle.dump({b"data": rs.randint(0, 256, (6, 3072),
                                                 dtype=np.uint8),
                             b"fine_labels": list(rs.randint(0, 100, 6)),
                             b"coarse_labels": list(rs.randint(0, 20, 6))},
                            f)


@pytest.mark.parametrize("kind,kw", [(10, {}), (100, {}),
                                     (100, {"fine_label": True})])
def test_cifar_datasets_equal_to_the_reference(tmp_path, kind, kw):
    root = str(tmp_path / ("c%d" % kind))
    _write_cifar(root, kind)
    cls = "CIFAR10" if kind == 10 else "CIFAR100"
    for train in (True, False):
        with mx.cpu():
            t = getattr(tdata.vision, cls)(root=root, train=train, **kw)
            got = [t[i] for i in range(len(t))]
        j = getattr(jdata.vision, cls)(root=root, train=train, **kw)
        assert len(got) == len(j)
        for i, (gi, gl) in enumerate(got):
            ji, jl = j[i]
            assert gi.shape == (32, 32, 3)
            np.testing.assert_array_equal(gi.asnumpy(), ji.asnumpy())
            assert gl == jl


def test_image_folder_dataset_equal_to_the_reference(tmp_path):
    from PIL import Image
    for c, cls in enumerate(("cat", "dog")):
        d = tmp_path / cls
        d.mkdir()
        for i in range(2):
            Image.fromarray(_field(10, 12, 3 * c + i)).save(
                str(d / ("%d.png" % i)))
        np.save(str(d / "x.npy"), _field(8, 8, 9 + c))
        (d / "notes.txt").write_text("skip me")
    with mx.cpu():
        t = tdata.vision.ImageFolderDataset(str(tmp_path))
        got = [t[i] for i in range(len(t))]
    j = jdata.vision.ImageFolderDataset(str(tmp_path))
    assert t.synsets == j.synsets == ["cat", "dog"]
    assert len(got) == len(j) == 6
    for i, (gi, gl) in enumerate(got):
        ji, jl = j[i]
        np.testing.assert_array_equal(gi.asnumpy(), ji.asnumpy())
        assert gl == jl


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _pair(img):
    return (jmx.nd.array(img, dtype=str(img.dtype)),
            mx.nd.array(img, ctx=mx.cpu(), dtype=str(img.dtype)))


@pytest.mark.parametrize("name,args", [
    ("ToTensor", ()), ("Normalize", ((0.5, 0.4, 0.3), (0.2, 0.25, 0.3))),
    ("Cast", ("float16",)), ("CenterCrop", (12,)), ("CenterCrop", ((10, 14),)),
])
def test_deterministic_transforms_within_1e6(name, args):
    img = _field(20, 18, 4)
    if name == "Normalize":
        img = img.transpose(2, 0, 1).astype(np.float32) / 255.0
    j, t = _pair(img)
    want = getattr(JT, name)(*args)(j).asnumpy()
    got = getattr(TT, name)(*args)(t).asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=1e-6,
                               atol=1e-6)


def _within_one_level(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1
    assert (d > 0).mean() <= 0.01, (d > 0).mean()


@pytest.mark.parametrize("size,shape", [(32, (40, 60)), ((50, 70), (40, 60)),
                                        (17, (64, 48)), ((24, 30), (100, 80)),
                                        (33, (33, 35))])
def test_resize_within_one_level_of_the_reference(size, shape):
    """jax.image.resize and F.interpolate(antialias=True) agree to ~5e-5
    in float32; truncating to uint8 then flips a value sitting on an
    integer by one level."""
    img = _field(shape[0], shape[1], 3)
    j, t = _pair(img)
    want = JT.Resize(size)(j).asnumpy()
    got = TT.Resize(size)(t).asnumpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    _within_one_level(got, want)
    j, t = _pair(img.astype(np.float32))
    np.testing.assert_allclose(TT.Resize(size)(t).asnumpy(),
                               JT.Resize(size)(j).asnumpy(), atol=1e-4)


def test_random_resized_crop_within_one_level_of_the_reference():
    img = _field(80, 100, 6)
    j, t = _pair(img)
    for seed in range(6):
        np.random.seed(seed)
        want = JT.RandomResizedCrop(24, scale=(0.2, 1.0))(j).asnumpy()
        np.random.seed(seed)
        got = TT.RandomResizedCrop(24, scale=(0.2, 1.0))(t).asnumpy()
        assert got.shape == want.shape == (24, 24, 3)
        _within_one_level(got, want)


@pytest.mark.parametrize("name,args", [
    ("RandomFlipLeftRight", ()), ("RandomFlipTopBottom", ()),
    ("RandomBrightness", (0.3,)), ("RandomContrast", (0.3,)),
    ("RandomSaturation", (0.3,)), ("RandomLighting", (0.1,)),
])
def test_random_transforms_equal_to_the_reference(name, args):
    img = _field(16, 14, 7)
    j, t = _pair(img)
    for seed in range(4):
        np.random.seed(seed)
        want = getattr(JT, name)(*args)(j).asnumpy()
        np.random.seed(seed)
        got = getattr(TT, name)(*args)(t).asnumpy()
        assert got.dtype == want.dtype
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        # the float math before the uint8 cast rounds apart by 1 at most
        assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_compose_pipeline_equal_to_the_reference():
    img = _field(40, 36, 8)
    j, t = _pair(img)
    jt = JT.Compose([JT.CenterCrop(30), JT.RandomFlipLeftRight(),
                     JT.ToTensor(), JT.Normalize(0.5, 0.25)])
    tt = TT.Compose([TT.CenterCrop(30), TT.RandomFlipLeftRight(),
                     TT.ToTensor(), TT.Normalize(0.5, 0.25)])
    for seed in range(3):
        np.random.seed(seed)
        want = jt(j).asnumpy()
        np.random.seed(seed)
        got = tt(t).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert pickle.loads(pickle.dumps(tt))(t).shape == (3, 30, 30)
