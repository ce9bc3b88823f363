"""The detection augmenters and ImageDetIter of the PyTorch port against
the JAX package's (``mxnet_tpu/image/detection.py``), on the same images
and under the same Python ``random`` seed: the cases of
``tests/test_spatial_ops.py``'s ``test_det_*`` and
``test_image_det_iter_end_to_end``, each with both packages, and the
outputs equal (images and labels bit for bit on the CPU route).

The card's route (nvJPEG, the augmenters on device tensors) cannot run
here; its augmenters take CPU tensors the same way, so they are held to
the numpy route here: labels equal, pixels within the resampler's
difference (torch's bicubic against cv2's)."""

import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.image import detection as jdet

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.image import detection as tdet

RS = np.random.RandomState


def _toy_label():
    return np.array([[1, 0.25, 0.25, 0.75, 0.75], [-1, 0, 0, 0, 0]],
                    np.float32)


def _both(make, img, label, seed):
    """(JAX output, port output) of the augmenter *make(module)* on the
    same inputs under the same random seed."""
    outs = []
    for mod in (jdet, tdet):
        random.seed(seed)
        out, lab = make(mod)(img.copy(), label.copy())
        outs.append((np.asarray(out), lab))
    return outs


def _equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_det_horizontal_flip():
    img = np.arange(2 * 4 * 3, dtype=np.uint8).reshape(2, 4, 3)
    label = np.array([[0, 0.1, 0.2, 0.4, 0.8], [-1, 0, 0, 0, 0]],
                     np.float32)
    j, t = _both(lambda m: m.DetHorizontalFlipAug(p=1.0), img, label, 0)
    _equal(j, t)
    np.testing.assert_allclose(t[1][0, [1, 3]], [0.6, 0.9], rtol=1e-6)
    np.testing.assert_array_equal(t[1][1], label[1])


@pytest.mark.parametrize("seed", range(6))
def test_det_random_crop(seed):
    img = RS(10).randint(0, 255, (32, 40, 3)).astype(np.uint8)
    j, t = _both(lambda m: m.DetRandomCropAug(min_object_covered=0.5,
                                              max_attempts=50),
                 img, _toy_label(), seed)
    _equal(j, t)
    kept = t[1][t[1][:, 0] >= 0]
    assert (kept[:, 1:] >= 0).all() and (kept[:, 1:] <= 1).all()


@pytest.mark.parametrize("seed", range(4))
def test_det_random_pad(seed):
    img = RS(11).randint(0, 255, (16, 20, 3)).astype(np.uint8)
    j, t = _both(lambda m: m.DetRandomPadAug(area_range=(1.5, 2.5),
                                             aspect_ratio_range=(0.8, 1.2)),
                 img, _toy_label(), seed)
    _equal(j, t)
    assert t[0].shape[0] > 16 or t[0].shape[1] > 20


def test_det_random_select_and_borrow():
    img = RS(12).randint(0, 255, (12, 12, 3)).astype(np.uint8)

    def make(m):
        inner = m.DetRandomSelectAug([m.DetHorizontalFlipAug(1.0)],
                                     skip_prob=0.5)
        return lambda s, lab: inner(*m.DetBorrowAug(
            (jmx if m is jdet else tmx).image.ColorNormalizeAug(
                np.array([1.0, 2.0, 3.0]), np.array([2.0, 2.0, 2.0])))(
            s, lab))
    for seed in range(4):
        _equal(*_both(make, img, _toy_label(), seed))


def _aug_args():
    return dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
                std=True)


@pytest.mark.parametrize("seed", range(5))
def test_create_det_augmenter_chain(seed):
    img = RS(seed).randint(0, 255, (60, 80, 3)).astype(np.uint8)
    label = np.array([[2, 0.1, 0.2, 0.5, 0.6], [0, 0.4, 0.3, 0.9, 0.95],
                      [-1, 0, 0, 0, 0]], np.float32)
    outs = []
    for m in (jmx, tmx):
        augs = m.image.CreateDetAugmenter((3, 32, 32), **_aug_args())
        random.seed(seed)
        x, lab = img, label.copy()
        for a in augs:
            x, lab = a(x, lab)
        outs.append((np.asarray(x), lab))
    assert [type(a).__name__ for a in jmx.image.CreateDetAugmenter(
        (3, 32, 32), **_aug_args())] == [type(a).__name__ for a in
                                          tmx.image.CreateDetAugmenter(
                                              (3, 32, 32), **_aug_args())]
    _equal(*outs)
    assert outs[1][0].shape == (32, 32, 3) and outs[1][0].dtype == np.float32


@pytest.mark.parametrize("seed", range(5))
def test_tensor_route_keeps_labels_and_pixels(seed):
    """The augmenters on an (h, w, 3) uint8 tensor, as the card's route
    runs them: the same labels as on the numpy route, the pixels within
    the two bicubic resamplers' difference."""
    img = RS(seed + 20).randint(0, 255, (70, 90, 3)).astype(np.uint8)
    img[20:50, 30:70] = (200, 40, 90)
    label = np.array([[1, 30 / 90, 20 / 70, 70 / 90, 50 / 70],
                      [-1, 0, 0, 0, 0]], np.float32)
    outs = []
    for src in (img, torch.from_numpy(img)):
        augs = tmx.image.CreateDetAugmenter((3, 40, 40), **_aug_args())
        random.seed(seed)
        x, lab = src, label.copy()
        for a in augs:
            x, lab = a(x, lab)
        outs.append((np.asarray(x), lab))
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    levels = np.abs(outs[1][0] - outs[0][0]) * 57.0
    assert outs[1][0].shape == outs[0][0].shape == (40, 40, 3)
    assert levels.mean() < 1.0, levels.mean()


def test_tensor_route_refuses_host_only_jitter():
    aug = tdet.DetBorrowAug(tmx.image.BrightnessJitterAug(0.3))
    with pytest.raises(MXNetError, match="host images only"):
        aug(torch.zeros((4, 4, 3), dtype=torch.uint8), _toy_label())


def _write_images(tmp_path, n, shape=(24, 30, 3)):
    import cv2
    rs = RS(12)
    items = []
    for i in range(n):
        img = rs.randint(0, 255, shape).astype(np.uint8)
        p = str(tmp_path / ("img%d.jpg" % i))
        cv2.imwrite(p, img)
        lab = []
        for j in range(1 + i % 2):
            lab += [j, 0.1, 0.1, 0.6, 0.7]
        items.append((np.array(lab, np.float32), p))
    return items


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def test_image_det_iter_end_to_end(tmp_path):
    items = _write_images(tmp_path, 4)
    jit = jdet.ImageDetIter(batch_size=2, data_shape=(3, 16, 16),
                            imglist=items, path_root="")
    with tmx.cpu():
        tit = tdet.ImageDetIter(batch_size=2, data_shape=(3, 16, 16),
                                imglist=items, path_root="")
    assert tit._max_objects == jit._max_objects == 2
    assert tit.provide_label[0].shape == (2, 2, 5)
    jb, tb = _batches(jit), _batches(tit)
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert a[2] == b[2]
    valid = tb[0][1][tb[0][1][:, :, 0] >= 0]
    assert (valid[:, 1:] >= 0).all() and (valid[:, 1:] <= 1).all()


@pytest.mark.parametrize("header", [False, True])
def test_image_det_iter_records_with_augmenters(tmp_path, header):
    """Records written once, read by both packages' ImageDetIter with
    shuffle and the SSD augmenters under one seed: every batch equal,
    the last one padded."""
    from mxnet_tpu import recordio as jrec
    rs = RS(3)
    prefix = str(tmp_path / "det")
    rec = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(7):
        img = rs.randint(0, 255, (rs.randint(30, 50), rs.randint(30, 50),
                                  3)).astype(np.uint8)
        k = 1 + i % 3
        objs = np.concatenate([rs.randint(0, 5, (k, 1)),
                               np.sort(rs.uniform(0, 1, (k, 2)), 1)[:, [0]],
                               np.sort(rs.uniform(0, 1, (k, 2)), 1)[:, [0]],
                               np.sort(rs.uniform(0, 1, (k, 2)), 1)[:, [1]],
                               np.sort(rs.uniform(0, 1, (k, 2)), 1)[:, [1]]],
                              1).astype(np.float32)
        lab = objs.ravel()
        if header:
            lab = np.concatenate([[2, 5], lab]).astype(np.float32)
        rec.write_idx(i, jrec.pack_img(jrec.IRHeader(0, lab, i, 0), img,
                                       quality=90))
    rec.close()
    outs = []
    for m, ctx in ((jmx, None), (tmx, tmx.cpu())):
        random.seed(5)
        augs = m.image.CreateDetAugmenter((3, 24, 24), **_aug_args())
        kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
                  shuffle=True, aug_list=augs)
        if ctx is None:
            it = m.image.ImageDetIter(3, (3, 24, 24), **kw)
        else:
            with ctx:
                it = m.image.ImageDetIter(3, (3, 24, 24), **kw)
        outs.append((it._max_objects, _batches(it)))
    assert outs[0][0] == outs[1][0] == 3
    assert len(outs[0][1]) == len(outs[1][1]) == 3
    for a, b in zip(*(o[1] for o in outs)):
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert a[2] == b[2]
    assert outs[1][1][-1][2] == 2


@pytest.mark.parametrize("raw", [[1, 0.1, 0.2, 0.3, 0.4, 2, 0.5, 0.5, 0.9,
                                  0.9],
                                 [2, 6, 3, 0.1, 0.1, 0.4, 0.4, 7],
                                 [4, 5, 9, 9, 1, 0.1, 0.1, 0.5, 0.5]])
def test_parse_label_forms(raw):
    want = jdet.ImageDetIter._parse_label(raw)
    np.testing.assert_array_equal(tdet.ImageDetIter._parse_label(raw), want)


def test_parse_label_rejects_what_the_reference_rejects():
    for mod, err in ((jdet, jmx.base.MXNetError), (tdet, MXNetError)):
        with pytest.raises(err):
            mod.ImageDetIter._parse_label([1, 2, 3])


def test_image_det_iter_raises_without_cuda_unless_on_the_cpu(tmp_path):
    """Like every entry point of the port, the iterator takes the current
    context, the card by default: without CUDA it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    items = _write_images(tmp_path, 2)
    with pytest.raises(MXNetError):
        tdet.ImageDetIter(batch_size=2, data_shape=(3, 16, 16),
                          imglist=items)
