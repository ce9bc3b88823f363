"""mx.image, the native decode team, ImageRecordIter and the ``_image_*``
ops of the PyTorch port against the JAX package on the same inputs.

Both packages decode with cv2 here, and the native route of each is the
libjpeg worker team built from ``src/io/jpeg_decode_pool.cc`` (the JAX
side's as ``tests/test_io.py`` builds it, the port's at first use).  The
card's route (nvJPEG onto the device, then the team's geometry as torch
ops) is held here through its geometry, :func:`augment_decoded`, fed the
team's own full-size decodes; its decoder runs on the card only
(``tests/test_torch_cuda.py``, chip_smoke phase 12)."""

import os
import random
import subprocess

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import image as jimg
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.io import native_decode as tnd

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_native_decode():
    """The JAX package's decode team, built by its own route."""
    from mxnet_tpu.io import native_decode
    if not native_decode.available():
        r = subprocess.run(["make", "-C", os.path.join(REPO, "src", "io")],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]
    assert native_decode.available()
    return native_decode


def _field(h, w, seed):
    """A smooth seeded field plus mild texture (a realistic JPEG)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([(yy * 0.5 + seed * 9) % 256, (xx * 0.4) % 256,
                    ((yy + xx) * 0.3) % 256], -1)
    img += rs.randint(0, 24, img.shape)
    return img.clip(0, 255).astype(np.uint8)


def _jpeg(img, quality=90):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return bytes(buf)


def _png(img):
    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return bytes(buf)


def _rec_file(tmp_path, n=20, big=False, png_at=None):
    prefix = str(tmp_path / "data")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rs = np.random.RandomState(7)
    for i in range(n):
        if big:
            h, w_ = rs.randint(60, 130, 2)
        else:
            h, w_ = 30 + i % 7, 28 + i % 5
        img = _field(int(h), int(w_), i)
        payload = _png(img) if png_at == i else _jpeg(img)
        w.write_idx(i, trec.pack(trec.IRHeader(0, float(i % 4), i, 0),
                                 payload))
    w.close()
    return prefix


# ---------------------------------------------------------------------------
# imdecode, resize, crops, augmenters
# ---------------------------------------------------------------------------

def test_imdecode_and_jpeg_dims_equal_to_the_reference():
    img = _field(37, 53, 1)
    buf = _jpeg(img)
    np.testing.assert_array_equal(timg.imdecode(buf), jimg.imdecode(buf))
    np.testing.assert_array_equal(timg.imdecode(buf, to_rgb=False),
                                  jimg.imdecode(buf, to_rgb=False))
    np.testing.assert_array_equal(timg.imdecode(buf, flag=0),
                                  jimg.imdecode(buf, flag=0))
    big = _jpeg(_field(200, 260, 2))
    np.testing.assert_array_equal(timg.imdecode(big, approx_size=40),
                                  jimg.imdecode(big, approx_size=40))
    from mxnet_tpu.image.image import _jpeg_dims as jdims
    from mxnet_tpu_torch.image.image import _jpeg_dims as tdims
    assert tdims(big) == jdims(big) == (200, 260)
    assert tdims(b"not a jpeg") is None
    with pytest.raises(mx.MXNetError, match="imdecode failed"):
        timg.imdecode(b"\xff\xd8garbage")


@pytest.mark.parametrize("fn,args", [
    ("imresize", (10, 14)), ("imresize", (90, 70, 0)),
    ("resize_short", (20,)), ("resize_short", (50, 1)),
    ("center_crop", ((30, 30),)), ("random_crop", ((20, 24),)),
    ("random_size_crop", ((16, 16), (0.3, 1.0), (0.75, 1.33))),
    ("fixed_crop", (3, 5, 20, 18, (12, 12))),
    ("color_normalize", (np.array([1.0, 2.0, 3.0], np.float32),
                         np.array([2.0, 3.0, 4.0], np.float32))),
])
def test_resize_and_crops_equal_to_the_reference(fn, args):
    img = _field(40, 60, 3)
    random.seed(11)
    want = getattr(jimg, fn)(img, *args)
    random.seed(11)
    got = getattr(timg, fn)(img, *args)
    if isinstance(want, tuple):
        assert got[1] == want[1]
        want, got = want[0], got[0]
    np.testing.assert_array_equal(got, want)
    assert timg.scale_down((40, 60), (50, 50)) == \
        jimg.scale_down((40, 60), (50, 50))


def _augmenters(mod):
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    return {
        "ResizeAug": mod.ResizeAug(30),
        "ForceResizeAug": mod.ForceResizeAug((20, 26)),
        "RandomCropAug": mod.RandomCropAug((24, 20)),
        "RandomSizedCropAug": mod.RandomSizedCropAug(
            (20, 20), (0.08, 1.0), (0.75, 1.33)),
        "CenterCropAug": mod.CenterCropAug((24, 24)),
        "HorizontalFlipAug": mod.HorizontalFlipAug(0.5),
        "BrightnessJitterAug": mod.BrightnessJitterAug(0.3),
        "ContrastJitterAug": mod.ContrastJitterAug(0.3),
        "SaturationJitterAug": mod.SaturationJitterAug(0.3),
        "HueJitterAug": mod.HueJitterAug(0.2),
        "ColorJitterAug": mod.ColorJitterAug(0.2, 0.2, 0.2),
        "LightingAug": mod.LightingAug(0.1, eigval, eigvec),
        "ColorNormalizeAug": mod.ColorNormalizeAug(
            np.array([1.0, 2.0, 3.0]), np.array([2.0, 2.5, 3.0])),
        "RandomGrayAug": mod.RandomGrayAug(0.5),
        "CastAug": mod.CastAug(),
        "SequentialAug": mod.SequentialAug(
            [mod.ResizeAug(28), mod.CastAug()]),
    }


@pytest.mark.parametrize("name", sorted(_augmenters(jimg)))
def test_every_augmenter_equal_to_the_reference(name):
    img = _field(40, 50, 5)
    jaug, taug = _augmenters(jimg)[name], _augmenters(timg)[name]
    for seed in range(4):
        random.seed(seed)
        np.random.seed(seed)
        want = jaug(img)
        random.seed(seed)
        np.random.seed(seed)
        got = taug(img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert taug.dumps() == jaug.dumps()


@pytest.mark.parametrize("kw", [
    dict(resize=30, rand_crop=True, rand_mirror=True, brightness=0.1,
         contrast=0.1, saturation=0.1, hue=0.1, pca_noise=0.05,
         rand_gray=0.1, mean=True, std=True),
    dict(rand_crop=True, rand_resize=True),
    dict(),
])
def test_create_augmenter_chain_equal_to_the_reference(kw):
    jaugs = jimg.CreateAugmenter((3, 24, 24), **kw)
    taugs = timg.CreateAugmenter((3, 24, 24), **kw)
    assert [a.dumps() for a in taugs] == [a.dumps() for a in jaugs]
    img = _field(40, 50, 6)
    random.seed(2)
    np.random.seed(2)
    want = img
    for a in jaugs:
        want = a(want)
    random.seed(2)
    np.random.seed(2)
    got = img
    for a in taugs:
        got = a(got)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the native decode team
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(resize=0), dict(resize=0, rand_crop=True, rand_mirror=True),
    dict(resize=48, rand_crop=True), dict(resize=100, rand_mirror=True),
])
def test_native_pool_equal_to_the_reference(cfg):
    jnd = _jax_native_decode()
    bufs = [_jpeg(_field(40 + 29 * i, 52 + 11 * i, i)) for i in range(8)]
    bufs.append(b"\xff\xd8 not a jpeg")
    np.random.seed(3)
    want, wok = jnd.NativeDecodePool(3, (32, 40), **cfg).decode_batch(bufs)
    np.random.seed(3)
    got, gok = tnd.NativeDecodePool(3, (32, 40), **cfg).decode_batch(bufs)
    np.testing.assert_array_equal(gok, wok)
    assert not gok[-1] and gok[:-1].all()
    np.testing.assert_array_equal(got[:-1], want[:-1])


def _full_decode(buf):
    h, w = timg.image._jpeg_dims(buf)
    out, ok = tnd.NativeDecodePool(1, (h, w)).decode_batch([buf])
    assert ok.all()
    return torch.from_numpy(out[0])


@pytest.mark.parametrize("cfg", [
    dict(resize=0), dict(resize=0, rand_crop=True, rand_mirror=True),
    dict(resize=36, rand_crop=True, rand_mirror=True),
    dict(resize=70), dict(resize=20),
])
def test_device_route_geometry_equal_to_the_team(cfg):
    """The nvJPEG route's geometry on the team's own full-size decodes:
    bit-equal where the team decodes at full scale; where it decodes at
    1/2 or 1/4 (libjpeg's scaled IDCT) the route's rounded area average
    stands in, within mean |d| < 1 (the crops fall in the same place)."""
    sizes = [(30, 26), (41, 44), (90, 75), (130, 170), (64, 200),
             (160, 150)]
    bufs = [_jpeg(_field(h, w, i)) for i, (h, w) in enumerate(sizes)]
    oh, ow = 24, 20
    np.random.seed(9)
    team, ok = tnd.NativeDecodePool(2, (oh, ow), **cfg).decode_batch(bufs)
    assert ok.all()
    np.random.seed(9)
    seeds = tnd.draw_seeds(len(bufs))
    scaled = 0
    for i, (buf, (h, w)) in enumerate(zip(bufs, sizes)):
        got = tnd.augment_decoded(
            _full_decode(buf), seeds[i], cfg.get("resize", 0), oh, ow,
            cfg.get("rand_crop", False), cfg.get("rand_mirror", False))
        assert got.dtype == torch.uint8 and tuple(got.shape) == (oh, ow, 3)
        d = np.abs(got.numpy().astype(int) - team[i].astype(int))
        if tnd._scale_denom(h, w, cfg.get("resize", 0), oh, ow) == 1:
            assert d.max() == 0, (i, d.max())
        else:
            scaled += 1
            assert d.mean() < 1.0, (i, d.mean())
    assert scaled >= (1 if cfg.get("resize") != 70 else 0)


def test_nvjpeg_pool_needs_a_cuda_device():
    with pytest.raises(mx.MXNetError, match="CUDA device"):
        tnd.NvjpegDecodePool(2, (8, 8), device=torch.device("cpu"))


# ---------------------------------------------------------------------------
# ImageRecordIter
# ---------------------------------------------------------------------------

def _record_iter(pkg, prefix, native, **kw):
    os.environ["MXNET_TPU_NATIVE_DECODE"] = native
    try:
        # the chain draws its crops from Python's global stream on its
        # decode threads: one thread keeps the order of the draws fixed
        args = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
                    data_shape=(3, 24, 24), batch_size=8,
                    preprocess_threads=2 if native == "1" else 1)
        args.update(kw)
        if pkg is mx:
            with mx.cpu():
                return mx.io.ImageRecordIter(**args)
        return jmx.io.ImageRecordIter(**args)
    finally:
        del os.environ["MXNET_TPU_NATIVE_DECODE"]


def _epoch(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("kw", [
    dict(shuffle=True, rand_crop=True, rand_mirror=True,
         mean_r=123.68, mean_g=116.28, mean_b=103.53),
    dict(resize=32, std_r=58.4, std_g=57.1, std_b=57.4),
])
def test_image_record_iter_equal_to_the_reference(tmp_path, native, kw):
    _jax_native_decode()
    prefix = _rec_file(tmp_path)
    epochs = {}
    for pkg in (jmx, mx):
        random.seed(5)
        np.random.seed(5)
        it = _record_iter(pkg, prefix, native, **kw)
        epochs[pkg] = _epoch(it) + (it.reset() or _epoch(it))
        it.close() if hasattr(it, "close") else None
        if pkg is mx:
            inner = it.iters[0]
            route = "native" if native == "1" else "chain"
            assert inner.routes[route] == 6 and sum(
                inner.routes.values()) == 6
            assert inner.native_route == ("libjpeg" if native == "1"
                                          else None)
    assert len(epochs[mx]) == len(epochs[jmx]) == 6
    for (gd, gl, gp), (wd, wl, wp) in zip(epochs[mx], epochs[jmx]):
        assert gd.dtype == np.float32 and gd.shape == (8, 3, 24, 24)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


def test_image_record_iter_batches_lie_on_the_callers_context(tmp_path):
    prefix = _rec_file(tmp_path, n=8)
    it = _record_iter(mx, prefix, "1")
    b = it.next()
    assert b.data[0].context == mx.cpu() and b.label[0].context == mx.cpu()
    it.close()
    os.environ["MXNET_TPU_NATIVE_DECODE"] = "1"
    try:
        with pytest.raises(mx.MXNetError, match="CUDA"):
            mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                  data_shape=(3, 8, 8), batch_size=2)
    finally:
        del os.environ["MXNET_TPU_NATIVE_DECODE"]


def test_non_jpeg_record_takes_the_chain_for_its_batch(tmp_path):
    prefix = _rec_file(tmp_path, n=16, png_at=11)
    it = _record_iter(mx, prefix, "1")
    assert len(_epoch(it)) == 2
    assert it.iters[0].routes == {"native": 1, "chain": 1}
    it.close()


def test_native_route_against_the_chain(tmp_path):
    """The team (libjpeg's scaled decode, plain upsampling, its own
    bilinear) against cv2's chain: the reference's limit, mean |d| < 8
    on the 0-255 scale."""
    prefix = _rec_file(tmp_path, n=16, big=True)
    got = {}
    for native in ("1", "0"):
        it = _record_iter(mx, prefix, native, resize=40,
                          data_shape=(3, 32, 32))
        got[native] = np.concatenate([d for d, _, _ in _epoch(it)])
        it.close()
    assert np.abs(got["1"] - got["0"]).mean() < 8.0


def test_image_iter_imglist_equal_to_the_reference(tmp_path):
    paths = []
    for i in range(6):
        p = tmp_path / ("img%d.jpg" % i)
        with open(p, "wb") as f:
            f.write(_jpeg(_field(30, 34, i)))
        paths.append(([float(i % 2)], str(p)))
    random.seed(1)
    want = next(jimg.ImageIter(batch_size=3, data_shape=(3, 24, 24),
                               imglist=paths, path_root=""))
    random.seed(1)
    got = next(timg.ImageIter(batch_size=3, data_shape=(3, 24, 24),
                              imglist=paths, path_root=""))
    np.testing.assert_array_equal(got.data[0].asnumpy(),
                                  want.data[0].asnumpy())
    np.testing.assert_array_equal(got.label[0].asnumpy(),
                                  want.label[0].asnumpy())
    assert got.data[0].context == mx.cpu()


# ---------------------------------------------------------------------------
# the _image_* ops
# ---------------------------------------------------------------------------

def _img_input(shape, seed=0, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return rs.uniform(0, 1, shape).astype(dtype)


@pytest.mark.parametrize("name,shape,params", [
    ("to_tensor", (6, 5, 3), {}), ("to_tensor", (2, 6, 5, 3), {}),
    ("normalize", (3, 6, 5), dict(mean=(0.5, 0.4, 0.3),
                                  std=(0.2, 0.3, 0.25))),
    ("normalize", (2, 3, 6, 5), dict(mean=(0.1, 0.2, 0.3),
                                     std=(1.0, 2.0, 3.0))),
    ("flip_left_right", (3, 6, 5), {}), ("flip_top_bottom", (2, 3, 6, 5), {}),
])
def test_deterministic_image_ops_match_the_reference(name, shape, params):
    x = _img_input(shape)
    if name == "to_tensor":
        x = (x * 255).astype(np.uint8)
    want = getattr(jmx.nd.image, name)(jmx.nd.array(x, dtype=x.dtype),
                                       **params).asnumpy()
    got = getattr(mx.nd.image, name)(mx.nd.array(x, ctx=mx.cpu(),
                                                 dtype=str(x.dtype)),
                                     **params).asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_image_op_registry_contracts_match_the_reference():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    jnames = sorted(n for n in jreg.list_ops() if "image" in n or n in (
        "to_tensor", "flip_left_right", "flip_top_bottom",
        "random_flip_left_right", "random_flip_top_bottom",
        "random_brightness", "random_contrast", "random_saturation"))
    tnames = sorted(n for n in treg.list_ops() if "image" in n or n in (
        "to_tensor", "flip_left_right", "flip_top_bottom",
        "random_flip_left_right", "random_flip_top_bottom",
        "random_brightness", "random_contrast", "random_saturation"))
    assert tnames == jnames and len([n for n in tnames
                                     if n.startswith("_image_")]) == 9
    for n in jnames:
        j, t = jreg.get_op(n), treg.get_op(n)
        assert t.param_names == j.param_names, n
        assert t.input_names == j.input_names, n
        assert t.needs_rng == j.needs_rng, n
    assert sorted(n for n in dir(mx.nd.image) if not n.startswith("_")) == \
        sorted(n for n in dir(jmx.nd.image) if not n.startswith("_"))
    assert sorted(n for n in dir(mx.sym.image) if not n.startswith("_")) == \
        sorted(n for n in dir(jmx.sym.image) if not n.startswith("_"))


@pytest.mark.parametrize("name", ["random_flip_left_right",
                                  "random_flip_top_bottom"])
def test_random_flips_flip_whole_or_not_at_rate_p(name):
    x = _img_input((3, 5, 4), 1)
    axis = -1 if name.endswith("left_right") else -2
    flipped = np.flip(x, axis)
    mx.random.seed(0)
    n_flip = 0
    draws = 400
    for _ in range(draws):
        y = getattr(mx.nd.image, name)(mx.nd.array(x, ctx=mx.cpu()),
                                       p=0.3).asnumpy()
        if np.array_equal(y, flipped):
            n_flip += 1
        else:
            np.testing.assert_array_equal(y, x)
    se = np.sqrt(0.3 * 0.7 / draws)
    assert abs(n_flip / draws - 0.3) < 4 * se


@pytest.mark.parametrize("name", ["random_brightness", "random_contrast",
                                  "random_saturation"])
def test_random_color_ops_by_structure_and_moments(name):
    """Each draw is the reference's formula at some alpha; the alphas are
    uniform on [min_factor, max_factor] (mean and variance within 4
    standard errors)."""
    x = _img_input((2, 3, 4, 5), 2)
    coef = np.array([0.299, 0.587, 0.114], np.float32)
    gray_c = np.tensordot(coef, np.moveaxis(x, 1, 0), axes=1)
    lo, hi = 0.6, 1.8
    mx.random.seed(1)
    alphas = []
    for _ in range(300):
        y = getattr(mx.nd.image, name)(mx.nd.array(x, ctx=mx.cpu()),
                                       min_factor=lo,
                                       max_factor=hi).asnumpy()
        if name == "random_brightness":
            a = float(y.sum() / x.sum())
            want = x * np.float32(a)
        elif name == "random_contrast":
            gray = gray_c.mean()
            a = float(((y - gray) * (x - gray)).sum() /
                      ((x - gray) ** 2).sum())
            want = x * a + gray * (1 - a)
        else:
            gray = np.expand_dims(gray_c, 1)
            a = float(((y - gray) * (x - gray)).sum() /
                      ((x - gray) ** 2).sum())
            want = x * a + gray * (1 - a)
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
        assert lo <= a <= hi
        alphas.append(a)
    alphas = np.asarray(alphas)
    mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
    n = len(alphas)
    assert abs(alphas.mean() - mean) < 4 * np.sqrt(var / n)
    assert abs(alphas.var() - var) < 4 * np.sqrt(
        ((hi - lo) ** 4 / 80 - var ** 2) / n)
