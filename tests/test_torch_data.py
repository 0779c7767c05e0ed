"""gqx_torch's data package against gqx's, bit for bit.

Every transform from the same ``np.random.default_rng`` seed, every reader
on the same fixture (files written to ``tmp_path`` in each standard
layout, as tests/test_data.py writes them), and the Pipeline over one
epoch with the numpy augment in both packages (``native=False``; the C++
augment, which is not bit-equal to it, is held to gqx's in
tests/test_torch_native.py).  Tolerance: none, the arrays are compared
with ``assert_array_equal`` and dtypes must match.
"""

import gzip
import importlib.util
import pickle
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import gqx.data.datasets as gqx_datasets
import gqx.data.transforms as gqx_tf
import gqx_torch.data.datasets as port_datasets
import gqx_torch.data.transforms as port_tf
from gqx.config import GQConfig as GqxConfig
from gqx.data import Pipeline as GqxPipeline
from gqx_torch.config import GQConfig
from gqx_torch.data import Pipeline

N_TRAIN, N_TEST = 12, 6


@pytest.fixture(autouse=True)
def few_threads():
    """The suite runs in several worker processes on one host, and torch's
    default of a thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _images(shape, seed=5):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.uint8)


@pytest.mark.parametrize("dataset", sorted(gqx_tf.STATS))
def test_normalize_and_augment_match_gqx(dataset):
    channels = len(gqx_tf.STATS[dataset][0])
    side = 64 if dataset == "tinyimg" else 32
    x = _images((6, side, side, channels))
    _same(port_tf.normalize(x, dataset), gqx_tf.normalize(x, dataset))
    _same(port_tf.augment_batch(x, dataset, np.random.default_rng(11)),
          gqx_tf.augment_batch(x, dataset, np.random.default_rng(11)))


def test_tables_match_gqx():
    assert port_tf.STATS == gqx_tf.STATS
    assert port_tf.AUGMENT == gqx_tf.AUGMENT
    assert port_tf.TINYIMG_SIZE == gqx_tf.TINYIMG_SIZE
    assert set(port_datasets.LOADERS) == set(gqx_datasets.LOADERS)


@pytest.mark.parametrize("padding,flip", [(0, False), (4, False), (0, True), (4, True)])
def test_random_crop_flip_matches_gqx(padding, flip):
    x = _images((9, 32, 32, 3))
    _same(port_tf.random_crop_flip(x, np.random.default_rng(3), padding, flip),
          gqx_tf.random_crop_flip(x, np.random.default_rng(3), padding, flip))


@pytest.mark.parametrize("shape,out", [((5, 64, 64, 3), 224), ((4, 40, 70, 3), 96),
                                       ((3, 90, 30, 1), 64)])
def test_random_resized_crop_matches_gqx(shape, out):
    # 40x70 and 90x30 fall outside the ratio bounds in some attempts and
    # exercise the clamped center-crop fallback
    x = _images(shape)
    _same(port_tf.random_resized_crop(x, np.random.default_rng(7), out),
          gqx_tf.random_resized_crop(x, np.random.default_rng(7), out))


@pytest.mark.parametrize("shape,resize,crop", [((2, 64, 64, 3), 256, 224),
                                               ((3, 50, 80, 3), 72, 64)])
def test_resize_center_crop_matches_gqx(shape, resize, crop):
    x = _images(shape)
    _same(port_tf.resize_center_crop(x, resize, crop), gqx_tf.resize_center_crop(x, resize, crop))


def test_bilinear_crop_resize_matches_gqx():
    x = _images((4, 20, 24, 3))
    rng = np.random.default_rng(2)
    top, left = rng.integers(0, 8, 4), rng.integers(0, 8, 4)
    h, w = rng.integers(4, 12, 4), rng.integers(4, 14, 4)
    _same(port_tf._bilinear_crop_resize(x, top, left, h, w, 17, 13),
          gqx_tf._bilinear_crop_resize(x, top, left, h, w, 17, 13))


# ---------------------------------------------------------------------------
# readers, on fixtures in each standard layout
# ---------------------------------------------------------------------------

def _write_idx(path, arr, compress=False):
    """IDX format: >u4 magic (0x0000_08_nd), >u4 per dim, raw uint8 payload."""
    magic = struct.pack(">I", 0x00000800 | arr.ndim)
    dims = b"".join(struct.pack(">I", d) for d in arr.shape)
    opener = gzip.open if compress else open
    with opener(str(path) + (".gz" if compress else ""), "wb") as f:
        f.write(magic + dims + arr.astype(np.uint8).tobytes())


def _mnist(root, rng):
    d = root / "MNIST" / "raw"
    d.mkdir(parents=True)
    for prefix, n, gz in (("train", N_TRAIN, False), ("t10k", N_TEST, True)):
        _write_idx(d / f"{prefix}-images-idx3-ubyte", rng.integers(0, 256, (n, 28, 28)), gz)
        _write_idx(d / f"{prefix}-labels-idx1-ubyte", np.arange(n) % 10, gz)


def _cifar10(root, rng):
    d = root / "cifar-10-batches-py"
    d.mkdir()
    for i in range(1, 6):
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (N_TRAIN // 2, 3072)).astype(np.uint8),
                         "labels": [int(v) for v in rng.integers(0, 10, N_TRAIN // 2)]}, f)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({"data": rng.integers(0, 256, (N_TEST, 3072)).astype(np.uint8),
                     "labels": [int(v) for v in rng.integers(0, 10, N_TEST)]}, f)


def _cifar100(root, rng):
    d = root / "cifar-100-python"
    d.mkdir()
    for name, n in (("train", N_TRAIN), ("test", N_TEST)):
        with open(d / name, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072)).astype(np.uint8),
                         "fine_labels": [int(v) for v in rng.integers(0, 100, n)]}, f)


def _svhn(root, rng):
    from scipy import io as sio

    for name, n in (("train", N_TRAIN), ("test", N_TEST)):
        sio.savemat(root / f"{name}_32x32.mat",
                    {"X": rng.integers(0, 256, (32, 32, 3, n)).astype(np.uint8),
                     "y": ((np.arange(n) + 3) % 10 + 1).astype(np.uint8)[:, None]})


def _stl10(root, rng):
    d = root / "stl10_binary"
    d.mkdir()
    for name, n in (("train", N_TRAIN), ("test", N_TEST)):
        rng.integers(0, 256, (n, 3, 96, 96)).astype(np.uint8).tofile(d / f"{name}_X.bin")
        (np.arange(n) % 10 + 1).astype(np.uint8).tofile(d / f"{name}_y.bin")


def _tinyimg(root, rng):
    for split, count in (("train", 3), ("val", 2)):
        for cls in ("n001", "n002"):
            d = root / "tinyimgnet" / split / cls
            d.mkdir(parents=True)
            for i in range(count):
                Image.fromarray(rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)).save(
                    d / f"img_{i}.jpg")


FIXTURES = {"mnist": _mnist, "cifar10": _cifar10, "cifar100": _cifar100, "svhn": _svhn,
            "stl10": _stl10, "tinyimg": _tinyimg}
SYNTHETIC = dict(num_train=96, num_test=40, image_shape=(16, 16, 3))


def _load_both(name, root, **kw):
    return (port_datasets.load_dataset(name, str(root), **kw),
            gqx_datasets.load_dataset(name, str(root), **kw))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reader_matches_gqx(name, tmp_path):
    FIXTURES[name](tmp_path, np.random.default_rng(0))
    port, ref = _load_both(name, tmp_path)
    _same(port, ref)
    assert port[0][1].dtype == np.int64


@pytest.mark.parametrize("kw", [{}, SYNTHETIC])
def test_synthetic_reader_matches_gqx(kw):
    port, ref = _load_both("synthetic", "", **kw)
    _same(port, ref)


@pytest.mark.parametrize("name,kw", [("digits", {}), ("digits", {"fold": (5, 2)}),
                                     ("digits32", {})])
def test_digits_reader_matches_gqx(name, kw):
    if importlib.util.find_spec("sklearn") is None:
        pytest.skip("scikit-learn is not installed")
    port, ref = _load_both(name, "", **kw)
    _same(port, ref)


def test_unknown_dataset_raises():
    with pytest.raises(ValueError):
        port_datasets.load_dataset("nosuch", "")


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["synthetic", "cifar10", "mnist", "tinyimg"])
def test_pipeline_matches_gqx_over_an_epoch(name, tmp_path):
    kw = dict(dataset=name, num_users=2, batch_size=2, test_batch_size=4, seed=3,
              data_dir=str(tmp_path))
    if name == "synthetic":
        kw.update(batch_size=8, test_batch_size=16)
        kw["dataset_kwargs"] = SYNTHETIC
    else:
        FIXTURES[name](tmp_path, np.random.default_rng(0))
    port = Pipeline(GQConfig(**kw), native=False)
    ref = GqxPipeline(GqxConfig(**kw), native=False)
    assert port.augment == "numpy"
    assert port.image_shape == ref.image_shape
    assert port.steps_per_epoch == ref.steps_per_epoch > 0
    for epoch in (1, 2):
        got, want = list(port.train_epoch(epoch)), list(ref.train_epoch(epoch))
        assert len(got) == len(want) == ref.steps_per_epoch
        for a, b in zip(got, want):
            _same(a, b)
            assert a[0].shape == (2, kw["batch_size"]) + ref.image_shape
            assert a[1].dtype == np.int32
    for limit in (None, 0, 1):
        got, want = list(port.test_batches(limit)), list(ref.test_batches(limit))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
