"""gqx_torch's native (C++) data library against gqx's, bit for bit.

The port builds its own copy of gqx's source (``gqx_torch/csrc/
gqx_native.cc``, g++ with gqx's flags) into ``gqx_torch/_build/``; gqx
builds ``native/libgqx_native.so``.  The same images and the same
``np.random.Generator`` state give the same float32 bits in both, and the
port's ``Pipeline`` at its default takes that augment, as gqx's does.
"""

import pickle

import numpy as np
import pytest
import torch

import gqx.data.native as gqx_native
import gqx_torch.data as data
import gqx_torch.data.native as native
from gqx.config import GQConfig as GqxConfig
from gqx.data import Pipeline as GqxPipeline
from gqx_torch.config import GQConfig
from gqx_torch.data import Pipeline
from gqx_torch.data.transforms import normalize
from gqx_torch.ops import pack as torch_pack


@pytest.fixture(autouse=True)
def both_libraries(monkeypatch):
    """Both libraries loaded (a worker that read gqx's library while another
    built it tries again)."""
    if not gqx_native.available():
        monkeypatch.setattr(gqx_native, "_tried", False)
    assert gqx_native.available() and native.available()


def _images(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.uint8)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dataset,shape", [("cifar10", (33, 32, 32, 3)),
                                           ("stl10", (4, 96, 96, 3)),
                                           ("mnist", (9, 28, 28, 1)),
                                           ("synthetic", (8, 16, 16, 3))])
def test_augment_and_normalize_match_gqx(dataset, shape):
    x = _images(shape, len(dataset))
    got = native.augment_batch(x, dataset, np.random.default_rng(7))
    _bits_equal(got, gqx_native.augment_batch(x, dataset, np.random.default_rng(7)))
    _bits_equal(native.normalize_batch(x, dataset), gqx_native.normalize_batch(x, dataset))
    # a dataset without crop or flip is normalize, to float32 rounding
    if dataset in ("mnist", "synthetic"):
        np.testing.assert_allclose(got, normalize(x, dataset), rtol=1e-5, atol=1e-6)


def test_augment_draws_its_seed_as_gqx():
    """One draw from the generator a batch, as gqx's: the generators stay
    in step over several batches."""
    x = _images((16, 32, 32, 3), 1)
    r_port, r_gqx = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        _bits_equal(native.augment_batch(x, "cifar10", r_port),
                    gqx_native.augment_batch(x, "cifar10", r_gqx))
    assert r_port.integers(0, 2 ** 31) == r_gqx.integers(0, 2 ** 31)


@pytest.mark.parametrize("bits", list(range(1, 33)))
def test_pack_bits_matches_gqx_and_the_torch_packer(bits):
    """Every width 1-32: the words gqx's library packs, and those of
    ``gqx_torch.ops.pack`` (int32 bit patterns of the same words); the
    unpack gives the values back."""
    rng = np.random.default_rng(bits)
    n = 777
    vals = rng.integers(0, 2 ** bits, size=n, dtype=np.uint64).astype(np.uint32)
    words = native.pack_bits(vals, bits)
    _bits_equal(words, gqx_native.pack_bits(vals, bits))
    _bits_equal(native.unpack_bits(words, bits, n), vals)
    _bits_equal(native.unpack_bits(words, bits, n), gqx_native.unpack_bits(words, bits, n))
    t = torch_pack.pack_bits(torch.from_numpy(vals.astype(np.int64)), bits)
    _bits_equal(t.numpy().view(np.uint32), words)
    back = torch_pack.unpack_bits(torch.from_numpy(words.view(np.int32)), bits, n)
    _bits_equal(back.numpy().astype(np.uint32), vals)


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        native.augment_batch(np.zeros((2, 8, 8, 3), np.float32), "cifar10",
                             np.random.default_rng(0))
    with pytest.raises(ValueError):
        native.augment_batch(np.zeros((2, 8, 8, 9), np.uint8), "cifar10",
                             np.random.default_rng(0))
    with pytest.raises(ValueError):
        native.pack_bits(np.zeros(4, np.uint32), 33)
    with pytest.raises(ValueError):
        native.unpack_bits(np.zeros(1, np.uint32), 8, 5)
    assert native.num_threads() >= 1


def _write_cifar10(root, rng, n_train=40, n_test=12):
    d = root / "cifar-10-batches-py"
    d.mkdir()
    for i in range(1, 6):
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n_train // 5, 3072)).astype(np.uint8),
                         "labels": [int(v) for v in rng.integers(0, 10, n_train // 5)]}, f)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({"data": rng.integers(0, 256, (n_test, 3072)).astype(np.uint8),
                     "labels": [int(v) for v in rng.integers(0, 10, n_test)]}, f)


def test_pipelines_at_their_defaults_match_gqx(tmp_path):
    """CIFAR-10 files written from a seed: both Pipelines at their defaults
    take the native augment and give the same batches, epoch after epoch;
    ``native=False`` takes numpy's, which differs."""
    _write_cifar10(tmp_path, np.random.default_rng(0))
    kw = dict(dataset="cifar10", num_users=2, batch_size=4, test_batch_size=6, seed=3,
              data_dir=str(tmp_path))
    port, ref = Pipeline(GQConfig(**kw)), GqxPipeline(GqxConfig(**kw))
    assert port.augment == "native" and ref._native is not None
    assert port.steps_per_epoch == ref.steps_per_epoch == 5
    for epoch in (1, 2):
        got, want = list(port.train_epoch(epoch)), list(ref.train_epoch(epoch))
        assert len(got) == len(want) == 5
        for (x, y), (wx, wy) in zip(got, want):
            assert x.shape == (2, 4, 32, 32, 3)
            _bits_equal(x, wx)
            _bits_equal(y, wy)
    numpy_port = Pipeline(GQConfig(**kw), native=False)
    assert numpy_port.augment == "numpy"
    x_np, _ = next(numpy_port.train_epoch(1))
    assert x_np.tobytes() != next(port.train_epoch(1))[0].tobytes()


def test_pipeline_native_rule(tmp_path, monkeypatch):
    """tinyimg takes numpy's augment whatever ``native`` says; only
    ``native=False`` selects numpy's where the library builds, and where it
    does not, ``None`` and ``True`` take numpy's, as gqx's do."""
    syn = dict(dataset="synthetic", num_users=2, batch_size=4,
               dataset_kwargs=dict(num_train=16, num_test=8, image_shape=(8, 8, 3)))
    assert Pipeline(GQConfig(**syn)).augment == "native"
    assert Pipeline(GQConfig(**syn), native=True).augment == "native"
    assert Pipeline(GQConfig(**syn), native=False).augment == "numpy"
    monkeypatch.setattr(native, "available", lambda: False)
    assert Pipeline(GQConfig(**syn)).augment == "numpy"
    assert Pipeline(GQConfig(**syn), native=True).augment == "numpy"
    monkeypatch.undo()
    tiny = np.zeros((4, 8, 8, 3), np.uint8), np.zeros(4, np.int64)
    monkeypatch.setattr(data, "load_dataset", lambda *a, **k: (tiny, tiny))
    assert Pipeline(GQConfig(dataset="tinyimg", num_users=1, batch_size=4)).augment == "numpy"
