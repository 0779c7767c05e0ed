"""gqx_torch's k-means and codebook training against gqx's, on the CPU.

Lloyd's iterations from the same samples and the same initial rows (gqx's,
drawn with threefry: the port's generator draws others by design), the
assignment, an empty cluster, the samples' zero-row guard, a trained
codebook's quality against gqx's, and ``get_codebook``'s train-and-cache
path, which writes only into the port's cache (a temporary directory
here) and never into the repository's ``codebooks/``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqx.codebooks.kmeans as gqx_kmeans
import gqx_torch.codebooks as codebooks
import gqx_torch.codebooks.kmeans as kmeans
from gqx_torch.config import GQConfig
from gqx_torch.models import create_model
from gqx_torch.train import create_train_state, make_train_step

# Lloyd's test size: one full assignment chunk and a short one
N, DIM, K, ITERS = (1 << 17) + 3000, 4, 16, 3


@pytest.fixture(autouse=True)
def few_threads():
    """The suite runs in several worker processes on one host, and torch's
    default of a thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gqx_run():
    """gqx's samples, its initial rows (``jax.random.choice`` as its
    ``lloyd`` draws them) and its centroids after ``ITERS`` iterations."""
    k_sample, k_init = jax.random.split(jax.random.PRNGKey(11))
    x = gqx_kmeans.unit_gaussian_samples(k_sample, N, DIM)
    init = x[jax.random.choice(k_init, N, (K,), replace=False)]
    out = gqx_kmeans.lloyd(k_init, x, K, ITERS)
    return np.asarray(x), np.asarray(init), np.asarray(out)


def test_lloyd_matches_gqx(gqx_run):
    """The centroids within 1e-5 (the float32 sums are taken in another
    order); the assignment equal to gqx's argmax on the same centroids but
    where gqx's top two logits lie within 1e-6."""
    x, init, want = gqx_run
    x, init, want = x.copy(), init.copy(), want.copy()
    got = kmeans.lloyd_from(torch.from_numpy(x), torch.from_numpy(init), ITERS)
    assert got.dtype == torch.float32 and got.shape == (K, DIM)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not np.allclose(want, init, atol=1e-3)          # the centroids moved

    assign = kmeans.assign(torch.from_numpy(x), torch.from_numpy(want)).numpy()
    logits = np.asarray(jnp.dot(x, want.T) - 0.5 * jnp.sum(want * want, axis=1))
    ref = np.asarray(gqx_kmeans._assign_chunk(jnp.asarray(x), jnp.asarray(want)))
    differ = assign != ref
    top2 = np.sort(logits[differ], axis=1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] <= 1e-6), int(differ.sum())
    assert differ.sum() <= 5


def test_empty_cluster_keeps_its_centroid():
    """A centroid that no row is nearest to keeps its value; the others are
    their rows' means (a float64 loop as the reference)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 3)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) + 1.0                       # every row at x0 > 1
    init = np.stack([x[0], x[1], x[2], np.array([-50.0, 0.0, 0.0], np.float32)])
    got = kmeans.lloyd_from(torch.from_numpy(x), torch.from_numpy(init), 2).numpy()
    c = init.astype(np.float64)
    for _ in range(2):
        a = np.argmin(((x[:, None, :] - c[None]) ** 2).sum(-1), axis=1)
        c = np.stack([x[a == j].mean(0) if (a == j).any() else c[j] for j in range(4)])
    np.testing.assert_array_equal(got[3], init[3])
    np.testing.assert_allclose(got, c, rtol=0, atol=1e-5)


def test_unit_samples_guard_zero_rows(monkeypatch):
    """Unit rows from the generator; given the same draws with a zero row,
    both packages leave it zero (no NaN) and scale the others alike."""
    x = kmeans.unit_gaussian_samples(1000, 6, torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_allclose(torch.linalg.vector_norm(x, dim=1).numpy(), 1.0, rtol=1e-6)
    raw = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32)
    raw[2] = 0.0
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.from_numpy(raw.copy()))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(raw))
    got = kmeans.unit_gaussian_samples(4, 6, None, "cpu").numpy()
    want = np.asarray(gqx_kmeans.unit_gaussian_samples(jax.random.PRNGKey(0), 4, 6))
    assert np.all(np.isfinite(got)) and not got[2].any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _score(cb, samples):
    cb = cb / np.linalg.norm(cb, axis=1, keepdims=True)
    return float((samples @ cb.T).max(1).mean())


def test_train_codebook_quality_matches_gqx():
    """dim 8, K 32, 20,000 samples, 10 iterations in both packages: the
    mean best cosine over fresh unit samples within 1%."""
    got = codebooks.kmeans.train_codebook(8, 32, train_size=20_000, iters=10, device="cpu")
    want = gqx_kmeans.train_codebook(8, 32, train_size=20_000, iters=10)
    assert got.shape == want.shape == (32, 8) and got.dtype == np.float32
    s = np.random.default_rng(9).standard_normal((50_000, 8))
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    assert _score(got, s) == pytest.approx(_score(want, s), rel=1e-2)
    # the same seed gives the same codebook
    again = codebooks.kmeans.train_codebook(8, 32, train_size=20_000, iters=10, device="cpu")
    assert again.tobytes() == got.tobytes()


def _tree(directory):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, fs in os.walk(directory) for f in fs}


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The port's cache in a temporary directory, a small training set, the
    search variables unset, and ``get_codebook``'s memo cleared around."""
    monkeypatch.setattr(codebooks, "CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv(codebooks.ENV_TRAIN_SIZE, "4096")
    for var in (codebooks.ENV_DIR, codebooks.ENV_REFERENCE_DIR):
        monkeypatch.delenv(var, raising=False)
    codebooks.get_codebook.cache_clear()
    yield tmp_path / "cache"
    codebooks.get_codebook.cache_clear()


def test_get_codebook_trains_and_caches_only_in_its_cache(cache, monkeypatch):
    """K = 16 is shipped for no dim: the first call trains on the CPU and
    writes the cache's file only; the second (memo cleared) reads it."""
    shipped = _tree(codebooks.DEFAULT_DIR)
    cb = codebooks.get_codebook(6, 16, device="cpu")
    assert cb.shape == (16, 6) and cb.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(cb, axis=1), 1.0, rtol=1e-6)
    assert os.listdir(cache) == [codebooks.codebook_filename(6, 16)]
    assert _tree(codebooks.DEFAULT_DIR) == shipped
    stored = codebooks.fvecs_read(cache / codebooks.codebook_filename(6, 16))
    assert stored.tobytes() == cb.tobytes()

    def refuse(*a, **k):
        raise AssertionError("trained again")

    monkeypatch.setattr(codebooks, "train_codebook", refuse)
    codebooks.get_codebook.cache_clear()
    # rows are normalized at load, the stored unit rows again (as gqx does)
    again = codebooks.get_codebook(6, 16, device="cpu")
    assert again.tobytes() == codebooks.normalize_rows(stored)[1].tobytes()
    np.testing.assert_allclose(again, cb, rtol=0, atol=1e-7)


def test_get_codebook_on_the_card_without_one_raises(cache):
    with pytest.raises(RuntimeError, match="CUDA device"):
        codebooks.get_codebook(6, 16, device="cuda")
    assert not cache.exists()


def test_folded_step_trains_an_unshipped_codebook_on_the_cpu(cache):
    """FCN at HSQ c_dim 16 / k_bit 3 needs a (K 8, dim 16) codebook, which
    the repository does not ship: the plan trains it on the entry point's
    device, and one folded step runs."""
    shipped = _tree(codebooks.DEFAULT_DIR)
    cfg = GQConfig(network="fcn", quantizer="hsq", c_dim=16, k_bit=3, n_bit=6, num_users=2,
                   batch_size=4)
    model = create_model("fcn", 10, generator=torch.Generator().manual_seed(0))
    state, plan = create_train_state(cfg, model, device="cpu")
    assert {(u.compressor.dim, u.compressor.K) for u in plan.units
            if hasattr(u.compressor, "K")} == {(16, 8)}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    loss = make_train_step(cfg, plan)(state, torch.randn(2, 4, 1, 28, 28, generator=gen),
                                      torch.randint(0, 10, (2, 4), generator=gen), 0.1, 5e-4,
                                      gen)
    assert np.isfinite(float(loss))
    assert all(not torch.equal(before[n], p) for n, p in model.named_parameters())
    assert os.listdir(cache) == [codebooks.codebook_filename(16, 8)]
    assert _tree(codebooks.DEFAULT_DIR) == shipped
