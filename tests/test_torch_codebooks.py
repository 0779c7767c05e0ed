"""The port's codebook search path against gqx's: the same directories in
the same order (``search_dir``, ``$GQX_CODEBOOK_DIR``, the repository's
``codebooks/learned_codebook``, ``./codebooks/learned_codebook``,
``$GQX_REFERENCE_CODEBOOKS``), a file of the wrong shape skipped, and the
same array returned.  The (dim, K) is one the repository ships, and gqx's
k-means is replaced by a function that raises, so gqx never trains (or
writes) a codebook here."""

import os

import numpy as np
import pytest

import gqx.codebooks as gqx_codebooks
from gqx.utils.vecs_io import fvecs_write
from gqx_torch import codebooks

DIM, K = 16, 256


def _write(directory, rows, dim=DIM, k=K):
    os.makedirs(directory, exist_ok=True)
    fvecs_write(os.path.join(directory, codebooks.codebook_filename(dim, k)), rows)


def _unit(rows):
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture
def clean(monkeypatch):
    """Both caches cleared before and after, both variables unset, and gqx's
    training refused."""
    def refuse(*a, **k):
        raise AssertionError("gqx trained a codebook")

    monkeypatch.setattr(gqx_codebooks, "train_codebook", refuse)
    for var in (codebooks.ENV_DIR, codebooks.ENV_REFERENCE_DIR):
        monkeypatch.delenv(var, raising=False)
    gqx_codebooks.get_codebook.cache_clear()
    codebooks.get_codebook.cache_clear()
    yield monkeypatch
    gqx_codebooks.get_codebook.cache_clear()
    codebooks.get_codebook.cache_clear()


@pytest.mark.parametrize("case", ["env_dir", "env_dir_wrong_shape", "reference_dir",
                                  "env_dir_without_search_dir"])
def test_codebook_search_path_matches_gqx(clean, tmp_path, case):
    rng = np.random.default_rng(len(case))
    env_rows = rng.standard_normal((K, DIM)).astype(np.float32)
    ref_rows = rng.standard_normal((K, DIM)).astype(np.float32)
    wrong = rng.standard_normal((K, DIM + 1)).astype(np.float32)   # (K, DIM + 1): skipped
    first = str(tmp_path / "first")
    _write(first, wrong)
    search_dir = first
    shipped = codebooks.fvecs_read(os.path.join(codebooks.DEFAULT_DIR,
                                                codebooks.codebook_filename(DIM, K)))
    if case == "env_dir":
        _write(str(tmp_path / "env"), env_rows)
        want = env_rows
    elif case == "env_dir_wrong_shape":
        # the variable's file is skipped too; the repository's comes before
        # the reference directory
        _write(str(tmp_path / "env"), wrong[:-1])                      # (K - 1, DIM + 1)
        _write(str(tmp_path / "ref"), ref_rows)
        clean.setenv(codebooks.ENV_REFERENCE_DIR, str(tmp_path / "ref"))
        want = shipped
    elif case == "reference_dir":
        # no repository directory holds it: the last place is reached
        empty = str(tmp_path / "empty")
        os.makedirs(empty)
        clean.setattr(gqx_codebooks, "DEFAULT_CACHE_DIR", empty)
        clean.setattr(codebooks, "DEFAULT_DIR", empty)
        clean.chdir(tmp_path)
        _write(str(tmp_path / "ref"), ref_rows)
        clean.setenv(codebooks.ENV_REFERENCE_DIR, str(tmp_path / "ref"))
        want = ref_rows
    else:
        _write(str(tmp_path / "env"), env_rows)
        search_dir = None
        want = env_rows
    if case != "reference_dir":
        clean.setenv(codebooks.ENV_DIR, str(tmp_path / "env"))
    got_gqx = gqx_codebooks.get_codebook(DIM, K, search_dir=search_dir)
    got = codebooks.get_codebook(DIM, K, search_dir=search_dir)
    assert got.shape == (K, DIM) and got.dtype == np.float32
    assert got.tobytes() == got_gqx.tobytes()
    np.testing.assert_allclose(got, _unit(want), rtol=1e-6, atol=1e-7)
