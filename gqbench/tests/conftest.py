"""Fixtures of the benchmark's tests: the tiny CPU cells of ``data/`` and the
check for a card (made inside a fixture, never while a module is imported)."""

import os

import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def tiny(monkeypatch):
    """The manifest and the files of the tiny CPU cells; the faults a test
    plants in this process are undone after it.  The program memoizes its
    codebooks per process, and under several ranks rank 0 broadcasts the
    one it finds: a fresh rank beside a rank 0 that remembers one would
    wait for a broadcast that never comes, so the memo is cleared too."""
    from gqbench.harness import manifest
    from gqbench.tests import plants
    from gqx_torch.codebooks import get_codebook

    get_codebook.cache_clear()

    monkeypatch.setattr(manifest, "BENCHMARK_FILE", os.path.join(DATA, "BENCHMARK.json"))
    monkeypatch.setattr(manifest, "DATA_DIR", DATA)
    yield manifest
    plants.restore()
    get_codebook.cache_clear()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
