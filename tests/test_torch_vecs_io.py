"""gqx_torch's vecs IO against gqx's: each reader on files gqx wrote, each
writer byte-equal to gqx's (truncating, appending, empty), the mmap
readers read-only, for fvecs, ivecs and bvecs alike."""

import numpy as np
import pytest

import gqx.utils.vecs_io as gqx_io
import gqx_torch.utils.vecs_io as port_io

KINDS = {"fvecs": np.float32, "ivecs": np.int32, "bvecs": np.uint8}


def _rows(kind, n, dim, seed):
    rng = np.random.default_rng(seed)
    if kind == "fvecs":
        return rng.standard_normal((n, dim)).astype(np.float32)
    if kind == "ivecs":
        return rng.integers(-2 ** 31, 2 ** 31, (n, dim)).astype(np.int32)
    return rng.integers(0, 256, (n, dim)).astype(np.uint8)


def _fn(module, kind, what):
    return getattr(module, f"{kind}_{what}")


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_writers_byte_equal_to_gqx(kind, tmp_path):
    """Write, then append, as both packages: the same bytes each time."""
    first, more = _rows(kind, 5, 7, 0), _rows(kind, 3, 7, 1)
    for module, name in ((gqx_io, "gqx"), (port_io, "port")):
        path = tmp_path / f"{name}.{kind}"
        _fn(module, kind, "write")(path, first)
        _fn(module, kind, "write")(path, more, append=True)
    assert (tmp_path / f"port.{kind}").read_bytes() == (tmp_path / f"gqx.{kind}").read_bytes()
    # a write without append truncates
    for module, name in ((gqx_io, "gqx"), (port_io, "port")):
        _fn(module, kind, "write")(tmp_path / f"{name}.{kind}", more)
    assert (tmp_path / f"port.{kind}").read_bytes() == (tmp_path / f"gqx.{kind}").read_bytes()


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("mmap", [False, True])
def test_readers_match_gqx(kind, mmap, tmp_path):
    rows = np.concatenate([_rows(kind, 4, 9, 2), _rows(kind, 2, 9, 3)])
    path = tmp_path / f"x.{kind}"
    write = _fn(gqx_io, kind, "write")
    write(path, rows[:4])
    write(path, rows[4:], append=True)
    what = "read_mmap" if mmap else "read"
    got, want = _fn(port_io, kind, what)(path), _fn(gqx_io, kind, what)(path)
    _same(np.asarray(got), np.asarray(want))
    _same(np.asarray(got), rows)
    if mmap:
        assert not got.flags.writeable
        with pytest.raises(ValueError):
            got[0, 0] = 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_empty_file(kind, tmp_path):
    """An empty array writes an empty file, and every reader gives (0, 0)
    of the kind's dtype, as gqx's."""
    empty = np.zeros((0, 4), KINDS[kind])
    for module, name in ((gqx_io, "gqx"), (port_io, "port")):
        _fn(module, kind, "write")(tmp_path / f"{name}.{kind}", empty)
    path = tmp_path / f"port.{kind}"
    assert path.read_bytes() == (tmp_path / f"gqx.{kind}").read_bytes() == b""
    for what in ("read", "read_mmap"):
        got = _fn(port_io, kind, what)(path)
        _same(got, _fn(gqx_io, kind, what)(path))
        assert got.shape == (0, 0) and got.dtype == KINDS[kind]


def test_shipped_codebook_reads_alike():
    from gqx_torch.codebooks import DEFAULT_DIR, codebook_filename

    path = f"{DEFAULT_DIR}/{codebook_filename(16, 256)}"
    _same(port_io.fvecs_read(path), gqx_io.fvecs_read(path))
    _same(np.asarray(port_io.fvecs_read_mmap(path)), port_io.fvecs_read(path))


def test_normalize_rows_matches_gqx():
    rows = _rows("fvecs", 6, 5, 4)
    rows[2] = 0.0
    for a, b in zip(port_io.normalize_rows(rows), gqx_io.normalize_rows(rows)):
        _same(a, b)
