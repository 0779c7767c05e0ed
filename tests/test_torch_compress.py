"""gqx_torch's compressors against gqx's on the same numpy inputs."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqx.compress.vq as gqx_vq
from gqx.codebooks import get_codebook as gqx_get_codebook
from gqx.codebooks import orthonormal_codebook as gqx_orthonormal
from gqx.compress.api import subvector_dim as gqx_subvector_dim
from gqx.compress import make_compressor as gqx_make_compressor
from gqx.compress.scalar import ProbabilisticScalarCompressor as GqxScalar
from gqx.compress.scalar import TransposedScalarCompressor as GqxScalarT
from gqx.config import GQConfig as GqxConfig
from gqx.ops import pallas_hsq4
from gqx.ops.pallas_hsq2 import bf16_exact_codebook as gqx_bf16_exact
import gqx_torch.codebooks as port_codebooks
from gqx_torch.codebooks import get_codebook, orthonormal_codebook
from gqx_torch.compress import make_compressor
from gqx_torch.compress.api import stochastic_increment, subvector_dim
from gqx_torch.compress.scalar import (ProbabilisticScalarCompressor, QSGDCompressor,
                                       SignSGDCompressor)
from gqx_torch.compress.sparse import MaureySparsificationCompressor, TopKCompressor
from gqx_torch.compress.vq import ProbabilisticVectorCompressor, ResidualCompressor
from gqx_torch.config import GQConfig
from gqx_torch.ops import rand as rand_ops
from gqx_torch.ops.hsq_prep import bf16_exact_codebook
from gqx_torch.parallel.packing import wire_bytes


def interpret_kernels(monkeypatch):
    """Run gqx's HSQ path with its Pallas kernels in interpret mode."""
    shim = types.SimpleNamespace(**{
        name: functools.partial(getattr(pallas_hsq4, name), interpret=True)
        for name in ("hsq_encode_flat", "hsq_decode_flat", "hsq_decode_mean")
    })
    monkeypatch.setattr(gqx_vq, "_hsq_kernels", lambda: shim)


@pytest.mark.parametrize("dim,k", [(16, 256), (8, 256), (16, 64), (32, 1024)])
def test_codebooks_byte_equal(dim, k):
    want = gqx_bf16_exact(gqx_get_codebook(dim, k))
    got = bf16_exact_codebook(get_codebook(dim, k))
    assert got.shape == (k, dim)
    assert got.tobytes() == want.tobytes()


def test_orthonormal_codebook_equal():
    assert orthonormal_codebook(16, seed=3).tobytes() == gqx_orthonormal(16, seed=3).tobytes()


def test_missing_codebook_raises(tmp_path, monkeypatch):
    """A codebook that no directory of the search path holds (K = 7 is
    shipped for no dim) is trained on the card by default: without one
    that raises, and nothing is written to the cache."""
    for var in ("GQX_CODEBOOK_DIR", "GQX_REFERENCE_CODEBOOKS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(port_codebooks, "CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        get_codebook(16, 7, search_dir=str(tmp_path))
    assert not (tmp_path / "cache").exists()


def test_subvector_dim_equal():
    for size in [1, 7, 16, 24, 48, 1000, 1728, 4096, 147456, 1000 * 3, 23520842, 36]:
        for c_dim in (0, 8, 16, 32, 128):
            try:
                want = gqx_subvector_dim(size, c_dim)
            except ValueError:
                with pytest.raises(ValueError):
                    subvector_dim(size, c_dim)
                continue
            assert subvector_dim(size, c_dim) == want


def _segments_and_values(rng, users):
    # leaf segments + a pad segment of zeros, as a planned HSQ unit has them;
    # every non-final segment spans >= 8 rows (gqx's transposed layout needs it)
    segs = (9, 100, 37, 250, 64)
    pad = 52
    m = sum(segs) + pad
    u = rng.standard_normal((users, m)).astype(np.float32)
    u[:, 9:109] *= 1e-3
    u[:, m - pad:] = 0.0
    u[0, 109:146] = 0.25   # a degenerate (constant) segment
    return segs + (pad,), u


def test_norm_levels_equal_mordered_gqx(rng):
    users = 3
    segs, u = _segments_and_values(rng, users)
    m = u.shape[1]
    want = jax.vmap(GqxScalar(m, (m,), 6, random=False, segment_sizes=segs).compress)(
        jnp.asarray(u))
    port = ProbabilisticScalarCompressor(m, (m,), 6, random=False, segment_sizes=segs)
    got = port.compress(torch.from_numpy(u))
    np.testing.assert_array_equal(got["l"].numpy(), np.asarray(want["l"]))
    np.testing.assert_array_equal(got["lower"].numpy(), np.asarray(want["lower"]))
    np.testing.assert_array_equal(got["upper"].numpy(), np.asarray(want["upper"]))
    dec_want = jax.vmap(GqxScalar(m, (m,), 6, random=False, segment_sizes=segs).decompress)(want)
    np.testing.assert_array_equal(port.decompress(got).numpy(), np.asarray(dec_want))
    # the users axis is the leading axis of the same calls
    assert torch.equal(port.roundtrip_batch(torch.from_numpy(u)), port.decompress(got))
    assert torch.equal(port.roundtrip(torch.from_numpy(u[1])), port.decompress(got)[1])


def test_norm_levels_equal_transposed_gqx(rng):
    """gqx's transposed-layout quantizer (its TPU hot path) gives the same
    levels as the port's m-order one."""
    segs, u = _segments_and_values(rng, 1)
    b = 8
    m = u.shape[1]
    s_pad = m // b
    comp_t = GqxScalarT(b, s_pad, 6, random=False, segment_sizes=segs)
    u_t = u[0].reshape(s_pad, b).T  # element (blk, s) = m-order row s*b + blk
    want = comp_t.compress(jnp.asarray(u_t))
    l_m = np.asarray(want["l"]).T.reshape(-1)
    port = ProbabilisticScalarCompressor(m, (m,), 6, random=False, segment_sizes=segs)
    got = port.compress(torch.from_numpy(u[0]))
    np.testing.assert_array_equal(got["l"].numpy(), l_m)
    np.testing.assert_array_equal(got["lower"].numpy(), np.asarray(want["lower"]))
    np.testing.assert_array_equal(got["upper"].numpy(), np.asarray(want["upper"]))


def test_segment_bounds_span_many_blocks(rng):
    """Segments longer than one reduction block and shorter than one."""
    segs = (3000, 1, 2048, 1025)
    v = torch.from_numpy(rng.standard_normal((2, sum(segs))).astype(np.float32))
    comp = ProbabilisticScalarCompressor(sum(segs), (sum(segs),), 4, random=False,
                                         segment_sizes=segs)
    lower, upper, _, _ = comp._bounds(v)
    off = 0
    for i, n in enumerate(segs):
        assert torch.equal(lower[:, i], v[:, off:off + n].amin(1))
        assert torch.equal(upper[:, i], v[:, off:off + n].amax(1))
        off += n


def test_stochastic_increment_routes():
    """Every draw, whatever its size, takes its uniforms from the Philox
    generator seeded from the caller's generator (no torch.rand path)."""
    for m in (65536, 100, 0):
        scaled = torch.linspace(0, 63.9, 2 * m).reshape(2, m)
        floored = scaled.to(torch.int32)
        inc = stochastic_increment(scaled, floored, torch.Generator().manual_seed(5))
        gen2 = torch.Generator().manual_seed(5)
        hi, lo = torch.randint(0, 1 << 31, (2,), generator=gen2).tolist()
        r = rand_ops.uniform((hi << 31) | lo, 0, (2, m), "cpu")
        assert inc.shape == (2, m) and inc.dtype == torch.int32
        assert torch.equal(inc, ((scaled - floored.float()) > r).to(torch.int32))


def test_norm_stochastic_rounding_unbiased(rng):
    m = 70000
    comp = ProbabilisticScalarCompressor(m, (m,), 6, random=True, segment_sizes=(m,))
    v = torch.from_numpy(rng.uniform(0, 1, (4, m)).astype(np.float32))
    sig = comp.compress(v, torch.Generator().manual_seed(0))
    assert int(sig["l"].min()) >= 0 and int(sig["l"].max()) <= 64
    err = (comp.decompress(sig) - v).mean()
    assert abs(float(err)) < 2e-4   # E[l] = scaled: unbiased


def _hsq_pair(monkeypatch, size, passes, segs):
    interpret_kernels(monkeypatch)
    kw = dict(c_dim=16, k_bit=8, n_bit=6, random=False, hsq_passes=passes)
    gcfg = GqxConfig(quantizer="hsq", **kw)
    gcfg.use_pallas = True
    from gqx.compress import make_compressor as gqx_make

    gq = gqx_make("hsq", size, (size,), gcfg, norm_segment_sizes=segs)
    pt = make_compressor("hsq", size, (size,), GQConfig(quantizer="hsq", **kw),
                         norm_segment_sizes=segs)
    return gq, pt


@pytest.mark.parametrize("passes", [1, 2])
def test_hsq_compress_and_decode_mean_match_gqx(rng, monkeypatch, passes):
    """The whole HSQ compressor on a padded, segmented unit: codes, norm
    levels and the fused decode-mean, from the same per-user vectors."""
    # two kernel tiles: XLA's CPU backend cannot run gqx's single-tile bf16
    # decode-mean dot in interpret mode
    users, leaves, pad = 3, (1728, 4096, 36864, 65536), 131072 - 108224
    size = sum(leaves) + pad
    segs = tuple(n // 16 for n in leaves) + (pad // 16,)
    gq, pt = _hsq_pair(monkeypatch, size, passes, segs)
    assert gq.sig_t  # gqx's TPU path: transposed signature layout
    assert pt.codewords.numpy().tobytes() == np.asarray(gq.codewords).tobytes()
    g = rng.standard_normal((users, size)).astype(np.float32)
    g[:, 1728:5824] *= 1e-2
    g[:, size - pad:] = 0.0

    sig_j = gq.compress_batch_m(jnp.asarray(g), None)
    sig_t = pt.compress_batch(torch.from_numpy(g), None)
    codes_j = np.asarray(sig_j["codes"])
    differ = sig_t["codes"].numpy() != codes_j
    print(f"passes={passes}: {int(differ.sum())} near-tie codes differ of {differ.size}")
    assert differ.sum() <= 2
    l_j = np.asarray(sig_j["u"]["l"])
    l_t = sig_t["u"]["l"].numpy()
    assert (l_t != l_j)[~differ].sum() <= 2
    np.testing.assert_allclose(sig_t["u"]["lower"].numpy(), np.asarray(sig_j["u"]["lower"]), rtol=1e-6)
    np.testing.assert_allclose(sig_t["u"]["upper"].numpy(), np.asarray(sig_j["u"]["upper"]), rtol=1e-6)

    # gqx's own batched path (transposed layout, its decode-mean kernel),
    # under one jit as gqx's train step runs it
    mean_j = np.asarray(jax.jit(lambda v: gq.decode_mean(gq.compress_batch(v, None)))(
        jnp.asarray(g)))
    mean_t = pt.decode_mean(sig_t).numpy()
    rows_bad = ~np.isclose(mean_t, mean_j, rtol=1e-5, atol=1e-7).reshape(-1, 16).all(1)
    flipped = (differ | (l_t != l_j)).any(0)
    assert not np.any(rows_bad & ~flipped)
    assert np.all(mean_t.reshape(-1, 16)[-(pad // 16):] == 0.0)


def test_hsq_accounting_matches_gqx(monkeypatch):
    size = 65536
    gq, pt = _hsq_pair(monkeypatch, size, 1, (1000, 3096))
    assert (pt.dim, pt.K, pt.M, pt.code_bits, pt.wire_bits) == \
        (gq.dim, gq.K, gq.M, gq.code_bits, gq.wire_bits)
    assert pt.code_dtype == torch.uint8


def test_make_compressor_builds_each_name():
    cfg = GQConfig(quantizer="qsgd", c_dim=16, n_bit=2)
    for name, kind in (("topk", TopKCompressor), ("pvq", ProbabilisticVectorCompressor),
                       ("residual", ResidualCompressor),
                       ("maurey", MaureySparsificationCompressor)):
        assert type(make_compressor(name, 4096, (4096,), cfg)) is kind
    for name, kind in (("qsgd", QSGDCompressor), ("terngrad", QSGDCompressor),
                       ("sign", SignSGDCompressor)):
        assert type(make_compressor(name, 4096, (4096,), cfg)) is kind
    with pytest.raises(ValueError):
        make_compressor("nosuch", 4096, (4096,), cfg)
    # a ragged size (dim 24) and a large codebook take the row-major kernels
    ragged = make_compressor("hsq", 4104, (4104,), GQConfig(quantizer="hsq", c_dim=16))
    assert ragged.dim == 24 and not ragged.flat_ok
    large = make_compressor("hsq", 4096, (4096,), GQConfig(quantizer="hsq", c_dim=8, k_bit=10))
    assert large.K == 1024 and not large.flat_ok and large.code_dtype == torch.int32


# -- the scalar compressors of the canonical comparison ------------------------

SCALAR_CONFIGS = {
    "qsgd2bit": dict(quantizer="qsgd", c_dim=128, n_bit=2),
    "qsgd_ragged": dict(quantizer="qsgd", c_dim=16, n_bit=4),     # 4104 -> buckets of 24
    "terngrad": dict(quantizer="terngrad"),
    "sign": dict(quantizer="sign"),
}


def _scalar_pair(which, size, random=False):
    kw = dict(SCALAR_CONFIGS[which], random=random)
    name = kw["quantizer"]
    return (gqx_make_compressor(name, size, (size,), GqxConfig(**kw)),
            make_compressor(name, size, (size,), GQConfig(**kw)))


def _gradient_like(rng, users, size):
    g = (rng.standard_normal((users, size)) * 10.0 ** rng.uniform(-4, 0, (users, 1))).astype(np.float32)
    g[:, :300] = 0.0            # zero buckets (0/0 -> 0) and exact zeros for sign
    g[0, 500] = -g[0, 500:640].max() * 2   # a negative bucket maximum
    return g


@pytest.mark.parametrize("which", list(SCALAR_CONFIGS))
def test_scalar_compressors_match_gqx(rng, which):
    """random=False: signature (levels, signs, norms) and round trip equal
    gqx's bit for bit, for one vector and for a users axis; a zero bucket
    round-trips to zero; the accounting is gqx's."""
    users = 3
    size = 4104 if which == "qsgd_ragged" else 4096
    gq, pt = _scalar_pair(which, size)
    g = _gradient_like(rng, users, size)
    sig_j = jax.vmap(gq.compress)(jnp.asarray(g))
    sig_t = pt.compress_batch(torch.from_numpy(g), None)
    assert sorted(sig_t) == sorted(sig_j)
    for key in sig_j:
        np.testing.assert_array_equal(sig_t[key].numpy(), np.asarray(sig_j[key]), err_msg=key)
    dec_j = np.asarray(jax.vmap(gq.decompress)(sig_j))
    dec_t = pt.decompress_batch(sig_t)
    np.testing.assert_array_equal(dec_t.numpy(), dec_j)
    assert not dec_t[:, :300].any() and bool(torch.isfinite(dec_t).all())
    assert torch.equal(pt.roundtrip(torch.from_numpy(g[1])), dec_t[1])
    assert torch.equal(pt.roundtrip_batch(torch.from_numpy(g)), dec_t)
    # the server mean: the same three addends, summed and divided in each
    # framework's own way, so equal to a float32 rounding
    np.testing.assert_allclose(pt.decode_mean(sig_t).numpy(),
                               np.asarray(gq.decode_mean(sig_j)), rtol=3e-7, atol=1e-30)
    assert pt.wire_bits == gq.wire_bits
    if which != "sign":
        assert (pt.dim, pt.M, pt.s) == (gq.dim, gq.M, gq.s)
        assert int(sig_t["l"].max()) <= pt.s - 1    # no overflow without rounding up


@pytest.mark.parametrize("which", list(SCALAR_CONFIGS))
@pytest.mark.parametrize("random", [False, True])
def test_scalar_wire_bytes_match_gqx(which, random):
    from gqx.ops.wire import wire_bytes as gqx_wire_bytes

    gq, pt = _scalar_pair(which, 4104 if which == "qsgd_ragged" else 4096, random)
    assert wire_bytes(pt) == gqx_wire_bytes(gq)


def test_qsgd_stochastic_rounding_unbiased_and_may_overflow(rng):
    size = 128 * 600
    pt = make_compressor("qsgd", size, (size,), GQConfig(quantizer="qsgd", c_dim=128, n_bit=2))
    v = torch.from_numpy(rng.standard_normal((4, size)).astype(np.float32))
    with pytest.raises(ValueError):
        pt.compress(v, None)
    sig = pt.compress(v, torch.Generator().manual_seed(0))
    assert int(sig["l"].min()) >= 0 and int(sig["l"].max()) == pt.s   # the bucket maximum rounds up
    err = (pt.decompress(sig) - v).mean()
    assert abs(float(err)) < 2e-3                                     # E[l] = scaled: unbiased
    again = pt.compress(v, torch.Generator().manual_seed(0))
    assert torch.equal(sig["l"], again["l"])
