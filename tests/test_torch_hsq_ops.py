"""gqx_torch's HSQ and uniform kernels, held against gqx's Pallas kernels:
the v4 generation (``pallas_hsq4``) and the v3 generation (``pallas_hsq3``),
which compute the same three functions on the same m-order contract.

On the CPU the port's wrappers compute their plain PyTorch versions; gqx's
kernels run in Pallas interpret mode, as gqx's own tests run them.  The
tests marked ``cuda`` hold the CUDA kernels against the plain versions and
skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gqx.ops import pallas_hsq3, pallas_hsq4
from gqx.ops.pallas_hsq2 import bf16_exact_codebook as gqx_bf16_exact
from gqx.ops.pallas_hsq2 import expand_codebook, split_hi_lo
from gqx_torch.ops import hsq as hsq_ops
from gqx_torch.ops import rand as rand_ops
from gqx_torch.ops.hsq_prep import bf16_exact_codebook, bf16_round


def _codebook(rng, k, dim):
    cb = rng.standard_normal((k, dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=1, keepdims=True)
    # exact ties by construction: codeword 0 = -codeword 1 (a +v/-v tie),
    # codeword 3 = codeword 2 (an equal pair)
    cb[0] = -cb[1]
    cb[3] = cb[2]
    return gqx_bf16_exact(cb)


def _gqx_operands(cb):
    eh, el = split_hi_lo(expand_codebook(cb))
    return jnp.asarray(eh), jnp.asarray(el)


def _encode_inputs(rng, cb, users, m):
    dim = cb.shape[1]
    x = rng.standard_normal((users, m, dim)).astype(np.float32)
    x[:, :4] = 0.0                      # zero rows -> code 0, u 0
    x[:, 4] = cb[1]                     # p0 = -p1 < 0 < p1: code 1, u = +|c|^2
    x[:, 5] = cb[0]                     # p0 = +|c|^2: code 0
    x[:, 6] = 2.0 * cb[3]               # equal pair: first index, code 2
    x[:, 7] = -cb[3]                    # negative side of the pair: code 2
    return x.reshape(users, m * dim)


def _top2_margin(x, cb, passes):
    rows = torch.from_numpy(x).reshape(-1, cb.shape[1])
    c = torch.from_numpy(cb)
    hi = bf16_round(rows)
    p = hi.double() @ c.double().t()
    if passes == 2:
        p = p + bf16_round(rows - hi).double() @ c.double().t()
    top = p.abs().topk(2, dim=1).values
    return ((top[:, 0] - top[:, 1]) / top[:, 0].clamp_min(1e-30)).numpy()


def _check_encode(kernels, rng, passes, dim, k, batched=True):
    """The port's encode against ``kernels.hsq_encode_flat`` (interpret)."""
    users, m = 3, 403
    cb = _codebook(rng, k, dim)
    x = _encode_inputs(rng, cb, users, m)
    eh, el = _gqx_operands(cb)
    if not batched:
        users, x = 1, x[1:2]
    x_in = x if batched else x[0]
    u_j, c_j = kernels.hsq_encode_flat(jnp.asarray(x_in), eh, el, dim, tile_s=8,
                                       passes=passes, interpret=True)
    u_t, c_t = hsq_ops.hsq_encode_flat(torch.from_numpy(x_in), torch.from_numpy(cb),
                                       dim, passes, torch.uint8)
    assert u_t.shape == u_j.shape and c_t.shape == c_j.shape and c_t.dtype == torch.uint8
    u_j, c_j = np.asarray(u_j).reshape(users, m), np.asarray(c_j).reshape(users, m)
    u_t, c_t = u_t.numpy().reshape(users, m), c_t.numpy().astype(np.int32).reshape(users, m)

    # the constructed rows reproduce the kernel's tie rule exactly
    np.testing.assert_array_equal(c_t[:, :8], c_j[:, :8])
    np.testing.assert_array_equal(c_t[:, :4], 0)
    np.testing.assert_array_equal(u_t[:, :4], 0.0)
    np.testing.assert_array_equal(c_t[:, 4:8], [[1, 0, 2, 2]] * users)
    assert np.all(u_t[:, 4:7] > 0) and np.all(u_t[:, 7] < 0)

    # elsewhere codes may differ only on near-ties (top-2 |p| within 1e-5)
    differ = (c_t != c_j).reshape(-1)
    margin = _top2_margin(x, cb, passes)
    assert np.all(margin[differ] <= 1e-5), margin[differ]
    print(f"passes={passes} dim={dim}: {int(differ.sum())} near-tie codes differ "
          f"of {differ.size}")
    same = ~differ
    np.testing.assert_allclose(u_t.reshape(-1)[same], u_j.reshape(-1)[same],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("dim,k", [(16, 256), (8, 64)])
def test_encode_matches_pallas_kernel(rng, passes, dim, k):
    _check_encode(pallas_hsq4, rng, passes, dim, k)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("passes", [1, 2])
def test_encode_matches_pallas_v3_kernel(rng, passes, batched):
    """The v3 generation of the encode (tie rows included): the same
    function, so the same kernel and plain version stand for it."""
    _check_encode(pallas_hsq3, rng, passes, 16, 256, batched)


def test_encode_bf16_input_equals_rounded_f32(rng):
    """passes=1 rounds to bf16 inside the kernel, so a bf16 unit gives the
    same signature as its float32 values (gqx/compress/vq.py:163-170)."""
    cb = _codebook(rng, 256, 16)
    x = torch.from_numpy(_encode_inputs(rng, cb, 2, 300))
    a = hsq_ops.hsq_encode_flat(x, torch.from_numpy(cb), 16, 1)
    b = hsq_ops.hsq_encode_flat(x.to(torch.bfloat16), torch.from_numpy(cb), 16, 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    single = hsq_ops.hsq_encode_flat(x[1], torch.from_numpy(cb), 16, 1)
    assert torch.equal(single[1], a[1][1]) and torch.equal(single[0], a[0][1])


def _decode_tolerance(codes, u, cb, dim):
    """1e-6 of the magnitude of the summed terms: only the order of the
    fp32 additions differs from the TPU kernel's."""
    mag = hsq_ops.hsq_decode_mean_plain(torch.from_numpy(codes), torch.from_numpy(np.abs(u)),
                                        torch.from_numpy(np.abs(cb)), dim, 2)
    return 1e-6 * mag.numpy()


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("users,span", [(3, 256), (4, 3), (8, 5)])
def test_decode_mean_matches_pallas_kernel(rng, passes, users, span):
    """span < K forces many users onto the same code, so the per-code weight
    sums (in user order, then x 1/U, then bf16) are exercised."""
    dim, k, m = 16, 256, 517
    cb = _codebook(rng, k, dim)
    codes = rng.integers(0, span, (users, m)).astype(np.int32)
    u = rng.standard_normal((users, m)).astype(np.float32)
    eh, el = _gqx_operands(cb)
    want = np.asarray(pallas_hsq4.hsq_decode_mean(
        jnp.asarray(codes), jnp.asarray(u), eh, el, dim, tile_s=8, passes=passes,
        interpret=True))
    got = hsq_ops.hsq_decode_mean(torch.from_numpy(codes.astype(np.uint8)),
                                  torch.from_numpy(u), torch.from_numpy(cb), dim,
                                  passes).numpy()
    err = np.abs(got - want)
    assert np.all(err <= _decode_tolerance(codes, u, cb, dim)), err.max()
    if passes == 1:
        # the bf16 weight rounding is the kernel's, not the exact mean's
        exact = (cb[codes] * u[..., None]).mean(0).reshape(-1)
        assert np.abs(got - exact).max() > 1e3 * err.max() + 1e-6


def test_decode_plain_matches_pallas_decode(rng):
    dim, k, m, users = 16, 64, 200, 2
    cb = _codebook(rng, k, dim)
    codes = rng.integers(0, k, (users, m)).astype(np.int32)
    u = rng.standard_normal((users, m)).astype(np.float32)
    eh, el = _gqx_operands(cb)
    for passes in (1, 2):
        want = np.asarray(pallas_hsq4.hsq_decode_flat(
            jnp.asarray(codes), jnp.asarray(u), eh, el, dim, tile_s=8,
            passes=passes, interpret=True))
        got = hsq_ops.hsq_decode_plain(torch.from_numpy(codes), torch.from_numpy(u),
                                       torch.from_numpy(cb), dim, passes).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("users,span", [(4, 3), (8, 256)])
def test_decode_mean_matches_pallas_v3_kernel(rng, passes, users, span):
    """The v3 generation of the decode-mean, uint8 codes: the tolerance is
    the v4 test's (the order of the fp32 additions)."""
    dim, k, m = 16, 256, 517
    cb = _codebook(rng, k, dim)
    codes = rng.integers(0, span, (users, m)).astype(np.int32)
    u = rng.standard_normal((users, m)).astype(np.float32)
    eh, el = _gqx_operands(cb)
    want = np.asarray(pallas_hsq3.hsq_decode_mean(
        jnp.asarray(codes), jnp.asarray(u), eh, el, dim, tile_s=8, passes=passes,
        interpret=True))
    got = hsq_ops.hsq_decode_mean(torch.from_numpy(codes.astype(np.uint8)),
                                  torch.from_numpy(u), torch.from_numpy(cb), dim,
                                  passes).numpy()
    assert np.all(np.abs(got - want) <= _decode_tolerance(codes, u, cb, dim))


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("kernels", [pallas_hsq4, pallas_hsq3], ids=["v4", "v3"])
def test_decode_flat_matches_pallas_kernels(rng, kernels, passes, batched):
    """The per-user decode wrapper (its plain version on the CPU) against both
    generations of gqx's kernel: exact, since every product of a bf16 scale
    with a bf16-exact codeword is exact in float32.  uint8 and int32 codes,
    (U, M) and (M,)."""
    dim, k, m = 16, 256, 333
    cb = _codebook(rng, k, dim)
    shape = (3, m) if batched else (m,)
    codes = rng.integers(0, k, shape).astype(np.int32)
    u = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 1, shape)).astype(np.float32)
    eh, el = _gqx_operands(cb)
    want = np.asarray(kernels.hsq_decode_flat(
        jnp.asarray(codes), jnp.asarray(u), eh, el, dim, tile_s=8, passes=passes,
        interpret=True))
    for code_dtype in (np.uint8, np.int32):
        got = hsq_ops.hsq_decode_flat(torch.from_numpy(codes.astype(code_dtype)),
                                      torch.from_numpy(u), torch.from_numpy(cb), dim, passes)
        assert got.shape == shape[:-1] + (m * dim,) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    if passes == 1:
        # the scale is rounded to bf16: not the float32 product
        exact = (cb[codes] * u[..., None]).reshape(want.shape)
        assert np.abs(want - exact).max() > 0


def test_bf16_exact_codebook_matches_gqx(rng):
    cb = rng.standard_normal((64, 16)).astype(np.float32)
    got = bf16_exact_codebook(cb)
    want = gqx_bf16_exact(cb)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- K3: counter-based uniforms --------------------------------------------

def test_philox_known_answers():
    """Philox4x32-10 answer vectors of the Random123 distribution."""
    def run(ctr, key):
        c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        return [int(w) for w in rand_ops.philox4x32_10(*c, *key)]

    assert run([0, 0, 0, 0], [0, 0]) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = 0xFFFFFFFF
    assert run([f, f, f, f], [f, f]) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
               [0xA4093822, 0x299F31D0]) == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_uniform_reproducible_and_offset():
    a = rand_ops.uniform(123, 0, (5, 1001), "cpu")
    b = rand_ops.uniform(123, 0, (5, 1001), "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, rand_ops.uniform(124, 0, (5, 1001), "cpu"))
    # the counter is the element index // 4 plus the offset
    shifted = rand_ops.uniform(123, 3, (5 * 1001 - 12,), "cpu")
    assert torch.equal(shifted, a.reshape(-1)[12:])
    # bits -> float: the top 24 bits of word 0 of block 0
    w0 = rand_ops.philox4x32_10(*(torch.zeros(1, dtype=torch.int64),) * 4, 123, 0)[0]
    assert float(a[0, 0]) == float(w0 >> 8) * 2.0 ** -24


def test_uniform_empty_launches_nothing():
    before = rand_ops.launches
    out = rand_ops.uniform(7, 0, (0, 5), "cpu")
    assert out.shape == (0, 5) and out.dtype == torch.float32
    assert rand_ops.launches == before


def test_uniform_distribution():
    r = rand_ops.uniform(2024, 0, (1 << 20,), "cpu").double()
    assert float(r.min()) >= 0.0 and float(r.max()) < 1.0
    assert abs(float(r.mean()) - 0.5) < 2e-3
    assert abs(float(r.var()) - 1.0 / 12.0) < 1e-3
    hist = torch.histc(r, bins=64, min=0.0, max=1.0)
    expected = r.numel() / 64
    chi2 = float(((hist - expected) ** 2 / expected).sum())
    assert chi2 < 130.0  # 63 degrees of freedom, p ~ 1e-6


def test_cpu_wrappers_take_plain_versions(rng):
    before = dict(hsq_ops.launches), rand_ops.launches
    cb = torch.from_numpy(_codebook(rng, 64, 16))
    u, c = hsq_ops.hsq_encode_flat(torch.randn(2, 160), cb, 16, 1)
    hsq_ops.hsq_decode_mean(c, u, cb, 16, 1)
    hsq_ops.hsq_decode_flat(c, u, cb, 16, 1)
    rand_ops.uniform(1, 0, (3,), "cpu")
    assert (dict(hsq_ops.launches), rand_ops.launches) == before


def test_encode_kernel_covers_the_flat_envelope():
    """Every (dim, K) of gqx's flat layout that the kernel's dims take, K a
    power of two, fits the encode kernel's shared memory; and a user's row
    of a (U, M*dim) unit starts on the kernel's load alignment whenever the
    unit does."""
    from gqx_torch.ops.hsq_prep import supports_flat

    for dim in hsq_ops.KERNEL_DIMS:
        ks = [2 ** b for b in range(1, 14) if supports_flat(dim, 2 ** b)]
        assert ks and max(ks) == 8192 // (128 // dim)
        for k in ks:
            assert hsq_ops.encode_smem_bytes(k, dim) <= hsq_ops.MAX_SMEM
        for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
            align = hsq_ops.encode_alignment(dim, dtype)
            assert align == min(4 if size == 2 else 16, dim // 4 * size)
            assert (dim * size) % align == 0
    # 8 bytes per 8 codewords, k-step and lane: dim 16, K 256 -> 8 KB; dim 32 two steps
    assert hsq_ops.encode_smem_bytes(256, 16) == 8192
    assert hsq_ops.encode_smem_bytes(2048, 32) == 131072
    assert hsq_ops.encode_smem_bytes(13, 8) == 512
