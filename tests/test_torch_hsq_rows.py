"""gqx_torch's row-major HSQ encode/decode (``ops/hsq_rows.py``) and the
HSQ compressor outside the flat-layout envelope, against gqx's
``ops/pallas_hsq.py`` kernels in Pallas interpret mode on the same numpy
inputs.  On the CPU the port's wrappers compute their plain versions.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqx.ops.pallas_hsq as gqx_rows
from gqx.compress import make_compressor as gqx_make
from gqx.config import GQConfig as GqxConfig
from gqx_torch.compress import make_compressor
from gqx_torch.config import GQConfig
from gqx_torch.codebooks import get_codebook
from gqx_torch.ops import hsq_rows
from gqx_torch.ops.hsq_prep import split_bf16_3


def _codebook(rng, k, dim):
    """Unit codewords in raw float32 (not bf16-representable)."""
    cb = rng.standard_normal((k, dim)).astype(np.float32)
    return cb / np.linalg.norm(cb, axis=1, keepdims=True)


def _top2_margin(rows, cb):
    p = np.abs(rows.astype(np.float64) @ cb.astype(np.float64).T)
    top = np.sort(p, axis=1)[:, -2:]
    return (top[:, 1] - top[:, 0]) / np.maximum(top[:, 1], 1e-30)


@pytest.mark.parametrize("k", [64, 1024])
@pytest.mark.parametrize("dim", [8, 16, 24, 40, 256, 512])
def test_rows_encode_decode_match_pallas_kernel(rng, dim, k):
    m = 700
    cb = _codebook(rng, k, dim)
    rows = rng.standard_normal((m, dim)).astype(np.float32)
    rows[:3] = 0.0                                   # zero rows: code 0, u 0
    u_j, c_j = gqx_rows.hsq_encode(jnp.asarray(rows), jnp.asarray(cb), tile_m=256,
                                   interpret=True)
    u_j, c_j = np.array(u_j), np.array(c_j)
    u_t, c_t = hsq_rows.hsq_encode(torch.from_numpy(rows), torch.from_numpy(cb))
    assert u_t.dtype == torch.float32 and c_t.dtype == torch.int32
    u_t, c_t = u_t.numpy(), c_t.numpy()
    np.testing.assert_array_equal(c_t[:3], 0)
    np.testing.assert_array_equal(u_t[:3], 0.0)

    # the two packages sum the dim fp32 products in different orders, so a
    # code may differ only where the top two |p| are within 1e-5 relative
    differ = c_t != c_j
    assert np.all(_top2_margin(rows, cb)[differ] <= 1e-5)
    # u: 1e-6 relative to the summed magnitudes |x| . |c| (a sum of dim
    # products rounded in another order)
    mag = (np.abs(rows) @ np.abs(cb).T)[np.arange(m), c_j]
    assert np.all(np.abs(u_t - u_j)[~differ] <= 1e-6 * mag[~differ])

    # decode: one fp32 product per element, exact
    want = np.asarray(gqx_rows.hsq_decode(jnp.asarray(c_j), jnp.asarray(u_j), jnp.asarray(cb),
                                          tile_m=256, interpret=True))
    got = hsq_rows.hsq_decode(torch.from_numpy(c_j), torch.from_numpy(u_j),
                              torch.from_numpy(cb)).numpy()
    assert got.shape == (m, dim)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(gqx_rows.hsq_decode_xla(
        jnp.asarray(c_j), jnp.asarray(u_j), jnp.asarray(cb))))


def test_rows_encode_tie_takes_first_index():
    """argmax |p| with the first index: p = [-3, 3] gives code 0 and u = -3,
    where the flat-layout encode's ``pos >= -neg`` rule gives code 1."""
    cb = np.zeros((4, 8), np.float32)
    cb[0, 0], cb[1, 0], cb[2, 1], cb[3, 1] = -1.0, 1.0, 0.5, 0.5
    rows = np.zeros((3, 8), np.float32)
    rows[0, 0] = 3.0            # p = [-3, 3, 0, 0]
    rows[1, 1] = -2.0           # p = [0, 0, -1, -1]: the first of an equal pair
    rows[2, 0] = -3.0           # p = [3, -3, 0, 0]
    u_j, c_j = gqx_rows.hsq_encode(jnp.asarray(rows), jnp.asarray(cb), interpret=True)
    for dtype in (torch.int32, torch.uint8):
        u_t, c_t = hsq_rows.hsq_encode(torch.from_numpy(rows), torch.from_numpy(cb), dtype)
        assert c_t.dtype == dtype
        np.testing.assert_array_equal(c_t.numpy(), [0, 2, 0])
        np.testing.assert_array_equal(u_t.numpy(), [-3.0, -1.0, 3.0])
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))


def test_rows_batched_equals_per_user(rng):
    cb = torch.from_numpy(_codebook(rng, 64, 24))
    rows = torch.from_numpy(rng.standard_normal((3, 50, 24)).astype(np.float32))
    before = dict(hsq_rows.launches)
    u, c = hsq_rows.hsq_encode(rows, cb)
    dec = hsq_rows.hsq_decode(c, u, cb)
    assert u.shape == c.shape == (3, 50) and dec.shape == (3, 50, 24)
    for i in range(3):
        ui, ci = hsq_rows.hsq_encode(rows[i], cb)
        assert torch.equal(ui, u[i]) and torch.equal(ci, c[i])
        assert torch.equal(hsq_rows.hsq_decode(ci, ui, cb), dec[i])
    assert hsq_rows.launches == before       # CPU tensors take the plain versions


@pytest.fixture
def interpret_rows_kernels(monkeypatch):
    """gqx's compressor calls its row-major kernels without ``interpret``."""
    for name in ("hsq_encode", "hsq_decode"):
        monkeypatch.setattr(gqx_rows, name,
                            functools.partial(getattr(gqx_rows, name), interpret=True))


@pytest.mark.parametrize("c_dim,k_bit,size", [(8, 10, 8 * 900), (16, 6, 24 * 301),
                                              (256, 8, 256 * 300), (512, 6, 512 * 40)])
def test_hsq_compressor_rows_path_matches_gqx(rng, interpret_rows_kernels, c_dim, k_bit, size):
    """A large codebook (dim 8, K 1024), a ragged size (dim 24) and the wide
    route's dims (256, K 256; 512, K 64): compress, decompress,
    decompress_batch and decode_mean against gqx with ``use_pallas=True``
    and ``random=False``."""
    users = 3
    kw = dict(quantizer="hsq", c_dim=c_dim, k_bit=k_bit, n_bit=6, random=False, hsq_passes=1)
    gcfg = GqxConfig(**kw)
    gcfg.use_pallas = True
    gq = gqx_make("hsq", size, (size,), gcfg)
    pt = make_compressor("hsq", size, (size,), GQConfig(**kw))
    assert not gq.flat_ok and not pt.flat_ok
    assert (pt.dim, pt.K, pt.M) == (gq.dim, gq.K, gq.M)
    # the raw codebook, not the bf16-rounded one
    assert pt.codewords.numpy().tobytes() == np.asarray(gq.codewords).tobytes()
    assert pt.code_dtype == (torch.int32 if k_bit > 8 else torch.uint8)
    g = rng.standard_normal((users, size)).astype(np.float32)
    g[1] *= 1e-3

    sig_j = gq.compress_batch(jnp.asarray(g), None)
    sig_t = pt.compress_batch(torch.from_numpy(g), None)
    assert sig_t["codes"].dtype == pt.code_dtype
    codes_j = np.asarray(sig_j["codes"]).astype(np.int64)
    differ = sig_t["codes"].numpy().astype(np.int64) != codes_j
    assert differ.sum() <= 2                          # near-tie codes only
    l_j, l_t = np.asarray(sig_j["u"]["l"]), sig_t["u"]["l"].numpy()
    level = (l_t != l_j) & ~differ
    assert level.sum() <= 2                           # u on a level boundary
    np.testing.assert_allclose(sig_t["u"]["lower"].numpy().reshape(-1),
                               np.asarray(sig_j["u"]["lower"]).reshape(-1), rtol=1e-6)

    # decode of gqx's own signature: exact (one product per element)
    sig_same = {"codes": torch.from_numpy(np.array(sig_j["codes"])),
                "u": {k: torch.from_numpy(np.array(v)) for k, v in sig_j["u"].items()}}
    dec_j = np.asarray(gq.decompress_batch(sig_j))
    dec_t = pt.decompress_batch(sig_same)
    np.testing.assert_array_equal(dec_t.numpy(), dec_j)
    one = {"codes": sig_same["codes"][1], "u": {k: v[1] for k, v in sig_same["u"].items()}}
    assert torch.equal(pt.decompress(one), dec_t[1])
    # decode_mean: the mean over users, summed in another order (1e-6 of the
    # summed magnitudes)
    mean_j = np.asarray(gq.decode_mean(sig_j))
    mean_t = pt.decode_mean(sig_same).numpy()
    assert np.all(np.abs(mean_t - mean_j) <= 1e-6 * np.abs(dec_j).mean(0) + 1e-30)

    # the port's own round trip differs from gqx's only on flipped subvectors
    rt = pt.roundtrip_batch(torch.from_numpy(g), None).numpy()
    bad = ~np.isclose(rt, dec_j, rtol=1e-5, atol=1e-8).reshape(users, pt.M, pt.dim).all(2)
    assert not np.any(bad & ~(differ | level))
    single = pt.roundtrip(torch.from_numpy(g[2]), None).numpy()
    np.testing.assert_array_equal(single, rt[2])


# -- the tensor-core route's arithmetic, and bf16 rows -------------------------

def _split_cases(rng):
    """float32 values for the three-piece split: random over many binades,
    +-0, powers of two, values next to bf16 rounding boundaries (halfway
    points and their float32 neighbours), and large and tiny exponents
    inside the exact range (2^-110 up to the largest bf16)."""
    rand = (rng.standard_normal(4096) * 2.0 ** rng.integers(-60, 60, 4096)).astype(np.float32)
    zeros = np.array([0.0, -0.0], np.float32)
    powers = np.ldexp(np.float32(1.0), np.arange(-110, 128)).astype(np.float32)
    powers = np.concatenate([powers, -powers])
    # bf16 keeps 8 significand bits: a float32 whose low 16 bits are 0x8000 is
    # halfway between two bf16 values
    base = rng.integers(0x0C800000, 0x7F000000, 2048, dtype=np.uint32) & np.uint32(0xFFFF0000)
    half = base | np.uint32(0x8000)
    bounds = np.concatenate([half, half - 1, half + 1, base | np.uint32(0x7FFF),
                             base | np.uint32(0xFFFF)]).view(np.float32)
    bounds = np.concatenate([bounds, -bounds])
    extremes = np.array([2.0 ** -110, 1.5 * 2.0 ** -110, 3.3895314e38, -3.3895314e38,
                         1.2345678e-33, 1e-30, 7e37], np.float32)
    return np.concatenate([rand, zeros, powers, bounds, extremes])


def _is_bf16(t):
    return torch.equal(t, t.to(torch.bfloat16).to(torch.float32))


def test_split_bf16_3_is_exact(rng):
    """h + m + l == x in float64, each piece bf16-representable, |m| <= 2^-8
    |x| and |l| <= 2^-16 |x|, on the values the kernel may split."""
    x = torch.from_numpy(_split_cases(rng))
    h, m, l = split_bf16_3(x)
    assert all(_is_bf16(p) for p in (h, m, l))
    assert torch.equal(h.double() + m.double() + l.double(), x.double())
    assert bool((m.abs() <= 2.0 ** -8 * x.abs()).all())
    assert bool((l.abs() <= 2.0 ** -16 * x.abs()).all())
    # -0 keeps its sign in h; a bf16 value is its own h
    assert torch.equal(split_bf16_3(torch.tensor([-0.0]))[0].view(torch.int32),
                       torch.tensor([-0.0]).view(torch.int32))
    xb = x[torch.isfinite(x.to(torch.bfloat16))].to(torch.bfloat16).to(torch.float32)
    hb, mb, lb = split_bf16_3(xb)
    assert torch.equal(hb, xb) and not bool(mb.any()) and not bool(lb.any())


@pytest.mark.parametrize("dim", [5, 8, 24, 32, 64, 256, 512])
def test_tensor_core_passes_within_tolerance(rng, dim):
    """The products the tensor-core kernels sum, in float64: for bf16 rows
    the three passes x.c_h + x.c_m + x.c_l equal x.c exactly, product by
    product (and, up to dim 32, where float64 sums them exactly, sum by
    sum); for float32 rows the six kept passes (mm, hl, lh, hm, mh, hh) miss
    x.c by less than 2^-23 of |x|.|c|, far inside the 1e-6 the kernels are
    held to."""
    cb = torch.from_numpy(_codebook(rng, 64, dim))
    rows = torch.from_numpy((rng.standard_normal((500, dim)) *
                             2.0 ** rng.integers(-30, 30, (500, 1))).astype(np.float32))
    exact = rows.double() @ cb.double().t()
    mag = rows.double().abs() @ cb.double().abs().t()
    c = [p.double() for p in split_bf16_3(cb)]
    xb = rows.to(torch.bfloat16).to(torch.float32)
    for k0 in range(0, 64, 8):                  # (rows, 8 codewords, dim) at a time
        prods = [xb.double()[:, None] * p[None, k0:k0 + 8] for p in c]
        assert torch.equal(prods[0] + prods[1] + prods[2],
                           xb.double()[:, None] * cb.double()[None, k0:k0 + 8])
    if dim <= 32:
        three = sum(xb.double() @ p.t() for p in c)
        assert torch.equal(three, xb.double() @ cb.double().t())
    x = [p.double() for p in split_bf16_3(rows)]
    kept = [(1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)]      # (x piece, c piece), h m l
    six = sum(x[i] @ c[j].t() for i, j in kept)
    assert bool(((six - exact).abs() <= 2.0 ** -23 * mag).all())


def _round_toward_zero(t):
    """float64 -> float32, rounded toward zero."""
    r = t.float()
    return torch.where(r.double().abs() > t.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _wide_route_products(rows, cb, two_sets):
    """The wide route's products (``csrc/hsq_rows_encode_wide.cu``),
    modelled: per k16 step of the dims, each kept pass's 16 exact products
    added to its accumulator in one sum rounded toward zero, as the tensor
    cores round; the passes smallest first, (h, h) into one set and the
    smaller ones into a second, the two added in float32 at the end
    (``two_sets``), or all into one set."""
    c = split_bf16_3(cb)
    if rows.dtype == torch.bfloat16:
        x, kept = (rows.float(),), [(0, 2), (0, 1), (0, 0)]
    else:
        x, kept = split_bf16_3(rows), [(1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)]
    big = torch.zeros(rows.shape[0], cb.shape[0])
    small = torch.zeros_like(big)
    for e in range(0, rows.shape[1], 16):
        for i, j in kept:
            step = x[i][:, e:e + 16].double() @ c[j][:, e:e + 16].double().t()
            if two_sets and (i, j) != (0, 0):
                small = _round_toward_zero(small.double() + step)
            else:
                big = _round_toward_zero(big.double() + step)
    return big + small


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [256, 512])
def test_wide_route_two_accumulator_sets_keep_codes_off_near_ties(rng, dim, dtype):
    """The wide route's accumulation under the tensor cores' truncation
    (``_wide_route_products``), on rows over 2^-20..2^20 and on near-ties
    (the 400 of 8,000 rows c_i + c_j plus noise, cast to the input type,
    whose top two |p| lie closest): with two accumulator sets, the plan the
    kernel takes, every |p| lies within 2.5e-6 of the row's largest |p| of
    its float64 value, so a code can differ from the exact argmax only where
    the top two |p| are within 1e-5 relative, and none differs elsewhere; on
    average one set errs at least twice as much."""
    k = 256
    cb = torch.from_numpy(get_codebook(dim, k))

    def margins(x):
        top = (x.double() @ cb.double().t()).abs().topk(2, dim=1).values
        return (top[:, 0] - top[:, 1]) / top[:, 0]

    n = 8000
    i, j = rng.integers(0, k, n), rng.integers(0, k, n)
    j = np.where(i == j, (j + 1) % k, j)
    noise = rng.standard_normal((n, dim)) * 10.0 ** rng.uniform(-8, -3, (n, 1)) / np.sqrt(dim)
    near = torch.from_numpy((cb.numpy()[i] + cb.numpy()[j] + noise).astype(np.float32)).to(dtype)
    near = near[margins(near).argsort()[:400]]
    rand = rng.standard_normal((600, dim)) * 2.0 ** rng.uniform(-20, 20, (600, 1))
    rows = torch.cat([torch.from_numpy(rand.astype(np.float32)).to(dtype), near])
    exact = rows.double() @ cb.double().t()
    top = exact.abs().amax(1)
    margin = margins(rows)
    assert int((margin <= 1e-5).sum()) >= 100            # the near-ties are there
    err = {}
    for two in (True, False):
        p = _wide_route_products(rows, cb, two).double()
        err[two] = (p - exact).abs().amax(1) / top
        if two:
            assert float(err[two].max()) <= 2.5e-6
            differ = p.abs().argmax(1) != exact.abs().argmax(1)
            assert bool((margin[differ] <= 1e-5).all())
    assert float(err[False].mean()) >= 2 * float(err[True].mean())


@pytest.mark.parametrize("k", [7, 1024])
@pytest.mark.parametrize("dim", [8, 24])
def test_rows_encode_bf16_rows_equal_their_float32_cast(rng, dim, k):
    """bf16 rows go to the plain version as they are: it widens them, so it
    gives the bits it gives on their float32 cast, and agrees with gqx's
    kernel (interpret mode) on that cast under the usual tolerance."""
    cb = _codebook(rng, k, dim)
    rows = torch.from_numpy(rng.standard_normal((2, 300, dim)).astype(np.float32))
    rows[:, 0] = 0.0
    rb = rows.to(torch.bfloat16)
    before = dict(hsq_rows.launches), dict(hsq_rows.launches_by_route)
    u_b, c_b = hsq_rows.hsq_encode(rb, torch.from_numpy(cb))
    u_f, c_f = hsq_rows.hsq_encode(rb.to(torch.float32), torch.from_numpy(cb))
    assert (dict(hsq_rows.launches), dict(hsq_rows.launches_by_route)) == before
    assert torch.equal(u_b, u_f) and torch.equal(c_b, c_f)
    cast = rb.to(torch.float32).numpy().reshape(-1, dim)
    u_j, c_j = gqx_rows.hsq_encode(jnp.asarray(cast), jnp.asarray(cb), tile_m=256, interpret=True)
    u_j, c_j = np.array(u_j), np.array(c_j)
    u_t, c_t = u_b.numpy().reshape(-1), c_b.numpy().reshape(-1)
    differ = c_t != c_j
    assert np.all(_top2_margin(cast, cb)[differ] <= 1e-5)
    mag = (np.abs(cast) @ np.abs(cb).T)[np.arange(len(cast)), c_j]
    assert np.all(np.abs(u_t - u_j)[~differ] <= 1e-6 * mag[~differ])


def test_compress_batch_takes_bf16_rows_as_they_are(rng, monkeypatch):
    """A bf16 unit outside the flat layout (dim 8, K 1024) reaches the
    row-major encode without a float32 copy; the signature is the one the
    float32 copy gave."""
    size = 8 * 900
    cfg = GQConfig(quantizer="hsq", c_dim=8, k_bit=10, n_bit=6, random=True, hsq_passes=1)
    pt = make_compressor("hsq", size, (size,), cfg)
    assert not pt.flat_ok
    g = torch.from_numpy(rng.standard_normal((3, size)).astype(np.float32)).to(torch.bfloat16)
    seen = []
    real = hsq_rows.hsq_encode

    def spy(rows, codebook, code_dtype=torch.int32):
        seen.append(rows.dtype)
        return real(rows, codebook, code_dtype)

    monkeypatch.setattr(hsq_rows, "hsq_encode", spy)
    sig_b = pt.compress_batch(g, torch.Generator().manual_seed(5))
    sig_f = pt.compress_batch(g.to(torch.float32), torch.Generator().manual_seed(5))
    assert seen == [torch.bfloat16, torch.float32]
    assert torch.equal(sig_b["codes"], sig_f["codes"])
    for key in sig_f["u"]:
        assert torch.equal(sig_b["u"][key], sig_f["u"][key])


def test_rows_encode_route_is_a_function_of_dtype_and_dim():
    """dims up to 32 on ``tensor_core``, every wider dim on
    ``tensor_core_wide``, with no cap."""
    wide = (33, 36, 256, 257, 512, 576)
    for dtype in (torch.bfloat16, torch.float32):
        assert [hsq_rows.route(dtype, d) for d in (1, 5, 8, 24, 32)] == [hsq_rows.TENSOR_CORE] * 5
        assert [hsq_rows.route(dtype, d) for d in wide] == [hsq_rows.TENSOR_CORE_WIDE] * 6
        with pytest.raises(ValueError):
            hsq_rows.route(dtype, 0)
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError):
            hsq_rows.route(dtype, 8)
    assert set(hsq_rows.launches_by_route) == {hsq_rows.TENSOR_CORE, hsq_rows.TENSOR_CORE_WIDE}
