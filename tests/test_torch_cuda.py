"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc, and skips without them.  The
file imports neither jax nor gqx, so it also runs where only the port is
installed; there, skip the repository's conftest (which sets up jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from gqx_torch.compress.sparse import TopKCompressor
from gqx_torch.ops import bn as bn_ops
from gqx_torch.ops import dw as dw_ops
from gqx_torch.ops import hsq as hsq_ops
from gqx_torch.ops import hsq_rows
from gqx_torch.ops import rand as rand_ops
from gqx_torch.ops.hsq_prep import bf16_exact_codebook
from gqx_torch.ops.pack import pack_uint, unpack_uint
from gqx_torch.scripts.rows_wide_probe import cuda_core_encode

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _codebook(seed, k, dim):
    """Unit codewords, bf16-exact, with an exact +v/-v pair (0, 1) and an
    equal pair (2, 3)."""
    cb = np.random.default_rng(seed).standard_normal((k, dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=1, keepdims=True)
    cb[0] = -cb[1]
    cb[3] = cb[2]
    return bf16_exact_codebook(cb)


def _encode_inputs(seed, cb, users, m):
    dim = cb.shape[1]
    x = np.random.default_rng(seed + 1).standard_normal((users, m, dim)).astype(np.float32)
    x[:, :4] = 0.0              # zero rows -> code 0, u 0
    x[:, 4] = cb[1]             # +v/-v tie: code 1, u > 0
    x[:, 5] = cb[0]             # code 0
    x[:, 6] = 2.0 * cb[3]       # equal pair: the first index, code 2
    x[:, 7] = -cb[3]            # negative side of the pair: code 2
    return x.reshape(users, m * dim)


def _encode_near_ties_only(x, cb, passes, c_kernel, c_plain):
    """Codes may differ only where the top two |p| of the row, as the plain
    version forms it (bf16 hi, plus the bf16 lo at passes=2), are within
    1e-5 relative; returns the rows where they agree."""
    differ = (c_kernel != c_plain).reshape(-1)
    if bool(differ.any()):
        rows = x.reshape(-1, cb.shape[1])[differ].float()
        hi = rows.bfloat16().float()
        p = hi.double() @ cb.double().t()
        if passes == 2:
            p = p + (rows - hi).bfloat16().double() @ cb.double().t()
        top = p.abs().topk(2, dim=1).values
        assert float(((top[:, 0] - top[:, 1]) / top[:, 0].clamp_min(1e-30)).max()) <= 1e-5
    return ~differ


# (dim, K, codes): every dim of the kernel at 64 and 256 codewords with uint8
# codes, and gqx's flat limit at dim 16 (K = 1024) with int32 codes
ENCODE_SHAPES = [(4, 64, torch.uint8), (8, 64, torch.uint8), (16, 64, torch.uint8),
                 (32, 64, torch.uint8), (4, 256, torch.uint8), (8, 256, torch.uint8),
                 (16, 256, torch.uint8), (32, 256, torch.uint8), (16, 1024, torch.int32)]


@pytest.mark.parametrize("users", [1, 3])
@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,k,code_dtype", ENCODE_SHAPES)
def test_cuda_kernels_match_plain(cuda_device, dim, k, code_dtype, dtype, passes, users):
    """The encode against its plain version (then the decode-mean and the
    uniforms on its output).  4,099 rows per user: not a multiple of the
    kernel's 64-row warp tile.  One user goes in as a 1-D vector."""
    m = 4099
    cb_np = _codebook(dim * k, k, dim)
    cb = torch.from_numpy(cb_np).to(cuda_device)
    x = torch.from_numpy(_encode_inputs(dim, cb_np, users, m)).to(cuda_device, dtype)
    x_in = x[0] if users == 1 else x
    before = dict(hsq_ops.launches), rand_ops.launches
    u, c = hsq_ops.hsq_encode_flat(x_in, cb, dim, passes, code_dtype)
    up, cp = hsq_ops.hsq_encode_flat_plain(x_in, cb, dim, passes, code_dtype)
    assert u.shape == c.shape == x_in.shape[:-1] + (m,) and c.dtype == code_dtype
    u, c, up, cp = (t.reshape(users, m) for t in (u, c, up, cp))
    assert torch.equal(c[:, :8].cpu(), torch.tensor([[0, 0, 0, 0, 1, 0, 2, 2]] * users,
                                                    dtype=code_dtype))
    assert bool((u[:, :4] == 0).all())
    assert int((c != cp).sum()) <= 2
    same = _encode_near_ties_only(x, cb, passes, c, cp).reshape(users, m)
    torch.testing.assert_close(u[same], up[same], rtol=1e-6, atol=0)
    # u is summed in the plain version's order: the same bits
    assert torch.equal(u[same], up[same])
    d = hsq_ops.hsq_decode_mean(c, u, cb, dim, passes)
    dp = hsq_ops.hsq_decode_mean_plain(c, u, cb, dim, passes)
    tol = 1e-6 * hsq_ops.hsq_decode_mean_plain(c, u.abs(), cb.abs(), dim, 2)
    assert bool(((d - dp).abs() <= tol).all())
    r = rand_ops.uniform(99, 5, (3, 70001), cuda_device)
    assert torch.equal(r, rand_ops.uniform_plain(99, 5, (3, 70001), cuda_device))
    assert rand_ops.uniform(99, 5, (0,), cuda_device).numel() == 0
    # one launch per wrapper call that had work, none for the plain versions
    assert hsq_ops.launches["hsq_encode"] == before[0]["hsq_encode"] + 1
    assert hsq_ops.launches["hsq_decode_mean"] == before[0]["hsq_decode_mean"] + 1
    assert rand_ops.launches == before[1] + 1


@pytest.mark.parametrize("dim,k,code_dtype,dtype,passes", [
    (16, 256, torch.uint8, torch.bfloat16, 1), (16, 256, torch.uint8, torch.float32, 2),
    (32, 1024, torch.int32, torch.float32, 1), (4, 64, torch.uint8, torch.bfloat16, 1)])
def test_cuda_encode_repeats_bits(cuda_device, dim, k, code_dtype, dtype, passes):
    """Two runs of the encode on the same input give the same bits."""
    cb = torch.from_numpy(_codebook(7, k, dim)).to(cuda_device)
    x = torch.from_numpy(_encode_inputs(8, cb.cpu().numpy(), 2, 30001)).to(cuda_device, dtype)
    u1, c1 = hsq_ops.hsq_encode_flat(x, cb, dim, passes, code_dtype)
    u2, c2 = hsq_ops.hsq_encode_flat(x, cb, dim, passes, code_dtype)
    assert torch.equal(c1, c2)
    assert torch.equal(u1.view(torch.int32), u2.view(torch.int32))


def _decode_mean_codes(rng, pattern, users, m, k):
    """(users, m) codes: random; all users on one code per subvector (one
    distinct code); or every user on its own (users distinct codes)."""
    if pattern == "random":
        return rng.integers(0, k, (users, m))
    base = rng.integers(0, k, m)
    step = np.arange(users)[:, None] if pattern == "distinct" else np.zeros((users, 1), np.int64)
    return (base[None] + step) % k


@pytest.mark.parametrize("users", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("k,code_dtype", [(64, torch.uint8), (256, torch.uint8),
                                          (1024, torch.int32)])
@pytest.mark.parametrize("dim", [4, 8, 16, 32])
def test_cuda_decode_mean_matches_plain(cuda_device, dim, k, code_dtype, passes, users):
    """The fused decode-mean against its plain version at 517, 4,096 and
    4,099 subvectors (ragged and misaligned rows: element loads; 4,096:
    vector loads, and element loads again with u starting 4 bytes off),
    for random codes, one code per subvector and all codes distinct; 8
    users take the kernel's fixed user count, the others its loop.  1e-6 of
    the summed magnitudes (only the order of the float32 additions of at
    most U terms differs), and two runs give the same bits."""
    rng = np.random.default_rng(dim * k + 10 * passes + users)
    cb = torch.from_numpy(_codebook(dim + k, k, dim)).to(cuda_device)
    for m, offset in ((517, 0), (4096, 0), (4096, 1), (4099, 0)):
        for pattern in ("random", "same", "distinct"):
            codes = torch.from_numpy(_decode_mean_codes(rng, pattern, users, m, k)).to(
                cuda_device, code_dtype)
            scales = rng.standard_normal((users, m)) * 10.0 ** rng.uniform(-4, 1, (users, m))
            flat = torch.zeros(users * m + offset, device=cuda_device)
            u = flat[offset:].view(users, m)
            u.copy_(torch.from_numpy(scales.astype(np.float32)))
            before = hsq_ops.launches["hsq_decode_mean"]
            got = hsq_ops.hsq_decode_mean(codes, u, cb, dim, passes)
            again = hsq_ops.hsq_decode_mean(codes, u, cb, dim, passes)
            want = hsq_ops.hsq_decode_mean_plain(codes, u, cb, dim, passes)
            tol = 1e-6 * hsq_ops.hsq_decode_mean_plain(codes, u.abs(), cb.abs(), dim, 2)
            assert hsq_ops.launches["hsq_decode_mean"] == before + 2
            assert got.shape == (m * dim,) and got.dtype == torch.float32
            assert bool(((got - want).abs() <= tol).all()), (m, offset, pattern)
            assert torch.equal(got, again)


def test_cuda_wrappers_refuse_bad_input(cuda_device):
    cb = torch.from_numpy(_codebook(1, 256, 16)).to(cuda_device)
    x = torch.randn(2, 320, device=cuda_device)
    with pytest.raises(ValueError):
        hsq_ops.hsq_encode_flat(x.t().contiguous().t(), cb, 16, 1)     # not contiguous
    with pytest.raises(ValueError):
        hsq_ops.hsq_encode_flat(x.double(), cb, 16, 1)
    with pytest.raises(ValueError):
        hsq_ops.hsq_encode_flat(x, cb.cpu(), 16, 1)                      # codebook elsewhere
    with pytest.raises(ValueError):
        hsq_ops.hsq_encode_flat(x.bfloat16().reshape(-1)[1:-15], cb, 16, 1)   # 4-byte loads, 2 B off
    with pytest.raises(ValueError):
        hsq_ops.hsq_encode_flat(x, torch.cat([cb] * 2), 16, 1)           # 512 codewords, uint8 codes
    u, c = hsq_ops.hsq_encode_flat(x, cb, 16, 1)
    with pytest.raises(ValueError):
        hsq_ops.hsq_decode_mean(c, u.double(), cb, 16, 1)


def test_cuda_small_norm_draw_launches_philox(cuda_device):
    """A unit below 65,536 values per user (an FCN unit) still draws its
    uniforms on the card, through the Philox kernel, bit-equal to the plain
    version under the same generator."""
    from gqx_torch.compress.api import stochastic_increment

    scaled = torch.linspace(0, 63.9, 2 * 1000, device=cuda_device).reshape(2, 1000)
    floored = scaled.to(torch.int32)
    before = rand_ops.launches
    inc = stochastic_increment(scaled, floored, torch.Generator().manual_seed(3))
    assert rand_ops.launches == before + 1
    assert inc.device.type == "cuda"
    want = stochastic_increment(scaled.cpu(), floored.cpu(), torch.Generator().manual_seed(3))
    assert torch.equal(inc.cpu(), want)


# -- per-user decode and the row-major kernels -------------------------------

@pytest.mark.parametrize("passes", [1, 2])
def test_cuda_decode_bit_equal_to_plain(cuda_device, passes):
    cb = torch.from_numpy(_codebook(2, 256, 16)).to(cuda_device)
    rng = np.random.default_rng(3)
    for shape in ((3, 5001), (5001,)):
        codes = torch.from_numpy(rng.integers(0, 256, shape).astype(np.int32)).to(cuda_device)
        u = torch.from_numpy((rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, 2, shape))
                             .astype(np.float32)).to(cuda_device)
        for c in (codes, codes.to(torch.uint8)):
            before = hsq_ops.launches["hsq_decode"]
            out = hsq_ops.hsq_decode_flat(c, u, cb, 16, passes)
            assert hsq_ops.launches["hsq_decode"] == before + 1
            assert out.shape == shape[:-1] + (5001 * 16,)
            assert torch.equal(out, hsq_ops.hsq_decode_plain(c, u, cb, 16, passes))
            assert hsq_ops.launches["hsq_decode"] == before + 1   # plain launches nothing


def _near_tie_only(rows, cb, c_kernel, c_plain):
    """Codes may differ only where the top two |p| are within 1e-5 relative."""
    differ = (c_kernel != c_plain).reshape(-1)
    if bool(differ.any()):
        p = (rows.reshape(-1, rows.shape[-1])[differ].double() @ cb.double().t()).abs()
        top = p.topk(2, dim=1).values
        assert float(((top[:, 0] - top[:, 1]) / top[:, 0].clamp_min(1e-30)).max()) <= 1e-5
    return ~differ


def _rows_codebook(rng, k, dim):
    """Unit codewords in raw float32 with exact ties: a +v/-v pair (0, 1);
    an equal pair in two lanes of a quad (2, 4); from K = 20 a -v in a later
    group of the same lane (3, 19) and an equal pair in one lane's group
    (5, 13); from K = 64 an equal pair across the codebook (6, K - 1), in
    another shared-memory K-tile where the codebook has several.  Returns
    the codebook and, per tie row of ``_rows_input``, its code."""
    cb = rng.standard_normal((k, dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=1, keepdims=True)
    cb[0] = -cb[1]
    cb[4] = cb[2]
    codes = [0, 0, 2]
    if k >= 20:
        cb[19] = -cb[3]
        cb[13] = cb[5]
        codes += [3, 5]
    if k >= 64:
        cb[k - 1] = cb[6]
        codes += [6]
    return cb, codes


def _rows_input(rng, cb, users, m):
    """(users, m, dim) float32 rows; the first ones meet the ties of
    ``_rows_codebook``: a zero row (code 0, u 0); 3 * c1 (p0 = -p1: code 0,
    u < 0); 2 * c4 (= 2 * c2: code 2); -c19 (= c3: code 3, u > 0); c13
    (= c5: code 5); c[K-1] (= c6: code 6)."""
    k, dim = cb.shape
    rows = rng.standard_normal((users, m, dim)).astype(np.float32)
    rows[:, 0] = 0.0
    rows[:, 1] = 3.0 * cb[1]
    rows[:, 2] = 2.0 * cb[4]
    if k >= 20:
        rows[:, 3] = -cb[19]
        rows[:, 4] = cb[13]
    if k >= 64:
        rows[:, 5] = cb[k - 1]
    return rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [7, 64, 1024, 4096])
@pytest.mark.parametrize("dim", [4, 5, 8, 16, 24, 32, 36])
def test_cuda_rows_kernels_match_plain(cuda_device, dim, k, dtype):
    """Both encode routes (dim <= 32 on ``tensor_core``, 36 on
    ``tensor_core_wide``), bf16 and float32 rows, K from 7 to 4096 (above shared memory:
    several K-tiles), 3,001 rows per user (not a multiple of 16 or of a
    warp's rows), and the exact ties of ``_rows_codebook``, which must give
    the first index."""
    rng = np.random.default_rng(dim * k)
    cb_np, tie_codes = _rows_codebook(rng, k, dim)
    cb = torch.from_numpy(cb_np).to(cuda_device)
    rows = torch.from_numpy(_rows_input(rng, cb_np, 2, 3001)).to(cuda_device, dtype)
    code_dtype = torch.uint8 if k <= 256 else torch.int32
    which = hsq_rows.route(dtype, dim)
    assert which == (hsq_rows.TENSOR_CORE if dim <= 32 else hsq_rows.TENSOR_CORE_WIDE)
    before, by_route = dict(hsq_rows.launches), dict(hsq_rows.launches_by_route)
    u, c = hsq_rows.hsq_encode(rows, cb, code_dtype)
    up, cp = hsq_rows.hsq_encode_plain(rows, cb, code_dtype)
    assert c.dtype == code_dtype and u.shape == c.shape == (2, 3001)
    n = len(tie_codes)
    assert torch.equal(c[:, :n].cpu(), torch.tensor([tie_codes] * 2, dtype=code_dtype))
    assert bool((u[:, 0] == 0).all()) and bool((u[:, 1] < 0).all())
    if k >= 20:
        assert bool((u[:, 3] > 0).all())
    same = _near_tie_only(rows, cb, c, cp).reshape(c.shape)
    mag = (rows.float().abs() @ cb.abs().t()).gather(2, cp.long()[..., None])[..., 0]
    assert bool(((u - up).abs()[same] <= 1e-6 * mag[same]).all())
    dec = hsq_rows.hsq_decode(c, u, cb)
    assert dec.shape == (2, 3001, dim)
    assert torch.equal(dec, hsq_rows.hsq_decode_plain(c, u, cb))
    u1, c1 = hsq_rows.hsq_encode(rows[1], cb, code_dtype)
    assert torch.equal(u1, u[1]) and torch.equal(c1, c[1])
    assert hsq_rows.launches == {"hsq_rows_encode": before["hsq_rows_encode"] + 2,
                                 "hsq_rows_decode": before["hsq_rows_decode"] + 1}
    assert hsq_rows.launches_by_route == {**by_route, which: by_route[which] + 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_rows_encode_routes_move_their_counts(cuda_device, dtype):
    """Each route's count moves by one per launch, the sum with it; two runs
    give the same bits."""
    rng = np.random.default_rng(11)
    for dim, which in ((8, hsq_rows.TENSOR_CORE), (40, hsq_rows.TENSOR_CORE_WIDE)):
        cb = torch.from_numpy(_rows_codebook(rng, 64, dim)[0]).to(cuda_device)
        rows = torch.from_numpy(rng.standard_normal((3, 517, dim)).astype(np.float32)).to(
            cuda_device, dtype)
        before, by_route = hsq_rows.launches["hsq_rows_encode"], dict(hsq_rows.launches_by_route)
        u1, c1 = hsq_rows.hsq_encode(rows, cb, torch.uint8)
        assert hsq_rows.launches_by_route == {**by_route, which: by_route[which] + 1}
        assert hsq_rows.launches["hsq_rows_encode"] == before + 1
        u2, c2 = hsq_rows.hsq_encode(rows, cb, torch.uint8)
        assert torch.equal(c1, c2) and torch.equal(u1.view(torch.int32), u2.view(torch.int32))


def _wide_codebook(rng, k, dim):
    """``_rows_codebook``'s ties where K allows them; K = 1: one random unit
    codeword (every row takes code 0)."""
    if k >= 7:
        return _rows_codebook(rng, k, dim)
    cb = rng.standard_normal((k, dim)).astype(np.float32)
    return cb / np.linalg.norm(cb, axis=1, keepdims=True), [0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 7, 256, 1024, 4096])
@pytest.mark.parametrize("dim", [33, 40, 64, 255, 256, 257, 512, 576])
def test_cuda_wide_rows_encode_matches_plain(cuda_device, dim, k, dtype):
    """The wide route (dims above 32): ragged dims (33, 255, 257: chunks
    zero-padded, bf16 rows of an odd dim copied value by value), K from 1
    to 4096 (codebooks of several 128-codeword tiles; int32 codes above
    256), bf16 and float32 rows scaled by 2^-20..2^20, two users, the exact
    ties of ``_rows_codebook`` (the first index), rows starting 2 or 4
    bytes off 16 (the narrower copies).  Codes may differ from the plain
    version only where the top two |p| are within 1e-5 relative, u within
    1e-6 of |x|.|c|; u bit-equal to ``hsq_rows_encode.cu``'s wherever the
    codes agree (dim <= 256, its cap); the same bits twice; one launch a
    call on ``tensor_core_wide``."""
    rng = np.random.default_rng(dim * 7 + k)
    cb_np, tie_codes = _wide_codebook(rng, k, dim)
    cb = torch.from_numpy(cb_np).to(cuda_device)
    rows_np = _rows_input(rng, cb_np, 2, 1500) if k >= 7 else \
        rng.standard_normal((2, 1500, dim)).astype(np.float32)
    rows_np[:, 0] = 0.0
    rows_np *= np.exp2(rng.integers(-20, 21, (2, 1500, 1))).astype(np.float32)
    rows = torch.from_numpy(rows_np).to(cuda_device, dtype)
    code_dtype = torch.uint8 if k <= 256 else torch.int32
    assert hsq_rows.route(dtype, dim) == hsq_rows.TENSOR_CORE_WIDE
    before, by_route = dict(hsq_rows.launches), dict(hsq_rows.launches_by_route)
    u, c = hsq_rows.hsq_encode(rows, cb, code_dtype)
    assert hsq_rows.launches_by_route == {
        **by_route, hsq_rows.TENSOR_CORE_WIDE: by_route[hsq_rows.TENSOR_CORE_WIDE] + 1}
    assert hsq_rows.launches["hsq_rows_encode"] == before["hsq_rows_encode"] + 1
    up, cp = hsq_rows.hsq_encode_plain(rows, cb, code_dtype)
    assert c.dtype == code_dtype and u.shape == c.shape == (2, 1500)
    n = len(tie_codes)
    assert torch.equal(c[:, :n].cpu(), torch.tensor([tie_codes] * 2, dtype=code_dtype))
    assert bool((u[:, 0] == 0).all())
    if k >= 7:
        assert bool((u[:, 1] < 0).all())
    same = _near_tie_only(rows, cb, c, cp).reshape(c.shape)
    mag = (rows.float().abs() @ cb.abs().t()).gather(2, cp.long()[..., None])[..., 0]
    assert bool(((u - up).abs()[same] <= 1e-6 * mag[same]).all())
    u2, c2 = hsq_rows.hsq_encode(rows, cb, code_dtype)
    assert torch.equal(c, c2) and torch.equal(u.view(torch.int32), u2.view(torch.int32))
    u1, c1 = hsq_rows.hsq_encode(rows[1], cb, code_dtype)
    assert torch.equal(u1, u[1]) and torch.equal(c1, c[1])
    if dim <= 256:
        uo, co = cuda_core_encode(rows, cb, code_dtype)
        agree = co == c
        assert torch.equal(uo[agree].view(torch.int32), u[agree].view(torch.int32))
    # rows starting 2 (bf16) or 4 (float32) bytes past a 16-byte boundary
    flat = torch.empty(rows.numel() + 8, dtype=dtype, device=cuda_device)
    off = flat[1:1 + rows.numel()].view(rows.shape)
    off.copy_(rows)
    uf, cf = hsq_rows.hsq_encode(off, cb, code_dtype)
    assert torch.equal(cf, c) and torch.equal(uf.view(torch.int32), u.view(torch.int32))


def test_cuda_decode_and_rows_refuse_bad_input(cuda_device):
    cb = torch.from_numpy(_codebook(1, 256, 16)).to(cuda_device)
    codes = torch.zeros((2, 64), dtype=torch.int32, device=cuda_device)
    u = torch.ones((2, 64), device=cuda_device)
    for decode in (lambda c, v, b: hsq_ops.hsq_decode_flat(c, v, b, 16, 1), hsq_rows.hsq_decode):
        with pytest.raises(ValueError):
            decode(codes.long(), u, cb)
        with pytest.raises(ValueError):
            decode(codes, u.double(), cb)
        with pytest.raises(ValueError):
            decode(codes.t().contiguous().t(), u, cb)            # not contiguous
        with pytest.raises(ValueError):
            decode(codes, u[:, :32], cb)                         # shapes differ
        with pytest.raises(ValueError):
            decode(codes, u, cb.cpu())                           # codebook elsewhere
    with pytest.raises(ValueError):
        hsq_ops.hsq_decode_flat(codes, u, cb, 16, 3)             # passes
    with pytest.raises(ValueError):
        hsq_ops.hsq_decode_flat(codes, u, cb, 8, 1)              # dim is not the codebook's
    rows = torch.randn(2, 20, 16, device=cuda_device)
    with pytest.raises(ValueError):
        hsq_rows.hsq_encode(rows.double(), cb)
    with pytest.raises(ValueError):
        hsq_rows.hsq_encode(rows[:, :, :8], cb)                  # not contiguous, wrong dim
    with pytest.raises(ValueError):
        hsq_rows.hsq_encode(rows, cb.cpu())
    with pytest.raises(ValueError):
        hsq_rows.hsq_encode(rows, torch.randn(300, 16, device=cuda_device), torch.uint8)
    # no dim cap: a dim-300 encode matches its plain version
    wide, cb300 = torch.randn(4, 300, device=cuda_device), torch.randn(8, 300, device=cuda_device)
    u, c = hsq_rows.hsq_encode(wide, cb300)
    up, cp = hsq_rows.hsq_encode_plain(wide, cb300)
    same = _near_tie_only(wide, cb300, c, cp)
    mag = (wide.abs() @ cb300.abs().t()).gather(1, cp.long()[:, None])[:, 0]
    assert bool(((u - up).abs()[same] <= 1e-6 * mag[same]).all())
    with pytest.raises(ValueError):    # the tensor-core route loads pairs: 2 bytes off
        flat = torch.randn(2 * 20 * 16 + 1, device=cuda_device, dtype=torch.bfloat16)
        hsq_rows.hsq_encode(flat[1:].view(2, 20, 16), cb)


def test_cuda_tensor_never_reaches_a_plain_version(cuda_device, monkeypatch):
    """A CUDA tensor launches the kernel; a CPU tensor computes the plain
    version and launches nothing."""
    cb = torch.from_numpy(_codebook(4, 64, 16)).to(cuda_device)
    rows = torch.randn(2, 100, 16, device=cuda_device)

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    real = {(mod, name): getattr(mod, name) for mod, name in (
        (hsq_ops, "hsq_encode_flat_plain"), (hsq_ops, "hsq_decode_plain"),
        (hsq_ops, "hsq_decode_mean_plain"), (hsq_rows, "hsq_encode_plain"),
        (hsq_rows, "hsq_decode_plain"), (dw_ops, "per_user_dw_plain"))}
    for mod, name in real:
        monkeypatch.setattr(mod, name, refuse)
    u, c = hsq_ops.hsq_encode_flat(rows.reshape(2, -1), cb, 16, 1)
    hsq_ops.hsq_decode_flat(c, u, cb, 16, 1)
    for users in (1, 2, 8):     # the decode-mean's specialised user counts and another
        hsq_ops.hsq_decode_mean(c[:1].expand(users, -1).contiguous(),
                                u[:1].expand(users, -1).contiguous(), cb, 16, 1)
    u, c = hsq_rows.hsq_encode(rows, cb, torch.uint8)
    hsq_rows.hsq_decode(c, u, cb)
    by_route = dict(dw_ops.launches_by_route)
    for ci, dtype in ((3, torch.bfloat16), (16, torch.bfloat16), (3, torch.float32),
                      (16, torch.float32)):
        x = torch.randn(4, ci, 8, 8, device=cuda_device, dtype=dtype)
        dw_ops.per_user_dw(x, torch.randn(4, 5, 8, 8, device=cuda_device, dtype=dtype),
                           2, 3, 3, 1, 1)
    # float32 with 3 channels takes the narrow float32 route: no path reaches CC
    assert dw_ops.launches_by_route == {k: v + (k != CC) for k, v in by_route.items()}
    torch.cuda.synchronize()
    for (mod, name), fn in real.items():
        monkeypatch.setattr(mod, name, fn)
    before = dict(hsq_ops.launches), dict(hsq_rows.launches)
    u, c = hsq_rows.hsq_encode(rows.cpu(), cb.cpu(), torch.uint8)
    hsq_rows.hsq_decode(c, u, cb.cpu())
    hsq_ops.hsq_decode_flat(c, u, cb.cpu(), 16, 2)
    assert (dict(hsq_ops.launches), dict(hsq_rows.launches)) == before


# -- the per-user conv weight gradient ----------------------------------------

def _dw_tolerance(x, dy, users, kh, kw, ph, pw):
    """The kernel and the plain version add the same float32 products (exact
    for bf16 operands) in different orders: sqrt(n) * 2^-23 of the summed
    magnitudes, n = B*H*W terms per sum."""
    n = x.shape[0] // users * x.shape[2] * x.shape[3]
    mag = dw_ops.per_user_dw_plain(x.abs(), dy.abs(), users, kh, kw, ph, pw)
    return (n ** 0.5) * 2.0 ** -23 * mag + 1e-30


TC, NW, CC = dw_ops.TENSOR_CORE, dw_ops.NARROW, dw_ops.CUDA_CORE
TF, NF = dw_ops.TENSOR_CORE_F32, dw_ops.NARROW_F32
F32 = torch.float32


@pytest.mark.parametrize("users,batch,ci,co,h,w,kh,kw,ph,pw,dtype,route", [
    (2, 4, 16, 32, 8, 8, 3, 3, 1, 1, torch.float32, TF),
    (2, 4, 3, 64, 32, 32, 3, 3, 1, 1, torch.bfloat16, NW),      # the stem: (ci, tap) columns
    (3, 5, 70, 65, 4, 4, 3, 3, 1, 1, torch.bfloat16, TC),       # ragged channel tiles, 4x4 plane
    (2, 3, 17, 9, 5, 7, 2, 2, 0, 1, torch.float32, TF),         # even window, uneven pads
    (1, 2, 5, 6, 6, 9, 5, 5, 3, 1, torch.bfloat16, NW),         # pads that are not (k-1)/2
    (2, 2, 8, 8, 3, 70, 1, 7, 0, 3, torch.float32, NF),         # rows of 70, a 1x7 window
    (8, 32, 64, 64, 1, 1, 3, 2, 2, 0, torch.bfloat16, TC),      # a 1x1 plane: only one tap is not zero
    (1, 64, 20, 20, 2, 2, 4, 6, 1, 2, torch.float32, TF),       # the batch split in many ranges
    # the narrow float32 route: fewer than 16 input channels, exact bf16 pieces
    (2, 4, 3, 64, 32, 32, 3, 3, 1, 1, F32, NF),                 # the stem
    (2, 3, 15, 20, 6, 6, 3, 3, 1, 1, F32, NF),                  # the widest input it takes
    (1, 4, 1, 8, 9, 7, 3, 7, 2, 5, F32, NF),                    # ci 1, kw 7, W = 7: 4-byte copies
    (1, 3, 3, 8, 33, 31, 3, 3, 1, 1, F32, NF),                  # 33 x 31: a piece of 33 rows
    (8, 32, 3, 64, 1, 1, 3, 3, 2, 0, F32, NF),                  # a 1x1 plane
    (1, 64, 8, 20, 5, 7, 5, 5, 1, 3, F32, NF),                  # 64 ranges, kw 5, pads (1, 3)
    (2, 3, 8, 24, 6, 70, 2, 2, 1, 0, F32, NF),                  # ci 8, W = 70, even window
    (8, 32, 3, 64, 32, 32, 3, 3, 1, 1, F32, NF),                # 8 users x 32 at the stem
    (2, 2, 15, 70, 7, 70, 7, 7, 3, 2, F32, NF),                 # 735 columns: 23 tiles; co 70
    (3, 5, 15, 16, 4, 4, 2, 1, 0, 0, F32, NF),                  # ci 15, kw 1
    # float32 on the tensor cores (exact bf16 pieces) where it is weakest
    (3, 5, 70, 65, 4, 4, 3, 3, 1, 1, F32, TF),                  # ragged channel tiles, 4x4 plane
    (8, 4, 64, 64, 4, 4, 3, 3, 1, 1, F32, TF),                  # W = 4: 13 rows a chunk
    (2, 3, 24, 70, 7, 7, 3, 3, 1, 1, F32, TF),                  # W = 7: 4-byte loads; co 70 ragged
    (2, 2, 24, 70, 7, 9, 5, 5, 3, 1, F32, TF),                  # kw = 5 (two groups of taps), pads (3, 1)
    (8, 32, 64, 64, 1, 1, 3, 2, 2, 0, F32, TF),                 # a 1x1 plane: only one tap is not zero
    (1, 64, 32, 16, 8, 8, 3, 3, 1, 1, F32, TF),                 # the batch split in 16 ranges
    (2, 2, 16, 8, 3, 200, 1, 7, 0, 3, F32, TF),                 # column chunks: a halo of data
    (2, 3, 20, 20, 5, 6, 2, 1, 1, 0, F32, TF),                  # kw = 1
    (2, 3, 16, 16, 6, 10, 3, 3, 1, 1, F32, TF),                 # W = 10: 8-byte loads
    # the tensor-core route where it is weakest
    (8, 4, 64, 64, 4, 4, 3, 3, 1, 1, torch.bfloat16, TC),       # W = 4: 4-pixel loads, 2 of 6 columns halo
    (2, 3, 24, 70, 7, 7, 3, 3, 1, 1, torch.bfloat16, TC),       # W = 7: 1-pixel loads; ci 24, co 70 ragged
    (2, 2, 24, 70, 7, 9, 5, 5, 3, 1, torch.bfloat16, TC),       # kw = 5 (two groups of taps), pads (3, 1)
    (1, 64, 32, 16, 8, 8, 3, 3, 1, 1, torch.bfloat16, TC),      # the batch split in 16 ranges
    (2, 2, 16, 8, 3, 200, 1, 7, 0, 3, torch.bfloat16, TC),      # column chunks: a halo of data
    (2, 3, 20, 20, 5, 6, 2, 1, 1, 0, torch.bfloat16, TC),       # kw = 1
    # the narrow route: bf16 with fewer than 16 input channels
    (1, 4, 1, 8, 9, 7, 3, 7, 2, 5, torch.bfloat16, NW),         # ci 1, kw 7, W = 7: 2-byte loads
    (8, 4, 3, 64, 32, 32, 3, 3, 1, 1, torch.bfloat16, NW),      # 8 users, 16-byte loads
    (2, 3, 8, 24, 6, 70, 2, 2, 1, 0, torch.bfloat16, NW),       # ci 8, W = 70, even window
    (2, 2, 15, 70, 7, 70, 7, 7, 3, 2, torch.bfloat16, NW),      # 735 columns: 23 tiles; co 70
    (8, 32, 3, 64, 1, 1, 3, 3, 2, 0, torch.bfloat16, NW),       # a 1x1 plane
    (1, 64, 8, 20, 5, 7, 5, 5, 1, 3, torch.bfloat16, NW),       # 64 ranges, kw 5, pads (1, 3)
    (3, 5, 15, 16, 4, 4, 2, 1, 0, 0, torch.bfloat16, NW),       # ci 15, kw 1
    (1, 3, 3, 8, 33, 31, 3, 3, 1, 1, torch.bfloat16, NW),       # 33 x 31: a piece of 33 rows
])
def test_cuda_per_user_dw_matches_plain(cuda_device, users, batch, ci, co, h, w, kh, kw, ph, pw,
                                        dtype, route):
    rng = np.random.default_rng(ci * co + h)
    x = torch.from_numpy(rng.standard_normal((users * batch, ci, h, w)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((users * batch, co, h, w)).astype(np.float32))
    _check_dw(x.to(cuda_device, dtype), dy.to(cuda_device, dtype), users, kh, kw, ph, pw, route)


@pytest.mark.parametrize("dtype", [torch.bfloat16, F32])
@pytest.mark.parametrize("users,batch,ci,co,hw", [
    # VGG-16: widening convs, and 512 channels on a 2x2 plane (2-pixel loads)
    (8, 4, 64, 128, 16), (8, 4, 128, 256, 8), (8, 4, 256, 512, 4), (8, 4, 512, 512, 2),
    (8, 32, 512, 512, 2),
    # DenseNet-BC: the 3 -> 24 stem, and 48 -> 12 (12 rows of a 64-row co
    # tile, 48 columns of a 64-column ci tile) at every plane
    (8, 4, 3, 24, 32), (8, 4, 48, 12, 32), (8, 4, 48, 12, 16), (8, 4, 48, 12, 8),
    (8, 32, 48, 12, 4)])
def test_cuda_per_user_dw_at_vgg_and_densenet_geometries(cuda_device, users, batch, ci, co, hw,
                                                         dtype):
    """The 3x3 SAME convs of VGG-16 and DenseNet-BC that no ResNet has, on
    the route each takes (narrow below 16 input channels, tensor cores
    above; bf16 or float32)."""
    rng = np.random.default_rng(ci * co + hw)
    x = torch.from_numpy(rng.standard_normal((users * batch, ci, hw, hw)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((users * batch, co, hw, hw)).astype(np.float32))
    route = dw_ops.route(dtype, ci, 3)
    assert route == ((TC if dtype == torch.bfloat16 else TF) if ci >= 16 else
                     (NW if dtype == torch.bfloat16 else NF))
    _check_dw(x.to(cuda_device, dtype), dy.to(cuda_device, dtype), users, 3, 3, 1, 1, route)


def test_cuda_per_user_dw_f32_mixed_magnitudes(cuda_device):
    """float32 on the tensor cores with x of mixed sign over 2^-20 .. 2^20
    (random significands, so no product ties) and every user's images in
    pairs whose dy nearly cancel: the pieces of small and large values, and
    sums far below their summed magnitudes."""
    users, batch, ci, co, h, w = 2, 6, 32, 24, 8, 8
    rng = np.random.default_rng(20)
    x = rng.standard_normal((users * batch, ci, h, w)) * 2.0 ** rng.uniform(-20, 20,
                                                                           (users * batch, ci, h, w))
    dy = rng.standard_normal((users * batch, co, h, w))
    dy[1::2] = -dy[0::2] * (1.0 + 2.0 ** -6 * rng.standard_normal((users * batch // 2, co, h, w)))
    x[1::2] = x[0::2]
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    dy = torch.from_numpy(dy.astype(np.float32)).to(cuda_device)
    _check_dw(x, dy, users, 3, 3, 1, 1, TF)


def test_cuda_per_user_dw_narrow_f32_mixed_magnitudes(cuda_device):
    """The narrow float32 route at the stem's 3 channels with x of mixed sign
    over 2^-20 .. 2^20 and every user's images in pairs whose dy nearly
    cancel, as the tensor-core case above."""
    users, batch, ci, co, h, w = 2, 6, 3, 64, 16, 16
    rng = np.random.default_rng(21)
    x = rng.standard_normal((users * batch, ci, h, w)) * 2.0 ** rng.uniform(-20, 20,
                                                                           (users * batch, ci, h, w))
    dy = rng.standard_normal((users * batch, co, h, w))
    dy[1::2] = -dy[0::2] * (1.0 + 2.0 ** -6 * rng.standard_normal((users * batch // 2, co, h, w)))
    x[1::2] = x[0::2]
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    dy = torch.from_numpy(dy.astype(np.float32)).to(cuda_device)
    _check_dw(x, dy, users, 3, 3, 1, 1, NF)


def test_cuda_core_baseline_matches_plain_at_the_stem(cuda_device):
    """per_user_dw.cu, the CUDA-core kernel that the float32 routes replaced
    and that is timed beside them, through its C entry at the float32 stem
    (8 users x 32, 3 -> 64 @32x32): within _dw_tolerance of the plain
    version, the same bits twice, and no launch counted."""
    from gqx_torch.scripts.dw_f32_probe import cuda_core_dw

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((256, 3, 32, 32)).astype(np.float32)).to(cuda_device)
    dy = torch.from_numpy(rng.standard_normal((256, 64, 32, 32)).astype(np.float32)).to(cuda_device)
    before = dw_ops.launches
    got = cuda_core_dw(x, dy, 8, 3, 3, 1, 1)
    want = dw_ops.per_user_dw_plain(x, dy, 8, 3, 3, 1, 1)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= _dw_tolerance(x, dy, 8, 3, 3, 1, 1)).all())
    assert torch.equal(got, cuda_core_dw(x, dy, 8, 3, 3, 1, 1))
    assert dw_ops.launches == before


def _check_dw(x, dy, users, kh, kw, ph, pw, route):
    """The kernel against its plain version (within _dw_tolerance), the
    library's weight gradient (1e-4) and itself (the same bits twice), on
    the route it must take."""
    n, ci, h, w = x.shape
    batch, co, dtype = n // users, dy.shape[1], x.dtype
    assert dw_ops.route(dtype, ci, kw) == route
    before, by_route = dw_ops.launches, dict(dw_ops.launches_by_route)
    got = dw_ops.per_user_dw(x, dy, users, kh, kw, ph, pw)
    assert dw_ops.launches == before + 1
    assert dw_ops.launches_by_route == {**by_route, route: by_route[route] + 1}
    want = dw_ops.per_user_dw_plain(x, dy, users, kh, kw, ph, pw)
    assert dw_ops.launches == before + 1                     # plain launches nothing
    assert got.shape == (users, co, ci, kh, kw) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= _dw_tolerance(x, dy, users, kh, kw, ph, pw)).all())
    # the library's weight gradient of the same convolution, user by user,
    # in float32 (cuDNN's TF32 would round the operands to 10 bits)
    xp = torch.nn.functional.pad(x.float(), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for u in range(users):
            sl = slice(u * batch, (u + 1) * batch)
            lib = torch.nn.grad.conv2d_weight(xp[sl], (co, ci, kh, kw), dy[sl].float())
            torch.testing.assert_close(got[u], lib, rtol=1e-4,
                                       atol=1e-4 * float(lib.abs().max()))
    # the split reduction is combined in a fixed order: the same bits again
    assert torch.equal(got, dw_ops.per_user_dw(x, dy, users, kh, kw, ph, pw))
    assert dw_ops.launches_by_route[route] == by_route[route] + 2


def test_cuda_per_user_dw_refuses_bad_input(cuda_device, monkeypatch):
    x = torch.randn(4, 3, 8, 8, device=cuda_device)
    dy = torch.randn(4, 5, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x, dy[:, :, :4], 2, 3, 3, 1, 1)               # not the input's size
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x, dy.to(torch.bfloat16), 2, 3, 3, 1, 1)      # mixed types
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x.double(), dy.double(), 2, 3, 3, 1, 1)
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x, dy, 3, 3, 3, 1, 1)                         # 4 images, 3 users
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x, dy, 2, 3, 3, 3, 1)                         # pad outside the window
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x.permute(0, 1, 3, 2), dy, 2, 3, 3, 1, 1)     # not contiguous
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x, dy.cpu(), 2, 3, 3, 1, 1)
    with pytest.raises(NotImplementedError):
        dw_ops.per_user_dw(x, dy, 2, 1, 9, 0, 4)
    with pytest.raises(NotImplementedError):   # rows whose staged pieces outgrow shared memory
        dw_ops.per_user_dw(torch.randn(2, 15, 7, 300, device=cuda_device),
                           torch.randn(2, 4, 7, 300, device=cuda_device), 1, 7, 7, 3, 3)
    monkeypatch.setattr(dw_ops, "per_user_dw_plain", None)   # a CUDA tensor never reaches it
    assert dw_ops.per_user_dw(x, dy, 2, 3, 3, 1, 1).shape == (2, 5, 3, 3, 3)
    xb = torch.randn(4, 16, 8, 8, device=cuda_device, dtype=torch.bfloat16)
    assert dw_ops.per_user_dw(xb, dy.bfloat16(), 2, 3, 3, 1, 1).shape == (2, 5, 16, 3, 3)


def test_cuda_folded_step_takes_the_kernel_and_matches_the_loop(cuda_device):
    """A folded float32 ResNet-18 step on the card launches the per-user
    weight gradient once per stride-1 3x3 conv (14: the stem's on the narrow
    float32 route, 13 on the float32 tensor-core route) and none in the loop; the
    two routes' gradients agree within 1e-3 of each leaf's norm (the card's
    convolution algorithms differ between batch 8 and batch 4)."""
    from gqx_torch.config import GQConfig
    from gqx_torch.models import create_model
    from gqx_torch.models.common import clear_batch_stats
    from gqx_torch.train import (create_train_state, folded_user_grads, make_train_step,
                                 user_grads)

    cfg = GQConfig(network="resnet18", quantizer="hsq", c_dim=16, k_bit=8, n_bit=6,
                   num_users=2, batch_size=4)
    gen = torch.Generator().manual_seed(0)
    model = create_model("resnet18", 10, "float32", gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "bn" in name and name.endswith("bias"):
                p.uniform_(1.0, 2.0, generator=gen)      # ReLU inputs away from 0
    state, plan = create_train_state(cfg, model, device="cuda")
    x = torch.randn(2, 4, 3, 32, 32, generator=gen).to(cuda_device)
    y = torch.randint(0, 10, (2, 4), generator=gen).to(cuda_device)
    before, by_route = dw_ops.launches, dict(dw_ops.launches_by_route)
    _, folded = folded_user_grads(model, plan, plan.names, x, y)
    assert dw_ops.launches == before + 14
    # float32: the stem on the narrow route, the 13 others on the tensor-core route
    assert dw_ops.launches_by_route == {**by_route, NF: by_route[NF] + 1, TF: by_route[TF] + 13}
    clear_batch_stats(model)
    _, looped = user_grads(model, plan.names, x, y)
    assert dw_ops.launches == before + 14
    for n in plan.names:
        want = looped[n].mean(0, keepdim=True).expand_as(looped[n]) if n == "linear.bias" \
            else looped[n]
        assert float((folded[n] - want).norm()) <= 1e-3 * float(want.norm()), n
    loss = make_train_step(cfg, plan)(state, x, y, 0.1, 5e-4, torch.Generator().manual_seed(1))
    assert dw_ops.launches == before + 28 and bool(torch.isfinite(loss))


# -- the wire format and top-k ------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 6, 7, 8, 13, 16, 32])
def test_cuda_pack_matches_cpu(cuda_device, bits):
    """The card packs the same 32-bit words as the CPU (int64 shifts masked to
    32 bits on both), and unpacks them bit-exactly; lengths on and off a
    period of the stream, up to a ResNet-50 HSQ unit's subvectors."""
    rng = np.random.default_rng(bits)
    for n in (1, 333, 1_470_464):
        vals = torch.from_numpy(rng.integers(0, 2 ** bits, n, dtype=np.int64))
        words = pack_uint(vals.to(cuda_device), bits)
        assert words.dtype == torch.int32 and words.device.type == "cuda"
        assert torch.equal(words.cpu(), pack_uint(vals, bits))
        assert torch.equal(unpack_uint(words, bits, n).cpu(), vals)


@pytest.mark.parametrize("kind", ["integers", "bf16"])
def test_cuda_topk_ties_match_cpu(cuda_device, kind):
    """top-k on the card keeps the CPU's indices among equal |v| (the lowest
    index first), so its values and its mean are the CPU's exactly."""
    rng = np.random.default_rng(3)
    shape = (8, 1 << 20)
    if kind == "integers":
        x = torch.from_numpy(rng.integers(-4, 5, shape).astype(np.float32))
    else:
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16().float()
    comp = TopKCompressor(shape[1], (shape[1],), 256)
    got = comp.compress_batch(x.to(cuda_device))
    want = comp.compress_batch(x)
    assert torch.equal(got["indices"].cpu(), want["indices"])
    assert torch.equal(got["values"].cpu(), want["values"])
    assert torch.equal(comp.decode_mean(got).cpu(), comp.decode_mean(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_max_pool_ties_match_cpu(cuda_device, dtype):
    """Max pooling (VGG, the CNN) on windows whose maxima tie, on positive
    values exact in bf16: the card's forward and its gradient equal the
    CPU's bit for bit (a tied window's gradient goes to its first maximum,
    as on the CPU and in gqx: tests/test_torch_zoo.py)."""
    from gqx_torch.models.common import max_pool

    rng = np.random.default_rng(7)
    levels = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
    x = torch.from_numpy(levels[rng.integers(0, 4, (64, 32, 9, 9))]).to(dtype)
    x[0, 0, :2, :2] = 1.5
    cot = torch.from_numpy(rng.standard_normal((64, 32, 4, 4)).astype(np.float32)).to(dtype)
    out = []
    for dev in ("cpu", cuda_device):
        xd = x.to(dev).requires_grad_(True)
        y = max_pool(xd, 2)
        dx, = torch.autograd.grad(y, xd, cot.to(dev))
        out.append((y.detach().cpu(), dx.cpu()))
    (y_cpu, dx_cpu), (y_card, dx_card) = out
    assert torch.equal(y_card, y_cpu) and torch.equal(dx_card, dx_cpu)
    assert int((dx_cpu[0, 0, :2, :2] != 0).sum()) == 1 and dx_cpu[0, 0, 0, 0] != 0


def test_cuda_kmeans_matches_cpu(cuda_device):
    """Lloyd on the card against the CPU in lockstep, at a small size through
    the check chip_smoke.py makes at 65,536 x 576 (``lloyd_lockstep``: each of
    5 iterations from the CPU's centroids; assignments differ only on
    near-ties, centroids by what a moved row moves).  A codebook trained on
    the card is finite float32."""
    import importlib.util
    import pathlib

    from gqx_torch.codebooks import kmeans

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    x = kmeans.unit_gaussian_samples(20_000, 24, torch.Generator().manual_seed(0), "cpu")
    c = x[torch.randperm(20_000, generator=torch.Generator().manual_seed(1))[:64]]
    differing, _, errs = chip_smoke.lloyd_lockstep(x, c, 5)
    assert len(differing) == len(errs) == 5
    cb = kmeans.train_codebook(24, 64, train_size=20_000, iters=5, device=cuda_device)
    assert cb.shape == (64, 24) and cb.dtype == np.float32 and np.isfinite(cb).all()


# -- the grouped batch norm ---------------------------------------------------

BN_EPS = 1e-5
BF16, F32 = torch.bfloat16, torch.float32


@functools.lru_cache(maxsize=None)
def _bn_planes(network):
    """(C, H, W) of ``network``'s batch norms, sorted."""
    from gqx_torch.models import create_model
    from gqx_torch.models.common import batch_norm_planes

    return sorted(batch_norm_planes(create_model(network, 10)))


# (users, images a user, C, H, W, dtype): every batch norm of the three cells
# (ResNet-50 at 32 and 16 users, VGG-16 at 64) and of DenseNet-BC (its
# concatenated channel counts), of ResNet-50's per-user loop (one user), of
# ResNet-50 and VGG-16 in float32 (whose 32x32 backward takes the two-pass
# route), and odd planes (H*W of 63, 6 and 1: accesses of 1 and 2 elements),
# a batch too large for shared memory, a ragged tile
BN_SHAPES = ([(32, 32) + s + (BF16,) for s in _bn_planes("resnet50")]
             + [(16, 32) + s + (BF16,) for s in _bn_planes("resnet50")]
             + [(64, 32) + s + (BF16,) for s in _bn_planes("vgg16")]
             + [(8, 32) + s + (BF16,) for s in _bn_planes("dense")]
             + [(1, 32) + s + (BF16,) for s in _bn_planes("resnet50")]
             + [(8, 32) + s + (F32,)
                for s in sorted(set(_bn_planes("resnet50")) | set(_bn_planes("vgg16")))]
             + [(3, 5, 7, 7, 9, BF16), (2, 3, 10, 3, 2, BF16), (2, 3, 5, 1, 1, F32),
                (2, 128, 8, 32, 32, BF16), (3, 4, 100, 4, 4, F32)])


def _bn_case(users, batch, c, h, w, dtype, seed, loc=0.5, scale=2.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (users * batch, c, h, w)
    x = (torch.randn(shape, generator=g, device="cuda") * scale + loc).to(dtype)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    weight = torch.rand(c, generator=g, device="cuda") + 0.5
    bias = torch.randn(c, generator=g, device="cuda")
    return x, dy, weight, bias


def _grouped(t, users):
    return t.float().reshape((users, -1) + tuple(t.shape[1:]))


def _bc(v):
    return v[:, None, :, None, None]


def _bn_forward_from(x, weight, bias, mean, inv, users):
    """y from the given statistics, op for op as the plain version (and the
    kernel) rounds it."""
    y = (_grouped(x, users) - _bc(mean)) * _bc(inv)
    return (y * weight[:, None, None] + bias[:, None, None]).to(x.dtype).reshape(x.shape)


def _bn_backward_from(x, dy, mean, var, inv, weight, s1, s2, users):
    """dx from the given sums, op for op as the kernel rounds it (the plain
    version's ``/ n`` may be a product by 1/n on the card: here a division,
    which is the same where n is a power of two)."""
    n = torch.tensor(float(x.numel() // (users * x.shape[1])), device=x.device)
    xc = _grouped(x, users) - _bc(mean)
    g1 = weight * inv
    g2 = s1 * g1 / n
    g5 = (var > 0).to(var.dtype) * -(s2 * g1 * inv) / n
    dx = _bc(g1) * _grouped(dy, users) - _bc(g2) + xc * _bc(g5)
    return dx.to(x.dtype).reshape(x.shape)


def _check_bn(x, dy, weight, bias, users, var_override=None):
    """The kernels against the plain version on the same inputs.

    Tolerances: the float32 sums (mean, E[x^2], s1, s2) add the same terms
    in other orders, each thread a run of at most 256, then a tree: within
    2e-5 of the summed magnitudes; var = E[x^2] - mean^2 within 6e-5 of
    E[x^2].  Given the kernel's own statistics, y and dx round exactly where
    the plain version rounds them (once to x's type at the end): the same
    bits.  inv is rsqrt(var + eps) within 2 float32 ulp.  The backward takes
    the kernel's forward statistics, with ``var_override`` put in where
    given (a clipped group whose x is not constant: its g5 term is off)."""
    y, mean, var, inv = bn_ops.grouped_bn_forward(x, weight, bias, users, BN_EPS)
    _, mean_p, var_p, _ = bn_ops.forward_plain(x, weight, bias, users, BN_EPS)
    xg = _grouped(x, users)
    assert bool(((mean - mean_p).abs() <= 2e-5 * xg.abs().mean(dim=(1, 3, 4))).all())
    assert bool(((var - var_p).abs() <= 6e-5 * (xg * xg).mean(dim=(1, 3, 4))).all())
    torch.testing.assert_close(inv, torch.rsqrt(var + BN_EPS), rtol=2.5e-7, atol=0)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert torch.equal(y, _bn_forward_from(x, weight, bias, mean, inv, users))
    if var_override is not None:
        var = var_override(var)
    dx, s2, s1 = bn_ops.grouped_bn_backward(x, dy, mean, var, inv, weight, users)
    _, s2_p, s1_p = bn_ops.backward_plain(x, dy, mean, var, inv, weight, users)
    dyg = _grouped(dy, users)
    assert bool(((s1 - s1_p).abs() <= 2e-5 * dyg.abs().sum(dim=(1, 3, 4))).all())
    xhat = (xg - _bc(mean)) * _bc(inv)
    assert bool(((s2 - s2_p).abs() <= 2e-5 * (dyg * xhat).abs().sum(dim=(1, 3, 4))).all())
    assert dx.dtype == x.dtype and dx.shape == x.shape
    assert torch.equal(dx, _bn_backward_from(x, dy, mean, var, inv, weight, s1, s2, users))
    return (y, mean, var, inv), (dx, s2, s1)


def _bn_route(x, users, backward):
    p = bn_ops.plan(x.shape[0] // users, x.shape[1], x.shape[2] * x.shape[3], x.dtype,
                    backward, bn_ops.block_smem(x.device.index))
    return f"{'backward' if backward else 'forward'}.{p.route}"


@pytest.mark.parametrize("users,batch,c,h,w,dtype", BN_SHAPES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_cuda_grouped_bn_matches_plain(cuda_device, users, batch, c, h, w, dtype):
    """Forward and backward against the plain version, at every batch-norm
    shape of the three cells and beside them; one launch each way, on the
    route the plan names (the cells' shapes: read once, from shared
    memory)."""
    x, dy, weight, bias = _bn_case(users, batch, c, h, w, dtype, seed=c * h + users)
    before = dict(bn_ops.launches_by_route)
    _check_bn(x, dy, weight, bias, users)
    fwd, bwd = _bn_route(x, users, False), _bn_route(x, users, True)
    assert bn_ops.launches_by_route == {k: v + (k == fwd) + (k == bwd)
                                        for k, v in before.items()}
    if (users, batch, dtype) in ((32, 32, BF16), (16, 32, BF16), (64, 32, BF16)):
        assert (fwd, bwd) == ("forward.smem", "backward.smem")


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cuda_grouped_bn_large_mean_and_clipped_groups(cuda_device, dtype):
    """A group whose |mean| is 64x its std (x centred element by element in
    s2: sum(dy * x) - mean * sum(dy) would miss s2's tolerance there), a
    constant group (var exactly 0, mean exact), and a group with x not
    constant whose var is given as 0 to the backward (its g5 term off)."""
    users, batch, c, h, w = 4, 32, 8, 16, 16
    x, dy, weight, bias = _bn_case(users, batch, c, h, w, dtype, seed=5)
    xg = x.view(users, batch, c, h, w)
    xg[0, :, 0] = 1.5
    xg[1, :, 1] = (512 + 8 * torch.randn((batch, h, w), device="cuda")).to(dtype)

    def clip(var):
        var = var.clone()
        var[2, 3] = 0.0
        return var

    (_, mean, var, _), (dx, s2, s1) = _check_bn(x, dy, weight, bias, users, clip)
    assert float(var[0, 0]) == 0.0 and float(mean[0, 0]) == 1.5 and float(var[1, 1]) > 0.0


def test_cuda_grouped_bn_repeats_bits(cuda_device):
    """Two runs on the same inputs give the same bits, on both routes."""
    for users, batch, c, h, w, dtype in [(32, 32, 64, 32, 32, BF16), (8, 32, 2048, 4, 4, BF16),
                                         (2, 32, 16, 32, 32, F32)]:
        x, dy, weight, bias = _bn_case(users, batch, c, h, w, dtype, seed=11)
        first = bn_ops.grouped_bn_forward(x, weight, bias, users, BN_EPS)
        again = bn_ops.grouped_bn_forward(x, weight, bias, users, BN_EPS)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        _, mean, var, inv = first
        first = bn_ops.grouped_bn_backward(x, dy, mean, var, inv, weight, users)
        again = bn_ops.grouped_bn_backward(x, dy, mean, var, inv, weight, users)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("users,c,h,w,dtype", [
    (32, 64, 32, 32, BF16), (16, 512, 4, 4, BF16), (8, 128, 16, 16, F32),
    (8, 2048, 4, 4, BF16), (4, 64, 32, 32, F32)], ids=lambda v: str(v).replace("torch.", ""))
def test_cuda_grouped_bn_folded_and_per_user_calls_agree_to_the_bit(cuda_device, users, c, h,
                                                                      w, dtype):
    """One call on all users' groups and one call a user (the per-user loop)
    give each group the same bits, forward and backward: the plan, which
    fixes the order of a group's sums, does not depend on the users (here
    with a tile of 32 channels at 4x4 even where one user's call fills 16 of
    the card's 132 multiprocessors, and on the two-pass route at float32
    32x32)."""
    x, dy, weight, bias = _bn_case(users, 32, c, h, w, dtype, seed=c + users)
    y, mean, var, inv = bn_ops.grouped_bn_forward(x, weight, bias, users, BN_EPS)
    dx, s2, s1 = bn_ops.grouped_bn_backward(x, dy, mean, var, inv, weight, users)
    for u in range(users):
        rows = slice(32 * u, 32 * (u + 1))
        one = bn_ops.grouped_bn_forward(x[rows], weight, bias, 1, BN_EPS)
        assert all(torch.equal(a, b) for a, b in zip(one, (y[rows], mean[u:u + 1],
                                                           var[u:u + 1], inv[u:u + 1])))
        one = bn_ops.grouped_bn_backward(x[rows], dy[rows], *one[1:], weight, 1)
        assert all(torch.equal(a, b) for a, b in zip(one, (dx[rows], s2[u:u + 1], s1[u:u + 1])))


def test_cuda_grouped_bn_narrows_to_the_alignment(cuda_device):
    """x one element into a larger buffer, so 2-byte aligned only: the
    accesses narrow from 8 elements to one, the results stay the plain
    version's."""
    x = torch.randn(8 * 3 * 5 * 8 + 1, device="cuda").to(BF16)[1:].view(8, 3, 5, 8)
    assert x.is_contiguous() and x.data_ptr() % 4
    dy = torch.randn(8, 3, 5, 8, device="cuda").to(BF16)
    _check_bn(x, dy, torch.rand(3, device="cuda") + 0.5, torch.randn(3, device="cuda"), 4)


def test_cuda_grouped_bn_refuses_bad_input(cuda_device):
    x, dy, weight, bias = _bn_case(2, 4, 6, 8, 8, F32, seed=1)
    _, mean, var, inv = bn_ops.grouped_bn_forward(x, weight, bias, 2, BN_EPS)
    fwd = functools.partial(bn_ops.grouped_bn_forward, eps=BN_EPS)
    for bad in (x.double(), x.half(), x.permute(0, 1, 3, 2), x[:, :, :, :4]):
        with pytest.raises(ValueError):                     # type, layout
            fwd(bad, weight, bias, 2)
    with pytest.raises(ValueError):
        fwd(x[0], weight, bias, 1)                          # not NCHW
    with pytest.raises(ValueError):
        fwd(x, weight, bias, 3)                             # 8 images, 3 users
    for w, b in ((weight[:5], bias), (weight, bias.double()), (weight.cpu(), bias)):
        with pytest.raises(ValueError):
            fwd(x, w, b, 2)
    bwd = bn_ops.grouped_bn_backward
    with pytest.raises(ValueError):
        bwd(x, dy[:, :5], mean, var, inv, weight, 2)        # dy of another shape
    with pytest.raises(ValueError):
        bwd(x, dy.to(BF16), mean, var, inv, weight, 2)      # mixed types
    with pytest.raises(ValueError):
        bwd(x, dy, mean[:1], var[:1], inv[:1], weight, 2)   # statistics of one user
    with pytest.raises(ValueError):
        bwd(x, dy, mean, var.t().contiguous().t(), inv, weight, 2)
    with pytest.raises(NotImplementedError):
        fwd(x[:0], weight, bias, 2)
    # dy in another layout is made contiguous: the same bits
    dyt = dy.transpose(2, 3).contiguous().transpose(2, 3)
    assert not dyt.is_contiguous()
    assert all(torch.equal(a, b) for a, b in zip(bwd(x, dyt, mean, var, inv, weight, 2),
                                                 bwd(x, dy, mean, var, inv, weight, 2)))


def test_cuda_tensor_never_reaches_the_plain_batch_norm(cuda_device, monkeypatch):
    """On the card the batch norm's forward and backward, as the models call
    them, launch the kernels and never the plain version; on the CPU the
    plain version runs and nothing launches."""
    from gqx_torch.models.common import BatchNorm
    from gqx_torch.models.folded import folded_users

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    real = bn_ops.forward_plain, bn_ops.backward_plain
    monkeypatch.setattr(bn_ops, "forward_plain", refuse)
    monkeypatch.setattr(bn_ops, "backward_plain", refuse)
    before, by_route = bn_ops.launches, dict(bn_ops.launches_by_route)
    for users, dtype, hw in ((2, BF16, 8), (1, BF16, 4), (2, F32, 32)):
        bn = BatchNorm(16).to(cuda_device)
        x = torch.randn(2 * 32, 16, hw, hw, device="cuda").to(dtype).requires_grad_(True)
        with folded_users(users) if users > 1 else contextlib.nullcontext() as ctx:
            y = bn(x)
        ghosts = [ctx.ghosts[bn.weight], ctx.ghosts[bn.bias]] if users > 1 else \
            [bn.weight, bn.bias]
        dx, dw, db = torch.autograd.grad(y.float().square().sum(), [x] + ghosts)
        assert dw.shape == db.shape == ((users, 16) if users > 1 else (16,))
    torch.cuda.synchronize()
    # float32 32x32 at 32 images a user: a group of 128 KB, twice that backward
    assert bn_ops.launches == before + 6
    assert bn_ops.launches_by_route == {
        **by_route, "forward.smem": by_route["forward.smem"] + 3,
        "backward.smem": by_route["backward.smem"] + 2,
        "backward.two_pass": by_route["backward.two_pass"] + 1}
    monkeypatch.setattr(bn_ops, "forward_plain", real[0])
    monkeypatch.setattr(bn_ops, "backward_plain", real[1])
    x = torch.randn(4, 3, 5, 5)
    y, mean, var, inv = bn_ops.grouped_bn_forward(x, torch.ones(3), torch.zeros(3), 2, BN_EPS)
    bn_ops.grouped_bn_backward(x, torch.randn(4, 3, 5, 5), mean, var, inv, torch.ones(3), 2)
    assert bn_ops.launches == before + 6


def test_cuda_folded_resnet50_step_takes_the_bn_kernels(cuda_device):
    """A folded bf16 ResNet-50 forward and backward launches each of its 53
    batch norms once each way, all read once from shared memory."""
    from gqx_torch.config import GQConfig
    from gqx_torch.models import create_model
    from gqx_torch.train import create_train_state, folded_user_grads

    cfg = GQConfig(network="resnet50", quantizer="hsq", c_dim=16, k_bit=8, n_bit=6,
                   num_users=4, batch_size=32, compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    model = create_model("resnet50", 10, "bfloat16", gen)
    _, plan = create_train_state(cfg, model, device="cuda")
    x = torch.randn(4, 32, 3, 32, 32, generator=gen).to(cuda_device)
    y = torch.randint(0, 10, (4, 32), generator=gen).to(cuda_device)
    before = dict(bn_ops.launches_by_route)
    _, grads = folded_user_grads(model, plan, plan.names, x, y)
    torch.cuda.synchronize()
    assert bn_ops.launches_by_route == {
        **before, "forward.smem": before["forward.smem"] + 53,
        "backward.smem": before["backward.smem"] + 53}
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
