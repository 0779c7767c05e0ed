"""The port's per-user conv weight gradient (its plain version, which is
what the wrapper computes on the CPU) against gqx's three routines on the
same numpy inputs: the shifted-slice einsum, the per-user vjp, and the
Pallas kernel in interpret mode.

gqx works in NHWC / HWIO, the port in NCHW / OIHW:
    x   (U*B, H, W, Ci)      -> (U*B, Ci, H, W)
    dy  (U*B, H, W, Co)      -> (U*B, Co, H, W)
    dW  (U, kh, kw, Ci, Co)  -> (U, Co, Ci, kh, kw)

Tolerance: every routine adds the same B*H*W float32 products per output
in its own order, so they may differ by a few float32 roundings of the
summed magnitudes: 1e-5 of sum |x| |dy| with float32 inputs (the products
are rounded too) and 2e-6 with bf16 inputs (the products are exact).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqx.ops.pallas_dw as gqx_dw
from gqx.models import folded as gqx_folded
from gqx_torch.ops import dw as dw_ops

# users, batch, h, w, ci, co, kh, kw, (ph, pw) low pads
CASES = {
    "3x3": (2, 4, 8, 8, 16, 32, 3, 3, (1, 1)),
    "stem_ci3": (2, 3, 8, 8, 3, 16, 3, 3, (1, 1)),
    "plane4x4": (3, 2, 4, 4, 8, 8, 3, 3, (1, 1)),
    "2x2_uneven": (2, 2, 6, 5, 4, 6, 2, 2, (0, 1)),
    "5x5": (1, 3, 7, 7, 5, 4, 5, 5, (2, 2)),
}


def _inputs(rng, case, dtype):
    users, batch, h, w, ci, co, kh, kw, (ph, pw) = CASES[case]
    x = rng.standard_normal((users * batch, h, w, ci)).astype(np.float32)
    dy = rng.standard_normal((users * batch, h, w, co)).astype(np.float32)
    if dtype == "bfloat16":   # bf16-exact values, so both packages see the same numbers
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        dy = np.asarray(jnp.asarray(dy).astype(jnp.bfloat16).astype(jnp.float32))
    padding = ((ph, kh - 1 - ph), (pw, kw - 1 - pw))
    return x, dy, padding


def _port(x, dy, case, dtype):
    users, _, _, _, _, _, kh, kw, (ph, pw) = CASES[case]
    t = getattr(torch, dtype)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(t)
    dyt = torch.from_numpy(np.ascontiguousarray(dy.transpose(0, 3, 1, 2))).to(t)
    got = dw_ops.per_user_dw(xt, dyt, users, kh, kw, ph, pw)      # CPU: the plain version
    assert got.dtype == torch.float32
    assert torch.equal(got, dw_ops.per_user_dw_plain(xt, dyt, users, kh, kw, ph, pw))
    mag = dw_ops.per_user_dw_plain(xt.abs(), dyt.abs(), users, kh, kw, ph, pw)
    return got.numpy(), mag.numpy()


def _to_port_layout(dku):
    return np.asarray(dku, dtype=np.float32).transpose(0, 4, 3, 1, 2)


def _check(got, want, mag, dtype):
    rel = 1e-5 if dtype == "float32" else 2e-6
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= rel * mag + 1e-30), float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_gqx_einsum(rng, case, dtype):
    users, _, _, _, ci, co, kh, kw, _ = CASES[case]
    x, dy, padding = _inputs(rng, case, dtype)
    k = jnp.zeros((kh, kw, ci, co), jnp.float32)     # float32 kernel: no final rounding
    want = gqx_folded._per_user_dw_einsum(jnp.asarray(x), jnp.asarray(dy), k, users,
                                          (1, 1), padding)
    got, mag = _port(x, dy, case, dtype)
    _check(got, _to_port_layout(want), mag, dtype)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_gqx_per_user_vjp(rng, case):
    """gqx's 'bgc' branch: one conv vjp per user slice."""
    users, _, _, _, ci, co, kh, kw, _ = CASES[case]
    x, dy, padding = _inputs(rng, case, "float32")
    k = jnp.zeros((kh, kw, ci, co), jnp.float32)
    xu = jnp.asarray(x).reshape((users, -1) + x.shape[1:])
    dyu = jnp.asarray(dy).reshape((users, -1) + dy.shape[1:])
    want = jax.vmap(lambda a, b: jax.vjp(
        lambda kk: gqx_folded._conv(a, kk, (1, 1), padding), k)[1](b)[0])(xu, dyu)
    got, mag = _port(x, dy, case, "float32")
    _check(got, _to_port_layout(want), mag, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["3x3", "stem_ci3", "plane4x4", "2x2_uneven"])
def test_plain_matches_gqx_pallas_kernel_interpreted(rng, monkeypatch, case, dtype):
    """gqx's TPU kernel, run on the CPU by giving its pallas_call
    interpret=True for the length of the test."""
    users, _, _, _, _, _, kh, kw, (ph, pw) = CASES[case]
    x, dy, _ = _inputs(rng, case, dtype)
    monkeypatch.setattr(gqx_dw.pl, "pallas_call",
                        functools.partial(gqx_dw.pl.pallas_call, interpret=True))
    jt = getattr(jnp, dtype)
    want = gqx_dw.per_user_dw.__wrapped__(jnp.asarray(x).astype(jt), jnp.asarray(dy).astype(jt),
                                          users, kh, kw, ph, pw)
    assert want.dtype == jnp.float32
    got, mag = _port(x, dy, case, dtype)
    _check(got, _to_port_layout(want), mag, dtype)


def test_wrapper_refuses_bad_input():
    x, dy = torch.randn(4, 3, 8, 8), torch.randn(4, 5, 8, 8)
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x, dy[:, :, :4], 2, 3, 3, 1, 1)          # not the input's size
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x, dy.to(torch.bfloat16), 2, 3, 3, 1, 1)  # mixed types
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x, dy, 3, 3, 3, 1, 1)                    # 4 images, 3 users
    with pytest.raises(ValueError):
        dw_ops.per_user_dw(x, dy, 2, 3, 3, 3, 1)                    # pad outside the window
    assert dw_ops.launches == 0 or not torch.cuda.is_available()


@pytest.mark.parametrize("shape,want", [
    ((8, 32, 64, 64, 3, 132), 11), ((8, 32, 3, 64, 3, 132), 11),
    ((8, 32, 128, 128, 3, 132), 8), ((8, 32, 512, 512, 3, 132), 1), ((2, 5, 8, 8, 3, 132), 5)])
def test_batch_splits_fill_the_card_and_leave_no_range_empty(shape, want):
    splits = dw_ops.batch_splits(*shape)
    assert splits == want
    batch = shape[1]
    per = -(-batch // splits)
    assert 1 <= splits <= batch and (splits - 1) * per < batch


@pytest.mark.parametrize("dtype,ci,kw,want", [
    (torch.bfloat16, 64, 3, "tensor_core"),    # ResNet-50's 3x3 convs past the stem
    (torch.bfloat16, 16, 7, "tensor_core"),    # the narrowest input and widest window it takes
    (torch.bfloat16, 512, 1, "tensor_core"),
    (torch.bfloat16, 3, 3, "narrow"),          # the stem
    (torch.bfloat16, 15, 3, "narrow"),         # the widest input it takes
    (torch.bfloat16, 1, 7, "narrow"),          # the narrowest input and widest window
    (torch.float32, 64, 3, "tensor_core_f32"),   # float32 on exact bf16 pieces
    (torch.float32, 16, 7, "tensor_core_f32"),   # the narrowest input and widest window it takes
    (torch.float32, 3, 3, "narrow_f32"),         # the float32 stem: (ci, tap) columns on pieces
    (torch.float32, 15, 3, "narrow_f32"),        # the widest input it takes
    (torch.float32, 1, 7, "narrow_f32"),         # the narrowest input and widest window
    (torch.float32, 64, 8, "cuda_core"),         # beyond MAX_KW: the CUDA-core wrapper raises
    (torch.bfloat16, 64, 8, "cuda_core"),
])
def test_route_is_a_function_of_dtype_and_shapes(dtype, ci, kw, want):
    assert dw_ops.route(dtype, ci, kw) == want


@pytest.mark.parametrize("shape,kw,want", [
    ((8, 32, 64, 64, 3, 132), 3, 16), ((8, 32, 512, 512, 3, 132), 3, 1),
    ((1, 64, 32, 16, 3, 132), 3, 16), ((2, 2, 24, 70, 5, 132), 5, 2)])
def test_tensor_core_batch_splits(shape, kw, want):
    """The tensor-core route's blocks: one per (user, tap row, group of up
    to three taps, 64 x 64 channel tile, range)."""
    splits = dw_ops.batch_splits(*shape, which=dw_ops.TENSOR_CORE, kw=kw)
    assert splits == want
    per = -(-shape[1] // splits)
    assert 1 <= splits <= shape[1] and (splits - 1) * per < shape[1]


@pytest.mark.parametrize("shape,kw,want", [
    ((8, 32, 64, 64, 3, 132), 3, 11), ((8, 32, 128, 128, 3, 132), 3, 8),
    ((8, 32, 256, 256, 3, 132), 3, 2), ((8, 32, 512, 512, 3, 132), 3, 1),
    ((1, 64, 32, 16, 3, 132), 3, 16), ((2, 2, 24, 70, 5, 132), 5, 2),
    ((3, 5, 70, 65, 3, 132), 3, 5)])
def test_tensor_core_f32_batch_splits(shape, kw, want):
    """The float32 tensor-core route's blocks: as the bf16 route's, one per
    (user, tap row, group of up to three taps, 64 x 64 channel tile, range),
    but two per multiprocessor."""
    splits = dw_ops.batch_splits(*shape, which=dw_ops.TENSOR_CORE_F32, kw=kw)
    assert splits == want
    per = -(-shape[1] // splits)
    assert 1 <= splits <= shape[1] and (splits - 1) * per < shape[1]


def _dw_f64(x, dy, users, kh, kw, ph, pw):
    """The weight gradient summed in float64."""
    _, ci, h, w = x.shape
    co = dy.shape[1]
    xp = torch.nn.functional.pad(x.double(), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    xu = xp.reshape(users, -1, ci, h + kh - 1, w + kw - 1)
    dyu = dy.double().reshape(users, -1, co, h, w)
    taps = [torch.einsum("ubihw,ubohw->uoi", xu[..., i:i + h, j:j + w], dyu)
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=-1).reshape(users, co, ci, kh, kw)


@pytest.mark.parametrize("ci,co,hw", [(3, 64, 32), (64, 64, 32), (128, 128, 16),
                                      (256, 256, 8), (512, 512, 4)])
def test_f32_pieces_arithmetic_fits_the_tolerance(ci, co, hw):
    """Which cross products the float32 tensor-core route keeps, at
    ResNet-18's five 3x3 geometries (2 users x 2 images): x and dy split into
    exact bf16 pieces (split_bf16_3), the six kept cross products (mm, hl,
    lh, hm, mh, hh) each summed in float32 and added smallest first, within
    the card tests' tolerance (sqrt(n) * 2^-23 of the summed magnitudes) of
    the float64 sum; the dropped ml, lm and ll together below 2^-23 of the
    summed magnitudes.  The sums here round to nearest: how the tensor cores
    accumulate is the next test's."""
    from gqx_torch.ops.hsq_prep import split_bf16_3

    users, batch = 2, 2
    rng = np.random.default_rng(ci + hw)
    x = torch.from_numpy(rng.standard_normal((users * batch, ci, hw, hw)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((users * batch, co, hw, hw)).astype(np.float32))
    args = (users, 3, 3, 1, 1)
    xs, ds = split_bf16_3(x), split_bf16_3(dy)
    for pieces in (xs, ds):
        assert all(torch.equal(p, p.bfloat16().float()) for p in pieces)     # bf16 values
    assert torch.equal(xs[0] + xs[1] + xs[2], x) and torch.equal(ds[0] + ds[1] + ds[2], dy)
    got = torch.zeros(users, co, ci, 3, 3)
    for a, b in ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)):            # (dy, x) pieces
        got += dw_ops.per_user_dw_plain(xs[b], ds[a], *args)
    exact = _dw_f64(x, dy, *args)
    mag = _dw_f64(x.abs(), dy.abs(), *args)
    n = batch * hw * hw
    assert bool(((got.double() - exact).abs() <= n ** 0.5 * 2.0 ** -23 * mag).all())
    dropped = sum(_dw_f64(xs[b], ds[a], *args) for a, b in ((1, 2), (2, 1), (2, 2)))
    assert bool((dropped.abs() <= 2.0 ** -23 * mag).all())


def _round_toward_zero(t):
    """float64 -> float32, rounded toward zero."""
    r = t.float()
    return torch.where(r.double().abs() > t.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _columns(x, users):
    """x (U*B, Ci, H, W) -> (U, Ci*9, B*H*W) float64: per user, the 3x3
    window's shifted inputs (pads (1, 1)) as the columns of a GEMM whose depth
    is the pixels."""
    n, ci, h, w = x.shape
    xp = torch.nn.functional.pad(x.double(), (1, 1, 1, 1))
    taps = torch.stack([xp[:, :, i:i + h, j:j + w] for i in range(3) for j in range(3)], 2)
    return taps.reshape(users, n // users, ci * 9, h * w).transpose(1, 2).reshape(users, ci * 9, -1)


def _tensor_core_sum(xs, ds, users, two_sets):
    """The float32 tensor-core route's accumulation, modelled: per step of 16
    pixels, each kept cross product's 16 exact products (mm, hl, lh, hm, mh,
    hh in that order) added to its accumulator in one sum rounded toward
    zero, as the tensor cores round; hh into one set and the five smaller
    ones into a second, the two added at the end (``two_sets``), or all six
    into one set."""
    cols = [_columns(p, users) for p in xs]
    rows = [d.double().reshape(users, -1, d.shape[1], d.shape[2] * d.shape[3]).transpose(1, 2)
            .reshape(users, d.shape[1], -1) for d in ds]
    acc = torch.zeros(users, rows[0].shape[1], cols[0].shape[1])
    rest = torch.zeros_like(acc)
    for p in range(0, cols[0].shape[-1], 16):
        for a, b in ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)):          # (dy, x) pieces
            step = torch.einsum("uop,uip->uoi", rows[a][..., p:p + 16], cols[b][..., p:p + 16])
            if two_sets and (a, b) != (0, 0):
                rest = _round_toward_zero(rest.double() + step)
            else:
                acc = _round_toward_zero(acc.double() + step)
    return acc + rest


@pytest.mark.parametrize("ci,co,hw", [(64, 64, 32), (128, 128, 16), (256, 256, 8),
                                      (512, 512, 4)])
def test_f32_two_accumulator_sets_fit_the_tolerance_under_truncation(ci, co, hw):
    """The float32 tensor-core route's two accumulator sets, with the tensor
    cores' truncating additions modelled (``_tensor_core_sum``), at the four
    geometries of ResNet-18 that take the route (2 users x 2 images): within
    the card tests' tolerance of the float64 sum, and on average at most a
    quarter of the error of one set, whose six roundings a step all fall at
    the scale of the whole sum."""
    from gqx_torch.ops.hsq_prep import split_bf16_3

    users, batch = 2, 2
    rng = np.random.default_rng(ci + hw)
    x = torch.from_numpy(rng.standard_normal((users * batch, ci, hw, hw)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((users * batch, co, hw, hw)).astype(np.float32))
    xs, ds = split_bf16_3(x), split_bf16_3(dy)
    exact = _dw_f64(x, dy, users, 3, 3, 1, 1).reshape(users, co, ci * 9)
    mag = _dw_f64(x.abs(), dy.abs(), users, 3, 3, 1, 1).reshape(users, co, ci * 9)
    rel = {two: (_tensor_core_sum(xs, ds, users, two).double() - exact).abs() / mag
           for two in (True, False)}
    n = batch * hw * hw
    assert bool((rel[True] <= n ** 0.5 * 2.0 ** -23).all())
    assert float(rel[True].mean()) <= float(rel[False].mean()) / 4


@pytest.mark.parametrize("shape,want", [
    ((8, 32, 3, 64, 32, 32, 3, 3), (32, 32)),     # the ResNet-50 stem: a piece is an image
    ((2, 4, 3, 64, 32, 32, 3, 3), (32, 4)),
    ((1, 64, 3, 16, 8, 8, 3, 3), (8, 64)),        # one user: a range per image
    ((2, 2, 15, 70, 7, 70, 7, 7), (7, 2)),        # 735 columns: 23 column tiles, 2 co tiles
    ((1, 2, 15, 8, 4, 300, 7, 7), (1, 8)),        # rows too wide for 32 KB: one row a piece
    ((8, 32, 1, 8, 1, 1, 3, 2), (1, 32))])        # a 1x1 plane
def test_narrow_splits_fill_the_card_and_leave_no_range_empty(shape, want):
    """The narrow route's pieces (bands of rows, at most 1,024 pixels and
    32 KB of staged x) and ranges of pieces: one block per (user, 64-row
    tile of Co, 32-column tile of (ci, tap), range), 2 per multiprocessor."""
    users, batch, ci, co, h, w, kh, kw = shape
    rows, splits = dw_ops.narrow_splits(*shape, 132)
    assert (rows, splits) == want
    pieces = batch * -(-h // rows)
    per = -(-pieces // splits)
    assert 1 <= splits <= pieces and (splits - 1) * per < pieces     # no range is empty
    assert rows * w <= 1024 or rows == 1
    assert 2 * ci * (rows + kh - 1) * (w + kw - 1) <= 32 * 1024 or rows == 1
    if shape == (8, 32, 3, 64, 32, 32, 3, 3):
        blocks = users * -(-(ci * kh * kw) // 32) * -(-co // 64) * splits
        assert blocks >= 132     # every multiprocessor of an H100 has a block


@pytest.mark.parametrize("shape,want", [
    ((8, 32, 3, 64, 32, 32, 3, 3), (32, 32)),     # the ResNet-50 stem: a piece is an image
    ((2, 2, 3, 64, 32, 32, 3, 3), (32, 2)),
    ((8, 32, 15, 64, 32, 32, 3, 3), (6, 6)),      # 15 channels: 6 rows fit 32 KB, 5 column tiles
    ((2, 2, 15, 64, 32, 32, 3, 3), (6, 12)),
    ((1, 2, 3, 8, 4, 300, 7, 7), (1, 8)),         # rows too wide for 32 KB: one row a piece
    ((8, 32, 3, 64, 1, 1, 3, 3), (1, 32))])       # a 1x1 plane
def test_narrow_f32_splits_fill_the_card_and_leave_no_range_empty(shape, want):
    """The float32 narrow route's pieces and ranges: as the bf16 route's,
    with each staged value's three bf16 pieces in 8 bytes where the bf16
    route stages 2."""
    users, batch, ci, co, h, w, kh, kw = shape
    rows, splits = dw_ops.narrow_splits(*shape, 132, dw_ops.NARROW_F32)
    assert (rows, splits) == want
    pieces = batch * -(-h // rows)
    per = -(-pieces // splits)
    assert 1 <= splits <= pieces and (splits - 1) * per < pieces     # no range is empty
    assert rows * w <= 1024 or rows == 1
    assert 8 * ci * (rows + kh - 1) * (w + kw - 1) <= 32 * 1024 or rows == 1
    if shape == (8, 32, 3, 64, 32, 32, 3, 3):
        blocks = users * -(-(ci * kh * kw) // 32) * -(-co // 64) * splits
        assert blocks >= 132     # every multiprocessor of an H100 has a block


def _narrow_order(batch, h, w, rows, splits):
    """The float32 narrow kernel's order of a user's B*H*W pixels (image-major)
    as (ranges, 4 warps, k-steps, 16 slots), -1 where a slot holds no pixel:
    range r takes its pieces (bands of ``rows`` rows) in order; in each,
    warp i takes the chunks of 32 pixels at 32 i, 32 i + 128, ..., and k-step
    s of a chunk c0 holds its 16 pixels c0 + 16 s .. c0 + 16 s + 15."""
    bands = -(-h // rows)
    pieces = batch * bands
    per = -(-pieces // splits)
    order = [[[] for _ in range(4)] for _ in range(splits)]
    for q in range(pieces):
        b, band = divmod(q, bands)
        start = b * h * w + band * rows * w
        npx = (min(h, (band + 1) * rows) - band * rows) * w
        for warp in range(4):
            for c0 in range(32 * warp, npx, 128):
                for s in range(2):
                    slots = [c0 + 16 * s + e for e in range(16)]
                    order[q // per][warp].append([start + p if p < npx else -1 for p in slots])
    steps = max(len(o) for r in order for o in r)
    return torch.tensor([[o + [[-1] * 16] * (steps - len(o)) for o in r] for r in order])


def _narrow_f32_sum(xs, ds, users, band_rows, splits, two_sets):
    """The float32 narrow route's accumulation at a 3x3 window with pads
    (1, 1), modelled: per warp and 16-slot k-step (``_narrow_order``), each
    kept cross product's 16 exact products (mm, hl, lh, hm, mh, hh in that
    order) added to its accumulator in one sum rounded toward zero, as the
    tensor cores round; hh into one set and the five smaller ones into a
    second, the two added at the end rounded to nearest (``two_sets``), or
    all six into one set; then the warps' sums added in warp order and the
    ranges' sums in range order, in float32."""
    batch, h, w = xs[0].shape[0] // users, xs[0].shape[2], xs[0].shape[3]
    idx = _narrow_order(batch, h, w, band_rows, splits)
    idx = torch.where(idx < 0, batch * h * w, idx)          # the appended zero pixel
    pad = lambda t: torch.nn.functional.pad(t, (0, 1))
    cols = [pad(_columns(p, users))[..., idx] for p in xs]  # (U, N, R, 4, steps, 16)
    rows = [pad(d.double().reshape(users, batch, d.shape[1], h * w).transpose(1, 2)
                .reshape(users, d.shape[1], -1))[..., idx] for d in ds]
    shape = (users, idx.shape[0], 4, rows[0].shape[1], cols[0].shape[1])
    acc, rest = torch.zeros(shape), torch.zeros(shape)
    for j in range(idx.shape[2]):
        for a, b in ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)):          # (dy, x) pieces
            step = torch.einsum("uorwk,unrwk->urwon", rows[a][..., j, :], cols[b][..., j, :])
            if two_sets and (a, b) != (0, 0):
                rest = _round_toward_zero(rest.double() + step)
            else:
                acc = _round_toward_zero(acc.double() + step)
    warps = acc + rest
    total = None
    for r in range(warps.shape[1]):
        tile = warps[:, r, 0]
        for i in range(1, 4):
            tile = tile + warps[:, r, i]
        total = tile if total is None else total + tile
    return total


@pytest.mark.parametrize("ci", [3, 1, 15])
def test_narrow_f32_two_accumulator_sets_fit_the_tolerance_under_truncation(ci):
    """The float32 narrow route's order of sums (``_narrow_f32_sum``: 16-slot
    k-steps per warp's chunk, the warps in order, the ranges in order), with
    the tensor cores' truncating additions modelled, at the stem's geometry
    (ci -> 64 @32x32, 3x3, 2 users x 2 images, the route's band rows and
    ranges): within the card tests' tolerance of the float64 sum, and on
    average at most a quarter of the error of one set."""
    from gqx_torch.ops.hsq_prep import split_bf16_3

    users, batch, co, hw = 2, 2, 64, 32
    rng = np.random.default_rng(ci)
    x = torch.from_numpy(rng.standard_normal((users * batch, ci, hw, hw)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((users * batch, co, hw, hw)).astype(np.float32))
    rows, splits = dw_ops.narrow_splits(users, batch, ci, co, hw, hw, 3, 3, 132,
                                        dw_ops.NARROW_F32)
    xs, ds = split_bf16_3(x), split_bf16_3(dy)
    exact = _dw_f64(x, dy, users, 3, 3, 1, 1).reshape(users, co, ci * 9)
    mag = _dw_f64(x.abs(), dy.abs(), users, 3, 3, 1, 1).reshape(users, co, ci * 9)
    rel = {two: (_narrow_f32_sum(xs, ds, users, rows, splits, two).double() - exact).abs() / mag
           for two in (True, False)}
    n = batch * hw * hw
    assert bool((rel[True] <= n ** 0.5 * 2.0 ** -23).all())
    assert float(rel[True].mean()) <= float(rel[False].mean()) / 4
