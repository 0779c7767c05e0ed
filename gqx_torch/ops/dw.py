"""Per-user convolution weight gradient (counterpart of ``gqx/ops/pallas_dw.py``).

The folded-users backward (``gqx_torch.models.folded``) runs one forward and
one data-gradient backward on the folded (U*B) batch and needs one weight
gradient per user:

    dW[u, co, ci, i, j] = sum over the images b of user u and over (h, w) of
        xpad[b, ci, h + i - ph, w + j - pw] * dy[b, co, h, w]

for a stride-1 convolution whose output has the input's size (kh - 1 pad
rows and kw - 1 pad columns in all, ``ph`` and ``pw`` of them on the low
side).  Tensors are in the port's layout: ``x`` (U*B, Ci, H, W) and ``dy``
(U*B, Co, H, W), float32 or bf16, and the result (U, Co, Ci, kh, kw) is
float32 in the weight's OIHW order.  Operands enter as float32 and the sum
is float32; the caller rounds the result to its compute dtype where gqx
does.

``per_user_dw`` computes the plain version for CPU tensors and launches a
CUDA kernel for CUDA tensors; there is no fallback from one to the other.
Which kernel, ``route`` decides from the dtype and the shapes alone:

- ``"tensor_core"`` (``csrc/per_user_dw_tc.cu``): bf16 with at least 16
  input channels and kw <= 7, on bf16 ``mma.sync`` with float32
  accumulation, one (co, ci) tile per tap;
- ``"narrow"`` (``csrc/per_user_dw_narrow.cu``): bf16 with fewer than 16
  input channels (the stem's 3) and kw <= 7, on bf16 ``mma.sync`` with the
  (ci, tap) pairs as the columns of one GEMM whose depth is the pixels;
- ``"tensor_core_f32"`` (``csrc/per_user_dw_tc_f32.cu``): float32 with at
  least 16 input channels and kw <= 7, the tensor-core route's design on
  exact bf16 pieces of the float32 values (six of the nine cross products
  per fragment pair, at float32 accuracy);
- ``"narrow_f32"`` (``csrc/per_user_dw_narrow_f32.cu``): float32 with
  fewer than 16 input channels (the stem's 3) and kw <= 7, the narrow
  route's GEMM on the float32 route's exact bf16 pieces;
- ``"cuda_core"``: kw > 7, which raises.  Its kernel, ``csrc/per_user_dw.cu``
  (float32 FMAs), serves no training path; it stays callable through its C
  entry (``gqx_torch.scripts.dw_f32_probe.cuda_core_dw``) as the baseline
  that the float32 routes are timed and checked beside.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gqx_torch.ops import _build

TENSOR_CORE, NARROW, CUDA_CORE = "tensor_core", "narrow", "cuda_core"
TENSOR_CORE_F32, NARROW_F32 = "tensor_core_f32", "narrow_f32"

#: launches of any of the CUDA kernels (not of the plain version), and by
#: route; ``launches`` is always the sum of ``launches_by_route``
launches = 0
launches_by_route = {TENSOR_CORE: 0, NARROW: 0, CUDA_CORE: 0, TENSOR_CORE_F32: 0,
                     NARROW_F32: 0}

MAX_KW = 7            # the kernels keep a kw-wide window of taps per block
_TILE_CO = 64         # output channels per block, every route
# per route: the library, its C entry, blocks per multiprocessor (kBlocksPerSM
# of the tensor-core and narrow kernels) and taps of a row per block
_ROUTES = {
    CUDA_CORE: ("per_user_dw", "gqx_per_user_dw", 2, MAX_KW),
    TENSOR_CORE: ("per_user_dw_tc", "gqx_per_user_dw_tc", 3, 3),
    NARROW: ("per_user_dw_narrow", "gqx_per_user_dw_narrow", 2, MAX_KW),
    TENSOR_CORE_F32: ("per_user_dw_tc_f32", "gqx_per_user_dw_tc_f32", 2, 3),
    NARROW_F32: ("per_user_dw_narrow_f32", "gqx_per_user_dw_narrow_f32", 2, MAX_KW),
}
# the narrow routes: (ci, tap) columns per block, dy pixels of a piece at
# most, and the shared memory their staged x planes aim for; per route the
# bytes of a staged element (a bf16 value; a float32 value's three bf16
# pieces in 8 bytes) and the staged bytes a block may take (kMaxStaged
# elements of the kernel: the float32 kernel keeps 4 more bytes of raw value
# per element and a 64 KB ring of dy beside them in its 227 KB)
_NARROW_TILE_N = 32
_NARROW_PIXELS = 1024
_NARROW_STAGE = 32 * 1024
_NARROW_ELEMENT = {NARROW: 2, NARROW_F32: 8}
_NARROW_MAX_STAGE = {NARROW: 2 * ((1 << 16) - 1024), NARROW_F32: 8 * ((232448 - 65536) // 12)}


def _check(x, dy, users, kh, kw, ph, pw):
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"per_user_dw: x and dy must be NCHW, got {tuple(x.shape)} "
                         f"and {tuple(dy.shape)}")
    if x.shape[0] != dy.shape[0] or x.shape[2:] != dy.shape[2:]:
        raise ValueError(f"per_user_dw: dy {tuple(dy.shape)} does not have the batch and "
                         f"size of x {tuple(x.shape)} (a stride-1 same-size conv)")
    if users < 1 or x.shape[0] % users:
        raise ValueError(f"per_user_dw: batch {x.shape[0]} does not fold {users} users")
    if kh < 1 or kw < 1 or not (0 <= ph < kh and 0 <= pw < kw):
        raise ValueError(f"per_user_dw: window {kh}x{kw} with low pads ({ph}, {pw})")
    if x.dtype != dy.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"per_user_dw: x and dy must both be float32 or bfloat16, got "
                         f"{x.dtype} and {dy.dtype}")


def per_user_dw_plain(x: torch.Tensor, dy: torch.Tensor, users: int,
                      kh: int, kw: int, ph: int, pw: int) -> torch.Tensor:
    """The plain version (gqx's ``_per_user_dw_einsum``): kh*kw shifted
    slices of the padded input, each contracted with dy over (b, h, w) per
    user, with float32 operands."""
    _check(x, dy, users, kh, kw, ph, pw)
    _, ci, h, w = x.shape
    co = dy.shape[1]
    xp = F.pad(x.to(torch.float32), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    xu = xp.reshape(users, -1, ci, h + kh - 1, w + kw - 1)
    dyu = dy.to(torch.float32).reshape(users, -1, co, h, w)
    taps = [torch.einsum("ubihw,ubohw->uoi", xu[..., i:i + h, j:j + w], dyu)
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=-1).reshape(users, co, ci, kh, kw)


def route(dtype: torch.dtype, ci: int, kw: int) -> str:
    """The kernel that a CUDA call takes, from its dtype and shapes alone."""
    if kw > MAX_KW:
        return CUDA_CORE
    if dtype == torch.bfloat16:
        return TENSOR_CORE if ci >= 16 else NARROW
    return TENSOR_CORE_F32 if ci >= 16 else NARROW_F32


def batch_splits(users: int, batch: int, ci: int, co: int, kh: int, sm_count: int,
                 which: str = CUDA_CORE, kw: int = 3) -> int:
    """Into how many ranges route ``which`` cuts a user's images.  The
    blocks, one per (user, tap row, group of taps, channel tile, range), run
    a fixed number per multiprocessor in waves; a last wave that is nearly
    empty costs as much as a full one.  So: the fewest ranges (at most 16)
    that fill the card at least once and whose waves are at least 90% full,
    counting a range as long as its longest; failing that, the best filled.
    A function of the shapes and the card only, so the order of the sum, and
    with it every bit of the result, repeats."""
    _, _, per_sm, taps = _ROUTES[which]
    ci_tile = 16 if which == CUDA_CORE and ci <= 16 else 64
    blocks = users * kh * -(-kw // taps) * -(-ci // ci_tile) * -(-co // _TILE_CO)
    return _fewest_ranges(blocks, batch, per_sm * sm_count, min(batch, 16))


def _fewest_ranges(blocks: int, units: int, slots: int, most: int) -> int:
    """The fewest ranges (at most ``most``) of a user's ``units`` that fill
    the card's ``slots`` at least once with ``blocks`` blocks per range, in
    waves at least 90% full, counting a range as long as its longest;
    failing that, the best filled."""
    best, best_fill = 1, 0.0
    for want in range(1, most + 1):
        per = -(-units // want)
        splits = -(-units // per)
        waves = -(-blocks * splits // slots)
        # useful unit-blocks over what the waves could hold
        fill = blocks * units / (waves * slots * per)
        if fill > best_fill + 1e-9:
            best, best_fill = splits, fill
        if fill >= 0.9:
            break
    return best


def _narrow_stage_bytes(ci: int, rows: int, w: int, kh: int, kw: int,
                        which: str = NARROW) -> int:
    """Shared memory of a narrow kernel's staged x: per channel rows + kh - 1
    rows of w + kw - 1 columns of the route's staged elements."""
    return _NARROW_ELEMENT[which] * ci * (rows + kh - 1) * (w + kw - 1)


@functools.lru_cache(maxsize=None)
def narrow_splits(users: int, batch: int, ci: int, co: int, h: int, w: int, kh: int, kw: int,
                  sm_count: int, which: str = NARROW):
    """(band rows, ranges) of narrow route ``which`` (``NARROW`` or
    ``NARROW_F32``).  A user's images are cut into pieces, bands of rows that
    hold at most 1,024 pixels and whose staged x fits 32 KB (one row at
    least), and its pieces into ranges.  The blocks, one per (user, 64-row
    tile of Co, 32-column tile of the (ci, tap) columns, range), run 2 per
    multiprocessor in waves; the ranges are chosen as ``batch_splits``
    chooses them, from every count up to the number of pieces.  A function
    of the shapes and the card only, so the order of the sum, and every bit
    of the result, repeats."""
    rows = max(1, min(h, _NARROW_PIXELS // max(w, 1)))
    while rows > 1 and _narrow_stage_bytes(ci, rows, w, kh, kw, which) > _NARROW_STAGE:
        rows -= 1
    pieces = batch * -(-h // rows)
    blocks = users * -(-(ci * kh * kw) // _NARROW_TILE_N) * -(-co // _TILE_CO)
    return rows, _fewest_ranges(blocks, pieces, _ROUTES[which][2] * sm_count, pieces)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry(which: str):
    """(library, C entry with its argument types) of route ``which``."""
    name, entry = _ROUTES[which][:2]
    lib = _build.load(name)
    fn = getattr(lib, entry)
    ints = 12 if which in (NARROW, NARROW_F32) else 11
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * ints + \
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _kernel(x, dy, users, kh, kw, ph, pw):
    if not (x.is_contiguous() and dy.is_contiguous()) or x.device != dy.device:
        raise ValueError("per_user_dw: x and dy must be contiguous on one device")
    n, ci, h, w = x.shape
    which = route(x.dtype, ci, kw)
    if kw > MAX_KW or h >= 1 << 15:
        raise NotImplementedError(f"per_user_dw: no CUDA kernel for kw {kw} > {MAX_KW} "
                                  f"or {h} >= 32768 rows")
    narrow = which in (NARROW, NARROW_F32)
    if narrow and (w >= 1 << 15 or
                   _narrow_stage_bytes(ci, 1, w, kh, kw, which) > _NARROW_MAX_STAGE[which]):
        raise NotImplementedError(f"per_user_dw: no {which} kernel for rows of {w} pixels")
    co = dy.shape[1]
    batch = n // users
    out = torch.empty((users, co, ci, kh, kw), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if n == 0 or h * w == 0:
        return out.zero_()
    if narrow:
        rows, splits = narrow_splits(users, batch, ci, co, h, w, kh, kw, _sm_count(x.device),
                                     which)
        extra = [rows]
    else:
        splits, extra = batch_splits(users, batch, ci, co, kh, _sm_count(x.device), which, kw), []
    scratch = (torch.empty((splits,) + tuple(out.shape), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib, fn = _entry(which)
    # the narrow entries also take the rows of a piece
    err = fn(x.data_ptr(), dy.data_ptr(), users, batch,
             ci, co, h, w, kh, kw, ph, pw, *extra, splits,
             scratch.data_ptr() if scratch is not None else None, out.data_ptr(),
             _build.stream_ptr(x.device))
    _build.check(lib, err, f"per_user_dw ({which})")
    global launches
    launches += 1
    launches_by_route[which] += 1
    return out


def per_user_dw(x: torch.Tensor, dy: torch.Tensor, users: int,
                kh: int, kw: int, ph: int, pw: int) -> torch.Tensor:
    """x (U*B, Ci, H, W), dy (U*B, Co, H, W), both float32 or both bf16 ->
    the per-user weight gradient (U, Co, Ci, kh, kw) float32 of a stride-1
    kh x kw convolution with low pads (ph, pw) whose output has the input's
    size.  Two calls on the same inputs give the same bits."""
    _check(x, dy, users, kh, kw, ph, pw)
    if x.device.type == "cpu":
        return per_user_dw_plain(x, dy, users, kh, kw, ph, pw)
    if x.device.type != "cuda":
        raise ValueError(f"per_user_dw: unsupported device {x.device}")
    return _kernel(x, dy, users, kh, kw, ph, pw)
