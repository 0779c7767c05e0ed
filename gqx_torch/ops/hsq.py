"""HSQ encode and fused decode-mean (counterpart of ``gqx/ops/pallas_hsq4.py``).

Each function has a wrapper and a plain PyTorch version.  The wrapper
computes the plain version for CPU tensors and launches the CUDA kernel
(``csrc/hsq_encode.cu``, ``csrc/hsq_decode_mean.cu``) for CUDA tensors;
there is no fallback from one to the other.  The m-order signature layout
is used throughout: codes and u are (U, M), row m of user i holds the
subvector ``flat[i, m*dim:(m+1)*dim]``.

The arithmetic is the TPU kernels' (see the notes in the CUDA sources):
inputs rounded per ``passes``, a bf16-exact codebook, the ``pos >= -neg``
selection with first-index ties, and the bf16-rounded per-code weights of
the decode-mean.
"""

from __future__ import annotations

import ctypes

import torch

from gqx_torch.ops import _build
from gqx_torch.ops.hsq_prep import bf16_round

#: launches of each CUDA kernel (not of the plain versions)
launches = {"hsq_encode": 0, "hsq_decode_mean": 0}

KERNEL_DIMS = (4, 8, 16, 32)
MAX_SMEM = 227 * 1024          # dynamic shared memory one block may use
_CHUNK = 1 << 16               # rows per block of the plain versions


def _check_codebook(codebook, dim, device):
    if codebook.dtype != torch.float32 or codebook.dim() != 2 or codebook.shape[1] != dim:
        raise ValueError(f"codebook must be (K, {dim}) float32, got "
                         f"{tuple(codebook.shape)} {codebook.dtype}")
    if codebook.device != device or not codebook.is_contiguous():
        raise ValueError("codebook must be contiguous on the input's device")
    if dim not in KERNEL_DIMS:
        raise NotImplementedError(f"no CUDA kernel for dim {dim} (has {KERNEL_DIMS})")
    if codebook.numel() * 4 > MAX_SMEM:
        raise NotImplementedError(
            f"codebook of {codebook.numel() * 4} bytes exceeds shared memory")


# -- encode -----------------------------------------------------------------

def hsq_encode_flat_plain(flat: torch.Tensor, codebook: torch.Tensor, dim: int,
                          passes: int = 2, code_dtype=torch.uint8):
    """The plain version: (U, size) or (size,) -> (u, codes) of (U, M)/(M,)."""
    batched = flat.dim() == 2
    x = flat if batched else flat[None]
    users, size = x.shape
    m = size // dim
    rows = x.reshape(users * m, dim).to(torch.float32)
    cb_t = codebook.to(device=rows.device, dtype=torch.float32).t()
    k = codebook.shape[0]
    iota = torch.arange(k, device=rows.device)
    u = torch.empty(users * m, dtype=torch.float32, device=rows.device)
    codes = torch.empty(users * m, dtype=code_dtype, device=rows.device)
    for s in range(0, users * m, _CHUNK):
        r = rows[s:s + _CHUNK]
        xh = bf16_round(r)
        p = xh @ cb_t
        if passes == 2:
            p = p + bf16_round(r - xh) @ cb_t
        pos, neg = p.amax(1), p.amin(1)
        uj = torch.where(pos >= -neg, pos, neg)
        idx = torch.where(p == uj[:, None], iota, k).amin(1)
        u[s:s + _CHUNK] = uj
        codes[s:s + _CHUNK] = idx.to(code_dtype)
    u, codes = u.reshape(users, m), codes.reshape(users, m)
    return (u, codes) if batched else (u[0], codes[0])


def _encode_kernel(flat, codebook, dim, passes, code_dtype):
    if flat.dtype not in (torch.float32, torch.bfloat16) or not flat.is_contiguous():
        raise ValueError(f"hsq_encode: input must be contiguous float32/bf16, got {flat.dtype}")
    if passes not in (1, 2):
        raise ValueError(f"hsq_encode: passes must be 1 or 2, got {passes}")
    if code_dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"hsq_encode: codes must be uint8 or int32, got {code_dtype}")
    k = codebook.shape[0]
    if code_dtype == torch.uint8 and k > 256:
        raise ValueError(f"hsq_encode: {k} codewords do not fit uint8 codes")
    _check_codebook(codebook, dim, flat.device)
    batched = flat.dim() == 2
    x = flat if batched else flat[None]
    users, size = x.shape
    if size % dim:
        raise ValueError(f"hsq_encode: size {size} is not a multiple of dim {dim}")
    m = size // dim
    u = torch.empty((users, m), dtype=torch.float32, device=flat.device)
    codes = torch.empty((users, m), dtype=code_dtype, device=flat.device)
    lib = _build.load("hsq_encode")
    fn = lib.gqx_hsq_encode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codebook.data_ptr(),
             k, dim, users, m, passes, u.data_ptr(), codes.data_ptr(),
             int(code_dtype == torch.uint8), _build.stream_ptr(flat.device))
    _build.check(lib, err, "hsq_encode")
    launches["hsq_encode"] += 1
    return (u, codes) if batched else (u[0], codes[0])


def hsq_encode_flat(flat: torch.Tensor, codebook: torch.Tensor, dim: int,
                    passes: int = 2, code_dtype=torch.uint8):
    """HSQ encode of (U, size) or (size,) -> (u float32, codes) of (U, M)/(M,).

    passes=1 rounds the input to bf16 (a bf16 input is taken as it is);
    passes=2 contracts bf16(x) and bf16(x - bf16(x)) separately.  u is the
    signed inner product of largest magnitude, ``pos`` winning an exact
    +v/-v tie, and the code is the first index attaining it."""
    if flat.device.type == "cpu":
        return hsq_encode_flat_plain(flat, codebook, dim, passes, code_dtype)
    if flat.device.type != "cuda":
        raise ValueError(f"hsq_encode: unsupported device {flat.device}")
    return _encode_kernel(flat, codebook, dim, passes, code_dtype)


# -- fused decode-mean ------------------------------------------------------

def hsq_decode_mean_plain(codes: torch.Tensor, u: torch.Tensor,
                          codebook: torch.Tensor, dim: int, passes: int = 2):
    """The plain version: codes/u (U, M) -> (M*dim,) float32."""
    users, m = codes.shape
    cb = codebook.to(device=u.device, dtype=torch.float32)
    k = cb.shape[0]
    out = torch.empty((m, dim), dtype=torch.float32, device=u.device)
    inv = 1.0 / users
    for s in range(0, m, _CHUNK):
        e = min(s + _CHUNK, m)
        w = torch.zeros((e - s, k), dtype=torch.float32, device=u.device)
        # one user per scatter: each row gets one index per call, so the
        # weights are summed in user order, as the TPU kernel sums them
        for i in range(users):
            w.scatter_add_(1, codes[i, s:e].long()[:, None],
                           u[i, s:e].to(torch.float32)[:, None])
        w = w * inv
        wh = bf16_round(w)
        o = wh @ cb
        if passes == 2:
            o = o + bf16_round(w - wh) @ cb
        out[s:e] = o
    return out.reshape(-1)


def _decode_mean_kernel(codes, u, codebook, dim, passes):
    if codes.dtype not in (torch.uint8, torch.int32) or not codes.is_contiguous():
        raise ValueError(f"hsq_decode_mean: codes must be contiguous uint8/int32, got {codes.dtype}")
    if u.dtype != torch.float32 or not u.is_contiguous() or u.shape != codes.shape:
        raise ValueError("hsq_decode_mean: u must be contiguous float32 shaped like codes")
    if u.device != codes.device or codes.dim() != 2:
        raise ValueError("hsq_decode_mean: codes and u must be (U, M) on one device")
    if passes not in (1, 2):
        raise ValueError(f"hsq_decode_mean: passes must be 1 or 2, got {passes}")
    _check_codebook(codebook, dim, u.device)
    users, m = codes.shape
    out = torch.empty(m * dim, dtype=torch.float32, device=u.device)
    lib = _build.load("hsq_decode_mean")
    fn = lib.gqx_hsq_decode_mean
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(codes.data_ptr(), int(codes.dtype == torch.uint8), u.data_ptr(),
             codebook.data_ptr(), codebook.shape[0], dim, users, m, passes,
             out.data_ptr(), _build.stream_ptr(u.device))
    _build.check(lib, err, "hsq_decode_mean")
    launches["hsq_decode_mean"] += 1
    return out


def hsq_decode_mean(codes: torch.Tensor, u: torch.Tensor, codebook: torch.Tensor,
                    dim: int, passes: int = 2) -> torch.Tensor:
    """(1/U) * sum_i u[i] * codebook[codes[i]] per subvector, with the TPU
    kernel's weight rounding: per distinct code the u of its users summed in
    user order, times float(1/U), then bf16 (passes=1) or bf16 hi + lo
    (passes=2).  codes/u (U, M) -> (M*dim,) float32."""
    if u.device.type == "cpu":
        return hsq_decode_mean_plain(codes, u, codebook, dim, passes)
    if u.device.type != "cuda":
        raise ValueError(f"hsq_decode_mean: unsupported device {u.device}")
    return _decode_mean_kernel(codes, u, codebook, dim, passes)


def hsq_decode_plain(codes: torch.Tensor, u: torch.Tensor, codebook: torch.Tensor,
                     dim: int, passes: int = 2) -> torch.Tensor:
    """Per-user decode u * codebook[code] with the TPU decode's rounding of u
    (bf16 at passes=1, bf16 hi + lo at passes=2): (..., M) -> (..., M*dim).
    gqx's kernel for it (pallas_hsq4.hsq_decode_flat) is not ported yet, so
    this plain version serves every device."""
    cb = codebook.to(device=u.device, dtype=torch.float32)
    rows = cb[codes.long()]
    uh = bf16_round(u.to(torch.float32))
    out = rows * uh[..., None]
    if passes == 2:
        out = out + rows * bf16_round(u - uh)[..., None]
    return out.reshape(codes.shape[:-1] + (codes.shape[-1] * dim,))
