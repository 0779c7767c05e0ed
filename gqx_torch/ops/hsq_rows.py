"""Row-major HSQ encode and decode (counterpart of ``gqx/ops/pallas_hsq.py``).

These serve the (dim, K) outside the flat-layout kernels' envelope
(``hsq_prep.supports_flat``): any subvector dim, any codebook size.  The
arithmetic is float32-accurate, as gqx's kernels compute it at
``Precision.HIGHEST``: the raw (not bf16-rounded) codebook, inputs not
rounded, ``code = argmax |p|`` with the first index on a tie and
``u = p[code]`` (for p = [-3, 3]: code 0, u = -3, where the flat encode's
``pos >= -neg`` rule gives code 1), and the decode ``u * codebook[code]``.

Each function has a wrapper and a plain PyTorch version.  The wrapper
computes the plain version for CPU tensors and launches a CUDA kernel for
CUDA tensors; there is no fallback from one to the other.  A leading users
axis is covered by one launch.  The encode takes bf16 or float32 rows of any
dim and any number of codewords, on the tensor cores over exact bf16 pieces
of the float32 values (``hsq_prep.split_bf16_3``), by one of two routes
(``route``): dims up to 32 in ``csrc/hsq_rows_encode_tc.cu``, wider dims in
``csrc/hsq_rows_encode_wide.cu`` (a GEMM with an argmax epilogue).  The
decode is ``csrc/hsq_rows_decode.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from gqx_torch.ops import _build
from gqx_torch.ops.hsq import check_signature

TENSOR_CORE, TENSOR_CORE_WIDE = "tensor_core", "tensor_core_wide"

#: launches of each CUDA kernel (not of the plain versions); the encode's
#: by route too, ``launches["hsq_rows_encode"]`` being their sum
launches = {"hsq_rows_encode": 0, "hsq_rows_decode": 0}
launches_by_route = {TENSOR_CORE: 0, TENSOR_CORE_WIDE: 0}

MAX_TC_DIM = 32                # the tensor-core encode pads a row to 8, 16, 24 or 32
_ROUTES = {TENSOR_CORE: ("hsq_rows_encode_tc", "gqx_hsq_rows_encode_tc"),
           TENSOR_CORE_WIDE: ("hsq_rows_encode_wide", "gqx_hsq_rows_encode_wide")}
# x, x_bf16, codebook, k, dim, rows, u, codes, codes_u8, [pieces,] stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
_CHUNK = 1 << 16               # rows per block of the plain encode


# -- encode -----------------------------------------------------------------

def hsq_encode_plain(rows: torch.Tensor, codebook: torch.Tensor,
                     code_dtype=torch.int32):
    """The plain version: rows (..., M, dim) -> (u, codes) of (..., M)."""
    lead, dim = rows.shape[:-1], rows.shape[-1]
    flat = rows.reshape(-1, dim).to(torch.float32)
    cb_t = codebook.to(device=flat.device, dtype=torch.float32).t()
    n = flat.shape[0]
    u = torch.empty(n, dtype=torch.float32, device=flat.device)
    codes = torch.empty(n, dtype=code_dtype, device=flat.device)
    for s in range(0, n, _CHUNK):
        p = flat[s:s + _CHUNK] @ cb_t
        idx = p.abs().argmax(1)            # the first index on a tie
        u[s:s + _CHUNK] = p.gather(1, idx[:, None])[:, 0]
        codes[s:s + _CHUNK] = idx.to(code_dtype)
    return u.reshape(lead), codes.reshape(lead)


def route(dtype: torch.dtype, dim: int) -> str:
    """The encode kernel a CUDA call with rows of ``dtype`` and ``dim``
    takes: ``tensor_core`` for dim <= 32, ``tensor_core_wide`` above."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"hsq_rows_encode: rows must be bf16 or float32, got {dtype}")
    if dim < 1:
        raise ValueError(f"hsq_rows_encode: dim must be at least 1, got {dim}")
    return TENSOR_CORE if dim <= MAX_TC_DIM else TENSOR_CORE_WIDE


def _encode_kernel(rows, codebook, code_dtype):
    if rows.dtype not in (torch.bfloat16, torch.float32) or not rows.is_contiguous() \
            or rows.dim() not in (2, 3):
        raise ValueError("hsq_rows_encode: rows must be contiguous bf16 or float32 (M, dim) or "
                         f"(U, M, dim), got {tuple(rows.shape)} {rows.dtype}")
    dim = rows.shape[-1]
    if codebook.dtype != torch.float32 or codebook.dim() != 2 or codebook.shape[1] != dim:
        raise ValueError(f"hsq_rows_encode: codebook must be (K, {dim}) float32, got "
                         f"{tuple(codebook.shape)} {codebook.dtype}")
    if codebook.device != rows.device or not codebook.is_contiguous():
        raise ValueError("hsq_rows_encode: codebook must be contiguous on the input's device")
    if code_dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"hsq_rows_encode: codes must be uint8 or int32, got {code_dtype}")
    k = codebook.shape[0]
    if k < 1 or (code_dtype == torch.uint8 and k > 256):
        raise ValueError(f"hsq_rows_encode: {k} codewords do not fit {code_dtype} codes")
    which = route(rows.dtype, dim)
    # the tensor-core kernel loads a row's pairs of values whole when dim is
    # a multiple of 8
    if which == TENSOR_CORE and dim % 8 == 0 and rows.data_ptr() % (2 * rows.element_size()):
        raise ValueError("hsq_rows_encode: rows must start on a pair of values")
    lead = rows.shape[:-1]
    u = torch.empty(lead, dtype=torch.float32, device=rows.device)
    codes = torch.empty(lead, dtype=code_dtype, device=rows.device)
    source, entry = _ROUTES[which]
    lib = _build.load(source)
    fn = getattr(lib, entry)
    args = [rows.data_ptr(), int(rows.dtype == torch.bfloat16), codebook.data_ptr(), k, dim,
            u.numel(), u.data_ptr(), codes.data_ptr(), int(code_dtype == torch.uint8)]
    argtypes = list(_ARGTYPES)
    if which == TENSOR_CORE_WIDE:
        # scratch for the codebook's bf16 pieces, which the C entry splits
        # once per call
        lib.gqx_hsq_rows_encode_wide_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gqx_hsq_rows_encode_wide_scratch_bytes.restype = ctypes.c_int64
        pieces = torch.empty(lib.gqx_hsq_rows_encode_wide_scratch_bytes(k, dim),
                             dtype=torch.uint8, device=rows.device)
        args.append(pieces.data_ptr())
        argtypes.append(ctypes.c_void_p)
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, _build.stream_ptr(rows.device))
    _build.check(lib, err, f"hsq_rows_encode ({which})")
    launches["hsq_rows_encode"] += 1
    launches_by_route[which] += 1
    return u, codes


def hsq_encode(rows: torch.Tensor, codebook: torch.Tensor, code_dtype=torch.int32):
    """rows (M, dim) or (U, M, dim) bf16 or float32, codebook (K, dim)
    float32 -> (u float32, codes) of (M,) / (U, M): p = rows @ codebook^T
    with float32-accurate products, code = argmax |p| (first index),
    u = p[code]."""
    if rows.device.type == "cpu":
        return hsq_encode_plain(rows, codebook, code_dtype)
    if rows.device.type != "cuda":
        raise ValueError(f"hsq_rows_encode: unsupported device {rows.device}")
    return _encode_kernel(rows, codebook, code_dtype)


# -- decode -----------------------------------------------------------------

def hsq_decode_plain(codes: torch.Tensor, u: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """The plain version (gqx's ``hsq_decode_xla``): a table gather and a
    row scale, codes/u (..., M) -> (..., M, dim) float32."""
    cb = codebook.to(device=u.device, dtype=torch.float32)
    return cb[codes.long()] * u.to(torch.float32)[..., None]


def _decode_kernel(codes, u, codebook):
    dim = codebook.shape[-1]
    check_signature("hsq_rows_decode", codes, u, codebook, dim)
    out = torch.empty(codes.shape + (dim,), dtype=torch.float32, device=u.device)
    lib = _build.load("hsq_rows_decode")
    fn = lib.gqx_hsq_rows_decode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(codes.data_ptr(), int(codes.dtype == torch.uint8), u.data_ptr(),
             codebook.data_ptr(), dim, codes.numel(), out.data_ptr(),
             _build.stream_ptr(u.device))
    _build.check(lib, err, "hsq_rows_decode")
    launches["hsq_rows_decode"] += 1
    return out


def hsq_decode(codes: torch.Tensor, u: torch.Tensor,
               codebook: torch.Tensor) -> torch.Tensor:
    """codes (uint8/int32, < K) and u float32 of (M,) or (U, M), codebook
    (K, dim) float32 -> rows (..., M, dim) = u * codebook[code], one float32
    product per element (bit-equal to the gather)."""
    if u.device.type == "cpu":
        return hsq_decode_plain(codes, u, codebook)
    if u.device.type != "cuda":
        raise ValueError(f"hsq_rows_decode: unsupported device {u.device}")
    return _decode_kernel(codes, u, codebook)
