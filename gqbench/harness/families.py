"""Device kernels into families, frozen here so that a change to the measured
program cannot move the yardstick.  Copied from the program's benchmark
module at the time this benchmark was written; later changes there are not
taken over.

A kernel written by hand is its own family, found by its ``__global__``
name; any other kernel by the host ops it was launched under, innermost
first: a batch-norm backward node, a batch-norm forward range, the foreach
ops of the SGD update, a convolution, a GEMM, a copy, else "the rest".
"""

from __future__ import annotations

import re
from typing import Sequence

# the hand-written kernels, by the name of their __global__ function
HAND_WRITTEN = {
    "hsq_encode_tc_kernel": "K1 hsq_encode",
    "hsq_decode_mean_kernel": "K2 hsq_decode_mean",
    "philox_uniform_kernel": "K3 philox_uniform",
    "gather_scale_kernel": "K4/K6 decode",
    "hsq_rows_encode_tc_kernel": "K6 rows_encode_tc",
    "hsq_rows_encode_wide_kernel": "K6 rows_encode_wide",
    "split_codebook_kernel": "K6 rows_encode_wide (codebook split)",
    "hsq_rows_encode_kernel": "K6 rows_encode (CUDA cores)",
    "per_user_dw_tc_kernel": "K7 per_user_dw_tc",
    "per_user_dw_narrow_kernel": "K7 per_user_dw_narrow",
    "per_user_dw_tc_f32_kernel": "K7 per_user_dw_tc_f32",
    "per_user_dw_narrow_f32_kernel": "K7 per_user_dw_narrow_f32",
    "per_user_dw_kernel": "K7 per_user_dw (CUDA cores)",
}
#: the range the benchmark puts round each batch norm's forward
BN_FORWARD = "gqbench::bn_forward"
BN_BACKWARD_NODE = "GroupedBatchNormBackward"
CONV_OPS = {"aten::convolution", "aten::_convolution", "aten::convolution_backward",
            "aten::cudnn_convolution", "aten::cudnn_convolution_transpose"}
GEMM_OPS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::matmul", "aten::einsum",
            "aten::linear", "aten::baddbmm"}
COPY_OPS = {"aten::copy_", "aten::_to_copy", "aten::to", "aten::clone", "aten::contiguous",
            "aten::cat", "aten::stack", "aten::constant_pad_nd"}
UNATTRIBUTED = "unattributed"


def kernel_tokens(kernel: str):
    return re.findall(r"[A-Za-z_]\w*", kernel)


def classify(kernel: str, ops: Sequence[str]) -> str:
    """The family of a device kernel from its name and the names of the host
    ops it was launched under, innermost first."""
    for token in kernel_tokens(kernel):
        if token in HAND_WRITTEN:
            return HAND_WRITTEN[token]
    if not ops:
        return UNATTRIBUTED
    if any(BN_BACKWARD_NODE in op for op in ops):
        return "BN backward"
    if BN_FORWARD in ops:
        return "BN forward"
    if any(op.startswith("aten::_foreach_") for op in ops):
        return "SGD update"
    for family, names in (("convolutions", CONV_OPS), ("GEMMs/einsums", GEMM_OPS),
                          ("casts and copies", COPY_OPS)):
        if any(op in names for op in ops):
            return family
    return "the rest"
