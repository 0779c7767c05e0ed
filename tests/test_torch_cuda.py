"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc, and skips without them.  The
file imports neither jax nor gqx, so it also runs where only the port is
installed; there, skip the repository's conftest (which sets up jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gqx_torch.ops import hsq as hsq_ops
from gqx_torch.ops import rand as rand_ops
from gqx_torch.ops.hsq_prep import bf16_exact_codebook

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


@pytest.mark.parametrize("passes", [1, 2])
def test_cuda_kernels_match_plain(cuda_device, passes):
    cb_np = _codebook(0, 256, 16)
    cb = torch.from_numpy(cb_np).to(cuda_device)
    x = torch.from_numpy(_encode_inputs(0, cb_np, 4, 4096)).to(cuda_device)
    before = dict(hsq_ops.launches), rand_ops.launches
    u, c = hsq_ops.hsq_encode_flat(x, cb, 16, passes)
    up, cp = hsq_ops.hsq_encode_flat_plain(x, cb, 16, passes)
    assert torch.equal(c[:, :8].cpu(), torch.tensor([[0, 0, 0, 0, 1, 0, 2, 2]] * 4,
                                                    dtype=torch.uint8))
    assert bool((u[:, :4] == 0).all())
    assert int((c != cp).sum()) <= 2
    same = c == cp
    torch.testing.assert_close(u[same], up[same], rtol=1e-6, atol=0)
    d = hsq_ops.hsq_decode_mean(c, u, cb, 16, passes)
    dp = hsq_ops.hsq_decode_mean_plain(c, u, cb, 16, passes)
    tol = 1e-6 * hsq_ops.hsq_decode_mean_plain(c, u.abs(), cb.abs(), 16, 2)
    assert bool(((d - dp).abs() <= tol).all())
    r = rand_ops.uniform(99, 5, (3, 70001), cuda_device)
    assert torch.equal(r, rand_ops.uniform_plain(99, 5, (3, 70001), cuda_device))
    assert rand_ops.uniform(99, 5, (0,), cuda_device).numel() == 0
    # one launch per wrapper call that had work, none for the plain versions
    assert hsq_ops.launches["hsq_encode"] == before[0]["hsq_encode"] + 1
    assert hsq_ops.launches["hsq_decode_mean"] == before[0]["hsq_decode_mean"] + 1
    assert rand_ops.launches == before[1] + 1


def test_cuda_wrappers_refuse_bad_input(cuda_device):
    cb = torch.from_numpy(_codebook(1, 256, 16)).to(cuda_device)
    x = torch.randn(2, 320, device=cuda_device)
    with pytest.raises(ValueError):
        hsq_ops.hsq_encode_flat(x.t().contiguous().t(), cb, 16, 1)     # not contiguous
    with pytest.raises(ValueError):
        hsq_ops.hsq_encode_flat(x.double(), cb, 16, 1)
    with pytest.raises(ValueError):
        hsq_ops.hsq_encode_flat(x, cb.cpu(), 16, 1)                      # codebook elsewhere
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
