"""The grouped batch norm's wrapper (``gqx_torch.ops.bn``) on the CPU: a CPU
tensor takes the plain version, the arithmetic the folded step ran before
the kernels, and launches nothing (tests/test_torch_folded.py holds that
version to gqx through ``GroupedBatchNorm``); and ``plan``, which chooses the
kernels' route and tile, at every batch-norm shape of the benchmark's cells
and beside them.  The kernels themselves run on the card only
(tests/test_torch_cuda.py)."""

import functools

import numpy as np
import pytest
import torch

from gqx_torch.models import create_model
from gqx_torch.models.common import BatchNorm, batch_norm_planes
from gqx_torch.ops import bn as bn_ops

H100 = 232448   # the shared memory a block may opt into


@functools.lru_cache(maxsize=None)
def _planes(network):
    """{(C, H, W): count} of ``network``'s batch norms."""
    return batch_norm_planes(create_model(network, 10))


def test_batch_norm_planes_reads_each_batch_norm_once():
    """ResNet-50's 53 batch norms at 32x32 fall on 11 planes; the model
    keeps its mode and no hook stays behind."""
    model = create_model("resnet50", 10)
    planes = batch_norm_planes(model)
    assert planes == {(64, 32, 32): 7, (256, 32, 32): 4, (128, 32, 32): 1, (128, 16, 16): 7,
                      (512, 16, 16): 5, (256, 16, 16): 1, (256, 8, 8): 11, (1024, 8, 8): 7,
                      (512, 8, 8): 1, (512, 4, 4): 5, (2048, 4, 4): 4}
    assert model.training
    assert not any(m._forward_pre_hooks for m in model.modules() if isinstance(m, BatchNorm))
    assert batch_norm_planes(create_model("fcn", 10)) == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("users", [1, 3])
def test_a_cpu_tensor_takes_the_plain_version(rng, dtype, users):
    x = torch.from_numpy(rng.standard_normal((users * 4, 5, 6, 7)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(dtype)
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    before = bn_ops.launches, dict(bn_ops.launches_by_route)
    got = bn_ops.grouped_bn_forward(x, weight, bias, users, 1e-5)
    want = bn_ops.forward_plain(x, weight, bias, users, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, mean, var, inv = got
    got = bn_ops.grouped_bn_backward(x, dy, mean, var, inv, weight, users)
    want = bn_ops.backward_plain(x, dy, mean, var, inv, weight, users)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == dtype and got[1].shape == got[2].shape == (users, 5)
    assert (bn_ops.launches, bn_ops.launches_by_route) == before


def test_the_wrapper_refuses_bad_shapes():
    x = torch.randn(6, 3, 4, 4)
    with pytest.raises(ValueError):
        bn_ops.grouped_bn_forward(x[0], torch.ones(3), torch.zeros(3), 1, 1e-5)
    with pytest.raises(ValueError):
        bn_ops.grouped_bn_forward(x, torch.ones(3), torch.zeros(3), 4, 1e-5)
    _, mean, var, inv = bn_ops.grouped_bn_forward(x, torch.ones(3), torch.zeros(3), 2, 1e-5)
    with pytest.raises(ValueError):
        bn_ops.grouped_bn_backward(x, x[:, :2], mean, var, inv, torch.ones(3), 2)


def _cells():
    """(users, C, H, W) of every batch norm of the benchmark's three cells,
    32 images a user: ResNet-50 at 32 and 16 users, VGG-16 at 64."""
    return sorted({(u,) + s for net, u in (("resnet50", 32), ("resnet50", 16), ("vgg16", 64))
                   for s in _planes(net)})


def test_every_batch_norm_of_the_cells_is_read_once():
    cells = _cells()
    assert len(_planes("resnet50")) == 11 and sum(_planes("resnet50").values()) == 53
    assert sum(_planes("vgg16").values()) == 13 and len(cells) == 27
    for users, c, h, w in cells:
        for backward in (False, True):
            p = bn_ops.plan(32, c, h * w, torch.bfloat16, backward, H100)
            assert p.route == bn_ops.SMEM, (users, c, h, w, backward)


# (C, H*W) -> (tile, vec, threads forward, threads backward) of the cells' bf16
# batch norms at 32 images a user, whatever the users: one channel a block at
# 32x32 (its group is 64 KB, 128 KB backward: one block a multiprocessor, so
# 1,024 threads), two at 16x16, eight at 8x8, 32 at 4x4 and 2x2 (32 KB of x a
# block); 16-byte accesses but at 2x2 (8 bytes)
CELL_PLANS = {(64, 1024): (1, 8, 256, 1024), (256, 1024): (1, 8, 256, 1024),
              (128, 1024): (1, 8, 256, 1024), (128, 256): (2, 8, 256, 256),
              (512, 256): (2, 8, 256, 256), (256, 256): (2, 8, 256, 256),
              (256, 64): (8, 8, 256, 256), (1024, 64): (8, 8, 256, 256),
              (512, 64): (8, 8, 256, 256), (512, 16): (32, 8, 256, 256),
              (2048, 16): (32, 8, 256, 256), (512, 4): (32, 4, 256, 256)}


def test_the_cells_plans():
    for users, c, h, w in _cells():
        tile, vec, t_fwd, t_bwd = CELL_PLANS[(c, h * w)]
        fwd = bn_ops.plan(32, c, h * w, torch.bfloat16, False, H100)
        bwd = bn_ops.plan(32, c, h * w, torch.bfloat16, True, H100)
        assert (fwd.tile, fwd.vec, fwd.threads) == (tile, vec, t_fwd)
        assert (bwd.tile, bwd.vec, bwd.threads) == (tile, vec, t_bwd)
        assert bwd.smem == 2 * fwd.smem == 2 * tile * 32 * h * w * 2


def _shapes():
    """(users, images a user, C, H*W, dtype) of the cells, DenseNet-BC at 8
    and 32 users, the per-user loop (one user), float32 compute, a larger
    batch and odd planes."""
    out = [(u, 32, c, h * w, torch.bfloat16) for u, c, h, w in _cells()]
    out += [(u, 32, c, h * w, torch.bfloat16) for u in (8, 32) for c, h, w in _planes("dense")]
    out += [(1, 32, c, h * w, torch.bfloat16) for c, h, w in _planes("resnet50")]
    out += [(8, 32, c, h * w, torch.float32) for net in ("resnet18", "resnet50", "vgg16")
            for c, h, w in _planes(net)]
    out += [(2, 128, 8, 1024, torch.bfloat16), (3, 5, 7, 63, torch.bfloat16),
            (2, 3, 10, 6, torch.bfloat16), (2, 3, 5, 1, torch.float32)]
    return out


@pytest.mark.parametrize("backward", [False, True])
def test_plans_are_a_function_of_shape_dtype_and_shared_memory(backward):
    """Every plan: whole groups in a block, a power-of-two tile that the
    threads cover (8 a channel at least) and that holds at most 32 KB of x
    where it holds more than one channel, staged groups within the shared
    memory, the widest access that H*W allows; the same plan again for the
    same arguments, and another route where the shared memory is
    smaller.  The number of users is no argument: it cannot change the
    order of a group's sums."""
    for _, batch, c, hw, dtype in _shapes():
        p = bn_ops.plan(batch, c, hw, dtype, backward, H100)
        size = dtype.itemsize
        group = batch * hw * size * (2 if backward else 1)
        assert p.tile & (p.tile - 1) == 0 and 1 <= p.tile <= p.threads // 8
        assert p.tile == 1 or p.tile * batch * hw * size <= bn_ops.TILE_BYTES
        assert hw % p.vec == 0 and p.vec * size <= 16 and (p.vec * size == 16 or hw % (2 * p.vec))
        if p.route == bn_ops.SMEM:
            assert p.smem == p.tile * group <= H100 - bn_ops.RESERVED
            assert p.threads == (bn_ops.LARGE_BLOCK if 2 * p.smem > H100
                                 else bn_ops.SMALL_BLOCK)
        else:
            assert group > H100 - bn_ops.RESERVED
            assert (p.smem, p.threads) == (0, bn_ops.SMALL_BLOCK)
        assert bn_ops.plan(batch, c, hw, dtype, backward, H100) == p
    # float32 at 32x32: the forward's 128 KB group staged, the backward's 256 KB not
    f32 = [bn_ops.plan(32, 64, 1024, torch.float32, b, H100) for b in (False, True)]
    assert [(p.route, p.threads) for p in f32] == [(bn_ops.SMEM, 1024), (bn_ops.TWO_PASS, 256)]
    # the same shapes on a card with 100 KB a block: the 32x32 backward no longer fits
    small = bn_ops.plan(32, 64, 1024, torch.bfloat16, True, 100 * 1024)
    assert (small.route, small.smem) == (bn_ops.TWO_PASS, 0)
