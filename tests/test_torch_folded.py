"""The port's folded-users layers and step against gqx's, float32 on the CPU
(where the port's per-user conv weight gradient is its plain version).

Layouts: gqx NHWC / HWIO / dense (in, out); the port NCHW / OIHW / dense
(out, in).  Tolerances are relative to each tensor's largest magnitude and
cover the different summation orders of the two frameworks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqx.ops.pallas_dw as gqx_dw
from gqx.config import GQConfig as GqxConfig
from gqx.models import create_model as gqx_create_model
from gqx.models import folded as gqx_folded
from gqx.parallel.packing import plan_units as gqx_plan_units
from gqx.train import TrainState as GqxTrainState
from gqx.train import evaluate as gqx_evaluate
from gqx.train import folded_user_grads as gqx_folded_user_grads
from gqx.train import make_eval_step as gqx_make_eval_step
from gqx_torch.config import GQConfig
from gqx_torch.convert import from_jax, leaf_paths
from gqx_torch.models import create_model
from gqx_torch.models.common import BatchNorm, Conv2d, Dense, same_pads, update_running_stats
from gqx_torch.models.folded import GroupedBatchNorm, folded_users
from gqx_torch.ops import dw as dw_ops
from gqx_torch.train import (create_train_state, evaluate, folded_user_grads, make_eval_step,
                             make_train_step, user_grads)


def _close(got, want, rtol=1e-5, msg=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * scale, err_msg=msg)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# -- the three layers ----------------------------------------------------------

@pytest.mark.parametrize("dw_impl", ["bgc", "pallas"])
@pytest.mark.parametrize("size,cin,cout,k,stride", [
    (8, 6, 10, 3, 1), (8, 3, 16, 3, 1), (4, 8, 8, 3, 1),   # the kernel's route
    (8, 6, 10, 1, 1), (8, 6, 10, 1, 2),                    # the batched contraction
    (8, 6, 10, 3, 2), (9, 5, 7, 3, 2)])                    # the library per user
def test_shared_conv_matches_gqx(rng, monkeypatch, dw_impl, size, cin, cout, k, stride):
    """dx on the folded batch and the per-user weight gradient, against
    gqx's shared_conv under its vmapped route and under its 'pallas' routing
    (the kernel in interpret mode)."""
    users, batch = 3, 2
    monkeypatch.setattr(gqx_folded, "DW_IMPL", dw_impl)
    monkeypatch.setattr(gqx_dw.pl, "pallas_call",
                        functools.partial(gqx_dw.pl.pallas_call, interpret=True))
    x = rng.standard_normal((users * batch, size, size, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    out = -(-size // stride)
    cot = rng.standard_normal((users * batch, out, out, cout)).astype(np.float32)

    def loss(xx, ghost):
        y = gqx_folded.shared_conv(xx, jnp.asarray(w), ghost, users, (stride, stride), "SAME")
        return jnp.sum(y * cot), y

    ghost0 = jnp.zeros((users,) + w.shape, jnp.float32)
    (dx_j, dku_j), y_j = jax.grad(loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), ghost0)

    conv = Conv2d(cin, cout, k, stride)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    xt = _nchw(x).requires_grad_(True)
    before = dw_ops.launches
    with folded_users(users) as ctx:
        y = conv(xt)
    ghost = ctx.ghosts[conv.weight]
    assert ghost.shape == (users, cout, cin, k, k) and ghost.stride() == (0,) * 5
    dx, dku, dw_shared = torch.autograd.grad((y * _nchw(cot)).sum(), [xt, ghost, conv.weight],
                                             allow_unused=True)
    assert dw_shared is None                 # the per-user gradients replace the total
    assert dw_ops.launches == before         # CPU tensors: the plain version
    _close(y.detach().numpy().transpose(0, 2, 3, 1), y_j)
    _close(dx.numpy().transpose(0, 2, 3, 1), dx_j)
    _close(dku.numpy().transpose(0, 3, 4, 2, 1), dku_j)


def test_shared_conv_routes_same_size_convs_to_the_kernel_wrapper(monkeypatch):
    """Stride-1 same-size KxK (K > 1) goes to per_user_dw with the conv's low
    pads; 1x1 and strided convs do not."""
    import gqx_torch.models.folded as folded

    calls = []
    real = folded.per_user_dw
    monkeypatch.setattr(folded, "per_user_dw",
                        lambda *a: calls.append(a[2:]) or real(*a))
    for k, stride, size in ((3, 1, 8), (2, 1, 5), (1, 1, 8), (1, 2, 8), (3, 2, 8)):
        conv = Conv2d(4, 6, k, stride)
        conv.reset_parameters(torch.Generator().manual_seed(0))
        with folded_users(2) as ctx:
            y = conv(torch.randn(4, 4, size, size))
        torch.autograd.grad(y.sum(), [ctx.ghosts[conv.weight]])
    assert calls == [(2, 3, 3, 1, 1), (2, 2, 2, same_pads(5, 2, 1)[0], same_pads(5, 2, 1)[0])]


def test_shared_dense_matches_gqx(rng):
    users, batch, cin, cout = 3, 4, 20, 7
    x = rng.standard_normal((users * batch, cin)).astype(np.float32)
    w = rng.standard_normal((cin, cout)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    cot = rng.standard_normal((users * batch, cout)).astype(np.float32)

    def loss(xx, ghost):
        return jnp.sum((gqx_folded.shared_dense(xx, jnp.asarray(w), ghost, users) + b) * cot)

    dx_j, dku_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.zeros((users, cin, cout)))
    dense = Dense(cin, cout)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T.copy()))
        dense.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    with folded_users(users) as ctx:
        y = dense(xt)
    dx, dku, db = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                      [xt, ctx.ghosts[dense.weight], dense.bias])
    assert dense.bias not in ctx.ghosts       # the bias gets the folded total
    _close(dx.numpy(), dx_j)
    _close(dku.numpy().transpose(0, 2, 1), dku_j)
    _close(db.numpy(), cot.sum(0))


def test_grouped_batch_norm_matches_gqx(rng):
    users, batch, size, c = 3, 4, 5, 6
    x = (rng.standard_normal((users * batch, size, size, c)) * 2 + 3).astype(np.float32)
    x[:batch, :, :, 0] = 1.5                       # a constant channel: clipped variance
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def loss(xx, gs, gb):
        bshape = (users, 1, 1, 1, c)
        y, stats = gqx_folded.grouped_batch_norm(
            xx, users, jnp.asarray(scale) + gs.reshape(bshape), jnp.asarray(bias) + gb.reshape(bshape))
        return jnp.sum(y * cot), (y, stats)

    zeros = jnp.zeros((users, c), jnp.float32)
    (dx_j, ds_j, db_j), (y_j, (mean_j, var_j)) = jax.grad(
        loss, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), zeros, zeros)

    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = _nchw(x).requires_grad_(True)
    with folded_users(users) as ctx:
        y = bn(xt)
    (mean, var), = bn.batch_stats
    assert mean.shape == var.shape == (users, c)
    dx, ds, db = torch.autograd.grad((y * _nchw(cot)).sum(),
                                     [xt, ctx.ghosts[bn.weight], ctx.ghosts[bn.bias]])
    _close(y.detach().numpy().transpose(0, 2, 3, 1), y_j)
    _close(mean.numpy(), mean_j, rtol=1e-6)
    _close(var.numpy(), var_j)
    assert float(var[0, 0]) == 0.0
    _close(dx.numpy().transpose(0, 2, 3, 1), dx_j, rtol=2e-5)
    _close(ds.numpy(), ds_j, rtol=2e-5)
    _close(db.numpy(), db_j)
    update_running_stats(bn)
    _close(bn.running_mean.numpy(), 0.1 * np.asarray(mean_j).mean(0), rtol=1e-6)
    _close(bn.running_var.numpy(), 0.9 + 0.1 * np.asarray(var_j).mean(0), rtol=1e-6)


def _bn_one_group(x, weight, bias, eps, dy):
    """Training BN over the whole batch as the per-user loop ran it before
    the groups were added: forward and analytic backward, op for op."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    y = (xf - mean[:, None, None]) * inv[:, None, None]
    y = (y * weight[:, None, None] + bias[:, None, None]).to(x.dtype)
    n = x.numel() // x.shape[1]
    xc = x.to(mean.dtype) - mean[:, None, None]
    dyf = dy.to(mean.dtype)
    s1 = dyf.sum(dim=(0, 2, 3))
    s2 = (dyf * (xc * inv[:, None, None])).sum(dim=(0, 2, 3))
    g1 = weight * inv
    g2 = s1 * g1 / n
    g5 = (var > 0).to(var.dtype) * -(s2 * g1 * inv) / n
    dx = g1[:, None, None] * dyf - g2[:, None, None] + xc * g5[:, None, None]
    return y, mean, var, dx.to(x.dtype), s2, s1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_with_one_group_is_bit_equal_to_the_ungrouped(rng, dtype):
    x = torch.from_numpy((rng.standard_normal((6, 5, 7, 7)) + 2).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((6, 5, 7, 7)).astype(np.float32)).to(dtype)
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(np.float32)).requires_grad_(True)
    bias = torch.from_numpy(rng.standard_normal(5).astype(np.float32)).requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    y, mean, var = GroupedBatchNorm.apply(xr, weight, bias, None, None, 1, 1e-5)
    dx, dw, db = torch.autograd.grad(y, [xr, weight, bias], dy)
    want = _bn_one_group(x, weight.detach(), bias.detach(), 1e-5, dy)
    for got, ref in zip((y.detach(), mean[0], var[0], dx, dw, db), want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    # and through the module, outside any folded context
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    assert torch.equal(bn(x), want[0])
    update_running_stats(bn)
    assert torch.equal(bn.running_mean, 0.9 * torch.zeros(5) + (1 - 0.9) * want[1])


# -- the folded step -----------------------------------------------------------

def _pair(rng, name, batch):
    """gqx's model and parameters (BN biases in [1, 2], which keeps ReLU
    inputs away from 0, where rounding could give them opposite signs in the
    two packages) and the port's model loaded with them."""
    shape = (28, 28, 1) if name == "fcn" else (32, 32, 3)
    gmodel = gqx_create_model(name, 10)
    v = gmodel.init(jax.random.PRNGKey(1), jnp.zeros((batch,) + shape), train=True)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.uniform(1.0, 2.0, a.shape).astype(np.float32))
        if "BatchNorm" in jax.tree_util.keystr(p) and "bias" in jax.tree_util.keystr(p) else a,
        v["params"])
    stats = jax.tree.map(
        lambda s: jnp.asarray(rng.uniform(0.5, 1.5, s.shape).astype(np.float32)),
        v.get("batch_stats", {}))
    model = create_model(name, 10)
    sd, _ = from_jax(model, jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, stats) if stats else None)
    model.load_state_dict(sd)
    return gmodel, params, stats, model, shape


@pytest.mark.parametrize("name", ["fcn", "resnet18"])
def test_folded_user_grads_match_gqx_and_the_loop(rng, name):
    """Every leaf and user within 1e-4 of the user's largest entry of the
    leaf against gqx's folded gradients, and within 2e-5 against the port's
    own per-user loop; losses and BN running statistics too."""
    users, batch = 2, 8
    gmodel, params, stats, model, shape = _pair(rng, name, batch)
    x = rng.standard_normal((users, batch) + shape).astype(np.float32)
    y = rng.integers(0, 10, (users, batch))
    kw = dict(network=name, quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, num_users=users)
    gplan = gqx_plan_units(params, GqxConfig(**kw))
    losses_j, grads_j, stats_j = jax.jit(
        lambda p, s, xx, yy: gqx_folded_user_grads(gmodel, gplan, users, p, s, xx, yy)
    )(params, stats, jnp.asarray(x), jnp.asarray(y))

    state, plan = create_train_state(GQConfig(**kw), model, device="cpu")
    names = plan.names
    xt, yt = torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()), torch.from_numpy(y)
    losses_f, grads_f = folded_user_grads(model, plan, names, xt, yt)
    running_f = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    update_running_stats(model)
    stats_f = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    model.load_state_dict(running_f, strict=False)
    losses_l, grads_l = user_grads(model, names, xt, yt)
    update_running_stats(model)

    np.testing.assert_allclose(losses_f.numpy(), np.asarray(losses_j), rtol=1e-5)
    np.testing.assert_allclose(losses_f.numpy(), losses_l.numpy(), rtol=1e-6)
    conv = [from_jax(model, jax.tree.map(lambda a: np.asarray(a[i]), grads_j))[0]
            for i in range(users)]
    paths = leaf_paths(model)
    for n in names:
        got = grads_f[n].numpy()
        assert got.shape == (users,) + tuple(model.get_parameter(n).shape)
        assert grads_f[n].dtype == torch.float32
        want = np.stack([c[n].numpy() for c in conv])
        loop = grads_l[n].numpy()
        if isinstance(model.get_submodule(n.rsplit(".", 1)[0]), Dense) and n.endswith("bias"):
            # no ghost: the folded total / U for every user, in both packages
            assert np.array_equal(got[0], got[1])
            loop = np.broadcast_to(loop.mean(0), loop.shape)
        for u in range(users):
            _close(got[u], want[u], rtol=1e-4, msg=f"{paths[n]} user {u} vs gqx")
            _close(got[u], loop[u], rtol=2e-5, msg=f"{paths[n]} user {u} vs the loop")
    if stats:
        sd, _ = from_jax(model, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats_j))
        for k, v in stats_f.items():
            _close(v.numpy(), sd[k].numpy(), rtol=1e-5)
            _close(v.numpy(), model.state_dict()[k].numpy(), rtol=1e-6)


def test_folded_refuses_a_compressed_leaf_without_a_ghost():
    """A dense bias above the passthrough threshold would be compressed with
    a gradient that is not per user (gqx asserts the same)."""
    cfg = GQConfig(network="fcn", quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, num_users=2,
                   passthrough_threshold=100)
    state, plan = create_train_state(cfg, create_model("fcn", 10), device="cpu")
    x, y = torch.randn(2, 2, 1, 28, 28), torch.randint(0, 10, (2, 2))
    with pytest.raises(ValueError, match="fc1.bias"):
        folded_user_grads(state.model, plan, plan.names, x, y)
    cfg.folded_users = False
    assert torch.isfinite(make_train_step(cfg, plan)(state, x, y, 0.1, 5e-4,
                                                      torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("name", ["fcn", "resnet18"])
def test_eval_step_and_evaluate_match_gqx(rng, name):
    batch = 4
    gmodel, params, stats, model, shape = _pair(rng, name, batch)
    batches = [(rng.standard_normal((n,) + shape).astype(np.float32), rng.integers(0, 10, (n,)))
               for n in (batch, batch, 3)]
    g_step = gqx_make_eval_step(gmodel)
    gstate = GqxTrainState(params, stats, None, None, jnp.zeros((), jnp.int32))
    want = gqx_evaluate(g_step, gstate, [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches])
    step = make_eval_step(model)
    model.train()
    got = evaluate(step, [(_nchw(x), torch.from_numpy(y)) for x, y in batches])
    assert model.training                       # left in the mode it was in
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == want[1]
    loss, correct = step(_nchw(batches[0][0]), torch.from_numpy(batches[0][1]))
    loss_j, correct_j = g_step(params, stats, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert int(correct) == int(correct_j)
    assert evaluate(step, []) == (0.0, 0.0)
