"""gqx_torch's models against gqx's, with gqx's weights carried over by
``gqx_torch.convert.from_jax``.  Float32 on the CPU; tolerances cover the
different summation order of the two frameworks' convolutions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gqx.config import GQConfig as GqxConfig
from gqx.models import create_model as gqx_create_model
from gqx.parallel.packing import plan_units as gqx_plan_units
from gqx.train import folded_user_grads
from gqx_torch.convert import from_jax, leaf_paths
from gqx_torch.models import create_model
from gqx_torch.models.common import Conv2d, Dense, update_running_stats
from gqx_torch.train import user_grads


@pytest.mark.parametrize("name,want", [
    ("fcn", 203530), ("resnet18", 11173962), ("resnet34", 21282122),
    ("resnet50", 23520842)])
def test_param_count(name, want):
    model = create_model(name, 10)
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("size,k,stride", [
    (32, 3, 2), (32, 3, 1), (8, 1, 2), (9, 3, 2), (9, 1, 2), (4, 3, 2)])
def test_conv_same_padding_matches_xla(rng, size, k, stride):
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 7)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = Conv2d(5, 7, k, stride)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        got = conv(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _gqx_model_and_port(rng, name, batch):
    shape = (batch, 28, 28, 1) if name == "fcn" else (batch, 32, 32, 3)
    gmodel = gqx_create_model(name, 10)
    v = gmodel.init(jax.random.PRNGKey(1), jnp.zeros(shape), train=True)
    params = v["params"]
    stats = jax.tree.map(
        lambda s: jnp.asarray(rng.uniform(0.5, 1.5, s.shape).astype(np.float32)),
        v.get("batch_stats", {}))
    model = create_model(name, 10)
    sd, _ = from_jax(model, jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, stats) if stats else None)
    model.load_state_dict(sd)
    x = rng.standard_normal(shape).astype(np.float32)
    return gmodel, params, stats, model, x


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, rtol=1e-4, msg=""):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=msg)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_forward_parity_train_and_eval(rng, name):
    gmodel, params, stats, model, x = _gqx_model_and_port(rng, name, 2)
    want_eval = gmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    want_train, mutated = gmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                       train=True, mutable=["batch_stats"])
    with torch.no_grad():
        model.eval()
        got_eval = model(_nchw(x))
        model.train()
        got_train = model(_nchw(x))
        update_running_stats(model)
    _close(got_eval.numpy(), np.asarray(want_eval))
    _close(got_train.numpy(), np.asarray(want_train))
    sd, _ = from_jax(model, jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, mutated["batch_stats"]))
    for k, v in model.state_dict().items():
        if "running" in k:
            _close(v.numpy(), sd[k].numpy())


def test_fcn_forward_parity(rng):
    gmodel, params, _, model, x = _gqx_model_and_port(rng, "fcn", 3)
    want = gmodel.apply({"params": params}, jnp.asarray(x), train=True)
    with torch.no_grad():
        got = model(_nchw(x))
    _close(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("name", ["fcn", "resnet18"])
def test_per_user_grads_match_folded(rng, name):
    """The port's per-user loop vs gqx's folded-users gradients (its
    production path), every leaf and user, within 1e-4 of each user's
    largest entry of the leaf, and the BN statistics.

    A ReLU input within float32 rounding of zero can take opposite signs in
    the two packages, and one such flip moves a ResNet leaf's gradient by up
    to a few percent.  So the BN biases are drawn from [1, 2], which keeps
    ReLU inputs away from zero, and each user has 8 images, which keeps the
    fast variance E[x^2] - E[x]^2 well conditioned."""
    users, batch = 2, 8
    gmodel, params, stats, model, _ = _gqx_model_and_port(rng, name, batch)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.uniform(1.0, 2.0, a.shape).astype(np.float32))
        if "BatchNorm" in jax.tree_util.keystr(p) and "bias" in jax.tree_util.keystr(p) else a,
        params)
    sd, _ = from_jax(model, jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, stats) if stats else None)
    model.load_state_dict(sd)
    shape = (users, batch) + ((28, 28, 1) if name == "fcn" else (32, 32, 3))
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, 10, (users, batch))
    cfg = GqxConfig(quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, num_users=users)
    gplan = gqx_plan_units(params, cfg)
    losses_j, grads_j, stats_j = jax.jit(
        lambda p, s, xx, yy: folded_user_grads(gmodel, gplan, users, p, s, xx, yy)
    )(params, stats, jnp.asarray(x), jnp.asarray(y))

    model.train()
    names = [n for n, _ in model.named_parameters()]
    xt, yt = torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()), torch.from_numpy(y)
    losses_t, grads_t = user_grads(model, names, xt, yt)
    np.testing.assert_allclose(losses_t.detach().numpy(), np.asarray(losses_j), rtol=1e-5)

    conv = [from_jax(model, jax.tree.map(lambda a: np.asarray(a[i]), grads_j))[0]
            for i in range(users)]
    paths = leaf_paths(model)
    for n in names:
        got, want = grads_t[n].numpy(), np.stack([c[n].numpy() for c in conv])
        if isinstance(model.get_submodule(n.rsplit(".", 1)[0]), Dense) and n.endswith("bias"):
            # gqx gives leaves without a ghost (dense biases, all in the
            # passthrough unit) the folded total / U; that unit only ever
            # sums them, so compare the sums
            got, want = got.sum(0)[None], want.sum(0)[None]
        for u in range(got.shape[0]):
            _close(got[u], want[u], msg=f"{paths[n]} user {u}")
    if stats:
        update_running_stats(model)
        sd, _ = from_jax(model, jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, stats_j))
        for k, v in model.state_dict().items():
            if "running" in k:
                _close(v.numpy(), sd[k].numpy())
