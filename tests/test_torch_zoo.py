"""The port's VGG, DenseNet-BC and LeNet CNN against gqx's, on the CPU.

Builders at full width (parameter counts and leaf paths, from gqx's
``jax.eval_shape``, which compiles nothing); at small widths the forward in
train and eval mode, max pooling with tied windows, the per-user gradients
(folded and looped), two HSQ training steps, and the CLI.  The small
models: a VGG whose configuration reaches a 2x2 stage, on 16x16x3;
``DenseNet((2, 2), growth_rate=4)`` on 16x16x3; the CNN at its own
28x28x1 (HSQ at c_dim 8: gqx's subvector rule finds no dim for the CNN's
25,000 conv weights at c_dim 16, in either package).
"""

import csv
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqx.compress.vq as gqx_vq
from gqx.config import GQConfig as GqxConfig
from gqx.models import create_model as gqx_create_model
from gqx.models.cnn import CNN as GqxCNN
from gqx.models.common import max_pool as gqx_max_pool
from gqx.models.densenet import (DenseNet121 as GqxDenseNet121, DenseNet161 as GqxDenseNet161,
                                 DenseNet169 as GqxDenseNet169, DenseNet201 as GqxDenseNet201)
from gqx.models.densenet import DenseNet as GqxDenseNet
from gqx.models.vgg import VGG as GqxVGG
from gqx.ops import pallas_hsq4
from gqx.parallel.packing import plan_units as gqx_plan_units
from gqx.train import create_train_state as gqx_create_state
from gqx.train import folded_user_grads as gqx_folded_user_grads
from gqx.train import make_train_step as gqx_make_step
from gqx_torch import models as zoo
from gqx_torch.cli import main as cli_main
from gqx_torch.config import GQConfig
from gqx_torch.convert import from_jax, leaf_paths
from gqx_torch.data import datasets
from gqx_torch.models import create_model
from gqx_torch.models.cnn import CNN
from gqx_torch.models.common import Conv2d, Dense, max_pool, update_running_stats
from gqx_torch.models.densenet import DenseNet
from gqx_torch.models.vgg import VGG
from gqx_torch.train import create_train_state, folded_user_grads, make_train_step, user_grads

# 16 -> 8 -> 4 -> 2 -> 1; 119,808 compressed weights, so the HSQ unit has two
# of gqx's kernel tiles (XLA's CPU backend cannot run gqx's single-tile bf16
# decode-mean dot in interpret mode, tests/test_torch_compress.py)
SMALL_VGG = (16, "M", 64, 64, "M", 64, "M", 64, "M")


@pytest.fixture(autouse=True)
def few_threads():
    """The suite runs in several worker processes on one host, and torch's
    default of a thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _small(name, dtype="float32"):
    """(gqx's model, the port's, image shape, HSQ c_dim) at small widths."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    if name == "vgg":
        return GqxVGG(SMALL_VGG, 10, jd), VGG(SMALL_VGG, 10, td, image_shape=(16, 16, 3)), \
            (16, 16, 3), 16
    if name == "dense":
        return (GqxDenseNet((2, 2), growth_rate=4, dtype=jd),
                DenseNet((2, 2), growth_rate=4, dtype=td, image_shape=(16, 16, 3)), (16, 16, 3), 16)
    return GqxCNN(10), CNN(10), (28, 28, 1), 8


def _paired(rng, name, batch, dtype="float32"):
    """gqx's small model and parameters (BN biases in [1, 2], which keeps
    ReLU inputs away from 0, where rounding could give them opposite signs
    in the two packages; running statistics in [0.5, 1.5]) and the port's
    model loaded with them."""
    gmodel, model, shape, c_dim = _small(name, dtype)
    v = jax.jit(functools.partial(gmodel.init, train=True))(jax.random.PRNGKey(1),
                                                            jnp.zeros((batch,) + shape))
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.uniform(1.0, 2.0, a.shape).astype(np.float32))
        if "BatchNorm" in jax.tree_util.keystr(p) and "bias" in jax.tree_util.keystr(p) else a,
        v["params"])
    stats = jax.tree.map(lambda s: jnp.asarray(rng.uniform(0.5, 1.5, s.shape).astype(np.float32)),
                         v.get("batch_stats", {}))
    _load(model, params, stats)
    return gmodel, params, stats, model, shape, c_dim


def _load(model, params, stats=None):
    sd, _ = from_jax(model, jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, stats) if stats else None)
    model.load_state_dict(sd)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got, want, rtol, atol_scale=None, msg=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if atol_scale is None else atol_scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * scale, err_msg=msg)


# -- the builders at full width ------------------------------------------------

GQX_COUNTS = {"vgg11": 9_231_114, "vgg16": 14_728_266, "dense": 1_000_618,
              "cnn": 431_080}   # tests/test_models.py
BUILDERS = {
    "vgg11": (lambda: gqx_create_model("vgg11", 10), lambda: create_model("vgg11", 10)),
    "vgg13": (lambda: gqx_create_model("vgg13", 10), lambda: create_model("vgg13", 10)),
    "vgg16": (lambda: gqx_create_model("vgg16", 10), lambda: create_model("vgg16", 10)),
    "vgg19": (lambda: gqx_create_model("vgg19", 10), lambda: create_model("vgg19", 10)),
    "dense": (lambda: gqx_create_model("dense", 10), lambda: create_model("dense", 10)),
    "cnn": (lambda: gqx_create_model("cnn", 10), lambda: create_model("cnn", 10)),
    "DenseNet121": (lambda: GqxDenseNet121(10), lambda: zoo.DenseNet121(10)),
    "DenseNet169": (lambda: GqxDenseNet169(10), lambda: zoo.DenseNet169(10)),
    "DenseNet201": (lambda: GqxDenseNet201(10), lambda: zoo.DenseNet201(10)),
    "DenseNet161": (lambda: GqxDenseNet161(10), lambda: zoo.DenseNet161(10)),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builders_match_gqx_counts_and_leaf_paths(name):
    """Each builder's parameter count is gqx's (the known counts of
    tests/test_models.py, the others from gqx's ``eval_shape``); its
    ``leaf_paths`` are gqx's flattened parameter paths; and ``from_jax``
    fills the whole state_dict from gqx's trees at their shapes with
    nothing left over on either side."""
    gbuild, build = BUILDERS[name]
    shape = (1, 28, 28, 1) if name == "cnn" else (1, 32, 32, 3)
    v = jax.eval_shape(lambda: gbuild().init(jax.random.PRNGKey(0), jnp.zeros(shape), train=True))
    flat = {"/".join(str(k.key) for k in p): a.shape
            for p, a in jax.tree_util.tree_flatten_with_path(v["params"])[0]}
    model = build()
    want = GQX_COUNTS.get(name, sum(int(np.prod(s)) for s in flat.values()))
    assert sum(p.numel() for p in model.parameters()) == want
    assert sorted(leaf_paths(model).values()) == sorted(flat)
    zeros = lambda tree: jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    sd, _ = from_jax(model, zeros(v["params"]), zeros(v.get("batch_stats", {})) or None)
    model.load_state_dict(sd)   # strict: every parameter and buffer
    extra = dict(zeros(v["params"]))
    extra["Extra_0"] = {"kernel": np.zeros(1, np.float32)}
    with pytest.raises(KeyError, match="no port counterpart"):
        from_jax(model, extra)


# -- forward, pooling, dtype and shape rules -----------------------------------

@pytest.mark.parametrize("name", ["vgg", "dense", "cnn"])
def test_forward_parity_train_and_eval(rng, name):
    """Logits in eval mode (running statistics) and train mode (batch
    statistics), and the running statistics after the train-mode forward,
    to 1e-4 of their scale (tests/test_torch_models.py's float32 rtol)."""
    gmodel, params, stats, model, shape, _ = _paired(rng, name, 4)
    x = rng.standard_normal((4,) + shape).astype(np.float32)
    variables = {"params": params, "batch_stats": stats} if stats else {"params": params}
    want_eval = jax.jit(functools.partial(gmodel.apply, train=False))(variables, jnp.asarray(x))
    want_train, mutated = jax.jit(functools.partial(gmodel.apply, train=True,
                                                    mutable=["batch_stats"]))(variables, jnp.asarray(x))
    with torch.no_grad():
        model.eval()
        got_eval = model(_nchw(x))
        model.train()
        got_train = model(_nchw(x))
        update_running_stats(model)
    _close(got_eval.numpy(), want_eval, rtol=1e-4)
    _close(got_train.numpy(), want_train, rtol=1e-4)
    if stats:
        sd, _ = from_jax(model, jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, mutated["batch_stats"]))
        running = {k: v for k, v in model.state_dict().items() if "running" in k}
        assert running
        for k, v in running.items():
            _close(v.numpy(), sd[k].numpy(), rtol=1e-4, msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_ties_route_the_gradient_as_flax(rng, dtype):
    """Windows whose maxima tie (all four equal, two or three equal, at
    every pair of positions) on positive values exact in bf16, and an odd
    side (the last row and column dropped): the forward and the gradient
    equal flax's bit for bit (both send a tied window's gradient to its
    first maximum in row-major order)."""
    levels = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
    x = levels[rng.integers(0, 4, (3, 9, 9, 5))]
    x[0, :2, :2, 0] = 1.5                     # all four equal
    x[0, 2:4, 2:4, 1] = [[1.0, 2.0], [2.0, 0.5]]
    x[0, 4:6, 4:6, 2] = [[2.0, 1.0], [1.0, 2.0]]
    cot = rng.standard_normal((3, 4, 4, 5)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jd)
    y_j, vjp = jax.vjp(lambda a: gqx_max_pool(a, 2), xj)
    dx_j = vjp(jnp.asarray(cot).astype(jd))[0]
    xt = _nchw(x).to(td).requires_grad_(True)
    y = max_pool(xt, 2)
    dx, = torch.autograd.grad(y, xt, _nchw(cot).to(td))
    got = lambda t: t.detach().float().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got(y), np.asarray(y_j.astype(jnp.float32)))
    np.testing.assert_array_equal(got(dx), np.asarray(dx_j.astype(jnp.float32)))
    assert int((got(dx)[0, :2, :2, 0] != 0).sum()) == 1 and got(dx)[0, 0, 0, 0] != 0


def test_cnn_is_float32_whatever_dtype_is_asked():
    """gqx builds the CNN without a compute dtype; so does the port."""
    model = create_model("cnn", 10, "bfloat16")
    assert all(m.dtype == torch.float32 for m in model.modules() if isinstance(m, (Conv2d, Dense)))
    out = model(torch.randn(2, 1, 28, 28))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.exp().sum(-1).detach().numpy(), 1.0, rtol=1e-5)   # log-softmax


@pytest.mark.parametrize("name,shape", [("vgg16", (28, 28, 1)), ("dense", (28, 28, 1)),
                                        ("cnn", (12, 12, 1)), ("resnet18", (16, 16, 3))])
def test_an_empty_pooled_map_raises(name, shape):
    """Where the image pools to nothing before the classifier (gqx dies in
    its init with a ZeroDivisionError), the port names the network and the
    shape and builds no zero-width classifier."""
    with pytest.raises(ValueError, match=rf"image shape \({shape[0]}, {shape[1]}, {shape[2]}\)"):
        create_model(name, 10, image_shape=shape)


# -- the per-user gradients ----------------------------------------------------

def _pre_bn_conv_bias(model, n):
    """A conv bias that a BatchNorm normalizes away: each user's gradient is
    zero in exact arithmetic (BN is invariant to a per-channel shift of its
    input), so both packages compute rounding noise.  It is held against
    the scale of its conv's weight gradient instead of its own."""
    mod = model.get_submodule(n.rsplit(".", 1)[0])
    return isinstance(model, VGG) and isinstance(mod, Conv2d) and n.endswith("bias")


def _grads(rng, name, dtype, users=2, batch=8):
    """The port's folded and looped per-user gradients, and gqx's folded
    ones, from the same weights and batch; each {name: (U, *shape)}."""
    gmodel, params, stats, model, shape, c_dim = _paired(rng, name, batch, dtype)
    x = rng.standard_normal((users, batch) + shape).astype(np.float32)
    y = rng.integers(0, 10, (users, batch))
    kw = dict(quantizer="hsq", c_dim=c_dim, k_bit=8, n_bit=6, num_users=users,
              compute_dtype=dtype)
    gplan = gqx_plan_units(params, GqxConfig(**kw))
    losses_j, grads_j, _ = jax.jit(
        lambda p, s, xx, yy: gqx_folded_user_grads(gmodel, gplan, users, p, s, xx, yy)
    )(params, stats, jnp.asarray(x), jnp.asarray(y))
    state, plan = create_train_state(GQConfig(**kw), model, device="cpu")
    xt, yt = torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()), torch.from_numpy(y)
    losses_f, grads_f = folded_user_grads(model, plan, plan.names, xt, yt)
    losses_l, grads_l = user_grads(model, plan.names, xt, yt)
    conv = [from_jax(model, jax.tree.map(lambda a: np.asarray(a[i]), grads_j))[0]
            for i in range(users)]
    gqx = {n: np.stack([c[n].numpy() for c in conv]) for n in plan.names}
    folded = {n: g.numpy() for n, g in grads_f.items()}
    loop = {}
    for n in plan.names:
        g = grads_l[n].numpy()
        if not _ghosted(model, n):
            # no ghost (biases): every user gets the folded total / U
            assert np.array_equal(folded[n][0], folded[n][-1])
            g = np.broadcast_to(g.mean(0), g.shape)
        loop[n] = g
    return model, plan.names, (losses_f, losses_l, losses_j), folded, loop, gqx


def _ghosted(model, n):
    mod = model.get_submodule(n.rsplit(".", 1)[0])
    return not (isinstance(mod, (Conv2d, Dense)) and n.endswith("bias"))


@pytest.mark.parametrize("name", ["vgg", "dense", "cnn"])
def test_folded_user_grads_match_gqx_and_the_loop_float32(rng, name):
    """Every leaf and user within 1e-4 of the user's largest entry of the
    leaf against gqx's folded gradients and within 2e-5 against the port's
    own loop (tests/test_torch_folded.py's float32 tolerances); the losses
    to 1e-5 and 1e-6."""
    model, names, (lf, ll, lj), folded, loop, gqx = _grads(rng, name, "float32")
    np.testing.assert_allclose(lf.numpy(), np.asarray(lj), rtol=1e-5)
    np.testing.assert_allclose(lf.numpy(), ll.numpy(), rtol=1e-6)
    paths = leaf_paths(model)
    for n in names:
        assert folded[n].dtype == np.float32
        for u in range(folded[n].shape[0]):
            scale = None
            if _pre_bn_conv_bias(model, n):
                scale = float(np.abs(gqx[n.replace("bias", "weight")][u]).max())
            _close(folded[n][u], gqx[n][u], 1e-4, scale, msg=f"{paths[n]} user {u} vs gqx")
            _close(folded[n][u], loop[n][u], 2e-5, scale, msg=f"{paths[n]} user {u} vs the loop")


def _rel_l2(a, b, names):
    num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in names)
    return (num / sum(float((b[n] ** 2).sum()) for n in names)) ** 0.5


@pytest.mark.parametrize("name", ["vgg", "dense", "cnn"])
def test_folded_user_grads_match_gqx_and_the_loop_bf16(rng, name):
    """With bf16 compute, activations and each per-user gradient are bf16
    values, and a one-ulp difference in an activation moves everything
    upstream of it; so the check is on all leaves together (the pre-BN conv
    biases, rounding noise, left out), in relative L2 against the yardstick
    of bf16 itself, gqx's bf16 gradients against its float32 ones from the
    same weights and batch (as chip_smoke.py's folded-against-looped check
    on the card does):
      - the port's bf16 gradients lie as close to gqx's float32 ones as
        gqx's bf16 gradients do (within 1.5x);
      - the port's and gqx's bf16 gradients differ by at most 2x that
        yardstick;
      - the port's folded and looped bf16 gradients agree to 2e-2 (the
        card check's bf16 bound for all leaves together).
    The CNN is float32 in both packages whatever the compute dtype, so it
    is held to the float32 tolerances."""
    if name == "cnn":
        model, names, (lf, _, lj), folded, _, gqx = _grads(rng, name, "bfloat16")
        assert all(p.dtype == torch.float32 for p in model.parameters())
        np.testing.assert_allclose(lf.numpy(), np.asarray(lj), rtol=1e-5)
        for n in names:
            for u in range(folded[n].shape[0]):
                _close(folded[n][u], gqx[n][u], 1e-4, msg=n)
        return
    *_, gqx32 = _grads(np.random.default_rng(0), name, "float32")
    model, names, (lf, ll, lj), folded, loop, gqx = _grads(np.random.default_rng(0), name, "bfloat16")
    names = [n for n in names if not _pre_bn_conv_bias(model, n)]
    yardstick = _rel_l2(gqx, gqx32, names)
    to_truth, to_gqx, to_loop = (_rel_l2(folded, gqx32, names), _rel_l2(folded, gqx, names),
                                 _rel_l2(folded, loop, names))
    print(f"{name} bf16: gqx bf16 vs its float32 {yardstick:.3e}; port bf16 vs gqx float32 "
          f"{to_truth:.3e}, vs gqx bf16 {to_gqx:.3e}, folded vs loop {to_loop:.3e}")
    assert 0 < yardstick < 0.5
    assert to_truth <= 1.5 * yardstick
    assert to_gqx <= 2.0 * yardstick
    assert to_loop <= 2e-2
    np.testing.assert_allclose(lf.numpy(), ll.numpy(), rtol=2e-2)
    np.testing.assert_allclose(lf.numpy(), np.asarray(lj), rtol=2e-2)


# -- two training steps, and the CLI -------------------------------------------

@pytest.fixture
def interpret_kernels(monkeypatch):
    """gqx's flat-layout kernels in interpret mode (its compressor calls
    them without ``interpret``)."""
    shim = types.SimpleNamespace(**{
        n: functools.partial(getattr(pallas_hsq4, n), interpret=True)
        for n in ("hsq_encode_flat", "hsq_decode_flat", "hsq_decode_mean")})
    monkeypatch.setattr(gqx_vq, "_hsq_kernels", lambda: shim)


@pytest.mark.parametrize("name", ["vgg", "cnn"])
def test_two_hsq_steps_match_gqx(rng, interpret_kernels, name):
    """Two canonical folded HSQ steps (passes 1, no EF, 2 users x 2, random
    off) from gqx's initial state: the passthrough leaves (conv and dense
    biases, BN parameters, the small convs) and the BN statistics to 1e-5
    relative, and at most 1e-3 of the HSQ unit's subvectors off (a code or
    norm level flipped between the packages, as for ResNet-18 in
    tests/test_torch_train.py); the second step starts again from gqx's
    state."""
    users, batch = 2, 2
    gmodel, model, shape, c_dim = _small(name)
    kw = dict(quantizer="hsq", c_dim=c_dim, k_bit=8, n_bit=6, num_users=users, batch_size=batch,
              random=False, hsq_passes=1)
    gcfg = GqxConfig(**kw)
    gcfg.use_pallas = True
    gstate, gplan, tx = gqx_create_state(gcfg, gmodel, jnp.zeros((batch,) + shape),
                                         jax.random.PRNGKey(0))
    gstep = gqx_make_step(gcfg, gmodel, gplan, tx)
    gstate = gstate._replace(params=jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.uniform(1.0, 2.0, a.shape).astype(np.float32))
        if "BatchNorm" in jax.tree_util.keystr(p) and "bias" in jax.tree_util.keystr(p) else a,
        gstate.params))
    _load(model, gstate.params, gstate.batch_stats)
    state, plan = create_train_state(GQConfig(**kw), model, device="cpu")
    step = make_train_step(GQConfig(**kw), plan)
    hsq = plan.units[0]
    assert type(hsq.compressor).__name__ == "HSQCompressor" and hsq.compressor.flat_ok
    x = rng.standard_normal((2, users, batch) + shape).astype(np.float32)
    y = rng.integers(0, 10, (2, users, batch))
    for s in range(2):
        gstate, gloss = gstep(gstate, jnp.asarray(x[s]), jnp.asarray(y[s]), jnp.float32(1.0),
                              jnp.float32(0.1), jnp.float32(5e-4), jax.random.PRNGKey(0))
        loss = step(state, torch.from_numpy(x[s].transpose(0, 1, 4, 2, 3).copy()),
                    torch.from_numpy(y[s]), 0.1, 5e-4, None)
        np.testing.assert_allclose(float(loss), float(gloss), rtol=1e-5)
        want, _ = from_jax(model, jax.tree.map(np.asarray, gstate.params),
                           jax.tree.map(np.asarray, gstate.batch_stats) or None)
        got = model.state_dict()
        hsq_names = {plan.names[i] for i in hsq.leaf_indices}
        bad = {}
        for n, w in want.items():
            miss = (got[n] - w).abs() > 1e-5 * w.abs() + 1e-7
            if n in hsq_names:
                bad[n] = miss.float()
            else:
                assert not bool(miss.any()), n
        packed = plan.pack({n: bad.get(n, torch.zeros_like(got[n])) for n in plan.names})[0]
        rows = packed.reshape(-1, hsq.compressor.dim).amax(1) > 0
        print(f"{name} step {s + 1}: {int(rows.sum())} of {rows.numel()} HSQ subvectors differ")
        assert int(rows.sum()) <= 1e-3 * rows.numel()
        _load(model, gstate.params, gstate.batch_stats)
        for n, t in from_jax(model, jax.tree.map(np.asarray, gstate.opt_state.trace))[0].items():
            state.trace[n].copy_(t)


@pytest.mark.parametrize("name,c_dim", [("cnn", "8"), ("dense", "16")])
def test_cli_trains_the_new_networks_on_the_cpu(tmp_path, monkeypatch, name, c_dim):
    """``gqx_torch.cli`` with ``--platform cpu`` on a synthetic set cut to 32
    images: 2 HSQ steps and an eval, finite losses in scalars.csv.  (VGG-16
    goes through the CLI on the card, in chip_smoke.py.)"""
    monkeypatch.setitem(datasets.LOADERS, "synthetic",
                        functools.partial(datasets.load_synthetic, num_train=32, num_test=16))
    state, accuracy = cli_main(
        ["--network", name, "--dataset", "synthetic", "--quantizer", "hsq", "--c-dim", c_dim,
         "--k-bit", "8", "--n-bit", "6", "--num-users", "2", "--batch-size", "8", "--epochs", "1",
         "--platform", "cpu", "--logdir", str(tmp_path)])
    assert state.step == 2 and 0.0 <= accuracy <= 1.0
    with open(os.path.join(tmp_path, "scalars.csv")) as f:
        rows = {r["tag"]: float(r["value"]) for r in csv.DictReader(f)}
    assert np.isfinite(rows["loss"]) and np.isfinite(rows["accuracy(%)"])
