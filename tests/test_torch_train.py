"""gqx_torch's training step against gqx's, from the same weights and batch.

gqx runs its canonical step (folded users, Pallas HSQ kernels in interpret
mode, ``use_pallas=True`` planning) on the CPU in float32 with
``random=False``; the port runs its step, folded users by default as well,
on the CPU through the plain versions of its kernels.
"""

import ast
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqx.compress.vq as gqx_vq
import gqx.ops.pallas_hsq as gqx_rows
from gqx.config import GQConfig as GqxConfig
from gqx.models import create_model as gqx_create_model
from gqx.ops import pallas_hsq4
from gqx.train import create_train_state as gqx_create_state
from gqx.train import make_train_step as gqx_make_step
from gqx_torch.config import GQConfig
from gqx_torch.convert import from_jax
from gqx_torch.models import create_model
from gqx_torch.parallel.aggregate import init_state
from gqx_torch.train import create_train_state, make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
USERS, BATCH = 2, 2
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture
def interpret_kernels(monkeypatch):
    """gqx's flat-layout and row-major kernels in interpret mode (its
    compressor calls them without ``interpret``)."""
    shim = types.SimpleNamespace(**{
        name: functools.partial(getattr(pallas_hsq4, name), interpret=True)
        for name in ("hsq_encode_flat", "hsq_decode_flat", "hsq_decode_mean")
    })
    monkeypatch.setattr(gqx_vq, "_hsq_kernels", lambda: shim)
    for name in ("hsq_encode", "hsq_decode"):
        monkeypatch.setattr(gqx_rows, name,
                            functools.partial(getattr(gqx_rows, name), interpret=True))


def _setup(name, rng, port_extra=None, **extra):
    shape = (28, 28, 1) if name == "fcn" else (32, 32, 3)
    kw = dict(network=name, quantizer="hsq", c_dim=16, k_bit=8, n_bit=6,
              num_users=USERS, batch_size=BATCH, random=False, hsq_passes=1)
    kw.update(extra)
    gcfg = GqxConfig(**kw)
    gcfg.use_pallas = True
    gmodel = gqx_create_model(name, 10)
    gstate, gplan, tx = gqx_create_state(gcfg, gmodel, jnp.zeros((BATCH,) + shape),
                                         jax.random.PRNGKey(0))
    gstep = gqx_make_step(gcfg, gmodel, gplan, tx)
    # BN biases away from 0 keep ReLU inputs away from 0, where float32
    # rounding could give them opposite signs in the two packages
    # (tests/test_torch_models.py::test_per_user_grads_match_folded)
    gstate = gstate._replace(params=jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.uniform(1.0, 2.0, a.shape).astype(np.float32))
        if "BatchNorm" in jax.tree_util.keystr(p) and "bias" in jax.tree_util.keystr(p) else a,
        gstate.params))
    model = create_model(name, 10)
    _load(model, gstate)
    cfg = GQConfig(**kw, **(port_extra or {}))
    state, plan = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, plan)
    x = rng.standard_normal((2, USERS, BATCH) + shape).astype(np.float32)
    y = rng.integers(0, 10, (2, USERS, BATCH))
    return gstate, gstep, state, plan, step, x, y


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(model, gstate, state=None):
    """Copy gqx's parameters, BN statistics (and momentum) into the port."""
    sd, _ = from_jax(model, _np(gstate.params), _np(gstate.batch_stats) or None)
    model.load_state_dict(sd)
    if state is not None:
        trace, _ = from_jax(model, _np(gstate.opt_state.trace))
        for n, t in state.trace.items():
            t.copy_(trace[n])


def _run_both(gstate, gstep, state, step, x, y, scale=1.0):
    gstate, gloss = gstep(gstate, jnp.asarray(x), jnp.asarray(y), jnp.float32(scale),
                          jnp.float32(0.1), jnp.float32(5e-4), jax.random.PRNGKey(0))
    loss = step(state, torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()),
                torch.from_numpy(y), 0.1, 5e-4, None, scale)
    np.testing.assert_allclose(float(loss), float(gloss), rtol=1e-5)
    return gstate


def _compare(model, state, plan, gstate, with_trace):
    """Parameters and BN statistics (and, with ``with_trace``, the momentum)
    against gqx's, to 1e-5 relative.  Passthrough leaves and BN statistics
    must all agree; returns how many HSQ subvectors do not — those whose
    code or norm level flipped between the two packages (near-ties, level
    boundaries) — and how many there are."""
    want, _ = from_jax(model, _np(gstate.params), _np(gstate.batch_stats) or None)
    got = {n: v for n, v in model.state_dict().items()}
    pairs = [(n, want[n], got[n]) for n in want]
    if with_trace:
        # the ResNet-18 gradients of the two packages agree to ~1e-4 of each
        # leaf's scale (tests/test_torch_models.py), not 1e-5 per element, so
        # the momentum is held to 1e-5 only on the FCN
        want_t, _ = from_jax(model, _np(gstate.opt_state.trace))
        pairs += [(n, want_t[n], state.trace[n]) for n in want_t]
    bad = {}
    for n, w, g in pairs:
        miss = (g - w).abs() > RTOL * w.abs() + ATOL
        bad[n] = miss if n not in bad else bad[n] | miss
    hsq_unit = plan.units[0]
    hsq_names = {plan.names[i] for i in hsq_unit.leaf_indices}
    for n, miss in bad.items():
        if n not in hsq_names:
            assert not bool(miss.any()), n
    mask = plan.pack({n: bad[n].float() for n in plan.names})[0]
    rows = mask.reshape(-1, hsq_unit.compressor.dim).amax(1) > 0
    return int(rows.sum()), rows.numel()


@pytest.mark.parametrize("name", ["fcn", "resnet18"])
def test_two_hsq_steps_match_gqx(rng, interpret_kernels, name):
    gstate, gstep, state, plan, step, x, y = _setup(name, rng)
    model = state.model
    for s in range(2):
        gstate = _run_both(gstate, gstep, state, step, x[s], y[s])
        flipped, total = _compare(model, state, plan, gstate, with_trace=name == "fcn")
        print(f"{name} step {s + 1}: {flipped} of {total} HSQ subvectors differ "
              "(flipped code or norm level)")
        if name == "fcn":
            assert flipped == 0
        else:
            assert flipped <= 1e-3 * total
            # a flipped subvector changes its elements by a quantization
            # step, which then moves every gradient of the next step; the
            # second step starts again from gqx's state
            _load(model, gstate, state)


@pytest.mark.parametrize("c_dim", [256, 512])
def test_two_wide_rows_fcn_steps_match_gqx(rng, interpret_kernels, c_dim):
    """HSQ at c_dim 256 and 512 / k_bit 8 plans the FCN's weights as one
    row-major unit of 262,144 elements (dim 256 or 512, K 256: the wide
    route's shapes on the card); two folded steps against gqx with its
    row-major kernels in interpret mode."""
    gstate, gstep, state, plan, step, x, y = _setup("fcn", rng, c_dim=c_dim, k_bit=8)
    comp = plan.units[0].compressor
    assert (plan.units[0].size, comp.dim, comp.K, comp.flat_ok) == (262_144, c_dim, 256, False)
    for s in range(2):
        gstate = _run_both(gstate, gstep, state, step, x[s], y[s])
        flipped, total = _compare(state.model, state, plan, gstate, with_trace=True)
        print(f"c_dim {c_dim} step {s + 1}: {flipped} of {total} HSQ subvectors differ")
        assert flipped == 0


def test_two_looped_fcn_steps_match_gqx(rng, interpret_kernels, monkeypatch):
    """``folded_users=False``: the per-user loop gives the same two steps,
    and never enters the folded route."""
    import gqx_torch.train as train_mod

    monkeypatch.setattr(train_mod, "folded_user_grads", None)
    gstate, gstep, state, plan, step, x, y = _setup("fcn", rng,
                                                    port_extra=dict(folded_users=False))
    for s in range(2):
        gstate = _run_both(gstate, gstep, state, step, x[s], y[s])
        flipped, _ = _compare(state.model, state, plan, gstate, with_trace=True)
        assert flipped == 0


def test_folded_step_is_the_default_and_runs_one_forward(rng, monkeypatch):
    """The default config takes the folded route: one forward on the (U*B)
    batch per step, where the loop runs U."""
    calls = []
    for folded, want in ((True, [USERS * BATCH]), (False, [BATCH] * USERS)):
        cfg = GQConfig(network="fcn", quantizer="sgd", num_users=USERS, batch_size=BATCH)
        assert cfg.folded_users
        cfg.folded_users = folded
        model = create_model("fcn", 10)
        state, plan = create_train_state(cfg, model, device="cpu")
        model.register_forward_pre_hook(lambda m, args: calls.append(args[0].shape[0]))
        calls.clear()
        make_train_step(cfg, plan)(state, torch.randn(USERS, BATCH, 1, 28, 28),
                                   torch.randint(0, 10, (USERS, BATCH)), 0.1, 5e-4, None)
        assert calls == want


@pytest.mark.parametrize("extra", [
    dict(quantizer="sgd"), dict(quantizer="qsgd", c_dim=128, n_bit=2),
    dict(quantizer="terngrad"), dict(quantizer="sign"),
], ids=["sgd", "qsgd2bit", "terngrad", "sign"])
def test_two_fcn_steps_of_the_comparison_configs_match_gqx(rng, extra):
    """The four other configurations of the canonical comparison, two folded
    steps each with random=False: parameters and momentum within 1e-5 (or
    1e-6 of the leaf's largest magnitude, for elements that cancel to near
    zero), except at most 1e-4 of the elements where a level or sign sat on
    a boundary and fell to the other side in the two packages."""
    gstate, gstep, state, plan, step, x, y = _setup("fcn", rng, **extra)
    model = state.model
    for s in range(2):
        gstate = _run_both(gstate, gstep, state, step, x[s], y[s])
        want, _ = from_jax(model, _np(gstate.params))
        want_t, _ = from_jax(model, _np(gstate.opt_state.trace))
        bad = total = 0
        for n, p in model.named_parameters():
            for got, ref in ((p.detach(), want[n]), (state.trace[n], want_t[n])):
                tol = RTOL * ref.abs() + 1e-6 * ref.abs().max() + ATOL
                bad += int(((got - ref).abs() > tol).sum())
                total += ref.numel()
        print(f"{extra['quantizer']} step {s + 1}: {bad} of {total} elements differ")
        assert bad <= (0 if extra["quantizer"] == "sgd" else 1e-4 * total)
        if bad:
            _load(model, gstate, state)


@pytest.mark.parametrize("extra", [
    dict(ef=True, two_phase=True), dict(mode="ring"), dict(mode="ring", ef=True),
], ids=["ps_ef_two_phase", "ring", "ring_ef"])
def test_two_fcn_steps_with_ef_and_ring_match_gqx(rng, interpret_kernels, extra):
    """Error feedback with the two-phase downlink, and the chain ring, through
    the entry points: parameters, momentum and the carried error-feedback
    state after each of two steps, at an EF scale below 1."""
    gstate, gstep, state, plan, step, x, y = _setup("fcn", rng, **extra)
    for s in range(2):
        gstate = _run_both(gstate, gstep, state, step, x[s], y[s], scale=0.5)
        flipped, _ = _compare(state.model, state, plan, gstate, with_trace=True)
        assert flipped == 0
        ef_t, ef_j = state.agg_state.ef, gstate.agg_state.ef
        assert (ef_t is None) == (ef_j is None) == (not extra.get("ef", False))
        for group_t, group_j in ((ef_t, ef_j), (state.agg_state.server_ef,
                                                gstate.agg_state.server_ef)):
            assert (group_t is None) == (group_j is None)
            for t, j in zip(group_t or (), group_j or ()):
                # 1e-6 of the unit's scale: the same float32 ops in both packages
                j = np.asarray(j)
                assert np.abs(t.numpy() - j).max() <= 1e-6 * max(np.abs(j).max(), 1e-30)
    assert state.agg_state.server_ef is None or bool(state.agg_state.server_ef[0].any())


def test_step_options_raise():
    with pytest.raises(ValueError):
        GQConfig(backend="mesh")
    with pytest.raises(ValueError):
        GQConfig(scan_blocks=True)
    with pytest.raises(ValueError):
        GQConfig(use_pallas=False)
    with pytest.raises(ValueError):
        GQConfig(mode="tree")
    cfg = GQConfig(network="fcn", quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, num_users=2)
    _, plan = create_train_state(cfg, create_model("fcn", 10), device="cpu")
    sizes = [u.size for u in plan.units]
    # EF state for every unit, the identity unit too; the server error only
    # with EF and two-phase together (gqx/parallel/aggregate.py:48-57)
    none = init_state(plan, 2, ef=False, two_phase=True)
    assert none.ef is None and none.server_ef is None
    ef = init_state(plan, 2, ef=True, two_phase=False)
    assert [tuple(e.shape) for e in ef.ef] == [(2, n) for n in sizes] and ef.server_ef is None
    both = init_state(plan, 2, ef=True, two_phase=True)
    assert [tuple(e.shape) for e in both.server_ef] == [(n,) for n in sizes]
    assert all(e.dtype == torch.float32 and not e.any() for e in both.ef + both.server_ef)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            create_train_state(GQConfig(quantizer="sgd"), create_model("fcn", 10))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_or_gqx():
    """jax is preloaded in some environments, so sys.modules proves nothing:
    the sources are scanned."""
    files = sorted((REPO / "gqx_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    banned = ("jax", "jaxlib", "flax", "optax", "gqx")
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in banned, f"{f.relative_to(REPO)} imports {mod}"
