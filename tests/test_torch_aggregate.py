"""gqx_torch's aggregators (PS with error feedback and two-phase downlink,
chain ring) against gqx's, from the same per-user gradients over two
consecutive steps, so that the error-feedback state is carried.

gqx runs with ``use_pallas=True`` planning, its Pallas HSQ kernels in
interpret mode and ``random=False``; the port runs on the CPU through the
plain versions of its kernels.  Both plans are built from the same leaf
list: the FCN's, and a cut of ResNet-18 (stem, one basic block and the
classifier) that gives one HSQ unit of 8,192 subvectors and one identity
unit.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqx.compress.vq as gqx_vq
from gqx.config import GQConfig as GqxConfig
from gqx.models import create_model as gqx_create_model
from gqx.ops import pallas_hsq4
from gqx.parallel import aggregate as gqx_agg
from gqx.parallel.packing import plan_units as gqx_plan_units
from gqx_torch.config import GQConfig
from gqx_torch.parallel import aggregate as agg
from gqx_torch.parallel.packing import plan_units

USERS = 3
SCALES = (0.4621171572600098, 0.7615941559557649)    # ef_scale(1), ef_scale(2)

RESNET18_CUT = {
    "TorchConv_0/Conv_0/kernel": (3, 3, 3, 64),
    "BatchNorm_0/scale": (64,),
    "BatchNorm_0/bias": (64,),
    "BasicBlock_0/TorchConv_0/Conv_0/kernel": (3, 3, 64, 64),
    "BasicBlock_0/BatchNorm_0/scale": (64,),
    "BasicBlock_0/BatchNorm_0/bias": (64,),
    "BasicBlock_0/TorchConv_1/Conv_0/kernel": (3, 3, 64, 64),
    "BasicBlock_0/BatchNorm_1/scale": (64,),
    "BasicBlock_0/BatchNorm_1/bias": (64,),
    "Dense_0/kernel": (512, 10),
    "Dense_0/bias": (10,),
}


@pytest.fixture
def interpret_kernels(monkeypatch):
    shim = types.SimpleNamespace(**{
        name: functools.partial(getattr(pallas_hsq4, name), interpret=True)
        for name in ("hsq_encode_flat", "hsq_decode_flat", "hsq_decode_mean")
    })
    monkeypatch.setattr(gqx_vq, "_hsq_kernels", lambda: shim)


def _fcn_leaves():
    model = gqx_create_model("fcn", 10)
    v = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                          jnp.zeros((2, 28, 28, 1)), train=True))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(v["params"])[0]}


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


# gqx leaf (flax layout) -> port leaf: conv HWIO -> OIHW, dense (in, out) -> (out, in)
_TO_PORT = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}


def _plans(leaves, **extra):
    kw = dict(quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, num_users=USERS,
              random=False, hsq_passes=1, **extra)
    gcfg = GqxConfig(**kw)
    gcfg.use_pallas = True
    gplan = gqx_plan_units(
        _nest({p: jax.ShapeDtypeStruct(s, jnp.float32) for p, s in leaves.items()}), gcfg)
    cfg = GQConfig(**kw)
    tplan = plan_units([(p, tuple(s[i] for i in _TO_PORT[len(s)])) for p, s in leaves.items()],
                       {p: p for p in leaves}, cfg)
    assert [u.sizes for u in tplan.units] == [u.sizes for u in gplan.units]
    assert [u.pad for u in tplan.units] == [u.pad for u in gplan.units]
    return gcfg, gplan, cfg, tplan


def _grads(rng, leaves):
    """Per-user gradients with a different scale per leaf, in both layouts."""
    g = {p: (rng.standard_normal((USERS,) + s) * 10.0 ** rng.uniform(-3, -1)).astype(np.float32)
         for p, s in leaves.items()}
    port = {p: torch.from_numpy(np.ascontiguousarray(
        a.transpose((0,) + tuple(i + 1 for i in _TO_PORT[a.ndim - 1])))) for p, a in g.items()}
    return _nest({p: jnp.asarray(a) for p, a in g.items()}), port


def _close_units(plan, got, want, what):
    """Per unit: every element within 1e-6 of the unit's scale (its largest
    magnitude), except whole HSQ subvectors whose code or norm level flipped
    between the packages (near-ties), at most 1e-3 of them."""
    for unit, t, j in zip(plan.units, got, want):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape, what
        bad = np.abs(t - j) > 1e-6 * np.abs(j).max()
        if hasattr(unit.compressor, "dim"):
            rows = bad.reshape(-1, unit.compressor.dim).any(1)
            assert rows.sum() <= 1e-3 * rows.size, (what, int(rows.sum()))
        else:
            assert not bad.any(), what


def _run(rng, interpret, leaves, mode, ef, two_phase):
    gcfg, gplan, cfg, tplan = _plans(leaves, mode=mode, ef=ef, two_phase=two_phase)
    gstate = gqx_agg.init_state(gplan, USERS, ef, two_phase)
    tstate = agg.init_state(tplan, USERS, ef, two_phase)
    g_aggregate = gqx_agg.make_aggregator(gcfg, gplan)
    t_aggregate = agg.make_aggregator(cfg, tplan)
    for step, scale in enumerate(SCALES):
        gj, gt = _grads(rng, leaves)
        agg_j, gstate = g_aggregate(gj, gstate, jnp.float32(scale), jax.random.PRNGKey(step))
        agg_t = t_aggregate(gt, tstate, scale, None)
        what = f"{mode} ef={ef} two_phase={two_phase} step {step}"
        _close_units(tplan, tplan.pack(agg_t), gplan.pack(agg_j), what + " aggregate")
        assert (tstate.ef is None) == (gstate.ef is None) == (not ef)
        assert (tstate.server_ef is None) == (gstate.server_ef is None)
        if ef:
            _close_units(tplan, tstate.ef, gstate.ef, what + " ef")
            if step:
                assert all(bool(e.any()) for e in tstate.ef[:1])   # the HSQ unit's error
            assert not tstate.ef[-1].any()                         # identity: no error
        if tstate.server_ef is not None:
            _close_units(tplan, tstate.server_ef, gstate.server_ef, what + " server ef")
    return tplan, agg_t


@pytest.mark.parametrize("ef,two_phase", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("net", ["fcn", "resnet18_cut"])
def test_ps_aggregate_matches_gqx(rng, interpret_kernels, net, ef, two_phase):
    leaves = _fcn_leaves() if net == "fcn" else RESNET18_CUT
    tplan, _ = _run(rng, interpret_kernels, leaves, "ps", ef, two_phase)
    assert len(tplan.units) == 2 and tplan.units[0].pad > 0


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("net", ["fcn", "resnet18_cut"])
def test_ring_aggregate_matches_gqx(rng, interpret_kernels, net, ef):
    leaves = _fcn_leaves() if net == "fcn" else RESNET18_CUT
    _run(rng, interpret_kernels, leaves, "ring", ef, False)


def test_ring_returns_sum_and_ps_mean_on_identity_units(rng):
    """With the identity compressor the ring's result is the users' sum, the
    PS result their mean, and error feedback stays zero."""
    leaves = {"Dense_0/kernel": (20, 30), "Dense_0/bias": (30,)}
    _, port = _grads(rng, leaves)
    kw = dict(quantizer="sgd", num_users=USERS, ef=True)
    plan = plan_units([(p, tuple(v.shape[1:])) for p, v in port.items()],
                      {p: p for p in leaves}, GQConfig(**kw))
    for mode, reduce in (("ring", lambda v: v.sum(0)), ("ps", lambda v: v.mean(0))):
        cfg = GQConfig(mode=mode, two_phase=mode == "ps", **kw)
        state = agg.init_state(plan, USERS, True, cfg.two_phase)
        out = agg.make_aggregator(cfg, plan)(port, state, 0.5, None)
        for p, v in port.items():
            torch.testing.assert_close(out[p], reduce(v), rtol=1e-6, atol=1e-7)
        assert all(not e.any() for e in state.ef)
        assert state.server_ef is None or all(not e.any() for e in state.server_ef)


def test_ring_with_bf16_units_adds_the_carry_in_float32(rng):
    """bf16 units (bf16 compute, passes=1, no EF): the ring equals the
    float32-unit ring on the bf16-rounded gradients, exactly."""
    kw = dict(quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, num_users=USERS, random=False,
              hsq_passes=1, mode="ring", compute_dtype="bfloat16")
    named = [(p, tuple(s[i] for i in _TO_PORT[len(s)])) for p, s in RESNET18_CUT.items()]
    paths = {p: p for p in RESNET18_CUT}
    _, port = _grads(rng, RESNET18_CUT)
    outs = []
    for unit_dtype, grads in (("auto", port), ("float32", {
            p: v.to(torch.bfloat16).float() if v[0].numel() > 1000 else v
            for p, v in port.items()})):
        cfg = GQConfig(unit_dtype=unit_dtype, **kw)
        plan = plan_units(named, paths, cfg)
        assert (plan.unit_dtypes[0] == torch.bfloat16) == (unit_dtype == "auto")
        outs.append(agg.make_aggregator(cfg, plan)(grads, agg.AggState(), 1.0, None))
    for p in port:
        assert outs[0][p].dtype == torch.float32
        assert torch.equal(outs[0][p], outs[1][p])
    # error feedback forces float32 units (gqx/parallel/packing.py:335-345)
    assert plan_units(named, paths, GQConfig(ef=True, **kw)).unit_dtypes == [None, None]


def test_stochastic_draw_order_is_reproducible(rng):
    """random=True: the same generator seed gives the same aggregate and
    state; users' batch first, then the server (one seed each per unit)."""
    cfg = GQConfig(quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, num_users=USERS,
                    random=True, hsq_passes=1, ef=True, two_phase=True)
    plan = plan_units([(p, tuple(s[i] for i in _TO_PORT[len(s)])) for p, s in RESNET18_CUT.items()],
                      {p: p for p in RESNET18_CUT}, cfg)
    _, port = _grads(rng, RESNET18_CUT)
    outs = []
    for seed in (7, 7, 8):
        state = agg.init_state(plan, USERS, True, True)
        gen = torch.Generator().manual_seed(seed)
        out = agg.make_aggregator(cfg, plan)(port, state, 1.0, gen)
        outs.append((out, state, torch.randint(0, 1 << 31, (1,), generator=gen)))
    same = lambda a, b: all(torch.equal(a[0][p], b[0][p]) for p in a[0])  # noqa: E731
    assert same(outs[0], outs[1]) and not same(outs[0], outs[2])
    assert torch.equal(outs[0][1].ef[0], outs[1][1].ef[0])
    # two seeds of two words each were drawn for the one HSQ unit
    gen = torch.Generator().manual_seed(7)
    torch.randint(0, 1 << 31, (2,), generator=gen)
    torch.randint(0, 1 << 31, (2,), generator=gen)
    assert torch.equal(torch.randint(0, 1 << 31, (1,), generator=gen), outs[0][2])
    with pytest.raises(ValueError):
        agg.make_aggregator(cfg, plan)(port, agg.init_state(plan, USERS, True, True), 1.0, None)


@pytest.mark.parametrize("kw", [
    dict(quantizer="qsgd", c_dim=128, n_bit=2), dict(quantizer="terngrad"),
    dict(quantizer="sign"), dict(quantizer="qsgd", c_dim=128, n_bit=2, ef=True, two_phase=True),
    dict(quantizer="sign", mode="ring", ef=True),
], ids=["qsgd2bit", "terngrad", "sign", "qsgd2bit_ef_two_phase", "sign_ring_ef"])
def test_scalar_compressors_aggregate_like_gqx(rng, kw):
    """The comparison configurations' compressors under the PS (and one
    ring) aggregator on the ResNet-18 cut, two steps with random=False:
    the plans agree and every element is within 1e-6 of its unit's scale."""
    kw = dict(num_users=USERS, random=False, **kw)
    gcfg, cfg = GqxConfig(**kw), GQConfig(**kw)
    gplan = gqx_plan_units(
        _nest({p: jax.ShapeDtypeStruct(s, jnp.float32) for p, s in RESNET18_CUT.items()}), gcfg)
    tplan = plan_units([(p, tuple(s[i] for i in _TO_PORT[len(s)])) for p, s in RESNET18_CUT.items()],
                       {p: p for p in RESNET18_CUT}, cfg)
    assert [u.sizes for u in tplan.units] == [u.sizes for u in gplan.units]
    assert [type(u.compressor).__name__ for u in tplan.units] == \
        [type(u.compressor).__name__ for u in gplan.units]
    assert tplan.wire_bytes() == gplan.wire_bytes()
    ef, two_phase = cfg.ef, cfg.two_phase
    gstate = gqx_agg.init_state(gplan, USERS, ef, two_phase)
    tstate = agg.init_state(tplan, USERS, ef, two_phase)
    g_aggregate = gqx_agg.make_aggregator(gcfg, gplan)
    t_aggregate = agg.make_aggregator(cfg, tplan)
    for step, scale in enumerate(SCALES):
        gj, gt = _grads(rng, RESNET18_CUT)
        agg_j, gstate = g_aggregate(gj, gstate, jnp.float32(scale), jax.random.PRNGKey(step))
        agg_t = t_aggregate(gt, tstate, scale, None)
        for group_t, group_j in ((tplan.pack(agg_t), gplan.pack(agg_j)), (tstate.ef, gstate.ef),
                                 (tstate.server_ef, gstate.server_ef)):
            assert (group_t is None) == (group_j is None)
            for t, j in zip(group_t or (), group_j or ()):
                j = np.asarray(j)
                assert np.abs(t.numpy() - j).max() <= 1e-6 * np.abs(j).max()
