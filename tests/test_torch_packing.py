"""gqx_torch's unit plans and pack/unpack against gqx's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gqx.config import GQConfig as GqxConfig
from gqx.models import create_model as gqx_create_model
from gqx.parallel.packing import plan_units as gqx_plan_units
from gqx_torch.config import GQConfig
from gqx_torch.convert import from_jax, leaf_paths
from gqx_torch.models import create_model
from gqx_torch.parallel.packing import plan_units

SHAPES = {"fcn": (2, 28, 28, 1), "resnet18": (2, 32, 32, 3)}


def _gqx_param_shapes(name):
    model = gqx_create_model(name, 10)
    v = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                          jnp.zeros(SHAPES[name]), train=True))
    return v["params"]


def _config_kw(quantizer, layout):
    kw = dict(quantizer=quantizer, quant_layout=layout, num_users=2,
              compute_dtype="bfloat16", hsq_passes=1)
    if quantizer == "hsq":
        kw.update(c_dim=16, k_bit=8, n_bit=6)
    return kw


def _plans(name, quantizer, layout):
    gcfg = GqxConfig(**_config_kw(quantizer, layout))
    gcfg.use_pallas = True
    gparams = _gqx_param_shapes(name)
    gplan = gqx_plan_units(gparams, gcfg)
    model = create_model(name, 10, "bfloat16")
    tplan = plan_units([(n, tuple(p.shape)) for n, p in model.named_parameters()],
                       leaf_paths(model), GQConfig(**_config_kw(quantizer, layout)))
    return gparams, gplan, model, tplan


@pytest.mark.parametrize("name", ["fcn", "resnet18"])
@pytest.mark.parametrize("quantizer", ["hsq", "sgd"])
def test_plan_equals_gqx(name, quantizer):
    gparams, gplan, model, tplan = _plans(name, quantizer, "outfirst")
    gpaths = ["/".join(str(getattr(k, "key", k)) for k in p)
              for p, _ in jax.tree_util.tree_flatten_with_path(gparams)[0]]
    paths = leaf_paths(model)
    assert [paths[n] for n in tplan.names] == gpaths
    assert len(tplan.units) == len(gplan.units)
    for tu, gu, tdt, gdt in zip(tplan.units, gplan.units, tplan.unit_dtypes, gplan.unit_dtypes):
        assert tu.leaf_indices == gu.leaf_indices
        assert tu.sizes == gu.sizes
        assert tu.pad == gu.pad
        assert type(tu.compressor).__name__ == type(gu.compressor).__name__
        assert (tdt is None) == (gdt is None)
        if tdt is not None:
            assert str(tdt).split(".")[-1] == np.dtype(gdt).name
        if quantizer == "hsq" and hasattr(gu.compressor, "norm_compressor"):
            assert tu.compressor.norm_compressor.segment_sizes == \
                gu.compressor.norm_compressor.segment_sizes
            assert (tu.compressor.dim, tu.compressor.M) == (gu.compressor.dim, gu.compressor.M)
    assert tplan.wire_bytes() == gplan.wire_bytes()
    if quantizer == "hsq":
        assert tplan.units[0].pad > 0 and tplan.units[0].size % 65536 == 0


def _random_grads(rng, gparams, users):
    return jax.tree.map(
        lambda s: rng.standard_normal((users,) + tuple(s.shape)).astype(np.float32), gparams)


@pytest.mark.parametrize("layout", ["outfirst", "torch", "natural"])
@pytest.mark.parametrize("name", ["fcn", "resnet18"])
def test_pack_equals_gqx_and_roundtrips(rng, name, layout):
    gparams, gplan, model, tplan = _plans(name, "hsq", layout)
    users = 2
    g = _random_grads(rng, gparams, users)
    per_user = [from_jax(model, jax.tree.map(lambda a: a[i], g))[0] for i in range(users)]
    tg = {n: torch.stack([pu[n] for pu in per_user]) for n in per_user[0]}

    want = [np.asarray(a.astype(jnp.float32)) for a in gplan.pack(jax.tree.map(jnp.asarray, g))]
    got = tplan.pack(tg)
    for w, t, dt in zip(want, got, tplan.unit_dtypes):
        assert t.dtype == (dt or torch.float32)
        np.testing.assert_array_equal(t.float().numpy(), w)

    back = tplan.unpack(got)
    for n, v in tg.items():
        expect = v
        if any(n in [tplan.names[i] for i in u.leaf_indices] and dt is not None
               for u, dt in zip(tplan.units, tplan.unit_dtypes)):
            expect = v.to(torch.bfloat16)
        assert torch.equal(back[n], expect)
