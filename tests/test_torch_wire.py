"""gqx_torch's wire format (``gqx_torch/ops/pack.py``, ``gqx_torch/ops/wire.py``)
against gqx's: the same signature packs to the same 32-bit words, the
unpack is bit-exact, and the byte count is the payload's.  Every comparison
here is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gqx.compress import make_compressor as gqx_make_compressor
from gqx.config import GQConfig as GqxConfig
from gqx.models import create_model as gqx_create_model
from gqx.ops.pack import pack_uint as gqx_pack_uint
from gqx.ops.wire import pack_signature as gqx_pack_signature
from gqx.ops.wire import wire_bytes as gqx_wire_bytes
from gqx.parallel.packing import plan_units as gqx_plan_units
from gqx_torch.compress import make_compressor
from gqx_torch.config import QUANTIZER_CHOICES, GQConfig
from gqx_torch.convert import leaf_paths
from gqx_torch.models import create_model
from gqx_torch.ops.pack import pack_uint, packed_words, unpack_uint
from gqx_torch.ops.wire import pack_signature, unpack_signature, wire_bytes
from gqx_torch.parallel.packing import plan_units

NAMES = ("sgd", "sign", "qsgd", "hsq", "pvq", "residual", "topk", "maurey")
# tests/test_pack.py's cases; k_bit 0 (K == dim) is an HSQ-only configuration
CASES = [(n, k) for n in NAMES for k in (0, 6, 8)
         if not (k == 0 and n in ("pvq", "residual", "maurey"))]


@pytest.fixture(autouse=True)
def few_threads():
    """The suite runs in several worker processes on one host, and torch's
    default of a thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _words(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32 and t.dim() == 1
    return t.numpy().view(np.uint32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_bit_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{where}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
    if got.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), where


@pytest.mark.parametrize("bits", range(1, 33))
def test_pack_uint_matches_gqx(bits, rng):
    """Every width, at lengths on and off a period of the stream."""
    for n in (1, 7, 64, 333):
        vals = rng.integers(0, 2 ** bits, size=n, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(gqx_pack_uint(jnp.asarray(vals), bits))
        got = pack_uint(torch.from_numpy(vals.astype(np.int64)), bits)
        assert got.shape[0] == packed_words(n, bits)
        np.testing.assert_array_equal(_words(got), want)
        back = unpack_uint(got, bits, n)
        assert back.dtype == torch.int64
        np.testing.assert_array_equal(back.numpy(), vals.astype(np.int64))


@pytest.mark.parametrize("name,k_bit", CASES)
def test_signature_packs_to_gqx_words(name, k_bit, rng):
    """gqx's signature, as torch tensors, packs to gqx's words; the unpack
    gives the signature back bit for bit and decodes to the same vector;
    the payload's bytes are the port's ``wire_bytes``, which is gqx's."""
    kw = dict(quantizer=name, c_dim=16, k_bit=k_bit, n_bit=6, cr=64, dataset="synthetic")
    v = rng.standard_normal((2048,)).astype(np.float32)
    gq = gqx_make_compressor(name, v.size, v.shape, GqxConfig(**kw))
    pt = make_compressor(name, v.size, v.shape, GQConfig(**kw))
    sig_j = gq.compress(jnp.asarray(v), jax.random.PRNGKey(0))
    wire_j = gqx_pack_signature(gq, sig_j)
    sig = _to_torch(sig_j)
    wire = pack_signature(pt, sig)
    assert set(wire) == set(wire_j)
    for k in wire_j:
        np.testing.assert_array_equal(_words(wire[k]), np.asarray(wire_j[k]), err_msg=k)
    back = unpack_signature(pt, wire)
    _assert_bit_equal(back, sig)
    _assert_bit_equal(pt.decompress(back), pt.decompress(sig))
    assert sum(4 * w.numel() for w in wire.values()) == wire_bytes(pt) == gqx_wire_bytes(gq)
    # the port's own signature takes the same round trip
    own = pt.compress(torch.from_numpy(v), torch.Generator().manual_seed(1))
    _assert_bit_equal(unpack_signature(pt, pack_signature(pt, own)), own)


def test_maurey_trits_carry_a_zero_sign():
    """Maurey's signs are {-1, 0, +1}: an all-zero vector samples the last
    index with sign 0, and every trit survives the wire."""
    cfg = GQConfig(quantizer="maurey", c_dim=32, k_bit=8, n_bit=8)
    comp = make_compressor("maurey", 2048, (2048,), cfg)
    sig0 = comp.compress(torch.zeros(2048), torch.Generator().manual_seed(0))
    assert bool((sig0["signs"] == 0).all()) and bool((sig0["codes"] == 2047).all())
    sig = dict(sig0, signs=torch.from_numpy(np.resize([-1.0, 0.0, 1.0], comp.k).astype(np.float32)))
    for s in (sig0, sig):
        _assert_bit_equal(unpack_signature(comp, pack_signature(comp, s)), s)


def test_transposed_wire_raises():
    comp = make_compressor("hsq", 65536, (65536,), GQConfig(quantizer="hsq", c_dim=16))
    with pytest.raises(ValueError, match="transposed"):
        pack_signature(comp, {}, transposed=True)
    with pytest.raises(ValueError, match="transposed"):
        unpack_signature(comp, {}, transposed=True)


def _fcn_gqx_params():
    model = gqx_create_model("fcn", 10)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((2, 28, 28, 1)),
                                             train=True))["params"]


@pytest.mark.parametrize("name", QUANTIZER_CHOICES)
def test_plan_wire_bytes_are_the_packed_bytes(name, rng):
    """The FCN's plan under each of gqx's nine quantizers: ``UnitPlan.
    wire_bytes`` is gqx's count and the bytes of one user's packed
    payload."""
    kw = dict(quantizer=name, c_dim=16, k_bit=6, n_bit=6, cr=64, num_users=2)
    gcfg = GqxConfig(**kw)
    gcfg.use_pallas = True
    gplan = gqx_plan_units(_fcn_gqx_params(), gcfg)
    model = create_model("fcn", 10)
    plan = plan_units([(n, tuple(p.shape)) for n, p in model.named_parameters()],
                      leaf_paths(model), GQConfig(**kw))
    assert [type(u.compressor).__name__ for u in plan.units] == \
        [type(u.compressor).__name__ for u in gplan.units]
    assert plan.wire_bytes() == gplan.wire_bytes()
    grads = {n: torch.from_numpy(rng.standard_normal((1,) + tuple(p.shape)).astype(np.float32))
             for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    packed = 0
    for u, g in zip(plan.units, plan.pack(grads)):
        sig = u.compressor.compress(g[0], gen)
        packed += sum(4 * w.numel() for w in pack_signature(u.compressor, sig).values())
    assert packed == plan.wire_bytes()
