"""gqx_torch's top-k, Maurey, PVQ and Residual compressors against gqx's on
the same numpy inputs, the samplers fed gqx's own uniforms.  Each test
states its tolerance."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqx.compress.vq as gqx_vq
import gqx_torch.compress.vq as vq
from gqx.compress import make_compressor as gqx_make_compressor
from gqx.config import GQConfig as GqxConfig
from gqx.ops import pallas_hsq4
from gqx.ops.pallas_hsq2 import bf16_exact_codebook as gqx_bf16_exact
from gqx_torch.cli import main
from gqx_torch.compress import make_compressor
from gqx_torch.config import GQConfig
from gqx_torch.compress.vq import ProbabilisticVectorCompressor

from test_torch_train import RTOL, _load, _np, _run_both, _setup


@pytest.fixture(autouse=True)
def few_threads():
    """The suite runs in several worker processes on one host, and torch's
    default of a thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _pair(name, size, **kw):
    cfg = dict(dict(quantizer=name, c_dim=16, k_bit=8, n_bit=6, cr=64), **kw)
    return (gqx_make_compressor(name, size, (size,), GqxConfig(**cfg)),
            make_compressor(name, size, (size,), GQConfig(**cfg)))


# -- top-k ----------------------------------------------------------------------

def _tied(rng, kind, shape):
    if kind == "integers":
        return rng.integers(-4, 5, shape).astype(np.float32)
    # gradients taken in bf16 and carried in float32: many equal magnitudes
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("kind", ["integers", "bf16"])
def test_topk_matches_gqx_ties_included(kind, rng):
    """Indices, values and the mean exactly gqx's: equal |v| by the lowest
    index first."""
    users, size = 3, 4096
    gq, pt = _pair("topk", size)
    v = _tied(rng, kind, (users, size))
    a = np.abs(v)
    kth = np.sort(a, axis=1)[:, ::-1][:, pt.k - 1]
    assert ((a == kth[:, None]).sum(1) > 1).all()       # the cut falls inside a tie
    sig_j = jax.vmap(gq.compress)(jnp.asarray(v))
    sig = pt.compress_batch(torch.from_numpy(v))
    np.testing.assert_array_equal(sig["indices"].numpy(), np.asarray(sig_j["indices"]))
    np.testing.assert_array_equal(sig["values"].numpy(), np.asarray(sig_j["values"]))
    np.testing.assert_array_equal(pt.decode_mean(sig).numpy(), np.asarray(gq.decode_mean(sig_j)))
    np.testing.assert_array_equal(pt.decompress(pt.compress(torch.from_numpy(v[1]))).numpy(),
                                  np.asarray(gq.roundtrip(jnp.asarray(v[1]))))


def test_topk_drops_a_tensor_smaller_than_cr(rng):
    """size // cr == 0: one slot on the wire, value 0, decoding to zeros."""
    gq, pt = _pair("topk", 100, cr=256)
    assert pt.dropped and pt.k == 1 == gq.k
    v = rng.standard_normal(100).astype(np.float32)
    sig = pt.compress(torch.from_numpy(v))
    sig_j = gq.compress(jnp.asarray(v))
    np.testing.assert_array_equal(sig["indices"].numpy(), np.asarray(sig_j["indices"]))
    assert sig["values"].tolist() == [0.0]
    assert not bool(pt.decompress(sig).any())


def test_two_topk_fcn_steps_match_gqx(rng):
    """top-k is deterministic: two folded PS steps of the FCN give gqx's
    parameters and momentum to 1e-5 relative (1e-6 of the leaf's largest
    magnitude where they cancel to near zero)."""
    gstate, gstep, state, plan, step, x, y = _setup("fcn", rng, quantizer="topk", cr=64)
    model = state.model
    from gqx_torch.convert import from_jax

    for s in range(2):
        gstate = _run_both(gstate, gstep, state, step, x[s], y[s])
        want, _ = from_jax(model, _np(gstate.params))
        want_t, _ = from_jax(model, _np(gstate.opt_state.trace))
        for n, p in model.named_parameters():
            for got, ref in ((p.detach(), want[n]), (state.trace[n], want_t[n])):
                tol = RTOL * ref.abs() + 1e-6 * ref.abs().max() + 1e-7
                assert bool(((got - ref).abs() <= tol).all()), (s, n)
        _load(model, gstate, state)


# -- the users' mean -------------------------------------------------------------

@pytest.mark.parametrize("name,in_order", [
    ("topk", True), ("pvq", True), ("residual", True),
    ("maurey", False), ("qsgd", False), ("terngrad", False)])
def test_users_mean_adds_in_order_only_where_asked(name, in_order, rng):
    """decode_mean is users_mean of the decodes: for top-k, PVQ and Residual
    user 0 + user 1 + ... in order times float32(1/U), for the others one
    reduction, sum(0) / U; both bit for bit."""
    users, size = 5, 1024
    _, pt = _pair(name, size)
    assert pt.in_order_mean is in_order
    dec = torch.from_numpy((rng.standard_normal((users, size))
                            * 10.0 ** rng.uniform(-3, 3, (users, 1))).astype(np.float32))
    want = functools.reduce(torch.add, dec) * (1.0 / users) if in_order else dec.sum(0) / users
    assert torch.equal(pt.users_mean(dec), want)
    sig = pt.compress_batch(torch.from_numpy(rng.standard_normal((users, size)).astype(np.float32)),
                            torch.Generator().manual_seed(0))
    assert torch.equal(pt.decode_mean(sig), pt.users_mean(pt.decompress_batch(sig)))


def test_error_feedback_mean_is_users_mean(rng, monkeypatch):
    """The PS aggregator with error feedback takes its mean of the users'
    round trips from users_mean, as decode_mean does: one call a unit."""
    from gqx_torch.compress.sparse import TopKCompressor
    from gqx_torch.parallel import aggregate as agg
    from gqx_torch.parallel.packing import plan_units

    calls = []
    mean = TopKCompressor.users_mean
    monkeypatch.setattr(TopKCompressor, "users_mean",
                        lambda self, dec: calls.append(tuple(dec.shape)) or mean(self, dec))
    users, leaves = 3, {"Dense_0/kernel": (64, 96), "Dense_1/kernel": (96, 64)}
    cfg = GQConfig(quantizer="topk", cr=8, num_users=users, ef=True)
    plan = plan_units(list(leaves.items()), {p: p for p in leaves}, cfg)
    grads = {p: torch.from_numpy(rng.standard_normal((users,) + s).astype(np.float32))
             for p, s in leaves.items()}
    state = agg.init_state(plan, users, True, False)
    out = agg.make_aggregator(cfg, plan)(grads, state, 0.5, None)
    assert calls == [(users, u.size) for u in plan.units]
    # first step: e = g, and top-k's round trip and what it left add up to e
    # exactly, so the mean is the in-order mean of g - the new error
    want = [functools.reduce(torch.add, g - e) * (1.0 / users)
            for g, e in zip(plan.pack(grads), state.ef)]
    for p, v in plan.unpack(want).items():
        assert torch.equal(out[p], v), p


# -- Maurey ---------------------------------------------------------------------

def _exact_cdf_input(rng, kind, users, size):
    """Integer |v| whose l1 is 4096: every partial sum of |v| / l1 is a
    multiple of 2^-12, exact in float32 in any order."""
    if kind == "zeros":
        return np.zeros((users, size), np.float32)
    v = np.empty((users, size), np.float32)
    for i in range(users):
        a = rng.integers(0, 2, size)
        a[rng.choice(size, 4096 - a.sum(), replace=False)] += 1
        v[i] = a * rng.choice([-1.0, 1.0], size)
    return v


@pytest.mark.parametrize("kind", ["integers", "zeros"])
def test_maurey_matches_gqx_on_an_exact_cdf(kind, rng):
    """With gqx's uniforms: codes, signs (0 for a zero coordinate, as for
    every sample of an all-zero vector) and scale exactly gqx's, and so is
    each user's decode."""
    users, size = 2, 4096
    gq, pt = _pair("maurey", size)
    assert (pt.cr, pt.idx_bits, pt.k) == (gq.cr, gq.idx_bits, gq.k)
    v = _exact_cdf_input(rng, kind, users, size)
    keys = [jax.random.PRNGKey(5 + i) for i in range(users)]
    sig_j = [gq.compress(jnp.asarray(v[i]), keys[i]) for i in range(users)]
    r = np.stack([np.asarray(jax.random.uniform(k, (gq.k,))) for k in keys])
    sig = pt.sample(torch.from_numpy(v), torch.from_numpy(r))
    for i in range(users):
        np.testing.assert_array_equal(sig["codes"][i].numpy(), np.asarray(sig_j[i]["codes"]))
        np.testing.assert_array_equal(sig["signs"][i].numpy(), np.asarray(sig_j[i]["signs"]))
        assert float(sig["scale"][i]) == float(sig_j[i]["scale"])
        np.testing.assert_array_equal(pt.decompress_batch(sig)[i].numpy(),
                                      np.asarray(gq.decompress(sig_j[i])))
    if kind == "zeros":
        assert bool((sig["signs"] == 0).all()) and bool((sig["codes"] == size - 1).all())


def test_maurey_without_samples_raises():
    """cr = 32*c_dim // (k_bit + n_bit) == 0: gqx divides by zero at plan
    time; the port raises a ValueError naming the configuration."""
    cfg = dict(quantizer="maurey", c_dim=1, k_bit=32, n_bit=8)
    with pytest.raises(ZeroDivisionError):
        gqx_make_compressor("maurey", 4096, (4096,), GqxConfig(**cfg))
    with pytest.raises(ValueError, match="c_dim=1, k_bit=32, n_bit=8"):
        make_compressor("maurey", 4096, (4096,), GQConfig(**cfg))


# -- PVQ ------------------------------------------------------------------------

def _gqx_pvq_uniforms(key, m):
    """The uniforms gqx's PVQ draws for its samples (gqx/compress/vq.py:412-426)."""
    return np.asarray(jax.random.uniform(jax.random.split(key)[0], (m,)))


def _codes_off_boundary(rows, c_dagger, r, got, want, eps=1e-5, tol=1e-6):
    """Rows whose codes differ must have r - eps within ``tol`` of the
    float64 CDF between the two codes; returns how many differ."""
    differ = np.nonzero(got != want)[0]
    p = rows[differ].astype(np.float64) @ c_dagger.astype(np.float64).T
    cdf = np.cumsum(np.abs(p) / np.abs(p).sum(1, keepdims=True), axis=1)
    for j, i in enumerate(differ):
        lo, hi = sorted((int(got[i]), int(want[i])))
        assert np.abs(r[i] - eps - cdf[j, lo:hi]).min() <= tol, i
    return len(differ)


def test_pvq_matches_gqx_with_gqx_uniforms(rng):
    """c_dagger bit-equal; p within 1e-6 relative; codes equal but where r
    lies within 1e-6 of a float64 CDF boundary; u (unquantized, n_bit 32)
    within 1e-6 relative where the codes agree."""
    users, size = 2, 8192
    gq, pt = _pair("pvq", size, n_bit=32)
    assert pt.c_dagger.numpy().tobytes() == np.asarray(gq.c_dagger).tobytes()
    assert pt.codewords.numpy().tobytes() == np.asarray(gq.codewords).tobytes()
    v = rng.standard_normal((users, size)).astype(np.float32)
    keys = [jax.random.PRNGKey(3 + i) for i in range(users)]
    sig_j = [gq.compress(jnp.asarray(v[i]), keys[i]) for i in range(users)]
    r = np.stack([_gqx_pvq_uniforms(k, gq.M) for k in keys])
    u, codes = pt.encode(torch.from_numpy(v), torch.from_numpy(r))
    rows = v.reshape(-1, 16)
    p_j = np.asarray(jnp.dot(jnp.asarray(rows), gq.c_dagger.T, precision=jax.lax.Precision.HIGHEST))
    p = torch.from_numpy(rows) @ pt.c_dagger.t()
    np.testing.assert_allclose(p.numpy(), p_j, rtol=1e-6, atol=1e-6 * np.abs(p_j).max())
    want_codes = np.concatenate([np.asarray(s["codes"]) for s in sig_j]).astype(np.int64)
    want_u = np.concatenate([np.asarray(s["u"]) for s in sig_j])
    got_codes = codes.reshape(-1).long().numpy()
    off = _codes_off_boundary(rows, pt.c_dagger.numpy(), r.reshape(-1), got_codes, want_codes)
    print(f"pvq: {off} of {got_codes.size} samples at a CDF boundary")
    same = got_codes == want_codes
    np.testing.assert_allclose(u.reshape(-1).numpy()[same], want_u[same], rtol=1e-6)


def test_pvq_unbiased():
    """gqx's test_pvq_unbiased: with K == dim (an orthonormal codebook) the
    mean decode of 8192 draws is v to 0.15."""
    v = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    pt = ProbabilisticVectorCompressor(64, (64,), c_dim=8, k_bit=3, n_bit=32, random=False)
    assert pt.K == 8 == pt.dim
    vecs = torch.from_numpy(np.tile(v, (8192, 1)))
    mean = pt.decode_mean(pt.compress_batch(vecs, torch.Generator().manual_seed(7)))
    np.testing.assert_allclose(mean.numpy(), v, atol=0.15)


# -- Residual -------------------------------------------------------------------

def test_residual_matches_gqx(rng, monkeypatch):
    """HSQ (passes=2 whatever hsq_passes says, bf16-exact codebook) then PVQ
    (the file's codebook) on the residual, norms with random=False and the
    PVQ samples fed gqx's uniforms: the HSQ stage's codes and levels equal
    gqx's (its kernels in interpret mode) and its bounds to 1e-6; the PVQ
    stage's codes equal but at a CDF boundary, its levels equal where the
    codes are; the decode within 1e-5 on every other subvector."""
    shim = types.SimpleNamespace(**{
        name: functools.partial(getattr(pallas_hsq4, name), interpret=True)
        for name in ("hsq_encode_flat", "hsq_decode_flat", "hsq_decode_mean")
    })
    monkeypatch.setattr(gqx_vq, "_hsq_kernels", lambda: shim)
    users, size = 2, 8192
    segs = (100, 412)
    kw = dict(quantizer="residual", c_dim=16, k_bit=8, n_bit=6, random=False, hsq_passes=1)
    gcfg = GqxConfig(**kw)
    gcfg.use_pallas = True
    gq = gqx_make_compressor("residual", size, (size,), gcfg, norm_segment_sizes=segs)
    pt = make_compressor("residual", size, (size,), GQConfig(**kw), norm_segment_sizes=segs)
    hsq, pvq = pt.stages
    assert hsq.passes == 2 == gq.stages[0].passes and hsq.flat_ok
    assert hsq.codewords.numpy().tobytes() == gqx_bf16_exact(pvq.file_codebook).tobytes()
    assert pvq.codewords.numpy().tobytes() == np.asarray(gq.stages[1].codewords).tobytes()

    v = rng.standard_normal((users, size)).astype(np.float32)
    keys = [jax.random.PRNGKey(11 + i) for i in range(users)]
    sig_j = [gq.compress(jnp.asarray(v[i]), keys[i]) for i in range(users)]
    # gqx splits the key per stage, then PVQ's for its samples
    r = np.stack([_gqx_pvq_uniforms(jax.random.split(k, 2)[1], pvq.M) for k in keys])
    monkeypatch.setattr(vq, "uniform", lambda seed, offset, shape, device: torch.from_numpy(r))
    sig = pt.compress_batch(torch.from_numpy(v), torch.Generator().manual_seed(0))

    s0 = [s["stage0"] for s in sig_j]
    np.testing.assert_array_equal(sig["stage0"]["codes"].numpy(),
                                  np.stack([np.asarray(s["codes"]) for s in s0]))
    np.testing.assert_array_equal(sig["stage0"]["u"]["l"].numpy(),
                                  np.stack([np.asarray(s["u"]["l"]) for s in s0]))
    for b in ("lower", "upper"):
        np.testing.assert_allclose(sig["stage0"]["u"][b].numpy(),
                                   np.stack([np.asarray(s["u"][b]) for s in s0]), rtol=1e-6)

    s1 = [s["stage1"] for s in sig_j]
    residual = (torch.from_numpy(v) - hsq.decompress_batch(sig["stage0"])).numpy()
    got_codes = sig["stage1"]["codes"].reshape(-1).long().numpy()
    want_codes = np.concatenate([np.asarray(s["codes"]) for s in s1]).astype(np.int64)
    off = _codes_off_boundary(residual.reshape(-1, 16), pvq.c_dagger.numpy(), r.reshape(-1),
                              got_codes, want_codes)
    same = (got_codes == want_codes).reshape(users, -1)
    l_j = np.stack([np.asarray(s["u"]["l"]) for s in s1])
    assert (sig["stage1"]["u"]["l"].numpy() != l_j)[same].sum() <= 2
    dec = pt.decompress_batch(sig).numpy().reshape(users, -1, 16)
    dec_j = np.stack([np.asarray(gq.decompress(s)) for s in sig_j]).reshape(users, -1, 16)
    close = np.isclose(dec, dec_j, rtol=1e-5, atol=1e-6 * np.abs(dec_j).max()).all(-1)
    flipped = ~same | (sig["stage1"]["u"]["l"].numpy() != l_j)
    print(f"residual: {off} PVQ samples at a CDF boundary")
    assert not np.any(~close & ~flipped)


# -- the entry point ------------------------------------------------------------

@pytest.mark.parametrize("quantizer", ["topk", "maurey", "pvq", "residual"])
def test_cli_trains_each_new_quantizer(quantizer, tmp_path):
    """``python -m gqx_torch.cli --network fcn --platform cpu`` with each of
    the four: 4,096 synthetic images in batches of 8 x 256, two steps, finite
    loss and a test accuracy."""
    state, accuracy = main(["--network", "fcn", "--dataset", "synthetic", "--quantizer",
                            quantizer, "--c-dim", "16", "--k-bit", "6", "--n-bit", "6",
                            "--cr", "64", "--num-users", "8", "--batch-size", "256",
                            "--epochs", "1", "--platform", "cpu", "--logdir", str(tmp_path)])
    assert state.step == 2
    assert 0.0 <= accuracy <= 1.0
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
