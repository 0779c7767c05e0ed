"""The port's distributed step against gqx's mesh step, and checkpoints that
do not fit the state they are restored into.

gqx's mesh step runs on conftest's 8 virtual CPU devices at 8 users (one a
device), its HSQ kernels in interpret mode; the port's on a gloo group of
one rank in this process.  PS and the chain ring do not depend on the
device count but through float32 order, so the losses agree within 1e-5
(``tests/test_multihost.py``'s tolerance) with ``random=False``.  The
segmented ring does depend on it: ``tests/test_torch_collectives.py`` holds
it at two ranks against gqx at two devices.
"""

import functools
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import gqx.compress.vq as gqx_vq
from gqx.config import GQConfig as GqxConfig
from gqx.models import create_model as gqx_create_model
from gqx.ops import pallas_hsq4
from gqx.parallel.collectives import make_mesh_train_step as gqx_mesh_step
from gqx.train import create_train_state as gqx_create_state
from gqx_torch.checkpoint import restore_checkpoint, save_checkpoint
from gqx_torch.config import GQConfig
from gqx_torch.convert import from_jax
from gqx_torch.models import create_model
from gqx_torch.parallel import distributed
from gqx_torch.train import create_train_state, make_train_step

USERS, BATCH, STEPS = 8, 4, 3
QUANT = {"qsgd": dict(quantizer="qsgd", c_dim=128, n_bit=4),
         "hsq": dict(quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, hsq_passes=1)}
MODES = {"ps_logical": dict(mode="ps"), "ps_packed": dict(mode="ps", wire="packed"),
         "ring": dict(mode="ring")}


@pytest.fixture(autouse=True)
def deadline():
    """A per-test time limit: SIGALRM fails the test."""
    def fire(signum, frame):
        raise TimeoutError("the test ran past its time limit")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def group():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    assert distributed.maybe_initialize(device="cpu", world_of_one=True)
    yield
    dist.destroy_process_group()
    torch.set_num_threads(n)


@pytest.fixture
def interpret_kernels(monkeypatch):
    shim = types.SimpleNamespace(**{
        name: functools.partial(getattr(pallas_hsq4, name), interpret=True)
        for name in ("hsq_encode_flat", "hsq_decode_flat", "hsq_decode_mean")})
    monkeypatch.setattr(gqx_vq, "_hsq_kernels", lambda: shim)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("quant", sorted(QUANT))
def test_mesh_step_matches_gqx(group, interpret_kernels, quant, mode):
    kw = dict(network="fcn", random=False, num_users=USERS, batch_size=BATCH, backend="mesh",
              **QUANT[quant], **MODES[mode])
    gcfg = GqxConfig(**kw)
    gcfg.use_pallas = True
    gmodel = gqx_create_model("fcn", 10)
    gstate, plan, tx = gqx_create_state(gcfg, gmodel, jnp.zeros((BATCH, 28, 28, 1)),
                                        jax.random.PRNGKey(0))
    model = create_model("fcn", 10)
    sd, _ = from_jax(model, jax.tree.map(np.asarray, gstate.params))
    model.load_state_dict(sd)
    cfg = GQConfig(**kw)
    state, port_plan = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, port_plan)
    gstep, gstate = gqx_mesh_step(gcfg, gmodel, plan, tx, gstate)
    rng = np.random.default_rng(3)
    for s in range(STEPS):
        x = rng.standard_normal((USERS, BATCH, 28, 28, 1)).astype(np.float32)
        y = rng.integers(0, 10, (USERS, BATCH))
        gstate, gloss = gstep(gstate, jnp.asarray(x), jnp.asarray(y), jnp.float32(1.0),
                              jnp.float32(0.05), jnp.float32(5e-4), jax.random.PRNGKey(s))
        loss = step(state, torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()),
                    torch.from_numpy(y), 0.05, 5e-4, None, 1.0)
        np.testing.assert_allclose(float(loss), float(gloss), rtol=1e-5)


def _ef_state(**extra):
    cfg = GQConfig(network="fcn", quantizer="qsgd", c_dim=128, n_bit=4, num_users=2, ef=True,
                   **extra)
    return create_train_state(cfg, create_model("fcn", 10), device="cpu")[0]


def test_a_checkpoint_of_another_unit_count_raises(tmp_path):
    """gqx's restore raises on a list of another length; the port's did copy
    a prefix.  It raises now, naming what differs."""
    state = _ef_state()
    fewer = _ef_state()
    fewer.agg_state.ef = fewer.agg_state.ef[:1]
    path = save_checkpoint(str(tmp_path), fewer, step=1)
    with pytest.raises(ValueError, match=r"error-feedback state of 1 units, the target has 2"):
        restore_checkpoint(path, state)


@pytest.mark.parametrize("users", [1, 4])
def test_a_checkpoint_of_another_buffer_shape_raises(tmp_path, users):
    """A unit's EF buffer of another shape (another user count here; a
    segmented ring's (W, W, chunk) slots) raises naming the unit."""
    state = _ef_state()
    other = create_train_state(GQConfig(network="fcn", quantizer="qsgd", c_dim=128, n_bit=4,
                                        num_users=users, ef=True),
                               create_model("fcn", 10), device="cpu")[0]
    path = save_checkpoint(str(tmp_path), other, step=1)
    with pytest.raises(ValueError, match="error-feedback of unit 0 has shape"):
        restore_checkpoint(path, state)
