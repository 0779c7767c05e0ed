"""The port's distributed backend (gqx_torch.parallel.collectives and
distributed) on the CPU with gloo.

In this process: a group of one rank (in process, a HashStore); its
distributed steps against the port's sim step with the same generator,
bit for bit with ``random=True``.  Then ONE pair of gloo processes
(``gqx_torch.scripts.dist_worker``, a FileStore rendezvous under tmp_path)
runs every two-rank job in turn: the modes against the sim step, a
checkpoint save and resume, a codebook no file holds, the segmented ring
against gqx's mesh step at two devices, and a two-process CLI drive.
"""

import functools
import json
import os
import signal
import subprocess
import sys
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
from gqx_torch import cli
from gqx_torch.compress import make_compressor
from gqx_torch.compress.api import UserRows, batch_uniform, draw_seed
from gqx_torch.config import GQConfig
from gqx_torch.convert import from_jax
from gqx_torch.models import create_model
from gqx_torch.ops.wire import wire_bytes
from gqx_torch.parallel import collectives, distributed
from gqx_torch.train import create_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USERS, BATCH, STEPS = 4, 4, 4
HSQ = dict(network="fcn", quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, hsq_passes=1,
           num_users=USERS, batch_size=BATCH)
# the two-rank jobs that hold the sim step's values (mode -> GQConfig extras).
# They take the per-user loop: the folded step gives a dense bias the folded
# total / U of its users (no per-user gradient, gqx's rule), a sum over
# another count of rows on a rank than in the sim step, and the CPU's matmul
# gives a row other bits in a batch of fewer than 16 rows
LOOP = dict(folded_users=False)
# logical PS through HSQ's fused decode-mean rounds each rank's mean weights
# to bf16 (hsq_passes=1), so its two-rank mean is another rounding than the
# sim's: it is held to the sim through QSGD, whose mean is the decodes' sum
MODES = {
    "ps_logical": dict(quantizer="qsgd", c_dim=128, n_bit=4),
    "ps_logical_hsq": dict(),
    "ps_packed": dict(wire="packed"),
    "ps_packed_ef_two_phase": dict(wire="packed", ef=True, two_phase=True),
    "ring": dict(mode="ring"),
    "ring_ef": dict(mode="ring", ef=True),
}
BIT_EQUAL = ("ps_packed", "ps_packed_ef_two_phase", "ring", "ring_ef")
# logical PS agrees to float32 order, and a later step's encode can turn
# that into a level flipped at a boundary: it is held after a step
STEPS_OF = {"ps_logical": 1}
# gqx's multihost smoke configuration, and canonical HSQ
GQX_QUANT = {"qsgd": dict(quantizer="qsgd", c_dim=128, n_bit=4),
             "hsq": dict(quantizer="hsq", c_dim=16, k_bit=8, n_bit=6, hsq_passes=1)}
CLI_FLAGS = ["--network", "fcn", "--dataset", "synthetic", "--quantizer", "hsq", "--c-dim",
             "16", "--k-bit", "6", "--n-bit", "6", "--num-users", "8", "--batch-size", "64",
             "--epochs", "1", "--platform", "cpu", "--backend", "mesh", "--wire", "packed"]
PAIR_TIMEOUT = 240


@pytest.fixture(autouse=True)
def deadline():
    """A per-test time limit: SIGALRM fails the test."""
    def fire(signum, frame):
        raise TimeoutError("the test ran past its time limit")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(300)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread a process, as the workers run (the suite runs several
    processes on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group():
    """A gloo group of one rank in this process."""
    assert distributed.maybe_initialize(device="cpu", world_of_one=True)
    yield
    dist.destroy_process_group()


def _batches(seed=0, users=USERS, steps=STEPS):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((steps, users, BATCH, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (steps, users, BATCH))
    return torch.from_numpy(x), torch.from_numpy(y)


def _train(config, x, y, weights=None, gen_seed=7, scale=0.5, rows=None):
    """``config``'s steps on users ``rows`` (all) of each batch; returns
    (losses, state)."""
    model = create_model("fcn", 10, "float32", torch.Generator().manual_seed(0))
    if weights is not None:
        model.load_state_dict(weights)
    state, plan = create_train_state(config, model, device="cpu")
    step = make_train_step(config, plan)
    gen = torch.Generator().manual_seed(gen_seed)
    lo, hi = rows or (0, x.shape[1])
    losses = [float(step(state, x[s][lo:hi], y[s][lo:hi], 0.1, 5e-4, gen, scale))
              for s in range(x.shape[0])]
    return losses, state


def _tensors(state):
    """Every tensor of a state that the ranks replicate, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"trace.{k}": v for k, v in state.trace.items()})
    for i, t in enumerate(state.agg_state.server_ef or ()):
        out[f"server_ef.{i}"] = t
    return out


def _assert_bit_equal(got, want, what):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what}: {k} differs"


# -- one rank in process -----------------------------------------------------

@pytest.mark.parametrize("mode", ["ps_logical", "ps_logical_ef_two_phase", "ps_packed",
                                  "ps_packed_ef_two_phase", "ring", "ring_ef"])
def test_one_rank_equals_the_sim_step(group, mode):
    """At W = 1 every rank-local draw, kernel and order is the sim step's:
    losses, parameters, BN statistics, momentum and both EF states equal it
    bit for bit, with random=True."""
    extra = dict(MODES.get(mode, {}))
    if mode == "ps_logical_ef_two_phase":
        extra = dict(ef=True, two_phase=True)
    x, y = _batches(steps=2)
    ls, sim = _train(GQConfig(**dict(HSQ, **extra)), x, y)
    lm, mesh = _train(GQConfig(**dict(HSQ, backend="mesh", **extra)), x, y)
    assert ls == lm
    _assert_bit_equal(_tensors(mesh), _tensors(sim), mode)
    for a, b in zip(mesh.agg_state.ef or (), sim.agg_state.ef or ()):
        assert torch.equal(a, b)


def test_segmented_ring_error_feedback_slots(group):
    """The segmented ring keeps one (1, W, chunk) EF slot per send, and a
    state of another shape is refused, not zeroed."""
    cfg = GQConfig(**HSQ, backend="mesh", mode="ring", ring_mode="segmented", ef=True)
    x, y = _batches(steps=2)
    _, state = _train(cfg, x, y)
    model = state.model
    chunks = [tuple(e.shape) for e in state.agg_state.ef]
    assert chunks == [(1, 1, 262_144), (1, 1, 266)]
    # the HSQ unit's residuals; the identity unit is lossless
    assert bool(state.agg_state.ef[0].any()) and not state.agg_state.ef[1].any()
    _, plan = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, plan)
    state.agg_state.ef = [torch.zeros(USERS, u.size) for u in plan.units]
    with pytest.raises(ValueError, match="error feedback of shapes"):
        step(state, x[0], y[0], 0.1, 5e-4, None)


def test_an_nccl_group_with_cpu_tensors_raises(group, monkeypatch):
    """NCCL moves tensors on the card only: a CPU step under an NCCL group
    raises (and a CUDA one under gloo would)."""
    cfg = GQConfig(**HSQ, backend="mesh")
    x, y = _batches(steps=1)
    model = create_model("fcn", 10, "float32", torch.Generator().manual_seed(0))
    state, plan = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, plan)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    with pytest.raises(ValueError, match="nccl process group with tensors on cpu"):
        step(state, x[0], y[0], 0.1, 5e-4, torch.Generator())
    assert distributed.backend_for("cuda") == "nccl" and distributed.backend_for("cpu") == "gloo"


@pytest.mark.parametrize("users,world", [(3, 2), (8, 3), (6, 4)])
def test_a_world_that_does_not_divide_the_users_raises(users, world):
    """gqx drops devices until their count divides the users; a rank cannot
    be dropped, so the port raises."""
    with pytest.raises(ValueError, match="do not divide"):
        distributed.process_user_range(users, 0, world)
    assert distributed.process_user_range(users * world, 1, world) == (users, 2 * users)
    rows = np.arange(4 * world).reshape(2 * world, 2)
    np.testing.assert_array_equal(distributed.local_user_batch(rows, 1, world), rows[2:4])


def test_batch_uniforms_of_a_users_view():
    """A rank's users draw their rows of the whole batch's stream: the two
    halves of a batch are its rows, bit for bit, and differ."""
    whole = batch_uniform(torch.Generator().manual_seed(3), (4, 7), "cpu")
    halves = [batch_uniform(UserRows(torch.Generator().manual_seed(3), a, 2), (2, 7), "cpu")
              for a in (0, 2)]
    assert torch.equal(torch.cat(halves), whole)
    assert not torch.equal(halves[0], halves[1])
    with pytest.raises(ValueError):
        batch_uniform(UserRows(torch.Generator(), 0, 3), (2, 7), "cpu")


@pytest.mark.parametrize("name", ["sgd", "sign", "qsgd", "terngrad", "hsq", "pvq",
                                  "residual", "topk", "maurey"])
@pytest.mark.parametrize("random", [True, False])
def test_seed_draws_counts_the_draws(name, random, monkeypatch):
    """``seed_draws`` is the number of seeds a compress draws: the chain
    ring's ranks skip that many per hop of another rank."""
    cfg = GQConfig(quantizer=name, c_dim=16, k_bit=8, n_bit=6, random=random, cr=4)
    comp = make_compressor(name, 4096, (4096,), cfg, device="cpu")
    calls = []
    real = torch.randint
    monkeypatch.setattr(torch, "randint", lambda *a, **k: calls.append(1) or real(*a, **k))
    comp.compress_batch(torch.randn(2, 4096), torch.Generator().manual_seed(0))
    assert len(calls) == comp.seed_draws


def test_packed_rows_are_wire_bytes():
    """One int32 row of wire_bytes / 4 words per user, unpacked bit for bit."""
    cfg = GQConfig(**HSQ)
    comp = make_compressor("hsq", 65_536, (65_536,), cfg, device="cpu")
    sig = comp.compress_batch(torch.randn(3, 65_536), torch.Generator().manual_seed(1))
    rows, layout = collectives.pack_rows(comp, sig)
    assert rows.dtype == torch.int32 and rows.shape == (3, wire_bytes(comp) // 4)
    back = collectives.unpack_rows(comp, rows, layout)
    assert torch.equal(back["codes"], sig["codes"]) and torch.equal(back["u"]["l"], sig["u"]["l"])
    assert torch.equal(back["u"]["lower"], sig["u"]["lower"])


def test_the_segmented_ring_seeds_are_one_table():
    """The segmented ring's hop seeds depend on the unit's seed and the (rank,
    hop) index only, and no two of a 4 x 4 table are equal."""
    seed = draw_seed(torch.Generator().manual_seed(5))
    table = [collectives.hop_seed(seed, i) for i in range(16)]
    assert len(set(table)) == 16 and all(0 <= s < 2 ** 63 for s in table)
    assert table == [collectives.hop_seed(seed, i) for i in range(16)]


def test_chain_ring_warns_past_eight_ranks():
    cfg = GQConfig(mode="ring")
    with pytest.warns(UserWarning, match="latency-bound"):
        assert collectives.warn_chain_ring_scale(cfg, 16)
    assert not collectives.warn_chain_ring_scale(cfg, 8)
    assert not collectives.warn_chain_ring_scale(GQConfig(mode="ring", ring_mode="segmented"), 16)


# -- two gloo ranks ----------------------------------------------------------

def _interpret_kernels():
    """gqx's flat HSQ kernels in interpret mode (tests/test_torch_train.py)."""
    return types.SimpleNamespace(**{
        name: functools.partial(getattr(pallas_hsq4, name), interpret=True)
        for name in ("hsq_encode_flat", "hsq_decode_flat", "hsq_decode_mean")})


def _gqx_segmented(quant, tmp_path):
    """gqx's segmented ring at 2 users (make_user_mesh takes 2 of the 8
    virtual devices), random=False, 3 steps; its initial weights go to the
    port as a state dict.  Returns (weights path, batches path, losses)."""
    users = 2
    kw = dict(network="fcn", random=False, num_users=users, batch_size=BATCH,
              backend="mesh", mode="ring", ring_mode="segmented", **GQX_QUANT[quant])
    gcfg = GqxConfig(**kw)
    gcfg.use_pallas = True
    gmodel = gqx_create_model("fcn", 10)
    gstate, plan, tx = gqx_create_state(gcfg, gmodel, jnp.zeros((BATCH, 28, 28, 1)),
                                        jax.random.PRNGKey(0))
    model = create_model("fcn", 10)
    sd, _ = from_jax(model, jax.tree.map(np.asarray, gstate.params))
    weights = tmp_path / f"gqx_{quant}.pt"
    torch.save(sd, weights)
    x, y = _batches(seed=11, users=users, steps=3)
    batches = tmp_path / f"gqx_{quant}_batches.pt"
    torch.save({"x": x, "y": y}, batches)
    step, gstate = gqx_mesh_step(gcfg, gmodel, plan, tx, gstate)
    losses = []
    for s in range(3):
        xs = jnp.asarray(x[s].numpy().transpose(0, 1, 3, 4, 2))
        gstate, loss = step(gstate, xs, jnp.asarray(y[s].numpy()), jnp.float32(1.0),
                            jnp.float32(0.05), jnp.float32(5e-4), jax.random.PRNGKey(s))
        losses.append(float(loss))
    return str(weights), str(batches), losses


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """ONE pair of gloo processes runs every two-rank job; returns (results
    {(job, rank): dict}, the jobs, gqx's segmented losses, the directory)."""
    tmp = tmp_path_factory.mktemp("pair")
    x, y = _batches()
    torch.save({"x": x, "y": y}, tmp / "batches.pt")
    common = dict(batches=str(tmp / "batches.pt"), steps=STEPS, seed=7, lr=0.1, wd=5e-4,
                  scale=0.5, weights=None)
    jobs = [dict(common, name=m, steps=STEPS_OF.get(m, STEPS),
                 config=dict(HSQ, backend="mesh", **LOOP, **extra))
            for m, extra in MODES.items()]
    jobs.append(dict(common, name="checkpoint", checkpoint_at=2,
                     config=dict(HSQ, backend="mesh", **LOOP,
                                 **MODES["ps_packed_ef_two_phase"])))
    jobs.append(dict(common, name="segmented_ef",
                     config=dict(HSQ, backend="mesh", mode="ring", ring_mode="segmented",
                                 ef=True)))
    # (8, 16): K 16 at dim 8, which no file holds
    jobs.append(dict(common, name="codebook", steps=1, codebook_cache=str(tmp / "cache"),
                     config=dict(HSQ, k_bit=4, c_dim=8, backend="mesh", wire="packed")))
    real = gqx_vq._hsq_kernels
    gqx_vq._hsq_kernels = _interpret_kernels
    try:
        gqx_losses = {q: _gqx_segmented(q, tmp) for q in GQX_QUANT}
    finally:
        gqx_vq._hsq_kernels = real
    for q, (weights, batches, _) in gqx_losses.items():
        jobs.append(dict(name=f"segmented_gqx_{q}", batches=batches, weights=weights, steps=3,
                         seed=7, lr=0.05, wd=5e-4, scale=1.0,
                         config=dict(network="fcn", random=False, num_users=2,
                                     batch_size=BATCH, backend="mesh", mode="ring",
                                     ring_mode="segmented", **GQX_QUANT[q])))
    spec = {"jobs": jobs, "cli": CLI_FLAGS + ["--logdir", str(tmp / "cli2")],
            "cli_store": str(tmp / "cli_store")}
    with open(tmp / "jobs.json", "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=REPO, GQX_CODEBOOK_TRAIN_SIZE="4096")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gqx_torch.scripts.dist_worker", str(tmp / "jobs.json"),
         str(r), "2", str(tmp / "store"), str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAIR_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = {}
    for job in jobs:
        for r in range(2):
            results[(job["name"], r)] = torch.load(tmp / f"{job['name']}.{r}.pt",
                                                   weights_only=True)
    return results, gqx_losses, tmp


def _replicated(result):
    out = {f"model.{k}": v for k, v in result["state_dict"].items()}
    out.update({f"trace.{k}": v for k, v in result["trace"].items()})
    for i, t in enumerate(result["server_ef"] or ()):
        out[f"server_ef.{i}"] = t
    return out


@pytest.mark.parametrize("mode", sorted(MODES) + ["segmented_ef"])
def test_two_ranks_end_bit_equal(pair, mode):
    """Parameters, BN running statistics, momentum and the server EF (the
    two-phase draws) are bit-equal on both ranks, and so are the losses."""
    results, _, _ = pair
    a, b = results[(mode, 0)], results[(mode, 1)]
    assert a["losses"] == b["losses"]
    _assert_bit_equal(_replicated(b), _replicated(a), mode)
    assert a["users"] == [0, 2] and b["users"] == [2, 4]


@pytest.mark.parametrize("mode", sorted(set(MODES) - {"ps_logical_hsq"}))
def test_two_ranks_equal_the_sim_step(pair, mode):
    """Packed PS and the chain ring give the sim step's values bit for bit
    (the per-user loop: see LOOP) with random=True (each rank's users draw their rows of the sim's
    uniforms); after logical PS's all-reduce of two local means, the
    parameters and momentum are within 1e-6 of each tensor's largest
    magnitude.  Each rank's EF is its users' rows of the sim's."""
    results, _, _ = pair
    x, y = _batches()
    n = STEPS_OF.get(mode, STEPS)
    losses, sim = _train(GQConfig(**dict(HSQ, **LOOP, **MODES[mode])), x[:n], y[:n])
    want = _tensors(sim)
    for r in range(2):
        got = results[(mode, r)]
        if mode in BIT_EQUAL:
            assert got["losses"] == losses
            _assert_bit_equal(_replicated(got), want, f"{mode} rank {r}")
            for e, full in zip(got["ef"] or (), sim.agg_state.ef or ()):
                assert torch.equal(e, full[2 * r:2 * r + 2])
        else:
            np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
            g = _replicated(got)
            for k, w in want.items():
                tol = 1e-6 * w.abs().max() + 1e-12
                assert float((g[k] - w).abs().max()) <= tol, k


def test_a_two_rank_checkpoint_resumes_bit_for_bit(pair):
    """After 2 steps rank 0 writes one checkpoint (both ranks' EF gathered),
    each rank restores its users' rows into a fresh state, and 2 more steps
    end bit-equal to 4 unbroken ones."""
    results, _, tmp = pair
    assert sorted(os.listdir(tmp / "checkpoint_checkpoints")) == ["gqx_state_2.msgpack"]
    for r in range(2):
        got, want = results[("checkpoint", r)], results[("ps_packed_ef_two_phase", r)]
        assert got["losses"] == want["losses"]
        _assert_bit_equal(_replicated(got), _replicated(want), f"rank {r}")
        for a, b in zip(got["ef"], want["ef"]):
            assert torch.equal(a, b)


def test_a_missing_codebook_is_trained_by_rank_0_only(pair):
    """(8, 16) is in no file: rank 0 trains it once, rank 1 takes it by
    broadcast, and both hold the same bytes."""
    results, _, tmp = pair
    a, b = results[("codebook", 0)], results[("codebook", 1)]
    assert (a["trained"], b["trained"]) == (1, 0)
    assert a["codebook"].shape == (16, 8)
    assert torch.equal(a["codebook"].view(torch.int32), b["codebook"].view(torch.int32))
    assert os.path.exists(tmp / "cache" / "angular_dim_8_Ks_16.fvecs")


@pytest.mark.parametrize("quant", sorted(GQX_QUANT))
def test_segmented_ring_matches_gqx_at_two_ranks(pair, quant):
    """The port's segmented ring at W = 2 against gqx's at two devices, from
    the same weights and batches, random=False: losses within 1e-5."""
    results, gqx_losses, _ = pair
    want = gqx_losses[quant][2]
    for r in range(2):
        np.testing.assert_allclose(results[(f"segmented_gqx_{quant}", r)]["losses"], want,
                                   rtol=1e-5)


def test_a_two_process_cli_drive_logs_the_one_process_losses(pair, group, tmp_path):
    """``gqx_torch.cli --backend mesh --wire packed`` in two processes: rank 0
    logs the loss and accuracy lines of the one-process run (packed PS is
    the sim step's at any W); rank 1 logs nothing."""
    _, _, tmp = pair
    state, accuracy = cli.main(CLI_FLAGS + ["--logdir", str(tmp_path)])
    for r in range(2):
        got = torch.load(tmp / f"cli.{r}.pt", weights_only=True)
        assert (got["step"], got["accuracy"]) == (state.step, accuracy)

    def lines(d):
        with open(os.path.join(d, "scalars.csv")) as f:
            return [line.split(",")[:3] for line in f.read().splitlines()[1:]]

    assert lines(tmp / "cli2") == lines(tmp_path)
    assert [t for t, _, _ in lines(tmp_path)] == [
        "wire_bytes_per_user_step", "compression_ratio_vs_fp32", "loss", "accuracy(%)"]
