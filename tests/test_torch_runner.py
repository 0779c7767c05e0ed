"""gqx_torch's runner (and its metrics and checkpoint) against gqx's.

All on the CPU (``device="cpu"``: the plain versions of the kernels), on
FCN and the synthetic set cut to a few hundred images.  The runners are
compared with the numpy augment in both packages (both native libraries
patched away) and, each once more, at both packages' defaults, where both
take their C++ augment (gqx's ``native/``, the port's
``gqx_torch/csrc/gqx_native.cc``): the two augments are not bit-equal, so
like is compared with like.
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
import gqx.data.native as gqx_native
import gqx.runner as gqx_runner
import gqx_torch.data.native as port_native
import gqx_torch.runner as port_runner
from gqx.config import GQConfig as GqxConfig
from gqx.config import lr_at_epoch as gqx_lr_at_epoch
from gqx.config import resolve_schedule as gqx_resolve_schedule
from gqx.config import wd_at_epoch as gqx_wd_at_epoch
from gqx.models import create_model as gqx_create_model
from gqx.ops import pallas_hsq4
from gqx.runner import run_training as gqx_run_training
from gqx.train import create_train_state as gqx_create_state
from gqx_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from gqx_torch.config import GQConfig, lr_at_epoch, resolve_schedule, wd_at_epoch
from gqx_torch.convert import from_jax
from gqx_torch.metrics import export_csv, export_tree
from gqx_torch.models import create_model
from gqx_torch.runner import run_training
from gqx_torch.train import create_train_state

SMALL = dict(num_train=512, num_test=256, image_shape=(16, 16, 3))


@pytest.fixture(autouse=True)
def few_threads():
    """The suite runs in several worker processes on one host, and torch's
    default of a thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def cfg(logdir=None, cls=GQConfig, **kw):
    """tests/test_runner.py's configuration on the cut synthetic set:
    8 steps an epoch."""
    base = dict(network="fcn", dataset="synthetic", quantizer="qsgd", c_dim=128,
                n_bit=4, num_users=4, batch_size=16, test_batch_size=256, seed=3,
                log_epoch=2, eval_batch_count=1, dataset_kwargs=SMALL, logdir=logdir)
    base.update(kw)
    return cls(**base)


def _rows(logdir):
    with open(os.path.join(logdir, "scalars.csv")) as f:
        return list(csv.DictReader(f))


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.state_dict().items()}


def _augment(monkeypatch, which):
    """Both packages on the numpy augment, or both at their defaults: the
    native library in each, which must load."""
    if which == "numpy":
        monkeypatch.setattr(gqx_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)
        return
    if not gqx_native.available():
        # a worker that read gqx's library while another built it: try again
        monkeypatch.setattr(gqx_native, "_tried", False)
    assert gqx_native.available() and port_native.available()


@pytest.mark.parametrize("dataset", ["cifar10", "mnist", "tinyimg"])
@pytest.mark.parametrize("quantizer", ["hsq", "sign"])
def test_schedules_match_gqx(dataset, quantizer):
    """lr and wd at every epoch around each boundary of each schedule, the
    reference's re-hardcoded weight decay included (tests/test_train.py)."""
    port = resolve_schedule(GQConfig(dataset=dataset, quantizer=quantizer))
    ref = gqx_resolve_schedule(GqxConfig(dataset=dataset, quantizer=quantizer))
    assert port == ref
    epochs, base_lr, boundaries, lrs, _, wd = port
    points = {1, epochs, epochs + 1} | {b + d for b in boundaries for d in (-1, 0, 1)}
    for e in sorted(points):
        assert lr_at_epoch(e, base_lr, boundaries, lrs) == gqx_lr_at_epoch(e, base_lr, boundaries, lrs)
        assert wd_at_epoch(e, wd, boundaries) == gqx_wd_at_epoch(e, wd, boundaries)


def _one_epoch_schedule(resolve):
    return lambda config: (1,) + tuple(resolve(config)[1:])


def test_metrics_csv_rows_match_gqx(tmp_path, monkeypatch):
    """The same (tag, step) rows as gqx's runner, in the same order, and
    the same wire accounting.  The schedule is cut to one epoch, which the
    reference's loop runs as two (range(1, epochs + 2)); log_epoch=2 gives
    two eval points an epoch.  Both on the numpy augment."""
    _metrics_csv_rows_match_gqx(tmp_path, monkeypatch, "numpy")


def test_metrics_csv_rows_match_gqx_default_augment(tmp_path, monkeypatch):
    """As above, both runners at their default augment (the native one)."""
    _metrics_csv_rows_match_gqx(tmp_path, monkeypatch, "default")


def _metrics_csv_rows_match_gqx(tmp_path, monkeypatch, augment):
    _augment(monkeypatch, augment)
    monkeypatch.setattr(port_runner, "resolve_schedule", _one_epoch_schedule(resolve_schedule))
    monkeypatch.setattr(gqx_runner, "resolve_schedule",
                        _one_epoch_schedule(gqx_resolve_schedule))
    port_dir, gqx_dir = str(tmp_path / "port"), str(tmp_path / "gqx")
    state, _ = run_training(cfg(port_dir), progress=False, device="cpu")
    gstate, _ = gqx_run_training(cfg(gqx_dir, cls=GqxConfig), progress=False)
    assert state.step == int(gstate.step) == 16
    got, want = _rows(port_dir), _rows(gqx_dir)
    assert [(r["tag"], int(r["step"])) for r in got] == [(r["tag"], int(r["step"])) for r in want]
    assert [(r["tag"], int(r["step"])) for r in got if r["tag"] == "loss"] == [
        ("loss", 3), ("loss", 7), ("loss", 11), ("loss", 15)]
    for g, w in zip(got, want):
        if g["tag"] in ("wire_bytes_per_user_step", "compression_ratio_vs_fp32"):
            assert float(g["value"]) == pytest.approx(float(w["value"]), rel=1e-12)
        assert np.isfinite(float(g["value"]))
    written = export_csv(port_dir)
    assert os.path.exists(os.path.join(port_dir, "accuracypct.csv")), written


def test_export_tree_walks_runs(tmp_path):
    for sub in ("fcn/synthetic/qsgd", "fcn/synthetic/sgd"):
        run_training(cfg(str(tmp_path / sub), quantizer=sub.rsplit("/", 1)[1]),
                     epochs_override=1, max_steps=4, progress=False, device="cpu")
    out = export_tree(str(tmp_path))
    assert len(out) >= 4 and any(p.endswith("accuracypct.csv") for p in out)


def test_resume_continues_and_equals_an_uninterrupted_run(tmp_path):
    """The step count continues from the checkpoint, and with
    deterministic rounding (random=False) the resumed run ends bit-equal
    to two epochs in one run: parameters, momentum and step come back."""
    c = functools.partial(cfg, random=False, save_model=True)
    state1, _ = run_training(c(str(tmp_path / "a")), epochs_override=1, progress=False,
                             device="cpu")
    assert state1.step == 8
    assert latest_checkpoint(str(tmp_path / "a")).endswith("gqx_state_8.msgpack")
    state2, _ = run_training(c(str(tmp_path / "a")), epochs_override=2, progress=False,
                             resume=True, device="cpu")
    assert state2.step == 16
    straight, _ = run_training(c(str(tmp_path / "b")), epochs_override=2, progress=False,
                               device="cpu")
    for (n, a), b in zip(_params(state2).items(), _params(straight).values()):
        assert torch.equal(a, b), n
    for n in straight.trace:
        assert torch.equal(state2.trace[n], straight.trace[n]), n


def test_training_is_deterministic():
    a, _ = run_training(cfg(), epochs_override=1, progress=False, device="cpu")
    b, _ = run_training(cfg(), epochs_override=1, progress=False, device="cpu")
    for (n, x), y in zip(_params(a).items(), _params(b).values()):
        assert torch.equal(x, y), n


def test_profile_trace_written(tmp_path):
    prof = str(tmp_path / "trace")
    run_training(cfg(str(tmp_path), profile_dir=prof, profile_steps=2), epochs_override=1,
                 progress=False, device="cpu")
    found = [f for _, _, fs in os.walk(prof) for f in fs if f.endswith(".pt.trace.json")]
    assert found, "no torch.profiler trace written"


def test_checkpoint_round_trip_with_error_feedback(tmp_path):
    """Parameters, BN statistics, momentum, both EF buffers and the step
    come back into a fresh state; a state without EF refuses the file."""
    c = GQConfig(network="resnet18", quantizer="qsgd", c_dim=128, n_bit=4, num_users=2,
                 ef=True, two_phase=True)
    state, _ = create_train_state(c, create_model("resnet18", 10), device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in list(state.model.state_dict().values()) + list(state.trace.values()) \
                + state.agg_state.ef + state.agg_state.server_ef:
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    state.step = 123
    path = save_checkpoint(str(tmp_path), state, step=state.step)
    fresh, _ = create_train_state(c, create_model("resnet18", 10), device="cpu")
    restore_checkpoint(path, fresh)
    assert fresh.step == 123
    for (n, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(list(state.trace.values()) + state.agg_state.ef + state.agg_state.server_ef,
                    list(fresh.trace.values()) + fresh.agg_state.ef + fresh.agg_state.server_ef):
        assert torch.equal(a, b)
    no_ef, _ = create_train_state(GQConfig(network="resnet18", quantizer="qsgd", c_dim=128,
                                           n_bit=4, num_users=2),
                                  create_model("resnet18", 10), device="cpu")
    with pytest.raises(ValueError):
        restore_checkpoint(path, no_ef)


def test_runner_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        run_training(cfg(), epochs_override=1, progress=False)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """gqx's flat-layout kernels in interpret mode (its compressor calls
    them without ``interpret``)."""
    shim = types.SimpleNamespace(**{
        name: functools.partial(getattr(pallas_hsq4, name), interpret=True)
        for name in ("hsq_encode_flat", "hsq_decode_flat", "hsq_decode_mean")
    })
    monkeypatch.setattr(gqx_vq, "_hsq_kernels", lambda: shim)


def test_three_hsq_steps_match_gqx_runner(tmp_path, monkeypatch, interpret_kernels):
    """Both runners, 3 steps of FCN + HSQ (c_dim 16, K 256, n_bit 6,
    random=False) from gqx's initial parameters, which the test carries
    into the port through ``convert.from_jax``.  Parameters and momentum
    agree to 1e-5 relative (+1e-7): a subvector whose HSQ code or norm
    level differed would move its elements by a quantization step, so the
    codes and levels agree as well.  Both on the numpy augment."""
    _three_hsq_steps_match_gqx_runner(monkeypatch, "numpy")


def test_three_hsq_steps_match_gqx_runner_default_augment(tmp_path, monkeypatch,
                                                          interpret_kernels):
    """As above, both runners at their default augment (the native one)."""
    _three_hsq_steps_match_gqx_runner(monkeypatch, "default")


def _three_hsq_steps_match_gqx_runner(monkeypatch, augment):
    _augment(monkeypatch, augment)
    kw = dict(network="fcn", dataset="synthetic", quantizer="hsq", c_dim=16, k_bit=8,
              n_bit=6, num_users=2, batch_size=8, test_batch_size=64, seed=5, random=False,
              eval_batch_count=1, dataset_kwargs=dict(num_train=64, num_test=64,
                                                      image_shape=(16, 16, 3)))
    gcfg = GqxConfig(**kw)
    gcfg.use_pallas = True
    gmodel = gqx_create_model("fcn", 10)
    init, _, _ = gqx_create_state(gcfg, gmodel, jnp.zeros((8, 16, 16, 3), jnp.float32),
                                  jax.random.PRNGKey(5))
    init_params = jax.tree.map(np.asarray, init.params)

    def create_from_gqx(name, num_classes, dtype, generator, image_shape):
        model = create_model(name, num_classes, dtype, generator, image_shape=image_shape)
        model.load_state_dict(from_jax(model, init_params)[0])
        return model

    monkeypatch.setattr(port_runner, "create_model", create_from_gqx)
    gstate, _ = gqx_run_training(gcfg, epochs_override=1, max_steps=3, progress=False)
    state, _ = run_training(GQConfig(**kw), epochs_override=1, max_steps=3, progress=False,
                            device="cpu")
    assert state.step == int(gstate.step) == 3
    want, _ = from_jax(state.model, jax.tree.map(np.asarray, gstate.params))
    want_trace, _ = from_jax(state.model, jax.tree.map(np.asarray, gstate.opt_state.trace))
    start, _ = from_jax(state.model, init_params)
    for n, p in state.model.named_parameters():
        assert not torch.equal(p.detach(), start[n]), n
        torch.testing.assert_close(p.detach(), want[n], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(state.trace[n], want_trace[n], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,shape", [("fcn", (16, 16, 3)), ("fcn", (32, 32, 3)),
                                        ("resnet18", (28, 28, 1)), ("resnet18", (96, 96, 3))])
def test_models_sized_from_the_image_shape_match_gqx(name, shape):
    """The runner sizes the layers that gqx's modules size from their first
    input (the FCN's input, the ResNet stem and classifier) from the
    Pipeline's image shape: gqx's weights load into the port's model, and
    the eval-mode outputs agree to 1e-4 of their scale."""
    rng = np.random.default_rng(4)
    gmodel = gqx_create_model(name, 10)
    v = gmodel.init(jax.random.PRNGKey(1), jnp.zeros((2,) + shape), train=True)
    model = create_model(name, 10, image_shape=shape)
    sd, _ = from_jax(model, jax.tree.map(np.asarray, v["params"]),
                     jax.tree.map(np.asarray, v["batch_stats"]) if "batch_stats" in v else None)
    model.load_state_dict(sd)
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    want = np.asarray(gmodel.apply(v, jnp.asarray(x), train=False))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
