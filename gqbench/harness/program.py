"""The system under test, driven as its training loop drives it.

``Session`` builds what ``gqx_torch.runner.run_training`` builds for a
configuration and a traffic mix (the data pipeline with its native augment,
the model, the training state and the step of ``make_train_step``; the
model, its leaves' paths and its running statistics by the program half of
the configuration's model family, ``family_program``), puts
the benchmark's weights into it, and runs steps in the loop's order: the
pipeline's next global batch, ``runner.to_device``, the step.  Evals, logs
and checkpoints are left out.

On a card ``to_device`` runs on a stream of its own, which the compute
stream waits for on the device.  Its pageable copy then waits for that
copy alone, not for the steps queued on the compute stream, so the host
dispatches the next step while the card still runs the last one: a host
that stands still for less than the queued work no longer leaves the card
idle.  How far ahead the host gets is bounded by the driver's launch queue.

The weights are drawn from the seed on the device by the benchmark
(``reference.model.init_weights``), so the program and the reference start
from the same values.  The step's host generator is seeded with the seed.

On several ranks (a mix with ``backend: mesh``) every rank builds the same
session on its own device, draws the same global batch and steps on its own
users' rows, as the program's runner does.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List

import torch
from torch.autograd.profiler import record_function

from gqbench.harness import manifest
from gqbench.reference import model as ref_model

#: the benchmark's ranges round the program's calls into each layer, as
#: (module, attribute, range), in a traced run; a traced run stops where the
#: program no longer has one of them, so that a renamed call cannot take its
#: layer out of the metrics' sight (add the new name here instead).  The
#: mesh step takes ``folded_user_grads`` and ``fused_sgd_update`` from
#: ``gqx_torch.train`` when it is made, so their ranges hold there too.
SPANS = (
    ("gqx_torch.train", "folded_user_grads", "gqbench::fwd_bwd"),
    ("gqx_torch.parallel.aggregate", "ps_aggregate", "gqbench::aggregate"),
    ("gqx_torch.train", "fused_sgd_update", "gqbench::sgd_update"),
    ("gqx_torch.train", "update_running_stats", "gqbench::bn_stats"),
    ("gqx_torch.parallel.collectives", "_ps_unit_logical", "gqbench::aggregate"),
    ("gqx_torch.parallel.collectives", "_ps_unit_packed", "gqbench::aggregate"),
    ("gqx_torch.parallel.collectives", "update_running_stats", "gqbench::bn_stats"),
)
DATA_SPAN = "gqbench::data"
COPY_SPAN = "gqbench::copy"
STEP_SPAN = "gqbench::step"


def family_program(spec):
    """The program half of the configuration's model family."""
    return manifest.family(ref_model.family(spec).PROGRAM)


def gq_config(spec, traffic, seed: int):
    from gqx_torch.config import GQConfig

    return GQConfig(
        network=spec["network"], quantizer=traffic["quantizer"], mode=traffic["mode"],
        c_dim=traffic["c_dim"], k_bit=traffic["k_bit"], n_bit=traffic["n_bit"],
        random=traffic["random"],
        num_users=traffic["num_users"], batch_size=traffic["batch_size"], lr=traffic["lr"],
        momentum=traffic["momentum"], weight_decay=traffic["weight_decay"],
        ef=traffic["ef"], two_phase=traffic["two_phase"], seed=int(seed),
        backend=traffic["backend"], wire=traffic.get("wire", "logical"),
        compute_dtype=spec["compute_dtype"], passthrough_threshold=traffic["passthrough"],
        folded_users=traffic["folded_users"],
        **family_program(spec).config_fields(spec, traffic, seed))


class Session:
    """One training run of the program, from set-up to its last step."""

    def __init__(self, spec, traffic, seed: int, device: torch.device, rank: int = 0,
                 world: int = 1):
        from gqx_torch.data import Pipeline
        from gqx_torch.parallel.distributed import local_user_batch
        from gqx_torch.runner import to_device
        from gqx_torch.train import create_train_state, make_train_step

        self.parts: Dict[str, float] = {}
        t = time.perf_counter()
        self.config = gq_config(spec, traffic, seed)
        self.device = device
        self.lr, self.wd = traffic["lr"], traffic["weight_decay"]
        self.pipeline = Pipeline(self.config)
        self.parts["data"] = time.perf_counter() - t

        t = time.perf_counter()
        self.half = family_program(spec)
        model = self.half.build(spec, self.config, self.pipeline)
        self.state, self.plan = create_train_state(self.config, model, device=device)
        self.step_fn = make_train_step(self.config, self.plan)
        self.paths = self.half.leaf_paths(model)
        weights = ref_model.init_weights(spec, seed, device)
        params = dict(model.named_parameters())
        if sorted(self.paths.values()) != sorted(weights):
            raise ValueError("the program's leaves are not the configuration's: "
                             f"{sorted(set(self.paths.values()) ^ set(weights))[:6]}")
        with torch.no_grad():
            for n, p in params.items():
                if tuple(p.shape) != tuple(weights[self.paths[n]].shape):
                    raise ValueError(f"{n}: {tuple(p.shape)} in the program, "
                                     f"{tuple(weights[self.paths[n]].shape)} configured")
            torch._foreach_copy_([params[n] for n in params],
                                 [weights[self.paths[n]] for n in params])
        del weights
        self.generator = torch.Generator().manual_seed(int(seed))
        self._to_device = to_device
        self._local = (lambda a: a) if traffic["backend"] != "mesh" else \
            (lambda a: local_user_batch(a, rank, world))
        self.batches = self._epochs()
        self.data_s = self.copy_s = 0.0
        self.copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.parts["state"] = time.perf_counter() - t

    @property
    def model(self):
        return self.state.model

    def _epochs(self):
        for epoch in itertools.count(1):
            yield from self.pipeline.train_epoch(epoch)

    def step(self, spans: bool = False):
        """One step of the loop; returns the step's loss (a device scalar).
        The host time of the pipeline's next batch is added to ``data_s``,
        that of ``to_device`` to ``copy_s``."""
        t = time.perf_counter()
        with record_function(DATA_SPAN) if spans else contextlib.nullcontext():
            x, y = next(self.batches)
        t1 = time.perf_counter()
        with record_function(COPY_SPAN) if spans else contextlib.nullcontext():
            xt, yt = self._copy(self._local(x), self._local(y))
        t2 = time.perf_counter()
        self.data_s += t1 - t
        self.copy_s += t2 - t1
        return self.step_fn(self.state, xt, yt, self.lr, self.wd, self.generator, 1.0)

    def _copy(self, x, y):
        """``to_device`` on the copy stream; the compute stream waits for it
        on the device, and the batch's memory is not reused before the
        compute stream is done with it."""
        if self.copy_stream is None:
            return self._to_device(x, y, self.device)
        with torch.cuda.stream(self.copy_stream):
            xt, yt = self._to_device(x, y, self.device)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_stream(self.copy_stream)
        xt.record_stream(compute)
        yt.record_stream(compute)
        return xt, yt

    # -- the checked steps --------------------------------------------------
    def checked_steps(self, steps: int = 3) -> dict:
        """The first ``steps`` steps, with the readings the check compares:
        each step's loss, the norm per leaf of the first step's gradient as
        the optimizer got it (its momentum after one step less the weight
        decay, the momentum starting at zero), the norm per leaf of the
        parameters' change and per running statistic of its change."""
        model = self.model
        params = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        buffers = self.half.running_buffers(model, self.paths)
        start_buf = {k: b.detach().clone() for k, b in buffers.items()}
        losses, grad = [], None
        for i in range(steps):
            losses.append(self.step())
            if i == 0:
                grad = {self.paths[n]: _norm(self.state.trace[n] - self.wd * start[n])
                        for n in params}
        change = {self.paths[n]: _norm(p.detach() - start[n]) for n, p in params.items()}
        bn = {k: _norm(b - start_buf[k]) for k, b in buffers.items()}
        return dict(losses=[float(v) for v in losses], grad=grad, change=change, bn_stats=bn)

    # -- the measured window ------------------------------------------------
    def window(self, seconds: float = None, steps: int = None) -> dict:
        """Steps for ``seconds`` of host time (or exactly ``steps``), with no
        synchronise of the benchmark's own: an event is recorded on the
        stream after each step and read when the window has closed, and so
        is each loss.  When the time is up nothing more is sent, and every
        step sent counts, over the device time to its end."""
        cuda = self.device.type == "cuda"
        start = _event(cuda)
        ends, losses = [], []
        self.data_s = self.copy_s = 0.0
        t0 = time.perf_counter()
        while (steps is None and time.perf_counter() - t0 < seconds) or \
                (steps is not None and len(ends) < steps):
            losses.append(self.step())
            ends.append(_event(cuda))
        host_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize(self.device)
            marks = [start] + ends
            step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        else:
            step_ms = [1e3 * host_s / len(ends)] * len(ends)
        loss_values = torch.stack(losses).float().cpu().tolist()
        return dict(steps=len(ends), step_ms=step_ms, losses=loss_values,
                    data_ms=1e3 * self.data_s / len(ends),
                    copy_ms=1e3 * self.copy_s / len(ends))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _event(cuda: bool):
    if not cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@contextlib.contextmanager
def layer_spans():
    """The benchmark's ranges round the program's layer calls (``SPANS``),
    removed on exit.  Entered before the session is built, since a step
    may take the functions it calls when it is made.  Raises where the
    program lacks a module or a call of ``SPANS``."""
    import importlib

    found = [(importlib.import_module(module), attr, name) for module, attr, name in SPANS]
    for mod, attr, name in found:
        if getattr(mod, attr, None) is None:
            raise LookupError(f"the program has no {mod.__name__}.{attr}, which the range "
                              f"{name} wraps: the metrics reading the range would read nothing")
    restore: List = []
    for mod, attr, name in found:
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                return _fn(*a, **k)

        setattr(mod, attr, wrapped)
        restore.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in reversed(restore):
            setattr(mod, attr, fn)


@contextlib.contextmanager
def bn_ranges(model):
    """A range round every batch norm's forward, removed on exit."""
    from gqbench.harness.families import BN_FORWARD

    handles = _bn_ranges(model, BN_FORWARD)
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _bn_ranges(model, name: str):
    """Hooks that open a range named ``name`` before each batch norm's
    forward and close it after."""
    try:
        from gqx_torch.models.common import BatchNorm
    except ImportError:
        return []
    open_ranges = {}

    def enter(mod, args):
        open_ranges[id(mod)] = record_function(name).__enter__()

    def leave(mod, args, out):
        open_ranges.pop(id(mod)).__exit__(None, None, None)

    handles = []
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            handles += [mod.register_forward_pre_hook(enter), mod.register_forward_hook(leave)]
    return handles
