"""Faults planted in the measured program: module-level, so that a rank
started as a fresh process can take them too.  A tests' traffic mix names
one under ``plant`` ("gqbench.tests.plants.<fault>"); ``controls.py``
plants them at a cell's own size on the chip."""

import importlib

_saved = []


def _swap(module: str, attr: str, make) -> None:
    mod = importlib.import_module(module)
    if hasattr(mod, attr):
        _saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, make(getattr(mod, attr)))


def restore() -> None:
    """Undo every fault planted in this process, last first."""
    while _saved:
        mod, attr, fn = _saved.pop()
        setattr(mod, attr, fn)


def unchanged() -> None:
    """Every step returns the state as it found it: no update of the
    parameters, the momentum or the running statistics."""
    from gqx_torch.models.common import clear_batch_stats

    for module in ("gqx_torch.train", "gqx_torch.parallel.collectives"):
        _swap(module, "fused_sgd_update", lambda fn: (lambda *a, **k: None))
        _swap(module, "update_running_stats", lambda fn: clear_batch_stats)


def half_batch() -> None:
    """Each user's gradient from the first half of its micro-batch: the
    mean taken over the rest."""

    def make(fn):
        def grads(model, plan, names, x, y):
            half = x.shape[1] // 2
            return fn(model, plan, names, x[:, :half], y[:, :half])
        return grads

    for module in ("gqx_torch.train", "gqx_torch.parallel.collectives"):
        _swap(module, "folded_user_grads", make)


def no_exchange() -> None:
    """The gather between ranks left out: each rank receives its own rows in
    every rank's place."""

    def make(fn):
        def gather(out, rows):
            view = out.view((-1,) + tuple(rows.shape))
            view.copy_(rows.unsqueeze(0).expand_as(view))
        return gather

    _swap("gqx_torch.parallel.collectives", "_all_gather", make)


def _scaled_dw(factor: float) -> None:
    def make(fn):
        def dw(*a, **k):
            return fn(*a, **k) * factor
        return dw

    _swap("gqx_torch.models.folded", "per_user_dw", make)


def k7_scaled() -> None:
    """The per-user weight gradient of the stride-1 convolutions (the
    program's own kernel, K7) comes out a tenth short."""
    _scaled_dw(0.9)


def k7_zero() -> None:
    """The per-user weight gradient of the stride-1 convolutions comes out
    zero."""
    _scaled_dw(0.0)
