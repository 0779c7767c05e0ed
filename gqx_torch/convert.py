"""Carry gqx's weights into the port.

``leaf_paths(model)`` names, for every parameter and BN buffer of a port
model, the flattened path of the same leaf in gqx's flax trees
(``"Bottleneck_3/TorchConv_1/Conv_0/kernel"``); ``plan_units`` orders leaves
by it, so the port's compression units are gqx's.  ``from_jax`` converts
gqx's ``params`` and ``batch_stats`` (nested dicts of numpy arrays) into the
port's ``state_dict``:

  conv kernel  HWIO (kh, kw, cin, cout) -> OIHW (cout, cin, kh, kw)
  conv bias    (cout,)                  -> (cout,), where the conv has one
  dense kernel (in, out)                -> (out, in)
  BN scale / bias / mean / var          -> weight / bias / running_mean / running_var
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from gqx_torch.models.common import BatchNorm, Conv2d, Dense

_LEAF = {
    Conv2d: {"weight": "kernel", "bias": "bias"},
    Dense: {"weight": "kernel", "bias": "bias"},
    BatchNorm: {"weight": "scale", "bias": "bias",
                "running_mean": "mean", "running_var": "var"},
}


def _walk(model: nn.Module):
    """(port name, gqx path, module, attribute) for every converted leaf."""
    prefixes: Dict[str, str] = {"": ""}
    for name, mod in model.named_modules():
        if name:
            parent = name.rsplit(".", 1)[0] if "." in name else ""
            seg = getattr(mod, "flax_path", "")
            base = prefixes[parent]
            prefixes[name] = f"{base}/{seg}" if base and seg else (base or seg)
        for attr, leaf in _LEAF.get(type(mod), {}).items():
            if getattr(mod, attr) is None:     # a conv without a bias
                continue
            full = f"{name}.{attr}" if name else attr
            yield full, f"{prefixes[name]}/{leaf}", mod, attr


def leaf_paths(model: nn.Module) -> Dict[str, str]:
    """{port parameter name: gqx params path} for every trainable leaf."""
    return {name: path for name, path, mod, attr in _walk(model)
            if isinstance(getattr(mod, attr), nn.Parameter)}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def _to_port(value: np.ndarray, mod: nn.Module, attr: str) -> torch.Tensor:
    a = np.asarray(value, dtype=np.float32)
    if attr == "weight" and isinstance(mod, Conv2d):
        a = a.transpose(3, 2, 0, 1)
    elif attr == "weight" and isinstance(mod, Dense):
        a = a.T
    return torch.from_numpy(np.array(a, order="C", copy=True))


def from_jax(model: nn.Module, params: Mapping, batch_stats: Mapping = None
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """gqx's flax ``params``/``batch_stats`` (numpy leaves) -> (the port's
    state_dict for ``model``, {port parameter name: gqx path}).  Without
    ``batch_stats`` only the parameters are converted."""
    p_flat = _flatten(params)
    s_flat = _flatten(batch_stats or {})
    state: Dict[str, torch.Tensor] = {}
    used = set()
    for name, path, mod, attr in _walk(model):
        if attr.startswith("running_") and batch_stats is None:
            continue
        src = s_flat if attr.startswith("running_") else p_flat
        if path not in src:
            raise KeyError(f"gqx tree has no leaf {path} for {name}")
        state[name] = _to_port(src[path], mod, attr)
        used.add(("s" if src is s_flat else "p", path))
    unused = ({("p", p) for p in p_flat} | {("s", s) for s in s_flat}) - used
    if unused:
        raise KeyError(f"gqx leaves with no port counterpart: {sorted(unused)[:5]}")
    return state, leaf_paths(model)
