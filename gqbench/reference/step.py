"""Plain float32 training steps of the benchmark's cells: the yardstick that
decides ``correct``.

One step, as the published method runs it (the reference implementation's
``one_iter``): each user's loss and gradient on its own micro-batch (a loop
over the users), the users' gradients packed into compression units, each
user's unit compressed and the server's mean of the decompressed units, then
SGD with momentum and weight decay, and the model's running statistics
moved by the users' batch statistics, as its family moves them.

Compression, from the method's description and not from the measured
program's code:
  - units: leaves of at most ``passthrough`` elements travel uncompressed
    in one unit; the others that split into subvectors of ``c_dim`` form one
    unit, leaves concatenated in path order, each flattened in the order
    its family gives (``unit_dims``: conv kernels as (cout, kh, kw, cin),
    every other leaf row-major), an HSQ unit zero-padded to a multiple of 65,536
    elements; each leaf, and the pad, is a segment of the norm quantizer;
  - HSQ: per subvector the codeword of largest |<x, c>| and u = <x, c>;
    PVQ: p = x @ pinv(C^T)^T, a code drawn with probability |p_j| / |p|_1
    (the first j whose running sum reaches r - 1e-5) and u = sign(p_j)
    |p|_1;
  - the norm quantizer: per segment and user, l = floor of (u - min) /
    (max - min) * 2^n_bit clamped to 2^n_bit - 1, plus one where the
    fraction exceeds a uniform; u' = l (max - min) / 2^n_bit + min;
  - every uniform comes from ``philox.uniform`` under a seed drawn from
    the step's host generator: per unit, PVQ's samples first, then the
    norm quantizer's.
The codebook is the shipped file's, rows scaled to unit length.

Everything runs in float32 (or the ``dtype`` asked for) with TF32 off.
``quant`` (the control) rounds the model's products as its family's
``user_loss`` says; ``half`` (a planted fault) trains each user on the first half of its
micro-batch.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from gqbench.families.images import Data
from gqbench.reference import model as ref_model
from gqbench.reference import philox

HSQ_ALIGN = 65536
ROWS = 1 << 20   # subvectors per block of the encodes


def subvector_dim(size: int, c_dim: int, max_tries: int = 10) -> int:
    """The method's bucket rule: dim = dim // 2 * 3 until it divides size."""
    if c_dim == 0 or size < c_dim:
        return size
    dim = c_dim
    for _ in range(max_tries):
        if size % dim != 0:
            dim = dim // 2 * 3
    if size % dim != 0:
        raise ValueError(f"not divisible: size {size} c_dim {c_dim} dim {dim}")
    return dim


def read_codebook(root: str, dim: int, k: int) -> np.ndarray:
    """The (k, dim) ``angular_dim_{dim}_Ks_{k}.fvecs`` of the shipped
    codebooks, rows scaled to unit length."""
    path = os.path.join(root, "codebooks", "learned_codebook",
                        f"angular_dim_{dim}_Ks_{k}.fvecs")
    raw = np.fromfile(path, dtype=np.int32)
    d = int(raw[0])
    rows = raw.reshape(-1, d + 1)[:, 1:].view(np.float32).astype(np.float64)
    if rows.shape != (k, dim):
        raise ValueError(f"{path}: {rows.shape}, not {(k, dim)}")
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows.astype(np.float32)


def plan(spec, traffic) -> List[dict]:
    """The compression units: dicts with ``kind`` ("identity", "hsq" or
    "pvq"), ``paths``, ``sizes``, ``pad``, ``dim`` and ``segments``."""
    q = traffic["quantizer"]
    specs = ref_model.leaves(spec)
    thr = traffic["passthrough"]
    small = [(p, math.prod(s)) for p, s, _ in specs if math.prod(s) <= thr]
    big = [(p, math.prod(s)) for p, s, _ in specs if math.prod(s) > thr]
    c_dim = traffic["c_dim"]
    aligned = [(p, n) for p, n in big if n % c_dim == 0]
    ragged = [(p, n) for p, n in big if n % c_dim]
    units = []

    def unit(members, pad_to):
        total = sum(n for _, n in members)
        dim = subvector_dim(total, c_dim)
        pad = (-total) % pad_to if pad_to and pad_to % dim == 0 else 0
        segments = [n // dim for _, n in members] + ([pad // dim] if pad else [])
        return dict(kind=q, paths=[p for p, _ in members], sizes=[n for _, n in members],
                    pad=pad, dim=dim, segments=segments)

    if aligned:
        units.append(unit(aligned, HSQ_ALIGN if q == "hsq" else 0))
    units += [unit([m], 0) for m in ragged]
    if small:
        units.append(dict(kind="identity", paths=[p for p, _ in small],
                          sizes=[n for _, n in small], pad=0, dim=0, segments=[]))
    return units


def _flat(leaf: torch.Tensor, users: int, dims=None) -> torch.Tensor:
    """(U, *shape) -> (U, n), the leaf's axes in the order ``dims`` (None:
    row-major)."""
    if dims is not None:
        leaf = leaf.permute(0, *(d + 1 for d in dims))
    return leaf.reshape(users, -1)


def _unflat(vec: torch.Tensor, shape, dims=None) -> torch.Tensor:
    """(n,) -> ``shape``, undoing ``_flat``."""
    if dims is None:
        return vec.reshape(shape)
    inverse = sorted(range(len(dims)), key=lambda d: dims[d])
    return vec.reshape([shape[d] for d in dims]).permute(inverse).contiguous()


def quantize_norms(u: torch.Tensor, segments, n_bit: int, r: torch.Tensor) -> torch.Tensor:
    """u (U, M) -> u' (U, M) by the min/max stochastic quantizer per segment."""
    s = float(2 ** n_bit)
    out = torch.empty_like(u)
    start = 0
    for n in segments:
        seg = u[:, start:start + n]
        lo = seg.amin(1, keepdim=True)
        hi = seg.amax(1, keepdim=True)
        span = hi - lo
        zero = span == 0.0
        scaled = torch.where(zero, torch.zeros_like(seg),
                             torch.abs((seg - lo) / torch.where(zero, torch.ones_like(span), span)) * s)
        level = torch.clamp(scaled, 0, s - 1).floor()
        level = level + (scaled - level > r[:, start:start + n]).to(seg.dtype)
        out[:, start:start + n] = level * span / s + lo
        start += n
    return out


def _encode(rows: torch.Tensor, kind: str, cb: torch.Tensor, c_pinv_t: torch.Tensor,
            r: Optional[torch.Tensor]):
    """rows (N, dim) -> (u (N,), codes (N,)) by HSQ or PVQ."""
    n = rows.shape[0]
    u = torch.empty(n, dtype=rows.dtype, device=rows.device)
    codes = torch.empty(n, dtype=torch.int64, device=rows.device)
    k = cb.shape[0]
    for s in range(0, n, ROWS):
        x = rows[s:s + ROWS]
        if kind == "hsq":
            p = x @ cb.t()
            idx = p.abs().argmax(1)
            u[s:s + ROWS] = p.gather(1, idx[:, None])[:, 0]
        else:
            p = x @ c_pinv_t
            a = p.abs()
            l1 = a.sum(1)
            prob = a / torch.where(l1 == 0.0, torch.ones_like(l1), l1)[:, None]
            cdf = torch.cumsum(prob, dim=1)
            idx = (cdf < (r[s:s + ROWS, None] - 1e-5)).sum(1).clamp(0, k - 1)
            u[s:s + ROWS] = torch.sign(p.gather(1, idx[:, None])[:, 0]) * l1
        codes[s:s + ROWS] = idx
    return u, codes


def aggregate(units, grads: Dict[str, torch.Tensor], users: int, traffic,
              generator: torch.Generator, cb: torch.Tensor,
              dims: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """The server's mean of the users' decompressed units, per leaf (each
    flattened by ``dims``, the family's ``unit_dims``)."""
    device = cb.device
    c_pinv_t = torch.from_numpy(np.linalg.pinv(cb.double().cpu().numpy().T)).to(
        device, cb.dtype).t()
    out = {}
    for unit in units:
        parts = [_flat(grads[p], users, dims.get(p)) for p in unit["paths"]]
        if unit["kind"] == "identity":
            mean = torch.cat(parts, dim=1).mean(0)
        else:
            if unit["pad"]:
                parts.append(torch.zeros(users, unit["pad"], dtype=cb.dtype, device=device))
            vec = torch.cat(parts, dim=1)
            dim = unit["dim"]
            m = vec.shape[1] // dim
            r = None
            if unit["kind"] == "pvq":
                r = philox.uniform(philox.draw_seed(generator), (users * m,), device)
            u, codes = _encode(vec.reshape(users * m, dim), unit["kind"], cb, c_pinv_t, r)
            del vec
            r_norm = philox.uniform(philox.draw_seed(generator), (users, m), device)
            uq = quantize_norms(u.reshape(users, m), unit["segments"], traffic["n_bit"], r_norm)
            codes = codes.reshape(users, m)
            acc = torch.zeros(m, dim, dtype=cb.dtype, device=device)
            for a in range(users):
                acc += cb[codes[a]] * uq[a][:, None]
            mean = (acc / users).reshape(-1)
        offset = 0
        for p, n in zip(unit["paths"], unit["sizes"]):
            out[p] = mean[offset:offset + n]
            offset += n
    return out


def user_grads(spec, params, x, y, quant=None):
    """Per-user losses (U,), gradients {path: (U, *shape)} and the batch
    values of the running statistics {key: tensors (U, ...)} by a loop over
    users."""
    users = x.shape[0]
    paths = list(params)
    leaves = [params[p] for p in paths]
    grads = {p: torch.empty((users,) + tuple(params[p].shape), dtype=params[p].dtype,
                            device=params[p].device)
             for p in paths}
    values = {}
    losses = []
    for a in range(users):
        rec = ref_model.Recorder()
        loss = ref_model.user_loss(spec, params, x[a], y[a], rec, quant)
        for p, g in zip(paths, torch.autograd.grad(loss, leaves)):
            grads[p][a] = g
        for k, v in rec.stats.items():
            values.setdefault(k, []).append(v)
        losses.append(loss.detach())
    stats = {k: tuple(torch.stack(u) for u in zip(*v)) for k, v in values.items()}
    return torch.stack(losses), grads, stats


def training_data(spec, data, seed: int):
    """The cell's training set: the family's ``Data`` where it has one, else
    the shared synthetic images."""
    return getattr(ref_model.family(spec), "Data", Data)(data, seed)


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def run(spec, traffic, seed: int, data, root: str, device, steps: int = 3,
        quant=None, half: bool = False, dtype: torch.dtype = torch.float32) -> dict:
    """``steps`` reference steps from the seed's weights and data.  Returns
    the readings the check compares: ``losses`` (per step), ``grad`` (norm
    per leaf of the first step's aggregated gradient, as the optimizer gets
    it), ``change`` (norm per leaf of the parameters' change over the
    steps) and ``bn_stats`` (norm per running statistic of its change; none
    where the model keeps none).  ``data`` is ``training_data``'s.
    ``dtype`` float64 (a witness of float32's own rounding) computes every
    tensor in it from the same float32 weights, data, codebook and draws."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        users, batch = traffic["num_users"], traffic["batch_size"]
        params = {p: t.to(dtype, copy=True).requires_grad_(True)
                  for p, t in ref_model.init_weights(spec, seed, device).items()}
        start = {p: t.detach().clone() for p, t in params.items()}
        trace = {p: torch.zeros_like(t) for p, t in params.items()}
        fam = ref_model.family(spec)
        running = {k: torch.full(shape, value, dtype=dtype, device=device)
                   for k, (shape, value) in fam.running_stats(spec).items()}
        running0 = {k: v.clone() for k, v in running.items()}
        units = plan(spec, traffic)
        dims = fam.unit_dims(spec)
        cb = torch.from_numpy(read_codebook(root, traffic["c_dim"],
                                            2 ** traffic["k_bit"])).to(device, dtype)
        generator = torch.Generator().manual_seed(int(seed))
        lr, wd, mom = traffic["lr"], traffic["weight_decay"], traffic["momentum"]
        losses, first = [], None
        for step in range(steps):
            x, y = data.batch(step, users, batch, device)
            if x.is_floating_point():
                x = x.to(dtype)
            if half:
                x, y = x[:, :batch // 2], y[:, :batch // 2]
            loss_u, grads, stats = user_grads(spec, params, x, y, quant)
            losses.append(float(loss_u.mean()))
            agg = aggregate(units, grads, users, traffic, generator, cb, dims)
            del grads
            with torch.no_grad():
                agg = {p: _unflat(agg[p], params[p].shape, dims.get(p)) for p in params}
                if first is None:
                    first = norms(agg)
                for p, t in params.items():
                    trace[p] = agg[p] + wd * t + mom * trace[p]
                    t.sub_(lr * trace[p])
                fam.update_running(spec, running, stats)
        change = norms({p: params[p].detach() - start[p] for p in params})
        bn = norms({k: running[k] - running0[k] for k in running})
        return dict(losses=losses, grad=first, change=change, bn_stats=bn)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def fp8_quant():
    """The control's rounding: operands to float8 e4m3 and the gradients
    flowing back into them to e5m2, each tensor scaled by its largest
    magnitude first (per-tensor scaling, as fp8 training does)."""

    def rnd(t, dtype, top):
        amax = t.detach().abs().amax().clamp_min(1e-30)
        scale = top / amax
        return (t * scale).to(dtype).to(torch.float32) / scale

    class _Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return rnd(t, torch.float8_e4m3fn, 448.0)

        @staticmethod
        def backward(ctx, g):
            return rnd(g, torch.float8_e5m2, 57344.0)

    return _Round.apply
