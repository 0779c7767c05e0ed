"""Quantized gradient aggregation: parameter-server and chain-ring topologies
(counterpart of ``gqx/parallel/aggregate.py``).

  - PS (reference quantizers/ps_quantizer.py:27-65): every user adds its
    error-feedback (EF) error, scaled by the warm-up schedule, compresses and
    decompresses its gradient and keeps the new error; the server means the
    decompressed gradients; with two-phase the mean is recompressed for the
    downlink, with a server-side error of its own when EF is on.  Without EF
    no per-user decompressed value is needed, so the compressor's (fused)
    ``decode_mean`` does the server reduce.
  - Ring (reference quantizers/ring_quantizer.py:25-47): a chain.  User i > 0
    first adds the previous user's decompressed partial sum, then (EF +)
    compresses and decompresses.  The result is the last hop's value: a
    quantized **sum** over the users, not a mean.

Gradients are packed into a few flat units (``gqx_torch.parallel.packing``)
and each unit is aggregated as a whole: the PS path in one batched encode
and decode over the users, the ring in U sequential single-vector hops.

State (``AggState``): one (num_users, unit_size) float32 error per unit,
the identity unit included, when EF is on; one (unit_size,) server error per
unit when EF and two-phase are both on.  The aggregators update it **in
place** (gqx returns a new state): a ResNet-50 unit's error is 753 MB for 8
users.

Draw order from the ``torch.Generator``, the same on the CPU and the card:
units in plan order; per unit one seed for the users' batch (PS) or one per
hop in hop order (ring), then one for the server's recompression.  gqx
splits a key per unit and user instead, so with ``random=True`` parity with
gqx is distributional; with ``random=False`` nothing is drawn.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from gqx_torch.parallel.packing import UnitPlan
from gqx_torch.utils.profiling import span


@dataclasses.dataclass
class AggState:
    """Aggregator state across training steps (per-unit lists)."""

    ef: Optional[List[torch.Tensor]] = None          # [(num_users, unit_size)]
    server_ef: Optional[List[torch.Tensor]] = None   # [(unit_size,)]


def init_state(plan: UnitPlan, num_users: int, ef: bool, two_phase: bool,
               device="cpu") -> AggState:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return AggState(
        ef=[zeros(num_users, u.size) for u in plan.units] if ef else None,
        server_ef=[zeros(u.size) for u in plan.units] if (ef and two_phase) else None,
    )


def ps_aggregate(plan: UnitPlan, grads: Dict[str, torch.Tensor], state: AggState,
                 scale: float, generator: Optional[torch.Generator], *,
                 two_phase: bool = False) -> Dict[str, torch.Tensor]:
    """Parameter-server aggregation over a stacked users axis.

    ``grads`` maps each leaf name to (num_users, *leaf_shape).  Returns
    {name: aggregated leaf}; ``state`` is updated in place."""
    with span("gqx_torch::aggregate"):
        with span("gqx_torch::aggregate.pack"):
            units = plan.pack(grads)
        out = []
        for ui, (unit, g) in enumerate(zip(plan.units, units)):
            comp = unit.compressor
            e = state.ef[ui] if state.ef is not None else None
            with span("gqx_torch::aggregate.encode"):
                g_enc = e.mul_(scale).add_(g) if e is not None else g   # g + scale * e
                sig = comp.compress_batch(g_enc, generator)
            with span("gqx_torch::aggregate.decode"):
                if e is None:
                    mean = comp.decode_mean(sig)
                else:
                    dec = comp.decompress_batch(sig)
                    # the plain mean of the users' decoded values: the fused
                    # decode-mean rounds its weights after summing and is not this
                    mean = comp.users_mean(dec)
                    e.sub_(dec)                               # the new error

            if two_phase:
                # downlink recompression of the mean (reference ps_quantizer.py:52-61)
                mean = two_phase_roundtrip(comp, mean, state.server_ef, ui, generator)
            out.append(mean)
        return plan.unpack(out)


def two_phase_roundtrip(comp, mean: torch.Tensor, server_ef: Optional[List[torch.Tensor]],
                        ui: int, generator) -> torch.Tensor:
    """The downlink's round trip of unit ``ui``'s mean, with the server's
    error feedback where ``server_ef`` holds it (updated in place)."""
    with span("gqx_torch::aggregate.encode"):
        if server_ef is not None:
            mean = mean + server_ef[ui]
        sig = comp.compress(mean, generator)
    with span("gqx_torch::aggregate.decode"):
        dec = comp.decompress(sig)
        if server_ef is not None:
            server_ef[ui] = mean - dec
    return dec


def ring_aggregate(plan: UnitPlan, grads: Dict[str, torch.Tensor], state: AggState,
                   scale: float, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """Chain-ring aggregation over a stacked users axis.

    The hop order is user 0, 1, ..., U-1; each hop compresses the running
    partial sum, so quantization noise enters at every hop (reference
    ring_quantizer.py:31-43); hop 0 has no carry to add.  EF is per hop.
    Returns the last hop's decompressed value; ``state`` is updated in place.

    With bf16 units (bf16 compute, ``hsq_passes=1``, no EF) hop 0 encodes the
    bf16 gradient as it is and every later hop adds the float32 carry to the
    bf16 gradient in float32.  gqx's ``lax.scan`` refuses that plan (its
    carry would change type) and needs ``unit_dtype="float32"`` there."""
    with span("gqx_torch::aggregate"):
        with span("gqx_torch::aggregate.pack"):
            units = plan.pack(grads)
        out = []
        for ui, (unit, g) in enumerate(zip(plan.units, units)):
            comp = unit.compressor
            carry = None
            for i in range(g.shape[0]):
                e = None if state.ef is None else state.ef[ui][i]
                with span("gqx_torch::aggregate.encode"):
                    acc = g[i] if carry is None else g[i] + carry
                    if e is not None:
                        acc = acc + scale * e
                    sig = comp.compress(acc, generator)
                with span("gqx_torch::aggregate.decode"):
                    carry = comp.decompress(sig)
                    if e is not None:
                        torch.sub(acc, carry, out=e)      # the new error
            out.append(carry)
        return plan.unpack(out)


def make_aggregator(config, plan: UnitPlan) -> Callable:
    """aggregate(grads, state, scale, generator) for config.mode."""
    if config.mode == "ps":
        two_phase = bool(config.two_phase)
        return lambda grads, state, scale, generator: ps_aggregate(
            plan, grads, state, scale, generator, two_phase=two_phase)
    if config.mode == "ring":
        return lambda grads, state, scale, generator: ring_aggregate(
            plan, grads, state, scale, generator)
    raise ValueError(f"unknown mode {config.mode!r}")
