"""Parameter-server aggregation (counterpart of ``gqx/parallel/aggregate.py``).

PS (reference quantizers/ps_quantizer.py:27-65): every user compresses its
gradient, the server means the decompressed gradients.  This slice ports
the path without error feedback and without two-phase downlink
recompression: per unit, one batched encode over the users and the fused
decode-mean.  Error feedback, two-phase and the ring need the per-user
decode kernel (K4) and raise until it is ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gqx_torch.parallel.packing import UnitPlan


def _needs_k4(what: str):
    return NotImplementedError(
        f"{what} needs the per-user HSQ decode kernel (hsq_decode_flat), "
        "which is not ported yet (ROADMAP Queue 2, K4)")


def init_state(plan: UnitPlan, num_users: int, ef: bool, two_phase: bool) -> None:
    """The aggregator's state across steps.  Without error feedback and
    two-phase recompression, the only path ported, there is none."""
    if ef or two_phase:
        raise _needs_k4("error feedback / two-phase aggregation")
    return None


def ps_aggregate(plan: UnitPlan, grads: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """PS aggregation over a stacked users axis.

    ``grads`` maps each leaf name to (num_users, *leaf_shape).  Returns
    {name: aggregated leaf}."""
    units = plan.pack(grads)
    out = []
    for u, g in zip(plan.units, units):
        sig = u.compressor.compress_batch(g, generator)
        out.append(u.compressor.decode_mean(sig))
    return plan.unpack(out)


def make_aggregator(config, plan: UnitPlan):
    """aggregate(grads, generator) for config.mode."""
    if config.mode != "ps":
        raise _needs_k4("ring aggregation")
    return lambda grads, generator: ps_aggregate(plan, grads, generator)
