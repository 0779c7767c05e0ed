"""Quantized collectives over the users of several processes (counterpart
of ``gqx/parallel/collectives.py``) on ``torch.distributed``.

Layout (``gqx_torch.parallel.distributed``): W ranks, one device each; rank
r owns users ``[r*U/W, (r+1)*U/W)``, and W must divide U (gqx silently
drops devices until it does; a rank cannot be dropped, so the port
raises).  Parameters, momentum, BN running statistics and the server-side
error feedback (EF) are replicated; a user's EF lives on the rank that owns
the user.  Each rank runs the per-user gradients of its own users
(``train.folded_user_grads``), then per compression unit:

  - PS, wire "logical": the local users' encode and fused decode-mean (with
    EF: their round trip and ``users_mean``), then one ``all_reduce`` of the
    local means (a sum, divided by W).
  - PS, wire "packed": the local users' encode; each user's signature
    packed (``ops/wire.py``) into one int32 row of ``wire_bytes / 4``
    words; ONE ``all_gather`` of the rows per unit; every rank unpacks all
    U users and decodes their mean (with EF: their per-user decode, as the
    sim step means it, and each local user's new error from it).  The port
    ships only the m-order wire, so what moves is exactly ``wire_bytes``
    per user (gqx's TPU path ships its transposed wire, ADVICE.md).
  - Chain ring: rank r receives the float32 carry from rank r - 1, runs its
    users' hops in order and sends the carry on; the last rank's value is
    broadcast.  gqx's masked ``ppermute`` loop does O(D) work per device;
    point to point gives the same values with O(1) (``_ring_unit``).
  - Segmented ring: a lossless local sum, W - 1 reduce-scatter hops that
    each send an encoded, packed chunk (paired ``isend`` / ``irecv``), then
    an ``all_gather`` of the packed final segments and gqx's reorder.  EF
    holds one (1, W, chunk) slot per send.
  - Two-phase: replicated; every rank makes the same server draws.
  - BN batch statistics and the losses: one flat ``all_gather``, so every
    rank takes the sim step's means over all users (``_pmean_tree``).

Draws (the sim step's order, ``gqx_torch.parallel.aggregate``): every rank
holds the sim's generator, seeded alike, and makes the same ``draw_seed``
calls in the same order.  A draw over the users' batch takes the rank's
rows at their place in the counter stream (``compress.api.UserRows``,
``batch_uniform``), so distinct users get distinct uniforms and PS and the
chain ring give the sim step's values: bit for bit where the reduction
order is the same (packed PS, the chain ring), to float32 order for logical
PS's ``all_reduce``.  A chain-ring rank skips the seeds of the hops other
ranks make (``Compressor.seed_draws`` each).  The segmented ring is another
algorithm: per unit every rank draws one seed ``s``, and the hop h of rank
d compresses with a generator seeded ``mix(s, d * W + h)``, the same table
on every rank.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from gqx_torch.compress import IdenticalCompressor, make_compressor
from gqx_torch.compress.api import UserRows, draw_seed
from gqx_torch.config import resolve_schedule
from gqx_torch.models.common import BatchNorm, clear_batch_stats, update_running_stats
from gqx_torch.ops.wire import pack_signature, unpack_signature, wire_bytes
from gqx_torch.parallel.aggregate import AggState, two_phase_roundtrip
from gqx_torch.parallel.distributed import (check_backend, process_user_range,
                                            rank_and_world)
from gqx_torch.parallel.packing import UnitPlan
from gqx_torch.utils.profiling import span

# torch 2.13 renamed all_gather_into_tensor (it now warns)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

#: a row layout: (field, words) in pack order
Layout = List[Tuple[str, int]]


def warn_chain_ring_scale(config, n_devices: Optional[int] = None) -> bool:
    """Warn when the chain ring is about to run on more than 8 ranks: the
    chain is latency-bound (D sequential full-unit hops are the algorithm,
    reference ring_quantizer.py:25-47); gqx measured it 32x slower than the
    segmented ring at 32 devices (results/mesh_bench_cpu_32dev.json).
    ``n_devices`` defaults to the world size.  Returns True if it warned."""
    if config.mode != "ring" or config.ring_mode != "chain":
        return False
    if n_devices is None:
        n_devices = rank_and_world()[1]
    if n_devices <= 8:
        return False
    warnings.warn(
        f"--mode ring --ring-mode chain on {n_devices} ranks: the chain is latency-bound "
        "(reference-parity mode; 32x slower than segmented at 32 devices in gqx, "
        "results/mesh_bench_cpu_32dev.json). Use --ring-mode segmented for real runs.",
        stacklevel=2)
    return True


def make_user_mesh(num_users: int) -> Tuple[int, int]:
    """(world size, local users per rank).  Raises ``ValueError`` where the
    world size does not divide ``num_users`` (gqx drops devices instead)."""
    rank, world = rank_and_world()
    start, stop = process_user_range(num_users, rank, world)
    return world, stop - start


def segment_chunk_size(unit_size: int, n_dev: int, align: int) -> int:
    """Per-rank segment size: ceil(unit / W) rounded up to the compressor's
    subvector alignment."""
    base = -(-unit_size // n_dev)
    return -(-base // align) * align


def segment_chunks(plan: UnitPlan, world: int) -> List[int]:
    """The segmented ring's chunk size of each unit."""
    return [segment_chunk_size(u.size, world, max(int(getattr(u.compressor, "dim", 1)), 1))
            for u in plan.units]


def segment_compressors(config, plan: UnitPlan, world: int, device) -> List:
    """The segmented ring's compressor of each unit's chunk (gqx's,
    collectives.py:302-315): the identity stays the identity; the others
    are ``config.quantizer`` at the chunk's size, one norm range.  A VQ
    codebook that no file holds trains on ``device``."""
    return [IdenticalCompressor(c, (c,)) if isinstance(u.compressor, IdenticalCompressor)
            else make_compressor(config.quantizer, c, (c,), config, device=device)
            for u, c in zip(plan.units, segment_chunks(plan, world))]


def init_mesh_state(config, plan: UnitPlan, device) -> AggState:
    """The aggregator state of this rank: per-user EF (local users, unit) for
    PS and the chain ring, one (1, W, chunk) slot per send for the
    segmented ring, each only with EF; the replicated server EF with EF and
    two-phase."""
    world, local = make_user_mesh(config.num_users)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    ef = None
    if config.ef:
        if config.mode == "ring" and config.ring_mode == "segmented":
            ef = [zeros(1, world, c) for c in segment_chunks(plan, world)]
        else:
            ef = [zeros(local, u.size) for u in plan.units]
    server = [zeros(u.size) for u in plan.units] if (config.ef and config.two_phase) else None
    return AggState(ef=ef, server_ef=server)


# --------------------------------------------------------------------------
# the wire: one int32 row per user
# --------------------------------------------------------------------------

def _user(sig, i):
    if isinstance(sig, dict):
        return {k: _user(v, i) for k, v in sig.items()}
    return sig[i]


def _stack(sigs):
    if isinstance(sigs[0], dict):
        return {k: _stack([s[k] for s in sigs]) for k in sigs[0]}
    return torch.stack(sigs)


def _leaves(sig):
    if isinstance(sig, dict):
        for v in sig.values():
            yield from _leaves(v)
    else:
        yield sig


def pack_rows(comp, sig) -> Tuple[torch.Tensor, Layout]:
    """A batched signature of n users -> (n, wire_bytes / 4) int32 rows, the
    fields of ``pack_signature`` laid end to end, and their layout."""
    rows, layout = [], None
    for i in range(next(iter(_leaves(sig))).shape[0]):
        wire = pack_signature(comp, _user(sig, i))
        if layout is None:
            layout = [(k, w.numel()) for k, w in wire.items()]
        rows.append(torch.cat([w.reshape(-1) for w in wire.values()]))
    out = torch.stack(rows)
    if 4 * out.shape[1] != wire_bytes(comp):
        raise AssertionError(f"a packed row of {4 * out.shape[1]} B, wire_bytes "
                             f"{wire_bytes(comp)}")
    return out, layout


def unpack_rows(comp, rows: torch.Tensor, layout: Layout):
    """(n, words) int32 rows -> the batched signature of the n users, bit
    for bit the one ``pack_rows`` was given."""
    sizes = [n for _, n in layout]
    sigs = []
    for row in rows:
        fields = dict(zip((k for k, _ in layout), row.split(sizes)))
        sigs.append(unpack_signature(comp, fields))
    return _stack(sigs)


def gather_rows(rows: torch.Tensor, world: int) -> torch.Tensor:
    """(n, words) rows of every rank -> (world * n, words), rank-major: ONE
    ``all_gather``."""
    out = rows.new_empty((world * rows.shape[0],) + tuple(rows.shape[1:]))
    with span("gqx_torch::collective.exchange"):
        _all_gather(out, rows.contiguous())
    return out


# --------------------------------------------------------------------------
# per-unit aggregation bodies
# --------------------------------------------------------------------------

def _mean_over_ranks(local: torch.Tensor, world: int) -> torch.Tensor:
    """The mean over ranks of equal-weight local means: one ``all_reduce``
    sum, divided by W (at W = 1 the value itself)."""
    out = local.to(torch.float32).contiguous()
    with span("gqx_torch::collective.exchange"):
        dist.all_reduce(out)
    return out.div_(world)


def _ps_unit_logical(comp, g, e, scale, users: UserRows, world: int):
    """Local round trips or the fused decode-mean, then the mean over ranks.
    ``e`` (local users, unit) is updated in place."""
    with span("gqx_torch::aggregate.encode"):
        g_enc = e.mul_(scale).add_(g) if e is not None else g   # g + scale * e
        sig = comp.compress_batch(g_enc, users)
    with span("gqx_torch::aggregate.decode"):
        if e is None:
            local = comp.decode_mean(sig)
        else:
            dec = comp.decompress_batch(sig)
            local = comp.users_mean(dec)
            e.sub_(dec)                           # the new error
    return _mean_over_ranks(local, world)


def _ps_unit_packed(comp, g, e, scale, users: UserRows, world: int):
    """Wire-true PS: the local users' packed rows are gathered, every rank
    unpacks all users and means their decodes.  With EF the mean is the
    sim step's ``users_mean`` of the per-user decodes, and each local user's
    new error is its encoded value less its decode."""
    with span("gqx_torch::aggregate.encode"):
        g_enc = e.mul_(scale).add_(g) if e is not None else g
        sig = comp.compress_batch(g_enc, users)
    with span("gqx_torch::collective.pack"):
        rows, layout = pack_rows(comp, sig)
    rows = gather_rows(rows, world)
    with span("gqx_torch::collective.unpack"):
        sig_all = unpack_rows(comp, rows, layout)
    with span("gqx_torch::aggregate.decode"):
        if e is None:
            return comp.decode_mean(sig_all)
        dec = comp.decompress_batch(sig_all)
        e.sub_(dec[users.first:users.first + users.count])
        return comp.users_mean(dec)


def _skip_draws(generator, n: int) -> None:
    if generator is not None:
        for _ in range(n):
            draw_seed(generator)


def _ring_unit(comp, g, e, scale, generator, first: int, num_users: int,
               rank: int, world: int):
    """The chain over all users: rank r waits for rank r - 1's float32 carry,
    runs its users' hops as the sim step does (hop 0 has no carry), sends
    the carry to rank r + 1, and the last rank's value is broadcast: the
    quantized SUM (reference ring_quantizer.py:45-47).  The hops of other
    ranks' users are skipped in the generator."""
    _skip_draws(generator, first * comp.seed_draws)
    carry = None
    if rank > 0:
        carry = torch.empty(comp.size, dtype=torch.float32, device=g.device)
        with span("gqx_torch::collective.exchange"):
            dist.recv(carry, rank - 1)
    for i in range(g.shape[0]):
        with span("gqx_torch::aggregate.encode"):
            acc = g[i] if carry is None else g[i] + carry
            if e is not None:
                acc = acc + scale * e[i]
            sig = comp.compress(acc, generator)
        with span("gqx_torch::aggregate.decode"):
            carry = comp.decompress(sig).to(torch.float32)
            if e is not None:
                torch.sub(acc, carry, out=e[i])   # the new error
    if rank < world - 1:
        with span("gqx_torch::collective.exchange"):
            dist.send(carry.contiguous(), rank + 1)
    _skip_draws(generator, (num_users - first - g.shape[0]) * comp.seed_draws)
    final = carry.contiguous() if rank == world - 1 else torch.empty(
        comp.size, dtype=torch.float32, device=g.device)
    with span("gqx_torch::collective.exchange"):
        dist.broadcast(final, world - 1)
    return final


_MASK64 = (1 << 64) - 1


def hop_seed(seed: int, index: int) -> int:
    """The segmented ring's seed of hop ``index`` (rank * W + hop): output
    ``index + 1`` of splitmix64 from state ``seed`` (the unit's seed), 63
    bits, the same on every rank."""
    z = (seed + (index + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _ring_unit_segmented(cc, chunk: int, g, e, scale, seed: Optional[int],
                         rank: int, world: int):
    """Bandwidth-optimal quantized ring (gqx's, collectives.py:190-252): the
    local users' sum (float32, lossless), W - 1 reduce-scatter hops with an
    encode and decode of 1/W of the unit each, then the compressed
    all-gather of the final segments.  Output: the quantized SUM over users.

    EF: the send at (rank d, hop s) always carries the running sum of
    segment (d - s) % W, so each rank keeps one chunk slot per send, ``e``
    (1, W, chunk), adds ``scale * e[s]`` before the encode and stores the
    new residual there."""
    total = g.sum(0, dtype=torch.float32)
    size = total.shape[0]
    pad = world * chunk - size
    segs = (torch.nn.functional.pad(total, (0, pad)) if pad else total).reshape(world, chunk)
    slots = e[0] if e is not None else None

    def encode(x, hop):
        gen = None if seed is None else torch.Generator().manual_seed(
            hop_seed(seed, rank * world + hop))
        with span("gqx_torch::aggregate.encode"):
            pre = x + scale * slots[hop] if slots is not None else x
            sig = cc.compress_batch(pre[None], gen)
        if slots is not None:
            with span("gqx_torch::aggregate.decode"):
                torch.sub(pre, cc.decompress_batch(sig)[0], out=slots[hop])
        with span("gqx_torch::collective.pack"):
            return pack_rows(cc, sig)

    def decode(rows, layout):
        with span("gqx_torch::collective.unpack"):
            sig = unpack_rows(cc, rows, layout)
        with span("gqx_torch::aggregate.decode"):
            return cc.decompress_batch(sig)

    acc = segs[rank]
    for s in range(world - 1):
        rows, layout = encode(acc, s)
        recv = torch.empty_like(rows)
        ops = [dist.P2POp(dist.isend, rows, (rank + 1) % world),
               dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
        with span("gqx_torch::collective.exchange"):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        acc = decode(recv, layout)[0] + segs[(rank - s - 1) % world]

    # rank d now holds the quantized sum of segment (d + 1) % W
    rows, layout = encode(acc, world - 1)
    decoded = decode(gather_rows(rows, world), layout)
    order = (torch.arange(world) - 1) % world     # segment j came from rank j - 1
    return decoded[order.to(decoded.device)].reshape(-1)[:size]


def _pmean_tree(model, losses: torch.Tensor, world: int) -> torch.Tensor:
    """The BN batch statistics of the local users and their losses, across
    ranks as ONE flat collective: an ``all_gather`` (not a mean of means), so
    each BatchNorm's recorded statistics become the (U, C) ones of all users
    in user order, and the running statistics and the loss are the sim
    step's bit for bit.  Returns the mean loss over all users."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm) and m.batch_stats]
    parts = [losses.to(torch.float32).reshape(-1)]
    shapes = []
    for m in bns:
        mean = torch.cat([a for a, _ in m.batch_stats])
        var = torch.cat([b for _, b in m.batch_stats])
        shapes.append(mean.shape)
        parts += [mean.to(torch.float32).reshape(-1), var.to(torch.float32).reshape(-1)]
    flat = torch.cat(parts)
    cols = gather_rows(flat[None], world).split([p.numel() for p in parts], dim=1)
    for i, (m, shape) in enumerate(zip(bns, shapes)):
        rows = (world * shape[0],) + tuple(shape[1:])
        m.batch_stats[:] = [(cols[1 + 2 * i].reshape(rows), cols[2 + 2 * i].reshape(rows))]
    return cols[0].reshape(-1).to(losses.dtype).mean()


# --------------------------------------------------------------------------
# the distributed training step
# --------------------------------------------------------------------------

def _check_state(state_ef, want: List[Tuple[int, ...]], what: str) -> None:
    if state_ef is None:
        return
    got = [tuple(t.shape) for t in state_ef]
    if got != want:
        raise ValueError(f"{what} of shapes {got}, the distributed step needs {want} "
                         "(build the state with create_train_state under the same config and "
                         "process group)")


def make_mesh_train_step(config, plan: UnitPlan) -> Callable:
    """step(state, x (L, B, C, H, W), y (L, B), lr, wd, generator, scale=1.0)
    -> the mean loss over all users, where L is this rank's users and the
    batch their rows of the global batch (``distributed.local_user_batch``).
    ``generator`` is the sim step's, seeded alike on every rank.  The state
    comes from ``create_train_state`` under the same config and process
    group (``init_mesh_state``); parameters, momentum, BN statistics and the
    server EF stay equal on every rank."""
    from gqx_torch.train import folded_user_grads, fused_sgd_update, user_grads

    rank, world = rank_and_world()
    first, stop = process_user_range(config.num_users, rank, world)
    local = stop - first
    momentum = resolve_schedule(config)[4]
    packed = config.wire == "packed"
    ring = config.mode == "ring"
    segmented = ring and config.ring_mode == "segmented"
    chunks = segment_chunks(plan, world)
    # the segmented ring's chunk compressors, built at the first step on the
    # model's device
    chunk_comps: Dict[torch.device, List] = {}
    warn_chain_ring_scale(config, world)

    if segmented:
        ef_want = [(1, world, c) for c in chunks]
    else:
        ef_want = [(local, u.size) for u in plan.units]

    def train_step(state, x, y, lr: float, wd: float, generator, scale: float = 1.0):
        model = state.model
        dev = next(model.parameters()).device
        if x.device != dev or y.device != dev:
            raise ValueError(f"batch on {x.device}/{y.device}, model on {dev}")
        if x.shape[0] != local:
            raise ValueError(f"rank {rank} owns {local} users, the batch holds {x.shape[0]}")
        check_backend(dev)
        agg_state = state.agg_state
        _check_state(agg_state.ef, ef_want, "error feedback")
        _check_state(agg_state.server_ef, [(u.size,) for u in plan.units], "server error feedback")
        clear_batch_stats(model)
        if config.folded_users:
            losses, grads = folded_user_grads(model, plan, plan.names, x, y)
        else:
            losses, grads = user_grads(model, plan.names, x, y)
        users = UserRows(generator, first, local)
        with span("gqx_torch::aggregate"):
            with span("gqx_torch::aggregate.pack"):
                units = plan.pack(grads)
            out = []
            for ui, (unit, g) in enumerate(zip(plan.units, units)):
                comp = unit.compressor
                e = agg_state.ef[ui] if agg_state.ef is not None else None
                if segmented:
                    seed = None if generator is None else draw_seed(generator)
                    if dev not in chunk_comps:
                        chunk_comps[dev] = segment_compressors(config, plan, world, dev)
                    mean = _ring_unit_segmented(chunk_comps[dev][ui], chunks[ui], g, e, scale,
                                                seed, rank, world)
                elif ring:
                    mean = _ring_unit(comp, g, e, scale, generator, first, config.num_users,
                                      rank, world)
                elif packed:
                    mean = _ps_unit_packed(comp, g, e, scale, users, world)
                else:
                    mean = _ps_unit_logical(comp, g, e, scale, users, world)
                if not ring and config.two_phase:
                    # replicated, with the same draws on every rank
                    mean = two_phase_roundtrip(comp, mean, agg_state.server_ef, ui, generator)
                out.append(mean)
        fused_sgd_update(plan.unpack(out), dict(model.named_parameters()), state.trace,
                         lr, wd, momentum)
        loss = _pmean_tree(model, losses, world)
        update_running_stats(model)
        state.step += 1
        return loss

    return train_step
