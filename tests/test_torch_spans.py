"""The port's own profiler ranges (``gqx_torch.utils.profiling.span``).

Off, a span is the shared null context and makes no range.  Under
torch.profiler (CPU) a step of a small conv / BN / dense network, fed by
the data pipeline and ``runner.to_device``, enters every span of
``SPAN_NAMES`` but the mesh's, once a layer or a unit, nested as their
meanings say; a mesh step in a world of one enters the collective spans.
Splitting the round trips into their spanned encode and decode halves
leaves the aggregators' results as they were, bit for bit.
"""

import ast
import collections
import contextlib
import json
import pathlib

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.profiler import ProfilerActivity, profile

from gqx_torch.config import GQConfig
from gqx_torch.data import Pipeline
from gqx_torch.models.common import BatchNorm, Conv2d, Dense, nhwc_flatten, reset_parameters
from gqx_torch.parallel import aggregate, distributed
from gqx_torch.runner import to_device
from gqx_torch.train import create_train_state, make_train_step
from gqx_torch.utils import profiling
from gqx_torch.utils.profiling import SPAN_NAMES, span

REPO = pathlib.Path(__file__).resolve().parents[1]
USERS, BATCH, IMAGE = 2, 2, (8, 8, 3)
MESH_ONLY = {n for n in SPAN_NAMES if n.startswith("gqx_torch::collective.")}


class Tiny(nn.Module):
    """Each per-user weight gradient route of a folded conv (the stride-1
    KxK conv's, a strided 1x1's, a strided 3x3's), two batch norms and a
    dense layer, at 8x8 images."""

    def __init__(self):
        super().__init__()
        self.image_shape = IMAGE
        self.conv1 = Conv2d(3, 16, 3, flax_path="Conv_0")
        self.bn1 = BatchNorm(16, flax_path="BatchNorm_0")
        self.conv2 = Conv2d(16, 32, 1, stride=2, flax_path="Conv_1")
        self.bn2 = BatchNorm(32, flax_path="BatchNorm_1")
        self.conv3 = Conv2d(32, 16, 3, stride=2, flax_path="Conv_2")
        self.fc = Dense(16 * 2 * 2, 10, flax_path="Dense_0")

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return self.fc(nhwc_flatten(self.conv3(x))).to(torch.float32)


def _config(quantizer="hsq", **extra):
    return GQConfig(network="cnn", dataset="synthetic", quantizer=quantizer,
                    num_users=USERS, batch_size=BATCH, c_dim=16, k_bit=8, n_bit=6,
                    passthrough_threshold=100,
                    dataset_kwargs=dict(num_train=4 * USERS * BATCH, num_test=4,
                                        image_shape=IMAGE), **extra)


def _state(config):
    model = Tiny()
    reset_parameters(model, torch.Generator().manual_seed(0))
    state, plan = create_train_state(config, model, device="cpu")
    return state, plan, make_train_step(config, plan)


def _batches(steps, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((steps, USERS, BATCH, IMAGE[2]) + IMAGE[:2], generator=g)
    return x, torch.randint(0, 10, (steps, USERS, BATCH), generator=g)


def _annotations(prof, tmp_path):
    """The profiled window's user annotations (ranges) as (start, end, name,
    thread), from its chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e["tid"])
            for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(inner, outer, ranges):
    """Whether every range named ``inner`` lies in one named ``outer`` on
    its thread."""
    outs = [r for r in ranges if r[2] == outer]
    return all(any(o[0] <= r[0] and r[1] <= o[1] and o[3] == r[3] for o in outs)
               for r in ranges if r[2] == inner)


# -- off ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPAN_NAMES))
def test_a_span_off_is_the_shared_null_context(name, monkeypatch):
    def no_range(*a, **k):
        raise AssertionError("a range was made with no profiler running")

    monkeypatch.setattr(profiling, "record_function", no_range)
    ctx = span(name)
    assert ctx is profiling._NULL
    with ctx:
        pass
    assert span(name) is ctx


def test_every_call_site_names_a_span_of_the_table():
    """Every ``span(...)`` of the port takes a literal name of
    ``SPAN_NAMES``, and every name of the table is entered somewhere."""
    used = collections.Counter()
    for f in sorted((REPO / "gqx_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), f"{f}:{node.lineno}: not a literal"
                assert arg.value in SPAN_NAMES, f"{f}:{node.lineno}: {arg.value}"
                used[arg.value] += 1
    assert set(used) == set(SPAN_NAMES)
    assert all(n.startswith("gqx_torch::") for n in SPAN_NAMES)


# -- on ----------------------------------------------------------------------

@pytest.mark.parametrize("quantizer", ["hsq", "pvq"])
def test_a_profiled_step_enters_every_span(quantizer, tmp_path):
    config = _config(quantizer)
    state, plan, step = _state(config)
    batches = Pipeline(config).train_epoch(1)
    gen = torch.Generator().manual_seed(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x, y = next(batches)
        xt, yt = to_device(x, y, torch.device("cpu"))
        step(state, xt, yt, 0.1, 5e-4, gen)
    ranges = _annotations(prof, tmp_path)
    count = collections.Counter(r[2] for r in ranges)
    assert set(count) == set(SPAN_NAMES) - MESH_ONLY
    mods = list(state.model.modules())
    bns = sum(isinstance(m, BatchNorm) for m in mods)
    folded = sum(isinstance(m, (Conv2d, Dense)) for m in mods)
    units = len(plan.units)
    assert count == {**{n: 1 for n in count}, "gqx_torch::bn.forward": bns,
                     "gqx_torch::bn.backward": bns, "gqx_torch::fwd_bwd.per_user_dw": folded,
                     "gqx_torch::aggregate.encode": units, "gqx_torch::aggregate.decode": units}
    for inner, outer in [("gqx_torch::data.augment", "gqx_torch::data.batch"),
                         ("gqx_torch::bn.forward", "gqx_torch::fwd_bwd"),
                         ("gqx_torch::aggregate.pack", "gqx_torch::aggregate"),
                         ("gqx_torch::aggregate.encode", "gqx_torch::aggregate"),
                         ("gqx_torch::aggregate.decode", "gqx_torch::aggregate")]:
        assert _inside(inner, outer, ranges), (inner, outer)
    # the batch's range closes before it is yielded, before the step's ops
    first = {name: s for s, _, name, _ in sorted(ranges, reverse=True)}
    batch_end = max(e for _, e, n, _ in ranges if n == "gqx_torch::data.batch")
    assert batch_end <= first["gqx_torch::data.to_device"] <= first["gqx_torch::fwd_bwd"]
    encode = [s for s, _, n, _ in ranges if n == "gqx_torch::aggregate.encode"]
    decode = [s for s, _, n, _ in ranges if n == "gqx_torch::aggregate.decode"]
    assert all(a < b for a, b in zip(sorted(encode), sorted(decode)))


@pytest.mark.parametrize("extra,spans", [
    (dict(wire="packed"), {"pack", "exchange", "unpack"}),
    (dict(wire="logical", ef=True, two_phase=True), {"exchange"}),
    (dict(mode="ring"), {"exchange"}),
])
def test_a_mesh_step_enters_the_collective_spans(extra, spans, tmp_path):
    opened = distributed.maybe_initialize(device="cpu", world_of_one=True)
    try:
        state, plan, step = _state(_config(backend="mesh", **extra))
        x, y = _batches(1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, x[0], y[0], 0.1, 5e-4, torch.Generator().manual_seed(3), 0.5)
    finally:
        if opened:
            dist.destroy_process_group()
    found = {r[2] for r in _annotations(prof, tmp_path)}
    assert found & MESH_ONLY == {f"gqx_torch::collective.{s}" for s in spans}
    assert {"gqx_torch::aggregate", "gqx_torch::aggregate.pack", "gqx_torch::aggregate.encode",
            "gqx_torch::aggregate.decode"} <= found


# -- the split round trips ---------------------------------------------------

def _unsplit_ps(plan, grads, state, scale, generator, *, two_phase=False):
    """``aggregate.ps_aggregate`` with whole round trips, as it was before
    its encode and decode were spanned apart."""
    out = []
    for ui, (unit, g) in enumerate(zip(plan.units, plan.pack(grads))):
        comp = unit.compressor
        if state.ef is not None:
            e = state.ef[ui]
            e.mul_(scale).add_(g)
            dec = comp.roundtrip_batch(e, generator)
            mean = comp.users_mean(dec)
            e.sub_(dec)
        else:
            mean = comp.decode_mean(comp.compress_batch(g, generator))
        if two_phase:
            if state.server_ef is not None:
                mean = mean + state.server_ef[ui]
                dec2 = comp.roundtrip(mean, generator)
                state.server_ef[ui] = mean - dec2
                mean = dec2
            else:
                mean = comp.roundtrip(mean, generator)
        out.append(mean)
    return plan.unpack(out)


def _unsplit_ring(plan, grads, state, scale, generator):
    """``aggregate.ring_aggregate`` with whole round trips."""
    out = []
    for ui, (unit, g) in enumerate(zip(plan.units, plan.pack(grads))):
        comp = unit.compressor
        carry = None
        for i in range(g.shape[0]):
            acc = g[i] if carry is None else g[i] + carry
            e = None if state.ef is None else state.ef[ui][i]
            if e is not None:
                acc = acc + scale * e
            carry = comp.roundtrip(acc, generator)
            if e is not None:
                torch.sub(acc, carry, out=e)
        out.append(carry)
    return plan.unpack(out)


def _run(config, steps=2, traced=False):
    state, _, step = _state(config)
    x, y = _batches(steps)
    gen = torch.Generator().manual_seed(5)
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
        losses = [step(state, x[i], y[i], 0.1, 5e-4, gen, 0.5) for i in range(steps)]
    tensors = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    tensors.update({f"trace.{k}": v for k, v in state.trace.items()})
    for key in ("ef", "server_ef"):
        for i, t in enumerate(getattr(state.agg_state, key) or ()):
            tensors[f"{key}.{i}"] = t
    return losses, tensors


@pytest.mark.parametrize("extra", [dict(ef=True, two_phase=True),
                                   dict(mode="ring", ef=True)])
def test_split_round_trips_leave_the_step_bit_equal(extra, monkeypatch):
    config = _config(random=True, **extra)
    traced = _run(config, traced=True)
    plain = _run(config)
    monkeypatch.setattr(aggregate, "ps_aggregate", _unsplit_ps)
    monkeypatch.setattr(aggregate, "ring_aggregate", _unsplit_ring)
    unsplit = _run(config)
    for got in (traced, plain):
        assert [float(v) for v in got[0]] == [float(v) for v in unsplit[0]]
        assert got[1].keys() == unsplit[1].keys()
        for k, v in unsplit[1].items():
            assert torch.equal(got[1][k], v), k
