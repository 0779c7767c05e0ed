"""Unit planning (counterpart of ``gqx/parallel/packing.py``): map a model's
gradients onto a few flat "compression units".

  - all passthrough (<= threshold) leaves -> ONE identity unit,
  - all compressed leaves whose size is divisible by ``c_dim`` -> ONE unit,
    zero-padded for HSQ to a multiple of 65,536 elements, with per-leaf
    norm segments and the pad as its own segment,
  - ragged leaves -> a unit each.

Leaves are named by the port's parameter names, and taken in gqx's leaf
order: its flattened flax paths sorted component by component (so
``Bottleneck_10`` precedes ``Bottleneck_2``), as ``gqx_torch.convert``
gives them.  That makes the units, their concatenation order and their
norm segments equal to gqx's.

Tensors here are in the port's layout: conv weights OIHW (cout, cin, kh,
kw), dense weights (out, in).  The ``quant_layout`` orders become:
  torch     OIHW as is, dense (out, in) as is;
  outfirst  conv (cout, kh, kw, cin) = permute(0, 2, 3, 1), dense as is;
  natural   gqx's flax order: conv (kh, kw, cin, cout), dense (in, out).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from gqx_torch.compress import IdenticalCompressor, make_compressor
from gqx_torch.compress.api import Compressor, subvector_dim
from gqx_torch.ops.wire import wire_bytes

HSQ_ALIGN = 65536  # 512 x 128: the TPU kernels' tile, kept for an identical plan


@dataclasses.dataclass(frozen=True)
class Unit:
    leaf_indices: Tuple[int, ...]   # indices into the plan's leaf list
    sizes: Tuple[int, ...]          # element count per member leaf
    compressor: Compressor          # over the concatenated flat vector
    pad: int = 0                    # zero tail appended by pack()

    @property
    def size(self) -> int:
        return sum(self.sizes) + self.pad


def layout_perm(shape: Tuple[int, ...], layout: str) -> Tuple[int, ...]:
    """Permutation of a port-layout leaf into ``layout``'s flattening order."""
    nd = len(shape)
    if layout == "torch" or nd < 2:
        return tuple(range(nd))
    if layout == "outfirst":
        return (0, 2, 3, 1) if nd == 4 else tuple(range(nd))
    if layout == "natural":
        return (2, 3, 1, 0) if nd == 4 else (1, 0)
    raise ValueError(f"unknown quant_layout {layout!r}")


def _invert(perm):
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


class UnitPlan:
    """Pack/unpack between named leaves (with optional leading axes, such as
    users) and the per-unit flat vectors."""

    def __init__(self, names: Sequence[str], leaf_shapes: Sequence[Tuple[int, ...]],
                 units: List[Unit], layout: str = "torch",
                 unit_dtypes: Optional[Sequence[Optional[torch.dtype]]] = None):
        self.names = list(names)
        self.leaf_shapes = [tuple(s) for s in leaf_shapes]
        self.units = units
        self.layout = layout
        self.unit_dtypes = (list(unit_dtypes) if unit_dtypes is not None
                            else [None] * len(units))
        self.perms = [layout_perm(s, layout) for s in self.leaf_shapes]
        covered = sorted(i for u in units for i in u.leaf_indices)
        if covered != list(range(len(self.names))):
            raise ValueError("units must cover every leaf exactly once")

    def pack(self, tree: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
        """leaves (*lead, *leaf_shape) -> per-unit (*lead, unit_size)."""
        out = []
        for u, dt in zip(self.units, self.unit_dtypes):
            flats = []
            for i, size in zip(u.leaf_indices, u.sizes):
                x = tree[self.names[i]]
                nlead = x.dim() - len(self.leaf_shapes[i])
                lead = tuple(x.shape[:nlead])
                if dt is not None:
                    x = x.to(dt)  # cast before the permute: half the bytes
                perm = self.perms[i]
                if perm != tuple(range(len(perm))):
                    x = x.permute(tuple(range(nlead)) + tuple(nlead + p for p in perm))
                flats.append(x.reshape(lead + (size,)))
            if u.pad:
                flats.append(flats[0].new_zeros(lead + (u.pad,)))
            out.append(flats[0].contiguous() if len(flats) == 1 else torch.cat(flats, dim=-1))
        return out

    def unpack(self, unit_arrays: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """per-unit (*lead, unit_size) -> {name: (*lead, *leaf_shape)}."""
        leaves: Dict[str, torch.Tensor] = {}
        for u, arr in zip(self.units, unit_arrays):
            lead = tuple(arr.shape[:-1])
            nlead = len(lead)
            offset = 0
            for i, size in zip(u.leaf_indices, u.sizes):
                piece = arr[..., offset:offset + size]
                perm = self.perms[i]
                shape = self.leaf_shapes[i]
                if perm != tuple(range(len(perm))):
                    piece = piece.reshape(lead + tuple(shape[p] for p in perm))
                    inv = _invert(perm)
                    piece = piece.permute(tuple(range(nlead)) + tuple(nlead + p for p in inv))
                else:
                    piece = piece.reshape(lead + shape)
                leaves[self.names[i]] = piece
                offset += size
        return leaves

    @property
    def compressors(self) -> List[Compressor]:
        return [u.compressor for u in self.units]

    def wire_bytes(self) -> int:
        """Packed payload bytes per user and step (``gqx_torch.ops.wire``:
        whole 32-bit words, as gqx counts them)."""
        return sum(wire_bytes(u.compressor) for u in self.units)


def _path_key(path: str):
    return tuple(path.split("/"))


def plan_units(named_shapes: Sequence[Tuple[str, Tuple[int, ...]]],
               paths: Mapping[str, str], config, device="cuda") -> UnitPlan:
    """Build the unit plan for named leaves (port layout) per config.

    ``paths`` maps each name to gqx's flattened leaf path
    (``gqx_torch.convert.leaf_paths``); leaves are ordered by it.  A VQ
    codebook that no file holds is trained on ``device``."""
    items = sorted(named_shapes, key=lambda ns: _path_key(paths[ns[0]]))
    names = [n for n, _ in items]
    shapes = [tuple(s) for _, s in items]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    threshold = int(getattr(config, "passthrough_threshold", 1000))
    grouping = getattr(config, "grouping", "auto")
    name = config.quantizer

    passthrough_idx = [i for i, s in enumerate(sizes) if s <= threshold]
    compressed_idx = [i for i, s in enumerate(sizes) if s > threshold]
    units: List[Unit] = []

    def leaf_unit(i):
        units.append(Unit((i,), (sizes[i],),
                          make_compressor(name, sizes[i], (sizes[i],), config,
                                          device=device)))

    group_ok = (
        grouping != "none"
        and name not in ("sgd", "terngrad", "topk", "maurey")
        and not (name in ("qsgd", "hsq") and config.c_dim == 0)
    )
    if group_ok:
        needs_alignment = name in ("qsgd", "hsq", "pvq", "residual")
        aligned = [i for i in compressed_idx
                   if not needs_alignment or sizes[i] % config.c_dim == 0]
        ragged = [i for i in compressed_idx if i not in aligned]
        if aligned:
            total = sum(sizes[i] for i in aligned)
            norm_segments = None
            pad = 0
            if name in ("hsq", "pvq", "residual"):
                dim = subvector_dim(total, config.c_dim)
                if any(sizes[i] % dim for i in aligned):
                    raise ValueError(f"grouped leaves not aligned to dim {dim}")
                if name == "hsq" and HSQ_ALIGN % dim == 0:
                    pad = (-total) % HSQ_ALIGN
                norm_segments = tuple(sizes[i] // dim for i in aligned)
                if pad:
                    norm_segments = norm_segments + (pad // dim,)
            comp = make_compressor(name, total + pad, (total + pad,), config,
                                   norm_segment_sizes=norm_segments, device=device)
            units.append(Unit(tuple(aligned), tuple(sizes[i] for i in aligned),
                              comp, pad=pad))
        for i in ragged:
            leaf_unit(i)
    else:
        for i in compressed_idx:
            leaf_unit(i)

    if passthrough_idx:
        total = sum(sizes[i] for i in passthrough_idx)
        units.append(Unit(tuple(passthrough_idx),
                          tuple(sizes[i] for i in passthrough_idx),
                          IdenticalCompressor(total, (total,))))

    # bf16 units for HSQ when the passes=1 kernel rounds its input to bf16
    # anyway (gqx/parallel/packing.py:335-351): the same values, half the bytes
    ud = getattr(config, "unit_dtype", "auto")
    bf16_units = ud == "bfloat16" or (
        ud == "auto"
        and name == "hsq"
        and int(getattr(config, "hsq_passes", 2)) == 1
        and not getattr(config, "ef", False)
        and getattr(config, "compute_dtype", "float32") == "bfloat16"
    )
    unit_dtypes = [
        torch.bfloat16 if bf16_units and not isinstance(u.compressor, IdenticalCompressor)
        else None
        for u in units
    ]
    return UnitPlan(names, shapes, units,
                    layout=getattr(config, "quant_layout", "torch"),
                    unit_dtypes=unit_dtypes)
