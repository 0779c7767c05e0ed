"""Signature <-> packed payload for every compressor (counterpart of the
m-order half of ``gqx/ops/wire.py``).

``pack_signature`` turns one user's signature into a dict of int32 word
tensors (the payload; ``gqx_torch.ops.pack`` says how the bits lie), word
for word gqx's for the same signature; ``unpack_signature`` inverts it
bit-exactly; ``wire_bytes`` is the payload's exact size.  gqx's transposed
wire is its TPU kernels' (B, s_pad) layout, which the port has no signature
in: ``transposed=True`` raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from gqx_torch.compress.scalar import (IdenticalCompressor, ProbabilisticScalarCompressor,
                                       QSGDCompressor, SignSGDCompressor)
from gqx_torch.compress.sparse import MaureySparsificationCompressor, TopKCompressor
from gqx_torch.compress.vq import (HSQCompressor, ProbabilisticVectorCompressor,
                                   ResidualCompressor)
from gqx_torch.ops.pack import f32_to_words, pack_uint, packed_words, unpack_uint, words_to_f32

Wire = Dict[str, torch.Tensor]


def _level_bits(comp) -> int:
    """Bits of a quantization level: with stochastic rounding the level can
    reach s = 2^n_bit, one bit more than n_bit (gqx/ops/wire.py:44-52)."""
    return comp.n_bit + (1 if comp.random else 0)


def _index_bits(comp: TopKCompressor) -> int:
    return 16 if comp.size <= (1 << 16) else 32


def _trits(signs: torch.Tensor) -> torch.Tensor:
    """{-1, 0, +1} -> {0, 1, 2}: two bits a sign, so a 0 survives."""
    return (torch.sign(signs).reshape(-1) + 1).to(torch.int64)


def _no_transposed(transposed: bool):
    if transposed:
        raise ValueError("the transposed wire is the layout of gqx's TPU kernels; the port's "
                         "signatures are m-order only")


def _pack_prob_scalar(comp: ProbabilisticScalarCompressor, sig) -> Wire:
    return {
        "bounds": f32_to_words(torch.stack([sig["lower"], sig["upper"]])),
        "l": pack_uint(sig["l"].reshape(-1), _level_bits(comp)),
    }


def _unpack_prob_scalar(comp: ProbabilisticScalarCompressor, wire: Wire):
    shape = (2, comp.n_segments) if comp.segment_sizes is not None else (2,)
    bounds = words_to_f32(wire["bounds"], shape)
    l = unpack_uint(wire["l"], _level_bits(comp), comp.size).to(torch.int32)
    return {"lower": bounds[0], "upper": bounds[1], "l": l.reshape(comp.shape)}


def pack_signature(comp, sig, transposed: bool = False) -> Wire:
    """One user's signature -> {field: int32 words}."""
    _no_transposed(transposed)
    if isinstance(comp, IdenticalCompressor):
        return {"raw": f32_to_words(sig["vec"])}
    if isinstance(comp, SignSGDCompressor):
        return {"trits": pack_uint(_trits(sig["signs"]), 2)}
    if isinstance(comp, QSGDCompressor):
        return {
            "norm": f32_to_words(sig["norm"]),
            "signs": pack_uint(sig["signs"].reshape(-1), 1),
            "l": pack_uint(sig["l"].reshape(-1), _level_bits(comp)),
        }
    if isinstance(comp, ProbabilisticScalarCompressor):
        return _pack_prob_scalar(comp, sig)
    if isinstance(comp, (HSQCompressor, ProbabilisticVectorCompressor)):
        out = {"codes": pack_uint(sig["codes"].reshape(-1), comp.code_bits)}
        if comp.compressed_norm:
            inner = _pack_prob_scalar(comp.norm_compressor, sig["u"])
            out.update({f"u_{k}": v for k, v in inner.items()})
        else:
            out["u_raw"] = f32_to_words(sig["u"])
        return out
    if isinstance(comp, ResidualCompressor):
        return {f"s{i}_{k}": v
                for i, stage in enumerate(comp.stages)
                for k, v in pack_signature(stage, sig[f"stage{i}"]).items()}
    if isinstance(comp, TopKCompressor):
        return {"values": f32_to_words(sig["values"]),
                "indices": pack_uint(sig["indices"], _index_bits(comp))}
    if isinstance(comp, MaureySparsificationCompressor):
        return {"scale": f32_to_words(sig["scale"]),
                "codes": pack_uint(sig["codes"], comp.idx_bits),
                "signs": pack_uint(_trits(sig["signs"]), 2)}
    raise TypeError(type(comp))


def unpack_signature(comp, wire: Wire, transposed: bool = False):
    """{field: int32 words} -> the signature, bit-exact."""
    _no_transposed(transposed)
    if isinstance(comp, IdenticalCompressor):
        return {"vec": words_to_f32(wire["raw"], comp.shape)}
    if isinstance(comp, SignSGDCompressor):
        trits = unpack_uint(wire["trits"], 2, comp.size).to(torch.float32) - 1.0
        return {"signs": trits.reshape(comp.shape)}
    if isinstance(comp, QSGDCompressor):
        return {
            "norm": words_to_f32(wire["norm"], (comp.M,)),
            "signs": unpack_uint(wire["signs"], 1, comp.size).to(torch.bool).reshape(comp.shape),
            "l": unpack_uint(wire["l"], _level_bits(comp), comp.size)
            .to(torch.int32).reshape(comp.shape),
        }
    if isinstance(comp, ProbabilisticScalarCompressor):
        return _unpack_prob_scalar(comp, wire)
    if isinstance(comp, (HSQCompressor, ProbabilisticVectorCompressor)):
        codes = unpack_uint(wire["codes"], comp.code_bits, comp.M).to(comp.code_dtype)
        if comp.compressed_norm:
            inner = {k[2:]: v for k, v in wire.items() if k.startswith("u_")}
            u = _unpack_prob_scalar(comp.norm_compressor, inner)
        else:
            u = words_to_f32(wire["u_raw"], (comp.M,))
        return {"codes": codes, "u": u}
    if isinstance(comp, ResidualCompressor):
        sig = {}
        for i, stage in enumerate(comp.stages):
            prefix = f"s{i}_"
            sub = {k[len(prefix):]: v for k, v in wire.items() if k.startswith(prefix)}
            sig[f"stage{i}"] = unpack_signature(stage, sub)
        return sig
    if isinstance(comp, TopKCompressor):
        return {"values": words_to_f32(wire["values"], (comp.k,)),
                "indices": unpack_uint(wire["indices"], _index_bits(comp), comp.k)
                .to(torch.int32)}
    if isinstance(comp, MaureySparsificationCompressor):
        trits = unpack_uint(wire["signs"], 2, comp.k).to(torch.float32)
        return {"scale": words_to_f32(wire["scale"], (1,))[0],
                "codes": unpack_uint(wire["codes"], comp.idx_bits, comp.k).to(torch.int32),
                "signs": trits - 1.0}
    raise TypeError(type(comp))


def wire_bytes(comp) -> int:
    """Exact packed payload bytes of one user's signature (whole words)."""
    if isinstance(comp, IdenticalCompressor):
        return 4 * comp.size
    if isinstance(comp, SignSGDCompressor):
        return 4 * packed_words(comp.size, 2)
    if isinstance(comp, QSGDCompressor):
        return 4 * (comp.M + packed_words(comp.size, 1)
                    + packed_words(comp.size, _level_bits(comp)))
    if isinstance(comp, ProbabilisticScalarCompressor):
        # two range scalars per segment (per original leaf of a grouped unit)
        return 4 * (2 * comp.n_segments + packed_words(comp.size, _level_bits(comp)))
    if isinstance(comp, (HSQCompressor, ProbabilisticVectorCompressor)):
        u_bytes = wire_bytes(comp.norm_compressor) if comp.compressed_norm else 4 * comp.M
        return 4 * packed_words(comp.M, comp.code_bits) + u_bytes
    if isinstance(comp, ResidualCompressor):
        return sum(wire_bytes(s) for s in comp.stages)
    if isinstance(comp, TopKCompressor):
        return 4 * (comp.k + packed_words(comp.k, _index_bits(comp)))
    if isinstance(comp, MaureySparsificationCompressor):
        # the scale, then an index and a two-bit sign per sample
        return 4 * (1 + packed_words(comp.k, comp.idx_bits) + packed_words(comp.k, 2))
    raise TypeError(type(comp))
