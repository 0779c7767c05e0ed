"""Bit-packing: the wire format (counterpart of ``gqx/ops/pack.py``).

Values are packed little-endian into 32-bit words: value i occupies stream
bits [i*bits, (i+1)*bits).  A payload is an int32 tensor holding each
word's bit pattern (``.numpy().view(np.uint32)`` gives gqx's uint32 words),
on the CPU and on the card alike.  The shifts and ORs are done in int64 and
masked to 32 bits: torch has no uint32 shifts on the CPU.  Unpacked values
come back as int64.

Two packers, as gqx has them:
  - ``pack_aligned`` / ``unpack_aligned``: bits in {1, 2, 4, 8, 16}, a lane
    reshape and a shift-or;
  - ``pack_bits`` / ``unpack_bits``: any bits (such as 7-bit norm levels),
    periodic: every lcm(bits, 32) stream bits hold 32/gcd values in
    bits/gcd words with a fixed value -> (word, offset) map.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

WORD = 32
_MASK32 = 0xFFFFFFFF


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def packed_words(n_values: int, bits: int) -> int:
    """Number of 32-bit words needed for n_values of ``bits`` bits."""
    return _ceil_div(n_values * bits, WORD)


def _to_words(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _from_words(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & _MASK32


def _mask(bits: int) -> int:
    return (1 << bits) - 1


def _padded(v: torch.Tensor, n: int) -> torch.Tensor:
    """``v`` zero-padded at the end to ``n`` values."""
    return torch.cat([v, v.new_zeros(n - v.shape[0])]) if n > v.shape[0] else v


def pack_aligned(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (N,) unsigned ints of ``bits`` in {1, 2, 4, 8, 16, 32}."""
    assert WORD % bits == 0, bits
    per_word = WORD // bits
    n_words = _ceil_div(values.shape[0], per_word)
    v = _padded(values.to(torch.int64) & _mask(bits), n_words * per_word)
    shifts = torch.arange(per_word, dtype=torch.int64, device=v.device) * bits
    # the lanes' bits do not overlap, so their sum is their OR
    return _to_words((v.reshape(n_words, per_word) << shifts).sum(1))


def unpack_aligned(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    assert WORD % bits == 0, bits
    per_word = WORD // bits
    shifts = torch.arange(per_word, dtype=torch.int64, device=words.device) * bits
    lanes = (_from_words(words)[:, None] >> shifts) & _mask(bits)
    return lanes.reshape(-1)[:n]


def _period(bits: int) -> Tuple[int, int]:
    """(values, words) per bitstream period: lcm(bits, 32) stream bits."""
    g = math.gcd(bits, WORD)
    return WORD // g, bits // g


def pack_bits(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (N,) unsigned ints of any ``bits`` into the little-endian
    stream: each word is an OR of the shifted value columns that reach it."""
    n = values.shape[0]
    vpp, wpp = _period(bits)
    p = _ceil_div(n, vpp)
    cols = _padded(values.to(torch.int64) & _mask(bits), p * vpp).reshape(p, vpp)
    words = []
    for k in range(wpp):
        acc = None
        for i in range(vpp):
            w0, off = divmod(i * bits, WORD)
            if w0 == k:
                term = cols[:, i] << off
            elif w0 + 1 == k and off + bits > WORD:
                term = cols[:, i] >> (WORD - off)
            else:
                continue
            acc = term if acc is None else acc | term
        words.append(acc & _MASK32)
    return _to_words(torch.stack(words, dim=1).reshape(-1)[:packed_words(n, bits)])


def unpack_bits(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: each value from at most two words."""
    vpp, wpp = _period(bits)
    p = _ceil_div(n, vpp)
    w = _padded(_from_words(words), p * wpp)[:p * wpp].reshape(p, wpp)
    vals = []
    for i in range(vpp):
        w0, off = divmod(i * bits, WORD)
        x = w[:, w0] >> off
        if off + bits > WORD:
            x = x | (w[:, w0 + 1] << (WORD - off))
        vals.append(x & _mask(bits))
    return torch.stack(vals, dim=1).reshape(-1)[:n]


def pack_uint(values: torch.Tensor, bits: int) -> torch.Tensor:
    """(N,) unsigned ints of ``bits`` bits -> int32 words."""
    if bits == 32:
        return _to_words(values.to(torch.int64) & _MASK32)
    if WORD % bits == 0:
        return pack_aligned(values, bits)
    return pack_bits(values, bits)


def unpack_uint(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """int32 words -> (n,) int64 values of ``bits`` bits."""
    if bits == 32:
        return _from_words(words[:n])
    if WORD % bits == 0:
        return unpack_aligned(words, bits, n)
    return unpack_bits(words, bits, n)


def f32_to_words(x: torch.Tensor) -> torch.Tensor:
    """float32 values (any shape) -> their bit patterns, flat int32."""
    return x.to(torch.float32).contiguous().reshape(-1).view(torch.int32)


def words_to_f32(w: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    return w.contiguous().view(torch.float32).reshape(shape)
