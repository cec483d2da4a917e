"""Order-preserving float encodings (reference: clickhouse_tpu/ops/hash_ops.py).

Only the IEEE branch, which the sort keys need: a float maps to a u64
token (carried as int64 bits) whose unsigned order is the float total
order: -0.0 below +0.0, NaNs last.  The map is one-to-one, so equal tokens
are equal bit patterns (-0.0 and +0.0 are two keys, NaNs with equal bits
one) and the decoders give the float back exactly.  hash64 and the other
row hashes are not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["f64_token", "f32_token", "f64_from_token", "sortable_bits",
           "_order_map32"]

_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_U32 = 0xFFFFFFFF


def _order_map32(b: torch.Tensor) -> torch.Tensor:
    """IEEE f32 bit pattern (u32 value in int64) -> int64 holding the u32
    whose unsigned order is the float total order (negative: flip all
    bits; positive: set the sign bit)."""
    b = b.to(torch.int64) & _U32
    return torch.where((b >> 31) == 1, (~b) & _U32, b | 0x80000000)


def _order_unmap32(t: torch.Tensor) -> torch.Tensor:
    """Inverse of _order_map32: the f32 bit pattern as a u32 in int64."""
    t = t.to(torch.int64) & _U32
    return torch.where((t >> 31) == 1, t & 0x7FFFFFFF, (~t) & _U32)


def f64_token(x: torch.Tensor) -> torch.Tensor:
    """Total-order injective u64 token (int64 bits) of an f64 column."""
    bits = x.to(torch.float64).view(torch.int64)
    return torch.where(bits < 0, ~bits, bits | _SIGN)


def f64_from_token(t: torch.Tensor) -> torch.Tensor:
    """Inverse of `f64_token`."""
    bits = torch.where(t < 0, t & ~_SIGN, ~t)
    return bits.view(torch.float64)


def f32_token(x: torch.Tensor) -> torch.Tensor:
    """f32 counterpart of `f64_token` (same token layout, lo half zero)."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    return _order_map32(b) << 32


def _f32_from_token(t: torch.Tensor) -> torch.Tensor:
    """Inverse of `f32_token`."""
    b = _order_unmap32((t >> 32) & _U32)       # u32 bits in [0, 2^32)
    return (b - ((b >> 31) << 32)).to(torch.int32).view(torch.float32)


def sortable_bits(x: torch.Tensor):
    """(encoded, decoder): floats as their tokens (`f64_token` /
    `f32_token`), which sort as u64 and are one-to-one, so grouping and
    sorting never compare raw floats; decoder is None for other types."""
    if x.dtype == torch.float64:
        return f64_token(x), f64_from_token
    if x.dtype == torch.float32:
        return f32_token(x), _f32_from_token
    return x, None
