"""Order-preserving float encodings (reference: clickhouse_tpu/ops/hash_ops.py).

Only the IEEE branch, which the sort keys need: a float maps to a u64
token (carried as int64 bits) whose unsigned order is the float total
order: -0.0 below +0.0, NaNs last.  hash64 and the other row hashes are not
ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["f64_token", "f32_token", "_order_map32"]

_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_U32 = 0xFFFFFFFF


def _order_map32(b: torch.Tensor) -> torch.Tensor:
    """IEEE f32 bit pattern (u32 value in int64) -> int64 holding the u32
    whose unsigned order is the float total order (negative: flip all
    bits; positive: set the sign bit)."""
    b = b.to(torch.int64) & _U32
    return torch.where((b >> 31) == 1, (~b) & _U32, b | 0x80000000)


def f64_token(x: torch.Tensor) -> torch.Tensor:
    """Total-order injective u64 token (int64 bits) of an f64 column."""
    bits = x.to(torch.float64).view(torch.int64)
    return torch.where(bits < 0, ~bits, bits | _SIGN)


def f32_token(x: torch.Tensor) -> torch.Tensor:
    """f32 counterpart of `f64_token` (same token layout, lo half zero)."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    return _order_map32(b) << 32
