"""String kernels over a dictionary's bytes (K10).

A String column is dictionary codes; a predicate over its values is
computed once a dictionary value, into a lookup table that the rows then
gather by code.  ``prefix_match`` computes that table for ``startsWith``,
``endsWith`` and ``LIKE 'p%'`` / ``LIKE '%s'`` from the dictionary's bytes
on the device (``Dictionary.device_chars``: ClickHouse's ColumnString
layout, one chars buffer and U + 1 offsets).

Reference: ``_device_prefix_lut`` (clickhouse_tpu/exprs/functions.py:611),
which compares a (U, 64) byte matrix of the values truncated to 64 bytes,
for dictionaries of 65,536 to 4,194,304 values only (the window that its
TPU's program constants allowed).  The port takes the kernel for every
dictionary size, over every byte of every value.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.errors import MemoryLimitExceeded
from . import _native

__all__ = ["prefix_match", "check_chars_bytes"]


def check_chars_bytes(need: int, left: Optional[int]) -> None:
    """Raise MemoryLimitExceeded, before anything is built, where a
    dictionary's chars, offsets and LUT need more than the `left` bytes
    of the budget (None: no limit)."""
    if left is not None and need > left:
        raise MemoryLimitExceeded(
            f"a string dictionary's bytes would need {need} bytes of device "
            f"memory ({max(left, 0)} bytes of the budget left)")


def _check(chars: torch.Tensor, offsets: torch.Tensor) -> None:
    if chars.dtype != torch.uint8 or chars.dim() != 1 \
            or offsets.dim() != 1 or offsets.numel() < 1 \
            or offsets.dtype not in (torch.int32, torch.int64) \
            or chars.device != offsets.device:
        raise ValueError("prefix_match: chars must be 1-d uint8 and offsets "
                         "1-d int32/int64 (U + 1 values), on one device")


def prefix_match(chars: torch.Tensor, offsets: torch.Tensor, needle: bytes,
                 suffix: bool = False, negate: bool = False) -> torch.Tensor:
    """uint8 (U,): 1 where dictionary value u (chars[offsets[u]:
    offsets[u + 1]]) begins with needle (ends with it, with suffix), XOR
    negate.  A value shorter than the needle does not match; an empty
    needle matches every value."""
    _check(chars, offsets)
    needle = bytes(needle)
    if chars.device.type == "cpu":
        return _prefix_match_plain(chars, offsets, needle, suffix, negate)
    if chars.device.type != "cuda":
        raise RuntimeError(f"prefix_match: no kernel for {chars.device}")
    return _prefix_match_cuda(chars, offsets, needle, suffix, negate)


def _prefix_match_plain(chars, offsets, needle: bytes, suffix: bool,
                        negate: bool) -> torch.Tensor:
    """prefix_match in plain torch: one gather of every value's j-th
    compared byte for each needle byte j."""
    p = len(needle)
    off = offsets.to(torch.int64)
    start, end = off[:-1], off[1:]
    hit = end - start >= p
    if p and chars.numel():
        first = end - p if suffix else start
        last = chars.numel() - 1
        for j, c in enumerate(needle):
            at = torch.clamp(first + j, 0, last)
            hit = hit & (chars[at] == c)
    elif p:
        hit = torch.zeros_like(hit)
    return (hit ^ negate).to(torch.uint8)


def _prefix_match_cuda(chars, offsets, needle: bytes, suffix: bool,
                       negate: bool) -> torch.Tensor:
    dev = chars.device
    n = offsets.numel() - 1
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return out                      # no launch
    chars, offsets = chars.contiguous(), offsets.contiguous()
    nd = torch.frombuffer(bytearray(needle), dtype=torch.uint8).to(dev) \
        if needle else None
    rc = _native.library().chtt_prefix_match(
        chars.data_ptr(), offsets.data_ptr(),
        int(offsets.dtype == torch.int64), n,
        None if nd is None else nd.data_ptr(), len(needle), int(suffix),
        int(negate), out.data_ptr(), _native.grid_blocks(dev, n),
        _native.stream_ptr(dev))
    _native.check(rc, "prefix_match")
    _native.count_launch("prefix_match", n)
    return out
