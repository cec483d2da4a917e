"""The streamed chunk transport's unpack (K13).

A bounded integer column of a streamed table crosses the host->device
link bit-packed (storage/table.py ChunkSource.encode_column, the "half"
layout): value j and value j + cap / 2 of a chunk, less the column's
lower bound, share one little-endian pair of bpp = w4 / 4 bytes, j's in
the low w4 bits.  ``unpack_pairs`` turns the bytes into the column's
narrow storage on the device.

Reference: ``_chunk_block`` (clickhouse_tpu/exec/streaming.py:930-968),
which unpacks the same bytes inside its per-chunk XLA program.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from . import _native

__all__ = ["unpack_pairs", "unpack_pairs_bytes"]

_OUT_TYPES = (torch.int8, torch.uint8, torch.int16, torch.int32,
              torch.int64)


def unpack_pairs_bytes(cap: int, bpp: int, out_dtype: torch.dtype) -> int:
    """Bytes K13 moves for a chunk of cap values: its packed pairs read
    once, its output written once."""
    return cap // 2 * bpp + cap * torch.empty(0, dtype=out_dtype
                                              ).element_size()


def _check(data: torch.Tensor, w4: int, bpp: int, cap: int,
           out_dtype: torch.dtype) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1 or cap < 0 or cap % 2 \
            or not 4 <= w4 <= 28 or w4 % 4 or bpp != w4 // 4 \
            or data.numel() != cap // 2 * bpp or out_dtype not in _OUT_TYPES:
        raise ValueError(
            f"unpack_pairs: {data.numel()} uint8 bytes, w4={w4}, bpp={bpp}, "
            f"cap={cap}, {out_dtype}: want cap even, w4 a multiple of 4 in "
            f"[4, 28], bpp = w4 / 4 and cap / 2 * bpp bytes")


def unpack_pairs(data: torch.Tensor, w4: int, off: int, bpp: int, cap: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """(cap,) out_dtype: out[j] = (pair_j & mask) + off and out[j + cap/2]
    = (pair_j >> w4 & mask) + off, pair_j the little-endian bytes
    data[j * bpp:(j + 1) * bpp], mask = 2^w4 - 1 (values wrap to
    out_dtype as numpy's astype)."""
    _check(data, w4, bpp, cap, out_dtype)
    if data.device.type == "cpu":
        return _unpack_pairs_plain(data, w4, off, bpp, cap, out_dtype)
    if data.device.type != "cuda":
        raise RuntimeError(f"unpack_pairs: no kernel for {data.device}")
    return _unpack_pairs_cuda(data, w4, off, bpp, cap, out_dtype)


def _unpack_pairs_plain(data, w4: int, off: int, bpp: int, cap: int,
                        out_dtype) -> torch.Tensor:
    """unpack_pairs in plain torch: each pair as an int64 of its bytes."""
    half = cap // 2
    by = data.reshape(half, bpp).to(torch.int64)
    pair = torch.zeros(half, dtype=torch.int64, device=data.device)
    for k in range(bpp):
        pair |= by[:, k] << (8 * k)
    mask = (1 << w4) - 1
    v = torch.cat([pair & mask, (pair >> w4) & mask]) + off
    return v.to(out_dtype)


def _unpack_pairs_cuda(data, w4: int, off: int, bpp: int, cap: int,
                       out_dtype) -> torch.Tensor:
    dev = data.device
    out = torch.empty(cap, dtype=out_dtype, device=dev)
    half = cap // 2
    if half == 0:
        return out                      # no launch
    data = data.contiguous()
    rc = _native.library().chtt_unpack_pairs(
        data.data_ptr(), half, bpp, w4, int(off),
        _native.dtype_code(out_dtype), out.data_ptr(),
        _native.grid_blocks(dev, half), _native.stream_ptr(dev))
    _native.check(rc, "unpack_pairs")
    _native.count_launch("unpack_pairs", cap)
    return out
