"""Brute-force vector distances over an Array(Float32) column, and K11.

Reference: clickhouse_tpu/exprs/functions_ext.py:_mxu_dist_parts and the
`mxu` forms of its distances (:2204-2287).  For a (cap, W) matrix A, zero
past each row's length, int32 lengths and one query q, the reference takes
three float32 products, dot = A @ q, a2 = (A * A) @ 1 and the length-masked
|q|^2 (a prefix of q^2), and then the distance in float32:

    cosine      1 - dot / max(sqrt(a2) * sqrt(b2), FLT_MIN)
    L2          sqrt(max(a2 - 2 dot + b2, 0))
    L2Squared   max(a2 - 2 dot + b2, 0)
    dot         dot

K11 (csrc/vector_distance.cu) computes the three parts and the distance in
one pass that reads each byte of A once.  Its plain PyTorch version
(`_vector_distance_plain`) repeats the same arithmetic with torch
operations; a CPU tensor takes it, a CUDA tensor launches the kernel or
raises.  The two sum in different orders, so they agree within float32
rounding (tests and chip_smoke.py state the tolerance).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _native

__all__ = ["DISTANCE_OPS", "vector_distance", "zero_row_distance"]

# op name -> K11's op code (csrc/vector_distance.cu, ChttDistanceOp)
DISTANCE_OPS = {"cosine": 0, "l2": 1, "l2squared": 2, "dot": 3}
_FLT_MIN = torch.finfo(torch.float32).tiny
_CHUNK = 1 << 20        # rows of the plain version's float32 temporaries
_ROWS_PER_WARP = 4      # kRows of csrc/vector_distance.cu


def zero_row_distance(op: str) -> float:
    """The distance the formulas give a zero row of length 0 (dot, a2 and
    b2 all 0): what K11 writes past row n without reading it."""
    return 1.0 if op == "cosine" else 0.0


def _check(A, lengths, q, op, n):
    if op not in DISTANCE_OPS:
        raise ValueError(f"vector_distance: unknown op {op!r}")
    if A.dim() != 2 or A.dtype != torch.float32 or not A.is_contiguous():
        raise ValueError("vector_distance: A must be a contiguous 2-d "
                         "float32 matrix")
    cap, w = A.shape
    if w % 8 or w < 8:
        raise ValueError(f"vector_distance: the width {w} is not a "
                         f"multiple of 8")
    if lengths.shape != (cap,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError(f"vector_distance: lengths must be {cap} "
                         f"contiguous int32 values")
    if q.shape != (w,) or q.dtype != torch.float32:
        raise ValueError(f"vector_distance: q must be {w} float32 values")
    if not 0 <= n <= cap:
        raise ValueError(f"vector_distance: n = {n} outside [0, {cap}]")
    if lengths.device != A.device or q.device != A.device:
        raise ValueError("vector_distance: A, lengths and q must be on one "
                         "device")


def vector_distance(A: torch.Tensor, lengths: torch.Tensor, q: torch.Tensor,
                    op: str, n: Optional[int] = None) -> torch.Tensor:
    """float32 (cap,): the distance `op` of each row of A (cap, W) to q
    (W,), rows of lengths[i] elements (A zero past them).  Rows at and past
    n (default: every row) get zero_row_distance(op) without being read.
    """
    n = A.shape[0] if n is None else int(n)
    _check(A, lengths, q, op, n)
    if A.device.type == "cpu":
        return _vector_distance_plain(A, lengths, q, op, n)
    if A.device.type != "cuda":
        raise RuntimeError(f"vector_distance: no kernel for {A.device}")
    return _vector_distance_cuda(A, lengths, q, op, n)


def _distance(op, dot, a2, b2):
    if op == "dot":
        return dot
    if op == "cosine":
        den = torch.sqrt(a2) * torch.sqrt(b2)
        # max(den, FLT_MIN), a NaN kept as it is (jnp.maximum's)
        return 1.0 - dot / torch.where(den < _FLT_MIN,
                                       torch.full_like(den, _FLT_MIN), den)
    v = a2 - 2.0 * dot + b2
    v = torch.where(v < 0, torch.zeros_like(v), v)
    return torch.sqrt(v) if op == "l2" else v


def _vector_distance_plain(A, lengths, q, op, n):
    """vector_distance in plain torch: dot and a2 a chunk of rows at a
    time (float32 products), b2 from the float32 prefix sums of q^2."""
    cap, w = A.shape
    out = torch.full((cap,), zero_row_distance(op), dtype=torch.float32,
                     device=A.device)
    prefix = torch.cat([torch.zeros(1, dtype=torch.float32,
                                    device=A.device),
                        torch.cumsum(q * q, 0)])
    for lo in range(0, n, _CHUNK):
        a = A[lo:min(n, lo + _CHUNK)]
        dot = torch.mv(a, q)
        a2 = (a * a).sum(1)
        b2 = prefix[lengths[lo:lo + a.shape[0]].to(torch.int64)
                    .clamp(0, w)]
        out[lo:lo + a.shape[0]] = _distance(op, dot, a2, b2)
    return out


def _vector_distance_cuda(A, lengths, q, op, n):
    dev = A.device
    cap, w = A.shape
    if A.data_ptr() % 16:
        raise ValueError("vector_distance: A must start on a 16-byte "
                         "boundary (K11 loads 16 bytes a lane)")
    if w > _native.K11_MAX_WIDTH:
        raise ValueError(f"vector_distance: rows of {w} elements are wider "
                         f"than K11 takes ({_native.K11_MAX_WIDTH})")
    q = q.contiguous()
    out = torch.empty(cap, dtype=torch.float32, device=dev)
    rc = _native.library().chtt_vector_distance(
        A.data_ptr(), lengths.data_ptr(), q.data_ptr(), n, cap, w,
        DISTANCE_OPS[op], out.data_ptr(),
        _native.grid_blocks(dev, -(-cap // _ROWS_PER_WARP) * 32, per_sm=8),
        _native.stream_ptr(dev))
    _native.check(rc, "vector_distance")
    _native.count_launch("vector_distance", n)
    return out
