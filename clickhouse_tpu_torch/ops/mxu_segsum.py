"""Exact dense segment counts and integer sums, and K2.

Reference: clickhouse_tpu/ops/mxu_segsum.py, which runs these as f32
one-hot matmuls over 8-bit limbs (the TPU serializes scatter).  The
contract is kept: for S <= MAX_DENSE_GROUPS slots, exact per-slot counts
and integer sums mod 2^64 in ONE pass over the data.  Here the pass is K2
(csrc/dense_group_reduce.cu), a shared-memory histogram with 64-bit
atomics; signed and unsigned sums share the same bits, so no limbs and no
sign bias are needed.  Counts are int64 throughout (the reference carries
them in int32 across chunks; the two agree below 2^31 rows per slot).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import _native

__all__ = ["MAX_DENSE_GROUPS", "dense_group_reduce", "mxu_group_reduce",
           "mxu_counts_and_sums"]

MAX_DENSE_GROUPS = 16384
_MAX_ARRAYS = 16                   # per kind; csrc/dense_group_reduce.cu
_SUM_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int16,
               torch.int32, torch.int64)


def dense_group_reduce(ids: torch.Tensor, base_mask: Optional[torch.Tensor],
                       count_masks: Sequence[Optional[torch.Tensor]],
                       sum_values: Sequence[torch.Tensor],
                       sum_masks: Sequence[Optional[torch.Tensor]], S: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot counts and sums of the rows with base_mask set.

    ids         -- int32/int64 slot per row; rows outside [0, S) are skipped
    count_masks -- one count output per entry (None = base_mask alone)
    sum_values  -- integer (or bool) values, one sum output per entry
    sum_masks   -- per sum, an extra row mask (None = base_mask alone)
    -> (counts int64 (C, S), sums int64 (K, S), wrapping mod 2^64)

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    if len(sum_masks) != len(sum_values):
        raise ValueError("dense_group_reduce: one mask entry per sum")
    if not 1 <= S <= MAX_DENSE_GROUPS:
        raise ValueError(f"dense_group_reduce: S={S} outside "
                         f"[1, {MAX_DENSE_GROUPS}]")
    for v in sum_values:
        if v.dtype not in _SUM_DTYPES:
            raise TypeError(f"dense_group_reduce: cannot sum {v.dtype}")
    if ids.device.type == "cpu":
        return _dense_group_reduce_plain(ids, base_mask, count_masks,
                                         sum_values, sum_masks, S)
    if ids.device.type != "cuda":
        raise RuntimeError(f"dense_group_reduce: no kernel for {ids.device}")
    return _dense_group_reduce_cuda(ids, base_mask, count_masks, sum_values,
                                    sum_masks, S)


def _check_rowwise(t, n, dev, what, dtypes):
    if t.dim() != 1 or t.shape[0] != n or t.device != dev \
            or not t.is_contiguous() or t.dtype not in dtypes:
        raise ValueError(f"dense_group_reduce: {what} must be a contiguous "
                         f"1-d tensor of {n} rows on {dev}, one of {dtypes}")


def _dense_group_reduce_cuda(ids, base_mask, count_masks, sum_values,
                             sum_masks, S):
    import ctypes
    dev = ids.device
    n = ids.shape[0]
    C, K = len(count_masks), len(sum_values)
    if C + K < 1 or C > _MAX_ARRAYS or K > _MAX_ARRAYS:
        raise ValueError(f"dense_group_reduce: {C} counts and {K} sums "
                         f"(1..{_MAX_ARRAYS} each)")
    _check_rowwise(ids, n, dev, "ids", (torch.int32, torch.int64))
    masks = [base_mask] + list(count_masks) + list(sum_masks)
    for m in masks:
        if m is not None:
            _check_rowwise(m, n, dev, "a mask", (torch.bool,))
    for v in sum_values:
        _check_rowwise(v, n, dev, "a summed value", _SUM_DTYPES)
    counts = torch.zeros((C, S), dtype=torch.int64, device=dev)
    sums = torch.zeros((K, S), dtype=torch.int64, device=dev)

    def ptrs(ts):
        return (ctypes.c_void_p * max(len(ts), 1))(
            *[t.data_ptr() if t is not None else None for t in ts])

    dtypes = (ctypes.c_int * max(K, 1))(
        *[_native.dtype_code(v.dtype) for v in sum_values])
    cm, sv, sm = ptrs(count_masks), ptrs(sum_values), ptrs(sum_masks)
    lib = _native.library()
    rc = lib.chtt_dense_group_reduce(
        ids.data_ptr(), int(ids.dtype == torch.int64),
        base_mask.data_ptr() if base_mask is not None else None, n, S,
        C, ctypes.cast(cm, ctypes.c_void_p), K,
        ctypes.cast(sv, ctypes.c_void_p), ctypes.cast(dtypes, ctypes.c_void_p),
        ctypes.cast(sm, ctypes.c_void_p), counts.data_ptr(), sums.data_ptr(),
        _native.grid_blocks(dev, n, per_sm=4), _native.stream_ptr(dev))
    _native.check(rc, "dense_group_reduce")
    _native.LAUNCHES["dense_group_reduce"] += 1
    return counts, sums


def _dense_group_reduce_plain(ids, base_mask, count_masks, sum_values,
                              sum_masks, S):
    """Plain PyTorch version of K2 (same contract)."""
    dev = ids.device
    ids = ids.to(torch.int64)
    m0 = (ids >= 0) & (ids < S)
    if base_mask is not None:
        m0 = m0 & base_mask.to(torch.bool)
    idc = ids.clamp(0, S - 1)
    counts = torch.zeros((len(count_masks), S), dtype=torch.int64,
                         device=dev)
    for c, cm in enumerate(count_masks):
        m = m0 if cm is None else m0 & cm.to(torch.bool)
        counts[c] = torch.bincount(idc[m], minlength=S)
    sums = torch.zeros((len(sum_values), S), dtype=torch.int64, device=dev)
    for k, (v, sm) in enumerate(zip(sum_values, sum_masks)):
        m = m0 if sm is None else m0 & sm.to(torch.bool)
        sums[k].index_add_(0, idc[m], v.to(torch.int64)[m])
    return counts, sums


def mxu_group_reduce(ids, base_mask, count_masks, sum_specs, S):
    """Batched dense reductions in ONE pass over the data.

    count_masks -- one count output per entry (None entry = base_mask)
    sum_specs   -- (values, signed, bounds, mask or None) per sum output
    Returns ([counts (S,) int64...], [sums (S,) int64 bits...]).
    """
    counts, sums = dense_group_reduce(
        ids.contiguous(), _bool_or_none(base_mask),
        [_bool_or_none(m) for m in count_masks],
        [v.contiguous() for v, _, _, _ in sum_specs],
        [_bool_or_none(m) for _, _, _, m in sum_specs], S)
    return list(counts.unbind(0)), list(sums.unbind(0))


def mxu_counts_and_sums(ids: torch.Tensor, mask: torch.Tensor,
                        int_values: Sequence[Tuple[torch.Tensor, bool]],
                        S: int,
                        bounds: Sequence[Optional[Tuple[int, int]]] = ()
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """-> (counts (S,) int64, [sums (S,) int64 bits per value]).

    ids        -- slot per row, in [0, S) (rows with mask=False ignored)
    int_values -- list of (values, is_signed); any integer dtype
    bounds     -- accepted for the reference's signature; exact sums need
                  no bounds here
    """
    counts, sums = dense_group_reduce(
        ids.contiguous(), _bool_or_none(mask), [None],
        [v.contiguous() for v, _ in int_values], [None] * len(int_values),
        S)
    return counts[0], list(sums.unbind(0))


def _bool_or_none(m):
    return None if m is None else m.to(torch.bool).contiguous()

