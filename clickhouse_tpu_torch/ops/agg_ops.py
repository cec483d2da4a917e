"""Grouping machinery for the trivial and dense GROUP BY kinds, and K1.

Reference: clickhouse_tpu/ops/agg_ops.py.  Two of its three grouping kinds
are in this port:

  * dense   -- provably-small key space (interval analysis): the slot is a
               mixed-radix function of the keys; counts and integer sums run
               in one pass of K2 (``mxu_segsum.dense_group_reduce``);
  * trivial -- GROUP BY (): masked whole-column reductions, K1
               (:func:`masked_reduce`).

The sort kind (``group_by_sort``, the reference's generic path) is not
ported yet and raises ``NotImplementedError_`` naming it.

Unsigned values ride as signed bit patterns (u16 in int32, u32 and u64 in
int64), so a reduction whose order matters for 64-bit unsigned values
(min/max) takes ``unsigned=True``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.errors import NotImplementedError_
from . import _native, mxu_segsum

__all__ = ["Grouping", "group_by_sort", "group_by_dense", "group_trivial",
           "masked_reduce"]

_OPS = {"sum": 0, "min": 1, "max": 2, "any": 3, "bor": 4, "band": 5,
        "bxor": 6}
_BITOPS = ("bor", "band", "bxor")
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_I64_MAX = (1 << 63) - 1


# -- K1: masked reduction ---------------------------------------------------

def masked_reduce(op: str, data: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *,
                  unsigned: bool = False) -> torch.Tensor:
    """Reduce the rows of `data` where `mask` holds (all rows if None).

    op: sum | min | max | any | bor | band | bxor.  Returns a 0-d tensor:
    int64 for integer and bool sums (wrapping mod 2^64), float64 for float
    sums, the data's dtype otherwise.  min/max/any/bit ops give 0 when no
    row is selected; `any` is the first selected row; float min/max order
    -0.0 below +0.0 and propagate NaN.  `unsigned` marks int64 data that
    holds UInt64 bits.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (csrc/masked_reduce.cu).
    """
    if op not in _OPS:
        raise ValueError(f"masked_reduce: unknown op {op!r}")
    if op in _BITOPS and data.is_floating_point():
        raise TypeError(f"masked_reduce: {op} needs integer data")
    unsigned = bool(unsigned) and data.dtype == torch.int64
    if data.device.type == "cpu":
        return _masked_reduce_plain(op, data, mask, unsigned)
    if data.device.type != "cuda":
        raise RuntimeError(f"masked_reduce: no kernel for {data.device}")
    return _masked_reduce_cuda(op, data, mask, unsigned)


def _masked_reduce_cuda(op, data, mask, unsigned):
    if data.dim() != 1 or not data.is_contiguous():
        raise ValueError("masked_reduce: data must be 1-d and contiguous")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != data.shape
                             or mask.device != data.device
                             or not mask.is_contiguous()):
        raise ValueError("masked_reduce: mask must be a contiguous bool "
                         "tensor of the data's shape and device")
    dev = data.device
    n = data.numel()
    if op == "sum":
        out_dtype = torch.float64 if data.is_floating_point() \
            else torch.int64
    else:
        out_dtype = data.dtype
    out = torch.empty((), dtype=out_dtype, device=dev)
    nb = _native.grid_blocks(dev, n)
    acc = torch.empty(3, dtype=torch.int64, device=dev)
    partials = torch.empty(nb, dtype=torch.float64, device=dev)
    lib = _native.library()
    rc = lib.chtt_masked_reduce(
        data.data_ptr(), _native.dtype_code(data.dtype),
        mask.data_ptr() if mask is not None else None, n, _OPS[op],
        int(unsigned), out.data_ptr(), acc.data_ptr(), partials.data_ptr(),
        nb, _native.stream_ptr(dev))
    _native.check(rc, "masked_reduce")
    _native.count_launch("masked_reduce", n)
    return out


def _f64_order_key(x: torch.Tensor) -> torch.Tensor:
    """Float -> int64 whose SIGNED order is the IEEE total order."""
    bits = x.to(torch.float64).view(torch.int64)
    return torch.where(bits < 0, bits ^ _I64_MAX, bits)


def _f64_order_unkey(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k < 0, k ^ _I64_MAX, k).view(torch.float64)


def _fold_bits(op: str, x: torch.Tensor, ident: int) -> torch.Tensor:
    """Bitwise OR/AND/XOR of all elements by pairwise halving."""
    fn = {"bor": torch.bitwise_or, "band": torch.bitwise_and,
          "bxor": torch.bitwise_xor}[op]
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_full((1,), ident)])
        x = fn(x[0::2], x[1::2])
    return x.reshape(()) if x.numel() else x.new_full((), ident)


def _masked_reduce_plain(op: str, data: torch.Tensor,
                         mask: Optional[torch.Tensor],
                         unsigned: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1 (same contract as masked_reduce)."""
    dev = data.device
    if mask is None:
        mask = torch.ones(data.shape, dtype=torch.bool, device=dev)
    mask = mask.to(torch.bool)
    selected = mask.any()
    zero = torch.zeros((), dtype=data.dtype, device=dev)
    if op == "sum":
        if data.is_floating_point():
            acc = data.to(torch.float64)
            return torch.where(mask, acc, torch.zeros_like(acc)).sum()
        acc = data.to(torch.int64)
        return torch.where(mask, acc, torch.zeros_like(acc)).sum()
    if op == "any":
        idx = torch.argmax(mask.to(torch.uint8))
        return torch.where(selected, data[idx], zero)
    if op in ("min", "max"):
        pick = torch.amin if op == "min" else torch.amax
        ident = _I64_MAX if op == "min" else -_I64_MAX - 1
        if data.is_floating_point():
            nan = (torch.isnan(data) & mask).any()
            key = _f64_order_key(data).masked_fill(
                ~mask | torch.isnan(data), ident)
            v = _f64_order_unkey(pick(key)).to(data.dtype)
            v = torch.where(nan, torch.full_like(v, float("nan")), v)
            return torch.where(selected, v, zero)
        key = data.to(torch.int64)
        if unsigned:
            key = key ^ _SIGN
        v = pick(key.masked_fill(~mask, ident))
        if unsigned:
            v = v ^ _SIGN
        return torch.where(selected, v.to(data.dtype), zero)
    ident = -1 if op == "band" else 0
    acc = data.to(torch.int64).masked_fill(~mask, ident)
    v = _fold_bits(op, acc, ident)
    return torch.where(selected, v.to(data.dtype), zero)


# -- groupings ---------------------------------------------------------------

@dataclasses.dataclass
class Grouping:
    """Group id of each (valid) row.

    kind='dense':   slot is a function of the key; rows keep their order;
                    empty slots possible (`present` mask).
    kind='trivial': single global group at slot 0.

    group_ids carry num_groups_cap for padding/invalid rows (dropped by all
    reductions).
    """
    kind: str
    group_ids: torch.Tensor            # int32
    num_groups: torch.Tensor           # 0-d int64
    unique_keys: List[torch.Tensor]    # each (num_groups_cap,)
    num_groups_cap: int
    present: Optional[torch.Tensor] = None     # (cap_g,) bool (dense only)

    def group_valid(self) -> torch.Tensor:
        if self.present is not None:
            return self.present
        return torch.arange(self.num_groups_cap, dtype=torch.int64,
                            device=self.group_ids.device) < self.num_groups

    # -- reductions ----------------------------------------------------------
    def reduce(self, op: str, data: torch.Tensor,
               mask: Optional[torch.Tensor], *,
               unsigned: bool = False) -> torch.Tensor:
        """Per-group reduction over the rows where `mask` holds."""
        if self.kind == "trivial":
            return self._reduce_trivial(op, data, mask, unsigned)
        return self._reduce_dense(op, data, mask)

    def count_rows(self, mask: torch.Tensor) -> torch.Tensor:
        """Rows per group (int64)."""
        if self.kind == "dense":
            return self.dense_counts(mask)
        return self.reduce("sum", mask, None)

    def _reduce_trivial(self, op, data, mask, unsigned=False):
        v = masked_reduce(op, data.contiguous(), _mask_arg(mask, data),
                          unsigned=unsigned)
        out = torch.zeros((self.num_groups_cap,), dtype=v.dtype,
                          device=v.device)
        out[0] = v
        return out

    def _reduce_dense(self, op, data, mask):
        if op != "sum":
            raise ValueError(f"dense grouping cannot reduce '{op}'")
        if data.is_floating_point():
            raise ValueError("dense grouping sums integers only")
        cap_g = self.num_groups_cap
        ids = torch.clamp(self.group_ids, max=cap_g - 1)
        m = mask & (self.group_ids < cap_g)
        _, sums = mxu_segsum.mxu_counts_and_sums(ids, m, [(data, True)],
                                                 cap_g)
        return sums[0]

    def dense_counts(self, mask) -> torch.Tensor:
        cap_g = self.num_groups_cap
        ids = torch.clamp(self.group_ids, max=cap_g - 1)
        m = mask & (self.group_ids < cap_g)
        counts, _ = mxu_segsum.mxu_counts_and_sums(ids, m, [], cap_g)
        return counts


def _mask_arg(mask, data):
    if mask is None:
        return None
    if mask.dim() == 0:
        mask = mask.expand(data.shape)
    return mask.to(torch.bool).contiguous()


def group_by_sort(keys: Sequence[torch.Tensor], row_valid: torch.Tensor,
                  num_groups_cap: int, secondary=(), payloads=()):
    """The sort grouping (unbounded keys) is not ported yet."""
    raise NotImplementedError_(
        "group_by_sort (GROUP BY over keys without proven small bounds, "
        "min/max under GROUP BY, or group_by_algorithm='sort') is not "
        "ported to the CUDA engine yet")


def group_by_dense(keys: Sequence[torch.Tensor],
                   dims: Sequence[Tuple[int, int]],
                   row_valid: torch.Tensor, num_groups_cap: int,
                   present: Optional[torch.Tensor] = None) -> Grouping:
    """Direct-array grouping: slot computed from the key.

    dims[i] = (lo_i, size_i) proven bounds per key array; the first key
    varies fastest.  `present`/num_groups are filled in by the caller from
    the dense counts.
    """
    cap = keys[0].shape[0]
    dev = keys[0].device
    slot = torch.zeros((cap,), dtype=torch.int64, device=dev)
    stride = 1
    total = 1
    for k, (lo, size) in zip(keys, dims):
        d = torch.clamp(k.to(torch.int64) - lo, 0, size - 1)
        slot = slot + d * stride
        stride *= size
        total *= size
    if total > num_groups_cap:
        raise ValueError("dense grouping exceeds capacity")
    ids = torch.where(row_valid, slot, num_groups_cap).to(torch.int32)
    uks = []
    idx = torch.arange(num_groups_cap, dtype=torch.int64, device=dev)
    stride = 1
    for k, (lo, size) in zip(keys, dims):
        uks.append(((idx // stride) % size + lo).to(k.dtype))
        stride *= size
    if present is None:
        present = torch.zeros((num_groups_cap,), dtype=torch.bool,
                              device=dev)
    return Grouping(kind="dense", group_ids=ids,
                    num_groups=present.to(torch.int64).sum(),
                    unique_keys=uks, num_groups_cap=num_groups_cap,
                    present=present)


def group_trivial(row_valid: torch.Tensor, num_groups_cap: int = 1024
                  ) -> Grouping:
    """GROUP BY (): one global group, plain masked reductions."""
    dev = row_valid.device
    gid = torch.where(row_valid, 0, num_groups_cap).to(torch.int32)
    num_groups = row_valid.any().to(torch.int64)
    uk = torch.zeros((num_groups_cap,), dtype=torch.int32, device=dev)
    return Grouping(kind="trivial", group_ids=gid, num_groups=num_groups,
                    unique_keys=[uk], num_groups_cap=num_groups_cap)
