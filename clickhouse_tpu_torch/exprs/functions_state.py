"""The functions of aggregate states (reference: finalizeAggregation,
clickhouse_tpu/exprs/functions.py:2482-2517; initializeAggregation and
runningAccumulate, functions_ext6.py:457-591).

* finalizeAggregation(st): each row's state unpacked (K19) and finalized
  as a group of its own.
* initializeAggregation('fState', v...): each row its own group
  (_PerRowGrouping: a reduction of a row is the row, or the op's identity
  where it is masked out), the states packed (K19).  The analyzer takes the
  result type from the literal name.
* runningAccumulate(st): the states merged cumulatively down the block,
  then finalized a row: a sum, min or max state is one K17 scan of one
  segment (a min or max over the rows whose state saw a row: M1), any
  other takes the first row's state, as the reference does.
"""
from __future__ import annotations

from typing import List

import torch

from ..core import dtypes as dt
from ..core.errors import NotImplementedError_, TypeError_
from ..ops import agg_ops, scan_ops
from .aggregates import (GroupContext, get_aggregate, make_merge_for_dtype,
                         unpack_states)
from .expr import ColVal
from .functions import register

__all__ = []


def _state_type(ts, fn: str) -> dt.DType:
    st = dt.remove_nullable(ts[0])
    if not dt.is_agg_state(st):
        raise TypeError_(f"{fn} expects an AggregateFunction(...) argument")
    return st


def _with_validity(a: ColVal, validity):
    if a.validity is None:
        return validity
    av = a.validity.to(torch.uint8)
    return av if validity is None else validity.to(torch.uint8) & av


def _resolve_finalize(ts):
    return make_merge_for_dtype(_state_type(ts, "finalizeAggregation")) \
        .result_type()


def _exec_finalize(args, out_dtype):
    a = args[0]
    m = make_merge_for_dtype(a.dtype)
    res = m.inner.finalize(unpack_states(m.inner, a.data))
    return ColVal(out_dtype, res[0], _with_validity(a, res[1]),
                  lengths=res[2] if len(res) > 2 else None)


register("finalizeAggregation", _resolve_finalize, _exec_finalize,
         case_insensitive=True)


class _PerRowGrouping:
    """A grouping where every row is its own group (initializeAggregation;
    the reference's functions_ext6._PerRowGrouping)."""
    kind = "perrow"
    row_valid_ref = None

    def __init__(self, cap: int, device):
        self.num_groups_cap = cap
        self.num_groups = torch.tensor(cap, dtype=torch.int64, device=device)
        self.perm = torch.arange(cap, dtype=torch.int32, device=device)
        self.group_ids = self.perm

    @staticmethod
    def _tensor(mask):
        return mask.tensor() if isinstance(mask, agg_ops.RowMask) else mask

    def _sort_mask(self, mask):
        return None if mask is None else self._tensor(mask).to(torch.bool)

    def count_rows(self, mask) -> torch.Tensor:
        return self._tensor(mask).to(torch.int64)

    def reduce(self, op: str, data, mask, *, unsigned=False):
        if mask is None:
            return data
        m = self._tensor(mask).to(torch.bool)
        if data.dim() == 2:
            m = m[:, None]
        if op in ("min", "max") and not unsigned:
            info = torch.finfo(data.dtype) if data.is_floating_point() \
                else torch.iinfo(data.dtype)
            ident = info.max if op == "min" else info.min
        elif op in ("min", "max"):            # UInt64 bits
            ident = -1 if op == "min" else 0
        else:
            ident = -1 if op == "band" else 0
        return torch.where(m, data, torch.full((), ident, dtype=data.dtype,
                                               device=data.device))

    def reduce_many(self, specs) -> List[torch.Tensor]:
        return [self.count_rows(m) if op == "count"
                else self.reduce(op, d, m, unsigned=u)
                for op, d, m, u in specs]


def _exec_initialize(args, out_dtype):
    name = args[0].host
    if not isinstance(name, str):
        raise TypeError_("initializeAggregation expects a constant "
                         "aggregate name")
    vals = list(args[1:])
    cap = max([a.data.shape[0] for a in vals if not a.is_const] or [1])
    vals = [a.broadcast(cap) for a in vals]
    agg, _ = get_aggregate(name, [a.dtype for a in vals])
    dev = vals[0].data.device if vals else torch.device("cpu")
    g = _PerRowGrouping(cap, dev)
    ctx = GroupContext(row_valid=torch.ones(cap, dtype=torch.bool,
                                            device=dev),
                       grouping=g, checks=[])
    states = agg.update(ctx, vals, None)
    if agg.two_step:
        states = agg.sorted_step(ctx, g, vals, None, states)
    fin = agg.finalize(states)
    return ColVal(out_dtype, fin[0], fin[1],
                  lengths=fin[2] if len(fin) > 2 else None)


register("initializeAggregation", lambda ts: dt.String, _exec_initialize)


def _resolve_running(ts):
    return make_merge_for_dtype(_state_type(ts, "runningAccumulate")) \
        .result_type()


def _exec_running(args, out_dtype):
    a = args[0]
    inner = make_merge_for_dtype(a.dtype).inner
    states = unpack_states(inner, a.data)
    try:
        ops = list(inner.merge_ops())
    except NotImplementedError_:          # uniq: a merge of its own
        ops = [("first", False)]
    if inner.keeps_presence:
        ops.append(("sum", False))
    seen = states[-1] > 0 if inner.keeps_presence else None
    acc = []
    for (op, unsigned), s in zip(ops, states):
        if op == "sum":
            acc.append(scan_ops.segmented_scan("sum", s, None).to(s.dtype))
        elif op in ("min", "max"):
            acc.append(scan_ops.segmented_scan(op, s, None, seen,
                                               unsigned=unsigned)
                       .to(s.dtype))
        else:                    # any and the rest: the first row's state
            acc.append(s[:1].expand(s.shape).contiguous())
    res = inner.finalize(acc)
    return ColVal(out_dtype, res[0], _with_validity(a, res[1]),
                  lengths=res[2] if len(res) > 2 else None)


register("runningAccumulate", _resolve_running, _exec_running)
