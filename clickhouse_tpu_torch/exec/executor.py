"""Plan executor: runs the logical plan on device tensors (reference:
clickhouse_tpu/exec/executor.py).

Operators exchange *masked blocks* (full-capacity columns + a row validity
mask), so Filter is an AND and rows move only where an operator needs it
(aggregate, top-k).  Plans run eagerly, one torch operation or kernel at a
time; the first host synchronisation is ``materialize``.

The row mask stays in parts (``agg_ops.RowMask``: the scan's row count, a
Filter's ``column CMP literal`` terms over numeric columns, and a bool mask
for every other predicate) until a consumer needs a tensor.  GROUP BY ()
reductions and counts hand the parts to K1, which reads each term's column
in its narrow storage: ``SELECT count() FROM t WHERE x > c`` is one pass.
The route is chosen by the predicate's form alone.

Ported nodes: Scan, Filter, Project, Aggregate (GROUP BY (), dense and
sort GROUP BY), Sort (top-k for a LIMIT up to 4,096 rows, else a full
stable sort) and Limit.  Every other node, and every path of these nodes
that is not ported, raises ``NotImplementedError_`` naming it.

A GROUP BY whose groups may outnumber their slots (the sort grouping, at
most ``max_groups``) registers a capacity check; ``materialize`` reads the
group count there (its first host read) and raises ``CapacityError`` with
the count needed, which the session's autotuner retries with more slots.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.block import Block
from ..core.column import pad_to
from ..core.errors import CapacityError, NotImplementedError_
from ..core.settings import Settings
from ..exprs import aggregates as agg_reg
from ..exprs.expr import (DEVICE_KEY, BoundCall, BoundColumn, BoundLiteral,
                          ColVal, _literal_colval, colval_from_column,
                          evaluate)
from ..ops import _native, agg_ops, filter_ops, sort_ops
from ..plan import logical as L

__all__ = ["ExecBlock", "ExecContext", "execute_plan", "materialize"]


@dataclasses.dataclass
class ExecBlock:
    """A masked block: full-capacity columns + row mask."""
    cols: Dict[str, ColVal]        # field id -> ColVal
    rows: agg_ops.RowMask          # kept in parts until a tensor is needed
    capacity: int

    @property
    def valid(self) -> torch.Tensor:
        """The row mask as a bool (capacity,) tensor (built once)."""
        return self.rows.tensor()

    def env(self) -> Dict[str, ColVal]:
        env = dict(self.cols)
        env[DEVICE_KEY] = ColVal(dt.UInt8, torch.empty(
            0, dtype=torch.uint8, device=self.rows.device))
        return env


@dataclasses.dataclass
class Check:
    """A capacity to test at materialize: `value` (a device scalar) must
    not exceed `limit`; `setting` bounds the capacity (the session's
    autotuner retries with it raised)."""
    value: Any
    limit: int
    message: str
    setting: Optional[str] = None


class ExecContext:
    def __init__(self, table_blocks: Dict[Tuple[str, str], Block],
                 settings: Settings, device):
        self.table_blocks = table_blocks
        self.settings = settings
        self.device = torch.device(device)
        self.checks: List[Check] = []
        self.profile: Dict[str, int] = {}
        # interval-analysis facts: field id -> (lo, hi), filled at scans from
        # part minmax stats and propagated through projections
        self.field_bounds: Dict[str, Tuple[int, int]] = {}
        # device bytes a sort may take (the governor's budget less its
        # estimate); None: no limit
        self.memory_headroom: Optional[int] = None

    def count(self, name: str, value: int = 1):
        self.profile[name] = self.profile.get(name, 0) + value


# -- helpers -----------------------------------------------------------------

def _bool_mask(cv: ColVal, capacity: int) -> torch.Tensor:
    """Predicate ColVal -> bool mask (NULL -> False)."""
    cv = cv.broadcast(capacity)
    m = cv.data != 0
    if cv.validity is not None:
        m = m & cv.validity.to(torch.bool)
    return m


# comparison -> the same comparison with its arguments swapped
_CMP_SWAPPED = {"equals": "equals", "notEquals": "notEquals",
                "less": "greater", "greater": "less",
                "lessOrEquals": "greaterOrEquals",
                "greaterOrEquals": "lessOrEquals"}
_PLAIN_NUMERIC = {"Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16",
                  "UInt32", "UInt64", "Float32", "Float64"}


def _conjuncts(expr) -> list:
    """The operands of a (nested) AND; [expr] for any other predicate."""
    if isinstance(expr, BoundCall) and expr.name == "and":
        return [c for a in expr.args for c in _conjuncts(a)]
    return [expr]


def _filter_term(expr, env: Dict[str, ColVal],
                 capacity: int) -> Optional[agg_ops.Term]:
    """`column CMP literal` over a plain numeric column as a K1 term (the
    literal cast as _cmp_exec casts it), or None for any other form."""
    if not isinstance(expr, BoundCall) or expr.name not in _CMP_SWAPPED \
            or len(expr.args) != 2:
        return None
    a, b = expr.args
    cmp = expr.name
    if isinstance(a, BoundLiteral) and isinstance(b, BoundColumn):
        a, b, cmp = b, a, _CMP_SWAPPED[cmp]
    if not isinstance(a, BoundColumn) or not isinstance(b, BoundLiteral) \
            or b.value is None or b.dtype.nullable \
            or b.dtype.name not in _PLAIN_NUMERIC:
        return None
    cv = env.get(a.name)
    if cv is None or cv.dictionary is not None or cv.is_const \
            or dt.remove_nullable(cv.dtype).name not in _PLAIN_NUMERIC:
        return None
    col = cv.storage
    if col.dim() != 1 or col.shape[0] != capacity or (
            cv.validity is not None and cv.validity.shape != col.shape):
        return None
    logical = dt.remove_nullable(cv.dtype).np_dtype
    compare = np.promote_types(logical, b.dtype.np_dtype)
    lit = _literal_colval(b, torch.device("cpu"))
    constant = dt.cast_tensor(lit.data, b.dtype.np_dtype, compare).item()
    return agg_ops.Term(col, cv.validity, logical, cmp, compare, constant)


def _gather_colval(cv: ColVal, idx: torch.Tensor, capacity: int) -> ColVal:
    cv = cv.broadcast(capacity)
    data = cv.data[idx]
    validity = cv.validity[idx] if cv.validity is not None else None
    return ColVal(cv.dtype, data, validity, cv.dictionary)


def _arange(n: int, device, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


# -- node execution ----------------------------------------------------------

def execute_plan(node: L.PlanNode, ctx: ExecContext) -> ExecBlock:
    fn = _DISPATCH.get(type(node))
    if fn is None:
        raise NotImplementedError_(
            f"{type(node).__name__} is not ported to the CUDA engine yet")
    return fn(node, ctx)


def _exec_scan(node: L.ScanNode, ctx: ExecContext) -> ExecBlock:
    if node.final:
        raise NotImplementedError_(
            "SELECT ... FINAL is not ported to the CUDA engine yet")
    blk = ctx.table_blocks[(node.database, node.table)]
    cols = {}
    for f, storage_name in zip(node.schema, node.column_names):
        cols[f.id] = colval_from_column(blk[storage_name])
    cap = blk.capacity
    if node.column_stats:
        ctx.field_bounds.update(node.column_stats)
    n = int(blk.num_rows)
    ctx.count("rows_scanned", n)
    return ExecBlock(cols, agg_ops.RowMask(cap, ctx.device, n), cap)


def _exec_filter(node: L.FilterNode, ctx: ExecContext) -> ExecBlock:
    """AND the predicate into the row mask: each `column CMP literal`
    conjunct as a K1 term (up to K1's limit), the rest as a bool mask."""
    child = execute_plan(node.child, ctx)
    env = child.env()
    rows = child.rows
    for conj in _conjuncts(node.predicate):
        term = _filter_term(conj, env, child.capacity) \
            if len(rows.terms) < _native.K1_MAX_TERMS else None
        if term is not None:
            rows = rows.and_term(term)
        else:
            rows = rows.and_mask(_bool_mask(evaluate(conj, env),
                                            child.capacity))
    return ExecBlock(child.cols, rows, child.capacity)


def _exec_project(node: L.ProjectNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    from ..plan import ranges
    env = child.env()
    for name, cv0 in env.items():   # expose interval analysis to functions
        if cv0.bounds is None and name in ctx.field_bounds:
            cv0.bounds = ctx.field_bounds[name]
    cols = {}
    for f, e in zip(node.schema, node.exprs):
        cv = evaluate(e, env)
        cols[f.id] = cv.broadcast(child.capacity)
        b = ranges.infer_bounds(e, ctx.field_bounds)
        if b is not None:
            ctx.field_bounds[f.id] = b
    return ExecBlock(cols, child.rows, child.capacity)


def _agg_key_arrays(node: L.AggregateNode, child: ExecBlock,
                    ctx: ExecContext):
    """-> (key_cvs, key_arrays, dense_dims or None, global_agg).

    key_arrays are sort keys (sort_ops.SortKey): a Nullable key gives its
    validity and then its data zeroed where NULL; integer keys carry their
    proven bounds (narrowed to int32 where the bounds fit) and UInt64 keys
    their unsignedness; String keys are dictionary codes, floats sort by
    token."""
    from ..plan import ranges
    from ..ops.mxu_segsum import MAX_DENSE_GROUPS
    settings = ctx.settings
    cap = child.capacity
    key_cvs = [evaluate(e, child.env()) for _, e in node.keys]
    if not key_cvs:
        return key_cvs, [], None, True
    arrays: List[sort_ops.SortKey] = []
    dims: List = []
    dense_ok = True
    total = 1
    for (f, e), cv in zip(node.keys, key_cvs):
        cv = cv.broadcast(cap)
        data = cv.data
        if cv.validity is not None:
            v = cv.validity.to(torch.bool)
            data = torch.where(v, data, torch.zeros_like(data))
            arrays.append(sort_ops.SortKey(v, bounds=(0, 1)))
            dims.append((0, 2))
            total *= 2
        b = None
        if cv.dtype.is_dictionary:
            d = cv.dictionary
            b = (0, max(len(d) - 1, 0)) if d is not None else None
        elif cv.dtype.np_dtype.kind in ("i", "u", "b"):
            b = ranges.infer_bounds(e, ctx.field_bounds)
        # narrow 64-bit keys to i32 when bounds prove they fit
        if b is not None and not data.is_floating_point() \
                and data.element_size() == 8 \
                and -2**31 <= b[0] and b[1] < 2**31:
            data = data.to(torch.int32)
        unsigned = data.dtype == torch.int64 and not cv.dtype.is_dictionary \
            and dt.remove_nullable(cv.dtype).np_dtype == np.uint64
        arrays.append(sort_ops.SortKey(data, unsigned=unsigned, bounds=b))
        if b is None:
            dense_ok = False
            dims.append(None)
        else:
            size = b[1] - b[0] + 1
            dims.append((b[0], size))
            total *= size
    if not dense_ok or total <= 0 \
            or total > min(settings.max_groups, MAX_DENSE_GROUPS) \
            or settings.group_by_algorithm == "sort":
        dims = None
    return key_cvs, arrays, dims, False


def _exec_aggregate(node: L.AggregateNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    key_cvs, key_arrays, dims, global_agg = _agg_key_arrays(
        node, child, ctx)
    holistic = any(a.fn.holistic for a in node.aggregates)
    if holistic or not all(a.fn.sum_only for a in node.aggregates):
        dims = None          # dense grouping serves sum-family aggregates
    if node.with_totals:
        raise NotImplementedError_(
            "GROUP BY ... WITH TOTALS is not ported to the CUDA engine yet")
    return _aggregate_local(node, child, key_cvs, key_arrays, dims,
                            global_agg, ctx)


def _stage1(node: L.AggregateNode, child: ExecBlock,
            key_arrays: List[sort_ops.SortKey], dims, cap_g: int,
            ctx: ExecContext, global_agg: bool = False):
    """Local grouping + per-aggregate partial states."""
    cap = child.capacity
    from ..plan import ranges
    # GROUP BY () hands the row mask's parts to K1 and the sort grouping
    # to K4 (a scan's rows are sorted with no mask); the dense grouping
    # takes it as a tensor
    rows = child.valid if dims is not None else child.rows
    per_agg_inputs = []
    for item in node.aggregates:
        arg_cvs = []
        for a in item.args:
            cv = evaluate(a, child.env()).broadcast(cap)
            if cv.bounds is None:
                cv.bounds = ranges.infer_bounds(a, ctx.field_bounds)
            arg_cvs.append(cv)
        cond = None
        if item.cond is not None:
            cond = _bool_mask(evaluate(item.cond, child.env()), cap)
        premask = agg_reg.compose_row_mask(rows, arg_cvs, cond)
        per_agg_inputs.append((item, arg_cvs, cond, premask))

    if global_agg:
        # GROUP BY (): masked reductions (K1), never a sort
        grouping = agg_ops.group_trivial(ctx.device, cap_g)
    elif dims is not None:
        # provably-small key space: direct-array grouping (K2)
        grouping = agg_ops.group_by_dense([k.data for k in key_arrays],
                                          dims, rows, cap_g)
    else:
        # the generic path: a stable sort by the keys (K4, K5), then K6
        grouping = agg_ops.group_by_sort(key_arrays, rows, cap_g,
                                         max_bytes=ctx.memory_headroom)
    gctx = agg_reg.GroupContext(row_valid=rows, grouping=grouping)

    if grouping.kind == "dense":
        group_counts, states_per_agg = _dense_stage1(
            grouping, child, gctx,
            [(item, arg_cvs, cond)
             for item, arg_cvs, cond, _ in per_agg_inputs])
        grouping.present = group_counts > 0
        grouping.num_groups = grouping.present.to(torch.int64).sum()
        return grouping, group_counts, states_per_agg

    group_counts = grouping.count_rows(rows)
    if global_agg:
        grouping.num_groups = (group_counts[0] > 0).to(torch.int64)
    # a count over exactly the block's rows is the group count
    states_per_agg = [
        (item, arg_cvs,
         [group_counts] if isinstance(item.fn, agg_reg.CountAgg)
         and premask is rows else
         item.fn.update(dataclasses.replace(gctx, premask=premask),
                        arg_cvs, cond))
        for item, arg_cvs, cond, premask in per_agg_inputs]
    return grouping, group_counts, states_per_agg


def _dense_stage1(grouping, child: ExecBlock, gctx, per_agg_inputs):
    """All dense (sum-family) aggregates batched into ONE pass of K2."""
    from ..ops import mxu_segsum
    cap_g = grouping.num_groups_cap
    base = child.valid & (grouping.group_ids < cap_g)
    ids = torch.clamp(grouping.group_ids, max=cap_g - 1)

    count_masks: List = [None]           # [0] = the group row counts
    sum_specs: List = []
    plan = []                            # per agg: list of ('c'|'s', index)
    for item, arg_cvs, cond in per_agg_inputs:
        fn = item.fn
        mask = fn._row_mask(gctx, arg_cvs, cond)
        mask = None if mask is child.valid else mask
        if isinstance(fn, agg_reg.CountAgg):
            plan.append([("c", len(count_masks))])
            count_masks.append(mask)
        elif isinstance(fn, (agg_reg.SumAgg, agg_reg.AvgAgg)):
            v = fn._value(gctx, arg_cvs[0])
            sum_specs.append((v, True, arg_cvs[0].bounds, mask))
            steps = [("s", len(sum_specs) - 1)]
            if isinstance(fn, agg_reg.AvgAgg):
                steps.append(("c", len(count_masks)))
                count_masks.append(mask)
            plan.append(steps)
        else:
            raise NotImplementedError_(
                f"dense aggregation of {fn.name} is not ported")

    counts, sums = mxu_segsum.mxu_group_reduce(
        ids, base, count_masks, sum_specs, cap_g)

    states_per_agg = []
    for (item, arg_cvs, cond), steps in zip(per_agg_inputs, plan):
        states = [counts[ref] if kind == "c" else sums[ref]
                  for kind, ref in steps]
        states_per_agg.append((item, arg_cvs, states))
    return counts[0], states_per_agg


def _finalize(node: L.AggregateNode, key_cvs, unique_keys, num_groups,
              group_counts, states_per_agg, cap_g, global_agg,
              ctx: ExecContext, group_valid=None) -> ExecBlock:
    cols: Dict[str, ColVal] = {}
    ki = 0
    for (f, _), cv in zip(node.keys, key_cvs):
        if cv.validity is not None:
            uk_validity = unique_keys[ki].to(torch.uint8)
            ki += 1
        else:
            uk_validity = None
        uk = unique_keys[ki]
        ki += 1
        want = dt.remove_nullable(f.dtype).torch_dtype
        if not f.dtype.is_dictionary and uk.dtype != want \
                and not uk.is_floating_point():
            uk = uk.to(want)         # widen keys narrowed for grouping
        cols[f.id] = ColVal(f.dtype, uk, uk_validity, cv.dictionary)
    for item, arg_cvs, states in states_per_agg:
        out = item.fn.finalize(states)
        data, validity = out[0], out[1]
        if not isinstance(item.fn, agg_reg.CountAgg):
            data = torch.where(group_counts > 0, data, torch.zeros_like(data))
        dict_ = arg_cvs[0].dictionary if (item.args
                                          and item.field.dtype.is_dictionary) \
            else None
        cols[item.field.id] = ColVal(item.field.dtype, data, validity, dict_)
    if group_valid is None:
        if global_agg:
            num_groups = torch.clamp(num_groups, min=1)
        group_valid = _arange(cap_g, ctx.device) < num_groups
    return ExecBlock(cols, agg_ops.RowMask.of(group_valid), cap_g)


def _agg_capacity(child: ExecBlock, dims, global_agg: bool,
                  s: Settings) -> int:
    if global_agg:
        return 1024
    if dims is not None:
        total = 1
        for d in dims:
            total *= d[1]
        return pad_to(total)
    return pad_to(min(child.capacity, s.max_groups))


def _aggregate_local(node: L.AggregateNode, child: ExecBlock, key_cvs,
                     key_arrays, dims, global_agg: bool,
                     ctx: ExecContext) -> ExecBlock:
    s = ctx.settings
    cap_g = _agg_capacity(child, dims, global_agg, s)
    grouping, group_counts, states_per_agg = _stage1(
        node, child, key_arrays, dims, cap_g, ctx, global_agg)
    if not global_agg and dims is None:
        ctx.checks.append(Check(grouping.num_groups, cap_g,
                                "GROUP BY cardinality exceeded max_groups; "
                                "raise the max_groups setting",
                                setting="max_groups"))
    return _finalize(node, key_cvs, grouping.unique_keys,
                     grouping.num_groups, group_counts, states_per_agg,
                     cap_g, global_agg, ctx,
                     group_valid=None if global_agg
                     else grouping.group_valid())


def _token_for_sort(cv: ColVal, item: L.SortItem,
                    capacity: int) -> torch.Tensor:
    cv = cv.broadcast(capacity)
    rank = None
    dev = cv.data.device
    if cv.dtype.is_dictionary:
        d = cv.dictionary
        if d is not None and len(d):
            vals = d.values.astype(str)
            order = np.argsort(vals, kind="stable")
            r = np.empty(len(vals), np.int64)
            r[order] = np.arange(len(vals))
            rank = torch.from_numpy(r).to(dev)[cv.data.clamp(min=0).long()]
        else:
            rank = torch.zeros(cv.data.shape, dtype=torch.int64, device=dev)
    return sort_ops.order_token(
        cv.data, descending=item.descending, validity=cv.validity,
        nulls_last=item.nulls_last, rank=rank,
        unsigned=dt.is_unsigned(dt.remove_nullable(cv.dtype)))


def _exec_sort(node: L.SortNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    if any(i.fill is not None for i in node.items):
        raise NotImplementedError_(
            "ORDER BY ... WITH FILL is not ported to the CUDA engine yet")
    return _sort_block(node, child, ctx)


def _sort_block(node: L.SortNode, child: ExecBlock, ctx: ExecContext
                ) -> ExecBlock:
    cap = child.capacity
    n_valid = filter_ops.count_mask(child.rows)

    s = ctx.settings
    # tokens are built only on the path that reads them: eager torch, unlike
    # the reference's jit, would compute an unused token
    if (node.limit_hint is not None and len(node.items) == 1
            and node.limit_hint <= s.limit_pushdown_threshold
            and node.limit_hint < cap):
        k = int(node.limit_hint)
        it0 = node.items[0]
        cv0 = evaluate(it0.expr, child.env()).broadcast(cap)
        if k > sort_ops.MAX_TOPK:
            # above K3's k: the first k rows of the full stable sort, the
            # same rows by (invalid, token, row id)
            idx = sort_ops.sort_permutation(
                [_token_for_sort(cv0, it0, cap)], child.valid,
                max_bytes=ctx.memory_headroom)[:k]
        else:
            key32 = sort_ops.topk_key32(cv0, it0.descending)
            if key32 is not None and cap >= (1 << 16):
                idx = sort_ops.topk_permutation32(key32, child.valid, k)
            else:
                idx = sort_ops.topk_permutation(
                    _token_for_sort(cv0, it0, cap), child.valid, k)
        out_cap = pad_to(k)
        idx_full = torch.zeros((out_cap,), dtype=torch.int64,
                               device=ctx.device)
        idx_full[:k] = idx
        cols = {fid: _gather_colval(cv, idx_full, cap)
                for fid, cv in child.cols.items()}
        valid = _arange(out_cap, ctx.device) < torch.clamp(n_valid, max=k)
        return ExecBlock(cols, agg_ops.RowMask.of(valid), out_cap)

    # no top-k: the full stable multi-key sort (K4)
    tokens = [_token_for_sort(evaluate(i.expr, child.env()), i, cap)
              for i in node.items]
    perm = sort_ops.sort_permutation(tokens, child.valid,
                                     max_bytes=ctx.memory_headroom)
    cols = {fid: _gather_colval(cv, perm, cap)
            for fid, cv in child.cols.items()}
    valid = _arange(cap, ctx.device) < n_valid
    return ExecBlock(cols, agg_ops.RowMask.of(valid), cap)


def _exec_limit(node: L.LimitNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    rank = torch.cumsum(child.valid.to(torch.int64), 0) - 1
    keep = child.valid & (rank >= node.offset)
    if node.limit >= 0:
        keep = keep & (rank < node.offset + node.limit)
    return ExecBlock(child.cols, agg_ops.RowMask.of(keep), child.capacity)


_DISPATCH: Dict[type, Callable] = {
    L.ScanNode: _exec_scan,
    L.FilterNode: _exec_filter,
    L.ProjectNode: _exec_project,
    L.AggregateNode: _exec_aggregate,
    L.SortNode: _exec_sort,
    L.LimitNode: _exec_limit,
}


# -- materialization ---------------------------------------------------------

def materialize(block: ExecBlock, schema: List[L.Field],
                ctx: Optional[ExecContext] = None) -> Dict[str, np.ndarray]:
    """Pull the visible rows to host, in order (first host sync point),
    after testing the plan's capacity checks."""
    valid_np = block.valid.cpu().numpy()
    for check in (ctx.checks if ctx is not None else ()):
        actual = int(check.value)
        if actual > check.limit:
            raise CapacityError(f"{check.message} (needed {actual}, "
                                f"capacity {check.limit})",
                                setting=check.setting, needed=actual)
    out: Dict[str, np.ndarray] = {}
    for f in schema:
        cv = block.cols[f.id].broadcast(block.capacity)
        if cv.dtype.is_array or dt.is_composite(cv.dtype) \
                or cv.dtype.agg_state is not None:
            raise NotImplementedError_(
                f"{cv.dtype} results are not ported to the CUDA engine yet")
        data = dt.to_numpy_storage(
            cv.data, dt.remove_nullable(cv.dtype).np_dtype)[valid_np]
        if cv.dtype.is_dictionary:
            codes = data.astype(np.int64)
            vals = np.empty(len(codes), object)
            d = cv.dictionary
            ok = (codes >= 0) & (codes < (len(d) if d else 0))
            if d is not None and len(d):
                vals[ok] = d.values[codes[ok]]
            vals[~ok] = ""
            data = vals
        if cv.validity is not None:
            v = cv.validity.cpu().numpy()[valid_np]
            data = data.astype(object) if data.dtype != object \
                else data.copy()
            data[v == 0] = None
        from ..core import typed
        if typed.needs_decode(cv.dtype):
            data = typed.decode_for_display(cv.dtype, data)
        name = f.display
        if name in out:   # duplicate display names: disambiguate
            k = 1
            while f"{name}_{k}" in out:
                k += 1
            name = f"{name}_{k}"
        out[name] = data
    return out
