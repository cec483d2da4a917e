"""Out-of-core streaming and the memory governor (reference:
clickhouse_tpu/exec/streaming.py).

A table above ``max_device_block_bytes`` streams through the engine chunk
by chunk (ClickHouse's external aggregation).  The plan is split at the
aggregation:

    upper  (ORDER BY / HAVING / LIMIT / projections over the merged groups)
    -------- AggregateNode ----------------------------- breaker
    lower  (scan -> filter -> project -> probe-side joins)

and the lower part runs once a chunk (storage/table.py ChunkSource: one
physical layout for every chunk, the table's bounds in the plan, so every
chunk takes the same path).  Each chunk's groups and mergeable states
(exprs/aggregates.py ``merge``) are merged into a carry: a GROUP BY ()
carry over the trivial grouping (K1), a keyed one by regrouping carry ++
partials with the sort grouping (K4, K5) and K6.  The upper part runs on
the merged block (``BlockSourceNode``).  A probe-side join streams with
its build side read whole, once a chunk.

Host side: parts whose min/max refute the filter are never read
(``_prune_parts``; granules of the ORDER BY key's min/max within the
rest), and a selective filter over plain comparisons runs on the host
first (``host_prewhere_sel``), so only its rows cross the link.  Chunks
are encoded on reader threads (storage/read_pool.py, ``stream_readers``),
copied to the card on a stream of their own from page-locked memory by a
feeder thread, at most ``_PREFETCH_DEPTH`` chunks ahead of the one in use,
and a bit-packed column is unpacked there by K13 (ops/chunk_ops.py).

Ported: the aggregation split (StreamProgram).  Where the reference
streams through TopKProgram (ORDER BY ... LIMIT), CollectProgram (every
other shape, a holistic aggregate among them), a grace join (both join
sides above the threshold) or blow-up streaming (a cross join's
intermediate over the budget), the port raises ``NotImplementedError_``
naming that program.  The governor holds a plan that does not stream
against the device budget before it runs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.block import Block
from ..core.column import Column, pad_to
from ..core.errors import MemoryLimitExceeded, NotImplementedError_
from ..core.settings import Settings
from ..exprs.expr import ColVal
from ..ops import agg_ops, sort_ops
from ..ops.chunk_ops import unpack_pairs
from ..plan import logical as L

__all__ = ["estimate_plan_device_bytes", "effective_memory_budget",
           "estimate_plan_scan_bytes", "check_not_streamed",
           "cached_chars_bytes", "try_streaming", "StreamProgram",
           "find_split"]

_STREAM_KEY = "__stream__"

# join kinds safe to run on each probe-side chunk alone: every output row
# is decided by its probe row (RIGHT/FULL would need the build rows
# matched across chunks)
_STREAMABLE_JOIN_KINDS = ("inner", "left", "semi", "anti", "cross")
_GRACE_JOIN_KINDS = ("inner", "left", "semi", "anti")

# device chunks copied ahead of the one in use (the reference's
# _device_prefetch depth)
_PREFETCH_DEPTH = 2


def _collect_scans(node: L.PlanNode, out: List[L.ScanNode]) -> None:
    if isinstance(node, L.ScanNode):
        out.append(node)
    for c in node.children():
        _collect_scans(c, out)


def _scanned_columns(plan: L.PlanNode) -> Dict[Tuple[str, str], set]:
    scans: List[L.ScanNode] = []
    _collect_scans(plan, scans)
    cols: Dict[Tuple[str, str], set] = {}
    for s in scans:
        cols.setdefault((s.database, s.table), set()).update(s.column_names)
    return cols


# -- the governor ------------------------------------------------------------

def estimate_plan_scan_bytes(plan: L.PlanNode, catalog) -> int:
    """Bytes of every distinct scanned table (scanned columns only,
    narrow-storage aware)."""
    total = 0
    for key, cols in _scanned_columns(plan).items():
        t = catalog.get_table(*key)
        if t.num_rows:
            total += t.physical_bytes(cols)
    return total


def cached_chars_bytes(plan: L.PlanNode, blocks, device) -> int:
    """Device bytes of the string dictionaries' chars cached on `device`
    (Dictionary.device_chars) among the columns the plan scans: memory
    that a query reading them holds beside the estimate, whichever query
    built them.  blocks: (database, table) -> the scanned Block."""
    total, seen = 0, set()
    for key, cols in _scanned_columns(plan).items():
        blk = blocks[key]
        for c in cols:
            d = blk[c].dictionary
            if d is not None and id(d) not in seen:
                seen.add(id(d))
                total += d.cached_chars_bytes(device)
    return total


def _field_est_bytes(f: L.Field) -> int:
    t = f.dtype
    if t.is_dictionary:
        return 4
    if t.is_array:
        return 8 * 16            # heuristic: avg 16 elements per row
    if t.agg_state is not None:
        return 64
    return t.np_dtype.itemsize


def _subtree_rows(node: L.PlanNode, catalog, settings: Settings) -> int:
    """First-order output rows of a subtree (the reference's cap_of)."""
    if isinstance(node, L.ScanNode):
        return max(catalog.get_table(node.database, node.table).num_rows, 1)
    if isinstance(node, L.NumbersNode):
        return max(node.count, 1)
    kids = [_subtree_rows(c, catalog, settings) for c in node.children()]
    if isinstance(node, L.JoinNode):
        return kids[0] * kids[1] if node.kind == "cross" else max(kids[0], 1)
    if isinstance(node, L.AggregateNode):
        return min(kids[0], settings.max_groups)
    if isinstance(node, L.ArrayJoinNode):
        return kids[0] * 16
    if isinstance(node, L.UnionNode):
        return sum(kids)
    return max(kids) if kids else 1024


def estimate_plan_device_bytes(plan: L.PlanNode, catalog,
                               settings: Settings) -> int:
    """Scan bytes + the largest operator intermediate (capacity x row
    width), as the reference estimates.  Whether a GROUP BY sorts is known
    only when it runs, so a sort's working set is held against what this
    estimate leaves of the budget there (sort_ops.sort_rows'
    max_bytes)."""
    peak = 0

    def walk(n: L.PlanNode):
        nonlocal peak
        row = sum(_field_est_bytes(f) for f in n.schema)
        peak = max(peak, _subtree_rows(n, catalog, settings) * row)
        for c in n.children():
            walk(c)

    walk(plan)
    return estimate_plan_scan_bytes(plan, catalog) + peak


def effective_memory_budget(settings: Settings) -> int:
    """Device budget for the governor: max_device_memory_bytes, further
    capped by max_memory_usage when set."""
    budget = max(int(settings.max_device_memory_bytes), 1)
    if settings.max_memory_usage > 0:
        budget = min(budget, int(settings.max_memory_usage))
    return budget


def _stream_threshold(settings: Settings) -> int:
    thr = settings.max_device_block_bytes
    ext = settings.max_bytes_before_external_group_by
    if ext > 0:
        thr = min(thr, ext) if thr > 0 else ext
    return thr if thr > 0 else (2 << 30)


def _chunk_rows_for(table, columns, settings: Settings) -> int:
    if settings.stream_chunk_rows > 0:
        return pad_to(settings.stream_chunk_rows)
    n = max(table.num_rows, 1)
    row_bytes = max(table.physical_bytes(columns) // n, 1)
    return pad_to(min(settings.stream_chunk_bytes // row_bytes, n))


# -- the split ---------------------------------------------------------------

@dataclasses.dataclass
class StreamSplit:
    agg: L.AggregateNode
    upper: L.PlanNode             # the plan with agg as a BlockSourceNode
    scan: L.ScanNode              # the streamed scan
    big_key: Tuple[str, str]
    lower_scan_keys: List[Tuple[str, str]]   # small tables under the split
    upper_scan_keys: List[Tuple[str, str]]   # small tables above it
    path: Optional[list] = None   # root..scan
    lower_i: int = 0              # the streamable chain's head on path


@dataclasses.dataclass
class GenericSplit:
    """Where the reference streams without an aggregation breaker:
    kind "topk" (TopKProgram: ORDER BY ... LIMIT over the chain) or
    "collect" (CollectProgram: the chain's rows collected on the host).
    Detected only: the port raises naming the program."""
    kind: str
    scan: L.ScanNode
    big_key: Tuple[str, str]
    lower: L.PlanNode
    lower_scan_keys: List[Tuple[str, str]]
    upper_scan_keys: List[Tuple[str, str]]
    path: Optional[list] = None
    lower_i: int = 0


def _path_to(root: L.PlanNode, target: L.PlanNode
             ) -> Optional[List[L.PlanNode]]:
    if root is target:
        return [root]
    for c in root.children():
        p = _path_to(c, target)
        if p is not None:
            return [root] + p
    return None


def _replace_node(root: L.PlanNode, old: L.PlanNode,
                  new: L.PlanNode) -> L.PlanNode:
    """Clone the spine from root to `old`, swapping `old` for `new`."""
    if root is old:
        return new
    for f in dataclasses.fields(root):
        v = getattr(root, f.name)
        if isinstance(v, L.PlanNode):
            if _path_to(v, old) is not None:
                return dataclasses.replace(
                    root, **{f.name: _replace_node(v, old, new)})
        elif isinstance(v, list) and v and isinstance(v[0], L.PlanNode):
            for i, item in enumerate(v):
                if _path_to(item, old) is not None:
                    nv = list(v)
                    nv[i] = _replace_node(item, old, new)
                    return dataclasses.replace(root, **{f.name: nv})
    raise AssertionError("old node not under root")


def _stream_path(plan: L.PlanNode, big_key: Tuple[str, str]):
    """-> (scan, path root..scan, index j of the highest ancestor of the
    scan that runs on each chunk alone), or None.  The chain is Filter,
    Project and joins with the scan on their probe (left) side."""
    scans: List[L.ScanNode] = []
    _collect_scans(plan, scans)
    big = [s for s in scans if (s.database, s.table) == big_key]
    if len(big) != 1 or big[0].final:
        return None                       # FINAL folds need the whole table
    scan = big[0]
    path = _path_to(plan, scan)
    j = len(path) - 1
    for i in range(len(path) - 2, -1, -1):
        node = path[i]
        if isinstance(node, (L.FilterNode, L.ProjectNode)) or (
                isinstance(node, L.JoinNode) and node.left is path[i + 1]
                and node.kind in _STREAMABLE_JOIN_KINDS):
            j = i
            continue
        break
    return scan, path, j


def _scan_keys(node: L.PlanNode, skip=None) -> List[Tuple[str, str]]:
    scans: List[L.ScanNode] = []
    _collect_scans(node, scans)
    return [(s.database, s.table) for s in scans if s is not skip]


def find_split(plan: L.PlanNode, big_key: Tuple[str, str]
               ) -> Optional[StreamSplit]:
    """The aggregation breaker for streaming the scan of big_key, or None
    (no aggregation over the chain, WITH TOTALS, a holistic aggregate, a
    composite result)."""
    r = _stream_path(plan, big_key)
    if r is None:
        return None
    scan, path, j = r
    if j == 0:
        return None
    agg = path[j - 1]
    if not isinstance(agg, L.AggregateNode) or agg.with_totals:
        return None
    if any(a.fn.holistic for a in agg.aggregates):
        return None                       # needs each group's raw rows
    if any(dt.is_composite(f.dtype) for f in agg.schema):
        return None
    upper = _replace_node(plan, agg,
                          L.BlockSourceNode(agg.schema, _STREAM_KEY))
    return StreamSplit(agg, upper, scan, big_key,
                       _scan_keys(agg.child, scan), _scan_keys(upper),
                       path, j)


def find_generic_split(plan: L.PlanNode, big_key: Tuple[str, str],
                       settings: Settings) -> Optional[GenericSplit]:
    """Where the reference streams any other shape (its
    find_generic_split): top-k where the chain feeds ORDER BY with an
    effective LIMIT up to stream_topk_max, collect otherwise."""
    r = _stream_path(plan, big_key)
    if r is None:
        return None
    scan, path, j = r
    lower = path[j]
    if any(dt.is_composite(f.dtype) or f.dtype.agg_state is not None
           for f in lower.schema):
        return None
    keys = _scan_keys(lower, scan)
    parent = path[j - 1] if j > 0 else None
    kind = "collect"
    if isinstance(parent, L.SortNode) and parent.child is lower \
            and not any(i.fill is not None for i in parent.items):
        k = parent.limit_hint
        if k is None and j >= 2 and isinstance(path[j - 2], L.LimitNode) \
                and path[j - 2].limit >= 0:
            k = path[j - 2].limit + path[j - 2].offset
        if k is not None and 0 < k <= settings.stream_topk_max:
            kind = "topk"
    breaker = parent if kind == "topk" else lower
    upper = L.BlockSourceNode(breaker.schema, _STREAM_KEY) \
        if breaker is plan else _replace_node(
            plan, breaker, L.BlockSourceNode(breaker.schema, _STREAM_KEY))
    return GenericSplit(kind, scan, big_key, lower, keys, _scan_keys(upper),
                        path, j)


# -- grace joins and blow-up streaming: detection ----------------------------

def _colmap(node: L.PlanNode) -> Dict[str, tuple]:
    """field id -> (ScanNode, storage column) through Filter/Project
    renames and joins (the grace join's key columns)."""
    from ..exprs.expr import BoundColumn
    if isinstance(node, L.ScanNode):
        return {f.id: (node, nm)
                for f, nm in zip(node.schema, node.column_names)}
    if isinstance(node, L.FilterNode):
        return _colmap(node.child)
    if isinstance(node, L.ProjectNode):
        m = _colmap(node.child)
        return {f.id: m[e.name] for f, e in zip(node.schema, node.exprs)
                if isinstance(e, BoundColumn) and e.name in m}
    if isinstance(node, L.JoinNode):
        m = dict(_colmap(node.left))
        m.update(_colmap(node.right))
        return m
    return {}


def _detect_grace(split, scan: L.ScanNode, catalog, thr: int):
    """The chain's join whose build side is above the threshold (the
    reference's grace join), as (its build table's key or None,
    compatible: whether the reference can stream the plan at all)."""
    from ..exprs.expr import BoundColumn
    path, j = split.path, split.lower_i
    graces = []
    for i in range(j, len(path) - 1):
        node = path[i]
        if not isinstance(node, L.JoinNode):
            continue
        rscans: List[L.ScanNode] = []
        _collect_scans(node.right, rscans)
        over = []
        for s in rscans:
            t = catalog.get_table(s.database, s.table)
            if t.num_rows and t.physical_bytes(set(s.column_names)) > thr:
                over.append(s)
        if not over:
            continue
        if len(over) != 1 or not isinstance(node.right, L.ScanNode) \
                or node.kind not in _GRACE_JOIN_KINDS \
                or node.asof_left is not None or not node.left_keys \
                or node.right.final:
            return None, False
        bscan = node.right
        lmap = _colmap(node.left)
        bmap = {f.id: nm for f, nm in zip(bscan.schema, bscan.column_names)}
        big_t = catalog.get_table(scan.database, scan.table)
        build_t = catalog.get_table(bscan.database, bscan.table)
        for le, re_ in zip(node.left_keys, node.right_keys):
            if not (isinstance(le, BoundColumn)
                    and isinstance(re_, BoundColumn)):
                return None, False
            lm, rn = lmap.get(le.name), bmap.get(re_.name)
            if lm is None or lm[0] is not scan or rn is None:
                return None, False
            if big_t.schema[lm[1]].is_dictionary \
                    != build_t.schema[rn].is_dictionary:
                return None, False
        graces.append((bscan.database, bscan.table))
    if len(graces) > 1:
        return None, False
    return (graces[0] if graces else None), True


def _chain_blowup(split, catalog, settings: Settings) -> Tuple[int, int]:
    """-> (output rows a probe row, widest row bytes) over the chain
    between the breaker and the streamed scan."""
    f, row = 1, 8
    for i in range(split.lower_i, len(split.path) - 1):
        node = split.path[i]
        row = max(row, sum(_field_est_bytes(fl) for fl in node.schema))
        if isinstance(node, L.JoinNode) and node.kind == "cross" \
                and node.left is split.path[i + 1]:
            f *= _subtree_rows(node.right, catalog, settings)
    return f, row


def _blowup_chunk_rows(split, catalog, settings: Settings,
                       chunk_rows: int, probe_rows: int) -> int:
    """The reference's chunk for an expanding join's chain; raises
    MemoryLimitExceeded where one joined block cannot fit the budget."""
    f, row = _chain_blowup(split, catalog, settings)
    if f <= 1:
        return chunk_rows
    budget = effective_memory_budget(settings)
    mjbsr = max(int(settings.max_joined_block_size_rows), 1)
    blk = max(min(mjbsr, f * max(probe_rows, 1)), pad_to(1) * f)
    if blk * row > budget * 2:
        raise MemoryLimitExceeded(
            f"expanding join emits blocks of ~{blk} rows "
            f"(~{(blk * row) >> 20} MiB each; "
            f"max_joined_block_size_rows={mjbsr}), over the "
            f"{budget >> 20} MiB memory budget")
    return pad_to(min(chunk_rows, max((budget // 2) // (f * row), 1)))


def _check_streamable(table, columns) -> None:
    """NotStreamable where ChunkSource would refuse a column."""
    from ..storage.table import check_streamable
    for name in columns:
        check_streamable(table, name)


def _not_ported(program: str, what: str) -> NotImplementedError_:
    return NotImplementedError_(
        f"streaming {what} through {program} is not ported to the CUDA "
        f"engine yet")


def check_not_streamed(split, grace_key) -> None:
    """Raise NotImplementedError_ naming the program through which the
    reference would stream a split that is not the aggregation's: a grace
    join (grace_key: the build table above the threshold), TopKProgram
    or CollectProgram (a holistic aggregate's plan among them)."""
    if grace_key is not None:
        raise _not_ported("a grace join",
                          f"the build side {'.'.join(grace_key)}")
    if isinstance(split, GenericSplit):
        if split.kind == "topk":
            raise _not_ported("TopKProgram", "ORDER BY ... LIMIT")
        holistic = [a.fn.name for n in split.path
                    if isinstance(n, L.AggregateNode)
                    for a in n.aggregates if a.fn.holistic]
        raise _not_ported("CollectProgram", "this plan shape" + (
            f" (the holistic aggregate {holistic[0]})" if holistic else ""))


def blowup_would_stream(session, plan: L.PlanNode, settings: Settings):
    """After the governor refuses a plan: raise NotImplementedError_ where
    the reference would chunk the probe side of an expanding join (its
    try_blowup_streaming: stored scans, largest first, then numbers()
    sources of at most 2^27 rows), MemoryLimitExceeded where it refuses
    one joined block; return where neither applies."""
    from ..storage.table import NotStreamable, _narrow_itemsize
    catalog = session.catalog
    budget = effective_memory_budget(settings)
    if estimate_plan_device_bytes(plan, catalog, settings) <= budget:
        return
    cands, seen = [], set()
    scans: List[L.ScanNode] = []
    _collect_scans(plan, scans)
    for s in scans:
        key = (s.database, s.table)
        if key not in seen:
            seen.add(key)
            t = catalog.get_table(*key)
            cands.append((t.physical_bytes(set(s.column_names))
                          if t.num_rows else 0, None, key))
    cands.sort(key=lambda c: -c[0])
    nums: List[L.NumbersNode] = []

    def walk(n):
        if isinstance(n, L.NumbersNode):
            nums.append(n)
        for c in n.children():
            walk(c)
    walk(plan)
    cands += [(0, nn, None) for nn in nums if nn.count <= 1 << 27]
    for _, nn, key in cands:
        if nn is not None:
            key = ("_stream_tmp", f"numbers_{nn.start}_{nn.count}")
            plan2 = _replace_node(plan, nn, L.ScanNode(
                key[0], key[1], list(nn.schema), ["number"]))
            rows = nn.count
            width = _narrow_itemsize(np.dtype(np.uint64), (
                nn.start, nn.start + max(nn.count - 1, 0)))
            chunk = pad_to(settings.stream_chunk_rows) \
                if settings.stream_chunk_rows > 0 else pad_to(
                    min(settings.stream_chunk_bytes // width, max(rows, 1)))
            other = estimate_plan_scan_bytes(plan, catalog)
        else:
            plan2 = plan
            table = catalog.get_table(*key)
        split = find_split(plan2, key) \
            or find_generic_split(plan2, key, settings)
        if split is None:
            continue
        if nn is None:
            columns = list(split.scan.column_names)
            try:
                _check_streamable(table, columns)
            except NotStreamable:
                continue
            rows = table.num_rows
            chunk = _chunk_rows_for(table, columns, settings)
            other = estimate_plan_scan_bytes(plan, catalog) - (
                table.physical_bytes(set(columns)) if table.num_rows else 0)
        chunk = _blowup_chunk_rows(split, catalog, settings, chunk, rows)
        f, row = _chain_blowup(split, catalog, settings)
        if other + chunk * max(f, 1) * row <= budget * 2:
            raise _not_ported("blow-up streaming",
                              "an expanding join's probe side")


# -- pruning on the host -----------------------------------------------------

def _scan_filters(lower_root: L.PlanNode, scan: L.ScanNode) -> list:
    """The predicates of the chain's filters whose only source is the
    streamed scan."""
    preds = []

    def walk(n):
        if isinstance(n, L.FilterNode):
            ss: List[L.ScanNode] = []
            _collect_scans(n, ss)
            if len(ss) == 1 and ss[0] is scan:
                preds.append(n.predicate)
        for c in n.children():
            walk(c)

    walk(lower_root)
    return preds


def _count(session, name: str, value: int) -> None:
    session.profile_events[name] = \
        session.profile_events.get(name, 0) + value


def _prune_parts(lower_root: L.PlanNode, scan: L.ScanNode, table, session):
    """Part-level min/max pruning of the streamed scan (KeyCondition's
    role): parts whose stats refute a filter are never read.  -> (the
    surviving parts' indices or None for all, granule spans or None)."""
    from ..plan import ranges as R
    preds = _scan_filters(lower_root, scan)
    if not preds:
        return None, None
    col_of = {f.id: nm for f, nm in zip(scan.schema, scan.column_names)}
    keep = []
    for i, p in enumerate(table.parts):
        fb = {}
        for fid, nm in col_of.items():
            mm = p.minmax.get(nm)
            t = table.schema.get(nm)
            if mm is not None and t is not None \
                    and t.np_dtype.kind in ("i", "u"):
                fb[fid] = (int(mm[0]), int(mm[1]))
        if all(R.predicate_may_hold(pr, fb) for pr in preds):
            keep.append(i)
    pruned = len(table.parts) - len(keep)
    part_idx = None
    if pruned:
        _count(session, "PrunedParts", pruned)
        part_idx = tuple(keep)
    return part_idx, _prune_granules(preds, col_of, table, keep, session)


def _prune_granules(preds, col_of, table, part_indices, session):
    """Granule pruning within the surviving parts by the min/max of the
    table's first ORDER BY column (the primary index's implicit minmax
    skip index; the port's CREATE TABLE takes no other skip index).
    -> ((position in the surviving parts, lo, hi), ...) or None."""
    from ..plan import ranges as R
    order = [c for c in (table.order_by or []) if c in table.schema][:1]
    order = [c for c in order if c in col_of.values()
             and table.schema[c].np_dtype.kind in ("i", "u")]
    if not order:
        return None
    col = order[0]
    fid = next(f for f, nm in col_of.items() if nm == col)
    g = max(int(getattr(table, "index_granularity", 8192)), 1)
    spans, pruned = [], 0
    for pos, pi in enumerate(part_indices):
        p = table.parts[pi]
        n = p.num_rows
        if n == 0:
            continue
        mm = p.granule_minmax(col, g)
        keep = np.asarray([all(R.predicate_may_hold(
            pr, {fid: (int(lo), int(hi))}) for pr in preds)
            for lo, hi in mm], bool)
        if keep.all():
            spans.append((pos, 0, n))
            continue
        pruned += int((~keep).sum())
        gi = 0
        while gi < len(keep):          # kept granules, merged into spans
            if not keep[gi]:
                gi += 1
                continue
            gj = gi
            while gj + 1 < len(keep) and keep[gj + 1]:
                gj += 1
            spans.append((pos, gi * g, min((gj + 1) * g, n)))
            gi = gj + 1
    if not pruned:
        return None
    _count(session, "PrunedGranules", pruned)
    return tuple(spans)


class _NotHostEval(Exception):
    pass


# operators whose numpy semantics match the engine's (comparisons, boolean
# algebra, wrapping integer arithmetic); the rest stay on the device, where
# the filter runs again over the rows the host kept
_HOST_CMP = {"equals": np.equal, "notequals": np.not_equal,
             "greater": np.greater, "less": np.less,
             "greaterorequals": np.greater_equal,
             "lessorequals": np.less_equal}
_HOST_ARITH = {"plus": np.add, "minus": np.subtract,
               "multiply": np.multiply}


def _host_eval(e, cols):
    """A bound predicate over raw host part columns; raises _NotHostEval
    outside the subset whose results are the engine's."""
    from ..exprs.expr import (BoundCall, BoundColumn, BoundInList,
                              BoundLiteral)
    if isinstance(e, BoundColumn):
        a = cols.get(e.name)
        if a is None or a.dtype == object or a.dtype.kind not in "iufb":
            raise _NotHostEval
        return a
    if isinstance(e, BoundLiteral):
        if isinstance(e.value, (bool, int, float, np.number)):
            return e.value
        raise _NotHostEval
    if isinstance(e, BoundInList):
        base = _host_eval(e.arg, cols)
        vals = np.asarray(e.values)
        if vals.dtype == object or vals.dtype.kind not in "iufb":
            raise _NotHostEval
        m = np.isin(base, vals)
        return ~m if e.negated else m
    if isinstance(e, BoundCall):
        n = e.name.lower()
        if n in _HOST_CMP and len(e.args) == 2:
            return _HOST_CMP[n](_host_eval(e.args[0], cols),
                                _host_eval(e.args[1], cols))
        if n in _HOST_ARITH and len(e.args) == 2:
            with np.errstate(over="ignore"):
                return _HOST_ARITH[n](_host_eval(e.args[0], cols),
                                      _host_eval(e.args[1], cols))
        if n in ("and", "or"):
            out = None
            for a in e.args:
                v = _host_eval(a, cols)
                out = v if out is None else (out & v if n == "and"
                                             else out | v)
            return out
        if n == "not" and len(e.args) == 1:
            return ~np.asarray(_host_eval(e.args[0], cols), bool)
    raise _NotHostEval


def _pred_conjuncts(pred):
    from ..exprs.expr import BoundCall
    if isinstance(pred, BoundCall) and pred.name == "and":
        for a in pred.args:
            yield from _pred_conjuncts(a)
    else:
        yield pred


def host_prewhere_sel(lower_root: L.PlanNode, scan: L.ScanNode, table,
                      part_idx, spans, session, settings):
    """Host PREWHERE for a streamed scan (MergeTreeRangeReader's two-pass
    read for the host->device link): the conjuncts of _HOST_CMP /
    _HOST_ARITH run over the host parts, and only their rows are read;
    the device filter runs again over them.  -> (a row selection a
    surviving part, its cache key), or (None, None) where nothing is
    host-evaluable or more than 7/8 of the rows survive."""
    if not settings.optimize_move_to_prewhere:
        return None, None
    conjs = [c for p in _scan_filters(lower_root, scan)
             for c in _pred_conjuncts(p)]
    if not conjs:
        return None, None
    col_of = {f.id: nm for f, nm in zip(scan.schema, scan.column_names)}
    parts = table.parts if part_idx is None \
        else [table.parts[i] for i in part_idx]
    spans_of: Dict[int, list] = {}
    for pi, lo, hi in spans or ():
        spans_of.setdefault(pi, []).append((lo, hi))
    sel, total, kept, any_eval = [], 0, 0, False
    for pi, p in enumerate(parts):
        idxs = []
        for lo, hi in (spans_of.get(pi, []) if spans is not None
                       else [(0, p.num_rows)]):
            if hi <= lo:
                continue
            total += hi - lo
            cols = {fid: (p.columns[nm][lo:hi] if nm in p.columns else None)
                    for fid, nm in col_of.items()}
            mask = None
            for c in conjs:
                try:
                    m = np.asarray(_host_eval(c, cols), bool)
                except _NotHostEval:
                    continue
                any_eval = True
                mask = m if mask is None else mask & m
            w = np.arange(lo, hi, dtype=np.int64) if mask is None \
                else np.nonzero(mask)[0] + lo
            idxs.append(w)
            kept += len(w)
        sel.append(np.concatenate(idxs) if idxs else np.zeros(0, np.int64))
    if not any_eval or total == 0 or kept * 8 > total * 7:
        return None, None
    _count(session, "PrewhereStreamedScans", 1)
    _count(session, "PrewhereRowsDropped", total - kept)
    h = hashlib.sha1()
    for x in sel:
        h.update(x.tobytes())
    return sel, ("prewhere", h.hexdigest(), part_idx, spans)


# -- the per-chunk program ---------------------------------------------------

def _carry_cap(split: StreamSplit, table, settings: Settings) -> int:
    """The carry's group slots: the keys' proven cardinality where
    interval analysis bounds it (x % 1024 carries 1,024 groups), else
    min(rows, max_groups).  Sound either way: the merged groups are
    checked against it (CapacityError -> the autotuner re-plans)."""
    if not split.agg.keys:
        return 1024
    from ..plan import ranges as R
    fb: Dict[str, Tuple[int, int]] = {}

    def walk(n):
        if isinstance(n, L.ScanNode) and n.column_stats:
            fb.update(n.column_stats)
        for c in n.children():
            walk(c)

    walk(split.agg.child)
    total = 1
    for f, e in split.agg.keys:
        b = R.infer_bounds(e, fb)
        span = None if b is None else int(b[1]) - int(b[0]) + 1
        if span is None or span <= 0 or span > (1 << 22):
            total = None
            break
        total *= span * (2 if f.dtype.nullable else 1)
        if total > settings.max_groups:
            total = None
            break
    if total is not None:
        return pad_to(min(max(total, 1), settings.max_groups))
    return pad_to(min(table.num_rows, settings.max_groups))


@dataclasses.dataclass
class _Partial:
    """One chunk's (or the carry's) groups and states: key arrays, the
    groups that exist, and each state's tensor (slot 0: the row counts)."""
    keys: List[torch.Tensor]
    valid: torch.Tensor
    states: List[torch.Tensor]


def _stage1_on_chunk(split: StreamSplit, ctx, struct: dict) -> _Partial:
    """The lower plan over one chunk -> its groups' mergeable states."""
    from .executor import _agg_capacity, _agg_key_arrays, _stage1
    agg = split.agg
    child = _run(agg.child, ctx)
    key_cvs, key_arrays, dims, global_agg = _agg_key_arrays(agg, child, ctx)
    if not all(a.fn.sum_only for a in agg.aggregates):
        dims = None
    cap_g = _agg_capacity(child, dims, global_agg, ctx.settings)
    grouping, counts, states_per_agg = _stage1(
        agg, child, key_arrays, dims, cap_g, ctx, global_agg)
    # a state met twice (count()'s is the group counts) is carried once
    flat: List[torch.Tensor] = [counts]
    slots: List[List[int]] = []
    for _, _, states in states_per_agg:
        idx = []
        for st in states:
            at = next((i for i, t in enumerate(flat) if t is st), None)
            if at is None:
                at = len(flat)
                flat.append(st)
            idx.append(at)
        slots.append(idx)
    if not struct:
        struct.update(
            slots=slots, items=[item for item, _, _ in states_per_agg],
            sort_keys=[(k.unsigned, k.bounds) for k in key_arrays],
            key_meta=[(cv.broadcast(child.capacity).validity is not None,
                       cv.dictionary) for cv in key_cvs],
            agg_dicts=[arg_cvs[0].dictionary if arg_cvs else None
                       for _, arg_cvs, _ in states_per_agg],
            global_agg=global_agg, cap_g=cap_g,
            lower_checks=[(c.limit, c.message, c.setting)
                          for c in ctx.checks])
    struct["chunk_groups"] = grouping.num_groups if "chunk_groups" not in \
        struct else torch.maximum(struct["chunk_groups"],
                                  grouping.num_groups)
    vals = [torch.as_tensor(c.value, dtype=torch.int64, device=ctx.device)
            for c in ctx.checks]
    struct["lower_vals"] = vals if "lower_vals" not in struct else [
        torch.maximum(a, b) for a, b in zip(struct["lower_vals"], vals)]
    return _Partial(list(grouping.unique_keys), grouping.group_valid(),
                    flat)


def _run(node: L.PlanNode, ctx):
    from .executor import execute_plan
    return execute_plan(node, ctx)


def _widen(p: _Partial, cap_c: int) -> _Partial:
    """Stage-1 outputs padded from their slots to the carry's."""
    pad = cap_c - p.valid.shape[0]
    if pad <= 0:
        return p

    def grow(t):
        return torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]),
                                         dtype=t.dtype, device=t.device)])
    return _Partial([grow(k) for k in p.keys], grow(p.valid),
                    [grow(s) for s in p.states])


def _merge_carry(carry: _Partial, part: _Partial, struct: dict,
                 cap_c: int, device) -> Tuple[_Partial, torch.Tensor]:
    """carry ++ a chunk's partial states -> the merged carry and its group
    count: GROUP BY () over the trivial grouping (one group: no sort), a
    keyed carry regrouped by the sort grouping (K4, K5); every state's
    merge in one reduce_many (K6), argMin/argMax's after it."""
    valid = torch.cat([carry.valid, part.valid])
    states = [torch.cat([c, s.to(c.dtype)])
              for c, s in zip(carry.states, part.states)]
    if struct["global_agg"]:
        g = agg_ops.group_trivial(device, cap_c)
        mask = valid
    else:
        keys = [sort_ops.SortKey(torch.cat([ck, uk.to(ck.dtype)]),
                                 unsigned=u, bounds=b)
                for ck, uk, (u, b) in zip(carry.keys, part.keys,
                                          struct["sort_keys"])]
        g = agg_ops.group_by_sort(keys, valid, cap_c)
        mask = g.row_valid_ref
    # one reduction a distinct (op, state, mask): count()'s state is the
    # group count's
    specs, index, plan = [], {}, []

    def at(spec) -> int:
        key = (spec[0], id(spec[1]), id(spec[2]), spec[3])
        if key not in index:
            index[key] = len(specs)
            specs.append(spec)
        return index[key]

    at(("sum", states[0], mask, False))
    for item, idx in zip(struct["items"], struct["slots"]):
        own = [states[i] for i in idx]
        if item.fn.two_step:
            plan.append(("own", item.fn.merge(own, g, mask)))
        else:
            plan.append(("specs", [at(x) for x in
                                   item.fn.merge_specs(own, mask)]))
    merged = g.reduce_many(specs)
    out_states: List[Optional[torch.Tensor]] = [merged[0]] + \
        [None] * (len(states) - 1)
    for (how, got), idx in zip(plan, struct["slots"]):
        vals = got if how == "own" else [merged[j] for j in got]
        for i, v in zip(idx, vals):
            out_states[i] = v
    if struct["global_agg"]:
        n = (merged[0][0] > 0).to(torch.int64)
        keys_out = [torch.zeros(cap_c, dtype=torch.int32, device=device)]
        gvalid = torch.arange(cap_c, device=device) < n
    else:
        n, keys_out, gvalid = g.num_groups, list(g.unique_keys), \
            g.group_valid()
    return _Partial(keys_out, gvalid, out_states), n


# -- chunks to the device ----------------------------------------------------

def _device_prefetch(it, depth: int, stats: dict, device):
    """Run the chunk iterator on a feeder thread (the reference's
    _device_prefetch): its copy of chunk i + 1 to the device overlaps the
    consumer's compute on chunk i.  At most `depth` chunks are copied
    ahead of the one in use (a permit a chunk, returned when the consumer
    asks for the next).  stats["wait_s"]: the consumer's wait.  The
    feeder's exceptions are raised in the consumer."""
    q: "queue.Queue" = queue.Queue()
    permits = threading.Semaphore(depth + 1)
    done = object()
    err: list = []
    stop = [False]

    def feed():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            for x in it(permits):
                if stop[0]:
                    return
                q.put(x)
        except BaseException as e:      # noqa: BLE001 — raised below
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            x = q.get()
            stats["wait_s"] += time.perf_counter() - t0
            if x is done:
                break
            yield x
            permits.release()
        t.join()
        if err:
            raise err[0]
    finally:
        stop[0] = True
        while t.is_alive():
            permits.release()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)


def _to_device(data: Dict[str, tuple], device, stream) -> Dict[str, tuple]:
    """A chunk's host arrays as tensors on `device`: on a CUDA device
    copied on `stream` (the caller waits for its event), from page-locked
    memory where the source pinned them; on the CPU copies, so nothing
    writes into the source's cache."""
    out = {}
    for name, (d, v) in data.items():
        ts = []
        for a in (d, v):
            if a is None:
                ts.append(None)
                continue
            h = torch.from_numpy(a)
            if device.type == "cuda":
                with torch.cuda.stream(stream):
                    ts.append(h.to(device, non_blocking=True))
            else:
                ts.append(h.clone())
        out[name] = tuple(ts)
    return out


def _chunk_block(tensors: Dict[str, tuple], n: int, src, table) -> Block:
    """The chunk's Block: a packed column unpacked by K13 into its narrow
    storage, the others as they came."""
    cols: Dict[str, Column] = {}
    for name in src.columns:
        t = table.schema[name]
        data, validity = tensors[name]
        pk = src.packed.get(name)
        if pk is not None:
            w4, off, bpp = pk
            data = unpack_pairs(data, w4, off, bpp, src.chunk_rows,
                                dt.torch_dtype_of(src.storage[name]))
        ctype = dt.make_nullable(t) if (validity is not None
                                        and not t.nullable) else t
        cols[name] = Column(ctype, data, validity,
                            src.dictionaries.get(name))
    return Block(cols, n)


class StreamProgram:
    """The aggregation split run chunk by chunk (the reference's
    StreamProgram, its init/step/fin run eagerly)."""

    def __init__(self, session, split: StreamSplit, settings: Settings,
                 src, table, cap_c: int):
        self.session = session
        self.split = split
        self.settings = settings
        self.src = src
        self.table = table
        self.cap_c = cap_c
        self.device = session.device
        self.struct: Dict[str, Any] = {}
        catalog = session.catalog
        self.small_lower = {k: catalog.get_table(*k).read_block()
                            for k in split.lower_scan_keys}
        self.small_upper = {k: catalog.get_table(*k).read_block()
                            for k in split.upper_scan_keys}
        self.total_rows = src.total_rows
        # host preparation, transfer and the consumer's wait, in seconds,
        # and the chunks read, of the last run (the reference's
        # ProcessorsProfileLog split)
        self.io_stats = {"prep_s": 0.0, "transfer_s": 0.0, "wait_s": 0.0,
                         "chunks": 0}

    def _host_chunks(self):
        """(data, rows) of each chunk in index order: from the read pool
        where stream_readers > 1, else encoded here."""
        src, stats = self.src, self.io_stats
        readers = max(int(self.settings.stream_readers), 1)
        if readers > 1 and src.num_chunks > 1:
            from ..storage.read_pool import ParallelChunkReader
            chunk_b = max(int(self.settings.stream_chunk_bytes), 1)
            budget = max(int(self.settings.stream_buffer_bytes) // chunk_b, 1)
            reader = ParallelChunkReader(
                src, readers, max_buffered=min(readers + 2, budget))
            for _, data, n in reader.iter_ordered():
                yield data, n
            return
        for i in range(src.num_chunks):
            t0 = time.perf_counter()
            data, n = src.chunk(i)
            stats["prep_s"] += time.perf_counter() - t0
            yield data, n

    def _iter_chunks(self):
        """Device Blocks of the chunks, in index order: the copies of the
        next chunks overlap the compute on this one where there are
        several (_device_prefetch)."""
        dev, stats = self.device, self.io_stats
        cuda = dev.type == "cuda"
        copy_stream = torch.cuda.Stream(dev) if cuda else None

        def device_chunks(permits):
            for data, n in self._host_chunks():
                if permits is not None:
                    permits.acquire()
                t0 = time.perf_counter()
                tensors = _to_device(data, dev, copy_stream)
                ev = None
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(copy_stream)
                    ev.synchronize()
                stats["transfer_s"] += time.perf_counter() - t0
                stats["chunks"] += 1
                # a list: the consumer empties it, so the packed bytes go
                # once unpacked
                yield [tensors, n, ev]

        it = _device_prefetch(device_chunks, _PREFETCH_DEPTH, stats, dev) \
            if self.src.num_chunks > 1 else device_chunks(None)
        for item in it:
            tensors, n, ev = item
            item.clear()
            if ev is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(ev)
                for d, v in tensors.values():
                    for x in (d, v):
                        if x is not None:
                            x.record_stream(cur)
            blk = _chunk_block(tensors, n, self.src, self.table)
            del tensors
            yield blk

    def run(self, session):
        """-> (the result's host columns, its ExecContext)."""
        from .executor import Check, ExecContext, _finalize, materialize
        self.struct = struct = {}
        self.io_stats = {k: 0.0 if k != "chunks" else 0
                         for k in self.io_stats}
        settings, dev = self.settings, self.device
        carry: Optional[_Partial] = None
        n_groups = None
        for blk in self._iter_chunks():
            blocks = dict(self.small_lower)
            blocks[self.split.big_key] = blk
            ctx = ExecContext(blocks, settings, device=dev)
            ctx.merge_states = True
            part = _stage1_on_chunk(self.split, ctx, struct)
            if carry is None:
                # the carry holds at least a chunk's group slots
                self.cap_c = max(self.cap_c, struct["cap_g"])
                carry = _widen(part, self.cap_c)
                n_groups = struct["chunk_groups"]
            else:
                carry, n_groups = _merge_carry(carry, part, struct,
                                               self.cap_c, dev)
            del blk, blocks, ctx, part
        agg = self.split.agg
        ctx = ExecContext(dict(self.small_upper), settings, device=dev)
        key_cvs = [ColVal(f.dtype, None, torch.ones((), dtype=torch.uint8)
                          if has_v else None, dic)
                   for (f, _), (has_v, dic) in zip(agg.keys,
                                                   struct["key_meta"])]
        states_per_agg = [
            (item, [ColVal(item.field.dtype, None, None, dic)]
             if item.args else [], [carry.states[i] for i in idx])
            for item, dic, idx in zip(struct["items"], struct["agg_dicts"],
                                      struct["slots"])]
        global_agg = struct["global_agg"]
        merged = _finalize(agg, key_cvs, carry.keys, n_groups,
                           carry.states[0], states_per_agg, self.cap_c,
                           global_agg, ctx,
                           group_valid=None if global_agg else carry.valid)
        ctx.injected[_STREAM_KEY] = merged
        out = _run(self.split.upper, ctx)
        checks = [Check(struct["chunk_groups"], struct["cap_g"],
                        "per-chunk GROUP BY cardinality exceeded max_groups; "
                        "raise the max_groups setting", setting="max_groups")]
        if not global_agg:
            checks.append(Check(n_groups, self.cap_c,
                                "GROUP BY cardinality exceeded max_groups; "
                                "raise the max_groups setting",
                                setting="max_groups"))
        checks += [Check(v, limit, msg, setting) for v, (limit, msg, setting)
                   in zip(struct["lower_vals"], struct["lower_checks"])]
        ctx.checks = checks + ctx.checks
        cols = materialize(out, self.split.upper.schema, ctx)
        ctx.totals = None
        ctx.profile["rows_scanned"] = self.total_rows
        return cols, ctx


# -- the entry ---------------------------------------------------------------

def _build_stream_program(session, plan: L.PlanNode, settings: Settings,
                          thr: int) -> Optional[StreamProgram]:
    """The streamed table, its split and its chunk source (the reference's
    _build_stream_program, without its grace and generic branches, which
    raise naming their programs).  None where no streaming applies."""
    from ..storage.table import NotStreamable
    catalog = session.catalog
    scans: List[L.ScanNode] = []
    _collect_scans(plan, scans)
    over: Dict[Tuple[str, str], int] = {}
    for s in scans:
        key = (s.database, s.table)
        t = catalog.get_table(*key)
        b = t.physical_bytes(set(s.column_names)) if t.num_rows else 0
        if b > thr:
            over[key] = max(over.get(key, 0), b)
    for big in sorted(over, key=lambda k: -over[k]):
        split = find_split(plan, big)
        if split is None:
            split = find_generic_split(plan, big, settings)
        if split is None:
            continue
        table = catalog.get_table(*big)
        grace_key, compatible = _detect_grace(split, split.scan, catalog,
                                              thr)
        if not compatible:
            continue
        others = set(over) - {big}
        if grace_key is not None:
            others.discard(grace_key)
            if grace_key in split.upper_scan_keys \
                    or split.lower_scan_keys.count(grace_key) != 1:
                continue
        if others:
            continue                  # another big table cannot stream
        columns = list(split.scan.column_names)
        lower_root = split.agg.child if isinstance(split, StreamSplit) \
            else split.lower
        part_idx, spans = _prune_parts(lower_root, split.scan, table,
                                       session)
        try:
            _check_streamable(table, columns)
            chunk_rows = _blowup_chunk_rows(
                split, catalog, settings,
                _chunk_rows_for(table, columns, settings), table.num_rows)
            check_not_streamed(split, grace_key)
            psel, sel_key = host_prewhere_sel(
                lower_root, split.scan, table, part_idx, spans, session,
                settings)
            src = table.chunk_source(columns, chunk_rows, part_idx=part_idx,
                                     spans=spans, row_sel=psel,
                                     sel_key=sel_key)
        except NotStreamable:
            continue
        return StreamProgram(session, split, settings, src, table,
                             _carry_cap(split, table, settings))
    return None


def _versions(catalog, prog: StreamProgram):
    """Each table the program reads, by its uid and version: a cached
    program holds its tables' chunk sources, so it stands only while the
    same tables hold the same rows."""
    split = prog.split
    tables = {key: catalog.get_table(*key) for key in
              [split.big_key] + split.lower_scan_keys + split.upper_scan_keys}
    return tuple(sorted((key, t.uid, t.version) for key, t in tables.items()))


def try_streaming(session, stmt, settings: Settings, sql: str):
    """The streamed SELECT (the reference's try_streaming): None where no
    table is above the threshold or the plan does not stream; else
    (upper plan, host columns, ExecContext).  A plan that cannot stream
    and exceeds the device budget raises MemoryLimitExceeded before it
    runs, with the reference's message."""
    thr = _stream_threshold(settings)
    catalog = session.catalog
    if not any(t.num_rows and t.physical_bytes() > thr
               for db in catalog.databases.values()
               for t in db.tables.values()):
        return None
    skey = json.dumps(settings.as_dict(), sort_keys=True, default=str) \
        + "@" + catalog.current_database
    cache = session._stream_cache
    hit = cache.get((sql, skey)) if sql else None
    if hit is not None and _versions(catalog, hit[0]) == hit[1]:
        prog = hit[0]
        cols, ctx = prog.run(session)
        return prog.split.upper, cols, ctx
    plan = session._plan(stmt, settings)
    prog = _build_stream_program(session, plan, settings, thr)
    if prog is None:
        budget = effective_memory_budget(settings)
        est = estimate_plan_device_bytes(plan, catalog, settings)
        if est > budget:
            raise MemoryLimitExceeded(
                f"query would need ~{est >> 20} MiB of device memory "
                f"(budget {budget >> 20} MiB) and "
                "no streaming rewrite applies to this plan shape")
        return None
    cols, ctx = prog.run(session)
    if sql:
        if len(cache) > 64:
            cache.clear()
        cache[(sql, skey)] = (prog, _versions(catalog, prog))
    return prog.split.upper, cols, ctx
