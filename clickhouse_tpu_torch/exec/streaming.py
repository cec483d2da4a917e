"""Memory governor (reference: clickhouse_tpu/exec/streaming.py).

Only the governor is ported: a plan's estimated device footprint is held
against the budget before it runs, and a scan above
``max_device_block_bytes`` (which the reference streams chunk by chunk)
raises ``NotImplementedError_`` naming out-of-core streaming.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.errors import NotImplementedError_
from ..core.settings import Settings
from ..plan import logical as L

__all__ = ["estimate_plan_device_bytes", "effective_memory_budget",
           "estimate_plan_scan_bytes", "check_not_streamed",
           "cached_chars_bytes"]


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


def estimate_plan_device_bytes(plan: L.PlanNode, catalog,
                               settings: Settings) -> int:
    """Scan bytes + the largest operator intermediate (capacity x row
    width), as the reference estimates.  Whether a GROUP BY sorts is known
    only when it runs, so a sort's working set is held against what this
    estimate leaves of the budget there (sort_ops.sort_rows'
    max_bytes)."""
    caps: Dict[int, int] = {}

    def cap_of(node: L.PlanNode) -> int:
        hit = caps.get(id(node))
        if hit is not None:
            return hit
        if isinstance(node, L.ScanNode):
            v = max(catalog.get_table(node.database, node.table).num_rows, 1)
        elif isinstance(node, L.NumbersNode):
            v = max(node.count, 1)
        else:
            kids = [cap_of(c) for c in node.children()]
            if isinstance(node, L.JoinNode):
                v = kids[0] * kids[1] if node.kind == "cross" \
                    else max(kids[0], 1)
            elif isinstance(node, L.AggregateNode):
                v = min(kids[0], settings.max_groups)
            elif isinstance(node, L.ArrayJoinNode):
                v = kids[0] * 16
            elif isinstance(node, L.UnionNode):
                v = sum(kids)
            else:
                v = max(kids) if kids else 1024
        caps[id(node)] = v
        return v

    peak = 0

    def walk(n: L.PlanNode):
        nonlocal peak
        row = sum(_field_est_bytes(f) for f in n.schema)
        peak = max(peak, cap_of(n) * row)
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


def check_not_streamed(plan: L.PlanNode, catalog, settings: Settings) -> None:
    """Raise where the reference would stream a scanned table."""
    thr = _stream_threshold(settings)
    for (db, name), cols in _scanned_columns(plan).items():
        t = catalog.get_table(db, name)
        if t.num_rows and t.physical_bytes(cols) > thr:
            raise NotImplementedError_(
                f"table {db}.{name} ({t.physical_bytes(cols)} bytes) is "
                f"above max_device_block_bytes ({thr}); out-of-core "
                f"streaming is not ported to the CUDA engine yet")
