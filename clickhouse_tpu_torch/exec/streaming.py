"""Out-of-core streaming and the memory governor (reference:
clickhouse_tpu/exec/streaming.py).

A table above ``max_device_block_bytes`` streams through the engine chunk
by chunk.  The plan is split where the chain over the streamed scan
(scan -> filter -> project -> probe-side joins) meets its breaker, and the
lower part runs once a chunk (storage/table.py ChunkSource: one physical
layout for every chunk, the table's bounds in the plan, so every chunk
takes the same path):

  * StreamProgram, an aggregation (ClickHouse's external aggregation):
    each chunk's groups and mergeable states (exprs/aggregates.py
    ``merge``) are merged into a carry, a GROUP BY () carry over the
    trivial grouping (K1), a keyed one by regrouping carry ++ partials
    with the sort grouping (K4, K5) and K6;
  * TopKProgram, ORDER BY ... LIMIT k (the external sort's top-N): each
    chunk's k first rows (K3 for one key, K4 for several) merge with the
    carried k rows by a stable sort of carry ++ chunk (K4);
  * CollectProgram, any other shape (a holistic aggregate's among them):
    each chunk's surviving rows are compacted on the device (K14,
    ops/filter_ops.compact_rows) and only they are copied to the host;
    the rest of the plan runs over the collected rows on the device where
    they fit the budget, else a Sort [-> Limit] runs on the host.

The upper part runs on the carried block (``BlockSourceNode``).  A
probe-side join streams with its build side read whole, once a chunk;
where the build side is above the threshold too, both sides are
hash-partitioned on the host into buckets (the grace join, ClickHouse's
GraceHashJoin) and the program runs bucket by bucket with that bucket's
build rows.  A plan over the device budget whose excess is a cross join's
intermediate streams its probe side in chunks that fit
(``try_blowup_streaming``, the role of max_joined_block_size_rows).

Host side: parts whose min/max refute the filter are never read
(``_prune_parts``; granules of the ORDER BY key's min/max within the
rest), and a selective filter over plain comparisons runs on the host
first (``host_prewhere_sel``), so only its rows cross the link.  Chunks
are encoded on reader threads (storage/read_pool.py, ``stream_readers``),
copied to the card on a stream of their own from page-locked memory by a
feeder thread, at most ``_PREFETCH_DEPTH`` chunks ahead of the one in use,
and a bit-packed column is unpacked there by K13 (ops/chunk_ops.py).  The
governor holds a plan that does not stream against the device budget
before it runs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.block import Block
from ..core.column import Column, pad_to
from ..core.errors import MemoryLimitExceeded, NotImplementedError_
from ..core.settings import Settings
from ..exprs.expr import ColVal, StoredColVal, TermColVal, evaluate
from ..ops import agg_ops, filter_ops, sort_ops
from ..ops.chunk_ops import unpack_pairs
from ..plan import logical as L
from ..plan import ranges as R
from .executor import (_DISPATCH, Check, ExecBlock, ExecContext, _finalize,
                       _gather_colval, _token_for_sort, execute_plan,
                       materialize)

__all__ = ["estimate_plan_device_bytes", "effective_memory_budget",
           "estimate_plan_scan_bytes", "check_not_streamed",
           "cached_chars_bytes", "try_streaming", "try_blowup_streaming",
           "StreamProgram", "TopKProgram", "CollectProgram", "find_split"]

_STREAM_KEY = "__stream__"

# join kinds safe to run on each probe-side chunk alone: every output row
# is decided by its probe row (RIGHT/FULL would need the build rows
# matched across chunks)
_STREAMABLE_JOIN_KINDS = ("inner", "left", "semi", "anti", "cross")
_GRACE_JOIN_KINDS = ("inner", "left", "semi", "anti")

# device chunks copied ahead of the one in use (the reference's
# _device_prefetch depth)
_PREFETCH_DEPTH = 2

# numbers() sources of at most this many rows are materialized as hidden
# tables for blow-up streaming (1 GiB of host UInt64)
_NUMBERS_MAT_LIMIT = 1 << 27
_TMP_DB = "_stream_tmp"


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
    """Where the chain meets no aggregation breaker: kind "topk"
    (TopKProgram: ORDER BY ... LIMIT over the chain; the upper plan reads
    the carried rows in place of the Sort) or "collect" (CollectProgram:
    the chain's rows collected; the upper plan reads them in place of the
    chain)."""
    kind: str
    scan: L.ScanNode
    big_key: Tuple[str, str]
    lower: L.PlanNode             # the chain's head, run a chunk
    upper: L.PlanNode
    lower_scan_keys: List[Tuple[str, str]]
    upper_scan_keys: List[Tuple[str, str]]
    path: Optional[list] = None
    lower_i: int = 0
    sort_items: Optional[list] = None        # topk
    k_total: int = 0                         # topk: limit + offset
    limit_total: Optional[int] = None        # collect: rows to stop at


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
    if isinstance(parent, L.SortNode) and parent.child is lower \
            and not any(i.fill is not None for i in parent.items):
        k = parent.limit_hint
        if k is None and j >= 2 and isinstance(path[j - 2], L.LimitNode) \
                and path[j - 2].limit >= 0:
            k = path[j - 2].limit + path[j - 2].offset
        if k is not None and 0 < k <= settings.stream_topk_max:
            upper = _replace_node(
                plan, parent, L.BlockSourceNode(parent.schema, _STREAM_KEY))
            return GenericSplit("topk", scan, big_key, lower, upper, keys,
                                _scan_keys(upper), path, j,
                                sort_items=list(parent.items),
                                k_total=int(k))
    upper = L.BlockSourceNode(lower.schema, _STREAM_KEY) if lower is plan \
        else _replace_node(plan, lower,
                           L.BlockSourceNode(lower.schema, _STREAM_KEY))
    limit_total = None
    if isinstance(parent, L.LimitNode) and parent.limit >= 0:
        limit_total = parent.limit + parent.offset
    return GenericSplit("collect", scan, big_key, lower, upper, keys,
                        _scan_keys(upper), path, j, limit_total=limit_total)


# -- grace joins: detection and the host partition ---------------------------

@dataclasses.dataclass
class GraceJoin:
    """The chain's join whose build side is above the threshold: both
    sides are hash-partitioned on their key columns into n_buckets."""
    join: L.JoinNode
    build_scan: L.ScanNode
    build_key: Tuple[str, str]
    probe_cols: List[str]         # the streamed table's key columns
    build_cols: List[str]         # the build table's key columns
    kinds: List[str]              # a key pair's hash: int | float | str
    n_buckets: int = 0


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
    reference's grace join), as (its GraceJoin or None, compatible:
    whether the plan can stream at all)."""
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
        probe_cols, build_cols, kinds = [], [], []
        for le, re_ in zip(node.left_keys, node.right_keys):
            if not (isinstance(le, BoundColumn)
                    and isinstance(re_, BoundColumn)):
                return None, False
            lm, rn = lmap.get(le.name), bmap.get(re_.name)
            if lm is None or lm[0] is not scan or rn is None:
                return None, False
            lt, rt = big_t.schema[lm[1]], build_t.schema[rn]
            if lt.is_dictionary != rt.is_dictionary:
                return None, False
            kinds.append("str" if lt.is_dictionary else "float" if "f" in (
                lt.np_dtype.kind, rt.np_dtype.kind) else "int")
            probe_cols.append(lm[1])
            build_cols.append(rn)
        graces.append(GraceJoin(node, bscan, (bscan.database, bscan.table),
                                probe_cols, build_cols, kinds))
    if len(graces) > 1:
        return None, False
    return (graces[0] if graces else None), True


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """The reference's splitmix64 finalizer (its parallel/distributed.py
    _splitmix64_np), over uint64."""
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
        return z


def _hash_values_u64(v: np.ndarray, kind: str) -> np.ndarray:
    """A uint64 a row for the bucket of a key value, equal for equal
    values whatever their storage type: integers through int64, floats
    through their float64 bits, strings as crc32 | adler32 << 32 of their
    UTF-8 bytes.  NULL is 0 (bucket 0; it matches in no bucket)."""
    n = len(v)
    if kind == "str":
        h = np.zeros(n, np.uint64)
        for i, x in enumerate(v):
            if x is not None:
                b = str(x).encode()
                h[i] = np.uint64(zlib.crc32(b)) \
                    | (np.uint64(zlib.adler32(b)) << np.uint64(32))
        return h
    wide = np.float64 if kind == "float" else np.int64
    if v.dtype == object:
        mask = np.asarray([x is not None for x in v], bool)
        vals = np.zeros(n, wide)
        if mask.any():
            vals[mask] = np.asarray([x for x in v if x is not None], wide)
        h = vals.view(np.uint64) if kind == "float" \
            else vals.astype(np.uint64)
        h[~mask] = 0
        return h
    if kind == "float":
        return v.astype(np.float64).view(np.uint64)
    with np.errstate(over="ignore"):
        return v.astype(np.int64).astype(np.uint64)


def _bucket_dtype(P: int):
    return np.uint8 if P <= 256 else np.uint16 if P <= 65536 else np.int32


def _bucket_of(cols: List[np.ndarray], kinds: List[str], P: int
               ) -> np.ndarray:
    """Each row's bucket: splitmix64(h ^ splitmix64(key hash)) over the
    key columns from h = 0, mod P (the reference's), in the narrowest
    type that holds P."""
    h = np.zeros(len(cols[0]), np.uint64)
    with np.errstate(over="ignore"):
        for v, kind in zip(cols, kinds):
            h = _splitmix64_np(h ^ _splitmix64_np(_hash_values_u64(v, kind)))
    return (h % np.uint64(P)).astype(_bucket_dtype(P))


# rows a worker hashes at a time; numpy releases the GIL in its loops
_HASH_SLICE = 1 << 23


def _host_workers() -> int:
    """Threads for the host's share of a grace join (the partition, the
    buckets' encoding): the cores, at most 8."""
    return max(min(os.cpu_count() or 1, 8), 1)


def _part_buckets(cols: List[np.ndarray], kinds: List[str], P: int,
                  pool: Optional[ThreadPoolExecutor]) -> np.ndarray:
    """One part's bucket ids, hashed in slices of _HASH_SLICE rows on the
    pool's threads (strings on this one)."""
    n = len(cols[0])
    if pool is None or n <= _HASH_SLICE or "str" in kinds:
        return _bucket_of(cols, kinds, P)
    out = np.empty(n, _bucket_dtype(P))

    def work(lo: int) -> None:
        hi = min(lo + _HASH_SLICE, n)
        out[lo:hi] = _bucket_of([c[lo:hi] for c in cols], kinds, P)
    list(pool.map(work, range(0, n, _HASH_SLICE)))
    return out


def _partition_rows(parts, cols: List[str], kinds: List[str], P: int):
    """Each part's rows by bucket, in row order within a bucket: ->
    sel[bucket][part position] (int64 row indices).  A part's ids are
    hashed on worker threads, the parts sorted at once on others; the ids
    take a byte (P <= 256), so numpy's stable sort of them is a radix
    sort."""
    def split(a: Optional[np.ndarray]) -> List[np.ndarray]:
        if a is None:
            return [np.zeros(0, np.int64)] * P
        order = np.argsort(a, kind="stable")
        ends = np.cumsum(np.bincount(a, minlength=P))
        return np.split(order, ends[:-1])

    with ThreadPoolExecutor(_host_workers()) as pool, \
            ThreadPoolExecutor(_host_workers()) as sorter:
        pending = [sorter.submit(split, _part_buckets(
            [np.asarray(p.columns[c]) for c in cols], kinds, P, pool)
            if p.num_rows else None) for p in parts]
        per_part = [f.result() for f in pending]
    return [[pp[b] for pp in per_part] for b in range(P)]


def _grace_bucket_count(build_bytes: int, thr: int, settings) -> int:
    """grace_join_buckets, or the power of two (2..256) that cuts the
    build side into buckets of at most a quarter of the threshold."""
    if settings.grace_join_buckets > 0:
        return int(settings.grace_join_buckets)
    target = max(thr // 4, 1)
    P = 1
    while P * target < build_bytes and P < 256:
        P *= 2
    return max(P, 2)


def _grace_build_buckets(table, columns: List[str], sel_per_bucket):
    """A ChunkSource a build bucket, each one chunk of one shared capacity,
    in one layout (the first's) and unpacked: its rows stay on the host
    until its bucket runs (one bucket on the device at a time)."""
    from ..storage.table import ChunkSource
    cap = pad_to(max(max(sum(len(s) for s in sels)
                         for sels in sel_per_bucket), 1))
    srcs, donor = [], None
    for sels in sel_per_bucket:
        src = ChunkSource(table, columns, cap, row_sel=sels, pack=False,
                          layout_donor=donor)
        donor = donor or src
        srcs.append(src)
    return srcs


# -- blow-up streaming: the chunk of an expanding join -----------------------

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


def _split_chunk_rows(split, table, columns, catalog,
                      settings: Settings) -> int:
    """The chunk rows of a split's streamed table: the configured chunk,
    at least a top-k's rows, cut to an expanding join's chunk
    (_blowup_chunk_rows); NotStreamable where a column cannot stream."""
    _check_streamable(table, columns)
    chunk_rows = _chunk_rows_for(table, columns, settings)
    if isinstance(split, GenericSplit) and split.kind == "topk":
        chunk_rows = max(chunk_rows, pad_to(split.k_total))
    return _blowup_chunk_rows(split, catalog, settings, chunk_rows,
                              table.num_rows)


def _check_streamable(table, columns) -> None:
    """NotStreamable where ChunkSource would refuse a column."""
    from ..storage.table import check_streamable
    for name in columns:
        check_streamable(table, name)


def check_not_streamed(split) -> None:
    """Raise NotImplementedError_ naming a node above the split that the
    engine cannot run (a window function over a collect's rows), before
    any chunk is read."""
    todo = [split.upper]
    while todo:
        node = todo.pop()
        if type(node) not in _DISPATCH:
            what = "a window function (WindowNode)" \
                if isinstance(node, L.WindowNode) else type(node).__name__
            program = {"topk": "TopKProgram", "collect": "CollectProgram"
                       }.get(getattr(split, "kind", None), "StreamProgram")
            raise NotImplementedError_(
                f"streaming {what} over {program}'s rows is not ported to "
                f"the CUDA engine yet")
        todo.extend(node.children())


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


class _StreamProgramBase:
    """What the programs share (the reference's _StreamProgramBase): the
    sources as (ChunkSource, grace bucket or None) pairs, the small
    tables' blocks (a grace bucket's build rows in place of the build
    table's), the chunk loop with the read pool and the prefetch, and
    io_stats."""

    def __init__(self, session, split, settings: Settings, sources, table,
                 grace: Optional[tuple] = None):
        # grace: (the build table's key, a ChunkSource a bucket) or None
        self.settings = settings
        self.sources = sources
        self.src = sources[0][0]
        self.table = table
        self.split = split
        self.grace = grace
        self.device = session.device
        self.struct: Dict[str, Any] = {}
        catalog = session.catalog
        gk = grace[0] if grace else None
        self.small_lower = {k: catalog.get_table(*k).read_block()
                            for k in split.lower_scan_keys if k != gk}
        self.small_upper = {k: catalog.get_table(*k).read_block()
                            for k in split.upper_scan_keys}
        self.total_rows = sum(src.total_rows for src, _ in sources)
        # host preparation, transfer and the consumer's wait, in seconds,
        # the chunks read and the bytes copied back to the host (a
        # collect's rows), of the last run (the reference's
        # ProcessorsProfileLog split)
        self.io_stats = {"prep_s": 0.0, "transfer_s": 0.0, "wait_s": 0.0,
                         "chunks": 0, "back_bytes": 0}
        # the small tables' blocks a grace bucket reads: one dict, its
        # build entry replaced bucket by bucket
        self._grace_blocks: Dict[Tuple[str, str], Any] = {}
        self._bucket: Optional[int] = None

    def _lower_blocks(self, bucket: Optional[int]):
        """The small tables' blocks for a source: a grace bucket's build
        rows copied to the device once, while its bucket runs (the dict is
        the same for every bucket, so the one before is freed here)."""
        if self.grace is None or bucket is None:
            return self.small_lower
        blocks, gk = self._grace_blocks, self.grace[0]
        if self._bucket != bucket:
            blocks.clear()                    # one bucket on the device
            src = self.grace[1][bucket]
            data, n = src.chunk(0)
            tensors = _to_device(data, self.device, None)
            blocks.update(self.small_lower)
            blocks[gk] = _chunk_block(tensors, n, src, src.table)
            self._bucket = bucket
        return blocks

    def _lower_on_chunk(self, blk: Block, blocks):
        """The lower plan over one chunk (the reference's
        _lower_on_chunk) -> (its ExecBlock, its ExecContext)."""
        blocks = dict(blocks)
        blocks[self.split.big_key] = blk
        ctx = ExecContext(blocks, self.settings, device=self.device)
        return _run(self.split.lower, ctx), ctx

    def _chunks(self):
        """(device Block, the small tables' blocks) of every chunk, source
        by source; a source without rows is skipped once a chunk was
        read (the first chunk of the first source shapes the carry)."""
        self.io_stats = {k: 0 if k in ("chunks", "back_bytes") else 0.0
                         for k in self.io_stats}
        read = False
        try:
            for src, bucket in self.sources:
                if src.total_rows == 0 and read:
                    continue
                blocks = self._lower_blocks(bucket)
                for blk in self._iter_chunks(src):
                    read = True
                    yield blk, blocks
        finally:
            self._grace_blocks.clear()
            self._bucket = None

    def _host_chunks(self, src):
        """(data, rows) of each chunk in index order: from the read pool
        where stream_readers > 1, else encoded here."""
        stats = self.io_stats
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

    def _iter_chunks(self, src):
        """Device Blocks of src's chunks, in index order: the copies of the
        next chunks overlap the compute on this one where there are
        several (_device_prefetch)."""
        dev, stats = self.device, self.io_stats
        cuda = dev.type == "cuda"
        copy_stream = torch.cuda.Stream(dev) if cuda else None

        def device_chunks(permits):
            for data, n in self._host_chunks(src):
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
                # once unpacked (this frame keeps no other reference while
                # the chunk is processed)
                item = [tensors, n, ev]
                del tensors
                yield item

        it = _device_prefetch(device_chunks, _PREFETCH_DEPTH, stats, dev) \
            if src.num_chunks > 1 else device_chunks(None)
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
            blk = _chunk_block(tensors, n, src, self.table)
            del tensors
            yield blk

    def _checks(self, struct: dict) -> List[Check]:
        """The lower plan's capacity checks at their largest over the
        chunks (collected by _keep_checks)."""
        return [Check(v, limit, msg, setting) for v, (limit, msg, setting)
                in zip(struct.get("lower_vals", []),
                       struct.get("lower_checks", []))]


def _keep_checks(struct: dict, ctx) -> None:
    """Carry a chunk's capacity checks: their limits once, their values
    as the largest over the chunks (on the device: no sync)."""
    if "lower_checks" not in struct:
        struct["lower_checks"] = [(c.limit, c.message, c.setting)
                                  for c in ctx.checks]
    vals = [torch.as_tensor(c.value, dtype=torch.int64, device=ctx.device)
            for c in ctx.checks]
    struct["lower_vals"] = vals if "lower_vals" not in struct else [
        torch.maximum(a, b) for a, b in zip(struct["lower_vals"], vals)]


class StreamProgram(_StreamProgramBase):
    """The aggregation split run chunk by chunk (the reference's
    StreamProgram, its init/step/fin run eagerly)."""

    def __init__(self, session, split: StreamSplit, settings: Settings,
                 sources, table, cap_c: int, grace: Optional[tuple] = None):
        super().__init__(session, split, settings, sources, table, grace)
        self.cap_c = cap_c

    def run(self, session):
        """-> (the result's host columns, its ExecContext)."""
        self.struct = struct = {}
        settings, dev = self.settings, self.device
        carry: Optional[_Partial] = None
        n_groups = None
        for blk, small in self._chunks():
            blocks = dict(small)
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
        ctx.checks = checks + self._checks(struct) + ctx.checks
        cols = materialize(out, self.split.upper.schema, ctx)
        ctx.totals = None
        ctx.profile["rows_scanned"] = self.total_rows
        return cols, ctx


def _map_colval(f, cv: ColVal, *more: ColVal) -> ColVal:
    """A column rebuilt from f over its tensors (stored narrow: storage
    and validity; else data, validity and lengths), each given with the
    same tensor of each column of `more`; None stays None.  A slice, a
    gather, or over two columns of one layout their concatenation."""
    def g(get):
        t = get(cv)
        return None if t is None else f(t, *[get(m) for m in more])
    if isinstance(cv, StoredColVal) \
            and all(isinstance(m, StoredColVal) for m in more):
        return StoredColVal(cv.dtype, g(lambda c: c.storage),
                            g(lambda c: c.validity))
    return ColVal(cv.dtype, g(lambda c: c.data), g(lambda c: c.validity),
                  cv.dictionary, lengths=g(lambda c: c.lengths))


def _slice_rows(blk: Block, lo: int, hi: int) -> Block:
    """Rows [lo, hi) of a chunk's Block (views of its columns)."""
    def cut(t):
        return None if t is None else t[lo:hi]
    return Block({name: dataclasses.replace(
        c, data=c.data[lo:hi], validity=cut(c.validity),
        lengths=cut(c.lengths)) for name, c in blk.columns.items()},
        max(min(blk.num_rows, hi) - lo, 0))


def _exact_bounds(b):
    """Integer bounds that a float of the part statistics holds exactly
    (|value| <= 2^53), else None."""
    if b is None or not all(isinstance(v, (int, np.integer)) or float(
            v).is_integer() for v in b):
        return None
    lo, hi = int(b[0]), int(b[1])
    return (lo, hi) if -(1 << 53) <= lo <= hi <= 1 << 53 else None


def _sort_value(eb: ExecBlock, item, ctx) -> ColVal:
    """A sort item's value over a block, with no widened copy kept on the
    block (an integer column stored narrow as stored, an intDiv/modulo
    term formed in its source's type: their tokens and keys are the
    widened column's) and its proven bounds (so a K3 top-k takes the
    32-bit entry where they span 32 bits)."""
    cv = evaluate(item.expr, eb.env(), ctx.memory_headroom)
    b = _exact_bounds(cv.bounds if cv.bounds is not None
                      else R.infer_bounds(item.expr, ctx.field_bounds))
    if isinstance(cv, StoredColVal) and not cv.storage.is_floating_point():
        return ColVal(cv.dtype, cv.storage, cv.validity, bounds=b)
    if isinstance(cv, TermColVal):
        return ColVal(cv.dtype, cv.term.build_narrow(), cv.validity,
                      bounds=b)
    cv = cv.broadcast(eb.capacity)
    return dataclasses.replace(cv, bounds=b) if type(cv) is ColVal else cv


def _sort_key(eb: ExecBlock, item, ctx) -> sort_ops.SortKey:
    """A sort item as a key of K4's sort: a non-NULL integer value whose
    proven bounds span less than 2^31 as itself in 32 bits where they fit
    (DESC: hi - value), its bounds given, so sort_rows packs it without
    measuring it or building a 64-bit token; any other value as its order
    token.  The order is the token's either way."""
    cv = _sort_value(eb, item, ctx)
    x, b = cv.data, cv.bounds
    if cv.validity is None and cv.dictionary is None and b is not None \
            and not x.is_floating_point() and x.dtype != torch.bool \
            and int(b[1]) - int(b[0]) < 1 << 31:
        lo, hi = int(b[0]), int(b[1])
        x = x.to(torch.int32 if -(1 << 31) <= lo and hi < 1 << 31
                 else torch.int64)
        if item.descending:
            return sort_ops.SortKey(hi - x, bounds=(0, hi - lo))
        return sort_ops.SortKey(x, bounds=(lo, hi))
    return sort_ops.SortKey(_token_for_sort(cv, item, eb.capacity),
                            unsigned=True)


def _packed_key32(keys: List[sort_ops.SortKey]) -> Optional[torch.Tensor]:
    """Sort keys whose bounds all fit one 31-bit key, packed side by side
    (the first most significant, each less its lower bound), as int32: its
    order is the keys' order, so K3's 32-bit entry takes a top-k of
    several keys over one chunk as it takes one key's (a K4 sort of a
    2^27-row chunk held 4.6 GB of an H100's memory).  None where they do
    not fit."""
    if any(k.bounds is None or k.unsigned for k in keys):
        return None
    widths = [(int(k.bounds[1]) - int(k.bounds[0])).bit_length()
              for k in keys]
    if sum(widths) > 31:
        return None
    out, shift = None, sum(widths)
    for k, w in zip(keys, widths):
        shift -= w
        v = (k.data - int(k.bounds[0])).to(torch.int32)
        v = v << shift if shift else v
        out = v if out is None else out.bitwise_or_(v)
    return out


def _sort_perm(eb: ExecBlock, items, valid, ctx) -> torch.Tensor:
    """The stable sort (K4) of the block's rows by the items: valid rows
    by (keys, row id), then the rest."""
    perm, _ = sort_ops.sort_rows([_sort_key(eb, it, ctx) for it in items],
                                 valid, want_keys=False,
                                 max_bytes=ctx.memory_headroom)
    return perm.to(torch.int64)


# rows of a chunk's slice that a top-k sorted by K4 lowers and sorts at
# once (a 2^27-row chunk's projection and K4 sort by two keys held 4.6 GB
# of an H100)
TOPK_SORT_ROWS = 1 << 24


class TopKProgram(_StreamProgramBase):
    """ORDER BY ... LIMIT k streamed (the reference's TopKProgram, the
    external sort's top-N): each chunk's first k rows in the sort's order
    (K3 for one key or keys packed into one; else the stable sort K4, a
    slice of TOPK_SORT_ROWS rows at a time), merged with the carried k
    rows by a stable sort of carry ++ part (K4), so a tie keeps the
    carry's row first, as one block's stable sort keeps the earlier
    row."""

    def __init__(self, session, split: GenericSplit, settings: Settings,
                 sources, table, grace: Optional[tuple] = None):
        super().__init__(session, split, settings, sources, table, grace)
        self.k_cap = pad_to(max(split.k_total, 1))
        self._sliced: Optional[bool] = None  # K4 over slices (_spans)

    def _k3_key(self, eb: ExecBlock, ctx, cap: int):
        """(the key K3 takes the block's first k rows by, whether it is
        the 32-bit key or a 64-bit order token), or None where K4 sorts
        the rows: chunks of `cap` rows below 2^16, k above K3's, or
        several keys that do not pack into one 31-bit key."""
        items = self.split.sort_items
        if cap < 1 << 16 or min(self.k_cap, cap) > sort_ops.MAX_TOPK:
            return None
        if len(items) == 1:
            cv = _sort_value(eb, items[0], ctx)
            key32 = sort_ops.topk_key32(cv, items[0].descending)
            return (key32, True) if key32 is not None else (
                _token_for_sort(cv, items[0], eb.capacity), False)
        key32 = _packed_key32([_sort_key(eb, it, ctx) for it in items])
        return None if key32 is None else (key32, True)

    def _spans(self, blk: Block, small):
        """The row spans of a chunk that are lowered apart: the whole
        chunk (None) where K3 takes it or it fits TOPK_SORT_ROWS, else
        its slices of TOPK_SORT_ROWS rows up to its row bound.  K3 or K4
        is decided once, over the first slice (the keys' types and
        bounds are the plan's)."""
        cap = blk.capacity
        step = max(TOPK_SORT_ROWS, self.k_cap)
        if step >= cap:
            return [None]
        if self._sliced is None:
            eb, ctx = self._lower_on_chunk(_slice_rows(blk, 0, step), small)
            self._sliced = self._k3_key(eb, ctx, cap) is None
        if not self._sliced:
            return [None]
        return [(lo, min(lo + step, cap)) for lo in range(0, cap, step)
                if not lo or lo < blk.num_rows]

    def _top(self, eb: ExecBlock, idx0: torch.Tensor, ctx):
        """The block's rows at idx0 (its first rows in the sort's order),
        gathered as stored into k_cap slots, and how many hold a row."""
        idx = torch.zeros(self.k_cap, dtype=torch.int64, device=ctx.device)
        idx[:idx0.shape[0]] = idx0
        count = torch.clamp(filter_ops.count_mask(eb.rows),
                            max=min(self.split.k_total, idx0.shape[0]))
        cols = {f.id: _gather_colval(eb.cols[f.id], idx, eb.capacity)
                for f in self.split.lower.schema}
        return cols, count

    def _merge(self, carry, part, ctx):
        """carry ++ part, stably sorted, its first k_cap rows."""
        (ccols, ccount), (pcols, pcount) = carry, part
        k_cap, cat_cap = self.k_cap, 2 * self.k_cap
        cols = {fid: _map_colval(
            lambda x, y: torch.cat([x, y.to(x.dtype)]), ccols[fid],
            pcols[fid]) for fid in ccols}
        ar = torch.arange(k_cap, device=ctx.device)
        valid = torch.cat([ar < ccount, ar < pcount])
        eb = ExecBlock(cols, agg_ops.RowMask.of(valid), cat_cap)
        idx = _sort_perm(eb, self.split.sort_items, valid, ctx)[:k_cap]
        return ({fid: _gather_colval(cv, idx, cat_cap)
                 for fid, cv in cols.items()},
                torch.clamp(ccount + pcount, max=self.split.k_total))

    def run(self, session):
        """-> (the result's host columns, its ExecContext)."""
        self.struct = struct = {}
        carry = None
        items, k_cap = self.split.sort_items, self.k_cap
        for blk, small in self._chunks():
            for span in self._spans(blk, small):
                eb, ctx = self._lower_on_chunk(
                    blk if span is None else _slice_rows(blk, *span), small)
                _keep_checks(struct, ctx)
                cap = eb.capacity
                key = None if span else self._k3_key(eb, ctx, cap)
                if key is None:
                    idx0 = _sort_perm(eb, items, eb.valid, ctx)[:k_cap]
                elif key[1]:
                    idx0 = sort_ops.topk_permutation32(key[0], eb.valid,
                                                       min(k_cap, cap))
                else:
                    idx0 = sort_ops.topk_permutation(key[0], eb.valid,
                                                     min(k_cap, cap))
                part = self._top(eb, idx0, ctx)
                carry = part if carry is None \
                    else self._merge(carry, part, ctx)
                del eb, ctx, key, idx0, part
            del blk
        cols, count = carry
        ctx = ExecContext(dict(self.small_upper), self.settings,
                          device=self.device)
        valid = torch.arange(self.k_cap, device=self.device) < count
        ctx.injected[_STREAM_KEY] = ExecBlock(
            cols, agg_ops.RowMask.of(valid), self.k_cap)
        out = _run(self.split.upper, ctx)
        ctx.checks = self._checks(struct) + ctx.checks
        res = materialize(out, self.split.upper.schema, ctx)
        ctx.totals = None
        ctx.profile["rows_scanned"] = self.total_rows
        return res, ctx


class CollectProgram(_StreamProgramBase):
    """Any other shape streamed (the reference's CollectProgram): each
    chunk's surviving rows are compacted on the device by K14
    (filter_ops.compact_rows: their indices in row order and their count,
    the one value read back a chunk) and only they are copied, as stored,
    to page-locked host memory; host memory plays the role of the
    reference's temporary data on disk.  The rest of the plan then runs
    over the collected rows: a bare block or a LIMIT is cut on the host,
    rows that fit the budget run the upper plan on the device, and above
    it a Sort [-> Limit] sorts on the host (_np_order, the external
    sort)."""

    def run(self, session):
        """-> (the result's host columns, its ExecContext)."""
        self.struct = struct = {}
        schema = self.split.lower.schema
        acc: Dict[str, List[tuple]] = {f.id: [] for f in schema}
        total, limit = 0, self.split.limit_total
        pin = self.device.type == "cuda"
        for blk, small in self._chunks():
            eb, ctx = self._lower_on_chunk(blk, small)
            _keep_checks(struct, ctx)
            cap = eb.capacity
            cvs = {f.id: eb.cols[f.id].broadcast(cap) for f in schema}
            if "kinds" not in struct:
                struct["kinds"] = {
                    fid: (isinstance(cv, StoredColVal), cv.dictionary,
                          cv.validity is not None, cv.lengths is not None)
                    for fid, cv in cvs.items()}
            idx, count = filter_ops.compact_rows(eb.rows)
            n = int(count)
            if limit is not None:
                n = min(n, limit - total)
            if n > 0:
                sel = idx[:n]
                for fid, cv in cvs.items():
                    stored, _, has_v, has_l = struct["kinds"][fid]
                    piece = tuple(
                        _to_host(t.index_select(0, sel), pin)
                        if t is not None else None
                        for t in (cv.storage if stored else cv.data,
                                  cv.validity if has_v else None,
                                  cv.lengths if has_l else None))
                    self.io_stats["back_bytes"] += sum(
                        t.nbytes for t in piece if t is not None)
                    acc[fid].append(piece)
                total += n
            del blk, eb, ctx, cvs, idx
            if limit is not None and total >= limit:
                break
        if pin:
            torch.cuda.current_stream(self.device).synchronize()
        return self._finalize(session, acc, total)

    def _host_cols(self, acc, total: int) -> Dict[str, ColVal]:
        """The collected rows, a host ColVal a field (as stored)."""
        out = {}
        for f in self.split.lower.schema:
            stored, dic, has_v, has_l = self.struct["kinds"][f.id]
            pieces = acc[f.id]
            parts = []
            for j in range(3):
                ts = [p[j] for p in pieces]
                parts.append(torch.cat(ts) if ts and ts[0] is not None
                             else None)
            data, validity, lengths = parts
            if data is None:
                data = torch.zeros(0, dtype=dt.remove_nullable(
                    f.dtype).torch_dtype)
                validity = torch.zeros(0, dtype=torch.uint8) \
                    if has_v else None
                lengths = torch.zeros(0, dtype=torch.int32) \
                    if has_l else None
                stored = False
            out[f.id] = StoredColVal(f.dtype, data, validity) if stored \
                else ColVal(f.dtype, data, validity, dic, lengths=lengths)
        return out

    def _block(self, cols: Dict[str, ColVal], n: int, device,
               pad: bool) -> ExecBlock:
        """The first n collected rows as an ExecBlock on `device` (padded
        to the pad unit where the upper plan runs over it)."""
        cap = pad_to(n) if pad else max(n, 1)

        def fit(t):
            t = t[:n]
            if t.shape[0] < cap:
                t = torch.cat([t, torch.zeros((cap - t.shape[0],)
                                              + tuple(t.shape[1:]),
                                              dtype=t.dtype)])
            return t.to(device)
        out = {fid: _map_colval(fit, cv) for fid, cv in cols.items()}
        valid = torch.arange(cap, device=device) < n
        return ExecBlock(out, agg_ops.RowMask.of(valid), cap)

    def _finalize(self, session, acc, total: int):
        split, settings = self.split, self.settings
        upper = split.upper
        cols = self._host_cols(acc, total)
        cpu = torch.device("cpu")
        ctx = ExecContext({}, settings, device=cpu)
        ctx.checks = self._checks(self.struct)

        def done(eb, schema, c):
            res = materialize(eb, schema, c)
            c.totals = None
            c.profile["rows_scanned"] = self.total_rows
            return res, c
        if isinstance(upper, L.BlockSourceNode):
            return done(self._block(cols, total, cpu, False), upper.schema,
                        ctx)
        if isinstance(upper, L.LimitNode) \
                and isinstance(upper.child, L.BlockSourceNode):
            lo = upper.offset
            hi = lo + upper.limit if upper.limit >= 0 else total
            n = max(min(hi, total) - lo, 0)
            cols = {fid: _map_colval(lambda t: t[lo:lo + n], cv)
                    for fid, cv in cols.items()}
            return done(self._block(cols, n, cpu, False), upper.schema, ctx)
        est = sum(t.nbytes for cv in cols.values()
                  for t in (cv.storage, cv.validity) if t is not None)
        budget = max(int(settings.max_device_memory_bytes), 1)
        if est <= budget:
            # the collected rows fit the device: the rest of the plan runs
            # there over them
            ectx = ExecContext(dict(self.small_upper), settings,
                               device=self.device)
            ectx.injected[_STREAM_KEY] = self._block(cols, total,
                                                     self.device, True)
            out = _run(upper, ectx)
            ectx.checks = ctx.checks + ectx.checks
            return done(out, upper.schema, ectx)
        # over the budget: a Sort [-> Limit] chain sorts on the host
        chain, node = [], upper
        while not isinstance(node, L.BlockSourceNode):
            chain.append(node)
            kids = node.children()
            if len(kids) != 1:
                break
            node = kids[0]
        if not isinstance(node, L.BlockSourceNode) \
                or not all(isinstance(c, (L.SortNode, L.LimitNode))
                           for c in chain) \
                or sum(isinstance(c, L.SortNode) for c in chain) != 1:
            raise MemoryLimitExceeded(
                f"collected streamed rows need ~{est >> 20} MiB on device "
                f"(budget {budget >> 20} MiB) and the remaining plan is not "
                "a host-executable Sort/Limit chain; raise "
                "max_device_memory_bytes or add a LIMIT")
        n = total
        for c in reversed(chain):       # bottom-up: the Sort, then Limits
            if isinstance(c, L.SortNode):
                perm = torch.from_numpy(_np_order(c.items, cols))
                cols = {fid: _map_colval(
                    lambda t: t.index_select(0, perm), cv)
                    for fid, cv in cols.items()}
            else:
                lo = c.offset
                hi = min(lo + c.limit if c.limit >= 0 else n, n)
                cols = {fid: _map_colval(lambda t: t[lo:hi], cv)
                        for fid, cv in cols.items()}
                n = max(hi - lo, 0)
        return done(self._block(cols, n, cpu, False), upper.schema, ctx)


def _to_host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A device tensor's copy in host memory, page-locked on a CUDA
    device (enqueued: the caller synchronises before reading it)."""
    if not pin:
        return t.clone() if t.device.type == "cpu" else t.cpu()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _np_order(items, cols: Dict[str, ColVal]) -> np.ndarray:
    """The host permutation of an ORDER BY over collected rows (the
    reference's _np_order, the external sort's): each key's u64 token (a
    string's rank in its dictionary, a float's total-order bits, an
    integer's bits with the sign flipped), inverted for DESC, NULL at the
    bottom or the top of the range; np.lexsort, stable.  Keys must be
    plain columns of the collected rows."""
    from ..exprs.expr import BoundColumn
    keys: List[np.ndarray] = []
    for it in items:
        if not isinstance(it.expr, BoundColumn) or it.expr.name not in cols:
            raise MemoryLimitExceeded(
                "host external sort requires plain column ORDER BY keys")
        cv = cols[it.expr.name]
        logical = dt.remove_nullable(cv.dtype)
        v = dt.to_numpy_storage(cv.data, None if logical.is_dictionary
                                else logical.np_dtype)
        if logical.is_dictionary:
            d = cv.dictionary
            vals = d.values.astype(str) if d is not None and len(d) \
                else np.zeros(0, str)
            order = np.argsort(vals, kind="stable")
            rank = np.empty(len(vals), np.int64)
            rank[order] = np.arange(len(vals))
            tok = rank[np.maximum(v.astype(np.int64), 0)].astype(np.uint64) \
                if len(vals) else np.zeros(len(v), np.uint64)
        elif v.dtype.kind == "f":
            bits = v.astype(np.float64).view(np.uint64)
            sign = (bits >> np.uint64(63)).astype(bool)
            tok = np.where(sign, ~bits,
                           bits | np.uint64(1 << 63)).astype(np.uint64)
        elif v.dtype.kind in "ub":
            tok = v.astype(np.uint64)
        else:
            with np.errstate(over="ignore"):
                tok = v.astype(np.int64).astype(np.uint64) \
                    ^ np.uint64(1 << 63)
        if it.descending:
            tok = ~tok
        if cv.validity is not None:
            is_null = cv.validity.numpy() == 0
            tok = np.where(is_null,
                           np.uint64(2**64 - 1) if it.nulls_last
                           else np.uint64(0),
                           np.clip(tok, np.uint64(1), np.uint64(2**64 - 2)))
        keys.append(tok)
    return np.lexsort(tuple(reversed(keys)))   # the last key is primary


# -- the entry ---------------------------------------------------------------

def _program(session, split, settings: Settings, sources, table,
             grace=None):
    """The program of a split: StreamProgram for an aggregation,
    TopKProgram or CollectProgram for the others."""
    if isinstance(split, StreamSplit):
        return StreamProgram(session, split, settings, sources, table,
                             _carry_cap(split, table, settings), grace)
    cls = TopKProgram if split.kind == "topk" else CollectProgram
    return cls(session, split, settings, sources, table, grace)


def _grace_sources(session, split, grace_j: GraceJoin, table, columns,
                   chunk_rows: int, part_idx, thr: int, settings):
    """Both sides hash-partitioned into the grace join's buckets: -> (a
    probe ChunkSource a bucket over its rows, with the bucket, and the
    program's grace argument: the build table's key and its buckets'
    sources).  Counts GraceJoinBuckets."""
    from ..storage.table import ChunkSource
    catalog = session.catalog
    build_table = catalog.get_table(*grace_j.build_key)
    build_cols = list(grace_j.build_scan.column_names)
    P = _grace_bucket_count(build_table.physical_bytes(set(build_cols)),
                            thr, settings)
    grace_j.n_buckets = P
    parts = table.parts if part_idx is None \
        else [table.parts[i] for i in part_idx]
    probe_sel = _partition_rows(parts, grace_j.probe_cols, grace_j.kinds, P)
    build_sel = _partition_rows(build_table.parts, grace_j.build_cols,
                                grace_j.kinds, P)
    builds = _grace_build_buckets(build_table, build_cols, build_sel)
    sources, donor = [], None
    for b in range(P):
        src = ChunkSource(table, columns, chunk_rows, part_idx=part_idx,
                          row_sel=probe_sel[b], layout_donor=donor)
        donor = donor or src
        sources.append((src, b))
    # a bucket is a chunk or a few: the read pool would not spread their
    # encoding, so the buckets of both sides are encoded here at once
    # (into each source's encode cache)
    with ThreadPoolExecutor(_host_workers()) as pool:
        list(pool.map(lambda src: [src.chunk(i) for i in
                                   range(src.num_chunks)],
                      [src for src, _ in sources] + builds))
    _count(session, "GraceJoinBuckets", P)
    return sources, (grace_j.build_key, builds)


def scans_over_threshold(catalog, plan: L.PlanNode,
                         thr: int) -> Dict[Tuple[str, str], int]:
    """The tables the plan scans above the streaming threshold, each with
    the bytes of the columns it reads."""
    scans: List[L.ScanNode] = []
    _collect_scans(plan, scans)
    over: Dict[Tuple[str, str], int] = {}
    for s in scans:
        key = (s.database, s.table)
        t = catalog.get_table(*key)
        b = t.physical_bytes(set(s.column_names)) if t.num_rows else 0
        if b > thr:
            over[key] = max(over.get(key, 0), b)
    return over


def _build_stream_program(session, plan: L.PlanNode, settings: Settings,
                          thr: int):
    """The streamed table, its split, its chunk sources (a grace join's
    buckets among them) and its program (the reference's
    _build_stream_program).  None where no streaming applies."""
    from ..storage.table import NotStreamable
    catalog = session.catalog
    over = scans_over_threshold(catalog, plan, thr)
    for big in sorted(over, key=lambda k: -over[k]):
        split = find_split(plan, big) or find_generic_split(plan, big,
                                                            settings)
        if split is None:
            continue
        table = catalog.get_table(*big)
        grace_j, compatible = _detect_grace(split, split.scan, catalog, thr)
        if not compatible:
            continue
        others = set(over) - {big}
        if grace_j is not None:
            others.discard(grace_j.build_key)
            # the build table is read only as that join's build side
            if grace_j.build_key in split.upper_scan_keys \
                    or split.lower_scan_keys.count(grace_j.build_key) != 1:
                continue
        if others:
            continue                  # another big table cannot stream
        columns = list(split.scan.column_names)
        lower_root = split.agg.child if isinstance(split, StreamSplit) \
            else split.lower
        part_idx, spans = _prune_parts(lower_root, split.scan, table,
                                       session)
        try:
            chunk_rows = _split_chunk_rows(split, table, columns, catalog,
                                           settings)
            check_not_streamed(split)
            grace = None
            if grace_j is None:
                psel, sel_key = host_prewhere_sel(
                    lower_root, split.scan, table, part_idx, spans, session,
                    settings)
                sources = [(table.chunk_source(
                    columns, chunk_rows, part_idx=part_idx, spans=spans,
                    row_sel=psel, sel_key=sel_key), None)]
            else:
                sources, grace = _grace_sources(
                    session, split, grace_j, table, columns, chunk_rows,
                    part_idx, thr, settings)
        except NotStreamable:
            continue
        return _program(session, split, settings, sources, table, grace)
    return None


def _versions(catalog, prog):
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
               for name, db in catalog.databases.items() if name != _TMP_DB
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


# -- blow-up streaming -------------------------------------------------------

def _collect_numbers(node: L.PlanNode, out: List[L.NumbersNode]) -> None:
    if isinstance(node, L.NumbersNode):
        out.append(node)
    for c in node.children():
        _collect_numbers(c, out)


def _materialize_numbers(session, nn: L.NumbersNode) -> None:
    """A hidden table (database _TMP_DB) holding a numbers() source, so
    that a ChunkSource can stream it; at most four are kept."""
    from ..storage.table import Database, Table
    catalog = session.catalog
    db = catalog.databases.get(_TMP_DB)
    if db is None:
        db = catalog.databases[_TMP_DB] = Database(_TMP_DB)
    name = f"numbers_{nn.start}_{nn.count}"
    if name in db.tables:
        return
    if len(db.tables) >= 4:
        db.tables.clear()
    t = Table(name, [("number", dt.UInt64)], device=catalog.device)
    t.insert_pydict({"number": np.arange(nn.start, nn.start + nn.count,
                                         dtype=np.uint64)})
    db.tables[name] = t


def try_blowup_streaming(session, plan: L.PlanNode, settings: Settings):
    """The second chance after the governor refuses a plan (the
    reference's try_blowup_streaming): where the excess is an expanding
    join's intermediate, chunk that join's probe side so that each
    chunk's joined block fits the budget.  Candidates: the stored scans,
    largest first, then numbers() sources of at most 2^27 rows (turned
    into hidden tables).  -> (upper plan, host columns, ExecContext) and
    counts BlowupStreamedQueries, or None (the caller raises the
    refusal); MemoryLimitExceeded where one joined block cannot fit."""
    from ..storage.table import NotStreamable
    catalog = session.catalog
    budget = effective_memory_budget(settings)
    if estimate_plan_device_bytes(plan, catalog, settings) <= budget:
        return None
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
    _collect_numbers(plan, nums)
    cands += [(0, nn, None) for nn in nums if nn.count <= _NUMBERS_MAT_LIMIT]
    for _, nn, key in cands:
        if nn is not None:
            key = (_TMP_DB, f"numbers_{nn.start}_{nn.count}")
            plan2 = _replace_node(plan, nn, L.ScanNode(
                key[0], key[1], list(nn.schema), ["number"]))
        else:
            plan2 = plan
        split = find_split(plan2, key) \
            or find_generic_split(plan2, key, settings)
        if split is None:
            continue
        if nn is not None:
            _materialize_numbers(session, nn)
        table = catalog.get_table(*key)
        columns = list(split.scan.column_names)
        try:
            chunk_rows = _split_chunk_rows(split, table, columns, catalog,
                                           settings)
            f, row = _chain_blowup(split, catalog, settings)
            other = estimate_plan_scan_bytes(plan2, catalog) - (
                table.physical_bytes(set(columns)) if table.num_rows else 0)
            # 2x: the chunk is padded up to the pad unit
            if other + chunk_rows * max(f, 1) * row > budget * 2:
                continue
            check_not_streamed(split)
            src = table.chunk_source(columns, chunk_rows)
        except NotStreamable:
            continue
        prog = _program(session, split, settings, [(src, None)], table)
        cols, ctx = prog.run(session)
        _count(session, "BlowupStreamedQueries", 1)
        return split.upper, cols, ctx
    return None
