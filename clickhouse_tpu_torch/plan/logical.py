"""Logical query plan.

Analog of the reference's QueryPlan of IQueryPlanStep nodes
(src/Processors/QueryPlan/): a tree the executor lowers onto device kernels.
Columns are identified by unique internal ids (`#n`) with separate display
names — the role the reference's Analyzer plays by qualifying identifiers
into unique QueryTree column nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..core import dtypes as dt
from ..exprs.expr import BoundExpr
from ..exprs.aggregates import AggregateFunction

__all__ = [
    "Field", "PlanNode", "ScanNode", "OneRowNode", "NumbersNode",
    "FilterNode", "ProjectNode", "AggregateItem", "AggregateNode",
    "SortItem", "SortNode", "WindowItem", "WindowNode", "ArrayJoinNode",
    "LimitNode", "LimitByNode", "JoinNode", "DistinctNode", "UnionNode",
    "SetOpNode",
    "explain_plan",
]


@dataclasses.dataclass(frozen=True)
class Field:
    id: str                      # unique internal id, e.g. "#3"
    display: str                 # user-visible result name
    dtype: dt.DType
    qualifiers: Tuple[str, ...] = ()   # table aliases this field answers to
    # JOIN ... USING folds the right key out of unqualified `*` but keeps it
    # reachable via its qualifier (b.k / b.*) — reference semantics
    star_hidden: bool = False


class PlanNode:
    schema: List[Field]

    def children(self) -> Sequence["PlanNode"]:
        return ()

    def label(self) -> str:
        return type(self).__name__.replace("Node", "")


@dataclasses.dataclass
class ScanNode(PlanNode):
    database: str
    table: str
    schema: List[Field]
    # storage column name per schema field (ids are fresh per query)
    column_names: List[str]
    final: bool = False
    # set by the optimizer: predicate usable for part/granule pruning
    pruning_predicate: Optional[BoundExpr] = None
    # per-field integer bounds from part minmax stats (interval analysis)
    column_stats: Optional[Dict[str, Tuple[int, int]]] = None
    # engine family + sort key (FINAL fold semantics at read time)
    engine: str = "Memory"
    order_by_cols: Tuple[str, ...] = ()
    # engine arguments (sign/version columns of the Collapsing family)
    engine_args: Tuple[str, ...] = ()

    def label(self):
        return f"Scan {self.database}.{self.table}"


@dataclasses.dataclass
class BlockSourceNode(PlanNode):
    """A pre-computed block injected by the streaming executor (streaming:
    the merged aggregation state of all scanned chunks re-enters the plan
    here; the reference's analog is a pipeline reading from a temporary
    stream, src/Interpreters/TemporaryDataOnDisk.h)."""
    schema: List[Field]
    key: str = "__stream__"

    def label(self):
        return f"BlockSource {self.key}"


@dataclasses.dataclass
class OneRowNode(PlanNode):
    """SELECT without FROM: one synthetic row (system.one analog)."""
    schema: List[Field]


@dataclasses.dataclass
class NumbersNode(PlanNode):
    """numbers(N) table function: virtual sequence source."""
    schema: List[Field]
    start: int
    count: int

    def label(self):
        return f"Numbers [{self.start}, {self.start + self.count})"


@dataclasses.dataclass
class FilterNode(PlanNode):
    child: PlanNode
    predicate: BoundExpr
    schema: List[Field]

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class ProjectNode(PlanNode):
    child: PlanNode
    exprs: List[BoundExpr]       # one per output field
    schema: List[Field]

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class AggregateItem:
    field: Field                 # output field for this aggregate
    fn: AggregateFunction
    args: List[BoundExpr]
    cond: Optional[BoundExpr] = None


@dataclasses.dataclass
class AggregateNode(PlanNode):
    child: PlanNode
    keys: List[Tuple[Field, BoundExpr]]
    aggregates: List[AggregateItem]
    schema: List[Field]          # key fields + aggregate fields
    with_totals: bool = False
    # distributed execution mode, set by the parallel planner:
    #   single | partial (update only -> states) | merge (states -> final)
    mode: str = "single"

    def children(self):
        return (self.child,)

    def label(self):
        kk = ", ".join(f.display for f, _ in self.keys)
        aa = ", ".join(a.field.display for a in self.aggregates)
        return f"Aggregate keys=[{kk}] aggs=[{aa}]"


@dataclasses.dataclass
class SortItem:
    expr: BoundExpr
    descending: bool = False
    nulls_last: bool = True
    # ORDER BY ... WITH FILL: (from, to, step) literal values or None each
    fill: Optional[tuple] = None


@dataclasses.dataclass
class ArrayJoinNode(PlanNode):
    """arrayJoin(arr): expand each row into one row per array element
    (reference: ArrayJoinTransform, src/Interpreters/ArrayJoinAction.cpp)."""
    child: PlanNode
    array_expr: BoundExpr
    out_field: Field              # the element column
    schema: List[Field]

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class WindowItem:
    field: Field
    fn: str                       # row_number|rank|dense_rank|lag|lead|...
    args: List[BoundExpr]
    partition_by: List[BoundExpr]
    order_by: List[SortItem]
    frame: object                 # running | full | ("rows"|"range", lo, hi)
    shift: int = 1                # lag/lead offset


@dataclasses.dataclass
class WindowNode(PlanNode):
    """Window functions over sorted partitions (WindowTransform analog,
    src/Processors/Transforms/WindowTransform.cpp)."""
    child: PlanNode
    items: List[WindowItem]
    schema: List[Field]           # child fields + window fields

    def children(self):
        return (self.child,)

    def label(self):
        return "Window [" + ", ".join(i.fn for i in self.items) + "]"


@dataclasses.dataclass
class SortNode(PlanNode):
    child: PlanNode
    items: List[SortItem]
    schema: List[Field]
    limit_hint: Optional[int] = None    # enables top-k path

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class LimitNode(PlanNode):
    child: PlanNode
    limit: int
    offset: int
    schema: List[Field]

    def children(self):
        return (self.child,)

    def label(self):
        return f"Limit {self.limit} offset {self.offset}"


@dataclasses.dataclass
class LimitByNode(PlanNode):
    child: PlanNode
    n: int
    offset: int
    keys: List[BoundExpr]
    schema: List[Field]

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class JoinNode(PlanNode):
    left: PlanNode
    right: PlanNode
    kind: str                    # inner|left|semi|anti|cross
    strictness: str              # all|any|semi|anti
    left_keys: List[BoundExpr]
    right_keys: List[BoundExpr]
    residual: Optional[BoundExpr]
    schema: List[Field]          # left fields then right fields (as exposed)
    is_global: bool = False
    # planner statistic: the build (right) side's join keys are provably
    # unique (part-level uniqueness stats) -> N:1 propagate join eligible
    build_unique: bool = False
    # ASOF JOIN: inequality pair (left expr OP right expr)
    asof_left: Optional[BoundExpr] = None
    asof_right: Optional[BoundExpr] = None
    asof_op: str = "<="
    # the output field ids that the join's parent and its residual read
    # (set when the plan's columns are pruned; None: every field of
    # `schema`).  `schema` stays the reference's, so the governor's
    # estimate does too; the executor builds only these columns.
    read_fields: Optional[Set[str]] = None

    def children(self):
        return (self.left, self.right)

    def reads(self, field_id: str) -> bool:
        """Whether an output field is read above the join (so built)."""
        return self.read_fields is None or field_id in self.read_fields

    def label(self):
        return f"Join {self.strictness} {self.kind}"


@dataclasses.dataclass
class DistinctNode(PlanNode):
    child: PlanNode
    schema: List[Field]
    limit_hint: Optional[int] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class UnionNode(PlanNode):
    inputs: List[PlanNode]
    schema: List[Field]

    def children(self):
        return tuple(self.inputs)


@dataclasses.dataclass
class SetOpNode(PlanNode):
    """INTERSECT / EXCEPT (IntersectOrExceptTransform analog)."""
    left: PlanNode
    right: PlanNode
    op: str                        # intersect | except
    distinct: bool
    schema: List[Field]

    def children(self):
        return (self.left, self.right)


def explain_plan(node: PlanNode, indent: int = 0) -> str:
    """EXPLAIN PLAN rendering (QueryPlan::explainPlan analog)."""
    lines = ["  " * indent + node.label()]
    for c in node.children():
        lines.append(explain_plan(c, indent + 1))
    return "\n".join(lines)
