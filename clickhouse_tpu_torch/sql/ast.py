"""Abstract syntax tree for the SQL dialect.

Analog of the reference's IAST hierarchy (src/Parsers/IAST.h:32), reduced to
plain dataclasses.  Binary/unary operators are desugared by the parser into
FuncCall nodes with ClickHouse function names (plus/less/and/...), exactly as
the reference's ExpressionListParsers does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

__all__ = [
    "Expr", "Identifier", "Literal", "Star", "FuncCall", "WindowSpec",
    "Tuple_", "Subquery",
    "SelectItem", "TableRef", "TableFunctionRef", "SubqueryRef", "Join",
    "OrderItem", "Select", "Union", "Insert", "ColumnDef", "CreateTable",
    "CreateDatabase", "DropTable", "ShowTables", "Describe", "Explain",
    "SetStatement", "Use", "TruncateTable", "CTE", "format_expr",
]


class Expr:
    pass


@dataclasses.dataclass
class Identifier(Expr):
    name: str                      # possibly qualified: "t.x" keeps parts
    parts: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.parts:
            self.parts = tuple(self.name.split("."))


@dataclasses.dataclass
class Literal(Expr):
    value: Any                     # int | float | str | None | bool | tuple


@dataclasses.dataclass
class Star(Expr):
    table: Optional[str] = None    # t.* qualifier
    # column transformers: ("except", [names]) | ("apply", fn_name) |
    # ("replace", [(expr, col_name)])  (ref: ParserColumnsTransformers)
    transformers: List[tuple] = dataclasses.field(default_factory=list)
    columns_re: Optional[str] = None   # COLUMNS('regex') matcher


@dataclasses.dataclass
class WindowSpec:
    partition_by: List["Expr"] = dataclasses.field(default_factory=list)
    order_by: List["OrderItem"] = dataclasses.field(default_factory=list)
    # None | "running" (RANGE UNBOUNDED PRECEDING..CURRENT ROW, peers) |
    # "full" | ("rows"|"range", lo, hi) with lo/hi: None = unbounded,
    # 0 = current row, signed int = offset (negative PRECEDING)
    frame: object = None


@dataclasses.dataclass
class FuncCall(Expr):
    name: str
    args: List[Expr]
    params: Optional[List[Expr]] = None    # quantile(0.5)(x)
    distinct: bool = False                 # count(DISTINCT x)
    over: Optional[WindowSpec] = None      # fn(...) OVER (...)


@dataclasses.dataclass
class Tuple_(Expr):
    items: List[Expr]


@dataclasses.dataclass
class Lambda(Expr):
    """x -> expr / (x, y) -> expr — higher-order function argument."""
    params: List[str]
    body: Expr


@dataclasses.dataclass
class Subquery(Expr):
    query: "Select"


@dataclasses.dataclass
class Aliased(Expr):
    """Expression-level alias — ClickHouse lets ANY parenthesized or
    argument expression carry `AS name`, visible query-wide
    (ref: ExpressionListParsers.cpp ParserWithOptionalAlias)."""
    expr: Expr
    alias: str


# -- SELECT ------------------------------------------------------------------

@dataclasses.dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclasses.dataclass
class TableRef:
    database: Optional[str]
    table: str
    alias: Optional[str] = None
    final: bool = False
    sample: Optional[float] = None     # SAMPLE ratio in (0, 1]


@dataclasses.dataclass
class TableFunctionRef:
    func: FuncCall
    alias: Optional[str] = None


@dataclasses.dataclass
class SubqueryRef:
    query: Union["Select", "Union"]
    alias: Optional[str] = None


@dataclasses.dataclass
class Join:
    kind: str                      # inner|left|right|full|cross
    strictness: str                # all|any|semi|anti|asof
    table: Union[TableRef, TableFunctionRef, SubqueryRef]
    on: Optional[Expr] = None
    using: Optional[List[str]] = None
    is_global: bool = False


@dataclasses.dataclass
class OrderItem:
    expr: Expr
    descending: bool = False
    nulls_last: Optional[bool] = None   # None = dialect default
    # WITH FILL [FROM e] [TO e] [STEP e]: (from, to, step) exprs or None
    fill: Optional[tuple] = None
    collate: Optional[str] = None       # COLLATE 'locale'


@dataclasses.dataclass
class CTE:
    name: str
    query: Optional[Union["Select", "Union"]] = None
    expr: Optional[Expr] = None         # WITH <expr> AS name scalar form
    recursive: bool = False             # WITH RECURSIVE name AS (...)


@dataclasses.dataclass
class Select:
    items: List[SelectItem]
    from_: Optional[Union[TableRef, TableFunctionRef, SubqueryRef]] = None
    joins: List[Join] = dataclasses.field(default_factory=list)
    where: Optional[Expr] = None
    prewhere: Optional[Expr] = None
    group_by: Optional[List[Expr]] = None
    group_by_with_totals: bool = False
    group_by_modifier: Optional[str] = None   # rollup | cube | grouping_sets
    grouping_sets: Optional[List[List["Expr"]]] = None
    having: Optional[Expr] = None
    order_by: Optional[List[OrderItem]] = None
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    limit_by: Optional[Tuple[Expr, List[Expr]]] = None   # (n, exprs)
    distinct: bool = False
    ctes: List[CTE] = dataclasses.field(default_factory=list)
    settings: Dict[str, Any] = dataclasses.field(default_factory=dict)
    outfile: Optional[str] = None
    format: Optional[str] = None
    # ARRAY JOIN clause: (kind 'inner'|'left', [(expr, alias|None), ...])
    array_join: Optional[tuple] = None
    # WINDOW name AS (spec) named-window definitions
    windows: Dict[str, "WindowSpec"] = dataclasses.field(default_factory=dict)
    # ORDER BY ... INTERPOLATE (col AS expr, ...): [(name, expr|None)]
    interpolate: Optional[list] = None
    limit_with_ties: bool = False


@dataclasses.dataclass
class Union:
    selects: List[Union["Select", "Union"]]
    mode: str = "all"              # all|distinct
    mode_explicit: bool = True     # False: bare UNION (DISTINCT in WITH
                                   # RECURSIVE, per SQL standard)


@dataclasses.dataclass
class SetOp:
    """INTERSECT / EXCEPT (reference: ASTSelectIntersectExceptQuery)."""
    left: object                   # Select | Union | SetOp
    right: object
    op: str                        # intersect | except
    distinct: bool = False         # ALL (default) keeps multiset counts


# -- DDL / DML ---------------------------------------------------------------

@dataclasses.dataclass
class ColumnDef:
    name: str
    type_name: str                     # "" = infer from default expr
    default: Optional[Expr] = None
    codec: Optional[str] = None        # 'Delta, LZ4' codec chain
    # default kind: default | materialized | alias | ephemeral
    default_kind: str = "default"


@dataclasses.dataclass
class IndexDef:
    """Skip index: INDEX name expr TYPE kind(params) GRANULARITY n
    (reference: src/Storages/MergeTree/MergeTreeIndices.h)."""
    name: str
    expr: Expr
    kind: str                          # minmax | set | bloom_filter | ...
    params: List[Any] = dataclasses.field(default_factory=list)
    granularity: int = 1


@dataclasses.dataclass
class CreateTable:
    database: Optional[str]
    table: str
    columns: List[ColumnDef]
    # CREATE TABLE x AS other_table / AS table_function(...)
    as_table: Optional[Tuple[Optional[str], str]] = None
    as_table_function: Optional[FuncCall] = None
    cluster: Optional[str] = None
    constraints: List[Tuple[str, Expr]] = dataclasses.field(
        default_factory=list)
    engine: str = "Memory"
    engine_args: List[str] = dataclasses.field(default_factory=list)
    order_by: Optional[List[Expr]] = None
    partition_by: Optional[Expr] = None
    primary_key: Optional[List[Expr]] = None
    settings: Dict[str, Any] = dataclasses.field(default_factory=dict)
    if_not_exists: bool = False
    as_select: Optional[Union[Select, "Union"]] = None
    ttl: Optional[str] = None          # table-level TTL expression text
    sample_by: Optional[Expr] = None   # SAMPLE BY key expression
    # PROJECTION name (SELECT ... GROUP BY ...) declarations
    projections: List[tuple] = dataclasses.field(default_factory=list)
    # INDEX declarations (skip indexes)
    indexes: List["IndexDef"] = dataclasses.field(default_factory=list)
    or_replace: bool = False


@dataclasses.dataclass
class CreateDatabase:
    name: str
    if_not_exists: bool = False
    engine: Optional[str] = None
    cluster: Optional[str] = None
    engine_args: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CreateView:
    database: Optional[str]
    name: str
    query: Union["Select", "Union"]
    materialized: bool = False
    to_table: Optional[str] = None     # MATERIALIZED ... TO target
    if_not_exists: bool = False
    cluster: Optional[str] = None
    populate: bool = False             # POPULATE: backfill at create


@dataclasses.dataclass
class Insert:
    database: Optional[str]
    table: str
    columns: Optional[List[str]] = None
    values: Optional[List[List[Expr]]] = None
    select: Optional[Union[Select, "Union"]] = None
    infile: Optional[str] = None
    format: Optional[str] = None
    inline_data: Optional[str] = None   # raw data after FORMAT fmt
    table_function: Optional[FuncCall] = None
    settings: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DropTable:
    database: Optional[str]
    table: str
    if_exists: bool = False
    is_database: bool = False
    cluster: Optional[str] = None


@dataclasses.dataclass
class TruncateTable:
    database: Optional[str]
    table: str
    if_exists: bool = False
    cluster: Optional[str] = None


@dataclasses.dataclass
class MultiStatement:
    """Several statements produced by one source statement (DROP USER a, b);
    executed in order, last result returned."""
    statements: List[object] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DetachAttach:
    """DETACH TABLE (drop from catalog, keep durable data) / bare
    ATTACH TABLE (reload from the durable store)."""
    kind: str                       # detach | attach
    database: Optional[str]
    table: str
    if_exists: bool = False


@dataclasses.dataclass
class OptimizeTable:
    database: Optional[str]
    table: str
    final: bool = False


@dataclasses.dataclass
class CreateDictionary:
    database: Optional[str]
    name: str
    columns: List["ColumnDef"] = dataclasses.field(default_factory=list)
    primary_key: Optional[str] = None
    source_table: Optional[str] = None


@dataclasses.dataclass
class CreateUser:
    name: str
    password: Optional[str] = None
    if_not_exists: bool = False


@dataclasses.dataclass
class DropUser:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class CreateRole:
    name: str
    if_not_exists: bool = False


@dataclasses.dataclass
class CreateQuota:
    name: str
    duration_s: int
    maxes: Dict[str, int]
    users: List[str]
    if_not_exists: bool = False


@dataclasses.dataclass
class CreateRowPolicy:
    name: str
    database: Optional[str]
    table: str
    using_text: str
    users: List[str]
    if_not_exists: bool = False


@dataclasses.dataclass
class DropAccessEntity:
    kind: str                      # role | quota | row_policy
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class GrantRevoke:
    kind: str                      # grant | revoke
    privileges: List[str] = dataclasses.field(default_factory=list)
    target: str = "*.*"
    user: str = "default"


@dataclasses.dataclass
class AlterTable:
    database: Optional[str]
    table: str
    action: str      # delete|update|add_column|drop_column|add_projection|
                     # drop_projection|materialize_projection|modify_ttl|
                     # modify_column|rename_column|clear_column|add_index|
                     # drop_index|drop_partition|detach_partition|
                     # attach_partition|modify_setting|modify_order_by|...
    predicate: Optional[Expr] = None
    updates: Optional[List[Tuple[str, Expr]]] = None
    column: Optional[ColumnDef] = None
    column_name: Optional[str] = None
    projection: Optional[tuple] = None      # (name, select_ast or None)
    ttl: Optional[str] = None
    new_name: Optional[str] = None          # RENAME COLUMN target
    index: Optional["IndexDef"] = None      # ADD INDEX
    index_name: Optional[str] = None
    partition: Optional[Expr] = None        # PARTITION expr / ID 'x'
    from_table: Optional[Tuple[Optional[str], str]] = None  # ATTACH ... FROM
    settings: Dict[str, Any] = dataclasses.field(default_factory=dict)
    if_exists: bool = False
    cluster: Optional[str] = None


@dataclasses.dataclass
class AlterMulti:
    """ALTER TABLE t action1, action2, ... (one mutation entry each,
    applied in order — reference ASTAlterQuery command list)."""
    database: Optional[str]
    table: str
    actions: List[AlterTable] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BackupRestore:
    kind: str                      # backup | restore
    database: Optional[str]
    table: str
    path: str
    disk: Optional[str] = None     # Disk('name', 'path') target


@dataclasses.dataclass
class ShowTables:
    databases: bool = False
    like: Optional[str] = None
    not_like: bool = False


@dataclasses.dataclass
class ShowCreate:
    """SHOW CREATE TABLE/DATABASE/VIEW/DICTIONARY t."""
    kind: str                      # table | database
    database: Optional[str] = None
    table: str = ""


@dataclasses.dataclass
class Describe:
    database: Optional[str]
    table: str
    table_expr: object = None      # TableFunctionRef | SubqueryRef


@dataclasses.dataclass
class Explain:
    kind: str                      # ast|plan|pipeline|estimate|syntax|...
    query: Union[Select, "Union"]
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CreateFunction:
    """CREATE FUNCTION name AS (args) -> expr — SQL UDF
    (ref: src/Interpreters/UserDefinedSQLFunctionFactory.cpp)."""
    name: str
    params: List[str] = dataclasses.field(default_factory=list)
    body: Optional[Expr] = None
    or_replace: bool = False
    if_not_exists: bool = False


@dataclasses.dataclass
class DropFunction:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class RenameTable:
    """RENAME TABLE a TO b[, c TO d] / EXCHANGE TABLES a AND b."""
    pairs: List[Tuple[Tuple[Optional[str], str],
                      Tuple[Optional[str], str]]]
    exchange: bool = False
    cluster: Optional[str] = None


@dataclasses.dataclass
class SetStatement:
    changes: Dict[str, Any]


@dataclasses.dataclass
class SystemCommand:
    """SYSTEM <command> — accepted for reference compatibility; commands
    that manage background machinery (FLUSH LOGS, STOP MERGES, SYNC
    REPLICA...) are no-ops in this engine's synchronous model."""
    command: str


@dataclasses.dataclass
class KillQuery:
    """KILL QUERY WHERE <cond> [SYNC|ASYNC] (ref: InterpreterKillQuery)."""
    where: Expr
    sync: bool = False


@dataclasses.dataclass
class Use:
    database: str


@dataclasses.dataclass
class CheckTable:
    database: Optional[str]
    table: str


@dataclasses.dataclass
class ExistsTable:
    database: Optional[str]
    table: str


def window_key(e: "FuncCall") -> str:
    """What makes two window calls one: the call's text (format_expr, which
    names the column), its frame, and its ORDER BY items' NULLS FIRST/LAST.
    format_expr writes neither of the last two, so two calls that differ
    only there would share one result (W1, the reference's keying by the
    text alone: clickhouse_tpu/plan/analyzer.py:1270-1276, :2247-2249)."""
    nulls = tuple(o.nulls_last for o in e.over.order_by)
    return f"{format_expr(e)} FRAME {e.over.frame!r} NULLS {nulls!r}"


def format_expr(e: Expr) -> str:
    """Debug/EXPLAIN rendering of an expression."""
    if isinstance(e, Identifier):
        return e.name
    if isinstance(e, Literal):
        if isinstance(e.value, str):
            return "'" + e.value.replace("'", "\\'") + "'"
        if e.value is None:
            return "NULL"
        return str(e.value)
    if isinstance(e, Star):
        return f"{e.table}.*" if e.table else "*"
    if isinstance(e, FuncCall):
        params = ""
        if e.params:
            params = "(" + ", ".join(format_expr(p) for p in e.params) + ")"
        d = "DISTINCT " if e.distinct else ""
        base = f"{e.name}{params}({d}{', '.join(format_expr(a) for a in e.args)})"
        if e.over is not None:
            parts = []
            if e.over.partition_by:
                parts.append("PARTITION BY " + ", ".join(
                    format_expr(p) for p in e.over.partition_by))
            if e.over.order_by:
                parts.append("ORDER BY " + ", ".join(
                    format_expr(o.expr) + (" DESC" if o.descending else "")
                    for o in e.over.order_by))
            base += " OVER (" + " ".join(parts) + ")"
        return base
    if isinstance(e, Tuple_):
        return "(" + ", ".join(format_expr(i) for i in e.items) + ")"
    if isinstance(e, Lambda):
        head = e.params[0] if len(e.params) == 1 \
            else "(" + ", ".join(e.params) + ")"
        return f"{head} -> {format_expr(e.body)}"
    if isinstance(e, Aliased):
        return f"({format_expr(e.expr)} AS {e.alias})"
    if isinstance(e, Subquery):
        return "(<subquery>)"
    return repr(e)
