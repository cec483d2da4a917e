"""Out-of-core streaming of the CUDA engine against the JAX reference, on
the CPU.

The reference's streaming cases (tests/test_streaming.py) run through
``clickhouse_tpu.connect()`` and ``clickhouse_tpu_torch.connect(
device="cpu")`` over the same rows, inserted in the same parts, with the
thresholds that make every table "big" (STREAM: chunks of 1,024 rows, about
ten a table).  Each port run that streams is held to the reference's
streamed rows and to the port's own whole-block rows: integers and strings
exactly, floats within a relative 1e-9 (the chunks' partial sums add in
another order than one block's).  ``rows_read`` and the pruning events
must equal the reference's.  The shapes that stream through the other
programs (TopKProgram, CollectProgram, a grace join, blow-up streaming, a
holistic aggregate through CollectProgram) are held to the reference's
rows here once each; tests/test_torch_stream_programs.py holds every
reference case of them.

K13's plain version (ops/chunk_ops.py) is held against the reference's
own unpack (``_chunk_block``, run through JAX on the CPU) over bytes from
the reference's ``ChunkSource.encode_column``, for every nibble width.
"""
import math

import numpy as np
import pytest
import torch

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (CapacityError,
                                              MemoryLimitExceeded)

STREAM = {"max_device_block_bytes": 1, "stream_chunk_rows": 1024}
# a threshold between the dimension table's bytes and the big table's: the
# join's probe side streams, its build side is read whole (at 1 byte both
# are "big" and the reference takes its grace join)
PROBE = {"max_device_block_bytes": 4096, "stream_chunk_rows": 1024}
FLOAT_RTOL = 1e-9
N = 10_000


def _load(s):
    s.execute("CREATE TABLE big (id Int64, k Int64, kw Int64, v Float64, "
              "cat String, nv Nullable(Int64))")
    rng = np.random.default_rng(7)
    ids = np.arange(N, dtype=np.int64)
    k = (ids % 97).astype(np.int64)
    kw = rng.integers(0, 3000, N).astype(np.int64) * 1_000_003
    v = rng.normal(100.0, 10.0, N).round(3)
    cat = np.asarray([f"c{i % 13}" for i in range(N)], object)
    nv = np.asarray([None if i % 11 == 0 else int(i % 7) for i in range(N)],
                    object)
    for lo in range(0, N, 3_000):          # several parts
        hi = min(lo + 3_000, N)
        s.insert_pydict("big", {"id": ids[lo:hi], "k": k[lo:hi],
                                "kw": kw[lo:hi], "v": v[lo:hi],
                                "cat": cat[lo:hi], "nv": nv[lo:hi]})
    s.execute("CREATE TABLE dim (k Int64, name String)")
    s.insert_pydict("dim", {
        "k": np.arange(97, dtype=np.int64),
        "name": np.asarray([f"name{i}" for i in range(97)], object)})


@pytest.fixture(scope="module")
def sessions():
    js, ts = jch.connect(), tch.connect(device="cpu")
    _load(js)
    _load(ts)
    return js, ts


def _same(got, want, atol=1e-12) -> bool:
    if isinstance(want, float) or isinstance(got, float):
        if want is None or got is None:
            return got is want
        if math.isnan(want):
            return math.isnan(got)
        return math.isclose(got, want, rel_tol=FLOAT_RTOL, abs_tol=atol)
    return got == want


def _rows_match(got, want, atol=1e-12) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_same(a, b, atol) for a, b in zip(g, w))
        for g, w in zip(got, want))


def _streamed(s, sql, settings):
    before = s.profile_events.get("StreamedQueries", 0)
    r = s.execute(sql, settings=settings)
    assert s.profile_events.get("StreamedQueries", 0) == before + 1, \
        f"did not stream: {sql}"
    return r


def _both(sessions, sql, settings=STREAM):
    """The port's streamed rows against the reference's streamed rows and
    the port's whole-block rows; rows_read against the reference's."""
    js, ts = sessions
    want = _streamed(js, sql, settings)
    got = _streamed(ts, sql, settings)
    whole = ts.execute(sql).rows()
    assert _rows_match(got.rows(), want.rows()), (got.rows()[:5],
                                                  want.rows()[:5])
    assert _rows_match(got.rows(), whole), (got.rows()[:5], whole[:5])
    assert got.rows_read == want.rows_read
    return got.rows()


AGGREGATION = {
    "global": "SELECT count(), sum(v), min(v), max(v), avg(v), "
              "sum(k * 2 + 1) FROM big",
    "global-filter": "SELECT count(), sum(v) FROM big WHERE k < 40 AND "
                     "v > 95",
    "group-int": "SELECT k, count(), sum(v), min(id), max(id) FROM big "
                 "GROUP BY k ORDER BY k",
    "group-wide-key": "SELECT kw, count() AS c FROM big GROUP BY kw "
                      "ORDER BY c DESC, kw LIMIT 20",
    "group-string": "SELECT cat, count(), avg(v) FROM big GROUP BY cat "
                    "ORDER BY cat",
    "group-nullable": "SELECT nv, count() FROM big GROUP BY nv ORDER BY nv",
    "if-and-arg": "SELECT countIf(v > 100), sumIf(v, k = 5), argMax(id, v), "
                  "any(k) FROM big",
    "having-order-limit": "SELECT k, count() AS c, sum(v) AS sv FROM big "
                          "GROUP BY k HAVING c > 100 ORDER BY sv DESC "
                          "LIMIT 5",
    "expression-keys": "SELECT k % 10 AS b, intDiv(k, 10) AS h, count() "
                       "FROM big GROUP BY b, h ORDER BY b, h",
    "var-stddev": "SELECT k, varSamp(v), stddevPop(v) FROM big WHERE k < 5 "
                  "GROUP BY k ORDER BY k",
    "empty": "SELECT k, count() FROM big WHERE v > 1e9 GROUP BY k",
    "subquery": "SELECT count() FROM (SELECT k FROM big GROUP BY k "
                "HAVING count() > 0)",
}


@pytest.mark.parametrize("name", list(AGGREGATION))
def test_streamed_aggregation_matches_reference(sessions, name):
    rows = _both(sessions, AGGREGATION[name])
    if name == "group-int":
        assert len(rows) == 97


# every aggregate that merges, each plain and with -If, over a key and
# under GROUP BY (); -If conditions that leave some chunks' groups empty
MERGEABLE = ["count()", "sum(v)", "avg(v)", "min(v)", "max(id)", "any(k)",
             "varPop(v)", "varSamp(v)", "stddevPop(v)", "stddevSamp(v)",
             "covarPop(v, id)", "covarSamp(v, id)", "corr(v, id)",
             "skewPop(v)", "skewSamp(v)", "kurtPop(v)", "kurtSamp(v)",
             "avgWeighted(v, k)", "groupBitAnd(id)", "groupBitOr(id)",
             "groupBitXor(id)", "argMin(id, v)", "argMax(id, v)",
             "min(cat)", "max(cat)", "sumWithOverflow(k)"]


# where the reference's streamed run is not its whole-block answer (ROADMAP
# queue 3, ST1 and ST2): its merge of a min, max, any, argMin/argMax or
# groupBitAnd state under -If takes a chunk's group without a row as a
# value of 0 (ST1), and its String min/max leak a traced rank table out of
# its per-chunk program (ST2: UnexpectedTracerError).  The port is held
# to the reference's whole-block rows there.
PRESENCE = ("min(", "max(", "any(", "argMin(", "argMax(", "groupBitAnd(")
STRING_MINMAX = ("min(cat", "max(cat", "minIf(cat", "maxIf(cat")


def _if(agg: str) -> str:
    name, args = agg.split("(", 1)
    return f"{name}If({args[:-1]}{', ' if args[:-1] else ''}id < 2500)"


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
@pytest.mark.parametrize("agg", MERGEABLE + [_if(a) for a in MERGEABLE])
def test_every_mergeable_aggregate_streams(sessions, agg, grouped):
    """Each chunk's states merge into the carry as one block's would
    reduce: the reference's streamed rows and the port's whole-block rows
    (a -If whose rows lie in the first chunks only leaves the later
    chunks' groups without a row: min, max, any, groupBitAnd and argMin
    keep their presence count for it)."""
    sql = f"SELECT {agg} FROM big" if not grouped else \
        f"SELECT k % 7 AS g, {agg} FROM big GROUP BY g ORDER BY g"
    js, ts = sessions
    # skewness and kurtosis are differences of terms (mean / sd)^3 and ^4
    # times their size (mean 100, sd 10): held to 1e-9 of those terms
    atol = 1e-9 * 1e4 if agg.startswith(("skew", "kurt")) else 1e-12
    got = _streamed(ts, sql, STREAM).rows()
    assert _rows_match(got, ts.execute(sql).rows(), atol)
    if agg.startswith(STRING_MINMAX) or (
            "If(" in agg and agg.replace("If(", "(", 1).startswith(PRESENCE)):
        want = js.execute(sql).rows()                 # ST1, ST2
    else:
        want = _streamed(js, sql, STREAM).rows()
    assert _rows_match(got, want, atol)


@pytest.mark.parametrize("sql", [
    "SELECT name, count(), sum(v) FROM big INNER JOIN dim ON big.k = dim.k "
    "GROUP BY name ORDER BY name",
    "SELECT count() FROM big LEFT JOIN dim ON big.k = dim.k "
    "WHERE dim.k >= 0",
], ids=["inner-grouped", "left-filtered"])
def test_probe_side_join_streams(sessions, sql):
    """The probe side streams, the build side is read whole a chunk; with
    both tables above the threshold, both engines take the grace join."""
    _both(sessions, sql, PROBE)
    js, ts = sessions
    before = _events(ts, "GraceJoinBuckets")
    assert _both(sessions, sql, STREAM)
    assert _events(ts, "GraceJoinBuckets") > before


def test_autotune_rescues_chunk_overflow(sessions):
    js, ts = sessions
    sql = "SELECT count() FROM (SELECT kw FROM big GROUP BY kw)"
    st = {**STREAM, "max_groups": 512}
    got = ts.execute(sql, settings=st).rows()
    assert got == js.execute(sql, settings=st).rows() == \
        ts.execute(sql).rows()


def test_capacity_error_when_autotune_off(sessions):
    js, ts = sessions
    st = {**STREAM, "max_groups": 512, "capacity_autotune": 0}
    with pytest.raises(CapacityError):
        ts.execute("SELECT kw, count() FROM big GROUP BY kw", settings=st)


def test_stream_cache_reuse(sessions):
    _, ts = sessions
    sql = "SELECT k, sum(v) FROM big GROUP BY k ORDER BY k LIMIT 3"
    r1 = ts.execute(sql, settings=STREAM).rows()
    size = len(ts._stream_cache)
    r2 = ts.execute(sql, settings=STREAM).rows()
    assert r1 == r2 and len(ts._stream_cache) == size


@pytest.mark.parametrize("mod", [jch, tch], ids=["reference", "port"])
def test_insert_invalidates_stream_cache(mod):
    s = mod.connect() if mod is jch else mod.connect(device="cpu")
    s.execute("CREATE TABLE inc (k Int64, v Int64)")
    s.insert_pydict("inc", {"k": np.zeros(2048, np.int64),
                            "v": np.ones(2048, np.int64)})
    sql = "SELECT sum(v) FROM inc"
    assert s.execute(sql, settings=STREAM).rows() == [(2048,)]
    s.insert_pydict("inc", {"k": np.zeros(10, np.int64),
                            "v": np.full(10, 5, np.int64)})
    assert s.execute(sql, settings=STREAM).rows() == [(2098,)]


def test_drop_and_create_invalidates_stream_cache():
    """A table dropped and created again under its name starts at the same
    version: the cached program, which holds the old table's chunks, must
    not answer for the new one."""
    s = tch.connect(device="cpu")
    sql = "SELECT count(), sum(v) FROM again"
    for v in (1, 7):
        s.execute("DROP TABLE IF EXISTS again")
        s.execute("CREATE TABLE again (v Int64)")
        s.insert_pydict("again", {"v": np.full(3000, v, np.int64)})
        assert _streamed(s, sql, STREAM).rows() == [(3000, 3000 * v)]


@pytest.mark.parametrize("agg", ["argMin", "argMax"])
@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_arg_min_max_of_uint64_order_streams(agg, grouped):
    """A UInt64 order above 2^63 is carried signed from chunk to chunk
    (its top bit flipped): the streamed rows are the reference's and the
    port's whole-block rows."""
    rng = np.random.default_rng(11)
    n = 5000
    # one order value on the other side of 2^63 from the rest, in a late
    # chunk: a signed merge would keep an earlier chunk's best
    if agg == "argMax":
        o = rng.integers(0, 2 ** 62, n, dtype=np.uint64)
        o[4321] = 2 ** 64 - 2
    else:
        o = rng.integers(2 ** 63, 2 ** 64 - 1, n, dtype=np.uint64)
        o[4321] = 3
    data = {"id": np.arange(n, dtype=np.int64),
            "k": (np.arange(n) % 5).astype(np.int64), "o": o}
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute("CREATE TABLE u (id Int64, k Int64, o UInt64)")
        for lo in range(0, n, 2000):
            s.insert_pydict("u", {c: x[lo:lo + 2000]
                                  for c, x in data.items()})
    sql = f"SELECT {agg}(id, o) FROM u" if not grouped else \
        f"SELECT k, {agg}(id, o) FROM u GROUP BY k ORDER BY k"
    got = _streamed(ts, sql, STREAM).rows()
    assert got == ts.execute(sql).rows()
    assert got == js.execute(sql).rows()


def test_uneven_final_chunk():
    s = tch.connect(device="cpu")
    s.execute("CREATE TABLE odd (x Int64)")
    s.insert_pydict("odd", {"x": np.arange(2500, dtype=np.int64)})
    r = _streamed(s, "SELECT count(), sum(x), max(x) FROM odd", STREAM)
    assert r.rows() == [(2500, 2500 * 2499 // 2, 2499)]
    assert r.rows_read == 2500


def test_external_group_by_setting_triggers(sessions):
    js, ts = sessions
    st = {"max_bytes_before_external_group_by": 1, "stream_chunk_rows": 2048}
    assert _streamed(ts, "SELECT count() FROM big", st).rows() == [(N,)]
    assert _streamed(js, "SELECT count() FROM big", st).rows() == [(N,)]


@pytest.mark.parametrize("mod", [jch, tch], ids=["reference", "port"])
def test_final_read_does_not_stream(mod):
    """FINAL folds need the whole table: neither engine streams it, and
    both answer on the whole block."""
    s = mod.connect() if mod is jch else mod.connect(device="cpu")
    s.execute("CREATE TABLE r (k Int64, v Int64) "
              "ENGINE = ReplacingMergeTree ORDER BY k")
    s.insert_pydict("r", {"k": np.arange(2000, dtype=np.int64),
                          "v": np.ones(2000, np.int64)})
    before = s.profile_events.get("StreamedQueries", 0)
    assert s.execute("SELECT count() FROM r FINAL",
                     settings=STREAM).rows() == [(2000,)]
    assert s.profile_events.get("StreamedQueries", 0) == before


# -- the memory governor -----------------------------------------------------

@pytest.mark.parametrize("mod", [jch, tch], ids=["reference", "port"])
def test_unstreamable_over_budget_raises(mod):
    s = mod.connect() if mod is jch else mod.connect(device="cpu")
    err = MemoryLimitExceeded if mod is tch else \
        __import__("clickhouse_tpu.core.errors",
                   fromlist=["x"]).MemoryLimitExceeded
    s.execute("CREATE TABLE r (k Int64, v Int64) "
              "ENGINE = ReplacingMergeTree ORDER BY k")
    s.insert_pydict("r", {"k": np.arange(3000, dtype=np.int64),
                          "v": np.ones(3000, np.int64)})
    with pytest.raises(err, match="no streaming rewrite"):
        s.execute("SELECT count() FROM r FINAL",
                  settings={"max_device_block_bytes": 1,
                            "max_device_memory_bytes": 1})
    assert s.execute("SELECT count() FROM r").rows() == [(3000,)]


def test_eager_path_governed():
    s = tch.connect(device="cpu")
    s.execute("CREATE TABLE t (x Int64)")
    s.insert_pydict("t", {"x": np.arange(4096, dtype=np.int64)})
    with pytest.raises(MemoryLimitExceeded):
        s.execute("SELECT count() FROM t FINAL",
                  settings={"compile_queries": 0,
                            "max_device_memory_bytes": 1})


@pytest.mark.parametrize("mod", [jch, tch], ids=["reference", "port"])
def test_streaming_rescues_over_budget(mod):
    s = mod.connect() if mod is jch else mod.connect(device="cpu")
    s.execute("CREATE TABLE t (x Int64)")
    s.insert_pydict("t", {"x": np.arange(5000, dtype=np.int64)})
    r = s.execute("SELECT sum(x) FROM t",
                  settings={"max_device_block_bytes": 1,
                            "stream_chunk_rows": 1024,
                            "max_device_memory_bytes": 1})
    assert r.rows() == [(5000 * 4999 // 2,)]


# -- part pruning ------------------------------------------------------------

PRUNE = {"max_device_block_bytes": 1024, "stream_chunk_rows": 1024}


def _parts(mod):
    s = mod.connect() if mod is jch else mod.connect(device="cpu")
    s.execute("CREATE TABLE big (k Int64, v Int64)")
    for p in range(4):
        s.insert_pydict("big", {
            "k": np.arange(p * 1000, p * 1000 + 1000, dtype=np.int64),
            "v": np.ones(1000, np.int64) * p})
    return s


@pytest.mark.parametrize("sql,rows,pruned", [
    ("SELECT count(), sum(v) FROM big WHERE k >= 2000 AND k < 3000",
     [(1000, 2000)], 3),
    ("SELECT count() FROM big WHERE k = 3500", [(1,)], 3),
    ("SELECT count() FROM big", [(4000,)], None),
    ("SELECT count() FROM big WHERE v % 2 = 0", [(2000,)], None),
    ("SELECT count() FROM big WHERE k > 100000", [(0,)], 4),
], ids=["range", "point", "no-filter", "unprovable", "all-pruned"])
def test_part_pruning_matches_reference(sql, rows, pruned):
    js, ts = _parts(jch), _parts(tch)
    want = _streamed(js, sql, PRUNE)
    got = _streamed(ts, sql, PRUNE)
    assert got.rows() == want.rows() == rows
    assert got.rows_read == want.rows_read
    assert ts.profile_events.get("PrunedParts") \
        == js.profile_events.get("PrunedParts") == pruned


def test_granules_of_the_order_by_key_are_pruned():
    """Within a surviving part, the granules whose ORDER BY key min/max
    refute the filter are not read."""
    s = tch.connect(device="cpu")
    s.execute("CREATE TABLE g (k Int64, v Int64) ENGINE = MergeTree "
              "ORDER BY k")
    s.insert_pydict("g", {"k": np.arange(40_000, dtype=np.int64),
                          "v": np.ones(40_000, np.int64)})
    r = _streamed(s, "SELECT count(), sum(k) FROM g WHERE k >= 30000",
                  {**PRUNE, "optimize_move_to_prewhere": 0})
    assert r.rows() == [(10_000, sum(range(30_000, 40_000)))]
    assert s.profile_events.get("PrunedGranules") == 3
    assert r.rows_read < 40_000


# -- host PREWHERE -----------------------------------------------------------

def _events(s, name):
    return s.profile_events.get(name, 0)


def test_selective_filter_streams_survivors_only(sessions):
    js, ts = sessions
    before = (_events(js, "PrewhereRowsDropped"),
              _events(ts, "PrewhereRowsDropped"))
    _both(sessions, "SELECT count(), sum(v) FROM big WHERE k = 13")
    dropped = (_events(js, "PrewhereRowsDropped") - before[0],
               _events(ts, "PrewhereRowsDropped") - before[1])
    assert dropped[1] == dropped[0] > 0.9 * N


def test_prewhere_disabled_setting(sessions):
    js, ts = sessions
    st = dict(STREAM, optimize_move_to_prewhere=0)
    before = _events(ts, "PrewhereStreamedScans")
    rows = _streamed(ts, "SELECT count() FROM big WHERE k = 13", st).rows()
    assert _events(ts, "PrewhereStreamedScans") == before
    assert rows == js.execute("SELECT count() FROM big WHERE k = 13").rows()


def test_unselective_predicate_keeps_aligned_path(sessions):
    _, ts = sessions
    before = _events(ts, "PrewhereStreamedScans")
    _both(sessions, "SELECT count() FROM big WHERE k >= 0")
    assert _events(ts, "PrewhereStreamedScans") == before


def test_mixed_conjuncts_partial_host_eval(sessions):
    _both(sessions, "SELECT count(), avg(v) FROM big "
                    "WHERE k = 13 AND cat != 'c1'")


# -- the other programs ------------------------------------------------------

@pytest.mark.parametrize("sql,settings,program", [
    ("SELECT id, v FROM big ORDER BY v LIMIT 7", STREAM, "TopKProgram"),
    ("SELECT id, v FROM big WHERE k = 13 AND id > 100 ORDER BY id LIMIT 7",
     STREAM, "TopKProgram"),
    ("SELECT id, v FROM big WHERE k = 13", STREAM, "CollectProgram"),
    ("SELECT quantileExact(0.5)(v) FROM big", STREAM,
     "holistic aggregate quantileExact.*CollectProgram"),
    ("SELECT count(), sum(v) FROM big INNER JOIN dim ON big.k = dim.k",
     STREAM, "grace join"),
], ids=["topk", "topk-prewhere", "collect", "holistic", "grace"])
def test_unported_stream_programs_raise_naming_them(sessions, sql, settings,
                                                    program):
    """Each shape that the reference streams through another program than
    the aggregation's (once raised naming the program) now streams
    through the port's: the reference's rows, in order, and the port's
    whole-block rows; the grace join counts its buckets."""
    js, ts = sessions
    before = _events(ts, "GraceJoinBuckets")
    assert _both(sessions, sql, settings)
    assert (_events(ts, "GraceJoinBuckets") > before) == (
        program == "grace join")


def test_blowup_streaming_raises_naming_it():
    """A cross join's intermediate over the budget: both engines chunk its
    probe side (blow-up streaming, BlowupStreamedQueries) to the same
    answer; a joined block that cannot fit raises MemoryLimitExceeded in
    both."""
    sql = "SELECT count(*) FROM numbers(10000) n1 CROSS JOIN numbers(1000) n2"
    st = {"max_memory_usage": 16000000, "max_joined_block_size_rows": 1000}
    assert jch.connect().execute(sql, settings=st).rows() == [(10_000_000,)]
    ts = tch.connect(device="cpu")
    assert ts.execute(sql, settings=st).rows() == [(10_000_000,)]
    assert _events(ts, "BlowupStreamedQueries") == 1
    with pytest.raises(MemoryLimitExceeded, match="expanding join"):
        ts.execute(sql, settings={**st,
                                  "max_joined_block_size_rows": 10000000})


# -- K13's plain version against the reference's unpack ----------------------

@pytest.mark.parametrize("w4", [4, 8, 12, 16, 20, 24, 28])
@pytest.mark.parametrize("rows", [3, 2047, 4097])
def test_unpack_pairs_plain_matches_reference(w4, rows):
    """The reference's ChunkSource.encode_column packs a column spanning
    w4 bits from a negative lower bound; the port encodes the same bytes,
    and K13's plain version unpacks them as the reference's _chunk_block
    does, over every row of the chunk (capacities 2 * odd, padding
    included)."""
    import jax.numpy as jnp
    from clickhouse_tpu.exec.streaming import _chunk_block as ref_unpack
    from clickhouse_tpu.storage.table import ChunkSource as RefSource
    from clickhouse_tpu_torch.ops.chunk_ops import unpack_pairs
    from clickhouse_tpu_torch.storage.table import ChunkSource
    lo = -(1 << (w4 - 1)) - 5
    rng = np.random.default_rng(w4 * 7 + rows)
    x = rng.integers(lo, lo + (1 << w4), rows).astype(np.int64)
    x[0], x[-1] = lo, lo + (1 << w4) - 1            # the span's ends
    half = rows // 2 + 1
    cap = 2 * (half + 1 - half % 2)            # twice an odd number
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute("CREATE TABLE p (x Int64)")
        s.insert_pydict("p", {"x": x})
    ref = RefSource(js.catalog.get_table("default", "p"), ["x"], cap)
    src = ChunkSource(ts.catalog.get_table("default", "p"), ["x"], cap)
    assert src.packed["x"] == ref.packed["x"]
    w, off, bpp = src.packed["x"]
    assert w == w4 and off == lo
    want_bytes, _ = ref.encode_column("x", x, cap)
    got_bytes, _ = src.encode_column("x", x, cap)
    assert np.array_equal(got_bytes, want_bytes)
    blk = ref_unpack({"cols": {"x": {"data": jnp.asarray(want_bytes)}},
                      "num_rows": rows}, ref,
                     js.catalog.get_table("default", "p"))
    want = np.asarray(blk["x"].data)
    got = unpack_pairs(torch.from_numpy(got_bytes), w, off, bpp, cap,
                       torch.from_numpy(np.zeros(0, want.dtype)).dtype)
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[:rows], x)


def test_unpack_pairs_refuses_a_bad_layout():
    from clickhouse_tpu_torch.ops.chunk_ops import unpack_pairs
    with pytest.raises(ValueError, match="unpack_pairs"):
        unpack_pairs(torch.zeros(10, dtype=torch.uint8), 20, 0, 5, 5,
                     torch.int32)            # an odd capacity
    with pytest.raises(ValueError, match="unpack_pairs"):
        unpack_pairs(torch.zeros(10, dtype=torch.uint8), 20, 0, 4, 4,
                     torch.int32)            # bpp is w4 / 4


# -- the chunk pipeline ------------------------------------------------------

def test_read_pool_and_prefetch_keep_chunk_order(sessions):
    """stream_readers > 1 encodes chunks on reader threads, the feeder
    thread copies them ahead; the chunks still merge in index order, so a
    float sum is bit-equal to the one-reader run (more readers than
    chunks, threads switched often)."""
    import sys
    _, ts = sessions
    sql = "SELECT k, sum(v), avg(v) FROM big GROUP BY k ORDER BY k"
    one = _streamed(ts, sql, STREAM).rows()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for readers in (2, 16):
            got = _streamed(ts, sql, {**STREAM,
                                      "stream_readers": readers}).rows()
            assert got == one
    finally:
        sys.setswitchinterval(interval)


def test_a_failing_chunk_read_reaches_the_query(monkeypatch):
    """An error while a chunk is read (on the feeder or a reader thread)
    is raised by the query, and no thread is left running."""
    import threading
    from clickhouse_tpu_torch.storage.table import ChunkSource
    s = tch.connect(device="cpu")
    s.execute("CREATE TABLE f (x Int64)")
    s.insert_pydict("f", {"x": np.arange(10_000, dtype=np.int64)})
    real = ChunkSource._chunk_uncached

    def broken(self, i):
        if i == 5:
            raise OSError("disk gone")
        return real(self, i)

    monkeypatch.setattr(ChunkSource, "_chunk_uncached", broken)
    before = threading.active_count()
    for readers in (1, 3):
        with pytest.raises(OSError, match="disk gone"):
            s.execute("SELECT sum(x) FROM f",
                      settings={**STREAM, "stream_readers": readers})
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=5)
    assert threading.active_count() <= before


def test_hash_token_dictionary_streams(monkeypatch):
    """A String column of at least HASH_DICT_MIN_ROWS rows takes the
    hash-token dictionary (no sort of its values); its groups are the
    sorted dictionary's."""
    from clickhouse_tpu_torch.storage.table import ChunkSource
    monkeypatch.setattr(ChunkSource, "HASH_DICT_MIN_ROWS", 1000)
    s = tch.connect(device="cpu")
    s.execute("CREATE TABLE h (s Nullable(String), v Int64)")
    vals = np.asarray([None if i % 17 == 0 else f"v{i % 50}é"
                       for i in range(6000)], object)
    s.insert_pydict("h", {"s": vals, "v": np.arange(6000, dtype=np.int64)})
    sql = "SELECT s, count(), sum(v) FROM h GROUP BY s ORDER BY s"
    got = _streamed(s, sql, STREAM).rows()
    src = s.catalog.get_table("default", "h")._chunk_source_cache[1]
    assert "s" in src._dict_hashes
    assert got == s.execute(sql).rows()
    assert len(got) == 51 and got[-1][0] is None
