"""The CUDA engine's joins against the JAX reference, on the CPU.

The same SQL runs through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")`` over the same rows (made
from a seed with numpy, loaded into the reference, read back from its
table and handed to the port with ``interop.table_from_numpy``).  Rows
compare IN ORDER: a join's output is probe-major in both engines (the
probe rows in place for an N:1 join; for a 1:N join each probe row's
matches follow in key-sorted build order, ascending build row id within a
key).  Integers must agree exactly, floats within rtol=1e-12 (sums add in
different orders).

The tables stay at most 20,000 probe rows, in one module-scoped pair of
sessions.
"""
import math

import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu.sql.parser import parse as jparse
from clickhouse_tpu_torch.core.errors import CapacityError
from clickhouse_tpu_torch.interop import table_from_numpy
from clickhouse_tpu_torch.plan import logical as TL
from clickhouse_tpu_torch.sql.parser import parse as tparse

FLOAT_RTOL = 1e-12
N_FACT = 20_000
N_DIM = 1000

TYPES = {
    "fact": {"fk": "Int64", "w": "Float64", "i": "Int32", "s": "String",
             "nk": "Nullable(Int64)", "fl": "Float64", "a": "Int32",
             "b": "UInt8", "c": "Int16"},
    "dim": {"k": "Int64", "label": "Int64", "big": "UInt64", "f": "Float64",
            "name": "String", "nlab": "Nullable(Int32)", "g": "Float32"},
    "dimd": {"k": "Int64", "label": "Int64", "name": "String",
             "f": "Float64"},
    "dims": {"s": "String", "v": "Int64"},
    "dimn": {"nk": "Nullable(Int64)", "v": "Int64"},
    "dimf": {"fl": "Float64", "v": "Int64"},
    "dimm": {"a": "Int32", "b": "UInt8", "c": "Int16", "v": "Int64"},
    "l1": {"a": "Int64", "x": "String"},
    "r1": {"b": "Int64", "y": "Float64"},
    "u1": {"id": "Int64", "p": "Int32"},
    "u2": {"id": "Int64", "q": "String"},
}


def _reference_columns(js, table):
    blk = js.catalog.get_table("default", table).read_block()
    return {name: np.asarray(v) for name, v in blk.to_pydict().items()}


def _tables(rng):
    fk = rng.integers(0, 2 * N_DIM, N_FACT)              # half miss
    nk = rng.integers(0, 50, N_FACT).astype(object)
    nk[rng.random(N_FACT) < 0.2] = None
    fl_pool = np.array([0.0, -0.0, np.nan, 1.5, -2.25, 3.0, np.inf])
    kd = np.concatenate([np.arange(N_DIM), np.arange(N_DIM // 3)])
    k = np.arange(N_DIM)
    nlab = ((k * 7) % 50).astype(object)
    nlab[k % 4 == 0] = None
    dimn_k = np.arange(60).astype(object)
    dimn_k[::7] = None
    nf = 40
    return {
        "fact": {"fk": fk, "w": rng.normal(size=N_FACT),
                 "i": rng.integers(-5, 5, N_FACT).astype(np.int32),
                 "s": np.asarray([f"s{v}" for v in rng.integers(0, 30,
                                                                N_FACT)],
                                 object),
                 "nk": nk, "fl": fl_pool[rng.integers(0, len(fl_pool),
                                                      N_FACT)],
                 "a": rng.integers(0, 6, N_FACT).astype(np.int32),
                 "b": rng.integers(0, 4, N_FACT).astype(np.uint8),
                 "c": rng.integers(-3, 3, N_FACT).astype(np.int16)},
        "dim": {"k": k, "label": (k * 1000003) % 881,
                "big": k.astype(np.uint64) * np.uint64(2**40)
                + np.uint64(2**63),
                "f": k * 0.5 - 3.0,
                "name": np.asarray([f"v{x % 13}" for x in k], object),
                "nlab": nlab, "g": (k * 0.25).astype(np.float32)},
        "dimd": {"k": kd, "label": (kd * 3) % 101,
                 "name": np.asarray([f"d{x % 7}" for x in kd], object),
                 "f": kd * 0.125},
        # keys from a dictionary of their own: s0..s44, half of fact's
        "dims": {"s": np.asarray([f"s{v}" for v in range(15, 45)], object),
                 "v": np.arange(30) * 11},
        "dimn": {"nk": dimn_k, "v": np.arange(60)},
        "dimf": {"fl": np.array([0.0, -0.0, np.nan, 1.5, 7.0, -2.25]),
                 "v": np.arange(6) * 100},
        "dimm": {"a": np.repeat(np.arange(6), 4).astype(np.int32),
                 "b": np.tile(np.arange(4), 6).astype(np.uint8),
                 "c": (np.arange(24) % 5 - 2).astype(np.int16),
                 "v": np.arange(24)},
        "l1": {"a": rng.integers(0, 10, nf),
               "x": np.asarray([f"x{v}" for v in range(nf)], object)},
        "r1": {"b": rng.integers(0, 10, 30), "y": rng.normal(size=30)},
        "u1": {"id": rng.integers(0, 40, 200),
               "p": rng.integers(0, 9, 200).astype(np.int32)},
        "u2": {"id": np.concatenate([np.arange(0, 40, 2), np.arange(10)]),
               "q": np.asarray([f"q{v}" for v in range(30)], object)},
    }


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(2024)
    js = jch.connect()
    ts = tch.connect(device="cpu")
    for name, cols in _tables(rng).items():
        types = TYPES[name]
        js.execute(f"CREATE TABLE {name} ("
                   + ", ".join(f"{c} {t}" for c, t in types.items()) + ")")
        js.insert_pydict(name, cols)
        table_from_numpy(ts, name, _reference_columns(js, name), types)
    return js, ts


def _same_value(got, want):
    if isinstance(want, float) or isinstance(got, float):
        if want is None or got is None:
            return got is want
        if math.isnan(want):
            return math.isnan(got)
        if want == 0.0:
            return got == 0.0 and math.copysign(1, got) == \
                math.copysign(1, want)
        return math.isclose(got, want, rel_tol=FLOAT_RTOL, abs_tol=0.0)
    return got == want


def _both(sessions, sql, settings=None):
    js, ts = sessions
    want = js.execute(sql, settings=settings).rows()
    got = ts.execute(sql, settings=settings).rows()
    assert len(got) == len(want), (sql, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) and all(
            _same_value(a, b) for a, b in zip(g, w)), (sql, i, g, w)
    return got


# -- the join forms, rows in order ----------------------------------------

FORMS = {
    "q4": "SELECT count(), sum(label) FROM fact INNER JOIN dim "
          "ON fact.fk = dim.k",
    "inner-n1": "SELECT fk, label, big, f, name, nlab, g FROM fact "
                "INNER JOIN dim ON fact.fk = dim.k",
    "inner-n1-key": "SELECT fk, k, label FROM fact INNER JOIN dim "
                    "ON fact.fk = dim.k",
    "left-n1": "SELECT fk, label, big, f, name, nlab, g FROM fact "
               "LEFT JOIN dim ON fact.fk = dim.k",
    "right": "SELECT k, label, fk, w FROM fact RIGHT JOIN dim "
             "ON fact.fk = dim.k",
    "semi-left": "SELECT fk, w FROM fact LEFT SEMI JOIN dimd "
                 "ON fact.fk = dimd.k",
    "anti-left": "SELECT fk, w FROM fact LEFT ANTI JOIN dimd "
                 "ON fact.fk = dimd.k",
    "any-left-dup": "SELECT fk, label, name FROM fact ANY LEFT JOIN dimd "
                    "ON fact.fk = dimd.k",
    "any-inner-dup": "SELECT fk, label, f FROM fact ANY INNER JOIN dimd "
                     "ON fact.fk = dimd.k",
    "inner-1n": "SELECT fk, w, label, name, f FROM fact INNER JOIN dimd "
                "ON fact.fk = dimd.k",
    "left-1n": "SELECT fk, label, name, f FROM fact LEFT JOIN dimd "
               "ON fact.fk = dimd.k",
    "cross": "SELECT a, x, b, y FROM l1 CROSS JOIN r1",
    "non-equi": "SELECT a, x, b, y FROM l1 INNER JOIN r1 ON l1.a < r1.b",
    "residual-n1": "SELECT fk, w, label FROM fact INNER JOIN dim "
                   "ON fact.fk = dim.k AND fact.w > 0.5",
    "residual-1n": "SELECT fk, w, label FROM fact INNER JOIN dimd "
                   "ON fact.fk = dimd.k AND dimd.label > 50",
    "using": "SELECT id, p, q FROM u1 INNER JOIN u2 USING (id)",
    "using-left": "SELECT id, p, q FROM u1 LEFT JOIN u2 USING (id)",
    "two-keys": "SELECT fact.a, fact.b, v, w FROM fact INNER JOIN dimm "
                "ON fact.a = dimm.a AND fact.b = dimm.b",
    "three-keys": "SELECT fact.a, fact.b, fact.c, v FROM fact LEFT JOIN dimm "
                  "ON fact.a = dimm.a AND fact.b = dimm.b "
                  "AND fact.c = dimm.c",
    "string-keys": "SELECT fact.s, v, fk FROM fact INNER JOIN dims "
                   "ON fact.s = dims.s",
    "string-keys-left": "SELECT fact.s, v FROM fact LEFT JOIN dims "
                        "ON fact.s = dims.s",
    "nullable-keys": "SELECT fact.nk, v, fk FROM fact INNER JOIN dimn "
                     "ON fact.nk = dimn.nk",
    "nullable-keys-left": "SELECT fact.nk, v FROM fact LEFT JOIN dimn "
                          "ON fact.nk = dimn.nk",
    "float-keys": "SELECT fact.fl, v FROM fact INNER JOIN dimf "
                  "ON fact.fl = dimf.fl",
    "float-keys-left": "SELECT fact.fl, v FROM fact LEFT JOIN dimf "
                       "ON fact.fl = dimf.fl",
    "join-then-group": "SELECT name, count() AS c, sum(w) FROM fact "
                       "INNER JOIN dim ON fact.fk = dim.k GROUP BY name "
                       "ORDER BY name",
    "join-then-sort": "SELECT fk, label FROM fact INNER JOIN dimd "
                      "ON fact.fk = dimd.k ORDER BY label DESC, fk LIMIT 20",
    "filtered-sides": "SELECT fk, w, label FROM fact INNER JOIN dim "
                      "ON fact.fk = dim.k WHERE w > 0 AND label < 400",
    "aggregate-probe": "SELECT a.fk, a.c, label FROM (SELECT fk, count() AS c "
                       "FROM fact GROUP BY fk) AS a INNER JOIN dimd "
                       "ON a.fk = dimd.k",
    "three-tables": "SELECT fk, dim.label, dimd.label FROM fact "
                    "INNER JOIN dim ON fact.fk = dim.k "
                    "INNER JOIN dimd ON fact.fk = dimd.k",
    "left-residual": "SELECT fk, w, label FROM fact LEFT JOIN dimd "
                     "ON fact.fk = dimd.k AND dimd.label > 50",
    "key-expression": "SELECT fk, label FROM fact INNER JOIN dim "
                      "ON fact.fk + 1 = dim.k",
    "int32-int64-keys": "SELECT i, label FROM fact INNER JOIN dim "
                        "ON fact.i = dim.k",
    "uint8-int64-keys": "SELECT fact.b, label FROM fact LEFT JOIN dim "
                        "ON fact.b = dim.k",
    "uint64-int64-keys": "SELECT fk, big FROM fact LEFT JOIN dim "
                         "ON fact.fk = dim.big",
    "empty-build": "SELECT fk, v FROM fact LEFT JOIN dimn "
                   "ON fact.fk = dimn.v WHERE v > 1000",
    "empty-probe": "SELECT count() FROM (SELECT fk FROM fact WHERE fk < 0) "
                   "AS e INNER JOIN dimd ON e.fk = dimd.k",
}


@pytest.mark.parametrize("sql", list(FORMS.values()), ids=list(FORMS))
def test_join_forms_match_reference(sessions, sql):
    _both(sessions, sql)


@pytest.mark.parametrize("use_nulls", [0, 1])
@pytest.mark.parametrize("sql", [
    "SELECT fk, label, f, name FROM fact LEFT JOIN dim ON fact.fk = dim.k",
    "SELECT fk, label, f, name FROM fact LEFT JOIN dimd ON fact.fk = dimd.k",
], ids=["n1", "1n"])
def test_left_defaults_with_join_use_nulls(sessions, sql, use_nulls):
    """Unmatched rows of a LEFT join: 0, 0.0 and '' (join_use_nulls=0) or
    NULL (1), for Int, Float and String payloads."""
    rows = _both(sessions, sql, {"join_use_nulls": use_nulls})
    miss = [r for r in rows if r[0] >= N_DIM]
    assert miss
    want = (None, None, None) if use_nulls else (0, 0.0, "")
    assert all(tuple(r[1:]) == want for r in miss)


@pytest.mark.parametrize("dense", [1, 0], ids=["dense", "hash"])
@pytest.mark.parametrize("sql", [
    FORMS["q4"],
    "SELECT count(), sum(label) FROM fact LEFT JOIN dim ON fact.fk = dim.k",
    "SELECT count() FROM fact LEFT SEMI JOIN dimd ON fact.fk = dimd.k",
    "SELECT count() FROM fact LEFT ANTI JOIN dimd ON fact.fk = dimd.k",
    "SELECT fk, k, label FROM fact INNER JOIN dim ON fact.fk = dim.k",
], ids=["q4", "left", "semi", "anti", "key"])
def test_dense_gather_counter_on_and_off(sessions, sql, dense):
    """join_dense_gather=1 takes the direct-address path (K7) and counts
    DenseGatherJoins in both engines; 0 takes the hash path (K8)."""
    js, ts = sessions
    before = (js.profile_events.get("DenseGatherJoins", 0),
              ts.profile_events.get("DenseGatherJoins", 0))
    _both(sessions, sql, {"join_dense_gather": dense})
    after = (js.profile_events.get("DenseGatherJoins", 0),
             ts.profile_events.get("DenseGatherJoins", 0))
    assert after[1] - before[1] == after[0] - before[0] == dense


@pytest.mark.parametrize("autotune", [1, 0], ids=["autotune-on",
                                                  "autotune-off"])
def test_max_joined_rows_overflow(sessions, autotune):
    """A 1:N join whose output exceeds max_joined_rows raises CapacityError
    naming the setting; the autotuner retries with more rows."""
    sql = ("SELECT fk, label FROM fact INNER JOIN dimd ON fact.fk = dimd.k "
           "SETTINGS max_joined_rows = 2000")
    js, ts = sessions
    if autotune:
        before = ts.profile_events.get("CapacityRetunes", 0)
        _both(sessions, sql)
        assert ts.profile_events.get("CapacityRetunes", 0) > before
        return
    with pytest.raises(CapacityError, match="max_joined_rows") as e:
        ts.execute(sql, settings={"capacity_autotune": 0})
    assert e.value.setting == "max_joined_rows"
    assert e.value.needed > 2000


def test_cross_join_above_2_24_rows():
    """A cross join of 20M rows, above 2^24: its output capacity is the
    product of the two sides' rows, held to the closed form.  The
    reference caps that capacity at 2^24 rows and raises CapacityError
    here (after about two minutes on a CPU, so it is not run)."""
    sql = ("SELECT count(), sum(n1.number) FROM numbers(5000) n1 "
           "CROSS JOIN numbers(4000) n2")
    assert tch.connect(device="cpu").execute(sql).rows() == [
        (20_000_000, 4000 * (5000 * 4999 // 2))]


def test_asof_join_raises_naming_asof(sessions):
    """ASOF JOIN, which raised naming ASOF before it was ported, now
    answers as the reference does (rows in the reference's order: the
    probe rows in place)."""
    _both(sessions, "SELECT fk, label FROM fact ASOF LEFT JOIN dimd "
                    "ON fact.i = dimd.label AND fact.fk >= dimd.k")


def test_full_join_raises_naming_union(sessions):
    """FULL JOIN, which the analyzer plans as a UnionNode of a LEFT join
    and the right side's unmatched rows, raised naming the union before
    UnionNode was ported; it now answers as the reference does (rows in
    the reference's order: the LEFT join's, then the unmatched build
    rows)."""
    _both(sessions, "SELECT fk, label FROM fact FULL JOIN dim "
                    "ON fact.fk = dim.k")


def _find_join(node):
    if type(node).__name__ == "JoinNode":
        return node
    for c in node.children():
        j = _find_join(c)
        if j is not None:
            return j
    return None


@pytest.mark.parametrize("table,unique", [("dim", True), ("dimd", False)])
def test_build_unique_matches_reference_plan(sessions, table, unique):
    """column_unique gives the port's planner the reference's build_unique,
    so Q4's shape takes the dense route in both (and dimd, whose keys
    repeat, the 1:N route in both)."""
    js, ts = sessions
    sql = (f"SELECT count(), sum(label) FROM fact INNER JOIN {table} "
           f"ON fact.fk = {table}.k")
    jj = _find_join(js._plan(jparse(sql), js.settings))
    tj = _find_join(ts._plan(tparse(sql), ts.settings))
    assert isinstance(tj, TL.JoinNode)
    assert tj.build_unique == jj.build_unique == unique
    assert js.catalog.get_table("default", table).column_unique("k") \
        == ts.catalog.get_table("default", table).column_unique("k") \
        == unique
    before = (js.profile_events.get("DenseGatherJoins", 0),
              ts.profile_events.get("DenseGatherJoins", 0))
    _both(sessions, sql)
    dense = (js.profile_events.get("DenseGatherJoins", 0) - before[0],
             ts.profile_events.get("DenseGatherJoins", 0) - before[1])
    assert dense == ((1, 1) if unique else (0, 0))


# -- the reference's propagate-join tests, as differential cases -----------

@pytest.mark.parametrize("sql", [
    # test_inner_n1_unique_dim
    "SELECT fk, lab, big, f, name FROM pfact INNER JOIN pdim "
    "ON pfact.fk = pdim.k ORDER BY fk, lab",
    # test_left_n1_defaults
    "SELECT fk, lab, name FROM pfact LEFT JOIN pdim ON pfact.fk = pdim.k "
    "ORDER BY fk",
    # test_count_sum_matches_expand_path
    "SELECT count(), sum(lab) FROM pfact INNER JOIN pdim "
    "ON pfact.fk = pdim.k",
    # test_any_join_dup_dim
    "SELECT fk, lab FROM pfact ANY LEFT JOIN pdimd ON pfact.fk = pdimd.k "
    "ORDER BY fk",
    # test_semi_anti
    "SELECT count() FROM pfact SEMI LEFT JOIN pdimd ON pfact.fk = pdimd.k",
    "SELECT count() FROM pfact ANTI LEFT JOIN pdimd ON pfact.fk = pdimd.k",
    # test_nonunique_dim_falls_back_to_expand
    "SELECT count() FROM pfact INNER JOIN pdimd ON pfact.fk = pdimd.k",
    # test_nullable_keys_never_match
    "SELECT pl.k, v FROM pl LEFT JOIN pr ON pl.k = pr.k ORDER BY v",
    # TestDenseGatherJoin
    "SELECT count(), sum(w), sum(lab) FROM pfact INNER JOIN pdim "
    "ON pfact.fk = pdim.k",
    "SELECT nm, count() AS c FROM pfact INNER JOIN pdim "
    "ON pfact.fk = pdim.k GROUP BY nm ORDER BY nm",
    # TestJoinReorder: the big table written as the build side
    "SELECT count(), sum(lab) FROM pdim INNER JOIN pfact "
    "ON pdim.k = pfact.fk",
], ids=["inner-n1", "left-n1-defaults", "count-sum", "any-dup", "semi",
        "anti", "nonunique-expand", "nullable-keys", "dense-sums",
        "dense-group", "reorder"])
def test_propagate_join_shapes(propagate_sessions, sql):
    _both(propagate_sessions, sql)


@pytest.fixture(scope="module")
def propagate_sessions():
    """test_join_propagate.py's tables: fact of 5,000 rows (half miss),
    dim of 97 unique keys (a UInt64 column forcing two words), dimd with a
    third of them twice, and NULL probe keys."""
    rng = np.random.default_rng(7)
    n_fact, n_dim = 5000, 97
    fk = rng.integers(0, n_dim * 2, n_fact)
    k = np.arange(n_dim)
    kd = np.concatenate([k, k[: n_dim // 3]])

    def dim_cols(keys):
        return {"k": keys, "lab": (keys * 1000003) % 881,
                "big": keys.astype(np.uint64) * np.uint64(2**40),
                "f": keys * 0.5 - 3.0,
                "name": np.asarray([f"v{x}" for x in keys], object),
                "nm": np.asarray([f"n{x % 5}" for x in keys], object)}
    dim_types = {"k": "Int64", "lab": "Int64", "big": "UInt64",
                 "f": "Float64", "name": "String", "nm": "String"}
    tables = {
        "pfact": ({"fk": fk, "w": rng.integers(-10, 10, n_fact)},
                  {"fk": "Int64", "w": "Int64"}),
        "pdim": (dim_cols(k), dim_types),
        "pdimd": (dim_cols(kd), dim_types),
        "pl": ({"k": np.asarray([1, None, 2, None, 3], object)},
               {"k": "Nullable(Int64)"}),
        "pr": ({"k": np.arange(5), "v": np.arange(5) * 10},
               {"k": "Int64", "v": "Int64"}),
    }
    js = jch.connect()
    ts = tch.connect(device="cpu")
    for name, (cols, types) in tables.items():
        js.execute(f"CREATE TABLE {name} ("
                   + ", ".join(f"{c} {t}" for c, t in types.items()) + ")")
        js.insert_pydict(name, cols)
        table_from_numpy(ts, name, _reference_columns(js, name), types)
    return js, ts


def test_uint32_payload_at_the_sentinel_is_kept():
    """A UInt32 payload holding 0 and 2^32 - 1: the reference's dense path
    takes lo - 1 = -1 as the sentinel of a word that wraps to int32, so the
    build row whose payload is 2^32 - 1 reads as unmatched and its probe
    rows vanish (clickhouse_tpu/exec/executor.py:1564, the sentinel taken
    from the value's bounds, and :1422, the word wrapped to int32).  The port takes the hash path for such a payload
    and keeps them; the reference's answer is pinned so that a repair of
    it shows."""
    k = np.arange(8, dtype=np.int64)
    u = np.array([0, 1, 2**31, 2**32 - 1, 5, 6, 7, 8], np.uint64)
    fk = np.array([3, 0, 3, 7, 9], np.int64)
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s_ in (js, ts):
        s_.execute("CREATE TABLE du (k Int64, u UInt32)")
        s_.insert_pydict("du", {"k": k, "u": u.astype(np.uint32)})
        s_.execute("CREATE TABLE fu (fk Int64)")
        s_.insert_pydict("fu", {"fk": fk})
    sql = "SELECT fk, u FROM fu INNER JOIN du ON fu.fk = du.k"
    want = [(int(f), int(u[f])) for f in fk if f < len(k)]
    assert ts.execute(sql).rows() == want
    assert js.execute(sql).rows() != want
    assert js.execute(sql, settings={"join_dense_gather": 0}).rows() == want


# -- J3: the join builds only the columns read above it ----------------------
# Q4's, Q4h's and Q4x's shapes (chip_smoke.load_join_tables) at small size:
# dim's keys unique in a small range (the direct-address join, K7), dim_h's
# unique and far apart (the hash join, K8), dim2's each twice (the 1:N
# join); fact_h's keys miss on every 10th row.

N_SHAPED = 20_000
N_SHAPED_DIM = 1000
SHAPES = {"q4": ("fact4", "dim4"), "q4h": ("fact4h", "dim4h"),
          "q4x": ("fact4", "dim4x")}


@pytest.fixture(scope="module")
def shaped_sessions():
    k = np.arange(N_SHAPED_DIM, dtype=np.int64)
    label = (k * 7) % 97
    i = np.arange(N_SHAPED, dtype=np.int64)
    fk = (i * 40503) % N_SHAPED_DIM
    kh = k * 2654435761
    tables = {"dim4": {"k": k, "label": label},
              "dim4h": {"k": kh, "label": label},
              "dim4x": {"k": k // 2, "label": label},
              "fact4": {"fk": fk},
              "fact4h": {"fk": kh[fk] + (i % 10 == 0)}}
    js = jch.connect()
    ts = tch.connect(device="cpu")
    for name, cols in tables.items():
        types = {c: "Int64" for c in cols}
        js.execute(f"CREATE TABLE {name} ("
                   + ", ".join(f"{c} Int64" for c in cols) + ")")
        js.insert_pydict(name, cols)
        table_from_numpy(ts, name, _reference_columns(js, name), types)
    return js, ts


SHAPED_FORMS = {
    "count-sum": "SELECT count(), sum(label) FROM {f} INNER JOIN {d} "
                 "ON {f}.fk = {d}.k",
    "star": "SELECT * FROM {f} INNER JOIN {d} ON {f}.fk = {d}.k",
    "residual-on-build-key": "SELECT fk, label FROM {f} INNER JOIN {d} "
                             "ON {f}.fk = {d}.k AND {d}.k % 3 = 1",
    "left-use-nulls": "SELECT fk, label FROM {f} LEFT JOIN {d} "
                      "ON {f}.fk = {d}.k SETTINGS join_use_nulls = 1",
}


@pytest.mark.parametrize("form", list(SHAPED_FORMS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_shaped_joins_match_reference(shaped_sessions, shape, form):
    """Q4-, Q4h- and Q4x-shaped joins give the reference's rows in order,
    whether the build key is read above the join (SELECT *, a residual on
    it) or not (count(), sum(label))."""
    f, d = SHAPES[shape]
    rows = _both(shaped_sessions, SHAPED_FORMS[form].format(f=f, d=d))
    assert rows


def _spy_calls(monkeypatch, module, names):
    calls = {name: [] for name in names}
    for name in names:
        fn = getattr(module, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name].append(args)
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, spy)
    return calls


def _join_blocks(monkeypatch):
    """The blocks the port's joins return, as they run."""
    from clickhouse_tpu_torch.exec import executor
    blocks = []
    run = executor._DISPATCH[TL.JoinNode]

    def spy(node, ctx):
        blocks.append((node, run(node, ctx)))
        return blocks[-1][1]
    monkeypatch.setitem(executor._DISPATCH, TL.JoinNode, spy)
    return blocks


@pytest.mark.parametrize("shape", list(SHAPES))
def test_join_builds_only_what_is_read(shaped_sessions, monkeypatch, shape):
    """Q4's K7 call carries `label` alone, one word with its sentinel and
    proven range and no "key" word; Q4h's K8 call carries one word; Q4x's
    1:N join gathers `label` alone.  The join's schema still holds the
    build key (the plan is the reference's), and no right-side column
    outside what is read above the join is built."""
    from clickhouse_tpu_torch.ops import join_ops
    f, d = SHAPES[shape]
    calls = _spy_calls(monkeypatch, join_ops,
                       ["dense_gather_join", "propagate_join",
                        "build_join_table"])
    blocks = _join_blocks(monkeypatch)
    _both(shaped_sessions, SHAPED_FORMS["count-sum"].format(f=f, d=d))
    (node, block), = blocks
    right = {fld.id for fld in node.right.schema}
    assert {fld.display for fld in node.schema
            if fld.id in right} == {"k", "label"}
    assert [fld.display for fld in node.schema
            if fld.id in right and fld.id in block.cols] == ["label"]
    if shape == "q4":
        (args,) = calls["dense_gather_join"]
        entries = args[4]
        assert [e[0] for e in entries] == ["word"]
        assert entries[0][2] == -1 and tuple(entries[0][3]) == (0, 96)
        assert not calls["propagate_join"]
    elif shape == "q4h":
        (args,) = calls["propagate_join"]
        assert len(args[4]) == 1
        assert not calls["dense_gather_join"]
    else:
        assert len(calls["build_join_table"]) == 1
        assert not calls["propagate_join"] and not calls["dense_gather_join"]


@pytest.mark.parametrize("form", ["count-sum", "star"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_join_estimate_is_the_reference(shaped_sessions, shape, form):
    """The governor's estimate of the shaped joins' plans is the
    reference's: the join's schema keeps what the reference's keeps."""
    from clickhouse_tpu.exec.streaming import \
        estimate_plan_device_bytes as jest
    from clickhouse_tpu_torch.exec.streaming import \
        estimate_plan_device_bytes as test_
    js, ts = shaped_sessions
    f, d = SHAPES[shape]
    sql = SHAPED_FORMS[form].format(f=f, d=d)
    jplan = js._plan(jparse(sql), js.settings)
    tplan = ts._plan(tparse(sql), ts.settings)
    assert [x.display for x in _find_join(tplan).schema] == \
        [x.display for x in _find_join(jplan).schema]
    assert test_(tplan, ts.catalog, ts.settings) == \
        jest(jplan, js.catalog, js.settings)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_join_working_set_is_held_to_the_budget(shaped_sessions, monkeypatch,
                                                shape):
    """A budget that the governor's estimate passes, with less left than
    the join's own working set (match flags and words, K7's table, K8's
    buckets and payload, K9's slots), raises MemoryLimitExceeded naming the
    join before any join kernel runs; at the default budget the query
    answers."""
    from clickhouse_tpu_torch.core.errors import MemoryLimitExceeded
    from clickhouse_tpu_torch.exec.streaming import \
        estimate_plan_device_bytes
    from clickhouse_tpu_torch.ops import join_ops
    js, ts = shaped_sessions
    f, d = SHAPES[shape]
    sql = SHAPED_FORMS["count-sum"].format(f=f, d=d)
    est = estimate_plan_device_bytes(ts._plan(tparse(sql), ts.settings),
                                     ts.catalog, ts.settings)
    calls = _spy_calls(monkeypatch, join_ops,
                       ["dense_gather_join", "propagate_join",
                        "build_join_table", "probe_join_table",
                        "expand_matches"])
    with pytest.raises(MemoryLimitExceeded, match="joining"):
        ts.execute(sql, settings={"max_device_memory_bytes": est + 4096})
    assert not any(calls.values())
    _both(shaped_sessions, sql)


# -- J3 through chains of joins ----------------------------------------------
# The inner join of a chain keeps its build key in its schema but does not
# build it unless something above reads it; none of these queries selects
# the middle key.  Each chain gives the reference's rows and takes the
# reference's routes: (N:1 calls, 1:N builds).

CHAINS = {
    "n1-then-n1": ("SELECT count(), sum(dim.label), sum(dimn.v) FROM fact "
                   "INNER JOIN dim ON fact.fk = dim.k "
                   "INNER JOIN dimn ON fact.a = dimn.v", (2, 0)),
    "n1-then-left-n1": ("SELECT fk, dim.label, dimn.v FROM fact "
                        "LEFT JOIN dim ON fact.fk = dim.k "
                        "LEFT JOIN dimn ON fact.a = dimn.v", (2, 0)),
    "n1-then-1n": ("SELECT count(), sum(dim.label), sum(dimd.f) FROM fact "
                   "INNER JOIN dim ON fact.fk = dim.k "
                   "INNER JOIN dimd ON dim.label = dimd.k", (1, 1)),
    "right-through-a-join": ("SELECT dims.s, dims.v, fk, label FROM fact "
                             "INNER JOIN dim ON fact.fk = dim.k "
                             "RIGHT JOIN dims ON fact.s = dims.s", (1, 1)),
    "any-right-through-a-join": ("SELECT count(), sum(dims.v), sum(label) "
                                 "FROM fact INNER JOIN dim "
                                 "ON fact.fk = dim.k ANY RIGHT JOIN dims "
                                 "ON fact.s = dims.s", (2, 0)),
}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_join_chains_match_reference(sessions, monkeypatch, chain):
    """Three-table joins whose middle key nothing reads: the outer join
    finds every column it reads (the inner join built it) and keeps the
    route that the build side's types decide, with the unread key left
    out."""
    from clickhouse_tpu_torch.ops import join_ops
    sql, (n1, expand) = CHAINS[chain]
    calls = _spy_calls(monkeypatch, join_ops,
                       ["dense_gather_join", "propagate_join",
                        "build_join_table"])
    blocks = _join_blocks(monkeypatch)
    rows = _both(sessions, sql)
    assert rows
    assert len(calls["dense_gather_join"]) + len(calls["propagate_join"]) \
        == n1
    assert len(calls["build_join_table"]) == expand
    for node, block in blocks:
        built = {fld.id for fld in node.schema if fld.id in block.cols}
        assert built == {fld.id for fld in node.schema if node.reads(fld.id)}
    inner = blocks[0][0]          # the first to finish
    assert any(not inner.reads(fld.id) for fld in inner.schema)


def test_wrapped_toint8_payload_is_exact():
    """toInt8 of values in [0, 300] on the build side wraps; its proven
    range is the int8 range (not the input's [0, 300]), so the join gives
    numpy's values, -128 and -1 among them, as the reference does."""
    v = np.arange(301, dtype=np.int64)
    fk = np.tile(np.array([0, 127, 128, 255, 256, 300, 5000]), 300)
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s_ in (js, ts):
        s_.execute("CREATE TABLE d8 (k Int64, v Int64)")
        s_.insert_pydict("d8", {"k": v, "v": v})
        s_.execute("CREATE TABLE f8 (fk Int64)")
        s_.insert_pydict("f8", {"fk": fk})
    for how in ("INNER", "ANY LEFT"):
        sql = (f"SELECT fk, t FROM f8 {how} JOIN (SELECT k, toInt8(v) AS t "
               f"FROM d8) AS dd ON f8.fk = dd.k")
        want = [(int(f), int(np.int64(f).astype(np.int8)) if f <= 300
                 else 0) for f in fk if f <= 300 or how != "INNER"]
        assert ts.execute(sql).rows() == want
        _both((js, ts), sql)


def test_dense_join_range_that_does_not_hold_raises(shaped_sessions,
                                                    monkeypatch):
    """K7's table trusts each word's proven range; where a stated range
    does not hold (here `label`'s stated as [1, 96] over values in
    [0, 96]), the call's out_of_range flag makes the query raise at
    materialize instead of answering from a table it may have filled
    wrong."""
    from clickhouse_tpu_torch.exec import executor
    dense_words = executor._dense_words

    def narrowed(*args):
        entries, rb = dense_words(*args)
        return [e[:3] + ((e[3][0] + 1, e[3][1]),) if e[0] == "word" else e
                for e in entries], rb
    monkeypatch.setattr(executor, "_dense_words", narrowed)
    f, d = SHAPES["q4"]
    with pytest.raises(CapacityError, match="proven value range"):
        shaped_sessions[1].execute(
            SHAPED_FORMS["count-sum"].format(f=f, d=d))


@pytest.mark.parametrize("form", ["inner", "left", "residual"])
def test_one_to_n_join_takes_the_probe_rows_as_a_count(shaped_sessions,
                                                       monkeypatch, form):
    """A scan's probe rows (no mask, no filter terms, no NULL keys) reach
    the 1:N route as their row count: K8's probe gets no validity, so the
    padding rows past the count (key 0, which dim4x holds) match there,
    and K9 gets the count and no mask, and gives them no output row.  The
    rows are the reference's, in order."""
    from clickhouse_tpu_torch.ops import join_ops
    on = {"inner": "INNER JOIN dim4x ON fact4.fk = dim4x.k",
          "left": "LEFT JOIN dim4x ON fact4.fk = dim4x.k",
          "residual": "INNER JOIN dim4x ON fact4.fk = dim4x.k "
                      "AND fact4.fk + dim4x.label > 100"}
    seen = {}
    for name in ("probe_join_table", "expand_matches"):
        fn = getattr(join_ops, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            out = _fn(*args, **kw)
            seen[_name] = (args, kw, out)
            return out
        monkeypatch.setattr(join_ops, name, spy)
    _both(shaped_sessions, f"SELECT fk, label FROM fact4 {on[form]}")
    pargs, _, pr = seen["probe_join_table"]
    eargs, ekw, (p_idx, _, _, count) = seen["expand_matches"]
    assert pargs[2] is None and eargs[1] is None
    assert ekw["n_rows"] == N_SHAPED
    n = pr.matched.shape[0]
    assert n > N_SHAPED and bool((pargs[1][0][N_SHAPED:] == 0).all())
    assert bool(pr.matched[N_SHAPED:].all())
    live = min(int(count), p_idx.shape[0])
    assert live and int(p_idx[:live].max()) < N_SHAPED


@pytest.fixture(scope="module")
def array_sessions():
    """a(k, x) probes b(k, v Array(Float32)) (unique keys: the N:1 path)
    and b2 (key 1 twice: the 1:N path), an empty array among the rows."""
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute("CREATE TABLE a (k Int64, x Int64)")
        s.execute("CREATE TABLE b (k Int64, v Array(Float32))")
        s.execute("CREATE TABLE b2 (k Int64, v Array(Float32))")
        s.execute("INSERT INTO a VALUES (1, 10), (2, 20), (3, 30), (4, 40)")
        s.execute("INSERT INTO b VALUES (1, [1, 2]), (2, [3]), (3, [])")
        s.execute("INSERT INTO b2 VALUES (1, [1, 2]), (2, [3]), (3, []), "
                  "(1, [5, 6, 7])")
    return js, ts


@pytest.mark.parametrize("dense", [1, 0], ids=["dense", "hash"])
@pytest.mark.parametrize("kind", ["INNER", "LEFT"])
@pytest.mark.parametrize("build", ["b", "b2"], ids=["n-to-1", "1-to-n"])
def test_join_keeps_array_lengths(array_sessions, build, kind, dense):
    """A build-side Array column keeps each row's length through both join
    paths: [1, 2], [3] and [] (an unmatched LEFT row: []), as the
    reference gives them, never the padded row."""
    sql = (f"SELECT a.k, {build}.v FROM a {kind} JOIN {build} "
           f"ON a.k = {build}.k ORDER BY a.k")
    js, ts = array_sessions
    st = {"join_dense_gather": dense}
    want = js.execute(sql, settings=st).rows()
    got = ts.execute(sql, settings=st).rows()
    assert got == want
    assert (2, [3.0]) in got and (3, []) in got
