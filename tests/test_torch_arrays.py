"""ARRAY JOIN and the array functions of the CUDA engine against the JAX
reference, on the CPU.

The same rows, made from a seed with numpy, go through
``clickhouse_tpu.connect()`` and ``clickhouse_tpu_torch.connect(
device="cpu")``; integers must be equal, floats (arrayAvg, arraySum of a
Float64 array) within rtol 1e-9.  The expansion takes K9's plain version
here (each row a probe with seg_start 0 and seg_len its length).  Rows
compare in order where the query orders them, as multisets otherwise.
Array(String) is not ported: those cases of the reference's TestArrays
raise naming the column type.
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (CapacityError,
                                              NotImplementedError_)

FLOAT_RTOL = 1e-9
N = 3000


def _lists(rng, n, lo, hi, max_len, dtype):
    lens = rng.integers(0, max_len + 1, n)
    out = np.empty(n, object)
    for i, k in enumerate(lens):
        out[i] = [dtype(v) for v in rng.integers(lo, hi, k)]
    return out


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(23)
    js, ts = jch.connect(), tch.connect(device="cpu")
    f = _lists(rng, N, -50, 50, 6, float)
    for i in range(N):
        f[i] = [v / 4 for v in f[i]]
    cols = {"id": np.arange(N, dtype=np.int64),
            "g": rng.integers(0, 7, N).astype(np.int64),
            "nums": _lists(rng, N, -20, 20, 7, int),
            "u": _lists(rng, N, 0, 300, 5, int),
            "f": f}
    small = {"id": np.arange(4, dtype=np.int64),
             "nums": np.asarray([[1, 2, 3], [10], [], [4, 5]], object)}
    for s in (js, ts):
        s.execute("CREATE TABLE arr (id Int64, g Int64, nums Array(Int64), "
                  "u Array(UInt32), f Array(Float64))")
        s.insert_pydict("arr", cols)
        s.execute("CREATE TABLE ta (id Int64, nums Array(Int64))")
        s.insert_pydict("ta", small)
    return js, ts


def _close(a, b) -> bool:
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= FLOAT_RTOL * max(abs(a), abs(b), 1e-300)
    return a == b and type(a) is type(b)


def _both(sessions, sql, ordered=True, settings=None):
    js, ts = sessions
    want = js.execute(sql, settings=settings).rows()
    got = ts.execute(sql, settings=settings).rows()
    if not ordered:
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    assert len(got) == len(want), (sql, len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(x, y) for x, y in zip(g, w)), \
            (sql, g, w)
    return got


# -- the reference's TestArrays (tests/test_arrays.py) -------------------

@pytest.mark.parametrize("sql", [
    "SELECT [1, 2, 3] AS a, length([1,2,3]) AS l",
    "SELECT id, length(nums) FROM ta ORDER BY id",
    "SELECT nums[1], nums[-1], nums[10] FROM ta ORDER BY id LIMIT 1",
    "SELECT indexOf(nums, 5) FROM ta ORDER BY id",
    "SELECT arraySum(nums), arrayMin(nums), arrayMax(nums) FROM ta "
    "ORDER BY id",
    "SELECT id, arrayJoin(nums) AS n FROM ta ORDER BY id, n",
    "SELECT sum(arrayJoin(nums)) FROM ta WHERE id < 2",
], ids=["array_literal", "length_empty", "array_element", "index_of",
        "array_reductions", "array_join", "array_in_where_via_join"])
def test_reference_array_cases(sessions, sql):
    _both(sessions, sql)


@pytest.mark.parametrize("sql", [
    "CREATE TABLE sa (id Int64, tags Array(String))",
    "SELECT ['a', 'b'] AS t",
])
def test_array_of_strings_raises_naming_the_type(sessions, sql):
    """The reference's Array(String) cases (tags[1], has(tags, 'b'),
    arrayJoin(tags) GROUP BY, the round trip) wait for that column type:
    the port refuses it naming the type."""
    with pytest.raises(NotImplementedError_, match="Array\\(String\\)"):
        sessions[1].execute(sql)


# -- the array functions over seeded rows ---------------------------------

@pytest.mark.parametrize("sql", [
    "SELECT id, nums[1], nums[-1], nums[3], nums[-7], nums[g - 3] FROM arr",
    "SELECT id, has(nums, 3), has(u, 17), indexOf(nums, -2), "
    "indexOf(u, 250), has(f, 0.25) FROM arr",
    "SELECT id, arraySum(nums), arrayMin(nums), arrayMax(nums), "
    "arrayAvg(nums) FROM arr",
    "SELECT id, arraySum(u), arrayMin(u), arrayMax(u) FROM arr",
    "SELECT id, arraySum(f), arrayMin(f), arrayMax(f), arrayAvg(f) FROM arr",
    "SELECT id, arrayConcat(nums, u), arrayConcat([1, 2], nums), "
    "arrayEnumerate(nums), emptyArrayToSingle(u) FROM arr",
    "SELECT range(4), range(0), emptyArrayInt64(), arrayConcat([1], [2, 3]),"
    " arrayEnumerate([5, 6]), emptyArrayToSingle(emptyArrayInt64())",
    "SELECT id, range(g), length(range(g)) FROM arr",
    "SELECT sum(arraySum(nums)), countIf(has(u, 7)), sum(indexOf(u, 7)) "
    "FROM arr",
], ids=["element", "has-indexOf", "reduce-int64", "reduce-uint32",
        "reduce-float64", "concat-enumerate-single", "constants",
        "range-of-a-column", "qa4-shape"])
def test_array_functions_match_reference(sessions, sql):
    _both(sessions, sql + (" ORDER BY id" if "FROM arr" in sql
                           and "sum(" not in sql else ""))


def test_array_element_of_a_map_raises_naming_map():
    from clickhouse_tpu_torch.core import dtypes as dt
    from clickhouse_tpu_torch.exprs.expr import ColVal
    from clickhouse_tpu_torch.exprs.functions import FUNCTIONS
    import torch
    m = ColVal(dt.Map(dt.Int64, dt.Int64), torch.zeros(4, dtype=torch.int8))
    with pytest.raises(NotImplementedError_, match="Map"):
        FUNCTIONS["arrayElement"]._execute(
            [m, ColVal(dt.Int64, torch.zeros((), dtype=torch.int64))],
            dt.Int64)


# -- ARRAY JOIN ------------------------------------------------------------

@pytest.mark.parametrize("sql", [
    "SELECT id, x FROM arr ARRAY JOIN nums AS x",
    "SELECT id, x FROM arr LEFT ARRAY JOIN nums AS x",
    "SELECT id, x, y FROM arr ARRAY JOIN nums AS x, u AS y",
    "SELECT id, x, y FROM arr LEFT ARRAY JOIN u AS x, nums AS y",
    "SELECT id, x FROM arr ARRAY JOIN f AS x WHERE x > 1.5",
    "SELECT id, x FROM arr ARRAY JOIN nums AS x WHERE x % 3 = 1 AND g < 4",
    "SELECT id, x FROM (SELECT id, u FROM arr WHERE g = 2) ARRAY JOIN u "
    "AS x",
    "SELECT arrayJoin(u) AS x, id FROM arr WHERE id % 5 = 0",
    "SELECT arrayJoin([1, 2, 3]) AS x, id FROM arr WHERE id < 10",
], ids=["inner", "left", "two-arrays", "left-two-arrays", "where-float",
        "where-element", "where-below", "function-form", "literal"])
def test_array_join_matches_reference(sessions, sql):
    _both(sessions, sql)


@pytest.mark.parametrize("sql", [
    "SELECT x, count(), sum(id) FROM arr ARRAY JOIN u AS x GROUP BY x "
    "ORDER BY x",
    "SELECT x, count() FROM arr ARRAY JOIN nums AS x GROUP BY x "
    "ORDER BY count() DESC, x LIMIT 10",
    "SELECT count(), sum(id) FROM arr LEFT ARRAY JOIN nums AS t "
    "WHERE t = 0",
    "SELECT sum(t * x) FROM arr ARRAY JOIN u AS t, nums AS x",
    "SELECT x % 10 AS k, count() FROM arr ARRAY JOIN u AS x GROUP BY k "
    "ORDER BY k",
], ids=["group-by-element", "qa1-shape", "qa3-shape", "qa2-shape",
        "group-by-expression"])
def test_array_join_aggregates_match_reference(sessions, sql):
    _both(sessions, sql)


def test_array_join_of_empty_arrays_only(sessions):
    for s in sessions:
        s.execute("CREATE TABLE ea (id Int64, a Array(Int64))")
        s.insert_pydict("ea", {"id": np.arange(3, dtype=np.int64),
                               "a": np.asarray([[], [], []], object)})
    _both(sessions, "SELECT id, x FROM ea ARRAY JOIN a AS x")
    _both(sessions, "SELECT id, x FROM ea LEFT ARRAY JOIN a AS x "
                    "ORDER BY id")


def test_array_join_capacity_retry(sessions):
    """Past max_array_join_rows the expansion raises CapacityError naming
    the setting with the rows it needs; the session re-plans with it
    raised and answers as the reference does."""
    js, ts = sessions
    sql = "SELECT count(), sum(x) FROM arr ARRAY JOIN nums AS x"
    need = ts.execute(sql).rows()[0][0]
    with pytest.raises(CapacityError, match="max_array_join_rows") as e:
        ts.execute(sql, settings={"max_array_join_rows": 100,
                                  "capacity_autotune": 0})
    assert e.value.setting == "max_array_join_rows"
    assert e.value.needed == need
    before = ts.profile_events.get("CapacityRetunes", 0)
    _both(sessions, sql, settings={"max_array_join_rows": 100})
    assert ts.profile_events.get("CapacityRetunes", 0) > before


@pytest.mark.parametrize("settings", [None, {"compile_queries": 0}],
                         ids=["compiled", "eager"])
def test_element_bounds_are_the_references(sessions, settings):
    """The element column's bounds are the reference's: a literal list's
    own, and, run eagerly, the min and max over the padded matrix (range()
    of the element reads them: unbounded, it refuses)."""
    _both(sessions, "SELECT x, range(x) FROM (SELECT arrayJoin([1, 3, 2]) "
                    "AS x)", settings=settings)
    sql = "SELECT x, length(range(x)) FROM ta ARRAY JOIN nums AS x"
    if settings is None:
        for s in sessions:
            with pytest.raises(Exception, match="bounded length"):
                s.execute(sql)
    else:
        _both(sessions, sql, settings=settings)
