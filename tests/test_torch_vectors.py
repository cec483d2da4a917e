"""The CUDA engine's vector search (Array(Float32) columns, the distance
functions and K11's plain version) against the JAX reference, on the CPU.

The same numpy rows (made from a seed) go into ``clickhouse_tpu.connect()``
and ``clickhouse_tpu_torch.connect(device="cpu")``:

* ``big``: 70,000 vectors of 24 Float32 (a block of 70,656 rows, at or
  above the reference's 65,536-row threshold): the float32 form, which the
  port computes with K11 (its plain version here) from dot, |a|^2 and the
  length-masked |q|^2;
* ``rag``: 70,000 rows of 0 to 24 elements (ragged lengths, the float32
  form with the masked |q|^2);
* ``small``: 300 rows of 0 to 11 Float64 and Float32 elements: the
  float64 elementwise form.

Tolerance.  The float32 form sums in another order than XLA's CPU
matmul (torch.mv, and K11's lanes on the card), so a distance d agrees
with the reference's d_ref within 1e-5 * |d_ref| + 1e-6 * s, where s is
the row's scale: 1 for cosineDistance, 1 + |a|^2 + |q|^2 for the others
(their float32 parts are sums of that size).  The float64 form agrees
within 1e-12 relative.  Row order and ids compare exactly: each top-k
below first checks that numpy's float64 k-th and (k+1)-th distances lie
further apart than the tolerance.
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.interop import table_from_numpy
from clickhouse_tpu_torch.ops import vector_ops

N_BIG, W_BIG = 70_000, 24
N_SMALL = 300
RTOL32, ATOL32 = 1e-5, 1e-6
DISTANCES = ["L2Distance", "L2SquaredDistance", "L1Distance", "LinfDistance",
             "dotProduct", "cosineDistance"]
KERNEL_FORM = {"L2Distance", "L2SquaredDistance", "dotProduct",
               "cosineDistance"}


def _literal(q, cast=True):
    body = "[" + ",".join(f"{x:.5f}" for x in q) + "]"
    return f"CAST({body} AS Array(Float32))" if cast else body


def _q(seed, w):
    q = np.random.default_rng(seed).normal(size=w).astype(np.float32)
    return np.array([float(f"{x:.5f}") for x in q])


def _ragged(rng, n, w, dtype):
    """n rows of 0..w elements: the (n, w) matrix zero past each row's
    length, the lengths, and a list a row."""
    lens = rng.integers(0, w + 1, n)
    lens[:4] = [0, 1, w - 1, w]
    m = rng.normal(size=(n, w)).astype(dtype)
    m[np.arange(w)[None, :] >= lens[:, None]] = 0
    rows = np.empty(n, object)
    for i in range(n):
        rows[i] = m[i, :lens[i]].tolist()
    return m, lens, rows


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(11)
    js, ts = jch.connect(), tch.connect(device="cpu")
    big = rng.normal(size=(N_BIG, W_BIG)).astype(np.float32)
    big[5] = 0                                   # a zero row
    ids = np.arange(N_BIG, dtype=np.int64)
    rag_m, rag_len, rag_rows = _ragged(rng, N_BIG, W_BIG, np.float32)
    sm_m, sm_len, sm_rows = _ragged(rng, N_SMALL, 11, np.float64)
    s32_rows = np.empty(N_SMALL, object)
    for i in range(N_SMALL):
        s32_rows[i] = [float(np.float32(x)) for x in sm_rows[i]]
    tables = {
        "big": ({"id": ids, "v": big},
                {"id": "Int64", "v": "Array(Float32)"}),
        "rag": ({"id": ids, "v": rag_rows},
                {"id": "Int64", "v": "Array(Float32)"}),
        "small": ({"id": np.arange(N_SMALL, dtype=np.int64), "d": sm_rows,
                   "f": s32_rows},
                  {"id": "Int64", "d": "Array(Float64)",
                   "f": "Array(Float32)"}),
    }
    for name, (cols, types) in tables.items():
        js.execute(f"CREATE TABLE {name} ("
                   + ", ".join(f"{c} {t}" for c, t in types.items()) + ")")
        js.insert_pydict(name, cols)
        table_from_numpy(ts, name, cols, types)
    data = {"big": (big, np.full(N_BIG, W_BIG)), "rag": (rag_m, rag_len),
            "small": (sm_m, sm_len)}
    return js, ts, data


def _scale(fn, a, q, lens):
    if fn == "cosineDistance":
        return np.ones(len(a))
    qq = np.concatenate([[0.0], np.cumsum(q.astype(np.float64) ** 2)])
    return 1 + (a.astype(np.float64) ** 2).sum(1) + qq[lens]


def _column(res):
    return np.asarray([r[0] for r in res.rows()], np.float64)


@pytest.mark.parametrize("fn", DISTANCES + ["L2Norm", "L1Norm"])
@pytest.mark.parametrize("table", ["big", "rag"])
@pytest.mark.parametrize("cast", [True, False], ids=["f32-query",
                                                     "f64-query"])
def test_float32_form_matches_reference(sessions, fn, table, cast,
                                        monkeypatch):
    """Each function over a block at or above 65,536 rows, against a
    Float32 query (Float32 result) and a Float64 one (Float64 result):
    the four with a float32 form go through vector_distance (K11's
    wrapper) once, over every row, and agree with the reference within
    the float32 tolerance; L1, Linf and the norms are float64 and agree
    within 1e-12."""
    js, ts, data = sessions
    a, lens = data[table]
    q = _q(3, W_BIG)
    arg = "" if fn.endswith("Norm") else ", " + _literal(q, cast)
    sql = f"SELECT {fn}(v{arg}) FROM {table}"
    calls = []
    fwd = vector_ops.vector_distance

    def spy(A, *args, **kw):
        calls.append(A.shape)
        return fwd(A, *args, **kw)
    monkeypatch.setattr(vector_ops, "vector_distance", spy)
    got, want = ts.execute(sql), js.execute(sql)
    assert got.types == want.types
    g, w = _column(got), _column(want)
    if fn in KERNEL_FORM:
        assert calls == [(pytest.approx(N_BIG, abs=1024), W_BIG)]
        tol = RTOL32 * np.abs(w) + ATOL32 * _scale(fn, a, q, lens)
        assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w) - tol)
    else:
        assert calls == []
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn", DISTANCES + ["L2Norm", "L1Norm"])
@pytest.mark.parametrize("col", ["d", "f"])
def test_float64_form_matches_reference(sessions, fn, col, monkeypatch):
    """Below the threshold every function is the float64 elementwise form,
    masked by the first argument's lengths (rows of 0 to 11 elements
    against a query of 8, so some rows are longer and some shorter), for
    Float64 and Float32 columns; it agrees within 1e-12."""
    js, ts, _ = sessions
    q = _q(4, 8)
    arg = "" if fn.endswith("Norm") else ", " + _literal(q, cast=False)
    sql = f"SELECT id, {fn}({col}{arg}) FROM small ORDER BY id"
    monkeypatch.setattr(vector_ops, "vector_distance", None)
    got, want = ts.execute(sql), js.execute(sql)
    assert got.types == want.types
    assert [r[0] for r in got.rows()] == [r[0] for r in want.rows()]
    np.testing.assert_allclose([r[1] for r in got.rows()],
                               [r[1] for r in want.rows()], rtol=1e-12,
                               atol=1e-12)


def _numpy_top(a, q, fn, k, keep=None):
    a64, q64 = a.astype(np.float64), q.astype(np.float64)
    if fn == "cosineDistance":
        d = 1 - a64 @ q64 / np.maximum(np.linalg.norm(a64, axis=1)
                                       * np.linalg.norm(q64), 1e-300)
    else:
        d = np.linalg.norm(a64 - q64, axis=1)
    if keep is not None:
        d = np.where(keep, d, np.inf)
    order = np.argsort(d, kind="stable")
    gap = d[order[k]] - d[order[k - 1]]
    assert gap > 1e-4 * max(1.0, abs(d[order[k - 1]])), gap
    return order[:k].tolist()


@pytest.mark.parametrize("sql,fn,k,keep", [
    ("SELECT id FROM big ORDER BY cosineDistance(v, {q32}) LIMIT 10",
     "cosineDistance", 10, None),
    ("SELECT id FROM big ORDER BY L2Distance(v, {q64}) LIMIT 10",
     "L2Distance", 10, None),
    ("SELECT id FROM big WHERE id < 35000 ORDER BY cosineDistance(v, {q32}) "
     "LIMIT 3", "cosineDistance", 3, N_BIG // 2),
], ids=["Q8-float32-top-k", "Q8l-float64-top-k", "Q8w-filtered"])
def test_top_k_by_distance_matches_reference(sessions, sql, fn, k, keep,
                                             monkeypatch):
    """ORDER BY distance LIMIT k as Q8, Q8l and Q8w ask it (at a smaller
    table): a Float32 distance takes K3's 32-bit entry, a Float64 one its
    64-bit entry, and a WHERE's row mask holds under the distance; the
    ids are the reference's and numpy's float64 top-k."""
    from clickhouse_tpu_torch.ops import sort_ops
    js, ts, data = sessions
    q = _q(5, W_BIG)
    sql = sql.format(q32=_literal(q), q64=_literal(q, cast=False))
    entries = []
    for name in ("topk_permutation32", "topk_permutation"):
        fwd = getattr(sort_ops, name)

        def spy(*args, _fwd=fwd, _name=name, **kw):
            entries.append(_name)
            return _fwd(*args, **kw)
        monkeypatch.setattr(sort_ops, name, spy)
    got = [r[0] for r in ts.execute(sql).rows()]
    assert got == [r[0] for r in js.execute(sql).rows()]
    mask = None if keep is None else np.arange(N_BIG) < keep
    qf = q.astype(np.float32) if "CAST" in sql else q
    assert got == _numpy_top(data["big"][0], qf, fn, k, mask)
    assert entries == ["topk_permutation32" if fn == "cosineDistance"
                       else "topk_permutation"]


def test_threshold_reads_the_block_capacity(sessions, monkeypatch):
    """The float32 form starts at a block capacity of 65,536 rows: 64,513
    rows pad to it (K11's form in the port, and the reference's), 64,512
    rows do not; both packages pad alike."""
    js, ts, data = sessions
    a = data["big"][0]
    q = _q(6, W_BIG)
    calls = []
    fwd = vector_ops.vector_distance
    monkeypatch.setattr(vector_ops, "vector_distance",
                        lambda A, *x, **kw: calls.append(A.shape[0])
                        or fwd(A, *x, **kw))
    for n in (64_512, 64_513):
        name = f"cap{n}"
        cols = {"v": a[:n]}
        js.execute(f"CREATE TABLE {name} (v Array(Float32))")
        js.insert_pydict(name, cols)
        table_from_numpy(ts, name, cols, {"v": "Array(Float32)"})
        jcap = js.catalog.get_table("default", name).read_block().capacity
        tcap = ts.catalog.get_table("default", name).read_block().capacity
        assert jcap == tcap
        sql = f"SELECT cosineDistance(v, {_literal(q)}) FROM {name}"
        g, w = _column(ts.execute(sql)), _column(js.execute(sql))
        assert np.all(np.abs(g - w) <= RTOL32 * np.abs(w) + ATOL32)
    assert calls == [65_536]


def test_select_insert_and_cast_of_arrays(sessions):
    """SELECT of an Array column gives lists of its elements (an empty
    row an empty list), INSERT ... VALUES takes array literals, and CAST
    converts an array literal's elements, as the reference does."""
    js, ts, _ = sessions
    for s in (js, ts):
        s.execute("CREATE TABLE lit (id Int64, v Array(Float32), "
                  "w Array(Int64))")
        s.execute("INSERT INTO lit VALUES (1, [1.0, 0.5], [3, -4]), "
                  "(2, [], []), (3, [0.25, 1e-3, -2.5], [7])")
    for sql in ["SELECT id, v, w FROM lit ORDER BY id",
                "SELECT d, f FROM small ORDER BY id LIMIT 20",
                "SELECT v FROM rag WHERE id < 6 ORDER BY id",
                "SELECT CAST([1.5, 2.25, -3] AS Array(Float32)), [1, 2], "
                "CAST([7, 8] AS Array(Float64))"]:
        got, want = ts.execute(sql), js.execute(sql)
        assert got.rows() == want.rows(), sql
        assert got.types == want.types, sql
    sql = ("SELECT id, cosineDistance(v, [1.0, 1.0]), L2Distance(v, "
           "CAST([1, 1] AS Array(Float32))) FROM lit ORDER BY id")
    got, want = ts.execute(sql), js.execute(sql)
    assert got.types == want.types
    np.testing.assert_allclose(np.asarray(got.rows(), np.float64),
                               np.asarray(want.rows(), np.float64),
                               rtol=1e-12)


def _reference_formulas():
    """The `mxu` forms of clickhouse_tpu/exprs/functions_ext.py:2269-2287
    (lambdas there, so written out here)."""
    import jax.numpy as jnp
    return {
        "l2": lambda dot, a2, b2: jnp.sqrt(jnp.maximum(a2 - 2.0 * dot + b2,
                                                       0.0)),
        "l2squared": lambda dot, a2, b2: jnp.maximum(a2 - 2.0 * dot + b2,
                                                     0.0),
        "dot": lambda dot, a2, b2: dot,
        "cosine": lambda dot, a2, b2: 1.0 - dot / jnp.maximum(
            jnp.sqrt(a2) * jnp.sqrt(b2), jnp.finfo(dot.dtype).tiny)}


_REFERENCE_FORMULAS = _reference_formulas()


@pytest.mark.parametrize("op", sorted(vector_ops.DISTANCE_OPS))
@pytest.mark.parametrize("case", ["q-as-wide", "q-narrower", "q-wider",
                                  "rows-past-n"])
def test_vector_distance_plain_matches_reference_parts(op, case):
    """K11's plain version against the reference's _mxu_dist_parts and its
    float32 formulas, over ragged rows (lengths 0, 1, W - 1, W), a zero
    row and a zero query's row: within 1e-5 relative plus 1e-6 of the
    row's scale (module docstring).  The query is padded or cut to the
    column's width as the port's caller does; rows at and past n take the
    zero row's value."""
    import jax.numpy as jnp
    from clickhouse_tpu.core import dtypes as jdt
    from clickhouse_tpu.exprs.expr import ColVal as JColVal
    from clickhouse_tpu.exprs.functions_ext import _mxu_dist_parts
    import torch
    rng = np.random.default_rng(21)
    n, w = 70_000, 16
    a, lens, _ = _ragged(rng, n, w, np.float32)
    a[7] = 0
    lens[7] = w
    wq = {"q-as-wide": w, "q-narrower": 8, "q-wider": 24,
          "rows-past-n": w}[case]
    q = rng.normal(size=wq).astype(np.float32)
    at = jdt.Array(jdt.Float32)
    dot, a2, b2 = (np.asarray(x) for x in _mxu_dist_parts([
        JColVal(at, jnp.asarray(a), lengths=jnp.asarray(lens, jnp.int32)),
        JColVal(at, jnp.asarray(q)[None, :],
                lengths=jnp.asarray([wq], jnp.int32))]))
    want = np.asarray(_REFERENCE_FORMULAS[op](
        jnp.asarray(dot), jnp.asarray(a2), jnp.asarray(b2)))
    qt = torch.from_numpy(q)
    qt = qt[:w] if wq >= w else torch.nn.functional.pad(qt, (0, w - wq))
    n_rows = n - 1000 if case == "rows-past-n" else n
    got = vector_ops.vector_distance(
        torch.from_numpy(a), torch.from_numpy(lens.astype(np.int32)), qt,
        op, n_rows).numpy()
    scale = np.ones(n) if op == "cosine" else 1 + a2 + b2
    ok = np.abs(got[:n_rows] - want[:n_rows]) \
        <= RTOL32 * np.abs(want[:n_rows]) + ATOL32 * scale[:n_rows]
    assert ok.all(), np.flatnonzero(~ok)[:5]
    assert (got[n_rows:] == vector_ops.zero_row_distance(op)).all()


@pytest.mark.parametrize("type_name", ["Array(String)",
                                       "Array(Tuple(Int32, String))",
                                       "Array(Array(Int32))",
                                       "Array(Nullable(Float32))"])
def test_unported_array_types_raise_typed_errors(type_name):
    """An Array of anything but a plain number raises NotImplementedError_
    naming the type when the table is created."""
    from clickhouse_tpu_torch.core.errors import NotImplementedError_
    ts = tch.connect(device="cpu")
    with pytest.raises(NotImplementedError_, match=type_name.replace(
            "(", r"\(").replace(")", r"\)")):
        ts.execute(f"CREATE TABLE bad (v {type_name})")
