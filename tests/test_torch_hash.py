"""The CUDA engine's row hashes against the JAX reference, on the CPU.

``clickhouse_tpu_torch.ops.hash_ops`` (hash64, hash_combine, hash_columns,
bucket_of, _to_u64) against ``clickhouse_tpu.ops.hash_ops`` over the same
numpy-seeded values of every integer type (an int8 -1 sign-extends as
astype(uint64)), UInt32 and UInt64 at and above 2^31 and 2^63, Bool, Date,
DateTime, a Decimal's scaled integer, Float32 and Float64 (with NaN, +-inf,
-0.0 and +0.0): bit-identical, and equal to the reference's native
splitmix64 (clickhouse_tpu/native, its libchnative or its numpy twin).
K15's plain version (``row_hash`` over ``HashArg``s: columns as stored, a
Float64 stored as float32, an intDiv/modulo Term, a constant, more than
four columns through the carried hash) equals hash_columns of the logical
values.  ``cityHash64`` and ``sipHash64`` over numbers, dates, Bool and
Decimal, Nullable, constants and one to six arguments answer as the
reference does through both engines (and a UInt64 `%` or `intDiv` by a
power of two, a mask or a shift); of a String they raise (S3).  Every
comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu import native as jnative
from clickhouse_tpu.ops import hash_ops as jh
from clickhouse_tpu_torch.core.errors import (NotImplementedError_,
                                              UnknownFunction)
from clickhouse_tpu_torch.interop import table_from_numpy
from clickhouse_tpu_torch.ops import hash_ops as th
from clickhouse_tpu_torch.ops.hash_ops import HashArg
from clickhouse_tpu_torch.ops.scan_ops import Term

N = 4_000
U64 = np.uint64


def _values(name, rng, n=N):
    """Seeded values of a type, with its edges: (numpy logical array, the
    port's tensor under the unsigned rule)."""
    if name == "bool":
        a = rng.random(n) < 0.5
    elif name in ("int8", "int16", "int32", "int64"):
        info = np.iinfo(name)
        a = rng.integers(info.min, info.max, n, dtype=name, endpoint=True)
        a[:4] = [-1, 0, info.min, info.max]
    elif name in ("uint8", "uint16", "uint32", "uint64"):
        info = np.iinfo(name)
        a = rng.integers(0, info.max, n, dtype=name, endpoint=True)
        a[:3] = [0, info.max, 1]
        if name in ("uint32", "uint64"):
            top = U64(1) << U64(63 if name == "uint64" else 31)
            a[3:6] = [top - 1 if name == "uint32" else np.uint64(2**63 - 1),
                      top, top + 1]
    elif name == "float32":
        a = rng.normal(0, 1e3, n).astype(np.float32)
        a[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, np.float32(1e-40)]
    else:
        a = rng.normal(0, 1e6, n)
        a[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324]
    if a.dtype == np.uint64:
        t = torch.from_numpy(a.view(np.int64).copy())
    elif a.dtype in (np.uint16, np.uint32):
        t = torch.from_numpy(a.astype(np.int64 if a.dtype == np.uint32
                                      else np.int32))
    else:
        t = torch.from_numpy(a.copy())
    return a, t


TYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
         "uint32", "uint64", "float32", "float64")


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("name", TYPES)
def test_hash64_matches_reference_and_native(name):
    """hash64 of every type's values is the reference's, bit for bit; an
    integer's is the native splitmix64 of its sign-extended bits."""
    a, t = _values(name, np.random.default_rng(TYPES.index(name)))
    want = np.asarray(jh.hash64(jnp.asarray(a)))
    got = _u64(th.hash64(t))
    assert np.array_equal(got, want)
    assert np.array_equal(_u64(th._to_u64(t)),
                          np.asarray(jh._to_u64(jnp.asarray(a))))
    if a.dtype.kind in "iub":
        assert np.array_equal(got, jnative.hash64_np(a.astype(np.uint64)))


@pytest.mark.parametrize("names", [("int8", "uint64"), ("float32", "int32"),
                                   ("bool", "float64", "uint32"),
                                   ("int16", "uint8", "int64", "float64",
                                    "uint16")])
def test_hash_combine_and_columns_match_reference(names):
    rng = np.random.default_rng(len(names))
    cols = [_values(n, rng) for n in names]
    want = np.asarray(jh.hash_columns([jnp.asarray(a) for a, _ in cols]))
    got = th.hash_columns([t for _, t in cols])
    assert np.array_equal(_u64(got), want)
    h = th.hash64(cols[0][1])
    jh_ = jh.hash64(jnp.asarray(cols[0][0]))
    assert np.array_equal(_u64(th.hash_combine(h, cols[1][1])),
                          np.asarray(jh.hash_combine(
                              jh_, jnp.asarray(cols[1][0]))))


@pytest.mark.parametrize("buckets", [1, 2, 8, 1024, 1 << 20])
def test_bucket_of_matches_reference(buckets):
    a, t = _values("uint64", np.random.default_rng(5))
    h = th.hash64(t)
    want = np.asarray(jh.bucket_of(jh.hash64(jnp.asarray(a)), buckets))
    got = th.bucket_of(h, buckets)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_row_hash_plain_reads_columns_as_stored():
    """K15's plain version over columns as stored equals hash_columns of
    the logical values: narrow integer storage, a Float64 stored as
    float32, a dictionary code, an intDiv/modulo Term, a constant, one to
    six columns (past four through the carried hash)."""
    rng = np.random.default_rng(11)
    x = rng.integers(-100_000, 100_000, N)
    f = rng.normal(0, 1, N).astype(np.float32)
    code = rng.integers(0, 300, N).astype(np.int32)
    args = [HashArg(torch.from_numpy(x.astype(np.int32))),
            HashArg(torch.from_numpy(f), "f64"),
            HashArg(torch.from_numpy(code)),
            HashArg(Term(torch.from_numpy(x.astype(np.int32)), "mod", 7,
                         torch.int64)),
            HashArg(torch.tensor(-3, dtype=torch.int64)),
            HashArg(Term(torch.from_numpy(x.astype(np.int32)), "div", -4,
                         torch.int64))]
    logical = [x, f.astype(np.float64), code, np.fmod(x, 7),
               np.full(N, -3, np.int64),
               (np.abs(x) // 4) * -np.sign(x)]
    for k in range(1, len(args) + 1):
        want = np.asarray(jh.hash_columns([jnp.asarray(v)
                                           for v in logical[:k]]))
        assert np.array_equal(_u64(th.row_hash(args[:k])), want), k
        folded = th.fold_args(args[:k], 4)
        assert len(folded) <= 4
        assert np.array_equal(_u64(th.row_hash(folded)), want), k
    assert np.array_equal(
        _u64(th.row_hash([HashArg(torch.tensor(5))], 3)),
        np.asarray(jh.hash64(jnp.full((3,), 5, jnp.int64))))
    assert np.array_equal(
        _u64(th.row_hash([HashArg(torch.from_numpy(f), "f32")])),
        np.asarray(jh.hash64(jnp.asarray(f))))


def test_row_hash_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        th.row_hash([])
    with pytest.raises(ValueError):
        th.row_hash([HashArg(torch.zeros(3, dtype=torch.int32), "f32")])
    with pytest.raises(ValueError):
        th.row_hash([HashArg(torch.zeros(3)), HashArg(
            torch.zeros(3, dtype=torch.int64), "hash")])
    with pytest.raises(ValueError):
        th.row_hash([HashArg(torch.zeros(3)), HashArg(torch.zeros(4))])


# -- the hashing functions through both engines ------------------------------

_SESSIONS = []


def _sessions():
    if not _SESSIONS:
        rng = np.random.default_rng(23)
        n = 3_000
        cols = {"i8": rng.integers(-128, 128, n).astype(np.int8),
                "u32": rng.integers(0, 1 << 32, n, dtype=np.uint64)
                .astype(np.uint32),
                "u64": rng.integers(0, 1 << 63, n, dtype=np.uint64)
                + (rng.random(n) < 0.5).astype(np.uint64) * U64(1 << 63),
                "i64": rng.integers(-10**6, 10**6, n),
                "f32": rng.normal(0, 1, n).astype(np.float32),
                "f64": np.where(rng.random(n) < 0.5, rng.normal(0, 1, n),
                                rng.integers(-50, 50, n).astype(np.float64)),
                "b": rng.random(n) < 0.3,
                "d": rng.integers(0, 40_000, n).astype(np.int32),
                "t": rng.integers(0, 2**31, n).astype(np.int64),
                "dec": rng.integers(-10**9, 10**9, n),
                "nv": np.asarray([None if i % 7 == 0 else int(i % 50)
                                  for i in range(n)], object),
                "s": np.asarray([f"s{i % 37}" for i in range(n)], object)}
        types = {"i8": "Int8", "u32": "UInt32", "u64": "UInt64",
                 "i64": "Int64", "f32": "Float32", "f64": "Float64",
                 "b": "Bool", "d": "Date", "t": "DateTime",
                 "dec": "Decimal(18, 2)", "nv": "Nullable(Int64)",
                 "s": "String"}
        js, ts = jch.connect(), tch.connect(device="cpu")
        js.execute("CREATE TABLE h (" + ", ".join(
            f"{c} {t}" for c, t in types.items()) + ")")
        js.insert_pydict("h", cols)
        blk = js.catalog.get_table("default", "h").read_block()
        table_from_numpy(ts, "h", {k: np.asarray(v) for k, v in
                                   blk.to_pydict().items()}, types)
        _SESSIONS.extend([js, ts])
    return _SESSIONS


HASH_SQL = [
    "SELECT cityHash64(i8), sipHash64(u32), cityHash64(u64) FROM h",
    "SELECT cityHash64(i64, f32), sipHash64(f64) FROM h",
    "SELECT cityHash64(b), sipHash64(d), cityHash64(t), sipHash64(dec) "
    "FROM h",
    "SELECT cityHash64(nv), sipHash64(nv, i8) FROM h",
    "SELECT cityHash64(i8, u32, u64, i64, f32, f64) FROM h",
    "SELECT cityHash64(i64 % 7, intDiv(i64, 3), 5) FROM h",
    "SELECT cityHash64(1), sipHash64(1, 2.5), cityHash64(-1)",
    "SELECT count() FROM h WHERE cityHash64(i64) % 16 = 3",
    "SELECT u64 % 16, intDiv(u64, 1024), u64 % 9223372036854775808, "
    "intDiv(u64, 9223372036854775808), u64 % 1, intDiv(u64, 1), u64 % 7 "
    "FROM h",
    "SELECT cityHash64(i64) % 8 AS b, count() FROM h GROUP BY b ORDER BY b",
]


@pytest.mark.parametrize("sql", HASH_SQL)
def test_hash_functions_match_reference(sql):
    js, ts = _sessions()
    assert ts.execute(sql).rows() == js.execute(sql).rows()


def test_hash_of_a_string_raises_naming_s3():
    """S3: the reference hashes a String's dictionary code; the port
    refuses until the byte hashes are ported
    (tests/test_torch_ops.py DIVERGENCES["s3_city_hash_of_a_string"])."""
    ts = _sessions()[1]
    for sql in ("SELECT cityHash64(s) FROM h",
                "SELECT sipHash64(i64, s) FROM h"):
        with pytest.raises(NotImplementedError_, match="S3"):
            ts.execute(sql)


def test_byte_hashes_stay_unported():
    """xxHash64 is the reference's byte-wise host function
    (functions_ext2.py:383-396), not the row hash: it raises."""
    js, ts = _sessions()
    assert js.execute("SELECT xxHash64(1)").rows() == [
        (11468921228449061269,)]
    with pytest.raises(UnknownFunction):
        ts.execute("SELECT xxHash64(1)")
