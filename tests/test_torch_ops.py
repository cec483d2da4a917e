"""clickhouse_tpu_torch's kernels (their plain versions, on the CPU) against
the JAX reference functions they replace, on the same numpy inputs.

  K1 masked_reduce       vs Grouping.reduce of group_trivial / count_mask
  K2 dense_group_reduce  vs mxu_counts_and_sums / mxu_group_reduce
  K3 topk_smallest       vs topk_permutation / topk_permutation32
  K4 radix_sort_pairs    vs sort_permutation and group_by_sort's perm
  K5 segment_bounds      vs group_by_sort's group ids, bounds, unique keys
  K6 segment_reduce      vs seg_reduce_sorted
  order_token, topk_key32 on every dtype

Integers must be bit-exact.  Float sums: rtol=1e-12, because the two sum
in different orders (pairwise in XLA, sequential partials in torch).  A
float sum over the sort grouping is held to an absolute tolerance of
n * eps * max|prefix| instead: the reference takes each group's sum as a
difference of two prefix sums over all n sorted rows, so its error scales
with the running prefix, not with the group, while K6 adds each group's
own values.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clickhouse_tpu.core import dtypes as jdt
from clickhouse_tpu.exprs.expr import ColVal as JColVal
from clickhouse_tpu.ops import agg_ops as jagg
from clickhouse_tpu.ops import filter_ops as jfilter
from clickhouse_tpu.ops import mxu_segsum as jmxu
from clickhouse_tpu.ops import scan_ops as jscan
from clickhouse_tpu.ops import sort_ops as jsort
from clickhouse_tpu_torch.core import dtypes as tdt
from clickhouse_tpu_torch.exprs.expr import ColVal as TColVal
from clickhouse_tpu_torch.ops import agg_ops as tagg
from clickhouse_tpu_torch.ops import filter_ops as tfilter
from clickhouse_tpu_torch.ops import mxu_segsum as tmxu
from clickhouse_tpu_torch.ops import scan_ops as tscan
from clickhouse_tpu_torch.ops import sort_ops as tsort

NP_DTYPES = ["bool", "int8", "uint8", "int16", "uint16", "int32", "uint32",
             "int64", "uint64", "float32", "float64"]
OPS = ["sum", "min", "max", "any", "bor", "band", "bxor"]
FLOAT_RTOL = 1e-12


def _t(a: np.ndarray) -> torch.Tensor:
    return tdt.tensor_from_numpy(a, "cpu")


def _values(rng, name, n):
    d = np.dtype(name)
    if d.kind == "b":
        return rng.random(n) < 0.5
    if d.kind == "f":
        a = rng.normal(0, 1e6, n)
        a[rng.random(n) < 0.05] = -0.0
        a[rng.random(n) < 0.05] = 0.0
        return a.astype(d)
    info = np.iinfo(d)
    return rng.integers(info.min, info.max, n, endpoint=True, dtype=d)


def _same(port: torch.Tensor, ref, ref_dtype=None):
    want = np.asarray(ref)
    got = tdt.to_numpy_storage(port, ref_dtype or want.dtype)
    if want.dtype.kind == "f":
        got = got.astype(np.float64)
        w = want.astype(np.float64)
        assert np.isnan(got).tolist() == np.isnan(w).tolist()
        ok = ~np.isnan(w)
        np.testing.assert_allclose(got[ok], w[ok], rtol=FLOAT_RTOL, atol=0)
        zero = ok & (w == 0)
        assert np.signbit(got[zero]).tolist() == np.signbit(w[zero]).tolist()
    else:
        assert got.astype(want.dtype).tolist() == want.tolist()


# -- K1 ----------------------------------------------------------------------

@pytest.mark.parametrize("name", NP_DTYPES)
def test_masked_reduce_matches_reference(name):
    rng = np.random.default_rng(len(name))
    n = 3000
    x = _values(rng, name, n)
    masks = {"some": rng.random(n) < 0.3, "none_masked": None,
             "all_masked": np.zeros(n, bool)}
    for op in OPS:
        if op in ("bor", "band", "bxor") and np.dtype(name).kind == "f":
            continue
        if op in ("min", "max") and name == "bool":
            continue     # the reference has no bool min/max (Bool is UInt8)
        for m in masks.values():
            mj = jnp.ones(n, jnp.bool_) if m is None else jnp.asarray(m)
            g = jagg.group_trivial(jnp.ones(n, jnp.bool_))
            ref = np.asarray(g.reduce(op, jnp.asarray(x), mj))[0]
            got = tagg.masked_reduce(op, _t(x), None if m is None else _t(m),
                                     unsigned=name == "uint64")
            _same(got.reshape(1), np.asarray([ref]))


def test_masked_reduce_nan_negzero_and_int64_overflow():
    g = jagg.group_trivial(jnp.ones(4, jnp.bool_))
    x = np.array([1.0, np.nan, -0.0, 0.0])
    for op, m in (("min", None), ("max", None), ("sum", None),
                  ("min", np.array([0, 0, 1, 1], bool)),
                  ("max", np.array([0, 0, 1, 1], bool))):
        mj = jnp.ones(4, jnp.bool_) if m is None else jnp.asarray(m)
        ref = np.asarray(g.reduce(op, jnp.asarray(x), mj))[:1]
        got = tagg.masked_reduce(op, _t(x), None if m is None else _t(m))
        _same(got.reshape(1), ref)
    big = np.full(1000, (1 << 62) + 12345, np.int64)
    g = jagg.group_trivial(jnp.ones(1000, jnp.bool_))
    ref = np.asarray(g.reduce("sum", jnp.asarray(big),
                              jnp.ones(1000, jnp.bool_)))[:1]
    _same(tagg.masked_reduce("sum", _t(big)).reshape(1), ref)


def test_count_mask_matches_reference():
    m = np.random.default_rng(0).random(5000) < 0.37
    assert int(tfilter.count_mask(_t(m))) == \
        int(jfilter.count_mask(jnp.asarray(m)))
    g = jagg.group_trivial(jnp.ones(5000, jnp.bool_))
    gt = tagg.group_trivial(torch.device("cpu"))
    assert np.asarray(g.count_rows(jnp.asarray(m))).tolist() == \
        gt.count_rows(_t(m)).tolist()


@pytest.mark.parametrize("case", range(13))
def test_masked_reduce_terms_match_reference(case):
    """The plain K1 with a filter term and a row bound against the
    reference's comparison, count_mask and Grouping._reduce_trivial: every
    storage type a term reads, every comparison, NaN, NULLs, constants
    beyond the storage range and UInt64 against signed constants (compared
    in float64)."""
    from chip_smoke import CMPS, _lit_type, make_term, term_cases
    from clickhouse_tpu.exprs import functions as jfn
    from clickhouse_tpu.exprs.expr import BoundLiteral as JLiteral
    from clickhouse_tpu.exprs.expr import _literal_colval as jliteral
    rng = np.random.default_rng(case)
    n, n_rows = 3000, 2993
    type_name, values, lits = term_cases(rng, n)[case]
    jt = jdt.parse_type_name(type_name)
    vals, validity = np.asarray(values), None
    if vals.dtype == object:                 # NULLs
        validity = np.array([v is not None for v in vals])
        vals = np.where(validity, vals, 0)
        validity = jnp.asarray(validity.astype(np.uint8))
    col = JColVal(jt, jnp.asarray(vals.astype(jdt.remove_nullable(jt)
                                              .np_dtype)), validity)
    y = rng.integers(-(1 << 40), 1 << 40, n)
    g = jagg.group_trivial(jnp.ones(n, jnp.bool_))
    for cmp in CMPS:
        for lit in lits:
            pred = jfn.get(cmp).execute(
                [col, jliteral(JLiteral(lit, jdt.parse_type_name(
                    _lit_type(lit))))], jdt.UInt8)
            m = (np.asarray(pred.data) != 0) & (np.arange(n) < n_rows)
            if pred.validity is not None:
                m &= np.asarray(pred.validity) != 0
            t = make_term(values, type_name, cmp, lit, "cpu")
            got = tagg.masked_reduce("sum", None, n_rows=n_rows, terms=[t])
            assert int(got) == int(jfilter.count_mask(jnp.asarray(m))), \
                (type_name, cmp, lit)
            yt = np.zeros(t.storage.shape[0], np.int64)
            yt[:n] = y
            for op in ("sum", "min", "max"):
                ref = np.asarray(g.reduce(op, jnp.asarray(y),
                                          jnp.asarray(m)))[:1]
                got = tagg.masked_reduce(op, _t(yt), n_rows=n_rows,
                                         terms=[t])
                _same(got.reshape(1), ref)


def _k1_term_rows(kt, storage: np.ndarray) -> np.ndarray:
    """csrc/masked_reduce.cu term_pass over host values, from the kernel
    parameters _k1_term gives (validity left out)."""
    U = np.uint64
    if storage.dtype.kind == "f":
        d = storage.astype(np.float32).astype(np.float64) \
            if kt.mode == tagg._TM_F32 else storage.astype(np.float64)
    elif kt.mode == tagg._TM_I32:
        k = (storage.astype(np.int64) - kt.lo) & 0xFFFFFFFF
        return (k <= kt.span) != bool(kt.neg)
    elif kt.mode == tagg._TM_K64:
        key = storage.astype(np.int64).view(U) ^ U(kt.xorv)
        return ((key - U(kt.lo)) <= U(kt.span)) != bool(kt.neg)
    else:
        x = storage.astype(np.int64)
        d = x.astype(np.float32).astype(np.float64) \
            if kt.mode == tagg._TM_F32 else x.astype(np.float64)
        if kt.u64src:
            d = np.where(x < 0, d + 18446744073709551616.0, d)
    nan = np.isnan(d)
    b = np.where(d == 0, 0.0, d).view(U)
    key = np.where(b >> U(63), ~b, b | U(1 << 63))
    ok = ((key - U(kt.lo)) <= U(kt.span)) != bool(kt.neg)
    return np.where(nan, bool(kt.nan_pass), ok)


def test_k1_term_parameters_give_the_plain_rows():
    """The kernel's form of every term (key range, negation, NaN answer,
    32-bit test for narrow columns), emulated on the host, selects the rows
    the plain version selects."""
    from chip_smoke import CMPS, make_term, term_cases
    rng = np.random.default_rng(3)
    n = 5000
    for type_name, values, lits in term_cases(rng, n):
        for cmp in CMPS:
            for lit in lits:
                t = make_term(values, type_name, cmp, lit, "cpu")
                kt = tagg._k1_term(t, 0)
                got = _k1_term_rows(kt, t.storage.numpy())
                if t.validity is not None:
                    got = got & (t.validity.numpy() != 0)
                want = t.evaluate().numpy()
                assert got.tolist() == want.tolist(), (type_name, cmp, lit)


# -- K2 ----------------------------------------------------------------------

@pytest.mark.parametrize("S", [7, 1024, 16384])
def test_dense_counts_and_sums_match_reference(S):
    rng = np.random.default_rng(S)
    n = 70_000                          # > one 65,536-row reference chunk
    ids = rng.integers(0, S, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    vals = [(rng.integers(-(1 << 62), 1 << 62, n), True),      # negative
            (rng.integers(0, 200, n).astype(np.uint8), False),
            (rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32),
             True)]
    rc, rs = jmxu.mxu_counts_and_sums(
        jnp.asarray(ids), jnp.asarray(mask),
        [(jnp.asarray(v), s) for v, s in vals], S)
    tc, ts = tmxu.mxu_counts_and_sums(_t(ids), _t(mask),
                                      [(_t(v), s) for v, s in vals], S)
    assert tc.tolist() == np.asarray(rc).tolist()
    for got, ref in zip(ts, rs):
        assert tdt.to_numpy_storage(got, np.asarray(ref).dtype).tolist() \
            == np.asarray(ref).tolist()


def test_dense_group_reduce_matches_reference_batched():
    rng = np.random.default_rng(5)
    n, S = 70_000, 2048
    ids = rng.integers(0, S, n).astype(np.int32)
    base = rng.random(n) < 0.9
    cm = [None, rng.random(n) < 0.5]
    sv = [rng.integers(-10**12, 10**12, n), rng.integers(0, 9, n)]
    sm = [rng.random(n) < 0.5, None]
    rc, rs = jmxu.mxu_group_reduce(
        jnp.asarray(ids), jnp.asarray(base),
        [None if m is None else jnp.asarray(m) for m in cm],
        [(jnp.asarray(v), True, None,
          None if m is None else jnp.asarray(m)) for v, m in zip(sv, sm)], S)
    tc, ts = tmxu.mxu_group_reduce(
        _t(ids), _t(base), [None if m is None else _t(m) for m in cm],
        [(_t(v), True, None, None if m is None else _t(m))
         for v, m in zip(sv, sm)], S)
    for got, ref in zip(tc + ts, list(rc) + list(rs)):
        assert got.tolist() == np.asarray(ref).tolist()


def test_dense_group_reduce_skips_ids_outside_slots():
    ids = torch.tensor([0, 3, -1, 4, 2], dtype=torch.int32)
    counts, sums = tmxu.dense_group_reduce(
        ids, None, [None], [torch.tensor([1, 2, 3, 4, 5])], [None], 4)
    assert counts.tolist() == [[1, 0, 1, 1]]
    assert sums.tolist() == [[1, 0, 5, 2]]


# -- K3 ----------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(50, 10), (50, 80), (20_000, 100),
                                 (1 << 20, 64)])
def test_topk_permutation_matches_reference(n, k):
    rng = np.random.default_rng(n + k)
    tok = (rng.integers(0, 40, n).astype(np.uint64)
           * np.uint64(1 << 58))                    # ties, top bit set
    valid = rng.random(n) < 0.7
    ref = np.asarray(jsort.topk_permutation(jnp.asarray(tok),
                                            jnp.asarray(valid), k))
    got = tsort.topk_permutation(_t(tok), _t(valid), k).numpy()
    m = min(int(valid.sum()), k)
    assert got[:m].tolist() == ref[:m].tolist()


@pytest.mark.parametrize("n,k", [(70_000, 100), (70_000, 4096)])
def test_topk_permutation32_matches_reference(n, k):
    rng = np.random.default_rng(k)
    key = rng.integers(0, 1 << 32, n).astype(np.uint32)
    key[rng.random(n) < 0.1] = 7                        # ties
    key[:5] = [2**32 - 1, 2**32 - 2, 2**32 - 1, 0, 0]   # clamp collisions
    valid = rng.random(n) < 0.9
    ref = np.asarray(jsort.topk_permutation32(jnp.asarray(key),
                                              jnp.asarray(valid), k))
    got = tsort.topk_permutation32(_t(key), _t(valid), k).numpy()
    m = min(int(valid.sum()), k)
    assert got[:m].tolist() == ref[:m].tolist()


def _key32_case(case, rng, n):
    """(u32 keys, validity) for one case of the 32-bit entry."""
    key = rng.integers(0, 1 << 32, n).astype(np.uint32)
    valid = np.ones(n, bool)
    if case == "ties":
        key = rng.integers(0, 50, n).astype(np.uint32)
    elif case == "extremes":                 # 2^32 - 2 and 2^32 - 1 tie
        key[rng.random(n) < 0.5] = 2**32 - 1
        key[rng.random(n) < 0.5] = 2**32 - 2
        key[rng.random(n) < 0.001] = 3
    elif case == "invalid":
        valid = rng.random(n) < 0.3
        key[::3] = 0                         # the smallest keys, some invalid
    elif case == "k_over_valid":
        valid = np.zeros(n, bool)
        valid[rng.choice(n, 40, replace=False)] = True
    elif case == "descending":               # topk_key32's DESC key: ~key
        key = ~rng.integers(0, 1000, n).astype(np.uint32)
    return key, valid


@pytest.mark.parametrize("case", ["ties", "extremes", "invalid",
                                  "k_over_valid", "descending"])
@pytest.mark.parametrize("n,k", [(1 << 16, 100), (70_000, 4096)])
def test_topk_permutation32_int32_entry_matches_reference(case, n, k):
    rng = np.random.default_rng(n + k + len(case))
    key, valid = _key32_case(case, rng, n)
    ref = np.asarray(jsort.topk_permutation32(jnp.asarray(key),
                                              jnp.asarray(valid), k))
    bits = torch.from_numpy(key.view(np.int32).copy())   # the u32 as int32
    got = tsort.topk_permutation32(bits, _t(valid), k).numpy()
    plain = tsort.topk_smallest32(bits, _t(valid), k).numpy()
    m = min(int(valid.sum()), k)
    assert got[:m].tolist() == ref[:m].tolist()
    assert plain[:m].tolist() == ref[:m].tolist()


def test_topk_clamped_keys_tie():
    key = torch.tensor([2**32 - 1, 2**32 - 2, 5], dtype=torch.int64)
    valid = torch.ones(3, dtype=torch.bool)
    assert tsort.topk_permutation32(key, valid, 3).tolist() == [2, 0, 1]


# -- order tokens ------------------------------------------------------------

@pytest.mark.parametrize("name", NP_DTYPES)
def test_order_token_matches_reference(name):
    rng = np.random.default_rng(1)
    x = _values(rng, name, 500)
    if np.dtype(name).kind == "f":
        x[:3] = [np.nan, -0.0, np.inf]
    validity = (rng.random(500) < 0.8).astype(np.uint8)
    for desc in (False, True):
        for v, nl in ((None, True), (validity, True), (validity, False)):
            ref = np.asarray(jsort.order_token(
                jnp.asarray(x), descending=desc,
                validity=None if v is None else jnp.asarray(v),
                nulls_last=nl))
            got = tsort.order_token(
                _t(x), descending=desc, validity=None if v is None else _t(v),
                nulls_last=nl, unsigned=np.dtype(name).kind == "u")
            assert got.numpy().view(np.uint64).tolist() == ref.tolist()


@pytest.mark.parametrize("name", ["float32", "float64", "int64"])
def test_sortable_bits_match_reference(name):
    """Floats enter a sort as the reference's tokens (-0.0 and +0.0 apart,
    NaNs last) and decode to their own bits; other types pass as they
    are."""
    from clickhouse_tpu.ops import hash_ops as jhash
    from clickhouse_tpu_torch.ops import hash_ops as thash
    rng = np.random.default_rng(3)
    x = _values(rng, name, 500)
    if np.dtype(name).kind == "f":
        x[:5] = [np.nan, -np.nan, -np.inf, -0.0, np.inf]
    ref, ref_decode = jhash.sortable_bits(jnp.asarray(x))
    got, decode = thash.sortable_bits(_t(x))
    assert (decode is None) == (ref_decode is None)
    if decode is None:
        assert got.numpy().tolist() == x.tolist()
        return
    assert got.numpy().view(np.uint64).tolist() == np.asarray(ref).tolist()
    bits = np.dtype(f"uint{8 * x.itemsize}")
    assert decode(got).numpy().view(bits).tolist() == x.view(bits).tolist()
    assert np.asarray(ref_decode(ref)).view(bits).tolist() == \
        x.view(bits).tolist()


@pytest.mark.parametrize("name", NP_DTYPES)
def test_topk_key32_matches_reference(name):
    rng = np.random.default_rng(2)
    x = _values(rng, name, 500)
    tname = {"bool": "Bool"}.get(name, name.capitalize()
                                 .replace("Uint", "UInt"))
    bounds = (int(x.min()), int(x.min()) + 1000) \
        if np.dtype(name).kind in "iu" else None
    for desc in (False, True):
        ref = jsort.topk_key32(JColVal(jdt.parse_type_name(tname),
                                       jnp.asarray(x), bounds=bounds), desc)
        got = tsort.topk_key32(TColVal(tdt.parse_type_name(tname), _t(x),
                                       bounds=bounds), desc)
        if ref is None:
            assert got is None
        else:
            assert got.dtype == torch.int32     # the u32 key as int32 bits
            assert got.numpy().view(np.uint32).tolist() == \
                np.asarray(ref).astype(np.uint32).tolist()


# -- the port itself -----------------------------------------------------------

def test_port_imports_without_jax():
    code = ("import sys, clickhouse_tpu_torch, clickhouse_tpu_torch.ops, "
            "clickhouse_tpu_torch.exec.session, chip_smoke; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if 'jax' in m)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_wrappers_refuse_devices_without_a_kernel():
    with pytest.raises(RuntimeError):
        tagg.masked_reduce("sum", torch.ones(3, device="meta"))
    with pytest.raises(RuntimeError):
        tsort.topk_smallest(torch.ones(3, dtype=torch.int64, device="meta"),
                            None, 1)


def test_unported_paths_raise_typed_errors():
    """The sort grouping and the full sort answer as the reference's (they
    raised before K4-K6); K3's own k > 4,096 refusal stays."""
    from clickhouse_tpu_torch.core.errors import NotImplementedError_
    x = np.array([3, 1, 3, 2], np.int64)
    valid = np.array([1, 1, 0, 1], bool)
    g = tagg.group_by_sort([tsort.SortKey(_t(x))], _t(valid), 4)
    ref = jagg.group_by_sort([jnp.asarray(x)], jnp.asarray(valid), 4)
    assert g.perm[:3].tolist() == np.asarray(ref.perm)[:3].tolist()
    assert g.unique_keys[0][:3].tolist() == \
        np.asarray(ref.unique_keys[0])[:3].tolist()
    tok = tsort.order_token(_t(x))
    assert tsort.sort_permutation([tok], _t(valid))[:3].tolist() == \
        np.asarray(jsort.sort_permutation(
            [jsort.order_token(jnp.asarray(x))], jnp.asarray(valid)))[
            :3].tolist()
    with pytest.raises(NotImplementedError_, match="large-k"):
        tsort.topk_smallest(torch.zeros(10_000, dtype=torch.int64), None,
                            5000)


# -- K4, K5, K6 --------------------------------------------------------------

def _key_values(rng, name, n):
    """Keys with ties (and NaN, -0.0 and +0.0 for floats; UInt64 above
    2^63), away from the 64-bit maxima where the reference's clamped min/max
    tokens tie."""
    d = np.dtype(name)
    if d.kind == "b":
        return rng.random(n) < 0.5
    if d.kind == "f":
        a = rng.integers(-20, 20, n).astype(np.float64) / 4
        a[rng.random(n) < 0.05] = np.nan
        a[rng.random(n) < 0.05] = -0.0
        return a.astype(d)
    info = np.iinfo(d)
    pool = rng.integers(info.min, info.max - 1, 40, endpoint=True, dtype=d)
    return pool[rng.integers(0, 40, n)]


def _sort_key(x: np.ndarray) -> tsort.SortKey:
    return tsort.SortKey(_t(x), unsigned=x.dtype == np.uint64)


@pytest.mark.parametrize("name", NP_DTYPES)
def test_sort_permutation_matches_reference(name):
    """Two tokens (the second descending), invalid rows: the valid rows
    come in the reference's stable order; K4's pass plan and packing run
    through its plain version."""
    rng = np.random.default_rng(len(name) + 5)
    n = 5000
    a, b = _key_values(rng, name, n), _key_values(rng, "int16", n)
    valid = rng.random(n) < 0.8
    ref = np.asarray(jsort.sort_permutation(
        [jsort.order_token(jnp.asarray(a)),
         jsort.order_token(jnp.asarray(b), descending=True)],
        jnp.asarray(valid)))
    got = tsort.sort_permutation(
        [tsort.order_token(_t(a), unsigned=name == "uint64"),
         tsort.order_token(_t(b), descending=True)], _t(valid))
    m = int(valid.sum())
    assert got.dtype == torch.int64
    assert got[:m].tolist() == ref[:m].tolist()


def _groupings(keys, valid, cap_g):
    ref = jagg.group_by_sort([jnp.asarray(k) for k in keys],
                             jnp.asarray(valid), cap_g)
    got = tagg.group_by_sort([_sort_key(k) for k in keys], _t(valid), cap_g)
    return ref, got


@pytest.mark.parametrize("name", NP_DTYPES)
@pytest.mark.parametrize("cap_g", [64, 4096])
def test_group_by_sort_matches_reference(name, cap_g):
    """K4's perm, K5's group ids, group count, segment bounds and the
    unique keys, for every key type; cap_g 64 leaves groups without a
    slot."""
    rng = np.random.default_rng(len(name) + cap_g)
    n = 3000
    keys = [_key_values(rng, name, n)]
    if name == "int32":                  # a Nullable key: validity, data
        v = rng.random(n) < 0.9
        keys = [v, np.where(v, keys[0], 0).astype(np.int32),
                _key_values(rng, "uint64", n)]
    valid = rng.random(n) < 0.85
    ref, got = _groupings(keys, valid, cap_g)
    m = int(valid.sum())
    assert got.perm[:m].tolist() == np.asarray(ref.perm)[:m].tolist()
    assert got.group_ids.tolist() == np.asarray(ref.group_ids).tolist()
    ng = int(ref.num_groups)
    assert int(got.num_groups) == ng
    assert got.starts.tolist() == np.asarray(ref.starts).tolist()
    assert got.ends.tolist() == np.asarray(ref.ends).tolist()
    for g, r in zip(got.unique_keys, ref.unique_keys):
        k = min(ng, cap_g)
        _same(g[:k], np.asarray(r)[:k])


def _sum_atol(data, ref_grouping, mask):
    """n * eps * max|prefix| of the reference's prefix sums of the masked
    data in sorted order."""
    d = np.asarray(data, np.float64)[np.asarray(ref_grouping.perm)]
    if mask is not None:
        d = np.where(np.asarray(mask)[np.asarray(ref_grouping.perm)], d, 0.0)
    d = np.where(np.isfinite(d), d, 0.0)
    return len(d) * np.finfo(np.float64).eps * np.abs(np.cumsum(d)).max()


@pytest.mark.parametrize("name", NP_DTYPES)
def test_segment_reduce_matches_reference(name):
    """K6's plain version against seg_reduce_sorted over the reference's
    grouping of the same keys: every op, with and without a mask, groups
    without a masked-in row, NaN and -0.0."""
    rng = np.random.default_rng(len(name) + 9)
    n, cap_g = 3000, 1024
    keys = [rng.integers(0, 300, n)]
    valid = rng.random(n) < 0.9
    ref_g, got_g = _groupings(keys, valid, cap_g)
    d = np.dtype(name)
    x = _key_values(rng, name, n) if d.kind != "f" else _values(rng, name, n)
    if d.kind == "f":
        x[rng.random(n) < 0.02] = np.nan
    gid = got_g.group_ids
    for op in OPS:
        if op in ("bor", "band", "bxor") and d.kind == "f":
            continue
        for m in (None, rng.random(n) < 0.3, np.zeros(n, bool)):
            if op == "band" and name == "bool" and m is not None:
                # the reference gives masked-out bool rows False as band's
                # identity (clickhouse_tpu/ops/scan_ops.py:226 inverts it
                # for integer types only): ROADMAP queue 3
                continue
            mj = None if m is None else ref_g.take(jnp.asarray(m))
            xs = x
            if op == "sum" and d.kind == "f":
                # the reference's prefix difference turns every group after
                # a NaN into NaN (ROADMAP queue 3); K6 sums each group
                xs = np.where(np.isnan(x), 0.5, x).astype(d)
            want = np.asarray(jscan.seg_reduce_sorted(
                op, ref_g.take(jnp.asarray(xs)), ref_g.group_ids,
                ref_g.boundary, ref_g.starts, ref_g.ends, cap_g,
                mask_sorted=mj))
            got = tscan.segment_reduce(op, _t(xs), None if m is None
                                       else _t(m), got_g.perm, gid, cap_g,
                                       unsigned=name == "uint64")
            if op == "sum" and d.kind == "f":
                g = got.numpy()
                assert np.isnan(g).tolist() == np.isnan(want).tolist()
                ok = ~np.isnan(want)
                np.testing.assert_allclose(
                    g[ok], want[ok], rtol=0,
                    atol=_sum_atol(xs, ref_g, m))
            else:
                _same(got, want)
    cnt = tscan.segment_reduce("count", None, _t(valid), got_g.perm, gid,
                               cap_g)
    assert cnt.tolist() == (got_g.ends - got_g.starts).tolist()


def test_radix_sort_pass_plan(monkeypatch):
    """K4 sorts only the bits that vary, in even digits: x's 20 bits plus
    the invalid flag take three 7-bit passes, and Q2b's scan rows (every
    row below the row count valid) the 20 bits alone, also in three."""
    assert tsort.sort_pass_plan(21) == (3, 7)
    assert tsort.sort_pass_plan(32) == (4, 8)
    assert tsort.sort_pass_plan(64) == (8, 8)
    assert tsort.sort_pass_plan(0) == (1, 1)
    x = np.arange(200_000, dtype=np.int64) * 2654435761 % 1_000_003
    seen = []
    plain = tsort._radix_sort_pairs_plain

    def spy(keys, bits, values):
        seen.append((keys.dtype, bits))
        return plain(keys, bits, values)
    monkeypatch.setattr(tsort, "_radix_sort_pairs_plain", spy)
    key = tsort.SortKey(_t(x).to(torch.int32), bounds=(0, 1_000_002))
    perm, _ = tsort.sort_rows([key], torch.ones(len(x), dtype=bool))
    assert seen == [(torch.int32, 21)]
    assert perm.tolist() == np.argsort(x, kind="stable").tolist()
    rows = tagg.RowMask(len(x) + 100, torch.device("cpu"), len(x))
    padded = tsort.SortKey(torch.cat([key.data, key.data[:100]]),
                           bounds=key.bounds)
    g = tagg.group_by_sort([padded], rows, 1 << 20)
    assert seen[1:] == [(torch.int32, 20)]
    assert g.perm.tolist() == perm.tolist()
    assert int(g.num_groups) == len(np.unique(x))


def test_segment_bounds_folds_key_arrays_past_the_fourth():
    """K5 compares four key arrays a row; six arrays give the groups that
    comparing all six gives (the last three folded into their own group
    ids first)."""
    rng = np.random.default_rng(11)
    n, cap_g = 5000, 1024
    lead = np.sort(rng.integers(0, 300, n))
    keys = [_t(lead.astype(np.int32))] + [
        _t(np.where(lead % p == 0, rng.integers(0, 3, n), 0).astype(dt))
        for p, dt in ((2, np.int64), (3, np.int32), (5, np.int64),
                      (7, np.int32), (11, np.int64))]
    nv = torch.tensor(n - 37)
    got = tscan.segment_bounds(keys, nv, cap_g)
    want = tscan._segment_bounds_plain(keys, nv, cap_g)
    for g, w in zip(got, want):
        assert g.tolist() == w.tolist()
