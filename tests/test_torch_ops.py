"""clickhouse_tpu_torch's kernels (their plain versions, on the CPU) against
the JAX reference functions they replace, on the same numpy inputs.

  K1 masked_reduce       vs Grouping.reduce of group_trivial / count_mask
  K2 dense_group_reduce  vs mxu_counts_and_sums / mxu_group_reduce
  K3 topk_smallest       vs topk_permutation / topk_permutation32
  K4 radix_sort_pairs    vs sort_permutation and group_by_sort's perm
  K5 segment_bounds      vs group_by_sort's group ids, bounds, unique keys
  K6 segment_reduce      vs seg_reduce_sorted
  K7 dense_gather_join   vs dense_gather_join
  K8 propagate_join, build/probe_join_table vs the same functions
  K9 expand_matches      vs expand_matches
  K10 prefix_match       vs _device_prefix_lut
  order_token, topk_key32 on every dtype

Integers must be bit-exact.  Float sums: rtol=1e-12, because the two sum
in different orders (pairwise in XLA, sequential partials in torch).  A
float sum over the sort grouping is held to an absolute tolerance of
n * eps * max|prefix| instead: the reference takes each group's sum as a
difference of two prefix sums over all n sorted rows, so its error scales
with the running prefix, not with the group, while K6 adds each group's
own values.
"""
import datetime
import subprocess
import sys

import jax.numpy as jnp
from jax import lax
import numpy as np
import pytest
import torch

from clickhouse_tpu.core import dtypes as jdt
from clickhouse_tpu.exprs.expr import ColVal as JColVal
from clickhouse_tpu.ops import agg_ops as jagg
from clickhouse_tpu.ops import filter_ops as jfilter
from clickhouse_tpu.ops import join_ops as jjoin
from clickhouse_tpu.ops import mxu_segsum as jmxu
from clickhouse_tpu.ops import scan_ops as jscan
from clickhouse_tpu.ops import sort_ops as jsort
from clickhouse_tpu_torch.core import dtypes as tdt
from clickhouse_tpu_torch.exprs.expr import ColVal as TColVal
from clickhouse_tpu_torch.ops import agg_ops as tagg
from clickhouse_tpu_torch.ops import filter_ops as tfilter
from clickhouse_tpu_torch.ops import join_ops as tjoin
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
        if kt.u64src:                  # __ull2double_rn: rounded once
            d = x.view(U).astype(np.float64)
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


def _np_sum_atol(x) -> float:
    """n * eps * sum(|x|) over x's finite values: a bound on the error of
    any order of summing a group of x's rows."""
    v = np.asarray(x, np.float64)
    v = v[np.isfinite(v)]
    return len(v) * np.finfo(np.float64).eps * float(np.abs(v).sum())


def _np_group_reduce(op, x, keys, valid, mask, cap_g):
    """numpy's per-group answer: the valid rows grouped by key in ascending
    key order, each group reduced over its rows where mask holds (0 for a
    group without such a row): sum (float64 for floats), max, band."""
    out = np.zeros(cap_g, np.float64 if x.dtype.kind == "f" else x.dtype)
    for slot, k in enumerate(np.unique(keys[valid])[:cap_g]):
        rows = valid & (keys == k)
        if mask is not None:
            rows &= mask
        v = x[rows]
        if len(v):
            out[slot] = {"sum": lambda a: a.astype(np.float64).sum()
                         if a.dtype.kind == "f" else a.sum(),
                         "max": np.max,
                         "band": np.bitwise_and.reduce}[op](v)
    return out


def _reference_reduce(op, x, mask, ref_g, cap_g):
    """seg_reduce_sorted of x (raw row order) over the reference's
    grouping; op count counts the masked-in rows."""
    ones = op == "count"
    if ones:
        op, x = "sum", np.ones(len(ref_g.perm), np.int64)
    mj = None if mask is None else ref_g.take(jnp.asarray(mask))
    return np.asarray(jscan.seg_reduce_sorted(
        op, ref_g.take(jnp.asarray(x)), ref_g.group_ids, ref_g.boundary,
        ref_g.starts, ref_g.ends, cap_g, mask_sorted=mj))


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
            got = tscan.segment_reduce(op, _t(x), None if m is None
                                       else _t(m), got_g.perm, gid, cap_g,
                                       unsigned=name == "uint64")
            if op == "sum" and d.kind == "f":
                # the reference's prefix difference turns every group after
                # a NaN into NaN (DIVERGENCES["float_sum_nan"]): held to
                # numpy's per-group sums instead
                want = _np_group_reduce("sum", x, keys[0], valid, m, cap_g)
                g = got.numpy()
                assert np.isnan(g).tolist() == np.isnan(want).tolist()
                ok = ~np.isnan(want)
                np.testing.assert_allclose(g[ok], want[ok], rtol=0,
                                           atol=_np_sum_atol(x))
                continue
            if op == "band" and name == "bool" and m is not None:
                # the reference's band identity for masked-out bool rows
                # is False (DIVERGENCES["bool_band_identity"]): numpy's
                want = _np_group_reduce("band", x, keys[0], valid, m, cap_g)
            else:
                want = _reference_reduce(op, x, m, ref_g, cap_g)
            _same(got, want)
    cnt = tscan.segment_reduce("count", None, _t(valid), got_g.perm, gid,
                               cap_g)
    assert cnt.tolist() == (got_g.ends - got_g.starts).tolist()


def test_radix_sort_pass_plan(monkeypatch):
    """K4 sorts only the bits that vary, in even digits: x's 20 bits plus
    the invalid flag take three 7-bit passes, and Q2b's scan rows (every
    row below the row count valid) the 20 bits alone, also in three; Q2m's
    18-bit intDiv(x, 4) three of 6 bits.  Every plan fits the kernel: at
    most 8-bit digits, 4 passes of a u32 key and 8 of a u64 key."""
    assert tsort.sort_pass_plan(21) == (3, 7)
    assert tsort.sort_pass_plan(20) == (3, 7)
    assert tsort.sort_pass_plan(18) == (3, 6)
    assert tsort.sort_pass_plan(32) == (4, 8)
    assert tsort.sort_pass_plan(64) == (8, 8)
    assert tsort.sort_pass_plan(0) == (1, 1)
    for bits in range(65):
        passes, digit = tsort.sort_pass_plan(bits)
        assert 1 <= digit <= 8 and passes * digit >= bits
        assert passes <= (4 if bits <= 32 else 8)
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


def test_sort_rows_bytes_counts_k4_scratch():
    """The sort's working set counts K4's scratch: the passes x radix
    histogram, a tile counter a pass and one 8-byte look-back status word
    a (tile, digit), 8,192-row tiles of u32 keys and 4,096 of u64."""
    n = 100_000_000
    hist = (3 * 128 + 3) * 4 + 4                      # padded to 8 bytes
    status = -(-n // 8192) * 128 * 8
    assert tsort.k4_scratch_bytes(n, 4, 20) == hist + status == 12_502_544
    # Q2b: the packed u32 key; K4's two key and row id buffers
    assert tsort.sort_rows_bytes(n, [20]) == n * 4 + n * 2 * 8 \
        + tsort.k4_scratch_bytes(n, 4, 20)
    # a chain: a u64 key of 8 passes, then a u32 key of one
    u64 = n * (2 * 12) + tsort.k4_scratch_bytes(n, 8, 64)
    u32 = n * (8 + 8) + tsort.k4_scratch_bytes(n, 4, 5)
    assert tsort.k4_scratch_bytes(n, 8, 64) == \
        (8 * 256 + 8) * 4 + -(-n // 4096) * 256 * 8
    assert tsort.sort_rows_bytes(n, [64, 5]) == n * 12 + max(u64, u32)


def test_sort_grouping_counts_packing_and_k5():
    """The sort grouping's working set counts the packing of its keys
    beside K4 (where it is the larger), and K5's group ids, slots and
    look-back scratch: a status word a 4,096-row tile, with up to three
    rows of a misaligned head, and the tile counter; five key arrays fold
    the tail into group ids of their own."""
    n, cap_g = 100_000_000, 2_097_152
    assert tscan.k5_scratch_bytes(n) == (-(-(n + 3) // 4096) + 1) * 8
    assert tscan.k5_scratch_bytes(4093) == 16
    assert tscan.k5_scratch_bytes(4094) == 24
    k5 = 4 * n + 16 * cap_g + 8 + tscan.k5_scratch_bytes(n)
    assert tscan.segment_bounds_bytes(n, cap_g, 2) == k5
    assert tscan.segment_bounds_bytes(n, cap_g, 5) == \
        k5 + 4 * n + tscan.k5_scratch_bytes(n) + 24
    # one packed u32 key whose packing (28 bytes a row) outweighs K4's 16
    assert tsort.sort_rows_bytes(n, [20], 28) == n * 4 + n * 28
    key = tsort.SortKey(torch.zeros(4, dtype=torch.float64))
    assert tsort._pack_bytes([tsort._Field(key, 0, 20)]) == 4 + 33
    narrow = tsort.SortKey(torch.zeros(4, dtype=torch.int32), bounds=(0, 9))
    assert tsort._pack_bytes([tsort._Field(narrow, 1 << 63, 4)]) == 4 + 8


# -- K6 with several specs a launch -------------------------------------------

def _many_specs(rng, name, n):
    """(op, values, mask) lists over the dtype under test and an int64
    column, two masks, None and an all-false mask, as numpy."""
    d = np.dtype(name)
    x = _key_values(rng, name, n) if d.kind != "f" else _values(rng, name, n)
    y = _key_values(rng, "int64", n)
    m1, m2, none = rng.random(n) < 0.3, rng.random(n) < 0.7, np.zeros(n, bool)
    specs = [("sum", x, None), ("min", x, m1), ("max", x, m2),
             ("any", x, none), ("count", None, m1), ("sum", y, m2),
             ("max", y, None), ("any", y, m1), ("count", None, None)]
    if d.kind != "f":
        specs += [("bxor", x, None), ("band", y, m1)]
    return specs


@pytest.mark.parametrize("name", NP_DTYPES)
def test_segment_reduce_many_matches_reference(name):
    """K6's multi-spec entry (plain version) against seg_reduce_sorted over
    the reference's grouping: one column under several ops, two columns,
    two masks, no mask and an all-false mask, counts; with and without the
    grouping's row counts."""
    rng = np.random.default_rng(len(name) + 17)
    n, cap_g = 3000, 1024
    keys = [rng.integers(0, 300, n)]
    valid = rng.random(n) < 0.9
    ref_g, got_g = _groupings(keys, valid, cap_g)
    specs = _many_specs(rng, name, n)
    wants = [_reference_reduce(op, x, m, ref_g, cap_g) for op, x, m in specs]
    uns = name == "uint64"
    for group_rows in (None, got_g.ends - got_g.starts):
        got = tscan.segment_reduce_many(
            [(op, None if x is None else _t(x), None if m is None else _t(m),
              uns and x is not None and x.dtype == np.uint64)
             for op, x, m in specs], got_g.perm, got_g.group_ids, cap_g,
            group_rows=group_rows)
        assert len(got) == len(specs)
        for (op, x, m), g, want in zip(specs, got, wants):
            if op == "sum" and x.dtype.kind == "f":
                np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                           atol=_sum_atol(x, ref_g, m))
            else:
                _same(g, want)


def test_k6_launch_plan():
    """K6's launches: every reduction of Q2m in one launch reading one
    column in two forms (its value for the sum, its order key for min and
    max; `any` reads none) and keeping no count where the grouping's row
    counts are given; shared masks counted once; more specs, columns,
    forms or masks than one launch takes split into more."""
    x, y = torch.arange(10), torch.arange(10, dtype=torch.int32)
    m1, m2 = torch.ones(10, dtype=torch.bool), torch.zeros(10, dtype=torch.bool)
    q2m = [(op, x, None, False) for op in ("sum", "min", "max", "any")]
    launches, where = tscan._plan_launches(q2m, True)
    assert len(launches) == 1
    assert [t is x for t in launches[0].data] == [True]
    assert launches[0].counts == [] and launches[0].masks == []
    assert [f for _, f, _ in launches[0].specs] == [0, 1, 1, -1]
    assert launches[0].forms == [(0, tscan._INT, 0, 0, False),
                                 (0, tscan._KEY, 0, 0, False)]
    assert where == [(0, 0, -1), (0, 1, -1), (0, 2, -1), (0, 3, -1)]
    # no group_rows: min, max and any share one count of every row
    launches, where = tscan._plan_launches(q2m, False)
    assert launches[0].counts == [-1]
    assert [c for _, _, c in where] == [-1, 0, 0, 0]
    # counts: over every row from group_rows (no launch), one a mask
    specs = [("count", None, None, False), ("count", None, m1, False),
             ("min", y, m1, False), ("max", x[:10], m2, False)]
    launches, where = tscan._plan_launches(specs, True)
    assert where[0] == (-1, -1, -1)
    assert len(launches) == 1 and launches[0].counts == [0, 1]
    assert len(launches[0].data) == 2 and len(launches[0].masks) == 2
    # splits: nine reductions; five columns; five masks
    many = [("sum", x, None, False)] * 9
    assert [len(la.specs) for la in tscan._plan_launches(many, True)[0]] \
        == [8, 1]
    cols = [("sum", torch.arange(10) + i, None, False) for i in range(5)]
    assert [len(la.data) for la in tscan._plan_launches(cols, True)[0]] \
        == [4, 1]
    masks = [("sum", x, torch.rand(10) < 0.5, False) for _ in range(5)]
    assert [len(la.masks) for la in tscan._plan_launches(masks, True)[0]] \
        == [4, 1]
    forms = [(op, torch.arange(10) + i, None, False) for i in range(3)
             for op in ("sum", "min")]
    assert [len(la.forms) for la in tscan._plan_launches(forms, True)[0]] \
        == [4, 2]


# K6's Term divisors, as chip_smoke.K6_TERM_DIVISORS: 2, 7, 1024 where it
# fits, -3 and each storage type's MAX and MIN
_TERM_DIVISORS = {np.int8: (2, 7, -3, 127, -128),
                  np.int16: (2, 7, 1024, -3, 32767, -32768),
                  np.int32: (2, 7, 1024, -3, (1 << 31) - 1, -(1 << 31))}


def _term_values(st, rng):
    """Every int8 and int16 value; for int32 a sample with the edges."""
    info = np.iinfo(st)
    if st != np.int32:
        return np.arange(info.min, info.max + 1, dtype=st)
    v = rng.integers(info.min, info.max, 200_000, endpoint=True)
    edges = [info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max]
    return np.concatenate([np.asarray(edges), v]).astype(st)


def _term32(v, c, op):
    """csrc/segment_reduce.cu apply_term, step for step in numpy: |v| and
    |c| as u32, the quotient by the host's multiplier (one multiply-high
    and two shifts), the sign put back in u32 arithmetic."""
    from clickhouse_tpu_torch.ops.calendar_ops import magic
    v = v.astype(np.int64)
    a = np.where(v < 0, -v, v).astype(np.uint64)           # <= 2^31
    d = abs(c)
    m, l = magic(d, 32)
    s1, s2 = min(l, 1), max(l - 1, 0)
    t = (np.uint64(m) * a) >> np.uint64(32)
    q = ((t + ((a - t) >> np.uint64(s1))) >> np.uint64(s2)) & 0xFFFFFFFF
    assert int(q.max(initial=0)) < 1 << 32
    mask = np.uint64(0xFFFFFFFF)
    if op == "div":
        neg = (v < 0) != (c < 0)
        r = np.where(neg, (np.uint64(1 << 32) - q) & mask, q)
    else:
        rem = (a - q * np.uint64(d)) & mask
        r = np.where(v < 0, (np.uint64(1 << 32) - rem) & mask, rem)
    return r.astype(np.uint32).view(np.int32).astype(np.int64)


@pytest.mark.parametrize("st", [np.int8, np.int16, np.int32],
                         ids=["int8", "int16", "int32"])
def test_k6_term_arithmetic_mirror(st):
    """K6's in-register intDiv and modulo (the host's Granlund-Montgomery
    multiplier of |c|, u32 arithmetic), mirrored in numpy, equal
    scan_ops.Term.build (torch's truncating division and fmod) and the
    reference's intDiv/modulo over the widened values, for every int8 and
    int16 value, sampled int32 values with MIN and MAX, and every divisor
    of _TERM_DIVISORS."""
    rng = np.random.default_rng(40)
    v = _term_values(st, rng)
    src = torch.from_numpy(v)
    for c in _TERM_DIVISORS[st]:
        for op in ("div", "mod"):
            want = tscan.Term(src, op, c, torch.int64).build().numpy()
            assert np.array_equal(_term32(v, c, op), want), (c, op)
            w = jnp.asarray(v.astype(np.int64))
            cw = jnp.asarray(c, dtype=jnp.int64)
            ref = np.asarray(lax.div(w, cw) if op == "div"
                             else lax.rem(w, cw))
            assert np.array_equal(ref, want), (c, op)


def test_k6_term_is_its_built_column():
    """A Term spec reduces as its built column: every op, through both of
    K6's entries' plain versions, with a mask; Term.index_select gathers the
    source and widens; the same term twice is one spec key and one form;
    a divisor outside the storage type, 0 or -1 raises."""
    rng = np.random.default_rng(41)
    n, cap_g = 5000, 64
    src = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n)
                           .astype(np.int32))
    src[0] = -(1 << 31)
    key = np.sort(rng.integers(0, 40, n))
    gid = torch.from_numpy(key.astype(np.int32))
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    m = torch.from_numpy(rng.random(n) < 0.6)
    starts, ends = tscan.bounds_of_gid(gid, cap_g)
    for op_name, c in (("mod", 7), ("div", -3), ("mod", 1024)):
        t = tscan.Term(src, op_name, c, torch.int64)
        col = t.build()
        for op in ("sum", "min", "max", "any", "bxor", "band", "bor"):
            got = tscan.segment_reduce_many([(op, t, m, False)], perm, gid,
                                            cap_g)[0]
            want = tscan.segment_reduce_many([(op, col, m, False)], perm,
                                             gid, cap_g)[0]
            assert torch.equal(got, want), (op, op_name, c)
            got = tscan.segment_reduce_sorted([(op, t, m, False)], starts,
                                              ends, n)[0]
            want = tscan._segment_reduce_plain(op, col, m, None, gid, cap_g,
                                               False)
            assert torch.equal(got, want), (op, op_name, c)
        f = tscan.segment_reduce_many(
            [("fsumx", (src, t, 1), None, (False, False))], perm, gid,
            cap_g)[0]
        assert torch.equal(f, tscan.segment_reduce_many(
            [("fsumx", (src, col, 1), None, (False, False))], perm, gid,
            cap_g)[0])
        idx = torch.from_numpy(rng.integers(0, n, 300))
        assert torch.equal(t.index_select(0, idx), col[idx])
    t1 = tscan.Term(src, "mod", 7, torch.int64)
    t2 = tscan.Term(src, "mod", 7, torch.int64)
    assert tscan.spec_key(("max", t1, None, False)) \
        == tscan.spec_key(("max", t2, None, False))
    la, _ = tscan._plan_launches([("max", t1, None, False),
                                  ("max", t2, m, False)], True)
    assert len(la) == 1 and len(la[0].data) == 1 and len(la[0].forms) == 1
    for bad in (0, -1, 1 << 31):
        with pytest.raises(ValueError):
            tscan.Term(src, "mod", bad, torch.int64)
    with pytest.raises(ValueError):
        tscan.Term(src.to(torch.int64), "mod", 7, torch.int64)


def test_k6_plan_q2s2_one_launch_one_source():
    """Q2s2's seven reductions (max of x % 7, the statistics' terms of x
    and x % 7, bxor of x) and its count: ONE launch with ONE source column
    (x's int32 storage) in four forms (x's double and value, x % 7's key
    and double), the two x % 7 Terms one."""
    x = torch.arange(-500, 500, dtype=torch.int32)
    a = tscan.Term(x, "mod", 7, torch.int64)     # argMax's x % 7
    b = tscan.Term(x, "mod", 7, torch.int64)     # corr's x % 7
    specs = [("max", a, None, False),
             ("fsumx", (x, None, 1), None, (False, False)),
             ("fsumx", (x, None, 2), None, (False, False)),
             ("fsumx", (x, b, 1), None, (False, False)),
             ("fsumx", (b, None, 1), None, (False, False)),
             ("fsumx", (b, None, 2), None, (False, False)),
             ("bxor", x, None, False), ("count", None, None, False)]
    la, where = tscan._plan_launches([tscan._checked_spec(sp)
                                      for sp in specs], True)
    assert len(la) == 1 and len(la[0].data) == 1 and la[0].data[0] is x
    assert len(la[0].specs) == 7 and la[0].counts == []
    assert sorted(la[0].forms) == sorted([
        (0, tscan._KEY, 2, 7, False), (0, tscan._DBL, 0, 0, False),
        (0, tscan._DBL, 2, 7, False), (0, tscan._INT, 0, 0, False)])
    assert where[-1] == (-1, -1, -1)


def _layout_gid(name, rng):
    """(sorted group ids, cap_g) of a sorted-entry layout: rows without a
    slot carry cap_g or more and come last."""
    if name == "one_row_groups":
        return np.arange(3000), 4096
    if name == "empty_slots":                    # slots past the groups
        return np.sort(rng.integers(0, 50, 4000)), 200
    if name == "more_groups_than_slots":         # the rest have no slot
        return np.sort(rng.integers(0, 900, 5000)), 300
    if name == "group_over_many_tiles":          # 40 % in one group
        k = rng.integers(0, 30, 30_000)
        k[rng.random(30_000) < 0.4] = 11
        return np.sort(k), 64
    k = np.sort(rng.integers(0, 80, 6000))       # invalid rows last
    k[-700:] = 1 << 20
    return k, 128


# bounds that break the sorted entry's layout: (starts, ends, n)
_BAD_BOUNDS = {
    "gap_between_groups": ([0, 5, 9], [4, 9, 12], 12),
    "first_group_after_row_0": ([2, 5, 9], [5, 9, 12], 12),
    "end_before_start": ([0, 5, 9], [5, 9, 7], 12),
    "past_the_rows": ([0, 5, 9], [5, 9, 14], 12),
}


@pytest.mark.parametrize("case", sorted(_BAD_BOUNDS))
def test_sorted_entry_rejects_bounds_with_a_gap(case):
    """The sorted-order entry's plain version and gid_of_bounds raise for
    bounds that are not K5's layout (the kernel would credit a gap's rows
    to the group before it); K5's own bounds pass."""
    s, e, n = _BAD_BOUNDS[case]
    starts, ends = torch.tensor(s), torch.tensor(e)
    x = torch.arange(n, dtype=torch.int64)
    with pytest.raises(ValueError, match="no gap"):
        tscan.gid_of_bounds(starts, ends, n)
    with pytest.raises(ValueError, match="no gap"):
        tscan.segment_reduce_sorted([("sum", x, None, False)], starts, ends,
                                    n)
    ok = torch.tensor([0, 5, 9]), torch.tensor([5, 9, 11])
    got = tscan.segment_reduce_sorted([("sum", x, None, False)], *ok, n)[0]
    assert got.tolist() == [10, 26, 19]


@pytest.mark.parametrize("gid", [[0, 0, 3, 1, 1], [0, 9, 1, 1, 9]],
                         ids=["descending", "no_slot_before_a_group"])
def test_bounds_of_gid_rejects_unsorted_group_ids(gid):
    """bounds_of_gid takes ascending group ids with the rows without a slot
    (cap_g or more) last, and raises otherwise."""
    with pytest.raises(ValueError, match="ascend"):
        tscan.bounds_of_gid(torch.tensor(gid, dtype=torch.int32), 4)


@pytest.mark.parametrize("layout", ["one_row_groups", "empty_slots",
                                    "more_groups_than_slots",
                                    "group_over_many_tiles",
                                    "invalid_rows"])
def test_sorted_entry_bounds_form_equals_gid_form(layout):
    """K6's sorted-order entry from K5's bounds (starts/ends: its plain
    version's group of each row by gid_of_bounds) equals its group-id
    form, for every op with and without a mask; the bounds come from K5's
    plain version over the sorted keys and from bounds_of_gid alike, and
    gid_of_bounds gives K5's group ids back (cap_g where there is no
    slot)."""
    rng = np.random.default_rng(42)
    key, cap_g = _layout_gid(layout, rng)
    n = len(key)
    n_valid = int((key < (1 << 20)).sum())
    kt = torch.from_numpy(key.astype(np.int32))
    gid, _, starts, ends = tscan._segment_bounds_plain(
        [kt], torch.tensor(n_valid), cap_g)
    gid = torch.where(gid >= cap_g, cap_g, gid).to(torch.int32)
    s2, e2 = tscan.bounds_of_gid(gid, cap_g)
    assert torch.equal(s2, starts) and torch.equal(e2, ends)
    assert torch.equal(tscan.gid_of_bounds(starts, ends, n), gid)
    x = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n))
    f = torch.from_numpy(rng.normal(0, 1e3, n))
    m = torch.from_numpy(rng.random(n) < 0.5)
    specs = [(op, d, mm, False) for mm in (None, m)
             for op, d in (("sum", x), ("min", x), ("max", f), ("any", x),
                           ("bxor", x), ("sum", f), ("count", None))]
    got = tscan.segment_reduce_sorted(specs, starts, ends, n,
                                      group_rows=ends - starts)
    for (op, d, mm, u), g in zip(specs, got):
        want = tscan._segment_reduce_plain(op, d, mm, None, gid, cap_g, u)
        assert torch.equal(g, want) or (
            g.is_floating_point() and torch.allclose(
                g, want, rtol=1e-12, atol=0, equal_nan=True)), (op, layout)


# -- reference divergences (ROADMAP queue 3) -----------------------------------
# Each case's runner gives (the port's answer, the reference's, the answer
# the port must give, the right answer), where an answer may be the name of
# the error raised.  The port gives its answer; the reference gives
# neither it nor the right one.
_M = np.iinfo(np.int64).max


def _reduce_divergence(op, x, mask, want):
    """op over the groups of keys 0, 0, 1, 1, 2, 2 in both engines."""
    keys = np.array([0, 0, 1, 1, 2, 2])
    valid = np.ones(6, bool)
    ref_g, got_g = _groupings([keys], valid, 8)
    got = tscan.segment_reduce(op, _t(x), None if mask is None else _t(mask),
                               got_g.perm, got_g.group_ids, 8)
    ref = _reference_reduce(op, x, mask, ref_g, 8)[:3]
    return got.numpy()[:3], ref, want, want


_SQL_SESSIONS = []


def _sql_sessions():
    """One reference and one port session (CPU) over the divergence
    tables: u (S1: 70,000 values 'v%06d' and one value of 73 bytes ending
    'xyz'), p (S2: rows (s, u)), g (S4: a String key b, c, b, d) and h
    (S5, S6: 20,000 rows of x)."""
    if not _SQL_SESSIONS:
        import clickhouse_tpu as jch
        import clickhouse_tpu_torch as tch
        from clickhouse_tpu_torch.interop import table_from_numpy
        js, ts = jch.connect(), tch.connect(device="cpu")
        u = np.array([f"v{i:06d}" for i in range(70000)]
                     + ["A" * 70 + "xyz"], dtype=object)
        x = (np.arange(20000, dtype=np.int64) * 2654435761) % 1_000_003
        tables = {
            "u": ({"u": u}, {"u": "String"}),
            "p": ({"s": np.array(["ab", "b", "ba", "c"], dtype=object),
                   "u": np.array(["a", "b", "b", "x"], dtype=object)},
                  {"s": "String", "u": "String"}),
            "g": ({"s": np.array(["b", "c", "b", "d"], dtype=object)},
                  {"s": "String"}),
            "h": ({"x": x}, {"x": "Int64"})}
        for name, (cols, types) in tables.items():
            js.execute(f"CREATE TABLE {name} ("
                       + ", ".join(f"{c} {t}" for c, t in types.items())
                       + ")")
            js.insert_pydict(name, cols)
            table_from_numpy(ts, name, cols, types)
        # R1, R3: MergeTree-family tables read with FINAL; R2: WITH FILL
        # beside a String column
        keys = np.arange(3000, dtype=np.int64)
        for s in (js, ts):
            s.execute("CREATE TABLE rv (k UInt32, v UInt32, p Int64) "
                      "ENGINE = ReplacingMergeTree(v) ORDER BY k")
            s.execute("INSERT INTO rv VALUES (1, 5, 100), (2, 1, 200)")
            s.execute("INSERT INTO rv VALUES (1, 3, 101), (2, 2, 201)")
            s.execute("CREATE TABLE rm (k Int64, v Int64) "
                      "ENGINE = ReplacingMergeTree ORDER BY k")
            s.insert_pydict("rm", {"k": keys, "v": keys})
            s.insert_pydict("rm", {"k": keys[::2], "v": keys[::2] + 1})
            s.execute("CREATE TABLE fs (a Int64, s String)")
            s.execute("INSERT INTO fs VALUES (1, 'x'), (3, 'w')")
            # M1, A8: states of groups, one with no row passing v > 4
            s.execute("CREATE TABLE ms (k Int64, v Int64)")
            s.execute("INSERT INTO ms VALUES (1, 5), (1, 7), (2, 3), (3, 6)")
            # A2, A3, A9: the aggregate tail's weighted quantiles and moving
            # sums over a few rows
            s.execute("CREATE TABLE tl (k Int64, x Int64, w UInt8, "
                      "big Int64)")
            s.execute("INSERT INTO tl VALUES (1, 1, 1, 9007199254740993), "
                      "(1, 2, 1, 1), (1, 3, 10, 0), (2, 5, 2, 7), "
                      "(2, 4, 3, 0)")
        # A11: deltaSum over UInt64 values above 2^63, in row order
        for s in (js, ts):
            s.execute("CREATE TABLE tu (u UInt64)")
            s.insert_pydict("tu", {"u": np.array([1, (1 << 63) + 5, 3],
                                                 np.uint64)})
        # A7: the tail's run counts under a mask, over seeded rows
        tr = _tail_rows()
        js.execute("CREATE TABLE tr (k Int64, a Int64, b Int64, w Int64, "
                   "c Int64)")
        js.insert_pydict("tr", tr)
        table_from_numpy(ts, "tr", tr, {c: "Int64" for c in tr})
        _SQL_SESSIONS.extend([js, ts, x])
    return _SQL_SESSIONS


def _tail_rows():
    """tr: 600 seeded rows, six keys, small a and b, weights and a
    condition column."""
    rng = np.random.default_rng(7)
    n = 600
    return {"k": rng.integers(0, 6, n), "a": rng.integers(0, 5, n),
            "b": rng.integers(0, 4, n), "w": rng.integers(1, 9, n),
            "c": rng.integers(-3, 4, n)}


def _tail_groups():
    """tr's rows with c > 0, a key at a time."""
    t = _tail_rows()
    return t, [np.flatnonzero((t["k"] == k) & (t["c"] > 0))
               for k in range(6)]


def _a7_topk_weighted():
    t, groups = _tail_groups()
    want = []
    for k, rows in enumerate(groups):
        vals, inv = np.unique(t["a"][rows], return_inverse=True)
        sums = np.bincount(inv, weights=t["w"][rows]).astype(np.int64)
        want.append((k, [int(v) for v in vals[np.lexsort((vals, -sums))][:2]]))
    return _sql_divergence("SELECT k, topKWeightedIf(2)(a, w, c > 0) FROM tr "
                           "GROUP BY k ORDER BY k", want)


def _a7_cramers_v():
    t, groups = _tail_groups()
    want = []
    for k, rows in enumerate(groups):
        a, b = t["a"][rows], t["b"][rows]
        ua, ia = np.unique(a, return_inverse=True)
        ub, ib = np.unique(b, return_inverse=True)
        nab = np.zeros((len(ua), len(ub)))
        np.add.at(nab, (ia, ib), 1.0)
        e = np.outer(nab.sum(1), nab.sum(0))
        chi2 = len(a) * max(float((nab[nab > 0] ** 2 / e[nab > 0]).sum())
                            - 1.0, 0.0)
        want.append((k, round(float(np.sqrt(
            chi2 / (len(a) * max(min(len(ua), len(ub)) - 1, 1)))), 9)))
    return _sql_divergence("SELECT k, round(cramersVIf(a, b, c > 0), 9) "
                           "FROM tr GROUP BY k ORDER BY k", want)


def _a7_rank_corr():
    t, groups = _tail_groups()

    def ranks(v):
        s = np.sort(v)
        return (np.searchsorted(s, v) + np.searchsorted(s, v, "right")
                - 1) / 2.0 + 1.0
    want = []
    for k, rows in enumerate(groups):
        rx, ry = ranks(t["a"][rows]), ranks(t["b"][rows])
        want.append((k, round(float(np.corrcoef(rx, ry)[0, 1]), 9)))
    return _sql_divergence("SELECT k, round(rankCorrIf(a, b, c > 0), 9) "
                           "FROM tr GROUP BY k ORDER BY k", want)


def _answer(session, sql, read=lambda r: r.rows()):
    """The rows of sql (read from its Result), or the name of the error."""
    try:
        return read(session.execute(sql))
    except Exception as e:           # the error is the engine's answer
        return type(e).__name__.rstrip("_")


def _sql_divergence(sql, want, right=None, read=lambda r: r.rows()):
    js, ts = _sql_sessions()[:2]
    return (_answer(ts, sql, read), _answer(js, sql, read), want,
            want if right is None else right)


def _s5():
    x = _sql_sessions()[2]
    n = int(np.minimum(np.bincount(x // 4), 2).sum())
    return _sql_divergence("SELECT count() FROM (SELECT x FROM h "
                           "LIMIT 2 BY intDiv(x, 4))", [(n,)])


def _s6():
    r = _sql_sessions()[2] % 3000
    want = [(int(r[i]),) for i in sorted(np.unique(r, return_index=True)[1])]
    return _sql_divergence("SELECT x % 3000 AS r FROM h LIMIT 1 BY r "
                           "SETTINGS max_groups = 1024", want)


def _w1():
    """W1: sum(x) over P's default frame and over ROWS BETWEEN 1 PRECEDING
    AND CURRENT ROW, P = PARTITION BY x % 16 ORDER BY x (h's x are
    distinct): numpy's sums of the two columns."""
    x = _sql_sessions()[2]
    o = np.lexsort((x, x % 16))
    xs, part = x[o], x[o] % 16
    start = np.r_[True, part[1:] != part[:-1]]
    run = np.cumsum(xs) - np.repeat(np.r_[0, np.cumsum(xs)][
        np.flatnonzero(start)], np.diff(np.r_[np.flatnonzero(start),
                                              len(xs)]))
    pair = xs + np.where(start, 0, np.r_[0, xs[:-1]])
    return _sql_divergence(
        "SELECT sum(a), sum(b) FROM (SELECT sum(x) OVER (PARTITION BY x % "
        "16 ORDER BY x) AS a, sum(x) OVER (PARTITION BY x % 16 ORDER BY x "
        "ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) AS b FROM h)",
        [(int(run.sum()), int(pair.sum()))])


def _s7_want():
    """concat('y', s, '-', s, u) over table p, row by row in numpy."""
    s = np.array(["ab", "b", "ba", "c"])
    u = np.array(["a", "b", "b", "x"])
    got = np.char.add(np.char.add(np.char.add(np.char.add("y", s), "-"), s),
                      u)
    return [(str(v),) for v in got]


DIVERGENCES = {
    # a NaN in group 0 turns every later group's sum into NaN
    "float_sum_nan": (lambda: _reduce_divergence(
        "sum", np.array([1.0, np.nan, 2.0, 3.0, 4.0, 0.5]), None,
        np.array([np.nan, 5.0, 4.5])),
        "clickhouse_tpu/ops/scan_ops.py:179-182"),
    # INT64_MAX and INT64_MAX - 1 share one clamped order token under a
    # mask, and the later row wins
    "int64_max_tie": (lambda: _reduce_divergence(
        "max", np.array([_M, _M - 1, 5, 6, 1, 2], np.int64),
        np.ones(6, bool), np.array([_M, 6, 2], np.int64)),
        "clickhouse_tpu/ops/sort_ops.py:59"),
    # a masked-out bool row takes False, not True, as band's identity
    "bool_band_identity": (lambda: _reduce_divergence(
        "band", np.array([1, 1, 1, 0, 1, 1], bool),
        np.array([1, 0, 1, 1, 0, 0], bool), np.array([True, False, False])),
        "clickhouse_tpu/ops/scan_ops.py:224-227"),
    # S1: the device byte matrix truncates values to 64 bytes, and the
    # suffix of a longer value is read from the truncated bytes
    "s1_endswith_past_64_bytes": (lambda: _sql_divergence(
        "SELECT count() FROM u WHERE endsWith(u, 'xyz')", [(1,)]),
        "clickhouse_tpu/core/column.py:65,123,128,141-145"),
    "s1_like_suffix_past_64_bytes": (lambda: _sql_divergence(
        "SELECT count() FROM u WHERE u LIKE '%xyz'", [(1,)]),
        "clickhouse_tpu/core/column.py:65,123,128,141-145"),
    # S2: a needle column is replaced by its first dictionary value; the
    # port refuses a needle that is not a constant, as LIKE does
    "s2_needle_column": (lambda: _sql_divergence(
        "SELECT startsWith(s, u) FROM p", "TypeError",
        [(1,), (1,), (1,), (0,)]),
        "clickhouse_tpu/exprs/functions.py:1405"),
    # S3: cityHash64 of a String hashes its dictionary code, not its
    # bytes; the port refuses until the byte hashes are ported
    "s3_city_hash_of_a_string": (lambda: _sql_divergence(
        "SELECT cityHash64(s) FROM g", "NotImplementedError"),
        "clickhouse_tpu/exprs/functions.py:1496-1507"),
    # S4: the totals row shows a String key as its dictionary's first
    # value, not the type's default ''
    "s4_totals_string_key": (lambda: _sql_divergence(
        "SELECT s, count() FROM g GROUP BY s WITH TOTALS", [("", 4)],
        read=lambda r: list(zip(*[list(v) for v in r.totals.values()]))),
        "clickhouse_tpu/exec/executor.py:547-551"),
    # S5: a LIMIT BY key that is an expression over an unselected column is
    # bound below the projection, whose block no longer holds the column
    "s5_limit_by_unselected_expression": (
        _s5, "clickhouse_tpu/plan/analyzer.py (LIMIT BY keys)"),
    # S6: LIMIT BY past max_groups has no capacity check: the groups past
    # the slots share the last slot's rank (the port retries with more)
    "s6_limit_by_past_max_groups": (
        _s6, "clickhouse_tpu/exec/executor.py:1337-1351"),
    # S7: concat of a constant and two or more columns takes the product
    # of the columns' dictionaries and drops every constant argument
    "s7_concat_drops_constants": (lambda: _sql_divergence(
        "SELECT concat('y', s, '-', s, u) FROM p", _s7_want()),
        "clickhouse_tpu/exprs/functions.py:1452-1487"),
    # D1: dateTrunc's year, quarter, month and week units hand a DateTime
    # to a toStartOf* that returns days, read back as seconds; a Date's
    # day, hour, minute and second units return seconds as days
    "d1_date_trunc_datetime_month": (lambda: _sql_divergence(
        "SELECT dateTrunc('month', toDateTime('2013-07-15 10:00:00'))",
        [(datetime.datetime(2013, 7, 1),)]),
        "clickhouse_tpu/exprs/functions_ext.py:627-643"),
    "d1_date_trunc_date_day": (lambda: _sql_divergence(
        "SELECT date_trunc('day', toDate('2013-07-15'))",
        [(datetime.date(2013, 7, 15),)]),
        "clickhouse_tpu/exprs/functions_ext.py:627-643"),
    # D2: the functions of the time of day read a Date's day number as
    # seconds (ClickHouse refuses a Date there); toUnixTimestamp(Date)
    # gives the day number, not the midnight's seconds
    "d2_to_hour_of_a_date": (lambda: _sql_divergence(
        "SELECT toHour(toDate('2013-07-15'))", "TypeError", "TypeError"),
        "clickhouse_tpu/exprs/functions.py:1093-1107"),
    "d2_unix_timestamp_of_a_date": (lambda: _sql_divergence(
        "SELECT toUnixTimestamp(toDate('2013-07-15'))", [(1373846400,)]),
        "clickhouse_tpu/exprs/functions.py:1111-1113"),
    # D3: a Date plus an interval below a day adds 0 days (hours,
    # minutes, seconds) or n // 10^k days (the sub-second units); ClickHouse
    # makes a DateTime of it, which the port does not port yet
    "d3_date_plus_hours": (lambda: _sql_divergence(
        "SELECT toDate('2013-07-15') + INTERVAL 25 HOUR",
        "NotImplementedError", [(datetime.datetime(2013, 7, 16, 1),)]),
        "clickhouse_tpu/exprs/functions.py:207-222"),
    # D4: DateTime - Date subtracts a day number from seconds (ClickHouse
    # refuses the pair)
    "d4_datetime_minus_date": (lambda: _sql_divergence(
        "SELECT toDateTime('2013-07-15 10:00:00') - toDate('2013-07-15')",
        "TypeError", "TypeError"),
        "clickhouse_tpu/exprs/functions.py:290-296"),
    # D5: roundDown reads the array's zero padding as boundaries
    "d5_round_down_padding": (lambda: _sql_divergence(
        "SELECT roundDown(7, [1, 5, 10])", [(5.0,)]),
        "clickhouse_tpu/exprs/functions_ext5.py:120-134"),
    # D6: the week of toStartOfWeek / toLastDayOfWeek starts on a Monday;
    # ClickHouse's default mode 0 starts it on a Sunday
    "d6_start_of_week_mode_0": (lambda: _sql_divergence(
        "SELECT toStartOfWeek(toDate('2013-07-17')), "
        "toLastDayOfWeek(toDate('2013-07-17'))",
        [(datetime.date(2013, 7, 14), datetime.date(2013, 7, 20))]),
        "clickhouse_tpu/exprs/functions.py:1156-1175, "
        "functions_ext5.py:95-103"),
    # D7: roundToExp2 takes XLA's inexact log2, which puts some powers of
    # two below their exponent
    "d7_round_to_exp2_of_a_power": (lambda: _sql_divergence(
        "SELECT roundToExp2(64)", [(64,)]),
        "clickhouse_tpu/exprs/functions_ext.py:101-107"),
    # D8: add/subtract{Milli,Micro,Nano}seconds round through float64, so
    # a step below a second vanishes at a large time (the intervals floor)
    "d8_subtract_nanoseconds": (lambda: _sql_divergence(
        "SELECT subtractNanoseconds(toDateTime('2033-05-18 03:33:20'), 13)",
        [(datetime.datetime(2033, 5, 18, 3, 33, 19),)]),
        "clickhouse_tpu/exprs/functions_ext4.py:740-758"),
    # W1: two window calls that differ only in their frame share one
    # result (the calls are keyed by a text that leaves the frame out)
    "w1_window_frame_shared": (
        _w1, "clickhouse_tpu/sql/ast.py:542-551, "
        "clickhouse_tpu/plan/analyzer.py:1270-1276, :2247-2249"),
    # D9: XLA flushes a subnormal float64 result to zero on the CPU
    "d9_subnormal_result": (lambda: _sql_divergence(
        "SELECT exp10(-311)", [(float(np.power(10.0, -311)),)]),
        "XLA's CPU float mode (flush to zero)"),
    # R1: FINAL over ReplacingMergeTree(ver) keeps each key's newest row
    # whatever its version; ClickHouse (and the reference's own merge,
    # storage/merges.py:75-76) keeps the highest version
    "r1_replacing_final_ignores_version": (lambda: _sql_divergence(
        "SELECT k, v, p FROM rv FINAL ORDER BY k",
        [(1, 5, 100), (2, 2, 201)]),
        "clickhouse_tpu/exec/executor.py:200-205"),
    # R2: WITH FILL's generated rows show a String column's dictionary
    # code 0, its first value, not the type's default ''
    "r2_fill_string_default": (lambda: _sql_divergence(
        "SELECT a, s FROM fs ORDER BY a WITH FILL",
        [(1, "x"), (2, ""), (3, "w")]),
        "clickhouse_tpu/exec/executor.py:919-921"),
    # R3: FINAL over more keys than max_groups drops the keys past its
    # slots, with no capacity check (the port re-plans with more)
    "r3_final_past_max_groups": (lambda: _sql_divergence(
        "SELECT count(), sum(v) FROM rm FINAL SETTINGS max_groups = 1024",
        [(3000, 3000 * 2999 // 2 + 1500)]),
        "clickhouse_tpu/exec/executor.py:200, :205"),
    # M1: a min state that saw no row (group 2: no v > 4) holds 0, which
    # -Merge takes as a value; ClickHouse's empty state takes no part
    "m1_min_merge_of_an_empty_state": (lambda: _sql_divergence(
        "SELECT minMerge(st) FROM (SELECT k, minStateIf(v, v > 4) AS st "
        "FROM ms GROUP BY k)", [(5,)]),
        "clickhouse_tpu/exprs/aggregates.py:1089-1092"),
    # A8: uniqMerge under GROUP BY () asserts the sort grouping
    "a8_uniq_merge_global": (lambda: _sql_divergence(
        "SELECT uniqMerge(st) FROM (SELECT k, uniqState(v) AS st FROM ms "
        "GROUP BY k)", [(4,)]),
        "clickhouse_tpu/exprs/agg_sketch.py:348"),
    # A3: quantilesExactWeighted maps to the unweighted quantiles (weights
    # 1, 1, 10 put the weighted median at 3)
    "a3_quantiles_exact_weighted": (lambda: _sql_divergence(
        "SELECT quantilesExactWeighted(0.5)(x, w) FROM tl WHERE k = 1",
        [([3],)]),
        "clickhouse_tpu/exprs/aggregates.py:874-875"),
    # A2 (weighted): quantileExactWeightedIf over a group whose rows all
    # fail the condition reads a neighbouring group's value; ClickHouse's
    # empty state gives 0
    "a2_weighted_quantile_empty_group": (lambda: _sql_divergence(
        "SELECT k, quantileExactWeightedIf(0.5)(x, w, x > 100) FROM tl "
        "GROUP BY k ORDER BY k", [(1, 0), (2, 0)]),
        "clickhouse_tpu/exprs/agg_ext.py:244-246"),
    # A9: groupArrayMovingSum(N) drops its window (ClickHouse sums the
    # last N values) ...
    "a9_moving_sum_window": (lambda: _sql_divergence(
        "SELECT groupArrayMovingSum(2)(x) FROM tl WHERE k = 1",
        [([1, 3, 5],)]),
        "clickhouse_tpu/exprs/aggregates.py:1220"),
    # ... and sums integers through float64, inexact above 2^53
    "a9_moving_sum_exact": (lambda: _sql_divergence(
        "SELECT groupArrayMovingSum(big) FROM tl WHERE k = 1",
        [([9007199254740993, 9007199254740994, 9007199254740994],)]),
        "clickhouse_tpu/exprs/agg_ext.py:728"),
    # A11: deltaSum of a UInt64 compares the values as signed int64, so a
    # rise to 2^63 + 5 reads as a fall (ClickHouse compares unsigned)
    "a11_delta_sum_uint64": (lambda: _sql_divergence(
        "SELECT deltaSum(u) FROM tu", [((1 << 63) + 4,)]),
        "clickhouse_tpu/exprs/agg_ext.py:162-196"),
    # A7 (the tail): topKWeighted, cramersV and rankCorr under a mask count
    # their runs over run ids that do not ascend (the masked-out rows take
    # the id cap between groups), so later groups' runs are miscounted
    "a7_topk_weighted_if": (
        _a7_topk_weighted, "clickhouse_tpu/exprs/agg_ext4.py:47-60"),
    "a7_cramers_v_if": (
        _a7_cramers_v, "clickhouse_tpu/exprs/agg_ext3.py:424-434"),
    "a7_rank_corr_if": (
        _a7_rank_corr, "clickhouse_tpu/exprs/agg_ext2.py:171-176"),
}


def _same_answer(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str) or isinstance(a, list):
        return a == b
    return np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("case", sorted(DIVERGENCES))
def test_port_matches_numpy_where_reference_diverges(case):
    got, _, want, _ = DIVERGENCES[case][0]()
    assert _same_answer(got, want), (got, want)


@pytest.mark.parametrize("case", sorted(DIVERGENCES))
def test_reference_divergence_is_pinned(case):
    """The reference's answer differs from the port's and from the right
    one on these inputs, for the defect DIVERGENCES names: the port does
    not bless it.  Should the reference be repaired, this test fails and
    the case joins the differential tests."""
    got, ref, want, right = DIVERGENCES[case][0]()
    assert not _same_answer(ref, want), DIVERGENCES[case][1]
    assert not _same_answer(ref, right), DIVERGENCES[case][1]
    assert not _same_answer(got, ref)


# -- K10: prefix_match ------------------------------------------------------
# The port's plain version over a dictionary's chars and offsets against
# the reference's _device_prefix_lut over its byte matrix, on a dictionary
# of 65,536 values (the bottom of the reference's device window) of at
# most 64 bytes (its matrix's width), with UTF-8, empty values and values
# that are prefixes of others.

_K10_DICTS = []


def _k10_dicts():
    if not _K10_DICTS:
        from clickhouse_tpu.core.column import Dictionary as JDictionary
        from clickhouse_tpu_torch.core.column import Dictionary as TDictionary
        rng = np.random.default_rng(41)
        pieces = np.array(["a", "b", "ab", "é", "日", "😀", "x", " "])
        vals = {"", "ab", "abé", "ab" * 32}
        while len(vals) < 65536:
            w = "".join(rng.choice(pieces, int(rng.integers(1, 14))))
            if len(w.encode()) <= 64:
                vals.add(w)
        vals = np.array(sorted(vals), dtype=object)
        _K10_DICTS.extend([JDictionary(vals, sorted_=True),
                           TDictionary(vals, sorted_=True)])
    return _K10_DICTS


K10_NEEDLES = {"empty": "", "one_byte": "a", "two_bytes": "ab",
               "utf8": "é", "whole_value": "abé", "sixty_four": "ab" * 32,
               "emoji_suffix": "😀", "miss": "zz"}


@pytest.mark.parametrize("suffix", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("needle", sorted(K10_NEEDLES))
def test_prefix_match_matches_reference(needle, suffix):
    from clickhouse_tpu.exprs.functions import _device_prefix_lut
    from clickhouse_tpu_torch.ops.string_ops import prefix_match
    jd, td = _k10_dicts()
    nd = K10_NEEDLES[needle]
    ref = np.asarray(_device_prefix_lut(jd, nd, suffix))
    chars, offsets = td.device_chars("cpu")
    got = prefix_match(chars, offsets, nd.encode(), suffix=suffix)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.uint8))
    neg = prefix_match(chars, offsets, nd.encode(), suffix=suffix,
                       negate=True)
    np.testing.assert_array_equal(neg.numpy(), 1 - ref.astype(np.uint8))


# -- K7, K8, K9: joins -------------------------------------------------------
# The observable results are compared: match flags and the matched rows'
# words, or per valid output slot the probe row and the build row it
# pairs (row_order[build_pos]), and the output count.  The reference's
# words of an unmatched row are whatever its sorts carried (the caller
# masks them); the port's are 0.


def _join_keys(rng, name, nb, n):
    """(build keys, probe keys) of one type: duplicates among the build
    keys, half the probe keys without a match; floats with -0.0, +0.0 and
    NaN."""
    if name == "float64":
        pool = np.array([0.0, -0.0, np.nan, 1.5, -2.25, 3.0, np.inf, 7.5])
        return pool[rng.integers(0, 6, nb)], pool[rng.integers(0, 8, n)]
    d = np.dtype(name)
    return (rng.integers(0, max(nb // 2, 1), nb).astype(d),
            rng.integers(0, max(nb, 1), n).astype(d))


@pytest.mark.parametrize("sentinel", [-1, 100], ids=["lo-1", "hi+1"])
@pytest.mark.parametrize("probe_type", ["int64", "int32", "int16"])
def test_dense_gather_join_matches_reference(probe_type, sentinel):
    rng = np.random.default_rng(31)
    lo, hi, nb, n = -200, 1799, 700, 5000
    bk = rng.permutation(hi - lo + 1)[:nb] + lo
    bv = rng.random(nb) < 0.9
    pk = rng.integers(lo - 100, hi + 100, n).astype(probe_type)
    pv = rng.random(n) < 0.9
    w = rng.integers(0, 100, nb).astype(np.int32)
    v = (rng.random(nb) < 0.5).astype(np.int32)
    for words in ([("word", w, sentinel)],
                  [("key",), ("word", w, sentinel), ("keyvalid",),
                   ("word", v, 2)],
                  [], [("key",), ("keyvalid",)]):
        ref = jjoin.dense_gather_join(
            jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
            jnp.asarray(pv), [(e[0], jnp.asarray(e[1]), e[2])
                              if e[0] == "word" else e for e in words],
            lo, hi)
        got = tjoin.dense_gather_join(
            _t(bk), _t(bv), _t(pk), _t(pv),
            [(e[0], _t(e[1]), e[2]) if e[0] == "word" else e
             for e in words], lo, hi)
        np.testing.assert_array_equal(got.matched.numpy(),
                                      np.asarray(ref.matched))
        for a, b in zip(got.words, ref.words):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _slot_fields(entries, layout, nb):
    """K7's table rows as csrc/dense_join.cu writes them (k_dense_build),
    emulated in numpy: (nb + 1, slot bytes) uint8, the last row the empty
    slot (k_dense_init)."""
    words, slot_bytes = layout
    slots = np.zeros((nb + 1, slot_bytes), np.uint8)
    for w in words:
        vals = np.ones(nb, np.int64) if w.entry is None \
            else entries[w.entry][1].astype(np.int64)
        mask = (1 << (8 * w.bytes)) - 1
        field = np.append((vals - w.base) & mask, w.empty).astype(np.uint64)
        for b in range(w.bytes):
            slots[:, w.offset + b] = (field >> np.uint64(8 * b)) & \
                np.uint64(0xFF)
    return slots


def _slot_value(slots, w):
    field = np.zeros(slots.shape[0], np.uint64)
    for b in range(w.bytes):
        field |= slots[:, w.offset + b].astype(np.uint64) << np.uint64(8 * b)
    return field


@pytest.mark.parametrize("case", ["one_byte", "two_bytes", "four_bytes",
                                  "no_range", "packed", "eight_words",
                                  "presence"])
def test_dense_slot_layout_round_trips(case):
    """K7's narrow table: each word in 1, 2 or 4 bytes less its lower bound
    (the fewest its range and sentinel need), the widest first, each on a
    multiple of its width, in a slot of 1-32 bytes; every build word comes
    back from its field, and the first word's field is never its sentinel's
    but in the empty slot."""
    rng = np.random.default_rng(35)
    nb = 500

    def word(lo, hi, sentinel, bounds=True):
        v = rng.integers(lo, hi + 1, nb).astype(np.int32)
        v[:2] = lo, hi
        return ("word", v, sentinel) + (((lo, hi),) if bounds else ())
    entries = {
        "one_byte": [word(0, 96, -1)],
        "two_bytes": [word(-700, 64_000, 64_001)],
        "four_bytes": [word(-2**31 + 1, 5, -2**31)],
        "no_range": [word(0, 96, -1, bounds=False)],
        "packed": [("key",), word(0, 1, 2), word(-9, 300, -10),
                   word(5, 2**20, 4), ("keyvalid",), word(-3, 250, 251)],
        "eight_words": [word(-2**31 + 1, 2**31 - 1, -2**31)
                        for _ in range(8)],
        "presence": [("key",)],
    }[case]
    layout = tjoin.dense_slot_layout(entries)
    words, slot_bytes = layout
    want_bytes = {"one_byte": [1], "two_bytes": [2], "four_bytes": [4],
                  "no_range": [4], "packed": [4, 2, 1, 1],
                  "eight_words": [4] * 8, "presence": [1]}[case]
    assert [w.bytes for w in words] == want_bytes
    assert slot_bytes in (1, 2, 4, 8, 16, 32)
    assert sum(want_bytes) <= slot_bytes < 2 * sum(want_bytes)
    for w in words:
        assert w.offset % w.bytes == 0 and w.offset + w.bytes <= slot_bytes
    slots = _slot_fields(entries, layout, nb)
    for w in words:
        field = _slot_value(slots, w)
        assert field[-1] == w.empty
        if w.entry is None:
            assert (field[:-1] == 1).all()
            continue
        got = ((field.astype(np.int64) + w.base) & 0xFFFFFFFF).astype(
            np.uint32).view(np.int32)
        np.testing.assert_array_equal(got[:-1], entries[w.entry][1])
        assert int(got[-1]) == entries[w.entry][2]
    assert (_slot_value(slots, words[0])[:-1] != words[0].empty).all()


@pytest.mark.parametrize("case", ["int8_range", "range_does_not_hold",
                                  "key_past_hi", "invalid_row_past_hi"])
def test_dense_gather_join_tests_the_stated_ranges(case):
    """K7's plain version sets out_of_range where a valid build row's key
    lies outside [lo, hi] or a word outside its stated range (toInt8 of
    values in [0, 300] stated as [0, 300]); where the ranges hold (the
    int8 range, or the row past hi invalid) it is 0 and the words are the
    reference's."""
    rng = np.random.default_rng(36)
    nb, n = 301, 2000
    bk = np.arange(nb)
    bv = np.ones(nb, bool)
    pk = rng.integers(-10, nb + 10, n)
    w8 = np.arange(nb).astype(np.int8).astype(np.int32)
    word = ("word", w8, -129, (-128, 127))
    lo, hi = 0, nb - 1
    if case == "range_does_not_hold":
        word = ("word", w8, -1, (0, 300))
    elif case in ("key_past_hi", "invalid_row_past_hi"):
        hi = nb - 2
        bv[-1] = case == "key_past_hi"
    got = tjoin.dense_gather_join(_t(bk), _t(bv), _t(pk), None,
                                  [(word[0], _t(word[1])) + word[2:]],
                                  lo, hi)
    assert got.out_of_range.shape == () and got.out_of_range.dtype == \
        torch.int32
    holds = case in ("int8_range", "invalid_row_past_hi")
    assert int(got.out_of_range) == (0 if holds else 1)
    if holds:
        ref = jjoin.dense_gather_join(
            jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
            jnp.ones(n, bool), [("word", jnp.asarray(w8), -129)], lo, hi)
        np.testing.assert_array_equal(got.matched.numpy(),
                                      np.asarray(ref.matched))
        np.testing.assert_array_equal(got.words[0].numpy(),
                                      np.asarray(ref.words[0]))


@pytest.mark.parametrize("fn,interval,want", [
    ("toInt8", (0, 300), (-128, 127)),
    ("toInt8", (-5, 100), (-5, 100)),
    ("toUInt8", (-1, 10), (0, 255)),
    ("toUInt8", (3, 255), (3, 255)),
    ("toInt16", (0, 40_000), (-32768, 32767)),
    ("toUInt16", (0, 70_000), (0, 65535)),
    ("toInt32", (-2**31, 2**31), (-2**31, 2**31 - 1)),
    ("toUInt32", (0, 2**32 - 1), (0, 2**32 - 1)),
    ("toInt64", (0, 2**64 - 1), (-2**63, 2**63 - 1)),
    ("toUInt64", (-1, 5), (0, 2**64 - 1)),
    ("identity", (-7, 300), (-7, 300)),
])
def test_cast_bounds_hold_where_the_cast_wraps(fn, interval, want):
    """A narrowing cast's bounds: the input's where every value of it fits
    the target type, else the target type's whole range (the port's
    ranges; the reference passes the input's through)."""
    from clickhouse_tpu_torch.core import dtypes as tdt_
    from clickhouse_tpu_torch.exprs.expr import BoundCall, BoundColumn
    from clickhouse_tpu_torch.plan import ranges
    col = BoundColumn("x", tdt_.Int64)
    e = BoundCall(fn, [col], tdt_.Int64)
    assert ranges.infer_bounds(e, {"x": interval}) == want


@pytest.mark.parametrize("name", ["int64", "int32", "uint8", "float64"])
@pytest.mark.parametrize("nk", [1, 2])
def test_propagate_join_matches_reference(name, nk):
    """Each probe row takes the smallest build row id with its keys."""
    rng = np.random.default_rng(32)
    nb, n = 600, 4000
    pairs = [_join_keys(rng, name, nb, n) for _ in range(nk)]
    bv = rng.random(nb) < 0.9
    pv = rng.random(n) < 0.9
    words = [np.arange(nb, dtype=np.int32),
             rng.integers(-9, 9, nb).astype(np.int32)]
    ref = jjoin.propagate_join([jnp.asarray(b) for b, _ in pairs],
                               jnp.asarray(bv),
                               [jnp.asarray(p) for _, p in pairs],
                               jnp.asarray(pv),
                               [jnp.asarray(w) for w in words])
    got = tjoin.propagate_join([_t(b) for b, _ in pairs], _t(bv),
                               [_t(p) for _, p in pairs], _t(pv),
                               [_t(w) for w in words])
    m = np.asarray(ref.matched)
    assert m.any() and not m.all()
    np.testing.assert_array_equal(got.matched.numpy(), m)
    for a, b in zip(got.words, ref.words):
        np.testing.assert_array_equal(a.numpy()[m], np.asarray(b)[m])
        assert not a.numpy()[~m].any()


def _build_rows(row_order, start, length):
    return [sorted(row_order[s:s + l].tolist()) if l else []
            for s, l in zip(start, length)]


@pytest.mark.parametrize("name", ["int64", "int32", "float64"])
def test_build_and_probe_join_table_match_reference(name):
    """Each probe row's match and its matching build rows."""
    rng = np.random.default_rng(33)
    nb, n, cap_g = 900, 3000, 1024
    b, p = _join_keys(rng, name, nb, n)
    bv = rng.random(nb) < 0.9
    pv = rng.random(n) < 0.9
    ref_t = jjoin.build_join_table([jnp.asarray(b)], jnp.asarray(bv), cap_g)
    ref = jjoin.probe_join_table(ref_t, [jnp.asarray(p)], jnp.asarray(pv))
    got_t = tjoin.build_join_table([_t(b)], _t(bv), cap_g)
    got = tjoin.probe_join_table(got_t, [_t(p)], _t(pv))
    assert int(got_t.num_groups) == int(ref_t.num_groups)
    m = np.asarray(ref.matched)
    np.testing.assert_array_equal(got.matched.numpy(), m)
    assert _build_rows(got_t.row_order.numpy(), got.seg_start.numpy()[m],
                       got.seg_len.numpy()[m]) == \
        _build_rows(np.asarray(ref_t.row_order), np.asarray(ref.seg_start)[m],
                    np.asarray(ref.seg_len)[m])
    # rows of one key come in ascending build row id
    order = got_t.row_order.numpy()
    for s_, l_ in zip(got.seg_start.numpy()[m], got.seg_len.numpy()[m]):
        assert (np.diff(order[s_:s_ + l_]) > 0).all()


@pytest.mark.parametrize("form", ["mask", "count", "count-and-mask"])
@pytest.mark.parametrize("left,any_join", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("cap", [1024, 40_960])
def test_expand_matches_matches_reference(left, any_join, cap, form):
    """The same probe result expanded by both: each valid slot's probe row
    and build position, its flag, and the output count (beyond the
    capacity too).  The probe rows' validity is a bool mask, a row count
    (the rows past it invalid, no mask), or both; the reference is given
    the equivalent bool mask."""
    rng = np.random.default_rng(34)
    n = 6000
    matched = rng.random(n) < 0.6
    valid = rng.random(n) < 0.9
    seg_len = np.where(matched, rng.integers(0, 6, n), 0).astype(np.int32)
    seg_len[n // 2] = 3000 if matched[n // 2] else 0      # a heavy key
    seg_start = np.where(matched, rng.integers(0, 500, n), 0).astype(
        np.int32)
    n_rows = None if form == "mask" else n - 1234
    mask = None if form == "count" else valid
    ref_valid = np.ones(n, bool) if mask is None else mask.copy()
    if n_rows is not None:
        ref_valid[n_rows:] = False
    ref = jjoin.expand_matches(
        jjoin.ProbeResult(jnp.asarray(matched), jnp.asarray(seg_start),
                          jnp.asarray(seg_len)),
        jnp.asarray(ref_valid), cap, left=left, any_join=any_join)
    got = tjoin.expand_matches(
        tjoin.ProbeResult(_t(matched), _t(seg_start), _t(seg_len)),
        None if mask is None else _t(mask), cap, left=left,
        any_join=any_join, n_rows=n_rows)
    count = int(ref[3])
    assert int(got[3]) == count
    live = min(count, cap)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a.numpy()[:live], np.asarray(b)[:live])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert not got[2].numpy()[live:].any()
    assert not got[0].numpy()[live:].any()


# -- K17 segmented_scan, K18 segmented_search --------------------------------
# The plain versions against the reference's running_reduce (its reverse
# scans built from [::-1] copies, as the reference's window frames build
# them) and searchsorted_seg / searchsorted.  Integers, first and last are
# exact; a float sum within n * eps * the running sum of |x| (the
# reference's associative_scan and the plain version's doubling passes add
# in other orders; a float32 sum accumulates in float64 in the port).  A
# masked min or max is compared where its segment has had a masked-in row:
# before that it holds the identity, the bound of the storage type, which
# for UInt16 and UInt32 (stored int32 and int64 in the port) is another
# number; the sign of a zero picked between -0.0 and +0.0 is not compared.

SCAN_DTYPES = ["bool", "int8", "uint8", "int16", "uint16", "int32", "uint32",
               "int64", "uint64", "float32", "float64"]


def _ref_scan(op, x, boundary, mask, reverse):
    if not reverse:
        return np.asarray(jscan.running_reduce(
            op, jnp.asarray(x), jnp.asarray(boundary),
            None if mask is None else jnp.asarray(mask)))
    rb = np.r_[boundary[1:], True][::-1]
    out = jscan.running_reduce(
        op, jnp.asarray(x[::-1]), jnp.asarray(rb),
        None if mask is None else jnp.asarray(mask[::-1]))
    return np.asarray(out)[::-1]


def _np_seen(boundary, mask, reverse):
    """Whether a row's segment has had a masked-in row up to it."""
    m = np.ones(len(boundary), bool) if mask is None else mask
    b, mm = (np.r_[boundary[1:], True][::-1], m[::-1]) if reverse \
        else (boundary, m)
    seg = np.cumsum(b) - 1
    cnt = np.cumsum(mm)
    first = np.flatnonzero(b)
    before = np.r_[0, cnt][first][seg]
    seen = cnt - before > 0
    return seen[::-1] if reverse else seen


def _assert_scan_like_reference(op, x, boundary, mask, reverse, got):
    """The port's scan `got` of numpy values x against the reference's
    running_reduce over the same rows (the comparison the header above
    states)."""
    n = len(x)
    # the reference's min and max take no bool (iinfo): its uint8
    ref_x = x.astype(np.uint8) if x.dtype == bool and op in (
        "min", "max") else x
    want = _ref_scan(op, ref_x, boundary, mask, reverse)
    g = tdt.to_numpy_storage(got, want.dtype if ref_x is x else x.dtype)
    keep = np.ones(n, bool)
    if op in ("min", "max") and mask is not None:
        keep = _np_seen(boundary, mask, reverse)
    g, w = g[keep], want[keep]
    if w.dtype.kind != "f":
        assert g.astype(w.dtype).tolist() == w.tolist()
        return
    g64, w64 = g.astype(np.float64), w.astype(np.float64)
    assert np.isnan(g64).tolist() == np.isnan(w64).tolist()
    ok = ~np.isnan(w64)
    if op != "sum":
        assert g64[ok].tolist() == w64[ok].tolist()
        return
    absx = np.nan_to_num(np.abs(x.astype(np.float64)))
    scale = _ref_scan("sum", absx, boundary, mask, reverse)[keep]
    eps = np.finfo(x.dtype).eps
    assert (np.abs(g64 - w64)[ok] <= n * eps * scale[ok] + 1e-300).all()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", ["sum", "min", "max", "first", "last"])
@pytest.mark.parametrize("name", SCAN_DTYPES)
def test_running_reduce_matches_reference(name, op, reverse):
    rng = np.random.default_rng(sum(map(ord, name + op)) + reverse)
    n = 1500
    x = _values(rng, name, n)
    if np.dtype(name).kind == "f":
        x[rng.random(n) < 0.02] = np.nan
    boundary = rng.random(n) < 0.03
    boundary[0] = True
    for mask in (None, rng.random(n) < 0.6):
        got = tscan.running_reduce(
            op, _t(x), _t(boundary), None if mask is None else _t(mask),
            reverse=reverse, unsigned=x.dtype == np.uint64)
        _assert_scan_like_reference(op, x, boundary, mask, reverse, got)


@pytest.mark.parametrize("layout", ["tile_edges", "one_row_segments",
                                    "one_segment"])
@pytest.mark.parametrize("name", ["bool", "int8", "uint8", "int16", "int32",
                                  "int64", "uint64", "float32", "float64",
                                  "row_index"])
def test_scan_cases_match_reference(name, layout):
    """chip_smoke's K17 case builders (k17_values, k17_boundary,
    k17_mask: every K17_DTYPES entry, NaN and -0.0, UInt64 bits above
    2^63) over 1,500 rows (two of K17's warp-tiles and part of a third;
    the length of the test above, whose compiled reference scans it
    shares), through K17's plain version against the reference's
    running_reduce: every op both ways, masks of none, some and every
    row.  The cases the card holds K17 to are so known right first."""
    from chip_smoke import k17_boundary, k17_calls, k17_mask, k17_values
    rng = np.random.default_rng(len(name) * 3 + len(layout))
    n = 1500
    data, uns = k17_values(rng, name, n, "cpu")
    b = k17_boundary(rng, layout, n, "cpu")
    x = np.arange(n, dtype=np.int64) if data is None else data.numpy()
    if uns:
        x = x.view(np.uint64)
    boundary = np.zeros(n, bool) if b is None else b.numpy().copy()
    boundary[0] = True
    for mkind in ("none", "random", "all_masked"):
        mask = k17_mask(rng, mkind, n, "cpu")
        m = None if mask is None else mask.numpy()
        for op, reverse in k17_calls(data, b, mask):
            got = tscan._segmented_scan_plain(op, data, b, mask, reverse,
                                              uns, n)
            _assert_scan_like_reference(op, x, boundary, m, reverse, got)


def test_segmented_scan_row_index():
    """The row index as data (nothing read): the executor's peer
    bounds."""
    tie = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)
    first = tscan.segmented_scan("first", None, _t(tie))
    last = tscan.segmented_scan("first", None, _t(tie), reverse=True)
    assert first.tolist() == [0, 0, 0, 3, 4, 4, 6, 6]
    assert last.tolist() == [2, 2, 2, 3, 5, 5, 7, 7]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("name", ["int32", "int64", "uint64", "float64"])
def test_searchsorted_seg_matches_reference(name, side):
    from clickhouse_tpu.ops import search as jsearch
    from clickhouse_tpu_torch.ops import search as tsearch
    rng = np.random.default_rng(len(name) + len(side))
    n, nq = 3000, 2500
    seg = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    key = _values(rng, name, n)
    if np.dtype(name).kind == "f":
        key = np.round(key / 1e5) + 0.0          # no -0.0: one order
    key = key[np.lexsort((key, seg))]
    qseg = rng.integers(-1, 42, nq).astype(np.int32)
    qkey = np.concatenate([key[rng.integers(0, n, nq // 2)],
                           _values(rng, name, nq - nq // 2)])
    if np.dtype(name).kind == "f":
        qkey = np.round(qkey / 1e5) + 0.0
    want = np.asarray(jsearch.searchsorted_seg(
        jnp.asarray(seg), jnp.asarray(key), jnp.asarray(qseg),
        jnp.asarray(qkey), side=side))
    got = tsearch.searchsorted_seg(_t(seg), _t(key), _t(qseg), _t(qkey),
                                   side, unsigned=name == "uint64")
    assert got.tolist() == want.astype(np.int64).tolist()
    a = np.sort(key)
    want1 = np.asarray(jsearch.searchsorted(jnp.asarray(a),
                                            jnp.asarray(qkey), side=side))
    got1 = tsearch.searchsorted(_t(a), _t(qkey), side,
                                unsigned=name == "uint64")
    assert got1.tolist() == want1.astype(np.int64).tolist()


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("name", ["one_segment_sorted",
                                  "many_segments_sorted", "straddle",
                                  "sparse_wide", "one_out_of_order",
                                  "empty_segments", "extremes",
                                  "extremes_unsigned"])
def test_search_cases_match_reference(name, side):
    """chip_smoke's K18 cases (k18_case at its CPU size: sorted queries
    over one segment and many, tiles straddling segments' ends, a stretch
    wider than K18's window, a query out of order in every tile, empty
    segments, queries at +-(2^63 - 1)) through K18's plain version against
    the reference's searchsorted_seg (searchsorted for the one-segment
    form), exactly.  The cases the card holds K18 to are so known right
    first."""
    from chip_smoke import k18_case, k18_tensors
    from clickhouse_tpu.ops import search as jsearch
    from clickhouse_tpu_torch.ops import search as tsearch
    case = k18_case(name, small=True)
    t, q, gid, starts, ends = k18_tensors(case, "cpu")
    got = tsearch._segmented_search_plain(t, q, side, gid, starts, ends,
                                          case["unsigned"])
    key, qkey = case["table"], case["queries"]
    if case["unsigned"]:
        key, qkey = key.view(np.uint64), qkey.view(np.uint64)
    if gid is None:
        want = jsearch.searchsorted(jnp.asarray(key), jnp.asarray(qkey),
                                    side=side)
    else:
        want = jsearch.searchsorted_seg(
            jnp.asarray(case["seg"].astype(np.int32)), jnp.asarray(key),
            jnp.asarray(case["qseg"]), jnp.asarray(qkey), side=side)
    assert got.tolist() == np.asarray(want).astype(np.int64).tolist()


def test_segmented_search_clamps_segment_ids():
    from clickhouse_tpu_torch.ops import search as tsearch
    table = torch.tensor([1, 5, 9, 2, 4], dtype=torch.int64)
    starts = torch.tensor([0, 3], dtype=torch.int64)
    ends = torch.tensor([3, 5], dtype=torch.int64)
    q = torch.tensor([5, 5, 3, 3], dtype=torch.int64)
    gid = torch.tensor([-4, 0, 1, 9], dtype=torch.int32)
    got = tsearch.segmented_search(table, q, "right", gid=gid, starts=starts,
                                   ends=ends)
    assert got.tolist() == [2, 2, 4, 4]
