"""clickhouse_tpu_torch's kernels (their plain versions, on the CPU) against
the JAX reference functions they replace, on the same numpy inputs.

  K1 masked_reduce       vs Grouping.reduce of group_trivial / count_mask
  K2 dense_group_reduce  vs mxu_counts_and_sums / mxu_group_reduce
  K3 topk_smallest       vs topk_permutation / topk_permutation32
  order_token, topk_key32 on every dtype

Integers must be bit-exact.  Float sums: rtol=1e-12, because the two sum
in different orders (pairwise in XLA, sequential partials in torch).
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
from clickhouse_tpu.ops import sort_ops as jsort
from clickhouse_tpu_torch.core import dtypes as tdt
from clickhouse_tpu_torch.exprs.expr import ColVal as TColVal
from clickhouse_tpu_torch.ops import agg_ops as tagg
from clickhouse_tpu_torch.ops import filter_ops as tfilter
from clickhouse_tpu_torch.ops import mxu_segsum as tmxu
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
    gt = tagg.group_trivial(torch.ones(5000, dtype=torch.bool))
    assert np.asarray(g.count_rows(jnp.asarray(m))).tolist() == \
        gt.count_rows(_t(m)).tolist()


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
    from clickhouse_tpu_torch.core.errors import NotImplementedError_
    with pytest.raises(NotImplementedError_, match="group_by_sort"):
        tagg.group_by_sort([torch.zeros(4)], torch.ones(4, dtype=torch.bool),
                           4)
    with pytest.raises(NotImplementedError_, match="sort_permutation"):
        tsort.sort_permutation([torch.zeros(4)], torch.ones(4, dtype=bool))
    with pytest.raises(NotImplementedError_, match="large-k"):
        tsort.topk_smallest(torch.zeros(10_000, dtype=torch.int64), None,
                            5000)
