"""Vector math over Array columns (reference: the "array vector math"
section of clickhouse_tpu/exprs/functions_ext.py, :2174-2320; ClickHouse's
src/Functions/array/arrayDistance.cpp).

L2Distance, L2SquaredDistance, L1Distance, LinfDistance, dotProduct and
cosineDistance of two arrays, and L2Norm and L1Norm of one.  The result is
Float32 when every argument is Array(Float32), else Float64 (the
reference's type rule, which keeps ORDER BY distance LIMIT k on K3's
32-bit entry).

Two forms, chosen as the reference chooses them:
  * a column of at least MXU_DISTANCE_MIN_ROWS rows (the block's
    capacity) against one constant query vector: cosine, L2, L2Squared and
    dotProduct are computed in float32 from the parts dot, |a|^2 and the
    length-masked |q|^2 by K11 (ops/vector_ops.vector_distance) and cast to
    the result type;
  * every other case: float64 elementwise over the rows masked by the first
    argument's lengths.
"""
from __future__ import annotations

import torch

from ..core import dtypes as dt
from ..ops import vector_ops
from .expr import ColVal
from .functions import _and_validity, _array_arg, _elem_mask, register

__all__ = ["MXU_DISTANCE_MIN_ROWS"]

# the block capacity from which a distance to a constant query takes the
# float32 form (the reference's _MXU_DISTANCE_MIN_ROWS)
MXU_DISTANCE_MIN_ROWS = 1 << 16


def _arrfn(ex):
    """Give a constant (1-d) array argument a row dimension (and 1-d
    lengths) for the exec, and a column without lengths full-width ones;
    return a constant when every array argument was one."""
    def wrapped(args, out_dtype):
        new_args = []
        all_const = True
        saw_array = False
        for a in args:
            if not dt.remove_nullable(a.dtype).is_array:
                new_args.append(a)
                continue
            saw_array = True
            if a.data.dim() == 1:
                lens = a.lengths
                if lens is None:
                    lens = torch.full((1,), a.data.shape[0],
                                      dtype=torch.int32,
                                      device=a.data.device)
                a = ColVal(a.dtype, a.data[None, :], a.validity,
                           a.dictionary, host=a.host,
                           lengths=lens.reshape(1))
            else:
                if a.lengths is None:
                    a = ColVal(a.dtype, a.data, a.validity, a.dictionary,
                               host=a.host, lengths=torch.full(
                                   (a.data.shape[0],), a.data.shape[1],
                                   dtype=torch.int32, device=a.data.device))
                all_const = False
            new_args.append(a)
        out = ex(new_args, out_dtype)
        if saw_array and all_const and out.data.dim() >= 1 \
                and out.data.shape[0] == 1:
            return ColVal(out.dtype, out.data[0], out.validity,
                          out.dictionary)
        return out
    return wrapped


def _rows(x: ColVal) -> torch.Tensor:
    return x.data if x.data.dim() == 2 else x.data[None, :]


def _vec_pair(args):
    """Both arrays as float64 (rows, W) matrices padded to the wider one
    and masked by the first argument's lengths."""
    a, b = _array_arg(args[0]), _array_arg(args[1])
    w = max(a.data.shape[-1], b.data.shape[-1])

    def pad2(x):
        d = _rows(x)
        if d.shape[-1] < w:
            d = torch.nn.functional.pad(d, (0, w - d.shape[-1]))
        return d.to(torch.float64)
    da, db = pad2(a), pad2(b)
    lens = a.lengths
    if lens.dim() == 0:
        lens = lens.expand(max(da.shape[0], db.shape[0]))
    mask = torch.arange(w, device=da.device)[None, :] \
        < lens[:, None].to(torch.int64)
    return da * mask, db * mask


def _kernel_args(args):
    """(A, lengths, q) of K11's form: the first argument a column of at
    least MXU_DISTANCE_MIN_ROWS rows (its capacity) and the second one
    constant query vector; None otherwise.  A is the column as float32
    (a copy only for another element type); q is cut or zero-padded to
    A's width (A is zero past each row's length, which is at most that
    width, so the parts are the reference's, which pads both to the wider
    of the two)."""
    a0, b0 = _array_arg(args[0]), _array_arg(args[1])
    if a0.data.dim() != 2 or _rows(b0).shape[0] != 1 \
            or a0.data.shape[0] < MXU_DISTANCE_MIN_ROWS:
        return None
    A = a0.data.to(torch.float32).contiguous()
    w = A.shape[1]
    q = _rows(b0)[0].to(torch.float32)
    q = q[:w] if q.shape[0] >= w else torch.nn.functional.pad(
        q, (0, w - q.shape[0]))
    return A, a0.lengths.to(torch.int32).contiguous(), q


def _register_distance(name, fn, op=None):
    def exec_(args, out):
        st = dt.remove_nullable(out).torch_dtype
        if op is not None:
            kargs = _kernel_args(args)
            if kargs is not None:
                return ColVal(out, vector_ops.vector_distance(
                    *kargs, op).to(st), _and_validity(args))
        a, b = _vec_pair(args)
        return ColVal(out, fn(a, b).to(st), _and_validity(args))

    def resolve(ts):
        # all-Float32 vectors keep a Float32 result (the reference's rule)
        def inner_f32(t):
            t = dt.remove_nullable(t)
            return t.is_array and dt.array_inner(t).name == "Float32"
        base = dt.Float32 if all(inner_f32(t) for t in ts) else dt.Float64
        return base.with_nullable(any(t.nullable for t in ts))
    register(name, resolve, _arrfn(exec_))


def _cosine(a, b):
    den = torch.sqrt((a * a).sum(-1)) * torch.sqrt((b * b).sum(-1))
    return 1.0 - (a * b).sum(-1) / torch.where(
        den < 1e-300, torch.full_like(den, 1e-300), den)


_register_distance("L2Distance",
                   lambda a, b: torch.sqrt(((a - b) ** 2).sum(-1)), op="l2")
_register_distance("L2SquaredDistance", lambda a, b: ((a - b) ** 2).sum(-1),
                   op="l2squared")
_register_distance("L1Distance", lambda a, b: (a - b).abs().sum(-1))
_register_distance("LinfDistance", lambda a, b: (a - b).abs().amax(-1))
_register_distance("dotProduct", lambda a, b: (a * b).sum(-1), op="dot")
_register_distance("cosineDistance", _cosine, op="cosine")


def _norm_exec(fn):
    def ex(args, out_dtype):
        a = _array_arg(args[0])
        return ColVal(out_dtype, fn(a.data.to(torch.float64) * _elem_mask(a)),
                      _and_validity(args))
    return ex


register("L2Norm", lambda ts: dt.Float64.with_nullable(ts[0].nullable),
         _arrfn(_norm_exec(lambda x: torch.sqrt((x * x).sum(-1)))))
register("L1Norm", lambda ts: dt.Float64.with_nullable(ts[0].nullable),
         _arrfn(_norm_exec(lambda x: x.abs().sum(-1))))
