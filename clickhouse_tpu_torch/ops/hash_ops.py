"""Row hashes and order-preserving float encodings (reference:
clickhouse_tpu/ops/hash_ops.py).

Floats map to u64 tokens (carried as int64 bits) whose unsigned order is
the float total order: -0.0 below +0.0, NaNs last.  The map is
one-to-one, so equal tokens are equal bit patterns (-0.0 and +0.0 are two
keys, NaNs with equal bits one) and the decoders give the float back
exactly.  Only the reference's IEEE (CPU) branch is ported.

The row hash is the reference's splitmix64 finalizer (``hash64``), folded
over several columns by ``hash_combine`` (``hash_columns``); a value enters
it as its u64 bits (``_to_u64``: an integer sign-extended as numpy's
astype(uint64), a float as its token).  Under the port's unsigned rule a
u64 rides as int64 bits: every multiply and add wraps mod 2^64 and a right
shift is a shift plus a mask.  ``row_hash`` (K15, csrc/row_hash.cu) computes
``hash_columns`` over 1-4 columns as they are stored, in one pass.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from . import _native

__all__ = ["f64_token", "f32_token", "f64_from_token", "sortable_bits",
           "_order_map32", "hash64", "hash_combine", "hash_columns",
           "bucket_of", "_to_u64", "HashArg", "row_hash", "row_hash_bytes",
           "MAX_HASH_COLS"]

_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_U32 = 0xFFFFFFFF


def _i64(u: int) -> int:
    """The int64 bits of the u64 value u."""
    return u - (1 << 64) if u >> 63 else u


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_M1 = _i64(0xBF58476D1CE4E5B9)
_M2 = _i64(0x94D049BB133111EB)


def _order_map32(b: torch.Tensor) -> torch.Tensor:
    """IEEE f32 bit pattern (u32 value in int64) -> int64 holding the u32
    whose unsigned order is the float total order (negative: flip all
    bits; positive: set the sign bit)."""
    b = b.to(torch.int64) & _U32
    return torch.where((b >> 31) == 1, (~b) & _U32, b | 0x80000000)


def _order_unmap32(t: torch.Tensor) -> torch.Tensor:
    """Inverse of _order_map32: the f32 bit pattern as a u32 in int64."""
    t = t.to(torch.int64) & _U32
    return torch.where((t >> 31) == 1, t & 0x7FFFFFFF, (~t) & _U32)


def f64_token(x: torch.Tensor) -> torch.Tensor:
    """Total-order injective u64 token (int64 bits) of an f64 column."""
    bits = x.to(torch.float64).view(torch.int64)
    return torch.where(bits < 0, ~bits, bits | _SIGN)


def f64_from_token(t: torch.Tensor) -> torch.Tensor:
    """Inverse of `f64_token`."""
    bits = torch.where(t < 0, t & ~_SIGN, ~t)
    return bits.view(torch.float64)


def f32_token(x: torch.Tensor) -> torch.Tensor:
    """f32 counterpart of `f64_token` (same token layout, lo half zero)."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    return _order_map32(b) << 32


def _f32_from_token(t: torch.Tensor) -> torch.Tensor:
    """Inverse of `f32_token`."""
    b = _order_unmap32((t >> 32) & _U32)       # u32 bits in [0, 2^32)
    return (b - ((b >> 31) << 32)).to(torch.int32).view(torch.float32)


def sortable_bits(x: torch.Tensor):
    """(encoded, decoder): floats as their tokens (`f64_token` /
    `f32_token`), which sort as u64 and are one-to-one, so grouping and
    sorting never compare raw floats; decoder is None for other types."""
    if x.dtype == torch.float64:
        return f64_token(x), f64_from_token
    if x.dtype == torch.float32:
        return f32_token(x), _f32_from_token
    return x, None


# -- row hashes --------------------------------------------------------------

def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _to_u64(x: torch.Tensor) -> torch.Tensor:
    """A column's values as u64 bits in int64 (the reference's _to_u64 on
    the CPU): integers and Bool sign- or zero-extended as numpy's
    astype(uint64), a float as its token."""
    if x.dtype == torch.float64:
        return f64_token(x)
    if x.dtype == torch.float32:
        return f32_token(x)
    if x.dtype in (torch.bool, torch.uint8, torch.int8, torch.int16,
                   torch.int32, torch.int64):
        return x.to(torch.int64)
    raise TypeError(f"hash64: unsupported dtype {x.dtype}")


def hash64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over a u64 (or bit-castable) column: int64
    bits of the reference's uint64 result."""
    z = _to_u64(x) + _GOLDEN
    z = (z ^ _shr(z, 30)) * _M1
    z = (z ^ _shr(z, 27)) * _M2
    return z ^ _shr(z, 31)


def hash_combine(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Order-dependent combiner (boost-style):
    h' = mix(h ^ (mix(x) + c + (h << 6) + (h >> 2)))."""
    x = hash64(x)
    return hash64(h ^ (x + _GOLDEN + (h << 6) + _shr(h, 2)))


def hash_columns(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """One u64 hash (int64 bits) per row over several columns."""
    assert arrays, "hash_columns requires at least one column"
    h = hash64(arrays[0])
    for a in arrays[1:]:
        h = hash_combine(h, a)
    return h


def bucket_of(h: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Exchange bucket = the high bits of the hash (int32), as the
    reference's (a power of two of buckets; one bucket: all 0, the
    reference's shift by 64)."""
    assert num_buckets & (num_buckets - 1) == 0, \
        "num_buckets must be a power of 2"
    shift = 64 - num_buckets.bit_length() + 1
    if shift >= 64:
        return torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    return _shr(h, shift).to(torch.int32)


# -- K15: the row hash over columns as stored --------------------------------

MAX_HASH_COLS = _native.MAX_HASH_COLS
# how a column's stored values become u64 bits (csrc/hash64.cuh HashKind)
_KINDS = {"int": 0, "f32": 1, "f64": 2, "hash": 3}
_TERMS = {None: 0, "div": 1, "mod": 2}


@dataclasses.dataclass(frozen=True)
class HashArg:
    """One column of a row hash as K15 and K16 read it.

    data: the column as stored, (n,) or 0-d (one value for every row), or
    a scan_ops.Term (intDiv/modulo of an int8/16/32 column by a constant,
    formed in registers).  kind: "int" (the stored integer, Bool or
    dictionary code sign- or zero-extended), "f32" (the f32 token of a
    Float32), "f64" (the f64 token of a Float64, whose storage may be
    float32: widened exactly first) or "hash" (first only: int64 hashes
    of earlier columns, which the fold goes on from)."""
    data: object
    kind: str = "int"

    def values(self) -> torch.Tensor:
        """The u64 bits (int64) the hash takes (plain torch)."""
        from .scan_ops import Term
        if isinstance(self.data, Term):
            return self.data.build().to(torch.int64)
        t = self.data
        if self.kind == "hash":
            return t
        if self.kind == "f32":
            return f32_token(t)
        if self.kind == "f64":
            return f64_token(t.to(torch.float64))
        if t.is_floating_point():
            raise TypeError(f"HashArg: float storage {t.dtype} of kind "
                            f"'int'")
        return _to_u64(t)

    def tensor(self) -> torch.Tensor:
        """The tensor the kernels read (a Term's source)."""
        from .scan_ops import Term
        return self.data.source if isinstance(self.data, Term) else self.data


def _n_rows(args: Sequence[HashArg]) -> Optional[int]:
    """The row count of the args' columns (None: all 0-d)."""
    ns = {a.tensor().shape[0] for a in args if a.tensor().dim() == 1}
    if len(ns) > 1:
        raise ValueError(f"row_hash: columns of {sorted(ns)} rows")
    return ns.pop() if ns else None


def _check_args(args: Sequence[HashArg]) -> None:
    if not args:
        raise ValueError("row_hash: no column")
    for i, a in enumerate(args):
        if a.kind not in _KINDS or (a.kind == "hash" and (
                i or a.tensor().dtype != torch.int64)):
            raise ValueError(f"row_hash: kind {a.kind!r} of column {i}")
        t = a.tensor()
        if t.dim() > 1:
            raise ValueError("row_hash: a column must be 1-d or 0-d")
        if (a.kind == "f32" and t.dtype != torch.float32) or (
                a.kind == "f64" and t.dtype not in (torch.float32,
                                                    torch.float64)):
            raise ValueError(f"row_hash: {a.kind} of {t.dtype}")
    devs = {a.tensor().device for a in args}
    if len(devs) > 1:
        raise ValueError(f"row_hash: columns on {sorted(map(str, devs))}")


def plain_values(args: Sequence[HashArg], n: int) -> list:
    """Each arg's u64 bits over n rows (plain torch; a 0-d arg
    broadcast)."""
    return [a.values().expand(n) if a.tensor().dim() == 0 else a.values()
            for a in args]


def _fold(vals: Sequence[torch.Tensor], first_kind: str) -> torch.Tensor:
    """hash_columns of u64 bits, going on from vals[0] where it is a
    hash (kind "hash")."""
    h = vals[0] if first_kind == "hash" else hash64(vals[0])
    for v in vals[1:]:
        h = hash_combine(h, v)
    return h


def fold_args(args: Sequence[HashArg], limit: int = MAX_HASH_COLS,
              n: Optional[int] = None) -> list:
    """args as at most `limit` (2 or more) columns of one kernel launch:
    the leading ones hashed first (K15), their hash the first column."""
    args = list(args)
    if len(args) <= limit:
        return args
    keep = limit - 1
    return [HashArg(row_hash(args[:-keep], n), "hash")] + args[-keep:]


def row_hash(args: Sequence[HashArg], n: Optional[int] = None
             ) -> torch.Tensor:
    """hash_columns of the args' values, one int64 (u64 bits) a row: n
    rows (the columns' length; n given where every arg is 0-d).

    A CPU tensor takes the plain version (hash_columns); a CUDA tensor
    launches K15 (csrc/row_hash.cu) once for each four columns (after
    the first launch, the hash so far and the next three)."""
    _check_args(args)
    rows = _n_rows(args)
    n = rows if rows is not None else int(n if n is not None else 1)
    if rows is not None and rows != n:
        raise ValueError(f"row_hash: {rows} rows, {n} asked")
    dev = args[0].tensor().device
    if dev.type == "cpu":
        return _fold(plain_values(args, n), args[0].kind)
    if dev.type != "cuda":
        raise RuntimeError(f"row_hash: no kernel for {dev}")
    args = list(args)
    h = _row_hash_cuda(args[:MAX_HASH_COLS], n)
    rest = args[MAX_HASH_COLS:]
    while rest:
        step = MAX_HASH_COLS - 1
        h = _row_hash_cuda([HashArg(h, "hash")] + rest[:step], n)
        rest = rest[step:]
    return h


def row_hash_bytes(args: Sequence[HashArg], n: int) -> int:
    """Bytes K15 moves: each column as stored read once (a 0-d one not at
    all), 8 bytes a row written."""
    return sum(n * a.tensor().element_size() for a in args
               if a.tensor().dim() == 1) + 8 * n


def hash_cols(args: Sequence[HashArg]):
    """The kernels' ChttHashCol array of args (and the tensors it points
    into, to keep alive while the kernel runs)."""
    from .calendar_ops import magic
    from .scan_ops import Term
    cols = (_native.HashCol * MAX_HASH_COLS)()
    keep = []
    for i, a in enumerate(args):
        t = a.tensor().contiguous()
        keep.append(t)
        c = cols[i]
        c.data = t.data_ptr()
        c.dtype = _native.dtype_code(t.dtype)
        c.kind = _KINDS[a.kind]
        c.stride = 1 if t.dim() == 1 else 0
        if isinstance(a.data, Term):
            m, l = magic(abs(a.data.c), 32)
            c.term, c.c, c.magic = _TERMS[a.data.op], a.data.c, m
            c.shift1, c.shift2 = min(l, 1), max(l - 1, 0)
    return cols, keep


def _row_hash_cuda(args: Sequence[HashArg], n: int) -> torch.Tensor:
    dev = args[0].tensor().device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    cols, keep = hash_cols(args)
    rc = _native.library().chtt_row_hash(
        ctypes.byref(cols), len(args), n, out.data_ptr(),
        _native.grid_blocks(dev, n, per_sm=8), _native.stream_ptr(dev))
    _native.check(rc, "row_hash")
    _native.count_launch("row_hash", n)
    del keep
    return out

