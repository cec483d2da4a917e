"""ORDER BY: order tokens, K3 (top-k) and K4 (stable radix sort).

Reference: clickhouse_tpu/ops/sort_ops.py.  Every sort key maps to a u64
token (carried as int64 bits) whose unsigned order is the requested row
order, with direction and NULL placement folded in.  `ORDER BY ... LIMIT
k` then takes the k smallest rows by (invalid, token, row id) with K3
(csrc/topk_smallest.cu): ties go to the lower row id.  Where the value
provably fits 32 bits, K3's 32-bit entry reads a u32 key (int32 bits) and
the validity byte instead, 5 bytes a row in place of 9.

The full stable sort (``sort_rows``: the sort grouping's and
``sort_permutation``'s, for ORDER BY without a top-k, multi-key ORDER BY
and k > 4,096) is K4 (csrc/radix_sort.cu), an LSD radix sort of (key, row
id) pairs.  The keys are packed into as few bits as vary: each key less
its lower bound (proven by interval analysis, or read from the device),
the invalid flag above them all, several keys to one u64 where they fit;
wider key sets chain K4 calls, least significant first.  The order is the
reference's stable sort by (invalid, key 1, ..., key n, row id).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.errors import (ExecutionError, MemoryLimitExceeded,
                           NotImplementedError_)
from . import _native

__all__ = ["order_token", "sort_permutation", "topk_permutation",
           "topk_key32", "topk_permutation32", "topk_smallest",
           "topk_smallest32", "MAX_TOPK", "SortKey", "order_value",
           "sort_rows", "sort_rows_bytes", "radix_sort_pairs",
           "sort_pass_plan", "k4_scratch_bytes"]

MAX_TOPK = 4096
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_U32 = 0xFFFFFFFF
_I32_SIGN = -(1 << 31)             # int32 bits of 1 << 31
_I64_MAX = (1 << 63) - 1
_NARROW_INTS = (torch.bool, torch.uint8, torch.int8, torch.int16,
                torch.int32)


def order_token(x: torch.Tensor, *, descending: bool = False,
                validity: Optional[torch.Tensor] = None,
                nulls_last: bool = True,
                rank: Optional[torch.Tensor] = None,
                unsigned: bool = False) -> torch.Tensor:
    """Monotone map of a column into u64 tokens (int64 bits) so that
    unsigned-ascending order is the desired order.

    rank     -- optional precomputed ordering rank (dictionary strings)
    unsigned -- the column's values are unsigned (UInt64 as int64 bits)
    """
    if rank is not None:
        x, unsigned = rank, False
    if x.dtype in (torch.float64, torch.float32):
        from .hash_ops import f32_token, f64_token
        tok = f64_token(x) if x.dtype == torch.float64 else f32_token(x)
    elif x.dtype in (torch.bool, torch.uint8) or unsigned:
        tok = x.to(torch.int64)
    else:  # signed ints: sign-extended bits with the sign bit flipped
        tok = x.to(torch.int64) ^ _SIGN
    if descending:
        tok = ~tok
    if validity is not None:
        # reserve the extreme value for NULL; real tokens move inward by one
        if nulls_last:
            tok = torch.where(tok == -1, torch.full_like(tok, -2), tok)
            null_tok = -1
        else:
            tok = torch.where(tok == 0, torch.ones_like(tok), tok)
            null_tok = 0
        tok = torch.where(validity.to(torch.bool), tok,
                          torch.full_like(tok, null_tok))
    return tok


def sort_permutation(tokens: Sequence[torch.Tensor],
                     row_valid: torch.Tensor, *,
                     max_bytes: Optional[int] = None) -> torch.Tensor:
    """int64 permutation sorting the rows by the token columns (u64 tokens
    as int64 bits), stably; invalid rows sink last.  The valid rows come in
    the order of the reference's stable sort by (invalid, tokens..., row
    id); the order of the invalid rows among themselves is not kept.
    max_bytes: sort_rows' limit on its working set."""
    perm, _ = sort_rows([SortKey(t, unsigned=True) for t in tokens],
                        row_valid, want_keys=False, max_bytes=max_bytes)
    return perm.to(torch.int64)


# -- K4: stable radix sort of (key, row id) pairs -----------------------------

@dataclasses.dataclass
class SortKey:
    """One operand of a stable multi-key sort, in ascending order.

    data     -- the values: an integer, bool or float tensor (floats sort by
                their total-order token: -0.0 below +0.0, NaNs last)
    unsigned -- int64 data holding UInt64 bits (sorts unsigned)
    bounds   -- proven [lo, hi] of the values (interval analysis), or None
    """
    data: torch.Tensor
    unsigned: bool = False
    bounds: Optional[Tuple[int, int]] = None


def order_value(key: SortKey) -> torch.Tensor:
    """The key's u64 order value (int64 bits): its unsigned order is the
    key's order."""
    x = key.data
    if x.is_floating_point():
        from .hash_ops import sortable_bits
        return sortable_bits(x)[0]
    if x.dtype in (torch.bool, torch.uint8) or key.unsigned:
        return x.to(torch.int64)
    return x.to(torch.int64) ^ _SIGN


def _bounded_range(key: SortKey) -> Optional[Tuple[int, int]]:
    """[lo, hi] of the key's order values from its proven bounds, where
    they span fewer than 2^32 values (wider bounds, usually a type's own
    range, are measured on the device instead)."""
    if key.bounds is None or key.data.is_floating_point():
        return None
    lo, hi = int(key.bounds[0]), int(key.bounds[1])
    if key.unsigned or key.data.dtype in (torch.bool, torch.uint8):
        if lo < 0:
            return None
    else:
        lo, hi = lo + (1 << 63), hi + (1 << 63)
    if not 0 <= lo <= hi < 1 << 64 or hi - lo >= 1 << 32:
        return None
    return lo, hi


def _measured_ranges(values: List[torch.Tensor],
                     valid: Optional[torch.Tensor]) -> List[Tuple[int, int]]:
    """[lo, hi] of each order value over the valid rows: one device
    reduction each, one host read for all; (0, 0) where no row is
    valid."""
    parts = []
    for v in values:
        sv = v ^ _SIGN                 # unsigned order as signed order
        if valid is None:
            parts += [sv.amin(), sv.amax()]
        else:
            parts += [torch.where(valid, sv, _I64_MAX).amin(),
                      torch.where(valid, sv, -_I64_MAX - 1).amax()]
    got = torch.stack(parts).tolist()
    out = []
    for i in range(len(values)):
        lo, hi = got[2 * i] + (1 << 63), got[2 * i + 1] + (1 << 63)
        out.append((lo, hi) if lo <= hi else (0, 0))
    return out


def sort_pass_plan(bits: int) -> Tuple[int, int]:
    """(passes, digit bits) of K4 for keys of `bits` significant bits:
    8-bit digits at most, the bits spread evenly over the passes (21 bits:
    three passes of 7 bits), at least one pass."""
    passes = max(1, math.ceil(bits / 8))
    return passes, max(1, math.ceil(bits / passes))


# rows of K4's scatter tiles by key bytes: 512 threads, 16 u32 keys a
# thread or 8 u64 (csrc/radix_sort.cu tile_rows; chtt_radix_tile_rows)
K4_TILE_ROWS = {4: 8192, 8: 4096}


def k4_scratch_bytes(n: int, key_bytes: int, bits: int) -> int:
    """Device bytes of K4's scratch for n keys of key_bytes bytes sorted by
    `bits` bits (csrc/radix_sort.cu scratch_bytes): the passes x radix
    digit histogram, a tile counter a pass, and one look-back status word
    (8 bytes) a (tile, digit)."""
    passes, digit = sort_pass_plan(bits)
    ints = (passes << digit) + passes
    return (ints + (ints & 1)) * 4 \
        + -(-n // K4_TILE_ROWS[key_bytes]) * (1 << digit) * 8


@dataclasses.dataclass
class _Field:
    """One key's place in a packed sort key: its width in bits and how to
    compute its non-negative packed value (the order value less lo)."""
    key: Optional[SortKey]             # None: the invalid flag
    lo: int
    width: int


def _pack_groups(fields: List[_Field]) -> List[List[_Field]]:
    """Split the fields (most significant first) into packed keys of at
    most 64 bits, least significant key first."""
    groups: List[List[_Field]] = []
    cur: List[_Field] = []
    width = 0
    for f in reversed(fields):
        if cur and width + f.width > 64:
            groups.append(cur)
            cur, width = [], 0
        cur.insert(0, f)
        width += f.width
    if cur:
        groups.append(cur)
    return groups


def _lo_value(f: _Field) -> int:
    """The field's lower bound as a value of its key (not an order
    value)."""
    x = f.key.data
    signed = not (f.key.unsigned or x.dtype in (torch.bool, torch.uint8)
                  or x.is_floating_point())
    return f.lo - (1 << 63) if signed else f.lo


def _narrow_field(f: _Field, dtype: torch.dtype) -> bool:
    """A narrow integer in a range of < 2^31 values: its packed value is
    x - lo in 32 bits."""
    return dtype == torch.int32 and f.key.data.dtype in _NARROW_INTS \
        and -(1 << 31) <= _lo_value(f) < 1 << 31


def _key_dtype(width: int) -> torch.dtype:
    """A packed key's tensor type: int32 bits up to 31 bits, else int64."""
    return torch.int32 if width <= 31 else torch.int64


def _field_value(f: _Field, valid: Optional[torch.Tensor], n: int, dev,
                 dtype: torch.dtype) -> torch.Tensor:
    """The field's packed value a row (0 on invalid rows), as `dtype`."""
    if f.key is None:
        return (~valid).to(dtype)
    x = f.key.data
    if _narrow_field(f, dtype):
        v = x.to(torch.int32) - _lo_value(f)
    else:
        lo = f.lo - (1 << 64) if f.lo >= 1 << 63 else f.lo
        v = (order_value(f.key) - lo).to(dtype)
    if x.dim() == 0:
        v = v.expand(n)
    return v if valid is None else torch.where(valid, v, 0)


def _group_key(group: List[_Field], valid, n: int, dev) -> Tuple[
        torch.Tensor, int]:
    """One packed key (int32 bits for up to 32 bits, else int64) and its
    width: the group's fields side by side, the first most significant."""
    width = sum(f.width for f in group)
    dtype = _key_dtype(width)
    key = None
    shift = width
    for f in group:
        shift -= f.width
        if f.width == 0:
            continue
        v = _field_value(f, valid, n, dev, dtype)
        if shift:
            v = v << shift
        key = v if key is None else key | v
    if key is None:
        key = torch.zeros(n, dtype=dtype, device=dev)
    if width == 32:
        key = _low32(key)
    return key.contiguous(), width


def _pack_bytes(group: List[_Field]) -> int:
    """Bytes a row that building the group's packed key takes beside the
    packed keys: the widest field's value (4 or 8 bytes) and its
    _field_value temporaries (two int32 for a narrow integer, two int64
    for another integer, four int64 and a bool for a float's token, a bool
    for the invalid flag)."""
    dtype = _key_dtype(sum(f.width for f in group))
    b = 4 if dtype == torch.int32 else 8
    most = 0
    for f in group:
        if f.width == 0:
            continue
        if f.key is None:
            temp = 1
        elif _narrow_field(f, dtype):
            temp = 8
        elif f.key.data.is_floating_point():
            temp = 33
        else:
            temp = 16
        most = max(most, b + temp)
    return most


def sort_rows_bytes(n: int, widths: Sequence[int], pack: int = 0) -> int:
    """Device bytes sort_rows holds at its peak for n rows whose packed
    keys are `widths` bits wide (least significant first): every packed
    key (4 bytes a row up to 32 bits, else 8), and the larger of what
    building one of them takes beside them (`pack` bytes a row,
    _pack_bytes) and what one K4 call takes: its key and row id buffers
    (two of each above one pass), its scratch (k4_scratch_bytes) and,
    after the first call, its input key gathered into the order so far
    and the row ids it is given."""
    k4 = 0
    total = 0
    for i, w in enumerate(widths):
        b = 4 if w <= 32 else 8
        total += b
        bufs = 2 if sort_pass_plan(w)[0] > 1 else 1
        k4 = max(k4, n * (bufs * (b + 4) + (b + 4 if i else 0))
                 + k4_scratch_bytes(n, b, w))
    return n * total + max(k4, n * pack)


def sort_rows(keys: Sequence[SortKey], row_valid: Optional[torch.Tensor], *,
              secondary: Sequence[SortKey] = (), want_keys: bool = True,
              max_bytes: Optional[int] = None, held_bytes: int = 0
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Stable sort of the rows by (invalid, keys..., secondary..., row id),
    with K4.

    -> (perm, sorted): perm (int32) maps a sorted position to its row;
    sorted holds the packed words of (invalid, keys...) in sorted order
    (empty unless `want_keys`), whose equality between rows is the keys'
    equality (two valid rows have equal packed words exactly when every
    key is equal).  The secondary keys order the rows within equal keys
    and are packed into words of their own, so they never reach `sorted`.
    row_valid None: every row is valid.  Invalid rows sort last.
    max_bytes: raise MemoryLimitExceeded, before allocating, where the
    sort's working set (sort_rows_bytes) and the caller's `held_bytes`
    (what it holds or will allocate beside the sort) are larger.
    """
    every = list(keys) + list(secondary)
    if any(k.data.dim() > 1 for k in every):
        raise NotImplementedError_(
            "sorting or grouping by an Array key is not ported to the CUDA "
            "engine yet")
    first = next(k.data for k in every if k.data.dim() == 1)
    n, dev = first.shape[0], first.device
    valid = None if row_valid is None else row_valid.to(torch.bool)
    fields = [_Field(None, 0, 0 if valid is None else 1)]
    ranges = [_bounded_range(k) for k in every]
    todo = [i for i, r in enumerate(ranges) if r is None]
    if todo and n:
        got = _measured_ranges([order_value(every[i]).expand(n)
                                for i in todo], valid)
        for i, r in zip(todo, got):
            ranges[i] = r
    for k, r in zip(every, ranges):
        lo, hi = r if r is not None else (0, 0)
        fields.append(_Field(k, lo, (hi - lo).bit_length()))
    # least significant first: the secondary keys' words, then the keys'
    n_sec = 0
    if secondary:
        sec = _pack_groups(fields[1 + len(keys):])
        n_sec = len(sec)
        groups = sec + _pack_groups(fields[:1 + len(keys)])
    else:
        groups = _pack_groups(fields)
    if max_bytes is not None:
        need = sort_rows_bytes(n, [sum(f.width for f in g) for g in groups],
                               max(_pack_bytes(g) for g in groups)) \
            + held_bytes
        if need > max_bytes:
            raise MemoryLimitExceeded(
                f"sorting {n} rows would need {need} bytes of device "
                f"memory ({max(max_bytes, 0)} bytes of the budget left)")
    packed = [_group_key(g, valid, n, dev) for g in groups]
    perm = None
    last = None
    for i, (key, width) in enumerate(packed):
        if width == 0 and (perm is not None or i < len(packed) - 1):
            last = key                 # zeros: every order keeps them
            continue
        if perm is not None:
            key = key.index_select(0, perm)
        last, perm = radix_sort_pairs(key, width, perm)
    out: List[torch.Tensor] = []
    if want_keys:
        out = [last] + [k.index_select(0, perm)
                        for k, _ in packed[n_sec:-1]]
    return perm, out


def radix_sort_pairs(keys: torch.Tensor, bits: int,
                     values: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: sort (key, value) pairs by the low `bits` bits of the key
    (int32 bits of a u32 key, or int64 bits of a u64 key), stably, in the
    passes of :func:`sort_pass_plan`.  values (int32) None: the row ids.
    -> (sorted keys, values in sorted order).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    if keys.dim() != 1 or keys.dtype not in (torch.int32, torch.int64):
        raise ValueError("radix_sort_pairs: keys must be 1-d int32 or int64")
    if not 0 <= bits <= 8 * keys.element_size():
        raise ValueError(f"radix_sort_pairs: {bits} bits in a "
                         f"{keys.dtype} key")
    n = keys.shape[0]
    if values is not None and (values.dtype != torch.int32
                               or values.shape != keys.shape
                               or values.device != keys.device):
        raise ValueError("radix_sort_pairs: values must be int32 of the "
                         "keys' shape and device")
    if n >= 1 << 31:
        raise ValueError(f"radix_sort_pairs: {n} rows (row ids are int32)")
    if keys.device.type == "cpu":
        return _radix_sort_pairs_plain(keys, bits, values)
    if keys.device.type != "cuda":
        raise RuntimeError(f"radix_sort_pairs: no kernel for {keys.device}")
    return _radix_sort_cuda(keys.contiguous(), bits,
                            None if values is None else values.contiguous())


def _radix_sort_cuda(keys, bits, values):
    """Launch K4: the histogram kernel, then a scatter a pass."""
    n = keys.shape[0]
    dev = keys.device
    if n == 0:
        return keys.clone(), torch.empty(0, dtype=torch.int32, device=dev)
    passes, digit = sort_pass_plan(bits)
    key_bytes = keys.element_size()
    keys = _native.aligned16(keys)         # the histogram's 16-byte loads
    ka, va = torch.empty_like(keys), torch.empty(n, dtype=torch.int32,
                                                 device=dev)
    kb, vb = (torch.empty_like(keys), torch.empty_like(va)) if passes > 1 \
        else (ka, va)
    scratch = torch.empty(k4_scratch_bytes(n, key_bytes, bits),
                          dtype=torch.uint8, device=dev)
    rc = _native.library().chtt_radix_sort_pairs(
        keys.data_ptr(), key_bytes,
        None if values is None else values.data_ptr(), n, passes, digit,
        ka.data_ptr(), va.data_ptr(), kb.data_ptr(), vb.data_ptr(),
        scratch.data_ptr(), scratch.numel(), _native.stream_ptr(dev))
    _native.check(rc, "radix_sort_pairs")
    _native.count_launch("radix_sort_pairs", n)
    return (ka, va) if passes % 2 else (kb, vb)


def _radix_sort_pairs_plain(keys, bits, values):
    """Plain PyTorch version of K4: the kernel's pass plan, each pass a
    stable sort by one digit."""
    passes, digit = sort_pass_plan(bits)
    n = keys.shape[0]
    vals = values if values is not None else torch.arange(
        n, dtype=torch.int32, device=keys.device)
    mask = (1 << digit) - 1
    for p in range(passes):
        # an arithmetic shift: the sign copies land above the digit's bits
        d = (keys >> (p * digit)) & mask
        order = torch.sort(d, stable=True).indices
        keys, vals = keys[order], vals[order]
    return keys, vals


def topk_key32(cv, descending: bool) -> Optional[torch.Tensor]:
    """u32 order key, as int32 bits, when the sort value provably fits 32
    bits: f32 values and <=32-bit integer types, or wider integers whose
    proven bounds span < 2^32 - 1.  None otherwise, and for nullable and
    dictionary columns."""
    if cv.validity is not None or cv.dictionary is not None:
        return None
    from ..core import dtypes as dt
    x = cv.data
    logical = dt.remove_nullable(cv.dtype).np_dtype
    if x.dtype == torch.float32:
        # hash_ops._order_map32 on int32 bits: negative -> ~b, else set sign
        b = x.view(torch.int32)
        key = torch.where(b < 0, ~b, b ^ _I32_SIGN)
    elif x.dtype == torch.bool:
        key = x.to(torch.int32)
    elif logical.kind == "u" and logical.itemsize <= 4:
        key = _low32(x)
    elif logical.kind == "i" and logical.itemsize <= 4 \
            and not x.is_floating_point():
        key = x.to(torch.int32) ^ _I32_SIGN
    elif logical.kind in ("i", "u") and not x.is_floating_point() \
            and getattr(cv, "bounds", None) is not None \
            and int(cv.bounds[1]) - int(cv.bounds[0]) < 2**32 - 1:
        # wide type, but interval analysis proves a 32-bit span
        lo, hi = int(cv.bounds[0]), int(cv.bounds[1])
        if x.dtype == torch.int32 and -2**31 <= lo and hi - lo < 2**31:
            key = x - lo               # in bounds: no int32 overflow
        else:
            key = _low32(x.to(torch.int64) - lo)
    else:
        return None
    if descending:
        key = ~key
    return key


def _low32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of each value, as int32 bits (x's value mod 2^32)."""
    if x.dtype in (torch.int32, torch.uint8, torch.int8, torch.int16):
        return x.to(torch.int32)
    return x.to(torch.int64).contiguous().view(torch.int32)[0::2].contiguous()


def topk_permutation32(key32: torch.Tensor, row_valid: torch.Tensor, k: int
                       ) -> torch.Tensor:
    """Indices of the k smallest u32 keys among valid rows.  key32 holds
    the u32 keys as int32 bits (or as int64 values in [0, 2^32)).  Keys
    clamp to 2^32 - 2 and invalid rows take 2^32 - 1 (so valid keys
    2^32 - 2 and 2^32 - 1 tie, as in the reference); K3's 32-bit entry
    applies both as it reads the rows."""
    if key32.dtype != torch.int32:
        key32 = _low32(key32)
    return topk_smallest32(key32.contiguous(),
                           row_valid.to(torch.bool).contiguous(), k)


def topk_permutation(token: torch.Tensor, row_valid: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """Indices of the k smallest tokens among valid rows (ascending by
    (invalid, token, row id)).  Validity is a separate key, never folded
    into the token."""
    return topk_smallest(token.contiguous(),
                         row_valid.to(torch.bool).contiguous(), k)


def topk_smallest(token: torch.Tensor, valid: Optional[torch.Tensor],
                  k: int) -> torch.Tensor:
    """K3, 64-bit entry: int64 indices of the k smallest rows by (invalid,
    token as unsigned 64-bit, row id); valid=None means every row is valid.
    Only the first min(n_valid, k) indices are meaningful; the rest point
    at rows the caller masks (at most the last row).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    _check_k(k)
    if k == 0:
        return torch.empty(0, dtype=torch.int64, device=token.device)
    if token.device.type == "cpu":
        return _topk_smallest_plain(token, valid, k)
    return _topk_cuda(token, torch.int64, valid, k)


def topk_smallest32(key32: torch.Tensor, valid: Optional[torch.Tensor],
                    k: int) -> torch.Tensor:
    """K3, 32-bit entry: int64 indices of the k smallest rows by (u32 key
    clamped to 2^32 - 2, or 2^32 - 1 where the row is invalid; row id).
    key32 holds the u32 keys as int32 bits; valid=None means every row is
    valid.  Only the first min(n_valid, k) indices are meaningful.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    _check_k(k)
    if k == 0:
        return torch.empty(0, dtype=torch.int64, device=key32.device)
    if key32.device.type == "cpu":
        return _topk_smallest32_plain(key32, valid, k)
    return _topk_cuda(key32, torch.int32, valid, k)


def _check_k(k):
    if k < 0:
        raise ExecutionError(f"topk_smallest: k={k} (a top-k needs k >= 0)")
    if k > MAX_TOPK:
        raise NotImplementedError_(
            f"large-k top-k (k={k} > {MAX_TOPK}) is not ported to the CUDA "
            f"engine yet")


def _topk_cuda(key, dtype, valid, k):
    """Launch K3: level 1, then (with more than one block) the merge."""
    n = key.shape[0]
    dev = key.device
    if key.device.type != "cuda":
        raise RuntimeError(f"topk_smallest: no kernel for {key.device}")
    if key.dim() != 1 or key.dtype != dtype or not key.is_contiguous():
        raise ValueError(f"topk_smallest: key must be contiguous 1-d {dtype}")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != key.shape
                              or valid.device != dev
                              or not valid.is_contiguous()):
        raise ValueError("topk_smallest: valid must be a contiguous bool "
                         "tensor of the key's shape and device")
    if not 1 <= n < _U32:
        raise ValueError(f"topk_smallest: {n} rows outside [1, 2^32 - 1)")
    key_bytes = key.element_size()
    key, valid = _native.aligned16(key), _native.aligned16(valid)
    scratch, nb = _topk_scratch(key, k)
    out = torch.empty((k,), dtype=torch.int64, device=dev)
    lib = _native.library()
    rc = lib.chtt_topk_smallest(
        key.data_ptr(), key_bytes,
        valid.data_ptr() if valid is not None else None, n, k, nb,
        out.data_ptr(), scratch.data_ptr(), _native.stream_ptr(dev))
    _native.check(rc, "topk_smallest")
    _native.count_launch("topk_smallest", n)
    return out


def _topk_scratch(key: torch.Tensor, k: int):
    """K3's scratch for key's rows, and its number of level-1 blocks: the
    published threshold, each level-1 block's best k and quantiles, and the
    merge's bounds."""
    key_bytes = key.element_size()
    lib = _native.library()
    with torch.cuda.device(key.device):
        nb = lib.chtt_topk_blocks(key_bytes, key.shape[0], k)
    if nb < 0:
        _native.check(-nb, "topk_smallest")
    size = lib.chtt_topk_scratch_bytes(key_bytes, nb, k)
    return torch.empty((size,), dtype=torch.uint8, device=key.device), nb


def _topk_smallest_plain(token, valid, k):
    """Plain PyTorch version of K3's 64-bit entry: stable sorts from the
    least significant key (row id order is the starting order), then the
    first k; indices past the row count clamp to the last row."""
    n = token.shape[0]
    perm = torch.sort(token ^ _SIGN, stable=True).indices
    if valid is not None:
        inv = (~valid.to(torch.bool)).to(torch.uint8)[perm]
        perm = perm[torch.sort(inv, stable=True).indices]
    out = perm[:k]
    if out.shape[0] < k:
        out = torch.cat([out, out.new_full((k - out.shape[0],), n - 1)])
    return out


def _topk_smallest32_plain(key32, valid, k):
    """Plain PyTorch version of K3's 32-bit entry: the reference's clamp
    and sentinel on the u32 key, then the 64-bit entry's plain version."""
    key = key32.to(torch.int64) & _U32
    key = torch.clamp(key, max=_U32 - 1)
    if valid is not None:
        key = torch.where(valid.to(torch.bool), key, torch.full_like(key, _U32))
    return _topk_smallest_plain(key, None, k)
