"""ORDER BY ... LIMIT k: order tokens and K3 (top-k).

Reference: clickhouse_tpu/ops/sort_ops.py.  Every sort key maps to a u64
token (carried as int64 bits) whose unsigned order is the requested row
order, with direction and NULL placement folded in.  `ORDER BY ... LIMIT
k` then takes the k smallest rows by (invalid, token, row id) with K3
(csrc/topk_smallest.cu): ties go to the lower row id.  Where the value
provably fits 32 bits, K3's 32-bit entry reads a u32 key (int32 bits) and
the validity byte instead, 5 bytes a row in place of 9.

The full multi-key sort (``sort_permutation``) and top-k with k > 4,096
are not ported yet and raise ``NotImplementedError_`` naming them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.errors import NotImplementedError_
from . import _native

__all__ = ["order_token", "sort_permutation", "topk_permutation",
           "topk_key32", "topk_permutation32", "topk_smallest",
           "topk_smallest32", "MAX_TOPK"]

MAX_TOPK = 4096
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_U32 = 0xFFFFFFFF
_I32_SIGN = -(1 << 31)             # int32 bits of 1 << 31


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
                     row_valid: torch.Tensor) -> torch.Tensor:
    """The full stable multi-key sort is not ported yet."""
    raise NotImplementedError_(
        "sort_permutation (ORDER BY without a LIMIT the top-k path takes) "
        "is not ported to the CUDA engine yet")


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
    if key32.device.type == "cpu":
        return _topk_smallest32_plain(key32, valid, k)
    return _topk_cuda(key32, torch.int32, valid, k)


def _check_k(k):
    if k < 1:
        raise ValueError(f"topk_smallest: k={k}")
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
