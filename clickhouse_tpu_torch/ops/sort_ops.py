"""ORDER BY ... LIMIT k: order tokens and K3 (top-k).

Reference: clickhouse_tpu/ops/sort_ops.py.  Every sort key maps to a u64
token (carried as int64 bits) whose unsigned order is the requested row
order, with direction and NULL placement folded in.  `ORDER BY ... LIMIT
k` then takes the k smallest rows by (invalid, token, row id) with K3
(csrc/topk_smallest.cu): ties go to the lower row id.

The full multi-key sort (``sort_permutation``) and top-k with k > 4,096
are not ported yet and raise ``NotImplementedError_`` naming them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.errors import NotImplementedError_
from . import _native

__all__ = ["order_token", "sort_permutation", "topk_permutation",
           "topk_key32", "topk_permutation32", "topk_smallest", "MAX_TOPK"]

MAX_TOPK = 4096
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_U32 = 0xFFFFFFFF
_CAND_BYTES = 16                   # struct Cand of csrc/topk_smallest.cu


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
    """u32 order key (int64 holding values in [0, 2^32)) when the sort value
    provably fits 32 bits: f32 values and <=32-bit integer types, or wider
    integers whose proven bounds span < 2^32 - 1.  None otherwise, and for
    nullable and dictionary columns."""
    if cv.validity is not None or cv.dictionary is not None:
        return None
    from ..core import dtypes as dt
    x = cv.data
    logical = dt.remove_nullable(cv.dtype).np_dtype
    if x.dtype == torch.float32:
        from .hash_ops import _order_map32
        key = _order_map32(x.view(torch.int32).to(torch.int64))
    elif x.dtype == torch.bool:
        key = x.to(torch.int64)
    elif logical.kind == "u" and logical.itemsize <= 4:
        key = x.to(torch.int64) & _U32
    elif logical.kind == "i" and logical.itemsize <= 4 \
            and not x.is_floating_point():
        key = (x.to(torch.int32).to(torch.int64) + (1 << 31)) & _U32
    elif logical.kind in ("i", "u") and not x.is_floating_point() \
            and getattr(cv, "bounds", None) is not None \
            and int(cv.bounds[1]) - int(cv.bounds[0]) < 2**32 - 1:
        # wide storage, but interval analysis proves a 32-bit span
        key = (x.to(torch.int64) - int(cv.bounds[0])) & _U32
    else:
        return None
    if descending:
        key = _U32 - key
    return key


def topk_permutation32(key32: torch.Tensor, row_valid: torch.Tensor, k: int
                       ) -> torch.Tensor:
    """Indices of the k smallest u32 keys among valid rows.  Keys clamp to
    2^32 - 2 and invalid rows take 2^32 - 1 (so valid keys 2^32 - 2 and
    2^32 - 1 tie, as in the reference); K3 then selects on the key."""
    n = key32.shape[0]
    k32 = torch.clamp(key32, max=_U32 - 1)
    k32 = torch.where(row_valid.to(torch.bool), k32,
                      torch.full_like(k32, _U32))
    out = topk_smallest(k32.contiguous(), None, k)
    return torch.clamp(out, max=n - 1)


def topk_permutation(token: torch.Tensor, row_valid: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """Indices of the k smallest tokens among valid rows (ascending by
    (invalid, token, row id)).  Validity is a separate key, never folded
    into the token."""
    return topk_smallest(token.contiguous(),
                         row_valid.to(torch.bool).contiguous(), k)


def topk_smallest(token: torch.Tensor, valid: Optional[torch.Tensor],
                  k: int) -> torch.Tensor:
    """K3: int64 indices of the k smallest rows by (invalid, token as
    unsigned 64-bit, row id); valid=None means every row is valid.  Only
    the first min(n_valid, k) indices are meaningful; the rest point at
    rows the caller masks.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    if k < 1:
        raise ValueError(f"topk_smallest: k={k}")
    if k > MAX_TOPK:
        raise NotImplementedError_(
            f"large-k top-k (k={k} > {MAX_TOPK}) is not ported to the CUDA "
            f"engine yet")
    if token.device.type == "cpu":
        return _topk_smallest_plain(token, valid, k)
    if token.device.type != "cuda":
        raise RuntimeError(f"topk_smallest: no kernel for {token.device}")
    return _topk_smallest_cuda(token, valid, k)


_STREAM_ROUND = 1024               # kRound of csrc/topk_smallest.cu


def _topk_tile(k: int) -> int:
    """Shared-memory tile of K3: a power of two >= 2k and >= k + 1024."""
    need = max(2 * k, k + _STREAM_ROUND, 2048)
    return 1 << (need - 1).bit_length()


def _topk_smallest_cuda(token, valid, k):
    n = token.shape[0]
    dev = token.device
    if token.dim() != 1 or token.dtype != torch.int64 \
            or not token.is_contiguous():
        raise ValueError("topk_smallest: token must be contiguous 1-d int64")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != token.shape
                              or valid.device != dev
                              or not valid.is_contiguous()):
        raise ValueError("topk_smallest: valid must be a contiguous bool "
                         "tensor of the token's shape and device")
    if not 1 <= n < _U32:
        raise ValueError(f"topk_smallest: {n} rows outside [1, 2^32 - 1)")
    tile = _topk_tile(k)
    nb = _native.grid_blocks(dev, n, threads=_STREAM_ROUND, per_sm=4)
    out = torch.empty((k,), dtype=torch.int64, device=dev)
    cands = nb * k if n > tile else 1
    scratch = torch.empty((2, cands * _CAND_BYTES), dtype=torch.uint8,
                          device=dev)
    lib = _native.library()
    rc = lib.chtt_topk_smallest(
        token.data_ptr(), valid.data_ptr() if valid is not None else None,
        n, k, tile, nb, out.data_ptr(), scratch[0].data_ptr(),
        scratch[1].data_ptr(), _native.stream_ptr(dev))
    _native.check(rc, "topk_smallest")
    _native.LAUNCHES["topk_smallest"] += 1
    return out


def _topk_smallest_plain(token, valid, k):
    """Plain PyTorch version of K3: stable sorts from the least significant
    key (row id order is the starting order), then the first k; indices
    past the row count clamp to the last row."""
    n = token.shape[0]
    perm = torch.sort(token ^ _SIGN, stable=True).indices
    if valid is not None:
        inv = (~valid.to(torch.bool)).to(torch.uint8)[perm]
        perm = perm[torch.sort(inv, stable=True).indices]
    out = perm[:k]
    if out.shape[0] < k:
        out = torch.cat([out, out.new_full((k - out.shape[0],), n - 1)])
    return out
