"""Routing between the PackedModel serving layouts and the kernels (port of
``repro/kernels/dispatch.py``).

The route follows the tensor: an operand on a CUDA device launches the
hand-written kernel (or raises where no kernel is ported yet), an operand
on the CPU takes the kernel's plain PyTorch version.  There is no switch
that sends a CUDA tensor to a plain version.  On the CPU the quantized
matmul routes are literally the dense layout's graph (``x @ decode``), so
dense / uint8 / packed serving agree bitwise there, as in the reference.

The reference's TPU block tables (``_PACKED_BLOCK_TABLE``,
``_PAGED_BLOCK_TABLE``) and its ``REPRO_PAGED_BLOCK`` override are not
carried over: each CUDA kernel picks its own tiles.  The blockwise-prefill
token tile is kept exactly, because the tile partition decides the bits
of the online softmax.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.compression import (PackedLayout, torch_dtype,
                                          unpack_indices_2d, unpack_rows)
from repro_torch.kernels import ref
from repro_torch.kernels.blockwise_prefill import blockwise_prefill
from repro_torch.kernels.blockwise_prefill_quant import \
    blockwise_prefill_quant
from repro_torch.kernels.codebook_matmul_packed import codebook_matmul_packed
from repro_torch.kernels.codebook_matmul_packed_t import \
    codebook_matmul_packed_t
# the page gather needs no routing of its own: the per-slot view of any
# pool dtype, dead slots masked to the trash page
from repro_torch.kernels.page_gather import page_gather
from repro_torch.kernels.paged_attention import paged_attention as \
    _paged_attention
from repro_torch.kernels.paged_attention_quant import \
    paged_attention_quant as _paged_attention_quant
from repro_torch.kernels.quantized_gather import quantized_gather as \
    _quantized_gather_rows

# Every kernel wrapper of the port, by kernel name; each carries its launch
# count as ``.launches``.
KERNELS = {
    "quantized_gather": _quantized_gather_rows,
    "codebook_matmul_packed": codebook_matmul_packed,
    "codebook_matmul_packed_t": codebook_matmul_packed_t,
    "blockwise_prefill": blockwise_prefill,
    "page_gather": page_gather,
    "paged_attention": _paged_attention,
    "blockwise_prefill_quant": blockwise_prefill_quant,
    "paged_attention_quant": _paged_attention_quant,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} has no CUDA kernel yet: "
                               f"ROADMAP.md {item}")


# ---------------------------------------------------------------------------
# Blockwise prefill
# ---------------------------------------------------------------------------

_PREFILL_BLOCK_TABLE: Dict[Tuple[str, int], int] = {
    ("dense", 12): 64,
    ("dense", 8): 64,
    ("dense", 44): 64,
    ("quant", 12): 8,
}

DEFAULT_PREFILL_TILE = 64


def prefill_token_tile(kind: str, feat: int,
                       page_size: Optional[int] = None) -> int:
    """KV-row tile of the blockwise prefill: ``REPRO_PREFILL_BLOCK`` →
    exact (kind, feat) entry → :data:`DEFAULT_PREFILL_TILE`; clamped to a
    divisor of ``page_size`` when given."""
    env = os.environ.get("REPRO_PREFILL_BLOCK")
    if env:
        try:
            tile = int(env)
        except ValueError as e:
            raise ValueError(f"REPRO_PREFILL_BLOCK={env!r}; expected an "
                             f"int token tile") from e
    else:
        tile = _PREFILL_BLOCK_TABLE.get((kind, feat), DEFAULT_PREFILL_TILE)
    tile = max(1, tile)
    if page_size is not None:
        tile = min(tile, page_size)
        while page_size % tile:
            tile -= 1
    return tile


def blockwise_prefill_attention(q, k, v, q_pos, k_pos, *,
                                window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                scale: float) -> torch.Tensor:
    """q [B,C,H,hd] vs a stored view k [B,S,KV,hd] / v [B,S,KV,vd] with
    1-D positions q_pos [C] / k_pos [S] → [B,C,H,vd] in the view dtype.
    The view is padded to a tile multiple with ``POS_SENTINEL`` rows here,
    on every device, so kernel and plain version reduce over the same
    tile partition."""
    tile = prefill_token_tile("dense", k.shape[-1])
    s = k.shape[1]
    k_pos = k_pos.to(torch.int32)
    pad = (-s) % tile
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), ref.POS_SENTINEL,
                                             dtype=torch.int32,
                                             device=k_pos.device)])
    out = blockwise_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                            q_pos, k_pos, window=window, softcap=softcap,
                            scale=scale, token_tile=tile)
    return out.to(v.dtype)


def blockwise_prefill_attention_quant(q, k_words, v_words, k_cb, v_cb,
                                      q_pos, k_pos, *, page_size: int,
                                      bits: int, head_dim: int,
                                      window: Optional[int] = None,
                                      softcap: Optional[float] = None,
                                      scale: float) -> torch.Tensor:
    """Chunked-prompt prefill over the slot's codebook-quantized pages:
    word view [B, S, KV, Wd] (S = npg·page_size, logical row order) +
    per-page codebooks [B, npg, Gcb, K] → [B, C, H, head_dim] in the
    codebook dtype.  The tile is ``prefill_token_tile("quant", head_dim,
    page_size=page_size)``, as in the reference: it divides the page, so
    the view needs no padding."""
    tile = prefill_token_tile("quant", head_dim, page_size=page_size)
    s = k_words.shape[1]
    if s % page_size:
        raise ValueError(f"quantized view rows {s} not a multiple of "
                         f"page_size={page_size}")
    out = blockwise_prefill_quant(
        q.contiguous(), k_words, v_words, k_cb.contiguous(),
        v_cb.contiguous(), q_pos, k_pos.to(torch.int32), page_size=page_size,
        bits=bits, head_dim=head_dim, window=window, softcap=softcap,
        scale=scale, token_tile=tile)
    return out.to(k_cb.dtype)


# ---------------------------------------------------------------------------
# Paged KV (continuous-batching engine, dense and quantized pages)
# ---------------------------------------------------------------------------

def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    pos: torch.Tensor, alive: torch.Tensor, *,
                    softcap: Optional[float] = None,
                    scale: float) -> torch.Tensor:
    """Paged GQA decode over dense KV pages: q [B,1,H,hd] + pools
    [P+1, page, KV, hd] → [B, 1, H·hd] in the pool dtype.  The CUDA kernel
    on the card, the reference's jnp math (gather, mask, softmax) on the
    CPU."""
    out = _paged_attention(q.contiguous(), k_pool, v_pool, page_table, pos,
                           alive, softcap=softcap, scale=scale)
    return out.to(k_pool.dtype)


def paged_attention_quant(q: torch.Tensor, k_words: torch.Tensor,
                          v_words: torch.Tensor, k_cb: torch.Tensor,
                          v_cb: torch.Tensor, page_table: torch.Tensor,
                          pos: torch.Tensor, alive: torch.Tensor, *,
                          bits: int, head_dim: int,
                          softcap: Optional[float] = None,
                          scale: float) -> torch.Tensor:
    """Paged GQA decode over codebook-quantized KV pages (bits/8 bytes per
    cached scalar): word pools [P+1, page, KV, Wd] + per-page codebooks
    [P+1, Gcb, K] → [B, 1, H·hd] in the codebook dtype."""
    out = _paged_attention_quant(q.contiguous(), k_words, v_words, k_cb,
                                 v_cb, page_table, pos, alive, bits=bits,
                                 head_dim=head_dim, softcap=softcap,
                                 scale=scale)
    return out.to(k_cb.dtype)


# ---------------------------------------------------------------------------
# Codebook matmuls
# ---------------------------------------------------------------------------

def packed_codebook_matmul(x: torch.Tensor, pidx: torch.Tensor,
                           codebook: torch.Tensor, *,
                           layout: Optional[PackedLayout] = None
                           ) -> torch.Tensor:
    """y[M, N] = x[M, Kd] · codebook[unpack(pidx)] over the
    ``pack_indices_2d`` word operand; ``layout`` is validated when given."""
    k = int(codebook.shape[-1])
    m, kd = x.shape
    n = pidx.shape[-1]
    if layout is not None and (layout.kd, layout.n, layout.k) != (kd, n, k):
        raise ValueError(f"packed layout {layout} does not match "
                         f"operands x[{m},{kd}] pidx[...,{n}] cb[{k}]")
    return codebook_matmul_packed(x, pidx, codebook)


def quantized_matmul(x: torch.Tensor, idx: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """x[..., Kd] · codebook[idx[Kd, N]] — the uint8 oracle layout; the
    dense graph on the CPU."""
    if x.is_cuda:
        raise _not_ported("the uint8-index matmul (codebook_matmul_pallas)",
                          "kernel row 11")
    return (x @ decode_leaf(idx, codebook)).to(x.dtype)


def packed_quantized_matmul(x: torch.Tensor, pidx: torch.Tensor,
                            codebook: torch.Tensor, *,
                            layout: Optional[PackedLayout] = None
                            ) -> torch.Tensor:
    """Batched-x entry of ``qleaf.qmatmul`` for the ``<name>_pidx``
    layout: the dense graph on the CPU, the packed kernel on the card."""
    if not x.is_cuda:
        if layout is None:
            raise ValueError("packed_quantized_matmul needs the "
                             "PackedLayout on the dequant route")
        return (x @ decode_packed_leaf(pidx, codebook, layout)).to(x.dtype)
    if pidx.ndim != 2 or (layout is not None
                          and (layout.shape is not None
                               or layout.order != "kd")):
        raise _not_ported("a grouped / non-matrix packed matmul "
                          "(MoE expert stacks)", "module 6")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float().contiguous()
    y = packed_codebook_matmul(x2, pidx, codebook, layout=layout)
    return y.reshape(lead + (y.shape[-1],)).to(x.dtype)


def packed_quantized_matmul_t(x: torch.Tensor, pidx: torch.Tensor,
                              codebook: torch.Tensor, *,
                              layout: PackedLayout) -> torch.Tensor:
    """y[..., V] = x[..., D] · codebook[unpack(pidx)]ᵀ — the fused tied LM
    head over a packed [V, D] leaf (either word order)."""
    if not x.is_cuda:
        w = decode_packed_leaf(pidx, codebook, layout)
        return (x @ w.transpose(-1, -2)).to(x.dtype)
    if pidx.ndim != 2 or layout.shape is not None or codebook.ndim != 1:
        raise _not_ported("a grouped / non-matrix transposed packed matmul",
                          "module 6")
    if tuple(pidx.shape) != layout.word_shape:
        raise ValueError(f"pidx {tuple(pidx.shape)} != layout word shape "
                         f"{layout.word_shape} ({layout})")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float().contiguous()
    y = codebook_matmul_packed_t(x2, pidx, codebook, layout.kd,
                                 order=layout.order)
    return y.reshape(lead + (layout.kd,)).to(x.dtype)


def quantized_gather(tokens: torch.Tensor, pidx: torch.Tensor,
                     codebook: torch.Tensor, *,
                     layout: PackedLayout) -> torch.Tensor:
    """Embedding dequant-on-gather ``codebook[unpack(pidx)[tokens]]``.

    ``layout.order == "row"`` (the serving layout): the fused gather
    kernel on the card, its plain version on the CPU.  ``"kd"`` (the
    column-packed layout): plain torch on every device, as in the
    reference — one full word per embedding column."""
    if layout.order == "row":
        out = _quantized_gather_rows(tokens.reshape(-1), pidx, codebook,
                                     layout.n)
        rows = out.reshape(tuple(tokens.shape) + (layout.n,))
    else:
        mask = (1 << layout.bits) - 1
        tok = tokens.long()
        words = pidx.view(torch.int32)[tok // layout.lanes].long()
        lane = (tok % layout.lanes) * layout.bits
        idx = (words >> lane[..., None]) & mask
        rows = codebook[idx]
    return rows if layout.dtype is None else rows.to(torch_dtype(layout.dtype))


# ---------------------------------------------------------------------------
# Dense reconstruction
# ---------------------------------------------------------------------------

def decode_leaf(idx: torch.Tensor, codebook: torch.Tensor,
                dtype=None) -> torch.Tensor:
    """Dense weight from (indices, codebook); a 2-D codebook is per-group
    ([G, K] against idx [G, ...])."""
    idx = idx.long()
    if codebook.ndim == 2:
        flat = idx.reshape(idx.shape[0], -1)
        w = torch.gather(codebook, 1, flat).reshape(idx.shape)
    else:
        w = codebook[idx]
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    return w.to(dtype) if dtype is not None else w


def decode_packed_leaf(pidx: torch.Tensor, codebook: torch.Tensor,
                       layout: PackedLayout, dtype=None) -> torch.Tensor:
    """Dense weight from the packed word operand (``pack_indices_2d``, or
    ``pack_rows`` when ``layout.order == "row"``; grouped leaves carry a
    leading G axis), reshaped to ``layout.shape`` when set."""
    if layout.order == "row":
        idx = unpack_rows(pidx, layout.n, layout.k)
    elif pidx.ndim == 3:
        idx = torch.stack([unpack_indices_2d(w, layout.kd, layout.k)
                           for w in pidx])
    else:
        idx = unpack_indices_2d(pidx, layout.kd, layout.k)
    if dtype is None:
        dtype = layout.dtype
    w = decode_leaf(idx, codebook, dtype)
    if layout.shape is not None:
        w = w.reshape(w.shape[:-2] + tuple(layout.shape))
    return w
