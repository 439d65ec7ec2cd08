"""GQA and MLA attention for serving: projections, the blockwise-prefill
block steps, the contiguous-cache decode steps and the engine's paged
steps over dense and codebook-quantized KV (or latent) pages (port of the
ported parts of ``repro/models/attention.py``).

Not ported yet (each raises or is absent): the full-sequence
``chunked_attention`` / ``gqa_forward`` / ``mla_forward`` training path
and sliding-window rings (ROADMAP.md modules 8 and 13).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import kvquant
from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import (decode_attention_ref,
                                     dequant_view_ref,
                                     mla_decode_attention_ref)
from repro_torch.models.layers import apply_rope, init_normal, rms_norm
from repro_torch.models.qleaf import qmatmul, qweight


def init_gqa(generator: torch.Generator, d_model: int, n_heads: int,
             n_kv: int, head_dim: int, qkv_bias: bool = False,
             dtype=torch.float32, device=None) -> dict:
    s = d_model ** -0.5
    p = {
        "wq": init_normal(generator, (d_model, n_heads * head_dim), s,
                          dtype, device),
        "wk": init_normal(generator, (d_model, n_kv * head_dim), s, dtype,
                          device),
        "wv": init_normal(generator, (d_model, n_kv * head_dim), s, dtype,
                          device),
        "wo": init_normal(generator, (n_heads * head_dim, d_model),
                          (n_heads * head_dim) ** -0.5, dtype, device),
    }
    if qkv_bias:
        p["q_bias"] = torch.zeros(n_heads * head_dim, dtype=dtype,
                                  device=device)
        p["k_bias"] = torch.zeros(n_kv * head_dim, dtype=dtype, device=device)
        p["v_bias"] = torch.zeros(n_kv * head_dim, dtype=dtype, device=device)
    return p


def _qkv(p, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int):
    """q/k/v projections (+ QKV bias); each weight may be dense or a
    quantized leaf."""
    b, s, _ = x.shape
    q = qmatmul(p, "wq", x)
    k = qmatmul(p, "wk", x)
    v = qmatmul(p, "wv", x)
    if "q_bias" in p:
        q, k, v = q + p["q_bias"], k + p["k_bias"], v + p["v_bias"]
    return (q.reshape(b, s, n_heads, head_dim),
            k.reshape(b, s, n_kv, head_dim),
            v.reshape(b, s, n_kv, head_dim))


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, C, KV, hd]
    v: torch.Tensor


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype=torch.float32, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros(batch, capacity, n_kv, head_dim, dtype=dtype,
                      device=device),
        v=torch.zeros(batch, capacity, n_kv, head_dim, dtype=dtype,
                      device=device))


def gqa_prefill_block(p, x: torch.Tensor, buf_k: torch.Tensor,
                      buf_v: torch.Tensor, start: int, *, n_heads: int,
                      n_kv: int, head_dim: int, window=None,
                      attn_softcap=None, rope_theta: float = 10000.0,
                      query_scale=None):
    """One prompt block of a global GQA layer: append the block's K/V to
    the growing buffers ([B, start, KV, hd] → [B, start+c, ...]) and attend
    over them with the blockwise-prefill kernel.  Returns (out, bk, bv)."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    t = start + torch.arange(c, device=x.device)
    q = apply_rope(q, t[None, :], rope_theta)
    k = apply_rope(k, t[None, :], rope_theta)
    bk = torch.cat([buf_k, k.to(buf_k.dtype)], dim=1)
    bv = torch.cat([buf_v, v.to(buf_v.dtype)], dim=1)
    scale = query_scale if query_scale is not None else head_dim ** -0.5
    o = dispatch.blockwise_prefill_attention(
        q, bk, bv, t, torch.arange(bk.shape[1], device=x.device),
        window=window, softcap=attn_softcap, scale=scale)
    return qmatmul(p, "wo", o.reshape(b, c, n_heads * head_dim)), bk, bv


def gqa_decode(p, x_t: torch.Tensor, cache: KVCache, pos: int, *,
               n_heads: int, n_kv: int, head_dim: int, ring: bool = False,
               window=None, attn_softcap=None, rope_theta: float = 10000.0,
               query_scale=None):
    """One-token decode over a contiguous cache.  x_t [B,1,D]; ``pos`` the
    position written.  Plain torch (the reference calls no kernel here).

    The cache is updated in place (row ``pos`` of k and v) rather than
    copied, and returned."""
    if ring:
        raise NotImplementedError("sliding-window ring decode is not ported "
                                  "yet: ROADMAP.md module 8")
    q, k, v = _qkv(p, x_t, n_heads, n_kv, head_dim)
    pos_arr = torch.tensor([pos], device=x_t.device)
    q = apply_rope(q, pos_arr[None, :], rope_theta)
    k = apply_rope(k, pos_arr[None, :], rope_theta)
    cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v[:, 0].to(cache.v.dtype)

    idx = torch.arange(cache.k.shape[1], device=x_t.device)
    valid = idx <= pos
    if window is not None:
        valid &= idx > pos - window
    scale = query_scale if query_scale is not None else head_dim ** -0.5
    o = decode_attention_ref(q, cache.k, cache.v, valid[None],
                             softcap=attn_softcap, scale=scale)
    return qmatmul(p, "wo", o.to(x_t.dtype)), cache


# ---------------------------------------------------------------------------
# Paged / slot-aware steps (continuous-batching engine)
#
# Global-attention layers store KV in a pool of fixed-size pages shared by
# all batch slots; a per-slot page table maps logical position t to the
# physical cell (table[slot, t // page], t % page).  Physical page 0 is the
# trash page: dead slots (and unallocated logical pages) point at it, so one
# decode step serves any admission / eviction state with the same shapes.
# Where the reference returns new pools, the port writes them in place
# (``index_put_``) and returns the same cache.  Many dead slots may write
# the trash page's cell at once.  The card resolves duplicate indices of a
# scatter in no fixed order, so every write first takes the value of the
# last row (in row order) that targets its cell (:func:`_last_writer`):
# duplicates then carry equal values and the pools hold what a serial
# write leaves, page 0 included, on both devices.  The writes are issued
# before the attention reads them, on the same stream.
# ---------------------------------------------------------------------------


class PagedKVCache(NamedTuple):
    k: torch.Tensor          # [n_pages + 1, page, KV, hd]  (page 0 = trash)
    v: torch.Tensor


def init_paged_kv_cache(n_pages: int, page_size: int, n_kv: int,
                        head_dim: int, dtype=torch.float32,
                        device=None) -> PagedKVCache:
    shape = (n_pages + 1, page_size, n_kv, head_dim)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def _last_writer(cell: torch.Tensor, n_cells: int) -> torch.Tensor:
    """For each row of ``cell`` [*I] (flat cell ids below ``n_cells``), the
    flat index of the last row, in row order, with the same cell: a scatter
    that gives every row that row's value writes equal values to a
    duplicated cell, so it leaves what a serial write leaves whatever order
    the device resolves duplicates in.  No host read: a ``scatter_reduce``
    (amax) of row numbers, then a gather."""
    flat = cell.reshape(-1)
    rows = torch.arange(flat.numel(), device=flat.device)
    last = torch.empty(n_cells, dtype=torch.long, device=flat.device)
    last.scatter_reduce_(0, flat, rows, "amax", include_self=False)
    return last[flat].reshape(cell.shape)


def _take_rows(values: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``values`` [*I, ...] with row i replaced by flat row ``src[i]``."""
    lead = values.reshape((src.numel(),) + values.shape[src.ndim:])
    return lead[src.reshape(-1)].reshape(values.shape)


class PageWrites(NamedTuple):
    """Where a step's page writes land: cells (phys, off) [*I] and, per
    row, the row whose value it stores (:func:`_last_writer`).  The same for
    every layer of a stack and for K and V, so an engine step computes it
    once (:func:`slot_writes`, :func:`block_writes`)."""
    phys: torch.Tensor
    off: torch.Tensor
    src: torch.Tensor


def _page_writes(phys, off, page_size: int, n_pages: int) -> PageWrites:
    return PageWrites(phys, off,
                      _last_writer(phys * page_size + off, n_pages * page_size))


def slot_writes(page_table: torch.Tensor, pos: torch.Tensor,
                alive: torch.Tensor, page_size: int,
                n_pages: int) -> PageWrites:
    """One decode write per slot, [B]: slot b writes logical position
    pos[b] of its pages; dead (or page-starved) slots write the trash page.
    ``n_pages`` counts the pool's pages, the trash page included."""
    b, npg = page_table.shape
    pos = pos.long()
    pg = torch.clamp(pos // page_size, 0, npg - 1)
    phys = page_table.long()[torch.arange(b, device=pos.device), pg]
    phys = torch.where(alive.bool(), phys, 0)
    return _page_writes(phys, pos % page_size, page_size, n_pages)


def block_writes(page_table: torch.Tensor, start, alive: torch.Tensor,
                 c: int, page_size: int, n_pages: int) -> PageWrites:
    """``c`` consecutive writes per slot from logical position ``start``
    (an int or [B]), [B, c]; dead slots write the trash page."""
    b, npg = page_table.shape
    dev = page_table.device
    start = torch.as_tensor(start, device=dev).long().reshape(-1)
    t = start.expand(b)[:, None] + torch.arange(c, device=dev)[None, :]
    pg = torch.clamp(t // page_size, 0, npg - 1)
    phys = page_table.long()[torch.arange(b, device=dev)[:, None], pg]
    phys = torch.where(alive.bool()[:, None], phys, 0)
    return _page_writes(phys, t % page_size, page_size, n_pages)


def _write_slot(pool: torch.Tensor, page_table: torch.Tensor,
                pos: torch.Tensor, alive: torch.Tensor, new: torch.Tensor,
                page_size: int,
                writes: Optional[PageWrites] = None) -> torch.Tensor:
    """Scatter one new entry per slot into its current page, in place.

    pool [P+1, page, ...]; page_table [B, npg]; pos / alive [B];
    new [B, ...].  Dead (or page-starved) slots write the trash page.
    ``writes``: the step's :func:`slot_writes`, when the caller made it."""
    w = writes if writes is not None else slot_writes(
        page_table, pos, alive, page_size, pool.shape[0])
    pool[w.phys, w.off] = _take_rows(new, w.src).to(pool.dtype)
    return pool


def _write_block_slot(pool: torch.Tensor, page_table: torch.Tensor, start,
                      alive: torch.Tensor, new: torch.Tensor,
                      page_size: int,
                      writes: Optional[PageWrites] = None) -> torch.Tensor:
    """Blockwise twin of ``_write_slot``: scatter ``c`` consecutive
    entries per slot from logical position ``start`` (an int or [B]), in
    place.  new [B, c, ...].  Dead slots write the trash page.  ``writes``:
    the step's :func:`block_writes`, when the caller made it."""
    w = writes if writes is not None else block_writes(
        page_table, start, alive, new.shape[1], page_size, pool.shape[0])
    pool[w.phys, w.off] = _take_rows(new, w.src).to(pool.dtype)
    return pool


def _gather_slots(pool: torch.Tensor, page_table: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """Logical KV view per slot: [B, npg·page, ...].  Dead slots' table
    rows read the trash page (the page-gather kernel on the card, its
    plain version on the CPU)."""
    return dispatch.page_gather(pool, page_table, alive)


def gqa_decode_paged(p, x_t: torch.Tensor, cache: PagedKVCache,
                     page_table: torch.Tensor, pos: torch.Tensor,
                     alive: torch.Tensor, *, n_heads: int, n_kv: int,
                     head_dim: int, page_size: int, attn_softcap=None,
                     rope_theta: float = 10000.0, query_scale=None,
                     writes: Optional[PageWrites] = None):
    """One-token GQA decode for a batch of engine slots.

    x_t [B,1,D]; page_table [B, npg] int32; pos [B] per-slot write
    positions; alive [B] bool (dead slots: reads fully masked, writes land
    on the trash page); ``writes`` the step's :func:`slot_writes` when the
    caller made it.  Returns (out [B,1,D], cache) — the pools are written
    in place."""
    q, k, v = _qkv(p, x_t, n_heads, n_kv, head_dim)
    posb = pos[:, None]
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    _write_slot(cache.k, page_table, pos, alive, k[:, 0], page_size, writes)
    _write_slot(cache.v, page_table, pos, alive, v[:, 0], page_size, writes)
    scale = query_scale if query_scale is not None else head_dim ** -0.5
    o = dispatch.paged_attention(q, cache.k, cache.v, page_table, pos, alive,
                                 softcap=attn_softcap, scale=scale)
    return qmatmul(p, "wo", o.to(x_t.dtype)), cache


def gqa_prefill_block_paged(p, x: torch.Tensor, cache: PagedKVCache,
                            page_table: torch.Tensor, start: int,
                            alive: torch.Tensor, *, n_heads: int, n_kv: int,
                            head_dim: int, page_size: int, attn_softcap=None,
                            rope_theta: float = 10000.0, query_scale=None,
                            writes: Optional[PageWrites] = None):
    """One prompt block of a paged GQA layer.

    x [B,c,D]; ``start`` the block's first logical position.  Writes the
    block's K/V into the slot's pages (``writes``: the step's
    :func:`block_writes` when the caller made it), then attends the
    block's queries over the gathered page view through the
    blockwise-prefill route — rows past ``start + c`` are future or stale
    and mask out causally (row index == position).  Returns (out [B,c,D],
    cache)."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    t = start + torch.arange(c, device=x.device)
    q = apply_rope(q, t[None, :], rope_theta)
    k = apply_rope(k, t[None, :], rope_theta)
    _write_block_slot(cache.k, page_table, start, alive, k, page_size, writes)
    _write_block_slot(cache.v, page_table, start, alive, v, page_size, writes)
    view_k = _gather_slots(cache.k, page_table, alive)     # [B,cap,KV,hd]
    view_v = _gather_slots(cache.v, page_table, alive)
    scale = query_scale if query_scale is not None else head_dim ** -0.5
    o = dispatch.blockwise_prefill_attention(
        q, view_k, view_v, t, torch.arange(view_k.shape[1], device=x.device),
        softcap=attn_softcap, scale=scale)
    return qmatmul(p, "wo", o.reshape(b, c, n_heads * head_dim)), cache


# --- codebook-quantized paged KV (kv_bits ∈ {2, 4, 8}) ----------------------
#
# Pages store bit-packed codebook indices (``core.kvquant``'s pack_rows
# layout, int32 bit patterns) plus per-page codebooks fit at write time.
# Freeze-on-first-write: a page's codebook is fit exactly once, from the
# token row written at its offset 0, and every later write into the page
# assigns against the frozen codebook.  Storage is therefore a pure
# function of the written values, and the stored value is
# ``cb[assign(v, cb)]`` exactly.
#
# The reference fits a codebook for every written row and keeps the fit
# only at offset 0; its blockwise write scans the block token by token.  A
# fit depends on its own row alone, so the port fits only the rows that
# start a page (known on the host from the positions), K and V together in
# one batched fit, writes those codebooks, and then assigns, packs and
# scatters the whole block at once against each token's page codebook: the
# same bits, provided a block writes each page's offset 0 at most once and
# before the page's other rows, which ascending positions guarantee.


class QuantPagedKVCache(NamedTuple):
    k_words: torch.Tensor    # [n_pages + 1, page, KV, Wd] int32 words
    v_words: torch.Tensor
    k_cb: torch.Tensor       # [n_pages + 1, Gcb, K]; Gcb = KV | 1
    v_cb: torch.Tensor


def init_quant_paged_kv_cache(n_pages: int, page_size: int, n_kv: int,
                              head_dim: int, bits: int, cb_mode: str,
                              dtype=torch.float32,
                              device=None) -> QuantPagedKVCache:
    wd = kvquant.words_per(head_dim, kvquant.check_kv_bits(bits))
    gcb = n_kv if cb_mode == "head" else 1
    wshape = (n_pages + 1, page_size, n_kv, wd)
    cshape = (n_pages + 1, gcb, kvquant.kv_entries(bits))
    return QuantPagedKVCache(
        k_words=torch.zeros(wshape, dtype=torch.int32, device=device),
        v_words=torch.zeros(wshape, dtype=torch.int32, device=device),
        k_cb=torch.zeros(cshape, dtype=dtype, device=device),
        v_cb=torch.zeros(cshape, dtype=dtype, device=device))


def _quant_groups(new: torch.Tensor, cb_mode: str) -> torch.Tensor:
    """Token rows [..., KV, hd] → codebook groups [..., Gcb, N]: one group
    per kv head ("head") or one per row ("page")."""
    if cb_mode == "head":
        return new
    return new.reshape(new.shape[:-2] + (1, new.shape[-2] * new.shape[-1]))


def fit_first_rows(k_rows: torch.Tensor, v_rows: torch.Tensor, bits: int,
                   cb_mode: str, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codebooks of the rows that start a page, K and V in one batched fit:
    k_rows / v_rows [F, KV, hd] → ([F, Gcb, K], [F, Gcb, K])."""
    f = k_rows.shape[0]
    grp = torch.cat([_quant_groups(k_rows, cb_mode),
                     _quant_groups(v_rows, cb_mode)])
    cbs = kvquant.fit_codebooks(grp, bits).to(dtype)
    return cbs[:f], cbs[f:]


def first_write_slots(pos: torch.Tensor, page_size: int) -> torch.Tensor:
    """Slots whose decode write starts a page, as a long tensor on
    ``pos``'s device (the positions are read on the host)."""
    rows = [i for i, p in enumerate(pos.tolist()) if p % page_size == 0]
    return torch.tensor(rows, dtype=torch.long, device=pos.device)


def first_block_rows(start: int, c: int, page_size: int) -> slice:
    """The offsets in a block of ``c`` tokens from ``start`` that start a
    page, as a slice (a view, no index tensor)."""
    return slice((-start) % page_size, c, page_size)


def _write_rows_quant(words: torch.Tensor, cbs: torch.Tensor,
                      phys: torch.Tensor, off: torch.Tensor,
                      alive: torch.Tensor, new: torch.Tensor, bits: int,
                      cb_mode: str, first, cb_fit: Optional[torch.Tensor],
                      src: torch.Tensor):
    """Write token rows ``new`` [*I, KV, hd] at cells (phys, off) [*I].
    ``first`` indexes (into *I) the rows that start a page and ``cb_fit``
    holds their fitted codebooks; each replaces its page's codebook where
    the row's slot is alive (``alive`` [*I]).  Then every row is assigned
    against its page's codebook, packed and scattered, in place; a cell
    written twice keeps the last row's words (``src`` [*I]: the cells'
    :func:`_last_writer`)."""
    if cb_fit is not None:
        pf = phys[first]
        keep = cbs[pf]
        cbs[pf] = _take_rows(torch.where(alive[first][..., None, None],
                                         cb_fit, keep),
                             _last_writer(pf, cbs.shape[0]))
    grp = _quant_groups(new, cb_mode)
    idx = kvquant.assign_codebook(grp, cbs[phys])
    packed = kvquant.pack_rows_torch(idx.reshape(new.shape), bits)
    words[phys, off] = _take_rows(packed, src)
    return words, cbs


def _write_slot_quant(words: torch.Tensor, cbs: torch.Tensor,
                      page_table: torch.Tensor, pos: torch.Tensor,
                      alive: torch.Tensor, new: torch.Tensor, page_size: int,
                      bits: int, cb_mode: str,
                      fit: Optional[Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]] = None,
                      writes: Optional[PageWrites] = None):
    """Quantizing twin of ``_write_slot``, in place: words [P+1, page, KV,
    Wd]; cbs [P+1, Gcb, K]; new [B, KV, hd].  A live slot writing offset 0
    of a page fits that page's codebook from its row and freezes it;
    other writes assign against the frozen one.  Dead slots write the
    trash page and never refit it.  ``fit`` = (slots [F] long, codebooks
    [F, Gcb, K] or None when F = 0) carries the fits of the slots that
    start a page when the caller made them (K and V together); without it
    they are found from ``pos`` (a host read) and fit here.  ``writes``:
    the step's :func:`slot_writes`, when the caller made it.  Returns
    (words, cbs)."""
    w = writes if writes is not None else slot_writes(
        page_table, pos, alive, page_size, words.shape[0])
    if fit is None:
        rows = first_write_slots(pos, page_size)
        cb_fit = (kvquant.fit_codebooks(_quant_groups(new[rows], cb_mode),
                                        bits).to(cbs.dtype)
                  if rows.numel() else None)
    else:
        rows, cb_fit = fit
    return _write_rows_quant(words, cbs, w.phys, w.off, alive.bool(), new,
                             bits, cb_mode, (rows,), cb_fit, w.src)


def _write_block_slot_quant(words: torch.Tensor, cbs: torch.Tensor,
                            page_table: torch.Tensor, start: int,
                            alive: torch.Tensor, new: torch.Tensor,
                            page_size: int, bits: int, cb_mode: str,
                            fit: Optional[torch.Tensor] = None,
                            writes: Optional[PageWrites] = None):
    """Blockwise twin of ``_write_slot_quant``, in place: ``c`` tokens per
    slot from logical position ``start`` (an int, shared by the slots);
    new [B, c, KV, hd].  The block's rows at page offset 0 fit their
    pages' codebooks (``fit`` [B, F, Gcb, K] when the caller made them,
    for the offsets of :func:`first_block_rows`), then every token is
    assigned against its page's codebook: the reference's token-by-token
    scan, written at once.  ``writes``: the step's :func:`block_writes`,
    when the caller made it.  Returns (words, cbs)."""
    b, c = new.shape[0], new.shape[1]
    w = writes if writes is not None else block_writes(
        page_table, int(start), alive, c, page_size, words.shape[0])
    js = first_block_rows(int(start), c, page_size)
    n_first = len(range(c)[js])
    if n_first and fit is None:
        fit = kvquant.fit_codebooks(_quant_groups(new[:, js], cb_mode),
                                    bits).to(cbs.dtype)
    live = alive.bool()[:, None].expand(b, c)
    return _write_rows_quant(words, cbs, w.phys, w.off, live, new, bits,
                             cb_mode, (slice(None), js),
                             fit if n_first else None, w.src)


def gqa_decode_paged_quant(p, x_t: torch.Tensor, cache: QuantPagedKVCache,
                           page_table: torch.Tensor, pos: torch.Tensor,
                           alive: torch.Tensor, *, n_heads: int, n_kv: int,
                           head_dim: int, page_size: int, kv_bits: int,
                           kv_cb_mode: str = "page", attn_softcap=None,
                           rope_theta: float = 10000.0, query_scale=None,
                           fit_slots: Optional[torch.Tensor] = None,
                           writes: Optional[PageWrites] = None):
    """``gqa_decode_paged`` over codebook-quantized KV pages.  The written
    token is quantized before it is attended, so the kernel reads exactly
    what the cache stores.  ``fit_slots`` ([F] long, on the device) lists
    the slots whose write starts a page (the engine knows them); without
    it they are read from ``pos`` on the host.  ``writes`` as in
    :func:`gqa_decode_paged`.  Returns (out [B,1,D], cache), written in
    place."""
    q, k, v = _qkv(p, x_t, n_heads, n_kv, head_dim)
    posb = pos[:, None]
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    rows = (fit_slots if fit_slots is not None
            else first_write_slots(pos, page_size))
    fk = fv = None
    if rows.numel():
        fk, fv = fit_first_rows(k[rows, 0], v[rows, 0], kv_bits, kv_cb_mode,
                                cache.k_cb.dtype)
    _write_slot_quant(cache.k_words, cache.k_cb, page_table, pos, alive,
                      k[:, 0], page_size, kv_bits, kv_cb_mode, fit=(rows, fk),
                      writes=writes)
    _write_slot_quant(cache.v_words, cache.v_cb, page_table, pos, alive,
                      v[:, 0], page_size, kv_bits, kv_cb_mode, fit=(rows, fv),
                      writes=writes)
    scale = query_scale if query_scale is not None else head_dim ** -0.5
    o = dispatch.paged_attention_quant(
        q, cache.k_words, cache.v_words, cache.k_cb, cache.v_cb, page_table,
        pos, alive, bits=kv_bits, head_dim=head_dim, softcap=attn_softcap,
        scale=scale)
    return qmatmul(p, "wo", o.to(x_t.dtype)), cache


def gqa_prefill_block_paged_quant(p, x: torch.Tensor,
                                  cache: QuantPagedKVCache,
                                  page_table: torch.Tensor, start: int,
                                  alive: torch.Tensor, *, n_heads: int,
                                  n_kv: int, head_dim: int, page_size: int,
                                  kv_bits: int, kv_cb_mode: str = "page",
                                  attn_softcap=None,
                                  rope_theta: float = 10000.0,
                                  query_scale=None,
                                  writes: Optional[PageWrites] = None):
    """``gqa_prefill_block_paged`` over codebook-quantized KV pages: the
    block's K/V rows are quantized into the slot's pages, then the block's
    queries attend over the stored words (page-gathered, with each page's
    codebooks) through the quantized blockwise-prefill route.  ``writes``
    as in :func:`gqa_prefill_block_paged`.  Returns (out [B,c,D], cache),
    written in place."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    t = start + torch.arange(c, device=x.device)
    q = apply_rope(q, t[None, :], rope_theta)
    k = apply_rope(k, t[None, :], rope_theta)
    js = first_block_rows(start, c, page_size)
    n_first = len(range(c)[js])
    fk = fv = None
    if n_first:
        fk, fv = fit_first_rows(k[:, js].reshape((-1,) + k.shape[2:]),
                                v[:, js].reshape((-1,) + v.shape[2:]),
                                kv_bits, kv_cb_mode, cache.k_cb.dtype)
        fk = fk.reshape((b, n_first) + fk.shape[1:])
        fv = fv.reshape((b, n_first) + fv.shape[1:])
    _write_block_slot_quant(cache.k_words, cache.k_cb, page_table, start,
                            alive, k, page_size, kv_bits, kv_cb_mode, fit=fk,
                            writes=writes)
    _write_block_slot_quant(cache.v_words, cache.v_cb, page_table, start,
                            alive, v, page_size, kv_bits, kv_cb_mode, fit=fv,
                            writes=writes)
    kw_view = _gather_slots(cache.k_words, page_table, alive)  # [B,cap,KV,Wd]
    vw_view = _gather_slots(cache.v_words, page_table, alive)
    masked = torch.where(alive.bool()[:, None], page_table.long(), 0)
    scale = query_scale if query_scale is not None else head_dim ** -0.5
    o = dispatch.blockwise_prefill_attention_quant(
        q, kw_view, vw_view, cache.k_cb[masked], cache.v_cb[masked], t,
        torch.arange(kw_view.shape[1], device=x.device), page_size=page_size,
        bits=kv_bits, head_dim=head_dim, softcap=attn_softcap, scale=scale)
    return qmatmul(p, "wo", o.reshape(b, c, n_heads * head_dim)), cache


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention
#
# A layer caches one latent row per token: c_kv [kv_lora] (the normalised
# down-projection) and k_rope [rope_dim] (its rotary key), shared by every
# head.  Decode attends in the latent space (the absorbed form: q_eff =
# q_nope · W_UK, logits = q_eff · c + q_rope · r, context = attn · c, then
# W_UV); prefill re-expands the latent view through W_UK / W_UV and runs
# the dense blockwise-prefill route with keys of width nope + rope and
# values of width v_dim.
# ---------------------------------------------------------------------------

def init_mla(generator: torch.Generator, d_model: int, n_heads: int, *,
             kv_lora: int, rope_dim: int, nope_dim: int, v_dim: int,
             dtype=torch.float32, device=None) -> dict:
    s = d_model ** -0.5
    qdim = n_heads * (nope_dim + rope_dim)
    return {
        "wq": init_normal(generator, (d_model, qdim), s, dtype, device),
        "w_dkv": init_normal(generator, (d_model, kv_lora + rope_dim), s,
                             dtype, device),
        "w_uk": init_normal(generator, (kv_lora, n_heads * nope_dim),
                            kv_lora ** -0.5, dtype, device),
        "w_uv": init_normal(generator, (kv_lora, n_heads * v_dim),
                            kv_lora ** -0.5, dtype, device),
        "wo": init_normal(generator, (n_heads * v_dim, d_model),
                          (n_heads * v_dim) ** -0.5, dtype, device),
        "kv_norm_scale": torch.zeros(kv_lora, dtype=dtype, device=device),
    }


def _mla_q(p, x: torch.Tensor, n_heads: int, nope_dim: int, rope_dim: int,
           positions: torch.Tensor, rope_theta: float):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope]); positions broadcast
    against [B, S] ([1, S] for a block, [B, 1] for a per-slot step)."""
    b, s, _ = x.shape
    q = qmatmul(p, "wq", x).reshape(b, s, n_heads, nope_dim + rope_dim)
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    return q_nope, apply_rope(q_rope, positions, rope_theta)


def _mla_latent(p, x: torch.Tensor, kv_lora: int, positions: torch.Tensor,
                rope_theta: float):
    """The rows the layer caches: (c_kv [B,S,kv_lora], k_rope
    [B,S,rope_dim])."""
    dkv = qmatmul(p, "w_dkv", x)
    c_kv = rms_norm(dkv[..., :kv_lora], p["kv_norm_scale"])
    k_rope = apply_rope(dkv[..., None, kv_lora:], positions,
                        rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_absorb_q(p, q_nope: torch.Tensor, kv_lora: int, n_heads: int,
                  nope_dim: int) -> torch.Tensor:
    """q_eff = q_nope · W_UK per head: [B,1,H,nope] → [B,1,H,kv_lora]."""
    w_uk = qweight(p, "w_uk").reshape(kv_lora, n_heads, nope_dim)
    return torch.einsum("bqhd,lhd->bqhl", q_nope, w_uk)


def _mla_out(p, ctx: torch.Tensor, kv_lora: int, n_heads: int,
             v_dim: int) -> torch.Tensor:
    """Latent context [B,1,H,kv_lora] → W_UV per head → W_O."""
    b = ctx.shape[0]
    w_uv = qweight(p, "w_uv").reshape(kv_lora, n_heads, v_dim)
    o = torch.einsum("bqhl,lhd->bqhd", ctx, w_uv).reshape(b, 1,
                                                         n_heads * v_dim)
    return qmatmul(p, "wo", o)


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # [B, C, kv_lora]
    k_rope: torch.Tensor     # [B, C, rope_dim]


def init_mla_cache(batch: int, capacity: int, kv_lora: int, rope_dim: int,
                   dtype=torch.float32, device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros(batch, capacity, kv_lora, dtype=dtype,
                         device=device),
        k_rope=torch.zeros(batch, capacity, rope_dim, dtype=dtype,
                           device=device))


def mla_decode(p, x_t: torch.Tensor, cache: MLACache, pos: int, *,
               n_heads: int, kv_lora: int, rope_dim: int, nope_dim: int,
               v_dim: int, rope_theta: float = 10000.0):
    """Absorbed one-token decode over a contiguous latent cache, in plain
    torch (the reference calls no kernel here; the engine's paged decode
    shares its attention routine).  The cache row ``pos`` is written in
    place.  Returns (out [B,1,D], cache)."""
    positions = torch.tensor([[pos]], device=x_t.device)
    q_nope, q_rope = _mla_q(p, x_t, n_heads, nope_dim, rope_dim, positions,
                            rope_theta)
    c_kv, k_rope = _mla_latent(p, x_t, kv_lora, positions, rope_theta)
    cache.c_kv[:, pos] = c_kv[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, pos] = k_rope[:, 0].to(cache.k_rope.dtype)
    q_eff = _mla_absorb_q(p, q_nope, kv_lora, n_heads, nope_dim)
    valid = torch.arange(cache.c_kv.shape[1], device=x_t.device) <= pos
    ctx = mla_decode_attention_ref(q_eff, q_rope, cache.c_kv, cache.k_rope,
                                   valid[None],
                                   scale=(nope_dim + rope_dim) ** -0.5)
    return _mla_out(p, ctx, kv_lora, n_heads, v_dim), cache


def _mla_block_attend(p, q_nope: torch.Tensor, q_rope: torch.Tensor,
                      c_view: torch.Tensor, r_view: torch.Tensor,
                      t: torch.Tensor, *, n_heads: int, nope_dim: int,
                      rope_dim: int, v_dim: int) -> torch.Tensor:
    """Expand a latent view [B,S,kv_lora] / [B,S,rope] through W_UK / W_UV
    (row-wise, so a row's keys do not depend on the view's length) and
    attend one block's queries over it: [B,c,H,v_dim]."""
    b, s = c_view.shape[0], c_view.shape[1]
    k_nope = qmatmul(p, "w_uk", c_view).reshape(b, s, n_heads, nope_dim)
    v = qmatmul(p, "w_uv", c_view).reshape(b, s, n_heads, v_dim)
    k = torch.cat([k_nope, r_view[:, :, None, :].expand(b, s, n_heads,
                                                        rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return dispatch.blockwise_prefill_attention(
        q, k, v, t, torch.arange(s, device=t.device),
        scale=(nope_dim + rope_dim) ** -0.5)


def mla_prefill_block(p, x: torch.Tensor, buf_c: torch.Tensor,
                      buf_r: torch.Tensor, start: int, *, n_heads: int,
                      kv_lora: int, rope_dim: int, nope_dim: int, v_dim: int,
                      rope_theta: float = 10000.0):
    """One prompt block of an MLA layer on the one-shot side: append the
    block's latent rows to the growing buffers and attend over the
    re-expansion of the result.  Returns (out [B,c,D], buf_c, buf_r)."""
    b, c, _ = x.shape
    t = start + torch.arange(c, device=x.device)
    q_nope, q_rope = _mla_q(p, x, n_heads, nope_dim, rope_dim, t[None, :],
                            rope_theta)
    c_kv, k_rope = _mla_latent(p, x, kv_lora, t[None, :], rope_theta)
    bc = torch.cat([buf_c, c_kv.to(buf_c.dtype)], dim=1)
    br = torch.cat([buf_r, k_rope.to(buf_r.dtype)], dim=1)
    o = _mla_block_attend(p, q_nope, q_rope, bc, br, t, n_heads=n_heads,
                          nope_dim=nope_dim, rope_dim=rope_dim, v_dim=v_dim)
    return qmatmul(p, "wo", o.reshape(b, c, n_heads * v_dim)), bc, br


# --- paged latent pages (continuous-batching engine) ------------------------

class PagedMLACache(NamedTuple):
    c_kv: torch.Tensor       # [n_pages + 1, page, kv_lora]  (page 0 = trash)
    k_rope: torch.Tensor     # [n_pages + 1, page, rope_dim]


def init_paged_mla_cache(n_pages: int, page_size: int, kv_lora: int,
                         rope_dim: int, dtype=torch.float32,
                         device=None) -> PagedMLACache:
    return PagedMLACache(
        c_kv=torch.zeros(n_pages + 1, page_size, kv_lora, dtype=dtype,
                         device=device),
        k_rope=torch.zeros(n_pages + 1, page_size, rope_dim, dtype=dtype,
                           device=device))


def mla_decode_paged(p, x_t: torch.Tensor, cache: PagedMLACache,
                     page_table: torch.Tensor, pos: torch.Tensor,
                     alive: torch.Tensor, *, n_heads: int, kv_lora: int,
                     rope_dim: int, nope_dim: int, v_dim: int,
                     page_size: int, rope_theta: float = 10000.0,
                     writes: Optional[PageWrites] = None):
    """Absorbed MLA decode for a batch of engine slots over the paged
    latent cache (per-slot ``pos``; dead slots write the trash page;
    ``writes`` as in :func:`gqa_decode_paged`).  Attention runs through
    the MLA paged-decode route.  Returns (out [B,1,D], cache) — the pools
    are written in place."""
    posb = pos[:, None]
    q_nope, q_rope = _mla_q(p, x_t, n_heads, nope_dim, rope_dim, posb,
                            rope_theta)
    c_kv, k_rope = _mla_latent(p, x_t, kv_lora, posb, rope_theta)
    _write_slot(cache.c_kv, page_table, pos, alive, c_kv[:, 0], page_size,
                writes)
    _write_slot(cache.k_rope, page_table, pos, alive, k_rope[:, 0],
                page_size, writes)
    q_eff = _mla_absorb_q(p, q_nope, kv_lora, n_heads, nope_dim)
    ctx = dispatch.mla_paged_attention(
        q_eff, q_rope, cache.c_kv, cache.k_rope, page_table, pos, alive,
        scale=(nope_dim + rope_dim) ** -0.5)
    return _mla_out(p, ctx, kv_lora, n_heads, v_dim), cache


def mla_prefill_block_paged(p, x: torch.Tensor, cache: PagedMLACache,
                            page_table: torch.Tensor, start: int,
                            alive: torch.Tensor, *, n_heads: int,
                            kv_lora: int, rope_dim: int, nope_dim: int,
                            v_dim: int, page_size: int,
                            rope_theta: float = 10000.0,
                            writes: Optional[PageWrites] = None):
    """One prompt block of an MLA layer over the paged latent cache: the
    block's latent rows land in the slot's pages (``writes`` as in
    :func:`gqa_prefill_block_paged`), the slot's page view is gathered and
    re-expanded, and the block attends over it (rows past the block mask
    out causally).  Returns (out [B,c,D], cache)."""
    b, c, _ = x.shape
    t = start + torch.arange(c, device=x.device)
    q_nope, q_rope = _mla_q(p, x, n_heads, nope_dim, rope_dim, t[None, :],
                            rope_theta)
    c_kv, k_rope = _mla_latent(p, x, kv_lora, t[None, :], rope_theta)
    _write_block_slot(cache.c_kv, page_table, start, alive, c_kv, page_size,
                      writes)
    _write_block_slot(cache.k_rope, page_table, start, alive, k_rope,
                      page_size, writes)
    c_view = _gather_slots(cache.c_kv, page_table, alive)  # [B,cap,lora]
    r_view = _gather_slots(cache.k_rope, page_table, alive)
    o = _mla_block_attend(p, q_nope, q_rope, c_view, r_view, t,
                          n_heads=n_heads, nope_dim=nope_dim,
                          rope_dim=rope_dim, v_dim=v_dim)
    return qmatmul(p, "wo", o.reshape(b, c, n_heads * v_dim)), cache


# --- codebook-quantized latent pages ----------------------------------------
#
# Latent pages always carry one codebook per page and tensor (the
# reference fixes the "page" grouping for MLA).  Their writes go through the
# GQA write path above, which takes rows [..., KV, hd]: a latent row is a
# one-"head" row ([..., 1, d]) and a word pool [P+1, page, Wd] is viewed as
# [P+1, page, 1, Wd], so the writes land in the pool itself.


class QuantPagedMLACache(NamedTuple):
    c_words: torch.Tensor    # [n_pages + 1, page, ⌈kv_lora/lanes⌉] int32
    r_words: torch.Tensor    # [n_pages + 1, page, ⌈rope_dim/lanes⌉] int32
    c_cb: torch.Tensor       # [n_pages + 1, 1, K]
    r_cb: torch.Tensor


def init_quant_paged_mla_cache(n_pages: int, page_size: int, kv_lora: int,
                               rope_dim: int, bits: int, dtype=torch.float32,
                               device=None) -> QuantPagedMLACache:
    k = kvquant.kv_entries(kvquant.check_kv_bits(bits))

    def words(d):
        return torch.zeros(n_pages + 1, page_size, kvquant.words_per(d, bits),
                           dtype=torch.int32, device=device)

    return QuantPagedMLACache(
        c_words=words(kv_lora), r_words=words(rope_dim),
        c_cb=torch.zeros(n_pages + 1, 1, k, dtype=dtype, device=device),
        r_cb=torch.zeros(n_pages + 1, 1, k, dtype=dtype, device=device))


def _one_group(t: torch.Tensor) -> torch.Tensor:
    """A latent row [..., d] (or word pool [..., Wd]) as one group
    [..., 1, d]: a view."""
    return t.unsqueeze(-2)


def mla_decode_paged_quant(p, x_t: torch.Tensor, cache: QuantPagedMLACache,
                           page_table: torch.Tensor, pos: torch.Tensor,
                           alive: torch.Tensor, *, n_heads: int,
                           kv_lora: int, rope_dim: int, nope_dim: int,
                           v_dim: int, page_size: int, kv_bits: int,
                           rope_theta: float = 10000.0,
                           fit_slots: Optional[torch.Tensor] = None,
                           writes: Optional[PageWrites] = None):
    """``mla_decode_paged`` over codebook-quantized latent pages: the
    token's latent rows are quantized into the slots' pages (a slot that
    starts a page fits its codebooks), then attended through the quantized
    MLA paged-decode route.  ``fit_slots`` and ``writes`` as in
    :func:`gqa_decode_paged_quant`.  Returns (out [B,1,D], cache), written
    in place."""
    posb = pos[:, None]
    q_nope, q_rope = _mla_q(p, x_t, n_heads, nope_dim, rope_dim, posb,
                            rope_theta)
    c_kv, k_rope = _mla_latent(p, x_t, kv_lora, posb, rope_theta)
    rows = (fit_slots if fit_slots is not None
            else first_write_slots(pos, page_size))
    for words, cbs, new in ((cache.c_words, cache.c_cb, c_kv[:, 0]),
                            (cache.r_words, cache.r_cb, k_rope[:, 0])):
        new = _one_group(new)
        cb_fit = (kvquant.fit_codebooks(new[rows], kv_bits).to(cbs.dtype)
                  if rows.numel() else None)
        _write_slot_quant(_one_group(words), cbs, page_table, pos, alive,
                          new, page_size, kv_bits, "page",
                          fit=(rows, cb_fit), writes=writes)
    q_eff = _mla_absorb_q(p, q_nope, kv_lora, n_heads, nope_dim)
    ctx = dispatch.mla_paged_attention_quant(
        q_eff, q_rope, cache.c_words, cache.r_words, cache.c_cb, cache.r_cb,
        page_table, pos, alive, bits=kv_bits, kv_lora=kv_lora,
        rope_dim=rope_dim, scale=(nope_dim + rope_dim) ** -0.5)
    return _mla_out(p, ctx, kv_lora, n_heads, v_dim), cache


def mla_prefill_block_paged_quant(p, x: torch.Tensor,
                                  cache: QuantPagedMLACache,
                                  page_table: torch.Tensor, start: int,
                                  alive: torch.Tensor, *, n_heads: int,
                                  kv_lora: int, rope_dim: int, nope_dim: int,
                                  v_dim: int, page_size: int, kv_bits: int,
                                  rope_theta: float = 10000.0,
                                  writes: Optional[PageWrites] = None):
    """MLA block prefill over codebook-quantized latent pages: the block's
    latent rows are quantized into the slot's pages (``writes`` as in
    :func:`gqa_prefill_block_paged`), then the slot's word view is
    gathered, dequantized in plain torch (the expansion needs dense
    latents, so the reference has no fused quantized MLA prefill kernel)
    and re-expanded as on dense pages.  Returns (out [B,c,D], cache)."""
    b, c, _ = x.shape
    t = start + torch.arange(c, device=x.device)
    q_nope, q_rope = _mla_q(p, x, n_heads, nope_dim, rope_dim, t[None, :],
                            rope_theta)
    c_kv, k_rope = _mla_latent(p, x, kv_lora, t[None, :], rope_theta)
    for words, cbs, new in ((cache.c_words, cache.c_cb, c_kv),
                            (cache.r_words, cache.r_cb, k_rope)):
        _write_block_slot_quant(_one_group(words), cbs, page_table, start,
                                alive, _one_group(new), page_size, kv_bits,
                                "page", writes=writes)
    masked = torch.where(alive.bool()[:, None], page_table.long(), 0)
    c_view, r_view = (
        dequant_view_ref(_gather_slots(words, page_table, alive),
                         cbs[masked], d, kv_bits, page_size).to(cbs.dtype)
        for words, cbs, d in ((cache.c_words, cache.c_cb, kv_lora),
                              (cache.r_words, cache.r_cb, rope_dim)))
    o = _mla_block_attend(p, q_nope, q_rope, c_view, r_view, t,
                          n_heads=n_heads, nope_dim=nope_dim,
                          rope_dim=rope_dim, v_dim=v_dim)
    return qmatmul(p, "wo", o.reshape(b, c, n_heads * v_dim)), cache
