"""GQA attention for serving: projections, the blockwise-prefill block
step, the contiguous-cache decode step and the engine's paged steps over
dense KV pages (port of the ported parts of
``repro/models/attention.py``).

Not ported yet (each raises or is absent): the full-sequence
``chunked_attention`` / ``gqa_forward`` training path, sliding-window
rings, MLA, and the quantized-KV pages (ROADMAP.md modules 7, 8, 13).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models.layers import apply_rope, init_normal
from repro_torch.models.qleaf import qmatmul


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
# the trash page's cell at once; which write lands there is unspecified on
# the card, which is harmless because the trash page is only ever read
# masked.  The writes are issued before the attention reads them, on the
# same stream.
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


def _write_slot(pool: torch.Tensor, page_table: torch.Tensor,
                pos: torch.Tensor, alive: torch.Tensor, new: torch.Tensor,
                page_size: int) -> torch.Tensor:
    """Scatter one new entry per slot into its current page, in place.

    pool [P+1, page, ...]; page_table [B, npg]; pos / alive [B];
    new [B, ...].  Dead (or page-starved) slots write the trash page."""
    b = new.shape[0]
    npg = page_table.shape[1]
    pos = pos.long()
    pg = torch.clamp(pos // page_size, 0, npg - 1)
    phys = page_table.long()[torch.arange(b, device=pool.device), pg]
    phys = torch.where(alive.bool(), phys, 0)
    pool[phys, pos % page_size] = new.to(pool.dtype)
    return pool


def _write_block_slot(pool: torch.Tensor, page_table: torch.Tensor, start,
                      alive: torch.Tensor, new: torch.Tensor,
                      page_size: int) -> torch.Tensor:
    """Blockwise twin of ``_write_slot``: scatter ``c`` consecutive
    entries per slot from logical position ``start`` (an int or [B]), in
    place.  new [B, c, ...].  Dead slots write the trash page."""
    b, c = new.shape[0], new.shape[1]
    npg = page_table.shape[1]
    dev = pool.device
    start = torch.as_tensor(start, device=dev).long().reshape(-1)
    t = start.expand(b)[:, None] + torch.arange(c, device=dev)[None, :]
    pg = torch.clamp(t // page_size, 0, npg - 1)
    phys = page_table.long()[torch.arange(b, device=dev)[:, None], pg]
    phys = torch.where(alive.bool()[:, None], phys, 0)
    pool[phys, t % page_size] = new.to(pool.dtype)
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
                     rope_theta: float = 10000.0, query_scale=None):
    """One-token GQA decode for a batch of engine slots.

    x_t [B,1,D]; page_table [B, npg] int32; pos [B] per-slot write
    positions; alive [B] bool (dead slots: reads fully masked, writes land
    on the trash page).  Returns (out [B,1,D], cache) — the pools are
    written in place."""
    q, k, v = _qkv(p, x_t, n_heads, n_kv, head_dim)
    posb = pos[:, None]
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    _write_slot(cache.k, page_table, pos, alive, k[:, 0], page_size)
    _write_slot(cache.v, page_table, pos, alive, v[:, 0], page_size)
    scale = query_scale if query_scale is not None else head_dim ** -0.5
    o = dispatch.paged_attention(q, cache.k, cache.v, page_table, pos, alive,
                                 softcap=attn_softcap, scale=scale)
    return qmatmul(p, "wo", o.to(x_t.dtype)), cache


def gqa_prefill_block_paged(p, x: torch.Tensor, cache: PagedKVCache,
                            page_table: torch.Tensor, start: int,
                            alive: torch.Tensor, *, n_heads: int, n_kv: int,
                            head_dim: int, page_size: int, attn_softcap=None,
                            rope_theta: float = 10000.0, query_scale=None):
    """One prompt block of a paged GQA layer.

    x [B,c,D]; ``start`` the block's first logical position.  Writes the
    block's K/V into the slot's pages, then attends the block's queries
    over the gathered page view through the blockwise-prefill route —
    rows past ``start + c`` are future or stale and mask out causally (row
    index == position).  Returns (out [B,c,D], cache)."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    t = start + torch.arange(c, device=x.device)
    q = apply_rope(q, t[None, :], rope_theta)
    k = apply_rope(k, t[None, :], rope_theta)
    _write_block_slot(cache.k, page_table, start, alive, k, page_size)
    _write_block_slot(cache.v, page_table, start, alive, v, page_size)
    view_k = _gather_slots(cache.k, page_table, alive)     # [B,cap,KV,hd]
    view_v = _gather_slots(cache.v, page_table, alive)
    scale = query_scale if query_scale is not None else head_dim ** -0.5
    o = dispatch.blockwise_prefill_attention(
        q, view_k, view_v, t, torch.arange(view_k.shape[1], device=x.device),
        softcap=attn_softcap, scale=scale)
    return qmatmul(p, "wo", o.reshape(b, c, n_heads * head_dim)), cache
