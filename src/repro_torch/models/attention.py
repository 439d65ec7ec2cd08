"""GQA attention for serving: projections, the blockwise-prefill block
step and the contiguous-cache decode step (port of the ported parts of
``repro/models/attention.py``).

Not ported yet (each raises or is absent): the full-sequence
``chunked_attention`` / ``gqa_forward`` training path, sliding-window
rings, MLA, and the paged / quantized-KV engine paths (ROADMAP.md
modules 5, 7, 8).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.layers import apply_rope, init_normal, softcap
from repro_torch.models.qleaf import qmatmul

NEG_INF = -1e30


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
    b = x_t.shape[0]
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
    rep = n_heads // n_kv
    qg = q.reshape(b, 1, n_kv, rep, head_dim)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg.float(),
                          cache.k.float()) * scale
    logits = softcap(logits, attn_softcap)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    attn = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrqs,bskd->bkrqd", attn.to(cache.v.dtype), cache.v)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, 1, n_heads * head_dim)
    return qmatmul(p, "wo", o.to(x_t.dtype)), cache
