"""Plain PyTorch versions of the ported kernels (port of
``repro/kernels/ref.py``).

Each function computes what its CUDA kernel computes, in the reference's
op order, on any device.  The kernel wrappers take these only for CPU
tensors; on the card they are what ``chip_smoke.py`` and the ``cuda``
tests hold the kernels against.  They compute in full f32: TF32 is
switched off for matmuls and convolutions (:func:`full_f32`) each time
one of them runs on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quant_ops
from repro_torch.core.compression import unpack_indices_2d, unpack_rows

NEG_INF = -1e30
POS_SENTINEL = 1 << 30          # k_pos value that is never visible


def full_f32() -> None:
    """Full-f32 products on the card: a float32 matmul or convolution must
    not drop to TF32 (about three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def codebook_matmul_ref(x: torch.Tensor, idx: torch.Tensor,
                        codebook: torch.Tensor) -> torch.Tensor:
    """Dequantize fully, then dot."""
    full_f32()
    w = codebook.float()[idx.long()]
    return (x.float() @ w).to(x.dtype)


def packed_codebook_matmul_ref(x: torch.Tensor, pidx: torch.Tensor,
                               codebook: torch.Tensor) -> torch.Tensor:
    """Plain version of ``codebook_matmul_packed``: unpack the
    ``pack_indices_2d`` words, gather, dot."""
    idx = unpack_indices_2d(pidx, x.shape[-1], codebook.shape[0])
    return codebook_matmul_ref(x, idx, codebook)


def packed_codebook_matmul_t_ref(x: torch.Tensor, pidx: torch.Tensor,
                                 codebook: torch.Tensor, n_out: int,
                                 order: str = "kd") -> torch.Tensor:
    """Plain version of ``codebook_matmul_packed_t``: unpack either word
    orientation to the [V, D] indices, gather, transposed dot."""
    full_f32()
    if order == "row":
        idx = unpack_rows(pidx, x.shape[-1], codebook.shape[0])     # [V, D]
    else:
        idx = unpack_indices_2d(pidx, n_out, codebook.shape[0])     # [V, D]
    w = codebook.float()[idx]
    return (x.float() @ w.T).to(x.dtype)


def quantized_gather_ref(tokens: torch.Tensor, pidx: torch.Tensor,
                         codebook: torch.Tensor, d: int) -> torch.Tensor:
    """Plain version of ``quantized_gather``: gather the packed word rows,
    unpack their lanes, LUT through the codebook."""
    words = pidx.view(torch.int32)[tokens.long()]    # [..., ⌈d/lanes⌉]
    idx = unpack_rows(words, d, codebook.shape[0])
    return codebook[idx]


def segment_stats(x: torch.Tensor, assign: torch.Tensor, k: int):
    """Per-row centroid sums and counts as ``kmeans_assign`` keeps them:
    x [G, N] float, assign [G, N] in [0, k) → (sums, counts) [G, k] in
    ``x``'s dtype.  Sums add in f64 and round once (an f32 running sum of
    2^16 points is off by ~1e-5 of the sum, the jnp oracle's
    ``segment_sum`` included); counts are integers converted at the end
    (exact up to 2^24 per centroid in f32, correctly rounded above, where
    an f32 running count would stall)."""
    g = x.shape[0]
    seg = (assign + k * torch.arange(g, device=x.device)[:, None]).reshape(-1)
    sums = torch.zeros(g * k, dtype=torch.float64, device=x.device
                       ).index_add_(0, seg, x.reshape(-1).double())
    counts = torch.bincount(seg, minlength=g * k)
    return (sums.reshape(g, k).to(x.dtype),
            counts.reshape(g, k).to(x.dtype))


# distance entries per chunk of kmeans_assign_ref's argmin (1 GiB of f32):
# qwen's embedding at K = 16 would need 10 GB at once
_ASSIGN_CHUNK = 1 << 28


def kmeans_assign_ref(w: torch.Tensor, codebook: torch.Tensor):
    """Plain version of ``kmeans_assign``: w [P] or [G, P], codebook [K]
    or [G, K] (need not be sorted) → (assign int32, sums f32, counts f32).

    ``assign`` is the argmin of (w - c_k)² in f32 with ties to the lower
    index, taken over chunks of points; sums and counts are
    :func:`segment_stats`, as the kernel's second pass keeps them."""
    x = w.float()
    c = codebook.float()
    batched = x.ndim == 2
    if not batched:
        x, c = x[None], c[None]
    g, p = x.shape
    k = c.shape[-1]
    step = max(1, _ASSIGN_CHUNK // max(1, g * k))
    assign = torch.cat([
        torch.argmin((x[:, i:i + step, None] - c[:, None, :]) ** 2, dim=-1)
        for i in range(0, p, step)], dim=1) if p else \
        torch.zeros((g, 0), dtype=torch.int64, device=x.device)
    sums, counts = segment_stats(x, assign, k)
    assign = assign.to(torch.int32)
    if not batched:
        return assign[0], sums[0], counts[0]
    return assign, sums, counts


FIXED_QUANT_MODES = ("binary", "ternary", "pow2")


def fixed_quant_ref(w: torch.Tensor, mode: str, pow2_c: int = 4,
                    scale: float = 1.0) -> torch.Tensor:
    """Plain version of ``fixed_quant``: ``scale · Q(w / scale)`` in f32
    through ``core.quant_ops``, back in ``w``'s dtype."""
    ws = w.float() / scale
    if mode == "binary":
        q = quant_ops.binarize(ws)
    elif mode == "ternary":
        q = quant_ops.ternarize(ws)
    elif mode == "pow2":
        q = quant_ops.pow2_quantize(ws, pow2_c)
    else:
        raise ValueError(f"mode={mode!r}; choose one of {FIXED_QUANT_MODES}")
    return (q * scale).to(w.dtype)


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x / cap)).to(x.dtype)


def blockwise_prefill_ref(q, k, v, q_pos, k_pos, *, window=None,
                          softcap=None, scale, token_tile):
    """q [B,C,H,hd]; k [B,S,KV,hd]; v [B,S,KV,vd]; q_pos [C]; k_pos [S]
    int32 with S a multiple of ``token_tile``.  Online softmax over
    ``token_tile``-row tiles; rows with ``k_pos > q_pos`` (or outside the
    window) get probability exactly 0.  Returns [B,C,H,vd] f32."""
    full_f32()
    b, c, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    if s % token_tile:
        raise ValueError(f"view rows {s} not a multiple of "
                         f"token_tile={token_tile}")
    rep = h // kv
    qg = q.float().reshape(b, c, kv, rep, hd)
    qp = q_pos.long()
    m = torch.full((b, kv, rep, c), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kv, rep, c), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, rep, c, vd), dtype=torch.float32,
                      device=q.device)
    for t0 in range(0, s, token_tile):
        ki = k[:, t0:t0 + token_tile].float()
        vi = v[:, t0:t0 + token_tile].float()
        kpos = k_pos[t0:t0 + token_tile].long()
        logits = torch.einsum("bqkrd,bskd->bkrqs", qg, ki) * scale
        logits = _softcap(logits, softcap)
        ok = kpos[None, :] <= qp[:, None]
        if window is not None:
            ok &= (qp[:, None] - kpos[None, :]) < window
        ok = ok[None, None, None]                         # [1,1,1,C,T]
        logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.where(ok, torch.exp(logits - m_new[..., None]),
                        torch.zeros_like(logits))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkrqs,bskd->bkrqd", p, vi)
        acc = acc * corr[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, h, vd)


def gather_pages_ref(pool: torch.Tensor, page_table: torch.Tensor,
                     alive: torch.Tensor) -> torch.Tensor:
    """Plain version of ``page_gather``: [P+1, page, ...] pool → per-slot
    logical view [B, npg·page, ...].

    Dead slots' table rows are masked to the trash page (page 0) *before*
    the gather, so a stalled or empty slot reads one repeated page instead
    of ``npg`` arbitrary live pages."""
    b, npg = page_table.shape
    table = torch.where(alive.bool()[:, None], page_table.long(), 0)
    g = pool[table]                              # [B, npg, page, ...]
    return g.reshape((b, npg * pool.shape[1]) + tuple(pool.shape[2:]))


def decode_attention_ref(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                         valid: torch.Tensor, *, softcap: Optional[float],
                         scale: float) -> torch.Tensor:
    """Masked one-token GQA attention over a per-row K/V view: q
    [B,1,H,hd]; ck/cv [B,cap,KV,hd]; valid [B or 1, cap] bool → [B,1,H·hd]
    in the view dtype.  Logits in f32, masked by select, softmax over the
    whole view (an all-masked row is uniform, as in the reference)."""
    full_f32()
    b, _, h, hd = q.shape
    kv = ck.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, hd)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), ck.float()) * scale
    logits = _softcap(logits, softcap)
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    attn = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrqs,bskd->bkrqd", attn.to(cv.dtype), cv)
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, h * hd)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        pos: torch.Tensor, alive: torch.Tensor, *,
                        softcap: Optional[float] = None,
                        scale: float) -> torch.Tensor:
    """Plain version of ``paged_attention`` (the reference's spec): gather
    both pools through the page table, mask rows past ``pos`` and dead
    slots, softmax-attend.  q [B,1,H,hd]; pools [P+1, page, KV, hd] →
    [B,1,H·hd].  A dead slot's row is fully masked, so its softmax is
    uniform and its output is the mean of the trash page's V rows; the
    CUDA kernel, like the reference's Pallas kernel, writes 0 there.  The
    engine discards dead rows either way."""
    gk = gather_pages_ref(k_pool, page_table, alive)
    gv = gather_pages_ref(v_pool, page_table, alive)
    cap = gk.shape[1]
    idx = torch.arange(cap, device=q.device)
    valid = (idx[None, :] <= pos.long()[:, None]) & alive.bool()[:, None]
    return decode_attention_ref(q, gk, gv, valid, softcap=softcap,
                                scale=scale)


def mla_decode_attention_ref(q_eff: torch.Tensor, q_rope: torch.Tensor,
                             gkv: torch.Tensor, grope: torch.Tensor,
                             valid: torch.Tensor, *,
                             scale: float) -> torch.Tensor:
    """Absorbed-MLA one-token attention over a per-row latent view (the
    reference's ``_paged_softmax_mla``): q_eff [B,1,H,L]; q_rope
    [B,1,H,R]; gkv [B,cap,L]; grope [B,cap,R]; valid [B or 1, cap] bool →
    latent context [B,1,H,L].  Logits (q_eff·c + q_rope·r)·scale in f32,
    masked by select, softmax over the whole view, the context from the
    same latent rows."""
    full_f32()
    logits = (torch.einsum("bqhl,bsl->bhqs", q_eff, gkv)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, grope))
    logits = logits.float() * scale
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bsl->bqhl", attn.to(gkv.dtype), gkv)


def _slot_valid(pos: torch.Tensor, alive: torch.Tensor, cap: int,
                device) -> torch.Tensor:
    idx = torch.arange(cap, device=device)
    return (idx[None, :] <= pos.long()[:, None]) & alive.bool()[:, None]


def mla_paged_attention_ref(q_eff: torch.Tensor, q_rope: torch.Tensor,
                            c_pool: torch.Tensor, r_pool: torch.Tensor,
                            page_table: torch.Tensor, pos: torch.Tensor,
                            alive: torch.Tensor, *,
                            scale: float) -> torch.Tensor:
    """Plain version of ``mla_paged_attention``: gather the latent pools
    [P+1, page, L] / [P+1, page, R] through the page table, mask rows past
    ``pos`` and dead slots, attend → [B,1,H,L].  Dead slots follow the jnp
    spec (the trash page's mean latent row); the CUDA kernel, like the
    Pallas kernel, writes 0 there."""
    gkv = gather_pages_ref(c_pool, page_table, alive)
    grope = gather_pages_ref(r_pool, page_table, alive)
    valid = _slot_valid(pos, alive, gkv.shape[1], q_eff.device)
    return mla_decode_attention_ref(q_eff, q_rope, gkv, grope, valid,
                                    scale=scale)


# ---------------------------------------------------------------------------
# Codebook-quantized KV pages
#
# Word pools hold the ``pack_rows`` layout over the trailing feature axis
# (int32 bit patterns, or uint32) with one codebook per page and group:
# cbs [P+1, Gcb, K], Gcb = 1 ("page" mode) or KV ("head" mode).  The
# dequantized view is a pure gather, so these versions equal the dense
# ones on the dequantized pools bit for bit.
# ---------------------------------------------------------------------------

def _lut(idx: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """idx [B, npg, page, ..., d] + per-page codebooks cb [B, npg, Gcb, K]
    → values [B, npg, page, ..., d]: each page's codebooks broadcast over
    its rows (and over the group axis when Gcb == 1)."""
    cb = cb.reshape(cb.shape[:2] + (1,) * (idx.ndim - cb.ndim)
                    + cb.shape[2:])
    cb_b = cb.expand(idx.shape[:-1] + cb.shape[-1:])
    return torch.gather(cb_b, -1, idx)


def dequant_pages_ref(words: torch.Tensor, cbs: torch.Tensor,
                      page_table: torch.Tensor, alive: torch.Tensor, d: int,
                      bits: int) -> torch.Tensor:
    """Gather + dequantize quantized pages into the logical view: words
    [P+1, page, ..., Wd]; cbs [P+1, Gcb, K]; dead slots read the trash
    page → [B, npg·page, ..., d] in the codebook dtype."""
    b, npg = page_table.shape
    table = torch.where(alive.bool()[:, None], page_table.long(), 0)
    w = words.view(torch.int32)[table]               # [B, npg, page, ..., Wd]
    idx = unpack_rows(w, d, 1 << bits)
    vals = _lut(idx, cbs[table])
    return vals.reshape((b, npg * words.shape[1]) + tuple(vals.shape[3:]))


def paged_attention_quant_ref(q: torch.Tensor, k_words: torch.Tensor,
                              v_words: torch.Tensor, k_cb: torch.Tensor,
                              v_cb: torch.Tensor, page_table: torch.Tensor,
                              pos: torch.Tensor, alive: torch.Tensor, *,
                              bits: int, head_dim: int,
                              softcap: Optional[float] = None,
                              scale: float) -> torch.Tensor:
    """Plain version of ``paged_attention_quant``: dequantize the slots'
    pages through their stored codebooks, then the dense route's math
    (dead slots follow the jnp spec, as in :func:`paged_attention_ref`)."""
    gk = dequant_pages_ref(k_words, k_cb, page_table, alive, head_dim, bits)
    gv = dequant_pages_ref(v_words, v_cb, page_table, alive, head_dim, bits)
    idx = torch.arange(gk.shape[1], device=q.device)
    valid = (idx[None, :] <= pos.long()[:, None]) & alive.bool()[:, None]
    return decode_attention_ref(q, gk, gv, valid, softcap=softcap,
                                scale=scale)


def dequant_view_ref(words: torch.Tensor, cbs: torch.Tensor, d: int,
                     bits: int, page_size: int) -> torch.Tensor:
    """Dequantize a gathered word view: words [B, S, ..., Wd] (S =
    npg·page_size, logical row order); cbs [B, npg, Gcb, K] → [B, S, ...,
    d].  The same unpack and per-page LUT as :func:`dequant_pages_ref`."""
    b, s = words.shape[:2]
    npg = cbs.shape[1]
    idx = unpack_rows(words, d, 1 << bits)
    idx = idx.reshape((b, npg, page_size) + tuple(idx.shape[2:]))
    vals = _lut(idx, cbs)
    return vals.reshape((b, s) + tuple(vals.shape[3:]))


def blockwise_prefill_quant_ref(q, k_words, v_words, k_cb, v_cb, q_pos,
                                k_pos, *, page_size, bits, head_dim,
                                window=None, softcap=None, scale,
                                token_tile):
    """Plain version of ``blockwise_prefill_quant``: dequantize the word
    view through its per-page codebooks, then the dense recurrence of
    :func:`blockwise_prefill_ref`.  Returns [B, C, H, hd] f32."""
    gk = dequant_view_ref(k_words, k_cb, head_dim, bits, page_size)
    gv = dequant_view_ref(v_words, v_cb, head_dim, bits, page_size)
    return blockwise_prefill_ref(q, gk, gv, q_pos, k_pos, window=window,
                                 softcap=softcap, scale=scale,
                                 token_tile=token_tile)


def mla_paged_attention_quant_ref(q_eff: torch.Tensor, q_rope: torch.Tensor,
                                  c_words: torch.Tensor,
                                  r_words: torch.Tensor, c_cb: torch.Tensor,
                                  r_cb: torch.Tensor,
                                  page_table: torch.Tensor,
                                  pos: torch.Tensor, alive: torch.Tensor, *,
                                  bits: int, kv_lora: int, rope_dim: int,
                                  scale: float) -> torch.Tensor:
    """Plain version of ``mla_paged_attention_quant``: dequantize the
    slots' latent word pages [P+1, page, Wd] through their per-page
    codebooks [P+1, 1, K], then the dense route's math."""
    gkv = dequant_pages_ref(c_words, c_cb, page_table, alive, kv_lora, bits)
    grope = dequant_pages_ref(r_words, r_cb, page_table, alive, rope_dim,
                              bits)
    valid = _slot_valid(pos, alive, gkv.shape[1], q_eff.device)
    return mla_decode_attention_ref(q_eff, q_rope, gkv, grope, valid,
                                    scale=scale)
