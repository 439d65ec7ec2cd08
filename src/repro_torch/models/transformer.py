"""Decoder stack for serving (port of the ported parts of
``repro/models/transformer.py``).

A model is a sequence of *stacks*; each stack is ``groups`` repetitions of
a layer ``pattern``.  Parameters keep the reference's stacked layout
(leaves ``[G, ...]`` under ``params["stacks"][i]["pos<j>"]``); where the
reference scans over groups, this port loops over them in Python and
slices each leaf ``[g]`` (a view, no copy).

Ported: global GQA mixers with dense (gated) MLPs — ``init_params``,
``prefill(block=…)`` (blockwise, through the blockwise-prefill kernel),
``init_cache`` and ``decode_step``, and the engine's entry points over
dense or codebook-quantized KV pages (``cfg.kv_bits``): ``init_paged_cache``,
``decode_step_slots`` and ``prefill_chunk_slots``.  Other mixers / MLP
kinds, sliding windows, sinusoidal positions and VLM patches raise
``NotImplementedError`` naming the ROADMAP.md module that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.convert import tree_map
from repro_torch.core import kvquant
from repro_torch.kernels.ref import full_f32
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import qleaf as Q


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str          # gqa | gqa_local | mla | ssm | rglru
    mlp: str = "dense"  # dense | moe | none


@dataclasses.dataclass(frozen=True)
class StackSpec:
    pattern: Tuple[LayerKind, ...]
    groups: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    stacks: Tuple[StackSpec, ...]
    mlp_act: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    ssm: Optional[Any] = None
    rglru: Optional[Any] = None
    post_norms: bool = False
    emb_scale: Optional[float] = None
    pos_embed: str = "rope"
    vlm_patches: int = 0
    q_chunk: int = 1024
    kv_chunk: int = 1024
    kv_bits: int = 0
    kv_cb_mode: str = "page"
    remat: bool = True
    remat_policy: str = "full"
    attn_unroll: bool = False
    subquadratic: bool = False

    @property
    def n_layers(self) -> int:
        return sum(len(s.pattern) * s.groups for s in self.stacks)


def uniform_stack(kind: LayerKind, n_layers: int) -> Tuple[StackSpec, ...]:
    return (StackSpec(pattern=(kind,), groups=n_layers),)


def check_ported(cfg: ModelConfig) -> None:
    """Raise for any part of ``cfg`` whose path is not ported yet."""
    for spec in cfg.stacks:
        for kind in spec.pattern:
            if kind.mixer == "gqa_local":
                raise NotImplementedError(
                    "gqa_local (sliding-window ring) is not ported yet: "
                    "ROADMAP.md module 8")
            if kind.mixer in ("mla", "rglru"):
                raise NotImplementedError(
                    f"mixer {kind.mixer!r} is not ported yet: ROADMAP.md "
                    f"module 8")
            if kind.mixer == "ssm" or kind.mlp == "moe":
                raise NotImplementedError(
                    f"layer {kind} is not ported yet: ROADMAP.md module 6")
            if kind.mixer != "gqa" or kind.mlp not in ("dense", "none"):
                raise ValueError(f"unknown layer kind {kind}")
    if cfg.pos_embed != "rope" or cfg.vlm_patches:
        raise NotImplementedError("sinusoidal positions / VLM patches are "
                                  "not ported yet: ROADMAP.md module 8")
    if cfg.kv_bits:
        kvquant.check_kv_bits(cfg.kv_bits)
        if cfg.kv_cb_mode not in ("page", "head"):
            raise ValueError(f"kv_cb_mode={cfg.kv_cb_mode!r}; choose 'page' "
                             f"or 'head'")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(generator, cfg: ModelConfig, kind: LayerKind, dtype,
                device) -> dict:
    p: dict = {"ln1_norm_scale": torch.zeros(cfg.d_model, dtype=dtype,
                                             device=device)}
    p["mixer"] = attn.init_gqa(generator, cfg.d_model, cfg.n_heads, cfg.n_kv,
                               cfg.head_dim, cfg.qkv_bias, dtype, device)
    if kind.mlp != "none":
        p["ln2_norm_scale"] = torch.zeros(cfg.d_model, dtype=dtype,
                                          device=device)
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                              cfg.gated_mlp, dtype, device)
    if cfg.post_norms:
        p["post1_norm_scale"] = torch.zeros(cfg.d_model, dtype=dtype,
                                            device=device)
        if kind.mlp != "none":
            p["post2_norm_scale"] = torch.zeros(cfg.d_model, dtype=dtype,
                                                device=device)
    return p


def _stack_trees(trees: List[dict]) -> dict:
    return {k: (_stack_trees([t[k] for t in trees])
                if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees]))
            for k in trees[0]}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, dtype=torch.float32) -> dict:
    """Random dense params in the reference's layout (same shapes and
    scales; the numbers differ from the reference's for one seed)."""
    check_ported(cfg)
    params: dict = {
        "embed_tok": L.init_normal(generator, (cfg.vocab, cfg.d_model),
                                   cfg.d_model ** -0.5, dtype, device),
        "final_norm_scale": torch.zeros(cfg.d_model, dtype=dtype,
                                        device=device),
    }
    if not cfg.tie_embeddings:
        params["head_w"] = L.init_normal(generator, (cfg.d_model, cfg.vocab),
                                         cfg.d_model ** -0.5, dtype, device)
    stacks = []
    for spec in cfg.stacks:
        stacks.append({
            f"pos{pi}": _stack_trees([_init_layer(generator, cfg, kind, dtype,
                                                  device)
                                      for _ in range(spec.groups)])
            for pi, kind in enumerate(spec.pattern)})
    params["stacks"] = tuple(stacks)
    return params


def _group(tree, g: int):
    """Slice every tensor of a stacked subtree to group ``g`` (views)."""
    return tree_map(lambda t: t[g], tree)


# ---------------------------------------------------------------------------
# Embedding / head / layer
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = Q.qembed(params, "embed_tok", tokens)
    if cfg.emb_scale is not None:
        x = x * torch.tensor(cfg.emb_scale, dtype=x.dtype)
    return x


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm_scale"])
    if cfg.tie_embeddings:
        logits = Q.qmatmul_t(params, "embed_tok", x)
    else:
        logits = Q.qmatmul(params, "head_w", x)
    return L.softcap(logits.float(), cfg.final_softcap)


def _mlp_residual(kind: LayerKind, p, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    if kind.mlp == "none":
        return x
    out = L.apply_mlp(p["mlp"], L.rms_norm(x, p["ln2_norm_scale"]),
                      cfg.mlp_act)
    if cfg.post_norms:
        out = L.rms_norm(out, p["post2_norm_scale"])
    return x + out


def _mixer_residual(p, x: torch.Tensor, out: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    if cfg.post_norms:
        out = L.rms_norm(out, p["post1_norm_scale"])
    return x + out


# ---------------------------------------------------------------------------
# Caches and decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.float32, device=None):
    """Stacked caches mirroring the param stacks: leaves
    [G, B, cap, KV, hd]."""
    check_ported(cfg)
    return tuple(
        {f"pos{pi}": attn.KVCache(
            k=torch.zeros(spec.groups, batch, capacity, cfg.n_kv,
                          cfg.head_dim, dtype=dtype, device=device),
            v=torch.zeros(spec.groups, batch, capacity, cfg.n_kv,
                          cfg.head_dim, dtype=dtype, device=device))
         for pi in range(len(spec.pattern))}
        for spec in cfg.stacks)


def decode_step(params, cfg: ModelConfig, caches, tokens_t: torch.Tensor,
                pos: int):
    """One new token per sequence.  tokens_t [B, 1]; ``pos`` the position
    written.  Returns (logits [B, 1, V] f32, caches) — the caches are
    updated in place."""
    full_f32()
    x = _embed(params, cfg, tokens_t)
    for spec, sp, sc in zip(cfg.stacks, params["stacks"], caches):
        for g in range(spec.groups):
            for pi, kind in enumerate(spec.pattern):
                p = _group(sp[f"pos{pi}"], g)
                c = _group(sc[f"pos{pi}"], g)
                out, _ = attn.gqa_decode(
                    p["mixer"], L.rms_norm(x, p["ln1_norm_scale"]), c, pos,
                    n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                    head_dim=cfg.head_dim, attn_softcap=cfg.attn_softcap,
                    rope_theta=cfg.rope_theta, query_scale=cfg.query_scale)
                x = _mlp_residual(kind, p, _mixer_residual(p, x, out, cfg),
                                  cfg)
    return _head(params, cfg, x), caches


# ---------------------------------------------------------------------------
# Blockwise prefill
# ---------------------------------------------------------------------------

# Default prompt-block length of the one-shot blockwise prefill (the
# engine's block length is its prefill chunk; both must partition alike
# for their streams to agree bit for bit).
DEFAULT_PREFILL_BLOCK = 64


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            last_logits_only: bool = False, block: Optional[int] = None):
    """Blockwise forward over the prompt, emitting logits + decode caches.

    The prompt runs in blocks of ``block`` tokens (default
    :data:`DEFAULT_PREFILL_BLOCK`, remainder last); each block attends over
    the K/V written so far through ``dispatch.blockwise_prefill_attention``.
    ``last_logits_only`` heads only the final position.  Returns (logits
    [B, S or 1, V] f32, caches with leaves [G, B, S, KV, hd])."""
    check_ported(cfg)
    full_f32()
    b, s = tokens.shape
    blk = max(1, min(block or DEFAULT_PREFILL_BLOCK, s))
    starts = list(range(0, s, blk))
    states = None
    logits_parts = []
    for start in starts:
        end = min(start + blk, s)
        x = _embed(params, cfg, tokens[:, start:end])
        if states is None:
            empty = torch.zeros(b, 0, cfg.n_kv, cfg.head_dim, dtype=x.dtype,
                                device=x.device)
            states = [[[attn.KVCache(k=empty, v=empty)
                        for _ in range(spec.groups)]
                       for _ in spec.pattern] for spec in cfg.stacks]
        for spec, sp, st in zip(cfg.stacks, params["stacks"], states):
            for g in range(spec.groups):
                for pi, kind in enumerate(spec.pattern):
                    p = _group(sp[f"pos{pi}"], g)
                    buf = st[pi][g]
                    out, bk, bv = attn.gqa_prefill_block(
                        p["mixer"], L.rms_norm(x, p["ln1_norm_scale"]),
                        buf.k, buf.v, start, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                        attn_softcap=cfg.attn_softcap,
                        rope_theta=cfg.rope_theta,
                        query_scale=cfg.query_scale)
                    st[pi][g] = attn.KVCache(k=bk, v=bv)
                    x = _mlp_residual(kind, p,
                                      _mixer_residual(p, x, out, cfg), cfg)
        if not last_logits_only:
            logits_parts.append(_head(params, cfg, x))
        elif start == starts[-1]:
            logits_parts.append(_head(params, cfg, x[:, -1:, :]))
    logits = (logits_parts[0] if len(logits_parts) == 1
              else torch.cat(logits_parts, dim=1))
    caches = tuple(
        {f"pos{pi}": attn.KVCache(k=torch.stack([c.k for c in st[pi]]),
                                  v=torch.stack([c.v for c in st[pi]]))
         for pi in range(len(spec.pattern))}
        for spec, st in zip(cfg.stacks, states))
    return logits, caches


# ---------------------------------------------------------------------------
# Paged caches (continuous-batching engine)
# ---------------------------------------------------------------------------
#
# Global-attention layers share one physical page pool per layer position
# ([G, n_pages + 1, page, KV, hd]; page 0 is the trash page) indexed by ONE
# per-slot page table: every layer caches the same logical positions, so
# the table is model-wide.  ``decode_step_slots`` is the engine's serve
# step: the same shapes for any admission / eviction state.


def init_paged_cache(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, dtype=torch.float32, device=None):
    """Engine caches mirroring the param stacks: leaves
    [G, n_pages + 1, page, KV, hd] (``PagedKVCache``), or with
    ``cfg.kv_bits`` word pools [G, n_pages + 1, page, KV, Wd] int32 and
    codebooks [G, n_pages + 1, Gcb, K] (``QuantPagedKVCache``).
    ``n_slots`` sizes the per-slot state of the mixers that keep one (none
    among the ported ones)."""
    del n_slots
    check_ported(cfg)
    caches = []
    for spec in cfg.stacks:
        stack = {}
        for pi in range(len(spec.pattern)):
            if cfg.kv_bits:
                one = attn.init_quant_paged_kv_cache(
                    n_pages, page_size, cfg.n_kv, cfg.head_dim, cfg.kv_bits,
                    cfg.kv_cb_mode, dtype, device)
            else:
                one = attn.init_paged_kv_cache(n_pages, page_size, cfg.n_kv,
                                               cfg.head_dim, dtype, device)
            stack[f"pos{pi}"] = type(one)(
                *(t.expand((spec.groups,) + t.shape).clone() for t in one))
        caches.append(stack)
    return tuple(caches)


def cache_page_size(stack_caches) -> int:
    """Page size of one stack's engine caches, dense or quantized (the
    pools' page axis)."""
    c = stack_caches["pos0"]
    pool = c.k_words if isinstance(c, attn.QuantPagedKVCache) else c.k
    return pool.shape[2]


def decode_step_slots(params, cfg: ModelConfig, caches,
                      page_table: torch.Tensor, tokens_t: torch.Tensor,
                      pos: torch.Tensor, alive: torch.Tensor,
                      fit_slots: Optional[List[int]] = None):
    """Slot-aware serve step of the engine.

    tokens_t [B, 1] (B = n_slots); page_table [B, npg] int32; pos [B]
    per-slot write positions; alive [B] bool.  Dead / page-starved slots
    are masked: their attention reads are invalid and their pool writes
    land on the trash page.  With quantized pages, ``fit_slots`` lists the
    slots whose write starts a page (their codebooks are fit this step);
    without it they are read from ``pos`` on the host.  Returns (logits
    [B, 1, V] f32, caches) — the pools are written in place."""
    full_f32()
    x = _embed(params, cfg, tokens_t)
    rows = None
    for spec, sp, sc in zip(cfg.stacks, params["stacks"], caches):
        page_size = cache_page_size(sc)
        if cfg.kv_bits and rows is None:
            rows = (attn.first_write_slots(pos, page_size)
                    if fit_slots is None
                    else torch.tensor(fit_slots, dtype=torch.long,
                                      device=pos.device))
        for g in range(spec.groups):
            for pi, kind in enumerate(spec.pattern):
                p = _group(sp[f"pos{pi}"], g)
                c = _group(sc[f"pos{pi}"], g)
                h = L.rms_norm(x, p["ln1_norm_scale"])
                kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                          head_dim=cfg.head_dim, page_size=page_size,
                          attn_softcap=cfg.attn_softcap,
                          rope_theta=cfg.rope_theta,
                          query_scale=cfg.query_scale)
                if cfg.kv_bits:
                    out, _ = attn.gqa_decode_paged_quant(
                        p["mixer"], h, c, page_table, pos, alive,
                        kv_bits=cfg.kv_bits, kv_cb_mode=cfg.kv_cb_mode,
                        fit_slots=rows, **kw)
                else:
                    out, _ = attn.gqa_decode_paged(p["mixer"], h, c,
                                                   page_table, pos, alive,
                                                   **kw)
                x = _mlp_residual(kind, p, _mixer_residual(p, x, out, cfg),
                                  cfg)
    return _head(params, cfg, x), caches


def prefill_chunk_slots(params, cfg: ModelConfig, caches,
                        page_table: torch.Tensor, tokens_c: torch.Tensor,
                        slot: int, start: int):
    """Engine blockwise prefill: ONE block of ``c`` prompt tokens for ONE
    slot against the shared paged caches.

    tokens_c [1, c] (positions [start, start + c)).  The block's K/V lands
    in the slot's pages (in place).  Returns (last-position logits
    [1, 1, V] f32, caches) — the logits matter only on the prompt's final
    block, where they seed the first sampled token."""
    full_f32()
    table_row = page_table[slot:slot + 1]
    alive = torch.ones(1, dtype=torch.bool, device=tokens_c.device)
    x = _embed(params, cfg, tokens_c)
    for spec, sp, sc in zip(cfg.stacks, params["stacks"], caches):
        page_size = cache_page_size(sc)
        for g in range(spec.groups):
            for pi, kind in enumerate(spec.pattern):
                p = _group(sp[f"pos{pi}"], g)
                c = _group(sc[f"pos{pi}"], g)
                h = L.rms_norm(x, p["ln1_norm_scale"])
                kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                          head_dim=cfg.head_dim, page_size=page_size,
                          attn_softcap=cfg.attn_softcap,
                          rope_theta=cfg.rope_theta,
                          query_scale=cfg.query_scale)
                if cfg.kv_bits:
                    out, _ = attn.gqa_prefill_block_paged_quant(
                        p["mixer"], h, c, table_row, start, alive,
                        kv_bits=cfg.kv_bits, kv_cb_mode=cfg.kv_cb_mode, **kw)
                else:
                    out, _ = attn.gqa_prefill_block_paged(
                        p["mixer"], h, c, table_row, start, alive, **kw)
                x = _mlp_residual(kind, p, _mixer_residual(p, x, out, cfg),
                                  cfg)
    return _head(params, cfg, x[:, -1:, :]), caches


# ---------------------------------------------------------------------------
# Module wrapper
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """A serving-params tree (dense, uint8 or packed layout) held on one
    device, with the model's serving entry points.  The tree is moved to
    ``device`` once at construction; calls then run there (the CUDA
    kernels on a card, their plain versions on the CPU)."""

    def __init__(self, cfg: ModelConfig, params, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else None
        self.params = (params if device is None
                       else tree_map(lambda t: t.to(device), params))

    def forward(self, tokens: torch.Tensor, last_logits_only: bool = False,
                block: Optional[int] = None):
        return self.prefill(tokens, last_logits_only=last_logits_only,
                            block=block)

    def prefill(self, tokens: torch.Tensor, last_logits_only: bool = False,
                block: Optional[int] = None):
        return prefill(self.params, self.cfg, tokens,
                       last_logits_only=last_logits_only, block=block)

    def decode_step(self, caches, tokens_t: torch.Tensor, pos: int):
        return decode_step(self.params, self.cfg, caches, tokens_t, pos)

    def init_cache(self, batch: int, capacity: int, dtype=torch.float32):
        return init_cache(self.cfg, batch, capacity, dtype, self.device)
