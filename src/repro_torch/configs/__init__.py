"""Architecture registry of the port: ``get_config`` / ``reduce_config``
over the ported architectures, plus the fixture zoo's ``tiny_cfg``.

Only architectures whose every layer kind is ported are registered; the
others join as their mixers are ported (SSM: ROADMAP.md module 6; RG-LRU
and sliding windows: module 8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import deepseek_v2_lite_16b, qwen1p5_0p5b
from repro_torch.models.transformer import (LayerKind, MLASpec, ModelConfig,
                                            MoESpec, StackSpec)

_REGISTRY = {
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.config,
    "qwen1.5-0.5b": qwen1p5_0p5b.config,
}


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; choose from {list_archs()}")
    return _REGISTRY[arch]()


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same-family tiny config for CPU smoke tests: small width, at most
    two groups per stack, tiny vocab; the layer structure (patterns, mixer
    kinds, the MoE / MLA machinery) is kept."""
    if cfg.ssm is not None:
        raise NotImplementedError("reducing an SSM spec is not ported yet: "
                                  "ROADMAP.md module 6")
    if cfg.rglru is not None:
        raise NotImplementedError("reducing an RG-LRU spec is not ported "
                                  "yet: ROADMAP.md module 8")
    heads = 4
    kv = min(cfg.n_kv, heads) if cfg.n_kv < cfg.n_heads else heads
    kv = max(1, kv if cfg.n_kv > 1 else 1)
    upd: Dict = dict(
        d_model=64,
        n_heads=heads,
        n_kv=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        stacks=tuple(dataclasses.replace(s, groups=min(s.groups, 2))
                     for s in cfg.stacks),
        q_chunk=32,
        kv_chunk=32,
        remat=False,
    )
    if cfg.window is not None:
        upd["window"] = 64
    if cfg.emb_scale is not None:
        upd["emb_scale"] = 8.0
    if cfg.query_scale is not None:
        upd["query_scale"] = 16.0 ** -0.5
    if cfg.moe is not None:
        # capacity_factor >= E / top_k: per-row capacity >= S, so no token
        # drops at the reduced size
        upd["moe"] = MoESpec(n_experts=4, top_k=2,
                             n_shared=min(1, cfg.moe.n_shared),
                             d_ff_expert=32, capacity_factor=4.0)
    if cfg.mla is not None:
        upd["mla"] = MLASpec(kv_lora=32, rope_dim=8, nope_dim=16, v_dim=16)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **upd)


def tiny_cfg(tie: bool = True) -> ModelConfig:
    """The golden fixtures' tiny stack (``repro.analysis.zoo.tiny_cfg``):
    GQA + dense MLP, tied embeddings by default."""
    return ModelConfig(
        name="tiny-diff", family="dense", d_model=32, n_heads=4, n_kv=2,
        head_dim=8, d_ff=64, vocab=96,
        stacks=(StackSpec(pattern=(LayerKind("gqa", "dense"),), groups=2),),
        tie_embeddings=tie, q_chunk=8, kv_chunk=8, remat=False)
