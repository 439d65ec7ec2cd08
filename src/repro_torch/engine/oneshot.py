"""The one-shot lockstep greedy loop (port of
``repro/engine/oneshot.py``): a fixed batch, blockwise prefill, greedy
decode.  It is the ``--no-engine`` serving path and the oracle the engine
is held against.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.models.transformer import ModelConfig, decode_step, prefill


def grow_caches(caches, prompt_len: int, gen_len: int):
    """Pad prefill caches (capacity = prompt_len on axis 2 of the stacked
    [G, B, S, ...] leaves: K/V [G, B, S, KV, hd] or MLA latents
    [G, B, S, d]) to prompt_len + gen_len for the decode loop."""
    def grow(leaf):
        if leaf.ndim >= 3 and leaf.shape[2] == prompt_len:
            pad = [0, 0] * (leaf.ndim - 3) + [0, gen_len]
            return torch.nn.functional.pad(leaf, pad)
        return leaf

    return tree_map(grow, caches)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(params, cfg: ModelConfig, prompts: torch.Tensor,
                    gen_len: int, collect_logits: bool = False,
                    block: Optional[int] = None,
                    stats: Optional[dict] = None,
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Lockstep greedy generation for a same-length prompt batch.

    prompts [B, S] → (tokens [B, gen_len] int64, and — with
    ``collect_logits`` — the per-step last-position logits [B, gen_len, V]
    f32).  Token 0 comes from the prefill logits; decode step t feeds the
    previous token at position S + t.  ``torch.argmax`` takes the first
    maximum, as ``jnp.argmax`` does.  When ``stats`` is a dict it receives
    ``prefill_s`` and ``decode_s`` (seconds per decode step, host clock
    around work that ends in a device synchronise)."""
    b, prompt_len = prompts.shape
    device = prompts.device
    _sync(device)
    t0 = time.perf_counter()
    logits0, caches = prefill(params, cfg, prompts, last_logits_only=True,
                              block=block)
    caches = grow_caches(caches, prompt_len, gen_len)
    tok = torch.argmax(logits0[:, -1], dim=-1)[:, None]
    _sync(device)
    if stats is not None:
        stats["prefill_s"] = time.perf_counter() - t0
        stats["decode_s"] = []
    toks = [tok]
    logs = [logits0[:, -1:]] if collect_logits else None
    for t in range(gen_len - 1):
        t1 = time.perf_counter()
        logits, caches = decode_step(params, cfg, caches, tok, prompt_len + t)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if stats is not None:
            _sync(device)
            stats["decode_s"].append(time.perf_counter() - t1)
        toks.append(tok)
        if collect_logits:
            logs.append(logits[:, -1:])
    tokens = torch.cat(toks, dim=1)
    return tokens, (torch.cat(logs, dim=1) if collect_logits else None)


def truncate_at_eos(tokens, eos_id: Optional[int]) -> np.ndarray:
    """Cut one request's stream after the first EOS (inclusive)."""
    tokens = np.asarray(tokens).reshape(-1)
    if eos_id is None:
        return tokens
    hits = np.nonzero(tokens == eos_id)[0]
    return tokens[:hits[0] + 1] if hits.size else tokens
