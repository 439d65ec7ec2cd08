"""Per-slot sampling, greedy half (port of ``repro/engine/sampling.py``).

A slot's next token is the ``argmax`` of its logits row — the exact rule
of the one-shot oracle, so engine streams equal one-shot streams bit for
bit.  ``torch.argmax`` keeps the first maximum, as ``jnp.argmax`` does.
Temperature / top-k sampling needs the reference's per-request threefry
keys and is ROADMAP.md module 9: the engine refuses such requests at
submission instead of decoding them greedily.
"""
from __future__ import annotations

from typing import Tuple

import torch


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """logits [B, V] → greedy tokens [B] int64 (first maximum)."""
    return torch.argmax(logits, dim=-1)


def sample_and_flag(logits: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_tokens` plus a per-row poison flag.

    ``bad[i]`` is True when row ``i`` holds any non-finite logit (NaN /
    inf — a numerically poisoned slot).  The engine quarantines flagged
    slots (typed ``FAILED`` outcome, pages freed) instead of streaming
    garbage; sampling runs on a zeroed copy of bad rows so a neighbor's
    lane never sees the NaN.  Returns (tokens [B], bad [B] bool)."""
    bad = ~torch.isfinite(logits).all(dim=-1)
    safe = torch.where(bad[:, None], torch.zeros_like(logits), logits)
    return sample_tokens(safe), bad
