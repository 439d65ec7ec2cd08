"""Scalar quantizer primitives (port of the part of
``repro/core/quant_ops.py`` the quantized KV cache needs).

Only :func:`fixed_codebook_assign` is ported here.  The binary / ternary /
power-of-two quantizers and the scale fits belong to the LC trainer
(ROADMAP.md module 13).
"""
from __future__ import annotations

import torch


def fixed_codebook_assign(t: torch.Tensor,
                          sorted_codebook: torch.Tensor) -> torch.Tensor:
    """Voronoi assignment of ``t`` [..., N] into the ascending codebooks
    ``sorted_codebook`` [..., K] (one codebook per leading index; a 1-D
    codebook serves every row) → int64 indices [..., N].

    The midpoints are ``0.5 * (c[1:] + c[:-1])`` in the codebook dtype, and
    ``searchsorted(right=True)`` sends a value equal to a midpoint to the
    larger index (paper eq. 11)."""
    mids = 0.5 * (sorted_codebook[..., 1:] + sorted_codebook[..., :-1])
    if mids.ndim == 1:
        return torch.searchsorted(mids, t, right=True)
    lead = torch.broadcast_shapes(mids.shape[:-1], t.shape[:-1])
    mids = mids.expand(lead + mids.shape[-1:]).contiguous()
    t = t.expand(lead + t.shape[-1:]).contiguous()
    return torch.searchsorted(mids, t, right=True)
