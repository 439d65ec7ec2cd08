"""Model-wide quantized-leaf ("qleaf") weight fetch (port of
``repro/models/qleaf.py``).

A multiplicative weight may arrive in three storage layouts (the
``PackedModel.serving_params`` layouts): dense ``p[name]``; uint8
``<name>_idx`` + ``<name>_cb``; bit-packed ``<name>_pidx`` uint32 words +
``<name>_cb`` + ``<name>_layout``.  Call sites pick the entry point by
access pattern and ``kernels.dispatch`` picks kernel or plain version by
the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch


def has_leaf(p, name: str) -> bool:
    """True if ``name`` is present in any of the three storage layouts."""
    return name in p or f"{name}_idx" in p or f"{name}_pidx" in p


def qweight(p, name: str, dtype=None) -> torch.Tensor:
    """Dense tensor fetch in the leaf's original shape (decoded if
    quantized)."""
    if f"{name}_pidx" in p:
        return dispatch.decode_packed_leaf(p[f"{name}_pidx"], p[f"{name}_cb"],
                                           p[f"{name}_layout"], dtype)
    if f"{name}_idx" in p:
        return dispatch.decode_leaf(p[f"{name}_idx"], p[f"{name}_cb"], dtype)
    w = p[name]
    return w.to(dtype) if dtype is not None else w


def qmatmul(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ <name>`` for a dense or quantized leaf."""
    if f"{name}_pidx" in p:
        return dispatch.packed_quantized_matmul(
            x, p[f"{name}_pidx"], p[f"{name}_cb"], layout=p[f"{name}_layout"])
    if f"{name}_idx" in p:
        return dispatch.quantized_matmul(x, p[f"{name}_idx"], p[f"{name}_cb"])
    return x @ p[name]


def qmatmul_t(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ <name>.T`` — the tied-embedding LM head over a [V, D] table."""
    if f"{name}_pidx" in p:
        return dispatch.packed_quantized_matmul_t(
            x, p[f"{name}_pidx"], p[f"{name}_cb"], layout=p[f"{name}_layout"])
    return x @ qweight(p, name).transpose(-1, -2)


def qembed(p, name: str, tokens: torch.Tensor) -> torch.Tensor:
    """Row gather ``<name>[tokens]`` — the embedding lookup."""
    if f"{name}_pidx" in p:
        return dispatch.quantized_gather(tokens, p[f"{name}_pidx"],
                                         p[f"{name}_cb"],
                                         layout=p[f"{name}_layout"])
    if f"{name}_idx" in p:
        idx = p[f"{name}_idx"][tokens.long()].long()
        return p[f"{name}_cb"][idx]
    return p[name][tokens.long()]
