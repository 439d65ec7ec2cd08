"""Shared model components: norms, RoPE, MLPs, softcaps (port of
``repro/models/layers.py``).

Param names follow the reference (``*_norm_scale``, ``*_bias``): the
quantization policy (``DEFAULT_EXCLUDE``) keys on them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + scale`` gain, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x / cap)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                      # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable).  Angles
    in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., :, None, None].float() * freqs   # [...,S,1,hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sqrelu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def init_normal(generator: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """N(0, scale²) weights drawn in f32 from ``generator``."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             gated: bool, dtype=torch.float32, device=None) -> dict:
    del act
    s_in = d_model ** -0.5
    s_out = d_ff ** -0.5
    p = {
        "w_in": init_normal(generator, (d_model, d_ff), s_in, dtype, device),
        "w_out": init_normal(generator, (d_ff, d_model), s_out, dtype,
                             device),
    }
    if gated:
        p["w_gate"] = init_normal(generator, (d_model, d_ff), s_in, dtype,
                                  device)
    return p


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    from repro_torch.models.qleaf import has_leaf, qmatmul
    f = act_fn(act)
    h = qmatmul(p, "w_in", x)
    if has_leaf(p, "w_gate"):
        h = f(qmatmul(p, "w_gate", x)) * h
    else:
        h = f(h)
    return qmatmul(p, "w_out", h)
