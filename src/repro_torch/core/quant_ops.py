"""Optimal scalar quantization operators (port of
``repro/core/quant_ops.py``: paper §4.2, Theorems A.1-A.3).

They solve the C step ``min_Θ ||w - Δ(Θ)||²`` in closed form for fixed
codebooks, with or without a learned global scale, on any device.

Conventions (the reference's):
* ``sgn(0) = +1`` (paper eq. 12).
* Ties at Voronoi boundaries round toward the larger codebook index
  (paper eq. 11).
* Scale-solving operators reduce over all elements.
* A subnormal input counts as zero.  The reference runs under XLA, which
  flushes subnormals to zero on both of its platforms (the CPU's FTZ/DAZ
  mode, the TPU's arithmetic), so there ``sgn(-1e-40) = +1``; PyTorch
  keeps subnormals, and :func:`flush_subnormal` restores the reference's
  answer.  The ``fixed_quant`` CUDA kernel does the same.

``pow2_quantize`` takes ``log2`` from the device's library: torch's CPU
``log2``, CUDA's ``log2f`` and XLA's ``log·(1/ln 2)`` can differ by an
ulp or two, which moves the exponent only where ``f + log2(3/2)`` lies
that close to an integer, i.e. at ``|t|`` within a few ulps of
``1.5·2^-n``.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

# log2(3/2) rounded to f32: the constant of Theorem A.1's exponent, the
# bits the reference's ``jnp.log2(1.5)`` gives (0x3F15C01A)
LOG2_1P5 = 0.5849624872207642


def flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every subnormal (and -0.0) replaced by +0.0, as XLA's
    flush-to-zero arithmetic reads it."""
    tiny = torch.finfo(t.dtype).tiny
    return torch.where(t.abs() < tiny, torch.zeros_like(t), t)


def sgn(t: torch.Tensor) -> torch.Tensor:
    """Sign with sgn(0) = +1 (paper eq. 12); subnormals count as 0."""
    one = torch.ones_like(t)
    return torch.where(flush_subnormal(t) >= 0, one, -one)


# ---------------------------------------------------------------------------
# Fixed codebook, no scale (paper eq. 11 particular cases)
# ---------------------------------------------------------------------------

def binarize(t: torch.Tensor) -> torch.Tensor:
    """q(t) for codebook {-1,+1}: q = sgn(t)."""
    return sgn(t)


def ternarize(t: torch.Tensor) -> torch.Tensor:
    """q(t) for codebook {-1,0,+1}: q = sgn(t)·1[|t| ≥ 1/2]."""
    return sgn(t) * (t.abs() >= 0.5).to(t.dtype)


def pow2_quantize(t: torch.Tensor, C: int) -> torch.Tensor:
    """q(t) for codebook {0, ±1, ±2^-1, ..., ±2^-C} (Theorem A.1).

    α(t) = 0              if f > C+1
           1              if f ≤ 0
           2^-C           if f ∈ (C, C+1]
           2^-⌊f+log2(3/2)⌋ otherwise,      f = -log2|t|.
    """
    if C < 0:
        raise ValueError(f"pow2 codebook needs C >= 0, got {C}")
    at = flush_subnormal(t).abs()
    f = -torch.log2(torch.where(at > 0, at, torch.ones_like(at)))
    f = torch.where(at > 0, f, torch.full_like(f, math.inf))
    mid_exp = torch.floor(f + LOG2_1P5)
    alpha = torch.where(
        f > C + 1, torch.zeros_like(f),
        torch.where(f <= 0, torch.ones_like(f),
                    torch.where(f > C, torch.full_like(f, 2.0 ** -C),
                                torch.exp2(-mid_exp))))
    return (alpha * sgn(t)).to(t.dtype)


def fixed_codebook_quantize(t: torch.Tensor,
                            codebook: torch.Tensor) -> torch.Tensor:
    """q(t) for an arbitrary fixed scalar codebook (paper eq. 11); the
    codebook need not be sorted."""
    c = torch.sort(codebook).values
    return c[fixed_codebook_assign(t, c)]


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


# ---------------------------------------------------------------------------
# Fixed codebook with learned global scale (Theorems A.2, A.3)
# ---------------------------------------------------------------------------

def binarize_scale(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codebook {-a,+a}, optimal a = mean(|w|) (Theorem A.2) → (q, a)."""
    a = w.abs().mean()
    return a * sgn(w), a


def ternarize_scale(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codebook {-a,0,+a}, exact optimal a (Theorem A.3).

    j* = argmax_j (1/√j) Σ_{i≤j} |w|_(i)  over |w| sorted descending,
    a* = (1/j*) Σ_{i≤j*} |w|_(i),   q_i = sgn(w_i)·a·1[|w_i| ≥ a/2].
    """
    flat = w.abs().reshape(-1)
    s = torch.sort(flat, descending=True).values
    csum = torch.cumsum(s, 0)
    j = torch.arange(1, flat.numel() + 1, dtype=csum.dtype,
                     device=csum.device)
    jstar = torch.argmax(csum / torch.sqrt(j))
    a = csum[jstar] / (jstar + 1).to(csum.dtype)
    q = sgn(w) * a * (w.abs() >= 0.5 * a).to(w.dtype)
    return q.to(w.dtype), a


def fixed_scale_fit(w: torch.Tensor, codebook: torch.Tensor,
                    iters: int = 20
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """General fixed codebook with adaptive scale (paper eq. 13):
    alternate assignment and ``a = Σ z_ik w_i c_k / Σ z_ik c_k²`` for
    ``iters`` iterations → (q, a, assignments)."""
    flat = w.reshape(-1)
    c = torch.sort(codebook.to(flat.dtype)).values
    csq = c * c
    a = torch.clamp(flat.abs().mean(), min=torch.finfo(flat.dtype).tiny)
    for _ in range(iters):
        assign = fixed_codebook_assign(flat, a * c)
        num = torch.sum(flat * c[assign])
        den = torch.sum(csq[assign])
        a = torch.where(den > 0, num / den, a)
    assign = fixed_codebook_assign(flat, a * c)
    q = (a * c[assign]).reshape(w.shape)
    return q, a, assign.reshape(w.shape)


def distortion(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Squared error ||w - q||², the C-step objective."""
    d = (w - q).reshape(-1)
    return torch.dot(d, d)


# Named registry of parameter-free operators (test / bench sweeps).
FIXED_OPS = {
    "binary": binarize,
    "ternary": ternarize,
    "pow2_c4": functools.partial(pow2_quantize, C=4),
    "pow2_c7": functools.partial(pow2_quantize, C=7),
}
