"""Exact 1-D k-means for adaptive-codebook quantization (port of the part
of ``repro/core/kmeans.py`` the quantized KV cache needs).

For scalar points each iteration is exact: sort the K centroids, and a
point belongs to centroid k iff it falls between the midpoints around c_k
(a ``searchsorted`` over K-1 midpoints, paper eq. 11).

Batching takes the place of the reference's ``jax.vmap``: every row along
the last axis is one independent fit, and the convergence state (``done``,
the distortion plateau, ``iters_run``) is kept per row, so a row's result
does not depend on which rows share its batch.  The loop runs its fixed
number of iterations with masks, as the reference's ``lax.scan`` does: no
host synchronisation inside it.

On the CPU the fits match ``repro.core.kmeans`` under ``jax.jit`` (as
the reference's engine steps run them) bit for bit:
- the quantile interpolation ``lo·(1−w) + hi·w`` is one fused
  multiply-add over the first product, as XLA on the CPU contracts it
  inside a jitted program.  (Called eagerly, ``jnp.quantile`` compiles
  alone and XLA fuses the second product instead: the reference's own
  seeds then differ in the last bit, and so do its codebooks wherever a
  seed survives the fit, i.e. for groups of fewer values than K.)
- per-centroid sums and counts accumulate point by point in index order
  (``index_add_``), as XLA's CPU scatter does.

On a CUDA device ``index_add_`` accumulates with float atomics, whose
order changes from run to run; there the sums are a masked reduction over
the points instead (``torch.sum`` over a one-hot mask, a fixed tree
order), so a fit is the same on every run.

Not ported here (ROADMAP.md module 13, the LC trainer, and module 14, the
distributed C step): point weights, the mesh ``axis_name``, k-means++
seeding and the grouped helpers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quant_ops import fixed_codebook_assign


class KMeansResult(NamedTuple):
    codebook: torch.Tensor     # [..., K] ascending
    assignments: torch.Tensor  # [..., N] int32
    distortion: torch.Tensor   # [...] Σ (w_i - c_{κ(i)})², f32
    iters_run: torch.Tensor    # [...] int32, iterations until convergence


def quantile_init(w: torch.Tensor, k: int) -> torch.Tensor:
    """Deterministic quantile seeding: the (i + 0.5)/k quantiles of each
    row of ``w`` [..., N] → [..., k], linear interpolation as
    ``jnp.quantile``.  A row holding a NaN seeds all-NaN."""
    x = w.float()
    a = torch.sort(x, dim=-1, stable=True).values
    n = x.shape[-1]
    qs = (torch.arange(k, dtype=torch.float32, device=x.device) + 0.5) / k
    q = qs * float(n - 1)
    low = torch.floor(q)
    high = torch.ceil(q)
    hi_w = q - low
    lo_w = 1.0 - hi_w
    low = torch.clamp(low, 0, n - 1).long()
    high = torch.clamp(high, 0, n - 1).long()
    lo_v, hi_v = a[..., low], a[..., high]
    # hi·hi_w rounded to f32, then lo·lo_w fused onto it (the product is
    # exact in f64) and rounded once: how XLA contracts the interpolation
    # inside a jitted program (see the module note)
    second = hi_v * hi_w
    out = (lo_v.double() * lo_w.double() + second.double()).float()
    out = torch.where(torch.isnan(x).any(dim=-1, keepdim=True),
                      torch.full_like(out, float("nan")), out)
    return out.to(w.dtype)


def _segment_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    """Per-row centroid sums and counts: x [G, N] f32, assign [G, N] in
    [0, k) → ([G, k], [G, k]) f32 (see the module note on the order)."""
    g = x.shape[0]
    if x.is_cuda:
        onehot = assign[..., None] == torch.arange(k, device=x.device)
        sums = torch.where(onehot, x[..., None], 0.0).sum(dim=1)
        return sums, onehot.sum(dim=1, dtype=torch.float32)
    seg = (assign + k * torch.arange(g, device=x.device)[:, None]).reshape(-1)
    sums = torch.zeros(g * k, dtype=x.dtype).index_add_(0, seg, x.reshape(-1))
    counts = torch.zeros(g * k, dtype=x.dtype).index_add_(
        0, seg, torch.ones_like(x).reshape(-1))
    return sums.reshape(g, k), counts.reshape(g, k)


def _distortion(x: torch.Tensor, c: torch.Tensor,
                assign: torch.Tensor) -> torch.Tensor:
    resid = (x - torch.gather(c, 1, assign)).float()
    return (resid * resid).sum(dim=-1)


def kmeans_fit(w: torch.Tensor, init_codebook: torch.Tensor,
               iters: int = 30, tol: float = 1e-4) -> KMeansResult:
    """At most ``iters`` exact 1-D k-means iterations per row of ``w``
    [..., N] from ``init_codebook`` [..., K].

    A row converges at the assignment fixpoint or on a distortion plateau
    (relative improvement <= ``tol``); its later iterations leave it as
    it is, and ``iters_run`` counts the ones that changed it.  Empty
    clusters keep their previous centroid.  A 1-D ``w`` is the
    reference's single fit."""
    lead, n = w.shape[:-1], w.shape[-1]
    k = init_codebook.shape[-1]
    x = w.reshape(-1, n)
    g = x.shape[0]
    dev = x.device
    c = torch.sort(init_codebook.to(x.dtype).reshape(g, k), dim=-1,
                   stable=True).values
    prev_assign = torch.full((g, n), -1, dtype=torch.int64, device=dev)
    prev_dist = torch.full((g,), float("inf"), dtype=torch.float32,
                           device=dev)
    done = torch.zeros(g, dtype=torch.bool, device=dev)
    n_run = torch.zeros(g, dtype=torch.int32, device=dev)
    for _ in range(iters):
        assign = fixed_codebook_assign(x, c)
        sums, counts = _segment_sums(x, assign, k)
        c_new = torch.where(counts > 0, sums / torch.clamp(counts, min=1), c)
        c_new = torch.sort(c_new, dim=-1, stable=True).values
        changed = (assign != prev_assign).any(dim=-1)
        dist = _distortion(x, c, assign)
        plateau = (prev_dist - dist) <= tol * dist.abs()
        c = torch.where(done[:, None], c, c_new)
        n_run = n_run + (~done).to(torch.int32)
        done = done | ~changed | plateau
        prev_assign, prev_dist = assign, dist
    assign = fixed_codebook_assign(x, c)
    dist = _distortion(x, c, assign)
    return KMeansResult(c.reshape(lead + (k,)),
                        assign.to(torch.int32).reshape(w.shape),
                        dist.reshape(lead), n_run.reshape(lead))
