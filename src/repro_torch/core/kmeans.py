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

The C step's fit, :func:`kmeans_fit_cstep`, is the same iteration with
its statistics kept as the ``kmeans_assign`` kernel keeps them: sums
added in f64 and rounded to f32 once, counts as integers.  The
reference's f32 running sums drift by ~1e-5 of a centroid over the 65k
points a centroid of one 1024 x 1024 layer holds, and an f32 count stops
at 2^24 (qwen's embedding has centroids with more); over 50 iterations
that moves a codebook by ~3e-5 of its largest entry.  On the CPU the
assignment is the reference's midpoint rule, so assignments, counts and
``iters_run`` still equal the reference's on the tests' groups, and the
codebooks agree to 1e-5.  On a CUDA device the assignments, sums and
counts come from the kernel (one streaming pass, the same on every run),
whose argmin sends a tie to the lower index where the midpoint rule sends
it to the larger.  On both devices the fit stops as soon as every row has
converged, and its final assignment is the midpoint rule's, as the
reference's.
The one-hot route above serves the KV page writes only: for a C-step leaf
such as qwen's 151936 x 1024 tied embedding it would build a [N, K] mask
on every iteration.

:func:`kmeans_plus_plus_init` draws from a ``torch.Generator`` in place of
the reference's ``jax.random`` key: the same seed gives the same seeds,
but not the reference's (torch has no threefry).

Not ported here (ROADMAP.md module 14, the distributed C step): point
weights and the mesh ``axis_name``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.quant_ops import fixed_codebook_assign
from repro_torch.kernels.kmeans_assign import kmeans_assign
from repro_torch.kernels.ref import segment_stats


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


def _midpoint_stats(x: torch.Tensor, c: torch.Tensor):
    """Midpoint assignment (ties to the larger index) and segment sums."""
    assign = fixed_codebook_assign(x, c)
    return (assign,) + _segment_sums(x, assign, c.shape[-1])


def _exact_stats(x: torch.Tensor, c: torch.Tensor):
    """Midpoint assignment, f64 segment sums rounded once, integer
    counts."""
    assign = fixed_codebook_assign(x, c)
    return (assign,) + segment_stats(x, assign, c.shape[-1])


def _kernel_stats(x: torch.Tensor, c: torch.Tensor):
    """Assignment, sums and counts from the ``kmeans_assign`` kernel."""
    assign, sums, counts = kmeans_assign(x, c)
    return assign.long(), sums.to(x.dtype), counts.to(x.dtype)


def cstep_stats(x: torch.Tensor, c: torch.Tensor):
    """One C-step Lloyd iteration's statistics of the rows of ``x`` [G, N]
    against the ascending ``c`` [G, K] → (assign int64, sums, counts): the
    ``kmeans_assign`` kernel on a CUDA device, the reference's midpoint
    rule on the CPU; sums in f64 and integer counts on both."""
    return (_kernel_stats if x.is_cuda else _exact_stats)(x, c)


def _lloyd(w: torch.Tensor, init_codebook: torch.Tensor, iters: int,
           tol: float, stats: Callable, stop_early: bool) -> KMeansResult:
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
        assign, sums, counts = stats(x, c)
        c_new = torch.where(counts > 0, sums / torch.clamp(counts, min=1), c)
        c_new = torch.sort(c_new, dim=-1, stable=True).values
        changed = (assign != prev_assign).any(dim=-1)
        dist = _distortion(x, c, assign)
        plateau = (prev_dist - dist) <= tol * dist.abs()
        c = torch.where(done[:, None], c, c_new)
        n_run = n_run + (~done).to(torch.int32)
        done = done | ~changed | plateau
        prev_assign, prev_dist = assign, dist
        if stop_early and bool(done.all()):
            break
    assign = fixed_codebook_assign(x, c)
    dist = _distortion(x, c, assign)
    return KMeansResult(c.reshape(lead + (k,)),
                        assign.to(torch.int32).reshape(w.shape),
                        dist.reshape(lead), n_run.reshape(lead))


def kmeans_fit(w: torch.Tensor, init_codebook: torch.Tensor,
               iters: int = 30, tol: float = 1e-4) -> KMeansResult:
    """At most ``iters`` exact 1-D k-means iterations per row of ``w``
    [..., N] from ``init_codebook`` [..., K].

    A row converges at the assignment fixpoint or on a distortion plateau
    (relative improvement <= ``tol``); its later iterations leave it as
    it is, and ``iters_run`` counts the ones that changed it.  Empty
    clusters keep their previous centroid.  A 1-D ``w`` is the
    reference's single fit."""
    return _lloyd(w, init_codebook, iters, tol, _midpoint_stats,
                  stop_early=False)


def kmeans_fit_cstep(w: torch.Tensor, init_codebook: torch.Tensor,
                     iters: int = 30, tol: float = 1e-4) -> KMeansResult:
    """The C step's :func:`kmeans_fit`: statistics from
    :func:`cstep_stats` (see the module note); the iterations stop once
    every row has converged (later ones would leave every row as it
    is)."""
    return _lloyd(w, init_codebook, iters, tol, cstep_stats,
                  stop_early=True)


def kmeans_plus_plus_init(gen: torch.Generator, w: torch.Tensor,
                          k: int) -> torch.Tensor:
    """k-means++ seeding (Arthur & Vassilvitskii 2007) of each row of
    ``w`` [..., N] → ascending [..., k], drawing from ``gen`` (on ``w``'s
    device).  Each seed after the first is drawn with probability ∝ D²
    by inverse CDF: an f64 ``cumsum`` and a ``searchsorted`` of one
    uniform draw per row (``torch.multinomial`` takes at most 2^24
    categories).  A row whose D² are all 0 draws uniformly."""
    lead, n = w.shape[:-1], w.shape[-1]
    x = w.reshape(-1, n)
    g = x.shape[0]
    dev = x.device
    first = torch.randint(0, n, (g, 1), generator=gen, device=dev)
    cents = [x.gather(1, first)]
    d2 = (x - cents[0]) ** 2
    for _ in range(1, k):
        cdf = torch.cumsum(d2, dim=-1, dtype=torch.float64)
        total = cdf[:, -1:]
        u = torch.rand((g, 1), generator=gen, device=dev,
                       dtype=torch.float64)
        idx = torch.where(total > 0,
                          torch.searchsorted(cdf, u * total, right=True),
                          (u * n).long()).clamp_(max=n - 1)
        c_new = x.gather(1, idx)
        cents.append(c_new)
        d2 = torch.minimum(d2, (x - c_new) ** 2)
    cents = torch.sort(torch.cat(cents, dim=-1), dim=-1).values
    return cents.reshape(lead + (k,))


def kmeans_quantize(w: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Δ(Θ): map each weight to its assigned codebook entry."""
    c = torch.sort(codebook).values
    return c[fixed_codebook_assign(w, c)].to(w.dtype)


def quantile_init_grouped(w: torch.Tensor, k: int) -> torch.Tensor:
    """[G, ...] weights → [G, K] quantile codebooks."""
    return quantile_init(w.reshape(w.shape[0], -1), k)
