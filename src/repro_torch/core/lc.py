"""The LC (learning-compression) algorithm state and its C step (port of
``repro/core/lc.py``, paper §3).

Augmented-Lagrangian alternation over a params tree:

    L step:  w   ← argmin_w  L(w) + μ/2 ||w - w_C - λ/μ||²      (SGD)
    C step:  Θ   ← Π(w - λ/μ)   per quantization group           (exact)
             w_C ← Δ(Θ)
    λ ← λ - μ (w - w_C)
    μ ← μ₀ aʲ

This module owns the algorithm state and the tree plumbing.  The L step
(the trainer, ROADMAP.md module 13 part 2) is not ported yet;
:func:`penalty_grad` is what it will add to the loss gradient.

Representation (the reference's):
* ``w_c`` / ``lam`` are trees congruent with ``params``; on leaves that
  are not quantized they hold the raw weight / zeros.
* ``theta`` is a flat ``{leaf path: scheme state}`` dict keyed by the
  reference's ``keystr`` paths (``"['stacks'][0]['pos0']['mlp']['w_in']"``).
* ``grouped`` leaves carry a leading stacked-layer axis G and get one
  codebook per layer (paper §5.3), the scheme's batch axis.

Trees are nested dicts and tuples of tensors.  Paths are visited in the
reference's flatten order (dict keys sorted), so :func:`quant_leaf_paths`
equals the reference's list.  The reference draws one ``jax.random`` key
per leaf; here the leaves' seeding draws from one ``torch.Generator`` in
that order.
"""
from __future__ import annotations

import dataclasses
import re
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Tuple)

import torch

from repro_torch.core.compression import DEFAULT_EXCLUDE
from repro_torch.core.schemes import Scheme, as_scheme

PyTree = Any


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    quantize: bool
    grouped: bool = False   # leading axis = per-layer codebook groups


@dataclasses.dataclass(frozen=True)
class LCConfig:
    mu0: float = 1e-3
    mu_growth: float = 1.1          # μ_j = μ0 · growth^j (paper §3.3)
    num_lc_iters: int = 30
    inner_alternations: int = 1     # (L,C) alternations per μ
    tol: float = 1e-6               # stop when RMS(w - w_C) < tol
    use_lagrangian: bool = True     # False → quadratic-penalty method (λ≡0)


class LCState(NamedTuple):
    w_c: PyTree                  # Δ(Θ); raw weights on unquantized leaves
    lam: PyTree                  # Lagrange multipliers; zeros elsewhere
    theta: Dict[str, Any]        # leaf path → scheme state
    mu: torch.Tensor             # current penalty weight, f32
    lc_iter: torch.Tensor        # outer iteration j, int32


# ---------------------------------------------------------------------------
# Trees by path
# ---------------------------------------------------------------------------

def tree_items(tree: PyTree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def map_paths(fn: Callable, tree: PyTree, *rest: PyTree,
              prefix: str = "") -> PyTree:
    """The tree of ``fn(path, leaf, *rest_leaves)``, congruent with
    ``tree`` (the ``rest`` trees congruent too)."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, *(r[k] for r in rest),
                             prefix=f"{prefix}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_paths(fn, v, *(r[i] for r in rest),
                                    prefix=f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


# ---------------------------------------------------------------------------
# QuantSpec construction
# ---------------------------------------------------------------------------

def default_qspec(params: PyTree, exclude: re.Pattern = DEFAULT_EXCLUDE,
                  grouped_min_ndim: int = 3, min_ndim: int = 2) -> PyTree:
    """Quantize every leaf with ndim ≥ ``min_ndim`` whose path avoids
    ``exclude``; leaves with ndim ≥ ``grouped_min_ndim`` are stacked-layer
    tensors [G, ...] with one codebook per group."""
    def make(path, leaf):
        if leaf.ndim < min_ndim or exclude.search(path):
            return LeafSpec(quantize=False)
        return LeafSpec(quantize=True, grouped=leaf.ndim >= grouped_min_ndim)

    return map_paths(make, params)


def quant_leaf_paths(qspec: PyTree) -> List[str]:
    """Ordered quantized-leaf paths (the theta keys)."""
    return [p for p, spec in tree_items(qspec) if spec.quantize]


def _grouped_lookup(qspec: PyTree) -> Dict[str, bool]:
    return {p: spec.grouped for p, spec in tree_items(qspec)}


def _map_quant(fn: Callable, qspec: PyTree, params: PyTree, *rest: PyTree,
               default: Callable = lambda path, w, *r: w) -> PyTree:
    """Map over paths: ``fn(path, w, *rest)`` on quantized leaves,
    ``default`` elsewhere.  All trees congruent with ``params``."""
    def go(path, w, spec, *r):
        return (fn if spec.quantize else default)(path, w, *r)

    return map_paths(go, params, qspec, *rest)


# ---------------------------------------------------------------------------
# Algorithm steps
# ---------------------------------------------------------------------------

def init_theta(gen: Optional[torch.Generator], params: PyTree,
               scheme: Scheme, qspec: PyTree) -> Dict[str, Any]:
    """Θ before the first C step: ``scheme.init`` of every quantized leaf,
    in :func:`quant_leaf_paths` order, drawing from ``gen``."""
    scheme = as_scheme(scheme)
    grouped = _grouped_lookup(qspec)
    leaves = dict(tree_items(params))
    return {p: scheme.init(gen, leaves[p], grouped=grouped[p])
            for p in quant_leaf_paths(qspec)}


def lc_init(gen: Optional[torch.Generator], params: PyTree, scheme: Scheme,
            qspec: PyTree, config: LCConfig,
            theta0: Optional[Dict[str, Any]] = None) -> LCState:
    """Initialize at the direct-compression point (μ→0⁺, λ=0): Θ = Π(w̄).

    ``theta0`` replaces :func:`init_theta`'s seeding with given initial
    states (for instance the reference's, carried over as arrays, or the
    seeds of a run to be replayed on another device)."""
    scheme = as_scheme(scheme)
    grouped = _grouped_lookup(qspec)
    theta = init_theta(gen, params, scheme, qspec) if theta0 is None \
        else theta0
    new_theta: Dict[str, Any] = {}

    def init_leaf(path, w):
        q, new_theta[path] = scheme.c_step(w, theta[path], first=True,
                                           grouped=grouped[path])
        return q.to(w.dtype)

    w_c = _map_quant(init_leaf, qspec, params)
    lam = map_paths(lambda path, w: torch.zeros_like(w), params)
    dev = next(iter(dict(tree_items(params)).values())).device
    return LCState(w_c=w_c, lam=lam,
                   theta={p: new_theta[p] for p in quant_leaf_paths(qspec)},
                   mu=torch.tensor(config.mu0, dtype=torch.float32,
                                   device=dev),
                   lc_iter=torch.tensor(0, dtype=torch.int32, device=dev))


def c_step(params: PyTree, state: LCState, scheme: Scheme, qspec: PyTree,
           config: LCConfig, advance_mu: bool = True) -> LCState:
    """One C step + multiplier + μ update (paper figs. 2/3/4 loop body).
    ``advance_mu=False`` holds μ for inner (L,C) alternations."""
    scheme = as_scheme(scheme)
    mu = state.mu
    grouped = _grouped_lookup(qspec)
    new_theta: Dict[str, Any] = {}

    def do_c(path, w, lam):
        ws = w - lam / torch.clamp(mu, min=1e-30)   # w - λ/μ
        q, new_theta[path] = scheme.c_step(ws, state.theta[path],
                                           first=False,
                                           grouped=grouped[path])
        return q.to(w.dtype)

    w_c = _map_quant(do_c, qspec, params, state.lam)
    if config.use_lagrangian:
        lam = _map_quant(lambda path, lam, w, q: lam - mu * (w - q),
                         qspec, state.lam, params, w_c,
                         default=lambda path, lam, w, q: lam)
    else:
        lam = state.lam
    return LCState(w_c=w_c, lam=lam,
                   theta={p: new_theta[p] for p in quant_leaf_paths(qspec)},
                   mu=mu * config.mu_growth if advance_mu else mu,
                   lc_iter=state.lc_iter + 1)


def penalty_grad(params: PyTree, state: LCState, qspec: PyTree) -> PyTree:
    """∇_w of μ/2||w - w_C - λ/μ||² = μ(w - w_C) - λ; zeros on unquantized
    leaves."""
    return _map_quant(lambda path, w, q, lam: state.mu * (w - q) - lam,
                      qspec, params, state.w_c, state.lam,
                      default=lambda path, w, q, lam: torch.zeros_like(w))


def _leaf_sum(tree: PyTree) -> torch.Tensor:
    return sum(v for _, v in tree_items(tree))


def penalty_value(params: PyTree, state: LCState,
                  qspec: PyTree) -> torch.Tensor:
    """μ/2 ||w - w_C - λ/μ||² (the L step's penalty, for logging)."""
    mu = torch.clamp(state.mu, min=1e-30)

    def sq(path, w, q, lam):
        d = (w - q - lam / mu).reshape(-1)
        return torch.dot(d, d)

    vals = _map_quant(sq, qspec, params, state.w_c, state.lam,
                      default=lambda path, w, q, lam: torch.zeros(
                          (), dtype=w.dtype, device=w.device))
    return 0.5 * state.mu * _leaf_sum(vals)


def feasibility_gap(params: PyTree, state: LCState,
                    qspec: PyTree) -> torch.Tensor:
    """RMS of (w - w_C) over quantized elements, the stopping criterion."""
    def sq(path, w, q):
        d = (w - q).reshape(-1)
        return torch.dot(d, d)

    vals = _map_quant(sq, qspec, params, state.w_c,
                      default=lambda path, w, q: torch.zeros(
                          (), dtype=torch.float32, device=w.device))
    p1, _ = param_counts(params, qspec)
    return torch.sqrt(_leaf_sum(vals) / max(p1, 1))


def finalize(params: PyTree, state: LCState, qspec: PyTree) -> PyTree:
    """The feasible (quantized) model: quantized leaves ← Δ(Θ)."""
    return _map_quant(lambda path, w, q: q, qspec, params, state.w_c,
                      default=lambda path, w, q: w)


def param_counts(params: PyTree, qspec: PyTree) -> Tuple[int, int]:
    """(P1, P0): quantized vs non-quantized element counts (eq. 14)."""
    p1 = p0 = 0
    specs = dict(tree_items(qspec))
    for path, w in tree_items(params):
        if specs[path].quantize:
            p1 += w.numel()
        else:
            p0 += w.numel()
    return p1, p0


def codebook_entry_count(state: LCState, scheme: Scheme) -> int:
    """Total stored float entries across per-group codebooks (eq. 14)."""
    scheme = as_scheme(scheme)
    n = 0
    for th in state.theta.values():
        first = next(iter(th.values()))
        if first.ndim == 0:
            groups = 1
        elif scheme.codebook_entries <= 1:
            groups = first.shape[0]
        else:   # adaptive: codebook is [K] or [G, K]
            cb = th["codebook"]
            groups = cb.shape[0] if cb.ndim == 2 else 1
        n += groups * scheme.codebook_entries
    return n
