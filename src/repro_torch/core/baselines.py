"""Baselines the paper compares against (port of the C-step half of
``repro/core/baselines.py``, §2 and §5).

* **DC**: direct compression (Gong et al. 2015): quantize a trained
  reference net once, loss-blind; the LC path at μ→0⁺ (§3.4).
* **iDC**: iterated DC (Han et al. 2015): alternate training from the
  quantized point and re-quantizing, with no penalty or multipliers.

Both reuse the scheme / C-step machinery of :mod:`repro_torch.core.lc`.
BinaryConnect needs gradients and comes with the trainer (ROADMAP.md
module 13 part 2).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import lc as lc_mod
from repro_torch.core.schemes import Scheme

PyTree = Any


def direct_compression(gen: Optional[torch.Generator], params: PyTree,
                       scheme: Any, qspec: Optional[PyTree] = None,
                       theta0: Optional[Dict[str, Any]] = None
                       ) -> Tuple[PyTree, lc_mod.LCState]:
    """DC: Θ = Π(w̄), w_DC = Δ(Θ) → (quantized params, state).

    ``scheme`` is a bare Scheme (then ``qspec`` is required) or a
    CompressionPlan (then ``qspec`` defaults to the plan's policy).
    ``theta0``: initial states in place of the seeding
    (:func:`lc.lc_init`)."""
    if qspec is None:
        if not hasattr(scheme, "build_qspec"):
            raise TypeError("qspec required when passing a bare Scheme")
        qspec = scheme.build_qspec(params)
    cfg = getattr(scheme, "lc", None) or lc_mod.LCConfig()
    state = lc_mod.lc_init(gen, params, scheme, qspec, cfg, theta0=theta0)
    return lc_mod.finalize(params, state, qspec), state


def idc_round(params: PyTree, state: lc_mod.LCState, scheme: Scheme,
              qspec: PyTree) -> Tuple[PyTree, lc_mod.LCState]:
    """One iDC round: re-quantize the current weights (λ = 0, μ = 0)."""
    cfg = lc_mod.LCConfig(use_lagrangian=False, mu0=0.0, mu_growth=1.0)
    zero_lam = lc_mod.map_paths(lambda path, t: torch.zeros_like(t),
                                state.lam)
    st = state._replace(lam=zero_lam, mu=torch.zeros_like(state.mu))
    st = lc_mod.c_step(params, st, scheme, qspec, cfg)
    return lc_mod.finalize(params, st, qspec), st
