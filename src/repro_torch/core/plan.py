"""CompressionPlan: the front door of the quantization pipeline (port of
``repro/core/plan.py``).

A plan bundles the scheme (Δ(Θ)/Π(w), from the ``core.schemes``
registry), the qspec policy (which leaves are quantized, which get
per-layer codebooks) and the LC hyperparameters.  The same plan drives
every stage::

    plan = CompressionPlan.parse("adaptive:16")
    qspec = plan.build_qspec(params)
    state = plan.init(gen, params, qspec)         # DC point (Θ = Π(w̄))
    state = plan.c_step(params, state, qspec)     # after each L step
    packed = plan.pack(params, state, qspec)      # → PackedModel artifact
    packed.save(path)                             # → launch.serve --packed

The sharded C step (``sharded_c_step=True``) is ROADMAP.md module 14 and
is refused.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch

from repro_torch.core import compression as C
from repro_torch.core import lc as lc_mod
from repro_torch.core.compression import DEFAULT_EXCLUDE, PackedModel
from repro_torch.core.lc import LCConfig, LCState
from repro_torch.core.schemes import Scheme, make_scheme

PyTree = Any


@dataclasses.dataclass(frozen=True)
class QSpecPolicy:
    """Which leaves quantize: path-regex exclusion + ndim thresholds."""

    exclude: str = DEFAULT_EXCLUDE.pattern
    min_ndim: int = 2
    grouped_min_ndim: int = 3

    def build(self, params: PyTree) -> PyTree:
        return lc_mod.default_qspec(
            params, exclude=re.compile(self.exclude, re.IGNORECASE),
            grouped_min_ndim=self.grouped_min_ndim, min_ndim=self.min_ndim)


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    scheme: Scheme
    qspec: QSpecPolicy = QSpecPolicy()
    lc: LCConfig = LCConfig()
    bits_ref: int = 32          # b of eq. 14: quote it with every ratio
    sharded_c_step: bool = False

    def __post_init__(self):
        if self.sharded_c_step:
            raise NotImplementedError(
                "sharded_c_step (the distributed C step over a mesh) is not "
                "ported yet: ROADMAP.md module 14")

    @classmethod
    def parse(cls, spec: str, *, lc: Optional[LCConfig] = None,
              qspec: Optional[QSpecPolicy] = None, bits_ref: int = 32,
              sharded_c_step: bool = False,
              **scheme_kw: Any) -> "CompressionPlan":
        """Build a plan from a scheme spec string (``adaptive:4`` ...)."""
        return cls(scheme=make_scheme(spec, **scheme_kw),
                   lc=lc or LCConfig(), qspec=qspec or QSpecPolicy(),
                   bits_ref=bits_ref, sharded_c_step=sharded_c_step)

    # -- pipeline stages ----------------------------------------------------

    def build_qspec(self, params: PyTree) -> PyTree:
        return self.qspec.build(params)

    def init(self, gen: Optional[torch.Generator], params: PyTree,
             qspec: Optional[PyTree] = None) -> LCState:
        """LC init at the direct-compression point."""
        qspec = self.build_qspec(params) if qspec is None else qspec
        return lc_mod.lc_init(gen, params, self.scheme, qspec, self.lc)

    def c_step(self, params: PyTree, state: LCState, qspec: PyTree,
               advance_mu: bool = True) -> LCState:
        return lc_mod.c_step(params, state, self.scheme, qspec, self.lc,
                             advance_mu=advance_mu)

    def finalize(self, params: PyTree, state: LCState,
                 qspec: PyTree) -> PyTree:
        return lc_mod.finalize(params, state, qspec)

    def pack(self, params: PyTree, state: LCState,
             qspec: Optional[PyTree] = None) -> PackedModel:
        """Finished LC run → deployable PackedModel artifact."""
        return PackedModel.pack(params, state, self, qspec=qspec,
                                bits_ref=self.bits_ref)

    # -- accounting ---------------------------------------------------------

    def summary(self, params: PyTree, state: LCState,
                qspec: Optional[PyTree] = None) -> Dict[str, Any]:
        """Eq.-14 accounting without building the packed artifact."""
        qspec = self.build_qspec(params) if qspec is None else qspec
        p1, p0 = lc_mod.param_counts(params, qspec)
        entries = lc_mod.codebook_entry_count(state, self.scheme)
        k = self.scheme.index_entries
        return {
            "scheme": self.scheme.spec,
            "k": k,
            "bits_per_weight": self.scheme.bits_per_weight,
            "p1": p1, "p0": p0, "codebook_entries": entries,
            "ratio": C.compression_ratio(p1, p0, k, entries, b=self.bits_ref),
            "packed_bytes": C.quantized_bytes(p1, p0, k, entries,
                                              b=self.bits_ref),
        }
