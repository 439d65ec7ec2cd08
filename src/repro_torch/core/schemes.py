"""Quantization scheme registry: pluggable C-step solvers (port of
``repro/core/schemes.py``).

A scheme bundles the decompression form Δ(Θ) with its optimal C-step
solver Π(w) (paper §4), behind one small interface that the LC algorithm,
the baselines and the packer share:

    state = scheme.init(gen, w, grouped)             # Θ (codebook / scale)
    q, state = scheme.c_step(w, state, first, grouped)   # solve eq. (8)
    scheme.bits_per_weight                           # storage accounting

``w`` is one quantization group, or with ``grouped=True`` a stack of
groups along its leading axis, each with its own Θ: the batch dimension
written out where the reference ``jax.vmap``s the same methods.  A
grouped state carries the leading axis G on every entry.

``gen`` is a ``torch.Generator`` (the reference's ``jax.random`` key),
used only by k-means++ seeding.  On a CUDA device the adaptive schemes'
Lloyd iterations run the ``kmeans_assign`` kernel and the fixed schemes
run the ``fixed_quant`` kernel; on the CPU both take the reference's
arithmetic (``core.kmeans``, ``core.quant_ops``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import quant_ops
from repro_torch.core.kmeans import (cstep_stats, kmeans_fit_cstep,
                                     kmeans_plus_plus_init, quantile_init)
from repro_torch.kernels.fixed_quant import fixed_quant

SchemeState = Dict[str, torch.Tensor]


def _rows(w: torch.Tensor, grouped: bool) -> torch.Tensor:
    """One row per quantization group: [G, N] (G = 1 when not grouped)."""
    return w.reshape(w.shape[0] if grouped else 1, -1)


def _unrow(t: torch.Tensor, grouped: bool) -> torch.Tensor:
    """Drop the group axis of a per-row result when not grouped."""
    return t if grouped else t[0]


def _gather(cb: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """cb [G, K] at assign [G, N] → [G, N]."""
    return torch.gather(cb, 1, assign.long())


@dataclasses.dataclass(frozen=True)
class Scheme:
    """Base class; concrete schemes override the methods below."""

    name: str = "base"

    # -- storage accounting ------------------------------------------------
    @property
    def bits_per_weight(self) -> int:
        raise NotImplementedError

    @property
    def codebook_entries(self) -> int:
        """Float entries stored beside the indices (K, or 1 for a scale)."""
        raise NotImplementedError

    @property
    def index_entries(self) -> int:
        """Size of the assignment index space (the K of pack_indices)."""
        raise NotImplementedError

    @property
    def spec(self) -> str:
        """Canonical ``make_scheme`` spec string (artifact manifests)."""
        return self.name

    # -- algorithm ----------------------------------------------------------
    def init(self, gen: torch.Generator, w: torch.Tensor,
             grouped: bool = False) -> SchemeState:
        raise NotImplementedError

    def c_step(self, w: torch.Tensor, state: SchemeState,
               first: bool = False, grouped: bool = False
               ) -> Tuple[torch.Tensor, SchemeState]:
        """Solve Π(w): return (quantized weights, new Θ state)."""
        raise NotImplementedError

    def assignments(self, w: torch.Tensor, state: SchemeState,
                    grouped: bool = False) -> torch.Tensor:
        """Codebook indices for packing / serving (int64, w's shape)."""
        raise NotImplementedError

    def decode(self, assign: torch.Tensor, state: SchemeState,
               grouped: bool = False) -> torch.Tensor:
        """Δ(Θ): indices → quantized weights."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AdaptiveScheme(Scheme):
    """Adaptive codebook of size K: the C step is exact 1-D k-means
    (§4.1)."""

    k: int = 4
    iters_first: int = 50
    iters_warm: int = 5
    init_method: str = "kmeans++"   # or "quantile" (deterministic)
    name: str = "adaptive"

    @property
    def bits_per_weight(self) -> int:
        return max(1, math.ceil(math.log2(self.k)))

    @property
    def codebook_entries(self) -> int:
        return self.k

    @property
    def index_entries(self) -> int:
        return self.k

    @property
    def spec(self) -> str:
        return f"{self.name}:{self.k}"

    def init(self, gen, w, grouped=False):
        x = _rows(w, grouped)
        if self.init_method == "kmeans++":
            cb = kmeans_plus_plus_init(gen, x, self.k)
        else:
            cb = quantile_init(x, self.k)
        iters = torch.zeros(x.shape[0], dtype=torch.int32, device=w.device)
        return {"codebook": _unrow(cb, grouped),
                "kmeans_iters": _unrow(iters, grouped)}

    def c_step(self, w, state, first=False, grouped=False):
        iters = self.iters_first if first else self.iters_warm
        x = _rows(w, grouped)
        cb = state["codebook"].reshape(x.shape[0], -1)
        res = kmeans_fit_cstep(x, cb, iters=iters)
        q = _gather(res.codebook, res.assignments).reshape(w.shape)
        return q.to(w.dtype), {"codebook": _unrow(res.codebook, grouped),
                               "kmeans_iters": _unrow(res.iters_run,
                                                      grouped)}

    def assignments(self, w, state, grouped=False):
        x = _rows(w, grouped)
        cb = state["codebook"].reshape(x.shape[0], -1)
        return quant_ops.fixed_codebook_assign(x, cb).reshape(w.shape)

    def decode(self, assign, state, grouped=False):
        cb = state["codebook"].reshape(-1, state["codebook"].shape[-1])
        a = assign.reshape(cb.shape[0], -1)
        return _gather(cb, a).reshape(assign.shape)


@dataclasses.dataclass(frozen=True)
class AdaptiveZeroScheme(AdaptiveScheme):
    """Adaptive codebook with one centroid pinned at 0: quantization and
    pruning together (paper §4.2, footnote 2).  The C step runs ``iters``
    k-means iterations over the free centroids, with the zero entry taking
    part in the assignments, and re-pins it after each update."""

    name: str = "adaptive_zero"

    @staticmethod
    def _pin_zero(cb: torch.Tensor) -> torch.Tensor:
        """Set each row's entry nearest 0 to 0 and sort: cb [G, K]."""
        zi = torch.argmin(cb.abs(), dim=-1, keepdim=True)
        pinned = cb.scatter(-1, zi, torch.zeros_like(zi, dtype=cb.dtype))
        return torch.sort(pinned, dim=-1).values

    def init(self, gen, w, grouped=False):
        st = super().init(gen, w, grouped)
        cb = st["codebook"].reshape(-1, self.k)
        st["codebook"] = _unrow(self._pin_zero(cb), grouped)
        return st

    def c_step(self, w, state, first=False, grouped=False):
        iters = self.iters_first if first else self.iters_warm
        x = _rows(w, grouped)
        cb = state["codebook"].reshape(x.shape[0], -1)
        for _ in range(iters):
            _, sums, counts = cstep_stats(x, cb)
            c_new = torch.where(counts > 0,
                                sums / torch.clamp(counts, min=1), cb)
            cb = self._pin_zero(c_new)
        assign = quant_ops.fixed_codebook_assign(x, cb)
        q = _gather(cb, assign).reshape(w.shape)
        n_it = torch.full((x.shape[0],), iters, dtype=torch.int32,
                          device=w.device)
        return q.to(w.dtype), {"codebook": _unrow(cb, grouped),
                               "kmeans_iters": _unrow(n_it, grouped)}

    def sparsity(self, w: torch.Tensor, state: SchemeState,
                 grouped: bool = False) -> torch.Tensor:
        """Fraction of weights pruned (assigned to the zero centroid)."""
        q = self.decode(self.assignments(w, state, grouped), state, grouped)
        return (q == 0.0).float().mean()


@dataclasses.dataclass(frozen=True)
class FixedScheme(Scheme):
    """Parameter-free fixed codebook: binary / ternary / pow2(C) (§4.2)."""

    kind: str = "binary"          # binary | ternary | pow2
    pow2_c: int = 4
    name: str = "fixed"

    def _codebook(self, dtype, device=None) -> torch.Tensor:
        if self.kind == "binary":
            vals = [-1.0, 1.0]
        elif self.kind == "ternary":
            vals = [-1.0, 0.0, 1.0]
        elif self.kind == "pow2":
            mags = [0.0] + [2.0 ** (-c) for c in range(self.pow2_c + 1)]
            vals = sorted({s * m for m in mags for s in (-1.0, 1.0)})
        else:
            raise ValueError(self.kind)
        return torch.tensor(vals, dtype=dtype, device=device)

    @property
    def _k(self) -> int:
        return {"binary": 2, "ternary": 3}.get(self.kind,
                                               2 * (self.pow2_c + 1) + 1)

    @property
    def bits_per_weight(self) -> int:
        return max(1, math.ceil(math.log2(self._k)))

    @property
    def codebook_entries(self) -> int:
        return 0  # fixed values: nothing stored

    @property
    def index_entries(self) -> int:
        return self._k

    @property
    def spec(self) -> str:
        return f"pow2:{self.pow2_c}" if self.kind == "pow2" else self.kind

    def init(self, gen, w, grouped=False):
        cb = self._codebook(torch.float32, w.device)
        if grouped:
            cb = cb.expand(w.shape[0], -1).contiguous()
        return {"codebook": cb}

    def c_step(self, w, state, first=False, grouped=False):
        if w.is_cuda:
            # The fixed_quant kernel at scale 1, where its division by the
            # scale is exact, so it computes the reference's operator.
            return fixed_quant(w, self.kind, pow2_c=self.pow2_c), state
        if self.kind == "binary":
            return quant_ops.binarize(w), state
        if self.kind == "ternary":
            return quant_ops.ternarize(w), state
        return quant_ops.pow2_quantize(w, self.pow2_c), state

    def assignments(self, w, state, grouped=False):
        x = _rows(w, grouped)
        cb = state["codebook"].to(w.dtype).reshape(-1, self._k)
        return quant_ops.fixed_codebook_assign(x, cb).reshape(w.shape)

    def decode(self, assign, state, grouped=False):
        cb = state["codebook"].reshape(-1, self._k)
        a = assign.reshape(cb.shape[0], -1)
        return _gather(cb, a).reshape(assign.shape)


@dataclasses.dataclass(frozen=True)
class ScaledFixedScheme(Scheme):
    """Fixed codebook with a learned global scale a (§4.2.1, Theorems
    A.2/A.3).  Its C step keeps the plain torch operators on every device:
    ``ternarize_scale`` tests ``|w| >= a/2``, while ``fixed_quant`` with
    ``scale=a`` would test ``|w/a| >= 1/2``, which rounds differently at
    the threshold."""

    kind: str = "binary_scale"    # binary_scale | ternary_scale
    name: str = "scaled_fixed"

    @property
    def _k(self) -> int:
        return 2 if self.kind == "binary_scale" else 3

    @property
    def bits_per_weight(self) -> int:
        return 1 if self.kind == "binary_scale" else 2

    @property
    def codebook_entries(self) -> int:
        return 1  # the scale

    @property
    def index_entries(self) -> int:
        return self._k

    @property
    def spec(self) -> str:
        return self.kind

    def _base(self, dtype, device) -> torch.Tensor:
        return torch.tensor([-1.0, 1.0] if self.kind == "binary_scale"
                            else [-1.0, 0.0, 1.0], dtype=dtype,
                            device=device)

    def init(self, gen, w, grouped=False):
        return {"scale": _unrow(_rows(w, grouped).abs().mean(dim=-1),
                                grouped)}

    def c_step(self, w, state, first=False, grouped=False):
        solve = (quant_ops.binarize_scale if self.kind == "binary_scale"
                 else quant_ops.ternarize_scale)
        if not grouped:
            q, a = solve(w)
            return q, {"scale": a}
        qs, scales = zip(*(solve(wg) for wg in w))
        return torch.stack(qs), {"scale": torch.stack(scales)}

    def assignments(self, w, state, grouped=False):
        x = _rows(w, grouped)
        a = state["scale"].reshape(-1, 1)
        return quant_ops.fixed_codebook_assign(
            x, a * self._base(w.dtype, w.device)).reshape(w.shape)

    def decode(self, assign, state, grouped=False):
        a = state["scale"].reshape(-1, 1)
        cb = a * self._base(torch.float32, assign.device)
        return _gather(cb, assign.reshape(cb.shape[0], -1)).reshape(
            assign.shape)


def as_scheme(obj: Any) -> Scheme:
    """Normalize a plan-or-scheme argument: anything carrying a Scheme
    under ``.scheme`` (a CompressionPlan) unwraps; a Scheme passes
    through."""
    scheme = getattr(obj, "scheme", obj)
    if not isinstance(scheme, Scheme):
        raise TypeError(f"expected a Scheme or CompressionPlan, got {obj!r}")
    return scheme


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SchemeFactory = Callable[..., Scheme]
_REGISTRY: Dict[str, SchemeFactory] = {}


def register_scheme(name: str, *aliases: str):
    """Decorator registering ``factory(arg: Optional[str], **kw) -> Scheme``
    under ``name`` (+ aliases); ``arg`` is the text after the first ``:``
    of a spec like ``adaptive:4``."""
    def deco(factory: SchemeFactory) -> SchemeFactory:
        for n in (name,) + aliases:
            if n in _REGISTRY:
                raise ValueError(f"scheme {n!r} registered twice")
            _REGISTRY[n] = factory
        return factory
    return deco


def registered_schemes() -> List[str]:
    return sorted(_REGISTRY)


def parse_spec(spec: str) -> Tuple[str, Optional[str]]:
    """``"adaptive:4"`` → ``("adaptive", "4")``; ``"binary"`` →
    ``("binary", None)``.  Validates the name against the registry."""
    name, _, arg = spec.partition(":")
    name = name.strip()
    if name not in _REGISTRY:
        raise ValueError(f"unknown scheme spec {spec!r}; registered: "
                         f"{registered_schemes()}")
    return name, (arg.strip() or None) if arg else None


def _int_arg(name: str, arg: Optional[str], default: int, lo: int) -> int:
    if arg is None:
        return default
    try:
        val = int(arg)
    except ValueError as e:
        raise ValueError(f"scheme {name!r}: arg {arg!r} is not an int") from e
    if val < lo:
        raise ValueError(f"scheme {name!r}: arg must be ≥ {lo}, got {val}")
    return val


@register_scheme("adaptive")
def _make_adaptive(arg: Optional[str] = None, **kw: Any) -> Scheme:
    k = _int_arg("adaptive", arg, kw.pop("k", 4), lo=2)
    return AdaptiveScheme(k=k, **kw)


@register_scheme("adaptive_zero")
def _make_adaptive_zero(arg: Optional[str] = None, **kw: Any) -> Scheme:
    k = _int_arg("adaptive_zero", arg, kw.pop("k", 4), lo=2)
    return AdaptiveZeroScheme(k=k, **kw)


@register_scheme("pow2")
def _make_pow2(arg: Optional[str] = None, **kw: Any) -> Scheme:
    c = _int_arg("pow2", arg, kw.pop("pow2_c", 4), lo=0)
    return FixedScheme(kind="pow2", pow2_c=c, **kw)


def _register_parameter_free(kind: str, cls) -> None:
    @register_scheme(kind)
    def factory(arg: Optional[str] = None, **kw: Any) -> Scheme:
        if arg is not None:
            raise ValueError(f"scheme {kind!r} takes no arg, got {arg!r}")
        kw.setdefault("kind", kind)
        return cls(**kw)


for _kind in ("binary", "ternary"):
    _register_parameter_free(_kind, FixedScheme)
for _kind in ("binary_scale", "ternary_scale"):
    _register_parameter_free(_kind, ScaledFixedScheme)


def make_scheme(spec: str, **kw: Any) -> Scheme:
    """Resolve a spec string (``adaptive:4``, ``binary``,
    ``ternary_scale``, ``pow2:4``) through the registry."""
    name, arg = parse_spec(spec)
    return _REGISTRY[name](arg, **kw)
