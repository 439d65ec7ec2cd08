"""Fixed-codebook quantizers (binary / ternary / powers of two) — CUDA
kernel ``csrc/fixed_quant.cu`` and its wrapper.

Replaces ``repro/kernels/fixed_quant.py:fixed_quant_pallas``:
``scale · Q(w / scale)`` elementwise over any shape, f32 or bf16 in and
out, f32 arithmetic inside, Q one of ``sgn``, ``sgn · 1[|t| >= ½]`` and
Theorem A.1's power-of-two rounding with C = ``pow2_c``.  Bound on the
H100: bytes (one read and one write per element); a grid-stride sweep.
Binary and ternary equal :func:`ref.fixed_quant_ref` bit for bit; pow2
too, except where two libraries' ``log2`` differ by an ulp at a rounding
threshold of the exponent (``|t|`` near ``1.5·2^-n``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MODES = ref.FIXED_QUANT_MODES
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])


def fixed_quant(w: torch.Tensor, mode: str, *, pow2_c: int = 4,
                scale: float = 1.0) -> torch.Tensor:
    """Quantize ``w`` (any shape, f32 or bf16) with a fixed codebook →
    the same shape and dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}; choose one of {MODES}")
    if pow2_c < 0 or not scale > 0:
        raise ValueError(f"pow2_c={pow2_c} must be >= 0 and scale={scale} "
                         f"> 0")
    if not w.is_cuda:
        return ref.fixed_quant_ref(w, mode, pow2_c, scale)
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    src = w.contiguous()
    out = torch.empty_like(src)
    fn = build.function("fixed_quant", "repro_fixed_quant", _ARGTYPES)
    err = fn(src.data_ptr(), out.data_ptr(), src.numel(), _DTYPES[w.dtype],
             MODES.index(mode), pow2_c, float(scale),
             build.stream_handle(w.device))
    build.check(err, "fixed_quant")
    fixed_quant.launches += 1
    return out


fixed_quant.launches = 0
