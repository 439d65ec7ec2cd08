"""Embedding dequant-on-gather over bit-packed rows — CUDA kernel
``csrc/quantized_gather.cu`` and its wrapper.

Replaces ``repro/kernels/quantized_gather.py:quantized_gather_pallas``:
out[T, D] = codebook[unpack(pidx[tokens])] over the ``pack_rows`` table
pidx [V, ⌈D/lanes⌉] uint32.  Bound on the H100: bytes (T·⌈D/lanes⌉·4
read, T·D·4 written); one block per token stages the codebook in shared
memory and walks the token's word row coalesced.  A pure gather, so it
equals :func:`ref.quantized_gather_ref` bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.compression import bits_per_index
from repro_torch.kernels import build, ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def quantized_gather(tokens: torch.Tensor, pidx: torch.Tensor,
                     codebook: torch.Tensor, d: int) -> torch.Tensor:
    """tokens [T] int; pidx [V, ⌈d/lanes⌉] uint32; codebook [K] f32 →
    [T, d] f32.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be flat [T], got {tuple(tokens.shape)}")
    k_entries = codebook.shape[-1]
    bits = bits_per_index(k_entries)
    lanes = 32 // bits
    v, wd = pidx.shape
    if wd != -(-d // lanes):
        raise ValueError(f"pidx cols {wd} != ceil({d}/{lanes}) — operand "
                         f"not in pack_rows layout for K={k_entries}")
    if not pidx.is_cuda:
        return ref.quantized_gather_ref(tokens, pidx, codebook, d)
    dev = pidx.device
    build.operand(pidx, "pidx", torch.uint32, dev)
    build.codebook(codebook, dev)
    tok = tokens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((tok.shape[0], d), dtype=torch.float32, device=dev)
    fn = build.function("quantized_gather", "repro_quantized_gather",
                        _ARGTYPES)
    err = fn(tok.data_ptr(), pidx.data_ptr(), codebook.data_ptr(),
             out.data_ptr(), tok.shape[0], v, d, wd, k_entries, bits,
             build.stream_handle(dev))
    build.check(err, "quantized_gather")
    quantized_gather.launches += 1
    return out


quantized_gather.launches = 0
