"""Codebook matmul over uint8 indices — CUDA kernel ``csrc/codebook_matmul.cu``
and its wrapper.

Replaces ``repro/kernels/codebook_matmul.py:codebook_matmul_pallas``:
y[M, N] = x[M, Kd] · cb[idx] with idx uint8 [Kd, N] (the
``--serve-layout uint8`` oracle layout, one byte per weight) and a K ≤ 256
entry f32 codebook.  Bound on the H100: the index bytes at decode, f32
FMAs at prefill.  Each block stages the codebook as a 256-entry LUT,
dequantizes a [64, 64] index tile (four bytes per load where N allows)
into shared memory per K step and accumulates a register tile in f32; at
decode the K loop is split across blocks (a partial-sum workspace from
``torch.empty`` plus an in-order second pass), as in
:mod:`repro_torch.kernels.codebook_matmul_packed`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.codebook_matmul_packed import split_k

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def codebook_matmul(x: torch.Tensor, idx: torch.Tensor,
                    codebook: torch.Tensor) -> torch.Tensor:
    """x [M, Kd] f32; idx [Kd, N] uint8; codebook [K ≤ 256] f32 → [M, N]
    f32.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if x.ndim != 2 or idx.ndim != 2 or x.shape[1] != idx.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} / idx {tuple(idx.shape)}: need "
                         f"[M, Kd] and [Kd, N]")
    if not idx.is_cuda:
        return ref.codebook_matmul_ref(x, idx, codebook)
    dev = idx.device
    build.operand(idx, "idx", torch.uint8, dev)
    build.codebook(codebook, dev)
    build.operand(x, "x", torch.float32, dev)
    m, kd = x.shape
    n = idx.shape[1]
    splits = split_k(m, n, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else out)
    fn = build.function("codebook_matmul", "repro_codebook_matmul", _ARGTYPES)
    err = fn(x.data_ptr(), idx.data_ptr(), codebook.data_ptr(),
             out.data_ptr(), partial.data_ptr(), m, kd, n,
             codebook.shape[0], splits, build.stream_handle(dev))
    build.check(err, "codebook_matmul")
    codebook_matmul.launches += 1
    return out


codebook_matmul.launches = 0
