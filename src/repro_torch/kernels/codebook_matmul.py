"""Codebook matmul over uint8 indices — CUDA kernel ``csrc/codebook_matmul.cu``
(its kernels in ``csrc/codebook_mma.cuh``, shared with row 1) and its
wrapper.

Replaces ``repro/kernels/codebook_matmul.py:codebook_matmul_pallas``:
y[M, N] = x[M, Kd] · cb[idx] with idx uint8 [Kd, N] (the
``--serve-layout uint8`` oracle layout, one byte per weight) and a K ≤ 256
entry f32 codebook.  The launch plans of
:mod:`repro_torch.kernels.codebook_matmul_packed` with a byte operand: at
M ≤ 16 a CUDA-core kernel bound by the index bytes (4-byte loads where
N % 4 == 0), above it 3×TF32 tensor-core tiles over the codebook as 256
(hi, lo) TF32 pairs; K split over a cluster's blocks, one launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.codebook_matmul_packed import (TC_COLS, Plan, plan,
                                                        sm_count)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
STEP_ROWS = 32         # index rows of a tensor-core K step (the .cu's)
STAGES = 3             # its cp.async ring (the .cu's)


@functools.lru_cache(maxsize=4096)
def uint8_plan(m: int, kd: int, n: int, sms: int) -> Plan:
    """:func:`~repro_torch.kernels.codebook_matmul_packed.plan` of a uint8
    call: the decode plan streams kd index rows."""
    return plan(m, kd, n, load_rows=kd, step=STEP_ROWS, sm_count=sms,
                entries=256, stages=STAGES,
                tile_bytes=tuple(STEP_ROWS * (c + 4) for c in TC_COLS))


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
    p = uint8_plan(m, kd, n, sm_count(dev.index))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = build.function("codebook_matmul", "repro_codebook_matmul", _ARGTYPES)
    err = fn(x.data_ptr(), idx.data_ptr(), codebook.data_ptr(),
             out.data_ptr(), m, kd, n, codebook.shape[0], p.tile, p.splits,
             build.stream_handle(dev))
    build.check(err, "codebook_matmul")
    codebook_matmul.launches += 1
    return out


codebook_matmul.launches = 0
