"""Codebook matmul over bit-packed indices — CUDA kernel
``csrc/codebook_matmul_packed.cu`` and its wrapper.

Replaces ``repro/kernels/codebook_matmul_packed.py:
codebook_matmul_packed_pallas``: y[M, N] = x[M, Kd] · cb[unpack(pidx)]
with pidx the ``pack_indices_2d`` words [⌈Kd/lanes⌉, N].  Bound on the
H100: the packed words (bytes) at decode, f32 FMAs (operations) at
prefill.  Each block dequantizes a [≤64, 64] weight tile into shared
memory per K step and accumulates a register tile in f32; at decode the K
loop is split across blocks (a partial-sum workspace from
``torch.empty`` plus an in-order second pass) so the card fills.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.compression import bits_per_index
from repro_torch.kernels import build, ref

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])
_BN = 64                    # output columns per block (see the .cu)


def split_k(m: int, n: int, sm_count: int) -> int:
    """K splits for an [m, n] output: enough blocks for two per SM.  The
    kernel clamps it to the number of K steps."""
    tiles = -(-n // _BN) * -(-m // (64 if m > 16 else 16))
    return max(1, min(64, -(-2 * sm_count // tiles)))


def codebook_matmul_packed(x: torch.Tensor, pidx: torch.Tensor,
                           codebook: torch.Tensor) -> torch.Tensor:
    """x [M, Kd] f32; pidx [⌈Kd/lanes⌉, N] uint32; codebook [K] f32 →
    [M, N] f32.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    k_entries = codebook.shape[-1]
    bits = bits_per_index(k_entries)
    lanes = 32 // bits
    m, kd = x.shape
    wk, n = pidx.shape
    if wk != -(-kd // lanes):
        raise ValueError(f"pidx rows {wk} != ceil({kd}/{lanes}) — operand "
                         f"not in pack_indices_2d layout for K={k_entries}")
    if not pidx.is_cuda:
        return ref.packed_codebook_matmul_ref(x, pidx, codebook)
    dev = pidx.device
    build.operand(pidx, "pidx", torch.uint32, dev)
    build.codebook(codebook, dev)
    build.operand(x, "x", torch.float32, dev)
    splits = split_k(m, n, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else out)
    fn = build.function("codebook_matmul_packed",
                        "repro_codebook_matmul_packed", _ARGTYPES)
    err = fn(x.data_ptr(), pidx.data_ptr(), codebook.data_ptr(),
             out.data_ptr(), partial.data_ptr(), m, kd, n, wk, k_entries,
             bits, splits, build.stream_handle(dev))
    build.check(err, "codebook_matmul_packed")
    codebook_matmul_packed.launches += 1
    return out


codebook_matmul_packed.launches = 0
