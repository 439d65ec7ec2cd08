"""Transposed codebook matmul over a bit-packed [V, D] table (the fused
tied-embedding LM head) — CUDA kernel ``csrc/codebook_matmul_packed_t.cu``
and its wrapper.

Replaces ``repro/kernels/codebook_matmul_packed_t.py:
codebook_matmul_packed_t_pallas``: y[M, V] = x[M, D] · cb[unpack(pidx)]ᵀ
with the words in ``pack_rows`` order (pidx [V, ⌈D/lanes⌉], the serving
layout) or ``pack_indices_2d`` order (pidx [⌈V/lanes⌉, D]).  Bound on the
H100: bytes — the row words are a decode step's largest single read.  A
fixed grid of blocks stages x once in shared memory and walks the vocab,
each warp reading four rows' words coalesced and reusing every x value
across them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.compression import bits_per_index
from repro_torch.kernels import build, ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ROWS_PER_BLOCK = {"row": 32, "kd": 8}     # warps x rows per warp (the .cu)


def codebook_matmul_packed_t(x: torch.Tensor, pidx: torch.Tensor,
                             codebook: torch.Tensor, n_out: int, *,
                             order: str = "kd") -> torch.Tensor:
    """x [M, D] f32 · W[V = n_out, D]ᵀ → [M, V] f32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if order not in ("kd", "row"):
        raise ValueError(f"order={order!r}; choose kd|row")
    k_entries = codebook.shape[-1]
    bits = bits_per_index(k_entries)
    lanes = 32 // bits
    m, d = x.shape
    want = ((-(-n_out // lanes), d) if order == "kd"
            else (n_out, -(-d // lanes)))
    if tuple(pidx.shape) != want:
        layout = "pack_indices_2d" if order == "kd" else "pack_rows"
        raise ValueError(f"pidx {tuple(pidx.shape)} != {want} — operand not "
                         f"in {layout} layout for K={k_entries}")
    if not pidx.is_cuda:
        return ref.packed_codebook_matmul_t_ref(x, pidx, codebook, n_out,
                                                order=order)
    dev = pidx.device
    build.operand(pidx, "pidx", torch.uint32, dev)
    build.codebook(codebook, dev)
    build.operand(x, "x", torch.float32, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-n_out // _ROWS_PER_BLOCK[order]), 4 * sms))
    out = torch.empty((m, n_out), dtype=torch.float32, device=dev)
    fn = build.function("codebook_matmul_packed_t",
                        "repro_codebook_matmul_packed_t", _ARGTYPES)
    err = fn(x.data_ptr(), pidx.data_ptr(), codebook.data_ptr(),
             out.data_ptr(), m, d, n_out, k_entries, bits,
             int(order == "row"), blocks, build.stream_handle(dev))
    build.check(err, "codebook_matmul_packed_t")
    codebook_matmul_packed_t.launches += 1
    return out


codebook_matmul_packed_t.launches = 0
