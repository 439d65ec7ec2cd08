"""Page gather: pool → per-slot logical view — CUDA kernel
``csrc/page_gather.cu`` and its wrapper.

Replaces ``repro/kernels/paged_attention.py:page_gather_pallas``: the
[P+1, page, ...] pool of any dtype becomes the per-slot view
[B, npg·page, ...] through the page table, with dead slots reading the
trash page 0.  Bound on the H100: bytes (the referenced pages read, the
view written).  One block per (logical page, slot) copies one page with
16-byte words; a pure copy, so it equals :func:`ref.gather_pages_ref` bit
for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _word_bytes(page_bytes: int, *tensors: torch.Tensor) -> int:
    """Widest copy word (16, 4 or 1 bytes) that divides a page and both
    base addresses."""
    for w in (16, 4):
        if page_bytes % w == 0 and all(t.data_ptr() % w == 0
                                       for t in tensors):
            return w
    return 1


def page_gather(pool: torch.Tensor, page_table: torch.Tensor,
                alive: torch.Tensor) -> torch.Tensor:
    """pool [P+1, page, ...]; page_table [B, npg] int; alive [B] bool or
    int → [B, npg·page, ...] in the pool's dtype.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if pool.ndim < 2 or page_table.ndim != 2:
        raise ValueError(f"pool {tuple(pool.shape)} / page_table "
                         f"{tuple(page_table.shape)}: need [P+1, page, ...] "
                         f"and [B, npg]")
    b, npg = page_table.shape
    if tuple(alive.shape) != (b,):
        raise ValueError(f"alive {tuple(alive.shape)} must be [{b}]")
    if not pool.is_cuda:
        return ref.gather_pages_ref(pool, page_table, alive)
    dev = pool.device
    build.operand(pool, "pool", pool.dtype, dev)
    tbl = page_table.to(device=dev, dtype=torch.int32).contiguous()
    alv = alive.to(device=dev, dtype=torch.int32).contiguous()
    page = pool.shape[1]
    out = torch.empty((b, npg * page) + tuple(pool.shape[2:]),
                      dtype=pool.dtype, device=dev)
    page_bytes = pool[0].numel() * pool.element_size()
    fn = build.function("page_gather", "repro_page_gather", _ARGTYPES)
    err = fn(pool.data_ptr(), tbl.data_ptr(), alv.data_ptr(), out.data_ptr(),
             b, npg, pool.shape[0], page_bytes,
             _word_bytes(page_bytes, pool, out), build.stream_handle(dev))
    build.check(err, "page_gather")
    page_gather.launches += 1
    return out


page_gather.launches = 0
