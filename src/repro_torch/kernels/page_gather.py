"""Page gather: pool → per-slot logical view — CUDA kernel
``csrc/page_gather.cu`` and its wrapper.

Replaces ``repro/kernels/paged_attention.py:page_gather_pallas``: the
[P+1, page, ...] pool of any dtype becomes the per-slot view
[B, npg·page, ...] through the page table, with dead slots reading the
trash page 0.  Bound on the H100: bytes (the referenced pages read, the
view written).  One block per (8 KB chunk, logical page, slot) copies its
chunk with 16-byte words, all loads in flight before the stores; a pure
copy, so it equals :func:`ref.gather_pages_ref` bit for bit.  ``alive``
reaches the kernel as the bool, uint8 or int32 tensor the caller holds,
with no cast kernel in between.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _word_bytes(page_bytes: int, *ptrs: int) -> int:
    """Widest copy word (16, 4 or 1 bytes) that divides a page and both
    base addresses."""
    for w in (16, 4):
        if page_bytes % w == 0 and all(p % w == 0 for p in ptrs):
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
    # bool / uint8 are read as bytes, anything else as int32 words
    byte = alive.dtype in (torch.bool, torch.uint8)
    alv = alive.to(device=dev, dtype=None if byte else torch.int32)
    alv = alv.contiguous()
    page = pool.shape[1]
    out = torch.empty((b, npg * page) + tuple(pool.shape[2:]),
                      dtype=pool.dtype, device=dev)
    page_bytes = math.prod(pool.shape[1:]) * pool.element_size()
    src, dst = pool.data_ptr(), out.data_ptr()
    fn = build.function("page_gather", "repro_page_gather_alive8" if byte
                        else "repro_page_gather", _ARGTYPES)
    err = fn(src, tbl.data_ptr(), alv.data_ptr(), dst, b, npg, pool.shape[0],
             page_bytes, _word_bytes(page_bytes, src, dst),
             build.stream_handle(dev))
    build.check(err, "page_gather")
    page_gather.launches += 1
    return out


page_gather.launches = 0
