"""Paged GQA decode attention over codebook-quantized KV pages — CUDA
kernel ``csrc/paged_attention_quant.cu`` and its wrapper.

Replaces ``repro/kernels/paged_attention.py:paged_attention_quant_pallas``:
the decode of :mod:`repro_torch.kernels.paged_attention` over word pools
[P+1, page, KV, Wd] (``pack_rows`` layout, int32 bit patterns) and one
codebook per page and group [P+1, Gcb, 2**bits] (Gcb = 1 or KV), unpacked
(shift+mask) and dequantized through a LUT inside the kernel.  Bound on
the H100: bytes (the visible rows' words, bits/32 of the dense pages').
One block per (kv head, slot) loops over the slot's pages and stops at
the page holding ``pos``; dead slots get 0 (the plain version
:func:`ref.paged_attention_quant_ref` follows the jnp spec there, so the
two are held together on alive slots only).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import kvquant
from repro_torch.kernels import build, ref

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def check_quant_operands(k_words: torch.Tensor, v_words: torch.Tensor,
                         k_cb: torch.Tensor, v_cb: torch.Tensor, *,
                         bits: int, head_dim: int) -> None:
    """Shape checks the reference makes before its quantized kernels: the
    word width is ⌈head_dim/lanes⌉, a codebook has 2**bits entries, one per
    page or one per kv head."""
    kvquant.check_kv_bits(bits)
    if v_words.shape != k_words.shape or v_cb.shape != k_cb.shape:
        raise ValueError(f"K/V operands differ: words {tuple(k_words.shape)}"
                         f" / {tuple(v_words.shape)}, codebooks "
                         f"{tuple(k_cb.shape)} / {tuple(v_cb.shape)}")
    wd = k_words.shape[-1]
    if wd != kvquant.words_per(head_dim, bits):
        raise ValueError(f"word operand width {wd} != ceil({head_dim}/lanes)"
                         f" for kv_bits={bits}")
    if k_cb.shape[-1] != kvquant.kv_entries(bits):
        raise ValueError(f"codebook K={k_cb.shape[-1]} != 2**{bits}")
    gcb, kv = k_cb.shape[-2], k_words.shape[-2]
    if gcb not in (1, kv):
        raise ValueError(f"{gcb} codebook groups per page: need 1 (page "
                         f"mode) or {kv} (head mode)")


def paged_attention_quant(q: torch.Tensor, k_words: torch.Tensor,
                          v_words: torch.Tensor, k_cb: torch.Tensor,
                          v_cb: torch.Tensor, page_table: torch.Tensor,
                          pos: torch.Tensor, alive: torch.Tensor, *,
                          bits: int, head_dim: int,
                          softcap: Optional[float] = None,
                          scale: float) -> torch.Tensor:
    """q [B,1,H,hd]; k_words / v_words [P+1, page, KV, Wd] 32-bit words;
    k_cb / v_cb [P+1, Gcb, 2**bits] f32; page_table [B, npg]; pos [B];
    alive [B] → [B, 1, H·hd] f32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if q.ndim != 4 or q.shape[1] != 1 or k_words.ndim != 4 \
            or k_cb.ndim != 3:
        raise ValueError(f"q {tuple(q.shape)} / k_words "
                         f"{tuple(k_words.shape)} / k_cb {tuple(k_cb.shape)}:"
                         f" need [B,1,H,hd], [P+1, page, KV, Wd] and "
                         f"[P+1, Gcb, K]")
    b, _, h, hd = q.shape
    n_phys, page, kv, wd = k_words.shape
    if hd != head_dim or kv <= 0 or h % kv or k_cb.shape[0] != n_phys:
        raise ValueError(f"q {tuple(q.shape)} / k_words "
                         f"{tuple(k_words.shape)} / k_cb {tuple(k_cb.shape)}"
                         f" do not form a GQA pool of head_dim {head_dim}")
    check_quant_operands(k_words, v_words, k_cb, v_cb, bits=bits,
                         head_dim=head_dim)
    if page_table.ndim != 2 or page_table.shape[0] != b \
            or tuple(pos.shape) != (b,) or tuple(alive.shape) != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / pos "
                         f"{tuple(pos.shape)} / alive {tuple(alive.shape)} "
                         f"must be [{b}, npg] / [{b}] / [{b}]")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap={softcap} must be positive")
    if not q.is_cuda:
        return ref.paged_attention_quant_ref(
            q, k_words, v_words, k_cb, v_cb, page_table, pos, alive,
            bits=bits, head_dim=head_dim, softcap=softcap, scale=scale)
    dev = q.device
    build.operand(q, "q", torch.float32, dev)
    for name, t in (("k_words", k_words), ("v_words", v_words)):
        build.operand(t, name, t.dtype, dev)
        if t.dtype not in (torch.int32, torch.uint32):
            raise TypeError(f"{name} must be 32-bit words, got {t.dtype}")
    for name, t in (("k_cb", k_cb), ("v_cb", v_cb)):
        build.operand(t, name, torch.float32, dev)
    tbl = page_table.to(device=dev, dtype=torch.int32).contiguous()
    p = pos.to(device=dev, dtype=torch.int32).contiguous()
    alv = alive.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((b, 1, h * hd), dtype=torch.float32, device=dev)
    fn = build.function("paged_attention_quant",
                        "repro_paged_attention_quant", _ARGTYPES)
    err = fn(q.data_ptr(), k_words.data_ptr(), v_words.data_ptr(),
             k_cb.data_ptr(), v_cb.data_ptr(), tbl.data_ptr(), p.data_ptr(),
             alv.data_ptr(), out.data_ptr(), b, h, kv, hd, wd,
             k_cb.shape[1], page, page_table.shape[1], n_phys, bits,
             float(scale), float(softcap or 0.0), build.stream_handle(dev))
    build.check(err, "paged_attention_quant")
    paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0
