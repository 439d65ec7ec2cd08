"""Absorbed-MLA paged decode attention over codebook-quantized latent pages
— CUDA kernel ``csrc/mla_paged_attention_quant.cu`` and its wrapper.

Replaces ``repro/kernels/paged_attention.py:
mla_paged_attention_quant_pallas``: the decode of
:mod:`repro_torch.kernels.mla_paged_attention` over word pools
c_words [P+1, page, ⌈L/lanes⌉] and r_words [P+1, page, ⌈R/lanes⌉]
(``pack_rows`` layout, int32 bit patterns) with one codebook per page and
tensor [P+1, 1, 2**bits], unpacked (shift+mask) and dequantized through a
LUT inside the kernel.  Bound on the H100: bytes (the visible rows'
words, bits/32 of the dense pages').  Dead slots get 0 (the plain version
follows the jnp spec there, so the two are held together on alive slots
only).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import kvquant
from repro_torch.kernels import build, ref
from repro_torch.kernels.mla_paged_attention import (check_mla_operands,
                                                     slot_operands)

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])


def mla_paged_attention_quant(q_eff: torch.Tensor, q_rope: torch.Tensor,
                              c_words: torch.Tensor, r_words: torch.Tensor,
                              c_cb: torch.Tensor, r_cb: torch.Tensor,
                              page_table: torch.Tensor, pos: torch.Tensor,
                              alive: torch.Tensor, *, bits: int,
                              kv_lora: int, rope_dim: int,
                              scale: float) -> torch.Tensor:
    """q_eff [B,1,H,L]; q_rope [B,1,H,R]; c_words / r_words [P+1, page,
    Wc / Wr] 32-bit words; c_cb / r_cb [P+1, 1, 2**bits] f32; page_table
    [B, npg]; pos [B]; alive [B] → latent context [B,1,H,L] f32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    kvquant.check_kv_bits(bits)
    check_mla_operands(q_eff, q_rope, c_words, r_words, page_table, pos,
                       alive, kv_lora, rope_dim)
    wc, wr = c_words.shape[-1], r_words.shape[-1]
    if wc != kvquant.words_per(kv_lora, bits) \
            or wr != kvquant.words_per(rope_dim, bits):
        raise ValueError(f"latent word widths ({wc},{wr}) don't match "
                         f"kv_bits={bits} for dims ({kv_lora},{rope_dim})")
    n_phys = c_words.shape[0]
    k = kvquant.kv_entries(bits)
    for name, cb in (("c_cb", c_cb), ("r_cb", r_cb)):
        if tuple(cb.shape) != (n_phys, 1, k):
            raise ValueError(f"{name} {tuple(cb.shape)} != ({n_phys}, 1, "
                             f"{k}): one codebook per latent page")
    if not q_eff.is_cuda:
        return ref.mla_paged_attention_quant_ref(
            q_eff, q_rope, c_words, r_words, c_cb, r_cb, page_table, pos,
            alive, bits=bits, kv_lora=kv_lora, rope_dim=rope_dim,
            scale=scale)
    dev = q_eff.device
    for name, t in (("q_eff", q_eff), ("q_rope", q_rope), ("c_cb", c_cb),
                    ("r_cb", r_cb)):
        build.operand(t, name, torch.float32, dev)
    for name, t in (("c_words", c_words), ("r_words", r_words)):
        build.operand(t, name, t.dtype, dev)
        if t.dtype not in (torch.int32, torch.uint32):
            raise TypeError(f"{name} must be 32-bit words, got {t.dtype}")
    b, _, h, _ = q_eff.shape
    page = c_words.shape[1]
    tbl, p, alv = slot_operands(page_table, pos, alive, dev)
    out = torch.empty((b, 1, h, kv_lora), dtype=torch.float32, device=dev)
    fn = build.function("mla_paged_attention_quant",
                        "repro_mla_paged_attention_quant", _ARGTYPES)
    err = fn(q_eff.data_ptr(), q_rope.data_ptr(), c_words.data_ptr(),
             r_words.data_ptr(), c_cb.data_ptr(), r_cb.data_ptr(),
             tbl.data_ptr(), p.data_ptr(), alv.data_ptr(), out.data_ptr(), b,
             h, kv_lora, rope_dim, wc, wr, page, page_table.shape[1], n_phys,
             bits, float(scale), build.stream_handle(dev))
    build.check(err, "mla_paged_attention_quant")
    mla_paged_attention_quant.launches += 1
    return out


mla_paged_attention_quant.launches = 0
