"""Blockwise (chunked-prompt) prefill attention over a codebook-quantized
K/V page view — CUDA kernel ``csrc/blockwise_prefill_quant.cu`` and its
wrapper.

Replaces ``repro/kernels/blockwise_prefill.py:
blockwise_prefill_quant_pallas``: the contract of
:mod:`repro_torch.kernels.blockwise_prefill` (q_pos / k_pos visibility,
optional window and softcap, online softmax over ``token_tile`` rows) over
a gathered word view [B, S, KV, Wd] (``pack_rows`` layout) with one
codebook per page and group [B, npg, Gcb, 2**bits]; the token tile
divides the page, so a tile reads one page's codebooks.  Bound on the
H100: operations at the serving shape.  One block per (query chunk, kv
head, batch row) unpacks and LUT-dequantizes one tile at a time into
shared memory and skips tiles no query of its chunk sees.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_attention_quant import check_quant_operands

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])


def blockwise_prefill_quant(q: torch.Tensor, k_words: torch.Tensor,
                            v_words: torch.Tensor, k_cb: torch.Tensor,
                            v_cb: torch.Tensor, q_pos: torch.Tensor,
                            k_pos: torch.Tensor, *, page_size: int,
                            bits: int, head_dim: int,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None, scale: float,
                            token_tile: int) -> torch.Tensor:
    """q [B,C,H,hd]; k_words / v_words [B,S,KV,Wd] 32-bit words; k_cb /
    v_cb [B, S/page_size, Gcb, 2**bits] f32; q_pos [C]; k_pos [S] →
    [B,C,H,hd] f32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if q.ndim != 4 or k_words.ndim != 4 or k_cb.ndim != 4:
        raise ValueError(f"q {tuple(q.shape)} / k_words "
                         f"{tuple(k_words.shape)} / k_cb {tuple(k_cb.shape)}:"
                         f" need [B,C,H,hd], [B,S,KV,Wd] and [B,npg,Gcb,K]")
    b, c, h, hd = q.shape
    s, kv, wd = k_words.shape[1], k_words.shape[2], k_words.shape[3]
    if page_size % token_tile or s % page_size:
        raise ValueError(f"token_tile={token_tile} must divide "
                         f"page_size={page_size} (view rows {s})")
    if hd != head_dim or kv <= 0 or h % kv or k_words.shape[0] != b \
            or tuple(k_cb.shape[:2]) != (b, s // page_size):
        raise ValueError(f"q {tuple(q.shape)} / k_words "
                         f"{tuple(k_words.shape)} / k_cb {tuple(k_cb.shape)}"
                         f" do not form a GQA view of head_dim {head_dim} "
                         f"and page {page_size}")
    check_quant_operands(k_words, v_words, k_cb, v_cb, bits=bits,
                         head_dim=head_dim)
    if tuple(q_pos.shape) != (c,) or tuple(k_pos.shape) != (s,):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / k_pos "
                         f"{tuple(k_pos.shape)} must be [{c}] / [{s}]")
    if window is not None and window <= 0:
        raise ValueError(f"window={window} must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap={softcap} must be positive")
    if not q.is_cuda:
        return ref.blockwise_prefill_quant_ref(
            q, k_words, v_words, k_cb, v_cb, q_pos, k_pos,
            page_size=page_size, bits=bits, head_dim=head_dim, window=window,
            softcap=softcap, scale=scale, token_tile=token_tile)
    dev = q.device
    build.operand(q, "q", torch.float32, dev)
    for name, t in (("k_words", k_words), ("v_words", v_words)):
        build.operand(t, name, t.dtype, dev)
        if t.dtype not in (torch.int32, torch.uint32):
            raise TypeError(f"{name} must be 32-bit words, got {t.dtype}")
    for name, t in (("k_cb", k_cb), ("v_cb", v_cb)):
        build.operand(t, name, torch.float32, dev)
    qp = q_pos.to(device=dev, dtype=torch.int32).contiguous()
    kp = k_pos.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((b, c, h, hd), dtype=torch.float32, device=dev)
    fn = build.function("blockwise_prefill_quant",
                        "repro_blockwise_prefill_quant", _ARGTYPES)
    err = fn(q.data_ptr(), k_words.data_ptr(), v_words.data_ptr(),
             k_cb.data_ptr(), v_cb.data_ptr(), qp.data_ptr(), kp.data_ptr(),
             out.data_ptr(), b, c, h, kv, s, hd, wd, k_cb.shape[2],
             page_size, token_tile, bits, float(scale),
             float(softcap or 0.0), int(window or 0),
             build.stream_handle(dev))
    build.check(err, "blockwise_prefill_quant")
    blockwise_prefill_quant.launches += 1
    return out


blockwise_prefill_quant.launches = 0
