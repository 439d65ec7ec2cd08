"""Blockwise (chunked-prompt) prefill attention over a dense K/V view —
CUDA kernel ``csrc/blockwise_prefill.cu`` and its wrapper.

Replaces ``repro/kernels/blockwise_prefill.py:blockwise_prefill_pallas``
(the dense variant; the quantized one is
:mod:`repro_torch.kernels.blockwise_prefill_quant`).  C prompt queries attend over a stored view of S rows with GQA
grouping, position-derived masking (``k_pos <= q_pos``, optional window),
optional softcap and an online softmax over ``token_tile`` rows.  Bound
on the H100: operations, small at the serving shapes.  One block per
(group of query rows, kv head, batch row), each warp owning a few rows,
folds the view's visible tiles one after another (tiles no query of the
block sees are skipped, which changes no bit), with the next K/V tile
loading by ``cp.async`` while the current one is folded and
register-blocked f32 FMA products.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])


def blockwise_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None, scale: float,
                      token_tile: int) -> torch.Tensor:
    """q [B,C,H,hd]; k [B,S,KV,hd]; v [B,S,KV,vd]; q_pos [C]; k_pos [S]
    (S a multiple of ``token_tile``) → [B,C,H,vd] f32.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    b, c, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    if s % token_tile:
        raise ValueError(f"view rows {s} not a multiple of "
                         f"token_tile={token_tile}")
    if h % kv or k.shape[0] != b or k.shape[-1] != hd \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} do not form a GQA view")
    if tuple(q_pos.shape) != (c,) or tuple(k_pos.shape) != (s,):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / k_pos "
                         f"{tuple(k_pos.shape)} must be [{c}] / [{s}]")
    if window is not None and window <= 0:
        raise ValueError(f"window={window} must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap={softcap} must be positive")
    if not q.is_cuda:
        return ref.blockwise_prefill_ref(q, k, v, q_pos, k_pos,
                                         window=window, softcap=softcap,
                                         scale=scale, token_tile=token_tile)
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.operand(t, name, torch.float32, dev)
    qp = q_pos.to(device=dev, dtype=torch.int32).contiguous()
    kp = k_pos.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((b, c, h, vd), dtype=torch.float32, device=dev)
    fn = build.function("blockwise_prefill", "repro_blockwise_prefill",
                        _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
             kp.data_ptr(), out.data_ptr(), b, c, h, kv, s, hd, vd,
             token_tile, float(scale), float(softcap or 0.0),
             int(window or 0), build.stream_handle(dev))
    build.check(err, "blockwise_prefill")
    blockwise_prefill.launches += 1
    return out


blockwise_prefill.launches = 0
