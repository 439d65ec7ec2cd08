"""Paged GQA decode attention over dense KV pages — CUDA kernel
``csrc/paged_attention.cu`` and its wrapper.

Replaces ``repro/kernels/paged_attention.py:paged_attention_pallas``: one
query token per engine slot attends over the slot's K/V pages through
the page table, rows past ``pos`` and dead slots masked, optional
softcap, online softmax.  Bound on the H100: bytes (the visible K/V rows).
:func:`plan` splits each slot's pages over the blocks of one thread-block
cluster (a block per split, group of query rows of a kv head, and slot),
whose partial softmax states merge in rank order on the card: one launch,
no workspace, the same bits on every call.

Dead slots: the kernel writes 0 there (the Pallas kernel's rule), while
the plain version :func:`ref.paged_attention_ref` follows the reference's
jnp spec (a uniform softmax: the mean of the trash page's V).  The engine
discards dead rows, so the two are held together on alive slots only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.codebook_matmul_packed import sm_count

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
MAX_SPLITS = 8         # blocks of one cluster (the portable limit)
MAX_REP = 4            # query rows of a block (``csrc/paged_attention.cu``)
BLOCKS_PER_SM = 4      # the blocks a plan aims at per SM (128 threads each)


class Plan(NamedTuple):
    splits: int        # blocks of one cluster, one per range of pages
    pages: int         # logical pages of a split (splits · pages ≥ npg)
    groups: int        # blocks per kv head (query rows of MAX_REP each)
    blocks: int        # blocks launched


def split_pages(npg: int, want: int) -> tuple:
    """``(splits, pages)``: at most ``want`` (and :data:`MAX_SPLITS`)
    contiguous ranges of ``pages`` logical pages that cover ``[0, npg)``,
    in order, none of them empty."""
    s = max(1, min(MAX_SPLITS, npg, want))
    pages = -(-npg // s)
    return -(-npg // pages), pages


@functools.lru_cache(maxsize=4096)
def plan(b: int, kv: int, rep: int, npg: int, sms: int) -> Plan:
    """The launch of a decode call over ``b`` slots, ``kv`` kv heads of
    ``rep`` query heads each and ``npg`` logical pages a slot, on ``sms``
    SMs: split the pages until the blocks fill about
    :data:`BLOCKS_PER_SM` a SM.  From the shapes alone (never from
    ``pos``, which lives on the card).  Cached: the engine asks for the same
    shape on every step."""
    groups = -(-rep // MAX_REP)
    units = b * kv * groups
    splits, pages = split_pages(npg, -(-BLOCKS_PER_SM * sms // units))
    return Plan(splits, pages, groups, splits * units)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    pos: torch.Tensor, alive: torch.Tensor, *,
                    softcap: Optional[float] = None,
                    scale: float) -> torch.Tensor:
    """q [B,1,H,hd]; k_pool / v_pool [P+1, page, KV, hd]; page_table
    [B, npg]; pos [B]; alive [B] → [B, 1, H·hd] f32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q.ndim != 4 or q.shape[1] != 1 or k_pool.ndim != 4:
        raise ValueError(f"q {tuple(q.shape)} / k_pool "
                         f"{tuple(k_pool.shape)}: need [B,1,H,hd] and "
                         f"[P+1, page, KV, hd]")
    b, _, h, hd = q.shape
    n_phys, page, kv, pool_hd = k_pool.shape
    if pool_hd != hd or kv <= 0 or h % kv or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} / k_pool "
                         f"{tuple(k_pool.shape)} / v_pool "
                         f"{tuple(v_pool.shape)} do not form a GQA pool")
    if page_table.ndim != 2 or page_table.shape[0] != b \
            or tuple(pos.shape) != (b,) or tuple(alive.shape) != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / pos "
                         f"{tuple(pos.shape)} / alive {tuple(alive.shape)} "
                         f"must be [{b}, npg] / [{b}] / [{b}]")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap={softcap} must be positive")
    if not q.is_cuda:
        return ref.paged_attention_ref(q, k_pool, v_pool, page_table, pos,
                                       alive, softcap=softcap, scale=scale)
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        build.operand(t, name, torch.float32, dev)
    tbl = page_table.to(device=dev, dtype=torch.int32).contiguous()
    p = pos.to(device=dev, dtype=torch.int32).contiguous()
    alv = alive.to(device=dev, dtype=torch.int32).contiguous()
    npg = page_table.shape[1]
    pl = plan(b, kv, h // kv, npg, sm_count(dev.index))
    out = torch.empty((b, 1, h * hd), dtype=torch.float32, device=dev)
    fn = build.function("paged_attention", "repro_paged_attention",
                        _ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             tbl.data_ptr(), p.data_ptr(), alv.data_ptr(), out.data_ptr(),
             b, h, kv, hd, page, npg, n_phys, pl.splits, pl.pages,
             float(scale), float(softcap or 0.0), build.stream_handle(dev))
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
