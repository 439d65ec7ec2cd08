"""Absorbed-MLA paged decode attention over dense latent pages — CUDA
kernel ``csrc/mla_paged_attention.cu`` and its wrapper.

Replaces ``repro/kernels/paged_attention.py:mla_paged_attention_pallas``:
one query token per engine slot and head attends over the slot's latent
rows (c [L] as key and value, its rotary key r [R]) through the page
table: softmax((q_eff·c + q_rope·r)·scale) · c, rows past ``pos`` and dead
slots masked.  Bound on the H100: bytes (the visible latent rows).
:func:`plan` splits each slot's pages over the blocks of one thread-block
cluster and its heads over groups (a block per split, head group and
slot); the splits' partial softmax states merge in rank order on the card:
one launch, no workspace, the same bits on every call.

Dead slots: the kernel writes 0 there (the Pallas kernel's rule), while
the plain version :func:`ref.mla_paged_attention_ref` follows the
reference's jnp spec (the trash page's mean latent row).  The engine
discards dead rows, so the two are held together on alive slots only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.codebook_matmul_packed import sm_count
from repro_torch.kernels.paged_attention import split_pages

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])
# The kernels' block holds every head's query row and context registers
# (``csrc/mla_attention.cuh``): at most 16 heads and a latent width of 512.
MAX_HEADS, MAX_LATENT = 16, 512


class Plan(NamedTuple):
    splits: int        # blocks of one cluster, one per range of pages
    pages: int         # logical pages of a split (splits · pages ≥ npg)
    heads: int         # heads of a block
    groups: int        # head groups (blocks per split and slot)
    blocks: int        # blocks launched


@functools.lru_cache(maxsize=4096)
def plan(b: int, h: int, npg: int, sms: int) -> Plan:
    """The launch of a decode call over ``b`` slots, ``h`` heads and
    ``npg`` logical pages a slot, on ``sms`` SMs: split the pages until the
    slots' splits fill the SMs (at most ``paged_attention.MAX_SPLITS``),
    then halve the head groups until the blocks fill half of them: every
    group reads the split's rows again (from L2 after the first), so past
    that point fewer, wider groups read less and lose little parallelism.
    From the shapes alone, never from ``pos``.  Cached."""
    splits, pages = split_pages(npg, -(-sms // b))
    groups = 1
    while groups < h and 2 * splits * groups * b < sms:
        groups *= 2
    heads = -(-h // groups)
    groups = -(-h // heads)
    return Plan(splits, pages, heads, groups, splits * groups * b)


def check_mla_operands(q_eff: torch.Tensor, q_rope: torch.Tensor,
                       c_pool: torch.Tensor, r_pool: torch.Tensor,
                       page_table: torch.Tensor, pos: torch.Tensor,
                       alive: torch.Tensor, kv_lora: int,
                       rope_dim: int) -> None:
    """Shape checks of the MLA paged-decode operands: q_eff [B,1,H,L],
    q_rope [B,1,H,R], pools (or word pools) [P+1, page, ·] on one pool
    geometry, page_table [B, npg], pos / alive [B]."""
    if q_eff.ndim != 4 or q_eff.shape[1] != 1 or q_rope.ndim != 4 \
            or q_rope.shape[:3] != q_eff.shape[:3]:
        raise ValueError(f"q_eff {tuple(q_eff.shape)} / q_rope "
                         f"{tuple(q_rope.shape)}: need [B,1,H,L] and "
                         f"[B,1,H,R]")
    if q_eff.shape[-1] != kv_lora or q_rope.shape[-1] != rope_dim:
        raise ValueError(f"q_eff / q_rope widths {q_eff.shape[-1]} / "
                         f"{q_rope.shape[-1]} != kv_lora {kv_lora} / rope "
                         f"{rope_dim}")
    if c_pool.ndim != 3 or r_pool.ndim != 3 \
            or c_pool.shape[:2] != r_pool.shape[:2]:
        raise ValueError(f"latent pools {tuple(c_pool.shape)} / "
                         f"{tuple(r_pool.shape)}: need [P+1, page, ·] each")
    b = q_eff.shape[0]
    if page_table.ndim != 2 or page_table.shape[0] != b \
            or tuple(pos.shape) != (b,) or tuple(alive.shape) != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / pos "
                         f"{tuple(pos.shape)} / alive {tuple(alive.shape)} "
                         f"must be [{b}, npg] / [{b}] / [{b}]")
    if q_eff.is_cuda and (q_eff.shape[2] > MAX_HEADS
                          or kv_lora > MAX_LATENT):
        raise ValueError(f"{q_eff.shape[2]} heads of latent width {kv_lora}:"
                         f" the CUDA kernel serves at most {MAX_HEADS} heads "
                         f"and a width of {MAX_LATENT}")


def slot_operands(page_table, pos, alive, dev):
    """The page table, positions and alive flags as contiguous int32 on
    ``dev``."""
    return [t.to(device=dev, dtype=torch.int32).contiguous()
            for t in (page_table, pos, alive)]


def mla_paged_attention(q_eff: torch.Tensor, q_rope: torch.Tensor,
                        c_pool: torch.Tensor, r_pool: torch.Tensor,
                        page_table: torch.Tensor, pos: torch.Tensor,
                        alive: torch.Tensor, *,
                        scale: float) -> torch.Tensor:
    """q_eff [B,1,H,L]; q_rope [B,1,H,R]; c_pool [P+1, page, L]; r_pool
    [P+1, page, R]; page_table [B, npg]; pos [B]; alive [B] → latent
    context [B,1,H,L] f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    check_mla_operands(q_eff, q_rope, c_pool, r_pool, page_table, pos, alive,
                       c_pool.shape[-1], r_pool.shape[-1])
    if not q_eff.is_cuda:
        return ref.mla_paged_attention_ref(q_eff, q_rope, c_pool, r_pool,
                                           page_table, pos, alive,
                                           scale=scale)
    dev = q_eff.device
    for name, t in (("q_eff", q_eff), ("q_rope", q_rope), ("c_pool", c_pool),
                    ("r_pool", r_pool)):
        build.operand(t, name, torch.float32, dev)
    b, _, h, lat = q_eff.shape
    n_phys, page, rd = r_pool.shape
    tbl, p, alv = slot_operands(page_table, pos, alive, dev)
    npg = page_table.shape[1]
    pl = plan(b, h, npg, sm_count(dev.index))
    out = torch.empty((b, 1, h, lat), dtype=torch.float32, device=dev)
    fn = build.function("mla_paged_attention", "repro_mla_paged_attention",
                        _ARGTYPES)
    err = fn(q_eff.data_ptr(), q_rope.data_ptr(), c_pool.data_ptr(),
             r_pool.data_ptr(), tbl.data_ptr(), p.data_ptr(), alv.data_ptr(),
             out.data_ptr(), b, h, lat, rd, page, npg, n_phys, pl.splits,
             pl.pages, pl.heads, float(scale), build.stream_handle(dev))
    build.check(err, "mla_paged_attention")
    mla_paged_attention.launches += 1
    return out


mla_paged_attention.launches = 0
