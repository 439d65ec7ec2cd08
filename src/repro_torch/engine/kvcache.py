"""Paged KV-cache bookkeeping: a fixed pool of fixed-size pages with a
per-slot page table (port of ``repro/engine/kvcache.py``; pure Python and
numpy).

The device-side pools live in the model cache tree
(``transformer.init_paged_cache``); this module owns the *host-side*
allocation state: the free list, per-slot ownership, and the int32 page
table the decode step consumes.  Physical page 0 is reserved as
the **trash page** — dead slots' writes and unallocated table entries
point at it, so the decode step's shapes never depend on which slots are
live.  Freeing a finished slot returns its pages to the free list
immediately (LIFO, so a queued request reuses the hottest pages first).

Not ported here: the allocator's snapshot state (ROADMAP.md module 10).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import kvquant


def kv_page_footprint(page_size: int, n_kv: int, head_dim: int,
                      kv_bits: int = 0, kv_cb_mode: str = "page",
                      itemsize: int = 4) -> int:
    """Stored HBM bytes of ONE page of ONE cached tensor (K or V).

    Dense pages store ``page·n_kv·head_dim`` scalars; quantized pages
    store bit-packed uint32 words (one row per (token, kv-head)) plus
    the per-page codebooks — the eq.-14 byte accounting with KV bits as
    the free variable.  ``bench_engine``'s equal-HBM rows and
    ``launch/report.py`` both quote this function.
    """
    if not kv_bits:
        return n_kv * kvquant.dense_page_bytes(page_size, head_dim,
                                               itemsize)
    kvquant.check_kv_bits(kv_bits)
    n_cb = n_kv if kv_cb_mode == "head" else 1
    word_bytes = page_size * n_kv * kvquant.words_per(head_dim,
                                                      kv_bits) * 4
    return word_bytes + n_cb * kvquant.kv_entries(kv_bits) * itemsize


def mla_page_footprint(page_size: int, kv_lora: int, rope_dim: int,
                       kv_bits: int = 0, itemsize: int = 4) -> int:
    """Stored HBM bytes of ONE latent page (c_kv + k_rope tensors)."""
    if not kv_bits:
        return (kvquant.dense_page_bytes(page_size, kv_lora, itemsize)
                + kvquant.dense_page_bytes(page_size, rope_dim, itemsize))
    kvquant.check_kv_bits(kv_bits)
    return (kvquant.quant_page_bytes(page_size, kv_lora, kv_bits, 1,
                                     itemsize)
            + kvquant.quant_page_bytes(page_size, rope_dim, kv_bits, 1,
                                       itemsize))


def mla_equal_hbm_slots(n_slots: int, page_size: int, kv_lora: int,
                        rope_dim: int, kv_bits: int,
                        itemsize: int = 4) -> int:
    """:func:`equal_hbm_slots` for latent pages: how many slots fit in the
    HBM of ``n_slots`` dense latent slots once the pages quantize to
    ``kv_bits``."""
    dense = mla_page_footprint(page_size, kv_lora, rope_dim, 0, itemsize)
    quant = mla_page_footprint(page_size, kv_lora, rope_dim, kv_bits,
                               itemsize)
    return max(n_slots, n_slots * dense // quant)


def equal_hbm_slots(n_slots: int, page_size: int, n_kv: int, head_dim: int,
                    kv_bits: int, kv_cb_mode: str = "page",
                    itemsize: int = 4) -> int:
    """How many slots fit in the HBM that ``n_slots`` dense-KV slots
    occupy, once pages quantize to ``kv_bits`` (slots scale with the
    page-byte ratio; pages per slot are geometry-fixed)."""
    dense = kv_page_footprint(page_size, n_kv, head_dim, 0,
                              itemsize=itemsize)
    quant = kv_page_footprint(page_size, n_kv, head_dim, kv_bits,
                              kv_cb_mode, itemsize)
    return max(n_slots, n_slots * dense // quant)


class PagePool:
    """Host-side page allocator for ``n_slots`` batch slots.

    Usable physical pages are 1..n_pages (0 is the trash page); each
    slot may own at most ``max_pages_per_slot`` (== ceil(max_seq /
    page_size)).
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_pages_per_slot: int):
        if n_pages < 1:
            raise ValueError("need at least one usable page")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.max_pages_per_slot = max_pages_per_slot
        self._free = list(range(n_pages, 0, -1))     # LIFO reuse
        self._owned = [[] for _ in range(n_slots)]
        self._seized = []         # pages withheld by pressure injection
        self.table = np.zeros((n_slots, max_pages_per_slot), np.int32)
        self.version = 0          # bumped on any table change (host cache
        #                           of the device-side table keys on it)

    # -- accounting ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Pages owned by live slots.  Seized pages are *withheld*, not
        used — they report via :attr:`seized`, so a pressure spike never
        inflates utilization into looking like real KV residency."""
        return self.n_pages - len(self._free) - len(self._seized)

    def utilization(self) -> float:
        """Fraction of the pool owned by live slots (excludes seized)."""
        return self.used_pages / max(self.n_pages, 1)

    def pages_of(self, slot: int):
        return list(self._owned[slot])

    def pages_for_len(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    # -- alloc / free -------------------------------------------------------

    def alloc(self, slot: int, n: int = 1) -> bool:
        """Append ``n`` pages to ``slot``; all-or-nothing."""
        if (len(self._free) < n
                or len(self._owned[slot]) + n > self.max_pages_per_slot):
            return False
        for _ in range(n):
            pg = self._free.pop()
            self.table[slot, len(self._owned[slot])] = pg
            self._owned[slot].append(pg)
        self.version += 1
        return True

    def ensure(self, slot: int, pos: int) -> bool:
        """Slot's pages cover logical position ``pos`` (alloc on demand).

        Returns False when the pool is exhausted (the engine then masks
        the slot for this step — a *stall*, resolved when another slot
        frees pages or by preemption)."""
        need = pos // self.page_size + 1
        if need > self.max_pages_per_slot:
            return False
        while len(self._owned[slot]) < need:
            if not self.alloc(slot, 1):
                return False
        return True

    def free_slot(self, slot: int) -> int:
        """Release every page of ``slot`` back to the pool."""
        n = len(self._owned[slot])
        while self._owned[slot]:
            self._free.append(self._owned[slot].pop())
        self.table[slot, :] = 0
        if n:
            self.version += 1
        return n

    # -- pressure injection (chaos harness) ---------------------------------

    @property
    def seized(self) -> int:
        """Pages currently withheld from the free list by an injected
        pressure spike (the chaos harness, ROADMAP.md module 10)."""
        return len(self._seized)

    def seize(self, n: int) -> int:
        """Withhold up to ``n`` free pages (a simulated pressure spike:
        the allocator behaves exactly as if neighbors held them).  Never
        touches owned pages — live requests' KV is untouchable.  Returns
        how many were actually seized."""
        taken = 0
        while taken < n and self._free:
            self._seized.append(self._free.pop())
            taken += 1
        return taken

    def release(self, n: Optional[int] = None) -> int:
        """Return ``n`` seized pages (default: all) to the free list.
        Tolerates over-release."""
        if n is None:
            n = len(self._seized)
        given = 0
        while given < n and self._seized:
            self._free.append(self._seized.pop())
            given += 1
        return given
