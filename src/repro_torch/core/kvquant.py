"""eq.-14 byte accounting of KV-cache pages (port of the byte helpers of
``repro/core/kvquant.py``).

Only the arithmetic is ported here: how many bytes a dense or a
codebook-quantized page stores, with KV bits as the free variable.  The
codebook fit, assignment and in-step packing are ROADMAP.md module 7.
"""
from __future__ import annotations

KV_BITS_CHOICES = (2, 4, 8)


def check_kv_bits(bits: int) -> int:
    if bits not in KV_BITS_CHOICES:
        raise ValueError(f"kv_bits={bits}; choose one of {KV_BITS_CHOICES} "
                         f"(0 disables KV quantization)")
    return bits


def kv_entries(bits: int) -> int:
    return 1 << bits


def kv_lanes(bits: int) -> int:
    return 32 // bits


def words_per(d: int, bits: int) -> int:
    """uint32 words per packed feature row of true width ``d``."""
    return -(-d // kv_lanes(bits))


def quant_page_bytes(page_size: int, feat: int, bits: int, n_cb: int,
                     itemsize: int = 4) -> int:
    """Stored bytes of one quantized page of ``feat`` features/token:
    packed words + ``n_cb`` per-page codebooks of K = 2**bits entries."""
    check_kv_bits(bits)
    word_bytes = page_size * words_per(feat, bits) * 4
    cb_bytes = n_cb * kv_entries(bits) * itemsize
    return word_bytes + cb_bytes


def dense_page_bytes(page_size: int, feat: int, itemsize: int = 4) -> int:
    return page_size * feat * itemsize
