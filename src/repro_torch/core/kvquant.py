"""Codebook quantization of KV-cache pages (port of
``repro/core/kvquant.py``: the paper's eq. 14 applied to activations).

* **fit** — per-group codebooks learned at page-write time by the exact
  1-D k-means of :mod:`repro_torch.core.kmeans`, quantile-seeded, so the
  fit is deterministic (no random numbers on the serving path);
* **assign / dequant** — eq.-11 midpoint assignment and its LUT inverse;
* **pack** — the ``pack_rows`` layout built on the device inside a step
  (:func:`pack_rows_torch`), as int32 bit patterns: PyTorch can neither
  index nor ``index_put_`` a ``uint32`` CUDA tensor, nor shift one on the
  CPU, so the word pools are ``torch.int32`` and compare with the
  reference's uint32 words through ``.view(np.uint32)``;
* **byte accounting** — stored bytes of a dense or a quantized page with
  KV bits as the free variable.

Grouping modes (``kv_cb_mode``): ``"page"`` fits one codebook per page
per tensor (K and V apart); ``"head"`` one per (page, kv head).
``bits`` ∈ {2, 4, 8}: K = 2**bits codebook entries, 32 // bits lanes per
word, no index straddling two words.
"""
from __future__ import annotations

import torch

from repro_torch.core.kmeans import kmeans_fit, quantile_init

KV_BITS_CHOICES = (2, 4, 8)
# k-means iterations per page-write fit (the reference's static trip
# count: pages are small and quantile seeding is near-optimal in 1-D)
KV_FIT_ITERS = 8


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


def pack_rows_torch(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """[..., D] indices (< 2**bits) → [..., ⌈D/lanes⌉] int32 words in the
    ``pack_rows`` layout: lane l of word w holds index w·lanes+l at bit
    offset l·bits.  The lanes are OR-ed in int64 and the word is stored as
    its int32 bit pattern (bit-identical to the reference's uint32)."""
    lanes = kv_lanes(bits)
    d = idx.shape[-1]
    w = idx.to(torch.int64)
    pad = (-d) % lanes
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    w = w.reshape(w.shape[:-1] + (-1, lanes))
    word = w[..., 0]
    for lane in range(1, lanes):
        word = word | (w[..., lane] << (lane * bits))
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    return word.to(torch.int32)


def fit_codebooks(vals: torch.Tensor, bits: int,
                  iters: int = KV_FIT_ITERS) -> torch.Tensor:
    """[..., G, N] values → [..., G, K] ascending f32 codebooks: quantile
    seeding + exact 1-D k-means, one fit per group, all in one batch.
    K > N is fine (empty clusters keep their centroids: a decode
    first-write fit sees one token row per group)."""
    k = kv_entries(check_kv_bits(bits))
    flat = vals.reshape(-1, vals.shape[-1]).float()
    cbs = kmeans_fit(flat, quantile_init(flat, k), iters=iters).codebook
    return cbs.reshape(vals.shape[:-1] + (k,))


def assign_codebook(vals: torch.Tensor, cbs: torch.Tensor) -> torch.Tensor:
    """[..., G, N] values + [..., G, K] ascending codebooks → int64
    indices [..., G, N] (the reference returns int32; same values).
    Eq.-11 midpoint assignment in f32, the rule the stored pages are
    reconstructed against, so storage is idempotent."""
    mids = 0.5 * (cbs[..., 1:] + cbs[..., :-1]).float()
    v = vals.float()
    lead = torch.broadcast_shapes(mids.shape[:-1], v.shape[:-1])
    flat_m = mids.expand(lead + mids.shape[-1:]).reshape(-1, mids.shape[-1])
    flat_v = v.expand(lead + v.shape[-1:]).reshape(-1, v.shape[-1])
    idx = torch.searchsorted(flat_m.contiguous(), flat_v.contiguous(),
                             right=True)
    return idx.reshape(lead + v.shape[-1:])


def dequant_codebook(idx: torch.Tensor, cbs: torch.Tensor) -> torch.Tensor:
    """Indices [..., G, N] + codebooks [..., G, K] → values in the
    codebook dtype (a pure LUT gather)."""
    cb_b = cbs.expand(idx.shape[:-1] + cbs.shape[-1:])
    return torch.gather(cb_b, -1, idx.long())


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
