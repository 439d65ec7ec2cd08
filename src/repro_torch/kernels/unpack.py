"""Bit-unpack + codebook dequant in plain PyTorch, under the names of
``repro/kernels/unpack.py``; the device version every CUDA kernel uses is
``csrc/unpack.cuh``.

Each uint32 word holds ``lanes = 32 // bits`` little-endian indices at a
fixed ``bits`` width (no straddling).  Two orientations:

* :func:`unpack_words_axis0` — words tile the leading axis
  (``pack_indices_2d``: word (w, n) holds rows w·lanes+l of column n);
* :func:`unpack_words_axis1` — words tile the trailing axis
  (``pack_rows``: word (r, w) holds columns w·lanes+l of row r).

Both are the artifact layer's unpacks (``core.compression``) with the
padding lanes kept.  Dequant is the K-entry LUT gather only: the
reference's one-hot variant (``REPRO_DEQUANT=onehot``) is a Mosaic
lowering workaround and gives the same values.
"""
from __future__ import annotations

import torch

from repro_torch.core.compression import unpack_indices_2d, unpack_rows


def unpack_words_axis0(words: torch.Tensor, bits: int) -> torch.Tensor:
    """[W, N] words → [W·lanes, N] int64: lane l of word (w, n) lands at
    row w·lanes + l."""
    return unpack_indices_2d(words, words.shape[0] * (32 // bits), 1 << bits)


def unpack_words_axis1(words: torch.Tensor, bits: int) -> torch.Tensor:
    """[R, W] words → [R, W·lanes] int64: lane l of word (r, w) lands at
    column w·lanes + l."""
    return unpack_rows(words, words.shape[1] * (32 // bits), 1 << bits)


def dequant_tile(idx: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Integer indices + [K] codebook → float weights (LUT gather)."""
    return cb[idx]
