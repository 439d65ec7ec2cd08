"""k-means assignment with per-centroid sums and counts — CUDA kernel
``csrc/kmeans_assign.cu`` and its wrapper.

Replaces ``repro/kernels/kmeans_assign.py:kmeans_assign_pallas``: for w
[P] or [G, P] and a codebook [K] or [G, K] (K <= 256, need not be sorted),
``assign = argmin_k (w - c_k)²`` (ties to the lower index), and each
centroid's Σw and count: one streaming pass in place of the one-hot
[G, P, K] reduction.  Bound on the H100: bytes for small K (8 B a point),
operations from K of about 60.  Blocks write partial sums and counts that
a second pass adds in a fixed order, with no float atomics, so the result
is the same on every run; sums are added in f64 above each thread's 32
points and returned in f32, counts are integers returned in f32.
Assignments and counts equal :func:`ref.kmeans_assign_ref` exactly, sums
to rounding (another order of addition).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

ITEMS = 32          # points per thread per block (kItems in the source)
MAX_K = 256
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def threads_for(k: int) -> int:
    """Threads per block for K centroids: each thread keeps K f32
    accumulators in shared memory, K·T <= 8192 (T >= 32)."""
    t = 256
    while t > 32 and t * k > 8192:
        t //= 2
    return t


def kmeans_assign(w: torch.Tensor, codebook: torch.Tensor):
    """w [P] or [G, P] float; codebook [K] or [G, K] float, one per row →
    (assign int32 like w, sums f32 like codebook, counts f32 like
    codebook).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    batched = w.ndim == 2
    if w.ndim not in (1, 2) or codebook.ndim != w.ndim \
            or (batched and codebook.shape[0] != w.shape[0]):
        raise ValueError(f"w {tuple(w.shape)} / codebook "
                         f"{tuple(codebook.shape)}: need [P] / [K] or "
                         f"[G, P] / [G, K]")
    k = codebook.shape[-1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k}; the kernel takes 1..{MAX_K} centroids")
    if not w.is_cuda:
        return ref.kmeans_assign_ref(w, codebook)
    dev = w.device
    x = build.operand(w.to(torch.float32).contiguous(), "w", torch.float32,
                      dev)
    cb = build.operand(codebook.to(torch.float32).contiguous(), "codebook",
                       torch.float32, dev)
    if not batched:
        x, cb = x[None], cb[None]
    g, p = x.shape
    assign = torch.empty((g, p), dtype=torch.int32, device=dev)
    sums = torch.zeros((g, k), dtype=torch.float32, device=dev)
    counts = torch.zeros((g, k), dtype=torch.float32, device=dev)
    if g and p:
        threads = threads_for(k)
        nblk = -(-p // (threads * ITEMS))
        part_sums = torch.empty((g, k, nblk), dtype=torch.float64,
                                device=dev)
        part_counts = torch.empty((g, k, nblk), dtype=torch.int32,
                                  device=dev)
        fn = build.function("kmeans_assign", "repro_kmeans_assign",
                            _ARGTYPES)
        err = fn(x.data_ptr(), cb.data_ptr(), assign.data_ptr(),
                 part_sums.data_ptr(), part_counts.data_ptr(),
                 sums.data_ptr(), counts.data_ptr(), g, p, k, threads, nblk,
                 build.stream_handle(dev))
        build.check(err, "kmeans_assign")
        kmeans_assign.launches += 1
    if not batched:
        return assign[0], sums[0], counts[0]
    return assign, sums, counts


kmeans_assign.launches = 0
