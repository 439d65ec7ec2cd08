"""Codebook matmul over bit-packed indices — CUDA kernel
``csrc/codebook_matmul_packed.cu`` (its kernels in ``csrc/codebook_mma.cuh``,
shared with row 11) and its wrapper.

Replaces ``repro/kernels/codebook_matmul_packed.py:
codebook_matmul_packed_pallas``: y[M, N] = x[M, Kd] · cb[unpack(pidx)]
with pidx the ``pack_indices_2d`` words [⌈Kd/lanes⌉, N].  :func:`plan`
picks one launch per call: at M ≤ 16 (decode) a CUDA-core kernel bound by
the words' bytes; above, 3×TF32 tensor-core tiles bound by operations.
Either may split K over the blocks of one thread-block cluster, which sum
their partials in rank order on the card: no workspace, no second launch,
the same bits on every call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.compression import bits_per_index
from repro_torch.kernels import build, ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
DECODE_MAX_M = 16      # rows of x the decode plan takes
DECODE_COLS = 32       # output columns of a decode block
MAX_SPLITS = 8         # blocks of one cluster (the portable limit)
TC_ROWS = 64           # output rows of a tensor-core tile (one wgmma)
TC_COLS = (64, 32)     # its column counts
TC_STAGES = 4          # its cp.async ring over packed words
SM_SHARED = 233472     # shared memory of an H100 SM; each block reserves 1 KB
TC_RESIDENT = 3        # blocks an SM holds at most (the kernel's register cap)
SPLITS = (1, 2, 4, 8)  # K splits: clusters of 3 or 6 blocks timed slower


class Plan(NamedTuple):
    tile: int          # 0: the decode plan; 64 / 32: tensor-core tile columns
    splits: int        # K splits, the blocks of one cluster (1..8)
    blocks: int        # blocks launched


def step_rows(bits: int) -> int:
    """Reduction rows of a tensor-core K step over ``bits``-bit words:
    whole word rows, a multiple of 8 (the mma's k) and at least 32
    (``step_words`` in ``csrc/codebook_mma.cuh``)."""
    lanes = 32 // bits
    w = 1
    while (w * lanes) % 8 or w * lanes < 32:
        w += 1
    return w * lanes


def tc_smem_bytes(step: int, cols: int, tile_bytes: int, entries: int,
                  stages: int = TC_STAGES) -> int:
    """Dynamic shared memory of a tensor-core block (``TcSmem`` in
    ``csrc/codebook_mma.cuh``): the ring of x and index tiles, two (hi, lo)
    B buffers, the (hi, lo) codebook."""
    return (stages * (TC_ROWS * (step + 4) * 4 + tile_bytes)
            + 4 * step * cols * 4 + entries * 8)


@functools.lru_cache(maxsize=4096)
def plan(m: int, kd: int, n: int, *, load_rows: int, step: int,
         sm_count: int, tile_bytes: tuple = (0, 0), entries: int = 256,
         stages: int = TC_STAGES) -> Plan:
    """The launch of an [m, kd] · [kd, n] product.

    ``load_rows``: the index rows the decode plan streams (word rows, or kd
    for uint8); ``step``: the reduction rows of a tensor-core K step;
    ``tile_bytes``: an index tile's bytes at each of ``TC_COLS``;
    ``entries``: the codebook LUT's; ``stages``: the cp.async ring's
    depth.  At m ≤ 16, 32-column blocks with K
    split until the blocks fill the SMs, never past one index row a split.
    Above, of both tile widths and every split up to the K steps, the plan
    that fills the SMs and leaves the busiest SM the least work, fewer
    blocks on a tie: waves of as many blocks as the SMs hold at once (their
    shared memory and registers decide), each block its share of the K
    steps plus about four steps of pipeline fill and cluster reduction (a
    32-column step timed about as long as a 64-column one on the H100).
    Cached: the serving path asks for the same few shapes on every step."""
    if m <= DECODE_MAX_M:
        tiles = -(-n // DECODE_COLS)
        s = max(1, min(MAX_SPLITS, load_rows, -(-sm_count // tiles)))
        return Plan(0, s, tiles * s)
    steps = max(1, -(-kd // step))
    best = None
    for cols, tb in zip(TC_COLS, tile_bytes):
        tiles = -(-m // TC_ROWS) * -(-n // cols)
        smem = tc_smem_bytes(step, cols, tb, entries, stages)
        wave = sm_count * min(TC_RESIDENT, SM_SHARED // (smem + 1024))
        for s in (s for s in SPLITS if s <= steps):
            blocks = tiles * s
            busiest = -(-blocks // wave) * (-(-steps // s) + 4)
            key = (blocks < sm_count, busiest, blocks)
            if best is None or key < best[0]:
                best = (key, Plan(cols, s, blocks))
    return best[1]


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (read once)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def packed_plan(m: int, kd: int, n: int, k_entries: int,
                sms: int) -> Plan:
    """:func:`plan` of a packed call with a ``k_entries`` codebook."""
    bits = bits_per_index(k_entries)
    lanes = 32 // bits
    step = step_rows(bits)
    return plan(m, kd, n, load_rows=-(-kd // lanes), step=step,
                sm_count=sms, entries=1 << bits,
                tile_bytes=tuple(step // lanes * (c + 8) * 4
                                 for c in TC_COLS))


def codebook_matmul_packed(x: torch.Tensor, pidx: torch.Tensor,
                           codebook: torch.Tensor) -> torch.Tensor:
    """x [M, Kd] f32; pidx [⌈Kd/lanes⌉, N] uint32; codebook [K] f32 →
    [M, N] f32.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    k_entries = codebook.shape[-1]
    bits = bits_per_index(k_entries)
    lanes = 32 // bits
    m, kd = x.shape
    wk, n = pidx.shape
    if wk != -(-kd // lanes):
        raise ValueError(f"pidx rows {wk} != ceil({kd}/{lanes}) — operand "
                         f"not in pack_indices_2d layout for K={k_entries}")
    if not pidx.is_cuda:
        return ref.packed_codebook_matmul_ref(x, pidx, codebook)
    dev = pidx.device
    build.operand(pidx, "pidx", torch.uint32, dev)
    build.codebook(codebook, dev)
    build.operand(x, "x", torch.float32, dev)
    p = packed_plan(m, kd, n, k_entries, sm_count(dev.index))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = build.function("codebook_matmul_packed",
                        "repro_codebook_matmul_packed", _ARGTYPES)
    err = fn(x.data_ptr(), pidx.data_ptr(), codebook.data_ptr(),
             out.data_ptr(), m, kd, n, wk, k_entries, bits, p.tile,
             p.splits, build.stream_handle(dev))
    build.check(err, "codebook_matmul_packed")
    codebook_matmul_packed.launches += 1
    return out


codebook_matmul_packed.launches = 0
