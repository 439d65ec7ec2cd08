#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one CUDA card

1. Prints the card (``nvidia-smi`` name and power limit) and builds every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, in parallel), printing ``-Xptxas -v`` for each.
2. Per kernel: holds it against its plain PyTorch version on the card at
   small ragged shapes and at the serving paths' shapes (the packed and
   uint8 codebook matmuls for K in {2, 4, 16, 256}; the page gather, the
   paged decode attention and the blockwise prefill, MLA's hd 192 / vd
   128 and the engine's one-slot view included, for several head
   groupings, head dims, page sizes,
   softcaps, positions and dead slots; the MLA paged decode over dense
   and over 2/4/8-bit latent pages; the two quantized-KV attention
   kernels for kv bits {2, 4, 8} x codebook mode {page, head}; quantized
   pools written by the port's quantizing write path or random words
   with sorted codebooks; the C step's k-means assignment at P = 2^20
   and 2^23, K = 16, batched [24, 2^20], and K in {2, 4, 256} unsorted at
   a ragged P; the fixed quantizers in every mode, C in {4, 7}, f32 and
   bf16, at Theorem A.1's threshold inputs too), and times it (CUDA events, and device time
   from the profiler, with the mean of a second pass in mirrored order
   beside it; the prefill also at the engine's shape) beside the plain version, one
   PyTorch library call
   as a yardstick (none reads packed KV words: the quantized kernels
   stand beside their dense kernel at the same shape instead), and the
   least time the card could take (the larger of bytes / 3.35 TB/s and
   FLOPs / 67 TFLOP/s f32).  The two codebook matmuls are also held at
   the engine's one-slot prefill block (M = 64), checked for equal bits on
   two calls, and timed at M = 4, 64 and 256 with their launch plan and a
   second bound, 3xTF32 on the tensor cores (three passes at 495 TFLOP/s).
3. C-step path at full width: compresses a random ``qwen1.5-0.5b`` (weights
   from a seed) on the card by direct compression with
   ``CompressionPlan.parse("adaptive:16")`` (k-means++ seeds, up to 50
   Lloyd iterations through the ``kmeans_assign`` kernel), packs and saves
   it, then DC with ``ternary`` and ``pow2:4`` through the ``fixed_quant``
   kernel, each leaf held against the plain version on the card; the
   counters zeroed before must show both kernels and no other.  Layer 0's
   q and first MLP group are replayed on the CPU route from the card's
   seeds (codebooks, words, distortion held).  The adaptive artifact is
   what every later qwen phase serves.  One-shot path at full width:
   serves it through
   ``repro_torch.launch.serve --packed DIR --no-engine --batch 4
   --prompt-len 128 --gen-len 16`` with the launch counters zeroed just
   before, checks that exactly the kernels of that path ran, and re-runs
   the same steps with the plain versions (the CPU route) teacher-forced
   on the served tokens, comparing the logits at every step; then
   profiles a prefill and 4 decode steps.  The same with
   ``--serve-layout uint8`` (the uint8 matmul kernel, held the same way).
4. Engine path at full width: serves the same artifact through the
   launcher's default engine mode (``--requests 8 --slots 4 --prompt-len
   128 --gen-len 16 --vary-gen --page-size 16``) with the counters zeroed
   just before, checks its six kernels ran, then again on an
   oversubscribed pool (``--pages 25``) that must stall; every finished
   stream is teacher-forced through the plain route on the CPU and each
   engine token must be its argmax or a near tie.  Then profiles an
   engine prefill step and 4 engine decode steps.
5. Quantized-KV engine path at full width: the same requests with
   ``--kv-bits 4`` twice (the streams must be equal bit for bit: the
   codebook fit is deterministic on the card) and ``--kv-bits 8 --kv-cb
   head`` once, counters zeroed before each serve: the quantized kernels
   must run and the dense attention kernels must not.  Prints the page
   pools' bytes beside the dense ones, holds every stream against the
   port's quantized path on the CPU teacher-forced on the card's pages,
   and profiles a quantized prefill step and 4 decode steps.
6. ``deepseek-v2-lite-16b`` (MLA + MoE) at full width, cut to 3 of its 27
   layers (the dense layer and two MoE layers): a random K=16 artifact
   built on the card, served one-shot (batch 4, prompt 128, 16 tokens),
   through the engine on dense latent pages and on 4-bit latent pages
   (the engine path's requests), each with the counters zeroed and its
   kernels checked, its latent pools' bytes held against
   ``mla_page_footprint``, its MoE routes recorded, and its logits or
   tokens held against the CPU replay of the same steps on the card's
   routes (and, on 4-bit pages, the card's page writes); then profiled.
7. Prints one JSON line of per-kernel results, the card line, and last
   ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
   before that line; so does a machine without a CUDA device.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # the same, f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # the same, dense TF32 on the tensor cores
KS = (2, 4, 16, 256)
K_MAIN = 16
L2_BYTES = 50 * 2 ** 20
# Relative tolerance of an f32 kernel against its plain version: both sum
# the same f32 products (up to a few thousand per output) in different
# orders, which moves a result by about sqrt(n) * 2^-24 relative to the
# largest term (~1e-6); 1e-4 leaves two orders of margin.
REL_TOL = 1e-4
# Serving logits, kernel route on the card vs plain route on the CPU, same
# tokens fed: 24 layers of f32 sums in different orders; relative to the
# largest logit.
LOGIT_REL_TOL = 1e-3
# A MoE route that differs between the card and the CPU replay must be a
# near tie: the CPU's probabilities at the first differing rank and the
# next within this fraction of the row's largest probability.
ROUTE_TIE_REL = 1e-5


class SmokeFailure(RuntimeError):
    pass


class Shapes:
    """The serving path's kernel shapes for one config and serve size
    (``batch`` is the one-shot batch and the engine's slot count)."""

    def __init__(self, cfg, batch: int, prompt_len: int, gen_len: int,
                 block: int, page: int = 16):
        self.cfg, self.batch = cfg, batch
        self.prompt_len, self.gen_len, self.block = prompt_len, gen_len, block
        # the engine's default pool: every slot holds max_seq in pages
        self.page = page
        self.npg = -(-(prompt_len + gen_len) // page)
        self.n_phys = batch * self.npg + 1
        self.v, self.d, self.f = cfg.vocab, cfg.d_model, cfg.d_ff
        self.h, self.kv, self.hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
        # (Kd, N) of every projection: q/k/v/o, w_in/w_gate, w_out
        self.proj = ((self.d, self.h * self.hd), (self.d, self.f),
                     (self.f, self.d))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Time per ``fn()`` call between CUDA events around ``iters``
    back-to-back calls (the host's launch rate when it cannot keep the card
    busy)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = getattr(event, "self_cuda_time_total", 0.0)
    return us / 1e3


def device_ms(fn, iters: int = 20):
    """Device kernel time per ``fn()`` call (CUPTI, through torch.profiler):
    what the card spends, without the host's launch overhead that
    :func:`cuda_ms` includes when launches cannot keep the card busy.
    None when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # per kernel: its mean time times its launches per call; a launch
    # record the tracer drops then lowers no call's time (each kernel of
    # ``fn`` runs a whole number of times, at least once, per call)
    total = sum(_device_ms(e) / e.count * max(1, round(e.count / iters))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count)
    return total if total > 0 else None


def time_all(kernel, plain, library, plain_iters: int = 30,
             **others) -> dict:
    """Event times (per call, launches back to back) and device times of a
    kernel wrapper, its plain version, the library yardstick (None where
    no PyTorch call computes the function) and any ``others`` (timed as
    ``<name>_ms``).  ``device_<key>`` is one profiler pass taken right
    after each function's event timing, in that order (kernel first);
    ``mirrored_device_<key>`` is its mean with a second pass in the
    reverse order (kernel last), printed beside it so that a clock that
    drifts during the phase shows."""
    out = {}
    fns = [("ms", kernel, 30), ("plain_ms", plain, plain_iters),
           ("library_ms", library, 30)]
    fns += [(f"{name}_ms", fn, 30) for name, fn in others.items()]
    for key, fn, iters in fns:
        if fn is None:
            out[key] = out["device_" + key] = None
            out["mirrored_device_" + key] = None
            continue
        out[key] = cuda_ms(fn, iters=iters)
        out["device_" + key] = device_ms(fn, iters=min(iters, 20))
    for key, fn, iters in fns[::-1]:
        if fn is None:
            continue
        first, again = out["device_" + key], device_ms(fn,
                                                       iters=min(iters, 20))
        out["mirrored_device_" + key] = (None if None in (first, again)
                                         else (first + again) / 2)
    return out


def copies_for(nbytes: int) -> int:
    """Operand copies to cycle through so repeated launches read device
    memory, not L2, as the serving path does (its weights far exceed L2)."""
    return max(1, min(64, -(-2 * L2_BYTES // max(nbytes, 1))))


def bound(nbytes: float, flops: float,
          flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def matmul_timings(label: str, kernel, plain, library, *, m: int, kd: int,
                   n: int, index_bytes: int, err: float, plan) -> dict:
    """``time_all`` of one codebook matmul shape, with its f32 bound (the
    products on the CUDA cores) and its 3xTF32 bound (three TF32 passes on
    the tensor cores) beside the launch plan that ran."""
    nbytes = m * kd * 4 + index_bytes + K_MAIN * 4 + m * n * 4
    b_ms, b_by = bound(nbytes, 2 * m * kd * n)
    tc_ms, tc_by = bound(nbytes, 3 * 2 * m * kd * n, TF32_FLOPS_PER_S)
    t = dict(shape=f"M={m} Kd={kd} N={n} K={K_MAIN}{label} plan {plan}",
             max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
             tc_bound_ms=tc_ms, tc_bound_by=tc_by,
             **time_all(kernel, plain, library))
    print(f"  timing {t}")
    return t


def compare(name: str, got: torch.Tensor, want: torch.Tensor, *,
            exact: bool = False, rel_tol: float = REL_TOL) -> float:
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise SmokeFailure(f"{name}: non-finite output")
    err = (got.double() - want.double()).abs().max().item() if got.numel() \
        else 0.0
    scale = max(want.abs().max().item(), 1e-30) if want.numel() else 1.0
    ok = torch.equal(got, want) if exact else err <= rel_tol * scale
    print(f"  {name}: max abs err {err:.3e}, rel {err / scale:.3e} "
          f"({'exact required' if exact else f'tol rel {rel_tol:g}'}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: kernel disagrees with plain version")
    return err


def rand_operands(gen, k: int, rows: int, cols: int, dev):
    """Random codebook [k] and indices [rows, cols] on the card."""
    cb = torch.sort(torch.randn(k, generator=gen, device=dev))[0]
    idx = torch.randint(0, k, (rows, cols), generator=gen, device=dev)
    return cb, idx


def packed_words(idx: torch.Tensor, k: int, order: str) -> torch.Tensor:
    from repro_torch.core.compression import as_words, pack_indices_2d, \
        pack_rows
    host = idx.cpu().numpy()
    words = pack_rows(host, k) if order == "row" else pack_indices_2d(host, k)
    return as_words(words, idx.device)


# ---------------------------------------------------------------------------
# Per-kernel phase
# ---------------------------------------------------------------------------

def check_gather(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantized_gather import quantized_gather
    print("quantized_gather (exact):")
    for k in KS:
        for (v, d, ts) in ((37, 29, (11,)),
                           (sh.v, sh.d, (sh.batch, sh.batch * sh.block))):
            cb, idx = rand_operands(gen, k, v, d, dev)
            pidx = packed_words(idx, k, "row")
            for t in ts:
                tok = torch.randint(0, v, (t,), generator=gen, device=dev)
                got = quantized_gather(tok, pidx, cb, d)
                torch.cuda.synchronize()
                err = compare(f"K={k} V={v} D={d} T={t}", got,
                              ref.quantized_gather_ref(tok, pidx, cb, d),
                              exact=True)
    # timing at the decode shape (one token per request)
    v, d, t = sh.v, sh.d, sh.batch
    cb, idx = rand_operands(gen, K_MAIN, v, d, dev)
    pidx = packed_words(idx, K_MAIN, "row")
    dense = cb[idx]
    toks = [torch.randint(0, v, (t,), generator=gen, device=dev)
            for _ in range(64)]
    it = iter(range(10 ** 9))
    times = time_all(
        lambda: quantized_gather(toks[next(it) % 64], pidx, cb, d),
        lambda: ref.quantized_gather_ref(toks[next(it) % 64], pidx, cb, d),
        lambda: torch.nn.functional.embedding(toks[next(it) % 64], dense))
    wd = pidx.shape[1]
    b_ms, b_by = bound(t * wd * 4 + t * 4 + K_MAIN * 4 + t * d * 4, 0)
    return dict(name="quantized_gather", shape=f"T={t} V={v} D={d} K={K_MAIN}",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)


def check_matmul(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.codebook_matmul_packed import (
        codebook_matmul_packed, packed_plan, sm_count)
    print("codebook_matmul_packed:")
    shapes = [(3, 37, 70), (33, 100, 130), (17, 1000, 130)]
    # decode, the engine's one-slot prefill block, the one-shot prefill
    ms = (sh.batch, sh.block, sh.batch * sh.block)
    for m in ms:
        shapes += [(m, kd, n) for kd, n in sh.proj]
    sms = sm_count(dev.index or 0)
    errs = {}
    for k in KS:
        for (m, kd, n) in shapes:
            cb, idx = rand_operands(gen, k, kd, n, dev)
            pidx = packed_words(idx, k, "kd")
            x = torch.randn(m, kd, generator=gen, device=dev)
            got = codebook_matmul_packed(x, pidx, cb)
            again = codebook_matmul_packed(x, pidx, cb)
            torch.cuda.synchronize()
            label = (f"K={k} M={m} Kd={kd} N={n} "
                     f"{tuple(packed_plan(m, kd, n, k, sms))}")
            if not torch.equal(got, again):
                raise SmokeFailure(f"{label}: two calls differ")
            errs[(k, m, kd, n)] = compare(
                label, got, ref.packed_codebook_matmul_ref(x, pidx, cb))
    timings = {}
    kd, n = sh.proj[1]                       # w_in / w_gate
    for m in ms:
        cb, idx = rand_operands(gen, K_MAIN, kd, n, dev)
        pidx = packed_words(idx, K_MAIN, "kd")
        x = torch.randn(m, kd, generator=gen, device=dev)
        nc = copies_for(pidx.numel() * 4)
        pw = [pidx.view(torch.int32).clone().view(torch.uint32)
              for _ in range(nc)]
        wd = [cb[idx] for _ in range(copies_for(kd * n * 4))]
        it = iter(range(10 ** 9))
        timings[m] = matmul_timings(
            "", lambda: codebook_matmul_packed(x, pw[next(it) % nc], cb),
            lambda: ref.packed_codebook_matmul_ref(x, pw[next(it) % nc], cb),
            lambda: torch.matmul(x, wd[next(it) % len(wd)]), m=m, kd=kd,
            n=n, index_bytes=pidx.numel() * 4,
            err=errs[(K_MAIN, m, kd, n)],
            plan=tuple(packed_plan(m, kd, n, K_MAIN, sms)))
    return dict(name="codebook_matmul_packed", **timings[ms[0]],
                prefill=[timings[m] for m in ms[1:]])


def check_matmul_t(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.codebook_matmul_packed_t import \
        codebook_matmul_packed_t
    print("codebook_matmul_packed_t:")
    shapes = [(3, 37, 101), (9, 50, 77), (sh.batch, sh.d, sh.v)]
    err_main = None
    for k in KS:
        for order in ("row", "kd"):
            for (m, d, v) in shapes:
                cb, idx = rand_operands(gen, k, v, d, dev)
                if order == "row":
                    pidx = packed_words(idx, k, "row")
                else:
                    pidx = packed_words(idx, k, "kd")     # [⌈V/lanes⌉, D]
                x = torch.randn(m, d, generator=gen, device=dev)
                got = codebook_matmul_packed_t(x, pidx, cb, v, order=order)
                torch.cuda.synchronize()
                err = compare(f"K={k} order={order} M={m} D={d} V={v}", got,
                              ref.packed_codebook_matmul_t_ref(
                                  x, pidx, cb, v, order=order))
                if (k, order, m, v) == (K_MAIN, "row", sh.batch, sh.v):
                    err_main = err
    m, d, v = sh.batch, sh.d, sh.v
    cb, idx = rand_operands(gen, K_MAIN, v, d, dev)
    pidx = packed_words(idx, K_MAIN, "row")
    x = torch.randn(m, d, generator=gen, device=dev)
    dense = cb[idx]
    times = time_all(
        lambda: codebook_matmul_packed_t(x, pidx, cb, v, order="row"),
        lambda: ref.packed_codebook_matmul_t_ref(x, pidx, cb, v, order="row"),
        lambda: x @ dense.T, plain_iters=5)
    b_ms, b_by = bound(m * d * 4 + pidx.numel() * 4 + K_MAIN * 4 + m * v * 4,
                       2 * m * d * v)
    return dict(name="codebook_matmul_packed_t",
                shape=f"M={m} D={d} V={v} K={K_MAIN} row",
                max_abs_err=err_main, bound_ms=b_ms, bound_by=b_by, **times)


def check_prefill(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.blockwise_prefill import blockwise_prefill
    print("blockwise_prefill:")

    def case(b, c, h, kv, hd, s, start, window=None, softcap=None,
             tile=64, vd=None):
        q = torch.randn(b, c, h, hd, generator=gen, device=dev)
        k = torch.randn(b, s, kv, hd, generator=gen, device=dev)
        v = torch.randn(b, s, kv, vd or hd, generator=gen, device=dev)
        q_pos = torch.arange(start, start + c, device=dev, dtype=torch.int32)
        k_pos = torch.arange(s, device=dev, dtype=torch.int32)
        pad = (-s) % tile
        if pad:       # sentinel-position pad rows, as the dispatch route adds
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            k_pos = torch.cat([k_pos, torch.full((pad,), ref.POS_SENTINEL,
                                                 dtype=torch.int32,
                                                 device=dev)])
        return q, k, v, q_pos, k_pos, dict(window=window, softcap=softcap,
                                           scale=hd ** -0.5, token_tile=tile)

    cases = {
        "GQA rep 2, ragged view": (2, 5, 4, 2, 8, 13, 8),
        "window 4 + softcap 5": (2, 7, 6, 3, 12, 20, 13, 4, 5.0),
        "rep 8, tile 16": (1, 9, 8, 1, 32, 40, 31, None, None, 16),
        # the deepseek-v2-lite MLA prefill: 16 heads, keys of nope 128 +
        # rope 64, values of 128, one slot's 9-page view
        "MLA hd 192 / vd 128, block at 64": (1, 64, 16, 16, 192, 144, 64,
                                             None, None, 64, 128),
    }
    for start in range(0, sh.prompt_len, sh.block):
        last = f"serving block at {start}"
        cases[last] = (sh.batch, sh.block, sh.h, sh.kv, sh.hd,
                       start + sh.block, start)
    # the engine's prefill: one slot's block over the slot's whole page view
    # (npg pages, padded to a tile multiple); later tiles are never visible
    engine = {f"engine view {sh.npg * sh.page} rows, block at {start}":
              (1, sh.block, sh.h, sh.kv, sh.hd, sh.npg * sh.page, start)
              for start in (0, sh.block)}
    cases.update(engine)
    # launch plans (query rows a warp, K/V buffers) that only these reach
    plans = {**{label: (1, 2) for label in engine},
             "MLA hd 192 / vd 128, tile 128: one K/V buffer": (1, 1),
             "B=2 block of 64: 2 rows a warp": (2, 2)}
    cases["MLA hd 192 / vd 128, tile 128: one K/V buffer"] = (
        1, 64, 16, 16, 192, 144, 64, None, None, 128, 128)
    cases["B=2 block of 64: 2 rows a warp"] = (2, 64, 16, 16, 64, 64, 0)
    grid = build.function("blockwise_prefill",
                          "repro_blockwise_prefill_grid",
                          [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {}
    for label, args in cases.items():
        q, k, v, qp, kp, kw = case(*args)
        if label in plans:
            out = [ctypes.c_int() for _ in range(4)]
            build.check(grid(*q.shape[:3], k.shape[2], k.shape[1], q.shape[3],
                             v.shape[3], kw["token_tile"],
                             *(ctypes.byref(x) for x in out)),
                        "blockwise_prefill")
            blocks, warps, rw, stages = (x.value for x in out)
            print(f"  {label}: plan of {blocks} blocks of {warps} warps, "
                  f"{rw} query rows a warp, {stages} K/V buffers "
                  f"({n_sm} SMs)")
            if (rw, stages) != plans[label]:
                raise SmokeFailure(f"blockwise_prefill {label}: plan "
                                   f"{(rw, stages)} != {plans[label]}")
        got = blockwise_prefill(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        errs[label] = compare(label, got, ref.blockwise_prefill_ref(
            q, k, v, qp, kp, **kw))

    def timing(label: str) -> dict:
        q, k, v, qp, kp, kw = case(*cases[label])
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = kp[None, :] <= qp[:, None]
        times = time_all(
            lambda: blockwise_prefill(q, k, v, qp, kp, **kw),
            lambda: ref.blockwise_prefill_ref(q, k, v, qp, kp, **kw),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"]))
        b, c, h, hd = q.shape
        vd = v.shape[-1]
        visible = int(mask.sum().item())    # (query, key) pairs the data needs
        rows = int(mask.any(0).sum().item())   # view rows some query sees
        nbytes = 4 * (q.numel() + b * rows * k.shape[2] * (hd + vd)
                      + b * c * h * vd + qp.numel() + kp.numel())
        b_ms, b_by = bound(nbytes, 2 * b * h * visible * (hd + vd))
        return dict(shape=f"B={b} C={c} H={h} KV={k.shape[2]} hd={hd} "
                          f"S={k.shape[1]} tile={kw['token_tile']} "
                          f"start={int(qp[0])}",
                    max_abs_err=errs[label], bound_ms=b_ms, bound_by=b_by,
                    **times)

    # timing at the serving path's last prompt block, then at the engine's
    return dict(name="blockwise_prefill", **timing(last),
                prefill=[timing(label) for label in engine])


def paged_operands(gen, dev, b: int, rep: int, kv: int, hd: int, page: int,
                   npg: int):
    """q [B,1,H,hd] and pools [B·npg + 1, page, KV, hd] of random values
    (rows past each slot's pos included), with a page table over a random
    permutation of the usable pages."""
    n_phys = b * npg + 1
    q = 3 * torch.randn(b, 1, kv * rep, hd, generator=gen, device=dev)
    kp = torch.randn(n_phys, page, kv, hd, generator=gen, device=dev)
    vp = torch.randn(n_phys, page, kv, hd, generator=gen, device=dev)
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[:b * npg]
    return q, kp, vp, (perm + 1).reshape(b, npg).to(torch.int32)


def check_page_gather(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.page_gather import page_gather
    print("page_gather (exact):")
    feat = (sh.kv, sh.hd)

    def case(label, b, npg, page, feat, dtype, alive):
        n_phys = b * npg + 1
        pool = torch.randint(-999, 999, (n_phys, page) + tuple(feat),
                             generator=gen, device=dev).to(dtype)
        table = torch.randint(0, n_phys, (b, npg), generator=gen, device=dev,
                              dtype=torch.int32)
        alv = torch.tensor(alive, device=dev)
        got = page_gather(pool, table, alv)
        torch.cuda.synchronize()
        return compare(label, got, ref.gather_pages_ref(pool, table, alv),
                       exact=True)

    case("f32 page 8, feat 2x8, one dead slot", 5, 3, 8, (2, 8),
         torch.float32, [True, True, False, True, True])
    case("bf16 page 16, feat 3x5 (16-byte words)", 3, 4, 16, (3, 5),
         torch.bfloat16, [True, False, True])
    case("int32 page 5, feat 7 (4-byte words)", 3, 2, 5, (7,), torch.int32,
         [True, True, True])
    case("uint8 page 5, feat 3 (1-byte words)", 2, 3, 5, (3,), torch.uint8,
         [True, True])
    case("all dead", 3, 3, 8, (2, 8), torch.float32, [False] * 3)
    err = 0.0
    for b in (1, sh.batch):       # prefill (one slot) and a full slot batch
        err = case(f"serving B={b} npg={sh.npg} page={sh.page} feat={feat}",
                   b, sh.npg, sh.page, feat, torch.float32, [True] * b)
    # timing at the prefill shape: one slot's view through a full pool
    _, kp, _, table = paged_operands(gen, dev, sh.batch, 1, sh.kv, sh.hd,
                                     sh.page, sh.npg)
    table, alive = table[:1], torch.ones(1, dtype=torch.bool, device=dev)
    nc = copies_for(kp.numel() * 4)
    pools = [kp.clone() for _ in range(nc)]
    it = iter(range(10 ** 9))
    tl = table.long()
    times = time_all(
        lambda: page_gather(pools[next(it) % nc], table, alive),
        lambda: ref.gather_pages_ref(pools[next(it) % nc], table, alive),
        lambda: pools[next(it) % nc][tl])
    page_bytes = kp[0].numel() * 4
    n_read = int(torch.unique(table).numel())
    b_ms, b_by = bound(n_read * page_bytes + table.numel() * page_bytes
                       + table.numel() * 4 + alive.numel(), 0)
    return dict(name="page_gather",
                shape=f"B=1 npg={sh.npg} pool [{sh.n_phys},{sh.page},"
                      f"{sh.kv},{sh.hd}] f32",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)


# Logical pages a slot of the split checks and of the long-context timing of
# rows 6 and 8 (``kernels/paged_attention.py``: plan): one page, the serving
# shape's 9, a count no plan divides, and 4096 rows of pages of 16.
SPLIT_NPG = (1, 9, 17, 256)
LONG_POS = 4095


def split_positions(pages: int, page: int, npg: int):
    """pos and alive of 5 slots against a plan of ``pages`` pages a split:
    the last row of split 0, the first of split 1, the last row of the
    slot, a slot whose rows all lie in split 0, and a dead slot."""
    cap, edge = npg * page, pages * page
    return ([min(edge - 1, cap - 1), min(edge, cap - 1), cap - 1,
             min(3, cap - 1), 5], [True, True, True, True, False])


def check_paged_attention(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.codebook_matmul_packed import sm_count
    from repro_torch.kernels.paged_attention import paged_attention, plan
    print(f"paged_attention (alive slots within rel {REL_TOL:g}, dead slots "
          f"exactly 0):")

    def case(label, q, kp, vp, table, pos, alive, softcap=None,
             twice=False):
        hd = q.shape[-1]
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        alive = torch.tensor(alive, device=dev)
        kw = dict(softcap=softcap, scale=hd ** -0.5)
        got = paged_attention(q, kp, vp, table, pos, alive, **kw)
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(q, kp, vp, table, pos, alive, **kw)
        dead = got[~alive]
        if not torch.equal(dead, torch.zeros_like(dead)):
            raise SmokeFailure(f"paged_attention {label}: dead slots not 0")
        if twice and not torch.equal(
                paged_attention(q, kp, vp, table, pos, alive, **kw), got):
            raise SmokeFailure(f"paged_attention {label}: two calls differ")
        if not alive.any():
            print(f"  {label}: every slot dead, output exactly 0 ok")
            return 0.0
        return compare(label, got[alive], want[alive])

    for rep, hd, page, softcap in ((1, 8, 8, None), (2, 64, 16, 30.0),
                                   (4, 128, 8, None), (1, 128, 16, 30.0),
                                   (2, 8, 16, None), (4, 64, 8, 30.0)):
        npg = 3
        ops = paged_operands(gen, dev, 5, rep, 2, hd, page, npg)
        case(f"rep {rep} hd {hd} page {page} softcap {softcap}, pos 0 / "
             f"page-1 / page / cap-1, one dead slot", *ops,
             [0, page - 1, page, npg * page - 1, 5],
             [True, True, True, True, False], softcap)
    ops = paged_operands(gen, dev, 3, 2, 2, 64, 16, 2)
    case("all dead", *ops, [3, 20, 31], [False] * 3)
    ops = paged_operands(gen, dev, sh.batch, sh.h // sh.kv, sh.kv, sh.hd,
                         sh.page, sh.npg)
    case("serving shape, one dead slot", *ops,
         [sh.prompt_len, sh.prompt_len + 7, sh.npg * sh.page - 1, 0],
         [True, True, True, False])
    rep = sh.h // sh.kv
    for npg in SPLIT_NPG:
        pl = plan(5, sh.kv, rep, npg, sm_count(dev.index))
        pos_s, alive_s = split_positions(pl.pages, sh.page, npg)
        case(f"npg {npg}, plan {tuple(pl)}: pos {pos_s} (split 0's last "
             f"row / split 1's first / the last / inside split 0), one dead "
             f"slot, two calls bit-equal",
             *paged_operands(gen, dev, 5, rep, sh.kv, sh.hd, sh.page, npg),
             pos_s, alive_s, twice=True)
    pos_l = [sh.prompt_len + i * (sh.gen_len - 1) // 3
             for i in range(sh.batch)]
    err = case(f"serving shape, pos {pos_l}", *ops, pos_l,
               [True] * sh.batch)
    timing = paged_attention_timing(gen, dev, sh, ops, pos_l, err)
    npg = -(-(LONG_POS + 1) // sh.page)
    long_ops = paged_operands(gen, dev, sh.batch, rep, sh.kv, sh.hd, sh.page,
                              npg)
    pos_long = [LONG_POS] * sh.batch
    long_err = case(f"long context, npg {npg}, pos {pos_long}", *long_ops,
                    pos_long, [True] * sh.batch)
    return dict(timing, long=paged_attention_timing(gen, dev, sh, long_ops,
                                                    pos_long, long_err))


def paged_attention_timing(gen, dev, sh: Shapes, ops, pos_l, err) -> dict:
    """Row 6, its plain version and SDPA on the gathered view, timed at 4
    slots at ``pos_l``, pools cycled past L2; the plan beside the shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.codebook_matmul_packed import sm_count
    from repro_torch.kernels.paged_attention import paged_attention, plan
    q, kp, vp, table = ops
    npg = table.shape[1]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    alive = torch.ones(sh.batch, dtype=torch.bool, device=dev)
    nc = copies_for(2 * kp.numel() * 4)
    pools = [(kp.clone(), vp.clone()) for _ in range(nc)]
    scale = sh.hd ** -0.5
    views = []
    for k_c, v_c in pools:        # the library call reads the gathered view
        gk = ref.gather_pages_ref(k_c, table, alive).transpose(1, 2)
        gv = ref.gather_pages_ref(v_c, table, alive).transpose(1, 2)
        views.append((gk.contiguous(), gv.contiguous()))
    cap = npg * sh.page
    mask = (torch.arange(cap, device=dev)[None, :] <= pos[:, None])
    mask = mask[:, None, None, :]
    qt = q.transpose(1, 2).contiguous()
    it = iter(range(10 ** 9))

    def kernel():
        k_c, v_c = pools[next(it) % nc]
        return paged_attention(q, k_c, v_c, table, pos, alive, scale=scale)

    def plain():
        k_c, v_c = pools[next(it) % nc]
        return ref.paged_attention_ref(q, k_c, v_c, table, pos, alive,
                                       scale=scale)

    def library():
        gk, gv = views[next(it) % nc]
        return torch.nn.functional.scaled_dot_product_attention(
            qt, gk, gv, attn_mask=mask, scale=scale)

    times = time_all(kernel, plain, library)
    rows = sum(p + 1 for p in pos_l)              # visible rows per kv head
    nbytes = (rows * sh.kv * sh.hd * 4 * 2 + 2 * q.numel() * 4
              + table.numel() * 4 + 2 * sh.batch * 4)
    b_ms, b_by = bound(nbytes, rows * sh.h * sh.hd * 2 * 2)
    pl = plan(sh.batch, sh.kv, sh.h // sh.kv, npg, sm_count(dev.index))
    return dict(name="paged_attention",
                shape=f"q [{sh.batch},1,{sh.h},{sh.hd}] pools "
                      f"[{kp.shape[0]},{sh.page},{sh.kv},{sh.hd}] "
                      f"npg={npg} pos {pos_l} plan {tuple(pl)}",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                **times)


# ---------------------------------------------------------------------------
# Quantized-KV kernel phases (rows 5 and 7)
# ---------------------------------------------------------------------------

QUANT_BITS = (2, 4, 8)
QUANT_MODES = ("page", "head")


def quant_pools(gen, dev, n_pages: int, page: int, kv: int, hd: int,
                bits: int, mode: str, written: bool):
    """K/V word pools [n_pages + 1, page, KV, Wd] and codebooks
    [n_pages + 1, Gcb, 2**bits]: filled by the port's quantizing write path
    (every usable page written from random K/V rows, page 0 the trash
    page), or random words with sorted random codebooks."""
    from repro_torch.models import attention as attn
    cache = attn.init_quant_paged_kv_cache(n_pages, page, kv, hd, bits, mode,
                                           device=dev)
    if written:
        table = torch.arange(1, n_pages + 1, device=dev)[None]
        one = torch.ones(1, dtype=torch.bool, device=dev)
        for words, cbs in ((cache.k_words, cache.k_cb),
                           (cache.v_words, cache.v_cb)):
            rows = 2 * torch.randn(1, n_pages * page, kv, hd, generator=gen,
                                   device=dev)
            attn._write_block_slot_quant(words, cbs, table, 0, one, rows,
                                         page, bits, mode)
        return cache
    for words in (cache.k_words, cache.v_words):
        words.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, words.shape,
                                  generator=gen, device=dev,
                                  dtype=torch.int64).to(torch.int32))
    for cbs in (cache.k_cb, cache.v_cb):
        cbs.copy_(torch.sort(torch.randn(cbs.shape, generator=gen,
                                         device=dev), dim=-1)[0])
    return cache


def dequant_pools(cache, bits: int, hd: int):
    """The dense pools [P+1, page, KV, hd] a quantized cache stores."""
    from repro_torch.kernels import ref
    n_phys, page = cache.k_words.shape[:2]
    table = torch.arange(n_phys, device=cache.k_words.device)[None]
    one = torch.ones(1, dtype=torch.bool, device=table.device)
    return [ref.dequant_pages_ref(w, c, table, one, hd, bits).reshape(
                (n_phys, page) + tuple(w.shape[2:-1]) + (hd,))
            for w, c in ((cache.k_words, cache.k_cb),
                         (cache.v_words, cache.v_cb))]


def check_paged_attention_quant(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.paged_attention_quant import \
        paged_attention_quant
    print(f"paged_attention_quant (alive slots within rel {REL_TOL:g}, dead "
          f"slots exactly 0):")

    def case(label, q, cache, table, pos, alive, bits, softcap=None):
        hd = q.shape[-1]
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        alive = torch.tensor(alive, device=dev)
        kw = dict(bits=bits, head_dim=hd, softcap=softcap, scale=hd ** -0.5)
        got = paged_attention_quant(q, *cache, table, pos, alive, **kw)
        torch.cuda.synchronize()
        want = ref.paged_attention_quant_ref(q, *cache, table, pos, alive,
                                             **kw)
        dead = got[~alive]
        if not torch.equal(dead, torch.zeros_like(dead)):
            raise SmokeFailure(f"paged_attention_quant {label}: dead slots "
                               f"not 0")
        if not alive.any():
            print(f"  {label}: every slot dead, output exactly 0 ok")
            return 0.0
        return compare(label, got[alive], want[alive])

    shapes = ((1, 64, 16, None), (2, 128, 8, 30.0), (4, 12, 16, None),
              (1, 12, 8, 30.0), (2, 64, 16, None), (4, 128, 8, 30.0))
    b, kv, npg = 5, 2, 3
    i = 0
    for bits in QUANT_BITS:
        for mode in QUANT_MODES:
            for written in (True, False):
                rep, hd, page, softcap = shapes[i % len(shapes)]
                i += 1
                cache = quant_pools(gen, dev, b * npg, page, kv, hd, bits,
                                    mode, written)
                q, _, _, table = paged_operands(gen, dev, b, rep, kv, hd,
                                                page, npg)
                case(f"{bits}-bit {mode} {'written' if written else 'random'}"
                     f" rep {rep} hd {hd} page {page} softcap {softcap}, pos "
                     f"0 / page-1 / page / cap-1, one dead slot", q, cache,
                     table, [0, page - 1, page, npg * page - 1, 5],
                     [True, True, True, True, False], bits, softcap)
    cache = quant_pools(gen, dev, 3 * 2, 16, 2, 64, 4, "page", True)
    q, _, _, table = paged_operands(gen, dev, 3, 2, 2, 64, 16, 2)
    case("all dead", q, cache, table, [3, 20, 31], [False] * 3, 4)
    # the serving decode shape, pools written by the port's write path
    bits, mode = 4, "page"
    n_pages = sh.n_phys - 1
    q, _, _, table = paged_operands(gen, dev, sh.batch, sh.h // sh.kv, sh.kv,
                                    sh.hd, sh.page, sh.npg)
    pos_l = [sh.prompt_len + i * (sh.gen_len - 1) // 3
             for i in range(sh.batch)]
    err = None
    for bits_s in QUANT_BITS:
        for mode_s in QUANT_MODES:
            c = quant_pools(gen, dev, n_pages, sh.page, sh.kv, sh.hd, bits_s,
                            mode_s, True)
            e = case(f"serving shape {bits_s}-bit {mode_s}, pos {pos_l}", q,
                     c, table, pos_l, [True] * sh.batch, bits_s)
            if (bits_s, mode_s) == (bits, mode):
                err, cache = e, c
    case("serving shape, one dead slot", q, cache, table,
         [sh.prompt_len, sh.prompt_len + 7, sh.npg * sh.page - 1, 0],
         [True, True, True, False], bits)
    # timing at the serving decode shape (4-bit, page mode), word pools
    # cycled past L2; beside it the dense kernel on the dequantized pools
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    alive = torch.ones(sh.batch, dtype=torch.bool, device=dev)
    nc = copies_for(2 * cache.k_words.numel() * 4)
    pools = [tuple(t.clone() for t in cache) for _ in range(nc)]
    dense = dequant_pools(cache, bits, sh.hd)
    nd = copies_for(2 * dense[0].numel() * 4)
    dense_pools = [(dense[0].clone(), dense[1].clone()) for _ in range(nd)]
    scale = sh.hd ** -0.5
    kw = dict(bits=bits, head_dim=sh.hd, scale=scale)
    it = iter(range(10 ** 9))
    times = time_all(
        lambda: paged_attention_quant(q, *pools[next(it) % nc], table, pos,
                                      alive, **kw),
        lambda: ref.paged_attention_quant_ref(q, *pools[next(it) % nc],
                                              table, pos, alive, **kw),
        None,
        dense=lambda: paged_attention(q, *dense_pools[next(it) % nd], table,
                                      pos, alive, scale=scale))
    rows = sum(p + 1 for p in pos_l)              # visible rows per kv head
    wd = cache.k_words.shape[-1]
    pages = sum(p // sh.page + 1 for p in pos_l)  # codebooks read
    gcb, k_ent = cache.k_cb.shape[1:]
    nbytes = (2 * rows * sh.kv * wd * 4 + 2 * pages * gcb * k_ent * 4
              + 2 * q.numel() * 4 + table.numel() * 4 + 2 * sh.batch * 4)
    b_ms, b_by = bound(nbytes, rows * sh.h * sh.hd * 2 * 2)
    return dict(name="paged_attention_quant",
                shape=f"q [{sh.batch},1,{sh.h},{sh.hd}] words "
                      f"[{sh.n_phys},{sh.page},{sh.kv},{wd}] cb "
                      f"[{sh.n_phys},{gcb},{k_ent}] npg={sh.npg} pos {pos_l} "
                      f"({bits}-bit {mode})",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, **times)


def check_prefill_quant(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.blockwise_prefill import blockwise_prefill
    from repro_torch.kernels.blockwise_prefill_quant import \
        blockwise_prefill_quant
    print(f"blockwise_prefill_quant (within rel {REL_TOL:g}):")

    def views(cache, table):
        """Word views [B, S, KV, Wd] and codebook views [B, npg, Gcb, K]
        of the slots' pages, as the engine's prefill gathers them."""
        from repro_torch.kernels.page_gather import page_gather
        alive = torch.ones(table.shape[0], dtype=torch.bool, device=dev)
        return ([page_gather(w, table, alive)
                 for w in (cache.k_words, cache.v_words)],
                [c[table.long()] for c in (cache.k_cb, cache.v_cb)])

    def case(label, q, wv, cv, start, page, bits, window=None, softcap=None):
        hd = q.shape[-1]
        c, s = q.shape[1], wv[0].shape[1]
        q_pos = torch.arange(start, start + c, device=dev, dtype=torch.int32)
        k_pos = torch.arange(s, device=dev, dtype=torch.int32)
        kw = dict(page_size=page, bits=bits, head_dim=hd, window=window,
                  softcap=softcap, scale=hd ** -0.5,
                  token_tile=dispatch.prefill_token_tile("quant", hd,
                                                         page_size=page))
        got = blockwise_prefill_quant(q, *wv, *cv, q_pos, k_pos, **kw)
        torch.cuda.synchronize()
        return compare(label, got, ref.blockwise_prefill_quant_ref(
            q, *wv, *cv, q_pos, k_pos, **kw))

    shapes = ((1, 64, None, None), (2, 12, 5, 30.0), (4, 128, None, 30.0),
              (2, 64, None, 30.0), (1, 12, 7, None), (4, 64, None, None))
    b, kv, npg, page, c, start = 2, 2, 4, 8, 13, 9
    i = 0
    for bits in QUANT_BITS:
        for mode in QUANT_MODES:
            for written in (True, False):
                rep, hd, window, softcap = shapes[i % len(shapes)]
                i += 1
                cache = quant_pools(gen, dev, b * npg, page, kv, hd, bits,
                                    mode, written)
                table = torch.arange(1, b * npg + 1, device=dev,
                                     dtype=torch.int32).reshape(b, npg)
                wv, cv = views(cache, table)
                q = torch.randn(b, c, kv * rep, hd, generator=gen, device=dev)
                case(f"{bits}-bit {mode} {'written' if written else 'random'}"
                     f" rep {rep} hd {hd} window {window} softcap {softcap}",
                     q, wv, cv, start, page, bits, window, softcap)
    # the serving blocks: one slot's pages (npg of page tokens), queries of
    # each prompt block, pools written by the port's write path
    table = torch.arange(1, sh.npg + 1, device=dev,
                         dtype=torch.int32)[None]
    q = torch.randn(1, sh.block, sh.h, sh.hd, generator=gen, device=dev)
    err = None
    for bits in QUANT_BITS:
        for mode in QUANT_MODES:
            cache = quant_pools(gen, dev, sh.npg, sh.page, sh.kv, sh.hd,
                                bits, mode, True)
            wv, cv = views(cache, table)
            for start in range(0, sh.prompt_len, sh.block):
                e = case(f"serving block at {start}, {bits}-bit {mode}", q,
                         wv, cv, start, sh.page, bits)
                if (bits, mode) == (4, "page"):
                    err, keep = e, (cache, wv, cv)
    # timing at the serving path's last prompt block (4-bit, page mode);
    # beside it the dense kernel on the dequantized view, same tile
    bits, mode = 4, "page"
    cache, wv, cv = keep
    start = sh.prompt_len - sh.block
    s = wv[0].shape[1]
    q_pos = torch.arange(start, start + sh.block, device=dev,
                         dtype=torch.int32)
    k_pos = torch.arange(s, device=dev, dtype=torch.int32)
    tile = dispatch.prefill_token_tile("quant", sh.hd, page_size=sh.page)
    kw = dict(page_size=sh.page, bits=bits, head_dim=sh.hd,
              scale=sh.hd ** -0.5, token_tile=tile)
    dk, dv = (ref.dequant_view_ref(w, cb, sh.hd, bits, sh.page)
              for w, cb in zip(wv, cv))
    times = time_all(
        lambda: blockwise_prefill_quant(q, *wv, *cv, q_pos, k_pos, **kw),
        lambda: ref.blockwise_prefill_quant_ref(q, *wv, *cv, q_pos, k_pos,
                                                **kw),
        None,
        dense=lambda: blockwise_prefill(q, dk, dv, q_pos, k_pos,
                                        scale=kw["scale"], token_tile=tile))
    visible = int((k_pos[None, :] <= q_pos[:, None]).sum().item())
    wd = wv[0].shape[-1]
    gcb, k_ent = cv[0].shape[2:]
    nbytes = 4 * (2 * q.numel() + 2 * s * sh.kv * wd
                  + 2 * cv[0].shape[1] * gcb * k_ent + q_pos.numel()
                  + k_pos.numel())
    b_ms, b_by = bound(nbytes, 2 * sh.h * visible * (sh.hd + sh.hd))
    return dict(name="blockwise_prefill_quant",
                shape=f"B=1 C={sh.block} H=KV={sh.h} hd={sh.hd} words "
                      f"[1,{s},{sh.kv},{wd}] cb [1,{cv[0].shape[1]},{gcb},"
                      f"{k_ent}] start {start} tile={tile} ({bits}-bit "
                      f"{mode})",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, **times)


# ---------------------------------------------------------------------------
# Kernel rows 11 (uint8 codebook matmul), 8 and 9 (MLA paged decode)
# ---------------------------------------------------------------------------

def check_codebook_matmul(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.codebook_matmul import (codebook_matmul,
                                                     uint8_plan)
    from repro_torch.kernels.codebook_matmul_packed import sm_count
    print("codebook_matmul (uint8 indices):")
    # one-byte index loads (N % 4 != 0), then the four-byte ones
    shapes = [(3, 37, 70), (33, 100, 130), (17, 1000, 130)]
    ms = (sh.batch, sh.block, sh.batch * sh.block)
    kd, n = sh.proj[1]                              # w_in / w_gate
    shapes += [(m, kd, n) for m in ms]
    sms = sm_count(dev.index or 0)
    errs = {}
    for k in KS:
        for (m, kd_, n_) in shapes:
            cb, idx = rand_operands(gen, k, kd_, n_, dev)
            idx = idx.to(torch.uint8)
            x = torch.randn(m, kd_, generator=gen, device=dev)
            got = codebook_matmul(x, idx, cb)
            again = codebook_matmul(x, idx, cb)
            torch.cuda.synchronize()
            label = (f"K={k} M={m} Kd={kd_} N={n_} "
                     f"{tuple(uint8_plan(m, kd_, n_, sms))}")
            if not torch.equal(got, again):
                raise SmokeFailure(f"{label}: two calls differ")
            errs[(k, m, kd_, n_)] = compare(
                label, got, ref.codebook_matmul_ref(x, idx, cb))
    timings = {}
    for m in ms:
        cb, idx = rand_operands(gen, K_MAIN, kd, n, dev)
        idx = idx.to(torch.uint8)
        x = torch.randn(m, kd, generator=gen, device=dev)
        nc = copies_for(idx.numel())
        ix = [idx.clone() for _ in range(nc)]
        wd = [cb[idx.long()] for _ in range(copies_for(kd * n * 4))]
        it = iter(range(10 ** 9))
        timings[m] = matmul_timings(
            " uint8", lambda: codebook_matmul(x, ix[next(it) % nc], cb),
            lambda: ref.codebook_matmul_ref(x, ix[next(it) % nc], cb),
            lambda: torch.matmul(x, wd[next(it) % len(wd)]), m=m, kd=kd,
            n=n, index_bytes=idx.numel(), err=errs[(K_MAIN, m, kd, n)],
            plan=tuple(uint8_plan(m, kd, n, sms)))
    return dict(name="codebook_matmul", **timings[ms[0]],
                prefill=[timings[m] for m in ms[1:]])


# The small odd MLA shape of rows 8 and 9: 3 heads, latent 40, rope 6,
# pages of 5, 3 logical pages per slot.
MLA_ODD = dict(h=3, lat=40, rd=6, page=5, npg=3)


def mla_shape(sh: Shapes) -> dict:
    """The MLA decode geometry of a config's serving shapes."""
    return dict(h=sh.h, lat=sh.cfg.mla.kv_lora, rd=sh.cfg.mla.rope_dim,
                page=sh.page, npg=sh.npg)


def mla_operands(gen, dev, b, h, lat, rd, page, npg):
    """q_eff [B,1,H,L], q_rope [B,1,H,R], latent pools [B·npg + 1, page, L
    / R] of random values (rows past each slot's pos included) and a page
    table over a random permutation of the usable pages."""
    n_phys = b * npg + 1
    q_eff = torch.randn(b, 1, h, lat, generator=gen, device=dev)
    q_rope = torch.randn(b, 1, h, rd, generator=gen, device=dev)
    c_pool = torch.randn(n_phys, page, lat, generator=gen, device=dev)
    r_pool = torch.randn(n_phys, page, rd, generator=gen, device=dev)
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[:b * npg]
    table = (perm + 1).reshape(b, npg).to(torch.int32)
    return q_eff, q_rope, c_pool, r_pool, table


def _mla_scale(sh: Shapes) -> float:
    m = sh.cfg.mla
    return (m.nope_dim + m.rope_dim) ** -0.5


def _check_alive(label, got, want, alive) -> float:
    """Dead slots exactly 0 (the Pallas rule); alive slots within REL_TOL
    of the plain version (which follows the jnp spec on dead slots)."""
    dead = got[~alive]
    if not torch.equal(dead, torch.zeros_like(dead)):
        raise SmokeFailure(f"{label}: dead slots not 0")
    if not alive.any():
        print(f"  {label}: every slot dead, output exactly 0 ok")
        return 0.0
    return compare(label, got[alive], want[alive])


def _mla_cases(sh: Shapes):
    """(label, geometry, pos, alive) of the row 8 / 9 checks: pos 0 / page-1
    / page / cap-1 with one dead slot at the odd and the serving shape, the
    serving decode positions, and an all-dead batch."""
    out = []
    for name, g in (("odd", MLA_ODD), ("serving", mla_shape(sh))):
        cap = g["npg"] * g["page"]
        out.append((f"{name} shape, pos 0 / page-1 / page / cap-1, one dead "
                    f"slot", g, [0, g["page"] - 1, g["page"], cap - 1, 5],
                    [True, True, True, True, False]))
    pos_l = [sh.prompt_len + i * (sh.gen_len - 1) // 3
             for i in range(sh.batch)]
    out.append((f"serving shape, pos {pos_l}", mla_shape(sh), pos_l,
                [True] * sh.batch))
    out.append(("all dead", MLA_ODD, [3, 7, 14], [False] * 3))
    return out, pos_l


def check_mla_paged_attention(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.codebook_matmul_packed import sm_count
    from repro_torch.kernels.mla_paged_attention import (mla_paged_attention,
                                                         plan)
    print(f"mla_paged_attention (alive slots within rel {REL_TOL:g}, dead "
          f"slots exactly 0):")
    scale = _mla_scale(sh)

    def case(label, ops, pos, alive, twice=False):
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        alive = torch.tensor(alive, device=dev)
        got = mla_paged_attention(*ops, pos, alive, scale=scale)
        torch.cuda.synchronize()
        if twice and not torch.equal(
                mla_paged_attention(*ops, pos, alive, scale=scale), got):
            raise SmokeFailure(f"mla_paged_attention {label}: two calls "
                               f"differ")
        return _check_alive(label, got, ref.mla_paged_attention_ref(
            *ops, pos, alive, scale=scale), alive), pos, alive

    cases, pos_l = _mla_cases(sh)
    err = None
    for label, g, pos, alive in cases:
        ops = mla_operands(gen, dev, len(pos), **g)
        e, pos, alive = case(label, ops, pos, alive)
        if label.startswith("serving shape, pos"):
            err, keep = e, (ops, pos, alive)
    g = mla_shape(sh)
    for npg in SPLIT_NPG:
        pl = plan(5, g["h"], npg, sm_count(dev.index))
        pos_s, alive_s = split_positions(pl.pages, g["page"], npg)
        case(f"npg {npg}, plan {tuple(pl)}: pos {pos_s} (split 0's last "
             f"row / split 1's first / the last / inside split 0), one dead "
             f"slot, two calls bit-equal",
             mla_operands(gen, dev, 5, **dict(g, npg=npg)), pos_s, alive_s,
             twice=True)
    timing = mla_timing(sh, *keep, pos_l, err)
    npg = -(-(LONG_POS + 1) // g["page"])
    long_ops = mla_operands(gen, dev, sh.batch, **dict(g, npg=npg))
    pos_long = [LONG_POS] * sh.batch
    long_err, pos, alive = case(f"long context, npg {npg}, pos {pos_long}",
                                long_ops, pos_long, [True] * sh.batch)
    return dict(timing, long=mla_timing(sh, long_ops, pos, alive, pos_long,
                                        long_err))


def mla_timing(sh: Shapes, ops, pos, alive, pos_l, err) -> dict:
    """Row 8, its plain version and SDPA on the gathered view, timed at
    ``pos_l``, pools cycled past L2; the plan beside the shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.codebook_matmul_packed import sm_count
    from repro_torch.kernels.mla_paged_attention import (mla_paged_attention,
                                                         plan)
    scale = _mla_scale(sh)
    q_eff, q_rope, c_pool, r_pool, table = ops
    dev = q_eff.device
    nc = copies_for((c_pool.numel() + r_pool.numel()) * 4)
    pools = [(c_pool.clone(), r_pool.clone()) for _ in range(nc)]
    b, _, h, lat = q_eff.shape
    # the library call: SDPA over the gathered view, q = [q_eff | q_rope],
    # k = [c | r] shared by every head, v = c
    qt = torch.cat([q_eff, q_rope], -1).transpose(1, 2).contiguous()
    views = []
    for c_c, r_c in pools:
        gc = ref.gather_pages_ref(c_c, table, alive)
        gr = ref.gather_pages_ref(r_c, table, alive)
        views.append((torch.cat([gc, gr], -1)[:, None].contiguous(),
                      gc[:, None].contiguous()))
    cap = table.shape[1] * c_pool.shape[1]
    mask = (torch.arange(cap, device=dev)[None, :] <= pos[:, None])
    mask = mask[:, None, None, :]
    it = iter(range(10 ** 9))
    times = time_all(
        lambda: mla_paged_attention(q_eff, q_rope, *pools[next(it) % nc],
                                    table, pos, alive, scale=scale),
        lambda: ref.mla_paged_attention_ref(q_eff, q_rope,
                                            *pools[next(it) % nc], table,
                                            pos, alive, scale=scale),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, *views[next(it) % nc], attn_mask=mask, scale=scale,
            enable_gqa=True))
    rd = q_rope.shape[-1]
    rows = sum(p + 1 for p in pos_l)              # visible latent rows
    nbytes = (rows * (lat + rd) * 4 + (q_eff.numel() + q_rope.numel()) * 4
              + b * h * lat * 4 + table.numel() * 4 + 2 * b * 4)
    b_ms, b_by = bound(nbytes, 2 * h * rows * (2 * lat + rd))
    pl = plan(b, h, table.shape[1], sm_count(dev.index))
    return dict(name="mla_paged_attention",
                shape=f"q_eff [{b},1,{h},{lat}] q_rope [{b},1,{h},{rd}] "
                      f"pools [{c_pool.shape[0]},{c_pool.shape[1]},{lat}/"
                      f"{rd}] npg={table.shape[1]} pos {pos_l} plan "
                      f"{tuple(pl)}",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, **times)


def mla_quant_pools(gen, dev, n_pages: int, page: int, lat: int, rd: int,
                    bits: int, written: bool):
    """Latent word pools [n_pages + 1, page, Wc / Wr] and per-page
    codebooks [n_pages + 1, 1, 2**bits]: written by the port's quantizing
    write path from random latent rows, or random words with sorted random
    codebooks."""
    from repro_torch.models import attention as attn
    cache = attn.init_quant_paged_mla_cache(n_pages, page, lat, rd, bits,
                                            device=dev)
    if written:
        table = torch.arange(1, n_pages + 1, device=dev)[None]
        one = torch.ones(1, dtype=torch.bool, device=dev)
        for words, cbs, d in ((cache.c_words, cache.c_cb, lat),
                              (cache.r_words, cache.r_cb, rd)):
            rows = 2 * torch.randn(1, n_pages * page, 1, d, generator=gen,
                                   device=dev)
            attn._write_block_slot_quant(words.unsqueeze(-2), cbs, table, 0,
                                         one, rows, page, bits, "page")
        return cache
    for words in (cache.c_words, cache.r_words):
        words.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, words.shape,
                                  generator=gen, device=dev,
                                  dtype=torch.int64).to(torch.int32))
    for cbs in (cache.c_cb, cache.r_cb):
        cbs.copy_(torch.sort(torch.randn(cbs.shape, generator=gen,
                                         device=dev), dim=-1)[0])
    return cache


def check_mla_paged_attention_quant(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.mla_paged_attention import mla_paged_attention
    from repro_torch.kernels.mla_paged_attention_quant import \
        mla_paged_attention_quant
    print(f"mla_paged_attention_quant (alive slots within rel {REL_TOL:g}, "
          f"dead slots exactly 0):")
    scale = _mla_scale(sh)
    cases, pos_l = _mla_cases(sh)
    err = None
    for bits in QUANT_BITS:
        for written in (True, False):
            for label, g, pos, alive in cases:
                b = len(pos)
                q_eff, q_rope, _, _, table = mla_operands(gen, dev, b, **g)
                cache = mla_quant_pools(gen, dev, b * g["npg"], g["page"],
                                        g["lat"], g["rd"], bits, written)
                kw = dict(bits=bits, kv_lora=g["lat"], rope_dim=g["rd"],
                          scale=scale)
                pos = torch.tensor(pos, dtype=torch.int32, device=dev)
                alive = torch.tensor(alive, device=dev)
                got = mla_paged_attention_quant(q_eff, q_rope, *cache, table,
                                                pos, alive, **kw)
                torch.cuda.synchronize()
                e = _check_alive(
                    f"{bits}-bit {'written' if written else 'random'} "
                    f"{label}", got, ref.mla_paged_attention_quant_ref(
                        q_eff, q_rope, *cache, table, pos, alive, **kw),
                    alive)
                if label.startswith("serving shape, pos") and bits == 4 \
                        and written:
                    err, keep = e, (q_eff, q_rope, cache, table, pos, alive)
    # timing at the serving decode shape (4-bit, pools written by the write
    # path), word pools cycled past L2; beside it row 8 on the dequantized
    # pools at the same shape
    q_eff, q_rope, cache, table, pos, alive = keep
    bits = 4
    g = mla_shape(sh)
    kw = dict(bits=bits, kv_lora=g["lat"], rope_dim=g["rd"], scale=scale)
    nc = copies_for((cache.c_words.numel() + cache.r_words.numel()) * 4)
    pools = [tuple(t.clone() for t in cache) for _ in range(nc)]
    n_phys = cache.c_words.shape[0]
    every = torch.arange(n_phys, device=dev)[None]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    dense = [ref.dequant_pages_ref(w, c, every, one, d, bits).reshape(
        n_phys, g["page"], d) for w, c, d in
        ((cache.c_words, cache.c_cb, g["lat"]),
         (cache.r_words, cache.r_cb, g["rd"]))]
    nd = copies_for((dense[0].numel() + dense[1].numel()) * 4)
    dense_pools = [(dense[0].clone(), dense[1].clone()) for _ in range(nd)]
    it = iter(range(10 ** 9))
    times = time_all(
        lambda: mla_paged_attention_quant(q_eff, q_rope,
                                          *pools[next(it) % nc], table, pos,
                                          alive, **kw),
        lambda: ref.mla_paged_attention_quant_ref(
            q_eff, q_rope, *pools[next(it) % nc], table, pos, alive, **kw),
        None,
        dense=lambda: mla_paged_attention(q_eff, q_rope,
                                          *dense_pools[next(it) % nd], table,
                                          pos, alive, scale=scale))
    b, _, h, lat = q_eff.shape
    rd = g["rd"]
    rows = sum(p + 1 for p in pos_l)
    wc, wr = cache.c_words.shape[-1], cache.r_words.shape[-1]
    pages = sum(p // g["page"] + 1 for p in pos_l)     # codebooks read
    k_ent = cache.c_cb.shape[-1]
    nbytes = (rows * (wc + wr) * 4 + 2 * pages * k_ent * 4
              + (q_eff.numel() + q_rope.numel()) * 4 + b * h * lat * 4
              + table.numel() * 4 + 2 * b * 4)
    b_ms, b_by = bound(nbytes, 2 * h * rows * (2 * lat + rd))
    return dict(name="mla_paged_attention_quant",
                shape=f"q_eff [{b},1,{h},{lat}] words [{n_phys},"
                      f"{g['page']},{wc}/{wr}] cb [{n_phys},1,{k_ent}] "
                      f"npg={table.shape[1]} pos {pos_l} ({bits}-bit)",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, **times)


# ---------------------------------------------------------------------------
# C-step kernels (rows 12 and 13) and the C-step path
# ---------------------------------------------------------------------------

# Point counts of the C-step kernel phases: the shapes of
# benchmarks/bench_cstep.py (2^20, 2^23), a stacked leaf of 24 layer groups,
# and a P that is a multiple of no block size.
CSTEP_P = (1 << 20, 1 << 23)
CSTEP_GROUPS = 24
CSTEP_ODD_P = 1_000_003


def check_kmeans_assign(gen, dev, sh: Shapes) -> dict:
    """Row 12 against its plain version: assignments and counts exact, sums
    within 1e-5 of the largest |sum|, the same on a second run."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import kmeans_assign
    print("kmeans_assign (assignments and counts exact, sums within rel "
          "1e-5):")
    small, big = CSTEP_P
    cases = [(f"P={p} K={K_MAIN}", (), p, K_MAIN, True) for p in CSTEP_P]
    cases += [(f"[{CSTEP_GROUPS}, {small}] K={K_MAIN} batched",
               (CSTEP_GROUPS,), small, K_MAIN, True)]
    cases += [(f"P={CSTEP_ODD_P} K={k} unsorted", (), CSTEP_ODD_P, k, False)
              for k in (2, 4, 256)]
    errs = {}
    for label, lead, p, k, ordered in cases:
        w = torch.randn(lead + (p,), generator=gen, device=dev)
        cb = torch.randn(lead + (k,), generator=gen, device=dev)
        if ordered:
            cb = torch.sort(cb, dim=-1).values
        got = kmeans_assign(w, cb)
        again = kmeans_assign(w, cb)
        want = ref.kmeans_assign_ref(w, cb)
        torch.cuda.synchronize()
        compare(f"{label}: assign", got[0], want[0], exact=True)
        compare(f"{label}: counts", got[2], want[2], exact=True)
        errs[label] = compare(f"{label}: sums", got[1], want[1],
                              rel_tol=1e-5)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise SmokeFailure(f"kmeans_assign {label}: two runs differ")
    p, k = big, K_MAIN
    nc = copies_for(p * 4)
    ws = [torch.randn(p, generator=gen, device=dev) for _ in range(nc)]
    cb = torch.sort(torch.randn(k, generator=gen, device=dev)).values
    it = iter(range(10 ** 9))
    times = time_all(lambda: kmeans_assign(ws[next(it) % nc], cb),
                     lambda: ref.kmeans_assign_ref(ws[next(it) % nc], cb),
                     None, plain_iters=10)
    # w read, assign written, the codebook read, sums and counts written
    b_ms, b_by = bound(p * 8 + 3 * k * 4, 3 * p * k)
    out = dict(name="kmeans_assign", shape=f"P={p} K={k} f32",
               max_abs_err=errs[f"P={p} K={k}"], bound_ms=b_ms,
               bound_by=b_by, **times)
    print(f"  timing {out}")
    return out


def ulps_from_pow2_threshold(t: torch.Tensor) -> torch.Tensor:
    """Distance of |t| from the nearest pow2 threshold 1.5·2^-n, in ulps
    (f32) of that threshold."""
    a = t.double().abs()
    n = torch.round(torch.log2(1.5 / a))
    th = 1.5 * torch.exp2(-n)
    ulp = torch.exp2(torch.floor(torch.log2(th)) - 23)
    return (a - th).abs() / ulp


def hold_fixed_quant(label: str, got: torch.Tensor, want: torch.Tensor,
                     w: torch.Tensor, mode: str, scale: float = 1.0) -> int:
    """Row 13's hold: bit for bit, except pow2 elements that flip where two
    ``log2`` libraries may round to either side of an exponent threshold;
    each flip is reported with its distance, and one farther than 2 ulps
    from a threshold fails.  Returns the number of flips."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SmokeFailure(f"{label}: {got.dtype}{tuple(got.shape)} != "
                           f"{want.dtype}{tuple(want.shape)}")
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    diff = got.view(bits) != want.view(bits)
    n = int(diff.sum())
    if n and mode != "pow2":
        raise SmokeFailure(f"{label}: {n} elements differ from the plain "
                           f"version")
    if n:
        t = (w.float() / scale)[diff]
        dist = ulps_from_pow2_threshold(t)
        print(f"  {label}: {n} pow2 flips at |t| = "
              f"{t.abs()[:8].tolist()}, {dist.max().item():.2f} ulps from "
              f"a threshold at most")
        if dist.max().item() > 2:
            raise SmokeFailure(f"{label}: a pow2 flip more than 2 ulps from "
                               f"a threshold")
    return n


def check_fixed_quant(gen, dev, sh: Shapes) -> dict:
    """Row 13 against its plain version, every mode, C in {4, 7}, f32 and
    bf16, at 2^20, 2^23 and [8, 1000], and at Theorem A.1's special
    inputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fixed_quant import MODES, fixed_quant
    print("fixed_quant (bit for bit; pow2 flips only at a threshold):")
    n = torch.arange(0, 12, device=dev, dtype=torch.float32)
    pw = torch.exp2(-n)
    special = torch.cat([pw, 1.5 * pw, torch.nextafter(1.5 * pw, pw * 2),
                         torch.nextafter(1.5 * pw, pw),
                         torch.tensor([0.0, 1e-40, 3.0, 0.5], device=dev)])
    special = torch.cat([special, -special])
    flips = 0
    for shape in ((CSTEP_P[0],), (CSTEP_P[1],), (8, 1000),
                  tuple(special.shape)):
        base = special if shape == tuple(special.shape) else \
            torch.randn(shape, generator=gen, device=dev) * 0.2
        for dtype in (torch.float32, torch.bfloat16):
            w = base.to(dtype)
            for mode in MODES:
                for c in ((4, 7) if mode == "pow2" else (4,)):
                    got = fixed_quant(w, mode, pow2_c=c)
                    want = ref.fixed_quant_ref(w, mode, c)
                    flips += hold_fixed_quant(
                        f"{mode} C={c} {str(dtype)[6:]} {list(shape)}", got,
                        want, w, mode)
    torch.cuda.synchronize()
    print(f"  all cases held; {flips} pow2 flips in all")
    p = CSTEP_P[1]
    nc = copies_for(p * 8)
    ws = [torch.randn(p, generator=gen, device=dev) * 0.2 for _ in range(nc)]
    it = iter(range(10 ** 9))
    times = time_all(lambda: fixed_quant(ws[next(it) % nc], "pow2"),
                     lambda: ref.fixed_quant_ref(ws[next(it) % nc], "pow2"),
                     None)
    b_ms, b_by = bound(p * 8, 10 * p)
    out = dict(name="fixed_quant", shape=f"P={p} f32 pow2 C=4",
               max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, pow2_flips=flips,
               **times)
    print(f"  timing {out}")
    return out


CSTEP_KERNELS = ("kmeans_assign", "fixed_quant")
# layer 0's q projection and its MLP's first projection: the groups whose
# card fit is held against the port's CPU route
CSTEP_HELD = ("['stacks'][0]['pos0']['mixer']['wq']",
              "['stacks'][0]['pos0']['mlp']['w_in']")


def _leaves(tree) -> dict:
    from repro_torch.core.lc import tree_items
    return dict(tree_items(tree))


def hold_cstep_group(path: str, params, theta0, state, pm, scheme) -> None:
    """Layer 0's group of ``path``: the port's CPU route run from the card's
    k-means++ seeds.  The card's codebook must lie within 1e-5 of max |c|
    of the CPU's, its packed words must equal the CPU's midpoint
    assignment of the group's weights against the card's codebook, and
    its distortion must be at most the CPU's · (1 + 1e-5)."""
    from repro_torch.core.compression import pack_indices
    from repro_torch.core.quant_ops import fixed_codebook_assign
    w = _leaves(params)[path][0].cpu()
    seeds = theta0[path]["codebook"][0].cpu()
    q_cpu, th_cpu = scheme.c_step(w, {"codebook": seeds,
                                      "kmeans_iters": torch.tensor(0)},
                                  first=True)
    cb_card = state.theta[path]["codebook"][0].cpu()
    iters_card = int(state.theta[path]["kmeans_iters"][0])
    label = f"C step {path}[0]"
    compare(f"{label}: card codebook vs CPU route from the same seeds",
            cb_card, th_cpu["codebook"], rel_tol=1e-5)
    words = pack_indices(fixed_codebook_assign(w.reshape(-1), cb_card)
                         .numpy(), scheme.index_entries)[0]
    if not np.array_equal(pm.packed[path].words[0], words):
        raise SmokeFailure(f"{label}: packed words differ from the CPU's "
                           f"assignment against the card's codebook")
    q_card = _leaves(state.w_c)[path][0].cpu()
    d_card = ((w.double() - q_card.double()) ** 2).sum().item()
    d_cpu = ((w.double() - q_cpu.double()) ** 2).sum().item()
    print(f"  {label}: iters card {iters_card} / CPU "
          f"{int(th_cpu['kmeans_iters'])}, words equal, distortion card "
          f"{d_card:.6e} vs CPU {d_cpu:.6e}")
    if d_card > d_cpu * (1 + 1e-5):
        raise SmokeFailure(f"{label}: the card's distortion exceeds the "
                           f"CPU's")


def hold_kmeans_assign_leaves(params, thetas: dict) -> None:
    """Row 12 against its plain version at every shape the C step gives
    it: one call per quantized leaf (its layer groups in one batched
    launch; qwen's tied embedding is one group of 155.6 M points, with
    centroids past 2^24 points) on each codebook of ``thetas`` (label →
    {path: scheme state}).  Assignments and counts exact, sums within
    1e-5 of the largest |sum|."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import kmeans_assign
    leaves = _leaves(params)
    most = 0
    for which, theta in thetas.items():
        for path, th in theta.items():
            cb = th["codebook"]
            cb = cb.reshape(-1, cb.shape[-1])
            x = leaves[path].reshape(cb.shape[0], -1)
            got = kmeans_assign(x, cb)
            want = ref.kmeans_assign_ref(x, cb)
            label = f"kmeans_assign {list(x.shape)} {path}, {which}"
            compare(f"{label}: assign", got[0], want[0], exact=True)
            compare(f"{label}: counts", got[2], want[2], exact=True)
            compare(f"{label}: sums", got[1], want[1], rel_tol=1e-5)
            most = max(most, int(want[2].max().item()))
            del got, want
    print(f"  every leaf held; the largest centroid holds {most} points "
          f"(2^24 = {1 << 24})")


def fixed_dc(spec: str, params, qspec) -> tuple:
    """Direct compression of every quantized leaf with a fixed scheme on
    the card, held element by element against the plain version on the
    card, and packed once.  Returns (leaf count, packed MB, ratio)."""
    from repro_torch.core.baselines import direct_compression
    from repro_torch.core.lc import quant_leaf_paths
    from repro_torch.core.plan import CompressionPlan
    from repro_torch.kernels import ref
    plan = CompressionPlan.parse(spec)
    scheme = plan.scheme
    w_dc, state = direct_compression(None, params, plan, qspec)
    leaves, dc = _leaves(params), _leaves(w_dc)
    flips = 0
    for path in quant_leaf_paths(qspec):
        want = ref.fixed_quant_ref(leaves[path], scheme.kind, scheme.pow2_c)
        flips += hold_fixed_quant(f"DC {spec} {path}", dc[path], want,
                                  leaves[path], scheme.kind)
    pm = plan.pack(params, state, qspec)
    s = pm.summary()
    print(f"  DC {spec}: {len(pm.packed)} leaves held against the plain "
          f"version ({flips} pow2 flips), packed {s['packed_bytes'] / 1e6:.1f}"
          f" MB, eq.-14 ratio {s['ratio']:.3f}")
    return len(pm.packed), s["packed_bytes"] / 1e6, s["ratio"]


def cstep_path(card: str, cfg, dev, directory: str) -> dict:
    """The paper's C step on the card at full width: direct compression of
    a random ``cfg`` (weights from a seed, as ``build_artifact`` makes
    them) with ``CompressionPlan.parse("adaptive:16")`` (k-means++ seeds,
    50 first iterations), packed and saved to ``directory``: the artifact
    every later qwen phase serves.  Then DC with ``ternary`` and
    ``pow2:4``.  The launch counters are zeroed before and read after the
    three; only the two C-step kernels may run."""
    from repro_torch.core import lc
    from repro_torch.core.baselines import direct_compression
    from repro_torch.core.plan import CompressionPlan
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import init_params
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    plan = CompressionPlan.parse(f"adaptive:{K_MAIN}")
    qspec = plan.build_qspec(params)
    p1, p0 = lc.param_counts(params, qspec)
    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # direct_compression seeds with lc.init_theta when given no theta0; the
    # seeds are taken here to replay two groups on the CPU
    theta0 = lc.init_theta(gen, params, plan, qspec)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, state = direct_compression(None, params, plan, qspec, theta0=theta0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pm = plan.pack(params, state, qspec)
    t3 = time.perf_counter()
    pm.save(directory)
    t4 = time.perf_counter()
    fixed = {spec: fixed_dc(spec, params, qspec)
             for spec in ("ternary", "pow2:4")}
    counts = dispatch.launch_counts()
    check_launched("C step (DC adaptive:16, ternary, pow2:4)", counts,
                   CSTEP_KERNELS)
    iters = {p: th["kmeans_iters"].tolist()
             for p, th in state.theta.items()}
    s = pm.summary()
    c_ms = 1e3 * (t2 - t0)
    print(f"C step on {card}: DC adaptive:{K_MAIN} of {len(iters)} leaves, "
          f"{p1} weights quantized ({p0} kept dense): seeding "
          f"{1e3 * (t1 - t0):.1f} ms + fits {1e3 * (t2 - t1):.1f} ms = "
          f"{c_ms:.1f} ms wall, {p1 / c_ms / 1e3:.1f} Mweights/s; pack "
          f"{1e3 * (t3 - t2):.1f} ms, save {1e3 * (t4 - t3):.1f} ms")
    for p, n in iters.items():
        print(f"  iters_run {p}: {n}")
    print(f"  packed {s['packed_bytes'] / 1e6:.1f} MB vs "
          f"{s['ref_bytes'] / 1e6:.1f} MB f32, eq.-14 ratio "
          f"{s['ratio']:.3f} (b = {s['bits_per_weight']} bits per index)")
    profile_window(f"C step fits (DC adaptive:{K_MAIN}, the same seeds)",
                   lambda: direct_compression(None, params, plan, qspec,
                                              theta0=theta0), card)
    for path in CSTEP_HELD:
        hold_cstep_group(path, params, theta0, state, pm, plan.scheme)
    t5 = time.perf_counter()
    hold_kmeans_assign_leaves(params, {"k-means++ seeds": theta0,
                                       "fitted codebooks": state.theta})
    torch.cuda.synchronize()
    print(f"  row 12 held on every leaf in {time.perf_counter() - t5:.1f} s")
    del params, state, theta0
    torch.cuda.empty_cache()
    return dict(counts=counts, c_step_ms=c_ms, iters=iters, pm=pm,
                fixed=fixed, mweights_per_s=p1 / c_ms / 1e3)


# ---------------------------------------------------------------------------
# Main-path phase
# ---------------------------------------------------------------------------

def build_artifact(cfg, k: int, seed: int, directory: str, dev):
    """Random K-entry artifact of ``cfg``, built on the card: per eligible
    leaf (per layer group for stacked leaves) the codebook is the K
    quantiles of a fixed random subsample and the assignment is a
    bucketize against the codebook midpoints, packed on the card.  Smoke
    scaffolding for deepseek, whose DC on the card is ROADMAP.md queue 1
    item 2; qwen's artifact comes from the C step (``cstep_path``)."""
    from repro_torch.core.compression import (DEFAULT_EXCLUDE, PackedLeaf,
                                              PackedModel, pack_lanes_torch)
    from repro_torch.core.lc import tree_items
    from repro_torch.models.transformer import init_params
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, device=dev)
    levels = (torch.arange(k, device=dev, dtype=torch.float32) + 0.5) / k
    packed, dense, entries = {}, {}, 0
    for path, leaf in tree_items(params):
        grouped = path.startswith("['stacks']")
        groups = leaf if grouped else leaf[None]
        if groups[0].ndim < 2 or DEFAULT_EXCLUDE.search(path):
            dense[path] = leaf.cpu().numpy()
            continue
        words, cbs = [], []
        for w in groups:
            flat = w.reshape(-1)
            sub = flat[torch.randint(0, flat.numel(), (1 << 20,),
                                     generator=gen, device=dev)]
            cb = torch.quantile(sub, levels)
            idx = torch.bucketize(flat, (cb[1:] + cb[:-1]) / 2)
            words.append(pack_lanes_torch(idx, k, 0).view(
                torch.int32).cpu().numpy().view(np.uint32))
            cbs.append(cb.cpu().numpy())
        entries += k * len(cbs)
        packed[path] = PackedLeaf(
            words=np.stack(words) if grouped else words[0],
            codebook=np.stack(cbs) if grouped else cbs[0],
            shape=tuple(leaf.shape), k=k, dtype="float32")
    pm = PackedModel(packed=packed, dense=dense, scheme_spec=f"adaptive:{k}",
                     k=k, codebook_entries=entries)
    pm.save(directory)
    return pm


def plain_teacher_forced(params_cpu, cfg, prompts: np.ndarray,
                         tokens: np.ndarray) -> torch.Tensor:
    """The same serve steps through the plain versions (the CPU route of
    every kernel) on the artifact's decoded params (the dense layout, whose
    plain route equals the quantized layouts' bit for bit), feeding the
    served tokens: per-step logits [B, G, V]."""
    from repro_torch.engine.oneshot import grow_caches
    from repro_torch.models.transformer import decode_step, prefill
    params = params_cpu
    p = torch.from_numpy(prompts)
    gen_len = tokens.shape[1]
    logits, caches = prefill(params, cfg, p, last_logits_only=True)
    caches = grow_caches(caches, p.shape[1], gen_len)
    out = [logits[:, -1:]]
    for t in range(gen_len - 1):
        tok = torch.from_numpy(tokens[:, t:t + 1])
        logits, caches = decode_step(params, cfg, caches, tok,
                                     p.shape[1] + t)
        out.append(logits[:, -1:])
    return torch.cat(out, dim=1)


def profile_window(label: str, fn, card: str) -> None:
    """Run ``fn`` once under torch.profiler: host wall time, device kernel
    time (CUPTI, device-side events only), the device's idle share and the
    kernels that take it.  The profiler adds host time of its own, so the
    idle shares are upper bounds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    # device-side events only: a CPU op's entry repeats the time of the
    # kernels it launched
    kern = [(e.key, _device_ms(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_ms(e) > 0]
    busy = sum(ms for _, ms, _ in kern)
    if busy == 0:
        print(f"profile {label}: device time not measured (the profiler "
              f"recorded no kernel time)")
        return
    top = sorted(kern, key=lambda r: -r[1])[:8]
    print(f"profile {label} on {card}: wall {wall:.3f} ms, device kernels "
          f"{busy:.3f} ms, device idle {1 - busy / wall:.1%}")
    for name, ms, n in top:
        print(f"    {ms:9.3f} ms  {n:6d} calls  {name[:90]}")


def profile_serve(directory: str, sh: Shapes, dev, card: str) -> None:
    """Where a one-shot serve's time goes: one prefill, then 4 decode
    steps, each under :func:`profile_window`."""
    from repro_torch.core.compression import PackedModel
    from repro_torch.engine.oneshot import grow_caches
    from repro_torch.models.transformer import decode_step, prefill
    params = PackedModel.load(directory).serving_params(packed=True,
                                                        device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    prompts = torch.randint(0, sh.v, (sh.batch, sh.prompt_len), generator=g,
                            device=dev)
    steps = 4

    def run_prefill():
        return prefill(params, sh.cfg, prompts, last_logits_only=True)

    logits, caches = run_prefill()                      # warm
    caches = grow_caches(caches, sh.prompt_len, 2 * steps + 1)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    decode_step(params, sh.cfg, caches, tok, sh.prompt_len)   # warm

    def run_decode():
        for t in range(steps):
            decode_step(params, sh.cfg, caches, tok, sh.prompt_len + 1 + t)

    profile_window("prefill", run_prefill, card)
    profile_window(f"decode x{steps}", run_decode, card)


def profile_engine(directory: str, sh: Shapes, dev, card: str) -> None:
    """Where an engine serve's time goes: the first engine step (admission
    and one prefill block of ``block`` tokens), then 4 steps once every
    slot decodes, each under :func:`profile_window`."""
    from repro_torch.core.compression import PackedModel
    from repro_torch.engine import Engine, Request
    params = PackedModel.load(directory).serving_params(packed=True,
                                                        device=dev)
    prompts = np.random.RandomState(5).randint(
        0, sh.v, size=(sh.batch, sh.prompt_len))
    eng = Engine(params, sh.cfg, n_slots=sh.batch, page_size=sh.page,
                 max_seq=sh.prompt_len + sh.gen_len)
    for r in range(sh.batch):
        eng.submit(Request(rid=r, prompt=prompts[r],
                           max_new_tokens=sh.gen_len))
    profile_window(f"engine step: admission + one {sh.block}-token prefill "
                   f"block", eng.step, card)
    while eng.sched.prefilling_ids() or eng.sched.queue:
        eng.step()
    steps = 4

    def run_decode():
        for _ in range(steps):
            eng.step()

    profile_window(f"engine decode x{steps} ({sh.batch} slots)", run_decode,
                   card)


# The kernels each path must launch: the one-shot serve, the engine on
# dense pages and the engine on quantized pages.
ONESHOT_KERNELS = ("quantized_gather", "codebook_matmul_packed",
                   "codebook_matmul_packed_t", "blockwise_prefill")
DENSE_PATH_KERNELS = ONESHOT_KERNELS + ("page_gather", "paged_attention")
QUANT_PATH_KERNELS = ("quantized_gather", "codebook_matmul_packed",
                      "codebook_matmul_packed_t", "page_gather",
                      "blockwise_prefill_quant", "paged_attention_quant")


def check_launched(path: str, counts: dict, names) -> None:
    """Every kernel of ``names`` launched during the path, and no other."""
    print(f"launches during the {path}: {counts}")
    missing = [n for n in names if counts[n] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the {path}: "
                           f"{missing}")
    extra = {n: c for n, c in counts.items() if c and n not in names}
    if extra:
        raise SmokeFailure(f"the {path} launched kernels outside its path: "
                           f"{extra}")


class RouteTape:
    """The MoE routes of a serve, call by call: every call of
    ``moe.route`` (one layer's top-k expert ids), kept on the device while
    recording.  A replay on the CPU takes the card's expert ids (routing
    is discontinuous: an ulp in a router logit can swap the k-th and
    (k+1)-th expert of a token), computes its own gates for them, and
    reports every token of a live row whose own top-k differs, with the
    gap of the CPU's probabilities at the first differing rank relative to
    the row's largest; a gap not below ROUTE_TIE_REL fails.  ``live`` ([B]
    bool, or None for every row) is set by the caller before each step:
    dead engine slots read other attention values on the two devices."""

    def __init__(self):
        self.calls = []
        self.live = None

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.models import moe
        route = moe.route

        def record(x, router_w, k):
            gates, eidx = route(x, router_w, k)
            self.calls.append(eidx.clone())
            return gates, eidx

        moe.route = record
        try:
            yield self
        finally:
            moe.route = route

    @contextlib.contextmanager
    def replaying(self, report: dict):
        from repro_torch.models import moe
        route = moe.route
        calls = iter(self.calls)

        def replay(x, router_w, k):
            if report["calls"] == len(self.calls):
                raise SmokeFailure(f"the CPU replay routes more than the "
                                   f"card's {len(self.calls)} calls")
            card = next(calls).to(x.device)
            report["calls"] += 1
            probs = moe.router_probs(x, router_w)
            srt, own = moe.top_k(probs, k + 1)
            if card.shape != own[..., :k].shape:
                raise SmokeFailure(f"route call {report['calls'] - 1}: "
                                   f"{tuple(card.shape)} on the card, "
                                   f"{tuple(own[..., :k].shape)} on the CPU")
            diff = own[..., :k] != card
            flip = diff.any(-1)
            if self.live is not None:
                flip &= self.live.to(flip.device)[:, None]
            for b, t in flip.nonzero().tolist():
                j = int(diff[b, t].nonzero()[0])
                gap = float(srt[b, t, j] - srt[b, t, j + 1]) / float(
                    srt[b, t, 0])
                report["flips"].append((j + 1, gap))
                if gap >= ROUTE_TIE_REL:
                    raise SmokeFailure(
                        f"route call {report['calls'] - 1}: row {b} token "
                        f"{t} routes to {card[b, t].tolist()} on the card, "
                        f"{own[b, t, :k].tolist()} on the CPU, whose "
                        f"probabilities at rank {j + 1}/{j + 2} differ by "
                        f"{gap:.2e} of the largest")
            report["tokens"] += int(card.shape[0] * card.shape[1])
            top = probs.gather(-1, card)
            return top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9), card

        moe.route = replay
        try:
            yield
        finally:
            moe.route = route
        if report["calls"] != len(self.calls):
            raise SmokeFailure(f"the CPU replay routed {report['calls']} "
                               f"calls, the card {len(self.calls)}")


def route_report() -> dict:
    return dict(calls=0, tokens=0, flips=[])


def print_routes(label: str, report: dict) -> None:
    flips = report["flips"]
    worst = max((g for _, g in flips), default=0.0)
    ranks = sorted({j for j, _ in flips})
    print(f"  {label}: {report['calls']} route calls on the card's expert "
          f"ids ({report['tokens']} token rows); {len(flips)} tokens whose "
          f"CPU top-k differs (at ranks {ranks}), largest probability gap "
          f"{worst:.2e} of the row's largest (a gap of {ROUTE_TIE_REL:g} or "
          f"more fails)")


def main_path(card: str, sh: Shapes, dev, directory: str, params_cpu,
              layout: str = "packed", kernels=None, routes=None,
              reuse=None, profile: bool = True) -> dict:
    """The one-shot path (``--no-engine``) of ``sh.cfg`` through the
    launcher, in the ``layout`` serving layout, its logits held at every
    step against the plain route teacher-forced on the served tokens.
    ``routes`` (a RouteTape) records the serve's MoE routes and replays
    them on the CPU; ``reuse`` is an earlier one-shot result on the same
    prompts whose plain logits serve when the tokens are the same."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    cfg, batch = sh.cfg, sh.batch
    prompt_len, gen_len = sh.prompt_len, sh.gen_len
    argv = ["--packed", directory, "--no-engine", "--batch", str(batch),
            "--prompt-len", str(prompt_len), "--gen-len", str(gen_len),
            "--serve-layout", layout, "--device", str(dev)]
    label = f"one-shot serve ({layout} layout, {cfg.name})"
    ctx = routes.recording() if routes else contextlib.nullcontext()
    dispatch.reset_launch_counts()
    with ctx:
        res = serve.main(argv, cfg=cfg)
    counts = dispatch.launch_counts()
    check_launched(label, counts, kernels or ONESHOT_KERNELS)
    tokens, logits = res["tokens"], res["logits"].cpu()
    if tokens.shape != (batch, gen_len) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab:
        raise SmokeFailure(f"bad served tokens {tokens}")
    if logits.shape != (batch, gen_len, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise SmokeFailure("served logits have the wrong shape or are "
                           "not finite")
    print(f"served on {card} ({label}): prefill {res['prefill_ms']:.3f} ms, "
          f"decode {res['decode_ms_per_step']:.3f} ms/step, "
          f"{res['decode_tokens_per_s']:.1f} decode tokens/s, "
          f"{res['tokens_per_s']:.1f} tokens/s end to end")
    if reuse is not None and np.array_equal(reuse["tokens"], tokens) \
            and np.array_equal(reuse["prompts"], res["prompts"]):
        plain = reuse["plain"]
        print("  the same tokens as the packed serve: its plain replay "
              "holds here too (the layouts' plain routes are bitwise equal)")
    else:
        t1 = time.perf_counter()
        report = route_report()
        ctx = routes.replaying(report) if routes else \
            contextlib.nullcontext()
        with ctx:
            plain = plain_teacher_forced(params_cpu, cfg, res["prompts"],
                                         tokens)
        if routes:
            print_routes(label, report)
        print(f"plain teacher-forced run (CPU route) took "
              f"{time.perf_counter() - t1:.1f} s")
    if profile:
        profile_serve(directory, sh, dev, card)
    compare(f"{label}: serving logits, every step", logits, plain,
            rel_tol=LOGIT_REL_TOL)
    agree = (plain.argmax(-1).numpy() == tokens).mean()
    print(f"  greedy tokens agree with the plain route's argmax at "
          f"{agree:.3f} of steps")
    return dict(res, counts=counts, plain=plain)


def hold_streams(label: str, params_cpu, cfg, prompts: np.ndarray,
                 outputs: dict, done: dict) -> None:
    """Teacher-force every finished stream through the plain route on the
    CPU (``transformer.prefill`` over prompt + stream): each engine token
    must be the plain argmax, or a near tie within LOGIT_REL_TOL of the
    row's largest |logit|.  ``done`` caches streams already held."""
    from repro_torch.models.transformer import prefill
    n_tok = n_tie = 0
    worst = 0.0
    t0 = time.perf_counter()
    for rid, toks in sorted(outputs.items()):
        toks = np.asarray(toks)
        key = (prompts[rid].tobytes(), toks.tobytes())
        if key not in done:
            seq = np.concatenate([prompts[rid], toks[:-1]]).astype(np.int64)
            logits, _ = prefill(params_cpu, cfg, torch.from_numpy(seq[None]))
            rows = logits[0, prompts.shape[1] - 1:]            # [n, V]
            ties, gap_max = 0, 0.0
            for t, tok in enumerate(toks):
                row = rows[t]
                best = int(row.argmax())
                if best == int(tok):
                    continue
                rel = float(row[best] - row[int(tok)]) / float(
                    row.abs().max())
                if rel > LOGIT_REL_TOL:
                    raise SmokeFailure(
                        f"{label}: request {rid} token {t} = {tok} is "
                        f"{rel:.2e} (relative) below the plain route's "
                        f"argmax {best}")
                ties += 1
                gap_max = max(gap_max, rel)
            done[key] = (len(toks), ties, gap_max)
        n, ties, gap_max = done[key]
        n_tok += n
        n_tie += ties
        worst = max(worst, gap_max)
    print(f"  {label}: {n_tok} engine tokens of {len(outputs)} streams held "
          f"against the plain route: {n_tok - n_tie} its argmax, {n_tie} "
          f"near ties within rel {LOGIT_REL_TOL:g} (largest gap {worst:.2e}); "
          f"{time.perf_counter() - t0:.1f} s")


def check_engine_serve(res, n_req: int, cfg, label: str):
    """Every request finished with a stream of its length in the vocab, and
    the EngineStats identity holds.  Returns the engine."""
    bad = {r: v.outcome.value for r, v in res["results"].items()
           if not v.ok}
    if bad or sorted(res["outputs"]) != list(range(n_req)):
        raise SmokeFailure(f"{label}: requests not all finished: {bad}")
    for rid, toks in res["outputs"].items():
        want = res["requests"][rid].max_new_tokens
        if len(toks) != want or toks.min() < 0 or toks.max() >= cfg.vocab:
            raise SmokeFailure(f"{label}: request {rid}: bad stream {toks}")
    st = res["engine"].stats
    if st.generated_tokens != st.decode_tokens + st.prefill_samples:
        raise SmokeFailure(f"{label}: EngineStats identity broken")
    return res["engine"]


def print_engine(card: str, label: str, res) -> None:
    eng, s = res["engine"], res["stats"]
    st = eng.stats
    print(f"{label} on {card} ({eng.pool.n_pages} pages): prefill "
          f"{s['prefill_ms_per_block']:.3f} ms/block (median of "
          f"{len(st.prefill_block_s)}), decode {s['decode_ms_per_step']:.3f} "
          f"ms/step (median of {len(st.decode_step_s)}), "
          f"{s['tokens_per_s']:.1f} tokens/s, slot occupancy "
          f"{s['slot_occupancy']:.3f}, page utilisation "
          f"{s['page_utilization']:.3f} (peak "
          f"{s['page_utilization_max']:.3f}), {s['stall_events']} stalls, "
          f"{s['preemptions']} preemptions, {s['steps']} steps, "
          f"{s['wall_s']:.3f} s")


def engine_argv(sh: Shapes, dev, directory: str):
    """The launcher's engine-mode arguments of the engine paths."""
    return ["--packed", directory, "--requests", str(2 * sh.batch),
            "--slots", str(sh.batch), "--prompt-len", str(sh.prompt_len),
            "--gen-len", str(sh.gen_len), "--vary-gen", "--page-size",
            str(sh.page), "--device", str(dev)]


def engine_path(card: str, sh: Shapes, dev, directory: str,
                params_cpu) -> dict:
    """The engine path (the launcher's default mode) at full width: a
    pool with room for every slot, then an oversubscribed one."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    cfg = sh.cfg
    n_req = 2 * sh.batch
    base = engine_argv(sh, dev, directory)
    done: dict = {}

    def serve_once(extra):
        res = serve.main(base + extra, cfg=cfg)
        check_engine_serve(res, n_req, cfg, "engine serve")
        print_engine(card, f"engine ({' '.join(extra) or 'default pool'})",
                     res)
        return res

    dispatch.reset_launch_counts()
    res = serve_once([])
    counts = dispatch.launch_counts()
    check_launched("engine serve", counts, DENSE_PATH_KERNELS)
    hold_streams("default pool", params_cpu, cfg, res["prompts"],
                 res["outputs"], done)
    pages = 25
    while True:
        tight = serve_once(["--pages", str(pages)])
        if tight["stats"]["stall_events"] > 0:
            break
        print(f"  --pages {pages} showed no stall; trying {pages - 1}")
        pages -= 1
        if pages < sh.npg:
            raise SmokeFailure("no oversubscribed pool showed a stall")
    print(f"  oversubscribed pool: --pages {pages} stalled "
          f"{tight['stats']['stall_events']} times")
    hold_streams(f"--pages {pages}", params_cpu, cfg, tight["prompts"],
                 tight["outputs"], done)
    profile_engine(directory, sh, dev, card)
    return dict(res, counts=counts, tight=tight, pages=pages)


class WriteTape:
    """The quantizing page writes of a quantized-KV serve, call by call:
    every call of ``attention._write_rows_quant`` (one layer's K or V
    rows), with the rows, the rows that started a page and the codebooks
    fit from them, and the words and page codebooks the call stored.  Kept
    on the device while recording, so the serve is not synchronised."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.models import attention as attn
        write = attn._write_rows_quant

        def record(words, cbs, phys, off, alive, new, bits, cb_mode, first,
                   cb_fit, src=None):
            out = write(words, cbs, phys, off, alive, new, bits, cb_mode,
                        first, cb_fit, src)
            self.calls.append(dict(
                new=new.clone(), alive=alive.clone(),
                first=None if cb_fit is None else new[first].clone(),
                cb_fit=None if cb_fit is None else cb_fit.clone(),
                words=words[phys, off].clone(), cbs=cbs[phys].clone()))
            return out

        attn._write_rows_quant = record
        try:
            yield self
        finally:
            attn._write_rows_quant = write


def _distortion(rows, cbs, cb_mode):
    """Σ (v − cb[assign(v, cb)])² per codebook group, and Σ v²."""
    from repro_torch.core import kvquant
    from repro_torch.models import attention as attn
    grp = attn._quant_groups(rows, cb_mode).float()
    rec = kvquant.dequant_codebook(kvquant.assign_codebook(grp, cbs), cbs)
    return ((grp - rec) ** 2).sum(-1), (grp ** 2).sum(-1)


@contextlib.contextmanager
def replaying(tape: WriteTape, what: str, report: dict):
    """Replay a card serve's page writes on the CPU, call i for call i (the
    same engine decisions make the same calls in the same order).

    ``what == "fits"``: the CPU quantizes its own rows against the card's
    fitted codebooks.  ``what == "pages"``: the CPU stores the card's words
    and codebooks, and checks each call: the rows it computed itself within
    REL_TOL of the card's; the card's words exactly the assignment of the
    card's rows to the card's codebooks, packed; the card's fitted
    codebooks as good a k-means fit of their rows as the CPU's fit of the
    same rows (distortion within 1%, or 1e-6 of the rows' energy)."""
    from repro_torch.core import kvquant
    from repro_torch.models import attention as attn
    write = attn._write_rows_quant
    calls = iter(tape.calls)

    def replay(words, cbs, phys, off, alive, new, bits, cb_mode, first,
               cb_fit, src=None):
        if report["calls"] == len(tape.calls):
            raise SmokeFailure(f"the CPU replay writes more than the card's "
                               f"{len(tape.calls)} calls")
        card = {k: (v.cpu() if v is not None else None)
                for k, v in next(calls).items()}
        n = report["calls"]
        report["calls"] += 1
        if card["new"].shape != new.shape or \
                (card["cb_fit"] is None) != (cb_fit is None):
            raise SmokeFailure(f"write call {n}: rows {tuple(new.shape)} on "
                               f"the CPU vs {tuple(card['new'].shape)} on "
                               f"the card")
        if what == "fits":
            return write(words, cbs, phys, off, alive, new, bits, cb_mode,
                         first, card["cb_fit"], src)
        live = card["alive"]
        scale = card["new"].abs().max().item()
        err = (new - card["new"]).abs()[live].max().item() if live.any() \
            else 0.0
        report["rows_rel"] = max(report["rows_rel"], err / scale)
        if err > REL_TOL * scale:
            raise SmokeFailure(f"write call {n}: K/V rows differ from the "
                               f"card's by {err / scale:.2e} (relative)")
        idx = kvquant.assign_codebook(attn._quant_groups(card["new"], cb_mode),
                                      card["cbs"])
        packed = kvquant.pack_rows_torch(idx.reshape(new.shape), bits)
        if not torch.equal(packed[live], card["words"][live]):
            raise SmokeFailure(f"write call {n}: the card's words are not the "
                               f"assignment of its rows to its codebooks")
        if card["cb_fit"] is not None:
            ck = kvquant.fit_codebooks(
                attn._quant_groups(card["first"], cb_mode), bits).to(
                    card["cb_fit"].dtype)
            d_card, energy = _distortion(card["first"], card["cb_fit"],
                                         cb_mode)
            d_cpu, _ = _distortion(card["first"], ck, cb_mode)
            floor = 1e-6 * energy
            report["fit_ratio"] = max(report["fit_ratio"], float(
                ((d_card + floor) / (d_cpu + floor).clamp(min=1e-30)).max()))
            if (d_card > 1.01 * d_cpu + floor).any():
                raise SmokeFailure(
                    f"write call {n}: the card's codebooks leave distortion "
                    f"{d_card.max().item():.4e} on their rows, the CPU fit "
                    f"of the same rows {d_cpu.max().item():.4e}")
            same = (card["cb_fit"] == ck).all(-1)
            report["groups"] += same.numel()
            report["equal"] += int(same.sum())
        words[phys, off] = card["words"]
        cbs[phys] = card["cbs"]
        return words, cbs

    attn._write_rows_quant = replay
    try:
        yield
    finally:
        attn._write_rows_quant = write
    if report["calls"] != len(tape.calls):
        raise SmokeFailure(f"the CPU replay made {report['calls']} write "
                           f"calls, the card {len(tape.calls)}")


def replay_engine_cpu(params_cpu, res, routes=None) -> dict:
    """The serve's engine again on the CPU (the port's plain versions of
    its kernels), teacher-forced: the same requests and knobs, so it takes
    the same scheduling decisions, with every sampled token replaced by
    the card's.  ``routes`` (a replaying RouteTape) learns which slots are
    live at each step.  Returns rid → logits rows [n, V], row t the logits
    the card's token t was sampled from."""
    from repro_torch.engine import Engine
    card = res["engine"]
    outputs = res["outputs"]
    eng = Engine(params_cpu, card.cfg, n_slots=card.n_slots,
                 page_size=card.page_size, max_seq=card.max_seq,
                 n_pages=card.pool.n_pages, token_budget=card.token_budget,
                 prefill_chunk=card.prefill_chunk, kv_bits=card.kv_bits,
                 kv_cb_mode=card.kv_cb_mode)
    rows = {rid: [] for rid in outputs}
    decode, chunk = eng._decode, eng._chunk

    def forced(logits, i, pos, rid, t):
        rows[rid].append(logits[i, pos].clone())
        out = torch.zeros_like(logits[i, pos])
        out[int(outputs[rid][t])] = 1.0
        logits[i, pos] = out

    def decode_forced(p, cfg, caches, table, tokens, pos, alive, **kw):
        if routes is not None:
            routes.live = alive.bool()
        logits, caches = decode(p, cfg, caches, table, tokens, pos, alive,
                                **kw)
        for i, s in enumerate(eng.sched.slots):
            if s is not None and bool(alive[i]):
                forced(logits, i, 0, s.req.rid, len(s.out))
        return logits, caches

    def chunk_forced(p, cfg, caches, table, tok, slot, start):
        if routes is not None:
            routes.live = None
        logits, caches = chunk(p, cfg, caches, table, tok, slot, start)
        s = eng.sched.slots[slot]
        if start + tok.shape[1] >= s.req.prompt_len:
            forced(logits, 0, -1, s.req.rid, 0)
        return logits, caches

    eng._decode, eng._chunk = decode_forced, chunk_forced
    got = eng.run([dataclasses.replace(r) for r in res["requests"]])
    if sorted(got) != sorted(outputs) or any(
            not np.array_equal(got[r], outputs[r]) for r in outputs):
        raise SmokeFailure("the CPU replay did not follow the card's tokens")
    return {rid: torch.stack(r) for rid, r in rows.items()}


def token_agreement(outputs: dict, rows: dict) -> dict:
    """Per card token: the CPU logits' argmax, a near tie (within
    LOGIT_REL_TOL of the row's largest |logit|), or beyond the gate."""
    n_tok = n_tie = 0
    worst = 0.0
    beyond = []
    for rid, toks in sorted(outputs.items()):
        for t, tok in enumerate(toks):
            row = rows[rid][t]
            best = int(row.argmax())
            n_tok += 1
            if best == int(tok):
                continue
            rel = float(row[best] - row[int(tok)]) / float(row.abs().max())
            worst = max(worst, rel)
            if rel > LOGIT_REL_TOL:
                beyond.append((rid, t, int(tok), best, rel))
            else:
                n_tie += 1
    return dict(tokens=n_tok, ties=n_tie, beyond=beyond, worst=worst)


def hold_engine(label: str, params_cpu, res, tape: WriteTape = None,
                routes: RouteTape = None) -> None:
    """Hold an engine serve's streams against the port's path on the CPU
    (plain versions), teacher-forced through the same engine decisions
    (``replay_engine_cpu``): every card token must be the CPU logits'
    argmax or a near tie within LOGIT_REL_TOL.  With quantized pages the
    CPU stores the pages the card wrote, call by call (``replaying(...,
    "pages")``, which checks each write); with MoE layers it takes the
    card's expert ids (``RouteTape.replaying``, which checks each one that
    differs from the CPU's own is a near tie)."""
    t0 = time.perf_counter()
    report = dict(calls=0, groups=0, equal=0, fit_ratio=0.0, rows_rel=0.0)
    rr = route_report()
    with contextlib.ExitStack() as stack:
        if tape is not None:
            stack.enter_context(replaying(tape, "pages", report))
        if routes is not None:
            stack.enter_context(routes.replaying(rr))
        rows = replay_engine_cpu(params_cpu, res, routes)
    agree = token_agreement(res["outputs"], rows)
    on = (" on the card's pages" if tape is not None else "")
    print(f"  {label}: {agree['tokens']} card tokens held against the CPU "
          f"path teacher-forced{on}: "
          f"{agree['tokens'] - agree['ties'] - len(agree['beyond'])} its "
          f"argmax, {agree['ties']} near ties within rel {LOGIT_REL_TOL:g} "
          f"(largest gap {agree['worst']:.2e}); "
          f"{time.perf_counter() - t0:.1f} s")
    if tape is not None:
        print(f"  {label}: {report['calls']} page writes: CPU rows within "
              f"rel {report['rows_rel']:.2e} of the card's, the card's words "
              f"its rows' assignment exactly, its codebooks "
              f"{report['equal']} of {report['groups']} bitwise equal to "
              f"the CPU fit of the same rows, distortion ratio card/CPU at "
              f"most {report['fit_ratio']:.6f}")
    if routes is not None:
        print_routes(label, rr)
    if agree["beyond"]:
        rid, t, tok, best, rel = agree["beyond"][0]
        raise SmokeFailure(f"{label}: request {rid} token {t} = {tok} is "
                           f"{rel:.2e} (relative) below the CPU path's "
                           f"argmax {best}")


def hold_quant_streams(label: str, params_cpu, res, tape: WriteTape) -> None:
    """Hold a quantized-KV serve's streams against the port's quantized
    path on the CPU teacher-forced on the card's pages (:func:`hold_engine`,
    the gate).

    Measured, not gated: the same replay with the CPU quantizing its own
    rows against the card's codebooks, and with the CPU fitting its own
    codebooks too.  Both quantize values that differ from the card's by
    rounding: an index flips where a value sits at a midpoint, a fit moves
    when a point crosses one, and the difference grows layer by layer, so
    the logits part by more than the gate allows (PERF.md, PR 14)."""
    hold_engine(label, params_cpu, res, tape)
    for what in ("fits", "own"):
        ctx = (replaying(tape, "fits", dict(calls=0)) if what == "fits"
               else contextlib.nullcontext())
        with ctx:
            agree = token_agreement(res["outputs"],
                                    replay_engine_cpu(params_cpu, res))
        how = ("to the card codebooks" if what == "fits"
               else "and fitting its own codebooks")
        print(f"  {label}, the CPU quantizing its own rows {how} "
              f"(measured, not gated): "
              f"{agree['tokens'] - agree['ties'] - len(agree['beyond'])} "
              f"tokens its argmax, {agree['ties']} near ties, "
              f"{len(agree['beyond'])} beyond rel {LOGIT_REL_TOL:g} (largest "
              f"gap {agree['worst']:.2e})")


def pool_bytes(eng) -> int:
    """Bytes of every page pool the engine allocated (from the tensors)."""
    return sum(t.numel() * t.element_size() for stack in eng.caches
               for cache in stack.values() for t in cache)


def profile_engine_quant(directory: str, sh: Shapes, dev, card: str,
                         kv_bits: int) -> None:
    """Where a quantized-KV engine serve's time goes: the first engine
    step (admission and one prefill block), then 4 decode steps."""
    from repro_torch.core.compression import PackedModel
    from repro_torch.engine import Engine, Request
    params = PackedModel.load(directory).serving_params(packed=True,
                                                        device=dev)
    prompts = np.random.RandomState(5).randint(
        0, sh.v, size=(sh.batch, sh.prompt_len))
    eng = Engine(params, sh.cfg, n_slots=sh.batch, page_size=sh.page,
                 max_seq=sh.prompt_len + sh.gen_len, kv_bits=kv_bits)
    for r in range(sh.batch):
        eng.submit(Request(rid=r, prompt=prompts[r],
                           max_new_tokens=sh.gen_len))
    profile_window(f"quant engine step ({kv_bits}-bit): admission + one "
                   f"{sh.block}-token prefill block", eng.step, card)
    while eng.sched.prefilling_ids() or eng.sched.queue:
        eng.step()
    steps = 4

    def run_decode():
        for _ in range(steps):
            eng.step()

    profile_window(f"quant engine decode x{steps} ({kv_bits}-bit, "
                   f"{sh.batch} slots)", run_decode, card)


def quant_engine_path(card: str, sh: Shapes, dev, directory: str,
                      params_cpu) -> dict:
    """The engine on codebook-quantized KV pages at full width: the engine
    path's requests with ``--kv-bits 4`` twice (the streams must be equal
    bit for bit: the codebook fit is deterministic on the card), then
    ``--kv-bits 8 --kv-cb head`` once; each stream held against the CPU
    quantized path."""
    from repro_torch.engine.kvcache import equal_hbm_slots, kv_page_footprint
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    cfg = sh.cfg
    n_req = 2 * sh.batch
    base = engine_argv(sh, dev, directory)
    counts = None
    runs = []
    for n, extra in enumerate((["--kv-bits", "4"], ["--kv-bits", "4"],
                               ["--kv-bits", "8", "--kv-cb", "head"])):
        # the first serve is timed as it is; the others record their writes
        label = f"quantized-KV engine serve ({' '.join(extra)})"
        tape = WriteTape()
        ctx = tape.recording() if n else contextlib.nullcontext()
        dispatch.reset_launch_counts()
        with ctx:
            res = serve.main(base + extra, cfg=cfg)
        c = dispatch.launch_counts()
        check_launched(label, c, QUANT_PATH_KERNELS)
        counts = counts or c
        eng = check_engine_serve(res, n_req, cfg, label)
        print_engine(card, label, res)
        dense_bytes = (2 * cfg.n_layers * (eng.pool.n_pages + 1) * sh.page
                       * cfg.n_kv * cfg.head_dim * 4)
        geo = (sh.page, cfg.n_kv, cfg.head_dim)
        knobs = (eng.kv_bits, eng.kv_cb_mode)
        print(f"  page pools {pool_bytes(eng)} B from the tensors vs "
              f"{dense_bytes} B dense; kv_page_footprint "
              f"{kv_page_footprint(*geo, *knobs)} B vs "
              f"{kv_page_footprint(*geo)} B dense per page and tensor; "
              f"equal_hbm_slots {equal_hbm_slots(sh.batch, *geo, *knobs)} "
              f"for {sh.batch} dense slots")
        if n:
            hold_quant_streams(' '.join(extra), params_cpu, res, tape)
        runs.append(res)
    a, b = runs[0]["outputs"], runs[1]["outputs"]
    if any(not np.array_equal(a[r], b[r]) for r in a):
        raise SmokeFailure("two --kv-bits 4 serves streamed different "
                           "tokens: the fit is not deterministic on the card")
    print(f"  --kv-bits 4 twice: {sum(len(v) for v in a.values())} tokens "
          f"bitwise equal")
    profile_engine_quant(directory, sh, dev, card, 4)
    return dict(runs[0], counts=counts, kv8=runs[2])


# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b (MLA + MoE) at full width
# ---------------------------------------------------------------------------

DS_ARCH = "deepseek-v2-lite-16b"
DS_ONESHOT_KERNELS = ("quantized_gather", "codebook_matmul_packed",
                      "blockwise_prefill")
DS_DENSE_KERNELS = DS_ONESHOT_KERNELS + ("page_gather",
                                         "mla_paged_attention")
DS_QUANT_KERNELS = DS_ONESHOT_KERNELS + ("page_gather",
                                         "mla_paged_attention_quant")
UINT8_ONESHOT_KERNELS = ("codebook_matmul", "blockwise_prefill")


def depth_cut(cfg):
    """``cfg`` at full width with each stack cut to at most two groups
    (``reduce_config``'s depth rule): for deepseek-v2-lite-16b the dense
    layer and two of the 26 MoE layers, 3 of 27 layers."""
    return dataclasses.replace(cfg, stacks=tuple(
        dataclasses.replace(s, groups=min(s.groups, 2)) for s in cfg.stacks))


def mla_engine_path(card: str, sh: Shapes, dev, directory: str, params_cpu,
                    kv_bits: int = 0) -> dict:
    """The engine on latent pages, dense or ``kv_bits``-bit codebook-
    quantized, at full width: the engine path's requests, their routes
    recorded (and their page writes, when quantized), the streams held
    against the CPU replay on the card's routes (and pages), the page
    pools' bytes against ``mla_page_footprint``."""
    from repro_torch.engine.kvcache import (mla_equal_hbm_slots,
                                            mla_page_footprint)
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    cfg = sh.cfg
    m = cfg.mla
    n_req = 2 * sh.batch
    extra = ["--kv-bits", str(kv_bits)] if kv_bits else []
    label = (f"{cfg.name} engine on "
             f"{f'{kv_bits}-bit' if kv_bits else 'dense'} latent pages")
    routes = RouteTape()
    tape = WriteTape() if kv_bits else None
    dispatch.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(routes.recording())
        if tape is not None:
            stack.enter_context(tape.recording())
        res = serve.main(engine_argv(sh, dev, directory) + extra, cfg=cfg)
    counts = dispatch.launch_counts()
    check_launched(label, counts,
                   DS_QUANT_KERNELS if kv_bits else DS_DENSE_KERNELS)
    eng = check_engine_serve(res, n_req, cfg, label)
    print_engine(card, label, res)
    per_page = mla_page_footprint(sh.page, m.kv_lora, m.rope_dim, kv_bits)
    dense_page = mla_page_footprint(sh.page, m.kv_lora, m.rope_dim)
    pages = cfg.n_layers * (eng.pool.n_pages + 1)
    got = pool_bytes(eng)
    print(f"  latent page pools {got} B from the tensors ({pages} pages x "
          f"mla_page_footprint {per_page} B; dense {dense_page} B per "
          f"page)" + (f"; mla_equal_hbm_slots "
                      f"{mla_equal_hbm_slots(sh.batch, sh.page, m.kv_lora, m.rope_dim, kv_bits)}"
                      f" for {sh.batch} dense slots" if kv_bits else ""))
    if got != pages * per_page:
        raise SmokeFailure(f"{label}: page pools hold {got} B, "
                           f"mla_page_footprint says {pages * per_page} B")
    hold_engine(label, params_cpu, res, tape, routes)
    if kv_bits:
        profile_engine_quant(directory, sh, dev, card, kv_bits)
    else:
        profile_engine(directory, sh, dev, card)
    return dict(res, counts=counts)


def deepseek_paths(card: str, dev, directory: str, sh: Shapes) -> dict:
    """deepseek-v2-lite-16b at full width, cut in depth (``sh.cfg``): a
    random K=16 artifact built on the card, served one-shot, through the
    engine on dense latent pages and on 4-bit latent pages, each held
    against the CPU replay of the same steps on the card's MoE routes."""
    from repro_torch.convert import tree_map
    t0 = time.perf_counter()
    pm = build_artifact(sh.cfg, K_MAIN, seed=0, directory=directory,
                        dev=dev)
    s = pm.summary()
    print(f"{sh.cfg.name} artifact ({sh.cfg.n_layers} layers: "
          f"{[len(st.pattern) * st.groups for st in sh.cfg.stacks]}): "
          f"{len(pm.packed)} packed leaves, {s['packed_bytes'] / 1e6:.1f} MB "
          f"packed vs {s['ref_bytes'] / 1e6:.1f} MB f32, built and saved in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params_cpu = tree_map(lambda t: t.cpu(), pm.decode(device=dev))
    del pm
    torch.cuda.empty_cache()
    print(f"  decoded for the CPU replays in {time.perf_counter() - t0:.1f} "
          f"s")
    oneshot = main_path(card, sh, dev, directory, params_cpu,
                        kernels=DS_ONESHOT_KERNELS, routes=RouteTape())
    dense = mla_engine_path(card, sh, dev, directory, params_cpu)
    quant = mla_engine_path(card, sh, dev, directory, params_cpu, kv_bits=4)
    return dict(oneshot=oneshot, dense=dense, quant=quant)


REPLACES = {
    "quantized_gather": "src/repro/kernels/quantized_gather.py:42",
    "codebook_matmul_packed": "src/repro/kernels/codebook_matmul_packed.py:57",
    "codebook_matmul_packed_t":
        "src/repro/kernels/codebook_matmul_packed_t.py:68",
    "blockwise_prefill": "src/repro/kernels/blockwise_prefill.py:132",
    "page_gather": "src/repro/kernels/paged_attention.py:472",
    "paged_attention": "src/repro/kernels/paged_attention.py:173",
    "blockwise_prefill_quant": "src/repro/kernels/blockwise_prefill.py:176",
    "paged_attention_quant": "src/repro/kernels/paged_attention.py:216",
    "codebook_matmul": "src/repro/kernels/codebook_matmul.py:57",
    "mla_paged_attention": "src/repro/kernels/paged_attention.py:353",
    "mla_paged_attention_quant": "src/repro/kernels/paged_attention.py:401",
    "kmeans_assign": "src/repro/kernels/kmeans_assign.py:53",
    "fixed_quant": "src/repro/kernels/fixed_quant.py:47",
}

# The path whose run gives each kernel's "launches": the path of the slice
# that ported it.
MAIN_PATH_OF = {"blockwise_prefill_quant": "quant_engine",
                "paged_attention_quant": "quant_engine",
                "codebook_matmul": "uint8_oneshot",
                "mla_paged_attention": "deepseek_engine",
                "mla_paged_attention_quant": "deepseek_quant_engine",
                "kmeans_assign": "cstep", "fixed_quant": "cstep"}


def run() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; it runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}")
    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib, log in logs.items():
        print(f"--- ptxas {lib} ---\n{log.strip()}")

    from repro_torch.configs import get_config
    from repro_torch.core.compression import PackedModel
    from repro_torch.models.transformer import DEFAULT_PREFILL_BLOCK
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sh = Shapes(get_config("qwen1.5-0.5b"), batch=4, prompt_len=128,
                gen_len=16, block=DEFAULT_PREFILL_BLOCK)
    full = get_config(DS_ARCH)
    sh_ds = Shapes(depth_cut(full), batch=4, prompt_len=128, gen_len=16,
                   block=DEFAULT_PREFILL_BLOCK)
    print(f"{DS_ARCH}: full width (d_model {full.d_model}, {full.n_heads} "
          f"heads, kv_lora {full.mla.kv_lora}, rope {full.mla.rope_dim}, "
          f"{full.moe.n_experts} experts top-{full.moe.top_k}, vocab "
          f"{full.vocab}), depth cut from {full.n_layers} to "
          f"{sh_ds.cfg.n_layers} layers (the dense layer + 2 MoE layers: "
          f"reduce_config's depth rule) to bound the CPU replay and the "
          f"card's time")
    phase_s = {}

    def timed(label, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[label] = time.perf_counter() - t
        print(f"phase {label}: {phase_s[label]:.1f} s")
        return out

    results = [timed(check.__name__, check, gen, dev, sh) for check in
               (check_gather, check_matmul, check_matmul_t, check_prefill,
                check_page_gather, check_paged_attention,
                check_prefill_quant, check_paged_attention_quant,
                check_codebook_matmul, check_kmeans_assign,
                check_fixed_quant)]
    results += [timed(check.__name__, check, gen, dev, sh_ds) for check in
                (check_mla_paged_attention, check_mla_paged_attention_quant)]
    with tempfile.TemporaryDirectory() as tmp:
        qwen_dir, ds_dir = os.path.join(tmp, "qwen"), os.path.join(tmp, "ds")
        paths = {"cstep": timed("cstep", cstep_path, card, sh.cfg, dev,
                                qwen_dir)}
        pm = paths["cstep"].pop("pm")
        s = pm.summary()
        print(f"artifact (the C step's): {len(pm.packed)} packed leaves, "
              f"{s['packed_bytes'] / 1e6:.1f} MB packed vs "
              f"{s['ref_bytes'] / 1e6:.1f} MB f32")
        del pm
        params_cpu = PackedModel.load(qwen_dir).decode()
        paths["oneshot"] = timed("oneshot", main_path, card, sh, dev,
                                 qwen_dir, params_cpu)
        paths["uint8_oneshot"] = timed(
            "uint8_oneshot", main_path, card, sh, dev, qwen_dir, params_cpu,
            layout="uint8", kernels=UINT8_ONESHOT_KERNELS,
            reuse=paths["oneshot"], profile=False)
        paths["dense_engine"] = timed("dense_engine", engine_path, card, sh,
                                      dev, qwen_dir, params_cpu)
        paths["quant_engine"] = timed("quant_engine", quant_engine_path,
                                      card, sh, dev, qwen_dir, params_cpu)
        del params_cpu
        ds = timed("deepseek", deepseek_paths, card, dev, ds_dir, sh_ds)
        paths["deepseek_oneshot"] = ds["oneshot"]
        paths["deepseek_engine"] = ds["dense"]
        paths["deepseek_quant_engine"] = ds["quant"]

    kernels = []
    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.6f} ms"

    for r in results:
        also = r.get("prefill")
        also = (also if isinstance(also, list) else [also]) + [r.get("long")]
        for label, t in [(r["name"], r)] + [("  same kernel", a)
                                            for a in also]:
            if t is None:
                continue
            if t["library_ms"] is not None:
                beside = f"library {fmt(t['library_ms'])}"
                dev_beside = f"library {fmt(t['device_library_ms'])}"
            elif "dense_ms" in t:
                beside = (f"library none; dense kernel at the same shape "
                          f"{fmt(t['dense_ms'])}")
                dev_beside = f"dense {fmt(t['device_dense_ms'])}"
            else:
                beside = dev_beside = "library none"
            mirrored = ", ".join(
                f"{key} {fmt(t.get('mirrored_device_' + key))}"
                for key in ("ms", "plain_ms", "library_ms", "dense_ms")
                if t.get("device_" + key) is not None)
            print(f"{label} at {t['shape']} on {card}: {t['ms']:.4f} ms per "
                  f"call (plain {t['plain_ms']:.4f} ms, {beside}); device "
                  f"time {fmt(t['device_ms'])} (plain "
                  f"{fmt(t['device_plain_ms'])}, {dev_beside}; mirrored "
                  f"mean: {mirrored}); bound "
                  f"{t['bound_ms']:.4f} ms by {t['bound_by']}: "
                  f"{t['bound_ms'] / t['ms']:.1%} of the per-call time"
                  + (f"; 3xTF32 tensor-core bound {t['tc_bound_ms']:.4f} ms "
                     f"by {t['tc_bound_by']}" if "tc_bound_ms" in t else ""))
        main = paths[MAIN_PATH_OF.get(r["name"], "dense_engine")]
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{r['name']}.cu",
            "replaces": REPLACES[r["name"]],
            "launches": main["counts"][r["name"]],
            **{f"launches_{p}": res["counts"][r["name"]]
               for p, res in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"],
            "device_plain_ms": r["device_plain_ms"],
            "device_library_ms": r["device_library_ms"],
            **{"mirrored_device_" + key: r.get("mirrored_device_" + key)
               for key in ("ms", "plain_ms", "library_ms")},
            "dense_ms": r.get("dense_ms"),
            **({f"long_{key}": r["long"][key]
                for key in ("shape", "ms", "device_ms", "plain_ms",
                            "library_ms", "device_library_ms", "bound_ms")}
               if "long" in r else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = run()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
