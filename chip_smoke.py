#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one CUDA card

1. Prints the card (``nvidia-smi`` name and power limit) and builds every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, in parallel), printing ``-Xptxas -v`` for each.
2. Per kernel: holds it against its plain PyTorch version on the card at
   small ragged shapes and at the serving path's shapes (the packed
   kernels for K in {2, 4, 16, 256}; the page gather and the paged decode
   attention for several head groupings, head dims, page sizes, softcaps,
   positions and dead slots), and times it (CUDA events) beside the plain
   version, one PyTorch library call as a yardstick, and the least time
   the card could take (the larger of bytes / 3.35 TB/s and FLOPs /
   67 TFLOP/s f32).
3. Builds a random K=16 ``qwen1.5-0.5b`` artifact on the card from a seed
   and saves it.  One-shot path at full width: serves it through
   ``repro_torch.launch.serve --packed DIR --no-engine --batch 4
   --prompt-len 128 --gen-len 16`` with the launch counters zeroed just
   before, checks that every kernel of that path ran, and re-runs the same
   steps with the plain versions (the CPU route) teacher-forced on the
   served tokens, comparing the logits at every step; then profiles a
   prefill and 4 decode steps.
4. Engine path at full width: serves the same artifact through the
   launcher's default engine mode (``--requests 8 --slots 4 --prompt-len
   128 --gen-len 16 --vary-gen --page-size 16``) with the counters zeroed
   just before, checks that all six kernels ran, then again on an
   oversubscribed pool (``--pages 25``) that must stall; every finished
   stream is teacher-forced through the plain route on the CPU and each
   engine token must be its argmax or a near tie.  Then profiles an
   engine prefill step and 4 engine decode steps.
5. Prints one JSON line of per-kernel results, the card line, and last
   ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
   before that line; so does a machine without a CUDA device.
"""
from __future__ import annotations

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
    total = sum(_device_ms(e) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / iters if total > 0 else None


def time_all(kernel, plain, library, plain_iters: int = 30) -> dict:
    """Event times (per call, launches back to back) and device times of a
    kernel wrapper, its plain version and the library yardstick."""
    out = {}
    for key, fn, iters in (("ms", kernel, 30),
                           ("plain_ms", plain, plain_iters),
                           ("library_ms", library, 30)):
        out[key] = cuda_ms(fn, iters=iters)
        out["device_" + key] = device_ms(fn, iters=min(iters, 20))
    return out


def copies_for(nbytes: int) -> int:
    """Operand copies to cycle through so repeated launches read device
    memory, not L2, as the serving path does (its weights far exceed L2)."""
    return max(1, min(64, -(-2 * L2_BYTES // max(nbytes, 1))))


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


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
    from repro_torch.kernels.codebook_matmul_packed import \
        codebook_matmul_packed
    print("codebook_matmul_packed:")
    shapes = [(3, 37, 70), (33, 100, 130)]
    m_decode, m_prefill = sh.batch, sh.batch * sh.block
    for m in (m_decode, m_prefill):
        shapes += [(m, kd, n) for kd, n in sh.proj]
    errs = {}
    for k in KS:
        for (m, kd, n) in shapes:
            cb, idx = rand_operands(gen, k, kd, n, dev)
            pidx = packed_words(idx, k, "kd")
            x = torch.randn(m, kd, generator=gen, device=dev)
            got = codebook_matmul_packed(x, pidx, cb)
            torch.cuda.synchronize()
            errs[(k, m, kd, n)] = compare(
                f"K={k} M={m} Kd={kd} N={n}", got,
                ref.packed_codebook_matmul_ref(x, pidx, cb))
    timings = {}
    kd, n = sh.proj[1]                       # w_in / w_gate
    for m in (m_decode, m_prefill):
        cb, idx = rand_operands(gen, K_MAIN, kd, n, dev)
        pidx = packed_words(idx, K_MAIN, "kd")
        x = torch.randn(m, kd, generator=gen, device=dev)
        nc = copies_for(pidx.numel() * 4)
        pw = [pidx.view(torch.int32).clone().view(torch.uint32)
              for _ in range(nc)]
        wd = [cb[idx] for _ in range(copies_for(kd * n * 4))]
        it = iter(range(10 ** 9))
        times = time_all(
            lambda: codebook_matmul_packed(x, pw[next(it) % nc], cb),
            lambda: ref.packed_codebook_matmul_ref(x, pw[next(it) % nc], cb),
            lambda: torch.matmul(x, wd[next(it) % len(wd)]))
        b_ms, b_by = bound(m * kd * 4 + pidx.numel() * 4 + K_MAIN * 4
                           + m * n * 4, 2 * m * kd * n)
        timings[m] = dict(shape=f"M={m} Kd={kd} N={n} K={K_MAIN}",
                          max_abs_err=errs[(K_MAIN, m, kd, n)],
                          bound_ms=b_ms, bound_by=b_by, **times)
        print(f"  timing {timings[m]}")
    return dict(name="codebook_matmul_packed", **timings[m_decode],
                prefill=timings[m_prefill])


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
    from repro_torch.kernels import ref
    from repro_torch.kernels.blockwise_prefill import blockwise_prefill
    print("blockwise_prefill:")

    def case(b, c, h, kv, hd, s, start, window=None, softcap=None,
             tile=64):
        q = torch.randn(b, c, h, hd, generator=gen, device=dev)
        k = torch.randn(b, s, kv, hd, generator=gen, device=dev)
        v = torch.randn(b, s, kv, hd, generator=gen, device=dev)
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
    }
    for start in range(0, sh.prompt_len, sh.block):
        cases[f"serving block at {start}"] = (
            sh.batch, sh.block, sh.h, sh.kv, sh.hd, start + sh.block, start)
    err = None
    for label, args in cases.items():
        q, k, v, qp, kp, kw = case(*args)
        got = blockwise_prefill(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        err = compare(label, got, ref.blockwise_prefill_ref(q, k, v, qp, kp,
                                                            **kw))
    # timing at the serving path's last prompt block
    q, k, v, qp, kp, kw = case(*cases[f"serving block at {start}"])
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = kp[None, :] <= qp[:, None]
    times = time_all(
        lambda: blockwise_prefill(q, k, v, qp, kp, **kw),
        lambda: ref.blockwise_prefill_ref(q, k, v, qp, kp, **kw),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=kw["scale"]))
    b, c, h, hd = q.shape
    vd = v.shape[-1]
    visible = int(mask.sum().item())        # (query, key) pairs the data needs
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + b * c * h * vd
                  + qp.numel() + kp.numel())
    b_ms, b_by = bound(nbytes, 2 * b * h * visible * (hd + vd))
    return dict(name="blockwise_prefill",
                shape=f"B={b} C={c} H={h} KV={sh.kv} hd={hd} "
                      f"S={k.shape[1]} tile={kw['token_tile']}",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)


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


def check_paged_attention(gen, dev, sh: Shapes) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    print(f"paged_attention (alive slots within rel {REL_TOL:g}, dead slots "
          f"exactly 0):")

    def case(label, q, kp, vp, table, pos, alive, softcap=None):
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
    pos_l = [sh.prompt_len + i * (sh.gen_len - 1) // 3
             for i in range(sh.batch)]
    err = case(f"serving shape, pos {pos_l}", *ops, pos_l,
               [True] * sh.batch)
    # timing at the serving decode shape, pools cycled past L2
    q, kp, vp, table = ops
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
    cap = sh.npg * sh.page
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
    return dict(name="paged_attention",
                shape=f"q [{sh.batch},1,{sh.h},{sh.hd}] pools "
                      f"[{sh.n_phys},{sh.page},{sh.kv},{sh.hd}] npg={sh.npg} "
                      f"pos {pos_l}",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)


# ---------------------------------------------------------------------------
# Main-path phase
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    """(reference keystr path, tensor) pairs of a params tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}['{k}']")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def build_artifact(cfg, k: int, seed: int, directory: str, dev):
    """Random K-entry artifact of ``cfg``, built on the card: per eligible
    leaf (per layer group for stacked leaves) the codebook is the K
    quantiles of a fixed random subsample and the assignment is a
    bucketize against the codebook midpoints.  Smoke scaffolding, not the
    LC algorithm (``CompressionPlan`` is ROADMAP.md module 13)."""
    from repro_torch.core.compression import (DEFAULT_EXCLUDE, PackedLeaf,
                                              PackedModel, pack_indices)
    from repro_torch.models.transformer import init_params
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, device=dev)
    levels = (torch.arange(k, device=dev, dtype=torch.float32) + 0.5) / k
    packed, dense, entries = {}, {}, 0
    for path, leaf in _flatten(params):
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
            words.append(pack_indices(idx.to(torch.uint8).cpu().numpy(),
                                      k)[0])
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


def plain_teacher_forced(directory: str, cfg, prompts: np.ndarray,
                         tokens: np.ndarray) -> torch.Tensor:
    """The same serve steps through the plain versions (the CPU route of
    every kernel), feeding the served tokens: per-step logits [B, G, V]."""
    from repro_torch.core.compression import PackedModel
    from repro_torch.engine.oneshot import grow_caches
    from repro_torch.models.transformer import decode_step, prefill
    params = PackedModel.load(directory).serving_params(packed=True)
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


def check_launched(path: str, counts: dict, names) -> None:
    print(f"launches during the {path}: {counts}")
    missing = [n for n in names if counts[n] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the {path}: "
                           f"{missing}")


def main_path(card: str, sh: Shapes, dev, directory: str,
              arch_args=()) -> dict:
    """The one-shot path (``--no-engine``) at full width (``arch_args``,
    e.g. ``("--reduced",)``, serve another size of the config)."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    cfg, batch = sh.cfg, sh.batch
    prompt_len, gen_len = sh.prompt_len, sh.gen_len
    argv = ["--packed", directory, "--no-engine", "--batch", str(batch),
            "--prompt-len", str(prompt_len), "--gen-len", str(gen_len),
            "--device", str(dev), *arch_args]
    dispatch.reset_launch_counts()
    res = serve.main(argv)
    counts = dispatch.launch_counts()
    check_launched("one-shot serve", counts,
                   ("quantized_gather", "codebook_matmul_packed",
                    "codebook_matmul_packed_t", "blockwise_prefill"))
    tokens, logits = res["tokens"], res["logits"].cpu()
    if tokens.shape != (batch, gen_len) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab:
        raise SmokeFailure(f"bad served tokens {tokens}")
    if logits.shape != (batch, gen_len, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise SmokeFailure("served logits have the wrong shape or are "
                           "not finite")
    print(f"served on {card}: prefill {res['prefill_ms']:.3f} ms, "
          f"decode {res['decode_ms_per_step']:.3f} ms/step, "
          f"{res['decode_tokens_per_s']:.1f} decode tokens/s, "
          f"{res['tokens_per_s']:.1f} tokens/s end to end")
    t1 = time.perf_counter()
    plain = plain_teacher_forced(directory, cfg, res["prompts"], tokens)
    print(f"plain teacher-forced run (CPU route) took "
          f"{time.perf_counter() - t1:.1f} s")
    profile_serve(directory, sh, dev, card)
    compare("serving logits, every step", logits, plain,
            rel_tol=LOGIT_REL_TOL)
    agree = (plain.argmax(-1).numpy() == tokens).mean()
    print(f"  greedy tokens agree with the plain route's argmax at "
          f"{agree:.3f} of steps")
    return dict(res, counts=counts)


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


def engine_path(card: str, sh: Shapes, dev, directory: str,
                arch_args=()) -> dict:
    """The engine path (the launcher's default mode) at full width: a
    pool with room for every slot, then an oversubscribed one."""
    from repro_torch.core.compression import PackedModel
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    cfg = sh.cfg
    n_req = 2 * sh.batch
    base = ["--packed", directory, "--requests", str(n_req), "--slots",
            str(sh.batch), "--prompt-len", str(sh.prompt_len), "--gen-len",
            str(sh.gen_len), "--vary-gen", "--page-size", str(sh.page),
            "--device", str(dev), *arch_args]
    params_cpu = PackedModel.load(directory).decode()
    done: dict = {}

    def serve_once(extra):
        res = serve.main(base + extra)
        bad = {r: v.outcome.value for r, v in res["results"].items()
               if not v.ok}
        if bad or sorted(res["outputs"]) != list(range(n_req)):
            raise SmokeFailure(f"engine requests not all finished: {bad}")
        for rid, toks in res["outputs"].items():
            want = res["requests"][rid].max_new_tokens
            if len(toks) != want or toks.min() < 0 or toks.max() >= cfg.vocab:
                raise SmokeFailure(f"engine request {rid}: bad stream {toks}")
        eng = res["engine"]
        st = eng.stats
        if st.generated_tokens != st.decode_tokens + st.prefill_samples:
            raise SmokeFailure("EngineStats identity broken")
        s = res["stats"]
        print(f"engine on {card} ({' '.join(extra) or 'default pool'}, "
              f"{eng.pool.n_pages} pages): prefill "
              f"{s['prefill_ms_per_block']:.3f} ms/block (median of "
              f"{len(st.prefill_block_s)}), decode "
              f"{s['decode_ms_per_step']:.3f} ms/step (median of "
              f"{len(st.decode_step_s)}), {s['tokens_per_s']:.1f} tokens/s, "
              f"slot occupancy {s['slot_occupancy']:.3f}, page utilisation "
              f"{s['page_utilization']:.3f} (peak "
              f"{s['page_utilization_max']:.3f}), {s['stall_events']} stalls, "
              f"{s['preemptions']} preemptions, {s['steps']} steps, "
              f"{s['wall_s']:.3f} s")
        return res

    dispatch.reset_launch_counts()
    res = serve_once([])
    counts = dispatch.launch_counts()
    check_launched("engine serve", counts, dispatch.KERNELS)
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


REPLACES = {
    "quantized_gather": "src/repro/kernels/quantized_gather.py:42",
    "codebook_matmul_packed": "src/repro/kernels/codebook_matmul_packed.py:57",
    "codebook_matmul_packed_t":
        "src/repro/kernels/codebook_matmul_packed_t.py:68",
    "blockwise_prefill": "src/repro/kernels/blockwise_prefill.py:132",
    "page_gather": "src/repro/kernels/paged_attention.py:472",
    "paged_attention": "src/repro/kernels/paged_attention.py:173",
}


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
    from repro_torch.models.transformer import DEFAULT_PREFILL_BLOCK
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sh = Shapes(get_config("qwen1.5-0.5b"), batch=4, prompt_len=128,
                gen_len=16, block=DEFAULT_PREFILL_BLOCK)
    results = [check(gen, dev, sh) for check in
               (check_gather, check_matmul, check_matmul_t, check_prefill,
                check_page_gather, check_paged_attention)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pm = build_artifact(sh.cfg, K_MAIN, seed=0, directory=tmp, dev=dev)
        s = pm.summary()
        print(f"artifact: {len(pm.packed)} packed leaves, "
              f"{s['packed_bytes'] / 1e6:.1f} MB packed vs "
              f"{s['ref_bytes'] / 1e6:.1f} MB f32, built and saved in "
              f"{time.perf_counter() - t0:.1f} s")
        main = main_path(card, sh, dev, tmp)
        engine = engine_path(card, sh, dev, tmp)

    kernels = []
    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    for r in results:
        for label, t in ((r["name"], r), ("  same kernel", r.get("prefill"))):
            if t is None:
                continue
            print(f"{label} at {t['shape']} on {card}: {t['ms']:.4f} ms per "
                  f"call (plain {t['plain_ms']:.4f} ms, library "
                  f"{t['library_ms']:.4f} ms); device time "
                  f"{fmt(t['device_ms'])} (plain {fmt(t['device_plain_ms'])}, "
                  f"library {fmt(t['device_library_ms'])}); bound "
                  f"{t['bound_ms']:.4f} ms by {t['bound_by']}: "
                  f"{t['bound_ms'] / t['ms']:.1%} of the per-call time")
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{r['name']}.cu",
            "replaces": REPLACES[r["name"]],
            "launches": engine["counts"][r["name"]],
            "launches_oneshot": main["counts"][r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
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
