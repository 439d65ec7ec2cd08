"""Serving launcher of the port (``repro.launch.serve``): a thin client of
the continuous-batching engine, or the one-shot loop with ``--no-engine``.

    PYTHONPATH=src python -m repro_torch.launch.serve --packed DIR \\
        --requests 8 --slots 4 --prompt-len 128 --gen-len 16 --vary-gen

By default requests flow through ``repro_torch.engine.Engine``: a request
queue feeding a fixed set of batch slots, a paged KV cache (fixed-size
pages + per-slot page table, finished requests' pages reused at once),
blockwise prefill mixed with decode under a per-step token budget, and
greedy sampling.  The pages are dense, or with ``--kv-bits {2,4,8}``
codebook-quantized (bit-packed indices + per-page codebooks, one per page
or with ``--kv-cb head`` one per kv head), read by the quantized
blockwise-prefill and paged-attention kernels.  ``--no-engine`` runs the
one-shot lockstep loop (``repro_torch.engine.oneshot``, the engine's
oracle) over ``--batch`` prompts; it keeps dense KV and refuses
``--kv-bits``.

``--packed DIR`` serves a PackedModel artifact (the reference's npz +
``manifest.json`` format): with ``--serve-layout packed`` every quantized
leaf stays bit-packed on the device and runs through the CUDA kernels
(embedding gather, every projection, the tied LM head; prefill attention
through the page gather and the blockwise-prefill kernel; decode attention
through the paged-attention kernel).  Without ``--packed`` the model is
dense with random weights from a seed.  It runs on the card unless
``--device cpu`` is given; with no card it stops with an error.

The reference's flags whose path is not ported yet are accepted by name
and refused with the ROADMAP.md module that will port them.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.core.compression import ArtifactError, PackedModel
from repro_torch.engine import Engine, Request, greedy_generate
from repro_torch.kernels import build
from repro_torch.models.transformer import init_params

MLP_LEAVES = ("w_in", "w_gate", "w_out")

# flag (argparse dest) → the ROADMAP.md module that ports its path; the
# flag is refused unless left at its default
_NOT_PORTED = {
    "mesh": "module 14 (distributed)",
    "host_devices": "module 14 (distributed)",
    "ckpt_dir": "module 13 (LC training and its checkpoints)",
    "temperature": "module 9 (sampling beyond greedy)",
    "top_k": "module 9 (sampling beyond greedy)",
    "snapshot_dir": "module 10 (fault tolerance)",
    "snapshot_every": "module 10 (fault tolerance)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="one-shot batch size / engine slot count alias")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--packed", default=None,
                    help="PackedModel artifact dir: serve quantized")
    ap.add_argument("--serve-layout", default="packed",
                    choices=("packed", "uint8"),
                    help="bit-packed uint32 words or uint8 indices "
                         "(uint8 runs on the CPU only until its kernel is "
                         "ported)")
    ap.add_argument("--serve-leaves", default="all", choices=("all", "mlp"))
    ap.add_argument("--no-engine", action="store_true",
                    help="one-shot lockstep loop (the engine's oracle)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--host-devices", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--requests", type=int, default=None,
                    help="number of requests (default: --batch)")
    ap.add_argument("--slots", type=int, default=None,
                    help="engine batch slots (default: --batch)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens")
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size (default: slots × max pages)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-step token budget (decode + blockwise "
                         "prefill)")
    ap.add_argument("--vary-gen", action="store_true",
                    help="stagger request gen lengths (engine mode)")
    ap.add_argument("--kv-bits", type=int, default=0, choices=(0, 2, 4, 8),
                    help="codebook-quantize the engine's KV pages to this "
                         "many bits (0 = dense pages)")
    ap.add_argument("--kv-cb", default=None, choices=("page", "head"),
                    help="KV codebook grouping: one per page (the default) "
                         "or one per (page, kv head)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds --vary-gen's lengths and the requests")
    ap.add_argument("--deadline", type=int, default=None,
                    help="per-request deadline in engine steps "
                         "(DEADLINE_EXCEEDED past it)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound the request queue; submissions beyond it "
                         "get REJECTED_BACKPRESSURE")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=None)
    return ap


def _refuse_unported(ap: argparse.ArgumentParser, args) -> None:
    for dest, item in _NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            ap.error(f"{flag} is not ported yet (ROADMAP.md {item})")
    if args.no_engine and (args.kv_bits or args.kv_cb is not None):
        ap.error("--kv-bits / --kv-cb quantize the engine's KV pages "
                 "(ROADMAP.md module 7); the one-shot oracle (--no-engine) "
                 "keeps dense KV")


def _load_params(args, cfg, device):
    if args.packed is None:
        gen = torch.Generator(device=device).manual_seed(0)
        return init_params(cfg, gen, device=device)
    try:
        packed = PackedModel.load(args.packed)
    except ArtifactError as e:
        sys.exit(f"refusing to serve {args.packed}: {e}")
    quant_names = None if args.serve_leaves == "all" else MLP_LEAVES
    params = packed.serving_params(quant_names=quant_names,
                                   packed=args.serve_layout == "packed",
                                   device=device)
    s = packed.summary()
    cov = packed.leaf_coverage()
    n_q = sum(r["quantized"] for r in cov)
    idx_bytes = (s["bits_per_weight"] / 8
                 if args.serve_layout == "packed" else 1.0)
    print(f"serving packed artifact: {s['scheme']} "
          f"({s['bits_per_weight']} bit/weight, x{s['ratio']:.1f}, "
          f"{args.serve_layout} layout: {idx_bytes:g} B/weight index "
          f"traffic; {args.serve_leaves} leaves — {n_q}/{len(cov)} param "
          f"paths quantized)")
    return params


def _where(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _serve_oneshot(args, cfg, params, device) -> dict:
    n_b = args.batch
    prompts = np.random.RandomState(7).randint(
        0, cfg.vocab, size=(n_b, args.prompt_len))
    prompts_t = torch.from_numpy(prompts).to(device)
    stats: dict = {}
    tokens, logits = greedy_generate(params, cfg, prompts_t, args.gen_len,
                                     collect_logits=True, stats=stats)
    tokens = tokens.cpu().numpy()
    for r in range(n_b):
        print(f"req{r}: {tokens[r]}")

    where = _where(device)
    decode_s = stats["decode_s"]
    step_ms = 1e3 * float(np.median(decode_s)) if decode_s else float("nan")
    total_s = stats["prefill_s"] + sum(decode_s)
    result = {
        "device": where,
        "prompts": prompts,
        "tokens": tokens,
        "logits": logits,
        "prefill_ms": 1e3 * stats["prefill_s"],
        "decode_ms_per_step": step_ms,
        "decode_tokens_per_s": 1e3 * n_b / step_ms if decode_s else None,
        "tokens_per_s": n_b * args.gen_len / total_s,
    }
    print(f"one-shot serve on {where}: batch {n_b}, prompt "
          f"{args.prompt_len}, gen {args.gen_len} | prefill "
          f"{result['prefill_ms']:.3f} ms | decode "
          f"{step_ms:.3f} ms/step (median of {len(decode_s)}) | "
          f"{result['tokens_per_s']:.1f} tokens/s end to end")
    return result


def _serve_engine(args, cfg, params, device) -> dict:
    n_req = args.requests if args.requests is not None else args.batch
    n_slots = args.slots if args.slots is not None else args.batch
    prompts = np.random.RandomState(7).randint(
        0, cfg.vocab, size=(n_req, args.prompt_len))
    rng = np.random.RandomState(args.seed)
    reqs = []
    for r in range(n_req):
        gen_len = (int(rng.randint(max(args.gen_len // 4, 1),
                                   args.gen_len + 1))
                   if args.vary_gen else args.gen_len)
        reqs.append(Request(rid=r, prompt=prompts[r], max_new_tokens=gen_len,
                            seed=args.seed + r,
                            deadline_steps=args.deadline))
    eng = Engine(params, cfg, n_slots=n_slots, page_size=args.page_size,
                 max_seq=args.prompt_len + args.gen_len, n_pages=args.pages,
                 token_budget=args.token_budget,
                 queue_limit=args.queue_limit, kv_bits=args.kv_bits,
                 kv_cb_mode=args.kv_cb or "page")
    outs = eng.run(reqs)
    for r in sorted(eng.results):
        res = eng.results[r]
        if res.ok:
            print(f"req{r}: {res.tokens}")
        else:
            print(f"req{r}: {res.outcome.value} ({res.detail}; "
                  f"{res.tokens.size} partial tokens)")
    n_bad = sum(not res.ok for res in eng.results.values())
    if n_bad:
        print(f"outcomes: {len(eng.results) - n_bad}/{len(eng.results)} "
              f"finished")
    s = eng.stats.summary()
    where = _where(device)
    kv = (f"kv {args.kv_bits}-bit {eng.kv_cb_mode} codebooks"
          if args.kv_bits else "dense kv")
    print(f"engine on {where}: {n_req} requests through {n_slots} slots "
          f"({kv}), {s['delivered_tokens']} tokens in {s['steps']} steps "
          f"({s['tokens_per_s']:.1f} tokens/s, prefill "
          f"{s['prefill_ms_per_block']:.3f} ms/block, decode "
          f"{s['decode_ms_per_step']:.3f} ms/step, occupancy "
          f"{s['slot_occupancy']:.2f}, page util "
          f"{s['page_utilization']:.2f} peak "
          f"{s['page_utilization_max']:.2f}, {s['stall_events']} stalls, "
          f"{s['preemptions']} preemptions)")
    return {
        "device": where,
        "prompts": prompts,
        "requests": reqs,
        "outputs": outs,
        "results": eng.results,
        "stats": s,
        "engine": eng,
        "prefill_ms_per_block": s["prefill_ms_per_block"],
        "decode_ms_per_step": s["decode_ms_per_step"],
        "tokens_per_s": s["tokens_per_s"],
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Serve through the engine (default) or the one-shot loop
    (``--no-engine``).  Engine mode returns the prompts, the requests,
    the finished streams, every typed result, the stats summary and the
    engine; one-shot mode the prompts, the tokens, the per-step logits
    [B, gen_len, V] (on the device) and the timings."""
    ap = build_parser()
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)
    device = torch.device(args.device)
    if device.type == "cuda" and args.serve_layout == "uint8":
        ap.error("--serve-layout uint8 has no CUDA kernel yet (ROADMAP.md "
                 "section 2, kernel row 11); it runs with --device cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device is visible: this launcher runs on the card "
                 "(pass --device cpu for the plain CPU versions)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if device.type == "cuda":
        build.build()
    params = _load_params(args, cfg, device)
    if args.no_engine:
        return _serve_oneshot(args, cfg, params, device)
    return _serve_engine(args, cfg, params, device)


if __name__ == "__main__":
    main()
