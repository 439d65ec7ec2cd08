"""Mixture-of-Experts with sort-based capacity dispatch (port of the local
path of ``repro/models/moe.py``).

Per layer and step: router logits [T, E] → the top-k experts of each token
(softmax probabilities over the top k, renormalised); per batch row the
(token, slot) pairs are sorted by expert and placed into an [E, C, D]
dispatch buffer (capacity C per expert, overflow dropped); a gated FFN per
expert; the outputs combined back with the router probabilities.

Routing is a discontinuity: two devices whose f32 logits differ by an ulp
may pick different experts for a token at a near tie.  It is therefore one
module-level function, :func:`route`, which a caller can wrap to record a
serve's routes and replay them elsewhere.

Bits, on every device: ``lax.top_k`` breaks ties toward the lower index,
so the top k is a stable descending sort, sliced.  The combine adds each
token's k contributions one after another in ascending expert order, the
order of the reference's scatter-add on the CPU (XLA adds the sorted
updates sequentially); ``index_add_`` on CUDA adds with float atomics in
no fixed order, so it is not used for sums.  The dispatch writes have
unique destinations, so their order does not matter.

The expert stacks are fetched through ``qleaf.qweight`` (a dense temporary
when they serve quantized) and multiplied with ``torch.einsum``, as the
reference leaves them to XLA outside any Pallas kernel.  The router stays
f32 and unquantized.  Not ported: the expert-parallel ``shard_map`` path
(ROADMAP.md module 14).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers import act_fn, init_normal
from repro_torch.models.qleaf import has_leaf, qmatmul, qweight


def init_moe(generator: torch.Generator, d_model: int, d_ff_expert: int,
             n_experts: int, n_shared: int, act: str, dtype=torch.float32,
             device=None) -> dict:
    """Random MoE params in the reference's layout and scales (the numbers
    differ from the reference's for one seed)."""
    del act
    s_in = d_model ** -0.5
    s_out = d_ff_expert ** -0.5
    p = {
        "router_w": init_normal(generator, (d_model, n_experts), s_in,
                                torch.float32, device),
        "experts_w_in": init_normal(
            generator, (n_experts, d_model, d_ff_expert), s_in, dtype,
            device),
        "experts_w_gate": init_normal(
            generator, (n_experts, d_model, d_ff_expert), s_in, dtype,
            device),
        "experts_w_out": init_normal(
            generator, (n_experts, d_ff_expert, d_model), s_out, dtype,
            device),
    }
    if n_shared > 0:
        dsh = n_shared * d_ff_expert
        p["shared_w_in"] = init_normal(generator, (d_model, dsh), s_in, dtype,
                                       device)
        p["shared_w_gate"] = init_normal(generator, (d_model, dsh), s_in,
                                         dtype, device)
        p["shared_w_out"] = init_normal(generator, (dsh, d_model),
                                        dsh ** -0.5, dtype, device)
    return p


def router_probs(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """Softmax of the f32 router logits: x [..., D] → [..., E]."""
    return torch.softmax(x.float() @ router_w.float(), dim=-1)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest values, descending, ties toward the
    lower index (a stable descending sort, sliced)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router_w: torch.Tensor,
          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (gates [B, S, k] f32, expert ids [B, S, k] int64): the
    top-k router probabilities, renormalised to sum to 1."""
    gates, eidx = top_k(router_probs(x, router_w), k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, eidx


def capacity_of(s: int, top_k: int, capacity_factor: float, e: int) -> int:
    """Per-expert capacity of one batch row of ``s`` tokens, computed as
    the reference does (Python float, then ``int``)."""
    return max(1, int(s * top_k * capacity_factor / e))


def _dispatch_row(xt: torch.Tensor, eidx: torch.Tensor, gates: torch.Tensor,
                  e: int, c: int, top_k: int):
    """Route one batch row's tokens: xt [S, D], eidx / gates [S, k] →
    (ex_in [E, C, D], dst [S·k], keep [S·k], stok [S·k], sgate [S·k]),
    the (token, slot) pairs in ascending expert order."""
    s, d = xt.shape
    dev = xt.device
    flat_e = eidx.reshape(-1)
    flat_tok = torch.arange(s, device=dev).repeat_interleave(top_k)
    se, order = torch.sort(flat_e, stable=True)
    stok, sgate = flat_tok[order], gates.reshape(-1)[order]
    group_start = torch.searchsorted(se, torch.arange(e, device=dev))
    pos_in_group = torch.arange(se.numel(), device=dev) - group_start[se]
    keep = pos_in_group < c
    dst = torch.where(keep, se * c + pos_in_group, e * c)
    buf = torch.zeros(e * c, d, dtype=xt.dtype, device=dev)
    buf.index_add_(0, dst[keep], xt[stok[keep]])     # unique destinations
    return buf.reshape(e, c, d), dst, keep, stok, sgate


def _combine_row(ex_out: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
                 stok: torch.Tensor, sgate: torch.Tensor, s: int,
                 top_k: int) -> torch.Tensor:
    """ex_out [E, C, D] → [S, D]: each token's kept expert outputs, scaled
    by their gates, added from 0 one after another in ascending expert
    order (dropped pairs add an exact 0)."""
    e, c, d = ex_out.shape
    gathered = ex_out.reshape(e * c, d)[torch.clamp(dst, max=e * c - 1)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    contrib = gathered * sgate[:, None].to(gathered.dtype)      # [S·k, D]
    # the pairs are sorted by expert, then by token: a stable sort by token
    # lists each token's k pairs in ascending expert order
    by_tok = torch.sort(stok, stable=True)[1]
    contrib = contrib[by_tok].reshape(s, top_k, d)
    out = torch.zeros(s, d, dtype=contrib.dtype, device=contrib.device)
    for j in range(top_k):
        out = out + contrib[:, j]
    return out


def apply_moe(p, x: torch.Tensor, *, top_k: int, act: str = "silu",
              capacity_factor: float = 1.25,
              capacity: Optional[int] = None) -> torch.Tensor:
    """x [B, S, D] → [B, S, D].  Routing, capacity and the dispatch /
    combine stay inside each batch row, as in the reference."""
    b, s, d = x.shape
    f = act_fn(act)
    w_in = qweight(p, "experts_w_in")
    w_gate = qweight(p, "experts_w_gate")
    w_out = qweight(p, "experts_w_out")
    e = w_in.shape[0]
    gates, eidx = route(x, p["router_w"], top_k)
    c = capacity if capacity is not None else capacity_of(
        s, top_k, capacity_factor, e)
    rows = [_dispatch_row(x[i], eidx[i], gates[i], e, c, top_k)
            for i in range(b)]
    ex_in = torch.stack([r[0] for r in rows])                   # [B,E,C,D]
    h = torch.einsum("becd,edf->becf", ex_in, w_in)
    g = torch.einsum("becd,edf->becf", ex_in, w_gate)
    ex_out = torch.einsum("becf,efd->becd", f(g) * h, w_out)
    out = torch.stack([_combine_row(ex_out[i], *rows[i][1:], s, top_k)
                       for i in range(b)])
    if has_leaf(p, "shared_w_in"):
        hs = f(qmatmul(p, "shared_w_gate", x)) * qmatmul(p, "shared_w_in", x)
        out = out + qmatmul(p, "shared_w_out", hs)
    return out.to(x.dtype)
