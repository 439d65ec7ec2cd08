"""The launch plans and the ordered merge behind kernel rows 6 and 8
(``csrc/paged_attention.cu``, ``csrc/mla_paged_attention.cu``, their split
and merge in ``csrc/split_decode.cuh``), held on the CPU without JAX and
without a compiler.

- The plans: every logical page lies in exactly one split, in order; no
  split is empty; the split count fits a portable cluster; the plans read
  the shapes alone, never ``pos``.
- A torch emulation of the kernels' arithmetic, per split an online softmax
  over tiles of visible rows, then the splits' (m, l, acc) merged in order,
  equals the plain versions in ``kernels/ref.py``; NaN written into every
  pool row past ``pos`` never reaches the output.
- A split that holds no visible row leaves the merged bits exactly as they
  are without it, and a dead slot merges to exactly 0.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import mla_paged_attention as mpa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

NEG_INF = -1e30
SMS = 132          # the H100's SMs
GQA_TILE = 32      # logical rows of a row 6 tile (hd <= 128)
MLA_TILE = 16      # of a row 8 tile


def _ranges(npg, splits, pages):
    return [range(s * pages, min(npg, (s + 1) * pages))
            for s in range(splits)]


@pytest.mark.parametrize("npg", [1, 2, 7, 8, 9, 17, 64, 255, 256, 1000])
@pytest.mark.parametrize("b,kv,rep", [(1, 1, 1), (4, 16, 1), (5, 2, 4),
                                      (3, 2, 5), (32, 8, 2)])
def test_gqa_plan_covers_every_page_once(npg, b, kv, rep):
    p = pa.plan(b, kv, rep, npg, SMS)
    ranges = _ranges(npg, p.splits, p.pages)
    assert [j for r in ranges for j in r] == list(range(npg))
    assert all(len(r) > 0 for r in ranges)
    assert 1 <= p.splits <= pa.MAX_SPLITS and p.splits * p.pages >= npg
    assert p.groups == -(-rep // pa.MAX_REP)
    assert p.blocks == p.splits * b * kv * p.groups


@pytest.mark.parametrize("npg", [1, 2, 7, 9, 17, 256, 1000])
@pytest.mark.parametrize("b,h", [(1, 16), (4, 16), (5, 3), (64, 16)])
def test_mla_plan_covers_every_page_and_head_once(npg, b, h):
    p = mpa.plan(b, h, npg, SMS)
    ranges = _ranges(npg, p.splits, p.pages)
    assert [j for r in ranges for j in r] == list(range(npg))
    assert all(len(r) > 0 for r in ranges)
    assert 1 <= p.splits <= pa.MAX_SPLITS
    heads = [list(range(g * p.heads, min(h, (g + 1) * p.heads)))
             for g in range(p.groups)]
    assert [x for g in heads for x in g] == list(range(h))
    assert all(heads) and p.heads <= mpa.MAX_HEADS
    assert p.blocks == p.splits * p.groups * b


def test_plans_at_the_serving_shapes_read_no_pos():
    # qwen1.5-0.5b engine decode: 4 slots, 16 kv heads, 9 pages of 16
    assert pa.plan(4, 16, 1, 9, SMS) == pa.Plan(5, 2, 1, 320)
    # deepseek-v2-lite engine decode: 4 slots, 16 heads, 9 pages of 16
    assert mpa.plan(4, 16, 9, SMS) == mpa.Plan(5, 2, 4, 4, 80)
    for plan in (pa.plan, mpa.plan):
        assert "pos" not in inspect.signature(plan.__wrapped__).parameters


# --- the emulation ---------------------------------------------------------

def _visible(pos, alive, npg, page):
    return min(npg * page, pos + 1) if alive and pos >= 0 else 0


def _online(state, logits, values):
    """One tile of the online softmax: logits [heads, T], values [T, d]."""
    m, l, acc = state
    m_new = torch.maximum(m, logits.max(1).values)
    c = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[:, None])
    return m_new, l * c + p.sum(1), acc * c[:, None] + p @ values


def _split_states(slot_rows, scores, heads, d, splits, pages, page, n,
                  tile):
    """Per split (m, l, acc) of one slot with n visible rows: tiles of
    `tile` logical rows of the split's pages cut at n; `slot_rows(rows)`
    gathers those rows (and only those), `scores(x)` gives the logits and
    the values of the gathered rows."""
    states = []
    for s in range(splits):
        st = (torch.full((heads,), NEG_INF), torch.zeros(heads),
              torch.zeros(heads, d))
        lo, hi = min(n, s * pages * page), min(n, (s + 1) * pages * page)
        for t0 in range(lo, hi, tile):
            rows = slot_rows(range(t0, min(hi, t0 + tile)))
            st = _online(st, *scores(rows))
        states.append(st)
    return states


def _merge(states):
    """The ordered merge of split_decode.cuh, from +0 in split order."""
    big = states[0][0]
    for m, _, _ in states[1:]:
        big = torch.maximum(big, m)
    big_l = torch.zeros_like(states[0][1])
    big_a = torch.zeros_like(states[0][2])
    for m, l, a in states:
        f = torch.exp(m - big)
        big_l = big_l + l * f
        big_a = big_a + a * f[:, None]
    return big_a / torch.clamp_min(big_l, 1e-30)[:, None]


def _rows_of(pool, table_row, page):
    n_phys = pool.shape[0]

    def rows(idx):
        idx = torch.tensor(list(idx))
        phys = table_row[idx // page].clamp(0, n_phys - 1)
        return pool[phys, idx % page]
    return rows


def _poison_past_pos(pool, table, pos, alive):
    """A copy of the pool with NaN in every row that no slot sees."""
    out = torch.full_like(pool, float("nan"))
    page = pool.shape[1]
    for b in range(table.shape[0]):
        n = _visible(int(pos[b]), bool(alive[b]), table.shape[1], page)
        for s in range(n):
            phys, t = int(table[b, s // page]), s % page
            out[phys, t] = pool[phys, t]
    return out


def emulate_gqa(q, k_pool, v_pool, table, pos, alive, *, scale, softcap,
                plan, tile=GQA_TILE, keep=None):
    """Row 6's arithmetic: per slot and split an online softmax, then the
    ordered merge.  `keep(splits)` picks the states that are merged."""
    b_n, _, h, hd = q.shape
    kv, page, npg = k_pool.shape[2], k_pool.shape[1], table.shape[1]
    rep = h // kv
    out = torch.empty(b_n, 1, h * hd)
    for b in range(b_n):
        n = _visible(int(pos[b]), bool(alive[b]), npg, page)
        krows = _rows_of(k_pool, table[b].long(), page)
        vrows = _rows_of(v_pool, table[b].long(), page)

        def gathered(idx):
            return krows(idx), vrows(idx)

        def scores(kv_rows):
            k, v = kv_rows                            # [T, KV, hd]
            kh = k.repeat_interleave(rep, dim=1)      # [T, H, hd]
            logits = torch.einsum("hd,thd->ht", q[b, 0], kh) * scale
            if softcap:
                logits = softcap * torch.tanh(logits / softcap)
            vh = v.repeat_interleave(rep, dim=1)
            return logits, vh

        # heads are independent: run the softmax per head on its own rows
        res = []
        for hh in range(h):
            def head_scores(kv_rows, hh=hh):
                logits, vh = scores(kv_rows)
                return logits[hh:hh + 1], vh[:, hh]
            states = _split_states(gathered, head_scores, 1, hd,
                                   plan.splits, plan.pages, page, n, tile)
            res.append(_merge(keep(states) if keep else states))
        out[b, 0] = torch.cat(res, 0).reshape(-1)
    return out


def emulate_mla(q_eff, q_rope, c_pool, r_pool, table, pos, alive, *, scale,
                plan, tile=MLA_TILE, keep=None):
    """Row 8's arithmetic: per slot and split (all heads of a block share
    the rows) an online softmax, then the ordered merge."""
    b_n, _, h, lat = q_eff.shape
    page, npg = c_pool.shape[1], table.shape[1]
    out = torch.empty(b_n, 1, h, lat)
    for b in range(b_n):
        n = _visible(int(pos[b]), bool(alive[b]), npg, page)
        crows = _rows_of(c_pool, table[b].long(), page)
        rrows = _rows_of(r_pool, table[b].long(), page)

        def scores(idx):
            c, r = crows(idx), rrows(idx)
            logits = (q_eff[b, 0] @ c.T + q_rope[b, 0] @ r.T) * scale
            return logits, c

        states = _split_states(lambda idx: idx, scores, h, lat, plan.splits,
                               plan.pages, page, n, tile)
        out[b, 0] = _merge(keep(states) if keep else states)
    return out


def _gqa_case(seed, b, kv, rep, hd, page, npg):
    rng = np.random.default_rng(seed)
    n_phys = b * npg + 1

    def t(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(
            np.float32))
    q = t(b, 1, kv * rep, hd, s=3.0)
    kp, vp = t(n_phys, page, kv, hd), t(n_phys, page, kv, hd)
    table = torch.from_numpy(
        (rng.permutation(n_phys - 1)[:b * npg] + 1).reshape(b, npg).astype(
            np.int32))
    return q, kp, vp, table


def _boundary_pos(plan, page, npg):
    """pos at the last row of split 0, the first of split 1, the last row,
    a slot whose rows all lie in split 0, and a dead slot's."""
    cap, edge = npg * page, plan.pages * page
    return ([min(edge - 1, cap - 1), min(edge, cap - 1), cap - 1,
             min(2, cap - 1), 5], [True, True, True, True, False])


def _hold(got, want, alive, rel=1e-5):
    assert torch.isfinite(got).all()
    live = alive.bool()
    scale = want[live].abs().max()
    assert (got[live] - want[live]).abs().max() <= rel * scale
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))


@pytest.mark.parametrize("rep,hd,page,npg,softcap,tile", [
    (1, 8, 4, 9, None, 3), (2, 12, 5, 17, 5.0, 4), (4, 8, 3, 1, None, 2)])
def test_gqa_split_merge_equals_the_plain_version(rep, hd, page, npg,
                                                  softcap, tile):
    b, kv = 5, 2
    q, kp, vp, table = _gqa_case(rep * 100 + npg, b, kv, rep, hd, page, npg)
    plan = pa.plan(b, kv, rep, npg, SMS)
    pos_l, alive_l = _boundary_pos(plan, page, npg)
    pos, alive = torch.tensor(pos_l), torch.tensor(alive_l)
    kw = dict(scale=hd ** -0.5, softcap=softcap)
    got = emulate_gqa(q, _poison_past_pos(kp, table, pos, alive),
                      _poison_past_pos(vp, table, pos, alive), table, pos,
                      alive, plan=plan, tile=tile, **kw)
    _hold(got, ref.paged_attention_ref(q, kp, vp, table, pos, alive, **kw),
          alive)


@pytest.mark.parametrize("h,lat,rd,page,npg,tile", [
    (3, 40, 6, 5, 3, 4), (4, 16, 8, 4, 9, 3), (2, 8, 4, 2, 17, 16)])
def test_mla_split_merge_equals_the_plain_version(h, lat, rd, page, npg,
                                                  tile):
    rng = np.random.default_rng(h * 10 + npg)
    b = 5
    n_phys = b * npg + 1

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q_eff, q_rope = t(b, 1, h, lat), t(b, 1, h, rd)
    c_pool, r_pool = t(n_phys, page, lat), t(n_phys, page, rd)
    table = torch.from_numpy(
        (rng.permutation(n_phys - 1)[:b * npg] + 1).reshape(b, npg).astype(
            np.int32))
    plan = mpa.plan(b, h, npg, SMS)
    pos_l, alive_l = _boundary_pos(plan, page, npg)
    pos, alive = torch.tensor(pos_l), torch.tensor(alive_l)
    scale = (lat + rd) ** -0.5
    got = emulate_mla(q_eff, q_rope,
                      _poison_past_pos(c_pool, table, pos, alive),
                      _poison_past_pos(r_pool, table, pos, alive), table,
                      pos, alive, scale=scale, plan=plan, tile=tile)
    _hold(got, ref.mla_paged_attention_ref(q_eff, q_rope, c_pool, r_pool,
                                           table, pos, alive, scale=scale),
          alive)


def _non_empty(states):
    return [s for s in states if bool((s[0] > NEG_INF).any())]


@pytest.mark.parametrize("pos0", [0, 3, 7])
def test_an_empty_split_leaves_the_merged_bits_as_they_were(pos0):
    """Slot 0's rows all lie in split 0 (pages of 8, 2 pages a split):
    merging the empty splits too gives the same bits as merging split 0
    alone; the dead slot merges to exactly 0 either way."""
    b, kv, rep, hd, page, npg = 2, 2, 2, 8, 8, 9
    q, kp, vp, table = _gqa_case(pos0, b, kv, rep, hd, page, npg)
    plan = pa.plan(b, kv, rep, npg, SMS)
    assert plan.splits > 1
    pos, alive = torch.tensor([pos0, 30]), torch.tensor([True, False])
    kw = dict(scale=0.3, softcap=None, plan=plan, tile=4)
    every = emulate_gqa(q, kp, vp, table, pos, alive, **kw)
    alone = emulate_gqa(q, kp, vp, table, pos, alive,
                        keep=lambda st: _non_empty(st) or st[:1], **kw)
    assert torch.equal(every, alone)
    assert torch.equal(every[1], torch.zeros_like(every[1]))
    # and the same for the MLA merge
    q_eff, q_rope = q[:, :, :3, :8], q[:, :, :3, :4]
    c_pool, r_pool = kp[:, :, 0], vp[:, :, 0, :4].contiguous()
    mplan = mpa.plan(b, 3, npg, SMS)
    kw = dict(scale=0.3, plan=mplan, tile=4)
    every = emulate_mla(q_eff, q_rope, c_pool, r_pool, table, pos, alive,
                        **kw)
    alone = emulate_mla(q_eff, q_rope, c_pool, r_pool, table, pos, alive,
                        keep=lambda st: _non_empty(st) or st[:1], **kw)
    assert torch.equal(every, alone)
    assert torch.equal(every[1], torch.zeros_like(every[1]))
