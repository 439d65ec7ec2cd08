"""The port's paged-KV layer held against the reference on the CPU: the
plain versions of the two paged kernels against the reference's jnp
oracles and its Pallas kernels (interpret mode), the page pool and slot
scheduler decision for decision under one seeded operation sequence, the
KV byte accounting, and the paged write / decode / prefill steps of a GQA
layer.  The ``cuda``-marked kernel-vs-plain tests on the card are in
``tests/test_torch_cuda.py``.

Dead slots: the reference's jnp oracle softmaxes an all-masked row, which
gives uniform weights (the mean of the trash page's V), while its Pallas
kernel divides a zero accumulator by max(l, 1e-30), which gives 0.  The
port's plain version follows the jnp oracle, the spec, on every slot; it
meets the Pallas kernel (and the port's CUDA kernel, which follows the
Pallas kernel) on alive slots only.  The engine discards dead rows.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvquant as jkvquant
from repro.engine import kvcache as jkvcache
from repro.engine import scheduler as jscheduler
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.core import kvquant
from repro_torch.engine import kvcache, sampling, scheduler
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.page_gather import page_gather
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import attention as attn

# The shapes here are tiny: one torch thread per test worker keeps torch's
# thread pool off the cores the reference's JAX tests compile on.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# 4 slots, page 4, 3 logical pages per slot (capacity 12), 9 usable pages.
# pos covers 0, page - 1, page and capacity - 1; slot 2 is dead and its
# stale table row points at live pages.
B, KV, HD, PAGE, NPG = 4, 2, 8, 4, 3
TBL = np.array([[3, 7, 0], [5, 0, 0], [1, 2, 4], [9, 6, 8]], np.int32)
POS = np.array([0, 3, 4, 11], np.int32)
ALIVE = np.array([True, True, False, True])


@functools.lru_cache(maxsize=None)
def _case(rep: int):
    rng = np.random.RandomState(rep)
    kp = rng.randn(B * NPG - 2, PAGE, KV, HD).astype(np.float32)
    vp = rng.randn(B * NPG - 2, PAGE, KV, HD).astype(np.float32)
    q = (3 * rng.randn(B, 1, KV * rep, HD)).astype(np.float32)
    return q, kp, vp


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_page_gather_plain_exact_vs_reference_and_pallas():
    _, kp, _ = _case(1)
    ipool = np.arange(kp.size // HD, dtype=np.int32).reshape(kp.shape[:-1])
    for pool in (kp, ipool):
        want = np.asarray(jref.gather_pages_ref(*_j(pool, TBL, ALIVE)))
        pallas = np.asarray(jops.page_gather(*_j(pool, TBL, ALIVE),
                                             interpret=True))
        got = page_gather(*_t(pool, TBL, ALIVE))
        assert got.dtype == torch.from_numpy(pool).dtype
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), pallas)
        # the dead slot reads the trash page only
        view = got.numpy().reshape((B, NPG, PAGE) + pool.shape[2:])
        np.testing.assert_array_equal(view[2], np.stack([pool[0]] * NPG))
    assert torch.equal(dispatch.page_gather(*_t(kp, TBL, ALIVE)),
                       page_gather(*_t(kp, TBL, ALIVE)))


@pytest.mark.parametrize("rep,softcap", [(1, None), (2, 30.0)])
def test_paged_attention_plain_vs_reference_and_pallas(rep, softcap):
    q, kp, vp = _case(rep)
    kw = dict(softcap=softcap, scale=HD ** -0.5)
    want = np.asarray(jref.paged_attention_ref(
        *_j(q, kp, vp, TBL, POS, ALIVE), **kw))
    pallas = np.asarray(jops.paged_attention(
        *_j(q, kp, vp, TBL, POS, ALIVE), interpret=True, **kw))
    got = paged_attention(*_t(q, kp, vp, TBL, POS, ALIVE), **kw)
    assert tuple(got.shape) == (B, 1, KV * rep * HD)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy()[ALIVE], pallas[ALIVE], **TOL)
    # dead slot: the jnp spec's uniform softmax is the trash page's mean V
    # (the Pallas kernel writes 0 there instead)
    trash_mean = vp[0].mean(axis=0)                       # [KV, HD]
    np.testing.assert_allclose(
        got.numpy()[2, 0].reshape(KV, rep, HD),
        np.repeat(trash_mean[:, None], rep, axis=1), **TOL)
    np.testing.assert_array_equal(pallas[2], 0.0)


@pytest.mark.parametrize("rep,softcap", [(2, None), (1, 30.0)])
def test_paged_attention_plain_vs_reference_more_heads(rep, softcap):
    q, kp, vp = _case(rep)
    kw = dict(softcap=softcap, scale=HD ** -0.5)
    want = np.asarray(jref.paged_attention_ref(
        *_j(q, kp, vp, TBL, POS, ALIVE), **kw))
    got = dispatch.paged_attention(*_t(q, kp, vp, TBL, POS, ALIVE), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paged_wrappers_reject_bad_operands_and_do_not_count_on_cpu():
    q, kp, vp = _case(2)
    dispatch.reset_launch_counts()
    with pytest.raises(ValueError, match="GQA pool"):
        paged_attention(*_t(q, kp, vp[..., :4], TBL, POS, ALIVE), scale=1.0)
    with pytest.raises(ValueError, match="must be"):
        paged_attention(*_t(q, kp, vp, TBL[:2], POS, ALIVE), scale=1.0)
    with pytest.raises(ValueError, match="softcap"):
        paged_attention(*_t(q, kp, vp, TBL, POS, ALIVE), scale=1.0,
                        softcap=0.0)
    with pytest.raises(ValueError, match="alive"):
        page_gather(*_t(kp, TBL, ALIVE[:2]))
    paged_attention(*_t(q, kp, vp, TBL, POS, ALIVE), scale=1.0)
    page_gather(*_t(kp, TBL, ALIVE))
    assert dispatch.launch_counts() == {n: 0 for n in dispatch.KERNELS}


# ---------------------------------------------------------------------------
# Host-side engine state: page pool, scheduler, byte accounting
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (pool.free_pages, pool.used_pages, pool.seized,
            pool.utilization(), pool.version, pool.table.tolist(),
            [pool.pages_of(s) for s in range(pool.n_slots)])


def test_page_pool_decisions_equal_reference_under_random_ops():
    rng = np.random.RandomState(0)
    geo = dict(n_pages=11, page_size=4, n_slots=3, max_pages_per_slot=5)
    port, ref_pool = kvcache.PagePool(**geo), jkvcache.PagePool(**geo)
    ops_seen = set()
    for _ in range(400):
        op = ["alloc", "ensure", "free", "seize", "release"][
            rng.choice(5, p=[0.3, 0.35, 0.15, 0.1, 0.1])]
        slot = int(rng.randint(3))
        if op == "alloc":
            n = int(rng.randint(0, 4))
            got, want = port.alloc(slot, n), ref_pool.alloc(slot, n)
        elif op == "ensure":
            p = int(rng.randint(0, 24))
            got, want = port.ensure(slot, p), ref_pool.ensure(slot, p)
        elif op == "free":
            got, want = port.free_slot(slot), ref_pool.free_slot(slot)
        elif op == "seize":
            n = int(rng.randint(0, 4))
            got, want = port.seize(n), ref_pool.seize(n)
        else:
            n = None if rng.rand() < 0.3 else int(rng.randint(0, 3))
            got, want = port.release(n), ref_pool.release(n)
        ops_seen.add((op, got))
        assert got == want, op
        assert _pool_state(port) == _pool_state(ref_pool)
        assert port.pages_for_len(slot * 5) == \
            ref_pool.pages_for_len(slot * 5)
    assert {("alloc", False), ("alloc", True), ("ensure", False),
            ("ensure", True)} <= ops_seen


def test_slot_scheduler_decisions_equal_reference_under_random_ops():
    rng = np.random.RandomState(1)
    port, ref_sched = scheduler.SlotScheduler(3), jscheduler.SlotScheduler(3)
    next_rid = 0
    for _ in range(300):
        op = int(rng.randint(6))
        if op == 0:
            prompt = rng.randint(0, 50, size=int(rng.randint(1, 6)))
            gen = int(rng.randint(1, 4))
            eos = None if rng.rand() < 0.5 else int(rng.randint(0, 50))
            for s in (port, ref_sched):
                mod = scheduler if s is port else jscheduler
                s.submit(mod.Request(rid=next_rid, prompt=prompt,
                                     max_new_tokens=gen, eos_id=eos))
            next_rid += 1
        elif op == 1 and port.free_ids() and port.queue:
            i = port.free_ids()[0]
            port.admit(i, port.queue.popleft())
            ref_sched.admit(i, ref_sched.queue.popleft())
        elif op == 2 and port.prefilling_ids():
            i = port.prefilling_ids()[0]
            tok = int(rng.randint(0, 50))
            for s in (port, ref_sched):
                s.slots[i].prefilled = True
                s.slots[i].out.append(tok)
        elif op == 3 and port.running_ids():
            i = port.running_ids()[-1]
            tok = int(rng.randint(0, 50))
            for s in (port, ref_sched):
                s.slots[i].out.append(tok)
            if port.slots[i].finished():
                assert ref_sched.slots[i].finished()
                a, b = port.evict(i), ref_sched.evict(i)
                assert (a.req.rid, a.out) == (b.req.rid, b.out)
        elif op == 4 and port.running_ids():
            i = port.running_ids()[0]
            port.requeue_front(port.evict(i).req)
            ref_sched.requeue_front(ref_sched.evict(i).req)
        elif op == 5 and next_rid:
            rid = int(rng.randint(next_rid))
            a, b = port.remove_queued(rid), ref_sched.remove_queued(rid)
            assert (a is None) == (b is None)
            assert port.slot_of(rid) == ref_sched.slot_of(rid)
        assert port.free_ids() == ref_sched.free_ids()
        assert port.running_ids() == ref_sched.running_ids()
        assert port.prefilling_ids() == ref_sched.prefilling_ids()
        assert port.occupancy() == ref_sched.occupancy()
        assert port.has_work() == ref_sched.has_work()
        assert [r.rid for r in port.queue] == [r.rid for r in ref_sched.queue]
        for a, b in zip(port.slots, ref_sched.slots):
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.req.rid, a.admit_seq, a.prefill_progress,
                        a.prefilled, a.write_pos, a.n_generated,
                        a.finished(), a.out) == \
                    (b.req.rid, b.admit_seq, b.prefill_progress, b.prefilled,
                     b.write_pos, b.n_generated, b.finished(), b.out)
    for bad in (dict(prompt=np.array([], np.int32)),
                dict(prompt=np.arange(3), max_new_tokens=0),
                dict(prompt=np.arange(3), deadline_steps=0)):
        with pytest.raises(ValueError):
            scheduler.Request(rid=0, **bad)


def test_kv_byte_accounting_equals_reference():
    for bits in (2, 4, 8):
        for d in (8, 33, 64):
            assert kvquant.words_per(d, bits) == jkvquant.words_per(d, bits)
            assert kvquant.quant_page_bytes(16, d, bits, 2) == \
                jkvquant.quant_page_bytes(16, d, bits, 2)
        for mode in ("page", "head"):
            for slots in (1, 4):
                assert kvcache.equal_hbm_slots(slots, 16, 16, 64, bits,
                                               mode) == \
                    jkvcache.equal_hbm_slots(slots, 16, 16, 64, bits, mode)
    for bits in (0, 2, 4, 8):
        assert kvcache.kv_page_footprint(16, 16, 64, bits) == \
            jkvcache.kv_page_footprint(16, 16, 64, bits)
    assert kvquant.dense_page_bytes(16, 64) == jkvquant.dense_page_bytes(16,
                                                                          64)
    with pytest.raises(ValueError, match="kv_bits"):
        kvquant.check_kv_bits(3)


def test_sample_and_flag_first_max_and_poison_rows():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [float("nan"), 1.0, 2.0, 0.0],
                           [0.0, 0.0, 0.0, 0.0], [-1.0, float("inf"), 0, 0]])
    toks, bad = sampling.sample_and_flag(logits)
    assert toks.tolist() == [1, 0, 0, 0]
    assert bad.tolist() == [False, True, False, True]
    want = jnp.argmax(jnp.asarray(logits.numpy()[[0, 2]]), axis=-1)
    assert toks[[0, 2]].tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# Paged GQA layer steps against the reference's
# ---------------------------------------------------------------------------

D_MODEL, H, NKV, HDIM, PG = 16, 4, 2, 8, 4


@functools.lru_cache(maxsize=None)
def _layer():
    rng = np.random.RandomState(5)
    p = {"wq": rng.randn(D_MODEL, H * HDIM), "wk": rng.randn(D_MODEL,
                                                             NKV * HDIM),
         "wv": rng.randn(D_MODEL, NKV * HDIM), "wo": rng.randn(H * HDIM,
                                                               D_MODEL),
         "q_bias": rng.randn(H * HDIM), "k_bias": rng.randn(NKV * HDIM),
         "v_bias": rng.randn(NKV * HDIM)}
    p = {k: (0.3 * v).astype(np.float32) for k, v in p.items()}
    pool = rng.randn(2, 8, PG, NKV, HDIM).astype(np.float32)
    return p, pool


def _both_layers():
    p, pool = _layer()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tc = attn.PagedKVCache(k=torch.from_numpy(pool[0].copy()),
                           v=torch.from_numpy(pool[1].copy()))
    jc = jattn.PagedKVCache(k=jnp.asarray(pool[0]), v=jnp.asarray(pool[1]))
    return tp, jp, tc, jc


LAYER_KW = dict(n_heads=H, n_kv=NKV, head_dim=HDIM, page_size=PG,
                rope_theta=1e4)


def test_gqa_decode_paged_matches_reference():
    tp, jp, tc, jc = _both_layers()
    table = np.array([[2, 5, 0], [7, 0, 0], [1, 3, 4]], np.int32)
    pos = np.array([6, 1, 9], np.int32)
    alive = np.array([True, False, True])
    x = np.random.RandomState(6).randn(3, 1, D_MODEL).astype(np.float32)
    got, cache = attn.gqa_decode_paged(tp, *_t(x), tc, *_t(table, pos, alive),
                                       **LAYER_KW)
    want, jcache = jattn.gqa_decode_paged(jp, *_j(x), jc,
                                          *_j(table, pos, alive), **LAYER_KW)
    assert cache is tc                      # the pools are written in place
    np.testing.assert_allclose(got.numpy()[alive], np.asarray(want)[alive],
                               **TOL)
    for a, b in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_allclose(a.numpy()[1:], np.asarray(b)[1:], **TOL)


def test_gqa_prefill_block_paged_and_block_writes_match_reference():
    tp, jp, tc, jc = _both_layers()
    table = np.array([[6, 2, 3]], np.int32)
    x = np.random.RandomState(7).randn(1, 5, D_MODEL).astype(np.float32)
    for start in (0, 5):
        got, tc = attn.gqa_prefill_block_paged(
            tp, *_t(x), tc, torch.from_numpy(table), start,
            torch.ones(1, dtype=torch.bool), **LAYER_KW)
        want, jc = jattn.gqa_prefill_block_paged(
            jp, *_j(x), jc, jnp.asarray(table), start, jnp.ones(1, bool),
            **LAYER_KW)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
    # a dead slot's block lands on the trash page only
    pool = torch.zeros(4, PG, 1, 2)
    new = torch.ones(1, 3, 1, 2)
    attn._write_block_slot(pool, torch.tensor([[1, 2]]), 2,
                           torch.zeros(1, dtype=torch.bool), new, PG)
    assert pool[1:].abs().sum() == 0 and pool[0, 2:].sum() == 4
    jpool = jattn._write_block_slot(jnp.zeros((4, PG, 1, 2)),
                                    jnp.asarray([[1, 2]]), 2,
                                    jnp.zeros(1, bool), jnp.ones((1, 3, 1, 2)),
                                    PG)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
