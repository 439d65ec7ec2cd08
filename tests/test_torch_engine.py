"""The port's continuous-batching engine on the CPU.

THE invariant, as in ``tests/test_engine.py``: for any admission order,
slot count, page-pool size and completion pattern, every request's greedy
token stream from the engine equals the port's one-shot loop's
(``repro_torch.engine.oneshot``), bit for bit.  The scenarios are the
reference's, on ``tiny_cfg(tie=True)`` served from the ``pr2_mlp_only``
artifact (GQA + dense MLP, every leaf bit-packed): staggered admission
under a token budget smaller than a prompt, page reuse on an
oversubscribed pool, preemption replay, no prefill forward wider than
``effective_chunk``, EOS early exit, and the typed outcomes (rejection,
backpressure, cancel, deadline, ``max_steps`` partials, NaN quarantine).
Then the port's engine against the reference's ``Engine`` on the same
artifact, step by step: the ``step()`` info, the page table and the
streams.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from repro.analysis.zoo import tiny_cfg as ref_tiny_cfg
from repro.core import PackedModel as RefPackedModel
from repro.engine import Engine as RefEngine
from repro.engine import Request as RefRequest
from repro_torch import configs
from repro_torch.core.compression import PackedModel
from repro_torch.engine import (Engine, Outcome, Request, greedy_generate,
                                truncate_at_eos)
from repro_torch.models import transformer as T

# The shapes here are tiny: one torch thread per test worker keeps torch's
# thread pool off the cores the reference's JAX tests compile on.
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "pr2_mlp_only")
CFG = configs.tiny_cfg(tie=True)


@functools.lru_cache(maxsize=None)
def _artifact():
    with pytest.warns(UserWarning):
        return PackedModel.load(FIXTURE)


def _params():
    return _artifact().serving_params(packed=True)


@functools.lru_cache(maxsize=None)
def _prompts(n: int, length: int) -> np.ndarray:
    return np.random.RandomState(7 + length).randint(0, CFG.vocab,
                                                     size=(n, length))


def _oracle(params, reqs, block=None):
    """One-shot greedy streams per request, grouped by prompt length (the
    lockstep loop needs a rectangular batch); ``block`` is the prefill
    block, the engine's ``effective_chunk`` where it differs from the
    default, so both sides run the same blockwise partition."""
    out, by_len = {}, {}
    for r in reqs:
        by_len.setdefault(r.prompt_len, []).append(r)
    for group in by_len.values():
        prompts = torch.from_numpy(np.stack([r.prompt for r in group]))
        gen = max(r.max_new_tokens for r in group)
        toks = greedy_generate(params, CFG, prompts, gen, block=block)[0]
        for i, r in enumerate(group):
            out[r.rid] = truncate_at_eos(toks[i].numpy()[:r.max_new_tokens],
                                         r.eos_id)
    return out


def _assert_streams_equal(outs, want):
    assert set(outs) == set(want)
    for rid in want:
        np.testing.assert_array_equal(
            outs[rid], want[rid],
            err_msg=f"request {rid}: engine stream != one-shot stream")


def _assert_stats_identity(eng, outs):
    st = eng.stats
    assert st.generated_tokens == st.decode_tokens + st.prefill_samples
    if not st.preemptions:
        assert st.delivered_tokens == sum(len(v) for v in outs.values())


def _staggered_reqs():
    p16, p8 = _prompts(4, 16), _prompts(2, 8)
    gens = [6, 2, 5, 3, 6, 1]
    return [Request(rid=r, prompt=(p16[r // 2] if r % 2 == 0
                                   else p8[r // 4]),
                    max_new_tokens=gens[r]) for r in range(6)]


def test_engine_matches_one_shot_staggered():
    params = _params()
    reqs = _staggered_reqs()
    # token_budget 12 < prompt 16: blocks {12, 4} for the long prompts and
    # {8} for the short — the oracle runs the same partition
    want = _oracle(params, reqs, block=12)
    eng = Engine(params, CFG, n_slots=2, page_size=8, max_seq=24,
                 token_budget=12)
    assert eng.effective_chunk == 12
    outs = eng.run(reqs)
    _assert_streams_equal(outs, want)
    _assert_stats_identity(eng, outs)
    s = eng.stats.summary()
    assert s["finished"] == 6 and s["delivered_tokens"] == 23
    assert 0 < s["slot_occupancy"] <= 1
    assert 0 < s["page_utilization_max"] <= 1
    assert len(eng.stats.decode_step_s) > 0
    assert len(eng.stats.prefill_block_s) == eng.stats.prefill_calls == 9
    # the device table is uploaded again only when the pool changed
    assert eng.table_uploads <= eng.pool.version + 1 < eng.stats.steps + 10


def test_engine_long_prompt_blocks_never_exceed_effective_chunk():
    """prompt_len 40 >> prefill_chunk 8: five block forwards per request,
    none wider than ``effective_chunk``, every prompt token once."""
    params = _params()
    prompts = _prompts(3, 40)
    reqs = [Request(rid=r, prompt=prompts[r], max_new_tokens=[6, 3, 5][r])
            for r in range(3)]
    eng = Engine(params, CFG, n_slots=2, page_size=8, max_seq=64,
                 prefill_chunk=8, token_budget=10)
    assert eng.effective_chunk == 8
    widths = []
    orig = eng._chunk

    def spy(p, c, caches, table, tok, slot, start):
        widths.append(int(tok.shape[1]))
        return orig(p, c, caches, table, tok, slot, start)

    eng._chunk = spy
    outs = eng.run(list(reqs))
    assert max(widths) <= eng.effective_chunk == 8
    assert sum(widths) == 3 * 40
    _assert_streams_equal(outs, _oracle(params, reqs, block=8))
    st = eng.stats
    assert st.prefill_tokens == 3 * 40 and st.prefill_calls == 3 * 5
    assert st.prefill_samples == 3
    _assert_stats_identity(eng, outs)
    assert st.generated_tokens == sum(len(v) for v in outs.values())


def test_page_reuse_stress_never_corrupts_neighbor_kv():
    """A long request decodes while short ones churn through the slots
    around it on an oversubscribed pool; every stream stays the one-shot
    stream — a recycled page is never still read through an old table."""
    params = _params()
    p16, p8 = _prompts(8, 16), _prompts(4, 8)
    reqs = [Request(rid=0, prompt=p16[0], max_new_tokens=8)]
    for r in range(1, 8):
        reqs.append(Request(rid=r, prompt=(p8[r % 4] if r % 2 else p16[r]),
                            max_new_tokens=2 + r % 3))
    want = _oracle(params, reqs)
    # 3 slots but only 7 usable pages (full residency would need 9)
    eng = Engine(params, CFG, n_slots=3, page_size=8, max_seq=24, n_pages=7,
                 token_budget=20)
    outs = eng.run(reqs)
    _assert_streams_equal(outs, want)
    _assert_stats_identity(eng, outs)
    assert eng.stats.summary()["page_utilization_max"] > 0.8


def test_preemption_replays_request_exactly():
    params = _params()
    p16 = _prompts(6, 16)
    reqs = [Request(rid=r, prompt=p16[r],
                    max_new_tokens=[6, 2, 5, 3, 6, 4][r]) for r in range(6)]
    want = _oracle(params, reqs)
    eng = Engine(params, CFG, n_slots=3, page_size=8, max_seq=22, n_pages=6,
                 token_budget=20)
    outs = eng.run(reqs)
    _assert_streams_equal(outs, want)
    assert eng.stats.preemptions > 0 and eng.stats.stall_events > 0
    assert eng.stats.generated_tokens == \
        eng.stats.decode_tokens + eng.stats.prefill_samples
    assert eng.stats.generated_tokens > eng.stats.delivered_tokens
    assert any(eng.results[r].n_preemptions for r in eng.results)


def test_engine_eos_early_exit_against_one_shot():
    """EOS stops a request mid-stream; its slot and pages free while the
    neighbors keep decoding.  Held against the one-shot loop cut at EOS."""
    params = _params()
    p16 = _prompts(3, 16)
    plain = _oracle(params, [Request(rid=r, prompt=p16[r], max_new_tokens=8)
                             for r in range(3)])
    eos = int(plain[1][2])
    reqs = [Request(rid=r, prompt=p16[r], max_new_tokens=8,
                    eos_id=eos if r == 1 else None) for r in range(3)]
    want = _oracle(params, reqs)
    assert 1 <= len(want[1]) <= 3 and want[1][-1] == eos
    eng = Engine(params, CFG, n_slots=2, page_size=8, max_seq=24)
    outs = eng.run(reqs)
    _assert_streams_equal(outs, want)
    assert len(outs[1]) == len(want[1]) and outs[1][-1] == eos
    assert eng.pool.used_pages == 0


def test_engine_rejects_backpressure_cancel_and_deadline():
    params = _params()
    p16, p8 = _prompts(1, 16), _prompts(5, 8)
    # rejections are typed outcomes: submit never reserves a page
    eng = Engine(params, CFG, n_slots=1, page_size=8, max_seq=24)
    assert eng.submit(Request(rid=0, prompt=p16[0], max_new_tokens=100)) \
        is Outcome.REJECTED_TOO_LARGE
    assert "max_seq" in eng.results[0].detail
    assert eng.pool.used_pages == 0 and not eng.sched.has_work()
    eng2 = Engine(params, CFG, n_slots=1, page_size=8, max_seq=24,
                  n_pages=2)
    assert eng2.submit(Request(rid=0, prompt=p16[0], max_new_tokens=8)) \
        is Outcome.REJECTED_TOO_LARGE
    assert "pool" in eng2.results[0].detail
    eng3 = Engine(params, CFG, n_slots=1, page_size=8, max_seq=24, n_pages=1)
    assert eng3.run([Request(rid=0, prompt=p16[0], max_new_tokens=2)]) == {}
    assert eng3.stats.rejected == 1
    # bounded queue: 2 queued, 3 shed; a queued request cancelled
    eng4 = Engine(params, CFG, n_slots=1, page_size=8, max_seq=16,
                  queue_limit=2)
    reqs = [Request(rid=r, prompt=p8[r], max_new_tokens=4) for r in range(5)]
    outcomes = [eng4.submit(r) for r in reqs]
    assert outcomes[:2] == [None, None]
    assert all(o is Outcome.REJECTED_BACKPRESSURE for o in outcomes[2:])
    assert eng4.cancel(1) and not eng4.cancel(99)
    assert eng4.results[1].outcome is Outcome.CANCELLED
    outs = eng4.run()
    assert sorted(outs) == [0] and sorted(eng4.results) == [0, 1, 2, 3, 4]
    _assert_streams_equal(outs, _oracle(params, reqs[:1]))
    assert eng4.stats.cancelled == 1 and eng4.stats.rejected == 3
    # a running request cancelled mid-stream keeps its partial tokens
    eng5 = Engine(params, CFG, n_slots=2, page_size=8, max_seq=64)
    eng5.submit(Request(rid=0, prompt=p8[0], max_new_tokens=40))
    eng5.submit(Request(rid=1, prompt=p8[1], max_new_tokens=4))
    for _ in range(4):
        eng5.step()
    assert eng5.cancel(0)
    assert eng5.results[0].tokens.size > 0
    _assert_streams_equal(eng5.run(), _oracle(params, [Request(
        rid=1, prompt=p8[1], max_new_tokens=4)]))
    # a tight deadline expires mid-stream; the neighbor finishes untouched
    eng6 = Engine(params, CFG, n_slots=2, page_size=8, max_seq=64)
    eng6.submit(Request(rid=0, prompt=p8[0], max_new_tokens=40,
                        deadline_steps=4))
    eng6.submit(Request(rid=1, prompt=p8[1], max_new_tokens=4))
    outs = eng6.run()
    assert sorted(outs) == [1]
    assert eng6.results[0].outcome is Outcome.DEADLINE_EXCEEDED
    assert 0 < eng6.results[0].tokens.size < 40
    assert eng6.pool.used_pages == 0 and eng6.stats.deadline_expired == 1


def test_engine_max_steps_partials_and_unported_modes():
    params = _params()
    p8 = _prompts(2, 8)
    eng = Engine(params, CFG, n_slots=2, page_size=8, max_seq=64)
    outs = eng.run([Request(rid=r, prompt=p8[r], max_new_tokens=30)
                    for r in range(2)], max_steps=6)
    assert outs == {}
    for r in range(2):
        assert eng.results[r].outcome is Outcome.FAILED
        assert "max_steps" in eng.results[r].detail
        assert eng.results[r].tokens.size > 0
    assert not eng.sched.has_work() and eng.pool.used_pages == 0
    # sampled requests are refused, never decoded greedily
    with pytest.raises(NotImplementedError, match="module 9"):
        eng.submit(Request(rid=5, prompt=p8[0], temperature=0.7))
    assert 5 not in eng.results
    # quantized KV pages (module 7) are ported: bad knobs are refused
    with pytest.raises(ValueError, match="kv_cb_mode"):
        Engine(params, CFG, kv_bits=4, kv_cb_mode="tensor")
    with pytest.raises(ValueError, match="kv_bits"):
        Engine(params, CFG, kv_bits=3)


def test_nan_quarantine_isolates_the_poisoned_slot():
    """A slot whose logits row goes non-finite fails typed and frees its
    slot while its neighbor's stream stays the one-shot stream — also
    after the neighbor takes over the poisoned slot's pages (LIFO reuse),
    here filled with NaN K/V as a numerically poisoned request leaves
    them."""
    params = _params()
    p8 = _prompts(2, 8)
    reqs = [Request(rid=0, prompt=p8[0], max_new_tokens=12),
            Request(rid=1, prompt=p8[1], max_new_tokens=5)]
    eng = Engine(params, CFG, n_slots=2, page_size=4, max_seq=24)
    orig, calls = eng._decode, []

    def poisoned(p, cfg, caches, table, tokens, pos, alive):
        logits, caches = orig(p, cfg, caches, table, tokens, pos, alive)
        calls.append(1)
        if len(calls) == 2:
            slot = eng.sched.slot_of(1)
            idx = torch.tensor(eng.pool.pages_of(slot))
            for cache in caches[0].values():
                for pool in cache:
                    pool[:, idx] = float("nan")
            logits[slot] = float("nan")
        return logits, caches

    eng._decode = poisoned
    outs = eng.run(reqs)
    assert sorted(outs) == [0]
    res = eng.results[1]
    assert res.outcome is Outcome.FAILED and "non-finite" in res.detail
    assert res.tokens.size == 2
    assert eng.stats.quarantined == 1 and eng.stats.failed == 1
    _assert_streams_equal(outs, _oracle(params, reqs[:1]))


# ---------------------------------------------------------------------------
# The port's engine against the reference's, step by step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_engine_run():
    """The reference's Engine over the same artifact and requests, one
    ``step()`` at a time: every info dict and page table, and the
    streams."""
    with pytest.warns(UserWarning):
        rpm = RefPackedModel.load(FIXTURE)
    rcfg = ref_tiny_cfg(tie=True)
    reqs = [RefRequest(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens)
            for r in _staggered_reqs()]
    eng = RefEngine(rpm.serving_params(packed=True), rcfg, n_slots=2,
                    page_size=8, max_seq=24, n_pages=4, token_budget=12)
    for r in reqs:
        eng.submit(r)
    trace = []
    while eng.sched.has_work():
        info = eng.step()
        trace.append((info, eng.pool.table.copy()))
    return trace, dict(eng.outputs), eng.stats.summary()


def test_engine_steps_equal_reference_engine(reference_engine_run):
    trace, ref_outs, ref_summary = reference_engine_run
    eng = Engine(_params(), CFG, n_slots=2, page_size=8, max_seq=24,
                 n_pages=4, token_budget=12)
    for r in _staggered_reqs():
        assert eng.submit(r) is None
    steps = 0
    while eng.sched.has_work():
        info = eng.step()
        want_info, want_table = trace[steps]
        assert info == want_info, f"step {steps}"
        np.testing.assert_array_equal(eng.pool.table, want_table,
                                      err_msg=f"step {steps}")
        steps += 1
    assert steps == len(trace)
    _assert_streams_equal(eng.outputs,
                          {k: np.asarray(v) for k, v in ref_outs.items()})
    got = eng.stats.summary()
    for key in ("steps", "generated_tokens", "delivered_tokens",
                "prefill_tokens", "slot_occupancy", "page_utilization",
                "page_utilization_max", "finished", "preemptions",
                "stall_events"):
        assert got[key] == pytest.approx(ref_summary[key]), key
    assert got["stall_events"] > 0 and got["preemptions"] > 0


def test_engine_config_and_layouts():
    """The engine takes any serving layout and infers its pool dtype; the
    dense layout serves the same streams as the packed one."""
    pm = _artifact()
    reqs = [Request(rid=r, prompt=_prompts(2, 8)[r], max_new_tokens=3)
            for r in range(2)]
    outs = {}
    for name, params in (("packed", pm.serving_params(packed=True)),
                         ("uint8", pm.serving_params(packed=False)),
                         ("dense", pm.decode())):
        eng = Engine(params, CFG, n_slots=2, page_size=4, max_seq=12)
        assert eng.dtype == torch.float32 and eng.device.type == "cpu"
        assert eng.caches[0]["pos0"].k.shape == (2, 7, 4, 2, 8)
        outs[name] = eng.run(list(reqs))
    for name in ("uint8", "dense"):
        _assert_streams_equal(outs[name], outs["packed"])
    bad = dataclasses.replace(CFG, stacks=(T.StackSpec(
        (T.LayerKind("gqa_local"),), 1),))
    with pytest.raises(NotImplementedError, match="module 8"):
        Engine(pm.decode(), bad)
