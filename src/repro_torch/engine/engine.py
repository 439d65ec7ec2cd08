"""The continuous-batching step loop (port of ``repro/engine/engine.py``,
dense or codebook-quantized KV pages, greedy sampling, one device).

Each :meth:`Engine.step` mixes, under a per-step token budget:

1. **decode** — one token for every running slot, in a single
   ``decode_step_slots`` call over all ``n_slots`` (dead slots are masked,
   so the tensor shapes never depend on admission or eviction);
2. **admission** — queued requests move into free slots once their
   prompt's pages can be reserved from the pool;
3. **blockwise prefill** — each admitted prompt advances at most ONE
   block of ≤ ``effective_chunk`` new tokens per step, paid out of the
   leftover budget.  The block is the compute: an incremental forward
   over just those tokens whose K/V lands directly in the slot's pages,
   so no engine step runs a forward over more than ``effective_chunk``
   prompt tokens.  The one-shot oracle runs the same blockwise
   computation (``transformer.prefill`` with the same block), so engine
   token streams are exactly the one-shot streams.

A finished slot's pages return to the pool immediately.  If every running
slot is page-starved and nothing else can progress, the youngest stalled
request is preempted back to the queue head and restarts from scratch;
greedy decoding makes the replayed stream identical.

Failure isolation: every request ends in exactly one typed
:class:`~repro_torch.engine.outcomes.Outcome` in :attr:`Engine.results`.
An unservable prompt is rejected before reserving a page
(``REJECTED_TOO_LARGE``; a full bounded queue gives
``REJECTED_BACKPRESSURE``), per-request deadlines expire to
``DEADLINE_EXCEEDED`` with pages freed at once, :meth:`cancel` frees
mid-stream, a per-request preemption budget turns page-starved livelock
into a typed ``FAILED``, and a non-finite logit row quarantines only its
slot while batch mates keep decoding.  :meth:`run` never raises: going
past ``max_steps`` fails the stragglers and returns every completed
stream.

With ``kv_bits`` ∈ {2, 4, 8} the pages hold codebook-quantized K/V
(bit-packed indices and per-page codebooks, ``kv_cb_mode`` "page" or
"head"): each page's codebook is fit when its first row is written and
frozen after, so storage is a pure function of the written values.

Not ported here: the device mesh (ROADMAP.md module 14), sampling beyond
greedy (module 9) and the chaos / snapshot hooks (module 10).  In PyTorch
the step runs eagerly, so the reference's jit-cache counters have no
counterpart.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.compression import torch_dtype
from repro_torch.engine import sampling
from repro_torch.engine.kvcache import PagePool
from repro_torch.engine.outcomes import Outcome, RequestResult
from repro_torch.engine.scheduler import Request, SlotScheduler
from repro_torch.models.transformer import (ModelConfig, check_ported,
                                            decode_step_slots,
                                            init_paged_cache,
                                            prefill_chunk_slots)


def _activation_dtype(params) -> torch.dtype:
    """The model's residual-stream dtype, read off the embedding leaf in
    any serving layout (dense table, or the layout / codebook metadata of
    the quantized layouts)."""
    if "embed_tok" in params:
        return params["embed_tok"].dtype
    layout = params.get("embed_tok_layout")
    if layout is not None and layout.dtype is not None:
        return torch_dtype(layout.dtype)
    if "embed_tok_cb" in params:
        return params["embed_tok_cb"].dtype
    return torch.float32


def _device_of(params) -> torch.device:
    """The device of the params tree (its embedding leaf)."""
    for name in ("embed_tok", "embed_tok_pidx", "embed_tok_idx"):
        if name in params:
            return params[name].device
    raise ValueError("params carry no embedding leaf")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0        # prompt tokens actually computed
    prefill_calls: int = 0         # block forwards run (>= 1 per prompt)
    prefill_samples: int = 0       # first tokens sampled at final blocks
    admitted: int = 0
    finished: int = 0
    delivered_tokens: int = 0      # tokens in finished outputs (excludes
    #                                work discarded by preemption)
    stall_events: int = 0
    preemptions: int = 0
    rejected: int = 0              # TOO_LARGE + BACKPRESSURE at submit
    cancelled: int = 0
    deadline_expired: int = 0
    quarantined: int = 0           # non-finite logit rows isolated
    failed: int = 0                # FAILED outcomes (incl. quarantines)
    occupancy_sum: float = 0.0
    page_util_sum: float = 0.0
    page_util_max: float = 0.0
    wall_s: float = 0.0
    # host seconds of each prefill block forward and each decode step,
    # around work that ends in a device synchronise
    prefill_block_s: List[float] = dataclasses.field(default_factory=list)
    decode_step_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def generated_tokens(self) -> int:
        """Tokens *sampled*: decode steps plus the first token each
        completed prefill emits.  A multi-block prefill samples exactly
        once, so this never double-counts block forwards; it exceeds
        delivered_tokens when preemptions discarded work."""
        return self.decode_tokens + self.prefill_samples

    def summary(self) -> dict:
        steps = max(self.steps, 1)
        wall = max(self.wall_s, 1e-9)

        def median_ms(xs):
            return 1e3 * statistics.median(xs) if xs else float("nan")

        return {
            "steps": self.steps,
            "generated_tokens": self.generated_tokens,
            "delivered_tokens": self.delivered_tokens,
            "prefill_tokens": self.prefill_tokens,
            "tokens_per_s": self.delivered_tokens / wall,
            "slot_occupancy": self.occupancy_sum / steps,
            "page_utilization": self.page_util_sum / steps,
            "page_utilization_max": self.page_util_max,
            "finished": self.finished,
            "preemptions": self.preemptions,
            "stall_events": self.stall_events,
            "rejected": self.rejected,
            "cancelled": self.cancelled,
            "deadline_expired": self.deadline_expired,
            "quarantined": self.quarantined,
            "failed": self.failed,
            "wall_s": self.wall_s,
            "prefill_ms_per_block": median_ms(self.prefill_block_s),
            "decode_ms_per_step": median_ms(self.decode_step_s),
        }


class Engine:
    """Continuous-batching serving engine over (possibly packed) params.

    ``params`` may be any serving layout — dense, uint8, or the bit-packed
    ``serving_params(packed=True)`` tree — on one device; the engine's
    page pools and step tensors live on that device (the CUDA kernels run
    on a card, their plain versions on the CPU).

    Memory sizing: the page pool holds ``n_pages`` pages of ``page_size``
    tokens for every attention layer; ``max_seq`` bounds one request's
    prompt + generation.  The default gives every slot its full
    ``max_seq`` worth of pages (no contention); a smaller ``n_pages``
    oversubscribes the pool (short / long request mixes reuse pages).

    ``dtype`` is the KV-pool element type and must match the model's
    activation dtype; the default infers it from the embedding leaf.

    Admission control: ``queue_limit`` bounds the request queue —
    :meth:`submit` beyond it records ``REJECTED_BACKPRESSURE``.
    ``max_preemptions`` bounds how many times one request may be
    preempted for page pressure before it fails typed.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 page_size: int = 16, max_seq: int = 256,
                 n_pages: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefill_chunk: int = 64, dtype=None,
                 queue_limit: Optional[int] = None,
                 max_preemptions: int = 8, kv_bits: int = 0,
                 kv_cb_mode: str = "page"):
        if kv_bits:
            # the knobs ride on the config, which the step functions read
            # and check_ported validates; kv_bits == 0 leaves cfg as it is
            cfg = dataclasses.replace(cfg, kv_bits=kv_bits,
                                      kv_cb_mode=kv_cb_mode)
        check_ported(cfg)
        self.params = params
        self.cfg = cfg
        self.kv_bits = kv_bits
        self.kv_cb_mode = kv_cb_mode
        self.device = _device_of(params)
        self.n_slots = n_slots
        self.page_size = page_size
        max_pages_per_slot = -(-max_seq // page_size)
        self.max_seq = max_pages_per_slot * page_size
        if n_pages is None:
            n_pages = n_slots * max_pages_per_slot
        self.pool = PagePool(n_pages, page_size, n_slots, max_pages_per_slot)
        self.sched = SlotScheduler(n_slots)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.token_budget = (int(token_budget) if token_budget is not None
                             else n_slots + self.prefill_chunk)
        if self.token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        # the block size every prefill forward actually uses: the fixed
        # partition must fit inside a fresh step's budget, or a long
        # prompt could never schedule its first block
        self.effective_chunk = max(1, min(self.prefill_chunk,
                                          self.token_budget))
        self.queue_limit = (None if queue_limit is None
                            else max(int(queue_limit), 1))
        self.max_preemptions = int(max_preemptions)
        self.dtype = dtype if dtype is not None else _activation_dtype(params)
        self.caches = init_paged_cache(cfg, n_slots, n_pages, page_size,
                                       self.dtype, self.device)
        self._decode = decode_step_slots
        self._chunk = prefill_chunk_slots
        self._table_cache = (-1, None)     # (pool.version, device table)
        self.table_uploads = 0
        self.outputs: Dict[int, np.ndarray] = {}
        self.results: Dict[int, RequestResult] = {}
        self._submit_step: Dict[int, int] = {}
        self._preempt_counts: Dict[int, int] = {}
        self.stats = EngineStats()

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> Optional[Outcome]:
        """Admission control.  Returns ``None`` when the request is
        queued, or the typed rejection outcome (also recorded in
        :attr:`results`) — never reserves a page for an unservable
        request, never disturbs in-flight neighbors.  A sampled request
        (``temperature > 0``) raises: only greedy decoding is ported."""
        if req.temperature > 0:
            raise NotImplementedError(
                f"request {req.rid}: temperature {req.temperature} > 0 needs "
                f"sampling beyond greedy, not ported yet: ROADMAP.md "
                f"module 9")
        total = req.prompt_len + req.max_new_tokens
        if total > self.max_seq:
            return self._reject(
                req, Outcome.REJECTED_TOO_LARGE,
                f"prompt {req.prompt_len} + max_new {req.max_new_tokens} "
                f"exceeds max_seq {self.max_seq}")
        if self.pool.pages_for_len(total) > self.pool.n_pages:
            # would stall at the same position on every replay — reject
            # up front instead of preempt-cycling until max_steps
            return self._reject(
                req, Outcome.REJECTED_TOO_LARGE,
                f"needs {self.pool.pages_for_len(total)} pages to finish, "
                f"pool has {self.pool.n_pages}")
        if (self.queue_limit is not None
                and len(self.sched.queue) >= self.queue_limit):
            return self._reject(
                req, Outcome.REJECTED_BACKPRESSURE,
                f"queue full ({self.queue_limit}); retry after drain")
        self._submit_step.setdefault(req.rid, self.stats.steps)
        self.sched.submit(req)
        return None

    def cancel(self, rid: int, detail: str = "client cancel") -> bool:
        """Cancel a queued or running request: its pages free at once,
        its partial tokens ride in the typed result, and batch mates never
        notice.  Returns False for unknown / finished rids."""
        if self.sched.remove_queued(rid) is not None:
            self._record(rid, Outcome.CANCELLED, detail=detail)
            self.stats.cancelled += 1
            return True
        slot = self.sched.slot_of(rid)
        if slot is None:
            return False
        s = self.sched.evict(slot)
        self.pool.free_slot(slot)
        self._record(rid, Outcome.CANCELLED, tokens=s.out, detail=detail)
        self.stats.cancelled += 1
        return True

    def abort_remaining(self, detail: str):
        """Terminate every queued and in-flight request with a typed
        ``FAILED`` carrying its partial tokens (used on a ``max_steps``
        overrun — completed outputs survive)."""
        while self.sched.queue:
            req = self.sched.queue.popleft()
            self._record(req.rid, Outcome.FAILED, detail=detail)
            self.stats.failed += 1
        for i, s in enumerate(self.sched.slots):
            if s is None:
                continue
            self.sched.evict(i)
            self.pool.free_slot(i)
            self._record(s.req.rid, Outcome.FAILED, tokens=s.out,
                         detail=detail)
            self.stats.failed += 1

    def run(self, requests: Optional[List[Request]] = None,
            max_steps: int = 100_000) -> Dict[int, np.ndarray]:
        """Drive steps until queue and slots drain; returns rid → tokens
        for every ``FINISHED`` request.  Never raises on a request's fate:
        rejected / expired / failed requests carry typed outcomes in
        :attr:`results`, and a ``max_steps`` overrun fails the stragglers
        instead of discarding the completed streams."""
        for r in requests or ():
            self.submit(r)
        t0 = time.perf_counter()
        while self.sched.has_work():
            self.step()
            if self.stats.steps > max_steps:
                self.abort_remaining(f"engine exceeded max_steps "
                                     f"({max_steps})")
                break
        _sync(self.device)
        self.stats.wall_s += time.perf_counter() - t0
        return dict(self.outputs)

    # -- one step -----------------------------------------------------------

    def step(self) -> dict:
        st = self.stats
        st.steps += 1
        st.occupancy_sum += self.sched.occupancy()
        info = {"decoded": 0, "prefill_tokens": 0, "admitted": 0,
                "finished": 0, "stalled": 0, "preempted": 0, "expired": 0,
                "quarantined": 0}
        budget = self.token_budget

        # 0) deadline sweep: expired requests (queued or in-flight) free
        #    their slot / pages before any work is scheduled this step
        self._expire_deadlines(info)

        # 1) decode every running slot whose next page is available
        running = self.sched.running_ids()
        ready, stalled = [], []
        for i in running:
            s = self.sched.slots[i]
            (ready if self.pool.ensure(i, s.write_pos)
             else stalled).append(i)
        if stalled:
            st.stall_events += len(stalled)
            info["stalled"] = len(stalled)
        if ready:
            self._decode_ready(ready, info)
            budget -= len(ready)
            st.decode_tokens += len(ready)

        # 2) admit queued requests into free slots (reserve prompt pages)
        for i in self.sched.free_ids():
            if not self.sched.queue:
                break
            req = self.sched.queue[0]
            if not self.pool.alloc(i, self.pool.pages_for_len(
                    req.prompt_len)):
                break
            self.sched.queue.popleft()
            self.sched.admit(i, req)
            st.admitted += 1
            info["admitted"] += 1

        # 3) blockwise prefill under the leftover budget: each prefilling
        #    slot advances at most one block per step, and only when the
        #    leftover budget covers the whole block.  Block boundaries
        #    depend only on (prompt_len, effective_chunk), so a preempted
        #    request replays the exact same block sequence.
        for i in self.sched.prefilling_ids():
            s = self.sched.slots[i]
            blk = min(self.effective_chunk,
                      s.req.prompt_len - s.prefill_progress)
            if blk > budget:
                continue
            self._prefill_block(i, s, blk, info)
            budget -= blk

        util = self.pool.utilization()
        st.page_util_sum += util
        st.page_util_max = max(st.page_util_max, util)

        if not (info["decoded"] or info["prefill_tokens"]
                or info["admitted"] or info["expired"]
                or info["quarantined"]):
            self._resolve_no_progress(stalled, info)
        return info

    # -- internals ----------------------------------------------------------

    def _record(self, rid: int, outcome: Outcome, tokens=None,
                detail: str = ""):
        self.results[rid] = RequestResult(
            rid=rid, outcome=outcome,
            tokens=np.asarray(tokens if tokens is not None else [],
                              np.int32),
            detail=detail,
            n_preemptions=self._preempt_counts.get(rid, 0))

    def _reject(self, req: Request, outcome: Outcome,
                detail: str) -> Outcome:
        self._record(req.rid, outcome, detail=f"request {req.rid}: {detail}")
        self.stats.rejected += 1
        return outcome

    def _expire_deadlines(self, info):
        expired = []
        for req in list(self.sched.queue):
            if self._deadline_hit(req):
                self.sched.remove_queued(req.rid)
                self._record(req.rid, Outcome.DEADLINE_EXCEEDED,
                             detail=self._deadline_detail(req))
                expired.append(req.rid)
        for i, s in enumerate(self.sched.slots):
            if s is None or not self._deadline_hit(s.req):
                continue
            self.sched.evict(i)
            self.pool.free_slot(i)
            self._record(s.req.rid, Outcome.DEADLINE_EXCEEDED,
                         tokens=s.out,
                         detail=self._deadline_detail(s.req))
            expired.append(s.req.rid)
        if expired:
            self.stats.deadline_expired += len(expired)
            info["expired"] = len(expired)

    def _deadline_hit(self, req: Request) -> bool:
        if req.deadline_steps is None:
            return False
        born = self._submit_step.get(req.rid, 0)
        return self.stats.steps - born > req.deadline_steps

    def _deadline_detail(self, req: Request) -> str:
        return (f"deadline of {req.deadline_steps} steps exceeded "
                f"(submitted at step {self._submit_step.get(req.rid, 0)})")

    def _page_table(self) -> torch.Tensor:
        """The device copy of the pool's page table, uploaded again only
        when the pool's ``version`` moved."""
        if self._table_cache[0] != self.pool.version:
            self._table_cache = (self.pool.version,
                                 torch.from_numpy(self.pool.table.copy()).to(
                                     self.device))
            self.table_uploads += 1
        return self._table_cache[1]

    def _decode_ready(self, ready, info):
        b = self.n_slots
        tokens = np.zeros((b, 1), np.int64)
        pos = np.zeros((b,), np.int32)
        alive = np.zeros((b,), bool)
        for i in ready:
            s = self.sched.slots[i]
            tokens[i, 0] = s.out[-1]
            pos[i] = s.write_pos
            alive[i] = True
        dev = self.device
        # quantized pages: the slots whose write starts a page fit its
        # codebook this step (known here, so the step needs no host read)
        fit = ({"fit_slots": [i for i in ready
                              if pos[i] % self.page_size == 0]}
               if self.kv_bits else {})
        t0 = time.perf_counter()
        logits, self.caches = self._decode(
            self.params, self.cfg, self.caches, self._page_table(),
            torch.from_numpy(tokens).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(alive).to(dev), **fit)
        nxt, bad = sampling.sample_and_flag(logits[:, 0])
        nxt, bad = nxt.cpu().numpy(), bad.cpu().numpy()
        self.stats.decode_step_s.append(time.perf_counter() - t0)
        for i in ready:
            if bad[i]:
                self._quarantine(i, info)
                continue
            s = self.sched.slots[i]
            s.out.append(int(nxt[i]))
            info["decoded"] += 1
            if s.finished():
                self._finish(i, info)

    def _quarantine(self, i, info):
        """Isolate a slot whose logits went non-finite: typed ``FAILED``
        with the partial stream, pages freed, neighbors untouched (their
        lanes sampled from their own finite rows this very step).

        The slot's pages are zeroed before they return to the pool: they
        may hold the non-finite K/V that poisoned it, and the next owner
        of a recycled page reads its rows past ``pos`` masked — a masked
        row still enters the plain versions' products as 0 × value, and
        0 × NaN is NaN.  With quantized pages that is the words and the
        page codebooks, which a non-finite row turns to NaN when it is
        fit.  (The reference frees them as they are.)"""
        s = self.sched.evict(i)
        self._scrub_pages(self.pool.pages_of(i))
        self.pool.free_slot(i)
        self._record(s.req.rid, Outcome.FAILED, tokens=s.out,
                     detail="non-finite logits: slot quarantined")
        self.stats.quarantined += 1
        self.stats.failed += 1
        info["quarantined"] += 1

    def _scrub_pages(self, pages):
        """Zero every pool of the given pages in every layer: dense K/V, or
        the words and codebooks of quantized pages."""
        if not pages:
            return
        idx = torch.tensor(pages, device=self.device)
        for stack in self.caches:
            for cache in stack.values():
                for pool in cache:
                    pool[:, idx] = 0

    def _prefill_block(self, i, s, blk, info):
        """One incremental forward over the slot's next ``blk`` prompt
        tokens: the block's K/V lands in the slot's pages inside the call.
        On the final block the request's first token is sampled from the
        block's last-position logits — the same row the one-shot oracle's
        blockwise prefill produces, so streams stay bit-exact."""
        start = s.prefill_progress
        tok = torch.from_numpy(
            s.req.prompt[None, start:start + blk].astype(np.int64)).to(
                self.device)
        t0 = time.perf_counter()
        logits, self.caches = self._chunk(
            self.params, self.cfg, self.caches, self._page_table(), tok, i,
            start)
        _sync(self.device)
        self.stats.prefill_block_s.append(time.perf_counter() - t0)
        s.prefill_progress += blk
        self.stats.prefill_calls += 1
        self.stats.prefill_tokens += blk
        info["prefill_tokens"] += blk
        if s.prefill_progress < s.req.prompt_len:
            return
        tok0, bad = sampling.sample_and_flag(logits[:, -1])
        self.stats.prefill_samples += 1
        s.prefilled = True
        if bool(bad.cpu()[0]):
            self._quarantine(i, info)
            return
        s.out.append(int(tok0.cpu()[0]))
        if s.finished():
            self._finish(i, info)

    def _finish(self, i, info):
        s = self.sched.evict(i)
        self.pool.free_slot(i)
        self.outputs[s.req.rid] = np.asarray(s.out, np.int32)
        self._record(s.req.rid, Outcome.FINISHED, tokens=s.out)
        self.stats.finished += 1
        self.stats.delivered_tokens += len(s.out)
        info["finished"] += 1

    def _resolve_no_progress(self, stalled, info):
        if stalled:
            # every runnable slot is page-starved and no admission or
            # prefill could proceed: preempt the youngest, replay later.
            # Seized pages (an injected pressure spike) are transient by
            # construction — wait them out instead of burning a request's
            # preemption budget on borrowed starvation.
            if self.pool.seized:
                return
            j = max(stalled, key=lambda i: self.sched.slots[i].admit_seq)
            s = self.sched.evict(j)
            self.pool.free_slot(j)
            rid = s.req.rid
            n = self._preempt_counts.get(rid, 0) + 1
            self._preempt_counts[rid] = n
            self.stats.preemptions += 1
            info["preempted"] = 1
            if n > self.max_preemptions:
                # livelock breaker: two page-starved giants would
                # otherwise ping-pong this resolver forever
                self._record(rid, Outcome.FAILED, tokens=s.out,
                             detail=f"preemption budget exhausted "
                                    f"({n - 1} > {self.max_preemptions} "
                                    f"would never converge)")
                self.stats.failed += 1
                return
            # Request is immutable (progress lives on SlotState): the
            # replay reuses it as-is and regenerates the same stream
            self.sched.requeue_front(s.req)
        elif self.sched.queue:
            if self.pool.seized or self.pool.used_pages:
                # pages will free (pressure release / neighbor finish);
                # the queue head retries admission next step
                self.stats.stall_events += 1
                return
            # defensive: submit() guards total size up front, so an
            # unadmittable head with an idle pool is a logic error —
            # fail that request typed instead of killing the batch
            req = self.sched.queue.popleft()
            self._record(
                req.rid, Outcome.FAILED,
                detail=f"prompt needs "
                       f"{self.pool.pages_for_len(req.prompt_len)} pages, "
                       f"pool has {self.pool.n_pages} — unadmittable")
            self.stats.failed += 1
