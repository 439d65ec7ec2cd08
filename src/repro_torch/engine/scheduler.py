"""Request queue + slot scheduler for the continuous-batching engine
(port of ``repro/engine/scheduler.py``; pure Python and numpy).

Requests wait in a FIFO queue until a batch slot frees; an admitted
request occupies its slot through (chunked) prefill and decode, tracking
its own position, generated tokens, and completion (EOS or max-new-
tokens).  The slot set is fixed-size: admission and eviction only flip
host-side state, never the step's tensor shapes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request.

    ``temperature == 0`` is greedy (the differential-oracle setting and
    the only mode the port's engine serves; ``temperature``, ``top_k``
    and ``seed`` drive sampling, ROADMAP.md module 9).
    ``deadline_steps`` bounds how many *engine steps* after submission
    the request may stay unfinished (steps, not wall time, so replays
    are deterministic); expiry yields a typed
    ``DEADLINE_EXCEEDED`` outcome and frees the slot/pages immediately.
    """
    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    deadline_steps: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.deadline_steps is not None and self.deadline_steps < 1:
            raise ValueError("deadline_steps must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)


class SlotState:
    """Runtime state of one occupied batch slot."""

    __slots__ = ("req", "admit_seq", "prefill_progress", "prefilled", "out")

    def __init__(self, req: Request, admit_seq: int):
        self.req = req
        self.admit_seq = admit_seq
        self.prefill_progress = 0      # prompt tokens computed so far
        self.prefilled = False
        self.out: List[int] = []       # generated tokens (first from prefill)

    @property
    def write_pos(self) -> int:
        """Cache position the next decode step writes (the position of
        the last generated token, which the step feeds back in)."""
        return self.req.prompt_len + len(self.out) - 1

    @property
    def n_generated(self) -> int:
        return len(self.out)

    def finished(self) -> bool:
        if not self.out:
            return False
        if len(self.out) >= self.req.max_new_tokens:
            return True
        return (self.req.eos_id is not None
                and self.out[-1] == self.req.eos_id)


class SlotScheduler:
    """Admit/evict requests over a fixed set of ``n_slots`` batch slots."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.queue: deque = deque()
        self.slots: List[Optional[SlotState]] = [None] * n_slots
        self._admit_seq = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def requeue_front(self, req: Request) -> None:
        self.queue.appendleft(req)

    def free_ids(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    def running_ids(self):
        """Slots with committed prefill, decoding."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.prefilled]

    def prefilling_ids(self):
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.prefilled]

    def occupancy(self) -> float:
        return sum(s is not None for s in self.slots) / self.n_slots

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def admit(self, slot: int, req: Request) -> SlotState:
        assert self.slots[slot] is None, slot
        st = SlotState(req, self._admit_seq)
        self._admit_seq += 1
        self.slots[slot] = st
        return st

    def evict(self, slot: int) -> SlotState:
        st = self.slots[slot]
        assert st is not None, slot
        self.slots[slot] = None
        return st

    def slot_of(self, rid: int) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is not None and s.req.rid == rid:
                return i
        return None

    def remove_queued(self, rid: int) -> Optional[Request]:
        """Drop a still-queued request (cancellation / deadline expiry
        before admission)."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                return req
        return None
