"""Typed per-request outcomes — the engine's failure-isolation contract
(port of ``repro/engine/outcomes.py``; pure Python and numpy).

Every request submitted to the engine ends in exactly one
:class:`Outcome`, recorded as a :class:`RequestResult` in
``Engine.results``.  Nothing about one request's fate may corrupt a
neighbor: an unservable prompt is *rejected* before any page is
reserved, a poisoned slot is *quarantined* while the rest of the batch
keeps decoding, and every request that reaches ``FINISHED`` carries the
stream the one-shot oracle gives.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class Outcome(enum.Enum):
    """Terminal state of one request."""

    FINISHED = "finished"                    # full stream delivered
    REJECTED_TOO_LARGE = "rejected_too_large"    # can never fit max_seq/pool
    REJECTED_BACKPRESSURE = "rejected_backpressure"  # bounded queue full
    CANCELLED = "cancelled"                  # client cancel; pages freed
    DEADLINE_EXCEEDED = "deadline_exceeded"  # per-request deadline expired
    FAILED = "failed"                        # quarantined / budget exhausted

    @property
    def ok(self) -> bool:
        return self is Outcome.FINISHED


@dataclasses.dataclass
class RequestResult:
    """One request's terminal record.

    ``tokens`` holds the delivered stream for ``FINISHED`` and whatever
    partial prefix existed at termination otherwise (empty for
    rejections).  ``detail`` is the human-readable reason for every
    non-``FINISHED`` outcome.
    """

    rid: int
    outcome: Outcome
    tokens: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))
    detail: str = ""
    n_preemptions: int = 0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)

    @property
    def ok(self) -> bool:
        return self.outcome.ok
