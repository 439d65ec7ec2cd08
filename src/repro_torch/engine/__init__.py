"""Serving loops of the port (``repro.engine``): the continuous-batching
engine over dense KV pages and the one-shot lockstep loop it is held
against.

* :mod:`repro_torch.engine.scheduler` — request queue + slot scheduler;
* :mod:`repro_torch.engine.kvcache`   — fixed-size page pool + per-slot
  tables, page footprints;
* :mod:`repro_torch.engine.sampling`  — per-slot greedy sampling with the
  non-finite row flag;
* :mod:`repro_torch.engine.engine`    — the step loop (blockwise prefill
  + decode under a per-step token budget);
* :mod:`repro_torch.engine.oneshot`   — the one-shot greedy loop, the
  engine's oracle;
* :mod:`repro_torch.engine.outcomes`  — typed per-request outcomes.

Not ported yet: sampling beyond greedy (ROADMAP.md module 9), snapshot /
restore and the chaos harness (module 10).
"""
from repro_torch.engine.engine import Engine, EngineStats
from repro_torch.engine.kvcache import (PagePool, equal_hbm_slots,
                                        kv_page_footprint)
from repro_torch.engine.oneshot import (greedy_generate, grow_caches,
                                        truncate_at_eos)
from repro_torch.engine.outcomes import Outcome, RequestResult
from repro_torch.engine.sampling import sample_and_flag, sample_tokens
from repro_torch.engine.scheduler import Request, SlotScheduler

__all__ = ["Engine", "EngineStats", "PagePool", "Request", "SlotScheduler",
           "greedy_generate", "grow_caches", "truncate_at_eos",
           "sample_tokens", "sample_and_flag", "Outcome", "RequestResult",
           "kv_page_footprint", "equal_hbm_slots"]
