"""Serving loops of the port.  Slice 1 ports the one-shot loop; the
continuous-batching engine is ROADMAP.md module 5."""
from repro_torch.engine.oneshot import (greedy_generate, grow_caches,
                                        truncate_at_eos)

__all__ = ["greedy_generate", "grow_caches", "truncate_at_eos"]
