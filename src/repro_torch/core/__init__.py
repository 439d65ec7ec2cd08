"""Artifact format, eq.-14 accounting and the C step (port of
``repro.core``; the C step's modules are imported by name:
``core.plan``, ``core.lc``, ``core.schemes``, ``core.baselines``)."""
from repro_torch.core.compression import (ArtifactError, PackedLayout,
                                          PackedLeaf, PackedModel,
                                          bits_per_index)

__all__ = ["ArtifactError", "PackedLayout", "PackedLeaf", "PackedModel",
           "bits_per_index"]
