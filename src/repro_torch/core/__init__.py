"""Artifact format and eq.-14 accounting (port of ``repro.core``)."""
from repro_torch.core.compression import (ArtifactError, PackedLayout,
                                          PackedLeaf, PackedModel,
                                          bits_per_index)

__all__ = ["ArtifactError", "PackedLayout", "PackedLeaf", "PackedModel",
           "bits_per_index"]
