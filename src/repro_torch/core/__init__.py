"""The checkpoint/restart engine: save and restore of a training state
through the content-addressed store, with the device encode on CUDA."""
from .cas import ChunkStore
from .cdc import GearChunker
from .cdc_scan import GearScanner
from .checkpoint import CheckpointManager
from .policy import (CheckpointPolicy, ChunkingPolicy, CodecPolicy,
                     DurabilityPolicy, PipelinePolicy, RestorePolicy)
from .split_state import leaf_paths, tree_unflatten
from .storage import Tier, TieredStore

__all__ = [
    "CheckpointManager", "CheckpointPolicy", "ChunkStore", "ChunkingPolicy",
    "CodecPolicy", "DurabilityPolicy", "GearChunker", "GearScanner",
    "PipelinePolicy", "RestorePolicy", "Tier", "TieredStore", "leaf_paths",
    "tree_unflatten",
]
