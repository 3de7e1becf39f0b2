"""The checkpoint/restart engine: save and restore of a training state
through the content-addressed store, with the device encode on CUDA, and
the reliability plane around it (fault injection, scrub and degraded
commit, WeightSync). Exports the JAX package's ``repro.core`` names."""
from .atomic import CrashInjector, CrashPoint
from .cas import ChunkStore
from .cdc import GearChunker
from .cdc_scan import GearScanner
from .checkpoint import CheckpointManager
from .chunk_exec import ChunkIOExecutor
from .coordinator import CheckpointCoordinator
from .drain import DrainCounters, quiesce_device_state
from .errors import (AbortedError, CASError, CkptError, CodecUnavailableError,
                     CorruptShardError, MissingShardError, NamespaceError,
                     NoCheckpointError, RegistryMismatchError, SpaceError)
from .faults import FaultPlane, FaultSpec, FaultyTier, wrap_store
from .policy import (CheckpointPolicy, ChunkingPolicy, CodecPolicy,
                     DurabilityPolicy, PipelinePolicy, RestorePolicy)
from .preempt import PreemptionGuard, PreemptQueue
from .resilience import (CircuitBreaker, Deadline, RemoteInconsistencyError,
                         RetryPolicy, TierHealth, is_tier_full, is_transient,
                         retry_io)
from .restore_path import (ReadCache, RestorePlan, RestoreSession,
                           RestoreStream)
from .save_path import PersistStage, SavePlan, SaveSession
from .split_state import (abstract_train_state, config_digest,
                          init_train_state, leaf_paths,
                          lower_half_descriptor, state_shardings,
                          tree_unflatten)
from .storage import RemoteTier, Tier, TieredStore, default_store
from .weightsync import (PeerTier, WeightPublisher, WeightSubscriber,
                         build_fleet)

__all__ = [
    "AbortedError", "CASError", "CheckpointCoordinator", "CheckpointManager",
    "CheckpointPolicy", "ChunkIOExecutor", "ChunkStore", "ChunkingPolicy",
    "CircuitBreaker", "CkptError", "CodecPolicy", "CodecUnavailableError",
    "CorruptShardError", "CrashInjector", "CrashPoint", "Deadline",
    "DrainCounters", "DurabilityPolicy", "FaultPlane", "FaultSpec",
    "FaultyTier", "GearChunker", "GearScanner",
    "MissingShardError", "NamespaceError",
    "NoCheckpointError", "PeerTier", "PersistStage", "PipelinePolicy",
    "PreemptQueue", "PreemptionGuard",
    "ReadCache", "RegistryMismatchError", "RemoteInconsistencyError",
    "RemoteTier", "RestorePlan",
    "RestorePolicy", "RestoreSession", "RestoreStream", "RetryPolicy",
    "SavePlan", "SaveSession", "SpaceError", "Tier", "TierHealth",
    "TieredStore", "WeightPublisher", "WeightSubscriber",
    "abstract_train_state", "build_fleet", "config_digest", "default_store",
    "init_train_state", "is_tier_full", "is_transient", "leaf_paths",
    "lower_half_descriptor",
    "quiesce_device_state", "retry_io", "state_shardings", "wrap_store",
]
