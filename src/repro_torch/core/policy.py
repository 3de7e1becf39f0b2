"""Composable checkpoint policy objects — the production configuration
surface of the C/R system.

The paper's production-hardening lesson (and the MANA restart-agnosticism
follow-on) is that a restarted job must not depend on the caller
reconstructing the writer's environment by hand. Two consequences shape
this module:

  * the public API is a handful of small, frozen, composable policy
    dataclasses instead of a flat kwarg namespace — ``ChunkingPolicy``
    (scheme, sizes, candidate-scan backend), ``PipelinePolicy`` (chunk-IO
    width, the bounded multi-round persist queue, host snapshot byte
    budget, read-cache budget, drain mode), ``DurabilityPolicy``
    (replicas, retention, coordinator timeouts/retries) and
    ``CodecPolicy``, composed into one validated ``CheckpointPolicy``;
  * the policy travels WITH the data: manifest v6 embeds the writer's
    effective policy (``to_dict``/``from_dict`` round-trip), so restore
    and the inspector adopt the writer's chunking/scan/codec settings
    with zero caller configuration — a caller whose config drifted from
    the history it restores cannot silently mis-deduplicate against it.

Every legacy flat ``CheckpointManager`` kwarg maps onto exactly one
policy field (``from_legacy_kwargs``, one ``DeprecationWarning`` per
construction); ``with_overrides`` merges flat CLI-style overrides and
``from_env`` merges ``REPRO_CKPT_*`` environment overrides on top of any
base policy.
"""
from __future__ import annotations

import warnings
from dataclasses import asdict, dataclass, field, fields

from . import cdc_scan
from . import codec as codec_mod
from .cas import DEFAULT_CHUNK_SIZE
from .chunk_exec import DEFAULT_IO_THREADS
from .errors import CodecUnavailableError
from .storage import DEFAULT_REMOTE_PART_BYTES

MODES = ("full", "incremental")
CHUNKINGS = ("fixed", "cdc")

DEFAULT_READ_CACHE_BYTES = 1 << 30
ENV_PREFIX = "REPRO_CKPT_"


@dataclass(frozen=True)
class ChunkingPolicy:
    """How encoded shard payloads become CAS chunks.

    ``chunk_size`` is the fixed size for ``scheme="fixed"`` and the
    content-defined AVERAGE for ``scheme="cdc"`` (min/avg/max default to
    size/4, size, size*4 — FastCDC normalization — unless ``min_size`` /
    ``max_size`` pin them). ``scan_backend`` picks the CDC candidate-scan
    engine (``core.cdc_scan``); the serial engine is always pinned to the
    numpy oracle regardless."""
    scheme: str = "fixed"
    chunk_size: int = DEFAULT_CHUNK_SIZE
    min_size: int | None = None
    max_size: int | None = None
    scan_backend: str = "auto"

    def __post_init__(self):
        if self.scheme not in CHUNKINGS:
            raise ValueError(f"chunking must be one of {CHUNKINGS}, "
                             f"got {self.scheme!r}")
        if int(self.chunk_size) <= 0:
            raise ValueError("chunk_size must be positive")
        if self.scan_backend not in cdc_scan.BACKENDS:
            raise ValueError(
                f"scan_backend must be one of {cdc_scan.BACKENDS}, "
                f"got {self.scan_backend!r}")


@dataclass(frozen=True)
class PipelinePolicy:
    """Concurrency shape of the save/restore engines.

    ``io_threads=1`` is the serial reference engine (it also forces
    ``persist_queue_depth`` to 1 and the numpy CDC scan — the baseline
    stays byte-for-byte). ``persist_queue_depth`` bounds how many
    overlapped rounds may be in flight at once (snapshot round N+1 while
    round N persists); ``host_bytes_budget`` caps the aggregate host
    snapshot bytes those rounds may pin (admission blocks the next
    snapshot rather than OOMing the host). ``async_drain=None`` leaves
    the store's drain mode as constructed."""
    io_threads: int = DEFAULT_IO_THREADS
    persist_queue_depth: int = 1
    host_bytes_budget: int | None = None
    read_cache_bytes: int = DEFAULT_READ_CACHE_BYTES
    async_drain: bool | None = None

    def __post_init__(self):
        if int(self.persist_queue_depth) < 1:
            raise ValueError("persist_queue_depth must be >= 1")
        if self.host_bytes_budget is not None \
                and int(self.host_bytes_budget) <= 0:
            raise ValueError("host_bytes_budget must be positive or None")
        if int(self.read_cache_bytes) <= 0:
            raise ValueError("read_cache_bytes must be positive")

    @property
    def serial(self) -> bool:
        return int(self.io_threads) <= 1

    @property
    def effective_queue_depth(self) -> int:
        """The serial engine is pinned to depth 1 (serial-baseline purity)."""
        return 1 if self.serial else int(self.persist_queue_depth)


@dataclass(frozen=True)
class DurabilityPolicy:
    """Redundancy, retention and the coordinator's failure clocks.

    The ``io_*`` trio is the typed retry budget (``resilience``): up to
    `io_retries` same-tier re-attempts per transient ``OSError``, with
    decorrelated jitter starting at `io_backoff_ms`, and every retry
    sleep of one round drawing from a single shared `io_deadline_s`
    budget so a sick tier bounds the aggregate stall, not
    retries × fault sites. Consumed only by the pipelined engine — the
    serial (``io_threads=1``) engine stays fail-fast (serial-baseline purity)."""
    replicas: int = 1                   # 2 = buddy redundancy
    retain: int = 3
    keepalive_s: float = 10.0
    save_timeout_s: float = 600.0
    max_retries: int = 1
    io_retries: int = 2
    io_backoff_ms: float = 5.0
    io_deadline_s: float = 30.0


@dataclass(frozen=True)
class CodecPolicy:
    """Shard payload encodings. ``None`` resolves to the best codec the
    environment supports (zstd with the optional ``zstandard`` package,
    raw otherwise); ``params_codec`` defaults to ``codec`` (int8 opt-in).

    ``device_precondition`` controls whether a byteplane codec's forward
    transform runs ON DEVICE, fused into the CDC scan dispatch (the
    tentpole fusion): ``None`` (auto) enables it on the pipelined engine
    and never on the serial engine (host numpy purity); ``False`` forces
    the host oracle encoder everywhere. A MACHINE-LOCAL performance knob:
    the stored bytes are identical either way, so manifest adoption keeps
    the reader's own setting.

    ``device_entropy`` is the same knob for the chunk-encoded codecs'
    plane entropy stage (byteplane-rle / byteplane-rans): ``None``
    (auto) fuses RLE/rANS coding into the same device dispatch so chunks
    reach the host pre-compressed; ``False`` keeps the scan/transform
    fusion but runs the entropy stage through the host oracle. Equally
    machine-local — every backend is byte-identical."""
    codec: str | None = None
    params_codec: str | None = None
    device_precondition: bool | None = None
    device_entropy: bool | None = None

    def __post_init__(self):
        for c in (self.codec, self.params_codec):
            if c is not None and c not in codec_mod.CODECS:
                raise ValueError(f"unknown codec {c!r}")

    def precondition_enabled(self, serial: bool) -> bool:
        """Effective device_precondition for an engine: the serial engine
        is always pinned to the host path (serial-baseline purity)."""
        if serial:
            return False
        return True if self.device_precondition is None \
            else bool(self.device_precondition)

    def entropy_enabled(self, serial: bool) -> bool:
        """Effective device_entropy for an engine — same pinning rules as
        ``precondition_enabled``: the serial engine always takes the host
        oracle path."""
        if serial:
            return False
        return True if self.device_entropy is None \
            else bool(self.device_entropy)

    def resolved(self) -> tuple:
        """(codec, params_codec) with defaults resolved against THIS
        environment; raises ``CodecUnavailableError`` when a requested
        codec needs a package the environment lacks."""
        codec = self.codec or codec_mod.default_codec()
        params = self.params_codec or codec
        for c in {codec, params}:
            if not codec_mod.available(c):
                # fail fast with the real cause — otherwise every writer
                # rank dies on encode and the save aborts with an opaque
                # "no surviving writer ranks"
                raise CodecUnavailableError(
                    "codec requires the optional `zstandard` package "
                    "(pip install 'repro[compress]')", codec=c)
        return codec, params


@dataclass(frozen=True)
class RestorePolicy:
    """Read-side behaviour — reader-LOCAL, like pipeline/durability: the
    manifest adoption path never takes these from a writer's embedded
    policy, because the writer's streaming choice must not change a
    reader's restore semantics.

    ``streaming=True`` makes the trainer restore through
    ``CheckpointManager.restore_streaming``: leaves release to device
    placement as they land (first-use order) and step 0 begins once the
    frontier — the first ``frontier_classes`` distinct first-use classes,
    embedding + block 0 by default — is resident, with every later touch
    of an un-landed leaf blocking on its future (bit-exact by
    construction). ``remote_part_bytes`` sizes the remote tier's
    multipart ranged GETs."""
    streaming: bool = False
    frontier_classes: int = 2
    remote_part_bytes: int = DEFAULT_REMOTE_PART_BYTES

    def __post_init__(self):
        if int(self.frontier_classes) < 1:
            raise ValueError("frontier_classes must be >= 1")
        if int(self.remote_part_bytes) <= 0:
            raise ValueError("remote_part_bytes must be positive")


_SECTIONS = {"chunking": ChunkingPolicy, "pipeline": PipelinePolicy,
             "durability": DurabilityPolicy, "codec": CodecPolicy,
             "restore": RestorePolicy}

# flat-name → policy-field map: the legacy CheckpointManager kwargs plus
# the newer pipeline knobs, shared by the legacy shim, CLI merging and
# environment overrides
FLAT_FIELDS = {
    "mode": ("mode",),
    "n_writers": ("n_writers",),
    "chunking": ("chunking", "scheme"),
    "chunk_size": ("chunking", "chunk_size"),
    "min_chunk_size": ("chunking", "min_size"),
    "max_chunk_size": ("chunking", "max_size"),
    "scan_backend": ("chunking", "scan_backend"),
    "io_threads": ("pipeline", "io_threads"),
    "persist_queue_depth": ("pipeline", "persist_queue_depth"),
    "host_bytes_budget": ("pipeline", "host_bytes_budget"),
    "read_cache_bytes": ("pipeline", "read_cache_bytes"),
    "async_drain_to_slow": ("pipeline", "async_drain"),
    "replicas": ("durability", "replicas"),
    "retain": ("durability", "retain"),
    "keepalive_s": ("durability", "keepalive_s"),
    "save_timeout_s": ("durability", "save_timeout_s"),
    "max_retries": ("durability", "max_retries"),
    "io_retries": ("durability", "io_retries"),
    "io_backoff_ms": ("durability", "io_backoff_ms"),
    "io_deadline_s": ("durability", "io_deadline_s"),
    "codec": ("codec", "codec"),
    "params_codec": ("codec", "params_codec"),
    "device_precondition": ("codec", "device_precondition"),
    "device_entropy": ("codec", "device_entropy"),
    "streaming_restore": ("restore", "streaming"),
    "restore_frontier_classes": ("restore", "frontier_classes"),
    "remote_part_bytes": ("restore", "remote_part_bytes"),
}

# exactly the pre-policy CheckpointManager.__init__ kwargs, in their
# historical signature order — the deprecation shim accepts these and
# nothing else
LEGACY_KWARGS = (
    "n_writers", "codec", "params_codec", "replicas", "retain",
    "keepalive_s", "save_timeout_s", "max_retries", "async_drain_to_slow",
    "mode", "chunk_size", "chunking", "scan_backend", "io_threads",
)

_ENV_INT = {"n_writers", "chunk_size", "min_chunk_size", "max_chunk_size",
            "io_threads", "persist_queue_depth", "host_bytes_budget",
            "read_cache_bytes", "replicas", "retain", "max_retries",
            "io_retries", "restore_frontier_classes", "remote_part_bytes"}
_ENV_FLOAT = {"keepalive_s", "save_timeout_s", "io_backoff_ms",
              "io_deadline_s"}
_ENV_BOOL = {"async_drain_to_slow", "streaming_restore",
             "device_precondition", "device_entropy"}


@dataclass(frozen=True)
class CheckpointPolicy:
    """The validated, composed checkpoint configuration —
    ``CheckpointManager(store, policy=CheckpointPolicy(...))`` is the
    canonical constructor. Section fields accept the dataclass or a plain
    dict (``from_dict`` convenience)."""
    mode: str = "full"
    n_writers: int = 4
    chunking: ChunkingPolicy = field(default_factory=ChunkingPolicy)
    pipeline: PipelinePolicy = field(default_factory=PipelinePolicy)
    durability: DurabilityPolicy = field(default_factory=DurabilityPolicy)
    codec: CodecPolicy = field(default_factory=CodecPolicy)
    restore: RestorePolicy = field(default_factory=RestorePolicy)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        for name, cls in _SECTIONS.items():
            v = getattr(self, name)
            if isinstance(v, dict):
                object.__setattr__(self, name, cls(**v))
            elif not isinstance(v, cls):
                raise TypeError(f"{name} must be a {cls.__name__} or a "
                                f"dict, got {type(v).__name__}")

    # ------------------------------------------------------------------
    # serialization (manifest v6 embeds the writer's policy)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CheckpointPolicy":
        """Lenient inverse of ``to_dict``: unknown keys are ignored
        (manifests written by NEWER code stay readable), missing keys
        take their defaults. Values are still validated — garbage raises,
        and callers reading untrusted manifests catch + warn."""
        if not isinstance(d, dict):
            raise TypeError("policy must be a mapping, "
                            f"got {type(d).__name__}")
        kw: dict = {}
        if "mode" in d:
            kw["mode"] = d["mode"]
        if "n_writers" in d:
            kw["n_writers"] = int(d["n_writers"])
        for name, klass in _SECTIONS.items():
            sub = d.get(name)
            if sub is None:
                continue
            if not isinstance(sub, dict):
                raise TypeError(f"policy section {name!r} must be a "
                                f"mapping, got {type(sub).__name__}")
            known = {f.name for f in fields(klass)}
            kw[name] = klass(**{k: v for k, v in sub.items() if k in known})
        return cls(**kw)

    # ------------------------------------------------------------------
    # flat-override merging (legacy kwargs, CLI flags, env vars)
    # ------------------------------------------------------------------
    def with_overrides(self, **flat) -> "CheckpointPolicy":
        """Merge flat overrides (the legacy kwarg names plus the newer
        pipeline knobs, see ``FLAT_FIELDS``) onto this policy. ``None``
        values are skipped — an unset CLI flag never clobbers the base."""
        top = {"mode": self.mode, "n_writers": self.n_writers}
        secs = {name: dict(vars(getattr(self, name)).items())
                for name in _SECTIONS}
        for k, v in flat.items():
            path = FLAT_FIELDS.get(k)
            if path is None:
                raise TypeError(f"unknown checkpoint policy override {k!r}")
            if v is None:
                continue
            if len(path) == 1:
                top[path[0]] = v
            else:
                secs[path[0]][path[1]] = v
        return CheckpointPolicy(
            mode=top["mode"], n_writers=top["n_writers"],
            **{name: cls(**secs[name]) for name, cls in _SECTIONS.items()})

    @classmethod
    def from_legacy_kwargs(cls, **kwargs) -> "CheckpointPolicy":
        """The deprecation shim behind ``CheckpointManager(store, mode=...,
        chunking=..., ...)``: every historical flat kwarg maps onto its
        policy field with identical validation and defaults. Emits exactly
        ONE ``DeprecationWarning`` per call, however many kwargs ride it."""
        unknown = sorted(set(kwargs) - set(LEGACY_KWARGS))
        if unknown:
            raise TypeError(
                f"unexpected keyword argument(s) {unknown}; pass a "
                f"CheckpointPolicy (policy=) for non-legacy configuration")
        warnings.warn(
            "flat CheckpointManager kwargs are deprecated; pass "
            "CheckpointManager(store, policy=CheckpointPolicy(...)) "
            f"instead (got legacy: {sorted(kwargs)})",
            DeprecationWarning, stacklevel=3)
        return cls().with_overrides(**kwargs)

    @classmethod
    def from_env(cls, env=None, *, base: "CheckpointPolicy | None" = None,
                 prefix: str = ENV_PREFIX) -> "CheckpointPolicy":
        """Merge ``REPRO_CKPT_<FLAT_NAME>`` environment overrides onto
        ``base`` (default policy when None) — e.g. ``REPRO_CKPT_IO_THREADS=8``,
        ``REPRO_CKPT_PERSIST_QUEUE_DEPTH=2``. Empty values are ignored."""
        if env is None:
            import os
            env = os.environ
        flat: dict = {}
        for name in FLAT_FIELDS:
            raw = env.get(prefix + name.upper())
            if raw is None or raw == "":
                continue
            if name in _ENV_INT:
                flat[name] = int(raw)
            elif name in _ENV_FLOAT:
                flat[name] = float(raw)
            elif name in _ENV_BOOL:
                flat[name] = raw.strip().lower() in ("1", "true", "yes", "on")
            else:
                flat[name] = raw
        return (base or cls()).with_overrides(**flat)


def policy_from_manifest(manifest: dict) -> CheckpointPolicy | None:
    """The policy a v6 manifest embeds: ``None`` when absent (v≤5
    manifests), the parsed ``CheckpointPolicy`` otherwise. A corrupted
    block RAISES — callers (restore adoption, the inspector) degrade it
    to a warning; the shard records stay self-describing either way."""
    block = manifest.get("policy")
    if block is None:
        return None
    return CheckpointPolicy.from_dict(block)
