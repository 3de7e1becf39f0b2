"""Model / run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig`` in
``src/repro/configs/<arch>.py`` using the exact assigned hyperparameters.
The config is the *only* thing the checkpoint format depends on besides the
state itself (split-state model: the lower half — mesh, executables — is
reconstructed from config at restore time, never persisted).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace

# Block kinds understood by the model zoo.
ATTN_GLOBAL = "attn_global"
ATTN_LOCAL = "attn_local"
RGLRU = "rglru"
SSM = "ssm"
BLOCK_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSM)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # hidden width of each expert MLP
    n_shared_experts: int = 0     # always-on shared experts (DeepSeek/Kimi style)
    capacity_factor: float = 1.25
    first_k_dense: int = 0        # leading layers use a dense MLP (Kimi-K2 style)
    dense_d_ff: int = 0           # d_ff of those dense layers (0 -> d_expert)
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD hyperparameters."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    """Griffin/RecurrentGemma recurrent-block hyperparameters."""
    lru_width: int = 0            # 0 -> d_model
    conv_width: int = 4
    n_lru_heads: int = 0          # 0 -> block-diagonal heads off (single head)


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- block pattern (repeats to cover n_layers) ---
    pattern: tuple = (ATTN_GLOBAL,)
    window: int = 0               # sliding window for attn_local
    causal: bool = True
    # --- attention details ---
    qk_norm: bool = False
    attn_softcap: float = 0.0     # gemma2 logit soft-capping
    final_softcap: float = 0.0    # gemma2 final-logit soft-capping
    attn_scale: float = 0.0       # 0 -> 1/sqrt(head_dim)
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0  # rope base for local layers (0 -> rope_theta)
    rope_pct: float = 1.0          # fraction of head_dim rotated (stablelm: 0.25)
    positional: str = "rope"       # rope | conv | none
    # --- mlp ---
    act: str = "silu"              # silu | gelu
    gated_mlp: bool = True
    use_bias: bool = False
    # --- norms ---
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    post_norm: bool = False        # gemma2-style post-block norms
    # --- embeddings ---
    tie_embeddings: bool = False
    embed_scale: bool = False      # multiply embeddings by sqrt(d_model) (gemma)
    # --- sub-configs ---
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    optimizer: str = "adamw"
    remat_policy: str = "nothing"  # nothing | dots | full (what to SAVE);
                                   # "dots" saves every projection output —
                                   # 58 GiB/device on gemma3 train_4k
                                   # vs ~6 GiB for "nothing"
    scan_layers: bool = True
    attn_chunk: int = 1024         # kv-chunk size for online-softmax XLA path
    attn_impl: str = "xla"         # xla | pallas (pallas = TPU target path)
    seq_shard_attn: bool = False   # set by launcher when n_heads % tp != 0:
                                   # shard attention over sequence instead of
                                   # heads (no q-chunk scan; kv replicated)
    moe_impl: str = "gspmd"        # gspmd (baseline: XLA-chosen collectives)
                                   # | shard_map (explicit EP all-to-all —
                                   #   §Perf hillclimb, ~35x collective win)
    dp_over_model: bool = False    # small-model hillclimb: batch shards over
                                   # BOTH mesh axes (pure DP; model axis
                                   # carries batch instead of idle replicas)
    seq_shard_resid: bool = False  # Megatron-SP hillclimb: residual stream
                                   # sharded over "model" on the seq dim —
                                   # norms/residuals/logits shrink by tp and
                                   # TP all-reduces become reduce-scatter +
                                   # all-gather pairs
    # --- provenance ---
    source: str = ""

    def __post_init__(self):
        for k in self.pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        if ATTN_LOCAL in self.pattern and self.window <= 0:
            raise ValueError("attn_local requires window > 0")

    # ---- derived ----
    @property
    def layer_kinds(self) -> tuple:
        """Per-layer block kind, length n_layers."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def moe_layer(self, i: int) -> bool:
        return self.moe is not None and i >= self.moe.first_k_dense

    @property
    def global_attn_fraction(self) -> float:
        kinds = self.layer_kinds
        n_attn = sum(k.startswith("attn") for k in kinds)
        if n_attn == 0:
            return 0.0
        return sum(k == ATTN_GLOBAL for k in kinds) / len(kinds)

    @property
    def subquadratic(self) -> bool:
        """True when 500k-token decode is tractable (assignment long_500k rule)."""
        kinds = set(self.layer_kinds)
        if kinds & {RGLRU, SSM}:
            return True
        # mostly-local attention (gemma3 5:1) with a bounded-window KV cache
        return self.window > 0 and self.global_attn_fraction <= 0.25


@dataclass(frozen=True)
class Stage:
    """A run of layers sharing one repeating block pattern.

    Layers inside a stage are executed with ``lax.scan`` over stacked params
    when ``repeat > 1`` — this keeps the HLO size O(pattern) instead of
    O(n_layers) (compile-time scalability for 61-layer MoEs).
    """
    kinds: tuple        # block kinds of ONE pattern repetition
    repeat: int         # number of repetitions (scan length)
    moe: bool           # MLPs in this stage are MoE
    layer_offset: int   # absolute index of first layer (for rope bases etc.)


def build_stages(cfg: ModelConfig) -> list[Stage]:
    kinds = list(cfg.layer_kinds)
    stages: list[Stage] = []
    start = 0
    # Peel leading dense layers of a MoE model into their own (unrolled) stage.
    if cfg.moe is not None and cfg.moe.first_k_dense > 0:
        k = cfg.moe.first_k_dense
        stages.append(Stage(tuple(kinds[:k]), 1, False, 0))
        start = k
    rest = kinds[start:]
    plen = len(cfg.pattern)
    n_full, rem = divmod(len(rest), plen)
    is_moe = cfg.moe is not None
    if n_full > 0:
        stages.append(Stage(tuple(rest[: plen * 1][:plen]), n_full, is_moe, start))
    if rem > 0:
        stages.append(
            Stage(tuple(rest[plen * n_full:]), 1, is_moe, start + plen * n_full)
        )
    assert sum(len(s.kinds) * s.repeat for s in stages) == cfg.n_layers
    return stages


def reduced(cfg: ModelConfig, *, seq_friendly: bool = True) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests.

    Preserves: family, pattern structure, norm/activation choices, MoE/SSM/LRU
    machinery. Shrinks: widths, depth, vocab, experts.
    """
    plen = len(cfg.pattern)
    n_layers = max(plen + 1, 3) if plen > 1 else 2
    moe = None
    if cfg.moe is not None:
        moe = replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_expert=64,
            first_k_dense=min(cfg.moe.first_k_dense, 1), dense_d_ff=96,
        )
        if cfg.moe.first_k_dense > 0:
            n_layers = max(n_layers, 2)
    ssm = replace(cfg.ssm, d_state=16, head_dim=16, chunk_size=32) if cfg.ssm else None
    rglru = replace(cfg.rglru, lru_width=64) if cfg.rglru else None
    return replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=96,
        vocab_size=128,
        window=min(cfg.window, 16) if cfg.window else 0,
        moe=moe,
        ssm=ssm,
        rglru=rglru,
        dtype="float32",
        attn_chunk=32 if seq_friendly else cfg.attn_chunk,
        remat_policy="nothing",
    )


# ---------------------------------------------------------------------------
# Analytic parameter counts (for 6·N·D model-FLOPs roofline terms).
# ---------------------------------------------------------------------------

def param_counts(cfg: ModelConfig) -> dict:
    """Analytic total / active parameter counts (embedding included in total,
    excluded from `n_active_matmul` which feeds 6·N·D)."""
    d = cfg.d_model
    total = 0
    active = 0  # per-token matmul-participating params
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    for i, kind in enumerate(cfg.layer_kinds):
        # block mixer
        if kind.startswith("attn"):
            qkv = d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim
            out = cfg.n_heads * cfg.head_dim * d
            blk = qkv + out
        elif kind == RGLRU:
            w = cfg.rglru.lru_width or d
            # two input branches + output proj + conv + lru gates
            blk = 2 * d * w + w * d + cfg.rglru.conv_width * w + 3 * w
        elif kind == SSM:
            s = cfg.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            zxbcdt = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
            blk = zxbcdt + d_in * d + s.d_conv * (d_in + 2 * s.n_groups * s.d_state) + 3 * nh
        else:  # pragma: no cover
            raise ValueError(kind)
        total += blk
        active += blk
        # mlp
        mult = 3 if cfg.gated_mlp else 2
        if cfg.moe_layer(i):
            m = cfg.moe
            e_p = mult * d * m.d_expert
            total += m.n_experts * e_p + m.n_shared_experts * e_p + d * m.n_experts
            active += (m.top_k + m.n_shared_experts) * e_p + d * m.n_experts
        else:
            ff = (cfg.moe.dense_d_ff or cfg.d_ff) if (cfg.moe and not cfg.moe_layer(i)) else cfg.d_ff
            if kind == SSM:
                ff = 0  # mamba2 blocks have no separate MLP
            total += mult * d * ff
            active += mult * d * ff
    return {
        "n_total": total + embed,
        "n_active": active + embed,
        "n_total_matmul": total,
        "n_active_matmul": active,
        "n_embed": embed,
    }
