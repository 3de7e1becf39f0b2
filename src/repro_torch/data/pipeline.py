"""Deterministic, checkpointable synthetic data pipeline
(``src/repro/data/pipeline.py`` on PyTorch).

The iterator state is pure data (seed, step, per-source counters) — part of
the checkpointed *upper half*. Restoring it reproduces the exact batch
sequence, which is what makes the bit-exact-resume test (paper's Gromacs
claim: "resumed to generate exactly the same results as an uninterrupted
run") possible.

Batches are drawn on the host with the JAX package's counter-based numpy
Philox stream keyed on (seed, step), so batch ``i`` is identical in both
packages; ``next`` hands the batch back as tensors on the pipeline's
device. An encoder config's batch is the JAX pipeline's frame features,
cluster labels and mask, drawn from the same stream after the tokens.

On a mesh every rank draws the whole global batch and keeps its own rows
(``rows``, the batch dim's range of the rank's ``batch_spec`` shard), so
the rows of all ranks together are the one-device batch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..devices import resolve_device


@dataclass(frozen=True)
class DataState:
    seed: int
    step: int
    # tokens drawn per mixture source (reliability metric + restore check)
    source_counts: tuple = ()

    def to_json(self):
        return {"seed": self.seed, "step": self.step,
                "source_counts": list(self.source_counts)}

    @staticmethod
    def from_json(d):
        return DataState(d["seed"], d["step"], tuple(d["source_counts"]))


class SyntheticPipeline:
    """Mixture-of-corpora synthetic LM batches: each "source" draws
    Zipf-ish tokens from its own band of the vocabulary, so mixture
    sampling and its checkpointed counters are observable in tests.
    ``device`` (``None`` → CUDA) is where ``next`` places the batch;
    ``rows`` (a ``(start, stop)`` pair, None for all) the rows it keeps."""

    def __init__(self, cfg, *, batch, seq_len, mixture=(0.6, 0.3, 0.1),
                 device=None, rows=None):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.mixture = np.asarray(mixture, np.float64)
        self.mixture /= self.mixture.sum()
        self.device = resolve_device(device)
        self.rows = rows

    def init_state(self, seed=0):
        return DataState(seed=seed, step=0,
                         source_counts=(0,) * len(self.mixture))

    def _rng(self, state: DataState):
        # counter-based: (seed, step) fully determine the stream — O(1)
        # skip-ahead, restore-exact
        return np.random.Generator(
            np.random.Philox(key=[state.seed, state.step]))

    def next_host(self, state: DataState):
        """(``{"tokens": int32 (B, S) numpy}``, next state): the JAX
        pipeline's batch, draw for draw. An encoder's batch is
        ``{"features": f32 (B, S, d_model), "labels": int32 (B, S),
        "mask": bool (B, S)}``."""
        rng = self._rng(state)
        B, S, V = self.batch, self.seq_len, self.cfg.vocab_size
        src = rng.choice(len(self.mixture), size=(B,), p=self.mixture)
        counts = list(state.source_counts)
        bands = np.linspace(0, V, len(self.mixture) + 1).astype(np.int64)
        toks = np.empty((B, S), np.int32)
        for i in range(len(self.mixture)):
            rows = src == i
            n = int(rows.sum())
            if n == 0:
                continue
            counts[i] += n * S
            lo, hi = int(bands[i]), max(int(bands[i + 1]), int(bands[i]) + 1)
            # Zipf-flavored draw clipped into the band
            z = rng.zipf(1.3, size=(n, S)).astype(np.int64)
            toks[rows] = (lo + (z % max(hi - lo, 1))).astype(np.int32)
        new_state = replace(state, step=state.step + 1,
                            source_counts=tuple(counts))
        if self.cfg.family == "encoder":
            feats = rng.standard_normal((B, S, self.cfg.d_model),
                                        dtype=np.float32)
            mask = rng.random((B, S)) < 0.35
            return {"features": feats, "labels": toks % V,
                    "mask": mask}, new_state
        return {"tokens": toks % V}, new_state

    def next(self, state: DataState):
        """(``next_host``'s batch — this rank's ``rows`` of it — as tensors
        on the device, next state)."""
        import torch
        batch, new_state = self.next_host(state)
        if self.rows is not None:
            batch = {k: np.ascontiguousarray(v[slice(*self.rows)])
                     for k, v in batch.items()}
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}, new_state
