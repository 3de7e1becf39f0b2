"""Serving launcher with a checkpointable serving state
(``src/repro/launch/serve.py`` on PyTorch).

The paper's preempt-queue use case applied to inference: a low-priority
serving job must vacate its node for real-time work. The serving upper
half — params, KV caches, the generated-token buffer and its cursor —
checkpoints mid-decode through the port's ``CheckpointManager``, and a
resumed run (of either package: the tree and its leaf names are the JAX
package's) finishes token-exact.

    python -m repro_torch.launch.serve --arch gemma3-1b --requests 8

Runs on the CUDA card unless ``--device cpu`` (``run(device="cpu")``).
The JAX launcher's ``--weight-sync`` hot-swap is not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from ..configs import ARCH_IDS, get_config, reduced
from ..core.checkpoint import CheckpointManager
from ..core.policy import CheckpointPolicy
from ..core.storage import default_store
from ..devices import resolve_device
from ..models import Model
from ..train.steps import make_serve_fns

log = logging.getLogger("repro_torch.serve")


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str, *, n_requests=8, prompt_len=32, gen_len=32,
        workdir="runs/serve", ckpt_every=16, preempt_at=None,
        full_config=False, seed=0, device=None):
    """Greedy-serve `n_requests` prompts of `prompt_len` tokens (from
    ``np.random.default_rng(seed)``, as the JAX launcher draws them) for
    `gen_len` tokens, checkpointing the serving state every `ckpt_every`
    tokens and at `preempt_at` (then returning ``status="preempted"``).
    A run whose store already holds a checkpoint resumes from the newest.
    Returns the JAX launcher's report plus timings: ``prefill_s``,
    ``decode_s``, ``tok_per_s``, ``save_s``/``save_bytes`` (last save) and
    ``restore_s``."""
    import torch
    cfg = get_config(arch) if full_config else reduced(get_config(arch))
    dev = resolve_device(device)
    model = Model(cfg)
    prefill_fn, decode_fn, _ = make_serve_fns(model)
    manager = CheckpointManager(default_store(f"{workdir}/{arch}"),
                                CheckpointPolicy(n_writers=2), device=dev)
    rep = {}
    try:
        rng = np.random.default_rng(seed)
        prompts = rng.integers(0, cfg.vocab_size, (n_requests, prompt_len),
                               dtype=np.int32)
        cache_len = prompt_len + gen_len
        latest = manager.latest_step()
        if latest is None:
            params = model.init(seed=seed, device=dev)
            t0 = time.monotonic()
            tok, cache = prefill_fn(params, torch.from_numpy(prompts).to(dev),
                                    cache_len=cache_len)
            out = np.full((n_requests, gen_len), -1, np.int32)
            out[:, 0] = tok.cpu().numpy()
            rep["prefill_s"] = time.monotonic() - t0
            cursor = 1
            log.info("prefilled %d requests", n_requests)
        else:
            abstract = {
                "params": model.abstract_params(),
                "cache": model.init_cache(n_requests, cache_len,
                                          device="meta"),
                "out_tokens": torch.empty((n_requests, gen_len),
                                          dtype=torch.int32, device="meta"),
                "cursor": torch.empty((), dtype=torch.int32, device="meta")}
            t0 = time.monotonic()
            state, _ = manager.restore(abstract, step=latest)
            _sync(dev)
            rep["restore_s"] = time.monotonic() - t0
            params, cache = state["params"], state["cache"]
            out = state["out_tokens"].cpu().numpy().copy()
            cursor = int(state["cursor"])
            log.info("restored serving state at token %d", cursor)

        def save():
            state = {"params": params, "cache": cache,
                     "out_tokens": torch.from_numpy(out.copy()).to(dev),
                     "cursor": torch.tensor(cursor, dtype=torch.int32,
                                            device=dev)}
            t = time.monotonic()
            r = manager.save(state, cursor, extra={"arch": arch})
            rep["save_s"], rep["save_bytes"] = time.monotonic() - t, \
                r["bytes"]
            return r

        t0 = time.monotonic()
        start = cursor
        while cursor < gen_len:
            tok, cache = decode_fn(params, cache,
                                   torch.from_numpy(out[:, cursor - 1])
                                   .to(dev))
            out[:, cursor] = tok.cpu().numpy()
            cursor += 1
            if ckpt_every and cursor % ckpt_every == 0:
                r = save()
                log.info("serving checkpoint @token %d (%.2fs, %.1f MB)",
                         cursor, r["seconds"], r["bytes"] / 1e6)
            if preempt_at is not None and cursor == preempt_at:
                if not (ckpt_every and cursor % ckpt_every == 0):
                    save()
                log.info("preempted at token %d — state persisted", cursor)
                rep.update(status="preempted", cursor=cursor, tokens=out)
                return rep
        dt = time.monotonic() - t0
        rep.update(status="completed", cursor=cursor, tokens=out,
                   decode_s=dt,
                   tok_per_s=n_requests * (gen_len - start) / max(dt, 1e-9))
        return rep
    finally:
        manager.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--workdir", default="runs/serve")
    ap.add_argument("--ckpt-every", type=int, default=16)
    ap.add_argument("--preempt-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rep = run(args.arch, n_requests=args.requests,
              prompt_len=args.prompt_len, gen_len=args.gen_len,
              workdir=args.workdir, ckpt_every=args.ckpt_every,
              preempt_at=args.preempt_at, device=args.device)
    print({k: v for k, v in rep.items() if k != "tokens"})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
