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

With ``--weight-sync <store-root>`` the server also subscribes to a
trainer-side ``WeightPublisher``: before every decode step it polls the
store's announcement, pulls only the chunks its cache misses, and on a new
flip copies the flipped host set into the served parameter tensors on the
device — serving never blocks on a full restore, and a failed sync holds
the last-good weights.
"""
from __future__ import annotations

import argparse
import dataclasses
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


def _hot_swap(params, sub, last_step, ws: dict, dev):
    """Poll the WeightSync subscriber before a decode step and, on a new
    flip, copy the flipped host tensors into the served parameter tensors
    (leaf names match ``leaf_paths`` under the ``params/`` root — the
    naming the publisher's manifest uses): one H2D copy per flip, none per
    poll. A leaf missing from the flipped set (or of another shape) holds
    the serving params as they are; a failed sync already held the
    subscriber's last-good set. Accumulates the poll and copy times in
    `ws`."""
    import torch

    from ..core.split_state import leaf_paths
    t0 = time.monotonic()
    sub.sync()
    step, arrays = sub.current()
    dt = time.monotonic() - t0
    ws["polls"] += 1
    ws["sync_s"] += dt
    if step is None or step == last_step:
        return last_step
    ws["flip_sync_s"] += dt
    leaves = leaf_paths({"params": params})
    missing = [n for n, leaf in leaves if n not in arrays
               or tuple(arrays[n].shape) != tuple(leaf.shape)]
    if missing:
        log.warning("weight-sync step %s misses %d leaf(s) (e.g. %s) — "
                    "holding current params", step, len(missing),
                    missing[0])
        return last_step
    t0 = time.monotonic()
    with torch.no_grad():
        for name, leaf in leaves:
            leaf.copy_(arrays[name])
    _sync(dev)
    ws["swaps"] += 1
    ws["swap_s"] += time.monotonic() - t0
    ws["flip_blocking_s"] += sub.counters["last_flip_blocking_s"]
    log.info("hot-swapped params to published step %s", step)
    return step


def run(arch: str, *, n_requests=8, prompt_len=32, gen_len=32,
        workdir="runs/serve", ckpt_every=16, preempt_at=None,
        full_config=False, n_layers=None, seed=0, weight_sync=None,
        weight_sync_name=None, device=None):
    """Greedy-serve `n_requests` prompts of `prompt_len` tokens (from
    ``np.random.default_rng(seed)``, as the JAX launcher draws them) for
    `gen_len` tokens, checkpointing the serving state every `ckpt_every`
    tokens and at `preempt_at` (then returning ``status="preempted"``).
    A run whose store already holds a checkpoint resumes from the newest.
    Returns the JAX launcher's report plus timings: ``prefill_s``,
    ``decode_s``, ``tok_per_s``, ``save_s``/``save_bytes`` (last save) and
    ``restore_s``. `n_layers` cuts the config's depth (its first
    `n_layers` layers, at its widths). An encoder has no decode path and
    is refused, as in the JAX launcher.

    `weight_sync` (a publisher's store root) hot-swaps published params
    before every decode step (``_hot_swap``); the completed report then
    carries ``weight_sync_step`` (the last flipped step, as the JAX
    launcher's), the served ``params`` and ``weight_sync``: polls, swaps
    (flips copied in), the seconds in ``sync()`` (all polls, and those
    that flipped), the copy seconds and the flips' blocking seconds."""
    import torch
    cfg = get_config(arch) if full_config else reduced(get_config(arch))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode serving path")
    dev = resolve_device(device)
    model = Model(cfg)
    prefill_fn, decode_fn, _ = make_serve_fns(model)
    manager = CheckpointManager(default_store(f"{workdir}/{arch}"),
                                CheckpointPolicy(n_writers=2), device=dev)
    rep = {}
    sub, ws_step = None, None
    ws = dict(polls=0, swaps=0, sync_s=0.0, flip_sync_s=0.0, swap_s=0.0,
              flip_blocking_s=0.0)
    try:
        if weight_sync is not None:
            from ..core.storage import Tier, TieredStore
            from ..core.weightsync import WeightSubscriber
            sub = WeightSubscriber(
                TieredStore(Tier("ws-src", weight_sync)),
                f"{workdir}/{arch}/ws-cache",
                name=weight_sync_name or f"serve-{arch}",
                leaf_filter=lambda n: n.startswith("params/"))
            log.info("weight-sync: subscribed to %s", weight_sync)
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
            if sub is not None:
                ws_step = _hot_swap(params, sub, ws_step, ws, dev)
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
        if sub is not None:
            rep.update(weight_sync_step=ws_step, weight_sync=ws,
                       params=params)
        return rep
    finally:
        if sub is not None:
            sub.close()
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
    ap.add_argument("--weight-sync", default=None, metavar="STORE_ROOT",
                    help="subscribe to a WeightSync publisher's store root "
                         "and hot-swap params between decode steps")
    ap.add_argument("--weight-sync-name", default=None,
                    help="subscriber name published back to the source "
                         "(inspect_ckpt --subscribers)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rep = run(args.arch, n_requests=args.requests,
              prompt_len=args.prompt_len, gen_len=args.gen_len,
              workdir=args.workdir, ckpt_every=args.ckpt_every,
              preempt_at=args.preempt_at, weight_sync=args.weight_sync,
              weight_sync_name=args.weight_sync_name, device=args.device)
    print({k: v for k, v in rep.items() if k not in ("tokens", "params")})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
