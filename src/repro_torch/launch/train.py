"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(``src/repro/launch/train.py`` on PyTorch, with the same flags).

Runs the REDUCED config by default (``--full-config`` for the published
widths) through the paper's full production path: restore-on-start →
train → periodic async checkpoints → preempt-safe exit. Runs on the CUDA
card unless ``--device cpu``. Under torchrun (``WORLD_SIZE`` > 1) every
process joins the process group (NCCL on the card, gloo with ``--device
cpu``) and trains one rank of ``launch.mesh.make_host_mesh()``'s default
mesh, ``(world, 1)`` on ("data", "model"):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \
        gemma3-1b --steps 4 --ckpt-every 2 --device cpu --workdir /tmp/w
"""
from __future__ import annotations

import argparse
import logging
import os
from dataclasses import replace

from ..configs import ARCH_IDS, get_config, reduced
from ..configs.presets import preset_overrides
from ..core.codec import CODECS
from ..train.loop import Trainer, TrainerConfig
from ..train.steps import CUBLAS_WORKSPACE
from .mesh import make_host_mesh


def main(argv=None):
    # the deterministic train step needs it before cuBLAS first runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--workdir", default="runs/train")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--codec", default=None, choices=list(CODECS),
                    help="default: zstd if the zstandard package is "
                         "installed, else raw")
    ap.add_argument("--params-codec", default=None, choices=list(CODECS))
    ap.add_argument("--ckpt-mode", default="full",
                    choices=["full", "incremental"],
                    help="incremental = content-addressed dedup checkpoints")
    ap.add_argument("--chunk-size", type=int, default=1 << 20)
    ap.add_argument("--chunking", default="fixed", choices=["fixed", "cdc"],
                    help="cdc = content-defined chunking (dedup survives "
                         "byte-shifted payloads)")
    ap.add_argument("--scan-backend", default="auto",
                    choices=["auto", "numpy", "jnp", "pallas"],
                    help="cdc candidate-scan engine (auto = the device "
                         "kernel for large payloads, numpy oracle below)")
    ap.add_argument("--io-threads", type=int, default=4,
                    help="chunk-IO pipeline width (1 = serial engine)")
    ap.add_argument("--persist-queue-depth", type=int, default=1,
                    help="async checkpoint rounds in flight at once "
                         "(>1 = snapshot round N+1 while round N "
                         "persists)")
    ap.add_argument("--host-bytes-budget", type=int, default=None,
                    help="cap on aggregate host snapshot bytes queued "
                         "rounds may pin (admission blocks instead of "
                         "running the host out of memory)")
    ap.add_argument("--streaming-restore", action="store_true",
                    help="begin step 0 once the first-use frontier "
                         "(embedding + block 0) is resident; tail layers "
                         "stream in behind the completion gate")
    ap.add_argument("--remote-dir", default=None,
                    help="mount a cold object-store tier (simulated) at "
                         "this directory — cold restarts pull straight "
                         "from it via multipart ranged reads")
    ap.add_argument("--remote-bw", type=float, default=None,
                    help="remote tier bandwidth in bytes/s "
                         "(default unthrottled)")
    ap.add_argument("--remote-latency", type=float, default=0.0,
                    help="remote tier per-request latency in seconds")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--writers", type=int, default=4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync-ckpt", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full-size config")
    ap.add_argument("--preset", action="store_true",
                    help="apply the per-arch production parallelism preset")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = get_config(args.arch)
    if args.preset:
        ov = preset_overrides(args.arch)
        if ov:
            cfg = replace(cfg, **ov)
    if not args.full_config:
        cfg = reduced(cfg)
    tcfg = TrainerConfig(
        workdir=f"{args.workdir}/{args.arch}", batch=args.batch,
        seq_len=args.seq_len, ckpt_every=args.ckpt_every,
        async_ckpt=not args.sync_ckpt, codec=args.codec,
        params_codec=args.params_codec, ckpt_mode=args.ckpt_mode,
        chunk_size=args.chunk_size, chunking=args.chunking,
        scan_backend=args.scan_backend,
        io_threads=args.io_threads,
        persist_queue_depth=args.persist_queue_depth,
        host_bytes_budget=args.host_bytes_budget, replicas=args.replicas,
        n_writers=args.writers, grad_accum=args.grad_accum, seed=args.seed,
        streaming_restore=args.streaming_restore,
        remote_dir=args.remote_dir, remote_bw=args.remote_bw,
        remote_latency_s=args.remote_latency)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = make_host_mesh(device=args.device)
    trainer = Trainer(cfg, tcfg, device=args.device,
                      mesh=mesh).init_or_restore()
    try:
        report = trainer.fit(args.steps)
    finally:
        trainer.manager.close()
    print(f"status={report['status']} step={report['step']} "
          f"ckpt={report['ckpt_metrics']}")
    last = trainer.manager.last_report
    if last:
        print(f"last ckpt: step={last['step']} persist={last['seconds']:.3f}s"
              f" blocked={last.get('blocking_s', last['seconds']):.3f}s"
              f" overlapped={last.get('overlapped', False)}")
    if report["history"]:
        print("final:", report["history"][-1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
