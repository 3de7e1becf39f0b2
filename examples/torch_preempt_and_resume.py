"""Preempt-queue demo on the PyTorch port: a low-priority training job is
preempted by a high-priority arrival (the paper's scheduling-flexibility
use case), takes a final checkpoint at the step boundary, exits, and later
resumes exactly. The twin of ``examples/preempt_and_resume.py``; runs on
the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_preempt_and_resume.py [--device cpu]
"""
import argparse
import logging
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import CONFIGS, reduced  # noqa: E402
from repro_torch.core.preempt import (PreemptionGuard,  # noqa: E402
                                      PreemptQueue)
from repro_torch.devices import resolve_device  # noqa: E402
from repro_torch.train.loop import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.steps import CUBLAS_WORKSPACE  # noqa: E402


def main(device=None) -> dict:
    """Returns the workdir, both reports' (status, step), the restored
    step, the final params digest and ``check``: what the run asserted."""
    dev = resolve_device(device)
    # the deterministic train step needs it before cuBLAS first runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    cfg = reduced(CONFIGS["starcoder2-3b"])
    wd = tempfile.mkdtemp(prefix="repro-preempt-")
    tcfg = TrainerConfig(workdir=wd, batch=4, seq_len=64, ckpt_every=50,
                         seed=1, log_every=5)

    print("== low-priority job starts (target: 30 steps)")
    queue = PreemptQueue()
    job = Trainer(cfg, tcfg, device=dev).init_or_restore()
    with PreemptionGuard() as guard:
        job.fit(30, guard=guard, stop_after=12)
        print("== high-priority job arrives -> preempting")
        queue.submit_high_priority(guard, job="realtime-inference")
        report = job.fit(30, guard=guard)
    print(f"== job exited: {report['status']} at step {report['step']}")
    assert report["status"] == "preempted"
    job.manager.close()

    print("== nodes free for the high-priority job ... done; restarting")
    job2 = Trainer(cfg, tcfg, device=dev).init_or_restore()
    print(f"== restored from step {job2.restored_from}")
    report2 = job2.fit(30)
    print(f"== finished: {report2['status']} at step {report2['step']}")
    assert report2["status"] == "completed" and report2["step"] == 30
    print("== coordinator metrics:", report2["ckpt_metrics"])
    job2.manager.close()
    preempted = (report["status"], report["step"])
    completed = (report2["status"], report2["step"])
    return {"workdir": wd, "preempted": preempted,
            "restored_from": job2.restored_from, "completed": completed,
            "digest": job2.params_digest(),
            "ckpt_metrics": report2["ckpt_metrics"],
            "check": {"ok": True, "preempted": preempted,
                      "restored_from": job2.restored_from,
                      "completed": completed}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(args.device)
