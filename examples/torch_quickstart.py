"""Quickstart on the PyTorch port: train a small LM with transparent C/R,
kill it, restore it, and verify the continuation is bit-exact (the
paper's Gromacs claim). The twin of ``examples/quickstart.py``; runs on
the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import logging
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import CONFIGS, reduced  # noqa: E402
from repro_torch.devices import resolve_device  # noqa: E402
from repro_torch.train.loop import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.steps import CUBLAS_WORKSPACE  # noqa: E402


def main(device=None) -> dict:
    """Returns the workdir, both digests, the restored step, the last
    checkpoint report and ``check``: what the run asserted."""
    dev = resolve_device(device)
    # the deterministic train step needs it before cuBLAS first runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    cfg = reduced(CONFIGS["gemma3-1b"])
    wd = tempfile.mkdtemp(prefix="repro-quickstart-")
    print(f"== workdir {wd}")
    print("== reference run: 20 uninterrupted steps")
    ref = Trainer(cfg, TrainerConfig(workdir=wd + "/ref", batch=4, seq_len=64,
                                     ckpt_every=0, seed=42, log_every=5),
                  device=dev)
    ref.init_or_restore()
    ref.fit(20)
    ref_digest = ref.params_digest()
    ref.manager.close()

    print("== C/R run: 10 steps, async checkpoint every 5, then 'crash'")
    t = Trainer(cfg, TrainerConfig(workdir=wd + "/cr", batch=4, seq_len=64,
                                   ckpt_every=5, async_ckpt=True, seed=42,
                                   log_every=5), device=dev)
    t.init_or_restore()
    t.fit(20, stop_after=10)
    del t  # simulated node failure — only the checkpoint survives

    print("== restart: lower half rebuilt, upper half restored")
    t2 = Trainer(cfg, TrainerConfig(workdir=wd + "/cr", batch=4, seq_len=64,
                                    ckpt_every=5, seed=42, log_every=5),
                 device=dev)
    t2.init_or_restore()
    print(f"   restored from step {t2.restored_from}")
    t2.fit(20)

    digest = t2.params_digest()
    ok = digest == ref_digest
    print(f"== bit-exact resume: {ok}")
    assert ok
    print("== checkpoint metrics:", t2.manager.last_report)
    t2.manager.close()
    return {"workdir": wd, "ref_digest": ref_digest, "digest": digest,
            "restored_from": t2.restored_from, "step": t2.py_step,
            "last_report": t2.manager.last_report,
            "check": {"ok": ok, "digests_equal": ok,
                      "restored_from": t2.restored_from,
                      "step": t2.py_step}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(args.device)
