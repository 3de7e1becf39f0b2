"""Serving with transparent C/R on the PyTorch port: batched greedy
decoding is preempted mid-generation, then restored — the completed
outputs are token-identical to an uninterrupted run. The twin of
``examples/serve_with_cr.py``; runs on the CUDA card unless ``--device
cpu``.

    PYTHONPATH=src python examples/torch_serve_with_cr.py [--device cpu]
"""
import argparse
import logging
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.devices import resolve_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def main(device=None) -> dict:
    """Returns the workdir, the three runs' reports and ``check``: what
    the run asserted."""
    dev = resolve_device(device)
    wd = tempfile.mkdtemp(prefix="repro-serve-")
    print("== uninterrupted serving run (reference)")
    full = serve.run("stablelm-1.6b", n_requests=4, prompt_len=16,
                     gen_len=24, workdir=wd + "/ref", ckpt_every=0, seed=7,
                     device=dev)
    print(f"   {full['status']}  ~{full.get('tok_per_s', 0):.0f} tok/s")

    print("== serving run preempted at token 9")
    pre = serve.run("stablelm-1.6b", n_requests=4, prompt_len=16, gen_len=24,
                    workdir=wd + "/cr", ckpt_every=0, preempt_at=9, seed=7,
                    device=dev)
    assert pre["status"] == "preempted"

    print("== restored serving run finishes the batch")
    resumed = serve.run("stablelm-1.6b", n_requests=4, prompt_len=16,
                        gen_len=24, workdir=wd + "/cr", ckpt_every=0, seed=7,
                        device=dev)
    ok = np.array_equal(resumed["tokens"], full["tokens"])
    print(f"== token-exact continuation: {ok}")
    assert ok
    return {"workdir": wd, "full": full, "preempted": pre,
            "resumed": resumed,
            "check": {"ok": ok, "tokens_equal": ok,
                      "preempted_at": pre["cursor"],
                      "tok_per_s": full.get("tok_per_s"),
                      "resumed_tok_per_s": resumed.get("tok_per_s")}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(args.device)
