"""Tiny cells for the CPU tests: a copy of the benchmark's directory in a
temporary root, with configurations of the two models at toy widths (the
widths are the only change) and their own BENCHMARK.json."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "mamba2-780m.l4": dict(n_layers=2, d_model=64, vocab_size=128,
                           ssm={"d_state": 16, "d_conv": 4, "expand": 2,
                                "head_dim": 16, "n_groups": 1,
                                "chunk_size": 32},
                           train={"batch": 2, "seq_len": 64}),
    "hubert-xlarge.l6": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                             head_dim=16, d_ff=96, vocab_size=32,
                             train={"batch": 2, "seq_len": 64}),
}
# limits of the toy cells (float32 CPU runs of the program against the
# reference read under 1e-4 on every number)
TINY_LIMITS = {k: {"limit": 1e-3} for k in ("loss_gap", "grad_gap",
                                             "change_gap")}


def make_tiny_root(root: Path) -> Path:
    """A benchmark root under `root` whose cells are the real ones at toy
    widths."""
    src = REPO / "crbench"
    dst = root / "crbench"
    for d in ("traffic", "metrics", "reference"):
        shutil.copytree(src / d, dst / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "configs").mkdir()
    (dst / "limits").mkdir()
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cj = json.loads((REPO / c["file"]).read_text())
        cj.update(TINY[c["name"]])
        cj["dtype"] = "float32"
        (root / c["file"]).write_text(json.dumps(cj))
        (dst / "limits" / f"{c['name']}.json").write_text(
            json.dumps(TINY_LIMITS))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return make_tiny_root(tmp_path / "root")
