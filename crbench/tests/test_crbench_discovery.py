"""A cell, a configuration, a traffic mix and a metric added only as new
files (and entries in BENCHMARK.json) are found and run: no file of the
harness changes."""
import json

from crbench.bench import Bench
from crbench.run import run_cell


def test_new_parts_as_files_only(tiny_root):
    d = tiny_root / "crbench"
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    # a configuration: the toy mamba2 at another depth
    cj = json.loads((tiny_root / spec["configs"][0]["file"]).read_text())
    cj.update(name="mamba2-780m.l3", n_layers=3)
    (d / "configs" / "mamba2-780m.l3.json").write_text(json.dumps(cj))
    (d / "limits" / "mamba2-780m.l3.json").write_text(
        (d / "limits" / "mamba2-780m.l4.json").read_text())
    spec["configs"].append({"name": "mamba2-780m.l3", "source": cj["source"],
                            "file": "crbench/configs/mamba2-780m.l3.json",
                            "reduced": ["n_layers"], "why": "a test"})
    # a traffic mix: one save a window
    tj = json.loads((d / "traffic" / "ckpt-interval.json").read_text())
    tj["saves"] = 1
    (d / "traffic" / "ckpt-once.json").write_text(json.dumps(tj))
    # a metric: the rounds that landed
    (d / "metrics" / "rounds_landed.py").write_text(
        "def read(rec):\n    return float(len(rec.rounds))\n")
    spec["end_to_end"].append({"name": "rounds_landed", "unit": "rounds",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["mamba2-once"]})
    # the cell, which reports training goodput
    next(m for m in spec["end_to_end"]
         if m["name"] == "train_tok_s")["workloads"].append("mamba2-once")
    spec["workloads"].append({"name": "mamba2-once",
                              "config": "mamba2-780m.l3",
                              "traffic": "ckpt-once", "chips": 1,
                              "why": "a test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    b = Bench(tiny_root)
    assert [m["name"] for m, _ in b.metrics("mamba2-once", False)] == \
        ["train_tok_s", "setup_s", "rounds_landed"]
    assert "rounds_landed" not in [m["name"] for m, _ in
                                   b.metrics("mamba2-ckpt", False)]
    out = run_cell(tiny_root, "mamba2-once", 5, 1.0, False, device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["rounds_landed"]["value"] == 1.0
    assert out["diag"]["steps"] >= 3


def test_split_metrics_follow_their_cells():
    """Cells that restart report goodput and its per-layer metrics under
    names of their own (``<base>.restart``), read by the base's reader;
    the interval cells report the base names alone."""
    from crbench.tests.conftest import REPO
    b = Bench(REPO)
    for w in ("mamba2-ckpt", "hubert-ckpt", "hubert-recover"):
        restart = w.endswith("recover")
        for traced in (False, True):
            for m, reader in b.metrics(w, traced):
                assert m["moves" if traced else "name"].endswith(
                    ".restart") == restart or m["name"] == "setup_s", (w, m)
                assert reader.__name__ == "crbench_metrics_" + \
                    m["name"].split(".")[0]
    names = {m["name"] for m, _ in b.metrics("hubert-recover", True)}
    assert {"step_s.restart", "step_mfu.restart", "device_idle.restart",
            "resume_s", "decode_roofline", "k8_roofline.restart"} == names
