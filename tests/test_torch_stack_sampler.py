"""``chip_smoke.StackSampler`` (``chip_smoke.py --stacks``) on the CPU: a
thread busy in a known function while a ``phase`` and a segment are set
shows in the written report under that phase and segment, with its share
of the samples; samples taken outside the phase are counted apart. About
2 s alone."""
import importlib.util
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spin_in_a_known_function(stop: threading.Event):
    while not stop.is_set():
        sum(range(1000))


def test_stack_sampler_counts_a_busy_thread_per_phase(tmp_path):
    cs = _chip_smoke()
    sampler = cs.StackSampler(period=0.005, depth=2)
    stop = threading.Event()
    with cs.phase("busy"):
        cs.CURRENT_PHASE[1] = "spin"
        worker = threading.Thread(target=_spin_in_a_known_function,
                                  args=(stop,))
        worker.start()
        time.sleep(0.5)
        stop.set()
        worker.join()
    assert cs.CURRENT_PHASE == ["between", ""]
    time.sleep(0.2)
    out = tmp_path / "stacks.txt"
    sampler.write(out)
    report = out.read_text().split("== ")
    busy = [sec for sec in report if sec.startswith("busy/spin:")]
    assert len(busy) == 1
    rows = busy[0].splitlines()[1:]
    spin = [r for r in rows if "_spin_in_a_known_function" in r]
    assert spin, busy[0]
    share, count = spin[0].split()[:2]
    assert 0.0 < float(share) <= 1.0 and int(count) > 5
    assert any(sec.startswith("between:") for sec in report)
