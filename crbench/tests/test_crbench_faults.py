"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half of each batch left out (the
mean over the rest), and an answer altered where it is produced (a saved
leaf, a restored leaf). A cell on one chip has no exchange between chips
to leave out. Tiny cells on the CPU; the chip check is skipped."""
import pytest
import torch

from crbench import driver
from crbench.run import run_cell

SEED = 2**31 + 99


def broken_trainer(monkeypatch, wrap):
    orig = driver.Run.trainer

    def trainer(self, *a, **kw):
        t = orig(self, *a, **kw)
        t.step_fn = wrap(t.step_fn)
        return t

    monkeypatch.setattr(driver.Run, "trainer", trainer)


def unchanged(step):
    def fn(state, batch):
        loss, metrics, _ = step.grads(state, batch)
        return state, {**metrics, "loss": loss}
    return fn


def half_batch(step):
    def fn(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return fn


@pytest.mark.parametrize("workload", ["mamba2-ckpt", "hubert-recover"])
@pytest.mark.parametrize("fault", [unchanged, half_batch])
def test_broken_step_is_not_correct(tiny_root, monkeypatch, workload, fault):
    broken_trainer(monkeypatch, fault)
    out = run_cell(tiny_root, workload, SEED, 1.0, False, device="cpu")
    assert out["correct"] is False
    bad = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert bad & {"loss_gap", "grad_gap", "change_gap"}


def test_sound_runs_are_correct(tiny_root):
    for w in ("mamba2-ckpt", "hubert-recover", "hubert-ckpt"):
        out = run_cell(tiny_root, w, SEED, 1.0, False, device="cpu")
        assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("workload", ["hubert-ckpt", "hubert-recover"])
def test_altered_saved_leaf_is_not_correct(tiny_root, monkeypatch, workload):
    from repro_torch.core import save_path
    orig = save_path.snapshot_items

    def snapshot_items(state, pool, quantize=None):
        items = orig(state, pool, quantize)
        name, rng, arr = items[-1]
        arr = arr.copy()
        arr.reshape(-1).view("uint8")[0] ^= 1
        items[-1] = (name, rng, arr)
        return items

    monkeypatch.setattr(save_path, "snapshot_items", snapshot_items)
    out = run_cell(tiny_root, workload, SEED, 1.0, False, device="cpu")
    assert out["correct"] is False
    assert out["checks"]["save_mismatch"]["value"] > 0


def test_altered_restored_leaf_is_not_correct(tiny_root, monkeypatch):
    from repro_torch.core.checkpoint import CheckpointManager
    orig = CheckpointManager.restore

    def restore(self, *a, **kw):
        state, extra = orig(self, *a, **kw)
        leaf = state["params"]["final_norm"]["scale"]
        with torch.no_grad():
            leaf.view(-1)[0] += 1
        return state, extra

    monkeypatch.setattr(CheckpointManager, "restore", restore)
    out = run_cell(tiny_root, "hubert-recover", SEED, 1.0, False,
                   device="cpu")
    assert out["correct"] is False
    assert out["checks"]["restore_mismatch"]["value"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64])
def test_digest_sees_every_block(monkeypatch, dtype):
    """The digest that holds saves and restores to the state: equal bits
    agree, through the plain reader's NumPy arrays too; a change in any
    block, or two words swapped within one, or two blocks swapped,
    differ (blocks of 4 words here, of ``DIGEST_WORDS`` in a run)."""
    monkeypatch.setattr(driver, "DIGEST_WORDS", 4)
    d = driver.Digest(torch.device("cpu"), SEED)
    x = (torch.arange(1, 11) * 3).to(dtype)
    base = d({"x": x})
    as_numpy = x.contiguous().view(driver._int(x)).numpy()
    assert driver.Digest.differ(base, d({"x": torch.from_numpy(
        driver._signed(as_numpy))})) == 0
    changed = x.clone()
    changed[9] += 1
    within = x.clone()
    within[[4, 5]] = x[[5, 4]]
    blocks = torch.cat([x[4:8], x[:4], x[8:]])
    for other in (changed, within, blocks):
        assert driver.Digest.differ(base, d({"x": other})) == 1
    assert driver.Digest.differ(base, {**d({"x": x}), "y": base["x"]}) == 1
