"""The seeded inputs: the same seed gives the same weights and batches,
another seed other values of the same sizes, and seeds past 32 bits
work."""
import torch

from crbench import inputs
from crbench.tests.conftest import TINY, REPO
import json


def cfg(name):
    c = json.loads((REPO / "crbench" / "configs" / f"{name}.json").read_text())
    c.update(TINY[name])
    return c


SEEDS = (0, 2**31 + 12345, 2**40 + 7)


def test_weights_repeat_exactly():
    from crbench.reference import mamba2
    spec = mamba2.param_specs(cfg("mamba2-780m.l4"))
    for seed in SEEDS:
        a = inputs.weights(spec, seed, "cpu")
        b = inputs.weights(spec, seed, "cpu")
        assert list(a) == list(spec)
        for n in a:
            assert a[n].dtype == getattr(torch, spec[n][2])
            assert torch.equal(a[n], b[n]), n
    a, b = (inputs.weights(spec, s, "cpu") for s in SEEDS[:2])
    assert not torch.equal(a["embed"], b["embed"])


def test_batches_repeat_exactly():
    for name in TINY:
        c = cfg(name)
        for seed in SEEDS:
            for step in (0, 5):
                a = inputs.batch(c, seed, step, "cpu")
                b = inputs.batch(c, seed, step, "cpu")
                assert a.keys() == b.keys()
                for k in a:
                    assert torch.equal(a[k], b[k])
        x, y = inputs.batch(c, SEEDS[1], 0, "cpu"), \
            inputs.batch(c, SEEDS[1], 1, "cpu")
        k = next(iter(x))
        assert x[k].shape == y[k].shape and not torch.equal(x[k], y[k])


def test_batch_contents():
    c = cfg("mamba2-780m.l4")
    t = inputs.batch(c, 3, 0, "cpu")["tokens"]
    assert t.dtype == torch.int32 and int(t.min()) >= 0 and \
        int(t.max()) < c["vocab_size"]
    h = cfg("hubert-xlarge.l6")
    b = inputs.batch(h, 3, 0, "cpu")
    assert b["features"].dtype == torch.bfloat16
    assert b["mask"].dtype == torch.bool and 0 < float(b["mask"].float()
                                                       .mean()) < 1
