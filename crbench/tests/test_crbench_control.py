"""The control comes out not correct: the reference with float8 (e4m3)
weight products, the next precision below the configurations' bfloat16,
put in the program's place, at each configuration's own size, on three
seeds. Needs the card (marked ``cuda``; skipped without one):

    python3 -m pytest -q -m cuda crbench/tests
"""
import pytest

from crbench.tests.conftest import REPO

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("config", ["mamba2-780m.l4", "hubert-xlarge.l6"])
def test_control_is_not_correct(card, config):
    from crbench import inputs
    from crbench.bench import Bench
    from crbench.calibrate import seeds
    from crbench.reference import compare
    from crbench.reference import train as T
    bench = Bench(REPO)
    cj = bench.config(config)
    model = bench.reference(cj["reference"])
    lim = bench.limits(config)
    for seed in seeds(3):       # the seeds the control was read on
        w0 = inputs.weights(model.param_specs(cj), seed, card)
        batches = [inputs.batch(cj, seed, s, card) for s in range(3)]
        ref = T.train(model, cj, w0, batches)
        low = T.train(model, cj, w0, batches, T.fp8_matmul)
        g = compare.gaps(low, ref)
        assert any(g[k] > lim[k]["limit"] for k in g), (seed, g)
