"""The card's cases of two ported reference suites:

- ``tests/test_attention.py`` (ported in ``test_torch_attention.py``): at
  its gradient case's shape, K8's forward and ``kernels/flash_attention/
  ops.py::attention_backward`` under autograd against the plain version's
  autograd, within the suite's 2e-5 (values) and 5e-5 (gradients);
- ``tests/test_coordinator_drain.py`` (ported in
  ``test_torch_host_suites.py``): ``quiesce_device_state`` returns only
  once the stream that wrote a leaf is idle.

Every test is marked ``cuda`` and skips without a card. The file imports
no JAX, so it runs on a machine that has none:

    python -m pytest -q tests/test_torch_suites_cuda.py

~14 s alone at ``-n 6 --dist loadfile`` here, where both skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.drain import quiesce_device_state
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.layers import attention_full

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(),
                                 reason="needs a CUDA card")]


def _qkv(device, B=1, S=32, H=4, K=2, D=16, seed=42):
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal((B, S, H, D), dtype=np.float32),
          rng.standard_normal((B, S, K, D), dtype=np.float32),
          rng.standard_normal((B, S, K, D), dtype=np.float32))
    return [torch.from_numpy(x).to(device).requires_grad_(True) for x in xs]


def _err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def test_k8_forward_and_backward_match_the_plain_autograd():
    q, k, v = _qkv("cuda")
    before = fa.launches
    out = attention_full(q, k, v, causal=True)
    assert fa.launches == before + 1
    out.sum().backward()
    pq, pk, pv = _qkv("cuda")
    ref = fa.flash_attention_plain(pq, pk, pv, causal=True)
    ref.sum().backward()
    assert _err(out, ref) < 2e-5
    for a, b in zip((q, k, v), (pq, pk, pv)):
        assert _err(a.grad, b.grad) < 5e-5


def test_quiesce_device_state_waits_for_the_writing_stream():
    """A leaf written on the card behind ~0.5 s of queued work: the stream
    is busy when ``quiesce_device_state`` is called, and idle once it
    returns."""
    dev = torch.device("cuda")
    x = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    state = {"params": {"w": x * 2}, "step": torch.zeros((), device=dev)}
    assert not torch.cuda.current_stream().query()
    waited = quiesce_device_state(state)
    assert torch.cuda.current_stream().query()
    assert waited > 0.0
    assert float(state["params"]["w"][0]) == 2.0
