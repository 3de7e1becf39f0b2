"""The model zoo's dense attention families on PyTorch (norms and prefill
attention run the port's CUDA kernels K7 and K8)."""
from .model import Model

__all__ = ["Model"]
