"""Fused RMSNorm: the K7 kernel's wrapper, its plain version and the
differentiable ``rmsnorm`` (the launch count is ``ops.launches``)."""
from .ops import rmsnorm, rmsnorm_backward, rmsnorm_fused, rmsnorm_plain

__all__ = ["rmsnorm", "rmsnorm_backward", "rmsnorm_fused", "rmsnorm_plain"]
