"""Fused RMSNorm: the K7 kernel's wrapper and its plain version (the
launch count is ``ops.launches``)."""
from .ops import rmsnorm_fused, rmsnorm_plain

__all__ = ["rmsnorm_fused", "rmsnorm_plain"]
