"""Flash-attention forward: the K8 kernel's wrapper, its plain version,
the naive oracle and the differentiable ``attention`` (the launch count is
``ops.launches``)."""
from .ops import (attention, attention_backward, attention_reference,
                  flash_attention, flash_attention_plain)

__all__ = ["attention", "attention_backward", "attention_reference",
           "flash_attention", "flash_attention_plain"]
