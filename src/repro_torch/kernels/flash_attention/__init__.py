"""Flash-attention forward: the K8 kernel's wrapper, its plain version and
the naive oracle (the launch count is ``ops.launches``)."""
from .ops import attention_reference, flash_attention, flash_attention_plain

__all__ = ["attention_reference", "flash_attention", "flash_attention_plain"]
