"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
build, and the wrappers that launch them beside their plain versions."""


def register_ops() -> tuple:
    """Define the registered operators of the model kernels,
    ``repro_torch::rmsnorm`` (K7) and ``repro_torch::flash_attention``
    (K8), if this process has not yet: an exported program that calls them
    loads only after this. Returns both ``OpOverload``s."""
    from .flash_attention import ops as fa
    from .rmsnorm import ops as rn
    return rn.op(), fa.op()
