"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
build, and the wrappers that launch them beside their plain versions."""
