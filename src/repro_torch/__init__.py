"""PyTorch/CUDA port of the ``repro`` checkpoint/restart system, for one
NVIDIA H100. It writes and reads the JAX package's on-disk format
byte-for-byte; its device encode runs as hand-written CUDA kernels
(``csrc/``). It imports neither JAX nor the ``repro`` package."""
