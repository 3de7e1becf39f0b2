"""The benchmark of the PyTorch/CUDA port (``repro_torch``): training
goodput under interval checkpoints and under restarts. ``python3 -m
crbench.run`` runs one cell; ``BENCHMARK.json`` names the cells."""
