"""Plain references of the benchmark: the models, AdamW and the
checkpoint reader, written from the published descriptions and the
checkpoint format, in plain PyTorch and NumPy. Nothing here imports the
program (``repro_torch``) or the JAX package."""
