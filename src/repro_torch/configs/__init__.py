"""Model configurations whose training state the port checkpoints (copies
of the JAX package's framework-free config modules)."""
