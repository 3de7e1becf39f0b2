"""Checkpoint codec kernels: byteplane forward (K2) and RLE emission (K3)."""
