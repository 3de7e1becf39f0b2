"""Checkpoint codec kernels: byteplane forward (K2) and inverse (K4), RLE
emission (K3), and the int8 block quantizer (K5) and dequantizer (K6)."""
