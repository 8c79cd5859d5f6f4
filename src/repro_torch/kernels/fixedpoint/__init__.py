"""Packed-word decode: (P, W) children words -> (P, n_vars) float32
search points in one CUDA launch (``csrc/fixedpoint.cu``)."""
