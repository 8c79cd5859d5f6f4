"""Packed-word population generation: every child of one parent as
(2N-1, W) words in one CUDA launch (``csrc/graycode.cu``)."""
