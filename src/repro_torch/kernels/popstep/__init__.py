"""The fused DGO population step: generate, decode, evaluate and select
every child of one parent in one CUDA launch (``csrc/popstep.cu``)."""
