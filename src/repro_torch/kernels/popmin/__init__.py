"""Population (min, argmin): one CUDA launch a call, one block or a grid
whose last block folds the blocks' winners (``csrc/popmin.cu``)."""
