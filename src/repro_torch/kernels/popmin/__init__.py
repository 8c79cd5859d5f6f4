"""Population (min, argmin): per-tile partials and their fold, two CUDA
launches (``csrc/popmin.cu``)."""
