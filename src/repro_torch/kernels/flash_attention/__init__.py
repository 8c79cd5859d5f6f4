"""Forward attention, causal / sliding-window / GQA, as one CUDA launch
(``csrc/flash_attention.cu``)."""
