"""Hand-written CUDA kernels of the port, one package per kernel: the
build and binding (``kernel.py``), the public wrappers with their plain
PyTorch versions (``ops.py``) and the unfused oracle (``ref.py``)."""
