"""PyTorch/CUDA port of the DGO system in ``repro``.

``repro_torch`` runs on one NVIDIA H100 through hand-written CUDA
kernels, beside the JAX package ``repro`` that it is held against.  It
imports neither ``jax`` nor ``repro``.  The front door is
``repro_torch.core.solver.solve``; see ``ROADMAP.md`` for what is ported.
"""
