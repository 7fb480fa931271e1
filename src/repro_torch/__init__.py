"""PyTorch port of the ``repro`` package for one NVIDIA H100.

The layout mirrors ``src/repro``: ``configs/``, ``models/``,
``kernels/paged_attention/``, ``serve/``, ``launch/`` and ``checkpoint/``.
This package imports ``torch`` and numpy only. The JAX package stays the
reference it is tested against (``tests/test_torch_*.py``).

On a CUDA tensor every kernel of the serving path is a hand-written CUDA
kernel for ``sm_90a``; on a CPU tensor the same op runs its plain PyTorch
version, which is how the tests run without a card.
"""
