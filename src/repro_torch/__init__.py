"""PyTorch + CUDA port of the MX-SAFE system (serving slice).

Mirrors the JAX package's layout (``configs/``, ``core/``, ``kernels/``,
``models/``, ``serve/``).  It imports ``torch`` and never ``jax``; the two
packages meet only in the parity tests (``tests/test_torch_*.py``) and
through ``convert.py``, which takes numpy arrays.
"""
