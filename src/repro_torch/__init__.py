"""eACGM on PyTorch and CUDA: the port of the JAX package `repro` to an
NVIDIA H100.

The layout mirrors `repro` module for module (`repro_torch/core/gmm.py` is
the port of `repro/core/gmm.py`, and so on). The package imports torch,
numpy and the standard library only — never `jax` and never `repro`; the two
packages meet only in the parity tests (`tests/test_torch_*.py`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (`repro_torch.device`).
"""
