"""The port's GMM kernels: hand-written CUDA for the card (``csrc/``), plain
PyTorch versions beside them (``ref.py``), and the dispatch (``ops.py``)."""
