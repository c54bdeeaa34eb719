"""PyTorch/CUDA port of the MoSSo streaming summarizer (``repro``'s twin).

Mirrors ``src/repro/`` module for module and is held leaf-bitwise to it
by ``tests/test_torch_*.py``.  Imports ``torch`` and numpy only: nothing
of JAX and nothing of the ``repro`` package.  Entry points run on a CUDA
device unless the caller passes ``device="cpu"``.
"""
