"""PyTorch/CUDA port of ``repro`` for the NVIDIA H100.

Imports ``torch`` and never JAX or the ``repro`` package. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""
