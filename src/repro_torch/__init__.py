"""PyTorch/CUDA port of ``repro``, grown beside it slice by slice.

It imports ``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.
Module names follow ``repro`` so each counterpart is easy to find. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; the
kernels (paged attention, flash attention, the systolic GEMM and the
int8-weight GEMM) are CUDA C++ for Hopper
(``kernels/csrc``), each with a plain PyTorch version beside it that CPU
tensors take.
"""
