"""MVulD on PyTorch and CUDA: the port of ``mvuld_tpu`` to one NVIDIA H100.

Mirrors ``mvuld_tpu``'s module paths and class and function names so each
counterpart is easy to find; imports ``torch``, never ``jax``, and nothing
from ``mvuld_tpu``. The Pallas kernels of the serving path are CUDA C++
sources under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``); every kernel wrapper falls back to its plain PyTorch
version only for tensors that lie on the CPU.
"""
