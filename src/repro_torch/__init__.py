"""NERO weather stencils in PyTorch, with hand-written CUDA kernels for Hopper.

The package mirrors `src/repro/` module for module. Plain PyTorch code runs
on the CPU; on a CUDA device every stencil kernel is a CUDA C++ kernel built
from `csrc/` at first use (`kernels/_build.py`).
"""
