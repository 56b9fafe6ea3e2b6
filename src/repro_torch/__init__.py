"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Mirrors the JAX package's layout (``configs``, ``models``, ``kernels``,
``serve``, ``data``, ``optim``, ``train``, ``launch``).  Imports torch, numpy
and the standard library only; the paged-attention kernels are CUDA C++
under ``csrc/``, built with ``nvcc`` at first use (``kernels/build.py``).
"""
