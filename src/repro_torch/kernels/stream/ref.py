"""Plain PyTorch versions of BabelStream's five kernels
(``repro/kernels/stream/ref.py``), rounding where the JAX kernels round.

The scalar is rounded to the arrays' dtype first, as JAX does with a
Python float against a bf16 array (bf16(0.4) = 0.400390625), and each
operation rounds to the dtype on its own: ``triad`` rounds ``s * c``
before adding ``b``.  ``dot`` multiplies and sums in f32 and returns an
f32 scalar.
"""
from __future__ import annotations

import torch

SCALAR = 0.4                        # BabelStream's startScalar


def scalar_in(dtype: torch.dtype, scalar: float = SCALAR) -> float:
    """``scalar`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(scalar, dtype=dtype).item()


def copy(a: torch.Tensor) -> torch.Tensor:
    return a.clone()


def mul(c: torch.Tensor, scalar: float = SCALAR) -> torch.Tensor:
    return c * scalar_in(c.dtype, scalar)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def triad(b: torch.Tensor, c: torch.Tensor,
          scalar: float = SCALAR) -> torch.Tensor:
    return b + c * scalar_in(c.dtype, scalar)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() * b.float()).sum()
