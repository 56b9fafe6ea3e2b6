from repro_torch.kernels.stream.stream import (  # noqa: F401
    add, copy, dot, mul, triad)
