from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ArchConfig, ShapeConfig, get, register, registry)
