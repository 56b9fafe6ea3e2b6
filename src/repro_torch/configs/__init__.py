from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, get, register, registry)
