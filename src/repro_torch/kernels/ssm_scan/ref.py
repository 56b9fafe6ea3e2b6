"""Plain PyTorch version for the selective-scan kernel — port of
``repro/kernels/ssm_scan/ref.py``: the model's own sequential scan."""
from repro_torch.models.ssm import mamba1_scan  # noqa: F401
