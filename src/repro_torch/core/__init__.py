"""The paper's instruction roofline for the port: hardware constants
(``hardware``), Eqs. 1-4 (``paper_model``), the paper's Tables 1-2
(``paper_data``), roofline assembly (``irm``), table emitters
(``report``), the instruction counter source of the port's own CUDA
kernels, a census of their SASS (``sass_counters``), and, for a whole
step, the per-device census of its traced ops (``step_census``), the
three-term roofline (``roofline``), the H100 step profile
(``gpu_model``) and the SVG figure (``plotting``).  Standard library and
torch only; ``hardware.h100_from_device`` reads the card through torch
and ``nvidia-smi`` when it is called."""
from repro_torch.core import hardware, paper_data, paper_model  # noqa: F401
from repro_torch.core.gpu_model import (  # noqa: F401
    GpuInstructionProfile, profile_from_census)
from repro_torch.core.hardware import (  # noqa: F401
    HardwareSpec, get as get_hardware, h100_spec)
from repro_torch.core.irm import gpu_irm, step_irm  # noqa: F401
from repro_torch.core.paper_model import KernelMeasurement  # noqa: F401
from repro_torch.core.plotting import plot_irm  # noqa: F401
from repro_torch.core.roofline import (  # noqa: F401
    RooflineTerms, roofline_terms)
from repro_torch.core.step_census import (  # noqa: F401
    Census, CollectiveStat, census_of_step)
