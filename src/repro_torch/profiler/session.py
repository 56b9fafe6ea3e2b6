"""Profiling session: turn one traced step into an instruction-roofline
record — the paper's per-kernel table row, generalized to a distributed
step; port of ``repro/profiler/session.py``.

This is the integration point of the whole system: dry run -> traced
step (``core/step_census.py``, on fake tensors, per device) -> {memory,
census, FLOP counter} -> three-term roofline + H100 instruction profile
(Eq. 2/3/4 analogues).  ``profile_step`` is ``profile_compiled``'s twin
and returns the JAX record's keys, with ``flop_counter`` (torch's own
``FlopCounterMode`` total over the same local ops) in place of XLA's
``cost_analysis``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.core.gpu_model import profile_from_census
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.report import census_summary
from repro_torch.core.roofline import roofline_terms, to_row
from repro_torch.core.step_census import Census, census_of_step


def memory_dict(census: Census) -> Dict[str, float]:
    """The JAX ``_memory_dict`` fields of a traced step: the arguments'
    and outputs' local bytes; alias 0 (the port's step is functional and
    donates nothing); temp the trace's peak live bytes less the
    arguments and the outputs, so that ``device_total_bytes`` (arguments
    + output + temp - alias, the JAX sum) is the peak whenever the peak
    holds them all.  No generated code."""
    args, out = census.argument_bytes, census.output_bytes
    temp = max(0.0, census.peak_live_bytes - args - out)
    mem = {"generated_code_size_in_bytes": 0.0,
           "argument_size_in_bytes": args,
           "output_size_in_bytes": out,
           "alias_size_in_bytes": 0.0,
           "temp_size_in_bytes": temp}
    mem["device_total_bytes"] = args + out + temp
    return mem


def profile_census(name: str, census: Census, n_devices: int,
                   hw: HardwareSpec, model_flops: Optional[float] = None,
                   runtime_s: Optional[float] = None) -> Dict[str, Any]:
    """The record of an already-taken census (see ``profile_step``)."""
    terms = roofline_terms(name, census, hw, n_devices,
                           model_flops_total=model_flops)
    if runtime_s is None:
        prof = profile_from_census(name, census, hw,
                                   runtime_s=max(terms.modeled_time_s,
                                                 1e-12),
                                   runtime_is_modeled=True)
    else:
        prof = profile_from_census(name, census, hw, runtime_s=runtime_s,
                                   runtime_is_modeled=False)
    return {
        "name": name,
        "n_devices": n_devices,
        "hw": hw.name,
        "memory": memory_dict(census),
        "flop_counter": {"flops": census.flop_counter_flops},
        "census": census_summary(census),
        "roofline": to_row(terms),
        "irm": prof.table_row(),
    }


def profile_step(name: str, fn, args, n_devices: int, hw: HardwareSpec,
                 model_flops: Optional[float] = None,
                 runtime_s: Optional[float] = None) -> Dict[str, Any]:
    """Trace ``fn(*args)`` on fake tensors (``census_of_step``) and build
    its record: ``name``, ``n_devices``, ``hw``, ``memory``,
    ``flop_counter``, ``census``, ``roofline`` and ``irm``.  With
    ``runtime_s`` the instruction profile is at that measured time
    (``runtime_is_modeled`` False), else at the roofline's modeled
    time."""
    census = census_of_step(fn, *args)
    return profile_census(name, census, n_devices, hw, model_flops,
                          runtime_s)
