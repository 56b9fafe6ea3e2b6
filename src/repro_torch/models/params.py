"""Parameter schema: every leaf declared once (shape, logical axes, init
kind, dtype); initialization, the abstract tree, the partition specs and
the JAX weight bridge all walk the same declaration.

Port of ``repro/models/params.py``.  ``axes`` are the logical sharding
names per dim ("fsdp" | "model" | "ep" | ... | None), the JAX
declaration's, resolved by the active ``MeshRules`` (``param_pspecs``).
Stacked per-layer parameters get a leading layer dim with axis None, as
in the JAX tree, so a parameter tree here is the same nested dict of the
same shapes.  ``abstract_params`` gives tensors on the ``meta`` device:
shapes and dtypes, no storage (``jax.ShapeDtypeStruct``'s counterpart).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"             # normal (fan-in) | zeros | ones | embed
                                     # | ssm_a | ssm_a_scalar | ssm_dt
    dtype: Optional[torch.dtype] = None   # None -> the config's param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def stacked(decl: ParamDecl, n: int) -> ParamDecl:
    return ParamDecl((n,) + decl.shape, (None,) + decl.axes, decl.init,
                     decl.dtype)


def map_schema(fn: Callable[[ParamDecl], Any], tree) -> Any:
    if isinstance(tree, ParamDecl):
        return fn(tree)
    return {k: map_schema(fn, tree[k]) for k in sorted(tree)}


def abstract_params(schema, default_dtype: torch.dtype):
    """The tree as ``meta`` tensors of the declared shapes and dtypes."""
    return map_schema(lambda d: torch.empty(
        d.shape, dtype=d.dtype or default_dtype, device="meta"), schema)


def param_pspecs(schema, rules):
    """The tree of partition specs: each leaf's logical axes resolved by
    ``rules`` (a ``dist.sharding.MeshRules``)."""
    from repro_torch.dist.sharding import P
    return map_schema(lambda d: P(*(rules.resolve(a) for a in d.axes)),
                      schema)


def _init_leaf(d: ParamDecl, generator: torch.Generator,
               device: torch.device, default_dtype: torch.dtype):
    dt = d.dtype or default_dtype
    if d.init in ("zeros", "ssm_a_scalar"):
        # ssm_a_scalar: Mamba2's per-head A_log, 0 so that A = -1
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init == "ssm_a":
        # mamba A_log init: log(1..N) broadcast over channels
        a = torch.log(torch.arange(1, d.shape[-1] + 1, dtype=torch.float32,
                                   device=device))
        return a.to(dt).expand(d.shape).contiguous()
    if d.init == "ssm_dt":
        # dt bias init so that softplus(dt) spans ~[1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(d.shape, generator=generator, dtype=torch.float32,
                       device=device)
        return torch.log(torch.expm1(torch.exp(lo + u * (hi - lo))) + 1e-9
                         ).to(dt)
    if d.init == "embed":
        mult = 0.02
    elif d.init == "normal":                 # fan-in normal
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        mult = 1.0 / math.sqrt(max(1, fan_in))
    else:
        raise NotImplementedError(f"init kind {d.init!r} is not ported")
    out = torch.empty(d.shape, dtype=dt, device=device)
    # stacked leaves fill one layer at a time: the f32 draw of a whole
    # full-width stack would be a multi-GB temporary
    slices = out if len(d.shape) >= 3 else out[None]
    for s in slices:
        r = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        s.copy_(r.to(dt) * torch.tensor(mult, dtype=dt, device=device))
    return out


def init_from_schema(schema, generator: torch.Generator,
                     device, default_dtype: torch.dtype) -> Dict[str, Any]:
    device = torch.device(device)
    return map_schema(
        lambda d: _init_leaf(d, generator, device, default_dtype), schema)


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters of ``cfg`` with the JAX schema's shapes, dtypes
    and init kinds (fan-in normal, ``embed`` x0.02, ones, zeros,
    Mamba1's ``ssm_a``, Mamba2's ``ssm_a_scalar`` and ``ssm_dt``), drawn
    from ``generator`` on ``device``.  The values differ from the JAX
    package's (a torch generator is not threefry); the tests hand both
    packages the same weights through ``params_from_jax`` instead."""
    from repro_torch.models.transformer import schema
    return init_from_schema(schema(cfg), generator, device, cfg.param_dtype)


def _leaf_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: cross as the raw 16-bit pattern
        bits = torch.from_numpy(a.view(np.uint16).copy())
        return bits.view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree_np, cfg, device="cuda") -> Dict[str, Any]:
    """Build the port's parameters from the numpy leaves of a JAX
    parameter tree (``jax.tree.map(np.asarray, params)``), bit-exact.
    Every leaf is checked against the port's schema for ``cfg``."""
    from repro_torch.models.transformer import schema
    device = torch.device(device)

    def walk(decl_tree, np_tree, path):
        if isinstance(decl_tree, ParamDecl):
            t = _leaf_from_numpy(np.asarray(np_tree))
            want = decl_tree.dtype or cfg.param_dtype
            if tuple(t.shape) != decl_tree.shape or t.dtype != want:
                raise ValueError(
                    f"{path}: got {tuple(t.shape)} {t.dtype}, schema "
                    f"wants {decl_tree.shape} {want}")
            return t.to(device)
        if set(decl_tree) != set(np_tree):
            raise ValueError(f"{path or 'params'}: keys {sorted(np_tree)} "
                             f"!= schema keys {sorted(decl_tree)}")
        return {k: walk(decl_tree[k], np_tree[k], f"{path}/{k}")
                for k in sorted(decl_tree)}

    return walk(schema(cfg), tree_np, "")
