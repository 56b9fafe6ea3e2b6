"""Logical-axis sharding: one place maps logical names to mesh axes —
port of ``repro/dist/sharding.py`` over a ``torch`` ``DeviceMesh``.

Parameters, caches and activations declare LOGICAL axes ("batch",
"model", "fsdp", "cache_seq", "ep", "moe_fsdp"); ``MeshRules`` resolves
them to the named dims of the active mesh (``("data", "model")`` or
``("pod", "data", "model")``).  The same model code runs unsharded on
one device (no mesh: every constraint is a no-op) and SPMD over a mesh,
where the state is ``DTensor``s placed by ``train.elastic.reshard``.

``P`` is the port's partition spec: a tuple with one entry per tensor
dim (None, a mesh axis name, or a tuple of them).  ``validated``
replicates a dim that its mesh axes do not divide, as the JAX package's
``_validated`` does; ``placements`` turns a validated spec into the
DTensor ``Shard``/``Replicate`` placements (never DTensor's uneven
sharding, so the shards are JAX's).  ``constrain`` is the torch form of
``with_sharding_constraint``: a ``redistribute`` of a DTensor to the
placements its logical names resolve to.

``island`` runs a function on the local shards of its DTensor inputs
(``local_map``): the hand-written kernels take raw device pointers, and
an op that DTensor does not propagate (an embedding gather, the
router's sort, the fused loss's own backward) runs there too, with the
placements the JAX ``constrain`` before it names.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

Axes = Tuple[str, ...]


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), ...)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _entry(axes: Axes):
    """Spec entry for a (possibly empty / multi) axis tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def entry_axes(entry) -> Axes:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical-axis -> mesh-axis mapping for one (shape x mesh) cell."""

    batch_axes: Axes = ()            # data-parallel axes for batch dims
    fsdp_axes: Axes = ()             # weight-shard axes (ZeRO-3 style)
    cache_seq_axes: Axes = ()        # KV-cache sequence sharding (decode)
    ep_axes: Axes = ("model",)       # expert-parallel axes (MoE blocks)
    model_axis: str = "model"        # tensor-parallel axis
    use_fsdp: bool = True

    def resolve(self, name: Optional[str]):
        if name is None:
            return None
        if name == "batch":
            return _entry(self.batch_axes)
        if name == "model":
            return self.model_axis
        if name == "fsdp":
            return _entry(self.fsdp_axes) if self.use_fsdp else None
        if name == "cache_seq":
            return _entry(self.cache_seq_axes)
        if name == "ep":
            return _entry(self.ep_axes)
        if name == "moe_fsdp":
            # fsdp axes not already consumed by expert parallelism
            if not self.use_fsdp:
                return None
            return _entry(tuple(a for a in self.fsdp_axes
                                if a not in self.ep_axes))
        raise ValueError(f"unknown logical axis {name!r}")


# --- active context -------------------------------------------------------
# Process-wide, where the JAX package's is thread-local: autograd runs a
# CUDA backward, and with it each checkpointed layer's recompute, on a
# device thread of its own, which must see the mesh the forward saw.

@dataclasses.dataclass
class _Context:
    mesh: Any = None
    rules: Optional[MeshRules] = None


_CTX = _Context()


def set_context(mesh, rules: Optional[MeshRules]) -> None:
    """Install mesh + rules for the rest of the process (launchers)."""
    _CTX.mesh = mesh
    _CTX.rules = rules


def current_mesh():
    return _CTX.mesh


def active_rules() -> Optional[MeshRules]:
    return _CTX.rules


@contextlib.contextmanager
def use_mesh(mesh, rules: MeshRules):
    """Scoped mesh + rules (multi-device tests, the card's mesh phase)."""
    prev = (_CTX.mesh, _CTX.rules)
    set_context(mesh, rules)
    try:
        yield mesh
    finally:
        set_context(*prev)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of anything with a ``shape``
    mapping (a mesh's shape given as such)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# --- specs and placements -------------------------------------------------

def validated(spec: Sequence, shape: Tuple[int, ...], mesh) -> P:
    """Replicate dims a mesh axis does not divide (reduced smoke shapes);
    axes missing from the mesh count as size 1."""
    sizes = mesh_shape(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        size = 1
        for a in entry_axes(entry):
            size *= sizes.get(a, 1)
        out.append(entry if size and shape[i] % size == 0 else None)
    return P(*out)


def placements(spec: Sequence, shape: Tuple[int, ...], mesh) -> tuple:
    """The DTensor placements, one per mesh dim, of ``spec`` validated
    for ``shape``: ``Shard(i)`` on every mesh dim that tensor dim i's
    entry names, ``Replicate()`` on the others.  DTensor splits a dim
    over several mesh dims in mesh order, so a multi-axis entry's chunks
    follow JAX's row-major combined index when it lists its axes in mesh
    order, as every activation, parameter and cache spec does.  The one
    entry that does not, an int8 moment's block dim of a ("model",
    "fsdp") parameter, is split in mesh order here: the same chunks on
    other ranks than JAX's, the same bytes a rank."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(validated(spec, shape, mesh)):
        for a in entry_axes(entry):
            if a in names:
                out[names.index(a)] = Shard(i)
    return tuple(out)


def logical_spec(names: Sequence[Optional[str]], rules: MeshRules,
                 mesh) -> P:
    """The spec of logical names under ``rules``, axes missing from the
    mesh dropped (``constrain``'s resolution)."""
    present = set(mesh_shape(mesh))
    entries = []
    for name in names:
        e = rules.resolve(name)
        entries.append(_entry(tuple(a for a in entry_axes(e)
                                    if a in present)))
    return P(*entries)


_DTENSOR = []        # DTensor's class, imported at the first subclass seen


def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor?  A plain tensor (the single-device path's every
    call) answers from its type alone, without touching
    ``torch.distributed``."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the placements of ``logical_axes`` under
    the active rules (a Partial value is reduced, a sharded one gathered
    or split); a no-op without an active mesh or on a plain tensor.
    Names missing from the mesh or not dividing the dim replicate."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None or not is_dtensor(x):
        return x
    spec = logical_spec(logical_axes, rules, mesh)
    return x.redistribute(mesh, placements(spec, tuple(x.shape), mesh))


def place(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """A plain tensor that every rank holds whole, as a DTensor placed by
    ``logical_axes`` (a no-op without a mesh or on a DTensor, which
    ``constrain`` moves instead)."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return x
    if is_dtensor(x):
        return constrain(x, *logical_axes)
    from torch.distributed.tensor import distribute_tensor
    spec = logical_spec(logical_axes, rules, mesh)
    return distribute_tensor(x, mesh, placements(spec, tuple(x.shape), mesh))


def on_mesh(*tensors) -> bool:
    """Is a mesh active and is any of ``tensors`` a DTensor?"""
    return _CTX.mesh is not None and any(is_dtensor(t) for t in tensors)


def mesh_coordinate(mesh, dims: Sequence[int]) -> int:
    """This rank's row-major combined index over mesh dims ``dims``."""
    coord = mesh.get_coordinate()
    r = 0
    for m in dims:
        r = r * mesh.shape[m] + coord[m]
    return r


def island(fn, mesh, args, in_placements, out_placements):
    """``fn`` on the local shards of ``args`` (``local_map``): each
    DTensor argument is first redistributed to its ``in_placements``,
    and the outputs come back as
    DTensors with ``out_placements``.  A Replicate input on a mesh dim
    where another input is sharded (each rank then does its own share of
    the work) gets a Partial gradient, reduced by whoever reads it; on a
    dim where every input is replicated the ranks repeat one computation
    and the gradient stays Replicate.  ``out_placements``: one output's
    placements, or a tuple of them for a tuple of outputs."""
    from torch.distributed.tensor import Partial, Placement, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)      # one output
    split = {m for pl in in_placements for m, p in enumerate(pl)
             if isinstance(p, Shard)}
    grads = tuple(tuple(Partial() if isinstance(p, Replicate) and m in split
                        else p for m, p in enumerate(pl))
                  for pl in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
