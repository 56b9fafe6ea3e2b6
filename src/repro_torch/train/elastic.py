"""Elastic scaling: place a state on a (new) mesh and keep the global batch
across world sizes — port of ``repro/train/elastic.py``.

Checkpoints hold whole, mesh-agnostic tensors (``train/checkpoint.py``),
so an elastic resize is a restore plus a re-placement under the new
mesh's rules:

  * ``replan_batch``: keep the GLOBAL batch constant across world sizes
    by recomputing the per-shard batch and the gradient-accumulation
    factor (the loss scale and the optimizer's hyperparameters are then
    unchanged when ranks join or leave);
  * ``reshard``: place a whole state tree onto a mesh by the schema's
    partition specs, each leaf a DTensor (``distribute_tensor``) with
    the validated placements: a dim that the new mesh's axes no longer
    divide is replicated, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.dist.sharding import P, placements


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    global_batch: int
    n_data_shards: int
    per_shard_batch: int
    grad_accum: int

    @property
    def per_step_batch(self) -> int:
        return self.per_shard_batch * self.n_data_shards * self.grad_accum


def replan_batch(global_batch: int, n_data_shards: int,
                 max_per_shard: int = 64) -> BatchPlan:
    """Keep the global batch fixed while the data-parallel world resizes."""
    assert global_batch % n_data_shards == 0, (global_batch, n_data_shards)
    per = global_batch // n_data_shards
    accum = 1
    while per > max_per_shard:
        assert per % 2 == 0, per
        per //= 2
        accum *= 2
    return BatchPlan(global_batch, n_data_shards, per, accum)


def reshard(state, pspecs, mesh) -> Any:
    """Place a whole (every rank holding the same values) state tree onto
    ``mesh`` per ``pspecs`` (a tree of ``P`` of the same structure):
    each leaf a DTensor with the validated placements."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(state, torch.Tensor):
        assert isinstance(pspecs, P), pspecs
        return distribute_tensor(state, mesh, placements(
            pspecs, tuple(state.shape), mesh))
    return {k: reshard(state[k], pspecs[k], mesh) for k in sorted(state)}


def gather(state) -> Any:
    """The whole tensors of a placed tree (``full_tensor`` of each
    DTensor leaf; a plain leaf as it is)."""
    if isinstance(state, torch.Tensor):
        return state.full_tensor() if hasattr(state, "full_tensor") \
            else state
    return {k: gather(state[k]) for k in sorted(state)}
