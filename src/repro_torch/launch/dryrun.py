"""The dry-run's cell plan — port of the planning half of
``repro/launch/dryrun.py``.

For an (architecture x input shape) cell on the single-pod 16 x 16 mesh
or the 2 x 16 x 16 multi-pod mesh, ``plan_cell`` returns what the JAX
``run_cell``/``build_cell`` decide before they compile: the mesh rules
(``rules_for``), the MoE block count of 2-D expert parallelism, and for
a training cell the moment dtype, the microbatch count, the layer group
of grouped remat and the gradient-accumulation dtype; and the bytes each
device holds of every state tree (parameters, optimizer state, batch,
cache) under the validated specs of that mesh.  Nothing is allocated:
the trees are meta tensors.

The JAX module's other half, lowering and compiling each cell on 512
placeholder devices with XLA's ``memory_analysis``/``cost_analysis`` and
its HLO census, has no torch counterpart and is not imitated.

    python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES, ShapeConfig, shape_applicable
from repro_torch.dist.sharding import MeshRules, entry_axes, validated
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.model import Model, get_model
from repro_torch.optim.adamw import AdamW, AdamWConfig, tree_leaves

# params above this per-TP-shard size keep FSDP sharding even for serving
_SERVE_FSDP_BYTES = 8e9


def _params_bytes(model: Model) -> float:
    return float(sum(p.numel() * p.element_size()
                     for p in tree_leaves(model.abstract_params())))


def rules_for(model: Model, shape: ShapeConfig,
              multi_pod: bool) -> MeshRules:
    pod = ("pod",) if multi_pod else ()
    if shape.kind == "train" or shape.kind == "prefill":
        return MeshRules(batch_axes=pod + ("data",),
                         fsdp_axes=pod + ("data",),
                         cache_seq_axes=("model",),
                         use_fsdp=True)
    # decode
    tp = 16
    big = _params_bytes(model) / tp > _SERVE_FSDP_BYTES
    if shape.global_batch == 1:                      # long_500k
        return MeshRules(batch_axes=(),
                         fsdp_axes=("data",),
                         cache_seq_axes=pod + ("data", "model"),
                         use_fsdp=big)
    if big:
        # 2-D weight-stationary serving (the JAX package's grok decode):
        # batch on "pod" only, weights sharded data x model, expert blocks
        # EP-sharded across data x model, the KV cache sequence-sharded
        # across data x model
        return MeshRules(batch_axes=pod,
                         fsdp_axes=("data",),
                         cache_seq_axes=("data", "model"),
                         ep_axes=("data", "model"),
                         use_fsdp=True)
    return MeshRules(batch_axes=pod + ("data",),
                     fsdp_axes=pod + ("data",),
                     cache_seq_axes=("model",),
                     use_fsdp=False)


def _microbatches(model: Model, shape: ShapeConfig, n_dp: int,
                  budget_bytes: float = 3e9) -> int:
    """Gradient-accumulation factor keeping the per-device residual stack
    (L x B_loc x S x d x 2 bytes, the remat checkpoint) under budget."""
    cfg = model.cfg
    b_loc = max(1, shape.global_batch // n_dp)
    stack = cfg.n_layers * b_loc * shape.seq_len * cfg.d_model * 2.0
    if cfg.is_encoder_decoder:
        stack *= 2
    mb = 1
    while stack / mb > budget_bytes and mb < b_loc:
        mb *= 2
    while b_loc % mb != 0:
        mb *= 2
    return min(mb, b_loc)


def _remat_group(cfg, shape: ShapeConfig, n_dp: int, mb: int
                 ) -> Optional[int]:
    """The layer group of grouped remat when the residual stack is still
    over budget at ``mb`` microbatches (dense attention families only);
    None when per-block remat fits."""
    b_loc = max(1, shape.global_batch // n_dp // mb)
    stack = cfg.n_layers * b_loc * shape.seq_len * cfg.d_model * 2.0
    if stack <= 3e9 or cfg.mamba_version or cfg.is_encoder_decoder:
        return None
    for g in (2, 4, 8):
        if cfg.n_layers % g == 0 and stack / g <= 3e9:
            break
    return g


def per_device_bytes(tree, specs, sizes: Dict[str, int]) -> int:
    """Bytes one device holds of a tree of meta tensors placed by
    ``specs`` (validated for each leaf's shape over the mesh ``sizes``)."""
    if isinstance(tree, torch.Tensor):
        n = tree.numel()
        for entry in validated(specs, tuple(tree.shape), sizes):
            for a in entry_axes(entry):
                n //= sizes[a]
        return n * tree.element_size()
    return sum(per_device_bytes(tree[k], specs[k], sizes) for k in tree)


def plan_cell(arch: str, shape_name: str, multi_pod: bool
              ) -> Dict[str, Any]:
    """The cell's plan (see the module docstring), or {"skipped": why}."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    mesh_shape, axes = production_mesh_shape(multi_pod)
    sizes = dict(zip(axes, mesh_shape))
    out: Dict[str, Any] = {
        "cell": f"{arch}/{shape_name}/"
                f"{'pod2x16x16' if multi_pod else 'pod16x16'}"}
    skip = shape_applicable(cfg, shape)
    if skip:
        return dict(out, skipped=skip)
    model = get_model(cfg)
    rules = rules_for(model, shape, multi_pod)
    if cfg.n_experts and len(rules.ep_axes) > 1:
        # 2-D expert parallelism: the block count follows the ep axes
        g = 1
        for a in rules.ep_axes:
            g *= sizes[a]
        cfg = dataclasses.replace(cfg, ep_shards=g)
        model = get_model(cfg)
        out["ep_shards"] = g
    out["rules"] = dataclasses.asdict(rules)
    p_specs = model.param_pspecs(rules)
    trees = {"params": per_device_bytes(model.abstract_params(), p_specs,
                                        sizes)}
    b_specs = model.batch_pspecs(shape, rules)
    inputs = model.input_specs(shape)
    if shape.kind == "train":
        n = cfg.n_params()
        moment_dtype = "bfloat16" if n > 5e10 else "float32"
        n_dp = 1
        for a in rules.batch_axes:
            n_dp *= sizes[a]
        mb = _microbatches(model, shape, n_dp)
        g = _remat_group(cfg, shape, n_dp, mb)
        if g is not None:
            out["remat_group"] = g
        opt = AdamW(AdamWConfig(moment_dtype=moment_dtype))
        out.update(moment_dtype=moment_dtype, microbatches=mb,
                   accum_dtype="bfloat16" if n > 2e11 else "float32")
        trees["opt"] = per_device_bytes(
            opt.abstract_state(model.abstract_params()),
            opt.state_pspecs(p_specs), sizes)
        trees["batch"] = per_device_bytes(inputs, b_specs, sizes)
    elif shape.kind == "prefill":
        trees["batch"] = per_device_bytes(inputs, b_specs, sizes)
    else:
        trees["tokens"] = per_device_bytes(inputs["tokens"],
                                           b_specs["tokens"], sizes)
        trees["cache"] = per_device_bytes(inputs["cache"], b_specs["cache"],
                                          sizes)
    out["per_device_bytes"] = trees
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    archs = sorted(configs.registry()) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                print(json.dumps(plan_cell(arch, shape_name, mp)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
