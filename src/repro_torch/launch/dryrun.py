"""Multi-pod dry-run driver — port of ``repro/launch/dryrun.py``.

For an (architecture x input shape) cell on the single-pod 16 x 16 mesh
or the 2 x 16 x 16 multi-pod mesh, ``plan_cell`` returns what the JAX
``run_cell``/``build_cell`` decide before they compile: the mesh rules
(``rules_for``), the MoE block count of 2-D expert parallelism, and for
a training cell the moment dtype, the microbatch count, the layer group
of grouped remat and the gradient-accumulation dtype; and the bytes each
device holds of every state tree (parameters, optimizer state, batch,
cache) under the validated specs of that mesh.  Nothing is allocated:
the trees are meta tensors.

``run_cell`` is the other half, the JAX module's lower-compile-profile:
it builds the cell's real step (``build_cell``: ``make_train_step`` with
the plan's moment dtype, microbatches, remat group and accumulation
dtype, or ``Model.prefill``, or ``Model.decode_step``) over fake tensors
placed by ``train.elastic.reshard`` on the production mesh of a fake
process group of 256 or 512 ranks (``launch.mesh.fake_production_mesh``),
traces it once on the plain route (the JAX dry run compiles
``attention_impl="reference"``; the kernels' ctypes wrappers cannot take
fake tensors) and profiles it (``profiler.profile_step``): the
per-device census, memory, three-term roofline and H100 instruction
profile, against an H100 SXM's data-sheet constants.  Records go to
``build/dryrun_torch/``; a cell that cannot be traced is an error
record, and ``main`` exits 1.

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --resume
    python -m repro_torch.launch.dryrun --arch grok-1-314b --plan-only
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES, ShapeConfig, shape_applicable
from repro_torch.dist.sharding import (
    MeshRules, entry_axes, mesh_shape, use_mesh, validated)
from repro_torch.launch.mesh import fake_production_mesh, production_mesh_shape
from repro_torch.models.model import Model, get_model
from repro_torch.optim.adamw import AdamW, AdamWConfig, tree_leaves, tree_map

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "..", "build", "dryrun_torch")

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


def mesh_name(multi_pod: bool, sizes: Optional[Dict[str, int]] = None
              ) -> str:
    if sizes is None:
        return "pod2x16x16" if multi_pod else "pod16x16"
    return "mesh" + "x".join(str(v) for v in sizes.values())


def _cell(arch: str, shape_name: str, multi_pod: bool, cfg=None,
          shape: Optional[ShapeConfig] = None,
          sizes: Optional[Dict[str, int]] = None):
    """(plan, model, rules, shape) of a cell; ``cfg``, ``shape`` and the
    mesh ``sizes`` default to the arch's config, ``SHAPES[shape_name]``
    and the production mesh."""
    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    if sizes is None:
        mesh_dims, axes = production_mesh_shape(multi_pod)
        named = None
        sizes = dict(zip(axes, mesh_dims))
    else:
        named = sizes
    out: Dict[str, Any] = {
        "cell": f"{arch}/{shape_name}/{mesh_name(multi_pod, named)}"}
    skip = shape_applicable(cfg, shape)
    if skip:
        return dict(out, skipped=skip), None, None, shape
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
    return out, model, rules, shape


def plan_cell(arch: str, shape_name: str, multi_pod: bool
              ) -> Dict[str, Any]:
    """The cell's plan (see the module docstring), or {"skipped": why}."""
    return _cell(arch, shape_name, multi_pod)[0]


def _fake(tree):
    """Fake CPU tensors of a tree of meta tensors (under the caller's
    ``FakeTensorMode``)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def build_cell(model: Model, shape: ShapeConfig, plan: Dict[str, Any], mesh
               ) -> Tuple[Any, tuple, Dict[str, Any]]:
    """(step, args, info) of a cell: the step the cell runs and its
    arguments, fake tensors placed on ``mesh`` by ``reshard`` under the
    active rules (call it under ``use_mesh`` and a ``FakeTensorMode``).
    The model runs on the plain route."""
    from repro_torch.dist.sharding import active_rules
    from repro_torch.train.elastic import reshard
    from repro_torch.train.train_step import make_train_step
    rules = active_rules()
    cfg = model.cfg
    info: Dict[str, Any] = {}
    if "remat_group" in plan:
        cfg = dataclasses.replace(cfg, remat_group=plan["remat_group"])
        info["remat_group"] = plan["remat_group"]
    model = Model(cfg, plain_attention=True)
    p_specs = model.param_pspecs(rules)
    params = reshard(_fake(model.abstract_params()), p_specs, mesh)
    inputs = model.input_specs(shape)
    b_specs = model.batch_pspecs(shape, rules)
    if shape.kind == "train":
        info.update(moment_dtype=plan["moment_dtype"],
                    microbatches=plan["microbatches"],
                    accum_dtype=plan["accum_dtype"])
        opt = AdamW(AdamWConfig(moment_dtype=plan["moment_dtype"]))
        state = reshard(_fake(opt.abstract_state(model.abstract_params())),
                        opt.state_pspecs(p_specs), mesh)
        step = make_train_step(model, opt, microbatches=plan["microbatches"],
                               accum_dtype=getattr(torch,
                                                   plan["accum_dtype"]))
        batch = reshard(_fake(inputs), b_specs, mesh)
        return step, (params, state, batch), info
    if shape.kind == "prefill":
        def prefill(params, batch):
            return model.prefill(params, batch)
        return prefill, (params, reshard(_fake(inputs), b_specs, mesh)), info

    def decode(params, tokens, cache):
        return model.decode_step(params, tokens, cache)
    tokens = reshard(_fake(inputs["tokens"]), b_specs["tokens"], mesh)
    cache = reshard(_fake(inputs["cache"]), b_specs["cache"], mesh)
    return decode, (params, tokens, cache), info


def h100_sxm():
    """The dry run's card: an H100 SXM from its data sheet (132 SMs,
    1980 MHz, 80 GiB, the data sheet's HBM rate); no card is read."""
    from repro_torch.core.hardware import h100_spec
    return h100_spec("NVIDIA H100 SXM (data sheet)", 132, 1980.0,
                     80 * 2 ** 30)


def summary_line(record: Dict[str, Any]) -> str:
    """The JAX dry run's line of a record."""
    mem = record.get("memory", {})
    rl = record.get("roofline", {})
    return (f"[dryrun] {record['cell']}: trace {record['trace_s']:.1f}s | "
            f"dev bytes {mem.get('device_total_bytes', 0)/2**30:.2f} GiB | "
            f"{rl.get('dominant')}-bound | modeled "
            f"{float(rl.get('modeled_time_s') or 0)*1e3:.2f} ms | "
            f"MFU {float(rl.get('mfu_vs_peak') or 0)*100:.1f}% | "
            f"collective wire "
            f"{record['census']['collective_wire_bytes']/1e9:.3f} GB")


def trace_cell(arch: str, shape_name: str, multi_pod: bool, *, cfg=None,
               shape: Optional[ShapeConfig] = None, mesh=None
               ) -> Dict[str, Any]:
    """Build and trace one cell on fake tensors (arguments as
    ``run_cell``'s): {"plan", "model", "shape"} and, unless the plan
    skips the cell, {"census", "info", "build_s", "trace_s",
    "n_devices"}."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.step_census import census_of_step
    sizes = mesh_shape(mesh) if mesh is not None else None
    plan, model, rules, shape = _cell(arch, shape_name, multi_pod, cfg,
                                      shape, sizes)
    out = {"plan": plan, "model": model, "shape": shape}
    if "skipped" in plan:
        return out
    ctx = (contextlib.nullcontext(mesh) if mesh is not None
           else fake_production_mesh(multi_pod))
    with ctx as m, use_mesh(m, rules):
        t0 = time.time()
        with FakeTensorMode():
            fn, args, out["info"] = build_cell(model, shape, plan, m)
        out["build_s"] = time.time() - t0
        out["census"] = census_of_step(fn, *args)
        out["trace_s"] = time.time() - t0 - out["build_s"]
        out["n_devices"] = m.size()
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, *, cfg=None,
             shape: Optional[ShapeConfig] = None, mesh=None
             ) -> Dict[str, Any]:
    """Build, trace and profile one cell (see the module docstring)
    against ``h100_sxm()``.  ``cfg`` and ``shape`` replace the arch's
    config and ``SHAPES[shape_name]`` (reduced cells); ``mesh`` is a
    DeviceMesh over a live fake group to use instead of the production
    mesh."""
    from repro_torch.profiler.session import profile_census
    t = trace_cell(arch, shape_name, multi_pod, cfg=cfg, shape=shape,
                   mesh=mesh)
    plan = t["plan"]
    if "skipped" in plan:
        return plan
    cell = plan["cell"]
    record = profile_census(cell, t["census"], t["n_devices"], h100_sxm(),
                            model_flops=t["model"].model_flops(t["shape"]))
    rules = plan["rules"]
    record.update({
        "cell": cell, "arch": arch, "shape": t["shape"].name,
        "mesh": cell.rsplit("/", 1)[1], "multi_pod": multi_pod,
        "build_s": t["build_s"], "trace_s": t["trace_s"],
        "build_info": t["info"],
        "rules": {k: rules[k] for k in ("batch_axes", "fsdp_axes",
                                        "cache_seq_axes", "use_fsdp")},
        "plan": plan,
    })
    if verbose:
        print(summary_line(record))
        sys.stdout.flush()
    return record


def _out_path(arch: str, shape_name: str, multi_pod: bool,
              out_dir: str = RESULTS_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape_name}__"
                                 f"{mesh_name(multi_pod)}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists")
    ap.add_argument("--plan-only", action="store_true",
                    help="print each cell's plan as a JSON line; trace "
                         "nothing")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    archs = sorted(configs.registry()) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                if args.plan_only:
                    print(json.dumps(plan_cell(arch, shape_name, mp)))
                    continue
                path = _out_path(arch, shape_name, mp, args.out_dir)
                if args.resume and os.path.exists(path):
                    continue
                try:
                    rec = run_cell(arch, shape_name, mp)
                except Exception as e:                      # noqa: BLE001
                    rec = {"cell": f"{arch}/{shape_name}/{mesh_name(mp)}",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures.append(rec["cell"])
                    print(f"[dryrun] FAILED {rec['cell']}: {rec['error']}")
                    sys.stdout.flush()
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
    if args.plan_only:
        return 0
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}")
        return 1
    print("[dryrun] all requested cells OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
