"""zamba2's sharded backward on fake meshes: the hybrid's training step
traced on fake tensors (``launch/dryrun.py::trace_cell``) with the work
a device held against the JAX package's census.

A tail Mamba2 layer after the shared block sends the block a gradient
that is Partial over the model axis (its input projection's dx), and
the Mamba2 input projection's output is chunked into z and x.  DTensor,
left to propagate those gradients as they come, runs the shared block's
FFN and the projections' backward products over the whole feature dim
on every model rank (at the 16 x 16 production cell, each of the shared
FFN's weight-gradient products over all 14,336 of d_ff);
``dist.sharding.constrain`` and ``models.layers.dense`` give the
gradients the placements the values had, as GSPMD does.

  * Reduced zamba2-7b with 7 layers (one group of 6 Mamba2 layers and
    its shared block, then a tail layer), S 64, batch 8, on a 1 x 1 and
    a 2 x 2 fake mesh: tensor-core ops by FLOPs of one op against the
    JAX package's HLO census of the same cells (a subprocess with four
    host devices, ``census_from_compiled``), port minus JAX pinned in
    ``PINNED`` with each difference's cause.
  * Reduced zamba2-7b's train, prefill and decode cells on the fake
    16 x 16 mesh: its 8 SSD heads of 16 do not divide the model axis,
    and the heads' split and merge replicate the channels first
    (``models.layers.split_heads``, ``merge_heads``), as GSPMD reshards.
  * zamba2-7b at published widths, 7 layers, S 4096, a global batch of
    16 (one row a data rank, the production cell's microbatch) on the
    fake 16 x 16 mesh: the step traces through its backward, and no
    product of the shared FFN or of the Mamba2 input projection runs
    over the whole feature dim: each is the rank's 1/16.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from torch_one_thread import _one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LAYERS = 7

# port minus JAX, tensor-core ops by FLOPs of one op (torch 2.13's DTensor)
PINNED = {
    # jnp contracts the SSD scan's three-operand einsums (a chunk's
    # state, y from the state) in another order than torch.einsum: 112
    # more small products and 21 more (B, c, H, hd)-sized ones in JAX;
    # XLA's backward recomputes 6 more score blocks of the shared
    # attention; the fused loss recomputes the logits GEMM (XLA merges it)
    "train/1x1": {16384: -112, 262144: -21, 1048576: -6, 16777216: 1},
    # the SSD differences as at 1 x 1 (a quarter the size); w_bc (B and
    # C, replicated over the model axis) and the K and V projections:
    # DTensor splits their products over the model axis and gathers the
    # outputs, where GSPMD computes them whole and their weight
    # gradients on the fsdp shard; XLA's 6 more score blocks
    "train/2x2": {4096: -112, 65536: -21, 262144: 14, 524288: -14,
                  1048576: -6},
}
CELLS = sorted(PINNED)

JAX_SIDE = r"""
import os, sys, json, collections, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
jax.devices()
import repro.core.hlo_counters as hc
import repro.launch.dryrun as jdry
from repro.configs import get, ShapeConfig
from repro.dist.sharding import use_mesh
from repro.models import get_model

orig_one = hc.ModuleCensus._one


def _one(self, inst, comp, out, count_bytes):
    before = out.mxu_flops
    orig_one(self, inst, comp, out, count_bytes)
    if inst.opcode == "dot" and out.mxu_flops != before:
        if not hasattr(out, "dots"):
            out.dots = collections.Counter()
        out.dots[int(out.mxu_flops - before)] += 1


orig_merge = hc.Census.merge_scaled


def merge(self, other, mult):
    orig_merge(self, other, mult)
    if hasattr(other, "dots"):
        if not hasattr(self, "dots"):
            self.dots = collections.Counter()
        for k, v in other.dots.items():
            self.dots[k] += v * mult


hc.ModuleCensus._one = _one
hc.Census.merge_scaled = merge


def mesh_of(dims):
    devs = np.asarray(jax.devices()[:dims[0] * dims[1]]).reshape(dims)
    try:
        return jax.sharding.Mesh(devs, ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
    except (AttributeError, TypeError):        # jax < 0.5: no AxisType
        return jax.sharding.Mesh(devs, ("data", "model"))


cfg = dataclasses.replace(get("zamba2-7b").reduced(),
                          n_layers=int(sys.argv[1]))
shape = ShapeConfig("train_small", 64, 8, "train")
res = {}
for dims in ((1, 1), (2, 2)):
    model = get_model(cfg)
    mesh = mesh_of(dims)
    rules = jdry.rules_for(model, shape, False)
    with use_mesh(mesh, rules):
        fn, args, in_sh, out_sh, donate, _ = jdry.build_cell(
            model, shape, rules, mesh)
        compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(*args).compile()
    c = hc.census_from_compiled(compiled)
    res[f"train/{dims[0]}x{dims[1]}"] = {
        "mxu_flops": c.mxu_flops,
        "dots": {str(k): v for k, v in c.dots.items()}}
print("RESULT" + json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(N_LAYERS)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith("RESULT")]
    assert run.returncode == 0 and lines, run.stderr[-3000:]
    return json.loads(lines[-1][len("RESULT"):])


def _trace(cfg, shape, dims):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    with fake_mesh(dims, ("data", "model")) as m:
        return dryrun.trace_cell("zamba2-7b", shape.name, False, cfg=cfg,
                                 shape=shape, mesh=m)["census"]


@pytest.mark.parametrize("cell", CELLS)
def test_tc_flops_against_the_jax_census(cell, jax_cells):
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    cfg = dataclasses.replace(configs.get("zamba2-7b").reduced(),
                              n_layers=N_LAYERS)
    dims = tuple(int(d) for d in cell.split("/")[1].split("x"))
    census = _trace(cfg, ShapeConfig("train_small", 64, 8, "train"), dims)
    port = collections.Counter()
    for (_, flops), n in census.tc_op_flops.items():
        port[flops] += n
    jax = collections.Counter({int(k): v for k, v in
                               jax_cells[cell]["dots"].items()})
    diff = {f: port[f] - jax[f] for f in set(port) | set(jax)
            if port[f] != jax[f]}
    assert diff == PINNED[cell]
    assert census.tc_flops - jax_cells[cell]["mxu_flops"] == sum(
        f * n for f, n in PINNED[cell].items())
    assert census.tc_flops == census.flop_counter_flops


def test_published_widths_on_the_16x16_mesh():
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("zamba2-7b"), n_layers=N_LAYERS)
    shape = dataclasses.replace(configs.SHAPES["train_4k"], global_batch=16)
    census = _trace(cfg, shape, (16, 16))
    assert census.tc_flops == census.flop_counter_flops > 0
    rows = shape.seq_len                 # one row of 4096 tokens a rank
    d, m = cfg.d_model, 16
    d_in = d * cfg.ssm_expand
    flops = collections.Counter()
    for (_, f), n in census.tc_op_flops.items():
        flops[f] += n
    # the shared FFN's products (w_gate, w_up, w_down, their dx and dW)
    # and the Mamba2 input projection's (w_zx: d -> 2 d_in), per rank
    for width in (cfg.d_ff, 2 * d_in):
        whole = 2 * rows * d * width
        assert flops[whole] == 0, (width, flops[whole])
        assert flops[whole // m] > 0, width


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_cells_on_the_16x16_mesh(kind):
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    census = _trace(configs.get("zamba2-7b").reduced(),
                    ShapeConfig(kind + "_small", 64, 16, kind), (16, 16))
    assert census.tc_flops == census.flop_counter_flops > 0
