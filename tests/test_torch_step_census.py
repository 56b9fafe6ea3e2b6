"""The port's per-device step census (``core/step_census.py``) on the CPU:
fake tensors, fake process groups, and the JAX package's HLO census of
the same cells.

  * The sharded matmul of a 16 x 16 mesh: (64, 4096) Shard(0)/Replicate
    @ (4096, 4096)^T Replicate/Shard(0) counts the local product only,
    2 * 4 * 4096 * 256 = 8,388,608 FLOPs a device (FlopCounterMode over
    DTensors reports the global 2,147,483,648), with the all-gather's
    operand and wire bytes by hand; DTensor's global-shape propagation
    product runs during the census and is not counted.  Without the
    census's guard a plain dispatch mode sees that global product.
  * Ceil-tiled tensor-core issues and the padding efficiency by hand for
    M = 1, 16 and 17; f32 products summed apart from bf16 ones; an
    elementwise op's bytes and a view's; the peak live bytes of small
    chains by hand.
  * One device: ``tc_flops`` equals FlopCounterMode's total exactly.
  * Against the JAX package: reduced qwen2-0.5b's train, prefill and
    decode cells at one device (a 1 x 1 mesh) and on a 2 x 2 mesh.  The
    JAX side runs in a subprocess with four host devices and reports
    ``census_from_compiled(...).mxu_flops`` of each compiled cell and its
    dots by FLOPs of one.  Tolerance: zero after the pinned differences.
    Prefill and decode at one device agree exactly; every other
    difference is pinned op by op (count of tensor-core ops of each size,
    port minus JAX) in ``PINNED`` and listed in ROADMAP queue 3.
"""
import collections
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_one_thread import _one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# port minus JAX, tensor-core ops by FLOPs of one op (torch 2.13's DTensor)
PINNED = {
    # the fused loss recomputes the 512 x 64 x 256 logits GEMM in its
    # backward (XLA merges the two); XLA's backward recomputes 12 more
    # QK^T score blocks (2 * 32 * 32 * 16 a batch-head) than the port's
    "train/1x1": {16777216: 1, 1048576: -12},
    # + the unembedding over the whole vocabulary on each model rank
    # (GSPMD splits the vocabulary: 4 GEMMs of 4,194,304 there), the
    # score blocks as at 1 x 1, and the projections' tensor-parallel
    # splits (DTensor's strategies against GSPMD's)
    "train/2x2": {8388608: 4, 4194304: -4, 2097152: 4, 1048576: -16,
                  524288: 12, 262144: -12},
    "prefill/1x1": {},
    # the K/V projections split over the model axis (then gathered),
    # computed whole on each rank by GSPMD
    "prefill/2x2": {1048576: -4, 524288: 4},
    "decode/1x1": {},
    # the decode logits over the whole vocabulary (131,072 against
    # 65,536), and the projections' splits
    "decode/2x2": {131072: 1, 65536: 3, 32768: -3, 16384: -1},
}
CELLS = sorted(PINNED)

JAX_SIDE = r"""
import os, sys, json, collections
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
jax.devices()                        # 4 host devices before the import below
import repro.core.hlo_counters as hc
import repro.launch.dryrun as jdry
from repro.configs import get, ShapeConfig
from repro.dist.sharding import use_mesh
from repro.models import get_model

# each dot's FLOPs, scaled by the trip counts as the census scales them
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


cfg = get("qwen2-0.5b").reduced()
res = {}
for kind in ("train", "prefill", "decode"):
    shape = ShapeConfig(kind + "_small", 64, 8, kind)
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
        res[f"{kind}/{dims[0]}x{dims[1]}"] = {
            "mxu_flops": c.mxu_flops,
            "dots": {str(k): v for k, v in c.dots.items()}}
print("RESULT" + json.dumps(res))
"""


@pytest.fixture
def mesh16():
    from repro_torch.launch.mesh import fake_mesh
    with fake_mesh((16, 16), ("data", "model")) as m:
        yield m


def _probe_args(mesh, n_out):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 4096), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(n_out, 4096), mesh,
                              [Replicate(), Shard(0)])
    return x, w


def test_probe_sharded_matmul_counts_local_shards(mesh16, monkeypatch):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.core.step_census import census_of_step
    calls = []
    orig = ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"]

    def counted(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(ShardingPropagator,
                        "_propagate_tensor_meta_non_cached", counted)
    x, w = _probe_args(mesh16, 4096)
    c = census_of_step(
        lambda a, b: (a @ b.t()).redistribute(mesh16, [Shard(0),
                                                       Replicate()]), x, w)
    assert calls, "the global-shape propagation did not run in the census"
    assert c.tc_flops == 2 * 4 * 4096 * 256 == 8_388_608
    assert c.flop_counter_flops == 8_388_608          # not 2,147,483,648
    assert c.opcode_counts["aten.mm"] == 1
    assert c.tc_op_flops == {("aten.mm", 8_388_608): 1}
    # the product is (4, 256) on each rank; the redistribute gathers the
    # 16 model ranks' columns: a (64, 256) f32 result, 15/16 on the wire
    ag = c.collectives["all-gather"]
    assert (ag.count, ag.operand_bytes) == (1, 64 * 256 * 4)
    assert ag.wire_bytes == 64 * 256 * 4 * 15 / 16
    assert c.collective_wire_bytes == ag.wire_bytes
    # arguments: this rank's (4, 4096) and (256, 4096) f32 shards
    assert c.argument_bytes == (4 * 4096 + 256 * 4096) * 4
    assert c.output_bytes == 4 * 4096 * 4


def test_propagation_trap_exists_without_the_guard(mesh16):
    """A bare dispatch mode over the same kind of product sees DTensor's
    global-shape propagation product beside the local one."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func is torch.ops.aten.mm.default:
                seen.append((tuple(args[0].shape), tuple(args[1].shape)))
            return func(*args, **(kwargs or {}))

    x, w = _probe_args(mesh16, 2048)          # a schema no test has cached
    with x._local_tensor.fake_mode, Mode():
        x @ w.t()
    assert ((64, 4096), (4096, 2048)) in seen
    assert ((4, 4096), (4096, 128)) in seen


@pytest.mark.parametrize("M", [1, 16, 17])
def test_ceil_tiled_issues_and_padding(M):
    from repro_torch.core.gpu_model import profile_from_census
    from repro_torch.core.hardware import h100_spec
    from repro_torch.core.step_census import census_of_step
    c = census_of_step(lambda x, w: x @ w, torch.empty(M, 64),
                       torch.empty(64, 64))
    tiles = -(-M // 16)
    assert c.tc_issues == tiles * (64 // 8) * (64 // 16)
    assert c.tc_flops == 2 * M * 64 * 64
    assert c.tc_flops_padded == c.tc_issues * 4096
    prof = profile_from_census("mm", c, h100_spec("H100", 132, 1980.0, 0),
                               runtime_s=1.0)
    assert prof.tc_padding_efficiency == pytest.approx(M / (16 * tiles))


def test_f32_products_summed_apart():
    """A bf16 product counts in ``tc_flops`` only; an f32 one in
    ``tc_flops_f32`` too, which the roofline prices at the f32 peak."""
    from repro_torch.core.step_census import census_of_step
    f = 2 * 32 * 64 * 48
    half = census_of_step(lambda x, w: x @ w,
                          torch.empty(32, 64, dtype=torch.bfloat16),
                          torch.empty(64, 48, dtype=torch.bfloat16))
    assert (half.tc_flops, half.tc_flops_f32) == (f, 0)
    both = census_of_step(lambda x, w: (x @ w, x.float() @ w.float()),
                          torch.empty(32, 64, dtype=torch.bfloat16),
                          torch.empty(64, 48, dtype=torch.bfloat16))
    assert (both.tc_flops, both.tc_flops_f32) == (2 * f, f)


def test_elementwise_and_view_bytes():
    from repro_torch.core.step_census import census_of_step
    a, b = torch.empty(8, 16), torch.empty(8, 16)
    c = census_of_step(torch.add, a, b)
    assert c.hbm_bytes == 3 * 8 * 16 * 4
    assert (c.warp_flops, c.warp_issues) == (128, 4)
    assert c.class_counts == {"warp": 1}
    v = census_of_step(lambda t: t.view(16, 8), a)
    assert v.hbm_bytes == 0 and v.flops == 0 and v.warp_issues == 0
    assert v.class_counts == {"free": 1}


def test_peak_live_bytes_by_hand():
    from repro_torch.core.step_census import census_of_step
    from repro_torch.profiler.session import memory_dict
    n = 256 * 4                                      # (256,) f32

    def kept(a):
        b = a * 2
        c = b + 1
        return c * 3

    def freed(a):
        b = a * 2
        c = b + 1
        del b
        d = c * 3
        del c
        return d

    k = census_of_step(kept, torch.empty(256))
    assert k.peak_live_bytes == 4 * n                # a, b, c, d
    f = census_of_step(freed, torch.empty(256))
    assert f.peak_live_bytes == 3 * n                # a and two at a time
    mem = memory_dict(f)
    assert (mem["argument_size_in_bytes"], mem["output_size_in_bytes"],
            mem["temp_size_in_bytes"], mem["alias_size_in_bytes"]) == (
                n, n, n, 0)
    assert mem["device_total_bytes"] == f.peak_live_bytes


def test_one_device_tc_flops_equal_the_flop_counter():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import configs
    from repro_torch.core.step_census import census_of_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, AdamWConfig, tree_map
    from repro_torch.train.train_step import make_train_step
    model = Model(configs.get("qwen2-0.5b").reduced(), plain_attention=True)
    opt = AdamW(AdamWConfig())
    with FakeTensorMode():
        def fake(tree):
            return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                            tree)
        params = fake(model.abstract_params())
        state = fake(opt.abstract_state(model.abstract_params()))
        batch = {k: torch.empty(4, 32, dtype=torch.int32)
                 for k in ("tokens", "labels")}
    c = census_of_step(make_train_step(model, opt, microbatches=2), params,
                       state, batch)
    assert c.tc_flops > 0
    assert c.tc_flops == c.flop_counter_flops
    assert c.tc_flops == sum(f * n for (_, f), n in c.tc_op_flops.items())


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE], env=env,
                         capture_output=True, text=True, timeout=600)
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith("RESULT")]
    assert run.returncode == 0 and lines, run.stderr[-3000:]
    return json.loads(lines[-1][len("RESULT"):])


@pytest.mark.parametrize("cell", CELLS)
def test_tc_flops_against_the_jax_census(cell, jax_cells):
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    kind, dims = cell.split("/")
    shape = ShapeConfig(kind + "_small", 64, 8, kind)
    with fake_mesh(tuple(int(d) for d in dims.split("x")),
                   ("data", "model")) as m:
        census = dryrun.trace_cell(
            "qwen2-0.5b", shape.name, False,
            cfg=configs.get("qwen2-0.5b").reduced(), shape=shape,
            mesh=m)["census"]
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
