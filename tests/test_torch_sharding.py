"""The port's logical-axis sharding against the JAX package's, as pure
specs (no process group): for all ten archs, every input shape that
``shape_applicable`` allows, and both production meshes (16 x 16 and
2 x 16 x 16), the dry-run's rules, every partition-spec tree (parameters,
the whole-batch, paged and prefill caches, the batch, and the optimizer
state with f32, bf16 and int8 moments) leaf for leaf before and after
``validated``, the abstract trees' shapes and dtypes, and a training
cell's microbatch, remat and accumulation plan.  ``replan_batch`` is
the twin of ``test_train_substrate.py``'s.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported; JAX's backend is initialised first (one device) and the
variable is restored, so later subprocesses of the worker see their
own.  The JAX plan comes from ``build_cell`` on an ``AbstractMesh``,
which needs no devices.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import SHAPES as JSHAPES
from repro.configs import shape_applicable as j_shape_applicable
from repro.models import get_model as jget_model
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES, shape_applicable
from repro_torch.dist.sharding import MeshRules, P, placements, validated
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.model import get_model
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.train.elastic import replan_batch

ARCHS = sorted(jconfigs.registry())
CELLS = [(a, s, mp) for a in ARCHS for s in SHAPES for mp in (False, True)
         if shape_applicable(tconfigs.get(a), SHAPES[s]) is None]
PAGE, BLOCKS, PAGES = 16, 8, 64


@pytest.fixture(scope="module")
def jdry():
    jax.devices()                       # the backend keeps its one device
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


class _StubMesh:
    """What the JAX ``_validated`` reads of a mesh: its ``shape``."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def _walk(a, *rest, path=""):
    """Tuples (path, leaf of a, leaves of rest) of nested dicts with the
    same keys."""
    if isinstance(a, dict):
        for r in rest:
            assert set(a) == set(r), (path, sorted(a), sorted(r))
        for k in sorted(a):
            yield from _walk(a[k], *(r[k] for r in rest),
                             path=f"{path}/{k}")
    else:
        yield (path, a) + rest


def _dtype(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    return np.dtype(x).name


def _same_specs(jspecs, tspecs, jtree, sizes, jdry):
    """The two spec trees equal leaf for leaf as tuples, and so are their
    validated forms for the leaves of ``jtree`` over mesh ``sizes``."""
    n = 0
    for path, js, ts, leaf in _walk(jspecs, tspecs, jtree):
        assert isinstance(ts, P), (path, ts)
        assert tuple(js) == tuple(ts), (path, js, ts)
        shape = tuple(leaf.shape)
        assert tuple(jdry._validated(js, shape, _StubMesh(sizes))) == \
            tuple(validated(ts, shape, sizes)), (path, js)
        n += 1
    return n


def _same_abstract(jtree, ttree):
    for path, j, t in _walk(jtree, ttree):
        assert t.device.type == "meta", path
        assert tuple(j.shape) == tuple(t.shape), (path, j.shape, t.shape)
        assert np.dtype(j.dtype).name == _dtype(t.dtype), (path, j, t)


def _models(arch, shape_name, multi_pod, jdry):
    """Both packages' models and rules for the cell, with the 2-D EP block
    count the JAX ``run_cell`` sets."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    jmodel, tmodel = jget_model(jcfg), get_model(tcfg)
    jrules = jdry.rules_for(jmodel, jshape, multi_pod)
    trules = dryrun.rules_for(tmodel, shape, multi_pod)
    mshape, axes = production_mesh_shape(multi_pod)
    sizes = dict(zip(axes, mshape))
    if jcfg.n_experts and len(jrules.ep_axes) > 1:
        g = int(np.prod([sizes[a] for a in jrules.ep_axes]))
        jmodel = jget_model(dataclasses.replace(jcfg, ep_shards=g))
        tmodel = get_model(dataclasses.replace(tcfg, ep_shards=g))
    return jmodel, tmodel, jrules, trules, sizes


@pytest.mark.parametrize("arch,shape_name,multi_pod", CELLS)
def test_cell_specs_match_jax(arch, shape_name, multi_pod, jdry):
    jmodel, tmodel, jrules, trules, sizes = _models(arch, shape_name,
                                                    multi_pod, jdry)
    assert dataclasses.asdict(trules) == {
        f.name: getattr(jrules, f.name)
        for f in dataclasses.fields(jrules)}
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    assert shape_applicable(tmodel.cfg, shape) == j_shape_applicable(
        jmodel.cfg, jshape)
    B, S = shape.global_batch, shape.seq_len
    # parameters
    jp = jmodel.abstract_params()
    _same_abstract(jp, tmodel.abstract_params())
    jps = jmodel.param_pspecs(jrules)
    tps = tmodel.param_pspecs(trules)
    assert _same_specs(jps, tps, jp, sizes, jdry) > 0
    # the optimizer state, every moment dtype
    for md in ("float32", "bfloat16", "int8"):
        jopt, topt = JAdamW(JAdamWConfig(moment_dtype=md)), \
            AdamW(AdamWConfig(moment_dtype=md))
        ja = jopt.abstract_state(jp)
        _same_abstract(ja, topt.abstract_state(tmodel.abstract_params()))
        _same_specs(jopt.state_pspecs(jps), topt.state_pspecs(tps), ja,
                    sizes, jdry)
    # whole-batch cache and the prefill's parts
    jc = jmodel.abstract_cache(B, S)
    _same_abstract(jc, tmodel.abstract_cache(B, S))
    _same_specs(jmodel.cache_pspecs(B, S, jrules),
                tmodel.cache_pspecs(B, S, trules), jc, sizes, jdry)
    jpre = jmodel.prefill_cache_pspecs(jshape, jrules)
    tpre = tmodel.prefill_cache_pspecs(shape, trules)
    tcache = tmodel.cache_pspecs(B, S, trules)
    for k, spec in tpre.items():
        assert tuple(spec) == tuple(tcache[k]), k
    if jpre is None:              # the JAX SSM prefill returns no parts;
        assert set(tpre) == {"conv", "ssm"}     # the port's its states
    else:
        extra = set(tpre) - set(jpre)
        assert extra <= {"conv", "ssm"}, extra
        _same_specs(jpre, {k: tpre[k] for k in jpre},
                    {k: jc[k] for k in jpre}, sizes, jdry)
    # paged cache (decoder-only attention archs, as both packages refuse
    # the rest)
    cfg = tmodel.cfg
    if not (cfg.mamba_version or cfg.is_encoder_decoder):
        jpc = jmodel.abstract_paged_cache(B, BLOCKS, PAGE, PAGES)
        _same_abstract(jpc, tmodel.abstract_paged_cache(B, BLOCKS, PAGE,
                                                        PAGES))
        _same_specs(jmodel.paged_cache_pspecs(B, BLOCKS, PAGE, PAGES, jrules),
                    tmodel.paged_cache_pspecs(B, BLOCKS, PAGE, PAGES, trules),
                    jpc, sizes, jdry)
    else:
        with pytest.raises(ValueError):
            tmodel.paged_cache_pspecs(B, BLOCKS, PAGE, PAGES, trules)
    # a step's inputs
    ji = jmodel.input_specs(jshape)
    _same_abstract(ji, tmodel.input_specs(shape))
    _same_specs(jmodel.batch_pspecs(jshape, jrules),
                tmodel.batch_pspecs(shape, trules), ji, sizes, jdry)


@pytest.mark.parametrize("arch,multi_pod", [
    (a, mp) for a in ARCHS for mp in (False, True)])
def test_train_plan_matches_jax(arch, multi_pod, jdry):
    """The training cell's plan: ``plan_cell`` against what the JAX
    ``build_cell`` records (on an AbstractMesh: no devices), and
    ``_microbatches`` at every data-parallel width."""
    from jax.sharding import AbstractMesh
    jmodel, tmodel, jrules, trules, sizes = _models(arch, "train_4k",
                                                    multi_pod, jdry)
    mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    *_, info = jdry.build_cell(jmodel, JSHAPES["train_4k"], jrules, mesh)
    plan = dryrun.plan_cell(arch, "train_4k", multi_pod)
    assert plan["moment_dtype"] == info["moment_dtype"]
    assert plan["microbatches"] == info["microbatches"]
    assert plan.get("remat_group") == info.get("remat_group")
    n = jmodel.cfg.n_params()
    assert plan["accum_dtype"] == ("bfloat16" if n > 2e11 else "float32")
    for shape_name in ("train_4k", "prefill_32k"):
        for n_dp in (1, 2, 16, 32, 256):
            assert dryrun._microbatches(
                tmodel, SHAPES[shape_name], n_dp) == jdry._microbatches(
                    jmodel, JSHAPES[shape_name], n_dp)
    assert dryrun._params_bytes(tmodel) == jdry._params_bytes(jmodel)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_cell_bytes(arch):
    """Each tree's bytes a device holds: the whole tree's bytes divided
    leaf by leaf by the mesh axes its validated spec names."""
    for shape_name in SHAPES:
        plan = dryrun.plan_cell(arch, shape_name, False)
        if "skipped" in plan:
            assert plan["skipped"] == shape_applicable(
                tconfigs.get(arch), SHAPES[shape_name])
            continue
        model = get_model(tconfigs.get(arch))
        if "ep_shards" in plan:
            model = get_model(dataclasses.replace(
                model.cfg, ep_shards=plan["ep_shards"]))
        whole = dryrun._params_bytes(model)
        held = plan["per_device_bytes"]["params"]
        assert whole / 256 <= held <= whole, (shape_name, held, whole)
        if SHAPES[shape_name].kind == "train":
            assert plan["per_device_bytes"]["opt"] > 0


def test_placements_follow_validated_specs():
    """``placements``: Shard on each mesh dim that a validated entry
    names, in mesh order; a dim the axes do not divide replicates."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    assert placements(P(("pod", "data"), "model"), (64, 32), Mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert placements(P(("pod", "data"), "model"), (64, 24), Mesh) == (
        Shard(0), Shard(0), Replicate())
    assert placements(P(None, "data"), (3, 48), Mesh) == (
        Replicate(), Shard(1), Replicate())
    assert placements(P(("model", "data")), (256,), Mesh) == (
        Replicate(), Shard(0), Shard(0))        # split in mesh order
    rules = MeshRules(batch_axes=("data",), fsdp_axes=("data",),
                      ep_axes=("data", "model"))
    assert rules.resolve("moe_fsdp") is None
    assert rules.resolve("ep") == ("data", "model")
    assert MeshRules(use_fsdp=False).resolve("fsdp") is None
    with pytest.raises(ValueError):
        rules.resolve("heads")


def test_replan_batch_constant_global():
    for world in (2, 4, 8, 16):
        plan = replan_batch(256, world, max_per_shard=16)
        assert plan.per_step_batch == 256
        assert plan.per_shard_batch <= 16
