"""whisper's whole-batch decode step under a device mesh: the decode's
cross-attention over the cross cache sequence-sharded as the self cache
(``models/attention.py::mesh_cross_attention``), held against the JAX
package's sharded decode and its HLO census.

One module fixture runs the JAX side in a subprocess with four host
devices (``XLA_FLAGS`` set there only):

  * reduced whisper-large-v3 at f32 from ``jax.random.key(0)``, saved for
    the bridge; a (L, 4, 32, KV, hd) cache at pos 20 with per-slot
    windows from start [0, 3, 17, 5], the self and cross caches random
    from ``RandomState(0)`` and the cross cache's last 6 rows zero (its
    padding, which takes part in the decode's softmax in both packages);
    one ``decode_step`` jitted unsharded and on a (2, 2) ("data",
    "model") mesh under the decode rules (cache over "model") and the
    big-model rules (cache over "data" x "model");
  * the HLO census of the reduced whisper decode cell (bf16, B 8, T 64)
    at 1 x 1 and 2 x 2: ``mxu_flops`` and its dots by FLOPs of one, in
    the pattern of ``test_torch_step_census.py``.

Four gloo ranks (one intra-op thread each, a free local port) then take
the same step.  Held:

  * the port's sharded logits and written self caches against JAX's
    sharded ones (rtol = atol = 1e-4) and against the port's unsharded
    step (rtol = atol = 1e-5), under both rule sets, and once more with
    the cross cache handed in replicated over its sequence (the island
    constrains it onto ``cache_seq``);
  * the cross-attention inside its island: ``mesh_cross_attention`` once
    a layer, each rank's slice T / 2 (decode rules) or T / 4 (big-model
    rules) rows of its batch rows, all four heads;
  * the census: the port's tensor-core ops of the decode cell by FLOPs of
    one equal the JAX census's at 1 x 1 and 2 x 2 (no difference to pin);
  * the wire: the 2 x 2 cell's collective wire bytes a device are below
    one layer's local cross-cache bytes, which the gather of the whole
    cross cache on every rank moved twice a layer.
"""
import collections
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_one_thread import _one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-large-v3"
# the bounds of test_torch_dryrun_profile.py's decode step (chosen there
# before the first comparison; never widened)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)
B_DEC, T_DEC, POS, START, PAD = 4, 32, 20, [0, 3, 17, 5], 6
DEC_RULES = {
    "decode rules": dict(batch_axes=("data",), fsdp_axes=("data",),
                         cache_seq_axes=("model",), use_fsdp=False),
    "big-model rules": dict(batch_axes=(), fsdp_axes=("data",),
                            cache_seq_axes=("data", "model"),
                            ep_axes=("data", "model"), use_fsdp=True)}
# the census cells, B 8, T 64 in the reduced config's own dtype: (mesh,
# heads, None for the reduced config's 4 of 2 kv heads); 6 heads (and 6
# kv heads, whisper's own form) on (1, 4), where the model axis does not
# divide them and the attention's q projection splits them in
# gcd(6, 4) = 2 groups of 3
CENSUS_CELLS = {"decode/1x1": ((1, 1), None), "decode/2x2": ((2, 2), None),
                "decode/1x4, 6 heads": ((1, 4), 6)}

JAX_SIDE = r"""
import collections, dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
jax.devices()                        # 4 host devices before the imports
import repro.core.hlo_counters as hc
import repro.launch.dryrun as jdry
from repro.configs import get
from repro.configs.base import ShapeConfig
from repro.dist.sharding import MeshRules, use_mesh
from repro.models import get_model
from repro.train.elastic import reshard

out_dir = sys.argv[1]
spec = json.loads(sys.argv[2])


def mesh_of(dims):
    devs = np.asarray(jax.devices()[:dims[0] * dims[1]]).reshape(dims)
    try:
        return jax.sharding.Mesh(devs, ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
    except (AttributeError, TypeError):        # jax < 0.5: no AxisType
        return jax.sharding.Mesh(devs, ("data", "model"))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# one decode step, unsharded and on the (2, 2) mesh under each rule set
B, T = spec["B"], spec["T"]
cfg = dataclasses.replace(get(spec["arch"]).reduced(), dtype="float32")
model = get_model(cfg)
params = model.init(jax.random.key(0))
np.savez(os.path.join(out_dir, "params.npz"), **flat(params))
rng = np.random.RandomState(0)
cache = {k: np.asarray(v) for k, v in model.init_cache(B, T).items()}
for name in ("k", "v", "cross_k", "cross_v"):
    cache[name] = rng.randn(*cache[name].shape).astype(np.float32)
for name in ("cross_k", "cross_v"):
    cache[name][:, :, T - spec["pad"]:] = 0.0
cache["pos"] = np.asarray(spec["pos"], np.int32)
cache["start"] = np.asarray(spec["start"], np.int32)
tokens = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
np.savez(os.path.join(out_dir, "inputs.npz"), tokens=tokens, **cache)
jc = {k: jnp.asarray(v) for k, v in cache.items()}
logits, out = jax.jit(model.decode_step)(params, jnp.asarray(tokens), jc)
np.savez(os.path.join(out_dir, "jax_unsharded.npz"), logits=logits,
         k=out["k"], v=out["v"], pos=out["pos"])
mesh = mesh_of((2, 2))
shape = ShapeConfig("decode", T, B, "decode")
res = {"specs": {}, "census": {}}
for i, (tag, kw) in enumerate(spec["rules"].items()):
    rules = MeshRules(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in kw.items()})
    specs = model.batch_pspecs(shape, rules)
    with use_mesh(mesh, rules):
        p = reshard(params, model.param_pspecs(rules), mesh)
        t = reshard(jnp.asarray(tokens), specs["tokens"], mesh)
        c = reshard(jc, specs["cache"], mesh)
        logits, out = jax.jit(model.decode_step)(p, t, c)
    np.savez(os.path.join(out_dir, f"jax_mesh{i}.npz"), logits=logits,
             k=out["k"], v=out["v"], pos=out["pos"])
    res["specs"][tag] = str(out["cross_k"].sharding.spec)

# the decode cell's HLO census, each dot's FLOPs scaled by the trip
# counts as the census scales them
orig_one = hc.ModuleCensus._one
orig_merge = hc.Census.merge_scaled


def _one(self, inst, comp, out, count_bytes):
    before = out.mxu_flops
    orig_one(self, inst, comp, out, count_bytes)
    if inst.opcode == "dot" and out.mxu_flops != before:
        if not hasattr(out, "dots"):
            out.dots = collections.Counter()
        out.dots[int(out.mxu_flops - before)] += 1


def merge(self, other, mult):
    orig_merge(self, other, mult)
    if hasattr(other, "dots"):
        if not hasattr(self, "dots"):
            self.dots = collections.Counter()
        for k, v in other.dots.items():
            self.dots[k] += v * mult


hc.ModuleCensus._one = _one
hc.Census.merge_scaled = merge
shape = ShapeConfig("decode_small", 64, 8, "decode")
for cell, (dims, heads) in spec["census"].items():
    cfg = get(spec["arch"]).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)
    model = get_model(cfg)
    mesh = mesh_of(dims)
    rules = jdry.rules_for(model, shape, False)
    with use_mesh(mesh, rules):
        fn, args, in_sh, out_sh, donate, _ = jdry.build_cell(
            model, shape, rules, mesh)
        compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(*args).compile()
    c = hc.census_from_compiled(compiled)
    res["census"][cell] = {
        "mxu_flops": c.mxu_flops,
        "dots": {str(k): v for k, v in c.dots.items()}}
print("RESULT" + json.dumps(res))
"""

RANKS = r"""
import copy, dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        parts = k.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def worker(rank, port, data_dir, spec):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist.sharding import P, use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import attention, transformer
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_from_jax
    from repro_torch.train.elastic import gather, reshard
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(configs.get(spec["arch"]).reduced(),
                              dtype="float32")
    model = Model(cfg, plain_attention=True)
    params = params_from_jax(
        nest(dict(np.load(os.path.join(data_dir, "params.npz")))), cfg,
        device="cpu")
    inputs = {k: torch.from_numpy(v) for k, v in
              np.load(os.path.join(data_dir, "inputs.npz")).items()}
    tokens = inputs.pop("tokens")
    cache = inputs
    ref, ref_cache = model.decode_step(params, tokens, copy.deepcopy(cache))
    saved = {"unsharded": ref, "unsharded_k": ref_cache["k"],
             "unsharded_v": ref_cache["v"]}
    # each call of the cross-attention island, and the local shapes of
    # every decode partial (self and cross) inside the islands
    calls, partials = [], []
    island, partial = transformer.mesh_cross_attention, \
        attention._decode_partial

    def counted(q, k, v):
        calls.append(1)
        return island(q, k, v)

    def recorded(q, k, v, *a):
        partials.append([list(q.shape), list(k.shape)])
        return partial(q, k, v, *a)

    transformer.mesh_cross_attention = counted
    attention._decode_partial = recorded
    shape = ShapeConfig("decode", spec["T"], spec["B"], "decode")
    runs = [(tag, kw, False) for tag, kw in spec["rules"].items()]
    runs.append(("decode rules, cross cache replicated",
                 spec["rules"]["decode rules"], True))
    res = {}
    for i, (tag, kw, gathered) in enumerate(runs):
        # the rules the port's dry run picks for this cell, small and big
        dryrun._SERVE_FSDP_BYTES = 0 if kw["use_fsdp"] else 8e9
        rules = dryrun.rules_for(model, shape, False)
        specs = model.batch_pspecs(shape, rules)
        if gathered:
            for name in ("cross_k", "cross_v"):
                s = specs["cache"][name]
                specs["cache"][name] = P(s[0], s[1], None, s[3], s[4])
        del calls[:], partials[:]
        with use_mesh(mesh, rules):
            c = reshard(copy.deepcopy(cache), specs["cache"], mesh)
            cross_in = str(c["cross_k"].placements)
            logits, out = model.decode_step(
                reshard(params, model.param_pspecs(rules), mesh),
                reshard(tokens, specs["tokens"], mesh), c)
        out = gather(out)
        saved[f"mesh{i}"] = logits.full_tensor()
        saved[f"mesh{i}_k"], saved[f"mesh{i}_v"] = out["k"], out["v"]
        res[tag] = {
            "rules": {f: list(getattr(rules, f))
                      if isinstance(getattr(rules, f), tuple)
                      else getattr(rules, f) for f in kw},
            "cross_in": cross_in, "islands": len(calls),
            "partials": partials[:], "pos": int(out["pos"]),
            "unsharded_pos": int(ref_cache["pos"])}
    if rank == 0:
        np.savez(os.path.join(data_dir, "port.npz"),
                 **{k: v.numpy() for k, v in saved.items()})
        with open(os.path.join(data_dir, "port.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[2]), sys.argv[1],
                           json.loads(sys.argv[3])), nprocs=4)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SPEC = {"arch": ARCH, "B": B_DEC, "T": T_DEC, "pos": POS, "start": START,
        "pad": PAD, "rules": DEC_RULES, "census": CENSUS_CELLS}


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(JAX's result, its arrays' directory)."""
    tmp = tmp_path_factory.mktemp("whisper_mesh_decode")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(tmp),
                           json.dumps(SPEC)], env=_env(),
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.split("RESULT")[-1]), tmp


@pytest.fixture(scope="module")
def runs(jax_side):
    """(JAX's result, the port's result, their arrays' directory)."""
    jax_res, tmp = jax_side
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    proc = subprocess.run([sys.executable, str(script), str(tmp),
                           str(_free_port()), json.dumps(SPEC)], env=_env(),
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return jax_res, json.loads((tmp / "port.json").read_text()), tmp


RUNS = list(DEC_RULES) + ["decode rules, cross cache replicated"]


@pytest.mark.parametrize("i,tag", list(enumerate(RUNS)))
def test_sharded_step_matches_jax_and_unsharded(runs, i, tag):
    """Logits and written self caches of the port's step on the (2, 2)
    mesh against JAX's sharded step and the port's unsharded step."""
    jax_res, res, tmp = runs
    r = res[tag]
    rules = tag.split(",")[0]            # JAX's step under the same rules
    kw = DEC_RULES[rules]
    # the port's dry run picks the rules the JAX side was given
    assert r["rules"] == {k: list(v) if isinstance(v, tuple) else v
                          for k, v in kw.items()}, tag
    assert "'model'" in jax_res["specs"][rules]
    port = np.load(tmp / "port.npz")
    jax_mesh = np.load(tmp / f"jax_mesh{list(DEC_RULES).index(rules)}.npz")
    assert r["pos"] == r["unsharded_pos"] == int(jax_mesh["pos"]) == POS + 1
    np.testing.assert_allclose(port[f"mesh{i}"], jax_mesh["logits"],
                               err_msg=tag, **JAX_TOL)
    np.testing.assert_allclose(port[f"mesh{i}"], port["unsharded"],
                               err_msg=tag, **SELF_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(port[f"mesh{i}_{name}"], jax_mesh[name],
                                   err_msg=tag, **JAX_TOL)
        np.testing.assert_allclose(port[f"mesh{i}_{name}"],
                                   port[f"unsharded_{name}"], err_msg=tag,
                                   **SELF_TOL)
    jax_one = np.load(tmp / "jax_unsharded.npz")
    np.testing.assert_allclose(port["unsharded"], jax_one["logits"],
                               **JAX_TOL)


@pytest.mark.parametrize("tag", RUNS)
def test_cross_attention_runs_in_its_island(runs, tag):
    """One island a layer; each rank's partials over its slice of the
    cache's rows, its batch rows, all heads (the self cache's and the
    cross cache's alike: both are T rows)."""
    _, res, _ = runs
    r = res[tag]
    from repro_torch import configs
    cfg = configs.get(ARCH).reduced()
    L, H, KV, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert r["islands"] == L
    big = tag == "big-model rules"
    b, t = (B_DEC, T_DEC // 4) if big else (B_DEC // 2, T_DEC // 2)
    assert r["partials"] == [[[b, 1, H, hd], [b, t, KV, hd]]] * (2 * L)
    if "replicated" in tag:
        assert "Shard(dim=2)" not in r["cross_in"], r
    else:
        assert "Shard(dim=2)" in r["cross_in"], r


def _port_census(cell):
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    dims, heads = CENSUS_CELLS[cell]
    cfg = configs.get(ARCH).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)
    shape = ShapeConfig("decode_small", 64, 8, "decode")
    with fake_mesh(dims, ("data", "model")) as m:
        return dryrun.trace_cell(ARCH, shape.name, False, cfg=cfg,
                                 shape=shape, mesh=m)["census"]


@pytest.mark.parametrize("cell", list(CENSUS_CELLS))
def test_tc_flops_equal_the_jax_census(jax_side, cell):
    jax_res = jax_side[0]["census"][cell]
    census = _port_census(cell)
    port = collections.Counter()
    for (_, flops), n in census.tc_op_flops.items():
        port[flops] += n
    jax = collections.Counter({int(k): v for k, v in
                               jax_res["dots"].items()})
    diff = {f: port[f] - jax[f] for f in set(port) | set(jax)
            if port[f] != jax[f]}
    assert diff == {}
    assert census.tc_flops == jax_res["mxu_flops"]
    assert census.tc_flops == census.flop_counter_flops


def test_2x2_wire_below_one_layers_local_cross_cache():
    """Gathering the cross cache over the model axis moved (m - 1) / m of
    a layer's whole k and v on every rank; the combine moves f32 (B, 1,
    H) and (B, 1, H, D) partials."""
    import torch

    from repro_torch import configs
    cfg = configs.get(ARCH).reduced()
    census = _port_census("decode/2x2")
    # B 8 over data 2, T 64 over model 2, in the param dtype
    local = 2 * (8 // 2) * (64 // 2) * cfg.n_kv_heads * cfg.head_dim \
        * torch.empty((), dtype=cfg.param_dtype).element_size()
    assert 0 < census.collective_wire_bytes < local


def test_island_refuses_without_a_mesh_or_to_gather():
    """No active mesh: refused.  A cross cache sharded over its sequence
    that the cache_seq axes cannot split evenly (6 rows over 4) is not
    gathered: refused by name."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.sharding import MeshRules, use_mesh
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.attention import mesh_cross_attention
    q, kv = torch.zeros(2, 1, 4, 16), torch.zeros(2, 6, 2, 16)
    with pytest.raises(RuntimeError, match="DTensor cross cache"):
        mesh_cross_attention(q, kv, kv)
    rules = MeshRules(**DEC_RULES["decode rules"])
    with fake_mesh((1, 4), ("data", "model")) as m, use_mesh(m, rules):
        with FakeTensorMode():
            dq = distribute_tensor(torch.empty(2, 1, 4, 16), m,
                                   [Replicate(), Replicate()])
            dkv = distribute_tensor(torch.empty(2, 6, 2, 16), m,
                                    [Replicate(), Shard(1)])
            with pytest.raises(RuntimeError, match="6 rows do not divide"):
                mesh_cross_attention(dq, dkv, dkv)
