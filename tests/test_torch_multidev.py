"""The port's multi-device path on four gloo ranks of the CPU, held
against the JAX package on the same 2 x 2 mesh.

One module fixture runs the JAX side in a subprocess with four host
devices (``XLA_FLAGS`` set there only): reduced llama4-scout and
qwen2-0.5b at f32 from ``jax.random.key(0)``, saved for the bridge, and
the MoE loss unsharded and on a 2 x 2 ("data", "model") mesh under
``MeshRules(batch_axes=("data",), fsdp_axes=("data",))``, at capacity
factor 1.25 and 100.  Then it spawns four ranks (one intra-op thread
each, a free local port) that bridge the same weights, ``reshard`` them
and report every result at once:

  * ``reshard`` on the (2, 2) mesh: each rank's local shard of every
    parameter and AdamW moment (f32 and int8) is the slice its validated
    spec names, and ``full_tensor`` returns the tree bit for bit;
  * the MoE island: the port's sharded ``Model.loss`` (llama4-scout
    reduced, E 4, ``ep_shards`` 4, B 4, S 32) against JAX's sharded loss
    to rtol 1e-5; both within the JAX test's 2e-2 of the unsharded loss
    (local and global capacity differ); at capacity factor 100 nothing
    is dropped and sharded equals unsharded to rtol 1e-5;
  * a data-parallel ``train_step`` of reduced qwen2-0.5b on a (2, 1)
    mesh, global batch 4, at 1 and 2 microbatches and with int8 moments
    (updated whole on every rank), against the
    single-process step on the whole batch: loss and grad norm to rtol
    1e-5, each updated parameter to a relative norm error of 1e-5;
  * two ``Trainer`` steps on the (2, 1) mesh, a checkpoint of the
    gathered state every step, against the single-process run;
  * a tensor-parallel ``Model.loss`` of reduced qwen2-0.5b on a (1, 2)
    mesh under the train rules against the unsharded loss, rtol 1e-5.

The (2, 1) and (1, 2) meshes are the inner dims of a (2, 2, 1) and a
(2, 1, 2) mesh whose leading "rep" axis no rule names, so all four ranks
take part and the two copies run the same step.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SIDE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get
from repro.dist.sharding import MeshRules, use_mesh
from repro.models import get_model
from repro.train.elastic import reshard

out_dir = sys.argv[1]
try:
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
except (AttributeError, TypeError):            # jax < 0.5: no AxisType
    mesh = jax.make_mesh((2, 2), ("data", "model"))
rules = MeshRules(batch_axes=("data",), fsdp_axes=("data",))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


for arch in ("llama4-scout-17b-a16e", "qwen2-0.5b"):
    cfg = dataclasses.replace(get(arch).reduced(), dtype="float32")
    params = get_model(cfg).init(jax.random.key(0))
    np.savez(os.path.join(out_dir, f"{arch}.npz"), **flat(params))
rng = np.random.RandomState(0)
batch = {"tokens": rng.randint(0, 256, (4, 32)).astype(np.int32),
         "labels": rng.randint(0, 256, (4, 32)).astype(np.int32)}
np.savez(os.path.join(out_dir, "batch.npz"), **batch)
base = dataclasses.replace(get("llama4-scout-17b-a16e").reduced(),
                           dtype="float32")
params = get_model(base).init(jax.random.key(0))
jb = {k: jnp.asarray(v) for k, v in batch.items()}
res = {}
for cf in (1.25, 100.0):
    model = get_model(dataclasses.replace(base, capacity_factor=cf))
    ref = float(jax.jit(model.loss)(params, jb))
    with use_mesh(mesh, rules):
        p_sh = reshard(params, model.param_pspecs(rules), mesh)
        b_sh = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))), jb)
        sh = float(jax.jit(model.loss)(p_sh, b_sh))
    res[str(cf)] = {"unsharded": ref, "sharded": sh}
print("RESULT" + json.dumps(res))
"""

RANKS = r"""
import dataclasses, json, os, sys
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


def worker(rank, port, data_dir, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.dist.sharding import (
        MeshRules, P, entry_axes, mesh_shape, use_mesh, validated)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import get_model
    from repro_torch.models.params import params_from_jax
    from repro_torch.optim.adamw import AdamW, AdamWConfig, tree_leaves
    from repro_torch.train.elastic import gather, reshard
    from repro_torch.train.train_step import make_train_step

    res = {}
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(data_dir, "batch.npz")).items()}
    rows = {k: P("data", None) for k in batch}
    rules = MeshRules(batch_axes=("data",), fsdp_axes=("data",))

    def load(arch, **kw):
        cfg = dataclasses.replace(configs.get(arch).reduced(),
                                  dtype="float32", **kw)
        tree = nest(dict(np.load(os.path.join(data_dir, f"{arch}.npz"))))
        return cfg, params_from_jax(tree, cfg, device="cpu")

    host = make_host_mesh(4)
    res["host_mesh"] = [list(host.mesh_dim_names), list(host.shape)]
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    # the MoE island
    for cf in (1.25, 100.0):
        cfg, params = load("llama4-scout-17b-a16e", capacity_factor=cf)
        model = get_model(cfg)
        ref = float(model.loss(params, batch))
        with use_mesh(mesh, rules):
            loss = model.loss(reshard(params, model.param_pspecs(rules),
                                      mesh), reshard(batch, rows, mesh))
        res[f"moe_{cf}"] = {"unsharded": ref,
                            "sharded": float(loss.full_tensor()),
                            "placements": str(loss.placements)}

    # reshard: each rank's shard is its spec's slice; the round trip
    sizes, coord = mesh_shape(mesh), mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)

    def slice_of(x, spec):
        for i, e in enumerate(validated(spec, tuple(x.shape), mesh)):
            idx, n = 0, 1                     # the chunk, in mesh order
            for a in sorted(entry_axes(e), key=names.index):
                idx = idx * sizes[a] + coord[names.index(a)]
                n *= sizes[a]
            c = x.shape[i] // n
            x = x.narrow(i, idx * c, c)
        return x

    cfg, params = load("llama4-scout-17b-a16e")
    model = get_model(cfg)
    p_specs = model.param_pspecs(rules)
    for md in ("float32", "int8"):
        opt = AdamW(AdamWConfig(moment_dtype=md))
        state = {"params": params, "opt": opt.init(params)}
        specs = {"params": p_specs, "opt": opt.state_pspecs(p_specs)}
        placed = reshard(state, specs, mesh)
        whole, local, spec_l = (tree_leaves(state), tree_leaves(placed),
                                tree_leaves_specs(specs))
        res[f"reshard_{md}"] = {
            "leaves": len(whole),
            "sharded": sum(any(p.is_shard() for p in x.placements)
                           for x in local),
            "local_ok": all(torch.equal(slice_of(x, s), y.to_local())
                            for x, y, s in zip(whole, local, spec_l)),
            "full_ok": all(torch.equal(x, y) for x, y in
                           zip(whole, tree_leaves(gather(placed))))}

    # a data-parallel step on (2, 1), a tensor-parallel loss on (1, 2)
    cfg, params = load("qwen2-0.5b")
    model = get_model(cfg)
    p_specs = model.param_pspecs(rules)
    dp = init_device_mesh("cpu", (2, 2, 1),
                          mesh_dim_names=("rep", "data", "model"))
    for tag, mb, md in (("mb1", 1, "float32"), ("mb2", 2, "float32"),
                        ("int8", 1, "int8")):
        opt = AdamW(AdamWConfig(lr=1e-3, moment_dtype=md))
        specs = {"params": p_specs, "opt": opt.state_pspecs(p_specs)}
        step = make_train_step(model, opt, microbatches=mb)
        st0 = opt.init(params)
        ref_p, _, ref_m = step(params, st0, batch)
        with use_mesh(dp, rules):
            sp = reshard({"params": params, "opt": st0}, specs, dp)
            new_p, new_o, m = step(sp["params"], sp["opt"],
                                   reshard(batch, rows, dp))
        new_p = gather(new_p)
        res[f"dp_{tag}"] = {
            "loss": [float(ref_m["loss"]), float(m["loss"])],
            "grad_norm": [float(ref_m["grad_norm"]),
                          float(m["grad_norm"])],
            "step": int(gather(new_o)["step"]),
            "param_rel": max(
                float(torch.linalg.vector_norm(a - b)
                      / torch.linalg.vector_norm(b))
                for a, b in zip(tree_leaves(new_p), tree_leaves(ref_p))),
            "sharded_leaves": sum(
                any(p.is_shard() for p in x.placements)
                for x in tree_leaves(sp["params"]))}
    # the Trainer on the (2, 1) mesh, a checkpoint every step, against
    # the Trainer on one process
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def trainer(ckpt_dir=None):
        return Trainer(model, AdamWConfig(lr=1e-3),
                       DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4, seed=0),
                       TrainerConfig(steps=2, checkpoint_every=1,
                                     checkpoint_dir=ckpt_dir, log_every=100,
                                     async_checkpoint=False, device="cpu"))

    ref = trainer().run()["losses"]
    ckpt_dir = os.path.join(data_dir, "ckpt")
    with use_mesh(dp, rules):
        got = trainer(ckpt_dir).run()
    dist.barrier()
    restored = ckpt.restore(ckpt_dir, {"params": gather(got["params"]),
                                       "opt": gather(got["opt"])})
    res["trainer"] = {
        "losses": [ref, got["losses"]],
        "restored_step": restored[0],
        "restored_equal": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored[1]["params"]),
            tree_leaves(gather(got["params"]))))}
    tp = init_device_mesh("cpu", (2, 1, 2),
                          mesh_dim_names=("rep", "data", "model"))
    ref = float(model.loss(params, batch))
    with use_mesh(tp, rules):
        p_sh = reshard(params, p_specs, tp)
        loss = model.loss(p_sh, reshard(batch, rows, tp))
    res["tp"] = {"unsharded": ref, "sharded": float(loss.full_tensor()),
                 "wq": str(p_sh["blocks"]["attn"]["wq"].placements)}
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def tree_leaves_specs(tree):
    from repro_torch.dist.sharding import P
    if isinstance(tree, P):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves_specs(tree[k])]


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[3]), sys.argv[1], sys.argv[2]),
             nprocs=4)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("multidev")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d)],
                          env=_env(), capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")]
    jax_res = json.loads(line[-1][len("RESULT"):])
    script = d / "ranks.py"
    script.write_text(RANKS)
    out = d / "out.json"
    proc = subprocess.run([sys.executable, str(script), str(d), str(out),
                           str(free_port())], env=_env(),
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return jax_res, json.loads(out.read_text())


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("cf", [1.25, 100.0])
def test_moe_island_matches_jax_sharded(results, cf):
    jax_res, res = results
    ours, theirs = res[f"moe_{cf}"], jax_res[str(cf)]
    assert _rel(ours["sharded"], theirs["sharded"]) < 1e-5, (ours, theirs)
    assert _rel(ours["unsharded"], theirs["unsharded"]) < 1e-5
    for r in (ours, theirs):
        assert _rel(r["sharded"], r["unsharded"]) < 2e-2, r
    assert ours["placements"] == "(Replicate(), Replicate())"


def test_moe_nothing_dropped_sharded_equals_unsharded(results):
    ours = results[1]["moe_100.0"]
    assert _rel(ours["sharded"], ours["unsharded"]) < 1e-5, ours
    # at capacity 1.25 the local capacity drops other rows than the global
    ours = results[1]["moe_1.25"]
    assert ours["sharded"] != ours["unsharded"]


@pytest.mark.parametrize("md", ["float32", "int8"])
def test_reshard_round_trip(results, md):
    r = results[1][f"reshard_{md}"]
    assert r["local_ok"] and r["full_ok"], r
    assert r["sharded"] > r["leaves"] // 2, r
    assert results[1]["host_mesh"] == [["data", "model"], [4, 1]]


@pytest.mark.parametrize("case", ["mb1", "mb2", "int8"])
def test_data_parallel_step(results, case):
    r = results[1][f"dp_{case}"]
    assert _rel(r["loss"][1], r["loss"][0]) < 1e-5, r
    assert _rel(r["grad_norm"][1], r["grad_norm"][0]) < 1e-5, r
    assert r["param_rel"] < 1e-5, r
    assert r["step"] == 1 and r["sharded_leaves"] > 0, r


def test_trainer_on_the_mesh(results):
    """Two ``Trainer`` steps on the (2, 1) mesh equal the single-process
    run's losses; the checkpoint that rank 0 wrote of the gathered state
    restores the final parameters bit for bit."""
    r = results[1]["trainer"]
    for a, b in zip(*r["losses"]):
        assert _rel(b, a) < 1e-5, r
    assert r["restored_step"] == 2 and r["restored_equal"], r


def test_tensor_parallel_loss(results):
    r = results[1]["tp"]
    assert _rel(r["sharded"], r["unsharded"]) < 1e-5, r
    assert "Shard(dim=1)" in r["wq"], r        # wq's heads over "model"


def _launch(port, host_id, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "1", "--coordinator", f"127.0.0.1:{port}",
         "--num-hosts", "2", "--host-id", str(host_id), *extra],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.mark.parametrize("smoke", [False, True])
def test_launcher_multi_host_flags(smoke):
    """Two ranks through ``launch.train``'s multi-host flags: without
    ``--local-smoke`` the production mesh is refused by name (it needs
    256 ranks); with it each rank trains its shard of the batch."""
    port = free_port()
    extra = ("--local-smoke",) if smoke else ("--batch", "4")
    procs = [_launch(port, i, *extra) for i in (0, 1)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        if smoke:
            assert p.returncode == 0, err[-2000:]
            assert "[launch.train] done: loss" in out
        else:
            assert p.returncode == 2, (out, err[-2000:])
            assert "needs 256 ranks" in err and "has 2" in err, err
