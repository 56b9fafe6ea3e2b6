"""The port's dry run, profiling half (``launch/dryrun.py::run_cell``,
``profiler/session.py``), on the CPU over fake process groups.

  * ``run_cell`` on reduced cells on a fake 2 x 2 mesh: dense (qwen2-0.5b,
    train), MoE with 2-D expert parallelism (llama4-scout, decode under
    the big-model serving rules: expert blocks over data x model, the
    cache over data x model), Mamba1 (falcon-mamba-7b, prefill) and
    whisper (train); and one production 16 x 16 cell of reduced
    qwen2-0.5b over a fake group of 256 ranks.  Each record has the JAX
    record's keys, ``flop_counter`` in place of ``xla_cost_analysis``,
    the JAX ``_memory_dict`` fields, per-device argument bytes equal to
    ``plan_cell``'s ``per_device_bytes``, and collective wire bytes
    above 0; at world size 1 the wire bytes are exactly 0.
  * A failing cell gives an error record and exit code 1;
    ``fake_production_mesh`` refuses by name beside a live group.
  * The whole-batch decode step under a mesh (``mesh_decode_attention``:
    the cache sequence-sharded, softmax partials combined over the
    sequence axes) on 4 gloo ranks, under the decode rules (cache over
    "model") and the big-model rules (cache over "data" x "model"):
    logits and the written caches held against the JAX package's
    ``decode_step`` jitted on the same (2, 2) mesh of four host devices
    (reduced qwen2-0.5b f32, the JAX weights bridged, rtol = atol =
    1e-4) and against the port's unsharded step (rtol = atol = 1e-5).
  * Both examples run on the CPU.
"""
import json
import os
import runpy
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_one_thread import _one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_KEYS = {"name", "n_devices", "hw", "memory", "census", "roofline",
               "irm", "flop_counter"}
MEMORY_KEYS = {"generated_code_size_in_bytes", "argument_size_in_bytes",
               "output_size_in_bytes", "alias_size_in_bytes",
               "temp_size_in_bytes", "device_total_bytes"}
CELLS = [("qwen2-0.5b", "train"), ("llama4-scout-17b-a16e", "decode"),
         ("falcon-mamba-7b", "prefill"), ("whisper-large-v3", "train")]


def _small(kind, batch=8):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig(kind + "_small", 64, batch, kind)


def _check(rec, arch, n_devices):
    assert RECORD_KEYS <= set(rec) and "xla_cost_analysis" not in rec
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["n_devices"] == n_devices and rec["arch"] == arch
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(
        rec["plan"]["per_device_bytes"].values())
    assert mem["alias_size_in_bytes"] == 0
    assert mem["device_total_bytes"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"])
    assert rec["flop_counter"]["flops"] == rec["census"]["tc_flops"] > 0
    rl = rec["roofline"]
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert rl["modeled_time_s"] == max(rl["compute_s"], rl["memory_s"],
                                       rl["collective_s"]) > 0
    assert 0 < rl["mfu_vs_peak"] < 1
    assert rec["irm"]["runtime_modeled"] is True


@pytest.mark.parametrize("arch,kind", CELLS)
def test_run_cell_on_a_fake_2x2_mesh(arch, kind, monkeypatch):
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    if arch.startswith("llama4"):
        # the big-model serving rules at a reduced size
        monkeypatch.setattr(dryrun, "_SERVE_FSDP_BYTES", 0)
    with fake_mesh((2, 2), ("data", "model")) as m:
        rec = dryrun.run_cell(arch, kind + "_small", False, verbose=False,
                              cfg=configs.get(arch).reduced(),
                              shape=_small(kind), mesh=m)
    _check(rec, arch, 4)
    assert rec["cell"] == f"{arch}/{kind}_small/mesh2x2"
    assert rec["census"]["collective_wire_bytes"] > 0
    if arch.startswith("llama4"):
        assert rec["plan"]["ep_shards"] == 4
        assert rec["rules"]["cache_seq_axes"] == ("data", "model")


def test_world_size_one_has_no_wire_bytes():
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    with fake_mesh((1, 1), ("data", "model")) as m:
        rec = dryrun.run_cell("qwen2-0.5b", "train_small", False,
                              verbose=False,
                              cfg=configs.get("qwen2-0.5b").reduced(),
                              shape=_small("train"), mesh=m)
    _check(rec, "qwen2-0.5b", 1)
    assert rec["census"]["collective_wire_bytes"] == 0
    assert rec["roofline"]["collective_s"] == 0


def test_production_16x16_cell_of_reduced_qwen2():
    from repro_torch import configs
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen2-0.5b", "train_small", False, verbose=False,
                          cfg=configs.get("qwen2-0.5b").reduced(),
                          shape=_small("train", batch=32))
    _check(rec, "qwen2-0.5b", 256)
    assert rec["cell"] == "qwen2-0.5b/train_small/pod16x16"
    assert rec["census"]["collective_wire_bytes"] > 0
    assert rec["build_info"]["microbatches"] == 1


def test_failing_cell_is_an_error_record_and_exit_1(tmp_path, monkeypatch,
                                                    capsys):
    from repro_torch.launch import dryrun

    def broken(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                      "--out-dir", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "qwen2-0.5b__decode_32k__pod16x16.json")
                     .read_text())
    assert rec["error"] == "RuntimeError: no such step"
    assert "FAILED qwen2-0.5b/decode_32k/pod16x16" in capsys.readouterr().out
    # --resume skips the cell whose record exists
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--out-dir", str(tmp_path), "--resume"]) == 0


def test_fake_production_mesh_refuses_beside_a_live_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_mesh, fake_production_mesh
    with fake_mesh((2, 2), ("data", "model")):
        with pytest.raises(RuntimeError, match="already exists"):
            with fake_production_mesh():
                pass
    assert not dist.is_initialized()


# the decode step on the 2 x 2 mesh, the port against the JAX package's
# jitted step on the same mesh: f32 logits and cache rows at the bound
# tests/test_torch_dense_model.py holds the unsharded decode to; the
# sharded port against its own unsharded step at rtol = atol = 1e-5
# (both chosen before the first comparison; never widened)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)
B_DEC, T_DEC, POS, START = 4, 32, 20, [0, 3, 17, 5]
# repro.launch.dryrun.rules_for's decode rules on one pod, small and big
# model, each as keyword arguments of both packages' MeshRules
DEC_RULES = {
    "decode rules": dict(batch_axes=("data",), fsdp_axes=("data",),
                         cache_seq_axes=("model",), use_fsdp=False),
    "big-model rules": dict(batch_axes=(), fsdp_axes=("data",),
                            cache_seq_axes=("data", "model"),
                            ep_axes=("data", "model"), use_fsdp=True)}

JAX_DECODE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get
from repro.configs.base import ShapeConfig
from repro.dist.sharding import MeshRules, use_mesh
from repro.models import get_model
from repro.train.elastic import reshard

out_dir = sys.argv[1]
spec = json.loads(sys.argv[2])
try:
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
except (AttributeError, TypeError):            # jax < 0.5: no AxisType
    mesh = jax.make_mesh((2, 2), ("data", "model"))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


B, T = spec["B"], spec["T"]
cfg = dataclasses.replace(get("qwen2-0.5b").reduced(), dtype="float32")
model = get_model(cfg)
params = model.init(jax.random.key(0))
np.savez(os.path.join(out_dir, "params.npz"), **flat(params))
rng = np.random.RandomState(0)
cache = {k: np.asarray(v) for k, v in model.init_cache(B, T).items()}
for name in ("k", "v"):
    cache[name] = rng.randn(*cache[name].shape).astype(np.float32)
cache["pos"] = np.asarray(spec["pos"], np.int32)
cache["start"] = np.asarray(spec["start"], np.int32)
tokens = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
np.savez(os.path.join(out_dir, "inputs.npz"), tokens=tokens, **cache)
jc = {k: jnp.asarray(v) for k, v in cache.items()}
logits, out = jax.jit(model.decode_step)(params, jnp.asarray(tokens), jc)
np.savez(os.path.join(out_dir, "jax_unsharded.npz"), logits=logits,
         k=out["k"], v=out["v"], pos=out["pos"])
res = {}
shape = ShapeConfig("decode", T, B, "decode")
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
    res[tag] = {"k_spec": str(out["k"].sharding.spec)}
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
    from repro_torch.dist.sharding import MeshRules, use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_from_jax
    from repro_torch.train.elastic import gather, reshard
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(configs.get("qwen2-0.5b").reduced(),
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
    shape = ShapeConfig("decode", spec["T"], spec["B"], "decode")
    res = {}
    for i, (tag, kw) in enumerate(spec["rules"].items()):
        # the rules the port's dry run picks for this cell, small and big
        dryrun._SERVE_FSDP_BYTES = 0 if kw["use_fsdp"] else 8e9
        rules = dryrun.rules_for(model, shape, False)
        specs = model.batch_pspecs(shape, rules)
        with use_mesh(mesh, rules):
            logits, out = model.decode_step(
                reshard(params, model.param_pspecs(rules), mesh),
                reshard(tokens, specs["tokens"], mesh),
                reshard(copy.deepcopy(cache), specs["cache"], mesh))
            k_placements = str(out["k"].placements)
        out = gather(out)
        saved[f"mesh{i}"] = logits.full_tensor()
        saved[f"mesh{i}_k"], saved[f"mesh{i}_v"] = out["k"], out["v"]
        res[tag] = {
            "rules": {f: list(getattr(rules, f))
                      if isinstance(getattr(rules, f), tuple)
                      else getattr(rules, f) for f in kw},
            "k_placements": k_placements,
            "pos": int(out["pos"]),
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


def test_mesh_decode_equals_unsharded_on_4_gloo_ranks(tmp_path):
    """Reduced qwen2-0.5b at f32, the JAX package's weights, a random
    (L, 4, 32, KV, hd) cache at pos 20 with per-slot windows from
    start [0, 3, 17, 5]: one decode step on a (2, 2) mesh under the
    decode rules (cache over "model") and the big-model rules (cache
    over "data" x "model"), the JAX package's jitted step under GSPMD in
    a subprocess with four host devices, the port's on four gloo ranks.
    The port's sharded logits and written caches are held against
    JAX's sharded ones and against the port's own unsharded step."""
    spec = {"B": B_DEC, "T": T_DEC, "pos": POS, "start": START,
            "rules": DEC_RULES}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", JAX_DECODE, str(tmp_path),
                           json.dumps(spec)], env=env, capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jax_res = json.loads(proc.stdout.split("RESULT")[-1])
    script = tmp_path / "ranks.py"
    script.write_text(RANKS)
    proc = subprocess.run([sys.executable, str(script), str(tmp_path),
                           str(_free_port()), json.dumps(spec)], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads((tmp_path / "port.json").read_text())
    port = np.load(tmp_path / "port.npz")
    for i, (tag, kw) in enumerate(DEC_RULES.items()):
        r = res[tag]
        # the port's dry run picks the rules the JAX side was given
        assert r["rules"] == {k: list(v) if isinstance(v, tuple) else v
                              for k, v in kw.items()}, tag
        assert "Shard(dim=2)" in r["k_placements"], (tag, r)
        assert "Shard(dim=2)" not in jax_res[tag]["k_spec"]   # its own form
        assert "'model'" in jax_res[tag]["k_spec"], jax_res[tag]
        jax_mesh = np.load(tmp_path / f"jax_mesh{i}.npz")
        assert r["pos"] == r["unsharded_pos"] == int(jax_mesh["pos"]) \
            == POS + 1
        np.testing.assert_allclose(port[f"mesh{i}"], jax_mesh["logits"],
                                   err_msg=tag, **JAX_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(port[f"mesh{i}_{name}"],
                                       jax_mesh[name], err_msg=tag,
                                       **JAX_TOL)
            np.testing.assert_allclose(port[f"mesh{i}_{name}"],
                                       port[f"unsharded_{name}"],
                                       err_msg=tag, **SELF_TOL)
        np.testing.assert_allclose(port[f"mesh{i}"], port["unsharded"],
                                   err_msg=tag, **SELF_TOL)
    jax_one = np.load(tmp_path / "jax_unsharded.npz")
    np.testing.assert_allclose(port["unsharded"], jax_one["logits"],
                               **JAX_TOL)


def test_examples_run_on_the_cpu(tmp_path, capsys):
    ex = os.path.join(ROOT, "examples")
    quick = runpy.run_path(os.path.join(ex, "quickstart_torch.py"))
    assert quick["main"](["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "peak GIPS (Eq.3):        180.24" in out
    assert "tensor-core flops: 1.07 GFLOP" in out
    prof = runpy.run_path(os.path.join(ex, "profile_model_torch.py"))
    svg = tmp_path / "irm.svg"
    assert prof["main"](["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                         "--plot", str(svg)]) == 0
    out = capsys.readouterr().out
    assert '"cell": "qwen2-0.5b/decode_32k/pod16x16"' in out
    assert svg.read_text().startswith("<svg")
