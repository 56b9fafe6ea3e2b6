"""The Mamba1, hybrid and encoder-decoder families under a device mesh:
the port on four gloo ranks of the CPU, held against the JAX package on
the same 2 x 2 mesh.

One module fixture runs the JAX side in a subprocess with four host
devices (``XLA_FLAGS`` set there only): reduced falcon-mamba-7b,
zamba2-7b and whisper-large-v3 at f32 from ``jax.random.key(0)``, saved
for the bridge, a B 4, S 32 batch from ``RandomState(0)`` (whisper's
frames from ``randn``), and for each arch the unsharded loss, the loss
on a (2, 2) ("data", "model") mesh under the train rules
``MeshRules(batch_axes=("data",), fsdp_axes=("data",))`` and every
gradient leaf of ``jax.grad(model.loss)`` on that mesh.  Then four ranks
(one intra-op thread each, a free local port) bridge the same weights,
``reshard`` them and report at once:

  * the unsharded and the sharded ``Model.loss``, each within 1e-5
    relative of JAX's, and the sharded loss's placements (a replicated
    0-d DTensor);
  * every gradient leaf of the sharded loss (``loss_and_grads``, each
    reduced to its parameter's placements), ``full_tensor()`` against
    JAX's sharded gradient: ``allclose`` at rtol 1e-4 and atol 1e-4 x
    the leaf's max abs, the bound ``test_torch_train_families.py`` holds
    the unsharded gradients to (two frameworks' f32 sums in another
    order), chosen before the first comparison.  On the (2, 2) mesh
    each rank's channels cover half of x_proj's (and w_bc's) output, so
    a Bc or Cc gradient left un-summed over the model axis would come
    out half the truth;
  * the scans inside their islands: with remat per layer, the
    selective-scan wrapper (the CPU's plain route) and ``ssd_scan`` run
    twice a layer (forward and recompute), each time on local tensors
    only, d_in / 2 (or H / 2) channels of B / 2 rows a rank;
  * two ``Trainer`` steps on the mesh against the single-process run's
    losses, within 1e-5 relative.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_one_thread import _one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["falcon-mamba-7b", "zamba2-7b", "whisper-large-v3"]
# every gradient leaf: |port - JAX| <= ATOL x the leaf's max abs + RTOL x
# |JAX| (stated before the first comparison; never widened)
RTOL, ATOL = 1e-4, 1e-4

JAX_SIDE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get
from repro.dist.sharding import MeshRules, use_mesh
from repro.models import get_model
from repro.train.elastic import reshard

out_dir, archs = sys.argv[1], sys.argv[2].split(",")
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


res = {}
for arch in archs:
    cfg = dataclasses.replace(get(arch).reduced(), dtype="float32")
    model = get_model(cfg)
    params = model.init(jax.random.key(0))
    np.savez(os.path.join(out_dir, f"{arch}.npz"), **flat(params))
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, 256, (4, 32)).astype(np.int32),
             "labels": rng.randint(0, 256, (4, 32)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.randn(4, 32, cfg.d_model).astype(np.float32)
    np.savez(os.path.join(out_dir, f"{arch}.batch.npz"), **batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = float(jax.jit(model.loss)(params, jb))
    with use_mesh(mesh, rules):
        p_sh = reshard(params, model.param_pspecs(rules), mesh)
        b_sh = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))), jb)
        sh, grads = jax.jit(jax.value_and_grad(model.loss))(p_sh, b_sh)
    np.savez(os.path.join(out_dir, f"{arch}.grads.npz"), **flat(grads))
    res[arch] = {"unsharded": ref, "sharded": float(sh)}
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


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def worker(rank, port, data_dir, archs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.sharding import MeshRules, P, is_dtensor, use_mesh
    from repro_torch.kernels import ssm_scan
    from repro_torch.models import ssm
    from repro_torch.models.model import get_model
    from repro_torch.models.params import params_from_jax
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.elastic import gather, reshard
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = MeshRules(batch_axes=("data",), fsdp_axes=("data",))
    # what each scan is handed: (any DTensor argument, x's shape)
    calls = []
    for mod, name in ((ssm_scan, "selective_scan"), (ssm, "ssd_scan")):
        def recording(x, *a, _real=getattr(mod, name), _name=name, **kw):
            calls.append([_name, any(is_dtensor(t) for t in (x, *a)),
                          list(x.shape)])
            return _real(x, *a, **kw)
        setattr(mod, name, recording)

    res = {}
    for arch in archs:
        cfg = dataclasses.replace(configs.get(arch).reduced(),
                                  dtype="float32")
        model = get_model(cfg)
        params = params_from_jax(
            nest(dict(np.load(os.path.join(data_dir, f"{arch}.npz")))),
            cfg, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in np.load(
            os.path.join(data_dir, f"{arch}.batch.npz")).items()}
        ref = float(model.loss(params, batch))
        rows = {k: P("data", *[None] * (v.dim() - 1))
                for k, v in batch.items()}
        calls.clear()
        with use_mesh(mesh, rules):
            placed = reshard(params, model.param_pspecs(rules), mesh)
            loss = model.loss(placed, reshard(batch, rows, mesh))
            placements = str(loss.placements)
            _, grads = loss_and_grads(model, placed,
                                      reshard(batch, rows, mesh))
        scan_calls = list(calls)
        grads = gather(grads)
        if rank == 0:
            np.savez(os.path.join(data_dir, f"{arch}.port_grads.npz"),
                     **{k: v.numpy() for k, v in flat(grads).items()})

        def trainer():
            return Trainer(model, AdamWConfig(lr=1e-3), DataConfig(
                vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                seed=0, emit_frames=cfg.is_encoder_decoder,
                d_model=cfg.d_model), TrainerConfig(
                steps=2, log_every=100, async_checkpoint=False,
                device="cpu"))

        single = trainer().run()["losses"]
        with use_mesh(mesh, rules):
            on_mesh = trainer().run()["losses"]
        res[arch] = {"unsharded": ref, "sharded": float(loss.full_tensor()),
                     "placements": placements, "scan_calls": scan_calls,
                     "n_layers": cfg.n_layers,
                     "trainer": [single, on_mesh]}
    if rank == 0:
        with open(os.path.join(data_dir, "out.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[2]), sys.argv[1],
                           sys.argv[3].split(",")), nprocs=4)
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
    d = tmp_path_factory.mktemp("mesh_families")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d),
                           ",".join(ARCHS)], env=_env(), capture_output=True,
                          text=True, timeout=400, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")]
    jax_res = json.loads(line[-1][len("RESULT"):])
    script = d / "ranks.py"
    script.write_text(RANKS)
    proc = subprocess.run([sys.executable, str(script), str(d),
                           str(free_port()), ",".join(ARCHS)], env=_env(),
                          capture_output=True, text=True, timeout=400,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return d, jax_res, json.loads((d / "out.json").read_text())


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_match_jax(results, arch):
    """The port's unsharded and (2, 2)-sharded losses against JAX's; and
    JAX's own two, which agree to f32 rounding, so the bound holds both."""
    _, jax_res, res = results
    ours, theirs = res[arch], jax_res[arch]
    assert _rel(ours["unsharded"], theirs["unsharded"]) < 1e-5, (ours, theirs)
    assert _rel(ours["sharded"], theirs["sharded"]) < 1e-5, (ours, theirs)
    assert _rel(theirs["sharded"], theirs["unsharded"]) < 1e-5, theirs


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_is_a_replicated_dtensor(results, arch):
    assert results[2][arch]["placements"] == "(Replicate(), Replicate())"


@pytest.mark.parametrize("arch", ARCHS)
def test_every_grad_leaf_matches_jax_sharded(results, arch):
    d = results[0]
    want = dict(np.load(d / f"{arch}.grads.npz"))
    got = dict(np.load(d / f"{arch}.port_grads.npz"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        atol = ATOL * max(float(np.abs(w).max()), 1e-6)
        assert np.allclose(g, w, rtol=RTOL, atol=atol), (
            k, float(np.abs(g - w).max()), atol)
        # a gradient that reaches the leaf is not lost to the placement
        assert (np.abs(g).max() > 0) == (np.abs(w).max() > 0), k


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_scans_run_on_local_shards(results, arch):
    """Each layer's scan (the selective-scan wrapper, which takes the
    plain route on the CPU, or ``ssd_scan``) runs twice a layer under
    remat, in the loss's forward alone once, and always on local
    tensors: B / 2 rows and half the channels of a rank."""
    r = results[2][arch]
    calls = r["scan_calls"]
    L = r["n_layers"]
    assert len(calls) == L + 2 * L, calls      # the loss, then its grads
    assert not any(dt for _, dt, _ in calls), calls
    name = "selective_scan" if arch == "falcon-mamba-7b" else "ssd_scan"
    assert {c[0] for c in calls} == {name}
    d_in = 128                                  # reduced: d_model 64 x 2
    chans = d_in // 2 if name == "selective_scan" else d_in // 16 // 2
    assert all(shape[:3] == [2, 32, chans] for _, _, shape in calls), calls


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_on_the_mesh(results, arch):
    """Two ``Trainer`` steps on the (2, 2) mesh equal the single-process
    run's losses."""
    single, on_mesh = results[2][arch]["trainer"]
    assert len(single) == len(on_mesh) == 2
    for a, b in zip(single, on_mesh):
        assert np.isfinite(a) and _rel(b, a) < 1e-5, (single, on_mesh)
