"""The vocabulary on the model axis: the port's embedding gather, fused
loss and logits split the (V, d) tables over "model" as the JAX package
does, on four gloo ranks of the CPU held against the JAX package on the
same meshes.

One module fixture runs the JAX side in a subprocess with four host
devices (``XLA_FLAGS`` set there only): reduced qwen2-0.5b (tied
table) and granite-8b (untied) at f32 from ``jax.random.key(0)``, and
two variants of reduced qwen2-0.5b with 6 query heads of 16 (2 and 3 kv
heads), saved for the bridge; a B 4, S 32 batch from ``RandomState(0)``;
for each (mesh, arch) the loss and every gradient leaf of
``jax.value_and_grad(model.loss)`` on that mesh under the train rules
``MeshRules(batch_axes=("data",), fsdp_axes=("data",))``.  The meshes:
(1, 2) ("data", "model") (on the port the inner dims of a (2, 1, 2)
mesh whose leading "rep" axis no rule names, so all four ranks take
part), (2, 2), and for the 6-head variants (1, 4), where the model axis
does not divide the heads and both packages split them in two groups of
three (``models.attention.head_groups``).  Then four ranks (one intra-op
thread each, a free local port) bridge the same weights, ``reshard``
them and report at once:

  * the sharded ``Model.loss`` against JAX's sharded loss and the
    port's unsharded loss, rtol 1e-5;
  * the embedding and unembedding gradients (``full_tensor()``) against
    JAX's sharded ones, rtol 1e-5 with an atol of 1e-5 x the leaf's max
    abs; every other leaf at the bound ``test_torch_mesh_families.py``
    holds (rtol 1e-4, atol 1e-4 x max abs);
  * each table's gradient ``Shard(0)`` over "model" as it leaves the
    step, and the fused loss's backward building a rank-local dE of
    (V / m, d) rows;
  * ``_logits_exact`` on the mesh: logits split over the vocabulary
    (``Shard(2)`` on "model"), within 1e-6 of the unsharded ones, and
    greedy tokens equal to the unsharded tokens; the embedding gather
    equal to the unsharded one bit for bit;
  * for the 6-head variants, every local attention call on 3 heads.
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
# (mesh, arch): the 6-head variants only on the (1, 4) mesh
CELLS = [("1x2", "qwen2-0.5b"), ("1x2", "granite-8b"),
         ("2x2", "qwen2-0.5b"), ("2x2", "granite-8b"),
         ("1x4", "qwen2-h6kv2"), ("1x4", "qwen2-h6kv3")]
IDS = [f"{m}-{a}" for m, a in CELLS]
TABLE_RTOL = 1e-5            # the tables' gradients: rtol, atol x max abs
RTOL, ATOL = 1e-4, 1e-4      # every other leaf (test_torch_mesh_families)

CONFIGS = r"""
import dataclasses


def config(get, arch):
    '''Reduced f32 config of a test arch (``get``: either package's
    ``configs.get``).'''
    if arch.startswith("qwen2-h6"):
        base = get("qwen2-0.5b").reduced()
        return dataclasses.replace(base, dtype="float32", n_heads=6,
                                   n_kv_heads=int(arch[-1]), d_head=16)
    return dataclasses.replace(get(arch).reduced(), dtype="float32")
"""

JAX_SIDE = CONFIGS + r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get
from repro.dist.sharding import MeshRules, use_mesh
from repro.models import get_model
from repro.train.elastic import reshard

out_dir, cells = sys.argv[1], json.loads(sys.argv[2])
rules = MeshRules(batch_axes=("data",), fsdp_axes=("data",))


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


rng = np.random.RandomState(0)
batch = {"tokens": rng.randint(0, 256, (4, 32)).astype(np.int32),
         "labels": rng.randint(0, 256, (4, 32)).astype(np.int32)}
np.savez(os.path.join(out_dir, "batch.npz"), **batch)
jb = {k: jnp.asarray(v) for k, v in batch.items()}
res = {}
for arch in sorted({a for _, a in cells}):
    model = get_model(config(get, arch))
    params = model.init(jax.random.key(0))
    np.savez(os.path.join(out_dir, f"{arch}.npz"), **flat(params))
for mesh_name, arch in cells:
    model = get_model(config(get, arch))
    params = model.init(jax.random.key(0))
    mesh = mesh_of(tuple(int(d) for d in mesh_name.split("x")))
    with use_mesh(mesh, rules):
        p_sh = reshard(params, model.param_pspecs(rules), mesh)
        b_sh = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))), jb)
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(p_sh, b_sh)
    np.savez(os.path.join(out_dir, f"{mesh_name}-{arch}.grads.npz"),
             **flat(grads))
    res[f"{mesh_name}-{arch}"] = float(loss)
print("RESULT" + json.dumps(res))
"""

RANKS = CONFIGS + r"""
import json, os, sys
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


def worker(rank, port, data_dir, cells):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.dist.sharding import (
        MeshRules, P, is_dtensor, place, use_mesh)
    from repro_torch.models import attention as A, losses, layers
    from repro_torch.models import transformer as T
    from repro_torch.models.model import get_model, sample_token
    from repro_torch.models.params import params_from_jax
    from repro_torch.train.elastic import gather, reshard
    from repro_torch.train.train_step import loss_and_grads

    meshes = {
        "1x2": init_device_mesh("cpu", (2, 1, 2),
                                mesh_dim_names=("rep", "data", "model")),
        "2x2": init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model")),
        "1x4": init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))}
    rules = MeshRules(batch_axes=("data",), fsdp_axes=("data",))
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(data_dir, "batch.npz")).items()}
    rows = {k: P("data", None) for k in batch}

    # the fused loss's local dE, and the heads of each local attention
    d_e, heads = [], []
    backward = losses._FusedXent.backward

    def recording_backward(ctx, g):
        out = backward(ctx, g)
        d_e.append(list(out[1].shape))
        return out
    losses._FusedXent.backward = staticmethod(recording_backward)
    attend = A.attention

    def recording_attention(q, *a, **k):
        if not is_dtensor(q):
            heads.append(q.shape[2])
        return attend(q, *a, **k)
    A.attention = recording_attention

    res = {}
    for mesh_name, arch in cells:
        mesh = meshes[mesh_name]
        model_dim = list(mesh.mesh_dim_names).index("model")
        cfg = config(configs.get, arch)
        model = get_model(cfg)
        params = params_from_jax(
            nest(dict(np.load(os.path.join(data_dir, f"{arch}.npz")))),
            cfg, device="cpu")
        ref = float(model.loss(params, batch))
        tables = ["embed"] + ([] if cfg.tie_embeddings else ["unembed"])
        h = torch.from_numpy(np.random.RandomState(1).randn(
            4, 1, cfg.d_model).astype(np.float32))
        logits_ref = T._logits_exact(params, cfg, h)
        emb_ref = layers.embed(batch["tokens"], params["embed"])
        d_e.clear()
        heads.clear()
        with use_mesh(mesh, rules):
            placed = reshard(params, model.param_pspecs(rules), mesh)
            b_pl = reshard(batch, rows, mesh)
            loss = model.loss(placed, b_pl)
            _, grads = loss_and_grads(model, placed, b_pl)
            grad_pl = {t: str(grads[t].placements[model_dim])
                       for t in tables}
            logits = T._logits_exact(placed, cfg,
                                     place(h, "batch", None, None))
            logits_pl = str(logits.placements[model_dim])
            tokens = sample_token(logits[:, 0], None, 0.0)
            emb = layers.embed(b_pl["tokens"], placed["embed"])
        grads = gather(grads)
        if rank == 0:
            np.savez(os.path.join(data_dir,
                                  f"{mesh_name}-{arch}.port_grads.npz"),
                     **{k: v.numpy() for k, v in flat(grads).items()})
        res[f"{mesh_name}-{arch}"] = {
            "unsharded": ref, "sharded": float(loss.full_tensor()),
            "grad_placements": grad_pl, "dE_shapes": list(d_e),
            "V": cfg.vocab_size, "d": cfg.d_model,
            "model": mesh.size(model_dim),
            "logits_placement": logits_pl,
            "logits_err": float((logits.full_tensor() - logits_ref)
                                .abs().max()),
            "tokens": (tokens.full_tensor() if is_dtensor(tokens)
                       else tokens).tolist(),
            "tokens_ref": sample_token(logits_ref[:, 0], None, 0.0).tolist(),
            "embed_equal": bool(torch.equal(emb.full_tensor(), emb_ref)),
            "heads": list(heads)}
    if rank == 0:
        with open(os.path.join(data_dir, "out.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[2]), sys.argv[1],
                           json.loads(sys.argv[3])), nprocs=4)
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
    d = tmp_path_factory.mktemp("vocab_parallel")
    cells = json.dumps(CELLS)
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d), cells],
                          env=_env(), capture_output=True, text=True,
                          timeout=400, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")]
    jax_res = json.loads(line[-1][len("RESULT"):])
    script = d / "ranks.py"
    script.write_text(RANKS)
    proc = subprocess.run([sys.executable, str(script), str(d),
                           str(free_port()), cells], env=_env(),
                          capture_output=True, text=True, timeout=400,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return d, jax_res, json.loads((d / "out.json").read_text())


def _rel(a, b):
    return abs(a - b) / abs(b)


def _grads(results, cell):
    d = results[0]
    return (dict(np.load(d / f"{cell}.port_grads.npz")),
            dict(np.load(d / f"{cell}.grads.npz")))


@pytest.mark.parametrize("cell", IDS)
def test_sharded_loss_matches_jax(results, cell):
    _, jax_res, res = results
    r = res[cell]
    assert _rel(r["sharded"], jax_res[cell]) < 1e-5, (r, jax_res[cell])
    assert _rel(r["sharded"], r["unsharded"]) < 1e-5, r


@pytest.mark.parametrize("cell", IDS)
def test_table_grads_match_jax(results, cell):
    got, want = _grads(results, cell)
    tables = [k for k in ("embed", "unembed") if k in want]
    assert tables == (["embed"] if "qwen2" in cell else
                      ["embed", "unembed"])
    for k in tables:
        w, g = want[k], got[k]
        assert g.shape == w.shape, k
        atol = TABLE_RTOL * float(np.abs(w).max())
        assert np.allclose(g, w, rtol=TABLE_RTOL, atol=atol), (
            k, float(np.abs(g - w).max()), atol)


@pytest.mark.parametrize("cell", IDS)
def test_every_other_grad_leaf_matches_jax(results, cell):
    got, want = _grads(results, cell)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        atol = ATOL * max(float(np.abs(w).max()), 1e-6)
        assert np.allclose(g, w, rtol=RTOL, atol=atol), (
            k, float(np.abs(g - w).max()), atol)
        assert (np.abs(g).max() > 0) == (np.abs(w).max() > 0), k


@pytest.mark.parametrize("cell", IDS)
def test_table_grads_stay_split_over_the_model_axis(results, cell):
    r = results[2][cell]
    assert set(r["grad_placements"].values()) == {"S(0)"}, r


@pytest.mark.parametrize("cell", IDS)
def test_rank_local_dE_is_its_rows_of_the_vocabulary(results, cell):
    """One backward of the fused loss per gradient pass (``loss_and_grads``
    runs one), building dE of V / m rows by the whole d: the fsdp split
    is gathered inside the island and the vocabulary is not."""
    r = results[2][cell]
    assert r["dE_shapes"] == [[r["V"] // r["model"], r["d"]]], r


@pytest.mark.parametrize("cell", IDS)
def test_sharded_logits_and_greedy_tokens(results, cell):
    r = results[2][cell]
    assert r["logits_placement"] == "S(2)", r
    assert r["logits_err"] < 1e-6, r
    assert r["tokens"] == r["tokens_ref"], r


@pytest.mark.parametrize("cell", IDS)
def test_embedding_gather_is_exact(results, cell):
    assert results[2][cell]["embed_equal"]


@pytest.mark.parametrize("cell", IDS[-2:])
def test_head_groups_split_the_attention(results, cell):
    """6 heads over a model axis of 4: GSPMD's split, f = gcd(6, 4) = 2
    groups of 3 heads, each replicated on 2 ranks; every local attention
    call (2 layers, and each layer's remat recompute under the gradient
    pass) attends 3 heads."""
    heads = results[2][cell]["heads"]
    assert heads and set(heads) == {3}, heads
