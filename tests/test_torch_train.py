"""The port's training path against the JAX package's, on the CPU in f32
at reduced sizes, with the same weights bridged by ``params_from_jax``
and the same numpy-seeded batches.

  * ``Model.loss`` and every gradient leaf (qwen2-0.5b and granite-8b
    ``.reduced()``), and the remat variants (off, per block, groups of
    2), which must be exactly equal to each other.
  * AdamW with f32, bf16 and int8 moments, the clip and the three
    schedules, step by step; ``grad_compress`` with int8 codes equal to
    JAX's.
  * ``make_train_step`` for 3 steps with 1 and 2 microbatches (loss,
    grad_norm, params, moments).
  * ``batch_at``, bit for bit; the checkpoint, trainer and straggler
    twins of the JAX package's tests; ``model_flops`` for every arch and
    shape; the launcher on the CPU.

Tolerances: a model's loss within rtol = atol = 1e-4 and each gradient
leaf within 1e-4 of its max abs, as the parity tests hold two
frameworks' f32 sums (tests/test_torch_dense_model.py); the optimizer's
elementwise f32 arithmetic within rtol 1e-5 (the JAX package's own
AdamW test), bf16 moments within one bf16 ulp of the stored value, int8
codes equal; after whole train steps, parameters and moments within 1e-4
of the max abs over all their leaves.  That last bound is global, not per
leaf: Adam's update g / (sqrt(v) + eps) turns the f32 rounding of a
gradient element near eps (1e-8; qwen2's k bias has such elements) into
an update that differs by a visible fraction of lr, on a leaf whose own
values are of the size of lr.
"""
import dataclasses
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokenPipeline as JPipeline
from repro.models import get_model as jget_model
from repro.optim import schedule as jsched
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.grad_compress import compress as j_compress
from repro.optim.grad_compress import ef_step as j_ef_step
from repro.train import checkpoint as jckpt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import params_from_jax
from repro_torch.optim import schedule as tsched
from repro_torch.optim.adamw import AdamW, AdamWConfig, tree_leaves, tree_map
from repro_torch.optim.grad_compress import compress, decompress, ef_step
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.straggler import StragglerConfig, StragglerMonitor
from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and on a machine
    whose test workers share the cores more threads only oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A nested dict of tensors (or JAX arrays) as numpy arrays in f32."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, np.float32)


def _close_leaves(got, want, rel=1e-4, path="", scale=None):
    """Every leaf within ``rel`` of its own max abs (``scale`` None; a
    floor of 1e-6), or of ``scale``."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_leaves(got[k], want[k], rel, f"{path}/{k}", scale)
        return
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape, path
    bound = rel * (scale if scale is not None
                   else max(float(np.abs(w).max()), 1e-6))
    err = float(np.abs(g - w).max())
    assert err <= bound, f"{path}: max abs err {err} > {bound}"


def _max_abs(tree) -> float:
    if isinstance(tree, dict):
        return max(_max_abs(v) for v in tree.values())
    return float(np.abs(np.asarray(tree, np.float32)).max())


def _models(arch, seed=1):
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), dtype="float32")
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    return jm, jp, tget_model(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _batch(cfg, B, S, step=0, seed=0):
    b = JPipeline(JDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                              global_batch=B, seed=seed)).batch_at(step)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


# --- the loss and its gradients ------------------------------------------

@pytest.fixture(scope="module", params=["qwen2-0.5b", "granite-8b"])
def loss_case(request):
    """One arch's bridged weights, a batch, and JAX's loss and grads (one
    compile per arch, shared by the tests below)."""
    jm, jp, tm, tp = _models(request.param)
    jb, tb = _batch(jm.cfg, 2, 64, step=3)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in jb.items()})
    return tm, tp, tb, float(jl), jax.tree.map(np.asarray, jg)


def test_model_loss_and_every_grad_leaf_match_jax(loss_case):
    """S = 64 over the reduced configs' 32-chunks: the chunked flash
    reference under its custom backward, the fused loss over one chunk
    of 64, and the tied (qwen2) or untied (granite) table."""
    tm, tp, tb, jl, jg = loss_case
    loss, grads = loss_and_grads(tm, tp, tb)
    np.testing.assert_allclose(loss.item(), jl, **TOL)
    _close_leaves(_np(grads), jg)


def test_remat_variants_are_exactly_equal(loss_case):
    """remat "none", per block, and groups of 2 layers: the same loss and
    the same gradients, bit for bit."""
    tm, tp, tb, _, _ = loss_case
    runs = []
    for remat, group in (("none", 1), ("block", 1), ("block", 2),
                         ("full", 1)):
        cfg = dataclasses.replace(tm.cfg, remat=remat, remat_group=group)
        runs.append(loss_and_grads(tget_model(cfg), tp, tb))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            assert torch.equal(a, b)


def test_remat_recomputes_each_layer_once(loss_case):
    """With remat per block the backward runs every layer's forward once
    more (the attention count doubles); groups of 2 recompute the same
    layers; without remat nothing is recomputed."""
    from repro_torch.models import transformer as tT
    tm, tp, tb, _, _ = loss_case
    counts = {}
    real = tT.attn_apply

    def counting(*a, **kw):
        counts["n"] += 1
        return real(*a, **kw)

    for remat, group in (("none", 1), ("block", 1), ("block", 2)):
        counts["n"] = 0
        cfg = dataclasses.replace(tm.cfg, remat=remat, remat_group=group)
        try:
            tT.attn_apply = counting
            loss_and_grads(tget_model(cfg), tp, tb)
        finally:
            tT.attn_apply = real
        L = cfg.n_layers
        assert counts["n"] == (L if remat == "none" else 2 * L)


# --- AdamW, schedules, compression ---------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 300), np.float32),
            "b": {"c": rng.standard_normal((7,), np.float32)}}


def _to_t(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_matches_jax_step_by_step(moments, clip):
    """Five steps from the same params and gradients (large enough that
    the clip acts), with a warmup schedule: params, moments (int8: codes
    equal, scales within f32 rounding) and metrics."""
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip_norm=clip, moment_dtype=moments)
    jopt = JAdamW(JAdamWConfig(lr=jsched.linear_warmup(1e-2, 3), **kw))
    topt = AdamW(AdamWConfig(lr=tsched.linear_warmup(1e-2, 3), **kw))
    p_np = _opt_tree(0)
    jp, tp = jax.tree.map(jnp.asarray, p_np), _to_t(p_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g_np = jax.tree.map(lambda x: x * 3.0, _opt_tree(step + 10))
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g_np), js, jp)
        tp, ts, tmet = topt.update(_to_t(g_np), ts, tp)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jm["grad_norm"]), **OPT)
        np.testing.assert_allclose(tmet["lr"].item(), float(jm["lr"]), **OPT)
        tree_map(lambda a, b: np.testing.assert_allclose(
            _np(a), _np(b), **OPT), tp, jp)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for name in ("m", "v"):
            if moments == "int8":                # {"q", "scale"} a leaf
                tree_map(lambda _, a, b: (
                    np.testing.assert_array_equal(a["q"].numpy(),
                                                  np.asarray(b["q"])),
                    np.testing.assert_allclose(a["scale"].numpy(),
                                               np.asarray(b["scale"]),
                                               **OPT)), tp, ts[name],
                    js[name])
            else:                # bf16: one ulp of the stored value
                assert tree_leaves(ts[name])[0].dtype == getattr(
                    torch, moments)
                tol = OPT if moments == "float32" else dict(rtol=2 ** -7)
                tree_map(lambda a, b: np.testing.assert_allclose(
                    _np(a), _np(b), **tol), ts[name], js[name])


def test_adamw_moment_dtypes_converge():
    """The JAX test's quadratic bowl: every moment precision reaches the
    optimum within its bound (f32 0.05, bf16 0.08, int8 0.3)."""
    for moments, tol in (("float32", 0.05), ("bfloat16", 0.08),
                         ("int8", 0.3)):
        opt = AdamW(AdamWConfig(lr=0.1, weight_decay=0.0,
                                grad_clip_norm=None, moment_dtype=moments))
        p = {"w": torch.linspace(-2, 2, 512)}
        state = opt.init(p)
        for _ in range(150):
            p, state, _ = opt.update({"w": 2.0 * p["w"]}, state, p)
        assert float(p["w"].abs().max()) < tol, moments


def test_adamw_grad_clip_metric():
    opt = AdamW(AdamWConfig(lr=1e-2, grad_clip_norm=1.0, weight_decay=0.0))
    p = {"w": torch.zeros(4)}
    _, _, metrics = opt.update({"w": torch.full((4,), 100.0)},
                               opt.init(p), p)
    assert metrics["grad_norm"].item() == pytest.approx(200.0)


def test_schedules_match_jax():
    cases = [(tsched.constant(3e-4), jsched.constant(3e-4)),
             (tsched.linear_warmup(1.0, 10), jsched.linear_warmup(1.0, 10)),
             (tsched.cosine_with_warmup(3e-4, 100, 8),
              jsched.cosine_with_warmup(3e-4, 100, 8)),
             (tsched.cosine_with_warmup(1.0, 10, 100, min_ratio=0.1),
              jsched.cosine_with_warmup(1.0, 10, 100, min_ratio=0.1))]
    for tf, jf in cases:
        for s in (0, 1, 5, 8, 10, 50, 100, 150):
            got = tf(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(),
                                       float(jf(jnp.asarray(s, jnp.int32))),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [1000, 256, 7])
def test_grad_compress_codes_match_jax(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    q, s = compress(torch.from_numpy(x))
    jq, js = j_compress(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    y = decompress(q, s, (n,))
    assert float((y - torch.from_numpy(x)).abs().max()) < \
        float(np.abs(x).max()) / 100


def test_error_feedback_matches_jax():
    """50 error-feedback steps in both packages: equal codes, residuals
    within f32 rounding, and the EF invariant of the JAX test."""
    rng = np.random.default_rng(1)
    res_t, res_j = torch.zeros(512), jnp.zeros((512,), jnp.float32)
    true, sent = np.zeros(512), np.zeros(512)
    for _ in range(50):
        g = (rng.standard_normal(512) * 0.1).astype(np.float32)
        q, s, res_t, deq = ef_step(torch.from_numpy(g), res_t)
        jq, _, res_j, _ = j_ef_step(jnp.asarray(g), res_j)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j),
                                   rtol=1e-5, atol=1e-7)
        true += g
        sent += deq.numpy()
    np.testing.assert_allclose(sent + res_t.numpy(), true, rtol=1e-4,
                               atol=1e-4)


# --- whole train steps ----------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(micro):
    """Three steps of qwen2-0.5b reduced (B 4, S 32) from the bridged
    weights: loss and grad_norm each step, then params and moments."""
    jm, jp, tm, tp = _models("qwen2-0.5b")
    kw = dict(lr=1e-3, moment_dtype="float32")
    jstep = jax.jit(j_make_train_step(jm, JAdamW(JAdamWConfig(**kw)),
                                      microbatches=micro))
    topt = AdamW(AdamWConfig(**kw))
    tstep = make_train_step(tm, topt, microbatches=micro)
    js, ts = JAdamW(JAdamWConfig(**kw)).init(jp), topt.init(tp)
    for step in range(3):
        jb, tb = _batch(jm.cfg, 4, 32, step=step)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in jb.items()})
        tp, ts, tmet = tstep(tp, ts, tb)
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   **TOL)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), **TOL)
    want = jax.tree.map(np.asarray, jp)
    _close_leaves(_np(tp), want, scale=_max_abs(want))
    for name in ("m", "v"):
        want = jax.tree.map(np.asarray, js[name])
        _close_leaves(_np(ts[name]), want, scale=_max_abs(want))


def test_train_step_leaves_its_arguments():
    """The step is functional: the caller's params and state are unchanged
    and need no gradient."""
    _, _, tm, tp = _models("qwen2-0.5b")
    opt = AdamW(AdamWConfig(lr=1e-3))
    state = opt.init(tp)
    before = [t.clone() for t in tree_leaves(tp)]
    _, tb = _batch(tm.cfg, 2, 32)
    new, _, _ = make_train_step(tm, opt, microbatches=2)(tp, state, tb)
    for a, b, c in zip(tree_leaves(tp), before, tree_leaves(new)):
        assert torch.equal(a, b) and not a.requires_grad
        assert not c.requires_grad
    assert int(state["step"]) == 0


# --- data, checkpoints, trainer, straggler --------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=16, global_batch=8),
    dict(vocab_size=151936, seq_len=64, global_batch=4, seed=7),
    dict(vocab_size=100, seq_len=8, global_batch=8, num_hosts=4,
         host_index=2),
    dict(vocab_size=50, seq_len=4, global_batch=2, emit_embeddings=True,
         d_model=6),
    dict(vocab_size=50, seq_len=4, global_batch=2, emit_frames=True,
         d_model=6)])
def test_batch_at_bit_for_bit(kw):
    t, j = SyntheticTokenPipeline(DataConfig(**kw)), \
        JPipeline(JDataConfig(**kw))
    for step in (0, 1, 42):
        a, b = t.batch_at(step), j.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_pipeline_reassign_and_prefetch():
    kw = dict(vocab_size=1000, seq_len=8, global_batch=8, num_hosts=4)
    slow = SyntheticTokenPipeline(DataConfig(host_index=2, **kw))
    spare = SyntheticTokenPipeline(DataConfig(host_index=3, **kw))
    spare.reassign(slow_host=2, spare_host=3)
    np.testing.assert_array_equal(spare.batch_at(10)["tokens"],
                                  slow.batch_at(10)["tokens"])
    p = SyntheticTokenPipeline(DataConfig(vocab_size=100, seq_len=4,
                                          global_batch=2))
    it = p.iterator(start_step=5)
    np.testing.assert_array_equal(next(it)["tokens"], p.batch_at(5)["tokens"])
    p.close()


def _state():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.linspace(-1, 1, 5).to(torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    """bf16 stored as its bits and restored bit-exact, with step and
    extra; the JAX package's restore reads the same directory."""
    state = _state()
    ckpt.save(str(tmp_path), 7, state, {"data_step": 7})
    step, got, extra = ckpt.restore(str(tmp_path), state)
    assert step == 7 and extra == {"data_step": 7}
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    like = jax.tree.map(lambda t: np.zeros(t.shape), {
        "a": state["a"].numpy(), "b": {"c": np.zeros(5), "d": np.zeros(())}})
    jstep, jgot, _ = jckpt.restore(str(tmp_path), like)
    assert jstep == 7
    np.testing.assert_array_equal(jgot["a"], state["a"].numpy())
    np.testing.assert_array_equal(np.asarray(jgot["b"]["c"], np.float32),
                                  state["b"]["c"].float().numpy())


def test_checkpoint_skips_partial(tmp_path):
    state = {"a": torch.ones(2, 2)}
    ckpt.save(str(tmp_path), 5, state)
    ckpt.save(str(tmp_path), 9, state)
    os.remove(os.path.join(str(tmp_path), "step_000000009", "COMMIT"))
    assert ckpt.restore(str(tmp_path), state)[0] == 5
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(2, 2)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"a": torch.ones(3, 3)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"a": torch.ones(2, 2),
                                     "b": torch.ones(1)})


def test_async_checkpointer_snapshots_at_save(tmp_path):
    c = ckpt.AsyncCheckpointer()
    state = {"a": torch.ones(64, 64)}
    c.save(str(tmp_path), 3, state)
    state["a"].add_(1.0)                  # after save: not in the file
    c.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert torch.equal(ckpt.restore(str(tmp_path), state)[1]["a"],
                       torch.ones(64, 64))


def _trainer(steps, ckpt_dir=None, lr=1e-3, seed=7, **kw):
    cfg = tconfigs.get("qwen2-0.5b").reduced()
    return Trainer(tget_model(cfg), AdamWConfig(lr=lr),
                   DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=4),
                   TrainerConfig(steps=steps, checkpoint_every=3,
                                 checkpoint_dir=ckpt_dir, log_every=1000,
                                 seed=seed, device="cpu", **kw))


def test_trainer_restart_resumes(tmp_path):
    """6 steps with a synchronous checkpoint every 3, a restart to 9, and 9
    straight steps: the resumed steps equal the straight run's (on the
    CPU exactly; the JAX test allows 2e-3)."""
    d = str(tmp_path)
    _trainer(6, d, async_checkpoint=False).run()
    out2 = _trainer(9, d, async_checkpoint=False).run()
    assert len(out2["losses"]) == 3
    out3 = _trainer(9).run()
    np.testing.assert_array_equal(out2["losses"], out3["losses"][6:])


def test_trainer_async_checkpoints_and_history(tmp_path):
    tr = _trainer(4, str(tmp_path), microbatches=2)
    out = tr.run()
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert [h["step"] for h in tr.history] == [0, 1, 2, 3]
    assert all(np.isfinite([h["loss"], h["grad_norm"], h["time_s"]]).all()
               for h in tr.history)
    assert out["losses"] == [h["loss"] for h in tr.history]


def test_trainer_loss_decreases():
    out = _trainer(25, lr=3e-3, seed=0).run()
    assert out["last_loss"] < out["first_loss"]


def test_straggler_flagging():
    mon = StragglerMonitor(4, StragglerConfig(alpha=1.0, threshold=1.5,
                                              patience=2))
    base = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}
    assert mon.update(base) == []
    slow = {**base, 2: 5.0}
    assert mon.update(slow) == []
    assert mon.update(slow) == [2]
    mon.reset(2)
    assert mon.update(base) == []


# --- bookkeeping and the launcher ------------------------------------------

def test_model_flops_match_jax():
    for name in jconfigs.registry():
        for shape in jconfigs.SHAPES:
            assert tget_model(tconfigs.get(name)).model_flops(
                tconfigs.SHAPES[shape]) == jget_model(
                jconfigs.get(name)).model_flops(jconfigs.SHAPES[shape])
    assert tconfigs.SHAPES == {k: tconfigs.ShapeConfig(**dataclasses.asdict(v))
                               for k, v in jconfigs.SHAPES.items()}


def test_launcher_local_smoke_cpu(tmp_path):
    from repro_torch.launch import train as launch
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = launch.main(["--local-smoke", "--device", "cpu", "--steps", "2",
                          "--ckpt", str(tmp_path)])
    assert rc == 0
    lines = buf.getvalue().splitlines()
    done = [x for x in lines if x.startswith("[launch.train] done: loss ")]
    assert len(done) == 1
    first, last = (float(x) for x in done[0].split("loss ")[1].split(" -> "))
    assert np.isfinite([first, last]).all()
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu", "--coordinator", "localhost:1"])
