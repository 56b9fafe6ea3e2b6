"""Training of the non-dense families in the port against the JAX
package's, on the CPU in f32 at ``.reduced()`` sizes, with the same
weights bridged by ``params_from_jax`` and the same numpy-seeded batches
(the pipeline's ``emit_frames`` / ``emit_embeddings`` set as the
launchers set them).

  * ``Model.loss`` and every gradient leaf for llama4-scout and grok-1
    (MoE: the router, the capacity-bounded expert blocks and
    ``router_aux_weight`` x the aux loss), qwen2-vl (M-RoPE over three
    distinct (3, B, S) position streams, embedding inputs that take no
    gradient), whisper-large-v3 (layernorm, the gelu MLP, sinusoidal
    positions, the encoder's gradient from every decoder layer),
    falcon-mamba-7b (Mamba1) and zamba2-7b (the hybrid: the shared
    block's leaves take a gradient from every application).
  * The remat variants ("none", "block", "full") bit-equal for each of
    them, and the recompute counts: under remat each SSM layer and each
    whisper encoder and decoder layer runs its forward once more, each
    hybrid group (its Mamba2 layers and its application of the shared
    block) once more, and the hybrid's tail layers do not.
  * ``ssd_scan``'s gradients with a ragged last chunk against the
    ``ssd_step`` loop's, and with dividing chunks against the JAX
    function's.
  * ``make_train_step`` for 3 steps at 2 microbatches against JAX's, for
    whisper, llama4-scout (the aux loss) and zamba2.
  * ``launch.train --local-smoke --device cpu`` for one arch of each
    family, and ``examples/train_100m_torch.py``'s cpu-smoke preset.

Tolerances, as ``test_torch_train.py`` holds the dense family: the loss
within rtol = atol = 1e-4, each gradient leaf within 1e-4 of its max abs
(two frameworks' f32 sums in another order); after whole train steps,
parameters and moments within 1e-4 of the max abs over all their leaves
(Adam turns the rounding of a gradient near eps into a visible fraction
of lr on a small leaf); the SSD scan's gradients within 1e-5 of each
input's max abs (a few chunks of f32 einsums, not a model's layers).
The remat
variants recompute the same operations on the same inputs, so they are
held to equality.
"""
import dataclasses
import io
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokenPipeline as JPipeline
from repro.models import get_model as jget_model
from repro.models import ssm as jssm
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tT
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.optim.adamw import AdamW, AdamWConfig, tree_leaves
from repro_torch.train.train_step import loss_and_grads, make_train_step

from test_torch_train import _close_leaves, _max_abs, _np
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama4-scout-17b-a16e", "grok-1-314b", "qwen2-vl-72b",
         "whisper-large-v3", "falcon-mamba-7b", "zamba2-7b"]


def _models(arch, seed=1, **kw):
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), dtype="float32",
                               **kw)
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), dtype="float32",
                               **kw)
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    return jm, jp, tget_model(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _mrope_streams(B, S):
    """Three distinct (3, B, S) int32 streams: text-like positions, then
    a 4-wide grid's rows and columns, offset per row."""
    t = np.arange(S, dtype=np.int32)
    pos = np.stack([t, t // 4, t % 4 + 2])
    return np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, B, S)) + np.arange(B)[None, :, None]
    ).astype(np.int32)


def _batch(cfg, B, S, step=0, seed=0):
    """The JAX pipeline's batch (frames for the encoder-decoder,
    embeddings for a stub-frontend arch, as the launchers ask), as numpy
    and as tensors; an M-RoPE arch gets distinct position streams."""
    b = JPipeline(JDataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=seed,
        emit_embeddings=not cfg.embed_inputs and not cfg.is_encoder_decoder,
        emit_frames=cfg.is_encoder_decoder,
        d_model=cfg.d_model)).batch_at(step)
    if cfg.mrope_sections:
        b["positions"] = _mrope_streams(B, S)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


# --- the loss and its gradients ------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def loss_case(request):
    """One arch's bridged weights, a batch (B 2, S 64), and JAX's loss
    and grads (one compile per arch, shared by the tests below)."""
    jm, jp, tm, tp = _models(request.param)
    jb, tb = _batch(jm.cfg, 2, 64, step=3)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in jb.items()})
    return tm, tp, tb, float(jl), jax.tree.map(np.asarray, jg)


def test_model_loss_and_every_grad_leaf_match_jax(loss_case):
    tm, tp, tb, jl, jg = loss_case
    loss, grads = loss_and_grads(tm, tp, tb)
    np.testing.assert_allclose(loss.item(), jl, **TOL)
    _close_leaves(_np(grads), jg)


def test_remat_variants_are_exactly_equal(loss_case):
    """remat "none", per block and "full": the same loss and the same
    gradients, bit for bit (``remat_group`` is the dense family's alone
    and changes nothing here)."""
    tm, tp, tb, _, _ = loss_case
    runs = []
    for remat, group in (("none", 1), ("block", 1), ("full", 1),
                         ("block", 2)):
        cfg = dataclasses.replace(tm.cfg, remat=remat, remat_group=group)
        runs.append(loss_and_grads(tget_model(cfg), tp, tb))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            assert torch.equal(a, b)


def test_the_embeddings_input_takes_no_gradient():
    """qwen2-vl's ``embeds`` come from a frontend that is not part of the
    model: the loss is differentiated in the parameters only, and the
    batch's tensor is left as it was."""
    tcfg = dataclasses.replace(tconfigs.get("qwen2-vl-72b").reduced(),
                               dtype="float32")
    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    _, tb = _batch(tcfg, 2, 16)
    loss, grads = loss_and_grads(tget_model(tcfg), params, tb)
    assert not tb["embeds"].requires_grad and tb["embeds"].grad is None
    assert torch.isfinite(loss)
    assert grads["blocks"]["attn"]["wq"].abs().max() > 0


# --- remat: what runs again ----------------------------------------------

def _count_calls(monkeypatch, names):
    counts = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(tT, name)

        def counting(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tT, name, counting)
    return counts


@pytest.mark.parametrize("arch,n_layers,names", [
    ("falcon-mamba-7b", 3, ("mamba_block_apply",)),
    ("whisper-large-v3", 3, ("attn_apply", "_cross_attend")),
    ("zamba2-7b", 13, ("mamba_block_apply", "shared_attn_block"))],
    ids=["ssm", "whisper", "hybrid"])
def test_remat_recomputes_each_checkpoint_once(arch, n_layers, names,
                                               monkeypatch):
    """Forward calls of one ``loss_and_grads`` with remat off, per block
    and "full".  falcon-mamba at 3 layers: 3, then 6.  whisper at 3
    encoder and 3 decoder layers: attention 6 and cross-attention 3, then
    12 and 6.  zamba2 at 13 layers (2 groups of 6 and a tail layer):
    Mamba2 blocks 13 and shared blocks 2, then 25 (the tail once) and 4.
    The values are equal in every case."""
    kw = dict(n_layers=n_layers)
    if arch == "whisper-large-v3":
        kw["encoder_layers"] = n_layers
    base = dataclasses.replace(tconfigs.get(arch).reduced(), dtype="float32",
                               **kw)
    params = init_params(base, torch.Generator().manual_seed(2), "cpu")
    _, tb = _batch(base, 2, 24)
    counts = _count_calls(monkeypatch, names)
    runs = {}
    for remat in ("none", "block", "full"):
        for n in names:
            counts[n] = 0
        cfg = dataclasses.replace(base, remat=remat)
        runs[remat] = (loss_and_grads(tget_model(cfg), params, tb),
                       dict(counts))
    L = n_layers
    if arch == "falcon-mamba-7b":
        once = {"mamba_block_apply": L}
        twice = {"mamba_block_apply": 2 * L}
    elif arch == "whisper-large-v3":
        once = {"attn_apply": 2 * L, "_cross_attend": L}
        twice = {"attn_apply": 4 * L, "_cross_attend": 2 * L}
    else:
        k = base.attn_every
        G = L // k
        once = {"mamba_block_apply": L, "shared_attn_block": G}
        twice = {"mamba_block_apply": L + G * k, "shared_attn_block": 2 * G}
        assert L - G * k == 1
    assert runs["none"][1] == once
    assert runs["block"][1] == twice and runs["full"][1] == twice
    (l0, g0), _ = runs["none"]
    for remat in ("block", "full"):
        (l1, g1), _ = runs[remat]
        assert torch.equal(l1, l0)
        for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
            assert torch.equal(a, b)


def test_serving_passes_do_not_checkpoint(monkeypatch):
    """A prefill, and a forward under ``torch.no_grad()``, run each layer
    once whatever ``cfg.remat`` says."""
    cfg = dataclasses.replace(tconfigs.get("zamba2-7b").reduced(),
                              dtype="float32", n_layers=7, remat="full")
    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    counts = _count_calls(monkeypatch, ("mamba_block_apply",))
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    tget_model(cfg).prefill(params, {"tokens": toks})
    with torch.no_grad():
        tget_model(cfg).loss(params, {"tokens": toks, "labels": toks})
    assert counts["mamba_block_apply"] == 2 * cfg.n_layers


# --- the SSD scan's gradients ---------------------------------------------

def _ssd_inputs(seed, B, S, H, hd, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, hd).astype(np.float32)
    dt = (np.log1p(np.exp(rng.randn(B, S, H))) * 0.5).astype(np.float32)
    A = -np.exp(rng.randn(H) * 0.5).astype(np.float32)
    Bc = rng.randn(B, S, N).astype(np.float32)
    Cc = rng.randn(B, S, N).astype(np.float32)
    wy = rng.randn(B, S, H, hd).astype(np.float32)
    wh = rng.randn(B, H, hd, N).astype(np.float32)
    return (x, dt, A, Bc, Cc), wy, wh


def _torch_grads(fn, ins, wy, wh):
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = fn(*ts)
    loss = (y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()
    return torch.autograd.grad(loss, ts)


def _step_loop(x, dt, A, Bc, Cc):
    B, S, H, hd = x.shape
    h = torch.zeros((B, H, hd, Bc.shape[-1]))
    ys = []
    for t in range(S):
        y, h = tssm.ssd_step(x[:, t], dt[:, t], A, Bc[:, t], Cc[:, t], h)
        ys.append(y)
    return torch.stack(ys, 1), h


def test_ragged_ssd_scan_grads_equal_the_step_loop():
    """S 40 in chunks of 16 (the last of 8): the gradients of a weighted
    sum of y and the final state, in every input, against the same
    through 40 ``ssd_step`` calls."""
    ins, wy, wh = _ssd_inputs(0, 2, 40, 3, 4, 8)
    got = _torch_grads(lambda *a: tssm.ssd_scan(*a, chunk=16), ins, wy, wh)
    want = _torch_grads(_step_loop, ins, wy, wh)
    _close_leaves(_np(dict(enumerate(got))), _np(dict(enumerate(want))),
                  rel=1e-5)


def test_ssd_scan_grads_match_jax():
    """S 48 in chunks of 16, which the JAX function takes: gradients
    against ``jax.grad`` of the same weighted sum."""
    ins, wy, wh = _ssd_inputs(1, 2, 48, 3, 4, 8)
    got = _torch_grads(lambda *a: tssm.ssd_scan(*a, chunk=16), ins, wy, wh)

    def jloss(*a):
        y, h = jssm.ssd_scan(*a, chunk=16)
        return (y * wy).sum() + (h * wh).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, ins))
    _close_leaves(_np(dict(enumerate(got))), _np(dict(enumerate(want))),
                  rel=1e-5)


# --- whole train steps ----------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama4-scout-17b-a16e",
                                  "zamba2-7b"])
def test_train_step_matches_jax(arch):
    """Three steps at B 4 in 2 microbatches, S 32, from the bridged
    weights: loss and grad_norm each step, then params and moments."""
    jm, jp, tm, tp = _models(arch)
    kw = dict(lr=1e-3, moment_dtype="float32")
    jstep = jax.jit(j_make_train_step(jm, JAdamW(JAdamWConfig(**kw)),
                                      microbatches=2))
    topt = AdamW(AdamWConfig(**kw))
    tstep = make_train_step(tm, topt, microbatches=2)
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


# --- the trainer's memory -------------------------------------------------

def test_trainer_frees_the_initial_state():
    """From the second step on, no tensor of the initial parameters or
    moments is alive: the step is functional, so a reference that
    ``Trainer.run`` kept would hold a second copy of the weights and
    moments for the whole run (15.4 GB at whisper-large-v3)."""
    import gc
    import weakref

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(tconfigs.get("whisper-large-v3").reduced(),
                              dtype="float32")
    tr = Trainer(tget_model(cfg), AdamWConfig(lr=1e-3),
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=2, emit_frames=True,
                            d_model=cfg.d_model),
                 TrainerConfig(steps=3, device="cpu", log_every=100))
    refs, alive, init, step = [], [], tr.init_state, tr.step_fn

    def init_state():
        state = init()
        refs.extend(weakref.ref(t) for t in tree_leaves(state))
        return state

    def counted(*args):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
        return step(*args)

    tr.init_state, tr.step_fn = init_state, counted
    out = tr.run()
    assert len(out["losses"]) == 3
    # step 0 takes the initial state; after it, nothing of it is left
    assert alive[0] == len(refs) and alive[1:] == [0, 0], alive


# --- the launcher and the example ------------------------------------------

@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "qwen2-vl-72b",
                                  "whisper-large-v3", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_launcher_trains_each_family_on_the_cpu(arch):
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = launch_train.main(["--arch", arch, "--local-smoke", "--device",
                                "cpu", "--steps", "2"])
    out = buf.getvalue()
    assert rc == 0, out
    assert f"{arch}-reduced S 64 batch 4" in out and "done: loss" in out
    first, last = out.split("done: loss ")[1].split(" -> ")
    assert np.isfinite(float(first)) and np.isfinite(float(last))


def test_train_100m_example_cpu_smoke(tmp_path, monkeypatch):
    """The port's twin of examples/train_100m.py: its cpu-smoke preset for
    3 steps on the CPU through the port's Trainer, whose own check (the
    last loss below the first) passes."""
    script = str(REPO / "examples" / "train_100m_torch.py")
    monkeypatch.setattr(sys, "argv", [
        script, "--preset", "cpu-smoke", "--steps", "3", "--device", "cpu",
        "--ckpt", str(tmp_path)])
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(script, run_name="__main__")
    out = buf.getvalue()
    assert "llama-6m: ~6.0M params on cpu" in out, out
    assert "over 3 steps" in out and "OK — loss improved" in out, out


def test_serve_demo_example_on_the_cpu(monkeypatch):
    """The port's twin of examples/serve_demo.py with --device cpu: the
    whole-batch engine at temperature 0.8 (4 requests of 12 tokens), the
    paged engine's joins, and prefix sharing with copy-on-write; the
    script imports nothing of the JAX package."""
    script = REPO / "examples" / "serve_demo_torch.py"
    src = script.read_text()
    assert not any(line.split()[1].split(".")[0] in ("repro", "jax")
                   for line in src.splitlines()
                   if line.startswith(("import ", "from "))), src
    monkeypatch.setattr(sys, "argv", [str(script), "--device", "cpu"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(str(script), run_name="__main__")
    out = buf.getvalue()
    assert out.count("-> [") == 4 and "48 tokens in" in out, out
    assert "paged: 8 requests / 8 joins on 4 slots, 64 tokens" in out, out
    shared = int(out.split("shared-prefix: 8 requests, ")[1].split()[0])
    cow = int(out.split("served by page reference, ")[1].split()[0])
    assert shared > 0 and cow > 0, out
