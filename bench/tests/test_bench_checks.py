"""The comparison that decides ``correct``, on the CPU at a tiny size: the
plain reference against the port, the control (the reference in fp8 in
the program's place) failing it, and a run whose timed path is broken
underneath coming out not correct, once for each fault a cell can have.
At the cells' own size these readings are taken on the chip by
``bench/calibrate.py`` (PERF.md)."""
from __future__ import annotations

import json

import pytest
import torch

import bench_tiny as tiny

tiny.paths()
import checks  # noqa: E402
import common  # noqa: E402
from reference import dense_lm  # noqa: E402
from reference import train as ref_train  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


def _model(cfg):
    from repro_torch.models.model import get_model
    arch = common.arch_config(cfg)
    return arch, get_model(arch)


def test_reference_logits_match_the_port(root):
    cfg = json.loads((root / "bench/configs/granite-tiny.json").read_text())
    arch, model = _model(cfg)
    w = common.make_weights(model.schema(), 3, "cpu", arch.param_dtype)
    toks = torch.randint(0, cfg["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(0))
    from repro_torch.models import transformer as T
    pos = torch.arange(40)[None]
    got, _, _ = T.lm_forward(w, arch, toks, pos, mode="train", plain=True)
    want = dense_lm.logits_at(w, cfg, toks[0], range(40))
    assert torch.allclose(got[0].float(), want, rtol=1e-4, atol=1e-4)


def test_reference_loss_and_grads_match_the_port(root):
    cfg = json.loads((root / "bench/configs/qwen2-tiny.json").read_text())
    arch, model = _model(cfg)
    w = common.make_weights(model.schema(), 4, "cpu", arch.param_dtype)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 256, (2, 33), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    from repro_torch.train.train_step import loss_and_grads
    loss, grads = loss_and_grads(model, w, batch)
    p = {k: v.clone().requires_grad_(True)
         for k, v in ref_train.leaves(w).items()}
    tree = ref_train._rebuild(w, p)
    ref = sum(dense_lm.row_loss_sum(tree, cfg, toks[r, :-1], toks[r, 1:])
              for r in range(2)) / batch["labels"].numel()
    ref.backward()
    assert abs(float(loss) - float(ref.detach())) < 1e-5
    for k, g in ref_train.leaves(grads).items():
        want = p[k].grad if p[k].grad is not None else torch.zeros_like(g)
        assert torch.allclose(g, want, rtol=1e-4,
                              atol=1e-4 * float(want.abs().max() + 1e-12)), k


def test_serve_control_fails_the_check(root):
    """Requests served to the end by the port's engine read under the tiny
    limit; the fp8 control, on the same prompts and tokens, reads at
    least three times as much, and above the limit."""
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    cfg = json.loads((root / "bench/configs/granite-tiny.json").read_text())
    arch, model = _model(cfg)
    w = common.make_weights(model.schema(), 5, "cpu", arch.param_dtype)
    eng = PagedEngine(model, w, ServeConfig(max_batch=4, max_seq=128,
                                            max_new_tokens=24))
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (30, 17, 41, 9)]
    rids = [eng.submit(torch.tensor(p).numpy()) for p in prompts]
    out = eng.run()
    lower = max(dense_lm.served_gaps(w, cfg, p, out[r])
                for p, r in zip(prompts, rids))
    upper = max(dense_lm.served_gaps(w, cfg, p, out[r], control=True)
                for p, r in zip(prompts, rids))
    assert lower <= tiny.LIMITS[tiny.CHAT]["logit_gap"] < upper
    assert upper >= 3 * lower


def test_train_control_fails_the_check(root):
    d = tiny.driver("train")
    ctx = tiny.ctx(root, tiny.TRAIN, seed=23)
    out = d.run(ctx)
    assert out["correct"]
    arch, model = _model(ctx["cell"]["config"])
    ctrl = d.reference(ctx, model, arch, "fp8")
    ok, _ = checks.judge(checks.train_checks(ctrl, out["ref"]),
                         tiny.LIMITS[tiny.TRAIN])
    assert not ok


def _token_altered(monkeypatch):
    from repro_torch.models import model as M
    orig = M.sample_token

    def altered(logits, gen, temperature):
        return (orig(logits, gen, temperature) + 1) % logits.shape[-1]
    monkeypatch.setattr(M, "sample_token", altered)


def _state_unchanged_serve(monkeypatch):
    """The decode and prefill passes never write their K/V rows."""
    from repro_torch.models import transformer as T
    monkeypatch.setattr(T, "_write_rows", lambda *a, **k: None)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged_serve])
def test_broken_serving_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    out = tiny.driver("serve").run(tiny.ctx(root, tiny.CHAT, seed=31))
    assert out["correct"] is False


def _state_unchanged_train(step):
    def broken(params, state, batch):
        _, _, metrics = step(params, state, batch)
        return params, state, metrics
    return broken


def _half_batch(step):
    def broken(params, state, batch):
        n = batch["tokens"].shape[0] // 2
        return step(params, state, {k: v[:n] for k, v in batch.items()})
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged_train, _half_batch])
def test_broken_training_step_is_not_correct(root, monkeypatch, fault):
    from repro_torch.train import train_step
    make = train_step.make_train_step
    monkeypatch.setattr(train_step, "make_train_step",
                        lambda *a, **k: fault(make(*a, **k)))
    out = tiny.driver("train").run(tiny.ctx(root, tiny.TRAIN, seed=32))
    assert out["correct"] is False


@pytest.mark.card
def test_a_cell_on_the_card():
    """The training cell's command on the card with a short window (its
    check follows the steps before the window, so a short window still
    compares all it compares); run there by ``python3 -m pytest
    bench/tests -m card``."""
    import subprocess
    import sys
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "qwen2-0.5b.train-4k", "--seed", "5", "--seconds",
                        "5", "--trace", "0"], cwd=tiny.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
