"""A training job's steps: the port's ``make_train_step`` (loss, the
gradients through the flash kernel's forward with L, the plain flash
backward and the fused loss, gradient accumulation over microbatches,
AdamW) on batches from ``loadgen.token_batches``.

Set-up makes the weights from the seed, builds the one step object with
its optimizer state and drives it through the job's ``check_steps``
first steps, on the window's own call and feed; those steps warm every
shape, and their losses, step 1's gradients as the optimizer got them
(its first moment / (1 - b1)) and each leaf's change over them are what
the reference is held to.  The window takes the same object on and
keeps the card fed through a stall of the host: the step dispatched
waits only for the one ``ahead_steps`` before it (the job's data, some
4-8 s of steps).  Once ``--seconds`` have passed it dispatches nothing
more, waits for every step sent, and reads the clock after that wait:
all those steps over all that time.  With
``--trace 1`` two more steps run under ``torch.profiler``, the second with ranges
around the step, the flash backward, the fused loss and the optimizer,
and the flash kernel's calls recorded for its roofline.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from typing import Dict

import torch

import checks
import common
import loadgen
from reference import train as ref_train
from work import attention as watt
from work import trace as wtrace


def _norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float32))) * scale
            for k, v in ref_train.leaves(tree).items()}


def _changes(new, old) -> Dict[str, float]:
    a, b = ref_train.leaves(new), ref_train.leaves(old)
    return {k: float(torch.linalg.vector_norm(
        a[k].to(torch.float32) - b[k].to(torch.float32))) for k in a}


def build(ctx: Dict):
    """(arch, model, weights, optimizer, step, batches) of the cell."""
    from repro_torch.models.model import get_model
    from repro_torch.optim.adamw import AdamW, AdamWConfig
    from repro_torch.train.train_step import make_train_step
    cell, seed, device = ctx["cell"], ctx["seed"], ctx["device"]
    cfg, job = cell["config"], cell["traffic"]
    arch = common.arch_config(cfg, job.get("port"))
    model = get_model(arch)
    weights = common.make_weights(model.schema(), seed, device,
                                  arch.param_dtype)
    o = job["optimizer"]
    opt = AdamW(AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"],
                            eps=o["eps"], weight_decay=o["weight_decay"],
                            grad_clip_norm=o["clip"],
                            moment_dtype=o["moments"]))
    step = make_train_step(model, opt, microbatches=job["microbatches"])
    batches = loadgen.token_batches(job, cfg["vocab_size"], seed, device)
    return arch, model, weights, opt, step, batches


def first_steps(step, opt, weights, batches, n: int, b1: float):
    """Drives the step through its first ``n`` steps; returns (params,
    state, the program's readings).  Step 1's gradient as the optimizer
    got it, its first moment / (1 - b1), is kept on the host."""
    params, state = weights, opt.init(weights)
    losses, grad, g1 = [], None, None
    for t in range(n):
        params, state, metrics = step(params, state, next(batches))
        losses.append(float(metrics["loss"]))
        if t == 0:
            grad = _norms(state["m"], 1.0 / (1.0 - b1))
            g1 = {k: v.to(torch.float32).div(1.0 - b1).cpu()
                  for k, v in ref_train.leaves(state["m"]).items()}
    return params, state, {"losses": losses, "grad": grad, "g1": g1,
                           "change": _changes(params, weights)}


def _traced_step(step, params, state, batches, device):
    """One step traced with the device's activity alone (the busy
    share; its result is dropped: the step is functional), then one under
    the full profiler with the ranges; (params, state, summary with the
    flash forward calls' needed work)."""
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models import losses
    from repro_torch.optim import adamw
    marks = [(flash, "flash_bwd", "flash backward"),
             (losses._FusedXent, "forward", "fused loss"),
             (losses._FusedXent, "backward", "fused loss"),
             (adamw.AdamW, "update", "optimizer")]
    calls = []
    run0 = flash.run

    def run(q, k, v, causal, with_lse=False):
        calls.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                      k.shape[2], q.shape[3], bool(causal), bool(with_lse)))
        return run0(q, k, v, causal, with_lse)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    quiet = wtrace.quiet_span(
        lambda: step(params, state, next(batches)), device)
    batch = next(batches)
    flash.run = run
    try:
        with wtrace.marked(marks), wtrace.traced(device, acts) as t:
            with torch.profiler.record_function("step"):
                params, state, _ = step(params, state, batch)
    finally:
        flash.run = run0
    parts = ["step", "flash backward", "fused loss", "optimizer"]
    summary = wtrace.summarize(t[0], parts, t[1])
    if quiet:
        summary["busy_s"], summary["window_s"] = quiet
    summary["flash_work"] = [watt.flash(*c) for c in calls]
    summary["flash_kernel_s"] = wtrace.kernel_seconds(summary,
                                                      "flash_attention")
    summary["steps"] = 1
    return params, state, summary


def run(ctx: Dict) -> Dict:
    cell, seed, device = ctx["cell"], ctx["seed"], ctx["device"]
    cfg, job = cell["config"], cell["traffic"]
    cuda = torch.device(device).type == "cuda"
    arch, model, weights, opt, step, batches = build(ctx)
    params, state, prog = first_steps(step, opt, weights, batches,
                                      job["check_steps"],
                                      job["optimizer"]["b1"])
    del weights
    common.sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ahead, pending = job["ahead_steps"], deque()
    t_open = time.perf_counter()
    steps = 0
    while True:
        params, state, _ = step(params, state, next(batches))
        steps += 1
        if cuda:
            pending.append(torch.cuda.Event())
            pending[-1].record()
            while len(pending) >= ahead:
                pending.popleft().synchronize()
        if time.perf_counter() - t_open >= ctx["seconds"]:
            break
    common.sync(device)
    t_close = time.perf_counter()
    span = t_close - t_open
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    tokens = job["batch"] * job["seq_len"]
    e2e = {"train_tok_s": steps * tokens / span}
    record = {"cfg": cfg, "peaks": ctx["peaks"], "window_s": span,
              "steps": steps, "step_tokens": tokens,
              "window_peak_bytes": window_peak}
    if ctx["trace"]:
        params, state, record["trace"] = _traced_step(step, params, state,
                                                      batches, device)
    device_line = common.device_info(device)
    device_line["memory_peak_bytes"] = max(
        setup_peak, device_line["memory_peak_bytes"])
    # the check: the program's state freed, the reference given the same
    # weights and batches, drawn again from the seed
    del params, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference(ctx, model, arch)
    ok, cks = checks.judge(checks.train_checks(prog, ref), cell["limits"])
    return {"t_open": t_open, "correct": ok, "attempted": steps,
            "failed": 0, "e2e": e2e, "record": record, "checks": cks,
            "device": device_line, "prog": prog, "ref": ref}


def reference(ctx: Dict, model, arch, precision: str = "f32") -> Dict:
    """The reference's readings over the job's first steps, from the
    seed's weights and batches."""
    cell, seed, device = ctx["cell"], ctx["seed"], ctx["device"]
    cfg, job = cell["config"], cell["traffic"]
    weights = common.make_weights(model.schema(), seed, device,
                                  arch.param_dtype)
    feed = loadgen.token_batches(job, cfg["vocab_size"], seed, device)
    batches = [next(feed) for _ in range(job["check_steps"])]
    return ref_train.run(weights, cfg, job, batches, precision)
