"""Paged serving under a mix's load: the port's ``PagedEngine`` with the
traffic file's engine settings, its requests from
``loadgen.RequestStream``, sent by an open loop at a fixed rate
(``Load``).

Set-up makes the weights from the seed, serves two requests to the end
(``warm_up``: the prefill lane's (B, T) chunk and the decode loop), then
starts the load and runs ``warm_ticks`` ticks to bring it to its steady
state.  The
window opens after them and closes at the end of the first tick that ends
after ``--seconds``.  With ``--trace 1`` the window runs as it does
untraced, and then twice ``trace_ticks`` more ticks run under
``torch.profiler``, with ranges around the tick, the prefill lane and the
decode loop, and the paged attention calls' lengths recorded for their
kernels' rooflines.

Correct: after the window, a sample of the requests that the window
finished, drawn from the seed, the one with the most served tokens among
them, each served
the whole budget it asked for, with every served token within
``logit_gap`` of the reference's best logit at its position.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

import checks
import common
import loadgen
from reference import dense_lm
from work import attention as watt
from work import trace as wtrace

DONE = ("finished", "preempted_resumed")
FAILED = ("rejected", "cancelled", "deadline_exceeded")


class Load:
    """The requests a mix offers the engine, and what each saw; each
    tick's end is the time of the tokens it emitted and of the requests
    sent.  Requests fall due at a fixed ``rate`` a second, the first
    ``backlog`` of them at once; each is sent at the end of the tick in
    which it fell due and timed from when it was due."""

    def __init__(self, engine, stream: loadgen.RequestStream,
                 traffic: Dict):
        self.engine = engine
        self.stream = stream
        self.req: Dict[int, dict] = {}     # rid -> its record
        self.open: Dict[int, dict] = {}    # rids without a terminal status
        self.window = None                 # (t_open, t_close) once open
        self.ticks: List[dict] = []
        self.t0 = time.perf_counter()
        self.rate, self.backlog = traffic["rate"], traffic["backlog"]
        self.sent = 0
        self.arrive(self.t0)

    def due(self, j: int) -> float:
        return self.t0 + max(0, j + 1 - self.backlog) / self.rate

    def arrive(self, now: float) -> None:
        """Send every request due by ``now``."""
        while self.due(self.sent) <= now:
            self.send(self.due(self.sent))
            self.sent += 1

    def send(self, due: float) -> None:
        prompt, out = self.stream.next()
        rid = self.engine.submit(prompt.copy(), max_new_tokens=out)
        r = dict(rid=rid, prompt=prompt, budget=out, sent=due, first=None,
                 last=None, seen=0, gaps=[],
                 in_window=self.window is not None
                 and due >= self.window[0], failed=False)
        self.req[rid] = r
        self.open[rid] = r                 # a refused one is failed

    def tick(self) -> None:
        eng = self.engine
        if not eng.busy:
            # nothing to run until the next request falls due
            time.sleep(max(0.0, self.due(self.sent) - time.perf_counter()))
            self.arrive(time.perf_counter())
        eng.step()
        now = time.perf_counter()
        running = {s.rid: len(s.out) for s in eng.slots if s.active}
        done = 0
        for rid, r in list(self.open.items()):
            st = eng.status[rid].value
            if r["failed"] or st in FAILED:
                r["failed"] = True
                del self.open[rid]
                continue
            n = len(eng.results[rid]) if st in DONE else running.get(rid, 0)
            if n > r["seen"]:
                if r["first"] is None:
                    r["first"] = now
                else:
                    r["gaps"].append((now, now - r["last"]))
                r["last"], r["seen"] = now, n
            if st in DONE:
                r["done"] = now
                done += 1
                del self.open[rid]
        self.arrive(now)
        self.ticks.append(dict(end=now, active=len(running) + done,
                               queued=len(eng.queue)))


def _engine(model, params, cfg: Dict, traffic: Dict, seed: int):
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    scfg = ServeConfig(max_seq=cfg["max_position_embeddings"],
                       max_new_tokens=traffic["output"]["max"],
                       seed=common.sub_seed(seed, 4) % 2 ** 31,
                       **traffic["engine"])
    return PagedEngine(model, params, scfg)


def warm_up(engine, vocab: int, seed: int) -> None:
    """Serves two requests to the end before the load starts: two prefill
    chunks and two decode loops each, so that a process's first kernels
    load and the libraries pick their algorithms here, not while an open
    loop's clock runs and its backlog grows."""
    rng = np.random.default_rng(common.sub_seed(seed, 6))
    c = engine.cfg
    T, chunk = c.prefill_chunk_tokens or 2 * c.page_size, c.prefill_chunk
    for _ in range(2):
        engine.submit(rng.integers(0, vocab, T + 1, dtype=np.int32),
                      max_new_tokens=2 * chunk)
    engine.run()


def _recorders(rec: Dict):
    """Wrappers of the paged passes that keep, per call, the device's
    lengths and the active mask or grants (clones: no wait for the
    device)."""
    from repro_torch.models import transformer as T
    dec0, pre0 = T.lm_decode_paged, T.lm_prefill_paged

    def dec(params, cfg, tokens, cache, active, *a, **kw):
        rec["decode"].append((cache["length"].clone(), active.clone()))
        return dec0(params, cfg, tokens, cache, active, *a, **kw)

    def pre(params, cfg, tokens, cache, grants, *a, **kw):
        rec["prefill"].append((cache["length"].clone(), grants.clone()))
        return pre0(params, cfg, tokens, cache, grants, *a, **kw)
    return T, dec0, pre0, dec, pre


def _traced_span(loop: Load, ticks: int, device, arch):
    """``ticks`` ticks traced with the device's activity alone (the busy
    share), then ``ticks`` more under the full profiler with the ranges;
    the trace's summary with the needed work of the paged attention
    calls."""
    from torch.profiler import ProfilerActivity

    from repro_torch.models.model import Model
    from repro_torch.serve.engine import PagedEngine
    rec = {"decode": [], "prefill": []}
    T, dec0, pre0, dec, pre = _recorders(rec)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    marks = [(PagedEngine, "step", "tick"),
             (Model, "prefill_many_paged", "prefill lane"),
             (Model, "decode_many_paged", "decode loop")]
    quiet = wtrace.quiet_span(lambda: [loop.tick() for _ in range(ticks)],
                              device)
    T.lm_decode_paged, T.lm_prefill_paged = dec, pre
    try:
        with wtrace.marked(marks), wtrace.traced(device, acts) as t:
            for _ in range(ticks):
                loop.tick()
    finally:
        T.lm_decode_paged, T.lm_prefill_paged = dec0, pre0
    summary = wtrace.summarize(t[0], [m[2] for m in marks], t[1])
    if quiet:
        summary["busy_s"], summary["window_s"] = quiet
    H, KV = arch.n_heads, arch.n_kv_heads
    D, L = arch.head_dim, arch.n_layers
    page = loop.engine.cfg.page_size
    dec_work, pre_work, pre_tokens = [], [], 0
    for length, active in rec["decode"]:
        b, f = watt.paged_decode(length.cpu().numpy() + 1,
                                 active.cpu().numpy(), H, KV, D, page)
        dec_work.append((b * L, f * L))
    for length, grants in rec["prefill"]:
        g = grants.cpu().numpy()
        b, f = watt.paged_prefill(length.cpu().numpy(), g, H, KV, D, page)
        pre_work.append((b * L, f * L))
        pre_tokens += int(g.sum())
    summary.update(decode_steps=len(rec["decode"]), decode_work=dec_work,
                   prefill_tokens=pre_tokens, prefill_work=pre_work,
                   decode_kernel_s=wtrace.kernel_seconds(
                       summary, "paged_decode_kernel",
                       "decode_attention_combine"),
                   prefill_kernel_s=wtrace.kernel_seconds(
                       summary, "paged_prefill"))
    return summary


def sample(loop: Load, check: Dict, seed: int) -> List[dict]:
    """The requests whose output is compared, among those that the window
    finished: the one with the most served tokens, and others drawn from
    the seed, ``requests`` in all."""
    t_open, t_close = loop.window
    done = [r for r in loop.req.values()
            if t_open < r.get("done", 0) <= t_close]
    if not done:
        return []
    longest = max(done, key=lambda r: (r["seen"], -r["rid"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(common.sub_seed(seed, 5))
    k = min(len(rest), check["requests"] - 1)
    picked = [rest[i] for i in rng.choice(len(rest), k, replace=False)] \
        if k > 0 else []
    return [longest] + picked


def compare(weights, cfg: Dict, picked: List[dict], results: Dict,
            control: bool = False) -> float:
    """The widest logit gap over the picked requests' served tokens."""
    dense_lm.no_tf32()
    return max(dense_lm.served_gaps(weights, cfg, r["prompt"].tolist(),
                                    results[r["rid"]], control)
               for r in picked)


def run(ctx: Dict) -> Dict:
    from repro_torch.models.model import get_model
    cell, seed, device = ctx["cell"], ctx["seed"], ctx["device"]
    cfg, traffic = cell["config"], cell["traffic"]
    arch = common.arch_config(cfg, traffic.get("port"))
    model = get_model(arch)
    params = common.make_weights(model.schema(), seed, device,
                                 arch.param_dtype)
    engine = _engine(model, params, cfg, traffic, seed)
    warm_up(engine, cfg["vocab_size"], seed)
    loop = Load(engine, loadgen.RequestStream(traffic, cfg["vocab_size"],
                                              seed), traffic)
    grants: List[torch.Tensor] = []
    for _ in range(traffic["warm_ticks"]):
        loop.tick()
    common.sync(device)
    # the window
    from repro_torch.models.model import Model
    pre_many = Model.prefill_many_paged
    if ctx["trace"]:                       # prompt tokens of the window

        def counted(self, params, tokens, cache, gen, g, **kw):
            grants.append(g.clone())
            return pre_many(self, params, tokens, cache, gen, g, **kw)
        Model.prefill_many_paged = counted
    t_open = time.perf_counter()
    loop.window = (t_open, None)
    out0, app0 = engine.tokens_out, engine.tokens_appended
    host0, tick0 = len(engine.host_ms_trace), len(loop.ticks)
    try:
        while True:
            loop.tick()
            if loop.ticks[-1]["end"] - t_open >= ctx["seconds"]:
                break
    finally:
        Model.prefill_many_paged = pre_many
    t_close = loop.ticks[-1]["end"]
    loop.window = (t_open, t_close)
    span = t_close - t_open
    sent = [r for r in loop.req.values() if r["in_window"]]
    ttft = [((r["first"] if r["first"] is not None else t_close)
             - r["sent"]) * 1e3 for r in sent if not r["failed"]]
    itl = [g * 1e3 for r in loop.req.values() for t, g in r["gaps"]
           if t_open < t <= t_close]
    e2e = {"serve_out_tok_s": (engine.tokens_out - out0) / span,
           "ttft_p75_ms": common.quantile(ttft, 0.75) if ttft else None}
    record = {"cfg": cfg, "peaks": ctx["peaks"], "window_s": span,
              "tick_host_ms": engine.host_ms_trace[host0:],
              "occupancy": [t["active"] / engine.cfg.max_batch
                            for t in loop.ticks[tick0:]],
              "tokens_appended": engine.tokens_appended - app0,
              "prompt_tokens": (sum(int(g.sum()) for g in grants)
                                if ctx["trace"] else None),
              "ttft_ms": ttft, "itl_ms": itl}
    if ctx["trace"]:
        record["trace"] = _traced_span(loop, traffic["trace_ticks"], device,
                                       arch)
    device_line = common.device_info(device)
    # the check: the program's state freed first, the reference's weights
    # drawn again from the seed
    picked = sample(loop, traffic["check"], seed)
    results = dict(engine.results)
    short = [r["rid"] for r in picked
             if len(results[r["rid"]]) != r["budget"]]
    del engine, params, loop.engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    weights = common.make_weights(model.schema(), seed, device,
                                  arch.param_dtype)
    gap = compare(weights, cfg, picked, results) if picked else float("nan")
    ok, cks = checks.judge({"logit_gap": gap}, cell["limits"])
    cks["short_requests"] = {"value": float(len(short)), "limit": 0.0}
    cks["unsampled_requests"] = {
        "value": float(traffic["check"]["requests"] - len(picked)),
        "limit": 0.0}
    ok = ok and not short and len(picked) == traffic["check"]["requests"]
    return {"t_open": t_open, "correct": ok, "attempted": len(sent),
            "failed": sum(r["failed"] for r in sent), "e2e": e2e,
            "finished": sum(t_open < r.get("done", 0) <= t_close
                            for r in loop.req.values()),
            "ticks": loop.ticks[tick0:],
            "record": record, "checks": cks, "device": device_line,
            "sample": [(r["prompt"].tolist(), results[r["rid"]])
                       for r in picked]}
