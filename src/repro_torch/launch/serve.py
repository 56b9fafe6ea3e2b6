"""Serving launcher of the port: the paged continuous-batching engine, or
whole-batch lockstep generation, on one card.

    python -m repro_torch.launch.serve                    # granite-8b, cuda
    python -m repro_torch.launch.serve --whole-batch      # ServingEngine
    python -m repro_torch.launch.serve --whole-batch --legacy-loop
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --whole-batch
    python -m repro_torch.launch.serve --arch zamba2-7b --whole-batch
    python -m repro_torch.launch.serve --arch qwen2-vl-72b --local-smoke \
        --device cpu                         # text prompts, paged only
    python -m repro_torch.launch.serve --local-smoke --device cpu
    python -m repro_torch.launch.serve --local-smoke --device cpu \
        --no-prefix-sharing
    python -m repro_torch.launch.serve --local-smoke --device cpu \
        --kv-dtype int8 --max-queue 4 --deadline-ticks 40
    python -m repro_torch.launch.serve --local-smoke --device cpu \
        --no-prefill-lane
    python -m repro_torch.launch.serve --local-smoke --device cpu \
        --spec-k 3 --draft-arch qwen2-0.5b
    python -m repro_torch.launch.serve --local-smoke --device cpu \
        --snapshot-every 4 --snapshot-dir snaps
    python -m repro_torch.launch.serve --local-smoke --device cpu \
        --restore-from snaps/snap-00000008.bin

Weights are random, drawn from a seeded ``torch.Generator`` on the device
(nothing is downloaded).  The demo workloads are the JAX launcher's: for
the paged engine, twice ``--batch`` requests of a shared system prompt
plus a short random tail, with staggered output budgets; for
``--whole-batch``, ``--batch`` random prompts of 4-15 tokens.  The SSM
arch (falcon-mamba-7b) and the hybrid (zamba2-7b) are served whole-batch
only: the paged engine refuses them, as the JAX package's does.
qwen2-vl's demo prompts are text tokens, served paged only: the
whole-batch engine prefills token prompts, and the model's prefill reads
a frontend's embeddings.  Whisper
is refused: the paged engine refuses encoder-decoder archs, as the JAX
package's does, and its prefill reads a frontend's frames (it runs at
the Model level, ``Model.prefill`` with frames and tokens).  Prefix
sharing and cross-lifetime retention are on by default, as in the JAX launcher, which reports the
same sharing and retention lines; so are preempt-and-recompute and the
overload flags (``--no-preempt``, ``--preempt-policy``, ``--max-queue``,
``--deadline-ticks``, ``--wedge-ticks``) and ``--kv-dtype int8``.  The
overload line gives the preemptions, the recomputed tokens and the
requests' terminal statuses; the host line the median and p90 of the
engine's per-tick host time.  ``--no-prefill-lane`` feeds prompts through
the decode loop as forced tokens (prefill-by-decode); ``--spec-k`` with
``--draft-arch`` serves speculatively (greedy only), the draft's weights
drawn from seed 1, and prints the accept rate and the draft and verify
calls.  ``--snapshot-every`` with ``--snapshot-dir`` writes the engine's
whole state every n ticks (``serve/snapshot.py``); ``--restore-from``
restores one into the engine built from the flags, after checking the
snapshot's fingerprint against them before the weights and the engine
are built, and serves its in-flight work instead of the demo workload.
The pool line gives the bytes of a page and of the pools.
"""
import argparse
import sys
import time

import numpy as np


class SpecCapacityError(ValueError):
    """``--spec-k`` asks the draft pool for more rows than its block
    tables hold: the draft cache must fit a request's whole span plus k
    proposals in flight (the JAX launcher's startup check)."""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--local-smoke", action="store_true",
                    help="reduced config (same family, tiny dims)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--whole-batch", action="store_true",
                    help="lockstep whole-batch generation (ServingEngine) "
                         "instead of the paged continuous-batching engine")
    ap.add_argument("--legacy-loop", action="store_true",
                    help="with --whole-batch: per-token host loop instead "
                         "of the fused decode_many")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable prompt-prefix page sharing on admission "
                         "(implies no cross-lifetime retention)")
    ap.add_argument("--no-retain-prefixes", action="store_true",
                    help="disable cross-lifetime prefix retention: a "
                         "finished request's page-aligned prefix pages "
                         "return to the free list at once instead of "
                         "staying adoptable by digest")
    ap.add_argument("--retain-policy", default="lru",
                    choices=("lru", "popularity"),
                    help="retained-pool reclamation order under pool "
                         "pressure: least recently touched first (lru) or "
                         "fewest adoptions first (popularity)")
    ap.add_argument("--retain-pool-pages", type=int, default=0,
                    help="cap on retained-only pages held idle (0 = "
                         "pool-bounded: pressure reclaims them lazily)")
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"),
                    help="paged KV pool storage: the model's dtype or int8 "
                         "rows with per-row f32 scales")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission: reject submits once this many "
                         "requests wait (0 = unbounded)")
    ap.add_argument("--deadline-ticks", type=int, default=0,
                    help="per-request tick deadline (0 = none): a request "
                         "still unfinished this many ticks after submit "
                         "ends DEADLINE_EXCEEDED with its partial output")
    ap.add_argument("--preempt-policy", default="fewest-tokens",
                    choices=("fewest-tokens", "most-pages"),
                    help="victim when no slot can get pages: the request "
                         "with the fewest generated tokens, or the one "
                         "holding the most pages; it requeues and "
                         "recomputes")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable preempt-and-recompute: a pool that "
                         "cannot give any slot capacity raises 'page pool "
                         "exhausted'")
    ap.add_argument("--wedge-ticks", type=int, default=10_000,
                    help="consecutive idle-but-busy ticks before the "
                         "engine declares itself wedged and raises")
    ap.add_argument("--no-prefill-lane", action="store_true",
                    help="route prompts through the decode loop one token "
                         "per step as forced tokens (prefill-by-decode)")
    ap.add_argument("--draft-arch", default="",
                    help="speculative decoding: registry id of the draft "
                         "model (it must share the target's vocabulary); "
                         "it proposes --spec-k tokens per decode tick from "
                         "its own page pool, and the target verifies them "
                         "in one ragged prefill-lane call")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="draft proposals per decode tick (0 = off); a "
                         "tick keeps the accepted ones plus one bonus "
                         "token, and greedy output equals plain decode's")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="write the engine's whole state (both page pools "
                         "verbatim, tables, queue, requests, generator "
                         "states) every N ticks (0 = off); atomic, "
                         "checksummed, pruned to the newest two files")
    ap.add_argument("--snapshot-dir", default="",
                    help="directory for snap-<tick>.bin files (required "
                         "with --snapshot-every)")
    ap.add_argument("--restore-from", default="",
                    help="restore the engine from a snapshot file and "
                         "serve its in-flight work instead of the demo "
                         "workload; the snapshot's fingerprint must match "
                         "the flags (checked before the engine is built)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=4,
                    help="decode steps per engine tick")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="prompt tokens per prefill-lane chunk (0 = auto: "
                         "2x --page-size)")
    ap.add_argument("--pages-per-step", type=int, default=1,
                    help="accepted by the paged kernels; changes no result")
    ap.add_argument("--sys-prompt-tokens", type=int, default=16)
    args = ap.parse_args()
    if args.legacy_loop and not args.whole_batch:
        ap.error("--legacy-loop only applies to --whole-batch generation "
                 "(the paged engine always runs the fused decode cell)")
    if args.page_size < 1:
        ap.error("--page-size must be >= 1 (tokens per KV page)")
    if args.pages_per_step < 1:
        ap.error("--pages-per-step must be >= 1")
    if args.prefill_chunk_tokens < 0:
        ap.error("--prefill-chunk-tokens must be >= 0 (0 = auto)")
    if args.retain_pool_pages < 0:
        ap.error("--retain-pool-pages must be >= 0 (0 = pool-bounded)")
    if args.max_queue < 0:
        ap.error("--max-queue must be >= 0 (0 = unbounded admission)")
    if args.deadline_ticks < 0:
        ap.error("--deadline-ticks must be >= 0 (0 = no deadline)")
    if args.wedge_ticks < 1:
        ap.error("--wedge-ticks must be >= 1 (idle ticks before the "
                 "wedge tripwire fires)")
    if args.spec_k < 0:
        ap.error("--spec-k must be >= 0 (draft proposals per decode tick)")
    if args.spec_k and not args.draft_arch:
        ap.error("--spec-k needs --draft-arch (a draft model proposes the "
                 "tokens the target verifies)")
    if args.draft_arch and not args.spec_k:
        ap.error("--draft-arch without --spec-k does nothing; pass "
                 "--spec-k >= 1 to enable speculative decoding")
    if args.spec_k and args.whole_batch:
        ap.error("speculative decoding is a paged-engine mode (draft pages "
                 "+ ragged verify); drop --whole-batch")
    if args.spec_k and args.no_prefill_lane:
        ap.error("speculative verify rides the ragged prefill lane; drop "
                 "--no-prefill-lane")
    if args.spec_k and args.temperature != 0.0:
        ap.error("speculative decoding is greedy-only (acceptance compares "
                 "argmax tokens); use --temperature 0")
    if args.snapshot_every < 0:
        ap.error("--snapshot-every must be >= 0 (0 = no snapshots)")
    if args.snapshot_every and not args.snapshot_dir:
        ap.error("--snapshot-every needs --snapshot-dir (where the "
                 "snap-<tick>.bin files land)")
    if args.restore_from and args.whole_batch:
        ap.error("--restore-from restores the paged engine's state; the "
                 "whole-batch path has no snapshot format: drop "
                 "--whole-batch")
    if args.kv_dtype == "int8" and args.whole_batch:
        ap.error("--kv-dtype int8 quantizes the paged engine's page pools; "
                 "the whole-batch cache has none")
    if args.no_prefix_sharing and not args.no_retain_prefixes \
            and not args.whole_batch:
        print("[launch.serve] NOTE: --no-prefix-sharing disables the "
              "donor index, so cross-lifetime retention is off too "
              "(retention is digest-keyed prefix sharing)")

    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import (PagedEngine, RequestStatus,
                                          ServeConfig, ServingEngine)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[launch.serve] no CUDA device: the port serves on the card "
              "(pass --device cpu to run the plain path on the CPU)",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    cfg = configs.get(args.arch)
    if cfg.is_encoder_decoder:
        ap.error(f"{cfg.name} is an encoder-decoder arch with a stub "
                 f"frontend: the paged engine refuses it, as the JAX "
                 f"package's PagedEngine does, and ServingEngine prefills "
                 f"token prompts, not frames.  Run it through Model.prefill "
                 f"with frames and tokens, then Model.decode_many")
    if not cfg.embed_inputs and args.whole_batch:
        ap.error(f"{cfg.name} is a stub-frontend arch: ServingEngine "
                 f"prefills token prompts and its prefill reads a "
                 f"frontend's embeddings.  Drop --whole-batch: the paged "
                 f"engine serves its text prompts")
    if cfg.mamba_version and not args.whole_batch:
        ap.error(f"{cfg.name} is an SSM arch: pass --whole-batch (the paged "
                 f"engine refuses SSM and hybrid archs, as the JAX package's "
                 f"PagedEngine does: a slot that joins would inherit the "
                 f"previous occupant's state)")
    if args.local_smoke:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, pages_per_step=args.pages_per_step,
                              kv_dtype=args.kv_dtype,
                              draft_arch=args.draft_arch)
    max_seq = max(64, args.sys_prompt_tokens + 8 + args.new_tokens
                  + 2 * (args.batch - 1) + 16)
    if args.restore_from:
        # the fingerprint against the flags before the weights and the
        # engine are built: a mismatched restore dies naming the knob, not
        # on a shape mid-way
        from repro_torch.serve.snapshot import (SnapshotMismatchError,
                                                load_header)
        fp = load_header(args.restore_from)["fingerprint"]
        want = {"arch": cfg.name, "kv_dtype": cfg.kv_dtype,
                "max_batch": args.batch, "max_seq": max_seq,
                "page_size": args.page_size, "spec_k": args.spec_k,
                "temperature": args.temperature,
                "prefill_lane": not args.no_prefill_lane,
                "package": "repro_torch"}
        diff = {k: (fp.get(k), v) for k, v in want.items()
                if fp.get(k) != v}
        if diff:
            raise SnapshotMismatchError(
                f"{args.restore_from}: snapshot was taken from a "
                f"different serving config (snapshot vs launch flags): "
                f"{diff}")
    model = get_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen, device)
    draft_model = draft_params = None
    if args.spec_k:
        dcfg = configs.get(args.draft_arch)
        if args.local_smoke:
            dcfg = dcfg.reduced()
        if dcfg.vocab_size != cfg.vocab_size:
            ap.error(f"--draft-arch {args.draft_arch!r} has vocab "
                     f"{dcfg.vocab_size}, target has {cfg.vocab_size} — "
                     f"speculation needs a shared tokenizer")
        draft_model = get_model(dcfg)
        gen.manual_seed(1)
        draft_params = draft_model.init(gen, device)
    if args.spec_k:
        # the draft pool's capacity, checked before anything is served:
        # its block tables hold max_seq rows, which must fit the longest
        # request's span plus k proposals in flight
        span_max = (args.sys_prompt_tokens + 8 + args.new_tokens
                    + 2 * (args.batch - 1))
        if span_max + args.spec_k > max_seq:
            raise SpecCapacityError(
                f"--spec-k {args.spec_k} overflows the draft pool: the "
                f"worst-case request span is {span_max} tokens and the "
                f"draft block tables hold max_seq={max_seq} rows, so up "
                f"to {max_seq - span_max} proposals fit in flight; "
                f"lower --spec-k or --new-tokens/--sys-prompt-tokens")
    scfg = ServeConfig(max_batch=args.batch, max_seq=max_seq,
                       max_new_tokens=args.new_tokens,
                       temperature=args.temperature,
                       fused=not args.legacy_loop,
                       page_size=args.page_size,
                       prefill_chunk=args.prefill_chunk,
                       prefill_lane=not args.no_prefill_lane,
                       prefill_chunk_tokens=args.prefill_chunk_tokens,
                       prefix_sharing=not args.no_prefix_sharing,
                       retain_prefixes=not args.no_retain_prefixes,
                       retain_policy=args.retain_policy,
                       retain_pool_pages=args.retain_pool_pages,
                       preempt=not args.no_preempt,
                       preempt_policy=args.preempt_policy,
                       max_queue=args.max_queue,
                       deadline_ticks=args.deadline_ticks,
                       wedge_ticks=args.wedge_ticks,
                       snapshot_every_ticks=args.snapshot_every,
                       snapshot_dir=args.snapshot_dir,
                       spec_k=args.spec_k)
    rng = np.random.RandomState(0)
    if args.whole_batch:
        return whole_batch(ServingEngine(model, params, scfg), rng, cfg,
                           args, device)
    engine = PagedEngine(model, params, scfg, draft_model=draft_model,
                         draft_params=draft_params)
    kv = engine.kv
    draft_bytes = (engine.dkv.num_pages * engine.dkv.page_bytes
                   if engine.dkv is not None else 0)
    print(f"[launch.serve] pool: kv_dtype={args.kv_dtype}, {kv.num_pages} "
          f"pages x {kv.page} tokens, {kv.page_bytes} B/page "
          f"({kv.page_bytes / kv.page:.1f} B/token), "
          f"{kv.num_pages * kv.page_bytes / 1e6:.2f} MB pool"
          + (f" + {draft_bytes / 1e6:.2f} MB draft pool" if draft_bytes
             else ""))
    if args.restore_from:
        # serve the snapshot's in-flight work: queued requests re-admit
        # through the lane, running slots decode on from their feed token
        from repro_torch.serve.snapshot import restore_engine
        t0 = time.perf_counter()
        restore_engine(engine, args.restore_from)
        restore_ms = (time.perf_counter() - t0) * 1e3
        rids = sorted(engine.status)
        done = sum(engine.status[r] in (RequestStatus.FINISHED,
                                        RequestStatus.PREEMPTED_RESUMED)
                   for r in rids)
        print(f"[launch.serve] restored tick {engine.ticks} from "
              f"{args.restore_from} in {restore_ms:.1f} ms "
              f"({len(engine.queue)} queued, "
              f"{sum(s.active for s in engine.slots)} running, {done} "
              f"already terminal)")
    else:
        sys_prompt = rng.randint(0, cfg.vocab_size,
                                 size=args.sys_prompt_tokens
                                 ).astype(np.int32)
        rids = [engine.submit(
            np.concatenate([sys_prompt,
                            rng.randint(0, cfg.vocab_size,
                                        size=rng.randint(2, 8)
                                        ).astype(np.int32)]),
            max_new_tokens=args.new_tokens + (i % args.batch) * 2)
            for i in range(2 * args.batch)]
    t0 = time.perf_counter()
    results = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tok = sum(len(results[r]) for r in rids)
    bad = [r for r in rids if not all(0 <= t < cfg.vocab_size
                                      for t in results[r])]
    if bad:
        print(f"[launch.serve] out-of-vocab tokens in requests {bad}",
              file=sys.stderr)
        return 1
    print(f"[launch.serve] {cfg.name} on {device}: {len(results)} requests, "
          f"{n_tok} tokens, {engine.joins} joins over {args.batch} slots "
          f"in {engine.steps_run} ticks, {dt:.2f} s "
          f"({n_tok / dt:.1f} tokens/s, host clock)")
    util = engine.util_trace
    print(f"[launch.serve] paged: shared {engine.shared_tokens} prefix "
          f"tokens (logical/physical x{engine.logical_physical_ratio:.2f}, "
          f"{engine.kv.cow_copies} COW copies), page util "
          f"mean={np.mean(util) if util else 0:.2f} "
          f"max={np.max(util) if util else 0:.2f}")
    print(f"[launch.serve] retention: {engine.kv.retained_hits} retained "
          f"adoptions ({engine.kv.retained_hit_tokens} tokens re-shared "
          f"from dead donors), {engine.kv.retained_pages} pages retained, "
          f"{engine.kv.retained_reclaimed_pages} reclaimed under pressure")
    n_status = {s.value: sum(1 for r in rids if engine.status[r] == s)
                for s in RequestStatus}
    print(f"[launch.serve] overload: {engine.preemptions} preemptions "
          f"({engine.recompute_tokens} recomputed tokens), "
          f"{engine.rejected} rejected, "
          f"{engine.deadline_exceeded} deadline-exceeded, "
          f"{engine.no_progress_ticks} no-progress ticks; statuses "
          + ", ".join(f"{k}={v}" for k, v in n_status.items() if v))
    if args.snapshot_every:
        print(f"[launch.serve] snapshots: {engine.snapshots_written} "
              f"written to {args.snapshot_dir} (every "
              f"{args.snapshot_every} ticks, newest at tick "
              f"{engine._last_snapshot_tick})")
    if args.no_prefill_lane:
        print(f"[launch.serve] prefill-by-decode: "
              f"{engine.forced_upload_bytes} forced-token bytes uploaded, "
              f"{engine.prefill_upload_bytes} prefill-lane bytes")
    if args.spec_k:
        print(f"[launch.serve] speculative: draft={args.draft_arch} "
              f"k={args.spec_k}, accept rate {engine.accept_rate:.2f} "
              f"({engine.spec_accepted}/{engine.spec_proposed} proposals), "
              f"{engine.draft_dispatches} draft + "
              f"{engine.verify_dispatches} verify dispatches, "
              f"{engine.spec_trunc_tokens} rejected K/V rows truncated")
    host, waits = engine.host_ms_trace, engine.wait_ms_trace
    if host:
        print(f"[launch.serve] host: {len(host)} busy ticks, host ms per "
              f"tick median {np.median(host):.3f} p90 "
              f"{np.percentile(host, 90):.3f}, ms waiting for the device "
              f"(uploads, reads back) per tick median "
              f"{np.median(waits):.3f} p90 {np.percentile(waits, 90):.3f} "
              f"({device}), "
              f"{np.mean(engine.dispatch_trace):.2f} device calls and "
              f"{np.mean(engine.upload_trace):.0f} upload bytes per tick")
    return 0


def whole_batch(engine, rng, cfg, args, device) -> int:
    """``--batch`` random prompts of 4-15 tokens through
    ``ServingEngine.generate_batch``; prints the tokens and host-clock
    tokens/s."""
    import torch
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(4, 16)
                           ).astype(np.int32) for _ in range(args.batch)]
    t0 = time.perf_counter()
    outs = engine.generate_batch(prompts)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        print("[launch.serve] out-of-vocab tokens", file=sys.stderr)
        return 1
    mode = ("legacy per-token loop" if args.legacy_loop
            else "fused decode_many")
    print(f"[launch.serve] {cfg.name} on {device}: generated {n_tok} tokens "
          f"across {len(outs)} requests ({mode}), {dt:.2f} s "
          f"({n_tok / dt:.1f} tokens/s, host clock, prefill included)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
