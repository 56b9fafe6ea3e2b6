"""Serving demo of the PyTorch port on a reduced granite-8b — the twin of
``examples/serve_demo.py``: whole-batch fused decode at temperature 0.8,
then the paged continuous-batching engine (per-slot positions,
refcounted page pool, chunked prefill, prefix sharing + copy-on-write).

Run:  PYTHONPATH=src python examples/serve_demo_torch.py   # on the card
      PYTHONPATH=src python examples/serve_demo_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.models.model import get_model
from repro_torch.serve.engine import PagedEngine, ServeConfig, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    cfg = get("granite-8b").reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator(device=args.device).manual_seed(0),
                        args.device)
    engine = ServingEngine(model, params,
                           ServeConfig(max_batch=4, max_seq=96,
                                       max_new_tokens=12, temperature=0.8))

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 17, 5, 12)]
    t0 = time.time()
    outs = engine.generate_batch(prompts)
    dt = time.time() - t0
    total = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"[serve_demo_torch] req{i} prompt_len={len(prompts[i])} -> {o}")
    print(f"[serve_demo_torch] {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s on {args.device})")

    stats = engine.benchmark_decode(batch=4, seq=64, steps=6)
    print(f"[serve_demo_torch] fused decode step "
          f"{stats['s_per_step']*1e3:.2f} ms "
          f"({stats['tokens_per_s']:.1f} tok/s), "
          f"x{stats['fused_speedup']:.1f} vs per-token loop")

    # paged continuous batching: 8 requests over 4 slots, mid-flight joins,
    # prompts chunk-prefilled
    pe = PagedEngine(model, params,
                     ServeConfig(max_batch=4, max_seq=64, max_new_tokens=8,
                                 page_size=16, prefill_chunk=4))
    rids = [pe.submit(rng.randint(0, cfg.vocab_size, size=6)
                      .astype(np.int32)) for _ in range(8)]
    results = pe.run()
    util = pe.util_trace
    print(f"[serve_demo_torch] paged: {len(results)} requests / {pe.joins} "
          f"joins on 4 slots, {sum(len(results[r]) for r in rids)} tokens "
          f"in {pe.steps_run} chunked ticks, page util "
          f"mean={np.mean(util):.2f} max={np.max(util):.2f}")

    # prefix sharing: a common system prompt across 8 requests — later
    # admissions reference the resident prefix pages instead of recomputing
    # them; the first append into a shared page copies it (copy-on-write)
    pe = PagedEngine(model, params,
                     ServeConfig(max_batch=4, max_seq=64, max_new_tokens=6,
                                 page_size=8, prefill_chunk=4))
    sys_prompt = rng.randint(0, cfg.vocab_size, size=18).astype(np.int32)
    # ragged tails AND budgets stagger the finishes: sharing matches live
    # slots (and retained prefixes), so a later admission finds a donor
    rids = [pe.submit(np.concatenate(
        [sys_prompt, rng.randint(0, cfg.vocab_size, size=rng.randint(2, 9))
         .astype(np.int32)]), max_new_tokens=int(rng.randint(3, 10)))
        for _ in range(8)]
    results = pe.run()
    print(f"[serve_demo_torch] shared-prefix: {len(results)} requests, "
          f"{pe.shared_tokens} prompt tokens served by page reference, "
          f"{pe.kv.cow_copies} COW page copies, logical/physical tokens "
          f"x{pe.logical_physical_ratio:.2f}")


if __name__ == "__main__":
    main()
