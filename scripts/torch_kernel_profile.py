#!/usr/bin/env python3
"""Device time by CUDA kernel of the port's paged and dense decode
attention, selective scan and dot, beside the PyTorch calls
``chip_smoke.py`` times them against, from a ``torch.profiler`` trace of
the card.

    python3 scripts/torch_kernel_profile.py            # on one H100

Shapes are ``chip_smoke.py``'s timing phases, all at granite-8b's
attention geometry in bf16 (H = 32, KV = 8, D = 128) and cycling through
36 layers so that every call reads from memory: paged decode over a
22-page table at page 16 with the serving path's lengths (B = 4, kv_len
255, 276, 105, 147), at 4, 8, 16 and 32 splits per kv head (the wrapper
takes 8), against a block-table gather plus
``scaled_dot_product_attention``; dense decode (B = 4, T = kv_len = 486)
against SDPA (GQA), and at 4, 16 and 32 splits beside the wrapper's 8;
the selective scan at falcon-mamba-7b's shape (B = 4, S = 454, d_in =
8192, N = 16, bf16) with each channel's state over 1, 2 and 4 lanes of a
warp (the wrapper takes 2), cycling through 4 input sets, and the
instructions per exponential of each one's inner loop in its SASS
(``cuobjdump``); dot over 2^25
f32 elements against ``torch.dot``.  Each call runs ``ITERS`` times after
a warm-up, and for each the kernels it launched are printed with their
device microseconds per call, then their sum.  The last line names the
card and its power limit.
"""
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ITERS = 36


def profile(torch, name, fn):
    """Runs ``fn(i)`` ITERS times under the profiler; prints each CUDA
    kernel's device time per call and their sum."""
    from torch.profiler import ProfilerActivity, profile as trace
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(ITERS):
            fn(i)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / ITERS)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    if not rows:
        print(f"[profile] {name}: the trace holds no device time")
        return
    for key, count, us in sorted(rows, key=lambda r: -r[2]):
        print(f"[profile] {name}: {us:9.3f} us per call, {count // ITERS} "
              f"launch(es) per call: {key[:110]}")
    print(f"[profile] {name}: {sum(r[2] for r in rows):9.3f} us per call "
          f"in all")


def split_decode(torch, decode, q, k, v, kvl, start, n):
    """The dense decode kernel's C entry with ``n`` splits instead of the
    wrapper's ``decode.splits``, its scratch sized to match."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    out = torch.empty_like(q)
    part = torch.empty(B * H * n * (D + 2), dtype=torch.float32,
                       device=q.device)
    decode.KERNEL(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  kvl.data_ptr(), start.data_ptr(), part.data_ptr(), B,
                  k.shape[1], H, KV, D, n, decode.DTYPE_CODES[q.dtype],
                  torch.cuda.current_stream().cuda_stream)
    return out


def split_paged_decode(torch, paged, c, layer, n):
    """The paged decode kernel's C entry with ``n`` splits instead of the
    wrapper's ``paged.splits``, its scratch sized to match."""
    q, k = c["q"], c["k"]
    B, _, H, D = q.shape
    _, num_pages, page, KV, _ = k.shape
    out = torch.empty_like(q)
    part = torch.empty(B * H * n * (D + 2), dtype=torch.float32,
                       device=q.device)
    paged.KERNEL(out.data_ptr(), q.data_ptr(), k.data_ptr(),
                 c["v"].data_ptr(), None, None, c["table"].data_ptr(),
                 c["lens"].data_ptr(), part.data_ptr(), B, H, KV, D,
                 num_pages, page, c["table"].shape[1], layer, n,
                 paged.DTYPE_CODES[q.dtype], paged.DTYPE_CODES[k.dtype],
                 torch.cuda.current_stream().cuda_stream)
    return out


def profile_paged(torch):
    """Paged decode at the serving path's shape, its split counts, and
    gather + SDPA."""
    from chip_smoke import make_case, run_kernel, run_library
    from repro_torch.kernels.decode_attention import paged
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    L, NB = 36, 22
    c = make_case(gen, B=4, T=1, H=32, KV=8, D=128, page=16, NB=NB, L=L,
                  q_dtype=torch.bfloat16, pool="bf16",
                  lens=[255, 276, 105, 147])
    profile(torch, f"paged_decode_attention ({paged.splits(NB, 4, 8)} "
            f"splits)", lambda i: run_kernel("decode", c, layer=i % L))
    for n in (4, 8, 16, 32):
        profile(torch, f"paged_decode_attention, {n} splits",
                lambda i, n=n: split_paged_decode(torch, paged, c, i % L, n))
    profile(torch, "gather + SDPA (GQA)",
            lambda i: run_library("decode", c, layer=i % L))


def profile_scan(torch):
    """The selective scan at falcon-mamba-7b's prefill shape, its state
    over 1, 2 and 4 lanes a channel."""
    from chip_smoke import scan_inputs
    from repro_torch.kernels.ssm_scan import scan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    sets = [scan_inputs(gen, 4, 454, 8192, 16, torch.bfloat16)
            for _ in range(4)]
    lanes = scan.LANES
    profile(torch, f"selective_scan ({lanes} lanes)",
            lambda i: scan.selective_scan(*sets[i % 4]))
    for n in (1, 2, 4):
        scan.LANES = n
        profile(torch, f"selective_scan, {n} lanes",
                lambda i: scan.selective_scan(*sets[i % 4]))
    scan.LANES = lanes


def scan_loop_mix() -> None:
    """Instructions per exponential in the scan's inner loop, from the
    built library's SASS (``cuobjdump``): for each bf16 N = 16
    instantiation, of the loops (a backward branch and its target) that
    hold an MUFU, the one with the fewest instructions per MUFU, which is
    the unrolled step loop, and its commonest opcodes."""
    from repro_torch.core.sass_counters import (
        _TARGET, _base, sass_listing, split_functions)
    from repro_torch.kernels import build
    for name, insts in sorted(split_functions(
            sass_listing(build.build())).items()):
        m = re.search(r"selective_scan_kernelI13__nv_bfloat16Li16ELi(\d)E",
                      name)
        if not m:
            continue
        where = {a: k for k, (a, _) in enumerate(insts)}
        best = None
        for k, (a, text) in enumerate(insts):
            op, ins = _base(text)
            t = _TARGET.search(ins)
            if op != "BRA" or not t or int(t.group(1), 16) >= a:
                continue
            ops = [_base(x)[0] for _, x in insts[where[int(t.group(1), 16)]:
                                                   k + 1]]
            n = ops.count("MUFU")
            if n and (best is None or len(ops) / n < len(best) / best[
                    "MUFU"]):
                best = Counter(ops)
        total = sum(best.values())
        print(f"[sass] selective_scan bf16 N=16, {m.group(1)} lanes: inner "
              f"loop {total} instructions, {best['MUFU']} MUFU = "
              f"{total / best['MUFU']:.2f} per exponential; "
              f"{dict(best.most_common(8))}")


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_kernel_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.stream import stream
    profile_paged(torch)
    torch.cuda.empty_cache()
    profile_scan(torch)
    scan_loop_mix()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    B, T, H, KV, D, L, bf = 4, 486, 32, 8, 128, 36, torch.bfloat16
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(bf)
    kc, vc = (torch.randn(L, B, T, KV, D, generator=gen, device="cuda")
              .to(bf) for _ in range(2))
    kvl = torch.tensor(T, dtype=torch.int32, device="cuda")
    start = torch.zeros(B, dtype=torch.int32, device="cuda")
    profile(torch, "decode_attention", lambda i: decode.decode_attention(
        q, kc[i % L], vc[i % L], kvl, start))
    for n in (4, 16, 32):                # the wrapper's choice is 8
        profile(torch, f"decode_attention, {n} splits",
                lambda i, n=n: split_decode(torch, decode, q, kc[i % L],
                                            vc[i % L], kvl, start, n))
    profile(torch, "SDPA (GQA)", lambda i: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc[i % L].transpose(1, 2),
        vc[i % L].transpose(1, 2), enable_gqa=True))
    del kc, vc
    a, b = (torch.full((16384, 2048), v, device="cuda") for v in (0.1, 0.2))
    fa, fb = a.view(-1), b.view(-1)
    profile(torch, "dot", lambda i: stream.dot(a, b))
    profile(torch, "torch.dot", lambda i: torch.dot(fa, fb))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
