#!/usr/bin/env python3
"""Device time by CUDA kernel of the port's dense decode attention and dot,
beside the PyTorch calls ``chip_smoke.py`` times them against, from a
``torch.profiler`` trace of the card.

    python3 scripts/torch_kernel_profile.py            # on one H100

Shapes are ``chip_smoke.py``'s timing phases: dense decode at granite-8b's
geometry in bf16 (B = 4, T = kv_len = 486, H = 32, KV = 8, D = 128),
cycling through 36 layers' caches so that every call reads from memory,
against ``scaled_dot_product_attention`` (GQA), and at 4, 16 and 32
splits per kv head beside the wrapper's 8; dot over 2^25 f32
elements against ``torch.dot``.  Each call runs ``ITERS`` times after a
warm-up, and for each the kernels it launched are printed with their
device microseconds per call, then their sum.  The last line names the
card and its power limit.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

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


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_kernel_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.stream import stream
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
