"""Training launcher of the port: an arch at a training shape, restored
from the newest checkpoint if there is one, through the port's trainer on
one device.

    python -m repro_torch.launch.train                 # qwen2-0.5b, cuda
    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 2 --batch 8
    python -m repro_torch.launch.train --local-smoke --device cpu --steps 3
    python -m repro_torch.launch.train --local-smoke --device cpu \
        --steps 6 --ckpt ckpts             # a later run resumes from ckpts

Weights are random, drawn from a seeded ``torch.Generator`` on the
device; the data is the synthetic token pipeline.  As in the JAX
launcher: ``--shape`` names a training shape (``train_4k``: S = 4096, a
global batch of 256), ``--local-smoke`` runs the reduced config at S 64
and batch 4, the schedule is ``cosine_with_warmup(3e-4, 100, steps)``
(at most 2.4e-5 over the first 8 steps, so a short run barely moves its
weights) and the moments are bf16 above 2e11 parameters, else f32.  On
one card the global batch runs as accumulated microbatches of 4
sequences, and ``--batch`` may cut it.
The multi-host flags (``--coordinator``, ``--num-hosts``, ``--host-id``)
need a device mesh, which the port does not have yet, and are refused.
"""
import argparse
import sys
import time

# sequences a microbatch on one card: qwen2-0.5b at S 4096 in two of them
# peaks at ~23 GiB (chip_smoke.py's train phase, PERF.md)
MICROBATCH = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--local-smoke", action="store_true",
                    help="reduced config (same family, tiny dims)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch (default: the shape's)")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    args = ap.parse_args(argv)

    if args.coordinator or args.num_hosts != 1 or args.host_id != 0:
        ap.error("--coordinator, --num-hosts and --host-id need the "
                 "production mesh (the JAX launcher's rules_for and "
                 "make_production_mesh): the port trains on one device "
                 "until its multi-device slice")

    import torch

    from repro_torch import configs
    from repro_torch.configs import SHAPES
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import cosine_with_warmup
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[launch.train] no CUDA device: the port trains on the card "
              "(pass --device cpu to run the plain path on the CPU)",
              file=sys.stderr)
        return 2
    cfg = configs.get(args.arch)
    if args.local_smoke:
        cfg = cfg.reduced()
        seq_len, global_batch = 64, 4
    else:
        shape = SHAPES[args.shape]
        if shape.kind != "train":
            ap.error(f"--shape {args.shape} is a {shape.kind} shape")
        seq_len, global_batch = shape.seq_len, shape.global_batch
    global_batch = args.batch or global_batch
    micro = max(1, global_batch // MICROBATCH)

    model = get_model(cfg)
    trainer = Trainer(
        model,
        AdamWConfig(lr=cosine_with_warmup(3e-4, 100, args.steps),
                    moment_dtype="bfloat16" if cfg.n_params() > 2e11
                    else "float32"),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                   global_batch=global_batch,
                   emit_embeddings=not cfg.embed_inputs
                   and not cfg.is_encoder_decoder,
                   emit_frames=cfg.is_encoder_decoder,
                   d_model=cfg.d_model),
        TrainerConfig(steps=args.steps, checkpoint_dir=args.ckpt or None,
                      checkpoint_every=50, microbatches=micro,
                      device=args.device),
    )
    t0 = time.time()
    out = trainer.run()
    print(f"[launch.train] {cfg.name} S {seq_len} batch {global_batch} "
          f"({micro} microbatches) on {args.device}: "
          f"{len(out['losses'])} steps in {time.time() - t0:.2f} s")
    print(f"[launch.train] done: loss {out['first_loss']:.4f} -> "
          f"{out['last_loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
