"""Training launcher of the port: an arch at a training shape, restored
from the newest checkpoint if there is one, through the port's trainer on
one device, or on every rank of a multi-host run.

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

The multi-host flags, as in the JAX launcher: every rank runs

    python -m repro_torch.launch.train --arch grok-1-314b \
        --coordinator HOST:PORT --num-hosts N --host-id i

which joins the process group (NCCL with ``--device cuda``, one rank a
card; gloo with ``--device cpu``) and, without ``--local-smoke``, trains
on the production mesh (16 x 16, 256 ranks) under the dry-run's
``rules_for`` rules, installed with ``set_context``; a world of another
size is refused by name.  Under the mesh every rank draws the global
batch and the trainer places it; a data shard's rows run as
microbatches of 4.  With ``--local-smoke`` no mesh is built, as in the
JAX launcher: each rank trains the reduced config on its own shard of
the batch.  Without the flags the launcher trains on one device.
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

    multi_host = bool(args.coordinator) or args.num_hosts != 1 \
        or args.host_id != 0
    if multi_host and not args.coordinator:
        ap.error("--num-hosts and --host-id need --coordinator HOST:PORT")

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
    n_dp, hosts = 1, (args.num_hosts, args.host_id)
    if multi_host:
        import torch.distributed as dist
        if args.device == "cuda":
            torch.cuda.set_device(args.host_id % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if args.device == "cuda" else "gloo",
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_hosts, rank=args.host_id)
        if not args.local_smoke:
            from repro_torch.dist.sharding import set_context
            from repro_torch.launch.dryrun import rules_for
            from repro_torch.launch.mesh import make_production_mesh
            try:
                mesh = make_production_mesh()
            except ValueError as e:
                dist.destroy_process_group()
                print(f"[launch.train] {e}", file=sys.stderr)
                return 2
            rules = rules_for(get_model(cfg), shape, multi_pod=False)
            set_context(mesh, rules)
            for a in rules.batch_axes:
                n_dp *= dict(zip(mesh.mesh_dim_names, mesh.shape))[a]
            hosts = (1, 0)          # every rank draws the global batch
    micro = max(1, global_batch // n_dp // MICROBATCH)

    model = get_model(cfg)
    trainer = Trainer(
        model,
        AdamWConfig(lr=cosine_with_warmup(3e-4, 100, args.steps),
                    moment_dtype="bfloat16" if cfg.n_params() > 2e11
                    else "float32"),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                   global_batch=global_batch,
                   num_hosts=hosts[0], host_index=hosts[1],
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
    if multi_host:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
