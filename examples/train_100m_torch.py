"""End-to-end training run of the PyTorch port: a ~100M-parameter
llama-family model for a few hundred steps through the port's Trainer,
with checkpoint/restart and loss logging — the twin of
``examples/train_100m.py``, with the same presets.

Presets:
  --preset 100m        the real thing (~163M params, a few hundred steps;
                       on the card: --device cuda, the default)
  --preset cpu-smoke   CPU-sized variant (~6M params, 120 steps); same
                       code path end to end (--device cpu)

Run:  PYTHONPATH=src python examples/train_100m_torch.py --preset cpu-smoke \
          --device cpu
      PYTHONPATH=src python examples/train_100m_torch.py --preset 100m
Restart behaviour: re-running with the same --ckpt dir resumes from the
newest committed checkpoint (kill it mid-run and re-run to see).  The
default directory is ``build/train_100m_torch_ckpt`` in the checkout.
"""
import argparse
from pathlib import Path

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    "100m": dict(
        arch=ArchConfig(
            name="llama-100m", family="dense", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, d_ff=3072, vocab_size=32768,
            attn_chunk_q=512, attn_chunk_kv=512),
        seq_len=1024, global_batch=32, steps=300, lr=3e-4),
    "cpu-smoke": dict(
        arch=ArchConfig(
            name="llama-6m", family="dense", n_layers=4, d_model=256,
            n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=4096,
            attn_chunk_q=128, attn_chunk_kv=128),
        seq_len=128, global_batch=8, steps=120, lr=1e-3),
}
CKPT = Path(__file__).resolve().parents[1] / "build" / "train_100m_torch_ckpt"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="cpu-smoke", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    p = PRESETS[args.preset]
    cfg = p["arch"]
    model = get_model(cfg)
    n = cfg.n_params()
    print(f"[train_100m_torch] {cfg.name}: ~{n/1e6:.1f}M params on "
          f"{args.device}")

    steps = args.steps or p["steps"]
    trainer = Trainer(
        model,
        AdamWConfig(lr=cosine_with_warmup(p["lr"], 20, steps)),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq_len"],
                   global_batch=p["global_batch"]),
        TrainerConfig(steps=steps, checkpoint_every=max(10, steps // 4),
                      checkpoint_dir=args.ckpt, log_every=10,
                      device=args.device),
    )
    out = trainer.run()
    if not out["losses"]:
        print(f"[train_100m_torch] nothing to do: the checkpoint in "
              f"{args.ckpt} is at step {steps}")
        return
    print(f"[train_100m_torch] loss {out['first_loss']:.4f} -> "
          f"{out['last_loss']:.4f} over {len(out['losses'])} steps "
          f"({out['wall_s']:.1f}s)")
    assert out["last_loss"] < out["first_loss"], "loss did not improve"
    print("[train_100m_torch] OK — loss improved")


if __name__ == "__main__":
    main()
