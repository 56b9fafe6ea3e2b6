"""Training loop with checkpoint/restart, straggler monitoring and a
per-step history — port of ``repro/train/trainer.py``.

It runs on one explicit device (``TrainerConfig.device``, "cuda" unless
asked), with weights drawn from a ``torch.Generator`` seeded with
``TrainerConfig.seed``.  Each step takes the pipeline's batch for its
step number (a pure function of (seed, step)), so a run restored from a
checkpoint at step n sees the batches a straight run sees from n on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.straggler import StragglerMonitor
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0
    async_checkpoint: bool = True
    device: str = "cuda"


def batch_to_device(batch_np: Dict[str, Any], cfg, device
                    ) -> Dict[str, torch.Tensor]:
    """The pipeline's numpy batch as tensors on ``device``; embeddings and
    frames in the model's param dtype, as the JAX trainer casts them."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    for k in ("embeds", "frames"):
        if k in batch:
            batch[k] = batch[k].to(cfg.param_dtype)
    return batch


class Trainer:
    def __init__(self, model: Model, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, cfg: TrainerConfig):
        self.model = model
        self.optimizer = AdamW(opt_cfg)
        self.pipeline = SyntheticTokenPipeline(data_cfg)
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.step_fn = make_train_step(model, self.optimizer,
                                       microbatches=cfg.microbatches)
        self.monitor = StragglerMonitor(data_cfg.num_hosts)
        self.checkpointer = ckpt.AsyncCheckpointer()
        self.history: List[Dict[str, float]] = []

    # -- state ----------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        params = self.model.init(gen, self.device)
        return {"params": params, "opt": self.optimizer.init(params)}

    def _maybe_restore(self, state):
        d = self.cfg.checkpoint_dir
        if not d:
            return 0, state
        got = ckpt.restore(d, state)
        if got is None:
            return 0, state
        step, state, extra = got
        print(f"[trainer] restored checkpoint at step {step}")
        return int(extra.get("data_step", step)), state

    # -- loop -----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        state = self.init_state()
        start_step, state = self._maybe_restore(state)
        params, opt_state = state["params"], state["opt"]
        losses = []
        t_start = time.time()
        for step in range(start_step, self.cfg.steps):
            t0 = time.time()
            batch = batch_to_device(self.pipeline.batch_at(step),
                                    self.model.cfg, self.device)
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])          # waits for the step
            gnorm = float(metrics["grad_norm"])
            losses.append(loss)
            dt = time.time() - t0
            self.monitor.update({self.pipeline.cfg.host_index: dt})
            self.history.append({"step": step, "loss": loss, "time_s": dt,
                                 "grad_norm": gnorm})
            if step % self.cfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"gnorm {gnorm:.3f} {dt * 1e3:.0f} ms")
            if (self.cfg.checkpoint_dir
                    and (step + 1) % self.cfg.checkpoint_every == 0):
                st = {"params": params, "opt": opt_state}
                if self.cfg.async_checkpoint:
                    self.checkpointer.save(self.cfg.checkpoint_dir, step + 1,
                                           st, {"data_step": step + 1})
                else:
                    ckpt.save(self.cfg.checkpoint_dir, step + 1, st,
                              {"data_step": step + 1})
        self.checkpointer.wait()
        return {
            "losses": losses,
            "first_loss": losses[0] if losses else float("nan"),
            "last_loss": losses[-1] if losses else float("nan"),
            "wall_s": time.time() - t_start,
            "params": params,
            "opt": opt_state,
        }
