"""AdamW with optional low-precision moment storage — port of
``repro/optim/adamw.py``.

Parameters, gradients and moments are nested dicts of tensors of the
same structure; the update is functional, as the JAX one: it returns new
parameters and a new state.  ``moment_dtype``:

  float32  — default
  bfloat16 — halves moment memory
  int8     — blockwise-quantized moments (256 values a block) with f32
             per-block scales; the second moment is quantized on a sqrt
             scale and read back with a half-LSB floor

The global-norm clip, the bias corrections and the update run in f32;
weight decay applies to every leaf, norms and biases included, as in the
JAX package.  ``torch.round`` rounds half to even, as ``jnp.round``
does.  The JAX class's ``abstract_state`` and ``state_pspecs`` lay the
state out over a device mesh and have no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]

_QBLOCK = 256


def _quantize_int8(x: torch.Tensor, sqrt_domain: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise signed-int8 quantization with f32 per-block scales;
    ``sqrt_domain`` for the non-negative second moment (small v entries
    then do not collapse to zero)."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _QBLOCK))
    blk = flat.reshape(-1, _QBLOCK)
    if sqrt_domain:
        blk = torch.sqrt(torch.clamp(blk, min=0.0))
    scale = blk.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blk / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                     sqrt_domain: bool = False) -> torch.Tensor:
    qf = q.to(torch.float32)
    if sqrt_domain:
        # half-LSB floor: a v that quantized to 0 is read as half a step
        qf = torch.clamp(qf, min=0.5)
        flat = torch.square((qf * scale).reshape(-1))
    else:
        flat = (qf * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape))


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, keys sorted at every level (the order
    of ``jax.tree.leaves``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves(tree[k])]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (tensors) and the matching
    entries of ``rest``, which may hold anything at those places."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Schedule] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"    # float32 | bfloat16 | int8

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    cfg: AdamWConfig = AdamWConfig()

    def _store(self, x: torch.Tensor, sqrt_domain: bool = False):
        if self.cfg.moment_dtype == "int8":
            q, s = _quantize_int8(x, sqrt_domain)
            return {"q": q, "scale": s}
        dt = (torch.bfloat16 if self.cfg.moment_dtype == "bfloat16"
              else torch.float32)
        return x.to(dt)

    def _load(self, mom, p: torch.Tensor, sqrt_domain: bool = False):
        if self.cfg.moment_dtype == "int8":
            return _dequantize_int8(mom["q"], mom["scale"], p.shape,
                                    sqrt_domain)
        return mom.to(torch.float32)

    def init(self, params) -> Dict[str, Any]:
        def mk(p):
            return self._store(torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device))
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(mk, params), "v": tree_map(mk, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads, state, params) -> Tuple[Any, dict, dict]:
        """Returns (new params, new state, {"grad_norm", "lr"})."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = cfg.lr_at(step)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in tree_leaves(grads)))
        scale = None
        if cfg.grad_clip_norm is not None:
            scale = torch.clamp(cfg.grad_clip_norm
                                / torch.clamp(gnorm, min=1e-9), max=1.0)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                           device=stepf.device), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                           device=stepf.device), stepf)

        def one(p, g, m, v):
            g = g.to(torch.float32)          # clipped leaf by leaf: no
            if scale is not None:            # second copy of every grad
                g = g * scale
            m32 = cfg.b1 * self._load(m, p) + (1 - cfg.b1) * g
            v32 = (cfg.b2 * self._load(v, p, sqrt_domain=True)
                   + (1 - cfg.b2) * torch.square(g))
            upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            upd = upd + cfg.weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr * upd).to(p.dtype)
            return new_p, self._store(m32), self._store(v32, True)

        outs = tree_map(one, params, grads, state["m"], state["v"])
        pick = lambda i: tree_map(lambda _, o: o[i], params, outs)  # noqa
        new_state = {"m": pick(1), "v": pick(2), "step": step}
        return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}
