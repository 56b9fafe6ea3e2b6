"""Checkpoint/restart: step-addressed, atomic, corruption-tolerant — port
of ``repro/train/checkpoint.py`` with the same layout and semantics.

Format: one directory per step —
    <dir>/step_000000123/
        manifest.json     # leaf paths, shapes, dtypes, step, extra
        arrays.npz        # the leaves (np.savez, keyed a0, a1, ...)
        COMMIT            # written LAST; a checkpoint without it is partial

A state is a nested dict of tensors (or numpy arrays); its leaves are
taken with keys sorted at every level, the order of ``jax.tree.flatten``.
bf16 has no numpy dtype here (the card's machine has no ``ml_dtypes``):
it is stored as the uint16 view of its bits, and the manifest keeps the
logical dtype, as the JAX package stores it.  Restore scans for the
newest COMMITted step, skips partial ones and raises on a leaf count or
shape that does not match; save can run on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def _unflatten(like, leaves: List[Any]):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(like)


def _to_storable(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to write, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:               # its bits, as uint16
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(directory: str, step: int, state: Dict[str, Any],
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Blocking save of a nested dict of tensors or arrays."""
    path = os.path.join(directory, f"step_{step:09d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = _flatten(state)
    arrays, meta = {}, []
    for i, (name, leaf) in enumerate(leaves):
        arr, dtype = _to_storable(leaf)
        arrays[f"a{i}"] = arr
        meta.append({"path": name, "shape": list(arr.shape), "dtype": dtype})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "treedef": [m["path"] for m in meta],
                "n_leaves": len(leaves), "leaves": meta,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


class AsyncCheckpointer:
    """Fire-and-forget save on a background thread; at most one in flight
    (a second save waits — checkpointing never corrupts by overlap).  The
    state is copied to host memory before ``save`` returns."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def save(self, directory: str, step: int, state, extra=None):
        host = _unflatten(state, [
            leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else np.array(leaf)
            for _, leaf in _flatten(state)])           # snapshot now

        def work():
            with self._lock:
                save(directory, step, host, extra)

        self.wait()
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _is_valid(path: str) -> bool:
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "COMMIT"))
            and os.path.exists(os.path.join(path, "manifest.json"))
            and os.path.exists(os.path.join(path, "arrays.npz")))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and _is_valid(
                os.path.join(directory, name)):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(directory: str, like: Dict[str, Any],
            step: Optional[int] = None
            ) -> Optional[Tuple[int, Dict[str, Any], Dict[str, Any]]]:
    """Restore the newest valid checkpoint into the structure of ``like``:
    each leaf a tensor of its stored dtype, on the device of ``like``'s
    leaf where that is a tensor.  Returns (step, state, extra), or None
    if nothing is restorable."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    path = os.path.join(directory, f"step_{step:09d}")
    if not _is_valid(path):
        return None
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    leaves_like = [leaf for _, leaf in _flatten(like)]
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves_like)} — incompatible tree")
    leaves = []
    for i, ref in enumerate(leaves_like):
        t = _from_storable(data[f"a{i}"], manifest["leaves"][i]["dtype"])
        want = tuple(ref.shape) if hasattr(ref, "shape") else None
        if want is not None and tuple(t.shape) != want:
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != {want}")
        if isinstance(ref, torch.Tensor):
            t = t.to(ref.device)
        leaves.append(t)
    return manifest["step"], _unflatten(like, leaves), \
        manifest.get("extra", {})
