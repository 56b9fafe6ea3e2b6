"""Deterministic, resumable, sharded synthetic-token data pipeline — a
copy of ``repro/data/pipeline.py`` (numpy only), so that the port imports
nothing of the JAX package; ``batch_at(step)`` equals the JAX package's
bit for bit (tests/test_torch_train.py).

Production properties this models (and tests assert):
  * deterministic as a function of (seed, step) — restart-safe: the
    checkpoint stores only the step cursor;
  * host-sharded: each data-parallel host generates only its slice
    (``host_index`` / ``num_hosts``);
  * straggler re-assignment: ``reassign(host)`` lets the trainer hand a
    slow host's shard to a spare without replaying the stream (pure
    function of (seed, step, shard map));
  * background prefetch of the next batch (double buffering).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    emit_embeddings: bool = False     # stub-frontend archs (audio/vlm)
    d_model: int = 0
    emit_frames: bool = False         # enc-dec


class SyntheticTokenPipeline:
    """Zipf-ish synthetic LM tokens with next-token labels."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        self._shard_map: Dict[int, int] = {i: i for i in
                                           range(cfg.num_hosts)}
        self._queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._prefetch_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- determinism ---------------------------------------------------------
    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(
            key=self.cfg.seed, counter=[0, 0, step, shard]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The local batch for `step` — pure function of (seed, step,
        shard)."""
        cfg = self.cfg
        shard = self._shard_map[cfg.host_index]
        rng = self._rng(step, shard)
        # zipf-like marginal over the vocab, cheap to sample
        u = rng.random((self.local_batch, cfg.seq_len + 1))
        toks = ((cfg.vocab_size - 1) * u ** 3.0).astype(np.int32)
        batch: Dict[str, np.ndarray] = {
            "labels": toks[:, 1:].astype(np.int32)}
        if cfg.emit_embeddings:
            batch["embeds"] = rng.standard_normal(
                (self.local_batch, cfg.seq_len, cfg.d_model),
                dtype=np.float32)
        else:
            batch["tokens"] = toks[:, :-1]
        if cfg.emit_frames:
            batch["frames"] = rng.standard_normal(
                (self.local_batch, cfg.seq_len, cfg.d_model),
                dtype=np.float32)
            batch["tokens"] = toks[:, :-1]
        return batch

    # -- straggler mitigation hook -------------------------------------------
    def reassign(self, slow_host: int, spare_host: int) -> None:
        """Hand slow_host's shard to spare_host (no stream replay needed)."""
        self._shard_map[spare_host] = self._shard_map[slow_host]

    # -- prefetching iterator --------------------------------------------------
    def iterator(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._queue.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._stop.clear()
        self._prefetch_thread = threading.Thread(target=worker, daemon=True)
        self._prefetch_thread.start()
        try:
            while True:
                yield self._queue.get()
        finally:
            self._stop.set()

    def close(self):
        self._stop.set()
