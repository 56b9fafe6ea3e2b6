"""The one generator of the benchmark's traffic: it reads a traffic
file's parameters and makes, from ``--seed``, the requests of a serving
mix or the batches of a training job.  A new mix is a new data file.

Every seed gets the same sizes in the same order: the sizes are the
distribution's quantiles at evenly spaced points of a pool, put in an
order fixed for the mix (``ORDER``); the seed draws the token ids.  So
seeds change the ids and the weights, not how much work a run holds nor
when it comes: the order of completions, which set most of the spread
between seeds when the seed permuted the sizes, is the same in every run.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterator, Tuple

import numpy as np

from common import sub_seed

# the seed of the one order in which every run of a mix sends its sizes
ORDER = 20240521


def quantile_sizes(dist: Dict, n: int) -> np.ndarray:
    """``n`` sizes at the quantiles (i + 1/2) / n of ``dist``: lognormal
    (``median``, ``sigma``) or uniform (integers ``min``..``max``);
    clipped to [``min``, ``max``] where given."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        v = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    elif kind == "uniform":
        v = dist["min"] + np.floor(u * (dist["max"] - dist["min"] + 1))
    else:
        raise ValueError(f"unknown size distribution {kind!r}")
    lo, hi = dist.get("min", 1), dist.get("max", math.inf)
    return np.clip(v, lo, hi).astype(np.int64)


class RequestStream:
    """The requests of a serving mix, in the order they are sent: prompts
    of random ids drawn from the seed (unshared) and output budgets, the
    sizes a pool of ``pool`` quantiles in the mix's fixed order.  With
    ``first_output`` "residual", each request of the backlog gets a
    budget of a stratified fraction of its output length, as if the load
    had been running before the benchmark joined it, so that completions
    are spread from the first tick."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        self.vocab = vocab
        self.rng = np.random.default_rng(sub_seed(seed, 2))
        order = np.random.default_rng(ORDER)
        n = traffic["pool"]
        self.prompts = order.permutation(
            quantile_sizes(traffic["prompt"], n))
        self.outputs = order.permutation(
            quantile_sizes(traffic["output"], n))
        c = traffic["backlog"]
        frac = order.permutation((np.arange(c) + 0.5) / max(1, c))
        self._first = list(frac) if traffic.get("first_output") \
            == "residual" else []
        self.i = 0

    def next(self) -> Tuple[np.ndarray, int]:
        """(prompt ids (S,) int32, output budget)."""
        k = self.i % len(self.prompts)
        self.i += 1
        prompt = self.rng.integers(0, self.vocab, int(self.prompts[k]),
                                   dtype=np.int32)
        out = int(self.outputs[k])
        if self._first:
            out = max(1, math.ceil(out * self._first.pop()))
        return prompt, out


def token_batches(job: Dict, vocab: int, seed: int, device
                  ) -> Iterator[Dict]:
    """A training job's batches, step after step: ``batch`` rows of
    ``seq_len`` + 1 ids drawn on ``device`` from the seed, as tokens and
    next-token labels.  ``ids``: ``power``, floor((V - 1) u^exponent), a
    Zipf-like marginal."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 3))
    B, S = job["batch"], job["seq_len"]
    ids = job["ids"]
    if ids["dist"] != "power":
        raise ValueError(f"unknown id distribution {ids['dist']!r}")
    while True:
        u = torch.rand((B, S + 1), generator=gen, device=device)
        u = u ** ids["exponent"]
        toks = ((vocab - 1) * u).to(torch.int32)
        yield {"tokens": toks[:, :-1].contiguous(),
               "labels": toks[:, 1:].contiguous()}
