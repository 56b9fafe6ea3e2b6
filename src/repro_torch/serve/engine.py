"""Serving engines — port of ``repro/serve/engine.py``: ``ServingEngine``
(whole-batch lockstep generation) and ``PagedEngine`` (paged continuous
batching: the prefill lane, prefill-by-decode and speculative
draft-and-verify).

``ServingEngine`` prefills every prompt at once (right-aligned, pad 0,
and — as in the JAX package — no pad mask) and decodes all sequences in
lockstep: fused (``Model.decode_many``, sampling on the device) or as the
legacy loop with a host round trip per token.  For the dense family the
prefill runs the flash kernel and its K/V go into a fresh (L, B, S + new,
KV, hd) cache, which the dense decode kernel reads; for the SSM family
(falcon-mamba) the prefill runs the selective-scan kernel and every
layer's state after the prompt goes into the fresh (conv, ssm) cache;
for the hybrid (zamba2) both: the shared block's flash K/V, one cache per
application, and every Mamba2 layer's state.  It refuses the
stub-frontend archs (qwen2-vl, whisper), whose prompts are a frontend's
embeddings, not tokens.

``PagedEngine``: each tick: admit queued requests into free slots, let the
``TickScheduler`` grant per-slot work over the ``PagedKVCache``, patch the
device copies of the block table and lengths at the rows that changed,
then run at most two steps on the device — one ragged prefill chunk
(``Model.prefill_many_paged``) for slots with prompt left, and the decode
loop (``Model.decode_many_paged``, up to ``prefill_chunk`` steps under
the per-slot grants) for generating slots — and do the request bookkeeping on
the host.  The JAX package's donated ``jax.jit`` cells become in-place
torch calls on the engine's device (the device of the parameters).  It
serves decoder-only attention LMs only (qwen2-vl's text prompts among
them), and refuses the SSM, hybrid and encoder-decoder families as the
JAX package's ``PagedEngine`` does.

With ``prefill_lane=False`` there is no lane: prompts ride the decode
loop as forced tokens, one step per prompt token (prefill-by-decode); a
tick without a prompt in flight builds and uploads no forced arrays.

With ``spec_k > 0`` (greedy only) a draft model with its own page pool
proposes up to k tokens per granted slot in one forced-token decode call
(a slot the draft has not caught up with first replays its history
through the draft's prefill lane), and the target verifies the ragged
[feed, p_1 .. p_k] block in one prefill-lane call that unembeds every
position; a proposal is kept iff it equals the target's argmax there,
so the output is plain greedy decode's while a tick emits up to k + 1
tokens a slot.  Rejected rows roll back by truncating the lengths of
both pools.

A request whose prompt starts with tokens already resident in a live
slot's pages shares those pages on admission (found through a rolling-hash
prefix index), and with retention on, a finished slot's page-aligned
prefix stays adoptable after the slot is gone (``PagedKVCache``'s retained
pool) — the JAX engine's defaults, ``prefix_sharing`` and
``retain_prefixes``.

Overload is handled as in the JAX engine: ``submit`` rejects a request
that can never fit (``max_blocks``, the pool) or arrives past
``max_queue``; a request may carry a tick deadline; ``cancel`` ends a
queued or running one; and a tick where no slot can get step capacity
preempts a victim (``TickScheduler.pick_victim``), which requeues at the
front with its emitted output and recomputes it through the prefill lane
(``PREEMPTED_RESUMED``).  A seeded ``FaultPlan`` (``serve/faults.py``)
injects pool squeezes, forced evictions, dropped grants and poisoned
tokens; an always-on guard quarantines a slot that samples a token outside
the vocabulary.  int8 pools ride the tick with their scale pools.  Under
``trace_ticks`` each tick that runs device work records its host time
(``host_ms_trace``: wall time less the waits for the device, which are
its uploads and reads back; ``wait_ms_trace``: those waits), its device
calls (``dispatch_trace``) and its upload bytes (``upload_trace``), and
in speculative mode its draft and verify calls.

While the span recorder is on (``repro_torch.spans``: a live
``torch.profiler`` session, or ``spans.recording()``) a tick is an
``engine.tick`` span with its phases and waits as children, and each
request's way to its first token (``Request.t_*``, always kept) is
recorded as ``request.queued`` and ``request.prefill`` spans.

With ``snapshot_every_ticks > 0`` and a ``snapshot_dir`` the engine
writes its whole state at the end of every n-th tick, idle ticks too
(``serve/snapshot.py``, pruned to ``snapshot_keep`` files); after a
``kill`` fault a fresh engine on the same weights restores the newest
snapshot (``snapshot.restore_engine``) and serves on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.models.model import Model, sample_token
from repro_torch.models.transformer import check_supported
from repro_torch.serve.cache import PagedKVCache, digest_step
from repro_torch.serve.faults import EngineKilled
from repro_torch.serve.scheduler import TickScheduler


@dataclasses.dataclass
class ServeConfig:
    """The JAX package's ``ServeConfig``, field for field, with its
    defaults, which ``PagedEngine`` serves as they are (prefix sharing,
    retention and preemption on)."""
    max_batch: int = 4
    max_seq: int = 128
    max_new_tokens: int = 16
    temperature: float = 0.0          # 0 = greedy
    seed: int = 0
    eos_id: int = -1                  # < 0: no stop condition
    pad_id: int = 0
    fused: bool = True                # ServingEngine: decode_many vs the
                                      # per-token loop
    page_size: int = 16
    max_blocks: int = 0               # 0: ceil(max_seq / page_size)
    num_pages: int = 0                # 0: fit every slot's full table
    prefill_chunk: int = 4            # decode steps per tick
    prefill_lane: bool = True
    prefill_chunk_tokens: int = 0     # 0: ArchConfig's, then 2 x page_size
    prefix_sharing: bool = True
    share_min_tokens: int = 1
    retain_prefixes: bool = True
    retain_pool_pages: int = 0
    retain_policy: str = "lru"
    fairness: str = "least-served"
    tick_budget: int = 0
    trace_pool: bool = True
    trace_ticks: bool = True
    preempt: bool = True
    preempt_policy: str = "fewest-tokens"
    max_queue: int = 0
    deadline_ticks: int = 0
    quarantine_ticks: int = 2
    wedge_ticks: int = 10_000
    snapshot_every_ticks: int = 0
    snapshot_dir: str = ""
    snapshot_keep: int = 2
    spec_k: int = 0


class RequestStatus(enum.Enum):
    """Request lifecycle: every submitted rid ends in a terminal status."""
    QUEUED = "queued"                  # waiting for a slot (incl. requeued)
    RUNNING = "running"
    FINISHED = "finished"              # completed, never preempted
    PREEMPTED_RESUMED = "preempted_resumed"  # completed after a preemption
    REJECTED = "rejected"              # failed admission at submit()
    CANCELLED = "cancelled"            # cancel(); partial output kept
    DEADLINE_EXCEEDED = "deadline_exceeded"  # partial output kept


TERMINAL_STATUSES = frozenset({
    RequestStatus.FINISHED, RequestStatus.PREEMPTED_RESUMED,
    RequestStatus.REJECTED, RequestStatus.CANCELLED,
    RequestStatus.DEADLINE_EXCEEDED})


@dataclasses.dataclass
class Request:
    """One submitted request.  ``prompt`` never changes; ``emitted``
    gathers the output across preemptions (replayed as prompt on
    re-admission); ``max_new_tokens`` is the total output budget.  The
    ``t_*`` fields are its lifecycle on this process's
    ``time.perf_counter``, None until the event (and after a restore:
    snapshots leave them out)."""
    rid: int
    prompt: np.ndarray                # (S,) int32
    max_new_tokens: int
    deadline_tick: int = -1           # absolute engine tick; -1 = none
    emitted: List[int] = dataclasses.field(default_factory=list)
    preempts: int = 0                 # times this request lost its slot
    t_queued: Optional[float] = None  # when it last joined the queue
    t_admit: Optional[float] = None   # its first admission
    t_first: Optional[float] = None   # its first output token


@dataclasses.dataclass
class _Slot:
    """One schedulable slot: ``forced`` holds the prompt tokens queued
    behind the feed token; ``prompt_left`` counts prompt tokens not yet
    appended (the scheduler's lane selector); ``history`` the tokens whose
    K/V rows are resident in the slot's pages (``len(history) ==
    kv.length[i]``; the donor index reads it); ``served`` counts tokens
    appended (the fairness key)."""
    rid: int = -1
    forced: List[int] = dataclasses.field(default_factory=list)
    out: List[int] = dataclasses.field(default_factory=list)
    history: List[int] = dataclasses.field(default_factory=list)
    budget: int = 0
    served: int = 0
    prompt_left: int = 0
    active: bool = False


class ServingEngine:
    """Whole-batch greedy/temperature generation over a shared batched KV
    cache (see the module docstring).  The JAX engine's donated ``jit``
    cells become direct calls that update the cache in place; its sampler
    key becomes one ``torch.Generator`` on the parameters' device, seeded
    from ``cfg.seed`` and carried across calls."""

    def __init__(self, model: Model, params, cfg: ServeConfig):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_token(logits, self.generator, self.cfg.temperature)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill_cache(self, prompts: List[np.ndarray], mnt: int):
        """Right-aligns the prompts to a common length S with pad 0 (no pad
        mask, as in the JAX package), prefills once, and copies the cache
        parts into a fresh decode cache of S + mnt rows: the prefill K/V,
        for the SSM family every layer's (conv, ssm) state after the
        prompt, pads included, and for the hybrid both: each shared-block
        application's K/V and every layer's state.  The JAX engine gets
        no SSM cache parts from its prefill and decodes from a zero state,
        as if the prompt had never been seen; its own ``lm_decode``
        stepped over the prompt gives the state used here.  A
        stub-frontend arch is refused by name: its prefill reads a
        frontend's embeddings or frames, which token prompts do not give
        (the JAX engine fails here with a ``KeyError`` on the missing
        input)."""
        mcfg = self.model.cfg
        if not mcfg.embed_inputs:
            what = ("frames and decoder tokens" if mcfg.is_encoder_decoder
                    else "precomputed embeddings")
            raise ValueError(
                f"ServingEngine prefills token prompts, and {mcfg.name} is a "
                f"stub-frontend arch whose prefill reads {what} from a "
                f"frontend the repo does not have.  Call Model.prefill with "
                f"them, then Model.decode_step / decode_many"
                + ("" if mcfg.is_encoder_decoder else
                   ", or serve text prompts through PagedEngine"))
        B = len(prompts)
        S = max(len(p) for p in prompts)
        toks = np.zeros((B, S), np.int32)
        for i, p in enumerate(prompts):            # right-align
            toks[i, S - len(p):] = p
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        last_logits, cache_parts = self.model.prefill(self.params, batch)
        cache = self.model.init_cache(B, S + mnt, self.device)
        for k, src in (cache_parts or {}).items():
            cache[k][tuple(slice(0, n) for n in src.shape)] = src.to(
                cache[k].dtype)
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=self.device)
        return last_logits, cache

    def generate_batch(self, prompts: List[np.ndarray],
                       max_new_tokens: Optional[int] = None,
                       fused: Optional[bool] = None) -> List[List[int]]:
        """Prefill once, then decode all sequences in lockstep.  ``fused``
        (default ``cfg.fused``) runs the token loop with sampling on the
        device and one read back at the end; ``fused=False`` is the legacy
        loop, reading every token back to the host (same tokens)."""
        cfg = self.cfg
        mnt = max_new_tokens or cfg.max_new_tokens
        fused = cfg.fused if fused is None else fused
        B = len(prompts)

        last_logits, cache = self._prefill_cache(prompts, mnt)
        first = self._sample(last_logits)
        if fused:
            toks, cache, _done = self.model.decode_many(
                self.params, first[:, None], cache, self.generator,
                num_steps=mnt - 1, temperature=cfg.temperature,
                eos_id=cfg.eos_id, pad_id=cfg.pad_id)
            all_toks = torch.cat([first[None], toks]).cpu().numpy()
        else:
            tok = first[:, None]
            rows = [first.cpu().numpy()]
            for _ in range(mnt - 1):
                logits, cache = self.model.decode_step(self.params, tok,
                                                       cache)
                t = self._sample(logits)
                tok = t[:, None]
                rows.append(t.cpu().numpy())       # per-token host sync
            all_toks = np.stack(rows, axis=0)

        outs: List[List[int]] = []
        for i in range(B):
            col = [int(t) for t in all_toks[:, i]]
            if cfg.eos_id >= 0 and cfg.eos_id in col:
                col = col[: col.index(cfg.eos_id) + 1]
            outs.append(col)
        return outs

    def benchmark_decode(self, batch: int, seq: int, steps: int = 8
                         ) -> Dict[str, float]:
        """Host-clock decode throughput on the engine's device: the fused
        loop against the legacy per-step loop, each from a fresh cache at
        position seq // 2, after one warm-up call."""
        assert seq // 2 + 2 * steps + 2 <= seq, \
            f"steps={steps} overruns the cache (seq={seq})"

        def fresh_cache():
            cache = self.model.init_cache(batch, seq, self.device)
            cache["pos"] = torch.tensor(seq // 2, dtype=torch.int32,
                                        device=self.device)
            return cache

        tok0 = torch.zeros((batch, 1), dtype=torch.int32, device=self.device)

        # legacy: one step + argmax + host read per token
        cache = fresh_cache()
        logits, cache = self.model.decode_step(self.params, tok0, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        self._sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = self.model.decode_step(self.params, tok, cache)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            tok.cpu()                              # the per-token round trip
        dt_loop = (time.perf_counter() - t0) / steps

        # fused: the whole token loop, read back once
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed)
        cache = fresh_cache()
        toks, cache, _ = self.model.decode_many(self.params, tok0, cache, gen,
                                                num_steps=steps)
        self._sync()
        t0 = time.perf_counter()
        toks, cache, _ = self.model.decode_many(self.params, tok0, cache, gen,
                                                num_steps=steps)
        self._sync()
        dt_fused = (time.perf_counter() - t0) / steps

        return {
            "s_per_step": dt_fused,
            "tokens_per_s": batch / dt_fused,
            "s_per_step_fused": dt_fused,
            "tokens_per_s_fused": batch / dt_fused,
            "s_per_step_loop": dt_loop,
            "tokens_per_s_loop": batch / dt_loop,
            "fused_speedup": dt_loop / dt_fused,
        }


def _lcp(a: List[int], b: List[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class _PrefixIndex:
    """Rolling-hash index over every live slot's token-history prefixes:
    each slot registers the digest of history[:n] for every n (extended a
    few keys per appended token), and a lookup walks the prompt's own
    digest outward, stopping at the first length no slot matches — a
    prompt that shares nothing costs one probe.  The engine verifies the
    winner against the real history and falls back to an exact scan on a
    collision.  The digest is the retained pool's (``digest_step``), so a
    prefix hashes the same whether its donor is live or gone."""

    def __init__(self):
        self._map: Dict[tuple, set] = {}      # (n, digest) -> slot ids
        self._keys: Dict[int, List[tuple]] = {}
        self._digest: Dict[int, int] = {}
        self._len: Dict[int, int] = {}

    def add(self, slot: int, tokens) -> None:
        """Extend the slot's indexed history by ``tokens``."""
        h = self._digest.get(slot, 0)
        n = self._len.get(slot, 0)
        keys = self._keys.setdefault(slot, [])
        for t in tokens:
            h = digest_step(h, t)
            n += 1
            key = (n, h)
            self._map.setdefault(key, set()).add(slot)
            keys.append(key)
        self._digest[slot] = h
        self._len[slot] = n

    def drop(self, slot: int) -> None:
        for key in self._keys.pop(slot, ()):
            owners = self._map.get(key)
            if owners is not None:
                owners.discard(slot)
                if not owners:
                    del self._map[key]
        self._digest.pop(slot, None)
        self._len.pop(slot, None)

    def lookup(self, prompt: List[int], cap: int):
        """Longest n <= cap with a live slot whose indexed history starts
        with prompt[:n]; returns (slot, n) or (-1, 0)."""
        h, best, donor = 0, 0, -1
        for n in range(1, cap + 1):
            h = digest_step(h, prompt[n - 1])
            owners = self._map.get((n, h))
            if not owners:
                break
            best, donor = n, next(iter(owners))
        return donor, best

    def check(self, slots) -> None:
        """Every indexed slot is live, its indexed length equals its
        history, its digest chain recomputes from that history, and every
        key's owner set round-trips."""
        for slot_id, n in self._len.items():
            s = slots[slot_id]
            assert s.active, \
                f"prefix index holds entries for inactive slot {slot_id}"
            assert n == len(s.history), \
                f"slot {slot_id}: indexed length {n} != history " \
                f"{len(s.history)}"
            h = 0
            keys = self._keys.get(slot_id, [])
            assert len(keys) == n, \
                f"slot {slot_id}: {len(keys)} keys for {n} indexed tokens"
            for j, t in enumerate(s.history):
                h = digest_step(h, t)
                assert keys[j] == (j + 1, h), \
                    f"slot {slot_id}: key {j} drifted from history"
                assert slot_id in self._map.get((j + 1, h), ()), \
                    f"slot {slot_id}: key {(j + 1, h)} unregistered"
            assert self._digest.get(slot_id, 0) == h, \
                f"slot {slot_id}: digest accumulator drifted"
        for key, owners in self._map.items():
            assert owners, f"empty owner set left behind for {key}"
            for s_id in owners:
                assert s_id in self._len and self._len[s_id] >= key[0], \
                    f"key {key} names slot {s_id} beyond its indexed length"


class PagedEngine:
    """Non-lockstep continuous batching over the paged KV cache (see the
    module docstring).  Every slot advances at its own position on its
    own pages, so a request admitted mid-flight starts at position 0 and
    its greedy output equals a fresh single-request run; a shared or
    adopted prefix references the same K/V rows a fresh run would write,
    and a preempted request replays its prompt and emitted output through
    the prefill lane, so neither sharing nor preemption changes the
    tokens in f32 (in bf16 the recomputed rows round as a prefill chunk
    rounds, not as the decode steps that first wrote them).  Without the
    lane the prompts, and a resumed request's replay, go through the
    decode loop as forced tokens.  With ``spec_k > 0`` the decode ticks
    are speculative (``_spec_decode``, ``_spec_bookkeep``): the output
    is greedy decode's, a tick emits up to spec_k + 1 tokens a slot, and
    deadlines still count ticks."""

    def __init__(self, model: Model, params, cfg: ServeConfig,
                 draft_model: Optional[Model] = None, draft_params=None):
        self.model = model
        self.params = params
        self.cfg = cfg
        B = cfg.max_batch
        check_supported(model.cfg, paged=True)
        self._spec = cfg.spec_k > 0
        if self._spec:                   # the JAX engine's contract
            if draft_model is None:
                raise ValueError(
                    "spec_k > 0 needs a draft model: "
                    "PagedEngine(model, params, cfg, draft_model=, "
                    "draft_params=)")
            if cfg.temperature != 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only: a proposal is "
                    "accepted iff it equals the target argmax "
                    "(set temperature=0)")
            if not cfg.prefill_lane:
                raise ValueError(
                    "speculative decoding verifies through the ragged "
                    "prefill lane (set prefill_lane=True)")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    "draft and target must share a tokenizer: vocab "
                    f"{draft_model.cfg.vocab_size} != "
                    f"{model.cfg.vocab_size}")
        self.draft_model = draft_model
        self.draft_params = draft_params
        self.device = params["embed"].device
        # decode steps per tick; a speculative tick verifies the feed
        # token and up to spec_k proposals in one ragged call
        self._chunk = cfg.spec_k + 1 if self._spec \
            else max(1, cfg.prefill_chunk)
        # prompt tokens per prefill-lane chunk; 0: no lane, prompts go
        # through the decode loop as forced tokens
        self._chunk_tokens = 0
        if cfg.prefill_lane:
            self._chunk_tokens = (cfg.prefill_chunk_tokens
                                  or model.cfg.prefill_chunk_tokens
                                  or 2 * cfg.page_size)
        # retention rides the sharing machinery: without prefix_sharing
        # nothing could ever adopt a retained page
        self._retain = bool(cfg.prefix_sharing and cfg.retain_prefixes)
        self.kv = PagedKVCache(model, B, cfg.max_seq,
                               page_size=cfg.page_size,
                               max_blocks=cfg.max_blocks,
                               num_pages=cfg.num_pages,
                               retain=self._retain,
                               retain_cap=cfg.retain_pool_pages,
                               retain_policy=cfg.retain_policy,
                               device=self.device)
        # device copies of the block table and lengths, patched at the
        # rows the cache marks dirty (admission, share, adoption, COW,
        # eviction, defrag)
        self._table_dev = torch.zeros((B, self.kv.max_blocks),
                                      dtype=torch.int32, device=self.device)
        self._length_dev = torch.zeros((B,), dtype=torch.int32,
                                       device=self.device)
        self.kv.dirty.clear()            # mirrors start in sync (all zero)
        # the draft's own page pool (speculation): no sharing and no
        # retention; rejected rows roll back by length, a preempted slot
        # rebuilds by catch-up
        self.dkv: Optional[PagedKVCache] = None
        if self._spec:
            self.dkv = PagedKVCache(draft_model, B, cfg.max_seq,
                                    page_size=cfg.page_size,
                                    max_blocks=cfg.max_blocks,
                                    num_pages=cfg.num_pages,
                                    device=self.device)
            self._dtable_dev = torch.zeros((B, self.dkv.max_blocks),
                                           dtype=torch.int32,
                                           device=self.device)
            self._dlength_dev = torch.zeros((B,), dtype=torch.int32,
                                            device=self.device)
            self.dkv.dirty.clear()
            self._dgen = torch.Generator(device=self.device)
            self._dgen.manual_seed(cfg.seed + 1)
        self._pindex = _PrefixIndex()
        self.scheduler = TickScheduler(fairness=cfg.fairness,
                                       tick_budget=cfg.tick_budget,
                                       preempt_policy=cfg.preempt_policy)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.slots = [_Slot() for _ in range(B)]
        self.queue: List[Request] = []
        self.results: Dict[int, List[int]] = {}
        self._reqs: Dict[int, Request] = {}
        self.status: Dict[int, RequestStatus] = {}
        self.reject_reason: Dict[int, str] = {}
        self._feed = np.full((B,), cfg.pad_id, np.int32)
        self._next_rid = 0
        self.ticks = 0                    # step() calls, idle ones too
                                          # (the deadline and fault clock)
        self.steps_run = 0                # ticks that ran device work
        self._idle = 0                    # consecutive no-work busy ticks
        self.no_progress_ticks = 0        # all no-work busy ticks
        self.joins = 0
        self.rejected = 0
        self.preemptions = 0              # capacity preemptions + evictions
        self.recompute_tokens = 0         # tokens re-appended on resume
        self.cancelled = 0
        self.deadline_exceeded = 0
        self.quarantines = 0              # poison-triggered requeues
        self.dropped_grants = 0           # granted tokens a fault dropped
        self.fault_counts: Dict[str, int] = {}
        self._quarantined: Dict[int, int] = {}  # slot -> usable-again tick
        self._squeezed: List[Tuple[int, List[int]]] = []  # (release, pages)
        self._faults = None               # the armed FaultPlan
        self._drop_slots: Set[int] = set()
        self._poison_slots: Set[int] = set()
        self.stalls = 0
        self.tokens_out = 0               # kept output tokens
        self.shared_tokens = 0            # prompt tokens served by reference
        self.tokens_appended = 0          # fresh K/V rows written
        self.spec_proposed = 0            # draft tokens offered to verify
        self.spec_accepted = 0            # proposals the target accepted
        self.spec_trunc_tokens = 0        # target K/V rows rolled back
        self.draft_dispatches = 0         # draft catch-up + propose calls
        self.verify_dispatches = 0        # target verify calls
        self.draft_dispatch_trace: List[int] = []   # per busy tick
        self.verify_dispatch_trace: List[int] = []
        self.util_trace: List[float] = []        # per-tick page utilization
        self.occupancy_trace: List[float] = []   # per-tick row occupancy
        # host-to-device bytes: dirty table/length rows, forced-token
        # arrays (prefill-by-decode only), prefill-lane token blocks and
        # grants, and all of a tick's uploads
        self.table_upload_bytes = 0
        self.forced_upload_bytes = 0
        self.prefill_upload_bytes = 0
        self.upload_bytes = 0
        self.host_ms_trace: List[float] = []     # host work per busy tick
        self.wait_ms_trace: List[float] = []     # its waits for the device
        self.dispatch_trace: List[int] = []      # device calls per busy tick
        self.upload_trace: List[int] = []        # bytes uploaded per tick
        self.snapshots_written = 0
        self._last_snapshot_tick = -1     # one snapshot per tick at most
        self._wait_s = 0.0                # the tick's waits so far (s)

    # -- request lifecycle ----------------------------------------------

    def _admissible(self, prompt: np.ndarray, mnt: int) -> Optional[str]:
        """None if the request can complete on this engine, otherwise the
        reason it is rejected."""
        total = int(prompt.size) + mnt
        blocks = -(-total // self.kv.page)
        if blocks > self.kv.max_blocks:
            return (f"prompt+output needs {blocks} blocks > max_blocks="
                    f"{self.kv.max_blocks} (max_seq={self.cfg.max_seq})")
        if blocks > self.kv.num_pages - 1:
            return (f"prompt+output needs {blocks} blocks > pool of "
                    f"{self.kv.num_pages - 1} allocatable pages")
        if self.cfg.max_queue > 0 and len(self.queue) >= self.cfg.max_queue:
            return f"queue full ({self.cfg.max_queue} requests waiting)"
        return None

    def submit(self, prompt: np.ndarray,
               max_new_tokens: Optional[int] = None,
               deadline_ticks: Optional[int] = None) -> int:
        """Queue a request.  One that can never fit a slot's block table
        or the page pool, or arrives while ``max_queue`` requests wait,
        gets a ``REJECTED`` status (reason in ``reject_reason[rid]``).
        ``deadline_ticks`` (default ``cfg.deadline_ticks``; 0 = none)
        bounds the engine ticks the request may stay live."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt: a slot needs at least one "
                             "token to feed the decode step")
        rid = self._next_rid
        self._next_rid += 1
        mnt = max_new_tokens or self.cfg.max_new_tokens
        reason = self._admissible(prompt, mnt)
        if reason is not None:
            self.status[rid] = RequestStatus.REJECTED
            self.reject_reason[rid] = reason
            self.results[rid] = []
            self.rejected += 1
            return rid
        dl = self.cfg.deadline_ticks if deadline_ticks is None \
            else deadline_ticks
        req = Request(rid, prompt, mnt,
                      deadline_tick=self.ticks + dl if dl > 0 else -1,
                      t_queued=time.perf_counter())
        self._reqs[rid] = req
        self.status[rid] = RequestStatus.QUEUED
        self.queue.append(req)
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request: its partial output stays in
        ``results[rid]``, its slot and pages are released.  False if the
        rid is unknown or already terminal."""
        st = self.status.get(rid)
        if st is None or st in TERMINAL_STATUSES:
            return False
        req = self._reqs[rid]
        if st is RequestStatus.QUEUED:
            self.queue.remove(req)
        else:
            i = next((j for j, s in enumerate(self.slots)
                      if s.active and s.rid == rid), -1)
            if i >= 0:
                req.emitted.extend(self.slots[i].out)
                self._release_slot(i)
        self.results[rid] = list(req.emitted)
        self.status[rid] = RequestStatus.CANCELLED
        self.cancelled += 1
        return True

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s.active for s in self.slots)

    def run(self) -> Dict[int, List[int]]:
        """Drain queue and slots; returns {rid: generated tokens}."""
        while self.busy:
            self.step()
        return self.results

    # -- fault injection ------------------------------------------------

    def install_faults(self, plan) -> None:
        """Arm a ``FaultPlan``; its events fire at the top of their tick.
        Squeezed pages go back when their duration ends (idle ticks
        included).  A ``kill`` raises ``EngineKilled`` before the tick
        changes any state; the caller recovers by restoring the newest
        snapshot into a fresh engine (``snapshot.restore_engine``) and
        arming ``plan.without_kills_through(tick)`` on it."""
        self._faults = plan

    def _apply_faults(self) -> None:
        now = self.ticks
        if self._squeezed:                # releases first: a squeeze never
            keep = []                     # outlives its duration
            for until, pages in self._squeezed:
                if until <= now:
                    self.kv.release_pages(pages)
                else:
                    keep.append((until, pages))
            self._squeezed = keep
        if self._faults is None:
            return
        events = self._faults.events_at(now)
        for ev in events:
            if ev.kind == "kill":         # process death: no state advanced
                self.fault_counts["kill"] = \
                    self.fault_counts.get("kill", 0) + 1
                raise EngineKilled(now)
        for ev in events:
            self.fault_counts[ev.kind] = self.fault_counts.get(ev.kind, 0) + 1
            if ev.kind == "squeeze":      # pool pressure
                pages = self.kv.seize_pages(ev.pages)
                if pages:
                    self._squeezed.append((now + max(1, ev.duration), pages))
            elif ev.kind == "evict":      # forced eviction -> requeue
                i = ev.slot
                if not (0 <= i < len(self.slots) and self.slots[i].active):
                    i = next((j for j, s in enumerate(self.slots)
                              if s.active), -1)
                if i >= 0:
                    self._preempt(i)
            elif ev.kind == "drop":       # this tick's grant vanishes
                self._drop_slots.update(
                    range(len(self.slots)) if ev.slot < 0 else (ev.slot,))
            elif ev.kind == "poison":     # sampled tokens out of vocabulary
                self._poison_slots.update(
                    range(len(self.slots)) if ev.slot < 0 else (ev.slot,))

    # -- admission, preemption, expiry ------------------------------------

    def _find_donor(self, prompt: List[int]):
        """Longest common prefix of ``prompt`` with (a) a live slot's
        history, through the prefix index, and (b) the retained pool (the
        same digests, ``kv.match_retained``).  Returns (kind, ref,
        n_shared): kind "live" (ref = slot index), "retained" (ref = the
        entry) or None when nothing reaches ``share_min_tokens``.  A live
        match wins ties.  The cap at ``len(prompt) - 1`` keeps the last
        prompt token fed: its logits give the first output."""
        cap = len(prompt) - 1
        donor, best = self._pindex.lookup(prompt, cap)
        if donor >= 0 and not (self.slots[donor].active
                               and self.slots[donor].history[:best]
                               == prompt[:best]):
            # digest collision (or index drift): exact-scan fallback
            best, donor = 0, -1
            for j, s in enumerate(self.slots):
                if not s.active:
                    continue
                n = min(_lcp(prompt, s.history), cap)
                if n > best:
                    best, donor = n, j
        entry, n_ret = (None, 0)
        if self._retain:
            entry, n_ret = self.kv.match_retained(prompt, cap)
        min_share = max(1, self.cfg.share_min_tokens)
        if best >= n_ret and best >= min_share:
            return "live", donor, best
        if entry is not None and n_ret >= min_share:
            return "retained", entry, n_ret
        return None, None, 0

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            if self._quarantined.get(i, 0) > self.ticks:
                continue                   # a poisoned slot sits out
            head = self.queue[0]
            # a resumed request replays its emitted output as prompt
            prompt = [int(t) for t in head.prompt] + list(head.emitted)
            kind, ref, n_shared = (None, None, 0)
            if self.cfg.prefix_sharing:
                kind, ref, n_shared = self._find_donor(prompt)
            if n_shared == 0 and self.kv.allocatable == 0:
                break                      # pool dry: wait for eviction
            req = self.queue.pop(0)
            if kind == "live":
                self.kv.share(i, ref, n_shared)
                self.shared_tokens += n_shared
            elif kind == "retained":       # the donor is gone, its pages
                self.kv.adopt_retained(i, ref, n_shared)    # are not
                self.shared_tokens += n_shared
            self.kv.ensure(i, n_shared + 1)
            self.slots[i] = _Slot(rid=req.rid, forced=prompt[n_shared + 1:],
                                  out=[], history=prompt[:n_shared],
                                  budget=req.max_new_tokens
                                  - len(req.emitted),
                                  prompt_left=len(prompt) - n_shared,
                                  active=True)
            if self.cfg.prefix_sharing:
                self._pindex.add(i, prompt[:n_shared])
            self._feed[i] = prompt[n_shared]
            self.status[req.rid] = RequestStatus.RUNNING
            self._admitted(req)
            if req.preempts:               # shared tokens cost nothing
                self.recompute_tokens += len(prompt) - n_shared
            self.joins += 1

    def _release_slot(self, i: int) -> None:
        """Return slot ``i`` to the pool: its prefix index entries dropped,
        its pages freed refcount-aware (a shared page stays for its other
        referents) and, with retention on, its history's page-aligned
        prefix kept in the retained pool (a preempted victim's resume
        adopts it)."""
        history = self.slots[i].history
        self.slots[i] = _Slot()
        self._feed[i] = self.cfg.pad_id
        self._pindex.drop(i)
        self.kv.free_slot(i, retain_tokens=history if self._retain else None)
        if self.dkv is not None:          # draft pages never retain
            self.dkv.free_slot(i)

    def _preempt(self, i: int, quarantine: bool = False) -> None:
        """Evict slot ``i`` and requeue its request at the front with its
        output so far; on re-admission that output is replayed through
        the prefill lane.  ``quarantine``: the slot sat out a poisoned
        tick and stays empty for ``cfg.quarantine_ticks``."""
        slot = self.slots[i]
        req = self._reqs[slot.rid]
        req.emitted.extend(slot.out)
        req.preempts += 1
        req.t_queued = time.perf_counter()
        self.status[req.rid] = RequestStatus.QUEUED
        self.queue.insert(0, req)
        self._release_slot(i)
        if quarantine:
            self._quarantined[i] = self.ticks \
                + max(1, self.cfg.quarantine_ticks)
            self.quarantines += 1
        else:
            self.preemptions += 1

    def _preempt_for_capacity(self) -> bool:
        """Preempt one victim when no slot can get step capacity.  Needs
        two active slots: a lone stuck slot only happens under a fault
        squeeze, whose pages come back on schedule."""
        active = [i for i, s in enumerate(self.slots) if s.active]
        if len(active) < 2:
            return False
        gen = {i: len(self._reqs[self.slots[i].rid].emitted)
               + len(self.slots[i].out) for i in active}
        victim = self.scheduler.pick_victim(self.slots, self.kv,
                                            generated=gen)
        if victim < 0:
            return False
        self._preempt(victim)
        return True

    def _expire_deadlines(self) -> None:
        """Requests past their deadline end ``DEADLINE_EXCEEDED`` with the
        output they have, queued and running alike."""
        now = self.ticks
        for req in [r for r in self.queue if 0 <= r.deadline_tick < now]:
            self.queue.remove(req)
            self.results[req.rid] = list(req.emitted)
            self.status[req.rid] = RequestStatus.DEADLINE_EXCEEDED
            self.deadline_exceeded += 1
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            req = self._reqs[slot.rid]
            if 0 <= req.deadline_tick < now:
                req.emitted.extend(slot.out)
                self.results[req.rid] = list(req.emitted)
                self.status[req.rid] = RequestStatus.DEADLINE_EXCEEDED
                self.deadline_exceeded += 1
                self._release_slot(i)

    def _finish(self, i: int) -> None:
        slot = self.slots[i]
        req = self._reqs[slot.rid]
        self.results[slot.rid] = req.emitted + slot.out
        self.status[slot.rid] = (RequestStatus.PREEMPTED_RESUMED
                                 if req.preempts else RequestStatus.FINISHED)
        self._release_slot(i)

    # -- request spans ----------------------------------------------------

    @staticmethod
    def _lengths(req: Request) -> dict:
        return {"rid": req.rid, "prompt": int(req.prompt.size),
                "budget": req.max_new_tokens}

    def _admitted(self, req: Request) -> None:
        """A (re-)admission: ``request.queued`` from when the request last
        joined the queue, ``resumed`` after a preemption."""
        now = time.perf_counter()
        resumed = req.t_admit is not None
        if not resumed:
            req.t_admit = now
        if req.t_queued is not None:
            spans.record("request.queued", req.t_queued, now,
                         resumed=resumed, **self._lengths(req))

    def _first_token(self, req: Request) -> None:
        """The request's first output token: ``request.prefill`` from its
        first admission."""
        req.t_first = time.perf_counter()
        if req.t_admit is not None:
            spans.record("request.prefill", req.t_admit, req.t_first,
                         **self._lengths(req))

    def defrag(self) -> None:
        """Compact the page pool (``PagedKVCache.defrag``); the next tick
        re-uploads every table row."""
        self.kv.defrag()

    def _sync_dirty(self, kv: PagedKVCache, table_dev, length_dev) -> int:
        """Patch a device table/length pair in place at ``kv``'s dirty
        rows (the target's or the draft's); returns the bytes uploaded,
        counted as the JAX engine counts them, rows x (max_blocks + 1) x
        4, but over the rows really uploaded (the JAX engine pads the row
        batch to a power of two so that its patcher compiles once per
        size; an indexed torch copy needs no padding)."""
        if not kv.dirty:
            return 0
        rows = sorted(kv.dirty)
        kv.dirty.clear()
        with self._wait("engine.upload"):
            idx = torch.tensor(rows, dtype=torch.long, device=self.device)
            table_dev[idx] = torch.from_numpy(kv.table[rows]).to(
                self.device)
            length_dev[idx] = torch.from_numpy(kv.length[rows]).to(
                self.device)
        return len(rows) * (kv.max_blocks + 1) * 4

    # -- speculative decoding -------------------------------------------

    @property
    def accept_rate(self) -> float:
        """Share of the draft's proposals the target accepted (0.0 before
        the first proposal, as the JAX engine computes it)."""
        return self.spec_accepted / max(1, self.spec_proposed)

    def _draft_cache(self) -> dict:
        dkv = self.dkv
        c = {"k": dkv.k, "v": dkv.v, "table": self._dtable_dev,
             "length": self._dlength_dev}
        if dkv.quantized:
            c["k_scale"] = dkv.k_scale
            c["v_scale"] = dkv.v_scale
        return c

    def _draft_writeback(self, c: dict) -> None:
        dkv = self.dkv
        dkv.k, dkv.v = c["k"], c["v"]
        if dkv.quantized:
            dkv.k_scale, dkv.v_scale = c["k_scale"], c["v_scale"]
        self._dlength_dev = c["length"]      # the device advanced it

    def _spec_decode(self, steps, cache):
        """One speculative decode tick over the granted slots, as the JAX
        engine's ``_spec_decode``:

          1. catch-up — a slot whose draft pool lacks more than one
             history token (a fresh admission, a shared prefix, a resume:
             the draft shares nothing, it recomputes) replays the gap
             through the draft's prefill lane in chunks of
             ``max(chunk tokens, chunk)`` until at most one token trails;
             a dry draft pool catches up as far as its pages reach;
          2. propose — one forced-token decode call on the draft: a slot
             one token behind feeds that history token and forces the
             target's feed token in as its step-0 output, so the deficit
             costs no extra call;
          3. one ``.cpu()`` of the proposals: a wait for the device
             (``engine.readback``);
          4. verify — one ragged prefill-lane call on the target over
             [feed, p_1 .. p_k] per slot, draft tokens clamped into the
             vocabulary.

        Returns (greedy, accept, vgr, cache, upload bytes, draft calls):
        ``greedy`` and ``accept`` on the device; ``vgr``
        (B,) the target rows the verify appended, 1 + proposals, which is
        below the planned grant only where the draft pool capped the
        slot."""
        cfg = self.cfg
        B = len(self.slots)
        dkv = self.dkv
        chunk = self._chunk
        dev = self.device
        upload = draft_disp = 0
        rows = [i for i in range(B) if self.slots[i].active and steps[i] > 0]

        # catch-up: stream the missing history through the draft's lane
        Tc = max(self._chunk_tokens, chunk)
        while True:
            cg = np.zeros((B,), np.int32)
            tok_c = np.full((B, Tc), cfg.pad_id, np.int32)
            for i in rows:
                hist = self.slots[i].history
                dlen = int(dkv.length[i])
                miss = len(hist) - dlen
                if miss <= 1:
                    continue
                take = min(miss, Tc)
                if not dkv.ensure(i, dlen + take):
                    # draft pool dry: partial catch-up; the slot verifies
                    # at grant 1 until draft pages free up
                    take = min(take, len(dkv.owned[i]) * dkv.page - dlen)
                if take <= 0:
                    continue
                cg[i] = take
                tok_c[i, :take] = hist[dlen:dlen + take]
            if not cg.any():
                break
            b = self._sync_dirty(dkv, self._dtable_dev, self._dlength_dev)
            upload += b + B * (Tc + 1) * 4
            draft_disp += bool(b) + 1
            with self._wait("engine.upload"):
                tok_c_dev = torch.from_numpy(tok_c).to(dev)
                cg_dev = torch.from_numpy(cg).to(dev)
            _, c = self.draft_model.prefill_many_paged(
                self.draft_params, tok_c_dev, self._draft_cache(),
                self._dgen, cg_dev, temperature=0.0)
            self._draft_writeback(c)
            dkv.length += cg

        # propose: grant = deficit (<= 1) + k proposals per slot
        off = np.zeros((B,), np.int32)
        dgr = np.zeros((B,), np.int32)
        k_prop = np.zeros((B,), np.int32)
        feed_d = np.full((B,), cfg.pad_id, np.int32)
        forced_tok = np.full((chunk, B), cfg.pad_id, np.int32)
        forced_mask = np.zeros((chunk, B), bool)
        for i in rows:
            hist = self.slots[i].history
            d = len(hist) - int(dkv.length[i])
            if d > 1:
                continue                  # still catching up: no proposals
            k = int(steps[i]) - 1
            if k and not dkv.ensure(i, len(hist) + k):
                k = max(0, len(dkv.owned[i]) * dkv.page - len(hist))
            if d == 0 and k == 0:
                continue                  # nothing for the draft to do
            off[i], k_prop[i], dgr[i] = d, k, d + k
            if d:                         # replay the missing history
                feed_d[i] = hist[-1]      # token, force the feed in as
                forced_tok[0, i] = self._feed[i]   # its step-0 output
                forced_mask[0, i] = True
            else:
                feed_d[i] = self._feed[i]
        toks_d = None
        if dgr.any():
            b = self._sync_dirty(dkv, self._dtable_dev, self._dlength_dev)
            # feed, grants, forced tokens and mask: draft-side traffic
            # (forced_upload_bytes counts prompt traffic only)
            upload += b + 2 * B * 4 + chunk * B * (4 + 1)
            draft_disp += bool(b) + 1
            with self._wait("engine.upload"):
                feed_dev, dgr_dev, ftok_dev, fmask_dev = (
                    torch.from_numpy(a).to(dev)
                    for a in (feed_d, dgr, forced_tok, forced_mask))
            # steps past the largest grant would idle every slot
            toks_d, c = self.draft_model.decode_many_paged(
                self.draft_params, feed_dev[:, None], self._draft_cache(),
                self._dgen, dgr_dev, ftok_dev, fmask_dev,
                num_steps=int(dgr.max()), temperature=0.0)
            self._draft_writeback(c)
            dkv.length += dgr

        with self._wait("engine.readback"):
            toks_d_np = toks_d.cpu().numpy() if toks_d is not None else None

        # verify: one ragged prefill-lane call on the target
        vocab = self.model.cfg.vocab_size
        vgr = np.zeros((B,), np.int32)
        tok_v = np.full((B, chunk), cfg.pad_id, np.int32)
        for i in rows:
            tok_v[i, 0] = self._feed[i]
            k = int(k_prop[i])
            for s in range(k):
                t = int(toks_d_np[int(off[i]) + s, i])
                # clamp: an out-of-range draft token must not index past
                # the target's embedding (it is rejected anyway)
                tok_v[i, 1 + s] = min(max(t, 0), vocab - 1)
            vgr[i] = 1 + k
            self.spec_proposed += k
        upload += B * (chunk + 1) * 4
        with self._wait("engine.upload"):
            tok_v_dev = torch.from_numpy(tok_v).to(dev)
            vgr_dev = torch.from_numpy(vgr).to(dev)
        greedy, accept, cache = self.model.verify_many_paged(
            self.params, tok_v_dev, cache, vgr_dev)
        return greedy, accept, vgr, cache, upload, draft_disp

    def _spec_bookkeep(self, vgr, greedy_np, accept_np,
                       poisoned: Set[int]) -> None:
        """After a verify: emit each slot's accepted proposals and the
        bonus token, truncate the target's rejected rows (the pages stay
        owned; nothing past a length is read or shared), and roll the
        draft back to the accepted frontier."""
        cfg = self.cfg
        for i, slot in enumerate(self.slots):
            v = int(vgr[i])
            if not slot.active or v == 0 or i in poisoned:
                continue
            a = int(accept_np[i])
            kept = a + 1                  # accepted proposals + bonus
            L = len(slot.history)
            if kept < v:                  # rejected rows roll back
                self.kv.length[i] -= v - kept
                self.kv.dirty.add(i)
                self.spec_trunc_tokens += v - kept
            fed = [int(self._feed[i])] \
                + [int(greedy_np[i, s]) for s in range(kept - 1)]
            slot.history.extend(fed)
            if cfg.prefix_sharing:
                self._pindex.add(i, fed)
            slot.served += kept
            self.spec_accepted += a
            # the propose call appended [feed, p_1 .. p_{k-1}] past the
            # history: keep what the target accepted.  All k accepted
            # leaves a 1-token deficit (p_k was sampled, never appended)
            # that the next propose replays as a forced step 0.
            cur = int(self.dkv.length[i])
            dvalid = min(cur, L + min(kept, v - 1))
            if dvalid != cur:
                self.dkv.length[i] = dvalid
                self.dkv.dirty.add(i)
            self._emit(i, [int(greedy_np[i, s]) for s in range(kept)])

    # -- stepping -------------------------------------------------------

    def step(self) -> None:
        """One engine tick: faults, deadlines, admission, the plan (with
        preemption until some slot can advance, then the dropped-grant
        fault), the dirty-row sync, at most one prefill chunk and one
        decode loop on the device, the output guard, the bookkeeping, and
        quarantine of poisoned slots.  A tick that runs device work is an
        ``engine.tick`` span of four phases, ``engine.plan``,
        ``engine.prefill_lane``, ``engine.decode_loop`` and
        ``engine.bookkeep``, whose uploads and reads back are its waits
        for the device (``_wait``)."""
        t0 = time.perf_counter()
        self._wait_s = 0.0
        with spans.span("engine.tick", tick=self.ticks + 1) as tick:
            with spans.span("engine.plan"):
                plan, dispatches, tick_upload = self._plan_tick()
            if plan is None:
                spans.discard(tick)
            else:
                self._run_tick(plan, dispatches, tick_upload, t0)
        self._maybe_snapshot()

    def _plan_tick(self):
        """The tick's plan, device calls and upload bytes so far, after
        the dirty-row sync; (None, 0, 0) for a tick with no work."""
        cfg = self.cfg
        T = self._chunk_tokens
        self.ticks += 1
        self._apply_faults()
        self._expire_deadlines()
        self._admit()
        cow_disp0 = self.kv.cow_dispatches
        plan = self.scheduler.plan(self.slots, self.kv, self._chunk,
                                   prefill_tokens=T)
        self.stalls += plan.stalled
        # preempt-and-recompute: each pass drops one active slot, so the
        # loop is bounded by the batch; each plan ends in its own COW
        # flush, and the dirty rows are synced after the last one
        while not plan.any_work and cfg.preempt \
                and self._preempt_for_capacity():
            plan = self.scheduler.plan(self.slots, self.kv, self._chunk,
                                       prefill_tokens=T)
            self.stalls += plan.stalled
        # dropped-grant fault: the work vanishes after planning (lost work,
        # not a reason to preempt); the scheduler grants it again next tick
        if self._drop_slots:
            for i in self._drop_slots:
                if 0 <= i < len(self.slots):
                    d = int(plan.steps[i]) + int(plan.prefill[i])
                    if d:
                        self.dropped_grants += d
                        plan.steps[i] = 0
                        plan.prefill[i] = 0
            self._drop_slots.clear()
        if not plan.any_work:
            self._poison_slots.clear()
            if self.busy:
                if not cfg.preempt:
                    raise RuntimeError(
                        f"page pool exhausted: {len(self.kv.free)} free "
                        f"pages cannot give any slot step capacity "
                        f"(num_pages={self.kv.num_pages}, "
                        f"page={self.kv.page})")
                # idle-but-busy ticks are bounded (every queued request is
                # admissible, a lone stuck slot waits out a squeeze), so a
                # long run of them is a bookkeeping bug: raise
                self._idle += 1
                self.no_progress_ticks += 1
                if self._idle > cfg.wedge_ticks:
                    raise RuntimeError(
                        f"engine wedged: {cfg.wedge_ticks} consecutive "
                        "idle ticks with work pending (queue="
                        f"{len(self.queue)}, active="
                        f"{sum(s.active for s in self.slots)}, free="
                        f"{len(self.kv.free)}, seized="
                        f"{len(self.kv.seized)})")
            return None, 0, 0
        self._idle = 0
        # device calls, counted as the JAX engine counts its cells: the COW
        # flushes, the row patch, the prefill chunk, the decode loop
        dispatches = self.kv.cow_dispatches - cow_disp0
        row_bytes = self._sync_dirty(self.kv, self._table_dev,
                                     self._length_dev)
        if row_bytes:
            self.table_upload_bytes += row_bytes
            dispatches += 1
        return plan, dispatches, row_bytes

    def _run_tick(self, plan, dispatches: int, tick_upload: int,
                  t0: float) -> None:
        """The device work of a planned tick and its bookkeeping."""
        cfg = self.cfg
        T = self._chunk_tokens
        B = len(self.slots)
        steps, pgr = plan.steps, plan.prefill
        dev = self.device
        cache = {"k": self.kv.k, "v": self.kv.v,
                 "table": self._table_dev, "length": self._length_dev}
        if self.kv.quantized:            # scale pools ride the cache
            cache["k_scale"] = self.kv.k_scale
            cache["v_scale"] = self.kv.v_scale

        nxt = None
        if pgr.any():                     # prefill lane: one (B, T) chunk
            with spans.span("engine.prefill_lane", tokens=int(pgr.sum())):
                tok_mat = np.full((B, T), cfg.pad_id, np.int32)
                for i, slot in enumerate(self.slots):
                    g = int(pgr[i])
                    if g:
                        tok_mat[i, 0] = self._feed[i]
                        tok_mat[i, 1:g] = slot.forced[:g - 1]
                pbytes = B * (T + 1) * 4      # token block + grant vector
                self.prefill_upload_bytes += pbytes
                tick_upload += pbytes
                with self._wait("engine.upload"):
                    tok_dev = torch.from_numpy(tok_mat).to(dev)
                    pgr_dev = torch.from_numpy(pgr).to(dev)
                nxt, cache = self.model.prefill_many_paged(
                    self.params, tok_dev, cache, self.generator, pgr_dev,
                    temperature=cfg.temperature)
                dispatches += 1
        toks = greedy = accept = None
        vgr = steps                       # target rows the decode appends
        d_disp = v_disp = 0
        if steps.any() and self._spec:    # draft-propose, target-verify
            with spans.span("engine.decode_loop", num_steps=self._chunk):
                (greedy, accept, vgr, cache, d_up,
                 d_disp) = self._spec_decode(steps, cache)
            v_disp = 1
            tick_upload += d_up
            dispatches += d_disp + v_disp
            self.draft_dispatches += d_disp
            self.verify_dispatches += v_disp
        elif steps.any():
            # decode loop over the grants; steps past the largest grant
            # would be idle for every slot, so the loop stops there
            num_steps = int(steps.max())
            with spans.span("engine.decode_loop", num_steps=num_steps):
                tick_upload += 2 * B * 4      # feed tokens + step grants
                forced = self._forced_arrays(steps)
                if forced:
                    forced_bytes = self._chunk * B * (4 + 1)
                    self.forced_upload_bytes += forced_bytes
                    tick_upload += forced_bytes
                with self._wait("engine.upload"):
                    feed = torch.from_numpy(self._feed).to(dev)[:, None]
                    steps_dev = torch.from_numpy(steps).to(dev)
                    forced = tuple(torch.from_numpy(a).to(dev)
                                   for a in forced)
                toks, cache = self.model.decode_many_paged(
                    self.params, feed, cache, self.generator, steps_dev,
                    *forced, num_steps=num_steps,
                    temperature=cfg.temperature)
            dispatches += 1
        with spans.span("engine.bookkeep"):
            self._bookkeep(steps, pgr, vgr, cache, toks, nxt, greedy,
                           accept)
        t3 = time.perf_counter()
        if cfg.trace_ticks:
            # the tick's host time: its wall time less its waits for the
            # device, the uploads and reads back
            self.host_ms_trace.append((t3 - t0 - self._wait_s) * 1e3)
            self.wait_ms_trace.append(self._wait_s * 1e3)
            self.dispatch_trace.append(dispatches)
            self.upload_trace.append(tick_upload)
            if self._spec:
                self.draft_dispatch_trace.append(d_disp)
                self.verify_dispatch_trace.append(v_disp)
        self.upload_bytes += tick_upload

    def _bookkeep(self, steps, pgr, vgr, cache, toks, nxt, greedy,
                  accept) -> None:
        """After the device calls: the pools and counters, the pool
        statistics, the read back of the sampled tokens, the output guard,
        the lane's and the decode loop's bookkeeping, and quarantine."""
        cfg = self.cfg
        B = len(self.slots)
        self.kv.k, self.kv.v = cache["k"], cache["v"]
        if self.kv.quantized:
            self.kv.k_scale = cache["k_scale"]
            self.kv.v_scale = cache["v_scale"]
        self._length_dev = cache["length"]     # the device advanced it
        self.kv.length += vgr + pgr            # host mirror of the increment
        self.tokens_appended += int(vgr.sum()) + int(pgr.sum())
        self.steps_run += 1
        if cfg.trace_pool:
            self.util_trace.append(self.kv.utilization())
            self.occupancy_trace.append(self.kv.occupancy())

        # the device waits: the decode loop's tokens, the lane's sampled
        # token, the verify's argmaxes and accept lengths
        with self._wait("engine.readback"):
            toks_np, nxt_np, greedy_np, accept_np = (
                t.cpu().numpy() if t is not None else None
                for t in (toks, nxt, greedy, accept))
        # poison fault: the slot's sampled tokens this tick come back as
        # an out-of-vocabulary sentinel (a verified window entirely)
        if self._poison_slots:
            for i in self._poison_slots:
                if 0 <= i < B:
                    if toks_np is not None and steps[i]:
                        toks_np[:, i] = -1
                    if greedy_np is not None and vgr[i]:
                        greedy_np[i, :] = -1
                    if nxt_np is not None and pgr[i]:
                        nxt_np[i] = -1
            self._poison_slots.clear()
        # the always-on output guard: a kept token outside the vocabulary
        # means garbage logits; the slot skips this tick's bookkeeping and
        # is quarantined below, its request requeued with its pre-tick
        # output.  A verified window keeps accept + 1 tokens, each checked.
        vocab = self.model.cfg.vocab_size
        poisoned: Set[int] = set()
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            g, si = int(pgr[i]), int(vgr[i])
            if g and slot.prompt_left - g <= 0:   # sampled token is kept
                if not 0 <= int(nxt_np[i]) < vocab:
                    poisoned.add(i)
            if si and i not in poisoned:
                kept = (greedy_np[i, :int(accept_np[i]) + 1]
                        if greedy_np is not None else toks_np[:si, i])
                if not all(0 <= int(t) < vocab for t in kept):
                    poisoned.add(i)

        # prefill-lane bookkeeping: the chunk's tokens are known on the
        # host; only the ONE sampled token per slot came back, and it
        # matters only when the prompt drained
        for i, slot in enumerate(self.slots):
            g = int(pgr[i])
            if not slot.active or g == 0 or i in poisoned:
                continue
            fed = [int(self._feed[i])] + [int(t) for t in slot.forced[:g - 1]]
            slot.history.extend(fed)
            if cfg.prefix_sharing:
                self._pindex.add(i, fed)
            slot.served += g
            del slot.forced[:g - 1]
            slot.prompt_left -= g
            if slot.prompt_left > 0:      # mid-prompt: feed the next token
                self._feed[i] = slot.forced.pop(0)
                continue
            self._emit(i, [int(nxt_np[i])])
        if greedy_np is not None:         # a verified window per slot
            self._spec_bookkeep(vgr, greedy_np, accept_np, poisoned)
        elif toks_np is not None:
            self._decode_bookkeep(steps, toks_np, poisoned)
        for i in sorted(poisoned):
            if self.slots[i].active:
                self._preempt(i, quarantine=True)

    @contextlib.contextmanager
    def _wait(self, name: str):
        """A wait for the device, ``engine.upload`` (a blocking copy from
        pageable host memory) or ``engine.readback``: a span when the
        recorder is on, and always two clock reads, whose interval adds
        to the tick's waits, which ``host_ms_trace`` leaves out."""
        t = time.perf_counter()
        try:
            with spans.span(name):
                yield
        finally:
            self._wait_s += time.perf_counter() - t

    def _maybe_snapshot(self) -> None:
        """Write the whole state at the end of every
        ``cfg.snapshot_every_ticks``-th tick (idle ticks too: the fault
        and deadline clock moved), atomically, and prune old files to
        ``cfg.snapshot_keep``.  No ``snapshot_dir``: nothing is written.
        The snapshot module is imported here, when a snapshot is due."""
        cfg = self.cfg
        if cfg.snapshot_every_ticks <= 0 or not cfg.snapshot_dir \
                or self.ticks % cfg.snapshot_every_ticks != 0 \
                or self.ticks == self._last_snapshot_tick:
            return
        from repro_torch.serve import snapshot
        snapshot.save_snapshot(
            self, snapshot.snapshot_path(cfg.snapshot_dir, self.ticks))
        snapshot.prune_snapshots(cfg.snapshot_dir, cfg.snapshot_keep)
        self.snapshots_written += 1
        self._last_snapshot_tick = self.ticks

    def _forced_arrays(self, steps) -> tuple:
        """Prefill-by-decode: the (chunk, B) forced tokens and mask that
        feed the granted slots' next prompt tokens through the decode
        loop, on the host; () when no granted slot has prompt left (a
        pure-decode tick builds and uploads nothing)."""
        if not any(s.active and s.forced and steps[i]
                   for i, s in enumerate(self.slots)):
            return ()
        B = len(self.slots)
        forced_tok = np.full((self._chunk, B), self.cfg.pad_id, np.int32)
        forced_mask = np.zeros((self._chunk, B), bool)
        for i, slot in enumerate(self.slots):
            n = min(len(slot.forced), int(steps[i]))
            forced_tok[:n, i] = slot.forced[:n]
            forced_mask[:n, i] = True
        return forced_tok, forced_mask

    def _decode_bookkeep(self, steps, toks_np, poisoned: Set[int]) -> None:
        """After the decode loop: the tokens fed this tick are its K/V
        rows; a slot's first steps may have been forced prompt tokens,
        and only the steps past them emit output."""
        for i, slot in enumerate(self.slots):
            si = int(steps[i])
            if not slot.active or si == 0 or i in poisoned:
                continue
            out = [int(toks_np[s, i]) for s in range(si)]
            fed = [int(self._feed[i])] + out[:-1]
            slot.history.extend(fed)
            if self.cfg.prefix_sharing:
                self._pindex.add(i, fed)
            slot.served += si
            n_forced = min(len(slot.forced), si)
            del slot.forced[:n_forced]
            slot.prompt_left = max(0, slot.prompt_left - si)
            if n_forced < si:
                self._emit(i, out[n_forced:])
            else:                         # mid-prompt: feed the last one
                self._feed[i] = out[-1]

    def _emit(self, i: int, toks: List[int]) -> None:
        """Append slot ``i``'s new output tokens up to eos or its budget
        (later tokens of the chunk are overshoot, discarded) and finish the
        slot or feed its last token."""
        slot = self.slots[i]
        cfg = self.cfg
        if not slot.out:
            req = self._reqs[slot.rid]
            if req.t_first is None and not req.emitted:
                self._first_token(req)
        for tok in toks:
            slot.out.append(tok)
            self.tokens_out += 1
            if (cfg.eos_id >= 0 and tok == cfg.eos_id) \
                    or len(slot.out) >= slot.budget:
                self._finish(i)
                return
        self._feed[i] = toks[-1]

    # -- bookkeeping ----------------------------------------------------

    @property
    def logical_tokens(self) -> int:
        """Tokens logically resident over the run: fresh appends plus
        prompt tokens served by page reference."""
        return self.tokens_appended + self.shared_tokens

    @property
    def logical_physical_ratio(self) -> float:
        """Logical tokens per physically written token (1.0 when nothing
        was shared)."""
        return self.logical_tokens / max(1, self.tokens_appended)
