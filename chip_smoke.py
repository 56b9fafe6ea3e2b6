#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no result line):

  1. build   — builds the CUDA kernels from ``src/repro_torch/csrc`` with
               nvcc and prints the build time and the card's name and
               power limit.
  2. kernels — holds each paged-attention kernel against its plain PyTorch
               version on the card (granite-8b, qwen2-0.5b, granite-20b
               (48 heads over one KV head), phi4-mini, llama4-scout (40
               over 8: G = 5) and grok-1 (48 over 8: G = 6) geometry, page
               16, and page 8 for prefill, ragged lengths up to ~2k
               tokens, bf16/f32/int8 pools, an empty prefill slot, tables
               that alias another slot's pages with a prefill base and a
               decode length that are not page multiples; the
               split decode kernel also at kv_len on its pieces' and
               pages' edges, and kv_len 0, which must give exact zeros), then
               times the kernel, the plain version and one library
               yardstick (a gather plus ``scaled_dot_product_attention``,
               never used by the port) at the serving path's shapes,
               beside the least time the card could take for the same
               work; prints the prefill grid's block count (at least 128),
               the decode grid's splits, and both kernels' device time
               with the host's issue rate out of the way (``device_ms``);
               the prefill kernel also at the speculative verify's shape
               (T = 5 from mid-page bases), checked and timed.
  3. serve   — granite-8b at full width and depth (36 layers, bf16,
               random weights from a seeded generator) through
               ``PagedEngine``: 8 requests of 64-300 prompt tokens, 32 new
               tokens each, greedy.  Both kernels' launch counters must
               rise on this path, and one prefill chunk's and one decode
               step's logits on the kernel path are held against the plain
               path.  Sharing is off here (the JAX launcher's
               ``--no-prefix-sharing`` path).
     by-decode — the same requests with ``prefill_lane=False``: every
               prompt token rides the decode loop as a forced token.
               Hard checks: in-vocab tokens; the decode kernel's counter
               rises and the prefill kernel's does not;
               ``forced_upload_bytes`` > 0 and ``prefill_upload_bytes``
               0; each request's first-token logits within 8 bf16 ulps
               of the lane's (the serve phase's).
     spec    — the same requests with ``spec_k=4`` and two drafts: the
               target's first 4 layers (views), and layer 1 of a
               doctored target whose layers 2-36 have zeroed ``wo`` and
               ``w_down`` (a ceiling for the machinery).  Hard checks:
               32 in-vocab tokens each; ``kv.check()`` and
               ``dkv.check()`` after every tick; both paged kernels
               launched; one verify call per tick with decode grants;
               the doctored run's accept rate above 0.5; request 0's
               verify logits at its first decode position within 8 bf16
               ulps of the serve phase's decode step.  Token identity
               with serve is reported (bf16 verify takes its argmax over
               prefill-kernel logits).  Both phases print tokens/s and
               the host split beside serve's.
     share   — the same model and weights through ``PagedEngine`` with
               the default ServeConfig (prefix sharing and retention on),
               max_batch 4, page 16, prefill chunks of 32: a 200-token
               system prompt (12 pages and 8 tokens) behind 8 tails of
               16-120 tokens, then 4 exact repeats after the drain, 32
               new tokens each.  Every request gets 32 in-vocab tokens;
               shared tokens, copy-on-write copies and retained
               adoptions are all > 0; ``kv.check()`` and the prefix
               index's check pass after every tick; fewer prefill chunks
               than the same traffic with sharing off; a live sharer's
               and a retained adopter's first-token logits are within
               8 bf16 ulps of their prompts served alone with sharing
               off; and one ``defrag()`` mid-run changes no token and no
               bit of those logits.
               Both phases print the engine's per-tick host split
               (median and p90 of ``host_ms_trace``, the means of
               ``dispatch_trace`` and ``upload_trace``).
     recover — the share phase's model, weights, traffic and ServeConfig
               with a snapshot every 4 ticks (``serve/snapshot.py``, into
               a temporary directory; the second wave submitted when the
               first has drained, ``_next_rid`` the submission cursor).
               Served once uninterrupted (the snapshots' cost, and the
               tick trace that places the kills), then with two ``kill``
               faults: one in the first wave one tick past the last copy
               on write of a snapshot's interval, with a page shared; one
               in the repeats three ticks after a snapshot that holds a
               retained adoption.  Each is recovered as
               tests/test_snapshot_props.py recovers: the dead engine
               dropped, a fresh ``PagedEngine`` on the same parameter
               tensors, ``restore_engine(latest_snapshot(dir))``, the
               plan re-armed without the fired kill.  Hard checks: both
               kills fire and each restores from a snapshot;
               ``kv.check()`` and the prefix index after every tick;
               both runs' tokens and statuses bit-identical to the share
               phase's run, and its shared-token, COW and retained-
               adoption counts equal; both paged kernels launched; a
               truncated copy of the newest file (cut in the header, in
               the middle, 3 bytes short) raises
               ``SnapshotCorruptError`` and ``latest_snapshot`` falls
               back to the newest whole one.  Prints the bytes of a
               snapshot, the median and max save ms, each restore's ms,
               ticks replayed and seconds from the kill to the restored
               engine's first finished tick, the snapshots written and
               tokens/s of ``step()`` with snapshots on beside share's.
     overload — the same model and weights through ``PagedEngine`` with
               40 allocatable pages (under half of four slots' full
               tables), max_queue 6: 11 requests of 150-300 prompt and
               48 new tokens in two bursts (the first burst's 7th is
               rejected queue-full), the second burst's first request
               with a deadline, a running request cancelled, and a
               ``FaultPlan`` with a squeeze, an evict, a drop and a
               poison at fixed ticks.  Hard checks: every request
               terminal; a capacity preemption, recomputed tokens and a
               ``PREEMPTED_RESUMED`` request; a quarantine, dropped
               grants and all four fault kinds; the deadline request
               partial; ``kv.check()`` and the prefix index after every
               tick; drained with no live page and, after
               ``flush_retained``, the whole free list; every kept token
               in vocabulary; both paged kernels launched.  Against the
               same requests served uninterrupted: the count of
               identical requests (bf16, reported) and one resumed
               request's first logits after its resume within 8 bf16
               ulps of the uninterrupted run's at that position.  Prints
               tokens/s, recompute_tokens / tokens_out and the host
               split.  Then the first 4 requests on int8 pools and the
               same pool: terminal, preempted, ``kv.check()`` clean, and
               their first-token logits' drift against bf16 printed.
     whole-batch — the same model and weights through ``ServingEngine``
               (lockstep whole-batch serving): 4 prompts of 64-500 tokens,
               32 new tokens, greedy.  The flash kernel must run for every
               layer of the prefill and the dense decode kernel for every
               layer of every decode step; the fused loop and the legacy
               loop give identical tokens; a batch with a 777-token prompt
               is served (512 does not divide 777); the prefill's and one
               decode step's logits on the kernel path are held against
               the plain path.  Before it, both dense kernels are held
               against their plain versions (GQA, MQA, MHA, the MoE
               archs' G = 5 and 6 at D = 128, and zamba2's 32 heads of
               112 over 32, the D = 112 instantiations; f32 and bf16;
               decode over caches of 24-2080 rows with random windows, no
               window and an empty one, and at the split kernel's piece
               edges; flash causal and not, S = T from 37 to 2048, S != T,
               and S = 600 through ``models.attention.attention``), and
               after it timed at the whole-batch path's shapes beside
               their bounds and SDPA.
  4. parity  — qwen2-0.5b (reduced) in f32, kernel path against plain path:
               greedy tokens identical, through the engine (sharing and
               retention on, shared-prefix traffic and repeats; equal
               sharing counters; then tests/test_overload_props.py's two
               regression schedules and a ``FaultPlan.random(28)`` fuzz
               run, where every finished or resumed request gives the
               tokens of its uninterrupted run on both paths; then
               speculation at spec_k 1 and 3, and at 3 under preemption
               at a pool of five pages, and ``prefill_lane=False``, each
               identical on both paths and to plain greedy decode; then
               tests/test_snapshot_props.py's int8 speculative drill,
               int8 pools, spec_k 2 with a 1-layer draft, a random
               recoverable plan and kills at ticks 7 and 13 recovered
               from snapshots, identical to the uninterrupted run on
               both paths) and through
               ``ServingEngine`` (prompts of multiples of 32 tokens, so
               the plain side takes the chunked flash reference, among
               them a (608, 64) batch, which 512 does not divide).
     ssm     — the selective-scan kernel against its plain version (f32
               and bf16; B 1 and 4; N 8 and 16; d_in 128, 1000, 1001 and
               8192; S 1, 37, 512 and 2048; B and C strided views, as the model
               passes them).  Then falcon-mamba-7b at full width and depth
               (64 Mamba1 layers, bf16, random weights from a seeded
               generator) through ``ServingEngine``: 4 prompts of 64-500
               tokens, 32 new tokens, greedy; the scan kernel must run
               exactly once per layer per prefill; fused and legacy loops
               give identical tokens; the prefill's logits and state and
               one decode step's logits on the kernel path are held
               against the plain path, once more with the conv and dt
               weights scaled so that the scan's output moves the logits
               (shown by zeroing it), with every layer's scan held
               against its plain version on the same inputs.  Then
               falcon-mamba (reduced) in
               f32, kernel against plain path, greedy tokens identical;
               and the kernel (also its ``device_ms``) and plain version
               timed at the phase's shape beside the bound (no single
               PyTorch call computes a selective scan, so no library
               time).
     moe     — after the granite-8b and falcon-mamba weights are
               released (device memory printed at its start):
               llama4-scout at its published widths (d_model 5120, 40/8
               heads of 128, 16 experts of d_ff 8192 top-1, vocab
               202048) and 12 of its 48 layers (54.0 GB of bf16, the
               depth one card holds), random weights from a seeded
               generator.  Paged with sharing off (serve's 8 requests)
               and with the default ServeConfig (share's traffic; no
               shared = alone logit bound: MoE capacity counts every row
               of a call, so batching moves tokens).  Hard checks: 32
               in-vocab tokens a request; ``kv.check()`` (and the prefix
               index) after every tick; both paged kernels launched
               exactly once per layer of every call.  Readings: tokens/s,
               the host split, the weight-read floor of a call, and (a
               recording pass, ``moe_ffn`` wrapped, whose tokens must
               equal the timed pass's) the routed (row, layer)
               assignments and the share capacity dropped, for decode
               and prefill calls.  Then one prefill chunk of 32
               rows in all 4 slots and one decode step with all active
               on the kernel and the plain route: the (row, layer)
               assignments whose experts or capacity keep differ are
               printed, and where none differs the logits are held
               within 8 bf16 ulps (a flipped near-tie is printed, not
               failed).  Whole-batch ``ServingEngine`` (4 prompts of
               64-500 tokens): flash once per layer, dense decode once
               per layer per step, fused = legacy tokens.  Then
               llama4-scout and grok-1 (ep_shards 8, G = 2E) reduced in
               f32, kernel against plain route: greedy tokens identical
               with no row that carries no request (4 x 64 tokens);
               on ragged traffic the count that differ is reported.
     vlm     — qwen2-vl-72b at its published widths (d_model 8192, 64/8
               heads of 128, d_ff 29568, vocab 152064, M-RoPE sections
               (16, 24, 24), qkv bias) and 24 of its 80 layers (47.1 GB
               of bf16), random weights from a seeded generator.  Serve's
               8 requests as text prompts through ``PagedEngine`` (sharing
               off; ``kv.check()`` every tick; both paged kernels once
               per layer of their calls, at G = 8), the serve phase's
               one-shot prefill chunk and decode step within 8 bf16 ulps
               of the plain route; then one whole-batch ``Model.prefill``
               of embeddings at B = 2 with Qwen2-VL's position layout (a
               12 x 16 patch grid at t 0, h the row, w the column, then
               64 text tokens on all three streams from 16) and 32 greedy
               decode steps: flash once per layer, dense decode once per
               layer a step, the prefill's and the first step's logits
               within 8 bf16 ulps of the plain route, and the same
               embeddings with three equal ``arange`` streams moving the
               logits past that bound.  Prints tokens/s and the host
               split.
     audio   — whisper-large-v3 at full width and depth (32 + 32
               layers, 1.53e9 parameters, 3.07 GB of bf16), the reference
               dispatch's chunks set to 500 (1024 divides no 1500-row
               encoder; no width moves): 4 requests of 1500 seeded frames
               and 4 prompt tokens, ``Model.prefill`` into a cache of 1500
               rows (the cross cache unpadded), 32 greedy tokens through
               ``decode_many``.  Hard checks: in-vocab tokens; flash once
               per encoder layer and twice per decoder layer (its
               self-attention and the cross-attention over the frames),
               dense decode once per decoder layer a step; the prefill's
               and the first step's logits within 8 bf16 ulps of the
               plain route; at 4 + 4 layers in f32, identical greedy
               tokens on both routes.  Prints tokens/s and the encoder's
               ms and device ms.  Before both, the kernel phase holds the
               paged kernels at qwen2-vl's G = 8, dense decode at G = 8
               and at whisper's G = 1, D = 64, and flash's model route at
               whisper's shapes (non-causal S = T = 1500, causal 448, the
               cross-attention's 64 x 1500), and the timing phase times
               flash at the encoder's shape beside its bound and SDPA.
     hybrid  — zamba2-7b at its published widths and full depth (81
               Mamba2 layers, d_model 3584, 112 SSD heads of 64, N 64,
               chunks of 256; one shared attention + FFN block, 32/32
               heads of 112, d_ff 14336, after every 6th layer: 13
               applications, 3 tail layers; 6.64e9 parameters, 13.27 GB
               of bf16), random weights from a seeded generator, after
               the earlier phases' weights are released (device memory
               printed at its start).  Through ``ServingEngine``: the
               whole-batch phase's 4 prompts (64-500 tokens, the longest
               454: SSD chunks of 256 and a ragged 198), 32 greedy tokens,
               fused and legacy loop.  Hard checks: in-vocab tokens;
               flash exactly 13 launches per prefill and dense decode 13
               per step, both at D = 112; fused = legacy tokens.  Then one
               prefill and one decode step timed on the host clock and
               traced (``torch.profiler``): device ms beside host ms, and
               the SSD scans' device ms in the prefill (each call in a
               profiler range).  Then the routes: at all 81 layers, every
               application's flash output held against plain attention
               on the same inputs (TOL), and the drift of the prefill's
               and a decode step's logits and of the states printed
               beside the floor (the plain prefill with one bit flipped
               in the share of attention outputs where flash differs);
               at the first 13 layers (2 applications, 1 tail layer) of
               the same weights, the prefill's logits, every layer's conv
               and ssm state and one decode step's logits within 8 bf16
               ulps of the plain route (the states to their stack's
               scale).  Then dense decode (T = 486) and flash (S = T =
               454, causal) timed at the phase's shapes beside their
               bounds and SDPA; and zamba2 reduced to 13 layers in f32,
               at its reduced heads and with two heads of 112, through
               ``ServingEngine``: greedy tokens identical on both routes
               (prompts right-aligned to 17, 64 and 2).
     train   — qwen2-0.5b at its published widths and full depth (24
               layers, d_model 896, 14/2 heads of 64, d_ff 4864, vocab
               151936, tied, QKV bias; bf16, remat per block), random
               weights from a seeded generator, through the port's
               ``Trainer``: the synthetic pipeline at S = 4096, global
               batch 8 in 2 microbatches, AdamW at a constant lr of 1e-3
               with f32 moments, 7 steps with a synchronous checkpoint
               at step 4, then again from that checkpoint for steps 4-6
               (7 steps and not 8: a checkpoint at step 8 would add a
               5 GB write that nothing reads).
               Hard checks: every loss and grad norm finite; the last
               loss below the first; the flash kernel launched exactly 96
               times a step (24 layers x forward and remat recompute x 2
               microbatches); the resumed losses within rtol = atol =
               2e-3 of the straight run's; at 2 of the 24 layers, full
               width, S = 1024, every gradient leaf of ``Model.loss`` on
               the kernel route against the plain route (f32: within
               1e-4 of the leaf's max abs; bf16: relative norm error
               within TRAIN_BF16_GRAD_BOUND); qwen2 reduced in f32
               through 3 ``make_train_step`` steps on both routes (losses
               within 1e-4, params within 1e-4 of their max abs).
               Prints each step's loss, grad norm and ms, the median
               step, tokens/s, ``model_flops`` over the step time and its
               share of the bf16 peak, one step's device ms split by
               profiler ranges (the flash forward kernel, the plain flash
               backward, the fused loss, the optimizer, the rest), the
               peak memory, the flash kernel with L timed at the train
               shape beside its bound and SDPA, and
               ``launch.train --arch qwen2-0.5b --steps 2 --batch 8``.
               Before it, the kernel phase holds flash at qwen2's G = 7
               and, in bf16 and f32, the training instantiation's output
               and L against the plain forward's (and its output against
               the serving instantiation's, bit for bit) at every
               training shape of the port: qwen2's S = T = 4096 causal,
               whisper's S = T = 1500 causal and not (G = 1, D 64, a
               ragged last tile), zamba2's S = T = 1024 causal (D 112).
     train-families — the non-dense families through the port's training
               path (remat per block, the kernel route under autograd).
               whisper-large-v3 at full width and depth (32 + 32 layers,
               1.5e9 parameters, bf16, attn chunks 500 as in the audio
               phase) through the ``Trainer``: S = 1500 frames and
               tokens, batch 8 in 2 microbatches, the launchers' lr
               schedule (``cosine_with_warmup(3e-4, 100, 5)``), f32
               moments, 5 steps.  Hard: finite losses and grad norms, the
               last loss below the first, the first batch's loss after
               the steps below its loss under the initial weights (one
               evaluation each; equal if no weight moved), flash
               exactly 384 launches a
               step ((32 encoder + 32 self + 32 cross) x forward and
               remat recompute x 2 microbatches); at 2 + 2 layers, S =
               512, every gradient leaf of ``Model.loss`` on the kernel
               route against the plain route (f32 within 1e-4 of the
               leaf's max abs; bf16 relative norm error within
               TRAIN_BF16_GRAD_BOUND).  Prints the median step, decoder
               tokens/s, ``model_flops`` (6 N D, D the decoder tokens)
               over the step and its share of the bf16 peak, a profiled
               step's device split, the peak memory, the kernel with L at
               the encoder's shape (B 4, S = T = 1500, 20 heads of 64,
               non-causal) beside SDPA and its bound, and
               ``launch.train --arch whisper-large-v3 --steps 1 --batch
               4`` (S 4096).  falcon-mamba-7b at its published widths:
               the routes' grads at 2 layers (S 256, B 2), the selective
               scan exactly 2 launches a layer (forward, recompute; its
               backward the plain scan's), 3 steps at 4 layers (S 512,
               batch 4) with finite losses, the step ms, a profiled
               step's device split and the plain backward's host share.
               zamba2-7b at its published widths: the routes' grads at 6
               layers (S 512, one application), 3 steps at 12 layers (S
               1024, batch 4) with flash exactly 4 launches a step, a
               profiled step's device split and the SSD scans' share
               (their forwards, recomputes and backwards).  Then
               llama4-scout, grok-1, qwen2-vl, whisper, falcon-mamba and
               zamba2 reduced in f32 through 3 ``make_train_step`` steps
               on both routes (losses within 1e-4, params within 1e-4 of
               their max abs).
     mesh    — the multi-device path at world size 1: an NCCL process
               group of one rank over a local store, ``make_host_mesh(1)``
               ((1, 1) "data", "model"), the dry-run's train rules
               (``rules_for``).  qwen2-0.5b at full width and depth
               (bf16, remat per block) through the ``Trainer``: 2
               unsharded steps, then 2 steps on the DTensor state that
               ``reshard`` placed, from the same weights (seed 0) on the
               same batches (S 4096, batch 4, constant lr 1e-3).  Hard:
               ``full_tensor()`` of the placed initial state equals the
               unplaced state byte for byte; flash exactly 2 x 24
               launches a sharded step (forward and recompute, inside
               the attention island); the sharded losses and grad norms
               within TRAIN_RESUME_TOL of the unsharded ones (and
               printed: bitwise equal or not).  Then falcon-mamba-7b at
               its published widths (d_model 4096, d_in 8192, N 16;
               bf16, remat per layer) at the train-families step shape
               (4 layers, S 512, batch 4; weights from seed 1): the same
               two runs on the same NCCL group, the same hard checks,
               the selective scan exactly 2 x 4 launches a step in both
               (forward and recompute; inside the scan island of
               ``models/ssm.py`` when sharded).  Then whisper-large-v3
               at full width, 4 + 4 layers (``mesh_whisper_decode``): a
               plain-route prefill of 4 x 1500 frames, then one decode
               step unsharded and one on the same group under the dry
               run's decode rules, the self and cross caches over
               ``cache_seq``: the cross-attention island
               (``mesh_cross_attention``) once a layer, logits within
               LOGIT_ULPS bf16 ulps of the unsharded step's (printed:
               bitwise equal or not), the same greedy tokens.  Prints
               both archs' step ms and the phase's seconds beside the
               card's name and power limit.
  5. stream  — holds BabelStream's five kernels against their plain
               versions in f32 and bf16 (the JAX tests' shapes, odd
               shapes that exercise the bounds guards, ragged last
               blocks and the ragged tails of the 16-byte vector kernels,
               and BabelStream's 2^25 elements): copy, mul, add and
               triad bit-identical, dot within 2^-20 of sum |a b| and
               bit-identical from run to run; copy and mul in place, add
               and triad with ``out=`` each input in turn, bit-identical,
               and a view off the 16-byte boundary refused by all four.
               Then BabelStream itself
               (``launch/babelstream.py``) at 2^25 f32 elements, 100 times:
               its solution check must pass and all five launch counters
               rise.  Times each kernel, its plain version and one library
               call (``copy_``, ``torch.mul``, ``torch.add``, ``torch.add``
               with ``alpha``, ``torch.dot``; never used by the port), and
               prints BabelStream's table and the measured memory ceiling
               (copy's rate) beside the card's name and power limit.
  6. irm     — a census of the built library's SASS (``cuobjdump``), which
               must find all five stream kernels loop-free, copy, mul,
               add and triad with no branch at all, and every bf16
               flash and paged-prefill instantiation issuing bf16
               tensor-core products (``HMMA.16816.F32.BF16``) and cp.async
               copies (``LDGSTS``), D = 112 included; the H100
               ``HardwareSpec`` read from the card with the measured
               ceiling; and the instruction roofline (``launch/irm.py``),
               with the SM clock read right after the BabelStream loop:
               the five stream points, then the looped kernels' points
               at PERF.md's shapes — paged decode and its combine, paged
               prefill, dense decode and its combine, flash and the scan
               — each counted by the loop census (``nvdisasm -g`` lines:
               every SASS loop of every instantiation a point uses tied
               to a loop marked ``REPRO_TRIP``, its unroll factor read
               from the listing, no ``LoopError``; their int8 and f32
               instantiations, and dense decode's and flash's at D = 112
               in bf16 and f32, are counted too) times its trip model,
               with bytes from the byte model and runtime from the
               kernel's device time in a ``torch.profiler`` trace (taken
               right after the build, before any large trace); then
               the two paged kernels summed over the ``serve`` phase's
               traffic (a recording pass logs every call's lengths, a
               traced pass gives the device time; their launch counts
               must match).  Prints [lo, hi], both intensities and
               achieved/roof for every point (none fails on its roof:
               L2 can lift a memory-side point past it); fails if any
               point's achieved GIPS passes the Eq. 3 peak by 5%.  A
               stream point above its roof is printed, not clamped.

  7. profile — the dry run's profiling half (``core/step_census.py``,
               ``profiler/session.py``): the train phase's step
               (qwen2-0.5b, ``train_config()``, S 4096, batch 8 in
               ``TRAIN_MICRO`` microbatches, f32 moments) traced once
               with ``census_of_step`` on fake CPU tensors (the card is
               not used; the plain route, as the dry run traces), its
               three-term roofline and instruction profile on the card's
               ``HardwareSpec`` with BabelStream's measured copy rate as
               the HBM roof; one line with the modeled step (ms, dominant
               term) beside the train phase's measured median step, MFU
               at both, the tensor cores' padding efficiency, and the
               census's device bytes beside the train phase's
               ``max_memory_allocated``.  Then, in a subprocess (its fake
               256-rank group never meets the mesh phase's NCCL group),
               ``python -m repro_torch.launch.dryrun --arch qwen2-0.5b
               --shape train_4k``: the production 16 x 16 cell, its
               summary line printed, and its unembedding's tensor-core
               FLOPs a device (``unembedding_flops``: the fused loss's
               four products on a rank's 1/16 of the vocabulary) beside
               the whole vocabulary's, held at most 1/16 of it, with the
               cell's useful ratio.  Beside it, in another subprocess,
               ``--arch whisper-large-v3 --shape decode_32k``: its
               summary line, and its tensor-core FLOPs a device held
               below 1.0e10 and its collective wire below 1 GB (the
               decode's cross-attention split over the cross cache's
               sequence).  Any part failing fails the run.

The line before the last is the kernels summary (JSON), every kernel's
bound taken against the data sheet's 3.35 TB/s (``bound_ms``), and
``device_ms`` for the attention kernels and the scan.  The log
also gives each kernel's time at the measured ceiling (``copy_rate_ms``):
the paper's roof, but the rate of the port's own copy kernel, which
other kernels may beat, so it is no lower bound.  A summary line gives
the seconds each phase took after the build (the limit is 1200 s in all).
The last line is ``{"ok": true, "device": {...}}``.
"""
import collections
import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor cores (data sheet)
F32_FLOPS_PER_S = 67e12          # f32 on the CUDA cores (data sheet)
# Tolerances of kernel against plain version, with their reasons:
TOL = {
    "float32": (2e-5, "f32: only the summation order differs"),
    "bfloat16": (1e-2, "bf16 output: its own bf16 rounding (2**-8 relative)"
                       " plus int8 pages dequantized to f32 in the kernel "
                       "and to bf16 in the plain version"),
}
LOGIT_ULPS = 8                   # serve-phase logit bound, in bf16 ulps
DENSE_KERNELS = {                # name: (source, the TPU kernel it replaces)
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/decode.py:93"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash.py:83"),
}
# kernels with loops, which the loop census counts (matched by name)
LOOPED = ("paged_", "decode_attention_kernel",
          "decode_attention_combine_kernel", "flash_attention_kernel",
          "flash_attention_tc_kernel", "flash_attention_lse_kernel",
          "flash_attention_tc_lse_kernel", "selective_scan_kernel")
# the bf16 instantiations on the tensor cores: each must issue the bf16
# m16n8k16 product (HMMA) and the cp.async copy (LDGSTS); name: count
TENSOR_CORE = {"flash_attention_tc_kernel": 5,
               "flash_attention_tc_lse_kernel": 5,
               "paged_prefill_tc_kernel": 8}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def log_ptxas(path: Path) -> None:
    """One line per kernel from ``-Xptxas -v``: the range of registers
    over its instantiations (attention kernels: head dims and types;
    stream kernels: f32 and bf16) and the spill bytes."""
    import re
    stats = {}
    kernel = None
    for line in path.read_text().splitlines():
        m = re.search(r"entry function '[^']*?(paged_(?:decode|prefill)_"
                      r"kernel|paged_prefill_tc_kernel|decode_attention_"
                      r"(?:combine_)?kernel|flash_attention_(?:tc_)?"
                      r"(?:lse_)?kernel"
                      r"|selective_scan_kernel|stream_[a-z]+)", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            stats.setdefault(kernel, [[], 0])[0].append(int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            stats.setdefault(kernel, [[], 0])[1] += int(m.group(1))
    for kernel, (regs, spill) in sorted(stats.items()):
        log(f"[build] {kernel}: {len(regs)} instantiations, "
            f"{min(regs)}-{max(regs)} registers, {spill} bytes spilled")


def time_ms(fn, iters: int = 36, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 36, warmup: int = 3) -> float:
    """Device time of ``fn(i)`` per call with the host out of the way: a
    spin kernel (``torch.cuda._sleep``, ~10 ms) holds the stream while the
    host queues all the calls, so the events time them back to back on
    the card.  ``time_ms`` times them as the host issues them, which for
    a short kernel behind a Python wrapper is the host's rate."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    queued_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if queued_ms > 5.0:
        raise AssertionError(f"device_ms: queueing took {queued_ms:.1f} ms, "
                             f"too close to the spin kernel's ~10 ms")
    return start.elapsed_time(end) / iters


def check_close(what, got, want, tol) -> float:
    """max |got - want|; raises unless finite and within rtol = atol =
    tol."""
    import torch
    a, b = got.float(), want.float()
    err = (a - b).abs().max().item()
    if not torch.isfinite(a).all() or not torch.allclose(a, b, rtol=tol,
                                                         atol=tol):
        raise AssertionError(f"{what}: kernel differs from plain by "
                             f"{err:.3e} > tol {tol}")
    return err


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------

def make_case(gen, *, B, T, H, KV, D, page, NB, L, q_dtype, pool,
              lens, base=None, alias=0):
    """Random paged-attention inputs on the card: pools with every slot's
    pages scattered through a random permutation, ragged lengths.
    ``alias`` > 0 maps slot 1's first ``alias`` table entries to slot 0's
    pages, as prefix sharing does."""
    import torch
    from repro_torch.models.kv_quant import quantize_rows
    dev = "cuda"
    num_pages = B * NB + 1
    q = torch.randn(B, T, H, D, generator=gen, device=dev).to(q_dtype)
    shape = (L, num_pages, page, KV, D)
    kp = torch.randn(shape, generator=gen, device=dev)
    vp = torch.randn(shape, generator=gen, device=dev)
    ks = vs = None
    if pool == "int8":
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
    else:
        kp, vp = kp.to(q_dtype), vp.to(q_dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    table = perm[:B * NB].reshape(B, NB).to(torch.int32)
    if alias:
        table[1, :alias] = table[0, :alias]
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    base = None if base is None else torch.tensor(base, dtype=torch.int32,
                                                  device=dev)
    return dict(q=q, k=kp, v=vp, ks=ks, vs=vs, table=table, lens=lens,
                base=base, layer=L - 1)


def run_kernel(kind, c, layer=None, pages_per_step=1):
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_prefill_attention)
    layer = c["layer"] if layer is None else layer
    if kind == "decode":
        return paged_decode_attention(
            c["q"], c["k"], c["v"], c["table"], c["lens"], layer,
            k_scale=c["ks"], v_scale=c["vs"], pages_per_step=pages_per_step)
    return paged_prefill_attention(
        c["q"], c["k"], c["v"], c["table"], c["base"], c["lens"], layer,
        k_scale=c["ks"], v_scale=c["vs"], pages_per_step=pages_per_step)


def run_plain(kind, c, layer=None):
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref, paged_prefill_attention_ref)
    layer = c["layer"] if layer is None else layer
    if kind == "decode":
        return paged_decode_attention_ref(c["q"], c["k"], c["v"], c["table"],
                                          c["lens"], layer, c["ks"], c["vs"])
    return paged_prefill_attention_ref(c["q"], c["k"], c["v"], c["table"],
                                       c["base"], c["lens"], layer, c["ks"],
                                       c["vs"])


def run_library(kind, c, layer=None):
    """The yardstick: one block-table gather plus SDPA (GQA, boolean
    mask).  Timed only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    layer = c["layer"] if layer is None else layer
    B, T, H, D = c["q"].shape
    _, _, page, KV, _ = c["k"].shape
    tbl = c["table"].long()
    S = tbl.shape[1] * page
    k = c["k"][layer][tbl].reshape(B, S, KV, D).transpose(1, 2)
    v = c["v"][layer][tbl].reshape(B, S, KV, D).transpose(1, 2)
    tpos = torch.arange(S, device="cuda")
    if kind == "decode":
        mask = (tpos[None, :] < c["lens"][:, None])[:, None, None, :]
    else:
        qpos = c["base"][:, None] + torch.arange(T, device="cuda")[None, :]
        mask = ((tpos[None, None, :] <= qpos[:, :, None])
                & (tpos[None, None, :] < c["lens"][:, None, None]))[:, None]
    out = F.scaled_dot_product_attention(c["q"].transpose(1, 2), k, v,
                                         attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def bound_ms(nbytes, flops, flops_per_s, bytes_per_s=HBM_BYTES_PER_S):
    """Least time the card could take for ``nbytes`` moved and ``flops``
    done: the larger of the two times.  Returns (ms, "bytes" |
    "operations")."""
    t_bytes = nbytes / bytes_per_s
    t_ops = flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def work(kind, c):
    """The bytes a paged call must move and its flops (QK and PV over the
    attended positions).  The bytes are the I/O of the trip models' byte
    model (``trip_model``: q read, out written, the live K/V rows and
    their scales, the live table entries and lengths; the split decode's
    partials are scratch between its two launches, not I/O), the count
    the irm phase places the kernels' points by."""
    import torch

    from repro_torch.kernels.decode_attention import paged, prefill_paged
    B, T, H, D = c["q"].shape
    _, _, page, KV, _ = c["k"].shape
    NB = c["table"].shape[1]
    lens = c["lens"].long()
    if kind == "decode":
        las = paged.trip_model(B, H, KV, D, page, NB, lens.tolist(),
                               c["q"].dtype, c["k"].dtype)
        attended = int(lens.sum())               # T == 1
    else:
        las = prefill_paged.trip_model(B, T, H, KV, D, page, NB,
                                       c["base"].tolist(), lens.tolist(),
                                       c["k"].dtype)
        t = torch.arange(T, device=lens.device)
        qpos = c["base"].long()[:, None] + t[None, :]
        attended = int(torch.minimum(qpos + 1, lens[:, None]).clamp(
            min=0).sum())
    return sum(la.io_bytes for la in las), 4 * attended * H * D


# the paged kernels' geometries: the archs the port serves (the MoE
# archs' G = 5 and 6 query heads a KV head among them, qwen2-vl's G = 8)
PAGED_GEOMS = {"granite-8b": dict(H=32, KV=8, D=128),
               "qwen2-0.5b": dict(H=14, KV=2, D=64),
               "granite-20b": dict(H=48, KV=1, D=128),
               "phi4-mini-3.8b": dict(H=24, KV=8, D=128),
               "llama4-scout": dict(H=40, KV=8, D=128),
               "grok-1": dict(H=48, KV=8, D=128),
               "qwen2-vl": dict(H=64, KV=8, D=128)}


def kernel_phase(torch):
    """Kernels against their plain versions; returns {kind: max_abs_err}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    geoms = PAGED_GEOMS
    pools = [("bfloat16", torch.bfloat16, "bf16"),
             ("float32", torch.float32, "f32"),
             ("bfloat16", torch.bfloat16, "int8"),
             ("float32", torch.float32, "int8")]
    B, page, NB, L, T = 4, 16, 131, 2, 32        # NB % 3 != 0 (P = 3)
    lens = [2093, 17, 1024, 700]                 # ragged, up to ~2k
    base = [2061, 0, 130, 0]                     # prefill: chunk of 32
    grants = [32, 17, 5, 0]                      # ... slot 3 is EMPTY
    # aliased tables: slot 1's first 12 pages are slot 0's, as after a
    # share of 200 tokens (12 pages and 8 rows, the 13th page copied on
    # write); its prefill chunk starts at 200, not a page multiple
    alias_lens = [2093, 209, 1024, 700]
    alias_base = [2061, 200, 130, 0]
    errs = {"decode": 0.0, "prefill": 0.0}
    # (kind, page, NB, aliased pages): decode and prefill at the serving
    # page, prefill at page 8, whose 64-position tiles span eight pages
    # each, and both at the serving page on aliased tables
    runs = [("decode", page, NB, 0), ("prefill", page, NB, 0),
            ("prefill", 8, 2 * NB, 0), ("decode", page, NB, 12),
            ("prefill", page, NB, 12)]
    for gname, g in geoms.items():
        for tname, q_dtype, pool in pools:
            tol, _ = TOL[tname]
            for kind, pg, nb, alias in runs:
                if kind == "decode":
                    c = make_case(gen, B=B, T=1, NB=nb, L=L, page=pg,
                                  q_dtype=q_dtype, pool=pool,
                                  lens=alias_lens if alias else lens,
                                  alias=alias, **g)
                else:
                    b = alias_base if alias else base
                    c = make_case(gen, B=B, T=T, NB=nb, L=L, page=pg,
                                  q_dtype=q_dtype, pool=pool,
                                  lens=[x + n for x, n in zip(b, grants)],
                                  base=b, alias=alias, **g)
                got = run_kernel(kind, c, pages_per_step=3)
                want = run_plain(kind, c)
                torch.cuda.synchronize()
                live = c["lens"] > 0
                if kind == "prefill":
                    empty = got[~live]
                    if empty.numel() and empty.abs().max().item() != 0.0:
                        raise AssertionError(
                            f"{gname} {pool} prefill: the empty slot "
                            f"(new_len == 0) must be exact zeros")
                what = "aliased" if alias else "distinct"
                err = check_close(f"{gname} {pool} pool, q {tname}, {kind}, "
                                  f"{what} tables", got[live], want[live],
                                  tol)
                errs[kind] = max(errs[kind], err)
                log(f"[kernels] {kind:7s} {gname:14s} q={tname:8s} "
                    f"pool={pool:4s} page={pg:2d} {what:8s} tables "
                    f"max|kernel-plain|={err:.3e} (tol {tol})")
    errs["decode"] = max(errs["decode"],
                         paged_split_checks(torch, gen, geoms, pools))
    for tname, (tol, why) in TOL.items():
        log(f"[kernels] tolerance {tname}: rtol=atol={tol} — {why}")
    log("[kernels] empty prefill slot (new_len == 0): exact zeros from the "
        "kernel, as from the Pallas kernel (the plain version softmaxes it "
        "uniformly; excluded from the comparison)")
    log("[kernels] aliased tables: slot 1 maps slot 0's first 12 pages; "
        "decode at kv_len 209, prefill from base 200 (not page multiples)")
    return errs


def paged_split_checks(torch, gen, geoms, pools):
    """The split paged decode kernel at its pieces' and pages' edges: B =
    4 over a 22-page table at page 16 (8 splits per kv head at granite's
    KV = 8, 22 at qwen's KV = 2), kv_len of 0 (exact zeros), 1, one page,
    one page and a token, 8 pages (one a piece at 8 splits), 9 pages and
    a token (pieces 5-7 empty), 9 pages and the full table.  Returns
    max |kernel - plain|."""
    from repro_torch.kernels.decode_attention import paged
    B, page, NB = 4, 16, 22
    err = 0.0
    for gname, g in geoms.items():
        n = paged.splits(NB, B, g["KV"])
        for tname, q_dtype, pool in pools:
            tol, _ = TOL[tname]
            e = 0.0
            for lens in ([0, 1, page, page + 1],
                         [8 * page, 8 * page + 1, 9 * page, NB * page]):
                c = make_case(gen, B=B, T=1, NB=NB, L=2, page=page,
                              q_dtype=q_dtype, pool=pool, lens=lens, **g)
                got = run_kernel("decode", c)
                want = run_plain("decode", c)
                torch.cuda.synchronize()
                live = c["lens"] > 0
                if (got[~live] != 0).any().item():
                    raise AssertionError(f"{gname} {pool} decode: kv_len == "
                                         f"0 must give exact zeros")
                e = max(e, check_close(
                    f"{gname} {pool} pool, q {tname}, split decode lens="
                    f"{lens} ({n} splits)", got[live], want[live], tol))
            err = max(err, e)
            log(f"[kernels] decode  {gname:14s} q={tname:8s} pool={pool:4s} "
                f"{n} splits, kv_len on page and piece edges: max|kernel-"
                f"plain|={e:.3e} (tol {tol}); kv_len 0 exact zeros")
    return err


def timing_phase(torch, serve_lens, serve_base, max_blocks, n_layers):
    """Kernel, plain and library times at the serving path's shapes
    (granite-8b, bf16, B = 4, page 16, prefill chunk 32), cycling through
    the layers of a full-depth pool so that, as on the serving path,
    consecutive calls read different pages."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    g = dict(H=32, KV=8, D=128)
    rows = {}
    for kind in ("decode", "prefill"):
        if kind == "decode":
            c = make_case(gen, B=4, T=1, NB=max_blocks, L=n_layers, page=16,
                          q_dtype=torch.bfloat16, pool="bf16",
                          lens=serve_lens, **g)
        else:
            c = make_case(gen, B=4, T=32, NB=max_blocks, L=n_layers,
                          page=16, q_dtype=torch.bfloat16, pool="bf16",
                          lens=[b + 32 for b in serve_base], base=serve_base,
                          **g)
        if kind == "prefill":
            from repro_torch.kernels.decode_attention import prefill_paged
            blocks = prefill_paged.grid_blocks(4, 32, g["H"], g["KV"],
                                               torch.bfloat16)
            log(f"[timing] prefill grid at the serving shape (B=4, T=32, "
                f"H={g['H']}, KV={g['KV']}, bf16): {blocks} blocks")
            if blocks < 128:
                raise AssertionError(f"paged prefill launches {blocks} "
                                     f"blocks, fewer than 128")
        ms = time_ms(lambda i: run_kernel(kind, c, layer=i % n_layers))
        plain_ms = time_ms(lambda i: run_plain(kind, c, layer=i % n_layers))
        lib_ms = time_ms(lambda i: run_library(kind, c, layer=i % n_layers))
        nbytes, flops = work(kind, c)
        bms, bound_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        rows[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bms, bound_by=bound_by, bytes=nbytes,
                          flops=flops, flops_per_s=BF16_FLOPS_PER_S,
                          lens=c["lens"].tolist())
        log(f"[timing] {kind:7s} granite-8b bf16 B=4 lens={rows[kind]['lens']}"
            f": kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bms:.5f} "
            f"(by {bound_by}; live K/V bytes over "
            f"{HBM_BYTES_PER_S / 1e12} TB/s)")
        dms = device_ms(lambda i: run_kernel(kind, c, layer=i % n_layers))
        rows[kind]["device_ms"] = dms
        log(f"[timing] {kind} kernel device_ms={dms:.4f} (queued ahead of "
            f"the card; kernel_ms above is the wrapper's issue rate)")
        if kind == "decode":
            from repro_torch.kernels.decode_attention import paged
            n = paged.splits(max_blocks, 4, g["KV"])
            log(f"[timing] decode grid at NB={max_blocks}: {n} splits, "
                f"{n * g['KV'] * 4} blocks (+ the combine's {g['KV'] * 4})")
    # the prefill kernel at the speculative verify's shape: T = spec_k + 1
    # rows a slot from a base the serve lengths put mid-page
    T = SPEC_K + 1
    c = make_case(gen, B=4, T=T, NB=max_blocks, L=n_layers, page=16,
                  q_dtype=torch.bfloat16, pool="bf16", lens=serve_lens,
                  base=[n - T for n in serve_lens], **g)
    err = check_close(f"prefill at the verify shape (T={T})",
                      run_kernel("prefill", c), run_plain("prefill", c),
                      TOL["bfloat16"][0])
    ms = time_ms(lambda i: run_kernel("prefill", c, layer=i % n_layers))
    dms = device_ms(lambda i: run_kernel("prefill", c, layer=i % n_layers))
    plain_ms = time_ms(lambda i: run_plain("prefill", c,
                                           layer=i % n_layers))
    bms, bound_by = bound_ms(*work("prefill", c), BF16_FLOPS_PER_S)
    log(f"[timing] prefill at the verify shape (B=4, T={T}, bases "
        f"{[n - T for n in serve_lens]}): kernel_ms={ms:.4f} device_ms="
        f"{dms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.5f} (by "
        f"{bound_by}); max|err| {err:.3e}")
    rows["verify"] = dict(ms=ms, device_ms=dms, plain_ms=plain_ms,
                          bound_ms=bms, err=err)
    return rows


# ---------------------------------------------------------------------------
# 3./4. engine phases
# ---------------------------------------------------------------------------

def serve_phase(torch, decode_kernel, prefill_kernel, counter):
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    cfg = configs.get("granite-8b")              # full width and depth
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] granite-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params in bf16, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(7)
    prompt_lens = rng.randint(64, 301, size=8)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n in prompt_lens]
    new_tokens = 32
    # sharing off: the JAX launcher's --no-prefix-sharing path (the
    # share phase serves the defaults)
    scfg = ServeConfig(max_batch=4, max_seq=int(prompt_lens.max())
                       + new_tokens + 16, max_new_tokens=new_tokens,
                       page_size=16, prefill_chunk_tokens=32,
                       prefix_sharing=False, retain_prefixes=False)
    engine = PagedEngine(model, params, scfg)
    torch.cuda.reset_peak_memory_stats()
    rids = [engine.submit(p) for p in prompts]
    decode_kernel.launches = 0                   # counts of the main path
    prefill_kernel.launches = 0
    t0 = time.perf_counter()
    first, _, _ = drive_recorded(engine)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results = engine.results
    launches = {"decode": decode_kernel.launches,
                "prefill": prefill_kernel.launches}
    done = [r for r in rids if len(results.get(r, [])) == new_tokens
            and all(0 <= t < cfg.vocab_size for t in results[r])]
    n_out = sum(len(results[r]) for r in rids)
    log(f"[serve] {len(done)}/{len(rids)} requests finished with "
        f"{new_tokens} in-vocab tokens; prompts {prompt_lens.tolist()}; "
        f"{n_out} tokens in {dt:.2f} s = {n_out / dt:.1f} tokens/s "
        f"(+{int(prompt_lens.sum())} prompt tokens), {engine.ticks} ticks, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[serve] launches on this path: paged_decode_attention="
        f"{launches['decode']} ({cfg.n_layers} per decode step: "
        f"{launches['decode'] / cfg.n_layers:.0f} steps), "
        f"paged_prefill_attention={launches['prefill']} ({cfg.n_layers} "
        f"per prefill chunk: {launches['prefill'] / cfg.n_layers:.0f} "
        f"chunks)")
    if len(done) != len(rids):
        raise AssertionError(f"only {len(done)} of {len(rids)} requests "
                             f"finished with in-vocab tokens")
    if not (launches["decode"] > 0 and launches["prefill"] > 0):
        raise AssertionError(f"a kernel was not launched on the serving "
                             f"path: {launches}")
    split = host_split(engine, dt)
    log_host("serve", split)
    compare_logits(torch, cfg, params)
    max_blocks = engine.kv.max_blocks
    del engine
    census = serve_census_passes(torch, model, params, prompts, scfg,
                                 launches, counter)
    sv = {"lens": [int(n) + new_tokens // 2 for n in prompt_lens[:4]],
          "base": [int(n) - int(n) % 32 for n in prompt_lens[:4]],
          "max_blocks": max_blocks, "n_layers": cfg.n_layers,
          "host": split, "prompts": prompts, "scfg": scfg, "first": first,
          "tokens": [results[r] for r in rids], "tok_s": n_out / dt,
          "census": census}
    return launches, n_out / dt, sv, cfg, params


def serve_census_passes(torch, model, params, prompts, scfg, launches,
                        counter):
    """The ``serve`` traffic twice more, untimed, for the instruction
    census of the two paged kernels: once with the wrappers recording
    every call's lengths (``Kernel.record``: reads that wait for the
    card), once under ``torch.profiler`` for their device time.  The
    schedule does not depend on the weights or the timing, so both passes
    launch what the timed run launched.  Returns the kernels' summed
    points (``launch/irm.py``: ``serve_points``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import paged, prefill_paged
    from repro_torch.launch import irm
    from repro_torch.serve.engine import PagedEngine
    kernels = {"decode": paged.KERNEL, "prefill": prefill_paged.KERNEL}

    def drive():
        engine = PagedEngine(model, params, scfg)
        for p in prompts:
            engine.submit(p)
        while engine.busy:
            engine.step()
        torch.cuda.synchronize()

    for k in kernels.values():
        k.record = []
    try:
        drive()
        records = {kind: k.record for kind, k in kernels.items()}
    finally:
        for k in kernels.values():
            k.record = None
    got = {kind: len(r) for kind, r in records.items()}
    log(f"[serve] census passes: {got['decode']} decode and "
        f"{got['prefill']} prefill calls recorded (the timed run: "
        f"{launches['decode']}, {launches['prefill']}); a traced pass of "
        f"the same traffic for their device time")
    if got != launches:
        raise AssertionError(f"the recording pass made {got} calls, the "
                             f"timed run {launches}")
    for attempt in range(irm.TRACE_TRIES):
        # the profiler can drop a share of a trace's launches
        # (irm.app_points): a traced pass that missed some is run again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            drive()
        times = {e.key: (e.device_time_total, e.count)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.device_time_total > 0}
        try:
            points = irm.serve_points(counter, records, times)
            break
        except AssertionError as e:
            if attempt == irm.TRACE_TRIES - 1:
                raise
            log(f"[serve] census: {e}; tracing again")
    for p in points:
        log(f"[serve] census {p.kernel}: [{p.lo}, {p.hi}] warp "
            f"instructions, {p.bytes} bytes, {p.seconds * 1e3:.4f} ms of "
            f"device time in the traced pass")
    return points


def drive_recorded(engine, on_tick=None):
    """Steps ``engine`` until it drains.  Records each request's logits
    behind its first output token (the prefill chunk that drained its
    prompt, or the decode step that fed its last prompt token) as (rid,
    0), and behind its second (the decode step, or the verify's position
    0, that fed its first output) as (rid, 1).  ``on_tick(engine)`` runs
    after every tick.  Returns (logits, seconds in step(), ticks whose
    plan granted decode steps)."""
    from repro_torch.models import transformer
    model, rec, at = engine.model, {}, {}
    prefill_step, decode_step = (model.prefill_step_paged,
                                 model.decode_step_paged)
    lm_prefill = transformer.lm_prefill_paged

    def prefill_rec(*args):
        out, cache = prefill_step(*args)
        rec["prefill"] = out
        return out, cache

    def decode_rec(*args):
        out, cache = decode_step(*args)
        rec["decode"].append(out)
        return out, cache

    def verify_rec(*args, **kwargs):             # every position's logits
        out, cache = lm_prefill(*args, **kwargs)
        if kwargs.get("unembed_all"):
            rec["verify"] = out
        return out, cache

    plan = engine.scheduler.plan

    def plan_rec(slots, kv, *args, **kwargs):
        p = plan(slots, kv, *args, **kwargs)
        at["plan"] = p
        at["slots"] = [(s.rid, len(s.out), len(s.forced), s.prompt_left)
                       if s.active else None for s in slots]
        return p

    model.prefill_step_paged, model.decode_step_paged = (prefill_rec,
                                                         decode_rec)
    engine.scheduler.plan = plan_rec
    transformer.lm_prefill_paged = verify_rec
    logits, step_s, decode_ticks = {}, 0.0, 0
    try:
        while engine.busy:
            rec.clear()
            rec["decode"] = []
            at.clear()
            t0 = time.perf_counter()
            engine.step()
            step_s += time.perf_counter() - t0
            if on_tick is not None:
                on_tick(engine)
            if "plan" not in at:
                continue                         # no device work
            p = at["plan"]
            decode_ticks += bool(p.steps.any())
            for i, st in enumerate(at["slots"]):
                if st is None:
                    continue
                rid, n_out, n_forced, left = st
                g, si = int(p.prefill[i]), int(p.steps[i])
                if n_out == 0 and g and left - g <= 0:
                    logits[(rid, 0)] = rec["prefill"][i].float().clone()
                elif n_out == 0 and si > n_forced:
                    logits[(rid, 0)] = \
                        rec["decode"][n_forced][i].float().clone()
                elif n_out == 1 and si:
                    src = rec["verify"][i, 0] if "verify" in rec \
                        else rec["decode"][0][i]
                    logits[(rid, 1)] = src.float().clone()
    finally:
        transformer.lm_prefill_paged = lm_prefill
    return logits, step_s, decode_ticks


def ulp_check(phase, what, got, want):
    """``got`` within LOGIT_ULPS bf16 ulps of ``want``'s scale; logs and
    returns (max|diff|, bound), raises past the bound."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    lim = LOGIT_ULPS * 2.0 ** -8 * scale
    log(f"[{phase}] {what}: max|diff|={err:.4e}, bound {lim:.4e} "
        f"({LOGIT_ULPS} bf16 ulps of the logit scale {scale:.3f}); argmax "
        f"{'agrees' if got.argmax() == want.argmax() else 'differs'}")
    if not err <= lim:
        raise AssertionError(f"{phase}: {what} drift {err:.4e} > {lim:.4e}")
    return err, lim


def by_decode_phase(torch, cfg, params, sv, decode_kernel, prefill_kernel):
    """The serve phase's requests with ``prefill_lane=False``: every
    prompt token rides the decode loop as a forced token.  Hard checks:
    in-vocab tokens, the decode kernel launched and the prefill kernel
    not, forced bytes uploaded and no lane bytes, and each request's
    first-token logits within 8 bf16 ulps of the lane's."""
    import dataclasses

    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine
    new_tokens = sv["scfg"].max_new_tokens
    engine = PagedEngine(get_model(cfg), params,
                         dataclasses.replace(sv["scfg"], prefill_lane=False))
    rids = [engine.submit(p) for p in sv["prompts"]]
    decode_kernel.launches = 0                   # counts of this path
    prefill_kernel.launches = 0
    first, step_s, _ = drive_recorded(engine)
    torch.cuda.synchronize()
    launches = {"decode": decode_kernel.launches,
                "prefill": prefill_kernel.launches}
    tokens = [engine.results[r] for r in rids]
    n_out = sum(len(t) for t in tokens)
    tok_s = n_out / step_s
    split = host_split(engine, step_s)
    same = sum(a == b for a, b in zip(tokens, sv["tokens"]))
    log(f"[by-decode] granite-8b, the serve phase's 8 requests with "
        f"prefill_lane=False (prompts fed through the decode loop, "
        f"{engine._chunk} steps a tick): {n_out} tokens in {step_s:.2f} s "
        f"of step() = {tok_s:.1f} tokens/s against serve's "
        f"{sv['tok_s']:.1f}; {engine.ticks} ticks; forced_upload_bytes="
        f"{engine.forced_upload_bytes}, prefill_upload_bytes="
        f"{engine.prefill_upload_bytes}; {same}/8 requests give the lane's "
        f"tokens (bf16: reported, not required); on {gpu_line()}")
    log(f"[by-decode] launches on this path: paged_decode_attention="
        f"{launches['decode']} ({launches['decode'] / cfg.n_layers:.0f} "
        f"steps of {cfg.n_layers} layers), paged_prefill_attention="
        f"{launches['prefill']}")
    log_host("by-decode", split)
    if not all(len(t) == new_tokens and all(0 <= x < cfg.vocab_size
                                            for x in t) for t in tokens):
        raise AssertionError(f"by-decode: a request lacks {new_tokens} "
                             f"in-vocab tokens")
    if not (launches["decode"] > 0 and launches["prefill"] == 0):
        raise AssertionError(f"by-decode: the decode kernel must run and "
                             f"the prefill kernel must not: {launches}")
    if not (engine.forced_upload_bytes > 0
            and engine.prefill_upload_bytes == 0):
        raise AssertionError("by-decode: prompts did not go up as forced "
                             "tokens only")
    worst = 0.0
    for r in rids:
        err, lim = ulp_check("by-decode", f"request {r} first-token logits "
                             f"against the lane's", first[(r, 0)],
                             sv["first"][(r, 0)])
        worst = max(worst, err / lim)
    return dict(tok_s=tok_s, host=split, launches=launches, same=same,
                worst=worst, ticks=engine.ticks)


SPEC_K = 4


def first_layers(blocks, n):
    """Views of the first ``n`` layers of a stacked block tree."""
    if isinstance(blocks, dict):
        return {k: first_layers(v, n) for k, v in blocks.items()}
    return blocks[:n]


def spec_phase(torch, cfg, params, sv, decode_kernel, prefill_kernel):
    """The serve phase's requests with ``spec_k=4`` and two drafts: the
    target's first 4 layers (views), and, as a ceiling for the machinery,
    layer 1 of a doctored target whose layers 2-36 have zeroed ``wo`` and
    ``w_down`` (so they add nothing and the draft predicts the target).
    Hard checks: 32 in-vocab tokens each; ``kv.check()`` and
    ``dkv.check()`` every tick; both paged kernels launched; one verify
    call per tick with decode grants; the doctored run's accept rate
    above 0.5; one request's verify logits at its first decode position
    within 8 bf16 ulps of the serve phase's plain decode step's."""
    import dataclasses

    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine
    new_tokens = sv["scfg"].max_new_tokens
    scfg = dataclasses.replace(sv["scfg"], spec_k=SPEC_K)
    blocks = params["blocks"]

    def zeroed_past_layer_1(t):
        z = torch.zeros_like(t)
        z[0] = t[0]
        return z

    def doctored():
        return dict(params, blocks=dict(
            blocks,
            attn=dict(blocks["attn"],
                      wo=zeroed_past_layer_1(blocks["attn"]["wo"])),
            ffn=dict(blocks["ffn"],
                     w_down=zeroed_past_layer_1(blocks["ffn"]["w_down"]))))

    def on_tick(e):
        e.kv.check()
        e.dkv.check()
        for i, slot in enumerate(e.slots):
            if slot.active and len(slot.history) != int(e.kv.length[i]):
                raise AssertionError(f"spec: slot {i} history/length drift")

    out = {}
    for name, n_draft in (("slice", 4), ("doctored", 1)):
        target = params if name == "slice" else doctored()
        engine = PagedEngine(
            get_model(cfg), target, scfg,
            draft_model=get_model(dataclasses.replace(cfg,
                                                      n_layers=n_draft)),
            draft_params=dict(params, blocks=first_layers(blocks, n_draft)))
        rids = [engine.submit(p) for p in sv["prompts"]]
        decode_kernel.launches = 0               # counts of this path
        prefill_kernel.launches = 0
        logits, step_s, decode_ticks = drive_recorded(engine, on_tick)
        torch.cuda.synchronize()
        launches = {"decode": decode_kernel.launches,
                    "prefill": prefill_kernel.launches}
        tokens = [engine.results[r] for r in rids]
        n_out = sum(len(t) for t in tokens)
        split = host_split(engine, step_s)
        ticks = len(engine.draft_dispatch_trace)
        same = sum(a == b for a, b in zip(tokens, sv["tokens"]))
        log(f"[spec] {name} draft ({n_draft} layer{'s' * (n_draft > 1)}"
            + (", target layers 2-36 with zeroed wo and w_down" if
               name == "doctored" else "")
            + f"), spec_k {SPEC_K}: accept rate {engine.accept_rate:.4f} "
            f"({engine.spec_accepted}/{engine.spec_proposed}), "
            f"{engine.spec_trunc_tokens} rows truncated; {n_out} tokens in "
            f"{step_s:.2f} s of step() = {n_out / step_s:.1f} tokens/s "
            f"against serve's {sv['tok_s']:.1f}; {engine.ticks} ticks, "
            f"{decode_ticks} with decode grants; draft dispatches per busy "
            f"tick {engine.draft_dispatches / ticks:.2f}, verify "
            f"{engine.verify_dispatches / ticks:.2f}; {same}/8 requests "
            + ("give serve's tokens (bf16: reported, not required)"
               if name == "slice" else "give serve's tokens (another "
               "target)") + f"; on {gpu_line()}")
        log(f"[spec] {name} launches: paged_decode_attention="
            f"{launches['decode']} (the draft's propose steps), "
            f"paged_prefill_attention={launches['prefill']} (lane chunks, "
            f"draft catch-up, verifies)")
        log_host(f"spec {name}", split)
        if not all(len(t) == new_tokens and all(0 <= x < cfg.vocab_size
                                                for x in t) for t in tokens):
            raise AssertionError(f"spec {name}: a request lacks "
                                 f"{new_tokens} in-vocab tokens")
        if not (launches["decode"] > 0 and launches["prefill"] > 0):
            raise AssertionError(f"spec {name}: a kernel was not launched: "
                                 f"{launches}")
        if not (engine.verify_dispatches == decode_ticks
                and set(engine.verify_dispatch_trace) <= {0, 1}):
            raise AssertionError(f"spec {name}: {engine.verify_dispatches} "
                                 f"verify calls over {decode_ticks} decode "
                                 f"ticks")
        if name == "doctored" and not engine.accept_rate > 0.5:
            raise AssertionError(f"spec doctored: accept rate "
                                 f"{engine.accept_rate:.4f} <= 0.5")
        if name == "slice":
            r = rids[0]
            ulp_check("spec", f"request {r}'s verify logits at its first "
                      f"decode position (prefill kernel, T={SPEC_K + 1}) "
                      f"against serve's decode step", logits[(r, 1)],
                      sv["first"][(r, 1)])
        out[name] = dict(accept=engine.accept_rate, tok_s=n_out / step_s,
                         host=split, launches=launches, same=same,
                         draft_per_tick=engine.draft_dispatches / ticks,
                         verify_per_tick=engine.verify_dispatches / ticks)
        del engine, target
        torch.cuda.empty_cache()
    return out


SHARE_PAGE, SHARE_CHUNK = 16, 32


def share_traffic(rng, vocab):
    """The share phase's traffic: a 200-token system prompt (12 pages and
    8 tokens) behind 8 tails of 16-120 tokens, then a second wave that
    repeats 4 of the first wave's prompts exactly."""
    import numpy as np
    sys_prompt = rng.randint(0, vocab, size=200)
    first = [np.concatenate([sys_prompt, rng.randint(0, vocab, size=n)])
             .astype("int32") for n in rng.randint(16, 121, size=8)]
    return first, [first[j] for j in (0, 2, 5, 7)]


def serve_waves(torch, cfg, params, waves, new_tokens, *, sharing=True,
                defrag_at=0):
    """Serves ``waves`` of prompts through a fresh ``PagedEngine`` (the
    default ServeConfig at max_batch 4, page 16, prefill chunks of 32,
    or with sharing and retention off), each wave submitted after the
    last drained.  Records every request's first-token logits (the
    prefill-lane chunk that drained its prompt) and how it was admitted;
    checks ``kv.check()`` and the prefix index after every tick; calls
    ``defrag()`` once after tick ``defrag_at`` (0: never).  Returns a
    dict of the results, counters and the time spent in ``step()``."""
    import dataclasses

    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    longest = max(len(p) for w in waves for p in w)
    scfg = ServeConfig(max_batch=4, max_seq=longest + new_tokens + 16,
                       max_new_tokens=new_tokens, page_size=SHARE_PAGE,
                       prefill_chunk_tokens=SHARE_CHUNK)
    if not sharing:
        scfg = dataclasses.replace(scfg, prefix_sharing=False,
                                   retain_prefixes=False)
    engine = PagedEngine(get_model(cfg), params, scfg)
    model, rec, kinds, first = engine.model, {}, {}, {}
    prefill_step = model.prefill_step_paged

    def capture(*args):
        logits, cache = prefill_step(*args)
        rec["logits"] = logits
        return logits, cache

    model.prefill_step_paged = capture
    find = engine._find_donor

    def recording_find(prompt):
        kind, ref, n = find(prompt)
        kinds[engine.queue[0].rid] = (kind, n)
        return kind, ref, n

    engine._find_donor = recording_find
    rids, step_s = [], 0.0
    for wave in waves:
        rids.append([engine.submit(p) for p in wave])
        while engine.busy:
            rec.clear()
            t0 = time.perf_counter()
            engine.step()
            step_s += time.perf_counter() - t0
            for i, slot in enumerate(engine.slots):
                if slot.active and len(slot.out) == 1 \
                        and slot.rid not in first:
                    first[slot.rid] = rec["logits"][i].float().clone()
            engine.kv.check()
            engine._pindex.check(engine.slots)
            for i, slot in enumerate(engine.slots):
                if slot.active and len(slot.history) != \
                        int(engine.kv.length[i]):
                    raise AssertionError(f"slot {i}: history/length drift")
            if defrag_at and engine.ticks == defrag_at:
                engine.defrag()
                engine.kv.check()
    torch.cuda.synchronize()
    return dict(engine=engine, rids=rids, kinds=kinds, first=first,
                tokens=[[engine.results[r] for r in w] for w in rids],
                step_s=step_s)


def share_phase(torch, cfg, params, decode_kernel, prefill_kernel):
    """granite-8b (the serve phase's weights) through ``PagedEngine`` with
    the JAX engine's default sharing configuration: live shares from a
    mid-page base, copy on write, retained adoptions after the donors
    died, a defrag mid-run.  Returns the phase's readings."""
    import numpy as np
    new_tokens = 32
    waves = share_traffic(np.random.RandomState(29), cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    decode_kernel.launches = 0                   # counts of this path
    prefill_kernel.launches = 0
    run = serve_waves(torch, cfg, params, waves, new_tokens)
    launches = {"decode": decode_kernel.launches,
                "prefill": prefill_kernel.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng = run["engine"]
    n_out = sum(len(t) for w in run["tokens"] for t in w)
    tok_s = n_out / run["step_s"]
    chunks = launches["prefill"] // cfg.n_layers
    log(f"[share] granite-8b, default ServeConfig (sharing and retention "
        f"on), max_batch 4, page {SHARE_PAGE}, prefill chunks of "
        f"{SHARE_CHUNK}: 8 prompts of {[len(p) for p in waves[0]]} tokens "
        f"(a 200-token system prompt), then 4 exact repeats after the "
        f"drain; {n_out} tokens in {run['step_s']:.2f} s of step() = "
        f"{tok_s:.1f} tokens/s (host clock), {eng.ticks} ticks, peak "
        f"memory {peak:.2f} GiB")
    log(f"[share] shared {eng.shared_tokens} prompt tokens (logical/"
        f"physical x{eng.logical_physical_ratio:.3f}), {eng.kv.cow_copies} "
        f"COW copies in {eng.kv.cow_dispatches} flushes, "
        f"{eng.kv.retained_hits} retained adoptions "
        f"({eng.kv.retained_hit_tokens} tokens), {eng.kv.retained_pages} "
        f"pages retained at the end; admissions "
        + ", ".join(f"{r}:{k or 'none'}/{n}" for r, (k, n) in
                    sorted(run["kinds"].items())))
    log(f"[share] launches on this path: paged_decode_attention="
        f"{launches['decode']}, paged_prefill_attention="
        f"{launches['prefill']} ({chunks} chunks of {cfg.n_layers} layers)")
    split = host_split(eng, run["step_s"])
    log_host("share", split)
    bad = [t for w in run["tokens"] for t in w
           if len(t) != new_tokens or not all(0 <= x < cfg.vocab_size
                                              for x in t)]
    if bad:
        raise AssertionError(f"share: {len(bad)} requests without "
                             f"{new_tokens} in-vocab tokens")
    if not (launches["decode"] > 0 and launches["prefill"] > 0):
        raise AssertionError(f"share: a kernel was not launched: {launches}")
    if not (eng.shared_tokens > 0 and eng.kv.cow_copies > 0
            and eng.kv.retained_hits > 0):
        raise AssertionError("share: no sharing, copy on write or retained "
                             "adoption happened")

    decode_kernel.launches = prefill_kernel.launches = 0
    off = serve_waves(torch, cfg, params, waves, new_tokens, sharing=False)
    off_chunks = prefill_kernel.launches // cfg.n_layers
    off_launches = prefill_kernel.launches
    same = sum(a == b for a, b in zip(sum(off["tokens"], []),
                                      sum(run["tokens"], [])))
    log(f"[share] the same traffic with sharing off: {off_chunks} prefill "
        f"chunks ({off_launches} launches) against {chunks} with sharing; "
        f"{same}/12 requests give the same tokens (bf16: sharing changes "
        f"the batches' rounding, so this is reported, not required)")
    if not chunks < off_chunks:
        raise AssertionError(f"share: {chunks} prefill chunks with sharing, "
                             f"not fewer than {off_chunks} without")
    del off

    rid_of = {r: (w, j) for w, ids in enumerate(run["rids"])
              for j, r in enumerate(ids)}
    sharer = next(r for r, (k, n) in sorted(run["kinds"].items())
                  if k == "live" and n % SHARE_PAGE)
    adopter = next(r for r, (k, n) in sorted(run["kinds"].items())
                   if k == "retained")
    for name, rid in (("live sharer", sharer), ("retained adopter",
                                                adopter)):
        w, j = rid_of[rid]
        alone = serve_waves(torch, cfg, params, [[waves[w][j]]], new_tokens,
                            sharing=False)
        kind, n = run["kinds"][rid]
        ulp_check("share", f"{name} (request {rid}, {n} tokens {kind}) "
                  f"first-token logits against its prompt served alone with "
                  f"sharing off", run["first"][rid],
                  alone["first"][alone["rids"][0][0]])
        del alone

    mid = eng.ticks // 3
    redo = serve_waves(torch, cfg, params, waves, new_tokens, defrag_at=mid)
    worst = max((redo["first"][r] - run["first"][r]).abs().max().item()
                for r in (sharer, adopter))
    log(f"[share] the same traffic with one defrag() after tick {mid}: "
        f"tokens {'unchanged' if redo['tokens'] == run['tokens'] else 'CHANGED'}"
        f", sharer's and adopter's first-token logits max|diff|={worst:.3e}")
    if redo["tokens"] != run["tokens"] or worst != 0.0:
        raise AssertionError("share: defrag changed the tokens or logits")
    return dict(tok_s=tok_s, shared=eng.shared_tokens,
                ratio=eng.logical_physical_ratio, cow=eng.kv.cow_copies,
                hits=eng.kv.retained_hits, peak=peak, chunks=chunks,
                off_chunks=off_chunks, launches=launches, host=split,
                tokens=sum(run["tokens"], []),
                status=[eng.status[r].value for w in run["rids"] for r in w])


# ---------------------------------------------------------------------------
# recover: snapshots and kill-and-recover
# ---------------------------------------------------------------------------

RECOVER_EVERY = 4                # ticks between snapshots


def run_gated(engine, work, gate, on_tick=None):
    """Steps ``engine`` until every request of ``work`` ((prompt, budget)
    pairs, submitted in order) is served, submitting request i once
    ``gate(engine, i)`` holds.  ``engine._next_rid`` is the submission
    cursor, so an engine restored from a snapshot resubmits exactly the
    requests its snapshot does not hold.  Returns the seconds in
    ``step()``."""
    step_s = 0.0
    while True:
        while engine._next_rid < len(work) and gate(engine,
                                                    engine._next_rid):
            p, b = work[engine._next_rid]
            engine.submit(p, b)
        if not engine.busy and engine._next_rid >= len(work) \
                and not engine._squeezed:
            return step_s
        t0 = time.perf_counter()
        engine.step()
        step_s += time.perf_counter() - t0
        if on_tick is not None:
            on_tick(engine)


def drive_with_recovery(mk, work, gate, plan, snap_dir, on_tick=None,
                        on_restore=None):
    """tests/test_snapshot_props.py's recovery protocol: on
    ``EngineKilled`` the dead engine is dropped (its pools go back to the
    allocator), a fresh one from ``mk()`` restores the newest intact
    snapshot (or starts cold) and is armed with the plan less the kills
    fired so far.  ``on_restore(killed tick, engine, restore s, kill
    time)`` runs after each restore, the kill time on the host clock.
    Returns (engine, kills, restores)."""
    from repro_torch.serve import snapshot
    from repro_torch.serve.faults import EngineKilled
    engine = mk()
    engine.install_faults(plan)
    kills = restores = 0
    while True:
        try:
            run_gated(engine, work, gate, on_tick)
            return engine, kills, restores
        except EngineKilled as e:
            tick, t_kill = e.tick, time.perf_counter()
        kills += 1
        if kills >= 10:
            raise AssertionError("kill storm: recovery never converged")
        del engine
        latest = snapshot.latest_snapshot(snap_dir)
        engine = mk()
        t0 = time.perf_counter()
        if latest is not None:
            snapshot.restore_engine(engine, latest)
            restores += 1
        restore_s = time.perf_counter() - t0
        plan = plan.without_kills_through(tick)
        engine.install_faults(plan)
        if on_restore is not None:
            on_restore(tick, engine, restore_s, t_kill)


def engine_checks(engine) -> None:
    """The per-tick invariants: the pools, the prefix index, history ==
    length."""
    engine.kv.check()
    if engine.dkv is not None:
        engine.dkv.check()
    engine._pindex.check(engine.slots)
    for i, slot in enumerate(engine.slots):
        if slot.active and len(slot.history) != int(engine.kv.length[i]):
            raise AssertionError(f"slot {i}: history/length drift")


def pick_kills(trace):
    """Two kill ticks from an uninterrupted run's per-tick trace (tick ->
    (a page shared, COW copies, retained adoptions, second wave
    submitted, busy) at its end).  The first: in the first wave, one
    tick past the last copy on write of a snapshot's interval, with a
    page shared: the restored engine replays the live shares and makes
    the copies again.  The second: three ticks after a snapshot of the
    repeats that holds a retained adoption."""
    last = max(trace)
    first = second = None
    for s in range(RECOVER_EVERY, last + 1, RECOVER_EVERY):
        _, _, hits, wave2, busy = trace[s]
        if first is None and not wave2:
            cows = [u for u in range(s + 1, min(s + RECOVER_EVERY, last + 1))
                    if trace[u][1] > trace[u - 1][1] and trace[u][0]
                    and not trace[u][3]]
            first = cows[-1] + 1 if cows else None
        if second is None and wave2 and hits and busy and s + 3 <= last:
            second = s + 3
    if first is None or second is None:
        raise AssertionError(f"recover: no kill ticks found "
                             f"({first}, {second}) over {last} ticks")
    return first, second


def recover_phase(torch, cfg, params, share, decode_kernel, prefill_kernel):
    """The share phase's model, weights, traffic and ServeConfig with a
    snapshot every 4 ticks: served once uninterrupted, then with two
    kills, each recovered from the newest snapshot into a fresh engine on
    the same parameters.  Both runs give the share phase's tokens,
    statuses and sharing counters, bit for bit.  Returns the readings."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.models.model import get_model
    from repro_torch.serve import snapshot
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    from repro_torch.serve.faults import FaultEvent, FaultPlan
    new_tokens = 32
    waves = share_traffic(np.random.RandomState(29), cfg.vocab_size)
    work = [(p, new_tokens) for w in waves for p in w]
    n_first = len(waves[0])

    def gate(engine, i):                 # the second wave after the drain
        return i != n_first or not engine.busy

    longest = max(len(p) for p, _ in work)
    model = get_model(cfg)
    with tempfile.TemporaryDirectory(prefix="recover-") as tmp:
        def mk(snap_dir):
            return lambda: PagedEngine(model, params, ServeConfig(
                max_batch=4, max_seq=longest + new_tokens + 16,
                max_new_tokens=new_tokens, page_size=SHARE_PAGE,
                prefill_chunk_tokens=SHARE_CHUNK,
                snapshot_every_ticks=RECOVER_EVERY, snapshot_dir=snap_dir))

        # uninterrupted, snapshots on: their cost, and the kill ticks
        save, save_ms, trace = snapshot.save_snapshot, [], {}

        def timed_save(engine, path):
            t0 = time.perf_counter()
            out = save(engine, path)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def record(engine):
            engine_checks(engine)
            trace[engine.ticks] = (
                bool((engine.kv.refcount > 1).any()), engine.kv.cow_copies,
                engine.kv.retained_hits, engine._next_rid > n_first,
                engine.busy)

        snapshot.save_snapshot = timed_save
        try:
            eng = mk(os.path.join(tmp, "whole"))()
            trace[0] = (False, 0, 0, False, False)
            step_s = run_gated(eng, work, gate, record)
        finally:
            snapshot.save_snapshot = save
        torch.cuda.synchronize()
        newest = snapshot.latest_snapshot(os.path.join(tmp, "whole"))
        nbytes = os.path.getsize(newest)
        whole = dict(tokens=[eng.results[r] for r in range(len(work))],
                     status=[eng.status[r].value for r in range(len(work))],
                     counts=(eng.shared_tokens, eng.kv.cow_copies,
                             eng.kv.retained_hits),
                     written=eng.snapshots_written, ticks=eng.ticks,
                     page_bytes=eng.kv.page_bytes,
                     num_pages=eng.kv.num_pages)
        n_out = sum(len(t) for t in whole["tokens"])
        tok_s = n_out / step_s
        del eng
        kills = pick_kills(trace)

        # the kills: the main path of this phase
        snap_dir = os.path.join(tmp, "killed")
        restored, pending = [], {}

        def on_restore(tick, engine, restore_s, t_kill):
            restored.append(dict(killed=tick, tick=engine.ticks,
                                 replayed=tick - 1 - engine.ticks,
                                 restore_ms=restore_s * 1e3))
            pending["t0"] = t_kill

        def on_tick(engine):
            engine_checks(engine)
            if "t0" in pending:          # the restored engine's first tick
                torch.cuda.synchronize()
                restored[-1]["recover_s"] = \
                    time.perf_counter() - pending.pop("t0")

        decode_kernel.launches = 0       # counts of this phase's path
        prefill_kernel.launches = 0
        eng, n_kills, n_restores = drive_with_recovery(
            mk(snap_dir), work, gate,
            FaultPlan([FaultEvent(t, "kill") for t in kills]), snap_dir,
            on_tick, on_restore)
        torch.cuda.synchronize()
        launches = {"decode": decode_kernel.launches,
                    "prefill": prefill_kernel.launches}
        got = dict(tokens=[eng.results[r] for r in range(len(work))],
                   status=[eng.status[r].value for r in range(len(work))],
                   counts=(eng.shared_tokens, eng.kv.cow_copies,
                           eng.kv.retained_hits))

        # a truncated copy of the newest file is refused and skipped
        newest = snapshot.latest_snapshot(snap_dir)
        with open(newest, "rb") as f:
            blob = f.read()
        cut_path = snapshot.snapshot_path(
            snap_dir, snapshot.load_header(newest)["tick"] + 1)
        refused = []
        for cut in (24, len(blob) // 2, len(blob) - 3):
            with open(cut_path, "wb") as f:
                f.write(blob[:cut])
            try:
                snapshot.load_snapshot(cut_path)
            except snapshot.SnapshotCorruptError:
                refused.append(snapshot.latest_snapshot(snap_dir) == newest)
        os.remove(cut_path)
        del blob, eng

    gpu = gpu_line()
    share_counts = (share["shared"], share["cow"], share["hits"])
    log(f"[recover] granite-8b, the share phase's traffic and ServeConfig "
        f"with a snapshot every {RECOVER_EVERY} ticks: {nbytes} B a "
        f"snapshot ({whole['num_pages']} pages x {whole['page_bytes']} B "
        f"of K/V and the host state); {whole['written']} snapshots over "
        f"{whole['ticks']} ticks, save ms median "
        f"{float(np.median(save_ms)):.1f} max {max(save_ms):.1f} (D2H "
        f"copy, CRC32, write, fsync); {n_out} tokens in {step_s:.2f} s of "
        f"step() = {tok_s:.1f} tokens/s with snapshots on against the "
        f"share phase's {share['tok_s']:.1f}; on {gpu}")
    for r in restored:
        log(f"[recover] kill at tick {r['killed']}: restored tick "
            f"{r['tick']} in {r['restore_ms']:.1f} ms, {r['replayed']} "
            f"ticks replayed, {r.get('recover_s', float('nan')):.3f} s from "
            f"the kill to the restored engine's first finished tick; on "
            f"{gpu}")
    same = sum(a == b for a, b in zip(got["tokens"], share["tokens"]))
    log(f"[recover] kills at ticks {list(kills)}: {n_kills} fired, "
        f"{n_restores} restores; {same}/{len(work)} requests bit-identical "
        f"to the share phase's run (uninterrupted with snapshots: "
        f"{sum(a == b for a, b in zip(whole['tokens'], share['tokens']))}"
        f"/{len(work)}); statuses {sorted(set(got['status']))}; (shared "
        f"tokens, COW copies, retained adoptions) {got['counts']}, share "
        f"{share_counts}; launches paged_decode_attention="
        f"{launches['decode']}, paged_prefill_attention="
        f"{launches['prefill']}; truncated copies refused and skipped "
        f"{sum(refused)}/3")
    if n_kills != 2 or n_restores != 2 or len(restored) != 2:
        raise AssertionError(f"recover: {n_kills} kills, {n_restores} "
                             f"restores from a snapshot, not 2 and 2")
    for run, name in ((whole, "uninterrupted"), (got, "recovered")):
        if run["tokens"] != share["tokens"] \
                or run["status"] != share["status"] \
                or run["counts"] != share_counts:
            raise AssertionError(f"recover: the {name} run differs from "
                                 f"the share phase's")
    if not (launches["decode"] > 0 and launches["prefill"] > 0):
        raise AssertionError(f"recover: a kernel was not launched: "
                             f"{launches}")
    if refused != [True] * 3:
        raise AssertionError(f"recover: a truncated snapshot was not "
                             f"refused and skipped: {refused}")
    return dict(bytes=nbytes, save_med=float(np.median(save_ms)),
                save_max=max(save_ms), tok_s=tok_s,
                written=whole["written"], restored=restored,
                launches=launches)


# ---------------------------------------------------------------------------
# overload: preempt-and-recompute, deadlines, queue bound, cancel, faults
# ---------------------------------------------------------------------------

# 40 allocatable pages of 16 rows (2.36 MB each at granite-8b's width):
# under half of what four slots' full tables need, so the pool oversells
OVERLOAD_CFG = dict(max_batch=4, page_size=16, prefill_chunk_tokens=32,
                    max_seq=512, num_pages=41, max_new_tokens=48,
                    max_queue=6)
OVERLOAD_BURST2 = 10     # the second burst is submitted before this tick
OVERLOAD_DEADLINE = 58   # ticks: the second burst's first request's budget
OVERLOAD_CANCEL = 20     # from this tick: cancel a running request
OVERLOAD_FAULTS = ((12, "squeeze", dict(pages=6, duration=4)),
                   (24, "evict", {}), (28, "drop", {}),
                   (33, "poison", {}))


def host_split(engine, step_s: float) -> dict:
    """The engine's per-tick host traces: median and p90 of
    ``host_ms_trace``, the means of ``dispatch_trace`` and
    ``upload_trace``, and the traces' host time as a share of
    ``step_s``, the time the phase spent in ``step()`` (the rest is the
    wait for the device)."""
    import numpy as np
    h = engine.host_ms_trace
    return dict(ticks=len(h), med=float(np.median(h)),
                p90=float(np.percentile(h, 90)),
                disp=float(np.mean(engine.dispatch_trace)),
                up=float(np.mean(engine.upload_trace)),
                share=sum(h) / 1e3 / step_s, step_s=step_s)


def log_host(phase: str, s: dict) -> None:
    log(f"[{phase}] per-tick host split over {s['ticks']} busy ticks: "
        f"host_ms_trace median {s['med']:.3f} ms, p90 {s['p90']:.3f} ms, "
        f"{100 * s['share']:.1f}% of the {s['step_s']:.2f} s in step(); "
        f"dispatch_trace mean {s['disp']:.2f} device calls; upload_trace "
        f"mean {s['up']:.1f} B; on {gpu_line()}")


def overload_traffic(rng, vocab):
    """11 prompts of 150-300 tokens: 7 in the first burst (the 7th past
    ``max_queue``), 4 in the second."""
    return [rng.randint(0, vocab, size=n).astype("int32")
            for n in rng.randint(150, 301, size=11)]


def drive_overload(torch, cfg, params, prompts, *, num_pages, faults,
                   lifecycle, want=(), kv_dtype=None):
    """Serves ``prompts`` through a fresh ``PagedEngine`` at
    ``OVERLOAD_CFG`` with ``num_pages`` (0: every slot's full table): the
    first 7 at once, the rest before tick ``OVERLOAD_BURST2``.  ``faults``
    arms ``OVERLOAD_FAULTS``; ``lifecycle`` gives the second burst's first
    request a deadline and cancels a running request from tick
    ``OVERLOAD_CANCEL``.  ``kv.check()`` and the prefix index's check run
    after every tick.  Records the logits behind output token k of
    request r for every (r, k) in ``want`` and, for a resumed request,
    behind its first token after the resume.  Returns a dict of the
    readings."""
    import dataclasses

    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    from repro_torch.serve.faults import FaultEvent, FaultPlan
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    engine = PagedEngine(get_model(cfg), params,
                         ServeConfig(**dict(OVERLOAD_CFG,
                                            num_pages=num_pages)))
    if faults:
        engine.install_faults(FaultPlan([FaultEvent(t, k, **kw)
                                         for t, k, kw in OVERLOAD_FAULTS]))
    model, rec, at, logits, capacity = engine.model, {}, {}, {}, [0]
    prefill_step, decode_step = (model.prefill_step_paged,
                                 model.decode_step_paged)

    def prefill_rec(*args):
        out, cache = prefill_step(*args)
        rec["prefill"] = out
        return out, cache

    def decode_rec(*args):
        out, cache = decode_step(*args)
        rec["decode"].append(out)
        return out, cache

    model.prefill_step_paged, model.decode_step_paged = (prefill_rec,
                                                         decode_rec)
    plan = engine.scheduler.plan

    def plan_rec(slots, kv, *args, **kwargs):
        p = plan(slots, kv, *args, **kwargs)
        reqs = engine._reqs
        at["plan"] = p
        at["slots"] = [(s.rid, len(reqs[s.rid].emitted) + len(s.out),
                        s.prompt_left, reqs[s.rid].preempts)
                       if s.active else None for s in slots]
        return p

    engine.scheduler.plan = plan_rec
    preempt = engine._preempt_for_capacity

    def counting():
        ok = preempt()
        capacity[0] += ok
        return ok

    engine._preempt_for_capacity = counting
    rids = [engine.submit(p) for p in prompts[:7]]
    deadline_rid = cancelled = None
    step_s = 0.0
    while engine.busy or engine._squeezed or len(rids) < len(prompts):
        if len(rids) < len(prompts) and (engine.ticks + 1 >= OVERLOAD_BURST2
                                         or not engine.busy):
            for j, p in enumerate(prompts[7:]):
                dl = OVERLOAD_DEADLINE if lifecycle and j == 0 else None
                rids.append(engine.submit(p, deadline_ticks=dl))
            deadline_rid = rids[7] if lifecycle else None
        if lifecycle and cancelled is None \
                and engine.ticks + 1 >= OVERLOAD_CANCEL:
            victim = next((s.rid for s in engine.slots if s.active and s.out
                           and s.rid != deadline_rid), None)
            if victim is not None:
                if not engine.cancel(victim):
                    raise AssertionError(f"overload: cancel({victim}) of a "
                                         f"running request refused")
                cancelled = victim
        rec.clear()
        rec["decode"] = []
        at.clear()
        t0 = time.perf_counter()
        engine.step()
        step_s += time.perf_counter() - t0
        engine.kv.check()
        engine._pindex.check(engine.slots)
        for i, slot in enumerate(engine.slots):
            if slot.active and len(slot.history) != int(engine.kv.length[i]):
                raise AssertionError(f"overload: slot {i} history/length "
                                     f"drift")
        if engine.ticks > 2000:
            raise AssertionError("overload: the engine did not drain")
        if "plan" not in at:
            continue                     # the tick ran no device work
        p = at["plan"]
        for i, st in enumerate(at["slots"]):
            if st is None:
                continue
            rid, k, left, preempts = st
            g = int(p.prefill[i])
            if g and left - g <= 0 and (
                    (rid, k) in want or (preempts and k)):
                logits[(rid, k)] = rec["prefill"][i].float().clone()
            for s in range(int(p.steps[i])):
                if (rid, k + s) in want:
                    logits[(rid, k + s)] = rec["decode"][s][i].float().clone()
    if params["embed"].device.type == "cuda":
        torch.cuda.synchronize()
    return dict(engine=engine, rids=rids, logits=logits,
                capacity=capacity[0], step_s=step_s,
                deadline_rid=deadline_rid, cancelled=cancelled)


def overload_checks(run, vocab, new_tokens):
    """The overload phase's hard checks on one run; raises on a miss."""
    from repro_torch.serve.engine import TERMINAL_STATUSES, RequestStatus
    eng, rids = run["engine"], run["rids"]
    st = [eng.status[r] for r in rids]
    bad = [r for r, s in zip(rids, st) if s not in TERMINAL_STATUSES]
    if bad:
        raise AssertionError(f"overload: requests {bad} not terminal")
    kept = [t for r in rids for t in eng.results[r]]
    if not all(0 <= t < vocab for t in kept):
        raise AssertionError("overload: a kept token is out of vocabulary")
    if not (run["capacity"] >= 1 and eng.recompute_tokens > 0
            and RequestStatus.PREEMPTED_RESUMED in st):
        raise AssertionError(f"overload: no capacity preemption and resume "
                             f"({run['capacity']} capacity preemptions, "
                             f"{eng.recompute_tokens} recomputed tokens)")
    done = [r for r in rids if eng.status[r] in
            (RequestStatus.FINISHED, RequestStatus.PREEMPTED_RESUMED)]
    if any(len(eng.results[r]) != new_tokens for r in done):
        raise AssertionError("overload: a finished request lacks tokens")
    eng.kv.check()
    if eng.kv.live_pages != 0 or eng.kv.seized:
        raise AssertionError("overload: pages still live or seized after "
                             "the drain")
    eng.kv.flush_retained()
    eng.kv.check()
    if len(eng.kv.free) != eng.kv.num_pages - 1:
        raise AssertionError(f"overload: {len(eng.kv.free)} free pages "
                             f"after the flush, not {eng.kv.num_pages - 1}")
    return st


def overload_phase(torch, cfg, params, decode_kernel, prefill_kernel):
    """granite-8b (the serve phase's weights, bf16, kernels on) through
    ``PagedEngine`` with a pool under half of what four slots' full tables
    need, two bursts of requests, a queue bound, a deadline, a cancel and
    a fault plan (squeeze, evict, drop, poison); against the same requests
    served uninterrupted; then a short int8 run.  Returns the readings."""
    import numpy as np

    from repro_torch.serve.engine import RequestStatus
    new = OVERLOAD_CFG["max_new_tokens"]
    prompts = overload_traffic(np.random.RandomState(41), cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    decode_kernel.launches = 0                   # counts of this path
    prefill_kernel.launches = 0
    run = drive_overload(torch, cfg, params, prompts,
                         num_pages=OVERLOAD_CFG["num_pages"], faults=True,
                         lifecycle=True)
    launches = {"decode": decode_kernel.launches,
                "prefill": prefill_kernel.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng, rids = run["engine"], run["rids"]
    split = host_split(eng, run["step_s"])
    counts = {s.value: sum(eng.status[r] is s for r in rids)
              for s in RequestStatus}
    tok_s = eng.tokens_out / run["step_s"]
    overhead = eng.recompute_tokens / max(1, eng.tokens_out)
    page_mb = 2 * eng.kv.k[:, 0].numel() * eng.kv.k.element_size() / 1e6
    log(f"[overload] granite-8b, bf16, max_batch 4, page 16, prefill chunks "
        f"of 32, {eng.kv.num_pages - 1} allocatable pages of {page_mb:.2f} "
        f"MB, "
        f"max_queue {OVERLOAD_CFG['max_queue']}: {len(rids)} requests of "
        f"{[len(p) for p in prompts]} prompt tokens, {new} new each, in two "
        f"bursts; {eng.ticks} ticks, peak memory {peak:.2f} GiB; on "
        f"{gpu_line()}")
    log(f"[overload] statuses "
        + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
        + f"; {eng.preemptions} preemptions ({run['capacity']} for capacity"
        f", the rest forced evictions), {eng.recompute_tokens} recomputed "
        f"tokens, {eng.quarantines} quarantines, {eng.dropped_grants} "
        f"dropped grant tokens, faults {eng.fault_counts}, {eng.stalls} "
        f"stalls, {eng.no_progress_ticks} no-progress ticks; rejected: "
        + "; ".join(eng.reject_reason.values()))
    log(f"[overload] {eng.tokens_out} kept tokens in {run['step_s']:.2f} s "
        f"of step() = {tok_s:.1f} tokens/s (host clock); recompute "
        f"overhead recompute_tokens / tokens_out = {overhead:.3f}; on "
        f"{gpu_line()}")
    log(f"[overload] launches on this path: paged_decode_attention="
        f"{launches['decode']}, paged_prefill_attention="
        f"{launches['prefill']}")
    log_host("overload", split)
    st = overload_checks(run, cfg.vocab_size, new)
    if not (eng.quarantines >= 1 and eng.dropped_grants > 0
            and all(eng.fault_counts.get(k) for k in
                    ("squeeze", "evict", "drop", "poison"))):
        raise AssertionError(f"overload: a fault did not act "
                             f"({eng.fault_counts}, {eng.quarantines} "
                             f"quarantines, {eng.dropped_grants} dropped)")
    if counts["rejected"] < 1 or not all(
            "queue full" in why for why in eng.reject_reason.values()):
        raise AssertionError("overload: no submit was rejected queue-full")
    dl, cx = run["deadline_rid"], run["cancelled"]
    if not (eng.status[dl] is RequestStatus.DEADLINE_EXCEEDED
            and 0 < len(eng.results[dl]) < new):
        raise AssertionError(f"overload: request {dl} did not end "
                             f"DEADLINE_EXCEEDED with partial output "
                             f"({eng.status[dl]}, "
                             f"{len(eng.results[dl])} tokens)")
    if cx is None or eng.status[cx] is not RequestStatus.CANCELLED:
        raise AssertionError("overload: no running request was cancelled")
    if not (launches["decode"] > 0 and launches["prefill"] > 0):
        raise AssertionError(f"overload: a kernel was not launched: "
                             f"{launches}")

    # the same requests, uninterrupted: a full pool, no faults, no
    # deadline, no cancel
    resumed = sorted(run["logits"])
    base = drive_overload(torch, cfg, params, prompts, num_pages=0,
                          faults=False, lifecycle=False,
                          want=set(resumed) | {(r, 0) for r in rids[:4]})
    beng = base["engine"]
    done = [r for r in rids if eng.status[r] in
            (RequestStatus.FINISHED, RequestStatus.PREEMPTED_RESUMED)]
    same = sum(eng.results[r] == beng.results[r] for r in done)
    log(f"[overload] against the same requests served uninterrupted (a full "
        f"pool, no faults, no deadline or cancel; {beng.preemptions} "
        f"preemptions there): {same}/{len(done)} finished requests give "
        f"the same tokens (bf16: recompute writes the resumed rows through "
        f"the prefill kernel, so this is reported, not required)")
    match = [(r, k) for r, k in resumed
             if eng.results[r][:k] == beng.results[r][:k]
             and (r, k) in base["logits"]]
    if not match:
        raise AssertionError(f"overload: no resumed request kept the "
                             f"uninterrupted run's tokens up to its resume "
                             f"({resumed})")
    r, k = match[0]
    err, lim = ulp_check(
        "overload", f"resumed request {r}: logits of its first token after "
        f"the resume (output {k}, through the prefill kernel) against the "
        f"uninterrupted run's at the same position (a decode step)",
        run["logits"][(r, k)], base["logits"][(r, k)])

    # int8 pools: the first four requests, the same oversold pool
    q = drive_overload(torch, cfg, params, prompts[:4],
                       num_pages=OVERLOAD_CFG["num_pages"], faults=False,
                       lifecycle=False, want={(r, 0) for r in rids[:4]},
                       kv_dtype="int8")
    qeng = q["engine"]
    qst = overload_checks(q, cfg.vocab_size, new)
    drift = []
    for r in rids[:4]:
        a, b = q["logits"][(r, 0)], base["logits"][(r, 0)]
        drift.append((a - b).abs().max().item() / b.abs().max().item())
    log(f"[overload] int8 pools, the first 4 requests on the same pool: "
        f"statuses {[s.value for s in qst]}, {qeng.preemptions} "
        f"preemptions ({q['capacity']} for capacity), "
        f"{qeng.recompute_tokens} recomputed tokens, kv.check() clean every "
        f"tick; first-token logits against the bf16 run: max|diff| / logit "
        f"scale {', '.join(f'{d:.4f}' for d in drift)} (reported); "
        f"{sum(qeng.results[r] == beng.results[r] for r in rids[:4])}/4 "
        f"requests give the bf16 tokens")
    return dict(tok_s=tok_s, overhead=overhead, split=split, peak=peak,
                launches=launches, preemptions=eng.preemptions,
                capacity=run["capacity"], recompute=eng.recompute_tokens,
                same=same, done=len(done), counts=counts, drift=drift,
                logit_err=err, logit_lim=lim)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def compare_logits(torch, cfg, params, phase="serve"):
    """One prefill chunk and one decode step of the kernel path against
    the plain path, from the same cache (3 chunks of history)."""
    from repro_torch.models.model import get_model
    kern, plain = get_model(cfg), get_model(cfg, plain_attention=True)
    B, T, page, nb = 4, 32, 16, 12
    cache = kern.init_paged_cache(B, nb, page, B * nb + 1, "cuda")
    cache["table"] = torch.arange(1, 1 + B * nb, dtype=torch.int32,
                                  device="cuda").reshape(B, nb)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (B, 4 * T), generator=gen,
                         device="cuda")
    grants = torch.full((B,), T, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        for c in range(3):
            _, cache = kern.prefill_step_paged(params, toks[:, c * T:
                                                            (c + 1) * T],
                                               cache, grants)
        ck = {k: v.clone() for k, v in cache.items()}
        cp = {k: v.clone() for k, v in cache.items()}
        step_ms = {}

        def timed(name, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            step_ms[name] = (time.perf_counter() - t0) * 1e3
            return out

        lk, ck = timed("kernel prefill", kern.prefill_step_paged, params,
                       toks[:, 3 * T:], ck, grants)
        lp, cp = timed("plain prefill", plain.prefill_step_paged, params,
                       toks[:, 3 * T:], cp, grants)
        nxt = lp.argmax(-1).to(torch.int32)[:, None]
        dk, _ = timed("kernel decode", kern.decode_step_paged, params, nxt,
                      ck)
        dp, _ = timed("plain decode", plain.decode_step_paged, params, nxt,
                      cp)
    log(f"[{phase}] one forward ({cfg.n_layers} layers, B=4, host clock, "
        "single shot): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in step_ms.items())
        + " (prefill: T=32 tokens per slot after 96 of history)")
    for name, a, b in (("prefill chunk", lk, lp), ("decode step", dk, dp)):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        lim = LOGIT_ULPS * 2.0 ** -8 * scale
        log(f"[{phase}] {name} logits, kernel vs plain path: max|diff|="
            f"{err:.4e}, bound {lim:.4e} ({LOGIT_ULPS} bf16 ulps of the "
            f"logit scale {scale:.3f}); argmax agree "
            f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{B}")
        if not (err <= lim):
            raise AssertionError(f"{name}: kernel path logits drift "
                                 f"{err:.4e} > {lim:.4e}")


def parity_phase(torch):
    """qwen2-0.5b (reduced) in f32, prefix sharing and retention on (the
    default ServeConfig's): the engine on the kernel path and on the
    plain path must give identical greedy tokens and sharing counters.
    The traffic: 8 random prompts, 6 behind a common 13-token prefix
    (three pages and one token), then 3 repeats after the drain."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    cfg = dataclasses.replace(configs.get("qwen2-0.5b").reduced(),
                              dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    params = get_model(cfg).init(gen, "cuda")
    rng = np.random.RandomState(5)
    work = [(rng.randint(0, cfg.vocab_size, size=n).astype(np.int32), int(b))
            for n, b in zip(rng.randint(3, 40, size=8),
                            rng.randint(3, 12, size=8))]
    head = rng.randint(0, cfg.vocab_size, size=13)
    work += [(np.concatenate([head, rng.randint(0, cfg.vocab_size, size=n)])
              .astype(np.int32), int(b))
             for n, b in zip(rng.randint(1, 12, size=6),
                             rng.randint(3, 12, size=6))]
    repeats = [work[j] for j in (8, 10, 13)]
    outs, stats = [], []
    for plain in (False, True):
        engine = PagedEngine(
            get_model(cfg, plain_attention=plain), params,
            ServeConfig(max_batch=3, max_seq=64, page_size=4,
                        prefill_chunk=3, prefill_chunk_tokens=8))
        rids = [engine.submit(p, max_new_tokens=b) for p, b in work]
        engine.run()
        rids += [engine.submit(p, max_new_tokens=b) for p, b in repeats]
        res = engine.run()
        outs.append([res[r] for r in rids])
        stats.append((engine.shared_tokens, engine.kv.cow_copies,
                      engine.kv.retained_hits))
    same = sum(a == b for a, b in zip(*outs))
    log(f"[parity] qwen2-0.5b-reduced f32, sharing and retention on, kernel "
        f"vs plain path: {same}/{len(outs[0])} requests token-identical; "
        f"(shared tokens, COW copies, retained adoptions) kernel "
        f"{stats[0]}, plain {stats[1]}")
    if same != len(outs[0]):
        raise AssertionError("kernel path and plain path disagree in f32")
    if stats[0] != stats[1] or not all(stats[0]):
        raise AssertionError(f"parity: sharing counters {stats} differ or "
                             f"are zero")
    overload_parity(torch, cfg, params)
    spec_parity(torch, cfg, params)
    recover_parity(torch, cfg, params)


def snapshot_items(seed, vocab, n=8, last_tick=18):
    """tests/test_snapshot_props.py's schedule (``_make_items``): n
    (tick, prompt of 3, 5 or 8 tokens, budget 3 or 5), sorted by tick."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ats = sorted(int(t) for t in rng.randint(0, last_tick, size=n))
    return [(at, rng.randint(0, vocab, size=int(rng.choice((3, 5, 8))))
             .astype(np.int32), int(rng.choice((3, 5)))) for at in ats]


def recover_parity(torch, cfg, params):
    """tests/test_snapshot_props.py's ``test_kill_restore_int8_speculative``
    in f32 on the card: int8 target and draft pools, spec_k 2 with the
    1-layer draft, its recoverable ``FaultPlan.random(5)``, a snapshot
    every 2 ticks and kills at ticks 7 and 13, each recovered from the
    newest snapshot.  The recovered run on the kernel path gives the
    tokens and statuses of the uninterrupted run on the kernel path and
    on the plain path."""
    import dataclasses
    import tempfile

    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    from repro_torch.serve.faults import (RECOVERABLE_KINDS, FaultEvent,
                                          FaultPlan)
    seed = 5
    icfg = dataclasses.replace(cfg, kv_dtype="int8")
    dcfg = dataclasses.replace(icfg, n_layers=1)
    dparams = dict(params, blocks=first_layers(params["blocks"], 1))
    items = snapshot_items(seed, cfg.vocab_size)
    work = [(p, b) for _, p, b in items]
    recoverable = list(FaultPlan.random(
        seed, n_events=4, max_tick=20, max_batch=3, max_pages=3,
        max_duration=3, kinds=RECOVERABLE_KINDS).events)

    def mk(plain, snap_dir):
        return lambda: PagedEngine(
            get_model(icfg, plain_attention=plain), params, ServeConfig(
                max_batch=3, max_seq=48, page_size=4, num_pages=8,
                prefill_chunk=3, max_new_tokens=5, spec_k=2,
                snapshot_every_ticks=2 if snap_dir else 0,
                snapshot_dir=snap_dir),
            draft_model=get_model(dcfg, plain_attention=plain),
            draft_params=dparams)

    runs = {}
    with tempfile.TemporaryDirectory(prefix="recover-parity-") as tmp:
        for name, plain, kills, snap_dir in (
                ("uninterrupted", False, (), ""),
                ("plain path", True, (), ""),
                ("recovered", False, (7, 13), tmp)):
            eng, n_kills, n_restores = drive_with_recovery(
                mk(plain, snap_dir), work,
                lambda e, i: items[i][0] <= e.ticks,
                FaultPlan(recoverable + [FaultEvent(t, "kill")
                                         for t in kills]), tmp,
                engine_checks)
            runs[name] = dict(
                out=[(eng.status[r].value, eng.results[r])
                     for r in range(len(work))],
                kills=n_kills, restores=n_restores,
                int8=eng.kv.quantized and eng.dkv.quantized,
                faults=dict(eng.fault_counts))
    rec, ref = runs["recovered"], runs["uninterrupted"]
    log(f"[parity] kill and recover, int8 pools, spec_k 2, qwen2-0.5b-"
        f"reduced f32: kills at ticks 7 and 13, {rec['kills']} fired, "
        f"{rec['restores']} restores, faults {rec['faults']}; recovered "
        f"vs uninterrupted kernel path "
        f"{sum(a == b for a, b in zip(rec['out'], ref['out']))}/"
        f"{len(work)} identical (tokens and status), vs plain path "
        f"{sum(a == b for a, b in zip(rec['out'], runs['plain path']['out']))}"
        f"/{len(work)}")
    if rec["kills"] != 2 or rec["restores"] < 1 or not rec["int8"]:
        raise AssertionError(f"parity: kill and recover drill ran "
                             f"{rec['kills']} kills, {rec['restores']} "
                             f"restores")
    if not rec["out"] == ref["out"] == runs["plain path"]["out"]:
        raise AssertionError("parity: the recovered run differs from the "
                             "uninterrupted kernel or plain path")


def spec_parity(torch, cfg, params):
    """tests/test_torch_speculative.py's drives in f32 on the kernel path
    and on the plain path (max_batch 2, page 8, 18 new tokens, the
    1-layer draft slice): greedy tokens identical between the paths, and
    equal to plain greedy decode on the kernel path with the lane, for
    spec_k 1 and 3, for spec_k 3 under preemption at the CPU test's pool
    of five pages (also equal to the uninterrupted speculative run), and
    for prefill_lane=False."""
    import dataclasses

    import numpy as np

    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    drive = dict(max_batch=2, max_seq=96, max_new_tokens=18,
                 prefill_chunk=4, page_size=8)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = dict(params, blocks=first_layers(params["blocks"], 1))

    def prompts(seed):
        rng = np.random.RandomState(seed)
        return [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
                for n in rng.randint(4, 14, size=4)]

    def run(work, plain=False, **serve):
        spec = serve.get("spec_k", 0) > 0
        engine = PagedEngine(
            get_model(cfg, plain_attention=plain), params,
            ServeConfig(**dict(drive, **serve)),
            draft_model=get_model(dcfg, plain_attention=plain) if spec
            else None, draft_params=dparams if spec else None)
        rids = [engine.submit(p) for p in work]
        engine.run()
        engine.kv.check()
        if engine.dkv is not None:
            engine.dkv.check()
        return [engine.results[r] for r in rids], engine

    for name, seed, serve in (
            ("spec_k=1", 3, dict(spec_k=1)),
            ("spec_k=3", 3, dict(spec_k=3)),
            ("spec_k=3 at 5 pages", 13, dict(spec_k=3, num_pages=5)),
            ("prefill_lane=False", 3, dict(prefill_lane=False))):
        work = prompts(seed)
        (kt, ke), (pt, pe) = run(work, **serve), run(work, True, **serve)
        greedy, _ = run(work, num_pages=serve.get("num_pages", 0))
        extra = ""
        if "num_pages" in serve:
            oracle, _ = run(work, spec_k=3)
            extra = (f", {ke.preemptions}/{pe.preemptions} preemptions "
                     f"(kernel/plain), the uninterrupted speculative run "
                     f"{'agrees' if oracle == kt else 'DIFFERS'}")
            if not (ke.preemptions and pe.preemptions and oracle == kt):
                raise AssertionError(f"parity: {name} did not preempt on "
                                     f"both paths or left the "
                                     f"uninterrupted tokens")
        counts = (f" (accept {ke.spec_accepted}/{ke.spec_proposed} kernel, "
                  f"{pe.spec_accepted}/{pe.spec_proposed} plain)"
                  if ke.dkv is not None else
                  f" (forced bytes {ke.forced_upload_bytes})")
        log(f"[parity] {name}, qwen2-0.5b-reduced f32: kernel vs plain path "
            f"{sum(a == b for a, b in zip(kt, pt))}/4 token-identical, "
            f"against plain greedy with the lane "
            f"{sum(a == b for a, b in zip(kt, greedy))}/4{counts}{extra}")
        if not kt == pt == greedy:
            raise AssertionError(f"parity: {name} diverges in f32")


def overload_schedules(engine_for, vocab):
    """tests/test_overload_props.py's two regression schedules and one
    seeded ``FaultPlan.random`` fuzz run (its oversubscription schedule:
    10 requests over 7 pages, bursts, deadlines, cancels).  ``engine_for
    (**serve)`` builds the engine.  Returns one (engine, [(rid, prompt,
    budget)]) per schedule, each drained."""
    import numpy as np

    from repro_torch.serve.faults import FaultEvent, FaultPlan

    def drain(engine):
        while engine.busy or engine._squeezed:
            engine.step()
            engine.kv.check()
            engine._pindex.check(engine.slots)
            if engine.ticks > 2000:
                raise AssertionError("parity: the engine did not drain")

    out = []
    rng = np.random.RandomState(0)               # the formerly crashing one
    eng = engine_for(max_batch=2, max_seq=8, page_size=4, num_pages=3,
                     prefill_chunk=2, max_new_tokens=4)
    work = []
    for _ in range(2):
        p = rng.randint(0, vocab, size=3).astype(np.int32)
        work.append((eng.submit(p, 4), p, 4))
    drain(eng)
    out.append((eng, work))
    rng = np.random.RandomState(1)               # forced eviction
    eng = engine_for(max_batch=2, max_seq=32, page_size=4, prefill_chunk=2,
                     max_new_tokens=5)
    p = rng.randint(0, vocab, size=5).astype(np.int32)
    work = [(eng.submit(p, 5), p, 5)]
    eng.install_faults(FaultPlan([FaultEvent(3, "evict", slot=0),
                                  FaultEvent(6, "evict", slot=0)]))
    drain(eng)
    out.append((eng, work))
    seed = 28                                    # the fuzz, faults on
    rng = np.random.RandomState(seed)
    eng = engine_for(max_batch=3, max_seq=48, page_size=4, num_pages=8,
                     prefill_chunk=3, max_new_tokens=5)
    eng.install_faults(FaultPlan.random(seed, n_events=5, max_tick=10,
                                        max_batch=3, max_pages=3,
                                        max_duration=4))
    pending = [(rng.randint(0, vocab, size=rng.choice((3, 5, 8)))
                .astype(np.int32), int(rng.choice((3, 5))),
                int(rng.randint(4, 25)) if rng.rand() < 0.3 else 0)
               for _ in range(10)]
    work, ticks = [], 0
    while pending or eng.busy:
        if pending and (ticks % 5 == 0 or not eng.busy):
            for _ in range(min(len(pending), rng.randint(2, 5))):
                p, b, dl = pending.pop()
                work.append((eng.submit(p, b, deadline_ticks=dl), p, b))
        if rng.rand() < 0.15 and work:
            eng.cancel(int(rng.choice(sorted(r for r, _, _ in work))))
        if eng.busy:
            eng.step()
            eng.kv.check()
        ticks += 1
    drain(eng)
    out.append((eng, work))
    return out


def overload_parity(torch, cfg, params):
    """The f32 gate of overload handling: ``overload_schedules`` on the
    kernel path and on the plain path, against each request served
    uninterrupted on the kernel path (a full pool, no faults).  Every
    finished and resumed request gives the uninterrupted tokens on both
    paths, a cancelled or expired one a prefix of them, and the two paths
    agree on every status and result."""
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import (PagedEngine, RequestStatus,
                                          ServeConfig)
    runs = [overload_schedules(
        lambda **serve: PagedEngine(get_model(cfg, plain_attention=plain),
                                    params, ServeConfig(**serve)),
        cfg.vocab_size) for plain in (False, True)]
    alone = PagedEngine(get_model(cfg), params,
                        ServeConfig(max_batch=1, max_seq=64, page_size=4))
    names = ("formerly crashing", "forced eviction", "FaultPlan.random(28)")
    resumed = 0
    for name, (ke, work), (pe, _) in zip(names, *runs):
        want = {}
        for r, p, b in work:
            rid = alone.submit(p, b)
            alone.run()
            want[r] = alone.results[rid]
        st = {r: ke.status[r] for r, _, _ in work}
        ok = 0
        for r, _, _ in work:
            got = ke.results[r]
            if st[r] in (RequestStatus.FINISHED,
                         RequestStatus.PREEMPTED_RESUMED):
                ok += got == want[r]
            else:
                ok += got == want[r][:len(got)]
        same = ({r: (pe.status[r], pe.results[r]) for r, _, _ in work}
                == {r: (st[r], ke.results[r]) for r, _, _ in work})
        resumed += sum(s is RequestStatus.PREEMPTED_RESUMED
                       for s in st.values())
        log(f"[parity] overload, {name}: {len(work)} requests, statuses "
            f"{sorted(s.value for s in st.values())}, {ke.preemptions} "
            f"preemptions, {ke.quarantines} quarantines, faults "
            f"{ke.fault_counts}; {ok}/{len(work)} as served uninterrupted "
            f"(partial ones a prefix), kernel and plain paths "
            f"{'agree' if same else 'DIFFER'}")
        if ok != len(work) or not same:
            raise AssertionError(f"parity: overload schedule {name} "
                                 f"diverges in f32")
    if not resumed:
        raise AssertionError("parity: no request was preempted and resumed")


# ---------------------------------------------------------------------------
# whole-batch serving: the dense decode and flash kernels
# ---------------------------------------------------------------------------

DECODE_GEOMS = {"granite GQA": dict(H=32, KV=8, D=128),
                "qwen2 GQA": dict(H=14, KV=2, D=64),
                "MQA": dict(H=16, KV=1, D=128),
                "MHA": dict(H=8, KV=8, D=64),
                "granite-20b": dict(H=48, KV=1, D=128),
                "phi4-mini": dict(H=24, KV=8, D=128),
                "llama4-scout": dict(H=40, KV=8, D=128),
                "grok-1": dict(H=48, KV=8, D=128),
                "qwen2-vl": dict(H=64, KV=8, D=128),
                "whisper": dict(H=20, KV=20, D=64),
                "zamba2": dict(H=32, KV=32, D=112)}
FLASH_GEOMS = {"granite GQA": dict(H=32, KV=8, D=128),
               "qwen2 GQA": dict(H=14, KV=2, D=64),
               "MQA": dict(H=8, KV=1, D=64),
               "MHA": dict(H=8, KV=8, D=64),
               "granite-20b": dict(H=48, KV=1, D=128),
               "phi4-mini": dict(H=24, KV=8, D=128),
               "llama4-scout": dict(H=40, KV=8, D=128),
               "grok-1": dict(H=48, KV=8, D=128),
               "qwen2-vl": dict(H=64, KV=8, D=128),
               "zamba2": dict(H=32, KV=32, D=112)}
# whisper-large-v3's attention (20 heads of 64, G = 1) at its shapes: the
# encoder's non-causal S = T = 1500, the decoder's causal self-attention
# over its 448-token context, the cross-attention of 64 decoder rows over
# the 1500 encoder rows; (B, S, T, causal).  The plain side is the
# reference dispatch at the audio phase's chunks of 500.
WHISPER_FLASH = ((2, 1500, 1500, False), (2, 448, 448, True),
                 (4, 64, 1500, False))
WHISPER_CHUNK = 500


def dense_inputs(gen, B, S, T, H, KV, D, dtype):
    """Random q (B, S, H, D) and k, v (B, T, KV, D) on the card."""
    import torch
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


def dense_checks(torch):
    """The dense decode and flash kernels against their plain versions;
    returns {name: max_abs_err}."""
    import numpy as np

    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.attention import repeat_kv
    from repro_torch.models.flash import flash_attention_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    rng = np.random.RandomState(4321)
    errs = dict.fromkeys(DENSE_KERNELS, 0.0)
    B = 4
    for tname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol, _ = TOL[tname]
        for gname, g in DECODE_GEOMS.items():
            err = 0.0
            for T in (24, 48, 544, 2080):
                q, k, v = dense_inputs(gen, B, 1, T, dtype=dtype, **g)
                kv_len = int(rng.randint(1, T + 1))
                kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
                start = torch.from_numpy(rng.randint(
                    0, kv_len, size=B).astype(np.int32)).cuda()
                what = f"decode {gname} {tname} T={T} kv_len={kv_len}"
                for s in (start, None):
                    err = max(err, check_close(
                        what, decode.decode_attention(q, k, v, kvl, s),
                        decode_attention_ref(q, k, v, kvl, s), tol))
                empty = start.clone()
                empty[2] = kv_len                 # slot 2: an empty window
                got = decode.decode_attention(q, k, v, kvl, empty)
                want = decode_attention_ref(q, k, v, kvl, empty)
                torch.cuda.synchronize()
                if got[2].abs().max().item() != 0.0:
                    raise AssertionError(f"{what}: an empty window must "
                                         f"give exact zeros")
                keep = torch.arange(B, device="cuda") != 2
                err = max(err, check_close(what, got[keep], want[keep], tol))
            err = max(err, decode_split_checks(torch, gen, dtype, tol,
                                               f"{gname} {tname}", g))
            errs["decode_attention"] = max(errs["decode_attention"], err)
            log(f"[dense] decode {gname:11s} q={tname:8s} T in 24/48/544/"
                f"2080, random and no kv_start, split boundaries: "
                f"max|kernel-plain|={err:.3e} (tol {tol}); empty window "
                f"exact zeros")
        for gname, g in FLASH_GEOMS.items():
            err = 0.0
            shapes = [(S, S, c) for S in (37, 200, 512, 1024, 2048)
                      for c in (True, False)]
            shapes += [(200, 1024, False), (512, 1536, False),
                       (37, 24, False)]
            for S, T, causal in shapes:
                q, k, v = dense_inputs(gen, 2 if S <= 512 else 1, S, T,
                                       dtype=dtype, **g)
                H = g["H"]
                got = flash.flash_attention(q, k, v, causal=causal)
                want = flash_attention_ref(q, repeat_kv(k, H),
                                           repeat_kv(v, H), causal,
                                           min(512, S), min(512, T))
                err = max(err, check_close(
                    f"flash {gname} {tname} S={S} T={T} causal={causal}",
                    got, want, tol))
            errs["flash_attention"] = max(errs["flash_attention"], err)
            log(f"[dense] flash  {gname:11s} q={tname:8s} S = T in 37/200/"
                f"512/1024/2048 causal and not, S != T: max|kernel-plain|="
                f"{err:.3e} (tol {tol})")
        errs["flash_attention"] = max(errs["flash_attention"],
                                      lse_check(torch, gen, dtype, tol,
                                                tname),
                                      route_check(torch, gen, dtype, tol,
                                                  tname),
                                      whisper_flash_checks(torch, gen, dtype,
                                                           tol, tname))
    return errs


def whisper_flash_checks(torch, gen, dtype, tol, tname):
    """The flash kernel's model route (``flash.launch``) at whisper's
    shapes (``WHISPER_FLASH``) against the reference dispatch on the plain
    route: the chunked flash reference at S = T = 1500, direct attention
    at the others.  Returns max |kernel - plain|."""
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.attention import attention
    err = 0.0
    for B, S, T, causal in WHISPER_FLASH:
        q, k, v = dense_inputs(gen, B, S, T, 20, 20, 64, dtype)
        e = check_close(
            f"flash whisper {tname} B={B} S={S} T={T} causal={causal}",
            flash.launch(q, k, v, causal),
            attention(q, k, v, causal, WHISPER_CHUNK, WHISPER_CHUNK,
                      plain=True), tol)
        err = max(err, e)
        log(f"[dense] flash  whisper     q={tname:8s} B={B} S={S} T={T} "
            f"causal={causal} (G = 1, D = 64): max|kernel-plain|={e:.3e} "
            f"(tol {tol})")
    return err


def decode_split_checks(torch, gen, dtype, tol, what, g):
    """The split kernel at its pieces' edges, B = 4 over a T = 600 cache
    (8 to 19 splits per kv head): windows of 64 rows (two tiles) and one
    row either side, one starting inside a cache tile (kv_start = 37),
    windows of one row and of 40 (most pieces empty while the window is
    not), full ones, and an empty one (exact zeros).  Returns
    max |kernel - plain|."""
    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    B, T = 4, 600
    q, k, v = dense_inputs(gen, B, 1, T, dtype=dtype, **g)
    err = 0.0
    for kv_len, starts in ((600, (536, 535, 537, 37)),
                           (291, (0, 227, 290, 250)),
                           (500, (460, 0, 500, 499))):
        kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        got = decode.decode_attention(q, k, v, kvl, start)
        want = decode_attention_ref(q, k, v, kvl, start)
        torch.cuda.synchronize()
        live = start < kv_len
        if (got[~live] != 0).any().item():
            raise AssertionError(f"decode {what} splits: an empty window "
                                 f"must give exact zeros")
        err = max(err, check_close(
            f"decode {what} splits kv_len={kv_len} starts={starts} "
            f"({decode.splits(T, B, g['KV'])} splits)", got[live],
            want[live], tol))
    return err


def route_check(torch, gen, dtype, tol, tname):
    """``models.attention.attention`` at S = T = 600, causal: the kernel
    route takes a shape the reference dispatch serves (direct attention,
    600 * 600 <= 1024 * 1024) though 512 does not divide it, against
    ``direct_attention``.  Returns max |kernel - plain|."""
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.attention import attention, direct_attention
    q, k, v = dense_inputs(gen, 2, 600, 600, 32, 8, 128, dtype)
    n0 = flash.KERNEL.launches
    err = check_close(f"attention route {tname} S=T=600 causal",
                      attention(q, k, v, True),
                      direct_attention(q, k, v, True), tol)
    if flash.KERNEL.launches != n0 + 1:
        raise AssertionError("attention route at S=600: the flash kernel "
                             "did not run")
    log(f"[dense] attention route q={tname:8s} S = T = 600 causal (granite "
        f"geometry, B = 2) through the flash kernel: max|kernel-direct|="
        f"{err:.3e} (tol {tol})")
    return err


# L (the training forward's row normalizers) against the plain forward's:
# f32 only the summation order differs; bf16 adds the scores' f32
# accumulation on the tensor cores and their exp2 (P's rounding to bf16
# reaches only P V)
LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-4}


# The training instantiation's shapes, (model, B, S, T, H, KV, D, causal,
# the plain forward's chunk): qwen2-0.5b's (14 over 2 heads of 64; its
# train S, and S != T); whisper-large-v3's (20/20 heads of 64 at S = T =
# 1500, a ragged last tile: the encoder's and cross-attention's
# non-causal, the decoder's causal self-attention); zamba2-7b's shared
# block (32/32 heads of 112, its train S)
LSE_SHAPES = (("qwen2", 1, 4096, 4096, 14, 2, 64, True, 512),
              ("qwen2", 2, 1000, 1500, 14, 2, 64, False, 500),
              ("whisper", 4, 1500, 1500, 20, 20, 64, False, 500),
              ("whisper", 4, 1500, 1500, 20, 20, 64, True, 500),
              ("zamba2", 4, 1024, 1024, 32, 32, 112, True, 512))


def lse_check(torch, gen, dtype, tol, tname):
    """The training instantiation at each of LSE_SHAPES, its output and L
    against the plain forward's on the same inputs; its output also
    bit-identical to the serving instantiation's.  Returns the output's
    max error."""
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.attention import repeat_kv
    from repro_torch.models.flash import _flash_fwd
    err = 0.0
    for model, B, S, T, H, KV, D, causal, c in LSE_SHAPES:
        q, k, v = dense_inputs(gen, B, S, T, H, KV, D, dtype)
        out, L = flash.run(q, k, v, causal, with_lse=True)
        serving, _ = flash.run(q, k, v, causal)
        want, want_L = _flash_fwd(q, repeat_kv(k, H), repeat_kv(v, H),
                                  causal, c, c)
        what = f"flash with L {model} {tname} B={B} S={S} T={T} " \
               f"H={H} KV={KV} D={D} causal={causal}"
        if not torch.equal(out, serving):
            raise AssertionError(f"{what}: the output differs from the "
                                 f"serving instantiation's")
        o_err = check_close(what, out, want, tol)
        l_err = check_close(what + " L", L, want_L, LSE_TOL[tname])
        err = max(err, o_err)
        log(f"[dense] flash with L, {model} G = {H // KV}, D = {D}, "
            f"{tname}, B={B} S={S} T={T} causal={causal}: max|kernel-plain| "
            f"out {o_err:.3e} (tol {tol}), L {l_err:.3e} (tol "
            f"{LSE_TOL[tname]}); out = serving's, bit for bit")
        del q, k, v, out, L, serving, want, want_L
    return err


def dense_kernel_timing(torch, gen, *, B, H, KV, D, T, L, S, n_sets):
    """Kernel, plain and SDPA times of the two dense kernels in bf16:
    decode over a T-row cache (all rows live), cycling through L caches;
    flash at S = T' = S, causal, cycling through ``n_sets`` inputs, so
    that every call reads from memory and not from the 50 MB L2.
    Returns {kernel: row}, each with ms, plain_ms, library_ms (SDPA),
    device_ms, library_device_ms, shape, bytes and flops."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.attention import repeat_kv
    from repro_torch.models.flash import flash_attention_ref
    bf = torch.bfloat16
    rows = {}
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(bf)
    kc, vc = (torch.randn(L, B, T, KV, D, generator=gen, device="cuda")
              .to(bf) for _ in range(2))
    kvl = torch.tensor(T, dtype=torch.int32, device="cuda")
    start = torch.zeros(B, dtype=torch.int32, device="cuda")
    calls = (
        lambda i: decode.decode_attention(q, kc[i % L], vc[i % L], kvl,
                                          start),
        lambda i: decode_attention_ref(q, kc[i % L], vc[i % L], kvl, start),
        lambda i: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc[i % L].transpose(1, 2),
            vc[i % L].transpose(1, 2), enable_gqa=True))
    rows["decode_attention"] = dict(
        zip(("ms", "plain_ms", "library_ms"), map(time_ms, calls)),
        shape=f"B={B} T={T} kv_len={T} H={H} KV={KV} D={D}",
        bytes=sum(la.io_bytes for la in decode.trip_model(
            B, T, H, KV, D, T, [0] * B, bf)),
        flops=4 * B * T * H * D, device_ms=device_ms(calls[0]),
        library_device_ms=device_ms(calls[2]))
    del kc, vc
    qs, ks, vs = zip(*(dense_inputs(gen, B, S, S, H, KV, D, bf)
                       for _ in range(n_sets)))
    n = n_sets
    calls = (
        lambda i: flash.launch(qs[i % n], ks[i % n], vs[i % n], True),
        lambda i: flash_attention_ref(qs[i % n], repeat_kv(ks[i % n], H),
                                      repeat_kv(vs[i % n], H), True, S, S),
        lambda i: F.scaled_dot_product_attention(
            qs[i % n].transpose(1, 2), ks[i % n].transpose(1, 2),
            vs[i % n].transpose(1, 2), is_causal=True, enable_gqa=True))
    rows["flash_attention"] = dict(
        zip(("ms", "plain_ms", "library_ms"), map(time_ms, calls)),
        shape=f"B={B} S=T={S} causal H={H} KV={KV} D={D}",
        bytes=flash.trip_model(B, S, S, H, KV, D, True)[0].io_bytes,
        flops=4 * D * B * H * S * (S + 1) // 2, device_ms=device_ms(calls[0]),
        library_device_ms=device_ms(calls[2]))
    return rows


def log_dense_rows(rows, arch):
    """Each row's bound (bytes over 3.35 TB/s or flops over 989 TFLOP/s),
    logged beside its times; ``arch(name)`` labels a row."""
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["flops"],
                                                BF16_FLOPS_PER_S)
        log(f"[timing] {name} {arch(name)} bf16 {r['shape']}: kernel_ms="
            f"{r['ms']:.4f} device_ms={r['device_ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (SDPA; "
            f"device {r['library_device_ms']:.4f}) bound_ms="
            f"{r['bound_ms']:.5f} (by {r['bound_by']}: {r['bytes']} bytes "
            f"over 3.35 TB/s, {r['flops']} flops over 989 TFLOP/s)")


def dense_timing(torch, S):
    """The dense kernels at the whole-batch path's shapes (granite-8b,
    bf16, B = 4): decode over a T = S + 32 row cache (the last decode
    step's work) cycling through 36 layers' caches, flash at S = 512
    over 8 inputs; and flash at the whisper encoder's shape."""
    from repro_torch.kernels.decode_attention import decode
    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    B, KV, T = 4, 8, S + 32
    rows = dense_kernel_timing(torch, gen, B=B, H=32, KV=KV, D=128, T=T,
                               L=36, S=512, n_sets=8)
    blocks = decode.grid_blocks(B, T, KV)
    log(f"[timing] decode_attention grid at B={B} T={T} KV={KV}: "
        f"{decode.splits(T, B, KV)} splits, {blocks} blocks (+ the combine's "
        f"{KV * B}); device_ms (queued ahead of the card): kernel "
        f"{rows['decode_attention']['device_ms']:.4f}, SDPA "
        f"{rows['decode_attention']['library_device_ms']:.4f}")
    if blocks < 4 * B * KV:
        raise AssertionError(f"dense decode launches {blocks} blocks, fewer "
                             f"than 4 B KV = {4 * B * KV}")
    rows["flash_whisper"] = whisper_flash_timing(torch, gen)
    log_dense_rows(rows, lambda name: "whisper-large-v3"
                   if name == "flash_whisper" else "granite-8b")
    return rows


def whisper_flash_timing(torch, gen):
    """The flash kernel at the whisper encoder's shape (the audio phase's
    B = 4, S = T = 1500, 20 heads of 64 over 20 KV heads, non-causal,
    bf16), cycling through 4 inputs (each 46 MB of q, k and v): kernel,
    the plain chunked reference (chunks of 500) and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.flash import flash_attention_ref
    B, S, H, D, n = 4, 1500, 20, 64, 4
    qs, ks, vs = zip(*(dense_inputs(gen, B, S, S, H, H, D, torch.bfloat16)
                       for _ in range(n)))
    calls = (
        lambda i: flash.launch(qs[i % n], ks[i % n], vs[i % n], False),
        lambda i: flash_attention_ref(qs[i % n], ks[i % n], vs[i % n], False,
                                      WHISPER_CHUNK, WHISPER_CHUNK),
        lambda i: F.scaled_dot_product_attention(
            qs[i % n].transpose(1, 2), ks[i % n].transpose(1, 2),
            vs[i % n].transpose(1, 2)))
    row = dict(zip(("ms", "plain_ms", "library_ms"), map(time_ms, calls)),
               shape=f"B={B} S=T={S} non-causal H={H} KV={H} D={D}",
               bytes=flash.trip_model(B, S, S, H, H, D, False)[0].io_bytes,
               flops=4 * D * B * H * S * S)
    row["device_ms"] = device_ms(calls[0])
    row["library_device_ms"] = device_ms(calls[2])
    log(f"[timing] flash_attention at the whisper encoder's shape, "
        f"device_ms (queued ahead of the card): kernel "
        f"{row['device_ms']:.4f}, SDPA {row['library_device_ms']:.4f}")
    return row


def whole_batch_phase(torch, cfg, params):
    """granite-8b (the serve phase's weights) through ``ServingEngine``:
    the fused loop as the slice's main path (its launch counts), the
    legacy loop, ``benchmark_decode``, then the logits of the kernel path
    against the plain path."""
    import numpy as np

    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    rng = np.random.RandomState(17)
    prompt_lens = rng.randint(64, 501, size=4)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n in prompt_lens]
    new_tokens, S = 32, int(prompt_lens.max())
    engine = ServingEngine(get_model(cfg), params,
                           ServeConfig(max_new_tokens=new_tokens))
    torch.cuda.reset_peak_memory_stats()
    decode.KERNEL.launches = 0                   # counts of the main path
    flash.KERNEL.launches = 0
    t0 = time.perf_counter()
    fused = engine.generate_batch(prompts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"decode_attention": decode.KERNEL.launches,
                "flash_attention": flash.KERNEL.launches}
    t0 = time.perf_counter()
    legacy = engine.generate_batch(prompts, fused=False)
    torch.cuda.synchronize()
    dt_legacy = time.perf_counter() - t0
    bench = engine.benchmark_decode(batch=4, seq=1024, steps=8)
    n_out = sum(len(o) for o in fused)
    log(f"[whole-batch] granite-8b, prompts {prompt_lens.tolist()} "
        f"(right-aligned to S={S}), {new_tokens} new tokens each: fused "
        f"{n_out} tokens in {dt:.2f} s = {n_out / dt:.1f} tokens/s, legacy "
        f"loop {dt_legacy:.2f} s = {n_out / dt_legacy:.1f} tokens/s (host "
        f"clock, prefill included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[whole-batch] benchmark_decode(batch=4, seq=1024, steps=8): "
        f"fused {bench['s_per_step_fused'] * 1e3:.2f} ms/step "
        f"({bench['tokens_per_s_fused']:.1f} tokens/s), loop "
        f"{bench['s_per_step_loop'] * 1e3:.2f} ms/step "
        f"({bench['tokens_per_s_loop']:.1f} tokens/s)")
    log(f"[whole-batch] launches on this path: flash_attention="
        f"{launches['flash_attention']} ({cfg.n_layers} per prefill), "
        f"decode_attention={launches['decode_attention']} ({cfg.n_layers} "
        f"per step x {new_tokens - 1} steps = "
        f"{cfg.n_layers * (new_tokens - 1)})")
    if not all(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                            for t in o) for o in fused):
        raise AssertionError("whole-batch: a request did not get "
                             f"{new_tokens} in-vocab tokens")
    if fused != legacy:
        raise AssertionError("whole-batch: fused and legacy loop disagree")
    if launches["flash_attention"] < cfg.n_layers or \
            launches["decode_attention"] < cfg.n_layers * (new_tokens - 1):
        raise AssertionError(f"whole-batch: a kernel was not launched for "
                             f"every layer: {launches}")
    log("[whole-batch] fused and legacy loop: 4/4 requests token-identical")
    long_prompt_check(torch, cfg, engine, rng)
    compare_whole_batch_logits(torch, cfg, params, prompts)
    return dict(launches=launches, tok_s=n_out / dt, S=S)


def long_prompt_check(torch, cfg, engine, rng):
    """A batch whose longest prompt has 777 tokens, served at full width:
    the reference dispatch runs it as direct attention (777 * 777 <=
    1024 * 1024), though 512 does not divide 777; the card route must
    take it through the flash kernel, once per layer."""
    from repro_torch.kernels.flash_attention import flash
    lens, new_tokens = (777, 120), 4
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n in lens]
    n0 = flash.KERNEL.launches
    t0 = time.perf_counter()
    out = engine.generate_batch(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flash.KERNEL.launches - n0
    log(f"[whole-batch] prompts {list(lens)} (S = 777, which 512 does not "
        f"divide): served, {new_tokens} new tokens each in {dt:.2f} s; "
        f"flash_attention launches {launches}")
    if not all(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                            for t in o) for o in out):
        raise AssertionError("whole-batch S=777: a request did not get "
                             f"{new_tokens} in-vocab tokens")
    if launches != cfg.n_layers:
        raise AssertionError(f"whole-batch S=777: flash ran {launches} "
                             f"times, not once per layer")


def compare_whole_batch_logits(torch, cfg, params, prompts):
    """The prefill's last-position logits and one decode step's logits of
    the kernel path against the plain path, from the same prompts."""
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    kern, plain = get_model(cfg), get_model(cfg, plain_attention=True)
    with torch.no_grad():
        lk, ck = ServingEngine(kern, params, ServeConfig())._prefill_cache(
            prompts, 2)
        lp, cp = ServingEngine(plain, params, ServeConfig())._prefill_cache(
            prompts, 2)
        nxt = lp.argmax(-1).to(torch.int32)[:, None]
        dk, _ = kern.decode_step(params, nxt, ck)
        dp, _ = plain.decode_step(params, nxt, cp)
    for name, a, b in (("prefill", lk, lp), ("decode step", dk, dp)):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        lim = LOGIT_ULPS * 2.0 ** -8 * scale
        log(f"[whole-batch] {name} logits, kernel vs plain path: max|diff|="
            f"{err:.4e}, bound {lim:.4e} ({LOGIT_ULPS} bf16 ulps of the logit "
            f"scale {scale:.3f}); argmax agree "
            f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}")
        if not (err <= lim):
            raise AssertionError(f"whole-batch {name}: kernel path logits "
                                 f"drift {err:.4e} > {lim:.4e}")


def route_parity(torch, cfg, seed, lens_sets):
    """``cfg`` in f32, random weights from ``seed``, through
    ``ServingEngine`` on the kernel and the plain route: 12 greedy tokens
    for each batch of prompts of ``lens_sets``.  Returns (requests
    token-identical, requests)."""
    import dataclasses

    import numpy as np

    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    cfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = get_model(cfg).init(gen, "cuda")
    rng = np.random.RandomState(seed + 1)
    same = total = 0
    for lens in lens_sets:
        prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in lens]
        outs = [ServingEngine(get_model(cfg, plain_attention=plain), params,
                              ServeConfig(max_new_tokens=12)
                              ).generate_batch(prompts)
                for plain in (False, True)]
        same += sum(a == b for a, b in zip(*outs))
        total += len(prompts)
    return same, total


def whole_batch_parity(torch):
    """qwen2-0.5b (reduced) in f32 through ``ServingEngine``: the kernel
    path's greedy tokens equal the plain path's.  Prompts of 32-96 tokens
    in multiples of 32 (the plain side's chunked flash reference, chunks of
    32), a batch of short ones (its direct attention), and (608, 64):
    chunks of 32 divide 608, 512 does not, so the kernel route must take
    it as the reference does."""
    from repro_torch import configs
    same, total = route_parity(
        torch, configs.get("qwen2-0.5b").reduced(), 8,
        ((32, 64, 96), (96, 96, 32, 64), (7, 30, 19), (608, 64)))
    log(f"[parity] qwen2-0.5b-reduced f32 ServingEngine, kernel vs plain "
        f"path: {same}/{total} requests token-identical (the (608, 64) "
        f"batch included)")
    if same != total:
        raise AssertionError("whole-batch kernel path and plain path "
                             "disagree in f32")


# ---------------------------------------------------------------------------
# whole-batch serving of falcon-mamba-7b: the selective-scan kernel
# ---------------------------------------------------------------------------

SCAN_SOURCE = "src/repro_torch/csrc/selective_scan.cu"
SCAN_REPLACES = "src/repro/kernels/ssm_scan/scan.py:63"
# exponentials on the special-function units: 16 MUFU.EX2 per SM per clock
# (CUDA C++ Programming Guide, arithmetic throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz; expf takes one MUFU.EX2
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# Tolerances of the scan kernel against its plain version, with reasons
# (rtol, atol, why):
SCAN_TOL = {
    "float32": (2e-5, 2e-5, "f32: only the order of the N-sum and the exp "
                            "implementations differ (as tests/"
                            "test_ssm_scan_kernel.py holds Pallas against "
                            "jnp)"),
    "bfloat16": (2.0 ** -7 + 2e-5, 2e-5,
                 "bf16 y: the f32 bound plus one bf16 ulp (2^-7 relative), "
                 "the output's own rounding of two f32 values that differ "
                 "by that much; h_final is f32 on both sides from the same "
                 "upcast inputs, so 2e-5"),
}


def scan_inputs(gen, B, S, d_in, N, dtype, dt_rank=256):
    """Random scan inputs on the card, scaled as the JAX kernel test's
    (dt a softplus of a shifted normal, A = -exp(normal * 0.3)); Bc and Cc
    are column slices of one (B, S, dt_rank + 2N) tensor, as the model's
    x_proj output is sliced (falcon-mamba's dt_rank is 256)."""
    import torch
    import torch.nn.functional as F
    x = torch.randn(B, S, d_in, generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(B, S, d_in, generator=gen, device="cuda")
                    * 0.5 - 1.0).to(dtype)
    A = -torch.exp(torch.randn(d_in, N, generator=gen, device="cuda") * 0.3)
    dbc = torch.randn(B, S, dt_rank + 2 * N, generator=gen,
                      device="cuda").to(dtype)
    return x, dt, A, dbc[..., dt_rank:dt_rank + N], dbc[..., dt_rank + N:]


def scan_checks(torch):
    """The scan kernel against its plain version; returns max_abs_err over
    y and h_final."""
    from repro_torch.kernels.ssm_scan import scan
    from repro_torch.models.ssm import mamba1_scan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    worst = 0.0
    for tname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        rtol, atol, _ = SCAN_TOL[tname]
        for N in (8, 16):
            err = 0.0
            for B in (1, 4):
                for d_in in (128, 1000, 1001, 8192):
                    for S in (1, 37, 512, 2048):
                        x, dt, A, Bc, Cc = scan_inputs(gen, B, S, d_in, N,
                                                       dtype)
                        y, h = scan.selective_scan(x, dt, A, Bc, Cc)
                        want_y, want_h = mamba1_scan(x, dt, A, Bc, Cc)
                        torch.cuda.synchronize()
                        what = f"scan {tname} B={B} S={S} d_in={d_in} N={N}"
                        for name, a, b, rt, at in (
                                ("y", y, want_y, rtol, atol),
                                ("h_final", h, want_h, 2e-5, 2e-5)):
                            a, b = a.float(), b.float()
                            e = (a - b).abs().max().item()
                            if not torch.isfinite(a).all() or \
                                    not torch.allclose(a, b, rtol=rt,
                                                       atol=at):
                                raise AssertionError(
                                    f"{what} {name}: kernel differs from "
                                    f"plain by {e:.3e} (rtol {rt}, atol "
                                    f"{at})")
                            err = max(err, e)
                        if y.dtype != dtype or h.dtype != torch.float32:
                            raise AssertionError(f"{what}: output dtypes "
                                                 f"{y.dtype}, {h.dtype}")
            worst = max(worst, err)
            log(f"[ssm] scan q={tname:8s} N={N:2d} B in 1/4, d_in in 128/"
                f"1000/1001/8192 (1001: x, dt by plain loads), S in "
                f"1/37/512/2048, strided B/C: "
                f"max|kernel-plain|={err:.3e} (y rtol {rtol:.3g} atol "
                f"{atol}; h_final 2e-5)")
    for tname, (rtol, atol, why) in SCAN_TOL.items():
        log(f"[ssm] tolerance {tname}: rtol={rtol:.4g} atol={atol} — {why}")
    return worst


def ssm_serve_phase(torch):
    """falcon-mamba-7b at full width and depth through ``ServingEngine``:
    the fused loop as the slice's main path (its launch count), the
    legacy loop, ``benchmark_decode``, then the kernel path against the
    plain path."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.ssm_scan import scan
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    cfg = configs.get("falcon-mamba-7b")         # full width and depth
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[ssm] falcon-mamba-7b: {cfg.n_layers} Mamba1 layers, d_model "
        f"{cfg.d_model}, d_in {cfg.d_model * cfg.ssm_expand}, N "
        f"{cfg.ssm_state}, {n_params / 1e9:.3f} B params in bf16, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(17)              # the whole-batch phase's
    prompt_lens = rng.randint(64, 501, size=4)   # prompt lengths
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n in prompt_lens]
    new_tokens, S = 32, int(prompt_lens.max())
    engine = ServingEngine(model, params,
                           ServeConfig(max_new_tokens=new_tokens))
    torch.cuda.reset_peak_memory_stats()
    scan.KERNEL.launches = 0                     # counts of the main path
    t0 = time.perf_counter()
    fused = engine.generate_batch(prompts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = scan.KERNEL.launches
    t0 = time.perf_counter()
    legacy = engine.generate_batch(prompts, fused=False)
    torch.cuda.synchronize()
    dt_legacy = time.perf_counter() - t0
    legacy_launches = scan.KERNEL.launches - launches
    bench = engine.benchmark_decode(batch=4, seq=1024, steps=8)
    n_out = sum(len(o) for o in fused)
    log(f"[ssm] falcon-mamba-7b, prompts {prompt_lens.tolist()} "
        f"(right-aligned to S={S}), {new_tokens} new tokens each: fused "
        f"{n_out} tokens in {dt:.2f} s = {n_out / dt:.1f} tokens/s, legacy "
        f"loop {dt_legacy:.2f} s = {n_out / dt_legacy:.1f} tokens/s (host "
        f"clock, prefill included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[ssm] benchmark_decode(batch=4, seq=1024, steps=8): fused "
        f"{bench['s_per_step_fused'] * 1e3:.2f} ms/step "
        f"({bench['tokens_per_s_fused']:.1f} tokens/s), loop "
        f"{bench['s_per_step_loop'] * 1e3:.2f} ms/step "
        f"({bench['tokens_per_s_loop']:.1f} tokens/s)")
    log(f"[ssm] launches on this path: selective_scan={launches} "
        f"({cfg.n_layers} per prefill; the legacy loop's prefill "
        f"{legacy_launches}); decode steps run no scan")
    if not all(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                            for t in o) for o in fused):
        raise AssertionError(f"ssm: a request did not get {new_tokens} "
                             f"in-vocab tokens")
    if fused != legacy:
        raise AssertionError("ssm: fused and legacy loop disagree")
    if launches != cfg.n_layers or legacy_launches != cfg.n_layers:
        raise AssertionError(f"ssm: the scan kernel ran {launches} and "
                             f"{legacy_launches} times per prefill, not "
                             f"once per layer ({cfg.n_layers})")
    log("[ssm] fused and legacy loop: 4/4 requests token-identical")
    del engine
    compare_ssm_paths(torch, cfg, params, prompts)
    compare_ssm_scaled(torch, cfg, params, prompts)
    return dict(launches=launches, tok_s=n_out / dt, S=S)


def compare_ssm_paths(torch, cfg, params, prompts):
    """The prefill's last-position logits, its state (every layer's conv
    and ssm parts) and one decode step's logits of the kernel path against
    the plain path, from the same prompts.  Layer 0's scan state comes
    from the same inputs on both paths, so it is held to the f32 scan
    tolerance; the rest drift by bf16 roundings through the layers and are
    held to LOGIT_ULPS bf16 ulps of their scale."""
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    kern, plain = get_model(cfg), get_model(cfg, plain_attention=True)
    with torch.no_grad():
        lk, ck = ServingEngine(kern, params, ServeConfig())._prefill_cache(
            prompts, 2)
        lp, cp = ServingEngine(plain, params, ServeConfig())._prefill_cache(
            prompts, 2)
        states = {k: (ck[k].clone(), cp[k].clone()) for k in ("conv", "ssm")}
        nxt = lp.argmax(-1).to(torch.int32)[:, None]
        dk, _ = kern.decode_step(params, nxt, ck)
        dp, _ = plain.decode_step(params, nxt, cp)
    h0k, h0p = states["ssm"][0][0], states["ssm"][1][0]
    e0 = (h0k - h0p).abs().max().item()
    if not torch.allclose(h0k, h0p, rtol=2e-5, atol=2e-5):
        raise AssertionError(f"ssm: layer 0's prefill state differs by "
                             f"{e0:.3e} (rtol = atol = 2e-5)")
    log(f"[ssm] layer 0 prefill ssm state, kernel vs plain path: "
        f"max|diff|={e0:.3e} (rtol = atol = 2e-5: the same inputs)")
    pairs = [("prefill logits", lk, lp), ("decode step logits", dk, dp),
             ("prefill conv state", *states["conv"]),
             ("prefill ssm state", *states["ssm"])]
    for name, a, b in pairs:
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        lim = LOGIT_ULPS * 2.0 ** -8 * scale
        extra = ""
        if "logits" in name:
            agree = int((a.argmax(-1) == b.argmax(-1)).sum())
            extra = f"; argmax agree {agree}/{a.shape[0]}"
        log(f"[ssm] {name}, kernel vs plain path: max|diff|={err:.4e}, "
            f"bound {lim:.4e} ({LOGIT_ULPS} bf16 ulps of the scale "
            f"{scale:.3f}){extra}")
        if not (err <= lim):
            raise AssertionError(f"ssm {name}: kernel path drifts {err:.4e} "
                                 f"> {lim:.4e}")


# The scaled SSM check's weights: conv taps x4 and dt_bias + 2.  With the
# init's fan-in taps the scan's output barely reaches the logits; from x8
# up this random 64-layer network turns a flip of y's last bit in 1e-4 of
# its elements into a logit change past the bound, so no kernel could hold
# it there.  x4, + 2 is the measured scaling between the two
# (scripts/torch_ssm_drift.py; PERF.md, PR 16).
SSM_TAP_SCALE, SSM_DT_SHIFT = 4.0, 2.0


def compare_ssm_scaled(torch, cfg, params, prompts):
    """The serve-level check once more on weights that make the scan
    matter (``SSM_TAP_SCALE``, ``SSM_DT_SHIFT``).  On the plain path's
    prefill, every layer's scan also runs through the kernel on the same
    inputs, held to the bf16 scan tolerance (y) and 2e-5 (h_final); the
    plain path with the scan's y set to zero must move the prefill logits
    by more than the bound, or this check would not test the kernel; then
    the kernel path's prefill and decode-step logits against the plain
    path's, held to LOGIT_ULPS bf16 ulps of their scale."""
    from repro_torch.kernels.ssm_scan import scan
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    mixer = dict(params["blocks"]["mixer"])
    mixer["conv_w"] = mixer["conv_w"] * SSM_TAP_SCALE
    mixer["dt_bias"] = mixer["dt_bias"] + SSM_DT_SHIFT
    scaled = dict(params, blocks=dict(params["blocks"], mixer=mixer))
    kern, plain = get_model(cfg), get_model(cfg, plain_attention=True)
    plain_scan = ssm_mod.mamba1_scan
    rtol, atol, _ = SCAN_TOL["bfloat16"]
    worst = {"y": 0.0, "h": 0.0, "layers": 0}

    def both(*args):
        y, h = plain_scan(*args)
        yk, hk = scan.selective_scan(*args)
        for name, a, b, rt, at in (("y", yk, y, rtol, atol),
                                   ("h", hk, h, 2e-5, 2e-5)):
            a, b = a.float(), b.float()
            worst[name] = max(worst[name], ((a - b).abs() / (
                rt * b.abs() + at)).max().item())
        worst["layers"] += 1
        return y, h

    def no_scan(*args):
        y, h = plain_scan(*args)
        return torch.zeros_like(y), h

    def prefill(model, wrap=None):
        ssm_mod.mamba1_scan = wrap or plain_scan
        try:
            return ServingEngine(model, scaled, ServeConfig()
                                 )._prefill_cache(prompts, 2)
        finally:
            ssm_mod.mamba1_scan = plain_scan

    with torch.no_grad():
        lk, ck = prefill(kern)
        lp, cp = prefill(plain, both)
        state = cp["ssm"].abs().max().item()
        nxt = lp.argmax(-1).to(torch.int32)[:, None]
        dk, _ = kern.decode_step(scaled, nxt, ck)
        dp, _ = plain.decode_step(scaled, nxt, cp)
        l0, _ = prefill(plain, no_scan)
    log(f"[ssm] scaled weights (conv taps x{SSM_TAP_SCALE}, dt_bias + "
        f"{SSM_DT_SHIFT}): prefill ssm state max|h| = {state:.4f}; every "
        f"layer's scan, kernel vs plain on the same inputs "
        f"({worst['layers']} layers): worst |diff| / tol y {worst['y']:.3f}"
        f", h_final {worst['h']:.3f} (<= 1 holds)")
    if worst["layers"] != cfg.n_layers or not (worst["y"] <= 1.0
                                               and worst["h"] <= 1.0):
        raise AssertionError(f"ssm scaled: a layer's scan kernel differs "
                             f"from plain on the same inputs: {worst}")
    scale = lp.float().abs().max().item()
    lim = LOGIT_ULPS * 2.0 ** -8 * scale
    moved = (l0.float() - lp.float()).abs().max().item()
    log(f"[ssm] scaled weights: the scan's y set to zero moves the plain "
        f"prefill logits by {moved:.4e} against the bound {lim:.4e}")
    if not moved > lim:
        raise AssertionError(f"ssm scaled check: the scan moves the logits "
                             f"by {moved:.4e} <= {lim:.4e}, so it would not "
                             f"test the kernel")
    for name, a, b in (("prefill logits", lk, lp),
                       ("decode step logits", dk, dp)):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        lim = LOGIT_ULPS * 2.0 ** -8 * b.abs().max().item()
        agree = int((a.argmax(-1) == b.argmax(-1)).sum())
        log(f"[ssm] scaled weights, {name}, kernel vs plain path: "
            f"max|diff|={err:.4e}, bound {lim:.4e} ({LOGIT_ULPS} bf16 ulps "
            f"of the scale {b.abs().max().item():.3f}); argmax agree "
            f"{agree}/{a.shape[0]}")
        if not (err <= lim):
            raise AssertionError(f"ssm scaled {name}: kernel path drifts "
                                 f"{err:.4e} > {lim:.4e}")


def ssm_parity(torch):
    """falcon-mamba-7b (reduced) in f32 through ``ServingEngine``: the
    kernel path's greedy tokens equal the plain path's, over prompts
    shorter than the conv window, ragged ones, and ones over several of
    the kernel's 32-step tiles."""
    from repro_torch import configs
    same, total = route_parity(
        torch, configs.get("falcon-mamba-7b").reduced(), 12,
        ((5, 40, 17), (64, 100, 2, 70), (1, 2)))
    log(f"[parity] falcon-mamba-7b-reduced f32 ServingEngine, kernel vs "
        f"plain path: {same}/{total} requests token-identical")
    if same != total:
        raise AssertionError("ssm kernel path and plain path disagree in "
                             "f32")


def scan_timing(torch, S):
    """Kernel and plain times at the phase's shape (falcon-mamba-7b, bf16,
    B = 4, S = the longest prompt, d_in 8192, N 16), cycling through 4
    input sets (each ~65 MB of x and dt, past the 50 MB L2), beside the
    bound: the largest of the bytes over 3.35 TB/s, the exponentials over
    the SFUs and the flops over 67 TFLOP/s."""
    from repro_torch.kernels.ssm_scan import scan
    from repro_torch.models.ssm import mamba1_scan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    B, d_in, N, n_sets = 4, 8192, 16, 4
    sets = [scan_inputs(gen, B, S, d_in, N, torch.bfloat16)
            for _ in range(n_sets)]
    ms = time_ms(lambda i: scan.selective_scan(*sets[i % n_sets]))
    dms = device_ms(lambda i: scan.selective_scan(*sets[i % n_sets]))
    plain_ms = time_ms(lambda i: mamba1_scan(*sets[i % n_sets]), iters=8,
                       warmup=1)
    elems = B * S * d_in
    nbytes = scan.hbm_bytes(B, S, d_in, N, torch.bfloat16)
    exps, flops = elems * N, 6 * elems * N + elems
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "exps": exps / SFU_EXP_PER_S,
             "flops": flops / F32_FLOPS_PER_S}
    by = max(times, key=times.get)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=None, device_ms=dms,
               bound_ms=times[by] * 1e3,
               bound_by="bytes" if by == "bytes" else "operations")
    log(f"[timing] selective_scan falcon-mamba-7b bf16 B={B} S={S} "
        f"d_in={d_in} N={N}: kernel_ms={ms:.4f} device_ms={dms:.4f} "
        f"plain_ms={plain_ms:.4f} "
        f"library_ms=none (no single PyTorch call computes a selective "
        f"scan) bound_ms={row['bound_ms']:.5f} (by {by}: {nbytes} bytes "
        f"over 3.35 TB/s = {times['bytes'] * 1e3:.5f} ms, {exps} exps over "
        f"{SFU_EXP_PER_S / 1e12:.3f} T/s on the SFUs = "
        f"{times['exps'] * 1e3:.5f} ms, {flops} flops over 67 TFLOP/s = "
        f"{times['flops'] * 1e3:.5f} ms)")
    return row


def ssm_phase(torch):
    """Checks, then falcon-mamba-7b serving as the slice's main path, the
    reduced f32 parity and the times."""
    err = scan_checks(torch)
    serve = ssm_serve_phase(torch)
    torch.cuda.empty_cache()
    ssm_parity(torch)
    return dict(err=err, timing=scan_timing(torch, serve["S"]), **serve)


# ---------------------------------------------------------------------------
# moe: llama4-scout at full width through the paged engine
# ---------------------------------------------------------------------------

MOE_ARCH = "llama4-scout-17b-a16e"
# 12 of 48 layers, the depth one card holds: each layer is 2.076 G
# parameters (4.15 GB in bf16) and the untied embed and unembed 4.14 GB,
# so 12 layers make 54.0 GB; 16 would leave under 10 GB of the 80
MOE_LAYERS = 12
MOE_REDUCED_PARITY = (("llama4-scout-17b-a16e", {}),
                      ("grok-1-314b", {"ep_shards": 8}))


class MoeCalls:
    """Wraps ``transformer.moe_ffn`` (the name the blocks call) while
    active: counts its calls by kind (``decode``: one row a slot,
    ``prefill``: a chunk) and, with ``record``, each call's routing as
    ``models/moe.py`` takes it — the top-k experts of every row and
    whether capacity kept each (row, expert) assignment — on the device,
    with no read back until ``summary``."""

    def __init__(self, torch, record=False):
        self.torch, self.record = torch, record
        self.calls = {"decode": 0, "prefill": 0}
        self.assigned = {"decode": 0, "prefill": 0}
        self.dropped = {}
        self.routes = []

    def __enter__(self):
        from repro_torch.models import transformer
        self.real = real = transformer.moe_ffn

        def wrapped(x, router_w, w1, w2, w3, cfg):
            kind = "decode" if x.shape[1] == 1 else "prefill"
            self.calls[kind] += 1
            if self.record:
                experts, kept, gap = routing(self.torch, x, router_w, cfg)
                self.assigned[kind] += experts.numel()
                drop = (~kept).sum()
                self.dropped[kind] = self.dropped.get(kind, 0) + drop
                self.routes.append((experts, kept, gap))
            return real(x, router_w, w1, w2, w3, cfg)

        transformer.moe_ffn = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer.moe_ffn = self.real

    def summary(self):
        """{kind: (assignments, dropped)} of the recorded calls."""
        return {k: (self.assigned[k], int(self.dropped.get(k, 0)))
                for k in self.assigned}


def routing(torch, x, router_w, cfg):
    """One ``moe_ffn`` call's routing: (experts (n, k), kept (n, k) bool,
    gap (n,) f32: the k-th probability less the next).  An expert keeps
    the first C rows that picked it, by row index, C = max(1,
    int(capacity_factor * n * k / E)) over all n rows of the call."""
    import torch.nn.functional as F

    from repro_torch.models.moe import route
    n = x.shape[0] * x.shape[1]
    _, experts, probs = route(x.reshape(n, -1), router_w, cfg)
    capacity = max(1, int(cfg.capacity_factor * n * cfg.experts_per_token
                          / cfg.n_experts))
    picked = F.one_hot(experts, cfg.n_experts).sum(1) > 0       # (n, E)
    rank = picked.to(torch.int32).cumsum(0) - 1
    kept = (picked & (rank < capacity)).gather(1, experts)
    top = torch.topk(probs, cfg.experts_per_token + 1, dim=-1).values
    return experts, kept, top[:, -2] - top[:, -1]


def drive_moe(torch, model, params, scfg, prompts, decode_kernel,
              prefill_kernel, record=False):
    """Serves ``prompts`` through a fresh ``PagedEngine``; ``kv.check()``
    after every tick; the kernels' counts set to 0 just before and read
    just after.  Returns the engine, tokens, time in ``step()``, the
    model calls by kind and the kernels' launches."""
    from repro_torch.serve.engine import PagedEngine
    engine = PagedEngine(model, params, scfg)
    rids = [engine.submit(p) for p in prompts]
    step_s = 0.0
    decode_kernel.launches = 0                   # counts of this path
    prefill_kernel.launches = 0
    with MoeCalls(torch, record) as calls:
        while engine.busy:
            t0 = time.perf_counter()
            engine.step()
            step_s += time.perf_counter() - t0
            engine.kv.check()
        torch.cuda.synchronize()
    launches = {"decode": decode_kernel.launches,
                "prefill": prefill_kernel.launches}
    return dict(engine=engine, tokens=[engine.results[r] for r in rids],
                step_s=step_s, calls=calls, launches=launches)


def moe_path_checks(phase, cfg, tokens, new_tokens, calls, launches):
    """Every request's ``new_tokens`` in-vocab tokens; both paged
    kernels launched, exactly once per layer of every call of their
    kind."""
    bad = [t for t in tokens if len(t) != new_tokens
           or not all(0 <= x < cfg.vocab_size for x in t)]
    if bad:
        raise AssertionError(f"{phase}: {len(bad)} requests without "
                             f"{new_tokens} in-vocab tokens")
    for kind in ("decode", "prefill"):
        n = calls.calls[kind] // cfg.n_layers     # model calls of the kind
        if not (n > 0 and launches[kind] == n * cfg.n_layers
                == calls.calls[kind]):
            raise AssertionError(
                f"{phase}: paged_{kind}_attention launched "
                f"{launches[kind]} times over {calls.calls[kind]} MoE "
                f"layers ({n} calls), not {cfg.n_layers} per call")


def moe_phase(torch, decode_kernel, prefill_kernel):
    """llama4-scout at its published widths and 12 of its 48 layers,
    bf16, random weights: paged serving with sharing off (serve's
    traffic) and with the default ServeConfig (share's), the two routes
    at one shot, whole-batch; then the reduced MoE archs' f32 parity."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[moe] device memory at phase start: {free / 2**30:.2f} GiB free "
        f"of {total / 2**30:.2f} GiB ({held:.2f} GiB allocated by this "
        f"process); on {gpu_line()}")
    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_LAYERS)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    # what a call must read: every weight but the embedding table, whose
    # rows it gathers (the experts all of them: every block runs)
    nbytes = sum(t.numel() * t.element_size() for t in leaves) - \
        params["embed"].numel() * params["embed"].element_size()
    floor_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[moe] {MOE_ARCH}: {cfg.n_layers} of 48 layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, {cfg.n_experts} experts of d_ff {cfg.d_ff} top-"
        f"{cfg.experts_per_token} (capacity factor {cfg.capacity_factor}), "
        f"vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B params, "
        f"{n_params * 2 / 1e9:.2f} GB in bf16, init "
        f"{time.perf_counter() - t0:.1f} s; a call reads >= "
        f"{nbytes / 1e9:.2f} GB of weights = {floor_ms:.2f} ms at 3.35 TB/s "
        f"(<= {4 * 1e3 / floor_ms:.0f} tokens/s at batch 4)")

    new_tokens = 32
    rng = np.random.RandomState(7)               # the serve phase's traffic
    prompt_lens = rng.randint(64, 301, size=8)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n in prompt_lens]
    scfg = ServeConfig(max_batch=4, max_seq=int(prompt_lens.max())
                       + new_tokens + 16, max_new_tokens=new_tokens,
                       page_size=16, prefill_chunk_tokens=32,
                       prefix_sharing=False, retain_prefixes=False)
    torch.cuda.reset_peak_memory_stats()
    run = drive_moe(torch, model, params, scfg, prompts, decode_kernel,
                    prefill_kernel)
    eng = run["engine"]
    n_out = sum(len(t) for t in run["tokens"])
    tok_s = n_out / run["step_s"]
    calls = {k: v // cfg.n_layers for k, v in run["calls"].calls.items()}
    log(f"[moe] paged, sharing off, serve's 8 requests (prompts "
        f"{prompt_lens.tolist()}, {new_tokens} new): {n_out} tokens in "
        f"{run['step_s']:.2f} s of step() = {tok_s:.1f} tokens/s (host "
        f"clock), {eng.ticks} ticks, {calls['decode']} decode steps and "
        f"{calls['prefill']} prefill chunks; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on "
        f"{gpu_line()}")
    log(f"[moe] launches on this path: paged_decode_attention="
        f"{run['launches']['decode']}, paged_prefill_attention="
        f"{run['launches']['prefill']} ({cfg.n_layers} per call)")
    moe_path_checks("moe", cfg, run["tokens"], new_tokens, run["calls"],
                    run["launches"])
    split = host_split(eng, run["step_s"])
    log_host("moe", split)
    launches = run["launches"]
    del eng, run["engine"]
    rec = drive_moe(torch, model, params, scfg, prompts, decode_kernel,
                    prefill_kernel, record=True)
    drops = rec["calls"].summary()
    same = rec["tokens"] == run["tokens"]
    del rec["engine"]
    log(f"[moe] a recording pass of the same traffic (moe_ffn wrapped: "
        f"each call's routing, read after the drain): "
        + "; ".join(f"{k} calls {a} (row, layer) assignments, {d} dropped "
                    f"by capacity ({100 * d / max(a, 1):.2f}%)"
                    for k, (a, d) in drops.items())
        + f"; tokens {'identical to' if same else 'NOT identical to'} the "
        f"timed pass's")
    if not same:
        raise AssertionError("moe: the same traffic served twice gave other "
                             "tokens (rows without a request read the null "
                             "page: its writes must settle alike)")

    waves = share_traffic(np.random.RandomState(29), cfg.vocab_size)
    decode_kernel.launches = prefill_kernel.launches = 0
    with MoeCalls(torch) as share_calls:
        share = serve_waves(torch, cfg, params, waves, new_tokens)
    share_launches = {"decode": decode_kernel.launches,
                      "prefill": prefill_kernel.launches}
    seng = share["engine"]
    s_out = sum(len(t) for w in share["tokens"] for t in w)
    log(f"[moe] default ServeConfig (sharing and retention on), share's "
        f"traffic (a 200-token system prompt behind 8 tails, then 4 "
        f"repeats): {s_out} tokens in {share['step_s']:.2f} s of step() = "
        f"{s_out / share['step_s']:.1f} tokens/s, {seng.ticks} ticks; "
        f"shared {seng.shared_tokens} prompt tokens, {seng.kv.cow_copies} "
        f"COW copies, {seng.kv.retained_hits} retained adoptions; "
        f"launches paged_decode_attention={share_launches['decode']}, "
        f"paged_prefill_attention={share_launches['prefill']}; kv.check() "
        f"and the prefix index clean after every tick; no shared = alone "
        f"logit bound (MoE capacity counts the batch's rows)")
    moe_path_checks("moe share", cfg, sum(share["tokens"], []), new_tokens,
                    share_calls, share_launches)
    share_split = host_split(seng, share["step_s"])
    log_host("moe share", share_split)
    share_tok_s = s_out / share["step_s"]
    del seng, share

    shot = moe_routes_check(torch, cfg, params)
    flips = shot["flips"]
    wb = moe_whole_batch(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    moe_parity(torch)
    total_drop = sum(d for _, d in drops.values()) / max(
        1, sum(a for a, _ in drops.values()))
    return dict(tok_s=tok_s, share_tok_s=share_tok_s, drops=drops,
                drop_share=total_drop, flips=flips, launches=launches,
                share_launches=share_launches, wb=wb, host=split,
                share_host=share_split, free_gib=free / 2**30,
                floor_ms=floor_ms, device_ms=shot["device_ms"])


def moe_routes_check(torch, cfg, params):
    """The kernel route against the plain route at one shot with no row
    that carries no request: one prefill chunk granting all 4 slots 32
    rows, then one decode step with all 4 active, each route run twice
    from fresh caches.  Each layer's top-k experts and kept rows are
    recorded; the (row, layer) assignments that differ between the
    routes are counted and printed (by layer, with the router's top-k /
    next probability gap of the first layer's flipped rows), as are the
    differences between a route and its own second run.  Where no
    assignment differs in a call (and, for the decode step, in the
    prefill before it), its logits are held within LOGIT_ULPS bf16 ulps;
    a flipped near-tie is printed, not failed.  The second kernel run is
    traced (``torch.profiler``) for the calls' device time.  Returns the
    flip counts and the device ms."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import get_model
    B, T, page, nb = 4, 32, 16, 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device="cuda").to(torch.int32)
    grants = torch.full((B,), T, dtype=torch.int32, device="cuda")
    out, routes, step_ms, dev_ms = {}, {}, {}, {}
    for name, plain in (("kernel", False), ("plain", True),
                        ("kernel again", False), ("plain again", True)):
        m = get_model(cfg, plain_attention=plain)
        cache = m.init_paged_cache(B, nb, page, B * nb + 1, "cuda")
        cache["table"] = torch.arange(1, 1 + B * nb, dtype=torch.int32,
                                      device="cuda").reshape(B, nb)
        calls = MoeCalls(torch, record=True)
        logits = {}
        for kind in ("prefill", "decode"):
            traced = name == "kernel again"
            prof = profile(activities=[ProfilerActivity.CUDA]) if traced \
                else contextlib.nullcontext()
            with torch.no_grad(), calls, prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if kind == "prefill":
                    lg, cache = m.prefill_step_paged(params, toks, cache,
                                                     grants)
                else:
                    lg, cache = m.decode_step_paged(params, nxt, cache)
                torch.cuda.synchronize()
                step_ms[f"{name} {kind}"] = (time.perf_counter() - t0) * 1e3
            if traced:
                dev_ms[kind] = sum(
                    e.device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3
            if name == "kernel" and kind == "prefill":
                nxt = lg.argmax(-1).to(torch.int32)[:, None]
            logits[kind] = lg.float()
        out[name], routes[name] = logits, calls.routes
    L = cfg.n_layers

    def differ(a, b, kind):
        """Per layer: rows whose experts differ, rows whose keep differs."""
        i = 0 if kind == "prefill" else 1
        res = []
        for (ea, ka, _), (eb, kb, _) in zip(a[i * L:(i + 1) * L],
                                            b[i * L:(i + 1) * L]):
            e = (ea != eb).any(-1)
            res.append((int(e.sum()), int(((ka != kb).any(-1) & ~e).sum())))
        return res

    flips = {}
    for kind in ("prefill", "decode"):
        per = differ(routes["kernel"], routes["plain"], kind)
        flips[kind] = sum(e + k for e, k in per)
        first = next((li for li, (e, _) in enumerate(per) if e), None)
        gaps = ""
        if first is not None:
            i = first + (0 if kind == "prefill" else L)
            (ek, _, _), (ep, _, gp) = routes["kernel"][i], routes["plain"][i]
            moved = (ek != ep).any(-1)
            k = cfg.experts_per_token
            gaps = (f"; layer {first}'s flipped rows' top-{k} / next "
                    f"probability gap on the plain route: max "
                    f"{gp[moved].max().item():.3e}, median "
                    f"{gp[moved].median().item():.3e} (all rows' median "
                    f"{gp.median().item():.3e})")
        rows = (B * T if kind == "prefill" else B) * L
        log(f"[moe] kernel vs plain route, {kind}: (row, layer) assignments "
            f"that differ {flips[kind]} of {rows}; by layer (experts, keep "
            f"only) {per}{gaps}")
    for name in ("kernel", "plain"):
        again = f"{name} again"
        same = {k: torch.equal(out[name][k], out[again][k])
                for k in ("prefill", "decode")}
        moved = {k: sum(e + c for e, c in differ(routes[name],
                                                 routes[again], k))
                 for k in ("prefill", "decode")}
        log(f"[moe] the {name} route run twice from fresh caches: logits "
            f"bit-identical prefill {same['prefill']}, decode "
            f"{same['decode']}; assignments that differ prefill "
            f"{moved['prefill']}, decode {moved['decode']} (reported)")
    log(f"[moe] one call at one shot ({L} layers, B=4, host clock with a "
        f"sync either side): " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                          step_ms.items())
        + f" (the second kernel run under torch.profiler); device time of "
        f"its CUDA kernels: prefill {dev_ms['prefill']:.2f} ms, decode "
        f"{dev_ms['decode']:.2f} ms; on {gpu_line()}")
    for kind in ("prefill", "decode"):
        if flips["prefill"] == 0 and flips[kind] == 0:
            ulp_check("moe", f"{kind} logits, kernel vs plain route",
                      out["kernel"][kind], out["plain"][kind])
        else:
            err = (out["kernel"][kind] - out["plain"][kind]).abs().max()
            log(f"[moe] {kind} logits, kernel vs plain route: routing "
                f"flipped upstream, max|diff|={err.item():.4e}: printed, "
                f"not held")
    return dict(flips=flips, device_ms=dev_ms, step_ms=step_ms)


def moe_whole_batch(torch, cfg, params):
    """``ServingEngine`` on the moe phase's weights: 4 prompts of 64-500
    tokens (the whole-batch phase's), 32 new.  Flash must launch once per
    layer for the prefill and dense decode once per layer per step; the
    fused and legacy loops give identical tokens."""
    import numpy as np

    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    rng = np.random.RandomState(17)
    prompt_lens = rng.randint(64, 501, size=4)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n in prompt_lens]
    new_tokens = 32
    engine = ServingEngine(get_model(cfg), params,
                           ServeConfig(max_new_tokens=new_tokens))
    decode.KERNEL.launches = 0                   # counts of this path
    flash.KERNEL.launches = 0
    t0 = time.perf_counter()
    fused = engine.generate_batch(prompts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"decode_attention": decode.KERNEL.launches,
                "flash_attention": flash.KERNEL.launches}
    legacy = engine.generate_batch(prompts, fused=False)
    torch.cuda.synchronize()
    n_out = sum(len(o) for o in fused)
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (new_tokens - 1)}
    log(f"[moe] whole-batch, prompts {prompt_lens.tolist()}, {new_tokens} "
        f"new tokens each: fused {n_out} tokens in {dt:.2f} s = "
        f"{n_out / dt:.1f} tokens/s (host clock, prefill included); "
        f"launches flash_attention={launches['flash_attention']}, "
        f"decode_attention={launches['decode_attention']} (want {want}); "
        f"fused and legacy loop "
        f"{'token-identical' if fused == legacy else 'DIFFER'}")
    if not all(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                            for t in o) for o in fused):
        raise AssertionError(f"moe whole-batch: a request did not get "
                             f"{new_tokens} in-vocab tokens")
    if launches != want:
        raise AssertionError(f"moe whole-batch: launches {launches}, not "
                             f"one per layer per call {want}")
    if fused != legacy:
        raise AssertionError("moe whole-batch: fused and legacy loop "
                             "disagree")
    return dict(tok_s=n_out / dt, launches=launches)


def moe_parity(torch):
    """llama4-scout and grok-1 reduced in f32 (grok at ep_shards = 2E,
    the full grok block layout), the paged engine on the kernel route
    against the plain route.  Hard: identical greedy tokens on traffic
    with no row that carries no request (4 requests of 64 tokens, chunks
    of 32, max_batch 4, sharing off, no eos).  Reported: on ragged
    traffic (5 prompts of 5-40 tokens, staggered slots) how many
    requests differ: an idle prefill slot is exact zeros on the kernels
    and a uniform softmax in the plain version, and its rows take
    capacity (the reference's designed divergence)."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    for arch, change in MOE_REDUCED_PARITY:
        cfg = dataclasses.replace(configs.get(arch).reduced(),
                                  dtype="float32", **change)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        params = get_model(cfg).init(gen, "cuda")
        rng = np.random.RandomState(3)
        even = [rng.randint(0, cfg.vocab_size, size=64).astype(np.int32)
                for _ in range(4)]
        ragged = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                  for n in rng.randint(5, 41, size=5)]
        runs = {}
        for traffic, prompts, scfg in (
                ("even", even, ServeConfig(
                    max_batch=4, max_seq=96, max_new_tokens=16,
                    page_size=16, prefill_chunk_tokens=32,
                    prefix_sharing=False, retain_prefixes=False)),
                ("ragged", ragged, ServeConfig(
                    max_batch=4, max_seq=48, max_new_tokens=6, page_size=8,
                    prefill_chunk=3))):
            for plain in (False, True):
                engine = PagedEngine(get_model(cfg, plain_attention=plain),
                                     params, scfg)
                rids = [engine.submit(p) for p in prompts]
                res = engine.run()
                runs[traffic, plain] = [res[r] for r in rids]
        same = {t: sum(a == b for a, b in zip(runs[t, False], runs[t, True]))
                for t in ("even", "ragged")}
        log(f"[moe parity] {cfg.name} f32 (G {cfg.ep_shards}, E "
            f"{cfg.n_experts}, top-{cfg.experts_per_token}, "
            f"{cfg.ffn_kind}), kernel vs plain route: no empty row (4 x 64 "
            f"tokens) {same['even']}/4 requests token-identical; ragged "
            f"traffic {same['ragged']}/5 identical (reported: the designed "
            f"divergence)")
        if same["even"] != 4:
            raise AssertionError(f"moe parity: {cfg.name} kernel and plain "
                                 f"route disagree with no empty row")


# ---------------------------------------------------------------------------
# the stub-frontend families: qwen2-vl (M-RoPE, embeddings) and whisper
# ---------------------------------------------------------------------------

VLM_ARCH = "qwen2-vl-72b"
# 24 of 80 layers: a layer is 0.878 G parameters (1.756 GB of bf16), the
# untied embed and unembed 4.98 GB, so 24 layers make 47.1 GB (80 would
# be 145.4 GB), with room beside them for the f32 unembed copy of
# ``_logits_exact`` (4.98 GB) and the plain route's comparisons
VLM_LAYERS = 24
VLM_GRID = (12, 16)              # the image's patch grid: rows, columns
VLM_TEXT = 64                    # text tokens after the image
AUDIO_ARCH = "whisper-large-v3"
AUDIO_FRAMES = 1500              # the encoder's published positions
AUDIO_PARITY_LAYERS = 4          # encoder and decoder, the f32 parity run


def vlm_positions(torch, B):
    """Qwen2-VL's position layout for one image then text: the grid's
    patches at t = 0, h = their row, w = their column; the text after it
    on all three streams together, from one past the grid's largest
    position.  Returns (3, B, S) int32 on the card."""
    rows, cols = VLM_GRID
    r = torch.arange(rows * cols, device="cuda") // cols
    c = torch.arange(rows * cols, device="cuda") % cols
    text = max(rows, cols) + torch.arange(VLM_TEXT, device="cuda")
    pos = torch.stack([torch.cat([torch.zeros_like(r), text]),
                       torch.cat([r, text]), torch.cat([c, text])])
    return pos[:, None].expand(3, B, pos.shape[1]).to(torch.int32)


def vlm_phase(torch, decode_kernel, prefill_kernel):
    """qwen2-vl-72b at its published widths and 24 of its 80 layers, bf16,
    random weights: serve's traffic as text prompts through
    ``PagedEngine`` (sharing off), one prefill chunk and one decode step
    against the plain route; then one whole-batch ``Model.prefill`` of
    embeddings with the image-then-text M-RoPE layout and 32 greedy
    ``decode_step``s, its logits against the plain route and against the
    same prefill with three equal streams."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import PagedEngine, ServeConfig
    free, total = torch.cuda.mem_get_info()
    log(f"[vlm] device memory at phase start: {free / 2**30:.2f} GiB free "
        f"of {total / 2**30:.2f} GiB; on {gpu_line()}")
    cfg = dataclasses.replace(configs.get(VLM_ARCH), n_layers=VLM_LAYERS)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[vlm] {VLM_ARCH}: {cfg.n_layers} of 80 layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, M-RoPE "
        f"sections {cfg.mrope_sections}, qkv bias: {n_params / 1e9:.3f} B "
        f"params, {n_params * 2 / 1e9:.2f} GB in bf16, init "
        f"{time.perf_counter() - t0:.1f} s")

    new_tokens = 32
    rng = np.random.RandomState(7)               # the serve phase's traffic
    prompt_lens = rng.randint(64, 301, size=8)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n in prompt_lens]
    scfg = ServeConfig(max_batch=4, max_seq=int(prompt_lens.max())
                       + new_tokens + 16, max_new_tokens=new_tokens,
                       page_size=16, prefill_chunk_tokens=32,
                       prefix_sharing=False, retain_prefixes=False)
    engine = PagedEngine(model, params, scfg)
    rids = [engine.submit(p) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    step_s = 0.0
    decode_kernel.launches = 0                   # counts of this path
    prefill_kernel.launches = 0
    while engine.busy:
        t0 = time.perf_counter()
        engine.step()
        step_s += time.perf_counter() - t0
        engine.kv.check()
    torch.cuda.synchronize()
    paged_launches = {"decode": decode_kernel.launches,
                      "prefill": prefill_kernel.launches}
    tokens = [engine.results[r] for r in rids]
    n_out = sum(len(t) for t in tokens)
    log(f"[vlm] paged, sharing off, serve's 8 requests as text prompts "
        f"(prompts {prompt_lens.tolist()}, {new_tokens} new): {n_out} "
        f"tokens in {step_s:.2f} s of step() = {n_out / step_s:.1f} "
        f"tokens/s (host clock), {engine.ticks} ticks; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"paged_decode_attention={paged_launches['decode']}, "
        f"paged_prefill_attention={paged_launches['prefill']} "
        f"({cfg.n_layers} per call); kv.check() clean every tick")
    if not all(len(t) == new_tokens and all(0 <= x < cfg.vocab_size
                                            for x in t) for t in tokens):
        raise AssertionError(f"vlm: a request did not get {new_tokens} "
                             f"in-vocab tokens")
    if not all(n > 0 and n % cfg.n_layers == 0
               for n in paged_launches.values()):
        raise AssertionError(f"vlm: a paged kernel was not launched once "
                             f"per layer of its calls: {paged_launches}")
    split = host_split(engine, step_s)
    log_host("vlm", split)
    del engine
    compare_logits(torch, cfg, params, phase="vlm")

    # the whole-batch embeddings prefill and its decode steps
    B = 2
    pos = vlm_positions(torch, B)
    S = pos.shape[-1]
    embeds = (torch.randn(B, S, cfg.d_model, generator=gen, device="cuda")
              * 0.02).to(cfg.param_dtype)     # the token embeddings' scale
    flat = torch.arange(S, device="cuda", dtype=torch.int32)[None, None]
    flat = flat.expand(3, B, S)
    out, wb_launches, first = {}, {}, None
    with torch.no_grad():
        # the plain route first: its argmax is every route's first token,
        # so that the first decode steps compare on one input
        for name, plain, p in (("plain", True, pos), ("kernel", False, pos),
                               ("equal streams", False, flat)):
            m = get_model(cfg, plain_attention=plain)
            decode.KERNEL.launches = flash.KERNEL.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, parts = m.prefill(params, {"embeds": embeds,
                                             "positions": p})
            cache = m.init_cache(B, S + new_tokens, "cuda")
            for k, src in parts.items():
                cache[k][:, :, :S] = src
            cache["pos"] = torch.tensor(S, dtype=torch.int32, device="cuda")
            del parts
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            if first is None:
                first = last.argmax(-1).to(torch.int32)[:, None]
            t0 = time.perf_counter()
            step, cache = m.decode_step(params, first, cache)
            toks, cache, _ = m.decode_many(
                params, step.argmax(-1).to(torch.int32)[:, None], cache,
                None, new_tokens - 1)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            out[name] = dict(last=last.float(), step=step.float(),
                             toks=torch.cat([first.T, toks]).cpu(),
                             prefill_s=prefill_s, decode_s=decode_s)
            wb_launches[name] = {"flash_attention": flash.KERNEL.launches,
                                 "decode_attention": decode.KERNEL.launches}
            del cache
    k = out["kernel"]
    log(f"[vlm] whole-batch Model.prefill of embeddings, B={B}: a "
        f"{VLM_GRID[0]}x{VLM_GRID[1]} patch grid (t 0, h the row, w the "
        f"column) then {VLM_TEXT} text positions from {max(VLM_GRID)} on "
        f"all three streams (S={S}); prefill {k['prefill_s'] * 1e3:.1f} ms, "
        f"then {new_tokens} greedy decode_steps in {k['decode_s']:.2f} s = "
        f"{B * new_tokens / k['decode_s']:.1f} tokens/s (host clock); "
        f"launches {wb_launches['kernel']} (flash once per layer, dense "
        f"decode once per layer per step); tokens in vocabulary "
        f"{bool(((k['toks'] >= 0) & (k['toks'] < cfg.vocab_size)).all())}"
        f"; on {gpu_line()}")
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * new_tokens}
    if wb_launches["kernel"] != want:
        raise AssertionError(f"vlm whole-batch: launches "
                             f"{wb_launches['kernel']}, want {want}")
    if not bool(((k["toks"] >= 0) & (k["toks"] < cfg.vocab_size)).all()):
        raise AssertionError("vlm whole-batch: an out-of-vocab token")
    ulp_check("vlm", "embeddings prefill logits, kernel vs plain route",
              k["last"], out["plain"]["last"])
    ulp_check("vlm", "first decode step logits after it, kernel vs plain "
              "route", k["step"], out["plain"]["step"])
    same = int((k["toks"] == out["plain"]["toks"]).all(0).sum())
    log(f"[vlm] greedy tokens, kernel vs plain route: {same}/{B} sequences "
        f"identical over {new_tokens} (bf16: reported)")
    moved = (k["last"] - out["equal streams"]["last"]).abs().max().item()
    lim = LOGIT_ULPS * 2.0 ** -8 * k["last"].abs().max().item()
    log(f"[vlm] the same embeddings with three equal arange streams: "
        f"prefill logits move by max|diff|={moved:.4e} against the layout's "
        f"(the 8-ulp bound is {lim:.4e}): the sections see distinct "
        f"streams")
    if not moved > lim:
        raise AssertionError(f"vlm: distinct M-RoPE streams moved the "
                             f"logits by {moved:.4e}, within {lim:.4e}")
    del params
    torch.cuda.empty_cache()
    return dict(tok_s=n_out / step_s, host=split, launches=paged_launches,
                wb_launches=wb_launches["kernel"],
                wb_tok_s=B * new_tokens / k["decode_s"], free_gib=free / 2**30)


def audio_inputs(torch, gen, cfg, B):
    """B requests of AUDIO_FRAMES seeded random frames (unit normal: the
    encoder layernorms them) and 4 decoder prompt tokens."""
    frames = torch.randn(B, AUDIO_FRAMES, cfg.d_model, generator=gen,
                         device="cuda").to(cfg.param_dtype)
    toks = torch.randint(0, cfg.vocab_size, (B, 4), generator=gen,
                         device="cuda").to(torch.int32)
    return {"frames": frames, "tokens": toks}


def audio_generate(torch, m, params, batch, steps, first=None):
    """``Model.prefill`` of frames and tokens into a cache of
    AUDIO_FRAMES rows (the cross cache unpadded), then ``steps`` greedy
    tokens: one ``decode_step`` (fed ``first`` where given, else the
    prefill's argmax) and ``decode_many`` for the rest.  Returns (prefill
    logits, first step's logits, tokens (steps, B), prefill s, decode
    s)."""
    B, S = batch["tokens"].shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, parts = m.prefill(params, batch)
    cache = m.init_cache(B, AUDIO_FRAMES, "cuda")
    for k, src in parts.items():
        cache[k][:, :, :src.shape[2]] = src
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device="cuda")
    del parts
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if first is None:
        first = last.argmax(-1).to(torch.int32)[:, None]
    step, cache = m.decode_step(params, first, cache)
    toks, cache, _ = m.decode_many(
        params, step.argmax(-1).to(torch.int32)[:, None], cache, None,
        steps - 1)
    torch.cuda.synchronize()
    return (last.float(), step.float(), torch.cat([first.T, toks]).cpu(),
            prefill_s, time.perf_counter() - t0)


def audio_phase(torch):
    """whisper-large-v3 at full width and depth (32 + 32 layers), bf16,
    random weights, the reference dispatch's chunks at 500 (the one
    config change: 1024 divides no 1500-row encoder): 4 requests of 1500
    frames and 4 prompt tokens, ``Model.prefill`` then 32 greedy tokens
    through ``decode_many``; the prefill's and the first step's logits
    against the plain route; the encoder's device time.  Then the same at
    4 + 4 layers in f32, kernel route against plain: identical greedy
    tokens."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models import transformer
    from repro_torch.models.model import get_model
    cfg = dataclasses.replace(configs.get(AUDIO_ARCH),
                              attn_chunk_q=WHISPER_CHUNK,
                              attn_chunk_kv=WHISPER_CHUNK)
    kern, plain = get_model(cfg), get_model(cfg, plain_attention=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = kern.init(gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[audio] {AUDIO_ARCH}: {cfg.encoder_layers} + {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads of {cfg.head_dim}, d_ff {cfg.d_ff} (gelu), layernorm, vocab "
        f"{cfg.vocab_size} tied: {n_params / 1e9:.3f} B params, "
        f"{n_params * 2 / 1e9:.2f} GB in bf16, init "
        f"{time.perf_counter() - t0:.1f} s; attn_chunk_q = attn_chunk_kv = "
        f"{WHISPER_CHUNK} (the published 1024 makes the reference dispatch "
        f"refuse S = T = {AUDIO_FRAMES}; no width moves)")
    B, steps = 4, 32
    batch = audio_inputs(torch, gen, cfg, B)
    with torch.no_grad():
        audio_generate(torch, kern, params, batch, 2)          # warm-up
        flash.KERNEL.launches = decode.KERNEL.launches = 0     # this path
        k_last, k_step, k_toks, pre_s, dec_s = audio_generate(
            torch, kern, params, batch, steps)
        launches = {"flash_attention": flash.KERNEL.launches,
                    "decode_attention": decode.KERNEL.launches}
        # the first decode step fed the kernel route's first tokens
        p_last, p_step, p_toks, _, _ = audio_generate(
            torch, plain, params, batch, steps, first=k_toks[0][:, None].to(
                "cuda"))
        enc_ms = time_ms(lambda i: transformer.whisper_encode(
            params, cfg, batch["frames"]), iters=5, warmup=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            transformer.whisper_encode(params, cfg, batch["frames"])
            torch.cuda.synchronize()
        by_kernel = {e.key: e.device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.device_time_total > 0}
    enc_dev = sum(by_kernel.values()) / 1e3
    flash_dev = sum(v for k_, v in by_kernel.items() if "flash" in k_) / 1e3
    want = {"flash_attention": cfg.encoder_layers + 2 * cfg.n_layers,
            "decode_attention": cfg.n_layers * steps}
    ok = bool(((k_toks >= 0) & (k_toks < cfg.vocab_size)).all())
    log(f"[audio] B={B} x {AUDIO_FRAMES} frames, 4 prompt tokens: prefill "
        f"{pre_s * 1e3:.1f} ms, {steps} greedy tokens in {dec_s:.2f} s = "
        f"{B * steps / dec_s:.1f} tokens/s (host clock); launches "
        f"{launches} (want {want}: flash for the encoder, the decoder and "
        f"the cross-attention, once per layer; dense decode once per "
        f"decoder layer per step; a step's cross-attention is one query "
        f"row, the direct path); tokens in vocabulary {ok}; on {gpu_line()}")
    log(f"[audio] encoder ({cfg.encoder_layers} layers, B={B}, "
        f"S={AUDIO_FRAMES}): "
        f"{enc_ms:.2f} ms a call (CUDA events, back to back); device time "
        f"of its CUDA kernels {enc_dev:.2f} ms (torch.profiler), of which "
        f"flash {flash_dev:.2f} ms")
    if launches != want:
        raise AssertionError(f"audio: launches {launches}, want {want}")
    if not ok:
        raise AssertionError("audio: an out-of-vocab token")
    ulp_check("audio", "prefill logits, kernel vs plain route", k_last,
              p_last)
    ulp_check("audio", "first decode step logits, kernel vs plain route",
              k_step, p_step)
    same = int((k_toks == p_toks).all(0).sum())
    log(f"[audio] greedy tokens, kernel vs plain route: {same}/{B} "
        f"sequences identical over {steps} (bf16: reported)")
    del params, batch
    torch.cuda.empty_cache()

    # f32 at reduced depth: identical greedy tokens on both routes
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=AUDIO_PARITY_LAYERS,
                                encoder_layers=AUDIO_PARITY_LAYERS)
    gen.manual_seed(1)
    params = get_model(cfg32).init(gen, "cuda")
    batch = audio_inputs(torch, gen, cfg32, 2)
    with torch.no_grad():
        runs = [audio_generate(torch, get_model(cfg32, plain_attention=p),
                               params, batch, 16) for p in (False, True)]
    same32 = int((runs[0][2] == runs[1][2]).all(0).sum())
    err = (runs[0][0] - runs[1][0]).abs().max().item()
    log(f"[audio parity] {AUDIO_ARCH} at published widths, "
        f"{AUDIO_PARITY_LAYERS} + {AUDIO_PARITY_LAYERS} layers, f32, 2 x "
        f"{AUDIO_FRAMES} frames: kernel vs plain route {same32}/2 sequences "
        f"token-identical over 16 greedy tokens; prefill logits max|diff|="
        f"{err:.3e}")
    if same32 != 2:
        raise AssertionError("audio parity: kernel and plain route disagree "
                             "in f32")
    del params
    torch.cuda.empty_cache()
    return dict(tok_s=B * steps / dec_s, launches=launches, enc_ms=enc_ms,
                enc_dev_ms=enc_dev, enc_flash_ms=flash_dev,
                prefill_ms=pre_s * 1e3)


# ---------------------------------------------------------------------------
# hybrid: zamba2-7b at full width and depth through ServingEngine
# ---------------------------------------------------------------------------

HYBRID_ARCH = "zamba2-7b"
HYBRID_PARITY_LAYERS = 13        # the f32 parity: G = 2 groups, R = 1 tail
HYBRID_MARK = "ssd_scan"         # the profiler range around each SSD scan


def profiled_ms(torch, fn, mark=None):
    """``fn()`` once under ``torch.profiler``: (device ms of all its CUDA
    work, device ms of the kernels launched inside ``mark`` ranges, or
    None without a mark).  A range's kernels are those the profiler links
    to the CPU ops under it; 0 where it links none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    total = sum(e.device_time_total for e in events
                if e.device_type == cuda and e.name != mark) / 1e3
    if mark is None:
        return total, None
    return total, sum(e.device_time_total for e in events
                      if e.device_type != cuda and e.name == mark) / 1e3


def hybrid_generate(torch, engine, prompts, fused):
    """One ``generate_batch`` with the dense kernels' counts set to 0
    just before it: (tokens, host s, {kernel: launches})."""
    from repro_torch.kernels.decode_attention import decode
    from repro_torch.kernels.flash_attention import flash
    decode.KERNEL.launches = flash.KERNEL.launches = 0
    t0 = time.perf_counter()
    out = engine.generate_batch(prompts, fused=fused)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {
        "flash_attention": flash.KERNEL.launches,
        "decode_attention": decode.KERNEL.launches}


def hybrid_phase(torch):
    """zamba2-7b at its published widths and full depth (81 Mamba2
    layers, the shared block after every 6th: 13 applications, 3 tail
    layers), bf16, random weights, through ``ServingEngine``: 4 prompts
    of 64-500 tokens (the longest not a multiple of the SSD chunks), 32
    greedy tokens; fused and legacy loops; the routes against each
    other; the host split and the SSD scan's share of a prefill; the
    dense kernels timed at D = 112; then the reduced f32 parity."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    free, total = torch.cuda.mem_get_info()
    log(f"[hybrid] device memory at phase start: {free / 2**30:.2f} GiB "
        f"free of {total / 2**30:.2f} GiB "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated by "
        f"this process); on {gpu_line()}")
    cfg = configs.get(HYBRID_ARCH)               # full width and depth
    k, G = cfg.attn_every, cfg.n_layers // cfg.attn_every
    model = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[hybrid] {HYBRID_ARCH}: {cfg.n_layers} Mamba2 layers (d_model "
        f"{cfg.d_model}, d_in {cfg.d_model * cfg.ssm_expand}, "
        f"{cfg.d_model * cfg.ssm_expand // cfg.ssm_head_dim} SSD heads of "
        f"{cfg.ssm_head_dim}, N {cfg.ssm_state}, chunks of {cfg.ssm_chunk})"
        f" and one shared block ({cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}) after every {k}: {G} "
        f"applications, {cfg.n_layers - G * k} tail layers; "
        f"{n_params / 1e9:.3f} B params, {n_params * 2 / 1e9:.2f} GB in "
        f"bf16, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(17)              # the whole-batch phase's
    prompt_lens = rng.randint(64, 501, size=4)   # prompt lengths
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n in prompt_lens]
    new_tokens, S = 32, int(prompt_lens.max())
    if S % cfg.ssm_chunk == 0:
        raise AssertionError(f"hybrid: S = {S} must leave a ragged SSD "
                             f"chunk")
    engine = ServingEngine(model, params,
                           ServeConfig(max_new_tokens=new_tokens))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fused, dt, launches = hybrid_generate(torch, engine, prompts, True)
        legacy, dt_legacy, legacy_launches = hybrid_generate(
            torch, engine, prompts, False)
    n_out = sum(len(o) for o in fused)
    want = {"flash_attention": G, "decode_attention": G * (new_tokens - 1)}
    log(f"[hybrid] prompts {prompt_lens.tolist()} (right-aligned to S={S}:"
        f" SSD chunks of {cfg.ssm_chunk} and {S % cfg.ssm_chunk}), "
        f"{new_tokens} new tokens each: fused {n_out} tokens in {dt:.2f} s "
        f"= {n_out / dt:.1f} tokens/s, legacy loop {dt_legacy:.2f} s = "
        f"{n_out / dt_legacy:.1f} tokens/s (host clock, prefill included); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[hybrid] launches: fused {launches}, legacy {legacy_launches} "
        f"(want {want}: flash once per application in the prefill, dense "
        f"decode once per application per step, both at D = "
        f"{cfg.head_dim})")
    if not all(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                            for t in o) for o in fused):
        raise AssertionError(f"hybrid: a request did not get {new_tokens} "
                             f"in-vocab tokens")
    if fused != legacy:
        raise AssertionError("hybrid: fused and legacy loop disagree")
    if launches != want or legacy_launches != want:
        raise AssertionError(f"hybrid: launches {launches} and "
                             f"{legacy_launches}, want {want}")
    log("[hybrid] fused and legacy loop: 4/4 requests token-identical")
    split = hybrid_host_split(torch, cfg, engine, prompts, ssm_mod)
    del engine
    compare_hybrid_paths(torch, cfg, params, prompts)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    timing = hybrid_timing(torch, S, G)
    hybrid_parity(torch)
    return dict(launches=launches, tok_s=n_out / dt, S=S, timing=timing,
                free_gib=free / 2**30, **split)


def hybrid_host_split(torch, cfg, engine, prompts, ssm_mod):
    """One prefill and one decode step, each timed on the host clock
    (synchronised) and traced by ``torch.profiler``: device ms beside host
    ms, the rest the device's idle share; and the SSD scans' device ms in
    the prefill (each call wrapped in a profiler range)."""
    import numpy as np
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    model, params = engine.model, engine.params
    scan = ssm_mod.ssd_scan

    def marked(*args):
        with torch.profiler.record_function(HYBRID_MARK):
            return scan(*args)

    with torch.no_grad():
        last, cache = engine._prefill_cache(prompts, 4)
        nxt = last.argmax(-1).to(torch.int32)[:, None]
        model.decode_step(params, nxt, cache)                 # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, batch)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        model.decode_step(params, nxt, cache)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        ssm_mod.ssd_scan = marked
        try:
            pre_dev, scan_dev = profiled_ms(
                torch, lambda: model.prefill(params, batch), HYBRID_MARK)
        finally:
            ssm_mod.ssd_scan = scan
        step_dev, _ = profiled_ms(
            torch, lambda: model.decode_step(params, nxt, cache))
    log(f"[hybrid] host split: a prefill (B={len(prompts)}, S={S}) "
        f"{pre_ms:.1f} ms host clock, {pre_dev:.2f} ms of device time "
        f"(torch.profiler; the device idles {100 * (1 - pre_dev / pre_ms):.1f}"
        f"%); the SSD scans {scan_dev:.2f} ms of it "
        f"({100 * scan_dev / pre_dev:.1f}%, {cfg.n_layers} calls); a decode "
        f"step {step_ms:.2f} ms host clock, {step_dev:.3f} ms of device time"
        f" (idle {100 * (1 - step_dev / step_ms):.1f}%); on {gpu_line()}")
    return dict(prefill_ms=pre_ms, prefill_dev_ms=pre_dev,
                scan_dev_ms=scan_dev, step_ms=step_ms, step_dev_ms=step_dev)


# The depth at which the hybrid phase holds the two routes' logits and
# states to LOGIT_ULPS: the first 13 layers (2 shared-block applications,
# 1 tail layer) of the full-width weights.  At all 81 layers this random
# network turns one bf16 ulp in 1e-3 of one application's attention
# outputs into a logit change ~3x that bound (PERF.md, PR 27): the
# full-depth drift is printed beside that floor, and each application's
# flash output is held against plain attention on the same inputs.
HYBRID_ULP_LAYERS = 13


def hybrid_route_pair(torch, cfg, params, prompts, attend=None,
                      routes=("kernel", "plain")):
    """The kernel and plain routes' prefill (last-position logits, conv
    and ssm states) and one decode step's logits (fed the plain route's
    prefill argmax) from the same prompts; ``attend(direct_attention)``
    wraps the plain route's prefill attention.  Returns {route: [prefill
    logits, decode logits, conv, ssm]}."""
    from repro_torch.models import attention as attention_mod
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    out = {}
    plain_of = {"kernel": False, "plain": True}
    with torch.no_grad():
        for route in routes:
            plain = plain_of[route]
            m = get_model(cfg, plain_attention=plain)
            direct = attention_mod.direct_attention
            if plain and attend is not None:
                attention_mod.direct_attention = attend(direct)
            try:
                last, cache = ServingEngine(m, params, ServeConfig()
                                            )._prefill_cache(prompts, 2)
            finally:
                attention_mod.direct_attention = direct
            states = (cache["conv"].float(), cache["ssm"].clone())
            out[route] = [last.float(), cache, *states]
        nxt = out["plain"][0].argmax(-1).to(torch.int32)[:, None]
        for route in routes:
            step, _ = get_model(cfg, plain_attention=plain_of[route]
                                ).decode_step(params, nxt, out[route][1])
            out[route][1] = step.float()
    return out


def compare_hybrid_paths(torch, cfg, params, prompts):
    """The two routes at full width.  At all 81 layers: every shared-block
    application's flash output held against plain attention on the same
    inputs (TOL), the drift of the prefill's and one decode step's
    logits and of the states printed beside the floor (the plain prefill
    with the last bit of its attention outputs flipped in the share of
    elements where flash differs).  At the first HYBRID_ULP_LAYERS
    layers: the prefill's logits, every layer's conv and ssm state (to
    its stack's scale, as the ssm phase holds falcon's) and one decode
    step's logits within LOGIT_ULPS bf16 ulps of the plain route."""
    import dataclasses

    from repro_torch.kernels.flash_attention import flash
    tol, _ = TOL["bfloat16"]
    seen = {"calls": 0, "err": 0.0, "share": []}

    def both(direct):
        def run(q, k, v, causal, *rest):
            want = direct(q, k, v, causal, *rest)
            got = flash.launch(q, k, v, causal)
            seen["err"] = max(seen["err"], check_close(
                f"hybrid application {seen['calls']} flash", got, want, tol))
            seen["share"].append((got != want).float().mean().item())
            seen["calls"] += 1
            return want
        return run

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def flip(direct):
        share = sum(seen["share"]) / len(seen["share"])

        def run(*args):
            out = direct(*args)
            mask = (torch.rand(out.shape, generator=gen, device=out.device)
                    < share).to(torch.int16)
            return (out.view(torch.int16) ^ mask).view(out.dtype)
        return run

    full = hybrid_route_pair(torch, cfg, params, prompts, both)
    G = cfg.n_layers // cfg.attn_every
    if seen["calls"] != G:
        raise AssertionError(f"hybrid: {seen['calls']} attention calls in "
                             f"the plain prefill, not {G}")
    log(f"[hybrid] every application's flash output against plain "
        f"attention on the same inputs ({G} of them, B={len(prompts)}, "
        f"S={max(len(p) for p in prompts)}, D={cfg.head_dim}): "
        f"max|kernel-plain|={seen['err']:.3e} (tol {tol}), differing "
        f"elements {100 * sum(seen['share']) / G:.2f}%")
    floor = hybrid_route_pair(torch, cfg, params, prompts, flip,
                              routes=("plain",))["plain"]
    names = ("prefill logits", "decode step logits", "conv state",
             "ssm state")
    for i, name in enumerate(names):
        k, p, f = full["kernel"][i], full["plain"][i], floor[i]
        if i == 1:
            f = None                  # the floor's prefill only
        lim = LOGIT_ULPS * 2.0 ** -8 * p.abs().max().item()
        log(f"[hybrid] {cfg.n_layers} layers, {name}, kernel vs plain "
            f"route: max|diff|={(k - p).abs().max().item():.4e} = "
            f"{(k - p).abs().max().item() / lim:.2f} x the {LOGIT_ULPS}-ulp "
            f"bound {lim:.4e}"
            + ("" if f is None else
               f"; floor (one bit flipped in "
               f"{100 * sum(seen['share']) / G:.2f}% of the plain "
               f"attention outputs) {(f - p).abs().max().item():.4e} = "
               f"{(f - p).abs().max().item() / lim:.2f} x"))
    del full, floor
    torch.cuda.empty_cache()

    n = HYBRID_ULP_LAYERS
    cut = dataclasses.replace(cfg, n_layers=n)
    cut_params = dict(params, blocks=first_layers(params["blocks"], n))
    pair = hybrid_route_pair(torch, cut, cut_params, prompts)
    ulp_check("hybrid", f"{n} layers, prefill logits, kernel vs plain "
              f"route", pair["kernel"][0], pair["plain"][0])
    ulp_check("hybrid", f"{n} layers, decode step logits, kernel vs plain "
              f"route", pair["kernel"][1], pair["plain"][1])
    for i, name in ((2, "conv"), (3, "ssm")):
        a, b = pair["kernel"][i], pair["plain"][i]
        err = (a - b).abs().max().item()
        lim = LOGIT_ULPS * 2.0 ** -8 * b.abs().max().item()
        diff = (a - b).abs().flatten(1).amax(1)
        ratio = (diff / (LOGIT_ULPS * 2.0 ** -8 * b.abs().flatten(1).amax(1))
                 .clamp(min=1e-30)).tolist()
        worst = max(range(n), key=ratio.__getitem__)
        log(f"[hybrid] {n} layers, prefill {name} state, kernel vs plain "
            f"route, every layer: max|diff|={err:.4e}, bound {lim:.4e} "
            f"({LOGIT_ULPS} bf16 ulps of the stack's scale); against its "
            f"own scale the worst layer is {worst} at {ratio[worst]:.3f} "
            f"of its bound; the {cfg.attn_every} layers before the first "
            f"shared block differ by {diff[:cfg.attn_every].max().item():.1e}")
        if not err <= lim:
            raise AssertionError(f"hybrid {n} layers, {name} state: kernel "
                                 f"route drifts {err:.4e} > {lim:.4e}")


def hybrid_timing(torch, S, G):
    """The dense kernels at the hybrid phase's shapes (zamba2-7b's shared
    block, bf16, B = 4, 32 heads of 112 over 32): decode over a T = S + 32
    row cache cycling through the G applications' caches, flash at S =
    T = the longest prompt over 4 inputs."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(78)
    rows = dense_kernel_timing(torch, gen, B=4, H=32, KV=32, D=112,
                               T=S + 32, L=G, S=S, n_sets=4)
    log_dense_rows(rows, lambda name: "zamba2-7b")
    return rows


def hybrid_parity(torch):
    """zamba2-7b reduced to 13 layers (G = 2, R = 1) in f32 through
    ``ServingEngine``, kernel route against plain route: greedy tokens
    identical, at the reduced heads (16 wide) and with two heads of 112
    (the dense kernels' new instantiation).  Prompts right-aligned to 17
    (a ragged SSD chunk; direct attention on the plain route), 64 (the
    chunked reference) and 2."""
    import dataclasses

    from repro_torch import configs
    base = dataclasses.replace(configs.get(HYBRID_ARCH).reduced(),
                               n_layers=HYBRID_PARITY_LAYERS)
    for what, cfg in (("heads of 16", base),
                      ("heads of 112", dataclasses.replace(
                          base, n_heads=2, n_kv_heads=2, d_head=112))):
        same, total = route_parity(torch, cfg, 23,
                                   ((5, 17, 9), (64, 30, 2, 50), (1, 2)))
        log(f"[parity] {HYBRID_ARCH}-reduced, {HYBRID_PARITY_LAYERS} layers,"
            f" {what}, f32 ServingEngine, kernel vs plain route: "
            f"{same}/{total} requests token-identical")
        if same != total:
            raise AssertionError(f"hybrid ({what}): kernel and plain route "
                                 f"disagree in f32")


# ---------------------------------------------------------------------------
# train: qwen2-0.5b at full width and depth through the port's Trainer
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-0.5b"
TRAIN_S, TRAIN_B, TRAIN_MICRO = 4096, 8, 2
# 7 steps (a checkpoint at step 4 only), then steps 4-6 again from it
TRAIN_STEPS, TRAIN_RESUME = 7, 4
TRAIN_LR = 1e-3
TRAIN_RESUME_TOL = 2e-3             # the JAX test's rtol = atol for resume
# bf16 gradient leaves of Model.loss at 2 layers, S = 1024, kernel route
# against plain route: the bound on each leaf's relative norm error,
# written in PERF.md (PR 28) before the first run and never widened
TRAIN_BF16_GRAD_BOUND = 5e-2


def train_config():
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get(TRAIN_ARCH), remat="block")


def train_setup(steps, ckpt_dir=None):
    """The port's Trainer for the phase's run: qwen2-0.5b bf16, the
    synthetic pipeline at S 4096 and batch 8 (seed 0), constant lr 1e-3,
    f32 moments, 2 microbatches, weights from seed 0, a synchronous
    checkpoint every 4 steps into ``ckpt_dir``."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import constant
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = train_config()
    return Trainer(
        get_model(cfg),
        AdamWConfig(lr=constant(TRAIN_LR), moment_dtype="float32"),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                   global_batch=TRAIN_B, seed=0),
        TrainerConfig(steps=steps, checkpoint_every=TRAIN_RESUME,
                      checkpoint_dir=ckpt_dir, log_every=1,
                      microbatches=TRAIN_MICRO, seed=0,
                      async_checkpoint=False, device="cuda"))


def counted_steps(trainer, kernel=None):
    """Wraps the trainer's step so that each step runs with ``kernel``'s
    count (the flash kernel's by default) set to 0 just before it;
    returns the list that each step's count is appended to."""
    from repro_torch.kernels.flash_attention import flash
    kernel = kernel or flash.KERNEL
    per_step, inner = [], trainer.step_fn

    def step(*args):
        kernel.launches = 0
        out = inner(*args)
        per_step.append(kernel.launches)
        return out

    trainer.step_fn = step
    return per_step


def leaf_errors(torch, got, want):
    """{leaf path: (max abs err / max abs, relative norm error)}; a leaf
    the loss does not reach (rmsnorm's unused biases) must be zero on
    both routes and is left out."""
    out = {}

    def walk(g, w, path):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
            return
        g, w = g.float(), w.float()
        if w.abs().max().item() == 0:
            if g.abs().max().item() != 0:
                raise AssertionError(f"train grads {path}: zero on the "
                                     f"plain route, not on the kernel route")
            return
        d = g - w
        out[path] = ((d.abs().max() / w.abs().max()).item(),
                     (d.norm() / w.norm()).item())
    walk(got, want, "")
    return out


def route_grads(torch, tag, cfg, S, B, kernel, want, seed=5):
    """Every gradient leaf of one ``Model.loss`` of ``cfg`` (the batch
    from the synthetic pipeline at S and B, frames or embeddings as the
    launcher asks) on the kernel route against the plain route, in f32
    and bf16: f32 within 1e-4 of each leaf's max abs, bf16 relative norm
    error within TRAIN_BF16_GRAD_BOUND; ``kernel`` launched ``want``
    times by the kernel route.  Returns {dtype: worst error}."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models.model import get_model
    from repro_torch.models.params import init_params
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.trainer import batch_to_device
    worst = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(c, gen, "cuda")
        batch = batch_to_device(SyntheticTokenPipeline(data_config(
            c, S, B, seed)).batch_at(0), c, "cuda")
        kernel.launches = 0
        loss, grads = loss_and_grads(get_model(c), params, batch)
        if kernel.launches != want:
            raise AssertionError(f"{tag} grads {dtype}: {kernel.symbol} "
                                 f"launched {kernel.launches} times, not "
                                 f"{want}")
        want_loss, want_g = loss_and_grads(get_model(c, True), params, batch)
        errs = leaf_errors(torch, grads, want_g)
        if dtype == "float32":
            bad = {k: e for k, e in errs.items() if e[0] > 1e-4}
            worst[dtype] = max(e[0] for e in errs.values())
            rule = "max abs err within 1e-4 of the leaf's max abs"
        else:
            bad = {k: e for k, e in errs.items()
                   if e[1] > TRAIN_BF16_GRAD_BOUND}
            worst[dtype] = max(e[1] for e in errs.values())
            rule = (f"relative norm error within {TRAIN_BF16_GRAD_BOUND}")
        log(f"[{tag}] grads {c.name} {dtype} B={B} S={S}: loss kernel "
            f"{loss.item():.6f} plain {want_loss.item():.6f}; "
            f"{kernel.symbol} launches {want}; per leaf (max err / max abs, "
            f"rel norm err): " + ", ".join(
                f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in sorted(errs.items())))
        if bad or not torch.isfinite(loss):
            raise AssertionError(f"{tag} grads {dtype}: {rule} fails for "
                                 f"{sorted(bad)}")
        del params, grads, want_g
        torch.cuda.empty_cache()
    return worst


def data_config(cfg, S, B, seed=0):
    """The synthetic pipeline's config for ``cfg`` at S and B, with
    frames or embeddings as ``launch.train`` asks for them."""
    from repro_torch.data.pipeline import DataConfig
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                      seed=seed,
                      emit_embeddings=not cfg.embed_inputs
                      and not cfg.is_encoder_decoder,
                      emit_frames=cfg.is_encoder_decoder,
                      d_model=cfg.d_model)


def train_route_grads(torch):
    """Every gradient leaf of one ``Model.loss`` at 2 of qwen2-0.5b's 24
    layers, full width, B 2, S 1024, kernel route (flash forward with L,
    the plain backward) against plain route (direct attention), f32 and
    bf16; flash launched twice a layer (forward, remat recompute)."""
    import dataclasses

    from repro_torch.kernels.flash_attention import flash
    return route_grads(torch, "train", dataclasses.replace(
        train_config(), n_layers=2), 1024, 2, flash.KERNEL, 4)


def train_reduced_parity(torch, arch=TRAIN_ARCH, tag="parity"):
    """``arch`` reduced in f32 through 3 ``make_train_step`` steps (B 4 in
    2 microbatches, S 64, frames or embeddings as the launcher asks) on
    the kernel and the plain route from the same weights: losses within
    1e-4, params within 1e-4 of their max abs."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models.model import get_model
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamW, AdamWConfig, tree_leaves
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import batch_to_device
    cfg = dataclasses.replace(configs.get(arch).reduced(), dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                         "cuda")
    pipe = SyntheticTokenPipeline(data_config(cfg, 64, 4))
    runs = []
    for plain in (False, True):
        opt = AdamW(AdamWConfig(lr=TRAIN_LR))
        step = make_train_step(get_model(cfg, plain), opt, microbatches=2)
        p, s, losses = params, opt.init(params), []
        for i in range(3):
            p, s, m = step(p, s, batch_to_device(pipe.batch_at(i), cfg,
                                                 "cuda"))
            losses.append(m["loss"].item())
        runs.append((losses, p))
    (kl, kp), (pl, pp) = runs
    scale = max(t.abs().max().item() for t in tree_leaves(pp))
    perr = max((a - b).abs().max().item()
               for a, b in zip(tree_leaves(kp), tree_leaves(pp)))
    lerr = max(abs(a - b) for a, b in zip(kl, pl))
    log(f"[{tag}] {arch}-reduced f32, 3 train steps, kernel vs plain "
        f"route: losses {kl} vs {pl} (max diff {lerr:.2e}); params max diff "
        f"{perr:.2e} of max abs {scale:.3f}")
    if lerr > 1e-4 + 1e-4 * max(pl) or perr > 1e-4 * scale:
        raise AssertionError(f"{tag}: {arch} kernel and plain route differ "
                             f"in f32")
    return lerr, perr / scale


def lse_timing(torch, label, B, S, H, KV, D, causal, chunk, seed):
    """The flash kernel with L (bf16) at one training shape, cycling
    through 4 inputs: kernel, the plain chunked forward (with L, chunks
    of ``chunk``) and SDPA's forward; its bound, logged under ``label``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.attention import repeat_kv
    from repro_torch.models.flash import _flash_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = 4
    qs, ks, vs = zip(*(dense_inputs(gen, B, S, S, H, KV, D, torch.bfloat16)
                       for _ in range(n)))
    kernel = lambda i: flash.run(qs[i % n], ks[i % n], vs[i % n],  # noqa
                                 causal, with_lse=True)
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa
        qs[i % n].transpose(1, 2), ks[i % n].transpose(1, 2),
        vs[i % n].transpose(1, 2), is_causal=causal, enable_gqa=KV != H)
    pairs = S * (S + 1) // 2 if causal else S * S
    row = dict(ms=time_ms(kernel), library_ms=time_ms(sdpa),
               plain_ms=time_ms(lambda i: _flash_fwd(
                   qs[i % n], repeat_kv(ks[i % n], H),
                   repeat_kv(vs[i % n], H), causal, chunk, chunk), iters=6,
                   warmup=1),
               device_ms=device_ms(kernel), library_device_ms=device_ms(sdpa),
               shape=f"B={B} S=T={S} {'causal' if causal else 'non-causal'} "
                     f"H={H} KV={KV} D={D}, with L",
               bytes=flash.trip_model(B, S, S, H, KV, D, causal,
                                      with_lse=True)[0].io_bytes,
               flops=4 * D * B * H * pairs)
    log_dense_rows({"flash_attention": row}, lambda name: label)
    return row


def train_lse_timing(torch):
    """The flash kernel with L at the train shape (B 4, S = T = 4096, 14
    heads over 2 of 64, causal, bf16), cycling through 4 inputs: kernel,
    the plain chunked forward (with L, chunks of 512) and SDPA's forward;
    its bound."""
    return lse_timing(torch, f"{TRAIN_ARCH} train", 4, TRAIN_S, 14, 2, 64,
                      True, 512, 91)


def train_marks():
    """The functions a profiled train step puts a range around, (owner,
    attribute, part); the scan's and the SSD scan's run only on their
    families' steps."""
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.kernels.ssm_scan import scan
    from repro_torch.models import losses, ssm
    from repro_torch.optim import adamw
    return ((flash, "flash_bwd", "plain flash backward"),
            (losses._FusedXent, "forward", "fused loss"),
            (losses._FusedXent, "backward", "fused loss"),
            (adamw.AdamW, "update", "optimizer"),
            (scan.SelectiveScan, "backward", "plain scan backward"),
            (ssm, "ssd_scan", "SSD scans"))


AUTOGRAD_NODE = "autograd::engine::evaluate_function: "
FLASH_LSE = "flash_attention_tc_lse_kernel"
TRAIN_REST = "the rest (GEMMs, norms, rope, embedding)"


def train_split(torch, step, params, opt, batch):
    """One train step under ``torch.profiler``, a range (its part's name)
    around each of ``train_marks()``.  Each kernel is counted once: the
    flash forward kernel by name; else in the part of the innermost range
    or autograd node that launched it, a node belonging to the part whose
    range ran its forward op (matched by sequence number and thread), so
    that the SSD scans' part holds their forwards, remat recomputes and
    backwards; else in the rest.  Returns (device ms, {part: device ms},
    {"step": the step's host ms, part: host ms inside its ranges}); parts
    that took no time are left out."""
    import inspect

    from torch.profiler import ProfilerActivity, profile

    def marked(fn, part):
        def inner(*args, **kw):
            with torch.profiler.record_function(part):
                return fn(*args, **kw)
        return inner

    marks = train_marks()
    saved = [(o, a, inspect.getattr_static(o, a)) for o, a, _ in marks]
    for (o, a, part), (_, _, raw) in zip(marks, saved):
        fn = marked(getattr(o, a), part)
        setattr(o, a, staticmethod(fn) if isinstance(raw, staticmethod)
                else fn)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for o, a, raw in saved:
            setattr(o, a, raw)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    host = [e for e in events if e.device_type != cuda]
    names = {e.name for e in host}
    parts = {"flash forward kernel": 0.0}
    parts.update((part, 0.0) for *_, part in marks)

    def in_range(e):
        while e is not None and e.name not in parts:
            e = e.cpu_parent
        return e and e.name

    made = {(e.sequence_nr, e.thread): in_range(e) for e in host
            if e.sequence_nr >= 0 and not e.name.startswith(AUTOGRAD_NODE)
            and in_range(e)}

    def owner(e):
        while e is not None:
            if e.name in parts:
                return e.name
            if e.name.startswith(AUTOGRAD_NODE):
                part = made.get((e.sequence_nr, e.fwd_thread))
                if part:
                    return part
            e = e.cpu_parent
        return None

    # the device timeline also carries each range as an annotation of the
    # range's name: only kernels (names no CPU event has) are summed
    kernels = [e for e in events if e.device_type == cuda
               and e.name not in names]
    total = sum(e.device_time_total for e in kernels) / 1e3
    parts["flash forward kernel"] = sum(
        e.device_time_total for e in kernels if FLASH_LSE in e.name) / 1e3
    for e in host:
        ms = sum(k.duration for k in e.kernels if FLASH_LSE not in k.name)
        part = owner(e) if ms else None
        if part:
            parts[part] += ms / 1e3
    split = {k: v for k, v in parts.items() if v}
    split[TRAIN_REST] = total - sum(split.values())
    host_ms = {"step": step_ms}
    for part in split:
        spent = sum(e.cpu_time_total for e in host if e.name == part)
        if spent:
            host_ms[part] = spent / 1e3
    return total, split, host_ms


def train_phase(torch):
    """See the module docstring's ``train``.  Returns the phase's
    readings for the summary and the kernels line."""
    import shutil
    import statistics
    import tempfile

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import get_model
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import batch_to_device
    t_phase = time.perf_counter()
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    cfg = train_config()
    log(f"[train] {TRAIN_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.n_params():.4g} parameters, bf16; {free_gib:.2f} GiB free at "
        f"phase start; on {gpu_line()}")
    parts = {}
    t0 = time.perf_counter()
    lse = train_lse_timing(torch)
    parts["flash timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grad_err = train_route_grads(torch)
    train_reduced_parity(torch)
    torch.cuda.empty_cache()
    parts["route checks"] = time.perf_counter() - t0

    d = tempfile.mkdtemp(prefix="train-ckpt-")
    try:
        tr = train_setup(TRAIN_STEPS, d)
        per_step = counted_steps(tr)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = tr.run()
        run_s = time.perf_counter() - t0
        parts["straight run"] = run_s
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        hist = tr.history
        for h in hist:
            log(f"[train] step {h['step']}: loss {h['loss']:.6f} grad_norm "
                f"{h['grad_norm']:.6f} {h['time_s'] * 1e3:.1f} ms")
        losses = [h["loss"] for h in hist]
        norms = [h["grad_norm"] for h in hist]
        if not all(map(math.isfinite, losses + norms)):
            raise AssertionError(f"train: a loss or grad norm is not finite "
                                 f"({losses}, {norms})")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train: the last loss {losses[-1]} is not "
                                 f"below the first {losses[0]}")
        want = 2 * cfg.n_layers * TRAIN_MICRO
        if per_step != [want] * TRAIN_STEPS:
            raise AssertionError(f"train: flash launches a step {per_step}, "
                                 f"not {want} (layers x forward and "
                                 f"recompute x microbatches)")
        params, opt = out["params"], out["opt"]
        del out
        tr2 = train_setup(TRAIN_STEPS, d)
        t0 = time.perf_counter()
        out2 = tr2.run()
        resume_s = time.perf_counter() - t0
        parts["resumed run"] = resume_s
        resumed = out2["losses"]
        del out2
        log(f"[train] resumed from the step-{TRAIN_RESUME} checkpoint: "
            f"losses {resumed} against the straight run's "
            f"{losses[TRAIN_RESUME:]}; {resume_s:.1f} s with the restore")
        if len(resumed) != TRAIN_STEPS - TRAIN_RESUME or not all(
                abs(a - b) <= TRAIN_RESUME_TOL * (1 + abs(b))
                for a, b in zip(resumed, losses[TRAIN_RESUME:])):
            raise AssertionError("train: the resumed losses differ from the "
                                 "straight run's")
    finally:
        shutil.rmtree(d, ignore_errors=True)

    step_ms = statistics.median(h["time_s"] for h in hist[1:]) * 1e3
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    flops = get_model(cfg).model_flops(ShapeConfig("train", TRAIN_S,
                                                   TRAIN_B, "train"))
    tflops = flops / (step_ms / 1e3) / 1e12
    step = make_train_step(get_model(cfg), tr.optimizer,
                           microbatches=TRAIN_MICRO)
    batch = batch_to_device(tr.pipeline.batch_at(TRAIN_STEPS), cfg, "cuda")
    t0 = time.perf_counter()
    dev_total, split, _ = train_split(torch, step, params, opt, batch)
    parts["profiled step"] = time.perf_counter() - t0
    del params, opt, batch, tr, tr2
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] {TRAIN_STEPS} steps in {run_s:.1f} s; median step after "
        f"the first {step_ms:.1f} ms, {tok_s:.1f} tokens/s; model_flops "
        f"{flops:.4g} a step (6 N D), {tflops:.2f} TFLOP/s, "
        f"{100 * tflops / (BF16_FLOPS_PER_S / 1e12):.2f}% of the 989 "
        f"TFLOP/s bf16 peak; peak memory {peak_gib:.2f} GiB "
        f"(max_memory_allocated); on {gpu_line()}")
    log(f"[train] one step's device time (torch.profiler) {dev_total:.1f} ms"
        f" of {step_ms:.1f} ms: " + ", ".join(
            f"{k} {v:.1f} ms ({100 * v / dev_total:.1f}%)"
            for k, v in split.items()))

    t0 = time.perf_counter()
    rc = launch_train.main(["--arch", TRAIN_ARCH, "--steps", "2",
                            "--batch", str(TRAIN_B)])
    launch_s = parts["launcher"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"launch.train exited {rc}")
    log(f"[train] launch.train --arch {TRAIN_ARCH} --steps 2 --batch "
        f"{TRAIN_B}: {launch_s:.1f} s in process (weights, 2 steps)")
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + f"; the straight "
        f"run's steps {sum(h['time_s'] for h in hist):.1f} s of its "
        f"{run_s:.1f} (the rest: weights, the step-{TRAIN_RESUME} "
        f"checkpoint)")
    return dict(losses=losses, step_ms=step_ms, tok_s=tok_s, tflops=tflops,
                peak_share=tflops * 1e12 / BF16_FLOPS_PER_S, split=split,
                peak_gib=peak_gib, launches_per_step=per_step[0],
                lse_timing={k: lse[k] for k in (
                    "shape", "ms", "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "bound_by")},
                grad_err=grad_err)


# ---------------------------------------------------------------------------
# mesh: the training step on a one-rank device mesh
# ---------------------------------------------------------------------------

MESH_B, MESH_STEPS = 4, 2


def mesh_trainer():
    """The phase's Trainer: qwen2-0.5b bf16 (remat per block), the
    synthetic pipeline at S 4096 and batch 4 (seed 0) in one microbatch,
    constant lr 1e-3, f32 moments, weights from seed 0."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import constant
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = train_config()
    return Trainer(
        get_model(cfg),
        AdamWConfig(lr=constant(TRAIN_LR), moment_dtype="float32"),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                   global_batch=MESH_B, seed=0),
        TrainerConfig(steps=MESH_STEPS, log_every=1, microbatches=1, seed=0,
                      device="cuda"))


def mesh_mamba_trainer():
    """falcon-mamba-7b at its published widths (bf16, remat per layer)
    at the train-families phase's step shape (``FAM_MAMBA_STEPS``: 4
    layers, S 512, batch 4), MESH_STEPS steps, weights from seed 1."""
    import dataclasses

    from repro_torch import configs
    ls, S, B, _ = FAM_MAMBA_STEPS
    cfg = dataclasses.replace(configs.get(FAM_MAMBA), remat="block",
                              n_layers=ls)
    return fam_trainer(cfg, S, B, 1, MESH_STEPS, seed=1)


def mesh_held(tag, runs, kernel, want):
    """Hard checks of one arch's two runs: ``want`` launches of
    ``kernel`` every step of both, finite losses and grad norms within
    TRAIN_RESUME_TOL of the unsharded ones.  Returns (step ms of each
    run, bitwise equal or not)."""
    (h0, n0), (h1, n1) = runs["unsharded"], runs["sharded"]
    if n1 != [want] * MESH_STEPS or n0 != [want] * MESH_STEPS:
        raise AssertionError(f"mesh: {tag}: {kernel.symbol} launches a step "
                             f"{n1} sharded, {n0} unsharded, not {want} "
                             f"(layers x forward and recompute)")
    bitwise = True
    for a, b in zip(h1, h0):
        for k in ("loss", "grad_norm"):
            if not math.isfinite(a[k]) or abs(a[k] - b[k]) > \
                    TRAIN_RESUME_TOL * (1 + abs(b[k])):
                raise AssertionError(f"mesh: {tag}: step {a['step']} {k} "
                                     f"{a[k]} sharded, {b[k]} unsharded")
            bitwise &= a[k] == b[k]
    ms = {k: [h["time_s"] * 1e3 for h in hist]
          for k, (hist, _) in runs.items()}
    log(f"[mesh] {tag}: losses sharded {[h['loss'] for h in h1]}, "
        f"unsharded {[h['loss'] for h in h0]}; grad norms "
        f"{[h['grad_norm'] for h in h1]}, "
        f"{[h['grad_norm'] for h in h0]}; bitwise equal: {bitwise}")
    return ms, bitwise


MESH_WHISPER_LAYERS = 4          # of whisper-large-v3's 32 + 32


def mesh_whisper_decode(torch, mesh):
    """whisper-large-v3 at full width, 4 + 4 layers (bf16, weights from
    seed 2), on the plain route: 4 requests of AUDIO_FRAMES frames and 4
    prompt tokens prefilled unsharded into a cache of AUDIO_FRAMES rows,
    then one decode step unsharded and one on ``mesh`` under the dry
    run's decode rules (the cache placed by ``reshard``: the self and the
    cross cache over ``cache_seq``), the cross-attention inside
    ``mesh_cross_attention`` once a layer.  Hard: the sharded logits
    within LOGIT_ULPS bf16 ulps of the unsharded ones (the island
    normalizes each head's softmax after the value product, the plain
    route before it) and the same greedy tokens.  Returns its readings."""
    import copy
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models import transformer
    from repro_torch.models.model import get_model
    from repro_torch.train.elastic import reshard
    cfg = dataclasses.replace(configs.get(AUDIO_ARCH),
                              n_layers=MESH_WHISPER_LAYERS,
                              encoder_layers=MESH_WHISPER_LAYERS,
                              attn_chunk_q=WHISPER_CHUNK,
                              attn_chunk_kv=WHISPER_CHUNK)
    m = get_model(cfg, plain_attention=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    params = m.init(gen, "cuda")
    batch = audio_inputs(torch, gen, cfg, MESH_B)
    last, parts = m.prefill(params, batch)
    cache = m.init_cache(MESH_B, AUDIO_FRAMES, "cuda")
    for k, src in parts.items():
        cache[k][:, :, :src.shape[2]] = src
    del parts
    cache["pos"] = torch.tensor(batch["tokens"].shape[1], dtype=torch.int32,
                                device="cuda")
    first = last.argmax(-1).to(torch.int32)[:, None]
    want, _ = m.decode_step(params, first, copy.deepcopy(cache))
    shape = ShapeConfig("decode", AUDIO_FRAMES, MESH_B, "decode")
    rules = rules_for(m, configs.SHAPES["decode_32k"], multi_pod=False)
    specs = m.batch_pspecs(shape, rules)
    island, calls = transformer.mesh_cross_attention, []

    def counted(*a):
        calls.append(1)
        return island(*a)

    transformer.mesh_cross_attention = counted
    try:
        with use_mesh(mesh, rules):
            c = reshard(cache, specs["cache"], mesh)
            placed = str(c["cross_k"].placements)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _ = m.decode_step(reshard(params, m.param_pspecs(rules),
                                           mesh),
                                   reshard(first, specs["tokens"], mesh), c)
            got = got.full_tensor()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
    finally:
        transformer.mesh_cross_attention = island
    if len(calls) != cfg.n_layers:
        raise AssertionError(f"mesh: whisper decode: the cross-attention "
                             f"island ran {len(calls)} times, not once a "
                             f"layer ({cfg.n_layers})")
    err, lim = ulp_check("mesh", f"{AUDIO_ARCH} decode step ({cfg.n_layers} "
                         f"layers) sharded vs unsharded", got, want)
    same = torch.equal(got.argmax(-1), want.argmax(-1))
    bitwise = torch.equal(got, want)
    if not (same and torch.isfinite(got).all()):
        raise AssertionError("mesh: whisper decode: the sharded step's "
                             "greedy tokens differ or its logits are not "
                             "finite")
    log(f"[mesh] {AUDIO_ARCH} at full width, {cfg.n_layers} + "
        f"{cfg.encoder_layers} layers, B {MESH_B}, a {AUDIO_FRAMES}-row "
        f"cross cache placed {placed} under {rules}: one decode step, the "
        f"cross-attention island {len(calls)} times, greedy tokens equal, "
        f"logits bitwise equal: {bitwise} (max|diff| {err:.4e}, bound "
        f"{lim:.4e}); sharded step {step_s * 1e3:.1f} ms with DTensor's "
        f"first-call dispatch")
    return dict(islands=len(calls), max_abs_err=err, bitwise=bitwise,
                step_ms=step_s * 1e3)


def mesh_phase(torch):
    """See the module docstring's ``mesh``."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.kernels.ssm_scan import scan
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.elastic import gather, reshard
    t_phase = time.perf_counter()
    cases = ((TRAIN_ARCH, mesh_trainer, flash.KERNEL,
              2 * train_config().n_layers),
             (FAM_MAMBA, mesh_mamba_trainer, scan.KERNEL,
              2 * FAM_MAMBA_STEPS[0]))
    runs = {arch: {} for arch, *_ in cases}
    for arch, make, kernel, _ in cases:
        tr = make()
        per_step = counted_steps(tr, kernel)
        tr.run()
        runs[arch]["unsharded"] = (tr.history, per_step)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1)
        for arch, make, kernel, _ in cases:
            tr = make()
            rules = rules_for(tr.model, SHAPES["train_4k"], multi_pod=False)
            with use_mesh(mesh, rules):
                state = tr.init_state()
                placed = reshard(state, tr.state_pspecs(rules), mesh)
                leaves = tree_leaves(placed)
                n_leaves = len(leaves)
                sharded = sum(any(p.is_shard() for p in x.placements)
                              for x in leaves)
                same = all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(state), tree_leaves(gather(placed))))
                del state, placed, leaves
                if not same:
                    raise AssertionError(
                        f"mesh: {arch}: full_tensor() of the placed state "
                        f"differs from the unplaced state")
                per_step = counted_steps(tr, kernel)
                tr.run()
                runs[arch]["sharded"] = (tr.history, per_step)
            log(f"[mesh] {arch} on {mesh} under {rules}: {n_leaves} "
                f"state leaves, {sharded} sharded on a size-1 axis; "
                f"full_tensor() of the "
                f"placed state equal to the unplaced state byte for byte")
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        whisper = mesh_whisper_decode(torch, mesh)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out = {}
    for arch, _, kernel, want in cases:
        ms, bitwise = mesh_held(arch, runs[arch], kernel, want)
        out[arch] = dict(launches_per_step=want, step_ms=ms, bitwise=bitwise)
    q, m = out[TRAIN_ARCH], out[FAM_MAMBA]
    ls, S, B, _ = FAM_MAMBA_STEPS
    log(f"[mesh] step ms (the first step with warm-up): {TRAIN_ARCH} (S "
        f"{TRAIN_S}, batch {MESH_B}) sharded "
        f"{[round(x, 1) for x in q['step_ms']['sharded']]}, unsharded "
        f"{[round(x, 1) for x in q['step_ms']['unsharded']]}, flash "
        f"{q['launches_per_step']} launches a step; {FAM_MAMBA} ({ls} layers, "
        f"S {S}, batch {B}) sharded "
        f"{[round(x, 1) for x in m['step_ms']['sharded']]}, unsharded "
        f"{[round(x, 1) for x in m['step_ms']['unsharded']]}, the selective "
        f"scan {m['launches_per_step']} launches a step (inside its island "
        f"when sharded); phase {time.perf_counter() - t_phase:.1f} s; on "
        f"{gpu_line()}")
    return dict(q, mamba=m, whisper=whisper)


# ---------------------------------------------------------------------------
# train-families: whisper, Mamba1, the hybrid and the reduced archs trained
# ---------------------------------------------------------------------------

FAM_WHISPER = "whisper-large-v3"
FAM_S, FAM_B, FAM_MICRO, FAM_STEPS = AUDIO_FRAMES, 8, 2, 5
FAM_GRAD_S = 512                  # whisper's grads at 2 + 2 layers
# whisper's schedule: the launchers' own for a run of FAM_STEPS steps,
# cosine_with_warmup(3e-4, 100, steps) (lr 0, 3e-6, ..., 1.2e-5).  A
# constant lr without warmup overshoots at S 1500, in the JAX package as
# in the port: the first Adam step moves every element by lr, and the
# loss jumps (1e-3 and 1.75e-4, whisper large's published peak: 11.10 ->
# 14.19 and 13.10 at step 1 on the H100; PERF.md)
FAM_WHISPER_LR = (3e-4, 100)
FAM_MAMBA = "falcon-mamba-7b"
FAM_MAMBA_GRAD = (2, 256, 2)      # layers, S, B
FAM_MAMBA_STEPS = (4, 512, 4, 3)  # layers, S, batch, steps
FAM_HYBRID = "zamba2-7b"
FAM_HYBRID_GRAD = (6, 512, 2)     # one application of the shared block
FAM_HYBRID_STEPS = (12, 1024, 4, 3)   # two applications
FAM_PARITY = ("llama4-scout-17b-a16e", "grok-1-314b", "qwen2-vl-72b",
              "whisper-large-v3", "falcon-mamba-7b", "zamba2-7b")


def fam_trainer(cfg, S, B, micro, steps, seed=0, warmup=None):
    """The port's Trainer for one run of the phase: bf16 weights from
    ``seed``, the synthetic pipeline at S and B (frames or embeddings as
    the launcher asks), a constant lr of TRAIN_LR or, with ``warmup`` =
    (peak, warmup steps), ``cosine_with_warmup`` over the run, f32
    moments, ``micro`` microbatches, no checkpoint."""
    from repro_torch.models.model import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import constant, cosine_with_warmup
    from repro_torch.train.trainer import Trainer, TrainerConfig
    lr = constant(TRAIN_LR) if warmup is None else cosine_with_warmup(
        *warmup, steps)
    return Trainer(
        get_model(cfg),
        AdamWConfig(lr=lr, moment_dtype="float32"),
        data_config(cfg, S, B),
        TrainerConfig(steps=steps, log_every=1, microbatches=micro,
                      seed=seed, device="cuda"))


def fam_run(torch, tag, trainer, kernel, want):
    """Runs ``trainer`` with ``kernel``'s launches counted a step.  Hard:
    finite losses and grad norms, ``want`` launches every step.  Returns
    (history, run s, peak GiB, params, opt state)."""
    per_step = counted_steps(trainer, kernel)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = trainer.run()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = trainer.history
    for h in hist:
        log(f"[{tag}] step {h['step']}: loss {h['loss']:.6f} grad_norm "
            f"{h['grad_norm']:.6f} {h['time_s'] * 1e3:.1f} ms")
    vals = [h["loss"] for h in hist] + [h["grad_norm"] for h in hist]
    if not all(map(math.isfinite, vals)):
        raise AssertionError(f"{tag}: a loss or grad norm is not finite "
                             f"({vals})")
    if per_step != [want] * len(hist):
        raise AssertionError(f"{tag}: {kernel.symbol} launches a step "
                             f"{per_step}, not {want}")
    return hist, run_s, peak, out["params"], out["opt"]


def median_step_ms(hist):
    import statistics
    return statistics.median(h["time_s"] for h in hist[1:]) * 1e3


def held_loss(torch, trainer, params, micro):
    """The loss of the trainer's first batch (step 0's, in ``micro``
    microbatches, as the step takes it) under its initial weights (drawn
    again from its seed) and under ``params``, by one evaluation without
    grad: a control for the loss check that holds the batch fixed, since
    each step reads a new batch.  A run that does not change its weights
    (lr 0) gives two equal losses.  Returns (initial, trained)."""
    from repro_torch.train.train_step import split_batch
    from repro_torch.train.trainer import batch_to_device
    batch = batch_to_device(trainer.pipeline.batch_at(0), trainer.model.cfg,
                            "cuda")
    init = trainer.model.init(torch.Generator(device="cuda").manual_seed(
        trainer.cfg.seed), "cuda")
    with torch.no_grad():
        out = tuple(sum(trainer.model.loss(p, mb).item()
                        for mb in split_batch(batch, micro)) / micro
                    for p in (init, params))
    del init, batch
    torch.cuda.empty_cache()
    return out


def fam_whisper(torch):
    """(a) whisper-large-v3 at full width and depth through the Trainer:
    S 1500 frames and tokens, batch 8 in 2 microbatches, 5 steps; flash
    384 launches a step; the last loss below the first, and the first
    batch's loss after the steps below its loss under the initial
    weights (``held_loss``).  Readings: the
    median step, decoder tokens/s, ``model_flops`` (6 N D, D the decoder
    tokens) over the step and its share of the bf16 peak, a profiled
    step's device split, peak memory; then the kernel with L at the
    encoder's shape, the routes' grads at 2 + 2 layers, and
    ``launch.train --arch whisper-large-v3 --steps 1 --batch 4``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import get_model
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import batch_to_device
    parts = {}
    cfg = dataclasses.replace(configs.get(FAM_WHISPER), remat="block",
                              attn_chunk_q=WHISPER_CHUNK,
                              attn_chunk_kv=WHISPER_CHUNK)
    E, L = cfg.encoder_layers, cfg.n_layers
    n = cfg.n_params()
    log(f"[train-families] {FAM_WHISPER}: {E} + {L} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} tied, "
        f"{n:.4g} parameters, bf16, remat per block, attn chunks "
        f"{WHISPER_CHUNK} (the audio phase's one change); S {FAM_S} frames "
        f"and tokens, batch {FAM_B} in {FAM_MICRO} microbatches; states "
        f"{n * 16 / 1e9:.2f} GB (bf16 params and grads, f32 accumulator "
        f"and moments); lr cosine_with_warmup{FAM_WHISPER_LR + (FAM_STEPS,)}"
        f" (the launchers' schedule); on {gpu_line()}")
    t0 = time.perf_counter()
    tr = fam_trainer(cfg, FAM_S, FAM_B, FAM_MICRO, FAM_STEPS,
                     warmup=FAM_WHISPER_LR)
    want = 2 * (E + 2 * L) * FAM_MICRO
    hist, run_s, peak, params, opt = fam_run(
        torch, "train-families whisper", tr, flash.KERNEL, want)
    parts["steps"] = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train-families whisper: the last loss "
                             f"{losses[-1]} is not below the first "
                             f"{losses[0]}")
    t0 = time.perf_counter()
    held = held_loss(torch, tr, params, FAM_MICRO)
    parts["held batch"] = time.perf_counter() - t0
    log(f"[train-families] whisper's first batch, one evaluation: loss "
        f"{held[0]:.6f} under the initial weights, {held[1]:.6f} after "
        f"{FAM_STEPS} steps ({held[1] - held[0]:+.6f})")
    if not held[1] < held[0]:
        raise AssertionError(f"train-families whisper: the first batch's "
                             f"loss {held[1]} after the steps is not below "
                             f"its {held[0]} under the initial weights")
    step_ms = median_step_ms(hist)
    tok_s = FAM_B * FAM_S / (step_ms / 1e3)
    flops = get_model(cfg).model_flops(ShapeConfig("train", FAM_S, FAM_B,
                                                   "train"))
    tflops = flops / (step_ms / 1e3) / 1e12
    t0 = time.perf_counter()
    step = make_train_step(get_model(cfg), tr.optimizer,
                           microbatches=FAM_MICRO)
    batch = batch_to_device(tr.pipeline.batch_at(FAM_STEPS), cfg, "cuda")
    dev_total, split, _ = train_split(torch, step, params, opt, batch)
    parts["profiled step"] = time.perf_counter() - t0
    del params, opt, batch, tr, step
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train-families] whisper {FAM_STEPS} steps in {run_s:.1f} s; "
        f"median step after the first {step_ms:.1f} ms, {tok_s:.1f} decoder "
        f"tokens/s; model_flops {flops:.4g} a step (6 N D, D the decoder's "
        f"{FAM_B * FAM_S} tokens: the encoder's {FAM_B * FAM_S} frames are "
        f"not counted, as in the JAX package), {tflops:.2f} TFLOP/s, "
        f"{100 * tflops / (BF16_FLOPS_PER_S / 1e12):.2f}% of the 989 TFLOP/s "
        f"bf16 peak; peak memory {peak:.2f} GiB (max_memory_allocated); "
        f"flash {want} launches a step; on {gpu_line()}")
    log(f"[train-families] whisper one step's device time (torch.profiler) "
        f"{dev_total:.1f} ms of {step_ms:.1f} ms: " + ", ".join(
            f"{k} {v:.1f} ms ({100 * v / dev_total:.1f}%)"
            for k, v in split.items()))
    t0 = time.perf_counter()
    lse = lse_timing(torch, f"{FAM_WHISPER} encoder, train", 4, FAM_S,
                     cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, False,
                     WHISPER_CHUNK, 93)
    parts["flash timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grad_err = route_grads(
        torch, "train-families", dataclasses.replace(
            configs.get(FAM_WHISPER), encoder_layers=2, n_layers=2),
        FAM_GRAD_S, 2, flash.KERNEL, 2 * (2 + 2 * 2))
    parts["route grads"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = launch_train.main(["--arch", FAM_WHISPER, "--steps", "1",
                            "--batch", "4"])
    parts["launcher"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"launch.train --arch {FAM_WHISPER} exited {rc}")
    log(f"[train-families] launch.train --arch {FAM_WHISPER} --steps 1 "
        f"--batch 4 (train_4k: 4096 frames and tokens): "
        f"{parts['launcher']:.1f} s in process (weights, 1 step)")
    return dict(losses=losses, held=held, step_ms=step_ms, tok_s=tok_s,
                tflops=tflops, peak_share=tflops * 1e12 / BF16_FLOPS_PER_S,
                split=split, dev_ms=dev_total, peak_gib=peak,
                launches_per_step=want,
                lse_timing={k: lse[k] for k in (
                    "shape", "ms", "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "bound_by")},
                grad_err=grad_err, parts=parts)


def fam_mamba(torch):
    """(b) falcon-mamba-7b at its published widths: the routes' grads at
    2 layers (S 256, B 2; the scan twice a layer), then 3 steps at 4
    layers (S 512, batch 4): finite losses, the scan twice a layer a
    step, the step ms, and one profiled step (``train_split``): its
    device split and the plain scan backward's host ms."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.ssm_scan import scan
    from repro_torch.models.model import get_model
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import batch_to_device
    base = dataclasses.replace(configs.get(FAM_MAMBA), remat="block")
    lg, sg, bg = FAM_MAMBA_GRAD
    t0 = time.perf_counter()
    grad_err = route_grads(torch, "train-families",
                           dataclasses.replace(base, n_layers=lg), sg, bg,
                           scan.KERNEL, 2 * lg)
    grads_s = time.perf_counter() - t0
    ls, S, B, steps = FAM_MAMBA_STEPS
    cfg = dataclasses.replace(base, n_layers=ls)
    tr = fam_trainer(cfg, S, B, 1, steps, seed=1)
    hist, run_s, peak, params, opt = fam_run(
        torch, "train-families falcon-mamba", tr, scan.KERNEL, 2 * ls)
    step_ms = median_step_ms(hist)
    step = make_train_step(get_model(cfg), tr.optimizer)
    batch = batch_to_device(tr.pipeline.batch_at(steps), cfg, "cuda")
    dev_ms, split, host = train_split(torch, step, params, opt, batch)
    del params, opt, batch, tr, step
    gc.collect()
    torch.cuda.empty_cache()
    bwd = "plain scan backward"
    log(f"[train-families] {FAM_MAMBA} at published widths, {ls} of 64 "
        f"layers, bf16, S {S}, batch {B}: {steps} steps in {run_s:.1f} s, "
        f"median step after the first {step_ms:.1f} ms "
        f"({B * S / (step_ms / 1e3):.1f} tokens/s), peak {peak:.2f} GiB; "
        f"the scan {2 * ls} launches a step; a profiled step "
        f"{host['step']:.1f} ms of host time, its plain scan backwards "
        f"{host[bwd]:.1f} ms of it ({100 * host[bwd] / host['step']:.1f}%), "
        f"{dev_ms:.1f} ms of device time: " + ", ".join(
            f"{k} {v:.1f} ms ({100 * v / dev_ms:.1f}%)"
            for k, v in split.items())
        + f"; grads checked in {grads_s:.1f} s; on {gpu_line()}")
    return dict(step_ms=step_ms, peak_gib=peak, launches_per_step=2 * ls,
                host=host, dev_ms=dev_ms, split=split, grad_err=grad_err)


def fam_hybrid(torch):
    """(c) zamba2-7b at its published widths: the routes' grads at 6
    layers (S 512, B 2; one application, flash twice), then 3 steps at
    12 layers (S 1024, batch 4): finite losses, flash 4 launches a step,
    the step ms, one step's device split (``train_split``) with the SSD
    scans' share of it."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.models.model import get_model
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import batch_to_device
    base = dataclasses.replace(configs.get(FAM_HYBRID), remat="block")
    lg, sg, bg = FAM_HYBRID_GRAD
    t0 = time.perf_counter()
    grad_err = route_grads(torch, "train-families",
                           dataclasses.replace(base, n_layers=lg), sg, bg,
                           flash.KERNEL, 2 * (lg // base.attn_every))
    grads_s = time.perf_counter() - t0
    ls, S, B, steps = FAM_HYBRID_STEPS
    cfg = dataclasses.replace(base, n_layers=ls)
    G = ls // cfg.attn_every
    tr = fam_trainer(cfg, S, B, 1, steps, seed=2)
    hist, run_s, peak, params, opt = fam_run(
        torch, "train-families zamba2", tr, flash.KERNEL, 2 * G)
    step_ms = median_step_ms(hist)
    step = make_train_step(get_model(cfg), tr.optimizer)
    batch = batch_to_device(tr.pipeline.batch_at(steps), cfg, "cuda")
    dev_ms, split, _ = train_split(torch, step, params, opt, batch)
    del params, opt, batch, tr, step
    gc.collect()
    torch.cuda.empty_cache()
    ssd_ms = split.get("SSD scans", 0.0)
    log(f"[train-families] {FAM_HYBRID} at published widths, {ls} of 81 "
        f"layers ({G} applications), bf16, S {S}, batch {B}: {steps} steps "
        f"in {run_s:.1f} s, median step after the first {step_ms:.1f} ms "
        f"({B * S / (step_ms / 1e3):.1f} tokens/s), one step's device time "
        f"{dev_ms:.1f} ms (torch.profiler), peak {peak:.2f} GiB; flash "
        f"{2 * G} launches a step; the SSD scans {ssd_ms:.1f} ms of it "
        f"({100 * ssd_ms / dev_ms:.1f}%: their forwards, remat recomputes "
        f"and backwards); grads checked in {grads_s:.1f} s; on "
        f"{gpu_line()}")
    log(f"[train-families] zamba2 one step's device split: " + ", ".join(
        f"{k} {v:.1f} ms ({100 * v / dev_ms:.1f}%)"
        for k, v in split.items()))
    return dict(step_ms=step_ms, dev_ms=dev_ms, ssd_ms=ssd_ms, split=split,
                peak_gib=peak, launches_per_step=2 * G, grad_err=grad_err)


def train_families_phase(torch):
    """See the module docstring's ``train-families``."""
    t_phase = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    whisper = fam_whisper(torch)
    parts["whisper"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mamba = fam_mamba(torch)
    parts["falcon-mamba"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hybrid = fam_hybrid(torch)
    parts["zamba2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parity = {arch: train_reduced_parity(torch, arch, "train-families parity")
              for arch in FAM_PARITY}
    parts["reduced parity"] = time.perf_counter() - t0
    log(f"[train-families] phase {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + "; whisper's: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in whisper["parts"].items()))
    return dict(whisper=whisper, mamba=mamba, hybrid=hybrid, parity=parity)


# ---------------------------------------------------------------------------
# 5./6. BabelStream and the instruction roofline
# ---------------------------------------------------------------------------

BABEL = (16384, 2048)            # 2^25 elements: BabelStream's default size
# the JAX tests' shapes; n % 8 = 0 with ragged last blocks of copy, mul,
# add and triad (4096 f32 / 8192 bf16 elements a block); n % 8 = 3 and 1;
# BabelStream's
STREAM_SHAPES = [(8, 128), (256, 512), (1024, 128), (64, 1024), (3, 1000),
                 (33, 1000), (3, 1001), (9, 1001), BABEL]
# copy, mul, add and triad: the 16-byte vector kernels (map_vec), whose
# SASS must hold no branch
VECTOR_KERNELS = tuple(f"stream_{op}_{sfx}" for op in ("copy", "mul", "add",
                                                       "triad")
                       for sfx in ("f32", "bf16"))
STREAM_DOT_TOL = (2.0 ** -20, "of sum |a b|: the f32 products are exact "
                              "or rounded alike, and only the order of the "
                              "f32 sums differs, each within log2(n) f32 "
                              "epsilons (25 * 2^-24 < 2^-19 at 2^25); a lost "
                              "warp of products, ~2^-20 of the sum at 2^25, "
                              "fails it")
STREAM_SOURCE = "src/repro_torch/csrc/stream.cu"
STREAM_REPLACES = {"copy": 83, "mul": 97, "add": 111, "triad": 125,
                   "dot": 139}     # src/repro/kernels/stream/stream.py


def stream_checks(torch):
    """Each stream kernel against its plain version on the card, in f32
    and bf16 at every listed shape; returns {name: max |kernel - plain|}."""
    from repro_torch.kernels.stream import ref, stream
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    errs = dict.fromkeys(STREAM_REPLACES, 0.0)
    tol, why = STREAM_DOT_TOL
    for shape in STREAM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a, b, c = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            pairs = {"copy": (stream.copy(a), ref.copy(a)),
                     "mul": (stream.mul(c), ref.mul(c)),
                     "add": (stream.add(a, b), ref.add(a, b)),
                     "triad": (stream.triad(b, c), ref.triad(b, c)),
                     "dot": (stream.dot(a, b), ref.dot(a, b))}
            again = stream.dot(a, b)
            torch.cuda.synchronize()
            if not torch.equal(again.view(torch.int32),
                               pairs["dot"][0].view(torch.int32)):
                raise AssertionError(f"stream dot {tuple(shape)} {dtype}: "
                                     f"two runs differ in their bits")
            for name, (got, want) in pairs.items():
                err = (got.float() - want.float()).abs().max().item()
                if name == "dot":
                    scale = (a.float() * b.float()).abs().sum().item()
                    ok = err <= tol * scale
                else:
                    ok = got.dtype == want.dtype and torch.equal(got, want)
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError(
                        f"stream {name} {tuple(shape)} {dtype}: kernel "
                        f"differs from plain by {err:.3e}")
                errs[name] = max(errs[name], err)
            log(f"[stream] {str(tuple(shape)):14s} "
                f"{str(dtype).replace('torch.', ''):8s} copy/mul/add/triad "
                f"bit-identical, dot |kernel-plain| = "
                f"{(pairs['dot'][0] - pairs['dot'][1]).abs().item():.3e}")
    vector_edge_checks(torch, gen)
    log(f"[stream] tolerance: copy, mul, add, triad bit-identical (each "
        f"rounds where the plain version rounds); dot {tol} {why}; dot "
        f"bit-identical from run to run at every shape")
    return errs


def vector_edge_checks(torch, gen):
    """copy and mul in place (``out=`` the input, BabelStream's chain), add
    and triad with ``out=`` each input in turn, at a ragged shape,
    bit-identical to plain; and a view 4 bytes past a 16-byte boundary
    refused with ValueError by all four, as each input and as ``out=``."""
    from repro_torch.kernels.stream import ref, stream
    for dtype in (torch.float32, torch.bfloat16):
        x, w = (torch.randn((9, 1001), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        want = ref.mul(x)
        stream.mul(x, out=x)
        stream.copy(x, out=x)
        torch.cuda.synchronize()
        if not torch.equal(x, want):
            raise AssertionError(f"stream copy/mul in place {dtype}: "
                                 f"differs from plain")
        for name in ("add", "triad"):
            want = getattr(ref, name)(x, w)
            for which in range(2):
                z = [x.clone(), w.clone()]
                getattr(stream, name)(*z, out=z[which])
                torch.cuda.synchronize()
                if not (torch.equal(z[which], want)
                        and torch.equal(z[1 - which], (x, w)[1 - which])):
                    raise AssertionError(f"stream {name} {dtype} with out= "
                                         f"input {which}: differs from "
                                         f"plain")
        base = torch.zeros(1025, dtype=dtype, device="cuda")
        off, ok = base[1:].view(8, 128), base[:1024].view(8, 128)
        for name, call in (("copy", lambda: stream.copy(off)),
                           ("mul", lambda: stream.mul(off)),
                           ("add a", lambda: stream.add(off, ok)),
                           ("add b", lambda: stream.add(ok, off)),
                           ("triad b", lambda: stream.triad(off, ok)),
                           ("triad c", lambda: stream.triad(ok, off)),
                           ("copy out=", lambda: stream.copy(ok, out=off)),
                           ("mul out=", lambda: stream.mul(ok, out=off)),
                           ("add out=", lambda: stream.add(ok, ok, out=off)),
                           ("triad out=",
                            lambda: stream.triad(ok, ok, out=off))):
            try:
                call()
            except ValueError as e:
                if "16-byte aligned" not in str(e):
                    raise
                continue
            raise AssertionError(f"stream {name} {dtype}: a misaligned view "
                                 f"was not refused")
    log("[stream] copy and mul in place, add and triad with out= each "
        "input, (9, 1001) bit-identical in f32 and bf16; misaligned views "
        "refused (ValueError) as every input and out=")


def stream_timing(torch, ceiling_gbs):
    """Kernel, plain and library times at 2^25 f32 elements, with the
    bound against the data sheet; the time at the measured ceiling goes
    to the log only (see the module's docstring)."""
    from repro_torch.kernels.stream import ref, stream
    from repro_torch.launch.babelstream import ARRAYS_MOVED
    a, b, c = (torch.full(BABEL, v, device="cuda") for v in (0.1, 0.2, 0.0))
    fa, fb = a.view(-1), b.view(-1)
    calls = {
        "copy": (lambda i: stream.copy(a, out=c), lambda i: ref.copy(a),
                 lambda i: c.copy_(a)),
        "mul": (lambda i: stream.mul(c, out=b), lambda i: ref.mul(c),
                lambda i: torch.mul(c, 0.4, out=b)),
        "add": (lambda i: stream.add(a, b, out=c), lambda i: ref.add(a, b),
                lambda i: torch.add(a, b, out=c)),
        "triad": (lambda i: stream.triad(b, c, out=a),
                  lambda i: ref.triad(b, c),
                  lambda i: torch.add(b, c, alpha=0.4, out=a)),
        "dot": (lambda i: stream.dot(a, b), lambda i: ref.dot(a, b),
                lambda i: torch.dot(fa, fb))}
    flops = {"copy": 0, "mul": 1, "add": 1, "triad": 2, "dot": 2}
    n = a.numel()
    rows = {}
    for name, (kernel, plain, library) in calls.items():
        nbytes = ARRAYS_MOVED[name] * n * 4 + (4 if name == "dot" else 0)
        bms, by = bound_ms(nbytes, flops[name] * n, F32_FLOPS_PER_S)
        cms, _ = bound_ms(nbytes, flops[name] * n, F32_FLOPS_PER_S,
                          ceiling_gbs * 1e9)
        rows[name] = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                          library_ms=time_ms(library), bound_ms=bms,
                          bound_by=by)
        r = rows[name]
        log(f"[stream] {name:5s} 2^25 f32: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={bms:.4f} (by {by}, {nbytes} bytes over 3.35 TB/s) "
            f"copy_rate_ms={cms:.4f} (over the port copy's "
            f"{ceiling_gbs:.1f} GB/s; not a bound)")
    return rows


def stream_phase(torch, gpu):
    """Checks, then BabelStream as the slice's main path, then times."""
    from repro_torch.kernels.stream import stream
    from repro_torch.launch import babelstream, irm
    errs = stream_checks(torch)
    for k in stream.KERNELS.values():
        k.launches = 0                           # counts of the main path
    res = babelstream.run(*BABEL, torch.float32, num_times=100,
                          device="cuda")
    launches = stream.launch_counts()
    clocks = irm.sm_clocks()
    for line in babelstream.report(res).splitlines():
        log(f"[stream] {line}")
    log(f"[stream] launches on the BabelStream path: {launches}; SM clock "
        f"right after the loop, max: {clocks}")
    if not res.ok:
        raise AssertionError(f"BabelStream solution check failed: "
                             f"{res.errors} against {res.limits}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a stream kernel was not launched on the "
                             f"BabelStream path: {launches}")
    ceiling = res.copy_gbs()
    log(f"[stream] measured memory ceiling (BabelStream copy, 2^25 f32): "
        f"{ceiling:.3f} GB/s = {ceiling / 3352:.3f} of the data sheet's "
        f"3352 GB/s, on {gpu}")
    timing = stream_timing(torch, ceiling)
    return res, errs, launches, timing, clocks


def tensor_core_check(fns):
    """Every bf16 instantiation of the flash and paged-prefill kernels
    issues bf16 m16n8k16 products (``HMMA.16816.F32.BF16``) and cp.async
    copies (``LDGSTS``); prints their counts (and ``LDSM``, the ldmatrix
    loads) per instantiation."""
    for kernel, n in TENSOR_CORE.items():
        names = sorted(name for name in fns if kernel in name)
        if len(names) != n:
            raise AssertionError(f"{kernel}: {len(names)} SASS functions, "
                                 f"expected {n} instantiations")
        for name in names:
            ops = [text.split()[0] if not text.startswith("@") else
                   text.split()[1] for _, text in fns[name]]
            hmma = sum(op.startswith("HMMA.16816.F32.BF16") for op in ops)
            ldgsts = sum(op.startswith("LDGSTS") for op in ops)
            ldsm = sum(op.startswith("LDSM") for op in ops)
            short = re.sub(r"^_Z.*?\d+(?=" + kernel + ")", "", name)
            log(f"[irm] tensor cores {short}: {hmma} HMMA.16816.F32.BF16, "
                f"{ldgsts} LDGSTS, {ldsm} LDSM")
            if hmma == 0 or ldgsts == 0:
                raise AssertionError(f"{name}: no HMMA.16816.F32.BF16 "
                                     f"({hmma}) or LDGSTS ({ldgsts}) in its "
                                     f"SASS")


def irm_points_phase(torch):
    """The loop census of the built library (its SASS and every
    instruction's line), and the looped kernels' points at PERF.md's
    shapes (``launch/irm.py``: device time from ``torch.profiler``),
    measured first, on a card that no large trace has run on yet."""
    from repro_torch.core import sass_counters as sc
    from repro_torch.kernels import build
    from repro_torch.launch import irm
    t0 = time.perf_counter()
    lib = build.build()
    listing = sc.sass_listing(lib)
    counter = irm.LoopCounter(listing, sc.line_info(lib))
    points = irm.app_points(torch, counter, irm.app_cases(torch))
    torch.cuda.empty_cache()
    for p in points:
        log(f"[irm] point {p.kernel}: [{p.lo}, {p.hi}] warp instructions, "
            f"{p.bytes} bytes, {p.seconds * 1e3:.5f} ms of device time")
    log(f"[irm] application points measured and counted in "
        f"{time.perf_counter() - t0:.1f} s")
    return listing, counter, points


def irm_phase(torch, res, clocks, gpu, listing, counter, points):
    """The SASS census, then the roofline as ``launch/irm.py`` builds it:
    the stream kernels' points, the looped kernels' at PERF.md's shapes,
    and the paged kernels over the ``serve`` traffic (``points``)."""
    from repro_torch.core import sass_counters as sc
    from repro_torch.core.hardware import h100_from_device
    from repro_torch.launch import irm
    census = sc.census_text(listing, select="^stream_")
    fns = sc.split_functions(listing)
    looped = [name for name in fns if any(k in name for k in LOOPED)]
    missing = [k for k in LOOPED if not any(k in name for name in looped)]
    if missing:
        raise AssertionError(f"no SASS function found for {missing}")
    tensor_core_check(fns)
    for name, k in sorted(census.items()):
        log(f"[irm] census {name}: {k.warp_insts_per_warp} instructions "
            f"per warp, loop-free, {k.forward_branches} forward branches; "
            + ", ".join(f"{c} {v}" for c, v in k.counts.items() if v))
    if len(census) != 11:
        raise AssertionError(f"census found {sorted(census)}, not the 11 "
                             f"stream kernels")
    branched = {k: census[k].forward_branches for k in VECTOR_KERNELS
                if census[k].forward_branches}
    if branched:
        raise AssertionError(f"forward branches in {branched}: the census "
                             f"of the vector kernels counts on every warp "
                             f"running "
                             f"the whole listing (the ragged tail's guard a "
                             f"predicated store)")
    log(f"[irm] {', '.join(VECTOR_KERNELS)}: no branch, so every warp "
        f"issues the whole listing at 2^25 (all vector guards hold)")
    model, _ = irm.h100_irm(h100_from_device(res.copy_gbs()), census, res)
    for (name, _), c in sorted(counter._cache.items()):
        short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_\d+_", "", name)[:90]
        log(f"[irm] loop census {short}: straight-line part "
            f"[{sum(c.top_lo.values())}, {sum(c.top_hi.values())}] a warp; "
            + "; ".join(f"{lp.header:#x} REPRO_TRIP({lp.source}) at "
                        f"{lp.where} unrolled x{lp.unroll}, "
                        f"[{sum(lp.lo.values())}, {sum(lp.hi.values())}] an "
                        f"iteration" for lp in c.loops))
    for la in irm.variant_launches():    # the other dtypes: census only
        lo, hi = counter.count(la)
        log(f"[irm] loop census {irm.kernel_name(la)} ({la.function}): "
            f"[{lo / la.warps:.1f}, {hi / la.warps:.1f}] warp instructions "
            f"a warp over {la.warps} warps, {la.bytes} bytes")
    log(f"[irm] loop census: {len(counter._cache)} instantiations counted "
        f"(behind the points, then the int8 and f32 variants), every back "
        f"edge tied to a loop marked REPRO_TRIP, no LoopError")
    log(f"[irm] card: {gpu}")
    for line in irm.h100_report(census, res, clocks):
        log(f"[irm] {line}")
    for line in irm.app_report(model, points):
        log(f"[irm] {line}")
    faults = irm.over_peak(model.hw, irm.app_rows(model, points))
    if faults:
        raise AssertionError(f"points above the Eq. 3 peak (a census "
                             f"fault): {faults}")
    log(f"[irm] every point at or below {irm.PEAK_SLACK} x the Eq. 3 peak "
        f"{model.hw.peak_gips():.2f} GIPS; on {gpu}")


PROFILE_CELL = ("qwen2-0.5b", "train_4k")   # the dry run's 16 x 16 cell
# whisper's decode cell on the 16 x 16 mesh, its cross-attention split
# over the cross cache's 32,768 rows: the JAX package's census of the
# same cell (its run_cell, a CPU figure) counts 8.7378e9 tensor-core
# FLOPs a device, and the gather of the whole cross cache on every rank
# counted 1.6791e10 and 40.3 GB of wire a device in the port
CROSS_CELL = ("whisper-large-v3", "decode_32k")
CROSS_MAX_FLOPS, CROSS_MAX_WIRE = 1.0e10, 1e9


def profile_train_step(torch, train, ceiling_gbs):
    """The train phase's step traced on fake CPU tensors and profiled on
    the card's spec with the measured copy rate: (modeled record,
    measured record, census, trace seconds, spec, model FLOPs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ShapeConfig
    from repro_torch.core.hardware import h100_from_device
    from repro_torch.core.step_census import census_of_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, AdamWConfig, tree_map
    from repro_torch.profiler.session import profile_census
    from repro_torch.train.train_step import make_train_step
    t0 = time.perf_counter()
    model = Model(train_config(), plain_attention=True)
    opt = AdamW(AdamWConfig(moment_dtype="float32"))
    with FakeTensorMode():
        def fake(tree):
            return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                            tree)
        params = fake(model.abstract_params())
        state = fake(opt.abstract_state(model.abstract_params()))
        batch = {k: torch.empty((TRAIN_B, TRAIN_S), dtype=torch.int32)
                 for k in ("tokens", "labels")}
    step = make_train_step(model, opt, microbatches=TRAIN_MICRO)
    census = census_of_step(step, params, state, batch)
    trace_s = time.perf_counter() - t0
    hw = h100_from_device(ceiling_gbs)
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    flops = model.model_flops(shape)
    name = f"{TRAIN_ARCH}/train S {TRAIN_S} B {TRAIN_B}/1 device"
    modeled = profile_census(name, census, 1, hw, model_flops=flops)
    measured_s = train["step_ms"] / 1e3
    measured = profile_census(name, census, 1, hw, model_flops=flops,
                              runtime_s=measured_s)
    return modeled, measured, census, trace_s, hw, flops


def unembedding_flops(rec):
    """(the unembedding's tensor-core FLOPs a device in a training cell's
    dry-run record, those of the same four products over the whole
    vocabulary): the fused loss's chunk logits, their recompute in the
    backward, dh and dE, each 2 x rows x chunk x d x V / m FLOPs an op on
    a rank's rows of a microbatch and its 1/m of the vocabulary (m the
    model axis where it divides V).  A product over the whole vocabulary
    (m times the FLOPs an op) counts too."""
    from repro_torch import configs
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.models.losses import chunk_size
    cfg, shape = configs.get(rec["arch"]), configs.SHAPES[rec["shape"]]
    dims, axes = production_mesh_shape(rec["multi_pod"])
    sizes = dict(zip(axes, dims))
    n_data = math.prod(sizes[a] for a in rec["rules"]["batch_axes"])
    m = sizes["model"] if cfg.vocab_size % sizes["model"] == 0 else 1
    rows = shape.global_batch // n_data // rec["plan"]["microbatches"]
    whole_op = 2 * rows * chunk_size(shape.seq_len, 512) * cfg.d_model \
        * cfg.vocab_size
    ops = collections.Counter()
    for key, (n, _) in rec["census"]["top_tc_ops"].items():
        ops[int(key.rsplit(" ", 1)[1])] += n
    unembed = sum(ops[f] * f for f in {whole_op // m, whole_op})
    whole = 4 * 2 * shape.global_batch // n_data * shape.seq_len \
        * cfg.d_model * cfg.vocab_size
    return unembed, whole


def start_dryrun(arch, shape_name):
    """``python -m repro_torch.launch.dryrun`` of one production cell in
    a subprocess, CUDA hidden (its fake 256-rank group never meets the
    mesh phase's NCCL group), its output to files (a full pipe would
    stall it).  Returns (the process, its temporary directory)."""
    import os
    import tempfile
    out_dir = tempfile.TemporaryDirectory(prefix="dryrun-")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    with open(Path(out_dir.name) / "stdout.txt", "w") as fo, \
            open(Path(out_dir.name) / "stderr.txt", "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape_name, "--out-dir", out_dir.name],
            cwd=ROOT, env=env, stdout=fo, stderr=fe)
    return proc, out_dir


def finish_dryrun(proc, out_dir, arch, shape_name, timeout=400):
    """Waits for a ``start_dryrun`` cell, logs its summary line and
    returns its record; raises if it failed."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    d = Path(out_dir.name)
    stdout, stderr = (d / "stdout.txt").read_text(), \
        (d / "stderr.txt").read_text()
    path = d / f"{arch}__{shape_name}__pod16x16.json"
    rec = json.loads(path.read_text()) if path.exists() else {}
    out_dir.cleanup()
    for ln in stdout.splitlines():
        if ln.startswith("[dryrun]"):
            log(f"[profile] {ln}")
    if proc.returncode != 0 or "roofline" not in rec:
        raise AssertionError(f"profile: the dry run of {arch}/{shape_name}"
                             f" exited {proc.returncode}: "
                             f"{rec.get('error')}\n{stderr[-3000:]}")
    return rec


def profile_phase(torch, train, ceiling_gbs, gpu):
    """See the module docstring's ``profile``.  ``train`` is the train
    phase's readings (median step ms, peak memory), ``ceiling_gbs`` the
    stream phase's measured copy rate."""
    t0 = time.perf_counter()
    arch, shape_name = PROFILE_CELL
    # both production cells trace in subprocesses, beside this one's trace
    runs = [start_dryrun(*PROFILE_CELL), start_dryrun(*CROSS_CELL)]
    try:
        modeled, measured, census, trace_s, hw, flops = \
            profile_train_step(torch, train, ceiling_gbs)
        for proc, _ in runs:
            proc.wait(timeout=400)
    finally:
        for proc, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rl, mem = modeled["roofline"], modeled["memory"]
    mfu_measured = flops / (train["step_ms"] / 1e3 * hw.peak_flops_bf16)
    for v in (rl["modeled_time_s"], rl["mfu_vs_peak"], mfu_measured,
              mem["device_total_bytes"]):
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"profile: a non-positive or non-finite "
                                 f"reading {v} in {rl}, {mem}")
    if census.tc_flops != census.flop_counter_flops:
        raise AssertionError(f"profile: tensor-core FLOPs "
                             f"{census.tc_flops} differ from FlopCounterMode"
                             f"'s {census.flop_counter_flops}")
    log(f"[profile] {TRAIN_ARCH} train step (S {TRAIN_S}, batch {TRAIN_B} "
        f"in {TRAIN_MICRO} microbatches), traced on fake tensors in "
        f"{trace_s:.1f} s: modeled {rl['modeled_time_s'] * 1e3:.1f} ms "
        f"({rl['dominant']}-bound: compute {rl['compute_s'] * 1e3:.1f}, "
        f"memory {rl['memory_s'] * 1e3:.1f}, collective "
        f"{rl['collective_s'] * 1e3:.1f} ms; the plain route's work) against "
        f"the train phase's measured median {train['step_ms']:.1f} ms "
        f"(kernel route); MFU {100 * rl['mfu_vs_peak']:.2f}% modeled, "
        f"{100 * mfu_measured:.2f}% measured, of {hw.peak_flops_bf16 / 1e12:.1f}"
        f" TFLOP/s; census {census.tc_flops:.6g} tensor-core FLOPs "
        f"({census.tc_flops_f32:.6g} of them f32 products, priced at "
        f"{hw.peak_flops_fp32 / 1e12:.1f} TFLOP/s; useful ratio "
        f"{rl['useful_flops_ratio']:.4f}), tc_padding_efficiency "
        f"{modeled['irm']['tc_padding_efficiency']:.4f}, "
        f"{census.hbm_bytes / 1e9:.1f} GB of HBM traffic; achieved "
        f"tensor-core GIPS {measured['irm']['achieved_tc_gips']:.2f} at the "
        f"measured time (peak {measured['irm']['peak_tc_gips']:.2f}); device "
        f"bytes {mem['device_total_bytes'] / 2 ** 30:.2f} GiB (census peak) "
        f"against {train['peak_gib']:.2f} GiB max_memory_allocated; HBM roof "
        f"{ceiling_gbs:.1f} GB/s (BabelStream copy); on {gpu}")
    rec = finish_dryrun(*runs[0], arch, shape_name)
    c = rec["census"]
    unembed, whole = unembedding_flops(rec)
    log(f"[profile] {rec['cell']} unembedding: {unembed:.6g} tensor-core "
        f"FLOPs a device against {whole:.6g} for the whole vocabulary "
        f"({unembed / whole:.4f}; at most 1/16), useful ratio "
        f"{rec['roofline']['useful_flops_ratio']:.4f}")
    if not 0 < 16 * unembed <= whole:
        raise AssertionError(f"profile: the unembedding of {rec['cell']} "
                             f"counts {unembed} FLOPs a device, above "
                             f"1/16 of the whole vocabulary's {whole}")
    log(f"[profile] {rec['cell']} record: {rec['n_devices']} devices, "
        f"{c['tc_flops']:.6g} tensor-core FLOPs a device ("
        f"{c['tc_flops_f32']:.6g} f32; FlopCounterMode "
        f"{rec['flop_counter']['flops']:.6g}), {c['hbm_bytes'] / 1e9:.1f} GB "
        f"HBM and {c['collective_wire_bytes'] / 1e9:.3f} GB collective wire a "
        f"device, useful ratio {rec['roofline']['useful_flops_ratio']:.4f}")
    cross = finish_dryrun(*runs[1], *CROSS_CELL)
    cc, crl = cross["census"], cross["roofline"]
    log(f"[profile] {cross['cell']} record: {cc['tc_flops']:.6g} "
        f"tensor-core FLOPs a device (below {CROSS_MAX_FLOPS:.3g}; the JAX "
        f"package's 8.7378e9), {cc['collective_wire_bytes'] / 1e9:.4f} GB "
        f"collective wire a device (below {CROSS_MAX_WIRE / 1e9:g}), "
        f"{crl['dominant']}-bound, modeled {crl['modeled_time_s'] * 1e3:.2f} "
        f"ms, useful ratio {crl['useful_flops_ratio']:.4f}; the phase "
        f"{time.perf_counter() - t0:.1f} s (the cells modeled on an H100 "
        f"SXM's data sheet, not timed)")
    if not (0 < cc["tc_flops"] < CROSS_MAX_FLOPS
            and cc["collective_wire_bytes"] < CROSS_MAX_WIRE):
        raise AssertionError(
            f"profile: {cross['cell']} counts {cc['tc_flops']} tensor-core "
            f"FLOPs and {cc['collective_wire_bytes']} wire bytes a device: "
            f"the decode's cross-attention is not split over the cross "
            f"cache's sequence")
    return dict(modeled_ms=rl["modeled_time_s"] * 1e3,
                dominant=rl["dominant"], measured_ms=train["step_ms"],
                mfu_modeled=rl["mfu_vs_peak"], mfu_measured=mfu_measured,
                cell=rec["roofline"], cross=crl)


class Laps:
    """Seconds between successive marks of the run, by phase name."""

    def __init__(self):
        self.t, self.s = time.perf_counter(), {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = now - self.t
        self.t = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import paged, prefill_paged

    # full f32 matmuls for the plain versions and the f32 parity phase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    log(f"[build] nvcc built {len(build.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({build.BUILD_ROOT / build.source_hash()})")
    log_ptxas(build.BUILD_ROOT / build.source_hash() / "build.log")
    device = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    log(f"[build] card: {gpu}; python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    laps = Laps()
    listing, counter, points = irm_points_phase(torch)
    laps.mark("irm points")
    errs = kernel_phase(torch)
    laps.mark("kernels")
    d_errs = dense_checks(torch)
    laps.mark("dense checks")
    launches, tok_s, sv, cfg, params = serve_phase(torch, paged.KERNEL,
                                                   prefill_paged.KERNEL,
                                                   counter)
    laps.mark("serve")
    by_decode = by_decode_phase(torch, cfg, params, sv, paged.KERNEL,
                                prefill_paged.KERNEL)
    laps.mark("by-decode")
    spec = spec_phase(torch, cfg, params, sv, paged.KERNEL,
                      prefill_paged.KERNEL)
    laps.mark("spec")
    share = share_phase(torch, cfg, params, paged.KERNEL,
                        prefill_paged.KERNEL)
    laps.mark("share")
    recover = recover_phase(torch, cfg, params, share, paged.KERNEL,
                            prefill_paged.KERNEL)
    laps.mark("recover")
    over = overload_phase(torch, cfg, params, paged.KERNEL,
                          prefill_paged.KERNEL)
    laps.mark("overload")
    wb = whole_batch_phase(torch, cfg, params)
    laps.mark("whole-batch")
    del params
    torch.cuda.empty_cache()
    timing = timing_phase(torch, sv["lens"], sv["base"], sv["max_blocks"],
                          sv["n_layers"])
    laps.mark("timing")
    d_timing = dense_timing(torch, wb["S"])
    laps.mark("dense timing")
    parity_phase(torch)
    laps.mark("parity")
    whole_batch_parity(torch)
    laps.mark("whole-batch parity")
    ssm = ssm_phase(torch)
    laps.mark("ssm")
    # the engines' wrapped methods close over their engines (reference
    # cycles): collect them, and the weights they hold, before the moe
    # phase's 54 GB
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phase(torch, paged.KERNEL, prefill_paged.KERNEL)
    laps.mark("moe")
    gc.collect()
    torch.cuda.empty_cache()
    vlm = vlm_phase(torch, paged.KERNEL, prefill_paged.KERNEL)
    laps.mark("vlm")
    gc.collect()
    torch.cuda.empty_cache()
    audio = audio_phase(torch)
    laps.mark("audio")
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = hybrid_phase(torch)
    laps.mark("hybrid")
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase(torch)
    laps.mark("train")
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_phase(torch)
    laps.mark("mesh")
    gc.collect()
    torch.cuda.empty_cache()
    fam = train_families_phase(torch)
    laps.mark("train-families")
    gc.collect()
    torch.cuda.empty_cache()
    res, s_errs, s_launches, s_timing, clocks = stream_phase(torch, gpu)
    laps.mark("stream")
    irm_phase(torch, res, clocks, gpu, listing, counter,
              points + sv["census"])
    laps.mark("irm")
    profile_phase(torch, train, res.copy_gbs(), gpu)
    laps.mark("profile")
    ceiling = res.copy_gbs() * 1e9

    kernels = []
    for kind, mod, src, rep in (
            ("decode", paged, "src/repro_torch/csrc/paged_decode.cu",
             "src/repro/kernels/decode_attention/paged.py:132"),
            ("prefill", prefill_paged, "src/repro_torch/csrc/paged_prefill.cu",
             "src/repro/kernels/decode_attention/prefill_paged.py:145")):
        t = timing[kind]
        cms, _ = bound_ms(t["bytes"], t["flops"], t["flops_per_s"], ceiling)
        log(f"[timing] {kind} copy_rate_ms={cms:.5f} (its bytes over the "
            f"port copy's measured rate; not a bound)")
        kernels.append({
            "name": mod.KERNEL.symbol, "route": "cuda", "source": src,
            "replaces": rep, "launches": launches[kind],
            "max_abs_err": errs[kind], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "moe_launches": moe["launches"][kind],
            "vlm_launches": vlm["launches"][kind]})
    for name, (src, rep) in DENSE_KERNELS.items():
        t = d_timing[name]
        cms, _ = bound_ms(t["bytes"], t["flops"], BF16_FLOPS_PER_S, ceiling)
        log(f"[timing] {name} copy_rate_ms={cms:.5f} (its bytes over the "
            f"port copy's measured rate; not a bound)")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": wb["launches"][name], "max_abs_err": d_errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "moe_launches": moe["wb"]["launches"][name],
            "vlm_launches": vlm["wb_launches"][name],
            "audio_launches": audio["launches"][name],
            "hybrid_launches": hybrid["launches"][name],
            "zamba2": {k: hybrid["timing"][name][k] for k in (
                "shape", "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by")}})
        if name == "flash_attention":
            w = d_timing["flash_whisper"]
            kernels[-1]["whisper_encoder"] = {
                k: w[k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                  "library_ms", "library_device_ms",
                                  "bound_ms", "bound_by")}
            kernels[-1]["train_launches"] = train["launches_per_step"]
            kernels[-1]["mesh_launches"] = mesh["launches_per_step"]
            kernels[-1]["train_lse"] = train["lse_timing"]
            kernels[-1]["train_families_launches"] = {
                "whisper": fam["whisper"]["launches_per_step"],
                "zamba2": fam["hybrid"]["launches_per_step"]}
            kernels[-1]["whisper_train_lse"] = fam["whisper"]["lse_timing"]
    kernels.append({
        "name": "selective_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES, "launches": ssm["launches"],
        "max_abs_err": ssm["err"], **ssm["timing"],
        "train_launches": fam["mamba"]["launches_per_step"],
        "mesh_launches": mesh["mamba"]["launches_per_step"]})
    for name, line in STREAM_REPLACES.items():
        t = s_timing[name]
        kernels.append({
            "name": f"stream_{name}", "route": "cuda",
            "source": STREAM_SOURCE,
            "replaces": f"src/repro/kernels/stream/stream.py:{line}",
            "launches": s_launches[name], "max_abs_err": s_errs[name],
            **t})
    log(f"[summary] host_ms_trace median/p90 per busy tick: "
        + ", ".join(f"{name} {h['med']:.3f}/{h['p90']:.3f} ms "
                    f"({100 * h['share']:.1f}% of step())"
                    for name, h in (("serve", sv["host"]),
                                    ("by-decode", by_decode["host"]),
                                    ("spec slice", spec["slice"]["host"]),
                                    ("spec doctored",
                                     spec["doctored"]["host"]),
                                    ("share", share["host"]),
                                    ("overload", over["split"])))
        + f"; overload tokens/s {over['tok_s']:.1f}, recompute overhead "
        f"{over['overhead']:.3f}, {over['preemptions']} preemptions "
        f"({over['capacity']} for capacity); on {gpu}")
    log(f"[summary] serve tokens/s {tok_s:.1f}; by-decode "
        f"{by_decode['tok_s']:.1f}; spec_k {SPEC_K} with the 4-layer slice "
        f"{spec['slice']['tok_s']:.1f} (accept "
        f"{spec['slice']['accept']:.4f}), with the doctored target "
        f"{spec['doctored']['tok_s']:.1f} (accept "
        f"{spec['doctored']['accept']:.4f}); the same 8 requests, sharing "
        f"off, tokens/s over step(), serve's over its whole drive loop; on "
        f"{gpu}")
    log(f"[summary] serve tokens/s {tok_s:.1f} (sharing off); share tokens/s "
        f"{share['tok_s']:.1f} ({share['shared']} shared tokens, logical/"
        f"physical x{share['ratio']:.3f}, {share['hits']} retained "
        f"adoptions, peak {share['peak']:.2f} GiB); whole-batch tokens/s "
        f"{wb['tok_s']:.1f}; falcon-mamba-7b whole-batch tokens/s "
        f"{ssm['tok_s']:.1f}; memory ceiling "
        f"{res.copy_gbs():.3f} GB/s; on {gpu}")
    log(f"[summary] recover: {recover['bytes']} B a snapshot, save ms "
        f"median {recover['save_med']:.1f} max {recover['save_max']:.1f}, "
        f"restore ms "
        + ", ".join(f"{r['restore_ms']:.1f}" for r in recover['restored'])
        + ", kill to first restored tick s "
        + ", ".join(f"{r['recover_s']:.3f}" for r in recover['restored'])
        + f"; tokens/s with snapshots every {RECOVER_EVERY} ticks "
        f"{recover['tok_s']:.1f} against share's {share['tok_s']:.1f}; "
        f"launches decode {recover['launches']['decode']}, prefill "
        f"{recover['launches']['prefill']}; on {gpu}")
    log(f"[summary] moe ({MOE_ARCH}, {MOE_LAYERS} of 48 layers, bf16): "
        f"{moe['free_gib']:.2f} GiB free at phase start; paged sharing off "
        f"{moe['tok_s']:.1f} tokens/s (host {100 * moe['host']['share']:.1f}"
        f"% of step()), default ServeConfig {moe['share_tok_s']:.1f}, "
        f"whole-batch {moe['wb']['tok_s']:.1f}; weight-read floor "
        f"{moe['floor_ms']:.2f} ms a call; capacity dropped "
        f"{100 * moe['drop_share']:.2f}% of routed assignments ("
        + ", ".join(f"{k} {d}/{a}" for k, (a, d) in moe["drops"].items())
        + f"); kernel vs plain route flips prefill {moe['flips']['prefill']}"
        f", decode {moe['flips']['decode']}; launches decode "
        f"{moe['launches']['decode']}, prefill {moe['launches']['prefill']}"
        f"; on {gpu}")
    log(f"[summary] vlm ({VLM_ARCH}, {VLM_LAYERS} of 80 layers, bf16): "
        f"{vlm['free_gib']:.2f} GiB free at phase start; paged text prompts "
        f"{vlm['tok_s']:.1f} tokens/s (host {100 * vlm['host']['share']:.1f}"
        f"% of step()), whole-batch embeddings decode "
        f"{vlm['wb_tok_s']:.1f}; launches decode {vlm['launches']['decode']}"
        f", prefill {vlm['launches']['prefill']}, whole-batch "
        f"{vlm['wb_launches']}; audio ({AUDIO_ARCH}, 32 + 32 layers, bf16, "
        f"{AUDIO_FRAMES} frames): {audio['tok_s']:.1f} tokens/s, prefill "
        f"{audio['prefill_ms']:.1f} ms, encoder {audio['enc_ms']:.2f} ms a "
        f"call ({audio['enc_dev_ms']:.2f} ms of device time, flash "
        f"{audio['enc_flash_ms']:.2f}); launches {audio['launches']}; on "
        f"{gpu}")
    log(f"[summary] hybrid ({HYBRID_ARCH}, 81 layers, 13 shared-block "
        f"applications, bf16): {hybrid['free_gib']:.2f} GiB free at phase "
        f"start; whole-batch {hybrid['tok_s']:.1f} tokens/s; a prefill "
        f"{hybrid['prefill_ms']:.1f} ms ({hybrid['prefill_dev_ms']:.2f} ms "
        f"device, SSD scans {hybrid['scan_dev_ms']:.2f}); a decode step "
        f"{hybrid['step_ms']:.2f} ms ({hybrid['step_dev_ms']:.3f} ms "
        f"device); launches {hybrid['launches']}; on {gpu}")
    log(f"[summary] train ({TRAIN_ARCH}, 24 layers, bf16, S {TRAIN_S}, "
        f"batch {TRAIN_B} in {TRAIN_MICRO} microbatches): median step "
        f"{train['step_ms']:.1f} ms, {train['tok_s']:.1f} tokens/s, "
        f"{train['tflops']:.2f} TFLOP/s by model_flops "
        f"({100 * train['peak_share']:.2f}% of 989); device split "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in train["split"].items())
        + f"; peak {train['peak_gib']:.2f} GiB; loss {train['losses'][0]:.4f}"
        f" -> {train['losses'][-1]:.4f}; flash {train['launches_per_step']} "
        f"launches a step; on {gpu}")
    mm = mesh["mamba"]
    log(f"[summary] mesh ({TRAIN_ARCH}, 24 layers, bf16, S {TRAIN_S}, batch "
        f"{MESH_B}, a (1, 1) NCCL mesh): step ms sharded "
        f"{mesh['step_ms']['sharded']}, unsharded "
        f"{mesh['step_ms']['unsharded']}; losses bitwise equal: "
        f"{mesh['bitwise']}; flash {mesh['launches_per_step']} launches a "
        f"step.  {FAM_MAMBA} ({FAM_MAMBA_STEPS[0]} layers, S "
        f"{FAM_MAMBA_STEPS[1]}, batch {FAM_MAMBA_STEPS[2]}): step ms sharded "
        f"{mm['step_ms']['sharded']}, unsharded {mm['step_ms']['unsharded']};"
        f" bitwise equal: {mm['bitwise']}; the scan "
        f"{mm['launches_per_step']} launches a step; on {gpu}")
    w, m, h = fam["whisper"], fam["mamba"], fam["hybrid"]
    log(f"[summary] train-families: {FAM_WHISPER} (32 + 32 layers, bf16, S "
        f"{FAM_S}, batch {FAM_B} in {FAM_MICRO} microbatches) median step "
        f"{w['step_ms']:.1f} ms, {w['tok_s']:.1f} decoder tokens/s, "
        f"{w['tflops']:.2f} TFLOP/s by model_flops "
        f"({100 * w['peak_share']:.2f}% of 989; D the decoder tokens); "
        f"device split " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in w["split"].items())
        + f"; peak {w['peak_gib']:.2f} GiB; loss {w['losses'][0]:.4f} -> "
        f"{w['losses'][-1]:.4f}, the first batch {w['held'][0]:.4f} -> "
        f"{w['held'][1]:.4f}; flash {w['launches_per_step']} launches a "
        f"step.  {FAM_MAMBA} ({FAM_MAMBA_STEPS[0]} layers) step "
        f"{m['step_ms']:.1f} ms, the plain scan backward "
        f"{m['host']['plain scan backward']:.1f} ms of a profiled step's "
        f"{m['host']['step']:.1f} ms of host time; {FAM_HYBRID} "
        f"({FAM_HYBRID_STEPS[0]} layers) step {h['step_ms']:.1f} ms, device "
        f"{h['dev_ms']:.1f} ms, SSD scans {h['ssd_ms']:.1f} ms; grads worst "
        f"(f32 max err / max abs, bf16 rel norm err) whisper "
        f"{w['grad_err']}, falcon-mamba {m['grad_err']}, zamba2 "
        f"{h['grad_err']}; reduced f32 parity (loss diff, param diff / max "
        f"abs) " + ", ".join(f"{a} {l:.1e}/{q:.1e}"
                             for a, (l, q) in fam["parity"].items())
        + f"; on {gpu}")
    log("[summary] seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.s.items())
        + f"; {sum(laps.s.values()):.1f} after the build; on {gpu}")
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
