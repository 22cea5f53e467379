#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, each printing its results; any failure raises and the script exits
non-zero without the final line:

1. device — CUDA must be present; prints the card's name and power limit.
2. build — every kernel source under paddle_tpu_torch/csrc/ is compiled by
   nvcc (one process per source, all started together).
3. kernel vs plain — each kernel's wrapper against its plain PyTorch
   version on the card, at the main path's shapes (decode S=1 and prefill
   S=64 over a 1024-token paged cache, GQA, padded tables, an empty slot)
   plus the other supported block sizes / head dims / group sizes, a
   64-column tile over four pages ending mid-page, horizons one short of
   and one past a tile edge, split boundaries inside a page, and
   serve_knobs' verify_step (S=5, G=1, lengths past 512), in f32
   (tolerance 1e-4: another summation order), bf16 (elementwise
   2^-7 (|ref| + sum_j p_j |v_j|): probabilities and outputs rounded to
   bf16 at different places; ``paged_attention.kernel_tolerance``) and
   f16 (2^-10 of the same, plus 2^-24 (1 + sum_j |v_j|)).
4. timing — kernel, plain and library (SDPA on the gathered cache, a
   yardstick only) at the decode and prefill shapes, CUDA events, median of
   25, L2 flushed between launches; the bound from this run's live bytes
   and operations; bf16, and f16 at the decode and prefill shapes.
5. flash kernels vs plain — the forward, dq and dk/dv kernels against
   their plain versions on the same inputs, each output within
   ``flash_attention.kernel_tolerance``, in f32, bf16 and f16 (the AMP
   float16 path): the training shape (B=8, S=1024, H=16, D=64, causal),
   non-causal, D=128, GQA (Hkv=4, repeated as the wrapper repeats it), a
   ragged S=1000, and S=8192 (B=1, H=4), the sequence length the TPU
   served with its chunked backward.
6. flash timing — kernel, plain and library (scaled_dot_product_attention
   forward, and its backward, a yardstick only) at the training shape (in
   bf16 and f16) and at S=8192 (B=1, H=4), CUDA events, median of 25, L2
   flushed; the bounds
   from this run's shapes; then dq + dk/dv against the library's whole
   backward, with the ratio.
7. serving — GPT-350M at full width (24 layers, random seeded weights) in
   bf16 behind ContinuousGenerateBatchingPredictor (8 slots, chunk 64,
   4 decode steps) and InferenceServer: 12 threaded requests of 50-700
   prompt tokens and 16-64 new tokens, greedy and sampled, then 2 over
   HTTP. Checks lengths, ids, pool conservation and that the kernel ran
   exactly num_layers times per model forward. In situ, two prefill chunks
   of the full model hold every layer's kernel call against the plain
   version on the same inputs, and the logits against the plain attention
   path; a planted fault (lengths one short) must fail the per-layer check.
   Before the requests, the graphs phase: decode_step (8 slots x 4 steps
   over 300-900 cached tokens), prefill_chunk (C = 64), verify_step (4
   drafts) and generate(ids [8, 512], 128 new) each capture their CUDA
   graphs on the first call (keys, captures, capture ms, graph-pool
   bytes); a replay must give the same tokens as the body run without
   capture on the same inputs, greedy and sampled, and a captured paged
   forward's logits are held to its body's (max |diff|, 0 expected); each
   step program is timed and profiled in both forms (host wall, device ms,
   busy share, device kernels, host launch calls, and the graph's device
   time by CUDA events). The launch counts below hold through replays: a
   replay adds the launches its capture recorded.
7b. serve_knobs — the same model behind a ContinuousGenerateBatchingPredictor
   with its serving knobs (spec_k 4 with the n-gram drafter, the prefix
   cache, shortest-prompt-first, warmup; 8 slots x 1024, chunk 64, 4
   decode steps, block 32) and InferenceServer: /readyz 503 while the warm
   thread captures prefill_chunk, decode_step and verify_step, then 200;
   four chat sessions of four turns over a shared 512-token system prompt
   of repeated motifs (16 requests, 16-64 new tokens, a quarter sampled);
   the time to the first streamed token of a 600-token prompt, cold and as
   a prefix hit; an SSE request against its buffered twin, a sampled
   request through X-Temperature / X-Top-K / X-Spec, a Prometheus scrape.
   Gated: greedy tokens equal to a plain scheduler's (FIFO, no
   speculation, no prefix cache) on the same prompts up to each request's
   first near-tie, with tokens compared among the prefix-hit requests; each
   session's last history as the pool holds it indexed (shared pages,
   resumed-prefill, decode and verify rows) equal per layer to a cold
   plain-path prefill of the same tokens, and a control with one page
   swapped failing that; SSE = buffered, conservation with blocks shared during
   the run, prefix hits, drafted = accepted + wasted, no capture after the
   warmup, a well-formed scrape with the bound families, and the paged
   kernel's launches.
7c. serve_production — the same model behind a continuous scheduler with
   an AdapterRegistry (four seeded rank-8 adapters over qkv_proj and
   gate_up), a TenantLedger (gold, free, metered), an SLOMonitor, a
   FlightRecorder, a UtilizationLedger and a Tracer, behind
   InferenceServer (8 slots, chunk 64, block 32, warmup). Gated: base
   requests bit-identical to a scheduler without a registry; each
   adapter's greedy tokens, in f32, equal to a registry-free scheduler
   over merged weights W + (alpha / r) A B up to the first f32 near-tie,
   through the LoRA prefill / decode programs, the LoRA verify_step (a
   speculative scheduler) and LoRA generate_paged alike;
   no capture after the warmup under mixed traffic with a load and an
   unload in flight; a gold arrival pausing one of 8 free sequences, all
   tokens unchanged; every tick's FLOPs conserved and the MFU gauge off
   the card's 989e12 bf16 peak; /slo, /debug/ticks, /utilization and
   /debug/profile over HTTP with the 400 / 429 taxonomy; a batcher-thread
   death healed and a torn adapter load refused with the bank intact; a
   two-replica ReplicaFleet with one capture set per replica. Recorded:
   tokens/s with adapters against without and monitors on against off
   (three rounds of 64 requests each, each form's spread beside its
   median), paged launches per forward, what the replicas' captures added
   to the model's one graph pool.
8. dense kernel vs plain — the dense split-KV kernel (decode form up to 16
   query rows per (request, kv head) and in f32, prefill form above) against
   its plain version, within ``decode_attention.kernel_tolerance`` (f32
   1e-4, bf16 the paged bound), in f32 and bf16: the generation shapes
   (B=8, 16 heads of 64, T=640; decode S=1 at lengths 512-639, prefill
   S=512 at 0, and both with the one int length generate() passes), GQA 4
   and 8 at D=128, T=1000 (no multiple of a tile), requests whose live
   prefix ends inside the first tile, the forms' threshold (16, 17 and 24
   rows) at the full cache, and one request over a long cache in each form
   (many splits); in f16 too (the prefill form above 16 rows).
9. dense timing — kernel, plain and library (SDPA over the dense cache
   with the length mask, a yardstick only) at the decode and prefill
   shapes, CUDA events, median of 25, L2 flushed; the bound from this run's
   live bytes and operations, the time over each; and one request
   decoding at length 4000 of T=4096 (split, combined by a second launch);
   f16 at the decode and prefill shapes.
9b. f16_serve — GPT-350M in f16 (seeded weights) through the continuous
   scheduler over ``PagedKVCache(dtype="float16")``: 4 threaded greedy
   requests of 100-600 prompt tokens and 32 new, the paged kernel's f16
   form exactly num_layers times per forward, greedy tokens held to the
   plain route's up to each request's first near-tie; then dense
   ``generate(dtype="float16")`` over [4, 256] + 32 through the dense
   kernel's f16 forms, held to its plain route the same way.
10. generation — GPT-350M at full width (random seeded f32 weights, cast
   to bf16 by generate()). In situ first: the prompt's prefill (512 rows at
   length 0), its second half again (256 rows at length 256) and one
   decode forward hold every layer's dense kernel call to the plain
   version on the same inputs, and a planted fault (the length one short)
   must fail that check at the second prefill and at the decode, each on
   its own. Then the main path: generate(ids [8, 512], max_new_tokens=128),
   greedy and sampled (temperature 0.8, top-k 40), prefill and decode
   tokens/s, exactly num_layers x forwards dense launches (the replays
   of the key's prefill and decode programs); a decode forward profiled
   as its body and as its replay; the whole-batch
   GenerateBatchingPredictor behind InferenceServer (6 threaded requests of 64-500 prompt tokens, 32 new,
   and one over HTTP: lengths, ids, pool conservation, paged launches),
   then generate_paged's captured runner at [4, 256] + 32: replays equal
   to the bodies, greedy and sampled, with their walls, and a replayed
   call profiled: at most 3 host launch calls (fill, graph, read);
   one request through a predictor whose pool signature does not match
   (served by dense generate(), the dense count rising, the pool
   untouched); and generate_speculative(prompt of 256, 64 new, spec_k=4,
   drafter="self") in f32, whose tokens must equal greedy f32 generate()'s
   up to the first near-tie (top two logits within 1e-3), over at least 32
   tokens, with its acceptance, both kernels' launches and tokens/s; then
   the same with an oracle drafter replaying generate()'s tokens, which
   must accept every draft when no near-tie cut the comparison. The
   whole-batch predictor pads its batch to a power of two (padding rows
   write only the scratch page).
11. training — GPT-350M at full width, O2 bf16 (``amp.decorate``), AdamW
   (lr 1e-4, weight decay 0.01, multi_precision) under TrainStep, B=8,
   S=1024, seeded ids and labels rolled by one. In situ first: one forward
   and backward holds every layer's flash forward and dq / dk / dv to the
   plain versions on the same saved inputs; two planted faults (K rolled by
   one position into the forward, lse + 0.5 into the backward kernels) must
   each fail that check; the first loss through the kernels and through the
   plain attention agree within 1%. Then, from one saved state
   (``export_state`` / ``import_state``), 2 warm-up and 8 timed steps on
   the same batch twice: as bodies run without capture (the reference),
   then the main path: the captured TrainStep (the first call runs the
   body and captures one CUDA graph, the other nine replay it). Replayed
   losses and final parameters must be bit-equal to the bodies' (the same
   kernels in the same order on the same inputs), every loss finite, the
   last below the first, exactly 3 flash launches per layer per step
   through the replays; step time as bodies and as replays, tokens/s, the
   share of the bf16 peak, peak memory, capture ms and graph-pool bytes,
   and one step of each form profiled (host wall, device ms, busy share,
   host launch calls) with the graph's device time by CUDA events. Then
   the LR-schedule leg on the same model: Momentum under
   LinearWarmup(CosineAnnealingDecay) with ClipGradByNorm, the scheduler
   stepped after each step, five steps as bodies and then captured (a body
   with its capture, four replays): each replay's loss and parameters
   equal to its body's, the five rates distinct.
11a. script — GPT-350M as a Paddle training script runs it: the train
   phase's recipe (O2 bf16, AdamW, B 8, S 1024) behind ``paddle.Model``,
   fed by ``io.DataLoader`` (96 seeded token windows in a seeded order,
   two worker processes). ``fit`` for 12 steps, checkpointed every 4 (the
   main path: one capture, eleven replays, never the eager route, 24
   launches of each flash kernel a step); ``paddle.save`` / ``load`` of
   the state dicts equal on the card; the same fit in a fresh process
   (``--script-fit``) takes SIGTERM after step 6, flushes and exits with
   101, latest step 6; that checkpoint restored into this process's live
   step replays steps 7-12 with no new capture and the uninterrupted
   run's losses, bit for bit, and so does a fresh process resuming with
   ``resume="auto"``; ``metric.Accuracy`` over ``Model.evaluate`` equal to
   an argmax count (half the labels planted as hits); ``paddle.device``'s
   memory statistics equal to ``torch.cuda``'s; ``jit.save`` with
   ``InputSpec([None, 1024])``, then a fresh process that imports only the
   package serves the export through ``inference.create_predictor`` at
   B 8 and 2: 24 launches of the flash forward a forward, logits within
   2^-6 of the largest |logit| of the eager forward's. The fit runs under
   ``MonitorCallback`` (a bound ``StepMonitor``): the step seconds, data
   waits and checkpoint phases come from its tracer and registry;
   ``paddle_train_checkpoint_seconds`` observes every checkpoint's
   snapshot, serialize and commit, ``paddle_train_checkpoints_total
   {result="committed"}`` equals the checkpoints written, goodput lies in
   (0, 1], and the resumed process's monitor continues the step count
   from the checkpoint. Reported: fit's
   replayed step ms beside the train phase's, its busy share (one
   profiled ``train_batch``), tokens/s, each checkpoint's snapshot and
   write seconds and bytes, the resume's wall, the export's and load's
   seconds and bytes, the predictor's and the program's ms against the
   eager forward's, peak memory.
11f. train_monitor — GPT-350M at full width, O2 bf16, AdamW, B 8,
   S 1024, the captured TrainStep under a bound ``StepMonitor``: (a) 8
   monitored steps from a saved state bit-equal to 8 bare ones, rows 3-5
   launching 24 a step each as bare, no new capture, and host launch
   calls of a replay equal to the bare step's with ``loss_every=0`` (one
   more with the loss read); (b) tokens/s monitored over bare in turns
   (bare, monitored, monitored, bare; 3 rounds of 30 steps, from a saved
   state put back after them), with each form's spread, resolved or not,
   and each round's own ratio (its drift cancelled) with their spread and
   the most the monitor can cost; (c) a batch of another shape counts one
   recompile, ``new_shape``, and after ``aot_prime`` one ``aot_fallback``;
   (d) a NaN planted in a weight for one step (the state restored) gives
   one ``nan_loss`` anomaly, in the counter and as a trace event; (e) the
   live MFU beside the model-FLOP share of the same wall, their ratio,
   and the HBM gauges; (f) GPT-350M's operator-stats table from its seams
   under ``auto_cast(O2)``.
11g. incubate — (g) a 12-layer ``FusedTransformerEncoderLayer`` stack at
   BERT-base widths (768, 12 heads, 3072, post-LN, B 32, S 512, dropout 0,
   f32, relu) against ``nn.TransformerEncoder`` on the same weights and
   against ``fused_multi_head_attention`` + ``fused_feedforward``, within
   layers x 3072 x 2^-24 of the output's scale; (f) its operator stats
   over one eager O2 forward (black list f32, products bf16) and the
   tensor checker (level 0 raises on an inf, level 1 warns); (h) the stack
   in bf16 with dropout 0.1 and gelu, 8 steps as bodies, then captured
   under a ``StepMonitor``: bit-equal; (i) ``MoELayer`` at GPT-350M
   widths (d 1024, 8 experts of 4096, gelu, ``GShardGate`` top-2, T 8192):
   index against dense in f32 over three seeds (the same routing;
   ``l_aux`` equal; the output and every gradient within d x 2^-24 of its
   largest magnitude: the combine weights' gradient sums its d products
   in another order in the two), the index mode's bf16 forward + backward
   timed; (j) ``asp.prune_model`` on GPT-350M's 96 linear
   weights, 3 eager AdamW steps through ``decorate``: 2:4 kept; (k)
   ``LookAhead(k=2)`` and ``ModelAverage`` over 4 eager SGD steps of a
   two-layer stack equal hand loops, ``apply`` / ``restore`` round-trip.
11b. long context — ``bench.py`` ``_long_context_impl`` as the port runs
   it: ``gpt_350m(max_position=S)`` at S=4096, B=2 and S=8192, B=1, O2
   bf16, AdamW, the captured TrainStep, 2 warm-up + 4 timed steps: step
   ms, tokens/s, the share of the bf16 peak, peak memory; losses finite
   and falling, and 3 flash launches per layer per step (S=8192 is the
   length the TPU served with its chunked backward).
11c. train_recipes — GPT-350M at full width and depth, B 8, S 1024, AdamW,
   2 + 6 steps per leg from the same seeded weights: (a) O2 bf16 with
   recompute "block" and (b) "dots", each as bodies first (the first
   step's loss and parameters bit-equal to a no-recompute body's), then
   captured (replays bit-equal to the bodies); (c) O2 bf16 with dropout
   0.1 (attention on the plain route, as in JAX), captured: a replay after
   ``import_state`` draws the same masks, one with the generator moved on
   draws new ones; (d) AMP O1 bf16 over f32 parameters, bodies then
   captured, bit-equal; (d') Paddle's O2 recipe, ``decorate(level="O2")``
   and every step under ``auto_cast(level="O2", dtype="bfloat16")``,
   bodies then captured, bit-equal, the loss f32, and a replay outside
   auto_cast equal to one inside; (e) O2 f16, eager steps under GradScaler
   with one planted inf in a warm-up step (step skipped, scale halved). Each leg's
   model is built through GPTConfig(dropout=, recompute=). Per leg: step
   ms, tokens/s, peak memory against the leg-less 22,648,100,864 bytes,
   busy share and host launch calls of one profiled step, flash launches;
   losses fall.
11d. optimizers — each of the nine optimizers of this slice (Adamax,
   Adagrad, Adadelta, RMSProp, Lamb, ASGD, Rprop, NAdam, RAdam) for 3
   captured steps of a small GPT (f32): replays bit-equal to bodies, and
   close to eager ``Optimizer.step`` on a copy.
11e. rnn_lm — the recurrent layers at a published width: Zaremba,
   Sutskever and Vinyals 2014 (arXiv:1409.2329), the large PTB LSTM
   (``nn.Embedding(10000, 1500)``, ``nn.LSTM(1500, 1500, num_layers=2,
   dropout=0.65)`` with dropout 0.65 on its input and output too,
   ``nn.Linear(1500, 10000)``, 35 steps unrolled, batch 20, weights
   uniform in [-0.04, 0.04], ``SGD(1.0)`` with a global-norm clip of 10,
   f32, seeded weights and token ids), through the captured TrainStep:
   2 + 6 steps as bodies, then the same captured from the same state and
   generator seed: losses and parameters bit-equal, losses falling; one
   more replay's LSTM output (copied by a hook inside the graph) held to
   the layer run eagerly from the same state and masks; step ms, tokens/s,
   host launch calls and device ms by kind of a body and of a replay.
   Then ``dynamic_decode`` with a ``BeamSearchDecoder`` over the trained
   ``LSTMCell``s (beam 4, batch 8, 16 steps), timed, its ids equal to a
   plain beam search's on the same model.
12. FlashMask kernels vs plain — the masked forward, dq and dk/dv kernels
   against their plain versions, within ``flash_attention.kernel_tolerance``
   over the allowed positions, in f32, bf16 and f16: uneven causal documents
   (n = 1, one mask for all heads), causal n = 2 bands per head,
   non-causal n = 4 bands, GQA 16/4 at D = 128 with a mask per head,
   S = 1000; an all-zero causal mask (every output exactly 0) and a mask
   hiding nothing (bit for bit the unmasked causal kernels).
13. FlashMask timing — kernel, plain, bound and library (SDPA with the
   boolean mask, a yardstick only, with the backend it picked) at
   B = 1, S = 8192, H = 16, D = 64, bf16, causal, under the document mask
   of [2048, 1536, 1024, 1024, 768, 512, 512, 384, 256, 128] (14.9% of
   the causal pairs), and the unmasked causal kernels on the same inputs;
   then masked dq + dk/dv against the library's whole backward, with the
   ratio; in bf16 and in f16. At that shape each masked kernel's outputs
   are held to the plain versions (four heads at a time) within
   ``kernel_tolerance``: the max |kernel - plain| the kernels line reports.
14. varlen training — 24 blocks of RMSNorm ->
   ColumnParallelLinear(1024 -> 3072) -> F.flash_attn_varlen_qkvpacked
   (causal) -> RowParallelLinear(1024 -> 1024) -> residual, bf16, AdamW,
   8192 tokens a step packed from those documents in a seeded shuffled
   order, through the captured TrainStep with ``cu_seqlens`` the step's
   batch tensor (one key for every order). In situ first: layers 0, 11
   and 23's masked kernel calls held to the plain versions on their own
   inputs, and every document's end one short planted into the kernels
   must fail each. Then 2 warm-up and 5 timed steps: step ms, tokens/s,
   the first order's loss falling, exactly 24 launches of each masked
   kernel per step (none unmasked), and a profiled replay (busy, host
   launch calls). Then the stack in f16 (``decorate``): the same in-situ
   check and planted fault on its scaled loss, then 3 f16 eager steps
   under GradScaler, the masked kernels' f16 forms.

15. llama_serve — the card released of everything before (``release``;
   ``memory_reserved()`` must be under 1 GiB), LLaMA-2-7B bf16 at full
   size (32 layers, hidden 4096, 32 heads of 128, vocab 32000, random
   seeded weights): the in-situ paged check at layers 0, 15 and 31 over two
   prefill chunks and a decode forward (a length one short must fail it);
   the graphs phase of its step programs; the continuous scheduler behind
   InferenceServer (8 slots of 2048 tokens, 12 threaded requests of
   128-1500 prompt tokens and 64 new, half sampled, then 2 over HTTP;
   launches exactly num_layers per forward); the greedy answers served
   again on the plain route, equal up to each one's first near-tie; and,
   free of near-ties, two greedy answers prefilled again through the
   kernel path held row by row to a cold plain-path prefill, a swapped
   page failing (``served_rows_check``).
16. llama_generate — the same model: the in-situ dense check at layers 0,
   15 and 31 (``dense_insitu`` at [4, 512], T 640), then generate(ids [4,
   512], 128 new) greedy and sampled, exactly num_layers x forwards dense
   launches.
17. llama_train — LLaMA-2-7B at full depth (cut only if the host cannot
   hold TrainStep's 40.5 GB state copy), O2 bf16, AdamW, recompute
   "block", B 1, S 2048: in situ (``train_insitu``), then from a host copy
   of the state 4 steps as bodies and the same 4 through the captured
   TrainStep: losses bit-equal, each parameter's f64 digest equal, losses
   falling, flash launches 2 / 1 / 1 per layer and step; step ms, tokens/s,
   share of the bf16 peak, peak memory (under 90% of the card), a
   profiled replay.
18. gpt3_1p3b — full size (24 layers, hidden 2048, 16 heads of 128,
   learned positions, LayerNorm, GELU, biases): trained as phase 11 (B 4,
   S 2048), then served in bf16 (in situ at layers 0, 11, 23; 6 + 1
   requests of 100-1000 tokens and 32 new; greedy held to the plain
   route), and a request of 2000 + 64 tokens refused by
   ``_decode_validate`` through the scheduler and generate().
19. bert_base — full size, MLM on ``bert_mlm_mask`` batches (B 32, S
   512), O2 bf16 (LayerNorm f32), AdamW, dropout 0.1, captured: no flash
   launch in training (plain attention, as in JAX), losses falling; then
   an eval forward through the non-causal flash forward, in situ at
   layers 0 and 11 (K rolled by one must fail). Phases 3-6 and 8-9 also
   check and time the kernels at these phases' shapes (paged: 8 slots,
   32 kv heads of 128; dense: [4, 512] over T 640; flash: B 1, S 2048, 32
   heads of 128 causal, and B 32, S 512, 12 heads of 64 non-causal).
20. resnet50 — the nn surface's main path: ResNet-50 as ``bench.py``
   ``bench_resnet`` trains it (BASELINE config 1), nothing cut:
   ``vision.models.resnet50(num_classes=1000, data_format="NHWC")``
   (seeded random weights), ``amp.decorate`` O2 bf16 (batch norm f32),
   ``Momentum(0.1, 0.9, multi_precision=True)``, ``CrossEntropyLoss``,
   the captured ``TrainStep`` at B 128 on 224 x 224 seeded bf16 images.
   From one saved state 3 steps as bodies (the reference), then 3 through
   the captured step (a capture and two replays): losses, parameters,
   velocities and batch-norm running statistics bit-equal to the bodies';
   then 8 timed replays: step ms (bodies and replays), images/s, the share
   of the bf16 peak (FLOPs from the conv and linear shapes: 2 per MAC
   forward, x3 for a step), peak memory, one step of each form profiled
   (busy share, host launch calls, device time by kernel kind, the
   layout-copy and cast ops of a body); cuDNN deterministic for the phase.
   Then an eval forward (B 32) in NCHW f32 held to the NHWC f32 forward of
   the same freshly seeded weights, with the batch's own statistics as
   running statistics (logits O(1)).
21. core — the paddle-style surface on the card. The golden tables
   (``tests/test_op_golden*.py``: UNARY ... LINALG and the nn.functional
   ACTIVATIONS, LOSSES, NN_SHAPE, 240 cases, read by
   ``paddle_tpu_torch.testing.load_tables`` with ``P`` bound to the port)
   in f64 (the tables' tolerances) and f32 (GOLDEN_F32_TOL), eager
   against numpy with gradients against central differences, every output
   on the card; each case the tables run under jit captured once in a CUDA
   graph and replayed, bit-equal to eager (but NOT_CAPTURABLE); the
   planted ``exp`` fault must fail. Then GPT-350M's 24 blocks (B 8, S
   1024, bf16, the port model's seeded weights) trained for 3 eager steps
   through the op layer and ``F.flash_attention`` on Tensors (SGD under
   ``no_grad``, then ``clear_grad``): the first loss and every gradient
   held to the model's own backward, the loss falling, 24 launches of
   each flash kernel a step, the model's own eager step timed beside it,
   and one forward under ``auto_cast(level="O2")`` over f32 weights
   (matmuls bf16, the black list f32). Last, the wrapper's host cost per
   op against bare torch. Before the stack: the recurrent layers, the
   layer and functional fill-ins and grid sampling
   (``tests/nn_fillin_cases.py``: 16 cases) on the card against the same
   calls on the CPU in f64 and f32, outputs and gradients, each case
   without a host read captured and replayed bit-equal to eager; and
   ``F.flash_attention`` / ``F.flashmask_attention`` with q and k of
   different lengths or batches on the plain route, reported "plain",
   equal to ``_sdpa_core``, and so head dims 32 and 96 (no kernel takes
   them).
22. distributed — one NCCL rank on the card, started by the port's
   launcher (``python -m paddle_tpu_torch.distributed.launch
   --nproc_per_node 1 --backend nccl``: the worker, ``--distributed-worker``,
   joins from the launcher's environment; the launcher's store must serve
   natively and see the rank's heartbeats, and its exit code is the
   phase's): every collective of ``distributed.collective`` on CUDA
   tensors held to its one-rank answer; GPT-350M (O2 bf16, AdamW, B 8, S
   1024) 4 captured TrainSteps under ``DataParallel`` (its gradient
   all-reduce run at the first run and the capture, none by a replay)
   against the bare TrainStep: losses and parameters bit-equal, 24
   launches of each flash kernel a step; the same model through
   ``auto_parallel`` (``parallelize`` with a ColWise / RowWise plan over
   the attention and MLP linears, every key matched, and ZeRO-2;
   ``to_static`` under ``Strategy.amp`` O2 bf16) for 4 captured steps
   against a bare TrainStep under the same ``auto_cast``: losses and
   parameters bit-equal, 24 launches of each flash kernel a step, its
   step's ms over the bare step's; 4 greedy requests through the continuous scheduler
   under ``serving_mesh(dp=1, tp=1)`` equal to the plain scheduler's (at
   one rank the mesh is a no-op: the plain scheduler serves, no lockstep
   runs); the paged kernel on tp = 2 and 4 kv-head shards of a random
   pool (decode and prefill),
   the flash forward on each Ulysses head shard [B, S, H/tp, D] and
   ``ulysses_attention`` itself, each concatenation held to the plain
   version of the whole call within the kernels' tolerance. Then, in the
   same worker, the pipeline phase: (a) ``gpt_pipeline(gpt3_1p3b(),
   num_stages=4)`` under ``PipelineParallel`` (B 4, S 2048, O2 bf16,
   AdamW, 4 micro-batches; every stage in the one process), three steps
   of 1F1B, Eager1F1B, FThenB, ZB-H1 and VPP 2 from one saved state, held
   to the unpipelined micro-batch accumulation (losses within 2 bf16
   ulps, the whole model's gap within 1e-2 and every leaf's within 0.25)
   with each flash kernel's
   launches a step equal to the streams' prediction, the peak allocated
   bytes against the unpipelined step's and the 1F1B step's ms against the
   captured gpt3_1p3b step's; (b) GPT-350M under the captured TrainStep
   with ``shard_optimizer(opt, ShardingStage1/2/3)`` at one rank (the
   stages' collectives captured), parameters bit-equal to the bare
   TrainStep's; (c) the ZeRO-1 model and AdamW state through
   ``save_state_dict`` / ``load_state_dict`` into a fresh model and
   optimizer, bit-equal, and the next captured step equal (bytes and
   seconds recorded). Then three more legs: (d) ``moe_ep``, ``MoELayer``
   at the incubate phase's GPT-350M widths (8 x 1024 tokens, d 1024, 8
   experts of 4096, bf16, gshard top-2) built with ``moe_group=`` the
   one-rank world group, so NCCL's all-to-all carries its dispatch and
   return: forward, ``l_aux`` and every gradient bit-equal to the same
   layer without a group, both fwd + bwd timed, four all-to-alls a
   call; (e) ``sync_bn``, ResNet-50 (B 32, 224^2, NHWC, O2 bf16,
   Momentum) converted by ``convert_sync_batchnorm`` under
   ``DataParallel``, 2 captured steps bit-equal to the bare BatchNorm
   step, both step times; (f) ``rpc``, round trips to this rank over the
   launcher's native store, the median latency. The CPU tests rehearse
   the phase at two gloo ranks on a tiny GPT (pp 2 over the two ranks;
   ep 2 and dp 2 in the last legs), with a planted fault: the tied
   weight's gradient not summed across its stages.

Last lines: each phase's seconds, the card, the kernels JSON (a kernel
redesigned since it was first ported names the change in "redesigned";
rows 1-5 carry their D = 128 readings), then {"ok": true, "device":
{...}}. With ``--json PATH`` the full record (every check, timing, profile
and serving number) is also written to PATH.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

PROCESS_T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# max |dlogit| / max |logit|, kernel path vs plain path: a coarse bound.
# With random weights the residual stream hides attention errors (a planted
# off-by-one mask moved the logits by 1.7% against 1.05% sound on an NVIDIA
# H100 80GB HBM3 at 700 W), so the per-layer check is the one a fault must
# fail.
INSITU_REL_TOL = 2.5e-2
# first training loss, flash kernels vs plain attention: a coarse bound
LOSS_REL_TOL = 1e-2
# The kernels redesigned since they were first ported, and the change that
# redesigned each (their earlier times: PERF.md section 6).
REDESIGNED = {"paged_decode_attention": "PR 5", "flash_attention_fwd": "PR 5",
              "decode_attention": "PR 7",
              "flashmask_fwd": "PR 5", "flash_attention_dq": "PR 6",
              "flash_attention_dkv": "PR 6", "flashmask_dq": "PR 6",
              "flashmask_dkv": "PR 6"}


def ptxas_summary(log):
    """[(kernel, registers, spill store bytes)] of every entry function in
    the ``nvcc -Xptxas -v`` output ``log``; a template kernel is named with
    its arguments (``flash_dq_wgmma_kernel<64,0>``,
    ``paged_partials_kernel<bf16,64>``)."""
    def names(rest):            # <length><name>... -> (last name, rest)
        name = ""
        while rest[:1].isdigit():
            n = re.match(r"\d+", rest).group()
            end = len(n) + int(n)
            name, rest = rest[len(n):end], rest[end:]
        return name, rest

    out, name, spill = [], None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '_ZN?([^']+)'", line)
        if entry:
            name, rest = names(entry.group(1))
            args = []
            rest = rest[1:] if rest.startswith("I") else "E"
            while rest and rest[0] != "E":
                lit = re.match(r"L[ib](\d+)E", rest)
                if lit:
                    args.append(lit.group(1))
                    rest = rest[lit.end():]
                elif rest[0].isdigit():
                    t, rest = names(rest)
                    args.append({"__nv_bfloat16": "bf16"}.get(t, t))
                elif rest[0] == "f":
                    args.append("float")
                    rest = rest[1:]
                else:
                    break
            name += f"<{','.join(args)}>" if args else ""
            spill = 0
            continue
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores:
            spill = int(stores.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append((name, int(regs.group(1)), spill))
            name = None
    return out


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- phase 3/4
def make_case(torch, B, S, Hkv, G, D, BS, lengths, dtype, device, seed,
              capacity=1024):
    """Random q and pools, per-request page tables (entries past a
    request's extent point at page 0) and lengths."""
    g = torch.Generator(device=device).manual_seed(seed)
    NB = -(-capacity // BS)
    P = B * NB
    td = getattr(torch, dtype)
    q = torch.randn((B, S, Hkv * G, D), generator=g, device=device).to(td)
    kp = torch.randn((Hkv, P, BS, D), generator=g, device=device).to(td)
    vp = torch.randn((Hkv, P, BS, D), generator=g, device=device).to(td)
    perm = torch.randperm(P, generator=g, device=device).cpu().numpy()
    tables = np.zeros((B, NB), np.int32)
    for b, ln in enumerate(lengths):
        n = -(-(ln + S) // BS)
        tables[b, :n] = perm[b * NB:b * NB + n]
    return (q, kp, vp, torch.as_tensor(tables, device=device),
            torch.as_tensor(np.asarray(lengths, np.int32), device=device))


def decode_lengths(rng, B=8):
    ln = rng.integers(1, 1001, B)
    ln[3] = 0                                   # one empty slot
    return ln


def verify_lengths(rng, B=8, S=5):
    """serve_knobs' verify ticks: histories past its 512-token system
    prompt, one idle slot."""
    ln = rng.integers(512, 1024 - S + 1, B)
    ln[3] = 0
    return ln


LLAMA_SLOT = 2048                # llama_serve's tokens per slot


def llama_lengths(rng, B=8, S=1):
    """Per-slot lengths of llama_serve's step programs: histories of its
    128-1500-token prompts and 64 new tokens, one idle slot."""
    ln = rng.integers(128, 1500 + 64 - S + 1, B)
    ln[3] = 0
    return ln


def prefill_offsets(rng, B=8, S=64):
    off = rng.integers(1, 1024 - S, B)
    off[off % 32 == 0] += 1                     # never on a block boundary
    off[5] = 0
    return off


def held_to_plain(torch, pa, args, got, ref, scale=None):
    """(max |got - ref|, max of |got - ref| / the elementwise limit of
    ``kernel_tolerance``); the second is at most 1 where they agree."""
    err = (got.float() - ref.float()).abs()
    lim = pa.kernel_tolerance(*args, ref, scale=scale)
    return float(err.max()), float((err / lim).max())


def check_kernels(torch, pa, device):
    rng = np.random.default_rng(0)
    llama_rng = np.random.default_rng(40)
    cases = []
    for dtype in ("bfloat16", "float32", "float16"):
        for G in (1, 4):
            cases.append(("decode", 8, 1, 16 // G, G, 64, 32,
                          decode_lengths(rng), dtype))
            cases.append(("prefill", 8, 64, 16 // G, G, 64, 32,
                          prefill_offsets(rng), dtype))
        cases.append(("bs16-g8", 4, 3, 2, 8, 64, 16,
                      [0, 17, 500, 1000], dtype))
        cases.append(("bs64-d128", 4, 5, 4, 4, 128, 64,
                      [3, 64, 700, 250], dtype))
        cases.append(("bs128-s128", 2, 128, 2, 1, 64, 128, [0, 777], dtype))
        # a 64-column tile over 4 pages, the live prefix ending mid-page
        cases.append(("bs16-g2-d128-s64", 4, 64, 4, 2, 128, 16,
                      [0, 37, 300, 129], dtype))
        # horizons one short of and one past a tile edge (decode, prefill)
        cases.append(("bs32-tile-edge", 4, 1, 8, 1, 64, 32,
                      [126, 128, 62, 64], dtype))
        cases.append(("bs32-tile-edge-s64", 4, 64, 8, 1, 64, 32,
                      [63, 65, 127, 0], dtype))
        # split boundaries every 64 columns, half of them inside a page
        cases.append(("bs128-split-mid-page", 2, 8, 2, 2, 64, 128,
                      [300, 700], dtype))
        # serve_knobs' verify_step: K + 1 = 5 rows of a 64-row tile, G 1
        cases.append(("verify", 8, 5, 16, 1, 64, 32,
                      verify_lengths(np.random.default_rng(5)), dtype))
        # llama_serve's step programs: LLaMA-2-7B's 32 kv heads of 128, G 1,
        # over 2048-token slots (its decode and prefill-chunk shapes)
        cases.append(("llama-decode", 8, 1, 32, 1, 128, 32,
                      llama_lengths(llama_rng), dtype))
        cases.append(("llama-prefill", 8, 64, 32, 1, 128, 32,
                      llama_lengths(llama_rng, S=64), dtype))
    results = []
    worst = {}
    for n, (name, B, S, Hkv, G, D, BS, lengths, dtype) in enumerate(cases):
        if name == "bs128-split-mid-page":
            _, tps, splits = pa.kernel_launch_config(B, S, G, Hkv,
                                                     1024 // BS, BS)
            inside = [j * tps * 64 for j in range(1, splits)
                      if (j * tps * 64) % BS
                      and j * tps * 64 < max(lengths) + S]
            if not inside:
                raise AssertionError(f"{name}: no split boundary inside a "
                                     f"live page (tiles per split {tps})")
        args = make_case(torch, B, S, Hkv, G, D, BS, list(lengths), dtype,
                         device, seed=100 + n,
                         capacity=LLAMA_SLOT if name.startswith("llama")
                         else 1024)
        got = pa.paged_decode_attention(*args)
        torch.cuda.synchronize()
        ref = pa.paged_decode_attention_ref(*args)
        err, over = held_to_plain(torch, pa, args, got, ref)
        ok = bool(torch.isfinite(got).all()) and over <= 1.0
        rec = dict(case=name, dtype=dtype, B=B, S=S, Hq=Hkv * G, Hkv=Hkv,
                   D=D, BS=BS, max_abs_err=err, err_over_limit=over, ok=ok)
        print("kernel-check", json.dumps(rec), flush=True)
        results.append(rec)
        if name in ("decode", "prefill"):
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        if name.startswith("llama") and dtype == "bfloat16":
            d128 = worst.setdefault("d128", {})
            d128[name[len("llama-"):]] = dict(max_abs_err=err,
                                              err_over_limit=over)
        if not ok:
            raise AssertionError(f"kernel disagrees with plain: {rec}")
    return results, worst


def time_ms(torch, fn, flush, reps=25, queued=True):
    """Device time of one call: median of `reps` calls, each between two
    CUDA events, L2 flushed before each (the main path reaches attention
    after a layer's weights). A device-side sleep queued first keeps the
    card busy while the host enqueues every call, so the events time the
    device's work and not the host's launch overhead; the sleep must still
    be running when the last call is queued, or the script fails. With
    ``queued=False`` each call is timed on its own after a synchronise:
    for calls of tens of ms whose gigabyte temporaries make the allocator
    synchronise the device, where launch overhead is noise."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if not queued:
        for start, end in ev:
            flush.zero_()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))
    torch.cuda._sleep(int(4e8))                 # ~0.2 s at 1.98 GHz
    slept = torch.cuda.Event()
    slept.record()
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    if slept.query():
        raise AssertionError("host fell behind the device while queueing; "
                             "the timing would include launch overhead")
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def attention_bound(B, S, Hq, Hkv, D, NB, BS, lengths, elt, dtype):
    """Least time for this call on an H100 SXM: each input byte read once
    (q, the LIVE K/V rows, tables, lengths), the output written once; the
    operations 4*D per allowed (query head, row, column) triple. Returns
    (ms, 'bytes' | 'operations')."""
    capacity = NB * BS
    lengths = np.asarray(lengths, np.int64)
    live = np.minimum(lengths + S, capacity)
    kv_bytes = 2 * int(live.sum()) * Hkv * D * elt
    io_bytes = 2 * B * S * Hq * D * elt + (B * NB + B) * 4
    pairs = sum(int(np.minimum(ln + np.arange(S) + 1, capacity).sum())
                for ln in lengths)
    flops = 4.0 * D * Hq * pairs
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernels(torch, pa, device, dtype="bfloat16",
                 shapes=("decode", "prefill", "decode_d128", "prefill_d128")):
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    out = {}
    for name, S, lengths, Hkv, D, cap in (
            ("decode", 1, decode_lengths(rng), 16, 64, 1024),
            ("prefill", 64, prefill_offsets(rng), 16, 64, 1024),
            ("decode_d128", 1, llama_lengths(rng), 32, 128, LLAMA_SLOT),
            ("prefill_d128", 64, llama_lengths(rng, S=64), 32, 128,
             LLAMA_SLOT)):
        if name not in shapes:
            continue
        B, G, BS = 8, 1, 32
        args = make_case(torch, B, S, Hkv, G, D, BS, list(lengths),
                         dtype, device, seed=7, capacity=cap)
        q, kp, vp, tbl, ln = args
        before = pa.paged_decode_attention.launches
        ms = time_ms(torch, lambda: pa.paged_decode_attention(*args), flush)
        launches = pa.paged_decode_attention.launches - before
        plain_ms = time_ms(torch,
                           lambda: pa.paged_decode_attention_ref(*args),
                           flush)
        # library yardstick: SDPA over the cache gathered dense (setup,
        # not timed); the port never calls it
        T = tbl.shape[1] * BS
        kd = kp[:, tbl.long()].reshape(Hkv, B, T, D).transpose(0, 1)
        vd = vp[:, tbl.long()].reshape(Hkv, B, T, D).transpose(0, 1)
        pos_q = ln.long()[:, None] + torch.arange(S, device=device)
        mask = (torch.arange(T, device=device)[None, None, :]
                <= pos_q[:, :, None])[:, None]
        qt = q.transpose(1, 2)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask), flush)
        bound_ms, bound_by = attention_bound(B, S, Hkv * G, Hkv, D,
                                             tbl.shape[1], BS, lengths, 2,
                                             dtype)
        rec = dict(shape=name, B=B, S=S, Hq=Hkv * G, Hkv=Hkv, D=D, BS=BS,
                   dtype=dtype, live_tokens=int(np.minimum(
                       np.asarray(lengths) + S, T).sum()),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   timed_launches=launches)
        print("kernel-time", json.dumps(rec), flush=True)
        out[name] = rec
    return out


# ----------------------------------------------------------- phase 8/9
def dense_case(torch, B, S, Hkv, G, D, T, lengths, dtype, device, seed):
    """Random q and dense head-leading caches [B, Hkv, T, D], lengths (an
    int, the one length dense generate() passes, stays an int)."""
    g = torch.Generator(device=device).manual_seed(seed)
    td = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=g, device=device).to(td)
               for shape in ((B, S, Hkv * G, D), (B, Hkv, T, D),
                             (B, Hkv, T, D)))
    if isinstance(lengths, int):
        return q, k, v, lengths
    return q, k, v, torch.as_tensor(np.asarray(lengths, np.int32),
                                    device=device)


# llama_generate: generate(ids [B, P], P + new tokens) and its cache rows
LLAMA_GEN = (4, 512, 128)
LLAMA_T = LLAMA_GEN[1] + LLAMA_GEN[2]


def generation_lengths(rng, B=8, S=1, T=640):
    """Per-request lengths of the generation shapes: decode (S = 1) at
    512-639, where generate()'s 128 decode steps put them; prefill at 0."""
    if S > 1:
        return np.zeros(B, np.int64)
    return rng.integers(512, T - S + 1, B)


def check_dense_kernels(torch, da, device):
    """The dense kernel against its plain version on the card: the
    generation shapes (B = 8, 16 heads of 64, T = 640; decode S = 1 at
    lengths 512-639, prefill S = 512 at 0; both again with the one int
    length generate() passes), GQA 4 and 8 at D = 128, a T that is no
    multiple of any tile, requests whose live prefix ends inside the first
    tile, the two forms' threshold (16 and 17, 24 rows per (request, kv
    head)) at the full cache, and one request over a long cache (many
    splits) in either form; f32 and bf16."""
    rng = np.random.default_rng(20)
    llama_rng = np.random.default_rng(41)
    cases = []
    for dtype in ("bfloat16", "float32", "float16"):
        cases += [
            ("decode", 8, 1, 16, 1, 64, 640, generation_lengths(rng), dtype),
            ("prefill", 8, 512, 16, 1, 64, 640,
             generation_lengths(rng, S=512), dtype),
            ("decode-int", 8, 1, 16, 1, 64, 640, 575, dtype),
            ("prefill-int", 8, 512, 16, 1, 64, 640, 0, dtype),
            ("g4-d128", 4, 1, 4, 4, 128, 700, [0, 37, 400, 699], dtype),
            ("g4-d128-s33", 2, 33, 4, 4, 128, 700, [0, 600], dtype),
            ("g8-d128", 4, 3, 2, 8, 128, 300, [5, 64, 200, 297], dtype),
            ("ragged-t1000", 2, 7, 8, 1, 64, 1000, [500, 993], dtype),
            ("first-tile", 4, 1, 16, 1, 64, 640, [0, 3, 40, 63], dtype),
            # the forms' threshold, 16 rows per (request, kv head) (decode
            # form) and 17 and 24 (bf16: prefill form), at the full cache
            ("rows16-g8-d128", 4, 2, 2, 8, 128, 300, [0, 77, 150, 298],
             dtype),
            ("rows17", 4, 17, 4, 1, 64, 300, [0, 77, 150, 283], dtype),
            ("rows24-g8", 4, 3, 2, 8, 64, 300, [0, 77, 150, 297], dtype),
            # one request over a long cache: many splits in either form
            ("b1-decode-splits", 1, 1, 16, 1, 64, 4096, [4095], dtype),
            ("b1-prefill-splits", 1, 64, 16, 1, 64, 2048, [1984], dtype),
            # llama_generate: generate([4, 512] + 128) of LLaMA-2-7B, 32 kv
            # heads of 128, G 1 (its decode and prefill shapes)
            ("llama-decode", LLAMA_GEN[0], 1, 32, 1, 128, LLAMA_T,
             generation_lengths(llama_rng, LLAMA_GEN[0], 1, LLAMA_T), dtype),
            ("llama-prefill", LLAMA_GEN[0], LLAMA_GEN[1], 32, 1, 128,
             LLAMA_T, 0, dtype),
        ]
    results, worst = [], {}
    for n, (name, B, S, Hkv, G, D, T, lengths, dtype) in enumerate(cases):
        args = dense_case(torch, B, S, Hkv, G, D, T, lengths, dtype, device,
                          seed=400 + n)
        cfg = da.kernel_launch_config(B, S, G, Hkv, T, getattr(torch, dtype))
        if "splits" in name and cfg.splits == 1:
            raise AssertionError(f"{name}: expected several splits, {cfg}")
        got = da.decode_attention(*args)
        torch.cuda.synchronize()
        ref = da.decode_attention_ref(*args)
        err, over = held_to_plain(torch, da, args, got, ref)
        ok = bool(torch.isfinite(got).all()) and over <= 1.0
        rec = dict(case=name, dtype=dtype, B=B, S=S, Hq=Hkv * G, Hkv=Hkv,
                   D=D, T=T, form=cfg.form, splits=cfg.splits,
                   max_abs_err=err, err_over_limit=over, ok=ok)
        print("dense-check", json.dumps(rec), flush=True)
        results.append(rec)
        if name.startswith(("decode", "prefill")):
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        if name.startswith("llama") and dtype == "bfloat16":
            d128 = worst.setdefault("d128", {})
            d128[name[len("llama-"):]] = dict(max_abs_err=err,
                                              err_over_limit=over)
        if not ok:
            raise AssertionError(f"dense kernel disagrees with plain: {rec}")
    return results, worst


def dense_bound(B, S, Hq, Hkv, D, T, lengths, elt, dtype):
    """Least time of one dense call on an H100 SXM: q, the LIVE K/V rows
    and the lengths read once, the output written once; 4*D operations per
    allowed (query head, row, column) triple. Returns (ms, 'bytes' |
    'operations')."""
    lengths = np.asarray(lengths, np.int64)
    live = np.minimum(lengths + S, T)
    nbytes = (2 * int(live.sum()) * Hkv * D * elt
              + 2 * B * S * Hq * D * elt + B * 4)
    pairs = sum(int(np.minimum(ln + np.arange(S) + 1, T).sum())
                for ln in lengths)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * D * Hq * pairs / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_dense_kernels(torch, da, device, dtype="bfloat16",
                       shapes=("decode", "prefill", "decode_b1",
                               "decode_d128", "prefill_d128")):
    """Kernel, plain and library at the generation shapes (bf16, or
    ``dtype``), and at one request decoding at length 4000 of T = 4096
    (the split path). The library yardstick is
    scaled_dot_product_attention over the same dense cache with the length
    mask; the port never calls it."""
    import torch.nn.functional as F

    rng = np.random.default_rng(21)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    out = {}
    for name, B, S, T, Hkv, D in (
            ("decode", 8, 1, 640, 16, 64), ("prefill", 8, 512, 640, 16, 64),
            ("decode_b1", 1, 1, 4096, 16, 64),
            ("decode_d128", LLAMA_GEN[0], 1, LLAMA_T, 32, 128),
            ("prefill_d128", LLAMA_GEN[0], LLAMA_GEN[1], LLAMA_T, 32, 128)):
        lengths = (generation_lengths(rng, B, S, T) if B > 1
                   else np.array([4000]))
        if name not in shapes:
            continue
        args = dense_case(torch, B, S, Hkv, 1, D, T, lengths, dtype,
                          device, seed=7)
        q, k, v, ln = args
        ms = time_ms(torch, lambda: da.decode_attention(*args), flush)
        plain_ms = time_ms(torch, lambda: da.decode_attention_ref(*args),
                           flush)
        pos_q = ln.long()[:, None] + torch.arange(S, device=device)
        mask = (torch.arange(T, device=device)[None, None, :]
                <= pos_q[:, :, None])[:, None]
        qt = q.transpose(1, 2)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask), flush)
        bound_ms, bound_by = dense_bound(B, S, Hkv, Hkv, D, T, lengths, 2,
                                         dtype)
        cfg = da.kernel_launch_config(B, S, 1, Hkv, T, getattr(torch, dtype))
        rec = dict(shape=name, B=B, S=S, Hq=Hkv, Hkv=Hkv, D=D, T=T,
                   dtype=dtype,
                   live_tokens=int(np.minimum(lengths + S, T).sum()),
                   config=list(cfg), ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, over_bound=ms / bound_ms,
                   over_library=ms / library_ms)
        print("dense-time", json.dumps(rec), flush=True)
        out[name] = rec
    return out


# ----------------------------------------------------------- phase 5/6
FLASH_OUTPUTS = {"fwd": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}


def flash_run(fa, q, k, v, do, causal, plain=False, sri=None):
    """The three kernels (or their plain versions) on one case, their masked
    forms under a FlashMask ``sri``; the backward takes the plain forward's
    out and lse, so both sides see the same saved inputs."""
    ro, rl = fa.flash_attention_fwd_ref(q, k, v, causal, sri=sri)
    delta = fa.attention_delta(ro, do)
    if plain:
        out = dict(out=ro, lse=rl,
                   dq=fa.flash_attention_dq_ref(q, k, v, do, rl, delta,
                                                causal, sri=sri))
        out["dk"], out["dv"] = fa.flash_attention_dkv_ref(
            q, k, v, do, rl, delta, causal, sri=sri)
        return out, delta
    o, lse = fa.flash_fwd(q, k, v, causal, sri=sri)
    out = dict(out=o, lse=lse, dq=fa.flash_bwd_dq(q, k, v, do, rl, delta,
                                                  causal, sri=sri))
    out["dk"], out["dv"] = fa.flash_bwd_dkv(q, k, v, do, rl, delta, causal,
                                            sri=sri)
    return out, delta


def over_limit(torch, got, ref, lim):
    """{output: (max |got - ref|, max of |got - ref| / limit)}."""
    res = {}
    for name, x in got.items():
        err = (x.float() - ref[name].float()).abs()
        ratio = torch.where(err == 0, torch.zeros_like(err),
                            err / lim[name].clamp(min=1e-30))
        res[name] = (float(err.max()), float(ratio.max()))
    return res


def flash_inputs(torch, B, S, H, Hkv, D, dtype, device, seed):
    """q, k, v, dO on the card; kv heads repeated to H as the wrapper
    repeats them (``repeat_interleave``) before the kernels."""
    g = torch.Generator(device=device).manual_seed(seed)
    td = getattr(torch, dtype)
    q, do = (torch.randn((B, S, H, D), generator=g, device=device).to(td)
             for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=device).to(td)
            .repeat_interleave(H // Hkv, dim=2) for _ in range(2))
    return q, k, v, do


# the flash kernels' storage dtypes: the wgmma forms (bf16, and f16 for AMP
# in float16) and the CUDA-core f32 forms
FLASH_DTYPES = ("bfloat16", "float16", "float32")


def worst_of(worst, dtype, res):
    """Fold one case's max |kernel - plain| per output into ``worst``
    {dtype: {kernel: max abs err}} (lse left out)."""
    per = worst.setdefault(dtype, {})
    for kern, outs in FLASH_OUTPUTS.items():
        per[kern] = max([per.get(kern, 0.0)]
                        + [res[o][0] for o in outs if o != "lse"])


def check_flash_kernels(torch, fa, device):
    cases = [("train", 8, 1024, 16, 16, 64, True),
             ("noncausal", 2, 1024, 8, 8, 64, False),
             ("d128", 2, 512, 8, 8, 128, True),
             ("gqa", 2, 1024, 16, 4, 64, True),
             ("ragged", 2, 1000, 8, 8, 64, True),
             ("s8192", 1, 8192, 4, 4, 64, True),
             # llama_train (LLaMA-2-7B, B 1, S 2048, 32 heads of 128) and
             # bert_base's eval forward (B 32, S 512, 12 heads of 64)
             ("llama", 1, 2048, 32, 32, 128, True),
             ("bert", 32, 512, 12, 12, 64, False)]
    results, worst = [], {}
    for n, (name, B, S, H, Hkv, D, causal) in enumerate(cases):
        for dtype in FLASH_DTYPES:
            q, k, v, do = flash_inputs(torch, B, S, H, Hkv, D, dtype, device,
                                       seed=200 + n)
            got, _ = flash_run(fa, q, k, v, do, causal)
            torch.cuda.synchronize()
            ref, delta = flash_run(fa, q, k, v, do, causal, plain=True)
            lim = fa.kernel_tolerance(q, k, v, ref, causal, dout=do,
                                      delta=delta)
            res = over_limit(torch, got, ref, lim)
            ok = (all(bool(torch.isfinite(x).all()) for x in got.values())
                  and all(r <= 1.0 for _, r in res.values()))
            rec = dict(case=name, dtype=dtype, B=B, S=S, H=H, Hkv=Hkv, D=D,
                       causal=causal, ok=ok,
                       **{f"{o}_max_abs_err": e for o, (e, _) in res.items()},
                       **{f"{o}_err_over_limit": r
                          for o, (_, r) in res.items()})
            print("flash-check", json.dumps(rec), flush=True)
            results.append(rec)
            if name in ("llama", "bert"):
                if dtype == "bfloat16":
                    worst.setdefault(name, {}).update(
                        {kern: dict(
                            max_abs_err=max(res[o][0] for o in outs
                                            if o != "lse"),
                            err_over_limit=max(res[o][1] for o in outs))
                         for kern, outs in FLASH_OUTPUTS.items()})
            else:
                worst_of(worst, dtype, res)
            if not ok:
                raise AssertionError(f"flash kernel disagrees with plain: "
                                     f"{rec}")
            del got, ref, lim
    return results, worst


def flash_bounds(B, S, H, D, causal, elt=2, pairs=None, mask_bytes=0):
    """Least time of each kernel on an H100 SXM at these shapes: each input
    read once and each output written once; 2*D operations per allowed
    (row, column) pair and product (forward 2 products, dq 3, dk/dv 4).
    ``pairs``: the allowed pairs of one head where a FlashMask sets them
    (default all, or the causal triangle); ``mask_bytes``: the FlashMask,
    read once by each kernel. Returns {kernel: (ms, 'bytes' |
    'operations')}."""
    if pairs is None:
        pairs = S * (S + 1) // 2 if causal else S * S
    pairs *= B * H
    tile = B * S * H * D * elt
    row = B * H * S * 4
    work = {"fwd": (2, 3 * tile + tile + row + mask_bytes),
            "dq": (3, 4 * tile + 2 * row + tile + mask_bytes),
            "dkv": (4, 4 * tile + 2 * row + 2 * tile + mask_bytes)}
    out = {}
    for kern, (products, nbytes) in work.items():
        t_ops = 2.0 * D * pairs * products / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[kern] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


# (B, S, H, D, dtype, causal): the main path's, the TPU's chunked range,
# the main path's shape in f16 (AMP in float16), llama_train's (D 128) and
# bert_base's eval forward (non-causal)
FLASH_TIMED_SHAPES = {"train": (8, 1024, 16, 64, "bfloat16", True),
                      "s8192": (1, 8192, 4, 64, "bfloat16", True),
                      "train_f16": (8, 1024, 16, 64, "float16", True),
                      "llama": (1, 2048, 32, 128, "bfloat16", True),
                      "bert": (32, 512, 12, 64, "bfloat16", False)}


def time_flash(torch, fa, device):
    """Kernel, plain and library times of the three kernels at the shapes
    of FLASH_TIMED_SHAPES: the training shape in bf16 and f16, S = 8192,
    where the TPU ran its chunked backward (rows 6-7), llama_train's D 128
    and bert_base's non-causal shape. The library yardstick is
    scaled_dot_product_attention on the same inputs ([B, H, S, D]
    contiguous copies made outside the timing): its forward for the
    forward, its one backward (dq, dk and dv together) for dq and dk/dv.
    The port never calls it. Returns {shape: {kernel: record}}."""
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    out = {}
    for shape, (B, S, H, D, dtype, causal) in FLASH_TIMED_SHAPES.items():
        q, k, v, do = flash_inputs(torch, B, S, H, H, D, dtype, device,
                                   seed=300)
        ro, rl = fa.flash_attention_fwd_ref(q, k, v, causal)
        delta = fa.attention_delta(ro, do)
        calls = {
            "fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                    lambda: fa.flash_attention_fwd_ref(q, k, v, causal)),
            "dq": (lambda: fa.flash_bwd_dq(q, k, v, do, rl, delta, causal),
                   lambda: fa.flash_attention_dq_ref(q, k, v, do, rl, delta,
                                                     causal)),
            "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, rl, delta,
                                             causal),
                    lambda: fa.flash_attention_dkv_ref(q, k, v, do, rl,
                                                       delta, causal)),
        }
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        for t in (qt, kt, vt):
            t.requires_grad_()
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), flush)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), flush)
        bounds = flash_bounds(B, S, H, D, causal)
        out[shape] = {}
        for kern, (kernel, plain) in calls.items():
            rec = dict(shape=shape, kernel=kern, B=B, S=S, H=H, D=D,
                       dtype=dtype, causal=causal,
                       ms=time_ms(torch, kernel, flush),
                       plain_ms=time_ms(torch, plain, flush),
                       library_ms=lib_fwd if kern == "fwd" else lib_bwd,
                       library_call=("sdpa forward" if kern == "fwd" else
                                     "sdpa backward (dq, dk, dv in one "
                                     "call)"),
                       bound_ms=bounds[kern][0], bound_by=bounds[kern][1])
            print("flash-time", json.dumps(rec), flush=True)
            out[shape][kern] = rec
        out[shape]["bwd"] = whole_backward(out[shape], shape=shape, B=B, S=S,
                                           H=H, D=D, dtype=dtype)
        del q, k, v, do, ro, rl, delta, qt, kt, vt, dot, lib_out, calls
    return out


def whole_backward(recs, **shape):
    """dq + dk/dv of one timed shape against the library's one backward
    call (dq, dk and dv together), with the ratio; printed."""
    dq, dkv = recs["dq"], recs["dkv"]
    rec = dict(shape, kernel="dq+dkv", ms=dq["ms"] + dkv["ms"],
               library_ms=dq["library_ms"],
               library_call=dq["library_call"],
               over_library=(dq["ms"] + dkv["ms"]) / dq["library_ms"],
               bound_ms=dq["bound_ms"] + dkv["bound_ms"])
    if "unmasked_ms" in dq:
        rec["unmasked_ms"] = dq["unmasked_ms"] + dkv["unmasked_ms"]
    print("backward-time", json.dumps(rec), flush=True)
    return rec


# --------------------------------------------------------------- phase 7
def insitu_check(torch, model, cache_cls, device, C=64, slots=8, mod=None,
                 layers=None, decode=False):
    """Two prefill chunks of the full model per path, the second over a
    cache the first filled (and with ``decode`` a one-token decode forward
    after them). On the kernel path every layer's kernel call (or those of
    ``layers``) is held to the plain version on the same inputs (the limit
    of ``kernel_tolerance``), and the logits to the plain attention path's.
    A control runs the kernel with each request's length one short (every
    query row misses its own key) and must fail the per-layer check.
    ``mod``: the model's module, whose ``paged_decode_attention`` the check
    rebinds (GPT's by default)."""
    from paddle_tpu_torch.models import gpt as gpt_mod
    from paddle_tpu_torch.ops import paged_attention as pa

    mod = mod or gpt_mod
    rng = np.random.default_rng(4)
    V = model.config.vocab_size
    L = model._decode_cache_spec()[0]
    ids = rng.integers(0, V, (slots, 2 * C + 1))
    lens = np.full(slots, C)
    lens[2] = max(1, C * 37 // 64)              # a short chunk
    kernel = mod.paged_decode_attention

    def run(path, fault=False):
        over, calls = [], [0]

        def checked(q, kp, vp, tbl, ln, scale=None):
            layer = calls[0] % L
            calls[0] += 1
            bad = (ln - 1).clamp(min=0) if fault else ln
            got = kernel(q, kp, vp, tbl, bad, scale=scale)
            if layers is None or layer in layers:
                args = (q, kp, vp, tbl, ln)
                ref = pa.paged_decode_attention_ref(*args, scale=scale)
                over.append(held_to_plain(torch, pa, args, got, ref,
                                          scale)[1])
            return got

        kv = cache_cls(*model._decode_cache_spec(), block_size=32,
                       num_blocks=slots * 5, dtype=torch.bfloat16,
                       device=device)
        tables = np.stack([kv.reserve(i, 2 * C + 1) for i in range(slots)])
        mod.paged_decode_attention = checked
        try:
            rows = [model.chunk_logits(ids[:, :C], np.zeros(slots), lens, kv,
                                       tables, decode_kernel=path),
                    model.chunk_logits(ids[:, C:2 * C], lens,
                                       np.full(slots, C), kv, tables,
                                       decode_kernel=path)]
            if decode:
                rows.append(model.chunk_logits(
                    ids[:, 2 * C:], lens + C, np.ones(slots, np.int64), kv,
                    tables, decode_kernel=path))
        finally:
            mod.paged_decode_attention = kernel
        logits = torch.stack(rows).float()
        if not torch.isfinite(logits).all():
            raise AssertionError(f"non-finite logits on the {path} path")
        return logits, max(over, default=None)

    plain, _ = run("plain")
    scale = float(plain.abs().max())
    rec = dict(max_abs_logit=scale, rel_tol=INSITU_REL_TOL)
    for name, fault in (("kernel", False), ("fault", True)):
        logits, over = run("kernel", fault)
        diff = float((logits - plain).abs().max())
        rec[name] = dict(
            layer_err_over_limit=over, max_abs_dlogit=diff,
            rel=diff / scale, greedy_agreement=float(
                (logits.argmax(-1) == plain.argmax(-1)).float().mean()))
    rec.update(layers="all" if layers is None else list(layers),
               decode=decode)
    print("insitu", json.dumps(rec), flush=True)
    k, f = rec["kernel"], rec["fault"]
    if k["layer_err_over_limit"] > 1.0 or k["rel"] > INSITU_REL_TOL:
        raise AssertionError(f"kernel path drifts from plain path: {rec}")
    if f["layer_err_over_limit"] <= 1.0:
        raise AssertionError(f"the planted fault passed a check: {rec}")
    return rec


# CUDA runtime calls that put work on the device, as the profiler names them
HOST_LAUNCH_CALLS = re.compile(
    r"^cu(da)?(LaunchKernel(ExC|Ex)?|GraphLaunch"
    r"|Memcpy\w*Async|Memset\w*Async)$")


def graph_pool_bytes(torch, model):
    """Bytes the caching allocator holds in ``model``'s graph memory pool
    (every capture of the model allocates from it); None where the
    allocator's snapshot names no pools."""
    return pool_bytes(torch, getattr(model, "_graph_pool_handle", None))


def pool_bytes(torch, pool):
    """Bytes the caching allocator holds in the graph memory pool
    ``pool`` (0 for None); None where the snapshot names no pools."""
    if pool is None:
        return 0
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    return int(sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == tuple(pool)))


def captures_total(model):
    """Graphs captured so far by the model's live runners."""
    return sum(r["captures"] for r in runner_stats(model).values())


def runner_stats(model):
    """{kind: keys, captures, replays, capture seconds} of the model's
    step-program runners."""
    out = {}
    for key, run in list(model._runner_cache().items()):
        rec = out.setdefault(key[0], dict(keys=0, captures=0, replays=0,
                                          capture_s=0.0))
        rec["keys"] += 1
        rec["captures"] += run.captures
        rec["replays"] += run.replays
        rec["capture_s"] += run.capture_s
    return out


def profile_call(torch, fn, attention=()):
    """Where one call's time goes: ``fn`` (ending in a host copy or a
    synchronisation) timed by the host clock (median of 3 after a warm
    call), then traced by torch.profiler over one call: the device time of
    the kernels the profiler saw and their count, the device's busy share
    (kernel time over the profiled wall; one stream, no overlap), the host's
    launch calls (the CUDA runtime calls that put kernels, graphs and copies
    on the device), the share of device time in kernels whose names hold
    one of ``attention``, and the time by kernel kind."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    calls = {e.key: e.count for e in events
             if HOST_LAUNCH_CALLS.match(e.key)}
    dev_us = sum(e.self_device_time_total for e in kernels)
    attn_us = sum(e.self_device_time_total for e in kernels
                  if any(a in e.key for a in attention))
    by_kind = {}
    for e in kernels:
        kind = ("attention" if any(a in e.key for a in attention)
                else kernel_kind(e.key))
        ms, n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=float(np.median(walls)) * 1e3,
                profiled_wall_ms=prof_wall * 1e3,
                device_ms=dev_us / 1e3 if dev_us else None,
                kernel_launches=int(sum(e.count for e in kernels)),
                device_busy_share=(dev_us / 1e6 / prof_wall
                                   if dev_us else None),
                host_launch_calls=int(sum(calls.values())),
                host_calls_by_name=calls,
                attention_share_of_device=(attn_us / dev_us
                                           if dev_us else None),
                device_ms_by_kind=by_kind,
                top_kernels=[(e.key[:80], e.count,
                              e.self_device_time_total / 1e3) for e in top])


def graph_device_ms(torch, run, name, reps=10):
    """Device time of one replay of ``run``'s graph ``name``."""
    with run.lock:
        return replay_device_ms(torch, run.graphs[name].graph, reps)


def replay_device_ms(torch, graph, reps=10):
    """Device time of one replay of ``graph``: CUDA events around ``reps``
    back-to-back replays on the same inputs (measurement replays, left out
    of the wrappers' launch counts)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_launch_ms(torch, run, name, reps=10):
    """Host time of one ``replay()`` call of ``run``'s graph ``name``
    (the device idle first, so the launches do not queue behind work)."""
    graph = run.graphs[name].graph
    out = []
    with run.lock:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.replay()
            out.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return float(np.median(out)) * 1e3


def both_forms(torch, fn, run, name, attention):
    """``profile_call`` of ``fn`` with ``run``'s bodies run without capture
    (``body``) and replayed (``replay``), and the graph's device time."""
    with run._eager():
        body = profile_call(torch, fn, attention)
    replay = profile_call(torch, fn, attention)
    replay["graph_device_ms"] = graph_device_ms(torch, run, name)
    replay["graph_launch_ms"] = graph_launch_ms(torch, run, name)
    return dict(body=body, replay=replay)


PAGED_ATTENTION = ("paged_partials_kernel", "combine_kernel")
DENSE_ATTENTION = ("dense_decode_kernel", "dense_prefill_kernel",
                   "split_kv_combine_kernel")


def forward_logits_check(torch, model, kv, tables, offsets, ids, device):
    """One paged forward (the prefill program's) captured into a graph of
    its own, its last-position logits against the same forward's body on
    the same inputs: max |replay - body| (0 expected)."""
    from paddle_tpu_torch.jit.graphs import StepRunner

    S, C = ids.shape
    V = model.config.vocab_size

    def body(inp, out):
        valid = torch.ones((S, C), dtype=torch.bool, device=device)
        step = model._device_step(inp["offsets"], C, inp["tables"], valid,
                                  kv.block_size, kv.scratch_slot)
        lg = model._decode_call(model._decode_state(kv.dtype), inp["ids"],
                                kv.k_pages, kv.v_pages, step, "kernel")
        out["logits"].copy_(lg[:, -1].float())

    run = StepRunner(device, {"ids": ((S, C), torch.int64),
                              "offsets": ((S,), torch.int64),
                              "tables": (tables.shape, torch.int32)},
                     {"logits": ((S, V), torch.float32)}, {"fwd": body},
                     pool=model._graph_pool())
    run.fill(ids=ids, offsets=offsets, tables=tables)
    with run._eager():
        run.run("fwd")
    eager = run.read()["logits"]
    run.run("fwd")                  # first run: the body, then the capture
    run.run("fwd")                  # a replay
    replay = run.read()["logits"]
    if not np.isfinite(eager).all():
        raise AssertionError("non-finite logits in the captured forward")
    return float(np.abs(replay - eager).max())


def profile_steps(torch, model, cache_cls, device, slots=8, chunk=64,
                  decode_steps=4, spec_k=4, seed=6):
    """The graphs phase of the paged step programs, and where their time
    goes. decode_step (``decode_steps`` tokens per slot), prefill_chunk
    (``chunk`` rows per slot) and verify_step (``spec_k`` drafts) over 8
    slots with 300-900 cached tokens each, bf16. Per program: the first
    call, which runs the body and captures its graph (capture time, the
    graph pool's growth); the replay against the body run without capture
    on the same inputs, greedy and sampled (temperature 0.8, top-k 40, one
    seed): the tokens must be identical; then both forms through
    ``profile_call``, and the graph's device time by CUDA events. Last, a
    captured paged forward's logits against its body's."""
    rng = np.random.default_rng(seed)
    kv = cache_cls(*model._decode_cache_spec(), block_size=32,
                   num_blocks=slots * 1024 // 32, dtype=torch.bfloat16,
                   device=device)
    tables = np.stack([kv.reserve(i, 1024) for i in range(slots)])
    lengths = rng.integers(300, 900, slots)
    V = model.config.vocab_size
    tok = rng.integers(0, V, slots)
    chunk_ids = rng.integers(0, V, (slots, chunk))
    vchunk = rng.integers(0, V, (slots, spec_k + 1))
    every = np.ones(slots, bool)
    programs = {
        "decode_step": (
            lambda **kw: model.decode_step(
                tok, lengths, every, kv, tables, steps=decode_steps,
                max_lens=lengths + decode_steps, **kw),
            lambda: model.compiled_decode_step_runner(slots, decode_steps),
            slots * decode_steps),
        "prefill_chunk": (
            lambda **kw: model.prefill_chunk(
                chunk_ids, lengths, np.full(slots, chunk), kv, tables, **kw),
            lambda: model.compiled_prefill_chunk_runner(slots, chunk),
            slots * chunk),
        "verify_step": (
            lambda **kw: model.verify_step(
                vchunk, lengths, np.full(slots, spec_k), every, kv, tables,
                max_lens=lengths + spec_k + 1, **kw),
            lambda: model.compiled_verify_step_runner(slots, spec_k + 1),
            slots * (spec_k + 1)),
    }
    sampled = dict(temperature=0.8, top_k=40, seed=3)
    out = {}
    for name, (call, runner, tokens) in programs.items():
        pool0 = graph_pool_bytes(torch, model)
        t0 = time.perf_counter()
        call()                                      # body, then capture
        first_ms = (time.perf_counter() - t0) * 1e3
        run = runner()
        pool1 = graph_pool_bytes(torch, model)
        equal = {}
        for form, kw in (("greedy", {}), ("sampled", sampled)):
            with run._eager():
                body = call(**kw)
            replay = call(**kw)
            equal[form] = all(np.array_equal(a, b) for a, b in zip(
                body if isinstance(body, tuple) else (body,),
                replay if isinstance(replay, tuple) else (replay,)))
        forms = both_forms(torch, call, run, "step", PAGED_ATTENTION)
        rec = dict(program=name, slots=slots, tokens=tokens,
                   keys=len(model._runners(name)), captures=run.captures,
                   capture_ms=run.capture_s * 1e3, first_call_ms=first_ms,
                   graph_pool_bytes=pool1,
                   graph_pool_growth_bytes=(None if None in (pool0, pool1)
                                            else pool1 - pool0),
                   replay_equals_body=equal, **forms)
        print("graphs", json.dumps(rec), flush=True)
        out[name] = rec
        if not all(equal.values()):
            raise AssertionError(f"{name}: replay differs from its body: "
                                 f"{equal}")
        if run.captures != (run.device.type == "cuda"):
            raise AssertionError(f"{name}: {run.captures} captures")
    out["forward_logits_max_abs_diff"] = forward_logits_check(
        torch, model, kv, tables, lengths, chunk_ids, device)
    print("graphs-logits", json.dumps(
        {"max_abs_diff": out["forward_logits_max_abs_diff"]}), flush=True)
    return out


def dense_graphs(torch, model, device):
    """The graphs phase of generate(ids [8, 512], max_new_tokens=128),
    bf16: the first call (the prefill and decode bodies, then their
    capture), then the replayed call against the bodies run without
    capture, greedy and sampled (tokens identical), and the host wall of
    each form."""
    rng = np.random.default_rng(21)
    V = model.config.vocab_size
    ids = torch.as_tensor(rng.integers(0, V, (GEN_B, GEN_P)), device=device)
    pool0 = graph_pool_bytes(torch, model)
    t0 = time.perf_counter()
    model.generate(ids, max_new_tokens=GEN_NEW).cpu()
    first_ms = (time.perf_counter() - t0) * 1e3
    run = model.compiled_generate_runner(GEN_B, GEN_P, GEN_NEW)
    pool1 = graph_pool_bytes(torch, model)
    equal, wall = {}, {}
    for form, kw in (("greedy", {}), ("sampled", dict(temperature=0.8,
                                                      top_k=40, seed=1))):
        t0 = time.perf_counter()
        with run._eager():
            body = model.generate(ids, max_new_tokens=GEN_NEW, **kw).cpu()
        t1 = time.perf_counter()
        replay = model.generate(ids, max_new_tokens=GEN_NEW, **kw).cpu()
        t2 = time.perf_counter()
        equal[form] = bool(torch.equal(body, replay))
        wall[form] = dict(body_ms=(t1 - t0) * 1e3, replay_ms=(t2 - t1) * 1e3)
    rec = dict(program="generate", B=GEN_B, prompt=GEN_P,
               new_tokens=GEN_NEW, keys=len(model._runners("dense")),
               captures=run.captures, capture_ms=run.capture_s * 1e3,
               first_call_ms=first_ms, graph_pool_bytes=pool1,
               graph_pool_growth_bytes=(None if None in (pool0, pool1)
                                        else pool1 - pool0),
               replay_equals_body=equal, wall=wall)
    print("graphs", json.dumps(rec), flush=True)
    if not all(equal.values()) or run.captures != 2 * (
            run.device.type == "cuda"):
        raise AssertionError(f"generate(): replay differs from its body or "
                             f"captured {run.captures} programs: {rec}")
    return rec


def serve(torch, model, device, n_requests=12, http_requests=2,
          prompt_range=(50, 700), new_range=(16, 64), slots=8, chunk=64,
          decode_steps=4, block_size=32, max_seq_len=1024, outputs=None):
    """The main path: threaded requests through the continuous scheduler,
    then requests over HTTP. Returns the serving record; ``outputs``, when
    given, receives {request: (prompt, output, sampled)}."""
    from paddle_tpu_torch.inference import (
        ContinuousGenerateBatchingPredictor,
        InferenceServer,
        PagedKVCache,
    )
    from paddle_tpu_torch.ops import paged_attention as pa

    spec = model._decode_cache_spec()
    kv = PagedKVCache(*spec, block_size=block_size,
                      num_blocks=slots * max_seq_len // block_size,
                      dtype=torch.bfloat16, device=device)
    gp = ContinuousGenerateBatchingPredictor(
        model, max_slots=slots, prefill_chunk=chunk, decode_steps=decode_steps,
        max_new_tokens=new_range[1], max_seq_len=max_seq_len, kv_cache=kv,
        device=device)
    stats = dict(prefill_s=0.0, prefill_tokens=0, prefill_calls=0,
                 prefill_capture_s=0.0, decode_s=0.0, decode_tokens=0,
                 decode_calls=0, decode_capture_s=0.0)
    pf, dc = model.prefill_chunk, model.decode_step

    def timed(phase, call, tokens, *a, timing_hook=None, **kw):
        seen = []

        def hook(info):                 # the scheduler's own hook, chained
            seen.append(info)
            if timing_hook is not None:
                timing_hook(info)

        t0 = time.perf_counter()
        out = call(*a, timing_hook=hook, **kw)          # ends in a copy
        dt = time.perf_counter() - t0
        stats[f"{phase}_s"] += dt
        stats[f"{phase}_tokens"] += tokens
        stats[f"{phase}_calls"] += 1
        if seen[0]["compiled"]:         # the call that captured the graph
            stats[f"{phase}_capture_s"] += dt
        return out

    def timed_prefill(chunk_ids, offsets, chunk_lens, *a, **kw):
        return timed("prefill", pf, int(np.sum(chunk_lens)), chunk_ids,
                     offsets, chunk_lens, *a, **kw)

    def timed_decode(tokens, lengths, active, *a, steps=1, **kw):
        return timed("decode", dc, int(np.sum(active)) * steps, tokens,
                     lengths, active, *a, steps=steps, **kw)

    model.prefill_chunk, model.decode_step = timed_prefill, timed_decode
    rng = np.random.default_rng(9)
    V = model.config.vocab_size
    plens = rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)
    plens[0], plens[1] = prompt_range
    news = rng.integers(new_range[0], new_range[1] + 1, n_requests)
    prompts = [rng.integers(0, V, n).astype(np.int64) for n in plens]
    results, errors = {}, {}

    def client(i):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_k=40)
        try:
            results[i] = gp.infer(prompts[i], timeout=600,
                                  max_new_tokens=int(news[i]), **kw)
        except Exception as e:      # reported below, fails the phase
            errors[i] = repr(e)

    srv = InferenceServer(gp, device=device, default_timeout=600).start()
    captures0 = captures_total(model)
    pa.paged_decode_attention.launches = 0          # main path starts here
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"requests failed: {errors}")
        http_out = []
        for j in range(http_requests):
            p = rng.integers(0, V, int(plens[j % len(plens)])).astype(
                np.int64)
            buf = io.BytesIO()
            np.savez(buf, ids=p)
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate", data=buf.getvalue(),
                method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                out = np.load(io.BytesIO(r.read()))["out0"]
            http_out.append((p, out))
    finally:
        wall = time.perf_counter() - t0
        srv.stop()                                  # drains, closes gp
        model.prefill_chunk, model.decode_step = pf, dc
    launches = pa.paged_decode_attention.launches   # main path ends here
    for i, out in results.items():
        want = len(prompts[i]) + int(news[i])
        if out.shape != (want,) or not np.array_equal(out[:plens[i]],
                                                      prompts[i]):
            raise AssertionError(f"request {i}: shape {out.shape} != "
                                 f"({want},) or prompt not echoed")
        if out.min() < 0 or out.max() >= V:
            raise AssertionError(f"request {i}: token ids out of range")
    if outputs is not None:
        outputs.update({i: (prompts[i], out, i % 2 == 1)
                        for i, out in results.items()})
    for p, out in http_out:
        if (out.shape != (len(p) + new_range[1],)
                or not np.array_equal(out[:len(p)], p)
                or out.min() < 0 or out.max() >= V):
            raise AssertionError("HTTP request: wrong length or ids")
    kv.check_conservation()
    if kv.blocks_in_use != 0:
        raise AssertionError(f"{kv.blocks_in_use} KV blocks leaked")
    snap = gp.metrics.snapshot()
    forwards = (snap.get("prefill_ticks", 0)
                + decode_steps * snap.get("decode_ticks", 0))
    expect = spec[0] * forwards
    rec = dict(requests=n_requests, http_requests=http_requests,
               completed=snap.get("completed", 0), wall_s=wall,
               prefill_tokens=stats["prefill_tokens"],
               prefill_s=stats["prefill_s"],
               prefill_tok_per_s=stats["prefill_tokens"] / stats["prefill_s"],
               decode_tokens=stats["decode_tokens"],
               decode_s=stats["decode_s"],
               decode_tok_per_s=stats["decode_tokens"] / stats["decode_s"],
               prefill_capture_s=stats["prefill_capture_s"],
               decode_capture_s=stats["decode_capture_s"],
               prefill_tok_per_s_replayed=stats["prefill_tokens"] / (
                   stats["prefill_s"] - stats["prefill_capture_s"]),
               decode_tok_per_s_replayed=stats["decode_tokens"] / (
                   stats["decode_s"] - stats["decode_capture_s"]),
               prefill_ticks=snap.get("prefill_ticks", 0),
               decode_ticks=snap.get("decode_ticks", 0),
               kernel_launches=launches, expected_launches=expect,
               captures=captures_total(model) - captures0,
               runners=runner_stats(model))
    print("serving", json.dumps(rec), flush=True)
    if rec["completed"] != n_requests + http_requests:
        raise AssertionError(f"completed {rec['completed']} of "
                             f"{n_requests + http_requests}")
    if launches != expect or launches == 0:
        raise AssertionError(f"kernel launches {launches} != num_layers x "
                             f"forwards = {expect}")
    return rec


# -------------------------------------------------------------- phase 7b
KNOB_SYSTEM, KNOB_SESSIONS, KNOB_TURNS = 512, 4, 4
# a greedy token is compared only before the reference's first near-tie:
# top-2 gap under this share of the row's max |logit| (the coarse bound of
# kernel-path drift, INSITU_REL_TOL; verify and decode launches round bf16
# at different places)
NEAR_TIE_REL = INSITU_REL_TOL
# a sample line of the Prometheus text format 0.0.4
PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? '
    r'(-?[0-9.e+-]+|[+-]Inf|NaN)$')
PROM_FAMILIES = ("paddle_serving_events_total",
                 "paddle_serving_request_latency_seconds",
                 "paddle_kv_pool_blocks", "paddle_kv_pool_live_utilization",
                 "paddle_decode_launch_seconds", "paddle_sched_slots",
                 "paddle_spec_tokens_total", "paddle_spec_acceptance_rate",
                 "paddle_prefix_cache_blocks",
                 "paddle_prefix_hit_tokens_total",
                 "paddle_serving_recompiles_total",
                 "paddle_http_responses_total")


def _http(port, path, data=None, headers=None):
    """(status, headers, body) of one request; an HTTP error is a status."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {},
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _npz(ids):
    buf = io.BytesIO()
    np.savez(buf, ids=ids)
    return buf.getvalue()


def chat_sessions(rng, V):
    """The serve_knobs traffic's shape: a 512-token system prompt of
    repeated 8-token motifs (so the n-gram drafter proposes) shared by
    every session; per session a unique first user message of 32-200
    tokens, three follow-ups of 8-16, each turn 16-64 new tokens, and a
    quarter of the turns sampled (temperature 0.8, top-k 40)."""
    motifs = rng.integers(0, V, (4, 8))
    system = np.concatenate([motifs[j] for j in rng.integers(0, 4, 64)])
    plan = []
    for i in range(KNOB_SESSIONS):
        turns = []
        for t in range(KNOB_TURNS):
            n = int(rng.integers(32, 201) if t == 0 else rng.integers(8, 17))
            turns.append(dict(user=rng.integers(0, V, n).astype(np.int64),
                              new=int(rng.integers(16, 65)),
                              sampled=(i + t) % 4 == 3))
        plan.append(turns)
    return system.astype(np.int64), plan


def first_tie(torch, model, seq, plen, device):
    """Generated positions of ``seq`` before the first near-tie of a
    cache-free forward over it (all of them when there is none)."""
    with torch.no_grad():
        lg = model(torch.as_tensor(seq[None], device=device)).float()[
            0, plen - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    scale = lg.abs().amax(dim=-1).cpu().numpy()
    ties = np.nonzero(gap < NEAR_TIE_REL * scale)[0]
    return int(ties[0]) if len(ties) else len(seq) - plen


def prefix_rows_check(torch, model, kv, pc, outs, device, chunk=64,
                      swap=KNOB_SYSTEM // 32):
    """Each of ``outs``' full blocks as the scheduler left them indexed in
    ``kv`` (the shared system pages, the rows its resumed prefills, decode
    and verify ticks wrote), held to a cold plain-path prefill
    (``rows_check``); the control swaps block ``swap``, the first past the
    shared prompt."""
    pages = [[b for _, b in pc.lookup(out).pairs] for out in outs]
    rec = rows_check(torch, model, kv, pages, outs, device, chunk, swap)
    rec["shared_prompt_pages_common"] = len(
        {tuple(p[:swap]) for p in pages}) == 1
    return rec


def rows_check(torch, model, kv, pages, outs, device, chunk, swap):
    """The K/V rows that ``kv`` holds for each of ``outs`` on its pages
    (``pages[i]``, one per full block), held against a cold prefill of the
    same tokens through the plain attention path in a fresh pool: per layer
    max |K - K_cold| / max |K_cold|, and the same of V, the worst kept.
    Tokens only decide these rows, so no near-tie cuts the comparison. A
    control swaps block ``swap`` of the first sequence for the second's and
    must exceed INSITU_REL_TOL."""
    from paddle_tpu_torch.inference import PagedKVCache

    bs = kv.block_size
    nbs = [len(p) for p in pages]
    S, NB = len(outs), max(nbs)
    ref = PagedKVCache(kv.num_layers, kv.num_kv_heads, kv.head_dim,
                       block_size=bs, num_blocks=S * NB, dtype=kv.dtype,
                       device=device)
    for i in range(S):
        ref.reserve(i, nbs[i] * bs)
    tables = np.stack([ref.block_table(i, pad_to=NB) for i in range(S)])
    ids = np.zeros((S, -(-NB * bs // chunk) * chunk), np.int64)
    for i, out in enumerate(outs):
        ids[i, :nbs[i] * bs] = out[:nbs[i] * bs]
    for off in range(0, NB * bs, chunk):
        lens = np.clip(np.asarray(nbs) * bs - off, 0, chunk)
        model.chunk_logits(ids[:, off:off + chunk], np.full(S, off), lens,
                           ref, tables, decode_kernel="plain")

    def worst(i, held):
        cold = torch.as_tensor(tables[i, :nbs[i]], device=device)
        held = torch.as_tensor(held, device=device)
        err = 0.0
        for pools, refs in ((kv.k_pages, ref.k_pages),
                            (kv.v_pages, ref.v_pages)):
            for a, r in zip(pools, refs):
                r = r[:, cold].float()
                err = max(err, float((a[:, held].float() - r).abs().max()
                                     / r.abs().max()))
        return err

    rel = [worst(i, pages[i]) for i in range(S)]
    control = None
    if S > 1 and min(nbs[:2]) > swap:
        planted = list(pages[0])
        planted[swap] = pages[1][swap]
        control = worst(0, planted)
    return dict(blocks=nbs, rel=rel, control=control,
                rel_tol=INSITU_REL_TOL)


def serve_knobs(torch, model, device, slots=8, chunk=64, decode_steps=4,
                block_size=32, max_seq_len=1024, spec_k=4):
    """The continuous scheduler with its serving knobs — spec_k 4 with the
    n-gram drafter, the prefix cache, shortest-prompt-first and warmup —
    behind InferenceServer, GPT-350M bf16. /readyz is polled from the
    start (503 while the warm thread captures, then 200); four chat
    sessions of four turns each (``chat_sessions``) run threaded, session
    0 first and the others once its system prompt is indexed; then the
    time to the first streamed token of a fresh 600-token prompt, cold and
    again as a prefix hit; then over HTTP one SSE request, the same prompt
    buffered, one sampled request with X-Temperature / X-Top-K / X-Spec:
    off, and a Prometheus scrape. Gates: the SSE chunks equal the buffered
    answer; the pool conserves after the drain, and blocks were shared
    during the run; prefix hits skipped prompt tokens; drafted = accepted
    + wasted and verify ticks ran; the warmup missed no program and no
    capture followed it; every scrape line is a comment or a sample, with
    the bound families; the paged kernel launched num_layers times per
    forward; and the greedy requests, served again by a plain scheduler
    (FIFO, no speculation, no prefix cache) on the same prompts, give the
    same tokens up to each request's first near-tie."""
    from paddle_tpu_torch.inference import (
        ContinuousGenerateBatchingPredictor,
        InferenceServer,
        PagedKVCache,
    )
    from paddle_tpu_torch.ops import paged_attention as pa

    spec = model._decode_cache_spec()
    L = spec[0]
    V = model.config.vocab_size
    rng = np.random.default_rng(31)
    system, plan = chat_sessions(rng, V)
    num_blocks = slots * max_seq_len // block_size

    def pool():
        return PagedKVCache(*spec, block_size=block_size,
                            num_blocks=num_blocks, dtype=torch.bfloat16,
                            device=device)

    kv = pool()
    base = dict(max_slots=slots, prefill_chunk=chunk,
                decode_steps=decode_steps, max_new_tokens=64,
                max_seq_len=max_seq_len, device=device)
    t_build = time.perf_counter()
    gp = ContinuousGenerateBatchingPredictor(
        model, kv_cache=kv, spec_k=spec_k, drafter="ngram",
        prefix_cache=True, admit_policy="shortest_prompt_first",
        warmup=True, **base)
    hits = {}               # prompt bytes -> its prefix hit, per request
    install = gp._install_seq

    def recording_install(idx, req):    # host bookkeeping, tick thread
        ok = install(idx, req)
        if ok:
            hits[np.asarray(req.arrays[0], np.int64).tobytes()] = (
                gp._slots[idx].prefix_hit)
        return ok

    gp._install_seq = recording_install
    srv = InferenceServer(gp, device=device, default_timeout=600).start()
    readyz = []
    while True:
        readyz.append(_http(srv.port, "/readyz")[0])
        if readyz[-1] == 200 or time.perf_counter() - t_build > 600:
            break
        time.sleep(0.02)
    warm_wall = time.perf_counter() - t_build
    stats = gp.warm_stats()
    pool_keys = {k: r.captures for k, r in model._runner_cache().items()
                 if ("pool", kv.uid) in k}
    records = [[None] * KNOB_TURNS for _ in range(KNOB_SESSIONS)]
    errors = {}
    shared_max = [0]
    watching = threading.Event()

    def watch():            # host bookkeeping only, no device work
        while not watching.is_set():
            shared_max[0] = max(shared_max[0], kv.shared_block_count)
            time.sleep(0.002)

    def session(i):
        hist = system
        try:
            for t, turn in enumerate(plan[i]):
                prompt = np.concatenate([hist, turn["user"]])
                kw = (dict(temperature=0.8, top_k=40) if turn["sampled"]
                      else {})
                out = gp.infer(prompt, timeout=600,
                               max_new_tokens=turn["new"], **kw)
                records[i][t] = (prompt, out)
                hist = out
        except Exception as e:      # reported below, fails the phase
            errors[i] = repr(e)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    pa.paged_decode_attention.launches = 0          # main path starts here
    t0 = time.perf_counter()
    try:
        first = threading.Thread(target=session, args=(0,))
        first.start()
        while (gp.prefix_cache.indexed_blocks() < KNOB_SYSTEM // block_size
               and first.is_alive()):
            time.sleep(0.002)
        rest = [threading.Thread(target=session, args=(i,))
                for i in range(1, KNOB_SESSIONS)]
        for t in rest:
            t.start()
        for t in [first] + rest:
            t.join(timeout=900)
        traffic_wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in [first] + rest):
            raise AssertionError(f"chat sessions failed: {errors}")
        ttft = {}
        probe = rng.integers(0, V, 600).astype(np.int64)
        for form in ("cold", "prefix_hit"):
            hit0 = gp.metrics.get("prefix_hit_tokens")
            t1 = time.perf_counter()
            it = gp.infer_stream(probe, timeout=600, max_new_tokens=16)
            chunks = [next(it)]
            ttft[form] = dict(seconds=time.perf_counter() - t1,
                              hit_tokens=gp.metrics.get("prefix_hit_tokens")
                              - hit0)
            chunks += list(it)
            ttft[form]["tokens"] = int(sum(len(c) for c in chunks))
        sse_prompt = rng.integers(0, V, 24).astype(np.int64)
        status, hdrs, body = _http(srv.port, "/generate", _npz(sse_prompt),
                                   {"X-Stream": "sse"})
        events = []
        for block in body.decode().split("\n\n"):
            if block.strip():
                fields = dict(ln.split(": ", 1) for ln in block.split("\n"))
                events.append((fields["event"], json.loads(fields["data"])))
        sse_tokens = [tok for ev, d in events if ev == "tokens"
                      for tok in d["tokens"]]
        b_status, _, b_body = _http(srv.port, "/generate", _npz(sse_prompt))
        buffered = np.load(io.BytesIO(b_body))["out0"]
        s_status, _, s_body = _http(
            srv.port, "/generate", _npz(sse_prompt),
            {"X-Temperature": "0.8", "X-Top-K": "40", "X-Spec": "off"})
        sampled_http = np.load(io.BytesIO(s_body))["out0"]
        p_status, p_hdrs, prom = _http(srv.port, "/metrics?format=prom")
        prom = prom.decode()
    finally:
        watching.set()
        srv.stop(drain_timeout=60)                  # drains, closes gp
    launches = pa.paged_decode_attention.launches   # main path ends here
    conservation = kv.check_conservation()
    snap = gp.metrics.snapshot()
    counts = {kind: gp._spec_counter.labels("continuous", kind).value
              for kind in ("drafted", "accepted", "wasted")}
    recompiles = sum(c.value for _, c in
                     gp._recompile_counter.children())
    after_keys = {k: r.captures for k, r in model._runner_cache().items()
                  if ("pool", kv.uid) in k}
    generated = sum(len(out) - len(p) for sess in records
                    for p, out in sess)
    forwards = (snap.get("prefill_ticks", 0) + snap.get("verify_ticks", 0)
                + decode_steps * snap.get("decode_ticks", 0))
    bad_lines = [ln for ln in prom.splitlines()
                 if not (ln.startswith("# ") or PROM_SAMPLE.match(ln))]
    missing_fams = [f for f in PROM_FAMILIES if f"# TYPE {f} " not in prom]

    # the plain scheduler on the greedy requests' prompts
    greedy = [(i, t) for i in range(KNOB_SESSIONS) for t in range(KNOB_TURNS)
              if not plan[i][t]["sampled"]]
    plain_kv = pool()
    plain = ContinuousGenerateBatchingPredictor(model, kv_cache=plain_kv,
                                                **base)
    plain_out, plain_err = {}, {}

    def plain_client(i, t):
        try:
            plain_out[(i, t)] = plain.infer(
                records[i][t][0], timeout=600,
                max_new_tokens=plan[i][t]["new"])
        except Exception as e:      # reported below, fails the phase
            plain_err[(i, t)] = repr(e)

    try:
        ts = [threading.Thread(target=plain_client, args=it)
              for it in greedy]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=900)
    finally:
        plain.close()
    if plain_err or len(plain_out) != len(greedy):
        raise AssertionError(f"plain scheduler failed: {plain_err}")
    compared, first_ties, agree = {"prefix_hit": 0, "cold": 0}, [], True
    greedy_hits = []
    for i, t in greedy:
        prompt, out = records[i][t]
        ref = plain_out[(i, t)]
        c = first_tie(torch, model, ref, len(prompt), device)
        first_ties.append(c)
        greedy_hits.append(hits.get(prompt.tobytes(), 0))
        compared["prefix_hit" if greedy_hits[-1] > 0 else "cold"] += c
        agree &= bool(np.array_equal(out[:len(prompt) + c],
                                     ref[:len(prompt) + c]))
    rows = prefix_rows_check(torch, model, kv, gp.prefix_cache,
                             [sess[-1][1] for sess in records], device,
                             chunk=chunk, swap=KNOB_SYSTEM // block_size)
    rec = dict(
        config=dict(slots=slots, chunk=chunk, decode_steps=decode_steps,
                    block_size=block_size, max_seq_len=max_seq_len,
                    spec_k=spec_k, drafter="ngram", prefix_cache=True,
                    admit_policy="shortest_prompt_first", warmup=True),
        requests=KNOB_SESSIONS * KNOB_TURNS, greedy_requests=len(greedy),
        http_requests=3, readyz=readyz[:3] + readyz[-1:],
        readyz_polls=len(readyz), warm_wall_s=warm_wall, warm_stats=dict(
            stats or {}, missing=[str(k) for k in (stats or {}).get(
                "missing", ["no stats"])]),
        warm_errors=[repr(e) for e in gp.warm_errors()],
        traffic_wall_s=traffic_wall, generated_tokens=generated,
        tok_per_s=generated / traffic_wall,
        prefill_tokens_saved=snap.get("prefix_hit_tokens", 0),
        prefill_ticks=snap.get("prefill_ticks", 0),
        verify_ticks=snap.get("verify_ticks", 0),
        decode_ticks=snap.get("decode_ticks", 0),
        spec_tokens=counts, acceptance_rate=gp._acceptance_rate(),
        shared_blocks_max=shared_max[0], conservation=conservation,
        ttft=ttft, sse_events=len(events), sse_status=status,
        sse_equals_buffered=bool(
            b_status == 200 and status == 200 and events
            and events[-1][0] == "done"
            and np.array_equal(np.asarray(sse_tokens, np.int64),
                               buffered[len(sse_prompt):])),
        sampled_http=dict(status=s_status, shape=list(sampled_http.shape)),
        prometheus=dict(status=p_status, lines=len(prom.splitlines()),
                        bad_lines=bad_lines[:5],
                        missing_families=missing_fams),
        recompiles=recompiles, runner_keys=len(pool_keys),
        captures_after_warm=sum(after_keys.values())
        - sum(pool_keys.values()),
        kernel_launches=launches, expected_launches=L * forwards,
        compared_tokens=compared, first_ties=first_ties,
        greedy_prefix_hits=greedy_hits, greedy_equal_plain=agree,
        prefix_rows=rows)
    print("serve-knobs", json.dumps(rec), flush=True)
    checks = {
        "greedy tokens equal the plain scheduler's": agree,
        "greedy tokens compared among prefix hits":
            compared["prefix_hit"] > 0,
        "indexed rows equal a cold prefill, the swapped page fails": (
            min(rows["blocks"]) > KNOB_SYSTEM // block_size
            and max(rows["rel"]) <= INSITU_REL_TOL
            and rows["control"] is not None
            and rows["control"] > INSITU_REL_TOL),
        "SSE equals the buffered answer": rec["sse_equals_buffered"],
        "sampled HTTP request": (s_status == 200 and sampled_http.shape
                                 == (len(sse_prompt) + 64,)
                                 and 0 <= sampled_http.min()
                                 and sampled_http.max() < V),
        "pool conserved and drained": (conservation["requests"] == 0
                                       and kv.blocks_in_use
                                       == gp.prefix_cache.cached_blocks()),
        "blocks shared during the run": shared_max[0] > 0,
        "prefix hits skipped prompt tokens":
            rec["prefill_tokens_saved"] > 0
            and ttft["prefix_hit"]["hit_tokens"] > 0,
        "spec counters": (counts["wasted"] == counts["drafted"]
                          - counts["accepted"] and counts["drafted"] > 0
                          and counts["drafted"] == gp._spec_drafted
                          and rec["verify_ticks"] > 0),
        "readyz 503 then 200": (readyz[0] == 503 and readyz[-1] == 200),
        "warmup complete, no capture after": (
            stats is not None and stats["missing"] == []
            and stats["programs"] == 3 and len(pool_keys) == 3
            and recompiles == 0 and after_keys == pool_keys),
        "prometheus text": (p_status == 200 and not bad_lines
                            and not missing_fams),
        "paged launches = layers x forwards": (launches == L * forwards
                                               and launches > 0),
        "every request served": all(r is not None for sess in records
                                    for r in sess),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve_knobs: {failed}: {rec}")
    return rec


# ---------------------------------------------------------------- phase 7c
PROD = dict(slots=8, chunk=64, decode_steps=4, block_size=32,
            max_seq_len=512, new=48, adapters=4, rank=8, alpha=16.0,
            requests=16, free=8, spec_k=4, rate_requests=64,
            turns=("base", "lora", "monitored", "monitored", "lora", "base",
                   "base", "lora", "monitored"))
F32_TIE_REL = 1e-4      # f32 near-tie: the LoRA and merged products differ
                        # by f32 rounding (~1e-6 relative), far below this


def lora_factors(reg, seed, rank, scale=0.05):
    """Seeded (A [in, r], B [r, out]) numpy factors for every target."""
    rng = np.random.default_rng(seed)
    return {p: (rng.standard_normal((reg.dims(p)[0], rank))
                .astype(np.float32) * scale,
                rng.standard_normal((rank, reg.dims(p)[1]))
                .astype(np.float32) * scale)
            for p in reg.target_paths()}


def _storm_infer(pred, jobs, timeout=600):
    """[(prompt, kwargs)] served concurrently -> (outputs, wall seconds);
    a failed request raises."""
    outs, errs = [None] * len(jobs), {}

    def client(i):
        try:
            outs[i] = np.asarray(pred.infer(jobs[i][0], timeout=timeout,
                                            **jobs[i][1]))
        except Exception as e:      # reported below, fails the phase
            errs[i] = repr(e)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(i,))
          for i in range(len(jobs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    wall = time.perf_counter() - t0
    if errs or any(o is None for o in outs):
        raise AssertionError(f"requests failed: {errs}")
    return outs, wall


def rate_ratio(rates, num, den):
    """Median tokens/s of form ``num`` over form ``den``, with the wider of
    the two forms' spreads between turns ((max - min) / median); the ratio
    is resolved only where its gap from 1 is wider than that spread."""
    med = {f: float(np.median(rates[f])) for f in (num, den)}
    spread = max((max(rates[f]) - min(rates[f])) / med[f]
                 for f in (num, den))
    ratio = med[num] / med[den]
    return dict(ratio=ratio, spread=spread,
                resolved=bool(abs(1.0 - ratio) > spread))


def _wait_until(cond, limit=600.0):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > limit:
            raise AssertionError("condition never held")
        time.sleep(0.002)


def _f32_first_tie(torch, model, seq, plen, device):
    """Generated positions of ``seq`` before the first f32 near-tie of a
    cache-free forward over it (all of them when there is none)."""
    with torch.no_grad():
        lg = model(torch.as_tensor(seq[None], device=device)).float()[
            0, plen - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    scale = lg.abs().amax(dim=-1).cpu().numpy()
    ties = np.nonzero(gap < F32_TIE_REL * scale)[0]
    return int(ties[0]) if len(ties) else len(seq) - plen


def serve_production(torch, model, device, p=None):
    """Serving beyond the main path: GPT-350M bf16 behind a continuous
    scheduler with an ``AdapterRegistry`` (max 8 adapters of rank <= 8 over
    qkv_proj and gate_up, four seeded adapters), a ``TenantLedger`` (gold:
    weight 3, priority 0; free: priority 2; metered: 1 token/s for the
    429), an ``SLOMonitor``, a ``FlightRecorder``, a ``UtilizationLedger``
    and a ``Tracer``, behind ``InferenceServer``; 8 slots, chunk 64, block
    32, warmup. Gates, every one failing the run:
    (a) base requests are bit-identical to a scheduler without a registry;
    (b) each adapter's greedy tokens equal, in f32, those of a scheduler
        without a registry over the model with merged weights W + (alpha /
        r) A B, up to the first f32 near-tie: through a LoRA scheduler, a
        speculative LoRA scheduler (verify_step with the bank) and LoRA
        generate_paged (one capture, replayed for every adapter), their
        paged launches counted;
    (c) mixed adapter / base / sampled traffic, with a load and an unload
        while requests run, captures nothing after the warmup;
    (d) a gold request arriving while 8 free sequences run pauses one, and
        every free sequence's tokens equal its unpaused run, bit for bit;
    (e) every tick conserves its integer FLOPs, and the MFU gauge reads
        off the card's 989e12 bf16 peak;
    (f) /slo, /debug/ticks, /utilization and /debug/profile answer over
        HTTP, with the X-Adapter / X-Tenant 400 and 429 taxonomy;
    (g) an injected batcher.tick ThreadDeath is restarted by the
        Supervisor and serving goes on; a lora.load fault leaves the
        registry and its bank as they were;
    (h) a two-replica ReplicaFleet over the model answers requests, each
        replica with one capture set over its own pool.
    Recorded: tokens/s with adapters against the same traffic without,
    monitors on against off (three rounds of ``rate_requests`` requests
    a form, each form's spread between turns beside its median, and a
    ratio called unresolved where that spread is wider than its gap), row
    1's launches per forward, captures per replica, what the replicas'
    captures added to the model's one graph pool, the bank's bytes."""
    from paddle_tpu_torch.inference import (
        AdapterRegistry,
        ContinuousGenerateBatchingPredictor,
        FaultInjector,
        InferenceServer,
        PagedKVCache,
        ReplicaFleet,
        ThreadDeath,
    )
    from paddle_tpu_torch.inference.qos import TenantLedger
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.observability import (
        SLOMonitor,
        Tracer,
        UtilizationLedger,
        device_peak_flops,
    )
    from paddle_tpu_torch.ops import paged_attention as pa

    p = dict(PROD, **(p or {}))
    t_phase = time.perf_counter()
    S, C, T, new = p["slots"], p["chunk"], p["decode_steps"], p["new"]
    spec = model._decode_cache_spec()
    L = spec[0]
    V = model.config.vocab_size
    rng = np.random.default_rng(53)
    targets = ("qkv_proj", "gate_up")

    def pool(m=model, dtype=torch.bfloat16):
        return PagedKVCache(*m._decode_cache_spec(),
                            block_size=p["block_size"],
                            num_blocks=S * p["max_seq_len"]
                            // p["block_size"], dtype=dtype, device=device)

    base = dict(max_slots=S, prefill_chunk=C, decode_steps=T,
                max_new_tokens=new, max_seq_len=p["max_seq_len"],
                device=device)

    def prompts(n, lo=32, hi=200):
        return [rng.integers(0, V, int(rng.integers(lo, hi + 1)))
                .astype(np.int64) for _ in range(n)]

    faults = FaultInjector()
    reg = AdapterRegistry(model, max_adapters=8, max_rank=8,
                          targets=targets, faults=faults)
    names = [f"ad{i}" for i in range(p["adapters"])]
    factors = {n: lora_factors(reg, 100 + i, p["rank"])
               for i, n in enumerate(names)}
    for n in names:
        reg.register(n, factors[n], alpha=p["alpha"])
    led = TenantLedger()
    led.register("gold", weight=3.0, priority=0)
    led.register("free", weight=1.0, priority=2)
    led.register("metered", rate=1.0, burst=64.0)
    mon = SLOMonitor({"ttft_p95_ms": 60000.0, "tpot_p99_ms": 60000.0,
                      "availability": 0.99})
    util = UtilizationLedger(device=device)
    tracer = Tracer()
    kv = pool()
    gp = ContinuousGenerateBatchingPredictor(
        model, kv_cache=kv, adapters=reg, qos=led, slo=mon,
        flight_recorder=True, utilization=util, tracer=tracer,
        faults=faults, warmup=True, **base)
    ticks = []
    tick_end = util.tick_end

    def counted_tick_end():         # every tick's split, for gate (e)
        t = tick_end()
        if t is not None:
            ticks.append(t)
        return t

    util.tick_end = counted_tick_end
    plain = ContinuousGenerateBatchingPredictor(
        model, kv_cache=pool(), warmup=True,
        tracer=Tracer(enabled=False), **base)
    quiet = ContinuousGenerateBatchingPredictor(
        model, kv_cache=pool(), adapters=reg, warmup=True,
        tracer=Tracer(enabled=False), **base)
    srv = None
    try:
        _wait_until(lambda: gp.ready() and plain.ready() and quiet.ready())
        warm = {k: r.captures for k, r in model._runner_cache().items()
                if ("pool", kv.uid) in k}

        # (a) + the main path: base traffic, then mixed traffic with a
        # load and an unload in flight, then the preemption round
        base_prompts = prompts(p["free"])
        pa.paged_decode_attention.launches = 0      # main path starts here
        snap0 = gp.metrics.snapshot()
        base_lora = [np.asarray(gp.infer(q, timeout=600))
                     for q in base_prompts]
        # the mixed traffic routes ad0-ad2 and base; meanwhile ad_late is
        # loaded and the idle ad3 unloaded
        live = names[:-1]
        mixed = [(q, (dict(adapter=live[i % len(live)]) if i % 5 else {})
                  | (dict(temperature=0.8, top_k=40) if i % 4 == 3 else {})
                  | dict(tenant="free" if i % 2 else "gold"))
                 for i, q in enumerate(prompts(p["requests"]))]
        churn = {}

        def churn_bank():       # load and unload while requests run
            _wait_until(lambda: gp._phase_count(None) > 0)
            reg.register("ad_late", lora_factors(reg, 99, p["rank"]),
                         alpha=p["alpha"])
            churn["unloaded"] = reg.unregister(names[-1])
            churn["live_at_unload"] = gp._phase_count(None)

        ct = threading.Thread(target=churn_bank)
        ct.start()
        mixed_outs, mixed_wall = _storm_infer(gp, mixed)
        ct.join(timeout=600)
        reg.unregister("ad_late")
        reg.register(names[-1], factors[names[-1]], alpha=p["alpha"])
        # 8 free sequences, then the same 8 with a gold request arriving
        # once they hold every slot: it pauses one of them
        free_jobs = [(q, dict(tenant="free"))
                     for q in prompts(p["free"], 64, 96)]
        gold_job = (prompts(1)[0], dict(tenant="gold"))
        ref_free, _ = _storm_infer(gp, free_jobs)
        ref_gold = np.asarray(gp.infer(gold_job[0], timeout=600,
                                       **gold_job[1]))
        pre0 = gp.metrics.get("preempted_seqs")
        res0 = gp.metrics.get("resumed_seqs")
        box = {}
        ft = threading.Thread(target=lambda: box.update(
            free=_storm_infer(gp, free_jobs)[0]))
        ft.start()
        _wait_until(lambda: sum(s is not None for s in gp._slots) == S)
        got_gold = np.asarray(gp.infer(gold_job[0], timeout=600,
                                       **gold_job[1]))
        ft.join(timeout=600)
        launches = pa.paged_decode_attention.launches   # main path ends
        snap1 = gp.metrics.snapshot()

        def ticked(kind):
            return snap1.get(kind, 0) - snap0.get(kind, 0)
        forwards = ticked("prefill_ticks") + T * ticked("decode_ticks")
        paused = gp.metrics.get("preempted_seqs") - pre0
        resumed = gp.metrics.get("resumed_seqs") - res0
        after = {k: r.captures for k, r in model._runner_cache().items()
                 if ("pool", kv.uid) in k}
        recompiles = sum(c.value for _, c in
                         gp._recompile_counter.children())
        base_plain = [np.asarray(plain.infer(q, timeout=600))
                      for q in base_prompts]

        # rates: base / lora / monitored, in turns
        rate_jobs = [(q, {}) for q in prompts(p["rate_requests"])]
        lora_jobs = [(q, dict(adapter=names[i % len(names)]))
                     for i, (q, _) in enumerate(rate_jobs)]
        rates = {"base": [], "lora": [], "monitored": []}
        for form in p["turns"]:
            pred, jobs = {"base": (plain, rate_jobs),
                          "lora": (quiet, lora_jobs),
                          "monitored": (gp, lora_jobs)}[form]
            outs, wall = _storm_infer(pred, jobs)
            rates[form].append(sum(len(o) - len(q) for o, (q, _) in
                                   zip(outs, jobs)) / wall)

        # (e) the conservation of every tick so far, and the MFU gauge
        conserved = bool(ticks) and all(
            t["issued"] == t["useful"] + t["pad"] + t["spec_waste"]
            and sum(t["tenants"].values()) == t["useful"] for t in ticks)
        usnap = util.snapshot()

        # (f) HTTP
        srv = InferenceServer(gp, device=device, default_timeout=600).start()
        http = {}
        q = prompts(1)[0]
        for name, path, body, hdrs in (
                ("generate_adapter", "/generate", q, {"X-Adapter": "ad0",
                                                      "X-Tenant": "gold"}),
                ("unknown_adapter", "/generate", q, {"X-Adapter": "nope"}),
                ("empty_tenant", "/generate", q, {"X-Tenant": " "}),
                ("unknown_tenant", "/generate", q, {"X-Tenant": "nope"}),
                ("metered", "/generate", q, {"X-Tenant": "metered"}),
                ("slo", "/slo", None, None),
                ("ticks", "/debug/ticks?last=4", None, None),
                ("utilization", "/utilization", None, None),
                ("profile", "/debug/profile?ms=200", None, None),
                ("prom", "/metrics?format=prom", None, None)):
            status, h, raw = _http(srv.port, path,
                                   None if body is None else _npz(body),
                                   hdrs)
            http[name] = dict(status=status, retry_after=h.get(
                "Retry-After"), body=raw)
        prom = http["prom"]["body"].decode()
        mfu_line = next((ln for ln in prom.splitlines()
                         if ln.startswith("paddle_serving_mfu{")), None)

        # (g) faults
        restarts0 = gp._sup.restarts
        faults.install("batcher.tick", error=ThreadDeath(), times=1)
        _wait_until(lambda: faults.fired("batcher.tick") == 1)
        healed = np.asarray(gp.infer(q, timeout=600))
        restarts = gp._sup.restarts - restarts0
        before = ({n: reg.acquire(n) for n in reg.names()}, reg.stats(),
                  {k: float(t.double().abs().sum()) for k, t in
                   reg.bank()["b"].items()})
        for n in before[0]:
            reg.release(before[0][n][0])
        faults.install("lora.load", error=IOError("torn artifact"), times=1)
        try:
            reg.register("torn", factors[names[0]])
            torn = "registered"
        except IOError:
            torn = "refused"
        after_fault = ({n: reg.acquire(n) for n in reg.names()},
                       reg.stats(),
                       {k: float(t.double().abs().sum()) for k, t in
                        reg.bank()["b"].items()})
        for n in after_fault[0]:
            reg.release(after_fault[0][n][0])
    finally:
        if srv is not None:
            srv.stop(drain_timeout=60)
        for pr in (gp, plain, quiet):
            pr.close()
    served_rows = {"tokens": int(sum(len(o) - len(q) for o, (q, _) in
                                     zip(mixed_outs, mixed)))}

    # (b) f32: LoRA against merged weights, each adapter
    m32 = GPTForCausalLM(model.config, device=device, dtype=torch.float32,
                         seed=0)
    reg32 = AdapterRegistry(m32, max_adapters=8, max_rank=8,
                            targets=targets)
    rows32 = {n: reg32.register(n, factors[n], alpha=p["alpha"])
              for n in names}
    g32 = ContinuousGenerateBatchingPredictor(
        m32, kv_cache=pool(m32, torch.float32), adapters=reg32,
        tracer=Tracer(enabled=False), **base)
    kv_spec = pool(m32, torch.float32)
    g32s = ContinuousGenerateBatchingPredictor(
        m32, kv_cache=kv_spec, adapters=reg32, spec_k=p["spec_k"],
        tracer=Tracer(enabled=False), **base)
    merged = GPTForCausalLM(model.config, device=device,
                            dtype=torch.float32, seed=0)
    mods = dict(torch.nn.Module.named_modules(merged._decode_layer()))
    orig = {path: mods[path].weight.detach().clone()
            for path in reg32.target_paths()}
    gm = ContinuousGenerateBatchingPredictor(
        merged, kv_cache=pool(merged, torch.float32),
        tracer=Tracer(enabled=False), **base)
    # generate_paged, LoRA and merged: prompts right-padded to the
    # prompts' longest (one key, so every adapter replays one capture)
    B_pg, P_pg = 2, 200
    kv_pg, kv_pm = pool(m32, torch.float32), pool(merged, torch.float32)
    tab_pg = np.stack([kv_pg.reserve(("pg", b), P_pg + new)
                       for b in range(B_pg)])
    tab_pm = np.stack([kv_pm.reserve(("pg", b), P_pg + new)
                       for b in range(B_pg)])
    b_rec = {}
    spec_launches = spec_forwards = pg_launches = pg_calls = 0
    try:
        for n in names:
            with torch.no_grad():
                for path, (a, b) in factors[n].items():
                    mods[path].weight.copy_(orig[path] + torch.as_tensor(
                        a @ b * (p["alpha"] / p["rank"]), device=device))
            qs = prompts(2)
            lora_outs, _ = _storm_infer(g32, [(q, dict(adapter=n))
                                              for q in qs])
            merged_outs, _ = _storm_infer(gm, [(q, {}) for q in qs])
            s0 = g32s.metrics.snapshot()
            pa.paged_decode_attention.launches = 0
            spec_outs, _ = _storm_infer(g32s, [(q, dict(adapter=n))
                                               for q in qs])
            spec_launches += pa.paged_decode_attention.launches
            s1 = g32s.metrics.snapshot()
            spec_forwards += sum(s1.get(k, 0) - s0.get(k, 0) for k in
                                 ("prefill_ticks", "verify_ticks"))
            ids = np.zeros((B_pg, P_pg), np.int64)
            for b, qb in enumerate(qs):
                ids[b, :len(qb)] = qb
            plens = np.array([len(qb) for qb in qs])
            pa.paged_decode_attention.launches = 0
            pg_lora = m32.generate_paged(
                ids, plens, kv_pg, tab_pg, max_new_tokens=new,
                adapters=reg32, adapter_slots=[rows32[n]] * B_pg)
            pg_launches += pa.paged_decode_attention.launches
            pg_calls += 1
            pg_merged = merged.generate_paged(ids, plens, kv_pm, tab_pm,
                                              max_new_tokens=new)
            cmp, cmp_pg, eq, eq_spec, eq_pg = 0, 0, True, True, True
            for b, (qb, lo, mo, so) in enumerate(zip(qs, lora_outs,
                                                     merged_outs,
                                                     spec_outs)):
                c = _f32_first_tie(torch, merged, mo, len(qb), device)
                cmp += c
                eq &= bool(np.array_equal(lo[:len(qb) + c],
                                          mo[:len(qb) + c]))
                eq_spec &= bool(np.array_equal(so[:len(qb) + c],
                                               mo[:len(qb) + c]))
                # generate_paged's own reference: the merged model's
                # generate_paged, up to its first near-tie
                seq = np.concatenate([qb, pg_merged[b]])
                cp = _f32_first_tie(torch, merged, seq, len(qb), device)
                cmp_pg += cp
                eq_pg &= bool(np.array_equal(pg_lora[b, :cp],
                                             pg_merged[b, :cp]))
            b_rec[n] = dict(equal=eq, compared_tokens=cmp,
                            generated=2 * new, speculative_equal=eq_spec,
                            generate_paged_equal=eq_pg,
                            generate_paged_compared=cmp_pg)
        spec_keys = [k for k in m32._runner_cache()
                     if ("pool", kv_spec.uid) in k]
        pg_run = [r for k, r in m32._runner_cache().items()
                  if k[0] == "paged" and ("pool", kv_pg.uid) in k]
        lora_paths = dict(
            speculative=dict(
                launches=spec_launches, forwards=spec_forwards,
                programs=sorted(k[0] for k in spec_keys),
                lora_verify=any(k[0] == "verify_step"
                                and k[-1] == ("bank", reg32.uid)
                                for k in spec_keys),
                verify_ticks=g32s.metrics.get("verify_ticks"),
                accepted=g32s._spec_accepted, drafted=g32s._spec_drafted),
            generate_paged=dict(
                calls=pg_calls, launches=pg_launches,
                captures=[r.captures for r in pg_run],
                replays=[r.replays for r in pg_run]))
    finally:
        for b in range(B_pg):
            kv_pg.release(("pg", b))
            kv_pm.release(("pg", b))
        g32.close()
        g32s.close()
        gm.close()
        reg32.close()
    del m32, merged
    torch.cuda.empty_cache()

    # (h) a two-replica fleet over the one model
    fleet_rec = {}
    gp0, al0 = graph_pool_bytes(torch, model), torch.cuda.memory_allocated()
    fleet = ReplicaFleet.build(model, n_replicas=1, warmup=True,
                               tracer=Tracer(enabled=False), **base)
    try:
        r0 = fleet._by_name("r0").predictor
        _wait_until(r0.ready)
        gp1, al1 = (graph_pool_bytes(torch, model),
                    torch.cuda.memory_allocated())
        fleet.add_replica(warmup=True)
        r1 = fleet._by_name("r1").predictor
        _wait_until(r1.ready)
        gp2, al2 = (graph_pool_bytes(torch, model),
                    torch.cuda.memory_allocated())

        def caps(pr):
            return {k: r.captures for k, r in model._runner_cache().items()
                    if ("pool", pr.kv_cache.uid) in k}
        warm_caps = [caps(r0), caps(r1)]
        fleet_outs, fleet_wall = _storm_infer(
            fleet, [(q, {}) for q in prompts(p["requests"])])
        fleet_rec = dict(
            replicas=fleet.replica_states(),
            captures_per_replica=[sum(c.values()) for c in warm_caps],
            keys_per_replica=[len(c) for c in warm_caps],
            captures_after=[sum(caps(r).values()) for r in (r0, r1)],
            # the replicas' captures all allocate from the model's one
            # graph pool, which reuses the segments that the closed
            # schedulers' captures freed: what each replica's warmup added
            # to that shared pool, and the pool's total after both. Each
            # replica's own memory is its allocation growth: its KV pool
            # (kv_pool_bytes) and its runners' buffers
            shared_graph_pool_growth_bytes=[
                None if gp1 is None or gp0 is None else gp1 - gp0,
                None if gp2 is None or gp1 is None else gp2 - gp1],
            shared_graph_pool_total_bytes=gp2,
            allocated_bytes=[al1 - al0, al2 - al1],
            kv_pool_bytes=[sum(t.numel() * t.element_size()
                               for t in (*r.kv_cache.k_pages,
                                         *r.kv_cache.v_pages))
                           for r in (r0, r1)],
            served=sum(1 for o in fleet_outs if o is not None),
            dispatch={rep.name: rep.predictor.metrics.get("completed")
                      for rep in fleet._snapshot()},
            wall_s=fleet_wall)
    finally:
        fleet.close()
    reg.close()

    peak = device_peak_flops(device)
    rec = dict(
        config=dict(p, targets=list(targets), bank_bytes=reg.bank_bytes(),
                    tenants=led.tenant_names()),
        base_bit_identical=all(np.array_equal(a, b) for a, b in
                               zip(base_lora, base_plain)),
        adapters_vs_merged_f32=b_rec,
        mixed=dict(requests=len(mixed), wall_s=mixed_wall,
                   unloaded_row=churn.get("unloaded"),
                   live_at_unload=churn.get("live_at_unload"),
                   **served_rows),
        captures_after_warm=sum(after.values()) - sum(warm.values()),
        warm_keys=len(warm), recompiles=recompiles,
        preemption=dict(paused=paused, resumed=resumed, free_equal=bool(all(
                np.array_equal(a, b) for a, b in zip(box["free"],
                                                     ref_free))),
            gold_equal=bool(np.array_equal(got_gold, ref_gold))),
        utilization=dict(ticks=len(ticks), conserved=conserved,
                         peak_flops=util.peak_flops,
                         card_peak_flops=peak, mfu=usnap["mfu"],
                         mfu_line=mfu_line, flops=usnap["flops"],
                         useful_ratio=usnap.get("useful_ratio"),
                         host_gap_p50_s=usnap.get("host_gap_p50_s")),
        http={k: dict(status=v["status"], retry_after=v["retry_after"])
              for k, v in http.items()},
        faults=dict(restarts=restarts, healed_tokens=len(healed) - len(q),
                    lora_load=torn, registry_intact=(
                        before[0] == after_fault[0]
                        and before[1] == after_fault[1]
                        and before[2] == after_fault[2])),
        fleet=fleet_rec,
        kernel_launches=launches, forwards=forwards,
        launches_per_forward=launches / forwards if forwards else None,
        rates_tok_per_s=rates,
        rate_turns=dict(requests=len(rate_jobs), new_tokens=new,
                        turns=list(p["turns"])),
        adapters_over_base=rate_ratio(rates, "lora", "base"),
        monitored_over_quiet=rate_ratio(rates, "monitored", "lora"),
        lora_paths=lora_paths,
        wall_s=time.perf_counter() - t_phase)
    print("serve-production", json.dumps(rec, default=str), flush=True)
    checks = {
        "(a) base traffic bit-identical to no registry":
            rec["base_bit_identical"],
        "(b) adapters equal merged weights in f32": all(
            r["equal"] and r["compared_tokens"] > 0
            for r in b_rec.values()) and len(b_rec) == len(names),
        "(b) speculative LoRA (verify_step with the bank) equals merged": (
            all(r["speculative_equal"] for r in b_rec.values())
            and lora_paths["speculative"]["lora_verify"]
            and lora_paths["speculative"]["verify_ticks"] > 0
            and lora_paths["speculative"]["launches"]
            == L * lora_paths["speculative"]["forwards"] > 0),
        "(b) LoRA generate_paged equals merged, one capture replayed": (
            all(r["generate_paged_equal"] and r["generate_paged_compared"]
                > 0 for r in b_rec.values())
            and lora_paths["generate_paged"]["launches"]
            == L * new * pg_calls > 0
            and lora_paths["generate_paged"]["captures"]
            == [0 if str(device) == "cpu" else 1]),
        "(c) no capture after warmup under mixed traffic and churn": (
            rec["captures_after_warm"] == 0 and recompiles == 0
            and len(warm) == 2 and churn.get("unloaded") is not None
            and churn.get("live_at_unload", 0) > 0),
        "(d) a gold arrival pauses a free sequence, tokens unchanged": (
            paused >= 1 and rec["preemption"]["resumed"] >= 1
            and rec["preemption"]["free_equal"]
            and rec["preemption"]["gold_equal"]),
        "(e) utilization conserved, MFU off the card's peak": (
            conserved and peak is not None
            and util.peak_flops == peak == PEAK_FLOPS["bfloat16"]
            and mfu_line is not None),
        "(f) HTTP routes and the 400 / 429 taxonomy": (
            http["generate_adapter"]["status"] == 200
            and http["unknown_adapter"]["status"] == 400
            and http["empty_tenant"]["status"] == 400
            and http["unknown_tenant"]["status"] == 400
            and http["metered"]["status"] == 429
            and int(http["metered"]["retry_after"]) >= 1
            and all(http[k]["status"] == 200 for k in
                    ("slo", "ticks", "utilization", "profile", "prom"))),
        "(g) thread death healed, a torn load leaves the registry": (
            restarts >= 1 and len(healed) > len(q) and torn == "refused"
            and rec["faults"]["registry_intact"]),
        "(h) two replicas, one capture set each": (
            fleet_rec.get("served") == p["requests"]
            and all(v == "ready" for v in fleet_rec["replicas"].values())
            and fleet_rec["keys_per_replica"] == [2, 2]
            and fleet_rec["captures_after"]
            == fleet_rec["captures_per_replica"]
            and all(v > 0 for v in fleet_rec["dispatch"].values())),
        "paged launches = layers x forwards": (launches == L * forwards
                                               and launches > 0),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve_production: {failed}: {rec}")
    return rec


# --------------------------------------------------------------- phase 10
GEN_B, GEN_P, GEN_NEW = 8, 512, 128         # generate() at full width


def dense_insitu(torch, model, device, B=None, P=None, new=None, mod=None,
                 layers=None):
    """Three forwards of the full model over dense bf16 caches of T = P +
    new (640 by default): the prompt's prefill ([B, P] = [8, 512] at length
    0, the main path's), its second half prefilled again ([8, 256] at
    length 256: four 64-row tiles, each with its own causal limit, at a
    length a fault can shorten) and one decode forward (length 512). On the
    kernel path every layer's kernel call (or those of ``layers``) is held
    to the plain version on the same inputs (``kernel_tolerance``), each
    forward's worst reading kept apart, and the logits to the plain
    attention path's (a coarse bound). A control runs the kernel with the
    length one short: it must fail the per-layer check at the second
    prefill and at the decode, each on its own (at length 0 it clamps to
    no change). ``mod``: the model's module, whose ``decode_attention``
    the check rebinds (GPT's by default)."""
    from paddle_tpu_torch.models import gpt as gpt_mod
    from paddle_tpu_torch.models.steps import DenseStep
    from paddle_tpu_torch.ops import decode_attention as da

    B, P, new = B or GEN_B, P or GEN_P, new or GEN_NEW
    mod = mod or gpt_mod
    rng = np.random.default_rng(22)
    V = model.config.vocab_size
    ids = torch.as_tensor(rng.integers(0, V, (B, P + 1)), device=device)
    L, Hkv, D = model._decode_cache_spec()
    state = model._decode_state(torch.bfloat16)
    kernel = mod.decode_attention
    half = P // 2
    forwards = (("prefill_at_0", 0, P),
                (f"prefill_at_{half}", half, P),
                (f"decode_at_{P}", P, P + 1))
    faultable = [name for name, lo, _ in forwards if lo > 0]

    def run(path, fault=False):
        over, current, calls = {}, [None], [0]

        def checked(q, k, v, length, scale=None):
            layer = calls[0] % L
            calls[0] += 1
            got = kernel(q, k, v, max(length - 1, 0) if fault else length,
                         scale=scale)
            if layers is None or layer in layers:
                args = (q, k, v, length)
                ref = da.decode_attention_ref(*args, scale=scale)
                r = held_to_plain(torch, da, args, got, ref, scale)[1]
                over[current[0]] = max(over.get(current[0], 0.0), r)
            return got

        shape = (B, Hkv, P + new, D)
        kc = [torch.zeros(shape, dtype=torch.bfloat16, device=device)
              for _ in range(L)]
        vc = [torch.zeros(shape, dtype=torch.bfloat16, device=device)
              for _ in range(L)]
        rows = []
        mod.decode_attention = checked
        try:
            with torch.no_grad():
                for name, lo, hi in forwards:
                    current[0] = name
                    rows.append(model._decode_call(
                        state, ids[:, lo:hi], kc, vc, DenseStep(lo),
                        path)[:, -1])
        finally:
            mod.decode_attention = kernel
        logits = torch.stack(rows).float()
        if not torch.isfinite(logits).all():
            raise AssertionError(f"non-finite logits on the {path} path")
        return logits, over

    plain, _ = run("plain")
    scale = float(plain.abs().max())
    rec = dict(max_abs_logit=scale, rel_tol=INSITU_REL_TOL, B=B, P=P,
               layers="all" if layers is None else list(layers))
    for name, fault in (("kernel", False), ("fault", True)):
        logits, over = run("kernel", fault)
        diff = float((logits - plain).abs().max())
        rec[name] = dict(
            layer_err_over_limit=over, max_abs_dlogit=diff,
            rel=diff / scale, greedy_agreement=float(
                (logits.argmax(-1) == plain.argmax(-1)).float().mean()))
    print("dense-insitu", json.dumps(rec), flush=True)
    k, f = rec["kernel"], rec["fault"]
    if (sorted(k["layer_err_over_limit"]) != sorted(n for n, _, _ in forwards)
            or max(k["layer_err_over_limit"].values()) > 1.0
            or k["rel"] > INSITU_REL_TOL):
        raise AssertionError(f"dense kernel path drifts from plain: {rec}")
    if any(f["layer_err_over_limit"][n] <= 1.0 for n in faultable):
        raise AssertionError(f"the planted fault passed a check: {rec}")
    return rec


def generation(torch, model, device, B=None, P=None, new=None):
    """The dense main path: generate(ids [B, P], max_new_tokens=new) in
    bf16 ([8, 512] + 128 by default), greedy and then sampled (temperature
    0.8, top-k 40). A prefill-only call (max_new_tokens=1, the second of
    its key: a replay) before it times the prefill; decode tokens/s is
    the remaining new - 1 tokens per request over the rest of the greedy
    call. The dense kernel must launch exactly num_layers x forwards
    times."""
    from paddle_tpu_torch.ops import decode_attention as da

    B, P, N = B or GEN_B, P or GEN_P, new or GEN_NEW
    rng = np.random.default_rng(23)
    V = model.config.vocab_size
    L = model.config.num_layers
    ids = torch.as_tensor(rng.integers(0, V, (B, P)), device=device)

    def timed(**kw):
        t0 = time.perf_counter()
        out = model.generate(ids, **kw).cpu()       # ends in a host copy
        return out, time.perf_counter() - t0

    timed(max_new_tokens=N)                         # warm: captures
    timed(max_new_tokens=1)                         # its own key: captures
    _, prefill_s = timed(max_new_tokens=1)
    captures0 = captures_total(model)
    da.decode_attention.launches = 0                # main path starts here
    greedy, greedy_s = timed(max_new_tokens=N)
    sampled, sampled_s = timed(max_new_tokens=N, temperature=0.8,
                               top_k=40, seed=1)
    launches = da.decode_attention.launches         # main path ends here
    expect = L * 2 * N
    ids_np = ids.cpu().numpy()
    for name, out in (("greedy", greedy), ("sampled", sampled)):
        out = out.numpy()
        if (out.shape != (B, P + N)
                or not np.array_equal(out[:, :P], ids_np)
                or out.min() < 0 or out.max() >= V):
            raise AssertionError(f"{name} generate(): wrong shape or ids")
    decode_s = greedy_s - prefill_s
    rec = dict(B=B, prompt=P, new_tokens=N, dtype="bfloat16",
               prefill_s=prefill_s,
               prefill_tok_per_s=B * P / prefill_s,
               greedy_s=greedy_s, sampled_s=sampled_s, decode_s=decode_s,
               decode_tok_per_s=B * (N - 1) / decode_s,
               sampled_tok_per_s=B * N / sampled_s,
               kernel_launches=launches, expected_launches=expect,
               captures=captures_total(model) - captures0,
               runners=runner_stats(model),
               sampled_differs_from_greedy=bool(
                   (greedy.numpy() != sampled.numpy()).any()))
    print("generation", json.dumps(rec), flush=True)
    if launches != expect:
        raise AssertionError(f"dense kernel launches {launches} != "
                             f"num_layers x forwards = {expect}")
    return rec


def profile_dense_step(torch, model, device):
    """Where a generate() decode step's time goes: one decode forward and
    its sampler (8 requests at length 512 of T = 640, bf16 over the f32
    model's cast state), generate()'s own decode program of the main
    path's key, run as its body without capture and replayed, each through
    ``profile_call``, and the graph's device time by CUDA events. About 20
    decode runs after one prefill: rows 512-532 of the 640."""
    rng = np.random.default_rng(24)
    V = model.config.vocab_size
    ids = rng.integers(0, V, (GEN_B, GEN_P))
    model.generate(ids, max_new_tokens=GEN_NEW)
    run = model.compiled_generate_runner(GEN_B, GEN_P, GEN_NEW)
    run.fill(ids=ids, temps=np.zeros(GEN_B, np.float32),
             top_ks=np.zeros(GEN_B, np.int64),
             u=np.zeros((GEN_NEW, GEN_B), np.float32))
    run.run("prefill")

    def step():
        run.run("decode")
        torch.cuda.synchronize()

    rec = dict(call="generate decode forward", B=GEN_B, length=GEN_P,
               **both_forms(torch, step, run, "decode", DENSE_ATTENTION))
    print("dense-profile", json.dumps(rec), flush=True)
    return rec


def _post_npz(port, ids):
    buf = io.BytesIO()
    np.savez(buf, ids=ids)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return np.load(io.BytesIO(r.read()))["out0"]


def batch_serve(torch, model, device, n_requests=6, new=32,
                prompt_range=(64, 500), block_size=32):
    """The whole-batch GenerateBatchingPredictor behind InferenceServer
    over a bf16 pool: threaded requests of mixed prompt lengths in two
    rounds, the second resending the first's prompts (a cold round that
    captures, a warm one that replays where its batches repeat a shape),
    then one over HTTP. Each batch is one generate_paged call: one graph
    per (batch, prompt width rounded up to a power of two) (the prefill
    and new - 1 decode forwards through the paged kernel), captured on the
    key's first call and replayed after. Checks lengths, ids, pool
    conservation and the paged kernel's launches, then
    ``paged_runner_check``."""
    from paddle_tpu_torch.inference import (
        GenerateBatchingPredictor,
        InferenceServer,
        PagedKVCache,
    )
    from paddle_tpu_torch.ops import paged_attention as pa

    spec = model._decode_cache_spec()
    per_req = -(-(prompt_range[1] + new) // block_size)
    kv = PagedKVCache(*spec, block_size=block_size,
                      num_blocks=(n_requests + 1) * per_req,
                      dtype=torch.bfloat16, device=device)
    gp = GenerateBatchingPredictor(model, max_batch_size=8, max_delay_ms=100,
                                   max_new_tokens=new, kv_cache=kv,
                                   device=device)
    rng = np.random.default_rng(25)
    V = model.config.vocab_size
    plens = rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)
    prompts = [rng.integers(0, V, n).astype(np.int64) for n in plens]
    http_prompt = rng.integers(0, V, int(rng.integers(*prompt_range))
                               ).astype(np.int64)
    srv = InferenceServer(gp, device=device, default_timeout=600).start()
    captures0 = captures_total(model)
    pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    try:
        results, rounds = serve_rounds(gp, model, prompts, new,
                                       ("cold", "warm"))
        http_out = _post_npz(srv.port, http_prompt)
    finally:
        wall = time.perf_counter() - t0
        srv.stop()
    launches = pa.paged_decode_attention.launches
    for p, out in [(prompts[i], res[i]) for res in results
                   for i in range(n_requests)] + [(http_prompt, http_out)]:
        if (out.shape != (len(p) + new,) or not np.array_equal(out[:len(p)], p)
                or out.min() < 0 or out.max() >= V):
            raise AssertionError("whole-batch request: wrong length or ids")
    kv.check_conservation()
    if kv.blocks_in_use != 0:
        raise AssertionError(f"{kv.blocks_in_use} KV blocks leaked")
    snap = gp.metrics.snapshot()
    expect = spec[0] * new * len(gp.batch_sizes)
    rec = dict(requests=2 * n_requests, http_requests=1,
               completed=snap.get("completed", 0),
               batch_sizes=list(gp.batch_sizes), new_tokens=new, wall_s=wall,
               tok_per_s=(2 * n_requests + 1) * new / wall, rounds=rounds,
               warm_equals_cold=all(np.array_equal(results[0][i],
                                                   results[1][i])
                                    for i in range(n_requests)),
               paged_launches=launches, expected_launches=expect,
               captures=captures_total(model) - captures0)
    print("batch-serving", json.dumps(rec), flush=True)
    if rec["completed"] != 2 * n_requests + 1:
        raise AssertionError(f"completed {rec['completed']} of "
                             f"{2 * n_requests + 1}")
    if launches != expect or launches == 0:
        raise AssertionError(f"paged launches {launches} != num_layers x "
                             f"forwards = {expect}")
    rec["runner"] = paged_runner_check(torch, model, kv, new, rng)
    return rec


def serve_rounds(gp, model, prompts, new, names):
    """Rounds of the same threaded requests through predictor ``gp``: per
    round its wall, tokens/s, batch sizes and graph captures. Returns
    ([{request: output}] per round, [round record])."""
    results, errors, rounds = [], {}, []

    def client(i):
        try:
            results[-1][i] = gp.infer(prompts[i], timeout=600)
        except Exception as e:      # reported below, fails the phase
            errors[i] = repr(e)

    for name in names:
        results.append({})
        c0, b0 = captures_total(model), len(gp.batch_sizes)
        t1 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"requests failed: {errors}")
        dt = time.perf_counter() - t1
        rounds.append(dict(round=name, wall_s=dt,
                           tok_per_s=len(prompts) * new / dt,
                           batch_sizes=list(gp.batch_sizes[b0:]),
                           captures=captures_total(model) - c0))
    return results, rounds


def paged_runner_check(torch, model, kv, new, rng, B=4, P=256):
    """generate_paged's captured runner at one key (B 4, P 256, ``new``
    tokens, prompts of 256 / 200 / 131 / 64 over ``kv``): the first call
    (body, then capture), then greedy and sampled (temperature 0.8, top-k
    40, one seed) calls as bodies without capture and replayed, tokens
    identical, with the host wall of each form; then one call of each form
    through ``profile_call``: a replayed call is one fill, one graph
    launch and one read (at most 3 host launch calls)."""
    V = model.config.vocab_size
    plens = np.array([P, 200, 131, 64])
    ids = rng.integers(0, V, (B, P))
    tables = np.stack([kv.reserve(("runner", b), P + new)
                       for b in range(B)])
    try:
        def call(**kw):
            return model.generate_paged(ids, plens, kv, tables,
                                        max_new_tokens=new, **kw)

        pool0 = graph_pool_bytes(torch, model)
        t0 = time.perf_counter()
        call()
        first_ms = (time.perf_counter() - t0) * 1e3
        run = model.compiled_generate_paged_runner(B, P, new)
        equal, wall = {}, {}
        for form, kw in (("greedy", {}), ("sampled", dict(
                temperature=0.8, top_k=40, seed=2))):
            t0 = time.perf_counter()
            with run._eager():
                body = call(**kw)
            t1 = time.perf_counter()
            replay = call(**kw)
            t2 = time.perf_counter()
            equal[form] = bool(np.array_equal(body, replay))
            wall[form] = dict(body_ms=(t1 - t0) * 1e3,
                              replay_ms=(t2 - t1) * 1e3)
        with run._eager():
            body_prof = profile_call(torch, call, PAGED_ATTENTION)
        replay_prof = profile_call(torch, call, PAGED_ATTENTION)
        rec = dict(B=B, prompt=P, new_tokens=new, captures=run.captures,
                   capture_ms=run.capture_s * 1e3, first_call_ms=first_ms,
                   graph_pool_growth_bytes=(
                       None if None in (pool0, graph_pool_bytes(
                           torch, model)) else graph_pool_bytes(
                               torch, model) - pool0),
                   replay_equals_body=equal, wall=wall,
                   body=body_prof, replay=replay_prof,
                   replay_device_ms=replay_device_ms(
                       torch, run.graphs["step"].graph))
    finally:
        for b in range(B):
            kv.release(("runner", b))
    print("paged-runner", json.dumps(rec), flush=True)
    if not all(equal.values()) or run.captures != 1:
        raise AssertionError(f"generate_paged: replay differs from its body "
                             f"or {run.captures} captures: {rec}")
    if replay_prof["host_launch_calls"] > 3:
        raise AssertionError(f"a replayed generate_paged call made "
                             f"{replay_prof['host_launch_calls']} host "
                             f"launch calls (> 3): {rec}")
    return rec


def degrade_check(torch, model, device, new=16):
    """One request through a whole-batch predictor whose pool's (layers,
    kv heads, head dim) do not match the model: served by dense generate()
    in the pool's dtype, through the dense kernel, the pool untouched."""
    from paddle_tpu_torch.inference import (
        GenerateBatchingPredictor,
        PagedKVCache,
    )
    from paddle_tpu_torch.ops import decode_attention as da

    L, Hkv, D = model._decode_cache_spec()
    bad = PagedKVCache(L, 2 * Hkv, D, block_size=32, num_blocks=16,
                       dtype=torch.bfloat16, device=device)   # kv heads
    gp = GenerateBatchingPredictor(model, max_new_tokens=new, kv_cache=bad,
                                   device=device)
    prompt = np.random.default_rng(26).integers(
        0, model.config.vocab_size, 100).astype(np.int64)
    captures0 = captures_total(model)
    try:
        before = da.decode_attention.launches
        out = gp.infer(prompt, timeout=600)
        launches = da.decode_attention.launches - before
        fallback = gp.metrics.get("dense_fallback_batches")
    finally:
        gp.close()
    untouched = all(bool((p == 0).all()) for p in bad.k_pages + bad.v_pages)
    rec = dict(fallback_dense=gp.fallback_dense, dense_fallback_batches=
               fallback, dense_launches=launches, expected_launches=L * new,
               out_len=int(out.shape[0]), pool_untouched=untouched,
               captures=captures_total(model) - captures0)
    print("degrade", json.dumps(rec), flush=True)
    if not (gp.fallback_dense and fallback == 1 and launches == L * new
            and out.shape == (len(prompt) + new,)
            and np.array_equal(out[:len(prompt)], prompt) and untouched
            and bad.blocks_in_use == 0):
        raise AssertionError(f"signature-mismatch degrade failed: {rec}")
    return rec


SPEC_P, SPEC_NEW, SPEC_K = 256, 64, 4
NEAR_TIE = 1e-3


def speculative(torch, model, device):
    """generate_speculative(prompt of 256, 64 new, spec_k=4, drafter='self')
    in f32 (dtype=None): the self-drafter drafts through dense f32
    generate() (the dense kernel), verify_step scores through the paged kernel.
    Its tokens must equal greedy f32 generate()'s up to the first position
    where the top two logits of a cache-free forward over generate()'s
    output lie within 1e-3 (a near-tie, ROADMAP C); at least half must be
    compared."""
    from paddle_tpu_torch.inference.speculative import SpecStats
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(27)
    prompt = rng.integers(0, model.config.vocab_size, SPEC_P).astype(np.int64)
    model.generate_speculative(prompt, max_new_tokens=SPEC_NEW,
                               spec_k=SPEC_K, drafter="self",
                               dtype=None)        # warm: captures
    captures0 = captures_total(model)
    st = SpecStats()
    da.decode_attention.launches = pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    spec = model.generate_speculative(prompt, max_new_tokens=SPEC_NEW,
                                      spec_k=SPEC_K, drafter="self",
                                      dtype=None, stats=st)
    wall = time.perf_counter() - t0
    dense_n, paged_n = (da.decode_attention.launches,
                        pa.paged_decode_attention.launches)
    ref = model.generate(prompt[None], max_new_tokens=SPEC_NEW,
                         dtype=None)
    with torch.no_grad():
        lg = model(ref).float()[0, SPEC_P - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    ties = np.nonzero(gap < NEAR_TIE)[0]
    compared = int(ties[0]) if len(ties) else SPEC_NEW
    ref = ref[0].cpu().numpy()
    agree = bool(np.array_equal(spec[SPEC_P:SPEC_P + compared],
                                ref[SPEC_P:SPEC_P + compared]))
    class Oracle:       # replays greedy generate(): every draft accepted
        def draft(self, history, k):
            pos = len(history)
            return ref[pos:pos + int(k)]

    oracle_st = SpecStats()
    t0 = time.perf_counter()
    oracle = model.generate_speculative(prompt, max_new_tokens=SPEC_NEW,
                                        spec_k=SPEC_K, drafter=Oracle(),
                                        dtype=None, stats=oracle_st)
    oracle_wall = time.perf_counter() - t0
    oracle_agree = bool(np.array_equal(oracle[:SPEC_P + compared],
                                       ref[:SPEC_P + compared]))
    rec = dict(prompt=SPEC_P, new_tokens=SPEC_NEW, spec_k=SPEC_K,
               drafter="self", dtype="float32", stats=st.to_dict(),
               wall_s=wall, tok_per_s=SPEC_NEW / wall,
               dense_launches=dense_n, paged_launches=paged_n,
               compared_tokens=compared, min_top2_gap=float(gap.min()),
               captures=captures_total(model) - captures0,
               tokens_equal_greedy=agree,
               total_equal=bool(np.array_equal(spec, ref)),
               oracle=dict(stats=oracle_st.to_dict(), wall_s=oracle_wall,
                           tok_per_s=SPEC_NEW / oracle_wall,
                           tokens_equal_greedy=oracle_agree))
    print("speculative", json.dumps(rec), flush=True)
    L = model.config.num_layers
    if not (agree and oracle_agree) or compared < SPEC_NEW // 2:
        raise AssertionError(f"speculative tokens differ from greedy "
                             f"generate() or too few compared: {rec}")
    if (st.emitted != SPEC_NEW or paged_n != L * (1 + st.launches)
            or dense_n == 0 or dense_n % L):
        raise AssertionError(f"speculative launch accounting: {rec}")
    if compared == SPEC_NEW and oracle_st.acceptance_rate != 1.0:
        raise AssertionError(f"the oracle's greedy drafts were rejected: "
                             f"{rec}")
    return rec


# --------------------------------------------------------------- phase 11
def flash_launches(fa):
    return {"fwd": fa.flash_fwd.launches, "dq": fa.flash_bwd_dq.launches,
            "dkv": fa.flash_bwd_dkv.launches}


def train_insitu(torch, fa, model, ids, labels):
    """One forward and backward of the model with every flash kernel call
    held to its plain version on the same inputs (the limits of
    ``kernel_tolerance``); returns {"fwd" | "bwd": worst err / limit}.
    ``fault`` plants K rolled by one position into the forward kernel, or
    lse + 0.5 into the backward kernels; both must fail the check. Then the
    first loss through the kernels against the loss through the plain
    attention, same weights and batch."""
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)

    def run(fault=None, backward=True):
        worst = {"fwd": 0.0, "bwd": 0.0}

        def fwd(q, k, v, causal=False, scale=None):
            kk = k.roll(1, dims=1) if fault == "k_roll" else k
            out, lse = kernels[0](q, kk, v, causal, scale)
            ro, rl = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
            lim = fa.kernel_tolerance(q, k, v, dict(out=ro, lse=rl), causal,
                                      scale)
            res = over_limit(torch, dict(out=out, lse=lse),
                             dict(out=ro, lse=rl), lim)
            worst["fwd"] = max([worst["fwd"]] + [r for _, r in res.values()])
            return out, lse

        def bwd(kernel, plain, names):
            def call(q, k, v, dout, lse, delta, causal=False, scale=None):
                bad = lse + 0.5 if fault == "lse" else lse
                got = kernel(q, k, v, dout, bad, delta, causal, scale)
                ref = plain(q, k, v, dout, lse, delta, causal, scale)
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                refs = dict(zip(names, ref), lse=lse)
                lim = fa.kernel_tolerance(q, k, v, refs, causal, scale,
                                          dout=dout, delta=delta)
                res = over_limit(torch, dict(zip(names, got)), refs, lim)
                worst["bwd"] = max([worst["bwd"]]
                                   + [r for _, r in res.values()])
                return got if len(got) > 1 else got[0]
            return call

        fa.flash_fwd = fwd
        fa.flash_bwd_dq = bwd(kernels[1], fa.flash_attention_dq_ref, ("dq",))
        fa.flash_bwd_dkv = bwd(kernels[2], fa.flash_attention_dkv_ref,
                               ("dk", "dv"))
        try:
            if backward:
                _, loss = model(ids, labels=labels)
                loss.backward()
                model.zero_grad(set_to_none=True)
            else:
                with torch.no_grad():
                    model(ids, labels=labels)
        finally:
            fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv = kernels
        return worst

    sound = run()
    k_roll = run("k_roll", backward=False)
    lse_fault = run("lse")

    def first_loss(plain):
        if plain:
            fa.flash_fwd = (lambda q, k, v, causal=False, scale=None:
                            fa.flash_attention_fwd_ref(q, k, v, causal,
                                                       scale))
        try:
            with torch.no_grad():
                return float(model(ids, labels=labels)[1].float())
        finally:
            fa.flash_fwd = kernels[0]

    loss_k, loss_p = first_loss(False), first_loss(True)
    rec = dict(sound=sound, k_rolled_fwd=k_roll["fwd"],
               lse_plus_half_bwd=lse_fault["bwd"], loss_kernel=loss_k,
               loss_plain=loss_p, loss_rel=abs(loss_k - loss_p) / abs(loss_p),
               loss_rel_tol=LOSS_REL_TOL)
    print("train-insitu", json.dumps(rec), flush=True)
    if sound["fwd"] > 1.0 or sound["bwd"] > 1.0:
        raise AssertionError(f"flash kernels drift from plain in situ: {rec}")
    if k_roll["fwd"] <= 1.0 or lse_fault["bwd"] <= 1.0:
        raise AssertionError(f"a planted fault passed the check: {rec}")
    if not rec["loss_rel"] <= LOSS_REL_TOL:
        raise AssertionError(f"kernel loss drifts from plain loss: {rec}")
    return rec


def kernel_kind(name):
    """A device kernel's kind, by its name, for the time breakdown."""
    if "flash_" in name:
        return "flash attention"
    if any(t in name for t in ("nvjet", "gemm", "cutlass", "xmma")):
        return "matmul"
    if any(t in name for t in ("copy", "Copy", "cat", "Cat")):
        return "copy / cast"
    if "reduce" in name:
        return "reduction"
    if "elementwise" in name:
        return "elementwise"
    return "other"


def gpt_step_flops(config, B, S):
    """Operations of one training step: 6 per parameter per token for the
    matrix products (the blocks and the tied head; the embedding lookup is
    no product), and the attention's six [S, S] products (forward 2,
    backward 4) over the causal pairs."""
    c = config
    H, D = c.num_heads, c.hidden_size // c.num_heads
    kv = c.num_kv_heads * D
    block = (c.hidden_size * (c.hidden_size + 2 * kv) + c.hidden_size ** 2
             + 3 * c.hidden_size * c.intermediate_size + 2 * c.hidden_size)
    matmul_params = c.num_layers * block + c.vocab_size * c.hidden_size
    attn = c.num_layers * 6 * 2 * D * B * H * S * (S + 1) // 2
    return 6.0 * matmul_params * B * S + attn


def timed_steps(torch, step, args, kwargs, warmup, timed):
    """(losses, seconds per timed step): ``warmup`` then ``timed`` calls of
    ``step``, the timed ones between two synchronisations."""
    losses = [step(*args, **kwargs) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(*args, **kwargs) for _ in range(timed)]
    torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) / timed


def params_diff(torch, a, b):
    """max |a - b| over two lists of tensors (as f32)."""
    return max(float((x.detach().float() - y.float()).abs().max())
               for x, y in zip(a, b))


def train(torch, fa, device, B=8, S=1024, warmup=2, timed=8, seed=12,
          cfg=None, flops_fn=gpt_step_flops, lr_leg=True):
    """The training main path: GPT-350M (or ``cfg``) at full width, O2
    bf16, AdamW under the captured TrainStep, as ``bench.py``
    ``_gpt_train_phase`` runs the JAX package. From one saved state the
    same steps run twice: as bodies without capture (the reference, and
    the body wall), then captured and replayed (the main path: launch
    counts, the replay wall); losses and parameters must be bit-equal.
    ``flops_fn(cfg, B, S)``: the step's operations; ``lr_leg``: run the
    LR-schedule leg after."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m
    from paddle_tpu_torch.nn import functional as F

    cfg = cfg or gpt_350m()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device, seed=seed)
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, lambda logits, loss: loss, opt)
    ids_np = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    ids = torch.as_tensor(ids_np, device=device)
    labels = torch.as_tensor(np.roll(ids_np, -1, axis=1), device=device)
    torch.cuda.synchronize()
    print(f"train model: {cfg.num_layers} layers O2 bf16, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    insitu = train_insitu(torch, fa, model, ids, labels)

    batch = ((ids,), {"labels": labels})
    start = step.export_state()
    with step._eager():                     # the reference: bodies
        body_losses, body_s = timed_steps(torch, step, *batch, warmup,
                                          timed)
    body_params = [p.detach().clone() for p in model.parameters()]
    step.import_state(start)
    del start

    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0   # main path
    fa.flash_bwd_dkv.launches = 0
    losses, step_s = timed_steps(torch, step, *batch, warmup, timed)
    launches = flash_launches(fa)                          # main path ends
    backend = F.get_last_attention_backend()
    peak = torch.cuda.max_memory_allocated()
    (prog,) = step._programs.values()
    loss_equal = bool(torch.equal(torch.stack(losses),
                                  torch.stack(body_losses)))
    param_diff = params_diff(torch, model.parameters(), body_params)
    losses = [float(x.float()) for x in losses]
    body_losses = [float(x.float()) for x in body_losses]
    del body_params

    def one_step():
        step(ids, labels=labels)
        torch.cuda.synchronize()

    with step._eager():
        body = profile_call(torch, one_step, ("flash_",))
    replay = profile_call(torch, one_step, ("flash_",))
    # measurement replays: they go on training the model
    replay["graph_device_ms"] = replay_device_ms(torch, prog.capture.graph)
    # the forward and backward alone (no clip, no update), host clock
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        model(ids, labels=labels)[1].backward()
        model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    fwd_bwd_ms = (time.perf_counter() - t1) / 3 * 1e3
    flops = flops_fn(cfg, B, S)
    steps = warmup + timed
    rec = dict(B=B, S=S, layers=cfg.num_layers, warmup=warmup, timed=timed,
               losses=losses, body_losses=body_losses,
               replay_losses_equal_body=loss_equal,
               replay_params_max_abs_diff=param_diff,
               step_ms=step_s * 1e3, body_step_ms=body_s * 1e3,
               tokens_per_s=B * S / step_s, step_flops=flops,
               bf16_peak_share=flops / step_s / PEAK_FLOPS["bfloat16"],
               body_bf16_peak_share=flops / body_s / PEAK_FLOPS["bfloat16"],
               max_memory_allocated=peak, flash_launches=launches,
               expected_launches_each=cfg.num_layers * steps,
               attention_backend=backend,
               capture_ms=prog.capture.seconds * 1e3,
               graph_pool_bytes=pool_bytes(torch, step._pool),
               body=body, replay=replay, fwd_bwd_ms=fwd_bwd_ms)
    print("train", json.dumps(rec), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    if not loss_equal or param_diff != 0.0:
        raise AssertionError(
            f"replayed steps differ from their bodies: losses {losses} vs "
            f"{body_losses}, parameters max |diff| {param_diff}")
    if any(n != cfg.num_layers * steps for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != "
                             f"{cfg.num_layers} layers x {steps} steps each")
    if backend != "kernel":
        raise AssertionError(f"attention backend {backend!r} != 'kernel'")
    del step, opt, prog
    torch.cuda.empty_cache()
    if lr_leg:
        rec["lr_schedule"] = lr_schedule_leg(torch, model, ids, labels)
    del model
    torch.cuda.empty_cache()
    return rec, insitu


def lr_schedule_leg(torch, model, ids, labels, replays=4):
    """Momentum under LinearWarmup(CosineAnnealingDecay) with
    ClipGradByNorm on ``model``, the scheduler stepped after every step:
    from one saved state, ``replays + 1`` steps as bodies, then the same
    captured (a body and its capture, then ``replays`` replays). Every
    captured step's loss and parameters must equal its body's, and the
    rates must differ from step to step."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByNorm
    from paddle_tpu_torch.optimizer import lr

    def make():
        sched = lr.LinearWarmup(
            learning_rate=lr.CosineAnnealingDecay(learning_rate=0.01,
                                                  T_max=replays),
            warmup_steps=2, start_lr=0.001, end_lr=0.01)
        opt = optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                 parameters=model.parameters(),
                                 grad_clip=ClipGradByNorm(1.0))
        return TrainStep(model, lambda logits, loss: loss, opt), sched

    saved = [p.detach().clone() for p in model.parameters()]
    ref, sched = make()
    rates, body = [], []
    with ref._eager():
        for _ in range(replays + 1):
            rates.append(ref.optimizer.get_lr())
            loss = ref(ids, labels=labels)
            body.append((loss, [p.detach().clone()
                                for p in model.parameters()]))
            sched.step()
    with torch.no_grad():
        for p, v in zip(model.parameters(), saved):
            p.copy_(v)
    del ref, saved
    step, sched = make()
    equal = []
    for want_loss, want_params in body:
        loss = step(ids, labels=labels)
        equal.append(bool(torch.equal(loss, want_loss)) and params_diff(
            torch, model.parameters(), want_params) == 0.0)
        sched.step()
    (prog,) = step._programs.values()
    rec = dict(rates=rates, losses=[float(x.float()) for x, _ in body],
               captured=prog.capture is not None, replays=len(body) - 1,
               equal_per_step=equal)
    print("train-lr-schedule", json.dumps(rec), flush=True)
    if (not all(equal) or not rec["captured"]
            or len(set(rates)) != len(rates)):
        raise AssertionError(f"scheduled replays differ from their bodies "
                             f"or the rates repeat: {rec}")
    del step, body
    torch.cuda.empty_cache()
    return rec


def long_context(torch, fa, device, shapes=((4096, 2), (8192, 1)),
                 warmup=2, timed=4, seed=13):
    """``bench.py`` ``_long_context_impl`` as the port runs it:
    ``gpt_350m(max_position=S)`` trained at each (S, B) through the
    captured TrainStep (O2 bf16, AdamW), ``warmup`` + ``timed`` steps on
    one batch: step ms, tokens/s, share of the bf16 peak, peak memory;
    losses finite and falling, and exactly one launch of each flash kernel
    per layer per step (S 8192 runs rows 6-7's backward)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m

    out = {}
    for S, B in shapes:
        cfg = gpt_350m(max_position=S)
        model = GPTForCausalLM(cfg, device=device, seed=seed)
        amp.decorate(model, level="O2", dtype="bfloat16")
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters(),
                              weight_decay=0.01, multi_precision=True)
        step = TrainStep(model, lambda logits, loss: loss, opt)
        ids_np = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                      (B, S))
        ids = torch.as_tensor(ids_np, device=device)
        labels = torch.as_tensor(np.roll(ids_np, -1, axis=1), device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0   # main path
        fa.flash_bwd_dkv.launches = 0
        losses, step_s = timed_steps(torch, step, (ids,), {"labels": labels},
                                     warmup, timed)
        launches = flash_launches(fa)                          # ends
        (prog,) = step._programs.values()
        losses = [float(x.float()) for x in losses]
        flops = gpt_step_flops(cfg, B, S)
        steps = warmup + timed
        rec = dict(S=S, B=B, warmup=warmup, timed=timed, losses=losses,
                   step_ms=step_s * 1e3, tokens_per_s=B * S / step_s,
                   step_flops=flops,
                   bf16_peak_share=flops / step_s / PEAK_FLOPS["bfloat16"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   capture_ms=prog.capture.seconds * 1e3,
                   graph_pool_bytes=pool_bytes(torch, step._pool),
                   flash_launches=launches,
                   expected_launches_each=cfg.num_layers * steps)
        print("long-context", json.dumps(rec), flush=True)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"S={S}: losses not finite or not falling: "
                                 f"{losses}")
        if any(n != cfg.num_layers * steps for n in launches.values()):
            raise AssertionError(f"S={S}: flash launches {launches} != "
                                 f"{cfg.num_layers} x {steps} each")
        out[f"s{S}"] = rec
        del model, opt, step, prog
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ phase 12/13/14
# The packed documents of the FlashMask timing and of varlen_train: 8192
# tokens, 5,001,216 causal pairs per head (14.9% of the causal triangle).
FM_DOCS = [2048, 1536, 1024, 1024, 768, 512, 512, 384, 256, 128]


def doc_columns(lens, causal):
    """[S, n] int32 FlashMask of packed documents of these lengths, as
    ``flash_attn_unpadded`` builds it: per key column its document's end
    (causal, n = 1), or [end, S, 0, start] (non-causal, n = 4)."""
    cu = np.concatenate([[0], np.cumsum(lens)])
    S = int(cu[-1])
    seg = np.searchsorted(cu[1:-1], np.arange(S), side="right")
    end, start = cu[seg + 1], cu[seg]
    cols = [end] if causal else [end, np.full(S, S), np.zeros(S, np.int64),
                                 start]
    return np.stack(cols, -1).astype(np.int32)


def fm_sri(torch, per_head, device):
    """[B, H', S, n] int32 on the card from [B][H'] nested [S, n] arrays."""
    return torch.as_tensor(np.asarray(per_head, np.int32),
                           device=device).contiguous()


def flashmask_cases(rng):
    """(name, B, S, H, Hkv, D, causal, [B][H'] of [S, n] mask columns)."""
    def docs(S, k):
        cut = np.sort(rng.choice(np.arange(1, S), k, replace=False))
        return np.diff(np.concatenate([[0], cut, [S]]))

    def bands(S):           # causal n = 2: random [start, end) per column
        lo = rng.integers(np.arange(S), S + 1)
        return np.stack([lo, lo + rng.integers(0, S // 2, S)], -1)

    return [
        ("docs-causal", 2, 1024, 16, 16, 64, True,
         [[doc_columns(docs(1024, 6), True)] for _ in range(2)]),
        ("bands-causal-n2-per-head", 2, 512, 8, 8, 64, True,
         [[bands(512) for _ in range(8)] for _ in range(2)]),
        ("docs-noncausal-n4", 2, 512, 8, 8, 64, False,
         [[doc_columns(docs(512, 4), False)] for _ in range(2)]),
        ("gqa16-4-d128-per-head", 1, 768, 16, 4, 128, True,
         [[doc_columns(docs(768, 5), True) for _ in range(16)]]),
        ("s1000", 2, 1000, 4, 4, 64, True,
         [[doc_columns(docs(1000, 5), True)] for _ in range(2)]),
    ]


def check_flashmask_kernels(torch, fa, device):
    """The three masked kernels against their plain versions on the same
    inputs, each output within ``kernel_tolerance`` (over the allowed
    positions), in f32 and bf16: uneven causal documents (n = 1, one mask
    for all heads), causal n = 2 bands per head, non-causal n = 4 bands,
    GQA 16/4 at D = 128 with a mask per head, S = 1000. Then an all-zero
    causal mask (every row hidden: every output exactly 0) and a mask
    hiding nothing (start = S: bit for bit the unmasked causal kernels)."""
    rng = np.random.default_rng(30)
    results, worst = [], {}
    for n, (name, B, S, H, Hkv, D, causal, cols) in enumerate(
            flashmask_cases(rng)):
        sri = fm_sri(torch, cols, device)
        for dtype in FLASH_DTYPES:
            q, k, v, do = flash_inputs(torch, B, S, H, Hkv, D, dtype, device,
                                       seed=500 + n)
            got, _ = flash_run(fa, q, k, v, do, causal, sri=sri)
            torch.cuda.synchronize()
            ref, delta = flash_run(fa, q, k, v, do, causal, plain=True,
                                   sri=sri)
            lim = fa.kernel_tolerance(q, k, v, ref, causal, dout=do,
                                      delta=delta, sri=sri)
            res = over_limit(torch, got, ref, lim)
            ok = (all(bool(torch.isfinite(x).all()) for x in got.values())
                  and all(r <= 1.0 for _, r in res.values()))
            rec = dict(case=name, dtype=dtype, B=B, S=S, H=H, Hkv=Hkv, D=D,
                       causal=causal, n=int(sri.shape[3]),
                       mask_heads=int(sri.shape[1]), ok=ok,
                       **{f"{o}_max_abs_err": e for o, (e, _) in res.items()},
                       **{f"{o}_err_over_limit": r
                          for o, (_, r) in res.items()})
            print("flashmask-check", json.dumps(rec), flush=True)
            results.append(rec)
            worst_of(worst, dtype, res)
            if not ok:
                raise AssertionError(f"masked flash kernel disagrees with "
                                     f"plain: {rec}")
            del got, ref, lim
    S = 640
    for dtype in FLASH_DTYPES:
        q, k, v, do = flash_inputs(torch, 2, S, 8, 8, 64, dtype, device,
                                   seed=520)
        zero = torch.zeros((2, 1, S, 1), dtype=torch.int32, device=device)
        hidden, _ = flash_run(fa, q, k, v, do, True, sri=zero)
        nothing = torch.full((2, 8, S, 1), S, dtype=torch.int32,
                             device=device)
        masked, _ = flash_run(fa, q, k, v, do, True, sri=nothing)
        unmasked, _ = flash_run(fa, q, k, v, do, True)
        torch.cuda.synchronize()
        rec = dict(case="all-masked-and-mask-nothing", dtype=dtype, S=S,
                   all_masked_exact_zero={
                       o: bool((x == 0).all()) for o, x in hidden.items()},
                   mask_nothing_bit_equal={
                       o: bool(torch.equal(x, unmasked[o]))
                       for o, x in masked.items()})
        print("flashmask-check", json.dumps(rec), flush=True)
        results.append(rec)
        if not (all(rec["all_masked_exact_zero"].values())
                and all(rec["mask_nothing_bit_equal"].values())):
            raise AssertionError(f"masked kernels' edge cases: {rec}")
    return results, worst


def sdpa_backend(torch, q, k, v, mask):
    """The backend scaled_dot_product_attention picks for these inputs:
    PyTorch's own dispatcher choice (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0,
                                              False)).name


def time_flashmask(torch, fa, device, dtype="bfloat16"):
    """Kernel, plain, bound and library times of the masked kernels (causal,
    in ``dtype``) at B = 1, S = 8192, H = 16, D = 64 under the document mask of
    FM_DOCS (one mask for all heads), and the unmasked causal kernels on
    the same inputs: the work a mask-blind kernel would do. The library
    yardstick is scaled_dot_product_attention with the boolean [1, 1, S, S]
    mask (its forward; its one backward for dq and dk/dv), on [B, H, S, D]
    copies made outside the timing; ``sdpa_backend`` names the backend.
    The port never calls it. The backward kernels take the masked kernel's
    lse and delta. The plain versions (median of 5) are timed call by
    call (``time_ms`` ``queued=False``). Before the timing, each masked
    kernel's outputs at this shape are held to the plain versions on the
    same inputs (``held_by_heads``; the backward on the kernel's lse and
    delta): their max |kernel - plain| is the main path's reading, and a
    reading over ``kernel_tolerance`` fails the phase."""
    import torch.nn.functional as F

    B, S, H, D = 1, sum(FM_DOCS), 16, 64
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    q, k, v, do = flash_inputs(torch, B, S, H, H, D, dtype, device,
                               seed=310)
    sri = fm_sri(torch, [[doc_columns(FM_DOCS, True)]], device)
    allowed = fa.flashmask_allowed(S, sri, True)             # [1, 1, S, S]
    pairs = int(allowed.sum())
    o, lse = fa.flashmask_fwd(q, k, v, sri, True)
    delta = fa.attention_delta(o, do)
    got = {"fwd": dict(out=o, lse=lse),
           "dq": dict(dq=fa.flashmask_bwd_dq(q, k, v, do, lse, delta, sri,
                                             True)),
           "dkv": dict(zip(("dk", "dv"), fa.flashmask_bwd_dkv(
               q, k, v, do, lse, delta, sri, True)))}
    held = {}
    for kern, outs in got.items():
        finite = all(bool(torch.isfinite(x).all()) for x in outs.values())
        ratio, err = held_by_heads(torch, fa, kern, outs, q, k, v, sri, True,
                                   None, do, lse, delta)
        held[kern] = dict(max_abs_err=err, err_over_limit=ratio)
        if not finite or ratio > 1.0:
            raise AssertionError(f"masked {kern} ({dtype}) at the main "
                                 f"path's shape disagrees with plain: "
                                 f"{held[kern]}, finite {finite}")
    del got
    uo, ulse = fa.flash_fwd(q, k, v, True)
    udelta = fa.attention_delta(uo, do)
    calls = {
        "fwd": (lambda: fa.flashmask_fwd(q, k, v, sri, True),
                lambda: fa.flash_attention_fwd_ref(q, k, v, True, sri=sri),
                lambda: fa.flash_fwd(q, k, v, True)),
        "dq": (lambda: fa.flashmask_bwd_dq(q, k, v, do, lse, delta, sri,
                                           True),
               lambda: fa.flash_attention_dq_ref(q, k, v, do, lse, delta,
                                                 True, sri=sri),
               lambda: fa.flash_bwd_dq(q, k, v, do, ulse, udelta, True)),
        "dkv": (lambda: fa.flashmask_bwd_dkv(q, k, v, do, lse, delta, sri,
                                             True),
                lambda: fa.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                                   True, sri=sri),
                lambda: fa.flash_bwd_dkv(q, k, v, do, ulse, udelta, True)),
    }
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    for t in (qt, kt, vt):
        t.requires_grad_()

    def lib_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)

    lib_out = lib_fwd()

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                   retain_graph=True)

    library = {"fwd": time_ms(torch, lib_fwd, flush),
               "bwd": time_ms(torch, lib_bwd, flush)}
    backend = sdpa_backend(torch, qt, kt, vt, allowed)
    bounds = flash_bounds(B, S, H, D, True, pairs=pairs,
                          mask_bytes=sri.numel() * 4)
    ubounds = flash_bounds(B, S, H, D, True)
    out = {}
    for kern, (kernel, plain, unmasked) in calls.items():
        side = "fwd" if kern == "fwd" else "bwd"
        rec = dict(kernel=kern, B=B, S=S, H=H, D=D, dtype=dtype,
                   causal=True, documents=FM_DOCS, allowed_pairs_per_head=
                   pairs, causal_share=pairs / (S * (S + 1) / 2),
                   ms=time_ms(torch, kernel, flush),
                   plain_ms=time_ms(torch, plain, flush, reps=5,
                                    queued=False),
                   library_ms=library[side],
                   library_call=("sdpa forward, boolean mask" if side ==
                                 "fwd" else "sdpa backward, boolean mask "
                                 "(dq, dk, dv in one call)"),
                   library_backend=backend,
                   bound_ms=bounds[kern][0], bound_by=bounds[kern][1],
                   unmasked_ms=time_ms(torch, unmasked, flush),
                   unmasked_bound_ms=ubounds[kern][0],
                   unmasked_bound_by=ubounds[kern][1], **held[kern])
        print("flashmask-time", json.dumps(rec), flush=True)
        out[kern] = rec
    out["bwd"] = whole_backward(out, B=B, S=S, H=H, D=D, dtype=dtype,
                                masked=True)
    del q, k, v, do, o, uo, qt, kt, vt, dot, lib_out, allowed, calls
    torch.cuda.empty_cache()
    return out


def held_by_heads(torch, fa, kind, got, q, k, v, sri, causal, scale,
                  dout=None, lse=None, delta=None, chunk=4):
    """(worst |kernel - plain| / ``kernel_tolerance``, max |kernel - plain|
    with lse left out) over the outputs ``got`` of one masked kernel call
    ("fwd", "dq" or "dkv") on its own inputs, taken ``chunk`` heads at a
    time (the plain versions hold [chunk, S, S] f32 scores)."""
    B, S, H, _ = q.shape

    def rows(x, a, b):                  # [B * H, S] -> heads a:b
        return x.reshape(B, H, S)[:, a:b].reshape(-1, S)

    worst = err = 0.0
    for a in range(0, H, chunk):
        b = min(a + chunk, H)
        qs, ks, vs = (t[:, :, a:b] for t in (q, k, v))
        part = {n: rows(x, a, b) if n == "lse" else x[:, :, a:b]
                for n, x in got.items()}
        if kind == "fwd":
            ro, rl = fa.flash_attention_fwd_ref(qs, ks, vs, causal, scale,
                                                sri)
            ref = dict(out=ro, lse=rl)
            lim = fa.kernel_tolerance(qs, ks, vs, ref, causal, scale,
                                      sri=sri)
        else:
            dos, ls, ds = dout[:, :, a:b], rows(lse, a, b), rows(delta, a, b)
            plain = (fa.flash_attention_dq_ref if kind == "dq"
                     else fa.flash_attention_dkv_ref)
            r = plain(qs, ks, vs, dos, ls, ds, causal, scale, sri)
            ref = dict(zip(got, r if isinstance(r, tuple) else (r,)),
                       lse=ls)
            lim = fa.kernel_tolerance(qs, ks, vs, ref, causal, scale,
                                      dout=dos, delta=ds, sri=sri)
        res = over_limit(torch, part, ref, lim)
        worst = max([worst] + [r for _, r in res.values()])
        err = max([err] + [e for o, (e, _) in res.items() if o != "lse"])
    return worst, err


INSITU_LAYERS = (0, 11, 23)


def varlen_insitu(torch, fa, loss_of, cu, max_len, blocks):
    """One forward and backward of the stack with the masked kernel calls
    of layers 0, 11 and 23 held to the plain versions on their own inputs
    (``held_by_heads``); the control plants each document's end one short
    into all three kernels (the last row of every document then sees
    nothing) and must fail the check of each. Returns the worst readings
    per kernel, sound and faulted."""
    kernels = (fa.flashmask_fwd, fa.flashmask_bwd_dq, fa.flashmask_bwd_dkv)
    L = len(blocks)

    def run(fault):
        worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        calls = {"fwd": 0, "dq": 0, "dkv": 0}

        def checked(kind):            # forward calls go 0..L-1, backward
            i = calls[kind]           # calls L-1..0
            calls[kind] += 1
            return (i if kind == "fwd" else L - 1 - i) in INSITU_LAYERS

        def fwd(q, k, v, sri, causal=False, scale=None):
            out, lse = kernels[0](q, k, v, sri - 1 if fault else sri,
                                  causal, scale)
            if checked("fwd"):
                worst["fwd"] = max(worst["fwd"], held_by_heads(
                    torch, fa, "fwd", dict(out=out, lse=lse), q, k, v, sri,
                    causal, scale)[0])
            return out, lse

        def bwd(kind, kernel, names):
            def call(q, k, v, dout, lse, delta, sri, causal=False,
                     scale=None):
                got = kernel(q, k, v, dout, lse, delta,
                             sri - 1 if fault else sri, causal, scale)
                if checked(kind):
                    outs = got if isinstance(got, tuple) else (got,)
                    worst[kind] = max(worst[kind], held_by_heads(
                        torch, fa, kind, dict(zip(names, outs)), q, k, v,
                        sri, causal, scale, dout, lse, delta)[0])
                return got
            return call

        fa.flashmask_fwd = fwd
        fa.flashmask_bwd_dq = bwd("dq", kernels[1], ("dq",))
        fa.flashmask_bwd_dkv = bwd("dkv", kernels[2], ("dk", "dv"))
        try:
            loss_of(cu, max_len).backward()
        finally:
            fa.flashmask_fwd, fa.flashmask_bwd_dq, fa.flashmask_bwd_dkv = \
                kernels
            for p in blocks.parameters():
                p.grad = None
        if calls != {"fwd": L, "dq": L, "dkv": L}:
            raise AssertionError(f"masked kernel calls {calls} != {L} each")
        return worst

    rec = dict(dtype=str(next(blocks.parameters()).dtype)[6:],
               layers=list(INSITU_LAYERS), sound=run(False),
               doc_end_one_short=run(True))
    print("varlen-insitu", json.dumps(rec), flush=True)
    if max(rec["sound"].values()) > 1.0:
        raise AssertionError(f"masked kernels drift from plain in situ: "
                             f"{rec}")
    if min(rec["doc_end_one_short"].values()) <= 1.0:
        raise AssertionError(f"the planted fault passed a check: {rec}")
    return rec


def packed_stack(torch, layers, hidden, heads, device, seed,
                 dtype="bfloat16"):
    """``layers`` blocks of RMSNorm -> ColumnParallelLinear(hidden ->
    3 hidden) -> F.flash_attn_varlen_qkvpacked(causal=True) ->
    RowParallelLinear(hidden -> hidden) -> residual, built from the port's
    layers, weights drawn from a seeded generator."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear,
        RowParallelLinear,
    )
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.nn import RMSNorm
    from paddle_tpu_torch.nn import functional as F

    td = getattr(torch, dtype)

    class PackedBlock(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = RMSNorm(hidden, device=device, dtype=td)
            self.qkv = ColumnParallelLinear(hidden, 3 * hidden,
                                            device=device, dtype=td)
            self.proj = RowParallelLinear(hidden, hidden, device=device,
                                          dtype=td)

        def forward(self, x, cu, max_len):
            T = x.shape[0]
            qkv = self.qkv(self.norm(x)).reshape(T, 3, heads,
                                                 hidden // heads)
            out, _ = F.flash_attn_varlen_qkvpacked(qkv, cu, cu, max_len,
                                                   max_len, causal=True)
            return x + self.proj(out.reshape(T, hidden))

    blocks = torch.nn.ModuleList(PackedBlock() for _ in range(layers))
    gen = make_generator(seed, device)
    for blk in blocks:
        blk.qkv.reset_parameters(gen)
        blk.proj.reset_parameters(gen)
    return blocks


def packed_model(torch, blocks, x, target, max_len):
    """The packed-attention stack as one module for ``TrainStep``:
    forward(cu) is the mean square error of the last block's output on the
    fixed tokens ``x`` against ``target``, the documents' boundaries ``cu``
    one batch tensor that q and k share."""
    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = blocks
            self.register_buffer("x", x)
            self.register_buffer("target", target)

        def forward(self, cu):
            h = self.x
            for blk in self.blocks:
                h = blk(h, cu, max_len)
            return ((h.float() - self.target) ** 2).mean()

    return Stack()


def varlen_train(torch, fa, device, docs=FM_DOCS, layers=24, hidden=1024,
                 heads=16, warmup=2, timed=5, seed=40, f16_steps=3):
    """The slice's main path: training on packed documents through the
    captured TrainStep. ``layers`` packed-attention blocks
    (``packed_stack``) in bf16 under the port's AdamW (lr 1e-4, weight
    decay 0.01; the captured update runs in bf16, as JAX's TrainStep runs
    it in each parameter's dtype), the loss the mean square error of the
    last block's output against a seeded target (``packed_model``); each
    step packs the documents ``docs`` in an order shuffled by a seeded
    generator (its boundaries built on the host and passed as the step's
    one batch tensor, so every order replays one graph). In situ first
    (``varlen_insitu``, eager, on the first step's order), then ``warmup``
    + ``timed`` steps (a body and its capture, then replays): step ms and
    tokens/s on the host clock, every loss finite and the first order's
    loss lower after the steps than before (each step's loss depends on
    its order), exactly layers x steps launches of each masked kernel and none
    of the unmasked ones, and one profiled replay by kernel kind (the
    earlier eager loop on an NVIDIA H100 80GB HBM3 at 700.00 W: 103.73 ms
    a step, busy 0.41). Then the stack in f16
    (``decorate``): ``varlen_insitu`` again on its scaled loss, then
    ``f16_steps`` eager steps under ``GradScaler``: the masked kernels'
    f16 forms on the main path, losses finite."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.jit import TrainStep

    t0 = time.perf_counter()
    blocks = packed_stack(torch, layers, hidden, heads, device, seed)
    T = int(sum(docs))
    gen = make_generator(seed + 1, device)
    x = torch.randn((T, hidden), generator=gen, device=device).to(
        torch.bfloat16)
    target = torch.randn((T, hidden), generator=gen, device=device)
    order = np.random.default_rng(seed)
    max_len = int(max(docs))
    stack = packed_model(torch, blocks, x, target, max_len)
    step = TrainStep(stack, lambda loss: loss, optimizer.AdamW(
        learning_rate=1e-4, parameters=stack.parameters(), weight_decay=0.01,
        multi_precision=True))

    def batch():
        lens = order.permutation(docs)
        return torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                               device=device)

    def loss_of(cu, max_len):
        return stack(cu)

    n_params = sum(p.numel() for p in blocks.parameters())
    print(f"varlen model: {layers} packed-attention blocks bf16, "
          f"{n_params / 1e6:.1f} M params, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    insitu = varlen_insitu(torch, fa, loss_of, batch(), max_len, blocks)

    cus = [batch() for _ in range(warmup + timed)]
    with torch.no_grad():       # the first order's loss, before training
        before = float(stack(cus[0]))
    names = ("fm_fwd", "fm_dq", "fm_dkv", "fwd", "dq", "dkv")
    for n in names:                                   # main path starts
        fa._WRAPPERS[n].launches = 0
    losses = [step(cu) for cu in cus[:warmup]]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses += [step(cu) for cu in cus[warmup:]]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / timed
    launches = {n: fa._WRAPPERS[n].launches for n in names}   # ends
    losses = [float(v) for v in losses]
    with torch.no_grad():       # and after (each step packs another order)
        after = float(stack(cus[0]))
    (prog,) = step._programs.values()
    keys = len(step._programs)
    cu_next = batch()

    def one_step():
        step(cu_next)
        torch.cuda.synchronize()

    prof = profile_call(torch, one_step, ("flash_",))
    steps = warmup + timed
    rec = dict(layers=layers, hidden=hidden, heads=heads, tokens=T,
               documents=list(docs), warmup=warmup, timed=timed,
               losses=losses, first_order_loss_before_after=[before, after],
               step_ms=step_s * 1e3, tokens_per_s=T / step_s,
               captured=prog.capture is not None, keys=keys,
               capture_ms=prog.capture.seconds * 1e3,
               masked_launches=launches,
               expected_launches_each=layers * steps,
               profiled_wall_ms=prof["profiled_wall_ms"],
               device_ms=prof["device_ms"],
               kernel_launches=prof["kernel_launches"],
               host_launch_calls=prof["host_launch_calls"],
               device_busy_share=prof["device_busy_share"],
               attention_share_of_device=prof["attention_share_of_device"],
               device_ms_by_kind=prof["device_ms_by_kind"],
               top_kernels=prof["top_kernels"])
    print("varlen-train", json.dumps(rec), flush=True)
    if not all(np.isfinite(losses)) or not after < before:
        raise AssertionError(f"losses not finite, or the first order's "
                             f"loss not falling: {losses}, {before} -> "
                             f"{after}")
    want = dict(fm_fwd=layers * steps, fm_dq=layers * steps,
                fm_dkv=layers * steps, fwd=0, dq=0, dkv=0)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if not rec["captured"] or keys != 1:
        raise AssertionError(f"the packed steps were not one captured key: "
                             f"{keys} keys")
    del step, prog
    torch.cuda.empty_cache()

    # the f16 forms of the masked kernels on the same path: eager steps
    # under GradScaler with f32 master weights, as an f16 script trains (an
    # update in f16 itself loses AdamW's epsilon, 1e-8, below f16's range)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=stack.parameters(),
                          weight_decay=0.01)
    amp.decorate(stack, opt, level="O2", dtype="float16")
    stack.x = stack.x.half()
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    # the f16 kernels in situ, on the scaled loss the steps differentiate
    # (unscaled, dO underflows f16 at this loss's 2 / (T hidden) gradient)
    f16_insitu = varlen_insitu(torch, fa, lambda cu, _: scaler.scale(
        stack(cu)), batch(), max_len, blocks)

    def f16_step():
        loss = stack(batch())
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        return float(loss)

    for n in names:                                   # main path starts
        fa._WRAPPERS[n].launches = 0
    f16_losses = [f16_step() for _ in range(f16_steps)]
    f16_launches = {n: fa._WRAPPERS[n].launches for n in names}   # ends
    rec["f16"] = dict(losses=f16_losses, masked_launches=f16_launches,
                      steps=f16_steps, insitu=f16_insitu)
    print("varlen-train-f16", json.dumps(rec["f16"]), flush=True)
    want = dict(fm_fwd=layers * f16_steps, fm_dq=layers * f16_steps,
                fm_dkv=layers * f16_steps, fwd=0, dq=0, dkv=0)
    if f16_launches != want or not all(np.isfinite(f16_losses)):
        raise AssertionError(f"f16 packed steps: launches {f16_launches} "
                             f"!= {want}, or losses {f16_losses}")
    del blocks, stack, opt, x, target
    torch.cuda.empty_cache()
    return rec, insitu

# peak device memory of the leg-less training step (O2 bf16, AdamW, B 8,
# S 1024) as this script's training phase first recorded it, NVIDIA H100
# 80GB HBM3, 700.00 W
LEGLESS_PEAK_BYTES = 22_648_100_864
# one parameter of a full model, for the planted inf of the f16 leg
INF_PARAM = "gpt.blocks.0.mlp.down.weight"


def recipe_leg(torch, fa, model, ids, labels, name, dtype, warmup, timed,
               recompute=None, dropout=0.0, o1=False, o2=False, base=None):
    """One training recipe of GPT-350M through the captured TrainStep (see
    ``train_recipes``), on ``model`` built with this leg's ``recompute``
    and ``dropout``, every step under ``auto_cast`` bf16 at O1 (``o1``) or
    O2 (``o2``) or under none; returns its record, and raises when a gate
    fails."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import default_generator
    from paddle_tpu_torch.jit import TrainStep

    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, lambda logits, loss: loss, opt)
    gen = default_generator(ids.device)
    gen.manual_seed(7)
    def cast():
        if o2:
            return amp.auto_cast(level="O2", dtype="bfloat16")
        return (amp.auto_cast(dtype="bfloat16") if o1
                else contextlib.nullcontext())

    batch = ((ids,), {"labels": labels})
    rec = dict(leg=name, dtype=dtype, recompute=recompute, dropout=dropout,
               amp=("O2 decorate + auto_cast(O2) bf16" if o2
                    else "O1 bf16" if o1 else "O2"),
               warmup=warmup, timed=timed)
    start = step.export_state()
    body_losses = body_params = None
    if not dropout:                     # the reference: bodies
        with cast(), step._eager():
            first = step(*batch[0], **batch[1])
            if base is not None:        # recompute against none
                rec["first_step_loss_equal_no_recompute"] = bool(
                    torch.equal(first, base[0]))
                rec["first_step_params_max_abs_diff_no_recompute"] = (
                    params_diff(torch, model.parameters(), base[1]))
            rest, body_s = timed_steps(torch, step, *batch, warmup - 1,
                                       timed)
        rec["body_step_ms"] = body_s * 1e3
        body_losses = [first] + rest
        body_params = [p.detach().clone() for p in model.parameters()]
        step.import_state(start)
    torch.cuda.reset_peak_memory_stats()
    for w in fa._WRAPPERS.values():                 # main path starts
        w.launches = 0
    with cast():
        losses, step_s = timed_steps(torch, step, *batch, warmup, timed)
    launches = {k: w.launches for k, w in fa._WRAPPERS.items()}  # ends
    peak = torch.cuda.max_memory_allocated()
    (prog,) = step._programs.values()
    if body_losses is not None:
        rec["replay_losses_equal_body"] = bool(torch.equal(
            torch.stack(losses), torch.stack(body_losses)))
        rec["replay_params_max_abs_diff"] = params_diff(
            torch, model.parameters(), body_params)
        del body_params
    if dropout:
        # replays from one exported state: the first layer's updated
        # weight (its gradient passes every layer's masks; the bf16 loss
        # is too coarse to tell masks apart) is the same after
        # import_state, and differs once the generator has moved on
        probe = model.gpt.blocks[0].attn.qkv_proj.weight
        snap = step.export_state()

        def replay():
            step(*batch[0], **batch[1])
            return probe.detach().clone()

        a = replay()
        advanced = gen.get_state()
        step.import_state(snap)
        again = replay()
        step.import_state(snap)
        gen.set_state(advanced)
        b = replay()
        rec["import_state_repeats_masks"] = bool(torch.equal(a, again))
        rec["next_replay_draws_new_masks"] = not bool(torch.equal(a, b))
        rec["mask_probe_weight_max_abs_diff"] = float(
            (a.float() - b.float()).abs().max())
        del a, again, b, snap
    if o2:
        # the loss's dtype (JAX's black-listed mean: f32), and the step's
        # own casts kept when it is called outside auto_cast: the replay
        # from one exported state equals the replay under it, bit for bit
        snap = step.export_state()
        with cast():
            inside = step(*batch[0], **batch[1])
        step.import_state(snap)
        outside = step(*batch[0], **batch[1])
        rec["loss_dtype"] = str(inside.dtype).replace("torch.", "")
        rec["outside_auto_cast_equal"] = bool(torch.equal(inside, outside))
        del snap, inside, outside
    losses = [float(x.float()) for x in losses]

    def one_step():
        step(*batch[0], **batch[1])
        torch.cuda.synchronize()

    with cast():
        prof = profile_call(torch, one_step, ("flash_",))
    steps = warmup + timed
    rec.update(losses=losses, step_ms=step_s * 1e3,
               tokens_per_s=ids.numel() / step_s,
               max_memory_allocated=peak,
               memory_over_recorded_legless=peak / LEGLESS_PEAK_BYTES,
               device_busy_share=prof["device_busy_share"],
               host_launch_calls=prof["host_launch_calls"],
               device_ms=prof["device_ms"],
               device_ms_by_kind=prof["device_ms_by_kind"],
               capture_ms=prog.capture.seconds * 1e3,
               kernel_launches=launches, steps=steps)
    print("train-recipe", json.dumps(rec), flush=True)
    L = model.config.num_layers
    # per layer and step: the forward (twice under recompute: the flash
    # forward is no product, so the backward runs it again), dq and dk/dv;
    # none under dropout (the plain route)
    want = (0, 0, 0) if dropout else ((2 if recompute else 1) * L * steps,
                                      L * steps, L * steps)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses not finite or not falling: "
                             f"{losses}")
    if (launches["fwd"], launches["dq"], launches["dkv"]) != want:
        raise AssertionError(f"{name}: flash launches {launches}, "
                             f"{want} expected")
    if o2 and rec["loss_dtype"] != "float32":
        raise AssertionError(f"{name}: loss dtype {rec['loss_dtype']}, "
                             f"float32 expected")
    for gate in ("replay_losses_equal_body", "import_state_repeats_masks",
                 "next_replay_draws_new_masks",
                 "first_step_loss_equal_no_recompute",
                 "outside_auto_cast_equal"):
        if gate in rec and not rec[gate]:
            raise AssertionError(f"{name}: {gate} failed: {rec}")
    for gate in ("replay_params_max_abs_diff",
                 "first_step_params_max_abs_diff_no_recompute"):
        if rec.get(gate, 0.0) != 0.0:
            raise AssertionError(f"{name}: {gate} = {rec[gate]}")
    del step, opt, prog, start
    torch.cuda.empty_cache()
    return rec


def f16_scaler_leg(torch, fa, model, ids, labels, warmup, timed, plant=1):
    """O2 f16 (``decorate(dtype="float16")`` of the f32 ``model``, f32
    master weights) through eager steps under ``GradScaler`` (init scale
    1024: the f16 loss times the scale stays finite), as a Paddle f16
    script trains: forward, ``scaler.scale(loss).backward()``,
    ``scaler.step``, ``clear_grad``. Step ``plant``, a warm-up step, gets
    one inf in a gradient: that step must be skipped (parameters
    unchanged) and the scale halved; every timed step runs the full
    update. The flash kernels run their f16 forms."""
    from paddle_tpu_torch import amp, optimizer

    if not plant < warmup:
        raise ValueError(f"the planted inf (step {plant}) must fall in the "
                         f"warm-up ({warmup} steps)")
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01)
    amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    params = dict(model.named_parameters())
    skipped = None

    def step(i):
        nonlocal skipped
        _, loss = model(ids, labels=labels)
        scaler.scale(loss).backward()
        if i == plant:
            before = [p.detach().clone() for p in model.parameters()]
            scale = scaler.get_init_loss_scaling()
            with torch.no_grad():
                params[INF_PARAM].grad.view(-1)[0] = float("inf")
        scaler.step(opt)
        opt.clear_grad()
        if i == plant:
            skipped = dict(
                params_unchanged=params_diff(torch, model.parameters(),
                                             before) == 0.0,
                scale_before=scale, scale_after=scaler.get_init_loss_scaling())
            del before
        return loss.detach()

    for w in fa._WRAPPERS.values():                 # main path starts
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses = [step(i) for i in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(warmup + i) for i in range(timed)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    launches = {k: w.launches for k, w in fa._WRAPPERS.items()}  # ends
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x.float()) for x in losses]

    def one_step():
        step(-1)
        torch.cuda.synchronize()

    prof = profile_call(torch, one_step, ("flash_",))
    steps = warmup + timed
    rec = dict(leg="o2_f16_grad_scaler", dtype="float16", warmup=warmup,
               timed=timed, losses=losses, step_ms=step_s * 1e3,
               tokens_per_s=ids.numel() / step_s, max_memory_allocated=peak,
               memory_over_recorded_legless=peak / LEGLESS_PEAK_BYTES,
               device_busy_share=prof["device_busy_share"],
               host_launch_calls=prof["host_launch_calls"],
               device_ms=prof["device_ms"],
               device_ms_by_kind=prof["device_ms_by_kind"],
               planted_inf_step=plant, skipped=skipped,
               scaler=scaler.state_dict(), kernel_launches=launches,
               steps=steps)
    print("train-recipe", json.dumps(rec), flush=True)
    L = model.config.num_layers
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"f16: losses not finite or not falling: "
                             f"{losses}")
    if not (skipped["params_unchanged"]
            and skipped["scale_after"] == skipped["scale_before"] / 2):
        raise AssertionError(f"f16: the planted inf did not skip the step "
                             f"and halve the scale: {skipped}")
    if (launches["fwd"], launches["dq"], launches["dkv"]) != (L * steps,) * 3:
        raise AssertionError(f"f16: flash launches {launches}")
    return rec


def train_recipes(torch, fa, device, legless_peak, B=8, S=1024, warmup=2,
                  timed=6, seed=12):
    """The slice's training recipes on GPT-350M at full width and depth
    (``gpt_350m()``: 24 layers, hidden 1024, 16 heads of 64), B 8, S 1024,
    AdamW (lr 1e-4, weight decay 0.01), seeded ids and labels rolled by
    one, each leg's model built through ``GPTConfig(dropout=,
    recompute=)`` from the same seeded weights, ``warmup`` + ``timed``
    steps:

    (a) O2 bf16, ``recompute="block"``; (b) O2 bf16, ``recompute="dots"``
    — each first as bodies (the reference), its first step's loss and
    parameters bit-equal to a no-recompute body step's, then captured, the
    replays bit-equal to the bodies; (c) O2 bf16 with ``dropout=0.1``
    (attention on the plain route, as in JAX), captured: replays from one
    exported state draw the same masks again after ``import_state`` and
    new ones when the generator has moved on; (d) AMP O1 (``auto_cast``
    bf16) over f32 parameters, bodies then captured, bit-equal; (d') the
    standard Paddle O2 recipe: ``decorate(level="O2")`` bf16 and every
    step under ``auto_cast(level="O2", dtype="bfloat16")``, bodies then
    captured, bit-equal; its loss f32 (JAX's black-listed ``mean``) and a
    replay called outside ``auto_cast`` equal to one under it (the step
    keeps the casts it captured); (e) O2 f16 eager steps under
    ``GradScaler``, one planted inf in a warm-up step.

    Each leg: step ms, tokens/s, peak memory (and its ratio to the
    leg-less step's, ``legless_peak``, measured in this run by ``train``,
    and to the recorded 22,648,100,864 bytes), the device's busy share and
    the host's launch calls over one profiled step, and the flash kernels'
    launches (24 per step each, the forward 48 under recompute; none under
    dropout). Losses must be finite and fall."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (
        GPTConfig,
        GPTForCausalLM,
        gpt_350m,
    )

    fields = vars(gpt_350m())

    def build(dtype, **kw):
        """GPT-350M as a user builds it for this leg:
        ``GPTConfig(dropout=, recompute=)``, the same seeded f32 weights
        for every leg, then ``decorate`` to ``dtype`` (O2) where it is not
        f32."""
        model = GPTForCausalLM(GPTConfig(**{**fields, **kw}), device=device,
                               seed=seed)
        if dtype != "float32":
            amp.decorate(model, level="O2", dtype=dtype)
        return model

    t0 = time.perf_counter()
    model = build("bfloat16")
    V = model.config.vocab_size
    ids_np = np.random.default_rng(seed).integers(0, V, (B, S))
    ids = torch.as_tensor(ids_np, device=device)
    labels = torch.as_tensor(np.roll(ids_np, -1, axis=1), device=device)
    torch.cuda.synchronize()
    print(f"train-recipes model: GPT-350M, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the no-recompute reference of the first step (a body)
    base_step = TrainStep(model, lambda logits, loss: loss, optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters(), weight_decay=0.01,
        multi_precision=True))
    with base_step._eager():
        base_loss = base_step(ids, labels=labels)
    base = (base_loss, [p.detach().clone() for p in model.parameters()])
    del base_step, model
    legs = {}
    for name, kw in (("recompute_block", dict(recompute="block")),
                     ("recompute_dots", dict(recompute="dots")),
                     ("dropout_0.1", dict(dropout=0.1)),
                     ("o1_bf16_f32_params", dict(o1=True)),
                     ("o2_autocast", dict(o2=True))):
        dtype = "float32" if kw.get("o1") else "bfloat16"
        model = build(dtype, recompute=kw.get("recompute"),
                      dropout=kw.get("dropout", 0.0))
        legs[name] = recipe_leg(
            torch, fa, model, ids, labels, name, dtype, warmup,
            timed, base=base if "recompute" in kw else None, **kw)
        del model
        torch.cuda.empty_cache()
    del base
    legs["o2_f16_grad_scaler"] = f16_scaler_leg(
        torch, fa, build("float32"), ids, labels, warmup, timed)
    for rec in legs.values():
        rec["legless_max_memory_allocated"] = legless_peak
        rec["memory_over_legless"] = (rec["max_memory_allocated"]
                                      / legless_peak)
    amp_off = not amp.is_auto_cast_enabled()
    torch.cuda.empty_cache()
    if not amp_off:
        raise AssertionError("auto_cast left enabled after the O1 leg")
    return legs


OPTIMIZER_NAMES = ("Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb",
                   "ASGD", "Rprop", "NAdam", "RAdam")
# learning rates: 1e-2, and 1e-3 for RMSProp, whose first steps are
# g / sqrt((1 - rho) g^2) ~ 4.5 rates long (at 1e-2 the third loss rose)
OPT_LR = {"RMSProp": 1e-3}
# captured steps against eager Optimizer.step: the bias corrections and
# momentum schedules are f32 math on the device counter in the step and
# float64 math eagerly; an element whose gradient is near 0 moves by up to
# a normalised step on that difference, so parameters are held to a tenth
# of the rate (a wrong rule moves them by about the rate), losses to 1e-5
OPT_LOSS_RTOL = 1e-5


def optimizer_steps(torch, device, steps=3, B=2, S=128, seed=3):
    """Each of the nine optimizers ported in this slice trains a small GPT
    (2 layers, hidden 128, 2 heads of 64, vocab 256; f32) for ``steps``
    captured steps (the first a body and its capture, then replays): the
    replays bit-equal to the same steps run as bodies (``_eager()``), and
    within OPT_LOSS_RTOL (losses) and a tenth of the rate (parameters) of
    eager steps (forward, backward, ``Optimizer.step``) on a copy of the
    model."""
    import copy

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_position=256)
    rng = np.random.default_rng(seed)
    ids_np = rng.integers(0, 256, (B, S))
    ids = torch.as_tensor(ids_np, device=device)
    labels = torch.as_tensor(np.roll(ids_np, -1, 1), device=device)
    out = {}
    for name in OPTIMIZER_NAMES:
        model = GPTForCausalLM(cfg, device=device, seed=seed)
        bodies, eager = copy.deepcopy(model), copy.deepcopy(model)
        make = getattr(optimizer, name)
        rate = OPT_LR.get(name, 1e-2)

        def train_step(m):
            return TrainStep(m, lambda logits, loss: loss,
                             make(learning_rate=rate,
                                  parameters=m.parameters()))

        step, ref = train_step(model), train_step(bodies)
        opt = make(learning_rate=rate, parameters=eager.parameters())
        got, body, want = [], [], []
        for _ in range(steps):
            got.append(step(ids, labels=labels))
            with ref._eager():
                body.append(ref(ids, labels=labels))
            _, loss = eager(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            want.append(float(loss.detach()))
        (prog,) = step._programs.values()
        rec = dict(learning_rate=rate, losses=[float(x) for x in got],
                   eager_losses=want,
                   captured=prog.capture is not None,
                   replays_equal_bodies=bool(torch.equal(
                       torch.stack(got), torch.stack(body)))
                   and params_diff(torch, model.parameters(),
                                   list(bodies.parameters())) == 0.0,
                   params_max_abs_diff_eager=params_diff(
                       torch, model.parameters(),
                       [p.detach() for p in eager.parameters()]))
        out[name] = rec
        print("optimizer", name, json.dumps(rec), flush=True)
        if (not rec["captured"] or not rec["replays_equal_bodies"]
                or not np.allclose(rec["losses"], want, rtol=OPT_LOSS_RTOL,
                                   atol=0.0)
                or rec["params_max_abs_diff_eager"] > rate / 10
                or not rec["losses"][-1] < rec["losses"][0]):
            raise AssertionError(f"{name}: captured steps differ from the "
                                 f"bodies or the eager steps, or do not "
                                 f"train: {rec}")
    return out


# ------------------------------------------------------------ phases 15-19
# Zaremba, Sutskever and Vinyals 2014, "Recurrent Neural Network
# Regularization" (arXiv:1409.2329), the large PTB LSTM: 2 layers of 1500,
# vocab 10000, 35 steps unrolled, batch 20, dropout 0.65 on the
# non-recurrent connections, weights uniform in [-0.04, 0.04], SGD at 1.0
# with the gradients' global norm clipped to 10; f32
RNN_LM = dict(vocab=10000, hidden=1500, layers=2, dropout=0.65, steps=35,
              batch=20, init=0.04, lr=1.0, clip=10.0)


def rnn_lm_model(P, c):
    """The large PTB LSTM as a Paddle script writes it: ``nn.Embedding``,
    ``nn.Dropout``, ``nn.LSTM(num_layers=2, dropout=)``, ``nn.Linear``;
    forward(ids, labels) -> (logits, mean cross entropy)."""
    V = c["vocab"]

    class RNNLM(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = P.nn.Embedding(V, c["hidden"])
            self.drop = P.nn.Dropout(c["dropout"])
            self.lstm = P.nn.LSTM(c["hidden"], c["hidden"],
                                  num_layers=c["layers"],
                                  dropout=c["dropout"])
            self.head = P.nn.Linear(c["hidden"], V)

        def forward(self, ids, labels):
            out, _ = self.lstm(self.drop(self.embed(ids)))
            logits = self.head(self.drop(out))
            return logits, P.nn.functional.cross_entropy(
                logits.reshape([-1, V]), labels.reshape([-1]))

    return RNNLM()


class _LSTMCapture:
    """A forward hook that copies the LSTM's output into ``buf`` (a copy
    kernel inside a captured step too)."""

    def __init__(self, torch, layer, shape, device):
        self.buf = torch.zeros(shape, device=device)
        self.handle = layer.register_forward_hook(self)

    def __call__(self, layer, inputs, outputs):
        out = outputs[0]
        self.buf.copy_(getattr(out, "_value", out).detach())


def plain_beam_search(torch, step_fn, B, K, T, start, end):
    """Beam search written plainly, for holding ``dynamic_decode`` to:
    per step, on the host in f64, each batch row's K·V candidate totals
    sorted with numpy (every beam but the first at -1e9 at the first step;
    a finished beam only continues with ``end`` at no cost), the top K
    kept, the states gathered by their beams' rows. ``step_fn(tok [B·K],
    states) -> (logits [B·K, V], states)``."""
    tok = torch.full((B * K,), start, dtype=torch.int64,
                     device=step_fn.device)
    scores = np.zeros((B, K))
    scores[:, 1:] = -1e9
    done = np.zeros((B, K), bool)
    seqs = np.zeros((B, K, 0), np.int64)
    states = None
    for _ in range(T):
        logits, states = step_fn(tok, states)
        lp = torch.log_softmax(logits.float(), -1).double().cpu().numpy()
        V = lp.shape[-1]
        lp = lp.reshape(B, K, V)
        stop = np.full(V, -1e9)
        stop[end] = 0.0
        lp[done] = stop
        flat = (scores[:, :, None] + lp).reshape(B, K * V)
        top = np.argsort(-flat, axis=1, kind="stable")[:, :K]
        scores = np.take_along_axis(flat, top, 1)
        src, new = top // V, top % V
        seqs = np.concatenate([np.take_along_axis(seqs, src[..., None], 1),
                               new[..., None]], -1)
        done = np.take_along_axis(done, src, 1) | (new == end)
        rows = torch.as_tensor((np.arange(B)[:, None] * K + src).reshape(-1),
                               device=tok.device)
        states = tuple(tuple(s.index_select(0, rows) for s in pair)
                       for pair in states)
        tok = torch.as_tensor(new.reshape(-1), device=tok.device)
        if done.all():
            break
    return seqs, scores


def rnn_lm(torch, device, warmup=2, timed=6, seed=21, beam=4, decode_B=8,
           decode_T=16):
    """The recurrent layers at a published width (``RNN_LM``): the model
    built on the card from seeded weights, seeded token ids [20, 36] (input
    the first 35, labels the last 35), ``SGD(1.0)`` with
    ``ClipGradByGlobalNorm(10)``, through the captured ``TrainStep``. From
    one exported state and generator seed, ``warmup`` + ``timed`` steps as
    bodies (the reference), then the same steps captured (a capture and
    replays): losses and parameters bit-equal, losses falling. One more
    replay's LSTM output (a hook's copy inside the graph) held to the
    layer run eagerly from the same state and generator state (the same
    dropout masks). Step ms as bodies and replays, tokens/s, one step of
    each form profiled (host launch calls, device ms by kind). Then, in
    eval, ``dynamic_decode`` with a ``BeamSearchDecoder`` over the two
    trained ``LSTMCell``s (stacked), the embedding and the head, beam
    ``beam``, batch ``decode_B``, ``decode_T`` steps, timed cold and as
    the median of three warm calls, its ids equal
    to ``plain_beam_search``'s on the same model and its scores within
    1e-9."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.framework import default_generator
    from paddle_tpu_torch.framework import device as pdev
    from paddle_tpu_torch.jit import TrainStep

    c = RNN_LM
    prev = pdev._current["place"]
    P.set_device("cpu" if device == "cpu" else "gpu:0")
    try:
        P.seed(seed)
        model = rnn_lm_model(P, c)
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for p in torch.nn.Module.parameters(model):
                p.uniform_(-c["init"], c["init"], generator=g)
        B, S, V = c["batch"], c["steps"], c["vocab"]
        toks = np.random.default_rng(seed).integers(0, V, (B, S + 1))
        ids = P.to_tensor(toks[:, :-1])
        labels = P.to_tensor(toks[:, 1:])
        opt = P.optimizer.SGD(learning_rate=c["lr"],
                              parameters=model.parameters(),
                              grad_clip=P.nn.ClipGradByGlobalNorm(c["clip"]))
        step = TrainStep(model, lambda logits, loss: loss, opt)
        hook = _LSTMCapture(torch, model.lstm, (B, S, c["hidden"]), device)
        gen = default_generator(device)
        batch = ((ids, labels), {})
        start = step.export_state()
        gen.manual_seed(7)
        with step._eager():
            body_losses, body_s = timed_steps(torch, step, *batch, warmup,
                                              timed)
        body_params = [p.detach().clone()
                       for p in torch.nn.Module.parameters(model)]
        step.import_state(start)
        gen.manual_seed(7)
        losses, step_s = timed_steps(torch, step, *batch, warmup, timed)
        (prog,) = step._programs.values()
        rec = dict(config=dict(c), layers=c["layers"], hidden=c["hidden"],
                   warmup=warmup, timed=timed,
                   replay_losses_equal_body=bool(torch.equal(
                       torch.stack([x._value if hasattr(x, "_value") else x
                                    for x in losses]),
                       torch.stack([x._value if hasattr(x, "_value") else x
                                    for x in body_losses]))),
                   replay_params_max_abs_diff=params_diff(
                       torch, torch.nn.Module.parameters(model),
                       body_params))
        del body_params, start
        # one more replay; the LSTM output it copied, against the layer
        # run eagerly from the state and generator state it started from
        snap, gstate = step.export_state(), gen.get_state()
        step(*batch[0])
        captured = hook.buf.clone()
        step.import_state(snap)
        gen.set_state(gstate)
        with torch.no_grad():
            model(ids, labels)
        rec["captured_lstm_output_max_abs_diff"] = float(
            (captured - hook.buf).abs().max())
        rec["captured_lstm_output_max_abs"] = float(captured.abs().max())
        hook.handle.remove()
        del snap, captured

        def one_step():
            step(*batch[0])
            torch.cuda.synchronize()

        with step._eager():
            body_prof = profile_call(torch, one_step)
        replay_prof = profile_call(torch, one_step)
        losses = [float(x) for x in losses]
        rec.update(losses=losses, body_losses=[float(x) for x in body_losses],
                   step_ms=step_s * 1e3, body_step_ms=body_s * 1e3,
                   tokens_per_s=B * S / step_s, body_tokens_per_s=B * S
                   / body_s, capture_ms=prog.capture.seconds * 1e3,
                   body_host_launch_calls=body_prof["host_launch_calls"],
                   host_launch_calls=replay_prof["host_launch_calls"],
                   body_device_ms=body_prof["device_ms"],
                   device_ms=replay_prof["device_ms"],
                   device_busy_share=replay_prof["device_busy_share"],
                   body_device_busy_share=body_prof["device_busy_share"],
                   device_ms_by_kind=replay_prof["device_ms_by_kind"],
                   body_device_ms_by_kind=body_prof["device_ms_by_kind"])
        del step, prog, opt
        # beam search over the trained cells, in eval
        model.eval()

        class Stacked(P.nn.Layer):
            def __init__(self, cells):
                super().__init__()
                self.c0, self.c1 = cells

            def forward(self, x, states=None):
                s0, s1 = states if states is not None else (None, None)
                h, s0 = self.c0(x, s0)
                h, s1 = self.c1(h, s1)
                return h, (s0, s1)

        cell = Stacked([model.lstm.cells[0], model.lstm.cells[1]])
        dec = P.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                     beam_size=beam,
                                     embedding_fn=model.embed,
                                     output_fn=model.head)
        gc.collect()            # the step's graph and pool go before timing
        walls = []
        for _ in range(4):              # cold, then three warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dids, dscores = P.nn.dynamic_decode(dec, max_step_num=decode_T,
                                                batch_size=decode_B)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        warm = float(np.median(walls[1:]))

        def step_fn(tok, states):
            with torch.no_grad():
                out, states = cell(model.embed(P.Tensor(tok)), states)
                return model.head(out)._value, tuple(
                    tuple(t._value for t in pair) for pair in states)

        step_fn.device = torch.device(device)
        pids, pscores = plain_beam_search(torch, step_fn, decode_B, beam,
                                          decode_T, 0, 1)
        got = dscores.numpy()
        rec["decode"] = dict(
            beam=beam, batch=decode_B, max_steps=decode_T,
            steps=int(dids.shape[-1]), cold_ms=walls[0] * 1e3,
            ms=warm * 1e3, warm_ms=[w * 1e3 for w in walls[1:]],
            tokens_per_s=decode_B * beam * int(dids.shape[-1]) / warm,
            ids_equal_plain=bool(np.array_equal(dids.numpy(), pids)),
            scores_max_rel_diff=float(np.abs(got - pscores).max()
                                      / np.abs(pscores).max()))
    finally:
        pdev._current["place"] = prev
    print("rnn-lm", json.dumps(rec), flush=True)
    if not rec["replay_losses_equal_body"] or \
            rec["replay_params_max_abs_diff"] != 0.0:
        raise AssertionError(f"rnn_lm: replays differ from bodies: {rec}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"rnn_lm: losses not finite or not falling: "
                             f"{losses}")
    # the LSTM's outputs are tanh-bounded: f32 rounding of the same
    # products summed in the same order leaves them equal; 1e-5 allows
    # another cuBLAS algorithm under capture
    if rec["captured_lstm_output_max_abs_diff"] > 1e-5:
        raise AssertionError(f"rnn_lm: captured LSTM output against eager: "
                             f"{rec['captured_lstm_output_max_abs_diff']}")
    if not rec["decode"]["ids_equal_plain"] or \
            rec["decode"]["scores_max_rel_diff"] > 1e-9:
        raise AssertionError(f"rnn_lm: dynamic_decode against the plain "
                             f"beam search: {rec['decode']}")
    del model
    torch.cuda.empty_cache()
    return rec


def matmul_params(kind, c):
    """Weights that enter a matrix product once per token of a forward,
    read off each model's code: GPT ``qkv_proj``, ``out_proj``, the SwiGLU
    ``gate_up`` + ``down`` (three h x I matrices) or the GELU ``fc1`` +
    ``down`` (two), and the head, tied or untied (the same product);
    LLaMA q / k / v / o, gate / up / down and ``lm_head``; BERT ``qkv``,
    ``out``, ``fc1``, ``fc2``, the MLM ``transform`` and the decoder tied
    to the word embeddings. Lookups, norms and biases are no product."""
    h, inner, V = c.hidden_size, c.intermediate_size, c.vocab_size
    if kind == "bert":
        return c.num_layers * (4 * h * h + 2 * h * inner) + h * h + V * h
    kv = c.num_kv_heads * (h // c.num_heads)
    mlp = (3 if getattr(c, "use_swiglu", True) else 2) * h * inner
    return c.num_layers * (h * (h + 2 * kv) + h * h + mlp) + V * h


def forward_flops(kind, c, B, S, pairs=None):
    """Operations of one forward over [B, S]: 2 per weight per token, and
    per layer and head attention's two [S, S] products (scores, weighted
    sum) at 2 D per allowed (row, column) pair: the causal pairs for GPT
    and LLaMA, all S^2 for BERT, or ``pairs``."""
    if pairs is None:
        pairs = S * S if kind == "bert" else S * (S + 1) // 2
    D = c.hidden_size // c.num_heads
    attn = c.num_layers * 2 * 2 * D * c.num_heads * B * pairs
    return 2.0 * matmul_params(kind, c) * B * S + attn


def step_flops(kind, c, B, S):
    """Model operations of one training step: the forward and a backward
    of twice its operations (a recomputed forward is not counted)."""
    return 3.0 * forward_flops(kind, c, B, S)


def release(torch):
    """Collect garbage and return the allocator's cached blocks; the bytes
    it still reserves."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def reserved_segments(torch, n=8):
    """The allocator's largest segments: (bytes, live bytes, pool) each,
    pool 0 for the default pool and a graph's private pool otherwise."""
    segs = sorted(torch.cuda.memory_snapshot(),
                  key=lambda sg: -sg["total_size"])
    return [(sg["total_size"], sg["allocated_size"],
             list(sg.get("segment_pool_id", (0, 0)))) for sg in segs[:n]]


def host_available_bytes():
    """MemAvailable of /proc/meminfo (``free``'s available column)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def plain_route_tokens(torch, model, device, outputs, max_seq_len, slots=8,
                       chunk=64, decode_steps=4, block_size=32, dtype=None):
    """The greedy requests of ``outputs`` ({i: (prompt, output, sampled)})
    served again by a continuous scheduler on the plain attention route
    (``decode_kernel`` "plain": the paged kernel's plain version in every
    step program), threaded, over a fresh pool. Each kernel-path answer
    must equal the plain one up to that request's first near-tie of the
    plain answer (``first_tie``), and at least one token must be compared
    over all requests."""
    from paddle_tpu_torch.inference import (
        ContinuousGenerateBatchingPredictor,
        PagedKVCache,
    )

    greedy = sorted(i for i, (_, _, sampled) in outputs.items()
                    if not sampled)
    new = {i: len(outputs[i][1]) - len(outputs[i][0]) for i in greedy}
    kv = PagedKVCache(*model._decode_cache_spec(), block_size=block_size,
                      num_blocks=slots * max_seq_len // block_size,
                      dtype=dtype or torch.bfloat16, device=device)
    gp = ContinuousGenerateBatchingPredictor(
        model, kv_cache=kv, max_slots=slots, prefill_chunk=chunk,
        decode_steps=decode_steps, max_new_tokens=max(new.values()),
        max_seq_len=max_seq_len, device=device)
    gp.decode_kernel = "plain"
    plain, errors = {}, {}

    def client(i):
        try:
            plain[i] = gp.infer(outputs[i][0], timeout=600,
                                max_new_tokens=new[i])
        except Exception as e:      # reported below, fails the phase
            errors[i] = repr(e)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in greedy]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
    finally:
        gp.close()
    if errors or len(plain) != len(greedy):
        raise AssertionError(f"plain-route scheduler failed: {errors}")
    compared, agree = [], True
    for i in greedy:
        prompt, out, _ = outputs[i]
        c = first_tie(torch, model, plain[i], len(prompt), device)
        compared.append(c)
        agree &= bool(np.array_equal(out[:len(prompt) + c],
                                     plain[i][:len(prompt) + c]))
    rec = dict(greedy_requests=len(greedy), compared_tokens=compared,
               greedy_equal_plain=agree)
    print("plain-route-tokens", json.dumps(rec), flush=True)
    if not agree or sum(compared) == 0:
        raise AssertionError(f"greedy tokens differ from the plain route's "
                             f"or none was free of a near-tie: {rec}")
    return rec


def served_rows_check(torch, model, device, seqs, chunk=64):
    """A near-tie-free gate on served sequences: each of ``seqs`` (prompt
    and greedy answer) prefilled again through the kernel path in chunks
    into a fresh pool, and its full pages held per layer to a cold
    plain-path prefill of the same tokens (``rows_check``: within
    INSITU_REL_TOL; a page of the second sequence swapped into the first
    must fail)."""
    from paddle_tpu_torch.inference import PagedKVCache

    bs = 32
    full = [len(s) // bs for s in seqs]
    NB = max(full)
    kv = PagedKVCache(*model._decode_cache_spec(), block_size=bs,
                      num_blocks=len(seqs) * NB, dtype=torch.bfloat16,
                      device=device)
    for i in range(len(seqs)):
        kv.reserve(i, NB * bs)
    tables = np.stack([kv.block_table(i, pad_to=NB) for i in range(len(seqs))])
    ids = np.zeros((len(seqs), -(-NB * bs // chunk) * chunk), np.int64)
    for i, s in enumerate(seqs):
        ids[i, :full[i] * bs] = s[:full[i] * bs]
    for off in range(0, NB * bs, chunk):
        lens = np.clip(np.asarray(full) * bs - off, 0, chunk)
        model.chunk_logits(ids[:, off:off + chunk], np.full(len(seqs), off),
                           lens, kv, tables, decode_kernel="kernel")
    rec = rows_check(torch, model, kv,
                     [tables[i, :n].tolist() for i, n in enumerate(full)],
                     seqs, device, chunk, swap=min(full) // 2)
    print("served-rows", json.dumps(rec), flush=True)
    if max(rec["rel"]) > INSITU_REL_TOL or not (
            rec["control"] is not None
            and rec["control"] > INSITU_REL_TOL):
        raise AssertionError(f"served rows drift from the plain path, or "
                             f"the swapped page passed: {rec}")
    return rec


def llama_serve(torch, model, device):
    """LLaMA-2-7B bf16 at full size served: the in-situ paged check at
    layers 0, 15 and 31 over two prefill chunks and a decode forward; the
    graphs phase of the step programs (``profile_steps``); the continuous
    scheduler behind InferenceServer with 8 slots of 2048 tokens, 12
    threaded requests of 128-1500 prompt tokens and 64 new (half sampled)
    and two over HTTP; the greedy answers held to the plain route's
    (``plain_route_tokens``) and, free of near-ties, two of them prefilled
    again and held row by row to the plain path (``served_rows_check``)."""
    from paddle_tpu_torch.inference import PagedKVCache
    from paddle_tpu_torch.models import llama as llama_mod

    L = model.config.num_layers
    torch.cuda.reset_peak_memory_stats()
    insitu = insitu_check(torch, model, PagedKVCache, device, mod=llama_mod,
                          layers=(0, L // 2 - 1, L - 1), decode=True)
    steps = profile_steps(torch, model, PagedKVCache, device)
    outputs = {}
    serving = serve(torch, model, device, prompt_range=(128, 1500),
                    new_range=(64, 64), max_seq_len=LLAMA_SLOT,
                    outputs=outputs)
    peak = torch.cuda.max_memory_allocated()
    plain = plain_route_tokens(torch, model, device, outputs, LLAMA_SLOT)
    greedy = sorted(i for i, (_, _, sampled) in outputs.items()
                    if not sampled)
    rows = served_rows_check(torch, model, device,
                             [outputs[i][1] for i in greedy[:2]])
    rec = dict(insitu=insitu, profile=steps, serving=serving,
               plain_route=plain, served_rows=rows,
               max_memory_allocated=peak)
    print(f"llama_serve: prefill {serving['prefill_tok_per_s']:.0f} tok/s, "
          f"decode {serving['decode_tok_per_s']:.0f} tok/s, peak {peak} "
          f"bytes", flush=True)
    return rec


def llama_generate(torch, model, device):
    """LLaMA-2-7B dense generate() at [4, 512] + 128 new, bf16: the in-situ
    dense check at layers 0, 15 and 31 (``dense_insitu``), then the main
    path (``generation``)."""
    from paddle_tpu_torch.models import llama as llama_mod

    B, P, new = LLAMA_GEN
    L = model.config.num_layers
    torch.cuda.reset_peak_memory_stats()
    insitu = dense_insitu(torch, model, device, B=B, P=P, new=new,
                          mod=llama_mod, layers=(0, L // 2 - 1, L - 1))
    gen = generation(torch, model, device, B=B, P=P, new=new)
    gen["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return dict(insitu=insitu, generation=gen)


def param_digests(torch, params):
    """Per parameter (sum, sum of squares) in f64: a digest that one
    changed element moves."""
    return [(float(p.detach().double().sum()),
             float(p.detach().double().square().sum())) for p in params]


LLAMA_TRAIN = (1, 2048)         # llama_train's B, S


def llama_train(torch, fa, device, steps=4, seed=12):
    """LLaMA-2-7B trained: O2 bf16, AdamW (no masters, as JAX's TrainStep),
    recompute "block", B 1, S 2048, through the captured TrainStep. The
    depth is cut only if the host cannot hold the state's copy (TrainStep
    copies it to the host before a capture). In situ first
    (``train_insitu``). Then from one state saved on the host: ``steps``
    steps as bodies, the state restored, the same steps through the
    TrainStep (the first runs its body and captures, the rest replay):
    losses bit-equal and every parameter's digest equal, the losses
    falling, the flash forward launched twice per layer and step (the
    recompute) and dq / dk/dv once."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b

    B, S = LLAMA_TRAIN
    cfg = llama2_7b()
    cfg.recompute = "block"
    full_layers = cfg.num_layers
    h, inner, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    per_layer = 4 * h * h + 3 * h * inner
    params = cfg.num_layers * per_layer + 2 * V * h
    state_bytes = 3 * 2 * params            # bf16 parameters, two moments
    avail = host_available_bytes()
    if avail < 1.25 * state_bytes:
        fit = (avail / 1.25 / 6 - 2 * V * h) // per_layer
        cfg.num_layers = max(1, int(fit))
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                             seed=seed)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda logits, loss: loss, opt)
    ids_np = np.random.default_rng(seed).integers(0, V, (B, S))
    ids = torch.as_tensor(ids_np, device=device)
    labels = torch.as_tensor(np.roll(ids_np, -1, axis=1), device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama_train model: {cfg.num_layers} of {full_layers} layers, "
          f"{n_params / 1e9:.2f} B params, host available {avail} bytes, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    insitu = train_insitu(torch, fa, model, ids, labels)

    t0 = time.perf_counter()
    saved = step._copy_state(lambda t: t.detach().to("cpu", copy=True))
    copy_s = time.perf_counter() - t0
    with step._eager():
        body_losses = [step(ids, labels=labels) for _ in range(steps)]
    body_digests = param_digests(torch, model.parameters())
    step.import_state(saved)
    del saved
    gc.collect()

    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0   # main path
    fa.flash_bwd_dkv.launches = 0
    losses, step_s = timed_steps(torch, step, (ids,), {"labels": labels}, 1,
                                 steps - 1)
    launches = flash_launches(fa)                          # main path ends
    peak = torch.cuda.max_memory_allocated()
    digests_equal = param_digests(torch, model.parameters()) == body_digests
    loss_equal = bool(torch.equal(torch.stack(losses),
                                  torch.stack(body_losses)))
    losses = [float(x.float()) for x in losses]
    body_losses = [float(x.float()) for x in body_losses]
    (prog,) = step._programs.values()

    def one_step():
        step(ids, labels=labels)
        torch.cuda.synchronize()

    replay = profile_call(torch, one_step, ("flash_",))
    replay["graph_device_ms"] = replay_device_ms(torch, prog.capture.graph,
                                                 reps=3)
    flops = step_flops("llama", cfg, B, S)
    L = cfg.num_layers
    expect = dict(fwd=2 * L * steps, dq=L * steps, dkv=L * steps)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    rec = dict(B=B, S=S, layers=L, full_layers=full_layers,
               params=n_params, recompute="block", steps=steps,
               losses=losses, body_losses=body_losses,
               replay_losses_equal_body=loss_equal,
               replay_param_digests_equal_body=digests_equal,
               step_ms=step_s * 1e3, tokens_per_s=B * S / step_s,
               step_flops=flops,
               bf16_peak_share=flops / step_s / PEAK_FLOPS["bfloat16"],
               max_memory_allocated=peak, card_bytes=card_bytes,
               peak_share_of_card=peak / card_bytes,
               host_available_bytes=avail, state_bytes=state_bytes,
               host_copy_s=copy_s, flash_launches=launches,
               expected_launches=expect,
               capture_ms=prog.capture.seconds * 1e3,
               graph_pool_bytes=pool_bytes(torch, step._pool),
               replay=replay, insitu=insitu)
    print("llama_train", json.dumps(rec), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    if not loss_equal or not digests_equal:
        raise AssertionError(f"replayed steps differ from their bodies: "
                             f"{losses} vs {body_losses}, digests equal "
                             f"{digests_equal}")
    if launches != expect:
        raise AssertionError(f"flash launches {launches} != {expect}")
    if peak > 0.9 * card_bytes:
        raise AssertionError(f"peak {peak} bytes over 90% of the card")
    del step, opt, prog, model
    return rec


def refused_past_table(torch, model, device, prompt_len=2000, new=64):
    """A request whose prompt and new tokens pass the learned-position
    table (2048) is refused by ``_decode_validate`` with a ValueError
    naming max_position, through the scheduler's admission and through
    generate(), before any forward; the pool is left as it was."""
    from paddle_tpu_torch.inference import (
        ContinuousGenerateBatchingPredictor,
        PagedKVCache,
    )

    limit = model.config.max_position
    kv = PagedKVCache(*model._decode_cache_spec(), block_size=32,
                      num_blocks=(limit + 128) // 32, dtype=torch.bfloat16,
                      device=device)
    gp = ContinuousGenerateBatchingPredictor(
        model, kv_cache=kv, max_slots=1, prefill_chunk=64, decode_steps=4,
        max_new_tokens=new, max_seq_len=limit + 128, device=device)
    prompt = np.arange(prompt_len, dtype=np.int64) % 1000
    refusals = {}
    try:
        for name, call in (
                ("scheduler", lambda: gp.infer(prompt, timeout=60)),
                ("generate", lambda: model.generate(prompt[None],
                                                    max_new_tokens=new))):
            try:
                call()
                refusals[name] = None
            except ValueError as e:
                refusals[name] = str(e)
    finally:
        gp.close()
    torch.cuda.synchronize()            # a device assert would raise here
    rec = dict(prompt=prompt_len, new=new, max_position=limit,
               refusals=refusals, blocks_in_use=kv.blocks_in_use)
    print("refused-past-table", json.dumps(rec), flush=True)
    if not all(r and "max_position" in r for r in refusals.values()):
        raise AssertionError(f"a request past the table was not refused "
                             f"by _decode_validate: {rec}")
    return rec


def gpt3_1p3b_phase(torch, fa, device):
    """``gpt3_1p3b`` at full size (24 layers, hidden 2048, 16 heads of 128,
    learned positions, LayerNorm, GELU, biases): trained as ``train`` does
    (O2 bf16 with LayerNorm kept f32, AdamW, B 4, S 2048, its
    max_position; bodies then replays, bit-equal), then served in bf16:
    the in-situ paged check at layers 0, 11 and 23, six threaded requests
    of 100-1000 prompt tokens and 32 new (half sampled) and one over HTTP
    through the scheduler, the greedy answers held to the plain route's,
    and a request past the table refused by ``_decode_validate``."""
    from paddle_tpu_torch.inference import PagedKVCache
    from paddle_tpu_torch.models import gpt as gpt_mod

    cfg = gpt_mod.gpt3_1p3b()
    training, insitu_train = train(
        torch, fa, device, B=4, S=2048, warmup=2, timed=4, cfg=cfg,
        flops_fn=lambda c, B, S: step_flops("gpt", c, B, S), lr_leg=False)
    release(torch)
    model = gpt_mod.GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                                   seed=0)
    model.eval()
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    insitu = insitu_check(torch, model, PagedKVCache, device, mod=gpt_mod,
                          layers=(0, L // 2 - 1, L - 1), decode=True)
    outputs = {}
    serving = serve(torch, model, device, n_requests=6, http_requests=1,
                    prompt_range=(100, 1000), new_range=(32, 32),
                    max_seq_len=cfg.max_position, outputs=outputs)
    plain = plain_route_tokens(torch, model, device, outputs,
                               cfg.max_position)
    refused = refused_past_table(torch, model, device)
    rec = dict(training=training, train_insitu=insitu_train,
               serve_insitu=insitu, serving=serving, plain_route=plain,
               refused=refused,
               serve_max_memory_allocated=torch.cuda.max_memory_allocated())
    print(f"gpt3_1p3b: {training['step_ms']:.1f} ms/step, "
          f"{training['bf16_peak_share']:.3f} of the bf16 peak; serving "
          f"decode {serving['decode_tok_per_s']:.0f} tok/s", flush=True)
    del model
    return rec


def flash_fwd_insitu(torch, fa, fn, layers, num_layers):
    """``fn()`` (a forward) with the flash forward's calls at ``layers``
    (call index modulo ``num_layers``) held to the plain version on the
    same inputs; with K rolled by one position planted into those calls
    the check must fail. Returns (worst err / limit, the fault's)."""
    kernel = fa.flash_fwd

    def run(fault):
        worst, calls = [0.0], [0]

        def fwd(q, k, v, causal=False, scale=None):
            layer = calls[0] % num_layers
            calls[0] += 1
            if layer not in layers:
                return kernel(q, k, v, causal, scale)
            out, lse = kernel(q, k.roll(1, dims=1) if fault else k, v,
                              causal, scale)
            ro, rl = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
            lim = fa.kernel_tolerance(q, k, v, dict(out=ro, lse=rl), causal,
                                      scale)
            res = over_limit(torch, dict(out=out, lse=lse),
                             dict(out=ro, lse=rl), lim)
            worst[0] = max([worst[0]] + [r for _, r in res.values()])
            return out, lse

        fa.flash_fwd = fwd
        try:
            fn()
        finally:
            fa.flash_fwd = kernel
        return worst[0]

    return run(False), run(True)


BERT_SHAPE = (32, 512)          # bert_base's B, S
BERT_MASK_ID, BERT_SPECIAL = 103, (0, 101, 102)


def bert_base_phase(torch, fa, device, warmup=2, timed=6, seed=13):
    """``bert_base`` at full size trained with the MLM loss on
    ``bert_mlm_mask`` batches (B 32, S 512), O2 bf16 (LayerNorm kept
    f32), AdamW, at the config's dropout 0.1, through the captured
    TrainStep (a body and its capture, then replays); losses falling;
    attention on the plain route in training, as in JAX, so no flash
    kernel launches. Then ``eval()`` and one forward
    at the same shape: the non-causal flash forward once per layer, held
    in situ to the plain version at layers 0 and 11 (K rolled by one must
    fail), finite logits."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import (
        BertForMaskedLM,
        bert_base,
        bert_mlm_mask,
    )
    from paddle_tpu_torch.nn import functional as F

    B, S = BERT_SHAPE
    cfg = bert_base()
    model = BertForMaskedLM(cfg, device=device, seed=seed)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    step = TrainStep(model, lambda logits, loss: loss, opt)
    rng = np.random.default_rng(seed)
    raw = rng.integers(1000, cfg.vocab_size, (B, S))
    raw[:, 0], raw[:, -1] = 101, 102
    masked, labels = bert_mlm_mask(raw, cfg.vocab_size, BERT_MASK_ID,
                                   seed=seed, special_ids=BERT_SPECIAL)
    ids = torch.as_tensor(masked, device=device)
    lab = torch.as_tensor(labels, device=device)
    batch = ((ids,), {"labels": lab})
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0   # main path
    fa.flash_bwd_dkv.launches = 0
    losses, step_s = timed_steps(torch, step, *batch, warmup, timed)
    train_launches = flash_launches(fa)                    # main path ends
    backend = F.get_last_attention_backend()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x.float()) for x in losses]
    (prog,) = step._programs.values()

    def one_step():
        step(ids, labels=lab)
        torch.cuda.synchronize()

    replay = profile_call(torch, one_step)
    del step, opt, prog
    model.eval()
    L = cfg.num_layers

    def forward():
        with torch.no_grad():
            return model(ids)

    sound, fault = flash_fwd_insitu(torch, fa, forward, (0, L - 1), L)
    fa.flash_fwd.launches = 0                              # main path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = forward()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    eval_launches = fa.flash_fwd.launches                  # main path ends
    eval_backend = F.get_last_attention_backend()
    finite = bool(torch.isfinite(logits).all())
    flops = step_flops("bert", cfg, B, S)
    rec = dict(B=B, S=S, layers=L, dropout=cfg.dropout, param_dtypes=dtypes,
               masked_share=float((labels != -100).mean()),
               losses=losses, step_ms=step_s * 1e3,
               tokens_per_s=B * S / step_s, step_flops=flops,
               bf16_peak_share=flops / step_s / PEAK_FLOPS["bfloat16"],
               max_memory_allocated=peak,
               train_flash_launches=train_launches,
               train_attention_backend=backend, replay=replay,
               eval_ms=eval_ms, eval_flash_launches=eval_launches,
               eval_attention_backend=eval_backend,
               eval_insitu=dict(layers=[0, L - 1], sound=sound,
                                k_rolled=fault),
               logits_shape=list(logits.shape), logits_finite=finite)
    print("bert_base", json.dumps(rec), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    if any(train_launches.values()) or backend != "plain":
        raise AssertionError(f"training took a flash kernel: "
                             f"{train_launches}, {backend}")
    if (eval_launches != L or eval_backend != "kernel" or sound > 1.0
            or fault <= 1.0 or not finite
            or list(logits.shape) != [B, S, cfg.vocab_size]):
        raise AssertionError(f"eval forward: {rec}")
    del model, logits
    return rec


READING_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


# ------------------------------------------------------- f16 serving
def f16_serve(torch, device, n=4, new=32, max_seq_len=1024, slots=8,
              prompt_range=(100, 600)):
    """GPT-350M in f16 (seeded weights) served through the continuous
    scheduler over ``PagedKVCache(dtype="float16")``: ``n`` threaded
    greedy requests, every paged call in the kernel's f16 form (exactly
    num_layers launches per forward); the greedy answers held to the plain
    route's up to each one's first near-tie (``plain_route_tokens``). Then
    dense ``generate(dtype="float16")`` over [4, 256] + 32, greedy, held
    to its plain route the same way (the dense kernel's f16 forms)."""
    from paddle_tpu_torch.inference import (
        ContinuousGenerateBatchingPredictor,
        PagedKVCache,
    )
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import paged_attention as pa

    model = GPTForCausalLM(gpt_350m(), device=device, dtype=torch.float16,
                           seed=0).eval()
    L = model.config.num_layers
    kv = PagedKVCache(*model._decode_cache_spec(), block_size=32,
                      num_blocks=slots * max_seq_len // 32,
                      dtype="float16", device=device)
    gp = ContinuousGenerateBatchingPredictor(
        model, kv_cache=kv, max_slots=slots, prefill_chunk=64,
        decode_steps=4, max_new_tokens=new, max_seq_len=max_seq_len,
        device=device)
    rng = np.random.default_rng(31)
    V = model.config.vocab_size
    prompts = [rng.integers(0, V, int(rng.integers(*prompt_range)))
               .astype(np.int64) for _ in range(n)]
    outs, errors = {}, {}

    def client(i):
        try:
            outs[i] = gp.infer(prompts[i], timeout=600, max_new_tokens=new)
        except Exception as e:          # reported below, fails the phase
            errors[i] = repr(e)

    pa.paged_decode_attention.launches = 0      # the f16 main path
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        snap = gp.metrics.snapshot()
    finally:
        gp.close()
    wall = time.perf_counter() - t0
    launches = pa.paged_decode_attention.launches   # ... ends here
    forwards = snap.get("prefill_ticks", 0) + 4 * snap.get("decode_ticks", 0)
    if errors or len(outs) != n:
        raise AssertionError(f"f16 serving failed: {errors}")
    for i in range(n):
        if len(outs[i]) != len(prompts[i]) + new or not np.array_equal(
                outs[i][:len(prompts[i])], prompts[i]):
            raise AssertionError(f"f16 request {i}: wrong output")
    if launches != L * forwards or launches == 0:
        raise AssertionError(f"f16 serving: {launches} paged launches for "
                             f"{forwards} forwards of {L} layers")
    plain = plain_route_tokens(
        torch, model, device, {i: (prompts[i], outs[i], False)
                               for i in range(n)}, max_seq_len,
        dtype=torch.float16)
    ids = np.stack([rng.integers(0, V, 256) for _ in range(4)])
    da.decode_attention.launches = 0            # f16 generate() starts
    got = model.generate(ids, max_new_tokens=32, dtype="float16")
    dense_launches = da.decode_attention.launches       # ... ends here
    want = model.generate(ids, max_new_tokens=32, dtype="float16",
                          decode_kernel="plain")
    got, want = got.cpu().numpy(), want.cpu().numpy()
    compared = [first_tie(torch, model, want[b], 256, device)
                for b in range(4)]
    agree = all(np.array_equal(got[b, :256 + c], want[b, :256 + c])
                for b, c in enumerate(compared))
    if not agree or dense_launches != 32 * L:
        raise AssertionError(f"f16 generate(): tokens {agree}, "
                             f"{dense_launches} dense launches")
    rec = dict(requests=n, new_tokens=new, wall_s=wall,
               tok_per_s=n * new / wall, paged_launches=launches,
               forwards=forwards, plain_route=plain,
               generate=dict(dense_launches=dense_launches,
                             compared_tokens=compared,
                             greedy_equal_plain=agree))
    print("f16-serve", json.dumps(rec), flush=True)
    del model
    return rec


# ------------------------------------------------------------ core phase
# f32 golden leg: the table's tolerances are float64's; float32 keeps 24
# bits (unit roundoff 6e-8), and the tables' ops reach ~1e-6 relative
# through their worst conditioning (4 x 4 solves of SPD matrices,
# condition ~10, cumulative products, pinv): a limit 100x over that
GOLDEN_F32_TOL = dict(rtol=2e-4, atol=2e-5)
GOLDEN_F32_GRAD_TOL = 1e-3     # f32 gradients against f64 differences
# jit cases torch cannot capture: the op reads a status back to the host
# inside the library call (a copy a capture refuses)
NOT_CAPTURABLE = {"pinv": "torch.linalg.svd copies its convergence status "
                          "to the host"}


def capture_case(torch, fn, ins, kwargs, eager):
    """``fn`` on the Tensors ``ins`` captured once in a CUDA graph (after
    one warm-up call on a side stream) and replayed; returns whether every
    output of the replay equals ``eager``'s bit for bit."""
    from paddle_tpu_torch import testing as T

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*ins, **kwargs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*ins, **kwargs)
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a._value, b._value)
               for a, b in zip(T.leaves(out), T.leaves(eager)))


def golden_on_card(torch, device, dtypes=("float64", "float32"),
                   capture=True):
    """The golden tables (240 cases, ``testing.load_tables``) on ``device``
    in each of ``dtypes`` (float inputs cast; integer and bool ones as
    they are): eager against numpy (f64 at the table's tolerances, f32 at
    GOLDEN_F32_TOL against numpy on the same f32 inputs), gradients
    against central differences in f64 at the table's tolerances (f32:
    GOLDEN_F32_GRAD_TOL), every output on the device; then, with
    ``capture``, each case the tables run under jit captured in a CUDA
    graph and replayed, bit-equal to eager, but those in NOT_CAPTURABLE.
    A planted fault (``exp`` times 1 + 1e-4, for that check alone) must
    fail the f64 eager check."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import testing as T
    from paddle_tpu_torch.framework import device as pdev

    tables = T.load_tables(os.path.join(ROOT, "tests"), P, P.nn.functional)
    specs = [c for t in tables.values() for c in t]
    prev = pdev._current["place"]
    P.set_device("cpu" if device == "cpu" else "gpu:0")
    dev_type = "cpu" if device == "cpu" else "cuda"
    drawn = [spec["inputs"]() for spec in specs]   # once, for every dtype
    out = {}
    try:
        for dtype in dtypes:
            worst = dict(value=0.0, grad=0.0)
            captured, not_equal, errors = 0, [], {}
            for spec, inputs in zip(specs, drawn):
                opts = spec["opts"]
                kwargs = opts.get("kwargs") or {}
                f32 = dtype == "float32"
                if f32:
                    inputs = [a.astype(np.float32) if np.asarray(a).dtype
                              == np.float64 else a for a in inputs]
                    rtol, atol = (GOLDEN_F32_TOL["rtol"],
                                  GOLDEN_F32_TOL["atol"])
                else:
                    rtol, atol = opts.get("rtol", 1e-6), opts.get("atol",
                                                                  1e-8)
                want = spec["ref"](*[np.copy(a) for a in inputs])
                ins = [P.to_tensor(np.copy(a)) for a in inputs]
                got = spec["fn"](*ins, **kwargs)
                where = f"{spec['id']}:{dtype}"
                for t in T.leaves(got):
                    if t._value.device.type != dev_type:
                        raise AssertionError(f"{where}: output on "
                                             f"{t._value.device}")
                worst["value"] = max(worst["value"], T.compare(
                    got, want, rtol, atol, where))
                if opts.get("check_grad", True):
                    idx = opts.get("grad_indices")
                    if idx is None:
                        idx = [i for i, a in enumerate(inputs)
                               if np.issubdtype(np.asarray(a).dtype,
                                                np.floating)]
                    if idx:
                        g_rtol = (GOLDEN_F32_GRAD_TOL if f32
                                  else opts.get("grad_rtol", 5e-4))
                        worst["grad"] = max(worst["grad"], T.check_grad(
                            where, spec["fn"], spec["ref"], inputs, kwargs,
                            idx, g_rtol, opts.get("grad_atol", 1e-6),
                            opts.get("grad_eps", 1e-5),
                            opts.get("grad_samples", 6), P.to_tensor,
                            ref_inputs=[np.asarray(a, np.float64)
                                        if np.asarray(a).dtype == np.float32
                                        else a for a in inputs]))
                if (capture and opts.get("check_jit", True)
                        and spec["id"] not in NOT_CAPTURABLE):
                    try:
                        if capture_case(torch, spec["fn"], ins, kwargs, got):
                            captured += 1
                        else:
                            not_equal.append(spec["id"])
                    except Exception as e:   # reported below, fails
                        errors[spec["id"]] = repr(e)[:200]
            rec = dict(dtype=dtype, cases=len(specs),
                       worst_over_limit=worst["value"],
                       worst_grad_dev=worst["grad"], captured=captured,
                       not_capturable=sorted(NOT_CAPTURABLE),
                       capture_not_equal=not_equal, capture_errors=errors)
            print("golden", json.dumps(rec), flush=True)
            if not_equal or errors:
                raise AssertionError(f"golden capture: {rec}")
            out[dtype] = rec
        spec, inputs = next((s, d) for s, d in zip(specs, drawn)
                            if s["id"] == "exp")
        faulty = P.ops.unary_op(lambda v: torch.exp(v) * (1 + 1e-4), "exp")
        try:
            T.compare(faulty(P.to_tensor(inputs[0])), spec["ref"](inputs[0]),
                      1e-6, 1e-8, "planted exp")
            planted_failed = False
        except AssertionError:
            planted_failed = True
        print("golden-planted", json.dumps(dict(failed=planted_failed)),
              flush=True)
        if not planted_failed:
            raise AssertionError("the planted exp fault passed the check")
        out["planted_failed"] = planted_failed
    finally:
        pdev._current["place"] = prev
    return out


OP_STACK_LR = 0.5   # the eager stack's SGD rate (bf16 weights, one batch)


def op_stack_weights(P, model):
    """The model's weights as op-layer Tensors (copies) that need a
    gradient, by the model's parameter names."""
    return {n: P.to_tensor(p.detach(), stop_gradient=False)
            for n, p in model.named_parameters()}


def op_stack_loss(P, w, ids, labels, cfg):
    """The GPT forward and its mean token cross entropy written with the op
    layer: the embedding gather, RoPE, RMSNorm (mean square in f32 from
    ``square`` / ``mean`` / ``rsqrt``), the fused qkv product,
    ``F.flash_attention`` on Tensors, SwiGLU (``a * sigmoid(a) * b``), the
    tied head and ``log(sum(exp(logits - max))) + max - target``."""
    F = P.nn.functional
    B, S = ids.shape
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    D = cfg.hidden_size // H
    x = w["gpt.embed_tokens.weight"][ids]
    inv = 1.0 / (10000.0 ** (P.arange(0, D, 2, dtype="float32") / D))
    freqs = P.arange(S).astype("float32").unsqueeze(-1) * inv
    emb = P.concat([freqs, freqs], axis=-1).reshape([1, S, 1, D])
    cos, sin = P.cos(emb).astype(x.dtype), P.sin(emb).astype(x.dtype)

    def rope(t):
        rot = P.concat([-t[..., D // 2:], t[..., :D // 2]], axis=-1)
        return t * cos + rot * sin

    def rms(h, weight):
        h32 = h.astype("float32")
        ms = P.mean(P.square(h32), axis=-1, keepdim=True)
        return (h32 * P.rsqrt(ms + 1e-6)).astype(h.dtype) * weight

    for i in range(cfg.num_layers):
        pre = f"gpt.blocks.{i}."
        h = rms(x, w[pre + "ln1.weight"])
        qkv = P.matmul(h, w[pre + "attn.qkv_proj.weight"])
        q, k, v = P.split(qkv, [H * D, Hkv * D, Hkv * D], axis=-1)
        q = rope(q.reshape([B, S, H, D]))
        k = rope(k.reshape([B, S, Hkv, D]))
        o, _ = F.flash_attention(q, k, v.reshape([B, S, Hkv, D]),
                                 causal=True)
        x = x + P.matmul(o.reshape([B, S, H * D]),
                         w[pre + "attn.out_proj.weight"])
        h = rms(x, w[pre + "ln2.weight"])
        a, b = P.split(P.matmul(h, w[pre + "mlp.gate_up.weight"]), 2,
                       axis=-1)
        x = x + P.matmul(a * P.sigmoid(a) * b, w[pre + "mlp.down.weight"])
    x = rms(x, w["gpt.ln_f.weight"])
    logits = P.matmul(x, w["gpt.embed_tokens.weight"], transpose_y=True)
    m = P.max(logits, axis=-1, keepdim=True).detach()
    lse = P.log(P.sum(P.exp(logits - m), axis=-1)) + m.squeeze(-1)
    tgt = P.take_along_axis(logits, labels.unsqueeze(-1), axis=-1)
    return P.mean(lse - tgt.squeeze(-1))


def grad_rel(torch, a, b):
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


GRAD_REL_TOL = 5e-2   # op stack vs model gradients, per parameter (bf16)


def eager_stack(torch, fa, device, config=None, B=8, S=1024, steps=3,
                seed=12, dtype=None):
    """GPT-350M's 24 decoder blocks at full width (B 8, S 1024, bf16,
    seeded weights of the port's ``gpt_350m()`` model) trained eagerly
    through the paddle-style surface (``op_stack_loss``): ``steps`` steps
    of ``loss.backward()``, each updating in place under ``no_grad`` (SGD,
    OP_STACK_LR) and then ``clear_grad()``. Held: the first loss within
    LOSS_REL_TOL of the model's own forward on the same batch and every
    gradient within GRAD_REL_TOL (relative L2) of the model's own backward;
    the loss falls; the flash forward, dq and dk/dv kernels launch
    num_layers times each per step. The model's own eager steps (same
    kernels, same update) are timed beside the stack's. Then one forward
    and backward of the stack over f32 copies of the weights under
    ``auto_cast(level="O2")``: the matmuls' outputs bf16, the black list
    (exp, mean, square, log, sum) f32, the loss within LOSS_REL_TOL of the
    bf16 stack's and the gradients f32."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.framework import device as pdev
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m

    cfg = config or gpt_350m()
    dtype = dtype or torch.bfloat16
    model = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=0)
    L = cfg.num_layers
    g = torch.Generator(device=device).manual_seed(seed)
    ids_t = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                          device=device)
    ids_t, labels_t = ids_t[:, :-1], ids_t[:, 1:]
    prev = pdev._current["place"]
    P.set_device("cpu" if device == "cpu" else "gpu:0")
    sync = (torch.cuda.synchronize if device != "cpu" else (lambda: None))
    try:
        # the model's own forward and backward: the reference
        t0 = time.perf_counter()
        _, ref_loss = model(ids_t, labels_t)
        ref_loss.backward()
        sync()
        ref_grads = {n: p.grad for n, p in model.named_parameters()}
        w = op_stack_weights(P, model)
        ids, labels = P.to_tensor(ids_t), P.to_tensor(labels_t)
        losses, step_ms, launches = [], [], []
        for step in range(steps):
            before = flash_launches(fa)
            sync()
            t0 = time.perf_counter()
            loss = op_stack_loss(P, w, ids, labels, cfg)
            loss.backward()
            if step == 0:
                grads = {n: t.grad._value for n, t in w.items()}
                rel = {n: grad_rel(torch, grads[n], ref_grads[n])
                       for n in grads}
            with P.no_grad():
                for t in w.values():
                    t.subtract_(t.grad * OP_STACK_LR)
                    t.clear_grad()
            losses.append(float(loss))
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = flash_launches(fa)
            launches.append({k: after[k] - before[k] for k in after})
        del grads
        # the model's own eager steps, the same update
        model_ms = []
        for step in range(steps):
            sync()
            t0 = time.perf_counter()
            model.zero_grad(set_to_none=True)
            _, loss_m = model(ids_t, labels_t)
            loss_m.backward()
            with torch.no_grad():
                for p in model.parameters():
                    p.sub_(p.grad * OP_STACK_LR)
            sync()
            model_ms.append((time.perf_counter() - t0) * 1e3)
        model.zero_grad(set_to_none=True)
        ref_grads = None
        # O2 over f32 copies of the (updated) weights
        w32 = {n: P.to_tensor(t._value.float(), stop_gradient=False)
               for n, t in w.items()}
        with P.amp.auto_cast(level="O2", dtype="bfloat16"):
            probe = P.matmul(w32["gpt.ln_f.weight"].unsqueeze(0),
                             w32["gpt.blocks.0.mlp.down.weight"].T)
            black = P.exp(w32["gpt.ln_f.weight"])
            o2_loss = op_stack_loss(P, w32, ids, labels, cfg)
        o2_loss.backward()
        bf16_loss = float(op_stack_loss(P, w, ids, labels, cfg).detach())
        o2 = dict(loss=float(o2_loss), loss_dtype=str(o2_loss.dtype),
                  bf16_stack_loss=bf16_loss,
                  matmul_dtype=str(probe.dtype), exp_dtype=str(black.dtype),
                  grad_dtype=str(w32["gpt.ln_f.weight"].grad.dtype))
    finally:
        pdev._current["place"] = prev
    per_step = {k: L for k in ("fwd", "dq", "dkv")}
    model_loss = float(ref_loss.detach())
    rec = dict(layers=L, B=B, S=S, losses=losses, model_loss=model_loss,
               loss_rel=abs(losses[0] - model_loss) / abs(model_loss),
               grad_rel_max=max(rel.values()),
               grad_rel_worst=max(rel, key=rel.get),
               step_ms=step_ms, model_step_ms=model_ms,
               flash_launches=launches, o2=o2)
    print("eager-stack", json.dumps(rec), flush=True)
    ok = (rec["loss_rel"] <= LOSS_REL_TOL
          and rec["grad_rel_max"] <= GRAD_REL_TOL
          and losses[-1] < losses[0]
          and all(x == per_step for x in launches)
          and o2["matmul_dtype"] == "torch.bfloat16"
          and o2["exp_dtype"] == "torch.float32"
          and o2["grad_dtype"] == "torch.float32"
          and abs(o2["loss"] - bf16_loss) <= LOSS_REL_TOL * abs(bf16_loss))
    if not ok:
        raise AssertionError(f"eager op-layer stack: {rec}")
    del model, w, w32
    return rec


def wrapper_costs(torch, device, reps=2000):
    """The op layer's host cost per op, in microseconds of host clock per
    call (``reps`` calls, then a synchronise): ``a + b`` on [1024] f32 and
    ``matmul`` on [64, 64] f32, with and without a gradient, through the
    Tensor wrapper against the same torch call on bare tensors."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.framework import device as pdev

    prev = pdev._current["place"]
    P.set_device("cpu" if device == "cpu" else "gpu:0")
    sync = (torch.cuda.synchronize if device != "cpu" else (lambda: None))
    out = {}
    try:
        for name, shapes, op, bare in (
                ("add_1024", ([1024], [1024]), lambda a, b: a + b,
                 torch.add),
                ("matmul_64", ([64, 64], [64, 64]), P.matmul,
                 torch.matmul)):
            for grad in (False, True):
                vals = [torch.randn(s, device=device, requires_grad=grad)
                        for s in shapes]
                wrapped = [P.Tensor(v) for v in vals]

                def timed(fn, args):
                    for _ in range(50):
                        fn(*args)
                    sync()
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn(*args)
                    sync()
                    return (time.perf_counter() - t0) / reps * 1e6

                key = f"{name}{'_grad' if grad else ''}"
                out[key] = dict(wrapped_us=timed(op, wrapped),
                                torch_us=timed(bare, vals))
    finally:
        pdev._current["place"] = prev
    print("wrapper-cost", json.dumps(out), flush=True)
    return out


RESNET_B = 128          # bench.py bench_resnet on the accelerator
RESNET_HW = 224
RESNET_EVAL_B = 32
# NCHW f32 eval logits against NHWC f32 on the same seeded weights: cuDNN
# sums in other orders in the two layouts (TF32 off), and fifty batch
# norms carry the rounding on; the largest |diff| over the largest |logit|
# read 2.6e-5 on an H100 (logits ~4), and a layout fault gives O(1)
RESNET_LAYOUT_TOL = 1e-4


def conv_linear_macs(torch, model, x):
    """Multiply-accumulates of one forward of ``model`` on ``x``, from the
    shapes its Conv2D and Linear layers see (forward hooks)."""
    from paddle_tpu_torch import nn

    total = [0]

    def conv_hook(layer, inputs, out):
        o = out.shape
        k = layer.weight.shape
        total[0] += (int(np.prod(o)) * k[1] * int(np.prod(k[2:])))

    def linear_hook(layer, inputs, out):
        total[0] += int(np.prod(out.shape)) * layer.weight.shape[0]

    hooks = [m.register_forward_post_hook(
        conv_hook if isinstance(m, nn.Conv2D) else linear_hook)
        for m in model.sublayers()
        if isinstance(m, (nn.Conv2D, nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def resnet_state(torch, model, opt):
    """Copies of every parameter, batch-norm statistic and velocity."""
    out = {k: v._value.detach().clone()
           for k, v in model.state_dict().items()}
    for p in model.parameters():
        out["velocity:" + opt._param_name(p._value)] = (
            opt._accumulators["velocity"][id(p._value)].detach().clone())
    return out


def resnet_profile(torch, one_step):
    """One step's cast and layout-copy ops (a body, by aten op) and the
    kernels of the step by kind (conv, reduction, elementwise, copy)."""
    from torch.profiler import ProfilerActivity, profile

    one_step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_step()
    ops = {e.key: e.count for e in prof.key_averages()
           if e.key in ("aten::_to_copy", "aten::contiguous", "aten::clone",
                        "aten::copy_", "aten::permute", "aten::movedim",
                        "aten::convolution", "aten::cudnn_convolution",
                        "aten::convolution_backward")}
    kinds = {}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0):
            continue
        name = e.key
        kind = ("conv" if any(t in name for t in (
            "conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "nhwc",
            "gemm", "nvjet", "cutlass", "sm90")) else
            "copy / cast" if any(t in name for t in ("copy", "Copy",
                                                     "transpose"))
            else "reduction" if "reduce" in name
            else "elementwise" if "elementwise" in name else "other")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return dict(aten_ops=ops, device_ms_by_kind=kinds)


def resnet50_phase(torch, device, timed=8, seed=14):
    """ResNet-50 trained as bench_resnet trains it (BASELINE config 1),
    captured; replays held to bodies bit for bit; see the module
    docstring (phase 20)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp, nn, optimizer
    from paddle_tpu_torch.framework import device as pdev
    from paddle_tpu_torch.jit import TrainStep

    prev_place = pdev._current["place"]
    prev_det = torch.backends.cudnn.deterministic
    P.set_device("cpu" if device == "cpu" else "gpu:0")
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        P.seed(seed)
        model = P.vision.models.resnet50(num_classes=1000,
                                         data_format="NHWC")
        amp.decorate(model, level="O2", dtype="bfloat16")
        loss_fn = nn.CrossEntropyLoss()
        opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=model.parameters(),
                                 multi_precision=True)
        step = TrainStep(model, lambda out, y: loss_fn(out, y), opt)
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn(RESNET_B, RESNET_HW, RESNET_HW, 3, device=device,
                        generator=gen).bfloat16()
        y = torch.randint(0, 1000, (RESNET_B,), device=device,
                          generator=gen)
        xt, yt = P.Tensor(x), P.Tensor(y)
        n_params = sum(p.size for p in model.parameters())
        torch.cuda.synchronize()
        print(f"resnet50 model: {n_params / 1e6:.1f} M params, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        macs = conv_linear_macs(torch, model.eval(), xt[:1])
        model.train()
        step_flops = 3 * 2 * macs * RESNET_B

        start = step.export_state()
        with step._eager():     # the reference: 1 + 2 timed bodies
            body_losses, body_s = timed_steps(torch, step, (xt, yt), {}, 1,
                                              2)
        body_state = resnet_state(torch, model, opt)
        step.import_state(start)
        del start
        torch.cuda.reset_peak_memory_stats()
        losses = [step(xt, yt) for _ in range(3)]   # capture, 2 replays
        graph_state = resnet_state(torch, model, opt)
        losses_equal = bool(torch.equal(torch.stack(losses),
                                        torch.stack(body_losses)))
        unequal = sorted(k for k in body_state
                         if not torch.equal(body_state[k], graph_state[k]))
        n_stats = sum(k.endswith(("_mean", "_variance")) for k in body_state)
        n_compared = len(body_state)
        del body_state, graph_state
        more, step_s = timed_steps(torch, step, (xt, yt), {}, 0, timed)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v.float()) for v in losses + more]
        body_losses = [float(v.float()) for v in body_losses]
        (prog,) = step._programs.values()

        def one_step():
            step(xt, yt)
            torch.cuda.synchronize()

        with step._eager():
            body = profile_call(torch, one_step)
            body_ops = resnet_profile(torch, one_step)
        replay = profile_call(torch, one_step)
        replay_kinds = resnet_profile(torch, one_step)["device_ms_by_kind"]
        replay["graph_device_ms"] = replay_device_ms(torch,
                                                     prog.capture.graph)
        rec = dict(B=RESNET_B, hw=RESNET_HW, data_format="NHWC",
                   params=n_params, body_steps=3, body_timed=2,
                   timed=timed,
                   cudnn_deterministic=True,
                   losses=losses, body_losses=body_losses,
                   replay_losses_equal_body=losses_equal,
                   replay_state_unequal=unequal,
                   compared_tensors=n_compared,
                   bn_statistics_compared=n_stats,
                   step_ms=step_s * 1e3, body_step_ms=body_s * 1e3,
                   images_per_s=RESNET_B / step_s,
                   body_images_per_s=RESNET_B / body_s,
                   forward_macs_per_image=macs,
                   step_flops=step_flops,
                   flops_method="3 x 2 x (conv + linear MACs from the "
                                "layers' shapes) x B",
                   bf16_peak_share=step_flops / step_s
                   / PEAK_FLOPS["bfloat16"],
                   max_memory_allocated=peak,
                   capture_ms=prog.capture.seconds * 1e3,
                   graph_pool_bytes=pool_bytes(torch, step._pool),
                   body=body, replay=replay, body_ops=body_ops,
                   replay_device_ms_by_kind=replay_kinds)
        del step, opt, prog, model
        release(torch)
        rec["layout_check"] = resnet_layouts(torch, device, seed)
        release(torch)
    finally:
        torch.backends.cudnn.deterministic = prev_det
        pdev._current["place"] = prev_place
    print("resnet50", json.dumps(rec), flush=True)
    if not all(np.isfinite(rec["losses"])):
        raise AssertionError(f"resnet50 losses not finite: {rec['losses']}")
    if not losses_equal or unequal:
        raise AssertionError(
            f"resnet50 replays differ from bodies: losses "
            f"{rec['losses'][:3]} vs {body_losses}, unequal {unequal[:8]}")
    if rec["layout_check"]["rel"] > RESNET_LAYOUT_TOL:
        raise AssertionError(f"resnet50 NCHW vs NHWC: {rec['layout_check']}")
    return rec


def resnet_layouts(torch, device, seed):
    """Eval logits of ResNet-50 in NCHW f32 and in NHWC f32 with the same
    freshly seeded weights and, as running statistics, the eval batch's own
    (one training-mode forward of the NHWC model at momentum 0; B
    RESNET_EVAL_B, seeded images), so that the logits are O(1): max |diff|
    over max |logit|."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.nn.layer_conv_norm import _BatchNormBase

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(RESNET_EVAL_B, 3, RESNET_HW, RESNET_HW, device=device,
                    generator=gen)
    P.seed(seed)
    nhwc = P.vision.models.resnet50(num_classes=1000, data_format="NHWC")
    bns = [m for m in nhwc.sublayers() if isinstance(m, _BatchNormBase)]
    for m in bns:
        m._momentum = 0.0
    with torch.no_grad():
        nhwc(P.Tensor(x.permute(0, 2, 3, 1).contiguous()))
    for m in bns:
        m._momentum = 0.9
    nchw = P.vision.models.resnet50(num_classes=1000, data_format="NCHW")
    nchw.set_state_dict(nhwc.state_dict())
    out = {}
    for fmt, m, xi in (("NCHW", nchw, x),
                       ("NHWC", nhwc, x.permute(0, 2, 3, 1).contiguous())):
        m.eval()
        with torch.no_grad():
            out[fmt] = m(P.Tensor(xi))._value.float()
    del nchw, nhwc
    diff = float((out["NCHW"] - out["NHWC"]).abs().max())
    scale = float(out["NHWC"].abs().max())
    return dict(B=RESNET_EVAL_B, weights="seeded", statistics="the batch's",
                max_abs_diff=diff, max_abs_logit=scale, rel=diff / scale,
                limit=RESNET_LAYOUT_TOL,
                finite=bool(torch.isfinite(out["NCHW"]).all()))


def nn_fillins(torch, device, capture=True):
    """The recurrent layers, the layer and functional fill-ins and grid
    sampling on ``device`` against the same calls on the CPU, f64 and f32,
    outputs and gradients (``tests/nn_fillin_cases.py``, its limits), and
    each case without a host read captured in a CUDA graph and replayed,
    bit-equal to eager."""
    import paddle_tpu_torch as P

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import nn_fillin_cases as C
    finally:
        sys.path.pop(0)
    place = "cpu" if device == "cpu" else "gpu:0"
    cap = ((lambda fn, ins, eager: capture_case(torch, fn, ins, {}, eager))
           if capture else None)
    res = C.run_cases(P, place, capture_case=cap)
    rec = dict(cases=len(C.CASES), tol=C.TOL, worst={
        dt: max(res[dt].values()) for dt in ("float64", "float32")},
        by_case=res)
    print("nn-fillins", json.dumps(rec), flush=True)
    return rec


def cross_length_attention(torch, device, B=2, S=256, T=384, H=16, D=64):
    """q and k of different lengths (and of batches B and 1), which JAX's
    Pallas kernel refuses and its dispatcher sends to the XLA route:
    ``F.flash_attention`` and ``F.flashmask_attention`` on CUDA take the
    plain route, reported "plain": in bf16 bit-equal to ``_sdpa_core``
    called directly on the same tensors; in f32 within 1e-4 of the largest
    |output| of the same call on the CPU (sums in another order). Head
    dims the kernels do not take (32, 96) on self-attention shapes take the
    plain route too, reported "plain", with no kernel launch, bit-equal to
    ``_sdpa_core``."""
    import importlib

    import paddle_tpu_torch as P

    F = P.nn.functional
    fam = importlib.import_module(
        "paddle_tpu_torch.nn.functional.flash_attention")
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn(B, S, H, D, generator=g)
    scale = 1.0 / np.sqrt(D)
    rec = {}

    def call(form, q, k, v, sri, causal):
        if form == "flash":
            return F.flash_attention(q, k, v, causal=causal)[0]
        return F.flashmask_attention(q, k, v, sri, causal=causal)

    for kb, causal in ((B, True), (B, False), (1, True)):
        k = torch.randn(kb, T, H, D, generator=g)
        v = torch.randn(kb, T, H, D, generator=g)
        sri = torch.sort(torch.randint(0, S + 1, (kb, 1, T, 1 if causal
                                                   else 2), generator=g),
                         -1).values.int()
        sc = sri.to(device)
        half = [t.to(device, torch.bfloat16) for t in (q, k, v)]
        for form in ("flash", "flashmask"):
            out = call(form, *half, sc, causal)
            backend = F.get_last_attention_backend()
            mask = (None if form == "flash" else
                    P.ops.flash_attention.flashmask_allowed(S, sc, causal))
            plain = fam._sdpa_core(*half, mask, scale,
                                   causal and form == "flash", 0.0, False)
            got32 = call(form, *(t.to(device) for t in (q, k, v)), sc,
                         causal)
            cpu = call(form, q, k, v, sri, causal)
            rec[f"{form}:kb{kb}:{'causal' if causal else 'full'}"] = dict(
                backend=backend, f32_backend=F.get_last_attention_backend(),
                equal_plain=bool(torch.equal(out, plain)),
                f32_cpu_rel_diff=float((got32.cpu() - cpu).abs().max()
                                       / cpu.abs().max()))
    for d in (32, 96):      # head dims the kernels do not take
        x = torch.randn(1, 128, 4, d, generator=g).to(device, torch.bfloat16)
        before = P.ops.flash_attention.flash_fwd.launches
        out = F.flash_attention(x, x, x, causal=True)[0]
        fa_launches = P.ops.flash_attention.flash_fwd.launches - before
        plain = fam._sdpa_core(x, x, x, None, 1.0 / np.sqrt(d), True, 0.0,
                               False)
        rec[f"head_dim_{d}"] = dict(
            backend=F.get_last_attention_backend(), launches=fa_launches,
            equal_plain=bool(torch.equal(out, plain)))
    print("cross-length", json.dumps(rec), flush=True)
    bad = {k: r for k, r in rec.items() if not k.startswith("head_dim") and (
        r["backend"] != "plain" or r["f32_backend"] != "plain"
        or not r["equal_plain"] or r["f32_cpu_rel_diff"] > 1e-4)}
    bad.update({k: r for k, r in rec.items() if k.startswith("head_dim")
                and (r["backend"] != "plain" or r["launches"]
                     or not r["equal_plain"])})
    if bad:
        raise AssertionError(f"cross-length attention: {bad}")
    return rec


def core_phase(torch, fa, device):
    """The paddle-style core on the card: the golden tables (f64 and f32,
    eager, gradients, captured), the nn fill-ins (``nn_fillins``), the
    cross-length attention route, the eager GPT-350M stack through the op
    layer, the wrapper's host cost per op."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        golden = golden_on_card(torch, device)
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)
    fillins = nn_fillins(torch, device)
    cross = cross_length_attention(torch, device)
    stack = eager_stack(torch, fa, device)
    costs = wrapper_costs(torch, device)
    return dict(golden=golden, nn_fillins=fillins, cross_length=cross,
                eager_stack=stack, wrapper_cost=costs)


# ------------------------------------------------------------ script phase
# GPT-350M trained as a Paddle script trains it: a map-style dataset of
# seeded token windows behind a worker DataLoader, Model.fit checkpointed,
# preempted, resumed, then exported and served from the export.
SCRIPT = dict(B=8, S=1024, windows=96, eval_windows=16, every=4,
              preempt_after=6, seed=16, workers=2)
SCRIPT_DIR = os.path.join(ROOT, "_script")
# exported program vs eager forward, max |dlogit| / max |logit|: each side
# rounds its logits to bf16 once (2^-8 relative at most), and f32 sums in
# another order may flip a rounding on either side
SCRIPT_LOGIT_TOL = 2.0 ** -6

SERVE_SCRIPT = r'''
import json, sys, time
import numpy as np
import torch
import paddle_tpu_torch as P
from paddle_tpu_torch.ops import flash_attention as fa

art, ref_path, ids_path, out, device = sys.argv[1:6]
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
cfg = P.inference.Config(art)
if device == "cpu":
    cfg.disable_gpu()
t0 = time.perf_counter()
pred = P.inference.create_predictor(cfg)
sync()
rec = {"load_s": time.perf_counter() - t0}
ids = np.load(ids_path)
refs = np.load(ref_path)
for name, x in (("b8", ids), ("b2", ids[:2])):
    before = fa.flash_fwd.launches
    got = torch.from_numpy(pred.run([x])[0])
    rec[name + "_launches"] = fa.flash_fwd.launches - before
    ref = torch.from_numpy(refs[: len(x)]).view(torch.bfloat16).float()
    rec[name + "_shape"] = list(got.shape)
    rec[name + "_max_abs_diff"] = float((got - ref).abs().max())
    rec[name + "_max_abs_ref"] = float(ref.abs().max())
    rec[name + "_finite"] = bool(torch.isfinite(got).all())
walls = []
for _ in range(3):
    t0 = time.perf_counter()
    pred.run([ids])
    walls.append(time.perf_counter() - t0)
rec["predictor_ms"] = float(np.median(walls)) * 1e3
layer = pred._layer
x = torch.as_tensor(ids, device=device)
layer(x)
sync()
walls = []
for _ in range(3):
    t0 = time.perf_counter()
    layer(x)
    sync()
    walls.append(time.perf_counter() - t0)
rec["program_ms"] = float(np.median(walls)) * 1e3
rec["peak_bytes"] = P.device.cuda.max_memory_allocated()
rec["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "paddle_tpu"))
with open(out, "w") as f:
    json.dump(rec, f)
'''


def gpt_lm_loss(logits, labels):
    """The LM loss over GPT's logits: ``ParallelCrossEntropy`` per token (in
    the logits' dtype, as the model's own loss), averaged in f32 so that
    equal losses mean more than equal bf16 roundings."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ParallelCrossEntropy)

    per = ParallelCrossEntropy()(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1))
    return per.float().mean()


def script_loader(P, vocab, n, seed, c=SCRIPT):
    """A DataLoader of ``n`` seeded token windows (ids, next ids), in a
    seeded order, ``c["workers"]`` worker processes, batches of B."""
    io_ = P.io
    ids = np.random.default_rng(seed).integers(0, vocab, (n, c["S"] + 1))

    class TokenWindows(io_.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return ids[i, :-1], ids[i, 1:]

    class SeededSampler(io_.Sampler):
        def __iter__(self):
            return iter(np.random.default_rng(seed).permutation(n).tolist())

        def __len__(self):
            return n

    return io_.DataLoader(TokenWindows(), batch_sampler=io_.BatchSampler(
        sampler=SeededSampler(), batch_size=c["B"]),
        num_workers=c["workers"])


def script_model(P, c=SCRIPT, device="cuda"):
    """``paddle.Model`` over GPT-350M at full width, seeded, O2 bf16, with
    the train phase's AdamW, and the training loader."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m

    cfg = gpt_350m()
    net = GPTForCausalLM(cfg, device=device, seed=c["seed"])
    amp.decorate(net, level="O2", dtype="bfloat16")
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters(),
                          weight_decay=0.01, multi_precision=True)
    model = P.Model(net).prepare(opt, gpt_lm_loss)
    return model, script_loader(P, cfg.vocab_size, c["windows"], c["seed"],
                                c)


def script_fit(P, model, loader, ckpt_dir, sigterm_after=None, c=SCRIPT):
    """``model.fit`` over ``loader`` checkpointed into ``ckpt_dir`` every
    ``c["every"]`` steps, SIGTERM sent to this process after
    ``sigterm_after`` steps when given; (record, exit code or None)."""
    import signal

    from paddle_tpu_torch.framework.checkpoint import PreemptionExit
    from paddle_tpu_torch.hapi.callbacks import Callback, MonitorCallback

    losses, t = [], {}

    class Recorder(Callback):
        def on_begin(self, mode, logs=None):
            t["begin"] = time.perf_counter()

        def on_batch_end(self, mode, step, logs=None):
            losses.append(logs["loss"][0])
            if sigterm_after is not None and len(losses) == sigterm_after:
                os.kill(os.getpid(), signal.SIGTERM)

    mon = MonitorCallback(samples_per_step=c["B"],
                          tokens_per_step=c["B"] * c["S"])
    code = None
    t0 = time.perf_counter()
    try:
        model.fit(loader, epochs=1, verbose=0, callbacks=[Recorder(), mon],
                  checkpoint_dir=ckpt_dir, checkpoint_every=c["every"],
                  checkpoint_keep_last=2)
    except PreemptionExit as e:
        code = e.code
    step = model._train_step
    readings = monitor_readings(mon.monitor)
    return dict(losses=losses, fit_s=time.perf_counter() - t0,
                until_first_batch_s=t.get("begin", t0) - t0,
                step_s=readings.pop("step_s"),
                batch_s=readings.pop("batch_s"),
                data_wait_s=readings.pop("data_wait_s"),
                checkpoints=readings.pop("checkpoints"), monitor=readings,
                captures=step.captures, replays=step.replays,
                eager=model._train_step_broken), code


def monitor_series(mon, name):
    """{label values: value} of a StepMonitor's series ``name`` (a
    histogram's value: its observation count)."""
    for fam in mon.registry.families():
        if fam.name == name:
            return {labels: (sum(child.histogram_state()[0])
                             if fam.type == "histogram" else child.value)
                    for labels, child in fam.children()}
    return {}


def monitor_readings(mon):
    """What a StepMonitor's registry and tracer hold: each step's seconds
    (its ``h2d`` span's start to its ``step`` span's end, what
    ``paddle_train_step_seconds`` observes: ``TrainStep.__call__`` only),
    each batch's seconds after the first (its ``data_wait`` span's end to
    the next ``callbacks`` span's end: the fit loop's batch begin to batch
    end, ``Model.train_batch``'s host work and the callbacks included), the
    loader's waits (``data_wait``), the checkpoint phases as they ended (phase, seconds),
    the phase histogram's observations, the checkpoints by result,
    ``steps_total``, the monitor's step count and goodput."""
    spans = mon.tracer.spans()
    h2d = {sp.tags["step"]: sp.start_us for sp in spans if sp.name == "h2d"}
    waits = [sp.end_us for sp in spans if sp.name == "data_wait"]
    ends = sorted(sp.end_us for sp in spans if sp.name == "callbacks")
    batches = [(ends[i] - w) / 1e6 for w in waits
               for i in [bisect.bisect_right(ends, w)] if i < len(ends)]
    ckpt = sorted((sp for sp in spans if sp.name.startswith("ckpt_")),
                  key=lambda sp: sp.end_us)
    return dict(
        step_s=[(sp.end_us - h2d.get(sp.tags["step"], sp.start_us)) / 1e6
                for sp in spans if sp.name == "step"],
        batch_s=batches,
        data_wait_s=[sp.duration_us / 1e6 for sp in spans
                     if sp.name == "data_wait"],
        checkpoints=[(sp.name[len("ckpt_"):], sp.duration_us / 1e6)
                     for sp in ckpt],
        checkpoint_observations={k[0]: int(v) for k, v in monitor_series(
            mon, "paddle_train_checkpoint_seconds").items()},
        checkpoint_results={k[0]: int(v) for k, v in monitor_series(
            mon, "paddle_train_checkpoints_total").items()},
        steps_total=int(monitor_series(mon, "paddle_train_steps_total")
                        .get((), 0)),
        step=mon.last_fields.get("step"),
        goodput=mon.last_fields.get("goodput"),
        anomalies=[e.kind for e in mon.anomalies])


def script_worker(mode, ckpt_dir, out, c=SCRIPT, device="cuda"):
    """A fresh process's fit (``--script-fit``): "preempt" takes SIGTERM
    after ``preempt_after`` steps and exits with its flush's code;
    "resume" resumes from ``ckpt_dir``."""
    import torch

    import paddle_tpu_torch as P

    model, loader = script_model(P, c, device)
    rec, code = script_fit(P, model, loader, ckpt_dir,
                           c["preempt_after"] if mode == "preempt" else None,
                           c)
    torch.cuda.synchronize()
    rec["process_s"] = time.perf_counter() - PROCESS_T0
    with open(out, "w") as f:
        json.dump(rec, f)
    if code is not None:
        raise SystemExit(code)


def run_script_worker(mode, ckpt_dir, timeout=240):
    """(exit code, its record, wall seconds) of ``script_worker`` in a
    fresh process."""
    out = os.path.join(SCRIPT_DIR, f"{mode}.json")
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--script-fit", mode, "--script-dir", ckpt_dir,
                            "--script-out", out], capture_output=True,
                           text=True, timeout=timeout, cwd=ROOT)
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else e.stderr
        raise AssertionError(f"script worker {mode} still ran after "
                             f"{timeout} s: {(err or '')[-3000:]}") from e
    wall = time.perf_counter() - t0
    if not os.path.exists(out):
        raise AssertionError(f"script worker {mode} wrote nothing (exit "
                             f"{r.returncode}): {r.stderr[-3000:]}")
    with open(out) as f:
        return r.returncode, json.load(f), wall


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def state_equal(torch, a, b):
    """True when two state dicts (tensors, Tensors, numbers, dicts) hold
    equal values, tensors bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(state_equal(torch, a[k], b[k]) for k in a))
    a, b = getattr(a, "_value", a), getattr(b, "_value", b)
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))
    return a == b


def script_phase(torch, fa, device, train_rec, c=SCRIPT):
    """The ``script`` phase (module docstring). ``train_rec``: the train
    phase's record, whose replayed TrainStep this fit is set beside."""
    import shutil

    import paddle_tpu_torch as P
    from paddle_tpu_torch.framework.checkpoint import (CheckpointManager,
                                                       latest_step)

    shutil.rmtree(SCRIPT_DIR, ignore_errors=True)
    os.makedirs(SCRIPT_DIR)
    full_dir = os.path.join(SCRIPT_DIR, "full")
    pre_dir = os.path.join(SCRIPT_DIR, "preempted")
    steps = c["windows"] // c["B"]
    walls, last = {}, [time.perf_counter()]

    def lap(name):
        """The wall seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        walls[name], last[0] = now - last[0], now

    model, loader = script_model(P, c, device)
    net, opt = model.network, model._optimizer
    torch.cuda.synchronize()
    lap("build")

    # 1-2: the uninterrupted run, checkpointed (the main path)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0   # main path
    fa.flash_bwd_dkv.launches = 0
    full, code = script_fit(P, model, loader, full_dir, c=c)
    launches = flash_launches(fa)                          # main path ends
    peak = torch.cuda.max_memory_allocated()
    step = model._train_step
    (prog,) = step._programs.values()
    replayed_step_s = full["step_s"][1:]
    snapshots = [s for p, s in full["checkpoints"] if p == "snapshot"]
    writes = [s for p, s in full["checkpoints"] if p in ("serialize",
                                                         "commit")]
    ckpt_bytes = os.path.getsize(os.path.join(
        full_dir, f"step_{steps:010d}", "data_r0.npz"))
    lap("fit")

    # 5: paddle.save / paddle.load of the state dicts, on the card
    t0 = time.perf_counter()
    P.save(net.state_dict(), os.path.join(SCRIPT_DIR, "net.pdparams"))
    P.save(opt.state_dict(), os.path.join(SCRIPT_DIR, "net.pdopt"))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net_back = P.load(os.path.join(SCRIPT_DIR, "net.pdparams"))
    opt_back = P.load(os.path.join(SCRIPT_DIR, "net.pdopt"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    round_trip = dict(
        save_s=save_s, load_s=load_s,
        bytes=dir_bytes(SCRIPT_DIR) - dir_bytes(full_dir),
        net_equal=state_equal(torch, dict(net.state_dict()), net_back),
        opt_equal=state_equal(torch, opt.state_dict(), opt_back))
    del net_back, opt_back
    lap("round_trip")

    # 3: the same fit in a fresh process, SIGTERM after preempt_after steps
    pre_code, pre, pre_wall = run_script_worker("preempt", pre_dir)
    pre_latest = latest_step(pre_dir)
    lap("preempted_process")

    # 4: the preempted run's checkpoint restored into this process's live
    # step: the captured graph replays on it, nothing is captured again
    captures = step.captures
    t0 = time.perf_counter()
    restored = CheckpointManager(pre_dir).restore(step,
                                                  step=c["preempt_after"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    in_process = []
    for i, (x, y) in enumerate(loader):
        if i >= c["preempt_after"]:
            in_process.append(model.train_batch(x, y)[0])
    new_captures = step.captures - captures
    lap("in_process_restore")
    res_code, res, res_wall = run_script_worker("resume", pre_dir)
    lap("resumed_process")

    # 7: metric.Accuracy over Model.evaluate against an argmax count; the
    # label of half the rows is the eager forward's argmax at the last
    # position, of the others a random token
    eval_loader = script_loader(P, net.config.vocab_size, c["eval_windows"],
                                c["seed"] + 1, c)
    ids = torch.cat([x._value for x, _ in eval_loader])
    head = last_position(torch, net)
    with torch.no_grad():
        net.eval()
        top2 = torch.topk(head(ids).float(), 2, dim=-1)
    # hits: even rows whose top logit is not tied (argmax and topk agree)
    hit = (top2.values[:, 0] > top2.values[:, 1]).cpu().numpy()
    hit[1::2] = False
    rng = np.random.default_rng(c["seed"])
    labels = rng.integers(0, net.config.vocab_size, (len(ids), 1))
    labels[hit, 0] = top2.indices[:, 0].cpu().numpy()[hit]
    ev = P.Model(head).prepare(loss=lambda o, y: torch.nn.functional
                               .cross_entropy(o.float(), y.reshape(-1)),
                               metrics=P.metric.Accuracy())
    ds = [(ids[i].cpu().numpy(), labels[i]) for i in range(len(ids))]
    acc = float(ev.evaluate(ds, batch_size=c["B"], verbose=0)["acc"])
    preds = ev.predict([(x,) for x, _ in ds], batch_size=c["B"])
    hand = float(np.mean(torch.cat(preds).argmax(-1).cpu().numpy()
                         == labels[:, 0]))
    dev = P.device.cuda
    memory = {name: (getattr(dev, name)(), getattr(torch.cuda, name)())
              for name in ("memory_allocated", "max_memory_allocated",
                           "memory_reserved", "max_memory_reserved")}
    lap("evaluate")

    # 6: export, then serve the export from a fresh process
    x8 = ids[:c["B"]]
    with torch.no_grad():
        ref8 = net(x8)
        torch.cuda.synchronize()
        eager_walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            net(x8)
            torch.cuda.synchronize()
            eager_walls.append(time.perf_counter() - t0)
    eager_ms = float(np.median(eager_walls)) * 1e3
    ref_path = os.path.join(SCRIPT_DIR, "ref.npy")
    ids_path = os.path.join(SCRIPT_DIR, "ids.npy")
    np.save(ref_path, ref8.view(torch.int16).cpu().numpy())
    np.save(ids_path, x8.cpu().numpy())
    del ref8
    art = os.path.join(SCRIPT_DIR, "export", "gpt350m")
    t0 = time.perf_counter()
    P.jit.save(net, art, input_spec=[P.static.InputSpec([None, c["S"]],
                                                        "int64")])
    export_s = time.perf_counter() - t0
    art_bytes = dir_bytes(os.path.dirname(art))
    lap("export")
    out = os.path.join(SCRIPT_DIR, "serve.json")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", SERVE_SCRIPT, art, ref_path,
                        ids_path, out, str(device)], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    serve_wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"serving the export failed: {r.stderr[-3000:]}")
    with open(out) as f:
        served = json.load(f)
    lap("serve")

    # the fit loop's cost: one step through Model.train_batch, profiled,
    # beside the graph's device time (measurement steps: they go on
    # training the model)
    x, y = next(iter(loader))
    fit_profile = profile_call(torch, lambda: model.train_batch(x, y),
                               ("flash_",))
    graph_ms = replay_device_ms(torch, prog.capture.graph)
    lap("profile")
    step_ms = float(np.median(replayed_step_s)) * 1e3
    batch_ms = float(np.median(full["batch_s"])) * 1e3
    rec = dict(
        B=c["B"], S=c["S"], steps=steps, walls=walls,
        losses=full["losses"], fit_s=full["fit_s"],
        step_ms=step_ms, train_phase_step_ms=train_rec["step_ms"],
        fit_over_train_step=step_ms / train_rec["step_ms"],
        batch_ms=batch_ms, batch_over_train_step=batch_ms
        / train_rec["step_ms"],
        data_wait_ms=float(np.median(full["data_wait_s"])) * 1e3,
        tokens_per_s=c["B"] * c["S"] / (step_ms / 1e3),
        graph_device_ms=graph_ms, fit_profile=fit_profile,
        device_busy_share=fit_profile["device_busy_share"],
        captures=full["captures"], replays=full["replays"],
        eager_route=full["eager"], flash_launches=launches,
        checkpoint=dict(snapshot_s=snapshots, write_s=writes,
                        bytes=ckpt_bytes, every=c["every"]),
        monitor=full["monitor"], resumed_monitor=res["monitor"],
        round_trip=round_trip,
        preempted=dict(exit_code=pre_code, latest_step=pre_latest,
                       losses=pre["losses"], wall_s=pre_wall,
                       process_s=pre["process_s"]),
        in_process_restore=dict(step=restored, seconds=restore_s,
                                losses=in_process,
                                new_captures=new_captures),
        resumed=dict(exit_code=res_code, losses=res["losses"],
                     wall_s=res_wall, process_s=res["process_s"],
                     until_first_batch_s=res["until_first_batch_s"],
                     captures=res["captures"], replays=res["replays"],
                     latest_step=latest_step(pre_dir)),
        accuracy=acc, accuracy_by_hand=hand, designed_hits=int(hit.sum()),
        memory=memory,
        export=dict(seconds=export_s, bytes=art_bytes, eager_ms=eager_ms,
                    serve_wall_s=serve_wall, **served),
        max_memory_allocated=peak, card=card_line())
    print("script", json.dumps(rec), flush=True)
    full_l, want = full["losses"], full["losses"][c["preempt_after"]:]
    fails = []
    # distinct windows of random tokens: the losses stay near ln V
    if len(full_l) != steps or not all(np.isfinite(full_l)) \
            or abs(full_l[0] - np.log(net.config.vocab_size)) > 1.0:
        fails.append(f"losses {full_l}")
    if full["eager"] or full["captures"] != 1 or full["replays"] != steps - 1:
        fails.append(f"fit took the eager route or captured again: "
                     f"{full['captures']} captures, {full['replays']} "
                     f"replays, eager {full['eager']}")
    if any(n != net.config.num_layers * steps for n in launches.values()):
        fails.append(f"flash launches {launches}")
    if code is not None:
        fails.append(f"the uninterrupted fit exited with {code}")
    if not (round_trip["net_equal"] and round_trip["opt_equal"]):
        fails.append(f"round trip {round_trip}")
    if pre_code != 101 or pre_latest != c["preempt_after"] \
            or pre["losses"] != full_l[:c["preempt_after"]]:
        fails.append(f"preemption: exit {pre_code}, latest {pre_latest}, "
                     f"losses {pre['losses']}")
    if restored != c["preempt_after"] or in_process != want \
            or new_captures != 0:
        fails.append(f"in-process restore: {restored}, {in_process} vs "
                     f"{want}, {new_captures} new captures")
    if res_code != 0 or res["losses"] != want or res["eager"]:
        fails.append(f"resume: exit {res_code}, {res['losses']} vs {want}")
    # the bound StepMonitor's series: every checkpoint's three phases and
    # its commit, goodput, and a resumed count that continues the step
    fm, written = full["monitor"], -(-steps // c["every"])
    if (fm["checkpoint_observations"] != {p: written for p in
                                          ("snapshot", "serialize",
                                           "commit")}
            or fm["checkpoint_results"] != {"committed": written}
            or fm["steps_total"] != steps or fm["step"] != steps
            or not 0.0 < (fm["goodput"] or 0.0) <= 1.0
            or len(full["step_s"]) != steps
            or len(full["data_wait_s"]) != steps - 1):
        fails.append(f"the fit's monitor: {fm}, {len(full['step_s'])} "
                     f"steps, {len(full['data_wait_s'])} data waits, "
                     f"{written} checkpoints written")
    rm = res["monitor"]
    if (rm["step"] != steps or rm["steps_total"] != steps
            - c["preempt_after"]):
        fails.append(f"the resumed monitor does not continue the count: "
                     f"{rm}")
    if acc != hand or hand < hit.mean():
        fails.append(f"accuracy {acc} vs by hand {hand}")
    if any(a != b for a, b in memory.values()):
        fails.append(f"memory stats {memory}")
    for b in ("b8", "b2"):
        if (served[b + "_launches"] != net.config.num_layers
                or not served[b + "_finite"]
                or served[b + "_max_abs_diff"]
                > SCRIPT_LOGIT_TOL * served[b + "_max_abs_ref"]):
            fails.append(f"served {b}: {served}")
    if served["modules"]:
        fails.append(f"the serving process imported {served['modules']}")
    del model, net, opt, step, prog, loader, head, ev
    shutil.rmtree(SCRIPT_DIR, ignore_errors=True)
    if fails:
        raise AssertionError("script phase: " + "; ".join(fails))
    return rec


def last_position(torch, net):
    """The evaluation network: ``net``'s logits at the last position of
    each window, [B, V] (the shape ``metric.Accuracy`` takes)."""

    class LastPosition(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, ids):
            return self.net(ids)[:, -1]

    return LastPosition()


def d128_reading(timing, checked):
    """A paged or dense kernel's D = 128 readings for the kernels line:
    decode and prefill, each its times and its check's error."""
    return {form: dict({k: timing[f"{form}_d128"][k] for k in READING_KEYS},
                       **checked[form])
            for form in ("decode", "prefill")}


def flash_reading(timed, checked):
    """A flash kernel's readings at one shape for the kernels line."""
    return dict({k: timed[k] for k in READING_KEYS}, **checked)


# ------------------------------------------------ training monitors (18)
def turn_rates(torch, step, args, kwargs, monitor, rounds, steps):
    """Tokens/s of ``steps`` steps a turn, in turns bare, monitored,
    monitored, bare (``rounds`` times): {"bare": [...], "monitored":
    [...]}. A monitored turn binds ``monitor``; a bare one detaches it."""
    rates = {"bare": [], "monitored": []}
    tokens = args[0].numel()
    for _ in range(rounds):
        for form in ("bare", "monitored", "monitored", "bare"):
            if form == "monitored":
                monitor.bind(step)
            else:
                monitor.detach(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step(*args, **kwargs)
            torch.cuda.synchronize()
            rates[form].append(tokens * steps / (time.perf_counter() - t0))
    monitor.detach(step)
    return rates


def paired_ratio(rates, num, den):
    """``turn_rates``' rounds (den, num, num, den) each as one ratio, the
    mean rate of its two ``num`` turns over that of its two ``den`` turns,
    which cancels a drift linear in time within the round: the rounds'
    ratios, their median and spread (max - min), resolved where the
    median's gap from 1 is wider than the spread, and ``cost_at_most``,
    1 less the lowest round's ratio."""
    rounds = [(rates[num][2 * r] + rates[num][2 * r + 1])
              / (rates[den][2 * r] + rates[den][2 * r + 1])
              for r in range(len(rates[num]) // 2)]
    med = float(np.median(rounds))
    spread = max(rounds) - min(rounds)
    return dict(rounds=rounds, ratio=med, spread=spread,
                resolved=bool(abs(1.0 - med) > spread),
                cost_at_most=1.0 - min(rounds))


def train_monitor(torch, fa, device, B=8, S=1024, steps=8, rounds=3,
                  turn_steps=30, seed=12, cfg=None):
    """Phase ``train_monitor`` (module docstring, 11f): GPT-350M (or
    ``cfg``), O2 bf16, AdamW, the captured TrainStep under a bound
    ``StepMonitor``: (a) losses bit-equal to the bare step's, the same
    launches and host launch calls, (b) the monitored / bare rate, (c) the
    recompile sentinel, (d) one planted NaN, one anomaly, (e) live MFU
    beside the model-FLOP share and the HBM gauges, and GPT-350M's
    operator-stats table from its seams (f)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m
    from paddle_tpu_torch.observability import StepMonitor, device_peak_flops

    t_start = time.perf_counter()
    cfg = cfg or gpt_350m()
    model = GPTForCausalLM(cfg, device=device, seed=seed)
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, lambda logits, loss: loss, opt)
    rng = np.random.default_rng(seed)
    ids_np = rng.integers(0, cfg.vocab_size, (B, S))
    ids = torch.as_tensor(ids_np, device=device)
    batch = ((ids,), {"labels": torch.as_tensor(np.roll(ids_np, -1, 1),
                                                device=device)})
    half = rng.integers(0, cfg.vocab_size, (B // 2, S))
    other = ((torch.as_tensor(half, device=device),),
             {"labels": torch.as_tensor(np.roll(half, -1, 1),
                                        device=device)})
    start = step.export_state()

    # (a) the bare captured step, then the same steps monitored
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0
    bare = [step(*batch[0], **batch[1]) for _ in range(steps)]
    bare_launches = flash_launches(fa)
    bare = torch.stack(bare)

    # (c) a batch of another shape: one recompile, new_shape
    sentinel = StepMonitor(samples_per_step=B, tokens_per_step=B * S)
    sentinel.bind(step)
    step(*batch[0], **batch[1])
    step(*other[0], **other[1])
    step(*other[0], **other[1])
    sentinel.detach(step)
    new_shape = dict(recompiles=sentinel.recompiles,
                     reasons=[sp.tags["reason"] for sp in
                              sentinel.tracer.spans()
                              if sp.name == "compile"])

    step.import_state(start)
    prog = step.aot_prime(*batch[0], **batch[1])     # FLOPs, memory
    mon = StepMonitor(samples_per_step=B, tokens_per_step=B * S)
    mon.bind(step)
    captures = step.captures
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0   # main path
    fa.flash_bwd_dkv.launches = 0
    monitored = [step(*batch[0], **batch[1]) for _ in range(steps)]
    launches = flash_launches(fa)                          # main path ends
    monitored = torch.stack(monitored)
    losses_equal = bool(torch.equal(monitored, bare))
    fields = dict(mon.last_fields)
    live = dict(mfu=fields.get("mfu"), step_time_s=fields["step_time_s"],
                flops_per_step=mon.flops_per_step,
                peak_flops=device_peak_flops(step.device))
    model_flops = step_flops("gpt", cfg, B, S)
    live["model_flop_share"] = (model_flops / fields["step_time_s"]
                                / live["peak_flops"]
                                if live["peak_flops"] else None)
    live["model_flops_per_step"] = model_flops
    live["mfu_over_model_share"] = (live["mfu"] / live["model_flop_share"]
                                    if live["mfu"] and
                                    live["model_flop_share"] else None)
    hbm = dict(mon.hbm_stats)

    # the host's launch calls of one replay: bare, monitored without and
    # with the loss read
    def one_step():
        step(*batch[0], **batch[1])
        torch.cuda.synchronize()

    mon.detach(step)
    calls = {"bare": profile_call(torch, one_step)["host_launch_calls"]}
    mon.bind(step)
    mon.loss_every = 0
    calls["monitored_no_loss_read"] = profile_call(
        torch, one_step)["host_launch_calls"]
    mon.loss_every = 1
    calls["monitored"] = profile_call(torch, one_step)["host_launch_calls"]

    # (b) monitored against bare, in interleaved turns under a monitor of
    # their own, from a saved state put back after them: the turns train
    # on one batch, and the loss they reach would make the next batch of
    # (c') a spike for ``mon``'s detector
    pre_turns = step.export_state()
    rates = turn_rates(torch, step, *batch, StepMonitor(
        samples_per_step=B, tokens_per_step=B * S), rounds, turn_steps)
    step.import_state(pre_turns)
    del pre_turns
    ratio = dict(rate_ratio(rates, "monitored", "bare"),
                 paired=paired_ratio(rates, "monitored", "bare"))

    # (c') after aot_prime a call of another shape is JAX's aot_fallback
    mon.bind(step)
    before = mon.recompiles
    step(*other[0], **other[1])
    fallback = dict(recompiles=mon.recompiles - before, series={
        k[0]: v for k, v in monitor_series(
            mon, "paddle_train_recompiles_total").items()})

    # (d) a NaN planted in a weight for one step, the state restored
    saved = step.export_state()
    with torch.no_grad():
        model.gpt.ln_f.weight[0] = float("nan")
    step(*batch[0], **batch[1])
    step.import_state(saved)
    after_nan = float(step(*batch[0], **batch[1]))
    anomalies = monitor_series(mon, "paddle_train_anomalies_total")
    anomaly_events = [sp.tags["kind"] for sp in mon.tracer.spans()
                      if sp.name == "anomaly"]
    mon.detach(step)
    del saved, start

    # (f) GPT-350M's table from its seams: one eager O2 forward
    model.eval()
    with torch.no_grad(), debugging.collect_operator_stats(), \
            contextlib.redirect_stdout(io.StringIO()):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            model(*batch[0], **batch[1])
        gpt_table = debugging.operator_stats_snapshot()
    rec = dict(
        B=B, S=S, steps=steps, layers=cfg.num_layers,
        bare_losses=[float(x) for x in bare.float()],
        monitored_losses=[float(x) for x in monitored.float()],
        losses_bit_equal=losses_equal, flash_launches=launches,
        bare_flash_launches=bare_launches,
        new_captures=step.captures - captures,
        host_launch_calls=calls, rates_tok_per_s=rates,
        monitored_over_bare=ratio, new_shape=new_shape,
        aot_fallback=fallback, live_mfu=live, hbm=hbm,
        anomalies={k[0]: v for k, v in anomalies.items()},
        anomaly_events=anomaly_events, loss_after_restore=after_nan,
        gpt_op_table=gpt_table, flops_counted=prog.flops,
        wall_s=time.perf_counter() - t_start, card=card_line())
    print("train_monitor", json.dumps(rec), flush=True)
    fails = []
    if not losses_equal:
        fails.append(f"monitored losses differ from the bare step's: "
                     f"{rec['monitored_losses']} vs {rec['bare_losses']}")
    n = cfg.num_layers * steps
    if any(v != n for v in launches.values()) or launches != bare_launches:
        fails.append(f"flash launches {launches} (bare {bare_launches}), "
                     f"want {n} each")
    if rec["new_captures"] != 0:
        fails.append(f"{rec['new_captures']} captures under the monitor")
    if calls["monitored_no_loss_read"] != calls["bare"]:
        fails.append(f"host launch calls {calls}")
    if new_shape != dict(recompiles=1, reasons=["first", "new_shape"]):
        fails.append(f"new shape: {new_shape}")
    if fallback["recompiles"] != 1 or fallback["series"] != {
            "aot_fallback": 1.0}:
        fails.append(f"aot fallback: {fallback}")
    if anomalies != {("nan_loss",): 1.0} or anomaly_events != ["nan_loss"] \
            or not np.isfinite(after_nan):
        fails.append(f"anomalies {anomalies}, events {anomaly_events}, "
                     f"loss after the restore {after_nan}")
    if not (live["mfu"] and live["flops_per_step"] and hbm.get(
            "argument_bytes") and hbm.get("peak_bytes")):
        fails.append(f"live MFU or HBM gauges missing: {live}, {hbm}")
    if gpt_table.get("linear") != {"bfloat16": 4 * cfg.num_layers} \
            or set(gpt_table.get("sum", {})) != {"float32"}:
        fails.append(f"GPT-350M's seams: {gpt_table}")
    del step, opt, model, prog, mon, sentinel
    if fails:
        raise AssertionError("train_monitor: " + "; ".join(fails))
    return rec


def fused_stack(torch, P, layers, d, heads, ff, dropout, activation):
    """``layers`` FusedTransformerEncoderLayer in a Sequential (post-LN)."""
    inc = P.incubate.nn
    return P.nn.Sequential(*[inc.FusedTransformerEncoderLayer(
        d, heads, ff, dropout_rate=dropout, activation=activation)
        for _ in range(layers)])


def stack_weights(torch, fused, nn_stack):
    """``nn_stack``'s TransformerEncoderLayers given ``fused``'s weights:
    q / k / v are the column blocks of qkv_proj."""
    with torch.no_grad():
        for f, g in zip(fused, nn_stack.layers):
            w, b = f.fused_attn.qkv_proj.weight._value, \
                f.fused_attn.qkv_proj.bias._value
            a = g.self_attn
            for i, proj in enumerate((a.q_proj, a.k_proj, a.v_proj)):
                E = w.shape[0]
                proj.weight._value.copy_(w[:, i * E:(i + 1) * E])
                proj.bias._value.copy_(b[i * E:(i + 1) * E])
            for src, dst in ((f.fused_attn.out_proj, a.out_proj),
                             (f.ffn.linear1, g.linear1),
                             (f.ffn.linear2, g.linear2),
                             (f.fused_attn.ln, g.norm1), (f.ffn.ln, g.norm2)):
                dst.weight._value.copy_(src.weight._value)
                dst.bias._value.copy_(src.bias._value)


def functional_stack(P, fused, x):
    """The stack as ``fused_multi_head_attention`` + ``fused_feedforward``
    on its own weights (relu, no dropout)."""
    IF = P.incubate.nn.functional
    for f in fused:
        a, m = f.fused_attn, f.ffn
        x = IF.fused_multi_head_attention(
            x, a.qkv_proj.weight, a.out_proj.weight,
            qkv_bias=a.qkv_proj.bias, linear_bias=a.out_proj.bias,
            ln_scale=a.ln.weight, ln_bias=a.ln.bias, dropout_rate=0.0,
            attn_dropout_rate=0.0, num_heads=a.num_heads,
            transpose_qkv_wb=True, training=False)
        x = IF.fused_feedforward(
            x, m.linear1.weight, m.linear2.weight,
            linear1_bias=m.linear1.bias, linear2_bias=m.linear2.bias,
            ln2_scale=m.ln.weight, ln2_bias=m.ln.bias, dropout1_rate=0.0,
            dropout2_rate=0.0, activation="relu", training=False)
    return x


def moe_grads(torch, layer, x):
    """(output, l_aux, every gradient) of one forward and backward."""
    layer.clear_gradients()
    xt = x.detach().clone().requires_grad_(True)
    out = layer(xt)
    (out.float().square().mean() + 0.01 * layer.l_aux).backward()
    grads = [xt.grad] + [p._value.grad for p in layer.parameters()]
    return out.detach(), layer.l_aux.detach(), grads


def incubate_phase(torch, device, B=32, S=512, d=768, heads=12, ff=3072,
                   layers=12, steps=8, seed=18,
                   moe_shape=(8, 1024, 1024, 8, 4096), asp_config=None):
    """Phase ``incubate`` (module docstring, 11g): (g) the fused stack
    against the nn stack and the functionals in f32; (f) the stack's O2
    operator stats and the tensor checker; (h) the stack trained in bf16
    under a StepMonitor, replays against bodies; (i) MoE at GPT-350M
    widths, index against dense; (j) ASP on GPT-350M; (k) LookAhead and
    ModelAverage against hand loops."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m
    from paddle_tpu_torch.nn.functional import get_last_attention_backend
    from paddle_tpu_torch.observability import StepMonitor

    t_start = time.perf_counter()
    walls, last = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls[name], last[0] = now - last[0], now

    P.set_device("gpu:0" if str(device).startswith("cuda") else "cpu")
    P.seed(seed)
    g = torch.Generator(device=device).manual_seed(seed)
    fails = []

    # (g) f32: fused layers = nn layers = the functionals
    fused = fused_stack(torch, P, layers, d, heads, ff, 0.0, "relu")
    fused.eval()
    nn_stack = P.nn.TransformerEncoder(P.nn.TransformerEncoderLayer(
        d, heads, ff, dropout=0.0), layers)
    nn_stack.eval()
    stack_weights(torch, fused, nn_stack)
    x = torch.randn(B, S, d, generator=g, device=device)
    with torch.no_grad():
        out_fused = fused(P.Tensor(x))._value
        backend = get_last_attention_backend()
        out_nn = nn_stack(P.Tensor(x))._value
        out_fn = functional_stack(P, fused, P.Tensor(x))._value
    scale = float(out_nn.abs().max())
    # f32 sums of up to ``ff`` terms in another order, through ``layers``
    # layers each renormalised by its LayerNorm: at most layers * ff * 2^-24
    # of the output's scale (the worst-case, linear bound)
    lim = layers * ff * 2.0 ** -24 * scale
    g_rec = dict(fused_vs_nn=float((out_fused - out_nn).abs().max()),
                 functional_vs_fused=float((out_fn - out_fused).abs().max()),
                 limit=lim, backend=backend)
    if g_rec["fused_vs_nn"] > lim or g_rec["functional_vs_fused"] > lim \
            or backend != "plain":
        fails.append(f"(g) {g_rec}")
    del nn_stack, out_nn, out_fn, out_fused
    lap("g")

    # (f) one eager O2 forward of the stack: operator stats
    with torch.no_grad(), debugging.collect_operator_stats(), \
            contextlib.redirect_stdout(io.StringIO()):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            fused(P.Tensor(x))
        table = debugging.operator_stats_snapshot()
    black = amp.black_list()
    wrong = {op: b for op, b in table.items()
             if (op in black and set(b) != {"float32"})
             or (op in ("linear", "matmul") and set(b) != {"bfloat16"})}
    if wrong or "linear" not in table or "layer_norm" not in table:
        fails.append(f"(f) O2 table {table}")
    inf = P.to_tensor(torch.tensor([1.0, float("inf")], device=device))
    checker = {}
    try:
        debugging.enable_tensor_checker(debugging.TensorCheckerConfig(
            enable=True,
            debug_mode=debugging.DebugMode.CHECK_NAN_INF_AND_ABORT))
        try:
            P.exp(inf)
            checker["level0"] = "no raise"
        except FloatingPointError as e:
            checker["level0"] = str(e)
        debugging.enable_tensor_checker(debugging.TensorCheckerConfig(
            enable=True, debug_mode=debugging.DebugMode.CHECK_NAN_INF))
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            P.exp(inf)
        checker["level1"] = [str(w.message) for w in caught]
    finally:
        debugging.disable_tensor_checker()
    if "NaN/Inf" not in checker["level0"] or not any(
            "NaN/Inf" in m for m in checker["level1"]):
        fails.append(f"(f) tensor checker {checker}")
    lap("f")

    # (h) bf16, dropout 0.1, gelu: the captured TrainStep under a monitor,
    # replays against bodies from one saved state
    del fused
    P.seed(seed + 1)
    model = fused_stack(torch, P, layers, d, heads, ff, 0.1, "gelu")
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters())
    step = TrainStep(model, lambda out, y: (
        (out.astype("float32") - y) ** 2).mean(), opt)
    xb = x.to(torch.bfloat16)
    target = torch.randn(B, S, d, generator=g, device=device)
    start = step.export_state()
    with step._eager():
        body = torch.stack([step(xb, target) for _ in range(steps)])
    step.import_state(start)
    mon = StepMonitor(samples_per_step=B, tokens_per_step=B * S)
    mon.bind(step)
    replay = torch.stack([step(xb, target) for _ in range(steps)])
    h_rec = dict(body_losses=[float(v) for v in body],
                 replay_losses=[float(v) for v in replay],
                 equal=bool(torch.equal(body, replay)),
                 captures=step.captures, replays=step.replays,
                 monitor_steps=mon.last_fields.get("step"),
                 step_ms=mon.last_fields["step_time_s"] * 1e3,
                 backend=get_last_attention_backend())
    if not h_rec["equal"] or h_rec["captures"] != (
            1 if step.device.type == "cuda" else 0) \
            or h_rec["monitor_steps"] != steps \
            or not all(np.isfinite(h_rec["replay_losses"])):
        fails.append(f"(h) {h_rec}")
    del step, opt, model, start, body, replay, mon, x, xb, target
    release(torch)
    lap("h")

    # (i) MoE at GPT-350M widths: index against dense in f32 over three
    # seeds, then the index mode's bf16 forward + backward timed
    mb, ms_, D, E, F_ = moe_shape
    T = mb * ms_

    def moe(mode, s_):
        P.seed(s_)
        experts = [P.nn.Sequential(P.nn.Linear(D, F_), P.nn.GELU(),
                                   P.nn.Linear(F_, D)) for _ in range(E)]
        return MoELayer(D, experts, gate="gshard", dispatch_mode=mode)

    # the same decisions, not the same roundings. Dispatch is exact (one
    # token a slot), but the combine weights' gradient is a sum over the d
    # features of grad(y) * expert output: a matrix product (dense) against
    # a product and a row sum (index), the same d terms in another order.
    # That gap reaches the gate logits and so x and the gate weight; so
    # each tensor within d * 2^-24 of its largest magnitude (f32 sums of d
    # terms in another order: the linear worst case; a random walk gives
    # ~sqrt(d) * 2^-24)
    bound = D * 2.0 ** -24
    runs = []
    for s_ in (seed + 2, seed + 3, seed + 4):
        xm = torch.randn(mb, ms_, D, device=device, generator=torch
                         .Generator(device=device).manual_seed(s_))
        index, dense = moe("index", s_), moe("dense", s_)
        with torch.no_grad():
            for a, b in zip(index.parameters(), dense.parameters()):
                b._value.copy_(a._value)
        yi, li, gi = moe_grads(torch, index, xm)
        yd, ld, gd = moe_grads(torch, dense, xm)
        diffs = [float((a - b).abs().max()) / max(float(b.abs().max()),
                                                  1e-30)
                 for a, b in zip([yi] + gi, [yd] + gd)]
        # parameters: the experts' in order, then the gate's weight
        runs.append(dict(seed=s_, out_rel=diffs[0], x_grad_rel=diffs[1],
                         gate_grad_rel=diffs[-1], expert_grad_rel_max=max(
                             diffs[2:-1]), worst_rel=max(diffs),
                         l_aux_equal=bool(torch.equal(li, ld))))
        del dense, yd, gd, gi, yi
    i_rec = dict(T=T, d=D, experts=E, ff=F_, capacity=index.gate
                 .capacity_for(T), seeds=runs, worst_rel=max(
                     r["worst_rel"] for r in runs), bound=bound,
                 backend=get_last_attention_backend())
    if i_rec["worst_rel"] > bound or not all(r["l_aux_equal"]
                                             for r in runs):
        fails.append(f"(i) index vs dense {i_rec}")
    amp.decorate(index, level="O2", dtype="bfloat16")
    xb16 = xm.to(torch.bfloat16)
    # each call on its own: its gigabyte temporaries make the allocator
    # synchronise (time_ms's queued=False)
    i_rec["bf16_fwd_bwd_ms"] = time_ms(
        torch, lambda: moe_grads(torch, index, xb16),
        torch.empty(64 << 20, dtype=torch.uint8, device=device), reps=5,
        queued=False)
    del index, xm, xb16
    release(torch)
    lap("i")

    # (j) ASP on GPT-350M's linear weights, 3 eager AdamW steps
    cfg = asp_config or gpt_350m()
    gpt = GPTForCausalLM(cfg, device=device, seed=seed)
    asp.set_excluded_layers(["gpt.embed_tokens.weight"])
    try:
        masks = asp.prune_model(gpt)
    finally:
        asp.reset_excluded_layers()
    opt = asp.decorate(P.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=gpt.parameters()))
    ids_np = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, min(1024, cfg.max_position)))
    ids = torch.as_tensor(ids_np, device=device)
    labels = torch.as_tensor(np.roll(ids_np, -1, 1), device=device)
    losses = []
    for _ in range(3):
        _, loss = gpt(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    named = dict(torch.nn.Module.named_parameters(gpt))
    sparse = {n: asp.check_sparsity(named[n], 2, 4) for n in masks}
    j_rec = dict(pruned=len(masks), losses=losses,
                 all_sparse=all(sparse.values()),
                 density=asp.calculate_density(
                     named["gpt.blocks.0.mlp.down.weight"]))
    if not j_rec["all_sparse"] or len(masks) != 4 * cfg.num_layers:
        fails.append(f"(j) {j_rec}, not 2:4: "
                     f"{[n for n, ok in sparse.items() if not ok][:4]}")
    del gpt, opt, named
    asp._MASKS.clear()
    release(torch)
    lap("j")

    # (k) LookAhead(k=2) and ModelAverage over 4 eager steps against hand
    # loops on a two-layer f32 stack
    def small(seed_):
        P.seed(seed_)
        m = fused_stack(torch, P, 2, d, heads, ff, 0.0, "relu")
        return m

    xs = torch.randn(4, min(128, S), d, generator=g, device=device)
    ys = torch.randn(4, min(128, S), d, generator=g, device=device)
    net, ref = small(seed + 3), small(seed + 3)

    def sgd_step(model, opt_):
        ((model(P.Tensor(xs))._value - ys) ** 2).mean().backward()
        opt_.step()
        opt_.clear_grad()

    la = P.incubate.LookAhead(P.optimizer.SGD(
        0.05, parameters=net.parameters()), alpha=0.5, k=2)
    sgd = P.optimizer.SGD(0.05, parameters=ref.parameters())
    avg = P.incubate.ModelAverage(parameters=net.parameters())
    slow, seen, la_equal = None, [], True
    for i in range(4):
        sgd_step(net, la)
        avg.step()
        sgd_step(ref, sgd)
        if i == 1:
            slow = [p._value.detach().clone() for p in ref.parameters()]
        if i == 3:
            with torch.no_grad():
                for p, s_ in zip(ref.parameters(), slow):
                    p._value.copy_(s_ + 0.5 * (p._value - s_))
        seen.append([p._value.detach().clone() for p in net.parameters()])
        la_equal &= all(torch.equal(a._value, b._value) for a, b in
                        zip(net.parameters(), ref.parameters()))
    live = [p._value.detach().clone() for p in net.parameters()]
    avg.apply()
    hand = [sum(s_[i] for s_ in seen) / 4 for i in range(len(live))]
    avg_equal = all(torch.equal(p._value, h.to(p._value.dtype)) for p, h in
                    zip(net.parameters(), hand))
    avg.restore()
    restored = all(torch.equal(p._value, v) for p, v in
                   zip(net.parameters(), live))
    k_rec = dict(lookahead_equal=la_equal, average_equal=avg_equal,
                 restored=restored)
    if not all(k_rec.values()):
        fails.append(f"(k) {k_rec}")
    del net, ref, la, sgd, avg, seen, live, hand, slow
    release(torch)
    lap("k")
    rec = dict(g=g_rec, f=dict(o2_table=table, tensor_checker=checker),
               h=h_rec, i=i_rec, j=j_rec, k=k_rec, walls=walls,
               wall_s=time.perf_counter() - t_start, card=card_line())
    print("incubate", json.dumps(rec), flush=True)
    if fails:
        raise AssertionError("incubate: " + "; ".join(fails))
    return rec


PHASE_S = {}
PHASE_ALLOCATED = {}     # the allocator's live bytes as each phase ended


# ------------------------------------------------------------- distributed
# the CPU rehearsal's and the card tests' model: head dim 64, a kernel's
DIST_TINY = dict(vocab_size=128, hidden_size=256, num_layers=2, num_heads=4,
                 max_position=256)


def dist_collectives(torch, dist, device):
    """Every collective of ``distributed.collective`` on ``device`` at this
    world size, rank r holding base + r: {name: held to its meaning}."""
    n, me = dist.get_world_size(), dist.get_rank()
    base = torch.arange(1, 4, dtype=torch.float32, device=device)
    xs = [base + 10 * r for r in range(n)]
    mine = lambda: xs[me].clone()                      # noqa: E731
    res = {}

    def held(name, got, want):
        res[name] = bool(torch.equal(got, want))

    stack = torch.stack(xs)
    for op, want in (("sum", stack.sum(0)), ("max", stack.amax(0)),
                     ("min", stack.amin(0)), ("prod", stack.prod(0)),
                     ("avg", stack.mean(0))):
        t = mine()
        dist.all_reduce(t, op=op)
        held(f"all_reduce_{op}", t, want)
    t = mine()
    dist.reduce(t, dst=0)
    held("reduce", t, stack.sum(0))
    t = mine()
    dist.broadcast(t, src=n - 1)
    held("broadcast", t, xs[n - 1])
    lst = []
    dist.all_gather(lst, mine())
    held("all_gather", torch.stack(lst), stack)
    held("all_gather_axis", dist.all_gather(None, mine()[None], axis=0),
         stack)
    lst = []
    dist.gather(mine(), lst, dst=0)
    held("gather", torch.stack(lst), stack)
    t = torch.zeros_like(base)
    dist.scatter(t, [base * 0 + 10.0 * i for i in range(n)], src=0)
    held("scatter", t, base * 0 + 10.0 * me)
    t = torch.zeros_like(base)
    dist.reduce_scatter(t, [mine() * (i + 1) for i in range(n)])
    held("reduce_scatter", t, stack.sum(0) * (me + 1))
    t = torch.zeros_like(base[None])
    dist.reduce_scatter(t, torch.stack([mine() * (i + 1) for i in range(n)]))
    held("reduce_scatter_tiled", t[0], stack.sum(0) * (me + 1))
    outs = []
    dist.alltoall(outs, [mine() * (i + 1) + i for i in range(n)])
    held("alltoall", torch.stack(outs), stack * (me + 1) + me)
    src = torch.cat([mine() * (i + 1) + i for i in range(n)])
    dst = torch.empty_like(src)
    dist.alltoall_single(dst, src)
    held("alltoall_single", dst, (stack * (me + 1) + me).reshape(-1))
    held("shift", dist.shift(mine(), 1), xs[(me - 1) % n])
    a = torch.zeros_like(base)
    nxt, prv = (me + 1) % n, (me - 1) % n
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine(), nxt),
                                     dist.P2POp(dist.irecv, a, prv)]):
        w.wait()
    held("batch_isend_irecv", a, xs[prv])
    objs = [{"from": me}]
    dist.broadcast_object_list(objs, src=n - 1)
    res["broadcast_object_list"] = objs[0]["from"] == n - 1
    got = []
    dist.all_gather_object(got, me)
    res["all_gather_object"] = got == list(range(n))
    got = []
    dist.scatter_object_list(got, list(range(n)) if me == 0 else None, src=0)
    res["scatter_object_list"] = got == [me]
    dist.barrier()
    res["barrier"] = True
    return res


def dist_train(torch, dist, fa, device, cfg, B, S, steps, dtype, seed=12,
               plant=None):
    """The same steps of GPT (O2 bf16 on the card, AdamW) twice: a bare
    captured TrainStep on the whole batch, then the TrainStep over
    ``DataParallel`` with this rank's rows (the main path: the flash launch
    counts). Held: the losses, and each parameter after the steps against
    the bare step's (``param_gap``: per leaf, sum |p_dp - p_bare| over sum
    |p_bare - p_init|, the gap as a share of how far the leaf moved). At
    one rank both must be bit-equal. Across ranks (f32, the CPU
    rehearsal) the mean of the ranks' losses within 1e-5 relative and
    every leaf's gap within 1e-3 (f32 sums over other batch splits,
    through AdamW's normalised update; a skipped sync leaves gaps near 1).
    ``plant="skip_sync"`` leaves the DataParallel gradients local, which
    the gate must refuse. Then five rounds of two more steps of each,
    the forms alternating which goes first (``step_ms``: the median
    round, host clock; ``dp_over_bare``: the median of the rounds'
    ratios)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    n, me = dist.get_world_size(), dist.get_rank()
    rng = np.random.default_rng(seed)
    ids_np = rng.integers(0, cfg.vocab_size, (B, S))
    labels_np = np.roll(ids_np, -1, axis=1)
    rec, after, live = {}, {}, {}
    for form in ("bare", "data_parallel"):
        model = GPTForCausalLM(cfg, device=device, seed=seed)
        if dtype == "bfloat16":
            amp.decorate(model, level="O2", dtype="bfloat16")
        if form == "bare":
            init = [p.detach().clone() for p in model.parameters()]
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters(),
                              weight_decay=0.01, multi_precision=True)
        net = model if form == "bare" else dist.DataParallel(model)
        if form == "data_parallel" and plant == "skip_sync":
            net._sync = False
        step = TrainStep(net, lambda logits, loss: loss, opt)
        rows = (slice(None) if form == "bare"
                else slice(me * B // n, (me + 1) * B // n))
        ids = torch.as_tensor(ids_np[rows], device=device)
        labels = torch.as_tensor(labels_np[rows], device=device)
        if form == "data_parallel":
            fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0  # main path
            fa.flash_bwd_dkv.launches = 0
        t0 = time.perf_counter()
        losses = []
        for _ in range(steps):
            loss = step(ids, labels=labels).float()
            if form == "data_parallel":
                dist.all_reduce(loss, op="avg")
            losses.append(loss)
        if device != "cpu":
            torch.cuda.synchronize()
        r = dict(losses=[float(x) for x in losses],
                 loss_tensors=torch.stack(losses),
                 wall_s=time.perf_counter() - t0)
        if form == "data_parallel":
            r["flash_launches"] = flash_launches(fa)       # main path ends
        after[form] = [p.detach().clone() for p in model.parameters()]
        rec[form] = r
        live[form] = (step, ids, labels, net)
    ms = {form: [] for form in live}
    for rnd in range(5):                    # two more replays, host clock
        for form in (("bare", "data_parallel") if rnd % 2 == 0
                     else ("data_parallel", "bare")):
            step, ids, labels, _ = live[form]
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                step(ids, labels=labels)
            if device != "cpu":
                torch.cuda.synchronize()
            ms[form].append((time.perf_counter() - t0) / 2 * 1e3)
    for form, (step, _, _, net) in live.items():
        rec[form].update(step_ms=float(np.median(ms[form])),
                         step_ms_rounds=ms[form], captures=step.captures,
                         replays=step.replays)
    rec["data_parallel"]["syncs"] = live["data_parallel"][3].syncs
    rec["dp_over_bare"] = float(np.median(
        [d / b for d, b in zip(ms["data_parallel"], ms["bare"])]))
    del live, step, opt, net, model
    if device != "cpu":
        torch.cuda.empty_cache()
    a, b = rec["bare"].pop("loss_tensors"), rec["data_parallel"].pop(
        "loss_tensors")
    rec["bit_equal"] = bool(torch.equal(a, b))
    rec["max_rel_diff"] = float(((a - b).abs() / a.abs()).max())
    gaps = [float((d.float() - w.float()).abs().sum()
                  / (w.float() - i.float()).abs().sum().clamp(min=1e-30))
            for i, w, d in zip(init, after["bare"], after["data_parallel"])]
    rec["params_bit_equal"] = all(
        torch.equal(w, d) for w, d in zip(after["bare"],
                                          after["data_parallel"]))
    rec["param_gap"] = max(gaps)
    del init, after
    rec["ok"] = bool(rec["bit_equal"] and rec["params_bit_equal"] if n == 1
                     else rec["max_rel_diff"] <= 1e-5
                     and rec["param_gap"] <= 1e-3)
    rec["ok"] = rec["ok"] and all(np.isfinite(rec["bare"]["losses"]))
    if device != "cpu":
        # the gradient all-reduce ran while the step was captured (a sync
        # at the first run and one at the capture, none at the replays):
        # it is in the graph (at one rank NCCL copies: no kernel to see)
        dp = rec["data_parallel"]
        want = cfg.num_layers * steps
        rec["ok"] = (rec["ok"] and dp["captures"] == 1 and dp["syncs"] == 2
                     and all(v == want
                             for v in dp["flash_launches"].values()))
    return rec


GPT_TP_PLAN = {
    r"gpt\.blocks\.\d+\.attn\.qkv_proj": "col",
    r"gpt\.blocks\.\d+\.attn\.out_proj": "row",
    r"gpt\.blocks\.\d+\.mlp\.(fc1|gate_up)": "col",
    r"gpt\.blocks\.\d+\.mlp\.down": "row",
}


def dist_auto_parallel(torch, dist, fa, device, cfg, B, S, steps, dtype,
                       seed=12):
    """GPT through ``auto_parallel``: ``dist.parallelize`` with a
    ``ColWiseParallel`` / ``RowWiseParallel`` plan over the attention and
    MLP linears (``GPT_TP_PLAN``: every key must match a layer) and
    ``dp_config.sharding_level`` 2, on a ("dp", "mp") mesh of [world, 1];
    then ``dist.to_static`` under ``Strategy({"amp": O2 bf16})`` (f32 on
    the CPU), ``steps`` train steps on the global batch (each rank feeds
    its "dp" rows; the main path: the flash launch counts). Held to a bare
    captured TrainStep of the same model, seed, batch and AMP recipe (the
    same loss, under the same ``auto_cast``): at one rank the plans cut
    nothing and ZeRO keeps only its machinery, so the losses and every
    parameter must be bit-equal; across ranks (the CPU rehearsal) the
    losses within 1e-5 relative and every leaf's ``param_gap`` within
    1e-3. On the card the flash kernels must launch ``num_layers`` times
    a step each (rows 3-5) and the step be captured once. Then five rounds of two more steps of each, the forms
    alternating which goes first: ``step_ms`` (median round, host clock)
    and ``dist_over_bare`` (median of the rounds' ratios)."""
    import warnings

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.amp import _amp_cast
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ParallelCrossEntropy,
    )
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    n = dist.get_world_size()
    rng = np.random.default_rng(seed)
    ids_np = rng.integers(0, cfg.vocab_size, (B, S))
    labels_np = np.roll(ids_np, -1, axis=1)
    ids = torch.as_tensor(ids_np, device=device)
    labels = torch.as_tensor(labels_np, device=device)
    bf16 = dtype == "bfloat16"
    amp_cfg = {"enable": bf16, "dtype": "bfloat16", "level": "o2"}

    def loss_fn(logits, lab):
        per_token = ParallelCrossEntropy(mp_group=False)(
            logits.reshape(-1, logits.shape[-1]), lab.reshape(-1))
        return _amp_cast("mean", per_token)[0].mean()

    def make():
        model = GPTForCausalLM(cfg, device=device, seed=seed)
        if bf16:
            amp.decorate(model, level="O2", dtype="bfloat16")
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters(),
                              weight_decay=0.01, multi_precision=True)
        return model, opt

    def cast():
        return (amp.auto_cast(enable=True, level="O2", dtype="bfloat16")
                if bf16 else contextlib.nullcontext())

    rec = {"B": B, "S": S, "steps": steps}
    bare, bopt = make()
    init = [p.detach().clone() for p in bare.parameters()]
    bstep = TrainStep(bare, loss_fn, bopt, split_label=True)
    losses = []
    for _ in range(steps):
        with cast():
            losses.append(bstep(ids, labels).float().clone())
    a = torch.stack(losses)
    rec["bare_losses"] = [float(x) for x in losses]
    after_bare = [p.detach().clone() for p in bare.parameters()]

    mesh = dist.ProcessMesh(np.arange(n).reshape(n, 1), ["dp", "mp"])
    dist.auto_parallel.set_mesh(mesh)
    model, opt = make()
    plan = {k: dist.ColWiseParallel() if v == "col" else
            dist.RowWiseParallel() for k, v in GPT_TP_PLAN.items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, sopt = dist.parallelize(model, opt, config={
            "mp_config": {"parallelize_plan": plan},
            "dp_config": {"sharding_level": 2}})
    rec["unmatched_keys"] = [str(w.message) for w in caught
                             if "matched no layer" in str(w.message)]
    dm = dist.to_static(model, loss=loss_fn, optimizer=sopt,
                        strategy=dist.Strategy({"amp": amp_cfg}))
    dm.train()
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0    # main path
    fa.flash_bwd_dkv.launches = 0
    losses = []
    for _ in range(steps):
        losses.append(dm(ids, labels)._value.float().clone())
    if device != "cpu":
        torch.cuda.synchronize()
    rec["flash_launches"] = flash_launches(fa)             # main path ends
    b = torch.stack(losses)
    rec["losses"] = [float(x) for x in losses]
    step = dm._train_step
    rec.update(captures=step.captures, zero_stage=step._stage.stage,
               zero_group_ranks=step._stage.nranks)
    after = [p.detach().clone() for p in model.parameters()]
    rec["bit_equal"] = bool(torch.equal(a, b))
    rec["max_rel_diff"] = float(((a - b).abs() / a.abs()).max())
    rec["params_bit_equal"] = all(torch.equal(w, d)
                                  for w, d in zip(after_bare, after))
    rec["param_gap"] = max(
        float((d.float() - w.float()).abs().sum()
              / (w.float() - i.float()).abs().sum().clamp(min=1e-30))
        for i, w, d in zip(init, after_bare, after))
    del init, after, after_bare
    ms = {"bare": [], "dist_model": []}
    for rnd in range(5):                    # two more steps each, host clock
        for form in (("bare", "dist_model") if rnd % 2 == 0
                     else ("dist_model", "bare")):
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                if form == "bare":
                    with cast():
                        bstep(ids, labels)
                else:
                    dm(ids, labels)
            if device != "cpu":
                torch.cuda.synchronize()
            ms[form].append((time.perf_counter() - t0) / 2 * 1e3)
    rec["step_ms"] = float(np.median(ms["dist_model"]))
    rec["bare_step_ms"] = float(np.median(ms["bare"]))
    rec["dist_over_bare"] = float(np.median(
        [d / b for d, b in zip(ms["dist_model"], ms["bare"])]))
    rec["step_ms_rounds"] = ms
    dist.set_mesh(None)
    from paddle_tpu_torch.distributed import sharding

    sharding.uninstall(model)
    del dm, step, bstep, model, bare, opt, bopt, sopt
    if device != "cpu":
        torch.cuda.empty_cache()
    want = cfg.num_layers * steps
    rec["predicted_launches"] = {"fwd": want, "dq": want, "dkv": want}
    rec["ok"] = bool(
        not rec["unmatched_keys"]
        and (rec["bit_equal"] and rec["params_bit_equal"] if n == 1
             else rec["max_rel_diff"] <= 1e-5 and rec["param_gap"] <= 1e-3)
        and all(np.isfinite(rec["losses"]))
        and rec["zero_stage"] == 2 and rec["zero_group_ranks"] == n)
    if device != "cpu":
        # the kernels run on the card (the plain versions on the CPU)
        rec["ok"] = (rec["ok"] and rec["captures"] == 1
                     and rec["flash_launches"] == rec["predicted_launches"])
    return rec


def dist_serve(torch, dist, pa, device, cfg, dtype, n_req=4, plen=64,
               new=16):
    """Greedy requests through the continuous scheduler of a whole model,
    then through ``serving_mesh(dp=1, tp=world)`` over the same weights
    (each rank its shards). Tokens must be identical; the paged launches
    of the mesh run are the main path's. At world > 1 (the CPU rehearsal)
    every rank runs a predictor in lockstep and rank 0 serves. At one rank
    (the card) the mesh's tp axis has size 1, so the model gets no tp group
    and the predictor is the plain scheduler (``lockstep`` False): the
    check then holds the plain scheduler against itself over weights that
    went through the bridge, and no distributed serving code runs."""
    from paddle_tpu_torch import from_paddle_tpu_state, to_paddle_tpu_state
    from paddle_tpu_torch.inference import (
        ContinuousGenerateBatchingPredictor,
    )
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    n, me = dist.get_world_size(), dist.get_rank()
    td = getattr(torch, dtype)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, plen).astype(np.int64)
               for _ in range(n_req)]
    kw = dict(max_slots=4, prefill_chunk=64, decode_steps=4,
              max_new_tokens=new, max_seq_len=256, block_size=32,
              num_blocks=4 * 256 // 32, device=device)
    whole = GPTForCausalLM(cfg, device=device, dtype=td, seed=0)
    whole.eval()
    pred = ContinuousGenerateBatchingPredictor(whole, **kw)
    ref = [np.asarray(pred.infer(p, timeout=600)) for p in prompts]
    pred.close()
    state = to_paddle_tpu_state(whole)
    del whole, pred
    mesh = dist.serving_mesh(dp=1, tp=n)
    model = from_paddle_tpu_state(state, cfg, device=device, dtype=td)
    model.eval()
    pa.paged_decode_attention.launches = 0                 # main path
    t0 = time.perf_counter()
    pred = ContinuousGenerateBatchingPredictor(model, **kw)
    got = None
    if me == 0:
        got = [np.asarray(pred.infer(p, timeout=600)) for p in prompts]
    pred.close()
    launches = pa.paged_decode_attention.launches          # main path ends
    rec = dict(tp=mesh.get_dim_size("tp"), requests=n_req, prompt=plen,
               new=new, wall_s=time.perf_counter() - t0,
               lockstep=model.tp_group is not None,
               paged_launches=launches,
               pool_per_chip_bytes=pred.kv_cache.per_chip_pool_bytes(),
               pool_bytes=pred.kv_cache.pool_bytes())
    dist.set_mesh(None)
    if me == 0:
        rec["tokens_equal"] = all(np.array_equal(a, b)
                                  for a, b in zip(got, ref))
        rec["ok"] = rec["tokens_equal"] and all(
            len(a) == plen + new for a in got)
    else:
        rec["follower_runs"] = pred.follower_runs
        rec["ok"] = pred.follower_runs > 0
    if device != "cpu":
        rec["ok"] = rec["ok"] and launches > 0
    del model, pred
    return rec


def dist_shards(torch, pa, fa, device, B, S, H, D, dtype):
    """The kernels on tensor-parallel head shards, as rank r of tp would
    launch them: the paged kernel over its kv heads of a pool (decode and
    a 64-row prefill), the flash forward on each Ulysses head shard
    [B, S, H/tp, D]; each concatenation held against the plain version of
    the whole call within the kernels' tolerance. The pool is random, not
    one a scheduler filled: what tp changes is which heads a launch sees
    (a slice of the pool's head axis and of q's), not the values, tables
    or lengths, and the tables and lengths here are the single-card
    check's (``decode_lengths`` / ``prefill_offsets``). A pool filled by
    the tp = 2 scheduler is driven on the CPU, where the plain version
    stands in for the kernel (``tests/test_torch_mesh_serving.py``)."""
    rng = np.random.default_rng(17)
    rec = {}
    for tp in (2, 4):
        h = H // tp
        for name, Sq in (("paged_decode", 1), ("paged_prefill", 64)):
            lengths = (decode_lengths(rng) if Sq == 1
                       else prefill_offsets(rng))
            args = make_case(torch, 8, Sq, H, 1, D, 32, lengths, dtype,
                             device, seed=tp)
            q, kp, vp, tbl, ln = args
            got = torch.cat([pa.paged_decode_attention(
                q[:, :, r * h:(r + 1) * h], kp[r * h:(r + 1) * h],
                vp[r * h:(r + 1) * h], tbl, ln) for r in range(tp)], dim=2)
            ref = pa.paged_decode_attention_ref(*args)
            err, ratio = held_to_plain(torch, pa, args, got, ref)
            rec[f"{name}_tp{tp}"] = dict(max_abs_err=err, over_limit=ratio,
                                         ok=ratio <= 1.0)
        q, k, v, _ = flash_inputs(torch, B, S, H, H, D, dtype, device, tp)
        outs, lses = zip(*[fa.flash_fwd(q[:, :, r * h:(r + 1) * h],
                                        k[:, :, r * h:(r + 1) * h],
                                        v[:, :, r * h:(r + 1) * h], True)
                           for r in range(tp)])
        ro, rl = fa.flash_attention_fwd_ref(q, k, v, True)
        lim = fa.kernel_tolerance(q, k, v, {"out": ro, "lse": rl}, True)
        lse = torch.cat([x.reshape(B, h, S) for x in lses],
                        dim=1).reshape(B * H, S)          # [B * H, S]
        res = over_limit(torch, {"out": torch.cat(outs, dim=2), "lse": lse},
                         {"out": ro, "lse": rl}, lim)
        rec[f"ulysses_flash_fwd_tp{tp}"] = dict(
            max_abs_err=res["out"][0], over_limit=max(
                r[1] for r in res.values()),
            ok=all(r[1] <= 1.0 for r in res.values()))
    return rec


def dist_ulysses(torch, dist, fa, device, B, S, H, D, dtype):
    """``ulysses_attention`` over the world (the all-to-all, the flash
    kernel on the local heads, the all-to-all back): each rank's output
    shard held against the plain attention of the whole inputs."""
    from paddle_tpu_torch.distributed.context_parallel import (
        ulysses_attention,
    )

    n, me = dist.get_world_size(), dist.get_rank()
    q, k, v, _ = flash_inputs(torch, B, S, H, H, D, dtype, device, 5)
    cut = lambda x: x.chunk(n, dim=1)[me].contiguous()     # noqa: E731
    got = ulysses_attention(cut(q), cut(k), cut(v), causal=True,
                            group=dist.new_group())
    ro, rl = fa.flash_attention_fwd_ref(q, k, v, True)
    lim = fa.kernel_tolerance(q, k, v, {"out": ro, "lse": rl}, True)
    err = (got.float() - cut(ro).float()).abs()
    ratio = float((err / cut(lim["out"]).clamp(min=1e-30)).max())
    return dict(max_abs_err=float(err.max()), over_limit=ratio,
                ok=ratio <= 1.0)


# ------------------------------------------------------- phase: pipeline
PIPE_SCHEDULES = (("1F1B", "1F1B", 1), ("Eager1F1B", "Eager1F1B", 1),
                  ("FThenB", "FThenB", 1), ("ZB-H1", "ZB-H1", 1),
                  ("VPP2", "1F1B", 2))
# the rehearsal's GPT: gpt3_1p3b's family (learned positions, LayerNorm,
# GELU, biases, tied), head dim 128; 11 layers fill VPP 2's 8 chunks
PIPE_TINY = dict(vocab_size=128, hidden_size=256, num_layers=8, num_heads=2,
                 max_position=64, use_rope=False, use_rms_norm=False,
                 use_swiglu=False)
PIPE_CKPT_DIR = os.path.join(ROOT, "_pipeline_ckpt")


def pipe_predicted_launches(model, p, v, m, schedule, mine):
    """One step's flash launches of this rank's chunks, from the streams:
    every F of a chunk other than the last runs its blocks' forward; B
    (and ZB-H1's W) runs the chunk's forward again, then the backward
    (dq and dk/dv per block); ZB-H1's B of the first chunk makes no input
    gradient and runs nothing; the last chunk's F is fused into its B."""
    from paddle_tpu_torch.distributed.fleet.pipeline import (
        _SCHEDULES,
        SegmentLayers,
        _normalize_schedule,
    )
    from paddle_tpu_torch.models.gpt import GPTBlockPipe

    n = p * v
    bounds = SegmentLayers(model.layers_desc, n).do_segment()
    blocks = [sum(1 for i in range(bounds[c], bounds[c + 1])
                  if model.layers_desc[i].layer_func is GPTBlockPipe)
              for c in range(n)]
    gen, split = _SCHEDULES[_normalize_schedule(schedule)]
    fwd = bwd = 0
    for c, stream in enumerate(gen(n, m)):
        if not mine(c):
            continue
        for op, _ in stream:
            if op == "F":
                fwd += blocks[c] if c < n - 1 else 0
            elif split and op == "B" and c == 0 and n > 1:
                continue
            else:
                fwd += blocks[c]
                bwd += blocks[c]
    return {"fwd": fwd, "dq": bwd, "dkv": bwd}


def _pipe_tensors(model):
    return {k: getattr(t, "_value", t) for k, t in model.state_dict().items()}


def _pipe_sums(got, want, init):
    """(sum |got - want|, sum |want - init|) of one leaf, on got's device
    (the snapshots may be host copies)."""
    dev = got.device
    want, init = want.to(dev).float(), init.to(dev).float()
    return (float((got.detach().float() - want).abs().sum()),
            float((want - init).abs().sum()))


def _pipe_gap(torch, got, want, init):
    diff, moved = _pipe_sums(got, want, init)
    return diff / max(moved, 1e-30)


def _pipe_model_gap(torch, got, want, init):
    """The gap over the whole model: every leaf's summed difference over
    every leaf's summed movement."""
    sums = [_pipe_sums(got[k], want[k], init[k]) for k in got]
    return sum(d for d, _ in sums) / max(sum(m for _, m in sums), 1e-30)


def pipe_gpt(torch, dist, fa, device, tiny=False, plant=None, seed=21):
    """(a), (d), (e): ``gpt_pipeline(gpt3_1p3b(), num_stages=4)`` (every
    stage in this process at one rank; the rehearsal's world-n ranks one
    stage each) under ``PipelineParallel``, B 4, S 2048, O2 bf16 with
    LayerNorm f32, AdamW with f32 masters, ``accumulate_steps`` 4: three
    steps of each schedule from one saved state, held to the unpipelined
    micro-batch accumulation of the same model and batches (the engine's
    random contract: micro-batch i from the generator seeded with one
    draw + i). Loss limit: 2 bf16 ulps at the loss's magnitude (each
    micro-batch's loss is a bf16 mean; the tied embedding's gradient sums
    its two uses in another order, so later steps may round apart); f32
    (the rehearsal) 1e-5 relative. Parameters: the whole model's gap
    (every leaf's summed difference over every leaf's summed movement)
    within 1e-2 and every leaf's ``param_gap`` within 0.25. AdamW's
    normalised update turns a last-bit difference on an element with a
    tiny second moment into a step-sized one, and a zero-initialised bias
    moves little: such a leaf read 0.072-0.078 on the card in bf16 (the
    first probe; the rehearsal's f32 ~1e-2, its chunks' boundary values
    from the no-grad forward, whose CPU kernels may round apart from the
    recompute's); the planted fault reads ~0.75 on the tied weight. The
    worst leaf's ``worst_leaf_low_v_share``: the share of its summed
    difference on the tenth of its elements with the smallest AdamW
    second moment (0.1 if spread evenly); of a ``qkv_proj.bias``,
    ``worst_leaf_key_share``: the share on its key third. A control at
    every world size:
    1F1B with micro-batch 0's B and W dropped from the global order (a
    lost micro-batch) must fail the parameter gate on its own.
    Launches: each flash kernel's count
    in the main path's steps equals the streams' prediction. Peak
    allocated bytes of a pipelined step and of an unpipelined one, and the
    1F1B step's host-clock ms. ``plant="skip_shared_sum"`` leaves the
    tied weight's copies unsynced (pp > 1), which the gate must refuse."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import pipeline as pl
    from paddle_tpu_torch.distributed.fleet.base import (
        set_hybrid_communicate_group,
    )
    from paddle_tpu_torch.framework import default_generator
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt3_1p3b, gpt_pipeline

    n, me = dist.get_world_size(), dist.get_rank()
    cfg = GPTConfig(**PIPE_TINY) if tiny else gpt3_1p3b()
    B, S, m, steps = (4, 64, 4, 3) if tiny else (4, 2048, 4, 3)
    bf16 = device != "cpu"
    p = 4 if n == 1 else n
    rng = np.random.default_rng(seed)
    ids_np = rng.integers(0, cfg.vocab_size, (B, S))
    ids = torch.as_tensor(ids_np, device=device)
    labels = torch.as_tensor(np.roll(ids_np, -1, axis=1), device=device)
    gen = default_generator(device)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def peak_reset():
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return (int(torch.cuda.max_memory_allocated()) if device != "cpu"
                else None)

    def new_opt(model):
        return optimizer.AdamW(learning_rate=1e-4,
                               parameters=model.parameters(),
                               weight_decay=0.01, multi_precision=True)

    def build(num_stages, vpp=1):
        model = gpt_pipeline(cfg, num_stages=num_stages, device=device,
                             seed=seed, num_virtual_pipeline_stages=vpp)
        if bf16:
            amp.decorate(model, level="O2", dtype="bfloat16")
        return model

    # the reference: the whole model, unpipelined
    set_hybrid_communicate_group(None)
    ref = build(1)
    # host copies: the card holds what the steps hold, for the peaks
    init = {k: t.detach().to("cpu", copy=True)
            for k, t in _pipe_tensors(ref).items()}
    opt = new_opt(ref)
    mx, my = ids.chunk(m), labels.chunk(m)
    ref_losses, ref_ms = [], []
    for step in range(steps):
        sync()
        peak_reset()
        plain_base = (int(torch.cuda.memory_allocated())
                      if device != "cpu" else None)
        t0 = time.perf_counter()
        s = pl.micro_seed(gen)
        after = gen.get_state()
        total = 0
        for i in range(m):
            gen.manual_seed(s + i)
            loss = ref.loss_fn(ref(mx[i]), my[i])
            (loss / m).backward()
            total = total + loss.detach().float()
        gen.set_state(after)
        opt.step()
        opt.clear_grad()
        sync()
        ref_ms.append((time.perf_counter() - t0) * 1e3)
        ref_losses.append(float(total / m))
    plain_peak = peak()
    ref_after = {k: t.detach().to("cpu", copy=True)
                 for k, t in _pipe_tensors(ref).items()}
    # the last loss's graph reaches the parameters (its AccumulateGrad
    # nodes): drop it with the model
    del ref, opt, loss, total
    if device != "cpu":
        release(torch)

    hcg, strategy = None, None
    if n > 1:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs.update(pp_degree=n)
        hcg = fleet.HybridCommunicateGroup(strategy=strategy)
        set_hybrid_communicate_group(hcg)
    out = {"B": B, "S": S, "accumulate_steps": m, "stages": p,
           "layers": cfg.num_layers, "ref_losses": ref_losses,
           "ref_step_ms": ref_ms, "plain_peak_bytes": plain_peak,
           "plain_base_bytes": plain_base,
           "schedules": {}}
    built = {"model": None, "v": None}

    def low_v_share(model, opt, leaf, got):
        """The share of ``leaf``'s summed difference from the unpipelined
        run that sits on its elements in the lowest tenth of AdamW's second
        moment (0.1 if the difference spreads evenly)."""
        params = {k: getattr(q, "_value", q)
                  for k, q in model.named_parameters()}
        store = opt._accumulators.get("moment2", {})
        q = params.get(leaf)
        if q is None or id(q) not in store:
            return None
        v = store[id(q)].detach().float().flatten()
        d = (got.detach().float().flatten()
             - ref_after[leaf].to(got.device).float().flatten()).abs()
        if float(d.sum()) == 0.0:
            return None
        cut = v.kthvalue(max(1, v.numel() // 10)).values
        return float(d[v <= cut].sum() / d.sum())

    def key_share(leaf, got):
        """Of a ``qkv_proj.bias``: the share of its summed difference from
        the unpipelined run on its key third (whose gradient is zero in
        exact arithmetic: softmax ignores a constant per query)."""
        if not leaf.endswith("qkv_proj.bias"):
            return None
        lo = cfg.hidden_size
        hi = lo + cfg.num_kv_heads * (cfg.hidden_size // cfg.num_heads)
        d = (got.detach().float().flatten()
             - ref_after[leaf].to(got.device).float().flatten()).abs()
        total = float(d.sum())
        return float(d[lo:hi].sum()) / total if total else None

    def run_schedule(sched, v, fault=None):
        """Three steps of ``sched`` from the saved state, gated against
        the unpipelined run. ``fault="skip_backward"`` drops micro-batch
        0's B and W from the global order (a lost micro-batch)."""
        if built["model"] is None or (n > 1 and built["v"] != v):
            built["model"] = None
            if device != "cpu":
                release(torch)
            built["model"] = build(p, v if n > 1 else 1)
            built["v"] = v
        model = built["model"]
        live = _pipe_tensors(model)
        with torch.no_grad():
            for k, t in live.items():
                t.copy_(init[k])
        if fault == "skip_shared_sum":
            model._shared_groups = {}

        class _Cfg:
            pipeline_configs = {"accumulate_steps": m, "schedule_mode": sched}
            hybrid_configs = {"pp_configs": {"virtual_pp_degree": v}}

        wrapper = pl.PipelineParallel(model, hcg, strategy=_Cfg())
        opt = new_opt(model)
        wrapper._build_engine()
        eng = wrapper._engine
        if fault == "skip_backward":
            eng._orders[(m, eng.schedule)] = [
                o for o in pl.global_order(eng.n_chunks, m, eng.schedule)
                if o[1] == "F" or o[2] != 0]
        predicted = pipe_predicted_launches(model, p, v, m, sched, eng.mine)
        losses, ms = [], []
        fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0   # main path
        fa.flash_bwd_dkv.launches = 0
        for step in range(steps):
            sync()
            peak_reset()
            step_base = (int(torch.cuda.memory_allocated())
                         if device != "cpu" else None)
            t0 = time.perf_counter()
            losses.append(float(wrapper.train_batch((ids, labels), opt)))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = flash_launches(fa)                          # main path ends
        step_peak = peak()
        if bf16:
            ulp = [2.0 ** (np.floor(np.log2(abs(x))) - 7)
                   for x in ref_losses]
            limit = [2 * u for u in ulp]
        else:
            limit = [1e-5 * abs(x) for x in ref_losses]
        tensors = _pipe_tensors(model)
        gaps = {k: _pipe_gap(torch, t, ref_after[k], init[k])
                for k, t in tensors.items()}
        model_gap = _pipe_model_gap(torch, tensors, ref_after, init)
        worst = max(gaps, key=gaps.get)
        per_step = {kk: vv // steps for kk, vv in launches.items()}
        r = dict(losses=losses, step_ms=ms, peak_bytes=step_peak,
                 launches=launches, launches_per_step=per_step,
                 predicted_per_step=predicted, loss_limit=limit,
                 max_loss_diff=max(abs(a - b) for a, b in
                                   zip(losses, ref_losses)),
                 param_gap=max(gaps.values()), model_gap=model_gap,
                 worst_leaf=worst,
                 worst_leaf_low_v_share=low_v_share(model, opt, worst,
                                                    tensors[worst]),
                 worst_leaf_key_share=key_share(worst, tensors[worst]),
                 base_bytes=step_base,
                 chunks=sorted(eng.chunks), schedule=eng.schedule)
        r["losses_ok"] = bool(
            all(abs(a - b) <= lim for a, b, lim in
                zip(losses, ref_losses, limit)) and all(np.isfinite(losses)))
        r["params_ok"] = bool(r["param_gap"] <= 0.25 and model_gap <= 1e-2)
        r["launches_ok"] = bool(device == "cpu" or all(
            launches[kk] == steps * predicted[kk] for kk in predicted))
        r["ok"] = r["losses_ok"] and r["params_ok"] and r["launches_ok"]
        del wrapper, opt
        return r

    for name, sched, v in PIPE_SCHEDULES:
        out["schedules"][name] = run_schedule(sched, v, plant)
    # the control: a lost micro-batch must fail the parameter gate alone
    ctl = run_schedule("1F1B", 1, "skip_backward")
    out["control_skip_backward"] = {
        k: ctl[k] for k in ("losses", "max_loss_diff", "param_gap",
                            "model_gap", "worst_leaf", "losses_ok",
                            "params_ok")}
    out["control_failed"] = not ctl["params_ok"]
    model = built.pop("model")
    del model
    if device != "cpu":
        release(torch)
    set_hybrid_communicate_group(None)
    one = out["schedules"]["1F1B"]
    out["step_ms"] = float(np.median(one["step_ms"][1:]))
    out["plain_step_ms"] = float(np.median(ref_ms[1:]))
    out["pipeline_peak_bytes"] = one["peak_bytes"]
    out["pipeline_base_bytes"] = one["base_bytes"]
    out["ok"] = (all(r["ok"] for r in out["schedules"].values())
                 and out["control_failed"])
    return out


def pipe_zero(torch, dist, fa, device, tiny=False, seed=12, steps=3):
    """(b) and (c): GPT-350M (O2 bf16, AdamW, B 8, S 1024) under the
    captured ``jit.TrainStep`` with ``shard_optimizer(opt,
    ShardingStage{1,2,3}("dp", mesh))`` on a "dp" mesh of the world: at
    one rank every stage keeps its collectives (NCCL copies), and the
    parameters after the steps equal the bare TrainStep's bit for bit
    (the rehearsal's ranks: the mean loss within 1e-5 and every leaf's
    gap within 1e-3). Then (c): the ZeRO-1 model and AdamW state through
    ``save_state_dict`` / ``load_state_dict`` into a fresh model and
    optimizer, bit-equal, and the next captured step of each equal; the
    bytes written and the seconds."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import (
        ShardingStage1,
        ShardingStage2,
        ShardingStage3,
    )
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM, gpt_350m

    n, me = dist.get_world_size(), dist.get_rank()
    cfg = GPTConfig(**DIST_TINY) if tiny else gpt_350m()
    B, S = (4, 64) if tiny else (8, 1024)
    rng = np.random.default_rng(seed)
    ids_np = rng.integers(0, cfg.vocab_size, (B, S))
    labels_np = np.roll(ids_np, -1, axis=1)
    mesh = dist.auto_mesh(n, dim_names=["dp"])
    dist.set_mesh(mesh)

    def make(stage=None):
        model = GPTForCausalLM(cfg, device=device, seed=seed)
        if device != "cpu":
            amp.decorate(model, level="O2", dtype="bfloat16")
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters(),
                              weight_decay=0.01, multi_precision=True)
        zero = stage("dp", mesh) if stage is not None else None
        sopt = dist.shard_optimizer(opt, zero) if zero else opt
        return model, opt, zero, TrainStep(model, lambda lg, ls: ls, sopt)

    def run(step, rows, k):
        ids = torch.as_tensor(ids_np[rows], device=device)
        labels = torch.as_tensor(labels_np[rows], device=device)
        out = []
        for _ in range(k):
            loss = step(ids, labels=labels).float()
            if n > 1:
                dist.all_reduce(loss, op="avg")
            out.append(float(loss))
        return out

    whole = slice(None)
    mine = slice(me * B // n, (me + 1) * B // n)
    bare, _, _, bstep = make()
    init = {k: t.detach().clone() for k, t in bare.named_parameters()}
    bare_losses = run(bstep, whole, steps)
    bare_after = {k: t.detach().clone() for k, t in bare.named_parameters()}
    del bare, bstep
    if device != "cpu":
        release(torch)
    rec = {"B": B, "S": S, "steps": steps, "bare_losses": bare_losses,
           "stages": {}}
    keep = None
    for k, cls in ((1, ShardingStage1), (2, ShardingStage2),
                   (3, ShardingStage3)):
        model, opt, zero, step = make(cls)
        losses = run(step, mine if n > 1 else whole, steps)
        equal, gaps, rows = True, {}, {}
        for name, t in model.named_parameters():
            want = bare_after[name]
            w0 = init[name]
            lo_hi = getattr(t, "_zero_rows", None)
            if k == 3 and lo_hi is not None:
                want, w0 = want[lo_hi[0]:lo_hi[1]], w0[lo_hi[0]:lo_hi[1]]
                rows[name] = list(t.shape)
            equal = equal and torch.equal(t.detach(), want)
            gaps[name] = _pipe_gap(torch, t.detach(), want, w0)
        r = dict(losses=losses, params_bit_equal=bool(equal),
                 param_gap=max(gaps.values()), captures=step.captures,
                 replays=step.replays,
                 sliced=sum(1 for t in model.parameters()
                            if getattr(t, "_zero_rows", None) is not None))
        r["ok"] = bool((equal and losses == bare_losses) if n == 1 else (
            max(abs(a - b) / abs(b) for a, b in zip(losses, bare_losses))
            <= 1e-5 and r["param_gap"] <= 1e-3))
        if device != "cpu":
            r["ok"] = r["ok"] and r["captures"] == 1
        rec["stages"][f"zero{k}"] = r
        if k == 1:
            keep = (model, opt, zero, step)
        else:
            del model, opt, zero, step
            if device != "cpu":
                release(torch)
    rec["checkpoint"] = pipe_checkpoint(torch, dist, device, keep, make,
                                        run, mine if n > 1 else whole)
    del keep
    dist.set_mesh(None)
    rec["ok"] = (all(r["ok"] for r in rec["stages"].values())
                 and rec["checkpoint"]["ok"])
    return rec


def pipe_checkpoint(torch, dist, device, keep, make, run, rows):
    """(c): the ZeRO-1 run's model and AdamW state saved, loaded into a
    fresh model and optimizer (bit-equal), then one more captured step of
    each (equal)."""
    from paddle_tpu_torch.distributed import ShardingStage1
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    model, opt, zero, step = keep
    me = dist.get_rank()
    if me == 0:
        shutil.rmtree(PIPE_CKPT_DIR, ignore_errors=True)
    dist.barrier()
    t0 = time.perf_counter()
    ckpt.save_state_dict({"model": model.state_dict(keep_vars=True),
                          "opt": opt.state_dict()}, PIPE_CKPT_DIR)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(PIPE_CKPT_DIR, f))
                 for f in os.listdir(PIPE_CKPT_DIR))
    fresh, fopt, fzero, fstep = make(ShardingStage1)
    fopt._materialize_accumulators(list(fstep._params))
    t0 = time.perf_counter()
    target = {"model": fresh.state_dict(keep_vars=True),
              "opt": fopt.state_dict()}
    ckpt.load_state_dict(target, PIPE_CKPT_DIR)
    fopt.set_state_dict(target["opt"])
    if device != "cpu":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(
        fresh.parameters(), model.parameters()))
    sd_a, sd_b = opt.state_dict(), fopt.state_dict()
    same_opt = all(
        (torch.equal(sd_a[k], sd_b[k]) if isinstance(sd_a[k], torch.Tensor)
         else sd_a[k] == sd_b[k]) for k in sd_a)
    cont_a = run(step, rows, 1)
    cont_b = run(fstep, rows, 1)
    after = all(torch.equal(a, b) for a, b in zip(
        fresh.parameters(), model.parameters()))
    dist.barrier()
    if me == 0:
        shutil.rmtree(PIPE_CKPT_DIR, ignore_errors=True)
    rec = dict(bytes=nbytes, save_s=save_s, load_s=load_s,
               params_bit_equal=bool(same), opt_bit_equal=bool(same_opt),
               next_loss=cont_a, next_loss_restored=cont_b,
               next_params_bit_equal=bool(after))
    rec["ok"] = bool(same and same_opt and after and cont_a == cont_b)
    return rec


def distributed_worker(args):
    """One rank of the distributed phase, started by the port's launcher
    (``python -m paddle_tpu_torch.distributed.launch``): joins the process
    group from the launcher's environment (NCCL on the card, gloo on the
    CPU), runs the checks and writes its record to
    ``args.dist_out/rank<r>.json`` (its pid first, so the phase can stop
    it)."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_350m
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    device = args.dist_device
    if device == "cpu":
        torch.set_num_threads(1)     # the ranks share the host's cores
        os.nice(10)                  # below the tests that rehearse it
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    with open(os.path.join(args.dist_out, f"pid{rank}"), "w") as f:
        f.write(str(os.getpid()))
    t0 = time.perf_counter()
    env = dist.init_parallel_env(device=device, timeout=120)
    dev = str(dist.env.device())
    world = env.world_size
    rec = dict(rank=env.rank, world=world, backend=dist.get_backend(),
               init_s=time.perf_counter() - t0)
    if args.dist_plant == "raise" and env.rank == world - 1:
        raise RuntimeError("planted failure on the last rank")
    tiny = args.dist_tiny
    cfg = GPTConfig(**DIST_TINY) if tiny else gpt_350m()
    dtype = "float32" if tiny else "bfloat16"
    rec["collectives"] = dist_collectives(torch, dist, dev)
    rec["train"] = dist_train(torch, dist, fa, dev, cfg, 4 if tiny else 8,
                              64 if tiny else 1024, 4, dtype,
                              plant=args.dist_plant)
    t1 = time.perf_counter()
    rec["auto_parallel"] = dist_auto_parallel(
        torch, dist, fa, dev, cfg, 4 if tiny else 8, 64 if tiny else 1024,
        4, dtype)
    rec["auto_parallel"]["wall_s"] = time.perf_counter() - t1
    rec["serve"] = dist_serve(torch, dist, pa, dev, cfg, dtype,
                              new=8 if tiny else 16)
    shape = (2, 128, 4, 64) if tiny else (8, 1024, 16, 64)
    rec["shards"] = dist_shards(torch, pa, fa, dev, *shape, dtype)
    rec["ulysses"] = dist_ulysses(torch, dist, fa, dev, *shape, dtype)
    rec["wall_s"] = time.perf_counter() - t0
    # the pipeline phase, in the same worker
    t1 = time.perf_counter()
    if device != "cpu":
        release(torch)
    rec["pipeline"] = {
        "gpt": pipe_gpt(torch, dist, fa, dev, tiny=tiny,
                        plant=args.dist_plant),
        "zero": pipe_zero(torch, dist, fa, dev, tiny=tiny)}
    rec["pipeline"]["wall_s"] = time.perf_counter() - t1
    # expert parallelism, SyncBatchNorm and rpc, in the same worker
    t1 = time.perf_counter()
    if device != "cpu":
        release(torch)
    rec["moe_ep"] = dist_moe_ep(torch, dist, dev, (2, 16, 32, 4, 64) if tiny
                                else (8, 1024, 1024, 8, 4096))
    rec["moe_ep"]["wall_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rec["sync_bn"] = dist_sync_bn(torch, dist, dev, tiny)
    rec["sync_bn"]["wall_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rec["rpc"] = dist_rpc(torch, dist)
    rec["rpc"]["wall_s"] = time.perf_counter() - t1
    # the launcher's side: its store's server and this rank's heartbeats
    store, hb = dist.env.store(), dist.env.heartbeat()
    rec["launcher"] = {
        "server": store.get("job/server").decode() if store else None,
        "heartbeats": hb.beats if hb is not None else 0,
        "heartbeat_seen": bool(store is not None and store.get(
            f"hb/{env.rank}", wait=False) is not None),
        "attempt": int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))}
    rec["launcher"]["ok"] = (rec["launcher"]["server"] == "native"
                             and rec["launcher"]["heartbeats"] >= 1
                             and rec["launcher"]["heartbeat_seen"])
    rec["failures"] = (
        [k for k, ok in rec["collectives"].items() if not ok]
        + [k for k in ("train", "auto_parallel", "serve", "ulysses",
                       "launcher", "moe_ep", "sync_bn", "rpc")
           if not rec[k]["ok"]]
        + [k for k, r in rec["shards"].items() if not r["ok"]]
        + [f"pipeline.{k}" for k in ("gpt", "zero")
           if not rec["pipeline"][k]["ok"]])
    with open(os.path.join(args.dist_out, f"rank{env.rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


@contextlib.contextmanager
def _place(device):
    """The port's layers build on ``device`` within."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.framework import device as pdev

    prev = pdev._current["place"]
    P.set_device("cpu" if device == "cpu" else "gpu:0")
    try:
        yield P
    finally:
        pdev._current["place"] = prev


def dist_moe_ep(torch, dist, device, shape, seed=31):
    """``MoELayer`` (gshard top-2, index dispatch, bf16 on the card) built
    with ``moe_group=`` the world group, so its dispatch and return go
    through ``global_scatter`` / ``global_gather`` (NCCL's all-to-all on
    the card), against the same layer built without a group from the
    same weights. At one rank the forward, ``l_aux`` and every gradient
    must be bit-equal; across ranks (the CPU rehearsal, f32) each rank's
    output equals the no-group layer on its own tokens within 1e-5 of its
    largest magnitude (the capacity is per source rank). The fwd + bwd
    device times of both (``time_ms``, one call at a time), their ratio
    and a profile of each (``profile_call``), and the all-to-all launches
    of one fwd + bwd (``a2a_launches``: two forward, two backward)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.collective import _world
    from paddle_tpu_torch.distributed.utils import moe_utils
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    mb, ms_, D, E, F_ = shape
    n = dist.get_world_size()
    bf16 = device != "cpu"
    with _place(device) as P:
        layers = {}
        for form, group in (("ep", _world()), ("bare", None)):
            P.seed(seed)
            experts = [P.nn.Sequential(P.nn.Linear(D, F_), P.nn.GELU(),
                                       P.nn.Linear(F_, D))
                       for _ in range(E)]
            layers[form] = MoELayer(D, experts, gate="gshard",
                                    moe_group=group)
            if bf16:
                amp.decorate(layers[form], level="O2", dtype="bfloat16")
    ep, bare = layers["ep"], layers["bare"]
    with torch.no_grad():       # the same weights: the ep layer's slice
        names = dict(torch.nn.Module.named_parameters(bare))
        lo = ep.ep_group.rank * len(ep.experts)
        for k, p in torch.nn.Module.named_parameters(ep):
            if k.startswith("experts."):
                i, rest = k[len("experts."):].split(".", 1)
                k = f"experts.{lo + int(i)}.{rest}"
            p.copy_(names[k])
    gen = torch.Generator(device=device).manual_seed(seed + dist.get_rank())
    x = torch.randn(mb, ms_, D, device=device, generator=gen)
    if bf16:
        x = x.to(torch.bfloat16)
    before = moe_utils.launches
    ye, le, ge = moe_grads(torch, ep, x)
    a2a = moe_utils.launches - before
    yb, lb, gb = moe_grads(torch, bare, x)
    rec = dict(shape=list(shape), ranks=n, ep_local_experts=len(ep.experts),
               dtype="bfloat16" if bf16 else "float32", a2a_launches=a2a,
               dropped=int(ep.dropped), capacity=ep.gate.capacity_for(
                   mb * ms_))
    if n == 1:
        rec["out_bit_equal"] = bool(torch.equal(ye, yb))
        rec["l_aux_bit_equal"] = bool(torch.equal(le, lb))
        rec["grads_bit_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(ge, gb))
        rec["ok"] = (rec["out_bit_equal"] and rec["l_aux_bit_equal"]
                     and rec["grads_bit_equal"])
    else:
        rec["out_rel"] = float((ye.float() - yb.float()).abs().max()
                               / yb.float().abs().max().clamp(min=1e-30))
        rec["ok"] = rec["out_rel"] <= 1e-5
    rec["ok"] = bool(rec["ok"] and a2a == 4)
    del ye, yb, ge, gb
    if device != "cpu":
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        rec["ep_fwd_bwd_ms"] = time_ms(torch, lambda: moe_grads(
            torch, ep, x), flush, reps=5, queued=False)
        rec["bare_fwd_bwd_ms"] = time_ms(torch, lambda: moe_grads(
            torch, bare, x), flush, reps=5, queued=False)
        rec["ep_over_bare"] = rec["ep_fwd_bwd_ms"] / rec["bare_fwd_bwd_ms"]
        del flush

        def traced(layer):
            def call():
                moe_grads(torch, layer, x)
                torch.cuda.synchronize()
            return call

        # where the two calls' device time goes, kernel by kernel
        rec["ep_profile"] = profile_call(torch, traced(ep))
        rec["bare_profile"] = profile_call(torch, traced(bare))
    del ep, bare, layers, x
    return rec


def _bn_net(P, tiny):
    """ResNet-50 (NHWC, 1000 classes) on the card; a small conv net with
    two batch norms in the CPU rehearsal."""
    if not tiny:
        return P.vision.models.resnet50(num_classes=1000, data_format="NHWC")
    nn = P.nn
    return nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1, data_format="NHWC"),
        nn.BatchNorm2D(8, data_format="NHWC"), nn.ReLU(),
        nn.Conv2D(8, 8, 3, padding=1, data_format="NHWC"),
        nn.BatchNorm2D(8, data_format="NHWC"), nn.ReLU(),
        nn.AdaptiveAvgPool2D(1, data_format="NHWC"), nn.Flatten(),
        nn.Linear(8, 10))


def _state_copy(model):
    """Copies of every parameter and buffer of a paddle-style layer."""
    return [getattr(t, "_value", t).detach().clone()
            for t in model.state_dict().values()]


def dist_sync_bn(torch, dist, device, tiny, B=32, hw=224, steps=2,
                 seed=33):
    """ResNet-50 converted by ``SyncBatchNorm.convert_sync_batchnorm`` under
    ``DataParallel`` (O2 bf16 on the card, Momentum, this rank's rows),
    against the bare ``BatchNorm`` model on the whole batch, each through
    a ``TrainStep`` (``steps`` calls: the capture, then replays; cuDNN
    deterministic). At one rank the losses, parameters and running
    statistics must be bit-equal; across ranks (the CPU rehearsal, f32)
    the mean of the ranks' losses within 1e-5 relative and the state's
    gap within 1e-3 of how far it moved. Then three rounds of two more
    steps each, the forms alternating (``step_ms``, host clock)."""
    from paddle_tpu_torch import amp, nn, optimizer
    from paddle_tpu_torch.jit import TrainStep

    n, me = dist.get_world_size(), dist.get_rank()
    if tiny:
        B, hw = 8, 8
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rec, after, live, init = {}, {}, {}, None
    try:
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn(B, hw, hw, 3, device=device, generator=gen)
        y = torch.randint(0, 10 if tiny else 1000, (B,), device=device,
                          generator=gen)
        if not tiny:
            x = x.to(torch.bfloat16)
        with _place(device) as P:
            for form in ("bare", "sync"):
                P.seed(seed)
                model = _bn_net(P, tiny)
                if not tiny:
                    amp.decorate(model, level="O2", dtype="bfloat16")
                if form == "bare":
                    init = _state_copy(model)
                    net = model
                    rows = slice(None)
                else:
                    model = nn.SyncBatchNorm.convert_sync_batchnorm(model)
                    net = dist.DataParallel(model)
                    rows = slice(me * B // n, (me + 1) * B // n)
                loss_fn = nn.CrossEntropyLoss()
                opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                         parameters=model.parameters(),
                                         multi_precision=True)
                step = TrainStep(net, lambda out, t: loss_fn(out, t), opt)
                xt, yt = P.Tensor(x[rows]), P.Tensor(y[rows])
                losses = []
                for _ in range(steps):
                    loss = step(xt, yt)
                    loss = getattr(loss, "_value", loss).float().detach() \
                        .clone()
                    if form == "sync":
                        dist.all_reduce(loss, op="avg")
                    losses.append(loss)
                rec[form] = dict(losses=[float(v) for v in losses],
                                 kinds=sorted({type(m).__name__
                                               for m in model.sublayers()
                                               if "BatchNorm" in
                                               type(m).__name__}))
                after[form] = (_state_copy(model), torch.stack(losses))
                live[form] = (step, xt, yt)
        ms = {form: [] for form in live}
        for rnd in range(3):
            for form in (("bare", "sync") if rnd % 2 == 0
                         else ("sync", "bare")):
                step, xt, yt = live[form]
                if device != "cpu":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2):
                    step(xt, yt)
                if device != "cpu":
                    torch.cuda.synchronize()
                ms[form].append((time.perf_counter() - t0) / 2 * 1e3)
        for form, (step, _, _) in live.items():
            rec[form].update(step_ms=float(np.median(ms[form])),
                             step_ms_rounds=ms[form],
                             captures=step.captures, replays=step.replays)
        rec["sync_over_bare"] = float(np.median(
            [s / b for s, b in zip(ms["sync"], ms["bare"])]))
    finally:
        torch.backends.cudnn.deterministic = prev_det
    (wb, lb), (ws, ls) = after["bare"], after["sync"]
    rec["losses_bit_equal"] = bool(torch.equal(lb, ls))
    rec["state_bit_equal"] = all(torch.equal(a, b) for a, b in zip(wb, ws))
    rec["max_rel_diff"] = float(((lb - ls).abs() / lb.abs()).max())
    # the whole state's gap as a share of how far it moved (a conv bias
    # before a batch norm has a zero gradient up to rounding: its own
    # movement is noise)
    moved = [(i, b, s_) for i, b, s_ in zip(init, wb, ws)
             if i.is_floating_point()]
    rec["param_gap"] = float(
        sum((s_.float() - b.float()).abs().sum() for _, b, s_ in moved)
        / sum((b.float() - i.float()).abs().sum() for i, b, _ in moved))
    rec["ok"] = bool(rec["losses_bit_equal"] and rec["state_bit_equal"]
                     if n == 1 else rec["max_rel_diff"] <= 1e-5
                     and rec["param_gap"] <= 1e-3)
    rec["ok"] = bool(rec["ok"] and rec["sync"]["kinds"] == ["SyncBatchNorm"]
                     and "SyncBatchNorm" not in rec["bare"]["kinds"])
    del live, after, init
    if device != "cpu":
        release(torch)
    return rec


def dist_rpc(torch, dist, reps=50):
    """``distributed.rpc`` over the launcher's store: a round trip to this
    rank itself and one to the next rank, ``reps`` timed calls to self
    (``latency_ms``: the median, host clock)."""
    from paddle_tpu_torch.distributed import rpc

    rank, world = dist.get_rank(), dist.get_world_size()
    store = dist.env.store()
    rpc.init_rpc(name=f"worker{rank}", rank=rank, world_size=world)
    try:
        me = rpc.rpc_sync(f"worker{rank}", pow, args=(rank + 3, 2))
        peer = rpc.rpc_sync(f"worker{(rank + 1) % world}", pow,
                            args=(rank + 2, 2))
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            rpc.rpc_sync(rank, max, args=(1, 2))
            lat.append((time.perf_counter() - t0) * 1e3)
        workers = [w.name for w in rpc.get_all_worker_infos()]
    finally:
        rpc.shutdown()
    server = store.get("job/server").decode() if store else None
    rec = dict(self_answer=me, peer_answer=peer, workers=workers,
               latency_ms=float(np.median(lat)),
               latency_ms_p90=float(np.percentile(lat, 90)), reps=reps,
               server=server)
    rec["ok"] = bool(me == (rank + 3) ** 2 and peer == (rank + 2) ** 2
                     and workers == [f"worker{r}" for r in range(world)]
                     and server == "native")
    return rec


def _stop(pids):
    """SIGKILL each of the phase's ranks still alive (a pid whose command
    line is still a distributed worker's)."""
    import signal

    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if b"--distributed-worker" not in f.read():
                    continue
            os.kill(pid, signal.SIGKILL)
        except (OSError, ProcessLookupError, PermissionError):
            pass


def distributed_phase(world=1, device="cuda", tiny=False, plant=None,
                      timeout=600):
    """The distributed phase: ``world`` ranks started by the port's
    launcher (``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node <world> --backend nccl``, gloo on the CPU, where the
    tests rehearse it at two; NCCL at one rank on the card), each rank a
    ``--distributed-worker`` of this script. Fails if the launcher exits
    with another code than 0 (a rank that raises fails the pod) or a check
    of any rank does not hold; returns rank 0's record with the
    launcher's exit code and the stream of its log."""
    import signal

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(world),
           "--backend", "gloo" if device == "cpu" else "nccl",
           "--log_dir", os.path.join(tmp, "log"),
           "--heartbeat_interval", "1", "--heartbeat_timeout", "600",
           "--stop_grace", "10",
           os.path.abspath(__file__), "--distributed-worker",
           "--dist-device", device, "--dist-out", tmp]
    cmd += ["--dist-tiny"] if tiny else []
    cmd += ["--dist-plant", plant] if plant else []
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    launcher = subprocess.Popen(
        cmd, cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        # the CPU rehearsal's processes below the tests beside it
        preexec_fn=(lambda: os.nice(10)) if device == "cpu" else None)
    try:
        try:
            out, _ = launcher.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            launcher.send_signal(signal.SIGINT)     # tears its pod down
            try:
                out, _ = launcher.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                launcher.kill()
                out, _ = launcher.communicate()
        code = launcher.returncode
        recs = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            recs.append(json.load(open(path)) if os.path.exists(path)
                        else None)
        if code != 0 or any(r is None for r in recs):
            logs = ""
            for r in range(world):
                lp = os.path.join(tmp, "log", f"workerlog.{r}")
                if os.path.exists(lp):
                    logs += f"--- workerlog.{r} ---\n" + open(lp).read()[-3000:]
            raise AssertionError(
                f"distributed phase: launcher exit code {code}, rank exit "
                f"codes in its log {out.strip()!r}; ranks with a record "
                f"{[r is not None for r in recs]}\n{logs}")
        bad = {r["rank"]: {k: (r["pipeline"][k.split(".", 1)[1]]
                               if k.startswith("pipeline.")
                               else r.get(k, r["collectives"].get(k)))
                           for k in r["failures"]}
               for r in recs if r["failures"]}
        if bad:
            raise AssertionError(f"distributed phase: failed checks "
                                 f"{json.dumps(bad)}")
        rec = recs[0]
        rec["launcher"].update(exit_code=code, output=out.strip(),
                               ranks=world)
        return rec
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
        pids = []
        for r in range(world):
            pp = os.path.join(tmp, f"pid{r}")
            if os.path.exists(pp):
                pids.append(int(open(pp).read() or 0))
        _stop([p for p in pids if p])
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def phase(name):
    """Record the wall seconds of the block under ``name`` and the bytes
    the allocator holds live as it ends."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[name] = time.perf_counter() - t0
        PHASE_ALLOCATED[name] = sys.modules["torch"].cuda.memory_allocated()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the full record to this file")
    # the script phase's fresh processes (script_worker)
    ap.add_argument("--script-fit", choices=("preempt", "resume"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--script-dir", help=argparse.SUPPRESS)
    ap.add_argument("--script-out", help=argparse.SUPPRESS)
    # the distributed phase's ranks (distributed_worker)
    ap.add_argument("--distributed-worker", action="store_true",
                    help=argparse.SUPPRESS)
    for name, typ in (("device", str), ("out", str), ("plant", str)):
        ap.add_argument(f"--dist-{name}", type=typ, help=argparse.SUPPRESS)
    ap.add_argument("--dist-tiny", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.script_fit:
        script_worker(args.script_fit, args.script_dir, args.script_out)
        return
    if args.distributed_worker:
        distributed_worker(args)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on a GPU")
    device = "cuda"
    card = card_line()
    print("card:", card, flush=True)

    from paddle_tpu_torch.inference import PagedKVCache
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    # the plain versions' f32 products stay in full f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    with phase("build"):
        log = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, rec in log.items():
        ptxas[name] = ptxas_summary(rec["ptxas"])
        print(f"build {name}: {rec['seconds']:.1f} s nvcc; ptxas "
              + "; ".join(f"{k} {r} registers, {s} bytes spilled"
                          for k, r, s in ptxas[name]), flush=True)
    print(f"build: {build_s:.1f} s total", flush=True)

    with phase("kernel_checks_and_times"):
        checks, worst = check_kernels(torch, pa, device)
        timing = time_kernels(torch, pa, device)
        timing_f16 = time_kernels(torch, pa, device, "float16",
                                  ("decode", "prefill"))
        flash_checks, flash_worst = check_flash_kernels(torch, fa, device)
        flash_timing = time_flash(torch, fa, device)

    t0 = time.perf_counter()
    model = GPTForCausalLM(gpt_350m(), device=device, dtype=torch.bfloat16,
                           seed=0)
    torch.cuda.synchronize()
    print(f"model: GPT-350M bf16, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    with phase("serve"):
        insitu = insitu_check(torch, model, PagedKVCache, device)
        steps = profile_steps(torch, model, PagedKVCache, device)
        steps["generate"] = dense_graphs(torch, model, device)
        serving = serve(torch, model, device)
    print(f"serving on {card}: prefill {serving['prefill_tok_per_s']:.0f} "
          f"tok/s, decode {serving['decode_tok_per_s']:.0f} tok/s",
          flush=True)
    with phase("serve_knobs"):
        knobs = serve_knobs(torch, model, device)
    print(f"serve_knobs on {card}: {knobs['tok_per_s']:.0f} tok/s, "
          f"{knobs['prefill_tokens_saved']} prefill tokens saved, "
          f"acceptance {knobs['acceptance_rate']:.3f}, first token "
          f"{knobs['ttft']['cold']['seconds'] * 1e3:.1f} ms cold / "
          f"{knobs['ttft']['prefix_hit']['seconds'] * 1e3:.1f} ms prefix "
          f"hit, greedy tokens compared {knobs['compared_tokens']}, "
          f"indexed rows vs cold {max(knobs['prefix_rows']['rel']):.2e} "
          f"(swapped page {knobs['prefix_rows']['control']:.2e})",
          flush=True)
    with phase("serve_production"):
        prod = serve_production(torch, model, device)
    r = prod["rates_tok_per_s"]

    def ratio(d):
        return (f"{d['ratio']:.3f}, turn spread {d['spread']:.3f}, "
                f"{'resolved' if d['resolved'] else 'unresolved'}")
    print(f"serve_production on {card}: {np.median(r['lora']):.0f} tok/s "
          f"with adapters against {np.median(r['base']):.0f} without "
          f"({ratio(prod['adapters_over_base'])}), monitors on "
          f"{np.median(r['monitored']):.0f} "
          f"({ratio(prod['monitored_over_quiet'])} of off), "
          f"{prod['launches_per_forward']:.0f} paged launches a "
          f"forward, captures per replica "
          f"{prod['fleet']['captures_per_replica']}, shared graph pool "
          f"grown by {prod['fleet']['shared_graph_pool_growth_bytes']} "
          f"bytes by the replicas' warmups, "
          f"{prod['wall_s']:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    with phase("dense_checks_and_times"):
        dense_checks, dense_worst = check_dense_kernels(torch, da, device)
        dense_timing = time_dense_kernels(torch, da, device)
        dense_timing_f16 = time_dense_kernels(torch, da, device, "float16",
                                              ("decode", "prefill"))
    with phase("f16_serve"):
        f16 = f16_serve(torch, device)
    release(torch)

    t0 = time.perf_counter()
    model = GPTForCausalLM(gpt_350m(), device=device, seed=0)   # f32
    torch.cuda.synchronize()
    print(f"model: GPT-350M f32 (bf16 cast for generate), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with phase("generation"):
        gen_insitu = dense_insitu(torch, model, device)
        gen = generation(torch, model, device)
    print(f"generate() on {card}: prefill {gen['prefill_tok_per_s']:.0f} "
          f"tok/s, decode {gen['decode_tok_per_s']:.0f} tok/s", flush=True)
    with phase("batch_serve"):
        gen_profile = profile_dense_step(torch, model, device)
        batch = batch_serve(torch, model, device)
    print(f"batch-serve on {card}: " + ", ".join(
        f"{r['round']} {r['tok_per_s']:.1f} tok/s ({r['captures']} "
        f"captures, batches {r['batch_sizes']})" for r in batch["rounds"]),
        flush=True)
    with phase("speculative"):
        degrade = degrade_check(torch, model, device)
        spec = speculative(torch, model, device)
    print(f"speculative on {card}: acceptance "
          f"{spec['stats']['acceptance_rate']}, {spec['tok_per_s']:.1f} "
          f"tok/s, {spec['compared_tokens']} tokens compared", flush=True)
    del model
    torch.cuda.empty_cache()
    with phase("train"):
        training, train_checks = train(torch, fa, device)
    print(f"training on {card}: {training['step_ms']:.1f} ms/step replayed "
          f"({training['body_step_ms']:.1f} as bodies), "
          f"{training['tokens_per_s']:.0f} tok/s, "
          f"{training['bf16_peak_share']:.3f} of the bf16 peak", flush=True)
    with phase("script"):
        script = script_phase(torch, fa, device, training)
    print(f"script on {card}: fit {script['step_ms']:.1f} ms/step replayed "
          f"in TrainStep.__call__, {script['batch_ms']:.1f} ms batch begin "
          f"to end (TrainStep alone {training['step_ms']:.1f}), busy "
          f"{script['device_busy_share']:.3f}, "
          f"{script['tokens_per_s']:.0f} tok/s; checkpoint "
          f"{script['checkpoint']['bytes']} bytes, snapshots "
          f"{script['checkpoint']['snapshot_s']} s, serialize and commit "
          f"{script['checkpoint']['write_s']} s; resume "
          f"{script['resumed']['wall_s']:.1f} s; export "
          f"{script['export']['seconds']:.1f} s, "
          f"{script['export']['bytes']} bytes, load "
          f"{script['export']['load_s']:.1f} s; predictor "
          f"{script['export']['predictor_ms']:.1f} ms, program "
          f"{script['export']['program_ms']:.1f} ms, eager forward "
          f"{script['export']['eager_ms']:.1f} ms; peak "
          f"{script['max_memory_allocated']} bytes", flush=True)
    release(torch)
    with phase("train_monitor"):
        tmon = train_monitor(torch, fa, device)
    r = tmon["monitored_over_bare"]
    print(f"train_monitor on {card}: monitored / bare "
          f"{r['ratio']:.4f} (turn spread {r['spread']:.4f}, "
          f"{'resolved' if r['resolved'] else 'unresolved'}; paired by "
          f"round {r['paired']['ratio']:.4f}, spread "
          f"{r['paired']['spread']:.4f}, "
          f"{'resolved' if r['paired']['resolved'] else 'unresolved'}, "
          f"cost at most {r['paired']['cost_at_most']:.4f}), live MFU "
          f"{tmon['live_mfu']['mfu']:.4f} against a model-FLOP share of "
          f"{tmon['live_mfu']['model_flop_share']:.4f} "
          f"(ratio {tmon['live_mfu']['mfu_over_model_share']:.4f}), host "
          f"launch calls {tmon['host_launch_calls']}, {tmon['wall_s']:.1f} s",
          flush=True)
    release(torch)
    with phase("incubate"):
        incub = incubate_phase(torch, device)
    print(f"incubate on {card}: fused vs nn {incub['g']['fused_vs_nn']:.2e} "
          f"(limit {incub['g']['limit']:.2e}), MoE index vs dense "
          f"{incub['i']['worst_rel']:.2e} (limit {incub['i']['bound']:.2e}"
          f"), MoE bf16 fwd+bwd {incub['i']['bf16_fwd_bwd_ms']:.2f} ms, "
          f"fused stack bf16 step "
          f"{incub['h']['step_ms']:.1f} ms, {incub['wall_s']:.1f} s",
          flush=True)
    release(torch)
    with phase("long_context"):
        long_ctx = long_context(torch, fa, device)
    for key, r in long_ctx.items():
        print(f"long-context {key} on {card}: {r['step_ms']:.1f} ms/step, "
              f"{r['tokens_per_s']:.0f} tok/s, {r['bf16_peak_share']:.3f} "
              f"of the bf16 peak", flush=True)
    with phase("train_recipes"):
        recipes = train_recipes(torch, fa, device,
                                training["max_memory_allocated"])
    recipes["o2_autocast"]["legless_step_ms"] = training["step_ms"]
    recipes["o2_autocast"]["legless_body_step_ms"] = training["body_step_ms"]
    for key, r in recipes.items():
        print(f"train-recipe {key} on {card}: {r['step_ms']:.1f} ms/step, "
              f"{r['tokens_per_s']:.0f} tok/s, peak "
              f"{r['max_memory_allocated']} bytes, busy "
              f"{r['device_busy_share']:.2f}", flush=True)
    with phase("optimizers"):
        optimizers = optimizer_steps(torch, device)
    with phase("rnn_lm"):
        lm = rnn_lm(torch, device)
    print(f"rnn_lm on {card}: {lm['step_ms']:.1f} ms/step replayed "
          f"({lm['body_step_ms']:.1f} as bodies), {lm['tokens_per_s']:.0f} "
          f"tok/s, {lm['host_launch_calls']} host launch calls a replay "
          f"({lm['body_host_launch_calls']} a body); beam search "
          f"{lm['decode']['ms']:.1f} ms for {lm['decode']['steps']} steps",
          flush=True)
    with phase("flashmask"):
        fm_checks, fm_worst = check_flashmask_kernels(torch, fa, device)
        fm_timing = {dt: time_flashmask(torch, fa, device, dt)
                     for dt in ("bfloat16", "float16")}
    with phase("varlen_train"):
        varlen, varlen_checks = varlen_train(torch, fa, device)
    print(f"varlen training on {card}: {varlen['step_ms']:.1f} ms/step "
          f"captured, {varlen['tokens_per_s']:.0f} tok/s, busy "
          f"{varlen['device_busy_share']:.2f}", flush=True)

    # the other model families, each on a card released of the earlier ones.
    # cuBLAS keeps a 32 MiB workspace from the allocator for each stream it
    # ran on; one left inside a large segment holds all of it reserved
    # (one run: a 512 MiB segment held by one such block, 1.15 GB in all).
    # No graph of an earlier phase runs again, so none needs its workspace.
    torch._C._cuda_clearCublasWorkspaces()
    reserved = release(torch)
    held = reserved_segments(torch)
    print(f"reserved before the LLaMA-2-7B phases: {reserved} bytes; "
          f"segments {held}; live bytes as each phase ended "
          f"{PHASE_ALLOCATED}", flush=True)
    if reserved > 1 << 30:
        raise AssertionError(f"{reserved} bytes still reserved: an earlier "
                             f"model, pool or graph is alive ({held})")
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b

    t0 = time.perf_counter()
    llama = LlamaForCausalLM(llama2_7b(), device=device,
                             dtype=torch.bfloat16, seed=0)
    llama.eval()
    torch.cuda.synchronize()
    print(f"model: LLaMA-2-7B bf16, "
          f"{sum(p.numel() for p in llama.parameters()) / 1e9:.2f} B params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    with phase("llama_serve"):
        l_serve = llama_serve(torch, llama, device)
    with phase("llama_generate"):
        l_gen = llama_generate(torch, llama, device)
    print(f"llama_generate on {card}: decode "
          f"{l_gen['generation']['decode_tok_per_s']:.0f} tok/s", flush=True)
    del llama
    release(torch)
    with phase("llama_train"):
        l_train = llama_train(torch, fa, device)
    print(f"llama_train on {card}: {l_train['layers']} layers, "
          f"{l_train['step_ms']:.1f} ms/step, {l_train['tokens_per_s']:.0f} "
          f"tok/s, {l_train['bf16_peak_share']:.3f} of the bf16 peak, peak "
          f"{l_train['max_memory_allocated']} bytes", flush=True)
    release(torch)
    with phase("gpt3_1p3b"):
        g3 = gpt3_1p3b_phase(torch, fa, device)
    release(torch)
    with phase("bert_base"):
        bert = bert_base_phase(torch, fa, device)
    print(f"bert_base on {card}: {bert['step_ms']:.1f} ms/step, eval "
          f"forward {bert['eval_ms']:.1f} ms", flush=True)
    release(torch)
    with phase("resnet50"):
        resnet = resnet50_phase(torch, device)
    print(f"resnet50 on {card}: {resnet['step_ms']:.1f} ms/step replayed "
          f"({resnet['body_step_ms']:.1f} as bodies), "
          f"{resnet['images_per_s']:.0f} images/s, "
          f"{resnet['bf16_peak_share']:.3f} of the bf16 peak, peak "
          f"{resnet['max_memory_allocated']} bytes", flush=True)
    release(torch)
    with phase("core"):
        core = core_phase(torch, fa, device)
    st = core["eager_stack"]
    print(f"core on {card}: nn fill-ins {core['nn_fillins']['cases']} "
          f"cases x 2 dtypes, worst {core['nn_fillins']['worst']}; "
          f"cross-length attention on the plain route", flush=True)
    print(f"core on {card}: golden {core['golden']['float64']['cases']} "
          f"cases x 2 dtypes, {core['golden']['float64']['captured']} + "
          f"{core['golden']['float32']['captured']} captured; eager "
          f"op-layer stack {np.median(st['step_ms'][1:]):.1f} ms/step "
          f"against the model's {np.median(st['model_step_ms'][1:]):.1f}",
          flush=True)
    release(torch)
    with phase("distributed"):
        dist_rec = distributed_phase()
    tr, sv = dist_rec["train"], dist_rec["serve"]
    print(f"distributed on {card}: {dist_rec['backend']} at world "
          f"{dist_rec['world']} (init {dist_rec['init_s']:.1f} s); "
          f"collectives {sum(dist_rec['collectives'].values())}/"
          f"{len(dist_rec['collectives'])} held", flush=True)
    print(f"distributed on {card}: GPT-350M DataParallel TrainStep losses "
          f"{tr['data_parallel']['losses']} against the bare TrainStep's "
          f"{tr['bare']['losses']}: bit-equal {tr['bit_equal']}; "
          f"{tr['data_parallel']['step_ms']:.1f} ms a step against "
          f"{tr['bare']['step_ms']:.1f} (median of 5 alternating rounds; "
          f"ratio {tr['dp_over_bare']:.4f}); parameters bit-equal "
          f"{tr['params_bit_equal']}; gradient syncs "
          f"{tr['data_parallel']['syncs']} (first run, capture); flash "
          f"launches {tr['data_parallel']['flash_launches']}",
          flush=True)
    print(f"distributed on {card}: serving_mesh(dp=1, tp={sv['tp']}) "
          f"greedy tokens equal to the plain scheduler's "
          f"{sv['tokens_equal']} ({sv['requests']} requests, "
          f"{sv['paged_launches']} paged launches; lockstep "
          f"{sv['lockstep']}: at tp = 1 the mesh is a no-op and the plain "
          f"scheduler served)", flush=True)
    for key, r in sorted(dist_rec["shards"].items()):
        print(f"distributed on {card}: {key} max |kernel - plain| "
              f"{r['max_abs_err']:.3e}, {r['over_limit']:.3f} of the "
              f"limit", flush=True)
    ap = dist_rec["auto_parallel"]
    print(f"distributed on {card}: auto_parallel GPT-350M "
          f"(parallelize: ColWise/RowWise plan over {len(GPT_TP_PLAN)} "
          f"keys, ZeRO-{ap['zero_stage']}; to_static under Strategy.amp "
          f"O2 bf16) losses {ap['losses']} against the bare TrainStep's "
          f"{ap['bare_losses']}: bit-equal {ap['bit_equal']}, parameters "
          f"bit-equal {ap['params_bit_equal']}; {ap['step_ms']:.1f} ms a "
          f"step against {ap['bare_step_ms']:.1f} (median of 5 alternating "
          f"rounds; ratio {ap['dist_over_bare']:.4f}); flash launches "
          f"{ap['flash_launches']} (predicted {ap['predicted_launches']}); "
          f"leg {ap['wall_s']:.1f} s", flush=True)
    la = dist_rec["launcher"]
    print(f"distributed on {card}: started by the port's launcher "
          f"({la['ranks']} rank(s), store server {la['server']}, "
          f"{la['heartbeats']} heartbeats sent, seen in the store "
          f"{la['heartbeat_seen']}, exit code {la['exit_code']})",
          flush=True)
    u = dist_rec["ulysses"]
    print(f"distributed on {card}: ulysses_attention (world "
          f"{dist_rec['world']}) max |err| {u['max_abs_err']:.3e}, "
          f"{u['over_limit']:.3f} of the limit; phase "
          f"{dist_rec['wall_s']:.1f} s in the worker", flush=True)
    pipe = dist_rec["pipeline"]
    PHASE_S["distributed.pipeline"] = pipe["wall_s"]    # within it
    pg, pz = pipe["gpt"], pipe["zero"]
    pg["captured_gpt3_1p3b_step_ms"] = g3["training"]["step_ms"]
    pg["over_captured_step"] = pg["step_ms"] / g3["training"]["step_ms"]
    for name, r in pg["schedules"].items():
        print(f"pipeline on {card}: gpt3_1p3b {pg['stages']} stages "
              f"{name} (B {pg['B']}, S {pg['S']}, {pg['accumulate_steps']} "
              f"micro-batches, O2 bf16) losses {r['losses']} against the "
              f"unpipelined {pg['ref_losses']} (limit {r['loss_limit']}); "
              f"param_gap {r['param_gap']:.3e} ({r['worst_leaf']}), whole "
              f"model {r['model_gap']:.3e}; flash "
              f"launches a step {r['launches_per_step']}, predicted "
              f"{r['predicted_per_step']}", flush=True)
    c = pg["control_skip_backward"]
    print(f"pipeline on {card}: control, 1F1B with micro-batch 0's "
          f"backward dropped: param_gap {c['param_gap']:.3e} "
          f"({c['worst_leaf']}, limit 0.25), whole model "
          f"{c['model_gap']:.3e} (limit 1e-2), max loss diff "
          f"{c['max_loss_diff']:.3e}: refused {pg['control_failed']}; "
          f"the sound runs' worst leaf carries "
          f"{[r['worst_leaf_low_v_share'] for r in pg['schedules'].values()]}"
          f" of its difference on its lowest-second-moment tenth and "
          f"{[r['worst_leaf_key_share'] for r in pg['schedules'].values()]}"
          f" on its key third", flush=True)
    print(f"pipeline on {card}: 1F1B step {pg['step_ms']:.1f} ms against "
          f"the unpipelined accumulation's {pg['plain_step_ms']:.1f} and "
          f"the captured gpt3_1p3b step's {g3['training']['step_ms']:.1f} "
          f"(host clock); peak allocated {pg['pipeline_peak_bytes']} bytes "
          f"against {pg['plain_peak_bytes']} unpipelined (held before the "
          f"step {pg['pipeline_base_bytes']} and {pg['plain_base_bytes']})",
          flush=True)
    for k, r in pz["stages"].items():
        print(f"pipeline on {card}: GPT-350M {k} captured TrainStep "
              f"losses {r['losses']} against bare {pz['bare_losses']}: "
              f"parameters bit-equal {r['params_bit_equal']}, "
              f"{r['sliced']} parameters in rows, captures "
              f"{r['captures']}", flush=True)
    ck = pz["checkpoint"]
    print(f"pipeline on {card}: ZeRO-1 GPT-350M checkpoint {ck['bytes']} "
          f"bytes saved in {ck['save_s']:.2f} s, loaded in "
          f"{ck['load_s']:.2f} s; restored bit-equal "
          f"{ck['params_bit_equal'] and ck['opt_bit_equal']}, next step "
          f"equal {ck['next_params_bit_equal']}; phase "
          f"{pipe['wall_s']:.1f} s in the worker", flush=True)

    d = timing["decode"]
    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:245",
        "launches": serving["kernel_launches"],
        "serve_knobs_launches": knobs["kernel_launches"],
        "serve_production_launches": prod["kernel_launches"],
        "batch_serve_launches": batch["paged_launches"],
        "max_abs_err": worst["bfloat16"],
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"],
        "prefill": {k: timing["prefill"][k] for k in
                    ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")},
        "d128": d128_reading(timing, worst["d128"]),
        "llama_serve_launches": l_serve["serving"]["kernel_launches"],
        "gpt3_1p3b_serve_launches": g3["serving"]["kernel_launches"],
        # serving_mesh(dp=1, tp=1) on the card: the plain scheduler served
        "mesh_tp1_serve_launches": sv["paged_launches"],
    }]
    d = timing_f16["decode"]
    kernels.append({
        "name": "paged_decode_attention_f16",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:245",
        "dtype": "float16",
        "launches": f16["paged_launches"],
        "max_abs_err": worst["float16"],
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"],
        "prefill": {k: timing_f16["prefill"][k] for k in READING_KEYS}})
    g = dense_timing["decode"]
    kernels.append({
        "name": "decode_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:135",
        "launches": gen["kernel_launches"],
        "max_abs_err": dense_worst["bfloat16"],
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "prefill": {k: dense_timing["prefill"][k] for k in
                    ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")},
        "d128": d128_reading(dense_timing, dense_worst["d128"]),
        "llama_generate_launches":
            l_gen["generation"]["kernel_launches"],
    })
    g = dense_timing_f16["decode"]
    kernels.append({
        "name": "decode_attention_f16",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:135",
        "dtype": "float16",
        "launches": f16["generate"]["dense_launches"],
        "max_abs_err": dense_worst["float16"],
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "prefill": {k: dense_timing_f16["prefill"][k]
                    for k in READING_KEYS}})
    src = "paddle_tpu/ops/pallas/flash_attention.py"
    f16_leg = recipes["o2_f16_grad_scaler"]["kernel_launches"]
    for kern, name, replaces, also in (
            ("fwd", "flash_attention_fwd", f"{src}:89", []),
            ("dq", "flash_attention_dq", f"{src}:166", [f"{src}:230"]),
            ("dkv", "flash_attention_dkv", f"{src}:196", [f"{src}:272"])):
        t = flash_timing["train"][kern]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "also_replaces": also,
            "launches": training["flash_launches"][kern],
            "long_context_launches": {
                k: r["flash_launches"][kern] for k, r in long_ctx.items()},
            "train_recipes_launches": {
                k: r["kernel_launches"][kern] for k, r in recipes.items()
                if k != "o2_f16_grad_scaler"},
            "max_abs_err": flash_worst["bfloat16"][kern],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library_call": t["library_call"],
            "s8192": {k: flash_timing["s8192"][kern][k] for k in
                      ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")},
            "d128": dict(shape="llama_train B 1, S 2048, H 32, causal",
                         **flash_reading(flash_timing["llama"][kern],
                                         flash_worst["llama"][kern])),
            "bert": dict(shape="bert_base B 32, S 512, H 12, non-causal",
                         **flash_reading(flash_timing["bert"][kern],
                                         flash_worst["bert"][kern])),
            "llama_train_launches": l_train["flash_launches"][kern],
            "gpt3_1p3b_train_launches":
                g3["training"]["flash_launches"][kern],
            "bert_eval_launches": (bert["eval_flash_launches"]
                                   if kern == "fwd" else 0),
            "bert_train_launches": bert["train_flash_launches"][kern],
            "core_eager_stack_launches": [
                x[kern] for x in core["eager_stack"]["flash_launches"]],
            "script_fit_launches": script["flash_launches"][kern],
            "train_monitor_launches": tmon["flash_launches"][kern],
            "script_served_launches": (
                {b: script["export"][f"{b}_launches"] for b in ("b8", "b2")}
                if kern == "fwd" else {}),
            "distributed_launches":
                tr["data_parallel"]["flash_launches"][kern],
            "auto_parallel_launches":
                dist_rec["auto_parallel"]["flash_launches"][kern],
            "pipeline_launches": {
                name: r["launches"][kern]
                for name, r in pg["schedules"].items()}})
        t = flash_timing["train_f16"][kern]
        kernels.append({
            "name": f"{name}_f16", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "also_replaces": also, "dtype": "float16",
            "launches": f16_leg[kern],
            "max_abs_err": flash_worst["float16"][kern],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library_call": t["library_call"]})
    for kern, name, line in (("fwd", "flashmask_fwd", 89),
                             ("dq", "flashmask_dq", 166),
                             ("dkv", "flashmask_dkv", 196)):
        for dt, suffix, launches in (
                ("bfloat16", "", varlen["masked_launches"][f"fm_{kern}"]),
                ("float16", "_f16",
                 varlen["f16"]["masked_launches"][f"fm_{kern}"])):
            t = fm_timing[dt][kern]
            kernels.append({
                "name": name + suffix, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"{src}:{line}", "has_sri": True, "dtype": dt,
                "launches": launches,
                "max_abs_err": t["max_abs_err"],
                "err_over_limit": t["err_over_limit"],
                "small_cases_max_abs_err": fm_worst[dt][kern],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                "library_call": t["library_call"],
                "library_backend": t["library_backend"],
                "unmasked_ms": t["unmasked_ms"]})
    for kern in kernels:
        if kern["name"] in REDESIGNED:
            kern["redesigned"] = REDESIGNED[kern["name"]]
    record = dict(card=card, build_s=build_s, ptxas=ptxas, checks=checks,
                  timing=timing, timing_f16=timing_f16,
                  dense_timing_f16=dense_timing_f16, f16_serve=f16,
                  core=core,
                  insitu=insitu, profile=steps, serving=serving,
                  serve_knobs=knobs, serve_production=prod,
                  flash_checks=flash_checks, flash_timing=flash_timing,
                  dense_checks=dense_checks, dense_timing=dense_timing,
                  dense_insitu=gen_insitu, generation=gen,
                  dense_profile=gen_profile, batch_serving=batch,
                  degrade=degrade, speculative=spec,
                  train_insitu=train_checks, training=training,
                  script=script, train_monitor=tmon, incubate=incub,
                  long_context=long_ctx, train_recipes=recipes,
                  optimizers=optimizers, rnn_lm=lm,
                  flashmask_checks=fm_checks, flashmask_timing=fm_timing,
                  varlen_insitu=varlen_checks, varlen_train=varlen,
                  llama_serve=l_serve, llama_generate=l_gen,
                  llama_train=l_train, gpt3_1p3b=g3, bert_base=bert,
                  resnet50=resnet, distributed=dist_rec,
                  phase_s=PHASE_S, phase_allocated=PHASE_ALLOCATED,
                  kernels=kernels)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    print("phases", json.dumps({k: round(v, 1) for k, v in
                                PHASE_S.items()}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
