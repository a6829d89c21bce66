#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

    python3 chip_smoke.py            # from the repo root; needs one CUDA GPU

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. build the port's CUDA kernels from ``paddle_tpu_torch/ops/cuda/csrc``
   with nvcc (one process per source, in parallel);
2. hold each kernel against its plain PyTorch version on the GPU at the
   served shapes (BERT-base: rows 8x128 and 8x512, D = 768 / 3072; the
   LayerNorm and add+LayerNorm forwards also at R = 1, 128 and 512, at
   D = 128, 896, 4096 and 8192 on 300 rows and on views 4 bytes off the
   vector alignment, bit-identical across two launches; flash
   B = 8, H = 12, S = 128 and 512, D = 64 with padding, per-head, no bias
   and causal; bit-identical across two launches), float32 and bfloat16
   (flash also float16), and time kernel, plain version and one PyTorch
   library call (CUDA events, median of 25);
3. serve BERT-base at full width (12 layers, random weights from a seed)
   through save_inference_model → AnalysisPredictor (default passes) →
   ServingEngine: 16 bursts of 24 mixed-length requests, each burst
   drained before the next; check every result against a lone run of its
   padded request and against the plain path (kernel flags off), and
   prove the three served kernels launched with zero route fallbacks;
4. the unfused program (``switch_ir_optim(False)``): the LayerNorm kernel
   launches and the outputs match phase 3;
5. the attention pattern matmul → scale → add mask → softmax → dropout
   (test mode) → matmul, fused by ``multihead_matmul_fuse`` into a
   ``multihead_matmul`` op: the flash kernel launches and the output
   matches the plain path and the unfused program;
6. the training kernels against their plain versions at BERT-base
   training shapes: flash forward with dropout 0.1 and 0, beside SDPA at
   the same rate, and its dq and dk/dv kernels (B = 32, S = 128 and B = 8,
   S = 512; padding bias and causal; float32, bfloat16 and float16; one
   seed, so the masks are bit-identical; o, lse, dq, dk and dv
   bit-identical across two launches; in float32 with the padding
   bias, kernels and twin each against the same backward in float64; the
   pair timed, beside the library's backward with the same dropout rate,
   at 0.1 and at 0; both routes of the backward's plan at head dims 64,
   128 and 256 on padded and rectangular shapes, the FMA route also with
   the score-gradient scratch capped, the 16-bit cases in bf16 and
   float16 with their forward held too),
   LayerNorm backward (R = 4096 and 640, D = 768) and the multi-tensor
   Adam (runs of one at the word embedding's 23,440,896 elements,
   2,359,296, 768 and 2; all 158 BERT-base parameters as one run, adam
   and adamw, beside one ``_fused_adam_`` / ``_fused_adamw_`` call; the
   beta powers advanced once; then 16-bit parameters: bf16 p with float32
   m and v, all-bf16 and fp16 p with float32 m and v at the 158-tensor
   run, and those and all-fp16 at one 768 x 3072 weight, every output
   bit for bit equal to the twin's at an LR, AdamW decay and |p| at which
   the step and the decay each move most of p past its rounding, two
   launches bit-identical; timed at the recipe's LR beside
   ``_fused_adam_``), timed like phase 2;
   and the fused-training
   kernels: add+LayerNorm backward (R = 4096 and 1000, plus 1003 for a
   ragged last row block, D = 768) and bias+GELU backward (R = 4096,
   D = 3072 and R = 640, D = 768, plus R = 1003), float32 and bfloat16.
   Both LayerNorm backwards also at R = 1, at D = 128, 896, 4096 and
   8192 (one to 16 warps a row; the gate's edges) on 300 rows, and on
   views 4 bytes off the vector alignment (the scalar instantiation);
   their dscale/dbias bit-identical across two launches, and their row
   and column passes timed apart by ``torch.profiler`` at the main-path
   shapes;
7. train BERT-base at full width and depth (random weights from a seed,
   Adam 1e-4, dropout 0.1 as published) for 10 steps through
   ``Executor.prepare(donate_state=True)`` on a pretraining batch of
   32 x 128 tokens with 20 masked positions per sequence: the loss is
   finite and falls, no route falls back, and each step launches 12 flash
   forward, 12 dq, 12 dk/dv, 26 LayerNorm forward and backward and one
   Adam kernel for the 158 adam ops; one more step runs under
   ``torch.profiler`` for the
   device time by kernel and the device's busy share of a step; then,
   with dropout 0, 3 steps with every kernel on against every kernel
   flag off (the plain compositions) agree;
8. train BERT-base at full width and depth through the fused program and
   the published optimizer recipe: ``fuse_add_layernorm`` applied, then
   ``CompiledProgram(main).with_data_parallel(build_strategy=
   BuildStrategy(fuse_elewise_add_act_ops=True))`` prepared with
   ``donate_state=True``; AdamW with weight decay 0.01, gradients clipped
   to global norm 1.0, the LR warmed up linearly to 1e-4 and decayed
   linearly to 0 over 1,000,000 steps.  The warmup is cut from the
   published 10,000 steps to 3 so the loss moves within the 10 steps.
   Same batch and dropout as phase 7.  The loss is finite and falls, the
   LR read back each step is the schedule's closed form, no route falls
   back, and each step launches 25 add+LN forward and backward, 1 LN
   forward and backward, 13 bias+GELU forward and backward, 12 flash
   forward, dq and dk/dv and one Adam kernel for the 158 adamw ops; one
   more step runs under
   the profiler; then, with dropout 0, 3 steps with every kernel on
   against every kernel flag off agree;
9. the receive-stage kernels of the quantized gradient all-reduce against
   their plain versions: dequant-accumulate (#11) and
   dequant-accumulate-requantize (#12) on synthetic peer payloads at the
   shard shapes of a BERT-base step's 13 buckets (n = 2 with SB = 45,783,
   the word embedding, 14,618, 13,844, ten layer buckets, and 16,217;
   n = 3, 4 and 8 with a ragged SB = 1,003), int8 at block 256, int4 at
   blocks 256 and 128, and payload views 1 and 3 bytes past 16-byte
   alignment: #12's payload bit-identical and its scales within 2e-6,
   #11 within 1e-5 and 1e-6 of each block's max, each case a counted
   launch of the CUDA kernel; timed like phase 2 and
   by profiler device time; then the step's 13 launches in bucket order
   as one chain (events and profiler device time);
10. data-parallel BERT-base: two ranks on the one card
   (``python -m paddle_tpu_torch.distributed.launch --nproc 2
   --selected_gpus 0,0 --backend gloo``; NCCL refuses two ranks of one
   communicator on one GPU, so gloo carries the wire bytes through the
   host while everything else runs on the card), each running this script
   as ``--dp-worker``: the phase-8 program and recipe through ``fleet``
   with ``quant_allreduce`` on the phase-8 global batch (16 rows per
   rank), 10 steps in the int8 tier and 3 in the int4 tier.  Each rank
   checks 13 ``c_fused_quant_allreduce_sum`` buckets, 13 launches of #12
   (int8) or #11 (int4) per step, the phase-8 kernels' launches per step,
   no route fallback, gloo and its device, a finite falling loss, and
   reports per tier its step time, one profiled step's device-busy share
   and #12's or #11's launches and device time in it, and the wall time
   of its collectives (gloo staged through the host on a shared card: no
   measure of NVLink); the parent holds the ranks' parameters
   bit-identical after each leg, and 3 dropout-free int8 steps on two
   ranks against 3 single-GPU steps: the losses within the int8 tier's
   bound 5e-2, and Adam's first moments (linear in the reduced gradients)
   within four int8 quanta (4/127) as a relative norm;
11. paged-KV decode at BERT-base width (12 layers, hidden 768, vocab
   30522, random weights from the seed) through ``DecodeEngine(
   BertDecoder(cfg), DecodeConfig(block_size=16, max_seq_len=512,
   max_batch_size=8, prefill buckets 64-512, 4 segments a row, 32 new
   tokens, chains of 1 and 8, prefix cache)).generate`` over a pool of
   256 blocks (302 MB): 16 greedy requests of 16-384 prompt tokens in two
   bursts of 8 (the second once the first's chains run; four of it share
   a 64-token prefix with one of the first and hit the prefix cache).
   Every request's tokens equal ``greedy_reference``'s (a divergence is
   allowed once, and only where the reference's top-2 logit gap is under
   1e-4); 12 flash forward and 25 LayerNorm forward launches per forward
   (prefill, chunk or decode step), no other launch, no route fallback;
   one chain of 8 runs with host syncs made errors.  A second engine
   with ``sampling=True`` draws the same tokens for four requests in two
   submission orders, its greedy row the greedy run's.  Printed:
   tokens/s, TTFT p50/p99, ms per chain step at B8 and B1, prefill ms per
   bucket, one profiled chain's device time by kernel group and busy
   share.  Kernel #1 is held against its twin at the decode step's shape
   (B8 H12 Sq1 T512 D64 with a padded, all-masked row) and the chunk's
   (Sq 512, T 512, QPos causal term), timed beside SDPA on the same
   gathered K/V and the gather's own time;
12. bf16 mixed-precision pretraining at BERT-base width and depth
   (``contrib.mixed_precision.decorate``), three legs.  (a) bench.py's
   configuration: ``decorate(Adam(1e-4), use_pure_bf16=True)`` at
   96 x 128 with 20 masks, dropout 0.1: one step through
   ``Executor.run``, then 10 through ``prepare(donate_state=True)``; the
   loss is finite and falls, no route falls back, each step launches 12
   flash forward, 12 dq and 12 dk/dv kernels on bf16 operands, 26
   LayerNorm forward and backward kernels on float32 ones and one Adam
   launch for the 158 adam ops, and every parameter is still float32;
   one profiled step; bench.py's own measure (30 ``Executor.run`` steps,
   fetches left on the card, one sync); the model FLOP share of the bf16
   peak; then, with dropout 0, 3 steps with every kernel on against every
   kernel flag off, losses within 1e-2.  (b) phase 8's program and recipe
   with the optimizer under ``decorate``, 32 x 128, 10 steps: phase 8's
   launches, the flash kernels on bf16, the LR's closed form; its step
   beside phase 8's.  (c) fp16 loss scaling: ``tests/test_amp.py``'s MLP
   under ``decorate(SGD(0.1), use_pure_bf16=False)`` growing the scale
   after 3 good steps and backing it off after 2 bad ones, an inf fed at
   steps 4 and 5: those steps' gradients zeroed, the weights kept, scale
   and counters equal to a host replay at every step, no host sync inside
   a step; then BERT-base under fp16 ``decorate(Adam(1e-4),
   use_pure_bf16=False)`` with dynamic loss scaling at 32 x 128 for 4
   prepared steps: finite losses, 12/12/12 flash launches a step on
   float16 operands, and with dropout 0 kernels on vs every flag off
   within 1e-2.  Kernel #1 and the #2 + #3 pair are held and timed in
   bf16 and float16 at (a)'s shape (B96 H12 S128 D64, padding bias,
   dropout 0.1) like phase 6's rows.  (d) pure bf16: ``decorate(Adam(
   1e-4), use_pure_bf16=True)`` with the parameters cast to bf16 after the
   startup (``cast_parameters_to_bf16``; the moments stay float32), 32 x
   128, 4 prepared steps: finite losses, no route fallback, each step 12
   flash forward, dq and dk/dv on bf16, 25 LayerNorm forward and backward
   on float32 and 1 (the embeddings' LayerNorm) on bf16, one Adam launch
   on bf16 parameters; the parameters still bf16; with dropout 0, kernels
   on vs every flag off within 1e-2 (losses) and 3e-2 (gradients);
13. LAMB pretraining, checkpoint and resume: phase 8's program and recipe
   with ``LambOptimizer(lamb_weight_decay=0.01, epsilon=1e-6,
   exclude_from_weight_decay_fn=...)`` (LayerNorm parameters and biases
   excluded, as the BERT LAMB recipe has it) through
   ``prepare(donate_state=True)``.  Run A: 10 steps, ``save_checkpoint``
   after step 5 (the run goes on); run B: 10 steps from the same seed;
   run C: a new scope and executor, the startup, ``load_checkpoint`` of
   A's checkpoint, ``prepare`` and steps 6-10.  Finite losses, the LR on
   its closed form every step (so the schedule's counter resumed), no
   route fallback, each step phase 8's launches of #1-#9 and no Adam
   launch.  Right after ``load_checkpoint``, C holds A's state at step 5
   bit for bit (every persistable and the generator's state).  If A and
   B agree bit for bit (losses and every persistable), C must agree with
   A bit for bit after step 10; otherwise C lies no further from A than
   ``LAMB_RESUME_MARGIN`` (4) times B's distance from A (the norm of the
   state's difference over every persistable).  Printed: the step time (median of steps 3-10), one
   profiled step's device time split into products, port kernels, LAMB's
   update ops (with their launches) and other, and the seconds
   ``save_checkpoint`` and ``load_checkpoint`` take;
14. recompute, gradient merge and the wrapper optimizers, each through
   ``fleet.distributed_optimizer`` on one rank with phase 8's program and
   recipe and ``prepare(donate_state=True)``.  (a) ``strategy.recompute``
   with one checkpoint a layer (each encoder layer's last LayerNorm
   output) beside the same program without, 10 steps at dropout 0.1 from
   one seed: step-1 loss bit for bit, step-1 gradients within 1e-6 of
   max|grad|, step-10 loss within 1e-4; each step #1 24 times, add+LN
   forward 50, bias+GELU forward 25 (the recomputed segments run again),
   the backward kernels and #10 as phase 8, no fallback; each way the
   peak memory of one step, the median step and a profiled step.
   (b) recompute and ``strategy.gradient_merge`` (k 4, avg) on
   micro-batches of 8 x 128, 8 steps at dropout 0: the merged gradient
   at step 4 within 1e-4 of max|grad| of one step on the same 32 rows;
   on the steps that do not apply every parameter and moment bit for bit
   unchanged; the accumulators zero after each apply; #10 once per apply
   (2 in 8); one predicate read a step.  (c) ``ExponentialMovingAverage(
   0.999, thres_steps=the LR schedule's step)``, ``ModelAverage(0.15,
   2, 4)`` and ``LookaheadOptimizer(AdamW, 0.5, 2)``, 3 steps each: EMA's
   ``apply`` within one float32 ulp of ``ema / (1 - prod decay_t)``, the
   ``restore`` of both bit for bit, Lookahead's fast weights equal to
   its slow ones after each sync step; EMA's update ops timed in a
   profiled step.  (d) ``strategy.use_dgc`` on Momentum(1e-3, 0.9), 3
   steps: the word embedding's threshold (23.4 M elements) within one
   float32 ulp of ``np.quantile`` in float64, 0.1 % of its elements sent
   (± 1), U, V and the parameter the op's formula bit for bit; the 158
   DGC updates timed in a profiled step.  (e) ``strategy.localsgd`` (k
   2) on two ranks of the card over gloo (phase 10's launcher, each rank
   its 16 rows), 4 steps: no gradient all-reduce in the program, the
   parameters sha256-equal across the ranks after steps 2 and 4 and not
   after 3 (step 1 runs at the warmup's LR 0 and moves nothing);
15. ZeRO at BERT-base width (hidden 768, 12 heads, intermediate 3072,
   the full vocabulary) and 2 layers (``CUT_LAYERS``; phases 15-17 are cut
   in depth only, their launch counts derived from the depth,
   ``fused_launches``, and the adamw ops counted in the built program) on
   two ranks of the card over gloo (phase 10's launcher, each rank its 16
   of the 32 x 128 rows, dropout 0.1): phase 8's program with the recipe
   less its global-norm clip (ZeRO-1 refuses a norm clip), 6 prepared
   steps a leg.  (a) plain dp2 with the fp32
   bucketed all-reduce, the yardstick; (b) ``strategy.sharding`` (ZeRO-1,
   fp32 scatter); (c) and (d) the same with ``quant_allreduce`` int8 and
   int4 at block 256 (the scatter's receive stage on #11); (e) ZeRO-3:
   ``apply_fsdp_sharding(main, MeshLayout(fsdp=2))`` +
   ``CompiledProgram.with_mesh``; (b) saves a checkpoint after step 3,
   and (f), last in the same launch, loads it from disk into a freshly
   built program and scope.  Gates: finite, falling
   losses; the startup's parameters and the replicated persistables
   sha256-equal across the ranks; (b) and (e) within 1e-4 of (a)'s losses
   (relative) and parameters (of max|p|), (c) and (d) within a few times
   their measured gaps to (a)'s losses and parameters, and the first
   step's scattered word-embedding gradient within its measured gap to
   (b)'s (a peer's contribution lost would leave half the sum); phase
   8's launches a step, #10 once, #11 once an adamw op
   in (c) and (d) (on the int8 carrier) and never in the others,
   #12 never, no fallback; the bytes each rank's scope holds equal to
   what the layout predicts (the sharded persistables' global bytes
   halved); (f)'s restored blocks bit for bit (b)'s saved ones.  In the
   same launch, the auto-shard legs: (g) plain dp2 with phase 8's recipe,
   its global-norm clip 1.0 included; (h) fleet's
   ``DistributedStrategy(auto_shard=True)`` with the same recipe and a
   budget halfway between the free plan's peaks (the free plan, data 2,
   made first on the ranks), 4 steps each.  (h)'s gates: the winner is
   fsdp 2, the ranks' plan hashes are equal, no priced config carries an
   error, its planning made no route decision, no launch and no CUDA
   allocation, its clip's norm is summed over fsdp (one
   ``c_global_norm_allreduce``) and step 1's global norm exceeds 1.0 (the
   clip binds), it launches as (e) does, and it lands within (e)'s
   tolerances of (g).  Every leg prints the static per-rank estimate
   (``memory_analysis.analyze_memory``) of its persistent and peak bytes
   beside the measured ones (the bytes the scope holds, the allocation
   after the startup, ``max_memory_allocated``): the persistent estimate
   equals the bytes held of the persistables it prices, the peak's ratio
   is recorded (phases 8, 16 and 20 (a) print and gate the same).
   While the ranks run, the planner's static 12-layer plans
   of BERT-base at 2 and 4 devices and of MoE BERT-base with
   ``max_expert`` 2 (host work in this process, their seconds printed).  #10 on
   leg (b)'s 158 flat shards against its twin bit for bit, timed beside
   ``torch._fused_adamw_`` (BERT-base's 12 layers: 158 shards).  Printed
   per leg: the step (median of steps 3-6), gloo's wall time in one step,
   the persistent and peak bytes a rank, and the checkpoint's save and
   load seconds; per rank launch of phases 15-17 and 19 one line of its
   parts (spawn to the first step, steps, saves, loads, the in-process
   one-rank runs, the rest);
16. HSDP at BERT-base width and 2 layers on four ranks of the card over
   gloo (phase
   10's launcher, each rank its 8 of the 32 x 128 rows), phase 15's
   program and recipe with dropout 0, 6 prepared steps a leg.  (a) dp4
   with the fp32 bucketed all-reduce, the yardstick; (b) HSDP:
   ``apply_fsdp_sharding(main, MeshLayout(data=2, fsdp=2))`` +
   ``CompiledProgram.with_mesh`` (bucketed gradient sync: the
   fsdp-stamped gradients over dp, the rest over both axes); (c) (b)'s
   state after step 3 through ``save_checkpoint(sharded=True)`` (each
   rank its own blocks, nothing gathered) and then through
   ``AsyncCheckpointer``; (d) the same four ranks, after (b), restore
   (c) from disk onto ``MeshLayout(fsdp=4)`` (blocks re-cut from 2 parts
   to 4) in a freshly built program and scope, and (e) two fresh ranks
   onto ``MeshLayout(data=2)`` (every persistable whole), each then steps
   4-6.  Gates: (b) within 1e-4 of (a) in losses (relative) and
   parameters (of max|p|); every rank's persistent bytes the layout's
   prediction; (c) verifies, every block written once and the blocks
   covering each persistable whole, the AsyncCheckpointer copy's shard
   files the same bytes; (d)'s and (e)'s restored global state bit for
   bit (c)'s, each rank's bytes read equal to its planned bytes, steps
   4-6 within 1e-4 of (b)'s; phase 8's launches of #1-#10 a step on
   every rank of every leg, no fallback.  Printed per leg: the step,
   gloo's wall time and calls in one step, the persistent and peak bytes
   a rank; (c)'s save seconds, bytes written a rank, and the seconds
   ``AsyncCheckpointer.save()`` blocks against the whole write; (d)'s
   and (e)'s load seconds, bytes read and reshard wire bytes;
17. ``overlap_grad_sync`` at BERT-base width and 2 layers on two ranks of
   the card
   over gloo (phase 10's launcher, each rank its 16 of the 32 x 128
   rows), phase 8's program and recipe (dropout 0.1) through fleet, 6
   prepared steps a leg: (a) the classic tail-fused program, (b) overlap
   (ready-order buckets at bucket_mb 4, min_buckets 4, fired from backward
   hooks), (c) (b) with ``overlap_lowering`` off (the same buckets at the
   tail), (d) (b) in the int8 tier (#12 launched from the hooks on the
   communication worker's stream), (e) (d) with lowering off, (f)
   overlap at bucket_mb 32.  Gates: (b) = (c) = (a) and (d) = (e) bit for
   bit in losses and parameter sha256, both ranks alike; at least 4
   buckets in (b) and (d); in (b), (d), (f) every bucket hooked and the
   hooks fired in ``_ready_rank`` order, in (c), (e) every bucket at the
   tail; phase 8's launches of #1-#10 a step, #12 once a bucket a step in
   (d) and (e), no fallback; #11 and #12 held against their plain
   versions at two of (d)'s bucket shard shapes.  Printed per leg: the
   buckets, the step, the exposed collective ms (from the backward's end
   to the last reduced gradient, CUDA events), gloo's wall time and calls
   in one step and the device's busy share.  Then the preemption drill:
   phase 15's ZeRO-3 leg under a ``PreemptionHandler`` with an
   ``AsyncCheckpointer``; SIGTERM to the launcher after step 3 of 6: both
   ranks save one sharded checkpoint at the same step and exit 42 (the
   async copy of step 2 drained whole), and a relaunch resumes with steps
   4-6 and the parameters bit for bit the uninterrupted run's;
18. tensor and sequence parallelism at BERT-base width and 4 layers
   (``MP_LAYERS``; phases 18 and 19 are cut in depth only, every launch
   count derived from the built program)
   (``build_pretrain_network_parallel``, float32, Adam 1e-4, the ranks on
   the card over gloo, phase 10's launcher).  (k) the ring route's kernel
   entry — #1 returning lse, #2 and #3 taking delta - dlse — against its
   twins at B4 H6 S_loc 256 D64 (BERT-base's 12 heads over tp 2, S 512
   over sp 2), float32 and bfloat16, under a random dO and dlse, for a
   padding bias with one batch row all masked and the causal biases of a
   diagonal block and of a block wholly in the future (their all-masked
   rows the uniform mean of V), timed beside the library's lse-returning
   call (at 12 heads of 64, the depth does not enter); (a) tp 2 x sp 2
   on four ranks (``MeshLayout(tp=2,
   extra_axes={"sp": 2})``, every feed split ("dp", "sp"), batch 4 x 512,
   38 masked tokens in each sp half of every row, attention dropout 0),
   4 prepared steps, against the same program built with ``tp_degree=1,
   seq_axis=None`` on one rank from the same seed: losses within 1e-4;
   (b) tp 2 on two ranks, batch 32 x 128, attention dropout 0.1 on the
   plain flash route; (c), in (a)'s launch after it, fsdp 2 x tp 2
   (``apply_fsdp_sharding`` over ``MeshLayout(fsdp=2, tp=2)`` on the tp
   build: the tp blocks stay tp blocks, the rest is sharded over fsdp)
   at ``MP_LAYERS`` (at 12 the script ran past PR 21's clock), 32 x 128
   with 20 masked
   tokens a row (10 in each half), phase 8's recipe with its global-norm
   clip 1.0, dropout 0, against the same program built with
   ``tp_degree=1`` on one rank: losses within 1e-4, the clip's squares
   summed once over fsdp and once over tp and binding, the persistent
   bytes a rank the static estimate's (``learning_rate_0`` alone left
   out), each block bit for bit on the ranks that share its
   coordinates; then a sharded save (every block once) restored from
   disk onto tp 2 x sp 2 and onto data 4 in freshly built programs and
   scopes: the global state bit for bit, each rank's bytes read the
   planned ones, the next step's loss within 1e-4 of (c)'s.  Gates: no
   fallback; #1-#3 once an attention op a ring step (2 ring steps at sp 2
   on (a), one on (b) and (c)), the LayerNorm forward and backward once a
   ``layer_norm`` op, Adam 1, counted in the built program
   (``tpsp_launches``); every rank's startup the same parameters (sha256)
   and, after the steps, its replicated persistables sha256-equal to rank
   0's.  Printed per leg: the step, gloo's wall ms, calls and bytes in
   one step by kind (tp all-reduces, the LM head's tp gather, the ring's
   point-to-point shifts, the fsdp gathers and reduce-scatters, the
   gradient sync), the device's busy share and the peak allocated bytes;
   (c) also its persistent bytes beside the estimate, its save's and each
   restore's seconds and bytes;
19. pipeline parallelism at BERT-base width and 4 layers (``MP_LAYERS``,
   phase 8's program and recipe, float32, the ranks on the card over
   gloo):
   (a)-(c) on two ranks, ``apply_pipeline(main, 2, 4)`` (the stage cut
   planned at the 8 x 128 microbatch) and ``with_mesh`` over
   ``MeshLayout(pipe=2)``, 32 x 128 in 4 microbatches, 4 prepared steps a
   leg: (a) 1F1B, (b) zero-bubble and interleaved (chunks 2), dropout 0,
   each against the one-rank ``set_microbatches(main, 4)`` run of the same
   program on the same batch (run by rank 0 before its legs): losses
   within 1e-5 (relative), parameters within 1e-5 after the steps (each
   ``*_qkv_b``'s key third left out: an exactly-zero gradient Adam turns
   into ±LR noise); (c) 1F1B at dropout 0.1 with the ``pipe_replay_check``
   flag on: every B unit's recomputed boundary bit for bit the one its F
   unit sent; (d) dp 2 x pp 2 on four ranks through ``fleet``'s
   ``strategy.pipeline`` (``shard_weights``, phase 15's recipe: a norm
   clip would read gradient blocks), 64 x 128, against the one-rank run
   of 8 microbatches on the global batch: the bytes each rank holds equal
   to the layout's prediction (the pipe-sharded parameters and moments
   halved), a sharded save after step 4; (e) the same four ranks, after
   (d), restore it from disk into a freshly built program and scope bit
   for bit and take the step (d) took after its save, to the same
   loss.  Gates on every leg and rank: no fallback; #1-#10 launched
   exactly as the program's stage cut and the schedule's tables predict
   (``pipe_expected``); every step's census: idle slots the simulator's,
   no launch on an idle tick.  Printed per leg (rank 0): the step
   (median of steps 2-4), gloo's wall ms, calls and MB in one step split
   into the point-to-point hops, the pp all-reduce, the dp sync and the
   pipe-sharded gather / scatter, the schedule's ``bubble_frac``, the
   device busy share and the peak allocated bytes; per rank launch of
   phases 18 and 19 one line of its parts (spawn to the first step,
   steps, saves, loads, the in-process one-rank runs, the rest);
20. Mixture-of-Experts at BERT-base width (hidden 768, 12 heads,
   intermediate 3072, the full vocabulary, 12 layers, the routed FFN in
   every layer: ``moe_experts`` 8, top-2, capacity factor 2.0, aux weight
   0.01), phase 8's fused program with phase 15's recipe (no norm clip:
   under ``ep`` an expert gradient is its rank's block), 32 x 128 with 20
   masks.  (a) One rank in this process: 5 prepared steps at dropout 0.1
   (finite losses, no fallback, each kernel's launches a step counted in
   the built program's pass variant: #1-#3 once a layer, add+LN twice a
   layer and once for the embeddings, LN and bias+GELU once for the
   masked-LM transform, #10 once), the share of (token, choice) slots
   each layer dropped (from its Combine weights), the step, the peak and
   a profiled step's device busy share; then at dropout 0 and aux 0, 3
   steps with every kernel on against every flag off (phase 7's
   tolerances).  (b) The same program at 2 layers (``MOE_EP_LAYERS``:
   the script's clock) retrofitted by ``parallel.apply_expert_sharding``
   onto ``MeshLayout(expert=2)`` on two ranks of the card over gloo, one
   launch (each rank its 16 rows), 3 steps a tier: (i) the float32
   exchange, losses and parameters within 1e-5 of the one-rank run at
   its depth, dropout 0 and aux 0 (the kernel run of (a) when the depths
   agree); (ii)
   the int8 exchange within rtol 0.05 / atol 0.01 of (i), its receive
   dequantized by the composition (no kernel route taken); (iii) (i)'s
   state after step 3 through ``save_checkpoint(sharded=True)``, restored
   onto one rank in this process: every parameter bit for bit, the next
   loss within 1e-6 (relative) of the ranks'.  Every rank: no fallback, the
   launches its program predicts, the bytes it holds the layout's.
   Printed per tier: the step, the exchanges' and the dense all-reduce's
   gloo ms, calls and bytes in one step, persistent and peak bytes.  (c) The MoE decoder (8 experts, routed one token a group)
   through phase 11's ``DecodeEngine`` config: 8 of phase 11's requests,
   12 flash forward and 25 LN forward launches a forward, no fallback,
   the tokens against ``greedy_reference`` as phase 11 holds them, and an
   engine with every kernel flag off on the same weights serving the same
   tokens;
21. print the ``kernels`` JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.

Robustness and observability, inside the launches above (the report's
``observability`` line): phase 3 serves one more burst with tracing on
(each micro-batch's pad / run / split spans on one step id, and
``profiler.serving_stats()`` reporting ``stats()``); phase 6 holds #10
with the guard's skip flag set (kernel and twin write nothing) and unset
(kernel against twin), timed both ways; phase 8, on its program at
dropout 0, (i) 8 steps with tracing and a ``TelemetryRecorder`` off,
then 8 on (the JSONL valid, MFU in (0, 1] of the peak of the program's
GEMM dtype, goodput, HBM headroom), (ii) 8 steps under
``guard_nonfinite`` with a NaN gradient at guard step 2 (every
parameter and moment sha256-equal across it, the skip counter 1, later
losses the unguarded run's within 1e-6, #1-#10 at phase 8's counts; the
launches and device ms of the guard's probe and gate), (iii) the
watchdog drill (a 3 s stall against a 1 s deadline trips it once, with
stacks and a bundle; healthy steps do not); phase 11 runs its 16
requests again with tracing on (one ``decode::*`` span a prefill, chunk
and chain, the gauges, the same tokens); phase 13 corrupts run A's
params file once between its write and its readback (one
``checkpoint::retry``, run C restores bit for bit); phase 15 (f) runs the
restored program guarded with a NaN on rank 1 only (both ranks skip the
step, replicas sha256-equal); phase 16 (d) arms ``reshard_execute``
during a first restore (it raises on every rank) before the restore
whose gates follow.

Imports torch and the port only — nothing of JAX or the JAX package."""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time

SEED = 2024
SEQ_FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")
BURSTS, BURST_REQUESTS = 16, 24     # the served window: 384 requests

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,      # FP32 outside the tensor cores
              "tf32": 495e12,        # TF32 tensor cores
              "bfloat16": 989e12,    # BF16 tensor cores
              "float16": 989e12}     # FP16 tensor cores

# stated tolerances: kernel vs its plain version on the same inputs
TOL_F32 = 2e-5            # LN, add-LN, bias-GELU, flash o (abs)
TOL_LSE = 1e-4            # flash lse (abs)
BF16_REL = 2.0 ** -6      # bf16: max|Δ| <= two bf16 ulps of max|plain|
FP16_REL = 2.0 ** -9      # float16: two float16 ulps of max|plain|
TOL_LONE = 1e-5           # served result vs lone run of its padded request
TOL_PLAIN_PATH = 1e-4     # kernels on vs all kernel flags off, 12 layers
TOL_UNFUSED = 1e-4        # unfused program vs fused program, 12 layers
TOL_GRAD = 2e-4           # flash dq/dk/dv, of max(1, max|plain|)
TOL_LN_SUM = 2e-5         # LN dscale/dbias, of max(1, max|plain|)
TOL_ADAM = 1e-5           # Adam p, m, v (abs)
TOL_TRAIN_LOSS = 1e-4     # training loss, kernels on vs off (relative)
TOL_TRAIN_GRAD = 1e-4     # step-1 grads, kernels on vs off, of max|grad|

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS = 10, 32, 128, 20
LONG_BATCH, LONG_SEQ = 8, 512      # the longest BERT sequence
PLAIN_STEPS = 3
DROPOUT = 0.1


def train_launches(layers):
    """Launches per BERT training step of ``layers`` encoder layers: #1-#3
    once a layer; LayerNorm 2 a layer + the embeddings' + the masked-LM
    head's; one Adam launch for the run of every parameter's update."""
    return {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            "layer_norm_fwd": 2 * layers + 2,
            "layer_norm_bwd": 2 * layers + 2, "adam": 1}


def fused_launches(layers):
    """The fused program's (phase 8's) launches a step: add+LN for the 2
    residual adds a layer and the embedding sum, LN left for the masked-LM
    transform; bias+GELU for each FFN and the masked-LM transform (the
    pooled tanh runs unfused)."""
    return dict(train_launches(layers), layer_norm_fwd=1, layer_norm_bwd=1,
                add_layer_norm_fwd=2 * layers + 1,
                add_layer_norm_bwd=2 * layers + 1,
                bias_gelu_fwd=layers + 1, bias_gelu_bwd=layers + 1)


def adam_ops(program):
    """The ``adam`` / ``adamw`` ops of a built program (one a parameter)."""
    return sum(op.type in ("adam", "adamw")
               for op in program.global_block().ops)


def grad_sync_buckets(program):
    """The gradient-sync bucket ops of a built program."""
    return sum(op.type in GRAD_SYNC_BUCKETS
               for op in program.global_block().ops)


def cut_depth(cfg, layers=None):
    """``cfg`` at its full width with ``layers`` encoder layers (phases
    15-17 run BERT-base's width at CUT_LAYERS: their gates count launches
    and bytes, which the depth scales but does not change in kind)."""
    import copy
    cfg = copy.copy(cfg)
    cfg.num_hidden_layers = CUT_LAYERS if layers is None else layers
    return cfg


# launches per BERT-base training step (12 layers) and its adam ops, one a
# parameter, updated by one launch of the multi-tensor kernel
TRAIN_LAUNCHES = train_launches(12)
ADAM_OPS = 158
FUSED_LAUNCHES = fused_launches(12)
#: the depth of phases 15-17 (BERT-base width, hidden 768, 12 heads,
#: intermediate 3072, the full vocabulary)
CUT_LAYERS = 2
#: the depth of phases 18-19, at the same width
MP_LAYERS = 4
# phase 12: bench.py's headline configuration (BERT-base pretraining in
# bf16 at 96 x 128 with 20 masks), its timed window, the kernels-on vs
# flags-off bound in bf16, and the fp16 loss-scaling leg's policy and feed
AMP_BATCH, AMP_BENCH_STEPS = 96, 30
TOL_AMP_PLAIN = 1e-2      # bf16 losses, kernels on vs off (relative)
# bf16 step-1 grads, kernels on vs off, of max|grad| (the limit that
# tests/test_torch_amp.py holds the port's bf16 gradients to against JAX)
TOL_AMP_GRAD = 3e-2
# the float32 LayerNorms of the bf16 program: the encoder's rows (B*S)
# and the masked-LM head's (B*20)
AMP_LN_ROWS = (AMP_BATCH * TRAIN_SEQ, AMP_BATCH * TRAIN_MASKS)
AMP_FP16_STEPS, AMP_INF_STEPS = 9, (4, 5)
AMP_FP16_BERT_STEPS = 4   # fp16 BERT-base prepared steps (leg (c))
AMP_INCR_EVERY, AMP_DECR_EVERY = 3, 2
# the recipe (Devlin et al. 2019, A.2; google-research/bert
# optimization.py): peak LR 1e-4, decay to 0 over 1M steps, AdamW 0.01,
# global-norm clip 1.0; the warmup is cut from 10,000 steps to 3
PEAK_LR, WARMUP_STEPS, DECAY_STEPS = 1e-4, 3, 1_000_000
WEIGHT_DECAY, CLIP_NORM = 0.01, 1.0
TOL_LR = 1e-6             # LR read back vs the closed form (relative)
# phase 12 leg (d): pure bf16 (parameters cast to bf16, moments float32)
AMP_PURE_BF16_STEPS = 4
# its launches a step, by operand dtype: the flash kernels and the one Adam
# launch for the 158 updates on bf16; the embedding LayerNorm on bf16 (its
# input, the sum of three bf16 tables, has no cast before it), the others
# on float32
PURE_BF16_LAUNCHES = (
    ("flash_attention_fwd", "bfloat16", 12),
    ("flash_attention_bwd_dq", "bfloat16", 12),
    ("flash_attention_bwd_dkv", "bfloat16", 12),
    ("layer_norm_fwd", "float32", 25), ("layer_norm_fwd", "bfloat16", 1),
    ("layer_norm_bwd", "float32", 25), ("layer_norm_bwd", "bfloat16", 1),
    ("adam", "bfloat16", 1))
# phase 13: the recipe with LAMB (You et al. 2019; epsilon 1e-6 and weight
# decay 0.01 with LayerNorm parameters and biases excluded, as the BERT
# LAMB recipe has them), checkpointed after LAMB_SAVE_AT of TRAIN_STEPS
# steps and resumed; LAMB's ops replace the Adam kernel's launch
LAMB_EPSILON, LAMB_SAVE_AT = 1e-6, 5
# where two uninterrupted runs differ (an op summing in a varying order),
# the resumed run's distance from A over steps 6-10 may reach this multiple
# of A-B's over steps 1-10 (their ratio was 0.59 on an H100): the
# drift of a few ulps' disorder is itself random.  A resume that lost
# state (moments, powers, the LR counter, the generator) lies orders of
# magnitude further, and the restore itself is held bit for bit
LAMB_RESUME_MARGIN = 4.0
# phase 14: recompute (one checkpoint a layer: each encoder layer's
# forward runs again in the backward, so its kernels launch twice a step:
# #1 12 -> 24, add+LN 25 -> 50 (the embeddings' and the 24 residual), bias
# +GELU 13 -> 25 (the masked-LM head's runs once, after the last
# checkpoint); the backward kernels and #10 as phase 8), gradient merge,
# the averaging wrappers, DGC and LocalSGD on phase 8's program and recipe
RECOMPUTE_LAUNCHES = dict(FUSED_LAUNCHES, flash_attention_fwd=24,
                          add_layer_norm_fwd=50, bias_gelu_fwd=25)
RC_STEPS = TRAIN_STEPS
TOL_RC_GRAD = 1e-6        # step-1 grads, recompute vs not, of max|grad|
TOL_RC_LOSS = 1e-4        # step-10 loss, recompute vs not (relative)
GM_K, GM_MICRO, GM_STEPS = 4, 8, 8     # 4 micro-batches of 8 x 128: 2 applies
TOL_GM_GRAD = 1e-4        # merged gradient vs one 32-row step, of max|grad|
WRAP_STEPS = 3            # EMA, ModelAverage, Lookahead, DGC
EMA_DECAY = 0.999
MA_RATE, MA_MIN, MA_MAX = 0.15, 2, 4
LA_ALPHA, LA_K = 0.5, 2
DGC_LR, DGC_MOMENTUM = 1e-3, 0.9
LOCALSGD_K, LOCALSGD_STEPS = 2, 4
EDGE_ROWS = 1003          # ragged last block of the backwards' row blocks
# the LN backwards beyond BERT-base's shapes: widths of 1, 2, 8 and 16
# warps a row (128 and 8192 are the gate's edges) at a few hundred rows
LN_EDGE_ROWS = 300
LN_EDGE_WIDTHS = (128, 896, 4096, 8192)
# the LN forwards' rows of D = 768: served B8 x S128 (the main path), the
# training batch (B8 x S512 served, 32 x 128 trained), one row, the
# served B1 and B4 x S128, the trained masked-LM head's B32 x 20 and the
# bf16 program's rows
LN_FWD_ROWS = (8 * 128, 8 * 512, 1, 128, 512,
               TRAIN_BATCH * TRAIN_MASKS) + AMP_LN_ROWS
# the quantized all-reduce's receive stage (KERNEL_CENSUS_r15.json parity)
TOL_DQ_ACC = 1e-5         # #11 vs its plain version (abs)
TOL_DQ_ACC_BLOCK = 1e-6   # #11, each block of max|plain| of that block
TOL_DQ_SCALE = 2e-6       # #12's scales vs its plain version (abs)
# a BERT-base step's 13 quantized gradient buckets as one rank's shard at
# n = 2, block 256 (compiler.insert_grad_sync at the 32 MB cap), in bucket
# order: the word embedding, then the other parameters (ten of the
# buckets one encoder layer each)
STEP_BUCKET_SB = (45783, 14618) + (13844,) * 10 + (16217,)
# data parallelism on one card: two ranks, 13 gradient buckets of BERT-base
# at the default 32 MB cap, one #12 (int8) or #11 (int4) launch each
DP_RANKS, DP_BUCKETS, DP_INT4_STEPS = 2, 13, 3
DP_TIMEOUT_S = 420
TOL_DP_INT8 = 5e-2        # int8 tier vs full precision (test_grad_comm.py)
# Adam's first moments after the dropout-free legs, two ranks int8 vs one
# GPU, as a relative norm over every parameter: four int8 quanta (a
# quantum is 1/127 of its block's max).  The moments are linear in the
# reduced gradients, which the LR schedule and AdamW hide from the losses
TOL_DP_MOMENTS = 4 / 127

GRAD_SYNC_BUCKETS = ("c_fused_allreduce_sum", "c_fused_quant_allreduce_sum")


class SmokeFailure(Exception):
    pass


#: the parts of this rank launch's run, seconds (``--*-worker`` ranks):
#: "to_first_step" from the launcher's start (SMOKE_LAUNCH_T0) to the
#: first step, then "steps", "saves", "loads", written with the results
_STAMPS = {}


def stamp(part, seconds):
    _STAMPS[part] = _STAMPS.get(part, 0.0) + seconds


def first_step():
    """Mark the first step of this rank launch (once)."""
    t0 = os.environ.get("SMOKE_LAUNCH_T0")
    if t0 and "to_first_step" not in _STAMPS:
        _STAMPS["to_first_step"] = time.time() - float(t0)


#: {phase: its seconds by the script's clock}, each closed when the next
#: one begins
_PHASE_S = {}
_PHASE_OPEN = []


def begin_phase(n, what):
    """Log phase ``n`` and close the one before it: its seconds go into
    :data:`_PHASE_S` and on a line of their own."""
    now = time.perf_counter()
    if _PHASE_OPEN:
        prev, t0 = _PHASE_OPEN.pop()
        _PHASE_S[prev] = round(now - t0, 1)
        log(f"  phase {prev} ran {now - t0:.1f} s")
    _PHASE_OPEN.append((n, now))
    log(f"phase {n}: {what}")


def launch_env():
    """The environment of a rank launch: its start time for the ranks'
    stamps."""
    return dict(os.environ, SMOKE_LAUNCH_T0=repr(time.time()))


def launch_line(what, ranks, wall_s):
    """One line a launch: its wall seconds and rank 0's parts."""
    st = ranks[0].get("stamps") or {}
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in st.items())
    log(f"  {what}: {wall_s:.1f} s wall; rank 0: {parts or 'no stamps'}, "
        f"other {wall_s - sum(st.values()):.1f} s")


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, samples=25, warmup=3, flush=None,
            head_start=2_000_000):
    """Median device time of one call: each sample starts behind a GPU
    sleep of ``head_start`` cycles, so the host finishes enqueueing before
    the start event fires and the events see device time only (a call
    whose host work takes longer needs a longer head start).  With
    ``flush`` (a tensor larger than the L2 cache) the cache is overwritten
    before each sample, outside the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(head_start)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_split_ms(torch, fn, calls=10):
    """Device ms per call of each kernel ``fn`` launches, by kernel name
    (template arguments and parameters cut), from one profiled run of
    ``calls`` calls (a second when the first saw no device activity);
    empty when neither saw any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"(\w+)(<[^(]*>)?\(", e.name)
                name = m.group(1) if m else e.name[:60]
                by_name[name] = by_name.get(name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3 / calls
        if by_name:
            break
    return by_name


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fwd_bounds(nbytes, flops, dtype):
    """The flash forward's ``bound`` (and, in float32, its two operation
    bounds as extra keys), by the rule of the backward's rows: the function
    of the TPU kernel (two S^2 D products, each input read and each output
    written once), float32 at the smaller of the FMA-pipe and the 3xTF32
    tensor-core bound."""
    if dtype != "float32":
        return {}
    bound = bound_ms(nbytes, 3 * flops, "tf32")
    return {"bound": bound,
            "bound_fma_ms": bound_ms(nbytes, flops, "float32")[0],
            "bound_3xtf32_ms": bound[0]}


#: the 16-bit dtypes' tolerances against the plain versions
REL16 = {"bfloat16": BF16_REL, "float16": FP16_REL}


def max_err(torch, got, ref):
    return float((got.float() - ref.float()).abs().max())


def agree(torch, what, got, ref, dtype, tol, relative=False):
    """Kernel vs plain: bf16 (float16) within two bf16 (float16) ulps of
    max|plain|; float32 within ``tol``, of max(1, max|plain|) when
    ``relative``."""
    err = max_err(torch, got, ref)
    if dtype in REL16:
        limit = REL16[dtype] * float(ref.float().abs().max())
    elif relative:
        limit = tol * max(1.0, float(ref.float().abs().max()))
    else:
        limit = tol
    log(f"  {what}: max|Δ| {err:.3e} (tolerance {limit:.3e})")
    check(err <= limit, f"{what}: kernel disagrees with its plain version "
                        f"({err:.3e} > {limit:.3e})")
    return err


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def recorder(results):
    """record(name, shape, dtype, err, ms, plain_ms, lib_ms, nbytes, flops,
    bound=None, **extra) appends one timed row to ``results[name]``; its
    bound is ``bound_ms(nbytes, flops, dtype)`` unless ``bound`` gives
    (ms, by)."""
    def record(name, shape, dtype, err, ms, plain_ms, lib_ms, nbytes,
               flops, bound=None, **extra):
        b_ms, b_by = bound or bound_ms(nbytes, flops, dtype)
        row = {"shape": shape, "dtype": dtype, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, **extra}
        results.setdefault(name, []).append(row)
        log(f"  {name} {shape} {dtype}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by})"
            + "".join(f", {k} {v}" for k, v in extra.items()))
    return record


def randn_on(torch, gen, dev):
    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) *
                scale).to(dtype)
    return randn


def padding_bias(torch, gen, dev, bsz, seq):
    """BERT's head-shared bias (B, S, S): 0 where query and key are both
    inside the sequence, -1e4 elsewhere (padded query rows included)."""
    lens = torch.randint(seq // 4, seq + 1, (bsz,), generator=gen,
                         device=dev)
    mask = (torch.arange(seq, device=dev)[None, :] <
            lens[:, None]).float()                     # [B, S]
    return (mask[:, :, None] * mask[:, None, :]) * 1e4 - 1e4


def ln_fwd_checks(torch, results, randn, dtname, cases):
    """Both LayerNorm forwards, #4 LN(x) and #6 LN(a + b), against their
    plain twins in ``dtname`` on (rows, width, offset, case) ``cases``
    (``offset`` elements into each operand: views off the vector alignment
    take the scalar instantiation); every output bit-identical across two
    launches on the same inputs.  Each case is timed beside
    ``F.layer_norm``; #6 beside the two calls a user would make (a + b,
    then ``F.layer_norm``) and, as the lower yardstick, ``F.layer_norm``
    alone on the sum made beforehand."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import fused_ops as K

    dt = getattr(torch, dtname)
    es = torch.finfo(dt).bits // 8
    record = recorder(results)
    for rows, width, off, case in cases:
        def operand(n, scale=1.0, shift=0.0):
            return (shift + randn(n + off, scale=scale)).to(dt)[off:]
        a, b = (operand(rows * width).view(rows, width) for _ in range(2))
        s = operand(width, 0.1, 1.0)
        bb = operand(width, 0.1)
        u = a + b
        for name, kern, plain, lib in (
                ("layer_norm_fwd", lambda: K.layer_norm(a, s, bb),
                 lambda: K.layer_norm_plain(a, s, bb),
                 lambda: F.layer_norm(a, (width,), s, bb, 1e-5)),
                ("add_layer_norm_fwd",
                 lambda: K.add_layer_norm(a, b, s, bb),
                 lambda: K.add_layer_norm_plain(a, b, s, bb),
                 lambda: F.layer_norm(a + b, (width,), s, bb, 1e-5))):
            residual = name == "add_layer_norm_fwd"
            what = f"{name} [{rows},{width}] {dtname}" + \
                (f" ({case})" if case else "")
            got, again = kern(), kern()
            check(torch.equal(got, again),
                  f"{what}: output differs between two launches on the "
                  f"same inputs")
            err = agree(torch, what, got, plain(), dtname, TOL_F32)
            extra = {"case": case} if case else {}
            if residual:
                extra["library_is"] = "a + b, then F.layer_norm"
                extra["library_layer_norm_alone_ms"] = time_ms(
                    torch, lambda: F.layer_norm(u, (width,), s, bb, 1e-5))
            record(name, [rows, width], dtname, err, time_ms(torch, kern),
                   time_ms(torch, plain), time_ms(torch, lib),
                   ((2 + residual) * rows * width + 2 * width) * es,
                   (8 + residual) * rows * width, bit_identical=True,
                   **extra)


def kernel_checks(torch, results):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import fused_ops as K
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    randn = randn_on(torch, gen, dev)
    record = recorder(results)

    for dtname, dt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16),
                       ("float16", torch.float16)):
        es = torch.finfo(dt).bits // 8
        # LayerNorm and residual add + LayerNorm at the served rows (not
        # in float16: only the flash kernels take it)
        if dtname != "float16":
            ln_fwd_checks(torch, results, randn, dtname,
                          [(rows, 768, 0, None) for rows in LN_FWD_ROWS[:2]])
        # bias + GELU, D = 3072
        for rows in (8 * 128, 8 * 512) if dtname != "float16" else ():
            d = 3072
            xx, bb = randn(rows, d, dtype=dt), randn(d, scale=0.1, dtype=dt)
            err = agree(torch, f"bias_gelu [{rows},{d}] {dtname}",
                        K.bias_gelu(xx, bb), K.bias_gelu_plain(xx, bb),
                        dtname, TOL_F32)
            # ~20 operations per element: the add, erff's polynomial, 4 muls
            record("bias_gelu_fwd", [rows, d], dtname, err,
                   time_ms(torch, lambda: K.bias_gelu(xx, bb)),
                   time_ms(torch, lambda: K.bias_gelu_plain(xx, bb)),
                   time_ms(torch, lambda: F.gelu(xx + bb)),
                   (2 * rows * d + d) * es, 20 * rows * d)
        # flash attention, B = 8, H = 12, D = 64
        bsz, heads, d = 8, 12, 64
        for seq in (128, 512):
            bh = bsz * heads
            q, k, v = (randn(bh, seq, d, dtype=dt) for _ in range(3))
            shared = padding_bias(torch, gen, dev, bsz, seq)
            perhead = randn(bh, seq, seq)
            # BERT's bias masks the padded query rows too (every logit of
            # such a row carries -1e4); all rows are held to the tolerance
            for mode, bias, causal in (("padding-bias", shared, False),
                                       ("per-head-bias", perhead, False),
                                       ("no-bias", None, False),
                                       ("causal", None, True)):
                o, lse = FA.flash_fwd(q, k, v, bias, causal=causal)
                o2, lse2 = FA.flash_fwd(q, k, v, bias, causal=causal)
                po, plse = FA.flash_fwd_plain(q, k, v, bias, causal=causal)
                what = f"flash {mode} S={seq} {dtname}"
                check(torch.equal(o, o2) and torch.equal(lse, lse2),
                      f"{what}: o/lse differ between two launches")
                err = agree(torch, what + " o", o, po, dtname, TOL_F32)
                lerr = max_err(torch, lse, plse)
                if dtname != "float32":
                    # 16-bit scores come from the tensor cores, summed in
                    # another order than the twin's float32 matmul: at a
                    # padded row (every logit near -1e4, a float32 ulp
                    # ~1e-3) lse moves by an ulp.  Held per row to TOL_LSE
                    # plus two float32 ulps of |lse|
                    a = plse.abs()
                    over = float(((lse - plse).abs() - TOL_LSE - 2 * (
                        torch.nextafter(a, a + 1) - a)).max())
                    log(f"  {what} lse: max|Δ| {lerr:.3e} (tolerance "
                        f"{TOL_LSE:.1e} + 2 float32 ulps of |lse| per row; "
                        f"max|Δ| - tolerance {over:.3e})")
                    check(over <= 0, f"{what}: lse disagrees ({lerr})")
                else:
                    # a padded row's lse is near -1e4, where one float32
                    # ulp (9.766e-4) exceeds TOL_LSE: held per row to
                    # TOL_LSE plus one float32 ulp of |lse|
                    a = plse.abs()
                    over = float(((lse - plse).abs() - TOL_LSE - (
                        torch.nextafter(a, a + 1) - a)).max())
                    log(f"  {what} lse: max|Δ| {lerr:.3e} (tolerance "
                        f"{TOL_LSE:.1e} + 1 float32 ulp of |lse| per row; "
                        f"max|Δ| - tolerance {over:.3e})")
                    check(over <= 0, f"{what}: lse disagrees ({lerr})")
                if mode not in ("padding-bias", "causal"):
                    continue          # time the served and causal cases
                q4, k4, v4 = (t.view(bsz, heads, seq, d) for t in (q, k, v))
                if causal:
                    def lib():
                        return F.scaled_dot_product_attention(
                            q4, k4, v4, is_causal=True)
                    pairs = seq * (seq + 1) // 2
                else:
                    m4 = bias.view(bsz, 1, seq, seq).to(dt)

                    def lib():
                        return F.scaled_dot_product_attention(
                            q4, k4, v4, attn_mask=m4)
                    pairs = seq * seq
                nbytes = 4 * bh * seq * d * es + bh * seq * 4 + \
                    (0 if bias is None else bias.numel() * 4)
                flops = 4 * bh * pairs * d
                record("flash_attention_fwd",
                       [bsz, heads, seq, d, mode], dtname,
                       max(err, lerr),
                       time_ms(torch, lambda: FA.flash_fwd(
                           q, k, v, bias, causal=causal)),
                       time_ms(torch, lambda: FA.flash_fwd_plain(
                           q, k, v, bias, causal=causal)),
                       time_ms(torch, lib), nbytes, flops,
                       **fwd_bounds(nbytes, flops, dtname))
    # the LayerNorm forwards beyond the served rows, on their own generator
    randn = randn_on(torch, torch.Generator(device=dev).manual_seed(SEED + 7),
                     dev)
    for dtname in ("float32", "bfloat16"):
        es = torch.finfo(getattr(torch, dtname)).bits // 8
        ln_fwd_checks(
            torch, results, randn, dtname,
            [(rows, 768, 0, None) for rows in LN_FWD_ROWS[2:]] +
            [(LN_EDGE_ROWS, w, 0, f"D={w}") for w in LN_EDGE_WIDTHS] +
            [(LN_EDGE_ROWS, 768, 4 // es, "4-byte offset view")])


# ---------------------------------------------------------------------------
# phases 3 and 4: BERT-base served through the port
# ---------------------------------------------------------------------------


def make_requests(np, cfg, n):
    rng = np.random.RandomState(SEED)
    reqs = []
    for i in range(n):
        rows = 1 + (i % 2)
        seq = int(rng.randint(20, 501))
        ids = rng.randint(0, cfg.vocab_size, (rows, seq)).astype("int64")
        reqs.append({
            "src_ids": ids,
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (rows, 1)),
            "sent_ids": (np.arange(seq) >= seq // 2).astype(
                "int64")[None].repeat(rows, 0),
            "input_mask": np.ones((rows, seq, 1), dtype="float32"),
        })
    return reqs


def build_and_save(torch, model_dir):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig.base()
    unique_name.reset()
    main, startup = Program(), Program()
    startup.random_seed = SEED
    with program_guard(main, startup):
        feeds, seq_out, pooled = bert.build_inference_network(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor()                       # CUDAPlace(0)
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(model_dir, [v.name for v in feeds],
                                  [seq_out, pooled], exe, main, scope=scope)
    torch.cuda.synchronize()
    log(f"  BERT-base built on {exe.device} and saved in "
        f"{time.perf_counter() - t0:.1f} s ({cfg.num_hidden_layers} layers, "
        f"hidden {cfg.hidden_size}, heads {cfg.num_attention_heads}, FFN "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size})")
    return cfg


def max_abs(np, a, b):
    return float(np.abs(np.asarray(a, np.float64) -
                        np.asarray(b, np.float64)).max())


def serve_phase(torch, np, model_dir, cfg):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.serving import (ServingConfig, ServingEngine,
                                          pad_request)

    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    check(pred.device.type == "cuda", f"predictor on {pred.device}")
    ops = [op.type for op in pred.program.global_block().ops]
    log(f"  served program: {len(ops)} ops, "
        f"{ops.count('fused_attention')} fused_attention, "
        f"{ops.count('fused_add_layernorm')} fused_add_layernorm, "
        f"{ops.count('fused_elemwise_activation')} "
        f"fused_elemwise_activation")
    seq_name = pred.get_output_names()[0]
    scfg = ServingConfig(max_batch_size=8, max_wait_ms=5.0,
                         batch_buckets=(1, 2, 4, 8),
                         seq_buckets=(128, 256, 512), seq_feeds=SEQ_FEEDS,
                         seq_fetches=(seq_name,))
    engine = ServingEngine(pred, scfg)
    reqs = make_requests(np, cfg, BURSTS * BURST_REQUESTS)
    futs, results, walls = [], [], []
    try:
        t0 = time.perf_counter()
        n_warm = engine.warmup(reqs[0])
        torch.cuda.synchronize()
        log(f"  warmup: {n_warm} bucket combos in "
            f"{time.perf_counter() - t0:.1f} s")
        # the main path: counts from zero, served, read right after.  Each
        # burst is submitted at once and drained before the next.
        kernels.reset_launch_counts()
        registry.reset_route_counts()
        for i in range(BURSTS):
            burst = reqs[i * BURST_REQUESTS:(i + 1) * BURST_REQUESTS]
            t0 = time.perf_counter()
            bfuts = [engine.submit(r) for r in burst]
            results += [f.result(timeout=600) for f in bfuts]
            walls.append(time.perf_counter() - t0)
            futs += bfuts
        launches = kernels.launch_counts()
        routes = registry.route_counts()
        stats = engine.stats()
        traced_burst(engine, reqs[:BURST_REQUESTS])
    finally:
        engine.shutdown()
    wall = sum(walls)
    per_burst = sorted(BURST_REQUESTS / w for w in walls)
    log(f"  served {len(reqs)} requests in {BURSTS} bursts of "
        f"{BURST_REQUESTS} ({sum(r['src_ids'].shape[0] for r in reqs)} "
        f"rows, lengths {min(r['src_ids'].shape[1] for r in reqs)}-"
        f"{max(r['src_ids'].shape[1] for r in reqs)}) in {wall:.3f} s: "
        f"{len(reqs) / wall:.2f} requests/s (per burst: min "
        f"{per_burst[0]:.2f}, median {statistics.median(per_burst):.2f}, "
        f"max {per_burst[-1]:.2f}), p50 {stats['p50_ms']:.2f} ms, "
        f"p99 {stats['p99_ms']:.2f} ms, batches {stats['batches']}, "
        f"padding waste {stats['padding_waste']:.3f}")
    log(f"  launches on the served path: {launches}")
    fallbacks = {k: v for k, v in routes.items() if k[2] == "fallback"}
    log(f"  route hits: { {k[0]: v for k, v in routes.items() if k[2] == 'hit'} }")
    check(not fallbacks, f"route fallbacks on the served path: {fallbacks}")
    for name in ("flash_attention_fwd", "add_layer_norm_fwd",
                 "bias_gelu_fwd"):
        check(launches[name] > 0, f"{name} never launched on the served "
                                  f"path")

    # every result vs a lone run of its padded request, then vs the plain
    # path (all kernel flags off) on the same padded request
    lone_err = plain_err = 0.0
    canon, kernel_outs = [], []
    for r, f, res in zip(reqs, futs, results):
        bb, sb = f.bucket
        padded = pad_request(r, sb, SEQ_FEEDS, batch_bucket=bb)
        canon.append((padded, r["src_ids"].shape))
        lone = pred.run_feed(padded)
        kernel_outs.append(lone)
        rows, seq = r["src_ids"].shape
        lone_err = max(lone_err, max_abs(np, res[0], lone[0][:rows, :seq]),
                       max_abs(np, res[1], lone[1][:rows]))
    log(f"  served vs lone padded run: max|Δ| {lone_err:.3e} (tolerance "
        f"{TOL_LONE:.0e})")
    check(lone_err <= TOL_LONE, "served result differs from its lone run")
    flags.set_flags({"use_flash_attention": False,
                     "use_pallas_fused": False})
    try:
        kernels.reset_launch_counts()
        plain_outs = [pred.run_feed(p) for p, _ in canon]
        check(sum(kernels.launch_counts().values()) == 0,
              "the plain path launched a kernel")
    finally:
        flags.set_flags({"use_flash_attention": True,
                         "use_pallas_fused": True})
    for (p, (rows, seq)), ko, po in zip(canon, kernel_outs, plain_outs):
        plain_err = max(plain_err, max_abs(np, ko[0][:rows, :seq],
                                           po[0][:rows, :seq]),
                        max_abs(np, ko[1][:rows], po[1][:rows]))
        check(np.isfinite(ko[0]).all() and np.isfinite(ko[1]).all(),
              "non-finite served output")
    log(f"  kernels vs plain path (flags off): max|Δ| {plain_err:.3e} "
        f"(tolerance {TOL_PLAIN_PATH:.0e})")
    check(plain_err <= TOL_PLAIN_PATH, "kernel path disagrees with the "
                                       "plain path")
    serving = {"requests": len(reqs), "bursts": BURSTS, "wall_s": wall,
               "requests_per_s": len(reqs) / wall,
               "burst_requests_per_s": per_burst,
               "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
               "batches": stats["batches"],
               "padding_waste": stats["padding_waste"],
               "lone_max_abs": lone_err, "plain_path_max_abs": plain_err}
    return launches, serving, canon, kernel_outs


def unfused_phase(torch, np, model_dir, canon, fused_outs):
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    cfg = AnalysisConfig(model_dir)
    cfg.switch_ir_optim(False)
    pred = create_paddle_predictor(cfg)
    pred.prepare()
    ops = [op.type for op in pred.program.global_block().ops]
    log(f"  unfused program: {len(ops)} ops, {ops.count('layer_norm')} "
        f"layer_norm")
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    outs = [pred.run_feed(p) for p, _ in canon]
    launches = kernels.launch_counts()
    fallbacks = registry.route_counts("fallback")
    log(f"  launches on the unfused path: {launches}")
    check(launches["layer_norm_fwd"] > 0, "layer_norm_fwd never launched")
    check(not fallbacks, f"route fallbacks on the unfused path: "
                         f"{fallbacks}")
    err = 0.0
    for (p, (rows, seq)), uo, fo in zip(canon, outs, fused_outs):
        err = max(err, max_abs(np, uo[0][:rows, :seq], fo[0][:rows, :seq]),
                  max_abs(np, uo[1][:rows], fo[1][:rows]))
    log(f"  unfused vs fused: max|Δ| {err:.3e} (tolerance "
        f"{TOL_UNFUSED:.0e})")
    check(err <= TOL_UNFUSED, "unfused program disagrees with the fused")
    return launches, err


def mhm_phase(torch, np):
    """The attention pattern a user writes by hand, fused into one
    ``multihead_matmul`` op: the flash kernel runs it with the pattern's
    scale folded into q and the test-mode dropout's (1 - p) applied after
    (BERT-base heads: B = 8, H = 12, S = 128, D = 64, padding mask)."""
    from paddle_tpu_torch import flags, fluid
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    b, h, s, d = 8, 12, 128, 64
    main, startup = Program(), Program()
    with program_guard(main, startup):
        q, k, v = (fluid.layers.data(n, shape=[h, s, d])
                   for n in ("q", "k", "v"))
        mask = fluid.layers.data("mask", shape=[1, 1, s])
        scores = fluid.layers.matmul(q, k, transpose_y=True)
        scores = fluid.layers.scale(scores, scale=0.1)
        scores = fluid.layers.elementwise_add(scores, mask)
        probs = fluid.layers.dropout(fluid.layers.softmax(scores), 0.1,
                                     is_test=True)
        out = fluid.layers.matmul(probs, v)
    rng = np.random.RandomState(SEED)
    feed = {n: rng.randn(b, h, s, d).astype("float32")
            for n in ("q", "k", "v")}
    lens = rng.randint(s // 4, s + 1, b)
    feed["mask"] = np.where(np.arange(s)[None, :] < lens[:, None], 0.0,
                            -1e4).astype("float32").reshape(b, 1, 1, s)
    exe = fluid.Executor()                       # CUDAPlace(0)
    unfused, = exe.run(main, feed=feed, fetch_list=[out])
    apply_pass(main, "multihead_matmul_fuse", fetch_names=[out.name])
    ops = [op.type for op in main.global_block().ops]
    check(ops == ["multihead_matmul"], f"fused pattern: {ops}")
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    fused, = exe.run(main, feed=feed, fetch_list=[out])
    launches = kernels.launch_counts()["flash_attention_fwd"]
    fallbacks = registry.route_counts("fallback")
    flags.set_flags({"use_flash_attention": False})
    try:
        plain, = exe.run(main, feed=feed, fetch_list=[out])
    finally:
        flags.set_flags({"use_flash_attention": True})
    err_plain, err_unfused = max_abs(np, fused, plain), \
        max_abs(np, fused, unfused)
    log(f"  multihead_matmul [{b},{h},{s},{d}]: flash launches {launches}, "
        f"vs plain path max|Δ| {err_plain:.3e}, vs unfused program "
        f"{err_unfused:.3e} (tolerance {TOL_F32:.0e})")
    check(launches == 1, f"flash launched {launches} times")
    check(not fallbacks, f"route fallbacks: {fallbacks}")
    check(np.isfinite(fused).all(), "non-finite multihead_matmul output")
    check(max(err_plain, err_unfused) <= TOL_F32,
          "multihead_matmul disagrees with its plain path")
    return max(err_plain, err_unfused)


# ---------------------------------------------------------------------------
# phase 6: the training kernels against their plain versions
# ---------------------------------------------------------------------------


def bert_base_param_shapes(cfg):
    """The 158 parameter shapes of BERT-base pretraining (a program built
    for its declarations only; nothing runs)."""
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = Program(), Program()
    with program_guard(main, startup):
        bert.build_pretrain_network(cfg)
    return [tuple(p.shape) for p in main.all_parameters()]


def flash_training_checks(torch, results):
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    seed = torch.tensor([SEED], dtype=torch.int32, device=dev)
    for dtname in ("float32", "bfloat16", "float16"):
        for bsz, seq in ((TRAIN_BATCH, TRAIN_SEQ), (LONG_BATCH, LONG_SEQ)):
            flash_training_rows(torch, results, gen, seed, dtname, bsz, seq,
                                ("padding-bias", "causal"))
    flash_route_checks(torch, FA, gen, seed)


def flash_training_rows(torch, results, gen, seed, dtname, bsz, seq, modes):
    """The flash forward (dropout 0.1 and 0) and its dq and dk/dv kernels
    at (bsz, 12 heads, seq, 64) in ``dtname``, on one draw of q, k, v, dO
    and BERT's padding bias, in each of ``modes`` ("padding-bias",
    "causal"): against the twin, bit for bit across two launches, each
    timed beside SDPA / the library's backward at the same dropout rate
    and its bound; rows recorded in ``results``."""
    dev = torch.device("cuda", 0)
    randn = randn_on(torch, gen, dev)
    dt = getattr(torch, dtname)
    q, k, v, do = (randn(bsz * 12, seq, 64, dtype=dt) for _ in range(4))
    shared = padding_bias(torch, gen, dev, bsz, seq)
    for mode in modes:
        bias, causal = (shared, False) if mode == "padding-bias" else \
            (None, True)
        flash_training_mode(torch, results, seed, dtname, bsz, seq, mode,
                            (q, k, v, do), bias, causal)


def flash_training_mode(torch, results, seed, dtname, bsz, seq, mode,
                        qkvdo, bias, causal):
    """One mode of :func:`flash_training_rows` on its draw ``qkvdo``."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    record = recorder(results)
    q, k, v, do = qkvdo
    heads, d = 12, 64
    dt = q.dtype
    es = torch.finfo(dt).bits // 8
    bh = bsz * heads
    what = f"flash train {mode} B={bsz} S={seq} {dtname}"
    q4, k4, v4, do4 = (t.view(bsz, heads, seq, d).detach()
                       .requires_grad_(True) for t in (q, k, v, do))
    mask4 = None if bias is None else bias.view(bsz, 1, seq, seq).to(dt)
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    io_bytes = bh * seq * d * es
    extra = (0 if bias is None else bias.numel() * 4) + \
        2 * bh * seq * 4                  # lse, delta

    def forward_row(rate):
        """The forward at ``rate`` against the twin, bit for bit across two
        launches, timed beside SDPA at that rate; returns (o, lse)."""
        o, lse = FA.flash_fwd(q, k, v, bias, causal, rate, seed)
        o2, lse2 = FA.flash_fwd(q, k, v, bias, causal, rate, seed)
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"{what}: o/lse differ between two launches (dropout {rate})")
        po, plse = FA.flash_fwd_plain(q, k, v, bias, causal, rate, seed)
        err_o = agree(torch, f"{what} o (dropout {rate})", o, po, dtname,
                      TOL_F32)
        # a padded row's lse is near -1e4, where a float32 ulp is ~1e-3:
        # held per row to TOL_LSE of max(1, |lse|)
        lerr = float(((lse - plse).abs() / plse.abs().clamp_min(1.0)).max())
        log(f"  {what} lse (dropout {rate}): max|Δ|/max(1,|lse|) "
            f"{lerr:.3e} (tolerance {TOL_LSE:.1e})")
        check(lerr <= TOL_LSE, f"{what}: lse disagrees ({lerr})")
        nbytes = 4 * io_bytes + extra - bh * seq * 4
        flops = 4 * bh * pairs * d
        record("flash_attention_fwd_dropout",
               [bsz, heads, seq, d, mode, f"dropout {rate}"], dtname,
               max(err_o, lerr),
               time_ms(torch, lambda: FA.flash_fwd(
                   q, k, v, bias, causal, rate, seed)),
               time_ms(torch, lambda: FA.flash_fwd_plain(
                   q, k, v, bias, causal, rate, seed)),
               time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=mask4, is_causal=causal,
                   dropout_p=rate)),
               nbytes, flops, bit_identical=True,
               **fwd_bounds(nbytes, flops, dtname))
        return o, lse
    o, lse = forward_row(DROPOUT)
    forward_row(0.0)
    grads = FA.flash_bwd(q, k, v, bias, o, lse, do, causal, DROPOUT, seed)
    again = FA.flash_bwd(q, k, v, bias, o, lse, do, causal, DROPOUT, seed)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"{what}: dq/dk/dv differ between two launches on the same "
          f"inputs")
    refs = FA.flash_bwd_plain(q, k, v, bias, o, lse, do, causal, DROPOUT,
                              seed)
    errs = [agree(torch, f"{what} {n}", g, r, dtname, TOL_GRAD,
                  relative=True)
            for n, g, r in zip(("dq", "dk", "dv"), grads, refs)]
    # kernels and the library's backward, each at dropout 0.1 and at 0
    # (the library redraws its own mask: the same rate, not the same bits)
    timed = {}
    for rate in (DROPOUT, 0.0):
        o_r, lse_r = FA.flash_fwd(q, k, v, bias, causal, rate, seed)
        delta = (do.float() * o_r.float()).sum(dim=-1)
        args = (q, k, v, bias, do, lse_r, delta, causal, rate, seed)
        ds = FA.flash_bwd_dkv(*args)[2]
        lib_out = F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, is_causal=causal, dropout_p=rate)
        timed[rate] = (
            time_ms(torch, lambda: FA.flash_bwd_dq_ds(k, ds, seq, causal)),
            time_ms(torch, lambda: FA.flash_bwd_dkv(*args)),
            time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (q4, k4, v4), do4, retain_graph=True)))
        del lib_out, ds
    (dq_ms, dkv_ms, lib_bwd), (dq0_ms, dkv0_ms, lib0_bwd) = \
        timed[DROPOUT], timed[0.0]
    plain_bwd = time_ms(torch, lambda: FA.flash_bwd_plain(
        q, k, v, bias, o, lse, do, causal, DROPOUT, seed))
    shape = [bsz, heads, seq, d, mode, "dropout 0.1"]
    # each row's bound is the function of the TPU kernel it replaces: dq
    # 6 BH S^2 D flops (it recomputes q.k^T and do.v^T), dk/dv 8, each
    # reading q, k, v, dO, the bias, lse and delta once; float32 at the
    # smaller of the FMA-pipe and the 3xTF32 tensor-core bound, both kept
    # as extra keys.  This design's own work stands beside it: dk/dv also
    # writes the float32 score gradient ds^T (whole 64 x 64 tiles, the
    # causal ones on and below the diagonal), and dq is ds.k, 2 BH S^2 D
    # flops, reading k and ds.  The library's one backward call computes
    # dq, dk and dv together, and so does the plain version: both stand
    # beside each kernel, the library as extra keys, at dropout 0.1 and 0
    tiles = -(-seq // FA.BWD_TILE)
    ds_bytes = 4 * bh * FA.BWD_TILE ** 2 * (
        tiles * (tiles + 1) // 2 if causal else tiles ** 2)
    work = {"dq": (5 * io_bytes + extra, 6 * bh * pairs * d),
            "dkv": (6 * io_bytes + extra, 8 * bh * pairs * d)}
    design = {"dq": (2 * io_bytes + ds_bytes, 2 * bh * pairs * d),
              "dkv": (6 * io_bytes + extra + ds_bytes, 8 * bh * pairs * d)}
    witness = {}
    if dtname == "float32" and mode == "padding-bias":
        witness = float64_witness(torch, FA, what, grads, refs,
                                  (q, k, v, bias, o, lse, do), causal, seed)
    for name, err, ms, ms0 in (("dq", errs[0], dq_ms, dq0_ms),
                               ("dkv", max(errs[1:]), dkv_ms, dkv0_ms)):
        nbytes, flops = work[name]
        d_bytes, d_flops = design[name]
        bounds = {"bound_design_ms": bound_ms(d_bytes, d_flops, dtname)[0]}
        bound = None
        if dtname == "float32":
            bound = bound_ms(nbytes, 3 * flops, "tf32")
            bounds = {
                "bound_fma_ms": bound_ms(nbytes, flops, "float32")[0],
                "bound_3xtf32_ms": bound[0],
                "bound_design_ms": bound_ms(d_bytes, 3 * d_flops,
                                            "tf32")[0]}
        record(f"flash_attention_bwd_{name}", shape, dtname, err, ms,
               plain_bwd, None, nbytes, flops, bound=bound,
               library_dq_dk_dv_ms=lib_bwd, ms_dropout0=ms0,
               library_dq_dk_dv_ms_dropout0=lib0_bwd, **bounds,
               **witness.get(name, {}))


def float64_witness(torch, FA, what, grads, refs, inputs, causal, seed):
    """The float32 kernels and the float32 plain twin, each against the
    same backward in float64 (same inputs, same mask): max|Δ| over
    max(1, max|float64|), logged and returned as extra row keys.  The
    kernels reproduce the twin's q.k^T rounding, so phase 6 holds them to
    the twin; this shows how far each side is from the exact result."""
    wide = [None if t is None else t.double() for t in inputs]
    exact = FA.flash_bwd_plain(*wide, causal, DROPOUT, seed)
    out = {}
    for n, g, r, e in zip(("dq", "dk", "dv"), grads, refs, exact):
        top = max(1.0, float(e.abs().max()))
        out[n] = (float((g.double() - e).abs().max()) / top,
                  float((r.double() - e).abs().max()) / top)
        log(f"  {what} {n} vs float64: kernel {out[n][0]:.3e}, plain "
            f"twin {out[n][1]:.3e} (of max(1, max|float64|))")
    del exact, wide
    return {name: {"kernel_err_vs_float64": max(out[n][0] for n in ns),
                   "plain_err_vs_float64": max(out[n][1] for n in ns)}
            for name, ns in (("dq", ("dq",)), ("dkv", ("dk", "dv")))}


def flash_route_checks(torch, FA, gen, seed):
    """Both routes of ``bwd_plan`` at shapes the main path does not give:
    the FMA route (head dim 256, and head dims 64 and 128 with the score
    gradient scratch capped to 0 bytes, as past DS_SCRATCH_CAP) and the
    tensor-core route on unpadded and rectangular problems, each against
    the plain twin with dropout 0.1 and bit for bit across two runs; the
    16-bit cases (in bf16 and float16) their forward too, against its twin
    and bit for bit across two launches."""
    dev = torch.device("cuda", 0)
    randn = randn_on(torch, gen, dev)
    cases = [  # (bh, sq, sk, d, dtype, causal, bias ratio, scratch cap)
        (TRAIN_BATCH * 12, TRAIN_SEQ, TRAIN_SEQ, 64, torch.float32, False,
         12, 0),
        (24, 200, 200, 128, torch.bfloat16, True, 0, 0),
        (24, 100, 77, 64, torch.float32, False, 1, None),
        (24, 65, 65, 128, torch.bfloat16, True, 0, None),
        (24, 77, 200, 128, torch.float32, False, 12, None),
        (8, 100, 77, 256, torch.float32, False, 1, None),
        (8, 128, 128, 256, torch.bfloat16, True, 0, None)]
    # the 16-bit kernels at the odd and rectangular lengths too; every
    # 16-bit case again in float16
    cases += [(bh, sq, sk, d, torch.bfloat16, causal, ratio, cap)
              for bh, sq, sk, d, dt, causal, ratio, cap in cases
              if dt == torch.float32 and cap is None and d != 256]
    cases += [(bh, sq, sk, d, torch.float16, causal, ratio, cap)
              for bh, sq, sk, d, dt, causal, ratio, cap in cases
              if dt == torch.bfloat16]
    saved = FA.DS_SCRATCH_CAP
    try:
        for bh, sq, sk, d, dt, causal, ratio, cap in cases:
            FA.DS_SCRATCH_CAP = saved if cap is None else cap
            route = FA.bwd_plan(bh, sq, sk, d).route
            dtname = str(dt).replace("torch.", "")
            what = (f"flash bwd {route} route BH={bh} Sq={sq} Sk={sk} D={d} "
                    f"{'causal ' if causal else ''}{dtname}")
            q, do = (randn(bh, sq, d, dtype=dt) for _ in range(2))
            k, v = (randn(bh, sk, d, dtype=dt) for _ in range(2))
            bias = None
            if ratio:
                bias = torch.where(
                    torch.rand(bh // ratio, sq, sk, generator=gen,
                               device=dev) < 0.2, -1e4, 0.0)
            o, lse = FA.flash_fwd(q, k, v, bias, causal, DROPOUT, seed)
            if dtname != "float32":
                o2, lse2 = FA.flash_fwd(q, k, v, bias, causal, DROPOUT, seed)
                check(torch.equal(o, o2) and torch.equal(lse, lse2),
                      f"{what}: o/lse differ between two launches")
                po, plse = FA.flash_fwd_plain(q, k, v, bias, causal, DROPOUT,
                                              seed)
                agree(torch, f"{what} o", o, po, dtname, TOL_F32)
                lerr = float(((lse - plse).abs() /
                              plse.abs().clamp_min(1.0)).max())
                check(lerr <= TOL_LSE, f"{what}: lse disagrees ({lerr})")
            grads = FA.flash_bwd(q, k, v, bias, o, lse, do, causal, DROPOUT,
                                 seed)
            again = FA.flash_bwd(q, k, v, bias, o, lse, do, causal, DROPOUT,
                                 seed)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"{what}: dq/dk/dv differ between two launches")
            refs = FA.flash_bwd_plain(q, k, v, bias, o, lse, do, causal,
                                      DROPOUT, seed)
            for n, g, r in zip(("dq", "dk", "dv"), grads, refs):
                agree(torch, f"{what} {n}", g, r, dtname, TOL_GRAD,
                      relative=True)
            ms = time_ms(torch, lambda: FA.flash_bwd(
                q, k, v, bias, o, lse, do, causal, DROPOUT, seed))
            log(f"  {what}: flash_bwd (delta, dk/dv, dq) {ms:.4f} ms")
    finally:
        FA.DS_SCRATCH_CAP = saved


def ln_bwd_checks(torch, results, residual, main_rows, d, seed):
    """The LN backward (``residual``: the add+LN backward) against its
    plain twin, float32 and bfloat16: at the main path's ``main_rows`` of
    width ``d``, each also split into its row and column passes by
    ``torch.profiler``; then at R = 1, at the widths LN_EDGE_WIDTHS of
    LN_EDGE_ROWS rows, and on views 4 bytes off the vector alignment (the
    scalar instantiation).  Every case is timed beside
    ``native_layer_norm_backward`` (on u = a + b made beforehand for the
    residual variant, which it does not read), and its dscale/dbias are
    bit-identical across two launches on the same inputs."""
    from paddle_tpu_torch.ops.cuda import fused_ops as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = randn_on(torch, gen, dev)
    record = recorder(results)
    name = "add_layer_norm_bwd" if residual else "layer_norm_bwd"
    for dtname, dt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        es = torch.finfo(dt).bits // 8
        cases = [(rows, d, 0, None) for rows in main_rows] + \
            [(1, d, 0, "R=1")] + \
            [(LN_EDGE_ROWS, w, 0, f"D={w}") for w in LN_EDGE_WIDTHS] + \
            [(LN_EDGE_ROWS, d, 4 // es, "4-byte offset view")]
        for rows, width, off, case in cases:
            def operand(n):
                return randn(n + off, dtype=dt)[off:]
            a, dy = (operand(rows * width).view(rows, width)
                     for _ in range(2))
            b = operand(rows * width).view(rows, width) if residual else None
            s = 1.0 + operand(width) * 0.1
            if residual:
                def kern():
                    return K.add_layer_norm_bwd(a, b, s, dy)

                def plain():
                    return K.add_layer_norm_bwd_plain(a, b, s, dy)
                u = a + b
            else:
                def kern():
                    return K.layer_norm_bwd(a, s, dy)

                def plain():
                    return K.layer_norm_bwd_plain(a, s, dy)
                u = a
            what = f"{name} [{rows},{width}] {dtname}" + \
                (f" ({case})" if case else "")
            got, again, ref = kern(), kern(), plain()
            check(torch.equal(got[1], again[1]) and
                  torch.equal(got[2], again[2]),
                  f"{what}: dscale/dbias differ between two launches on "
                  f"the same inputs")
            err = max(agree(torch, what + " dx", got[0], ref[0], dtname,
                            TOL_F32),
                      agree(torch, what + " dscale", got[1], ref[1], dtname,
                            TOL_LN_SUM, relative=True),
                      agree(torch, what + " dbias", got[2], ref[2], dtname,
                            TOL_LN_SUM, relative=True))
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                u, [width], s, s, 1e-5)
            extra = {"case": case} if case else \
                {"split_ms": kernel_split_ms(torch, kern)}
            record(name, [rows, width], dtname, err, time_ms(torch, kern),
                   time_ms(torch, plain),
                   time_ms(torch, lambda:
                           torch.ops.aten.native_layer_norm_backward(
                               dy, u, [width], mean, rstd, s, s,
                               [True, True, True])),
                   ((3 + residual) * rows * width + 3 * width) * es,
                   (16 + residual) * rows * width,
                   dscale_dbias_bit_identical=True, **extra)


def ln_adam_training_checks(torch, results, cfg):
    from paddle_tpu_torch.ops.cuda import optimizer as O

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    randn = randn_on(torch, gen, dev)
    record = recorder(results)
    d = cfg.hidden_size
    # the encoder's rows (B*S) and the masked-LM head's (B*20), of the
    # float32 program and of the bf16 one (its LayerNorms run in float32)
    ln_bwd_checks(torch, results, False,
                  (TRAIN_BATCH * TRAIN_SEQ, TRAIN_BATCH * TRAIN_MASKS) +
                  AMP_LN_ROWS, d, SEED + 4)

    def adam_run(sizes, coeff):
        """One AdamTensor per size (random state; the LR and the powers of
        a third step), and a copy of each for the plain twin."""
        run = [O.AdamTensor(
            randn(n), randn(n), randn(n, scale=0.1),
            randn(n, scale=0.01).abs(), torch.tensor([1e-4], device=dev),
            torch.tensor([0.9 ** 3], device=dev),
            torch.tensor([0.999 ** 3], device=dev), 0.9, 0.999, 1e-8, coeff)
            for n in sizes]
        twin = [O.AdamTensor(*[t.clone() if torch.is_tensor(t) else t
                               for t in e]) for e in run]
        return run, twin

    def held(what, run, twin):
        """One launch over ``run`` against the twin on ``twin``: p, m and v
        within TOL_ADAM, each beta power advanced once, bit for bit."""
        powers = [(e.beta1_pow.clone(), e.beta2_pow.clone()) for e in run]
        O.adam_multi(run)
        O.adam_multi_plain(twin)
        err = 0.0
        for name, i in (("p", 0), ("m", 2), ("v", 3)):
            e = max(max_err(torch, a[i], b[i]) for a, b in zip(run, twin))
            log(f"  {what} {name}: max|Δ| {e:.3e} (tolerance {TOL_ADAM:.0e})")
            check(e <= TOL_ADAM, f"{what} {name}: the kernel disagrees with "
                                 f"its plain version ({e:.3e})")
            err = max(err, e)
        for e, (b1, b2) in zip(run, powers):
            check(torch.equal(e.beta1_pow, b1 * e.beta1) and
                  torch.equal(e.beta2_pow, b2 * e.beta2),
                  f"{what}: the beta powers did not advance exactly once")
        return err

    def library(run, coeff):
        fused = torch._fused_adamw_ if coeff else torch._fused_adam_
        args = [[e[i] for e in run] for i in range(4)]
        steps = [torch.tensor([1.0], device=dev) for _ in run]

        def call():
            fused(*args, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
                  weight_decay=coeff, eps=1e-8, amsgrad=False,
                  maximize=False)
        return call

    # one step's 158 updates as one run, adam (phase 7) and adamw (phase
    # 8), beside one library call over the same tensors.  The run's host
    # work (its table of 158 rows) outlasts time_ms's head start, so the
    # kernel and the library are timed by the profiler's device time; the
    # CUDA-event spans stand beside them
    shapes = bert_base_param_shapes(cfg)
    check(len(shapes) == ADAM_OPS, f"BERT-base has {len(shapes)} parameters")
    sizes = [math.prod(sh) for sh in shapes]
    total = sum(sizes)
    adam_err = 0.0
    for kind, coeff in (("adam", 0.0), ("adamw", WEIGHT_DECAY)):
        run, twin = adam_run(sizes, coeff)
        what = f"{kind} all {len(sizes)} BERT-base parameters, one launch"
        adam_err = max(adam_err, held(what, run, twin))
        lib = library(run, coeff)
        record("adam", [f"all {len(sizes)} BERT-base parameters, {kind}",
                        total], "float32", adam_err,
               sum(kernel_split_ms(torch, lambda: O.adam_multi(run))
                   .values()),
               time_ms(torch, lambda: O.adam_multi_plain(twin), samples=9),
               sum(kernel_split_ms(torch, lib).values()), 28 * total,
               12 * total, ms_from="profiler device time",
               events_ms=time_ms(torch, lambda: O.adam_multi(run),
                                 samples=9),
               library_events_ms=time_ms(torch, lib, samples=9),
               library_is=f"torch._fused_{kind}_, one call")
        del run, twin, lib
    # runs of one: the word embedding, a 768 x 3072 FFN weight, an LN
    # vector and next_sent_fc.b_0
    for n in (cfg.vocab_size * d, 4 * d * d, d, 2):
        run, twin = adam_run([n], 0.0)
        err = held(f"adam run of one n={n}", run, twin)
        record("adam", [n], "float32", err,
               time_ms(torch, lambda: O.adam_multi(run)),
               time_ms(torch, lambda: O.adam_multi_plain(twin)),
               time_ms(torch, library(run, 0.0)), 28 * n, 12 * n)
        adam_err = max(adam_err, err)
    adam16_checks(torch, results, randn, dev, sizes, 4 * d * d, O)


#: #10 on 16-bit parameters: (p, m and v) dtypes held and timed, at the
#: 158-tensor run and at one 768 x 3072 FFN weight (a pure-bf16 program
#: after cast_parameters_to_bf16 keeps float32 moments beside bf16 p)
ADAM16_RUN = (("bfloat16", "float32"), ("bfloat16", "bfloat16"),
              ("float16", "float32"))
ADAM16_ONE = ADAM16_RUN + (("float16", "float16"),)
#: #10's 16-bit check state: an LR, an AdamW coefficient and a parameter
#: scale at which both the Adam step and the decay move most 16-bit
#: parameters past their rounding (at the recipe's 1e-4 they stay put, and
#: a kernel that left p alone would agree with its twin)
ADAM16_CHECK = dict(lr=0.05, coeff=0.5, p_scale=0.01)
#: the least share of p that the check's update must move
ADAM16_MOVED = 0.5


def adam16_checks(torch, results, randn, dev, sizes, ffn, O):
    """#10 with 16-bit p (and m, v float32 or p's dtype): kernel against
    the twin from the same state bit for bit (both compute in float32 in
    the same order and round each output once; AdamW's decay in p's
    dtype), at ``ADAM16_CHECK``, where the Adam step and the decay each
    move most of p (checked against the start and a twin without decay,
    so a kernel that skipped either would differ); the beta powers
    advanced once, and two launches bit-identical.  Timed at the recipe's
    LR without decay beside ``torch._fused_adam_`` on the same tensors
    (all of p's dtype when the library refuses float32 moments beside
    16-bit p)."""
    record = recorder(results)

    def state(sizes, pdt, mdt, lr=1e-4, coeff=0.0, p_scale=1.0):
        pt, mt = getattr(torch, pdt), getattr(torch, mdt)
        return [O.AdamTensor(
            randn(n, scale=p_scale, dtype=pt), randn(n, dtype=mt),
            randn(n, scale=0.1, dtype=mt),
            randn(n, scale=0.01).abs().to(mt),
            torch.tensor([lr], device=dev),
            torch.tensor([0.9 ** 3], device=dev),
            torch.tensor([0.999 ** 3], device=dev), 0.9, 0.999, 1e-8, coeff)
            for n in sizes]

    def copy(run):
        return [O.AdamTensor(*[t.clone() if torch.is_tensor(t) else t
                               for t in e]) for e in run]

    def share_moved(a, b):
        return sum(int((x.p != y.p).sum()) for x, y in zip(a, b)) / \
            sum(x.p.numel() for x in a)

    def library(run, pdt):
        args = [[e[i] for e in run] for i in range(4)]
        steps = [torch.tensor([1.0], device=dev) for _ in run]

        def call():
            torch._fused_adam_(*args, [], steps, lr=1e-4, beta1=0.9,
                               beta2=0.999, weight_decay=0.0, eps=1e-8,
                               amsgrad=False, maximize=False)
        try:
            call()
            return call, "torch._fused_adam_, one call, the same tensors"
        except (RuntimeError, TypeError, NotImplementedError):
            same = [O.AdamTensor(*[t.to(getattr(torch, pdt))
                                   if torch.is_tensor(t) and t.numel() > 1
                                   else t for t in e]) for e in run]
            return library(same, pdt)[0], (
                f"torch._fused_adam_, one call, p, g, m, v all {pdt} (it "
                f"refuses float32 moments beside {pdt} p)")

    for label, run_sizes, combos in (
            (f"all {len(sizes)} BERT-base parameters", sizes, ADAM16_RUN),
            ("one 768 x 3072 FFN weight", [ffn], ADAM16_ONE)):
        for pdt, mdt in combos:
            start = state(run_sizes, pdt, mdt, **ADAM16_CHECK)
            twin, one, two = copy(start), copy(start), copy(start)
            bare = [e._replace(coeff=0.0) for e in copy(start)]
            O.adam_multi_plain(twin)
            O.adam_multi_plain(bare)
            O.adam_multi(one)
            O.adam_multi(two)
            what = f"adam {label}, p {pdt}, m and v {mdt}"
            moved, decayed = share_moved(twin, start), share_moved(twin, bare)
            log(f"  {what}: the check's update moves {100 * moved:.2f} % of "
                f"p, its decay {100 * decayed:.2f} % (lr "
                f"{ADAM16_CHECK['lr']}, coeff {ADAM16_CHECK['coeff']}, |p| "
                f"~{ADAM16_CHECK['p_scale']})")
            check(min(moved, decayed) > ADAM16_MOVED,
                  f"{what}: the check's update leaves p in place")
            err = 0.0
            for name, i in (("p", 0), ("m", 2), ("v", 3)):
                dt = str(start[0][i].dtype).replace("torch.", "")
                e = max(max_err(torch, a[i], b[i]) for a, b in zip(one, twin))
                log(f"  {what} {name} ({dt}): max|Δ| {e:.3e} (bit for bit)")
                check(all(torch.equal(a[i], b[i]) for a, b in zip(one, twin)),
                      f"{what} {name}: the kernel disagrees with its plain "
                      f"version ({e:.3e})")
                check(all(torch.equal(a[i], b[i]) for a, b in zip(one, two)),
                      f"{what} {name}: two launches differ")
                err = max(err, e)
            for a, b in zip(one, start):
                check(torch.equal(a.beta1_pow, b.beta1_pow * b.beta1),
                      f"{what}: the beta powers did not advance once")
            del twin, two, bare, one, start
            # timed at the recipe's LR without decay, as the library's call
            start = state(run_sizes, pdt, mdt)
            one = copy(start)
            total = sum(run_sizes)
            pb, mb = (torch.finfo(getattr(torch, t)).bits // 8
                      for t in (pdt, mdt))
            lib, lib_is = library(copy(start), pdt)
            record("adam", [label, total], pdt, err,
                   sum(kernel_split_ms(torch, lambda: O.adam_multi(one))
                       .values()),
                   time_ms(torch, lambda: O.adam_multi_plain(start),
                           samples=9),
                   sum(kernel_split_ms(torch, lib).values()),
                   (2 * pb + 5 * mb) * total, 12 * total,
                   bound=bound_ms((2 * pb + 5 * mb) * total, 12 * total,
                                  "float32"),
                   ms_from="profiler device time", moments=mdt,
                   library_is=lib_is)
            del start, one, lib


def fused_training_checks(torch, results, cfg):
    """add+LN backward at the encoder's rows and bias+GELU backward at the
    FFN's and the masked-LM transform's, each also at EDGE_ROWS."""
    from paddle_tpu_torch.ops.cuda import fused_ops as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    randn = randn_on(torch, gen, dev)
    record = recorder(results)
    d = cfg.hidden_size
    ln_bwd_checks(torch, results, True,
                  (TRAIN_BATCH * TRAIN_SEQ, 1000, EDGE_ROWS), d, SEED + 5)
    for dtname, dt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        es = torch.finfo(dt).bits // 8
        for rows, width in ((TRAIN_BATCH * TRAIN_SEQ, cfg.intermediate_size),
                            (TRAIN_BATCH * TRAIN_MASKS, d),
                            (EDGE_ROWS, cfg.intermediate_size)):
            x, dy = randn(rows, width, dtype=dt), randn(rows, width, dtype=dt)
            bb = randn(width, scale=0.1, dtype=dt)
            what = f"bias_gelu_bwd [{rows},{width}] {dtname}"
            got = K.bias_gelu_bwd(x, bb, dy)
            ref = K.bias_gelu_bwd_plain(x, bb, dy)
            err = max(agree(torch, what + " dx", got[0], ref[0], dtname,
                            TOL_F32),
                      agree(torch, what + " db", got[1], ref[1], dtname,
                            TOL_LN_SUM, relative=True))
            u = x + bb

            def library():
                return torch.ops.aten.gelu_backward(dy, u).sum(0)
            # ~30 operations per element: erff and expf, the add, 6 muls
            record("bias_gelu_bwd", [rows, width], dtname, err,
                   time_ms(torch, lambda: K.bias_gelu_bwd(x, bb, dy)),
                   time_ms(torch, lambda: K.bias_gelu_bwd_plain(x, bb, dy)),
                   time_ms(torch, library),
                   (3 * rows * width + 2 * width) * es, 30 * rows * width,
                   library_is="gelu_backward(dy, x + b) and its .sum(0)")


def quant_peers(torch, gen, spec, n, sb, offset=0):
    """n peers' quantized shards of sb blocks, peer-major as all_to_all
    delivers them, from gradient-like data: each block's magnitude drawn
    log-uniform in [1e-3, 1], so none lies far below the tolerances; with
    ``offset`` the payload is a view ``offset`` bytes into a larger
    buffer, so its base is not 16-byte aligned."""
    from paddle_tpu_torch.ops.quantize_wire import quantize_blockwise
    dev = torch.device("cuda", 0)
    x = torch.randn(n * sb, spec.block_size, generator=gen, device=dev)
    x *= 10.0 ** (-3 * torch.rand(n * sb, 1, generator=gen, device=dev))
    q, s = quantize_blockwise(x.reshape(-1), spec)
    if offset:
        buf = torch.empty(q.numel() + offset, dtype=torch.int8, device=dev)
        buf[offset:].copy_(q.reshape(-1))
        q = buf[offset:].view(q.shape)
    return q, s


def quant_bytes(spec, n, sb, requant):
    """Bytes #11 / #12 must move at n peers of sb blocks: the payload and
    scales read once; #11 writes float32 per element, #12 a byte per
    element and a scale per block."""
    read = n * sb * (spec.payload_cols + 4)
    write = sb * (spec.payload_cols + 4) if requant else \
        4 * sb * spec.block_size
    return read + write


def quant_kernel_checks(torch, results):
    """#11 and #12 against their plain versions at the shard shapes of
    BERT-base's gradient buckets; the first row of each is its main-path
    shape (n = 2, the word-embedding bucket's 45,783 blocks: #12 in the
    int8 tier, #11 in the int4 tier); then the chain of a step's 13
    launches in bucket order.  Every case must launch the CUDA kernel
    (its launch counter moves by one), unaligned views included."""
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.cuda import quant_kernels as QK
    from paddle_tpu_torch.ops.quantize_wire import CompressionSpec
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(
        SEED + 4)
    record = recorder(results)
    # (wire dtype, block, peers, shard blocks, payload offset)
    cases = [("int4", 256, 2, 45783, 0), ("int8", 256, 2, 45783, 0),
             ("int8", 256, 2, 13844, 0), ("int4", 256, 2, 13844, 0),
             ("int4", 128, 2, 13844, 0), ("int8", 256, 4, 1003, 0),
             ("int8", 256, 8, 1003, 0), ("int4", 256, 8, 1003, 0),
             ("int4", 128, 4, 1003, 0), ("int8", 256, 2, 1003, 1),
             ("int4", 128, 2, 1003, 3), ("int8", 256, 3, 1003, 0),
             ("int4", 256, 3, 1003, 0), ("int8", 256, 2, 16217, 0),
             ("int8", 256, 2, 14618, 0), ("int4", 256, 2, 16217, 0),
             ("int4", 256, 2, 14618, 0)]
    for dtype, block, n, sb, offset in cases:
        spec = CompressionSpec(dtype, block)
        q, s = quant_peers(torch, gen, spec, n, sb, offset)
        shape = [n, sb, block, dtype] + (["unaligned"] if offset else [])
        what = f"n={n} SB={sb} {dtype} block {block}" + \
            (f" payload at +{offset} bytes" if offset else "")
        elems = sb * block
        launched = kernels.launch_counts()["dequant_accumulate"]
        acc = QK.dequant_accumulate(q, s, spec, n)
        check(kernels.launch_counts()["dequant_accumulate"] == launched + 1,
              f"dequant_accumulate {what}: the CUDA kernel did not launch")
        ref = QK.dequant_accumulate_plain(q, s, spec, n)
        err = agree(torch, f"dequant_accumulate {what}", acc, ref, "float32",
                    TOL_DQ_ACC)
        # and block by block, of the block's own max|plain|, so a block of
        # small values is held as tightly as a large one
        blocks_ref = ref.reshape(sb, block)
        block_err = float(((acc.reshape(sb, block) - blocks_ref).abs()
                           .amax(1) / blocks_ref.abs().amax(1)
                           .clamp_min(1e-30)).max())
        log(f"  dequant_accumulate {what}: worst block max|Δ| / max|plain| "
            f"{block_err:.3e} (tolerance {TOL_DQ_ACC_BLOCK:.0e})")
        check(block_err <= TOL_DQ_ACC_BLOCK,
              f"dequant_accumulate {what}: a block disagrees with its plain "
              f"version ({block_err:.3e} of its max)")
        record("dequant_accumulate", shape, "float32", err,
               time_ms(torch, lambda: QK.dequant_accumulate(q, s, spec, n)),
               time_ms(torch, lambda: QK.dequant_accumulate_plain(
                   q, s, spec, n)), None,
               quant_bytes(spec, n, sb, False), 2 * n * elems,
               device_ms=sum(kernel_split_ms(
                   torch, lambda: QK.dequant_accumulate(q, s, spec, n))
                   .values()) or None)
        if dtype != "int8":
            continue
        launched = kernels.launch_counts()["dequant_accumulate_requant"]
        q2, s2 = QK.dequant_accumulate_requant(q, s, spec, n)
        check(kernels.launch_counts()["dequant_accumulate_requant"] ==
              launched + 1, f"dequant_accumulate_requant {what}: the CUDA "
                            f"kernel did not launch")
        p2, t2 = QK.dequant_accumulate_requant_plain(q, s, spec, n)
        differ = int((q2 != p2).sum())
        serr = max_err(torch, s2, t2)
        log(f"  dequant_accumulate_requant {what}: payload bytes that differ "
            f"{differ} (must be 0), scales max|Δ| {serr:.3e} (tolerance "
            f"{TOL_DQ_SCALE:.0e})")
        check(differ == 0, f"dequant_accumulate_requant {what}: payload not "
                           f"bit-identical to its plain version")
        check(serr <= TOL_DQ_SCALE, f"dequant_accumulate_requant {what}: "
                                    f"scales disagree ({serr:.3e})")
        # per element: n conversions and fused multiply-adds, then |x|,
        # max, the quotient's multiply and two FMAs, the clip and rint: ~7
        record("dequant_accumulate_requant", shape, "float32", serr,
               time_ms(torch, lambda: QK.dequant_accumulate_requant(
                   q, s, spec, n)),
               time_ms(torch, lambda: QK.dequant_accumulate_requant_plain(
                   q, s, spec, n)), None,
               quant_bytes(spec, n, sb, True), (2 * n + 7) * elems,
               payload_bytes_differ=differ,
               device_ms=sum(kernel_split_ms(
                   torch, lambda: QK.dequant_accumulate_requant(
                       q, s, spec, n)).values()) or None)
    for name, dtype in (("dequant_accumulate_requant", "int8"),
                        ("dequant_accumulate", "int4")):
        results.setdefault("quant_step", {})[name] = quant_step_chain(
            torch, QK, gen, CompressionSpec(dtype, 256), results[name])


def quant_step_chain(torch, QK, gen, spec, rows):
    """A step's 13 launches of the tier's kernel (#12 int8, #11 int4) at
    n = 2 in bucket order, back to back on 13 inputs (~110 MB in the int8
    tier: more than the L2 holds): events over the chain and the sum of
    its profiled device times; beside them the sums over the 13 buckets of
    the per-shape rows above (events alone, device time, plain version,
    bound)."""
    requant = spec.dtype == "int8"
    fn = QK.dequant_accumulate_requant if requant else QK.dequant_accumulate
    inputs = [quant_peers(torch, gen, spec, 2, sb) for sb in STEP_BUCKET_SB]

    def chain():
        for q, s in inputs:
            fn(q, s, spec, 2)
    by_shape = {r["shape"][1]: r for r in rows
                if r["shape"] == [2, r["shape"][1], 256, spec.dtype]}
    out = {"buckets": list(STEP_BUCKET_SB),
           "chain_ms": time_ms(torch, chain, samples=15),
           "chain_device_ms": sum(kernel_split_ms(torch, chain,
                                                  calls=5).values()) or None,
           "bound_ms": sum(quant_bytes(spec, 2, sb, requant)
                           for sb in STEP_BUCKET_SB) / HBM_BYTES_PER_S * 1e3}
    for key in ("ms", "device_ms", "plain_ms"):
        times = [by_shape[sb][key] for sb in STEP_BUCKET_SB]
        out["sum_" + key] = None if None in times else sum(times)

    def ms(key):
        return "not measured" if out[key] is None else f"{out[key]:.4f} ms"
    log(f"  {spec.dtype} step, 13 launches at SB {STEP_BUCKET_SB[0]}, "
        f"{STEP_BUCKET_SB[1]}, 10 x {STEP_BUCKET_SB[2]}, "
        f"{STEP_BUCKET_SB[-1]}: chain {ms('chain_ms')} (events), "
        f"{ms('chain_device_ms')} (device); per shape alone, summed: "
        f"events {ms('sum_ms')}, device {ms('sum_device_ms')}, plain "
        f"{ms('sum_plain_ms')}; bound {ms('bound_ms')} (bytes)")
    del inputs
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: data-parallel BERT-base, two ranks on the one card
# ---------------------------------------------------------------------------


def build_dp_train(cfg, tier):
    """Phase 10's program as a rank writes it: phase 8's recipe and both
    fusion passes, through ``fleet`` with the ``tier`` quantized gradient
    all-reduce.  Returns (fleet.main_program, startup, loss, LR var)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        s = DistributedStrategy()
        s.quant_allreduce = True
        s.quant_configs = {"dtype": tier, "block_size": 256,
                           "stochastic_rounding": False}
        s.build_strategy = fluid.BuildStrategy()
        s.build_strategy.fuse_elewise_add_act_ops = True
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(PEAK_LR, DECAY_STEPS, 0.0,
                                          power=1.0),
            WARMUP_STEPS, 0.0, PEAK_LR)
        inner = fluid.optimizer.AdamW(
            lr, weight_decay=WEIGHT_DECAY,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(CLIP_NORM))
        fleet.distributed_optimizer(inner, s).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    return fleet.main_program, startup, total, inner.learning_rate_var


def params_digest(np, scope, program):
    """sha256 over every parameter's bytes, in name order."""
    import hashlib
    h = hashlib.sha256()
    for p in sorted(program.all_parameters(), key=lambda v: v.name):
        h.update(p.name.encode())
        h.update(np.ascontiguousarray(
            scope.find_var(p.name).detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def moment1_tensors(scope, program):
    """Adam's first moment of every parameter, by accumulator name."""
    return {v.name: scope.find_var(v.name) for v in program.list_vars()
            if v.persistable and "_moment1_" in v.name}


def timed_collectives(torch):
    """Wrap the gloo transfers of ops/collective_ops.py so one step can
    report their wall time (synchronised first, so the time is the
    transfer's and not the queued work's).  Returns (totals, undo)."""
    from paddle_tpu_torch.ops import collective_ops as C
    totals = {"ms": 0.0, "calls": 0}
    saved = {n: getattr(C, n) for n in ("all_to_all", "all_gather",
                                        "all_reduce")}

    def wrap(fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            totals["ms"] += (time.perf_counter() - t0) * 1e3
            totals["calls"] += 1
            return out
        return timed

    for n, fn in saved.items():
        setattr(C, n, wrap(fn))

    def undo():
        for n, fn in saved.items():
            setattr(C, n, fn)
    return totals, undo


def dp_leg(torch, np, cfg, tier, steps, measure, moments_path=None):
    """One leg on this rank: ``steps`` steps of the data-parallel program
    through prepare(donate_state=True) on the global batch, counts from
    zero before and read after; with ``measure`` one profiled step and
    one step with the collectives timed follow; with ``moments_path`` the
    Adam first moments are saved there for the parent."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    program, startup, total, lr_var = build_dp_train(cfg, tier)
    check(program._dp is not None and program._dp.world == DP_RANKS,
          f"fleet.main_program is not data-parallel over {DP_RANKS} ranks")
    buckets = sum(op.type == "c_fused_quant_allreduce_sum"
                  for op in program._program.global_block().ops)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    prepared = exe.prepare(program, fetch_list=[total, lr_var], scope=scope,
                           donate_state=True)

    def step():
        handle, lr = prepared.run(feed)
        return float(handle), float(lr)

    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, _ = step()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = kernels.launch_counts()
    fallbacks = registry.route_counts("fallback")
    fluid.sync_prepared_state(scope)
    out = {"tier": tier, "buckets": buckets, "losses": losses,
           "step_s": step_s, "launches": launches,
           "fallbacks": {str(k): v for k, v in fallbacks.items()},
           "params_sha256": params_digest(np, scope, program._program)}
    if moments_path:
        torch.save({n: t.detach().cpu() for n, t in
                    moment1_tensors(scope, program._program).items()},
                   moments_path)
    if measure:
        steady = statistics.median(step_s[2:])
        out["step_ms_median_3_10"] = steady * 1e3
        out["profile"] = profile_step(torch, step, steady * 1e3)
        totals, undo = timed_collectives(torch)
        try:
            t0 = time.perf_counter()
            step()
            out["collectives_step_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            undo()
        out["collectives_ms"] = totals["ms"]
        out["collective_calls"] = totals["calls"]
    del prepared, scope
    return out


def dp_worker(out_dir):
    """One rank of phase 10 (started by the launcher with
    ``--dp-worker``): writes ``rank<r>.json`` to ``out_dir``; any failed
    check exits non-zero, which fails the launch and the phase."""
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    from paddle_tpu_torch.models import bert
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    dev = torch.device("cuda", fleet.place.device_id)
    res = {"rank": rank, "world": fleet.worker_num(),
           "backend": fleet.backend, "place": repr(fleet.place),
           "device": torch.cuda.get_device_name(dev)}
    log(f"[rank {rank}] {res}")
    check(res["backend"] == "gloo", f"rank {rank} on {res['backend']}")
    base = bert.BertConfig.base()
    per_step = dict(FUSED_LAUNCHES)
    for tier, steps, kernel in (("int8", TRAIN_STEPS,
                                 "dequant_accumulate_requant"),
                                ("int4", DP_INT4_STEPS,
                                 "dequant_accumulate")):
        leg = dp_leg(torch, np, base, tier, steps, measure=True)
        res[tier] = leg
        log(f"[rank {rank}] {tier}: {leg['buckets']} buckets, losses "
            f"{[round(x, 5) for x in leg['losses']]}, step times (s) "
            f"{[round(x, 4) for x in leg['step_s']]}, launches "
            f"{leg['launches']}")
        check(leg["buckets"] == DP_BUCKETS,
              f"{tier}: {leg['buckets']} quantized buckets, expected "
              f"{DP_BUCKETS}")
        check(not leg["fallbacks"], f"{tier}: route fallbacks "
                                    f"{leg['fallbacks']}")
        check(all(math.isfinite(x) for x in leg["losses"]),
              f"{tier}: non-finite loss {leg['losses']}")
        check(leg["losses"][-1] < leg["losses"][0],
              f"{tier}: the loss did not fall: {leg['losses']}")
        want = dict(per_step, **{kernel: DP_BUCKETS})
        for name, n in leg["launches"].items():
            check(n == want.get(name, 0) * steps,
                  f"{tier}: {name} launched {n} times in {steps} steps, "
                  f"expected {want.get(name, 0)} per step")
    cfg0 = dataclasses.replace(base, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    res["dropout0_int8"] = dp_leg(
        torch, np, cfg0, "int8", PLAIN_STEPS, measure=False,
        moments_path=os.path.join(out_dir, "moment1.pt") if rank == 0
        else None)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def single_gpu_run(torch, np, cfg):
    """PLAIN_STEPS steps of phase 8's program on one GPU on the global
    batch (the data-parallel run's reference): the losses and the Adam
    first moments after them."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    program, startup, total, _ = build_fused_train(cfg)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    losses = [float(prepared.run(feed)[0]) for _ in range(PLAIN_STEPS)]
    fluid.sync_prepared_state(scope)
    moments = {n: t.detach().clone() for n, t in
               moment1_tensors(scope, program._program).items()}
    del prepared, scope
    return losses, moments


def dp_phase(torch, np, repo, cfg):
    """Launch the two ranks, hold their results against each other and
    the dropout-free leg against one GPU: the losses at the int8 tier's
    bound, and the Adam first moments, which a wrong reduction moves."""
    import dataclasses
    from paddle_tpu_torch.ops.cuda import build
    out_dir = os.path.join(build.BUILD_DIR, "smoke_dp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(DP_RANKS), "--selected_gpus", "0,0",
           "--backend", "gloo", "--timeout", str(DP_TIMEOUT_S),
           os.path.join(repo, "chip_smoke.py"), "--dp-worker", out_dir]
    log("  " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=repo, timeout=DP_TIMEOUT_S + 60).returncode
    log(f"  the ranks ran {time.perf_counter() - t0:.1f} s, exit code {rc}")
    check(rc == 0, f"a data-parallel rank failed (launcher exit code {rc})")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for leg in ("int8", "int4", "dropout0_int8"):
        digests = {r[leg]["params_sha256"] for r in ranks}
        log(f"  {leg}: parameter sha256 per rank "
            f"{[r[leg]['params_sha256'][:16] for r in ranks]}")
        check(len(digests) == 1, f"{leg}: the ranks' parameters differ")
        losses = {tuple(r[leg]["losses"]) for r in ranks}
        check(len(losses) == 1, f"{leg}: the ranks fetched other losses")
    for r in ranks:
        for tier, kernel in (("int8", "#12"), ("int4", "#11")):
            m = r[tier]
            prof = m.get("profile") or {}
            steps = TRAIN_STEPS if tier == "int8" else DP_INT4_STEPS
            log(f"  rank {r['rank']} ({r['place']}, {r['backend']}, "
                f"{r['device']}): {tier} step median of steps 3-{steps} "
                f"{m['step_ms_median_3_10']:.2f} ms; device busy "
                + (f"{100 * prof['busy_share']:.1f} % of it, {kernel} "
                   f"{prof['quant_launches']} launches {prof['quant_ms']:.4f}"
                   f" device ms" if prof else "not measured")
                + f"; collectives (gloo staged through the host, two ranks "
                f"on one card: no measure of NVLink) "
                f"{m['collectives_ms']:.2f} ms in {m['collective_calls']} "
                f"calls of a {m['collectives_step_ms']:.2f} ms step")
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    single, single_m = single_gpu_run(torch, np, cfg0)
    dp = ranks[0]["dropout0_int8"]["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(dp, single))
    log(f"  dropout 0, {PLAIN_STEPS} steps: two ranks int8 "
        f"{[round(x, 6) for x in dp]} vs one GPU "
        f"{[round(x, 6) for x in single]}: max relative gap {gap:.3e} "
        f"(tolerance {TOL_DP_INT8:.0e}, the int8 tier's bound)")
    check(gap <= TOL_DP_INT8, "two-rank int8 training strays from one GPU")
    dp_m = torch.load(os.path.join(out_dir, "moment1.pt"),
                      map_location=torch.device("cuda", 0))
    check(dp_m.keys() == single_m.keys() and len(single_m) > 0,
          "the two runs' Adam moments do not name the same parameters")
    num = den = 0.0
    worst, worst_name = 0.0, None
    for n, ref in single_m.items():
        d2 = float((dp_m[n].double() - ref.double()).pow(2).sum())
        r2 = float(ref.double().pow(2).sum())
        num, den = num + d2, den + r2
        rel = math.sqrt(d2 / r2) if r2 else math.sqrt(d2)
        if rel > worst:
            worst, worst_name = rel, n
    m_gap = math.sqrt(num / den)
    log(f"  dropout 0, {PLAIN_STEPS} steps: Adam first moments, two ranks "
        f"int8 vs one GPU, relative norm over {len(single_m)} parameters "
        f"{m_gap:.3e} (tolerance {TOL_DP_MOMENTS:.3e}, four int8 quanta); "
        f"worst parameter {worst_name} {worst:.3e}")
    check(m_gap <= TOL_DP_MOMENTS,
          "two-rank int8 gradients stray from one GPU's (Adam moments)")
    del dp_m, single_m
    return ranks, {"single_gpu_losses": single, "dp_int8_losses": dp,
                   "max_rel_gap": gap, "moment1_rel_gap": m_gap,
                   "moment1_worst": [worst_name, worst]}


# ---------------------------------------------------------------------------
# phase 7: BERT-base training through the port
# ---------------------------------------------------------------------------


def build_train(cfg, amp=False, pure_bf16=True):
    """Phase 7's program: pretraining + Adam(1e-4), run as it is; with
    ``amp``, bench.py's: the optimizer under
    ``decorate(..., use_pure_bf16=pure_bf16)`` (phase 12; fp16 with
    dynamic loss scaling when not ``pure_bf16``).  Returns (the program to
    run, startup, loss, LR var)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = Program(), Program()
    startup.random_seed = main.random_seed = SEED
    with program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        opt = fluid.optimizer.Adam(PEAK_LR)
        if amp:
            opt = decorate(opt, use_pure_bf16=pure_bf16)
        opt.minimize(total)
    return main, startup, total, opt.learning_rate_var


def build_fused_train(cfg, amp=False, lamb=False):
    """Phase 8's program, as a user writes it: the recipe, then both
    fusion passes (``fuse_elemwise_add_act`` through the build
    strategy); with ``amp`` the optimizer under ``decorate`` in bf16
    (phase 12); with ``lamb`` the recipe's LAMB in place of AdamW (phase
    13).  Returns (the CompiledProgram, startup, loss, LR var)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = Program(), Program()
    startup.random_seed = main.random_seed = SEED
    with program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(PEAK_LR, DECAY_STEPS, 0.0,
                                          power=1.0),
            WARMUP_STEPS, 0.0, PEAK_LR)
        clip = fluid.clip.GradientClipByGlobalNorm(CLIP_NORM)
        if lamb:
            opt = fluid.optimizer.LambOptimizer(
                lr, lamb_weight_decay=WEIGHT_DECAY, epsilon=LAMB_EPSILON,
                grad_clip=clip, exclude_from_weight_decay_fn=lamb_no_decay)
        else:
            opt = fluid.optimizer.AdamW(lr, weight_decay=WEIGHT_DECAY,
                                        grad_clip=clip)
        if amp:
            opt = decorate(opt, use_pure_bf16=True)
        opt.minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    bs = fluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=total.name, build_strategy=bs)
    return compiled, startup, total, opt.learning_rate_var


def lamb_no_decay(param):
    """The BERT LAMB recipe's exclusions from weight decay: every
    LayerNorm parameter and every bias, by name."""
    n = param.name
    return "_ln" in n or n.endswith(("_b", "_bias", ".b_0"))


def scheduled_lr(step):
    """The recipe's LR for run ``step`` (0-based), in closed form."""
    if step < WARMUP_STEPS:
        return PEAK_LR * step / WARMUP_STEPS
    return PEAK_LR * (1.0 - min(step, DECAY_STEPS) / DECAY_STEPS)


# the port's kernels by their CUDA function names (csrc/*.cu)
PORT_KERNEL_NAMES = ("flash_fwd_kernel", "flash_fwd_sm90_kernel",
                     "flash_fwd_fma_kernel", "flash_bwd_dq_kernel",
                     "flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel",
                     "flash_bwd_dq_fma_kernel",
                     "flash_bwd_dkv_fma_kernel", "ln_fwd_kernel",
                     "ln_bwd_rows_kernel", "ln_bwd_colsum_kernel",
                     "bias_gelu_fwd_kernel", "bias_gelu_bwd_kernel",
                     "bias_gelu_bwd_colsum_kernel",
                     "adam_multi_kernel", "dq_acc_kernel",
                     "dq_acc_loop_kernel", "dq_acc_requant_kernel",
                     "dq_acc_requant_loop_kernel")


def covered_us(spans):
    """Length of the union of (start, end) spans: device time during which
    at least one of them ran."""
    total, lo, hi = 0.0, None, None
    for start, end in sorted(spans):
        if hi is None or start > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return total + (0.0 if hi is None else hi - lo)


def range_kernels(prof, name):
    """(launches, device ms) of the kernels launched inside the CPU ranges
    ``name`` (``torch.profiler.record_function``) of a profile: each op's
    kernels, found by the profiler's correlation of launch and kernel,
    summed over the ranges' descendants."""
    from torch.autograd import DeviceType
    n, us = 0, 0.0
    stack = [e for e in prof.events()
             if e.name == name and e.device_type == DeviceType.CPU]
    while stack:
        e = stack.pop()
        for k in getattr(e, "kernels", ()):
            n += 1
            us += k.duration
        stack.extend(getattr(e, "cpu_children", ()))
    return n, us / 1e3


def profile_step(torch, step, step_ms, ranges=()):
    """Device time of one training step by kernel, from torch.profiler:
    the port's kernels, the matrix products (cuBLAS / CUTLASS gemm, and
    cuBLASLt's ``nvjet`` kernels) and everything else (sums of each
    kernel's span), and the device's busy share of ``step_ms`` (the
    median unprofiled step): the union of the
    spans, since a programmatic dependent launch (the LN backwards'
    column sum) starts, and waits, before its primary ends.  Each named
    CPU range of ``ranges`` (plain PyTorch ops: none is a port kernel or
    a product) gets its own group, taken out of "other", with its
    launches.  None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    by_name, spans = {}, []
    for e in prof.events():
        # a named range also shows as a span on the device's timeline
        # (first to last kernel inside it): not a kernel, not busy time
        if e.device_type == DeviceType.CUDA and e.name not in ranges:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
            spans.append((e.time_range.start, e.time_range.end))
    if not by_name:
        log("  device time by kernel: not measured (the profiler saw no "
            "device activity)")
        return None
    groups = {"port kernels": 0.0, "matrix products": 0.0, "other": 0.0}
    quant = [0, 0.0]             # #11 / #12: launches, device ms
    for name, (n, us) in by_name.items():
        low = name.lower()
        if "dq_acc" in name:
            quant[0] += n
            quant[1] += us / 1e3
        if any(k in name for k in PORT_KERNEL_NAMES):
            groups["port kernels"] += us / 1e3
        elif "gemm" in low or "cutlass" in low or low.startswith("nvjet"):
            groups["matrix products"] += us / 1e3
        else:
            groups["other"] += us / 1e3
    launches_in = {}
    for name in ranges:
        n, ms = range_kernels(prof, name)
        launches_in[name] = n
        if n:
            groups[name] = ms
            groups["other"] -= ms
        else:
            log(f"  {name}: not measured (the profiler linked no kernel "
                f"to the range)")
    busy = covered_us(spans) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    log(f"  one profiled step: device busy {busy:.2f} ms of the "
        f"{step_ms:.2f} ms median step ({100 * busy / step_ms:.1f} %); "
        + ", ".join(f"{g} {ms:.2f} ms" for g, ms in groups.items()))
    for name, n in launches_in.items():
        if n:
            log(f"  {name}: {n} launches, {groups[name]:.3f} device ms")
    for name, (n, us) in top:
        log(f"    {us / 1e3:8.3f} ms  {n:4d}x  {name[:110]}")
    return {"busy_ms": busy, "step_ms": step_ms,
            "range_launches": launches_in,
            "busy_share": busy / step_ms, "groups_ms": groups,
            "quant_launches": quant[0], "quant_ms": quant[1],
            "top": [{"name": name[:200], "calls": n, "ms": us / 1e3}
                    for name, (n, us) in top]}


def check_launches(kernels, expected, steps, dtypes):
    """Each kernel launched ``expected[name]`` times a step over ``steps``
    steps and no other, every one of those launches on operands of
    ``dtypes[name]``."""
    launches = kernels.launch_counts()
    for name, n in launches.items():
        per_step = expected.get(name, 0)
        check(n == per_step * steps,
              f"{name}: {n} launches in {steps} steps, expected "
              f"{per_step} per step")
    for (name, dt), n in kernels.launch_counts_by_dtype().items():
        check(dt == dtypes.get(name),
              f"{name}: {n} launches on {dt} operands, expected "
              f"{dtypes.get(name)} only")
    return launches


def train_phase(torch, np, cfg, build, expected, schedule=None,
                batch=TRAIN_BATCH, dtypes=None, run_first=False,
                estimate=False):
    """TRAIN_STEPS steps of ``build(cfg)``'s program through
    prepare(donate_state=True) on a ``batch`` x TRAIN_SEQ batch, dropout
    as cfg says, each kernel launched exactly ``expected`` times per step
    and no other, on operands of ``dtypes[name]`` (float32 when not
    given), the parameters float32 after the steps; the LR fetched each
    step equals ``schedule(step)`` when given.  With ``run_first`` one
    step through ``Executor.run`` comes first (bench.py's entry), its
    launches checked alike.  Then one more step under the profiler.  The
    model FLOP share is of the bf16 peak when the program casts to bf16,
    else of the float32 one.  With ``estimate`` the static memory estimate
    is printed beside the measured bytes (:func:`check_estimate`)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    dtypes = dtypes or {name: "float32" for name in expected}
    program, startup, total, lr_var = build(cfg)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                batch, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor()                       # CUDAPlace(0)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    allocated_after_startup = torch.cuda.memory_allocated()
    params = program.all_parameters()
    n_params = sum(math.prod(p.shape) for p in params)
    first = None
    if run_first:
        kernels.reset_launch_counts()
        registry.reset_route_counts()
        first = float(exe.run(program, feed=feed, fetch_list=[total],
                              scope=scope)[0])
        check(math.isfinite(first), f"Executor.run: non-finite loss {first}")
        check(not registry.route_counts("fallback"),
              f"route fallbacks in Executor.run: "
              f"{registry.route_counts('fallback')}")
        check_launches(kernels, expected, 1, dtypes)
        log(f"  one step through Executor.run: loss {first:.5f}, launches "
            f"{kernels.launch_counts()}")
    prepared = exe.prepare(program, fetch_list=[total, lr_var], scope=scope,
                           donate_state=True)
    run_ops = prepared._program.global_block().ops
    ops = [op.type for op in run_ops]
    peak_dtype = "bfloat16" if any(
        op.type == "cast" and op.attrs.get("out_dtype") == "bfloat16"
        for op in run_ops) else "float32"
    log(f"  program run: {len(ops)} ops, "
        + ", ".join(f"{ops.count(t)} {t}" for t in (
            "fused_add_layernorm", "layer_norm",
            "fused_elemwise_activation", "fused_attention", "adam",
            "adamw")))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step():
        handle, lr = prepared.run(feed)
        return float(handle), float(lr)          # waits for the step

    # the main path: counts from zero, TRAIN_STEPS steps, read right after
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, lrs, step_s = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, lr = step()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        lrs.append(lr)
    launches = kernels.launch_counts()
    by_dtype = kernels.launch_counts_by_dtype()
    routes = registry.route_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_s[2:])
    tokens = batch * TRAIN_SEQ
    flops = model_flops_per_step(cfg, batch, TRAIN_SEQ, TRAIN_MASKS)
    peak = PEAK_FLOPS[peak_dtype]
    log(f"  BERT-base pretraining ({n_params} parameters, {len(params)} "
        f"tensors), batch {batch} x {TRAIN_SEQ}, {TRAIN_MASKS} masks "
        f"per sequence, dropout {cfg.hidden_dropout_prob}/"
        f"{cfg.attention_probs_dropout_prob}")
    log(f"  losses: {[round(x, 5) for x in losses]}")
    log(f"  learning rates: {lrs}")
    log(f"  step times (s): {[round(x, 4) for x in step_s]}")
    log(f"  training step: median of steps 3-{TRAIN_STEPS} {steady * 1e3:.2f} "
        f"ms, {batch / steady:.2f} sequences/s, {tokens / steady:.1f} "
        f"tokens/s; peak device memory {peak_gib:.2f} GiB")
    log(f"  model FLOPs a step {flops / 1e12:.3f} TFLOP (bench.py's count):"
        f" {flops / steady / 1e12:.1f} TFLOP/s, "
        f"{100 * flops / steady / peak:.2f} % of the {peak_dtype} peak "
        f"{peak / 1e12:.0f} TFLOP/s")
    log(f"  launches over {TRAIN_STEPS} steps: {launches}; by dtype "
        f"{by_dtype}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    fallbacks = {k: v for k, v in routes.items() if k[2] == "fallback"}
    check(not fallbacks, f"route fallbacks on the training path: "
                         f"{fallbacks}")
    check_launches(kernels, expected, TRAIN_STEPS, dtypes)
    fluid.sync_prepared_state(scope)
    kinds = {str(scope.find_var(p.name).dtype) for p in params}
    check(kinds == {"torch.float32"}, f"parameters left float32: {kinds}")
    memory = None
    if estimate:
        est, state_in, written = memory_estimate(program, feed, total.name)
        held, predicted, _, _ = held_bytes(torch, None, scope, program)
        memory = {"estimate": {"state_bytes": est.state_bytes,
                               "peak_bytes": est.peak_bytes},
                  "state_in_held": scope_bytes(torch, scope, state_in),
                  "held": held, "predicted": predicted,
                  "left_out": left_out_bytes(torch, None, scope, program,
                                             state_in, written),
                  "allocated_after_startup": allocated_after_startup,
                  "peak_bytes": torch.cuda.max_memory_allocated()}
        check_estimate("one rank", memory)
    if schedule is not None:
        lr_err = max(abs(lr - schedule(i)) / PEAK_LR
                     for i, lr in enumerate(lrs))
        log(f"  LR vs the closed-form schedule: max |Δ| / peak {lr_err:.3e} "
            f"(tolerance {TOL_LR:.0e})")
        check(lr_err <= TOL_LR, f"the LR does not follow the schedule: {lrs}")
    profile = profile_step(torch, step, steady * 1e3)
    result = {"losses": losses, "lrs": lrs, "step_s": step_s,
              "step_ms_median_3_10": steady * 1e3,
              "sequences_per_s": batch / steady,
              "tokens_per_s": tokens / steady, "batch": batch,
              "model_tflop_per_step": flops / 1e12,
              "peak_share": flops / steady / peak, "peak_dtype": peak_dtype,
              "parameters": n_params, "peak_gib": peak_gib,
              "launches_by_dtype": {f"{n}/{dt}": c
                                    for (n, dt), c in by_dtype.items()},
              "profile": profile}
    if first is not None:
        result["executor_run_loss"] = first
    if memory is not None:
        result["memory"] = memory
    del prepared, scope
    return launches, result


def train_plain_phase(torch, np, cfg, build, expected, batch=TRAIN_BATCH,
                      tol_loss=TOL_TRAIN_LOSS, tol_grad=TOL_TRAIN_GRAD,
                      after_startup=None):
    """Dropout 0: PLAIN_STEPS steps of ``build``'s program through
    Executor.run with every kernel on (each launched ``expected`` times
    per step), and again with every kernel flag off, from the same
    startup (then ``after_startup(program, scope)`` when given); losses
    agree within ``tol_loss`` (relative) and step-1 grads within
    ``tol_grad`` of max|grad|."""
    import dataclasses
    from paddle_tpu_torch import flags, fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    program, startup, total, _ = build(cfg0)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg0,
                                batch, TRAIN_SEQ, TRAIN_MASKS)
    grad_names = [p.name + "@GRAD" for p in program.all_parameters()]

    def run(kernels_on):
        flags.set_flags({"use_flash_attention": kernels_on,
                         "use_pallas_fused": kernels_on})
        try:
            scope = fluid.Scope()
            exe = fluid.Executor()
            exe.run(startup, scope=scope)
            if after_startup is not None:
                after_startup(program, scope)
            kernels.reset_launch_counts()
            losses, grads = [], None
            for i in range(PLAIN_STEPS):
                fetch = [total] + (grad_names if i == 0 else [])
                # bf16 gradients (a pure-bf16 program's) read as float32
                out = [o.float().cpu().numpy() for o in exe.run(
                    program, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)]
                losses.append(float(out[0]))
                if i == 0:
                    grads = out[1:]
            return losses, grads, kernels.launch_counts()
        finally:
            flags.set_flags({"use_flash_attention": True,
                             "use_pallas_fused": True})

    k_losses, k_grads, k_launches = run(True)
    p_losses, p_grads, p_launches = run(False)
    check(sum(p_launches.values()) == 0, "the plain path launched a kernel")
    check(all(k_launches[n] == per_step * PLAIN_STEPS
              for n, per_step in expected.items()),
          f"the kernel path launched {k_launches}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    grad_err, worst = 0.0, ""
    for n, a, b in zip(grad_names, k_grads, p_grads):
        e = max_abs(np, a, b) / max(float(np.abs(b).max()), 1e-30)
        if e > grad_err:
            grad_err, worst = e, n
    log(f"  dropout 0, {PLAIN_STEPS} steps: losses kernels "
        f"{[round(x, 6) for x in k_losses]} vs plain "
        f"{[round(x, 6) for x in p_losses]}: max relative Δ {loss_err:.3e} "
        f"(tolerance {tol_loss:.0e}); step-1 grads: max |Δ| / "
        f"max|grad| {grad_err:.3e} at {worst} (tolerance {tol_grad:.0e})")
    check(loss_err <= tol_loss, "training loss: kernels disagree with the "
                                "plain path")
    check(grad_err <= tol_grad,
          f"step-1 grad of {worst}: kernels disagree with the plain path")
    return {"plain_losses": p_losses, "kernel_losses": k_losses,
            "loss_max_rel": loss_err, "grad_max_rel": grad_err,
            "grad_worst": worst}


# ---------------------------------------------------------------------------
# robustness and observability (tracing, telemetry, the guarded step, the
# watchdog, the drill seams), inside phases 3, 6, 8, 11, 13, 15 and 16
# ---------------------------------------------------------------------------

#: phase 8's observability legs: steps a leg, the guard step the drill
#: poisons, the watchdog drill's deadline and stall (seconds)
OBS_STEPS = 8
GUARD_POISON = 2
WATCHDOG_DEADLINE_S, WATCHDOG_STALL_S = 1.0, 3.0
TOL_GUARD_LOSS = 1e-6     # guarded steps vs the unguarded run (relative)
#: what the observability checks measured, printed on the report's
#: ``observability`` line
OBS_REPORT = {}


def sha256_of(torch, scope, names):
    """sha256 of each named scope tensor's bytes."""
    import hashlib
    return {n: hashlib.sha256(scope.find_var(n).detach().contiguous().cpu()
                              .numpy().tobytes()).hexdigest() for n in names}


def guard_activity(torch, fn):
    """(launches, device ms) of the guard's own work in one profiled call
    of ``fn`` (a guarded step): the kernels of ``guardrails.stash_probe``
    (the probe and the verdict) and ``guarded_state_out`` (the selects and
    the counters), each run inside a named range; (None, None) when the
    profiler linked no kernel to them."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch.framework import guardrails
    saved = {n: getattr(guardrails, n) for n in ("stash_probe",
                                                 "guarded_state_out")}

    def ranged(name, f):
        def g(*a, **kw):
            with record_function(name):
                return f(*a, **kw)
        return g
    for n, f in saved.items():
        setattr(guardrails, n, ranged("guard::" + n, f))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for n, f in saved.items():
            setattr(guardrails, n, f)
    n = ms = 0
    for name in saved:
        k, t = range_kernels(prof, "guard::" + name)
        n, ms = n + k, ms + t
    return (n, ms) if n else (None, None)


def adam_skip_checks(torch, cfg):
    """Phase 6: #10 with the guard's skip flag on the 158-tensor AdamW run
    — set, kernel and twin leave p, m, v and both powers bit for bit;
    unset, the kernel agrees with the twin within TOL_ADAM; the run timed
    with the flag unset (profiler device time) beside no flag."""
    from paddle_tpu_torch.ops.cuda import optimizer as O
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    randn = randn_on(torch, gen, dev)
    sizes = [math.prod(sh) for sh in bert_base_param_shapes(cfg)]

    def run_of():
        return [O.AdamTensor(
            randn(n), randn(n), randn(n, scale=0.1),
            randn(n, scale=0.01).abs(), torch.tensor([1e-4], device=dev),
            torch.tensor([0.9 ** 3], device=dev),
            torch.tensor([0.999 ** 3], device=dev), 0.9, 0.999, 1e-8,
            WEIGHT_DECAY) for n in sizes]

    def state(run):
        return [t.clone() for e in run for t in (e.p, e.m, e.v, e.beta1_pow,
                                                  e.beta2_pow)]

    one = torch.ones(1, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    run = run_of()
    twin = [O.AdamTensor(*[t.clone() if torch.is_tensor(t) else t
                           for t in e]) for e in run]
    before = state(run)
    O.adam_multi(run, skip=one)
    O.adam_multi_plain(twin, skip=one)
    kept = all(torch.equal(a, b) for a, b in zip(state(run), before)) and \
        all(torch.equal(a, b) for a, b in zip(state(twin), before))
    log(f"  #10 skip flag set, all {len(sizes)} BERT-base parameters: p, "
        f"m, v and both powers bit for bit, kernel and twin: {kept}")
    check(kept, "#10: a set skip flag let the kernel or its twin write")
    O.adam_multi(run, skip=zero)
    O.adam_multi_plain(twin, skip=zero)
    err = max(max_err(torch, a[i], b[i]) for a, b in zip(run, twin)
              for i in (0, 2, 3))
    powers = all(torch.equal(a.beta1_pow, b.beta1_pow) and
                 torch.equal(a.beta2_pow, b.beta2_pow)
                 for a, b in zip(run, twin))
    log(f"  #10 skip flag unset: kernel vs twin max|Δ| {err:.3e} "
        f"(tolerance {TOL_ADAM:.0e}), powers bit for bit {powers}")
    check(err <= TOL_ADAM and powers,
          "#10 with the skip flag unset disagrees with its twin")
    flag_ms = sum(kernel_split_ms(torch, lambda: O.adam_multi(
        run, skip=zero)).values())
    none_ms = sum(kernel_split_ms(torch, lambda: O.adam_multi(run))
                  .values())
    log(f"  #10 all {len(sizes)} parameters, adamw: {flag_ms:.4f} ms with "
        f"the skip flag unset, {none_ms:.4f} ms without a flag (profiler "
        f"device time)")
    OBS_REPORT["adam_skip_flag"] = {"kept": kept, "unset_max_abs": err,
                                    "flag_unset_ms": flag_ms,
                                    "no_flag_ms": none_ms}


def observe_phase(torch, np, cfg):
    """Phase 8's observability legs on its program at dropout 0:
    (i) OBS_STEPS steps with tracing and a TelemetryRecorder off, then
    OBS_STEPS on; (ii) a fresh run under ``guard_nonfinite`` with
    ``grad_nonfinite`` armed at guard step GUARD_POISON; (iii) the
    watchdog drill on it."""
    import dataclasses
    from paddle_tpu_torch import flags, fluid, observability as obs
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.cuda import build
    from paddle_tpu_torch.testing import faultline
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    compiled, startup, total, _ = build_fused_train(cfg0)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg0,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flight_dir = os.path.join(build.BUILD_DIR, "smoke_flight")
    shutil.rmtree(flight_dir, ignore_errors=True)
    flags.set_flags({"flight_dump_dir": flight_dir})

    def fresh(guard):
        flags.set_flags({"guard_nonfinite": guard})
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        return scope, exe.prepare(compiled, fetch_list=[total],
                                  scope=scope, donate_state=True)

    def steps(prepared, n, rec=None):
        losses, walls = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            if rec is None:
                losses.append(float(prepared.run(feed)[0]))
            else:
                with rec.step(tokens=tokens) as st:
                    st.loss = prepared.run(feed)[0]
                losses.append(st.record["loss"])
            walls.append(time.perf_counter() - t0)
        return losses, walls

    report = {}
    try:
        # (i) telemetry off, then on, on one prepared step
        scope, prepared = fresh(False)
        program = prepared._program
        unguarded, off_s = steps(prepared, OBS_STEPS)
        path = os.path.join(build.BUILD_DIR, "smoke_telemetry.jsonl")
        if os.path.exists(path):
            os.remove(path)
        t0 = time.perf_counter()
        rec = obs.TelemetryRecorder(path, program=program, feed_shapes=feed,
                                    fetch_names=[total.name],
                                    tokens_per_step=tokens).attach(prepared)
        header_s = time.perf_counter() - t0
        obs.tracing.clear_events()
        obs.tracing.enable()
        try:
            _, on_s = steps(prepared, OBS_STEPS, rec)
        finally:
            obs.tracing.disable()
            rec.close()
        spans = len(obs.tracing.get_events())
        obs.tracing.clear_events()
        facts = obs.validate_jsonl(path)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        os.remove(path)
        head = recs[0]
        rows = [r for r in recs if r["record"] == "step"]
        mfus = [r["mfu"] for r in rows]
        off_ms = statistics.median(off_s[2:]) * 1e3
        on_ms = statistics.median(on_s[2:]) * 1e3
        headroom = [r.get("hbm_headroom_bytes") for r in rows]
        log(f"  (i) telemetry: median of steps 3-{OBS_STEPS} {off_ms:.2f} "
            f"ms off, {on_ms:.2f} ms with tracing and the recorder on "
            f"({spans} spans); the header priced in {header_s:.2f} s: "
            f"{head['static']['flops_per_step'] / 1e12:.4f} TFLOP a step "
            f"(GEMMs, op specs), peak {head['peak_flops'] / 1e12:.0f} "
            f"TFLOP/s for {head['peak_dtype']} on "
            f"{head['device']['device_kind']}; MFU a step "
            f"{[round(x, 4) for x in mfus]}, goodput "
            f"{[r['goodput'] for r in rows]}, HBM headroom "
            f"{headroom[-1]} B (card less the static peak "
            f"{head['static'].get('peak_hbm_bytes')} B)")
        check(facts["steps"] == OBS_STEPS and
              all(m is not None and 0 < m <= 1 for m in mfus),
              f"telemetry: MFU out of (0, 1]: {mfus}")
        check(headroom[-1] is not None, "telemetry: no HBM headroom")
        report["telemetry"] = {
            "step_ms_off": off_ms, "step_ms_on": on_ms, "spans": spans,
            "header_s": header_s, "mfu": mfus,
            "mfu_median": statistics.median(mfus[2:]),
            "peak_flops": head["peak_flops"],
            "peak_dtype": head["peak_dtype"],
            "flops_per_step": head["static"]["flops_per_step"],
            "goodput": [r["goodput"] for r in rows],
            "hbm_headroom_bytes": headroom[-1],
            "peak_hbm_estimate": head["static"].get("peak_hbm_bytes")}
        del prepared, scope
        torch.cuda.empty_cache()

        # (ii) the guarded step, the drill at guard step GUARD_POISON
        scope, prepared = fresh(True)
        names = [v.name for v in program.list_vars() if v.persistable and
                 (v.name in {p.name for p in program.all_parameters()} or
                  "moment" in v.name)]
        kernels.reset_launch_counts()
        faultline.arm("grad_nonfinite", action="nan", step=GUARD_POISON,
                      times=1)
        guarded, g_s, trace = [], [], []
        try:
            for i in range(OBS_STEPS):
                if i == GUARD_POISON:
                    fluid.sync_prepared_state(scope)
                    before = sha256_of(torch, scope, names)
                t0 = time.perf_counter()
                guarded.append(float(prepared.run(feed)[0]))
                g_s.append(time.perf_counter() - t0)
                if i == GUARD_POISON:
                    # armed, the seam reads the guard's step count on the
                    # host (a wait mid-step): disarmed for the timed steps
                    faultline.disarm()
                    fluid.sync_prepared_state(scope)
                    after = sha256_of(torch, scope, names)
                trace.append(prepared.guard_info(sync=True)
                             ["skipped_total"])
        finally:
            faultline.disarm()
        launches = kernels.launch_counts()
        info = prepared.guard_info(sync=True)
        kept = before == after
        # the skipped step recomputes step GUARD_POISON's loss from the
        # same state; each later step is the unguarded run's one before
        want = unguarded[:GUARD_POISON + 1] + \
            unguarded[GUARD_POISON:OBS_STEPS - 1]
        gap = max(abs(a - b) / abs(b) for a, b in zip(guarded, want))
        g_ms = statistics.median(g_s[GUARD_POISON + 2:]) * 1e3
        added = guard_activity(torch, lambda: float(prepared.run(feed)[0]))
        log(f"  (ii) guarded, NaN in a gradient at guard step "
            f"{GUARD_POISON}: skip total {info['skipped_total']} (after "
            f"each step {trace}); {len(names)} parameters and moments "
            f"sha256-equal across the skipped step: {kept}; losses vs the "
            f"unguarded run's max relative Δ {gap:.3e} (tolerance "
            f"{TOL_GUARD_LOSS:.0e}); launches {launches}")
        log(f"  the guard adds {added[0]} launches and "
            f"{added[1] if added[1] is None else round(added[1], 4)} "
            f"device ms a step (one profiled step, its probe and gate in "
            f"named ranges); guarded step {g_ms:.2f} ms (median of steps "
            f"{GUARD_POISON + 3}-{OBS_STEPS}, unarmed) against "
            f"{off_ms:.2f} ms unguarded")
        check(kept, "guard: the skipped step changed a parameter or moment")
        check(info["skipped_total"] == 1 and info["consecutive"] == 0,
              f"guard: skip counters {info}")
        check(gap <= TOL_GUARD_LOSS, f"guard: losses {guarded} vs the "
                                     f"unguarded {unguarded}")
        for name, per in FUSED_LAUNCHES.items():
            check(launches[name] == per * OBS_STEPS,
                  f"guard: {name} launched {launches[name]} times in "
                  f"{OBS_STEPS} steps, expected {per} a step")
        report["guard"] = {"skipped_total": info["skipped_total"],
                           "skip_trace": trace, "sha256_equal": kept,
                           "loss_max_rel": gap, "added_launches": added[0],
                           "added_device_ms": added[1],
                           "step_ms_guarded": g_ms,
                           "step_ms_unguarded": off_ms}

        # (iii) the watchdog: a stalled step trips it once, healthy ones
        # do not
        flags.set_flags({"step_deadline_s": WATCHDOG_DEADLINE_S})
        obs.watchdog.ensure_started()
        base = len(obs.watchdog.trips())
        counter = obs.metrics.counter("watchdog::trip", beacon="prepared")
        c0 = counter.get()
        faultline.arm("step_stall", action="stall",
                      seconds=WATCHDOG_STALL_S, times=1)
        try:
            float(prepared.run(feed)[0])
        finally:
            faultline.disarm()
        for _ in range(3):
            float(prepared.run(feed)[0])
        time.sleep(1.5 * WATCHDOG_DEADLINE_S)
        trips = obs.watchdog.trips()[base:]
        bundle = obs.flight.validate_bundle(trips[0]["bundle"]) \
            if trips and trips[0]["bundle"] else None
        stacks = len(bundle["extra"]["thread_stacks"]) if bundle else 0
        log(f"  (iii) watchdog, deadline {WATCHDOG_DEADLINE_S} s, a "
            f"{WATCHDOG_STALL_S} s stall then 3 healthy steps: "
            f"{len(trips)} trip(s) "
            f"{[(t['beacon'], round(t['stalled_s'], 2)) for t in trips]}, "
            f"{stacks} thread stacks in the bundle, watchdog::trip "
            f"{counter.get() - c0}")
        check(len(trips) == 1 and trips[0]["beacon"] == "prepared" and
              stacks >= 1 and counter.get() - c0 == 1,
              f"watchdog: trips {trips}")
        report["watchdog"] = {"trips": len(trips), "stacks": stacks,
                              "stalled_s": trips[0]["stalled_s"]}
        del prepared, scope
    finally:
        flags.set_flags({"guard_nonfinite": False, "step_deadline_s": 0.0})
        shutil.rmtree(flight_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    OBS_REPORT["phase8"] = report
    return report


def traced_burst(engine, burst):
    """Phase 3: one more burst through the served engine with tracing on:
    each micro-batch's pad / run / split spans share its step id, and
    ``profiler.serving_stats()`` reports what ``stats()`` reports."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import tracing
    before = engine.stats()["batches"]
    tracing.clear_events()
    tracing.enable()
    try:
        for f in [engine.submit(r) for r in burst]:
            f.result(timeout=600)
        engine.drain(timeout=600)
    finally:
        tracing.disable()
    stats = engine.stats()
    by_sid = {}
    names = set()
    for name, _, _, _, attrs in tracing.get_events():
        names.add(name)
        if name in ("serving::pad", "serving::run", "serving::split"):
            by_sid.setdefault(attrs["step_id"], []).append(name)
    tracing.clear_events()
    batches = stats["batches"] - before
    whole = sum(sorted(v) == ["serving::pad", "serving::run",
                              "serving::split"] for v in by_sid.values())
    listed = stats in profiler.serving_stats()
    log(f"  traced burst of {len(burst)}: {batches} micro-batches, {whole} "
        f"step ids each on one batch's pad / run / split spans; span "
        f"names {sorted(names)}; serving_stats() lists stats(): {listed}")
    check(whole == batches == len(by_sid),
          f"serving spans by step id: {by_sid}")
    check(listed, "profiler.serving_stats() does not report the engine")
    OBS_REPORT["phase3"] = {"batches": batches, "span_names": sorted(names)}


def traced_decode(engine, prompts, untraced):
    """Phase 11: the 16 requests again with tracing on: one
    ``decode::prefill`` / ``chunk`` / ``chain`` span each of the engine's
    prefills, chunks and chains, each on a step id of its own, the
    ``decode::*`` gauges set, and the tokens those of the untraced run."""
    from paddle_tpu_torch.observability import metrics, tracing
    before = engine.stats()
    tracing.clear_events()
    tracing.enable()
    try:
        res, _, wall = drive_decode(engine, prompts,
                                    decode_budgets(len(prompts)))
        engine.drain()
    finally:
        tracing.disable()
    after = engine.stats()
    spans, sids = {}, set()
    for name, _, _, _, attrs in tracing.get_events():
        if name.startswith("decode::"):
            spans[name] = spans.get(name, 0) + 1
            sids.add(attrs["step_id"])
    tracing.clear_events()
    want = {"decode::prefill": "prefill_batches",
            "decode::chunk": "chunk_steps", "decode::chain": "chains_run"}
    want = {k: after[v] - before[v] for k, v in want.items()
            if after[v] - before[v]}
    same = all(a.tokens.tolist() == b.tokens.tolist()
               for a, b in zip(res, untraced))
    gauges = {m["name"]: m["value"] for m in metrics.metrics_snapshot(
        include_serving=False)["metrics"] if m["name"].startswith(
            "decode::")}
    log(f"  traced run of the {len(prompts)} requests ({wall:.3f} s): spans "
        f"{spans} (the engine counted {want}), {len(sids)} step ids; tokens "
        f"those of the untraced run: {same}; gauges {gauges}")
    check(spans == want and len(sids) == sum(spans.values()),
          f"decode spans {spans}, the engine counted {want}")
    check(same, "decode: the traced run's tokens differ from the untraced")
    check({"decode::cache_blocks_used", "decode::active_seqs",
           "decode::prefix_cache_hits"} <= set(gauges),
          f"decode gauges {gauges}")
    OBS_REPORT["phase11"] = {"spans": spans, "gauges": gauges,
                             "tokens_equal": same}


def zero_guard_drill(torch, np, exe, program, main, scope, total, feed):
    """Phase 15 (f): the restored program's steps under
    ``guard_nonfinite``, a NaN gradient on rank 1 only at guard step 1:
    each rank's skip total after each step, its persistables' digests
    across the skipped step, and its replicated digest after."""
    from paddle_tpu_torch import flags, fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.testing import faultline
    flags.set_flags({"guard_nonfinite": True})
    fluid.sync_prepared_state(scope)
    try:
        prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                               donate_state=True)
        if fleet.worker_index() == 1:
            faultline.arm("grad_nonfinite", action="nan", step=1, times=1)
        trace, losses = [], []
        for i in range(3):
            if i == 1:
                fluid.sync_prepared_state(scope)
                before = state_digests(np, scope, main)
            losses.append(float(prepared.run(feed)[0]))
            trace.append(prepared.guard_info(sync=True)["skipped_total"])
            if i == 1:
                fluid.sync_prepared_state(scope)
                kept = state_digests(np, scope, main) == before
    finally:
        faultline.disarm()
        flags.set_flags({"guard_nonfinite": False})
    fluid.sync_prepared_state(scope)
    return {"skip_trace": trace, "kept": kept, "losses": losses,
            "replicated_sha256": replicated_digest(np, program._dp, scope,
                                                   main)}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 12: bf16 mixed-precision pretraining at BERT-base width
# ---------------------------------------------------------------------------


def model_flops_per_step(cfg, batch, seq, num_masks):
    """bench.py's analytic count of one step's matrix-product FLOPs (2 a
    multiply-add; the backward twice the forward): the encoder's
    projections and FFN, attention's two S^2 products, the masked-LM and
    pooler heads."""
    d, ff = cfg.hidden_size, cfg.intermediate_size
    tokens = batch * seq
    per_layer = 2 * tokens * (d * 3 * d + d * d + 2 * d * ff)
    attn = 2 * batch * cfg.num_attention_heads * seq * seq * \
        (d // cfg.num_attention_heads) * 2
    heads = 2 * (batch * num_masks) * d * cfg.vocab_size + 2 * batch * d * d
    return 3 * (cfg.num_hidden_layers * (per_layer + attn) + heads)


def amp_dtypes(expected, half="bfloat16"):
    """The operand dtype of each kernel of the bf16 (float16) program: the
    flash kernels take the 16-bit Q, K, V; LayerNorm (black list),
    bias+GELU (its inputs cast back) and Adam (float32 master weights)
    stay float32."""
    return {name: half if name.startswith("flash_attention")
            else "float32" for name in expected}


def bench_style_ms(torch, np, cfg, build, batch):
    """bench.py's timing of its headline configuration, on the port:
    ``build(cfg)``'s program from its startup on a ``batch`` x TRAIN_SEQ
    batch, one synced ``Executor.run``, then AMP_BENCH_STEPS runs with the
    feeds on the card and the fetches left there, one sync at the end."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    program, startup, total, _ = build(cfg)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg, batch,
                                TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor()                       # CUDAPlace(0)
    exe.run(startup, scope=scope)
    feed_dev = {k: torch.as_tensor(v, device=exe.device)
                for k, v in feed.items()}
    loss = float(exe.run(program, feed=feed_dev, fetch_list=[total],
                         scope=scope)[0])
    check(math.isfinite(loss), f"bench-style warm-up loss {loss}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(AMP_BENCH_STEPS):
        out, = exe.run(program, feed=feed_dev, fetch_list=[total],
                       scope=scope, return_numpy=False)
    last = float(out)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / AMP_BENCH_STEPS
    check(math.isfinite(last), f"bench-style loss {last}")
    del scope
    log(f"  bench.py's measure ({AMP_BENCH_STEPS} Executor.run steps, "
        f"device-resident feeds and fetches, one sync): {dt * 1e3:.2f} ms "
        f"a step, {batch / dt:.2f} samples/s")
    return {"bench_style_step_ms": dt * 1e3,
            "bench_style_samples_per_s": batch / dt}


def scale_replay(np, bad_steps, steps, scale, incr_every, decr_every, incr,
                 decr):
    """The dynamic loss-scale policy on the host, one step at a time:
    (scale, good, bad) after each step, the scale in float32."""
    good = bad = 0
    scale = np.float32(scale)
    out = []
    for i in range(steps):
        if i + 1 in bad_steps:
            good, bad = 0, bad + 1
        else:
            good, bad = good + 1, 0
        if good >= incr_every:
            scale, good = np.float32(scale * np.float32(incr)), 0
        elif bad >= decr_every:
            scale = max(np.float32(scale * np.float32(decr)), np.float32(1.0))
            bad = 0
        out.append((float(scale), good, bad))
    return out


def build_amp_mlp(fluid):
    """tests/test_amp.py's two-layer MLP under fp16 ``decorate(SGD(0.1))``
    with a fast policy (grow after 3 good steps, back off after 2 bad)."""
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.framework import unique_name
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        const = fluid.initializer.Constant(0.02)
        h = fluid.layers.fc(x, 32, act="relu", bias_attr=False,
                            param_attr=fluid.ParamAttr(name="w1",
                                                       initializer=const))
        logits = fluid.layers.fc(h, 4, bias_attr=False,
                                 param_attr=fluid.ParamAttr(
                                     name="w2", initializer=const))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        decorate(fluid.optimizer.SGD(0.1), use_pure_bf16=False,
                 incr_every_n_steps=AMP_INCR_EVERY,
                 decr_every_n_nan_or_inf=AMP_DECR_EVERY).minimize(loss)
    return main, startup, loss


def fp16_scaling_leg(torch, np):
    """Leg (c), first part: fp16 loss scaling on the card.  The MLP trains
    AMP_FP16_STEPS steps through prepare(donate_state=True) on feeds
    already on the card, steps AMP_INF_STEPS carrying an inf; steps after
    the first run with host syncs made errors.  Those steps' gradients
    are zeroed and the weights stay; scale and counters equal the host
    replay every step."""
    from paddle_tpu_torch import fluid
    main, startup, loss = build_amp_mlp(fluid)
    state = ["loss_scaling_0", "good_steps_0", "bad_steps_0"]
    scope = fluid.Scope()
    exe = fluid.Executor()
    dev = exe.device
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    xs = rng.randn(16, 16).astype(np.float32)
    ys = rng.randint(0, 4, (16, 1)).astype(np.int64)
    feeds = []
    for i in range(AMP_FP16_STEPS):
        x = xs.copy()
        if i + 1 in AMP_INF_STEPS:
            x[3, 5] = np.inf
        feeds.append({"x": torch.from_numpy(x).to(dev),
                      "label": torch.from_numpy(ys).to(dev)})
    step = exe.prepare(main, fetch_list=[loss, "w2@GRAD", "w2"] + state,
                       scope=scope, donate_state=True)
    replay = scale_replay(np, AMP_INF_STEPS, AMP_FP16_STEPS, 2.0 ** 15,
                          AMP_INCR_EVERY, AMP_DECR_EVERY, 2.0, 0.8)
    w_before = scope.find_var("w2").cpu().numpy().copy()
    got = []
    for i, f in enumerate(feeds):
        torch.cuda.synchronize()
        if i:
            torch.cuda.set_sync_debug_mode("error")
        try:
            handles = step.run(f)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        l, g, w, sc, good, bad = (h.numpy() for h in handles)
        got.append((float(sc[0]), int(good[0]), int(bad[0])))
        if i + 1 in AMP_INF_STEPS:
            check(not np.isfinite(l).all(), f"step {i + 1}: finite loss")
            check(not g.any(), f"step {i + 1}: gradients not zeroed")
            check(np.array_equal(w, w_before),
                  f"step {i + 1}: the weights moved on an overflow")
        else:
            check(np.isfinite(l).all() and g.any(),
                  f"step {i + 1}: loss {l}, gradient all zero")
            check(not np.array_equal(w, w_before),
                  f"step {i + 1}: the weights did not move")
        w_before = w.copy()
    log(f"  fp16 MLP, {AMP_FP16_STEPS} steps, inf at steps "
        f"{list(AMP_INF_STEPS)}: (scale, good, bad) {got}; host replay "
        f"{replay}")
    check(got == replay, "the loss-scale state differs from the replay")
    check(got[AMP_INF_STEPS[-1] - 1][0] == float(
        np.float32(np.float32(2.0 ** 16) * np.float32(0.8))),
          "the scale did not back off once by 0.8")
    del step, scope
    return {"fp16_scale_state": got}


def fp16_bert_leg(torch, np, cfg):
    """BERT-base under fp16 ``decorate(Adam(1e-4), use_pure_bf16=False)``
    with dynamic loss scaling, TRAIN_BATCH x TRAIN_SEQ, AMP_FP16_BERT_STEPS
    prepared steps: the losses finite, no route fallback, 12/12/12 flash
    launches a step on float16 operands (LayerNorm and Adam on float32);
    then, dropout 0, kernels on vs every flag off within TOL_AMP_PLAIN
    (losses) and TOL_AMP_GRAD (step-1 gradients)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry

    def build(c):
        return build_train(c, amp=True, pure_bf16=False)
    program, startup, total, _ = build(cfg)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    state = ["loss_scaling_0", "good_steps_0", "bad_steps_0"]
    prepared = exe.prepare(program, fetch_list=[total] + state, scope=scope,
                           donate_state=True)
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    steps = []
    for _ in range(AMP_FP16_BERT_STEPS):
        loss, sc, good, bad = (h.numpy() for h in prepared.run(feed))
        steps.append((float(loss), float(sc[0]), int(good[0]), int(bad[0])))
    launches = kernels.launch_counts()
    log(f"  fp16 BERT-base, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{AMP_FP16_BERT_STEPS} prepared steps: (loss, scale, good, bad) "
        f"{steps}; launches {kernels.launch_counts_by_dtype()}")
    check(all(math.isfinite(x[0]) for x in steps),
          f"fp16 BERT-base: non-finite loss {steps}")
    fallbacks = {k: v for k, v in registry.route_counts().items()
                 if k[2] == "fallback"}
    check(not fallbacks, f"fp16 BERT-base: route fallbacks {fallbacks}")
    check_launches(kernels, TRAIN_LAUNCHES, AMP_FP16_BERT_STEPS,
                   amp_dtypes(TRAIN_LAUNCHES, "float16"))
    del prepared, scope
    plain = train_plain_phase(torch, np, cfg, build, TRAIN_LAUNCHES,
                              tol_loss=TOL_AMP_PLAIN, tol_grad=TOL_AMP_GRAD)
    return {"steps": steps, "launches": launches, **plain}


def pure_bf16_leg(torch, np, cfg):
    """Leg (d): BERT-base under ``decorate(Adam(1e-4),
    use_pure_bf16=True)`` with its parameters cast to bf16 after the
    startup (``cast_parameters_to_bf16``; the moments stay float32),
    TRAIN_BATCH x TRAIN_SEQ, AMP_PURE_BF16_STEPS prepared steps: finite
    losses, no route fallback, the flash kernels and #10 launched on bf16
    (one launch a step for the 158 updates), the LayerNorms on float32,
    the parameters still bf16; then, dropout 0, kernels on vs every flag
    off within TOL_AMP_PLAIN and TOL_AMP_GRAD."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib.mixed_precision.fp16_utils import \
        cast_parameters_to_bf16
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry

    def build(c):
        return build_train(c, amp=True)
    program, startup, total, _ = build(cfg)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    cast_parameters_to_bf16(program, scope)
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses = [float(prepared.run(feed)[0])
              for _ in range(AMP_PURE_BF16_STEPS)]
    launches = kernels.launch_counts()
    log(f"  pure bf16 BERT-base, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{AMP_PURE_BF16_STEPS} prepared steps: losses "
        f"{[round(x, 5) for x in losses]}; launches "
        f"{kernels.launch_counts_by_dtype()}")
    check(all(math.isfinite(x) for x in losses),
          f"pure bf16 BERT-base: non-finite loss {losses}")
    fallbacks = {k: v for k, v in registry.route_counts().items()
                 if k[2] == "fallback"}
    check(not fallbacks, f"pure bf16 BERT-base: route fallbacks {fallbacks}")
    # every launch on its dtype: the embeddings' sum is bf16 once its
    # tables are, so the embedding LayerNorm (no cast before it in the
    # rewrite) runs on bf16 like the JAX package's; the other 25 on float32
    per_step = {(n, dt): c for n, dt, c in PURE_BF16_LAUNCHES}
    got = kernels.launch_counts_by_dtype()
    check(got == {k: c * AMP_PURE_BF16_STEPS for k, c in per_step.items()},
          f"pure bf16 BERT-base: launches {got}, expected {per_step} a "
          f"step")
    fluid.sync_prepared_state(scope)
    kinds = {str(scope.find_var(p.name).dtype)
             for p in program.all_parameters()}
    check(kinds == {"torch.bfloat16"}, f"parameters left bf16: {kinds}")
    del prepared, scope
    plain = train_plain_phase(
        torch, np, cfg, build, TRAIN_LAUNCHES, tol_loss=TOL_AMP_PLAIN,
        tol_grad=TOL_AMP_GRAD,
        after_startup=lambda prog, sc: cast_parameters_to_bf16(prog, sc))
    return {"losses": losses, "launches": launches,
            "launches_by_dtype": {f"{n}/{dt}": c
                                  for (n, dt), c in got.items()},
            **plain}


def bf16_bias_check(torch):
    """BERT's padding bias ``mask * 1e4 - 1e4`` through the port's
    ``scale`` op on a bf16 tensor on the card: 0 and -9984 exactly, as the
    JAX package's weak-typed scalars give (a float32 scalar met in float32
    arithmetic would leave -16 where the mask keeps a key)."""
    from paddle_tpu_torch.ops import registry
    mask = torch.tensor([[0.0, 1.0, 1.0, 0.0]], dtype=torch.bfloat16,
                        device="cuda")
    out = registry.get_op("scale")(registry.LoweringContext(
        device=mask.device), {"X": [mask]}, {"scale": 1e4, "bias": -1e4})
    got = out["Out"].float().cpu().tolist()[0]
    log(f"  bf16 padding bias on the card: {got}")
    check(got == [-9984.0, 0.0, 0.0, -9984.0],
          f"bf16 padding bias {got}, expected 0 and -9984")


def amp_kernel_rows(torch, per_kernel):
    """#1 and the #2 + #3 pair in bf16 and in float16 at leg (a)'s shape,
    as phase 6 times them: kernel, twin, SDPA / the library's backward at
    the same dropout, bounds."""
    log(f"  #1 and the #2 + #3 pair in bf16 and float16 at the main-path "
        f"shape (B{AMP_BATCH} H12 S{TRAIN_SEQ} D64, padding bias, dropout "
        f"{DROPOUT})")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    seed = torch.tensor([SEED + 12], dtype=torch.int32, device=dev)
    for dtname in ("bfloat16", "float16"):
        flash_training_rows(torch, per_kernel, gen, seed, dtname, AMP_BATCH,
                            TRAIN_SEQ, ("padding-bias",))


def amp_phase(torch, np, cfg, per_kernel, fused_step_ms):
    """Phase 12's four legs; returns (launches of leg (a)'s prepared
    steps, of leg (b)'s, of leg (c)'s fp16 BERT-base steps, of leg (d)'s
    pure-bf16 steps, the report)."""
    log(f"  (a) bench.py's configuration: decorate(Adam({PEAK_LR}), "
        f"use_pure_bf16=True), batch {AMP_BATCH} x {TRAIN_SEQ}, "
        f"{TRAIN_MASKS} masks, dropout {DROPOUT}")
    expected = TRAIN_LAUNCHES

    def build(c):
        return build_train(c, amp=True)
    launches, report = train_phase(
        torch, np, cfg, build, expected, batch=AMP_BATCH,
        dtypes=amp_dtypes(expected), run_first=True)
    report.update(bench_style_ms(torch, np, cfg, build, AMP_BATCH))
    log(f"  (a) prepared step {report['step_ms_median_3_10']:.2f} ms "
        f"({report['sequences_per_s']:.1f} samples/s), bench.py's measure "
        f"{report['bench_style_step_ms']:.2f} ms "
        f"({report['bench_style_samples_per_s']:.1f} samples/s); "
        f"{100 * report['peak_share']:.2f} % of the "
        f"{report['peak_dtype']} peak")
    bf16_bias_check(torch)
    report.update(train_plain_phase(
        torch, np, cfg, build, expected, batch=AMP_BATCH,
        tol_loss=TOL_AMP_PLAIN, tol_grad=TOL_AMP_GRAD))
    log(f"  (b) the published recipe in bf16: phase 8's program with the "
        f"optimizer under decorate, batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    fused_launches, fused = train_phase(
        torch, np, cfg, lambda c: build_fused_train(c, amp=True),
        FUSED_LAUNCHES, schedule=scheduled_lr,
        dtypes=amp_dtypes(FUSED_LAUNCHES))
    log(f"  (b) step {fused['step_ms_median_3_10']:.2f} ms in bf16 beside "
        f"phase 8's {fused_step_ms:.2f} ms in float32 (this run)")
    log("  (c) fp16 loss scaling on the card, then BERT-base in fp16")
    scaling = fp16_scaling_leg(torch, np)
    fp16_bert = fp16_bert_leg(torch, np, cfg)
    amp_kernel_rows(torch, per_kernel)
    log("  (d) pure bf16: decorate(Adam) and cast_parameters_to_bf16, #10 "
        "on bf16 parameters")
    pure = pure_bf16_leg(torch, np, cfg)
    return launches, fused_launches, fp16_bert["launches"], \
        pure["launches"], {
            "bench_config": report, "recipe_bf16": fused,
            "recipe_fp32_step_ms": fused_step_ms, "fp16_scaling": scaling,
            "fp16_bert": fp16_bert, "pure_bf16": pure}


# ---------------------------------------------------------------------------
# phase 13: LAMB pretraining, checkpoint and resume
# ---------------------------------------------------------------------------


def persistable_state(torch, scope, program):
    """Every persistable of ``program`` in ``scope``, cloned on the card."""
    from paddle_tpu_torch import fluid
    fluid.sync_prepared_state(scope)
    return {v.name: scope.find_var(v.name).detach().clone()
            for v in program.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def restore_point(torch, scope, program):
    """What a resume must restore: every persistable of ``program`` and the
    scope's generator states (``get_state()`` bytes), cloned."""
    from paddle_tpu_torch.framework.executor import _RNG_VAR
    state = persistable_state(torch, scope, program)
    state.update({n: g.get_state() for n, g in scope.vars.items()
                  if n.startswith(_RNG_VAR) and
                  isinstance(g, torch.Generator)})
    return state


def run_distance(torch, a, b):
    """How far run ``a`` lies from ``b``: (the norm of the difference of
    their states over every persistable, relative to ``b``'s, max |Δ loss|
    over the steps both ran, max |Δ| over every persistable, the
    persistable where it is largest)."""
    losses = max((abs(x - y) for x, y in zip(a["losses"], b["losses"])),
                 default=0.0)
    worst, where, num, den = 0.0, "", 0.0, 0.0
    for n, t in a["state"].items():
        d = t.double() - b["state"][n].double()
        num += float((d * d).sum())
        den += float((b["state"][n].double() ** 2).sum())
        e = float(d.abs().max())
        if e > worst:
            worst, where = e, n
    return math.sqrt(num / max(den, 1e-300)), losses, worst, where


def lamb_run(torch, np, cfg, ckpt_dir, save_at=None, resume=False,
             profile=False):
    """TRAIN_STEPS steps of phase 13's program through
    prepare(donate_state=True) from the seed; with ``save_at`` a
    save_checkpoint after that step (the run goes on), with ``resume`` a
    new scope and executor, the startup, load_checkpoint and the steps
    after the checkpoint's.  Returns the losses, the state after the last
    step, the step times, the launches of the steps and the save / load
    seconds."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    compiled, startup, total, lr_var = build_fused_train(cfg, lamb=True)
    program = compiled._program
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor()                       # CUDAPlace(0)
    exe.run(startup, scope=scope)
    out = {"first_step": 1}
    if resume:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = fluid.io.load_checkpoint(exe, ckpt_dir, main_program=program,
                                      scope=scope)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        check(st.step == LAMB_SAVE_AT and not st.skipped_checkpoints,
              f"load_checkpoint: step {st.step}, skipped "
              f"{st.skipped_checkpoints}")
        out["first_step"] = st.step + 1
        out["restored"] = restore_point(torch, scope, program)
    prepared = exe.prepare(compiled, fetch_list=[total, lr_var],
                           scope=scope, donate_state=True)
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, step_s = [], []
    for i in range(out["first_step"], TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        loss, lr = (float(h) for h in prepared.run(feed))
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        check(abs(lr - scheduled_lr(i - 1)) <= TOL_LR * PEAK_LR,
              f"step {i}: LR {lr}, the schedule says {scheduled_lr(i - 1)}")
        if i == save_at:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fluid.io.save_checkpoint(exe, ckpt_dir,
                                     fluid.io.TrainStatus(0, i), program,
                                     scope=scope)
            out["save_s"] = time.perf_counter() - t0
            out["saved"] = restore_point(torch, scope, program)
    out.update(losses=losses, step_s=step_s,
               launches=kernels.launch_counts(),
               by_dtype=kernels.launch_counts_by_dtype(),
               routes=registry.route_counts(),
               state=persistable_state(torch, scope, program))
    out["state_bytes"] = sum(t.numel() * t.element_size()
                             for t in out["state"].values())
    if profile:
        # one more step, LAMB's group of ops under a named range
        group = registry.GROUPS["lamb"]

        def traced(ctx, items):
            with torch.profiler.record_function("lamb_update"):
                return group(ctx, items)
        registry.GROUPS["lamb"] = traced
        try:
            steady = statistics.median(step_s[2:]) * 1e3
            out["profile"] = profile_step(
                torch, lambda: float(prepared.run(feed)[0]), steady,
                ranges=("lamb_update",))
        finally:
            registry.GROUPS["lamb"] = group
    del prepared, scope
    return out


def lamb_phase(torch, np, cfg, ckpt_dir):
    """Phase 13: LAMB pretraining, checkpoint and resume (see the module
    docstring); returns (the launches of run A's steps, the report)."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.testing import faultline
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    retries = metrics.counter("checkpoint::retry", stage="params")
    r0 = retries.get()
    # run A's save: the params file corrupted once between its write and
    # its readback; the retry writes it again, and C restores from it
    faultline.arm("checkpoint_write", action="corrupt_file",
                  match={"stage": "params"}, times=1)
    try:
        a = lamb_run(torch, np, cfg, ckpt_dir, save_at=LAMB_SAVE_AT)
    finally:
        faultline.disarm()
    retried = retries.get() - r0
    log(f"  run A's save_checkpoint with its params file corrupted once "
        f"after the write: checkpoint::retry{{stage=params}} {retried}")
    check(retried == 1, f"checkpoint::retry read {retried}, not 1")
    OBS_REPORT["phase13"] = {"checkpoint_retry": retried}
    b = lamb_run(torch, np, cfg, ckpt_dir, profile=True)
    c = lamb_run(torch, np, cfg, ckpt_dir, resume=True)
    expected = {k: v for k, v in FUSED_LAUNCHES.items() if k != "adam"}
    # LAMB moves each tensor by about lr |p| a step (the trust ratio), so
    # at the recipe's 1e-4 the loss need not fall within 10 steps: finite
    for name, r in (("A", a), ("B", b), ("C", c)):
        log(f"  run {name} (steps {r['first_step']}-{TRAIN_STEPS}): losses "
            f"{[round(x, 5) for x in r['losses']]}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"run {name}: non-finite loss {r['losses']}")
    fallbacks = {k: v for k, v in a["routes"].items() if k[2] == "fallback"}
    check(not fallbacks, f"LAMB: route fallbacks {fallbacks}")
    for name, per_step in expected.items():
        check(a["launches"][name] == per_step * TRAIN_STEPS,
              f"LAMB: {name} launched {a['launches'][name]} times in "
              f"{TRAIN_STEPS} steps, expected {per_step} a step")
    check(a["launches"]["adam"] == 0, "LAMB: the Adam kernel launched")
    # C starts from A's checkpoint: right after load_checkpoint it holds
    # A's state at the save, every persistable and generator bit for bit
    saved, restored = a.pop("saved"), c.pop("restored")
    check(sorted(saved) == sorted(restored),
          f"load_checkpoint restored {sorted(set(saved) ^ set(restored))} "
          f"differently from what was saved")
    differ = [n for n in saved if not torch.equal(saved[n], restored[n])]
    log(f"  restore: {len(saved)} persistables and generator states, "
        f"{len(differ)} differ from run A's at step {LAMB_SAVE_AT}")
    check(not differ, f"load_checkpoint restored {differ[:5]} other than "
                      f"run A saved them at step {LAMB_SAVE_AT}")
    del saved, restored
    # C ran steps 6-10 from A's checkpoint: held against A's steps 6-10
    tail = {"losses": a["losses"][LAMB_SAVE_AT:], "state": a["state"]}
    ab = run_distance(torch, a, b)
    ca = run_distance(torch, c, tail)
    cb = run_distance(torch, c, {"losses": b["losses"][LAMB_SAVE_AT:],
                                 "state": b["state"]})
    for what, d in (("A-B (two uninterrupted runs)", ab),
                    ("C-A (resumed vs the run it was saved from)", ca),
                    ("C-B", cb)):
        log(f"  distance {what}: state {d[0]:.3e} (relative norm), losses "
            f"max |Δ| {d[1]:.3e}, state max |Δ| {d[2]:.3e} (at "
            f"{d[3] or '-'})")
    bitwise = ab[:3] == (0.0, 0.0, 0.0)
    if bitwise:
        check(ca[:3] == (0.0, 0.0, 0.0), "the uninterrupted runs agree "
              "bit for bit and the resumed one does not")
    else:
        # two runs differ only where an op sums in a varying order: the
        # resumed run, which shares A's first steps exactly (above), may
        # drift from A over steps 6-10 as far as B drifts over 1-10, with
        # LAMB_RESUME_MARGIN for the spread of such drift
        check(ca[0] <= LAMB_RESUME_MARGIN * ab[0],
              f"the resumed run lies further from the run it was saved "
              f"from than {LAMB_RESUME_MARGIN} times the two uninterrupted "
              f"runs from each other")
    steady = statistics.median(b["step_s"][2:]) * 1e3
    gb = a["state_bytes"] / 1e9
    log(f"  step: median of steps 3-{TRAIN_STEPS} {steady:.2f} ms (run B); "
        f"save_checkpoint {a['save_s']:.2f} s, load_checkpoint "
        f"{c['load_s']:.2f} s for {gb:.3f} GB of state")
    report = {"losses": {"A": a["losses"], "B": b["losses"],
                         "C": c["losses"]},
              "bitwise": bitwise,
              "distance_ab": ab, "distance_ca": ca, "distance_cb": cb,
              "step_ms_median_3_10": steady, "step_s": b["step_s"],
              "save_s": a["save_s"], "load_s": c["load_s"],
              "state_gb": gb, "profile": b["profile"]}
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return a["launches"], report


# ---------------------------------------------------------------------------
# phase 14: recompute, gradient merge and the wrapper optimizers
# ---------------------------------------------------------------------------


def checkpoint_names(program):
    """Each encoder layer's last LayerNorm output (``Y`` of the LayerNorm
    whose scale is an ``_ln2_scale`` parameter): one recompute checkpoint
    a layer, picked from the program as the tests pick them."""
    return [op.output("Y")[0] for op in program.global_block().ops
            if op.type in ("layer_norm", "fused_add_layernorm")
            and op.input("Scale")[0].endswith("_ln2_scale")]


def recipe_optimizer(fluid, inner=None):
    """Phase 8's recipe (warmup, linear decay, global-norm clip): AdamW
    0.01, or ``inner(lr, clip)``."""
    lr = fluid.layers.linear_lr_warmup(
        fluid.layers.polynomial_decay(PEAK_LR, DECAY_STEPS, 0.0, power=1.0),
        WARMUP_STEPS, 0.0, PEAK_LR)
    clip = fluid.clip.GradientClipByGlobalNorm(CLIP_NORM)
    if inner is not None:
        return inner(lr, clip)
    return fluid.optimizer.AdamW(lr, weight_decay=WEIGHT_DECAY,
                                 grad_clip=clip)


def build_wrapped_train(cfg, configure=None, inner=None, wrap=None,
                        post=None):
    """Phase 14's program: phase 8's BERT-base pretraining and recipe
    (``recipe_optimizer(fluid, inner)``), wrapped by ``wrap(fluid, opt)``
    when given, through ``fleet.distributed_optimizer`` on one rank with
    the strategy ``configure(strategy, main)`` sets; then ``post(fluid,
    main)`` in the same programs (EMA's ``update``, ModelAverage) and both
    fusion passes, as phase 8.  Returns (the CompiledProgram, startup,
    loss, post's result)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    UserDefinedRoleMaker)
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    extra = None
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        opt = recipe_optimizer(fluid, inner)
        if wrap is not None:
            opt = wrap(fluid, opt)
        fleet.init(UserDefinedRoleMaker(0, 1))           # CUDAPlace(0)
        s = DistributedStrategy()
        if configure is not None:
            configure(s, main)
        fleet.distributed_optimizer(opt, s).minimize(total)
        check(fleet.main_program is main, "fleet on one rank compiled "
                                          "the program")
        if post is not None:
            extra = post(fluid, main)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    bs = fluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=total.name, build_strategy=bs)
    return compiled, startup, total, extra


def traced_ops(executor_mod, torch, name, pick):
    """A context manager naming a CPU range ``name`` around every op for
    which ``pick(op)`` holds (``executor._call``), so a profiled step
    gives those ops' launches and device time (``profile_step``'s
    ``ranges``)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        real = executor_mod._call

        def call(op, fn):
            if pick(op):
                with torch.profiler.record_function(name):
                    return real(op, fn)
            return real(op, fn)
        executor_mod._call = call
        try:
            yield
        finally:
            executor_mod._call = real
    return ctx()


def wrapped_run(torch, np, cfg, build, steps, feeds=None, grads=False,
                fetch=None, after_step=None, measure=False, ranges=()):
    """``steps`` steps of ``build()``'s program through
    prepare(donate_state=True) on the card from the seed (phase 8's
    batch, or ``feeds[i]`` at step i), launch and route counts
    from zero before the steps and read right after them.  With
    ``grads`` every ``param@GRAD`` is fetched too, step 1's kept
    (``grads``); ``fetch(program)`` names more fetches, and
    ``after_step(i, scope, program, fetched)`` runs after each step.
    With ``measure``: the peak memory of one more step
    (``reset_peak_memory_stats`` around it), then one profiled step
    (``ranges``: (range name, op picker) pairs, ``traced_ops``)."""
    import contextlib
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework import executor as executor_mod
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    compiled, startup, total, extra = build()
    program = compiled._program
    if feeds is None:
        feeds = [bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                      TRAIN_BATCH, TRAIN_SEQ,
                                      TRAIN_MASKS)] * steps
    scope = fluid.Scope()
    exe = fluid.Executor()                       # CUDAPlace(0)
    exe.run(startup, scope=scope)
    more = list(fetch(program)) if fetch is not None else []
    grad_names = [p.name + "@GRAD" for p in program.all_parameters()] \
        if grads else []
    prepared = exe.prepare(compiled, fetch_list=[total] + more + grad_names,
                           scope=scope, donate_state=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    out = {"losses": [], "step_s": [], "program": program, "scope": scope,
           "exe": exe, "extra": extra, "prepared": prepared,
           "launches_by_step": []}
    for i in range(steps):
        t0 = time.perf_counter()
        handles = prepared.run(feeds[i])
        out["losses"].append(float(handles[0]))
        out["step_s"].append(time.perf_counter() - t0)
        if i == 0 and grads:
            out["grads"] = {n: h.value.detach().clone() for n, h in
                            zip(grad_names, handles[1 + len(more):])}
        fetched = [h.value for h in handles[1:1 + len(more)]]
        del handles
        out["launches_by_step"].append(kernels.launch_counts())
        if after_step is not None:
            fluid.sync_prepared_state(scope)
            after_step(i + 1, scope, program, fetched)
        del fetched
    out["launches"] = kernels.launch_counts()
    out["routes"] = registry.route_counts()
    out["predicate_reads"] = prepared.stats["predicate_reads"]
    if measure:
        def one():
            return float(prepared.run(feeds[-1])[0])
        out["step_ms"] = statistics.median(out["step_s"][2:]) * 1e3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one()
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        with contextlib.ExitStack() as stack:
            for name, pick in ranges:
                stack.enter_context(traced_ops(executor_mod, torch, name,
                                               pick))
            out["profile"] = profile_step(torch, one, out["step_ms"],
                                          ranges=tuple(n for n, _ in ranges))
    return out


def check_wrapped_launches(what, launches, expected, steps):
    for name, n in launches.items():
        check(n == expected.get(name, 0) * steps,
              f"{what}: {name} launched {n} times in {steps} steps, "
              f"expected {expected.get(name, 0)} a step")


def no_fallbacks(what, routes):
    fallbacks = {k: v for k, v in routes.items() if k[2] == "fallback"}
    check(not fallbacks, f"{what}: route fallbacks {fallbacks}")


def grad_gap(torch, got, ref):
    """max over tensors of max|Δ| / max|ref|, the tensor, and the tensors
    that differ at all."""
    worst, where, differ = 0.0, "", []
    for n, b in ref.items():
        a = got[n]
        if not torch.equal(a, b):
            differ.append(n)
        e = float((a.double() - b.double()).abs().max()) / max(
            float(b.double().abs().max()), 1e-30)
        if e > worst:
            worst, where = e, n
    return worst, where, differ


def recompute_leg(torch, np, cfg):
    """(a): phase 8's program with and without ``strategy.recompute`` (one
    checkpoint a layer), RC_STEPS steps each at dropout 0.1 from one
    seed."""
    def configure(s, main):
        s.recompute = True
        s.recompute_configs = {"checkpoints": checkpoint_names(main)}

    runs = {}
    for name, conf in (("plain", None), ("recompute", configure)):
        runs[name] = wrapped_run(
            torch, np, cfg, lambda c=conf: build_wrapped_train(cfg, c),
            RC_STEPS, grads=True, measure=True)
        r = runs[name]
        bw = [op for op in r["program"].global_block().ops
              if op.type == "backward"][0]
        ckpts = list(bw.attrs.get("checkpoints") or ())
        check(len(ckpts) == (12 if name == "recompute" else 0),
              f"{name}: {len(ckpts)} recompute checkpoints")
        no_fallbacks(f"(a) {name}", r["routes"])
        check_wrapped_launches(f"(a) {name}", r["launches"],
                               RECOMPUTE_LAUNCHES if ckpts
                               else FUSED_LAUNCHES, RC_STEPS)
        log(f"  (a) {name}: losses {[round(x, 5) for x in r['losses']]}; "
            f"step median of 3-{RC_STEPS} {r['step_ms']:.2f} ms; peak "
            f"{r['peak_gib']:.3f} GiB in one step; launches "
            f"{r['launches']}")
        for k in ("scope", "exe", "prepared"):
            r.pop(k)
        torch.cuda.empty_cache()
    plain, rc = runs["plain"], runs["recompute"]
    check(plain["losses"][0] == rc["losses"][0],
          f"(a) step-1 loss {rc['losses'][0]!r} with recompute, "
          f"{plain['losses'][0]!r} without")
    gap, worst, differ = grad_gap(torch, rc["grads"], plain["grads"])
    log(f"  (a) step-1 gradients, recompute vs not: max|Δ| / max|grad| "
        f"{gap:.3e} at {worst or '-'} (tolerance {TOL_RC_GRAD:.0e}); "
        f"{len(plain['grads']) - len(differ)} of {len(plain['grads'])} "
        f"tensors bit for bit, differing: {differ}")
    check(gap <= TOL_RC_GRAD, f"(a) step-1 gradient of {worst}: recompute "
                              f"disagrees with the plain step")
    last = abs(rc["losses"][-1] - plain["losses"][-1]) / \
        abs(plain["losses"][-1])
    log(f"  (a) step-{RC_STEPS} loss: relative Δ {last:.3e} (tolerance "
        f"{TOL_RC_LOSS:.0e})")
    check(last <= TOL_RC_LOSS, "(a) recompute drifts from the plain run")
    report = {}
    for name, r in runs.items():
        prof = r["profile"] or {}
        report[name] = {"losses": r["losses"], "step_s": r["step_s"],
                        "step_ms_median_3_10": r["step_ms"],
                        "peak_gib": r["peak_gib"],
                        "busy_ms": prof.get("busy_ms"),
                        "profile": r["profile"]}
    report.update(grad_max_rel=gap, grad_worst=worst, grads_differ=differ,
                  last_loss_rel=last)
    log(f"  (a) peak memory {plain['peak_gib']:.3f} -> {rc['peak_gib']:.3f} "
        f"GiB, step {plain['step_ms']:.2f} -> {rc['step_ms']:.2f} ms, "
        f"device busy {report['plain']['busy_ms']} -> "
        f"{report['recompute']['busy_ms']} ms")
    return rc["launches"], report


def gradient_merge_leg(torch, np, cfg):
    """(b): recompute and ``strategy.gradient_merge`` (k GM_K, avg) on
    micro-batches of GM_MICRO rows, GM_STEPS steps at dropout 0; the
    merged gradient at the first apply against one step of the plain
    program on the same GM_K * GM_MICRO rows."""
    import dataclasses
    from paddle_tpu_torch.models import bert
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    whole = bert.make_fake_batch(np.random.RandomState(SEED), cfg0,
                                 GM_K * GM_MICRO, TRAIN_SEQ, TRAIN_MASKS)
    micro = []
    for j in range(GM_K):
        rows = slice(j * GM_MICRO, (j + 1) * GM_MICRO)
        micro.append({k: (v[j * GM_MICRO * TRAIN_MASKS:
                            (j + 1) * GM_MICRO * TRAIN_MASKS]
                          if k == "mask_label" else v[rows])
                      for k, v in whole.items()})
    feeds = [micro[i % GM_K] for i in range(GM_STEPS)]

    def configure(s, main):
        s.recompute = True
        s.recompute_configs = {"checkpoints": checkpoint_names(main)}
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": GM_K, "avg": True}

    ref = wrapped_run(torch, np, cfg0,
                      lambda: build_wrapped_train(cfg0, None), 1,
                      feeds=[whole], grads=True)
    ref_grads = ref["grads"]
    del ref
    torch.cuda.empty_cache()
    state, merged = {}, {}

    def eff_names(program):
        return sorted(v.name for v in program.list_vars()
                      if "_gm_eff" in v.name)

    def watch(i, scope, program, fetched):
        params = [p.name for p in program.all_parameters()]
        moments = [v.name for v in program.list_vars() if v.persistable
                   and ("_moment" in v.name or "_pow_acc" in v.name)]
        accs = [v.name for v in program.list_vars() if v.persistable
                and "_gm_acc" in v.name]
        now = {n: scope.find_var(n) for n in params + moments}
        applied = i % GM_K == 0
        if state:
            same = [n for n in now if torch.equal(now[n], state[n])]
            if applied:
                check(not [n for n in params if n in same],
                      f"(b) step {i}: an apply step left parameters "
                      f"unchanged: {[n for n in params if n in same][:5]}")
            else:
                check(len(same) == len(now),
                      f"(b) step {i}: a step that does not apply changed "
                      f"{[n for n in now if n not in same][:5]}")
        state.clear()
        state.update({n: t.detach().clone() for n, t in now.items()})
        if applied:
            nonzero = [n for n in accs if bool(scope.find_var(n).any())]
            check(len(accs) == ADAM_OPS and not nonzero,
                  f"(b) step {i}: {len(nonzero)} of {len(accs)} "
                  f"accumulators not zero after the apply")
        if i == GM_K:
            # each merged gradient, by the parameter its name starts with
            merged.update({n[:n.index("_gm_eff")] + "@GRAD": t.detach()
                           for n, t in zip(eff_names(program), fetched)})

    r = wrapped_run(torch, np, cfg0, lambda: build_wrapped_train(
        cfg0, configure), GM_STEPS, feeds=feeds, fetch=eff_names,
        after_step=watch)
    state.clear()
    check(merged.keys() == ref_grads.keys(),
          "(b) the merged gradients do not name the parameters")
    gap, worst, _ = grad_gap(torch, merged, ref_grads)
    log(f"  (b) merged gradient at step {GM_K} vs one {GM_K * GM_MICRO}-row "
        f"step: max|Δ| / max|grad| {gap:.3e} at {worst} (tolerance "
        f"{TOL_GM_GRAD:.0e})")
    check(gap <= TOL_GM_GRAD, f"(b) the merged gradient of {worst} "
                              f"strays from the whole batch's")
    merged.clear()
    del ref_grads
    no_fallbacks("(b)", r["routes"])
    per_step = dict(RECOMPUTE_LAUNCHES, adam=0)
    applies = GM_STEPS // GM_K
    for name, n in r["launches"].items():
        want = applies if name == "adam" else per_step.get(name, 0) * \
            GM_STEPS
        check(n == want, f"(b) {name} launched {n} times in {GM_STEPS} "
                         f"steps, expected {want}")
    adam_by_step = [d.get("adam", 0) for d in r["launches_by_step"]]
    want_adam = [(i + 1) // GM_K for i in range(GM_STEPS)]
    check(adam_by_step == want_adam,
          f"(b) Adam launches after each step {adam_by_step}, expected "
          f"{want_adam}")
    check(r["predicate_reads"] == GM_STEPS,
          f"(b) {r['predicate_reads']} predicate reads in {GM_STEPS} steps")
    apply_s = [s for i, s in enumerate(r["step_s"]) if (i + 1) % GM_K == 0]
    skip_s = [s for i, s in enumerate(r["step_s"])
              if (i + 1) % GM_K and i >= 1]
    log(f"  (b) losses {[round(x, 5) for x in r['losses']]}; step times "
        f"(s) {[round(x, 4) for x in r['step_s']]}: apply steps "
        f"{[round(x * 1e3, 2) for x in apply_s]} ms, the others' median "
        f"{statistics.median(skip_s) * 1e3:.2f} ms; {r['predicate_reads']} "
        f"predicate reads; launches {r['launches']}")
    return r["launches"], {
        "losses": r["losses"], "step_s": r["step_s"],
        "apply_step_ms": [s * 1e3 for s in apply_s],
        "other_step_ms_median": statistics.median(skip_s) * 1e3,
        "merged_grad_max_rel": gap, "merged_grad_worst": worst,
        "predicate_reads": r["predicate_reads"],
        "adam_launches_by_step": adam_by_step}


def averaging_leg(torch, np, cfg):
    """(c): WRAP_STEPS steps each of EMA (thres_steps: the LR schedule's
    step counter), ModelAverage and Lookahead(AdamW) on phase 8's
    program."""
    from paddle_tpu_torch import fluid

    def ema_post(fl, main):
        step = [v for v in main.list_vars()
                if v.persistable and v.name.startswith("@LR_STEP@")][0]
        ema = fl.optimizer.ExponentialMovingAverage(
            EMA_DECAY, thres_steps=fl.layers.cast(step, "float32"))
        ema.update()
        return ema

    def ma_post(fl, main):
        return fl.optimizer.ModelAverage(MA_RATE, min_average_window=MA_MIN,
                                         max_average_window=MA_MAX)

    def lookahead(fl, opt):
        return fl.optimizer.LookaheadOptimizer(opt, alpha=LA_ALPHA, k=LA_K)

    report = {}
    ema_names = lambda op: any("_ema" in n or n.startswith("ema_")  # noqa
                               for n in op.output_names())
    for name, kw in (("ema", {"post": ema_post}),
                     ("model_average", {"post": ma_post}),
                     ("lookahead", {"wrap": lookahead})):
        syncs = []

        def watch(i, scope, program, fetched, _syncs=syncs):
            if name != "lookahead":
                return
            params = [p.name for p in program.all_parameters()]
            slow = {v.name[:v.name.index("_slow")]: v.name
                    for v in program.list_vars() if "_slow" in v.name}
            equal = [torch.equal(scope.find_var(p),
                                 scope.find_var(slow[p])) for p in params]
            _syncs.append(sum(equal))
            if i % LA_K == 0:
                check(all(equal), f"(c) Lookahead step {i}: "
                                  f"{len(equal) - sum(equal)} fast weights "
                                  f"differ from the slow weights")

        r = wrapped_run(
            torch, np, cfg, lambda kw=kw: build_wrapped_train(cfg, **kw),
            WRAP_STEPS, after_step=watch, measure=name == "ema",
            ranges=(("ema_update", ema_names),) if name == "ema" else ())
        no_fallbacks(f"(c) {name}", r["routes"])
        check_wrapped_launches(f"(c) {name}", r["launches"],
                               FUSED_LAUNCHES, WRAP_STEPS)
        check(all(math.isfinite(x) for x in r["losses"]),
              f"(c) {name}: non-finite loss {r['losses']}")
        scope, exe, program = r["scope"], r["exe"], r["program"]
        fluid.sync_prepared_state(scope)
        params = [p.name for p in program.all_parameters()]
        entry = {"losses": r["losses"], "step_s": r["step_s"]}
        if name in ("ema", "model_average"):
            avg = r["extra"]
            before = {n: scope.find_var(n).detach().clone() for n in params}
            with fluid.scope_guard(scope):
                with avg.apply(exe):
                    applied = {n: scope.find_var(n).detach().clone()
                               for n in params}
            restored = [n for n in params
                        if torch.equal(scope.find_var(n), before[n])]
            check(len(restored) == len(params),
                  f"(c) {name}: restore gave back {len(restored)} of "
                  f"{len(params)} parameters bit for bit")
            moved = sum(not torch.equal(applied[n], before[n])
                        for n in params)
            check(moved > 0, f"(c) {name}: apply moved no parameter")
            entry["applied_params"] = moved
            if name == "ema":
                prod = scope.find_var(avg._decay_prod.name)
                factor = 1.0 - prod
                worst = 0
                for n in params:
                    want = scope.find_var(avg._ema_vars[n].name) / factor
                    got = applied[n]
                    ulps = (got.view(torch.int32).long()
                            - want.view(torch.int32).long()).abs().max()
                    worst = max(worst, int(ulps))
                log(f"  (c) EMA apply vs ema / (1 - prod decay_t) "
                    f"(prod {float(prod):.6f}): at most {worst} float32 "
                    f"ulps apart (tolerance 1)")
                check(worst <= 1, "(c) EMA's apply is not its bias-"
                                  "corrected average")
                prof = r["profile"] or {}
                entry["update_launches"] = prof.get(
                    "range_launches", {}).get("ema_update")
                entry["update_device_ms"] = prof.get(
                    "groups_ms", {}).get("ema_update")
                entry["step_ms_median"] = r["step_ms"]
                entry["ulps"] = worst
        else:
            entry["synced_params_by_step"] = syncs
            check(syncs[-1] < len(params),
                  "(c) Lookahead: the fast weights equal the slow ones "
                  "after a step that does not sync")
        log(f"  (c) {name}: losses {[round(x, 5) for x in r['losses']]}"
            + (f"; EMA update {entry['update_launches']} launches, "
               f"{entry['update_device_ms']} device ms a step"
               if name == "ema" else "")
            + (f"; fast = slow per step {syncs} of {len(params)}"
               if name == "lookahead" else ""))
        report[name] = entry
        del r, scope, exe
        torch.cuda.empty_cache()
    return report


def dgc_leg(torch, np, cfg):
    """(d): ``strategy.use_dgc`` on Momentum(DGC_LR, DGC_MOMENTUM) with the
    recipe's clip (fleet swaps in DGCMomentum: ``rampup_begin_step`` 0,
    sparsity [0.999]), WRAP_STEPS steps; the last step's op on the word
    embedding is held to ``np.quantile`` and to its formula."""
    from paddle_tpu_torch.ops import optimizer_ops, registry

    def configure(s, main):
        s.use_dgc = True

    def momentum(lr, clip):
        from paddle_tpu_torch import fluid
        return fluid.optimizer.Momentum(DGC_LR, DGC_MOMENTUM,
                                        grad_clip=clip)

    seen, armed = {}, []
    real = registry.OPS["dgc_momentum"]

    def capture(ctx, ins, attrs):
        out = real(ctx, ins, attrs)
        p = ins["Param"][0]
        if armed and p.numel() == cfg.vocab_size * cfg.hidden_size:
            seen.update({k: v[0].detach().clone() for k, v in ins.items()})
            seen.update({k: v.detach().clone() for k, v in out.items()})
            seen["attrs"] = dict(attrs)
        return out

    def arm(i, scope, program, fetched):
        # the word embedding's op of the last step (not a measured one)
        armed[:] = [True] if i == WRAP_STEPS - 1 else []

    registry.OPS["dgc_momentum"] = capture
    try:
        r = wrapped_run(
            torch, np, cfg,
            lambda: build_wrapped_train(cfg, configure, inner=momentum),
            WRAP_STEPS, after_step=arm, measure=True,
            ranges=(("dgc_update",
                     lambda op: op.type == "dgc_momentum"),))
    finally:
        registry.OPS["dgc_momentum"] = real
    check(bool(seen), "(d) the word embedding's dgc_momentum op did not run")
    ops = [op.type for op in r["program"].global_block().ops]
    check(ops.count("dgc_momentum") == ADAM_OPS and "momentum" not in ops,
          f"(d) {ops.count('dgc_momentum')} dgc_momentum ops")
    no_fallbacks("(d)", r["routes"])
    check_wrapped_launches("(d)", r["launches"], dict(FUSED_LAUNCHES,
                                                      adam=0), WRAP_STEPS)
    check(all(math.isfinite(x) for x in r["losses"]),
          f"(d) non-finite loss {r['losses']}")
    # the last captured step (the profiled one) of the word embedding
    mu = seen["attrs"]["momentum"]
    u_new = mu * seen["U"] + seen["Grad"]
    v_new = seen["V"] + u_new
    absv = v_new.abs()
    n = absv.numel()
    host = absv.double().cpu().numpy().reshape(-1)
    q = float(np.float32(seen["attrs"]["sparsity"][0]))
    want = np.float32(np.quantile(host, q))
    thr = float(optimizer_ops.quantile_linear(absv, torch.tensor(
        q, dtype=torch.float32, device=absv.device)))
    ulp = float(np.spacing(want))
    log(f"  (d) threshold over {n} elements: {thr!r} on the card, "
        f"np.quantile in float64 {float(want)!r} (one ulp {ulp:.3e})")
    check(abs(thr - float(want)) <= ulp, "(d) the DGC threshold is not "
                                         "np.quantile's")
    mask = (absv >= thr).to(v_new.dtype)
    sent = int(mask.sum())
    share = sent / n
    check(abs(sent - (1.0 - q) * n) <= 1.0 + 1e-6,
          f"(d) {sent} of {n} elements sent ({share:.6%}), not "
          f"{1.0 - q:.4%} ± 1/n")
    consistent = (torch.equal(seen["UOut"], u_new * (1.0 - mask)) and
                  torch.equal(seen["VOut"], v_new * (1.0 - mask)))
    lr = seen["LearningRate"].to(v_new.dtype)
    p_ok = torch.equal(seen["ParamOut"], seen["Param"] - lr * (v_new * mask))
    log(f"  (d) sent {sent} of {n} ({100 * share:.4f} %); U and V "
        f"{'match' if consistent else 'do NOT match'} the op's formula, "
        f"the parameter {'matches' if p_ok else 'does NOT match'}")
    check(consistent and p_ok, "(d) DGC's outputs are not its formula's")
    prof = r["profile"] or {}
    report = {"losses": r["losses"], "step_s": r["step_s"],
              "step_ms_median": r["step_ms"], "threshold": thr,
              "np_quantile": float(want), "sent": sent, "numel": n,
              "update_launches": prof.get("range_launches", {}).get(
                  "dgc_update"),
              "update_device_ms": prof.get("groups_ms", {}).get(
                  "dgc_update"),
              "peak_gib": r["peak_gib"]}
    log(f"  (d) losses {[round(x, 5) for x in r['losses']]}; step "
        f"{r['step_ms']:.2f} ms; DGC update {report['update_launches']} "
        f"launches, {report['update_device_ms']} device ms a step")
    seen.clear()
    return r["launches"], report


def localsgd_worker(out_dir):
    """One rank of phase 14's leg (e) (``--localsgd-worker``): phase 8's
    program and recipe through ``fleet`` with ``strategy.localsgd``
    (k_steps LOCALSGD_K), LOCALSGD_STEPS prepared steps on the global
    batch (each rank its half of the rows), the parameters' sha256 after
    each; writes ``localsgd<r>.json``."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    PaddleCloudRoleMaker)
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    cfg = bert.BertConfig.base()
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        s = DistributedStrategy()
        s.localsgd = True
        s.localsgd_configs = {"k_steps": LOCALSGD_K}
        s.build_strategy = fluid.BuildStrategy()
        s.build_strategy.fuse_elewise_add_act_ops = True
        fleet.distributed_optimizer(recipe_optimizer(fluid),
                                    s).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    program = fleet.main_program
    check(program._dp is not None and program._dp.world == DP_RANKS,
          "leg (e): fleet.main_program is not data-parallel")
    ops = [op.type for op in main.global_block().ops]
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    res = {"rank": rank, "ops": sorted(set(ops)),
           "sync_ops": ops.count("local_sgd_sync"), "losses": [],
           "digests": [], "step_s": []}
    for _ in range(LOCALSGD_STEPS):
        t0 = time.perf_counter()
        res["losses"].append(float(prepared.run(feed)[0]))
        res["step_s"].append(time.perf_counter() - t0)
        fluid.sync_prepared_state(scope)
        res["digests"].append(params_digest(np, scope, main))
    res["launches"] = kernels.launch_counts()
    res["fallbacks"] = len(registry.route_counts("fallback"))
    res["predicate_reads"] = prepared.stats["predicate_reads"]
    with open(os.path.join(out_dir, f"localsgd{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def localsgd_leg(torch, repo):
    """(e): two ranks on the card over gloo (phase 10's launcher)."""
    from paddle_tpu_torch.ops.cuda import build
    out_dir = os.path.join(build.BUILD_DIR, "smoke_localsgd")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(DP_RANKS), "--selected_gpus", "0,0",
           "--backend", "gloo", "--timeout", str(DP_TIMEOUT_S),
           os.path.join(repo, "chip_smoke.py"), "--localsgd-worker",
           out_dir]
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=repo, timeout=DP_TIMEOUT_S + 60).returncode
    log(f"  (e) the ranks ran {time.perf_counter() - t0:.1f} s, exit code "
        f"{rc}")
    check(rc == 0, f"(e) a LocalSGD rank failed (exit code {rc})")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"localsgd{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    for r in ranks:
        synced = [o for o in r["ops"] if "allreduce" in o]
        check(not synced, f"(e) rank {r['rank']}: gradient all-reduce ops "
                          f"{synced} in a LocalSGD program")
        check(r["sync_ops"] == 1 and not r["fallbacks"],
              f"(e) rank {r['rank']}: {r['sync_ops']} local_sgd_sync ops, "
              f"{r['fallbacks']} route fallbacks")
        check_wrapped_launches(f"(e) rank {r['rank']}", r["launches"],
                               FUSED_LAUNCHES, LOCALSGD_STEPS)
        check(r["predicate_reads"] == LOCALSGD_STEPS,
              f"(e) rank {r['rank']}: {r['predicate_reads']} predicate "
              f"reads")
    same = [a == b for a, b in zip(ranks[0]["digests"],
                                   ranks[1]["digests"])]
    # equal after a sync step, and after step 1, whose LR the warmup
    # holds at 0 (nothing moves); different after the other steps
    want = [(i + 1) % LOCALSGD_K == 0 or scheduled_lr(i) == 0.0
            for i in range(LOCALSGD_STEPS)]
    log(f"  (e) parameters sha256-equal across the ranks after each step: "
        f"{same} (a sync every {LOCALSGD_K} steps; LR 0 at step 1: "
        f"{want}); losses (each rank's fetch is the ranks' mean) "
        f"{[[round(x, 5) for x in r['losses']] for r in ranks]}")
    check(same == want, "(e) the ranks' parameters are not equal exactly "
                        "after the sync steps")
    return ranks[0]["launches"], {
        "same_after_step": same,
        "losses": [r["losses"] for r in ranks],
        "step_s": [r["step_s"] for r in ranks]}


def wrappers_phase(torch, np, cfg, repo):
    """Phase 14 (see the module docstring): legs (a)-(e); returns the
    launches of (a)'s recompute run, (b)'s run and (d)'s, and the
    report."""
    log("  (a) recompute, one checkpoint a layer, dropout "
        f"{cfg.hidden_dropout_prob}")
    rc_launches, rc = recompute_leg(torch, np, cfg)
    log(f"  (b) recompute + gradient merge, k {GM_K}, {GM_MICRO} x "
        f"{TRAIN_SEQ} micro-batches")
    gm_launches, gm = gradient_merge_leg(torch, np, cfg)
    log("  (c) EMA, ModelAverage, Lookahead")
    avg = averaging_leg(torch, np, cfg)
    log("  (d) DGC momentum")
    dgc_launches, dgc = dgc_leg(torch, np, cfg)
    log(f"  (e) LocalSGD, {DP_RANKS} ranks on one card over gloo")
    ls_launches, ls = localsgd_leg(torch, repo)
    return ({"recompute": rc_launches, "gradient_merge": gm_launches,
             "dgc": dgc_launches, "localsgd": ls_launches},
            {"recompute": rc, "gradient_merge": gm, "averages": avg,
             "dgc": dgc, "localsgd": ls})


#: phase 15: ZeRO on two ranks of the card.  Legs: (a) plain dp2 with the
#: fp32 all-reduce (the yardstick), (b) ZeRO-1 fp32, (c) ZeRO-1 with the
#: int8 scatter, (d) with the int4 scatter, (e) ZeRO-3 over fsdp = 2; (f)
#: the same ranks, after the other legs, load the checkpoint (b) saved
#: into a freshly built program and scope
ZERO_LEGS = "abcde"
ZERO_LEG_NAMES = {"a": "dp2, fp32 all-reduce", "b": "ZeRO-1, fp32 scatter",
                  "c": "ZeRO-1, int8 scatter", "d": "ZeRO-1, int4 scatter",
                  "e": "ZeRO-3, fsdp 2"}
ZERO_QUANT = {"c": "int8", "d": "int4"}
ZERO_BLOCK = 256          # the word embedding's shard: SB 45,783 at n = 2
ZERO_STEPS, ZERO_SAVE_AT = 6, 3
TOL_ZERO_LOSS = 1e-4      # (b), (e) vs (a): losses (relative)
TOL_ZERO_PARAM = 1e-4     # (b), (e) vs (a): parameters, of max|p|
# (c), (d) vs (a), a few times what the quantized scatter gives on these
# inputs (the legs are deterministic: stochastic rounding off).  Losses,
# relative: measured int8 7.5e-6, int4 2.0e-3.  Parameters, max|Δ| of
# max|p|: measured 5.3e-4, 7.9e-4; a shard or pad out of place moves a
# parameter by its own size, but 6 steps move no element by more than
# the summed LR (4e-4) each way, so this gap saturates near 8e-4 and
# cannot see a lost contribution.  The scatter gap can: the first step's
# scattered word-embedding gradient (the largest) against (b)'s fp32 one
# on the same inputs, |g - g_b| / |g_b|: measured int8 8.8e-3, int4
# 1.6e-1, where a peer's contribution lost leaves 0.5-0.7 of the sum
ZERO_QUANT_LOSS = {"int8": 4e-5, "int4": 1e-2}
ZERO_QUANT_PARAM = {"int8": 2e-3, "int4": 3e-3}
ZERO_QUANT_SCATTER = {"int8": 3e-2, "int4": 2.5e-1}
#: phase 15's auto-shard legs, in the same launch: (g) plain dp2 with
#: phase 8's recipe (its global-norm clip 1.0 included), (h) fleet's
#: auto_shard with the same recipe and a budget halfway between the free
#: plan's peaks, which flips the winner to fsdp 2 (the clip's squares
#: summed over fsdp); AUTO_STEPS prepared steps each
AUTO_LEGS = "gh"
AUTO_LEG_NAMES = {"g": "dp2, phase 8's recipe with its clip",
                  "h": "auto_shard under a budget (fsdp 2), the same recipe"}
AUTO_STEPS = 4


# ---------------------------------------------------------------------------
# phase 15: ZeRO-1 and ZeRO-3 on two ranks of the card
# ---------------------------------------------------------------------------


def zero_optimizer(fluid):
    """Phase 15's recipe: phase 8's AdamW 0.01 with warmup and linear
    decay, without the global-norm clip (ZeRO-1 refuses a norm clip: a
    shard-local norm would clip each rank differently)."""
    lr = fluid.layers.linear_lr_warmup(
        fluid.layers.polynomial_decay(PEAK_LR, DECAY_STEPS, 0.0, power=1.0),
        WARMUP_STEPS, 0.0, PEAK_LR)
    return fluid.optimizer.AdamW(lr, weight_decay=WEIGHT_DECAY)


def build_zero_train(cfg, leg, budget=None, feed=None):
    """Phase 15's program for ``leg`` as a rank writes it: BERT-base
    pretraining, ``fuse_add_layernorm`` and ``fuse_elewise_add_act_ops``,
    the recipe of :func:`zero_optimizer`; (a) through ``fleet`` (the fp32
    bucketed all-reduce), (b)-(d) through ``fleet`` with
    ``strategy.sharding`` (fp32, int8, int4 scatter), (e) minimized, then
    ``apply_fsdp_sharding(main, MeshLayout(fsdp=2))`` and
    ``CompiledProgram.with_mesh``; (g) like (a) with phase 8's recipe (its
    clip), (h) the same through fleet's ``auto_shard`` with the budget
    ``budget`` (None: no budget) at ``feed``'s shapes.  Returns (the
    program to run, main, startup, loss)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    build = fluid.BuildStrategy()
    build.fuse_elewise_add_act_ops = True
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        if leg == "e":
            zero_optimizer(fluid).minimize(total)
        elif leg in AUTO_LEGS:
            s = DistributedStrategy()
            s.build_strategy = build
            if leg == "h":
                s.auto_shard = True
                s.auto_shard_configs["hbm_budget_gb"] = budget
                s.auto_shard_configs["feed_shapes"] = {
                    k: (v.shape, str(v.dtype)) for k, v in feed.items()}
            fleet.distributed_optimizer(recipe_optimizer(fluid),
                                        s).minimize(total)
        else:
            s = DistributedStrategy()
            s.build_strategy = build
            s.sharding = leg != "a"
            if leg in ZERO_QUANT:
                s.quant_allreduce = True
                s.quant_configs = {"dtype": ZERO_QUANT[leg],
                                   "block_size": ZERO_BLOCK,
                                   "stochastic_rounding": False}
            fleet.distributed_optimizer(zero_optimizer(fluid),
                                        s).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    if leg != "e":
        return fleet.main_program, main, startup, total
    layout = MeshLayout(fsdp=DP_RANKS)
    apply_fsdp_sharding(main, layout)
    program = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=total.name,
        batch_axis=layout.batch_axes, build_strategy=build)
    return program, main, startup, total


def global_norm_name(main):
    """The global-norm clip's norm (the ``sqrt`` of its sum of squares)."""
    names = [op.output_names()[0] for op in main.global_block().ops
             if op.type == "sqrt" and
             op.output_names()[0].startswith("global_norm")]
    check(len(names) == 1, f"one global-norm clip expected, found {names}")
    return names[0]


def memory_estimate(program, feed, loss_name):
    """The static per-rank estimate of the program a rank runs
    (``memory_analysis.analyze_memory`` on the pass variant, at the
    feed's shapes and the run's layout), its state's names and the
    persistables the program writes."""
    from paddle_tpu_torch.framework import memory_analysis as ma
    variant = program._variant_for([loss_name]) \
        if hasattr(program, "_variant_for") else program
    est = ma.analyze_memory(
        variant, feed_shapes=feed, fetch_names=[loss_name],
        mesh_axes=getattr(program, "_mesh_axes", None) or {},
        batch_axis=getattr(program, "_batch_axis", None),
        seq_axis=getattr(program, "_seq_axis", None),
        feed_specs=getattr(program, "_feed_specs", None))
    state_in, written = ma._state_names(variant, [loss_name])
    return est, state_in, set(written)


def scope_bytes(torch, scope, names):
    """Bytes the scope holds of ``names``."""
    total = 0
    for n in names:
        t = scope.find_var(n)
        if torch.is_tensor(t):
            total += t.numel() * t.element_size()
    return total


def left_out_bytes(torch, dp, scope, main, state_in, written):
    """{each persistable the scope holds outside the estimate's state
    ``state_in``: [its bytes by the layout's formula, whether the program
    writes it]}: one the step writes before it reads it (a scheduled
    learning rate) is priced among the step's values, not its state."""
    from paddle_tpu_torch.ops.collective_ops import _sharding
    out = {}
    for v in main.list_vars():
        t = scope.find_var(v.name) if v.persistable else None
        if not torch.is_tensor(t) or v.name in state_in:
            continue
        whole = math.prod(v.shape) * t.element_size()
        sh = _sharding(dp, v)
        out[v.name] = [whole // sh[1].world if sh is not None else whole,
                       v.name in written]
    return out


def held_bytes(torch, dp, scope, main):
    """(bytes this rank's scope holds of the program's persistables, the
    bytes the layout predicts over the run's groups ``dp``: a sharded
    one's global bytes over the ranks of the axes that shard it, a
    replicated one's whole; the moments' and the parameters' held
    bytes)."""
    from paddle_tpu_torch.ops.collective_ops import _sharding
    held = predicted = moments = params = 0
    names = {p.name for p in main.all_parameters()}
    for v in main.list_vars():
        t = scope.find_var(v.name) if v.persistable else None
        if not torch.is_tensor(t):
            continue
        nbytes = t.numel() * t.element_size()
        whole = math.prod(v.shape) * t.element_size()
        held += nbytes
        sh = _sharding(dp, v)
        predicted += whole // sh[1].world if sh is not None else whole
        if "_moment" in v.name:
            moments += nbytes
        elif v.name in names:
            params += nbytes
    return held, predicted, moments, params


def state_digests(np, scope, main):
    """sha256 of each persistable's bytes as this rank holds it."""
    import hashlib
    out = {}
    for v in main.list_vars():
        t = scope.find_var(v.name) if v.persistable else None
        if t is None or not hasattr(t, "detach"):
            continue
        out[v.name] = hashlib.sha256(
            t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
    return out


def replicated_digest(np, dp, scope, main):
    """sha256 over the replicated persistables (those the layout does
    not shard), in name order, as this rank holds them."""
    import hashlib
    from paddle_tpu_torch.ops.collective_ops import shard_dim
    h = hashlib.sha256()
    for v in sorted(main.list_vars(), key=lambda v: v.name):
        t = scope.find_var(v.name) if v.persistable else None
        if t is None or not hasattr(t, "detach") or \
                shard_dim(dp, v) is not None:
            continue
        h.update(v.name.encode())
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def global_params(dp, scope, main):
    """Every parameter's global value (a sharded one's blocks gathered
    over ``dp``; a collective, so every rank calls it), on the device, in
    tensors of their own (the steps after update the scope's in place)."""
    from paddle_tpu_torch.ops.collective_ops import whole_of
    return {p.name: whole_of(dp, p, scope.find_var(p.name)).clone()
            for p in sorted(main.all_parameters(), key=lambda p: p.name)}


def params_gap(torch, got, ref):
    """max|Δ| over every parameter, of max|p| of the reference."""
    err = max(float((got[n] - ref[n]).abs().max()) for n in ref)
    top = max(float(ref[n].abs().max()) for n in ref)
    return err / top


def largest_scatter(main):
    """The output of the ZeRO-1 scatter (``zero_reduce_scatter`` or
    ``quant_reduce_scatter``) of the largest gradient: the word
    embedding's, this rank's flat shard of the sum."""
    block = main.global_block()
    ops = [op for op in block.ops
           if op.type in ("zero_reduce_scatter", "quant_reduce_scatter")]
    op = max(ops, key=lambda op: math.prod(
        block._find_var_recursive(op.inputs["X"][0]).shape))
    return op.outputs["Out"][0]


def zero_leg(torch, np, cfg, leg, feed, ckpt_dir, ref):
    """One leg of phase 15 on this rank: the startup (its global
    parameters' digest), ZERO_STEPS prepared steps counted from zero,
    (b)'s checkpoint after step ZERO_SAVE_AT, the held bytes against the
    layout, the digests, (a)'s parameters kept as ``ref`` or the leg's
    held against them ((b)'s first scattered word-embedding gradient
    likewise for (c), (d)), then one step with the gloo transfers
    timed."""
    from paddle_tpu_torch import fluid, io
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    dev = torch.device("cuda", fleet.place.device_id)
    out = {}
    if leg == "h":
        # the free plan first (no budget), then the budget halfway between
        # its peaks; the planning (and stamping) of the budgeted build
        # touches nothing on the card: no route decision, no launch, no
        # allocation
        build_zero_train(cfg, "h", None, feed)
        peaks = sorted(c.peak_bytes for c in fleet.plan.configs)
        budget = (peaks[0] + peaks[-1]) / 2 / float(1 << 30)
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated(dev)
        registry.reset_route_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        program, main, startup, total = build_zero_train(cfg, leg, budget,
                                                         feed)
        out["plan_s"] = time.perf_counter() - t0
        plan = fleet.plan
        out["plan_side_effects"] = {
            "routes": len(registry.route_counts()),
            "launches": sum(kernels.launch_counts().values()),
            "allocated_bytes": torch.cuda.memory_allocated(dev) - alloc0}
        out["budget_gb"] = budget
        out["free_peaks"] = peaks
        out["winner"] = plan.winner.layout.sizes
        out["plan_hashes"] = list(fleet._plan_hashes)
        out["plan"] = [{"layout": c.layout.sizes, "fits": c.fits,
                        "winner": c.winner, "peak_bytes": c.peak_bytes,
                        "wire_bytes": c.wire_bytes, "error": c.error}
                       for c in plan.configs]
    else:
        program, main, startup, total = build_zero_train(cfg, leg)
    steps = AUTO_STEPS if leg in AUTO_LEGS else ZERO_STEPS
    dp = program._dp
    check(dp is not None and dp.world == DP_RANKS,
          f"({leg}): the program does not run over {DP_RANKS} ranks")
    ops = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    out.update({"leg": leg, "ops": {t: ops.count(t) for t in (
        "zero_reduce_scatter", "quant_reduce_scatter", "zero_shard_slice",
        "zero_all_gather", "fsdp_all_gather", "c_fused_allreduce_sum",
        "c_global_norm_allreduce", "adamw")},
        "startup_params_sha256": params_digest(np, scope, main),
        "allocated_after_startup": torch.cuda.memory_allocated(dev)})
    est, state_in, written = memory_estimate(program, feed, total.name)
    out["estimate"] = {"state_bytes": est.state_bytes,
                       "peak_bytes": est.peak_bytes}
    torch.cuda.reset_peak_memory_stats(dev)
    scatter = largest_scatter(main) if leg in "bcd" else None
    norm = global_norm_name(main) if leg in AUTO_LEGS else None
    prepared = exe.prepare(program, fetch_list=[total] + (
        [scatter] if scatter else []) + ([norm] if norm else []),
        scope=scope, donate_state=True)
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, step_s = [], []
    first_step()
    for i in range(steps):
        t0 = time.perf_counter()
        got = prepared.run(feed)
        losses.append(float(got[0]))
        step_s.append(time.perf_counter() - t0)
        if norm and i == 0:
            out["step1_global_norm"] = float(got[-1].numpy().reshape(-1)[0])
        if scatter and i == 0:
            shard = got[1].value.detach().clone()
            if leg == "b":
                ref["scatter"] = shard
            else:
                out["scatter_gap_vs_b"] = float(
                    (shard - ref["scatter"]).norm() / ref["scatter"].norm())
            del shard
        if leg == "b" and i + 1 == ZERO_SAVE_AT:
            t0 = time.perf_counter()
            io.save_checkpoint(exe, ckpt_dir, io.TrainStatus(ZERO_SAVE_AT),
                               main, scope=scope)
            out["save_s"] = time.perf_counter() - t0
            stamp("saves", out["save_s"])
            out["saved_sha256"] = state_digests(np, scope, main)
    out["launches"] = {f"{k}/{dt}": n for (k, dt), n in
                       kernels.launch_counts_by_dtype().items()}
    out["fallbacks"] = {str(k): v for k, v in
                        registry.route_counts("fallback").items()}
    out["routes"] = {str(k): v for k, v in registry.route_counts().items()}
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    fluid.sync_prepared_state(scope)
    out["held"], out["predicted"], out["moment_bytes"], \
        out["param_bytes"] = held_bytes(torch, dp, scope, main)
    out["state_in_held"] = scope_bytes(torch, scope, state_in)
    out["left_out"] = left_out_bytes(torch, dp, scope, main, state_in,
                                     written)
    out["losses"], out["step_s"] = losses, step_s
    stamp("steps", sum(step_s))
    out["step_ms_median_3_6"] = statistics.median(step_s[2:]) * 1e3
    out["replicated_sha256"] = replicated_digest(np, dp, scope, main)
    params = global_params(dp, scope, main)
    if leg in ("a", "g"):
        ref[leg + "_params"], ref[leg + "_losses"] = params, losses
        if leg == "a":
            ref["params"], ref["losses"] = params, losses
    elif leg == "h":
        out["param_gap_vs_g"] = params_gap(torch, params, ref["g_params"])
        out["loss_gap_vs_g"] = max(abs(a - b) / abs(b) for a, b in
                                   zip(losses, ref["g_losses"]))
        del params
    else:
        out["param_gap_vs_a"] = params_gap(torch, params, ref["params"])
        out["loss_gap_vs_a"] = max(abs(a - b) / abs(b) for a, b in
                                   zip(losses, ref["losses"]))
        del params
    totals, undo = timed_collectives(torch)
    try:
        t0 = time.perf_counter()
        prepared.run(feed)[0].numpy()
        out["collectives_step_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    out["collectives_ms"] = totals["ms"]
    out["collective_calls"] = totals["calls"]
    del prepared, scope, exe
    torch.cuda.empty_cache()
    return out


def zero_restore(torch, np, cfg, feed, ckpt_dir, out_dir):
    """(f) after the other legs, in the same ranks: (b)'s program built
    afresh into a new ``Scope``, no startup, ``load_checkpoint`` of the
    checkpoint (b) saved after step ZERO_SAVE_AT read back from disk, the
    restored blocks' digests, then one step."""
    from paddle_tpu_torch import fluid, io
    from paddle_tpu_torch.distributed import fleet
    torch.cuda.empty_cache()
    program, main, _, total = build_zero_train(cfg, "b")
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    t0 = time.perf_counter()
    st = io.load_checkpoint(exe, ckpt_dir, main_program=main, scope=scope)
    out = {"load_s": time.perf_counter() - t0, "epoch": st.epoch_no,
           "restored_sha256": state_digests(np, scope, main)}
    stamp("loads", out["load_s"])
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    first_step()
    t0 = time.perf_counter()
    out["loss_after"] = float(prepared.run(feed)[0])
    out["guard"] = zero_guard_drill(torch, np, exe, program, main, scope,
                                    total, feed)
    stamp("steps", time.perf_counter() - t0)
    return out


def zero_worker(out_dir, legs):
    """One rank of phase 15 (``--zero-worker DIR LEGS``): the legs named
    by LEGS ("abcdeghf": (f) the restore of (b)'s checkpoint, last) in
    turn; writes ``zero<r>_<legs>.json``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    from paddle_tpu_torch.models import bert
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    check(fleet.backend == "gloo", f"rank {rank} on {fleet.backend}")
    cfg = cut_depth(bert.BertConfig.base())
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    ckpt_dir = os.path.join(out_dir, "ckpt")
    res = {"rank": rank, "place": repr(fleet.place)}
    ref = {}
    for leg in legs:
        if leg == "f":
            res["f"] = zero_restore(torch, np, cfg, feed, ckpt_dir, out_dir)
            continue
        res[leg] = zero_leg(torch, np, cfg, leg, feed, ckpt_dir, ref)
        log(f"[rank {rank}] ({leg}) losses "
            f"{[round(x, 5) for x in res[leg]['losses']]}, step ms "
            f"{res[leg]['step_ms_median_3_6']:.1f}, held "
            f"{res[leg]['held']} B (predicted "
            f"{res[leg]['predicted']})")
    res["stamps"] = dict(_STAMPS)
    with open(os.path.join(out_dir, f"zero{rank}_{legs}.json"), "w") as f:
        json.dump(res, f)
    return 0


def zero_launch(torch, repo, out_dir, legs, meanwhile=None):
    """Two ranks of this script on the card over gloo (phase 10's
    launcher); ``meanwhile()`` (host work of this process, nothing on the
    card) runs while they do.  Returns their JSON results."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(DP_RANKS), "--selected_gpus", "0,0",
           "--backend", "gloo", "--timeout", str(DP_TIMEOUT_S),
           os.path.join(repo, "chip_smoke.py"), "--zero-worker", out_dir,
           legs]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=repo, env=launch_env())
    try:
        if meanwhile is not None:
            meanwhile()
        rc = proc.wait(timeout=DP_TIMEOUT_S + 60)
    except BaseException:
        proc.terminate()              # the launcher forwards it to the ranks
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        raise
    wall = time.perf_counter() - t0
    log(f"  legs {legs}: the ranks ran {wall:.1f} s, exit code {rc}")
    check(rc == 0, f"phase 15 legs {legs}: a rank failed (exit code {rc})")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"zero{r}_{legs}.json")) as f:
            ranks.append(json.load(f))
    launch_line(f"phase 15 launch {legs}", ranks, wall)
    return ranks


def zero_expected(leg, adamw):
    """Launches a step by (kernel, operand dtype): phase 8's float32
    kernels at CUT_LAYERS layers and one Adam launch for the ``adamw``
    updates (flat shards in (b)-(d), dim-0 shards and replicated
    parameters in (e)); in (c) and (d) #11 once a parameter (the
    quantized scatter's receive stage on an int8 carrier), #12 never."""
    want = {f"{k}/float32": n for k, n in fused_launches(CUT_LAYERS).items()}
    if leg in ZERO_QUANT:
        want["dequant_accumulate/int8"] = adamw
    return want


def zero_adam_row(torch, results, cfg):
    """#10 at leg (b)'s shapes at full depth: the 158 flat shards of one
    rank of BERT-base's 12 layers (ceil(numel / (2 * 128)) * 128 elements
    each), adamw, one launch
    against the twin bit for bit, timed beside ``torch._fused_adamw_``
    over the same tensors."""
    from paddle_tpu_torch.ops.cuda import optimizer as O
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    randn = randn_on(torch, gen, dev)
    shards = [-(-math.prod(sh) // (DP_RANKS * 128)) * 128
              for sh in bert_base_param_shapes(cfg)]
    run = [O.AdamTensor(
        randn(n), randn(n), randn(n, scale=0.1), randn(n, scale=0.01).abs(),
        torch.tensor([PEAK_LR], device=dev),
        torch.tensor([0.9 ** 3], device=dev),
        torch.tensor([0.999 ** 3], device=dev), 0.9, 0.999, 1e-8,
        WEIGHT_DECAY) for n in shards]
    twin = [O.AdamTensor(*[t.clone() if torch.is_tensor(t) else t
                           for t in e]) for e in run]
    O.adam_multi(run)
    O.adam_multi_plain(twin)
    differ = sum(int((a[i] != b[i]).sum()) for a, b in zip(run, twin)
                 for i in (0, 2, 3))
    log(f"  #10 on the {len(shards)} flat shards of a rank: elements of p, "
        f"m, v that differ from the twin {differ} (must be 0)")
    check(differ == 0, "#10 on ZeRO-1 shards is not bit for bit its twin")
    total = sum(shards)
    args = [[e[i] for e in run] for i in range(4)]
    steps = [torch.tensor([1.0], device=dev) for _ in run]

    def lib():
        torch._fused_adamw_(*args, [], steps, lr=PEAK_LR, beta1=0.9,
                            beta2=0.999, weight_decay=WEIGHT_DECAY, eps=1e-8,
                            amsgrad=False, maximize=False)

    # CUDA events behind a 20 M-cycle GPU sleep (the run's 158-row table
    # takes the host ~2 ms to build); the profiler's device time beside
    # them, where it sees the kernels (it saw none for this run late in
    # the whole script)
    def events_ms(fn):
        return time_ms(torch, fn, samples=9, head_start=20_000_000)

    recorder(results)(
        "adam_zero1", [f"{len(shards)} flat shards of one rank of 2, adamw",
                       total], "float32", 0.0,
        events_ms(lambda: O.adam_multi(run)),
        time_ms(torch, lambda: O.adam_multi_plain(twin), samples=9),
        events_ms(lib), 28 * total, 12 * total,
        ms_from="CUDA events behind a 20 M-cycle GPU sleep",
        device_ms=sum(kernel_split_ms(
            torch, lambda: O.adam_multi(run)).values()) or None,
        library_device_ms=sum(kernel_split_ms(torch, lib).values()) or None,
        library_is="torch._fused_adamw_, one call", elements_differ=differ)


def static_plans(torch, np):
    """The auto-shard planner on the host (nothing on the card): BERT-base
    pretraining at 12 layers with phase 8's recipe planned for 2 and 4
    devices, and phase 20's MoE BERT-base (AdamW, no clip) for 2 with
    ``max_expert`` 2, at the 32 x 128 global batch, with the card's peak
    and the link figure; each ranking printed with its seconds.  No priced
    config may carry an error."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.shard_planner import plan_sharding
    from paddle_tpu_torch.models import bert
    out = {}
    for tag, cfg, nds, kw in (
            ("bert_base", bert.BertConfig.base(), (2, 4), {}),
            ("moe_bert_base", moe_config(DROPOUT), (2,),
             {"max_expert": 2})):
        unique_name.reset()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            _, total, _, _ = bert.build_pretrain_network(cfg)
            (zero_optimizer(fluid) if kw else
             recipe_optimizer(fluid)).minimize(total)
        feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                    TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
        for nd in nds:
            t0 = time.perf_counter()
            plan = plan_sharding(main, nd, loss_name=total.name,
                                 feed_shapes=feed, fetch_names=[total.name],
                                 **kw)
            secs = time.perf_counter() - t0
            log(f"  static plan, {tag} at {cfg.num_hidden_layers} layers on "
                f"{nd} devices ({secs:.2f} s of host time):")
            for line in plan.report().splitlines():
                log("    " + line)
            errors = [c.error for c in plan.configs if c.error]
            check(not errors, f"{tag} on {nd}: priced configs carry "
                              f"errors: {errors}")
            out[f"{tag}_{nd}"] = {
                "seconds": secs, "winner": plan.winner.layout.sizes,
                "configs": [{"layout": c.layout.sizes,
                             "peak_bytes": c.peak_bytes,
                             "wire_bytes": c.wire_bytes,
                             "cost_ms": c.cost_s * 1e3} for c in
                            plan.configs]}
    return out


def zero_phase(torch, np, repo, cfg, results):
    """Phase 15 (see the module docstring): the static plans, #10's shard
    row, legs (a)-(e), (g), (h) and then (f) in one launch of two ranks;
    returns the launches of rank 0 by leg and the report."""
    from paddle_tpu_torch.ops.cuda import build
    zero_adam_row(torch, results, cfg)
    out_dir = os.path.join(build.BUILD_DIR, "smoke_zero")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    plans = {}
    # the static plans are host work: they run while the ranks do
    ranks = zero_launch(torch, repo, out_dir, ZERO_LEGS + AUTO_LEGS + "f",
                        meanwhile=lambda: plans.update(static_plans(torch,
                                                                    np)))
    restored = ranks
    shutil.rmtree(out_dir, ignore_errors=True)
    report = {}
    for leg in ZERO_LEGS:
        rs = [r[leg] for r in ranks]
        what = f"({leg}) {ZERO_LEG_NAMES[leg]}"
        for r, m in enumerate(rs):
            who = f"{what} rank {r}"
            check(all(math.isfinite(x) for x in m["losses"]) and
                  m["losses"][-1] < m["losses"][0],
                  f"{who}: losses not finite and falling: {m['losses']}")
            check(not m["fallbacks"], f"{who}: fallbacks {m['fallbacks']}")
            want = zero_expected(leg, m["ops"]["adamw"])
            got = m["launches"]
            for key in set(want) | set(got):
                check(got.get(key, 0) == want.get(key, 0) * ZERO_STEPS,
                      f"{who}: {key} launched {got.get(key, 0)} times in "
                      f"{ZERO_STEPS} steps, expected {want.get(key, 0)} a "
                      f"step")
            check(m["held"] == m["predicted"],
                  f"{who}: the scope holds {m['held']} bytes of "
                  f"persistables, the layout predicts {m['predicted']}")
            check_estimate(who, m)
        for key in ("startup_params_sha256", "replicated_sha256"):
            check(rs[0][key] == rs[1][key],
                  f"{what}: {key} differs across the ranks")
        check(rs[0]["losses"] == rs[1]["losses"],
              f"{what}: the ranks fetched other losses")
        if leg != "a":
            tier = ZERO_QUANT.get(leg)
            bounds = {"loss_gap_vs_a": ZERO_QUANT_LOSS.get(tier,
                                                           TOL_ZERO_LOSS),
                      "param_gap_vs_a": ZERO_QUANT_PARAM.get(tier,
                                                             TOL_ZERO_PARAM)}
            if tier:
                bounds["scatter_gap_vs_b"] = ZERO_QUANT_SCATTER[tier]
            log(f"  {what}: " + "; ".join(
                f"{key} {max(m[key] for m in rs):.3e} (tolerance {bound})"
                for key, bound in bounds.items()))
            for key, bound in bounds.items():
                for r, m in enumerate(rs):
                    check(m[key] <= bound,
                          f"{what} rank {r}: {key} {m[key]:.3e} over "
                          f"{bound}")
        a = ranks[0]["a"]
        m = rs[0]
        log(f"  {what}: step {m['step_ms_median_3_6']:.2f} ms (median of "
            f"steps 3-{ZERO_STEPS}), gloo {m['collectives_ms']:.2f} ms in "
            f"{m['collective_calls']} calls of a "
            f"{m['collectives_step_ms']:.2f} ms step (gloo staged through "
            f"the host, two ranks on one card: no measure of NVLink); "
            f"persistent {m['held'] / 1e9:.4f} GB a rank (moments "
            f"{m['moment_bytes'] / 1e9:.4f} GB, parameters "
            f"{m['param_bytes'] / 1e9:.4f} GB; (a) "
            f"{a['held'] / 1e9:.4f} GB), peak allocated "
            f"{m['peak_bytes'] / 1e9:.3f} GB")
        report[leg] = {k: m[k] for k in (
            "losses", "step_ms_median_3_6", "collectives_ms",
            "collective_calls", "collectives_step_ms", "held",
            "moment_bytes", "param_bytes", "peak_bytes", "ops")}
        report[leg].update({k: m[k] for k in (
            "loss_gap_vs_a", "param_gap_vs_a", "scatter_gap_vs_b",
            "save_s") if k in m})
    report.update(auto_report(ranks))
    report["static_plans"] = plans
    b, e = ranks[0]["b"], ranks[0]["e"]
    a = ranks[0]["a"]
    check(b["moment_bytes"] * 2 <= a["moment_bytes"] + 2 * 128 * 4 *
          a["ops"]["adamw"] * 2, "(b): the moments a rank holds are not "
          "half")
    check(e["param_bytes"] < a["param_bytes"],
          "(e): the parameters a rank holds are not sharded")
    saved = [r["b"]["saved_sha256"] for r in ranks]
    for r, f in enumerate(restored):
        got = f["f"]["restored_sha256"]
        differ = sorted(n for n in saved[r] if got.get(n) != saved[r][n])
        log(f"  (f) rank {r}: load_checkpoint {f['f']['load_s']:.2f} s, "
            f"{len(saved[r])} persistables, restored blocks that differ "
            f"from the saved ones {len(differ)} (must be 0); a step after "
            f"it: loss {f['f']['loss_after']:.5f}")
        check(not differ, f"(f) rank {r}: restored blocks differ: "
                          f"{differ[:5]}")
        check(f["f"]["epoch"] == ZERO_SAVE_AT and
              math.isfinite(f["f"]["loss_after"]),
              f"(f) rank {r}: epoch {f['f']['epoch']}, loss "
              f"{f['f']['loss_after']}")
    guards = [r["f"]["guard"] for r in restored]
    log(f"  (f) guarded, a NaN gradient on rank 1 only at guard step 1: "
        f"skip totals {[g['skip_trace'] for g in guards]}, state kept "
        f"across the skipped step {[g['kept'] for g in guards]}, "
        f"replicated sha256 equal across the ranks "
        f"{guards[0]['replicated_sha256'] == guards[1]['replicated_sha256']}")
    for r, g in enumerate(guards):
        check(g["skip_trace"] == [0, 1, 1] and g["kept"] and
              all(math.isfinite(x) for x in g["losses"]),
              f"(f) rank {r}: the guard drill {g}")
    check(guards[0]["replicated_sha256"] == guards[1]["replicated_sha256"],
          "(f) guard drill: the replicas differ after the skipped step")
    OBS_REPORT["phase15"] = {"skip_trace": guards[0]["skip_trace"],
                             "replicas_equal": True}
    report["f"] = {"save_s": ranks[0]["b"]["save_s"],
                   "load_s": restored[0]["f"]["load_s"],
                   "loss_after": restored[0]["f"]["loss_after"]}
    launches = {f"zero_{leg}": {k.split("/")[0]: v for k, v in
                                ranks[0][leg]["launches"].items()}
                for leg in ZERO_LEGS + AUTO_LEGS}
    return launches, report


def check_estimate(who, m):
    """The static estimate of a rank's persistent state equals the bytes
    its scope holds of the persistables the estimate prices, and, with the
    persistables it leaves out (each one the step writes before it reads
    it), the layout's formula over every persistable the scope holds; the
    peak is printed beside the measured one, its ratio recorded without a
    gate (the transient model was fitted to XLA's buffer assignment, and
    the executor keeps a run's values to its end)."""
    est = m["estimate"]
    left = m["left_out"]
    log(f"  {who}: persistables outside the estimate's state (written "
        f"before they are read): {sorted(left)}, "
        f"{sum(b for b, _ in left.values())} B")
    log(f"  {who}: estimate {est['state_bytes'] / 1e9:.4f} GB persistent "
        f"(held {m['state_in_held'] / 1e9:.4f} GB of those persistables; "
        f"{m['allocated_after_startup'] / 1e9:.4f} GB allocated after the "
        f"startup), peak {est['peak_bytes'] / 1e9:.4f} GB against "
        f"max_memory_allocated {m['peak_bytes'] / 1e9:.4f} GB (ratio "
        f"{m['peak_bytes'] / est['peak_bytes']:.3f})")
    check(est["state_bytes"] == m["state_in_held"],
          f"{who}: estimated persistent bytes {est['state_bytes']}, the "
          f"scope holds {m['state_in_held']}")
    unwritten = sorted(n for n, (_, w) in left.items() if not w)
    check(not unwritten, f"{who}: the estimate leaves out persistables "
                         f"the step never writes: {unwritten}")
    check(est["state_bytes"] + sum(b for b, _ in left.values()) ==
          m["predicted"],
          f"{who}: estimated persistent bytes {est['state_bytes']} and "
          f"{sum(b for b, _ in left.values())} left out, the layout's "
          f"formula over every persistable held {m['predicted']}")


def auto_report(ranks):
    """(g) and (h) of phase 15: the gates of fleet's auto_shard on the
    card, and their report."""
    report = {}
    for leg in AUTO_LEGS:
        rs = [r[leg] for r in ranks]
        what = f"({leg}) {AUTO_LEG_NAMES[leg]}"
        for r, m in enumerate(rs):
            who = f"{what} rank {r}"
            check(all(math.isfinite(x) for x in m["losses"]) and
                  m["losses"][-1] < m["losses"][0],
                  f"{who}: losses not finite and falling: {m['losses']}")
            check(not m["fallbacks"], f"{who}: fallbacks {m['fallbacks']}")
            want = zero_expected("e", m["ops"]["adamw"])
            got = m["launches"]
            for key in set(want) | set(got):
                check(got.get(key, 0) == want.get(key, 0) * AUTO_STEPS,
                      f"{who}: {key} launched {got.get(key, 0)} times in "
                      f"{AUTO_STEPS} steps, expected {want.get(key, 0)} a "
                      f"step (as (e) launches)")
            check(m["held"] == m["predicted"],
                  f"{who}: the scope holds {m['held']} bytes of "
                  f"persistables, the layout predicts {m['predicted']}")
            check(m["step1_global_norm"] > CLIP_NORM,
                  f"{who}: step 1's global norm {m['step1_global_norm']} "
                  f"does not exceed the clip {CLIP_NORM}: it does not bind")
            check_estimate(who, m)
        check(rs[0]["losses"] == rs[1]["losses"],
              f"{what}: the ranks fetched other losses")
        check(rs[0]["step1_global_norm"] == rs[1]["step1_global_norm"],
              f"{what}: the ranks clip by other norms")
        report[leg] = {k: rs[0][k] for k in (
            "losses", "step_ms_median_3_6", "collectives_ms",
            "collective_calls", "held", "peak_bytes", "estimate",
            "allocated_after_startup", "step1_global_norm", "ops")}
    h = [r["h"] for r in ranks]
    for r, m in enumerate(h):
        who = f"(h) rank {r}"
        check(m["winner"] == {"dp": 1, "fsdp": DP_RANKS, "tp": 1},
              f"{who}: the planner's winner is {m['winner']}, not fsdp "
              f"{DP_RANKS}")
        check(len(set(m["plan_hashes"])) == 1 and
              len(m["plan_hashes"]) == DP_RANKS,
              f"{who}: the ranks' plan hashes differ: {m['plan_hashes']}")
        check(not [c for c in m["plan"] if c["error"]],
              f"{who}: a priced config carries an error: {m['plan']}")
        check(m["plan_side_effects"] == {"routes": 0, "launches": 0,
                                         "allocated_bytes": 0},
              f"{who}: planning touched the card: "
              f"{m['plan_side_effects']}")
        check(m["ops"]["c_global_norm_allreduce"] == 1,
              f"{who}: the clip's norm is not summed over fsdp")
        for key, bound in (("loss_gap_vs_g", TOL_ZERO_LOSS),
                           ("param_gap_vs_g", TOL_ZERO_PARAM)):
            check(m[key] <= bound,
                  f"{who}: {key} {m[key]:.3e} over {bound}")
    check(h[0]["plan_hashes"] == h[1]["plan_hashes"],
          "(h): the ranks gathered other plan hashes")
    m = h[0]
    log(f"  (h) auto_shard: budget {m['budget_gb']:.4f} GiB (halfway "
        f"between the free plan's peaks {m['free_peaks']}), winner "
        f"{m['winner']}, plan hashes equal on both ranks, planning and "
        f"stamping {m['plan_s']:.2f} s of host time with no route "
        f"decision, no launch and no allocation on the card; vs (g): "
        f"losses {m['loss_gap_vs_g']:.3e} (tolerance {TOL_ZERO_LOSS}), "
        f"parameters {m['param_gap_vs_g']:.3e} (tolerance "
        f"{TOL_ZERO_PARAM}); step-1 global norm "
        f"{m['step1_global_norm']:.4f} (clip {CLIP_NORM}); step "
        f"{m['step_ms_median_3_6']:.2f} ms against (g)'s "
        f"{ranks[0]['g']['step_ms_median_3_6']:.2f} ms")
    report["h"].update({k: m[k] for k in (
        "budget_gb", "free_peaks", "winner", "plan_s", "loss_gap_vs_g",
        "param_gap_vs_g", "plan")})
    return report


# ---------------------------------------------------------------------------
# phase 16: HSDP (data x fsdp) on four ranks, sharded checkpoints, reshard
# ---------------------------------------------------------------------------

#: phase 16: four ranks of the card over gloo, each its 8 rows of the
#: 32 x 128 batch, dropout 0.  (a) dp4, fp32 all-reduce (the yardstick);
#: (b) HSDP data 2 x fsdp 2; (c) (b)'s state after step 3 through
#: ``save_checkpoint(sharded=True)`` and ``AsyncCheckpointer``; (d) the
#: same four ranks, after (b), restore (c) onto fsdp 4 in a freshly built
#: program and scope, (e) two fresh ranks onto data 2 (plain data
#: parallelism), each then steps 4-6
HSDP_RANKS = 4
HSDP_LEG_NAMES = {"a": "dp4, fp32 all-reduce", "b": "HSDP data 2 x fsdp 2",
                  "d": "(c) restored onto fsdp 4",
                  "e": "(c) restored onto data 2"}
HSDP_LAYOUTS = {"b": {"data": 2, "fsdp": 2}, "d": {"fsdp": 4},
                "e": {"data": 2}}
HSDP_STEPS, HSDP_SAVE_AT = 6, 3
TOL_HSDP_LOSS = 1e-4      # (b) vs (a); (d), (e) vs (b): losses (relative)
TOL_HSDP_PARAM = 1e-4     # (b) vs (a): parameters, of max|p|
HSDP_TIMEOUT_S = 600


def hsdp_config(cfg):
    """Phase 16's model: BERT-base uncut, dropout 0."""
    import copy
    cfg = copy.copy(cfg)
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def build_hsdp_train(cfg, leg):
    """Phase 16's program for ``leg`` as a rank writes it: phase 15's (a)
    program through ``fleet`` for (a); for the others the recipe of
    :func:`zero_optimizer` minimized, ``apply_fsdp_sharding`` over the
    leg's ``MeshLayout`` (a no-op without an fsdp axis), the layout
    stamped on the program and ``CompiledProgram.with_mesh`` with
    bucketed gradient sync.  Returns (the program to run, main, startup,
    loss)."""
    if leg == "a":
        return build_zero_train(cfg, "a")
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        zero_optimizer(fluid).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    layout = MeshLayout(**HSDP_LAYOUTS[leg])
    apply_fsdp_sharding(main, layout)
    main._mesh_layout = layout
    build = fluid.BuildStrategy()
    build.fuse_elewise_add_act_ops = True
    build.fuse_all_reduce_ops = True
    program = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=total.name,
        batch_axis=layout.batch_axes, build_strategy=build)
    return program, main, startup, total


def global_digests(np, dp, scope, main):
    """sha256 of every persistable's global value (a sharded one's blocks
    gathered over its axes: a collective, so every rank calls it)."""
    import hashlib
    from paddle_tpu_torch.ops.collective_ops import whole_of
    out = {}
    for v in sorted(main.list_vars(), key=lambda v: v.name):
        t = scope.find_var(v.name) if v.persistable else None
        if t is None or not hasattr(t, "detach"):
            continue
        g = whole_of(dp, v, t)
        out[v.name] = hashlib.sha256(
            g.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
        del g
    return out


def hsdp_steps(torch, prepared, feed, steps, out):
    """``steps`` prepared steps with the launch and route counts set to 0
    first: the losses and step seconds; the launches by (kernel, dtype)
    and the fallbacks into ``out``."""
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, step_s = [], []
    first_step()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(prepared.run(feed)[0]))
        step_s.append(time.perf_counter() - t0)
    stamp("steps", sum(step_s))
    out["launches"] = {f"{k}/{dt}": n for (k, dt), n in
                       kernels.launch_counts_by_dtype().items()}
    out["fallbacks"] = {str(k): v for k, v in
                        registry.route_counts("fallback").items()}
    return losses, step_s


def hsdp_collectives(torch, prepared, feed, out):
    """One more step with the gloo transfers timed."""
    totals, undo = timed_collectives(torch)
    try:
        t0 = time.perf_counter()
        prepared.run(feed)[0].numpy()
        out["collectives_step_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    out["collectives_ms"] = totals["ms"]
    out["collective_calls"] = totals["calls"]


def hsdp_leg(torch, np, cfg, leg, feed, out_dir, ref):
    """Leg (a) or (b) on this rank: the startup, HSDP_STEPS prepared steps
    ((b) saves after step HSDP_SAVE_AT: (c)), the held bytes against the
    layout, (a)'s losses and parameters kept in ``ref`` or (b)'s held
    against them, then one step with the gloo transfers timed."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    dev = torch.device("cuda", fleet.place.device_id)
    program, main, startup, total = build_hsdp_train(cfg, leg)
    dp = program._dp
    check(dp is not None and dp.world == HSDP_RANKS,
          f"({leg}): the program does not run over {HSDP_RANKS} ranks")
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    ops = [op.type for op in main.global_block().ops]
    torch.cuda.synchronize()
    out = {"leg": leg, "ops": {t: ops.count(t) for t in (
        "fsdp_all_gather", "c_fused_allreduce_sum", "c_allreduce_sum",
        "adamw")}, "allocated_after_startup": torch.cuda.memory_allocated(
            dev)}
    est, state_in, written = memory_estimate(program, feed, total.name)
    out["estimate"] = {"state_bytes": est.state_bytes,
                       "peak_bytes": est.peak_bytes}
    torch.cuda.reset_peak_memory_stats(dev)
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    first, s1 = hsdp_steps(torch, prepared, feed, HSDP_SAVE_AT, out)
    launches = dict(out["launches"])
    if leg == "b":
        out.update(hsdp_save(torch, np, exe, dp, main, scope, out_dir))
    rest, s2 = hsdp_steps(torch, prepared, feed, HSDP_STEPS - HSDP_SAVE_AT,
                          out)
    for k, n in launches.items():
        out["launches"][k] = out["launches"].get(k, 0) + n
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["losses"], out["step_s"] = first + rest, s1 + s2
    out["step_ms_median_3_6"] = statistics.median(out["step_s"][2:]) * 1e3
    fluid.sync_prepared_state(scope)
    out["held"], out["predicted"], out["moment_bytes"], \
        out["param_bytes"] = held_bytes(torch, dp, scope, main)
    out["state_in_held"] = scope_bytes(torch, scope, state_in)
    out["left_out"] = left_out_bytes(torch, dp, scope, main, state_in,
                                     written)
    params = global_params(dp, scope, main)
    if leg == "a":
        ref["params"], ref["losses"] = params, out["losses"]
    else:
        out["param_gap_vs_a"] = params_gap(torch, params, ref["params"])
        out["loss_gap_vs_a"] = max(abs(a - b) / abs(b) for a, b in
                                   zip(out["losses"], ref["losses"]))
    del params
    hsdp_collectives(torch, prepared, feed, out)
    del prepared, scope, exe
    torch.cuda.empty_cache()
    return out


def hsdp_save(torch, np, exe, dp, main, scope, out_dir):
    """(c) on this rank, after (b)'s step HSDP_SAVE_AT: the global state's
    digests and bytes, ``save_checkpoint(sharded=True)`` under ``ckpt``
    and the same state through ``AsyncCheckpointer`` under ``async``: the
    seconds the sharded save takes, this rank's bytes written, the
    seconds ``save()`` blocks and the seconds until ``wait()``, called
    right after it, returns (the whole write)."""
    from paddle_tpu_torch import fluid, io
    fluid.sync_prepared_state(scope)
    out = {"saved_sha256": global_digests(np, dp, scope, main),
           "state_bytes": sum(
               math.prod(v.shape) * scope.find_var(v.name).element_size()
               for v in main.list_vars() if v.persistable and
               hasattr(scope.find_var(v.name), "element_size"))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = io.save_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                           io.TrainStatus(HSDP_SAVE_AT), main, scope=scope,
                           sharded=True)
    out["save_s"] = time.perf_counter() - t0
    out["written_bytes"] = sum(
        os.path.getsize(os.path.join(d, f"{stem}_{dp.rank}.{ext}"))
        for stem, ext in (("shard_data", "npz"), ("shard_manifest", "json"),
                          ("torch_rng", "npz")))
    ck = io.AsyncCheckpointer()
    t0 = time.perf_counter()
    ck.save(exe, os.path.join(out_dir, "async"),
            io.TrainStatus(HSDP_SAVE_AT), main, scope=scope)
    out["async_block_s"] = time.perf_counter() - t0
    ck.wait()
    out["async_whole_s"] = time.perf_counter() - t0
    stamp("saves", out["save_s"] + out["async_whole_s"])
    fluid.sync_prepared_state(scope)
    return out


def hsdp_restore(torch, np, cfg, leg, feed, out_dir):
    """(d) after (a) and (b) in their four ranks, or (e) on two fresh
    ranks: the leg's program built afresh into a new ``Scope``, no
    startup, ``load_checkpoint`` of (c)'s sharded checkpoint read back
    from disk onto its layout (the seconds, the bytes this rank read
    against its planned bytes, the reshard's wire bytes), the restored
    global state's digests, then steps HSDP_SAVE_AT + 1 to HSDP_STEPS."""
    from paddle_tpu_torch import fluid, io
    from paddle_tpu_torch.distributed import fleet
    torch.cuda.empty_cache()
    dev = torch.device("cuda", fleet.place.device_id)
    program, main, _, total = build_hsdp_train(cfg, leg)
    dp = program._dp
    exe = fluid.Executor(fleet.place)
    fault = None
    if leg == "d":
        # a fault between two per-var transfers of the restore: it raises
        # on every rank, and the restore below is the second one
        from paddle_tpu_torch.framework import reshard
        from paddle_tpu_torch.testing import faultline
        reshard.arm_fault(action="raise")
        try:
            io.load_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                               main_program=main, scope=fluid.Scope())
        except faultline.FaultlineError as e:
            fault = type(e).__name__
        finally:
            faultline.disarm()
    scope = fluid.Scope()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = io.load_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                            main_program=main, scope=scope)
    torch.cuda.synchronize()
    out = {"leg": leg, "load_s": time.perf_counter() - t0,
           "epoch": st.epoch_no,
           "bytes_read": st.read_stats["bytes_read"],
           "planned_bytes": st.read_stats["planned_bytes"],
           "wire_bytes": st.reshard["wire_bytes"] if st.reshard else None,
           "reshard_steps": st.reshard["steps_by_kind"] if st.reshard
           else None,
           "restored_sha256": global_digests(np, dp, scope, main),
           "fault": fault}
    stamp("loads", out["load_s"])
    torch.cuda.reset_peak_memory_stats(dev)
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    out["losses"], out["step_s"] = hsdp_steps(
        torch, prepared, feed, HSDP_STEPS - HSDP_SAVE_AT, out)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    fluid.sync_prepared_state(scope)
    out["held"], out["predicted"], out["moment_bytes"], \
        out["param_bytes"] = held_bytes(torch, dp, scope, main)
    hsdp_collectives(torch, prepared, feed, out)
    return out


def hsdp_worker(out_dir, legs):
    """One rank of phase 16 (``--hsdp-worker DIR LEGS``): legs "abd" on
    four ranks ((d) the restore of (c), last), "e" on two; writes
    ``hsdp<r>_<legs>.json``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    from paddle_tpu_torch.models import bert
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    check(fleet.backend == "gloo", f"rank {rank} on {fleet.backend}")
    cfg = hsdp_config(cut_depth(bert.BertConfig.base()))
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    res = {"rank": rank, "world": fleet.worker_num()}
    ref = {}
    for leg in legs:
        if leg in ("d", "e"):
            res[leg] = hsdp_restore(torch, np, cfg, leg, feed, out_dir)
        else:
            res[leg] = hsdp_leg(torch, np, cfg, leg, feed, out_dir, ref)
    for leg in legs:
        m = res[leg]
        log(f"[rank {rank}] ({leg}) losses "
            f"{[round(x, 5) for x in m['losses']]}, held {m['held']} B "
            f"(predicted {m['predicted']})")
    res["stamps"] = dict(_STAMPS)
    with open(os.path.join(out_dir, f"hsdp{rank}_{legs}.json"), "w") as f:
        json.dump(res, f)
    return 0


def hsdp_launch(torch, repo, out_dir, nproc, legs):
    """``nproc`` ranks of this script on the card over gloo; returns their
    JSON results."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--selected_gpus", ",".join(["0"] * nproc),
           "--backend", "gloo", "--timeout", str(HSDP_TIMEOUT_S),
           os.path.join(repo, "chip_smoke.py"), "--hsdp-worker", out_dir,
           legs]
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=repo, timeout=HSDP_TIMEOUT_S + 60,
                        env=launch_env()).returncode
    wall = time.perf_counter() - t0
    log(f"  legs {legs} on {nproc} ranks: ran {wall:.1f} s, exit code {rc}")
    check(rc == 0, f"phase 16 legs {legs}: a rank failed (exit code {rc})")
    ranks = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"hsdp{r}_{legs}.json")) as f:
            ranks.append(json.load(f))
    launch_line(f"phase 16 launch {legs}", ranks, wall)
    return ranks


def check_hsdp_rank(what, m, steps):
    """The gates every rank of every leg meets: finite losses, no
    fallback, phase 8's launches of #1-#10 a step at CUT_LAYERS layers,
    the held bytes the layout's."""
    check(all(math.isfinite(x) for x in m["losses"]),
          f"{what}: losses not finite: {m['losses']}")
    check(not m["fallbacks"], f"{what}: fallbacks {m['fallbacks']}")
    want = {f"{k}/float32": n for k, n in fused_launches(CUT_LAYERS).items()}
    got = m["launches"]
    for key in set(want) | set(got):
        check(got.get(key, 0) == want.get(key, 0) * steps,
              f"{what}: {key} launched {got.get(key, 0)} times in {steps} "
              f"steps, expected {want.get(key, 0)} a step")
    check(m["held"] == m["predicted"],
          f"{what}: the scope holds {m['held']} bytes of persistables, the "
          f"layout predicts {m['predicted']}")
    if "estimate" in m:
        check_estimate(what, m)


def shard_coverage(ckpt):
    """(elements each persistable's blocks cover, summed over every
    rank's shard manifest, the global elements, blocks listed twice) of a
    sharded checkpoint."""
    covered, total, seen, twice = {}, {}, set(), []
    for fn in sorted(os.listdir(ckpt)):
        if not fn.startswith("shard_manifest_"):
            continue
        with open(os.path.join(ckpt, fn)) as f:
            for name, rec in json.load(f)["vars"].items():
                total[name] = math.prod(rec["shape"])
                for e in rec["shards"]:
                    key = (name, json.dumps(e["index"]))
                    if key in seen:
                        twice.append(key)
                    seen.add(key)
                    covered[name] = covered.get(name, 0) + (
                        total[name] if e["index"] is None else
                        math.prod(b - a for a, b in e["index"]))
    return covered, total, twice


def hsdp_phase(torch, np, repo):
    """Phase 16 (see the module docstring); returns rank 0's launches by
    leg and the report."""
    from paddle_tpu_torch.ops.cuda import build
    out_dir = os.path.join(build.BUILD_DIR, "smoke_hsdp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        trained = hsdp_launch(torch, repo, out_dir, HSDP_RANKS, "abd")
        ckpt = os.path.join(out_dir, "ckpt", f"checkpoint_{HSDP_SAVE_AT}")
        copy = os.path.join(out_dir, "async", f"checkpoint_{HSDP_SAVE_AT}")
        report = {"c": hsdp_saved(trained, ckpt, copy)}
        restored = {"d": trained,
                    "e": hsdp_launch(torch, repo, out_dir, 2, "e")}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    faults = [r["d"]["fault"] for r in trained]
    log(f"  (d) reshard_execute armed during a first restore: raised "
        f"{faults} on the {len(faults)} ranks; the second restore's gates "
        f"follow")
    check(faults == ["FaultlineError"] * len(trained),
          f"(d) the reshard drill raised {faults}")
    OBS_REPORT["phase16"] = {"fault_raised": faults}
    report.update(hsdp_report(trained, restored))
    launches = {f"hsdp_{leg}": {k.split("/")[0]: v for k, v in
                                trained[0][leg]["launches"].items()}
                for leg in "ab"}
    launches.update({f"hsdp_{leg}": {k.split("/")[0]: v for k, v in
                                     ranks[0][leg]["launches"].items()}
                     for leg, ranks in restored.items()})
    return launches, report


def hsdp_saved(trained, ckpt, copy):
    """(c)'s gates: both checkpoints verify, every block of every
    persistable written once and the blocks covering it whole, the
    AsyncCheckpointer copy's shard files those of the sharded save."""
    from paddle_tpu_torch import io
    bs = [r["b"] for r in trained]
    saved = bs[0]["saved_sha256"]
    check(all(m["saved_sha256"] == saved for m in bs),
          "(c): the ranks gathered other global states")
    for d in (ckpt, copy):
        ok, why = io.validate_checkpoint_dir(d)
        check(ok, f"(c): {d} does not verify: {why}")
    covered, total, twice = shard_coverage(ckpt)
    check(not twice, f"(c): blocks written twice: {twice[:3]}")
    check(set(total) == set(saved) and covered == total,
          "(c): the blocks do not cover each persistable once: "
          f"{sorted(n for n in total if covered[n] != total[n])[:5]}")
    files = {d: io._read_manifest(d)["files"] for d in (ckpt, copy)}
    shards = sorted(f for f in files[ckpt] if f.startswith("shard_"))
    check(shards and all(files[ckpt][f] == files[copy].get(f)
                         for f in shards),
          "(c): AsyncCheckpointer's files differ from the sharded save's")
    payload = sum(os.path.getsize(os.path.join(ckpt, f)) for f in shards
                  if f.startswith("shard_data_"))
    written = [m["written_bytes"] for m in bs]
    log(f"  (c) sharded save: {max(m['save_s'] for m in bs):.2f} s (the "
        f"slowest rank), {sum(written) / 1e9:.4f} GB written by the "
        f"{len(bs)} ranks ({', '.join(map(str, written))} B), shard "
        f"payload {payload / 1e9:.4f} GB for a state of "
        f"{bs[0]['state_bytes'] / 1e9:.4f} GB, every block once; "
        f"AsyncCheckpointer.save() blocked "
        f"{max(m['async_block_s'] for m in bs):.2f} s of a "
        f"{max(m['async_whole_s'] for m in bs):.2f} s write")
    return {"save_s": [m["save_s"] for m in bs], "written_bytes": written,
            "payload_bytes": payload, "state_bytes": bs[0]["state_bytes"],
            "async_block_s": [m["async_block_s"] for m in bs],
            "async_whole_s": [m["async_whole_s"] for m in bs]}


def hsdp_report(trained, restored):
    """Phase 16's gates of legs (a), (b), (d) and (e), and their printed
    figures."""
    report = {}
    for leg in "ab":
        rs = [r[leg] for r in trained]
        what = f"({leg}) {HSDP_LEG_NAMES[leg]}"
        for r, m in enumerate(rs):
            check_hsdp_rank(f"{what} rank {r}", m, HSDP_STEPS)
        check(all(m["losses"] == rs[0]["losses"] for m in rs),
              f"{what}: the ranks fetched other losses")
        if leg == "b":
            for key, bound in (("loss_gap_vs_a", TOL_HSDP_LOSS),
                               ("param_gap_vs_a", TOL_HSDP_PARAM)):
                gap = max(m[key] for m in rs)
                log(f"  {what}: {key} {gap:.3e} (tolerance {bound})")
                check(gap <= bound, f"{what}: {key} {gap:.3e} over {bound}")
        m, a = rs[0], trained[0]["a"]
        log(f"  {what}: step {m['step_ms_median_3_6']:.2f} ms (median of "
            f"steps 3-{HSDP_STEPS}), gloo {m['collectives_ms']:.2f} ms in "
            f"{m['collective_calls']} calls of a "
            f"{m['collectives_step_ms']:.2f} ms step (gloo staged through "
            f"the host, four ranks on one card); persistent "
            f"{m['held'] / 1e9:.4f} GB a rank (moments "
            f"{m['moment_bytes'] / 1e9:.4f} GB, parameters "
            f"{m['param_bytes'] / 1e9:.4f} GB; (a) {a['held'] / 1e9:.4f} "
            f"GB), peak allocated {m['peak_bytes'] / 1e9:.3f} GB")
        report[leg] = {k: m[k] for k in (
            "losses", "step_ms_median_3_6", "collectives_ms",
            "collective_calls", "collectives_step_ms", "held",
            "moment_bytes", "param_bytes", "peak_bytes", "ops")}
        report[leg].update({k: m[k] for k in (
            "loss_gap_vs_a", "param_gap_vs_a") if k in m})
    saved = trained[0]["b"]["saved_sha256"]
    b_after = trained[0]["b"]["losses"][HSDP_SAVE_AT:]
    for leg, ranks in restored.items():
        what = f"({leg}) {HSDP_LEG_NAMES[leg]}"
        for r, res in enumerate(ranks):
            m = res[leg]
            who = f"{what} rank {r}"
            check_hsdp_rank(who, m, HSDP_STEPS - HSDP_SAVE_AT)
            differ = sorted(n for n in saved
                            if m["restored_sha256"].get(n) != saved[n])
            check(m["epoch"] == HSDP_SAVE_AT and not differ and
                  set(m["restored_sha256"]) == set(saved),
                  f"{who}: epoch {m['epoch']}, restored global state "
                  f"differs from (c)'s: {differ[:5]}")
            check(m["bytes_read"] == m["planned_bytes"],
                  f"{who}: read {m['bytes_read']} bytes, planned "
                  f"{m['planned_bytes']}")
            m["loss_gap_vs_b"] = max(abs(x - y) / abs(y) for x, y in
                                     zip(m["losses"], b_after))
            check(m["loss_gap_vs_b"] <= TOL_HSDP_LOSS,
                  f"{who}: steps {HSDP_SAVE_AT + 1}-{HSDP_STEPS} "
                  f"{m['losses']} vs (b)'s {b_after}: "
                  f"{m['loss_gap_vs_b']:.3e}")
        m = ranks[0][leg]
        m["step_ms_median"] = statistics.median(m["step_s"]) * 1e3
        log(f"  {what}: load_checkpoint {m['load_s']:.2f} s, read "
            f"{m['bytes_read'] / 1e9:.4f} GB a rank (planned "
            f"{m['planned_bytes'] / 1e9:.4f} GB), reshard wire "
            f"{(m['wire_bytes'] or 0) / 1e9:.4f} GB {m['reshard_steps']}; "
            f"the restored state bit for bit (c)'s; steps "
            f"{HSDP_SAVE_AT + 1}-{HSDP_STEPS} within "
            f"{max(r[leg]['loss_gap_vs_b'] for r in ranks):.3e} of (b)'s; "
            f"step {m['step_ms_median']:.2f} ms, gloo "
            f"{m['collectives_ms']:.2f} ms in {m['collective_calls']} calls; "
            f"persistent {m['held'] / 1e9:.4f} GB a rank, peak "
            f"{m['peak_bytes'] / 1e9:.3f} GB")
        report[leg] = {k: m[k] for k in (
            "load_s", "bytes_read", "planned_bytes", "wire_bytes",
            "reshard_steps", "losses", "loss_gap_vs_b", "held",
            "peak_bytes", "step_ms_median", "collectives_ms",
            "collective_calls")}
        report[leg]["ranks"] = len(ranks)
    check(restored["d"][0]["d"]["held"] < trained[0]["b"]["held"],
          "(d): fsdp 4 holds no less a rank than HSDP's fsdp 2")
    return report


# ---------------------------------------------------------------------------
# phase 17: overlap_grad_sync, and a preemption drill, on two ranks
# ---------------------------------------------------------------------------

#: phase 17: two ranks of the card over gloo, each its 16 of phase 8's
#: 32 x 128 rows, phase 8's program and recipe through fleet (phase 10's
#: launcher).  Legs: (a) the classic tail-fused program (fp32 buckets at
#: the 32 MB cap), (b) overlap_grad_sync at bucket_mb 4, min_buckets 4,
#: (c) (b) with overlap_lowering off (the same buckets at the tail), (d)
#: (b) in the int8 tier, (e) (d) with lowering off, (f) overlap at
#: bucket_mb 32
OVERLAP_LEGS = "abcdef"
OVERLAP_LEG_NAMES = {"a": "classic tail-fused", "b": "overlap, bucket_mb 4",
                     "c": "overlap, overlap_lowering off",
                     "d": "int8 overlap", "e": "int8 overlap, lowering off",
                     "f": "overlap, bucket_mb 32"}
OVERLAP_STEPS = 6
OVERLAP_TIMEOUT_S = 600
#: the preemption drill: phase 15's ZeRO-3 leg (e) under a
#: PreemptionHandler with an AsyncCheckpointer; SIGTERM to the launcher
#: after step PREEMPT_AT of PREEMPT_STEPS
PREEMPT_STEPS, PREEMPT_AT = 6, 3
PREEMPT_MARK = "PREEMPT-STEP"


def build_overlap_train(cfg, leg):
    """Phase 17's program for ``leg`` as a rank writes it: phase 8's
    BERT-base pretraining, recipe and fusion passes through ``fleet`` with
    the leg's gradient sync.  Returns (fleet.main_program, main, startup,
    loss)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        s = DistributedStrategy()
        if leg != "a":
            s.overlap_grad_sync = True
            s.overlap_configs = {"bucket_mb": 32 if leg == "f" else 4,
                                 "min_buckets": 4}
        if leg in "de":
            s.quant_allreduce = True
            s.quant_configs = {"dtype": "int8", "block_size": 256,
                               "stochastic_rounding": False}
        s.build_strategy = fluid.BuildStrategy()
        s.build_strategy.fuse_elewise_add_act_ops = True
        fleet.distributed_optimizer(recipe_optimizer(fluid),
                                    s).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    return fleet.main_program, main, startup, total


class GlooWall:
    """While on, the host wall time and the count of the
    ``torch.distributed`` collectives every thread calls (the caller's
    and the gradient-sync worker's): gloo's own time, the host staging
    copies outside it; a ``batch_isend_irecv`` is one call, its time the
    call's and its requests' waits."""

    NAMES = ("all_reduce", "all_gather", "broadcast", "batch_isend_irecv")

    def __enter__(self):
        import threading
        import torch.distributed as dist
        self.ms, self.calls = 0.0, 0
        lock = threading.Lock()
        self._saved = {n: getattr(dist, n) for n in self.NAMES}

        def add(t0, calls=0):
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                self.ms += ms
                self.calls += calls

        class Timed:
            """A request whose wait adds to the wall (waited once, as
            the caller does: a gloo request waited twice blocks)."""

            def __init__(self, req):
                self._req = req

            def wait(self, *args, **kw):
                t0 = time.perf_counter()
                try:
                    return self._req.wait(*args, **kw)
                finally:
                    add(t0)

        def wrap(name, fn):
            def timed(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                add(t0, 1)
                if name == "batch_isend_irecv":
                    out = [Timed(req) for req in out]
                return out
            return timed

        for n, fn in self._saved.items():
            setattr(dist, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for n, fn in self._saved.items():
            setattr(dist, n, fn)


def bucket_numels(main):
    """The element count of each gradient bucket of ``main``, in program
    order."""
    block = main.global_block()
    return [sum(math.prod(block._find_var_recursive(g).shape)
                for g in op.input("X"))
            for op in block.ops if op.type in GRAD_SYNC_BUCKETS]


def overlap_leg(torch, np, cfg, leg, feed):
    """One leg of phase 17 on this rank: OVERLAP_STEPS prepared steps
    counted from zero (each step's exposed collective ms from its
    ``grad_sync`` record), the parameters' digest, then one profiled step
    and one step with gloo's calls timed."""
    from paddle_tpu_torch import flags, fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    program, main, startup, total = build_overlap_train(cfg, leg)
    check(program._dp is not None and program._dp.world == DP_RANKS,
          f"({leg}): the program does not run over {DP_RANKS} ranks")
    flags.set_flags({"overlap_lowering": leg not in "ce"})
    try:
        scope = fluid.Scope()
        exe = fluid.Executor(fleet.place)
        exe.run(startup, scope=scope)
        prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                               donate_state=True)

        def step():
            return float(prepared.run(feed)[0])

        kernels.reset_launch_counts()
        registry.reset_route_counts()
        losses, step_s, exposed, fired = [], [], [], []
        first_step()
        for _ in range(OVERLAP_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            step_s.append(time.perf_counter() - t0)
            rec = prepared.grad_sync
            exposed.append(rec.exposed_ms())
            fired.append(list(rec.fired))
        stamp("steps", sum(step_s))
        out = {"leg": leg, "losses": losses, "step_s": step_s,
               "exposed_ms": exposed, "hooked": list(rec.hooked),
               "fired": fired, "tail": rec.tail,
               "bucket_numels": bucket_numels(main),
               "launches": {f"{k}/{dt}": n for (k, dt), n in
                            kernels.launch_counts_by_dtype().items()},
               "fallbacks": {str(k): v for k, v in
                             registry.route_counts("fallback").items()}}
        fluid.sync_prepared_state(scope)
        out["params_sha256"] = params_digest(np, scope, main)
        steady = statistics.median(step_s[2:]) * 1e3
        out["step_ms_median_3_6"] = steady
        out["exposed_ms_median_3_6"] = statistics.median(exposed[2:])
        out["profile"] = profile_step(torch, step, steady)
        with GlooWall() as wall:
            t0 = time.perf_counter()
            step()
            out["gloo_step_ms"] = (time.perf_counter() - t0) * 1e3
        out["gloo_ms"], out["gloo_calls"] = wall.ms, wall.calls
    finally:
        flags.set_flags({"overlap_lowering": True})
    del prepared, scope, exe
    torch.cuda.empty_cache()
    return out


def preempt_run(torch, np, out_dir, mode):
    """The preemption drill on this rank: phase 15's ZeRO-3 program
    (``MeshLayout(fsdp=2)``) under a ``PreemptionHandler`` over
    ``out_dir/ckpt`` with an ``AsyncCheckpointer``.  ``ref``: the
    uninterrupted PREEMPT_STEPS steps.  ``stop``: after step
    PREEMPT_AT - 1 an async save (``out_dir/async``), after step
    PREEMPT_AT rank 0 prints the marker and every rank waits for its
    SIGTERM; ``step_done`` then drains the write, saves the sharded
    checkpoint and exits 42.  ``resume``: restores and runs the rest.
    Returns the losses, the first step and each parameter's digest as
    this rank holds it."""
    from paddle_tpu_torch import fluid, io
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.preemption import PreemptionHandler
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import registry
    cfg = cut_depth(bert.BertConfig.base())
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    program, main, startup, total = build_zero_train(cfg, "e")
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    ck = io.AsyncCheckpointer()
    handler = PreemptionHandler(exe, os.path.join(out_dir, "ckpt"), main,
                                scope=scope, checkpointer=ck)
    t0 = time.perf_counter()
    st = handler.restore()
    restore_s = time.perf_counter() - t0
    stamp("loads", restore_s)
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    registry.reset_route_counts()
    losses = []
    first_step()
    for step in range(st.step + 1, PREEMPT_STEPS):
        t0 = time.perf_counter()
        losses.append(float(prepared.run(feed)[0]))
        stamp("steps", time.perf_counter() - t0)
        if mode == "stop" and step == PREEMPT_AT - 2:
            ck.save(exe, os.path.join(out_dir, "async"), io.TrainStatus(step),
                    main, scope=scope)
        if mode == "stop" and step == PREEMPT_AT - 1:
            if fleet.worker_index() == 0:
                log(f"{PREEMPT_MARK} {step + 1}")
            deadline = time.monotonic() + 300
            while not handler.preempted and time.monotonic() < deadline:
                time.sleep(0.01)
        handler.step_done(step)
    check(mode != "stop", "the drill's ranks were not stopped")
    ck.wait()
    fluid.sync_prepared_state(scope)
    digests = state_digests(np, scope, main)
    return {"losses": losses, "first_step": st.step + 1,
            "restore_s": restore_s,
            "params_sha256": {p.name: digests[p.name]
                              for p in main.all_parameters()},
            "fallbacks": {str(k): v for k, v in
                          registry.route_counts("fallback").items()}}


def overlap_worker(out_dir, legs):
    """One rank of phase 17 (``--overlap-worker DIR LEGS``): the legs of
    LEGS in turn ("z": the drill's uninterrupted run); writes
    ``overlap<r>.json``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    from paddle_tpu_torch.models import bert
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    check(fleet.backend == "gloo", f"rank {rank} on {fleet.backend}")
    cfg = cut_depth(bert.BertConfig.base())
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    res = {"rank": rank, "place": repr(fleet.place)}
    for leg in legs:
        if leg == "z":
            res[leg] = preempt_run(torch, np, out_dir, "ref")
            continue
        res[leg] = m = overlap_leg(torch, np, cfg, leg, feed)
        log(f"[rank {rank}] ({leg}) {len(m['bucket_numels'])} buckets, "
            f"losses {[round(x, 5) for x in m['losses']]}, step ms "
            f"{m['step_ms_median_3_6']:.1f}, exposed ms "
            f"{[round(x, 2) for x in m['exposed_ms']]}")
    res["stamps"] = dict(_STAMPS)
    with open(os.path.join(out_dir, f"overlap{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def preempt_worker(out_dir, mode):
    """One rank of the drill's ``stop`` or ``resume`` launch
    (``--preempt-worker DIR MODE``); writes ``preempt<r>_<mode>.json``
    (``stop`` exits 42 before)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    res = preempt_run(torch, np, out_dir, mode)
    res["stamps"] = dict(_STAMPS)
    with open(os.path.join(out_dir, f"preempt{rank}_{mode}.json"), "w") as f:
        json.dump(res, f)
    return 0


def overlap_launch_cmd(repo, flag, out_dir, arg):
    return [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
            "--nproc", str(DP_RANKS), "--selected_gpus", "0,0",
            "--backend", "gloo", "--timeout", str(OVERLAP_TIMEOUT_S),
            os.path.join(repo, "chip_smoke.py"), flag, out_dir, arg]


def read_ranks(out_dir, name):
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, name.format(r=r))) as f:
            ranks.append(json.load(f))
    return ranks


def preempt_drill(torch, repo, out_dir):
    """The drill's ``stop`` launch, SIGTERM to the launcher at the
    marker, then the ``resume`` launch; returns (the stop launch's exit
    code and seconds, resume's ranks)."""
    torch.cuda.empty_cache()
    cmd = overlap_launch_cmd(repo, "--preempt-worker", out_dir, "stop")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=repo, stdout=subprocess.PIPE,
                            text=True, env=launch_env())
    try:
        signalled = False
        for line in proc.stdout:
            print(line, end="", flush=True)
            if not signalled and line.startswith(PREEMPT_MARK):
                proc.send_signal(signal.SIGTERM)
                signalled = True
        rc = proc.wait(timeout=OVERLAP_TIMEOUT_S + 60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stop_s = time.perf_counter() - t0
    log(f"  drill: SIGTERM to the launcher after step {PREEMPT_AT}; the "
        f"launcher exited {rc} after {stop_s:.1f} s")
    check(signalled, "drill: the ranks never reached the marker")
    check(rc == 42, f"drill: the launcher exited {rc}, not 42")
    cmd = overlap_launch_cmd(repo, "--preempt-worker", out_dir, "resume")
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=repo, timeout=OVERLAP_TIMEOUT_S + 60,
                        env=launch_env()).returncode
    wall = time.perf_counter() - t0
    check(rc == 0, f"drill: the resumed ranks failed (exit code {rc})")
    ranks = read_ranks(out_dir, "preempt{r}_resume.json")
    launch_line("phase 17 drill resume launch", ranks, wall)
    return stop_s, ranks


def overlap_quant_checks(torch, results, numels):
    """#11 and #12 against their plain versions at two shard shapes of
    leg (d)'s ready-order buckets (n = 2, block 256: its smallest bucket
    and its median one), appended to ``results["overlap_quant"]``."""
    from paddle_tpu_torch.ops.cuda import quant_kernels as QK
    from paddle_tpu_torch.ops.quantize_wire import CompressionSpec
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(
        SEED + 17)
    spec = CompressionSpec("int8", 256)
    rows = results.setdefault("overlap_quant", [])
    for numel in sorted({min(numels), sorted(numels)[len(numels) // 2]}):
        sb = -(-numel // (DP_RANKS * 256))
        q, s = quant_peers(torch, gen, spec, DP_RANKS, sb)
        acc = QK.dequant_accumulate(q, s, spec, DP_RANKS)
        err = max_err(torch, acc, QK.dequant_accumulate_plain(
            q, s, spec, DP_RANKS))
        q2, s2 = QK.dequant_accumulate_requant(q, s, spec, DP_RANKS)
        p2, t2 = QK.dequant_accumulate_requant_plain(q, s, spec, DP_RANKS)
        differ = int((q2 != p2).sum())
        serr = max_err(torch, s2, t2)
        log(f"  #11 / #12 at a bucket of leg (d), n={DP_RANKS} SB={sb} "
            f"int8: #11 max|Δ| {err:.3e} (tolerance {TOL_DQ_ACC:.0e}); #12 "
            f"payload bytes that differ {differ} (must be 0), scales "
            f"max|Δ| {serr:.3e} (tolerance {TOL_DQ_SCALE:.0e})")
        check(err <= TOL_DQ_ACC, f"#11 at SB={sb}: {err:.3e}")
        check(differ == 0 and serr <= TOL_DQ_SCALE,
              f"#12 at SB={sb}: {differ} bytes, scales {serr:.3e}")
        rows.append({"shape": [DP_RANKS, sb, 256, "int8"],
                     "dequant_accumulate_max_abs_err": err,
                     "requant_payload_bytes_differ": differ,
                     "requant_scales_max_abs_err": serr})


def overlap_phase(torch, np, repo, results):
    """Phase 17 (see the module docstring); returns rank 0's launches by
    leg and the report."""
    from paddle_tpu_torch.ops.cuda import build
    out_dir = os.path.join(build.BUILD_DIR, "smoke_overlap")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rc = subprocess.run(
            overlap_launch_cmd(repo, "--overlap-worker", out_dir,
                               OVERLAP_LEGS + "z"), cwd=repo,
            timeout=OVERLAP_TIMEOUT_S + 60, env=launch_env()).returncode
        wall = time.perf_counter() - t0
        log(f"  legs {OVERLAP_LEGS} and the drill's uninterrupted run: "
            f"ran {wall:.1f} s, exit code {rc}")
        check(rc == 0, f"phase 17: a rank failed (exit code {rc})")
        ranks = read_ranks(out_dir, "overlap{r}.json")
        launch_line(f"phase 17 launch {OVERLAP_LEGS}z", ranks, wall)
        stop_s, resumed = preempt_drill(torch, repo, out_dir)
        ckpt = os.path.join(out_dir, "ckpt")
        saved = sorted(d for d in os.listdir(ckpt)
                       if d.startswith("checkpoint_"))
        files = set(os.listdir(os.path.join(ckpt, saved[-1])))
        from paddle_tpu_torch import io
        copy = os.path.join(out_dir, "async", f"checkpoint_{PREEMPT_AT - 2}")
        copy_ok = io.validate_checkpoint_dir(copy)[0]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    report = overlap_report(ranks)
    overlap_quant_checks(torch, results, ranks[0]["d"]["bucket_numels"])
    # the drill
    check(saved == [f"checkpoint_{PREEMPT_AT - 1}"],
          f"drill: checkpoints {saved}")
    check({f"shard_manifest_{r}.json" for r in range(DP_RANKS)} <= files,
          f"drill: the checkpoint lacks a rank's shards: {sorted(files)}")
    check(copy_ok, "drill: the in-flight AsyncCheckpointer write was torn")
    for r, res in enumerate(resumed):
        ref = ranks[r]["z"]
        check(res["first_step"] == PREEMPT_AT,
              f"drill rank {r}: resumed at step {res['first_step']}")
        check(res["losses"] == ref["losses"][PREEMPT_AT:],
              f"drill rank {r}: steps {PREEMPT_AT + 1}-{PREEMPT_STEPS} "
              f"{res['losses']} vs {ref['losses'][PREEMPT_AT:]}")
        differ = sorted(n for n in ref["params_sha256"]
                        if res["params_sha256"].get(n) !=
                        ref["params_sha256"][n])
        check(not differ, f"drill rank {r}: parameters differ: {differ[:5]}")
        check(not res["fallbacks"], f"drill rank {r}: fallbacks")
    log(f"  drill: both ranks saved one sharded checkpoint "
        f"({saved[-1]}) and exited 42 ({stop_s:.1f} s with the launch); "
        f"the AsyncCheckpointer copy of step {PREEMPT_AT - 1} whole; the "
        f"relaunch restored in {resumed[0]['restore_s']:.2f} s and steps "
        f"{PREEMPT_AT + 1}-{PREEMPT_STEPS} {resumed[0]['losses']} are bit "
        f"for bit the uninterrupted run's, parameters too")
    report["drill"] = {"stop_launch_s": stop_s, "checkpoints": saved,
                       "restore_s": resumed[0]["restore_s"],
                       "losses": resumed[0]["losses"]}
    launches = {f"overlap_{leg}": {k.split("/")[0]: v for k, v in
                                   ranks[0][leg]["launches"].items()}
                for leg in OVERLAP_LEGS}
    return launches, report


def overlap_report(ranks):
    """Phase 17's gates over legs (a)-(f), and their printed figures."""
    report = {}
    for leg in OVERLAP_LEGS:
        rs = [r[leg] for r in ranks]
        what = f"({leg}) {OVERLAP_LEG_NAMES[leg]}"
        n = len(rs[0]["bucket_numels"])
        for r, m in enumerate(rs):
            who = f"{what} rank {r}"
            check(all(math.isfinite(x) for x in m["losses"]),
                  f"{who}: losses not finite: {m['losses']}")
            check(not m["fallbacks"], f"{who}: fallbacks {m['fallbacks']}")
            want = {f"{k}/float32": v for k, v in
                    fused_launches(CUT_LAYERS).items()}
            if leg in "de":
                want["dequant_accumulate_requant/int8"] = n
            got = m["launches"]
            for key in set(want) | set(got):
                check(got.get(key, 0) == want.get(key, 0) * OVERLAP_STEPS,
                      f"{who}: {key} launched {got.get(key, 0)} times in "
                      f"{OVERLAP_STEPS} steps, expected {want.get(key, 0)} "
                      f"a step")
            if leg in "bdf":
                check(len(m["hooked"]) == n and m["tail"] == 0 and
                      m["hooked"] == sorted(m["hooked"], reverse=True) and
                      all(f == sorted(m["hooked"]) for f in m["fired"]),
                      f"{who}: hooks {m['hooked']} fired {m['fired'][-1]}, "
                      f"{m['tail']} at the tail; {n} buckets in ready order "
                      f"expected")
            elif leg in "ce":
                check(not m["hooked"] and m["tail"] == n,
                      f"{who}: {m['hooked']} hooked with lowering off")
        check(rs[0]["losses"] == rs[1]["losses"] and
              rs[0]["params_sha256"] == rs[1]["params_sha256"],
              f"{what}: the ranks differ")
        if leg in "bd":
            check(n >= 4, f"{what}: {n} buckets, at least 4 expected")
        m = rs[0]
        prof = m.get("profile") or {}
        log(f"  {what}: {n} buckets; step {m['step_ms_median_3_6']:.2f} ms "
            f"(median of steps 3-{OVERLAP_STEPS}); exposed collective "
            f"{m['exposed_ms_median_3_6']:.2f} ms (median; backward's end to "
            f"the last reduced gradient); gloo {m['gloo_ms']:.2f} ms in "
            f"{m['gloo_calls']} calls of a {m['gloo_step_ms']:.2f} ms step "
            f"(gloo staged through the host, two ranks on one card: no "
            f"measure of NVLink); device busy "
            + (f"{100 * prof['busy_share']:.1f} %" if prof
               else "not measured"))
        report[leg] = {k: m[k] for k in (
            "losses", "step_ms_median_3_6", "exposed_ms",
            "exposed_ms_median_3_6", "gloo_ms", "gloo_calls",
            "gloo_step_ms", "bucket_numels")}
        report[leg]["busy_share"] = prof.get("busy_share")
    a, b, c, d, e = (ranks[0][k] for k in "abcde")
    for x, y, what in ((b, c, "(b) vs (c)"), (b, a, "(b) vs (a)"),
                       (d, e, "(d) vs (e)")):
        check(x["losses"] == y["losses"] and
              x["params_sha256"] == y["params_sha256"],
              f"{what}: not bit for bit: {x['losses']} vs {y['losses']}")
    log("  (b) = (c) = (a) and (d) = (e) bit for bit in losses and "
        "parameter sha256; hooks fired in ready order in (b), (d), (f); "
        "#12 launched from the hooks in (d) as often as at the tail in (e)")
    return report


# ---------------------------------------------------------------------------
# phase 11: paged-KV decode serving at BERT-base width
# ---------------------------------------------------------------------------

DECODE_CONFIG = dict(block_size=16, max_seq_len=512, max_batch_size=8,
                     prefill_seq_buckets=(64, 128, 256, 512),
                     pack_max_segments=4, max_new_tokens=32,
                     chain_lengths=(1, 8), prefix_cache=True)
DECODE_POOL_BLOCKS = 256
DECODE_REQUESTS = 16          # two bursts of 8
DECODE_PROMPT_LENS = (16, 384)
DECODE_SHARED = 64            # tokens of the shared prefix (4 blocks)
DECODE_SAMPLING_NEW = 16
# launches per forward (prefill, chunk or one decode step of a chain):
# one flash forward per layer; the embedding LN and two per layer
DECODE_LAUNCHES = {"flash_attention_fwd": 12, "layer_norm_fwd": 25}
TOL_DECODE_GAP = 1e-4         # a divergence needs a top-2 gap below this
DECODE_MAX_DIVERGED = 1


def decode_prompts(np, vocab):
    """16 prompts of 16-384 tokens from a fixed seed.  Request 2 (first
    burst) and requests 9, 11, 13 and 15 (second burst) begin with the
    same 64 tokens: the four later ones hit the prefix cache, 4 full
    blocks each."""
    rng = np.random.RandomState(SEED + 11)
    lens = rng.randint(DECODE_PROMPT_LENS[0], DECODE_PROMPT_LENS[1] + 1,
                       DECODE_REQUESTS)
    prompts = [rng.randint(0, vocab, int(n)).astype(np.int64) for n in lens]
    shared = rng.randint(0, vocab, DECODE_SHARED).astype(np.int64)
    for i in (2, 9, 11, 13, 15):
        if prompts[i].size <= DECODE_SHARED + 16:
            prompts[i] = rng.randint(0, vocab, DECODE_SHARED + 40).astype(
                np.int64)
        prompts[i][:DECODE_SHARED] = shared
    return prompts


def decode_budgets(n):
    """New tokens per request: 32 down to 18 in steps of 2, so the first
    burst's requests retire at different chain boundaries and the second
    burst's prefills slot in while the rest of the first still decodes."""
    return [DECODE_CONFIG["max_new_tokens"] - 2 * (i % 8) for i in range(n)]


def drive_decode(engine, prompts, max_new, policies=None):
    """Submit ``prompts`` in two bursts of half: the second once every
    request of the first has its first token (its decode chains live).
    ``max_new`` is one budget or one per request.  Returns (results,
    first-token latencies in s, wall s)."""
    first, futs, t_sub = {}, [], {}
    half = len(prompts) // 2

    def submit(i):
        def on_token(tok, i=i):
            first.setdefault(i, time.perf_counter())
        t_sub[i] = time.perf_counter()
        kw = dict(policies[i]) if policies else {}
        n = max_new[i] if isinstance(max_new, (list, tuple)) else max_new
        futs.append((i, engine.generate({"src_ids": prompts[i]},
                                        max_new_tokens=n,
                                        on_token=on_token, **kw)))

    t0 = time.perf_counter()
    for i in range(half):
        submit(i)
    while len(first) < half and time.perf_counter() - t0 < 600:
        time.sleep(0.002)
    for i in range(half, len(prompts)):
        submit(i)
    results = {i: f.result(timeout=600) for i, f in futs}
    wall = time.perf_counter() - t0
    ttft = [first[i] - t_sub[i] for i in sorted(first)]
    return [results[i] for i in range(len(prompts))], ttft, wall


def engine_logits(np, engine, tokens):
    """The engine's next-token logits after ``tokens``, through its
    chunked-prefill program (the cache-read route) into blocks taken from
    the free list and returned after (the engine must be idle)."""
    cfg = engine.config
    bs, n = cfg.block_size, len(tokens)
    blocks = [engine._free.pop() for _ in range(-(-n // bs))]
    try:
        width = cfg.chunk_width
        feed = {"src_ids": np.zeros((1, width), np.int64),
                "pos_ids": np.zeros((1, width), np.int64),
                "slot_ids": np.full((1, width), -1, np.int32),
                "block_table": np.zeros((1, engine._mbps), np.int32),
                "ctx_len": np.array([n], np.int32),
                "last_pos": np.array([[n - 1]], np.int64)}
        feed["src_ids"][0, :n] = tokens
        feed["pos_ids"][0, :n] = np.arange(n)
        feed["slot_ids"][0, :n] = [blocks[p // bs] * bs + p % bs
                                   for p in range(n)]
        feed["block_table"][0, :len(blocks)] = blocks
        engine._acquire(engine._chunk)
        return engine._chunk.run(feed)[0].numpy()[0]
    finally:
        engine._free.extend(reversed(blocks))


def reference_logits(np, engine, tokens):
    """The greedy reference's next-token logits after ``tokens`` (its
    score program on the isolated weights)."""
    n = len(tokens)
    sb = next(b for b in engine._score_buckets() if b >= n)
    feed = {"src_ids": np.zeros((1, sb), np.int64),
            "pos_ids": np.zeros((1, sb), np.int64),
            "input_mask": np.zeros((1, sb, 1), np.float32),
            "last_pos": np.array([[n - 1]], np.int64)}
    feed["src_ids"][0, :n] = tokens
    feed["pos_ids"][0, :n] = np.arange(n)
    feed["input_mask"][0, :n, 0] = 1.0
    return engine._score.run(feed)[0].numpy()[0]


def decode_parity(torch, np, engine, prompts, results):
    """Every request's tokens against greedy_reference.  Where one
    diverges, the reference's top-2 logit gap at that step and the two
    paths' logit difference there (the engine's recomputed through its
    cache-read chunk program); passes only with every gap under
    TOL_DECODE_GAP and at most DECODE_MAX_DIVERGED diverged requests."""
    diverged = []
    for i, (p, res) in enumerate(zip(prompts, results)):
        ref = engine.greedy_reference({"src_ids": p},
                                      max_new_tokens=len(res.tokens))
        got, want = res.tokens.tolist(), ref.tokens.tolist()
        check(len(got) == len(want) and all(t >= 0 for t in got),
              f"decode request {i}: {len(got)} tokens, reference "
              f"{len(want)}")
        if got == want:
            continue
        t = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
        prefix = list(p) + want[:t]
        ref_l = reference_logits(np, engine, prefix)
        eng_l = engine_logits(np, engine, prefix)
        top2 = np.sort(ref_l)[-2:]
        gap = float(top2[1] - top2[0])
        diff = float(np.abs(ref_l - eng_l).max())
        log(f"  request {i} diverges at token {t}: engine {got[t]}, "
            f"reference {want[t]}; reference top-2 gap {gap:.3e}, "
            f"max|Δ logits| engine vs reference {diff:.3e}")
        diverged.append({"request": i, "token": t, "top2_gap": gap,
                         "logit_diff": diff})
        check(gap < TOL_DECODE_GAP, f"decode request {i} diverges from "
                                    f"greedy_reference at token {t} with a "
                                    f"top-2 gap of {gap:.3e}")
    check(len(diverged) <= DECODE_MAX_DIVERGED,
          f"{len(diverged)} decode requests diverge from greedy_reference")
    return diverged


def decode_kernel_checks(torch, results, dev):
    """Kernel #1 at the decode path's two new shapes against its twin:
    a decode step (B8 H12 Sq1, T 512, D64, the ctx_len bias of one padded
    batch row, ctx_len 0, among random lengths) and a chunk (B1 Sq512
    T512 with the QPos causal term).  Each row has its time, its bound by
    the bytes this data needs (the keys below ctx_len; the full window
    beside it), and SDPA's time on the same gathered K/V: the yardstick
    of a later paged decode kernel.  Beside them the gather's time: one
    pool's [B, T, 768] copy, two pools a layer a step."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cache_ops
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    record = recorder(results)
    heads, d, bs, nb = 12, 64, 16, DECODE_POOL_BLOCKS
    hidden = heads * d

    def split(t):
        b, s, _ = t.shape
        return t.view(b, s, heads, d).permute(0, 2, 1, 3).reshape(
            b * heads, s, d).contiguous()

    cases = []
    # decode step: B 8, one query row each
    b, t_len = 8, DECODE_CONFIG["max_seq_len"]
    ctx_len = torch.randint(1, t_len + 1, (b,), generator=gen, device=dev)
    ctx_len[-1] = 0                                  # a padded batch row
    cases.append(("decode", b, 1, ctx_len, None))
    # chunk: one row, 300 suffix tokens after 4 hit blocks
    start, n = 4 * bs, 300
    q_pos = torch.zeros(1, t_len, dtype=torch.int64, device=dev)
    q_pos[0, :n] = torch.arange(start, start + n, device=dev)
    cases.append(("chunk", 1, t_len, torch.tensor([start + n], device=dev),
                  q_pos))
    gather_row = None
    for name, b, sq, ctx_len, q_pos in cases:
        pool_k = torch.randn(nb, bs, hidden, generator=gen, device=dev)
        pool_v = torch.randn(nb, bs, hidden, generator=gen, device=dev)
        table = torch.randperm(nb, generator=gen, device=dev)[
            :b * (t_len // bs)].view(b, -1).to(torch.int32)
        q = torch.randn(b, sq, hidden, generator=gen, device=dev)
        keys = cache_ops.gather_cache(pool_k, table)
        vals = cache_ops.gather_cache(pool_v, table)
        bias = cache_ops.ctx_len_bias(ctx_len, t_len)
        if q_pos is not None:
            tpos = torch.arange(t_len, device=dev)[None, None, :]
            causal = torch.where(tpos <= q_pos[:, :, None], 0.0, -1e9)
            bias = bias + causal[:, None]
        bias3 = bias.expand(b, 1, sq, t_len).reshape(b, sq, t_len) \
            .contiguous()
        qf, kf, vf = split(q), split(keys), split(vals)
        o, lse = FA.flash_fwd(qf, kf, vf, bias3)
        po, plse = FA.flash_fwd_plain(qf, kf, vf, bias3)
        what = f"flash {name} B{b} Sq{sq} T{t_len} float32"
        check(bool(torch.isfinite(o).all()), f"{what}: non-finite output "
                                             f"(an all-masked row?)")
        err = agree(torch, what + " o", o, po, "float32", TOL_F32)
        # the padded row's lse is near -1e9, where a float32 ulp is 64:
        # held per row to TOL_LSE plus one float32 ulp of |lse|
        lerr = max_err(torch, lse, plse)
        a = plse.abs()
        over = float(((lse - plse).abs() - TOL_LSE - (
            torch.nextafter(a, a + 1) - a)).max())
        log(f"  {what} lse: max|Δ| {lerr:.3e} (tolerance {TOL_LSE:.1e} + 1 "
            f"float32 ulp of |lse| per row; max|Δ| - tolerance {over:.3e})")
        check(over <= 0, f"{what}: lse disagrees ({lerr})")
        lerr = float(((lse - plse).abs() / (1 + a)).max())
        bh = b * heads
        q4, k4, v4 = (t.view(b, heads, -1, d) for t in (qf, kf, vf))
        m4 = bias3.view(b, 1, sq, t_len)

        def lib():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)
        # the bytes this data needs: q, o, lse, the bias, and the K/V rows
        # inside each row's context (what a paged kernel would read)
        valid = int(ctx_len.clamp(max=t_len).sum())
        io = 4 * (2 * bh * sq * d + bh * sq + b * sq * t_len)
        nbytes = io + 4 * 2 * heads * valid * d
        full = io + 4 * 2 * bh * t_len * d
        if q_pos is None:
            pairs = heads * valid
        else:
            pairs = heads * int(((torch.arange(t_len, device=dev)[None] <=
                                  q_pos[0, :n, None]).sum()))
        flops = 4 * pairs * d
        bound = fwd_bounds(nbytes, flops, "float32")
        ms = time_ms(torch, lambda: FA.flash_fwd(qf, kf, vf, bias3))
        gather_ms = time_ms(torch, lambda: cache_ops.gather_cache(pool_k,
                                                                  table))
        gather_bytes = 2 * 4 * b * t_len * hidden + 4 * table.numel()
        record(f"flash_attention_fwd_{name}",
               [b, heads, sq, t_len, d, name], "float32", err,
               ms, time_ms(torch, lambda: FA.flash_fwd_plain(
                   qf, kf, vf, bias3)),
               time_ms(torch, lib), nbytes, flops, **bound,
               bound_full_window_ms=bound_ms(full, flops, "float32")[0],
               lse_rel_err=lerr, valid_keys=valid, gather_ms=gather_ms,
               gather_bound_ms=bound_ms(gather_bytes, 0, "float32")[0],
               library_is="SDPA on the gathered K/V, same mask")
        if name == "decode":
            gather_row = gather_ms
    return gather_row


def decode_synthetic_feed(np, engine, bsz, pos):
    """A chain feed of ``bsz`` live rows at position ``pos``, each on its
    own blocks of the pool (the pool's contents are what the traffic left:
    this times the work, not the tokens)."""
    cfg = engine.config
    mb = engine._mbps
    feed = engine._chain_feed_arrays(bsz, [])
    for i in range(bsz):
        feed["token_ids"][i] = 1000 + i
        feed["pos_ids"][i] = pos
        feed["block_table"][i] = np.arange(i * mb, (i + 1) * mb) % \
            engine.pool_blocks
        feed["ctx_len"][i] = pos + 1
        feed["steps_left"][i] = 10 ** 6
    return feed


def profile_chain(torch, run, wall_ms):
    """Device time of one chain by kernel group and its busy share of
    ``wall_ms`` (the union of the kernels' spans); None when the profiler
    saw no device activity.  Groups: the matrix products (cuBLAS /
    CUTLASS, split-K reductions), #1, #4, the cache gather and the
    head-split copies of its output, the cache writes and embedding
    lookups, the layer_norm op's Mean / Variance outputs (computed
    beside #4, read by nothing on this path), and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    groups = {"products": 0.0, "flash #1": 0.0, "layer_norm #4": 0.0,
              "gather + head-split copies": 0.0,
              "cache writes + lookups": 0.0,
              "layer_norm Mean/Variance": 0.0, "other": 0.0}
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
        low = e.name.lower()
        if "flash_fwd" in low:
            g = "flash #1"
        elif "ln_fwd" in low:
            g = "layer_norm #4"
        elif "gemm" in low or "cutlass" in low or "splitkreduce" in low:
            g = "products"
        elif "gather" in low or ("direct_copy" in low and
                                 "unrolled" not in low):
            # the unrolled copies are the small integer casts
            g = "gather + head-split copies"
        elif "index" in low:
            g = "cache writes + lookups"
        elif "welford" in low or "meanops" in low:
            g = "layer_norm Mean/Variance"
        else:
            g = "other"
        groups[g] += us / 1e3
    if not spans:
        log("  chain device time: not measured (the profiler saw no device "
            "activity)")
        return None
    busy = covered_us(spans) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (n, us) in top:
        log(f"    {us / 1e3:8.3f} ms  {n:5d}x  {name[:110]}")
    return {"busy_ms": busy, "wall_ms": wall_ms, "busy_share":
            busy / wall_ms, "groups_ms": groups,
            "host_ms": wall_ms - busy,
            "top": [{"name": name[:200], "calls": n, "ms": us / 1e3}
                    for name, (n, us) in top]}


def decode_timing(torch, np, engine):
    """ms per chain step at B8 and B1 (a chain of 8 from a synthetic feed,
    wall clock to the token fetch, median of 5), prefill ms per bucket
    (batch 1 and 8, pad feeds that write nothing, median of 3), and one
    profiled B8 chain of 8."""
    out = {"chain_step_ms": {}, "prefill_ms": {}}
    prepared = engine._chains[8]
    engine._acquire(prepared)
    for bsz in (8, 1):
        feed = decode_synthetic_feed(np, engine, bsz, 256)
        prepared.run(feed)[0].numpy()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            prepared.run(feed)[0].numpy()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["chain_step_ms"][f"B{bsz}"] = statistics.median(walls) / 8
    feed = decode_synthetic_feed(np, engine, 8, 256)
    out["chain_profile"] = profile_chain(
        torch, lambda: prepared.run(feed)[0].numpy(),
        out["chain_step_ms"]["B8"] * 8)
    K = engine.config.pack_max_segments
    engine._acquire(engine._prefill)
    for sb in engine.config.prefill_seq_buckets:
        for bb in (1, 8):
            feed = {"src_ids": np.zeros((bb, sb), np.int64),
                    "pos_ids": np.zeros((bb, sb), np.int64),
                    "input_mask": np.ones((bb, sb, K), np.float32),
                    "slot_ids": np.full((bb, sb), -1, np.int32),
                    "last_pos": np.zeros((bb, K), np.int64)}
            engine._prefill.run(feed)[1].numpy()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                engine._prefill.run(feed)[1].numpy()
                walls.append((time.perf_counter() - t0) * 1e3)
            out["prefill_ms"][f"B{bb}xS{sb}"] = statistics.median(walls)
    return out


def chain_without_host_sync(torch, np, engine):
    """One B8 chain of 8 with its feeds already on the card, under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync inside the
    chain raises.  The token fetch after it is the chain's one sync."""
    prepared = engine._chains[8]
    engine._acquire(prepared)
    dev = engine._exe.device
    feed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in decode_synthetic_feed(np, engine, 8, 128).items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = prepared.run(feed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tokens = handles[0].numpy()
    check(tokens.shape == (8, 8) and (tokens >= 0).all(),
          f"synthetic chain emitted {tokens.shape} {tokens.min()}")
    return True


def decode_phase(torch, np, results, place=None):
    """Phase 11: paged decode at BERT-base width through
    ``DecodeEngine(BertDecoder(cfg), DecodeConfig(...)).generate``."""
    from paddle_tpu_torch.models import BertDecoder
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = BertConfig.base()
    model = BertDecoder(cfg, seed=SEED)
    t0 = time.perf_counter()
    engine = DecodeEngine(model, DecodeConfig(
        pool_blocks=DECODE_POOL_BLOCKS, **DECODE_CONFIG), place=place)
    prompts = decode_prompts(np, cfg.vocab_size)
    report = {"pool_blocks": engine.pool_blocks,
              "pool_mb": model.cache_block_bytes(16) * engine.pool_blocks
              / 1e6}
    try:
        n_warm = engine.warmup()
        report["startup_and_warmup_s"] = time.perf_counter() - t0
        log(f"  BERT-base decoder ({cfg.num_hidden_layers} layers, hidden "
            f"{cfg.hidden_size}, vocab {cfg.vocab_size}), pool "
            f"{engine.pool_blocks} blocks ({report['pool_mb']:.1f} MB); "
            f"{n_warm} feed shapes warmed in "
            f"{report['startup_and_warmup_s']:.1f} s")
        # the main path: counts from zero, the traffic, read right after
        kernels.reset_launch_counts()
        registry.reset_route_counts()
        res, ttft, wall = drive_decode(engine, prompts,
                                       decode_budgets(len(prompts)))
        engine.drain()
        launches = kernels.launch_counts()
        routes = registry.route_counts()
        stats = engine.stats()
        forwards = stats["prefill_batches"] + stats["chunk_steps"] + \
            stats["decode_steps"]
        log(f"  {len(prompts)} requests in two bursts: {stats['tokens_out']}"
            f" tokens in {wall:.3f} s ({stats['tokens_out'] / wall:.1f} "
            f"tokens/s); {stats['prefill_batches']} prefills, "
            f"{stats['chunk_steps']} chunks, {stats['chains_run']} chains "
            f"({stats['chain_hist']}), {forwards} forwards; prefix hits "
            f"{stats['prefix_hits']}; host syncs {stats['host_syncs']}")
        fallbacks = {k: v for k, v in routes.items() if k[2] == "fallback"}
        check(not fallbacks, f"route fallbacks on the decode path: "
                             f"{fallbacks}")
        for name, per in DECODE_LAUNCHES.items():
            check(launches[name] == per * forwards,
                  f"{name}: {launches[name]} launches on the decode path, "
                  f"expected {per} x {forwards} forwards")
        others = {k: v for k, v in launches.items()
                  if v and k not in DECODE_LAUNCHES}
        check(not others, f"unexpected launches on the decode path: "
                          f"{others}")
        check(stats["prefix_hits"] >= 4 * 4,
              f"prefix hits {stats['prefix_hits']}: the shared-prefix "
              f"requests missed the cache")
        check(stats["failed"] == 0 and stats["completed"] == len(prompts),
              f"decode stats {stats}")
        ttft_sorted = sorted(ttft)
        report.update({
            "requests": len(prompts), "wall_s": wall,
            "tokens_out": stats["tokens_out"],
            "tokens_per_s": stats["tokens_out"] / wall,
            "ttft_p50_ms": 1e3 * statistics.median(ttft_sorted),
            "ttft_p99_ms": 1e3 * ttft_sorted[min(len(ttft_sorted) - 1,
                                                 int(0.99 * len(
                                                     ttft_sorted)))],
            "forwards": forwards, "launches": launches,
            "stats": {k: stats[k] for k in (
                "prefill_batches", "chunk_steps", "chains_run",
                "chain_hist", "decode_steps", "host_syncs", "prefix_hits",
                "prefill_tokens", "peak_blocks_used")}})
        log(f"  TTFT p50 {report['ttft_p50_ms']:.1f} ms, p99 "
            f"{report['ttft_p99_ms']:.1f} ms; launches {launches}")
        report["diverged"] = decode_parity(torch, np, engine, prompts, res)
        traced_decode(engine, prompts, res)
        log(f"  tokens vs greedy_reference: {len(prompts) - len(report['diverged'])}"
            f" of {len(prompts)} identical")
        report["no_host_sync_in_chain"] = chain_without_host_sync(
            torch, np, engine)
        report.update(decode_timing(torch, np, engine))
        log(f"  chain step ms {report['chain_step_ms']}; prefill ms "
            f"{report['prefill_ms']}")
        prof = report["chain_profile"]
        if prof:
            log(f"  one B8 chain of 8: device busy {prof['busy_ms']:.2f} of "
                f"{prof['wall_ms']:.2f} ms ({100 * prof['busy_share']:.1f} "
                f"%); " + ", ".join(f"{g} {ms:.3f}" for g, ms in
                                    prof["groups_ms"].items()))
        dev = engine._exe.device
    finally:
        engine.shutdown()
    greedy = {i: r.tokens.tolist() for i, r in enumerate(res)}
    report["sampling"] = sampling_leg(np, model, prompts, greedy, place)
    report["gather_ms"] = decode_kernel_checks(torch, results, dev)
    return launches, report


def sampling_leg(np, model, prompts, greedy, place):
    """A second engine with ``sampling=True``: four requests (one greedy,
    three sampling with fixed seeds) submitted in two orders draw the same
    tokens, and the greedy row equals the greedy run's."""
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
    engine = DecodeEngine(model, DecodeConfig(
        pool_blocks=DECODE_POOL_BLOCKS, sampling=True, **DECODE_CONFIG),
        place=place)
    picks = [0, 1, 3, 4]
    policies = [{}, {"temperature": 0.9, "top_k": 50, "top_p": 0.9,
                     "seed": 7},
                {"temperature": 0.7, "seed": 11},
                {"temperature": 1.2, "top_p": 0.8, "seed": 13}]
    try:
        runs = []
        for order in (picks, picks[::-1]):
            pol = [policies[picks.index(i)] for i in order]
            res, _, _ = drive_decode(engine, [prompts[i] for i in order],
                                     DECODE_SAMPLING_NEW, pol)
            runs.append({i: r.tokens.tolist() for i, r in zip(order, res)})
    finally:
        engine.shutdown()
    check(runs[0] == runs[1], f"sampling differs between submission "
                              f"orders: {runs}")
    check(runs[0][0] == greedy[0][:DECODE_SAMPLING_NEW],
          "the greedy row of the sampling engine differs from the greedy "
          "run")
    check(len({tuple(v) for v in runs[0].values()}) == len(picks),
          "sampled streams coincide")
    log(f"  sampling: {len(picks)} requests in two orders, identical; the "
        f"greedy row equals the greedy run")
    return {"requests": len(picks), "orders": 2, "identical": True}


# ---------------------------------------------------------------------------
# phase 18: tensor and sequence parallelism (tp x sp) on the ring route
# ---------------------------------------------------------------------------

#: (k): the ring's kernel entry at BERT-base's 12 heads over tp 2 and
#: S 512 over sp 2: B4 H6 S_loc 256 D64
RING_SHAPE = (4, 6, 256, 64)
RING_BIASES = ("padding", "causal_diagonal", "causal_future")
RING_NEG = -1e30          # the ring's additive mask (parallel/ring_attention)
#: (a): tp 2 x sp 2 on four ranks, batch 4 x 512, every row holding the
#: same masked count in each sp shard; (b): tp 2 on two ranks, 32 x 128
#: with attention dropout 0.1 on the plain flash route
TPSP_RANKS, TP_RANKS, SP_DEGREE = 4, 2, 2
TPSP_BATCH, TPSP_SEQ, TPSP_PER_SHARD = 4, 512, 38
TP_BATCH, TP_SEQ = TRAIN_BATCH, TRAIN_SEQ
TPSP_STEPS = 4
TPSP_LR = 1e-4
TOL_TPSP_LOSS = 1e-4      # (a) vs the one-rank run: losses (relative)
TPSP_TIMEOUT_S = 600
TPSP_LEG_NAMES = {"a": "tp 2 x sp 2, four ranks", "b": "tp 2, two ranks",
                  "c": "fsdp 2 x tp 2, four ranks"}
#: (c): fsdp 2 x tp 2 in (a)'s launch, phase 8's recipe (its global-norm
#: clip included), 32 x 128 with TRAIN_MASKS masked tokens a row, half of
#: them in each sp half (so the restore onto tp 2 x sp 2 sees the same
#: count in every shard); its sharded save restored onto
#: FSDP_TP_RESTORES in the same processes
FSDP_TP_LAYOUT = {"fsdp": 2, "tp": 2}
#: each leg's MeshLayout arguments
TPSP_LAYOUTS = {"a": {"tp": 2, "extra_axes": {"sp": SP_DEGREE}},
                "b": {"tp": 2}, "c": FSDP_TP_LAYOUT}
FSDP_TP_RESTORES = {"tp2sp2": {"tp": 2, "extra_axes": {"sp": 2}},
                    "data4": {"data": 4}}


def ring_biases(torch, gen, dev, bsz, seq):
    """The ring's three block biases, head-shared (B, S, S) float32: a
    padding mask with batch row 0 all masked, the causal bias of a
    diagonal block, and that of a block wholly in the future."""
    mask = (torch.rand(bsz, seq, generator=gen, device=dev) < 0.8).float()
    mask[0] = 0.0
    pad = ((1.0 - mask) * RING_NEG)[:, None, :].expand(bsz, seq, seq)
    keep = torch.ones(seq, seq, dtype=torch.bool, device=dev).tril()
    diag = torch.zeros(seq, seq, device=dev).masked_fill(
        ~keep, RING_NEG).expand(bsz, seq, seq)
    future = torch.full((bsz, seq, seq), RING_NEG, device=dev)
    return {"padding": pad.contiguous(), "causal_diagonal": diag.contiguous(),
            "causal_future": future}


def ring_kernel_checks(torch, results):
    """(k): the ring route's kernel entry — #1 returning lse, #2 and #3
    taking delta - dlse — against the plain twins at RING_SHAPE, float32
    and bfloat16, under a random dO and a random dlse, for each of the
    ring's block biases; the all-masked rows the uniform mean of V; timed
    beside the library's lse-returning call (the forward) and the bound."""
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    record = recorder(results)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    randn = randn_on(torch, gen, dev)
    bsz, heads, seq, d = RING_SHAPE
    bh = bsz * heads
    biases = ring_biases(torch, gen, dev, bsz, seq)
    for dtname in ("float32", "bfloat16"):
        dt = getattr(torch, dtname)
        es = torch.finfo(dt).bits // 8
        q, k, v, do = (randn(bh, seq, d, dtype=dt) for _ in range(4))
        dlse = randn(bh, seq, 1)
        io_bytes = bh * seq * d * es
        for kind in RING_BIASES:
            bias = biases[kind]
            what = f"ring {kind} B={bsz} H={heads} S={seq} {dtname}"
            o, lse = FA.flash_fwd(q, k, v, bias)
            po, plse = FA.flash_fwd_plain(q, k, v, bias)
            err_o = agree(torch, f"{what} o", o, po, dtname, TOL_F32)
            lerr = float(((lse - plse).abs() /
                          plse.abs().clamp_min(1.0)).max())
            log(f"  {what} lse: max|Δ|/max(1,|lse|) {lerr:.3e} "
                f"(tolerance {TOL_LSE:.1e})")
            check(lerr <= TOL_LSE, f"{what}: lse disagrees ({lerr})")
            check(bool(torch.isfinite(lse).all()),
                  f"{what}: an lse is not finite")
            rows = slice(0, heads) if kind == "padding" else \
                (slice(None) if kind == "causal_future" else None)
            if rows is not None:
                mean_v = v[rows].float().mean(dim=1, keepdim=True)
                agree(torch, f"{what} all-masked rows vs mean(V)",
                      o[rows].float(), mean_v.expand_as(o[rows]), dtname,
                      TOL_F32)
            grads = FA.flash_bwd(q, k, v, bias, o, lse, do, dlse=dlse)
            refs = FA.flash_bwd_plain(q, k, v, bias, o, lse, do, dlse=dlse)
            errs = [agree(torch, f"{what} {n}", g, r, dtname, TOL_GRAD,
                          relative=True)
                    for n, g, r in zip(("dq", "dk", "dv"), grads, refs)]
            if kind != "padding":
                continue
            # timed on the padding bias (the main path's block bias)
            extra = bias.numel() * 4 + 2 * bh * seq * 4    # lse, delta
            nbytes = 4 * io_bytes + bias.numel() * 4 + bh * seq * 4
            flops = 4 * bh * seq * seq * d
            q4, k4, v4 = (t.view(bsz, heads, seq, d) for t in (q, k, v))
            lib = None
            try:
                b4 = bias.view(bsz, 1, seq, seq).to(dt).expand(
                    bsz, heads, seq, seq)
                torch.ops.aten._scaled_dot_product_efficient_attention(
                    q4, k4, v4, b4, True)
                lib = time_ms(torch, lambda: torch.ops.aten.
                              _scaled_dot_product_efficient_attention(
                                  q4, k4, v4, b4, True))
            except RuntimeError as e:
                log(f"  {what}: the library's lse-returning call refused "
                    f"the inputs ({str(e).splitlines()[0][:120]})")
            bound = None
            if dtname == "float32":
                bound = bound_ms(nbytes, 3 * flops, "tf32")
            record("flash_attention_fwd_ring", [bsz, heads, seq, d, kind],
                   dtname, max(err_o, lerr),
                   time_ms(torch, lambda: FA.flash_fwd(q, k, v, bias)),
                   time_ms(torch, lambda: FA.flash_fwd_plain(q, k, v, bias)),
                   lib, nbytes, flops, bound=bound,
                   library_is="_scaled_dot_product_efficient_attention("
                   "compute_log_sumexp=True)")
            delta = (do.float() * o.float()).sum(dim=-1) - dlse.view(bh, seq)
            args = (q, k, v, bias, do, lse, delta)
            ds = FA.flash_bwd_dkv(*args)[2]
            dq_ms = time_ms(torch, lambda: FA.flash_bwd_dq_ds(k, ds, seq))
            dkv_ms = time_ms(torch, lambda: FA.flash_bwd_dkv(*args))
            del ds
            plain_bwd = time_ms(torch, lambda: FA.flash_bwd_plain(
                q, k, v, bias, o, lse, do, dlse=dlse))
            work = {"dq": (5 * io_bytes + extra, 6 * bh * seq * seq * d),
                    "dkv": (6 * io_bytes + extra, 8 * bh * seq * seq * d)}
            for name, err, ms in (("dq", errs[0], dq_ms),
                                  ("dkv", max(errs[1:]), dkv_ms)):
                nb, fl = work[name]
                record(f"flash_attention_bwd_{name}_ring",
                       [bsz, heads, seq, d, kind, "dlse"], dtname, err, ms,
                       plain_bwd, None, nb, fl,
                       bound=bound_ms(nb, 3 * fl, "tf32")
                       if dtname == "float32" else None)


def tpsp_launches(main, leg):
    """Launches a step of phase 18's built program: #1-#3 once a
    ``fused_attention`` op a ring step (the sp degree on (a), one step on
    (b) and (c)), the LayerNorm forward and backward once a
    ``layer_norm`` op, Adam one launch for the whole update."""
    ops = main.global_block().ops
    attn = sum(op.type == "fused_attention" for op in ops) * \
        (SP_DEGREE if leg == "a" else 1)
    ln = sum(op.type == "layer_norm" for op in ops)
    return {"flash_attention_fwd": attn, "flash_attention_bwd_dq": attn,
            "flash_attention_bwd_dkv": attn, "layer_norm_fwd": ln,
            "layer_norm_bwd": ln, "adam": 1}


def tpsp_config(leg):
    """Phase 18's model: BERT-base's width at MP_LAYERS layers; attention
    dropout 0 on (a) and (c) (the ring applies none, and the one-rank
    reference would), 0.1 on (b)."""
    from paddle_tpu_torch.models import bert
    cfg = cut_depth(bert.BertConfig.base(), MP_LAYERS)
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = DROPOUT if leg == "b" else 0.0
    return cfg


def tpsp_batch(np, cfg, leg):
    """The global batch: (a) 4 x 512 with TPSP_PER_SHARD masked tokens in
    each sp half of every row (the loss is the per-shard weighted mean,
    averaged over the shards: equal counts make it the global mean);
    (b) 32 x 128 as make_fake_parallel_batch draws it; (c) 32 x 128 with
    TRAIN_MASKS // 2 masked tokens in each sp half of every row (the same
    count in every batch and sequence shard of every layout it runs
    on)."""
    from paddle_tpu_torch.models import bert
    rng = np.random.RandomState(SEED)
    if leg == "b":
        return bert.make_fake_parallel_batch(rng, cfg, TP_BATCH, TP_SEQ)
    rows, seq, per = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS // 2) \
        if leg == "c" else (TPSP_BATCH, TPSP_SEQ, TPSP_PER_SHARD)
    feed = bert.make_fake_parallel_batch(rng, cfg, rows, seq)
    w = np.zeros((rows, seq), np.float32)
    half = seq // 2
    for i in range(rows):
        for h in range(2):
            w[i, h * half + rng.choice(half, per, replace=False)] = 1.0
    feed["lm_weights"] = w
    return feed


def tpsp_optimizer(leg):
    """Phase 18's optimizer, made from a ``fluid``: phase 8's recipe (its
    global-norm clip included) on (c), Adam at TPSP_LR on (a) and (b)."""
    if leg == "c":
        return recipe_optimizer
    return lambda fluid: fluid.optimizer.Adam(TPSP_LR)


def tpsp_layout(leg):
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    return MeshLayout(**TPSP_LAYOUTS[leg])


def build_tpsp_train(cfg, layout, optimizer):
    """Phase 18's program: ``build_pretrain_network_parallel`` at
    ``layout``'s tp degree (ring attention over ``sp`` where the layout
    has that axis), ``optimizer(fluid)`` minimized, rewritten by
    ``apply_fsdp_sharding`` where the layout has a fsdp axis and compiled
    ``with_mesh`` over it: the batch over its dp and fsdp axes, every
    feed split (batch, "sp") under sp, the gradient sync bucketed at 32
    MB.  ``layout`` None: the one-rank reference, built with
    ``tp_degree=1, seq_axis=None``.  Returns (program to run, main,
    startup, loss)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    seq = "sp" if layout is not None and layout.size("sp") > 1 else None
    with fluid.program_guard(main, startup):
        feeds, loss = bert.build_pretrain_network_parallel(
            cfg, tp_degree=layout.tp if layout is not None else 1,
            seq_axis=seq)
        optimizer(fluid).minimize(loss)
    if layout is None:
        return main, main, startup, loss
    if layout.fsdp > 1:
        apply_fsdp_sharding(main, layout)
    main._mesh_layout = layout
    build = fluid.BuildStrategy()
    build.fuse_all_reduce_ops = True
    batch = layout.batch_axes or "dp"
    program = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=loss.name, batch_axis=batch,
        seq_axis=seq,
        feed_specs={f.name: (batch, "sp") for f in feeds} if seq else None,
        build_strategy=build)
    return program, main, startup, loss


def params_sha(np, scope, main):
    """sha256 over every parameter's value in ``scope``, in name order
    (the startup's global values, before any rank cuts its blocks)."""
    import hashlib
    h = hashlib.sha256()
    for p in sorted(main.all_parameters(), key=lambda p: p.name):
        h.update(p.name.encode())
        h.update(scope.find_var(p.name).detach().contiguous().cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def timed_comm(torch, names, kind_of):
    """Wrap the gloo transfers ``names`` of collective_ops (each taking
    its group and its tensor, a list of tensors or of (shape, dtype)
    pairs first) so a step can report their wall ms, calls and bytes by
    ``kind_of(name, group)``.  Each is synchronised first, so the time is
    the transfer's.  Returns (totals, undo)."""
    from paddle_tpu_torch.ops import collective_ops as C
    totals = {}

    def nbytes(t):
        return sum(math.prod(x[0]) * 4 if isinstance(x, tuple) else
                   x.numel() * x.element_size()
                   for x in (t if isinstance(t, (list, tuple)) else [t]))

    def wrap(name, fn):
        def timed(g, t, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(g, t, *args, **kw)
            torch.cuda.synchronize()
            row = totals.setdefault(kind_of(name, g),
                                    {"ms": 0.0, "calls": 0, "bytes": 0})
            row["ms"] += (time.perf_counter() - t0) * 1e3
            row["calls"] += 1
            row["bytes"] += nbytes(t)
            return out
        return timed

    saved = {n: getattr(C, n) for n in names}
    for n, fn in saved.items():
        setattr(C, n, wrap(n, fn))

    def undo():
        for n, fn in saved.items():
            setattr(C, n, fn)
    return totals, undo


def _axes(g):
    return g.axis_name if isinstance(g.axis_name, tuple) else (g.axis_name,)


def comm_by_kind(torch):
    """Phase 18's gloo transfers by kind: the tp all-reduces (the clip's
    squares over tp among them), the tp gathers (the LM head's logits),
    the ring's point-to-point shifts, the fsdp gathers and their
    backward's reduce-scatters, and the gradient sync over the batch and
    sequence axes (the clip's squares over fsdp among them)."""
    def kind_of(name, g):
        if name == "ring_shift":
            return "ring P2P"
        if _axes(g) == ("tp",):
            return "tp all-reduce" if name == "all_reduce" else \
                f"tp {name.replace('_', '-')}"
        if _axes(g) == ("fsdp",) and name != "all_reduce":
            return "fsdp gather" if name == "all_gather" else \
                "fsdp reduce-scatter"
        return "grad sync"
    return timed_comm(torch, ("all_to_all", "all_gather", "all_reduce",
                              "broadcast", "ring_shift"), kind_of)


def fetched_loss(value):
    """A fetched loss as one float: under a batch axis the (1,) loss
    comes back one element a batch shard, each its shard's weighted mean
    (equal masked counts make their mean the global one)."""
    return float(value.numpy().astype("float64").mean())


def replica_digests(np, dp, scope, main):
    """{persistable: [[the axes it is a block over, this rank's block
    index along them] (empty where it is held whole), the sha256 of its
    bytes as this rank holds them]}: the ranks with the same key must
    hold the same bytes."""
    import hashlib
    from paddle_tpu_torch.ops.collective_ops import _sharding
    out = {}
    for v in main.list_vars():
        t = scope.find_var(v.name) if v.persistable else None
        if t is None or not hasattr(t, "detach"):
            continue
        sh = _sharding(dp, v)
        key = [] if sh is None else [list(_axes(sh[1])), sh[1].rank]
        out[v.name] = [key, hashlib.sha256(
            t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()]
    return out


def tpsp_leg(torch, np, leg, out_dir):
    """One rank of phase 18 leg (a), (b) or (c): the startup (its global
    parameters' sha256), TPSP_STEPS prepared steps with the launches and
    fallbacks counted, one step with the gloo transfers timed by kind,
    one profiled step, the peak allocated bytes, and the digests of each
    block after the steps (:func:`replica_digests`); (c) also its static
    estimate against the bytes held, step 1's global norm, and
    :func:`fsdp_tp_restores`."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    rank = fleet.worker_index()
    dev = torch.device("cuda", fleet.place.device_id)
    cfg = tpsp_config(leg)
    feed = tpsp_batch(np, cfg, leg)
    program, main, startup, loss = build_tpsp_train(
        cfg, tpsp_layout(leg), tpsp_optimizer(leg))
    dp = program._dp
    want = TP_RANKS if leg == "b" else TPSP_RANKS
    check(dp is not None and dp.world == want,
          f"({leg}): the program does not run over {want} ranks")
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    out = {"rank": rank, "leg": leg,
           "init_sha256": params_sha(np, scope, main),
           "expected": tpsp_launches(main, leg),
           "allocated_after_startup": torch.cuda.memory_allocated(dev)}
    norm = None
    if leg == "c":
        est, state_in, written = memory_estimate(program, feed, loss.name)
        out["estimate"] = {"state_bytes": est.state_bytes,
                           "peak_bytes": est.peak_bytes}
        norm = global_norm_name(main)
        out["allreduce_axes"] = sorted(
            str(op.attrs["_axis_name"]) for op in main.global_block().ops
            if op.type == "c_global_norm_allreduce")
    torch.cuda.reset_peak_memory_stats(dev)
    prepared = exe.prepare(program, fetch_list=[loss] + (
        [norm] if norm else []), scope=scope, donate_state=True)
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, step_s = [], []
    first_step()
    for i in range(TPSP_STEPS):
        t0 = time.perf_counter()
        got = prepared.run(feed)
        losses.append(fetched_loss(got[0]))
        step_s.append(time.perf_counter() - t0)
        if norm and i == 0:
            out["step1_global_norm"] = float(got[1].numpy().reshape(-1)[0])
    stamp("steps", sum(step_s))
    out["launches"] = {f"{k}/{dt}": n for (k, dt), n in
                       kernels.launch_counts_by_dtype().items()}
    out["fallbacks"] = {str(k): v for k, v in
                        registry.route_counts("fallback").items()}
    out["ring_hits"] = sum(v for k, v in registry.route_counts("hit").items()
                           if k[1] == "ring_flash_attention")
    out["losses"], out["step_s"] = losses, step_s
    out["step_ms_median"] = statistics.median(step_s[1:]) * 1e3
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    fluid.sync_prepared_state(scope)
    if leg == "c":
        out["held"], out["predicted"], out["moment_bytes"], \
            out["param_bytes"] = held_bytes(torch, dp, scope, main)
        out["state_in_held"] = scope_bytes(torch, scope, state_in)
        out["left_out"] = left_out_bytes(torch, dp, scope, main, state_in,
                                         written)
        out.update(fsdp_tp_save(torch, np, exe, dp, main, scope, out_dir))
        t0 = time.perf_counter()
        out["loss_next"] = fetched_loss(prepared.run(feed)[0])
        stamp("steps", time.perf_counter() - t0)
    totals, undo = comm_by_kind(torch)
    try:
        t0 = time.perf_counter()
        prepared.run(feed)[0].numpy()
        out["comm_step_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    out["comm"] = totals
    out["profile"] = profile_step(
        torch, lambda: prepared.run(feed)[0].numpy(),
        out["step_ms_median"])
    fluid.sync_prepared_state(scope)
    out["replica_sha256"] = replica_digests(np, dp, scope, main)
    out["held_bytes"] = sum(
        scope.find_var(v.name).numel() * scope.find_var(v.name)
        .element_size() for v in main.list_vars()
        if v.persistable and torch.is_tensor(scope.find_var(v.name)))
    log(f"[rank {rank}] ({leg}) losses {[round(x, 5) for x in losses]}, "
        f"step {out['step_ms_median']:.1f} ms")
    del prepared, scope, exe
    torch.cuda.empty_cache()
    if leg == "c":
        out["restores"] = fsdp_tp_restores(torch, np, cfg, feed, out_dir)
    return out


def fsdp_tp_save(torch, np, exe, dp, main, scope, out_dir):
    """(c)'s state after its steps: the global value's digests, then
    ``save_checkpoint(sharded=True)`` under ``fsdp_tp_ckpt`` (each block
    written once, by the ranks at coordinate 0 of the axes it is
    replicated over): the seconds and this rank's bytes written."""
    from paddle_tpu_torch import io
    out = {"saved_sha256": global_digests(np, dp, scope, main)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = io.save_checkpoint(exe, os.path.join(out_dir, "fsdp_tp_ckpt"),
                           io.TrainStatus(TPSP_STEPS), main, scope=scope,
                           sharded=True)
    out["save_s"] = time.perf_counter() - t0
    stamp("saves", out["save_s"])
    out["written_bytes"] = sum(
        os.path.getsize(os.path.join(d, f"{stem}_{dp.rank}.{ext}"))
        for stem, ext in (("shard_data", "npz"), ("shard_manifest", "json")))
    return out


def fsdp_tp_restores(torch, np, cfg, feed, out_dir):
    """(c)'s sharded save restored onto each of FSDP_TP_RESTORES in this
    process: a freshly built program and ``Scope``, ``load_checkpoint``
    reading the files back (the seconds, the bytes this rank read against
    its planned bytes, the reshard's steps and wire bytes), the restored
    global state's digests, then one step (the step (c) took after its
    save)."""
    from paddle_tpu_torch import fluid, io
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    out = {}
    for name, layout in FSDP_TP_RESTORES.items():
        program, main, _, loss = build_tpsp_train(
            cfg, MeshLayout(**layout), tpsp_optimizer("c"))
        dp = program._dp
        scope = fluid.Scope()
        exe = fluid.Executor(fleet.place)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = io.load_checkpoint(exe, os.path.join(out_dir, "fsdp_tp_ckpt"),
                                main_program=main, scope=scope)
        torch.cuda.synchronize()
        m = {"load_s": time.perf_counter() - t0, "epoch": st.epoch_no,
             "bytes_read": st.read_stats["bytes_read"],
             "planned_bytes": st.read_stats["planned_bytes"],
             "wire_bytes": st.reshard["wire_bytes"] if st.reshard else None,
             "reshard_steps": st.reshard["steps_by_kind"] if st.reshard
             else None,
             "restored_sha256": global_digests(np, dp, scope, main)}
        stamp("loads", m["load_s"])
        prepared = exe.prepare(program, fetch_list=[loss], scope=scope,
                               donate_state=True)
        t0 = time.perf_counter()
        m["loss_after"] = fetched_loss(prepared.run(feed)[0])
        stamp("steps", time.perf_counter() - t0)
        out[name] = m
        del prepared, scope, exe
        torch.cuda.empty_cache()
    return out


def tpsp_worker(out_dir, legs):
    """One rank of phase 18 (``--tpsp-worker DIR LEGS``): the legs LEGS
    ("ac" on four ranks, "b" on two) in turn (:func:`tpsp_leg`); writes
    ``tpsp<r>_<legs>.json``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    check(fleet.backend == "gloo", f"rank {rank} on {fleet.backend}")
    res = {"rank": rank}
    for leg in legs:
        res[leg] = tpsp_leg(torch, np, leg, out_dir)
    res["stamps"] = dict(_STAMPS)
    with open(os.path.join(out_dir, f"tpsp{rank}_{legs}.json"), "w") as f:
        json.dump(res, f)
    return 0


def tpsp_reference(torch, np, leg):
    """(a)'s or (c)'s one-rank reference: the same program built with
    ``tp_degree=1, seq_axis=None`` on this process, from the same seed
    (its parameters' sha256 held to the ranks' startup), TPSP_STEPS
    prepared steps on the same global batch: the losses, the step."""
    from paddle_tpu_torch import fluid
    cfg = tpsp_config(leg)
    feed = tpsp_batch(np, cfg, leg)
    program, main, startup, loss = build_tpsp_train(cfg, None,
                                                    tpsp_optimizer(leg))
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    sha = params_sha(np, scope, main)
    prepared = exe.prepare(program, fetch_list=[loss], scope=scope,
                           donate_state=True)
    losses, step_s = [], []
    for _ in range(TPSP_STEPS):
        t0 = time.perf_counter()
        losses.append(float(prepared.run(feed)[0]))
        step_s.append(time.perf_counter() - t0)
    del prepared, scope
    torch.cuda.empty_cache()
    return {"losses": losses, "init_sha256": sha,
            "step_ms_median": statistics.median(step_s[1:]) * 1e3}


def tpsp_launch(torch, repo, out_dir, nproc, legs):
    """``nproc`` ranks of this script on the card over gloo for the legs
    ``legs``; returns their JSON results."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--selected_gpus", ",".join(["0"] * nproc),
           "--backend", "gloo", "--timeout", str(TPSP_TIMEOUT_S),
           os.path.join(repo, "chip_smoke.py"), "--tpsp-worker", out_dir,
           legs]
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=repo, timeout=TPSP_TIMEOUT_S + 60,
                        env=launch_env()).returncode
    wall = time.perf_counter() - t0
    log(f"  legs {legs} on {nproc} ranks: ran {wall:.1f} s, exit code {rc}")
    check(rc == 0, f"phase 18 legs {legs}: a rank failed (exit code {rc})")
    ranks = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"tpsp{r}_{legs}.json")) as f:
            ranks.append(json.load(f))
    launch_line(f"phase 18 launch {legs}", ranks, wall)
    return ranks


def tpsp_report(leg, ranks, ref=None):
    """The gates of leg (a) or (b) and its printed figures: finite losses,
    every rank the same; the same startup on every rank (and the
    reference's); no fallback; the launches a step; each block (a
    replicated persistable whole) bit for bit the same on the ranks that
    share its coordinates; (a)'s losses within TOL_TPSP_LOSS of the
    one-rank run's."""
    what = f"({leg}) {TPSP_LEG_NAMES[leg]}"
    m0 = ranks[0]
    for r, m in enumerate(ranks):
        who = f"{what} rank {r}"
        check(all(math.isfinite(x) for x in m["losses"]),
              f"{who}: losses not finite: {m['losses']}")
        check(m["losses"] == m0["losses"],
              f"{who}: fetched other losses than rank 0")
        check(m["init_sha256"] == m0["init_sha256"],
              f"{who}: another startup than rank 0's")
        check(not m["fallbacks"], f"{who}: fallbacks {m['fallbacks']}")
        want = {f"{k}/float32": n for k, n in m["expected"].items()}
        got = m["launches"]
        for key in set(want) | set(got):
            check(got.get(key, 0) == want.get(key, 0) * TPSP_STEPS,
                  f"{who}: {key} launched {got.get(key, 0)} times in "
                  f"{TPSP_STEPS} steps, expected {want.get(key, 0)} a step")
    blocks = {}
    for m in ranks:
        for name, (key, sha) in m["replica_sha256"].items():
            blocks.setdefault((name, json.dumps(key)), set()).add(sha)
    split = sorted(k for k, v in blocks.items() if len(v) > 1)
    check(not split, f"{what}: ranks with the same coordinates hold other "
                     f"bytes: {split[:5]}")
    check(len({len(m["replica_sha256"]) for m in ranks}) == 1,
          f"{what}: the ranks hold different persistables")
    check((m0["ring_hits"] > 0) == (leg == "a"),
          f"{what}: {m0['ring_hits']} ring route hits")
    report = {k: m0[k] for k in ("losses", "step_ms_median", "comm_step_ms",
                                 "comm", "peak_bytes", "held_bytes",
                                 "expected")}
    report["busy_share"] = m0["profile"]["busy_share"] if m0["profile"] \
        else None
    if ref is not None:
        check(ref["init_sha256"] == m0["init_sha256"],
              f"{what}: the one-rank run started from other parameters")
        gap = max(abs(a - b) / abs(b) for a, b in
                  zip(m0["losses"], ref["losses"]))
        log(f"  {what}: losses {m0['losses']} vs one rank "
            f"{ref['losses']}: {gap:.3e} (tolerance {TOL_TPSP_LOSS})")
        check(gap <= TOL_TPSP_LOSS, f"{what}: losses {gap:.3e} from the "
                                    f"one-rank run's")
        report.update(loss_gap=gap, one_rank_losses=ref["losses"],
                      one_rank_step_ms=ref["step_ms_median"])
    comm = m0["comm"]
    log(f"  {what}: step {m0['step_ms_median']:.1f} ms (median of steps "
        f"2-{TPSP_STEPS}); one step with its gloo transfers timed "
        f"{m0['comm_step_ms']:.1f} ms: "
        + ", ".join(f"{k} {v['ms']:.1f} ms in {v['calls']} calls "
                    f"({v['bytes'] / 1e6:.1f} MB)"
                    for k, v in sorted(comm.items()))
        + f"; device busy "
        + (f"{100 * report['busy_share']:.1f} %" if report["busy_share"]
           is not None else "not measured")
        + f"; peak allocated {m0['peak_bytes'] / 1e9:.3f} GB, persistent "
        f"{m0['held_bytes'] / 1e9:.4f} GB a rank ({len(ranks)} ranks on one "
        f"card over gloo, staged through the host)")
    return report


def fsdp_tp_report(ranks, ckpt):
    """(c)'s gates beyond :func:`tpsp_report`'s, and its printed figures:
    the static estimate of a rank's persistent bytes what it holds (only
    ``learning_rate_0`` left out), the clip's squares summed once over
    fsdp and once over tp and binding on every rank alike, the sharded
    save every block once, and each restore's state bit for bit
    the saved one, its bytes read the planned ones and its next step
    within TOL_TPSP_LOSS of (c)'s."""
    what = f"(c) {TPSP_LEG_NAMES['c']}"
    m0 = ranks[0]
    for r, m in enumerate(ranks):
        who = f"{what} rank {r}"
        check(m["held"] == m["predicted"],
              f"{who}: the scope holds {m['held']} bytes of persistables, "
              f"the layout predicts {m['predicted']}")
        check(set(m["left_out"]) <= {"learning_rate_0"},
              f"{who}: persistables outside the estimate: "
              f"{sorted(m['left_out'])}")
        check_estimate(who, m)
        check(m["allreduce_axes"] == ["fsdp", "tp"],
              f"{who}: the clip's all-reduces run over "
              f"{m['allreduce_axes']}")
        check(m["step1_global_norm"] > CLIP_NORM and
              m["step1_global_norm"] == m0["step1_global_norm"],
              f"{who}: step 1's global norm {m['step1_global_norm']} (rank "
              f"0 {m0['step1_global_norm']}) does not bind the clip "
              f"{CLIP_NORM} alike on every rank")
        check(m["saved_sha256"] == m0["saved_sha256"],
              f"{who}: gathered another global state than rank 0")
    covered, total, twice = shard_coverage(ckpt)
    check(not twice, f"{what}: blocks written twice: {twice[:3]}")
    check(set(total) == set(m0["saved_sha256"]) and covered == total,
          f"{what}: the blocks do not cover each persistable once")
    written = [m["written_bytes"] for m in ranks]
    log(f"  {what}: step 1's global norm {m0['step1_global_norm']:.4f} "
        f"(clip {CLIP_NORM}: binds), squares summed over "
        f"{m0['allreduce_axes']}; persistent {m0['held'] / 1e9:.4f} GB a "
        f"rank (moments {m0['moment_bytes'] / 1e9:.4f} GB, parameters "
        f"{m0['param_bytes'] / 1e9:.4f} GB); sharded save "
        f"{max(m['save_s'] for m in ranks):.2f} s (the slowest rank), "
        f"{sum(written) / 1e9:.4f} GB written ({', '.join(map(str, written))}"
        f" B), every block once")
    report = {"save_s": [m["save_s"] for m in ranks],
              "written_bytes": written, "held": m0["held"],
              "moment_bytes": m0["moment_bytes"],
              "param_bytes": m0["param_bytes"], "estimate": m0["estimate"],
              "allocated_after_startup": m0["allocated_after_startup"],
              "step1_global_norm": m0["step1_global_norm"],
              "loss_next": m0["loss_next"], "restores": {}}
    for name in FSDP_TP_RESTORES:
        for r, m in enumerate(ranks):
            got = m["restores"][name]
            who = f"{what} restored onto {name} rank {r}"
            differ = sorted(n for n in m0["saved_sha256"]
                            if got["restored_sha256"].get(n) !=
                            m0["saved_sha256"][n])
            check(got["epoch"] == TPSP_STEPS and not differ and
                  set(got["restored_sha256"]) == set(m0["saved_sha256"]),
                  f"{who}: epoch {got['epoch']}, restored global state "
                  f"differs from the saved one: {differ[:5]}")
            check(got["bytes_read"] == got["planned_bytes"],
                  f"{who}: read {got['bytes_read']} bytes, planned "
                  f"{got['planned_bytes']}")
            gap = abs(got["loss_after"] - m["loss_next"]) / \
                abs(m["loss_next"])
            got["loss_gap"] = gap
            check(gap <= TOL_TPSP_LOSS,
                  f"{who}: the next step's loss {got['loss_after']} vs "
                  f"(c)'s {m['loss_next']}: {gap:.3e}")
        g = m0["restores"][name]
        log(f"  {what} restored onto {name}: load_checkpoint "
            f"{g['load_s']:.2f} s, read {g['bytes_read'] / 1e9:.4f} GB a "
            f"rank (planned {g['planned_bytes'] / 1e9:.4f} GB), reshard "
            f"wire {(g['wire_bytes'] or 0) / 1e9:.4f} GB "
            f"{g['reshard_steps']}; the restored state bit for bit the "
            f"saved one; the next step's loss {g['loss_after']} vs (c)'s "
            f"{m0['loss_next']} ("
            f"{max(m['restores'][name]['loss_gap'] for m in ranks):.3e})")
        report["restores"][name] = {k: g[k] for k in (
            "load_s", "bytes_read", "planned_bytes", "wire_bytes",
            "reshard_steps", "loss_after", "loss_gap")}
    return report


def tpsp_phase(torch, np, repo, results):
    """Phase 18 (see the module docstring); returns rank 0's launches by
    leg and the report."""
    from paddle_tpu_torch.ops.cuda import build
    ring_kernel_checks(torch, results)
    out_dir = os.path.join(build.BUILD_DIR, "smoke_tpsp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        refs = {leg: tpsp_reference(torch, np, leg) for leg in "ac"}
        four = tpsp_launch(torch, repo, out_dir, TPSP_RANKS, "ac")
        fsdp_tp = fsdp_tp_report(
            [r["c"] for r in four],
            os.path.join(out_dir, "fsdp_tp_ckpt", f"checkpoint_{TPSP_STEPS}"))
        two = tpsp_launch(torch, repo, out_dir, TP_RANKS, "b")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    report = {leg: tpsp_report(leg, [r[leg] for r in four], refs[leg])
              for leg in "ac"}
    report["b"] = tpsp_report("b", [r["b"] for r in two])
    report["c"].update(fsdp_tp)
    launches = {path: {k.split("/")[0]: v for k, v in
                       ranks[0][leg]["launches"].items()}
                for path, leg, ranks in (("tp_sp", "a", four),
                                         ("fsdp_tp", "c", four),
                                         ("tp", "b", two))}
    return launches, report


# ---------------------------------------------------------------------------
# phase 19: pipeline parallelism at BERT-base width, MP_LAYERS layers
# ---------------------------------------------------------------------------

PIPE_STAGES, PIPE_M, PIPE_STEPS = 2, 4, 4
PIPE_DP_BATCH = 64        # (d): 32 rows a data-parallel rank
PIPE_RANKS_D = 4
TOL_PIPE_LOSS = 1e-5      # losses vs the one-rank run (relative)
TOL_PIPE_PARAM = 1e-5     # parameters after the steps vs it (abs)
PIPE_TIMEOUT_S = 600
#: the two-rank launch's legs: (schedule, chunks, dropout)
PIPE_LEGS = {"a": ("1f1b", 1, 0.0), "b_zb": ("zero_bubble", 1, 0.0),
             "b_il": ("interleaved", 2, 0.0), "c": ("1f1b", 1, DROPOUT)}
PIPE_LEG_NAMES = {"a": "1F1B pp 2", "b_zb": "zero-bubble pp 2",
                  "b_il": "interleaved pp 2 x chunks 2",
                  "c": "1F1B pp 2, dropout 0.1",
                  "d": "dp 2 x pp 2 through fleet, pipe-sharded weights"}
#: op type -> (the kernels its forward launches, those its backward
#: launches); "gelu": a fused_elemwise_activation of add + GELU
PIPE_KERNEL_OPS = {
    "fused_attention": (("flash_attention_fwd",),
                        ("flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv")),
    "layer_norm": (("layer_norm_fwd",), ("layer_norm_bwd",)),
    "fused_add_layernorm": (("add_layer_norm_fwd",),
                            ("add_layer_norm_bwd",)),
    "gelu": (("bias_gelu_fwd",), ("bias_gelu_bwd",)),
}


def pipe_config(dropout):
    """Phase 19's model: BERT-base's width at MP_LAYERS layers, at
    ``dropout`` (hidden and attention)."""
    from paddle_tpu_torch.models import bert
    cfg = cut_depth(bert.BertConfig.base(), MP_LAYERS)
    cfg.hidden_dropout_prob = dropout
    cfg.attention_probs_dropout_prob = dropout
    return cfg


def pipe_feed_shapes(feed, M):
    """A microbatch's (shape, dtype) of every feed: the stage planner's
    shapes."""
    return {n: ((v.shape[0] // M,) + tuple(v.shape[1:]), str(v.dtype))
            for n, v in feed.items()}


def build_pipe_train(cfg, feed, schedule="1f1b", chunks=1, M=PIPE_M,
                     stages=PIPE_STAGES, via_fleet=False, clip=True):
    """Phase 19's program: phase 8's BERT-base pretraining, recipe and
    fusion passes (``fuse_add_layernorm`` on the program,
    ``fuse_elewise_add_act_ops`` through the build strategy).  ``stages``
    > 1: ``apply_pipeline(main, stages, M, schedule, chunks)`` and
    ``with_mesh`` over ``MeshLayout(pipe=stages)``; ``via_fleet``: (d),
    phase 15's recipe (no norm clip: a pipe-sharded gradient is a block)
    through ``fleet`` with ``strategy.pipeline`` (``shard_weights``) over
    the job's ranks split into (dp, pp); ``stages`` 1: the one-rank run,
    ``set_microbatches(main, M)`` and both passes on the program itself
    (``clip`` False: phase 15's recipe).  Returns (the program to run,
    main, startup, loss)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.framework.pipe import (apply_pipeline,
                                                 set_microbatches)
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    build = fluid.BuildStrategy()
    build.fuse_elewise_add_act_ops = True
    shapes = pipe_feed_shapes(feed, M * (2 if via_fleet else 1))
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        if via_fleet:
            s = DistributedStrategy()
            s.build_strategy = build
            s.pipeline = True
            s.pipeline_configs = {"accumulate_steps": M,
                                  "num_stages": stages,
                                  "shard_weights": True,
                                  "feed_shapes": shapes}
            fleet.distributed_optimizer(zero_optimizer(fluid),
                                        s).minimize(total)
        else:
            (recipe_optimizer(fluid) if clip else
             zero_optimizer(fluid)).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    if via_fleet:
        main._mesh_layout = MeshLayout(data=PIPE_RANKS_D // stages,
                                       pipe=stages)
        return fleet.main_program, main, startup, total
    if stages == 1:
        set_microbatches(main, M)
        apply_pass(main, "fuse_elemwise_add_act", fetch_names=[total.name])
        return main, main, startup, total
    apply_pipeline(main, stages, M, schedule=schedule, chunks=chunks,
                   feed_shapes=shapes)
    layout = MeshLayout(pipe=stages)
    main._mesh_layout = layout
    program = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=total.name, batch_axis="dp",
        build_strategy=build)
    return program, main, startup, total


def kernel_op_key(op):
    """The PIPE_KERNEL_OPS key of a forward op (a fused add + activation
    counts when its activation is GELU), or None."""
    key = op.type
    if key == "fused_elemwise_activation":
        key = "gelu" if "gelu" in op.attrs.get("functor_list", ()) else None
    return key if key in PIPE_KERNEL_OPS else None


def pipe_expected(program, loss_name, pp_rank, S, M, family, chunks):
    """Launches a rank makes a step, from the program and the schedule:
    each virtual stage's forward kernels once per F unit and once per
    recompute (each B unit, and each W unit under zero-bubble), its
    backward kernels once per B and W unit; #10 once."""
    from paddle_tpu_torch.framework.pipe import KIND_IDLE, simulate_schedule
    variant = program._variant_for([loss_name]) \
        if hasattr(program, "_variant_for") else program
    ops = variant.global_block().ops
    V = S * chunks
    per = [({}, {}) for _ in range(V)]
    for op in ops:
        if op.type == "backward":
            break
        key = kernel_op_key(op)
        if key is None:
            continue
        k = int(op.attrs.get("_pipe_stage", 0))
        for side, names in zip(per[k], PIPE_KERNEL_OPS[key]):
            for n in names:
                side[n] = side.get(n, 0) + 1
    sch = simulate_schedule(family, S, M, chunks=chunks)
    want = {"adam": 1}
    for t in range(sch["ticks"]):
        kind = sch["kind"][t][pp_rank]
        if kind == KIND_IDLE:
            continue
        fwd, bwd = per[sch["vstage"][t][pp_rank]]
        for side in (fwd,) if kind == 1 else (fwd, bwd):
            for n, c in side.items():
                want[n] = want.get(n, 0) + c
    return want


def pipe_comm(torch):
    """Phase 19's gloo transfers by kind: the point-to-point hops (sends
    unwaited: their staging), the all-reduces over pp (the gradient sum,
    and the loss and census sum), over dp (the data-parallel gradient
    sync), and the pipe-sharded weights' gather and gradient scatter."""
    def kind_of(name, g):
        if name in ("isend_to", "recv_from"):
            return "pp hops"
        if name == "all_reduce":
            return "pp all-reduce" if _axes(g) == ("pp",) else \
                "dp grad sync"
        return "pp weight gather/scatter"
    return timed_comm(torch, ("isend_to", "recv_from", "all_reduce",
                              "all_gather", "all_to_all"), kind_of)


def pipe_params_gap(torch, got, ref):
    """max|Δ| over every parameter; each ``*_qkv_b``'s key third left
    out (its gradient is exactly zero, and Adam turns the rounding noise
    there into ±LR steps)."""
    err = 0.0
    for n, r in ref.items():
        d = (got[n] - r).abs()
        if n.endswith("_qkv_b"):
            h = r.shape[0] // 3
            d = torch.cat([d[:h], d[2 * h:]])
        err = max(err, float(d.max()))
    return err


def pipe_reference(torch, np, cfg, feed, M, via_fleet):
    """The one-rank run on this process: the same program (phase 15's
    recipe for (d)) with ``set_microbatches(main, M)``, PIPE_STEPS
    prepared steps on ``feed`` from the seed: the losses, every
    parameter after them, the step ms."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    program, main, startup, loss = build_pipe_train(
        cfg, feed, M=M, stages=1, clip=not via_fleet)
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    prepared = exe.prepare(program, fetch_list=[loss], scope=scope,
                           donate_state=True)
    losses, step_s = [], []
    t0 = time.perf_counter()
    for _ in range(PIPE_STEPS):
        t1 = time.perf_counter()
        losses.append(float(prepared.run(feed)[0]))
        step_s.append(time.perf_counter() - t1)
    stamp("one-rank reference", time.perf_counter() - t0)
    fluid.sync_prepared_state(scope)
    params = {p.name: scope.find_var(p.name).clone()
              for p in main.all_parameters()}
    del prepared, scope
    torch.cuda.empty_cache()
    return {"losses": losses, "params": params,
            "step_ms_median": statistics.median(step_s[1:]) * 1e3}


def pipe_leg(torch, np, leg, ref, out_dir):
    """One leg of phase 19 on this rank: the startup, PIPE_STEPS prepared
    steps with the launches, fallbacks and each step's pipeline census,
    the launches the program and the schedule predict, the losses and
    parameters against the one-rank run ``ref``; (d) the held bytes
    against the layout, a sharded save and the state's digests, and the
    step after it; then one step with the gloo transfers timed by kind,
    one profiled step and the peak allocated bytes."""
    from paddle_tpu_torch import fluid, io
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.executor import last_pipeline_report
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    dev = torch.device("cuda", fleet.place.device_id)
    family, chunks, dropout = PIPE_LEGS.get(leg, ("1f1b", 1, 0.0))
    cfg = pipe_config(dropout)
    fed = PIPE_DP_BATCH if leg == "d" else TRAIN_BATCH
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg, fed,
                                TRAIN_SEQ, TRAIN_MASKS)
    program, main, startup, loss = build_pipe_train(
        cfg, feed, family, chunks, via_fleet=leg == "d")
    dp = program._dp
    pp = dp.over("pp")
    out = {"leg": leg, "pp_rank": pp.rank, "world": dp.world}
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    out["init_sha256"] = params_sha(np, scope, main)
    prepared = exe.prepare(program, fetch_list=[loss], scope=scope,
                           donate_state=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    if leg == "c":
        fluid.set_flags({"pipe_replay_check": True})
    losses, step_s, census = [], [], []
    first_step()
    try:
        for _ in range(PIPE_STEPS):
            t0 = time.perf_counter()
            losses.append(float(prepared.run(feed)[0]))
            step_s.append(time.perf_counter() - t0)
            rep = last_pipeline_report()
            census.append({k: rep[k] for k in (
                "census_idle_slots", "sim_idle_slots", "idle_launches",
                "rank_idle_ticks", "units", "ring_peak", "ring_slots",
                "replay_checked", "replay_mismatched", "hops", "walk_s")})
    finally:
        fluid.set_flags({"pipe_replay_check": False})
    stamp("steps", sum(step_s))
    out["launches"] = {f"{k}/{dt}": n for (k, dt), n in
                       kernels.launch_counts_by_dtype().items()}
    out["fallbacks"] = {str(k): v for k, v in
                        registry.route_counts("fallback").items()}
    out["expected"] = pipe_expected(program, loss.name, pp.rank,
                                    pp.world, PIPE_M, family, chunks)
    out["census"] = census
    out["bubble_frac"] = rep["bubble_frac"]
    out["sharded_params"] = len(rep["sharded_params"])
    out["losses"], out["step_s"] = losses, step_s
    out["step_ms_median"] = statistics.median(step_s[1:]) * 1e3
    fluid.sync_prepared_state(scope)
    params = global_params(dp, scope, main)
    if ref is not None:
        out["loss_gap"] = max(abs(a - b) / abs(b) for a, b in
                              zip(losses, ref["losses"]))
        out["param_gap"] = pipe_params_gap(torch, params, ref["params"])
        out["one_rank_losses"] = ref["losses"]
        out["one_rank_step_ms"] = ref["step_ms_median"]
    del params
    if leg == "d":
        out["held"], out["predicted"], out["moment_bytes"], \
            out["param_bytes"] = held_bytes(torch, dp, scope, main)
        t0 = time.perf_counter()
        io.save_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                           io.TrainStatus(PIPE_STEPS), main, scope=scope,
                           sharded=True)
        stamp("saves", time.perf_counter() - t0)
        out["saved_sha256"] = state_digests(np, scope, main)
    totals, undo = pipe_comm(torch)
    try:
        t0 = time.perf_counter()
        out["loss_after"] = float(prepared.run(feed)[0])
        out["comm_step_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    out["comm"] = totals
    out["profile"] = profile_step(
        torch, lambda: prepared.run(feed)[0].numpy(), out["step_ms_median"])
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del prepared, scope, exe
    torch.cuda.empty_cache()
    return out


def pipe_restore(torch, np, out_dir):
    """(e), after (d) in its four ranks: (d)'s program built afresh into
    a new ``Scope``, ``load_checkpoint`` of its sharded checkpoint read
    back from disk (no startup), the state digested as each rank holds
    it, then one step (the step (d) took after its save)."""
    from paddle_tpu_torch import fluid, io
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import bert
    torch.cuda.empty_cache()
    cfg = pipe_config(0.0)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                PIPE_DP_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    program, main, _, loss = build_pipe_train(cfg, feed, via_fleet=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    t0 = time.perf_counter()
    st = io.load_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                            main_program=main, scope=scope)
    out = {"load_s": time.perf_counter() - t0, "epoch": st.epoch_no}
    stamp("loads", out["load_s"])
    out["restored_sha256"] = state_digests(np, scope, main)
    prepared = exe.prepare(program, fetch_list=[loss], scope=scope,
                           donate_state=True)
    first_step()
    t0 = time.perf_counter()
    out["loss_after"] = float(prepared.run(feed)[0])
    stamp("steps", time.perf_counter() - t0)
    return out


def pipe_worker(out_dir, legs):
    """One rank of phase 19 (``--pipe-worker DIR LEGS``): "abc" (legs a,
    b_zb, b_il, c on two ranks, rank 0 running the one-rank reference
    first) or "de" (four ranks, rank 0's reference on the global batch,
    then (e) the restore of (d)'s checkpoint); writes
    ``pipe<r>_<legs>.json``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    from paddle_tpu_torch.models import bert
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    check(fleet.backend == "gloo", f"rank {rank} on {fleet.backend}")
    res = {"rank": rank}
    ref = None
    d = legs.startswith("d")
    if rank == 0:
        cfg = pipe_config(0.0)
        feed = bert.make_fake_batch(
            np.random.RandomState(SEED), cfg,
            PIPE_DP_BATCH if d else TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
        ref = pipe_reference(torch, np, cfg, feed,
                             PIPE_M * (2 if d else 1), d)
    for leg in (("d",) if d else tuple(PIPE_LEGS)):
        res[leg] = m = pipe_leg(torch, np, leg,
                                ref if leg != "c" else None, out_dir)
        log(f"[rank {rank}] ({leg}) losses "
            f"{[round(x, 5) for x in m['losses']]}, step "
            f"{m['step_ms_median']:.1f} ms")
    if legs == "de":
        res["e"] = pipe_restore(torch, np, out_dir)
    res["stamps"] = dict(_STAMPS)
    with open(os.path.join(out_dir, f"pipe{rank}_{legs}.json"), "w") as f:
        json.dump(res, f)
    return 0


def pipe_launch(torch, repo, out_dir, nproc, legs):
    """``nproc`` ranks of this script on the card over gloo; returns
    their JSON results."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--selected_gpus", ",".join(["0"] * nproc),
           "--backend", "gloo", "--timeout", str(PIPE_TIMEOUT_S),
           os.path.join(repo, "chip_smoke.py"), "--pipe-worker", out_dir,
           legs]
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=repo, timeout=PIPE_TIMEOUT_S + 60,
                        env=launch_env()).returncode
    wall = time.perf_counter() - t0
    log(f"  legs {legs} on {nproc} ranks: ran {wall:.1f} s, exit code {rc}")
    check(rc == 0, f"phase 19 legs {legs}: a rank failed (exit code {rc})")
    ranks = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"pipe{r}_{legs}.json")) as f:
            ranks.append(json.load(f))
    launch_line(f"phase 19 launch {legs}", ranks, wall)
    return ranks


def pipe_report(leg, ranks):
    """The gates of one leg on every rank, and rank 0's printed figures:
    finite losses, the same on every rank; the same startup; no fallback;
    #1-#10 launched exactly as the program and the schedule predict; the
    census (idle slots the simulator's, no launch on an idle tick); the
    losses and parameters within TOL_PIPE_* of the one-rank run ((a), (b),
    (d)); (c)'s recomputed boundaries bit for bit the sent ones; (d)'s
    held bytes the layout's."""
    what = f"({leg}) {PIPE_LEG_NAMES[leg]}"
    m0 = ranks[0]
    for r, m in enumerate(ranks):
        who = f"{what} rank {r}"
        check(all(math.isfinite(x) for x in m["losses"]),
              f"{who}: losses not finite: {m['losses']}")
        check(m["losses"] == m0["losses"],
              f"{who}: fetched other losses than rank 0")
        check(m["init_sha256"] == m0["init_sha256"],
              f"{who}: another startup than rank 0's")
        check(not m["fallbacks"], f"{who}: fallbacks {m['fallbacks']}")
        want = {f"{k}/float32": n for k, n in m["expected"].items()}
        got = m["launches"]
        for key in set(want) | set(got):
            check(got.get(key, 0) == want.get(key, 0) * PIPE_STEPS,
                  f"{who}: {key} launched {got.get(key, 0)} times in "
                  f"{PIPE_STEPS} steps, the plan and the schedule say "
                  f"{want.get(key, 0)} a step")
        for c in m["census"]:
            check(c["census_idle_slots"] == c["sim_idle_slots"] and
                  c["idle_launches"] == 0,
                  f"{who}: census {c['census_idle_slots']} idle slots vs "
                  f"the simulator's {c['sim_idle_slots']}, "
                  f"{c['idle_launches']} launches on idle ticks")
            if leg == "c":
                check(c["replay_mismatched"] == 0 and c["replay_checked"]
                      == (PIPE_M if m["pp_rank"] == 0 else 0),
                      f"{who}: {c['replay_mismatched']} of "
                      f"{c['replay_checked']} recomputed boundaries differ "
                      f"from the sent ones")
        if leg == "d":
            check(m["held"] == m["predicted"],
                  f"{who}: the scope holds {m['held']} bytes of "
                  f"persistables, the layout predicts {m['predicted']}")
            check(m["sharded_params"] > 0, f"{who}: no pipe-sharded "
                                           f"parameter")
    report = {k: m0[k] for k in (
        "losses", "step_ms_median", "comm_step_ms", "comm", "peak_bytes",
        "bubble_frac", "expected", "sharded_params")}
    report["census"] = m0["census"][-1]
    report["busy_share"] = m0["profile"]["busy_share"] if m0["profile"] \
        else None
    if "loss_gap" in m0:
        log(f"  {what}: losses {m0['losses']} vs one rank "
            f"{m0['one_rank_losses']}: {m0['loss_gap']:.3e} (tolerance "
            f"{TOL_PIPE_LOSS}); parameters after step {PIPE_STEPS} "
            f"max|Δ| {m0['param_gap']:.3e} (tolerance {TOL_PIPE_PARAM})")
        check(m0["loss_gap"] <= TOL_PIPE_LOSS,
              f"{what}: losses {m0['loss_gap']:.3e} from the one-rank run")
        check(m0["param_gap"] <= TOL_PIPE_PARAM,
              f"{what}: parameters {m0['param_gap']:.3e} from the one-rank "
              f"run")
        report.update({k: m0[k] for k in (
            "loss_gap", "param_gap", "one_rank_losses",
            "one_rank_step_ms")})
    if leg == "d":
        report.update(held=m0["held"], moment_bytes=m0["moment_bytes"],
                      param_bytes=m0["param_bytes"])
    comm = m0["comm"]
    log(f"  {what}: step {m0['step_ms_median']:.1f} ms (median of steps "
        f"2-{PIPE_STEPS}); bubble_frac {m0['bubble_frac']:.3f}; one step "
        f"with its gloo transfers timed {m0['comm_step_ms']:.1f} ms: "
        + ", ".join(f"{k} {v['ms']:.1f} ms in {v['calls']} calls "
                    f"({v['bytes'] / 1e6:.1f} MB)"
                    for k, v in sorted(comm.items()))
        + "; device busy "
        + (f"{100 * report['busy_share']:.1f} %" if report["busy_share"]
           is not None else "not measured")
        + f"; peak allocated {m0['peak_bytes'] / 1e9:.3f} GB a rank "
        f"({len(ranks)} ranks on one card over gloo, staged through the "
        f"host)")
    return report


def pipe_phase(torch, np, repo):
    """Phase 19 (see the module docstring); returns rank 0's launches by
    leg and the report."""
    from paddle_tpu_torch.ops.cuda import build
    out_dir = os.path.join(build.BUILD_DIR, "smoke_pipe")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        two = pipe_launch(torch, repo, out_dir, PIPE_STAGES, "abc")
        four = pipe_launch(torch, repo, out_dir, PIPE_RANKS_D, "de")
        restored = four
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    report = {leg: pipe_report(leg, [r[leg] for r in two])
              for leg in PIPE_LEGS}
    report["d"] = pipe_report("d", [r["d"] for r in four])
    for leg in ("b_zb", "b_il"):
        gap = max(abs(x - y) / abs(y) for x, y in
                  zip(two[0][leg]["losses"], two[0]["a"]["losses"]))
        check(gap <= TOL_PIPE_LOSS,
              f"({leg}): losses {gap:.3e} from (a)'s")
        report[leg]["loss_gap_vs_a"] = gap
    for r, e in enumerate(restored):
        saved = four[r]["d"]["saved_sha256"]
        got = e["e"]["restored_sha256"]
        differ = sorted(n for n in saved if got.get(n) != saved[n])
        check(not differ and e["e"]["epoch"] == PIPE_STEPS,
              f"(e) rank {r}: restored state differs: {differ[:5]}")
        check(e["e"]["loss_after"] == four[r]["d"]["loss_after"],
              f"(e) rank {r}: the step after the restore "
              f"{e['e']['loss_after']} vs {four[r]['d']['loss_after']}")
    log(f"  (e) (d)'s ranks restored its sharded checkpoint bit for "
        f"bit ({len(four[0]['d']['saved_sha256'])} persistables a rank, "
        f"load {restored[0]['e']['load_s']:.2f} s) and their next step's "
        f"loss is the uninterrupted run's: {restored[0]['e']['loss_after']}")
    report["e"] = {"load_s": restored[0]["e"]["load_s"],
                   "loss_after": restored[0]["e"]["loss_after"]}
    launches = {f"pipe_{leg}": {k.split("/")[0]: v for k, v in
                                two[0][leg]["launches"].items()}
                for leg in PIPE_LEGS}
    launches["pipe_d"] = {k.split("/")[0]: v for k, v in
                          four[0]["d"]["launches"].items()}
    return launches, report


# ---------------------------------------------------------------------------
# phase 20: Mixture-of-Experts at BERT-base width
# ---------------------------------------------------------------------------

#: BertConfig's MoE defaults with 8 experts: top-2, capacity factor 2.0,
#: aux weight 0.01, routing groups of up to 256 tokens
MOE_EXPERTS = 8
MOE_STEPS = 5             # (a): prepared steps at dropout 0.1
MOE_EP_STEPS = 3          # (b): steps a tier (the reference's count)
MOE_EP_RANKS = 2
#: (b)'s depth: BERT-base's width at CUT_LAYERS layers.  On an H100 80GB
#: at 700 W, at 12 its launch ran 80 s and the one-rank restore of its
#: 6.7 GB checkpoint 27 s, and at 4 the script ran 913.9 s by its clock;
#: (a) and (c) keep 12
MOE_EP_LAYERS = CUT_LAYERS
TOL_MOE_EP = 1e-5         # (b)(i) vs the one-rank run: losses, parameters
MOE_INT8_RTOL, MOE_INT8_ATOL = 0.05, 0.01   # (ii) vs (i), tests/test_moe
#: (iii) the next loss on one rank vs the ranks', relative: one rank's
#: mean over 32 rows against the mean of two 16-row means differ in the
#: order of the sum (one float32 ulp of a loss of 10 is 9.5e-7)
TOL_MOE_RESTORE = 1e-6
MOE_TIMEOUT_S = 600
#: (c): 8 requests of phase 11's prompts in one burst, routed one token a
#: group (capacity 1 an expert: no drop depends on the batch)
MOE_DECODE_REQUESTS = 8
MOE_DECODE_GROUP = 1


def moe_config(dropout, aux=0.01, layers=None):
    """Phase 20's model: BERT-base width with the routed FFN in every
    layer (``moe_experts`` 8, top-2, capacity factor 2.0), at
    ``dropout`` (hidden and attention) and aux weight ``aux``; ``layers``
    cuts the depth."""
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig.base()
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    cfg.moe_experts = MOE_EXPERTS
    cfg.moe_aux_weight = aux
    cfg.hidden_dropout_prob = dropout
    cfg.attention_probs_dropout_prob = dropout
    return cfg


def build_moe_train(cfg, layout=None, quant=None):
    """Phase 20's program: phase 8's fused program (``fuse_add_layernorm``
    on the program, ``fuse_elewise_add_act_ops`` through the build
    strategy) with phase 15's recipe (AdamW with warmup and decay, no
    global-norm clip: under ``ep`` an expert gradient is its rank's
    block).  ``layout``: ``apply_expert_sharding`` onto it (the exchange
    at ``quant``'s tier) and ``with_mesh`` over its batch axes, bucketed
    gradient sync; else one rank.  Returns (the program to run, main,
    startup, loss, LR var)."""
    from paddle_tpu_torch import fluid, parallel
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        opt = zero_optimizer(fluid)
        opt.minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    bs = fluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    if layout is None:
        program = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=total.name, build_strategy=bs)
    else:
        parallel.apply_expert_sharding(main, layout, quant_spec=quant)
        main._mesh_layout = layout
        bs.fuse_all_reduce_ops = True
        program = fluid.CompiledProgram(main).with_mesh(
            layout.build_mesh(), loss_name=total.name,
            batch_axis=layout.batch_axes, build_strategy=bs)
    return program, main, startup, total, opt.learning_rate_var


def program_launches(program, loss_name):
    """Launches a training step of ``program`` makes, from its pass
    variant: each forward op's kernels (PIPE_KERNEL_OPS) once, its
    backward's once, #10 once for the run of adamw ops."""
    variant = program._variant_for([loss_name]) \
        if hasattr(program, "_variant_for") else program
    want = {"adam": 1}
    for op in variant.global_block().ops:
        if op.type == "backward":
            break
        for names in PIPE_KERNEL_OPS.get(kernel_op_key(op), ()):
            for n in names:
                want[n] = want.get(n, 0) + 1
    return want


def combine_names(main):
    """Each routed block's Combine weights (moe_dispatch's output)."""
    return [op.outputs["Combine"][0] for op in main.global_block().ops
            if op.type == "moe_dispatch"]


def dropped_share(np, combines, top_k):
    """The share of (token, choice) slots each layer's routing dropped:
    1 - the kept entries of Combine [G, S, E, C] over tokens x top-k."""
    out = []
    for c in combines:
        c = np.asarray(c)
        tokens = c.shape[0] * c.shape[1]
        out.append(1.0 - float(np.count_nonzero(c)) / (tokens * top_k))
    return out


def moe_plain_run(torch, np, cfg, kernels_on, grads=True):
    """PLAIN_STEPS steps of phase 20's one-rank program at ``cfg`` through
    Executor.run from the seed's startup, with every kernel on or every
    kernel flag off: (losses, step-1 gradients, launches, the parameters
    after the steps on the host, the gradients' names)."""
    from paddle_tpu_torch import flags, fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    program, main, startup, total, _ = build_moe_train(cfg)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    grad_names = [p.name + "@GRAD" for p in main.all_parameters()]
    flags.set_flags({"use_flash_attention": kernels_on,
                     "use_pallas_fused": kernels_on})
    try:
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        kernels.reset_launch_counts()
        losses, got = [], None
        for i in range(PLAIN_STEPS):
            fetch = [total] + (grad_names if i == 0 and grads else [])
            res = exe.run(program, feed=feed, fetch_list=fetch,
                          scope=scope, return_numpy=False)
            losses.append(float(res[0]))
            if i == 0:
                got = [g.cpu() for g in res[1:]]
        params = {p.name: scope.find_var(p.name).detach().cpu().clone()
                  for p in main.all_parameters()}
        return losses, got, kernels.launch_counts(), params, grad_names
    finally:
        flags.set_flags({"use_flash_attention": True,
                         "use_pallas_fused": True})
        torch.cuda.empty_cache()


def moe_one_rank(torch, np):
    """(a): phase 20's program on this process, MOE_STEPS prepared steps at
    dropout 0.1 (launches a step derived from the program, no fallback,
    the drops a layer from the last step's Combine), one profiled step;
    then at dropout 0 and aux 0, PLAIN_STEPS steps with every kernel on
    against every kernel flag off (phase 7's tolerances).  Returns
    (launches, report, the reference: the kernel run's losses and
    parameters, for (b))."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    cfg = moe_config(DROPOUT)
    program, main, startup, total, lr_var = build_moe_train(cfg)
    expected = program_launches(program, total.name)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    combs = combine_names(main)
    params = main.all_parameters()
    n_params = sum(math.prod(p.shape) for p in params)
    n_expert = sum(math.prod(p.shape) for p in params
                   if len(p.shape) >= 2 and p.shape[0] == MOE_EXPERTS
                   and "_moe" in p.name)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    allocated_after_startup = torch.cuda.memory_allocated()
    est, state_in, written = memory_estimate(program, feed, total.name)
    prepared = exe.prepare(program, fetch_list=[total, lr_var] + combs,
                           scope=scope, donate_state=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from zero, MOE_STEPS steps, read right after
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, step_s, out = [], [], None
    for _ in range(MOE_STEPS):
        t0 = time.perf_counter()
        out = prepared.run(feed)
        losses.append(float(out[0]))
        step_s.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    fallbacks = registry.route_counts("fallback")
    drops = dropped_share(np, [h.numpy() for h in out[2:]], cfg.moe_top_k)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = statistics.median(step_s[1:])
    log(f"  (a) MoE BERT-base ({n_params} parameters, {n_expert} of them "
        f"in {MOE_EXPERTS} experts a layer x {cfg.num_hidden_layers}), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, dropout {DROPOUT}: losses "
        f"{[round(x, 5) for x in losses]}; step {steady * 1e3:.1f} ms "
        f"(median of steps 2-{MOE_STEPS}); peak allocated {peak_gb:.2f} "
        f"GB; token slots dropped a layer "
        f"{[round(d, 4) for d in drops]}")
    log(f"  launches over {MOE_STEPS} steps: {launches}; derived a step "
        f"from the program: {expected}")
    check(all(math.isfinite(x) for x in losses), f"(a): losses {losses}")
    check(not fallbacks, f"(a): route fallbacks {fallbacks}")
    check_launches(kernels, expected, MOE_STEPS,
                   {n: "float32" for n in expected})
    fluid.sync_prepared_state(scope)
    held, predicted, _, _ = held_bytes(torch, None, scope, main)
    memory = {"estimate": {"state_bytes": est.state_bytes,
                           "peak_bytes": est.peak_bytes},
              "state_in_held": scope_bytes(torch, scope, state_in),
              "held": held, "predicted": predicted,
              "left_out": left_out_bytes(torch, None, scope, main,
                                         state_in, written),
              "allocated_after_startup": allocated_after_startup,
              "peak_bytes": torch.cuda.max_memory_allocated()}
    check_estimate("(a) one rank", memory)
    profile = profile_step(torch, lambda: float(prepared.run(feed)[0]),
                           steady * 1e3)
    del prepared, scope, out
    torch.cuda.empty_cache()
    report = {"memory": memory, "losses": losses, "step_s": step_s,
              "step_ms_median": steady * 1e3, "peak_gb": peak_gb,
              "parameters": n_params, "expert_parameters": n_expert,
              "dropped_share_by_layer": drops, "expected": expected,
              "busy_share": profile["busy_share"] if profile else None,
              "profile": profile}

    # dropout 0, aux 0: kernels on vs every flag off; the kernel run is
    # (b)'s one-rank reference
    cfg0 = moe_config(0.0, aux=0.0)
    k_losses, k_grads, k_launches, k_params, grad_names = moe_plain_run(
        torch, np, cfg0, True)
    p_losses, p_grads, p_launches, _, _ = moe_plain_run(torch, np, cfg0,
                                                        False)
    check(sum(p_launches.values()) == 0, "(a): the plain path launched")
    check(all(k_launches.get(n, 0) == per * PLAIN_STEPS
              for n, per in expected.items()),
          f"(a): the kernel path launched {k_launches}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    grad_err, worst = 0.0, ""
    for n, a, b in zip(grad_names, k_grads, p_grads):
        e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if e > grad_err:
            grad_err, worst = e, n
    log(f"  (a) dropout 0, aux 0, {PLAIN_STEPS} steps: losses kernels "
        f"{[round(x, 6) for x in k_losses]} vs plain "
        f"{[round(x, 6) for x in p_losses]}: max relative Δ {loss_err:.3e} "
        f"(tolerance {TOL_TRAIN_LOSS:.0e}); step-1 grads max |Δ| / "
        f"max|grad| {grad_err:.3e} at {worst} (tolerance "
        f"{TOL_TRAIN_GRAD:.0e})")
    check(loss_err <= TOL_TRAIN_LOSS, "(a): kernels disagree with the "
                                      "plain path (losses)")
    check(grad_err <= TOL_TRAIN_GRAD,
          f"(a): step-1 grad of {worst}: kernels disagree with the plain "
          f"path")
    report.update(kernel_losses=k_losses, plain_losses=p_losses,
                  loss_max_rel=loss_err, grad_max_rel=grad_err,
                  grad_worst=worst)
    del k_grads, p_grads
    if MOE_EP_LAYERS != cfg.num_hidden_layers:
        # (b) runs cut: its one-rank reference at its own depth
        k_losses, _, _, k_params, _ = moe_plain_run(
            torch, np, moe_config(0.0, aux=0.0, layers=MOE_EP_LAYERS), True,
            grads=False)
    return launches, report, {"losses": k_losses, "params": k_params}


def moe_comm(torch):
    """Phase 20's gloo transfers by kind: the expert exchange (an
    all-to-all: the token blocks, or the int8 payload and its scales) and
    the dense gradients' all-reduce over ep."""
    def kind_of(name, g):
        return "expert exchange" if name == "all_to_all" else \
            "dense all-reduce"
    return timed_comm(torch, ("all_to_all", "all_reduce"), kind_of)


def moe_ep_leg(torch, np, tier, feed, out_dir):
    """One tier of (b) on this rank: ``apply_expert_sharding`` onto
    ``MeshLayout(expert=2)`` (float32, or the int8 exchange), the startup,
    MOE_EP_STEPS prepared steps (launches, fallbacks, the route table's
    entries); float32: the global parameters (a file for the parent) and
    a sharded save; the step after them with the gloo transfers timed;
    the held and peak bytes."""
    from paddle_tpu_torch import fluid, io
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    dev = torch.device("cuda", fleet.place.device_id)
    cfg = moe_config(0.0, aux=0.0, layers=MOE_EP_LAYERS)
    quant = None if tier == "fp32" else tier
    program, main, startup, total, _ = build_moe_train(
        cfg, MeshLayout(expert=MOE_EP_RANKS), quant)
    dp = program._dp
    check(dp is not None and dp.world == MOE_EP_RANKS,
          f"(b) {tier}: the program does not run over {MOE_EP_RANKS} ranks")
    out = {"tier": tier, "expected": program_launches(program, total.name),
           "exchanges": sum(op.type == "c_expert_alltoall"
                            for op in main.global_block().ops)}
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, step_s = [], []
    first_step()
    for _ in range(MOE_EP_STEPS):
        t0 = time.perf_counter()
        losses.append(float(prepared.run(feed)[0]))
        step_s.append(time.perf_counter() - t0)
    stamp("steps", sum(step_s))
    out["launches"] = {f"{k}/{dt}": n for (k, dt), n in
                       kernels.launch_counts_by_dtype().items()}
    out["fallbacks"] = {str(k): v for k, v in
                        registry.route_counts("fallback").items()}
    out["exchange_routes"] = sum(v for k, v in registry.route_counts()
                                 .items() if k[0] == "c_expert_alltoall")
    out["losses"], out["step_s"] = losses, step_s
    out["step_ms_median"] = statistics.median(step_s[1:]) * 1e3
    fluid.sync_prepared_state(scope)
    out["held"], out["predicted"], _, _ = held_bytes(torch, dp, scope, main)
    if tier == "fp32":
        params = global_params(dp, scope, main)
        out["params_path"] = os.path.join(out_dir, "ep_params.pt")
        if fleet.worker_index() == 0:
            torch.save({n: t.cpu() for n, t in params.items()},
                       out["params_path"])
        del params
        t0 = time.perf_counter()
        io.save_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                           io.TrainStatus(MOE_EP_STEPS),
                           main, scope=scope, sharded=True)
        out["save_s"] = time.perf_counter() - t0
        stamp("saves", out["save_s"])
    totals, undo = moe_comm(torch)
    try:
        t0 = time.perf_counter()
        out["loss_after"] = float(prepared.run(feed)[0])
        out["comm_step_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    out["comm"] = totals
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del prepared, scope, exe
    torch.cuda.empty_cache()
    return out


def moe_worker(out_dir):
    """One rank of (b) (``--moe-worker DIR``): the float32 tier, then the
    int8 tier, in one launch; writes ``moe<r>.json``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    from paddle_tpu_torch.models import bert
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    check(fleet.backend == "gloo", f"rank {rank} on {fleet.backend}")
    cfg = moe_config(0.0, aux=0.0, layers=MOE_EP_LAYERS)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    res = {"rank": rank}
    for tier in ("fp32", "int8"):
        res[tier] = m = moe_ep_leg(torch, np, tier, feed, out_dir)
        log(f"[rank {rank}] (b) {tier}: losses "
            f"{[round(x, 6) for x in m['losses']]}, step "
            f"{m['step_ms_median']:.1f} ms")
    res["stamps"] = dict(_STAMPS)
    with open(os.path.join(out_dir, f"moe{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def moe_launch(torch, repo, out_dir):
    """MOE_EP_RANKS ranks of this script on the card over gloo, one
    launch for (b)'s tiers; returns their JSON results."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(MOE_EP_RANKS), "--selected_gpus",
           ",".join(["0"] * MOE_EP_RANKS), "--backend", "gloo",
           "--timeout", str(MOE_TIMEOUT_S),
           os.path.join(repo, "chip_smoke.py"), "--moe-worker", out_dir]
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=repo, timeout=MOE_TIMEOUT_S + 60,
                        env=launch_env()).returncode
    wall = time.perf_counter() - t0
    log(f"  (b) on {MOE_EP_RANKS} ranks: ran {wall:.1f} s, exit code {rc}")
    check(rc == 0, f"phase 20 (b): a rank failed (exit code {rc})")
    ranks = []
    for r in range(MOE_EP_RANKS):
        with open(os.path.join(out_dir, f"moe{r}.json")) as f:
            ranks.append(json.load(f))
    launch_line("phase 20 launch (b)", ranks, wall)
    return ranks


def moe_ep_report(torch, np, ranks, ref, out_dir):
    """(b)'s gates: every rank's losses finite and alike, no fallback, no
    route of the exchange taken, the launches the program predicts, the
    held bytes the layout's; (i) against the one-rank reference ``ref``
    within TOL_MOE_EP (losses and parameters), (ii) against (i) within
    the int8 bound; (iii) the sharded checkpoint restored onto one rank
    in this process: the parameters bit for bit, the next loss within
    TOL_MOE_RESTORE (relative).  Returns rank 0's launches and the report."""
    from paddle_tpu_torch import fluid, io
    from paddle_tpu_torch.models import bert
    report = {"layers": MOE_EP_LAYERS}
    for tier in ("fp32", "int8"):
        what = f"(b) {tier} exchange, expert 2"
        m0 = ranks[0][tier]
        for r, rk in enumerate(ranks):
            m = rk[tier]
            who = f"{what} rank {r}"
            check(all(math.isfinite(x) for x in m["losses"]),
                  f"{who}: losses {m['losses']}")
            check(m["losses"] == m0["losses"], f"{who}: other losses than "
                                               f"rank 0's")
            check(not m["fallbacks"], f"{who}: fallbacks {m['fallbacks']}")
            check(m["exchange_routes"] == 0,
                  f"{who}: the exchange took a kernel route")
            want = {f"{k}/float32": n for k, n in m["expected"].items()}
            for key in set(want) | set(m["launches"]):
                check(m["launches"].get(key, 0) ==
                      want.get(key, 0) * MOE_EP_STEPS,
                      f"{who}: {key} launched {m['launches'].get(key, 0)} "
                      f"times in {MOE_EP_STEPS} steps, the program says "
                      f"{want.get(key, 0)} a step")
            check(m["held"] == m["predicted"],
                  f"{who}: holds {m['held']} bytes, the layout predicts "
                  f"{m['predicted']}")
        comm = m0["comm"]
        log(f"  {what}: losses {m0['losses']}; step "
            f"{m0['step_ms_median']:.1f} ms (median of steps 2-"
            f"{MOE_EP_STEPS}); one step with its gloo transfers timed "
            f"{m0['comm_step_ms']:.1f} ms: "
            + ", ".join(f"{k} {v['ms']:.1f} ms in {v['calls']} calls "
                        f"({v['bytes'] / 1e6:.1f} MB)"
                        for k, v in sorted(comm.items()))
            + f"; {m0['exchanges']} exchange ops; persistent "
            f"{m0['held'] / 1e9:.3f} GB, peak allocated "
            f"{m0['peak_bytes'] / 1e9:.3f} GB a rank (two ranks on one "
            f"card over gloo, staged through the host)")
        report[tier] = {k: m0[k] for k in (
            "losses", "step_ms_median", "comm_step_ms", "comm", "held",
            "peak_bytes", "expected", "exchanges")}
    fp, q = ranks[0]["fp32"], ranks[0]["int8"]
    gap = max(abs(a - b) for a, b in zip(fp["losses"], ref["losses"]))
    got = torch.load(fp["params_path"])
    pgap = pipe_params_gap(torch, got, ref["params"])
    del got
    log(f"  (b)(i) vs the one-rank run at dropout 0, aux 0: losses max|Δ| "
        f"{gap:.3e}, parameters max|Δ| {pgap:.3e} (tolerance {TOL_MOE_EP})")
    check(gap <= TOL_MOE_EP and pgap <= TOL_MOE_EP,
          f"(b)(i): {gap:.3e} / {pgap:.3e} from the one-rank run")
    report["fp32"].update(loss_gap=gap, param_gap=pgap)
    qgap = max(abs(a - b) - MOE_INT8_RTOL * abs(b)
               for a, b in zip(q["losses"], fp["losses"]))
    log(f"  (b)(ii) int8 exchange vs float32: losses {q['losses']} vs "
        f"{fp['losses']} (rtol {MOE_INT8_RTOL}, atol {MOE_INT8_ATOL})")
    check(qgap <= MOE_INT8_ATOL, "(b)(ii): the int8 exchange strays from "
                                 "the float32 one")
    # (iii) the sharded ep-2 checkpoint onto one rank
    cfg = moe_config(0.0, aux=0.0, layers=MOE_EP_LAYERS)
    program, main, _, total, _ = build_moe_train(cfg)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor()
    t0 = time.perf_counter()
    st = io.load_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                            main_program=main, scope=scope)
    load_s = time.perf_counter() - t0
    got = torch.load(fp["params_path"])
    differ = sorted(n for n, t in got.items()
                    if not torch.equal(scope.find_var(n).cpu(), t))
    del got
    check(st.epoch_no == MOE_EP_STEPS and not differ,
          f"(b)(iii): restored parameters differ: {differ[:5]}")
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    nxt = float(prepared.run(feed)[0])
    log(f"  (b)(iii) the expert-2 sharded checkpoint ({fp['save_s']:.2f} s "
        f"to save) restored onto one rank in {load_s:.2f} s, every "
        f"parameter bit for bit; the next loss {nxt} vs the ranks' "
        f"{fp['loss_after']} (tolerance {TOL_MOE_RESTORE}, relative)")
    check(abs(nxt - fp["loss_after"]) <= TOL_MOE_RESTORE * abs(nxt),
          f"(b)(iii): the next loss {nxt} vs {fp['loss_after']}")
    report["restore"] = {"load_s": load_s, "save_s": fp["save_s"],
                         "loss_after": nxt}
    del prepared, scope
    torch.cuda.empty_cache()
    launches = {"moe_ep": {k.split("/")[0]: v for k, v in
                           fp["launches"].items()},
                "moe_ep_int8": {k.split("/")[0]: v for k, v in
                                q["launches"].items()}}
    return launches, report


def moe_decode_leg(torch, np):
    """(c): phase 11's engine config serving the MoE decoder (8 experts,
    routed one token a group): MOE_DECODE_REQUESTS requests of phase 11's
    prompts with the kernels on (launches a forward, no fallback, tokens
    against greedy_reference as phase 11 holds them), then with every
    kernel flag off on the same weights: the same tokens (a divergence
    only where the reference's top-2 gap is under TOL_DECODE_GAP)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import BertDecoder
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
    cfg = moe_config(0.0)
    cfg.moe_group_size = MOE_DECODE_GROUP
    prompts = decode_prompts(np, cfg.vocab_size)[:MOE_DECODE_REQUESTS]
    budgets = decode_budgets(len(prompts))

    def engine_for():
        return DecodeEngine(BertDecoder(cfg, seed=SEED), DecodeConfig(
            pool_blocks=DECODE_POOL_BLOCKS, **DECODE_CONFIG),
            auto_start=False)

    engine = engine_for().start()
    try:
        kernels.reset_launch_counts()
        registry.reset_route_counts()
        t0 = time.perf_counter()
        futs = [engine.generate({"src_ids": p}, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        res = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        engine.drain()
        launches = kernels.launch_counts()
        fallbacks = registry.route_counts("fallback")
        stats = engine.stats()
        forwards = stats["prefill_batches"] + stats["chunk_steps"] + \
            stats["decode_steps"]
        log(f"  (c) MoE decoder, {len(prompts)} requests: "
            f"{stats['tokens_out']} tokens in {wall:.3f} s "
            f"({stats['tokens_out'] / wall:.1f} tokens/s), {forwards} "
            f"forwards; launches {launches}")
        check(not fallbacks, f"(c): route fallbacks {fallbacks}")
        for name, per in DECODE_LAUNCHES.items():
            check(launches.get(name, 0) == per * forwards,
                  f"(c): {name} launched {launches.get(name, 0)} times, "
                  f"expected {per} x {forwards} forwards")
        check(not {k: v for k, v in launches.items()
                   if v and k not in DECODE_LAUNCHES},
              f"(c): unexpected launches {launches}")
        diverged = decode_parity(torch, np, engine, prompts, res)
        weights = {n: engine._ref_scope.find_var(n).detach().cpu().numpy()
                   for n in engine._ref_scope.var_names()
                   if engine._programs.startup.global_block().has_var(n)}
    finally:
        engine.shutdown()
    kernel_tokens = [r.tokens.tolist() for r in res]
    flags.set_flags({"use_flash_attention": False,
                     "use_pallas_fused": False})
    plain = engine_for()
    try:
        plain.set_params(weights)
        plain.start()
        kernels.reset_launch_counts()
        futs = [plain.generate({"src_ids": p}, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        plain_tokens = [f.result(timeout=600).tokens.tolist() for f in futs]
        check(sum(kernels.launch_counts().values()) == 0,
              "(c): the plain route launched a kernel")
        differ = []
        for i, (a, b) in enumerate(zip(kernel_tokens, plain_tokens)):
            if a == b:
                continue
            t = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            ref_l = reference_logits(np, plain, list(prompts[i]) + b[:t])
            top2 = np.sort(ref_l)[-2:]
            differ.append({"request": i, "token": t,
                           "top2_gap": float(top2[1] - top2[0])})
    finally:
        flags.set_flags({"use_flash_attention": True,
                         "use_pallas_fused": True})
        plain.shutdown()
    log(f"  (c) tokens vs greedy_reference: {len(prompts) - len(diverged)} "
        f"of {len(prompts)} identical; kernel route vs plain route: "
        f"{len(prompts) - len(differ)} of {len(prompts)} identical "
        f"{differ}")
    check(len(differ) <= DECODE_MAX_DIVERGED and
          all(d["top2_gap"] < TOL_DECODE_GAP for d in differ),
          f"(c): the kernel route's tokens differ from the plain route's: "
          f"{differ}")
    return launches, {"requests": len(prompts), "wall_s": wall,
                      "tokens_out": stats["tokens_out"],
                      "tokens_per_s": stats["tokens_out"] / wall,
                      "forwards": forwards, "diverged": diverged,
                      "plain_differ": differ}


def moe_phase(torch, np, repo):
    """Phase 20 (see the module docstring); returns the launches by path
    and the report."""
    from paddle_tpu_torch.ops.cuda import build
    one_launches, one, ref = moe_one_rank(torch, np)
    out_dir = os.path.join(build.BUILD_DIR, "smoke_moe")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        ranks = moe_launch(torch, repo, out_dir)
        ep_launches, ep = moe_ep_report(torch, np, ranks, ref, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del ref
    dec_launches, dec = moe_decode_leg(torch, np)
    return ({"moe": one_launches, **ep_launches, "moe_decode": dec_launches},
            {"a": one, "b": ep, "c": dec})


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


# kernel -> (the path whose launches it reports, its row's name in the
# per-kernel results); the first float32 row is the main-path shape
KERNEL_PATHS = {
    "flash_attention_fwd": ("served", "flash_attention_fwd"),
    "add_layer_norm_fwd": ("served", "add_layer_norm_fwd"),
    "bias_gelu_fwd": ("served", "bias_gelu_fwd"),
    "layer_norm_fwd": ("unfused", "layer_norm_fwd"),
    "flash_attention_bwd_dq": ("train", "flash_attention_bwd_dq"),
    "flash_attention_bwd_dkv": ("train", "flash_attention_bwd_dkv"),
    "layer_norm_bwd": ("train", "layer_norm_bwd"),
    "adam": ("train", "adam"),
    "add_layer_norm_bwd": ("fused_train", "add_layer_norm_bwd"),
    "bias_gelu_bwd": ("fused_train", "bias_gelu_bwd"),
    "dequant_accumulate": ("dp_int4", "dequant_accumulate"),
    "dequant_accumulate_requant": ("dp_int8", "dequant_accumulate_requant"),
}


#: phase 14's paths: (a)'s recompute run, (b)'s recompute + gradient
#: merge, (d)'s DGC and (e)'s LocalSGD rank 0
WRAPPED_PATHS = ("recompute", "gradient_merge", "dgc", "localsgd")
#: phase 15's paths, rank 0 of each leg: (a) dp2 fp32, (b)-(d) ZeRO-1 in
#: fp32, int8 and int4, (e) ZeRO-3
ZERO_PATHS = tuple(f"zero_{leg}" for leg in ZERO_LEGS + AUTO_LEGS)
#: phase 16's paths, rank 0 of each leg: (a) dp4, (b) HSDP, (d) and (e)
#: the restores' steps
HSDP_PATHS = ("hsdp_a", "hsdp_b", "hsdp_d", "hsdp_e")
#: phase 17's paths, rank 0 of each leg: (a) classic, (b)-(f) overlapped
#: or at the tail, (d) and (e) int8
OVERLAP_PATHS = tuple(f"overlap_{leg}" for leg in OVERLAP_LEGS)
#: phase 18's paths, rank 0 of each leg: (a) tp x sp on the ring route,
#: (b) tp on the plain flash route, (c) fsdp x tp
TPSP_PATHS = ("tp_sp", "tp", "fsdp_tp")
#: phase 19's paths, rank 0 of each leg: (a) 1F1B, (b) zero-bubble and
#: interleaved, (c) 1F1B at dropout 0.1, (d) dp 2 x pp 2 through fleet
PIPE_PATHS = ("pipe_a", "pipe_b_zb", "pipe_b_il", "pipe_c", "pipe_d")
#: phase 20's paths: (a) one rank, (b) expert 2 rank 0 (float32 and int8
#: exchanges), (c) the MoE decoder
MOE_PATHS = ("moe", "moe_ep", "moe_ep_int8", "moe_decode")


def kernels_line(per_kernel, launches_by_path):
    """One entry per kernel, at its main-path shape, float32: served rows
    8 x 128 (flash B = 8, S = 128, padding bias; the LayerNorm and add+LN
    forwards R = 1024 of D = 768), training B = 32, S = 128 (flash with
    dropout 0.1; the LayerNorm and add+LN backwards rows 4096; bias+GELU
    rows 4096 x 3072; Adam the run of all 158 parameters, adam), and the
    quantized all-reduce's receive stage at the word-embedding bucket's
    shard (n = 2, SB = 45,783; #12 int8, #11 int4, launches from rank 0 of
    phase 10).  Sources and the TPU kernels replaced come from the port's
    route table; a kernel also launched on another path carries
    ``train_launches`` (phase 7) and ``fused_train_launches`` (phase 8),
    the LayerNorm forwards their launches on the served, unfused, training
    and fused-training paths (``launches_by_path``) and #6 its library
    call's name beside ``F.layer_norm`` alone on the sum,
    flash forward its dropout variant's times, the flash kernels their
    rows' extra bounds, and the flash backward its library call and
    float64 witness.  The flash forward and the LayerNorm forward carry
    their launches on the paged decode path (phase 11, ``decode_launches``)
    and the flash forward its decode-step and chunk rows.  Kernels of the
    bf16 programs (phase 12) carry ``amp_launches`` (leg (a)'s 10 prepared
    steps), ``amp_fused_launches`` (leg (b)'s) and ``amp_fp16_launches``
    (leg (c)'s fp16 BERT-base steps), the three flash kernels their bf16
    and float16 rows at that path's shape (``amp`` and ``amp_fp16``: B96
    S128, dropout 0.1, with the dropout-0 times) and the LayerNorm forward
    and backward their float32 rows there (``amp``: R 12,288 and
    1,920).  Leg (d)'s pure-bf16 steps (``amp_pure_bf16_launches``) and
    phase 13's LAMB run A (``lamb_launches``) add their launches, and so
    do phase 14's recompute (``recompute_launches``), recompute + gradient
    merge (``gradient_merge_launches``), DGC (``dgc_launches``) and
    LocalSGD (``localsgd_launches``, rank 0) runs, phase 15's legs
    (``zero_a_launches`` ... ``zero_e_launches``, rank 0) and phase 16's
    (``hsdp_a_launches``, ``hsdp_b_launches``, and the restored runs'
    ``hsdp_d_launches`` and ``hsdp_e_launches``, rank 0) and phase 17's
    (``overlap_a_launches`` ... ``overlap_f_launches``, rank 0; #11 and
    #12 also carry ``overlap_rows``, held at leg (d)'s bucket shapes) and
    phase 18's (``tp_sp_launches``: leg (a)'s ring route, ``tp_launches``:
    leg (b), ``fsdp_tp_launches``: leg (c), rank 0; #1-#3 also carry
    ``ring``, their rows at the ring's
    kernel entry, float32 and bfloat16) and phase 19's
    (``pipe_a_launches``, ``pipe_b_zb_launches``, ``pipe_b_il_launches``,
    ``pipe_c_launches``, ``pipe_d_launches``, rank 0) and phase 20's
    (``moe_launches``: (a)'s one-rank steps, ``moe_ep_launches`` and
    ``moe_ep_int8_launches``: (b)'s float32 and int8 exchange tiers, rank
    0, ``moe_decode_launches``: (c)); Adam
    carries its 16-bit rows (``16_bit``: bf16 and fp16 parameters beside
    float32 or 16-bit moments) and its row on ZeRO-1's flat shards
    (``zero1_shards``), #11 its rows at the ZeRO-1 scatter's largest
    shard (``zero_scatter``, int8 and int4)."""
    from paddle_tpu_torch.ops.op_specs import kernel_facts
    facts = kernel_facts()
    out = []
    for name, (path, rows_name) in KERNEL_PATHS.items():
        rows = [r for r in per_kernel[rows_name] if r["dtype"] == "float32"]
        main = rows[0]
        entry = {
            "name": name, "route": "cuda", "source": facts[name][0],
            "replaces": facts[name][1],
            "launches": launches_by_path[path][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "dtype": "float32", "path": path}
        # the flash backward's other bounds, its library call (dq, dk, dv
        # together) and its float64 witness, where its row has them
        entry.update({k: main[k] for k in (
            "bound_fma_ms", "bound_3xtf32_ms", "bound_design_ms",
            "library_dq_dk_dv_ms", "kernel_err_vs_float64",
            "plain_err_vs_float64", "library_is",
            "library_layer_norm_alone_ms") if k in main})
        if name in ("layer_norm_fwd", "add_layer_norm_fwd"):
            entry["launches_by_path"] = {
                p: launches_by_path[p].get(name, 0)
                for p in ("served", "unfused", "train", "fused_train",
                          "decode", "amp", "amp_fused", "amp_fp16",
                          "amp_pure_bf16", "lamb") + WRAPPED_PATHS}
        for other in ("train", "fused_train", "dp_int8", "dp_int4",
                      "decode", "amp", "amp_fused", "amp_fp16",
                      "amp_pure_bf16", "lamb") + WRAPPED_PATHS + ZERO_PATHS \
                + HSDP_PATHS + OVERLAP_PATHS + TPSP_PATHS + PIPE_PATHS \
                + MOE_PATHS:
            if path != other and launches_by_path[other].get(name):
                entry[other + "_launches"] = launches_by_path[other][name]
        if name == "adam":
            # 16-bit parameters (leg (d) of phase 12): the rows of phase 6
            entry["16_bit"] = [{k: r[k] for k in (
                "shape", "dtype", "moments", "ms", "plain_ms", "library_ms",
                "library_is", "bound_ms", "bound_by", "max_abs_err")}
                for r in per_kernel["adam"] if r["dtype"] != "float32"]
        if name == "adam":
            # ZeRO-1's update (phase 15): leg (b)'s 158 flat shards
            entry["zero1_shards"] = per_kernel["adam_zero1"][0]
        if name == "dequant_accumulate":
            # ZeRO-1's quantized scatter (phase 15, legs (c) and (d)): its
            # largest receive stage, the word embedding's shard at n = 2,
            # as phase 9 held and timed it
            entry["zero_scatter"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err",
                                   "device_ms")}
                for r in per_kernel[name]
                if r["shape"][:3] == [2, 45783, ZERO_BLOCK]]
            check(len(entry["zero_scatter"]) == 2,
                  "#11: no int8 and int4 rows at the scatter's shape")
        if name.startswith("dequant_accumulate"):
            # phase 17: held at the shard shapes of leg (d)'s overlapped
            # buckets
            entry["overlap_rows"] = per_kernel["overlap_quant"]
        if name in per_kernel.get("quant_step", {}):
            entry["step_13_launches"] = per_kernel["quant_step"][name]
        if name.startswith("flash_attention"):
            # the ring route (phase 18 (k)): B4 H6 S_loc 256 D64, the
            # padding block bias, lse returned and its cotangent folded
            entry["ring"] = [{k: r[k] for k in (
                "shape", "dtype", "ms", "plain_ms", "library_ms",
                "library_is", "bound_ms", "bound_by", "max_abs_err")
                if k in r} for r in per_kernel[name + "_ring"]]
            # the bf16 program's shape (phase 12): B96 S128, dropout 0.1,
            # in bf16 (``amp``) and float16 (``amp_fp16``)
            rows_of = "flash_attention_fwd_dropout" \
                if name == "flash_attention_fwd" else name
            for key, dt in (("amp", "bfloat16"), ("amp_fp16", "float16")):
                amp_row = [r for r in per_kernel[rows_of]
                           if r["dtype"] == dt
                           and r["shape"][0] == AMP_BATCH
                           and r["shape"][5] == f"dropout {DROPOUT}"][0]
                entry[key] = {k: amp_row[k] for k in (
                    "shape", "dtype", "ms", "plain_ms", "library_ms",
                    "library_dq_dk_dv_ms", "bound_ms", "bound_by",
                    "ms_dropout0", "library_dq_dk_dv_ms_dropout0",
                    "max_abs_err") if k in amp_row}
        if name in ("layer_norm_fwd", "layer_norm_bwd"):
            # the bf16 program's float32 LayerNorms: B96 x 128 and x 20 rows
            entry["amp"] = [{k: r[k] for k in (
                "shape", "dtype", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "max_abs_err")}
                for r in rows if r["shape"][0] in AMP_LN_ROWS
                and r["shape"][1] == 768 and "case" not in r]
            check(len(entry["amp"]) == len(AMP_LN_ROWS),
                  f"{name}: no float32 row at the bf16 program's rows")
        if name == "flash_attention_fwd":
            drop = [r for r in per_kernel["flash_attention_fwd_dropout"]
                    if r["dtype"] == "float32"][0]
            entry["dropout"] = {k: drop[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bound_fma_ms", "bound_3xtf32_ms",
                "max_abs_err")}
            # the paged decode path's shapes: a decode step (Sq 1) and a
            # chunk, on the gathered context, beside SDPA on the same K/V
            for path in ("decode", "chunk"):
                row = per_kernel[f"flash_attention_fwd_{path}"][0]
                entry[path] = {k: row[k] for k in (
                    "shape", "ms", "plain_ms", "library_ms", "library_is",
                    "bound_ms", "bound_by", "bound_full_window_ms",
                    "bound_fma_ms", "bound_3xtf32_ms", "max_abs_err",
                    "lse_rel_err", "valid_keys", "gather_ms",
                    "gather_bound_ms")}
        out.append(entry)
    return {"kernels": out}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: missing dependency: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available — this script runs the "
              "port on a GPU only", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "paddle_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (no "
              "paddle_tpu_torch package beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    workers = {"--dp-worker": dp_worker, "--localsgd-worker": localsgd_worker,
               "--zero-worker": zero_worker, "--hsdp-worker": hsdp_worker,
               "--overlap-worker": overlap_worker,
               "--preempt-worker": preempt_worker,
               "--tpsp-worker": tpsp_worker, "--pipe-worker": pipe_worker,
               "--moe-worker": moe_worker}
    if argv[:1] and argv[0] in workers:
        try:
            return workers[argv[0]](*argv[1:])
        except SmokeFailure as e:
            print(f"chip_smoke: rank FAILED: {e}", file=sys.stderr)
            return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}")

    from paddle_tpu_torch.ops.cuda import build
    model_dir = os.path.join(build.BUILD_DIR, "smoke_bert_base")
    ckpt_dir = os.path.join(build.BUILD_DIR, "smoke_lamb_checkpoints")
    t_start = time.perf_counter()
    try:
        begin_phase(1, "build")
        rep = build.build()
        log(f"  built {rep['built'] or 'nothing (cached)'} in "
            f"{rep['seconds']:.1f} s")

        begin_phase(2, "kernels vs plain versions")
        per_kernel = {}
        kernel_checks(torch, per_kernel)

        begin_phase(3, "BERT-base served through the port")
        shutil.rmtree(model_dir, ignore_errors=True)
        cfg = build_and_save(torch, model_dir)
        served, serving, canon, fused_outs = serve_phase(torch, np,
                                                         model_dir, cfg)

        begin_phase(4, "unfused program (switch_ir_optim(False))")
        unfused, unfused_err = unfused_phase(torch, np, model_dir, canon,
                                             fused_outs)
        serving["unfused_max_abs"] = unfused_err

        begin_phase(5, "multihead_matmul program on the flash kernel")
        serving["multihead_matmul_max_abs"] = mhm_phase(torch, np)

        begin_phase(6, "training kernels vs plain versions")
        from paddle_tpu_torch.models import bert
        base = bert.BertConfig.base()
        flash_training_checks(torch, per_kernel)
        ln_adam_training_checks(torch, per_kernel, base)
        adam_skip_checks(torch, base)
        fused_training_checks(torch, per_kernel, base)

        begin_phase(7, "BERT-base trained through the port")
        trained, training = train_phase(torch, np, base, build_train,
                                        TRAIN_LAUNCHES)
        training.update(train_plain_phase(torch, np, base, build_train,
                                          TRAIN_LAUNCHES))

        begin_phase(
            8, f"BERT-base trained through the fused program and the "
            f"published recipe (AdamW {WEIGHT_DECAY}, global-norm clip "
            f"{CLIP_NORM}, LR {PEAK_LR} decayed over {DECAY_STEPS} steps; "
            f"warmup cut from the published 10,000 steps to {WARMUP_STEPS} "
            f"so the loss moves within {TRAIN_STEPS} steps)")
        fused, fused_training = train_phase(
            torch, np, base, build_fused_train, FUSED_LAUNCHES,
            schedule=scheduled_lr, estimate=True)
        fused_training.update(train_plain_phase(
            torch, np, base, build_fused_train, FUSED_LAUNCHES))
        fused_training["observability"] = observe_phase(torch, np, base)

        begin_phase(
            9, "quantized all-reduce receive-stage kernels vs plain "
            "versions")
        quant_kernel_checks(torch, per_kernel)

        begin_phase(
            10, f"data-parallel BERT-base, {DP_RANKS} ranks on one "
            f"card over gloo, int8 tier {TRAIN_STEPS} steps, int4 tier "
            f"{DP_INT4_STEPS} steps")
        dp_ranks, dp_parity = dp_phase(torch, np, repo, base)

        begin_phase(
            11, "paged-KV decode at BERT-base width through "
            "DecodeEngine.generate")
        decoded, decode = decode_phase(torch, np, per_kernel)

        begin_phase(
            12, "bf16 mixed-precision pretraining at BERT-base width "
            "(contrib.mixed_precision.decorate)")
        amp, amp_fused, amp_fp16, amp_pure, amp_report = amp_phase(
            torch, np, base, per_kernel,
            fused_training["step_ms_median_3_10"])

        begin_phase(
            13, f"LAMB pretraining at BERT-base width (phase 8's "
            f"program and recipe with LAMB), checkpointed after step "
            f"{LAMB_SAVE_AT} and resumed")
        lamb, lamb_report = lamb_phase(torch, np, base, ckpt_dir)

        begin_phase(
            14, "recompute, gradient merge and the wrapper optimizers "
            "(EMA, ModelAverage, Lookahead, DGC, LocalSGD) through fleet on "
            "phase 8's program and recipe")
        wrapped, wrappers_report = wrappers_phase(torch, np, base, repo)

        begin_phase(
            15, f"ZeRO-1 and ZeRO-3 at BERT-base width on "
            f"{DP_RANKS} ranks of the card over gloo (phase 8's program at "
            f"{CUT_LAYERS} layers, the recipe without its norm clip), "
            f"{ZERO_STEPS} steps a leg; (g) dp2 and (h) auto_shard under a "
            f"budget with the recipe's clip, {AUTO_STEPS} steps each; the "
            f"static plans")
        zero_launches, zero_report = zero_phase(torch, np, repo, base,
                                                per_kernel)

        begin_phase(
            16, f"HSDP (data 2 x fsdp 2) at BERT-base width on "
            f"{HSDP_RANKS} ranks of the card over gloo (phase 15's program "
            f"and recipe, dropout 0), {HSDP_STEPS} steps a leg; sharded "
            f"checkpoints restored onto fsdp 4 and data 2")
        hsdp_launches, hsdp_report_ = hsdp_phase(torch, np, repo)

        begin_phase(
            17, f"overlap_grad_sync at BERT-base width on {DP_RANKS} "
            f"ranks of the card over gloo (phase 8's program and recipe "
            f"through fleet), {OVERLAP_STEPS} steps a leg; the preemption "
            f"drill on ZeRO-3")
        overlap_launches, overlap_report_ = overlap_phase(torch, np, repo,
                                                          per_kernel)

        begin_phase(
            18, f"tensor and sequence parallelism at BERT-base width on the "
            f"card over gloo: the ring's kernel entry against its twins, "
            f"{MP_LAYERS} layers: (a) tp 2 x sp 2 on {TPSP_RANKS} ranks "
            f"against one rank, (c) in its launch fsdp 2 x tp 2 with phase "
            f"8's recipe against one rank, its sharded save restored onto "
            f"tp 2 x sp 2 and data 4, (b) tp 2 with attention dropout, "
            f"{TPSP_STEPS} steps a leg")
        tpsp_launches, tpsp_report_ = tpsp_phase(torch, np, repo,
                                                 per_kernel)

        begin_phase(
            19, f"pipeline parallelism at BERT-base width and "
            f"{MP_LAYERS} layers "
            f"on the card over gloo (phase 8's program and recipe): "
            f"(a)-(c) pp {PIPE_STAGES} on {PIPE_STAGES} ranks, "
            f"{PIPE_M} microbatches (1F1B, zero-bubble, interleaved, 1F1B "
            f"at dropout {DROPOUT}), (d) dp 2 x pp 2 through fleet with "
            f"pipe-sharded weights on {PIPE_RANKS_D} ranks and (e) its "
            f"restore, {PIPE_STEPS} steps a leg")
        pipe_launches, pipe_report_ = pipe_phase(torch, np, repo)

        begin_phase(
            20, f"Mixture-of-Experts at BERT-base width "
            f"({MOE_EXPERTS} experts, top-2, capacity factor 2.0): (a) one "
            f"rank, {MOE_STEPS} steps of phase 20's fused program; (b) "
            f"expert 2 on {MOE_EP_RANKS} ranks of the card over gloo at "
            f"{MOE_EP_LAYERS} layers, float32 and int8 exchanges, the "
            f"sharded checkpoint restored onto one rank; (c) the MoE "
            f"decoder through DecodeEngine.generate")
        moe_launches, moe_report = moe_phase(torch, np, repo)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    begin_phase(21, f"report ({time.perf_counter() - t_start:.1f} s in all)")
    log("phase_seconds " + json.dumps(_PHASE_S))
    log("serving " + json.dumps(serving))
    log("training " + json.dumps(training))
    log("fused_training " + json.dumps(fused_training))
    log("data_parallel " + json.dumps({"ranks": dp_ranks,
                                       "parity": dp_parity}))
    log("decode " + json.dumps(decode))
    log("amp " + json.dumps(amp_report))
    log("lamb " + json.dumps(lamb_report))
    log("wrappers " + json.dumps(wrappers_report))
    log("zero " + json.dumps(zero_report))
    log("hsdp " + json.dumps(hsdp_report_))
    log("overlap " + json.dumps(overlap_report_))
    log("tp_sp " + json.dumps(tpsp_report_))
    log("pipeline " + json.dumps(pipe_report_))
    log("moe " + json.dumps(moe_report))
    log("observability " + json.dumps(OBS_REPORT))
    log("kernel_rows " + json.dumps(per_kernel))
    print(json.dumps(kernels_line(per_kernel, {
        "served": served, "unfused": unfused, "train": trained,
        "fused_train": fused, "dp_int8": dp_ranks[0]["int8"]["launches"],
        "dp_int4": dp_ranks[0]["int4"]["launches"], "decode": decoded,
        "amp": amp, "amp_fused": amp_fused, "amp_fp16": amp_fp16,
        "amp_pure_bf16": amp_pure, "lamb": lamb, **wrapped,
        **zero_launches, **hsdp_launches, **overlap_launches,
        **tpsp_launches, **pipe_launches, **moe_launches})))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
