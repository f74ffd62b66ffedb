"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``src/repro_torch/kernels`` and drives
its paths:

1. Kernels.  Each kernel against its plain PyTorch version on the card
   (max error, times, the least time the card could take, and one PyTorch
   library call as a yardstick): the four serving kernels at the serving
   path's shapes, the flash forward and backward at one training layer
   call's shape (each flash row names the dtype branch it ran: bf16 on the
   tensor cores, f32 on the CUDA cores; the forward's share of bf16
   outputs that round otherwise than the plain version's is printed),
   the five warp-feature kernels (shfl, vote, tile_reduce,
   mse_partial_sum, matmul) at sizes where launch latency does not
   dominate, and ``moe_gating`` at OLMoE's prefill shape (512 x 64, bf16,
   top-8) and decode shape (4 x 64), the Pallas kernel's edge rows first
   (ties, a NaN, all -inf, -1e30 below and above the picks, -3e38, +inf,
   +0/-0 ties), held against both plain versions (the rounds and their
   rank closed form) in bf16 and on the same values in f32, and timed
   with the calls queued beside an empty launch queued the same way, and
   the int8 branches of paged decode and verify (``paged_flash_decode[int8]``,
   ``paged_flash_verify[int8]``) at the serving shapes on pages quantized on
   the card, whose bytes must equal the CPU's, each also held against the
   float kernel on the dequantized pages (bf16 and f32 q), and the
   long-window branch of paged_flash_verify (T*G > 32 rows a KV head, a
   shared prefix's suffix prefill) at B 1, Hkv 2, G 6, D 128 behind a
   cached 256-token prefix, T 16 and 256, on bf16 pages and int8 pages
   under bf16 q (the tensor-core kernel, ``paged_flash_verify[long]`` and
   ``[long,int8]``) and f32 pages (the CUDA-core kernel), each with the key
   axis split across blocks and its split count and its split and combine
   kernels' profiled ms printed, beside SDPA on the dense view under the
   window's mask, for scale.  rmsnorm is timed
   at prefill's 4 x 512 rows and training's 8192 rows under an fp32 weight
   (beside ``F.rms_norm``; its wide branch in phases 5d, 7 and 7b);
   matmul in f32 (3xTF32 on the tensor cores;
   its bound is the smaller of the f32 CUDA cores' and three TF32
   products', both printed) and in bf16 (beside ``torch.matmul``), at
   2048^3.  The decode rows (dense, paged and int8-paged at qwen2's G = 6,
   and at OLMoE's G = 1 in phase 6) time their calls queued behind a spin
   on the card (the card's time; each call launches the split kernel and
   the combine pass) and print their factor to SDPA's queued time on the
   same slots and positions; so do the verify rows (bf16 and int8, the
   same split kernel over a spec_k = 4 window, beside SDPA on the dense
   view under the window's causal mask), which also print their split
   counts, and T = 1 verify must equal paged decode within 1e-6 (it
   prints whether bit for bit).  ``nvcc -Xptxas -v`` and ``cuobjdump
   -sass`` of ``matmul.cu``, ``rmsnorm.cu``, ``decode_attention.cu``,
   ``verify_attention.cu`` and ``warp_ops.cu`` run beside this phase
   (``ptxas ...`` lines, keyed by source: registers, spills, shared
   memory, HMMA count); it fails unless every matmul kernel and every
   instance of verify's long-window tensor-core kernel (bf16 and int8
   pages, D 64 and 128) has HMMA instructions and both decode kernels were
   reported.
2. The paper's layer: Figure 5 (``repro_torch.bench.fig5_microbench``) at
   the reference's size, HW through the warp-intrinsic kernels against SW
   through the PR-transformation lane loops; it fails if they disagree or
   if a warp kernel never launched.  A profile of each lowering then
   splits its time into device kernel time and kernels per call (from a
   whole trace only, else n/a: ``fig5_microbench.device_profile``).
   Then the paper's §IV pass (``pr_transform ...`` lines): the PR
   transformation's programs (``repro_torch.bench.pr_transform_bench``:
   the reference test's programs, every collective kind, a vote_uni and
   ballots with lane 0 of each segment inactive, integer reductions,
   int32 and bool shuffles, loads and stores outside a buffer, duplicate
   store indices, a region's carry) at WarpConfig(8, 4) and (32, 32)
   through the ``kernel`` (collectives on ``shfl``, ``vote`` and
   ``tile_reduce``), ``hw`` and ``sw`` executors.  It fails unless kernel
   == hw bit for bit (f32 sums within rtol 1e-6), sw == hw (f32 sums
   within 1e-5; the out-of-range store and the carry, where the paths'
   rules differ, each path equal to itself on the CPU), Fig. 3's report
   reads 2 serialised regions, 1 collective, 1 fissioned if, and each of
   the three kernels launched; it prints each lowering's event-timed ms,
   profiled device µs and kernels a call (``sw`` at 32x32 for two
   programs), and SW/HW.  The Table IV analogue follows (``table4 ...``
   lines: ATen ops and kernels of the RMSNorm site and a reduced qwen2 forward in each
   reduction form, and the HW kernels' registers and shared memory
   against one SM's).
3. Serving: 8 requests greedily with full-width qwen2-1.5b (random bf16
   weights from the seed) on the dense and on the paged cache layout, the
   paged pool small enough to force preemption.  Every serving run is
   pipelined, the engine's default: overlapped rounds, swap copies
   queued and materialized at the next commit, and each decode or verify
   step replayed as one captured CUDA graph (``serve/step_graph.py``); a
   timed engine first serves the same requests once untimed, which
   captures its graphs.  First a replay probe (``replay probe`` lines)
   holds one captured step of each kind (dense, paged, paged int8, spec)
   against the same step eager from equal states, bf16 at full width:
   whether logits, output and written cache rows are bit for bit equal.
   Beside the dense, paged, spec (b), int8 (a) and OLMoE dense runs a
   serial run (``pipeline=False``, eager: the control) serves the same
   call (``pipeline ...`` and ``graphs ...`` lines: tok/s of both, the
   graphs' count and capture seconds, the engines' peak memory, the
   token agreement, gated where the probe was bit for bit); in the fp32
   controls (C1's dense and paged, a spec run swapping on the preempting
   pool, the tiered swap run, the shared run on the preempting pool) the
   pipelined run must serve the serial run's tokens.  It fails where a
   captured step launches none of its kernels; the kernel rows' launches
   count replays (the capture's launches, added a replay).  It checks that every
   request finishes with its token count and that every serving kernel
   launched; teacher-forcing one request's tokens, the plain-version path
   and the models whose norms reduce through the paper's ``hw_warp`` and
   ``sw`` forms must give the kernel path's logits within a bf16
   tolerance (and, for the forms, the same greedy tokens).  Each run's
   prefill groups (uids, bucket, lengths) are logged, each request the
   bf16 layouts served otherwise is probed (its prompt rows as the two
   runs' prefill calls computed them), and an fp32 control serves dense
   and on the preempting pool, which must agree on every token (ROADMAP
   C1; the bf16 agreement is reported).  Last, it times one
   full-batch decode step (dense, paged bf16, paged int8) and one prefill
   against their summed kernel time (torch.profiler) to show where the
   time goes; each decode step's profile, and the spec_k = 4 verify
   step's, must hold both split-kernel passes (``decode_split_kernel``,
   ``decode_combine_kernel``), whose times it prints.  Beside those eager
   rows, one captured replay of each step kind (``..._graph`` rows: the
   dense, paged and int8 decode steps and the whole spec_k = 4 step with
   the 14-layer draft, beside that step eager), and in phase 6 OLMoE's
   decode step.
4. Speculative serving (``spec ...`` lines): the same 8 requests with
   spec_k = 4 on the paged layout, the verify window through
   ``paged_flash_verify``.  (a) A 14-layer self draft on the random
   weights, the pool sized to preempt; (b) weights damped to a
   near-identity stack with a 1-layer self draft, beside non-speculative
   paged serving of the same weights; (c) request 0's served tokens
   teacher-forced in windows of 4 through ``decode_verify_step``, kernel
   path and plain path, against the decode-step logits.  It fails unless
   every request finishes, the verify kernel launched, (a) preempted and
   both pools drained, and the verify logits stay within the tolerance.
4b. Tiered KV memory (``tiered ...`` lines), int8 pools: (a) the preempting
   pool under ``preempt="requeue"`` and ``"swap"`` (swapped bytes, the
   swap copy time, tok/s beside bf16 paged), (b) an int8 pool of the bf16
   preempting pool's bytes (preemptions beside bf16's), (c) an ample pool,
   (d) spec_k = 4 with the damped self:1 draft on the preempting pool,
   swapping.  Request 0's verify windows over an int8 pool are
   teacher-forced against int8 decode steps (kernel and plain path).  It
   fails unless every request finishes, both int8 branches launched (and
   no float paged kernel), the swap run swapped out and in, every pool
   drained, the ample pool never preempted, the windows stay within the
   logit tolerance, and, in an fp32 control, the swap, requeue and ample
   runs serve identical tokens, bar a request whose prompt the probe
   shows stored with other int8 bytes in the two runs (prefilled in
   another group or bucket); their bf16 agreement, and int8 against bf16
   paged and dense, are reported.
4c. Prefix sharing (``shared ...`` lines): 9 requests, 8 of them sharing
   one 256-token system prompt with suffixes of 17-240 tokens and one an
   exact copy of a page-aligned prompt, served with ``prefix_sharing`` on
   and off on (a) an ample pool and (b) the serving cell's preempting
   pool, and (c) with the eviction policies lfu and deepest on pool (b),
   and shared on an ample int8 pool.  Each shared admission prefills only
   its un-cached suffix through ``Model.prefill_suffix``, so through the
   long-window verify branch.  It fails unless every shared run launched
   the long branch and never the split verify kernel, shared something,
   leaked no page, (b) and (c) evicted and forked a page copy-on-write,
   the unshared (b) run preempted, the shared (b) run's slots mapped more
   pages than the pool held at its peak, the suffix prefill after a
   cached prefix gives the full prefill's logits within the logit
   tolerance (kernel and plain path), and, in an fp32 control, each
   shared run serves its unshared run's tokens and the three policies
   the same tokens (bf16 agreement is reported).  It prints TTFT of the
   warm admissions, tok/s and preemptions with and without sharing, peak
   physical against logical pages, and one warm against one cold
   admission's prefill device time (torch.profiler), with the warm
   prefill's long-branch device ms beside the unsplit design's.
4d. Sampling at temperature 0.7 (``sampled ...`` lines), the engine's
   keys ``fold_in(fold_in(PRNGKey(seed), uid), position)`` drawn on the
   card (``serve/sampling.py``): the sampler's keys, bits, uniforms and
   scaled logits at the full vocabulary equal the CPU's (the Gumbel
   values within ``GUMBEL_ATOL``); 4096 draws with distinct uids from one
   fixed logits row land within 5 sigma of softmax(logits / T) on each
   of 17 buckets; a sampled replay probe of the dense, paged and spec
   steps; dense and preempting paged serving pipelined against serial
   (gated where the sampled probe was bit for bit); the fp32 control
   sampled (dense = the preempting pool, gated); spec (b) sampled beside
   non-spec (accept rate and agreement reported); the captured sampled
   dense and spec steps' wall and kernel ms beside the greedy ones;
   ``ServeEngine.generate`` at two seeds and ``repro_torch.serve_lm``.
   It fails unless the sampled streams differ from the greedy ones and
   across two seeds.
4e. The engine's scheduling axes (``sched ...`` lines, after 4c; each
   number beside the card's name and power limit): (a) 4 long prompts
   (480-512 tokens, 16 new, priority 1) behind 2 short ones (32-64
   tokens, 96 new, priority 0), paged bf16 on an ample pool, with whole
   prefill and with ``prefill_budget=128`` (each long prompt written in
   128-token chunks through ``Model.prefill_suffix``, verify's long
   branch, between the decode steps): the short requests' TBT
   percentiles, the long ones' TTFT and chunk counts, tok/s, rounds and
   the long branch's launches; it fails unless every long request took
   more than one chunk and the long branch launched.  (b) The fp32
   control: chunked = whole prefill, greedy and sampled, serial =
   pipelined under the budget, and a swap run on a preempting pool under
   the budget = without it, every token.  (c) Lifecycle on 2 slots, 12
   requests in three priority classes, one cancel()ed before serve(),
   one with ``deadline_ms=0.0``: ``max_queue=8`` under reject-newest and
   reject-largest, and ``queue_watermark=2`` with ``shed_priority=2``;
   it fails unless every request ends in one terminal status, the shed
   set is the one the policy names, the cancelled and expired requests
   end so and the ok ones carry their tokens; the SLA summary
   (``serve.sla.format_summary``) is printed.  (d) On 1 slot priorities
   5, 1, 0 finish 0 first, with the all-default run's tokens (bf16).
   (e) The seed loop (``fused=False``, dense, eager): its fp32 tokens
   must be the fused run's; its bf16 tok/s beside the captured pipelined
   dense run.
4f. Faults, recovery, the HW->SW degrade and the pool audit (``faults
   ...`` lines, after 4e; each number beside the card's name and power
   limit): 4e's 12 lifecycle requests (deadlines dropped) on 4 slots of
   an ample paged pool, each engine warmed by fault-free sessions (which
   capture its graphs), pipelined and captured beside the serial
   control.  (a) One ``serve.faults`` schedule: NaN logits for a live
   uid (rounds 3-4), a cancel (round 5) and a forced deadline (round 6)
   of two other live uids, a seeded page corruption (round 8), a 3-round
   soft OOM (10-12) and a hard OOM at the first later round that
   allocates (found by running the rest of the schedule with a probe of
   the allocator's hook): the targets end failed, cancelled and timeout,
   each engine recovers once without degrading, the pool drains
   audit-clean, and pipelined = serial on statuses and tokens (gated
   where the paged replay probe was bit for bit).  (b) A ``kernel``
   fault at round 6: the engine degrades once onto the plain lowering
   (launch counts from the degrade on hold no rmsnorm, flash or decode
   launch; the dropped graphs are captured again and name none), every
   request ends ok.  (c) A 0.2 s straggler at round 8: the watchdog's
   event over 3x the median step.  (d) spec_k 4 on the damped weights
   with a self:1 draft, ``spec_collapse`` on one uid for 8 rounds: the
   governor (window 4, cooldown 4) turns speculation off and back on.
   The fp32 control runs (a), (b) and (d) on the widened weights: every
   ok request of (a) has the fault-free tokens, (b) the kernel run's
   (where one differs it prints the step's top-2 margin against the
   kernel-vs-plain logit error, and fails), (d) the fault-free spec
   run's.  (e) The wall from the hard OOM's recovery to the requeued
   requests' next tokens on the host, and the captured dense and paged
   decode steps' kernel ms with the fault-mask buffer the engine's steps
   read against without.  Every other phase's engines run without a
   fault schedule: each must end with no recovery, no degrade and (paged)
   an audit-clean pool (``fault-free engines`` line).
4g. Open-loop serving (``openloop ...`` lines, after 4f; each number
   beside the card's name and power limit): 16 requests from
   ``serve.workload.make_workload`` (prompts of median 128, at most 512
   tokens; median 32, at most 64 new) replayed through
   ``serve.async_engine.serve_open_loop`` on 4 slots of 16-token pages.
   (a) The round clock, a mean arrival every 8 rounds, on an ample pool:
   every status ok, the pool audit-clean with no page in use, and each
   request's streamed tokens against a closed ``serve()`` of the same
   requests on the same engine (bf16: reported, with the prefill buckets
   of a request that differs in both runs, C1); in fp32 on the ample
   pool, the serving cell's 105-page pool and a 56-page pool that this
   workload fills (it must preempt) the streams must equal the closed
   serve.  (b) The
   wall clock: R, the requests a second of a closed batch of the 16 on
   the warmed engine, then Poisson arrivals at 0.25, 0.5, 1 and 2 R with
   ``max_queue=8``: TTFT p50/p95/p99, TBT p50/p99/max, goodput, the
   status census, a busy round's own wall at p50 with and without an
   admission (which rounds admitted: the timeseries' live uids); the
   statuses must partition and the pools
   audit clean, and an fp32 run at 1 R must stream its closed serve's
   tokens.  (c) Chaos: MMPP-2 arrivals at 2 R on the round clock (R's
   round time), ``audit=True``, ``max_queue=8``, one schedule of a NaN,
   a cancel, a hard OOM and a ``kernel`` fault, its rounds found by
   probe runs: the cancel target ends cancelled, the pool clean and
   drained, no serving kernel launches after the degrade (nor in the
   graphs captured again), and in fp32 the survivors' tokens equal a
   fault-free closed serve's (bf16 reported).  (d) Backpressure: the 16
   submitted in one burst against ``max_queue=3`` with
   ``backpressure_watermark=2``: the depth never passes 2 and every
   request ends ok; without the watermark the burst sheds.  (e)
   ``preempt_calibrate=True`` on the preempting pool: the measured swap
   GB/s and decode GFLOP/s, the construction's seconds, the policy
   ``preempt="auto"`` takes, whose tokens must equal an explicit run of
   that policy.  (f) ``python -m repro_torch.launch.serve`` open-loop on
   the round clock with ``--preempt auto --preempt-calibrate``, in a
   subprocess: exit 0 and the SLA block printed.
5. Training (``train ...`` lines): full-width, full-depth qwen2-1.5b with
   fp32 master weights and AdamW state, bf16 compute, remat per layer and
   the 8-chunk loss, at the reference's train_4k length (S 4096; batch 2,
   cut from the reference's 256).  First one gradient on one batch twice
   on the same weights, kernel path and plain path (tf32 off), held to
   the loss, global-norm, per-leaf cosine and per-leaf norm-difference
   gates below, and a faulted control that must trip them; then
   ``Trainer.run`` for 4 steps (loss, lr, grad_norm, ms, tokens/s, peak
   memory, launches); then one profiled step.  It fails on a non-finite
   loss or unless every layer's backward went through
   ``flash_attention_bwd``.
5b. Checkpoints (``ckpt ...`` lines, after 5 has freed its state):
   qwen2-1.5b at full width cut to 2 layers (~0.56 B parameters; fp32
   weights and AdamW, bf16 compute, S 4096, batch 2), in a temporary
   folder that must have 2.5 states' bytes free and is removed at exit.
   (a) U1 and U2 train 6 steps each from one seed; P is the same run
   preempted after step 2 (a sync checkpoint at step 3), resumed by a new
   Trainer to 6, which must start at step 3.  If U1 and U2 agree bit for
   bit, P must equal U1 bit for bit; else P's largest difference per leaf
   must stay within twice U2's and its losses within rtol 1e-5 (the case
   is printed).  (b) ``AsyncCheckpointer.save``, one in-place training
   step, ``wait()``: the restored state must equal a clone taken at save,
   bit for bit.  (c) The checkpoint's bytes, the sync save's seconds, the
   async save's stall, the writer's and the restore's seconds.  (d)
   ``python -m repro_torch.launch.train --ckpt-dir`` twice on one folder
   (2 steps and a checkpoint, then a resume for 1 more) and, beside them,
   ``python -m repro_torch.train_lm --steps 1`` (a checkpoint, then its
   restart drill), each in a subprocess on the card: exit 0 and the
   resume printed.
5c. MoE training (``moe train ...`` lines): full-width, full-depth
   Granite-MoE-1B-A400M (24 layers, d_model 1024, 16/8 heads, 32 experts,
   top-8, ~1.38 B parameters) with fp32 weights and AdamW, bf16 compute,
   remat, the 8-chunk loss, S 4096 and batch 2, at the config's
   ``moe_group_size`` 0 and capacity factor 1.25.  One gradient on one
   batch through the kernel path (the router's top-k through
   ``moe_gating``'s forward, ``MoEGating``'s backward) and the plain path
   (autograd through ``moe_gating_ref``), tf32 off, held to the gates
   below, and a faulted control (the gating gradient scaled by 1.25) that
   must trip them; ``Trainer.run`` for 4 steps (loss, lr, grad_norm, ms,
   tokens/s, peak memory, launches); the share of token-expert choices
   dropped at capacity; one profiled step.  It fails on a non-finite loss
   or unless every layer's router went through the kernel's forward twice
   a step (forward and remat).
5d. MLA training (``mla train ...`` lines, after 5c, while the card holds
   no other model): MiniCPM3-4B at full width (d_model 2560, 40 heads, q
   rank 768, kv rank 256, q/k heads of 64 nope + 32 rope dims, v heads of
   64, d_ff 6400, vocab 73448) cut to 8 of its 62 layers, fp32 weights
   and AdamW, bf16 compute, remat, the 8-chunk loss, S 4096 and batch 2.
   First the memory count (the state at 16 bytes a parameter, the gradient
   check's two gradients and its plain backward's fp32 scores), which
   must fit; then the flash forward's and backward's (96, 64) instances at
   one training layer call (B 2 x S 4096 x 40 heads, causal, v a strided
   view of the decompressed row) against their plain versions, bf16 (their
   rows of the kernel record, beside SDPA's forward and backward or its
   refusal) and f32, and rmsnorm's wide branch over 8192 x 2560 bf16 rows
   under an fp32 weight (row ``rmsnorm[wide] (training, d 2560)``, beside
   ``F.rms_norm`` and the ragged branch on the same rows one element in,
   both branches held against the plain version); one gradient through the kernel path and the plain
   path held to the gates below, with two faulted controls (dk scaled by
   1.25 and dv scaled by 1.25 in the backward) that must each trip a
   gate; ``Trainer.run`` for 4 steps (loss, lr, grad_norm, ms, tokens/s,
   peak memory), whose launches must be, a step, two a layer of the
   forward's (96, 64) instance (forward and remat), one a layer of the
   backward's, and no other flash kernel, with rmsnorm's warp and wide
   branches and not its ragged one; one profiled step; and, after phase
   5e, ``python -m repro_torch.launch.train --arch minicpm3-4b --steps 2
   --batch 2 --seq 64`` in a subprocess on the card, which must exit 0,
   beside phase 5e's two CLI legs.
5e. RWKV6 and Zamba2 training (``recurrent train ...`` lines, after 5d):
   first the flash backward's (80, 80) instance at rows 3 and 3c's shape
   (B 2 x S 4096 x 32 / 32 heads, Zamba2's shared attention, causal)
   against its plain version, bf16 (row ``flash_attention_bwd (Zamba2 D
   80)`` of the kernel record, beside SDPA's forward and backward less its
   forward) and f32, and the bf16 call at the training step's shape.
   Then each model: the memory count (fp32 weights, gradients and AdamW
   at 16 bytes a parameter: Zamba2-2.7B at its full 54 layers, RWKV6-7B
   cut to 12 of 32), which must fit; one gradient through the kernel path
   and the plain path in fp32 compute at full width, depth cut (RWKV6 4
   layers, Zamba2 two groups), B 2 x S 64, held to phase 5's gates, with
   faulted controls that must each trip a gate (Zamba2: dk and dv scaled
   by 1.25 in the (80, 80) backward; RWKV6: rmsnorm's backward input
   scaled by 1.25), and the same gradient in bf16 compute, printed;
   ``Trainer.run`` for 2 steps at full width, bf16 compute, remat, B 2 x
   S 64 (loss, ms, tokens/s, peak memory), whose launches must be one
   (80, 80) forward and one backward a group a step for Zamba2 (the
   shared block is not rematted) and no flash kernel for RWKV6, with
   rmsnorm's wide branch and not its ragged one; one profiled step (the
   device's records).  ``python -m repro_torch.launch.train --arch
   rwkv6-7b`` and ``--arch zamba2-2.7b`` (``--steps 2 --batch 2 --seq
   64``) run after it, beside phase 5d's CLI, and must exit 0.
6. MoE serving (``moe ...`` lines), before training and after the qwen2
   serving model is freed: full-width OLMoE-1B-7B (16 layers, d_model
   2048, 16/16 heads, 64 experts, top-8; random bf16 weights from the
   seed) serves the same 8 requests on the dense cache, a preempting
   paged pool and an ample one, each prompt prefilled alone at its exact
   length, the router's top-k through ``moe_gating``.  First it holds the
   kernels at OLMoE's own shapes against their plain versions (flash
   forward at G = 1 and S 300, dense and paged decode at G = 1, rmsnorm
   over 512 x 2048 bf16 rows; decode at G = 1 with its bound and beside
   SDPA, for scale).  It fails unless every request finishes,
   every kernel of the path launched, the paged runs serve the dense
   run's tokens, one decode step launches ``moe_gating`` once per layer,
   and the teacher-forced plain path stays within the logit tolerance.  A
   preempted request may differ only where its re-prefill dropped expert
   picks at the prefill capacity (counted in a tapped rerun), and with
   nothing dropped, in fp32, it must agree (a control on the same
   weights; a bf16 control beside it is reported).  The teacher-forced
   paths' expert choices are compared, and the plain path is run again
   with the kernel path's routing replayed.  Last, one prefill and one
   decode step are profiled; each profile must hold ``moe_gating``'s
   device time, which the ``time`` line prints.  Before the profiles, the
   MoE target speculates (``spec moe ...`` lines): the same 8 requests
   with spec_k = 4 and a 4-of-16-layer self draft on the preempting pool
   (the verify window through ``paged_flash_verify`` at G = 1, T*G = 4,
   the target's and the draft's routers through ``moe_gating``): accept
   rate, tok/s beside non-speculative paged serving, preemptions (it must
   preempt) and the token agreement with the non-speculative run
   (reported), then request 0's verify windows teacher-forced against its
   decode steps, kernel and plain path, within the logit tolerance.  The
   kernel check of this phase holds ``paged_flash_verify`` at OLMoE's G =
   1 (B 4, Hkv 16, T 4, D 128; bf16 pages, and int8 pages printed)
   against its plain version.
4h. Layer options (``options ...`` lines, after 4d): qwen2-1.5b at full
   width with ``pad_vocab_to=256`` (151936 -> 152064 columns), its
   weights the serving weights with zero rows and columns appended: in
   fp32 compute, greedy and sampled (T 0.7, seed 3) captured paged serving
   of 4 requests must give the unpadded model's tokens; a tied model
   (``tie_embeddings``: no ``lm_head``, ``embed.T`` as the head) runs a
   prefill and 8 decode steps with finite logits; one captured decode
   step of the padded bf16 head is profiled beside the unpadded one.
4i. The fleet (``fleet ...`` lines): qwen2-1.5b at full width, paged, on
   12 requests of ``serve.workload.make_tenant_workload`` (64-token
   system prompts of 4 tenants): (a) 2 mixed replicas behind the
   cache-aware router, (b) 3 replicas disaggregated (1 prefill, 2
   decode) behind least-loaded, (c) (b) under per-worker fault schedules
   with a decode worker killed in round 3.  In fp32 compute (a) and (b)
   must serve one direct engine's tokens on every request, every request
   of (b) must cross one handoff and restore its pages (``swap_ins`` >=
   1), each fleet audit must be clean, and in (c) every request must end
   in a terminal status and the survivors must serve the direct engine's
   tokens.  In bf16 the agreement with a direct engine is reported (any
   request that differs is named), with the handoff's swap-out and
   restore ms, each replica's census and the fleet's SLA summary.  Then
   ``python -m repro_torch.launch.serve --replicas 2 --router
   cache-aware`` and ``--replicas 3 --disaggregate`` run in subprocesses
   on the card and must exit 0 with a clean fleet audit.
7. Qwen1.5-32B (``qwen32b ...`` lines, run right after phase 2, while
   the card holds no other model; printed before the serving lines):
   full width and depth (64 layers, d_model 5120, 40/40 heads, d_ff
   27392, vocab 152064, bf16, ~35.2 B parameters).  First its kernel
   shapes against their plain versions (the flash forward at Hq = Hkv =
   40, dense decode at 40/40 heads, rmsnorm's wide branch (several warps
   a row: rows wider than 2048) over 4 x 512 rows of 5120, its own row of
   the kernel record, ``rmsnorm[wide] (d 5120)``, beside ``F.rms_norm``
   and the ragged branch on the same rows one element in, and over 4
   decode rows of 5120 beside the ragged branch on a view one element in,
   which it must not be slower than; each branch held against the plain
   version), then the memory count (weight bytes, cache bytes, the prefill's transient copy, free device memory
   before the init): it fails with the count if they do not fit.  Then 4
   requests (prompts of 128-512 tokens, 16 new) served greedily on the
   dense cache, 4 slots, max_seq 576: TTFT, decode ms a step, tok/s,
   peak memory and the kernels' launches (``rmsnorm[wide]`` among them);
   request 0's first 8 tokens teacher-forced on the plain path within the
   logit tolerance.
7b. MiniCPM3-4B, MLA (``mla ...`` lines, right after phase 7): full
   width and depth (62 layers, d_model 2560, 40 heads, q rank 768, kv
   rank 256, q/k heads of 64 nope + 32 rope dims, v heads of 64, d_ff
   6400, vocab 73448, bf16, ~4.26 B parameters).  First the flash
   forward's (D, Dv) = (96, 64) instance at its prefill shape (B 4 x S 512
   x 40 heads, v a strided view of the decompressed row, as the model
   passes it) in bf16 (its row of the kernel record, beside SDPA or its
   refusal) and in f32, against ``flash_attention_ref``, and rmsnorm at
   the latent norms' widths 768 and 256 (warp branch) and d_model 2560
   (wide branch: row ``rmsnorm[wide] (d 2560)``, 4 x 512 rows beside
   ``F.rms_norm`` and the ragged branch, and 4 decode rows beside the
   ragged branch, as in phase 7); then the memory count; then 4 requests (prompts of
   512 and three of 128-512 tokens, 16 new) served greedily on the dense
   latent cache: tok/s, TTFT, ms a decode step against the weights'
   read, peak memory and the launches, which must include the Dv branch
   and rmsnorm's wide branch;
   request 0's first 8 tokens teacher-forced on the plain path within the
   logit tolerance; the paged layout must raise ``ValueError`` on the card.
   MLA decode runs no hand-written kernel (the reference's is fp32
   einsums in the latent space too).
7c. RWKV6-7B and Zamba2-2.7B serving (``recurrent ...`` lines, after
   7b): the kernels at their shapes, both models served at full
   width and depth, profiled, teacher-forced and refused on the paged
   layout, fp32 controls, and qwen2 speculating with each as its draft.
   The teacher-forced bf16 gate (kernel path within max(``LOGIT_TOL``, the
   plain bf16 path's distance from an fp32 run)) has faulted controls:
   RWKV6's rmsnorm wide-branch weight and Zamba2's D 80 attention output
   scaled by 1.001, 1.003, 1.01, ... in turn until the gate trips, which
   it must by 1.3; the smallest scale caught is printed.

Every serving, MoE and training run must normalize through rmsnorm's
one-warp-a-row branch or, for rows wider than 2048 (the 32B and MLA runs'
5120 and 2560), its several-warps-a-row wide branch: the run fails if one
launched the block-per-row ragged branch.  The flash rows count the bf16
branch's launches only.  The fp32 controls (C1, the tiered and the MoE
ones) run the f32 branch: its launches are printed on a line of their
own, and the run fails if a bf16 run launched an f32 flash kernel or an
fp32 control a bf16 one.

Details land in ``build/chip_smoke.json`` (git-ignored).  The
second-to-last lines are the kernels' JSON record and the card's name and
power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check exits non-zero before that line.  Imports no JAX.
Without CUDA, or without the repository's ``src/`` beside it, it fails.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DETAILS = ROOT / "build" / "chip_smoke.json"

# published peaks of one H100 SXM (dense): bf16 and TF32 tensor cores, fp32
# CUDA cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
TF32_FLOPS_S = 495e12
F32_FLOPS_S = 67e12

# bf16 kernel vs plain version: both accumulate in fp32 and round the
# output to bf16 once, so they may differ by a couple of bf16 ulps
# (2^-8 relative) of the output's magnitude
KERNEL_TOL = dict(atol=2e-2, rtol=2e-2)
# the flash forward at B 2 x S 4096 from N(0, 1) inputs: a row over n keys
# has |o| ~ sqrt(e / n), 0.03 at n ~ 3000, so KERNEL_TOL would pass a wrong
# P.V there.  rtol 8e-3 is one bf16 ulp (<= 2^-7 relative) wherever |o| is
# large, atol 2e-3 a few ulps of the small rows' |o|
FLASH_FWD_TOL = dict(atol=2e-3, rtol=8e-3)
# teacher-forced logits, plain path vs kernel path, bf16 through 28 layers:
# the paths differ only in where a bf16 rounding lands inside attention and
# rmsnorm, and random weights carry such 2^-8 relative differences from
# layer to layer; 10% of the step's largest |logit| stays far below what a
# wrong mask, position or page does (those change the logits wholesale)
LOGIT_TOL = 0.1
# mse: f32 sums of squares added in another order, the last ~1000 block
# partials by atomics in no fixed order; each atomic rounds to half an ulp
# of the running sum, so the sums differ by ~4e-7 relative (std) at any
# size.  2e-6 is ~5 of those; at 2^16 elements (one per thread) a lost
# element moves the sum by ~1.5e-5 relative, and at 2^25 a lost thread's
# run (124 elements) by ~4e-6
MSE_TOL = dict(atol=0.0, rtol=2e-6)
# f32 2048^3: each output sums 2048 products of N(0,1) pairs (|c| ~ 45) in
# another order than cuBLAS; f32 rounding leaves ~1e-5 relative, and a
# wrong tile or edge moves an entry by O(1)
MATMUL_TOL = dict(atol=2e-3, rtol=1e-4)
WARP_KERNELS = ("shfl", "vote", "tile_reduce", "mse_partial_sum", "matmul")
PR_KERNELS = ("shfl", "vote", "tile_reduce")   # the PR pass's kernel lowering
WARP_FORM_STEPS = 4
ARCH = "qwen2-1.5b"
MOE_ARCH = "olmoe-1b-7b"
# moe_gating vs its plain version: the same selection from the same f32
# values (a wrong pick moves a mask entry by 1) and weights <= 1 from the
# same exps, summed over the k selected in another order: a few f32 ulps
GATING_TOL = dict(atol=1e-6, rtol=0.0)
NEG_SENTINEL = -1e30          # the Pallas gating kernel's mask-out value
SLOTS = 4
MAX_NEW = 32
MAX_SEQ = 576
PAGE_SIZE = 16
SPEC_K = 4
# the slots' positions in a full decode batch, and their attend bucket
DECODE_POS = (543, 400, 300, 64)
ATTEND = 576
# verify kernel at T = 1 against the paged decode kernel in f32: one split
# kernel on the same split count, so they agree exactly (the gate stays
# at a few f32 ulps)
T1_TOL = 1e-6
# flash backward vs its plain version: both widen the same bf16 inputs
# and return f32 sums over up to 4096 keys (dq) or 6 x 4096 query rows
# (dk/dv) taken in another order, ~1e-5 of the sums' magnitude (<= ~10);
# a wrong mask, tile edge or group sum moves entries by O(0.1-1)
BWD_TOL = dict(atol=1e-3, rtol=1e-3)
# int8 kernels with f32 q: the plain version and the kernel dequantize to
# the same f32 values and sum in another order, to f32 rounding of the
# output (|o| <= max |v| ~ 4)
INT8_F32_TOL = dict(atol=1e-5, rtol=1e-5)
# training: the reference's train_4k sequence (config.py:148); its global
# batch of 256 is a pod's, cut to 2 for one card
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_STEPS = 4
VOCAB_CHUNKS = 8
# one gradient, kernel path vs plain path, bf16 compute through 28
# layers: the paths round to bf16 at the same points and differ only in
# the order of fp32 sums, so an occasional bf16 ulp flips and spreads.
# Each gate was set at ~10x this phase's sound reading on an H100 with the
# CUDA-core flash kernels (PERF.md): loss 2.9e-6, global norm 3.8e-5
# relative, and at layers.attn.bk 1 - cosine 4.1e-5 and a norm difference
# of 9.1e-3 relative.  The tensor-core flash kernels read 1.5e-5, 3.3e-5,
# 4.9e-5 and 9.9e-3; with the one-warp-a-row rmsnorm since (its bf16
# outputs round otherwise than the plain version's at 5.7e-6 of training's
# 8192 x 1536 elements, where the block-per-row kernel's did at 5.1e-6,
# other elements) 2.956e-5, 1.7e-5, 5.1e-5 and 1.0e-2: the loss 1.5 %
# under its gate (src/repro_torch/bench/grad_ab.py on each tree).  Variants
# of the flash kernels with an exact exp, a third bf16 term or fp32 sums
# across tiles read a loss difference of 1.1e-5 to 2.3e-5 whatever their
# own error (scripts/flash_variants.py): it is bf16 rounding noise through
# 28 layers, not a measure of the kernels' error.  The loss cannot see
# the backward (at random weights it sits near ln V whatever attention
# computes) and the cosine is blind to a wrong scale; the per-leaf norm
# difference is not, and a faulted control (dk scaled by GRAD_FAULT_DK
# in the backward) must trip a gate, or the gates are blind and the
# phase fails.
GRAD_LOSS_TOL = 3e-5          # absolute, on a loss of ~12 (ln 151936)
GRAD_NORM_TOL = 4e-4          # global norms, relative
GRAD_COS_MIN = 1 - 4e-4       # smallest per-leaf cosine similarity
GRAD_LEAF_TOL = 0.09          # largest per-leaf |a - b| / |b|
GRAD_FAULT_DK = 1.25          # the control's wrong dk scale
# phase 5b: checkpoints of full-width qwen2-1.5b cut to 2 layers (~0.56 B
# parameters): U1 and U2 train CKPT_STEPS steps uninterrupted from one
# seed; P is the same run preempted after step CKPT_STOP_AFTER (a sync
# checkpoint at step CKPT_STOP_AFTER + 1), then resumed by a new Trainer
CKPT_LAYERS = 2
CKPT_STEPS = 6
CKPT_STOP_AFTER = 2
CKPT_DISK_FACTOR = 2.5        # free disk the phase needs, in states' bytes
# the reference's resume tolerance on the loss (tests/test_fault_tolerance.py)
CKPT_LOSS_RTOL = 1e-5
# the CLIs: launch.train on one folder to CKPT_CLI_STEPS[0] (a checkpoint
# there), then resumed to CKPT_CLI_STEPS[1]; train_lm's restart drill
# after TRAIN_LM_STEPS steps (a checkpoint each step).  The drill needs one
# checkpoint and one restart, so no leg runs more steps than that
CKPT_CLI_STEPS = (2, 3)
CKPT_CLI_EVERY = 2
TRAIN_LM_STEPS = 1
# phase 5c: MoE training at full width and depth, at the config's own
# moe_group_size (0) and capacity factor (1.25)
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
# one gradient, kernel path vs plain path (autograd through moe_gating_ref),
# bf16 compute through 24 layers: moe_gating's masks equal the plain
# version's bit for bit, so what differs is rmsnorm's and flash's bf16
# rounding, which moves router logits across a tie now and then: a pick
# flips, and the expert buffers' places and drops behind it shift.  Each
# gate is ~10x this phase's sound reading on an H100 (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md): loss 4.58e-5, global norm 2.65e-4
# relative, and at layers.moe.router 1 - cosine 5.02e-4 and a norm
# difference of 3.17e-2 relative.  The faulted control (the gating
# gradient x GRAD_FAULT_GATE in every layer) read 1.92e-2, 1 - 1.13e-2 at
# layers.attn.wq and 0.324 at the router: it trips three gates.
MOE_GRAD_GATES = dict(loss=5e-4, norm=3e-3, cos=1 - 5e-3, leaf=0.3)
GRAD_FAULT_GATE = 1.25        # the MoE control's wrong gating-gradient scale
# rmsnorm's calls take the host longer to launch than the card to run:
# their rows are timed with the calls queued behind a spin on the card,
# long enough for a few hundred launches (cycles at a clock above the
# H100's 1.98 GHz)
SPIN_S = 0.02
SPIN_CYCLES_S = 2.0e9
# queued calls a decode or verify row times (its wrapper launches two
# kernels)
DECODE_ITERS = 100
# the decode and verify wrappers' two kernels, as the profiler names them
DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")
# the gating kernel, as the profiler names it
GATING_KERNEL = "moe_gating_kernel"
# prefix sharing: the system prompt the shared requests open with (16
# full pages), and the long-window verify branch's suffix buckets
# phase 4d: sampling
SAMPLE_T = 0.7
SAMPLE_SEED = 3
FREQ_DRAWS = 4096
FREQ_CHUNK = 256
FREQ_HOT = 16                 # buckets with ~2-8 % of the mass each
FREQ_SIGMA = 5.0
SYSTEM_PROMPT = 256
LONG_T = (16, 256)
# the long branch's f32 (CUDA-core) kernel vs its plain version: the same
# f32 products summed in another order over <= 512 keys, |o| <= max |v| ~ 4
LONG_F32_TOL = dict(atol=1e-5, rtol=1e-5)
# the long branch's kernels as the profiler names them: its split kernel
# (verify_long_tc_kernel / verify_long_core_kernel) and split.cuh's combine
LONG_KERNELS = ("verify_long", "decode_combine_kernel")
# a warm suffix prefill's long-branch device ms (28 calls) in this smoke
# before the key axis was split (one kernel a call; one H100 80GB HBM3 at
# 700 W), printed beside the current reading
LONG_UNSPLIT_WARM_MS = 1.005


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after a warm-up; inputs stay warm in the 50 MB L2).  A call
    the host launches more slowly than the card runs it is timed at the
    host's pace; with ``queued`` the calls first queue up behind a spin on
    the card, and the events time the card's work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(SPIN_S * SPIN_CYCLES_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn) -> float:
    """A decode or verify row's time: DECODE_ITERS calls queued behind a
    spin on the card, so the events time the card's work alone (such a
    call runs shorter than the host takes to launch one)."""
    return cuda_ms(fn, iters=DECODE_ITERS, queued=True)


def sdpa_factor(name: str, ms: float, sdpa_ms: float):
    """Print a decode row's factor to SDPA's queued time on the same
    slots, positions and dense view (for scale: the port never calls it;
    paged rows read other K/V through their tables, same shapes)."""
    print(f"kernel {name}: ms={ms:.4f} sdpa_ms={sdpa_ms:.4f} (calls queued) "
          f"factor to SDPA {ms / sdpa_ms:.2f}", flush=True)


def bound(n_bytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _words(t: torch.Tensor) -> torch.Tensor:
    """uint32 results (ballots) compared through their int32 view."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def agrees(got: torch.Tensor, want: torch.Tensor, tol) -> bool:
    """``tol`` is "exact" (same dtype and bits) or allclose's keywords."""
    got, want = _words(got), _words(want)
    if tol == "exact":
        return got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    return torch.allclose(got.float(), want.float(), **tol)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (_words(got).double() - _words(want).double()).abs().max().item()


# the branch of the flash kernels that each dtype runs (one C entry point
# dispatches on it)
FLASH_BRANCHES = {torch.bfloat16: "bf16 (tensor cores: mma.sync, split-bf16 P and dS)",
                  torch.float32: "f32 (CUDA cores)"}
# the branch each flash row ran, for the details file
BRANCHES_RUN = {}
# matmul readings beside its row: the bound candidates, the bf16 branch
MATMUL_READINGS = {}


def record_kernel(rows, name, source, replaces, got, want, tol, t_kernel, t_plain,
                  n_bytes, flops, peak, t_lib, branch=None):
    """Hold a kernel's result against its plain version's, print the line
    and add the kernel's JSON row (launches are filled in by the phase
    that drives the main path).  ``branch`` names the kernel's dtype
    branch where it has two."""
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = agrees(got, want, tol)
    b_ms, b_by = bound(n_bytes, flops, peak)
    rows[name] = dict(name=name, route="cuda", source=source,
                      replaces=replaces, launches=0, max_abs_err=err,
                      ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms,
                      bound_by=b_by, library_ms=t_lib)
    lib = "none" if t_lib is None else f"{t_lib:.4f}"
    ran = ""
    if branch is not None:
        BRANCHES_RUN[name] = branch
        ran = f" branch={branch}"
    print(f"kernel {name}: max_abs_err={err:.3e} tol={tol} ok={ok} "
          f"ms={t_kernel:.4f} plain_ms={t_plain:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"library_ms={lib}{ran}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version beyond {tol}")


RMSNORM_SOURCE = "src/repro_torch/kernels/rmsnorm/rmsnorm.cu"
RMSNORM_REPLACES = "src/repro/kernels/rmsnorm/rmsnorm.py:29"


def unaligned_copy(x: torch.Tensor) -> torch.Tensor:
    """x's values in a buffer of their own, one element in: the same rows,
    not 16-byte aligned, which rmsnorm's ragged branch takes."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return flat[1:].view(x.shape).copy_(x)


def rmsnorm_wide_row(rows, name, x, w, eps) -> dict:
    """A row of rmsnorm's wide branch (rows wider than 2048, which must
    take it): kernel, plain version and ``F.rms_norm`` (one call, which
    does not fuse a weight of another dtype than the rows) timed with the
    calls queued, the card's time.  Bound: x and w read once, y written
    once, 4 operations an element on the f32 CUDA cores.  Beside it the
    ragged branch, which took these rows before the wide one, on the same
    rows one element in (``unaligned_copy``), held against the plain
    version too and timed alike.  Prints the seconds the row took."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_branch
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    t0 = time.perf_counter()
    d = x.shape[-1]
    xr = unaligned_copy(x)
    for rows_in, branch in ((x, "wide"), (xr, "ragged")):
        took = rmsnorm_branch(rows_in, w)
        if took != branch:
            fail(f"{name}: {tuple(x.shape)} rows took rmsnorm's {took} branch, not {branch}")
    fns = (lambda: rmsnorm(x, w, eps), lambda: rmsnorm_ref(x, w, eps),
           lambda: F.rms_norm(x, (d,), w, eps))
    got, want = fns[0](), fns[1]()
    kernel_ms, plain_ms, library_ms = (queued_ms(f) for f in fns)
    record_kernel(rows, name, RMSNORM_SOURCE, RMSNORM_REPLACES, got, want, KERNEL_TOL,
                  kernel_ms, plain_ms, 2 * x.numel() * x.element_size() + d * w.element_size(),
                  4 * x.numel(), F32_FLOPS_S, library_ms)
    got_r = rmsnorm(xr, w, eps)
    torch.cuda.synchronize()
    ragged_err = max_err(got_r, want)
    ragged_ms = queued_ms(lambda: rmsnorm(xr, w, eps))
    print(f"kernel {name}: {tuple(x.shape)} {x.dtype} rows, {w.dtype} weight, times "
          f"queued (the card's); kernel / F.rms_norm {kernel_ms / library_ms:.3f}; ragged "
          f"branch on the same rows one element in: max_abs_err={ragged_err:.3e} "
          f"tol={KERNEL_TOL} ms={ragged_ms:.4f}, wide / ragged {kernel_ms / ragged_ms:.3f}; "
          f"recorded in {time.perf_counter() - t0:.1f} s", flush=True)
    if not agrees(got_r, want, KERNEL_TOL):
        fail(f"{name}: rmsnorm's ragged branch disagrees with its plain version")
    out = {k: rows[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "library_ms")}
    return dict(out, ragged_max_abs_err=ragged_err, ragged_ms=ragged_ms)


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def decode_case(gen: torch.Generator, hkv: int, g: int, dh: int):
    """bf16 decode inputs at the serving path's positions: one query row
    of G heads per slot and KV head, the dense cache sliced to the attend
    bucket (a strided view), and other K/V through shuffled 16-token pages.
    Returns (q, k view, v view, k pages, v pages, block tables, pos)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(SLOTS, hkv, g, dh)
    kc, vc = randn(SLOTS, MAX_SEQ, hkv, dh), randn(SLOTS, MAX_SEQ, hkv, dh)
    nb = MAX_SEQ // PAGE_SIZE
    n_pages = SLOTS * nb + 1
    kp, vp = randn(n_pages, PAGE_SIZE, hkv, dh), randn(n_pages, PAGE_SIZE, hkv, dh)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = perm.reshape(SLOTS, nb).to(torch.int32)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
    return q, kc[:, :ATTEND], vc[:, :ATTEND], kp, vp, bt, pos


def check_kernels(cfg, gen: torch.Generator):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        decode_splits,
        flash_decode,
        paged_flash_decode,
    )
    from repro_torch.kernels.decode_attention.ref import (
        flash_decode_ref,
        paged_flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
    )
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.verify_attention.ops import paged_flash_verify, verify_splits
    from repro_torch.kernels.verify_attention.ref import paged_verify_attention_ref

    dev, bf = "cuda", torch.bfloat16
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = hq // hkv
    b, s = SLOTS, 512                              # a full prefill batch
    bs = 2                                         # bf16 bytes

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    rows = {}

    def record(name, source, replaces, got, want, *args, **kw):
        record_kernel(rows, name, source, replaces, got, want, KERNEL_TOL, *args, **kw)

    def check(name, got, want, tol):
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"kernel {name}: max_abs_err={err:.3e} tol={tol}", flush=True)
        if not agrees(got, want, tol):
            fail(f"{name} disagrees with its plain version beyond {tol}")

    def rmsnorm_row(name, x, w):
        """rmsnorm's row: kernel, plain version and F.rms_norm timed with
        their calls queued (the card's time); the kernel's host-paced time
        printed beside them"""
        fns = [lambda: rmsnorm(x, w, cfg.norm_eps), lambda: rmsnorm_ref(x, w, cfg.norm_eps),
               lambda: F.rms_norm(x, (d,), w, cfg.norm_eps)]
        got, want = fns[0](), fns[1]()
        torch.cuda.synchronize()
        print(f"kernel {name}: {tuple(x.shape)} rows, {w.dtype} weight; host-paced "
              f"ms={cuda_ms(fns[0]):.4f} (calls as the host launches them); the row's "
              f"times are the card's, the calls queued", flush=True)
        kernel_ms, plain_ms, library_ms = (cuda_ms(f, iters=100, queued=True) for f in fns)
        record(name, "src/repro_torch/kernels/rmsnorm/rmsnorm.cu",
               "src/repro/kernels/rmsnorm/rmsnorm.py:29", got, want, kernel_ms, plain_ms,
               2 * x.numel() * bs + d * w.element_size(), 4 * x.numel(), F32_FLOPS_S,
               library_ms)

    # training's rmsnorm: bf16 rows of one 2 x 4096 batch, fp32 weight
    rmsnorm_row("rmsnorm (training)", randn(TRAIN_BATCH * TRAIN_SEQ, d),
                torch.randn(d, generator=gen, device=dev))
    # rmsnorm: ln1/ln2 over a prefill batch of 4 x 512 rows
    rmsnorm_row("rmsnorm", randn(b * s, d), randn(d))

    # flash forward: causal prefill of 4 x 512 tokens, 12 q heads over 2 kv
    q, k, v = randn(b, s, hq, dh), randn(b, s, hkv, dh), randn(b, s, hkv, dh)
    (got, lse), (want, lse_ref) = (flash_attention_fwd(q, k, v),
                                   flash_attention_ref(q, k, v))
    torch.cuda.synchronize()
    lse_err = (lse - lse_ref).abs().max().item()
    if lse_err > 1e-3:
        fail(f"flash_attention_fwd lse differs from its plain version by {lse_err}")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    record("flash_attention_fwd",
           "src/repro_torch/kernels/flash_attention/flash_attention.cu",
           "src/repro/kernels/flash_attention/flash_attention.py:123", got, want,
           cuda_ms(lambda: flash_attention_fwd(q, k, v)),
           cuda_ms(lambda: flash_attention_ref(q, k, v)),
           (2 * q.numel() + 2 * k.numel()) * bs + b * hq * s * 4,
           4 * dh * b * hq * s * (s + 1) // 2, BF16_FLOPS_S,
           cuda_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True)),
           branch=FLASH_BRANCHES[q.dtype])
    check("flash_attention_fwd (the same o at FLASH_FWD_TOL)", got, want, FLASH_FWD_TOL)

    # flash forward and backward at one training layer call, B 2 x S 4096,
    # causal, 12 q heads over 2 kv; the backward's lse and o from the
    # forward kernel
    bt_, st_ = TRAIN_BATCH, TRAIN_SEQ
    qb, dob = randn(bt_, st_, hq, dh), randn(bt_, st_, hq, dh)
    kb, vb = randn(bt_, st_, hkv, dh), randn(bt_, st_, hkv, dh)
    ob, lseb = flash_attention_fwd(qb, kb, vb)
    ob_ref, lseb_ref = flash_attention_ref(qb, kb, vb)
    check("flash_attention_fwd lse (training)", lseb, lseb_ref, dict(atol=1e-3, rtol=0.0))
    qt, kt, vt = (a.transpose(1, 2) for a in (qb, kb, vb))
    pairs = bt_ * hq * st_ * (st_ + 1) // 2      # live (query, key) pairs
    record_kernel(rows, "flash_attention_fwd (training)",
                  "src/repro_torch/kernels/flash_attention/flash_attention.cu",
                  "src/repro/kernels/flash_attention/flash_attention.py:123", ob, ob_ref,
                  FLASH_FWD_TOL, cuda_ms(lambda: flash_attention_fwd(qb, kb, vb), iters=10),
                  cuda_ms(lambda: flash_attention_ref(qb, kb, vb), iters=3, warmup=1),
                  (2 * qb.numel() + 2 * kb.numel()) * bs + bt_ * hq * st_ * 4,
                  4 * dh * pairs, BF16_FLOPS_S,
                  cuda_ms(lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True, enable_gqa=True), iters=10),
                  branch=FLASH_BRANCHES[qb.dtype])
    flips = (ob != ob_ref).double().mean().item()
    print(f"kernel flash_attention_fwd (training): {flips:.4%} of the bf16 outputs "
          f"round to another value than the plain version's", flush=True)
    del ob_ref, lseb_ref
    delta = (dob.float() * ob.float()).sum(-1).transpose(1, 2).contiguous()
    bwd_args = (qb, kb, vb, dob, lseb, delta)
    got = torch.cat([t.flatten() for t in flash_attention_bwd(*bwd_args)])
    want = torch.cat([t.flatten() for t in flash_attention_bwd_ref(*bwd_args)])
    torch.cuda.synchronize()
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (qb, kb, vb))
    dot = dob.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    # the function's five products (s, dp, dq, dk, dv) of 2 * D flops per
    # live (query, key) pair
    row_bytes = 2 * bt_ * hq * st_ * 4                 # lse, delta
    record_kernel(rows, "flash_attention_bwd",
                  "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
                  "src/repro/kernels/flash_attention/flash_attention.py:306", got, want,
                  BWD_TOL, cuda_ms(lambda: flash_attention_bwd(*bwd_args), iters=20, warmup=2),
                  cuda_ms(lambda: flash_attention_bwd_ref(*bwd_args), iters=5, warmup=1),
                  (2 * qb.numel() + 2 * kb.numel()) * bs + row_bytes
                  + (qb.numel() + 2 * kb.numel()) * 4,
                  10 * dh * pairs, BF16_FLOPS_S,
                  cuda_ms(sdpa_fwd_bwd, iters=20, warmup=2) - cuda_ms(sdpa, iters=20, warmup=2),
                  branch=FLASH_BRANCHES[qb.dtype])
    del qb, dob, kb, vb, ob, lseb, delta, bwd_args, got, want, qt, kt, vt, dot

    # decode at the serving path's positions
    qd, kv_view, vv_view, kp, vp, bt, pos = decode_case(gen, hkv, g, dh)
    live = int((pos + 1).sum())
    got, want = flash_decode(qd, kv_view, vv_view, pos), flash_decode_ref(
        qd, kv_view, vv_view, pos)
    torch.cuda.synchronize()
    mask = (torch.arange(ATTEND, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    q4 = qd.reshape(b, 1, hq, dh).transpose(1, 2)
    dec_bytes = (2 * qd.numel() + 2 * live * hkv * dh) * bs
    dec_flops = 4 * dh * hq * live
    # the decode rows' times are the card's: the calls queued (DECODE_ITERS)
    sdpa_ms = queued_ms(lambda: F.scaled_dot_product_attention(
        q4, kv_view.transpose(1, 2), vv_view.transpose(1, 2), attn_mask=mask,
        enable_gqa=True))
    record("flash_decode", "src/repro_torch/kernels/decode_attention/decode_attention.cu",
           "src/repro/kernels/decode_attention/decode_attention.py:108", got, want,
           queued_ms(lambda: flash_decode(qd, kv_view, vv_view, pos)),
           queued_ms(lambda: flash_decode_ref(qd, kv_view, vv_view, pos)),
           dec_bytes, dec_flops, BF16_FLOPS_S, sdpa_ms)
    sdpa_factor("flash_decode", rows["flash_decode"]["ms"], sdpa_ms)

    # paged decode: the same positions through shuffled 16-token pages
    got = paged_flash_decode(qd, kp, vp, bt, pos)
    want = paged_flash_decode_ref(qd, kp, vp, bt, pos)
    torch.cuda.synchronize()
    tables = int((pos // PAGE_SIZE + 1).sum()) * 4
    record("paged_flash_decode",
           "src/repro_torch/kernels/decode_attention/decode_attention.cu",
           "src/repro/kernels/decode_attention/decode_attention.py:189", got, want,
           queued_ms(lambda: paged_flash_decode(qd, kp, vp, bt, pos)),
           queued_ms(lambda: paged_flash_decode_ref(qd, kp, vp, bt, pos)),
           dec_bytes + tables, dec_flops, BF16_FLOPS_S, None)
    sdpa_factor("paged_flash_decode", rows["paged_flash_decode"]["ms"], sdpa_ms)

    # paged verify: a spec_k = 4 window at the same positions, T*G = 24
    # query rows per KV head; keys up to pos + T - 1.  No single PyTorch
    # call reads paged K/V, so no library time; SDPA on the dense view of
    # the same slots with the window's causal mask is printed for scale.
    t_w = SPEC_K
    qv = randn(b, hkv, t_w * g, dh)
    got = paged_flash_verify(qv, kp, vp, bt, pos, t_window=t_w)
    want = paged_verify_attention_ref(qv, kp, vp, bt, pos, t_w)
    torch.cuda.synchronize()
    keys = pos.long() + t_w                            # keys read per row
    ver_bytes = ((2 * qv.numel() + 2 * int(keys.sum()) * hkv * dh) * bs
                 + int(((keys - 1) // PAGE_SIZE + 1).sum()) * 4)
    # row t of the window scores pos + t + 1 keys, for each of hq heads
    ver_flops = 4 * dh * hq * sum(int(p) + t + 1 for p in pos.tolist()
                                  for t in range(t_w))
    record("paged_flash_verify",
           "src/repro_torch/kernels/verify_attention/verify_attention.cu",
           "src/repro/kernels/verify_attention/verify_attention.py:118", got, want,
           queued_ms(lambda: paged_flash_verify(qv, kp, vp, bt, pos, t_window=t_w)),
           queued_ms(lambda: paged_verify_attention_ref(qv, kp, vp, bt, pos, t_w)),
           ver_bytes, ver_flops, BF16_FLOPS_S, None)
    qs = qv.reshape(b, hkv, t_w, g, dh).transpose(2, 3).reshape(b, hq, t_w, dh)
    win_mask = (torch.arange(ATTEND, device=dev)[None, None, :]
                <= (pos[:, None] + torch.arange(t_w, device=dev)[None, :])[:, :, None])
    win_mask = win_mask[:, None].expand(b, hq, t_w, ATTEND)
    verify_sdpa_ms = queued_ms(lambda: F.scaled_dot_product_attention(
        qs, kv_view.transpose(1, 2), vv_view.transpose(1, 2), attn_mask=win_mask,
        enable_gqa=True))
    sdpa_factor("paged_flash_verify", rows["paged_flash_verify"]["ms"], verify_sdpa_ms)
    n_keys_max = bt.shape[1] * PAGE_SIZE
    print(f"kernel paged_flash_verify: library_ms none (no single PyTorch call "
          f"reads paged K/V); splits {verify_splits(b, hkv, t_w * g, t_w, n_keys_max)} "
          f"at T={t_w}, {verify_splits(b, hkv, g, 1, n_keys_max)} at T=1 (paged decode's "
          f"{decode_splits(b, hkv, n_keys_max)})", flush=True)

    # T = 1 verify is one-token paged decode: the two kernels in f32
    q1 = torch.randn(b, hkv, g, dh, generator=gen, device=dev)
    kpf, vpf = kp.float(), vp.float()
    t1 = paged_flash_verify(q1, kpf, vpf, bt, pos, t_window=1)
    d1 = paged_flash_decode(q1, kpf, vpf, bt, pos)
    torch.cuda.synchronize()
    t1_err = max_err(t1, d1)
    print(f"kernel paged_flash_verify T=1 vs paged_flash_decode (f32): "
          f"max_abs_err={t1_err:.3e} tol={T1_TOL} bit for bit: {torch.equal(t1, d1)}",
          flush=True)
    if not t1_err <= T1_TOL:
        fail(f"T = 1 verify differs from paged decode by {t1_err:.3e}")
    int8 = check_int8_kernels(rows, qd, qv, q1, kp, vp, bt, pos)
    return rows, t1_err, int8


def check_int8_kernels(rows, qd, qv, q1, kp, vp, bt, pos) -> dict:
    """The int8 branches of the two paged kernels at the serving shapes
    (the same positions, tables and query rows as the bf16 rows): the
    pages quantized on the card, whose bytes must equal the CPU's for the
    same f32 rows; each kernel against its plain version (bf16 q within
    KERNEL_TOL, f32 q within INT8_F32_TOL) and against the float kernel
    on the dequantized pages."""
    from repro_torch.kernels.decode_attention.ops import paged_flash_decode
    from repro_torch.kernels.decode_attention.ref import paged_flash_decode_ref
    from repro_torch.kernels.verify_attention.ops import paged_flash_verify
    from repro_torch.kernels.verify_attention.ref import paged_verify_attention_ref
    from repro_torch.serve.kv_cache import dequantize_kv, quantize_kv_rows

    kq, ks = quantize_kv_rows(kp.float())
    vq, vs = quantize_kv_rows(vp.float())
    torch.cuda.synchronize()

    def bits(t):     # scales compared by their bit patterns
        return t.cpu().view(torch.int32) if t.dtype == torch.float32 else t.cpu()

    cpu = (*quantize_kv_rows(kp.float().cpu()), *quantize_kv_rows(vp.float().cpu()))
    same = all(torch.equal(bits(a), bits(b)) for a, b in zip((kq, ks, vq, vs), cpu))
    print(f"kernel int8 pages: {kq.shape[0]} pages quantized on the card store the "
          f"CPU's bytes: {same}", flush=True)
    if not same:
        fail("int8 pages quantized on the card differ from the CPU's bytes")
    sc = dict(k_scales=ks, v_scales=vs)
    kf, vf = dequantize_kv(kq, ks), dequantize_kv(vq, vs)
    hkv, dh = kp.shape[2], kp.shape[3]
    t_w = qv.shape[2] // qd.shape[2]
    live = int((pos + 1).sum())
    keys = pos.long() + t_w
    bs = 2

    def kv_bytes(n_rows, n_blocks):
        # int8 values, one f32 scale per row, for K and V; the table entries
        return 2 * n_rows * (hkv * dh + 4) + n_blocks * 4

    out = {}
    for name, fn, ref, q, extra, n_bytes, flops, replaces in (
            ("paged_flash_decode[int8]", paged_flash_decode, paged_flash_decode_ref,
             qd, {}, 2 * qd.numel() * bs + kv_bytes(live, int((pos // PAGE_SIZE + 1).sum())),
             4 * dh * qd.shape[1] * qd.shape[2] * live,
             "src/repro/kernels/decode_attention/decode_attention.py:189"),
            ("paged_flash_verify[int8]", paged_flash_verify, paged_verify_attention_ref,
             qv, {"t_window": t_w},
             2 * qv.numel() * bs + kv_bytes(int(keys.sum()),
                                            int(((keys - 1) // PAGE_SIZE + 1).sum())),
             4 * dh * qd.shape[1] * qd.shape[2] * sum(int(p) + t + 1 for p in pos.tolist()
                                                      for t in range(t_w)),
             "src/repro/kernels/verify_attention/verify_attention.py:118")):
        got = fn(q, kq, vq, bt, pos, **extra, **sc)
        want = ref(q, kq, vq, bt, pos, **extra, **sc)
        source = ("src/repro_torch/kernels/decode_attention/decode_attention.cu"
                  if "decode" in name else
                  "src/repro_torch/kernels/verify_attention/verify_attention.cu")
        # the calls queued (the card's time)
        record_kernel(rows, name, source, replaces, got, want, KERNEL_TOL,
                      queued_ms(lambda: fn(q, kq, vq, bt, pos, **extra, **sc)),
                      queued_ms(lambda: ref(q, kq, vq, bt, pos, **extra, **sc)),
                      n_bytes, flops, BF16_FLOPS_S, None)
        print(f"kernel {name}: library_ms none (no PyTorch call reads int8 paged "
              f"K/V)", flush=True)
        # f32 q: the same arithmetic as the plain version's dequantized f32
        qf = q1 if "decode" in name else qv.float()
        checks = {
            "f32 q vs plain": (fn(qf, kq, vq, bt, pos, **extra, **sc),
                               ref(qf, kq, vq, bt, pos, **extra, **sc), INT8_F32_TOL),
            "f32 q vs the f32 kernel on the dequantized pages": (
                fn(qf, kq, vq, bt, pos, **extra, **sc),
                fn(qf, kf, vf, bt, pos, **extra), INT8_F32_TOL),
            "bf16 q vs the bf16 kernel on the dequantized pages": (
                got, fn(q, kf.to(q.dtype), vf.to(q.dtype), bt, pos, **extra),
                KERNEL_TOL)}
        out[name] = {}
        for label, (a, b, tol) in checks.items():
            torch.cuda.synchronize()
            err = max_err(a, b)
            print(f"kernel {name} {label}: max_abs_err={err:.3e} tol={tol}", flush=True)
            if not agrees(a, b, tol):
                fail(f"{name} ({label}) disagrees beyond {tol}")
            out[name][label] = err
    return out


def check_warp_kernels(gen: torch.Generator) -> dict:
    """The warp-feature kernels against their plain versions at sizes where
    launch latency does not dominate: (2^20, 32) lane blocks (128 MiB),
    2^25 mse elements, a 2048^3 f32 product; plus one width-128 case of
    each lane kernel, which takes the cross-warp shared-memory step.  The
    sweep over modes, dtypes, widths and ragged shapes is
    tests/test_torch_kernels_cuda.py's."""
    import torch.nn.functional as F

    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.mse.ops import mse_partial_sum
    from repro_torch.kernels.mse.ref import mse_partial_sum_ref
    from repro_torch.kernels.tile_reduce.ops import tile_reduce
    from repro_torch.kernels.tile_reduce.ref import tile_reduce_ref
    from repro_torch.kernels.warp_ops.ops import shfl, vote
    from repro_torch.kernels.warp_ops.ref import shfl_ref, shfl_src, vote_ref

    dev, rows = "cuda", {}
    n, w = 2 ** 20, 32
    x = torch.randn(n, w, generator=gen, device=dev)
    x128 = torch.randn(n // 4, 128, generator=gen, device=dev)
    block_bytes = 2 * x.numel() * 4            # read once, write once

    def check(name, got, want, tol="exact"):
        torch.cuda.synchronize()
        if not agrees(got, want, tol):
            fail(f"{name} disagrees with its plain version ({tol}), "
                 f"max_abs_err {max_err(got, want):.3e}")

    # shfl: Fig. 5's butterfly, bfly 16 timed at width 32
    check("shfl bfly 64 width 128", shfl(x128, "bfly", 64), shfl_ref(x128, "bfly", 64))
    src = shfl_src("bfly", w, 16, dev).expand(n, w)
    record_kernel(rows, "shfl", "src/repro_torch/kernels/warp_ops/warp_ops.cu",
                  "src/repro/kernels/warp_ops/warp_ops.py:90",
                  shfl(x, "bfly", 16), shfl_ref(x, "bfly", 16), "exact",
                  cuda_ms(lambda: shfl(x, "bfly", 16)),
                  cuda_ms(lambda: shfl_ref(x, "bfly", 16)),
                  block_bytes, 0, F32_FLOPS_S,
                  cuda_ms(lambda: torch.gather(x, 1, src)))

    # vote: Fig. 5's "any" without a mask timed; half the rows unanimous
    pred = (x > 0).to(torch.int32)
    pred[: n // 2] = 1
    p128 = (x128 > 0).to(torch.int32)
    p128[: n // 8] = 1
    check("vote uni width 128", vote(p128, "uni"), vote_ref(p128, "uni"))
    record_kernel(rows, "vote", "src/repro_torch/kernels/warp_ops/warp_ops.cu",
                  "src/repro/kernels/warp_ops/warp_ops.py:110",
                  vote(pred, "any"), vote_ref(pred, "any"), "exact",
                  cuda_ms(lambda: vote(pred, "any")),
                  cuda_ms(lambda: vote_ref(pred, "any")),
                  block_bytes, 0, F32_FLOPS_S,
                  cuda_ms(lambda: torch.any(pred, dim=1)))

    # tile_reduce: Fig. 5's reduce, an 8-lane f32 sum, timed; tile 128
    # takes the shared-memory steps.  The library call writes one value
    # per tile, 1/8 of the kernel's output bytes.
    check("tile_reduce sum tile 128", tile_reduce(x128, 128), tile_reduce_ref(x128, 128))
    record_kernel(rows, "tile_reduce", "src/repro_torch/kernels/tile_reduce/tile_reduce.cu",
                  "src/repro/kernels/tile_reduce/tile_reduce.py:43",
                  tile_reduce(x, 8), tile_reduce_ref(x, 8), "exact",
                  cuda_ms(lambda: tile_reduce(x, 8)),
                  cuda_ms(lambda: tile_reduce_ref(x, 8)),
                  block_bytes, 3 * x.numel(), F32_FLOPS_S,
                  cuda_ms(lambda: x.view(n, -1, 8).sum(-1)))

    # mse: f32 atomics in no fixed order, so a relative tolerance; 2^16
    # elements give each thread one, 2^25 (timed) a grid-stride run of 124
    p, t = (torch.randn(2 ** 16, generator=gen, device=dev) for _ in "pt")
    check("mse_partial_sum 2^16", mse_partial_sum(p, t), mse_partial_sum_ref(p, t), MSE_TOL)
    m = 2 ** 25
    p, t = (torch.randn(m, generator=gen, device=dev) for _ in "pt")
    record_kernel(rows, "mse_partial_sum", "src/repro_torch/kernels/mse/mse.cu",
                  "src/repro/kernels/mse/mse.py:45",
                  mse_partial_sum(p, t), mse_partial_sum_ref(p, t), MSE_TOL,
                  cuda_ms(lambda: mse_partial_sum(p, t)),
                  cuda_ms(lambda: mse_partial_sum_ref(p, t)),
                  2 * m * 4 + 4, 3 * m, F32_FLOPS_S,
                  cuda_ms(lambda: F.mse_loss(p, t, reduction="sum")))

    # matmul: 2048^3 in f32 (3xTF32 on the tensor cores) against cuBLAS in
    # full f32.  An f32-accurate product has two ways through the card, 2MNK
    # on the f32 CUDA cores or three TF32 products on the tensor cores: the
    # row's bound is the smaller of the two, and both are printed
    torch.backends.cuda.matmul.allow_tf32 = False
    d = 2048
    a, b = (torch.randn(d, d, generator=gen, device=dev) for _ in "ab")
    mm_bytes, mm_flops = 3 * d * d * 4, 2 * d ** 3
    ways = {"f32 CUDA cores": (mm_flops, F32_FLOPS_S),
            "3xTF32 tensor cores": (3 * mm_flops, TF32_FLOPS_S)}
    bounds = {way: bound(mm_bytes, *fp)[0] for way, fp in ways.items()}
    way = min(bounds, key=bounds.get)
    print("kernel matmul: bound candidates " + "; ".join(
        f"{w} {ms:.4f} ms" for w, ms in bounds.items()) + f"; the row takes {way}",
        flush=True)
    record_kernel(rows, "matmul", "src/repro_torch/kernels/matmul/matmul.cu",
                  "src/repro/kernels/matmul/matmul.py:39",
                  matmul(a, b), matmul_ref(a, b), MATMUL_TOL,
                  cuda_ms(lambda: matmul(a, b)), cuda_ms(lambda: matmul_ref(a, b)),
                  mm_bytes, *ways[way], cuda_ms(lambda: torch.matmul(a, b)))
    MATMUL_READINGS["f32 bound candidates ms"] = bounds

    # the bf16 branch at 2048^3 beside torch.matmul in bf16 (Fig. 5 runs
    # f32 only, so this branch has no row of its own)
    ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got, want = matmul(ah, bh), matmul_ref(ah, bh)
    check("matmul bf16 2048^3", got, want, KERNEL_TOL)
    r = dict(max_abs_err=max_err(got, want), ms=cuda_ms(lambda: matmul(ah, bh)),
             plain_ms=cuda_ms(lambda: matmul_ref(ah, bh)),
             bound_ms=bound(3 * d * d * 2, mm_flops, BF16_FLOPS_S)[0],
             library_ms=cuda_ms(lambda: torch.matmul(ah, bh)))
    print(f"kernel matmul bf16 2048^3: max_abs_err={r['max_abs_err']:.3e} tol={KERNEL_TOL} "
          f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
          f"(operations) library_ms={r['library_ms']:.4f}", flush=True)
    MATMUL_READINGS["bf16 2048^3"] = r
    return rows


# ---------------------------------------------------------------------------
# phase 1b: the paper's main path — Fig. 5 through the warp kernels
# ---------------------------------------------------------------------------

def run_fig5(seed: int):
    """Fig. 5 at the reference's size (8192 blocks of WarpConfig(8, 4),
    matmul 64 x 64): HW through the warp-intrinsic kernels, SW through the
    PR-transformation lane loops.  Returns the rows and the launch counts
    of the run."""
    from repro_torch import kernels
    from repro_torch.bench import fig5_microbench as fig5

    torch.cuda.synchronize()
    kernels.reset_launches()
    rows = fig5.run(seed=seed, device="cuda")     # raises if HW != SW
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for line in fig5.format_rows(rows):
        print(f"fig5 {line}", flush=True)
    print(f"fig5 launches {counts}", flush=True)
    for name in WARP_KERNELS:
        if counts[name] == 0:
            fail(f"{name} never launched in the Fig. 5 run")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 1c: the paper's §IV pass — whole thread programs on the warp kernels
# ---------------------------------------------------------------------------

def run_pr_transform(seed: int) -> dict:
    """The PR transformation's programs (``bench/pr_transform_bench.py``)
    at WarpConfig(8, 4) and (32, 32) through the ``kernel``, ``hw`` and
    ``sw`` executors of ``core.pr_transform``: kernel == hw bit for bit
    (f32 sums within rtol 1e-6), sw == hw (f32 sums within 1e-5), the
    out-of-range store and the region carry each path against the same
    path on the CPU, Fig. 3's transform report; it fails on any gate and
    unless the kernel lowering launched shfl, vote and tile_reduce.  Then
    each lowering's event-timed ms and profiled device time and kernels a
    call, and SW/HW against ``kernel``."""
    from repro_torch import kernels
    from repro_torch.bench import pr_transform_bench as prb

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    try:
        inputs = prb.check_all(seed, "cuda")
    except AssertionError as exc:
        fail(f"pr_transform: {exc}")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches = {name: counts[name] for name in PR_KERNELS}
    print(f"pr_transform gates held: {len(prb.CASES)} programs at "
          f"{', '.join(prb.block_name(w) for w in prb.BLOCKS)}; fig3 report "
          f"{prb.FIG3_REPORT}; kernel lowering launches {launches}", flush=True)
    for name in PR_KERNELS:
        if launches[name] == 0:
            fail(f"the PR pass's kernel lowering never launched {name}")
    rows = prb.time_all(inputs)
    for r in rows:
        print(f"pr_transform {prb.format_row(r)}", flush=True)
    geo = {}
    for block in (prb.block_name(w) for w in prb.BLOCKS):
        ratios = [r["sw_over_kernel"] for r in rows if r["block"] == block]
        geo[block] = float(np.exp(np.mean(np.log(ratios))))
    wall = time.perf_counter() - t0
    print("pr_transform SW/HW geomean (event ms, sw over kernel): "
          + "; ".join(f"{b} {g:.2f}" for b, g in geo.items())
          + f"; the phase took {wall:.1f} s", flush=True)
    return dict(rows=rows, launches=launches, geomean_sw_over_kernel=geo, phase_s=wall)


def run_table4(ptxas: dict) -> dict:
    """The Table IV analogue (``bench/table4_overhead.py``) on the card:
    ATen ops and kernels of the RMSNorm site and a reduced qwen2
    forward in each reduction form, and the HW kernels' registers and
    shared memory from this run's ptxas report."""
    from repro_torch.bench import table4_overhead as t4

    r = t4.run("cuda", ptxas=ptxas)
    for line in t4.format_lines(r):
        print(f"table4 {line}", flush=True)
    if not r["footprint"]:
        fail("table4: ptxas reported none of the HW warp kernels")
    return r


# ---------------------------------------------------------------------------
# phase 2: the main path — serve on both layouts
# ---------------------------------------------------------------------------

def make_requests(seed: int, vocab: int):
    """(uid, prompt, max_new_tokens) for 8 requests of 64-512 tokens."""
    rng = np.random.default_rng(seed)
    lens = [512] + rng.integers(64, 513, 7).tolist()   # the longest goes first
    return [(i, rng.integers(0, vocab, n).tolist(), MAX_NEW)
            for i, n in enumerate(lens)]


def serve(model, params, spec, warm: bool = False, **kw):
    """Serve ``spec`` on a fresh engine (pipelined, the engine's default,
    unless ``pipeline=False``) and time it; ``warm`` first runs one
    untimed session of the same requests on the engine, which captures
    every step graph the timed session replays (its graph stats are kept
    in ``eng.warm_graph_stats``).  The launch counts are the timed
    session's, replays included; ``eng.peak_bytes`` is the engine's peak
    device memory: the most allocated over its sessions (its device state,
    graph pool and the steps' transients) above what was allocated
    before it was built."""
    from repro_torch import kernels
    from repro_torch.serve.engine import Request, ServeEngine

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS, **kw)
    eng.warm_graph_stats = None
    if warm:
        eng.serve([Request(u, list(p), n) for u, p, n in spec])
        eng.warm_graph_stats = dict(eng.last_graph_stats)
    reqs = [Request(u, list(p), n) for u, p, n in spec]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    eng.base_bytes = base
    eng.peak_bytes = torch.cuda.max_memory_allocated() - base
    no_ragged_rmsnorm("a serving run", counts)
    fault_free("a serving run", eng)
    for u, _, n in spec:
        s = eng.last_stats[u]
        if s["status"] != "ok" or s["tokens"] != n or len(out.get(u, [])) != n:
            fail(f"request {u}: status {s['status']}, {s.get('tokens')} of {n} tokens")
    n_tok = sum(len(v) for v in out.values())
    return out, eng, counts, wall, n_tok


def no_ragged_rmsnorm(label: str, counts: dict):
    """Every serving, MoE and training run normalizes whole 16-byte rows
    of at most 8192 (the warp or the wide branch): rmsnorm's block-per-row
    ragged branch must not have launched."""
    if counts["rmsnorm[ragged]"]:
        fail(f"{label} launched rmsnorm's ragged branch "
             f"{counts['rmsnorm[ragged]']} times")


def add_counts(a: dict, b: dict) -> dict:
    return {n: a[n] + b[n] for n in a}


F32_FLASH = ("flash_attention_fwd[f32]", "flash_attention_bwd[f32]",
             "flash_attention_fwd[dv,f32]", "flash_attention_bwd[dv,f32]",
             "flash_attention_fwd[d80,f32]", "flash_attention_bwd[d80,f32]")
BF16_FLASH = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_fwd[dv]",
              "flash_attention_bwd[dv]", "flash_attention_fwd[d80]", "flash_attention_bwd[d80]")


def flash_branch_launches(bf16_runs: dict, fp32_runs: dict):
    """The flash kernels' dtype branches apart: the bf16 runs (whose counts
    fill the kernel rows) must launch no f32 flash kernel, and the fp32
    controls no bf16 one.  Prints the controls' f32 launches."""
    for label, c in bf16_runs.items():
        if any(c[n] for n in F32_FLASH):
            fail(f"{label} (bf16) launched the flash kernels' f32 branch: "
                 f"{ {n: c[n] for n in F32_FLASH} }")
    for label, c in fp32_runs.items():
        if any(c[n] for n in BF16_FLASH) or not c[F32_FLASH[0]]:
            fail(f"{label} launched the flash kernels' bf16 branch or no f32 "
                 f"forward: { {n: c[n] for n in BF16_FLASH + F32_FLASH} }")
    f32 = {label: c[F32_FLASH[0]] for label, c in fp32_runs.items()}
    print(f"flash_attention_fwd[f32] (CUDA cores) launches in the fp32 controls, "
          f"kept out of the bf16 kernel rows: {f32}; total {sum(f32.values())}",
          flush=True)


def layout_agreement(label, dense, paged, eng):
    """Token agreement of a paged run with the dense run: overall, per
    request, and which requests the paged run preempted; prints the line."""
    agree = float(np.mean([a == b for u in dense for a, b in zip(dense[u], paged[u])]))
    per_req = {u: float(np.mean([a == b for a, b in zip(dense[u], paged[u])]))
               for u in dense}
    preempted = [u for u in dense if eng.last_stats[u]["preemptions"]]
    print(f"{label}: {agree:.4f}; per request {per_req}; preempted {preempted}",
          flush=True)
    return agree, per_req, preempted


# the kernels each captured step must launch, by the engine's step kind
STEP_KERNELS = {"dense": ("rmsnorm", "flash_decode"),
                "paged": ("rmsnorm", "paged_flash_decode"),
                "paged_int8": ("rmsnorm", "paged_flash_decode[int8]"),
                "spec": ("rmsnorm", "flash_decode", "paged_flash_verify"),
                "spec_int8": ("rmsnorm", "flash_decode", "paged_flash_verify[int8]"),
                "moe": ("rmsnorm", "flash_decode", "moe_gating")}
# serial (eager) beside pipelined (captured) runs of one call, by label
PIPELINE_PAIRS = {}


def captured_kernels(label: str, eng, names):
    """Fail unless the pipelined engine replayed captured steps and each
    of its graphs launches every kernel of ``names`` (its launches a
    replay, read at capture), and unless those replays were counted."""
    g = eng.last_graph_stats
    per = g["launches_per_replay"]
    if not g["enabled"] or not per or g["replays"] == 0:
        fail(f"{label}: the pipelined run replayed no captured step: {g}")
    for key, d in per.items():
        missing = [n for n in names if d.get(n, 0) == 0]
        if missing:
            fail(f"{label}: the captured step {key} launches none of {missing}: {d}")


def pipeline_pair(label, piped, serial, names, gate: bool) -> dict:
    """A pipelined run (captured steps, queued swap copies) beside the
    serial, eager run of the same call (``serve``'s tuples): tok/s of
    both, the graphs' count and capture seconds (the warm session's, where
    it ran one), replays, peak memory of both, preemptions and the token
    agreement, which fails the run when ``gate`` (the fp32 controls, and
    bf16 where the replay probe showed the captured step bit for bit the
    eager one) is below 1.  Prints two lines, keeps the record."""
    p_out, p_eng, _, p_wall, p_tok = piped
    s_out, s_eng, _, s_wall, s_tok = serial
    captured_kernels(label, p_eng, names)
    if s_eng.last_graph_stats["replays"]:
        fail(f"{label}: the serial control replayed captured steps")
    g = p_eng.warm_graph_stats or p_eng.last_graph_stats
    agree = agreement(s_out, p_out)
    ts = {k: p_eng.last_stats["timeseries"][k] for k in ("dispatch_s", "commit_s", "overlap_s")}
    rec = dict(serial_tok_s=s_tok / s_wall, pipelined_tok_s=p_tok / p_wall,
               ratio=(p_tok / p_wall) / (s_tok / s_wall), graphs=g["graphs"],
               capture_s=g["capture_s"], warmed=p_eng.warm_graph_stats is not None,
               replays=p_eng.last_graph_stats["replays"],
               captured_in_timed_session=p_eng.last_graph_stats["captured"],
               serial_peak_gib=s_eng.peak_bytes / 2 ** 30,
               pipelined_peak_gib=p_eng.peak_bytes / 2 ** 30,
               serial_preemptions=s_eng.preemptions, pipelined_preemptions=p_eng.preemptions,
               token_agreement=agree, gated=gate,
               pipelined_phase_s={k: float(sum(v)) for k, v in ts.items()},
               launches_per_replay=p_eng.last_graph_stats["launches_per_replay"])
    print(f"pipeline {label}: serial {rec['serial_tok_s']:.1f} tok/s, pipelined "
          f"{rec['pipelined_tok_s']:.1f} tok/s ({rec['ratio']:.2f}x); token agreement "
          f"{agree:.4f} ({'gated' if gate else 'reported'}); preemptions serial "
          f"{s_eng.preemptions}, pipelined {p_eng.preemptions}; the engine's peak memory "
          f"serial {rec['serial_peak_gib']:.3f} GiB, pipelined "
          f"{rec['pipelined_peak_gib']:.3f} GiB; "
          f"pipelined host phases {rec['pipelined_phase_s']}", flush=True)
    print(f"graphs {label}: {g['graphs']} captured in {g['capture_s']:.3f} s"
          f"{' (the warm session)' if rec['warmed'] else ''}; {rec['replays']} replays "
          f"and {rec['captured_in_timed_session']} captures in the timed session",
          flush=True)
    if gate and (agree < 1.0 or s_eng.preemptions != p_eng.preemptions):
        fail(f"{label}: the pipelined run served other tokens or preemptions than "
             "the serial one")
    PIPELINE_PAIRS[label] = rec
    return rec


def step_state(model, params, kind: str, gen: torch.Generator, draft=None,
               sampler=None, masks=None) -> dict:
    """One engine step's fixed buffers at the decode profile's shape
    (SLOTS rows at DECODE_POS, attend ATTEND; random cache rows, int8
    pools quantized on the card, each slot's pages in its own table row)
    and its closure, as the engine builds it (``serve/step_graph.py``,
    ``spec_decode.build_spec_step``; ``draft`` = (model, params) for the
    spec kinds; ``sampler`` the engine's sampled-step draw, None greedy;
    ``masks`` the engine's (2, SLOTS) fault-mask buffer, which a decode
    step then reads, as the engine's do).  ``reset()`` puts tok / pos /
    remaining back."""
    from repro_torch.serve import spec_decode, step_graph
    from repro_torch.serve.kv_cache import quantize_kv_rows

    spec_k = SPEC_K if kind.startswith("spec") else 1
    i32 = dict(dtype=torch.int32, device="cuda")
    st = dict(tok=torch.randint(0, model.cfg.vocab, (SLOTS,), generator=gen, **i32),
              pos=torch.tensor(DECODE_POS, **i32),
              remaining=torch.full((SLOTS,), MAX_NEW, **i32),
              out=torch.zeros(3 + spec_k, SLOTS, **i32),
              uids=torch.arange(SLOTS, **i32))
    saved = [st[k].clone() for k in ("tok", "pos", "remaining")]
    st["reset"] = lambda: [st[k].copy_(v) for k, v in zip(("tok", "pos", "remaining"), saved)]
    st["restore"] = (st["tok"], st["pos"], st["remaining"])
    if kind in ("dense", "moe"):
        cache = model.init_cache(SLOTS, MAX_SEQ)
    else:
        cache = model.init_cache(SLOTS, MAX_SEQ, layout="paged", page_size=PAGE_SIZE,
                                 kv_dtype="int8" if kind.endswith("int8") else None)
        nb = cache["block_tables"].shape[1]
        cache["block_tables"].copy_(torch.arange(1, SLOTS * nb + 1, **i32).reshape(SLOTS, nb))
    for name in [n for n in cache if n in ("k", "v", "k_pages", "v_pages", "latent", "rope",
                                           "attn_k", "attn_v")]:
        rows = torch.randn(cache[name].shape, generator=gen, device="cuda")
        if cache[name].dtype == torch.int8:
            q, scale = quantize_kv_rows(rows)
            cache[name].copy_(q)
            cache[name[0] + "_scales"].copy_(scale)
        else:
            cache[name].copy_(rows)
    st["cache"] = cache
    if spec_k == 1:
        st["fn"] = step_graph.decode_step_fn(model, params, cache, st["tok"], st["pos"],
                                             st["remaining"], st["out"], ATTEND, MAX_SEQ,
                                             uids=st["uids"], sampler=sampler,
                                             nan_mask=None if masks is None else masks[0])
        return st
    dmodel, dparams = draft
    dcache = dmodel.init_cache(SLOTS, MAX_SEQ)
    for leaf in dcache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    st["draft_cache"] = dcache
    step = spec_decode.build_spec_step(model, dmodel, max_seq=MAX_SEQ, spec_k=spec_k,
                                       sampler=sampler)
    pool = {k: v for k, v in cache.items() if k != "block_tables"}
    mask = torch.ones(SLOTS, dtype=torch.bool, device="cuda")
    st["fn"] = lambda: step(params, dparams, pool, dcache, cache["block_tables"], st["tok"],
                            st["pos"], st["remaining"], st["uids"], mask, ATTEND, st["out"])
    return st


def replay_probe(model, params, kind: str, gen: torch.Generator, draft=None,
                 sampler=None) -> dict:
    """The captured step against the same step eager, from equal states
    (one seed, two draws): whether the logits, the output buffer and every
    cache leaf the step wrote are bit for bit equal, and the largest logit
    difference.  Where they are, nothing in the capture (cuBLAS's pick
    under capture, the programmatic combine launch as a graph edge)
    changes the step, so a bf16 serial / pipelined pair must agree on
    every token."""
    from repro_torch.serve.step_graph import StepGraphs

    seed = int(torch.randint(0, 2 ** 31, (1,), generator=gen, device="cuda").item())
    a = step_state(model, params, kind, torch.Generator(device="cuda").manual_seed(seed),
                   draft, sampler)
    b = step_state(model, params, kind, torch.Generator(device="cuda").manual_seed(seed),
                   draft, sampler)
    graphs = StepGraphs("cuda", enabled=True)
    want = a["fn"]()
    got = graphs.run((kind, ATTEND), b["fn"], restore=b["restore"])
    torch.cuda.synchronize()
    leaves = [(n, a["cache"][n], b["cache"][n]) for n in a["cache"]]
    leaves += [(f"draft {n}", a["draft_cache"][n], b["draft_cache"][n])
               for n in a.get("draft_cache", {})]
    rec = dict(logits_equal=bool(torch.equal(got, want)),
               max_logit_diff=(got - want).abs().max().item(),
               out_equal=bool(torch.equal(a["out"], b["out"])),
               cache_equal={n: bool(torch.equal(x, y)) for n, x, y in leaves})
    rec["bit_for_bit"] = (rec["logits_equal"] and rec["out_equal"]
                          and all(rec["cache_equal"].values()))
    label = kind if sampler is None else f"{kind} sampled"
    print(f"replay probe {label} ({model.dtype}): captured vs eager step bit for bit "
          f"{rec['bit_for_bit']}; logits max diff {rec['max_logit_diff']:.3e}; "
          f"output equal {rec['out_equal']}; cache leaves unequal "
          f"{[n for n, e in rec['cache_equal'].items() if not e]}", flush=True)
    del a, b, graphs
    return rec


def prefilled(model, params, prompt, layout="dense", kv_dtype=None):
    """One request's prompt prefilled, batch 1: (logits, cache), the dense
    cache or a paged pool (of ``kv_dtype``) whose block table maps the
    logical blocks to pages 1, 2, ... in order."""
    from repro_torch.serve.kv_cache import scatter_prefill

    toks = torch.tensor([prompt], device="cuda")
    if layout == "dense":
        return model.prefill(params, toks, MAX_SEQ)
    cache = model.init_cache(1, MAX_SEQ, layout="paged", page_size=PAGE_SIZE,
                             kv_dtype=kv_dtype)
    nb = cache["block_tables"].shape[1]
    cache["block_tables"][0] = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    logits, pcache = model.prefill(params, toks, len(prompt))
    scatter_prefill(cache, pcache, cache["block_tables"][:, :-(-len(prompt) // PAGE_SIZE)])
    return logits, cache


def teacher_force(model, params, prompt, tokens, kv_dtype=None):
    """Logits of ``model`` for one request (prefill, then decode on the
    served ``tokens``), batch 1: one row per generated position.  With
    ``kv_dtype`` the decode steps read a paged pool of that dtype."""
    logits, cache = prefilled(model, params, prompt,
                              "dense" if kv_dtype is None else "paged", kv_dtype)
    steps = [logits[0]]
    for t, tok in enumerate(tokens[:-1]):
        pos = torch.tensor([len(prompt) + t], dtype=torch.int32, device="cuda")
        attend = min(MAX_SEQ, -(-(len(prompt) + t + 1) // 64) * 64)
        logits, cache = model.decode_step(params, cache,
                                          torch.tensor([tok], device="cuda"), pos,
                                          attend_len=attend)
        steps.append(logits[0])
    return torch.stack(steps)


def compare_logits(label, got, want):
    """Max |logit| error per step against LOGIT_TOL of the step's logit
    scale, and argmax agreement; returns (max err, scale, agreement)."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"non-finite logits in the teacher-forced {label} run")
    err = (got - want).abs().max(dim=-1).values
    scale = want.abs().max(dim=-1).values
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"teacher-forced {label}: {got.shape[0]} steps, max |logit err| "
          f"{err.max().item():.4e} (logit scale {scale.max().item():.4e}, worst "
          f"step ratio {(err / scale).max().item():.4e}); argmax agreement "
          f"{agree:.4f}", flush=True)
    if (err > LOGIT_TOL * scale).any():
        fail(f"{label} logits differ from the kernel path's by more than "
             f"{LOGIT_TOL} of the logit scale")
    return err.max().item(), scale.max().item(), agree


# ---------------------------------------------------------------------------
# phase 3: speculative serving through the verify kernel
# ---------------------------------------------------------------------------

def _scaled(tree, factor: float):
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    return tree * factor


def preempting_pool(spec) -> int:
    """Pages for the first SLOTS prompts plus one growth page for all but
    one slot (and the trash page): the batch cannot grow without
    preempting."""
    first = sum(-(-len(p) // PAGE_SIZE) for _, p, _ in spec[:SLOTS])
    return first + SLOTS - 1 + 1


def spec_report(label, spec, out, eng, counts, wall, n_tok):
    """Print a speculative run's line and check what every one must show:
    the verify kernel launched and the pool drained.  Returns its record."""
    acc = [eng.last_stats[u]["accept_rate"] for u, _, _ in spec]
    disables = sum(eng.last_stats[u].get("spec_auto_disables", 0) for u, _, _ in spec)
    pool = eng.last_pool_stats
    print(f"spec {label}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; "
          f"accept_rate per request {[round(a, 3) for a in acc]} mean "
          f"{np.mean(acc):.3f}; auto-disables {disables}; preemptions "
          f"{eng.preemptions}; pool {pool}; launches {counts}", flush=True)
    if counts["paged_flash_verify"] == 0:
        fail(f"paged_flash_verify never launched in the spec {label} run")
    if counts["flash_decode"] == 0:
        fail(f"the draft's flash_decode never launched in the spec {label} run")
    if pool.used_pages != 0:
        fail(f"spec {label} run leaked {pool.used_pages} pages")
    return dict(tok_s=n_tok / wall, wall_s=wall, tokens=n_tok, accept_rate=acc,
                mean_accept_rate=float(np.mean(acc)), auto_disables=disables,
                preemptions=eng.preemptions, retracts=pool.retracts,
                counts=counts)


def verify_force(model, params, prompt, tokens, n_win, kv_dtype=None):
    """Logits of ``model`` for one request's served ``tokens`` taken in
    windows of SPEC_K through ``decode_verify_step`` on a paged cache of
    ``kv_dtype`` (batch 1): row i predicts tokens[i + 1], n_win * SPEC_K
    rows."""
    _, cache = prefilled(model, params, prompt, "paged", kv_dtype)
    rows = []
    for w in range(n_win):
        p0 = len(prompt) + SPEC_K * w
        win = torch.tensor([tokens[SPEC_K * w:SPEC_K * (w + 1)]], device="cuda")
        attend = min(MAX_SEQ, -(-(p0 + SPEC_K) // 64) * 64)
        logits, _ = model.decode_verify_step(
            params, cache, win, torch.tensor([p0], dtype=torch.int32, device="cuda"),
            attend)
        rows.append(logits[0])
    return torch.cat(rows)


def run_spec(cfg, model, params, spec, paged_tok_s, probe_spec: bool):
    """The speculative phase: (a) self:14 on the random weights with a
    preempting pool, (b) damped weights with self:1 beside non-speculative
    paged serving, and (b) serial beside pipelined (the tokens gated where
    ``probe_spec``: the captured spec step was bit for bit the eager one),
    (c) teacher-forced verify windows.  Returns the record and the verify
    kernel's launches in (a) and (b)."""
    from repro_torch.models.lm import Model

    paged = dict(cache_layout="paged", page_size=PAGE_SIZE)
    num_pages = preempting_pool(spec)
    out, eng, counts, wall, n_tok = serve(model, params, spec, num_pages=num_pages,
                                          spec_k=SPEC_K, draft="self:14", **paged)
    a = spec_report("a self:14", spec, out, eng, counts, wall, n_tok)
    print(f"spec a: pool {num_pages} pages; non-spec paged {paged_tok_s:.1f} tok/s",
          flush=True)
    if eng.preemptions < 1:
        fail("the spec (a) run was sized to preempt and did not")
    launches = counts["paged_flash_verify"]

    damped = dict(params, layers=_scaled(params["layers"], 0.05))
    base, _, _, b_wall, b_tok = serve(model, damped, spec, warm=True, **paged)
    print(f"spec b non-spec paged (damped weights): {b_tok} tokens in "
          f"{b_wall:.3f} s = {b_tok / b_wall:.1f} tok/s", flush=True)
    b_kw = dict(paged, spec_k=SPEC_K, draft="self:1")
    b_run = serve(model, damped, spec, warm=True, **b_kw)
    d_out, d_eng, d_counts, d_wall, d_tok = b_run
    b = spec_report("b damped self:1", spec, d_out, d_eng, d_counts, d_wall, d_tok)
    b["pipeline"] = pipeline_pair(
        "spec b", b_run, serve(model, damped, spec, pipeline=False, warm=True, **b_kw),
        STEP_KERNELS["spec"], gate=probe_spec)
    agree = np.mean([x == y for u in base for x, y in zip(base[u], d_out[u])])
    b.update(nonspec_tok_s=b_tok / b_wall, token_agreement=float(agree),
             speedup=b["tok_s"] / (b_tok / b_wall))
    print(f"spec b: spec vs non-spec token agreement {agree:.4f}; tok/s ratio "
          f"{b['speedup']:.3f}", flush=True)
    launches += d_counts["paged_flash_verify"]
    del damped

    # (c) request 0's served tokens, windows of SPEC_K, kernel and plain path
    uid, prompt, _ = spec[0]
    toks = out[uid]
    n_win = (len(toks) - 1) // SPEC_K
    dec = teacher_force(model, params, prompt, toks)[1:1 + n_win * SPEC_K]
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    c = {}
    for label, m in (("kernel", model), ("plain", plain)):
        v = verify_force(m, params, prompt, toks, n_win)
        err, scale, agree = compare_logits(
            f"uid {uid} verify windows ({label} path) vs decode steps", v, dec)
        served = (v.argmax(-1) == torch.tensor(toks[1:1 + n_win * SPEC_K],
                                               device="cuda")).float().mean().item()
        print(f"spec c {label}: argmax agreement with decode steps {agree:.4f}, "
              f"with served tokens {served:.4f}", flush=True)
        c[label] = dict(max_err=err, logit_scale=scale, argmax_agreement=agree,
                        served_agreement=served, rows=n_win * SPEC_K)
    return dict(a=a, b=b, c=c, num_pages=num_pages), launches


# ---------------------------------------------------------------------------
# phase 3a: ROADMAP C1, dense vs the preempting pool in fp32 compute
# ---------------------------------------------------------------------------

def fp32_model(cfg, params):
    """The serving model in fp32 compute with the bf16 weights widened
    (the same values; 6.2 GB at full width)."""
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import tree_map

    return (Model(cfg, device="cuda", dtype=torch.float32),
            tree_map(lambda t: t.float(), params))


def prefill_rows(model, params, spec, out, groups, uid):
    """The K/V rows of request ``uid``'s prompt as the last prefill call
    of a run that held it computed them: that call's group prefilled
    again, at its batch and bucket (``groups`` is the run's
    ``last_prefill_groups``; a resumed member's folded prompt is rebuilt
    from the run's tokens ``out``).  Returns (k, v), (L, n, Hkv, D)."""
    prompts = {u: p for u, p, _ in spec}
    uids, bucket, lens = [g for g in groups if uid in g[0]][-1]
    toks = torch.zeros(len(uids), bucket, dtype=torch.long, device="cuda")
    for i, (m, n) in enumerate(zip(uids, lens)):
        toks[i, :n] = torch.tensor(prompts[m] + out[m][:n - len(prompts[m])])
    last = torch.tensor([n - 1 for n in lens], device="cuda")
    _, cache = model.prefill(params, toks, bucket, last)
    i, n0 = uids.index(uid), len(prompts[uid])
    return cache["k"][:, i, :n0], cache["v"][:, i, :n0]


def stored_difference(model, params, spec, run_x, run_y, uid, quantized) -> dict:
    """How request ``uid``'s prompt rows differ between two runs' prefill
    calls (``run_*`` = (tokens, prefill groups)): float elements whose
    bits differ, and with ``quantized`` the int8 values and row scales
    that the pool then stores otherwise."""
    from repro_torch.serve.kv_cache import quantize_kv_rows

    rec = {}
    for name, a, b in zip("kv", prefill_rows(model, params, spec, *run_x, uid),
                          prefill_rows(model, params, spec, *run_y, uid)):
        rec[f"{name}_float_elements"] = int((a != b).sum())
        rec[f"{name}_max_abs"] = (a.float() - b.float()).abs().max().item()
        if quantized:
            (qa, sa), (qb, sb) = quantize_kv_rows(a), quantize_kv_rows(b)
            rec[f"{name}_int8_values"] = int((qa != qb).sum())
            rec[f"{name}_scales"] = int((sa != sb).sum())
    rec["elements"] = int(a.numel())
    return rec


def c1_control(cfg, model, params, spec, num_pages, dense, paged, dense_groups,
               paged_groups) -> dict:
    """ROADMAP C1.  Each bf16 request that the paged run served otherwise
    than dense is probed: its prompt rows as the two runs' prefill calls
    computed them (reported).  Then dense against the preempting paged
    pool at full width in fp32 compute, each run's prefill groups logged:
    a request that is never preempted can prefill in another
    right-padded group at another bucket after a preemption, and round
    otherwise in bf16; in fp32 the two layouts must serve the same
    tokens, or paged admission or decode is at fault.  The same fp32
    control gates the pipeline: each of its (pipelined) runs against the
    serial, eager run of the same call, and speculation (damped weights,
    a self:1 draft, the preempting pool, swapping) pipelined against
    serial, on every token."""
    probes = {u: stored_difference(model, params, spec, (dense, dense_groups),
                                   (paged, paged_groups), u, False)
              for u in dense if dense[u] != paged[u]}
    print(f"C1 bf16 probe, prompt rows of the requests dense and paged served "
          f"otherwise, as the two runs' prefill calls computed them: {probes}",
          flush=True)
    model32, params32 = fp32_model(cfg, params)
    d_run = serve(model32, params32, spec)
    p_run = serve(model32, params32, spec, cache_layout="paged", page_size=PAGE_SIZE,
                  num_pages=num_pages)
    (dense, d_eng, d_counts, _, _), (paged, p_eng, p_counts, _, _) = d_run, p_run
    print(f"C1 control fp32 prefill groups (uids, bucket, lengths): dense "
          f"{d_eng.last_prefill_groups}; paged {p_eng.last_prefill_groups}", flush=True)
    agree, per_req, preempted = layout_agreement(
        "C1 control fp32: dense vs preempting paged", dense, paged, p_eng)
    if not preempted:
        fail("the C1 control was sized to preempt and did not")
    if agree < 1.0:
        fail("in fp32 the preempting paged pool served other tokens than dense: "
             "a port fault in paged admission or decode (ROADMAP C1)")
    paged_kw = dict(cache_layout="paged", page_size=PAGE_SIZE, num_pages=num_pages)
    spec_kw = dict(paged_kw, preempt="swap", spec_k=SPEC_K, draft="self:1")
    damped = dict(params32, layers=_scaled(params32["layers"], 0.05))
    spec_run = serve(model32, damped, spec, **spec_kw)
    launches = add_counts(d_counts, p_counts)
    for label, run, p, kw, names in (
            ("fp32 control dense", d_run, params32, {}, STEP_KERNELS["dense"]),
            ("fp32 control paged", p_run, params32, paged_kw, STEP_KERNELS["paged"]),
            ("fp32 control spec", spec_run, damped, spec_kw, STEP_KERNELS["spec"])):
        serial = serve(model32, p, spec, pipeline=False, **kw)
        pipeline_pair(label, run, serial, names, gate=True)
        launches = add_counts(launches, serial[2])
    launches = add_counts(launches, spec_run[2])
    if spec_run[1].last_pool_stats.swap_ins < 1:
        fail("the fp32 spec control was sized to swap and did not")
    del damped, spec_run, d_run, p_run
    return dict(agreement=agree, per_request=per_req, preempted=preempted,
                dense_groups=d_eng.last_prefill_groups,
                paged_groups=p_eng.last_prefill_groups, bf16_probes=probes,
                launches=launches)


# ---------------------------------------------------------------------------
# phase 3c: tiered KV memory, int8 pages and host swap
# ---------------------------------------------------------------------------

def agreement(a, b) -> float:
    return float(np.mean([x == y for u in a for x, y in zip(a[u], b[u])]))


def swap_copy_ms(model, n_blocks: int, n: int = 5):
    """Host-clock ms of one swap-out (gather to a device tensor, then a
    synchronous copy into pinned host memory) and one swap-in (host to the
    pool, then a synchronize) of ``n_blocks`` int8 pages, means of ``n``
    after a warm-up; and the bytes moved each way."""
    from repro_torch.serve.kv_cache import swap_in_pages, swap_out_pages

    pool = model.init_cache(SLOTS, MAX_SEQ, layout="paged", page_size=PAGE_SIZE,
                            kv_dtype="int8")
    pool.pop("block_tables")
    src, dst = list(range(1, n_blocks + 1)), list(range(n_blocks + 1, 2 * n_blocks + 1))
    swap_in_pages(pool, swap_out_pages(pool, src), dst)
    torch.cuda.synchronize()
    t_out = t_in = 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        host = swap_out_pages(pool, src)
        t1 = time.perf_counter()
        swap_in_pages(pool, host, dst)
        torch.cuda.synchronize()
        t_out, t_in = t_out + t1 - t0, t_in + time.perf_counter() - t1
    nbytes = sum(t.numel() * t.element_size() for t in host.values())
    return t_out * 1e3 / n, t_in * 1e3 / n, nbytes


def run_tiered(cfg, model, params, spec, dense, paged, paged_tok_s, num_pages,
               bf16_preemptions, probe_int8: bool):
    """Greedy serving on int8 pools: (a) the preempting pool under requeue
    and swap, (b) an int8 pool of the bf16 preempting pool's bytes, (c) an
    ample one, (d) spec_k = 4 with the damped self:1 draft on the
    preempting pool, swapping; the verify windows on an int8 pool
    teacher-forced against int8 decode steps; and the fp32 control, whose
    swap, requeue and ample runs must serve the same tokens.  Returns the
    record (the fp32 control's launch counts in it) and the launch counts
    summed over the bf16 runs."""
    from repro_torch.models.lm import Model

    int8 = dict(cache_layout="paged", page_size=PAGE_SIZE, kv_dtype="int8")
    runs, counts, control_counts, results = {}, {}, {}, {}

    def run(label, m, p, **kw):
        result = serve(m, p, spec, **int8, **kw)
        out, eng, c, wall, n_tok = result
        results[label] = result
        pool = eng.last_pool_stats
        print(f"tiered {label}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
              f"tok/s; pool {eng.num_pages} pages; preemptions {eng.preemptions}; "
              f"swap_outs {pool.swap_outs} swap_ins {pool.swap_ins}; swapped out "
              f"{pool.swapped_out_bytes} B, in {pool.swapped_in_bytes} B; prefill "
              f"groups {eng.last_prefill_groups}; launches "
              f"{ {k: v for k, v in c.items() if v} }", flush=True)
        if pool.used_pages != 0:
            fail(f"the tiered {label} run leaked {pool.used_pages} pages")
        into = control_counts if label.startswith("fp32 control") else counts
        for k, v in c.items():
            into[k] = into.get(k, 0) + v
        runs[label] = dict(tok_s=n_tok / wall, wall_s=wall, tokens=n_tok,
                           num_pages=eng.num_pages, preemptions=eng.preemptions,
                           swap_outs=pool.swap_outs, swap_ins=pool.swap_ins,
                           swapped_out_bytes=pool.swapped_out_bytes,
                           swapped_in_bytes=pool.swapped_in_bytes,
                           prefill_groups=eng.last_prefill_groups)
        return out, eng

    # (a) the bf16 run's preempting pool, stored int8
    requeue, r_eng = run("a requeue", model, params, num_pages=num_pages)
    swap, s_eng = run("a swap", model, params, num_pages=num_pages, preempt="swap",
                      warm=True)
    # the queued swap copies and the captured int8 step against the serial,
    # eager round (whose swap copies are synchronous)
    pair_a = pipeline_pair("tiered a swap", results["a swap"], serve(
        model, params, spec, pipeline=False, warm=True, num_pages=num_pages,
        preempt="swap", **int8), STEP_KERNELS["paged_int8"], gate=probe_int8)
    if r_eng.preemptions < 1 or s_eng.preemptions < 1:
        fail("the tiered (a) runs were sized to preempt and did not")
    sp = s_eng.last_pool_stats
    if sp.swap_outs < 1 or sp.swap_ins < 1:
        fail(f"the swap run swapped out {sp.swap_outs} and in {sp.swap_ins} times")
    hkv, dh, L = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    int8_page = 2 * L * PAGE_SIZE * (hkv * dh + 4)          # values + row scales
    bf16_page = 2 * L * PAGE_SIZE * hkv * dh * 2
    blocks = max(1, round(sp.swapped_out_bytes / sp.swap_outs / int8_page))
    out_ms, in_ms, moved = swap_copy_ms(model, blocks)
    print(f"tiered a: tok/s int8 requeue {runs['a requeue']['tok_s']:.1f}, int8 swap "
          f"{runs['a swap']['tok_s']:.1f}, bf16 paged (requeue) {paged_tok_s:.1f}; "
          f"swap copy of {blocks} pages ({moved} B): out {out_ms:.3f} ms "
          f"({moved / out_ms / 1e6:.2f} GB/s), in {in_ms:.3f} ms "
          f"({moved / in_ms / 1e6:.2f} GB/s)", flush=True)

    # (b) the capacity half of the trade: the bf16 pool's bytes, int8 pages
    same_pages = (num_pages * bf16_page) // int8_page
    _, e_eng = run("b equal bytes", model, params, num_pages=same_pages)
    print(f"tiered b: {int8_page} B a page int8 against {bf16_page} B bf16 "
          f"({int8_page / PAGE_SIZE:.0f} against {bf16_page / PAGE_SIZE:.0f} B a token); "
          f"{same_pages} int8 pages in the bytes of {num_pages} bf16 pages; "
          f"preemptions int8 {e_eng.preemptions}, bf16 {bf16_preemptions}", flush=True)

    # (c) a pool that never preempts
    ample, a_eng = run("c ample", model, params)
    if a_eng.preemptions:
        fail("the ample int8 pool preempted")

    # (d) speculation on the preempting int8 pool, swapping
    damped = dict(params, layers=_scaled(params["layers"], 0.05))
    _, d_eng = run("d spec_k=4 damped self:1 swap", model, damped, num_pages=num_pages,
                   preempt="swap", spec_k=SPEC_K, draft="self:1")
    acc = [d_eng.last_stats[u]["accept_rate"] for u, _, _ in spec]
    runs["d spec_k=4 damped self:1 swap"]["mean_accept_rate"] = float(np.mean(acc))
    print(f"tiered d: accept_rate mean {np.mean(acc):.3f}", flush=True)
    del damped

    for name in ("paged_flash_decode[int8]", "paged_flash_verify[int8]"):
        if counts.get(name, 0) == 0:
            fail(f"{name} never launched while serving on int8 pools")
    if counts["paged_flash_decode"] or counts["paged_flash_verify"]:
        fail("a float paged kernel launched while serving on int8 pools")

    # reported, not gated: bf16 rounds otherwise at another prefill bucket,
    # and int8 stores other values than bf16 (the reference's own int8 ==
    # dense test fails)
    reports = {"swap vs requeue": agreement(requeue, swap),
               "ample vs requeue": agreement(requeue, ample),
               "int8 requeue vs bf16 paged": agreement(requeue, paged),
               "int8 ample vs dense": agreement(ample, dense)}
    print(f"tiered bf16 token agreement (reported, not gated): {reports}", flush=True)

    # the verify windows over an int8 pool against int8 decode steps:
    # request 0's tokens of the requeue run, the serving weights
    uid, prompt, _ = spec[0]
    toks = requeue[uid]
    n_win = (len(toks) - 1) // SPEC_K
    dec = teacher_force(model, params, prompt, toks, kv_dtype="int8")[1:1 + n_win * SPEC_K]
    windows = {}
    for label, m in (("kernel", model), ("plain", Model(cfg, device="cuda",
                                                         dtype=torch.bfloat16,
                                                         use_kernels=False))):
        v = verify_force(m, params, prompt, toks, n_win, kv_dtype="int8")
        err, scale, agree = compare_logits(
            f"int8 uid {uid} verify windows ({label} path) vs int8 decode steps", v, dec)
        windows[label] = dict(max_err=err, logit_scale=scale, argmax_agreement=agree)

    # the fp32 control: a request stores the same bytes in the swap, the
    # requeue and the ample run, and so serves the same tokens, wherever
    # its rows were computed from the same shapes.  A request prefilled in
    # another group or bucket gets fp32 rows that may differ in their last
    # bits (cuBLAS picks its kernel by the product's shape), and one int8
    # rounding flip moves a value by a whole quantization step: such a
    # request may differ only if the probe shows its prompt stored with
    # other int8 bytes in the two runs.
    model32, params32 = fp32_model(cfg, params)
    c = {label: run(f"fp32 control {label}", model32, params32, **kw)[0]
         for label, kw in (("requeue", dict(num_pages=num_pages)),
                           ("swap", dict(num_pages=num_pages, preempt="swap")),
                           ("ample", {}))}
    # the pipelined swap run (queued swap copies, captured int8 steps)
    # against the serial, eager one: every token
    run("fp32 control swap serial", model32, params32, num_pages=num_pages,
        preempt="swap", pipeline=False)
    pair_fp32 = pipeline_pair("tiered fp32 control swap", results["fp32 control swap"],
                              results["fp32 control swap serial"],
                              STEP_KERNELS["paged_int8"], gate=True)
    control, probes = {}, {}
    for x, y in (("swap", "requeue"), ("ample", "requeue")):
        per_req = {u: float(np.mean([a == b for a, b in zip(c[x][u], c[y][u])]))
                   for u in c[y]}
        control[f"{x} vs {y}"] = dict(all=agreement(c[x], c[y]), per_request=per_req)
        for u in (u for u, a in per_req.items() if a < 1.0):
            p = stored_difference(model32, params32, spec,
                                  (c[x], runs[f"fp32 control {x}"]["prefill_groups"]),
                                  (c[y], runs[f"fp32 control {y}"]["prefill_groups"]),
                                  u, True)
            probes[f"{x} vs {y}, request {u}"] = p
            if p["k_int8_values"] + p["v_int8_values"] + p["k_scales"] + p["v_scales"] == 0:
                fail(f"in fp32 request {u} served other tokens in the int8 {x} and "
                     f"{y} runs though its prompt was stored with the same bytes")
    print(f"tiered fp32 control token agreement: {control}; probe of the requests "
          f"that differ, their prompt rows as the two runs' prefill calls computed "
          f"them: {probes}", flush=True)
    del model32, params32
    return dict(runs=runs, swap_copy=dict(blocks=blocks, bytes=moved, out_ms=out_ms,
                                          in_ms=in_ms),
                int8_page_bytes=int8_page, bf16_page_bytes=bf16_page,
                equal_bytes_pages=same_pages, bf16_preemptions=bf16_preemptions,
                agreement_bf16=reports, agreement_fp32=control, fp32_probes=probes,
                verify_windows=windows, fp32_control_launches=control_counts,
                pipeline=dict(a_swap=pair_a, fp32_swap=pair_fp32)), counts


# ---------------------------------------------------------------------------
# phase 3d: prefix sharing, suffix prefill through the long-window verify
# ---------------------------------------------------------------------------

def make_shared_requests(seed: int, vocab: int):
    """(uid, prompt, max_new_tokens) for 9 requests: 8 share one
    SYSTEM_PROMPT-token system prompt, each with its own suffix of 17-240
    tokens, and request 2 is an exact copy of request 1, whose 48 make a
    page-aligned prompt (the copy-on-write admission).  The first four
    prompts fill the serving cell's preempting pool but for one growth
    page a slot, so unshared the batch preempts, and shared the prefix
    index outgrows the pool and evicts."""
    rng = np.random.default_rng(seed + 1)
    system = rng.integers(0, vocab, SYSTEM_PROMPT).tolist()
    lens = [240, 48, 239, 17, 236, 228, 220, 212]
    prompts = [system + rng.integers(0, vocab, n).tolist() for n in lens]
    prompts.insert(2, list(prompts[1]))
    return [(i, p, MAX_NEW) for i, p in enumerate(prompts)]


def long_window_case(cfg, gen: torch.Generator, t: int):
    """The long branch's shape: B 1, qwen2's Hkv 2, G 6, D 128, a window of
    ``t`` rows behind a cached SYSTEM_PROMPT-token prefix, in shuffled
    16-token pages of a MAX_SEQ table.  Returns f32 (q, k pages, v pages),
    the table and pos."""
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    g = cfg.n_heads // hkv
    nb = MAX_SEQ // PAGE_SIZE
    q = torch.randn(1, hkv, t * g, dh, generator=gen, device="cuda")
    kp = torch.randn(nb + 1, PAGE_SIZE, hkv, dh, generator=gen, device="cuda")
    vp = torch.randn(nb + 1, PAGE_SIZE, hkv, dh, generator=gen, device="cuda")
    bt = (torch.randperm(nb, generator=gen, device="cuda") + 1).to(torch.int32)[None]
    pos = torch.tensor([SYSTEM_PROMPT], dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, pos


def check_verify_long(cfg, rows: dict, gen: torch.Generator) -> dict:
    """The long-window branch of paged_flash_verify against its plain
    version at the suffix prefill's shape (long_window_case), T 16 and
    256: bf16 pages (the tensor-core kernel), f32 and int8 pages (the
    CUDA-core kernel; int8 under bf16 q), each timed with the calls queued
    beside its bound and, for scale, SDPA on the dense view of the same
    keys under the window's mask.  The T 256 cases are the kernel rows;
    the T 16 ones are printed.  Each case also prints the key axis's split
    count (``verify_long_splits``) and its split and combine kernels'
    device ms a call (torch.profiler)."""
    import torch.nn.functional as F

    from repro_torch.kernels.verify_attention.ops import (
        long_rows_per_block,
        paged_flash_verify,
        verify_long_splits,
    )
    from repro_torch.kernels.verify_attention.ref import paged_verify_attention_ref
    from repro_torch.serve.kv_cache import quantize_kv_rows

    source = "src/repro_torch/kernels/verify_attention/verify_attention.cu"
    replaces = "src/repro/kernels/verify_attention/verify_attention.py:118"
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    g = cfg.n_heads // hkv
    out = {}
    for t in LONG_T:
        q, kf, vf, bt, pos = long_window_case(cfg, gen, t)
        kq, ks = quantize_kv_rows(kf)
        vq, vs = quantize_kv_rows(vf)
        n_keys = SYSTEM_PROMPT + t
        # row r scores pos + r // G + 1 keys, in each of hkv KV heads
        flops = 4 * dh * hkv * sum(SYSTEM_PROMPT + r // g + 1 for r in range(t * g))
        tables = -(-n_keys // PAGE_SIZE) * 4
        # the same keys as a dense (1, Hkv, n_keys, D) view, for SDPA
        dense = [x[bt[0].long()].reshape(-1, hkv, dh)[:n_keys][None].transpose(1, 2)
                 for x in (kf, vf)]
        mask = (torch.arange(n_keys, device="cuda")[None, :]
                <= SYSTEM_PROMPT + torch.arange(t, device="cuda")[:, None])
        for label, qx, kp, vp, sc, tol, peak, elt, extra in (
                ("bf16", q.to(torch.bfloat16), kf.to(torch.bfloat16), vf.to(torch.bfloat16),
                 {}, KERNEL_TOL, BF16_FLOPS_S, 2, 0),
                ("f32", q, kf, vf, {}, LONG_F32_TOL, F32_FLOPS_S, 4, 0),
                ("int8", q.to(torch.bfloat16), kq, vq, dict(k_scales=ks, v_scales=vs),
                 KERNEL_TOL, BF16_FLOPS_S, 1, 4)):
            got = paged_flash_verify(qx, kp, vp, bt, pos, t_window=t, **sc)
            want = paged_verify_attention_ref(qx, kp, vp, bt, pos, t, **sc)
            n_bytes = (2 * qx.numel() * qx.element_size()
                       + 2 * n_keys * hkv * (dh * elt + extra) + tables)
            t_kernel = queued_ms(lambda: paged_flash_verify(qx, kp, vp, bt, pos, t_window=t,
                                                            **sc))
            t_plain = queued_ms(lambda: paged_verify_attention_ref(qx, kp, vp, bt, pos, t, **sc))
            qs = qx.reshape(1, hkv, t, g, dh).transpose(2, 3).reshape(1, hkv * g, t, dh)
            kd, vd = (x.to(qx.dtype) for x in dense)
            t_sdpa = queued_ms(lambda: F.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask, enable_gqa=True))
            name = {"bf16": "paged_flash_verify[long]", "f32": "paged_flash_verify[long] (f32)",
                    "int8": "paged_flash_verify[long,int8]"}[label]
            splits = verify_long_splits(1, hkv, t * g, bt.shape[1] * PAGE_SIZE,
                                        long_rows_per_block(qx.dtype))
            parts = kernel_parts_ms(lambda: paged_flash_verify(qx, kp, vp, bt, pos, t_window=t,
                                                               **sc), LONG_KERNELS)
            print(f"kernel {name} T={t}: splits {splits}, split kernel "
                  f"{parts[LONG_KERNELS[0]]:.4f} ms, combine {parts[LONG_KERNELS[1]]:.4f} ms "
                  f"(device, profiled)", flush=True)
            if t == max(LONG_T):
                record_kernel(rows, name, source, replaces, got, want, tol, t_kernel, t_plain,
                              n_bytes, flops, peak, None)
            else:
                torch.cuda.synchronize()
                err = max_err(got, want)
                b_ms, b_by = bound(n_bytes, flops, peak)
                print(f"kernel {name} T={t}: max_abs_err={err:.3e} tol={tol} ms={t_kernel:.4f} "
                      f"plain_ms={t_plain:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
                if not agrees(got, want, tol):
                    fail(f"{name} at T={t} disagrees with its plain version beyond {tol}")
            print(f"kernel {name} T={t} ({t * g} rows a KV head, pos {SYSTEM_PROMPT}): "
                  f"library_ms none (no PyTorch call reads paged K/V); SDPA on the dense "
                  f"view under the window's mask, for scale: {t_sdpa:.4f} ms, factor "
                  f"{t_kernel / t_sdpa:.2f}", flush=True)
            out[f"{label} T={t}"] = dict(ms=t_kernel, plain_ms=t_plain, sdpa_ms=t_sdpa,
                                         max_abs_err=max_err(got, want), splits=splits,
                                         split_ms=parts[LONG_KERNELS[0]],
                                         combine_ms=parts[LONG_KERNELS[1]])
    return out


def run_shared(cfg, model, params, num_pages: int, seed: int):
    """Prefix-sharing serving of make_shared_requests, each prompt's
    un-cached suffix prefilled through ``Model.prefill_suffix`` (the
    long-window verify branch): (a) an ample pool, (b) the serving cell's
    preempting pool, each with sharing on and off, (c) the policies lfu
    and deepest on pool (b), and an int8 ample pool with sharing; the
    suffix prefill teacher-forced against a full prefill; one warm and
    one cold admission's prefill profiled; then the fp32 control, whose
    shared runs must serve their unshared run's tokens and whose three
    policies the same tokens.  Returns (record, launch counts summed over
    the bf16 runs, the int8 run's, the fp32 control's, profiles)."""
    from repro_torch.models.lm import Model

    spec = make_shared_requests(seed, cfg.vocab)
    print(f"shared requests: {len(spec)} prompts of {[len(p) for _, p, _ in spec]} "
          f"tokens, a {SYSTEM_PROMPT}-token system prompt, request 2 a copy of request 1",
          flush=True)
    runs, counts, int8_counts, control_counts, results = {}, {}, {}, {}, {}

    def run(label, m, p, into, **kw):
        result = serve(m, p, spec, cache_layout="paged", page_size=PAGE_SIZE, **kw)
        out, eng, c, wall, n_tok = results[label] = result
        pool, st = eng.last_pool_stats, eng.last_stats
        sharing = kw.get("prefix_sharing", False)
        warm = [u for u, _, _ in spec if st[u].get("cached_prefix_tokens", 0) > 0]
        ttft = {u: st[u]["first_token_s"] - st[u]["admitted_s"] for u, _, _ in spec}
        rec = dict(tok_s=n_tok / wall, wall_s=wall, tokens=n_tok, num_pages=eng.num_pages,
                   preemptions=eng.preemptions, peak_used_pages=pool.peak_used_pages,
                   peak_logical_pages=pool.peak_logical_pages,
                   sharing_ratio=pool.sharing_ratio, shares=pool.shares,
                   cow_forks=pool.cow_forks, evictions=pool.evictions,
                   cached_prefix_tokens=pool.cached_prefix_tokens,
                   index_pages=pool.index_pages, warm=warm, admit_to_first_token_s=ttft,
                   first_token_s={u: st[u]["first_token_s"] for u, _, _ in spec},
                   prefill_groups=eng.last_prefill_groups,
                   launches={k: v for k, v in c.items() if v})
        print(f"shared {label}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; "
              f"pool {eng.num_pages} pages; preemptions {eng.preemptions}; peak physical "
              f"{pool.peak_used_pages} pages, peak logical {pool.peak_logical_pages}, "
              f"sharing ratio {pool.sharing_ratio:.3f}; cached_prefix_tokens "
              f"{pool.cached_prefix_tokens}, shares {pool.shares}, cow_forks "
              f"{pool.cow_forks}, evictions {pool.evictions}, index pages "
              f"{pool.index_pages}; warm {warm}; prefill groups "
              f"{eng.last_prefill_groups}; launches {rec['launches']}", flush=True)
        if pool.logical_pages != 0 or pool.used_pages != pool.index_pages:
            fail(f"the shared {label} run leaked pages: {pool}")
        if sharing:
            if c["paged_flash_verify[long]"] + c["paged_flash_verify[long,int8]"] == 0:
                fail(f"the shared {label} run prefilled no suffix through the "
                     "long-window verify branch")
            if c["paged_flash_verify"] + c["paged_flash_verify[int8]"]:
                fail(f"the shared {label} run launched the split verify kernel: a "
                     "suffix went through per-sub-window calls")
            if pool.sharing_ratio <= 1.0 or pool.cached_prefix_tokens == 0:
                fail(f"the shared {label} run shared nothing: {pool}")
        for k, v in c.items():
            into[k] = into.get(k, 0) + v
        runs[label] = rec
        return out

    pools = {"a": {}, "b": dict(num_pages=num_pages)}
    bf = {}
    for cell, kw in pools.items():
        for on in (True, False):
            label = f"{cell} {'on' if on else 'off'}"
            bf[label] = run(label, model, params, counts, prefix_sharing=on, **kw)
    for policy in ("lfu", "deepest"):
        bf[f"c {policy}"] = run(f"c {policy}", model, params, counts, prefix_sharing=True,
                                evict_policy=policy, **pools["b"])
    run("int8 a on", model, params, int8_counts, prefix_sharing=True, kv_dtype="int8")
    if int8_counts["paged_flash_verify[long,int8]"] == 0:
        fail("the int8 shared run never launched the long branch's int8 kernel")
    for label in ("b on", "c lfu", "c deepest"):
        r = runs[label]
        if r["evictions"] < 1 or r["cow_forks"] < 1:
            fail(f"the shared {label} run was sized to evict and fork, and recorded "
                 f"{r['evictions']} evictions and {r['cow_forks']} CoW forks")
    if runs["b off"]["preemptions"] < 1:
        fail("the unshared (b) run was sized to preempt and did not")
    b_on = runs["b on"]
    if b_on["peak_used_pages"] >= b_on["peak_logical_pages"]:
        fail(f"the shared (b) run's slots never mapped more pages than the pool held: "
             f"peak physical {b_on['peak_used_pages']}, peak logical "
             f"{b_on['peak_logical_pages']}")
    a_on, a_off = runs["a on"], runs["a off"]
    warm = a_on["warm"]
    ttft = {k: float(np.mean([runs[k]["admit_to_first_token_s"][u] for u in warm]))
            for k in ("a on", "a off")}
    first = {k: float(np.mean([runs[k]["first_token_s"][u] for u in warm]))
             for k in ("a on", "a off")}
    reports = {"a on vs off": agreement(bf["a on"], bf["a off"]),
               "b on vs off": agreement(bf["b on"], bf["b off"]),
               "lfu vs lru": agreement(bf["c lfu"], bf["b on"]),
               "deepest vs lru": agreement(bf["c deepest"], bf["b on"])}
    print(f"shared summary: warm requests {warm}; admission to first token, mean over "
          f"them, {ttft['a on'] * 1e3:.1f} ms shared against {ttft['a off'] * 1e3:.1f} ms "
          f"unshared; first token since serve() {first['a on'] * 1e3:.1f} against "
          f"{first['a off'] * 1e3:.1f} ms; tok/s a {a_on['tok_s']:.1f} against "
          f"{a_off['tok_s']:.1f}, b {runs['b on']['tok_s']:.1f} against "
          f"{runs['b off']['tok_s']:.1f}; preemptions at {num_pages} pages "
          f"{runs['b on']['preemptions']} shared, {runs['b off']['preemptions']} unshared; "
          f"peak physical pages a {a_on['peak_used_pages']} shared (peak logical "
          f"{a_on['peak_logical_pages']}) against {a_off['peak_used_pages']} unshared, "
          f"b {b_on['peak_used_pages']} shared (peak logical "
          f"{b_on['peak_logical_pages']}) against {runs['b off']['peak_used_pages']}; "
          f"bf16 token agreement (reported, not gated) {reports}", flush=True)

    # the suffix prefill after a cached system prompt, teacher-forced
    # against a full prefill of the same prompt (request 0), kernel path
    # and plain path; then one warm and one cold admission's prefill
    # profiled
    uid, prompt, _ = spec[0]
    suffix = prompt[SYSTEM_PROMPT:]
    _, cache = prefilled(model, params, prompt[:SYSTEM_PROMPT], "paged")
    toks = torch.tensor([suffix], device="cuda")
    start = torch.tensor([SYSTEM_PROMPT], dtype=torch.int32, device="cuda")
    last = torch.tensor([len(suffix) - 1], device="cuda")
    attend = min(MAX_SEQ, -(-len(prompt) // 64) * 64)
    full, _ = model.prefill(params, torch.tensor([prompt], device="cuda"), len(prompt))
    forced = {}
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    for label, m in (("kernel", model), ("plain", plain)):
        got, _ = m.prefill_suffix(params, cache, toks, start, last, attend)
        err, scale, agree = compare_logits(
            f"uid {uid} suffix prefill after a cached {SYSTEM_PROMPT}-token prefix "
            f"({label} path) vs the kernel path's full prefill", got, full)
        forced[label] = dict(max_err=err, logit_scale=scale, argmax_agreement=agree)
    del plain
    profiles = {
        "prefill_warm_suffix": profile_phase(
            f"prefill_warm_suffix (uid {uid}: {len(suffix)} of {len(prompt)} tokens, "
            f"{SYSTEM_PROMPT} cached)",
            lambda: model.prefill_suffix(params, cache, toks, start, last, attend), 3),
        "prefill_cold": profile_phase(
            f"prefill_cold (uid {uid}: {len(prompt)} tokens)",
            lambda: model.prefill(params, torch.tensor([prompt], device="cuda"),
                                  len(prompt)), 3)}
    warm_p = profiles["prefill_warm_suffix"]
    # a prefill runs no decode step: every combine in it is the long branch's
    long_ms = warm_p["verify_long_ms"] + warm_p["decode_kernels"]["decode_combine_kernel"]
    print(f"shared prefill device ms: warm {warm_p['device_ms']:.3f} "
          f"against cold {profiles['prefill_cold']['device_ms']:.3f} "
          f"({len(suffix) / len(prompt):.3f} of the prompt uncached); the warm prefill's "
          f"long branch {long_ms:.3f} ms (split kernel {warm_p['verify_long_ms']:.3f}, "
          f"combine {warm_p['decode_kernels']['decode_combine_kernel']:.3f}; unsplit "
          f"design: {LONG_UNSPLIT_WARM_MS})", flush=True)
    del cache

    # the fp32 control: sharing is invisible below the block tables
    model32, params32 = fp32_model(cfg, params)
    c = {}
    for cell, kw in pools.items():
        for on in (True, False):
            label = f"{cell} {'on' if on else 'off'}"
            c[label] = run(f"fp32 control {label}", model32, params32, control_counts,
                           prefix_sharing=on, **kw)
    for policy in ("lfu", "deepest"):
        c[f"c {policy}"] = run(f"fp32 control c {policy}", model32, params32,
                               control_counts, prefix_sharing=True, evict_policy=policy,
                               **pools["b"])
    control = {"a on vs off": agreement(c["a on"], c["a off"]),
               "b on vs off": agreement(c["b on"], c["b off"]),
               "lfu vs lru": agreement(c["c lfu"], c["b on"]),
               "deepest vs lru": agreement(c["c deepest"], c["b on"]),
               "a off vs b off": agreement(c["a off"], c["b off"])}
    print(f"shared fp32 control token agreement: {control}", flush=True)
    for k, v in control.items():
        if k != "a off vs b off" and v < 1.0:
            fail(f"in fp32 the shared runs served other tokens ({k}: {v:.4f}): sharing "
                 "is not invisible below the block tables")
    # the pipelined shared run on the preempting pool against the serial one
    run("fp32 control b on serial", model32, params32, control_counts,
        prefix_sharing=True, pipeline=False, **pools["b"])
    pair = pipeline_pair("shared fp32 control b on", results["fp32 control b on"],
                         results["fp32 control b on serial"], STEP_KERNELS["paged"],
                         gate=True)
    del model32, params32
    return (dict(runs=runs, agreement_bf16=reports, agreement_fp32=control,
                 teacher_forced=forced, warm_admit_to_first_token_s=ttft,
                 warm_first_token_s=first, num_pages=num_pages, pipeline_fp32=pair),
            counts, int8_counts, control_counts, profiles)


def where_time_goes(model, params, gen):
    """Host wall time (with a synchronize) and summed device kernel time
    (torch.profiler) of one full-batch decode step (dense, paged bf16 and
    paged int8), one 4 x 512 prefill,
    and the two halves of a speculative step (a 14-layer self-draft decode
    step, three per window, and one spec_k = 4 verify step over the paged
    cache) on the kernel path, eager; their ratio is the device's busy
    share.  Then the whole spec step eager, and each step kind replayed as
    the pipelined engine replays it, one captured graph a step (``_graph``
    rows)."""
    from repro_torch.serve.spec_decode import make_self_draft

    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
    tok = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
    cache = model.init_cache(SLOTS, MAX_SEQ)
    toks = torch.randint(0, model.cfg.vocab, (SLOTS, 512), generator=gen,
                         device="cuda")
    draft, dparams = make_self_draft(model, params, 14)
    dcache = draft.init_cache(SLOTS, MAX_SEQ)
    pcache = model.init_cache(SLOTS, MAX_SEQ, layout="paged", page_size=PAGE_SIZE)
    nb = pcache["block_tables"].shape[1]
    pcache["block_tables"] = torch.arange(1, SLOTS * nb + 1, dtype=torch.int32,
                                          device="cuda").reshape(SLOTS, nb)
    qcache = model.init_cache(SLOTS, MAX_SEQ, layout="paged", page_size=PAGE_SIZE,
                              kv_dtype="int8")
    qcache["block_tables"] = pcache["block_tables"]
    win = torch.zeros(SLOTS, SPEC_K, dtype=torch.int32, device="cuda")
    phases = {}
    for name, fn, n in (
            ("decode_step", lambda: model.decode_step(params, cache, tok, pos,
                                                      attend_len=MAX_SEQ), 10),
            ("paged_decode_step", lambda: model.decode_step(
                params, pcache, tok, pos, attend_len=MAX_SEQ), 10),
            ("paged_decode_step_int8", lambda: model.decode_step(
                params, qcache, tok, pos, attend_len=MAX_SEQ), 10),
            ("prefill_4x512", lambda: model.prefill(params, toks, 512), 3),
            ("draft_step_self14", lambda: draft.decode_step(
                dparams, dcache, tok, pos, attend_len=MAX_SEQ), 10),
            ("verify_step_T4", lambda: model.decode_verify_step(
                params, pcache, win, pos, attend_len=MAX_SEQ), 10)):
        # the device's records alone: the host-side events of ten eager
        # steps took the profiler 4-25 s a row to sum, and no reading uses them
        phases[name] = profile_phase(name, fn, n, device_only=True)
    # the whole spec step (three draft steps, verify, accept) eager, then
    # each step kind as the pipelined engine replays it: one captured graph
    spec_eager = step_state(model, params, "spec", gen, (draft, dparams))

    def eager_spec():
        spec_eager["reset"]()
        spec_eager["fn"]()

    phases["spec_step_T4_self14"] = profile_phase("spec_step_T4_self14", eager_spec, 10,
                                                  device_only=True)
    del spec_eager
    for name, kind in (("decode_step_graph", "dense"), ("paged_decode_step_graph", "paged"),
                       ("paged_decode_step_int8_graph", "paged_int8"),
                       ("spec_step_T4_self14_graph", "spec")):
        phases[name] = graph_phase(name, model, params, kind, gen, (draft, dparams))
    require_decode_kernels(phases, ("decode_step", "paged_decode_step",
                                    "paged_decode_step_int8", "draft_step_self14",
                                    "verify_step_T4", "spec_step_T4_self14",
                                    "decode_step_graph", "paged_decode_step_graph",
                                    "paged_decode_step_int8_graph",
                                    "spec_step_T4_self14_graph"))
    return phases


def graph_phase(name, model, params, kind: str, gen, draft=None, n: int = 10,
                sampler=None, masks=None, parts=()) -> dict:
    """``profile_phase`` of one captured step of ``kind`` replayed
    (``serve/step_graph.py``; the step's state from :func:`step_state`,
    tok / pos / remaining put back before each replay, three small copies
    that the device time includes); fails unless the graph launches the
    kind's kernels.  ``gating_ms`` etc. come from the profile as for the
    eager rows; ``parts`` names kernels whose device ms a replay is
    profiled apart (``kernel_parts_ms``, in ``parts_ms``)."""
    from repro_torch.serve.step_graph import StepGraphs

    st = step_state(model, params, kind, gen, draft, sampler, masks)
    graphs = StepGraphs("cuda", enabled=True)
    graphs.run((kind, ATTEND), st["fn"], restore=st["restore"])
    per = graphs.launches().get((kind, ATTEND), {})
    missing = [k for k in STEP_KERNELS[kind] if per.get(k, 0) == 0]
    if missing:
        fail(f"the captured {kind} step launches none of {missing}: {per}")

    def replay():
        st["reset"]()
        graphs.run((kind, ATTEND), st["fn"])

    rec = profile_phase(name, replay, n)
    rec["launches_per_replay"] = per
    if parts:
        rec["parts_ms"] = kernel_parts_ms(replay, parts)
    return rec


def kernel_parts_ms(fn, names, n: int = 20) -> dict:
    """Device ms a call of ``fn`` of the kernels whose names hold each of
    ``names`` (torch.profiler over ``n`` calls after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench.fig5_microbench import kernel_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {k: sum(kernel_us(e) for e in events if k in e.key) / 1e3 / n for k in names}


def profile_phase(name, fn, n: int, device_only: bool = False, warm: bool = True) -> dict:
    """Host wall time of ``n`` calls of ``fn`` after one warm-up call
    (none with ``warm=False``: the caller has run ``fn`` already), ended
    by a synchronize, then the summed device kernel time of ``n`` more
    under torch.profiler; prints the ``time`` line and returns both, the
    busy share and the largest kernels.  ``device_only`` records the
    device's activity alone (a call of tens of thousands of launches,
    whose host-side events would take the profiler minutes to sum)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench.fig5_microbench import kernel_us

    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    activities = [ProfilerActivity.CUDA]
    if not device_only:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_ms = sum(kernel_us(e) for e in events) / 1e3 / n
    top = sorted(events, key=kernel_us, reverse=True)[:8]
    decode = {k: sum(kernel_us(e) for e in events if k in e.key) / 1e3 / n
              for k in DECODE_KERNELS}
    gating = sum(kernel_us(e) for e in events if GATING_KERNEL in e.key) / 1e3 / n
    long_ms = sum(kernel_us(e) for e in events if LONG_KERNELS[0] in e.key) / 1e3 / n
    rec = dict(wall_ms=wall_ms, device_ms=dev_ms, decode_kernels=decode, gating_ms=gating,
               verify_long_ms=long_ms,
               kernels_a_call=sum(e.count for e in events if kernel_us(e) > 0) / n,
               top=[(e.key[:70], kernel_us(e) / 1e3 / n) for e in top if kernel_us(e) > 0])
    busy = f"{dev_ms / wall_ms:.3f}" if dev_ms > 0 else "not measured"
    print(f"time {name}: wall {wall_ms:.3f} ms, device kernels {dev_ms:.3f} ms, "
          f"device busy share {busy}; decode kernels "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in decode.items())
          + f"; {GATING_KERNEL} {gating:.4f}; {rec['kernels_a_call']:.0f} kernels a call; top: "
          + "; ".join(f"{k} {ms:.3f}" for k, ms in rec["top"]), flush=True)
    return rec


def require_decode_kernels(phases: dict, names):
    """Fail unless each decode- or verify-step profile (where the profiler
    saw device time at all) holds both kernels, the split and the combine
    (the verify step's are its paged_flash_verify calls)."""
    for name in names:
        r = phases[name]
        if r["device_ms"] > 0 and not all(r["decode_kernels"][k] > 0 for k in DECODE_KERNELS):
            fail(f"the {name} profile holds no {DECODE_KERNELS} time: "
                 f"{r['decode_kernels']}")


# ---------------------------------------------------------------------------
# phase 4d: sampling at temperature > 0
# ---------------------------------------------------------------------------

def step_sampler(device="cuda"):
    """The draw a sampled engine's captured steps make (``serve/sampling.py``,
    the reference's jitted rounding), at SAMPLE_T with SAMPLE_SEED's keys."""
    from repro_torch.serve import sampling

    return sampling.StepSampler(sampling.prng_key(SAMPLE_SEED, device), SAMPLE_T)


def check_sampler(vocab: int, gen: torch.Generator) -> dict:
    """The sampler on the card against the CPU at a decode step's shape
    (SLOTS rows of the full vocabulary, each row's (uid, position) key):
    keys, random bits, uniforms and scaled logits (both roundings) must
    be equal; the Gumbel values' largest difference (the libraries' log)
    and the token agreement are reported; the sampler's eager time a
    call (host-paced) beside one argmax."""
    from repro_torch.serve import sampling

    uids = torch.tensor([0, 1, 7, 2 ** 31 - 1], dtype=torch.int32)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32) + 1
    logits = torch.randn(SLOTS, vocab, generator=gen, device="cuda") * 3

    def draw(dev):
        base = sampling.prng_key(SAMPLE_SEED, dev)
        keys = sampling.fold_in(sampling.fold_in(base, uids.to(dev)), pos.to(dev))
        bits = sampling.random_bits(keys, (vocab,))
        unif = sampling.uniform_from_bits(bits, sampling.F32_TINY)
        lg = logits.to(dev)
        return dict(keys=keys, bits=bits, uniform=unif,
                    scaled_div=sampling.scale_logits(lg, SAMPLE_T),
                    scaled_mul=sampling.scale_logits(lg, SAMPLE_T, reciprocal=True),
                    gumbel=sampling.gumbel(keys, (vocab,)),
                    tokens=sampling.sample_at(lg, pos.to(dev), uids.to(dev), base,
                                              SAMPLE_T, reciprocal=True))

    gpu, cpu = draw("cuda"), draw("cpu")
    equal = {k: bool(torch.equal(gpu[k].cpu(), cpu[k]))
             for k in ("keys", "bits", "uniform", "scaled_div", "scaled_mul")}
    g_err = (gpu["gumbel"].cpu() - cpu["gumbel"]).abs().max().item()
    tok_agree = (gpu["tokens"].cpu() == cpu["tokens"]).float().mean().item()
    sampler = step_sampler()
    pos_d, uids_d = pos.cuda(), uids.cuda()
    sample_ms = cuda_ms(lambda: sampler(logits, pos_d, uids_d))
    argmax_ms = cuda_ms(lambda: torch.argmax(logits, dim=-1))
    rec = dict(equal=equal, gumbel_max_abs=g_err, token_agreement=tok_agree,
               sampler_eager_ms=sample_ms, argmax_ms=argmax_ms,
               elements=SLOTS * vocab)
    print(f"sampled sampler: CUDA vs CPU at {SLOTS} x {vocab}: equal {equal}; gumbel "
          f"max |diff| {g_err:.3e} (tolerance {sampling.GUMBEL_ATOL:.0e}); token "
          f"agreement {tok_agree:.4f}; the sampler eager {sample_ms:.3f} ms a call "
          f"(host-paced) against argmax {argmax_ms:.4f} ms", flush=True)
    if not all(equal.values()):
        fail(f"the sampler's keys, bits, uniforms or scaled logits differ between "
             f"the card and the CPU: {equal}")
    if g_err > sampling.GUMBEL_ATOL:
        fail(f"the card's Gumbel values are {g_err:.3e} from the CPU's")
    return rec


def frequency_check(vocab: int, gen: torch.Generator) -> dict:
    """FREQ_DRAWS draws, one per uid, from one fixed logits row: FREQ_HOT
    tokens set to hold ~2-8 % of softmax(logits / T) each, the rest of the
    vocabulary the remainder.  Each of the FREQ_HOT + 1 buckets' counts
    must lie within FREQ_SIGMA binomial sigmas of n p; chi-square
    reported."""
    from repro_torch.serve import sampling

    base = sampling.prng_key(SAMPLE_SEED, "cuda")
    logits = torch.randn(vocab, generator=gen, device="cuda")
    hot = torch.randperm(vocab, generator=gen, device="cuda")[:FREQ_HOT]
    w = torch.linspace(0.02, 0.08, FREQ_HOT, dtype=torch.float64, device="cuda")
    rest = torch.ones(vocab, dtype=torch.bool, device="cuda")
    rest[hot] = False
    z_rest = torch.exp(logits.double()[rest] / SAMPLE_T).sum()
    logits[hot] = (SAMPLE_T * torch.log(w / (1 - w.sum()) * z_rest)).float()
    p = torch.softmax(logits.double() / SAMPLE_T, dim=0)
    probs = torch.cat([p[hot], p[rest].sum()[None]])
    counts = torch.zeros(vocab, dtype=torch.int64, device="cuda")
    pos = torch.full((FREQ_CHUNK,), 17, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    for c in range(0, FREQ_DRAWS, FREQ_CHUNK):
        uids = torch.arange(c, c + FREQ_CHUNK, dtype=torch.int32, device="cuda")
        tok = sampling.sample_at(logits.expand(FREQ_CHUNK, vocab), pos, uids, base,
                                 SAMPLE_T, reciprocal=True)
        counts += torch.bincount(tok.long(), minlength=vocab)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = torch.cat([counts[hot], counts[rest].sum()[None]]).double()
    want = FREQ_DRAWS * probs
    sigma = torch.sqrt(FREQ_DRAWS * probs * (1 - probs))
    zs = ((got - want) / sigma).tolist()
    chi2 = float(((got - want) ** 2 / want).sum())
    rec = dict(draws=FREQ_DRAWS, buckets=FREQ_HOT + 1, max_abs_z=max(abs(z) for z in zs),
               z=zs, chi2=chi2, wall_s=wall)
    print(f"sampled frequency: {FREQ_DRAWS} draws with distinct uids from one row of "
          f"{vocab} logits at T {SAMPLE_T}: max |z| {rec['max_abs_z']:.2f} over "
          f"{FREQ_HOT + 1} buckets (gate {FREQ_SIGMA}); chi-square {chi2:.2f} "
          f"({FREQ_HOT} dof); {wall:.2f} s", flush=True)
    if rec["max_abs_z"] > FREQ_SIGMA:
        fail(f"sampled frequencies are {rec['max_abs_z']:.2f} sigma from softmax(logits/T)")
    return rec


def run_sampled(cfg, model, params, spec, num_pages, greedy_dense, phases,
                gen: torch.Generator, draft) -> tuple:
    """Phase 4d (see the module docstring).  Returns the record, the bf16
    runs' launch counts (summed) and the fp32 control's."""
    from repro_torch import serve_lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.spec_decode import make_self_draft

    t_phase = time.perf_counter()
    rec = dict(temperature=SAMPLE_T, seed=SAMPLE_SEED)
    rec["sampler"] = check_sampler(cfg.vocab, gen)
    rec["frequency"] = frequency_check(cfg.vocab, gen)
    sampler = step_sampler()
    probes = {kind: replay_probe(model, params, kind, gen, draft, sampler)
              for kind in ("dense", "paged", "spec")}
    rec["replay_probes"] = probes
    kw = dict(temperature=SAMPLE_T, seed=SAMPLE_SEED)
    paged_kw = dict(cache_layout="paged", page_size=PAGE_SIZE, num_pages=num_pages)
    runs = {}
    for label, lkw, kind in (("dense", {}, "dense"), ("paged", paged_kw, "paged")):
        piped = serve(model, params, spec, **kw, **lkw)
        serial = serve(model, params, spec, pipeline=False, **kw, **lkw)
        rec[f"pipeline_{label}"] = pipeline_pair(
            f"sampled {label}", piped, serial, STEP_KERNELS[kind],
            gate=probes[kind]["bit_for_bit"])
        runs[label] = (piped, serial)
    counts = add_counts(add_counts(*(r[2] for r in runs["dense"])),
                        add_counts(*(r[2] for r in runs["paged"])))
    sampled_dense = runs["dense"][0][0]
    if runs["paged"][0][1].preemptions < 1:
        fail("the sampled paged run was sized to preempt and did not")
    differ = agreement(greedy_dense, sampled_dense)
    rec["greedy_agreement"] = differ
    layout_agreement("sampled dense vs paged token agreement (bf16, reported)",
                     sampled_dense, runs["paged"][0][0], runs["paged"][0][1])
    del runs

    # the fp32 control of phase 3a, sampled: dense = the preempting pool
    model32, params32 = fp32_model(cfg, params)
    d32 = serve(model32, params32, spec, **kw)
    p32 = serve(model32, params32, spec, **kw, **paged_kw)
    agree32, _, preempted = layout_agreement(
        "sampled fp32 control: dense vs preempting paged", d32[0], p32[0], p32[1])
    rec["fp32_control"] = dict(agreement=agree32, preempted=preempted)
    counts32 = add_counts(d32[2], p32[2])
    if not preempted:
        fail("the sampled fp32 control was sized to preempt and did not")
    if agree32 < 1.0:
        fail("sampled, in fp32, the preempting paged pool served other tokens than dense")
    del model32, params32, d32, p32

    # spec (b) sampled: damped weights, a self:1 draft, beside non-spec
    damped = dict(params, layers=_scaled(params["layers"], 0.05))
    base, _, base_counts, b_wall, b_tok = serve(model, damped, spec, **kw,
                                                cache_layout="paged", page_size=PAGE_SIZE)
    s_out, s_eng, s_counts, s_wall, s_tok = serve(
        model, damped, spec, **kw, cache_layout="paged", page_size=PAGE_SIZE,
        spec_k=SPEC_K, draft="self:1")
    b = spec_report("b damped self:1 sampled", spec, s_out, s_eng, s_counts, s_wall, s_tok)
    b.update(nonspec_tok_s=b_tok / b_wall, token_agreement=agreement(base, s_out),
             speedup=b["tok_s"] / (b_tok / b_wall))
    print(f"sampled spec b: spec vs non-spec token agreement {b['token_agreement']:.4f} "
          f"(reported); tok/s {b['tok_s']:.1f} against non-spec {b_tok / b_wall:.1f}",
          flush=True)
    rec["spec_b"] = b
    counts = add_counts(counts, add_counts(base_counts, s_counts))
    del damped

    # the captured steps, sampled beside greedy (the same call)
    for name, kind in (("decode_step_graph", "dense"),
                       ("spec_step_T4_self14_graph", "spec")):
        rows = phases[name]
        s_rec = graph_phase(f"{name}_sampled", model, params, kind, gen,
                            make_self_draft(model, params, 14) if kind == "spec" else None,
                            sampler=sampler)
        phases[f"{name}_sampled"] = s_rec
        print(f"sampled step {kind}: wall {s_rec['wall_ms']:.3f} ms, kernels "
              f"{s_rec['device_ms']:.3f} ms against greedy wall {rows['wall_ms']:.3f}, "
              f"kernels {rows['device_ms']:.3f} (+{s_rec['wall_ms'] - rows['wall_ms']:.3f} "
              f"/ +{s_rec['device_ms'] - rows['device_ms']:.3f} ms)", flush=True)
        rec[f"{kind}_step"] = dict(sampled_wall_ms=s_rec["wall_ms"],
                                   sampled_device_ms=s_rec["device_ms"],
                                   greedy_wall_ms=rows["wall_ms"],
                                   greedy_device_ms=rows["device_ms"])

    # generate() at two seeds, and the serve_lm example
    prompts = torch.randint(0, cfg.vocab, (SLOTS, 64), generator=gen, device="cuda")
    outs = {}
    for seed in (SAMPLE_SEED, SAMPLE_SEED + 1):
        eng = ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS,
                          temperature=SAMPLE_T, seed=seed)
        outs[seed] = eng.generate(prompts, 16).cpu()
        fault_free("generate", eng)
        if outs[seed].shape != (SLOTS, 16) or not bool(
                ((outs[seed] >= 0) & (outs[seed] < cfg.vocab)).all()):
            fail(f"generate gave {tuple(outs[seed].shape)} tokens or ids out of range")
    seeds_differ = float((outs[SAMPLE_SEED] != outs[SAMPLE_SEED + 1]).float().mean())
    rec["generate_seed_difference"] = seeds_differ
    t0 = time.perf_counter()
    lm = serve_lm.main([])
    if lm["backend_degraded"] or lm["recoveries"]:
        fail(f"serve_lm's engine recovered {lm['recoveries']} time(s), degraded "
             f"{lm['backend_degraded']}")
    rec["serve_lm"] = dict(wall_s=time.perf_counter() - t0, tokens=lm["tokens"],
                           served=lm["served"])
    print(f"sampled sanity: sampled dense vs greedy dense token agreement {differ:.4f}; "
          f"generate seed {SAMPLE_SEED} vs {SAMPLE_SEED + 1}: {seeds_differ:.4f} of "
          f"tokens differ; serve_lm {lm['served']} requests, {lm['tokens']} tokens in "
          f"{rec['serve_lm']['wall_s']:.1f} s", flush=True)
    if differ >= 1.0:
        fail("the sampled dense run served the greedy tokens")
    if seeds_differ <= 0.0:
        fail("generate served the same tokens at two seeds")
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"sampled phase: {rec['wall_s']:.1f} s", flush=True)
    return rec, counts, counts32


# ---------------------------------------------------------------------------
# phase 4e: the engine's scheduling axes
# ---------------------------------------------------------------------------

SCHED_BUDGET = 128            # prompt tokens prefilled a round in (a) and (b)
SCHED_SHORT_NEW = 96
SCHED_LONG_NEW = 16
LIFECYCLE_SLOTS = 2
LIFECYCLE_MAX_QUEUE = 8
LIFECYCLE_WATERMARK = 2
LIFECYCLE_SHED_PRIORITY = 2


def make_sched_requests(seed: int, vocab: int):
    """(a)'s trace as Request fields: 2 short prompts (32-64 tokens, 96 new
    tokens, priority 0) after 4 long ones (480-512 tokens, 16 new,
    priority 1)."""
    rng = np.random.default_rng(seed + 27)
    longs = [dict(uid=i, prompt=rng.integers(0, vocab, int(n)).tolist(),
                  max_new_tokens=SCHED_LONG_NEW, priority=1)
             for i, n in enumerate(rng.integers(480, 513, 4))]
    shorts = [dict(uid=4 + i, prompt=rng.integers(0, vocab, int(n)).tolist(),
                   max_new_tokens=SCHED_SHORT_NEW, priority=0)
              for i, n in enumerate(rng.integers(32, 65, 2))]
    return longs + shorts


def make_lifecycle_requests(seed: int, vocab: int):
    """(c)'s trace: 12 short requests, priorities 0 (5 of them), 1 (4) and
    2 (3); uid 0 is cancelled before serve(), uid 1 carries deadline_ms
    0.0 (both priority 0, so no queue bound sheds them first), the others
    ttft_deadline_ms 1e9.  uid 2, the oldest of priority 1, has the
    largest footprint of its class, so a bound of 8 sheds another request
    under each policy."""
    rng = np.random.default_rng(seed + 28)
    prio = [0, 0, 1, 2, 0, 1, 2, 0, 1, 2, 1, 0]
    out = []
    for i, p in enumerate(prio):
        r = dict(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(16, 65))).tolist(),
                 max_new_tokens=40 if i == 2 else int(rng.integers(8, 25)), priority=p)
        r.update(deadline_ms=0.0) if i == 1 else r.update(ttft_deadline_ms=1e9)
        out.append(r)
    return out


def sched_serve(model, params, spec, *, warm: bool = False, slots: int = SLOTS,
                cancel=(), check: bool = True, **kw):
    """``serve``'s twin for Request fields (priorities, deadlines): a
    fresh engine, ``warm`` first serves the trace once untimed (capturing
    its graphs), ``cancel`` names uids cancel()ed just before the timed
    session; each request's time-between-token gaps are tapped from the
    engine's TBT clock, and the rounds that prefilled a chunk.  Unless
    ``check`` is False every request must end ``ok`` with its token count.
    Returns (tokens, engine, launch counts, wall s, tokens served, taps:
    gaps by uid and the chunk rounds)."""
    from repro_torch import kernels
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=slots, **kw)
    if warm:
        eng.serve([Request(**r) for r in spec])
    gaps = {}
    record = eng._record_tbt

    def tap(st, uid, now, committed):
        if committed > 0 and uid in st.last_emit:
            gaps.setdefault(uid, []).append(now - st.last_emit[uid])
        record(st, uid, now, committed)

    chunk_rounds = set()
    prefill_chunk = eng._prefill_chunk

    def tap_chunk(st, slot):
        chunk_rounds.add(st.rnd)
        return prefill_chunk(st, slot)

    eng._record_tbt, eng._prefill_chunk = tap, tap_chunk
    for uid in cancel:
        eng.cancel(uid)
    reqs = [Request(**r) for r in spec]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    no_ragged_rmsnorm("a scheduling run", counts)
    fault_free("a scheduling run", eng)
    if check:
        for r in spec:
            s = eng.last_stats[r["uid"]]
            if s["status"] != "ok" or len(out.get(r["uid"], [])) != r["max_new_tokens"]:
                fail(f"request {r['uid']}: status {s['status']}, {s.get('tokens')} of "
                     f"{r['max_new_tokens']} tokens")
    return (out, eng, counts, wall, sum(len(v) for v in out.values()),
            dict(gaps=gaps, chunk_rounds=chunk_rounds))


def round_walls_ms(timeseries, rounds: set) -> tuple:
    """The percentiles of the rounds' host walls (the gaps between their
    timeseries stamps), of ``rounds`` and of the others."""
    from repro_torch.serve import sla

    t, rnd = timeseries["t_s"], timeseries["round"]
    walls = {rnd[i]: (t[i] - t[i - 1]) * 1e3 for i in range(1, len(t))}
    return (sla.percentiles([w for r, w in walls.items() if r in rounds]),
            sla.percentiles([w for r, w in walls.items() if r not in rounds]))


def shed_set(spec, policy: str, max_queue: int) -> set:
    """The uids a ``max_queue`` bound sheds at enqueue, by the policy's
    rule computed from the trace: the largest (priority, arrival), or
    (priority, prompt + budget, arrival), first."""
    cands = list(spec)
    shed = set()
    while len(cands) > max_queue:
        if policy == "reject-newest":
            victim = max(cands, key=lambda r: (r["priority"], r["uid"]))
        else:
            victim = max(cands, key=lambda r: (r["priority"],
                                               len(r["prompt"]) + r["max_new_tokens"],
                                               r["uid"]))
        cands.remove(victim)
        shed.add(victim["uid"])
    return shed


def run_sched(cfg, model, params, seed: int, smi: str) -> tuple:
    """Phase 4e (see the module docstring).  Returns the record, the bf16
    runs' launch counts (summed) and the fp32 runs'."""
    from repro_torch.serve import sla
    from repro_torch.serve.engine import TERMINAL_STATUSES

    t_phase = time.perf_counter()
    spec = make_sched_requests(seed, cfg.vocab)
    longs = [r["uid"] for r in spec if r["max_new_tokens"] == SCHED_LONG_NEW]
    shorts = [r["uid"] for r in spec if r["uid"] not in longs]
    print(f"sched requests: long {[len(r['prompt']) for r in spec[:4]]} tokens "
          f"(+{SCHED_LONG_NEW}, priority 1), short {[len(r['prompt']) for r in spec[4:]]} "
          f"(+{SCHED_SHORT_NEW}, priority 0); slots {SLOTS}, max_seq {MAX_SEQ}", flush=True)
    rec, counts, counts32 = {}, {}, {}

    def into(c, run_counts):
        for k, v in run_counts.items():
            c[k] = c.get(k, 0) + v

    # (a) chunked against whole prefill, paged bf16, an ample pool
    paged = dict(cache_layout="paged", page_size=PAGE_SIZE)
    a = {}
    for label, budget in (("whole", None), ("chunked", SCHED_BUDGET)):
        out, eng, c, wall, n_tok, taps = sched_serve(model, params, spec, warm=True,
                                                     prefill_budget=budget, **paged)
        into(counts, c)
        st = eng.last_stats
        tbt = sla.percentiles([g * 1e3 for u in shorts for g in taps["gaps"].get(u, [])])
        chunk_w, other_w = round_walls_ms(st["timeseries"], taps["chunk_rounds"])
        r = dict(budget=budget, tok_s=n_tok / wall, wall_s=wall,
                 rounds=len(st["timeseries"]["round"]),
                 tbt_short_ms=tbt,
                 ttft_long_ms={u: st[u]["first_token_s"] * 1e3 for u in longs},
                 prefill_chunks={u: st[u].get("prefill_chunks", 0) for u in longs},
                 long_launches=c["paged_flash_verify[long]"],
                 chunk_round_wall_ms=chunk_w, other_round_wall_ms=other_w,
                 split_verify_launches=c["paged_flash_verify"],
                 sla=st["sla"], tokens=out)
        a[label] = r
        print(f"sched a {label} (prefill_budget {budget}): TBT of the short requests "
              f"p50 {tbt['p50']:.2f} p95 {tbt['p95']:.2f} p99 {tbt['p99']:.2f} max "
              f"{tbt['max']:.2f} ms (n {tbt['n']}); TTFT of the long requests "
              f"{ {u: round(v, 2) for u, v in r['ttft_long_ms'].items()} } ms; prefill "
              f"chunks {r['prefill_chunks']}; {r['tok_s']:.1f} tok/s; {r['rounds']} rounds; "
              f"paged_flash_verify[long] launches {r['long_launches']}; round wall ms "
              f"with a chunk p50 {chunk_w['p50'] or 0:.2f} max {chunk_w['max'] or 0:.2f} "
              f"(n {chunk_w['n']}), without p50 {other_w['p50']:.2f} max "
              f"{other_w['max']:.2f} (n {other_w['n']}); [{smi}]", flush=True)
    ch = a["chunked"]
    if min(ch["prefill_chunks"].values()) <= 1:
        fail(f"a long request took one chunk under prefill_budget {SCHED_BUDGET}: "
             f"{ch['prefill_chunks']}")
    if ch["long_launches"] == 0:
        fail("the chunked run never launched paged_flash_verify's long branch")
    bf16_agree = agreement(a["whole"]["tokens"], ch["tokens"])
    print(f"sched a: chunked vs whole token agreement {bf16_agree:.4f} (bf16, reported); "
          f"short TBT max {ch['tbt_short_ms']['max']:.2f} against "
          f"{a['whole']['tbt_short_ms']['max']:.2f} ms, p99 "
          f"{ch['tbt_short_ms']['p99']:.2f} against {a['whole']['tbt_short_ms']['p99']:.2f}; "
          f"[{smi}]", flush=True)
    for r in a.values():
        del r["tokens"]
    rec["a"] = dict(a, bf16_agreement=bf16_agree)

    # (b) the fp32 control: chunking, the pipeline and a preempting pool
    # under the budget move no token
    model32, params32 = fp32_model(cfg, params)
    n_admitted = sum(-(-len(r["prompt"]) // PAGE_SIZE) for r in spec[4:] + spec[:2])
    pool = n_admitted + SLOTS - 1 + 1
    b, b_pre = {}, {}
    runs = {"whole": {}, "chunked": dict(prefill_budget=SCHED_BUDGET),
            "chunked serial": dict(prefill_budget=SCHED_BUDGET, pipeline=False),
            "whole sampled": dict(temperature=SAMPLE_T, seed=SAMPLE_SEED),
            "chunked sampled": dict(prefill_budget=SCHED_BUDGET, temperature=SAMPLE_T,
                                    seed=SAMPLE_SEED),
            "swap": dict(num_pages=pool, preempt="swap"),
            "swap chunked": dict(num_pages=pool, preempt="swap",
                                 prefill_budget=SCHED_BUDGET)}
    for label, kw in runs.items():
        out, eng, c, _, _, _ = sched_serve(model32, params32, spec, **paged, **kw)
        into(counts32, c)
        b[label] = out
        b_pre[label] = eng.preemptions
    control = {"chunked vs whole": agreement(b["chunked"], b["whole"]),
               "chunked sampled vs whole sampled": agreement(b["chunked sampled"],
                                                             b["whole sampled"]),
               "chunked serial vs pipelined": agreement(b["chunked serial"], b["chunked"]),
               "swap chunked vs swap": agreement(b["swap chunked"], b["swap"])}
    print(f"sched b fp32 control: token agreement {control}; preemptions at {pool} pages "
          f"{ {k: b_pre[k] for k in ('swap', 'swap chunked')} }; sampled vs greedy "
          f"{agreement(b['whole sampled'], b['whole']):.4f}; [{smi}]", flush=True)
    for k, v in control.items():
        if v < 1.0:
            fail(f"in fp32, {k} served other tokens ({v:.4f})")
    if b_pre["swap"] < 1:
        fail(f"the fp32 swap run at {pool} pages was sized to preempt and did not")
    if agreement(b["whole sampled"], b["whole"]) >= 1.0:
        fail("the sampled fp32 run served the greedy tokens")
    rec["b"] = dict(agreement=control, preemptions=b_pre, num_pages=pool)
    del b

    # (c) lifecycle: shedding, watermark, cancel and deadlines, 2 slots
    life = make_lifecycle_requests(seed, cfg.vocab)
    c_rec = {}
    for label, kw in (("reject-newest", dict(max_queue=LIFECYCLE_MAX_QUEUE)),
                      ("reject-largest", dict(max_queue=LIFECYCLE_MAX_QUEUE,
                                              shed_policy="reject-largest")),
                      ("watermark", dict(queue_watermark=LIFECYCLE_WATERMARK,
                                         shed_priority=LIFECYCLE_SHED_PRIORITY))):
        out, eng, c, wall, n_tok, _ = sched_serve(model, params, life, slots=LIFECYCLE_SLOTS,
                                                  cancel=(0,), check=False, **paged, **kw)
        into(counts, c)
        st = eng.last_stats
        sts = {r["uid"]: st[r["uid"]]["status"] for r in life}
        shed = {u for u, s in sts.items() if s == "shed"}
        if label == "watermark":
            want = {r["uid"] for r in life if r["priority"] >= LIFECYCLE_SHED_PRIORITY}
        else:
            want = shed_set(life, kw.get("shed_policy", "reject-newest"), LIFECYCLE_MAX_QUEUE)
        if any(s not in TERMINAL_STATUSES for s in sts.values()) or len(sts) != len(life):
            fail(f"sched c {label}: a request has no terminal status: {sts}")
        if shed != want:
            fail(f"sched c {label}: shed {sorted(shed)}, the policy names {sorted(want)}")
        if sts[0] != "cancelled" or sts[1] != "timeout" or st[1].get("reason") != "deadline":
            fail(f"sched c {label}: the cancelled uid 0 is {sts[0]}, the expired uid 1 "
                 f"{sts[1]} ({st[1].get('reason')})")
        for r in life:
            if sts[r["uid"]] == "ok" and len(out[r["uid"]]) != r["max_new_tokens"]:
                fail(f"sched c {label}: ok request {r['uid']} has {len(out[r['uid']])} "
                     f"of {r['max_new_tokens']} tokens")
            if sts[r["uid"]] not in ("ok", "shed") and r["uid"] > 1:
                fail(f"sched c {label}: request {r['uid']} ended {sts[r['uid']]}")
        census = st["sla"]["statuses"]
        c_rec[label] = dict(statuses=census, shed=sorted(shed), tok_s=n_tok / wall,
                            sla=st["sla"])
        print(f"sched c {label}: statuses {census}; shed {sorted(shed)}; {n_tok} tokens "
              f"in {wall:.3f} s; [{smi}]\n{sla.format_summary(st['sla'])}", flush=True)
    rec["c"] = c_rec

    # (d) priorities on one slot: 0 first, then 1, then 5; the tokens of
    # the all-default run (each prefills alone in both)
    trio = [dict(r, priority=p) for r, p in zip(life[2:5], (5, 1, 0))]
    for r in trio:
        r.pop("ttft_deadline_ms", None)
    plain = [dict(r, priority=1) for r in trio]
    d_out, d_eng, c1, _, _, _ = sched_serve(model, params, trio, slots=1, **paged)
    base, _, c2, _, _, _ = sched_serve(model, params, plain, slots=1, **paged)
    into(counts, add_counts(c1, c2))
    fin = {r["priority"]: d_eng.last_stats[r["uid"]]["finished_s"] for r in trio}
    print(f"sched d: finish s by priority {fin}; tokens equal the all-default run: "
          f"{d_out == base}; [{smi}]", flush=True)
    if not fin[0] < fin[1] < fin[5]:
        fail(f"sched d: one slot finished the priorities in another order: {fin}")
    if d_out != base:
        fail("sched d: priorities moved the tokens")
    rec["d"] = dict(finished_s=fin, tokens_equal=True)

    # (e) the seed loop (fused=False) on the dense layout, the 8 requests
    # of make_requests: fp32 tokens of the fused run; bf16 tok/s beside the
    # captured pipelined dense run
    reqs8 = [dict(uid=u, prompt=p, max_new_tokens=n)
             for u, p, n in make_requests(seed, cfg.vocab)]
    f32_seed, _, c1, _, _, _ = sched_serve(model32, params32, reqs8, fused=False)
    f32_fused, _, c2, _, _, _ = sched_serve(model32, params32, reqs8)
    into(counts32, add_counts(c1, c2))
    del model32, params32
    torch.cuda.empty_cache()
    agree32 = agreement(f32_seed, f32_fused)
    e = {}
    for label, kw in (("captured", {}), ("seed loop", dict(fused=False))):
        out, eng, c, wall, n_tok, _ = sched_serve(model, params, reqs8, warm=True, **kw)
        into(counts, c)
        e[label] = dict(tok_s=n_tok / wall, wall_s=wall, tokens=out,
                        graphs=eng.last_graph_stats["graphs"],
                        replays=eng.last_graph_stats["replays"],
                        flash_decode=c["flash_decode"])
    seed_rec, cap_rec = e["seed loop"], e["captured"]
    ratio = seed_rec["tok_s"] / cap_rec["tok_s"]
    bf16_seed = agreement(seed_rec.pop("tokens"), cap_rec.pop("tokens"))
    print(f"sched e: seed loop {seed_rec['tok_s']:.1f} tok/s against captured pipelined "
          f"dense {cap_rec['tok_s']:.1f} ({ratio:.3f}x); fp32 token agreement {agree32:.4f} "
          f"(gated), bf16 {bf16_seed:.4f} (reported); the seed loop's replays "
          f"{seed_rec['replays']}, flash_decode launches {seed_rec['flash_decode']}; "
          f"[{smi}]", flush=True)
    if agree32 < 1.0:
        fail("in fp32 the seed loop served other tokens than the fused dense run")
    if seed_rec["replays"] or seed_rec["graphs"]:
        fail("the seed loop replayed captured steps")
    if seed_rec["flash_decode"] == 0:
        fail("the seed loop never launched flash_decode")
    rec["e"] = dict(seed_loop=seed_rec, captured=cap_rec, ratio=ratio,
                    fp32_agreement=agree32, bf16_agreement=bf16_seed)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"sched phase: {rec['wall_s']:.1f} s; [{smi}]", flush=True)
    return rec, counts, counts32


# ---------------------------------------------------------------------------
# phase 4f: faults, recovery, the HW->SW degrade and the pool audit
# ---------------------------------------------------------------------------

FAULTS_WARM = 2               # fault-free sessions before a fault schedule's
FAULT_STRAGGLER_S = 0.2
FAULT_SPEC_WINDOW = 4         # (d)'s governor: disable after 4 one-token windows,
FAULT_SPEC_COOLDOWN = 4       # re-arm 4 steps later
FAULT_COLLAPSE_SPAN = 8
# fault-free engines checked by ``fault_free`` (every serving phase's)
FAULT_FREE = {"engines": 0}


def fault_free(label: str, eng):
    """An engine that served without a fault schedule: a recovery or a
    degrade there would hide a failure behind the plain lowering, so it
    must have neither, and its pool (paged) must audit clean."""
    FAULT_FREE["engines"] += 1
    if eng.backend_degraded or eng.recoveries:
        fail(f"{label}: a fault-free engine recovered {eng.recoveries} time(s) "
             f"(backend_degraded {eng.backend_degraded})")
    p = eng.last_pool_stats
    if p is not None and not p.audit_ok:
        fail(f"{label}: the pool audit failed: {p.audit_errors}")


def fault_requests(seed: int, vocab: int, priorities: bool = True):
    """Phase 4f's trace: 4e's 12 lifecycle requests (prompts, budgets and,
    unless ``priorities`` is False, their classes), the deadlines dropped:
    the schedule's faults decide who ends how."""
    out = []
    for r in make_lifecycle_requests(seed, vocab):
        r = {k: v for k, v in r.items() if k not in ("deadline_ms", "ttft_deadline_ms")}
        if not priorities:
            r.pop("priority")
        out.append(r)
    return out


class FaultRun:
    """One engine of phase 4f (paged, SLOTS slots, ample pool), warmed by
    fault-free sessions (each checked by ``fault_free``), then sessions
    under a schedule.  What a run reads comes from the engine's own
    records (the timeseries' live uids, ``last_stats["recovery_log"]``)
    and from the schedule's public queries (:class:`ProbeSchedule`)."""

    def __init__(self, model, params, spec, warm: int = FAULTS_WARM, **kw):
        from repro_torch.serve.engine import ServeEngine

        self.spec = spec
        self.eng = ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS,
                               cache_layout="paged", page_size=PAGE_SIZE, **kw)
        for i in range(warm):
            self.base = self._serve(None)[0]
            fault_free(f"faults warm-up {i}", self.eng)
        self.warm_graphs = dict(self.eng.last_graph_stats)

    def _reqs(self):
        from repro_torch.serve.engine import Request

        return [Request(**r) for r in self.spec]

    def _serve(self, faults):
        from repro_torch import kernels

        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = self.eng.serve(self._reqs(), faults=faults)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, kernels.launch_counts()

    def run(self, faults):
        """The session under ``faults``: (tokens, wall s, launch counts)."""
        out, wall, counts = self._serve(faults)
        self.out = out
        return out, wall, counts

    def live_after(self) -> dict:
        """The last session's uids decoding at each round's end."""
        ts = self.eng.last_stats["timeseries"]
        return dict(zip(ts["round"], ts["live_uids"]))

    def recovery(self):
        """The last session's first recovery (None if none): its round,
        exception, requeued uids and each one's next token in ms after it."""
        log = self.eng.last_stats["recovery_log"]
        if not log:
            return None
        e = log[0]
        return dict(rnd=e["round"], exc=e["exc"], held=e["requeued"],
                    next_token_ms={u: (t - e["t_s"]) * 1e3
                                   for u, t in e["next_token_s"].items()})

    def statuses(self):
        return {r["uid"]: self.eng.last_stats[r["uid"]]["status"] for r in self.spec}

    def no_recovery(self, label: str):
        """A run whose faults recover nothing (a straggler, a collapse):
        the engine must not have recovered or left the kernels."""
        if self.eng.recoveries or self.eng.backend_degraded:
            fail(f"{label}: {self.eng.recoveries} recoveries, degraded "
                 f"{self.eng.backend_degraded}; this run's faults recover nothing")


def probe_schedule(faults, seed):
    """``faults`` as a schedule whose public queries also record what the
    engine asked: ``alloc_rounds``, every round whose allocation asked the
    OOM hook (the rounds a hard OOM can hit), and ``at_kernel``, the launch
    counts when a ``kernel`` fault fired (the degrade follows at once)."""
    from repro_torch import kernels
    from repro_torch.serve.faults import FaultSchedule

    class ProbeSchedule(FaultSchedule):
        def oom_denied(self, rnd):
            self.alloc_rounds.add(rnd)
            return super().oom_denied(rnd)

        def kernel_at(self, rnd):
            f = super().kernel_at(rnd)
            if f is not None and self.at_kernel is None:
                self.at_kernel = kernels.launch_counts()
            return f

    sched = ProbeSchedule(faults, seed=seed)
    sched.alloc_rounds, sched.at_kernel = set(), None
    return sched


def run_faults(cfg, model, params, seed: int, smi: str, probes: dict) -> tuple:
    """Phase 4f (see the module docstring).  Returns the record, the bf16
    runs' launch counts (summed) and the fp32 runs'."""
    from repro_torch.models.lm import Model
    from repro_torch.serve.faults import Fault, FaultSchedule

    t_phase = time.perf_counter()
    spec = fault_requests(seed, cfg.vocab)
    rec, counts, counts32 = {}, {}, {}
    serving = ("rmsnorm", "flash_attention_fwd", "flash_decode", "paged_flash_decode",
               "paged_flash_verify")

    def into(c, run_counts):
        for k, v in run_counts.items():
            c[k] = c.get(k, 0) + v

    def ok_tokens(run, base):
        """Every ok request's tokens against ``base``: (agreeing, ok)."""
        oks = [u for u, s in run.statuses().items() if s == "ok"]
        return sum(run.out[u] == base[u] for u in oks), len(oks)

    # (a) nan, page corruption, cancel, a forced deadline, a soft oom and a
    # hard oom: the rounds and targets come from the fault-free serial run
    serial = FaultRun(model, params, spec, pipeline=False)
    serial.run(None)
    fault_free("faults a serial targets run", serial.eng)
    live = serial.live_after()
    early = set(live[3]) & set(live[4])
    nan_uid = min(early)
    later = [u for u in sorted(set(live[3]) & set(live[7])) if u != nan_uid]
    if len(early) < 1 or len(later) < 2:
        fail(f"faults a: too few requests live across rounds 3-7 to target: {live}")
    cancel_uid, deadline_uid = later[0], later[1]
    faults = [Fault("nan", step=3, uid=nan_uid, span=2),
              Fault("cancel", step=5, uid=cancel_uid),
              Fault("deadline", step=6, uid=deadline_uid),
              Fault("page_corruption", step=8),
              Fault("oom", step=10, span=3)]
    probe = probe_schedule(faults, seed)
    serial.run(probe)
    allocs = probe.alloc_rounds
    hard = min((r for r in allocs if r >= 14), default=None)
    if hard is None:
        fail(f"faults a: no round from 14 on allocated a page: {sorted(allocs)}")
    faults.append(Fault("oom", step=hard, raise_exc=True))
    sched = FaultSchedule(faults, seed=seed)
    print(f"faults a schedule: nan uid {nan_uid} rounds 3-4, cancel uid {cancel_uid} round "
          f"5, deadline uid {deadline_uid} round 6, page corruption round 8 (seed {seed}), "
          f"soft oom rounds 10-12, hard oom round {hard}", flush=True)
    s_out, s_wall, s_counts = serial.run(sched)
    piped = FaultRun(model, params, spec)
    p_out, p_wall, p_counts = piped.run(sched)
    into(counts, add_counts(s_counts, p_counts))
    gate = probes["paged"]["bit_for_bit"]
    same = piped.statuses() == serial.statuses() and p_out == s_out
    want = {nan_uid: "failed", cancel_uid: "cancelled", deadline_uid: "timeout"}
    sts = piped.statuses()
    p_stats = piped.eng.last_pool_stats
    agree_a, n_ok = ok_tokens(piped, piped.base)
    rec["a"] = dict(schedule=[dataclasses.asdict(f) for f in faults], statuses=sts,
                    pipelined_equals_serial=same, gated=gate,
                    recoveries=piped.eng.recoveries, serial_recoveries=serial.eng.recoveries,
                    preemptions=piped.eng.preemptions,
                    retries={u: piped.eng.last_stats[u]["retries"] for u in sts},
                    reasons={u: piped.eng.last_stats[u].get("reason") for u in sts},
                    ok_equal_fault_free_bf16=[agree_a, n_ok],
                    wall_s=p_wall, serial_wall_s=s_wall, recovery=piped.recovery(),
                    audit_ok=p_stats.audit_ok, used_pages=p_stats.used_pages)
    print(f"faults a (bf16, pipelined / serial): statuses {sts}; equal {same} "
          f"({'gated' if gate else 'reported: the paged replay probe was not bit for bit'}); "
          f"recoveries {piped.eng.recoveries} / {serial.eng.recoveries}; preemptions "
          f"{piped.eng.preemptions} / {serial.eng.preemptions}; ok requests with the "
          f"fault-free tokens {agree_a} of {n_ok} (bf16, reported: a requeue re-prefills "
          f"at another bucket, C1); {p_wall:.3f} / {s_wall:.3f} s; audit_ok "
          f"{p_stats.audit_ok}, pages in use {p_stats.used_pages}; [{smi}]", flush=True)
    if gate and not same:
        fail("faults a: the pipelined run ended other statuses or tokens than the serial one")
    for eng, label in ((piped.eng, "pipelined"), (serial.eng, "serial")):
        st = {r["uid"]: eng.last_stats[r["uid"]]["status"] for r in spec}
        if any(st[u] != s for u, s in want.items()):
            fail(f"faults a {label}: targets ended {st}, the schedule names {want}")
        if eng.recoveries != 1 or eng.backend_degraded:
            fail(f"faults a {label}: {eng.recoveries} recoveries, degraded "
                 f"{eng.backend_degraded}; the hard oom recovers once, on the kernels")
        p = eng.last_pool_stats
        if not p.audit_ok or p.used_pages:
            fail(f"faults a {label}: audit {p.audit_errors}, {p.used_pages} pages in use")
    # (e) the recovery's wall to the requeued requests' next tokens
    r = piped.recovery()
    if r is None or set(r["next_token_ms"]) != set(r["held"]):
        fail(f"faults e: the requeued requests' next tokens were not all seen: {r}")
    wall_ms = max(r["next_token_ms"].values()) if r["next_token_ms"] else 0.0
    print(f"faults e: the hard oom at round {r['rnd']} requeued {sorted(r['held'])}; their "
          f"next tokens {', '.join(f'{u} {ms:.2f}' for u, ms in sorted(r['next_token_ms'].items()))}"
          f" ms after the recovery (last {wall_ms:.2f} ms); [{smi}]", flush=True)
    rec["e"] = dict(recovery_round=r["rnd"], next_token_ms=r["next_token_ms"],
                    last_ms=wall_ms)
    del serial

    # (b) a kernel fault mid-decode: the degrade onto the plain lowering
    kfault = probe_schedule([Fault("kernel", step=6)], seed)
    deg = FaultRun(model, params, spec)
    d_out, d_wall, d_counts = deg.run(kfault)
    into(counts, d_counts)
    names = ("rmsnorm", "flash_attention_fwd", "flash_decode", "paged_flash_decode")
    deg.at_degrade = kfault.at_kernel
    after = {n: d_counts[n] - deg.at_degrade[n] for n in names} if deg.at_degrade else None
    g = deg.eng.last_graph_stats
    recaptured = {k: {n: v.get(n, 0) for n in names} for k, v in g["launches_per_replay"].items()}
    print(f"faults b (bf16, pipelined): kernel fault at round 6; backend_degraded "
          f"{deg.eng.backend_degraded}, recoveries {deg.eng.recoveries}; launches after the "
          f"degrade {after} (before it {deg.at_degrade and {n: deg.at_degrade[n] for n in names}}); "
          f"graphs dropped {g['dropped']}, re-captured {g['captured']}, their kernel launches a "
          f"replay {recaptured}; statuses {set(deg.statuses().values())}; "
          f"{d_wall:.3f} s; [{smi}]", flush=True)
    if not deg.eng.backend_degraded or deg.eng.recoveries != 1 or after is None:
        fail("faults b: the kernel fault did not degrade the engine once")
    if any(after.values()) or any(any(v.values()) for v in recaptured.values()):
        fail(f"faults b: a hand-written serving kernel launched after the degrade: {after}, "
             f"{recaptured}")
    if g["dropped"] < 1 or g["captured"] < 1:
        fail(f"faults b: the degrade dropped {g['dropped']} graphs and captured {g['captured']}")
    if deg.eng.model.use_kernels or deg.eng.verify_backend != "torch":
        fail("faults b: the degraded model still routes to the kernels")
    if set(deg.statuses().values()) != {"ok"}:
        fail(f"faults b: {deg.statuses()}")
    rec["b"] = dict(after_degrade=after, at_degrade={n: deg.at_degrade[n] for n in names},
                    graphs=g, wall_s=d_wall,
                    bf16_agreement=agreement(d_out, deg.base))
    del deg

    # (c) a straggler after >= 5 steps
    strag = FaultRun(model, params, spec)
    c_out, _, c_counts = strag.run(FaultSchedule([Fault("straggler", step=8,
                                                        sleep_s=FAULT_STRAGGLER_S)]))
    into(counts, c_counts)
    ev = strag.eng.last_stats["stragglers"]
    print(f"faults c: straggler {FAULT_STRAGGLER_S} s at round 8: events {ev}; tokens equal "
          f"the fault-free run's {c_out == strag.base}; [{smi}]", flush=True)
    if not ev or not all(e["duration_s"] > strag.eng.straggler_factor * e["median_s"]
                         for e in ev) or max(e["duration_s"] for e in ev) < FAULT_STRAGGLER_S:
        fail(f"faults c: the watchdog recorded {ev}")
    if c_out != strag.base:
        fail("faults c: a straggler moved the tokens")
    strag.no_recovery("faults c")
    rec["c"] = dict(events=ev)
    del strag

    # (d) speculation's collapse: spec_k 4, damped weights, self:1 draft
    fifo = fault_requests(seed, cfg.vocab, priorities=False)
    target = max(fifo[:SLOTS], key=lambda r: r["max_new_tokens"])["uid"]
    collapse = FaultSchedule([Fault("spec_collapse", step=0, uid=target,
                                    span=FAULT_COLLAPSE_SPAN)], seed=seed)
    damped = dict(params, layers=_scaled(params["layers"], 0.05))
    spec_kw = dict(spec_k=SPEC_K, draft="self:1", spec_disable_window=FAULT_SPEC_WINDOW,
                   spec_cooldown=FAULT_SPEC_COOLDOWN)
    sp = FaultRun(model, damped, fifo, **spec_kw)
    sp_out, _, sp_counts = sp.run(collapse)
    into(counts, sp_counts)
    s = sp.eng.last_stats[target]
    rearms = s.get("spec_rearms", 0)
    print(f"faults d (bf16): spec_collapse on uid {target} rounds 0-{FAULT_COLLAPSE_SPAN - 1}: "
          f"auto-disables {s.get('spec_auto_disables', 0)}, re-armed {rearms}, "
          f"{s.get('spec_tokens', 0)} tokens in {s.get('spec_steps', 0)} windows; tokens "
          f"equal the fault-free spec run's {agreement(sp_out, sp.base):.4f} (bf16, "
          f"reported); [{smi}]", flush=True)
    if s.get("spec_auto_disables", 0) < 1 or rearms < 1:
        fail("faults d: the governor did not disable and re-enable speculation")
    sp.no_recovery("faults d")
    rec["d"] = dict(target=target, auto_disables=s.get("spec_auto_disables", 0),
                    rearms=rearms, spec_steps=s.get("spec_steps", 0),
                    spec_tokens=s.get("spec_tokens", 0),
                    bf16_agreement=agreement(sp_out, sp.base))
    del sp

    # the fp32 controls: (a), (b) and (d) on the same weights widened
    model32, params32 = fp32_model(cfg, params)
    c32 = {}
    a32 = FaultRun(model32, params32, spec, warm=1)
    into(counts32, a32.run(sched)[2])
    agree, n_ok = ok_tokens(a32, a32.base)
    p = a32.eng.last_pool_stats
    c32["a"] = dict(agreeing=agree, ok=n_ok, recoveries=a32.eng.recoveries,
                    audit_ok=p.audit_ok, used_pages=p.used_pages, statuses=a32.statuses())
    b32 = FaultRun(model32, params32, spec, warm=1)
    into(counts32, b32.run(FaultSchedule([Fault("kernel", step=6)], seed=seed))[2])
    b_agree = agreement(b32.out, b32.base)
    c32["b"] = dict(agreement=b_agree, degraded=b32.eng.backend_degraded)
    damped32 = dict(params32, layers=_scaled(params32["layers"], 0.05))
    d32 = FaultRun(model32, damped32, fifo, warm=1, **spec_kw)
    into(counts32, d32.run(collapse)[2])
    d32.no_recovery("faults d fp32")
    c32["d"] = dict(agreement=agreement(d32.out, d32.base),
                    auto_disables=d32.eng.last_stats[target].get("spec_auto_disables", 0))
    print(f"faults fp32 control: (a) ok requests with the fault-free tokens {agree} of "
          f"{n_ok}, recoveries {a32.eng.recoveries}, audit_ok {p.audit_ok}, pages in use "
          f"{p.used_pages}, statuses {a32.statuses()}; (b) degraded "
          f"{b32.eng.backend_degraded}, tokens equal the fault-free kernel run's {b_agree:.4f}; "
          f"(d) {c32['d']['agreement']:.4f}, auto-disables {c32['d']['auto_disables']}; "
          f"[{smi}]", flush=True)
    if agree != n_ok or a32.eng.recoveries != 1 or not p.audit_ok or p.used_pages:
        fail("faults a fp32: a survivor's tokens moved, or the recovery or pool is off")
    if b_agree < 1.0:
        # the plain lowering served another token: its margin against the
        # kernels' error at that step, then fail
        plain32 = Model(cfg, device="cuda", dtype=torch.float32, use_kernels=False)
        for u in sorted(b32.base):
            if b32.out.get(u) == b32.base[u]:
                continue
            prompt = next(r["prompt"] for r in spec if r["uid"] == u)
            k = teacher_force(model32, params32, prompt, b32.base[u])
            pl = teacher_force(plain32, params32, prompt, b32.base[u])
            i = next(j for j, (x, y) in enumerate(zip(b32.out[u], b32.base[u])) if x != y)
            top = torch.topk(k[i], 2).values
            print(f"faults b fp32: uid {u} step {i}: top-2 margin "
                  f"{(top[0] - top[1]).item():.3e}, kernel vs plain logits error "
                  f"{(k[i] - pl[i]).abs().max().item():.3e}", flush=True)
        fail("faults b fp32: the degraded run served other tokens than the kernel run")
    if not b32.eng.backend_degraded:
        fail("faults b fp32: no degrade")
    if c32["d"]["agreement"] < 1.0 or c32["d"]["auto_disables"] < 1:
        fail("faults d fp32: the collapse moved a token or never tripped the governor")
    rec["fp32"] = c32
    del a32, b32, d32, model32, params32
    torch.cuda.empty_cache()

    # (e) the captured step with the fault-mask buffer the engine's steps
    # read, against the same step without it: the two profiles' kernel ms
    # (their difference is within run-to-run spread) and the select's own
    # kernel (masked_fill) a replay
    gen = torch.Generator(device="cuda").manual_seed(seed + 28)
    masks = torch.zeros(2, SLOTS, dtype=torch.bool, device="cuda")
    steps = {}
    for kind in ("dense", "paged"):
        for label, m in (("", None), ("_masked", masks)):
            name = f"{kind}_decode_step_graph{label}"
            steps[name] = graph_phase(name, model, params, kind, gen, masks=m,
                                      parts=("masked_fill",))
    cost = {k: steps[f"{k}_decode_step_graph_masked"]["device_ms"]
            - steps[f"{k}_decode_step_graph"]["device_ms"] for k in ("dense", "paged")}
    select = {k: steps[f"{k}_decode_step_graph_masked"]["parts_ms"]["masked_fill"]
              for k in ("dense", "paged")}
    shown = {k: (round(v, 5) if v > 0.0 else "not measured (no masked_fill kernel in "
                 "the profile)") for k, v in select.items()}
    print(f"faults e: the fault masks in a captured step: the select's kernel (masked_fill) "
          f"{shown} ms a replay; kernel ms with - without {cost} (two profiles); [{smi}]",
          flush=True)
    rec["e"]["mask_cost_ms"] = cost
    rec["e"]["select_ms"] = select
    rec["e"]["steps"] = {k: dict(wall_ms=v["wall_ms"], device_ms=v["device_ms"])
                         for k, v in steps.items()}
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"faults phase: {rec['wall_s']:.1f} s; [{smi}]", flush=True)
    return rec, counts, counts32


# ---------------------------------------------------------------------------
# phase 4g: open-loop serving
# ---------------------------------------------------------------------------
OPENLOOP_N = 16
OPENLOOP_ROUND_S = 1.0 / 8    # (a): the round clock, a mean arrival every 8 rounds
OPENLOOP_RATES = (0.25, 0.5, 1.0, 2.0)   # (b): multiples of R, the closed batch's rate
OPENLOOP_MAX_QUEUE = 8
OPENLOOP_TIGHT_PAGES = 56     # (a)'s fp32 pool that this workload fills: it preempts
OPENLOOP_WATERMARK = 2        # (d): submit() awaits at this depth ...
OPENLOOP_BP_QUEUE = 3         # ... against this bound
OPENLOOP_CLI_REQUESTS = 12
DEGRADE_KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_decode", "paged_flash_decode")


def openloop_workload(seed: int, vocab: int, kind: str = "poisson"):
    """Phase 4g's 16 requests from ``serve.workload.make_workload``: prompts
    of median 128 (at most 512) tokens, median 32 (at most 64) new, at one
    arrival a second; a run rescales the arrival times."""
    from repro_torch.serve.workload import make_workload

    return make_workload(kind, OPENLOOP_N, vocab=vocab, seed=seed + 29, rate=1.0,
                         prompt_median=128, prompt_max=512, out_median=32, out_max=64)


def retimed(timed, scale: float = 1.0):
    """Fresh copies of ``timed`` (a session appends to each request's
    ``generated``), arrival times multiplied by ``scale``."""
    return [dataclasses.replace(t, arrival_s=t.arrival_s * scale,
                                request=dataclasses.replace(t.request, generated=None))
            for t in timed]


def admission_round_walls(ts, walls: dict) -> tuple:
    """The percentiles of the rounds' own walls (ms, ``walls`` by round) of
    the busy rounds that admitted a request (a uid decoding at the round's
    end that did not at the last round's) and of the other busy rounds
    (some uid decoding at the round's end)."""
    from repro_torch.serve import sla

    live, rnd = ts["live_uids"], ts["round"]
    adm, other = [], []
    for i in range(1, len(live)):
        if live[i] and rnd[i] in walls:
            (adm if set(live[i]) - set(live[i - 1]) else other).append(walls[rnd[i]])
    return sla.percentiles(adm), sla.percentiles(other)


def prefill_buckets(groups, uid) -> list:
    """The buckets of every prefill call of a session that held ``uid``."""
    return [b for uids, b, _ in groups if uid in uids]


class OpenLoopEngine:
    """One paged engine of phase 4g (SLOTS slots, MAX_SEQ, 16-token pages);
    each closed or open-loop session on it is timed, with its launch
    counts, and must end with its statuses partitioning the requests and
    its pool audit-clean with no page in use."""

    def __init__(self, model, params, **kw):
        from repro_torch.serve.engine import ServeEngine

        self.eng = ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS,
                               cache_layout="paged", page_size=PAGE_SIZE, **kw)
        # each round's own host wall, ms by round (the timeseries' stamps
        # also span the idle waits between wall-clock arrivals)
        self.round_ms = {}
        dispatch = self.eng.dispatch_round

        def timed_round(st):
            t0 = time.perf_counter()
            dispatch(st)
            self.round_ms[st.rnd] = (time.perf_counter() - t0) * 1e3

        self.eng.dispatch_round = timed_round

    def _timed(self, label, timed, fn):
        from repro_torch import kernels
        from repro_torch.serve.engine import TERMINAL_STATUSES

        torch.cuda.synchronize()
        kernels.reset_launches()
        self.round_ms = {}
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        no_ragged_rmsnorm(label, counts)
        st = self.eng.last_stats
        sts = {t.request.uid: st[t.request.uid]["status"] for t in timed}
        if any(s not in TERMINAL_STATUSES for s in sts.values()):
            fail(f"{label}: a request has no terminal status: {sts}")
        if any(sts[u] != "ok" for u in out) or len(out) != sum(s == "ok" for s in sts.values()):
            fail(f"{label}: the OK tokens {sorted(out)} are not the OK statuses {sts}")
        p = self.eng.last_pool_stats
        if not p.audit_ok or p.used_pages:
            fail(f"{label}: audit {p.audit_errors}, {p.used_pages} pages in use")
        self.statuses = sts
        return out, wall, counts

    def closed(self, label, timed, uids=None):
        """A closed ``serve()`` of the requests (those in ``uids``)."""
        if uids is not None:
            timed = [t for t in timed if t.request.uid in uids]
        reqs = [dataclasses.replace(t.request, generated=None) for t in timed]
        return self._timed(label, timed, lambda: self.eng.serve(reqs))

    def open(self, label, timed, clock, round_time_s=1.0, scale=1.0, faults=None):
        """``serve_open_loop`` of the requests at their arrival times times
        ``scale``, on the ``clock``."""
        from repro_torch.serve.async_engine import serve_open_loop

        wl = retimed(timed, scale)
        return self._timed(label, wl, lambda: asyncio.run(serve_open_loop(
            self.eng, wl, faults=faults, clock=clock, round_time_s=round_time_s)))


def live_across(live: dict, start: int, gap: int, skip=()) -> tuple:
    """The first round from ``start`` with a uid (not in ``skip``) decoding
    at it and ``gap`` rounds later, and that uid: (None, None) if none."""
    for r in sorted(x for x in live if x >= start):
        both = sorted(set(live[r]) & set(live.get(r + gap, ())) - set(skip))
        if both:
            return r, both[0]
    return None, None


def agree_on(a: dict, b: dict) -> float:
    """``agreement`` over the uids both hold."""
    common = [u for u in a if u in b]
    return agreement({u: a[u] for u in common}, b) if common else 0.0


def run_openloop(cfg, model, params, seed: int, smi: str, num_pages: int) -> tuple:
    """Phase 4g (see the module docstring).  Returns the record, the bf16
    runs' launch counts (summed) and the fp32 runs'."""
    import os

    from repro_torch.serve.async_engine import AsyncServeEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.faults import Fault
    from repro_torch.serve.workload import describe

    t_phase = time.perf_counter()
    timed = openloop_workload(seed, cfg.vocab)
    d = describe(timed)
    print(f"openloop requests: {OPENLOOP_N} poisson, prompts "
          f"{[len(t.request.prompt) for t in timed]} tokens, new "
          f"{[t.request.max_new_tokens for t in timed]}; slots {SLOTS}, max_seq {MAX_SEQ}, "
          f"{PAGE_SIZE}-token pages", flush=True)
    rec, counts, counts32 = dict(workload=d), {}, {}

    def into(c, *runs):
        for run_counts in runs:
            for k, v in run_counts.items():
                c[k] = c.get(k, 0) + v

    # (a) the round clock: streamed tokens against a closed serve of the same
    # requests on the same engine (the closed serve first: it captures)
    amp = OpenLoopEngine(model, params)
    closed, _, c1 = amp.closed("openloop a bf16 closed", timed)
    closed_groups = list(amp.eng.last_prefill_groups)
    ok, o_wall, c2 = amp.open("openloop a bf16", timed, "round", OPENLOOP_ROUND_S)
    open_groups = list(amp.eng.last_prefill_groups)
    into(counts, c1, c2)
    fault_free("openloop a bf16", amp.eng)
    if set(amp.statuses.values()) != {"ok"}:
        fail(f"openloop a bf16: statuses {amp.statuses}")
    same = {u: ok.get(u) == closed[u] for u in sorted(closed)}
    differ = {u: dict(closed=prefill_buckets(closed_groups, u),
                      open=prefill_buckets(open_groups, u))
              for u, s in same.items() if not s}
    rnds = len(amp.eng.last_stats["timeseries"]["round"])
    print(f"openloop a (bf16, round clock, a mean arrival every {1 / OPENLOOP_ROUND_S:g} rounds, "
          f"ample pool): {rnds} rounds in {o_wall:.3f} s; statuses all ok; audit clean, 0 "
          f"pages in use; requests with the closed serve's tokens {sum(same.values())} of "
          f"{len(same)} (bf16, reported: open-loop admission forms other prefill groups, C1); "
          f"prefill buckets of those that differ (closed, open): {differ}; [{smi}]", flush=True)
    rec["a"] = dict(bf16=dict(same=same, differ=differ, rounds=rnds, wall_s=o_wall,
                              preemptions=amp.eng.preemptions))
    model32, params32 = fp32_model(cfg, params)
    a32 = {}
    engines32 = {"ample": OpenLoopEngine(model32, params32),
                 f"{num_pages}-page": OpenLoopEngine(model32, params32, num_pages=num_pages),
                 f"{OPENLOOP_TIGHT_PAGES}-page": OpenLoopEngine(
                     model32, params32, num_pages=OPENLOOP_TIGHT_PAGES)}
    closed32 = {}
    for label, e in engines32.items():
        want, _, c1 = e.closed(f"openloop a fp32 {label} closed", timed)
        got, wall, c2 = e.open(f"openloop a fp32 {label}", timed, "round", OPENLOOP_ROUND_S)
        into(counts32, c1, c2)
        fault_free(f"openloop a fp32 {label}", e.eng)
        if set(e.statuses.values()) != {"ok"} or got != want:
            fail(f"openloop a fp32 {label}: statuses {e.statuses}; streamed tokens equal "
                 f"the closed serve's {agree_on(got, want):.4f}")
        closed32[label] = want
        a32[label] = dict(preemptions=e.eng.preemptions, wall_s=wall,
                          swap_outs=e.eng.last_pool_stats.swap_outs)
    print(f"openloop a fp32 control (round clock): the ample, {num_pages}-page and "
          f"{OPENLOOP_TIGHT_PAGES}-page pools stream the closed serve's tokens, every status "
          f"ok, pools clean; preemptions in the open sessions "
          f"{ {k: v['preemptions'] for k, v in a32.items()} }; [{smi}]", flush=True)
    if a32[f"{OPENLOOP_TIGHT_PAGES}-page"]["preemptions"] < 1:
        fail(f"openloop a fp32: the {OPENLOOP_TIGHT_PAGES}-page pool was sized to preempt "
             f"and did not")
    rec["a"]["fp32"] = a32

    # (b) the wall clock: R from a closed batch on the warmed engine, then
    # Poisson arrivals at multiples of R with max_queue 8
    _, r_wall, c1 = amp.closed("openloop b closed batch", timed)
    into(counts, c1)
    closed_rounds = len(amp.eng.last_stats["timeseries"]["round"])
    big_r = OPENLOOP_N / r_wall
    round_s = r_wall / closed_rounds
    print(f"openloop b: R = {big_r:.2f} requests/s ({OPENLOOP_N} requests in {r_wall:.3f} s "
          f"closed, {closed_rounds} rounds, {round_s * 1e3:.3f} ms a round); [{smi}]",
          flush=True)
    lad = OpenLoopEngine(model, params, max_queue=OPENLOOP_MAX_QUEUE)
    for half in (timed[:OPENLOOP_N // 2], timed[OPENLOOP_N // 2:]):
        into(counts, lad.closed("openloop b warm-up", half)[2])
    ladder = {}
    for mult in OPENLOOP_RATES:
        rate = mult * big_r
        got, wall, c = lad.open(f"openloop b {mult:g}R", timed, "wall", scale=1.0 / rate)
        into(counts, c)
        fault_free(f"openloop b {mult:g}R", lad.eng)
        st = lad.eng.last_stats
        s = st["sla"]
        adm_w, other_w = admission_round_walls(st["timeseries"], lad.round_ms)
        ttft, tbt = s["ttft_ms"], s["tbt_ms"]
        captured = lad.eng.last_graph_stats["captured"]
        ladder[f"{mult:g}R"] = dict(rate=rate, ttft_ms=ttft, tbt_ms=tbt,
                                    goodput_tok_s=s["goodput_tok_s"], statuses=s["statuses"],
                                    wall_s=wall, admission_round_ms=adm_w,
                                    other_round_ms=other_w, graphs_captured=captured)
        print(f"openloop b {mult:g}R ({rate:.2f} req/s, wall clock, max_queue "
              f"{OPENLOOP_MAX_QUEUE}): TTFT p50 {ttft['p50']:.2f} p95 {ttft['p95']:.2f} p99 "
              f"{ttft['p99']:.2f} ms; TBT p50 {tbt['p50']:.2f} p99 {tbt['p99']:.2f} max "
              f"{tbt['max']:.2f} ms (n {tbt['n']}); goodput {s['goodput_tok_s']:.1f} tok/s; "
              f"statuses {s['statuses']}; a busy round's wall p50 with an admission "
              f"{adm_w['p50'] or 0:.2f} ms (max {adm_w['max'] or 0:.2f}, n {adm_w['n']}), "
              f"without {other_w['p50'] or 0:.2f} ms (max {other_w['max'] or 0:.2f}, n "
              f"{other_w['n']}); graphs captured in the session {captured}; {wall:.3f} s; "
              f"[{smi}]", flush=True)
    got32, _, c = engines32["ample"].open("openloop b fp32 1R", timed, "wall", scale=1.0 / big_r)
    into(counts32, c)
    ok32 = {u: closed32["ample"][u] for u in got32}
    print(f"openloop b fp32 control (1R, wall clock): statuses "
          f"{engines32['ample'].eng.last_stats['sla']['statuses']}; OK tokens equal the "
          f"closed serve's {agree_on(got32, ok32):.4f}; [{smi}]", flush=True)
    if got32 != ok32:
        fail("openloop b fp32: a wall-clock stream differs from the closed serve")
    rec["b"] = dict(R=big_r, closed_wall_s=r_wall, round_ms=round_s * 1e3, ladder=ladder)

    # (c) chaos: bursty arrivals at 2R on the round clock (R's round time),
    # audit on, max_queue 8, a NaN, a cancel, a hard OOM and a kernel fault.
    # The rounds come from probe runs: a fault-free one (NaN and cancel
    # targets), then one under those two (the rounds that allocate, for the
    # hard OOM, and those with live rows, for the kernel fault)
    burst = openloop_workload(seed, cfg.vocab, "bursty")
    chaos_kw = dict(clock="round", round_time_s=round_s, scale=1.0 / (2 * big_r))

    def chaos_probe(label, faults):
        sched = probe_schedule(faults, seed)
        e = OpenLoopEngine(model, params, max_queue=OPENLOOP_MAX_QUEUE, audit=True)
        into(counts, e.open(label, burst, faults=sched, **chaos_kw)[2])
        ts = e.eng.last_stats["timeseries"]
        return dict(zip(ts["round"], ts["live_uids"])), sched.alloc_rounds

    live, _ = chaos_probe("openloop c fault-free probe", [])
    first = min((r for r, u in live.items() if u), default=0)
    nan_r, nan_uid = live_across(live, first + 2, 1)
    cancel_r, cancel_uid = live_across(live, first + 4, 8, skip=(nan_uid,))
    if nan_r is None or cancel_r is None:
        fail(f"openloop c: no NaN or cancel target in the fault-free run: {live}")
    faults = [Fault("nan", step=nan_r, uid=nan_uid, span=2),
              Fault("cancel", step=cancel_r, uid=cancel_uid)]
    live, allocs = chaos_probe("openloop c nan and cancel probe", faults)
    oom_r = min((r for r in allocs if r >= cancel_r + 2), default=None)
    kernel_r = min((r for r, u in live.items() if u and oom_r is not None and r >= oom_r + 4),
                   default=None)
    if oom_r is None or kernel_r is None:
        fail(f"openloop c: no allocating round from {cancel_r + 2} ({sorted(allocs)}) or no "
             f"live round 4 after it: {live}")
    faults += [Fault("oom", step=oom_r, raise_exc=True), Fault("kernel", step=kernel_r)]
    print(f"openloop c schedule (bursty, 2R, round clock, {round_s * 1e3:.3f} ms a round): "
          f"nan uid {nan_uid} rounds {nan_r}-{nan_r + 1}, cancel uid {cancel_uid} round "
          f"{cancel_r}, hard oom round {oom_r}, kernel fault round {kernel_r}", flush=True)
    c_rec = {}
    for label, m, p, c_acc in (("bf16", model, params, counts),
                               ("fp32", model32, params32, counts32)):
        sched = probe_schedule(faults, seed)
        e = OpenLoopEngine(m, p, max_queue=OPENLOOP_MAX_QUEUE, audit=True)
        got, wall, c = e.open(f"openloop c {label}", burst, faults=sched, **chaos_kw)
        into(c_acc, c)
        sts = e.statuses
        at = sched.at_kernel
        after = {n: c[n] - at[n] for n in DEGRADE_KERNELS} if at else None
        g = e.eng.last_graph_stats
        recaptured = {k: {n: v.get(n, 0) for n in DEGRADE_KERNELS}
                      for k, v in g["launches_per_replay"].items()}
        ref_eng = amp if label == "bf16" else engines32["ample"]
        want, _, c2 = ref_eng.closed(f"openloop c {label} fault-free closed", burst,
                                     uids=set(got))
        into(c_acc, c2)
        agree = agree_on(got, want)
        census = e.eng.last_stats["sla"]["statuses"]
        c_rec[label] = dict(statuses=sts, census=census, recoveries=e.eng.recoveries,
                            degraded=e.eng.backend_degraded, after_degrade=after,
                            survivors_equal_fault_free=agree, wall_s=wall)
        print(f"openloop c {label}: statuses {census} (nan uid {nan_uid} {sts[nan_uid]}, "
              f"cancel uid {cancel_uid} {sts[cancel_uid]}); recoveries {e.eng.recoveries}, "
              f"degraded {e.eng.backend_degraded}; launches after the degrade {after}; "
              f"re-captured graphs' launches {recaptured}; audit clean, 0 pages in use; "
              f"survivors with the fault-free closed serve's tokens {agree:.4f} "
              f"({'gated' if label == 'fp32' else 'reported, C1'}); {wall:.3f} s; [{smi}]",
              flush=True)
        if sts[cancel_uid] != "cancelled":
            fail(f"openloop c {label}: the cancel target ended {sts[cancel_uid]}")
        if not e.eng.backend_degraded or after is None or any(after.values()) or any(
                any(v.values()) for v in recaptured.values()):
            fail(f"openloop c {label}: the kernel fault did not degrade the engine off the "
                 f"kernels: after {after}, re-captured {recaptured}")
        if label == "fp32" and agree < 1.0:
            fail("openloop c fp32: a survivor's tokens differ from the fault-free serve")
        del e
    rec["c"] = dict(schedule=[dataclasses.asdict(f) for f in faults], **c_rec)
    del engines32, model32, params32
    torch.cuda.empty_cache()

    # (d) backpressure: the 16 requests submitted in one burst against
    # max_queue 3, with and without the watermark 2
    async def burst_submit(eng, watermark, seen):
        async with AsyncServeEngine(eng, backpressure_watermark=watermark) as srv:
            streams = []
            for t in retimed(timed):
                streams.append(await srv.submit(t.request))
                seen["peak"] = max(seen["peak"], srv._depth())
            for s in streams:
                await s.drain()
            return await srv.close()

    d_rec = {}
    for label, wm in (("watermark", OPENLOOP_WATERMARK), ("none", None)):
        e = OpenLoopEngine(model, params, max_queue=OPENLOOP_BP_QUEUE)
        seen = dict(peak=0)
        _, wall, c = e._timed(f"openloop d {label}", timed,
                              lambda: asyncio.run(burst_submit(e.eng, wm, seen)))
        into(counts, c)
        peak = seen["peak"]
        depth = max(e.eng.last_stats["timeseries"]["queue_depth"])
        census = e.eng.last_stats["sla"]["statuses"]
        d_rec[label] = dict(statuses=census, peak_submit_depth=peak, peak_queue_depth=depth)
        print(f"openloop d {label} (watermark {wm}, max_queue {OPENLOOP_BP_QUEUE}): statuses "
              f"{census}; the depth at each submit peaked at {peak}, the engine's queue at "
              f"{depth}; {wall:.3f} s; [{smi}]", flush=True)
    if (d_rec["watermark"]["peak_submit_depth"] > OPENLOOP_WATERMARK
            or d_rec["watermark"]["peak_queue_depth"] > OPENLOOP_WATERMARK
            or d_rec["watermark"]["statuses"] != {"ok": OPENLOOP_N}):
        fail(f"openloop d: the watermark did not hold the burst: {d_rec['watermark']}")
    if "shed" not in d_rec["none"]["statuses"]:
        fail(f"openloop d: without the watermark the burst shed nothing: {d_rec['none']}")
    rec["d"] = d_rec

    # (e) preempt_calibrate on the full-width paged engine, the 105-page pool
    spec8 = make_requests(seed, cfg.vocab)
    pool_kw = dict(cache_layout="paged", page_size=PAGE_SIZE, num_pages=num_pages)
    t0 = time.perf_counter()
    cal = ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS, preempt="auto",
                      preempt_calibrate=True, **pool_kw)
    calib_s = time.perf_counter() - t0
    cm = cal.cost_model
    from repro_torch import kernels
    from repro_torch.serve.engine import Request

    kernels.reset_launches()
    auto = cal.serve([Request(u, list(p), n) for u, p, n in spec8])
    torch.cuda.synchronize()
    into(counts, kernels.launch_counts())
    fault_free("openloop e calibrated", cal)
    if any(len(auto.get(u, [])) != n for u, _, n in spec8):
        fail(f"openloop e: the calibrated run did not serve every request: {cal.last_stats}")
    pool = cal._dev["pool"]
    per_token = sum(t.numel() * t.element_size() for t in pool.values()) / (
        pool["k_pages"].shape[1] * PAGE_SIZE)
    swap_s, recompute_s = per_token / cm.swap_gbps, 2.0 * cal._n_params / cm.decode_flops_s
    policy = "swap" if swap_s < recompute_s else "requeue"
    explicit, x_eng, c, _, _ = serve(model, params, spec8, preempt=policy, **pool_kw)
    into(counts, c)
    e_rec = dict(swap_gb_s=cm.swap_gbps / 1e9, decode_gflop_s=cm.decode_flops_s / 1e9,
                 calibrate_s=calib_s, bytes_per_token=per_token, swap_s_per_token=swap_s,
                 recompute_s_per_token=recompute_s, policy=policy,
                 preemptions=cal.preemptions, swap_outs=cal.last_pool_stats.swap_outs,
                 explicit_swap_outs=x_eng.last_pool_stats.swap_outs)
    print(f"openloop e: preempt_calibrate measured swap {e_rec['swap_gb_s']:.3f} GB/s and "
          f"decode {e_rec['decode_gflop_s']:.3f} GFLOP/s (the eager single-slot step) in "
          f"{calib_s:.3f} s of engine construction; {per_token:.0f} B a token: swap "
          f"{swap_s * 1e6:.3f} us against recompute {recompute_s * 1e6:.3f} us a token, so "
          f"preempt=auto takes {policy} on the {num_pages}-page pool ({cal.preemptions} "
          f"preemptions, {e_rec['swap_outs']} swap-outs; explicit {policy}: "
          f"{x_eng.preemptions}, {e_rec['explicit_swap_outs']}); tokens equal the explicit "
          f"run's {auto == explicit}; [{smi}]", flush=True)
    if cm.source != "measured" or auto != explicit:
        fail(f"openloop e: the calibrated auto run ({cm.source}) served other tokens than "
             f"preempt={policy}")
    rec["e"] = e_rec
    del cal, x_eng

    # (f) the serve CLI on the card, open-loop on the round clock
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
           "--cache-layout", "paged", "--workload", "poisson", "--clock", "round",
           "--requests", str(OPENLOOP_CLI_REQUESTS), "--preempt", "auto",
           "--preempt-calibrate"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    cli_s = time.perf_counter() - t0
    lines = run.stdout.splitlines()
    keep = [ln for ln in lines if ln.startswith((
        "calibrated", "workload", "  ttft", "  tbt", "  goodput", "  statuses", "lifecycle",
        "pool", "tiered")) or "tok/s (" in ln]
    print(f"openloop f: {' '.join(cmd[1:])}: exit {run.returncode} in {cli_s:.1f} s; "
          f"[{smi}]\n" + "\n".join(keep), flush=True)
    if run.returncode != 0 or "SLA:" not in run.stdout:
        fail(f"openloop f: the serve CLI exited {run.returncode} or printed no SLA block: "
             f"{run.stderr[-2000:]}")
    rec["f"] = dict(returncode=run.returncode, wall_s=cli_s, lines=keep)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"openloop phase: {rec['wall_s']:.1f} s; [{smi}]", flush=True)
    return rec, counts, counts32


# ---------------------------------------------------------------------------
# phase 3b: MoE serving through moe_gating
# ---------------------------------------------------------------------------

def gating_edges(e: int) -> torch.Tensor:
    """f32 router-logit rows (9, E) at the Pallas kernel's edges, each
    with the experts its rounds select at top_k >= 4 where they do not
    depend on k: all ties (the lowest ids); a NaN (nothing, NaN weights);
    all -inf (expert 0); -inf with 2, +0 and -0 above -1e30 and -1e30
    itself below and above them (those three and, exact in f32 only, the
    -1e30 below: 1, 9, 10, 12); -inf with one value and -1e30 only above
    it (3); -3e38 with -inf at id 0 (1: nothing above -1e30, the lowest
    id of the max); +inf among normals (NaN weights); +0/-0 ties behind
    two ones; all -1e30 (0)."""
    g = torch.Generator().manual_seed(e)
    x = torch.full((9, e), float("-inf"))
    x[0] = 0.0
    x[1] = torch.randn(e, generator=g) * 2
    x[1, e // 3] = float("nan")
    x[3, [1, 9, 10, 12, e - 1]] = torch.tensor([NEG_SENTINEL, 2.0, -0.0, 0.0, NEG_SENTINEL])
    x[4, [3, 5, 7]] = torch.tensor([1.0, NEG_SENTINEL, -3e38])
    x[5] = -3e38
    x[5, 0] = float("-inf")
    x[6] = torch.randn(e, generator=g) * 2
    x[6, 4] = float("inf")
    x[7, 0::2], x[7, 1::2] = 0.0, -0.0
    x[7, e - 2:] = 1.0
    x[8] = NEG_SENTINEL
    return x


# the edge rows' selections that do not depend on bf16 rounding: row ->
# the selected ids in f32 ("k": the lowest k ids) and in bf16, where
# -1e30 rounds to -1.00026e30, below the sentinel
GATING_EDGE_PICKS = {0: ("k", "k"), 1: ((), ()), 2: ((0,), (0,)),
                     3: ((1, 9, 10, 12), (9, 10, 12)), 4: ((3,), (3,)),
                     5: ((1,), (1,)), 8: ((0,), (0,))}


def gating_logits(gen: torch.Generator, t: int, e: int) -> torch.Tensor:
    """f32 router logits (t, E), N(0, 4), the edge rows first as far as t
    allows (``gating_edges``); the caller rounds them to bf16, which ties
    many more lanes."""
    x = torch.randn(t, e, generator=gen, device="cuda") * 2
    edges = gating_edges(e)[:t].cuda()
    x[:len(edges)] = edges
    return x


def gating_agreement(x: torch.Tensor, k: int) -> dict:
    """The kernel against both plain versions (the rounds and the rank
    closed form): masks equal, weights within GATING_TOL and NaN where
    they have NaN; the plain versions against each other bit for bit; and
    the edge rows' picks (GATING_EDGE_PICKS)."""
    from repro_torch.kernels.moe_gating.ops import moe_gating
    from repro_torch.kernels.moe_gating.ref import moe_gating_rank_ref, moe_gating_ref

    w, m = moe_gating(x, k)
    (wr, mr), (wq, mq) = moe_gating_ref(x, k), moe_gating_rank_ref(x, k)
    torch.cuda.synchronize()
    out = {name: torch.equal(m, mp) and torch.allclose(w, wp, equal_nan=True, **GATING_TOL)
           for name, (wp, mp) in (("rounds", (wr, mr)), ("rank", (wq, mq)))}
    out["plain_bits"] = (torch.equal(mr, mq)
                         and torch.equal(wr.nan_to_num(nan=-1.0), wq.nan_to_num(nan=-1.0)))
    picks = []
    for row, want in GATING_EDGE_PICKS.items():
        if row < x.shape[0]:
            ids = want[x.dtype == torch.bfloat16]
            ids = tuple(range(k)) if ids == "k" else ids
            picks.append(m[row].nonzero().flatten().tolist() == list(ids))
    nan_rows = [r for r in (1, 6) if r < x.shape[0]]
    out["edge_rows"] = all(picks) and bool(torch.isnan(w[nan_rows]).all())
    out["max_abs_err"] = max_err(w.nan_to_num(nan=-1.0), wr.nan_to_num(nan=-1.0))
    return out


def check_moe_gating(cfg, gen: torch.Generator) -> dict:
    """``moe_gating`` at OLMoE's decode shape (4 slots) and its prefill
    shape (512 tokens), bf16, the edge rows first: held against both plain
    versions there and on the same values in f32 (where -1e30 is exact);
    each shape timed with the calls queued (the card's time), beside an
    empty launch queued the same way, the host-paced time, the wrapper's
    host time a call, the bound and the plain time.  Returns the prefill
    shape's kernel row and the readings of both shapes."""
    from repro_torch.kernels.moe_gating.ops import moe_gating
    from repro_torch.kernels.moe_gating.ref import moe_gating_ref

    e, k = cfg.n_experts, cfg.top_k
    empty_ms = queued_ms(lambda: torch.cuda._sleep(0))
    readings, rows = {}, {}
    for shape, t in (("decode", SLOTS), ("prefill", 512)):
        xf = gating_logits(gen, t, e)
        x = xf.to(torch.bfloat16)
        agree = {dt: gating_agreement(v, k) for dt, v in (("bf16", x), ("f32", xf))}
        n = 1000
        t0 = time.perf_counter()
        for _ in range(n):
            moe_gating(x, k)
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        # bytes: bf16 logits in, f32 weights and int32 mask out;
        # operations: two compares (>, ==) a rival for each expert's rank,
        # ~4 for the softmax
        r = dict(ms=queued_ms(lambda: moe_gating(x, k)),
                 host_paced_ms=cuda_ms(lambda: moe_gating(x, k)), host_ms=host_ms,
                 empty_launch_ms=empty_ms, plain_ms=cuda_ms(lambda: moe_gating_ref(x, k)),
                 agreement=agree)
        r["bound_ms"], r["bound_by"] = bound(t * e * (2 + 4 + 4), t * e * (2 * e + 4),
                                             F32_FLOPS_S)
        readings[shape] = r
        print(f"kernel moe_gating {shape} {t} x {e} bf16 k {k}: ms={r['ms']:.4f} (calls "
              f"queued) empty_launch_ms={empty_ms:.4f} host_paced_ms="
              f"{r['host_paced_ms']:.4f} host_ms={host_ms:.4f} (wrapper, a call) "
              f"bound_ms={r['bound_ms']:.7f} ({r['bound_by']}) plain_ms={r['plain_ms']:.4f}; "
              + "; ".join(f"{dt}: {a}" for dt, a in agree.items()), flush=True)
        if not all(a[c] for a in agree.values()
                   for c in ("rounds", "rank", "plain_bits", "edge_rows")):
            fail(f"moe_gating disagrees with a plain version or an edge rule at the "
                 f"{shape} shape")

    def flat(wm):      # NaN weights as -1, which no weight takes
        return torch.cat([wm[0].nan_to_num(nan=-1.0).flatten(), wm[1].float().flatten()])

    def library():   # the same selection by other means: 3 calls, ties unordered
        v, i = torch.topk(x.float(), k)
        return torch.zeros(x.shape, device="cuda").scatter_(1, i, torch.softmax(v, -1))

    pre = readings["prefill"]
    record_kernel(rows, "moe_gating", "src/repro_torch/kernels/moe_gating/moe_gating.cu",
                  "src/repro/kernels/moe_gating/moe_gating.py:48",
                  flat(moe_gating(x, k)), flat(moe_gating_ref(x, k)), GATING_TOL,
                  pre["ms"], pre["plain_ms"], x.shape[0] * e * (2 + 4 + 4),
                  x.shape[0] * e * (2 * e + 4), F32_FLOPS_S, None)
    print(f"kernel moe_gating: library_ms none (no one PyTorch call computes it: "
          f"torch.topk + softmax + scatter_ is three, and topk orders ties its own "
          f"way); those three take {queued_ms(library):.4f} ms queued, for scale",
          flush=True)
    return rows, readings


def check_moe_shapes(cfg, gen: torch.Generator, rows: dict) -> dict:
    """The serving kernels at the shapes OLMoE gives them, which the kernel
    phase (qwen2's shapes) does not reach: the flash forward at G = 1 and
    an exact, odd prompt length; dense and paged decode at G = 1 (one
    query head per KV head: 16/16, d_head 128) at the serving positions;
    the spec_k = 4 verify window at G = 1 (T*G = 4 rows a KV head) on
    bf16 pages (its own row of the kernel record, ``paged_flash_verify
    (G=1)``, whose launches are the MoE speculation's) and int8 pages;
    rmsnorm over one 512-token prompt's bf16 rows of d_model 2048.  Each
    against its plain version at KERNEL_TOL, timed; dense decode also
    beside SDPA on the same inputs (for scale) and its bound.  Returns the
    readings by name."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import flash_decode, paged_flash_decode
    from repro_torch.kernels.decode_attention.ref import (
        flash_decode_ref,
        paged_flash_decode_ref,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.verify_attention.ops import paged_flash_verify
    from repro_torch.kernels.verify_attention.ref import paged_verify_attention_ref
    from repro_torch.serve.kv_cache import quantize_kv_rows

    hkv, dh = cfg.n_kv_heads, cfg.d_head
    g = cfg.n_heads // hkv
    out = {}

    def check(name, fn, ref, *args, tol=KERNEL_TOL, queued=False):
        got, want = fn(*args), ref(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ms, plain_ms = (cuda_ms(lambda: f(*args), iters=DECODE_ITERS if queued else 20,
                                queued=queued)
                        for f in (fn, ref))
        print(f"kernel {name} (OLMoE): max_abs_err={err:.3e} tol={tol} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}", flush=True)
        if not agrees(got, want, tol):
            fail(f"{name} disagrees with its plain version at OLMoE's shape")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = (randn(1, 300, hkv * g, dh) for _ in "qkv")
    check("flash_attention_fwd G=1 S 300", lambda *a: flash_attention_fwd(*a)[0],
          lambda *a: flash_attention_ref(*a)[0], q, k, v)
    check("flash_attention_fwd lse G=1 S 300", lambda *a: flash_attention_fwd(*a)[1],
          lambda *a: flash_attention_ref(*a)[1], q, k, v, tol=dict(atol=1e-3, rtol=0.0))
    qd, kv_view, vv_view, kp, vp, bt, pos = decode_case(gen, hkv, g, dh)
    # every decode time here is the card's (the calls queued); for scale
    # only (the port never calls it): SDPA on the same slots, positions and
    # cache view, and the least time the card could take
    check(f"flash_decode G={g}", flash_decode, flash_decode_ref, qd, kv_view, vv_view, pos,
          queued=True)
    mask = (torch.arange(ATTEND, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    q4 = qd.reshape(SLOTS, 1, hkv * g, dh).transpose(1, 2)
    live = int((pos + 1).sum())
    dec_bytes = (2 * qd.numel() + 2 * live * hkv * dh) * 2
    sdpa_ms = queued_ms(lambda: F.scaled_dot_product_attention(
        q4, kv_view.transpose(1, 2), vv_view.transpose(1, 2), attn_mask=mask,
        enable_gqa=True))
    check(f"paged_flash_decode G={g}", paged_flash_decode, paged_flash_decode_ref,
          qd, kp, vp, bt, pos, queued=True)
    tables = int((pos // PAGE_SIZE + 1).sum()) * 4
    for name, n_bytes, lib in ((f"flash_decode G={g}", dec_bytes, sdpa_ms),
                               (f"paged_flash_decode G={g}", dec_bytes + tables, None)):
        r = out[name]
        r["library_ms"], r["sdpa_ms"] = lib, sdpa_ms
        r["bound_ms"], r["bound_by"] = bound(n_bytes, 4 * dh * hkv * g * live, BF16_FLOPS_S)
        print(f"kernel {name} (OLMoE): bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={'none' if lib is None else f'{lib:.4f}'}", flush=True)
        sdpa_factor(f"{name} (OLMoE)", r["ms"], sdpa_ms)
    # the MoE target's verify window: spec_k = 4 at G = 1, keys up to
    # pos + T - 1; bytes and operations counted as the qwen2 row's
    t_w = SPEC_K
    qv = randn(SLOTS, hkv, t_w * g, dh)
    keys = pos.long() + t_w
    ver_bytes = ((2 * qv.numel() + 2 * int(keys.sum()) * hkv * dh) * 2
                 + int(((keys - 1) // PAGE_SIZE + 1).sum()) * 4)
    ver_flops = 4 * dh * hkv * g * sum(int(p) + t + 1 for p in pos.tolist()
                                       for t in range(t_w))
    record_kernel(rows, f"paged_flash_verify (G={g})",
                  "src/repro_torch/kernels/verify_attention/verify_attention.cu",
                  "src/repro/kernels/verify_attention/verify_attention.py:118",
                  paged_flash_verify(qv, kp, vp, bt, pos, t_window=t_w),
                  paged_verify_attention_ref(qv, kp, vp, bt, pos, t_w), KERNEL_TOL,
                  queued_ms(lambda: paged_flash_verify(qv, kp, vp, bt, pos, t_window=t_w)),
                  queued_ms(lambda: paged_verify_attention_ref(qv, kp, vp, bt, pos, t_w)),
                  ver_bytes, ver_flops, BF16_FLOPS_S, None)
    print(f"kernel paged_flash_verify (G={g}): library_ms none (no single PyTorch call "
          f"reads paged K/V); B {SLOTS}, Hkv {hkv}, T {t_w}, D {dh}", flush=True)
    out[f"paged_flash_verify G={g} T={t_w}"] = {
        k: rows[f"paged_flash_verify (G={g})"][k]
        for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    kq, ks = quantize_kv_rows(kp.float())
    vq, vs = quantize_kv_rows(vp.float())
    check(f"paged_flash_verify[int8] G={g} T={t_w}",
          lambda *a: paged_flash_verify(*a, t_window=t_w, k_scales=ks, v_scales=vs),
          lambda *a: paged_verify_attention_ref(*a, t_window=t_w, k_scales=ks, v_scales=vs),
          qv, kq, vq, bt, pos, queued=True)
    x, w = randn(512, cfg.d_model), randn(cfg.d_model)
    check(f"rmsnorm 512 x {cfg.d_model}", lambda *a: rmsnorm(*a, cfg.norm_eps),
          lambda *a: rmsnorm_ref(*a, cfg.norm_eps), x, w, queued=True)
    return out


@contextlib.contextmanager
def moe_tap(replay=None):
    """While open, taps the MoE layer of ``repro_torch.models.moe``: each
    gating call's (weights, mask) lands in ``["gatings"]`` (or, with
    ``replay``, the recorded outputs are returned in order instead of
    gating), and each dispatch's (tokens S, capacity C, dropped picks) in
    ``["dispatches"]``: a pick is dropped where its place in its expert's
    buffer, the running count of the group's earlier picks, is C or more
    (``models/moe.py``'s arithmetic).  Syncs once a dispatch."""
    from repro_torch.models import moe

    gating, dispatch = moe.gating_topk, moe._moe_dispatch
    rec = dict(gatings=[], dispatches=[])

    def tap_gating(logits, top_k, use_kernel=True):
        if replay is not None:
            out = replay[len(rec["gatings"])]
        else:
            out = gating(logits, top_k, use_kernel)
        rec["gatings"].append(out)
        return out

    def tap_dispatch(params, x, cfg, capacity_factor, use_kernel):
        y = dispatch(params, x, cfg, capacity_factor, use_kernel)
        s = x.shape[1]
        cf = capacity_factor or cfg.capacity_factor
        cap = max(int(s * cfg.top_k * cf / cfg.n_experts), 1)
        mask = rec["gatings"][-1][1]
        place = torch.cumsum(mask.to(torch.int32), dim=1) - 1
        rec["dispatches"].append((s, cap, int((mask & (place >= cap)).sum())))
        return y

    moe.gating_topk, moe._moe_dispatch = tap_gating, tap_dispatch
    try:
        yield rec
    finally:
        moe.gating_topk, moe._moe_dispatch = gating, dispatch


def prefill_drops(rec, n_layers: int) -> list:
    """(length, capacity, dropped picks over all layers) of each prefill
    in a tapped run, in order: its dispatches of more than one token, one
    per layer."""
    calls = [d for d in rec["dispatches"] if d[0] > 1]
    return [(calls[i][0], calls[i][1], sum(c[2] for c in calls[i:i + n_layers]))
            for i in range(0, len(calls), n_layers)]


def routing_flips(a, b) -> dict:
    """Token rows whose selected experts differ between two tapped runs of
    the same forwards, in the prefill and in the decode steps, and the
    first gating call (in order: forward x layers) where one does."""
    n = dict(prefill=0, prefill_rows=0, decode=0, decode_rows=0, first_call=None)
    for i, ((_, ma), (_, mb)) in enumerate(zip(a["gatings"], b["gatings"])):
        ma, mb = ma.reshape(-1, ma.shape[-1]), mb.reshape(-1, mb.shape[-1])
        phase = "prefill" if ma.shape[0] > SLOTS else "decode"
        flips = int((ma != mb).any(-1).sum())
        n[phase] += flips
        n[phase + "_rows"] += ma.shape[0]
        if flips and n["first_call"] is None:
            n["first_call"] = i
    return n


def preemption_control(label, model, params, spec, num_pages) -> dict:
    """One weights/dtype/capacity setting served dense and on the
    preempting pool: per-request token agreement and the preempted."""
    dense, _, d_counts, _, _ = serve(model, params, spec)
    paged, eng, p_counts, _, _ = serve(model, params, spec, cache_layout="paged",
                                       page_size=PAGE_SIZE, num_pages=num_pages)
    _, per_req, preempted = layout_agreement(
        f"moe control {label}: dense vs preempting paged", dense, paged, eng)
    if not preempted:
        fail(f"the MoE control {label} was sized to preempt and did not")
    return dict(per_request=per_req, preempted=preempted,
                launches=add_counts(d_counts, p_counts))


def run_moe(seed: int, gen: torch.Generator, rows: dict, smi: str):
    """Full-width OLMoE-1B-7B serving on both layouts, the MoE target
    speculating (:func:`run_spec_moe`), the plain path teacher-forced, one
    decode step's gating launches, and the profile of one prefill and one
    decode step.  Returns the record (the speculation's under ``"spec"``,
    its launch counts under ``"spec_counts"``) and the launch counts of
    the two serve runs."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import leaves

    cfg = get_config(MOE_ARCH)
    shapes = check_moe_shapes(cfg, gen, rows)

    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in leaves(params))
    print(f"moe model: {MOE_ARCH} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} experts="
          f"{cfg.n_experts} top_k={cfg.top_k} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"params={n_params} dtype=bf16; weights {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    spec = make_requests(seed, cfg.vocab)
    print(f"moe requests: {len(spec)} prompts of {[len(p) for _, p, _ in spec]} tokens, "
          f"each prefilled alone at its length", flush=True)
    serve(model, params, [(99, spec[1][1][:64], 2)])           # warm-up
    probe = replay_probe(model, params, "moe", gen)
    dense_run = serve(model, params, spec, warm=True)
    dense, d_eng, d_counts, d_wall, d_tok = dense_run
    print(f"moe serve dense: {d_tok} tokens in {d_wall:.3f} s = {d_tok / d_wall:.1f} "
          f"tok/s; launches {d_counts}", flush=True)
    pair = pipeline_pair("moe dense", dense_run, serve(model, params, spec, pipeline=False,
                                                       warm=True),
                         STEP_KERNELS["moe"], gate=probe["bit_for_bit"])
    del dense_run
    num_pages = preempting_pool(spec)
    paged, eng, p_counts, p_wall, p_tok = serve(
        model, params, spec, cache_layout="paged", page_size=PAGE_SIZE,
        num_pages=num_pages)
    peak = max(e.base_bytes + e.peak_bytes for e in (d_eng, eng))
    print(f"moe serve paged: {p_tok} tokens in {p_wall:.3f} s = {p_tok / p_wall:.1f} "
          f"tok/s; pool {num_pages} pages; preemptions {eng.preemptions}; launches "
          f"{p_counts}; peak memory {peak / 2 ** 30:.2f} GiB", flush=True)
    if eng.preemptions < 1:
        fail("the MoE paged run was sized to preempt and did not")
    if eng.last_pool_stats.used_pages != 0:
        fail(f"the MoE paged run leaked {eng.last_pool_stats.used_pages} pages")
    agree, per_req, preempted = layout_agreement("moe dense vs paged token agreement",
                                                 dense, paged, eng)
    ample, _, _, a_wall, a_tok = serve(model, params, spec, cache_layout="paged",
                                       page_size=PAGE_SIZE)
    agree_ample = np.mean([a == b for u in dense for a, b in zip(dense[u], ample[u])])
    print(f"moe serve paged, a pool that never preempts: {a_tok / a_wall:.1f} tok/s; "
          f"token agreement with dense {agree_ample:.4f}", flush=True)
    if agree_ample < 1.0:
        fail("paged serving without preemption served other tokens than dense")
    spec_rec, spec_counts = run_spec_moe(cfg, model, params, spec, num_pages, smi)
    for name in ("rmsnorm", "flash_attention_fwd", "moe_gating"):
        if d_counts[name] == 0 or p_counts[name] == 0:
            fail(f"{name} never launched while serving MoE")
    if d_counts["flash_decode"] == 0 or p_counts["paged_flash_decode"] == 0:
        fail("a decode kernel never launched while serving MoE")

    # Why a preempted request differs.  Every row is its own MoE group, so
    # only a preempted request can: its re-prefill runs prompt and
    # generated tokens through prefill at the prefill capacity C = S k cf
    # / E (cf = infer_capacity_factor), where the dense run took decode
    # steps that drop nothing.  (i) The preempting run again, tapped: the
    # picks each prefill drops.  (ii) Controls on the same weights, dense
    # against the preempting pool, with cf = E / k (C = S: nothing drops),
    # in bf16 and in fp32 compute.
    with moe_tap() as tap:
        # serial: the tap syncs once a dispatch, which no capture allows
        again, _, _, _, _ = serve(model, params, spec, cache_layout="paged",
                                  page_size=PAGE_SIZE, num_pages=num_pages,
                                  pipeline=False)
    drops = prefill_drops(tap, cfg.n_layers)
    resumed = {u: [d for d in drops if len(p) < d[0] < len(p) + MAX_NEW]
               for u, p, _ in spec if u in preempted}
    print(f"moe prefill drops (length, capacity, dropped picks over "
          f"{cfg.n_layers} layers): {drops}; re-prefills of the preempted {resumed}; "
          f"tapped rerun serves the same tokens {again == paged}", flush=True)
    del tap
    nodrop = dataclasses.replace(cfg, infer_capacity_factor=cfg.n_experts / cfg.top_k)
    controls = {label: preemption_control(label, Model(nodrop, device="cuda", dtype=dt),
                                          params, spec, num_pages)
                for label, dt in (("bf16 no drops", torch.bfloat16),
                                  ("fp32 no drops", torch.float32))}
    # the fp32 control gates; the bf16 one is reported: its re-prefill
    # still rounds otherwise than the decode steps, and a router near-tie
    # may turn that into another token on another card
    for label, c in controls.items():
        if label.startswith("fp32") and min(c["per_request"].values()) < 1.0:
            fail(f"with nothing dropped and fp32 compute ({label}) a preempted "
                 f"request still served other tokens paged than dense")
    # the exemption: a preempted request whose re-prefill dropped picks
    for u in dense:
        if per_req[u] < 1.0 and not (u in preempted and any(d[2] for d in resumed[u])):
            fail(f"request {u} served other tokens paged than dense, and no "
                 f"dropped pick of a re-prefill accounts for it")

    # the plain path teacher-forced, with each path's routing tapped; then
    # the plain path again with the kernel path's routing replayed, which
    # leaves only attention's and rmsnorm's bf16 rounding between them
    uid, prompt, _ = spec[0]
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    with moe_tap() as k_tap:
        k_logits = teacher_force(model, params, prompt, dense[uid])
    with moe_tap() as p_tap:
        p_logits = teacher_force(plain, params, prompt, dense[uid])
    err, scale, t_agree = compare_logits(f"moe uid {uid} plain vs kernel path",
                                         p_logits, k_logits)
    flips = routing_flips(k_tap, p_tap)
    first = flips["first_call"]
    print(f"moe teacher-forced routing, plain vs kernel path: {flips['prefill']} of "
          f"{flips['prefill_rows']} prefill token-layer rows and {flips['decode']} of "
          f"{flips['decode_rows']} decode rows select other experts; first at "
          f"{'none' if first is None else f'forward {first // cfg.n_layers} layer {first % cfg.n_layers}'}",
          flush=True)
    with moe_tap(replay=k_tap["gatings"]):
        r_logits = teacher_force(plain, params, prompt, dense[uid])
    r_err, _, r_agree = compare_logits(
        f"moe uid {uid} plain vs kernel path, the kernel path's routing replayed",
        r_logits, k_logits)
    del plain, k_logits, p_logits, r_logits, k_tap, p_tap

    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
    tok = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
    cache = model.init_cache(SLOTS, MAX_SEQ)
    torch.cuda.synchronize()
    kernels.reset_launches()
    model.decode_step(params, cache, tok, pos, attend_len=MAX_SEQ)
    torch.cuda.synchronize()
    per_step = kernels.launch_counts()["moe_gating"]
    print(f"moe decode step: moe_gating launched {per_step} times "
          f"({cfg.n_layers} layers)", flush=True)
    if per_step != cfg.n_layers:
        fail(f"a decode step launched moe_gating {per_step} times, not once per layer")
    toks = torch.randint(0, cfg.vocab, (1, 512), generator=gen, device="cuda")
    phases = {
        "moe_decode_step": profile_phase("moe_decode_step", lambda: model.decode_step(
            params, cache, tok, pos, attend_len=MAX_SEQ), 10),
        "moe_decode_step_graph": graph_phase("moe_decode_step_graph", model, params,
                                             "moe", gen),
        "moe_prefill_1x512": profile_phase("moe_prefill_1x512",
                                           lambda: model.prefill(params, toks, 512), 3)}
    require_decode_kernels(phases, ("moe_decode_step", "moe_decode_step_graph"))
    for name, r in phases.items():
        if r["device_ms"] > 0 and r["gating_ms"] <= 0:
            fail(f"the {name} profile holds no {GATING_KERNEL} time")
    print(f"moe gating device time: decode step {phases['moe_decode_step']['gating_ms']:.4f} "
          f"ms in {cfg.n_layers} calls, prefill 1 x 512 "
          f"{phases['moe_prefill_1x512']['gating_ms']:.4f} ms", flush=True)
    counts = add_counts(d_counts, p_counts)
    return dict(n_params=n_params, dense_tok_s=d_tok / d_wall, paged_tok_s=p_tok / p_wall,
                dense_counts=d_counts, paged_counts=p_counts, num_pages=num_pages,
                preemptions=eng.preemptions, token_agreement=agree,
                token_agreement_per_request=per_req, preempted=preempted,
                token_agreement_no_preemption=float(agree_ample),
                prefill_drops=drops, resumed_prefill_drops=resumed,
                preemption_controls=controls, kernels_at_olmoe_shapes=shapes,
                peak_bytes=peak, teacher_forced_max_err=err, logit_scale=scale,
                teacher_forced_argmax_agreement=t_agree, routing_flips=flips,
                replayed_routing_max_err=r_err, replayed_routing_argmax_agreement=r_agree,
                gating_per_decode_step=per_step, phases=phases, replay_probe=probe,
                pipeline=pair, spec=spec_rec, spec_counts=spec_counts), counts


SPEC_MOE_DRAFT = "self:4"     # 4 of OLMoE's 16 layers


def run_spec_moe(cfg, model, params, spec, num_pages: int, smi: str) -> tuple:
    """Phase 6's speculation (``spec moe`` lines): the MoE target with
    spec_k = 4 and a 4-layer self draft on the preempting pool, beside
    non-speculative paged serving on the same pool (both engines warm:
    each serves the requests once untimed, capturing its graphs); then
    request 0's verify windows teacher-forced against its decode steps on
    the kernel and the plain path.  A window of T tokens dispatches at
    capacity max(int(T k 8 / E), 1) = T here, as a decode step drops
    nothing at 1, so the two compute the same routing but for bf16 ties.
    Returns the record and the run's launch counts."""
    from repro_torch.models.lm import Model

    t0 = time.perf_counter()
    paged_kw = dict(cache_layout="paged", page_size=PAGE_SIZE, num_pages=num_pages)
    paged, _, _, p_wall, p_tok = serve(model, params, spec, warm=True, **paged_kw)
    paged_tok_s = p_tok / p_wall
    out, eng, counts, wall, n_tok = serve(model, params, spec, warm=True, spec_k=SPEC_K,
                                          draft=SPEC_MOE_DRAFT, **paged_kw)
    rec = spec_report(f"moe {SPEC_MOE_DRAFT}", spec, out, eng, counts, wall, n_tok)
    if eng.preemptions < 1:
        fail("the MoE spec run was sized to preempt and did not")
    for name in ("paged_flash_verify", "moe_gating"):
        if counts[name] == 0:
            fail(f"{name} never launched while the MoE target speculated")
    # the launches add up across replays (``kernels.add_launches``): each
    # step (a replay, or a capture's eager warm-up) verifies once a target
    # layer and gates once a target layer and once a draft layer a proposal;
    # each prefill (the requests', and each requeued resume's) gates once a
    # target and a draft layer
    g = eng.last_graph_stats
    steps = g["replays"] + g["captured"]
    n_t, n_d = cfg.n_layers, eng.draft_model.cfg.n_layers
    prefills = len(spec) + eng.preemptions
    want = {"paged_flash_verify": steps * n_t,
            "moe_gating": steps * (n_t + n_d * (SPEC_K - 1)) + prefills * (n_t + n_d)}
    print(f"spec moe launches: {steps} steps ({g['replays']} replays, {g['captured']} "
          f"captured), {prefills} prefills: paged_flash_verify {counts['paged_flash_verify']} "
          f"(expected {want['paged_flash_verify']}), moe_gating {counts['moe_gating']} "
          f"(expected {want['moe_gating']})", flush=True)
    if any(counts[k] != v for k, v in want.items()):
        fail("the MoE spec run's launches do not add up across its replays and prefills")
    agree, per_req, preempted = layout_agreement(
        "spec moe vs non-spec paged token agreement (reported)", paged, out, eng)
    print(f"spec moe: {n_tok / wall:.1f} tok/s against non-spec paged {paged_tok_s:.1f} "
          f"tok/s (both warm; ratio {n_tok / wall / paged_tok_s:.3f}); mean accept rate "
          f"{rec['mean_accept_rate']:.3f}; preemptions {eng.preemptions}; "
          f"paged_flash_verify launches {counts['paged_flash_verify']}, moe_gating "
          f"launches {counts['moe_gating']}; [{smi}]", flush=True)
    uid, prompt, _ = spec[0]
    toks = out[uid]
    n_win = (len(toks) - 1) // SPEC_K
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    c = {}
    for label, m in (("kernel", model), ("plain", plain)):
        dec = teacher_force(m, params, prompt, toks)[1:1 + n_win * SPEC_K]
        v = verify_force(m, params, prompt, toks, n_win)
        err, scale, t_agree = compare_logits(
            f"spec moe uid {uid} verify windows ({label} path) vs decode steps", v, dec)
        c[label] = dict(max_err=err, logit_scale=scale, argmax_agreement=t_agree,
                        rows=n_win * SPEC_K)
    rec.update(nonspec_tok_s=paged_tok_s, token_agreement=agree,
               token_agreement_per_request=per_req, preempted=preempted, c=c,
               draft=SPEC_MOE_DRAFT, phase_wall_s=time.perf_counter() - t0)
    print(f"spec moe: phase wall {rec['phase_wall_s']:.1f} s", flush=True)
    return rec, counts


# ---------------------------------------------------------------------------
# phase 4: training through the flash backward
# ---------------------------------------------------------------------------

def grad_readings(k_loss, k_grads, p_loss, p_grads) -> dict:
    """Kernel-path loss and gradients against the plain path's: the loss
    difference, the global norms' relative difference, and per leaf the
    cosine similarity and the relative norm of the difference."""
    from repro_torch.optim.optimizer import global_norm, named_leaves

    k_norm, p_norm = global_norm(k_grads).item(), global_norm(p_grads).item()
    p_named = dict(named_leaves(p_grads))
    cos, rel = {}, {}
    for path, a in named_leaves(k_grads):
        a, b = a.flatten().double(), p_named[path].flatten().double()
        cos[path] = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        rel[path] = ((a - b).norm() / b.norm()).item()
    worst_cos, worst_rel = min(cos, key=cos.get), max(rel, key=rel.get)
    return dict(kernel_loss=k_loss, plain_loss=p_loss,
                loss_diff=abs(k_loss - p_loss), kernel_grad_norm=k_norm,
                plain_grad_norm=p_norm, grad_norm_rel_diff=abs(k_norm - p_norm) / p_norm,
                min_cosine=cos[worst_cos], min_cosine_leaf=worst_cos,
                max_leaf_rel_diff=rel[worst_rel], max_leaf_rel_diff_leaf=worst_rel,
                cosines=cos, leaf_rel_diffs=rel)


# phase 5's gradient gates, by reading
DENSE_GRAD_GATES = dict(loss=GRAD_LOSS_TOL, norm=GRAD_NORM_TOL, cos=GRAD_COS_MIN,
                        leaf=GRAD_LEAF_TOL)


def tripped_gates(r: dict, gates: dict = DENSE_GRAD_GATES) -> list:
    """The gradient gates that reading ``r`` does not pass."""
    checks = [("loss", r["loss_diff"] <= gates["loss"]),
              ("global norm", r["grad_norm_rel_diff"] <= gates["norm"]),
              ("leaf cosine", r["min_cosine"] >= gates["cos"]),
              ("leaf norm difference", r["max_leaf_rel_diff"] <= gates["leaf"])]
    return [name for name, ok in checks if not ok]


def print_readings(label: str, r: dict, gates: dict = DENSE_GRAD_GATES,
                   prefix: str = "train"):
    print(f"{prefix} grad check {label} (tf32 off): loss kernel {r['kernel_loss']:.6f} "
          f"plain {r['plain_loss']:.6f} diff {r['loss_diff']:.3e} (tol {gates['loss']}); "
          f"grad norm kernel {r['kernel_grad_norm']:.6f} plain "
          f"{r['plain_grad_norm']:.6f} rel diff {r['grad_norm_rel_diff']:.3e} "
          f"(tol {gates['norm']}); min leaf cosine 1 - {1 - r['min_cosine']:.3e} at "
          f"{r['min_cosine_leaf']} (min 1 - {1 - gates['cos']:.1e}); max leaf norm "
          f"difference {r['max_leaf_rel_diff']:.3e} at {r['max_leaf_rel_diff_leaf']} "
          f"(tol {gates['leaf']}); gates tripped {tripped_gates(r, gates)}", flush=True)


@contextlib.contextmanager
def flash_grad_fault(index: int, scale: float):
    """A faulted control: the flash backward's gradient ``index`` (1 dk,
    2 dv) scaled by ``scale`` in every layer."""
    from repro_torch.kernels.flash_attention.ops import FlashAttention

    backward = FlashAttention.backward

    def faulted(ctx, do):
        grads = list(backward(ctx, do))
        grads[index] = grads[index] * scale
        return tuple(grads)

    FlashAttention.backward = staticmethod(faulted)
    try:
        yield
    finally:
        FlashAttention.backward = staticmethod(backward)


# the dense control: dk scaled by GRAD_FAULT_DK
DK_FAULT = (f"dk x {GRAD_FAULT_DK}", lambda: flash_grad_fault(1, GRAD_FAULT_DK))


def compare_grads(model, plain, params, batch, gates: dict = DENSE_GRAD_GATES,
                  faults=(DK_FAULT,),
                  prefix: str = "train") -> dict:
    """One gradient on one batch through the kernel path and through the
    plain path, same weights, held to the gates; then each faulted control
    (the kernel path under one of ``faults``, (label, context manager)
    pairs), which must trip a gate."""
    from repro_torch.train.step import make_grad_fn

    def grads(m):
        loss, g = make_grad_fn(m, vocab_chunks=VOCAB_CHUNKS)(params, batch)
        return loss.item(), g

    p_loss, p_grads = grads(plain)
    sound = grad_readings(*grads(model), p_loss, p_grads)
    print_readings("sound", sound, gates, prefix)
    if not (np.isfinite(sound["kernel_loss"]) and np.isfinite(p_loss)):
        fail(f"{prefix}: non-finite loss in the gradient check")
    if tripped_gates(sound, gates):
        fail(f"{prefix}: kernel-path gradients fail the gates {tripped_gates(sound, gates)}")
    controls = {}
    for label, faulted in faults:
        with faulted():
            controls[label] = grad_readings(*grads(model), p_loss, p_grads)
        print_readings(f"control ({label})", controls[label], gates, prefix)
        if not tripped_gates(controls[label], gates):
            fail(f"{prefix}: the gradient gates pass a backward with {label}")
    return dict(sound=sound, controls=controls)


def run_training(cfg, seed: int):
    """Full-width qwen2-1.5b training on one card: the gradient check,
    TRAIN_STEPS Trainer steps, one profiled step.  Returns the record and
    the launch counts of the Trainer run."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import AdamWConfig, init_adamw, leaves
    from repro_torch.train.step import TrainState, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 products in full fp32
    kw = dict(device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    model = Model(cfg, **kw)                           # remat on, as the reference
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in leaves(params))
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=seed))
    print(f"train model: {ARCH} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"params={n_params} fp32 master weights + AdamW, bf16 compute, remat, "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {VOCAB_CHUNKS} vocab chunks",
          flush=True)
    batch = {k: v.cuda() for k, v in data.batch_at(0).items()}
    grads = compare_grads(model, Model(cfg, use_kernels=False, **kw), params, batch)

    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    trainer = Trainer(model, data, opt, TrainerConfig(total_steps=TRAIN_STEPS,
                                                      vocab_chunks=VOCAB_CHUNKS))
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def log(step, m):
        print(f"train step {step}: loss {m['loss']:.6f} lr {m['lr']:.3e} grad_norm "
              f"{m['grad_norm']:.6f} {m['step_time_s'] * 1e3:.1f} ms "
              f"{tokens / m['step_time_s']:.1f} tokens/s", flush=True)

    start = TrainState(params, init_adamw(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()    # weights, AdamW state, leftovers
    kernels.reset_launches()
    state, hist = trainer.run(start_state=start, on_metrics=log)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"train: {len(hist)} steps, peak memory {peak / 2 ** 30:.2f} GiB "
          f"({before / 2 ** 30:.2f} GiB allocated before the run); launches "
          f"rmsnorm {counts['rmsnorm']} flash_attention_fwd "
          f"{counts['flash_attention_fwd']} ({counts['flash_attention_fwd'] // TRAIN_STEPS} "
          f"a step) flash_attention_bwd {counts['flash_attention_bwd']} "
          f"({counts['flash_attention_bwd'] // TRAIN_STEPS} a step)", flush=True)
    losses = [m["loss"] for _, m in hist]
    if len(hist) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"training gave losses {losses}")
    if counts["flash_attention_bwd"] != cfg.n_layers * TRAIN_STEPS:
        fail(f"flash_attention_bwd launched {counts['flash_attention_bwd']} times, "
             f"not once per layer per step")
    if counts["flash_attention_fwd"] != 2 * cfg.n_layers * TRAIN_STEPS:
        fail(f"flash_attention_fwd launched {counts['flash_attention_fwd']} times, "
             f"not twice (forward, remat) per layer per step")
    if counts["rmsnorm"] == 0:
        fail("rmsnorm never launched while training")
    no_ragged_rmsnorm("training", counts)

    step_fn = make_train_step(model, opt, vocab_chunks=VOCAB_CHUNKS)
    batch = {k: v.cuda() for k, v in data.batch_at(TRAIN_STEPS).items()}
    profile = profile_phase("train_step", lambda: step_fn(state, batch), 1)
    times = [m["step_time_s"] for _, m in hist]
    return dict(grad_check=grads, history=hist, peak_bytes=peak,
                allocated_before_bytes=before, n_params=n_params,
                step_ms=[t * 1e3 for t in times],
                tokens_s=[tokens / t for t in times], profile=profile,
                counts=counts), counts


# ---------------------------------------------------------------------------
# phase 5b: checkpoints, exact resume, the async writer, the training CLIs
# ---------------------------------------------------------------------------

def state_leaves(state) -> dict:
    """Every tensor of a TrainState by name: params, then AdamW's m and v."""
    from repro_torch.optim.optimizer import named_leaves

    out = {}
    for part, tree in (("params", state.params), ("m", state.opt.m), ("v", state.opt.v)):
        out.update({f"{part}.{k}": t for k, t in named_leaves(tree)})
    return out


def folder_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


@contextlib.contextmanager
def timed_calls(module, name: str):
    """While open, ``module.name`` is wrapped: each call's seconds (after a
    device synchronize) land in the yielded list."""
    fn, times = getattr(module, name), []

    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapper)
    try:
        yield times
    finally:
        setattr(module, name, fn)


def run_cli(label: str, cmd, smi: str, expect: str,
            keep=("loss", "resumed", "model")) -> dict:
    """Run one CLI in a subprocess from the checkout; print the lines of
    its output that start with one of ``keep``; fail unless it exits 0
    and prints ``expect``."""
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    kept = [ln for ln in run.stdout.splitlines() if ln.lstrip().startswith(keep)]
    print(f"{label}: {' '.join(cmd[1:])}: exit {run.returncode} in {wall:.1f} s; "
          f"[{smi}]\n  " + "\n  ".join(kept), flush=True)
    if run.returncode != 0 or expect not in run.stdout:
        fail(f"{label}: exit {run.returncode}, {expect!r} printed: "
             f"{expect in run.stdout}; {run.stderr[-2000:]}")
    return dict(returncode=run.returncode, wall_s=wall, lines=kept)


def run_ckpt(seed: int, smi: str) -> tuple:
    """Phase 5b (``ckpt`` lines): exact resume, the async writer's
    snapshot, the checkpoint's costs and the training CLIs' resume.
    Returns the record and the launch counts of its in-process training."""
    from repro_torch import kernels
    from repro_torch.checkpoint.checkpoint import (
        AsyncCheckpointer,
        latest_step,
        restore_checkpoint,
    )
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import AdamWConfig, leaves
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CKPT_LAYERS)
    model = Model(cfg, device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=seed))
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=CKPT_STEPS)

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    def trainer(ckpt=None):
        return Trainer(model, data, opt, TrainerConfig(
            total_steps=CKPT_STEPS, checkpoint_every=CKPT_STEPS * 100, checkpoint_dir=ckpt,
            vocab_chunks=VOCAB_CHUNKS))

    n_params = sum(p.numel() for p in leaves(model.init(gen())))
    state_bytes = 3 * 4 * n_params + 4          # fp32 weights, m and v; the int32 step
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        print(f"ckpt model: {ARCH} layers={cfg.n_layers} (cut from 28) d_model={cfg.d_model} "
              f"vocab={cfg.vocab} params={n_params}, fp32 master weights + AdamW "
              f"({state_bytes} B), bf16 compute, remat, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}; "
              f"{free} B free on the checkpoints' disk; [{smi}]", flush=True)
        if free < CKPT_DISK_FACTOR * state_bytes:
            fail(f"ckpt: {free} B free where the phase needs {CKPT_DISK_FACTOR} x the "
                 f"state's {state_bytes} B")
        rec = dict(n_params=n_params, state_bytes=state_bytes, free_bytes=free)
        kernels.reset_launches()

        # (a) exact resume
        u1, h_u1 = trainer().run(gen())
        u2, h_u2 = trainer().run(gen())
        l1, l2 = state_leaves(u1), state_leaves(u2)
        bitwise = u1.opt.step == u2.opt.step and all(torch.equal(l1[k], l2[k]) for k in l1)
        u2_diff = {k: (l2[k] - l1[k]).abs().max().item() for k in l1}
        del u2, l2
        dir_a = os.path.join(root, "a")
        polls = [0]

        def should_stop():
            polls[0] += 1
            return polls[0] == CKPT_STOP_AFTER + 1

        # the Trainer's own sync save and restore, timed
        with timed_calls(trainer_mod, "save_checkpoint") as save_s, \
                timed_calls(trainer_mod, "restore_checkpoint") as resume_s:
            _, h_p1 = trainer(dir_a).run(gen(), should_stop=should_stop)
            committed = latest_step(dir_a)
            p, h_p2 = trainer(dir_a).run(gen())
        if h_p1[-1][0] != CKPT_STOP_AFTER or committed != CKPT_STOP_AFTER + 1:
            fail(f"ckpt a: the preempted run stopped after step {h_p1[-1][0]} and "
                 f"committed step {committed}")
        if not h_p2 or h_p2[0][0] != CKPT_STOP_AFTER + 1:
            fail(f"ckpt a: the new Trainer did not resume at step {CKPT_STOP_AFTER + 1}: "
                 f"{[s for s, _ in h_p2]}")
        lp = state_leaves(p)
        p_diff = {k: (lp[k] - l1[k]).abs().max().item() for k in l1}
        loss_u1 = [m["loss"] for _, m in h_u1]
        loss_u2 = [m["loss"] for _, m in h_u2]
        loss_p = [m["loss"] for _, m in h_p1 + h_p2]
        if bitwise:
            case = "U1 = U2 bit for bit, so P must equal U1 bit for bit"
            ok = p.opt.step == u1.opt.step and all(torch.equal(lp[k], l1[k]) for k in l1)
        else:
            case = (f"U1 != U2 (nondeterministic sums), so P's largest difference per leaf "
                    f"must stay within 2x U2's and its losses within rtol {CKPT_LOSS_RTOL}")
            ok = (all(p_diff[k] <= 2 * u2_diff[k] for k in l1)
                  and np.allclose(loss_p, loss_u1, rtol=CKPT_LOSS_RTOL, atol=0))
        worst = max(p_diff, key=p_diff.get)
        print(f"ckpt a: U1, U2 {CKPT_STEPS} steps each; P preempted after step "
              f"{CKPT_STOP_AFTER} (committed step {committed}), resumed at step "
              f"{h_p2[0][0]}; case: {case}; holds {ok}; losses U1 {loss_u1} U2 {loss_u2} "
              f"P {loss_p}; largest |P - U1| {p_diff[worst]:.3e} at {worst} (U2 there "
              f"{u2_diff[worst]:.3e}); step ms U1 "
              f"{[round(m['step_time_s'] * 1e3, 1) for _, m in h_u1]}; [{smi}]", flush=True)
        if not ok:
            fail(f"ckpt a: the resumed run breaks its gate ({case})")
        rec["a"] = dict(bitwise=bitwise, case=case, losses_u1=loss_u1, losses_u2=loss_u2,
                        losses_p=loss_p, p_diff=p_diff, u2_diff=u2_diff,
                        step_ms=[m["step_time_s"] * 1e3 for _, m in h_u1])
        del u1, l1, lp
        shutil.rmtree(dir_a)

        # (b) the async writer: save, one in-place step, wait, restore
        dir_b = os.path.join(root, "b")
        clone = {k: t.clone() for k, t in state_leaves(p).items()}
        clone_step = p.opt.step
        ck = AsyncCheckpointer(dir_b, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(clone_step, p, metadata={"loss": loss_p[-1], "preempted": False})
        stall = time.perf_counter() - t0
        step_fn = make_train_step(model, opt, vocab_chunks=VOCAB_CHUNKS)
        batch = {k: v.cuda() for k, v in data.batch_at(CKPT_STEPS).items()}
        t0 = time.perf_counter()
        p, _ = step_fn(p, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.wait()
        wait_s = time.perf_counter() - t0
        writer_s = ck.last_write_s
        ck.close()
        moved = not all(torch.equal(t, clone[k]) for k, t in state_leaves(p).items())
        t0 = time.perf_counter()
        restored, r_step, _ = restore_checkpoint(dir_b, p)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = (restored.opt.step == clone_step and r_step == clone_step
                and all(torch.equal(t, clone[k]) for k, t in state_leaves(restored).items()))
        ckpt_bytes = folder_bytes(dir_b)
        print(f"ckpt b: AsyncCheckpointer.save at step {clone_step}, one in-place step "
              f"({step_s * 1e3:.1f} ms) that moved the live state: {moved}; restored = the "
              f"clone taken at save, bit for bit: {same}; [{smi}]", flush=True)
        if not (moved and same):
            fail("ckpt b: the async writer committed something other than its snapshot")
        del restored, clone
        shutil.rmtree(dir_b)

        # (c) what a checkpoint costs: (a)'s preemption save and resume in
        # the Trainer, (b)'s async save and restore
        step_ms = float(np.median(rec["a"]["step_ms"]))
        print(f"ckpt c: checkpoint {ckpt_bytes} B; sync save {save_s[0]:.3f} s (the "
              f"Trainer's at preemption); async save() stall {stall:.3f} s, writer "
              f"{writer_s:.3f} s (wait() after one step {wait_s:.3f} s); restore "
              f"{restore_s:.3f} s ({resume_s[0]:.3f} s in the Trainer's resume); a training "
              f"step {step_ms:.1f} ms (median of U1's); [{smi}]", flush=True)
        rec["c"] = dict(checkpoint_bytes=ckpt_bytes, sync_save_s=save_s[0],
                        async_stall_s=stall, writer_s=writer_s, wait_after_step_s=wait_s,
                        restore_s=restore_s, resume_restore_s=resume_s[0], step_ms=step_ms)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        del p
        torch.cuda.empty_cache()
        steps = 2 * CKPT_STEPS + len(h_p1) + len(h_p2) + 1
        if counts["flash_attention_bwd"] != cfg.n_layers * steps:
            fail(f"ckpt: flash_attention_bwd launched {counts['flash_attention_bwd']} times "
                 f"in {steps} steps of {cfg.n_layers} layers")
        no_ragged_rmsnorm("checkpoint training", counts)

        # (d) the CLIs, each in a process of its own: train_lm beside the
        # launch.train pair (a process's start, not its steps, is most of
        # its wall: ~25 s for 2 steps of the reduced model)
        cli_dir = os.path.join(root, "cli")
        base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                "--ckpt-dir", cli_dir, "--ckpt-every", str(CKPT_CLI_EVERY)]
        first, then = CKPT_CLI_STEPS
        with concurrent.futures.ThreadPoolExecutor(1) as beside:
            train_lm = beside.submit(
                run_cli, "ckpt d train_lm", [sys.executable, "-m", "repro_torch.train_lm",
                                            "--steps", str(TRAIN_LM_STEPS), "--ckpt",
                                            os.path.join(root, "train_lm")], smi,
                f"resumed at step {TRAIN_LM_STEPS}")
            rec["d"] = dict(
                train=run_cli("ckpt d launch.train", base + ["--steps", str(first)], smi,
                              f"over {first} steps"),
                resume=run_cli("ckpt d launch.train resumed", base + ["--steps", str(then)],
                               smi, f"resumed at step {first}"),
                train_lm=train_lm.result())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"ckpt phase: {rec['wall_s']:.1f} s; [{smi}]", flush=True)
    return rec, counts


# ---------------------------------------------------------------------------
# phase 5c: MoE training through moe_gating's forward and backward
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def gating_fault():
    """The MoE control's fault: the gating backward's logit gradient
    scaled by GRAD_FAULT_GATE in every layer."""
    from repro_torch.kernels.moe_gating.ops import MoEGating

    backward = MoEGating.backward

    def faulted(ctx, gw, gm):
        dlogits, rest = backward(ctx, gw, gm)
        return dlogits * GRAD_FAULT_GATE, rest

    MoEGating.backward = staticmethod(faulted)
    try:
        yield
    finally:
        MoEGating.backward = staticmethod(backward)


def run_moe_train(seed: int, smi: str) -> tuple:
    """Phase 5c (``moe train`` lines): full-width Granite-MoE training,
    the gradient check against the plain path and its faulted control,
    TRAIN_STEPS Trainer steps, the capacity drops, one profiled step.
    Returns the record and the launch counts of the Trainer run."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import AdamWConfig, init_adamw, leaves
    from repro_torch.train.step import TrainState, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(MOE_TRAIN_ARCH)
    kw = dict(device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    model = Model(cfg, **kw)                           # remat on, as the reference
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in leaves(params))
    group = cfg.moe_group_size or TRAIN_SEQ
    cap = max(int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=seed))
    print(f"moe train model: {MOE_TRAIN_ARCH} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} experts={cfg.n_experts} top_k={cfg.top_k} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} params={n_params} fp32 master weights + AdamW, "
          f"bf16 compute, remat, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {VOCAB_CHUNKS} vocab "
          f"chunks, moe_group_size {cfg.moe_group_size} (groups of {group} tokens), capacity "
          f"factor {cfg.capacity_factor} (C = {cap}); [{smi}]", flush=True)
    batch = {k: v.cuda() for k, v in data.batch_at(0).items()}
    grads = compare_grads(model, Model(cfg, use_kernels=False, **kw), params, batch,
                          gates=MOE_GRAD_GATES,
                          faults=((f"gating backward x {GRAD_FAULT_GATE}", gating_fault),),
                          prefix="moe train")

    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    trainer = Trainer(model, data, opt, TrainerConfig(total_steps=TRAIN_STEPS,
                                                      vocab_chunks=VOCAB_CHUNKS))
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def log(step, m):
        print(f"moe train step {step}: loss {m['loss']:.6f} lr {m['lr']:.3e} grad_norm "
              f"{m['grad_norm']:.6f} {m['step_time_s'] * 1e3:.1f} ms "
              f"{tokens / m['step_time_s']:.1f} tokens/s; [{smi}]", flush=True)

    start = TrainState(params, init_adamw(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launches()
    state, hist = trainer.run(start_state=start, on_metrics=log)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: counts[k] // TRAIN_STEPS for k in
                ("moe_gating", "flash_attention_fwd", "flash_attention_bwd", "rmsnorm")}
    print(f"moe train: {len(hist)} steps, peak memory {peak / 2 ** 30:.2f} GiB "
          f"({before / 2 ** 30:.2f} GiB allocated before the run); launches moe_gating "
          f"{counts['moe_gating']} flash_attention_fwd {counts['flash_attention_fwd']} "
          f"flash_attention_bwd {counts['flash_attention_bwd']} rmsnorm {counts['rmsnorm']} "
          f"(a step: {per_step}); [{smi}]", flush=True)
    losses = [m["loss"] for _, m in hist]
    if len(hist) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"moe train: losses {losses}")
    want = dict(moe_gating=2 * cfg.n_layers, flash_attention_fwd=2 * cfg.n_layers,
                flash_attention_bwd=cfg.n_layers)
    for name, n in want.items():      # forward and remat per layer; one backward
        if counts[name] != n * TRAIN_STEPS:
            fail(f"moe train: {name} launched {counts[name]} times in {TRAIN_STEPS} "
                 f"steps, not {n} a step")
    if counts["rmsnorm"] == 0:
        fail("moe train: rmsnorm never launched")
    no_ragged_rmsnorm("moe training", counts)

    # capacity drops on the trained weights, one forward of the next batch
    batch = {k: v.cuda() for k, v in data.batch_at(TRAIN_STEPS).items()}
    with moe_tap() as tap, torch.no_grad():
        model.backbone(state.params, batch)
    dropped = sum(d[2] for d in tap["dispatches"])
    choices = cfg.n_layers * tokens * cfg.top_k
    per_layer = [d[2] for d in tap["dispatches"]]
    print(f"moe train drops: {dropped} of {choices} token-expert choices dropped at capacity "
          f"factor {cfg.capacity_factor} ({dropped / choices:.4f}); per layer {per_layer}; "
          f"[{smi}]", flush=True)
    del tap

    step_fn = make_train_step(model, opt, vocab_chunks=VOCAB_CHUNKS)
    profile = profile_phase("moe_train_step", lambda: step_fn(state, batch), 1)
    times = [m["step_time_s"] for _, m in hist]
    rec = dict(grad_check=grads, history=hist, peak_bytes=peak, allocated_before_bytes=before,
               n_params=n_params, step_ms=[t * 1e3 for t in times],
               tokens_s=[tokens / t for t in times], counts=counts, dropped=dropped,
               choices=choices, dropped_per_layer=per_layer, capacity=cap, profile=profile)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"moe train phase: {rec['wall_s']:.1f} s; [{smi}]", flush=True)
    return rec, counts


def fig5_device_time(seed: int, iters: int = 5) -> dict:
    """Device side of Fig. 5: summed kernel time and kernels per call of
    each lowering (``fig5_microbench.device_profile``: n/a where no whole
    trace was taken).  Event-timed calls above include the host's gaps;
    this says how much of each is device work."""
    from repro_torch.bench import fig5_microbench as fig5

    inputs = fig5.make_inputs(seed, "cuda")
    out = {}
    for name, spec in fig5.BENCHES.items():
        out[name] = {}
        for low in fig5.LOWERINGS:
            fn, args = spec["make"](low), inputs[name]
            fn(*args)
            torch.cuda.synchronize()
            out[name][low] = fig5.device_profile(lambda: fn(*args), iters)
        r = {low: p["device_us"] for low, p in out[name].items()}
        ratio = (f"{r['sw'] / r['kernel']:.2f}" if None not in (r["sw"], r["kernel"])
                 else "n/a")
        print(f"fig5 device {name}: " + "; ".join(
            f"{low} {p['device_us']:.1f} us in {p['kernels']:.0f} kernels" if p["whole"]
            else f"{low} n/a ({p['traced']:.0f} kernel records of "
                 f"{p['launch_calls']:.0f} launch calls)"
            for low, p in out[name].items()) + f"; SW/HW device {ratio}", flush=True)
    return out


# a decode split kernel's template arguments: q type, cache type, D, GR
DECODE_TEMPLATE = re.compile(r"decode_split_kernel<([^,]+), ([^,]+), (\d+), (\d+),")
CACHE_BYTES = {"signed char": 1, "char": 1, "__nv_bfloat16": 2, "float": 4}


def print_ptxas(report: dict, build) -> dict:
    """Print ptxas's registers, spills and shared memory (static, and the
    matmul and split kernels' dynamic bytes from the library) and the
    HMMA count of each kernel of matmul.cu, rmsnorm.cu,
    decode_attention.cu, verify_attention.cu and warp_ops.cu; fail unless
    every matmul kernel and verify's long-window tensor-core kernel (bf16
    and int8 pages, D 64 and 128) run on the tensor cores, ptxas
    reported both decode kernels, and no instance of rmsnorm's wide
    kernel spills."""
    smem = build.LIB.fn("repro_matmul_smem_bytes", [build.I])
    decode_smem = build.LIB.fn("repro_decode_smem_bytes", [build.I] * 3)
    for name, r in sorted(report.items()):
        if "matmul_tc_kernel" in name:
            r["dynamic_smem"] = smem(1 if "bfloat16" in name else 0)
        t = DECODE_TEMPLATE.search(name)
        if t:
            r["dynamic_smem"] = decode_smem(CACHE_BYTES[t.group(2).strip()],
                                            int(t.group(3)), int(t.group(4)))
        print(f"ptxas {name}: registers={r.get('registers')} {r.get('spills')}; "
              f"static smem {r.get('static_smem')} B, dynamic smem "
              f"{r.get('dynamic_smem', 0)} B; HMMA {r.get('hmma', 0)}", flush=True)
    mm = [n for n in report if "matmul_tc_kernel" in n]
    if len(mm) != 4 or any(not report[n].get("hmma") for n in mm):
        fail(f"the matmul kernels do not all run on the tensor cores: "
             f"{ {n: report[n].get('hmma', 0) for n in mm} }")
    long_tc = [n for n in report if "verify_long_tc_kernel" in n]
    if (len(long_tc) != 4 or sum("char" in n for n in long_tc) != 2
            or any(not report[n].get("hmma") for n in long_tc)):
        fail(f"verify's long-window tensor-core kernels (bf16 and int8 pages, D 64 and 128) "
             f"do not all run on the tensor cores: "
             f"{ {n: report[n].get('hmma', 0) for n in long_tc} }")
    for k in DECODE_KERNELS:
        if not any(k in n for n in report):
            fail(f"ptxas reported no {k}")
    wide = [n for n in report if "rmsnorm_wide_kernel" in n]
    spilled = {n: report[n].get("spills") for n in wide
               if re.search(r"[1-9]\d* bytes spill", report[n].get("spills", ""))}
    if not wide or spilled:
        fail(f"rmsnorm's wide kernel: {len(wide)} instances reported, spilling: {spilled}")
    return report


# ---------------------------------------------------------------------------
# phase 4h: the layer options (a padded head, tied embeddings)
# ---------------------------------------------------------------------------

OPTIONS_PAD = 256
OPTIONS_REQS = 4
OPTIONS_PROMPT = 256
OPTIONS_NEW = 16
OPTIONS_TIED_STEPS = 8


def padded_params(params, pad: int):
    """``params`` with ``pad`` zero rows appended to ``embed`` and zero
    columns to ``lm_head``: the same function under ``pad_vocab_to``."""
    e, h = params["embed"], params["lm_head"]
    return dict(params, embed=torch.cat([e, e.new_zeros(pad, e.shape[1])]),
                lm_head=torch.cat([h, h.new_zeros(h.shape[0], pad)], dim=1))


def run_options(cfg, model, params, spec, gen, smi: str) -> tuple:
    """Phase 4h (``options`` lines): the padded head against the unpadded
    one in fp32 compute, greedy and sampled, captured paged serving (gated
    on every token); the tied model's prefill and decode steps (finite
    logits, the real vocabulary's width); one captured decode step of
    each bf16 head profiled.  Returns the record and the launch counts."""
    from repro_torch import kernels
    from repro_torch.models.lm import Model

    t0 = time.perf_counter()
    pcfg = dataclasses.replace(cfg, pad_vocab_to=OPTIONS_PAD)
    pad = pcfg.vocab_padded - cfg.vocab
    print(f"options: pad_vocab_to={OPTIONS_PAD}: vocab {cfg.vocab} -> "
          f"{pcfg.vocab_padded} ({pad} zero rows of embed, zero columns of lm_head)",
          flush=True)
    reqs = [(u, p[:OPTIONS_PROMPT], OPTIONS_NEW) for u, p, _ in spec[:OPTIONS_REQS]]
    f_model, f_params = fp32_model(cfg, params)
    fp_model = Model(pcfg, device="cuda", dtype=torch.float32)
    fp_params = padded_params(f_params, pad)
    paged = dict(cache_layout="paged", page_size=PAGE_SIZE)
    rec, counts, greedy = {}, None, None
    for label, kw in (("greedy", {}), ("sampled", dict(temperature=SAMPLE_T,
                                                       seed=SAMPLE_SEED))):
        base, _, c0, _, _ = serve(f_model, f_params, reqs, **paged, **kw)
        got, eng, c1, wall, n_tok = serve(fp_model, fp_params, reqs, **paged, **kw)
        replays = eng.last_graph_stats["replays"]
        same = got == base
        print(f"options {label} fp32: the padded head serves the unpadded model's tokens "
              f"on {sum(got[u] == base[u] for u in base)} of {len(base)} requests; "
              f"{n_tok} tokens in {wall:.3f} s; {replays} captured replays; [{smi}]",
              flush=True)
        if not same:
            fail(f"options {label}: the padded head served other tokens than the "
                 "unpadded model in fp32")
        if replays == 0:
            fail(f"options {label}: the padded head's paged serving replayed no "
                 "captured step")
        rec[label] = dict(same_tokens=same, replays=replays, tokens=n_tok, wall_s=wall)
        counts = add_counts(c0, c1) if counts is None else add_counts(counts,
                                                                      add_counts(c0, c1))
        greedy = base if greedy is None else greedy
    del f_model, f_params, fp_model, fp_params

    # tied: no lm_head, embed.T is the head (the serving weights' embed)
    t_model = Model(dataclasses.replace(cfg, tie_embeddings=True), device="cuda",
                    dtype=torch.bfloat16)
    t_params = {k: v for k, v in params.items() if k != "lm_head"}
    uid, prompt, _ = reqs[0]
    kernels.reset_launches()
    tied = teacher_force(t_model, t_params, prompt, greedy[uid][:OPTIONS_TIED_STEPS + 1])
    torch.cuda.synchronize()
    t_counts = kernels.launch_counts()
    finite = bool(torch.isfinite(tied).all())
    print(f"options tied: prefill + {tied.shape[0] - 1} decode steps, logits "
          f"{tuple(tied.shape)}, finite {finite}, |logit| max "
          f"{tied.abs().max().item():.4e}", flush=True)
    if not finite or tied.shape != (OPTIONS_TIED_STEPS + 1, cfg.vocab):
        fail("the tied model's logits are not finite or not the vocabulary's width")
    counts = add_counts(counts, t_counts)
    rec["tied"] = dict(steps=tied.shape[0], finite=finite)
    del t_model, t_params, tied

    # one captured decode step of each bf16 head, profiled
    pb_model = Model(pcfg, device="cuda", dtype=torch.bfloat16)
    pb_params = padded_params(params, pad)
    steps = {"unpadded": graph_phase("options_decode_step_graph", model, params, "dense",
                                     gen),
             "padded": graph_phase("options_decode_step_padded_graph", pb_model,
                                   pb_params, "dense", gen)}
    del pb_model, pb_params
    print(f"options decode step (captured, bf16, {SLOTS} slots): padded head "
          f"{steps['padded']['device_ms']:.4f} kernel ms against unpadded "
          f"{steps['unpadded']['device_ms']:.4f}; [{smi}]", flush=True)
    rec["decode_step"] = {k: dict(device_ms=v["device_ms"], wall_ms=v["wall_ms"])
                          for k, v in steps.items()}
    rec["wall_s"] = time.perf_counter() - t0
    print(f"options: phase wall {rec['wall_s']:.1f} s", flush=True)
    return rec, counts


# ---------------------------------------------------------------------------
# phase 4i: the fleet (engine workers, router, controller)
# ---------------------------------------------------------------------------

FLEET_N = 12
FLEET_SYSTEM = 64
FLEET_FAULTS_SEED = 13
FLEET_KILL_ROUND = 3
FLEET_CLI_REQUESTS = 8


def fleet_requests(seed: int, vocab: int):
    """(uid, prompt, max_new) of 12 tenant requests: 64-token system
    prompts of 4 tenants under a Zipf popularity, private suffixes of
    median 48 (at most 192) tokens, median 16 (at most 32) new tokens."""
    from repro_torch.serve.workload import make_tenant_workload

    timed, tenant_of = make_tenant_workload(
        "poisson", FLEET_N, vocab=vocab, system_len=FLEET_SYSTEM, seed=seed,
        suffix_median=48, suffix_max=192, out_median=16, out_max=32)
    return [(t.request.uid, t.request.prompt, t.request.max_new_tokens)
            for t in timed], tenant_of


def fleet_run(model, params, spec, kill: bool = False, **kw):
    """One fleet over ``spec`` (``serve.cluster.make_cluster``, SLOTS slots a
    worker, 16-token pages): closed, or with worker 1 killed at round
    FLEET_KILL_ROUND (``kill``).  Returns (tokens, controller, launch
    counts, wall s)."""
    from repro_torch import kernels
    from repro_torch.serve.cluster import make_cluster
    from repro_torch.serve.engine import Request

    c = make_cluster(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS,
                     page_size=PAGE_SIZE, **kw)
    reqs = [Request(u, list(p), n) for u, p, n in spec]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    if kill:
        for r in reqs:
            c.submit(r)
        for _ in range(FLEET_KILL_ROUND):
            c.step()
        c.fail_worker(1)
        c.drain()
        out = c.close()
    else:
        out = c.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    no_ragged_rmsnorm("a fleet run", counts)
    if not c.audit_report.ok:
        fail(f"fleet audit failed: {c.audit_report.errors}")
    return out, c, counts, wall


def fleet_line(label: str, c, out, wall: float, smi: str):
    from repro_torch.serve.sla import format_summary

    r = c.last_stats["router"]
    n_tok = sum(len(v) for v in out.values())
    print(f"fleet {label}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s "
          f"(graph captures included); router {r['policy']} decisions {r['decisions']} "
          f"affinity_hits {r['affinity_hits']} handoffs {r['handoffs']} reroutes "
          f"{r['reroutes']} rounds {r['rounds']}; [{smi}]", flush=True)
    sla = c.last_stats["sla"]
    for wid, census in sorted(sla["replicas"].items()):
        pool = c.last_pool_stats.get(int(wid))
        print(f"fleet {label} replica {wid} ({c.workers[int(wid)].role}): "
              f"{census['requests']} requests {census['statuses']}; pool peak "
              f"{pool.peak_used_pages}/{pool.num_pages} pages, {pool.swap_ins} swap-ins, "
              f"{pool.swap_outs} swap-outs", flush=True)
    print(f"fleet {label} fleet_summary:\n" + format_summary(sla), flush=True)
    return dict(tokens=n_tok, wall_s=wall, tok_s=n_tok / wall, router=r,
                replicas=sla["replicas"], statuses=sla["statuses"])


def run_fleet_cli(label: str, args, smi: str) -> dict:
    """``python -m repro_torch.launch.serve`` with the fleet flags in a
    subprocess on the card; fails unless it exits 0 with a clean fleet
    audit."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
           "--cache-layout", "paged", "--requests", str(FLEET_CLI_REQUESTS)] + args
    return run_cli(f"fleet cli {label}", cmd, smi, "fleet audit: clean",
                   keep=("cluster:", "router:", "replica", "fleet audit", "goodput"))


def run_fleet(cfg, model, params, seed: int, smi: str) -> tuple:
    """Phase 4i (``fleet`` lines).  fp32 (the gates): a direct engine, (a)
    2 mixed replicas behind cache-aware, (b) 3 replicas disaggregated
    behind least-loaded, (c) (b) under ``faults_seed`` with worker 1
    killed.  bf16 (reported): the same direct engine, (a) and (b), the
    handoff's swap-out and restore ms in (b).  Then the serving CLI's
    fleet flags in two subprocesses.  Returns the record, the bf16 runs'
    launch counts and the fp32 runs'."""
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.cluster import worker as worker_mod
    from repro_torch.serve.sla import merge_ledgers

    t0 = time.perf_counter()
    spec, tenant_of = fleet_requests(seed, cfg.vocab)
    print(f"fleet requests: {len(spec)} of {[len(p) for _, p, _ in spec]} prompt tokens "
          f"(tenants {[tenant_of[u] for u, _, _ in spec]}, {FLEET_SYSTEM}-token system "
          f"prompts), {[n for _, _, n in spec]} new", flush=True)
    paged = dict(cache_layout="paged", page_size=PAGE_SIZE)
    a_kw = dict(replicas=2, router_policy="cache-aware")
    b_kw = dict(replicas=3, disaggregate=True, router_policy="least-loaded")
    rec = {"fp32": {}, "bf16": {}}

    f_model, f_params = fp32_model(cfg, params)
    direct, _, fp32_counts, _, _ = serve(f_model, f_params, spec, **paged)
    for label, kw, kill in (("a", a_kw, False), ("b", b_kw, False),
                            ("c", dict(b_kw, faults_seed=FLEET_FAULTS_SEED), True)):
        out, c, counts, wall = fleet_run(f_model, f_params, spec, kill=kill, **kw)
        fp32_counts = add_counts(fp32_counts, counts)
        r = fleet_line(f"{label} fp32", c, out, wall, smi)
        statuses = {u: c.fleet[u]["status"] for u, _, _ in spec}
        same = {u: out[u] == direct[u] for u in out}
        print(f"fleet {label} fp32: statuses {statuses}; tokens equal the direct "
              f"engine's on {sum(same.values())} of {len(out)} ok requests", flush=True)
        if not all(same.values()):
            fail(f"fleet {label} fp32: requests {[u for u, v in same.items() if not v]} "
                 "served other tokens than the direct engine")
        if label in ("a", "b") and len(out) != len(spec):
            fail(f"fleet {label} fp32: only {len(out)} of {len(spec)} requests ended ok")
        if label == "b":
            handoffs = {u: c.fleet[u]["handoffs"] for u, _, _ in spec}
            ledgers = merge_ledgers([dict(w.ledger) for w in c.workers.values()])
            swap_ins = {u: ledgers[u].get("swap_ins", 0) for u, _, _ in spec}
            print(f"fleet b fp32: handoffs per request {handoffs}; swap_ins per request "
                  f"{swap_ins}", flush=True)
            if set(handoffs.values()) != {1} or min(swap_ins.values()) < 1:
                fail("fleet b fp32: a request did not cross exactly one handoff with "
                     "its pages restored")
            r.update(handoffs=handoffs, swap_ins=swap_ins)
        if label == "c":
            if c.last_stats["router"]["reroutes"] < 1:
                fail("fleet c: killing worker 1 re-routed nothing")
            r["lost_worker"] = 1
        r["statuses_by_uid"] = statuses
        rec["fp32"][label] = r
    del f_model, f_params

    direct_b, _, bf16_counts, d_wall, d_tok = serve(model, params, spec, warm=True, **paged)
    print(f"fleet direct bf16: {d_tok} tokens in {d_wall:.3f} s = {d_tok / d_wall:.1f} "
          f"tok/s (warm engine); [{smi}]", flush=True)
    for label, kw in (("a", a_kw), ("b", b_kw)):
        with timed_calls(worker_mod.EngineWorker, "_detach") as out_s, \
                timed_calls(engine_mod.ServeEngine, "_admit_swapped_row") as in_s:
            out, c, counts, wall = fleet_run(model, params, spec, **kw)
        bf16_counts = add_counts(bf16_counts, counts)
        r = fleet_line(f"{label} bf16", c, out, wall, smi)
        differ = [u for u in direct_b if out.get(u) != direct_b[u]]
        r["agreement"] = agreement(direct_b, out)
        r["differ"] = differ
        print(f"fleet {label} bf16: token agreement with the direct engine "
              f"{r['agreement']:.4f}; requests that differ {differ} (reported: a "
              "prefill in another group or bucket may round otherwise in bf16, C1)",
              flush=True)
        if label == "b":
            r["swap_out_ms"] = [1e3 * t for t in out_s]
            r["restore_ms"] = [1e3 * t for t in in_s]
            print(f"fleet b bf16 handoff: swap-out (commit + device->host pages) ms "
                  f"p50 {np.median(r['swap_out_ms']):.3f} max {max(r['swap_out_ms']):.3f} "
                  f"over {len(out_s)}; restore (host->device pages at admission) ms p50 "
                  f"{np.median(r['restore_ms']):.3f} max {max(r['restore_ms']):.3f} over "
                  f"{len(in_s)}; [{smi}]", flush=True)
        rec["bf16"][label] = r
    rec["bf16"]["direct_tok_s"] = d_tok / d_wall
    rec["cli"] = {"a": run_fleet_cli("a", ["--replicas", "2", "--router", "cache-aware"],
                                     smi),
                  "b": run_fleet_cli("b", ["--replicas", "3", "--disaggregate"], smi)}
    rec["wall_s"] = time.perf_counter() - t0
    print(f"fleet: phase wall {rec['wall_s']:.1f} s", flush=True)
    return rec, bf16_counts, fp32_counts


# ---------------------------------------------------------------------------
# phase 7: Qwen1.5-32B at full width and depth
# ---------------------------------------------------------------------------

QWEN32_ARCH = "qwen1.5-32b"
QWEN32_NEW = 16
QWEN32_FORCED = 8
QWEN32_MARGIN = 2 * 2 ** 30     # activations, graph pool, allocator slack
QWEN32_NORM_ROW = "rmsnorm[wide] (d 5120)"                    # row 1c


def check_32b_shapes(cfg, gen: torch.Generator, rows: dict) -> dict:
    """The kernels at Qwen1.5-32B's shapes, which no earlier phase reaches:
    the flash forward at Hq = Hkv = 40 over one 512-token prompt, dense
    decode at 40/40 heads on the serving slots and positions, and rmsnorm
    over 4 x 512 bf16 rows of 5120, its wide branch (rows wider than 2048):
    a row of the kernel record of its own (``rmsnorm[wide] (d 5120)``, its
    launches the 32B run's), beside ``F.rms_norm`` and the ragged branch;
    and over 4 decode rows beside the ragged branch."""
    from repro_torch.kernels.decode_attention.ops import flash_decode
    from repro_torch.kernels.decode_attention.ref import flash_decode_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    hkv, dh, d = cfg.n_kv_heads, cfg.d_head, cfg.d_model
    g = cfg.n_heads // hkv
    out = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def check(name, fn, ref, *args, queued=False):
        got, want = fn(*args), ref(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ms, plain_ms = (cuda_ms(lambda: f(*args), iters=DECODE_ITERS if queued else 20,
                                queued=queued) for f in (fn, ref))
        print(f"kernel {name} (qwen32b): max_abs_err={err:.3e} tol={KERNEL_TOL} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
        if not agrees(got, want, KERNEL_TOL):
            fail(f"{name} disagrees with its plain version at Qwen1.5-32B's shape")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    q, k, v = (randn(1, 512, hkv * g, dh) for _ in "qkv")
    check(f"flash_attention_fwd Hq=Hkv={hkv} S 512", lambda *a: flash_attention_fwd(*a)[0],
          lambda *a: flash_attention_ref(*a)[0], q, k, v)
    qd, kv_view, vv_view, _, _, _, pos = decode_case(gen, hkv, g, dh)
    check(f"flash_decode {hkv}/{hkv} heads", flash_decode, flash_decode_ref, qd, kv_view,
          vv_view, pos, queued=True)
    out[QWEN32_NORM_ROW] = rmsnorm_wide_row(rows, QWEN32_NORM_ROW, randn(SLOTS * 512, d),
                                            randn(d), cfg.norm_eps)
    out["rmsnorm decode rows"] = rmsnorm_decode_rows(cfg, randn)
    return out


def rmsnorm_decode_rows(cfg, randn) -> dict:
    """rmsnorm over a decode step's SLOTS rows of d_model: the wide branch
    beside the ragged one (on a view one element into the same storage,
    not 16-byte aligned), each held against the plain version, and
    ``F.rms_norm``, the calls queued.  A launch-paced call: the wide
    branch fails if it is slower than the ragged one it replaced."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_branch
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    t0 = time.perf_counter()
    d = cfg.d_model
    flat, w = randn(SLOTS * d + 8), randn(d)
    views = {"wide": flat[8:].view(SLOTS, d), "ragged": flat[1:1 + SLOTS * d].view(SLOTS, d)}
    ms, err = {}, {}
    for branch, x in views.items():
        if rmsnorm_branch(x, w) != branch:
            fail(f"{SLOTS} x {d} rows took rmsnorm's {rmsnorm_branch(x, w)} branch, not {branch}")
        got, want = rmsnorm(x, w, cfg.norm_eps), rmsnorm_ref(x, w, cfg.norm_eps)
        torch.cuda.synchronize()
        err[branch] = max_err(got, want)
        if not agrees(got, want, KERNEL_TOL):
            fail(f"rmsnorm's {branch} branch disagrees with its plain version on {SLOTS} x "
                 f"{d} rows: max_abs_err {err[branch]:.3e}")
        ms[branch] = queued_ms(lambda: rmsnorm(x, w, cfg.norm_eps))
    x = views["wide"]
    ms["F.rms_norm"] = queued_ms(lambda: F.rms_norm(x, (d,), w, cfg.norm_eps))
    print(f"kernel rmsnorm[wide] ({SLOTS} x {d} decode rows): max_abs_err={err['wide']:.3e} "
          f"ms={ms['wide']:.4f}; ragged branch (a view one element into the same storage) "
          f"max_abs_err={err['ragged']:.3e} ms={ms['ragged']:.4f}; tol={KERNEL_TOL}; "
          f"F.rms_norm ms={ms['F.rms_norm']:.4f} (calls queued, the card's time); wide / "
          f"ragged {ms['wide'] / ms['ragged']:.3f}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if ms["wide"] > ms["ragged"]:
        fail(f"rmsnorm's wide branch is slower than its ragged one on {SLOTS} x {d} rows")
    return dict(ms=ms, max_abs_err=err)


def run_qwen32b(seed: int, gen: torch.Generator, rows: dict, smi: str) -> tuple:
    """Phase 7 (``qwen32b`` lines): the kernels at the 32B shapes, the
    memory count, greedy dense serving of 4 requests, request 0's first
    tokens teacher-forced on the plain path.  Returns the record and the
    serve run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model

    t0 = time.perf_counter()
    cfg = get_config(QWEN32_ARCH)
    shapes = check_32b_shapes(cfg, gen, rows)
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    per_layer = (d * hq * dh + 2 * d * hkv * dh + hq * dh * d + (hq + 2 * hkv) * dh
                 + 3 * d * f + 2 * d)
    n_params = L * per_layer + 2 * V * d + d
    weight_bytes = 2 * n_params
    cache_bytes = 2 * L * SLOTS * MAX_SEQ * hkv * dh * 2
    # the prefill returns its batch's dense K/V (at most max_seq rows) for
    # the engine to copy into its cache
    prefill_bytes = cache_bytes
    # an earlier phase's engines may sit in reference cycles (their graphs
    # hold device pools): collect them before counting what is free
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    need = weight_bytes + cache_bytes + prefill_bytes + QWEN32_MARGIN
    print(f"qwen32b count: {n_params} parameters = {weight_bytes / 1e9:.2f} GB of bf16 "
          f"weights; KV cache {cache_bytes / 1e9:.2f} GB ({2 * L * hkv * dh * 2 / 1e6:.2f} "
          f"MB a token x {SLOTS} slots x {MAX_SEQ}); prefill copy {prefill_bytes / 1e9:.2f} "
          f"GB; margin {QWEN32_MARGIN / 2 ** 30:.0f} GiB; need {need / 2 ** 30:.2f} GiB; "
          f"free before the init {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB "
          f"(allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB); [{smi}]",
          flush=True)
    if need > free:
        fail(f"Qwen1.5-32B does not fit: need {need / 2 ** 30:.2f} GiB, "
             f"{free / 2 ** 30:.2f} GiB free")
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    t_init = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    print(f"qwen32b model: layers={L} d_model={d} heads={hq}/{hkv} d_head={dh} d_ff={f} "
          f"vocab={V} dtype=bf16; init {init_s:.1f} s (stacked leaves filled in place); "
          f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    rng = np.random.default_rng(seed + 32)
    lens = [512] + rng.integers(128, 513, SLOTS - 1).tolist()
    spec = [(i, rng.integers(0, V, n).tolist(), QWEN32_NEW) for i, n in enumerate(lens)]
    out, eng, counts, wall, n_tok = serve(model, params, spec, warm=True)
    peak = eng.base_bytes + eng.peak_bytes
    ttft = [eng.last_stats[u]["first_token_s"] - eng.last_stats[u]["enqueued_s"]
            for u, _, _ in spec]
    decode_ms = 1e3 * (wall - max(ttft)) / (QWEN32_NEW - 1)
    bound_ms = 1e3 * weight_bytes / HBM_BYTES_S
    print(f"qwen32b serve dense: {len(spec)} requests of {lens} prompt tokens, "
          f"{QWEN32_NEW} new: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s; "
          f"TTFT ms {[round(1e3 * t, 1) for t in ttft]}; decode {decode_ms:.2f} ms a step "
          f"(the weights' read alone {bound_ms:.2f} ms); peak memory {peak / 2 ** 30:.2f} "
          f"GiB; launches flash_attention_fwd {counts['flash_attention_fwd']}, "
          f"flash_decode {counts['flash_decode']}, rmsnorm[wide] "
          f"{counts['rmsnorm[wide]']} (warp branch {counts['rmsnorm']}, ragged "
          f"{counts['rmsnorm[ragged]']}); [{smi}]",
          flush=True)
    for name in ("flash_attention_fwd", "flash_decode", "rmsnorm[wide]"):
        if counts[name] == 0:
            fail(f"{name} never launched while serving Qwen1.5-32B")
    uid, prompt, _ = spec[0]
    k_logits = teacher_force(model, params, prompt, out[uid][:QWEN32_FORCED])
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    p_logits = teacher_force(plain, params, prompt, out[uid][:QWEN32_FORCED])
    err, scale, agree = compare_logits(f"qwen32b uid {uid} plain vs kernel path",
                                       p_logits, k_logits)
    rec = dict(n_params=n_params, weight_bytes=weight_bytes, cache_bytes=cache_bytes,
               free_before_init=free, total=total, init_s=init_s, tok_s=n_tok / wall,
               wall_s=wall, ttft_s=ttft, decode_ms=decode_ms, weight_read_ms=bound_ms,
               peak_bytes=peak, counts=counts, teacher_forced_max_err=err,
               logit_scale=scale, teacher_forced_argmax_agreement=agree,
               kernels_at_32b_shapes=shapes, phase_wall_s=time.perf_counter() - t0)
    print(f"qwen32b: phase wall {rec['phase_wall_s']:.1f} s", flush=True)
    del model, params, plain, eng, k_logits, p_logits
    torch.cuda.empty_cache()
    return rec, counts


# ---------------------------------------------------------------------------
# phase 7b: MiniCPM3-4B (MLA) at full width and depth
# ---------------------------------------------------------------------------

MLA_ARCH = "minicpm3-4b"
MLA_NEW = 16
MLA_FORCED = 8
MLA_MARGIN = 2 * 2 ** 30        # activations, graph pool, allocator slack
# the f32 CUDA-core kernel against its plain version: sums of 96 products
# and of up to 512 keys in another order (the card tests' f32 tolerance)
F32_FLASH_TOL = dict(atol=2e-5, rtol=2e-5)
MLA_FLASH_ROW = "flash_attention_fwd (MLA D 96 / Dv 64)"
MLA_NORM_ROW = "rmsnorm[wide] (d 2560)"                       # row 1d


def mla_params(cfg) -> int:
    """MiniCPM3's parameter count from its config (the port's leaves)."""
    d, h, L, V = cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.vocab
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    attn = (d * qr + qr + qr * h * (nd + rd) + d * (kr + rd) + kr + kr * h * (nd + vd)
            + h * vd * d)
    return L * (attn + 3 * d * cfg.d_ff + 2 * d) + 2 * V * d + d


def check_mla_shapes(cfg, gen: torch.Generator, rows: dict) -> dict:
    """The kernels at MiniCPM3's shapes: the flash forward's (96, 64)
    instance at its prefill (4 x 512 tokens, 40 heads, causal; v a strided
    view into the (.., nope + v) row, as ``mla_block_kv`` passes it) in
    bf16 (row ``MLA_FLASH_ROW``) and f32, and rmsnorm's branches at the
    latent norms' widths and at d_model, over prefill and decode rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_branch
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    h, nd, rd, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    b, s, dq = SLOTS, 512, nd + rd
    out = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k = randn(b, s, h, dq), randn(b, s, h, dq)
    v = randn(b, s, h, nd + vd)[..., nd:]
    (got, lse), (want, lse_ref) = flash_attention_fwd(q, k, v), flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    lse_err = (lse - lse_ref).abs().max().item()
    if got.shape != (b, s, h, vd) or lse_err > 1e-3:
        fail(f"the (96, 64) flash forward gave o {tuple(got.shape)}, lse off by {lse_err}")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    # 100 calls after 10: a 20-call window right after the 32B phase read
    # up to 1.8x the time of a longer one
    timing = dict(iters=100, warmup=10)
    try:
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                          **timing)
    except RuntimeError as exc:
        sdpa_ms = None
        print(f"kernel {MLA_FLASH_ROW}: SDPA refused Dv != D: {str(exc).splitlines()[0]}",
              flush=True)
    pairs = b * h * s * (s + 1) // 2                   # live (query, key) pairs
    # bytes: q, k and v's 64 elements a row read, o written, lse written;
    # operations: 2 * D for Q.K^T and 2 * Dv for P.V a live pair
    record_kernel(rows, MLA_FLASH_ROW,
                  "src/repro_torch/kernels/flash_attention/flash_attention.cu",
                  "src/repro/kernels/flash_attention/flash_attention.py:123", got, want,
                  FLASH_FWD_TOL, cuda_ms(lambda: flash_attention_fwd(q, k, v), **timing),
                  cuda_ms(lambda: flash_attention_ref(q, k, v)),
                  2 * (2 * q.numel() + 2 * b * s * h * vd) + b * h * s * 4,
                  (2 * dq + 2 * vd) * pairs, BF16_FLOPS_S, sdpa_ms,
                  branch=FLASH_BRANCHES[q.dtype])
    out[MLA_FLASH_ROW] = {key: rows[MLA_FLASH_ROW][key] for key in
                          ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    flips = (got != want).double().mean().item()
    print(f"kernel {MLA_FLASH_ROW}: {flips:.4%} of the bf16 outputs round to another "
          f"value than the plain version's", flush=True)
    q32, k32, v32 = q.float(), k.float(), randn(b, s, h, nd + vd, dtype=torch.float32)[..., nd:]
    got32, want32 = flash_attention_fwd(q32, k32, v32)[0], flash_attention_ref(q32, k32, v32)[0]
    torch.cuda.synchronize()
    err32, ok32 = max_err(got32, want32), agrees(got32, want32, F32_FLASH_TOL)
    ms32 = cuda_ms(lambda: flash_attention_fwd(q32, k32, v32), iters=5, warmup=1)
    b_ms32, b_by32 = bound(2 * (q32.numel() * 4 + b * s * h * vd * 4) + b * h * s * 4,
                           (2 * dq + 2 * vd) * pairs, F32_FLOPS_S)
    print(f"kernel flash_attention_fwd (MLA D 96 / Dv 64, f32): max_abs_err={err32:.3e} "
          f"tol={F32_FLASH_TOL} ok={ok32} ms={ms32:.4f} bound_ms={b_ms32:.4f} ({b_by32}) "
          f"branch={FLASH_BRANCHES[torch.float32]}", flush=True)
    if not ok32:
        fail("the f32 (96, 64) flash forward disagrees with its plain version")
    out["flash_attention_fwd (MLA, f32)"] = dict(max_abs_err=err32, ms=ms32, bound_ms=b_ms32)
    del q, k, v, got, want, qt, kt, vt, q32, k32, v32, got32, want32
    for width in (cfg.q_lora_rank, cfg.kv_lora_rank):
        x, w = randn(b * s, width), randn(width)
        took = rmsnorm_branch(x, w)
        g, r = rmsnorm(x, w, cfg.norm_eps), rmsnorm_ref(x, w, cfg.norm_eps)
        torch.cuda.synchronize()
        err, ok = max_err(g, r), agrees(g, r, KERNEL_TOL)
        ms = queued_ms(lambda: rmsnorm(x, w, cfg.norm_eps))
        print(f"kernel rmsnorm (MLA d {width}): {took} branch, max_abs_err={err:.3e} "
              f"tol={KERNEL_TOL} ok={ok} ms={ms:.4f} (card)", flush=True)
        if took != "warp" or not ok:
            fail(f"rmsnorm at d {width} took its {took} branch (expected warp) "
                 f"or disagrees with its plain version")
        out[f"rmsnorm (MLA d {width})"] = dict(branch=took, max_abs_err=err, ms=ms)
    # d_model: the wide branch, a row of its own
    out[MLA_NORM_ROW] = rmsnorm_wide_row(rows, MLA_NORM_ROW, randn(b * s, cfg.d_model),
                                         randn(cfg.d_model), cfg.norm_eps)
    out["rmsnorm decode rows"] = rmsnorm_decode_rows(cfg, randn)
    return out


def run_mla(seed: int, gen: torch.Generator, rows: dict, smi: str) -> tuple:
    """Phase 7b (``mla`` lines): the kernels at MiniCPM3's shapes, the
    memory count, greedy dense serving of 4 requests, the profiles of a
    prefill and a decode step (eager and replayed), request 0's first
    tokens teacher-forced on the plain path, and the paged layout refused.
    Returns the record and the serve run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.step_graph import StepGraphs

    t0 = time.perf_counter()
    cfg = get_config(MLA_ARCH)
    shapes = check_mla_shapes(cfg, gen, rows)
    L, V, d = cfg.n_layers, cfg.vocab, cfg.d_model
    n_params = mla_params(cfg)
    weight_bytes = 2 * n_params
    token_bytes = 2 * L * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)   # latent + rope
    cache_bytes = token_bytes * SLOTS * MAX_SEQ
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    # the prefill returns its batch's latent cache for the engine to copy
    need = weight_bytes + 2 * cache_bytes + MLA_MARGIN
    print(f"mla count: {n_params} parameters = {weight_bytes / 1e9:.2f} GB of bf16 "
          f"weights; latent cache {token_bytes / 1e3:.1f} KB a token x {SLOTS} slots x "
          f"{MAX_SEQ} = {cache_bytes / 1e9:.3f} GB (GQA at 40/40 heads of 64 would keep "
          f"{2 * L * 2 * cfg.n_heads * 64 / 1e3:.1f} KB); need {need / 2 ** 30:.2f} GiB with "
          f"the prefill copy and a {MLA_MARGIN / 2 ** 30:.0f} GiB margin; free before the "
          f"init {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB; [{smi}]", flush=True)
    if need > free:
        fail(f"MiniCPM3-4B does not fit: need {need / 2 ** 30:.2f} GiB, "
             f"{free / 2 ** 30:.2f} GiB free")
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    t_init = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    print(f"mla model: layers={L} d_model={d} heads={cfg.n_heads} q_rank={cfg.q_lora_rank} "
          f"kv_rank={cfg.kv_lora_rank} qk={cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim} "
          f"v={cfg.v_head_dim} d_ff={cfg.d_ff} vocab={V} dtype=bf16; init {init_s:.1f} s; "
          f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    rng = np.random.default_rng(seed + 3)
    lens = [512] + rng.integers(128, 513, SLOTS - 1).tolist()
    spec = [(i, rng.integers(0, V, n).tolist(), MLA_NEW) for i, n in enumerate(lens)]
    out, eng, counts, wall, n_tok = serve(model, params, spec, warm=True)
    peak = eng.base_bytes + eng.peak_bytes
    ttft = [eng.last_stats[u]["first_token_s"] - eng.last_stats[u]["enqueued_s"]
            for u, _, _ in spec]
    decode_ms = 1e3 * (wall - max(ttft)) / (MLA_NEW - 1)
    read_ms = 1e3 * weight_bytes / HBM_BYTES_S
    print(f"mla serve dense: {len(spec)} requests of {lens} prompt tokens, {MLA_NEW} new: "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s; TTFT ms "
          f"{[round(1e3 * t, 1) for t in ttft]}; decode {decode_ms:.2f} ms a step (the "
          f"weights' read alone {read_ms:.2f} ms); peak memory {peak / 2 ** 30:.2f} GiB; "
          f"graphs {eng.warm_graph_stats['graphs']} captured in the warm session, "
          f"{eng.last_graph_stats['replays']} replays; "
          f"launches flash_attention_fwd[dv] {counts['flash_attention_fwd[dv]']}, rmsnorm "
          f"{counts['rmsnorm']}, rmsnorm[wide] {counts['rmsnorm[wide]']}, rmsnorm[ragged] "
          f"{counts['rmsnorm[ragged]']}; [{smi}]",
          flush=True)
    for name in ("flash_attention_fwd[dv]", "rmsnorm", "rmsnorm[wide]"):
        if counts[name] == 0:
            fail(f"{name} never launched while serving MiniCPM3-4B")
    if eng.last_graph_stats["replays"] == 0:
        fail("the MLA decode steps were not replayed as captured graphs")
    stray = {n: counts[n] for n in ("flash_attention_fwd", "flash_attention_fwd[f32]",
                                    "flash_attention_fwd[dv,f32]", "flash_decode",
                                    "paged_flash_decode") if counts[n]}
    if stray:
        fail(f"the MLA run launched kernels off its path: {stray}")
    # where the time goes: one 4 x 512 prefill eager, and the decode step
    # as the engine replays it (one captured graph); few calls, since a
    # step is ~4 300 kernels and the profiler's records of each cost host
    # seconds
    toks = torch.randint(0, V, (SLOTS, 512), generator=gen, device="cuda")
    st = step_state(model, params, "dense", gen)
    graphs = StepGraphs("cuda", enabled=True)
    graphs.run(("dense", ATTEND), st["fn"], restore=st["restore"])

    def replay():
        st["reset"]()
        graphs.run(("dense", ATTEND), st["fn"])

    phases = {"mla_prefill_4x512": profile_phase("mla_prefill_4x512",
                                                 lambda: model.prefill(params, toks, 512), 2),
              "mla_decode_step_graph": profile_phase("mla_decode_step_graph", replay, 3)}
    del st, graphs, toks
    uid, prompt, _ = spec[0]
    k_logits = teacher_force(model, params, prompt, out[uid][:MLA_FORCED])
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    p_logits = teacher_force(plain, params, prompt, out[uid][:MLA_FORCED])
    err, scale, agree = compare_logits(f"mla uid {uid} plain vs kernel path",
                                       p_logits, k_logits)
    try:
        ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS, cache_layout="paged")
    except ValueError as exc:
        print(f"mla paged layout refused: {exc}", flush=True)
    else:
        fail("a paged MiniCPM3-4B engine was built; MLA's latent cache stays dense")
    rec = dict(n_params=n_params, weight_bytes=weight_bytes, latent_bytes_a_token=token_bytes,
               cache_bytes=cache_bytes, free_before_init=free, total=total, init_s=init_s,
               tok_s=n_tok / wall, wall_s=wall, ttft_s=ttft, decode_ms=decode_ms,
               weight_read_ms=read_ms, peak_bytes=peak, counts=counts,
               teacher_forced_max_err=err, logit_scale=scale,
               teacher_forced_argmax_agreement=agree, kernels_at_mla_shapes=shapes,
               phases=phases, phase_wall_s=time.perf_counter() - t0)
    print(f"mla: phase wall {rec['phase_wall_s']:.1f} s", flush=True)
    del model, params, plain, eng, k_logits, p_logits
    torch.cuda.empty_cache()
    return rec, counts


# ---------------------------------------------------------------------------
# phase 7c: RWKV6-7B and Zamba2-2.7B, the recurrent families
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("rwkv6-7b", "zamba2-2.7b")
RECURRENT_NEW = 32
RECURRENT_PROMPT = 512       # request 0's prompt; the others 128-512 tokens
RECURRENT_FORCED = 8
# the profiled prefill's length: a 512-token prefill is ~68k (RWKV6) and
# ~86k (Zamba2) launches, whose records take the profiler ~15 s to sum
RECURRENT_PROFILE_TOKENS = 128
# the scans' per-token products at a 512-token prefill (RWKV6: k v^T and
# its bonus-weighted copy, 1.07 GB a layer; Mamba2: dt x B^T, 0.67 GB),
# the graph pool and allocator slack
RECURRENT_MARGIN = 4 * 2 ** 30
# the fp32 control: full width, depth cut to 4 RWKV6 layers and 12 Zamba2
# layers (two groups of the shared block and 6 Mamba2 layers); decode from
# an empty state against forward within the reference test's tolerance
# (tests/test_arch_smoke.py:90)
RECURRENT_CONTROL_LAYERS = {"rwkv6-7b": 4, "zamba2-2.7b": 12}
RECURRENT_CONTROL_SEQ = 16
RECURRENT_CONTROL_TOL = dict(rtol=2e-3, atol=2e-3)
D80_FLASH_ROW = "flash_attention_fwd (Zamba2 D 80)"              # row 2e
D80_FLASH_F32_ROW = "flash_attention_fwd (Zamba2 D 80, f32)"
D80_DECODE_ROW = "flash_decode (Zamba2 D 80)"                     # row 4c
D80_DECODE_F32_ROW = "flash_decode (Zamba2 D 80, f32)"
RWKV_NORM_ROW = "rmsnorm[wide] (RWKV6 d 4096)"                   # row 1f
MAMBA_NORM_ROW = "rmsnorm[wide] (Mamba2 d_in 5120)"              # row 1g
# each serving run's kernels: every other counter must stay at 0
RECURRENT_KERNELS = {"rwkv6-7b": ("rmsnorm[wide]",),
                     "zamba2-2.7b": ("rmsnorm[wide]", "flash_attention_fwd[d80]",
                                     "flash_decode[d80]")}
RECURRENT_CONTROL_KERNELS = {"rwkv6-7b": ("rmsnorm[wide]",),
                             "zamba2-2.7b": ("rmsnorm[wide]", "flash_attention_fwd[d80,f32]",
                                             "flash_decode[d80]")}
# C11: the faulted controls of the teacher-forced bf16 gate, a kernel
# site's output (Zamba2: the shared block's attention at D 80, flash
# forward and flash_decode) or weight (RWKV6: every rmsnorm[wide] row's
# weight, the only kernel it runs) scaled by each factor in turn, smallest
# first, until the gate trips; the largest must trip it
C11_SCALES = (1.001, 1.003, 1.01, 1.03, 1.1, 1.3)


def recurrent_params(cfg) -> int:
    """RWKV6's or Zamba2's parameter count from its config (the port's
    leaves)."""
    d, L, V, f = cfg.d_model, cfg.n_layers, cfg.vocab, cfg.d_ff
    head = V * d * (1 if cfg.tie_embeddings else 2) + d          # embed, lm_head, ln_f
    if cfg.family == "ssm":
        # mu 5d; wr wk wv wg wo cr; w0, bonus, ln_x; wA, wB; mu_c; ck, cv; ln1, ln2
        lora = 64
        return head + L * (5 * d + 6 * d * d + 3 * d + 2 * d * lora + 2 * d + 2 * d * f + 2 * d)
    d_in, n, nh = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_expand * d // cfg.ssm_head_dim
    mamba = (d * (2 * d_in + 2 * n + nh) + (cfg.ssm_conv + 1) * (d_in + 2 * n) + 3 * nh
             + d_in + d_in * d + d)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shared = 2 * d + 2 * d * hq * dh + 2 * d * hkv * dh + 3 * d * f
    return head + L * mamba + shared


def check_recurrent_shapes(gen: torch.Generator, rows: dict) -> dict:
    """The kernels at the recurrent models' shapes, which no earlier phase
    reaches: the flash forward's (80, 80) instance at Zamba2's prefill
    call (1 x 512 tokens, 32 / 32 heads, causal) and dense decode at D 80
    (4 slots, Hkv 32, G 1, all 576 keys live), each in bf16 and f32 and a
    row of the kernel record beside SDPA on the same inputs, every time
    with the calls queued but the plain versions'; and rmsnorm's wide
    branch over 512 rows of RWKV6's 4096 and of Mamba2's inner 5120
    (rows ``RWKV_NORM_ROW`` and ``MAMBA_NORM_ROW``) beside F.rms_norm."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import flash_decode
    from repro_torch.kernels.decode_attention.ref import flash_decode_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    t0 = time.perf_counter()
    z = get_config("zamba2-2.7b")
    h, hkv, dh, s, b = z.n_heads, z.n_kv_heads, z.d_head, 512, SLOTS
    out = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    pairs = h * s * (s + 1) // 2                      # live (query, key) pairs
    for dtype, name, tol, peak in ((torch.bfloat16, D80_FLASH_ROW, FLASH_FWD_TOL, BF16_FLOPS_S),
                                   (torch.float32, D80_FLASH_F32_ROW, F32_FLASH_TOL,
                                    F32_FLOPS_S)):
        q, k, v = (randn(1, s, h, dh, dtype=dtype) for _ in "qkv")
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        got, want = flash_attention_fwd(q, k, v)[0], flash_attention_ref(q, k, v)[0]
        # bytes: q, k, v read and o written once, lse written; operations:
        # 2 * D for Q.K^T and 2 * Dv for P.V a live pair
        record_kernel(rows, name, "src/repro_torch/kernels/flash_attention/flash_attention.cu",
                      "src/repro/kernels/flash_attention/flash_attention.py:123", got, want, tol,
                      queued_ms(lambda: flash_attention_fwd(q, k, v)),
                      cuda_ms(lambda: flash_attention_ref(q, k, v)),
                      4 * q.numel() * q.element_size() + h * s * 4, 4 * dh * pairs, peak,
                      queued_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      is_causal=True)),
                      branch=FLASH_BRANCHES[dtype])
        out[name] = {key: rows[name][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "library_ms")}
        if dtype == torch.bfloat16:
            flips = (got != want).double().mean().item()
            print(f"kernel {name}: {flips:.4%} of the bf16 outputs round to another value "
                  f"than the plain version's", flush=True)
            out[name]["flip_share"] = flips
        del q, k, v, qt, kt, vt, got, want
    pos = torch.full((b,), MAX_SEQ - 1, dtype=torch.int32, device="cuda")
    for dtype, name, tol, peak in ((torch.bfloat16, D80_DECODE_ROW, KERNEL_TOL, BF16_FLOPS_S),
                                   (torch.float32, D80_DECODE_F32_ROW, F32_FLASH_TOL,
                                    F32_FLOPS_S)):
        q = randn(b, hkv, h // hkv, dh, dtype=dtype)
        k, v = randn(b, MAX_SEQ, hkv, dh, dtype=dtype), randn(b, MAX_SEQ, hkv, dh, dtype=dtype)
        q4 = q.reshape(b, 1, h, dh).transpose(1, 2)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        got, want = flash_decode(q, k, v, pos), flash_decode_ref(q, k, v, pos)
        record_kernel(rows, name, "src/repro_torch/kernels/decode_attention/decode_attention.cu",
                      "src/repro/kernels/decode_attention/decode_attention.py:108", got, want,
                      tol, queued_ms(lambda: flash_decode(q, k, v, pos)),
                      queued_ms(lambda: flash_decode_ref(q, k, v, pos)),
                      (2 * q.numel() + 2 * k.numel()) * q.element_size(),
                      4 * dh * h * b * MAX_SEQ, peak,
                      queued_ms(lambda: F.scaled_dot_product_attention(q4, kt, vt)))
        out[name] = {key: rows[name][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "library_ms")}
        sdpa_factor(name, rows[name]["ms"], rows[name]["library_ms"])
        del q, k, v, q4, kt, vt, got, want
    out[RWKV_NORM_ROW] = rmsnorm_wide_row(rows, RWKV_NORM_ROW, randn(512, 4096), randn(4096),
                                          1e-6)
    out[MAMBA_NORM_ROW] = rmsnorm_wide_row(rows, MAMBA_NORM_ROW, randn(512, 5120),
                                           randn(5120), 1e-6)
    print(f"recurrent kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def recurrent_control(arch: str, seed: int, gen: torch.Generator) -> dict:
    """The fp32 control at full width, depth cut (RECURRENT_CONTROL_LAYERS):
    RECURRENT_CONTROL_SEQ teacher-forced decode steps of 2 rows from an
    empty state against ``forward``'s logits within the reference test's
    2e-3, through the f32 instances (Zamba2: the flash forward's (80, 80)
    and dense decode's D 80)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model

    cfg = dataclasses.replace(get_config(arch), n_layers=RECURRENT_CONTROL_LAYERS[arch])
    model = Model(cfg, device="cuda", dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    toks = torch.randint(0, cfg.vocab, (2, RECURRENT_CONTROL_SEQ), generator=gen,
                         device="cuda")
    kernels.reset_launches()
    with torch.no_grad():
        want = model.forward(params, {"tokens": toks})
    cache = model.init_cache(2, 64)
    steps = []
    for t in range(RECURRENT_CONTROL_SEQ):
        logits, cache = model.decode_step(params, cache, toks[:, t],
                                          torch.full((2,), t, dtype=torch.int32, device="cuda"))
        steps.append(logits)
    got = torch.stack(steps, dim=1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, **RECURRENT_CONTROL_TOL)
    print(f"recurrent {arch} fp32 control (full width, {cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers): {RECURRENT_CONTROL_SEQ} decode steps from an "
          f"empty state vs forward, max |logit err| {err:.3e} (tol {RECURRENT_CONTROL_TOL}, "
          f"logit scale {want.abs().max().item():.3e}) ok={ok}; launches "
          f"{ {n: c for n, c in counts.items() if c} }", flush=True)
    if not ok:
        fail(f"{arch}'s fp32 decode from an empty state differs from forward by {err:.3e}")
    want_kernels = RECURRENT_CONTROL_KERNELS[arch]
    stray = {n: c for n, c in counts.items() if c and n not in want_kernels}
    missing = [n for n in want_kernels if counts[n] == 0]
    if stray or missing:
        fail(f"{arch}'s fp32 control launched {stray} off its path or never launched "
             f"{missing}")
    del model, params, cache, want, got, steps
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, seq=RECURRENT_CONTROL_SEQ, max_err=err, counts=counts)


def run_recurrent_model(arch: str, seed: int, gen: torch.Generator, smi: str) -> dict:
    """One recurrent model at full width and depth, bf16: the memory
    count, greedy dense serving of 4 requests (the decode steps captured),
    the profiles of a prefill and a replayed decode step, request 0's
    first tokens teacher-forced on the plain path, the paged layout
    refused, then the fp32 control."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import leaves
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.step_graph import StepGraphs

    t0 = time.perf_counter()
    cfg = get_config(arch)
    tag = arch.split("-")[0]
    n_params = recurrent_params(cfg)
    weight_bytes = 2 * n_params
    meta_cache = Model(cfg, device="meta", dtype=torch.bfloat16).init_cache(SLOTS, MAX_SEQ)
    cache_bytes = sum(t.numel() * t.element_size() for t in meta_cache.values())
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    need = weight_bytes + 2 * cache_bytes + RECURRENT_MARGIN
    print(f"recurrent {arch} count: {n_params} parameters = {weight_bytes / 1e9:.2f} GB of "
          f"bf16 weights; cache {cache_bytes / 1e6:.1f} MB for {SLOTS} slots x {MAX_SEQ} "
          f"({ {n: tuple(t.shape) for n, t in meta_cache.items()} }); need "
          f"{need / 2 ** 30:.2f} GiB with the prefill's copy and a "
          f"{RECURRENT_MARGIN / 2 ** 30:.0f} GiB margin; free before the init "
          f"{free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB; [{smi}]", flush=True)
    if need > free:
        fail(f"{arch} does not fit: need {need / 2 ** 30:.2f} GiB, {free / 2 ** 30:.2f} GiB free")
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    t_init = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    counted = sum(p.numel() for p in leaves(params))
    print(f"recurrent {arch} model: family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} d_ff={cfg.d_ff} vocab={cfg.vocab} dtype=bf16, {counted} "
          f"parameters; init {init_s:.1f} s; allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    if counted != n_params:
        fail(f"{arch}: the init made {counted} parameters, the count says {n_params}")
    rng = np.random.default_rng(seed + 35)
    lens = [RECURRENT_PROMPT] + rng.integers(128, RECURRENT_PROMPT + 1, SLOTS - 1).tolist()
    spec = [(i, rng.integers(0, cfg.vocab, n).tolist(), RECURRENT_NEW)
            for i, n in enumerate(lens)]
    out, eng, counts, wall, n_tok = serve(model, params, spec, warm=True)
    peak = eng.base_bytes + eng.peak_bytes
    ttft = [eng.last_stats[u]["first_token_s"] - eng.last_stats[u]["enqueued_s"]
            for u, _, _ in spec]
    decode_ms = 1e3 * (wall - max(ttft)) / (RECURRENT_NEW - 1)
    read_ms = 1e3 * weight_bytes / HBM_BYTES_S
    g, warm_graphs = eng.last_graph_stats, eng.warm_graph_stats["graphs"]
    print(f"recurrent {arch} serve dense: {len(spec)} requests of {lens} prompt tokens, "
          f"{RECURRENT_NEW} new: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s; "
          f"TTFT ms {[round(1e3 * t, 1) for t in ttft]}; decode {decode_ms:.2f} ms a step "
          f"(the weights' read alone {read_ms:.2f} ms); peak memory {peak / 2 ** 30:.2f} GiB; "
          f"graphs {warm_graphs} captured in the warm session, "
          f"{g['replays']} replays; launches rmsnorm[wide] {counts['rmsnorm[wide]']}, "
          f"flash_attention_fwd[d80] {counts['flash_attention_fwd[d80]']}, flash_decode[d80] "
          f"{counts['flash_decode[d80]']}, rmsnorm[ragged] {counts['rmsnorm[ragged]']}; "
          f"prefill groups {eng.last_prefill_groups}; [{smi}]", flush=True)
    want_kernels = RECURRENT_KERNELS[arch]
    for name in want_kernels:
        if counts[name] == 0:
            fail(f"{name} never launched while serving {arch}")
    stray = {n: c for n, c in counts.items() if c and n not in want_kernels}
    if stray:
        fail(f"the {arch} run launched kernels off its path: {stray}")
    if g["replays"] == 0:
        fail(f"the {arch} decode steps were not replayed as captured graphs")
    if any(len(uids) != 1 or [bucket] != n for uids, bucket, n in eng.last_prefill_groups):
        fail(f"{arch} prefilled a request beside another or padded: "
             f"{eng.last_prefill_groups}")
    # where the time goes: the first RECURRENT_PROFILE_TOKENS of request
    # 0's prompt prefilled alone (one scan a layer, a loop over the tokens
    # on the host: the same launches a token at any length), and the
    # decode step as the engine replays it (one captured graph)
    toks = torch.tensor([spec[0][1][:RECURRENT_PROFILE_TOKENS]], device="cuda")
    st = step_state(model, params, "dense", gen)
    graphs = StepGraphs("cuda", enabled=True)
    graphs.run(("dense", ATTEND), st["fn"], restore=st["restore"])

    def replay():
        st["reset"]()
        graphs.run(("dense", ATTEND), st["fn"])

    parts = {"serve": time.perf_counter() - t0}
    t1 = time.perf_counter()
    prefill = f"{tag}_prefill_1x{RECURRENT_PROFILE_TOKENS}"
    # the served sessions prefilled longer prompts already: no warm-up call
    phases = {prefill: profile_phase(prefill, lambda: model.prefill(params, toks, MAX_SEQ), 1,
                                     device_only=True, warm=False),
              f"{tag}_decode_step_graph": profile_phase(f"{tag}_decode_step_graph", replay, 3)}
    del st, graphs, toks
    parts["profiles"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    uid, prompt, _ = spec[0]
    forced = recurrent_teacher_forced(arch, cfg, model, params, prompt,
                                      out[uid][:RECURRENT_FORCED])
    parts["teacher_forced"] = time.perf_counter() - t1
    try:
        ServeEngine(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS, cache_layout="paged")
    except ValueError as exc:
        print(f"recurrent {arch} paged layout refused: {exc}", flush=True)
    else:
        fail(f"a paged {arch} engine was built; the recurrent states stay dense")
    del model, params, eng
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    control = recurrent_control(arch, seed, gen)
    parts["fp32_control"] = time.perf_counter() - t1
    rec = dict(n_params=n_params, weight_bytes=weight_bytes, cache_bytes=cache_bytes,
               free_before_init=free, total=total, init_s=init_s, tok_s=n_tok / wall,
               wall_s=wall, ttft_s=ttft, decode_ms=decode_ms, weight_read_ms=read_ms,
               peak_bytes=peak, graphs_warm=warm_graphs, replays=g["replays"],
               counts=counts, teacher_forced=forced, phases=phases,
               fp32_control=control, parts_s=parts, phase_wall_s=time.perf_counter() - t0)
    print(f"recurrent {arch}: {rec['phase_wall_s']:.1f} s "
          f"({ {k: round(v, 1) for k, v in parts.items()} })", flush=True)
    return rec


def recurrent_teacher_forced(arch, cfg, model, params, prompt, tokens) -> dict:
    """Request 0's first tokens teacher-forced on the kernel path, the
    plain path (``use_kernels=False``) and the plain path in fp32 on the
    same weight values.  The kernel path must stay within the bf16 logit
    tolerance of the plain path, LOGIT_TOL of each step's logit scale or,
    where bf16 arithmetic itself is farther than that from fp32, the
    plain bf16 path's own worst distance from the fp32 run: the scans
    carry a rounding difference through every later token (their state
    is fp32, their inputs and RWKV6's decay argument bf16), so two bf16
    paths that round apart inside one norm drift apart with the prompt's
    length.  A wrong kernel moves the logits wholesale, far past both."""
    from repro_torch.models.lm import Model

    secs = [time.perf_counter()]
    k_logits = teacher_force(model, params, prompt, tokens)
    secs.append(time.perf_counter())
    p_logits = teacher_force(Model(cfg, device="cuda", dtype=torch.bfloat16,
                                   use_kernels=False), params, prompt, tokens)
    secs.append(time.perf_counter())
    _, params32 = fp32_model(cfg, params)
    f_logits = teacher_force(Model(cfg, device="cuda", dtype=torch.float32, use_kernels=False),
                             params32, prompt, tokens)
    del params32
    torch.cuda.empty_cache()
    secs.append(time.perf_counter())
    secs = [round(b - a, 1) for a, b in zip(secs, secs[1:])]
    if not all(torch.isfinite(t).all() for t in (k_logits, p_logits, f_logits)):
        fail(f"non-finite logits in {arch}'s teacher-forced runs")

    def ratios(got, want):
        err = (got.float() - want.float()).abs().max(dim=-1).values
        return (err / want.float().abs().max(dim=-1).values).tolist()

    kp, pf, kf = ratios(k_logits, p_logits), ratios(p_logits, f_logits), ratios(k_logits,
                                                                                f_logits)
    tol = max(LOGIT_TOL, max(pf))
    agree = (k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean().item()
    print(f"teacher-forced recurrent {arch} uid 0, {len(kp)} steps after a {len(prompt)}-token "
          f"prompt, worst |logit err| / logit scale per step: kernel vs plain path (bf16) "
          f"{[round(r, 4) for r in kp]}; plain bf16 vs plain fp32 {[round(r, 4) for r in pf]}; "
          f"kernel bf16 vs plain fp32 {[round(r, 4) for r in kf]}; tolerance {tol:.4f} "
          f"(LOGIT_TOL {LOGIT_TOL} or the plain bf16 path's worst distance from fp32); "
          f"argmax agreement kernel vs plain {agree:.4f}; kernel, plain, fp32 runs {secs} s",
          flush=True)
    if max(kp) > tol:
        fail(f"{arch}'s kernel path differs from the plain path by {max(kp):.4f} of the logit "
             f"scale, past {tol:.4f}")
    controls = {}
    for scale in C11_SCALES:
        with c11_fault(arch, scale):
            c_logits = teacher_force(model, params, prompt, tokens)
        worst = max(ratios(c_logits, p_logits))
        controls[scale] = dict(kernel_vs_plain=worst, tripped=worst > tol)
        print(f"teacher-forced recurrent {arch} control ({C11_SITES[arch]} x {scale}): kernel "
              f"vs plain path {worst:.4f} of the logit scale against the gate's {tol:.4f}: "
              f"{'tripped' if worst > tol else 'passed'}", flush=True)
        if worst > tol:
            break
    caught = [sc for sc, c in controls.items() if c["tripped"]]
    if not caught:
        fail(f"{arch}'s teacher-forced gate passes {C11_SITES[arch]} x {max(C11_SCALES)}")
    return dict(kernel_vs_plain=kp, plain_vs_fp32=pf, kernel_vs_fp32=kf, tolerance=tol,
                argmax_agreement=agree, steps=len(kp), prompt=len(prompt),
                controls=controls, smallest_caught=caught[0])


C11_SITES = {"rwkv6-7b": "rmsnorm[wide]'s weight",
             "zamba2-2.7b": "the D 80 attention kernels' output"}


@contextlib.contextmanager
def c11_fault(arch: str, scale: float):
    """A faulted kernel site for phase 7c's bf16 gate: RWKV6's rmsnorm
    wide-branch launches (rows over 2048) with the weight scaled by
    ``scale``; Zamba2's attention at head dim 80 (the flash forward in
    prefill, flash_decode in decode) with its output scaled."""
    from repro_torch.kernels.rmsnorm.ops import RMSNorm
    from repro_torch.models import attention

    if arch == "rwkv6-7b":
        module, names = RMSNorm, ("forward",)

        def wrap(fn):
            def faulted(ctx, x, w, eps):
                return fn(ctx, x, w * scale if x.shape[-1] > 2048 else w, eps)
            return staticmethod(faulted)
    else:
        module, names = attention, ("flash_mha", "flash_decode")

        def wrap(fn):
            def faulted(q, *args, **kw):
                out = fn(q, *args, **kw)
                return out * scale if q.shape[-1] == 80 else out
            return faulted
    saved = {n: getattr(module, n) for n in names}
    for n, fn in saved.items():
        setattr(module, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, staticmethod(fn) if module is RMSNorm else fn)


def run_recurrent(seed: int, gen: torch.Generator, rows: dict, smi: str) -> dict:
    """Phase 7c (``recurrent`` lines): the kernels at the recurrent models'
    shapes, then RWKV6-7B and Zamba2-2.7B each served, profiled, checked
    against the plain path and in fp32.  Fills the new rows' launches from
    the serving runs (bf16) and the fp32 controls (f32 rows)."""
    t0 = time.perf_counter()
    shapes = check_recurrent_shapes(gen, rows)
    recs = {arch: run_recurrent_model(arch, seed, gen, smi) for arch in RECURRENT_ARCHS}
    rwkv, zamba = recs["rwkv6-7b"], recs["zamba2-2.7b"]
    rows[RWKV_NORM_ROW]["launches"] = rwkv["counts"]["rmsnorm[wide]"]
    rows[MAMBA_NORM_ROW]["launches"] = zamba["counts"]["rmsnorm[wide]"]
    rows[D80_FLASH_ROW]["launches"] = zamba["counts"]["flash_attention_fwd[d80]"]
    rows[D80_DECODE_ROW]["launches"] = zamba["counts"]["flash_decode[d80]"]
    control = zamba["fp32_control"]["counts"]
    rows[D80_FLASH_F32_ROW]["launches"] = control["flash_attention_fwd[d80,f32]"]
    rows[D80_DECODE_F32_ROW]["launches"] = control["flash_decode[d80]"]
    wall = time.perf_counter() - t0
    print(f"recurrent: phase wall {wall:.1f} s", flush=True)
    return dict(models=recs, kernels_at_recurrent_shapes=shapes, phase_wall_s=wall)


def run_recurrent_spec(model, params, spec, num_pages: int, smi: str) -> tuple:
    """Phase 7c's speculation (``recurrent spec`` lines): the qwen2 target
    on the preempting paged pool, spec_k SPEC_K, with each recurrent
    architecture as its draft (reduced, fresh weights in the target's
    vocabulary, as ``resolve_draft`` builds it).  Every request must
    finish (``serve``); prints each request's accept rate.  Returns the
    record and the runs' summed launch counts."""
    t0 = time.perf_counter()
    paged_kw = dict(cache_layout="paged", page_size=PAGE_SIZE, num_pages=num_pages)
    rec, total = {}, None
    for draft in RECURRENT_ARCHS:
        out, eng, counts, wall, n_tok = serve(model, params, spec, spec_k=SPEC_K, draft=draft,
                                              **paged_kw)
        acc = [eng.last_stats[u]["accept_rate"] for u, _, _ in spec]
        pool = eng.last_pool_stats
        print(f"recurrent spec draft={draft} ({eng.draft_model.cfg.family}, "
              f"{eng.draft_model.cfg.n_layers} layers, d_model {eng.draft_model.cfg.d_model}): "
              f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s (cold: captures "
              f"included); accept_rate per request {[round(a, 3) for a in acc]} mean "
              f"{np.mean(acc):.3f}; preemptions {eng.preemptions}; launches "
              f"{ {n: c for n, c in counts.items() if c} }; [{smi}]", flush=True)
        if counts["paged_flash_verify"] == 0:
            fail(f"paged_flash_verify never launched with the {draft} draft")
        if pool.used_pages != 0:
            fail(f"the spec run with the {draft} draft leaked {pool.used_pages} pages")
        rec[draft] = dict(tok_s=n_tok / wall, accept_rate=acc,
                          mean_accept_rate=float(np.mean(acc)), preemptions=eng.preemptions,
                          counts=counts)
        total = counts if total is None else add_counts(total, counts)
        del eng
    rec["phase_wall_s"] = time.perf_counter() - t0
    print(f"recurrent spec: phase wall {rec['phase_wall_s']:.1f} s", flush=True)
    return rec, total


# ---------------------------------------------------------------------------
# phase 5d: MLA training through the flash backward's (96, 64) instance
# ---------------------------------------------------------------------------

# MiniCPM3-4B at full width cut to 8 of its 62 layers: at 16 bytes a
# parameter (fp32 weights, gradients and both AdamW moments) the full
# depth's 4.26 B parameters are a 68.2 GB state, and the gradient check's
# plain backward needs ~21.5 GB of fp32 scores beside it; 8 layers are
# 0.88 B parameters and 14.0 GB (16 layers, 22.1 GB, until the smoke's
# time went to phase 5e: 46.3 s of phase at 16 layers, 30.9 s at 8)
MLA_TRAIN_LAYERS = 8
MLA_TRAIN_MARGIN = 4 * 2 ** 30  # remat's layer inputs, a vocab chunk, allocator slack
# fp32 (B, H, S, S) score tensors the plain attention's backward holds at
# once (scores, probabilities, their gradient and one temporary)
MLA_PLAIN_SCORES = 4
MLA_TRAIN_FWD_ROW = "flash_attention_fwd (MLA training)"       # row 2d
MLA_BWD_ROW = "flash_attention_bwd (MLA D 96 / Dv 64)"         # row 3c
MLA_TRAIN_NORM_ROW = "rmsnorm[wide] (training, d 2560)"         # row 1e
# one gradient, kernel path vs plain path, bf16 compute through the MLA
# layers: the paths round to bf16 at the same points and differ in the
# order of fp32 sums, the latent norms' and the d_model norms' bf16
# rounding among them.  Each gate is ~10x this phase's sound reading at 16
# layers on an H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): loss
# 1.249e-4, global norm 1.328e-4 relative, and at layers.attn.q_down 1 -
# cosine 2.786e-4 and a norm difference of 2.361e-2 relative.  The faulted
# controls read: dk x 1.25 a global norm 4.36e-3 off and 1 - cosine
# 3.18e-3 at layers.attn.kv_down (it trips two gates); dv x 1.25 a global
# norm 0.127 off, 1 - cosine 3.30e-2 at embed and 0.540 at
# layers.attn.kv_norm (three).  At 8 layers (same card) the sound check
# read 9.5e-6, 7.1e-5, 1 - 1.23e-4 and 1.57e-2, dk x 1.25 4.06e-3 and 1 -
# 3.10e-3 (two gates), dv x 1.25 three gates.  The loss cannot see a
# backward fault
MLA_GRAD_GATES = dict(loss=1.25e-3, norm=1.3e-3, cos=1 - 2.8e-3, leaf=0.24)
GRAD_FAULT_DV = 1.25          # the second control's wrong dv scale
DV_FAULT = (f"dv x {GRAD_FAULT_DV}", lambda: flash_grad_fault(2, GRAD_FAULT_DV))
MLA_CLI_STEPS = 2
# (label, command, what it must print): a CLI leg of run_clis
MLA_TRAIN_CLI = ("mla train cli", [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                                   MLA_ARCH, "--steps", str(MLA_CLI_STEPS), "--batch", "2",
                                   "--seq", "64"], f"over {MLA_CLI_STEPS} steps")


def run_clis(legs, smi: str) -> dict:
    """CLI legs ((label, command, what it must print) each) in subprocesses
    of their own, all at once (a process's start is most of a leg's
    wall): their ``run_cli`` records by label."""
    with concurrent.futures.ThreadPoolExecutor(len(legs)) as pool:
        started = [(label, pool.submit(run_cli, label, cmd, smi, expect))
                   for label, cmd, expect in legs]
        return {label: f.result() for label, f in started}


def check_mla_train_kernels(cfg, gen: torch.Generator, rows: dict) -> dict:
    """The flash forward's and backward's (96, 64) instances at one MLA
    training layer call: B 2 x S 4096 x 40 heads, causal, q/k of 96, v a
    strided view into the (.., nope + v) row as ``mla_block_kv`` passes
    it.  bf16 fills rows 2d and 3c (SDPA's forward, and its backward as
    forward + backward less forward, beside them); f32 is printed.  Then
    rmsnorm's wide branch over the batch's bf16 rows of d_model under an
    fp32 weight (row 1e)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
    )

    h, nd, rd, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    b, s, dq = TRAIN_BATCH, TRAIN_SEQ, nd + rd
    pairs = b * h * s * (s + 1) // 2                  # live (query, key) pairs
    out = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def case(dtype):
        q, k, do = randn(b, s, h, dq, dtype=dtype), randn(b, s, h, dq, dtype=dtype), \
            randn(b, s, h, vd, dtype=dtype)
        return q, k, randn(b, s, h, nd + vd, dtype=dtype)[..., nd:], do

    q, k, v, do = case(torch.bfloat16)
    n_in = 2 * (2 * q.numel() + v.numel())               # q, k, v read in bf16
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    lse_err = (lse - lse_ref).abs().max().item()
    if o.shape != (b, s, h, vd) or lse_err > 1e-3:
        fail(f"the (96, 64) flash forward at training's shape gave o {tuple(o.shape)}, "
             f"lse off by {lse_err}")
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    try:
        sdpa_ms = cuda_ms(sdpa, iters=10, warmup=2)
        sdpa_bwd_ms = cuda_ms(sdpa_fwd_bwd, iters=10, warmup=2) - sdpa_ms
    except RuntimeError as exc:
        sdpa_ms = sdpa_bwd_ms = None
        print(f"kernel {MLA_BWD_ROW}: SDPA refused Dv != D at training's shape: "
              f"{str(exc).splitlines()[0]}", flush=True)
    # bytes: q, k, v read, o and lse written; operations: 2 * D for Q.K^T
    # and 2 * Dv for P.V a live pair
    record_kernel(rows, MLA_TRAIN_FWD_ROW,
                  "src/repro_torch/kernels/flash_attention/flash_attention.cu",
                  "src/repro/kernels/flash_attention/flash_attention.py:123", o, o_ref,
                  FLASH_FWD_TOL, cuda_ms(lambda: flash_attention_fwd(q, k, v), iters=10),
                  cuda_ms(lambda: flash_attention_ref(q, k, v), iters=3, warmup=1),
                  n_in + 2 * o.numel() + b * h * s * 4, (2 * dq + 2 * vd) * pairs,
                  BF16_FLOPS_S, sdpa_ms, branch=FLASH_BRANCHES[q.dtype])
    del o_ref, lse_ref
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd_args = (q, k, v, do, lse, delta)
    got = flash_attention_bwd(*bwd_args)
    want = flash_attention_bwd_ref(*bwd_args)
    torch.cuda.synchronize()
    if [t.shape[-1] for t in got] != [dq, dq, vd]:
        fail(f"the (96, 64) backward's head dims {[t.shape[-1] for t in got]}")
    got, want = (torch.cat([t.flatten() for t in x]) for x in (got, want))
    # bytes: q, k, v, dO read in bf16, lse and delta in f32, dq, dk, dv
    # written in f32; operations: s, dq, dk of 2 * D and dp, dv of 2 * Dv
    # a live pair
    bwd_bytes = n_in + 2 * do.numel() + 2 * b * h * s * 4 + 4 * (2 * q.numel() + o.numel())
    bwd_flops = 2 * (3 * dq + 2 * vd) * pairs
    record_kernel(rows, MLA_BWD_ROW,
                  "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
                  "src/repro/kernels/flash_attention/flash_attention.py:306", got, want,
                  BWD_TOL, cuda_ms(lambda: flash_attention_bwd(*bwd_args), iters=20, warmup=2),
                  cuda_ms(lambda: flash_attention_bwd_ref(*bwd_args), iters=3, warmup=1),
                  bwd_bytes, bwd_flops, BF16_FLOPS_S, sdpa_bwd_ms,
                  branch=FLASH_BRANCHES[q.dtype])
    for name in (MLA_TRAIN_FWD_ROW, MLA_BWD_ROW):
        out[name] = {key: rows[name][key] for key in
                     ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    del q, k, v, do, o, lse, delta, bwd_args, got, want, qt, kt, vt, dot
    torch.cuda.empty_cache()

    # the f32 branch (CUDA cores) at the same shape
    q, k, v, do = case(torch.float32)
    o, lse = flash_attention_fwd(q, k, v)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    bwd_args = (q, k, v, do, lse, delta)
    got = torch.cat([t.flatten() for t in flash_attention_bwd(*bwd_args)])
    want = torch.cat([t.flatten() for t in flash_attention_bwd_ref(*bwd_args)])
    torch.cuda.synchronize()
    err32, ok32 = max_err(got, want), agrees(got, want, BWD_TOL)
    ms32 = cuda_ms(lambda: flash_attention_bwd(*bwd_args), iters=3, warmup=1)
    b_ms32, b_by32 = bound(4 * (2 * q.numel() + v.numel() + do.numel()) + 2 * b * h * s * 4
                           + 4 * (2 * q.numel() + o.numel()), bwd_flops, F32_FLOPS_S)
    print(f"kernel {MLA_BWD_ROW} (f32): max_abs_err={err32:.3e} tol={BWD_TOL} ok={ok32} "
          f"ms={ms32:.4f} bound_ms={b_ms32:.4f} ({b_by32}) "
          f"branch={FLASH_BRANCHES[torch.float32]}", flush=True)
    if not ok32:
        fail("the f32 (96, 64) flash backward disagrees with its plain version")
    out[f"{MLA_BWD_ROW} (f32)"] = dict(max_abs_err=err32, ms=ms32, bound_ms=b_ms32)
    del q, k, v, do, o, lse, delta, bwd_args, got, want
    torch.cuda.empty_cache()
    out[MLA_TRAIN_NORM_ROW] = rmsnorm_wide_row(
        rows, MLA_TRAIN_NORM_ROW, randn(b * s, cfg.d_model),
        randn(cfg.d_model, dtype=torch.float32), cfg.norm_eps)
    return out


def run_mla_train(seed: int, gen: torch.Generator, rows: dict, smi: str) -> tuple:
    """Phase 5d (``mla train`` lines): the memory count, the kernels at
    training's shape, MiniCPM3-4B training cut to MLA_TRAIN_LAYERS, the
    gradient check against the plain path with its two faulted controls,
    TRAIN_STEPS Trainer steps and one profiled step (its CLI leg,
    ``MLA_TRAIN_CLI``, runs after phase 5e beside that phase's).
    Returns the record and the launch counts of the Trainer run."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import AdamWConfig, init_adamw, leaves
    from repro_torch.train.step import TrainState, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_TRAIN_LAYERS)
    n_params = mla_params(cfg)
    per_layer = mla_params(dataclasses.replace(full, n_layers=1)) - mla_params(
        dataclasses.replace(full, n_layers=0))
    state_bytes = 16 * n_params                     # weights, grads, m, v in fp32
    scores = MLA_PLAIN_SCORES * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 * 4
    # the gradient check holds the weights, the plain path's gradients and
    # the kernel path's beside the plain backward's scores; the Trainer the
    # whole state
    need = max(12 * n_params + scores, state_bytes) + MLA_TRAIN_MARGIN
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"mla train count: {per_layer} parameters a layer, "
          f"{mla_params(dataclasses.replace(full, n_layers=0))} in the embedding, head and "
          f"final norm; full depth {full.n_layers} layers = {mla_params(full)} parameters = "
          f"{16 * mla_params(full) / 1e9:.1f} GB of fp32 weights, grads and AdamW moments; cut "
          f"to {cfg.n_layers} layers: {n_params} parameters, {state_bytes / 1e9:.1f} GB of "
          f"state; the gradient check's plain backward {scores / 1e9:.1f} GB of fp32 scores "
          f"(B {TRAIN_BATCH} x {cfg.n_heads} heads x S {TRAIN_SEQ}^2 x {MLA_PLAIN_SCORES}); "
          f"need {need / 2 ** 30:.2f} GiB with a {MLA_TRAIN_MARGIN / 2 ** 30:.0f} GiB margin; "
          f"free {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB; [{smi}]", flush=True)
    if need > free:
        fail(f"mla train: {cfg.n_layers} layers of MiniCPM3-4B do not fit: need "
             f"{need / 2 ** 30:.2f} GiB, {free / 2 ** 30:.2f} GiB free")
    shapes = check_mla_train_kernels(cfg, gen, rows)

    kw = dict(device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    model = Model(cfg, **kw)                           # remat on, as the reference
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    if sum(p.numel() for p in leaves(params)) != n_params:
        fail(f"mla train: the model holds {sum(p.numel() for p in leaves(params))} "
             f"parameters, the count {n_params}")
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=seed))
    print(f"mla train model: {MLA_ARCH} layers={cfg.n_layers} (cut from {full.n_layers}) "
          f"d_model={cfg.d_model} heads={cfg.n_heads} q_rank={cfg.q_lora_rank} "
          f"kv_rank={cfg.kv_lora_rank} qk={cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim} "
          f"v={cfg.v_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab} params={n_params} fp32 "
          f"master weights + AdamW, bf16 compute, remat, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, {VOCAB_CHUNKS} vocab chunks; [{smi}]", flush=True)
    batch = {k: v.cuda() for k, v in data.batch_at(0).items()}
    grads = compare_grads(model, Model(cfg, use_kernels=False, **kw), params, batch,
                          gates=MLA_GRAD_GATES,
                          faults=(DK_FAULT, DV_FAULT),
                          prefix="mla train")
    gc.collect()
    torch.cuda.empty_cache()

    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    trainer = Trainer(model, data, opt, TrainerConfig(total_steps=TRAIN_STEPS,
                                                      vocab_chunks=VOCAB_CHUNKS))
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def log(step, m):
        print(f"mla train step {step}: loss {m['loss']:.6f} lr {m['lr']:.3e} grad_norm "
              f"{m['grad_norm']:.6f} {m['step_time_s'] * 1e3:.1f} ms "
              f"{tokens / m['step_time_s']:.1f} tokens/s; [{smi}]", flush=True)

    start = TrainState(params, init_adamw(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launches()
    state, hist = trainer.run(start_state=start, on_metrics=log)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    flash = ("flash_attention_fwd[dv]", "flash_attention_bwd[dv]", "flash_attention_fwd",
             "flash_attention_bwd", "flash_attention_fwd[f32]", "flash_attention_bwd[f32]",
             "flash_attention_fwd[dv,f32]", "flash_attention_bwd[dv,f32]")
    per_step = {k: counts[k] / TRAIN_STEPS for k in
                flash[:4] + ("rmsnorm", "rmsnorm[wide]", "rmsnorm[ragged]")}
    print(f"mla train: {len(hist)} steps, peak memory {peak / 2 ** 30:.2f} GiB "
          f"({before / 2 ** 30:.2f} GiB allocated before the run); launches a step "
          f"{per_step}; [{smi}]", flush=True)
    losses = [m["loss"] for _, m in hist]
    if len(hist) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"mla train: losses {losses}")
    # forward and remat per layer; one backward; no other flash kernel
    want = {name: 0 for name in flash}
    want.update({"flash_attention_fwd[dv]": 2 * cfg.n_layers * TRAIN_STEPS,
                 "flash_attention_bwd[dv]": cfg.n_layers * TRAIN_STEPS})
    wrong = {name: counts[name] for name, n in want.items() if counts[name] != n}
    if wrong:
        fail(f"mla train: launches {wrong} in {TRAIN_STEPS} steps of {cfg.n_layers} "
             f"layers, not {dict((k, want[k]) for k in wrong)}")
    if counts["rmsnorm"] == 0:
        fail("mla train: the latent norms never launched rmsnorm's warp branch")
    if counts["rmsnorm[wide]"] == 0:
        fail("mla train: the d_model norms never launched rmsnorm's wide branch")
    no_ragged_rmsnorm("mla training", counts)

    step_fn = make_train_step(model, opt, vocab_chunks=VOCAB_CHUNKS)
    batch = {k: v.cuda() for k, v in data.batch_at(TRAIN_STEPS).items()}
    profile = profile_phase("mla_train_step", lambda: step_fn(state, batch), 1)
    times = [m["step_time_s"] for _, m in hist]
    del model, params, state, start, trainer, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(grad_check=grads, history=hist, peak_bytes=peak, allocated_before_bytes=before,
               n_params=n_params, params_a_layer=per_layer, state_bytes=state_bytes,
               plain_scores_bytes=scores, need_bytes=need, free_bytes=free,
               step_ms=[t * 1e3 for t in times], tokens_s=[tokens / t for t in times],
               counts=counts, kernels_at_training_shape=shapes, profile=profile)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"mla train phase: {rec['wall_s']:.1f} s; [{smi}]", flush=True)
    return rec, counts


# ---------------------------------------------------------------------------
# phase 5e: RWKV6-7B and Zamba2-2.7B training, Zamba2's shared attention
# through the flash backward's (80, 80) instance
# ---------------------------------------------------------------------------

# Zamba2-2.7B trains at full depth: its 2.42 B parameters are 38.7 GB of
# fp32 weights, gradients and AdamW moments.  RWKV6-7B's 7.53 B would be
# 120 GB, so it is cut to 12 of its 32 layers (3.17 B parameters, 50.7 GB
# of state: the embedding and head alone are 8.6 GB, a layer 3.5 GB)
RECURRENT_TRAIN_LAYERS = {"rwkv6-7b": 12, "zamba2-2.7b": 54}
# the scans run as a host loop over time, forward, recomputed and backward:
# at B 2 x S 128 a Zamba2 step ran 6.2-6.9 s (158 052 kernels) and its
# profile took 44.7 s of the smoke; B 2 x S 64 halves both
RECURRENT_TRAIN_SEQ = 64
RECURRENT_TRAIN_STEPS = 2
# remat's layer inputs, a layer's scan products (RWKV6: k v^T and its
# bonus-weighted copy, 2 x 134 MB at S 64), a vocab chunk, allocator slack
RECURRENT_TRAIN_MARGIN = 8 * 2 ** 30
# the gated gradient check runs in fp32 compute (the f32 instances: flash
# (80, 80)'s CUDA-core forward and backward, rmsnorm's f32 rows) at full
# width, depth cut (Zamba2 two groups, RWKV6 4 layers), B 2 x S 64: the
# scans carry a norm's bf16 rounding difference through every later token
# (ROADMAP C11), so in bf16 the paths drift apart by more than the dense
# gates allow while both are sound (on an H100: Zamba2 at this config a
# loss 2.1e-3 apart and 1 - cosine 1.1e-3 at layers.mamba.A_log, against
# 3e-5 and 4e-4; RWKV6 at 12 layers and S 128 a loss 1.7e-4 apart).  The
# same check in bf16 compute is printed beside it, ungated
RECURRENT_CHECK_LAYERS = {"rwkv6-7b": 4, "zamba2-2.7b": 12}
RECURRENT_CHECK_SEQ = 64
D80_BWD_ROW = "flash_attention_bwd (Zamba2 D 80)"               # row 3d
GRAD_FAULT_NORM = 1.25        # RWKV6's control: rmsnorm's backward input scale
RECURRENT_TRAIN_CLI_STEPS = 2


@contextlib.contextmanager
def norm_grad_fault(scale: float):
    """RWKV6's faulted control (its one kernel is rmsnorm): the incoming
    gradient of every ``RMSNorm`` backward scaled by ``scale``."""
    from repro_torch.kernels.rmsnorm.ops import RMSNorm

    backward = RMSNorm.backward

    def faulted(ctx, g):
        return backward(ctx, g * scale)

    RMSNorm.backward = staticmethod(faulted)
    try:
        yield
    finally:
        RMSNorm.backward = staticmethod(backward)


NORM_FAULT = (f"rmsnorm backward input x {GRAD_FAULT_NORM}",
              lambda: norm_grad_fault(GRAD_FAULT_NORM))
RECURRENT_TRAIN_FAULTS = {"rwkv6-7b": (NORM_FAULT,), "zamba2-2.7b": (DK_FAULT, DV_FAULT)}


def recurrent_train_clis() -> list:
    """The phase's CLI legs for ``run_clis``, run beside phase 5d's:
    ``launch.train`` on each reduced recurrent config (on the card the
    reduced Zamba2's heads of 64 run flash (64, 64))."""
    return [(f"recurrent train cli {arch}",
             [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--steps",
              str(RECURRENT_TRAIN_CLI_STEPS), "--batch", "2", "--seq", "64"],
             f"over {RECURRENT_TRAIN_CLI_STEPS} steps") for arch in RECURRENT_ARCHS]


def check_recurrent_train_kernels(gen: torch.Generator, rows: dict) -> dict:
    """The flash backward's (80, 80) instance at Zamba2's shared attention
    on rows 3 and 3c's shape: B 2 x S 4096 x 32 / 32 heads, causal.  bf16
    fills row 3d (SDPA's forward + backward less its forward beside it);
    f32 is printed; then the bf16 call at the phase's training shape (B 2
    x S RECURRENT_TRAIN_SEQ), timed and checked."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    z = get_config("zamba2-2.7b")
    h, dh, b = z.n_heads, z.d_head, TRAIN_BATCH
    out = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def case(s, dtype):
        q, k, v, do = (randn(b, s, h, dh, dtype=dtype) for _ in "qkvo")
        o, lse = flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, lse, delta

    def cost(s, esize):
        # bytes: q, k, v, dO read, lse and delta in f32, dq, dk, dv written
        # in f32; operations: s, dq, dk of 2 * D and dp, dv of 2 * Dv a
        # live (query, key) pair: 2 * (3 * 80 + 2 * 80) = 800
        pairs = b * h * s * (s + 1) // 2
        n = b * s * h * dh
        return 4 * n * esize + 2 * b * h * s * 4 + 3 * n * 4, 2 * (3 * dh + 2 * dh) * pairs

    s = TRAIN_SEQ
    args = case(s, torch.bfloat16)
    q, k, v, do = args[:4]
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    sdpa_bwd_ms = cuda_ms(sdpa_fwd_bwd, iters=10, warmup=2) - cuda_ms(sdpa, iters=10, warmup=2)
    got = torch.cat([t.flatten() for t in flash_attention_bwd(*args)])
    want = torch.cat([t.flatten() for t in flash_attention_bwd_ref(*args)])
    n_bytes, flops = cost(s, 2)
    record_kernel(rows, D80_BWD_ROW,
                  "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
                  "src/repro/kernels/flash_attention/flash_attention.py:306", got, want,
                  BWD_TOL, cuda_ms(lambda: flash_attention_bwd(*args), iters=20, warmup=2),
                  cuda_ms(lambda: flash_attention_bwd_ref(*args), iters=3, warmup=1),
                  n_bytes, flops, BF16_FLOPS_S, sdpa_bwd_ms, branch=FLASH_BRANCHES[q.dtype])
    sdpa_factor(D80_BWD_ROW, rows[D80_BWD_ROW]["ms"], sdpa_bwd_ms)
    out[D80_BWD_ROW] = {key: rows[D80_BWD_ROW][key] for key in
                        ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    del args, q, k, v, do, qt, kt, vt, dot, got, want
    torch.cuda.empty_cache()

    # the f32 branch (CUDA cores) at the same shape
    args = case(s, torch.float32)
    got = torch.cat([t.flatten() for t in flash_attention_bwd(*args)])
    want = torch.cat([t.flatten() for t in flash_attention_bwd_ref(*args)])
    torch.cuda.synchronize()
    err32, ok32 = max_err(got, want), agrees(got, want, BWD_TOL)
    ms32 = cuda_ms(lambda: flash_attention_bwd(*args), iters=3, warmup=1)
    n_bytes, flops = cost(s, 4)
    b_ms32, b_by32 = bound(n_bytes, flops, F32_FLOPS_S)
    print(f"kernel {D80_BWD_ROW} (f32): max_abs_err={err32:.3e} tol={BWD_TOL} ok={ok32} "
          f"ms={ms32:.4f} bound_ms={b_ms32:.4f} ({b_by32}) "
          f"branch={FLASH_BRANCHES[torch.float32]}", flush=True)
    if not ok32:
        fail("the f32 (80, 80) flash backward disagrees with its plain version")
    out[f"{D80_BWD_ROW} (f32)"] = dict(max_abs_err=err32, ms=ms32, bound_ms=b_ms32)
    del args, got, want
    torch.cuda.empty_cache()

    # the call the training step makes, a group of Zamba2 at B 2 x S 64
    s = RECURRENT_TRAIN_SEQ
    args = case(s, torch.bfloat16)
    got = torch.cat([t.flatten() for t in flash_attention_bwd(*args)])
    want = torch.cat([t.flatten() for t in flash_attention_bwd_ref(*args)])
    err, ok = max_err(got, want), agrees(got, want, BWD_TOL)
    ms = queued_ms(lambda: flash_attention_bwd(*args))
    n_bytes, flops = cost(s, 2)
    b_ms, b_by = bound(n_bytes, flops, BF16_FLOPS_S)
    print(f"kernel {D80_BWD_ROW} at the training step's B {b} x S {s}: max_abs_err={err:.3e} "
          f"ok={ok} ms={ms:.4f} (calls queued) bound_ms={b_ms:.4f} ({b_by})", flush=True)
    if not ok:
        fail(f"the (80, 80) flash backward disagrees with its plain version at S {s}")
    out[f"{D80_BWD_ROW} (S {s})"] = dict(max_abs_err=err, ms=ms, bound_ms=b_ms)
    return out


def recurrent_train_model(arch: str, seed: int, smi: str) -> dict:
    """One recurrent model's training: the memory count, the gradient
    check (fp32 at full width and cut depth, gated, with the arch's
    faulted controls; the same in bf16 compute, printed), then
    RECURRENT_TRAIN_STEPS Trainer steps at full width (bf16 compute, fp32
    master weights and AdamW, remat) and one profiled step."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import AdamWConfig, init_adamw, leaves
    from repro_torch.train.step import TrainState, make_grad_fn, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    tag = arch.split("-")[0]
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=RECURRENT_TRAIN_LAYERS[arch])
    n_params = recurrent_params(cfg)
    head = recurrent_params(dataclasses.replace(full, n_layers=0))
    per_layer = recurrent_params(dataclasses.replace(full, n_layers=1)) - head
    state_bytes = 16 * n_params                     # weights, grads, m, v in fp32
    need = state_bytes + RECURRENT_TRAIN_MARGIN
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"recurrent train {arch} count: {per_layer} parameters a layer, {head} in the "
          f"embedding, head and final norm{' and the shared block' if cfg.family == 'hybrid' else ''}; "
          f"full depth {full.n_layers} layers = {recurrent_params(full)} parameters = "
          f"{16 * recurrent_params(full) / 1e9:.1f} GB of fp32 weights, grads and AdamW "
          f"moments; {'full depth' if cfg.n_layers == full.n_layers else f'cut to {cfg.n_layers} layers'}: "
          f"{n_params} parameters, {state_bytes / 1e9:.1f} GB of state; need "
          f"{need / 2 ** 30:.2f} GiB with a {RECURRENT_TRAIN_MARGIN / 2 ** 30:.0f} GiB margin; "
          f"free {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB; [{smi}]", flush=True)
    if need > free:
        fail(f"recurrent train: {cfg.n_layers} layers of {arch} do not fit: need "
             f"{need / 2 ** 30:.2f} GiB, {free / 2 ** 30:.2f} GiB free")
    parts = {}

    # the gated check: fp32 at full width, depth cut
    t1 = time.perf_counter()
    ccfg = dataclasses.replace(full, n_layers=RECURRENT_CHECK_LAYERS[arch])
    kw32 = dict(device="cuda", dtype=torch.float32)
    model32 = Model(ccfg, **kw32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(seed))
    check_data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=RECURRENT_CHECK_SEQ,
                                              global_batch=TRAIN_BATCH, seed=seed))
    batch = {k: v.cuda() for k, v in check_data.batch_at(0).items()}
    print(f"recurrent train {arch} grad check: fp32 compute, {ccfg.n_layers} of "
          f"{full.n_layers} layers at full width, batch {TRAIN_BATCH} x seq "
          f"{RECURRENT_CHECK_SEQ}, the dense gates, controls "
          f"{[label for label, _ in RECURRENT_TRAIN_FAULTS[arch]]}", flush=True)
    kernels.reset_launches()
    grads32 = compare_grads(model32, Model(ccfg, use_kernels=False, **kw32), params32, batch,
                            faults=RECURRENT_TRAIN_FAULTS[arch],
                            prefix=f"recurrent train {arch} fp32")
    torch.cuda.synchronize()
    check_counts = kernels.launch_counts()
    # the same check in bf16 compute on the same fp32 weights and batch,
    # printed beside it
    kw = dict(device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    k_loss, k_grads = make_grad_fn(Model(ccfg, **kw), vocab_chunks=VOCAB_CHUNKS)(params32,
                                                                                batch)
    p_loss, p_grads = make_grad_fn(Model(ccfg, use_kernels=False, **kw),
                                   vocab_chunks=VOCAB_CHUNKS)(params32, batch)
    bf16 = grad_readings(k_loss.item(), k_grads, p_loss.item(), p_grads)
    print_readings("bf16 compute, same weights and batch (printed, not gated)", bf16,
                   prefix=f"recurrent train {arch}")
    if not all(torch.isfinite(g).all() for g in leaves(k_grads)):
        fail(f"recurrent train {arch}: non-finite bf16 gradients on the kernel path")
    del model32, params32, k_grads, p_grads
    gc.collect()
    torch.cuda.empty_cache()
    parts["grad_check"] = time.perf_counter() - t1

    # the training config: the Trainer at full width
    t1 = time.perf_counter()
    model = Model(cfg, **kw)                           # remat on, as the reference
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    if sum(p.numel() for p in leaves(params)) != n_params:
        fail(f"recurrent train {arch}: the model holds "
             f"{sum(p.numel() for p in leaves(params))} parameters, the count {n_params}")
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=RECURRENT_TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=seed))
    print(f"recurrent train {arch} model: family={cfg.family} layers={cfg.n_layers} "
          f"({'full depth' if cfg.n_layers == full.n_layers else f'cut from {full.n_layers}'}) "
          f"d_model={cfg.d_model} d_ff={cfg.d_ff} vocab={cfg.vocab} params={n_params} fp32 "
          f"master weights + AdamW, bf16 compute, remat, batch {TRAIN_BATCH} x seq "
          f"{RECURRENT_TRAIN_SEQ}, {VOCAB_CHUNKS} vocab chunks; [{smi}]", flush=True)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=RECURRENT_TRAIN_STEPS)
    trainer = Trainer(model, data, opt, TrainerConfig(total_steps=RECURRENT_TRAIN_STEPS,
                                                      vocab_chunks=VOCAB_CHUNKS))
    tokens = TRAIN_BATCH * RECURRENT_TRAIN_SEQ

    def log(step, m):
        print(f"recurrent train {arch} step {step}: loss {m['loss']:.6f} lr {m['lr']:.3e} "
              f"grad_norm {m['grad_norm']:.6f} {m['step_time_s'] * 1e3:.1f} ms "
              f"{tokens / m['step_time_s']:.1f} tokens/s; [{smi}]", flush=True)

    start = TrainState(params, init_adamw(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launches()
    state, hist = trainer.run(start_state=start, on_metrics=log)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    flash = {n: c for n, c in counts.items() if n.startswith("flash") and c}
    print(f"recurrent train {arch}: {len(hist)} steps, peak memory {peak / 2 ** 30:.2f} GiB "
          f"({before / 2 ** 30:.2f} GiB allocated before the run); launches rmsnorm[wide] "
          f"{counts['rmsnorm[wide]']} rmsnorm {counts['rmsnorm']} rmsnorm[ragged] "
          f"{counts['rmsnorm[ragged]']}, flash {flash}; [{smi}]", flush=True)
    losses = [m["loss"] for _, m in hist]
    if len(hist) != RECURRENT_TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"recurrent train {arch}: losses {losses}")
    want = {}
    if cfg.family == "hybrid":
        # one forward and one backward a group a step: the shared block is
        # not rematted, as in the reference's _hybrid_forward
        groups = cfg.n_layers // cfg.hybrid_attn_every
        want = {"flash_attention_fwd[d80]": groups * RECURRENT_TRAIN_STEPS,
                "flash_attention_bwd[d80]": groups * RECURRENT_TRAIN_STEPS}
    if flash != want:
        fail(f"recurrent train {arch}: flash launches {flash} in {RECURRENT_TRAIN_STEPS} "
             f"steps, not {want}")
    if counts["rmsnorm[wide]"] == 0:
        fail(f"recurrent train {arch}: rmsnorm's wide branch never launched")
    no_ragged_rmsnorm(f"recurrent training {arch}", counts)
    parts["trainer"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    step_fn = make_train_step(model, opt, vocab_chunks=VOCAB_CHUNKS)
    batch = {k: v.cuda() for k, v in data.batch_at(RECURRENT_TRAIN_STEPS).items()}
    # tens of thousands of launches a step: the device's records alone
    profile = profile_phase(f"{tag}_train_step", lambda: step_fn(state, batch), 1,
                            device_only=True, warm=False)
    parts["profile"] = time.perf_counter() - t1
    times = [m["step_time_s"] for _, m in hist]
    del model, params, state, start, trainer, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(n_params=n_params, params_a_layer=per_layer, head_params=head,
               state_bytes=state_bytes, need_bytes=need, free_bytes=free,
               grad_check_fp32=grads32, check_counts=check_counts, grad_check_bf16=bf16,
               history=hist, peak_bytes=peak, allocated_before_bytes=before,
               step_ms=[t * 1e3 for t in times], tokens_s=[tokens / t for t in times],
               counts=counts, profile=profile, parts_s=parts,
               wall_s=time.perf_counter() - t0)
    print(f"recurrent train {arch}: {rec['wall_s']:.1f} s "
          f"({ {k: round(v, 1) for k, v in parts.items()} })", flush=True)
    return rec


def run_recurrent_train(seed: int, gen: torch.Generator, rows: dict, smi: str) -> dict:
    """Phase 5e (``recurrent train`` lines): row 3d, the flash backward's
    (80, 80) instance at rows 3 and 3c's shape, then RWKV6-7B (depth cut)
    and Zamba2-2.7B (full) trained at full width.  Fills row 3d's
    launches from the Zamba2 Trainer run.  The phase's CLI legs
    (``recurrent_train_clis``) run after it, beside phase 5d's."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = check_recurrent_train_kernels(gen, rows)
    recs = {arch: recurrent_train_model(arch, seed, smi) for arch in RECURRENT_ARCHS}
    rows[D80_BWD_ROW]["launches"] = recs["zamba2-2.7b"]["counts"]["flash_attention_bwd[d80]"]
    f32 = recs["zamba2-2.7b"]["check_counts"]
    if not (f32["flash_attention_bwd[d80,f32]"] and f32["flash_attention_fwd[d80,f32]"]):
        fail(f"the Zamba2 fp32 gradient check never ran the (80, 80) f32 instances: {f32}")
    wall = time.perf_counter() - t0
    print(f"recurrent train phase: {wall:.1f} s; [{smi}]", flush=True)
    return dict(models=recs, kernels_at_training_shape=shapes, phase_wall_s=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.bench.kernel_ab import ptxas_report
        from repro_torch.kernels import build
        from repro_torch.models.layers import WarpFeatureConfig
        from repro_torch.models.lm import Model
        from repro_torch.optim.optimizer import leaves
        from repro_torch.serve.spec_decode import make_self_draft
    except ImportError as exc:
        fail(f"cannot import the port from {ROOT / 'src'}: {exc}")

    smi = smi_line()
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.LIB.load()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({len(build.sources())} sources)", flush=True)

    # ptxas's view of the redesigned kernels, compiled beside the kernel phase
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ptxas_job = pool.submit(ptxas_report, ROOT / "src" / "repro_torch" / "kernels")

    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows, t1_err, int8_checks = check_kernels(cfg, gen)
    long_checks = check_verify_long(cfg, rows, gen)
    serving_kernels = ("rmsnorm", "flash_attention_fwd", "flash_decode",
                       "paged_flash_decode")
    rows.update(check_warp_kernels(gen))
    ptxas = print_ptxas(ptxas_job.result(), build)
    pool.shutdown()
    gating_rows, gating_readings = check_moe_gating(get_config(MOE_ARCH), gen)
    rows.update(gating_rows)

    fig5_rows, fig5_counts = run_fig5(args.seed)
    for name in WARP_KERNELS:
        rows[name]["launches"] = fig5_counts[name]
    fig5_device = fig5_device_time(args.seed)
    pr_rec = run_pr_transform(args.seed)
    for name in PR_KERNELS:
        rows[name]["launches"] += pr_rec["launches"][name]
    table4 = run_table4(ptxas)
    # the 32B model first, while the card holds nothing else: its weights
    # take 65.6 of the card's 79 GiB
    qwen32b_rec, qwen32b_counts = run_qwen32b(args.seed, gen, rows, smi)
    rows[QWEN32_NORM_ROW]["launches"] = qwen32b_counts["rmsnorm[wide]"]
    mla_rec, mla_counts = run_mla(args.seed, gen, rows, smi)
    rows[MLA_FLASH_ROW]["launches"] = mla_counts["flash_attention_fwd[dv]"]
    rows[MLA_NORM_ROW]["launches"] = mla_counts["rmsnorm[wide]"]
    recurrent_rec = run_recurrent(args.seed, gen, rows, smi)

    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(args.seed))
    n_params = sum(p.numel() for p in leaves(params))
    print(f"model: {ARCH} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} params={n_params} dtype=bf16",
          flush=True)
    spec = make_requests(args.seed, cfg.vocab)
    print(f"requests: {len(spec)} prompts of {[len(p) for _, p, _ in spec]} tokens, "
          f"max_new_tokens={MAX_NEW}, slots={SLOTS}, max_seq={MAX_SEQ}", flush=True)
    # warm-up (cuBLAS handles, allocator): one short request, not counted
    serve(model, params, [(99, spec[1][1][:64], 2)])
    # the captured steps against the same steps eager, bf16, full width:
    # where bit for bit, the bf16 serial / pipelined pairs are gated
    draft1 = make_self_draft(model, params, 1)
    probes = {kind: replay_probe(model, params, kind, gen, draft1)
              for kind in ("dense", "paged", "paged_int8", "spec")}

    # the main path, pipelined (the engine's default): each timed engine
    # first serves the same requests once untimed, capturing its graphs
    dense_run = serve(model, params, spec, warm=True)
    dense, dense_eng, dense_counts, dense_wall, dense_tok = dense_run
    print(f"serve dense: {dense_tok} tokens in {dense_wall:.3f} s = "
          f"{dense_tok / dense_wall:.1f} tok/s; launches {dense_counts}", flush=True)
    # the first four prompts fill the pool but for one growth page per
    # slot: the batch cannot grow 32 tokens without preempting
    num_pages = preempting_pool(spec)
    paged_kw = dict(cache_layout="paged", page_size=PAGE_SIZE, num_pages=num_pages)
    paged_run = serve(model, params, spec, warm=True, **paged_kw)
    paged, eng, paged_counts, paged_wall, paged_tok = paged_run
    print(f"serve paged: {paged_tok} tokens in {paged_wall:.3f} s = "
          f"{paged_tok / paged_wall:.1f} tok/s; pool {num_pages} pages; "
          f"preemptions {eng.preemptions}; launches {paged_counts}", flush=True)
    # the serial, eager round beside each: the control (the kernel rows
    # count the pipelined main path's launches, replays included)
    dense_serial = serve(model, params, spec, pipeline=False, warm=True)
    pipeline_pair("dense", dense_run, dense_serial, STEP_KERNELS["dense"],
                  gate=probes["dense"]["bit_for_bit"])
    paged_serial = serve(model, params, spec, pipeline=False, warm=True, **paged_kw)
    pipeline_pair("paged", paged_run, paged_serial, STEP_KERNELS["paged"],
                  gate=probes["paged"]["bit_for_bit"])
    del dense_serial, paged_serial, dense_run, paged_run
    if eng.preemptions < 1:
        fail("the paged run was sized to preempt and did not")
    if eng.last_pool_stats.used_pages != 0:
        fail(f"paged run leaked {eng.last_pool_stats.used_pages} pages")
    print(f"prefill groups (uids, bucket, lengths): dense {dense_eng.last_prefill_groups}; "
          f"paged {eng.last_prefill_groups}", flush=True)
    # reported, not gated: after a preemption a request may prefill in
    # another right-padded group at another bucket and round otherwise in
    # bf16; the fp32 control below gates (ROADMAP C1)
    layout_agreement("dense vs paged token agreement", dense, paged, eng)
    c1 = c1_control(cfg, model, params, spec, num_pages, dense, paged,
                    dense_eng.last_prefill_groups, eng.last_prefill_groups)
    for name in ("rmsnorm", "flash_attention_fwd"):
        if dense_counts[name] == 0 or paged_counts[name] == 0:
            fail(f"{name} never launched while serving")
    if dense_counts["flash_decode"] == 0 or paged_counts["paged_flash_decode"] == 0:
        fail("a decode kernel never launched while serving")
    for name in serving_kernels:
        rows[name]["launches"] = dense_counts[name] + paged_counts[name]
    for name in ("flash_attention_fwd", "flash_decode"):
        rows[name]["launches"] += qwen32b_counts[name]
    rows["rmsnorm"]["launches"] += mla_counts["rmsnorm"]

    # teacher-force the plain-version path on request 0's served tokens
    uid, prompt, _ = spec[0]
    plain = Model(cfg, device="cuda", dtype=torch.bfloat16, use_kernels=False)
    k_logits = teacher_force(model, params, prompt, dense[uid])
    p_logits = teacher_force(plain, params, prompt, dense[uid])
    err, scale, _ = compare_logits(f"uid {uid} plain vs kernel path",
                                          p_logits, k_logits)
    agree_served = (p_logits.argmax(-1) == torch.tensor(dense[uid], device="cuda")
                    ).float().mean().item()
    print(f"token agreement plain vs served {agree_served:.4f}", flush=True)

    # the paper's reduction forms inside the full-width model: every norm
    # reduced in 128-lane groups by the HW primitives and by the SW
    # (PR-transformation) lane loops, prefill + WARP_FORM_STEPS decode steps
    warp_forms = {}
    steps = dense[uid][:WARP_FORM_STEPS + 1]
    for form in ("hw_warp", "sw"):
        m = Model(cfg, device="cuda", dtype=torch.bfloat16,
                  wf=WarpFeatureConfig(form))
        t0 = time.perf_counter()
        f_logits = teacher_force(m, params, prompt, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f_err, _, f_agree = compare_logits(f"uid {uid} wf={form} vs kernel path",
                                           f_logits, k_logits[:len(steps)])
        if f_agree < 1.0:
            fail(f"wf={form} changes the greedy token at some step")
        warp_forms[form] = dict(max_err=f_err, argmax_agreement=f_agree, wall_s=wall)
        print(f"wf={form}: prefill + {len(steps) - 1} decode steps in {wall:.2f} s",
              flush=True)

    spec_rec, verify_launches = run_spec(cfg, model, params, spec,
                                         paged_tok / paged_wall,
                                         probes["spec"]["bit_for_bit"])
    rows["paged_flash_verify"]["launches"] = verify_launches
    recurrent_spec, recurrent_spec_counts = run_recurrent_spec(model, params, spec, num_pages,
                                                               smi)
    for name in serving_kernels + ("paged_flash_verify",):
        rows[name]["launches"] += recurrent_spec_counts[name]

    tiered_rec, tiered_counts = run_tiered(cfg, model, params, spec, dense, paged,
                                           paged_tok / paged_wall, num_pages,
                                           eng.preemptions,
                                           probes["paged_int8"]["bit_for_bit"])
    for name in serving_kernels + ("paged_flash_decode[int8]", "paged_flash_verify[int8]"):
        rows[name]["launches"] += tiered_counts[name]

    shared_rec, shared_counts, shared_int8, shared_fp32, shared_profiles = run_shared(
        cfg, model, params, num_pages, args.seed)
    if shared_fp32["paged_flash_verify[long]"] == 0:
        fail("the shared fp32 control never launched the long branch's f32 kernel")
    for name in serving_kernels:
        rows[name]["launches"] += shared_counts[name] + shared_int8[name]
    rows["paged_flash_decode[int8]"]["launches"] += shared_int8["paged_flash_decode[int8]"]
    rows["paged_flash_verify[long]"]["launches"] = shared_counts["paged_flash_verify[long]"]
    rows["paged_flash_verify[long,int8]"]["launches"] = shared_int8[
        "paged_flash_verify[long,int8]"]
    rows["paged_flash_verify[long] (f32)"]["launches"] = shared_fp32["paged_flash_verify[long]"]

    sched_rec, sched_counts, sched_fp32 = run_sched(cfg, model, params, args.seed, smi)
    for name in serving_kernels + ("paged_flash_verify[long]",):
        rows[name]["launches"] += sched_counts[name]
    rows["paged_flash_verify[long] (f32)"]["launches"] += sched_fp32["paged_flash_verify[long]"]

    faults_rec, faults_counts, faults_fp32 = run_faults(cfg, model, params, args.seed, smi,
                                                        probes)
    for name in serving_kernels + ("paged_flash_verify",):
        rows[name]["launches"] += faults_counts[name]

    openloop_rec, openloop_counts, openloop_fp32 = run_openloop(cfg, model, params, args.seed,
                                                                smi, num_pages)
    for name in serving_kernels:
        rows[name]["launches"] += openloop_counts[name]

    phases = where_time_goes(model, params, gen)
    phases.update(shared_profiles)
    phases.update(mla_rec.pop("phases"))
    for rec in recurrent_rec["models"].values():
        phases.update(rec.pop("phases"))

    sampled_rec, sampled_counts, sampled_fp32 = run_sampled(
        cfg, model, params, spec, num_pages, dense, phases, gen, draft1)
    for name in serving_kernels + ("paged_flash_verify",):
        rows[name]["launches"] += sampled_counts[name]

    options_rec, options_counts = run_options(cfg, model, params, spec, gen, smi)
    for name in serving_kernels:
        rows[name]["launches"] += options_counts[name]
    fleet_rec, fleet_counts, fleet_fp32 = run_fleet(cfg, model, params, args.seed, smi)
    for name in serving_kernels:
        rows[name]["launches"] += fleet_counts[name]

    # the serving weights, engine and logits make way for training's
    preemptions = eng.preemptions
    del model, params, plain, m, eng, k_logits, p_logits, f_logits, draft1
    torch.cuda.empty_cache()
    moe_rec, moe_counts = run_moe(args.seed, gen, rows, smi)
    spec_moe_counts = moe_rec.pop("spec_counts")
    for name in ("rmsnorm", "flash_attention_fwd", "flash_decode", "paged_flash_decode",
                 "moe_gating"):
        rows[name]["launches"] += moe_counts[name] + spec_moe_counts[name]
    # the MoE target's verify windows are the G = 1 row's launches
    rows["paged_flash_verify (G=1)"]["launches"] = spec_moe_counts["paged_flash_verify"]
    phases.update(moe_rec.pop("phases"))
    torch.cuda.empty_cache()      # the MoE weights make way for training's
    train_rec, train_counts = run_training(cfg, args.seed)
    phases["train_step"] = train_rec.pop("profile")
    torch.cuda.empty_cache()      # phase 5's state makes way for the checkpoints'
    ckpt_rec, ckpt_counts = run_ckpt(args.seed, smi)
    torch.cuda.empty_cache()
    moe_train_rec, moe_train_counts = run_moe_train(args.seed, smi)
    phases["moe_train_step"] = moe_train_rec.pop("profile")
    torch.cuda.empty_cache()      # the MoE state makes way for MLA training's
    mla_train_rec, mla_train_counts = run_mla_train(args.seed, gen, rows, smi)
    phases["mla_train_step"] = mla_train_rec.pop("profile")
    rows[MLA_TRAIN_FWD_ROW]["launches"] = mla_train_counts["flash_attention_fwd[dv]"]
    rows[MLA_BWD_ROW]["launches"] = mla_train_counts["flash_attention_bwd[dv]"]
    rows[MLA_TRAIN_NORM_ROW]["launches"] = mla_train_counts["rmsnorm[wide]"]
    torch.cuda.empty_cache()      # MLA's state makes way for the recurrent models'
    recurrent_train_rec = run_recurrent_train(args.seed, gen, rows, smi)
    clis = run_clis([MLA_TRAIN_CLI] + recurrent_train_clis(), smi)
    mla_train_rec["cli"] = clis.pop(MLA_TRAIN_CLI[0])
    recurrent_train_rec["cli"] = clis
    for arch, rec in recurrent_train_rec["models"].items():
        phases[f"{arch.split('-')[0]}_train_step"] = rec.pop("profile")
    flash_branch_launches(
        {"serve dense": dense_counts, "serve paged": paged_counts,
         "sampled bf16 runs": sampled_counts,
         "tiered bf16 runs": tiered_counts, "shared bf16 runs": shared_counts,
         "shared int8 run": shared_int8, "sched bf16 runs": sched_counts,
         "faults bf16 runs": faults_counts, "openloop bf16 runs": openloop_counts,
         "fleet bf16 runs": fleet_counts, "spec moe": spec_moe_counts,
         "qwen32b serve": qwen32b_counts, "mla serve": mla_counts,
         **{f"recurrent {arch} serve": rec["counts"]
            for arch, rec in recurrent_rec["models"].items()},
         "recurrent spec": recurrent_spec_counts,
         "moe serve": moe_counts, "train": train_counts, "ckpt train": ckpt_counts,
         "moe train": moe_train_counts, "mla train": mla_train_counts,
         **{f"recurrent train {arch}": rec["counts"]
            for arch, rec in recurrent_train_rec["models"].items()}},
        {"C1 control fp32": c1["launches"], "shared fp32 control": shared_fp32,
         "sched fp32 runs": sched_fp32, "faults fp32 runs": faults_fp32,
         "openloop fp32 runs": openloop_fp32, "fleet fp32 runs": fleet_fp32,
         "sampled fp32 control": sampled_fp32,
         "tiered fp32 control": tiered_rec["fp32_control_launches"],
         "moe control fp32 no drops": moe_rec["preemption_controls"]["fp32 no drops"]["launches"]})
    # training's launches belong to the training-shape rows (phases 5, 5b
    # and 5c; 5d's flash launches to rows 2d and 3c, its wide rmsnorm
    # launches to row 1e), and MoE training's
    # gating launches to moe_gating's
    training = (train_counts, ckpt_counts, moe_train_counts, mla_train_counts)
    rows["rmsnorm (training)"]["launches"] = sum(c["rmsnorm"] for c in training)
    rows["flash_attention_bwd"]["launches"] += sum(c["flash_attention_bwd"] for c in training)
    rows["flash_attention_fwd (training)"]["launches"] = sum(
        c["flash_attention_fwd"] for c in training)
    rows["moe_gating"]["launches"] += moe_train_counts["moe_gating"]

    print(f"fault-free engines: {FAULT_FREE['engines']} checked, none recovered or "
          f"degraded, every paged pool audit-clean", flush=True)
    result = {"kernels": list(rows.values())}
    DETAILS.parent.mkdir(parents=True, exist_ok=True)
    DETAILS.write_text(json.dumps(dict(
        result, device=smi, phases=phases, dense_tok_s=dense_tok / dense_wall,
        paged_tok_s=paged_tok / paged_wall, dense_counts=dense_counts,
        paged_counts=paged_counts, preemptions=preemptions, train=train_rec,
        ckpt=ckpt_rec, moe_train=moe_train_rec, mla_train=mla_train_rec,
        num_pages=num_pages, teacher_forced_max_err=err, logit_scale=scale,
        fig5=fig5_rows, fig5_counts=fig5_counts, fig5_device=fig5_device,
        pr_transform=pr_rec, table4=table4,
        warp_forms=warp_forms, spec=spec_rec, verify_t1_err=t1_err, moe=moe_rec,
        c1_control=c1, tiered=tiered_rec, int8_kernel_checks=int8_checks,
        shared=shared_rec, sampled=sampled_rec, sched=sched_rec, faults=faults_rec,
        openloop=openloop_rec, options=options_rec, fleet=fleet_rec, qwen32b=qwen32b_rec,
        mla=mla_rec, recurrent=recurrent_rec, recurrent_spec=recurrent_spec,
        recurrent_train=recurrent_train_rec,
        fault_free_engines=FAULT_FREE["engines"], verify_long=long_checks,
        replay_probes=probes,
        pipeline=PIPELINE_PAIRS,
        moe_gating=gating_readings, flash_branches=BRANCHES_RUN,
        matmul=MATMUL_READINGS, ptxas=ptxas),
        indent=1))
    print(json.dumps(result), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
