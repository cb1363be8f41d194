#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines and seconds; any failure exits
non-zero and no phase's failure is caught:

  1. environment: the card's name and power limit, CUDA version, TF32 off;
  2. build: compiles the kernels under src/repro_torch/csrc with nvcc;
  3. kernels vs their plain PyTorch versions at the main paths' shapes and
     at their tiles' edges (``residual_int8`` also on rows holding NaN and
     Inf, on both of its paths), with times, the roofline bound and (where one
     exists) a library call; the two f32 tensor-core kernels are bound by
     f32-accurate 3xTF32 products on the tensor cores, and their bound on
     the FP32 CUDA cores is printed and kept beside it (``fp32_bound_ms``).
     Every kernel is timed twice: by CUDA events around back-to-back
     wrapper calls (``events_ms``, the host's checks and launch included)
     and by its device time alone in a profiler trace (``device_ms``).
     ``ms`` is the events time for the two tensor-core kernels and the
     device time for ``residual_int8`` and ``rwkv6_scan``, whose device
     time is shorter than their wrappers' host path; their inputs rotate
     over several sets where one would fit in L2.  ``rwkv6_scan`` has a
     row for prefill and one for decode, each with its own launches.
     Then come the dense and MoE LMs' kernels (lines ``3L``, phase 14),
     the flash kernel at the hybrid, audio and VLM families' shapes (lines
     ``3F``, phase 15), the flash backward at the LM families' training
     shapes (lines ``3B``, phase 16), the DiT kernels at DiT-MoE-G's shapes
     (lines ``3G``, phase 11), the two DiT backward kernels (lines ``3B``,
     phase 12a) and the RWKV-6 recurrence's backward (lines ``3B``, phase
     13a);
  4. kernels in place: the tiny DiT served on the CPU (plain versions)
     and on the card (kernels) from the same weights and noise, 6 steps
     so that a light step's codec'd expert outputs reach the sample; the
     smoke RWKV-6 prefilled and decoded on both from the same weights;
  5. main path 1: 8 DiT-MoE-XL requests x 10 steps under DICE with the
     int8 residual codec, then the other four schedules (sync, displaced
     and interweaved with the codec, staggered_batch) for 4 steps each;
     each run's kernel launch counts are set to 0 before it and held to
     what its plan implies after it;
  6. main path 2: rwkv6-3b at full width and depth in bf16, 8 prompts of
     2048 tokens prefilled, then 64 greedy decode steps, launch counts
     set to 0 before and held after; the streamed logits are held against
     one teacher-forced forward over prompt + generated tokens, and so are
     those of the first 2 and 8 layers of the same params;
  7. main path 3: continuous batching.  (a) The 4-layer DiT of
     tests/test_serve_continuous.py served on the card by
     ``serve_continuous`` (3 requests, 2 slots, arrivals 0, 0, 1; 4 and 6
     steps) under sync, interweaved, dice and dice + int8: the recycled request's and
     the first wave's samples against the same requests in a fresh fixed
     batch on the card, expected bit-identical (else held to TOL_F32 and
     the gap printed).  (b) DiT-MoE-XL with phase 5's weights, dice + int8:
     24 requests arriving 4 every 2 ticks through ``serve_continuous`` on 8
     slots, then the same 24 through ``serve_queue``; launch counts set to
     0 before each run and held to what its ticks' plans imply after it;
  8. main path 4: expert parallelism over ``torch.distributed`` on the one
     card, one spawned process per ep rank (the kernels were built in
     phase 2, before any rank starts).  (a) ep = 1 over NCCL: the 4-layer
     DiT of 7a under dice + int8, bit-identical to the mesh-less card run.
     (b) ep = 2, two ranks sharing the card over gloo (whose collectives
     copy CUDA tensors through the host; the ring's send/recv go through
     pinned host buffers): the 4-layer DiT at capacity_factor 8 under all
     five schedules, dice + int8 and staggered_batch, with blocking
     all-to-alls and with the ring, each against the single-process card
     run to TOL_F32.  (c) ep = 2 at full XL width with phase 5's weights
     (each rank draws the init and keeps its 4 experts, layer by layer):
     dice + int8, 8 requests (4 a rank) x 10 steps, blocking then ring; then
     ``serve_continuous`` with 24 requests arriving 4 every 2 ticks on 8
     slots (4 a rank).  Each rank's launch counts are set to 0 before each
     run and held to its plans after it, in the rank; the ranks send their
     counts back.  These numbers are ep = 2 sharing one card over a
     host-staged wire, not the paper's speed-up;
  9. main path 5: checkpoints, telemetry, the top-k codec and the
     resilience ladder at DiT-MoE-XL width, with phase 5's weights.  (a)
     The weights cut to 2 layers (1.4 GB) written with ``save_checkpoint``
     into a temporary directory under build/ (removed after), read back
     onto the card with ``load_checkpoint``, write and read GB/s printed;
     dice + int8 served 4 steps from the file and from memory, bit for
     bit; a flipped byte must raise ``CheckpointCorruptionError``.  (b) 8
     requests x 10 steps of dice + int8 with telemetry on: bit-identical to
     phase 5, s/step beside phase 5's, the per-layer means of the six
     fields, every age and codec error held to the plan.  (c) dice +
     topk_residual (0.125: 144 of 1152 entries a row), 4 steps, dispatch
     bytes held to the plan.  (d) guards on and faults off, bit-identical
     to phase 5; seeded corruption with guards on, finite, its fault
     counts printed; phase 7b's mix under dice with rid 0 poisoned at tick
     2, one requeue, its replay equal to rid 0 in a clean fixed batch bit
     for bit; a codec-error limit that demotes the codec at the first plan
     boundary after a coded tick.  Every run's launch counts are set to 0
     before it and held to its plans (the rebuilt ones after a demotion).
 10. main path 6: DistriFusion, the hierarchical mesh and expert
     placement.  (a) The 4-layer DiT of phase 8 on the CPU (plain versions)
     and on the card (kernels), to TOL_F32: ``rf_sample`` with
     ``patch_parallel_ndev`` 2 and 4 under sync, and ``patch_compose`` at 2
     under dice + int8.  (b) Phase 5's XL weights, 8 requests, f32: sync
     (10 steps), DistriFusion (``patch_parallel_ndev=8`` under sync, the
     reference benchmark's baseline, 10 steps, 448 flash launches a step)
     and the composed run under dice + int8 (4 steps) in one call: s/step,
     the stale K/V footprint, peak memory.  (c) gloo ranks sharing the
     card: the 4-layer DiT over ep2 x dp2 (five schedules, blocking and
     ring) against the single-process card run, and over ep2 x patch2 and
     ep2 x dp2 x patch2 against the single-process ``patch_compose`` run,
     to TOL_F32; XL width (depth cut to MESH_XL_LAYERS) over ep2 x dp2 and
     ep2 x patch2, dice + int8, 4 steps.  (d) XL width (MESH_XL_LAYERS
     layers) at ep=2 with the routers biased toward one expert: sync over
     the greedy placement (one replicated expert) of the identity layout's
     histogram against identity, samples to TOL_F32, per-rank dispatch
     bytes the plan's (scaled by ``cap_scale``), ``expert_ffn`` launches
     with the replica calls; then phase 7b's mix through
     ``serve_continuous`` with online greedy placement (re-shards, step
     keys, requests/s).  Every run's launches are held to its plans.
     The mesh runs' times are ranks time-slicing one card over a
     host-staged wire, not a deployment's.
 11. main path 7: expert paging and DiT-MoE-G (its kernels' shapes are
     held and timed at the end of phase 3, lines ``3G``: ``expert_ffn``
     (8, 320, 1408, 5632) f32, an ep=2 rank at refresh; ``flash_attention``
     (4, 256, 16, 88) f32 beside ``scaled_dot_product_attention``, the
     Dh <= 128 instance with its ptxas line; ``residual_int8`` at a rank's
     1024 and 2048 rows x 1408).  (a) The 4-layer DiT of phase 8 over 4 gloo ranks sharing the
     card, paged at the auto budget, for the five schedules, against the
     CPU's plain single-process run (TOL_F32) and bit for bit against the
     resident ep=4 run; E = 6 over 4 ranks (E_pad 8) against its
     single-process run; launches held to the plans.  (b) DiT-MoE-G at
     full width, depth cut to MESH_XL_LAYERS, 8 requests, ep=2 over two
     gloo ranks sharing the card, dice + int8, 4 steps, blocking and
     ring, paged (depth 1, the pool pinned in host memory, copies on a
     copy stream) and resident: paged samples bit-identical to resident,
     s/step, transfers and GB a step, the realized peak against the
     budget, ``max_memory_allocated`` per rank (paged below resident),
     pinned bytes and MemAvailable, and one traced paged step: the pool's
     copies, their GB/s and the share of their time a kernel ran beside
     them; then a probe of the card's copy engine (a 761 MB pinned copy
     beside 10 ``expert_ffn`` calls, alone and in both ranks at once; a
     16 MB copy each way issued just after it), which is why the pool
     queues its copies 32 MB at a time.  (c) On (b)'s pool: ``paging_err=0.3`` (samples bit-identical,
     the fault counts), ``paging_delay=0.5:0.01`` (s/step), and
     ``check_ring_lowering`` on a profiled ring step at ep=2.  Every line
     carries the card's name and power limit.

 12. main path 8: training.  (a) At the end of phase 3 (lines ``3B``),
     where the profiler still traces every launch: the two backward
     kernels (``expert_ffn_bwd`` on 3xTF32 ``wgmma``, five launches;
     ``flash_attention_bwd`` on 3xTF32 ``mma.sync``, two; the SASS of
     each holds its tensor-core instructions) against their plain
     versions: ``expert_ffn_bwd`` at XL's (8, 640, 1152, 4608) and
     G's (8, 320, 1408, 5632) f32 and at a capacity and widths off its
     tiles (odd d and f through zero-padded copies), with empty capacity
     rows; ``flash_attention_bwd`` at (8, 256,
     16, 72), (4, 256, 16, 88), Sq and Sk off its 64-row tiles, Dh 128 and
     24; the forward's optional ``lse`` output held to its plain version and
     the forward's output bit-identical with and without it; two runs bit
     for bit; a NaN row NaN where the plain version has it; events and
     device times against the bounds, the six-bmm yardstick and the
     backward of ``scaled_dot_product_attention`` through autograd, and
     each kernel's time over its yardstick's (rows from different cards
     compare by that ratio).  (b)
     The 4-layer DiT of tests/test_system.py: step-0 gradients (adaLN
     perturbed) card vs CPU leaf by leaf to TOL_F32, then 30
     ``rf_train_step``s on the CPU (plain versions) and on the card
     (kernels) from the same weights, batches and draws: losses within
     1e-3, the card's last 5 below 0.9 x its first 5, launches held to 4
     of each kernel a step.  (c) DiT-MoE-XL at full width, depth cut to
     TRAIN_XL_LAYERS, batch TRAIN_XL_BATCH, adaLN perturbed: a warm-up step
     and 4 timed steps (s/train-step, ``max_memory_allocated``, losses and
     grad norms finite, launches held to 8 of each forward and backward
     kernel a step); then the model cut to 2 layers at batch 2, step-0
     gradients card vs CPU.  (d) (b)'s card-trained model sampled under
     sync, displaced, interweaved and deep-sync DICE: paired MSE and the
     FID proxy against sync, interweaved < displaced and deep <= 1.05 x
     interweaved.
 13. main path 9: RWKV-6 training.  (a) At the end of phase 3 (lines
     ``3B``): ``rwkv6_scan_bwd`` (the chunked recurrence on the tensor
     cores in one launch, then dlogw's running sums and du's sum over the
     batch) against its plain version at rwkv6-3b's training shape (8, 40,
     128, 64) bf16 with and without a final-state gradient, its prefill
     shape (T = 2048), f32, DK 16/32/128, T = 1 and T = 45 (off the
     16-step chunk), decays drawn over [-6, 2], a logw of -inf and logw
     over [-30, -20]; two runs bit for bit; a NaN in r NaN where the plain
     version has it; HMMA in its SASS; its ptxas lines; its device and
     events time against the bound (bytes, 3xTF32, FP32) and beside the
     forward kernel's device time at the same shape (``bwd_over_fwd``: the
     ratio compares across cards) and, when the environment variable
     CHIP_SMOKE_PARENT names a ``git archive`` tar of the parent commit,
     beside that commit's kernel, built from its sources and timed through
     its own wrapper in the same run; no single library call computes it.  (b) The smoke RWKV-6 (2
     layers, d 128): f32 step-0 gradients card vs CPU leaf by leaf, then
     30 ``lm_train_step``s on the CPU (plain versions) and on the card
     (kernels) from the same weights and batches, f32 (losses within 1e-3)
     and bf16 (within TOL_LM_BF16_LOSS), launches held to one
     ``rwkv6_scan`` and one ``rwkv6_scan_bwd`` a layer and step.  (c)
     rwkv6-3b at full width and depth, bf16 params and f32 moments, batch
     8 x 128: a warm-up step and 4 timed steps (s/train-step,
     ``max_memory_allocated``, losses and grad norms finite, launches held
     to 32 of each scan kernel a step); then a prefill on the trained
     params, bit for bit against the same prefill with grad disabled.

 14. main path 10: the dense and MoE LM families (``models/dense.py``
     through ``get_model``).  In phase 3, before 3G (lines ``3L``): the
     flash kernel with its KV-cache masks against its plain version (the
     plain version over query chunks at their offsets) at gemma2-9b's
     prefill shape (4 x 8128, 16 heads over 8 kv heads of 256, bf16,
     causal, softcap 50) with window 4096 and without, at its decode shape
     (one query against 8,192 ring slots: a local layer at the last
     position, a global one with empty slots, a ring before it fills and
     a wrapped one), at stablelm's head dim 160, off its query and key
     tiles with a q_offset and a kv_valid_len, and with the non-causal
     one-sided window (C.9), each to TOL_BF16 with the atol in units of
     its query row's RMS, and planted faults (the window dropped, q_offset
     off by one, the ring's slots read in index order) rejected by that
     check; ``expert_ffn`` at qwen3-moe-30b-a3b's bf16 prefill (128, 1280,
     2048, 768) and decode (128, 8, ...) shapes; each timed by events and
     device time beside its plain version, ``scaled_dot_product_attention``
     with ``enable_gqa`` (no softcap) or none and three ``bmm``s, and its
     bound over the kept (query, key) pairs and the kept slots' K and V.  (a) The six ``smoke()`` configs, f32 and bf16 params,
     prefilled and decoded 8 steps on the CPU and on the card from the same
     weights (TOL_F32 / TOL_BF16; each CPU decode step from the card's
     cache), launches one flash (and one ``expert_ffn``) call a layer and
     pass; gemma2's smoke model decoded with ``long_context=True`` into a
     ring of 8 slots.  (b) gemma2-9b at full width and depth, bf16: 4
     prompts of 8,128 tokens, 64 greedy decode steps (prefill s, decode
     ms/step, ``max_memory_allocated``, 42 flash launches a pass), streamed
     logits against a teacher-forced pass that unembeds only the compared
     positions.  (c) qwen3-moe-30b-a3b at full width and depth (48
     layers): 8 x 2048 prompts, 32 decode steps, 48 flash and 48
     ``expert_ffn`` launches a pass.
 15. main path 11: the hybrid, audio and VLM families (``models/zamba2.py``,
     ``encdec.py``, ``vlm.py`` through ``get_model``).  In phase 3, after
     3L (lines ``3F``): the flash kernel at their shapes, held and timed as
     the 3L rows: zamba2-7b's shared block (4 x 4,096 prompt rows over its
     4,128-slot cache, 32 heads of 112, causal; one decode row), seamless's
     encoder (4 x 4,096 frames, 16 heads of 64, non-causal) and cross-
     attention (256 prompt rows and one decode row over the 4,096 frames),
     the VLM's self-attention (4 x 2,048, 32 heads over 8 of 128; one
     decode row over 2,080 ring slots) and cross-attention (2,048 rows and
     one decode row over 1,601 image keys), with SDPA (``enable_gqa``, no
     mask where the mask keeps every pair) beside each.  (a) The three
     ``smoke()`` configs and two ragged layouts (zamba2 with two trailing
     mamba blocks, the VLM with two trailing self layers), f32 and bf16
     params with the SSD's A_log, dt_bias and D and the cross gates drawn
     off their init values, prefilled and decoded 8 steps on the CPU and
     on the card from the same weights and stub inputs, each CPU step
     from the card's state (TOL_F32 / TOL_FAMILY_BF16; zamba2's f32 runs,
     whose conv tail and KV cache are bf16, TOL_F32_BF16_STATE), launches held
     to the plan.  (b) zamba2-7b at full width and depth, bf16: 4 x 4,096
     prompts, 32 greedy decode steps, 13 flash launches a pass.  (c)
     seamless-m4t-large-v2: 4 x 4,096 stub audio frames, 4 x 256 decoder
     prompts, the self cache padded for 32 decode steps, 72 flash launches
     in the prefill and 48 a decode step.  (d) llama-3.2-vision-11b: 4 x
     1,601 stub image embeddings, 4 x 2,048 prompts, 32 decode steps, 40
     flash launches a pass.  Each of (b)-(d): prefill s, decode ms/step,
     ``max_memory_allocated``, streamed logits against a teacher-forced
     pass (TOL_STREAM_DEEP, greedy agreement), the model freed after.
 16. main path 12: training every LM family but RWKV-6 (``train_lm``'s
     ``lm_train_step`` through ``get_model``'s ``loss_fn``, each layer
     recomputed in the backward).  In phase 3, after 3F (lines ``3B``):
     ``flash_attention_bwd`` (causal masks, GQA, bf16, Sq != Sk, one-sided
     windows, the logit softcap, Dh up to 256) against its plain version
     at each training shape of phase 16b (qwen3-32b's causal (8, 128, 64
     over 8, 128), zamba2-7b's (8, 128, 32 x 112), seamless's encoder (8,
     4096, 16 x 64), decoder self- and cross-attention over 4,096 frames,
     the VLM's self (32 over 8 x 128) and cross attention over 1,601 keys,
     gemma2-9b's local (window 4,096) and global layers (softcap 50, 16
     over 8 x 256) at 8 x 128 and 1 x 6,144, stablelm-12b's (32 over 8 x
     160), qwen3-moe's (32 over 4 x 128)) and at gemma2's 1 x 8,192
     context, bf16 timed and f32 checked where cheap: the forward's f32
     output and log-sum-exp to TOL_F32, the gradients to TOL_BF16 /
     TOL_F32 with the atol in units of each row's RMS plus 2^-14 of each
     element's terms' magnitudes, two runs bit for bit, the planted faults
     that apply (the plain version run non-causal, the last 32 queries' dQ
     without their diagonal key tile, the first 32 keys' dK/dV without
     query tile 0, kv heads mapped as h % KVH) rejected by more than 10x;
     events and device time beside the plain version, the device time of
     SDPA's backward (``is_causal``, or a bool mask for a window, no
     softcap; ``enable_gqa``) and the bound; checks off the main path
     (a window of 8 keys and a softcap of 5 over scaled logits, where the
     faults "the window one key wider" and "the softcap's factor left
     out" must be rejected too, a non-causal one-sided window with Sq !=
     Sk at Dh 160, a ragged Dh 200); "dK's last Dh tile dropped" at every
     line above Dh 128;
     ``expert_ffn_bwd`` in bf16 at qwen3-moe's (128 experts of 2048 x 768,
     capacity 80) and dbrx's (16 of 6144 x 10752, capacity 320) expert
     shapes against the plain version's f32 sums, the fault "dWg and dWu
     swapped" rejected, timed beside the plain version and six bf16
     ``bmm``s; ptxas's registers and spills.  (a) The smoke configs of
     qwen3-32b, deepseek-67b, zamba2-7b, seamless-m4t-large-v2,
     llama-3.2-vision-11b, gemma2-9b, stablelm-12b (also at head_dim
     160), qwen3-moe-30b-a3b and dbrx-132b: f32 step-0 gradients card vs
     CPU leaf by leaf, then 5 ``lm_train_step``s on both from the same
     params, batches and stub inputs, f32 and bf16, launches held to the
     plan (the recompute's second forward, and ``expert_ffn``'s,
     included).  (b) seamless-m4t-large-v2 at full width and depth,
     qwen3-32b (2 layers), zamba2-7b (12 layers: two uses of the shared
     block), llama-3.2-vision-11b (one superblock), gemma2-9b (4 layers
     at 8 x 128; 2 layers over 1 x 6,144 tokens), stablelm-12b (6 layers)
     and qwen3-moe-30b-a3b (3 layers, all 128 experts) at full width, bf16
     params and f32 moments, batch 8 x 128 with stub frames or image
     embeddings: a warm-up and 4 timed steps, s/step,
     ``max_memory_allocated``, finite losses and grad norms, launches held
     to the depth, and ``flash_attention``'s, ``flash_attention_bwd``'s
     and ``expert_ffn_bwd``'s by shape (``ops.FLASH_SHAPES``,
     ``FLASH_BWD_SHAPES``, ``FFN_BWD_SHAPES``) give the 3B rows' launches.
     dbrx-132b does not train at full width: one layer with its
     embeddings (4.5 B params) needs more than the card's 80 GB.
 17. training over a data x model mesh (``launch/mesh.make_local_mesh``,
     ``train_lm(mesh=)``, the expert-parallel MoE block with its
     differentiable all-to-alls): (a) ``make_local_mesh()`` on one NCCL
     rank, qwen3-moe smoke ``train_lm`` for 2 steps bit-identical to the
     mesh-less card run, launches held to the plan; (b) data 2 x model 2,
     four gloo ranks sharing the card against the same mesh on four CPU
     gloo ranks, qwen3-moe smoke for 3 steps from params drawn on the CPU
     (CUDA's generator draws other numbers): losses within 16a's bf16
     bound, every leaf but the experts bit-identical across the card's
     ranks, each rank's launches held to the plan; (c) qwen3-moe-30b-a3b
     at full width, 2 of 48 layers, model 2 (64 experts a rank) over two
     gloo ranks sharing the card, batch 8 x 128 bf16: a warm-up and 4
     timed steps, s/step, ``max_memory_allocated`` per rank, the
     all-to-alls' calls and bytes a step (the (128, 40, 2048) bf16 buffer
     of 512 local tokens at capacity 40, six calls a layer: forward,
     recompute, backward), launches by shape held to the plan; then one
     profiled step under remat "full" (12 all-to-alls by
     ``hlo_cost.collective_counts``) and one under "save_ffn" (8).
 18. the dry run against the card (``launch/dryrun.py``: the step on
     ``meta`` tensors for rank 0 of a fake world, host only, each run a
     process of its own, all started at once): (a) the fake backend and
     ``FakeStore`` import and a world-256 ``new_group`` runs an all-to-all
     on ``meta``; (b) the dry run of 16b's qwen3-moe cut (3 layers, 8 x
     128, a 1 x 1 mesh): its parameter, gradient and optimizer bytes equal
     what 16b held (its params, ``lm_grads``' gradient tree and AdamW's
     state), exactly, and its peak is within 2% of 16b's
     ``max_memory_allocated``; of 17c's (2 layers, model 2, a world of 2):
     its all-to-alls (count and bytes) equal 17c's profiled step's, exactly,
     and it holds the reference's placement (the dry run's train steps
     of the dense and moe families place every leaf by its spec, while
     17c runs ``train_lm``'s layout: the peaks of that placement are held
     to the card in phase 19); (c) 16b's cut on the
     card under the remat policies "full", "dots" and "save_ffn": step-0
     losses and gradients bit-identical to "full", s/step and
     ``max_memory_allocated`` beside the dry run's for that policy; (d) the
     production dry runs of qwen3-moe-30b-a3b train_4k and dit-moe-g
     dit_serve on 16 x 16: fits, peak bytes, dominant roofline term
     (modelled from the data sheet's peaks).
 19. tensor parallelism (``models/tp.py``; every leaf cut by the
     reference's ``param_spec`` over ``model``, the AdamW moments also over
     ``data`` by ``opt_state_spec``; ``sharding.shard_lm_params`` /
     ``shard_lm_moments``): (a) in phase 3 after 3B, the flash forward's
     log-sum-exp and f32 output and the backward at a query offset (the
     ``"seq"`` layout's rows) against their plain versions, qwen3-32b's (8,
     128, 64 over 8, 128) causal and gemma2's local and global layers over 1
     x 6,144, each cut into 2 query halves, bf16, to 3B's tolerances; the
     planted fault "offset ignored" rejected by 10x; each half timed beside
     its bound and the backward of ``scaled_dot_product_attention`` with an
     offset bool ``attn_mask``; (b) 16b's qwen3-32b cut (2 layers at full
     width, 8 x 128, bf16 params, f32 moments) under model 2 on two gloo
     ranks sharing the card, ``seq_shard`` + ``attn_seq``: the step-0 loss
     and the gathered gradients of ``embed`` (the batch's rows; every other
     row 0), layer 0's ``wq`` and ``wk`` and ``ln1`` against the single-rank
     step from the same params (run first, then freed), within 16a's bf16
     bound (loss) and 5e-2 of each leaf's largest (bf16 gradients); a
     warm-up and 2 timed steps (1 in (c)): s/step, launches per rank held to the plan
     (the offset backward's among them), ``max_memory_allocated`` per rank
     within 2% of the dry run's peak for the same cut and mesh, the
     collectives of a profiled step equal to the dry run's by kind; (c) the
     same cut at data 2 x model 2 (four ranks), the default layout and the
     moments cut over ``data`` (ZeRO): step-0 loss against (b)'s single
     rank, s/step, launches, memory and collectives against the dry run's.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

try:
    from repro_torch.common.config import HW
except ImportError:                       # not a checkout: main() says so
    HW = None
# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit;
# common/config.HW holds them): FP32 outside the tensor cores, TF32 on the
# tensor cores, and HBM3 bandwidth.  An f32-accurate 3xTF32 product costs
# three TF32 products.
PEAK_FP32_FLOPS = HW.peak_flops_fp32 if HW else None
PEAK_TF32_FLOPS = HW.peak_flops_tf32 if HW else None
PEAK_HBM_BYTES = HW.hbm_bw if HW else None

TOL_F32 = dict(rtol=1e-4, atol=1e-4)      # f32 sums of up to 4608 terms
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)     # bf16 in/out, f32 accumulate
XL_STEPS = 10
TINY_STEPS = 6
XL_REQUESTS = 8
TOL_SCAN = dict(rtol=1e-3, atol=1e-3)     # f32 state, sums of 64 terms chained over T
# max |streamed - teacher-forced| bf16 logit: 5e-2 where tests/test_streaming.py
# holds the reference (2 layers, and the last prompt position at any depth);
# over the decode positions at 32 layers the card's bf16 roundings, which
# differ between cuBLAS's kernels for 8 rows and for 16,896, spread to
# 0.19 (PERF.md, PR 12), so those are held to 0.25 and to greedy tokens
# that agree at least 90% of the time
TOL_STREAM = 5e-2
TOL_STREAM_DEEP = 0.25
MIN_GREEDY_AGREE = 0.9
LM_BATCH, LM_PROMPT, LM_DECODE = 8, 2048, 64
CONT_REQUESTS, CONT_SLOTS, CONT_EVERY = 24, 8, 2   # 7b: 4 requests every 2 ticks
DIT_KERNELS = ("expert_ffn", "flash_attention", "residual_int8")
EP = 2                                    # phase 8: ranks sharing the one card
EP_TIMEOUT_S = 600                        # per spawn: collectives and reports
MESH_XL_LAYERS = 8                        # phase 10c/10d: XL width, depth cut
PLACE_REQUESTS = 4                        # 10d: 2 a rank at capacity_factor 8
PLACE_BIAS = 1.5                          # 10d: router bias toward expert 5


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    mem = ""
    if "torch" in sys.modules and sys.modules["torch"].cuda.is_initialized():
        cuda = sys.modules["torch"].cuda
        mem = (f" (this process then holds {cuda.memory_allocated() / 2**30:.3f} GiB "
               f"allocated, {cuda.memory_reserved() / 2**30:.3f} reserved on the card)")
    log(f"== phase {name} done in {time.perf_counter() - t0:.3f} s{mem}")


def compare(name: str, got, want, tol) -> float:
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / w.abs().clamp_min(1e-6)).max()) if err.numel() else 0.0
    log(f"  {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
        f"(tol rtol={tol['rtol']} atol={tol['atol']}) "
        f"{'ok' if not bool(bad.any()) else 'FAIL'}")
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN")
    return smi.splitlines()[0]


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {build.build_stats['seconds']:.3f} s) into {build.build_dir()}")
    for line in build.ptxas_report():
        log(f"  {line}")


def _expert_inputs(gen, E, C, d, f, dtype):
    import torch
    kw = dict(generator=gen, device="cuda")
    buf = torch.randn((E, C, d), **kw).to(dtype)
    wg = (torch.randn((E, d, f), **kw) / math.sqrt(d)).to(dtype)
    wu = (torch.randn((E, d, f), **kw) / math.sqrt(d)).to(dtype)
    wd = (torch.randn((E, f, d), **kw) / math.sqrt(f)).to(dtype)
    return buf, wg, wu, wd


def phase_kernels():
    """Each kernel against its plain version; returns the table rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.timing import device_ms, rotating, time_ms
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}

    # ---- expert_ffn -------------------------------------------------------
    log("expert_ffn (hand-written CUDA, two launches) vs plain PyTorch")
    cases = [(8, 640, 1152, 4608, torch.float32, "silu"),   # XL refresh
             (8, 320, 1152, 4608, torch.float32, "silu"),   # XL DICE light
             (4, 640, 1152, 4608, torch.float32, "silu"),   # XL ep=2 rank refresh
             (8, 640, 1152, 4608, torch.bfloat16, "silu"),
             (8, 320, 1152, 4608, torch.bfloat16, "silu"),
             (2, 136, 1152, 768, torch.float32, "gelu"),    # ragged C and f
             (2, 136, 64, 768, torch.bfloat16, "gelu"),
             # edges of the 128-row, BK = 32, 64/128-column tiles
             (8, 1, 72, 100, torch.float32, "silu"),
             (8, 127, 1000, 100, torch.bfloat16, "silu"),
             (8, 129, 72, 4608, torch.float32, "gelu")]
    timed = {}
    for E, C, d, f, dtype, act in cases:
        args = _expert_inputs(gen, E, C, d, f, dtype)
        got = ops.expert_ffn(*args, act=act)
        want = ref.expert_ffn_ref(*args, act=act)
        torch.cuda.synchronize()
        err = compare(f"expert_ffn E={E} C={C} d={d} f={f} {str(dtype)[6:]} {act}",
                      got, want, TOL_F32 if dtype == torch.float32 else TOL_BF16)
        if (d, dtype) == (1152, torch.float32) and C in (320, 640):
            timed[E, C] = (err, args)
    d, f = 1152, 4608
    for E, C, label in ((8, 640, "refresh"), (8, 320, "light"),
                        (4, 640, "ep=2 rank refresh")):
        err, args = timed.pop((E, C))
        ms = time_ms(lambda: ops.expert_ffn(*args), 10)
        dev = device_ms(lambda: ops.expert_ffn(*args), 10)
        plain = time_ms(lambda: ref.expert_ffn_ref(*args), 10)
        x, wg, wu, wd = args
        h = torch.randn((E, C, f), device="cuda")     # leaves gen's stream as it was
        # the GEMMs alone, three cuBLAS bmm calls: a yardstick, not one
        # library call computing the gated MLP
        yard = time_ms(lambda: (torch.bmm(x, wg), torch.bmm(x, wu),
                                torch.bmm(h, wd)), 10)
        del x, wg, wu, wd, h
        flops = 6.0 * E * C * d * f
        nbytes = 4.0 * (2 * E * C * d + 3 * E * d * f)
        b_ms, b_by = bound(flops, nbytes)
        tc_ms, tc_by = bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
        log(f"  expert_ffn XL {label} E={E} C={C} f32: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s; device alone {dev:.4f} ms), plain "
            f"version (three f32 matmuls, activation and product) {plain:.4f} ms, "
            f"cuBLAS yardstick (the three f32 bmm calls alone) {yard:.4f} ms, bound "
            f"{tc_ms:.4f} ms ({tc_by}, 3xTF32 on the tensor cores), FP32 CUDA-core "
            f"bound {b_ms:.4f} ms ({b_by}); library: none (no single PyTorch call "
            f"computes the gated MLP); kernel < yardstick: {ms < yard}")
        if (E, C) == (4, 640):
            rows["expert_ffn ep2 rank"] = dict(
                name="expert_ffn", route="cuda",
                source="src/repro_torch/csrc/expert_ffn.cu",
                replaces="src/repro/kernels/expert_ffn.py:69", max_abs_err=err, ms=ms,
                device_ms=dev, events_ms=ms, plain_ms=plain, bound_ms=tc_ms, bound_by=tc_by,
                fp32_bound_ms=b_ms, library_ms=None, yardstick_ms=yard,
                shape="E=4 C=640 d=1152 f=4608 f32 silu (an ep=2 rank at refresh)")
        if (E, C) == (8, 640):
            rows["expert_ffn"] = dict(
                name="expert_ffn", route="cuda",
                source="src/repro_torch/csrc/expert_ffn.cu",
                replaces="src/repro/kernels/expert_ffn.py:69", max_abs_err=err, ms=ms,
                device_ms=dev, events_ms=ms, plain_ms=plain, bound_ms=tc_ms, bound_by=tc_by, fp32_bound_ms=b_ms,
                library_ms=None, yardstick_ms=yard, shape="E=8 C=640 d=1152 f=4608 f32 silu")
        del args

    # ---- flash_attention --------------------------------------------------
    log("flash_attention (hand-written CUDA) vs plain PyTorch")
    fcases = [((8, 256, 256, 16, 16, 72), torch.float32, {}),    # XL DiT
              ((8, 256, 256, 16, 16, 72), torch.bfloat16, {}),
              ((2, 128, 128, 4, 2, 64), torch.float32, dict(causal=True)),
              ((2, 128, 128, 4, 2, 64), torch.float32, dict(window=64)),
              ((2, 128, 128, 4, 2, 64), torch.float32, dict(causal=True, window=32)),
              ((2, 128, 128, 4, 2, 64), torch.float32, dict(softcap=50.0)),
              ((2, 128, 128, 4, 2, 64), torch.float32,
               dict(causal=True, window=64, softcap=30.0)),
              ((1, 256, 256, 4, 1, 64), torch.float32, {}),             # MQA
              ((2, 64, 64, 2, 2, 128), torch.float32, {}),
              ((2, 128, 256, 8, 8, 32), torch.float32, {}),
              ((1, 64, 100, 2, 2, 256), torch.float32, dict(causal=True)),  # ragged Sk
              ((1, 40, 40, 2, 2, 24), torch.float32, dict(window=1)),
              # edges of the 128-row query and 32-key (16 at Dh > 128) tiles
              ((2, 65, 257, 4, 1, 72), torch.float32, {}),
              ((1, 65, 257, 8, 2, 128), torch.bfloat16, dict(causal=True)),
              ((1, 40, 257, 4, 2, 256), torch.float32, dict(window=48))]
    for (B, Sq, Sk, H, KVH, Dh), dtype, opts in fcases:
        q = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Sk, KVH, Dh), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Sk, KVH, Dh), generator=gen, device="cuda").to(dtype)
        got = ops.flash_attention(q, k, v, **opts)
        want = ref.flash_attention_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        err = compare(f"flash B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} Dh={Dh} "
                      f"{str(dtype)[6:]} {opts}", got, want,
                      TOL_F32 if dtype == torch.float32 else TOL_BF16)
        if (B, Sq, Dh, dtype) == (8, 256, 72, torch.float32):
            row_err, xl_qkv = err, (q, k, v)
    q, k, v = xl_qkv
    B, S, H, Dh = q.shape
    ms = time_ms(lambda: ops.flash_attention(q, k, v), 50)
    dev = device_ms(lambda: ops.flash_attention(q, k, v), 50)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), 50)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 50)
    flops = 4.0 * B * H * S * S * Dh
    nbytes = 4.0 * 4 * B * S * H * Dh
    b_ms, b_by = bound(flops, nbytes)
    tc_ms, tc_by = bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
    log(f"  flash XL f32: kernel {ms:.4f} ms (device alone {dev:.4f} ms), plain {plain:.4f} ms, "
        f"scaled_dot_product_attention {lib:.4f} ms, bound {tc_ms:.4f} ms ({tc_by}, "
        f"3xTF32 on the tensor cores), FP32 CUDA-core bound {b_ms:.4f} ms ({b_by}); "
        f"the shape is the same on light and refresh steps; kernel <= library: "
        f"{ms <= lib}")
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:70", max_abs_err=row_err,
        ms=ms, device_ms=dev, events_ms=ms, plain_ms=plain, bound_ms=tc_ms, bound_by=tc_by,
        fp32_bound_ms=b_ms, library_ms=lib, shape="B=8 S=256 H=16 Dh=72 f32 non-causal")

    # ---- residual_int8 ----------------------------------------------------
    log("residual_int8 (hand-written CUDA) vs plain PyTorch")
    # the register path at the XL payloads (N = 4096 dispatch, 8192
    # combine; 4096 is its widest bf16 row), then the looping path's rows:
    # d not a multiple of the 16-byte vector, wider than 16 vectors a lane,
    # rows not 16-byte aligned; N not a multiple of the 8 rows a block
    icases = [(2048, 1152, torch.float32), (4096, 1152, torch.float32),
              (8192, 1152, torch.float32), (4096, 1152, torch.bfloat16),
              (16, 4096, torch.bfloat16), (37, 1151, torch.float32),
              (9, 1150, torch.bfloat16), (16, 4096, torch.float32),
              (16, 8192, torch.float32), (5, 9000, torch.bfloat16),
              (40, 1152, "unaligned f32")]
    for N, d, dtype in icases:
        unaligned = dtype == "unaligned f32"
        dtype = torch.float32 if unaligned else dtype
        value, base = _int8_inputs(gen, N, d, dtype, unaligned=unaligned)
        # exact .5 ties: base 0 and a row abs-max of 127 give scale 1, so
        # r / scale lands on k + 0.5, which must round half to even
        ties = torch.arange(d, device="cuda", dtype=torch.float32) % 254 - 126.5
        ties[0] = 127.0
        value[:4] = ties.to(dtype)
        base[:4] = 0
        qk, sk, rk = ops.residual_int8(value, base)
        qp, sp, rp = ref.residual_int8_ref(value, base)
        torch.cuda.synchronize()
        mism = int((qk != qp).sum())
        tag = f"N={N} d={d} {str(dtype)[6:]}{' unaligned rows' if unaligned else ''}"
        log(f"  residual_int8 {tag}: q mismatches {mism} (tol 0), scale equal "
            f"{torch.equal(sk, sp)}, tie rows round half to even: "
            f"{bool((qk[:4].float() == torch.round(ties)[None]).all())}")
        if mism or not torch.equal(sk, sp):
            raise AssertionError("residual_int8: q or scale differ from the plain version")
        err = compare(f"residual_int8 recon {tag}", rk, rp,
                      dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else TOL_BF16)
        if (N, d, dtype, unaligned) == (4096, 1152, torch.float32, False):
            row_err = err
    # C.6: rows holding NaN, +Inf, -Inf and a mix, and a NaN in a base row,
    # on the register path and the looping path: the plain version's (and
    # the JAX encoder's) scale NaN or Inf, q 0 and a NaN reconstruction
    for N, d, dtype in ((33, 1152, torch.float32), (33, 1152, torch.bfloat16),
                        (9, 1151, torch.float32), (16, 4096, torch.bfloat16),
                        (9, 9000, torch.float32)):
        value, base = _int8_inputs(gen, N, d, torch.float32)
        value[0, 3] = math.nan
        value[1, 2] = math.inf
        value[2, d - 1] = -math.inf
        value[3, 1], value[3, d // 2], value[3, d - 2] = math.nan, math.inf, -math.inf
        base[4, 0] = math.nan
        value, base = value.to(dtype), base.to(dtype)
        qk, sk, rk = ops.residual_int8(value, base)
        qp, sp, rp = ref.residual_int8_ref(value, base)
        torch.cuda.synchronize()
        same_scale = bool(((sk == sp) | (torch.isnan(sk) & torch.isnan(sp))).all())
        same_nan = torch.equal(torch.isnan(rk), torch.isnan(rp))
        ok = (torch.equal(qk, qp) and same_scale and same_nan
              and bool(torch.isnan(rk[:5]).all()) and bool((qk[:5] == 0).all()))
        log(f"  residual_int8 non-finite rows N={N} d={d} {str(dtype)[6:]}: q equal "
            f"{torch.equal(qk, qp)}, scale equal (NaN = NaN) {same_scale}, NaN "
            f"positions of recon equal {same_nan}, scales of the bad rows "
            f"{[float(x) for x in sk[:5, 0]]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("residual_int8: non-finite rows differ from the "
                                 "plain version")
        compare(f"residual_int8 recon of the finite rows N={N} d={d} {str(dtype)[6:]}",
                rk[5:], rp[5:],
                dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else TOL_BF16)
    # timed on three input sets a shape (113 MB at N = 4096), in turn, so
    # that no call finds its inputs in the 50 MB L2
    for N, dtype in ((4096, torch.float32), (8192, torch.float32),
                     (4096, torch.bfloat16)):
        d = 1152
        sets = [_int8_inputs(gen, N, d, dtype) for _ in range(3)]
        dev = device_ms(rotating(ops.residual_int8, sets), 300)
        events = time_ms(rotating(ops.residual_int8, sets), 300)
        plain = time_ms(rotating(ref.residual_int8_ref, sets), 30)
        es = 4 if dtype == torch.float32 else 2
        nbytes = N * d * (3 * es + 1) + N * 4
        b_ms, b_by = bound(6.0 * N * d, nbytes)
        log(f"  residual_int8 N={N} d={d} {str(dtype)[6:]}: kernel device {dev:.4f} ms "
            f"({nbytes / dev / 1e6:.1f} GB/s, {100 * b_ms / dev:.1f}% of bound), with host "
            f"(CUDA events) {events:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), library: none")
        if (N, dtype) == (4096, torch.float32):
            rows["residual_int8"] = dict(
                name="residual_int8", route="cuda",
                source="src/repro_torch/csrc/residual_int8.cu",
                replaces="src/repro/kernels/residual_codec.py:44", max_abs_err=row_err,
                ms=dev, device_ms=dev, events_ms=events, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, shape="N=4096 d=1152 f32")
        del sets

    # ---- rwkv6_scan -------------------------------------------------------
    log("rwkv6_scan (hand-written CUDA) vs plain PyTorch")
    # the main path's shapes, then T across the 2048 / DK-step tiles (1, a
    # ragged last tile at 37 and 300), DK 16 and 128, B * H odd, inputs
    # whose rows are not 16-byte aligned
    scases = [((8, 40, LM_PROMPT, 64), torch.bfloat16, False),    # rwkv6-3b prefill
              ((8, 40, 1, 64), torch.bfloat16, False),            # rwkv6-3b decode
              ((2, 4, 37, 16), torch.float32, False), ((2, 4, 37, 32), torch.bfloat16, False),
              ((1, 3, 300, 32), torch.float32, False), ((2, 2, 64, 128), torch.bfloat16, False),
              ((3, 5, 300, 64), torch.bfloat16, False), ((2, 3, 1, 128), torch.float32, False),
              ((1, 2, 37, 128), torch.bfloat16, False), ((2, 3, 300, 16), torch.bfloat16, False),
              ((3, 5, 45, 64), torch.bfloat16, True), ((1, 3, 45, 16), torch.float32, True)]
    for (B, H, T, DK), dtype, unaligned in scases:
        args = _scan_inputs(gen, B, H, T, DK, dtype, unaligned=unaligned)
        out, s_T = ops.rwkv6_scan(*args)
        want_out, want_s = ref.rwkv6_scan_ref(*args)
        torch.cuda.synchronize()
        tag = (f"rwkv6_scan B={B} H={H} T={T} DK={DK} r/k/v {str(dtype)[6:]}"
               f"{' unaligned rows' if unaligned else ''}")
        err = max(compare(f"{tag} out", out, want_out, TOL_SCAN),
                  compare(f"{tag} S_T", s_T, want_s, TOL_SCAN))
        if (H, T) == (40, LM_PROMPT):
            errs = {"prefill": err}
        if (H, T) == (40, 1):
            errs["decode"] = err
    # prefill on one input set (0.6 GB, far above L2); decode in turn on 8
    # (84 MB of state), as 32 layers' states would come
    for label, T, n_sets, iters in (("prefill", LM_PROMPT, 1, 20), ("decode", 1, 8, 200)):
        B, H, DK = 8, 40, 64
        sets = [_scan_inputs(gen, B, H, T, DK, torch.bfloat16, unaligned=False,
                             permuted=True) for _ in range(n_sets)]
        dev = device_ms(rotating(ops.rwkv6_scan, sets), iters)
        events = time_ms(rotating(ops.rwkv6_scan, sets), iters)
        plain = time_ms(rotating(ref.rwkv6_scan_ref, sets), 3 if T > 1 else 50)
        flops = 5.0 * DK * DK * B * H * T
        nbytes = (B * H * T * DK * (3 * 2 + 4 + 4) + H * DK * 2
                  + 2 * B * H * DK * DK * 4)
        b_ms, b_by = bound(flops, nbytes)
        bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
        log(f"  rwkv6_scan {label} B={B} H={H} T={T} DK={DK} bf16: kernel device "
            f"{dev:.4f} ms ({100 * b_ms / dev:.1f}% of bound), with host (CUDA events) "
            f"{events:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; FP32 "
            f"cores {flops / PEAK_FP32_FLOPS * 1e3:.4f} ms, bytes {bytes_ms:.4f} ms), "
            f"library: none (no single PyTorch call computes the recurrence)")
        rows["rwkv6_scan" if label == "prefill" else "rwkv6_scan decode"] = dict(
            name="rwkv6_scan", route="cuda", source="src/repro_torch/csrc/rwkv6_scan.cu",
            replaces="src/repro/kernels/rwkv6_scan.py:55", max_abs_err=errs[label],
            ms=dev, device_ms=dev, events_ms=events, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
            shape=f"B=8 H=40 T={T} DK=64 bf16 ({label})")
        del sets
    torch.cuda.synchronize()
    return rows


def _int8_inputs(gen, N, d, dtype, unaligned=False):
    """A payload and its residual base, 0.1 apart; with ``unaligned``, both
    are contiguous views that start one element into their storage."""
    import torch
    value = torch.randn((N, d), generator=gen, device="cuda")
    base = value + 0.1 * torch.randn((N, d), generator=gen, device="cuda")
    if unaligned:
        flat = torch.empty(2 * N * d + 1, device="cuda")
        flat[1:1 + N * d] = value.flatten()
        flat[1 + N * d:] = base.flatten()
        value, base = flat[1:1 + N * d].view(N, d), flat[1 + N * d:].view(N, d)
    return value.to(dtype), base.to(dtype)


def _scan_inputs(gen, B, H, T, DK, dtype, unaligned=False, permuted=False):
    """r/k/v in ``dtype``, logw f32 as the model makes it, u in ``dtype``,
    a random f32 state.  ``permuted``: (B, T, H, DK) projections permuted to
    (B, H, T, DK), as the model passes them; ``unaligned``: cut one element
    into wider rows as well, so no row is 16-byte aligned."""
    import torch
    kw = dict(generator=gen, device="cuda")
    if unaligned:
        width = H * DK
        rkv = torch.randn((B, T, 3 * width + 3), **kw).to(dtype)
        r, k, v = (rkv[..., 1 + i * width:1 + (i + 1) * width].unflatten(-1, (H, DK))
                   .permute(0, 2, 1, 3) for i in range(3))
        w = -torch.exp(torch.randn((B, T, width + 1), **kw) - 3.0)
        logw = w[..., 1:].unflatten(-1, (H, DK)).permute(0, 2, 1, 3)
    elif permuted:
        r, k, v = (torch.randn((B, T, H, DK), **kw).to(dtype).permute(0, 2, 1, 3)
                   for _ in range(3))
        logw = (-torch.exp(torch.randn((B, T, H, DK), **kw) - 3.0)).permute(0, 2, 1, 3)
    else:
        r, k, v = (torch.randn((B, H, T, DK), **kw).to(dtype) for _ in range(3))
        logw = -torch.exp(torch.randn((B, H, T, DK), **kw) - 3.0)
    u = (0.5 + 0.1 * torch.randn((H, DK), **kw)).to(dtype)
    s0 = 0.1 * torch.randn((B, H, DK, DK), **kw)
    return r, k, v, logw, u, s0


def _perturb(params, gen, scale=0.05):
    """adaLN and the output layer are zero-initialised; give them random
    values so the blocks are not identity maps."""
    import torch
    dev = gen.device
    for blk in params["blocks"]:
        blk["adaln"] = scale * torch.randn(blk["adaln"].shape, generator=gen, device=dev)
    params["final_out"] = scale * torch.randn(params["final_out"].shape,
                                              generator=gen, device=dev)
    return params


def planned_launches(plans, passes: int, ranks: int = 1, patch_ndev: int = 0):
    """Kernel launches a sequence of step plans implies (on each rank of a
    mesh whose ep axis has ``ranks``): per pass and layer one flash
    attention (``patch_ndev`` under the replicated patch simulation: one a
    simulated device) and one expert FFN (two for a staggered half-batch
    layer; on the ring one per chunk, ``ranks`` a call; one more a call
    for a placement's replicated experts); a codec'd action quantizes its
    dispatch payload, and an interweaved one with a cache its combine
    payload too (the int8 codec through ``residual_int8``; top-k is plain
    PyTorch)."""
    n = {"expert_ffn": 0, "flash_attention": 0, "residual_int8": 0,
         "rwkv6_scan": 0, "expert_ffn_bwd": 0, "flash_attention_bwd": 0,
         "rwkv6_scan_bwd": 0}
    for plan in plans:
        for a in plan.actions:
            n["flash_attention"] += passes * max(1, patch_ndev)
            replica = int(a.placement is not None and bool(a.placement.replicated))
            n["expert_ffn"] += passes * (2 if a.mode == "staggered" else 1) \
                * ((ranks if a.overlap else 1) + replica)
            if a.codec is not None and a.codec.kind == "int8_residual":
                n["residual_int8"] += passes * (
                    1 + int(a.mode == "interweaved" and a.want_cache))
    return n


def phase_tiny():
    import torch
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.configs.dit_moe_xl import tiny
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import DiceServer, Request
    from repro_torch.models.dit_moe import init_dit
    cfg = tiny()
    gen = torch.Generator(device="cpu").manual_seed(5)
    params = _perturb(init_dit(cfg, generator=gen), gen)
    noise = torch.randn((8, cfg.patch_tokens, cfg.in_channels), generator=gen)
    reqs = [Request(class_id=i % cfg.num_classes, rid=i) for i in range(8)]
    dcfg = DiceConfig.dice(compress=CompressConfig("int8_residual"))
    out = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, dev)
        server = DiceServer(cfg, dcfg, params=p, device=dev)
        # 6 steps: warm-up 0-1, refresh 2 and 4, light 3 and 5.  Step 4
        # consumes the light step's (int8-coded) expert outputs; with 4
        # steps they would never reach the sample.
        out[dev], stats = server.generate(reqs, num_steps=TINY_STEPS, noise=noise)
        log(f"  tiny on {dev}: {stats['wall_s']:.3f} s, launches "
            f"{stats['kernel_launches']}")
    if min(stats["kernel_launches"][k] for k in DIT_KERNELS) <= 0:
        raise AssertionError("the CUDA run of the tiny model missed a kernel")
    # f32 sums in another order can flip an int8 rounding (one quantization
    # step, 1/127 of a row's residual range); such flips stay far below
    # 1e-3 in the sample, while a wrong kernel's errors are O(1)
    compare("tiny dice+int8 samples, cuda kernels vs cpu plain", out["cuda"].cpu(),
            out["cpu"], dict(rtol=1e-3, atol=1e-3))


def phase_smoke_lm():
    """The smoke RWKV-6 (f32 params from one seed) prefilled with 2 x 32
    tokens on the CPU (plain recurrence) and on the card (kernel), then
    decoded 8 steps; each CPU decode step starts from the card's state, so
    a token-shift state that rounds to the other bf16 neighbour on one
    device cannot build up over the steps.  Logits and state S agree to
    1e-3."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model
    cfg = get_smoke("rwkv6-3b")
    api = get_model(cfg)
    params = api.init(cfg, generator=torch.Generator().manual_seed(3),
                      dtype=torch.float32)
    p_gpu = _to(params, "cuda")
    tokens = next(token_batches(cfg.vocab_size, 2, 40, seed=1))["tokens"]
    tol = dict(rtol=1e-3, atol=1e-3)
    ops.reset_launches()
    lg_gpu, st_gpu = api.prefill(p_gpu, {"tokens": tokens[:, :32].cuda()}, cfg)
    lg_cpu, st_cpu = api.prefill(params, {"tokens": tokens[:, :32]}, cfg)
    errs = [compare("smoke rwkv6 prefill logits, cuda vs cpu", lg_gpu.cpu(), lg_cpu, tol),
            compare("smoke rwkv6 prefill state S, cuda vs cpu", st_gpu["S"].cpu(),
                    st_cpu["S"], tol)]
    for t in range(32, 40):
        st_cpu = _to({k: v for k, v in st_gpu.items() if k != "pos"}, "cpu")
        st_cpu["pos"] = st_gpu["pos"]
        lg_cpu, st_cpu = api.decode_step(params, {"token": tokens[:, t]}, st_cpu, cfg)
        lg_gpu, st_gpu = api.decode_step(p_gpu, {"token": tokens[:, t].cuda()},
                                         st_gpu, cfg)
        torch.cuda.synchronize()
        for name, got, want in (("logits", lg_gpu, lg_cpu), ("S", st_gpu["S"], st_cpu["S"])):
            err = (got.cpu() - want).abs()
            errs.append(float(err.max()))
            if bool((err > tol["atol"] + tol["rtol"] * want.abs()).any()):
                raise AssertionError(f"smoke rwkv6 decode step {t}: {name} differ")
    log(f"  smoke rwkv6 8 decode steps from the card's state, cuda vs cpu: max abs "
        f"err {max(errs[2:]):.3e} (tol rtol=1e-3 atol=1e-3) ok; rwkv6_scan "
        f"launches on the card {ops.LAUNCHES['rwkv6_scan']}")
    if ops.LAUNCHES["rwkv6_scan"] != cfg.num_layers * 9:
        raise AssertionError("the CUDA run of the smoke RWKV-6 missed the kernel")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if hasattr(tree, "to") else tree      # a cache's host pos


def drive(server, reqs, num_steps: int, label: str, *, need_codec: bool):
    """One ``generate`` call with the launch counts set to 0 just before it
    and read just after; the counts must equal what the plan implies, and
    every kernel the path runs must have been launched."""
    import torch
    from repro_torch.kernels import ops
    splan = server.plan(num_steps)
    ops.reset_launches()
    samples, stats = server.generate(reqs, num_steps=num_steps)
    counts = dict(ops.LAUNCHES)
    want = planned_launches(splan.steps, passes=2)
    finite = bool(torch.isfinite(samples).all())
    log(f"  {label} XL {len(reqs)} requests x {num_steps} steps: "
        f"{stats['wall_s_per_step']:.4f} s/step, finite {finite}, std "
        f"{float(samples.std()):.6f}, launches {counts}, planned {want}")
    cfg = server.cfg
    if not finite or tuple(samples.shape) != (len(reqs), cfg.patch_tokens,
                                              cfg.in_channels):
        raise AssertionError(f"{label}: samples are not finite or have the wrong shape")
    needed = ["expert_ffn", "flash_attention"] + ["residual_int8"] * need_codec
    if counts != want or min(counts[k] for k in needed) <= 0:
        raise AssertionError(f"{label}: kernel launch counts differ from the plan")
    return samples, stats, counts


def _xl_server(dcfg):
    """DiT-MoE-XL on the card, params from seed 0, adaLN and the output
    layer perturbed from seed 99: phases 5 and 7 serve the same weights."""
    import torch
    from repro_torch.configs.dit_moe_xl import config
    from repro_torch.launch.serve import DiceServer
    server = DiceServer(config(), dcfg, device="cuda", seed=0)
    _perturb(server.params, torch.Generator(device="cuda").manual_seed(99))
    return server


def phase_xl(rows):
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import DiceServer, Request
    int8 = CompressConfig("int8_residual")
    t0 = time.perf_counter()
    server = _xl_server(DiceConfig.dice(compress=int8))
    cfg = server.cfg
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(server.params).values())
    log(f"  XL params: {n_params / 1e9:.3f} B on the card, init {time.perf_counter() - t0:.3f} s")
    reqs = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
            for i in range(XL_REQUESTS)]
    server.generate(reqs, num_steps=1)            # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    samples, stats, counts = drive(server, reqs, XL_STEPS, "dice+int8",
                                   need_codec=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  dice+int8 wall {stats['wall_s']:.4f} s, peak memory {peak:.3f} GiB, "
        f"plan variants {stats['num_plan_variants']}")
    db = stats["dispatch_bytes_per_step"]
    refresh = [db[s] for s in range(XL_STEPS) if s >= 2 and s % 2 == 0]
    light = [db[s] for s in range(XL_STEPS) if s >= 2 and s % 2 == 1]
    log(f"  dispatch_bytes per step {db}: refresh {refresh[0]:.0f}, light {light[0]:.0f}")
    if not max(light) < min(refresh):
        raise AssertionError("light steps do not dispatch fewer bytes than refresh steps")
    for name in DIT_KERNELS:
        rows[name]["launches"] = counts[name]

    # the other four schedules, 4 steps each from the same weights: 2
    # warm-up steps, then a refresh and a light (codec'd) step
    others = {"sync": (DiceConfig.sync_ep(), False),
              "displaced+int8": (DiceConfig.displaced(compress=int8), True),
              "interweaved+int8": (DiceConfig.interweaved(compress=int8), True),
              "staggered_batch": (DiceConfig.staggered_batch(), False)}
    for label, (dcfg, need_codec) in others.items():
        other = DiceServer(cfg, dcfg, params=server.params, device="cuda")
        drive(other, reqs, 4, label, need_codec=need_codec)
    return samples.cpu(), stats["wall_s_per_step"]


def phase_lm(rows):
    """rwkv6-3b, bf16, random params from seed 0: one warm-up prefill, then
    a prefill of 8 x 2048 prompt tokens and 64 greedy decode steps with
    the launch counts set to 0 before and read after; then one
    teacher-forced forward over prompt + generated tokens."""
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.models import rwkv6
    from repro_torch.models.api import get_model
    cfg = get_config("rwkv6-3b")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params).values())
    log(f"  rwkv6-3b params: {n_params / 1e9:.3f} B ({cfg.param_count() / 1e9:.3f} B "
        f"by the config's count), bf16, on the card, init "
        f"{time.perf_counter() - t0:.3f} s; {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.d_model // rwkv6.HEAD_DK} heads x {rwkv6.HEAD_DK}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")
    prompts = next(token_batches(cfg.vocab_size, LM_BATCH, LM_PROMPT, seed=0,
                                 device="cuda"))["tokens"]
    api.prefill(params, {"tokens": prompts}, cfg)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    t0 = time.perf_counter()
    last, state = api.prefill(params, {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.LAUNCHES["rwkv6_scan"]
    tok = last.argmax(-1)
    generated, streamed = [], [last]
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        generated.append(tok)
        lg, state = api.decode_step(params, {"token": tok}, state, cfg)
        streamed.append(lg)
        tok = lg.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"expert_ffn": 0, "flash_attention": 0, "residual_int8": 0,
            "rwkv6_scan": cfg.num_layers * (1 + LM_DECODE), "expert_ffn_bwd": 0,
            "flash_attention_bwd": 0, "rwkv6_scan_bwd": 0}
    log(f"  prefill {LM_BATCH} x {LM_PROMPT}: {prefill_s:.4f} s, "
        f"{LM_BATCH * LM_PROMPT / prefill_s:.1f} tokens/s")
    log(f"  decode {LM_DECODE} steps x {LM_BATCH}: {1e3 * decode_s / LM_DECODE:.4f} "
        f"ms/token step, {LM_BATCH * LM_DECODE / decode_s:.1f} tokens/s")
    log(f"  peak memory (prefill + decode) {peak:.3f} GiB; launches {counts}, "
        f"expected {want}; state pos {state['pos']}")
    if counts != want:
        raise AssertionError("rwkv6-3b: kernel launch counts differ from "
                             "32 per forward")
    rows["rwkv6_scan"]["launches"] = prefill_launches
    rows["rwkv6_scan decode"]["launches"] = counts["rwkv6_scan"] - prefill_launches
    log(f"  rwkv6_scan launches: prefill {prefill_launches}, decode "
        f"{counts['rwkv6_scan'] - prefill_launches}")

    gen_tokens = torch.stack(generated, 1).to(prompts.dtype)
    streamed = torch.stack(streamed, 1)                      # (B, 65, V)
    check_streaming(params, cfg, prompts, gen_tokens, streamed, TOL_STREAM_DEEP)
    log(f"  peak memory with the teacher-forced forward "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    # the same check on the first 2 and 8 layers of the same full-width
    # params: how the streamed-vs-forced gap grows with depth
    for depth, tol in ((2, TOL_STREAM), (8, TOL_STREAM_DEEP)):
        sub_cfg = cfg.replace(num_layers=depth)
        sub = dict(params, layers={k: _first(v, depth)
                                   for k, v in params["layers"].items()})
        last, state = api.prefill(sub, {"tokens": prompts}, sub_cfg)
        outs = [last]
        for i in range(LM_DECODE):
            last, state = api.decode_step(sub, {"token": gen_tokens[:, i]}, state,
                                          sub_cfg)
            outs.append(last)
        check_streaming(sub, sub_cfg, prompts, gen_tokens, torch.stack(outs, 1), tol)


def _first(tree, n: int):
    return ({k: _first(v, n) for k, v in tree.items()} if isinstance(tree, dict)
            else tree[:n])


def check_streaming(params, cfg, prompts, gen_tokens, streamed, tol_decode: float):
    """Hold streamed logits (B, 1 + decode steps, V) against one teacher-
    forced forward over prompt + generated tokens: the last prompt position
    to TOL_STREAM, the decode positions to ``tol_decode`` and greedy tokens
    that agree at least MIN_GREEDY_AGREE of the time.  A chunked
    continuation (the generated tokens as one T = 64 forward from the
    prefill state, so the state crosses a call boundary as in decode while
    the products keep many rows) is held to TOL_STREAM."""
    import torch
    from repro_torch.models import rwkv6
    P = prompts.shape[1]
    teacher, _ = rwkv6.forward(params, torch.cat([prompts, gen_tokens], 1), cfg)
    forced = teacher[:, P - 1:].clone()
    del teacher
    _, state = rwkv6.prefill(params, prompts, cfg)
    chunked, _ = rwkv6.forward(params, gen_tokens, cfg, state=state)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(streamed).all()) and bool(torch.isfinite(forced).all())
    err = (streamed.float() - forced.float()).abs().amax(dim=(0, 2))
    chunk_err = (chunked.float() - forced[:, 1:].float()).abs().max()
    chunk_vs_stream = (chunked.float() - streamed[:, 1:].float()).abs().max()
    agree = float((streamed[:, 1:].argmax(-1) == forced[:, 1:].argmax(-1)).float().mean())
    log(f"  {cfg.num_layers} layers: streamed vs teacher-forced max |diff| at the "
        f"last prompt position {float(err[0]):.4e} (tol {TOL_STREAM}), over "
        f"{streamed.shape[1] - 1} decode positions {float(err[1:].max()):.4e} (tol "
        f"{tol_decode}), greedy tokens agree {agree:.4f}; chunked continuation vs "
        f"forced {float(chunk_err):.4e}, vs streamed {float(chunk_vs_stream):.4e}; "
        f"forced logits std {float(forced.float().std()):.4f}, finite {finite}")
    if not finite or tuple(streamed.shape) != (prompts.shape[0], gen_tokens.shape[1] + 1,
                                               cfg.vocab_size):
        raise AssertionError("rwkv6: logits are not finite or have the wrong shape")
    if (float(err[0]) > TOL_STREAM or float(err[1:].max()) > tol_decode
            or agree < MIN_GREEDY_AGREE or float(chunk_err) > TOL_STREAM):
        raise AssertionError(f"rwkv6 {cfg.num_layers} layers: streamed logits "
                             f"disagree with teacher forcing")


def phase_continuous_tiny():
    """7a: a recycled slot's sample and the first wave's against the same
    requests in a fresh fixed batch, on the card, for four schedules."""
    import torch
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.configs.dit_moe_xl import tiny
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import (DiceServer, Request, request_noise,
                                          serve_continuous)
    from repro_torch.models.dit_moe import init_dit
    # the 4-layer config of tests/test_serve_continuous.py: capacity_factor
    # 8.0, so no dispatch overflows and every row is independent of its
    # co-residents
    cfg = tiny().replace(num_layers=4, d_model=64, moe_d_ff=64, d_ff=256,
                         patch_tokens=16, capacity_factor=8.0)
    gen = torch.Generator(device="cpu").manual_seed(99)
    params = _to(_perturb(init_dit(cfg, generator=gen), gen), "cuda")
    schedules = {"sync": DiceConfig.sync_ep(),
                 "interweaved": DiceConfig.interweaved(),
                 "dice": DiceConfig.dice(),
                 "dice+int8": DiceConfig.dice(compress=CompressConfig("int8_residual"))}
    reqs = [Request(1, 0), Request(2, 1), Request(3, 2)]
    worst = 0.0
    # at 6 steps a light step's output (int8-coded under dice+int8) reaches
    # the sample; at 4, the reference test's count, it does not
    for (label, dcfg), steps in itertools.product(schedules.items(), (4, 6)):
        server = DiceServer(cfg, dcfg, params=params, device="cuda")
        out, stats = serve_continuous(server, reqs, max_batch=2, num_steps=steps,
                                      seed=42, arrival_steps=[0.0, 0.0, 1.0])
        if stats["recycled_admissions"] < 1 or sorted(out) != [0, 1, 2]:
            raise AssertionError(f"7a {label}: no recycled admission")

        def fresh(batch):
            noise = torch.stack([request_noise(42, r.rid, cfg, "cuda") for r in batch])
            x, _ = server.generate(batch, num_steps=steps, noise=noise)
            return {r.rid: x[i].cpu() for i, r in enumerate(batch)}
        ref = {**fresh([reqs[2], Request(5, 7)]), **fresh(reqs[:2])}
        diff = max(float((out[r] - ref[r]).abs().max()) for r in (0, 1, 2))
        moved = float((out[2] - request_noise(42, 2, cfg)).abs().max())
        log(f"  7a {label} {steps} steps: recycled and first-wave samples vs a fresh "
            f"batch on the card, max abs diff {diff:.3e} "
            f"({'bit-identical' if diff == 0 else 'NOT bit-identical'}); "
            f"ticks {stats['ticks']}, step keys {stats['step_keys']}, moved {moved:.3f}")
        if moved == 0:
            raise AssertionError(f"7a {label}: the sampler left the noise unchanged")
        if diff != 0:
            for r in (0, 1, 2):
                compare(f"7a {label} {steps} steps rid {r}, continuous vs fresh batch",
                        out[r], ref[r], TOL_F32)
        worst = max(worst, diff)
    log(f"  7a largest recycled-vs-fresh difference over the four schedules and "
        f"4 and 6 steps: {worst:.3e}")


def phase_continuous_xl(rows):
    """7b: 24 XL requests through serve_continuous, then serve_queue."""
    import torch
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, serve_continuous, serve_queue
    server = _xl_server(DiceConfig.dice(compress=CompressConfig("int8_residual")))
    cfg = server.cfg
    reqs = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
            for i in range(CONT_REQUESTS)]
    arrivals = [float(CONT_EVERY * (i // 4)) for i in range(CONT_REQUESTS)]
    server.generate(reqs[:CONT_SLOTS], num_steps=1)     # warm-up: cuBLAS, allocator
    splan = server.plan(XL_STEPS)

    def check(label, out, counts, want):
        bad = [r for r, x in out.items()
               if tuple(x.shape) != (cfg.patch_tokens, cfg.in_channels)
               or not bool(torch.isfinite(x).all())]
        if sorted(out) != list(range(CONT_REQUESTS)) or bad:
            raise AssertionError(f"7b {label}: samples missing, misshapen or not finite")
        log(f"  7b {label} launches {counts}, planned {want}")
        if counts != want or min(counts[k] for k in DIT_KERNELS) <= 0:
            raise AssertionError(f"7b {label}: kernel launch counts differ from the plans")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, st = serve_continuous(server, reqs, max_batch=CONT_SLOTS,
                               num_steps=XL_STEPS, seed=0, arrival_steps=arrivals)
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    plans = [splan.variants[v] for v, _ in st["tick_variants"]]
    e2e = st["e2e_s"]
    log(f"  7b continuous: {CONT_REQUESTS} XL requests, {CONT_SLOTS} slots, "
        f"{XL_STEPS} steps: ticks {st['ticks']}, makespan {st['makespan_steps']}, "
        f"slotted ticks {st['slotted_ticks']}, admissions {st['admissions']} "
        f"(recycled {st['recycled_admissions']}), slot occupancy "
        f"{st['slot_occupancy']:.4f}, wall {st['wall_s']:.4f} s "
        f"({st['wall_s_per_tick']:.4f} s/tick, {CONT_REQUESTS / st['wall_s']:.4f} "
        f"requests/s), e2e p50 {e2e['p50']:.4f} s p95 {e2e['p95']:.4f} s, peak "
        f"memory {peak:.3f} GiB, step keys {st['step_keys']} of "
        f"{st['num_plan_variants']} plan variants; modeled paper8 (the paper's "
        f"8 x RTX 4090 model, not a measurement) {st['modeled_step_s_paper8']:.6f} s/step")
    check("continuous", out, counts, planned_launches(plans, passes=2))
    if st["recycled_admissions"] < 16 or st["slotted_ticks"] < 1:
        raise AssertionError("7b continuous: the mix did not recycle slots or "
                             "run a slotted tick")
    if st["step_keys"] != st["num_plan_variants"] or min(v for v, _ in st["tick_variants"]) < 0:
        raise AssertionError("7b continuous: step keys differ from the plan variants")
    for name in DIT_KERNELS:
        rows[name]["launches_continuous"] = counts[name]

    ops.reset_launches()
    out_q, view = serve_queue(server, reqs, max_batch=CONT_SLOTS,
                              num_steps=XL_STEPS, seed=0)
    counts_q = dict(ops.LAUNCHES)
    log(f"  7b queue: {view['batches']} batches of {CONT_SLOTS}, wall "
        f"{view['wall_s']:.4f} s ({view['wall_s'] / (view['batches'] * XL_STEPS):.4f} "
        f"s/step, {CONT_REQUESTS / view['wall_s']:.4f} requests/s), e2e p50 "
        f"{view['e2e_s']['p50']:.4f} s p95 {view['e2e_s']['p95']:.4f} s")
    check("queue", {r: x.cpu() for r, x in out_q.items()}, counts_q,
          planned_launches(list(splan.steps) * view["batches"], passes=2))



# ---------------------------------------------------------------------------
# phase 9: checkpoint, telemetry, top-k codec, resilience at XL width
# ---------------------------------------------------------------------------
def _generate_checked(server, reqs, num_steps, label, *, planned=True):
    """``generate`` with the launch counts set to 0 before and read after;
    the samples must be finite and, with ``planned``, the counts those of
    the plan."""
    import torch
    from repro_torch.kernels import ops
    splan = server.plan(num_steps)
    ops.reset_launches()
    samples, stats = server.generate(reqs, num_steps=num_steps)
    counts = dict(ops.LAUNCHES)
    want = planned_launches(splan.steps, passes=2)
    finite = bool(torch.isfinite(samples).all())
    log(f"  {label}: {stats['wall_s_per_step']:.4f} s/step, finite {finite}, "
        f"launches {counts}, planned {want}")
    if not finite or (planned and counts != want):
        raise AssertionError(f"{label}: samples not finite or launch counts differ "
                             f"from the plan")
    return samples, stats


def phase_checkpoint(cfg, params, reqs):
    """9a: phase 5's weights cut to 2 layers at full width, written and read
    back on the card, served from the file and from memory; a flipped byte
    must raise."""
    import shutil
    import tempfile
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import DiceServer
    from repro_torch.models.dit_moe import init_dit
    cfg2 = cfg.replace(num_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2])
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params2).values())
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=scratch)
    try:
        path = str(Path(tmp) / "xl2.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_io.save_checkpoint(path, params2, step=1)
        t_write = time.perf_counter() - t0
        size = Path(path).stat().st_size
        t0 = time.perf_counter()
        loaded = ckpt_io.load_checkpoint(path, init_dit(cfg2, generator=None),
                                         device="cuda")
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        log(f"  9a checkpoint of XL cut to 2 layers: {nbytes / 1e9:.4f} GB of "
            f"leaves, file {size / 1e9:.4f} GB; write {t_write:.3f} s "
            f"({nbytes / t_write / 1e9:.3f} GB/s, card to file), read "
            f"{t_read:.3f} s ({nbytes / t_read / 1e9:.3f} GB/s, file to card)")
        same = all(torch.equal(a, b) for a, b in zip(leaves(loaded).values(),
                                                     leaves(params2).values()))
        if not same:
            raise AssertionError("9a: the leaves read back differ from those written")
        dcfg = DiceConfig.dice(compress=CompressConfig("int8_residual"))
        out = {}
        for label, p in (("from the file", loaded), ("in memory", params2)):
            server = DiceServer(cfg2, dcfg, params=p, device="cuda")
            out[label], _ = _generate_checked(server, reqs, 4,
                                              f"9a dice+int8 2-layer XL {label}")
        diff = float((out["from the file"] - out["in memory"]).abs().max())
        log(f"  9a samples from the file vs in memory: max abs diff {diff:.3e} "
            f"({'bit-identical' if torch.equal(*out.values()) else 'DIFFERENT'})")
        if not torch.equal(*out.values()):
            raise AssertionError("9a: samples from the checkpoint differ")
        del loaded
        # one byte inside the first chunk (the first leaf's bytes follow the
        # manifest)
        head = len(ckpt_io.msgpack_lite.packb(ckpt_io.read_checkpoint_manifest(path)))
        with open(path, "r+b") as f:
            f.seek(head + 4096)
            b = f.read(1)
            f.seek(head + 4096)
            f.write(bytes([b[0] ^ 0x5A]))
        try:
            ckpt_io.load_checkpoint(path, init_dit(cfg2, generator=None), device="cuda")
        except ckpt_io.CheckpointCorruptionError as e:
            log(f"  9a flipped byte: CheckpointCorruptionError ({e})")
        else:
            raise AssertionError("9a: a flipped byte was read without an error")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_telemetry(server, reqs, phase5):
    """9b: telemetry on, samples bit-identical to phase 5's; the ages and
    codec errors held to the plan."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import DiceServer
    from repro_torch.obs import ObsConfig, telemetry
    samples5, s_per_step5 = phase5
    obs_server = DiceServer(server.cfg, server.dcfg, params=server.params,
                            device="cuda", obs=ObsConfig(enabled=True))
    samples, stats = _generate_checked(obs_server, reqs, XL_STEPS,
                                       "9b dice+int8 XL, telemetry on")
    same = torch.equal(samples.cpu(), samples5)
    log(f"  9b samples vs phase 5 (telemetry off): "
        f"{'bit-identical' if same else 'DIFFERENT'}; s/step {stats['wall_s_per_step']:.4f} "
        f"with telemetry vs {s_per_step5:.4f} in phase 5 "
        f"({100 * (stats['wall_s_per_step'] / s_per_step5 - 1):+.2f}%)")
    if not same:
        raise AssertionError("9b: telemetry changed the samples")
    tel = np.stack(stats["telemetry"])                  # (steps, L, 6)
    splan = obs_server.plan(XL_STEPS)
    age = np.array([[a.staleness for a in p.actions] for p in splan.steps])
    coded = np.array([[a.codec is not None for a in p.actions] for p in splan.steps])
    means = tel.mean(axis=0)
    log("  9b per-layer means over the steps (" + ", ".join(telemetry.TELEMETRY_FIELDS) + "):")
    for i, row in enumerate(means):
        log(f"    layer {i:2d}: " + " ".join(f"{v:.6g}" for v in row))
    ok_age = np.array_equal(tel[..., telemetry.AGE], age)
    ok_err = bool((tel[..., telemetry.CODEC_ERR][~coded] == 0).all()
                  and (tel[..., telemetry.CODEC_ERR][coded] > 0).all())
    log(f"  9b age = the plan's staleness on every step and layer (0 on sync "
        f"layers and warm-up steps, {int(age.max())} on stale layers): {ok_age}; "
        f"codec error 0 on every lossless step and > 0 on every coded one: {ok_err}")
    if not (ok_age and ok_err):
        raise AssertionError("9b: telemetry disagrees with the plan")


def phase_topk(server, reqs):
    """9c: dice + topk_residual at XL width."""
    from repro_torch.compress.codecs import CodecSpec, CompressConfig
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import DiceServer
    cfg = server.cfg
    dcfg = DiceConfig.dice(compress=CompressConfig("topk_residual", topk_frac=0.125))
    topk = DiceServer(cfg, dcfg, params=server.params, device="cuda")
    samples, stats = _generate_checked(topk, reqs, 4, "9c dice+topk_residual XL")
    spec = CodecSpec("topk_residual", topk_frac=0.125)
    tokens = len(reqs) * cfg.patch_tokens
    want = [sum(a.dispatch_bytes(tokens, cfg) for a in p.actions)
            for p in topk.plan(4).steps]
    got = stats["dispatch_bytes_per_step"]
    log(f"  9c kept {spec.keep_count(cfg.d_model)} of {cfg.d_model} entries a row, "
        f"{spec.wire_bytes_per_row(cfg.d_model)} B a row on the wire; dispatch "
        f"bytes per step {got}, planned {want}")
    if spec.wire_bytes_per_row(cfg.d_model) != 144 * 8 or [float(w) for w in want] != got:
        raise AssertionError("9c: dispatch bytes differ from the plan")


def phase_resilience(server, reqs, phase5):
    """9d: guards, seeded corruption, quarantine, codec demotion."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import DiceServer, Request, serve_continuous
    from repro_torch.obs import ObsConfig
    from repro_torch.resilience.faults import parse_resilience
    cfg = server.cfg

    def resilient(spec, **kw):
        return DiceServer(cfg, server.dcfg, params=server.params, device="cuda",
                          resilience=parse_resilience(spec), **kw)

    samples, _ = _generate_checked(resilient("guards=1"), reqs, XL_STEPS,
                                   "9d guards on, faults off")
    same = torch.equal(samples.cpu(), phase5[0])
    log(f"  9d guards on, faults off vs phase 5: "
        f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("9d: guards changed clean samples")
    samples, stats = _generate_checked(
        resilient("seed=7,corrupt=0.01,corrupt_dispatch=0.01"), reqs, 4,
        "9d corrupt=0.01, corrupt_dispatch=0.01, guards on")
    log(f"  9d fault events {stats['fault_events']}")
    if stats["fault_events"]["corrupt_combine"] <= 0 or \
            stats["fault_events"]["guarded_dispatch"] <= 0:
        raise AssertionError("9d: the corruption hit nothing")

    # phase 7b's mix under dice, rid 0 (slot 0) poisoned at tick 2 and
    # replayed in slot 0 from tick 4.  Slot 0's tokens lead every expert's
    # queue, so no capacity drop reaches them, and without a codec a slot's
    # sample does not depend on which of its ticks were slotted: the replay
    # must equal rid 0 in a clean fixed batch bit for bit.  (With the int8
    # codec a light step that meets another slot's warm-up runs the
    # lossless merge plan, so a replay on another schedule differs.)
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import request_noise
    reqs7 = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
             for i in range(CONT_REQUESTS)]
    arrivals = [float(CONT_EVERY * (i // 4)) for i in range(CONT_REQUESTS)]
    dice = DiceServer(cfg, DiceConfig.dice(), params=server.params, device="cuda",
                      resilience=parse_resilience("seed=1,poison_tick=2"))
    ops.reset_launches()
    out, st = serve_continuous(dice, reqs7, max_batch=CONT_SLOTS,
                               num_steps=XL_STEPS, seed=0, arrival_steps=arrivals)
    counts = dict(ops.LAUNCHES)
    want = planned_launches(st["tick_plans"], passes=2)
    clean = DiceServer(cfg, DiceConfig.dice(), params=server.params, device="cuda")
    noise = torch.stack([request_noise(0, r.rid, cfg, "cuda") for r in reqs7[:8]])
    ref, _ = clean.generate(reqs7[:8], num_steps=XL_STEPS, noise=noise)
    diff = float((out[0] - ref[0].cpu()).abs().max())
    log(f"  9d poison_tick=2 on phase 7b's mix (dice): quarantined {st['quarantined']}, "
        f"requeued {st['requeued']}, shed {st['shed']}, served {len(out)}, ticks "
        f"{st['ticks']}, {st['wall_s_per_tick']:.4f} s/tick; replayed rid 0 vs rid 0 in a "
        f"clean fixed batch: max abs diff {diff:.3e} "
        f"({'bit-identical' if diff == 0 else 'DIFFERENT'}); launches {counts}, "
        f"planned {want}")
    if (st["quarantined"], st["requeued"]) != (1, 1) or sorted(out) != list(
            range(CONT_REQUESTS)) or diff != 0 or counts != want:
        raise AssertionError("9d: quarantine and replay went wrong")

    # codec-error limit below any light step's error: demoted at a plan
    # boundary, the rebuilt plans' launches
    ops.reset_launches()
    out, st = serve_continuous(
        resilient("codec_err_limit=1e-12,demote_after=1",
                  obs=ObsConfig(enabled=True)),
        reqs, max_batch=CONT_SLOTS, num_steps=6, seed=0)
    counts = dict(ops.LAUNCHES)
    plans = st["tick_plans"]
    want = planned_launches(plans, passes=2)
    first = next(i for i, p in enumerate(plans) if any(a.codec for a in p.actions))
    expect = first + 1 + (-(first + 1)) % st["steady_period"]
    ticks = [t for t, _ in st["demotion_ticks"]]
    after = all(a.codec is None for p in plans[expect:] for a in p.actions)
    log(f"  9d codec_err_limit=1e-12: demotions {st['demotion_ticks']} (first coded "
        f"tick {first}, expected at {expect}); coded plans after it: {not after}; "
        f"launches {counts}, planned {want}")
    if st["demotions"] != ["codec"] or ticks != [expect] or not after or \
            counts != want or sorted(out) != [r.rid for r in reqs]:
        raise AssertionError("9d: the codec demotion went wrong")


def phase_main5(phase5):
    import torch
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import Request
    server = _xl_server(DiceConfig.dice(compress=CompressConfig("int8_residual")))
    reqs = [Request(class_id=(37 * i) % server.cfg.num_classes, rid=i)
            for i in range(XL_REQUESTS)]
    phase_checkpoint(server.cfg, server.params, reqs)
    phase_telemetry(server, reqs, phase5)
    phase_topk(server, reqs)
    phase_resilience(server, reqs, phase5)
    del server
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: expert parallelism (each function below named _ep_* runs in the
# spawned ranks: spawn imports this script again as a module, so they live
# at its top level)
# ---------------------------------------------------------------------------
def _tiny4(num_experts: int = 8):
    """Phase 7a's 4-layer DiT (capacity_factor 8.0, so no dispatch
    overflows) from seed 99 on the CPU, its 8 requests and their noise."""
    import torch
    from repro_torch.configs.dit_moe_xl import tiny
    from repro_torch.launch.serve import Request, request_noise
    from repro_torch.models.dit_moe import init_dit
    cfg = tiny().replace(num_layers=4, d_model=64, moe_d_ff=64, d_ff=256,
                         patch_tokens=16, capacity_factor=8.0,
                         num_experts=num_experts)
    gen = torch.Generator(device="cpu").manual_seed(99)
    params = _perturb(init_dit(cfg, generator=gen), gen)
    reqs = [Request(class_id=(3 * i) % cfg.num_classes, rid=i) for i in range(8)]
    noise = torch.stack([request_noise(42, r.rid, cfg) for r in reqs])
    return cfg, params, reqs, noise


def _tiny_schedules():
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.core.schedules import DiceConfig, Schedule
    return {"sync": DiceConfig.sync_ep(), "displaced": DiceConfig.displaced(),
            "interweaved": DiceConfig.interweaved(),
            "selective": DiceConfig(schedule=Schedule.DICE, sync_policy="deep",
                                    cond_comm=False),
            "dice": DiceConfig.dice(),
            "dice+int8": DiceConfig.dice(compress=CompressConfig("int8_residual")),
            "staggered_batch": DiceConfig.staggered_batch()}


def _every_rank(value):
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _ep_generate(server, reqs, steps, label, **kw):
    """One ``generate`` over the mesh with this rank's launch counts set to
    0 before and held to its plan after; returns (samples, summary,
    counts)."""
    import torch
    from repro_torch.kernels import ops
    ranks = server.mesh.size
    ops.reset_launches()
    x, st = server.generate(reqs, num_steps=steps, **kw)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = planned_launches(server.plan(steps).steps, passes=2, ranks=ranks)
    needed = ["expert_ffn", "flash_attention"] + ["residual_int8"] * (
        server.dcfg.compress is not None)
    if counts != want or min(counts[k] for k in needed) <= 0:
        raise AssertionError(f"8 {label} rank {server.mesh.rank}: launches "
                             f"{counts} differ from the plan's {want}")
    return x, st, counts


def _ep_tiny_runs(mesh, runs, steps):
    """8a/8b in each rank: the 4-layer DiT over the mesh for each
    (label, DiceConfig); returns {label: (samples, wall s/step, counts of
    every rank)}."""
    import torch
    from repro_torch.launch.serve import DiceServer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, reqs, noise = _tiny4()
    out = {}
    for label, dcfg in runs:
        server = DiceServer(cfg, dcfg, params=params, mesh=mesh)
        x, st, counts = _ep_generate(server, reqs, steps, label, noise=noise)
        out[label] = (x, st["wall_s_per_step"], _every_rank(counts))
    return out


def _ep_xl(mesh, tiny_runs):
    """8b then 8c in each rank of the ep=2 gloo mesh."""
    import torch
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.configs.dit_moe_xl import config
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import DiceServer, Request, serve_continuous
    tiny = _ep_tiny_runs(mesh, tiny_runs, TINY_STEPS)
    t0 = time.perf_counter()
    server = DiceServer(config(), DiceConfig.dice(compress=CompressConfig("int8_residual")),
                        mesh=mesh, seed=0)
    _perturb(server.params, torch.Generator(device=mesh.device).manual_seed(99))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = server.cfg
    reqs = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
            for i in range(XL_REQUESTS)]
    server.generate(reqs, num_steps=1)             # warm-up: cuBLAS, allocator
    wire_ms = _every_rank(_ep_wire_ms(mesh, cfg, XL_REQUESTS // mesh.size))
    runs = {}
    for engine in ("blocking", "ring"):
        srv = server if engine == "blocking" else DiceServer(
            cfg, dataclasses.replace(server.dcfg, overlap="ring"),
            params=server.params, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        x, st, counts = _ep_generate(srv, reqs, XL_STEPS, f"XL {engine}")
        runs[engine] = dict(
            s_per_step=st["wall_s_per_step"], dispatch=st["dispatch_bytes_per_step"],
            hops=st["ring_hops"], hop_bytes=st["hop_bytes_total"],
            finite=bool(torch.isfinite(x).all()), shape=tuple(x.shape),
            std=float(x.std()), counts=_every_rank(counts),
            peak_gib=_every_rank(torch.cuda.max_memory_allocated() / 2**30),
            backend=st["backend"], ep=st["ep"])
    reqs = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
            for i in range(CONT_REQUESTS)]
    arrivals = [float(CONT_EVERY * (i // 4)) for i in range(CONT_REQUESTS)]
    splan = server.plan(XL_STEPS)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, st = serve_continuous(server, reqs, max_batch=CONT_SLOTS,
                               num_steps=XL_STEPS, seed=0, arrival_steps=arrivals)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = planned_launches([splan.variants[v] for v, _ in st["tick_variants"]],
                            passes=2, ranks=mesh.size)
    if counts != want or min(counts[k] for k in DIT_KERNELS) <= 0:
        raise AssertionError(f"8c continuous rank {mesh.rank}: launches {counts} "
                             f"differ from the ticks' plans {want}")
    bad = [r for r, x in out.items() if tuple(x.shape) != (cfg.patch_tokens, cfg.in_channels)
           or not bool(torch.isfinite(x).all())]
    if sorted(out) != list(range(CONT_REQUESTS)) or bad:
        raise AssertionError("8c continuous: samples missing, misshapen or not finite")
    cont = {k: st[k] for k in ("ticks", "makespan_steps", "slotted_ticks", "admissions",
                               "recycled_admissions", "slot_occupancy", "wall_s",
                               "wall_s_per_tick", "e2e_s", "step_keys",
                               "num_plan_variants", "backend", "ep")}
    cont.update(counts=_every_rank(counts),
                peak_gib=_every_rank(torch.cuda.max_memory_allocated() / 2**30))
    return dict(tiny=tiny, init_s=_every_rank(init_s), wire_ms=wire_ms, runs=runs,
                continuous=cont)


def _ep_wire_ms(mesh, cfg, requests):
    """The wire alone: ms of one blocking all-to-all of the rank's f32
    (E, C, d) dispatch buffer at the refresh capacity of ``requests`` a
    rank, mean of 10 after 2 warm-ups."""
    import torch
    from repro_torch.core.moe import default_capacity
    C = default_capacity(requests * cfg.patch_tokens, cfg)
    buf = torch.randn((mesh.size, cfg.num_experts // mesh.size, C, cfg.d_model),
                      device=mesh.device)
    for _ in range(2):
        mesh.all_to_all(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        mesh.all_to_all(buf)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 10 * 1e3, tuple(buf.shape)


def phase_ep(rows):
    """8: expert parallelism on the one card (see the module docstring)."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import DiceServer
    torch.cuda.empty_cache()
    cfg, params, reqs, noise = _tiny4()
    schedules = _tiny_schedules()
    params = _to(params, "cuda")
    single = {}
    for label, dcfg in schedules.items():
        server = DiceServer(cfg, dcfg, params=params, device="cuda")
        single[label], _ = server.generate(reqs, num_steps=TINY_STEPS, noise=noise)
        single[label] = single[label].cpu()

    # (a) ep = 1 over NCCL: the mesh path's exchanges on one rank
    t0 = time.perf_counter()
    got, counts = mesh_lib.spawn(_ep_tiny_runs, 1, backend="nccl",
                                 timeout_s=EP_TIMEOUT_S,
                                 args=([("dice+int8", schedules["dice+int8"])],
                                       TINY_STEPS))
    x, _, rank_counts = got["dice+int8"]
    diff = float((x - single["dice+int8"]).abs().max())
    log(f"  8a ep=1 over nccl, 4-layer DiT dice+int8 {TINY_STEPS} steps: vs the "
        f"mesh-less card run max abs diff {diff:.3e} "
        f"({'bit-identical' if torch.equal(x, single['dice+int8']) else 'NOT bit-identical'}); "
        f"launches {rank_counts[0]}; {time.perf_counter() - t0:.1f} s with the spawn")
    if not torch.equal(x, single["dice+int8"]):
        raise AssertionError("8a: ep=1 over nccl differs from the mesh-less run")

    # (b) and (c): ep = 2 sharing the card over gloo, in one spawn
    t0 = time.perf_counter()
    tiny_runs = [(f"{label} {engine}", dataclasses.replace(dcfg, overlap=engine))
                 for label, dcfg in schedules.items() for engine in ("blocking", "ring")]
    res, totals = mesh_lib.spawn(_ep_xl, EP, backend="gloo", device="cuda",
                                 timeout_s=EP_TIMEOUT_S, args=(tiny_runs,))
    spawn_s = time.perf_counter() - t0
    for (label, dcfg), engine in itertools.product(schedules.items(), ("blocking", "ring")):
        x, s_step, rank_counts = res["tiny"][f"{label} {engine}"]
        compare(f"8b ep=2 gloo {label} {engine}, vs the single-process card run",
                x, single[label], TOL_F32)
        log(f"    launches per rank {rank_counts}; {s_step:.4f} s/step")
    (_, wire_shape) = res["wire_ms"][0]
    log(f"  8c wire: one gloo all_to_all_single of a rank's {wire_shape} f32 dispatch "
        f"buffer ({math.prod(wire_shape) * 4} B), ranks sharing one card: "
        f"{[round(ms, 4) for ms, _ in res['wire_ms']]} ms per rank")
    runs = res["runs"]
    for engine, r in runs.items():
        db = r["dispatch"]
        refresh = [db[i] for i in range(XL_STEPS) if i >= 2 and i % 2 == 0]
        light = [db[i] for i in range(XL_STEPS) if i >= 2 and i % 2 == 1]
        log(f"  8c XL ep=2 {r['backend']} (ranks sharing one card, host-staged wire), "
            f"dice+int8 {engine}, {XL_REQUESTS} requests ({XL_REQUESTS // EP} a rank) x "
            f"{XL_STEPS} steps: {r['s_per_step']:.4f} s/step, per-rank dispatch bytes "
            f"by step {[int(b) for b in db]} (refresh {refresh[0]:.0f} > light "
            f"{light[0]:.0f}: {max(light) < min(refresh)}), ring hops per layer "
            f"{r['hops']}, hop bytes {r['hop_bytes']:.0f}, peak memory per rank "
            f"{[round(g, 3) for g in r['peak_gib']]} GiB, finite {r['finite']}, "
            f"shape {r['shape']}, std {r['std']:.6f}; launches per rank {r['counts']}")
        if not (r["finite"] and r["shape"] == (XL_REQUESTS, 256, 16)
                and max(light) < min(refresh)):
            raise AssertionError(f"8c {engine}: samples or bytes are wrong")
        if r["hops"] != (2 * (EP - 1) if engine == "ring" else 0):
            raise AssertionError(f"8c {engine}: {r['hops']} ring hops per layer")
    c = res["continuous"]
    log(f"  8c XL ep=2 {c['backend']} serve_continuous (ranks sharing one card, "
        f"host-staged wire): {CONT_REQUESTS} requests, {CONT_SLOTS} slots "
        f"({CONT_SLOTS // EP} a rank): ticks {c['ticks']}, makespan "
        f"{c['makespan_steps']}, slotted {c['slotted_ticks']}, admissions "
        f"{c['admissions']} (recycled {c['recycled_admissions']}), wall "
        f"{c['wall_s']:.4f} s ({c['wall_s_per_tick']:.4f} s/tick, "
        f"{CONT_REQUESTS / c['wall_s']:.4f} requests/s), e2e p50 {c['e2e_s']['p50']:.4f} s "
        f"p95 {c['e2e_s']['p95']:.4f} s, step keys {c['step_keys']} of "
        f"{c['num_plan_variants']} variants, peak memory per rank "
        f"{[round(g, 3) for g in c['peak_gib']]} GiB, launches per rank {c['counts']} "
        f"(held to the ticks' plans in each rank)")
    if c["step_keys"] != c["num_plan_variants"]:
        raise AssertionError("8c continuous: step keys differ from the plan variants")
    log(f"  8c XL init per rank {[round(t, 3) for t in res['init_s']]} s; launch "
        f"totals per rank over 8b and 8c {totals}; the ep=2 spawn took {spawn_s:.1f} s. "
        f"These numbers are ep=2 sharing one card over a host-staged wire, not the "
        f"paper's speed-up.")
    blocking = runs["blocking"]["counts"]
    for name in DIT_KERNELS:
        rows[name]["launches_ep2_per_rank"] = [c[name] for c in blocking]
    rows["expert_ffn ep2 rank"]["launches"] = blocking[0]["expert_ffn"]
    rows["expert_ffn ep2 rank"]["launches_ep2_per_rank"] = [
        c["expert_ffn"] for c in blocking]


# ---------------------------------------------------------------------------
# phase 10: DistriFusion, the hierarchical mesh and expert placement (the
# functions named _hier_* and _place_* run in spawned ranks, so they live
# at the top level)
# ---------------------------------------------------------------------------
def _tf32_off():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sample(params, cfg, dcfg, noise, classes, steps, **kw):
    """``rf_sample`` with the launch counts set to 0 just before it; returns
    (samples, stats, counts, wall s/step between synchronisations)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sampling.rectified_flow import rf_sample
    on_card = noise.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    x, st = rf_sample(params, cfg, dcfg, num_steps=steps, classes=classes,
                      noise=noise, **kw)
    if on_card:
        torch.cuda.synchronize()
    return x, st, dict(ops.LAUNCHES), (time.perf_counter() - t0) / steps


def _check_launches(label, counts, want, coded: bool):
    needed = DIT_KERNELS if coded else DIT_KERNELS[:2]
    if counts != want or min(counts[k] for k in needed) <= 0:
        raise AssertionError(f"{label}: launches {counts} differ from the plan's {want}")


def _patch_runs():
    """10a's runs: (label, DiceConfig, patch_parallel_ndev, patch_compose)."""
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.core.schedules import DiceConfig
    int8 = CompressConfig("int8_residual")
    return [("distrifusion n_dev=2 sync", DiceConfig.sync_ep(), 2, False),
            ("distrifusion n_dev=4 sync", DiceConfig.sync_ep(), 4, False),
            ("patch_compose n_dev=2 dice+int8", DiceConfig.dice(compress=int8), 2, True)]


def phase_patch_tiny():
    """10a: displaced patch attention in place, the 4-layer DiT on the CPU
    (plain versions) and on the card (kernels); returns the card's samples."""
    import torch
    from repro_torch.core import plan as plan_lib
    cfg, params, reqs, noise = _tiny4()
    classes = torch.tensor([r.class_id for r in reqs])
    p_gpu = _to(params, "cuda")
    out = {}
    for label, dcfg, n_dev, compose in _patch_runs():
        kw = dict(patch_parallel_ndev=n_dev, patch_compose=compose, guidance=1.5)
        x_cpu = _sample(params, cfg, dcfg, noise, classes, TINY_STEPS, **kw)[0]
        x, st, counts, _ = _sample(p_gpu, cfg, dcfg, noise.cuda(), classes.cuda(),
                                   TINY_STEPS, **kw)
        splan = plan_lib.compile_step_plans(dcfg, cfg.num_layers, TINY_STEPS,
                                            experts_per_token=cfg.experts_per_token)
        want = planned_launches(splan.steps, passes=2, patch_ndev=n_dev)
        compare(f"10a tiny {label}, cuda kernels vs cpu plain", x.cpu(), x_cpu, TOL_F32)
        log(f"    launches {counts}, planned {want}; buffer_bytes {st['buffer_bytes'][-1]:.0f}")
        _check_launches(f"10a {label}", counts, want, dcfg.compress is not None)
        out[label] = x.cpu()
    return out


def _owner_flash_row():
    """``flash_attention`` at a DistriFusion owner's shape (n_dev = 8: 32
    of 256 queries, a strided view, the output written into a view of the
    whole) against its plain version; times and the table row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.timing import device_ms, time_ms
    gen = torch.Generator(device="cuda").manual_seed(13)
    B, S, H, Dh, Sq = 8, 256, 16, 72, 32
    q, k, v = (torch.randn((B, S, H, Dh), generator=gen, device="cuda")
               for _ in range(3))
    qo, out = q[:, :Sq], torch.empty_like(q)
    got = ops.flash_attention(qo, k, v, out=out[:, :Sq])
    err = compare("10b flash at a DistriFusion owner's shape (Sq=32 of S=256, strided q, "
                  "written into a view)", got, ref.flash_attention_ref(qo, k, v), TOL_F32)
    ms = time_ms(lambda: ops.flash_attention(qo, k, v, out=out[:, :Sq]), 50)
    dev = device_ms(lambda: ops.flash_attention(qo, k, v, out=out[:, :Sq]), 50)
    plain = time_ms(lambda: ref.flash_attention_ref(qo, k, v), 50)
    qt, kt, vt = (a.transpose(1, 2) for a in (qo, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 50)
    flops = 4.0 * B * H * Sq * S * Dh
    nbytes = 4.0 * (2 * B * Sq * H * Dh + 2 * B * S * H * Dh)
    b_ms, _ = bound(flops, nbytes)
    tc_ms, tc_by = bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
    log(f"  10b flash at the owner's shape: kernel {ms:.4f} ms (device alone {dev:.4f} ms), "
        f"plain {plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, bound "
        f"{tc_ms:.4f} ms ({tc_by}, 3xTF32)")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:70", max_abs_err=err,
                ms=ms, device_ms=dev, events_ms=ms, plain_ms=plain, bound_ms=tc_ms,
                bound_by=tc_by, fp32_bound_ms=b_ms, library_ms=lib,
                shape="B=8 Sq=32 Sk=256 H=16 Dh=72 f32 (a DistriFusion owner at n_dev=8)")


def phase_distrifusion(rows, phase5):
    """10b: DistriFusion at full XL depth and width (phase 5's weights, 8
    requests, f32) beside sync in the same call, then the composed run."""
    import torch
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.schedules import DiceConfig
    owner = _owner_flash_row()
    server = _xl_server(DiceConfig.sync_ep())
    cfg = server.cfg
    noise = torch.randn((XL_REQUESTS, cfg.patch_tokens, cfg.in_channels),
                        generator=torch.Generator(device="cuda").manual_seed(11),
                        device="cuda")
    classes = torch.tensor([(37 * i) % cfg.num_classes for i in range(XL_REQUESTS)],
                           device="cuda")
    int8 = CompressConfig("int8_residual")
    runs = [("sync", DiceConfig.sync_ep(), XL_STEPS, {}),
            ("distrifusion n_dev=8 sync", DiceConfig.sync_ep(), XL_STEPS,
             dict(patch_parallel_ndev=8)),
            ("patch_compose n_dev=2 dice+int8", DiceConfig.dice(compress=int8), 4,
             dict(patch_parallel_ndev=2, patch_compose=True))]
    _sample(server.params, cfg, DiceConfig.sync_ep(), noise, classes, 1,
            patch_parallel_ndev=8)                         # warm-up
    out = {}
    for label, dcfg, steps, kw in runs:
        torch.cuda.reset_peak_memory_stats()
        x, st, counts, s_step = _sample(server.params, cfg, dcfg, noise, classes,
                                        steps, **kw)
        peak = torch.cuda.max_memory_allocated() / 2**30
        splan = plan_lib.compile_step_plans(dcfg, cfg.num_layers, steps,
                                            experts_per_token=cfg.experts_per_token)
        want = planned_launches(splan.steps, passes=2,
                                patch_ndev=kw.get("patch_parallel_ndev", 0))
        finite = bool(torch.isfinite(x).all())
        log(f"  10b XL {label}, {XL_REQUESTS} requests x {steps} steps: {s_step:.4f} "
            f"s/step, buffer_bytes {st['buffer_bytes'][-1]:.0f}, peak memory "
            f"{peak:.3f} GiB, finite {finite}, std {float(x.std()):.6f}, launches "
            f"{counts} ({counts['flash_attention'] // steps} flash a step), planned {want}")
        if not finite or tuple(x.shape) != (XL_REQUESTS, cfg.patch_tokens, cfg.in_channels):
            raise AssertionError(f"10b {label}: samples not finite or misshapen")
        _check_launches(f"10b {label}", counts, want, dcfg.compress is not None)
        out[label] = (s_step, st["buffer_bytes"][-1], peak, counts)
    df = out["distrifusion n_dev=8 sync"]
    if df[3]["flash_attention"] != cfg.num_layers * 8 * 2 * XL_STEPS:
        raise AssertionError("10b: flash launches are not layers x 8 x 2 passes x steps")
    log(f"  10b s/step in this call: distrifusion {df[0]:.4f}, sync {out['sync'][0]:.4f} "
        f"({(df[0] / out['sync'][0] - 1) * 100:+.2f}%); phase 5 dice+int8 {phase5[1]:.4f}. "
        f"Stale K/V footprint (DistriFusion) {df[1] / 1e9:.4f} GB; composed dice+int8 "
        f"(DICE's caches + K/V) {out['patch_compose n_dev=2 dice+int8'][1] / 1e9:.4f} GB")
    for name in DIT_KERNELS[:2]:
        rows[name]["launches_distrifusion"] = df[3][name]
    rows["flash_attention distrifusion owner"] = dict(
        owner, launches=df[3]["flash_attention"])
    del server
    torch.cuda.empty_cache()


def _mesh_generate(server, reqs, steps, label, **kw):
    """One ``generate`` over the server's mesh with this rank's launch
    counts set to 0 before and held to its plan after."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    x, st = server.generate(reqs, num_steps=steps, **kw)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = planned_launches(server.plan(steps).steps, passes=2, ranks=server.n_ep)
    _check_launches(f"{label} rank {server.mesh.rank}", counts, want,
                    server.dcfg.compress is not None)
    return x, st, counts


def _hier_tiny(mesh, runs):
    """The 4-layer DiT over ``mesh`` for each (label, DiceConfig) at
    guidance 1.5; returns {label: (samples, s/step, counts of every rank)}."""
    from repro_torch.launch.serve import DiceServer
    cfg, params, reqs, noise = _tiny4()
    out = {}
    for label, dcfg in runs:
        server = DiceServer(cfg, dcfg, params=params, mesh=mesh)
        x, st, counts = _mesh_generate(server, reqs, TINY_STEPS, f"10c {label}",
                                       noise=noise, guidance=1.5)
        out[label] = (x, st["wall_s_per_step"], _every_rank(counts))
    return out


def _hier_xl(mesh):
    """XL width at MESH_XL_LAYERS layers, dice + int8, 8 requests x 4 steps
    over ``mesh``; the rank's numbers gathered from every rank."""
    import torch
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.configs.dit_moe_xl import config
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch.serve import DiceServer, Request
    cfg = config().replace(num_layers=MESH_XL_LAYERS)
    t0 = time.perf_counter()
    server = DiceServer(cfg, DiceConfig.dice(compress=CompressConfig("int8_residual")),
                        mesh=mesh, seed=0)
    _perturb(server.params, torch.Generator(device=mesh.device).manual_seed(99))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
            for i in range(XL_REQUESTS)]
    server.generate(reqs, num_steps=1)                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    x, st, counts = _mesh_generate(server, reqs, 4, f"10c XL {mesh.shape}")
    patch = mesh.shape.get("patch", 1)
    # one all-gather of (B_loc, T_loc, 2, KVH, Dh) f32 a layer and pass
    gather = (cfg.num_layers * 2 * (XL_REQUESTS // mesh.lanes) * cfg.patch_tokens * 2
              * cfg.num_kv_heads * cfg.head_dim * 4) if patch > 1 else 0
    res = dict(shape=dict(mesh.shape), backend=st["backend"],
               s_per_step=_every_rank(st["wall_s_per_step"]),
               dispatch=st["dispatch_bytes_per_step"], gather_bytes=gather,
               buffer_bytes=st["buffer_bytes"], init_s=_every_rank(init_s),
               peak_gib=_every_rank(torch.cuda.max_memory_allocated() / 2**30),
               counts=_every_rank(counts), finite=bool(torch.isfinite(x).all()),
               out_shape=tuple(x.shape))
    del server
    torch.cuda.empty_cache()
    return res


def _hier_job(mesh, runs_dp_ep, runs_patch):
    """10c in each of 4 ranks: the 4-layer DiT over ep2 x dp2 (this spawn's
    mesh) and over ep2 x patch2 (built here on the same 4 ranks), then XL
    width over both."""
    from repro_torch.launch import mesh as mesh_lib
    _tf32_off()
    patch_mesh = mesh_lib.make_mesh(ep=2, patch=2, backend="gloo", device="cuda")
    tiny = {"ep2xdp2": _hier_tiny(mesh, runs_dp_ep),
            "ep2xpatch2": _hier_tiny(patch_mesh, runs_patch)}
    return tiny, [_hier_xl(mesh), _hier_xl(patch_mesh)]


def _hier8_job(mesh, runs_patch):
    """10c in each of 8 ranks: the 4-layer DiT over ep2 x dp2 x patch2."""
    _tf32_off()
    return _hier_tiny(mesh, runs_patch)


def phase_hier(rows, patch_single):
    """10c: the hierarchical mesh on the one card, gloo ranks sharing it."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import DiceServer
    gen = torch.Generator(device="cuda").manual_seed(14)
    q = torch.randn((4, 128, 16, 72), generator=gen, device="cuda")
    k, v = (torch.randn((4, 256, 16, 72), generator=gen, device="cuda") for _ in range(2))
    compare("10c flash at an ep2 x patch2 rank's XL shape (T_loc=128 queries, 256 keys)",
            ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v), TOL_F32)
    cfg, params, reqs, noise = _tiny4()
    schedules = {k: v for k, v in _tiny_schedules().items()
                 if k in ("sync", "displaced", "interweaved", "selective", "dice")}
    p_gpu = _to(params, "cuda")
    single = {}
    for label, dcfg in schedules.items():
        server = DiceServer(cfg, dcfg, params=p_gpu, device="cuda")
        single[label] = server.generate(reqs, num_steps=TINY_STEPS, noise=noise,
                                        guidance=1.5)[0].cpu()
    runs_dp_ep = [(f"{label} {engine}", dataclasses.replace(dcfg, overlap=engine))
                  for label, dcfg in schedules.items() for engine in ("blocking", "ring")]
    compose_label, compose_dcfg, _, _ = _patch_runs()[2]
    runs_patch = [("dice+int8", compose_dcfg)]
    t0 = time.perf_counter()
    (tiny, xl), totals = mesh_lib.spawn(_hier_job, 4, dp=2, backend="gloo",
                                        device="cuda", timeout_s=EP_TIMEOUT_S,
                                        args=(runs_dp_ep, runs_patch))
    spawn4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiny8, _ = mesh_lib.spawn(_hier8_job, 8, dp=2, patch=2, backend="gloo",
                              device="cuda", timeout_s=EP_TIMEOUT_S, args=(runs_patch,))
    spawn8 = time.perf_counter() - t0
    for label in schedules:
        for engine in ("blocking", "ring"):
            x, s_step, counts = tiny["ep2xdp2"][f"{label} {engine}"]
            compare(f"10c ep2xdp2 gloo tiny {label} {engine}, vs the single-process "
                    f"card run", x, single[label], TOL_F32)
            log(f"    launches per rank {counts}; {s_step:.4f} s/step")
    for shape, res in (("ep2xpatch2", tiny["ep2xpatch2"]), ("ep2xdp2xpatch2", tiny8)):
        x, s_step, counts = res["dice+int8"]
        compare(f"10c {shape} gloo tiny dice+int8, vs the single-process "
                f"patch_compose card run", x, patch_single[compose_label], TOL_F32)
        log(f"    launches per rank {counts}; {s_step:.4f} s/step")
    for r in xl:
        log(f"  10c XL width ({MESH_XL_LAYERS} of 28 layers) {r['shape']} {r['backend']} "
            f"(4 ranks sharing one card, host-staged wire), dice+int8, {XL_REQUESTS} "
            f"requests x 4 steps: s/step per rank {[round(s, 4) for s in r['s_per_step']]}, "
            f"per-rank dispatch bytes by step {[int(b) for b in r['dispatch']]}, patch "
            f"all-gather bytes a step per rank (from the shapes) {r['gather_bytes']}, "
            f"buffer_bytes {r['buffer_bytes']:.0f}, peak memory per rank "
            f"{[round(g, 3) for g in r['peak_gib']]} GiB, init per rank "
            f"{[round(t, 2) for t in r['init_s']]} s, finite {r['finite']}, shape "
            f"{r['out_shape']}; launches per rank {r['counts']}")
        if not r["finite"] or r["out_shape"] != (XL_REQUESTS, 256, 16):
            raise AssertionError(f"10c XL {r['shape']}: samples not finite or misshapen")
    log(f"  10c spawns: 4 ranks {spawn4:.1f} s (launch totals {totals}), 8 ranks "
        f"{spawn8:.1f} s.  Ranks time-slicing one card over a host-staged wire: not "
        f"a deployment's numbers.")
    for name in DIT_KERNELS:
        rows[name]["launches_hier_per_rank"] = [c[name] for c in xl[0]["counts"]]


def _place_job(mesh, bias):
    """10d in each of 2 ranks, XL width at MESH_XL_LAYERS layers with every
    router biased by ``bias``: sync over the identity layout, then over the
    greedy placement (one replicated expert) of the identity layout's
    served-pair histogram, at capacity_factor 8 so that neither layout
    drops a pair; then phase 7b's mix through serve_continuous with online
    greedy placement."""
    import torch
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.configs.dit_moe_xl import config
    from repro_torch.core import placement as placement_lib
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import DiceServer, Request, serve_continuous
    _tf32_off()
    cfg = config().replace(num_layers=MESH_XL_LAYERS, capacity_factor=8.0)
    server = DiceServer(cfg, DiceConfig.sync_ep(), mesh=mesh, seed=0)
    _perturb(server.params, torch.Generator(device=mesh.device).manual_seed(99))
    for blk in server.params["blocks"]:
        blk["moe"]["router_bias"] = torch.as_tensor(bias, device=mesh.device)
    reqs = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
            for i in range(PLACE_REQUESTS)]
    noise = torch.randn((PLACE_REQUESTS, cfg.patch_tokens, cfg.in_channels),
                        generator=torch.Generator(device="cuda").manual_seed(12),
                        device="cuda")
    server.generate(reqs, num_steps=1, noise=noise)        # warm-up
    x_id, st_id, c_id = _mesh_generate(server, reqs, 4, "10d identity", noise=noise)
    # the identity layout's served-pair histogram, as the online engine
    # accumulates it (a warm-up no drift check reaches)
    probe = DiceServer(cfg, DiceConfig.sync_ep(), params=server.params, mesh=mesh,
                       placement=placement_lib.PlacementConfig(
                           mode="greedy", warmup_ticks=10**6))
    shares = serve_continuous(probe, reqs, max_batch=PLACE_REQUESTS, num_steps=4,
                              seed=0)[1]["routing_shares"]
    placements = placement_lib.greedy_placements(shares, mesh.size, replicate_top=1)
    placed = DiceServer(cfg, dataclasses.replace(DiceConfig.sync_ep(),
                                                 placements=placements),
                        params=server.params, mesh=mesh)
    t0 = time.perf_counter()
    placed.generate(reqs, num_steps=1, noise=noise)        # re-lays-out, warms up
    relayout_s = time.perf_counter() - t0
    x_pl, st_pl, c_pl = _mesh_generate(placed, reqs, 4, "10d greedy", noise=noise)
    diff = (x_pl - x_id).abs()
    plan = placed.plan(4).steps[0]
    tokens = PLACE_REQUESTS // mesh.size * cfg.patch_tokens
    res = dict(shares=[[round(v, 4) for v in row] for row in shares],
               placements=[(p.perm, p.replicated, p.cap_scale) for p in placements],
               err=float(diff.max()),
               ok=bool((diff <= TOL_F32["atol"] + TOL_F32["rtol"] * x_id.abs()).all()),
               relayout_s=relayout_s, s_id=st_id["wall_s_per_step"],
               s_pl=st_pl["wall_s_per_step"], bytes_id=st_id["dispatch_bytes_per_step"],
               bytes_pl=st_pl["dispatch_bytes_per_step"],
               want_bytes=sum(a.dispatch_bytes(tokens, cfg) for a in plan.actions),
               counts_id=_every_rank(c_id), counts_pl=_every_rank(c_pl))
    del placed, probe
    torch.cuda.empty_cache()

    # phase 7b's mix with online greedy placement, at the config's capacity
    online = DiceServer(cfg.replace(capacity_factor=1.25),
                        DiceConfig.dice(compress=CompressConfig("int8_residual")),
                        params=server.params, mesh=mesh,
                        placement=placement_lib.PlacementConfig(mode="greedy",
                                                                replicate_top=1))
    reqs = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
            for i in range(CONT_REQUESTS)]
    arrivals = [float(CONT_EVERY * (i // 4)) for i in range(CONT_REQUESTS)]
    ops.reset_launches()
    out, st = serve_continuous(online, reqs, max_batch=CONT_SLOTS,
                               num_steps=XL_STEPS, seed=0, arrival_steps=arrivals)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    _check_launches(f"10d continuous rank {mesh.rank}", counts,
                    planned_launches(st["tick_plans"], passes=2, ranks=mesh.size),
                    True)
    if sorted(out) != list(range(CONT_REQUESTS)) or not all(
            bool(torch.isfinite(x).all()) for x in out.values()):
        raise AssertionError("10d continuous: samples missing or not finite")
    res["continuous"] = {k: st[k] for k in (
        "ticks", "wall_s", "wall_s_per_tick", "placement_reshards",
        "placement_wire_scale", "step_keys", "num_plan_variants", "hist_updates",
        "dispatch_bytes_total", "backend")}
    res["continuous"]["counts"] = _every_rank(counts)
    return res


def phase_placement(rows):
    """10d: expert placement at ep=2 over gloo (see _place_job)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as mesh_lib
    # the replica call's shape: one replicated expert, a buffer for every
    # pair of a rank's 2 requests (512 tokens x top-2)
    args = _expert_inputs(torch.Generator(device="cuda").manual_seed(15), 1, 1024,
                          1152, 4608, torch.float32)
    compare("10d expert_ffn at the replica call's shape (E=1 C=1024 d=1152 f=4608)",
            ops.expert_ffn(*args), ref.expert_ffn_ref(*args), TOL_F32)
    del args
    bias = np.zeros(8, np.float32)
    bias[5] = PLACE_BIAS
    t0 = time.perf_counter()
    res, totals = mesh_lib.spawn(_place_job, EP, backend="gloo", device="cuda",
                                 timeout_s=EP_TIMEOUT_S, args=(bias,))
    log(f"  10d XL width ({MESH_XL_LAYERS} of 28 layers, capacity_factor 8) ep=2 gloo, "
        f"routers biased +{PLACE_BIAS} toward expert 5: identity layout's shares by "
        f"layer {res['shares']}; greedy placements (perm, replicated, cap_scale) "
        f"{res['placements']}")
    log(f"  10d sync {PLACE_REQUESTS} requests x 4 steps: identity {res['s_id']:.4f} "
        f"s/step, greedy {res['s_pl']:.4f} s/step (re-layout and a 1-step warm-up "
        f"{res['relayout_s']:.2f} s); placed vs identity samples max abs diff "
        f"{res['err']:.3e} (tol rtol=1e-4 atol=1e-4) {'ok' if res['ok'] else 'FAIL'}; "
        f"per-rank dispatch bytes by step identity {[int(b) for b in res['bytes_id']]}, "
        f"greedy {[int(b) for b in res['bytes_pl']]} (planned {res['want_bytes']}); "
        f"launches per rank identity {res['counts_id']}, greedy {res['counts_pl']}")
    if not res["ok"]:
        raise AssertionError("10d: placed samples differ from the identity layout's")
    if res["bytes_pl"] != [float(res["want_bytes"])] * 4 or \
            not res["bytes_pl"][0] < res["bytes_id"][0]:
        raise AssertionError("10d: the placed wire bytes are not the plan's")
    replicas = sum(1 for _, rep, _ in res["placements"] if rep)
    if [c["expert_ffn"] for c in res["counts_pl"]] != [
            c["expert_ffn"] + 2 * 4 * replicas for c in res["counts_id"]]:
        raise AssertionError("10d: expert_ffn launches miss the replica calls")
    c = res["continuous"]
    log(f"  10d serve_continuous, phase 7b's mix ({CONT_REQUESTS} requests, "
        f"{CONT_SLOTS} slots, dice+int8, capacity_factor 1.25), --placement greedy "
        f"--replicate-top 1, {c['backend']}: re-shards {c['placement_reshards']}, "
        f"planned wire scale {c['placement_wire_scale']:.4f}, histogram updates "
        f"{c['hist_updates']}, step keys {c['step_keys']} of {c['num_plan_variants']} "
        f"plan variants, ticks {c['ticks']}, wall {c['wall_s']:.4f} s "
        f"({c['wall_s_per_tick']:.4f} s/tick, {CONT_REQUESTS / c['wall_s']:.4f} "
        f"requests/s); launches per rank {c['counts']} (held to the ticks' plans)")
    if c["placement_reshards"] < 1 or c["step_keys"] > c["num_plan_variants"]:
        raise AssertionError("10d continuous: no re-shard, or more step keys than "
                             "plan variants")
    log(f"  10d spawn {time.perf_counter() - t0:.1f} s, launch totals per rank {totals}")
    rows["expert_ffn"]["launches_placed_per_rank"] = [
        c["expert_ffn"] for c in res["counts_pl"]]


# ---------------------------------------------------------------------------
# phase 11: expert paging and DiT-MoE-G (the functions named _paged_* and
# _g_* run in spawned ranks, so they live at the top level)
# ---------------------------------------------------------------------------
G_LAYERS = MESH_XL_LAYERS                 # 11b: G width, depth cut (the time limit)
G_STEPS = 4
G_FAULTS = "seed=3,paging_err=0.3"
G_DELAY = "seed=3,paging_delay=0.5:0.01"
PAGING_STATS = ("paged_transfers", "paged_bytes_in", "peak_resident_expert_bytes",
                "expert_hbm_budget")


def _paged_tiny(mesh, runs):
    """11a in each of 4 ranks: the 4-layer DiT over the mesh for each
    (label, DiceConfig, expert count), resident (where the experts divide
    over the ranks) and paged at the auto budget; returns {(label, paged):
    (samples, paging stats, launch counts of every rank)}."""
    from repro_torch.core.paging import PagingSpec
    from repro_torch.launch.serve import DiceServer
    _tf32_off()
    out = {}
    for label, dcfg, num_experts in runs:
        cfg, params, reqs, noise = _tiny4(num_experts)
        for paged in (False, True) if num_experts % mesh.size == 0 else (True,):
            d = dataclasses.replace(dcfg, paging=PagingSpec(budget_bytes=0)) \
                if paged else dcfg
            server = DiceServer(cfg, d, params=params, mesh=mesh)
            x, st, counts = _mesh_generate(
                server, reqs, TINY_STEPS,
                f"11a {label} {'paged' if paged else 'resident'}", noise=noise)
            out[label, paged] = (x, {k: st[k] for k in PAGING_STATS if k in st},
                                 _every_rank(counts))
    return out


def phase_paged_tiny(smi):
    """11a: the 4-layer DiT paged over 4 gloo ranks sharing the card."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import DiceServer
    schedules = {k: v for k, v in _tiny_schedules().items()
                 if k in ("sync", "displaced", "interweaved", "selective", "dice")}
    runs = [(label, dcfg, 8) for label, dcfg in schedules.items()]
    runs.append(("dice E=6", schedules["dice"], 6))
    single = {}
    for label, dcfg, num_experts in runs:
        cfg, params, reqs, noise = _tiny4(num_experts)
        single[label] = DiceServer(cfg, dcfg, params=params, device="cpu").generate(
            reqs, num_steps=TINY_STEPS, noise=noise)[0]
    t0 = time.perf_counter()
    res, totals = mesh_lib.spawn(_paged_tiny, 4, backend="gloo", device="cuda",
                                 timeout_s=EP_TIMEOUT_S, args=(runs,))
    for label, _, num_experts in runs:
        x, st, counts = res[label, True]
        compare(f"11a [{smi}] paged ep=4 gloo tiny {label} (E={num_experts}, "
                f"E_pad 8), cuda kernels vs the cpu plain single-process run",
                x, single[label], TOL_F32)
        same = None
        if (label, False) in res:
            same = torch.equal(x, res[label, False][0])
        log(f"    paged stats {st}; paged == resident ep=4 bit for bit: {same}; "
            f"launches per rank {counts}")
        if same is False:
            raise AssertionError(f"11a {label}: paged samples differ from resident")
        if not (0 < st["peak_resident_expert_bytes"] <= st["expert_hbm_budget"]
                and st["paged_transfers"] > 0):
            raise AssertionError(f"11a {label}: the realized peak exceeds the budget")
    log(f"  11a spawn of 4 ranks {time.perf_counter() - t0:.1f} s, launch totals {totals}")


def _mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def _copy_overlap(server, reqs, noise):
    """One paged step traced with device activity: the pool's host-to-device
    copies (the stream that spent the most time on them) against this
    rank's kernels: copies, ms, GB, GB/s while copying, and the share of
    copy time during which one of the rank's kernels ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.generate(reqs, num_steps=1, noise=noise)
        torch.cuda.synchronize()
    cuda = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    streams = {}
    for e in cuda:
        if "HtoD" in e.name():
            streams.setdefault(e.device_resource_id(), []).append(e)
    if not streams:
        raise AssertionError("11b: the trace holds no host-to-device copy")
    copies = max(streams.values(), key=lambda es: sum(e.duration_ns() for e in es))
    spans = sorted((e.start_ns(), e.end_ns()) for e in cuda
                   if not e.name().startswith(("Memcpy", "Memset")))
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    copy_ns = sum(e.duration_ns() for e in copies)
    overlap_ns = sum(max(0, min(e.end_ns(), b) - max(e.start_ns(), a))
                     for e in copies for a, b in merged)
    # where the trace does not record the bytes, count them from the pool's
    # geometry: a fetch copies each of its 3 leaves in PACE_BYTES pieces
    from repro_torch.core.paging import PACE_BYTES
    shard = server.expert_pool.layer_shard_bytes(0)
    pieces = 3 * -(-(shard // 3) // PACE_BYTES)
    nbytes = sum(e.nbytes() for e in copies) or len(copies) // pieces * shard
    return dict(copies=len(copies), copy_ms=copy_ns / 1e6, gb=nbytes / 1e9,
                gbps=nbytes / max(copy_ns, 1), overlap=overlap_ns / max(copy_ns, 1),
                kernels=len(spans), other_htod=sum(len(v) for v in streams.values())
                - len(copies))


def _overlap_probe(shard_bytes: int, iters: int = 10, barrier=None):
    """Whether the card runs a host-to-device copy beside kernels: ms of
    one layer shard's worth (``shard_bytes``) copied from pinned memory on
    a side stream, of ``iters`` ``expert_ffn`` calls at a G ep=2 rank's
    refresh shape on the current stream, and of both issued together
    (wall time between synchronisations; with ``barrier``, every rank
    starts each measurement together); then whether a 16 MB copy issued
    just after the big one waits for it."""
    import torch
    from repro_torch.kernels import ops
    host = torch.empty(shard_bytes // 4, dtype=torch.float32, pin_memory=True)
    dev = torch.empty_like(host, device="cuda")
    args = _expert_inputs(torch.Generator(device="cuda").manual_seed(23), 8, 320,
                          1408, 5632, torch.float32)
    side = torch.cuda.Stream()

    def copy():
        with torch.cuda.stream(side):
            dev.copy_(host, non_blocking=True)

    def compute():
        for _ in range(iters):
            ops.expert_ffn(*args)

    def timed(*fns):
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    small = torch.empty(4 << 20, dtype=torch.float32, device="cuda")
    small_host = torch.empty(small.shape, dtype=torch.float32, pin_memory=True)

    def d2h_behind_copy():
        # a 16 MB device-to-host copy issued just after the big
        # host-to-device one, on the current stream: ms until it is done
        copy()
        t0 = time.perf_counter()
        small_host.copy_(small, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return (time.perf_counter() - t0) * 1e3

    def h2d_behind_copy():
        # the same for a 16 MB host-to-device copy (a gloo exchange's
        # received payload goes to the card this way)
        copy()
        t0 = time.perf_counter()
        small.copy_(small_host, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return (time.perf_counter() - t0) * 1e3

    def alone(dst, src):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed(copy, compute)                                # warm-up
    alone(small_host, small)
    return dict(copy_ms=timed(copy), compute_ms=timed(compute),
                both_ms=timed(copy, compute), d2h_ms=alone(small_host, small),
                d2h_behind_copy_ms=d2h_behind_copy(),
                h2d_ms=alone(small, small_host),
                h2d_behind_copy_ms=h2d_behind_copy())


def _g_job(mesh, model: str = "dit-moe-g", layers: int = G_LAYERS):
    """11b and 11c in each of 2 ranks sharing the card: DiT-MoE-G at full
    width, ``layers`` deep, paged (depth 1, auto budget) and resident."""
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.compress.codecs import CompressConfig
    from repro_torch.configs import get_config
    from repro_torch.core import paging
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.serve import DiceServer, Request
    from repro_torch.resilience.faults import FaultPlan, parse_resilience
    _tf32_off()
    cfg = get_config(model).replace(num_layers=layers)
    dcfg = DiceConfig.dice(compress=CompressConfig("int8_residual"))
    spec = paging.PagingSpec(budget_bytes=0, depth=1)
    reqs = [Request(class_id=(37 * i) % cfg.num_classes, rid=i)
            for i in range(XL_REQUESTS)]
    noise = torch.randn((XL_REQUESTS, cfg.patch_tokens, cfg.in_channels),
                        generator=torch.Generator(device=mesh.device).manual_seed(21),
                        device=mesh.device)
    res = {}

    def build(paged):
        t0 = time.perf_counter()
        server = DiceServer(cfg, dcfg, mesh=mesh, seed=0,
                            paging=spec if paged else None)
        _perturb(server.params, torch.Generator(device=mesh.device).manual_seed(99))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        ring = DiceServer(cfg, dataclasses.replace(server.dcfg, overlap="ring"),
                          params=server.params, mesh=mesh,
                          expert_pool=server.expert_pool)
        server.generate(reqs, num_steps=1, noise=noise)      # warm-up
        return server, ring, init_s

    def run(server, label, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        x, st, counts = _mesh_generate(server, reqs, G_STEPS, f"11b G {label}",
                                       noise=noise, **kw)
        return dict(x=x.cpu(), s_per_step=st["wall_s_per_step"],
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    counts=counts, dispatch=st["dispatch_bytes_per_step"],
                    hops=st["ring_hops"],
                    **{k: st[k] for k in PAGING_STATS if k in st})

    paged, paged_ring, res["init_paged_s"] = build(True)
    pool = paged.expert_pool
    if mesh.device.type == "cuda":
        # both ranks at once: a copy beside kernels on a card two
        # processes share
        res["probe"] = _overlap_probe(pool.layer_shard_bytes(0),
                                      barrier=torch.distributed.barrier)
    res["pinned_bytes"] = pool.total_host_bytes()
    res["budget"] = paging.paging_of(paged.dcfg).budget_bytes
    res["layer_shard_bytes"] = pool.layer_shard_bytes(0)
    res["mem_available_gib"] = _mem_available_gib()
    res["paged"] = run(paged, "paged blocking")
    res["paged ring"] = run(paged_ring, "paged ring")
    res["trace"] = _copy_overlap(paged, reqs, noise)
    # 11c: the paging rungs on the same pool, then the ring-lowering check
    for key, fspec in (("faults", G_FAULTS), ("delay", G_DELAY)):
        rcfg = parse_resilience(fspec)
        server = DiceServer(cfg, paged.dcfg, params=paged.params, mesh=mesh,
                            expert_pool=pool, resilience=rcfg)
        r = run(server, f"paged {fspec}")
        r.update(paging.ledger_totals(pool, mesh.ep_mesh),
                 equal=torch.equal(r.pop("x"), res["paged"]["x"]))
        if key == "delay":
            fp = FaultPlan(rcfg.faults)
            r["delays"] = sum(fp.paging_delay(layer, mesh.rank, s, 0)
                              for layer in range(cfg.num_layers)
                              for s in range(1, 2 * G_STEPS + 1))
        res[key] = r
    pool.set_resilience(None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        paged_ring.generate(reqs, num_steps=1, noise=noise)
    res["ring_lowering"] = hlo_cost.check_ring_lowering(
        prof, n_dev=mesh.size, moe_layer_calls=2 * cfg.num_layers)
    del paged, paged_ring, server, pool
    gc.collect()
    torch.cuda.empty_cache()
    resident, resident_ring, res["init_resident_s"] = build(False)
    res["resident"] = run(resident, "resident blocking")
    res["resident ring"] = run(resident_ring, "resident ring")
    del resident, resident_ring
    gc.collect()
    torch.cuda.empty_cache()
    for engine in ("", " ring"):
        res["equal" + engine] = torch.equal(res["paged" + engine]["x"],
                                            res["resident" + engine]["x"])
    x = res["paged"]["x"]
    res["finite"], res["shape"] = bool(torch.isfinite(x).all()), tuple(x.shape)
    for r in [res[k] for k in ("paged", "paged ring", "resident", "resident ring",
                               "faults", "delay")]:
        r.pop("x", None)
    return _every_rank(res)


def phase_g_paging(rows, smi):
    """11b and 11c: DiT-MoE-G width, paged against resident at ep=2."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    ranks, totals = mesh_lib.spawn(_g_job, EP, backend="gloo", device="cuda",
                                   timeout_s=EP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    per = lambda key, field: [r[key][field] for r in ranks]  # noqa: E731
    steps = G_STEPS
    for engine in ("", " ring"):
        p, q = r0["paged" + engine], r0["resident" + engine]
        log(f"  11b [{smi}] DiT-MoE-G width ({G_LAYERS} of 40 layers), dice+int8, "
            f"{XL_REQUESTS} requests x {steps} steps, ep=2 gloo sharing the card,"
            f"{engine or ' blocking'}: paged (depth 1) {per('paged' + engine, 's_per_step')} "
            f"s/step per rank against resident {per('resident' + engine, 's_per_step')}; "
            f"paged samples == resident bit for bit: {r0['equal' + engine]}; "
            f"paged_transfers {p['paged_transfers']} ({p['paged_transfers'] / steps:.0f} "
            f"a step over both ranks), {p['paged_bytes_in'] / steps / 1e9:.4f} GB a step; "
            f"peak resident expert bytes {p['peak_resident_expert_bytes']} <= budget "
            f"{p['expert_hbm_budget']}; max_memory_allocated per rank paged "
            f"{[round(g, 3) for g in per('paged' + engine, 'peak_gib')]} GiB, resident "
            f"{[round(g, 3) for g in per('resident' + engine, 'peak_gib')]} GiB; "
            f"ring hops {p['hops']}; launches per rank {per('paged' + engine, 'counts')}")
        if not r0["equal" + engine]:
            raise AssertionError(f"11b{engine}: paged samples differ from resident")
        if not 0 < p["peak_resident_expert_bytes"] <= p["expert_hbm_budget"]:
            raise AssertionError("11b: the realized peak exceeds the budget")
        if not all(a < b for a, b in zip(per("paged" + engine, "peak_gib"),
                                          per("resident" + engine, "peak_gib"))):
            raise AssertionError("11b: paging did not lower max_memory_allocated")
    tr = [r["trace"] for r in ranks]
    log(f"  11b [{smi}] one traced paged step per rank: pool copies "
        f"{[t['copies'] for t in tr]} ({[round(t['gb'], 4) for t in tr]} GB, "
        f"{[round(t['copy_ms'], 3) for t in tr]} ms of copying: "
        f"{[round(t['gbps'], 3) for t in tr]} GB/s), share of copy time with a kernel "
        f"of the rank running {[round(t['overlap'], 4) for t in tr]}, kernels "
        f"{[t['kernels'] for t in tr]}, other HtoD copies {[t['other_htod'] for t in tr]}")
    if not all(t["overlap"] > 0 for t in tr):
        raise AssertionError("11b: the pool's copies overlap no kernel")
    probe = _overlap_probe(r0["layer_shard_bytes"])
    import ctypes
    cudart = ctypes.CDLL("/usr/local/cuda/lib64/libcudart.so")
    engines = ctypes.c_int(-1)
    cudart.cudaDeviceGetAttribute(ctypes.byref(engines), 40, 0)  # AsyncEngineCount
    log(f"  11b [{smi}] a {r0['layer_shard_bytes']} B pinned copy on a side stream "
        f"beside 10 expert_ffn calls (8, 320, 1408, 5632): one process alone on the "
        f"card: copy {probe['copy_ms']:.3f} ms, kernels {probe['compute_ms']:.3f} ms, "
        f"both {probe['both_ms']:.3f} ms; a 16 MB device-to-host copy alone "
        f"{probe['d2h_ms']:.3f} ms, issued just after the big copy "
        f"{probe['d2h_behind_copy_ms']:.3f} ms; a 16 MB host-to-device copy alone "
        f"{probe['h2d_ms']:.3f} ms, just after the big copy "
        f"{probe['h2d_behind_copy_ms']:.3f} ms; the card's async copy engines "
        f"{engines.value}; each of 2 ranks at once: "
        f"{[{k: round(v, 3) for k, v in r['probe'].items()} for r in ranks]}")
    log(f"  11b [{smi}] per rank: pinned host bytes {[r['pinned_bytes'] for r in ranks]}, "
        f"MemAvailable {[round(r['mem_available_gib'], 2) for r in ranks]} GiB, layer "
        f"shard {r0['layer_shard_bytes']} B, budget {r0['budget']} B, init paged "
        f"{[round(r['init_paged_s'], 2) for r in ranks]} s, resident "
        f"{[round(r['init_resident_s'], 2) for r in ranks]} s; samples finite "
        f"{r0['finite']}, shape {r0['shape']}")
    g = get_config("dit-moe-g")
    if not r0["finite"] or r0["shape"] != (XL_REQUESTS, g.patch_tokens, g.in_channels):
        raise AssertionError("11b: G samples not finite or misshapen")
    f, d = r0["faults"], r0["delay"]
    log(f"  11c [{smi}] {G_FAULTS}: samples == clean paged run {f['equal']}, fetch "
        f"errors {f['fetch_errors']}, retries {f['fetch_retries']}, stale fallbacks "
        f"{f['stale_fallbacks']}, transfers {f['transfers']}, "
        f"{per('faults', 's_per_step')} s/step")
    log(f"  11c [{smi}] {G_DELAY}: samples == clean {d['equal']}, delayed fetches per "
        f"rank {per('delay', 'delays')} (10 ms each, on the kernel-issuing thread), "
        f"{per('delay', 's_per_step')} s/step against {per('paged', 's_per_step')} clean")
    if not (f["equal"] and d["equal"] and f["fetch_errors"] > 0):
        raise AssertionError("11c: the paging rungs changed the samples or injected nothing")
    log(f"  11c [{smi}] check_ring_lowering on a profiled ring step at ep=2 "
        f"({G_LAYERS} layers x 2 passes): {r0['ring_lowering']} on every rank "
        f"{all(r['ring_lowering'] == r0['ring_lowering'] for r in ranks)}")
    log(f"  11b/11c spawn {spawn_s:.1f} s, launch totals per rank {totals}")
    launches = r0["paged"]["counts"]
    for key in ("expert_ffn G", "flash_attention G", "residual_int8 G"):
        rows[key]["launches"] = launches[rows[key]["name"]]
        rows[key]["launches_ep2_per_rank"] = [
            c[rows[key]["name"]] for c in per("paged", "counts")]


def phase_g_kernels(rows, smi):
    """Phase 3's last part: the three DiT kernels at DiT-MoE-G's shapes (the
    shapes phase 11b runs) against their plain versions, timed as the rest
    of phase 3; fills ``rows`` (phase 11b adds their launches)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.timing import device_ms, rotating, time_ms
    gen = torch.Generator(device="cuda").manual_seed(19)
    # expert_ffn at an ep=2 rank's refresh shape: 8 local experts, 2 x 160 rows
    E, C, d, f = 8, 320, 1408, 5632
    args = _expert_inputs(gen, E, C, d, f, torch.float32)
    err = compare(f"3G [{smi}] expert_ffn E={E} C={C} d={d} f={f} f32 silu "
                  f"(a G ep=2 rank at refresh)", ops.expert_ffn(*args),
                  ref.expert_ffn_ref(*args), TOL_F32)
    ms = time_ms(lambda: ops.expert_ffn(*args), 10)
    dev = device_ms(lambda: ops.expert_ffn(*args), 10)
    plain = time_ms(lambda: ref.expert_ffn_ref(*args), 10)
    x, wg, wu, wd = args
    h = torch.randn((E, C, f), device="cuda")
    yard = time_ms(lambda: (torch.bmm(x, wg), torch.bmm(x, wu), torch.bmm(h, wd)), 10)
    del x, wg, wu, wd, h, args
    flops = 6.0 * E * C * d * f
    nbytes = 4.0 * (2 * E * C * d + 3 * E * d * f)
    b_ms, b_by = bound(flops, nbytes)
    tc_ms, tc_by = bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
    log(f"  3G [{smi}] expert_ffn G: kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s; "
        f"device alone {dev:.4f} ms), plain {plain:.4f} ms, three-bmm yardstick "
        f"{yard:.4f} ms, bound {tc_ms:.4f} ms ({tc_by}, 3xTF32), FP32 bound {b_ms:.4f} ms "
        f"({b_by}); library: none")
    rows["expert_ffn G"] = dict(
        name="expert_ffn", route="cuda", source="src/repro_torch/csrc/expert_ffn.cu",
        replaces="src/repro/kernels/expert_ffn.py:69", max_abs_err=err, ms=ms,
        device_ms=dev, events_ms=ms, plain_ms=plain, bound_ms=tc_ms, bound_by=tc_by,
        fp32_bound_ms=b_ms, library_ms=None, yardstick_ms=yard,
        shape="E=8 C=320 d=1408 f=5632 f32 silu (a DiT-MoE-G ep=2 rank at refresh)")
    # flash_attention at G's head dim 88: the NT = 16 instance (Dh <= 128)
    B, S, H, Dh = 4, 256, 16, 88
    q, k, v = (torch.randn((B, S, H, Dh), generator=gen, device="cuda") for _ in range(3))
    err = compare(f"3G [{smi}] flash B={B} S={S} H={H} Dh={Dh} f32 (G's heads, an "
                  f"ep=2 rank's 4 requests)", ops.flash_attention(q, k, v),
                  ref.flash_attention_ref(q, k, v), TOL_F32)
    ms = time_ms(lambda: ops.flash_attention(q, k, v), 50)
    dev = device_ms(lambda: ops.flash_attention(q, k, v), 50)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), 50)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 50)
    flops = 4.0 * B * H * S * S * Dh
    nbytes = 4.0 * 4 * B * S * H * Dh
    b_ms, _ = bound(flops, nbytes)
    tc_ms, tc_by = bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
    regs = [line for line in build.ptxas_report() if line.startswith("flash<")
            and ", 16>" in line]
    log(f"  3G [{smi}] flash G: kernel {ms:.4f} ms (device alone {dev:.4f} ms), plain "
        f"{plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, bound {tc_ms:.4f} ms "
        f"({tc_by}, 3xTF32), FP32 bound {b_ms:.4f} ms; the NT=16 instance's ptxas: {regs}")
    rows["flash_attention G"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:70", max_abs_err=err, ms=ms,
        device_ms=dev, events_ms=ms, plain_ms=plain, bound_ms=tc_ms, bound_by=tc_by,
        fp32_bound_ms=b_ms, library_ms=lib,
        shape="B=4 S=256 H=16 Dh=88 f32 non-causal (DiT-MoE-G, an ep=2 rank)")
    del q, k, v, qt, kt, vt
    # residual_int8 at G's rows: a rank's 1024 dispatch and 2048 combine rows
    for N in (1024, 2048):
        value, base = _int8_inputs(gen, N, 1408, torch.float32)
        qk, sk, rk = ops.residual_int8(value, base)
        qp, sp, rp = ref.residual_int8_ref(value, base)
        torch.cuda.synchronize()
        if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
            raise AssertionError("3G: residual_int8 q or scale differ at G's width")
        err = compare(f"3G [{smi}] residual_int8 recon N={N} d=1408 f32", rk, rp,
                      dict(rtol=1e-6, atol=1e-6))
    sets = [_int8_inputs(gen, N, 1408, torch.float32) for _ in range(20)]
    dev = device_ms(rotating(ops.residual_int8, sets), 300)
    events = time_ms(rotating(ops.residual_int8, sets), 300)
    plain = time_ms(rotating(ref.residual_int8_ref, sets), 30)
    nbytes = N * 1408 * (3 * 4 + 1) + N * 4
    b_ms, b_by = bound(6.0 * N * 1408, nbytes)
    log(f"  3G [{smi}] residual_int8 G N={N} d=1408 f32: device {dev:.4f} ms "
        f"({100 * b_ms / dev:.1f}% of bound), events {events:.4f} ms, plain {plain:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), library: none")
    rows["residual_int8 G"] = dict(
        name="residual_int8", route="cuda", source="src/repro_torch/csrc/residual_int8.cu",
        replaces="src/repro/kernels/residual_codec.py:44", max_abs_err=err, ms=dev,
        device_ms=dev, events_ms=events, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape="N=2048 d=1408 f32 (a DiT-MoE-G ep=2 rank's combine rows)")
    del sets
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 12: training (the backward kernels, the tiny model cpu vs card, XL
# width, the quality ordering)
# ---------------------------------------------------------------------------
TRAIN_STEPS = 30                          # 12b: tests/test_system.py's run
TRAIN_BATCH = 16
TRAIN_XL_LAYERS = 8                       # 12c: XL width, depth cut
TRAIN_XL_BATCH = 8
TRAIN_XL_TIMED = 4
NO_PALLAS = "no Pallas kernel: XLA autodiff of repro.kernels.ref"
FFN_BWD_LAUNCHES = 5      # expert_ffn_bwd: five wgmma passes a call
FLASH_BWD_LAUNCHES = 2    # flash_attention_bwd: dQ (with D), then dK/dV


def _train_tiny_cfg():
    from repro_torch.configs.dit_moe_xl import tiny
    return tiny().replace(num_layers=4, d_model=64, moe_d_ff=64, d_ff=256, patch_tokens=16)


def sum_tol(n: int) -> float:
    """Relative tolerance, of a tensor's largest magnitude, for f32 sums of
    ``n`` products on the tensor cores: ``mma.sync``'s f32 accumulation
    drifts from an f32 FMA loop, the more the longer the sum (the
    backward's dX at XL, n = 2f + d = 10,368, lies 8.3e-5 of its largest
    value from the plain version, phase 12a, PR 20), so per-element
    TOL_F32 cannot hold small elements of long sums.  n x 2^-24 (6.2e-4
    at that n), never below TOL_F32's 1e-4."""
    return max(TOL_F32["rtol"], n * 2.0 ** -24)


def compare_sum(name: str, got, want, n: int) -> float:
    """``compare`` with TOL_F32's rtol and an atol of TOL_F32's plus
    ``sum_tol(n)`` of the largest finite magnitude of ``want``."""
    import torch
    w = want.float()
    finite = w[torch.isfinite(w)]
    scale = float(finite.abs().max()) if finite.numel() else 0.0
    tol = dict(rtol=TOL_F32["rtol"], atol=TOL_F32["atol"] + sum_tol(n) * scale)
    return compare(name, got, want, tol)


def _grads(params, batch, cfg, draws):
    """(loss, gradient leaves in flattening order) of rf_loss."""
    import torch
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.sampling.rectified_flow import rf_loss
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = rf_loss(live, batch, cfg, **draws)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))


def _compare_grads(label, got, want, names, n_sum):
    """Every leaf's gradient against the other device's, to TOL_F32's rtol
    and an atol of TOL_F32's plus ``sum_tol(n_sum)`` of the leaf's largest
    magnitude; prints the worst leaf.  Returns the largest absolute
    difference."""
    import torch
    worst, worst_name, max_abs = 0.0, "", 0.0
    rel = sum_tol(n_sum)
    for g, w, n in zip(got, want, names):
        g, w = g.float().cpu(), w.float().cpu()
        err = (g - w).abs()
        atol = TOL_F32["atol"] + rel * float(w.abs().max())
        ratio = float((err / (atol + TOL_F32["rtol"] * w.abs())).max())
        max_abs = max(max_abs, float(err.max()))
        if ratio > worst or not bool(torch.isfinite(g).all()):
            worst, worst_name = ratio, n
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: gradient of {n} is not finite")
    log(f"  {label}: {len(names)} leaves, max_abs_err {max_abs:.3e}, worst leaf {worst_name} "
        f"at {worst:.3f} of its tolerance (rtol={TOL_F32['rtol']}, atol={TOL_F32['atol']} + "
        f"{rel:.3e} x the leaf's max) {'ok' if worst <= 1.0 else 'FAIL'}")
    if worst > 1.0:
        raise AssertionError(f"{label}: gradients differ beyond their tolerance")
    return max_abs


def phase_backward_kernels(rows, smi):
    """12a, run at the end of phase 3 (lines ``3B``): the two backward
    kernels against their plain versions, twice bit for bit, on a NaN row,
    timed against their bounds and yardsticks.  In a whole run a profiler
    trace taken in phase 12 dropped some of their launches (PR 20), so
    their device times are taken where phase 3's are, and ``device_ms``
    checks the traced launch count."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.timing import device_ms, time_ms
    gen = torch.Generator(device="cuda").manual_seed(20)
    # ---- expert_ffn backward ---------------------------------------------
    for E, C, d, f, act, label in ((8, 640, 1152, 4608, "silu", "XL refresh"),
                                   (8, 320, 1408, 5632, "silu", "G ep=2 rank refresh"),
                                   (3, 129, 1152, 4608, "gelu", "C off the 128-row tile"),
                                   (2, 136, 72, 100, "silu", "ragged d and f"),
                                   (2, 40, 73, 97, "silu", "odd d and f: zero-padded copies")):
        x, wg, wu, wd = _expert_inputs(gen, E, C, d, f, torch.float32)
        x[:, C - C // 4:] = 0.0                   # empty capacity rows
        dy = torch.randn((E, C, d), generator=gen, device="cuda")
        dy[:, C - C // 4:] = 0.0
        got = ops.expert_ffn_bwd(x, wg, wu, wd, dy, act=act)
        want = ref.expert_ffn_bwd_ref(x, wg, wu, wd, dy, act=act)
        again = ops.expert_ffn_bwd(x, wg, wu, wd, dy, act=act)
        torch.cuda.synchronize()
        tag = f"3B [{smi}] expert_ffn_bwd E={E} C={C} d={d} f={f} {act} ({label})"
        # the longest chain of sums behind each gradient: d (G, U, dH),
        # then 2f for dX and C for the weights
        err = max(compare_sum(f"{tag} {n}", g, w, (2 * f if n == "dX" else C) + d)
                  for n, g, w in zip(("dX", "dWg", "dWu", "dWd"), got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        empty = not bool(got[0][:, C - C // 4:].any())
        log(f"  {tag}: two runs bit-identical {same}, empty rows' dX zero {empty}")
        if not (same and empty):
            raise AssertionError("expert_ffn_bwd: runs differ or empty rows got a gradient")
        if label == "XL refresh":
            xl_err, xl_args = err, (x, wg, wu, wd, dy)
        elif label == "G ep=2 rank refresh":
            g_err, g_args = err, (x, wg, wu, wd, dy)
        else:
            del x, wg, wu, wd, dy
        del got, want, again
    # a NaN in one token row: NaN where the plain version has it
    x, wg, wu, wd = _expert_inputs(gen, 2, 40, 64, 96, torch.float32)
    dy = torch.randn((2, 40, 64), generator=gen, device="cuda")
    x[1, 5, 3] = math.nan
    got = ops.expert_ffn_bwd(x, wg, wu, wd, dy)
    want = ref.expert_ffn_bwd_ref(x, wg, wu, wd, dy)
    nan_same = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(got, want))
    log(f"  3B [{smi}] expert_ffn_bwd NaN in one row: NaN positions equal the plain "
        f"version's {nan_same} (dX NaN rows {int(torch.isnan(got[0]).any(-1).sum())})")
    if not nan_same:
        raise AssertionError("expert_ffn_bwd: NaN positions differ from the plain version")
    for (E, C, d, f), err, args, key, shape in (
            ((8, 640, 1152, 4608), xl_err, xl_args, "expert_ffn_bwd",
             "E=8 C=640 d=1152 f=4608 f32 silu (XL refresh)"),
            ((8, 320, 1408, 5632), g_err, g_args, "expert_ffn_bwd G",
             "E=8 C=320 d=1408 f=5632 f32 silu (a DiT-MoE-G ep=2 rank)")):
        x, wg, wu, wd, dy = args
        ms = time_ms(lambda: ops.expert_ffn_bwd(x, wg, wu, wd, dy), 10)
        dev = device_ms(lambda: ops.expert_ffn_bwd(x, wg, wu, wd, dy), 10,
                        launches_per_call=FFN_BWD_LAUNCHES)
        plain = time_ms(lambda: ref.expert_ffn_bwd_ref(x, wg, wu, wd, dy), 5)
        hh = torch.randn((E, C, f), device="cuda")
        wgt, wut, wdt = (w.transpose(1, 2) for w in (wg, wu, wd))
        xt, ht = x.transpose(1, 2), hh.transpose(1, 2)
        # the six products alone (cuBLAS bmm): a yardstick, not one library
        # call computing the backward
        yard = time_ms(lambda: (torch.bmm(dy, wdt), torch.bmm(ht, dy), torch.bmm(hh, wgt),
                                torch.bmm(hh, wut), torch.bmm(xt, hh), torch.bmm(xt, hh)), 10)
        del hh, args
        flops = 12.0 * E * C * d * f              # six products
        nbytes = 4.0 * 2 * (2 * E * C * d + 3 * E * d * f)
        b_ms, b_by = bound(flops, nbytes)
        tc_ms, tc_by = bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
        log(f"  3B [{smi}] expert_ffn_bwd {shape}: kernel {ms:.4f} ms (device alone {dev:.4f} "
            f"ms; {FFN_BWD_LAUNCHES} wgmma launches, the recompute of G and U included: "
            f"{16.0 * E * C * d * f:.3e} FLOP done, {flops / ms / 1e9:.2f} TFLOP/s of the six "
            f"products), plain {plain:.4f} ms, six-bmm yardstick {yard:.4f} ms, kernel / "
            f"yardstick {ms / yard:.3f}, bound {tc_ms:.4f} ms ({tc_by}, six products at "
            f"3xTF32), FP32 bound {b_ms:.4f} ms; library: none")
        rows[key] = dict(
            name="expert_ffn_bwd", route="cuda", source="src/repro_torch/csrc/expert_ffn_bwd.cu",
            replaces=NO_PALLAS, launches=0, max_abs_err=err, ms=ms, device_ms=dev,
            events_ms=ms, plain_ms=plain, bound_ms=tc_ms, bound_by=tc_by, fp32_bound_ms=b_ms,
            library_ms=None, yardstick_ms=yard, yardstick_ratio=ms / yard, shape=shape)
        del x, wg, wu, wd, dy
    # ---- flash_attention backward ----------------------------------------
    timed = {}
    for B, Sq, Sk, H, Dh in ((8, 256, 256, 16, 72), (4, 256, 256, 16, 88),
                             (2, 65, 257, 4, 72), (1, 40, 70, 2, 128), (2, 64, 64, 4, 24)):
        q = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda")
        k, v = (torch.randn((B, Sk, H, Dh), generator=gen, device="cuda") for _ in range(2))
        do = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda")
        o_plain = ops.flash_attention(q, k, v)
        o, lse, _ = ops._flash_attention_fwd(q, k, v, want_lse=True)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
        again = ops.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        tag = f"3B [{smi}] flash_attention_bwd B={B} Sq={Sq} Sk={Sk} H={H} Dh={Dh} f32"
        compare(f"{tag} lse", lse, ref.attention_lse_ref(q, k), TOL_F32)
        err = max(compare(f"{tag} {n}", g, w, TOL_F32)
                  for n, g, w in zip(("dQ", "dK", "dV"), got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        fwd_same = torch.equal(o, o_plain)
        log(f"  {tag}: two runs bit-identical {same}; forward output with the lse store "
            f"bit-identical to without {fwd_same}")
        if not (same and fwd_same):
            raise AssertionError("flash_attention_bwd: runs differ, or the lse store "
                                 "changed the forward")
        if (B, Sq, Dh) in ((8, 256, 72), (4, 256, 88)):
            timed[B, Dh] = (err, q, k, v, o, lse, do)
    q, k, v, do = (torch.randn((1, 32, 2, 24), generator=gen, device="cuda") for _ in range(4))
    q[0, 3, 1, 5] = math.nan
    o, lse, _ = ops._flash_attention_fwd(q, k, v, want_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    nan_same = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(got, want))
    log(f"  3B [{smi}] flash_attention_bwd NaN in one query row: NaN positions equal the "
        f"plain version's {nan_same}")
    if not nan_same:
        raise AssertionError("flash_attention_bwd: NaN positions differ from the plain version")
    # the five wgmma passes, and the flash instances of Dh 72 and 88 (NT 9, 12)
    regs = [line for line in build.ptxas_report()
            if line.startswith(("bwd_wgmma", "flash_bwd_dkdv<f32, 9>", "flash_bwd_dq<f32, 9>",
                                "flash_bwd_dkdv<f32, 12>", "flash_bwd_dq<f32, 12>"))]
    for line in regs:
        log(f"  3B [{smi}] ptxas {line}")
    # ptxas notes that it serialized wgmmas (C7511-C7515) in the port's build
    serial = [line.strip() for line in (build.build_dir() / "build.log").read_text().splitlines()
              if "wgmma.mma_async instructions are serialized" in line]
    log(f"  3B [{smi}] ptxas notes of serialized wgmma: {len(serial)}")
    for line in serial:
        log(f"  3B [{smi}] ptxas {line}")
    for (B, Dh), key, shape in (((8, 72), "flash_attention_bwd",
                                 "B=8 S=256 H=16 Dh=72 f32 (XL)"),
                                ((4, 88), "flash_attention_bwd G",
                                 "B=4 S=256 H=16 Dh=88 f32 (DiT-MoE-G, an ep=2 rank)")):
        err, q, k, v, o, lse, do = timed.pop((B, Dh))
        S, H = q.shape[1], q.shape[2]
        ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do), 20)
        dev = device_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do), 20,
                        launches_per_call=FLASH_BWD_LAUNCHES)
        plain = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do), 20)
        qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True), 20)
        flops = 2.5 * 4.0 * B * H * S * S * Dh
        nbytes = 4.0 * 8 * B * S * H * Dh
        b_ms, b_by = bound(flops, nbytes)
        tc_ms, tc_by = bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
        log(f"  3B [{smi}] flash_attention_bwd {shape}: kernel {ms:.4f} ms (device alone "
            f"{dev:.4f} ms, {FLASH_BWD_LAUNCHES} launches, 3xTF32 mma.sync), plain {plain:.4f} "
            f"ms, backward of scaled_dot_product_attention through autograd {lib:.4f} ms, "
            f"kernel / SDPA backward {ms / lib:.3f}, bound {tc_ms:.4f} ms ({tc_by}, 3xTF32), "
            f"FP32 bound {b_ms:.4f} ms ({b_by})")
        rows[key] = dict(
            name="flash_attention_bwd", route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu", replaces=NO_PALLAS,
            launches=0, max_abs_err=err, ms=ms, device_ms=dev, events_ms=ms, plain_ms=plain,
            bound_ms=tc_ms, bound_by=tc_by, fp32_bound_ms=b_ms, library_ms=lib,
            yardstick_ratio=ms / lib, shape=shape)
        del qt, kt, vt, ot
    torch.cuda.synchronize()
    # the products are on the tensor cores: wgmma (HGMMA) in every pass of
    # expert_ffn_bwd, mma.sync (HMMA) in both flash_attention_bwd kernels
    sass = build.sass_opcodes(("HGMMA", "HMMA", "FFMA"))
    tensor = {k: v for k, v in sass.items() if "bwd" in k}
    for name, counts in sorted(tensor.items()):
        log(f"  3B [{smi}] sass {name}: {counts}")
    # passes 0 and 1 write the f32 scratch only; 2-4 have an f32 and a bf16
    # instance (the gradients' type)
    wgmma_ok = [k for k in tensor if k.startswith("bwd_wgmma")]
    hmma_ok = [k for k in tensor if k.startswith("flash_bwd")]
    want_wgmma = {"bwd_wgmma<0, f32>", "bwd_wgmma<1, f32>"} | {
        f"bwd_wgmma<{i}, {t}>" for i in (2, 3, 4) for t in ("f32", "bf16")}
    if (set(wgmma_ok) != want_wgmma or not all(tensor[k]["HGMMA"] > 0 for k in wgmma_ok)
            or not hmma_ok or not all(tensor[k]["HMMA"] > 0 for k in hmma_ok)):
        raise AssertionError("backward kernels: a product is not on the tensor cores "
                             f"(SASS opcode counts {tensor})")


def phase_train_tiny(smi):
    """12b: the 4-layer DiT of tests/test_system.py trained 30 steps on the
    CPU (plain versions) and on the card (kernels) from the same weights,
    batches and draws; returns the card's trained params and config."""
    import torch
    from repro_torch.checkpoint.io import flatten
    from repro_torch.data.synthetic import latent_batches
    from repro_torch.kernels import ops
    from repro_torch.models.dit_moe import init_dit
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.sampling.rectified_flow import rf_draws, rf_train_step
    cfg = _train_tiny_cfg()
    params = init_dit(cfg, generator=torch.Generator().manual_seed(0))
    it = latent_batches(batch=TRAIN_BATCH, tokens=cfg.patch_tokens, channels=cfg.in_channels,
                        num_classes=cfg.num_classes, seed=1)
    gen = torch.Generator().manual_seed(2)
    shape = (TRAIN_BATCH, cfg.patch_tokens, cfg.in_channels)
    data = [(next(it), rf_draws(gen, TRAIN_BATCH, shape)) for _ in range(TRAIN_STEPS)]
    # step 0's gradients with adaLN and final_out perturbed (adaLN-zero makes
    # every block's gradient exactly 0 at init)
    pert = _perturb(_to(params, "cpu"), torch.Generator().manual_seed(3))
    names = [n for n, _ in flatten(pert)[0]]
    loss_c, g_cpu = _grads(pert, data[0][0], cfg, data[0][1])
    loss_g, g_gpu = _grads(_to(pert, "cuda"), _to(data[0][0], "cuda"), cfg,
                           _to(data[0][1], "cuda"))
    _compare_grads(f"12b [{smi}] tiny step-0 gradients (adaLN perturbed), card vs cpu",
                   g_gpu, g_cpu, names, 2 * cfg.expert_d_ff + cfg.d_model)
    losses = {}
    trained = {}
    for dev in ("cpu", "cuda"):
        # a copy: the steps update the params in place
        p = tree_map(lambda t: t.detach().to(dev, copy=True), params)
        opt = adamw_init(p)
        ops.reset_launches()
        t0 = time.perf_counter()
        out = []
        for b, dr in data:
            p, opt, m = rf_train_step(p, opt, _to(b, dev), cfg, draws=_to(dr, dev))
            out.append(m["loss"])
        losses[dev] = [float(x) for x in out]
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        trained[dev] = p
        log(f"  12b [{smi}] tiny on {dev}: {TRAIN_STEPS} steps in {wall:.3f} s, first losses "
            f"{[round(x, 5) for x in losses[dev][:3]]}, last {[round(x, 5) for x in losses[dev][-3:]]}, "
            f"launches {counts}")
    want = {k: 0 for k in ops.LAUNCHES}
    for k in ("expert_ffn", "flash_attention", "expert_ffn_bwd", "flash_attention_bwd"):
        want[k] = TRAIN_STEPS * cfg.num_layers
    if counts != want:
        raise AssertionError(f"12b: launches {counts} differ from the plan's {want}")
    lc, lg = torch.tensor(losses["cpu"]), torch.tensor(losses["cuda"])
    # 30 AdamW steps compound the f32 rounding differences of the two
    # devices' sums; 1e-3 relative holds them (the CPU test holds the port
    # to the JAX reference at the same tolerance)
    compare(f"12b [{smi}] tiny losses over {TRAIN_STEPS} steps, card vs cpu", lg, lc,
            dict(rtol=1e-3, atol=0.0))
    first, last = float(lg[:5].mean()), float(lg[-5:].mean())
    log(f"  12b [{smi}] card loss: first 5 mean {first:.5f}, last 5 mean {last:.5f} "
        f"(must be < 0.9 x first: {last < 0.9 * first})")
    if not last < 0.9 * first:
        raise AssertionError("12b: the card's training did not reduce the loss")
    return cfg, trained["cuda"]


def phase_train_xl(rows, smi):
    """12c: DiT-MoE-XL at full width, depth cut to TRAIN_XL_LAYERS, batch
    TRAIN_XL_BATCH, adaLN and final_out perturbed: one warm-up step, then
    TRAIN_XL_TIMED timed steps with the launch counts set to 0 before them;
    then the model cut to 2 layers at batch 2, cpu against card."""
    import torch
    from repro_torch.checkpoint.io import flatten
    from repro_torch.configs.dit_moe_xl import config
    from repro_torch.data.synthetic import latent_batches
    from repro_torch.kernels import ops
    from repro_torch.models.dit_moe import init_dit
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sampling.rectified_flow import rf_draws, rf_train_step
    cfg = config().replace(num_layers=TRAIN_XL_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(12)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = _perturb(init_dit(cfg, generator=gen), gen)
    opt = adamw_init(params)
    it = latent_batches(batch=TRAIN_XL_BATCH, tokens=cfg.patch_tokens,
                        channels=cfg.in_channels, num_classes=cfg.num_classes, seed=4,
                        device="cuda")
    shape = (TRAIN_XL_BATCH, cfg.patch_tokens, cfg.in_channels)

    def step():
        nonlocal params, opt
        params, opt, m = rf_train_step(params, opt, next(it), cfg,
                                       draws=rf_draws(gen, TRAIN_XL_BATCH, shape))
        return m

    step()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    ms = [step() for _ in range(TRAIN_XL_TIMED)]
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / TRAIN_XL_TIMED
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in ms]
    gnorms = [float(m["grad_norm"]) for m in ms]
    want = {k: 0 for k in ops.LAUNCHES}
    for k in ("expert_ffn", "flash_attention", "expert_ffn_bwd", "flash_attention_bwd"):
        want[k] = TRAIN_XL_TIMED * cfg.num_layers
    n_params = sum(p.numel() for _, p in flatten(params)[0])
    log(f"  12c [{smi}] XL width ({cfg.num_layers} layers, {n_params / 1e9:.3f} B params f32), "
        f"batch {TRAIN_XL_BATCH}: {s_per_step:.4f} s/train-step over {TRAIN_XL_TIMED} steps, "
        f"max_memory_allocated {peak:.3f} GiB, losses {[round(x, 5) for x in losses]}, grad "
        f"norms {[round(x, 4) for x in gnorms]}, launches {counts} (per step "
        f"{ {k: v // TRAIN_XL_TIMED for k, v in counts.items()} }), planned {want}")
    if counts != want or not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError("12c: launches differ from the plan or the loss is not finite")
    for key in ("expert_ffn_bwd", "flash_attention_bwd"):
        rows[key]["launches"] = counts[key]
    for key in ("expert_ffn", "flash_attention"):
        rows[key]["launches_train"] = counts[key]
    # the same model cut to 2 layers at batch 2: cpu against card
    small = dict(params, blocks=params["blocks"][:2])
    small_cfg = cfg.replace(num_layers=2)
    del opt
    torch.cuda.empty_cache()
    b = next(latent_batches(batch=2, tokens=cfg.patch_tokens, channels=cfg.in_channels,
                            num_classes=cfg.num_classes, seed=5))
    dr = rf_draws(torch.Generator().manual_seed(6), 2, (2, cfg.patch_tokens, cfg.in_channels))
    names = [n for n, _ in flatten(small)[0]]
    ops.reset_launches()
    _, g_gpu = _grads(small, _to(b, "cuda"), small_cfg, _to(dr, "cuda"))
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    _, g_cpu = _grads(_to(small, "cpu"), b, small_cfg, dr)
    cpu_s = time.perf_counter() - t0
    _compare_grads(f"12c [{smi}] XL width 2 layers batch 2 step-0 gradients, card vs cpu "
                   f"({cpu_s:.1f} s on the cpu); card launches {counts}", g_gpu, g_cpu, names,
                   2 * cfg.expert_d_ff + cfg.d_model)
    if any(counts.get(k, 0) != 2 for k in ("expert_ffn", "flash_attention",
                                             "expert_ffn_bwd", "flash_attention_bwd")):
        raise AssertionError("12c: the 2-layer card gradients missed a kernel")
    del params, small, g_gpu, g_cpu
    torch.cuda.empty_cache()
    return s_per_step, peak


def phase_train_quality(cfg, params, smi):
    """12d: the 12b model the card trained, sampled on the card under sync,
    displaced, interweaved and deep-sync DICE: the ordering of
    tests/test_system.py."""
    import torch
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.metrics.fid_proxy import fid_proxy, mse_vs_reference
    from repro_torch.sampling.rectified_flow import rf_sample
    classes = (torch.arange(8) % cfg.num_classes).to("cuda")
    noise = torch.randn((8, cfg.patch_tokens, cfg.in_channels),
                        generator=torch.Generator().manual_seed(7))
    runs = {"sync": DiceConfig.sync_ep(), "displaced": DiceConfig.displaced(),
            "interweaved": DiceConfig.interweaved(),
            "deep": DiceConfig(schedule=DiceConfig.dice().schedule, sync_policy="deep",
                               cond_comm=False)}
    out = {}
    with torch.no_grad():
        for name, dcfg in runs.items():
            s, _ = rf_sample(params, cfg, dcfg, num_steps=8, classes=classes, noise=noise,
                             guidance=1.5)
            out[name] = s.cpu()
    mse = {n: mse_vs_reference(out[n], out["sync"]) for n in runs if n != "sync"}
    fid = {n: fid_proxy(out[n], out["sync"]) for n in runs if n != "sync"}
    ok = (mse["interweaved"] < mse["displaced"]
          and mse["deep"] <= 1.05 * mse["interweaved"] and min(mse.values()) > 0
          and all(bool(torch.isfinite(s).all()) for s in out.values()))
    log(f"  12d [{smi}] quality on the card-trained tiny model, 8 steps, guidance 1.5: "
        f"paired MSE vs sync {mse}; FID proxy vs sync {fid}; interweaved < displaced "
        f"{mse['interweaved'] < mse['displaced']}, deep <= 1.05 x interweaved "
        f"{mse['deep'] <= 1.05 * mse['interweaved']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("12d: the staleness quality ordering does not hold")


# ---------------------------------------------------------------------------
# phase 13: RWKV-6 training (the recurrence's backward kernel, the smoke
# model cpu vs card, rwkv6-3b at full width and depth)
# ---------------------------------------------------------------------------
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128     # 13c: the reference CLI's defaults
LM_TRAIN_TIMED = 4
LM_SMOKE_STEPS, LM_SMOKE_BATCH, LM_SMOKE_SEQ = 30, 2, 32   # 13b
# 13b's bf16 run: the card's and the CPU's bf16 products round about 0.02%
# of their outputs apart, and the bf16 updates then round apart at a few
# elements; the CPU test holds the port to the reference's printed bf16
# losses at 2e-3 (observed 8.3e-4), so card vs CPU in bf16 is held to 1e-2
TOL_LM_BF16_LOSS = 1e-2
SCAN_BWD_LAUNCHES = 2     # rwkv6_scan_bwd: the chunked recurrence, then dlogw's sums and du's
# the names of those two kernels, which 13a requires in each trace it times
SCAN_BWD_KERNELS = ("rwkv6_scan_bwd_kernel<", "rwkv6_scan_bwd_finish_kernel")
# 13a: a ``git archive`` tar of the parent commit, whose rwkv6_scan_bwd is
# built from its own sources and timed through its own wrapper, in a
# process of its own, beside this tree's (unset: not timed)
PARENT_ENV = "CHIP_SMOKE_PARENT"
PARENT_FLAG = "--time-parent-scan-bwd"    # that process's mode
SCAN_BWD_NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")
# dlogw's error where decays underflow, of the running sums' largest term
# (tests/test_torch_rwkv6_train.py's F32_REL, 168 x 2^-24)
DLOGW_SUMS_REL = 1e-5
SCAN_BWD_REPLACES = ("no Pallas kernel: XLA autodiff of the jnp scan of "
                     "src/repro/models/rwkv6.py:143 (_time_mix_scan)")


def _scan_bwd_inputs(gen, B, H, T, DK, dtype, permuted=False, logw_range=None):
    """r/k/v/u in ``dtype``, logw = -exp(decay) with decay uniform over
    [-6, 2] (w from 6e-4 to 0.9975; ``logw_range``: logw itself uniform
    over that range), s0 0.1 x normal, dout normal, dS_T 0.5 x normal.
    ``permuted``: (B, T, H, DK) tensors permuted to (B, H, T, DK), as the
    model hands them over."""
    import torch
    kw = dict(generator=gen, device="cuda")
    shape = (B, T, H, DK) if permuted else (B, H, T, DK)

    def draw(x):
        return x.permute(0, 2, 1, 3) if permuted else x
    r, k, v = (draw(torch.randn(shape, **kw)).to(dtype) for _ in range(3))
    if logw_range is None:
        logw = draw(-torch.exp(torch.rand(shape, **kw) * 8.0 - 6.0))
    else:
        lo, hi = logw_range
        logw = draw(lo + (hi - lo) * torch.rand(shape, **kw))
    dout = draw(torch.randn(shape, **kw))
    u = (0.5 + 0.1 * torch.randn((H, DK), **kw)).to(dtype)
    s0 = 0.1 * torch.randn((B, H, DK, DK), **kw)
    dS = 0.5 * torch.randn((B, H, DK, DK), **kw)
    return (r, k, v, logw, u, s0), dout, dS


def compare_scan_bwd(tag: str, got, want, n: int) -> float:
    """(dr, dk, dv, dlogw, du, ds0) against the plain version's: an f32
    output by ``compare_sum`` over ``n`` terms (dlogw is a running sum over
    T, so its error grows with T, not with each element's size); a bf16
    output with TOL_BF16 (one rounding, which can land on the neighbouring
    value) and the same atol for the sum.  Returns the largest error."""
    import torch
    errs = []
    for name, g, w in zip(SCAN_BWD_NAMES, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{tag} {name}: {g.dtype} {tuple(g.shape)} against "
                                 f"{w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.float32:
            errs.append(compare_sum(f"{tag} {name}", g, w, n))
        else:
            scale = float(w.float().abs().max())
            errs.append(compare(f"{tag} {name} (bf16)", g, w, dict(
                rtol=TOL_BF16["rtol"], atol=TOL_BF16["atol"] + sum_tol(n) * scale)))
    return max(errs)


def check_dlogw_rounding(tag: str, r, k, got, want) -> None:
    """dlogw where a chunk's decay products underflow: its values (w_t, at
    most e^-20, times the rest) lie far below the f32 rounding of the
    running sums of r dr and k dk it is the difference of, so
    ``compare_sum``'s floor of 1e-4 holds its error, not its values.  Here
    it is also held within DLOGW_SUMS_REL of those sums' largest term, as
    the CPU mirror holds it: finite, with an error at that rounding.  No
    check of the kernel's running-sum form can resolve values below it."""
    terms = max(float((r.float() * want[0].float()).abs().max()),
                float((k.float() * want[1].float()).abs().max()))
    err = float((got[3] - want[3]).abs().max())
    log(f"  {tag} dlogw: max_abs_err {err:.3e}, {err / terms:.3e} of the running sums' "
        f"largest term {terms:.4g} (tol {DLOGW_SUMS_REL:g}); largest |dlogw| "
        f"{float(want[3].abs().max()):.3e}")
    if not (bool(got[3].isfinite().all()) and err <= DLOGW_SUMS_REL * terms):
        raise AssertionError(f"{tag} dlogw: {err:.3e} against {DLOGW_SUMS_REL:g} x {terms:.4g}")


def scan_bwd_bound(B, H, T, DK, es_rkv: int, es_u: int, with_dS: bool):
    """(bound ms, what bounds it, FLOP, FP32 bound ms) of the recurrence's
    backward: 12 FLOP an element and step (the formulas' 9: the state
    gradient's carry 3 and dr, dk, dv 2 each; and the forward state's
    recompute 3) at 3xTF32's rate (a third of TF32's: the chunked kernel's
    state products run on the tensor cores), with the FP32 cores' rate
    beside it; bytes: r, k, v, logw, dout, s0, u (and dS_T) read once, dr,
    dk, dv, dlogw, ds0, du written once."""
    flops = 12.0 * DK * DK * B * H * T
    nbytes = (B * H * T * DK * (6 * es_rkv + 12) + B * H * DK * DK * 4 * (2 + int(with_dS))
              + 2 * H * DK * es_u)
    ms, by = bound(flops, nbytes, PEAK_TF32_FLOPS / 3)
    return ms, by, flops, bound(flops, nbytes)[0]


def _parent_scan_bwd_ms(shapes):
    """(commit, {T: CUDA-events ms}) of the parent's ``rwkv6_scan_bwd`` at
    B = 8, H = 40, DK = 64 bf16 for each (T, input sets, iterations) of
    ``shapes``, or (None, {}) when ``PARENT_ENV`` is unset.  ``PARENT_ENV``
    names a ``git archive`` tar; the commit is read from its header, and
    the tree is unpacked afresh into a temporary directory under build/
    and timed by ``chip_smoke.py PARENT_FLAG`` in a process of its own, so
    the parent's wrapper drives the parent's kernel whatever their C
    signature and scratch."""
    import tarfile
    import tempfile
    tar = os.environ.get(PARENT_ENV)
    if not tar:
        return None, {}
    with tarfile.open(tar) as tf:
        tf.next()
        commit = tf.pax_headers.get("comment", "")
        if not commit:
            raise AssertionError(f"{PARENT_ENV}={tar}: no commit in its header "
                                 f"(not made by git archive)")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="parent_tree.", dir=ROOT / "build") as tree:
        with tarfile.open(tar) as tf:
            tf.extractall(tree, filter="data")
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), PARENT_FLAG, tree,
                              json.dumps(shapes)], capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"the parent's rwkv6_scan_bwd ({commit}) was not timed: "
                             f"{out.stderr[-3000:]}")
    return commit, {int(t): ms for t, ms in json.loads(out.stdout.splitlines()[-1]).items()}


def time_parent_scan_bwd(tree: str, shapes) -> int:
    """``chip_smoke.py PARENT_FLAG TREE SHAPES``: time the ``rwkv6_scan_bwd``
    of the tree unpacked at TREE, built from its own sources by its own
    ``kernels/build.py`` and called through its own wrapper, on inputs
    drawn as 13a draws them; prints {T: CUDA-events ms} as JSON."""
    sys.path.insert(0, str(Path(tree) / "src"))
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.timing import rotating, time_ms
    if not Path(ops.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise AssertionError(f"imported {ops.__file__}, not the tree at {tree}")
    gen = torch.Generator(device="cuda").manual_seed(22)
    got = {}
    for T, n_sets, iters in shapes:
        sets = [_scan_bwd_inputs(gen, 8, 40, T, 64, torch.bfloat16, permuted=True)
                for _ in range(n_sets)]
        got[T] = time_ms(rotating(ops.rwkv6_scan_bwd, [(*a, d) for a, d, _ in sets]), iters)
        del sets
    print(json.dumps(got))
    return 0


def phase_scan_backward(rows, smi):
    """13a, run at the end of phase 3 (lines ``3B``, where the profiler
    traces every launch): ``rwkv6_scan_bwd`` against its plain version at
    rwkv6-3b's training and prefill shapes, f32, DK 16/32/128, T = 1 and
    off the 16-step chunks, with and without dS_T, a logw of -inf and
    decays whose chunk products underflow; two runs bit for bit; a NaN in
    r; its products on the tensor cores (HMMA in the SASS); events and
    device time against the bound (3xTF32, FP32 and bytes) and beside the
    forward's at the same shape (the backward/forward ratio compares
    across cards), and beside the parent commit's kernel when PARENT_ENV
    names its tar."""
    import torch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.timing import kernel_ms, rotating, time_ms
    gen = torch.Generator(device="cuda").manual_seed(22)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [((8, 40, LM_TRAIN_SEQ, 64), bf16, False, True, "rwkv6-3b training, dS_T none"),
             ((8, 40, LM_TRAIN_SEQ, 64), bf16, True, True, "training shape with dS_T"),
             ((8, 40, LM_PROMPT, 64), bf16, False, True, "rwkv6-3b prefill shape"),
             ((2, 4, 300, 64), f32, True, False, "f32"),
             ((2, 3, 37, 16), bf16, True, False, "DK 16"),
             ((2, 3, 300, 32), f32, False, False, "DK 32"),
             ((2, 3, 45, 128), bf16, True, False, "DK 128"),
             ((3, 5, 1, 64), bf16, True, False, "T = 1"),
             ((3, 5, 45, 64), f32, True, False, "T odd, off the 16-step chunk"),
             ((2, 4, 100, 64), bf16, True, False, "a logw of -inf: w 0 in one row at one step"),
             ((2, 4, 100, 64), f32, True, False,
              "logw in [-30, -20]: a chunk's decay products underflow f32")]
    for (B, H, T, DK), dtype, with_dS, permuted, label in cases:
        args, dout, dS = _scan_bwd_inputs(
            gen, B, H, T, DK, dtype, permuted,
            logw_range=(-30.0, -20.0) if "underflow" in label else None)
        if "-inf" in label:
            args[3][1, 2, 37, 5] = -math.inf
        dS_T = dS if with_dS else None
        got = ops.rwkv6_scan_bwd(*args, dout, dS_T)
        want = ref.rwkv6_scan_bwd_ref(*args, dout, dS_T)
        torch.cuda.synchronize()
        tag = (f"3B [{smi}] rwkv6_scan_bwd B={B} H={H} T={T} DK={DK} {str(dtype)[6:]} "
               f"({label})")
        err = compare_scan_bwd(tag, got, want, T + DK)
        if "underflow" in label:
            check_dlogw_rounding(tag, args[0], args[1], got, want)
        if (T, with_dS) == (LM_TRAIN_SEQ, False):
            again = ops.rwkv6_scan_bwd(*args, dout, dS_T)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"  {tag}: two runs bit-identical {same}")
            if not same:
                raise AssertionError("rwkv6_scan_bwd: two runs differ")
            train_err = err
        del args, dout, dS, got, want
    # a NaN in one element of r: NaN where the plain version has it
    args, dout, _ = _scan_bwd_inputs(gen, 2, 3, 45, 64, bf16)
    r = args[0].clone()
    r[1, 2, 20, 5] = math.nan
    got = ops.rwkv6_scan_bwd(r, *args[1:], dout)
    want = ref.rwkv6_scan_bwd_ref(r, *args[1:], dout)
    nan_same = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(got, want))
    log(f"  3B [{smi}] rwkv6_scan_bwd NaN in r at (b 1, h 2, t 20, 5): NaN positions equal "
        f"the plain version's {nan_same} (NaN elements "
        f"{[int(torch.isnan(g).sum()) for g in got]})")
    if not nan_same:
        raise AssertionError("rwkv6_scan_bwd: NaN positions differ from the plain version")
    for line in build.ptxas_report():
        if line.startswith("rwkv6_scan_bwd"):
            log(f"  3B [{smi}] ptxas {line}")
    sass = {k: v for k, v in build.sass_opcodes(("HMMA", "FFMA")).items()
            if k.startswith("rwkv6_scan_bwd<")}
    log(f"  3B [{smi}] sass rwkv6_scan_bwd: {sass}")
    if len(sass) != 8 or not all(c["HMMA"] > 0 for c in sass.values()):
        raise AssertionError(f"rwkv6_scan_bwd: a product is not on the tensor cores ({sass})")
    # timed on three input sets in turn (26 MB of inputs a set at the
    # training shape), as the model hands them over (permuted views)
    B, H, DK = 8, 40, 64
    shapes = ((LM_TRAIN_SEQ, 3, 30, 3), (LM_PROMPT, 1, 5, 1))
    parent_commit, parent_ms = _parent_scan_bwd_ms([shape[:3] for shape in shapes])
    for T, n_sets, iters, plain_iters in shapes:
        sets = [_scan_bwd_inputs(gen, B, H, T, DK, bf16, permuted=True) for _ in range(n_sets)]
        bwd_sets = [(*a, d) for a, d, _ in sets]
        fwd_sets = [a for a, _, _ in sets]
        # late in a whole run traces lose launches (the forward at the
        # training shape: 29 of 30, three traces in a row; a fourth trace
        # here: 0 or 1 of its launches, three runs in a row; NVIDIA H100
        # 80GB HBM3, 700 W), so the backward's device time by launch and
        # the forward's come from one trace a shape, each kernel's mean
        # taken over its traced launches; a trace without a launch of one
        # of the three is retaken, and any other kernel in it raises; the
        # forward's sets run two behind, so neither finds its inputs in L2
        bwd_fn = rotating(ops.rwkv6_scan_bwd, bwd_sets)
        fwd_fn = rotating(ops.rwkv6_scan, fwd_sets[2 % n_sets:] + fwd_sets[:2 % n_sets])
        split = kernel_ms(lambda: (bwd_fn(), fwd_fn()), iters,
                          SCAN_BWD_KERNELS + ("rwkv6_scan_kernel<",))
        fwd = split.pop("rwkv6_scan_kernel<")
        dev = sum(split.values())
        events = time_ms(rotating(ops.rwkv6_scan_bwd, bwd_sets), iters)
        plain = time_ms(rotating(ref.rwkv6_scan_bwd_ref, bwd_sets), plain_iters)
        b_ms, b_by, flops, fp32_ms = scan_bwd_bound(B, H, T, DK, 2, 2, False)
        if parent_commit is None:
            was = f"parent kernel: not timed ({PARENT_ENV} unset)"
        else:
            parent = parent_ms[T]
            was = (f"parent commit {parent_commit[:12]}'s kernel in this run, its own wrapper "
                   f"in a process of its own (CUDA events) {parent:.4f} ms, parent / this "
                   f"(events) {parent / events:.3f}")
        log(f"  3B [{smi}] rwkv6_scan_bwd B={B} H={H} T={T} DK={DK} bf16, dS_T none: kernel "
            f"device {dev:.4f} ms ({SCAN_BWD_LAUNCHES} launches; {100 * b_ms / dev:.1f}% of "
            f"bound), with host (CUDA events) {events:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP of the formulas and the state's "
            f"recompute at 3xTF32's 165 TFLOP/s {flops / (PEAK_TF32_FLOPS / 3) * 1e3:.4f} ms, "
            f"at FP32's 67 TFLOP/s {fp32_ms:.4f} ms), forward kernel device {fwd:.4f} ms at "
            f"the same shape, backward / forward {dev / fwd:.3f}; by launch (device ms) "
            f"{ {k: round(v, 4) for k, v in split.items()} }; {was}; library: none (no "
            f"single PyTorch call computes the recurrence's gradient)")
        if T == LM_TRAIN_SEQ:
            rows["rwkv6_scan_bwd"] = dict(
                name="rwkv6_scan_bwd", route="cuda",
                source="src/repro_torch/csrc/rwkv6_scan_bwd.cu", replaces=SCAN_BWD_REPLACES,
                launches=0, max_abs_err=train_err, ms=dev, device_ms=dev, events_ms=events,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms,
                library_ms=None, fwd_ms=fwd, bwd_over_fwd=dev / fwd,
                shape=f"B=8 H=40 T={T} DK=64 bf16, dS_T none (rwkv6-3b training)")
            if parent_commit is not None:
                rows["rwkv6_scan_bwd"]["parent_events_ms"] = parent
        del sets, bwd_sets, fwd_sets
    torch.cuda.synchronize()


def phase_train_lm_smoke(smi):
    """13b: the smoke RWKV-6 (2 layers, d 128): f32 step-0 gradients card
    vs CPU leaf by leaf, then LM_SMOKE_STEPS ``lm_train_step``s on the CPU
    (plain versions) and on the card (kernels) from the same weights and
    batches, in f32 (losses within 1e-3) and in bf16 (within
    TOL_LM_BF16_LOSS); the card's launches held to one ``rwkv6_scan`` and
    one ``rwkv6_scan_bwd`` a layer and step."""
    import torch
    from repro_torch.checkpoint.io import flatten
    from repro_torch.configs import get_smoke
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_train_step
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_map
    cfg = get_smoke("rwkv6-3b")
    api = get_model(cfg)
    it = token_batches(cfg.vocab_size, LM_SMOKE_BATCH, LM_SMOKE_SEQ, seed=5)
    data = [next(it) for _ in range(LM_SMOKE_STEPS)]
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, TOL_LM_BF16_LOSS)):
        name = str(dtype)[6:]
        params = api.init(cfg, generator=torch.Generator().manual_seed(4), dtype=dtype)
        if dtype == torch.float32:
            grads = {}
            for dev in ("cpu", "cuda"):
                live = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True),
                                params)
                loss, _ = api.loss_fn(live, _to(data[0], dev), cfg)
                grads[dev] = torch.autograd.grad(loss, tree_leaves(live))
            _compare_grads(f"13b [{smi}] smoke RWKV-6 f32 step-0 gradients, card vs cpu",
                           grads["cuda"], grads["cpu"], [n for n, _ in flatten(params)[0]],
                           cfg.d_ff + LM_SMOKE_SEQ)
        losses = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.detach().to(dev, copy=True), params)
            opt = adamw_init(p)
            ops.reset_launches()
            t0 = time.perf_counter()
            out = []
            for b in data:
                p, opt, m = lm_train_step(p, opt, _to(b, dev), cfg, total=LM_SMOKE_STEPS)
                out.append(m["loss"])
            losses[dev] = [float(x) for x in out]
            counts = dict(ops.LAUNCHES)
            log(f"  13b [{smi}] smoke RWKV-6 {name} on {dev}: {LM_SMOKE_STEPS} steps in "
                f"{time.perf_counter() - t0:.3f} s, first losses "
                f"{[round(x, 5) for x in losses[dev][:3]]}, last "
                f"{[round(x, 5) for x in losses[dev][-3:]]}, launches {counts}")
        want = {k: 0 for k in ops.LAUNCHES}
        want["rwkv6_scan"] = want["rwkv6_scan_bwd"] = LM_SMOKE_STEPS * cfg.num_layers
        if counts != want:
            raise AssertionError(f"13b: launches {counts} differ from the plan's {want}")
        compare(f"13b [{smi}] smoke RWKV-6 {name} losses over {LM_SMOKE_STEPS} steps, card "
                f"vs cpu", torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
                dict(rtol=tol, atol=0.0))


def phase_train_lm_full(rows, smi):
    """13c: rwkv6-3b at full width and depth, bf16 params and f32 moments
    (``train_lm``'s), batch LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens: one
    warm-up step, then LM_TRAIN_TIMED timed steps with the launch counts
    set to 0 before them; then a serving prefill on the trained params,
    bit for bit against the same prefill with grad disabled."""
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_train_step
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import adamw_init
    cfg = get_config("rwkv6-3b")
    api = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params)
    it = token_batches(cfg.vocab_size, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=0, device="cuda")

    def step():
        nonlocal params, opt
        params, opt, m = lm_train_step(params, opt, next(it), cfg, total=1 + LM_TRAIN_TIMED)
        return m

    step()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    ms = [step() for _ in range(LM_TRAIN_TIMED)]
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / LM_TRAIN_TIMED
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in ms]
    gnorms = [float(m["grad_norm"]) for m in ms]
    want = {k: 0 for k in ops.LAUNCHES}
    want["rwkv6_scan"] = want["rwkv6_scan_bwd"] = LM_TRAIN_TIMED * cfg.num_layers
    n_params = sum(t.numel() for t in leaves(params).values())
    log(f"  13c [{smi}] rwkv6-3b ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params bf16, moments f32), batch {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ} tokens: {s_per_step:.4f} s/train-step over {LM_TRAIN_TIMED} steps "
        f"({LM_TRAIN_BATCH * LM_TRAIN_SEQ / s_per_step:.1f} tokens/s), max_memory_allocated "
        f"{peak:.3f} GiB, losses {[round(x, 5) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}, launches {counts}, planned {want}")
    if counts != want or not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError("13c: launches differ from the plan or the loss is not finite")
    rows["rwkv6_scan_bwd"]["launches"] = counts["rwkv6_scan_bwd"]
    rows["rwkv6_scan"]["launches_train"] = counts["rwkv6_scan"]
    # serving from the trained params: the kernels' no-grad path, untouched
    del opt, ms
    torch.cuda.empty_cache()
    prompts = next(token_batches(cfg.vocab_size, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=9,
                                 device="cuda"))["tokens"]
    ops.reset_launches()
    served, st = api.prefill(params, {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    with torch.no_grad():
        plain, pst = api.prefill(params, {"tokens": prompts}, cfg)
    same = (torch.equal(served, plain) and torch.equal(st["S"], pst["S"])
            and served.grad_fn is None)
    finite = bool(torch.isfinite(served).all())
    log(f"  13c [{smi}] prefill {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} on the trained params: "
        f"bit-identical to the grad-disabled prefill {same}, finite {finite}, shape "
        f"{tuple(served.shape)}, launches {counts}")
    if not (same and finite and counts == {"rwkv6_scan": cfg.num_layers}):
        raise AssertionError("13c: serving after training changed or missed the kernel")
    del params, served, plain, st, pst
    torch.cuda.empty_cache()
    return s_per_step, peak


# ---------------------------------------------------------------------------
# phase 14: the dense and MoE LMs (3L, their kernels at the LMs' shapes, runs
# in phase 3)
# ---------------------------------------------------------------------------
PEAK_BF16_FLOPS = HW.peak_flops_bf16 if HW else None   # H100 SXM tensor cores, dense
LM_NAMES = ("gemma2-9b", "qwen3-moe-30b-a3b", "qwen3-32b", "stablelm-12b",
            "deepseek-67b", "dbrx-132b")
SMOKE_PROMPT, SMOKE_DECODE = 16, 8        # past gemma2 smoke's window of 8
RING_SLOTS, RING_STEPS = 8, 20            # 14a: a ring shorter than the positions
G2_BATCH, G2_PROMPT, G2_DECODE = 4, 8128, 64   # 8,192 tokens: gemma2's context
G2_WINDOW = 4096
MOE_BATCH, MOE_PROMPT, MOE_DECODE = 8, 2048, 32
PLAIN_ROWS = 1024                         # 3L: the plain attention, query rows a chunk
ROUNDOFF_TERMS = 2.0 ** -14               # 3B: f32 roundoff, of the terms' magnitudes
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:70"


def _close_quiet(name: str, got, want, tol) -> float:
    """``compare`` without its line: the max abs error, raising on a miss."""
    g, w = got.float().cpu(), want.float().cpu()
    err = (g - w).abs()
    if bool((err > tol["atol"] + tol["rtol"] * w.abs()).any()) or not _finite(g):
        raise AssertionError(f"{name}: card and CPU disagree (max abs err "
                             f"{float(err.max()):.3e})")
    return float(err.max()) if err.numel() else 0.0


def _finite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def _flash_count(pred) -> int:
    """``flash_attention``'s launches since the counts were last reset
    whose shape key (B, Sq, Sk, H, KVH, Dh, causal, window, softcap;
    ``ops.FLASH_SHAPES``) satisfies ``pred``: a row's measured count."""
    from repro_torch.kernels import ops
    return sum(n for key, n in ops.FLASH_SHAPES.items() if pred(*key))


def _row_tol_ratio(got, want, tol, *, terms=None):
    """(max abs err, max err over its query row's RMS, max err over its
    tolerance) of ``got`` against ``want`` (B, Sq, H, Dh): the tolerance is
    ``tol["atol"]`` times the RMS over Dh of ``want``'s (b, query, head)
    row plus ``tol["rtol"] |want|``.  A softmax over n kept unit-variance
    keys gives outputs of RMS about sqrt(e / n) (0.026 at 4,096 keys), so
    an absolute atol of TOL_BF16's 2e-2 would be as large as the output;
    the kernel's own error (bf16 rounding of P and of the output) scales
    with the row's RMS.  ``terms`` (gradients; ``want``'s shape): the sum
    of the magnitudes of each element's terms, of which ROUNDOFF_TERMS is
    added to its tolerance.  A gradient element is a sum whose terms
    cancel (sum_j P_ij (dP_ij - D_i) = 0; under a causal mask the first
    query's dq is 0 up to roundoff), so both sides carry f32 noise of the
    size of its terms, not of its row (in f32 at qwen3-32b's training
    shape on an H100, 4.4e-5 of the tensor's RMS on a row of 1e-3 of it;
    at zamba2's, 9.2e-5 of the magnitudes of P (|dP| + |D|) |K|, since
    dP - D itself cancels; at most 5.0e-6 of the magnitudes of every
    operand at each 3B shape, so 2^-14 leaves 12x)."""
    import torch
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    err = (g - w).abs()
    lim = tol["atol"] * rms + tol["rtol"] * w.abs()
    if terms is not None:
        lim = lim + ROUNDOFF_TERMS * terms
    lim = lim.clamp_min(1e-30)
    if not bool(torch.isfinite(g).all()):
        return float("inf"), float("inf"), float("inf")
    return (float(err.max()), float((err / rms.clamp_min(1e-30)).max()),
            float((err / lim).max()))


def _flash_lm_row(smi, gen, label, shape, opts, *, iters=0, k_pos_fn=None, launches=0,
                  faults=(), tag="3L"):
    """One 3L row: the flash kernel with KV-cache masks against its plain
    version, to TOL_BF16 (TOL_F32 in f32) with the atol in units of each
    query row's RMS (:func:`_row_tol_ratio`); then each planted fault of
    ``faults`` ((label, options that override the kernel's)) must fail
    that check; with ``iters`` (0: a check, no row, no profiler trace)
    timed by CUDA events and by device time; the plain version's time;
    ``scaled_dot_product_attention`` with ``enable_gqa`` (no softcap: SDPA
    has none; causal by ``is_causal`` where the mask is the plain causal
    one, no mask where it keeps every pair, else the mask as a bool
    ``attn_mask``); the bound over the (query, key) pairs the mask keeps
    and the K and V of the slots some query keeps, at the bf16 or 3xTF32
    tensor-core peak.  ``tag`` starts each line (3L, 3F)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.timing import device_ms, time_ms
    B, Sq, Sk, H, KVH, Dh, dtype = shape
    q = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KVH, Dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KVH, Dh), generator=gen, device="cuda").to(dtype)
    if k_pos_fn is not None:
        opts = dict(opts, k_pos=k_pos_fn(Sk))
    run = lambda: ops.flash_attention(q, k, v, **opts)   # noqa: E731
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    want = ref.flash_attention_ref(q, k, v, rows=PLAIN_ROWS, **opts)
    name = (f"{tag} [{smi}] flash {label} B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} Dh={Dh} "
            f"{str(dtype)[6:]} { {n: o for n, o in opts.items() if n != 'k_pos'} }")
    err, err_rms, ratio = _row_tol_ratio(run(), want, tol)
    log(f"  {name}: max_abs_err {err:.3e}, {err_rms:.3e} of its row's RMS, "
        f"{ratio:.3f} of its tolerance (rtol={tol['rtol']}, atol={tol['atol']} x the "
        f"row's RMS) {'ok' if ratio <= 1 else 'FAIL'}")
    if ratio > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    for fault, override in faults:
        _, f_rms, f_ratio = _row_tol_ratio(
            ops.flash_attention(q, k, v, **dict(opts, **override)), want, tol)
        log(f"  {tag} [{smi}] flash {label}, planted fault ({fault}): max err {f_rms:.3e} of "
            f"its row's RMS, {f_ratio:.3f} of the tolerance "
            f"{'rejected' if f_ratio > 1 else 'NOT REJECTED'}")
        if f_ratio <= 1:
            raise AssertionError(f"{name}: the check does not reject {fault}")
    del want
    if not iters:
        del q, k, v
        return None
    ms = time_ms(run, iters)
    dev = device_ms(run, iters)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, rows=PLAIN_ROWS, **opts), 1)
    mask = ref.attention_mask(Sq, Sk, causal=opts.get("causal", False),
                              window=opts.get("window"), device="cuda",
                              q_offset=opts.get("q_offset", 0), k_pos=opts.get("k_pos"),
                              one_sided=opts.get("one_sided_window", False))
    kept = int(mask.sum())
    kept_slots = int(mask.any(0).sum())
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    plain_causal = (opts.get("causal") and opts.get("window") is None
                    and opts.get("k_pos") is None and not opts.get("q_offset") and Sq == Sk)
    unmasked = (not opts.get("causal") and opts.get("window") is None
                and opts.get("k_pos") is None)
    if plain_causal:
        lib_fn = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    elif unmasked:
        lib_fn = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, enable_gqa=True)
    else:
        lib_fn = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib = time_ms(lib_fn, iters)
    del qt, kt, vt
    flops = 4.0 * B * H * kept * Dh
    es = q.element_size()
    # q read and out written whole; K and V only at the slots some query
    # keeps (the output depends on no other); k_pos whole
    nbytes = es * (2 * B * Sq * H * Dh + 2 * B * kept_slots * KVH * Dh) \
        + (4 * Sk if opts.get("k_pos") is not None else 0)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3
    b_ms, b_by = bound(flops, nbytes, peak)
    lib_mask = (", is_causal" if plain_causal else ", no mask" if unmasked
                else ", bool attn_mask")
    log(f"  {tag} [{smi}] flash {label}: kernel {ms:.4f} ms events, {dev:.4f} ms device, "
        f"plain {plain:.4f} ms (query chunks of {PLAIN_ROWS}), scaled_dot_product_attention "
        f"(enable_gqa, no softcap{lib_mask}) "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {kept} kept (query, key) pairs of "
        f"{Sq * Sk}, K and V of {kept_slots} of {Sk} slots; "
        f"{flops / dev / 1e9:.1f} TFLOP/s of them on the device)")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu", replaces=FLASH_REPLACES,
                launches=launches, max_abs_err=err, ms=ms, device_ms=dev, events_ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                shape=f"{label}: B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} Dh={Dh} "
                      f"{str(dtype)[6:]}")


def _ring_k_pos(pos: int):
    """k_pos of a ring of Sk slots after the write at ``pos``
    (``dense.ring_k_pos``, what decode builds once a step)."""
    def make(Sk: int):
        from repro_torch.models import dense
        return dense.ring_k_pos(pos, Sk, "cuda")
    return make


def phase_lm_kernels(rows, smi):
    """3L, in phase 3 before 3G: the flash kernel with its KV-cache masks
    at the dense LMs' shapes, and ``expert_ffn`` at qwen3-moe-30b-a3b's
    bf16 shapes, each against its plain version and timed (phase 14 adds
    the launches of the rows it runs)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.timing import device_ms, time_ms
    gen = torch.Generator(device="cuda").manual_seed(24)
    bf16 = torch.bfloat16
    g2 = (G2_BATCH, G2_PROMPT, G2_PROMPT, 16, 8, 256, bf16)
    cap = dict(causal=True, softcap=50.0, one_sided_window=True)
    rows["flash_attention gemma2 prefill local"] = _flash_lm_row(
        smi, gen, "gemma2-9b prefill, local layer (window 4096)", g2,
        dict(cap, window=G2_WINDOW), iters=3,
        faults=(("the window dropped", dict(window=None)),
                ("q_offset off by one", dict(q_offset=1))))
    rows["flash_attention gemma2 prefill global"] = _flash_lm_row(
        smi, gen, "gemma2-9b prefill, global layer", g2, cap, iters=3)
    ring = (G2_BATCH, 1, G2_PROMPT + G2_DECODE, 16, 8, 256, bf16)
    last = G2_PROMPT + G2_DECODE - 1
    rows["flash_attention gemma2 decode local"] = _flash_lm_row(
        smi, gen, "gemma2-9b decode, local layer at the last position", ring,
        dict(cap, window=G2_WINDOW, q_offset=last), iters=50, k_pos_fn=_ring_k_pos(last),
        faults=(("the window dropped", dict(window=None)),
                ("q_offset off by one", dict(q_offset=last - 1))))
    rows["flash_attention gemma2 decode global"] = _flash_lm_row(
        smi, gen, "gemma2-9b decode, global layer at the first decode position", ring,
        dict(cap, q_offset=G2_PROMPT), iters=50, k_pos_fn=_ring_k_pos(G2_PROMPT))
    # empty slots (the ring not yet full) and a wrapped ring, window 4096:
    # checks, not timed
    for pos in (5000, 3 * 8192 + 1234):
        wrapped = pos >= ring[2]
        _flash_lm_row(smi, gen, f"ring at position {pos}", ring,
                      dict(cap, window=G2_WINDOW, q_offset=pos),
                      k_pos_fn=_ring_k_pos(pos),
                      faults=(("ring slots read in index order", dict(k_pos=None)),)
                      if wrapped else ())
    # qwen3-moe-30b-a3b's attention (32 heads over 4 kv heads of 128, qk-norm
    # before it): 14c's prefill and its first decode position
    qm = (MOE_BATCH, MOE_PROMPT, MOE_PROMPT, 32, 4, 128, bf16)
    rows["flash_attention qwen3-moe prefill"] = _flash_lm_row(
        smi, gen, "qwen3-moe-30b-a3b prefill", qm,
        dict(causal=True, one_sided_window=True), iters=10)
    qd = (MOE_BATCH, 1, MOE_PROMPT + MOE_DECODE, 32, 4, 128, bf16)
    rows["flash_attention qwen3-moe decode"] = _flash_lm_row(
        smi, gen, "qwen3-moe-30b-a3b decode at the first decode position", qd,
        dict(causal=True, q_offset=MOE_PROMPT, one_sided_window=True), iters=50,
        k_pos_fn=_ring_k_pos(MOE_PROMPT))
    rows["flash_attention stablelm Dh 160"] = _flash_lm_row(
        smi, gen, "stablelm-12b's head dim 160 (the Dh 256 instance)",
        (2, 2048, 2048, 32, 8, 160, bf16), dict(causal=True, one_sided_window=True),
        iters=10)
    # a chunk of queries continuing a partly written cache, off the 128-row
    # query tile and the 16-key tile: q_offset 757, kv_valid_len 887
    valid = lambda Sk: torch.where(torch.arange(Sk, device="cuda") < 887,   # noqa: E731
                                   torch.arange(Sk, device="cuda"), -1).to(torch.int32)
    rows["flash_attention q_offset kv_valid_len"] = _flash_lm_row(
        smi, gen, "q_offset 757, kv_valid_len 887", (2, 130, 1000, 8, 2, 128, bf16),
        dict(causal=True, q_offset=757, one_sided_window=True), iters=20, k_pos_fn=valid)
    rows["flash_attention one-sided window"] = _flash_lm_row(
        smi, gen, "non-causal one-sided window 40 (layers.attention, C.9)",
        (2, 200, 200, 4, 4, 64, torch.float32),
        dict(causal=False, window=40, one_sided_window=True), iters=20)

    # expert_ffn at qwen3-moe-30b-a3b's bf16 shapes: 8 x 2048 prefill tokens
    # (capacity 1280) and 8 decode tokens (the capacity floor of 8)
    for C, label in ((1280, "prefill"), (8, "decode")):
        E, d, f = 128, 2048, 768
        args = _expert_inputs(gen, E, C, d, f, bf16)
        err = compare(f"3L [{smi}] expert_ffn qwen3-moe {label} E={E} C={C} d={d} f={f} "
                      f"bf16 silu", ops.expert_ffn(*args), ref.expert_ffn_ref(*args),
                      TOL_BF16)
        ms = time_ms(lambda: ops.expert_ffn(*args), 20)
        dev = device_ms(lambda: ops.expert_ffn(*args), 20)
        plain = time_ms(lambda: ref.expert_ffn_ref(*args), 5)
        x, wg, wu, wd = args
        h = torch.randn((E, C, f), device="cuda").to(bf16)
        yard = time_ms(lambda: (torch.bmm(x, wg), torch.bmm(x, wu), torch.bmm(h, wd)), 20)
        flops = 6.0 * E * C * d * f
        nbytes = 2.0 * (2 * E * C * d + 3 * E * d * f)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        log(f"  3L [{smi}] expert_ffn qwen3-moe {label}: kernel {ms:.4f} ms events, "
            f"{dev:.4f} ms device ({flops / dev / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, "
            f"three-bmm bf16 yardstick {yard:.4f} ms; library: none (no single PyTorch "
            f"call computes the gated MLP); bound {b_ms:.4f} ms ({b_by}, bf16 peak)")
        rows[f"expert_ffn qwen3-moe {label}"] = dict(
            name="expert_ffn", route="cuda", source="src/repro_torch/csrc/expert_ffn.cu",
            replaces="src/repro/kernels/expert_ffn.py:69", launches=0, max_abs_err=err,
            ms=ms, device_ms=dev, events_ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, yardstick_ms=yard,
            shape=f"E={E} C={C} d={d} f={f} bf16 silu (qwen3-moe-30b-a3b {label})")
        del args, x, wg, wu, wd, h
    torch.cuda.empty_cache()


def phase_lm_smoke_card(smi):
    """14a: each dense and MoE ``smoke()`` config, f32 and bf16 params from
    one seed, prefilled with 2 x SMOKE_PROMPT tokens and decoded
    SMOKE_DECODE steps on the CPU (plain versions) and on the card
    (kernels); each CPU decode step starts from the card's cache, so a
    bf16 value that rounds to the other neighbour on one device cannot
    build up over the steps.  Then gemma2's smoke model with
    ``long_context=True`` decoded from position 0 into a ring of
    RING_SLOTS slots, shorter than the positions it reaches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.models import dense
    from repro_torch.models.api import get_model
    P, D = SMOKE_PROMPT, SMOKE_DECODE
    for name in LM_NAMES:
        cfg = get_smoke(name)
        api = get_model(cfg)
        toks = torch.from_numpy(np.random.default_rng(14).integers(
            0, cfg.vocab_size, (2, P + D), dtype=np.int32))
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            params = api.init(cfg, generator=torch.Generator().manual_seed(14), dtype=dtype)
            p_gpu = _to(params, "cuda")
            ops.reset_launches()
            with torch.no_grad():
                lg_g, c_g = api.prefill(p_gpu, {"tokens": toks[:, :P].cuda()}, cfg,
                                        cache_len=P + D)
                lg_c, c_c = api.prefill(params, {"tokens": toks[:, :P]}, cfg,
                                        cache_len=P + D)
                tag = f"14a [{smi}] {cfg.name} {str(dtype)[6:]}"
                errs = [_close_quiet(f"{tag} prefill logits", lg_g, lg_c, tol),
                        _close_quiet(f"{tag} prefill cache k", c_g["k"], c_c["k"], tol),
                        _close_quiet(f"{tag} prefill cache v", c_g["v"], c_c["v"], tol)]
                for t in range(P, P + D):
                    c_c = {"k": c_g["k"].cpu(), "v": c_g["v"].cpu(), "pos": c_g["pos"]}
                    lg_c, c_c = api.decode_step(params, {"token": toks[:, t]}, c_c, cfg)
                    lg_g, c_g = api.decode_step(p_gpu, {"token": toks[:, t].cuda()}, c_g, cfg)
                    errs.append(_close_quiet(f"{tag} decode {t} logits", lg_g, lg_c, tol))
                    errs.extend(_close_quiet(f"{tag} decode {t} cache {n}", c_g[n], c_c[n], tol)
                                for n in ("k", "v"))
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.LAUNCHES.items() if v}
            want = {"flash_attention": cfg.num_layers * (1 + D)}
            if cfg.is_moe:
                want["expert_ffn"] = cfg.num_layers * (1 + D)
            log(f"  {tag}: prefill {P} + {D} decode steps, cuda vs cpu max abs err "
                f"{max(errs):.3e} (tol rtol={tol['rtol']} atol={tol['atol']}), launches "
                f"{counts}, planned {want}")
            if counts != want:
                raise AssertionError(f"{tag}: launches differ from the plan")
    cfg = get_smoke("gemma2-9b")
    api = get_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (2, RING_STEPS), dtype=np.int32))
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        params = api.init(cfg, generator=torch.Generator().manual_seed(15), dtype=dtype)
        p_gpu = _to(params, "cuda")
        c_g = api.init_cache(cfg, 2, RING_SLOTS, dtype=dtype, device="cuda")
        errs = []
        with torch.no_grad():
            for t in range(RING_STEPS):
                c_c = {"k": c_g["k"].cpu(), "v": c_g["v"].cpu(), "pos": c_g["pos"]}
                lg_c, _ = api.decode_step(params, {"token": toks[:, t]}, c_c, cfg,
                                          long_context=True)
                lg_g, c_g = api.decode_step(p_gpu, {"token": toks[:, t].cuda()}, c_g, cfg,
                                            long_context=True)
                errs.append(_close_quiet(f"14a ring step {t}", lg_g, lg_c, tol))
        log(f"  14a [{smi}] {cfg.name} {str(dtype)[6:]} long_context ring: {RING_STEPS} "
            f"decode steps into {RING_SLOTS} slots (windows "
            f"{dense.layer_windows(cfg, long_context=True)}), "
            f"cuda vs cpu max abs err {max(errs):.3e} (tol rtol={tol['rtol']} "
            f"atol={tol['atol']})")


def _greedy(api, params, cfg, prompts, steps: int, cache_len: int, extra=None,
            pad: int = 0):
    """Prefill then ``steps`` greedy decode steps, each timed between
    synchronisations; returns (streamed logits list, generated tokens,
    prefill s, decode s, flash/expert_ffn launches of the prefill).
    ``extra``: the stub modality inputs of the prefill's batch; ``pad``:
    zero slots appended to the self cache after the prefill (the
    encoder-decoder's prefill returns exactly the prompt's, as the
    reference's does)."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        last, cache = api.prefill(params, {"tokens": prompts, **(extra or {})}, cfg,
                                  cache_len=cache_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    if pad:
        from repro_torch.models import encdec
        cache = encdec.pad_cache(cache, pad)
    tok = last.argmax(-1)
    generated, streamed = [], [last]
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(steps):
            generated.append(tok)
            lg, cache = api.decode_step(params, {"token": tok}, cache, cfg)
            streamed.append(lg)
            tok = lg.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del cache
    return streamed, torch.stack(generated, 1), prefill_s, decode_s, prefill_counts


def phase_gemma2_full(rows, smi):
    """14b: gemma2-9b at full width and depth, bf16 params from seed 0: a
    warm-up prefill of 4 x 256, then G2_BATCH prompts of G2_PROMPT tokens
    and G2_DECODE greedy decode steps (8,192 tokens, gemma2's context)
    with the launch counts set to 0 before and read after; then one
    teacher-forced pass over prompt + generated tokens, unembedding only
    the positions it compares ((4, 8192, 256000) bf16 logits would be
    16.8 GB)."""
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.models import dense
    from repro_torch.models.api import get_model
    cfg = get_config("gemma2-9b")
    api = get_model(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = api.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params).values())
    log(f"  14b [{smi}] gemma2-9b params: {n_params / 1e9:.3f} B bf16 "
        f"({2 * n_params / 1e9:.2f} GB) on the card, init {time.perf_counter() - t0:.3f} s; "
        f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim} "
        f"(kv {cfg.num_kv_heads}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, windows "
        f"{G2_WINDOW} on even layers")
    prompts = next(token_batches(cfg.vocab_size, G2_BATCH, G2_PROMPT, seed=0,
                                 device="cuda"))["tokens"]
    _greedy(api, params, cfg, prompts[:, :256], 2, 258)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    streamed, gen_tokens, prefill_s, decode_s, pre = _greedy(
        api, params, cfg, prompts, G2_DECODE, G2_PROMPT + G2_DECODE)
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_pre = {"flash_attention": cfg.num_layers}
    want = {"flash_attention": cfg.num_layers * (1 + G2_DECODE)}
    log(f"  14b [{smi}] prefill {G2_BATCH} x {G2_PROMPT}: {prefill_s:.4f} s "
        f"({G2_BATCH * G2_PROMPT / prefill_s:.1f} tokens/s); decode {G2_DECODE} steps x "
        f"{G2_BATCH}: {1e3 * decode_s / G2_DECODE:.4f} ms/step "
        f"({G2_BATCH * G2_DECODE / decode_s:.1f} tokens/s); max_memory_allocated "
        f"{peak:.3f} GiB; launches prefill {pre} (planned {want_pre}), all {counts} "
        f"(planned {want})")
    if pre != want_pre or counts != want:
        raise AssertionError("14b: gemma2-9b's launches differ from one flash call a layer")
    for key, local in (("local", True), ("global", False)):
        rows[f"flash_attention gemma2 prefill {key}"]["launches"] = _flash_count(
            lambda B, Sq, Sk, H, KVH, Dh, c, w, sc: Sq > 1 and (w is not None) == local)
        rows[f"flash_attention gemma2 decode {key}"]["launches"] = _flash_count(
            lambda B, Sq, Sk, H, KVH, Dh, c, w, sc: Sq == 1 and (w is not None) == local)
    streamed = torch.stack(streamed, 1)                        # (B, 65, V)
    P = G2_PROMPT
    with torch.no_grad():
        full = torch.cat([prompts, gen_tokens.to(prompts.dtype)], 1)
        x, _ = dense.forward_hidden(params, full, cfg)
        forced = dense._unembed(params, x[:, P - 1:], cfg)
    del x
    torch.cuda.synchronize()
    finite = _finite(streamed) and _finite(forced)
    # TOL_STREAM_DEEP at every position, the last prompt one too: bf16 over
    # 42 layers, and the prefill (8,128 rows a GEMM), the decode steps (4)
    # and the forced pass (8,192) run cuBLAS kernels that round apart
    err = (streamed.float() - forced.float()).abs().amax(dim=(0, 2))
    agree = float((streamed[:, 1:].argmax(-1) == forced[:, 1:].argmax(-1)).float().mean())
    log(f"  14b [{smi}] streamed vs teacher-forced max |diff| at the last prompt "
        f"position {float(err[0]):.4e}, over {G2_DECODE} decode positions "
        f"{float(err[1:].max()):.4e} (tol {TOL_STREAM_DEEP} for both), greedy tokens agree "
        f"{agree:.4f} (min {MIN_GREEDY_AGREE}); forced logits std "
        f"{float(forced.float().std()):.4f}, finite {finite}; peak with the forced pass "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not finite or tuple(streamed.shape) != (G2_BATCH, G2_DECODE + 1, cfg.vocab_size):
        raise AssertionError("14b: logits are not finite or have the wrong shape")
    if float(err.max()) > TOL_STREAM_DEEP or agree < MIN_GREEDY_AGREE:
        raise AssertionError("14b: streamed logits disagree with teacher forcing")
    del params, streamed, forced
    torch.cuda.empty_cache()
    return prefill_s, decode_s / G2_DECODE, peak


def phase_moe_full(rows, smi):
    """14c: qwen3-moe-30b-a3b at full width and depth (48 layers, 30.5 B
    params, 61 GB in bf16), bf16 params from seed 0: a warm-up prefill, then
    MOE_BATCH prompts of MOE_PROMPT tokens and MOE_DECODE greedy decode
    steps, launches held to one flash and one ``expert_ffn`` call a layer
    and pass.  Teacher forcing is no check here: capacity-based routing
    drops other pairs for 16,640 tokens than for 8."""
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model
    cfg = get_config("qwen3-moe-30b-a3b")
    api = get_model(cfg)
    n_layers = cfg.num_layers
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = api.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params).values())
    log(f"  14c [{smi}] qwen3-moe-30b-a3b at full width and depth, {n_layers} layers: "
        f"{n_params / 1e9:.3f} B params bf16 on the card ({held:.3f} GiB held before "
        f"them), init {time.perf_counter() - t0:.3f} s; d {cfg.d_model}, {cfg.num_heads} heads x "
        f"{cfg.head_dim} (kv {cfg.num_kv_heads}), {cfg.num_experts} experts top-"
        f"{cfg.experts_per_token}, f {cfg.expert_d_ff}, vocab {cfg.vocab_size}")
    prompts = next(token_batches(cfg.vocab_size, MOE_BATCH, MOE_PROMPT, seed=1,
                                 device="cuda"))["tokens"]
    _greedy(api, params, cfg, prompts[:, :256], 2, 258)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    streamed, _, prefill_s, decode_s, pre = _greedy(
        api, params, cfg, prompts, MOE_DECODE, MOE_PROMPT + MOE_DECODE)
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_pre = {"flash_attention": n_layers, "expert_ffn": n_layers}
    want = {k: n_layers * (1 + MOE_DECODE) for k in want_pre}
    streamed = torch.stack(streamed, 1)
    finite = _finite(streamed)
    log(f"  14c [{smi}] prefill {MOE_BATCH} x {MOE_PROMPT}: {prefill_s:.4f} s "
        f"({MOE_BATCH * MOE_PROMPT / prefill_s:.1f} tokens/s); decode {MOE_DECODE} steps x "
        f"{MOE_BATCH}: {1e3 * decode_s / MOE_DECODE:.4f} ms/step "
        f"({MOE_BATCH * MOE_DECODE / decode_s:.1f} tokens/s); max_memory_allocated "
        f"{peak:.3f} GiB; logits finite {finite}, shape {tuple(streamed.shape)}; launches "
        f"prefill {pre} (planned {want_pre}), all {counts} (planned {want})")
    if pre != want_pre or counts != want:
        raise AssertionError("14c: launches differ from one flash and one expert_ffn "
                             "call a layer")
    if not finite or tuple(streamed.shape) != (MOE_BATCH, MOE_DECODE + 1, cfg.vocab_size):
        raise AssertionError("14c: logits are not finite or have the wrong shape")
    rows["expert_ffn qwen3-moe prefill"]["launches"] = n_layers
    rows["expert_ffn qwen3-moe decode"]["launches"] = n_layers * MOE_DECODE
    for key, one in (("prefill", False), ("decode", True)):
        rows[f"flash_attention qwen3-moe {key}"]["launches"] = _flash_count(
            lambda B, Sq, *_: (Sq == 1) == one)
    del params, streamed
    torch.cuda.empty_cache()
    return prefill_s, decode_s / MOE_DECODE, peak


# ---------------------------------------------------------------------------
# phase 15: the hybrid, audio and VLM families (3F, their flash shapes, runs
# in phase 3)
# ---------------------------------------------------------------------------
HYB_BATCH, HYB_PROMPT, HYB_DECODE = 4, 4096, 32
AUD_BATCH, AUD_PROMPT, AUD_DECODE = 4, 256, 32   # over the config's 4,096 frames
VLM_BATCH, VLM_PROMPT, VLM_DECODE = 4, 2048, 32  # and its 1,601 image tokens
# zamba2 under f32 params still keeps its conv tail and KV cache in bf16 (the
# reference's rounding points): an element whose card and CPU f32 values
# straddle a bf16 rounding boundary rounds one ulp apart and moves the logits
# by up to about 1e-3 (tests/test_torch_zamba2.py's CACHE_TOL); its bf16
# leaves are held one bf16 ulp (2^-7) wider
TOL_F32_BF16_STATE = dict(rtol=1e-4, atol=5e-3)
# the families' bf16 smoke models stack 5 to 8 blocks (zamba2's each with
# a chain of bf16 roundings: conv taps, silu, gating), and the flash kernel
# rounds P to bf16 where its plain version keeps f32: card against CPU they
# are held to the bf16 tolerance of the CPU tests against the JAX package
# (tests/test_torch_dense.py's MODEL_TOL; zamba2-smoke's prefill logits
# were 3.9e-2 apart in PR 25's first card run, past TOL_BF16)
TOL_FAMILY_BF16 = dict(rtol=5e-2, atol=5e-2)


def phase_family_kernels(rows, smi):
    """3F, in phase 3 after 3L: the flash kernel at the hybrid, audio and
    VLM families' bf16 shapes, each against its plain version and timed as
    the 3L rows (phase 15 adds the launches of the main paths' calls)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(25)
    bf16 = torch.bfloat16
    P, n = HYB_PROMPT, HYB_PROMPT + HYB_DECODE
    causal = dict(causal=True, one_sided_window=True)
    full = dict(causal=False, one_sided_window=True)

    def valid(Sk):                                   # kv_valid_len P: the prompt's slots
        idx = torch.arange(Sk, device="cuda", dtype=torch.int32)
        return torch.where(idx < P, idx, -1)

    rows["flash_attention zamba2 prefill"] = _flash_lm_row(
        smi, gen, "zamba2-7b prefill (the prompt in the 4,128-slot cache)",
        (HYB_BATCH, P, n, 32, 32, 112, bf16), causal, iters=3, k_pos_fn=valid, tag="3F")
    rows["flash_attention zamba2 decode"] = _flash_lm_row(
        smi, gen, "zamba2-7b decode at the first decode position",
        (HYB_BATCH, 1, n, 32, 32, 112, bf16), dict(causal, q_offset=P), iters=50,
        k_pos_fn=_ring_k_pos(P), tag="3F")
    F_ = 4096
    rows["flash_attention seamless encoder"] = _flash_lm_row(
        smi, gen, "seamless-m4t-large-v2 encoder over 4,096 frames",
        (AUD_BATCH, F_, F_, 16, 16, 64, bf16), full, iters=5, tag="3F")
    rows["flash_attention seamless cross prefill"] = _flash_lm_row(
        smi, gen, "seamless-m4t-large-v2 decoder prompt's cross-attention",
        (AUD_BATCH, AUD_PROMPT, F_, 16, 16, 64, bf16), full, iters=10, tag="3F")
    rows["flash_attention seamless cross decode"] = _flash_lm_row(
        smi, gen, "seamless-m4t-large-v2 decode's cross-attention",
        (AUD_BATCH, 1, F_, 16, 16, 64, bf16), full, iters=50, tag="3F")
    Ti, P, n = 1601, VLM_PROMPT, VLM_PROMPT + VLM_DECODE
    rows["flash_attention vlm self prefill"] = _flash_lm_row(
        smi, gen, "llama-3.2-vision-11b self-attention prefill",
        (VLM_BATCH, P, P, 32, 8, 128, bf16), causal, iters=5, tag="3F")
    rows["flash_attention vlm cross prefill"] = _flash_lm_row(
        smi, gen, "llama-3.2-vision-11b cross-attention prefill over 1,601 image keys",
        (VLM_BATCH, P, Ti, 32, 8, 128, bf16), full, iters=5, tag="3F")
    rows["flash_attention vlm self decode"] = _flash_lm_row(
        smi, gen, "llama-3.2-vision-11b self-attention decode at the first decode position",
        (VLM_BATCH, 1, n, 32, 8, 128, bf16), dict(causal, q_offset=P), iters=50,
        k_pos_fn=_ring_k_pos(P), tag="3F")
    rows["flash_attention vlm cross decode"] = _flash_lm_row(
        smi, gen, "llama-3.2-vision-11b cross-attention decode over 1,601 image keys",
        (VLM_BATCH, 1, Ti, 32, 8, 128, bf16), full, iters=50, tag="3F")
    torch.cuda.empty_cache()


def _flash_plan(cfg):
    """(flash calls in the prefill, flash calls a decode step) of a family."""
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2
        return zamba2.num_attn_blocks(cfg), zamba2.num_attn_blocks(cfg)
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    return cfg.num_layers, cfg.num_layers                 # vlm: self + cross


def _off_init(params, gen) -> None:
    """The SSD's A_log, dt_bias and D and the VLM's cross gates drawn off
    their init values (0, -4, 1: every head alike; gates 0: the cross path
    would add nothing), in place, from ``gen`` on its device."""
    import torch
    rand = lambda leaf: torch.rand(leaf.shape, generator=gen, device=gen.device)  # noqa: E731
    if "mamba" in params:
        m = params["mamba"]
        m["A_log"] = rand(m["A_log"]) * 2 - 1
        m["dt_bias"] = rand(m["dt_bias"]) * 5 - 4
        m["D"] = 0.5 + rand(m["D"])
    if "cross" in params:
        for g in ("gate_attn", "gate_mlp"):
            params["cross"][g] = 0.3 + 0.9 * rand(params["cross"][g])


def _family_smoke_configs():
    from repro_torch.configs import get_smoke
    z, v = get_smoke("zamba2-7b"), get_smoke("llama-3.2-vision-11b")
    return (z, z.replace(name="zamba2-smoke-ragged", num_layers=8),
            get_smoke("seamless-m4t-large-v2"),
            v, v.replace(name="llama-vision-smoke-ragged", num_layers=7))


def _state_errs(tag, got, want, tol, f32_model):
    """Max abs errors of a cache's tensor leaves, card against CPU; bf16
    leaves of an f32 model one bf16 ulp wider."""
    import torch
    errs = []
    for k, g in got.items():
        if not isinstance(g, torch.Tensor):
            assert g == want[k], (tag, k)
            continue
        t = dict(tol, rtol=2 ** -7) if f32_model and g.dtype == torch.bfloat16 else tol
        errs.append(_close_quiet(f"{tag} cache {k}", g, want[k], t))
    return errs


def phase_family_smoke_card(smi):
    """15a: the hybrid, audio and VLM ``smoke()`` configs and two ragged
    layouts, f32 and bf16 params from one seed (the SSD's and the gates'
    leaves off their init values), prefilled with 2 x SMOKE_PROMPT tokens
    (and the stub inputs) and decoded SMOKE_DECODE steps on the CPU and on
    the card; each CPU decode step starts from the card's state."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import stub_inputs
    from repro_torch.models import encdec
    from repro_torch.models.api import get_model
    P, D = SMOKE_PROMPT, SMOKE_DECODE
    for cfg in _family_smoke_configs():
        api = get_model(cfg)
        toks = torch.from_numpy(np.random.default_rng(15).integers(
            0, cfg.vocab_size, (2, P + D), dtype=np.int32))
        extra = stub_inputs(api, cfg, 2, torch.Generator().manual_seed(16))
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_FAMILY_BF16)):
            f32 = dtype == torch.float32
            if f32 and cfg.family == "hybrid":
                tol = TOL_F32_BF16_STATE
            gen = torch.Generator().manual_seed(15)
            params = api.init(cfg, generator=gen, dtype=dtype)
            _off_init(params, gen)
            p_gpu = _to(params, "cuda")
            kw = {} if cfg.family == "audio" else {"cache_len": P + D}
            tag = f"15a [{smi}] {cfg.name} {str(dtype)[6:]}"
            ops.reset_launches()
            with torch.no_grad():
                lg_g, c_g = api.prefill(p_gpu, {"tokens": toks[:, :P].cuda(),
                                                **_to(extra, "cuda")}, cfg, **kw)
                lg_c, c_c = api.prefill(params, {"tokens": toks[:, :P], **extra}, cfg, **kw)
                if cfg.family == "audio":
                    c_g, c_c = encdec.pad_cache(c_g, D), encdec.pad_cache(c_c, D)
                errs = [_close_quiet(f"{tag} prefill logits", lg_g, lg_c, tol)]
                errs += _state_errs(f"{tag} prefill", c_g, c_c, tol, f32)
                for t in range(P, P + D):
                    c_c = _to(c_g, "cpu")
                    lg_c, c_c = api.decode_step(params, {"token": toks[:, t]}, c_c, cfg)
                    lg_g, c_g = api.decode_step(p_gpu, {"token": toks[:, t].cuda()}, c_g, cfg)
                    errs.append(_close_quiet(f"{tag} decode {t} logits", lg_g, lg_c, tol))
                    errs += _state_errs(f"{tag} decode {t}", c_g, c_c, tol, f32)
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.LAUNCHES.items() if v}
            pre, step = _flash_plan(cfg)
            want = {"flash_attention": pre + D * step}
            log(f"  {tag}: prefill {P} + {D} decode steps, cuda vs cpu max abs err "
                f"{max(errs):.3e} (tol rtol={tol['rtol']} atol={tol['atol']}), launches "
                f"{counts}, planned {want}")
            if counts != want:
                raise AssertionError(f"{tag}: launches differ from the plan")
            del params, p_gpu


def _family_full(rows, smi, name, tag, batch, prompt, steps, row_shapes, *, pad=False):
    """One of 15b-15d: ``name`` at full width and depth, bf16 params from
    seed 0 (the SSD's and the gates' leaves off their init values), stub
    inputs from a seed: a warm-up prefill of 256 tokens, then ``batch``
    prompts of ``prompt`` tokens and ``steps`` greedy decode steps with the
    launch counts set to 0 before and read after; then one teacher-forced
    pass over prompt + generated tokens, unembedding only the compared
    positions.  ``row_shapes`` {3F row: predicate of a ``FLASH_SHAPES``
    key}: each row's launches, counted by shape at the wrapper over the
    prefill and the decode steps.  Returns (prefill s, decode s a step,
    peak GiB)."""
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import stub_inputs
    from repro_torch.models import dense, encdec, vlm, zamba2
    from repro_torch.models.api import get_model
    cfg = get_config(name)
    api = get_model(cfg)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(cfg, generator=gen)
    _off_init(params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params).values())
    log(f"  {tag} [{smi}] {name} at full width and depth: {n_params / 1e9:.3f} B params "
        f"bf16 ({2 * n_params / 1e9:.2f} GB) on the card ({held:.3f} GiB held before "
        f"them), init {time.perf_counter() - t0:.3f} s; {cfg.num_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, "
        f"d {cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim} (kv {cfg.num_kv_heads}), "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")
    prompts = next(token_batches(cfg.vocab_size, batch, prompt, seed=3,
                                 device="cuda"))["tokens"]
    extra = stub_inputs(api, cfg, batch, torch.Generator(device="cuda").manual_seed(4))
    pad = steps if pad else 0
    _greedy(api, params, cfg, prompts[:, :256], 2, 258, extra=extra,
            pad=2 if pad else 0)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    streamed, gen_tokens, prefill_s, decode_s, pre = _greedy(
        api, params, cfg, prompts, steps, prompt + steps, extra=extra, pad=pad)
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_pre, n_step = _flash_plan(cfg)
    want_pre = {"flash_attention": n_pre}
    want = {"flash_attention": n_pre + steps * n_step}
    log(f"  {tag} [{smi}] prefill {batch} x {prompt}: {prefill_s:.4f} s "
        f"({batch * prompt / prefill_s:.1f} tokens/s); decode {steps} steps x {batch}: "
        f"{1e3 * decode_s / steps:.4f} ms/step ({batch * steps / decode_s:.1f} tokens/s); "
        f"max_memory_allocated {peak:.3f} GiB; launches prefill {pre} (planned "
        f"{want_pre}), all {counts} (planned {want})")
    if pre != want_pre or counts != want:
        raise AssertionError(f"{tag}: {name}'s flash launches differ from the plan")
    for row, pred in row_shapes.items():
        rows[row]["launches"] = _flash_count(pred)
    streamed = torch.stack(streamed, 1)                          # (B, steps + 1, V)
    with torch.no_grad():
        full = torch.cat([prompts, gen_tokens.to(prompts.dtype)], 1)
        if cfg.family == "hybrid":
            forced = zamba2.forward(params, full, cfg)[0][:, prompt - 1:]
        elif cfg.family == "audio":
            forced = encdec.forward(params, full, extra["audio_frames"], cfg)[0][:, prompt - 1:]
        else:
            x = vlm.forward_hidden(params, full, extra["image_embeds"], cfg)
            forced = dense._unembed(params, x[:, prompt - 1:], cfg)
            del x
    torch.cuda.synchronize()
    finite = _finite(streamed) and _finite(forced)
    err = (streamed.float() - forced.float()).abs().amax(dim=(0, 2))
    agree = float((streamed[:, 1:].argmax(-1) == forced[:, 1:].argmax(-1)).float().mean())
    log(f"  {tag} [{smi}] streamed vs teacher-forced max |diff| at the last prompt "
        f"position {float(err[0]):.4e}, over {steps} decode positions "
        f"{float(err[1:].max()):.4e} (tol {TOL_STREAM_DEEP} for both), greedy tokens agree "
        f"{agree:.4f} (min {MIN_GREEDY_AGREE}); forced logits std "
        f"{float(forced.float().std()):.4f}, finite {finite}; peak with the forced pass "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not finite or tuple(streamed.shape) != (batch, steps + 1, cfg.vocab_size):
        raise AssertionError(f"{tag}: logits are not finite or have the wrong shape")
    if float(err.max()) > TOL_STREAM_DEEP or agree < MIN_GREEDY_AGREE:
        raise AssertionError(f"{tag}: streamed logits disagree with teacher forcing")
    del params, streamed, forced, extra
    torch.cuda.empty_cache()
    return prefill_s, decode_s / steps, peak


def phase_family_full(rows, smi):
    """15b-15d: zamba2-7b, seamless-m4t-large-v2 and llama-3.2-vision-11b at
    full width and depth, one after the other (each freed before the next);
    the 3F rows get their main-path launches, counted by shape."""
    _family_full(rows, smi, "zamba2-7b", "15b", HYB_BATCH, HYB_PROMPT, HYB_DECODE, {
        "flash_attention zamba2 prefill": lambda B, Sq, *_: Sq > 1,
        "flash_attention zamba2 decode": lambda B, Sq, *_: Sq == 1})
    _family_full(rows, smi, "seamless-m4t-large-v2", "15c", AUD_BATCH, AUD_PROMPT,
                 AUD_DECODE, {
                     "flash_attention seamless encoder":
                         lambda B, Sq, Sk, H, KVH, Dh, c, *_: not c and Sq == Sk,
                     "flash_attention seamless cross prefill":
                         lambda B, Sq, Sk, H, KVH, Dh, c, *_: not c and 1 < Sq != Sk,
                     "flash_attention seamless cross decode":
                         lambda B, Sq, Sk, H, KVH, Dh, c, *_: not c and Sq == 1},
                 pad=True)
    _family_full(rows, smi, "llama-3.2-vision-11b", "15d", VLM_BATCH, VLM_PROMPT,
                 VLM_DECODE, {
                     f"flash_attention vlm {kind} {when}":
                         (lambda B, Sq, Sk, H, KVH, Dh, c, *_, cr=kind == "cross",
                          one=when == "decode": c != cr and (Sq == 1) == one)
                     for kind in ("self", "cross") for when in ("prefill", "decode")})


# ---------------------------------------------------------------------------
# phase 16: training the dense, hybrid, audio and VLM families (the flash
# backward at their shapes runs in phase 3, lines 3B)
# ---------------------------------------------------------------------------
# 16a: the smoke configs (name, config overrides): stablelm also narrowed to
# its full config's head dim 160
LMT_SMOKE = (("qwen3-32b", {}), ("deepseek-67b", {}), ("zamba2-7b", {}),
             ("seamless-m4t-large-v2", {}), ("llama-3.2-vision-11b", {}), ("gemma2-9b", {}),
             ("stablelm-12b", {}), ("stablelm-12b", {"head_dim": 160}),
             ("qwen3-moe-30b-a3b", {}), ("dbrx-132b", {}))
# gemma2-9b's long-sequence training run: 1 x 6,144 tokens at 2 layers (one
# local, one global), its 8,192 context cut: at 8,192 the f32 and bf16
# logits over 256,000 words and their gradients (38 GB) on top of 2.23 B
# params' bf16 params and gradients and f32 moments ran out of the card's
# 80 GB in the second step (64.7 GiB allocated, 7.8 more asked; PERF.md
# §4); 6,144 still puts 2,048 queries past the 4,096 window
G2_TRAIN_SEQ = 6144
# 16b: (label, arch, layers (None: profile_train.LM_TRAIN_LAYERS'), batch, seq)
LMT_FULL = (("seamless-m4t-large-v2", "seamless-m4t-large-v2", None, 8, 128),
            ("qwen3-32b", "qwen3-32b", None, 8, 128),
            ("zamba2-7b", "zamba2-7b", None, 8, 128),
            ("llama-3.2-vision-11b", "llama-3.2-vision-11b", None, 8, 128),
            ("gemma2-9b", "gemma2-9b", None, 8, 128),
            ("gemma2-9b 6144", "gemma2-9b", 2, 1, G2_TRAIN_SEQ),
            ("stablelm-12b", "stablelm-12b", None, 8, 128),
            ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", None, 8, 128))
LMT_SMOKE_STEPS, LMT_SMOKE_BATCH, LMT_SMOKE_SEQ = 5, 2, 32   # 16a
LMT_TIMED = 4                                               # 16b, after a warm-up step
# the flash backward's LM training shapes (B, Sq, Sk, H, KVH, Dh, causal,
# window, softcap; ops.FLASH_BWD_SHAPES's key), at the reference CLI's 8 x
# 128 tokens and gemma2's 1 x 6,144 (and its 8,192 context, timed but not
# trained): (label, shape, the 16b run that trains it, its launches a
# step as a function of that run's config)
LMT_FLASH_SHAPES = (
    ("qwen3-32b self-attention (GQA 64 over 8)", (8, 128, 128, 64, 8, 128, True, None, None),
     "qwen3-32b", lambda c: c.num_layers),
    ("zamba2-7b shared block (Dh 112)", (8, 128, 128, 32, 32, 112, True, None, None),
     "zamba2-7b", lambda c: c.num_layers // c.hybrid_attn_every),
    ("seamless-m4t-large-v2 encoder over 4,096 frames",
     (8, 4096, 4096, 16, 16, 64, False, None, None),
     "seamless-m4t-large-v2", lambda c: c.encoder_layers),
    ("seamless-m4t-large-v2 decoder self-attention",
     (8, 128, 128, 16, 16, 64, True, None, None),
     "seamless-m4t-large-v2", lambda c: c.num_layers),
    ("seamless-m4t-large-v2 cross-attention over 4,096 frames",
     (8, 128, 4096, 16, 16, 64, False, None, None), "seamless-m4t-large-v2",
     lambda c: c.num_layers),
    ("llama-3.2-vision-11b self-attention (GQA 32 over 8)",
     (8, 128, 128, 32, 8, 128, True, None, None),
     "llama-3.2-vision-11b", lambda c: c.num_layers - c.num_layers // c.cross_attn_every),
    ("llama-3.2-vision-11b cross-attention over 1,601 image keys",
     (8, 128, 1601, 32, 8, 128, False, None, None), "llama-3.2-vision-11b",
     lambda c: c.num_layers // c.cross_attn_every),
    ("gemma2-9b local layer (window 4,096, softcap 50, Dh 256, GQA 16 over 8)",
     (8, 128, 128, 16, 8, 256, True, 4096, 50.0), "gemma2-9b", lambda c: (c.num_layers + 1) // 2),
    ("gemma2-9b global layer (softcap 50, Dh 256)", (8, 128, 128, 16, 8, 256, True, None, 50.0),
     "gemma2-9b", lambda c: c.num_layers // 2),
    ("gemma2-9b local layer over its 8,192-token context (not trained: 16b's is cut)",
     (1, 8192, 8192, 16, 8, 256, True, 4096, 50.0), None, None),
    ("gemma2-9b local layer over 6,144 tokens (the window bites)",
     (1, G2_TRAIN_SEQ, G2_TRAIN_SEQ, 16, 8, 256, True, 4096, 50.0), "gemma2-9b 6144",
     lambda c: (c.num_layers + 1) // 2),
    ("gemma2-9b global layer over 6,144 tokens",
     (1, G2_TRAIN_SEQ, G2_TRAIN_SEQ, 16, 8, 256, True, None, 50.0), "gemma2-9b 6144",
     lambda c: c.num_layers // 2),
    ("stablelm-12b (GQA 32 over 8, Dh 160)", (8, 128, 128, 32, 8, 160, True, None, None),
     "stablelm-12b", lambda c: c.num_layers),
    ("qwen3-moe-30b-a3b (GQA 32 over 4)", (8, 128, 128, 32, 4, 128, True, None, None),
     "qwen3-moe-30b-a3b", lambda c: c.num_layers),
)
# 3B checks off the main path, not timed: gemma2's head geometry with a
# window of 8 keys and a tight softcap over logits scaled 4x (q * 4), where
# the window's last key and the cap's factor 1 - (S/c)^2 each move the
# gradients far past the tolerance; stablelm's Dh 160 and a ragged Dh 200
# (label, shape, q scale, planted faults beyond the automatic ones: dK's
# last Dh tile dropped is one wherever Dh > 128)
LMT_FLASH_CHECKS = (
    ("gemma2 geometry, window 8, softcap 5 over 4x logits",
     (2, 128, 128, 16, 8, 256, True, 8, 5.0), 4.0, ("window", "softcap")),
    ("stablelm geometry, non-causal one-sided window 20, Sq != Sk",
     (2, 96, 130, 32, 8, 160, False, 20, None), 1.0, ()),
    ("Dh 200 (a ragged last Dh tile), causal, window 40", (1, 130, 130, 4, 2, 200, True, 40, 30.0),
     1.0, ()),
)
# the experts' backward in bf16 at the MoE family's shapes, C from
# core/moe.default_capacity at 8 x 128 tokens (capacity factor 1.25):
# (label, (E, C, d, f), the 16b run that trains it)
LMT_FFN_SHAPES = (
    ("qwen3-moe-30b-a3b (128 experts top-8)", (128, 80, 2048, 768), "qwen3-moe-30b-a3b"),
    ("dbrx-132b (16 experts top-4)", (16, 320, 6144, 10752), None),
)


def _flash_bwd_wrong_heads(q, k, v, o32, lse, do, masks):
    """A planted fault: the plain backward with query head h reading kv
    head h % KVH instead of h // G (the heads permuted into the grouped
    order that mapping implies, the gradients permuted back)."""
    from repro_torch.kernels import ref
    H, KVH = q.shape[2], k.shape[2]
    G = H // KVH
    perm = [(h % KVH) * G + h // KVH for h in range(H)]   # head h's grouped slot
    inv = sorted(range(H), key=lambda h: perm[h])           # the head in each slot
    dq, dk, dv = ref.flash_attention_bwd_ref(q[:, :, inv], k, v, o32[:, :, inv],
                                             lse[:, inv].contiguous(), do[:, :, inv],
                                             **masks)
    return dq[:, :, perm], dk, dv


def _flash_bwd_no_cap_factor(q, k, v, o32, lse, do, masks):
    """A planted fault: the plain backward with the softcap's factor
    1 - (S/c)^2 left out of dS (P and lse still over the capped logits)."""
    import torch
    from repro_torch.kernels import ref
    B, Sq, H, Dh = q.shape
    KVH, G = k.shape[2], H // k.shape[2]
    f32, scale = torch.float32, 1.0 / math.sqrt(Dh)
    s, mask = ref._logits(q, k.float(), causal=masks["causal"], window=masks["window"],
                          softcap=masks["softcap"], one_sided=True)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KVH, G, Sq)[..., None]), 0.0)
    qc, doc, oc = (t.to(f32).reshape(B, Sq, KVH, G, Dh) for t in (q, do, o32))
    dd = (doc * oc).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", doc, v.float()) - dd)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, doc)
    dq = (torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale).reshape(B, Sq, H, Dh)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qc) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_dk_tile_dropped(want):
    """A planted fault: the plain gradients with the last 8-column Dh tile
    of dK dropped (a column half's block that skips its last tile)."""
    dq, dk, dv = (g.clone() for g in want)
    last = (dk.shape[-1] - 1) // 8 * 8
    dk[..., last:last + 8] = 0
    return dq, dk, dv


def _flash_bwd_tile_dropped(q, k, v, o32, lse, do, want, side, softcap=None):
    """A planted fault of a causal Sq == Sk shape, confined to one tile:
    ``"dq"``, the last query block's loop stops one 32-key tile short, so
    the last 32 queries' dq miss their diagonal tile (keys Sq - 32 on);
    ``"dkdv"``, the first key block's loop starts one 32-query tile late,
    so the first 32 keys' dK and dV miss queries 0-31.  The other rows are
    ``want``'s (the plain gradients)."""
    from repro_torch.kernels import ref
    t, Sq = 32, q.shape[1]
    dq, dk, dv = (g.clone() for g in want)
    if side == "dq":
        a = Sq - t       # those queries over keys 0 .. a - 1, all visible to them
        dq[:, a:] = ref.flash_attention_bwd_ref(q[:, a:], k[:, :a], v[:, :a], o32[:, a:],
                                                lse[:, :, a:], do[:, a:], softcap=softcap)[0]
    else:
        # keys 0 .. t - 1 over queries t on, which see all of them
        _, dk[:, :t], dv[:, :t] = ref.flash_attention_bwd_ref(
            q[:, t:], k[:, :t], v[:, :t], o32[:, t:], lse[:, :, t:], do[:, t:],
            softcap=softcap)
    return dq, dk, dv


def _flash_bwd_row(smi, gen, label, shape, dtype, *, iters=0, q_scale=1.0, faults=()):
    """One 3B line of the LM training shapes (B, Sq, Sk, H, KVH, Dh,
    causal, window, softcap; the window one-sided, as ``layers.attention``
    applies it): the flash forward's f32 output and log-sum-exp against
    the plain version's (TOL_F32), then the backward kernel's dq, dk, dv
    against the plain backward, to TOL_BF16 (TOL_F32 in f32) with the
    atol in units of each (b, row, head) row's RMS over Dh, plus
    ROUNDOFF_TERMS of the magnitudes of each element's terms
    (:func:`_row_tol_ratio`); two runs bit for bit; the planted faults
    that apply must fail that check by more than 10x: the plain version
    run non-causal, the diagonal tile dropped from the last query block's
    dQ or the first query tile from the first key block's dK/dV (causal,
    Sq == Sk, no window that bites), kv heads mapped as h % KVH (GQA), and
    dK's last 8-column Dh tile dropped (Dh above 128, where the grid
    splits the columns in halves) and those ``faults`` names:
    ``"window"`` one key more, ``"softcap"`` the cap's factor left out.  ``q_scale`` multiplies q (a softcap that bites).  With
    ``iters``: events and device time (two launches a call), the plain
    version's time, the device time of the backward of
    ``scaled_dot_product_attention`` (``is_causal`` or, with a window, a
    bool ``attn_mask``; it has no softcap; ``enable_gqa``) through
    autograd, and the bound over the kept (query, key) pairs: 2.5x the
    forward's products at the bf16 peak (3xTF32 in f32) or the bytes of
    q, k, v, dO, the f32 O and lse read and dq, dk, dv written.  Returns
    the row (``iters``) or None."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.timing import device_ms, time_ms
    B, Sq, Sk, H, KVH, Dh, causal, window, softcap = shape
    masks = dict(causal=causal, window=window, softcap=softcap)
    kw = dict(generator=gen, device="cuda")
    q = (torch.randn((B, Sq, H, Dh), **kw) * q_scale).to(dtype)
    k = torch.randn((B, Sk, KVH, Dh), **kw).to(dtype)
    v = torch.randn((B, Sk, KVH, Dh), **kw).to(dtype)
    do = torch.randn((B, Sq, H, Dh), **kw).to(dtype)
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    extra = "".join(f" {n} {x}" for n, x in (("window", window), ("softcap", softcap)) if x)
    name = (f"3B [{smi}] flash_attention_bwd {label} B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} "
            f"Dh={Dh} {'causal ' if causal else ''}{str(dtype)[6:]}{extra}")
    o, lse, o32 = ops._flash_attention_fwd(q, k, v, one_sided_window=True, want_lse=True,
                                           **masks)
    want_o32, want_lse = ref.flash_attention_ref(q, k, v, one_sided_window=True, stats=True,
                                                 **masks)
    fwd_err = max(_close_quiet(f"{name} lse", lse, want_lse, TOL_F32),
                  _close_quiet(f"{name} f32 output", o32, want_o32, TOL_F32))
    if not torch.equal(o, o32.to(dtype)):
        raise AssertionError(f"{name}: the forward's output is not its f32 output rounded")
    del want_o32, want_lse
    run = lambda: ops.flash_attention_bwd(q, k, v, o32, lse, do, **masks)  # noqa: E731
    got, again = run(), run()
    want = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, **masks)
    terms = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, magnitudes=True, **masks)
    torch.cuda.synchronize()
    res = [_row_tol_ratio(g, w, tol, terms=t) for g, w, t in zip(got, want, terms)]
    err, ratio = max(r[0] for r in res), max(r[2] for r in res)
    of_terms = max(float(((g.float() - w.float()).abs() / t.clamp_min(1e-30)).max())
                   for g, w, t in zip(got, want, terms))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  {name}: forward lse / f32 output max_abs_err {fwd_err:.3e} (TOL_F32); dQ, dK, dV "
        f"max_abs_err {err:.3e}, at most {of_terms:.3e} of its terms' magnitudes; "
        f"{ratio:.3f} of its tolerance (rtol="
        f"{tol['rtol']}, atol={tol['atol']} x the row's RMS, plus {ROUNDOFF_TERMS:.3e} x the "
        f"terms' magnitudes) {'ok' if ratio <= 1 else 'FAIL'}; two runs bit-identical {same}")
    if ratio > 1 or not same:
        raise AssertionError(f"{name}: the kernel disagrees with its plain version or "
                             f"two runs differ")
    del again
    plan = []
    if causal:
        plan.append(("the plain version run non-causal", lambda: ref.flash_attention_bwd_ref(
            q, k, v, o32, lse, do, **dict(masks, causal=False))))
    if causal and Sq == Sk and (window is None or window >= Sq):
        plan += [("the last 32 queries' dQ without their diagonal key tile",
                  lambda: _flash_bwd_tile_dropped(q, k, v, o32, lse, do, want, "dq",
                                                  softcap)),
                 ("the first 32 keys' dK/dV without the first query tile",
                  lambda: _flash_bwd_tile_dropped(q, k, v, o32, lse, do, want, "dkdv",
                                                  softcap))]
    if KVH != H:
        plan.append(("kv heads mapped as h % KVH", lambda: _flash_bwd_wrong_heads(
            q, k, v, o32, lse, do, masks)))
    if "window" in faults:
        plan.append(("the window one key wider", lambda: ref.flash_attention_bwd_ref(
            q, k, v, o32, lse, do, **dict(masks, window=window + 1))))
    if "softcap" in faults:
        plan.append(("the softcap's factor 1 - (S/c)^2 left out",
                     lambda: _flash_bwd_no_cap_factor(q, k, v, o32, lse, do, masks)))
    if Dh > 128:
        plan.append(("dK's last 8-column Dh tile dropped",
                     lambda: _flash_bwd_dk_tile_dropped(want)))
    for fault, plain in plan:
        f_ratio = max(_row_tol_ratio(g, w, tol, terms=t)[2]
                      for g, w, t in zip(got, plain(), terms))
        log(f"  3B [{smi}] flash_attention_bwd {label} {str(dtype)[6:]}, planted fault "
            f"({fault}): {f_ratio:.3f} of the tolerance "
            f"{'rejected' if f_ratio > 10 else 'NOT REJECTED by 10x'}")
        if f_ratio <= 10:
            raise AssertionError(f"{name}: the check does not reject {fault} by 10x")
    del want, terms
    if not iters:
        del q, k, v, do, o, o32, lse, got
        torch.cuda.empty_cache()
        return None
    ms = time_ms(run, iters)
    dev = device_ms(run, iters, launches_per_call=FLASH_BWD_LAUNCHES)
    plain = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, **masks), 1)
    mask = ref.attention_mask(Sq, Sk, causal=causal, window=window, device="cuda",
                              one_sided=True)
    kept = int(mask.sum())
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v))
    sdpa_kw = (dict(is_causal=causal) if window is None
               else dict(attn_mask=mask))
    ot = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,  # noqa: E731
                                           retain_graph=True)
    lib_events = time_ms(sdpa_bwd, iters)
    lib = device_ms(sdpa_bwd, iters)
    del qt, kt, vt, ot, mask
    flops = 2.5 * 4.0 * B * H * kept * Dh
    es = q.element_size()
    nq, nk = B * Sq * H * Dh, B * Sk * KVH * Dh
    nbytes = (es * (2 * nq + 2 * nk)        # q, dO, k, v read
              + 4 * nq + 4 * B * H * Sq     # the f32 O and lse read
              + es * (nq + 2 * nk))         # dq, dk, dv written
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3
    b_ms, b_by = bound(flops, nbytes, peak)
    sdpa_how = ("is_causal" if window is None and causal else
                "bool attn_mask" if window is not None else "no mask")
    log(f"  3B [{smi}] flash_attention_bwd {label} {str(dtype)[6:]}: kernel {ms:.4f} ms "
        f"events, {dev:.4f} ms device ({FLASH_BWD_LAUNCHES} launches), plain {plain:.4f} ms, "
        f"backward of scaled_dot_product_attention ({sdpa_how}, enable_gqa"
        f"{'; no softcap, which SDPA does not take' if softcap else ''}) through "
        f"autograd {lib:.4f} ms device ({lib_events:.4f} ms events), kernel / SDPA backward "
        f"{dev / lib:.3f} (device), bound {b_ms:.4f} ms ({b_by}; {kept} kept (query, key) "
        f"pairs, {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB; {flops / dev / 1e9:.1f} TFLOP/s on "
        f"the device)")
    del q, k, v, do, o, o32, lse, got
    torch.cuda.empty_cache()
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu", replaces=NO_PALLAS,
                launches=0, max_abs_err=err, ms=ms, device_ms=dev, events_ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library_events_ms=lib_events, yardstick_ratio=dev / lib,
                shape=f"{label}: B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} Dh={Dh}"
                      f"{' causal' if causal else ''}{extra} {str(dtype)[6:]}")


def _ffn_bwd_bf16_ratio(got, want, n):
    """Max over the four gradients of |got - want| over its tolerance: a
    bf16 gradient against the plain version's f32 sum of ``n`` products
    (``sum_tol``), rounded once (2^-8 relative, half a bf16 ulp)."""
    out = 0.0
    for g, w, m in zip(got, want, n):
        w = w.float()
        lim = TOL_F32["atol"] + sum_tol(m) * float(w.abs().max()) + 2.0 ** -8 * w.abs()
        out = max(out, float(((g.float() - w).abs() / lim).max()))
    return out


def _ffn_bwd_bf16_row(smi, gen, label, E, C, d, f, *, iters):
    """One 3B line of ``expert_ffn_bwd`` in bf16 at an MoE config's expert
    shape: the four gradients against the plain version's f32 sums
    (:func:`_ffn_bwd_bf16_ratio`), two runs bit for bit, the planted fault
    (dWg and dWu swapped) rejected by more than 10x; events and device
    time (ten launches: five widening passes, five wgmma passes), the
    plain version's time, the six bf16 ``bmm``s of the gradients as the
    yardstick, and the bound: the six products' FLOP at the bf16 peak or
    the bytes of X, dY, the three weights read and the four gradients
    written, in bf16."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.timing import device_ms, time_ms
    x, wg, wu, wd = _expert_inputs(gen, E, C, d, f, torch.bfloat16)
    dy = torch.randn((E, C, d), generator=gen, device="cuda").bfloat16()
    run = lambda: ops.expert_ffn_bwd(x, wg, wu, wd, dy)  # noqa: E731
    got, again = run(), run()
    want = ref.expert_ffn_bwd_ref(*(t.float() for t in (x, wg, wu, wd, dy)))
    torch.cuda.synchronize()
    n = (2 * f + d, C, C, C)
    ratio = _ffn_bwd_bf16_ratio(got, want, n)
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    swapped = _ffn_bwd_bf16_ratio(got, (want[0], want[2], want[1], want[3]), n)
    name = f"3B [{smi}] expert_ffn_bwd {label} E={E} C={C} d={d} f={f} bf16"
    log(f"  {name}: dX, dWg, dWu, dWd max_abs_err {err:.3e}, {ratio:.3f} of the tolerance "
        f"(2^-8 |want| + TOL_F32's atol + sum_tol of the tensor's max) "
        f"{'ok' if ratio <= 1 else 'FAIL'}; two runs bit-identical {same}; planted fault (dWg "
        f"and dWu swapped) {swapped:.3f} of the tolerance "
        f"{'rejected' if swapped > 10 else 'NOT REJECTED by 10x'}")
    if ratio > 1 or not same or swapped <= 10:
        raise AssertionError(f"{name}: the kernel disagrees with its plain version, two runs "
                             f"differ or the check misses the planted fault")
    del again, want
    torch.cuda.empty_cache()
    ms = time_ms(run, iters)
    dev = device_ms(run, iters, launches_per_call=2 * FFN_BWD_LAUNCHES)
    plain = time_ms(lambda: ref.expert_ffn_bwd_ref(x, wg, wu, wd, dy), 1)
    with torch.no_grad():
        g = x @ wg
        u = x @ wu
        h = ref.act_fn("silu")(g) * u

    def six():
        dh = dy @ wd.transpose(1, 2)
        dwd = h.transpose(1, 2) @ dy
        dg, du = dh * u, dh * g
        dx = dg @ wg.transpose(1, 2) + du @ wu.transpose(1, 2)
        return dwd, dx, x.transpose(1, 2) @ dg, x.transpose(1, 2) @ du

    yard = time_ms(six, iters)
    flops = 6 * 2.0 * E * C * d * f
    nbytes = 2.0 * (3 * E * C * d + 6 * E * d * f)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  3B [{smi}] expert_ffn_bwd {label} bf16: kernel {ms:.4f} ms events, {dev:.4f} ms "
        f"device ({2 * FFN_BWD_LAUNCHES} launches), plain {plain:.4f} ms, six bf16 bmm "
        f"{yard:.4f} ms (kernel / six bmm {ms / yard:.3f}), bound {b_ms:.4f} ms ({b_by}; "
        f"{flops:.3e} FLOP, {nbytes / 1e6:.1f} MB; {flops / dev / 1e9:.1f} TFLOP/s on the "
        f"device)")
    del x, wg, wu, wd, dy, got, g, u, h
    torch.cuda.empty_cache()
    return dict(name="expert_ffn_bwd", route="cuda",
                source="src/repro_torch/csrc/expert_ffn_bwd.cu", replaces=NO_PALLAS,
                launches=0, max_abs_err=err, ms=ms, device_ms=dev, events_ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                yardstick_ms=yard, yardstick_ratio=ms / yard,
                shape=f"{label}: E={E} C={C} d={d} f={f} bf16")


def phase_lm_train_kernels(rows, smi):
    """3B, in phase 3 after 3F: the flash backward (and the forward's f32
    output and log-sum-exp it reads) at the LM families' training shapes,
    bf16 (timed) and f32 (checked), then its checks off the main path,
    and ``expert_ffn_bwd`` in bf16 at the MoE family's shapes; phase 16b
    adds each bf16 row's launches.  Then each instance's ptxas registers
    and spills."""
    import torch
    from repro_torch.kernels import build
    gen = torch.Generator(device="cuda").manual_seed(26)
    for label, shape, _, _ in LMT_FLASH_SHAPES:
        big = shape[1] * shape[2] > 1 << 20
        rows[f"flash_attention_bwd {label}"] = _flash_bwd_row(
            smi, gen, label, shape, torch.bfloat16, iters=3 if big else 20)
        if not big:
            _flash_bwd_row(smi, gen, label, shape, torch.float32)
    for label, shape, q_scale, faults in LMT_FLASH_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            _flash_bwd_row(smi, gen, label, shape, dtype, q_scale=q_scale, faults=faults)
    for label, (E, C, d, f), _ in LMT_FFN_SHAPES:
        rows[f"expert_ffn_bwd {label}"] = _ffn_bwd_bf16_row(
            smi, gen, label, E, C, d, f, iters=3 if d * f > 1 << 24 else 10)
    for line in build.ptxas_report():
        if line.startswith(("flash_bwd_dq<bf16", "flash_bwd_dkdv<bf16", "flash_bwd_dq<f32, 16>",
                            "flash_bwd_dkdv<f32, 16>", "flash_bwd_dq<f32, 8>",
                            "flash_bwd_dkdv<f32, 8>", "flash_bwd_dq<f32, 20>",
                            "flash_bwd_dkdv<f32, 20>", "flash_bwd_dq<f32, 32>",
                            "flash_bwd_dkdv<f32, 32>", "widen")):
            log(f"  3B [{smi}] ptxas {line}")


def _train_flash_plan(cfg):
    """(flash_attention, flash_attention_bwd) launches a training step of
    ``cfg``: every attention call runs the forward and the backward once,
    and the forward again where its layer is recomputed (all of them but
    the VLM's cross blocks)."""
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2
        n = zamba2.num_attn_blocks(cfg)
        return 2 * n, n
    if cfg.family == "audio":
        n = cfg.encoder_layers + 2 * cfg.num_layers
        return 2 * n, n
    if cfg.family == "vlm":
        n_cross = cfg.num_layers // cfg.cross_attn_every
        n_self = cfg.num_layers - n_cross
        return 2 * n_self + n_cross, n_self + n_cross
    return 2 * cfg.num_layers, cfg.num_layers


def _planned_train_launches(cfg, steps: int):
    """Every kernel's launches in ``steps`` training steps of ``cfg``:
    flash's (:func:`_train_flash_plan`) and, for the MoE family, one
    ``expert_ffn`` call a layer in the forward and one in its recompute,
    one ``expert_ffn_bwd`` a layer."""
    from repro_torch.kernels import ops
    fwd, bwd = _train_flash_plan(cfg)
    want = {k: 0 for k in ops.LAUNCHES}
    want["flash_attention"], want["flash_attention_bwd"] = steps * fwd, steps * bwd
    if cfg.is_moe:
        want["expert_ffn"], want["expert_ffn_bwd"] = 2 * steps * cfg.num_layers, \
            steps * cfg.num_layers
    return want


def _lmt_smoke_cfg(name, over):
    from repro_torch.configs import get_smoke
    cfg = get_smoke(name)
    return cfg.replace(name=f"{cfg.name} at head_dim {over['head_dim']}", **over) \
        if over else cfg


def phase_lm_train_smoke(smi):
    """16a: the smoke configs of every LM family ``train_lm`` trains
    (LMT_SMOKE: qwen3-32b, deepseek-67b, zamba2-7b, seamless-m4t-large-v2,
    llama-3.2-vision-11b, gemma2-9b, stablelm-12b also at head_dim 160,
    qwen3-moe-30b-a3b, dbrx-132b; the SSD's leaves and the cross gates off
    their init), from one seed: f32 step-0 gradients card vs CPU leaf by
    leaf, then LMT_SMOKE_STEPS ``lm_train_step``s on the CPU (plain
    versions) and on the card (kernels) from the same params, batches and
    stub inputs, f32 (losses within 1e-3) and bf16 (within
    TOL_LM_BF16_LOSS), the card's launches held to the plan."""
    import torch
    from repro_torch.checkpoint.io import flatten
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_train_step, stub_inputs
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_map
    for name, over in LMT_SMOKE:
        cfg = _lmt_smoke_cfg(name, over)
        api = get_model(cfg)
        it = token_batches(cfg.vocab_size, LMT_SMOKE_BATCH, LMT_SMOKE_SEQ, seed=16)
        sgen = torch.Generator().manual_seed(17)
        data = [dict(next(it), **stub_inputs(api, cfg, LMT_SMOKE_BATCH, sgen))
                for _ in range(LMT_SMOKE_STEPS)]
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, TOL_LM_BF16_LOSS)):
            gen = torch.Generator().manual_seed(16)
            params = api.init(cfg, generator=gen, dtype=dtype)
            _off_init(params, gen)
            tag = f"16a [{smi}] {cfg.name} {str(dtype)[6:]}"
            if dtype == torch.float32:
                grads = {}
                for dev in ("cpu", "cuda"):
                    live = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True),
                                    params)
                    loss, _ = api.loss_fn(live, _to(data[0], dev), cfg)
                    grads[dev] = torch.autograd.grad(loss, tree_leaves(live))
                _compare_grads(f"{tag} step-0 gradients, card vs cpu", grads["cuda"],
                               grads["cpu"], [n for n, _ in flatten(params)[0]],
                               max(cfg.d_ff, cfg.expert_d_ff or 0)
                               + max(LMT_SMOKE_SEQ, cfg.num_audio_frames or 0,
                                     cfg.num_image_tokens or 0))
            losses = {}
            for dev in ("cpu", "cuda"):
                p = tree_map(lambda t: t.detach().to(dev, copy=True), params)
                opt = adamw_init(p)
                ops.reset_launches()
                out = []
                for b in data:
                    p, opt, m = lm_train_step(p, opt, _to(b, dev), cfg, total=LMT_SMOKE_STEPS)
                    out.append(m["loss"])
                losses[dev] = [float(x) for x in out]
                counts = dict(ops.LAUNCHES)
            want = _planned_train_launches(cfg, LMT_SMOKE_STEPS)
            log(f"  {tag}: {LMT_SMOKE_STEPS} steps, losses cpu "
                f"{[round(x, 5) for x in losses['cpu']]}, card "
                f"{[round(x, 5) for x in losses['cuda']]}, card launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            if counts != want:
                raise AssertionError(f"{tag}: launches {counts} differ from the plan's {want}")
            compare(f"{tag} losses card vs cpu", torch.tensor(losses["cuda"]),
                    torch.tensor(losses["cpu"]), dict(rtol=tol, atol=0.0))


def phase_lm_train_full(rows, smi):
    """16b: each run of LMT_FULL at full width with the depth one card holds
    (``profile_train.lm_train_config``; seamless-m4t-large-v2 whole,
    gemma2-9b also over 1 x 8,192 tokens at 2 layers, one local and one
    global), bf16 params and f32 moments as ``train_lm`` makes them (the
    SSD's leaves and the cross gates off their init), with the stub audio
    frames or image embeddings: one warm-up step, then LMT_TIMED steps
    with the launch counts set to 0 before them and held to the depth
    after (the recompute's second forward included), flash's forward and
    backward and ``expert_ffn_bwd`` counted by shape at their wrappers;
    loss and grad norm finite; then one ``lm_grads``, whose gradient tree's
    bytes 18b reads.  Each model is freed before the next.
    Returns {label: {s_per_step, peak_gib, param_bytes, grad_bytes,
    opt_bytes}}."""
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_train import lm_train_config
    from repro_torch.launch.train import lm_grads, lm_train_step, stub_inputs
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import adamw_init
    out, fwd_total = {}, 0
    for label, arch, layers, batch, seq in LMT_FULL:
        cfg = lm_train_config(arch, layers)
        api = get_model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = api.init(cfg, generator=gen)
        _off_init(params, gen)
        opt = adamw_init(params)
        n_params = sum(t.numel() for t in leaves(params).values())
        it = token_batches(cfg.vocab_size, batch, seq, seed=0, device="cuda")
        sgen = torch.Generator(device="cuda").manual_seed(1)

        def step():
            nonlocal params, opt
            b = dict(next(it), **stub_inputs(api, cfg, batch, sgen))
            params, opt, m = lm_train_step(params, opt, b, cfg, total=1 + LMT_TIMED)
            return m

        step()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        ms = [step() for _ in range(LMT_TIMED)]
        torch.cuda.synchronize()
        s_per_step = (time.perf_counter() - t0) / LMT_TIMED
        counts, by_shape = dict(ops.LAUNCHES), dict(ops.FLASH_BWD_SHAPES)
        fwd_shapes, ffn_shapes = dict(ops.FLASH_SHAPES), dict(ops.FFN_BWD_SHAPES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(m["loss"]) for m in ms]
        gnorms = [float(m["grad_norm"]) for m in ms]
        want = _planned_train_launches(cfg, LMT_TIMED)
        layout = (f"{cfg.num_layers} layers + {cfg.encoder_layers} encoder layers"
                  if cfg.encoder_layers else f"{cfg.num_layers} layers")
        log(f"  16b [{smi}] {label} ({layout}, d {cfg.d_model}, {cfg.num_heads} heads x "
            f"{cfg.head_dim} over {cfg.num_kv_heads}, {n_params / 1e9:.3f} B params bf16, "
            f"moments f32), batch {batch} x {seq} tokens: {s_per_step:.4f} "
            f"s/train-step over {LMT_TIMED} steps ({batch * seq / s_per_step:.1f}"
            f" tokens/s), max_memory_allocated {peak:.3f} GiB, losses "
            f"{[round(x, 5) for x in losses]}, grad norms {[round(x, 4) for x in gnorms]}, "
            f"launches { {k: v for k, v in counts.items() if v} }, planned "
            f"{ {k: v for k, v in want.items() if v} }; flash_attention_bwd by (B, Sq, Sk, "
            f"H, KVH, Dh, causal, window, softcap) {by_shape}; flash_attention by shape "
            f"{fwd_shapes}; expert_ffn_bwd by (E, C, d, f, dtype) {ffn_shapes}")
        if counts != want or not all(math.isfinite(x) for x in losses + gnorms):
            raise AssertionError(f"16b {label}: launches differ from the plan or the loss "
                                 f"or grad norm is not finite")
        mine = {shape: LMT_TIMED * per_step(cfg)
                for _, shape, owner, per_step in LMT_FLASH_SHAPES if owner == label}
        if by_shape != mine:
            raise AssertionError(f"16b {label}: flash_attention_bwd's launches by shape "
                                 f"{by_shape} differ from the plan's {mine}")
        # the forward by shape: each backward's shape once more for its
        # recompute (the VLM's cross blocks are not recomputed)
        if set(fwd_shapes) != set(mine) or any(
                not mine[sh] <= fwd_shapes[sh] <= 2 * mine[sh] for sh in mine):
            raise AssertionError(f"16b {label}: flash_attention's launches by shape "
                                 f"{fwd_shapes} do not follow the backward's {mine}")
        ffn_mine = {(E, C, d, f, "bfloat16"): LMT_TIMED * cfg.num_layers
                    for _, (E, C, d, f), owner in LMT_FFN_SHAPES if owner == label}
        if ffn_shapes != ffn_mine:
            raise AssertionError(f"16b {label}: expert_ffn_bwd's launches by shape "
                                 f"{ffn_shapes} differ from the plan's {ffn_mine}")
        for lab, shape, owner, _ in LMT_FLASH_SHAPES:
            if owner == label:
                rows[f"flash_attention_bwd {lab}"]["launches"] = by_shape[shape]
                rows[f"flash_attention_bwd {lab}"]["launches_forward"] = fwd_shapes[shape]
        for lab, (E, C, d, f), owner in LMT_FFN_SHAPES:
            if owner == label:
                rows[f"expert_ffn_bwd {lab}"]["launches"] = ffn_shapes[(E, C, d, f, "bfloat16")]
        fwd_total += counts["flash_attention"]
        grads = lm_grads(params, dict(next(it), **stub_inputs(api, cfg, batch, sgen)), cfg)[1]
        out[label] = dict(s_per_step=s_per_step, peak_gib=peak,
                          param_bytes=_tree_bytes(params), grad_bytes=_tree_bytes(grads),
                          opt_bytes=_tree_bytes(opt))
        del params, opt, ms, grads
        torch.cuda.empty_cache()
    rows["flash_attention"]["launches_train_lm"] = fwd_total
    return out


# ---------------------------------------------------------------------------
# phase 17: training over a data x model mesh (the functions named _tm_*
# run in spawned ranks, so they live at the top level)
# ---------------------------------------------------------------------------
TM_NAME = "qwen3-moe-30b-a3b"
TM_SMOKE_BATCH, TM_SMOKE_SEQ = 4, 32      # 17a / 17b
TM_A_STEPS, TM_B_STEPS = 2, 3
TM_LAYERS, TM_BATCH, TM_SEQ, TM_MODEL = 2, 8, 128, 2    # 17c
TM_TIMED = 4                              # 17c, after a warm-up step
TM_TIMEOUT_S = 600
# 17c's peak a rank, 22.32 GiB measured at 2 layers (PERF.md), with 1 GiB for
# the rank's CUDA context and cache
TM_NEED_GIB = 23.4


def _tree_bytes(tree) -> int:
    """Bytes of every tensor of ``tree`` (params, AdamW's state)."""
    from repro_torch.bridge import leaves
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    return sum(t.numel() * t.element_size() for t in leaves(tree).values())


def _tm_digests(params):
    """sha256 of every leaf but the routed experts, in leaf order."""
    import hashlib
    import torch
    from repro_torch.checkpoint.io import flatten
    from repro_torch.common.sharding import is_lm_expert
    return [hashlib.sha256(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                           .numpy().tobytes()).hexdigest()
            for path, t in flatten(params)[0] if not is_lm_expert(path)]


def _tm_step0_grads(mesh, cfg, batch: int, seq: int):
    """17b in each rank: the f32 gradients of the first batch, reduced over
    the mesh (``lm_grads``) from params drawn on the CPU, the experts
    gathered, as they are and with the planted fault of the router's share
    not summed over ``model``; returns ({"right" | "router_not_summed":
    leaves}, paths)."""
    import torch
    from repro_torch.checkpoint.io import flatten
    from repro_torch.common import sharding as shard_lib
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch.train import lm_grads
    from repro_torch.models.api import get_model
    params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0),
                                 dtype=torch.float32)
    params = shard_lib.shard_lm_experts(_to(params, mesh.device), mesh)
    rows = shard_lib.local_rows(batch, mesh)
    b = {k: v[rows].to(mesh.device)
         for k, v in next(token_batches(cfg.vocab_size, batch, seq, seed=0)).items()}
    out, paths = {}, None
    right = shard_lib.is_lm_token_local
    for name in ("right", "router_not_summed"):
        if name == "router_not_summed":
            shard_lib.is_lm_token_local = lambda path: False
        try:
            _, g = lm_grads(params, b, cfg, mesh=mesh)
        finally:
            shard_lib.is_lm_token_local = right
        leaves = flatten(shard_lib.gather_lm_experts(g, mesh))[0]
        out[name] = [t for _, t in leaves]
        paths = [p for p, _ in leaves]
    return out, paths


def _tm_train_job(mesh, steps: int, batch: int, seq: int, cpu_init: bool = False):
    """17a / 17b in each rank: ``train_lm`` of the smoke config over the
    mesh, from its own init on the rank's device or (``cpu_init``, 17b)
    from params drawn on the CPU, the same on either device, and then
    first :func:`_tm_step0_grads`; returns (the losses and grad norms, the
    params with the experts gathered, every rank's digests of its other
    leaves, the step-0 gradients)."""
    import torch
    from repro_torch.common.sharding import gather_lm_experts
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_lm
    from repro_torch.models.api import get_model
    _tf32_off()
    cfg = get_smoke(TM_NAME)
    init = None
    if cpu_init:
        init = _to(get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0)),
                   mesh.device)
    grads = _tm_step0_grads(mesh, cfg, batch, seq) if cpu_init else None
    ops.reset_launches()                 # the counts the spawn reports are train_lm's
    hist = []
    params = train_lm(cfg, steps=steps, batch=batch, seq=seq, mesh=mesh, log_every=steps,
                      history=hist, params=init)
    return dict(losses=[float(m["loss"]) for m in hist],
                gnorms=[float(m["grad_norm"]) for m in hist],
                params=gather_lm_experts(params, mesh),
                digests=_every_rank(_tm_digests(params)), grads=grads)


def _tm_full_job(mesh, layers: int, batch: int, seq: int, timed: int):
    """17c in each rank: qwen3-moe-30b-a3b at full width cut to ``layers``,
    this rank's experts, a warm-up step, then ``timed`` steps with the
    launch counts and the all-to-alls' bytes counted; returns every rank's
    numbers."""
    import torch
    from repro_torch.bridge import leaves
    from repro_torch.common.sharding import local_rows, shard_lm_experts
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.hlo_cost import collective_counts
    from repro_torch.launch.train import lm_train_step
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import adamw_init
    cfg = get_config(TM_NAME).replace(num_layers=layers)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(cfg, generator=torch.Generator(device=mesh.device).manual_seed(0))
    params = shard_lm_experts(params, mesh)
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    n_params = sum(t.numel() for t in leaves(params).values())
    it = token_batches(cfg.vocab_size, batch, seq, seed=0, device=mesh.device)
    rows = local_rows(batch, mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sent = []
    a2a = mesh_lib.EPMesh.all_to_all

    def counted(self, t, **kw):
        sent.append(t.numel() * t.element_size())
        return a2a(self, t, **kw)

    mesh_lib.EPMesh.all_to_all = counted

    def step():
        nonlocal params, opt
        b = {k: v[rows] for k, v in next(it).items()}
        params, opt, m = lm_train_step(params, opt, b, cfg, total=1 + timed, mesh=mesh)
        return m

    try:
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        ops.reset_launches()
        sent.clear()
        t0 = time.perf_counter()
        ms = [step() for _ in range(timed)]
        torch.cuda.synchronize()
        s_per_step = (time.perf_counter() - t0) / timed
    finally:
        mesh_lib.EPMesh.all_to_all = a2a
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    counts, ffn_bwd = dict(ops.LAUNCHES), dict(ops.FFN_BWD_SHAPES)
    flash_bwd, flash = dict(ops.FLASH_BWD_SHAPES), dict(ops.FLASH_SHAPES)
    # one profiled step under "full" and one under "save_ffn": the
    # collectives each issues, by the c10d dispatcher's events
    profiled = {}
    for policy in ("full", "save_ffn"):
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            b = {k: v[rows] for k, v in next(it).items()}
            params, opt, m = lm_train_step(params, opt, b, cfg, total=1 + timed, mesh=mesh,
                                           remat_policy=policy)
            torch.cuda.synchronize()
        profiled[policy] = dict(counts=collective_counts(prof), loss=float(m["loss"]),
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return _every_rank(dict(
        s_per_step=s_per_step, init_s=init_s, n_params=n_params, peak_gib=peak_gib,
        losses=[float(m["loss"]) for m in ms], gnorms=[float(m["grad_norm"]) for m in ms],
        a2a_calls=len(sent) / timed, a2a_bytes=sum(sent) / timed, a2a_sizes=sorted(set(sent)),
        counts=counts, ffn_bwd=ffn_bwd, flash_bwd=flash_bwd, flash=flash,
        profiled=profiled))


def phase_train_mesh(rows, smi):
    """17: see the module docstring."""
    import torch
    from repro_torch.checkpoint.io import flatten
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core.moe import default_capacity
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.train import train_lm
    _tf32_off()
    cfg = get_smoke(TM_NAME)
    # (a) make_local_mesh() on one NCCL rank against the mesh-less card run
    t0 = time.perf_counter()
    hist = []
    want = train_lm(cfg, steps=TM_A_STEPS, batch=TM_SMOKE_BATCH, seq=TM_SMOKE_SEQ,
                    device="cuda", log_every=TM_A_STEPS, history=hist)
    want_losses = [float(m["loss"]) for m in hist]
    got, counts = mesh_lib.spawn(_tm_train_job, 1, backend="nccl", data=1, model=1,
                                 timeout_s=TM_TIMEOUT_S,
                                 args=(TM_A_STEPS, TM_SMOKE_BATCH, TM_SMOKE_SEQ))
    pairs = list(zip(flatten(got["params"])[0], flatten(want)[0]))
    same = all(torch.equal(g, w.cpu()) for (_, g), (_, w) in pairs)
    plan = _planned_train_launches(cfg, TM_A_STEPS)
    log(f"  17a [{smi}] make_local_mesh() on one nccl rank, {cfg.name} train_lm "
        f"{TM_A_STEPS} steps at {TM_SMOKE_BATCH} x {TM_SMOKE_SEQ}: losses "
        f"{got['losses']} vs the mesh-less card run {want_losses}, {len(pairs)} leaves "
        f"{'bit-identical' if same else 'NOT bit-identical'}; launches {counts[0]} "
        f"(planned {plan}); {time.perf_counter() - t0:.1f} s with the spawn")
    if not same or got["losses"] != want_losses:
        raise AssertionError("17a: the 1 x 1 mesh differs from the mesh-less run")
    if counts[0] != plan:
        raise AssertionError(f"17a: launches {counts[0]} differ from the plan's {plan}")

    # (b) data 2 x model 2: gloo ranks sharing the card against CPU gloo ranks
    t0 = time.perf_counter()
    runs = {}
    for dev in ("cpu", "cuda"):
        runs[dev] = mesh_lib.spawn(_tm_train_job, 4, backend="gloo", device=dev, data=2,
                                   model=2, timeout_s=TM_TIMEOUT_S,
                                   args=(TM_B_STEPS, TM_SMOKE_BATCH, TM_SMOKE_SEQ, True))
    (cpu, _), (card, card_counts) = runs["cpu"], runs["cuda"]
    plan = _planned_train_launches(cfg, TM_B_STEPS)
    same = all(d == card["digests"][0] for d in card["digests"])
    log(f"  17b [{smi}] data 2 x model 2, {cfg.name} train_lm {TM_B_STEPS} steps at "
        f"{TM_SMOKE_BATCH} x {TM_SMOKE_SEQ} (bf16, params drawn on the cpu), four gloo "
        f"ranks sharing the card vs four cpu gloo ranks: losses card {card['losses']}, cpu {cpu['losses']}; "
        f"{len(card['digests'][0])} leaves but the experts "
        f"{'bit-identical' if same else 'NOT bit-identical'} across the card's ranks; "
        f"launches per rank {card_counts} (planned {plan}); "
        f"{time.perf_counter() - t0:.1f} s with the spawns")
    compare(f"17b [{smi}] losses card vs cpu", torch.tensor(card["losses"]),
            torch.tensor(cpu["losses"]), dict(rtol=TOL_LM_BF16_LOSS, atol=0.0))
    compare(f"17b [{smi}] grad norms card vs cpu", torch.tensor(card["gnorms"]),
            torch.tensor(cpu["gnorms"]), dict(rtol=TOL_LM_BF16_LOSS, atol=0.0))
    # the mesh's backward (the all-to-alls', the slice's and gather's, the
    # group means') and the reduction, f32 at 16a's bounds; the planted
    # fault must fail the same comparison
    (want, names), (got, _) = cpu["grads"], card["grads"]
    n_sum = max(cfg.d_ff, cfg.expert_d_ff or 0) + TM_SMOKE_SEQ
    _compare_grads(f"17b [{smi}] f32 step-0 gradients reduced over the mesh, card vs cpu",
                   got["right"], want["right"], names, n_sum)
    try:
        _compare_grads(f"17b [{smi}] planted fault, the router not summed over model "
                       f"(must FAIL)", got["router_not_summed"], want["right"], names, n_sum)
    except AssertionError:
        pass
    else:
        raise AssertionError("17b: the gradient comparison passed the planted fault")
    if not same:
        raise AssertionError("17b: the replicated leaves differ across the ranks")
    if any(c != plan for c in card_counts):
        raise AssertionError(f"17b: launches {card_counts} differ from the plan's {plan}")

    # (c) qwen3-moe-30b-a3b at full width, 2 layers, model 2
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    need = TM_MODEL * TM_NEED_GIB * 2**30
    log(f"  17c [{smi}] before the spawn this process holds {held / 2**30:.3f} GiB "
        f"allocated, {torch.cuda.memory_allocated() / 2**30:.3f} after gc.collect(), "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} reserved; the card has "
        f"{free / 2**30:.3f} of {total / 2**30:.3f} GiB free, two ranks of "
        f"{TM_LAYERS} layers need {need / 2**30:.3f}")
    if free < need:
        raise AssertionError(f"17c: {free / 2**30:.3f} GiB free on the card, "
                             f"{need / 2**30:.3f} needed")
    full = get_config(TM_NAME).replace(num_layers=TM_LAYERS)
    res, _ = mesh_lib.spawn(_tm_full_job, TM_MODEL, backend="gloo", device="cuda", data=1,
                            model=TM_MODEL, timeout_s=TM_TIMEOUT_S,
                            args=(TM_LAYERS, TM_BATCH, TM_SEQ, TM_TIMED))
    e_loc = full.num_experts // TM_MODEL
    C = default_capacity(TM_BATCH * TM_SEQ // TM_MODEL, full)
    wire = full.num_experts * C * full.d_model * 2
    plan = _planned_train_launches(full, TM_TIMED)
    ffn_plan = {(e_loc, TM_MODEL * C, full.d_model, full.expert_d_ff, "bfloat16"):
                TM_TIMED * TM_LAYERS}
    flash_plan = {(TM_BATCH, TM_SEQ, TM_SEQ, full.num_heads, full.num_kv_heads,
                   full.head_dim, True, None, None): TM_TIMED * TM_LAYERS}
    for r, x in enumerate(res):
        log(f"  17c [{smi}] {TM_NAME} full width, {TM_LAYERS} of 48 layers, model "
            f"{TM_MODEL} ({e_loc} experts a rank), rank {r}: {x['n_params'] / 1e9:.4f} B "
            f"params bf16 (moments f32), batch {TM_BATCH} x {TM_SEQ}: "
            f"{x['s_per_step']:.4f} s/train-step over {TM_TIMED} steps "
            f"({TM_BATCH * TM_SEQ / x['s_per_step']:.1f} tokens/s), max_memory_allocated "
            f"{x['peak_gib']:.3f} GiB, init {x['init_s']:.2f} s; all-to-alls "
            f"{x['a2a_calls']:.0f} a step of {x['a2a_sizes']} B ({x['a2a_bytes']:.0f} B a "
            f"step; planned 6 a layer of {wire} B); losses "
            f"{[round(v, 5) for v in x['losses']]}, grad norms "
            f"{[round(v, 4) for v in x['gnorms']]}; launches "
            f"{ {k: v for k, v in x['counts'].items() if v} } (planned "
            f"{ {k: v for k, v in plan.items() if v} }); expert_ffn_bwd by shape "
            f"{x['ffn_bwd']}; flash_attention_bwd by shape {x['flash_bwd']}; "
            f"flash_attention by shape {x['flash']}")
        pf, ps = x["profiled"]["full"], x["profiled"]["save_ffn"]
        log(f"  17c [{smi}] rank {r}, one profiled step each: remat 'full' issues "
            f"{pf['counts']['all_to_all']} all-to-alls (planned {6 * TM_LAYERS}), loss "
            f"{pf['loss']:.5f}, max_memory_allocated {pf['peak_gib']:.3f} GiB; 'save_ffn' "
            f"{ps['counts']['all_to_all']} (planned {4 * TM_LAYERS}: the recompute reads "
            f"the exchange's saved buffers), loss {ps['loss']:.5f}, max_memory_allocated "
            f"{ps['peak_gib']:.3f} GiB; collectives {pf['counts']} / {ps['counts']}")
        bad = (x["counts"] != plan or x["ffn_bwd"] != ffn_plan or x["flash_bwd"] != flash_plan
               or x["a2a_calls"] != 6 * TM_LAYERS or x["a2a_sizes"] != [wire]
               or pf["counts"]["all_to_all"] != 6 * TM_LAYERS
               or ps["counts"]["all_to_all"] != 4 * TM_LAYERS
               or not all(math.isfinite(v) for v in x["losses"] + x["gnorms"]
                          + [pf["loss"], ps["loss"]]))
        if bad:
            raise AssertionError(f"17c rank {r}: launches, shapes or all-to-alls differ "
                                 f"from the plan, or a loss is not finite")
    if len({tuple(x["losses"]) for x in res}) != 1:
        raise AssertionError("17c: the ranks report different losses")
    mesh_run = dict(peak_gib=res[0]["peak_gib"], a2a_sizes=res[0]["a2a_sizes"],
                    a2a_full=res[0]["profiled"]["full"]["counts"]["all_to_all"],
                    a2a_save_ffn=res[0]["profiled"]["save_ffn"]["counts"]["all_to_all"])
    log(f"  17c: the spawn took {time.perf_counter() - t0:.1f} s; both ranks share one "
        f"card and a host-staged gloo wire, so these are not NCCL numbers")
    for name, key in (("expert_ffn", "expert_ffn"), ("flash_attention", "flash_attention"),
                      ("expert_ffn_bwd qwen3-moe-30b-a3b (128 experts top-8)",
                       "expert_ffn_bwd"),
                      ("flash_attention_bwd qwen3-moe-30b-a3b (GQA 32 over 4)",
                       "flash_attention_bwd")):
        rows[name]["launches_train_mesh_per_rank"] = [x["counts"][key] for x in res]
    return mesh_run



# ---------------------------------------------------------------------------
# phase 18: the dry run against the card (host-only dry runs, each a process
# of its own, started together; 18c on the card meanwhile)
# ---------------------------------------------------------------------------
DRY_TIMEOUT_S = 300
DRY_PEAK_REL = 0.02                       # 18b: |dry-run peak / measured - 1|
DRY_POLICIES = (("full", ""), ("dots", "remat_dots"), ("save_ffn", "save_ffn"))
DRY_FAKE_WORLD = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
g = dist.new_group(list(range(16)))
x = torch.empty(16, 4, device="meta")
out = torch.empty_like(x)
dist.all_to_all_single(out, x, group=g)
print(json.dumps({"torch": torch.__version__, "backend": dist.get_backend(),
                  "world": dist.get_world_size(), "group": dist.get_world_size(g),
                  "out": [list(out.shape), str(out.device)]}))
"""


def _dry_cmd(arch: str, shape: str, *extra: str):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
            "--shape", shape, "--quiet", *extra]


def _dry_start(cmd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _dry_finish(label: str, proc):
    """The last JSON line a dry-run process printed; raises with its error
    output if it failed."""
    try:
        out, err = proc.communicate(timeout=DRY_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"18 {label}: the dry run took over {DRY_TIMEOUT_S} s")
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"18 {label}: the dry run exited {proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-3000:]}")
    rec = json.loads(lines[-1])
    if "error" in rec:
        raise AssertionError(f"18 {label}: {rec['error']}")
    return rec


def _policy_runs(smi, cfg, batch: int, seq: int):
    """18c: cfg on the card under each remat policy: the step-0 loss and
    gradients against "full"'s, then a warm-up and LMT_TIMED steps with the
    peak reset before the warm-up and the launch counts set to 0 after it,
    held to the plan (every policy recomputes the kernels' forwards: a
    selective checkpoint keeps aten ops' outputs, and the kernels are not
    aten ops).  Returns {policy: (s/step, peak GiB, launches)}."""
    import torch
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_grads, lm_train_step
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    api = get_model(cfg)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(cfg, generator=gen)
    opt = adamw_init(params)
    it = token_batches(cfg.vocab_size, batch, seq, seed=0, device="cuda")
    b0 = next(it)
    loss0, want = lm_grads(params, b0, cfg)
    want = tree_leaves(want)
    names = [f"leaf {i}" for i in range(len(want))]
    n_sum = max(cfg.d_ff, cfg.expert_d_ff or 0) + seq
    for policy, _ in DRY_POLICIES[1:]:
        loss, got = lm_grads(params, b0, cfg, remat_policy=policy)
        got = tree_leaves(got)
        same = bool(torch.equal(loss, loss0)) and all(torch.equal(g, w)
                                                       for g, w in zip(got, want))
        log(f"  18c [{smi}] remat '{policy}' step-0 loss {float(loss):.6f} vs 'full' "
            f"{float(loss0):.6f}; {len(got)} gradient leaves "
            f"{'bit-identical to full' if same else 'NOT bit-identical to full'}")
        if not same:
            _compare_grads(f"18c [{smi}] '{policy}' gradients vs 'full'", got, want, names,
                           n_sum)
        del got, loss
    del want
    out = {}
    for policy, _ in DRY_POLICIES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = lambda: lm_train_step(params, opt, next(it), cfg, total=1 + LMT_TIMED,  # noqa: E731
                                     remat_policy=policy)
        params, opt, m = step()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        for _ in range(LMT_TIMED):
            params, opt, m = step()
        torch.cuda.synchronize()
        out[policy] = ((time.perf_counter() - t0) / LMT_TIMED,
                       torch.cuda.max_memory_allocated() / 2**30, dict(ops.LAUNCHES))
        plan = _planned_train_launches(cfg, LMT_TIMED)
        if out[policy][2] != plan or not math.isfinite(float(m["loss"])):
            raise AssertionError(f"18c {policy}: launches {out[policy][2]} differ from the "
                                 f"plan's {plan}, or the loss is not finite")
    del params, opt, m
    torch.cuda.empty_cache()
    return out


def phase_dry_run(rows, smi, train16, train17):
    """18: see the module docstring."""
    t0 = time.perf_counter()
    cut = ("--layers", "3", "--batch", "8", "--seq", "128")
    procs = {"18a fake world": _dry_start([sys.executable, "-c", DRY_FAKE_WORLD])}
    for policy, opt in DRY_POLICIES:
        procs[f"16b {policy}"] = _dry_start(_dry_cmd(TM_NAME, "train_4k", "--mesh", "1x1",
                                                     *cut, "--opts", opt))
    for policy, opt in DRY_POLICIES[::2]:
        procs[f"17c {policy}"] = _dry_start(_dry_cmd(
            TM_NAME, "train_4k", "--mesh", f"1x{TM_MODEL}", "--layers", str(TM_LAYERS),
            "--batch", str(TM_BATCH), "--seq", str(TM_SEQ), "--opts", opt))
    procs["18d qwen3-moe"] = _dry_start(_dry_cmd(TM_NAME, "train_4k"))
    procs["18d dit-moe-g"] = _dry_start(_dry_cmd("dit-moe-g", "dit_serve"))

    # (c) on the card while the dry runs trace on the host
    from repro_torch.launch.profile_train import lm_train_config
    cfg = lm_train_config(TM_NAME)
    card = _policy_runs(smi, cfg, 8, 128)

    rec = {label: _dry_finish(label, p) for label, p in procs.items()}
    fake = rec.pop("18a fake world")
    log(f"  18a torch {fake['torch']}: backend {fake['backend']}, world {fake['world']}, a "
        f"new_group of {fake['group']} ranks ran an all-to-all on meta {fake['out']}")
    if (fake["backend"], fake["world"], fake["group"]) != ("fake", 256, 16):
        raise AssertionError("18a: the fake world is not what was asked")

    def gib(n):
        return n / 2**30

    # (b) 16b's cut: the bytes it held, and its peak
    want16 = train16[TM_NAME]
    dry = rec["16b full"]
    mem = dry["memory"]
    held = want16["param_bytes"] + want16["grad_bytes"] + want16["opt_bytes"]
    pgo = mem["param_bytes"] + mem["grad_bytes"] + mem["opt_bytes"]
    ratio16 = gib(mem["peak_bytes"]) / want16["peak_gib"]
    log(f"  18b {TM_NAME} at 16b's cut ({cfg.num_layers} layers, 8 x 128, a 1 x 1 mesh): the "
        f"dry run's params + grads + AdamW state {pgo} B (grads {mem['grad_bytes']}), 16b "
        f"held {held} B (params {want16['param_bytes']}, lm_grads' tree "
        f"{want16['grad_bytes']}, moments and step {want16['opt_bytes']}); peak "
        f"{gib(mem['peak_bytes']):.3f} GiB modelled vs 16b's max_memory_allocated "
        f"{want16['peak_gib']:.3f} GiB measured [{smi}] (ratio {ratio16:.4f}); the dry run "
        f"took {dry['t_trace_s']} s")
    if pgo != held:
        raise AssertionError("18b: the dry run's parameter, gradient and optimizer bytes "
                             "differ from 16b's")
    if abs(ratio16 - 1) > DRY_PEAK_REL:
        raise AssertionError(f"18b: the dry run's peak is {ratio16:.3f} of 16b's")
    # (b) 17c's cut: the all-to-alls, which the MoE block issues alike in
    # train_lm's layout (17c: the experts alone over model) and the
    # reference's (tensor parallelism), which the dry run's train steps
    # place; its peak is that placement's, held to the card in phase 19
    dry = rec["17c full"]
    calls = dry["collective_counts"].get("all_to_all", 0)
    each = dry["collectives"].get("all_to_all", 0) / max(calls, 1)
    save = rec["17c save_ffn"]["collective_counts"].get("all_to_all", 0)
    log(f"  18b {TM_NAME} at 17c's cut ({TM_LAYERS} layers, model {TM_MODEL}, a world of "
        f"{TM_MODEL}): the dry run's all-to-alls {calls:.0f} a step of {each:.0f} B "
        f"('save_ffn' {save:.0f}), 17c's profiled step {train17['a2a_full']} of "
        f"{train17['a2a_sizes']} B ('save_ffn' {train17['a2a_save_ffn']}); peak a rank "
        f"{gib(dry['memory']['peak_bytes']):.3f} GiB modelled with every leaf placed by its "
        f"spec (held {dry['memory']['argument_bytes']} B, the reference's "
        f"{dry['spec_argument_bytes']} B) vs 17c's {train17['peak_gib']:.3f} GiB measured "
        f"with the experts alone cut [{smi}]")
    if (calls, save, [each]) != (train17["a2a_full"], train17["a2a_save_ffn"],
                                 train17["a2a_sizes"]):
        raise AssertionError("18b: the dry run's all-to-alls differ from 17c's")
    if dry["memory"]["argument_bytes"] != dry["spec_argument_bytes"]:
        raise AssertionError("18b: the dry run's train step holds other than the "
                             "reference's placement")
    # (c) the card's runs beside the dry run's predictions
    for policy, _ in DRY_POLICIES:
        d = rec[f"16b {policy}"]
        rl = d["roofline"]
        s_step, peak, launches = card[policy]
        log(f"  18c [{smi}] remat '{policy}': launches over {LMT_TIMED} steps "
            f"{ {k: v for k, v in launches.items() if v} } (as planned); {s_step:.4f} "
            f"s/train-step measured (the "
            f"dry run's roofline {max(rl['t_compute'], rl['t_memory']):.4f} s, "
            f"{rl['dominant']}-bound, modelled from data-sheet peaks: {rl['flops']:.4e} FLOP, "
            f"{rl['bytes']:.4e} B), max_memory_allocated {peak:.3f} GiB measured vs "
            f"{gib(d['memory']['peak_bytes']):.3f} GiB modelled "
            f"(ratio {gib(d['memory']['peak_bytes']) / peak:.4f})")
    for name, key in (("expert_ffn", "expert_ffn"), ("flash_attention", "flash_attention"),
                      ("expert_ffn_bwd qwen3-moe-30b-a3b (128 experts top-8)",
                       "expert_ffn_bwd"),
                      ("flash_attention_bwd qwen3-moe-30b-a3b (GQA 32 over 4)",
                       "flash_attention_bwd")):
        rows[name]["launches_remat_policies"] = {p: card[p][2][key] for p, _ in DRY_POLICIES}
    # (d) the production mesh, host only; fits is peak <= HW.hbm_bytes
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  18d [{smi}] the card's total_memory {total} B ({gib(total):.3f} GiB); the dry "
        f"run's fits compares with HW.hbm_bytes {HW.hbm_bytes:.0f} B (data sheet)")
    for label in ("18d qwen3-moe", "18d dit-moe-g"):
        d = rec[label]
        rl = d["roofline"]
        log(f"  {label}: {d['arch']} {d['shape']} on {d['mesh']} ({d['n_chips']} ranks, "
            f"rank 0 on meta, {d['t_trace_s']} s): fits {d['fits']}, peak "
            f"{d['memory']['peak_bytes']} B ({gib(d['memory']['peak_bytes']):.2f} GiB; held "
            f"{d['memory']['argument_bytes']} B, under the reference's specs "
            f"{d['spec_argument_bytes']} B), dominant {rl['dominant']} (compute "
            f"{rl['t_compute']:.4f} s, memory {rl['t_memory']:.4f} s, collective "
            f"{rl['t_collective']:.4f} s: {rl['modeled']})")
    log(f"  18: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 19: tensor parallelism
# ---------------------------------------------------------------------------
TP_NAME = "qwen3-32b"                     # 16b's cut: 2 layers at full width
TP_BATCH, TP_SEQ, TP_SEED = 8, 128, 0
TP_TIMEOUT_S = 600
# (label, data, model, the dry run's opts, timed steps after the warm-up;
# 19c's step is about 10 s over four host-staged gloo ranks)
TP_RUNS = (("19b", 1, 2, "seq_shard,attn_seq", 2), ("19c", 2, 2, "", 1))
# the leaves (b) compares, with the layer taken from the stacked ones
TP_LEAVES = ("embed", "layers/attn/wq", "layers/attn/wk", "layers/ln1/scale")
TOL_TP_BF16_GRAD = 5e-2                   # of each leaf's largest element (bf16 gradients)
# 19a: (label, shape as LMT_FLASH_SHAPES', query parts)
TP_FLASH_OFFSETS = (
    ("qwen3-32b self-attention (GQA 64 over 8), a rank's query half",
     (8, 128, 128, 64, 8, 128, True, None, None), 2),
    ("gemma2-9b local layer over 6,144 tokens, a rank's query half",
     (1, G2_TRAIN_SEQ, G2_TRAIN_SEQ, 16, 8, 256, True, 4096, 50.0), 2),
    ("gemma2-9b global layer over 6,144 tokens, a rank's query half",
     (1, G2_TRAIN_SEQ, G2_TRAIN_SEQ, 16, 8, 256, True, None, 50.0), 2),
)


def _flash_offset_row(smi, gen, label, shape, parts: int, iters: int):
    """One 19a line: the queries of ``shape`` cut into ``parts`` row blocks,
    each at its ``q_offset`` against every key, bf16: the forward's
    log-sum-exp and f32 output against the plain version's (TOL_F32), the
    backward kernel's dq, dk, dv against the plain backward at the offset
    to TOL_BF16 in units of each row's RMS plus ROUNDOFF_TERMS of the
    terms' magnitudes, as 3B holds it; two runs bit for bit; the planted
    fault "offset ignored" (the plain backward at offset 0) must fail by
    10x.  The last block (the most kept pairs) is timed: device time, the
    plain version, the backward of ``scaled_dot_product_attention`` with
    the block's bool ``attn_mask`` (``is_causal`` is top-left aligned), the
    bound over its kept pairs.  Returns the row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.timing import device_ms, time_ms
    B, Sq, Sk, H, KVH, Dh, causal, window, softcap = shape
    masks = dict(causal=causal, window=window, softcap=softcap)
    dtype, tol = torch.bfloat16, TOL_BF16
    kw = dict(generator=gen, device="cuda")
    q, do = (torch.randn((B, Sq, H, Dh), **kw).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Sk, KVH, Dh), **kw).to(dtype) for _ in range(2))
    n = Sq // parts
    extra = "".join(f" {nm} {x}" for nm, x in (("window", window), ("softcap", softcap)) if x)
    err = ratio = 0.0
    for i in range(parts):
        off = i * n
        qi, doi = q[:, off:off + n], do[:, off:off + n]
        name = (f"19a [{smi}] flash_attention_bwd at q_offset {off} {label} B={B} Sq={n} "
                f"Sk={Sk} H={H} KVH={KVH} Dh={Dh}{' causal' if causal else ''} bf16{extra}")
        o, lse, o32 = ops._flash_attention_fwd(qi, k, v, q_offset=off, one_sided_window=True,
                                               want_lse=True, **masks)
        want_o32, want_lse = ref.flash_attention_ref(qi, k, v, q_offset=off,
                                                     one_sided_window=True, stats=True, **masks)
        fwd_err = max(_close_quiet(f"{name} lse", lse, want_lse, TOL_F32),
                      _close_quiet(f"{name} f32 output", o32, want_o32, TOL_F32))
        del want_o32, want_lse
        run = lambda: ops.flash_attention_bwd(qi, k, v, o32, lse, doi,  # noqa: E731
                                              q_offset=off, **masks)
        got, again = run(), run()
        want = ref.flash_attention_bwd_ref(qi, k, v, o32, lse, doi, q_offset=off, **masks)
        terms = ref.flash_attention_bwd_ref(qi, k, v, o32, lse, doi, q_offset=off,
                                            magnitudes=True, **masks)
        torch.cuda.synchronize()
        res = [_row_tol_ratio(g, w, tol, terms=t) for g, w, t in zip(got, want, terms)]
        e, r = max(x[0] for x in res), max(x[2] for x in res)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        fault = ""
        if off:
            wrong = ref.flash_attention_bwd_ref(qi, k, v, o32, lse, doi, **masks)
            f_ratio = max(_row_tol_ratio(g, w, tol, terms=t)[2]
                          for g, w, t in zip(got, wrong, terms))
            fault = (f"; planted fault (offset ignored): {f_ratio:.3f} of the tolerance "
                     f"{'rejected' if f_ratio > 10 else 'NOT REJECTED by 10x'}")
            del wrong
        log(f"  {name}: forward lse / f32 output max_abs_err {fwd_err:.3e} (TOL_F32); dQ, dK, "
            f"dV max_abs_err {e:.3e}, {r:.3f} of the tolerance {'ok' if r <= 1 else 'FAIL'}; "
            f"two runs bit-identical {same}{fault}")
        if r > 1 or not same:
            raise AssertionError(f"{name}: the kernel disagrees with its plain version or "
                                 f"two runs differ")
        if off and f_ratio <= 10:
            raise AssertionError(f"{name}: the check does not reject the offset ignored")
        err, ratio = max(err, e), max(ratio, r)
        del again, want, terms
    ms = time_ms(run, iters)
    dev = device_ms(run, iters, launches_per_call=FLASH_BWD_LAUNCHES)
    plain = time_ms(lambda: ref.flash_attention_bwd_ref(qi, k, v, o32, lse, doi, q_offset=off,
                                                        **masks), 1)
    mask = ref.attention_mask(n, Sk, causal=causal, window=window, device="cuda",
                              q_offset=off, one_sided=True)
    kept = int(mask.sum())
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (qi, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    dot = doi.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,  # noqa: E731
                                           retain_graph=True)
    lib_events = time_ms(sdpa_bwd, iters)
    lib = device_ms(sdpa_bwd, iters)
    flops = 2.5 * 4.0 * B * H * kept * Dh
    nq, nk = B * n * H * Dh, B * Sk * KVH * Dh
    nbytes = 2 * (2 * nq + 2 * nk) + 4 * nq + 4 * B * H * n + 2 * (nq + 2 * nk)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  19a [{smi}] flash_attention_bwd at q_offset {off} {label} bf16: kernel {ms:.4f} ms "
        f"events, {dev:.4f} ms device ({FLASH_BWD_LAUNCHES} launches), plain {plain:.4f} ms, "
        f"backward of scaled_dot_product_attention (bool attn_mask at the offset, enable_gqa"
        f"{'; no softcap, which SDPA does not take' if softcap else ''}) through autograd "
        f"{lib:.4f} ms device ({lib_events:.4f} ms events), kernel / SDPA backward "
        f"{dev / lib:.3f} (device), bound {b_ms:.4f} ms ({b_by}; {kept} kept (query, key) "
        f"pairs, {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB)")
    del q, k, v, do, o, o32, lse, got, qt, kt, vt, ot, mask
    torch.cuda.empty_cache()
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu", replaces=NO_PALLAS,
                launches=0, max_abs_err=err, ms=ms, device_ms=dev, events_ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library_events_ms=lib_events, yardstick_ratio=dev / lib,
                shape=f"{label}: B={B} Sq={n} at q_offset {off} Sk={Sk} H={H} KVH={KVH} "
                      f"Dh={Dh}{' causal' if causal else ''}{extra} bf16")


def phase_tp_kernels(rows, smi):
    """19a, in phase 3 after 3B: see the module docstring."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(31)
    for label, shape, parts in TP_FLASH_OFFSETS:
        big = shape[1] * shape[2] > 1 << 20
        rows[f"flash_attention_bwd at a query offset {label}"] = _flash_offset_row(
            smi, gen, label, shape, parts, iters=3 if big else 20)


def _tp_params(cfg, mesh):
    """This rank's slices of the cut's params (drawn whole on its card from
    TP_SEED, the same on every rank, then cut) and its AdamW state, the
    moments cut over ``data`` where ``opt_state_spec`` says."""
    import torch
    from repro_torch.common import sharding as shard_lib
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import adamw_init
    api = get_model(cfg)
    whole = api.init(cfg, generator=torch.Generator(device=mesh.device).manual_seed(TP_SEED))
    params = shard_lib.shard_lm_params(whole, mesh)
    del whole
    dims = shard_lib.lm_moment_dims(api.init(cfg, generator=None), mesh)
    return params, shard_lib.shard_lm_moments(adamw_init(params), dims, mesh)


def _tp_leaf(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _tp_job(mesh, opts: str, timed: int, want_grads: bool):
    """19b / 19c in each rank: the cut's tensor-parallel step under the dry
    run's ``opts``; with ``want_grads`` first the step-0 loss and rank 0's
    gathered gradients of TP_LEAVES (``embed`` at the batch's rows, with the
    count of other rows not 0); then a warm-up and ``timed`` steps with the
    peak reset before the warm-up and the launch counts set to 0 after it,
    and one profiled step's collectives.  Returns (every rank's numbers,
    rank 0's gradients)."""
    import torch
    from repro_torch.common import sharding as shard_lib
    from repro_torch.common.config import ShapeConfig
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import train_kwargs
    from repro_torch.launch.hlo_cost import collective_counts
    from repro_torch.launch.profile_train import lm_train_config
    from repro_torch.launch.train import lm_grads, lm_train_step
    from repro_torch.models import dense
    cfg = lm_train_config(TP_NAME)
    t0 = time.perf_counter()
    params, opt = _tp_params(cfg, mesh)
    kw = train_kwargs(cfg, ShapeConfig("train_4k", TP_SEQ, TP_BATCH, "train"),
                      tuple(o for o in opts.split(",") if o))
    it = token_batches(cfg.vocab_size, TP_BATCH, TP_SEQ, seed=0, device=mesh.device)
    rows = shard_lib.local_rows(TP_BATCH, mesh)
    b0 = next(it)
    picked, loss0 = {}, None
    if want_grads:
        loss0, g = lm_grads(params, {k: v[rows] for k, v in b0.items()}, cfg, mesh=mesh, **kw)
        cuts = dense.param_cuts(params, cfg, mesh)
        used = torch.unique(b0["tokens"].long())
        for path in TP_LEAVES:
            c = _tp_leaf(cuts, path)
            t = _tp_leaf(g, path)
            t = t if c is None else mesh.model_gather(t, c)
            if path == "embed":
                other = t.abs().sum(1) != 0
                other[used] = False
                picked["embed_other_rows"] = int(other.sum())
                t = t[used]
            else:
                t = t[0]
            picked[path] = t.float().cpu()
            del t
        loss0 = float(loss0)
        del g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0

    def step(b):
        return lm_train_step(params, opt, {k: v[rows] for k, v in b.items()}, cfg,
                             total=1 + timed, mesh=mesh, **kw)

    torch.cuda.reset_peak_memory_stats()
    params, opt, m = step(b0)
    first = float(m["loss"])
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    ms = []
    for _ in range(timed):
        params, opt, m = step(next(it))
        ms.append(m)
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / timed
    peak = torch.cuda.max_memory_allocated()
    counts, offsets = dict(ops.LAUNCHES), dict(ops.FLASH_BWD_OFFSETS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        params, opt, m = step(next(it))
        torch.cuda.synchronize()
    coll = {k: v for k, v in collective_counts(prof).items() if v}
    return _every_rank(dict(
        init_s=init_s, s_per_step=s_per_step, peak=peak, loss0=loss0, first=first,
        losses=[float(x["loss"]) for x in ms], gnorms=[float(x["grad_norm"]) for x in ms],
        counts=counts, offsets=offsets, collectives=coll)), picked


def _tp_single_rank(cfg):
    """(b)'s reference: the single-rank step-0 loss and gradients of
    TP_LEAVES on the card from the same params and batch, on the CPU, the
    card freed after."""
    import torch
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch.train import lm_grads
    from repro_torch.models.api import get_model
    params = get_model(cfg).init(cfg, generator=torch.Generator(device="cuda")
                                 .manual_seed(TP_SEED))
    b0 = next(token_batches(cfg.vocab_size, TP_BATCH, TP_SEQ, seed=0, device="cuda"))
    loss, g = lm_grads(params, b0, cfg)
    used = torch.unique(b0["tokens"].long())
    out = {p: (_tp_leaf(g, p)[used] if p == "embed" else _tp_leaf(g, p)[0]).float().cpu()
           for p in TP_LEAVES}
    loss = float(loss)
    del params, g
    torch.cuda.empty_cache()
    return loss, out


def phase_tensor_parallel(rows, smi):
    """19 (b) and (c): see the module docstring."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.profile_train import lm_train_config
    t_phase = time.perf_counter()
    cfg = lm_train_config(TP_NAME)
    cut = ("--layers", str(cfg.num_layers), "--batch", str(TP_BATCH), "--seq", str(TP_SEQ))
    procs = {label: _dry_start(_dry_cmd(TP_NAME, "train_4k", "--mesh", f"{data}x{model}",
                                        *cut, "--opts", opts))
             for label, data, model, opts, _ in TP_RUNS}
    loss1, want = _tp_single_rank(cfg)
    out = {}
    # four ranks of about 15.4 GiB each share the card in (c): the ranks'
    # allocators grow their segments in place, not leaving blocks of
    # reserved and unused memory beside the peak (max_memory_allocated
    # counts allocations either way)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        spawned = {label: mesh_lib.spawn(
            _tp_job, data * model, data=data, model=model, backend="gloo", device="cuda",
            timeout_s=TP_TIMEOUT_S, args=(opts, timed, label == "19b"))
            for label, data, model, opts, timed in TP_RUNS}
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    for label, data, model, opts, timed in TP_RUNS:
        (ranks, picked), counts = spawned[label]
        plan = _planned_train_launches(cfg, timed)
        plan_run = _planned_train_launches(cfg, timed + 1)     # with the profiled step
        dry = _dry_finish(f"{label} dry run", procs[label])
        peak_dry = dry["memory"]["peak_bytes"]
        coll_dry = {k: int(v) for k, v in dry["collective_counts"].items() if v}
        r0 = ranks[0]
        log(f"  {label} [{smi}] {TP_NAME} at 16b's cut ({cfg.num_layers} layers, "
            f"{TP_BATCH} x {TP_SEQ}, bf16 params, f32 moments) on data {data} x model {model} "
            f"gloo ranks sharing the card, opts {opts or 'none'}: setup {r0['init_s']:.1f} s, "
            f"{[round(r['s_per_step'], 4) for r in ranks]} s/train-step a rank; step-0 "
            f"loss {r0['first']:.5f} (single rank {loss1:.5f}); losses "
            f"{[round(x, 4) for x in r0['losses']]}, grad norms "
            f"{[round(x, 3) for x in r0['gnorms']]}; launches a rank over {timed} steps "
            f"{ {k: v for k, v in r0['counts'].items() if v} } (offset backward by shape: "
            f"{[r['offsets'] for r in ranks]}); max_memory_allocated a rank "
            f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB measured vs "
            f"{peak_dry / 2**30:.3f} GiB modelled by the dry run (held "
            f"{dry['memory']['argument_bytes']} B, under the reference's specs "
            f"{dry['spec_argument_bytes']} B); collectives a step (rank 0's profile) "
            f"{r0['collectives']}, the dry run's {coll_dry}")
        if not math.isclose(r0["first"], loss1, rel_tol=TOL_LM_BF16_LOSS):
            raise AssertionError(f"{label}: the step-0 loss {r0['first']} is not the single "
                                 f"rank's {loss1}")
        for r, c in zip(ranks, counts):
            if r["counts"] != plan or c != plan_run:
                raise AssertionError(f"{label}: launches {r['counts']} over the timed steps "
                                     f"({c} over the run) differ from the plan's {plan} "
                                     f"({plan_run})")
            if not all(math.isfinite(x) for x in r["losses"] + r["gnorms"]):
                raise AssertionError(f"{label}: a loss or grad norm is not finite")
            if abs(r["peak"] / peak_dry - 1) > DRY_PEAK_REL:
                raise AssertionError(f"{label}: the peak {r['peak']} B is not within "
                                     f"{DRY_PEAK_REL} of the dry run's {peak_dry} B")
            if r["collectives"] != coll_dry:
                raise AssertionError(f"{label}: the collectives {r['collectives']} differ "
                                     f"from the dry run's {coll_dry}")
        if dry["memory"]["argument_bytes"] != dry["spec_argument_bytes"]:
            raise AssertionError(f"{label}: the dry run holds other than the reference's "
                                 f"placement")
        if picked:
            if picked.pop("embed_other_rows"):
                raise AssertionError(f"{label}: embed's gradient is not 0 outside the "
                                     f"batch's rows")
            for path, w in want.items():
                g = picked[path]
                e, top = float((g - w).abs().max()), float(w.abs().max())
                log(f"  {label} [{smi}] step-0 gradient of {path}"
                    f"{' (the batch rows)' if path == 'embed' else ' (layer 0)'} "
                    f"{tuple(g.shape)} vs the single rank: max_abs_err {e:.3e}, "
                    f"{e / top:.3e} of its largest {top:.3e} (bound {TOL_TP_BF16_GRAD})")
                if not e <= TOL_TP_BF16_GRAD * top:
                    raise AssertionError(f"{label}: {path}'s gradient differs from the "
                                         f"single rank's")
            if abs(r0["loss0"] - loss1) > TOL_LM_BF16_LOSS * abs(loss1):
                raise AssertionError(f"{label}: lm_grads' loss differs")
        out[label] = dict(ranks=ranks, counts=counts, dry=dry)
    tp = out["19b"]["ranks"]
    key = (TP_BATCH, TP_SEQ // 2, TP_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           True, None, None)
    row = rows[f"flash_attention_bwd at a query offset {TP_FLASH_OFFSETS[0][0]}"]
    row["launches"] = sum(r["offsets"].get(key, 0) for r in tp)
    if not row["launches"]:
        raise AssertionError(f"19b: no offset backward at {key} launched")
    row["launches_tp_per_rank"] = [r["counts"]["flash_attention_bwd"] for r in tp]
    for name in ("flash_attention", "flash_attention_bwd"):
        if name in rows:
            rows[name]["launches_tp_per_rank"] = {lab: [r["counts"][name] for r in o["ranks"]]
                                                  for lab, o in out.items()}
    log(f"  19: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(no src/repro_torch beside this script)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == [PARENT_FLAG]:
        return time_parent_scan_bwd(sys.argv[2], json.loads(sys.argv[3]))
    with phase("1 environment"):
        smi = phase_environment()
    with phase("2 build"):
        phase_build()
    with phase("3 kernels vs plain versions"):
        rows = phase_kernels()
        # 3L before 3G and 3B: a whole run's later profiler traces have
        # dropped launches (a 3L trace held 2 of 5 when it came last)
        phase_lm_kernels(rows, smi)
        phase_family_kernels(rows, smi)
        phase_lm_train_kernels(rows, smi)
        phase_tp_kernels(rows, smi)
        phase_g_kernels(rows, smi)
        phase_backward_kernels(rows, smi)
        phase_scan_backward(rows, smi)
    with phase("4 kernels in place (tiny DiT and smoke RWKV-6, cpu vs cuda)"):
        phase_tiny()
        phase_smoke_lm()
    with phase("5 main path 1 (DiT-MoE-XL, dice + int8_residual; other schedules)"):
        phase5 = phase_xl(rows)
    with phase("6 main path 2 (rwkv6-3b prefill + decode, bf16)"):
        phase_lm(rows)
    with phase("7 main path 3 (continuous serving, DiT-MoE-XL)"):
        phase_continuous_tiny()
        phase_continuous_xl(rows)
    with phase("8 main path 4 (expert parallelism on the one card: ep=1 nccl, "
               "ep=2 gloo)"):
        phase_ep(rows)
    with phase("9 main path 5 (checkpoint, telemetry, top-k codec, resilience; "
               "DiT-MoE-XL width)"):
        phase_main5(phase5)
    with phase("10 main path 6 (DistriFusion at XL, the dp x ep x patch mesh, "
               "expert placement)"):
        patch_single = phase_patch_tiny()
        phase_distrifusion(rows, phase5)
        phase_hier(rows, patch_single)
        phase_placement(rows)
    with phase("11 main path 7 (expert paging: the 4-layer DiT over 4 ranks, "
               "DiT-MoE-G width at ep=2)"):
        phase_paged_tiny(smi)
        phase_g_paging(rows, smi)
    with phase("12 main path 8 (training: the tiny DiT cpu vs card, DiT-MoE-XL width, "
               "the quality ordering; 12a ran at the end of phase 3)"):
        tiny_cfg, tiny_params = phase_train_tiny(smi)
        phase_train_xl(rows, smi)
        phase_train_quality(tiny_cfg, tiny_params, smi)
    with phase("13 main path 9 (RWKV-6 training: the smoke model cpu vs card, rwkv6-3b "
               "at full width and depth; 13a ran at the end of phase 3)"):
        phase_train_lm_smoke(smi)
        phase_train_lm_full(rows, smi)
    with phase("14 main path 10 (dense and MoE LMs: the six smoke configs cpu vs card, "
               "gemma2-9b at full width and depth, qwen3-moe-30b-a3b at full width; "
               "3L ran in phase 3)"):
        phase_lm_smoke_card(smi)
        phase_gemma2_full(rows, smi)
        phase_moe_full(rows, smi)
    with phase("15 main path 11 (hybrid, audio and VLM families: the smoke configs cpu vs "
               "card, zamba2-7b, seamless-m4t-large-v2 and llama-3.2-vision-11b at full "
               "width and depth; 3F ran in phase 3)"):
        phase_family_smoke_card(smi)
        phase_family_full(rows, smi)
    with phase("16 main path 12 (training every LM family but RWKV-6: the ten smoke configs "
               "cpu vs card, eight runs at full width; their 3B lines ran in phase 3)"):
        phase_lm_train_smoke(smi)
        train16 = phase_lm_train_full(rows, smi)
    with phase("17 main path 13 (training over a data x model mesh: make_local_mesh on one "
               "nccl rank, data 2 x model 2 gloo ranks card vs cpu, qwen3-moe-30b-a3b at "
               "full width over model 2)"):
        train17 = phase_train_mesh(rows, smi)
    with phase("18 the dry run against the card (the fake world; 16b's and 17c's cuts "
               "modelled and measured; the remat policies on the card; the production mesh, "
               "host only)"):
        phase_dry_run(rows, smi, train16, train17)
    with phase("19 main path 14 (tensor parallelism: qwen3-32b at 16b's cut over model 2, "
               "seq_shard + attn_seq, against the single rank and the dry run; ZeRO on data 2 x "
               "model 2; 19a ran in phase 3)"):
        phase_tensor_parallel(rows, smi)
    keys = ("name", "route", "source", "replaces", "launches", "launches_continuous",
            "launches_ep2_per_rank", "launches_distrifusion", "launches_hier_per_rank",
            "launches_placed_per_rank", "launches_train", "launches_train_lm",
            "launches_train_mesh_per_rank", "launches_remat_policies", "launches_tp_per_rank",
            "launches_forward",
            "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "yardstick_ms", "yardstick_ratio",
            "fp32_bound_ms", "fwd_ms", "bwd_over_fwd", "parent_events_ms",
            "device_ms",
            "events_ms", "shape")
    log(json.dumps({"kernels": [{k: rows[n][k] for k in keys if k in rows[n]}
                                for n in rows]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
