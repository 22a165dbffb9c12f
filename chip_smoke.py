#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. It builds the port's CUDA kernels with
nvcc (one process per source, in parallel), then runs twenty-four phases
and fails (non-zero exit, no result line) if any of them fails:

1. device: the card's name and power limit, the kernels' ptxas report;
2. every kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at the edge cases, with stated tolerances;
   ``mha_fwd`` on the route its wrapper picks (``mma`` tensor cores,
   ``fma`` or ``decode``), with the route counted, and the fma kernel
   also at the eval shape in bf16; ``mha_bwd_dq`` and ``mha_bwd_dkv`` on
   the route their wrappers pick (``mma`` tensor cores for bf16, ``fma``
   for f32 and for gemma-2b's bf16 heads of 256 over one kv head),
   counted, and the fma kernels also at the training shape in bf16; the
   xent kernels on the route their wrappers pick (for aligned
   bf16 ``wgmma``, the forward on wgmma and TMA, and ``mma``, the chunked
   tensor-core backward; ``fma`` for f32 and other layouts), counted,
   with each backward output's largest error over its tolerance, at
   llama-1b's, llama-7b's (D = 4096) and gemma-2b's (V = 256000) loss
   shapes among others (and a D of 4100 that ends the FMA kernels' last
   slab of D mid-way; the widest heads, of phases 16-19, in bf16 on the
   tensor-core routes alone); the same three kernels with ``transposed=True``
   (the tied head, w stored (V, D) and read in place) on the tied head's
   own routes (``wgmma_t``, ``mma_t``; ``fma_t`` for f32, a non-contiguous
   h and other layouts), counted, at llama-1b's and gemma-2b's tied loss
   shapes, a V of 32003 with ``vocab_size`` 32000, two token chunks and a
   single ragged row, dW (V, D) with zero padded rows, and the optimizer
   kernels also at gemma-2b's tied head (1, 256000, 2048); the tensor-core forwards, the
   optimizer, cross-entropy and attention-backward kernels also run twice
   (bitwise equal), and the optimizer kernels show that they write in
   place where the TPU kernels alias; ``update_apply`` on its ``vec`` route
   (16-byte vectors over the flat run) at a common offset of 0-7 elements
   of theta and g, for bf16, bf16 with an f32 g and f32, col and row, lr
   and gscale by value and by device pointer, bitwise equal to its
   ``strided`` route on the same values laid out transposed, with both
   routes counted; the segment clause of the three attention kernels
   (packed documents) against the plain versions under the dense mask, on
   every route each takes (``mma``; ``fma`` for f32, gemma-2b's heads of
   256 over one kv head and hd != hdv; ``decode`` at S <= 4), at a packed
   llama-1b batch's ids at the train shape, llama-7b's hd 128, a GQA
   shape and a ragged S of 250, non-causal S != T with q and kv ids of
   their own and rows whose id no key has (0 out, lse -1e30, dQ 0, dK and
   dV unmoved by their dO), unsorted ids, each case's largest error over
   its tolerance printed, bitwise repeatable, counted by route and in
   ``segment_launches``; all-equal ids bitwise the no-segment result on
   every route; the three attention kernels at MLA's widths (queries and
   keys 192 wide, values 128, 128 heads over 128 kv heads, causal; B 2
   and phase 17's train batch of 16 x 256), bf16 and f32, on the ``fma``
   route, and the xent kernels at deepseek-v3's head (D 7168, V 129280,
   bf16);
3. the serving path: greedy serving of llama-130m at full width and
   depth (bf16, seeded random weights; batch 8, a 512-token prompt, 64
   new tokens), checked against a full-sequence forward, with the kernel
   launch counts of the run (the prefill's on the ``mma`` route, every
   decode step's on ``decode``);
4. kernel times with CUDA events beside their bound, the plain version
   and one PyTorch library call computing the same function; for the
   attention kernels also their device time (torch.profiler) and, where
   they take the tensor cores, the fma kernels' time at the same shape
   (the backward pair at the training shape and at qwen2-500m's GQA
   shape), and, as ``mha_fwd``, at phase 9's training shapes of llama-7b
   (hd 128) and gemma-2b (hd 256, the fma route); for the xent kernels,
   at llama-1b's, llama-7b's and gemma-2b's loss shapes, also their device
   time and, for the backward, a second library yardstick that recomputes
   the logits, at llama-1b's and llama-7b's also the FMA kernels (one and
   two slabs of D), and
   variants of the xent sources built beside them, timed against the
   real kernels (of the backward: the fold taken out, the copies taken
   out; of the forward: the softmax epilogue taken out, and the wgmma
   too); the transposed xent kernels at llama-1b's and gemma-2b's tied
   shapes beside the untied kernel on a (D, V) copy and the library call
   (``h @ w.T`` + ``F.cross_entropy`` and its autograd); the optimizer kernels and their library calls also by device
   time, in turns; ``update_apply`` also at the head (bf16 theta, f32 m')
   and, in turns, beside its ``strided`` route on the same bytes and a
   variant that only loads and stores them; the three attention kernels
   at the packed train shape with segments, in turns with the same kernel
   without them, beside the plain version, SDPA with the dense boolean
   mask (and its backward), the bound of the pairs the batch's ids leave
   and the share of tile pairs the skip removes; the three attention
   kernels at deepseek-v3's train shape (``fma``, hd 192 / hdv 128) beside
   SDPA on the backend that takes hdv != hd (named), and the xent kernels
   at its head;
5. where the serving time goes: device busy time and the top kernels of
   one prefill and of decode steps, from torch.profiler;
6. the optimizer path: SCALE steps of llama-1b at full width and depth
   (bf16 params and grads from the seed, the clip factor from the global
   norm, ``scale_fused`` with the warmup-cosine schedule and lr_scaling):
   three ``update_params`` steps and three ``update`` + ``apply_updates``
   steps, their kernel launch counts checked per step (``update_apply``'s
   on the ``vec`` route), the result held
   against ``impl="jnp"`` on the same card, one step under
   ``torch.cuda.set_sync_debug_mode("error")``, step times beside the
   bound, the step's device busy time and top kernels (torch.profiler),
   and peak memory;
7. the loss path: llama-1b at full width and depth (bf16, seeded random
   weights; batch 16 of 256 tokens from the ported ``SyntheticLM``):
   ``make_eval_step`` (exactly 24 ``mha_fwd``, all on the ``mma`` route,
   and 1 ``xent_fwd``, on ``wgmma``), its loss against the plain
   full-logit route on the same hidden, against a forward whose attention
   is the plain ``mha_fwd_ref``, and beside ln(V) + sigma^2/2; the loss
   and its gradient at the head (exactly 1 launch of each xent kernel, the
   forward on ``wgmma``, the backward pair on ``mma``), held against the
   plain route's autograd, once under ``set_sync_debug_mode("error")``; times,
   top device kernels and the peak memory each route adds;
8. the training step: llama-1b at full width and depth (bf16, seeded
   random weights, batches of 16 x 256 from ``SyntheticLM``,
   ``scale_fused`` with clip 1.0 and ``remat="full"``): the launcher's
   ``main`` for three steps, then ``make_train_step`` for eight, each step's
   launches checked on every kernel counter (48 ``mha_fwd``, all on the
   ``mma`` route, 24 of each attention backward kernel, all on the ``mma``
   route, one of each xent kernel, the forward on ``wgmma``, the backward
   pair on ``mma``, 8 ``norm_sumsq``, 9 ``update_apply``, all on the
   ``vec`` route, one ``momentum_sumsq``), the loss falling and held to
   the curve of the same steps with attention through plain ``mha_fwd_ref``
   autograd, one step under ``set_sync_debug_mode("error")``, every leaf's
   gradient held against the plain-attention route (bf16 at full depth,
   f32 at 4 layers), the step's time, tokens/s, device busy time, idle
   share, top kernels and peak memory;
9. the training step of the paper's two largest models at full width and
   depth: llama-7b (32 layers, D = 4096, 32 heads of 128) and gemma-2b (18
   layers, 8 heads of 256 over one kv head, vocab 256000), each through
   the launcher for two steps and then ``make_train_step`` for four
   (bf16, batches of 16 x 256, ``scale_fused``, clip 1.0), every step's
   launches checked by route (llama-7b: 64 ``mha_fwd``, 32 of each
   attention backward kernel, all ``mma``; gemma-2b: 36, 18 and 18, all
   ``fma``; both: one of each xent kernel, the forward on ``wgmma`` and
   the backward on ``mma``, 8 ``norm_sumsq``, 9 ``update_apply`` on
   ``vec``, one ``momentum_sumsq``), the loss curve held to the same
   steps with attention through plain ``mha_fwd_ref`` autograd from the
   same seeded weights (full depth: the two routes run one after the
   other), step time, tokens/s, device busy time by kernel family, idle
   share and peak memory;
10. the optimizer zoo: (a) every name of the registry (and
   ``sgd_colnorm``/``sgd_rownorm`` also with ``impl="fused"``) trains
   llama-1b at full width and 2 layers (bf16, batches of 16 x 256 from
   ``SyntheticLM``, clip 1.0, a constant lr) through ``make_train_step``
   for three steps: finite losses and state, every updated label group
   moved, each step's optimizer-kernel launches by route (none for the
   names that never fuse; ``norm_sumsq`` and ``update_apply`` on ``vec``
   per matrix for the fused ablations; 8/9/1 for ``scale_fused``), one
   more step under ``set_sync_debug_mode("error")`` (all but
   ``sgd_svdnorm``, whose SVD checks its status on the host); the fused
   ablations against ``impl="jnp"`` on the same gradients; the
   Newton-Schulz, SVD and SWAN normalizations, the Adam and AdamS leaf and
   the GaLore projection and its inverse at llama-1b's w_gate and head
   against the same calls on the CPU; ``adam`` and ``muon`` through the
   launcher's ``main`` at full depth; (b) the paper's memory axis at full
   depth (24 layers): ``memory.py``'s methods (SCALE as ``scale_fused``)
   and ``adams``, two steps each, with the second step's time and
   tokens/s, peak memory, the optimizer state's allocated bytes beside
   ``memory_report`` in f32 and under the paper's bf16 protocol, and
   SCALE's peak over Adam's; GaLore and Fira at the largest depth whose
   first step (the SVD of every hidden matrix) fits its budget;
11. fault-tolerant training, llama-1b at full width and depth (bf16,
   batches of 16 x 256, ``scale_fused``, clip 1.0, ``GuardPolicy()``),
   checkpoints in a temporary directory removed at the end: (a) five
   guarded ``make_train_step`` steps with ``nan_grad@2`` (each step's
   launches checked by route as phase 8's; the skipped step launches
   them too) bitwise equal, in every leaf of params, optimizer state
   and guard, to the clean guarded run over the batches of steps 0, 1,
   3 and 4; one guarded step under ``set_sync_debug_mode("error")``;
   step time and peak memory with the guard on and off, in turns; (b)
   ``save`` of the whole ``TrainState`` (bytes, s, GB/s), how long
   ``save_async`` blocks and when it commits, ``restore_latest``
   (bitwise), and with the newest shard corrupted the fallback to the
   previous step, with its warning; (c) the launcher's ``main`` for 6
   steps with ``--ckpt-every 3``, against the same run's committed step
   3 resumed with ``--resume auto``: step 6's leaves bitwise equal; (d)
   ``python -m repro_torch.launch.train`` training llama-130m at full
   width and depth in a subprocess, sent SIGTERM after its first loss
   line: exit 0, its ``sigterm: checkpointed step N`` line, and a
   ``COMMITTED`` step N that restores;
12. tied-embedding training, llama-1b (the paper's main path with
   ``--tie-embeddings``) and gemma-2b (18 layers, vocab 256000) at full
   width and depth (bf16, batches of 16 x 256, ``scale_fused`` under
   ``LabelRules.tied()``, clip 1.0): the launcher with
   ``--tie-embeddings`` for two steps; one loss-and-grad against the same
   call with the plain xent versions swapped into ``dispatch`` (the
   embedding's gradient, the lookup's plus the head's, and every leaf);
   ``make_train_step`` for eight steps, each step's launches checked by
   route (one of each xent kernel on ``wgmma_t``/``mma_t`` and none on
   an untied route, 7 ``norm_sumsq``, 8 ``update_apply`` on ``vec``, one
   ``momentum_sumsq``: the tied embedding takes the momentum branch),
   their loss curve held to the same steps through the plain xent
   versions; one step under ``set_sync_debug_mode("error")``; step time,
   tokens/s, device busy time by kernel family, idle share and peak
   memory. The transposed kernels' rows of the kernels line are named
   ``xent_fwd transposed`` etc., their launches those of this phase;
13. packed-document training, llama-1b at full width and depth
   (``--pack-documents``, 16 x 256 first-fit packed ``SyntheticLM``
   batches): the launcher for two steps; one loss-and-grad against the
   plain attention swapped into ``dispatch``, every leaf; eight
   ``make_train_step`` steps, each step's launches checked by route and
   with segments (48 ``mha_fwd``, 24 of each backward kernel, all ``mma``
   and all with segments, and phase 8's xent and optimizer counts), the
   loss curve held to the same steps through the plain attention; each
   document's per-token losses against its offset-preserving unpacked
   row; document 1 of a row perturbed, every other document's losses
   bitwise unchanged; one step under ``set_sync_debug_mode("error")``;
   step time, real tokens/s, device busy time by kernel family, idle share
   and peak memory beside phase 8's. The segment rows of the kernels line
   are named ``mha_fwd segments`` etc., their launches those of this
   phase;
14. the telemetry plane, llama-1b at full width and depth (phase 8's
   configuration, guard on): four ``make_train_step`` steps with
   ``StatsPolicy(every_k=1)`` bitwise equal to four without (every
   parameter, optimizer-state and guard leaf), each launching phase 8's
   kernels and one more ``norm_sumsq`` a leaf of two or more dimensions
   (the column norms); the Fig. 4/10 stats per layer group; one stats step
   under ``set_sync_debug_mode("error")``; the groups' squared gradient
   and update norms against the step's own, and the column-norm max,
   median and dispersion against plain torch on ``value_and_grad``'s
   gradients; the step time (host clock, best of 6 in turns) and peak
   without stats, off the cadence (within 2% of without) and on every
   step; the launcher for 6 steps with ``--log-dir``, ``--metrics-every
   2``, ``--stats-every 2`` and ``--profile-steps 2:3``, its JSONL
   validated (kinds, steps, stats on steps 2, 4 and 6 only, memory and
   time keys, no metric a string) and its trace naming ``train_step``
   and ``obs_stats``; ``greedy_generate(logger=...)`` at phase 3's
   llama-130m shape, both ``serve`` records valid. The kernels line's
   ``norm_sumsq`` row gains a ``train stats`` path;
15. sharded training: (i) the ``col_offset`` clause of the three xent
   kernels at llama-1b's head (N 4096, D 2048, V 32000, bf16), untied
   and tied, cut into 2 and 4 vocabulary shards (column or row slices of
   the one head): each shard against its plain version with its
   col_offset, on the route it takes; the shards' combined (lse, ll),
   summed f32 dH and put-together f32 dW against the unsharded kernels on
   the whole head; per shard the kernel's time (CUDA events and device
   time), the plain version's, the bound and the library call for the
   same shard; (ii) two ranks on the one card (``gloo``, both on cuda:0):
   the sharded ``dispatch.xent_loss`` forward and backward at llama-1b's
   head on a (1, 2) mesh, untied and tied (rank 1's shard at col_offset
   16000), and the sharded SCALE entry points at llama-1b's full leaf
   shapes (the head, the stacked wq) on (2, 1) and (1, 2), col and row,
   each against the same call unsharded on the rank; (iii)
   ``make_train_step(rules, mesh)`` on a (1, 1) NCCL mesh at llama-1b's
   full width and depth for three steps (parameters DTensors placed per
   the rules), each step's launches as phase 8's, the losses against
   phase 8's from the same weights and batches, and the step time beside
   phase 8's. The kernels line gains the rows ``xent_fwd col_offset``,
   ``xent_bwd_dh col_offset`` and ``xent_bwd_dw col_offset`` (launches at
   a non-zero col_offset on the ``sharded`` path, whose other launches
   are (ii)'s and (iii)'s);
16. the MoE family and the ``ARCH_IDS`` configs: (i) the launcher with
   ``--arch dbrx-132b --smoke`` for two steps; dbrx-132b at full width
   (d_model 6144, 48 heads over 8 of 128, 16 experts top-4, moe_d_ff
   10752, vocab 100352) and 2 of its 40 layers (bf16, 16 x 256
   ``SyntheticLM`` batches: 2 groups of 2048 tokens, capacity 640;
   ``scale_fused``, clip 1.0, full remat): three ``make_train_step``
   steps, each step's launches checked by route (4 ``mha_fwd``, 2 of each
   attention backward kernel, all ``mma``; one of each xent kernel,
   ``wgmma`` and ``mma``; 6 ``norm_sumsq``, 7 ``update_apply`` on ``vec``,
   one ``momentum_sumsq``: the 4-D expert leaves take the optimizer's
   plain stage route, as in JAX), the loss and aux held to the same steps
   with every kernel through its plain version, the step time
   (best of steps 2-3), tokens/s, peak memory, and one step's device time
   by family (the MoE layer's spans: expert products, dispatch, combine,
   the router; the stage route on the 4-D leaves, the hand-written
   kernels, the step's own norms and copies); (ii) dbrx serving from the
   same seeded weights, batch 4, a 256-token prompt, 32 new tokens: at
   cf = E/k (no pair dropped) the last decode logits against a full
   forward (f32 within the serving tolerance; bf16 within twice the
   lower of its floors, the same check with plain attention and on a
   dense twin of dbrx's widths), prefill and decode ms, launches by
   route; at the config's cf 1.25 the decode ms and the share of (token,
   choice) pairs the decode steps drop; (iii) qwen2-7b, granite-3-8b
   (vocab 49155 padded to 49280), deepseek-67b and mistral-large-123b
   (d_model 12288) at full width and 2 layers: two ``make_train_step``
   steps with their launches checked by route and their losses against
   the same steps with every kernel plain, step time and peak. The
   kernels line gains the paths ``train moe``, ``serve moe`` and ``train
   arch``;
17. MLA and deepseek-v3-671b: (i) the launcher with ``--arch
   deepseek-v3-671b --smoke`` for two steps; deepseek-v3 at full width
   (d_model 7168, 128 MLA heads with q_lora 1536, kv_lora 512, qk 128 +
   64, v 128; d_ff 18432; top-8 experts of moe_d_ff 2048 and a shared
   one; vocab 129280), its 3 dense layers and 1 MoE layer, with 64 of its
   256 experts (printed as the ``reduced`` list), bf16, 16 x 256
   ``SyntheticLM`` batches, ``scale_fused``, clip 1.0, full remat: three
   ``make_train_step`` steps, each step's launches checked by route (8
   ``mha_fwd``, 4 of each attention backward kernel, all ``fma`` at hd
   192 / hdv 128; one of each xent kernel, ``wgmma`` and ``mma``; 18
   ``norm_sumsq``, 19 ``update_apply`` on ``vec``, one
   ``momentum_sumsq``), the loss and aux held to the same steps with
   every kernel through its plain version, step time, tokens/s,
   peak, and one step's device time by family (the MLA projections and the
   MoE layer by their spans; attention, xent, the optimizer's parts timed
   apart); (ii) serving with all 256 experts at the same 4 layers (bf16,
   batch 4, a 256-token prompt, 32 new tokens): prefill and decode ms at
   cf E/k and 1.25, the prefill's 4 ``mha_fwd`` on ``fma`` (the absorbed
   decode launches no kernel), one decode step's device time and idle
   share; at cf E/k the last decode logits against a full forward in
   bf16 within twice the floor of the same check with plain attention;
   a witness that runs no decode on its reference side, at the training
   cut (64 experts) and at the 3 dense layers alone: the bf16 decode
   against the same steps in f32 from the same bf16 weights, within
   twice the bf16 full forward's distance from the f32 one, and the f32
   decode against the f32 full forward within the serving tolerance.
   The kernels line gains the paths ``train mla`` and ``serve mla``.
18. Mamba2 and mamba2-370m: (i) the launcher with ``--arch mamba2-370m
   --smoke`` for two steps; mamba2-370m at full width and all 48 layers
   (d_model 1024, 32 heads of 64 over a state of 128, chunk 256; vocab
   50280), bf16, 4 x 1024 ``SyntheticLM`` batches (4 chunks a row),
   ``scale_fused``, clip 1.0, full remat: three ``make_train_step``
   steps, each step's launches checked by route (no attention kernel;
   one of each xent kernel, ``wgmma`` and ``mma``; 3 ``norm_sumsq``, 4
   ``update_apply`` on ``vec``, one ``momentum_sumsq``) and its grad norm
   finite, the losses held to the same steps with every kernel through
   its plain version, step time, tokens/s, peak, and one step's device
   time by family (the Mamba2 layer by its spans); (ii) serving (bf16,
   batch 8, a 512-token prompt, 64 new tokens): prefill and decode ms,
   no hand-written kernel launched, one decode step's device time and
   idle share, and the witness of phase 17: the f32 decode against the
   f32 full forward within the serving tolerance, the bf16 decode
   against the same steps in f32 from the same bf16 weights. Phase 2
   holds the xent kernels at its head (D 1024, V 50304 of 50280) and the
   optimizer kernels at its ``in_proj``, ``out_proj``, embedding and
   head. The kernels line gains the path ``train mamba2``.
19. the hybrid jamba-1.5-large-398b: (i) the launcher with ``--arch
   jamba-1.5-large-398b --smoke`` for two steps; (ii) one super-block of
   period 2 at full width (attention + MLP, then Mamba2 + MoE: d_model
   8192, 64 heads over 8 of 128, d_ff 24576, top-2 of moe_d_ff 24576,
   Mamba2 of 256 heads of 64 over a state of 128, chunk 256; vocab
   65536) with 4 of its 16 experts (the ``reduced`` list), bf16, 4 x 1024
   ``SyntheticLM`` batches, ``scale_fused``, clip 1.0, full remat: three
   ``make_train_step`` steps, each step's launches checked by route (2
   ``mha_fwd``, 1 of each attention backward kernel, all ``mma``; one of
   each xent kernel, ``wgmma`` and ``mma``; 11 ``norm_sumsq``, 12
   ``update_apply`` on ``vec``, one ``momentum_sumsq``) and its grad norm
   finite, the loss and aux held to the same steps with every kernel
   through its plain version, step time, tokens/s, peak, idle share and
   one step's device time by family (attention, the Mamba2 and MoE
   layers by their spans, the head, the work outside the model timed
   apart); (iii) serving the same super-block with all 16 experts (bf16,
   batch 4, a 512-token prompt, 32 new tokens) at cf E/k and 1.25:
   prefill and decode ms, the prefill's ``mha_fwd`` on ``mma`` and each
   decode step's on ``decode``, one decode step's device time and idle
   share, the bf16 decode against a full forward within twice the floor
   of the same check with plain attention, and the witness of phases
   17-18 at the training cut's 4 experts. Phase 2 holds the attention
   kernels at its train batch, prefill and decode, the xent kernels at its
   head (D 8192, V 65536) and the optimizer kernels at its ``in_proj``,
   ``out_proj``, router and head. The kernels line gains the paths
   ``train jamba`` and ``serve jamba``.
20. the VLM llama-3.2-vision-11b: (i) the launcher with ``--arch
   llama-3.2-vision-11b --smoke`` for two steps; all 8 super-blocks at
   full width (cross-attention + MLP, then 4 x (self-attention + MLP):
   d_model 4096, 32 heads over 8 of 128, d_ff 14336, vocab 128256; 4096
   image tokens a row), bf16 with the data pipeline's f32 images, 4 x
   1024 ``SyntheticLM`` batches, ``scale_fused``, clip 1.0, full remat:
   three ``make_train_step`` steps, each step's launches checked by route
   (the self-attention on ``mma``, the cross-attention on ``fma``: its q
   promoted to the images' f32, as JAX's arithmetic is; one of each xent
   kernel; 36 ``norm_sumsq``, 37 ``update_apply``, one
   ``momentum_sumsq``), the losses held to the same steps with every
   kernel through its plain version, step time, peak and one step's
   device time by family (the cross sub-layer by its spans
   ``cross_kv`` and ``cross_attn``); (ii) one step with bf16 images,
   every attention launch on ``mma``, its loss against the f32 images'
   first step's; (iii) serving with images (batch 4, a 512-token prompt,
   32 new tokens): the prefill's cross-attention on ``fma`` and
   self-attention on ``mma``, each decode step's on ``decode`` (the
   cross with no ``kv_len`` over the 4096 image keys, its keys and
   values recomputed from the images each step, as JAX's are), one
   decode step's device time, and the witness of phases 17-19 with the
   images. Phase 2 holds the attention kernels at its cross-attention
   (1024 queries over 4096 keys, non-causal), its decode step over the
   image keys and its self-attention, in f32 and bf16, and the xent
   kernels at its head (D 4096, V 128256, bf16); phase 4 times the
   cross-attention's three kernels in f32 against the plain versions and
   SDPA. The kernels line gains the paths ``train vlm``, ``train vlm bf16
   images`` and ``serve vlm``.
21. the audio musicgen-medium: (i) the launcher with ``--arch
   musicgen-medium --smoke`` for two steps; the full model (48 layers,
   d_model 1536, 24 heads of 64, d_ff 6144; 4 codebooks of 2048: a (4,
   2048, 1536) embedding summed over the codebooks and 4 heads) in bf16,
   4 x 4 x 1024 ``SyntheticLM`` batches, ``scale_fused``, clip 1.0, full
   remat: three steps, each step's launches checked by route (attention
   on ``mma``; each xent kernel 4 times, once a head; 8 ``norm_sumsq``, 9
   ``update_apply``, one ``momentum_sumsq`` on the (4, 1536, 2048) head),
   the losses against every kernel plain, step time, peak, device time by
   family; (ii) serving (batch 4 of 4 codebooks, a 512-frame prompt, 32
   new frames, each codebook's own argmax): prefill and decode ms, the
   prefill's attention on ``mma`` and each decode step's on ``decode``,
   the witness, and ``greedy_generate``'s JAX-faithful (B, n, 1) output.
   Phase 2 holds the attention kernels at its shape, the xent kernels at
   one head (D 1536, V 2048) and the optimizer kernels at its 3-D head
   and embedding. The kernels line gains the paths ``train musicgen``
   and ``serve musicgen``.
22. MoE and MLA on a ("data", "model") mesh: (i) two ``gloo`` ranks on
   cuda:0 (spawned, as phase 15 (ii)) on a (1, 2) mesh: dbrx-132b's MoE
   layer at full width (d_model 6144, 16 experts top-4, moe_d_ff 10752;
   16 x 256 tokens, 2 groups of 2048, capacity 640) and deepseek-v3's
   (d_model 7168, 64 of its 256 experts top-8, moe_d_ff 2048, the shared
   expert), 8 and 32 experts a rank through ``layers.moe_local`` with the
   eager all-reduce, forward and backward: each rank's y, aux, d(x),
   d(router), its experts' and the shared expert's gradients against its
   slice of one rank's unsharded ``apply_moe``, in f32 within a stated
   tolerance and in bf16 within twice its floor; the per-rank time of
   the expert products and of the combine's all-reduce; MLA's attention
   at the train shape (16 x 256, 128 heads, hd 192 / hdv 128) with its
   heads over "model", each rank's 64 through the sharded
   ``flash_attention`` on ``fma`` against its slice of the unsharded
   call, and the three kernels' per-rank times beside their bounds and
   SDPA on the same 64 heads; (ii) ``make_train_step(rules, mesh)`` on a
   (1, 1) NCCL mesh at phase 16's dbrx cut and phase 17's deepseek-v3
   cut, 3 steps each from the same weights and batches: each step's
   launches by route as theirs, the losses and aux against theirs, step
   time, idle share and peak beside theirs. The kernels line gains the
   path ``train sharded moe`` and the two cuts' per-step launches.
23. Mamba2 and the hybrid on a ("data", "model") mesh: (i) two ``gloo``
   ranks on cuda:0 on a (1, 2) mesh: mamba2-370m's Mamba2 layer at full
   width (d_model 1024, 32 heads of 64 over a state of 128) and jamba's
   (d_model 8192, 256 heads), 16 and 128 heads a rank through
   ``layers.mamba_local`` with the eager all-reduces, on phase 18's 4 x
   1024 tokens, forward and backward: each rank's y, d(x) and every
   leaf's gradient against one rank's unsharded ``apply_mamba``, in f32
   within a stated tolerance or twice its floor (the distance of the f32
   layer from its float64 twin) and in bf16 within twice its floor; the
   widths its SSD saw (its own half of the heads), the SSD's per-rank
   time at half and at all the heads, and each collective's bytes and
   host-clock time; (ii) ``make_train_step(rules, mesh)`` on a (1, 1)
   NCCL mesh at phase 18's mamba2-370m and phase 19's jamba cut, 3 steps
   each from the same weights and batches: the losses and aux bitwise
   theirs, each step's launches by route as theirs, step time, idle share
   and peak beside theirs. The kernels line gains the path ``train
   sharded mamba`` and the two models' per-step launches.
24. The VLM and audio on a ("data", "model") mesh: (i) two ``gloo``
   ranks on cuda:0 on a (1, 2) mesh: llama-3.2-vision-11b's
   cross-attention at phase 20's shape (4 x 1024 text queries over 4 x
   4096 image keys, 32 heads over 8 of 128, non-causal) with its heads
   over "model", each rank's 16 query heads over 4 kv heads through the
   sharded ``flash_attention`` in f32 (``fma``, the route f32 images
   give it) and bf16 (``mma``), forward and backward, against its slice
   of the unsharded call (bitwise expected), and the three kernels at
   the rank's heads against their plain versions (phase 2's bounds),
   timed beside the unsharded call, the plain version, SDPA on the same
   heads and the bound (phase 22's MLA attention takes the same helper);
   musicgen-medium's four codebook heads
   (N 4096, D 1536, V 2048) with the vocabulary over "model" through the
   sharded ``xent_loss`` (rank 1's 1024 columns at col_offset 1024, its
   launches there counted), forward and backward against one rank's
   whole-vocabulary loss, the codebook embedding's lookup through
   ``model._embed`` and its gradient from each rank's shard, and the
   three xent kernels on a rank's shard against their plain versions,
   timed beside the bound and the library call; (ii)
   ``make_train_step(rules, mesh)`` on a (1, 1) NCCL mesh at phase 20's
   uncut VLM and phase 21's musicgen, 3 steps each from the same weights
   and batches: the losses and aux bitwise theirs, each step's launches
   by route as theirs, step time, idle share and peak beside theirs;
   then the host-clock time musicgen's lookups and heads add on the
   mesh, against the step's extra time. The
   kernels line gains the path ``train sharded vlm``, the per-rank shapes
   of the attention and ``col_offset`` rows and the two models' per-step
   launches.
25. Sharded serving of the GQA families: (i) two ``gloo`` ranks on
   cuda:0 on a (1, 2) mesh run ``dispatch.seq_split_decode`` (the
   sequence-split decode plan: each rank's half of the cache's T on
   ``mha_fwd``'s ``decode`` route at its local fill, the partial (out,
   lse) pairs combined over "model" by ``lse_combine``) at llama-130m's
   serving decode (batch 8, a cache of 576, 12 heads of 64) and the
   VLM's self-attention decode (batch 4, a cache of 544, 32 heads over 8
   of 128), in f32 and bf16, at three fills (inside rank 0's half, so
   rank 1 has no valid key; on the boundary; past it): against the
   unsharded ``decode`` call, f32 within a stated tolerance and bf16
   within twice its floor (the distance of the unsharded bf16 call from
   the f32 one) plus one bf16 rounding of the largest partial output
   (each rank's output is rounded to bf16 before the combine), the
   launches counted by route; each rank's kernel
   alone (CUDA events and device time) against its plain version,
   beside the bound and SDPA over its filled keys, and the combine's
   all-reduce on the host clock; (ii) serving on a (1, 1) NCCL mesh
   (``make_prefill_step``/``make_decode_step`` with ``rules`` and
   ``mesh``, the parameters ``place_params``' DTensors, the cache
   ``init_cache``'s sequence-sharded one) of phase 3's llama-130m, phase
   16's dbrx cut (cf E/k), phase 20's VLM with images and phase 21's
   musicgen, from the same weights and prompts, each beside the same
   serving without a mesh in this phase: tokens equal, every step's
   logits bitwise (one "model" rank: the combine is exp(0) out / 1),
   launches by route equal, and the tokens those phases chose; prefill
   ms, decode ms a step, busy and idle share of a decode step and the
   peak above the weights, each beside the unsharded run. The kernels
   line gains the path ``serve sharded`` and the per-rank decode shapes
   on the ``mha_fwd`` row.

The line before the last is a JSON ``{"kernels": [...]}`` summary, the
last line ``{"ok": true, "device": {...}}``. It needs a CUDA card and
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import atexit
import json
import math
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

# Kernel against plain version, per element (reasons in the comments):
# f32 out: both sides sum unit-scale products in f32 in other orders.
F32_OUT_ATOL = 2e-5
# bf16 out: the kernel rounds the running, unnormalized p to bf16, the plain
# version the normalized p; the output itself has 8 bits of mantissa.
BF16_OUT_ATOL, BF16_OUT_RTOL = 2e-2, 2e-2
# lse is f32 in both dtypes. f32 scores are f32 FMAs; bf16 scores (the
# tensor-core route) are exact bf16 products summed in f32 inside mma.sync,
# chained over at most 8 k-steps through its truncating f32 accumulator:
# some 1e-6 of a unit-scale score, and lse moves no more than its scores.
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# Last decode step's logits against the full-sequence forward (bf16,
# 12 layers): the two paths round each bf16 matmul output at different
# places (one row against 575), about 2^-8 relative each, compounding
# through 12 residual layers.
SERVE_ATOL, SERVE_RTOL = 5e-2, 5e-2
# Phase 16 (ii), dbrx's last bf16 decode logits against a full forward at
# cf = E/k: prefill and decode round each bf16 product at other places
# than one forward over all the tokens does (cuBLAS picks other kernels
# for other row counts); each rounding moves a value by up to 2**-8
# relative, the 6144-wide head sums such moves of the final hidden into
# every logit, and the largest error over 4 x 100352 logits lies several
# standard deviations out, past SERVE_ATOL/RTOL, which llama-130m's
# smaller logits set. The comparison's floors are measured in the same
# run: attention through its plain version (no kernel on the path), and
# dbrx's dense twin (the same widths with a dense SwiGLU of moe_d_ff: no
# MoE). The kernel route may reach this multiple of the lower floor; a
# fault in a kernel or in the MoE decode moves logits by O(1), many times
# the floors.
SERVE_BF16_FLOOR_X = 2.0

SRC_MHA = "src/repro_torch/kernels/attention/csrc/mha_fwd.cu"
TPU_MHA = "src/repro/kernels/attention/attention.py:223"
SRC_MHA_BWD = "src/repro_torch/kernels/attention/csrc/mha_bwd.cu"
SRC_COLNORM = "src/repro_torch/kernels/colnorm/csrc/colnorm.cu"
SRC_MOMENTUM = "src/repro_torch/kernels/scale_head/csrc/momentum_sumsq.cu"
SRC_XENT = "src/repro_torch/kernels/xent/csrc/xent.cu"
SRC_HOPPER = "src/repro_torch/kernels/xent/csrc/hopper_gemm.cuh"
TPU_KERNELS = {  # the Pallas kernel bodies each CUDA kernel replaces
    "norm_sumsq": "src/repro/kernels/colnorm/colnorm.py:113",
    "update_apply": "src/repro/kernels/colnorm/colnorm.py:219",
    "norm_apply": "src/repro/kernels/colnorm/colnorm.py:176",
    "momentum_sumsq": "src/repro/kernels/scale_head/scale_head.py:36",
    "xent_fwd": "src/repro/kernels/xent/xent.py:149",
    "xent_bwd_dh": "src/repro/kernels/xent/xent.py:218",
    "xent_bwd_dw": "src/repro/kernels/xent/xent.py:291",
    "mha_bwd_dq": "src/repro/kernels/attention/attention.py:321",
    "mha_bwd_dkv": "src/repro/kernels/attention/attention.py:401",
}
BWD_KERNELS = ("mha_bwd_dq", "mha_bwd_dkv")
XENT_KERNELS = ("xent_fwd", "xent_bwd_dh", "xent_bwd_dw")

# Optimizer kernels against their plain versions (phase 2), per element:
# sums of squares (f32): both sides sum positive f32 terms in other
# orders, the kernel in chains of at most 64 + 8 + S terms (S splits),
# torch in its own; the relative error of such a chain is at most
# (n - 1) * 2**-24, 1.5e-5 at n = 256.
SS_RTOL = 2e-5
# element-wise outputs, given the same ss: the same IEEE f32 operations in
# the same order on both sides (the kernels use _rn intrinsics, so nvcc
# contracts nothing into FMAs), one rounding to the output dtype: at most
# one ulp of the output dtype at the scale of the formula's terms.
EW_ULPS = 1
# Phase 6, impl="fused" against impl="jnp" after the six steps, per
# element of the bf16 params: each step rounds theta once on each route,
# and the routes round differently by design (the fused write rounds
# theta - lr*g/norm once from f32; the jnp route rounds the f32 update to
# bf16 and then the sum; its colnorm multiplies by a reciprocal, the kernel
# divides): at most 1.5 bf16 ulps of the element's peak magnitude (the
# largest |theta| or |step| of its trajectory) per step, so 8 in six steps.
STEP_ULPS = 8
# the f32 momentum: the kernel forms 1 - beta in f32 (as the TPU kernel),
# the jnp route in double (as JAX's jnp route), 2.4e-7 apart relative; six
# EMA steps of that plus rounding stay within 4e-6 of the leaf's max |m|.
MOMENTUM_RTOL = 4e-6
# Cross-entropy kernels against their plain versions (phase 2), with lse
# from the plain forward:
# lse and ll: f32 sums of D exact products in other orders (logits of
# order 1), and a log-sum-exp over V terms.
XENT_LSE_ATOL, XENT_LSE_RTOL = 1e-4, 1e-5
# dh and dw: f32 sums over the vocab (dh) or the tokens (dw) of recomputed
# logits, in other orders: 1e-5 of the largest |ref| plus 1e-4 relative;
# written as bf16, one rounding on each side adds 2**-8 relative, so 8e-3.
XENT_GRAD_SCALE_ATOL = 1e-5
XENT_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 8e-3}
# Phase 7: the mean loss against the plain route on the same hidden (f32
# means of 4096 per-token losses of order 10, summed in other orders).
LOSS_ATOL = 1e-4
# Phase 7: the eval loss against a forward whose attention is mha_fwd_ref.
# The two forwards differ by the bf16 roundings of each attention output
# (the kernel rounds the running p, the plain version the normalized p),
# carried through 24 residual layers; a relative change e of the final
# hidden moves a per-token loss by about e times the spread of the logits
# (about 1 at this init), and the mean of 4096 such moves of either sign
# by far less than e.
EVAL_REF_ATOL = 2e-3
# Attention backward kernels against their plain versions (phase 2), with
# lse and delta from the plain forward, per element: f32, sums of up to a
# few thousand terms (dK of qwen2's 7-head groups over 512 rows) in other
# orders; bf16, p and ds are rounded to bf16 at the same places on both
# sides but from f32 values that differ in their last bits, so a rare term
# lands one bf16 ulp apart, and each output is rounded once on each side.
BWD_SCALE_ATOL = {"float32": 1e-5, "bfloat16": 2e-3}
BWD_RTOL = {"float32": 1e-5, "bfloat16": 8e-3}
# Phase 8, one loss-and-grad of llama-1b against the same call with the
# attention through plain mha_fwd_ref autograd, per leaf:
# f32 at full width and 4 layers, per element against the leaf's largest
# |gradient|: the two attentions agree to f32 rounding (about 1e-6
# relative, phase 2), which the backward through 4 layers carries at that
# size; 1e-4 leaves a wide margin.
TRAIN_GRAD_F32 = 1e-4
# bf16 at full depth, the leaf's relative error in norm: the forwards round
# each attention output differently (the kernel rounds the running p, the
# plain version the normalized p), about 2**-8 relative where they differ,
# compounding through 24 layers forward and back, and at random init the
# attention gradients are sums that cancel toward zero (ROADMAP reference
# caveat 1), where a few roundings are a large share.
TRAIN_GRAD_BF16 = 5e-2
# Phase 8, the loss curve of 8 steps against the plain-attention route's:
# each step's update differs by the gradients' bf16 difference above (a few
# % of a column-normalized step), which moves the next loss by a few % of
# that step's loss change (about 0.05 here), accumulating over 8 steps.
LOSS_CURVE_ATOL = 2e-2
TRAIN_STEPS = 8


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list:
    """One line per kernel of nvcc's -Xptxas -v log: registers and spills."""
    names, out, name, spill = [], [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            names.append(name)
            out.append(f"{line.split(':', 1)[1].strip()}; {spill}")
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    names = [n.replace("(anonymous namespace)::", "").split("(")[0]
             .removeprefix("void ") for n in names]
    return [f"{n}: {o}" for n, o in zip(names, out)]


def attention_cases():
    # name -> (B, S, T, H, K, hd, causal, kv_len)
    return {
        "prefill llama-130m": (8, 512, 512, 12, 12, 64, True, None),
        "decode kv_len=0": (8, 1, 576, 12, 12, 64, False, 0),
        "decode kv_len=1": (8, 1, 576, 12, 12, 64, False, 1),
        "decode kv_len=300": (8, 1, 576, 12, 12, 64, False, 300),
        "decode kv_len=576": (8, 1, 576, 12, 12, 64, False, 576),
        "rect causal S=64 T=576": (8, 64, 576, 12, 12, 64, True, None),
        "gqa qwen2-500m H=14 K=2": (8, 512, 512, 14, 2, 64, True, None),
        "ragged S=T=37": (8, 37, 37, 12, 12, 64, True, None),
        "hd=128": (4, 512, 512, 8, 8, 128, True, None),
        "hd=256": (2, 512, 512, 8, 1, 256, True, None),
        "eval llama-1b": (16, 256, 256, 32, 32, 64, True, None),
        # the edges of the tensor-core (mma) route
        "S=5 past decode": (8, 5, 5, 12, 12, 64, True, None),
        "ragged S=T=200": (8, 200, 200, 12, 12, 64, True, None),
        "rect causal S=64 T=576 hd=128": (8, 64, 576, 12, 12, 128, True,
                                          None),
        "gqa H=14 K=2 S=T=100 hd=128": (4, 100, 100, 14, 2, 128, True, None),
        "kv_len=300 S=16": (8, 16, 576, 12, 12, 64, False, 300),
        "kv_len=0 S=16": (8, 16, 576, 12, 12, 64, False, 0),
        "non-causal S=100 T=300": (8, 100, 300, 12, 12, 64, False, None),
        # phase 9's training shapes: llama-7b (mma, hd 128) and gemma-2b
        # (fma, 8 heads of 256 over 1 kv head)
        "train llama-7b hd=128": (16, 256, 256, 32, 32, 128, True, None),
        "train gemma-2b H=8 K=1 hd=256": (16, 256, 256, 8, 1, 256, True, None),
        # phase 16's GQA layouts at hd 128: dbrx-132b (48 heads over 8) and
        # mistral-large-123b (96 over 8)
        "train dbrx-132b H=48 K=8 hd=128": (16, 256, 256, 48, 8, 128, True,
                                            None),
        "train mistral-large H=96 K=8 hd=128": (16, 256, 256, 96, 8, 128,
                                                True, None),
        # and of qwen2-7b (28 over 4) and deepseek-67b (64 over 8)
        "train qwen2-7b H=28 K=4 hd=128": (16, 256, 256, 28, 4, 128, True,
                                           None),
        "train deepseek-67b H=64 K=8 hd=128": (16, 256, 256, 64, 8, 128,
                                               True, None),
        # phase 16's decode steps (batch 4, a cache of 256 + 32): the
        # first and the last step's kv_len, dbrx-132b's heads and 96 over 8
        "decode dbrx-132b H=48 K=8 kv_len=256": (4, 1, 288, 48, 8, 128,
                                                 False, 256),
        "decode dbrx-132b H=48 K=8 kv_len=287": (4, 1, 288, 48, 8, 128,
                                                 False, 287),
        "decode H=96 K=8 hd=128 kv_len=256": (4, 1, 288, 96, 8, 128, False,
                                              256),
        "decode H=96 K=8 hd=128 kv_len=287": (4, 1, 288, 96, 8, 128, False,
                                              287),
        # phase 19's: jamba-1.5-large-398b (64 heads over 8 of 128) at its
        # train batch of 4 x 1024, its serving prefill of 4 x 512 and the
        # first and last decode step's kv_len (a cache of 512 + 32)
        JAMBA_ATTN: (4, 1024, 1024, 64, 8, 128, True, None),
        "prefill jamba H=64 K=8 hd=128": (4, 512, 512, 64, 8, 128, True,
                                          None),
        "decode jamba H=64 K=8 kv_len=512": (4, 1, 544, 64, 8, 128, False,
                                             512),
        "decode jamba H=64 K=8 kv_len=543": (4, 1, 544, 64, 8, 128, False,
                                             543),
        # phase 20's: llama-3.2-vision-11b's cross-attention, 4 x 1024 text
        # queries over 4096 image keys (non-causal, 32 heads over 8 of
        # 128; f32 with the data pipeline's f32 images), a decode step's
        # one query over them (no kv_len), and its causal self-attention;
        # its serving: the prefill's cross- and self-attention at 4 x 512
        # and the self-attention's first and last decode step (a cache of
        # 512 + 32)
        VLM_CROSS: (4, 1024, 4096, 32, 8, 128, False, None),
        VLM_CROSS_DECODE: (4, 1, 4096, 32, 8, 128, False, None),
        VLM_ATTN: (4, 1024, 1024, 32, 8, 128, True, None),
        "prefill cross vlm S=512 T=4096": (4, 512, 4096, 32, 8, 128, False,
                                           None),
        "prefill vlm H=32 K=8 hd=128": (4, 512, 512, 32, 8, 128, True, None),
        "decode vlm H=32 K=8 kv_len=512": (4, 1, 544, 32, 8, 128, False, 512),
        "decode vlm H=32 K=8 kv_len=543": (4, 1, 544, 32, 8, 128, False, 543),
        # phase 21's: musicgen-medium's (24 heads of 64, causal) at its
        # train batch, its serving prefill and first and last decode step
        MUSICGEN_ATTN: (4, 1024, 1024, 24, 24, 64, True, None),
        "prefill musicgen H=K=24 hd=64": (4, 512, 512, 24, 24, 64, True,
                                          None),
        "decode musicgen H=K=24 kv_len=512": (4, 1, 544, 24, 24, 64, False,
                                              512),
        "decode musicgen H=K=24 kv_len=543": (4, 1, 544, 24, 24, 64, False,
                                              543),
    }


# the wrappers that count launches by route
ROUTED = ("mha_fwd", *BWD_KERNELS, *XENT_KERNELS, "update_apply")


def _routed():
    from repro_torch.kernels.attention import attention as A
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.xent import xent as X
    return {k: getattr(C if k == "update_apply" else X if k.startswith("xent")
                       else A, k) for k in ROUTED}


def route_counts():
    """{routed wrapper: its launches by route}."""
    return {k: dict(f.route_launches) for k, f in _routed().items()}


def zero_route_counts():
    for f in _routed().values():
        for r in f.route_launches:
            f.route_launches[r] = 0


def check_routes(got, want, what, show=True):
    """``got`` (as route_counts gives it) against ``want``, {wrapper:
    {route: launches}}; a route left out of ``want`` is expected at 0."""
    want = {k: {r: want.get(k, {}).get(r, 0) for r in c}
            for k, c in got.items()}
    if show:
        print(f"  {what}: launches by route {got} (expect {want})")
    if got != want:
        raise AssertionError(f"{what}: routes {got}, not {want}")


def make_qkv(torch, gen, B, S, T, H, K, hd, dtype, hdv=None):
    """q (B, S, H, hd), k (B, T, K, hd), v (B, T, K, hdv: default hd)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, S, H, hd), rnd(B, T, K, hd), rnd(B, T, K, hdv or hd)


def phase_kernels(torch, gen):
    """Phase 2: mha_fwd against mha_fwd_ref on the card, each case on the
    route ``_fwd_route`` picks; at the eval shape in bf16 also the fma
    kernel that took it before the tensor-core route (phase 4 times it).
    -> max errors."""
    from repro_torch.kernels.attention.attention import (_fwd_route,
                                                         _launch_fwd, mha_fwd)
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    errs = {}
    cases = [(name, shape, dtype, None) for name, shape in
             attention_cases().items()
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append(("eval llama-1b", attention_cases()["eval llama-1b"],
                  torch.bfloat16, "fma"))
    for name, (B, S, T, H, K, hd, causal, kl), dtype, forced in cases:
        q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, dtype)
        kv_len = None if kl is None else torch.tensor(
            kl, dtype=torch.int32, device="cuda")
        route = forced or _fwd_route(q, k, v)
        before = route_counts()
        if forced:
            out, lse = _launch_fwd(forced, q, k, v, kv_len,
                                   hd ** -0.5, causal)
        else:
            out, lse = mha_fwd(q, k, v, kv_len, scale=hd ** -0.5,
                               causal=causal)
        torch.cuda.synchronize()
        after = route_counts()
        fwd = before["mha_fwd"]
        if not forced and after != {**before, "mha_fwd": {
                **fwd, route: fwd[route] + 1}}:
            raise AssertionError(f"mha_fwd {name}: routes {before} -> "
                                 f"{after}, expected one {route}")
        if route == "mma":  # bitwise on a second run
            again = mha_fwd(q, k, v, kv_len, scale=hd ** -0.5, causal=causal)
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                raise AssertionError(f"mha_fwd {name}: a second run differs")
        ref, ref_lse = mha_fwd_ref(q, k, v, kv_len, scale=hd ** -0.5,
                                   causal=causal)
        if dtype == torch.float32:
            atol, rtol = F32_OUT_ATOL, 0.0
        else:
            atol, rtol = BF16_OUT_ATOL, BF16_OUT_RTOL
        d = (out.float() - ref.float()).abs()
        out_ok = bool((d <= atol + rtol * ref.float().abs()).all())
        rows = ref_lse > -1e29  # rows with at least one valid key
        dl = (lse - ref_lse).abs()[rows]
        lse_ok = bool((dl <= LSE_ATOL + LSE_RTOL
                       * ref_lse[rows].abs()).all())
        finite = bool(torch.isfinite(out.float()).all())
        zero_ok = kl != 0 or bool((out == 0).all())
        e_out = d.max().item()
        e_lse = dl.max().item() if dl.numel() else 0.0
        tag = str(dtype).replace("torch.", "")
        print(f"  {name:29s} {tag:8s} {route:6s} out err {e_out:.3e} "
              f"(tol {atol:g} + {rtol:g}|ref|)  lse err {e_lse:.3e} "
              f"(tol {LSE_ATOL:g} + {LSE_RTOL:g}|ref|)")
        if not (out_ok and lse_ok and finite and zero_ok):
            raise AssertionError(f"mha_fwd disagrees with the plain "
                                 f"version: {name} {tag} {route}")
        errs[(name, tag) if not forced else (name, tag, forced)] = e_out
    return errs


def bwd_cases():
    # name -> (B, S, T, H, K, hd, causal, kv_len)
    return {
        "train llama-1b": (16, 256, 256, 32, 32, 64, True, None),
        "gqa qwen2-500m H=14 K=2": (8, 512, 512, 14, 2, 64, True, None),
        "hd=128": (4, 512, 512, 8, 8, 128, True, None),
        "ragged S=T=200": (8, 200, 200, 12, 12, 64, True, None),
        "rect causal S=64 T=576": (8, 64, 576, 12, 12, 64, True, None),
        "kv_len=300 K=4": (8, 16, 576, 12, 4, 64, False, 300),
        "kv_len=0": (8, 16, 576, 12, 12, 64, False, 0),
        # the edges of the tensor-core (mma) route: dK, dV chained over
        # 4 x 1024 query rows, and the hd 128 layout on a ragged tile
        "long gqa S=T=1024 H=8 K=2": (1, 1024, 1024, 8, 2, 64, True, None),
        "hd=128 ragged S=T=200": (2, 200, 200, 4, 4, 128, True, None),
        # a bf16 head the mma route does not take: the fma kernels in bf16
        "hd=32 gqa ragged S=T=200": (4, 200, 200, 8, 4, 32, True, None),
        # gemma-2b's head, 8 query heads over 1 kv head of 256, on the fma
        # kernels: its training shape, the kv_len bound and S != T
        "train llama-7b hd=128": (16, 256, 256, 32, 32, 128, True, None),
        "train gemma-2b H=8 K=1 hd=256": (16, 256, 256, 8, 1, 256, True, None),
        "hd=256 kv_len=300 H=8 K=1": (2, 16, 576, 8, 1, 256, False, 300),
        "hd=256 rect causal S=64 T=576": (2, 64, 576, 8, 1, 256, True, None),
        # phase 16's GQA layouts at hd 128 (dbrx-132b, mistral-large-123b,
        # qwen2-7b, deepseek-67b)
        "train dbrx-132b H=48 K=8 hd=128": (16, 256, 256, 48, 8, 128, True,
                                            None),
        "train mistral-large H=96 K=8 hd=128": (16, 256, 256, 96, 8, 128,
                                                True, None),
        "train qwen2-7b H=28 K=4 hd=128": (16, 256, 256, 28, 4, 128, True,
                                           None),
        "train deepseek-67b H=64 K=8 hd=128": (16, 256, 256, 64, 8, 128,
                                               True, None),
        # phase 19's: jamba-1.5-large-398b at its train batch of 4 x 1024
        JAMBA_ATTN: (4, 1024, 1024, 64, 8, 128, True, None),
        # phase 20's cross-attention (non-causal, 1024 queries over 4096
        # image keys) and self-attention; phase 21's
        VLM_CROSS: (4, 1024, 4096, 32, 8, 128, False, None),
        VLM_ATTN: (4, 1024, 1024, 32, 8, 128, True, None),
        MUSICGEN_ATTN: (4, 1024, 1024, 24, 24, 64, True, None),
    }


def bwd_fma(torch, name, args, kw):
    """The fma kernel of backward kernel ``name`` on ``bwd_inputs``'s
    ``args``, whatever route the wrapper would take: phase 2 checks it, and
    phase 4 times it, at shapes the mma route takes. Counts nothing."""
    from repro_torch.kernels.attention.attention import _launch_bwd
    q, k, v = args[:3]
    outs = ((torch.empty_like(q),) if name == "mha_bwd_dq"
            else (torch.empty_like(k), torch.empty_like(v)))
    _launch_bwd(name, "fma", outs, *args, kw["scale"], kw["causal"],
                kw.get("segments"))
    return outs[0] if name == "mha_bwd_dq" else outs


def bwd_inputs(torch, gen, B, S, T, H, K, hd, causal, kl, dtype):
    """(q, k, v, dout, lse, delta, kv_len) with lse and delta from the plain
    forward, so both sides get the same statistics."""
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    kv_len = None if kl is None else torch.tensor(kl, dtype=torch.int32,
                                                  device="cuda")
    out, lse = mha_fwd_ref(q, k, v, kv_len, scale=hd ** -0.5, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, kv_len


def _bwd_check(torch, name, got, want, tag, key):
    """-> (max abs error, the largest error over its element's tolerance,
    that element's error in ulps of the output dtype at its |ref|: 1 is
    one rounding of the output landing apart, more is drift)."""
    scale = want.float().abs().max().item()
    d = (got.float() - want.float()).abs()
    tol = BWD_SCALE_ATOL[tag] * scale + BWD_RTOL[tag] * want.float().abs()
    if not (bool(torch.isfinite(got.float()).all()) and bool((d <= tol).all())
            and got.dtype == want.dtype and got.shape == want.shape):
        raise AssertionError(f"{name} disagrees with the plain version: {key}, "
                             f"max err {d.max().item():.3e}")
    ratio = (d / tol.clamp_min(1e-30)).flatten()
    i = int(ratio.argmax())
    w = want.flatten()[i:i + 1]
    return (d.max().item(), ratio[i].item(),
            (d.flatten()[i] / ulp(torch, w, want.dtype)[0]).item())


def phase_bwd_kernels(torch, gen):
    """Phase 2: mha_bwd_dq and mha_bwd_dkv against their plain versions on
    the card, each case on the route ``_bwd_route`` picks (counted), each
    run twice (bitwise equal); at the training shape in bf16 also the fma
    kernels that took it before the tensor-core route (phase 4 times
    them). Prints each case's largest error over its element's tolerance,
    which shows the tensor cores' chained sums drifting. -> {(kernel,
    case, dtype[, forced route]): max abs error}."""
    from repro_torch.kernels.attention.attention import (_bwd_route,
                                                         mha_bwd_dkv,
                                                         mha_bwd_dq)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref)
    errs = {}
    cases = [(name, shape, dtype, None) for name, shape in bwd_cases().items()
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append(("train llama-1b", bwd_cases()["train llama-1b"],
                  torch.bfloat16, "fma"))
    for name, (B, S, T, H, K, hd, causal, kl), dtype, forced in cases:
        tag = str(dtype).replace("torch.", "")
        key = f"{name} {tag}"
        args = bwd_inputs(torch, gen, B, S, T, H, K, hd, causal, kl, dtype)
        kw = dict(scale=hd ** -0.5, causal=causal)
        route = forced or _bwd_route(*args[:3])

        def run():
            if forced:
                return (bwd_fma(torch, "mha_bwd_dq", args, kw),
                        *bwd_fma(torch, "mha_bwd_dkv", args, kw))
            return mha_bwd_dq(*args, **kw), *mha_bwd_dkv(*args, **kw)
        before = route_counts()
        dq, dk, dv = run()
        torch.cuda.synchronize()
        after = route_counts()
        if not forced and after != {
                k: {**c, route: c[route] + 1} if k in BWD_KERNELS else c
                for k, c in before.items()}:
            raise AssertionError(f"attention backward {key}: routes {before} "
                                 f"-> {after}, expected one {route} each")
        e_q, r_q, u_q = _bwd_check(torch, "mha_bwd_dq", dq,
                                   mha_bwd_dq_ref(*args, **kw), tag, key)
        want_k, want_v = mha_bwd_dkv_ref(*args, **kw)
        e_k, r_k, u_k = _bwd_check(torch, "mha_bwd_dkv dK", dk, want_k, tag,
                                   key)
        e_v, r_v, u_v = _bwd_check(torch, "mha_bwd_dkv dV", dv, want_v, tag,
                                   key)
        del want_k, want_v
        again = run()
        _bitwise_again(torch, "mha_bwd_dq", dq, again[0], key)
        _bitwise_again(torch, "mha_bwd_dkv", torch.cat(
            [dk.flatten(), dv.flatten()]), torch.cat(
            [again[1].flatten(), again[2].flatten()]), key)
        if kl == 0 and not all(bool((g == 0).all()) for g in (dq, dk, dv)):
            raise AssertionError(f"kv_len=0 gradients are not 0: {key}")
        ek = (name, tag) if not forced else (name, tag, forced)
        errs[("mha_bwd_dq", *ek)] = e_q
        errs[("mha_bwd_dkv", *ek)] = max(e_k, e_v)
        torch.cuda.synchronize()
        mx = [x.float().abs().max().item() for x in (dq, dk, dv)]
        print(f"  {key:35s} {route:3s} dQ err {e_q:.3e}, dK {e_k:.3e}, dV "
              f"{e_v:.3e} (max |dQ|, |dK|, |dV| {mx[0]:.3g}, {mx[1]:.3g}, "
              f"{mx[2]:.3g}; tol {BWD_SCALE_ATOL[tag]:g}max|ref| + "
              f"{BWD_RTOL[tag]:g}|ref|; err/tol at most dQ {r_q:.3f}, dK "
              f"{r_k:.3f}, dV {r_v:.3f}, there {u_q:.3g}, {u_k:.3g}, "
              f"{u_v:.3g} ulps); bitwise repeatable")
        del args, dq, dk, dv, again
    return errs


def ulp(torch, x, dtype):
    """Spacing of ``dtype``'s numbers at |x| (f32 tensor)."""
    mant = 7 if dtype == torch.bfloat16 else 23
    x = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(x)) - mant)


# leaves of more elements are held in bf16 alone, the dtype the train
# paths give them: their f32 copies and checks side by side take 40 GB
# and more
OPT_F32_MAX = 2**29


def optimizer_shapes():
    # name -> canonical (L, m, n): ragged, odd rows, llama-1b's leaves, the
    # largest leaves of phase 9's models (llama-7b's stacked MLP leaf,
    # gemma-2b's head), and deepseek-v3's (phase 17: its head, embedding,
    # dense MLP, the MLA projections of the dense segment, the MoE
    # segment's router and its one-layer leaves)
    return {
        "ragged (3,77,129)": (3, 77, 129),
        "(1,5461,2048)": (1, 5461, 2048),
        "w_gate/w_up (24,2048,5461)": (24, 2048, 5461),
        "w_down (24,5461,2048)": (24, 5461, 2048),
        "tok_embed (1,32000,2048)": (1, 32000, 2048),
        "lm_head (1,2048,32000)": (1, 2048, 32000),
        "llama-7b w_gate/w_up (32,4096,11008)": (32, 4096, 11008),
        "gemma-2b lm_head (1,2048,256000)": (1, 2048, 256000),
        # the tied heads (phase 12) are the embeddings' shapes: llama-1b's
        # is tok_embed's above, gemma-2b's this one (row kind)
        "gemma-2b tied tok_embed (1,256000,2048)": (1, 256000, 2048),
        "deepseek-v3 lm_head (1,7168,129280)": (1, 7168, 129280),
        "deepseek-v3 tok_embed (1,129280,7168)": (1, 129280, 7168),
        "deepseek-v3 w_gate/w_up (3,7168,18432)": (3, 7168, 18432),
        "deepseek-v3 wo (3,16384,7168)": (3, 16384, 7168),
        "deepseek-v3 wq_b (3,1536,24576)": (3, 1536, 24576),
        "deepseek-v3 wkv_b (3,512,32768)": (3, 512, 32768),
        "deepseek-v3 wkv_a (3,7168,576)": (3, 7168, 576),
        "deepseek-v3 MoE wq_a (1,7168,1536)": (1, 7168, 1536),
        "deepseek-v3 router (1,7168,64)": (1, 7168, 64),
        # mamba2-370m's (phase 18): its two stacked projections, embedding
        # and head (the padded vocabulary of 50304)
        "mamba2-370m in_proj (48,1024,4384)": (48, 1024, 4384),
        "mamba2-370m out_proj (48,2048,1024)": (48, 2048, 1024),
        "mamba2-370m tok_embed (1,50304,1024)": (1, 50304, 1024),
        "mamba2-370m lm_head (1,1024,50304)": (1, 1024, 50304),
        # jamba-1.5-large-398b's training cut (phase 19): Mamba2's in_proj
        # and out_proj, the MoE router of 4 experts and the head
        "jamba in_proj (1,8192,33280)": (1, 8192, 33280),
        "jamba out_proj (1,16384,8192)": (1, 16384, 8192),
        "jamba router (1,8192,4)": (1, 8192, 4),
        "jamba lm_head (1,8192,65536)": (1, 8192, 65536),
        # llama-3.2-vision-11b's (phase 20): its head and embedding, and
        # the leaves stacked over its 8 super-blocks: the MLPs', the wq/wo
        # and wk/wv of the self- and the cross-attention (one shape each)
        "llama-3.2-vision lm_head (1,4096,128256)": (1, 4096, 128256),
        "llama-3.2-vision tok_embed (1,128256,4096)": (1, 128256, 4096),
        "llama-3.2-vision w_gate/w_up (8,4096,14336)": (8, 4096, 14336),
        "llama-3.2-vision w_down (8,14336,4096)": (8, 14336, 4096),
        "llama-3.2-vision wq/wo (8,4096,4096)": (8, 4096, 4096),
        "llama-3.2-vision wk/wv (8,4096,1024)": (8, 4096, 1024),
        # musicgen-medium's (phase 21): the 4 codebook heads, one 3-D leaf
        # in SCALE's momentum group, and the 4 codebook embeddings
        "musicgen lm_head (4,1536,2048)": (4, 1536, 2048),
        "musicgen tok_embed (4,2048,1536)": (4, 2048, 1536),
    }


def _check_ew(torch, name, got, want, scale, dtype, errs, key):
    """got against want within EW_ULPS ulps of dtype at ``scale``."""
    d = (got.float() - want.float()).abs()
    tol = EW_ULPS * ulp(torch, scale, dtype)
    worst = (d / tol).max().item()
    if not (bool(torch.isfinite(got.float()).all()) and worst <= 1.0):
        raise AssertionError(f"{name} disagrees with the plain version: "
                             f"{key}, max err {d.max().item():.3e}, "
                             f"{worst:.2f} x tol")
    errs[key] = max(errs.get(key, 0.0), d.max().item())
    return d.max().item()


def _check_ss(torch, name, got, want, errs, key):
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    if not (bool(torch.isfinite(got).all()) and rel <= SS_RTOL):
        raise AssertionError(f"{name}: sums of squares off by {rel:.3e} "
                             f"relative (tol {SS_RTOL:g}): {key}")
    errs[key] = max(errs.get(key, 0.0), (got - want).abs().max().item())
    return rel


def _bitwise_again(torch, name, first, again, key):
    if not torch.equal(first, again):
        raise AssertionError(f"{name}: a second run on the same inputs "
                             f"differs: {key}")


def phase_optimizer_kernels(torch, gen):
    """Phase 2: the four optimizer kernels against their plain versions.

    -> {(kernel, shape name, dtype): max abs error}.
    """
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head import ref as HR
    from repro_torch.kernels.scale_head import scale_head as H
    errs = {}
    lr = torch.tensor(0.01, device="cuda")
    for sname, shape in optimizer_shapes().items():
        big = shape[0] * shape[1] * shape[2] > OPT_F32_MAX
        for dtype in (torch.bfloat16, torch.float32)[:1 if big else 2]:
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            theta = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            m32 = 0.1 * torch.randn(shape, generator=gen, device="cuda")
            tag = str(dtype).replace("torch.", "")
            for axis in ("col", "row"):
                for gs in (None, 0.37):
                    # gscale and beta by value (Python) and by device pointer
                    gscale = None if gs is None else torch.tensor(
                        gs, device="cuda")
                    beta = 0.9 if gs is None else torch.tensor(
                        0.9, device="cuda")
                    key = f"{sname} {tag} {axis} gscale={gs}"
                    # norm_sumsq
                    ss = C.norm_sumsq(g, axis, gscale=gscale)
                    ss_p = CR.norm_sumsq_ref(g, axis, gscale=gscale)
                    r_ss = _check_ss(torch, "norm_sumsq", ss, ss_p, errs,
                                     ("norm_sumsq", sname, tag))
                    _bitwise_again(torch, "norm_sumsq", ss,
                                   C.norm_sumsq(g, axis, gscale=gscale), key)
                    # norm_apply, in g's dtype and in f32 (the update path)
                    e_na = 0.0
                    for out_dtype in {dtype, torch.float32}:
                        out = C.norm_apply(g, ss_p, axis, gscale=gscale,
                                           out_dtype=out_dtype)
                        want = CR.norm_apply_ref(g, ss_p, axis, gscale=gscale,
                                                 out_dtype=out_dtype)
                        e_na = max(e_na, _check_ew(
                            torch, "norm_apply", out, want, want, out_dtype,
                            errs, ("norm_apply", sname, tag)))
                        _bitwise_again(torch, "norm_apply", out, C.norm_apply(
                            g, ss_p, axis, gscale=gscale,
                            out_dtype=out_dtype), key)
                    # update_apply, in place
                    th = theta.clone()
                    got = C.update_apply(th, g, ss_p, lr, axis,
                                         gscale=gscale)
                    if got is not th or got.data_ptr() != th.data_ptr():
                        raise AssertionError(f"update_apply not in place: "
                                             f"{key}")
                    want = CR.update_apply_ref(theta.clone(), g, ss_p, lr,
                                               axis, gscale=gscale)
                    e_ua = _check_ew(torch, "update_apply", got, want,
                                     torch.maximum(theta.float().abs(),
                                                   want.float().abs()),
                                     dtype, errs, ("update_apply", sname, tag))
                    th2 = theta.clone()
                    C.update_apply(th2, g, ss_p, lr, axis, gscale=gscale)
                    _bitwise_again(torch, "update_apply", got, th2, key)
                    # momentum_sumsq, in place, f32 and bf16 storage
                    e_m = r_m = 0.0
                    for mdt in (torch.float32, torch.bfloat16):
                        m0 = m32.to(mdt)
                        m = m0.clone()
                        got_m, got_ss = H.momentum_sumsq(m, g, beta, axis,
                                                         gscale=gscale)
                        if got_m is not m or got_m.data_ptr() != m.data_ptr():
                            raise AssertionError(f"momentum_sumsq not in "
                                                 f"place: {key}")
                        want_m, want_ss = HR.momentum_sumsq_ref(
                            m0.clone(), g, beta, axis, gscale=gscale)
                        terms = (0.9 * m0.float().abs()
                                 + 0.1 * (gs or 1.0) * g.float().abs())
                        mk = ("momentum_sumsq", sname,
                              f"{tag} m {str(mdt).replace('torch.', '')}")
                        e_m = max(e_m, _check_ew(torch, "momentum_sumsq",
                                                 got_m, want_m, terms, mdt,
                                                 errs, mk))
                        r_m = max(r_m, _check_ss(torch, "momentum_sumsq",
                                                 got_ss, want_ss, errs, mk))
                        m2 = m0.clone()
                        _, ss2 = H.momentum_sumsq(m2, g, beta, axis,
                                                  gscale=gscale)
                        _bitwise_again(torch, "momentum_sumsq", got_m, m2,
                                       key)
                        _bitwise_again(torch, "momentum_sumsq", got_ss, ss2,
                                       key)
                    torch.cuda.synchronize()
                    print(f"  {key:52s} sumsq rel {r_ss:.2e}; norm_apply "
                          f"{e_na:.2e}; update_apply {e_ua:.2e}; momentum "
                          f"{e_m:.2e} (ss rel {r_m:.2e}); in place, "
                          f"bitwise repeatable")
            del g, theta, m32
    return errs


# update_apply's routes (phase 2): (theta dtype, g dtype) and shapes
UPDATE_PAIRS = {"bfloat16 g bfloat16": ("bfloat16", "bfloat16"),
                "bfloat16 g float32": ("bfloat16", "float32"),
                "float32 g float32": ("float32", "float32")}
UPDATE_SHAPES = {"ragged (3,77,129)": (3, 77, 129),
                 "w_gate/w_up (24,2048,5461)": (24, 2048, 5461),
                 "lm_head (1,2048,32000)": (1, 2048, 32000)}


def _on_route(fn, route, call):
    """call() -> its result, checking that it made exactly one launch of
    ``fn`` and that on ``route``."""
    was = dict(fn.route_launches)
    out = call()
    if fn.route_launches != {**was, route: was[route] + 1}:
        raise AssertionError(f"routes {was} -> {fn.route_launches}, expected "
                             f"one {route}")
    return out


def phase_update_routes(torch, gen):
    """Phase 2: update_apply's vec route against its strided route on the
    same values: contiguous at a common offset of 0-7 elements into their
    buffers (vec), and laid out transposed in memory and viewed back
    (strided), bitwise equal; the strided result within EW_ULPS of the
    plain version; vec in place and bitwise repeatable; operands at
    mismatched offsets on strided. -> {(kernel, shape, dtypes): max abs
    error against the plain version}."""
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    fn, errs = C.update_apply, {}
    for sname, (L, m, n) in UPDATE_SHAPES.items():
        def transposed(x):
            t = torch.empty((L, n, m), dtype=x.dtype, device="cuda")
            return t.transpose(1, 2).copy_(x)

        def at(x, off):
            buf = torch.empty(x.numel() + off, dtype=x.dtype, device="cuda")
            return buf[off:].view(x.shape).copy_(x)

        for pname, (tdn, gdn) in UPDATE_PAIRS.items():
            td, gd = getattr(torch, tdn), getattr(torch, gdn)
            theta = torch.randn((L, m, n), generator=gen, device="cuda").to(td)
            g = torch.randn((L, m, n), generator=gen, device="cuda").to(gd)
            key = ("update_apply", sname, pname)
            for axis in ("col", "row"):
                ss = CR.norm_sumsq_ref(g, axis)
                err = 0.0
                for by in ("value", "pointer"):
                    lr, gscale = (0.01, 0.37) if by == "value" else (
                        torch.tensor(0.01, device="cuda"),
                        torch.tensor(0.37, device="cuda"))
                    tag = f"{sname} {pname} {axis}, lr and gscale by {by}"
                    want = CR.update_apply_ref(theta.clone(), g, ss, lr, axis,
                                               gscale=gscale)
                    strided, gt = transposed(theta), transposed(g)
                    _on_route(fn, "strided", lambda: C.update_apply(
                        strided, gt, ss, lr, axis, gscale=gscale))
                    del gt
                    err = max(err, _check_ew(
                        torch, "update_apply", strided, want,
                        torch.maximum(theta.float().abs(), want.float().abs()),
                        td, errs, key))
                    del want
                    for off in range(8):
                        th, gv = at(theta, off), at(g, off)
                        got = _on_route(fn, "vec", lambda: C.update_apply(
                            th, gv, ss, lr, axis, gscale=gscale))
                        if got is not th or not torch.equal(th, strided):
                            raise AssertionError(
                                f"update_apply vec at offset {off} differs "
                                f"from strided or is not in place: {tag}")
                        if off == 0:  # bitwise repeatable
                            th = at(theta, 0)
                            C.update_apply(th, gv, ss, lr, axis, gscale=gscale)
                            if not torch.equal(th, strided):
                                raise AssertionError(f"update_apply vec: a "
                                                     f"second run differs: {tag}")
                    # theta and g at offsets whose 16-byte boundaries differ
                    th, gv = at(theta, 1), at(g, 2)
                    _on_route(fn, "strided", lambda: C.update_apply(
                        th, gv, ss, lr, axis, gscale=gscale))
                    if not torch.equal(th, strided):
                        raise AssertionError(f"update_apply at mismatched "
                                             f"offsets differs: {tag}")
                    del th, gv, strided
                torch.cuda.synchronize()
                print(f"  update_apply {sname:27s} {pname:19s} {axis}: vec at "
                      f"offsets 0-7 bitwise equal to strided (transposed "
                      f"layout) and repeatable, lr and gscale by value and by "
                      f"pointer; mismatched offsets strided; max err "
                      f"{err:.2e} against the plain version (tol {EW_ULPS} "
                      f"ulp)")
            del theta, g
    return errs


def phase_serving(torch, seed, power):
    """Phase 3: greedy serving of llama-130m through the port's entry points."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.models import (forward, init_params, logits_from_hidden)
    from repro_torch.training import (greedy_generate, make_decode_step,
                                      make_prefill_step)
    cfg = get_arch("llama-130m")
    B, P, N = 8, 512, 64
    max_seq = P + N
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda", dtype=torch.int32)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, {cfg.num_params() / 1e6:.1f}M "
          f"params; batch {B}, prompt {P}, {N} new tokens")
    greedy_generate(cfg, params, prompt, 2, max_seq)  # warm-up, not counted
    torch.cuda.synchronize()

    # the main path: counts set to 0 just before it, read just after
    torch.cuda.reset_peak_memory_stats()
    mha_fwd.launches = 0
    zero_route_counts()
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, prompt, N, max_seq)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = mha_fwd.launches
    routes = route_counts()
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * (1 + (N - 1))
    print(f"  greedy_generate: mha_fwd launches {launches} (expect "
          f"{cfg.n_layers} x (1 + {N - 1}) = {want})")
    if launches != want:
        raise AssertionError(f"mha_fwd launched {launches} times, not {want}")
    # the prompt's prefill on the tensor cores, every decode step on decode
    check_routes(routes, {"mha_fwd": {"mma": cfg.n_layers,
                                      "decode": cfg.n_layers * (N - 1)}},
                 "greedy_generate")
    if out.shape != (B, N) or not bool(((out >= 0)
                                        & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {tuple(out.shape)}")

    # the same path step by step, timed, for the per-phase launch counts
    prefill = make_prefill_step(cfg, max_seq)
    decode = make_decode_step(cfg)
    mha_fwd.launches = 0
    zero_route_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logits = prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n_prefill = mha_fwd.launches
    check_routes(route_counts(), {"mha_fwd": {"mma": cfg.n_layers}},
                 "prefill")
    mha_fwd.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(N - 1):  # feed back the tokens greedy_generate chose
        state, logits = decode(params, state, out[:, i:i + 1])
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / (N - 1)
    n_decode = mha_fwd.launches
    if n_prefill + n_decode != launches:
        raise AssertionError("step-by-step launches differ from the run's")

    # last decode step's logits against a full-sequence forward
    seq = torch.cat([prompt, out[:, :N - 1]], dim=1)
    with torch.no_grad():
        h, _, _ = forward(params, cfg, seq)
        ref = logits_from_hidden(params, cfg, h[:, -1:])[:, -1].float()
    got = logits[:, -1].float()
    got, ref = got[:, :cfg.vocab_size], ref[:, :cfg.vocab_size]
    err = (got - ref).abs()
    ok = bool((err <= SERVE_ATOL + SERVE_RTOL * ref.abs()).all())
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"  last decode logits vs full forward over {seq.shape[1]} tokens: "
          f"max err {err.max().item():.3e} (tol {SERVE_ATOL:g} + "
          f"{SERVE_RTOL:g}|ref|), |ref| max {ref.abs().max().item():.3f}, "
          f"argmax agreement {agree:.3f}, finite "
          f"{bool(torch.isfinite(got).all())}")
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError("serving logits disagree with the full forward")
    print(f"  [{power}] greedy_generate end to end {e2e_s * 1e3:.1f} ms for "
          f"{B * N} tokens ({B * N / e2e_s:.1f} tokens/s)")
    print(f"  [{power}] prefill {prefill_s * 1e3:.2f} ms ({B * P / prefill_s:.0f}"
          f" prompt tokens/s); decode {decode_ms:.3f} ms/step for batch {B} "
          f"({B * 1e3 / decode_ms:.1f} tokens/s)")
    print(f"  [{power}] torch.cuda.max_memory_allocated {peak / 2**20:.1f} MiB")
    return {"launches": launches, "prefill_launches": n_prefill,
            "decode_launches": n_decode, "prefill_ms": prefill_s * 1e3,
            "decode_ms": decode_ms, "mean_kv_len": P + N // 2,
            "tokens": out}


def time_ms(torch, fn, iters, warm=5):
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, n, match=""):
    """Device time per call of the kernels whose name contains ``match``
    (all kernels by default), over ``n`` calls of ``fn`` under
    torch.profiler: the kernels' own time, without the host's launch cost
    that back-to-back CUDA-event timing includes when the host is the
    slower side. In a long process the profiler now and then records
    fewer launches than ran, or none: a session in which some kernel's
    recorded launches are not a multiple of ``n`` is made again (it says
    so), up to three sessions; the last one counts each kernel's mean
    time per recorded launch times its launches per call, rounded where
    that is not 0. None if no session recorded device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.key, e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and match in e.key
                   and e.count]
        short = [f"{c} of {k[:50]}" for k, c, _ in kernels if c % n]
        if kernels and not short:
            break
        print(f"  profiler, session {attempt + 1}: recorded "
              f"{', '.join(short) if kernels else 'no device time'} over "
              f"{n} calls")
    total = sum(t / c * (round(c / n) or c / n) for _, c, t in kernels)
    return total / 1e3 if total else None


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def attention_bound_ms(B, S, T, H, K, hd, causal, kv_len, el_bytes,
                       hdv=None, peak=BF16_FLOPS_PER_S):
    """Least time: max(bytes once / HBM rate, FLOPs / ``peak``: bf16's
    unless given). Reads q, k (hd wide) and v (hdv, default hd), writes
    out (hdv) and lse."""
    hdv = hdv or hd
    keys = kv_len if kv_len is not None else T
    # valid (query, key) pairs; rectangular causal: query i sees keys
    # <= T - S + i
    pairs = S * (T - S) + S * (S + 1) // 2 if causal else S * keys
    flops = 2 * (hd + hdv) * pairs * B * H  # q.k and p.v, 2 FLOPs a MAC
    nbytes = (el_bytes * (B * S * H * (hd + hdv) + B * keys * K * (hd + hdv))
              + 4 * B * H * S)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / peak), \
        ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak
         else "operations")


def phase_timing(torch, gen, power, serve, errs):
    """Phase 4: kernel, plain version and SDPA at the serving shapes, at
    the llama-1b eval step's (its launches are filled in after phase 7) and
    at phase 9's training shapes (llama-7b, gemma-2b).
    Where the tensor-core route runs, the fma kernel that ran these shapes
    before it is timed beside it, in the same run."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention.attention import (_fwd_route,
                                                         _launch_fwd, mha_fwd)
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    kl = serve["mean_kv_len"]
    shapes = {
        "prefill": ((8, 512, 512, 12, 12, 64, True, None),
                    serve["prefill_launches"], 50, "prefill llama-130m"),
        "decode": ((8, 1, 576, 12, 12, 64, False, kl),
                   serve["decode_launches"], 500, "decode kv_len=300"),
        "eval": ((16, 256, 256, 32, 32, 64, True, None), None, 50,
                 "eval llama-1b"),
        # phase 9's training shapes (their launches are filled in after it)
        "train llama-7b": ((16, 256, 256, 32, 32, 128, True, None), None, 50,
                           "train llama-7b hd=128"),
        "train gemma-2b": ((16, 256, 256, 8, 1, 256, True, None), None, 10,
                           "train gemma-2b H=8 K=1 hd=256"),
    }
    rows = []
    for phase, (shape, launches, iters, err_case) in shapes.items():
        B, S, T, H, K, hd, causal, kv_len = shape
        q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, torch.bfloat16)
        kl_t = None if kv_len is None else torch.tensor(
            kv_len, dtype=torch.int32, device="cuda")
        scale = hd ** -0.5
        route = _fwd_route(q, k, v)
        ms = time_ms(torch, lambda: mha_fwd(q, k, v, kl_t, scale=scale,
                                            causal=causal), iters)
        dev_ms = device_ms(torch, lambda: mha_fwd(
            q, k, v, kl_t, scale=scale, causal=causal), 10, "mha_fwd")
        fma_ms = fma_dev_ms = None
        if route == "mma":
            def fma():
                return _launch_fwd("fma", q, k, v, kl_t, scale, causal)
            fma_ms = time_ms(torch, fma, max(iters // 5, 5))
            fma_dev_ms = device_ms(torch, fma, 5, "mha_fwd")
        plain_ms = time_ms(torch, lambda: mha_fwd_ref(
            q, k, v, kl_t, scale=scale, causal=causal), max(iters // 10, 5))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if kv_len is not None:
            mask = (torch.arange(T, device="cuda") < kv_len)[None, None, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal, scale=scale)
        lib_ms = time_ms(torch, sdpa, iters)
        lib_dev_ms = device_ms(torch, sdpa, 10)
        bound, by = attention_bound_ms(B, S, T, H, K, hd, causal, kv_len, 2)
        print(f"  [{power}] mha_fwd {phase} B={B} S={S} T={T} H={H} hd={hd}"
              f"{' kv_len=%d' % kv_len if kv_len is not None else ''}, "
              f"{route} route: {ms:.4f} ms (device time {fmt_ms(dev_ms)}; "
              f"bound {bound:.4f} ms by {by}; plain {plain_ms:.4f} ms; SDPA "
              f"{lib_ms:.4f} ms, device time {fmt_ms(lib_dev_ms)})"
              + ("" if fma_ms is None else f"; the fma kernel at this shape "
                 f"{fma_ms:.4f} ms (device time {fmt_ms(fma_dev_ms)})"))
        rows.append({"name": "mha_fwd", "shape": phase, "route": "cuda",
                     "kernel_route": route,
                     "source": SRC_MHA, "replaces": TPU_MHA,
                     "launches": launches,
                     "max_abs_err": errs[(err_case, "bfloat16")],
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                     "library_device_ms": lib_dev_ms, "fma_ms": fma_ms,
                     "fma_device_ms": fma_dev_ms})
    return rows


def bwd_bound_ms(B, S, T, H, K, hd, causal, kv_len, el_bytes, kernel,
                 hdv=None, peak=BF16_FLOPS_PER_S):
    """Least time of an attention backward kernel: max(bytes once / HBM
    rate, FLOPs / ``peak``: bf16's unless given). Per valid (query, key) pair dQ takes s and
    ds.k (hd wide each) and dp (hdv); dK, dV take s, ds^T q (hd), dp and
    p^T dO (hdv; default hd). Both read q, k (hd), v, dout (hdv), lse and
    delta; dQ writes dQ, the other dK and dV."""
    hdv = hdv or hd
    keys = kv_len if kv_len is not None else T
    pairs = S * (T - S) + S * (S + 1) // 2 if causal else S * keys
    mac = 2 * hd + hdv if kernel == "mha_bwd_dq" else 2 * (hd + hdv)
    flops = 2 * mac * pairs * B * H
    q_el, kv_el = B * S * H, B * T * K
    nbytes = (el_bytes * (q_el + B * keys * K) * (hd + hdv)
              + 2 * 4 * B * H * S)
    nbytes += el_bytes * (q_el * hd if kernel == "mha_bwd_dq"
                          else kv_el * (hd + hdv))
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def bwd_timing(torch, gen, power, errs):
    """Phase 4, the backward kernels at the training step's shape (llama-1b:
    B=16, S=T=256, 32 heads of 64, causal, bf16), at qwen2-500m's GQA
    shape (B=8, S=T=512, 14 heads over 2 kv heads of 64), and at phase 9's
    llama-7b (32 heads of 128) and gemma-2b (B=16, S=T=256, 8 heads over 1
    kv head of 256, the fma route): each
    kernel on its route by CUDA events and by device time (torch.profiler),
    where the mma route runs the fma kernel that took these shapes before
    it beside it in the same run, the plain version, the bound, and the
    library route (the backward of F.scaled_dot_product_attention: dQ, dK
    and dV together, in its own (B, H, S, hd) layout). -> one row per
    kernel, its training shape's numbers on top and every shape under
    "shapes"."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention.attention import (_bwd_route,
                                                         mha_bwd_dkv,
                                                         mha_bwd_dq)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref)
    shapes = {"train": ((16, 256, 256, 32, 32, 64), "train llama-1b"),
              "gqa": ((8, 512, 512, 14, 2, 64), "gqa qwen2-500m H=14 K=2"),
              "llama-7b": ((16, 256, 256, 32, 32, 128),
                           "train llama-7b hd=128"),
              "gemma-2b": ((16, 256, 256, 8, 1, 256),
                           "train gemma-2b H=8 K=1 hd=256")}
    note = "backward of F.scaled_dot_product_attention (dQ, dK, dV together)"
    rows = {name: [] for name in BWD_KERNELS}
    for shape, ((B, S, T, H, K, hd), err_case) in shapes.items():
        args = bwd_inputs(torch, gen, B, S, T, H, K, hd, True, None,
                          torch.bfloat16)
        kw = dict(scale=hd ** -0.5, causal=True)
        q, k, v, do = args[:4]
        route = _bwd_route(q, k, v)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           scale=hd ** -0.5,
                                           enable_gqa=K != H)
        dot = do.transpose(1, 2).contiguous()

        def sdpa_bwd():
            return torch.autograd.grad(o, [qt, kt, vt], dot,
                                       retain_graph=True)
        lib_ms = time_ms(torch, sdpa_bwd, 20)
        lib_dev_ms = device_ms(torch, sdpa_bwd, 10)
        for name, kern, plain in (("mha_bwd_dq", mha_bwd_dq, mha_bwd_dq_ref),
                                  ("mha_bwd_dkv", mha_bwd_dkv,
                                   mha_bwd_dkv_ref)):
            def call():
                return kern(*args, **kw)

            def fma():
                return bwd_fma(torch, name, args, kw)
            ms = time_ms(torch, call, 20)
            dev_ms = device_ms(torch, call, 10, name)
            fma_ms = fma_dev_ms = None
            if route == "mma":  # the kernel that took the shape before
                fma_ms = time_ms(torch, fma, 5)
                fma_dev_ms = device_ms(torch, fma, 5, name)
            plain_ms = time_ms(torch, lambda: plain(*args, **kw), 5)
            bound, by = bwd_bound_ms(B, S, T, H, K, hd, True, None, 2, name)
            print(f"  [{power}] {name} {shape} B={B} S={S} T={T} H={H} K={K} "
                  f"hd={hd} causal bf16, {route} route: {ms:.4f} ms (device "
                  f"time {fmt_ms(dev_ms)}; bound {bound:.4f} ms by {by}"
                  + ("" if fma_ms is None else f"; the fma kernel at this "
                     f"shape {fma_ms:.4f} ms, device time "
                     f"{fmt_ms(fma_dev_ms)}")
                  + f"; plain {plain_ms:.4f} ms; {note} {lib_ms:.4f} ms, "
                  f"device time {fmt_ms(lib_dev_ms)})")
            rows[name].append({
                "name": name, "shape": f"{shape}: B={B} S={S} T={T} H={H} "
                f"K={K} hd={hd} causal bf16", "route": "cuda",
                "kernel_route": route, "source": SRC_MHA_BWD,
                "replaces": TPU_KERNELS[name], "launches": None,
                "max_abs_err": errs[(name, err_case, "bfloat16")],
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "library_device_ms": lib_dev_ms, "library_note": note,
                "fma_ms": fma_ms, "fma_device_ms": fma_dev_ms})
        del args, q, k, v, do, qt, kt, vt, o, dot
    out = []
    for name in BWD_KERNELS:
        row = {k: v for k, v in rows[name][0].items() if k != "shape"}
        row["shapes"] = rows[name]
        out.append(row)
    return out


def update_call(torch, lib, route, theta, g, ss, lr):
    """A call of a colnorm library's update_apply C entry for ``route``
    ("vec" with this tree's split, or "strided") on these tensors, col,
    with no gscale."""
    from repro_torch.kernels.colnorm import colnorm as C
    L, m, n = theta.shape
    lr_p, lr_v = C.scalar_arg(lr, "lr", theta.device)
    T, G = C._DTYPES[theta.dtype], C._DTYPES[g.dtype]
    if route == "vec":
        split = C.vec_split(theta.numel(), C.vec_head(theta, g),
                            C.vec_width(theta, g))
        entry, args = lib.update_apply_vec, (
            theta.data_ptr(), T, g.data_ptr(), G, ss.data_ptr(), L, m, n, 0,
            *split, lr_p, lr_v, None, 1.0, C.EPS)
    else:
        entry, args = lib.update_apply, (
            theta.data_ptr(), T, *theta.stride(), g.data_ptr(), G,
            *g.stride(), ss.data_ptr(), L, m, n, 0, lr_p, lr_v, None, 1.0,
            C.EPS)

    def call():
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"update_apply ({route}): CUDA error {err}")
    return call


def update_timing(torch, gen, power, errs, procs, row, theta, g, ss, lr):
    """Phase 4, update_apply beyond its w_gate row: at the head (bf16
    theta, f32 m', as head_update_apply calls it) against its bound and
    addcdiv_; at w_gate, in turns there and back, the vec kernel, the
    strided kernel on the same bytes and the "update loads and stores only"
    variant, by CUDA events and by device time. Adds them to ``row``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    head = (1, 2048, 32000)
    th = torch.randn(head, generator=gen, device="cuda").to(torch.bfloat16)
    m = 1e-3 * torch.randn(head, generator=gen, device="cuda")
    ss_h = C.norm_sumsq(m, "col")
    denom = torch.sqrt(ss_h) + 1e-8
    nh = th.numel()
    nbytes = (2 + 2 + 4) * nh + 4 * head[2]
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    kern = lambda: C.update_apply(th, m, ss_h, lr, "col")  # noqa: E731
    lib = lambda: th.addcdiv_(m, denom, value=-1e-6)  # noqa: E731
    if C._route(th, m) != "vec":
        raise AssertionError("update_apply at the head is not on vec")
    ms = time_ms(torch, kern, 50)
    plain_ms = time_ms(torch, lambda: CR.update_apply_ref(
        th, m, ss_h, lr, "col"), 10)
    lib_ms = time_ms(torch, lib, 50)
    turns = [device_ms(torch, f, 20) for f in (kern, lib, lib, kern)]
    dev = tuple(None if None in pair else sum(pair) / 2
                for pair in ((turns[0], turns[3]), (turns[1], turns[2])))
    print(f"  [{power}] update_apply lm_head (1,2048,32000) bf16 theta, f32 "
          f"m', col, vec: {ms:.4f} ms (bound {bound:.4f} ms by bytes, "
          f"{nbytes / 1e6:.1f} MB, {bound / ms:.3f} of it; plain "
          f"{plain_ms:.4f} ms; theta.addcdiv_(m, sqrt(ss)+eps, value=-lr) "
          f"{lib_ms:.4f} ms); device time in turns (kernel, library, "
          f"library, kernel) {', '.join(fmt_ms(t) for t in turns)}")
    row["shapes"] = [
        {k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                             "library_ms", "device_ms", "library_device_ms",
                             "max_abs_err")},
        {"shape": "lm_head (1,2048,32000) theta bf16, m' f32", "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound, "library_ms": lib_ms,
         "device_ms": dev[0], "library_device_ms": dev[1],
         "max_abs_err": errs[("update_apply", "lm_head (1,2048,32000)",
                              "bfloat16 g float32")]}]
    del th, m, ss_h, denom
    # w_gate: the two routes and the variant on the same bytes, in turns
    lib = C._bind(_build.library("colnorm"))
    var = C._bind(_variant_lib(procs, "update loads and stores only"))
    calls = {"vec": update_call(torch, lib, "vec", theta, g, ss, lr),
             "strided": update_call(torch, lib, "strided", theta, g, ss, lr),
             "loads and stores only": update_call(torch, var, "vec", theta,
                                                  g, ss, lr)}
    order = list(calls) + list(calls)[::-1]
    ev, dv = {k: [] for k in calls}, {k: [] for k in calls}
    for k in order:
        ev[k].append(time_ms(torch, calls[k], 20))
    for k in order:
        dv[k].append(device_ms(torch, calls[k], 20))
    res = {}
    for k in calls:
        e = sum(ev[k]) / 2
        d = None if None in dv[k] else sum(dv[k]) / 2
        res[k] = {"ms": e, "device_ms": d, "runs": ev[k], "device_runs": dv[k]}
        print(f"  [{power}] update_apply w_gate bf16 col, {k}: {e:.4f} ms "
              f"(events, {' and '.join(f'{x:.4f}' for x in ev[k])}), device "
              f"{fmt_ms(d)} ({', '.join(fmt_ms(x) for x in dv[k])}); "
              f"{row['bound_ms'] / e:.3f} of the {row['bound_ms']:.4f} ms "
              f"bound")
    v, st = res["vec"], res["strided"]
    print(f"  [{power}] update_apply w_gate: vec {st['ms'] / v['ms']:.2f}x "
          f"the strided kernel by events" + (
              "" if None in (v["device_ms"], st["device_ms"]) else
              f", {st['device_ms'] / v['device_ms']:.2f}x by device time"))
    row["kernel_route"] = "vec"
    row["variants"] = res


def optimizer_timing(torch, gen, power, errs, procs):
    """Phase 4, optimizer kernels at their largest llama-1b shapes (bf16
    operands, col as on the main path): kernel, plain version, bound by
    bytes and one PyTorch library call doing the same work; update_apply
    also as ``update_timing`` says."""
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head import ref as HR
    from repro_torch.kernels.scale_head import scale_head as H
    big, head = (24, 2048, 5461), (1, 2048, 32000)
    bf = torch.bfloat16
    g = torch.randn(big, generator=gen, device="cuda").to(bf)
    theta = torch.randn(big, generator=gen, device="cuda").to(bf)
    ss = C.norm_sumsq(g, "col")
    denom = torch.sqrt(ss) + 1e-8  # the library calls' divisor, f32
    lr = torch.tensor(1e-6, device="cuda")
    n, L, cols = g.numel(), big[0], big[2]
    gh = torch.randn(head, generator=gen, device="cuda").to(bf)
    m = 1e-3 * torch.randn(head, generator=gen, device="cuda")
    gh32 = gh.float()  # lerp_ takes its end in m's dtype
    nh = gh.numel()
    cases = [
        # name, shape name, bytes moved once, kernel, plain, library, note
        ("norm_sumsq", "w_gate/w_up (24,2048,5461)", 2 * n + 4 * L * cols,
         lambda: C.norm_sumsq(g, "col"),
         lambda: CR.norm_sumsq_ref(g, "col"),
         lambda: torch.linalg.vector_norm(g, dim=1, keepdim=True,
                                          dtype=torch.float32),
         "torch.linalg.vector_norm(dim=1, dtype=float32)"),
        ("update_apply", "w_gate/w_up (24,2048,5461)",
         3 * 2 * n + 4 * L * cols,
         lambda: C.update_apply(theta, g, ss, lr, "col"),
         lambda: CR.update_apply_ref(theta, g, ss, lr, "col"),
         lambda: theta.addcdiv_(g, denom, value=-1e-6),
         "theta.addcdiv_(g, sqrt(ss)+eps, value=-lr)"),
        ("norm_apply", "w_gate/w_up (24,2048,5461)",
         (2 + 4) * n + 4 * L * cols,
         lambda: C.norm_apply(g, ss, "col", out_dtype=torch.float32),
         lambda: CR.norm_apply_ref(g, ss, "col", out_dtype=torch.float32),
         lambda: torch.div(g, denom),
         "torch.div(g, sqrt(ss)+eps) -> float32"),
        ("momentum_sumsq", "lm_head (1,2048,32000)",
         (4 + 2 + 4) * nh + 4 * head[2],
         lambda: H.momentum_sumsq(m, gh, 0.9, "col"),
         lambda: HR.momentum_sumsq_ref(m, gh, 0.9, "col"),
         lambda: m.lerp_(gh32, 0.1),
         "m.lerp_(g, 1-beta), EMA only, g in f32"),
    ]
    rows = []
    for name, sname, nbytes, kern, plain, lib, lib_note in cases:
        src = SRC_MOMENTUM if name == "momentum_sumsq" else SRC_COLNORM
        ms = time_ms(torch, kern, 50)
        plain_ms = time_ms(torch, plain, 10)
        lib_ms = time_ms(torch, lib, 50)
        # kernel and library call also by device time, in turns (kernel,
        # library, library, kernel), so that the card's drift falls on both
        turns = [device_ms(torch, f, 20) for f in (kern, lib, lib, kern)]
        k1, l1, l2, k2 = turns
        dev = tuple(None if None in pair else sum(pair) / 2
                    for pair in ((k1, k2), (l1, l2)))
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        # phase 2's error at this shape and these dtypes (bf16 g; the
        # head's momentum in f32)
        dts = "bfloat16 m float32" if name == "momentum_sumsq" else "bfloat16"
        err = errs[(name, sname, dts)]
        print(f"  [{power}] {name} {sname} bf16 col: {ms:.4f} ms (bound "
              f"{bound:.4f} ms by bytes, {nbytes / 1e6:.1f} MB, "
              f"{bound / ms:.3f} of it; "
              f"{nbytes / ms / 1e6:.0f} GB/s; plain {plain_ms:.4f} ms; "
              f"{lib_note} {lib_ms:.4f} ms)" + (
                  "" if None in dev else
                  f"; device time in turns (kernel, library, library, "
                  f"kernel) {', '.join(fmt_ms(t) for t in turns)}: kernel "
                  f"{dev[0] / dev[1]:.3f}x the library"))
        rows.append({"name": name, "shape": sname, "route": "cuda",
                     "source": src, "replaces": TPU_KERNELS[name],
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": lib_ms,
                     "device_ms": dev[0], "library_device_ms": dev[1]})
    update_timing(torch, gen, power, errs, procs, rows[1], theta, g, ss, lr)
    return rows


def phase_profile(torch, seed, power, serve):
    """Phase 5: device busy time of one prefill and of decode steps.

    torch.profiler (CUPTI) sums the kernels' device time; the idle share
    is taken against the untraced times of phase 3.
    """
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.training import make_decode_step, make_prefill_step
    cfg = get_arch("llama-130m")
    B, P, steps = 8, 512, 8
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg, P + 64)
    decode = make_decode_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for phase, n in (("prefill", 1), ("decode", steps)):
        state, logits = prefill(params, prompt)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            if phase == "prefill":
                prefill(params, prompt)
            else:
                for _ in range(n):
                    state, logits = decode(params, state, tok)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
        untraced = serve["prefill_ms"] if phase == "prefill" \
            else serve["decode_ms"]
        if busy_ms == 0:
            print(f"  {phase}: the profiler recorded no device time "
                  "(device busy share not measured)")
            continue
        print(f"  [{power}] {phase}: device busy {busy_ms:.3f} ms per "
              f"{'step' if n > 1 else 'call'} of {untraced:.3f} ms untraced "
              f"(idle share {1 - busy_ms / untraced:.3f}); "
              f"{sum(e.count for e in kernels) // n} kernel launches")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        for e in top:
            print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms "
                  f"x{e.count // n:<4d} {e.key[:90]}")


def counts():
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.scale_head import scale_head as H
    return {"norm_sumsq": C.norm_sumsq.launches,
            "update_apply": C.update_apply.launches,
            "norm_apply": C.norm_apply.launches,
            "momentum_sumsq": H.momentum_sumsq.launches}


def zero_counts():
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.scale_head import scale_head as H
    for fn in (C.norm_sumsq, C.update_apply, C.norm_apply, H.momentum_sumsq):
        fn.launches = 0


def step_bytes(params, labels):
    """Bytes an update_params step of SCALE must move (each once): a
    stateless matrix reads g twice (sums of squares, apply) and theta once
    and writes theta; the head reads g, reads and writes the f32 momentum,
    reads it again and reads and writes theta; an Adam vector reads g,
    reads and writes theta and both f32 moments."""
    total = 0
    for k, p in params.items():
        n, b = p.numel(), p.element_size()
        total += n * {"vector": 3 * b + 16, "last": 3 * b + 12}.get(
            labels[k], 4 * b)
    return total


def profile_step(torch, power, step, untraced_ms, n=3,
                 label="update_params step", top=8):
    """Device busy time and top kernels of ``n`` calls of ``step``
    (torch.profiler), and the update_apply kernels' sum where they ran; the
    idle share is against the untraced step time. -> (busy ms per call or
    None, [(kernel, launches per call, device ms per call)])."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy_ms == 0:
        print("  the profiler recorded no device time (busy share not "
              "measured)")
        return None, []
    print(f"  [{power}] {label}: device busy {busy_ms:.3f} ms of "
          f"{untraced_ms:.3f} ms untraced (idle share "
          f"{1 - busy_ms / untraced_ms:.3f}); "
          f"{sum(e.count for e in kernels) // n} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms "
              f"x{e.count // n:<4d} {e.key[:90]}")
    ua = [e for e in kernels if "update_apply" in e.key]
    if ua:  # both update_apply kernels (the head's may miss the top)
        print(f"  [{power}] {label}: update_apply kernels "
              f"{sum(e.self_device_time_total for e in ua) / 1e3 / n:.3f} ms "
              f"of device time, {sum(e.count for e in ua) // n} launches")
    return busy_ms, [(e.key, e.count / n, e.self_device_time_total / 1e3 / n)
                     for e in kernels]


def phase_optimizer(torch, seed, power):
    """Phase 6: SCALE optimizer steps of llama-1b at full width and depth."""
    from repro_torch.configs import get_arch
    from repro_torch.core import (apply_updates, global_norm, label_tree,
                                  linear_warmup_cosine, make_optimizer)
    from repro_torch.core import pipeline
    from repro_torch.models import init_params
    from repro_torch.models.model import flatten
    cfg = get_arch("llama-1b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = {k: p.detach() for k, p in
              flatten(init_params(cfg, gen, device="cuda")).items()}
    grads = {k: torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype)
             for k, p in params.items()}
    labels = label_tree(params, require_last=True)
    n_el = sum(p.numel() for p in params.values())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; {len(params)} "
          f"leaves, {n_el / 1e9:.3f} G params; labels "
          f"{sorted(set(labels.values()))}")
    # the trainer's clip: gscale = min(1, clip / (|g| + 1e-9)), clip 1.0
    gnorm = global_norm(grads)
    gscale = torch.minimum(torch.ones_like(gnorm), 1.0 / (gnorm + 1e-9))
    # update() takes no grad_scale: the trainer scales the tree, and JAX
    # promotes bf16 * f32 to f32
    scaled = {k: pipeline.jax_mul(g, gscale) for k, g in grads.items()}
    sched = linear_warmup_cosine(1e-3, 1000)
    fused = make_optimizer("scale_fused", sched, lr_scaling=True)
    plain = make_optimizer("scale", sched, lr_scaling=True)
    pf = {k: p.clone() for k, p in params.items()}
    pr = {k: p.clone() for k, p in params.items()}
    sf, sr = fused.init(pf), plain.init(pr)
    torch.cuda.synchronize()
    expect = {"update_params": {"norm_sumsq": 8, "update_apply": 9,
                                "norm_apply": 0, "momentum_sumsq": 1},
              "update": {"norm_sumsq": 8, "update_apply": 0,
                         "norm_apply": 9, "momentum_sumsq": 1}}
    # every update_apply on the vec route
    expect_r = {"update_params": {"update_apply": {"vec": 9}}, "update": {}}

    def step(tx, p, s, entry):
        if entry == "update_params":
            return tx.update_params(grads, s, p, grad_scale=gscale)
        u, s = tx.update(scaled, s, p)
        return apply_updates(p, u), s

    entries = ["update_params"] * 3 + ["update"] * 3
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    zero_route_counts()
    per_step = []
    for entry in entries:
        before, before_r = counts(), route_counts()
        pf, sf = step(fused, pf, sf, entry)
        per_step.append((entry, {k: v - before[k]
                                 for k, v in counts().items()},
                         {k: {r: n - before_r[k][r] for r, n in c.items()}
                          for k, c in route_counts().items()}))
    torch.cuda.synchronize()
    launches = counts()
    peak_mem = torch.cuda.max_memory_allocated()
    for i, (entry, c, r) in enumerate(per_step):
        print(f"  step {i} {entry:13s} launches {c}; update_apply by route "
              f"{r['update_apply']}")
        if c != expect[entry]:
            raise AssertionError(f"step {i} ({entry}) launched {c}, not "
                                 f"{expect[entry]}")
        check_routes(r, expect_r[entry], f"step {i} ({entry})", show=False)
    print(f"  launches over the six steps: {launches}")

    # the same six steps on the plain jnp route, tracking each element's
    # peak |theta| or |step| for the per-element bound
    peak = {k: p.float().abs() for k, p in pr.items()}
    for entry in entries:
        old = {k: p.clone() for k, p in pr.items()}
        pr, sr = step(plain, pr, sr, entry)
        for k, p in pr.items():
            peak[k] = torch.maximum(peak[k], torch.maximum(
                p.float().abs(), (p.float() - old[k].float()).abs()))
        del old
    worst, changed, moved = 0.0, 0, 0
    for k, p in pf.items():
        d = (p.float() - pr[k].float()).abs()
        worst = max(worst, (d / ulp(torch, peak[k], p.dtype)).max().item())
        changed += int((d > 0).sum())
        moved += int((pr[k] != params[k]).sum())
        if not bool(torch.isfinite(p.float()).all()):
            raise AssertionError(f"non-finite params in {k}")
    mf, mr = sf.mu["lm_head/w"], sr.mu["lm_head/w"]
    m_rel = ((mf - mr).abs().max() / mr.abs().max()).item()
    print(f"  fused vs jnp after 6 steps: params differ in {changed} of "
          f"{n_el} elements, at most {worst:.2f} bf16 ulps of the element's "
          f"peak (bound {STEP_ULPS}); {moved} elements moved from their "
          f"start; lm_head momentum max err {m_rel:.3e} of max |m| (bound "
          f"{MOMENTUM_RTOL:g}); count {int(sf.count)} / {int(sr.count)}")
    if worst > STEP_ULPS or m_rel > MOMENTUM_RTOL or int(sf.count) != 6:
        raise AssertionError("impl='fused' and impl='jnp' disagree")
    del pr, sr, peak

    # one step with any host synchronisation an error
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pf, sf = fused.update_params(grads, sf, pf, grad_scale=gscale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  update_params under set_sync_debug_mode('error'): no host "
          "synchronisation")

    nbytes = step_bytes(pf, labels)
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    t_fused = time_ms(torch, lambda: fused.update_params(
        grads, sf, pf, grad_scale=gscale), 10)
    t_upd = time_ms(torch, lambda: apply_updates(pf, fused.update(
        scaled, sf, pf)[0]), 5)
    pr = {k: p.clone() for k, p in params.items()}
    sr = plain.init(pr)
    t_plain = time_ms(torch, lambda: plain.update_params(
        grads, sr, pr, grad_scale=gscale), 3)
    print(f"  [{power}] update_params step: fused {t_fused:.3f} ms "
          f"({nbytes / t_fused / 1e6:.0f} GB/s), jnp {t_plain:.3f} ms; bound "
          f"{bound:.3f} ms ({nbytes / 1e9:.3f} GB by bytes)")
    print(f"  [{power}] update + apply_updates step (fused): {t_upd:.3f} ms")
    profile_step(torch, power, lambda: fused.update_params(
        grads, sf, pf, grad_scale=gscale), t_fused)
    print(f"  [{power}] torch.cuda.max_memory_allocated over the six steps "
          f"{peak_mem / 2**20:.1f} MiB")
    return {"launches": launches, "step_ms": t_fused, "bound_ms": bound}


# ------------------------------------------------------- the loss path


def xent_counts():
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.kernels.xent import xent as X
    return {"mha_fwd": mha_fwd.launches,
            **{k: getattr(X, k).launches for k in XENT_KERNELS}}


def zero_xent_counts():
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.kernels.xent import xent as X
    for fn in (mha_fwd, *(getattr(X, k) for k in XENT_KERNELS)):
        fn.launches = 0


def xent_cases():
    # name -> (N, D, V, vocab_size, share of -1 labels)
    return {
        "llama-1b N=4096": (4096, 2048, 32000, 32000, 0.0),
        "N=1": (1, 2048, 32000, 32000, 0.0),
        "N=4097 vocab_size=31990": (4097, 2048, 32000, 31990, 0.1),
        "all labels -1": (300, 2048, 32000, 32000, 1.0),
        # D not a multiple of the tensor-core backward's K-tile of 32
        "D=80": (300, 80, 1000, 1000, 0.2),
        # chunk_plan cuts the vocabulary into 32 chunks of 1024
        "N=16384": (16384, 2048, 32000, 32000, 0.0),
        # and the tokens into two chunks (dW summed across them)
        "N=140000 D=16 V=128": (140000, 16, 128, 128, 0.1),
        # one 128 x 256 tile of the wgmma forward, h and w exactly 64 x 64
        # and 64 x 256; one row with ragged K and vocab tiles
        "single tile N=64 D=64 V=256": (64, 64, 256, 256, 0.0),
        "N=1 D=96 V=264 vocab_size=260": (1, 96, 264, 260, 0.0),
        # llama-7b's loss: D = 4096, two slabs of D on the FMA kernels
        "llama-7b N=4096 D=4096": (4096, 4096, 32000, 32000, 0.0),
        # a D that ends the FMA kernels' last slab mid-way (not a multiple
        # of 16: bf16 takes the FMA kernels too)
        "D=4100": (300, 4100, 1000, 1000, 0.2),
        # gemma-2b's loss: V = 256000, 4 splits of the forward, 63 chunks
        # of the backward
        "gemma-2b N=4096 V=256000": (4096, 2048, 256000, 256000, 0.05),
        # phase 16's heads: dbrx-132b (D 6144, V 100352) and granite-3-8b's
        # padded vocabulary (49155 of 49280 columns)
        "dbrx-132b N=4096 D=6144 V=100352": (4096, 6144, 100352, 100352, 0.0),
        "granite N=4096 D=4096 V=49280/49155": (4096, 4096, 49280, 49155,
                                                0.05),
        # and the heads of qwen2-7b, deepseek-67b and mistral-large-123b
        "qwen2-7b N=4096 D=3584 V=152064": (4096, 3584, 152064, 152064, 0.0),
        "deepseek-67b N=4096 D=8192 V=102400": (4096, 8192, 102400, 102400,
                                                0.0),
        "mistral-large N=4096 D=12288 V=32768": (4096, 12288, 32768, 32768,
                                                 0.0),
        # phase 17's head: deepseek-v3-671b (D 7168, V 129280)
        MLA_HEAD: (4096, 7168, 129280, 129280, 0.0),
        # phase 18's head: mamba2-370m (D 1024, vocab 50280 padded to 50304)
        MAMBA_HEAD: (4096, 1024, 50304, 50280, 0.0),
        # phase 19's head: jamba-1.5-large-398b (D 8192, V 65536)
        JAMBA_HEAD: (4096, 8192, 65536, 65536, 0.0),
        # phase 20's: llama-3.2-vision-11b (D 4096, V 128256); phase 21's:
        # one of musicgen-medium's 4 codebook heads (D 1536, V 2048)
        VLM_HEAD: (4096, 4096, 128256, 128256, 0.0),
        MUSICGEN_HEAD: (4096, 1536, 2048, 2048, 0.0),
    }


# phase 16's, 17's, 19's and 20's widest heads in bf16 alone, their main
# path's dtype, on its routes alone (wgmma, mma): the FMA kernels at these
# D and V, in f32 or with w read through its columns, take seconds a call
# (with the latter, the first six heads' cases took 200 s on an H100 at
# 700 W), and the gpu tests hold them at these shapes in both dtypes
XENT_BF16_ONLY = ("dbrx-132b N=4096 D=6144 V=100352",
                  "qwen2-7b N=4096 D=3584 V=152064",
                  "deepseek-67b N=4096 D=8192 V=102400",
                  "mistral-large N=4096 D=12288 V=32768",
                  "deepseek-v3 N=4096 D=7168 V=129280",
                  "jamba N=4096 D=8192 V=65536",
                  "llama-3.2-vision N=4096 D=4096 V=128256")


def xent_inputs(torch, gen, N, D, V, masked, dtype):
    h = torch.randn((N, D), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((D, V), generator=gen, device="cuda")
         / D ** 0.5).to(dtype)
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
    drop = torch.rand((N,), generator=gen, device="cuda") < masked
    labels = torch.where(drop, -1, labels)
    gl = torch.rand((N,), generator=gen, device="cuda")
    return h, w, labels, gl


def _grad_check(torch, name, got, want, dtype, key):
    """-> (max abs error, the largest error over its element's
    tolerance)."""
    scale = want.float().abs().max().item()
    tag = str(dtype).replace("torch.", "")
    d = (got.float() - want.float()).abs()
    tol = XENT_GRAD_SCALE_ATOL * scale + XENT_GRAD_RTOL[tag] * want.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool((d <= tol).all())
    if not ok:
        raise AssertionError(f"{name} disagrees with the plain version: {key}, "
                             f"max err {d.max().item():.3e}")
    return d.max().item(), (d / tol.clamp_min(1e-30)).max().item()


def phase_xent_kernels(torch, gen):
    """Phase 2: the three xent kernels against their plain versions, each
    run twice (bitwise equal), on the route its wrapper picks (counted:
    ``wgmma`` for the forward and ``mma`` for the backward on aligned bf16,
    ``fma`` for f32 and for w read through its columns; the widest heads,
    XENT_BF16_ONLY, on the bf16 routes alone). Prints each
    backward output's largest error over its element's tolerance.
    -> {(kernel, case, dtype): max abs error}."""
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    errs = {}
    for cname, (N, D, V, vs, masked) in xent_cases().items():
        for dtype in (torch.bfloat16, torch.float32)[
                :1 if cname in XENT_BF16_ONLY else 2]:
            tag = str(dtype).replace("torch.", "")
            key = f"{cname} {tag}"
            h, w, labels, gl = xent_inputs(torch, gen, N, D, V, masked, dtype)
            # aligned bf16 on the tensor cores; f32 and a D that is not a
            # multiple of 16 on the FMA kernels
            tc = dtype == torch.bfloat16 and D % 16 == 0
            fwd_route = "wgmma" if tc else "fma"
            was = dict(X.xent_fwd.route_launches)
            lse, ll = X.xent_fwd(h, w, labels, vocab_size=vs)
            torch.cuda.synchronize()
            if X.xent_fwd.route_launches != {**was, fwd_route:
                                             was[fwd_route] + 1}:
                raise AssertionError(f"xent_fwd: routes {was} -> "
                                     f"{X.xent_fwd.route_launches}, expected "
                                     f"one {fwd_route}: {key}")
            want_lse, want_ll = XR.xent_fwd_ref(h, w, labels, vocab_size=vs)
            e_f = 0.0
            for got, want in ((lse, want_lse), (ll, want_ll)):
                d = (got - want).abs()
                if not (bool(torch.isfinite(got).all()) and bool(
                        (d <= XENT_LSE_ATOL + XENT_LSE_RTOL
                         * want.abs()).all())):
                    raise AssertionError(f"xent_fwd disagrees with the plain "
                                         f"version: {key}")
                e_f = max(e_f, d.max().item())
            bad = (labels < 0) | (labels >= vs)
            if not bool((ll[bad] == 0).all()):
                raise AssertionError(f"xent_fwd: ll of a masked label is not "
                                     f"0: {key}")
            _bitwise_again(torch, "xent_fwd", torch.stack([lse, ll]),
                           torch.stack(X.xent_fwd(h, w, labels,
                                                  vocab_size=vs)), key)
            errs[("xent_fwd", cname, tag)] = e_f
            msg = [f"fwd {fwd_route} {e_f:.2e}"]
            if X.mma_layout(h, w) != tc:
                raise AssertionError(f"xent_fwd: unexpected kernel for {key}")
            # the FMA kernels, which other bf16 layouts take
            w_cols = (w.T.contiguous().T
                      if tc and cname not in XENT_BF16_ONLY else None)
            if w_cols is not None:
                e_fma = 0.0
                was = dict(X.xent_fwd.route_launches)
                got_cols = X.xent_fwd(h, w_cols, labels, vocab_size=vs)
                if X.xent_fwd.route_launches != {**was, "fma": was["fma"] + 1}:
                    raise AssertionError(f"xent_fwd: w_cols did not take the "
                                         f"fma route: {key}")
                for got, want in zip(got_cols, (want_lse, want_ll)):
                    d = (got - want).abs()
                    if not bool((d <= XENT_LSE_ATOL + XENT_LSE_RTOL
                                 * want.abs()).all()):
                        raise AssertionError(f"xent_fwd (FMA kernel) "
                                             f"disagrees: {key}")
                    e_fma = max(e_fma, d.max().item())
                msg.append(f"fwd FMA kernel {e_fma:.2e}")
            route = "mma" if tc else "fma"
            for name, fn, ref in (("xent_bwd_dh", X.xent_bwd_dh,
                                   XR.xent_bwd_dh_ref),
                                  ("xent_bwd_dw", X.xent_bwd_dw,
                                   XR.xent_bwd_dw_ref)):
                e = e_fma = 0.0
                r, r_fma = {}, {}  # err/tol by out dtype
                for out_dtype in (dtype, torch.float32)[:1 + (
                        dtype != torch.float32)]:
                    otag = str(out_dtype).replace("torch.", "")
                    args = (h, w, labels, want_lse, gl)
                    was = dict(fn.route_launches)
                    got = fn(*args, vocab_size=vs, out_dtype=out_dtype)
                    if fn.route_launches != {**was, route: was[route] + 1}:
                        raise AssertionError(f"{name}: routes {was} -> "
                                             f"{fn.route_launches}, expected "
                                             f"one {route}: {key}")
                    want = ref(*args, vocab_size=vs, out_dtype=out_dtype)
                    if got.dtype != out_dtype or got.shape != want.shape:
                        raise AssertionError(f"{name}: {got.dtype} "
                                             f"{tuple(got.shape)}: {key}")
                    e1, r[otag] = _grad_check(torch, name, got, want,
                                              out_dtype, key)
                    e = max(e, e1)
                    _bitwise_again(torch, name, got, fn(
                        *args, vocab_size=vs, out_dtype=out_dtype), key)
                    if name == "xent_bwd_dw" and not bool(
                            (got[:, vs:] == 0).all()):
                        raise AssertionError(f"xent_bwd_dw: padded columns "
                                             f"not 0: {key}")
                    if w_cols is not None:
                        was = dict(fn.route_launches)
                        e1, r_fma[otag] = _grad_check(
                            torch, f"{name} (FMA kernel)",
                            fn(h, w_cols, labels, want_lse, gl, vocab_size=vs,
                               out_dtype=out_dtype), want, out_dtype, key)
                        e_fma = max(e_fma, e1)
                        if fn.route_launches != {**was, "fma": was["fma"] + 1}:
                            raise AssertionError(f"{name}: w_cols did not take "
                                                 f"the fma route: {key}")
                    del got, want
                errs[(name, cname, tag)] = e
                ratios = ", ".join(f"{k} out {v:.3f}" for k, v in r.items())
                msg.append(f"{name[5:]} {route} {e:.2e} (err/tol {ratios})")
                if w_cols is not None:
                    ratios = ", ".join(f"{k} out {v:.3f}"
                                       for k, v in r_fma.items())
                    msg.append(f"{name[5:]} fma {e_fma:.2e} (err/tol "
                               f"{ratios})")
            torch.cuda.synchronize()
            print(f"  xent {key:34s} max err {'; '.join(msg)} (tols: lse/ll "
                  f"{XENT_LSE_ATOL:g}+{XENT_LSE_RTOL:g}|ref|, grads "
                  f"{XENT_GRAD_SCALE_ATOL:g}max|ref|+{XENT_GRAD_RTOL[tag]:g}"
                  f"|ref| in each out dtype; err/tol is the largest error "
                  f"over its element's tolerance); bitwise repeatable")
            del h, w, w_cols, labels, gl
    return errs


def xent_bound_ms(N, D, ncols, el_bytes, kernel):
    """Least time: max(bytes once / HBM rate, FLOPs / bf16 peak); the
    backward kernels recompute the logits, so they do twice the forward's
    products. -> (ms, "bytes" | "operations")."""
    flops = 2 * N * D * ncols * (1 if kernel == "xent_fwd" else 2)
    nbytes = el_bytes * (N * D + D * ncols) + 4 * N + 4 * 2 * N
    if kernel == "xent_bwd_dh":
        nbytes += el_bytes * N * D
    elif kernel == "xent_bwd_dw":
        nbytes += el_bytes * D * ncols
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def xent_timing(torch, gen, power, errs):
    """Phase 4, the xent kernels (bf16) at the loss shapes of llama-1b,
    llama-7b (D = 4096), gemma-2b (V = 256000) and deepseek-v3 (D = 7168,
    V = 129280): kernel by CUDA events
    and by device time (torch.profiler, every kernel of the call), plain
    version, bound, and two library routes: torch.matmul +
    F.cross_entropy for the forward; for the backward, the autograd
    backward of that pair (dh and dw together, reusing the saved logits),
    and that forward and backward together, which recomputes the logits as
    the kernels by contract do. At llama-1b's and llama-7b's shapes also
    the FMA kernels (w read through its columns), which walk D in one and
    in two slabs of 2048. -> one row per
    kernel, llama-1b's numbers on top and every shape under "shapes"."""
    import torch.nn.functional as F
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    shapes = {"llama-1b": ((4096, 2048, 32000), "llama-1b N=4096"),
              "llama-7b": ((4096, 4096, 32000), "llama-7b N=4096 D=4096"),
              "gemma-2b": ((4096, 2048, 256000), "gemma-2b N=4096 V=256000"),
              # phase 17's head (its launches are filled in after it)
              "deepseek-v3": ((4096, 7168, 129280), MLA_HEAD)}
    note_bwd = ("autograd of matmul + cross_entropy (dh and dw together, "
                "from saved logits)")
    note_full = ("matmul + cross_entropy and its autograd backward (dh and "
                 "dw together, logits recomputed)")
    kernel_routes = {"xent_fwd": "wgmma", "xent_bwd_dh": "mma",
                     "xent_bwd_dw": "mma"}
    bf = torch.bfloat16
    rows = {name: [] for name in XENT_KERNELS}
    for model, ((N, D, V), err_case) in shapes.items():
        h, w, labels, _ = xent_inputs(torch, gen, N, D, V, 0.0, bf)
        lse, _ = X.xent_fwd(h, w, labels, vocab_size=V)
        gl = torch.full((N,), 1.0 / N, device="cuda")
        args = (h, w, labels, lse, gl)
        w_cols = (w.T.contiguous().T if model in ("llama-1b", "llama-7b")
                  else None)
        hl, wl = h.detach().requires_grad_(), w.detach().requires_grad_()
        lib_loss = F.cross_entropy((hl @ wl).float(), labels.long(),
                                   reduction="mean")

        def lib_bwd():
            return torch.autograd.grad(lib_loss, [hl, wl], retain_graph=True)

        def lib_fwd():
            return F.cross_entropy((h @ w).float(), labels.long(),
                                   reduction="none")

        def lib_full():
            hf, wf = h.detach().requires_grad_(), w.detach().requires_grad_()
            loss = F.cross_entropy((hf @ wf).float(), labels.long(),
                                   reduction="mean")
            return torch.autograd.grad(loss, [hf, wf])
        libs = {k: (time_ms(torch, f, 10), device_ms(torch, f, 3))
                for k, f in (("fwd", lib_fwd), ("bwd", lib_bwd),
                             ("full", lib_full))}
        del lib_loss
        fns = {"xent_fwd": (X.xent_fwd, XR.xent_fwd_ref, (h, w, labels), {},
                            "fwd", "torch.matmul + F.cross_entropy", None),
               "xent_bwd_dh": (X.xent_bwd_dh, XR.xent_bwd_dh_ref, args,
                               {"out_dtype": bf}, "bwd", note_bwd, "full"),
               "xent_bwd_dw": (X.xent_bwd_dw, XR.xent_bwd_dw_ref, args,
                               {"out_dtype": bf}, "bwd", note_bwd, "full")}
        for name, (fn, ref, a, kw, lib, lib_note, lib2) in fns.items():
            def kern():
                return fn(*a, vocab_size=V, **kw)
            ms = time_ms(torch, kern, 5)
            dev_ms = device_ms(torch, kern, 5)
            plain_ms = time_ms(torch, lambda: ref(*a, vocab_size=V, **kw), 3)
            bound, by = xent_bound_ms(N, D, V, 2, name)
            (lib_ms, lib_dev), (lib2_ms, lib2_dev) = libs[lib], libs.get(
                lib2, (None, None))
            # products executed: the backward's logits, then G's hi and lo
            # halves contracted
            tflop = 2 * N * D * V * (1 if name == "xent_fwd" else 3) / 1e12
            fma_ms = fma_dev_ms = None
            if w_cols is not None:  # the FMA kernel: one or two slabs of D
                a_cols = (h, w_cols, *a[2:])

                def fma():
                    return fn(*a_cols, vocab_size=V, **kw)
                fma_ms = time_ms(torch, fma, 2, warm=1)
                fma_dev_ms = device_ms(torch, fma, 1)
            print(f"  [{power}] {name} {model} N={N} D={D} V={V} bf16, "
                  f"{kernel_routes[name]}: {ms:.4f} ms (device time "
                  f"{fmt_ms(dev_ms)}; {tflop / ms * 1e3:.1f} TFLOP/s of the "
                  f"{tflop:.3f} TFLOP it executes; bound {bound:.4f} ms by "
                  f"{by}, {bound / ms:.4f} of it; plain {plain_ms:.4f} ms; "
                  f"{lib_note} {lib_ms:.4f} ms, device time {fmt_ms(lib_dev)}"
                  + ("" if lib2 is None else f"; {note_full} {lib2_ms:.4f} "
                     f"ms, device time {fmt_ms(lib2_dev)}")
                  + ("" if fma_ms is None else f"; the FMA kernel (w read "
                     f"through its columns, {-(-D // 2048)} slab(s) of D) "
                     f"{fma_ms:.4f} ms, device time {fmt_ms(fma_dev_ms)}")
                  + ")")
            rows[name].append({
                "name": name, "shape": f"{model}: N={N} D={D} V={V} bf16",
                "route": "cuda", "kernel_route": kernel_routes[name],
                "source": SRC_XENT,
                # the forward's mainloop is in the header xent.cu includes
                "sources": [SRC_XENT] + ([SRC_HOPPER]
                                         if name == "xent_fwd" else []),
                "replaces": TPU_KERNELS[name], "launches": None,
                "max_abs_err": errs[(name, err_case, "bfloat16")],
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "library_device_ms": lib_dev, "library_note": lib_note,
                "library_recompute_ms": lib2_ms,
                "library_recompute_device_ms": lib2_dev,
                "library_recompute_note": None if lib2 is None
                else note_full, "fma_ms": fma_ms,
                "fma_device_ms": fma_dev_ms})
        del h, w, w_cols, labels, lse, gl, args, hl, wl
    out = []
    for name in XENT_KERNELS:
        row = {k: v for k, v in rows[name][0].items() if k != "shape"}
        row["shapes"] = rows[name]
        out.append(row)
    return out


# Phase 4: variants of the xent sources that measure the tensor-core
# kernels' designs at the train shape, each text substitutions on xent.cu
# or hopper_gemm.cuh (wrong results where a step is taken out: a time
# only). Of the backward: "chained" takes out the fold (each K-tile's
# products chain in the accumulator, which truncates), "no copies" fills
# the ring once and leaves stale tiles after (the loop without its
# cp.async traffic). Of the forward: "fwd no epilogue" replaces the
# softmax fold of each tile by one add of one logit (the wgmma mainloop
# alone: with no read of the accumulator left, ptxas drops the wgmma),
# "fwd loads only" also drops the wgmma (the TMA ring alone: how fast L2
# and memory feed the tiles).
_FWD_FOLD = ("    if (n0 + hopper::kBN <= ncols)\n"
             "      fold<false>(r, acc, n0);\n"
             "    else\n"
             "      fold<true>(r, acc, n0);\n", "    r.s[0] += acc[0];\n")
_FWD_WGMMA = ("#pragma unroll\n"
              "          for (int kk = 0; kk < kBK / 16; ++kk)\n"
              "            wgmma_m64n256k16<1>(acc, "
              "sw128_desc(a + 32 * kk, 16, 1024),\n"
              "                                "
              "sw128_desc(b + 16 * 128 * kk, kBBoxBytes, 1024), "
              "kt > 0 || kk > 0);\n", "")
XENT_VARIANTS = {
    # name: (the kernels it times, ((source, old text, new text), ...))
    "chained": (("xent_bwd_dh", "xent_bwd_dw"), (
        (SRC_XENT,
         '      "mov.f32 t0, 0f00000000;\\nmov.f32 t1, 0f00000000;\\n"\n'
         '      "mov.f32 t2, 0f00000000;\\nmov.f32 t3, 0f00000000;\\n"\n',
         '      "mov.f32 t0, %0;\\nmov.f32 t1, %1;\\n"\n'
         '      "mov.f32 t2, %2;\\nmov.f32 t3, %3;\\n"\n'),
        (SRC_XENT,
         '      "add.rn.f32 %0, %0, t0;\\nadd.rn.f32 %1, %1, t1;\\n"\n'
         '      "add.rn.f32 %2, %2, t2;\\nadd.rn.f32 %3, %3, t3;\\n}\\n"\n',
         '      "mov.f32 %0, t0;\\nmov.f32 %1, t1;\\n"\n'
         '      "mov.f32 %2, t2;\\nmov.f32 %3, t3;\\n}\\n"\n'))),
    "no copies": (("xent_bwd_dh", "xent_bwd_dw"), (
        (SRC_XENT,
         "    if (kt + kGemmStages - 1 < nk) load(kt + kGemmStages - 1);\n",
         ""),)),
    "fwd no epilogue": (("xent_fwd",), ((SRC_XENT, *_FWD_FOLD),)),
    "fwd loads only": (("xent_fwd",), ((SRC_XENT, *_FWD_FOLD),
                                       (SRC_HOPPER, *_FWD_WGMMA))),
}


# Phase 4: a variant of colnorm.cu that measures update_apply's vec route.
# "update loads and stores only" writes back theta + 0 * g (ptxas drops a
# load whose value nothing reads, volatile or not), so it moves the
# kernel's bytes in its pattern with no other math and no ss reads: the
# card's ceiling for them.
COLNORM_VARIANTS = {
    "update loads and stores only": (("update_apply",), (
        (SRC_COLNORM,
         "update_value(th[u].get(k), gv[u].get(k), sv[u][k], lr, gs, eps)",
         "__fadd_rn(th[u].get(k), __fmul_rn(0.f, gv[u].get(k)))"),)),
}


def start_variants(variants, sources):
    """Start one nvcc per entry of ``variants`` beside the kernels' build:
    each into its own directory of ``build/repro_torch/variants/``, with its
    copies of ``sources`` (the first is the one compiled). -> {name:
    (process, library path)}."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "variants"
    texts = {rel: (ROOT / rel).read_text() for rel in sources}
    jobs = {}
    for name, (_, subs) in variants.items():
        var = dict(texts)
        for rel, old, new in subs:
            if var[rel].count(old) != 1:
                raise AssertionError(f"variant {name!r}: its text is not "
                                     f"in {rel} once")
            var[rel] = var[rel].replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for rel, text in var.items():
            (d / Path(rel).name).write_text(text)
        jobs[name] = d / Path(sources[0]).name
    procs = {}
    for name, cu in jobs.items():
        lib = out / name.replace(" ", "_") / f"lib{cu.stem}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    atexit.register(_stop, [proc for proc, _ in procs.values()])
    return procs


def _stop(procs):
    """Kill what is still running of ``procs`` (a failed run exits early)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _variant_lib(procs, name):
    """The loaded library of variant ``name`` once its nvcc has ended."""
    import ctypes
    proc, lib = procs[name]
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"variant {name!r}: nvcc failed\n{log}")
    return ctypes.CDLL(str(lib))


def _fwd_wgmma_call(torch, lib, h, w, labels, ncols):
    """A call of a library's xent_fwd_wgmma C entry with this tree's plan,
    on buffers made once."""
    from repro_torch.kernels.xent import xent as X
    N, D = h.shape
    splits, per = X.split_plan(N, ncols)
    part = torch.empty((3, N, splits), device="cuda")
    lse, ll = (torch.empty(N, device="cuda") for _ in range(2))

    def call():
        err = lib.xent_fwd_wgmma(
            h.data_ptr(), h.stride(0), w.data_ptr(), w.stride(0),
            labels.data_ptr(), part.data_ptr(), lse.data_ptr(), ll.data_ptr(),
            N, D, ncols, 0, splits, per, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"xent_fwd_wgmma: CUDA error {err}")
    return call


def xent_variant_timing(torch, gen, power, procs, rows):
    """Phase 4: the kernels each variant times, at the train shape (the
    backward with bf16 out), by CUDA events, beside the real kernels timed
    again in the same loop (the forward's in turns, there and back); for
    the backward also the f32-out error over tolerance against the plain
    version. Adds the results to the xent rows under "variants"."""
    import math
    from repro_torch.kernels import _build
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    N, D, V = 4096, 2048, 32000
    h, w, labels, gl = xent_inputs(torch, gen, N, D, V, 0.1, torch.bfloat16)
    lse, _ = XR.xent_fwd_ref(h, w, labels, vocab_size=V)
    rows_c, cols = X.chunk_plan(N, V)
    g = torch.empty((2, rows_c, cols), dtype=torch.bfloat16, device="cuda")
    acc = torch.empty((rows_c, D), dtype=torch.float32, device="cuda")
    libs = {"kernel": X._bind(_build.library("xent"))}
    for name in XENT_VARIANTS:
        libs[name] = X._bind(_variant_lib(procs, name))
    res = {}
    flops = 2 * N * D * V
    # the forward's, in turns there and back: the card's clock drifts as it
    # heats over back-to-back products. Its TMA loads ask L2 for one 48 KB
    # stage (128 rows of h, 256 columns of w, 64 deep) per row tile,
    # vocab tile and K-tile.
    tma_bytes = -(-N // 128) * -(-V // 256) * -(-D // 64) * 49152
    fwd = [v for v in libs
           if v == "kernel" or "xent_fwd" in XENT_VARIANTS[v][0]]
    calls = {v: _fwd_wgmma_call(torch, libs[v], h, w, labels, V) for v in fwd}
    times = {v: [] for v in fwd}
    for v in fwd + fwd[::-1]:
        times[v].append(time_ms(torch, calls[v], 10))
    for v, t in times.items():
        ms = sum(t) / len(t)
        res.setdefault("xent_fwd", {})[v] = {"ms": ms, "runs": t}
        print(f"  [{power}] xent_fwd {v}: {ms:.4f} ms (mean of "
              f"{' and '.join(f'{x:.4f}' for x in t)}; {flops / ms / 1e9:.1f} "
              f"TFLOP/s of logits; its {tma_bytes / 1e9:.2f} GB of TMA loads "
              f"at {tma_bytes / ms / 1e9:.2f} TB/s)")
    for name in ("xent_bwd_dh", "xent_bwd_dw"):
        dh = name == "xent_bwd_dh"
        want = (XR.xent_bwd_dh_ref if dh else XR.xent_bwd_dw_ref)(
            h, w, labels, lse, gl, vocab_size=V)
        for variant, lib in libs.items():
            if variant != "kernel" and name not in XENT_VARIANTS[variant][0]:
                continue

            def run(bf, lib=lib):
                out = torch.empty((N, D) if dh else (D, V), device="cuda",
                                  dtype=torch.bfloat16 if bf else torch.float32)
                err = lib.xent_bwd_chunks(
                    int(dh), h.data_ptr(), h.stride(0), w.data_ptr(),
                    w.stride(0), labels.data_ptr(), lse.data_ptr(),
                    gl.data_ptr(), g.data_ptr(), acc.data_ptr(),
                    out.data_ptr(), int(bf), N, D, V, V, 0, rows_c, cols, 0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} ({variant}): CUDA error {err}")
                return out
            ms = time_ms(torch, lambda: run(True), 5)
            got = run(False)
            d = (got - want).abs()
            tol = (XENT_GRAD_SCALE_ATOL * want.abs().max()
                   + XENT_GRAD_RTOL["float32"] * want.abs())
            ratio = (d / tol).max().item()
            ratio = ratio if math.isfinite(ratio) else None  # stale tiles
            res.setdefault(name, {})[variant] = {"ms": ms, "f32_err_over_tol":
                                                 ratio}
            print(f"  [{power}] {name} {variant}: {ms:.4f} ms, f32 out "
                  f"err/tol " + ("not finite (stale tiles)" if ratio is None
                                 else f"{ratio:.3f}"))
            del got, d, tol
        del want
    for row in rows:
        if row["name"] in res:
            row["variants"] = res[row["name"]]


def phase_loss(torch, seed, power):
    """Phase 7: the loss path of llama-1b at full width and depth."""
    import math
    from repro_torch.configs import get_arch
    from unittest import mock
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.models import forward, init_params, lm_loss
    from repro_torch.training import make_eval_step
    cfg = get_arch("llama-1b")
    B, S = 16, 256
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    batch = make_dataset(cfg, S, B, seed=seed,
                         device="cuda").global_batch_at(0)
    labels = batch["labels"]
    n_tok = int((labels >= 0).sum())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}; batch {B} x {S} from "
          f"SyntheticLM (seed {seed}), {n_tok} labelled tokens")
    eval_step = make_eval_step(cfg)
    eval_step(params, batch)  # warm-up, not counted
    torch.cuda.synchronize()

    # the main path: counts set to 0 just before it, read just after
    zero_xent_counts()
    zero_route_counts()
    out = eval_step(params, batch)
    torch.cuda.synchronize()
    c_eval = xent_counts()
    check_routes(route_counts(), {"mha_fwd": {"mma": cfg.n_layers},
                                  "xent_fwd": {"wgmma": 1}},
                 "make_eval_step")
    want = {"mha_fwd": cfg.n_layers, "xent_fwd": 1, "xent_bwd_dh": 0,
            "xent_bwd_dw": 0}
    print(f"  make_eval_step launches {c_eval} (expect {want})")
    if c_eval != want:
        raise AssertionError(f"eval step launched {c_eval}, not {want}")
    loss, ppl = out["loss"].item(), out["perplexity"].item()
    with torch.no_grad():
        hidden, _, _ = forward(params, cfg, batch["tokens"])
        w0 = params["lm_head"]["w"]
        plain = (XR.losses(hidden, w0, labels, cfg.vocab_size).sum()
                 / n_tok).item()
        sigma2 = (hidden.float().square().sum(-1).mean()
                  * w0.float().var()).item()
    expect = math.log(cfg.vocab_size) + sigma2 / 2
    print(f"  eval loss {loss:.6f} (perplexity {ppl:.2f}); plain full-logit "
          f"route on the same hidden {plain:.6f} (|diff| "
          f"{abs(loss - plain):.2e}, tol {LOSS_ATOL:g}); ln V + sigma^2/2 = "
          f"{expect:.4f} at this init (sigma^2 = {sigma2:.4f})")
    if not (math.isfinite(loss) and abs(loss - plain) <= LOSS_ATOL
            and abs(ppl - math.exp(loss)) <= 1e-4 * ppl):
        raise AssertionError("eval loss disagrees with the plain route")
    # the whole eval against a forward whose attention is the plain
    # mha_fwd_ref (dispatch's name swapped for this one call), with the
    # plain full-logit loss on its hidden
    with mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref), \
            torch.no_grad():
        ref_hidden, _, _ = forward(params, cfg, batch["tokens"])
        ref_loss = (XR.losses(ref_hidden, w0, labels, cfg.vocab_size).sum()
                    / n_tok).item()
        h_err = ((hidden.float() - ref_hidden.float()).abs().max()
                 / ref_hidden.float().abs().max()).item()
    del ref_hidden
    print(f"  eval loss against a forward through mha_fwd_ref: "
          f"{ref_loss:.6f} (|diff| {abs(loss - ref_loss):.2e}, tol "
          f"{EVAL_REF_ATOL:g}); final hidden max |diff| / max |ref| "
          f"{h_err:.2e}")
    if not abs(loss - ref_loss) <= EVAL_REF_ATOL:
        raise AssertionError("eval loss disagrees with the forward through "
                             "the plain attention")

    # the loss and its gradient at the head
    w = params["lm_head"]["w"].requires_grad_(True)
    h = hidden.detach().requires_grad_()

    def kernel_route():
        return torch.autograd.grad(lm_loss(params, cfg, h, labels)[0], [h, w])

    def plain_route():
        ls = XR.losses(h, w, labels, cfg.vocab_size).sum() / n_tok
        return torch.autograd.grad(ls, [h, w])

    kernel_route()  # warm-up, not counted
    torch.cuda.synchronize()
    zero_xent_counts()
    zero_route_counts()
    gh, gw = kernel_route()
    torch.cuda.synchronize()
    c_grad = xent_counts()
    want = {"mha_fwd": 0, "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1}
    print(f"  loss-and-grad at the head launches {c_grad} (expect {want})")
    if c_grad != want:
        raise AssertionError(f"loss-and-grad launched {c_grad}, not {want}")
    check_routes(route_counts(), {"xent_fwd": {"wgmma": 1},
                                  "xent_bwd_dh": {"mma": 1},
                                  "xent_bwd_dw": {"mma": 1}},
                 "loss-and-grad at the head")
    launches = {k: c_eval[k] + c_grad[k] for k in c_eval}
    wh, ww = plain_route()
    e_h, r_h = _grad_check(torch, "dH", gh, wh, torch.bfloat16, "phase 7")
    e_w, r_w = _grad_check(torch, "dW", gw, ww, torch.bfloat16, "phase 7")
    print(f"  dH {tuple(gh.shape)} and dW {tuple(gw.shape)} against the "
          f"plain route's autograd: max err {e_h:.3e} and {e_w:.3e} (tol "
          f"{XENT_GRAD_SCALE_ATOL:g}max|ref| + "
          f"{XENT_GRAD_RTOL['bfloat16']:g}|ref|; err/tol at most {r_h:.3f} "
          f"and {r_w:.3f}); max |dW| {ww.float().abs().max().item():.3e}")
    del wh, ww, gh, gw

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernel_route()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  loss-and-grad under set_sync_debug_mode('error'): no host "
          "synchronisation")

    t_eval = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_step(params, batch)
        torch.cuda.synchronize()
        t_eval.append(time.perf_counter() - t0)
    eval_s = min(t_eval)
    grad_ms = time_ms(torch, kernel_route, 3)
    plain_ms = time_ms(torch, plain_route, 3)
    print(f"  [{power}] eval step {eval_s * 1e3:.3f} ms (best of 3; "
          f"{B * S / eval_s:.0f} tokens/s); loss-and-grad at the head "
          f"{grad_ms:.3f} ms, plain route {plain_ms:.3f} ms")
    profile_step(torch, power, lambda: eval_step(params, batch),
                 eval_s * 1e3, n=1, label="eval step")
    # two calls: the first launch of a traced window can go unrecorded
    profile_step(torch, power, kernel_route, grad_ms, n=2,
                 label="loss-and-grad at the head")

    for name, fn in (("kernel route", kernel_route),
                     ("plain route", plain_route)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        added = torch.cuda.max_memory_allocated() - base
        del res
        print(f"  [{power}] peak memory the loss-and-grad call adds, {name}: "
              f"{added / 2**20:.1f} MiB (N*V*4 = "
              f"{B * S * cfg.vocab_size * 4 / 2**20:.1f} MiB)")
        if name == "kernel route" and added >= B * S * cfg.vocab_size * 4:
            raise AssertionError("the kernel route holds (N, V) logits")
    w.requires_grad_(False)
    return {"launches": launches, "eval_ms": eval_s * 1e3,
            "grad_ms": grad_ms}


# ------------------------------------------------------- the training step


def train_counts():
    from repro_torch.kernels.attention import attention as A
    return {**counts(), **xent_counts(),
            **{k: getattr(A, k).launches for k in BWD_KERNELS}}


def zero_train_counts():
    from repro_torch.kernels.attention import attention as A
    zero_counts()
    zero_xent_counts()
    for k in BWD_KERNELS:
        getattr(A, k).launches = 0


def phase_train(torch, seed, power):
    """Phase 8: the training step of llama-1b at full width and depth."""
    import dataclasses
    import math
    from unittest import mock
    from repro_torch.configs import get_arch
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.launch import train as launcher
    from repro_torch.models import Params, init_params
    from repro_torch.models.model import flatten
    from repro_torch.training import (init_state, make_train_step,
                                      value_and_grad)
    cfg = get_arch("llama-1b")
    B, S = 16, 256
    L = cfg.n_layers
    print(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat!r}; batch "
          f"{B} x {S} from SyntheticLM (seed {seed}); scale_fused, clip 1.0, "
          f"linear_warmup_cosine(1e-3, steps)")

    # the launcher, as a user runs it
    argv = ["--arch", "llama-1b", "--optimizer", "scale_fused", "--batch",
            str(B), "--seq", str(S), "--steps", "3", "--log-every", "1",
            "--seed", str(seed)]
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}:")
    t0 = time.perf_counter()
    final = launcher.main(argv)
    print(f"  launcher: 3 steps in {time.perf_counter() - t0:.1f} s (build, "
          f"init and first-call costs included), final loss {final:.4f}")
    if not math.isfinite(final):
        raise AssertionError("the launcher's loss is not finite")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    ref_params = Params({k: p.detach().clone()
                         for k, p in flatten(params).items()})
    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(TRAIN_STEPS)]

    def builder():
        tx = make_optimizer("scale_fused",
                            linear_warmup_cosine(1e-3, TRAIN_STEPS))
        return tx, make_train_step(cfg, tx, clip_norm=1.0)

    # the main path: counts set to 0 just before it, read just after
    tx, step = builder()
    state = init_state(params, tx)
    torch.cuda.synchronize()
    zero_train_counts()
    zero_route_counts()
    per_step, per_step_routes, losses = [], [], []
    for b in batches:
        before, before_r = train_counts(), route_counts()
        state, metrics = step(state, b)
        per_step.append({k: v - before[k] for k, v in train_counts().items()})
        per_step_routes.append({k: {r: n - before_r[k][r]
                                    for r, n in c.items()}
                                for k, c in route_counts().items()})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = train_counts()
    routes = route_counts()
    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 8, "update_apply": 9, "momentum_sumsq": 1,
            "norm_apply": 0}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"train step {i} launched {c}, not {want}")
    print(f"  make_train_step: every one of {TRAIN_STEPS} steps launched "
          f"{want}; over the run {launches}")
    # the forward, its recompute, the backward pair and the xent kernels
    # on the tensor cores, every step
    want_r = {"mha_fwd": {"mma": 2 * L},
              **{k: {"mma": L} for k in BWD_KERNELS},
              "xent_fwd": {"wgmma": 1},
              "xent_bwd_dh": {"mma": 1}, "xent_bwd_dw": {"mma": 1},
              "update_apply": {"vec": 9}}
    for i, c in enumerate(per_step_routes):
        check_routes(c, want_r, f"train step {i}", show=False)
    check_routes(routes, {k: {r: TRAIN_STEPS * n for r, n in c.items()}
                          for k, c in want_r.items()},
                 f"{TRAIN_STEPS} train steps (every step {want_r})")
    losses = [float(x) for x in losses]

    # the same steps with attention through plain mha_fwd_ref autograd
    tx_r, step_r = builder()
    state_r = init_state(ref_params, tx_r)
    with mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref):
        ref_losses = []
        for b in batches:
            state_r, m = step_r(state_r, b)
            ref_losses.append(float(m["loss"]))
    del state_r, ref_params, tx_r, step_r
    gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
    print(f"  loss over {TRAIN_STEPS} steps: "
          f"{' '.join(f'{x:.4f}' for x in losses)}")
    print(f"  plain-attention route:   "
          f"{' '.join(f'{x:.4f}' for x in ref_losses)} (max |diff| "
          f"{gap:.2e}, tol {LOSS_CURVE_ATOL:g})")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and gap <= LOSS_CURVE_ATOL):
        raise AssertionError("the training loss does not fall, or leaves the "
                             "plain-attention route's curve")

    # one step with any host synchronisation an error
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  train step under set_sync_debug_mode('error'): no host "
          "synchronisation")

    # every leaf's gradient against the plain-attention route: bf16 at full
    # depth, then f32 at full width and 4 layers
    batch = batches[0]

    def grads_both(c, p):
        _, _, g = value_and_grad(p, c, batch)
        with mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref):
            _, _, r = value_and_grad(p, c, batch)
        return g, r

    g, r = grads_both(cfg, state.params)
    worst_k, worst = "", 0.0
    for k, x in g.items():
        rel = ((x.float() - r[k].float()).norm()
               / r[k].float().norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst_k, worst = k, rel
    print(f"  bf16 gradients, {len(g)} leaves at full depth, against the "
          f"plain-attention route: worst relative error in norm {worst:.3e} "
          f"({worst_k}; tol {TRAIN_GRAD_BF16:g})")
    if not worst <= TRAIN_GRAD_BF16:
        raise AssertionError("bf16 gradients disagree with plain attention")
    del g, r
    cfg4 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    p4 = init_params(cfg4, torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda")
    g, r = grads_both(cfg4, p4)
    worst_k, worst = "", 0.0
    for k, x in g.items():
        e = ((x - r[k]).abs().max() / r[k].abs().max().clamp_min(1e-30)).item()
        if e > worst:
            worst_k, worst = k, e
    print(f"  f32 gradients, 4 layers at full width, against the "
          f"plain-attention route: worst max |diff| / max |ref| per leaf "
          f"{worst:.3e} ({worst_k}; tol {TRAIN_GRAD_F32:g})")
    if not worst <= TRAIN_GRAD_F32:
        raise AssertionError("f32 gradients disagree with plain attention")
    del g, r, p4

    # times: host clock best of 3, the profile of one step, peak memory
    def one():
        nonlocal state
        state, _ = step(state, batch)

    t_step = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        t_step.append(time.perf_counter() - t0)
    step_s = min(t_step)
    print(f"  [{power}] train step {step_s * 1e3:.3f} ms (best of 3; "
          f"{B * S / step_s:.0f} tokens/s)")
    profile_step(torch, power, one, step_s * 1e3, n=1, label="train step",
                 top=30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  [{power}] torch.cuda.max_memory_allocated over one train step "
          f"{peak / 2**20:.1f} MiB")
    return {"launches": launches, "per_step": per_step[0],
            "routes": per_step_routes[0], "step_ms": step_s * 1e3,
            "peak": peak, "losses": losses}


# ------------------------------------------- the paper's two largest models

PAPER_MODELS = ("llama-7b", "gemma-2b")
PAPER_STEPS = 4  # make_train_step steps of each model in phase 9
# a train step's device time by kernel family (phase 9): the first family
# whose substring is in a kernel's name takes it
KERNEL_FAMILIES = (
    # phase 20: the VLM's cross sub-layer spans (``models.layers.
    # apply_attention`` with image embeddings), ahead of the attention
    # kernels they hold
    ("cross_kv|", "VLM cross k/v projections of the images (f32 with f32 "
     "images)"),
    ("cross_attn|", "VLM cross-attention over the image keys (mha_fwd, "
     "mha_bwd_dq, mha_bwd_dkv)"),
    ("mha_fwd", "attention forward (mha_fwd)"),
    ("mha_bwd_dq", "attention backward dQ (mha_bwd_dq)"),
    ("mha_bwd_dkv", "attention backward dK, dV (mha_bwd_dkv)"),
    ("gemm_rows_kernel", "xent_fwd (wgmma mainloop and softmax epilogue)"),
    ("xent_fwd", "xent_fwd (split combine)"),
    ("GEpilogue", "xent backward: G kernels"),
    ("StoreEpilogue", "xent backward: dH and dW products"),
    ("update_apply", "update_apply"),
    ("sumsq", "norm_sumsq and momentum_sumsq"),
    ("momentum", "norm_sumsq and momentum_sumsq"),
    ("finish_kernel", "norm_sumsq and momentum_sumsq"),
    # phase 16: the MoE layer's spans (``models.layers.apply_moe``), which
    # moe_profile puts before a kernel's name as "span|kernel"
    ("moe_router|", "MoE router (product, softmax, top-k, slots, aux)"),
    ("moe_dispatch|", "MoE dispatch (one-hot masks and einsum)"),
    ("moe_experts|", "MoE expert products (SwiGLU, capacity-padded)"),
    ("moe_combine|", "MoE combine einsum"),
    # phase 17: the MLA layer's spans (``models.layers.apply_mla_attention``)
    ("mla_proj|", "MLA projections (latents, up-projections, norms, rope, "
     "wo)"),
    ("mla_decode|", "MLA absorbed decode (latent-cache products, softmax)"),
    # phase 18: the Mamba2 layer's spans (``models.layers.apply_mamba``)
    ("mamba_proj|", "Mamba2 projections, conv and gate (in_proj, conv1d, "
     "softplus, gated rmsnorm, out_proj)"),
    ("mamba_ssd|", "Mamba2 chunked SSD (intra-chunk blocks, chunk states, "
     "recurrence)"),
    ("mamba_decode|", "Mamba2 decode recurrence (f32 state update)"),
    ("gemm", "cuBLAS GEMMs (projections, MLP, head)"),
    ("nvjet", "cuBLAS GEMMs (projections, MLP, head)"),
    ("", "other (copies, element-wise, reductions)"),
)


def by_family(kernels):
    """{family: (device ms, launches)} of profile_step's (or moe_profile's)
    kernel list."""
    out = {}
    for key, n, ms in kernels:
        fam = next(f for sub, f in KERNEL_FAMILIES if sub in key)
        t, c = out.get(fam, (0.0, 0))
        out[fam] = (t + ms, c + round(n))
    return out


def train_paper_model(torch, seed, power, arch):
    """One model of phase 9, at full width and depth: the launcher for two
    steps, then ``make_train_step`` for PAPER_STEPS steps (the main path:
    counts from 0 just before, read just after, every step's launches by
    route checked), its loss curve against the same steps with attention
    through plain ``mha_fwd_ref`` autograd from the same seeded weights
    (run after the kernel route's state is freed, so the two never share
    the card), step time, tokens/s, device busy time by kernel family, idle
    share and peak memory."""
    import math
    from unittest import mock
    from repro_torch.configs import get_arch
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.launch import train as launcher
    from repro_torch.models import init_params
    from repro_torch.models.model import count_params, param_shapes
    from repro_torch.training import init_state, make_train_step
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    cfg = get_arch(arch)
    B, S = 16, 256
    L = cfg.n_layers
    n_params = count_params(param_shapes(cfg))
    print(f"  {arch}: {L} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} kv heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} G params, "
          f"{cfg.dtype}, remat {cfg.remat!r}; batch {B} x {S} from "
          f"SyntheticLM (seed {seed}); scale_fused, clip 1.0, "
          f"linear_warmup_cosine(1e-3, steps)")
    argv = ["--arch", arch, "--optimizer", "scale_fused", "--batch", str(B),
            "--seq", str(S), "--steps", "3", "--log-every", "1", "--seed",
            str(seed)]
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}:")
    t0 = time.perf_counter()
    final = launcher.main(argv)
    print(f"  launcher: 2 steps in {time.perf_counter() - t0:.1f} s (init "
          f"and first-call costs included), final loss {final:.4f}")
    if not math.isfinite(final):
        raise AssertionError(f"{arch}: the launcher's loss is not finite")
    torch.cuda.empty_cache()

    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(PAPER_STEPS)]

    def start():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tx = make_optimizer("scale_fused",
                            linear_warmup_cosine(1e-3, PAPER_STEPS))
        return (init_state(init_params(cfg, gen, device="cuda"), tx),
                make_train_step(cfg, tx, clip_norm=1.0))

    # the main path: counts set to 0 just before it, read just after
    state, step = start()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    zero_route_counts()
    per_step, per_step_routes, losses = [], [], []
    for b in batches:
        before, before_r = train_counts(), route_counts()
        state, metrics = step(state, b)
        per_step.append({k: v - before[k] for k, v in train_counts().items()})
        per_step_routes.append({k: {r: n - before_r[k][r]
                                    for r, n in c.items()}
                                for k, c in route_counts().items()})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = train_counts()
    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 8, "update_apply": 9, "momentum_sumsq": 1,
            "norm_apply": 0}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"{arch} train step {i} launched {c}, not "
                                 f"{want}")
    # hd 128 takes the tensor cores both ways, hd 256 the fma kernels
    attn = "mma" if cfg.head_dim in (64, 128) else "fma"
    want_r = {"mha_fwd": {attn: 2 * L}, **{k: {attn: L} for k in BWD_KERNELS},
              "xent_fwd": {"wgmma": 1}, "xent_bwd_dh": {"mma": 1},
              "xent_bwd_dw": {"mma": 1}, "update_apply": {"vec": 9}}
    for i, c in enumerate(per_step_routes):
        check_routes(c, want_r, f"{arch} train step {i}", show=False)
    print(f"  {arch} make_train_step: every one of {PAPER_STEPS} steps "
          f"launched {want}, by route {want_r}")
    losses = [float(x) for x in losses]

    # times: host clock best of 3, the profile of one step
    def one():
        nonlocal state
        state, _ = step(state, batches[0])

    t_step = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        t_step.append(time.perf_counter() - t0)
    step_s = min(t_step)
    print(f"  [{power}] {arch} train step {step_s * 1e3:.3f} ms (best of 3; "
          f"{B * S / step_s:.0f} tokens/s); torch.cuda.max_memory_allocated "
          f"over its {PAPER_STEPS} main-path steps {peak / 2**20:.1f} MiB")
    busy, kernels = profile_step(torch, power, one, step_s * 1e3, n=1,
                                 label=f"{arch} train step", top=12)
    fams = by_family(kernels)
    for fam, (ms, n) in sorted(fams.items(), key=lambda x: -x[1][0]):
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<5d} {fam}")
    del state, step
    torch.cuda.empty_cache()

    # the same steps with attention through plain mha_fwd_ref autograd,
    # from the same seeded weights
    state, step = start()
    with mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref):
        ref_losses = []
        for b in batches:
            state, m = step(state, b)
            ref_losses.append(float(m["loss"]))
    del state, step
    torch.cuda.empty_cache()
    gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
    print(f"  {arch} loss over {PAPER_STEPS} steps: "
          f"{' '.join(f'{x:.4f}' for x in losses)}")
    print(f"  {arch} plain-attention route (full depth): "
          f"{' '.join(f'{x:.4f}' for x in ref_losses)} (max |diff| "
          f"{gap:.2e}, tol {LOSS_CURVE_ATOL:g})")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and gap <= LOSS_CURVE_ATOL):
        raise AssertionError(f"{arch}: the training loss does not fall, or "
                             "leaves the plain-attention route's curve")
    return {"launches": launches, "per_step": per_step[0],
            "routes": per_step_routes[0], "step_ms": step_s * 1e3,
            "tokens_per_s": B * S / step_s, "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / (step_s * 1e3),
            "peak_mib": peak / 2**20, "losses": losses,
            "ref_losses": ref_losses, "loss_gap": gap,
            "device_ms_by_family": {f: ms for f, (ms, _) in fams.items()}}


def phase_paper_models(torch, seed, power):
    """Phase 9: llama-7b and gemma-2b train at full width and depth."""
    return {arch: train_paper_model(torch, seed, power, arch)
            for arch in PAPER_MODELS}


# ------------------------------------------------------- the optimizer zoo

ZOO_ARCH = "llama-1b"
ZOO_LAYERS = 2          # depth of part (a); part (b) runs at full depth
ZOO_STEPS = 3
# constant; Adam's first steps are +-lr, which moves the bf16 norm
# scales (1.0) only above half a bf16 ulp of 1.0 (0.0039)
ZOO_LR = 5e-3
ZOO_FUSED = ("sgd_colnorm", "sgd_rownorm")  # also run with impl="fused"
# torch.linalg.svd on a CUDA tensor checks its solver's status on the
# host: sgd_svdnorm synchronises every step (GaLore and Fira on refresh
# steps only, which the sync check below does not take)
ZOO_SYNCS = ("sgd_svdnorm",)
# impl="fused" against impl="jnp" on the same gradients, per element of
# the bf16 params: as phase 6, 1.5 bf16 ulps of the element's peak a step
ZOO_STEP_ULPS = 1.5 * ZOO_STEPS
# the card against the CPU at one full-width leaf, f32, per element
# against the largest |ref| of the leaf. The products sum thousands of f32
# terms in other orders (cuBLAS/cuSOLVER against the CPU's BLAS/LAPACK;
# TF32 is off): about sqrt(5461) * 2**-24 = 4.4e-6 relative each. Five
# quintic Newton-Schulz steps amplify that along the small singular
# directions by up to a**5 = 3.4445**5 = 484: 2.1e-3 (ns, and swan after
# its standardization). SVD: each solver's backward error is at most
# about n * 2**-24 = 3.3e-4 of |G| at n = 5461, which moves the polar
# factor u @ vt (spectral norm 1) by at most 2 / (1 + sigma_min /
# sigma_max) = 1.6 times that (sigma_min / sigma_max about 0.24 at
# w_gate): 5.3e-4, 7e-3 of its largest element (0.077). The projection
# and its inverse are single products. Adam and AdamS are
# element-wise, the same IEEE operations, but CUDA's powf need not round
# b2**t as the CPU's does and 1 - b2**t magnifies an ulp of it (2e-5 at
# t = 3), so they are held per element, relative.
ZOO_LEAF_RTOL = {"ns_orthogonalize": 2.1e-3, "swan_normalize": 2.1e-3,
                 "svd_orthogonalize": 7e-3, "project": 1e-4,
                 "project_back": 1e-4}
ZOO_ADAM_RTOL = 1e-4
# part (b): GaLore and Fira run at full depth if their first step (the SVD
# of every hidden matrix) is estimated within this budget
ZOO_REFRESH_BUDGET_S = 10.0


def zoo_cases():
    from repro_torch.core import OPTIMIZER_NAMES
    return ([(n, {}) for n in OPTIMIZER_NAMES]
            + [(n, {"impl": "fused"}) for n in ZOO_FUSED])


def zoo_tag(name, kw):
    return name + (" (impl='fused')" if kw else "")


def zoo_expect(name, kw, n_mat):
    """Optimizer-kernel launches a step, and update_apply's by route."""
    zero = dict.fromkeys(("norm_sumsq", "update_apply", "norm_apply",
                          "momentum_sumsq"), 0)
    if name == "scale_fused":  # the stateless matrices and the head
        return ({**zero, "norm_sumsq": n_mat - 1, "update_apply": n_mat,
                 "momentum_sumsq": 1}, {"update_apply": {"vec": n_mat}})
    if kw.get("impl") == "fused":
        return ({**zero, "norm_sumsq": n_mat, "update_apply": n_mat},
                {"update_apply": {"vec": n_mat}})
    return zero, {}


def state_bytes(state):
    """Bytes the optimizer state holds: mu, nu and extra."""
    from repro_torch.models.model import flatten
    trees = [state.mu, state.nu] + ([state.extra] if state.extra is not None
                                    else [])
    return sum(t.numel() * t.element_size() for tree in trees
               for t in flatten(tree).values())


def zoo_leaf_checks(torch, gen):
    """The card's result of the zoo's per-leaf maths against the same call
    on the CPU, at llama-1b's w_gate slice (2048, 5461) and head
    (2048, 32000), f32."""
    import importlib
    from repro_torch.core import make_optimizer
    from repro_torch.core import normalization as N
    from repro_torch.core import pipeline as P
    swan = importlib.import_module("repro_torch.core.swan")
    bad = []

    def held(what, got, want, rtol, elementwise=False):
        got = got.float().cpu()
        want = want.float()
        err = (got - want).abs()
        scale = want.abs() if elementwise else want.abs().max()
        worst = (err / (rtol * scale).clamp_min(1e-30)).max().item()
        print(f"    {what}: max |card - cpu| {err.max().item():.3e}, "
              f"{worst:.3f} of the bound ({rtol:g} of "
              f"{'|ref|' if elementwise else 'max |ref|'})")
        if not worst <= 1:
            bad.append(what)
        return worst

    for leaf, shape in (("w_gate", (2048, 5461)), ("head", (2048, 32000))):
        g = torch.randn(shape, generator=gen, device="cuda")
        gc = g.cpu()
        t0 = time.perf_counter()
        if leaf == "w_gate":
            for fn in (N.ns_orthogonalize, N.svd_orthogonalize,
                       swan.swan_normalize):
                held(f"{leaf} {fn.__name__}", fn(g), fn(gc),
                     ZOO_LEAF_RTOL[fn.__name__])
        # Adam and AdamS at t = 3 from random moments
        m0 = torch.randn(shape, generator=gen, device="cuda") * 0.1
        v0 = torch.rand(shape, generator=gen, device="cuda") * 0.01
        count = torch.tensor(2, dtype=torch.int32, device="cuda")
        m, v, mc, vc = m0.clone(), v0.clone(), m0.cpu(), v0.cpu()
        upd = P._adam_leaf(g, m, v, count, 0.9, 0.999, 1e-8)
        want = P._adam_leaf(gc, mc, vc, count.cpu(), 0.9, 0.999, 1e-8)
        if held(f"{leaf} _adam_leaf update", upd, want, ZOO_ADAM_RTOL,
                True) > 1:
            # the bias corrections and the worst element's inputs, to
            # tell the two sides' arithmetic apart
            bc = [(float(1.0 - b ** (count + 1)).hex(),
                   float(1.0 - b ** (count.cpu() + 1)).hex())
                  for b in (0.9, 0.999)]
            i = int(((upd.cpu() - want).abs() / want.abs().clamp_min(1e-30))
                    .argmax())
            print(f"      1 - b**3 (card, cpu) for b1, b2: {bc}; element "
                  f"{i}: card {float(upd.view(-1)[i])!r} cpu "
                  f"{float(want.view(-1)[i])!r}, g "
                  f"{float(gc.view(-1)[i])!r}, m0 {float(m0.view(-1)[i])!r},"
                  f" v0 {float(v0.view(-1)[i])!r}")
        held(f"{leaf} _adam_leaf m, v", torch.stack([m, v]),
             torch.stack([mc, vc]), 1e-6, True)
        # AdamS: its update (delta mode) at t = 3 from the same momentum
        tx = make_optimizer("adams", 1e-2)
        p, pc = {"w": torch.zeros(shape, device="cuda")}, {"w": torch.zeros(
            shape)}
        s, sc = tx.init(p), tx.init(pc)
        for st, mm in ((s, m0), (sc, m0.cpu())):
            st.mu["w"].copy_(mm)
            st.count.fill_(2)
        u, _ = tx.update({"w": g}, s, p)
        uc, _ = tx.update({"w": gc}, sc, pc)
        held(f"{leaf} AdamS update", u["w"], uc["w"], ZOO_ADAM_RTOL, True)
        del u, uc, s, sc
        # the projection and its inverse, rank 256, from the card's SVD
        r = P._rank_for(shape, 256)
        pj = P._svd_projector(g, r)
        R = P._project(g, pj)
        held(f"{leaf} project (rank {r})", R, P._project(gc, pj.cpu()),
             ZOO_LEAF_RTOL["project"])
        held(f"{leaf} project_back", P._project_back(R, pj, shape),
             P._project_back(R.cpu(), pj.cpu(), shape),
             ZOO_LEAF_RTOL["project_back"])
        print(f"    ({leaf}: {time.perf_counter() - t0:.1f} s with the CPU "
              f"references)")
        del g, gc, m, v, mc, vc, m0, v0
    if bad:
        raise AssertionError(f"the card disagrees with the CPU: {bad}")


def phase_zoo(torch, seed, power):
    """Phase 10: every optimizer of the registry trains llama-1b at full
    width (part a, 2 layers), and the paper's memory axis at full depth
    (part b)."""
    import dataclasses
    import math
    from repro_torch.configs import get_arch
    from repro_torch.core import (label_tree, make_optimizer, memory_report,
                                  METHODS)
    from repro_torch.data import make_dataset
    from repro_torch.launch import train as launcher
    from repro_torch.models import Params, init_params
    from repro_torch.models.model import flatten, param_shapes
    from repro_torch.training import (init_state, make_train_step,
                                      value_and_grad)
    full = get_arch(ZOO_ARCH)
    cfg = dataclasses.replace(full, n_layers=ZOO_LAYERS)
    B, S = 16, 256
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = {k: p.detach() for k, p in
            flatten(init_params(cfg, gen, device="cuda")).items()}
    labels = label_tree(base)
    n_mat = sum(lab != "vector" for lab in labels.values())
    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(ZOO_STEPS + 1)]
    print(f"  (a) {cfg.name} at full width, {ZOO_LAYERS} layers, "
          f"{cfg.dtype}; batch {B} x {S} from SyntheticLM; clip 1.0, "
          f"constant lr {ZOO_LR:g}; {len(base)} leaves, {n_mat} matrices")

    def fresh():
        return Params({k: p.clone() for k, p in base.items()})

    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    zero_train_counts()
    zero_route_counts()
    first_step_s = {}
    for name, kw in zoo_cases():
        tag = zoo_tag(name, kw)
        tx = make_optimizer(name, ZOO_LR, **kw)
        step = make_train_step(cfg, tx, clip_norm=1.0)
        state = init_state(fresh(), tx)
        want, want_r = zoo_expect(name, kw, n_mat)
        losses, times = [], []
        for i in range(ZOO_STEPS):
            before, before_r = counts(), route_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batches[i])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = {k: v - before[k] for k, v in counts().items()}
            got_r = {k: {r: n - before_r[k][r] for r, n in c.items()}
                     for k, c in route_counts().items()}
            if got != want:
                raise AssertionError(f"{tag} step {i}: optimizer kernels "
                                     f"{got}, not {want}")
            check_routes({"update_apply": got_r["update_apply"]}, want_r,
                         f"{tag} step {i}", show=False)
            losses.append(float(metrics["loss"]))
        # one more step with any host synchronisation an error
        synced = name in ZOO_SYNCS
        if not synced:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, metrics = step(state, batches[ZOO_STEPS])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        params = flatten(state.params)
        moved = {}
        for k, p in params.items():
            lab = labels[k]
            moved[lab] = moved.get(lab, False) or bool((p != base[k]).any())
        st = state.opt_state
        finite = all(bool(torch.isfinite(t.float()).all()) for t in
                     [*params.values(),
                      *flatten({"mu": st.mu, "nu": st.nu,
                                "extra": st.extra or {}}).values()])
        # plain SGD's step on the norm scales (1.0) is lr * g, below half
        # a bf16 ulp of 1.0 here: only its matrices must move
        need = ({"first", "last", "matrix"} if name in ("sgd",
                                                        "sgd_momentum")
                else set(moved))
        print(f"  {tag:26s} losses {' '.join(f'{x:.4f}' for x in losses)}; "
              f"step 0 {times[0] * 1e3:.1f} ms, step 2 {times[2] * 1e3:.1f} "
              f"ms; kernels a step {want if any(want.values()) else 'none'}"
              f"; sync check "
              f"{'skipped (svd)' if synced else 'passed'}; moved "
              f"{sorted(k for k, v in moved.items() if v)}")
        if not (finite and all(map(math.isfinite, losses))
                and all(moved[g] for g in need)):
            raise AssertionError(f"{tag}: non-finite loss or state, or a "
                                 f"label group did not move ({moved})")
        first_step_s[tag] = times[0]
        del state, step, tx, params, st
    launches = train_counts()
    torch.cuda.empty_cache()

    # the fused ablations against impl="jnp" on the same gradients
    _, _, grads = value_and_grad(fresh(), cfg, batches[0])
    from repro_torch.core import global_norm
    gnorm = global_norm(grads)
    gscale = torch.minimum(torch.ones_like(gnorm), 1.0 / (gnorm + 1e-9))
    for name in ZOO_FUSED:
        out = {}
        for impl in ("fused", "jnp"):
            tx = make_optimizer(name, ZOO_LR, impl=impl)
            p = {k: v.clone() for k, v in base.items()}
            s = tx.init(p)
            peak = {k: v.float().abs() for k, v in p.items()}
            for _ in range(ZOO_STEPS):
                old = {k: v.clone() for k, v in p.items()}
                p, s = tx.update_params(grads, s, p, grad_scale=gscale)
                for k, v in p.items():
                    peak[k] = torch.maximum(peak[k], torch.maximum(
                        v.float().abs(), (v.float() - old[k].float()).abs()))
                del old
            out[impl] = (p, peak)
        (pf, _), (pr, peak) = out["fused"], out["jnp"]
        worst = max((((pf[k].float() - pr[k].float()).abs()
                      / ulp(torch, peak[k], pr[k].dtype)).max().item())
                    for k in pr)
        print(f"  {name}: impl='fused' against impl='jnp' after "
              f"{ZOO_STEPS} update_params steps on the same gradients: at "
              f"most {worst:.2f} bf16 ulps of the element's peak (bound "
              f"{ZOO_STEP_ULPS:g})")
        if worst > ZOO_STEP_ULPS:
            raise AssertionError(f"{name}: fused and jnp disagree")
        del out, pf, pr, peak
    del grads

    print("  the zoo's per-leaf maths, card against CPU (f32):")
    zoo_leaf_checks(torch, gen)

    # the launcher, as a user runs it
    for name in ("adam", "muon"):
        argv = ["--arch", ZOO_ARCH, "--optimizer", name, "--batch", str(B),
                "--seq", str(S), "--steps", "3", "--log-every", "1",
                "--seed", str(seed)]
        print(f"  python -m repro_torch.launch.train {' '.join(argv)}:")
        t0 = time.perf_counter()
        final = launcher.main(argv)
        print(f"  launcher ({name}, full depth): 3 steps in "
              f"{time.perf_counter() - t0:.1f} s, final loss {final:.4f}")
        if not math.isfinite(final):
            raise AssertionError(f"the launcher's loss ({name}) is not "
                                 "finite")
        torch.cuda.empty_cache()

    # (b) the paper's memory axis at full depth
    del base
    torch.cuda.empty_cache()
    L = full.n_layers
    refresh_2 = max(first_step_s["galore"], first_step_s["fira"])
    per_layer = refresh_2 / ZOO_LAYERS
    depth = min(L, max(ZOO_LAYERS, int(ZOO_REFRESH_BUDGET_S / per_layer)))
    print(f"  (b) {full.name} at full width and depth ({L} layers), 2 steps "
          f"each, clip 1.0, constant lr {ZOO_LR:g}; GaLore and Fira's first "
          f"step took {refresh_2:.2f} s at {ZOO_LAYERS} layers, so they run "
          f"at {depth} layers (budget {ZOO_REFRESH_BUDGET_S:g} s)")
    names = [("scale_fused" if m == "scale" else m) for m in METHODS] + [
        "adams"]
    peaks = {}
    for name in names:
        c = full if name not in ("galore", "fira") else \
            dataclasses.replace(full, n_layers=depth)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        g = torch.Generator(device="cuda").manual_seed(seed)
        tx = make_optimizer(name, ZOO_LR)
        state = init_state(init_params(c, g, device="cuda"), tx)
        step = make_train_step(c, tx, clip_norm=1.0)
        dsf = make_dataset(c, S, B, seed=seed, device="cuda")
        # the peak of the two steps: weights, state, gradients, activations
        # and the step's temporaries (init's are not the run's)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m1 = step(state, dsf.global_batch_at(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m2 = step(state, dsf.global_batch_at(1))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = state_bytes(state.opt_state)
        method = "scale" if name == "scale_fused" else name
        shapes = param_shapes(c)
        if method in METHODS:
            f32 = memory_report(shapes, method, dtype_bytes=4).state_bytes
            bf16 = memory_report(shapes, method).state_bytes
        else:
            f32 = bf16 = None
        loss = (float(m1["loss"]), float(m2["loss"]))
        peaks[name] = peak
        print(f"  [{power}] {name:12s} {c.n_layers:2d} layers: step 2 "
              f"{dt * 1e3:9.3f} ms ({B * S / dt:8.0f} tokens/s); peak "
              f"{peak / 2**20:10.1f} MiB; state allocated "
              f"{got / 1e9:7.3f} GB, memory.py f32 "
              f"{'n/a' if f32 is None else f'{f32 / 1e9:7.3f}'} GB, paper "
              f"bf16 protocol {'n/a' if bf16 is None else f'{bf16 / 1e9:7.3f}'}"
              f" GB; losses {loss[0]:.4f} {loss[1]:.4f}")
        if not all(map(math.isfinite, loss)):
            raise AssertionError(f"{name}: non-finite loss at full depth")
        del state, step, tx, dsf
    torch.cuda.empty_cache()
    print(f"  [{power}] peak memory, SCALE over Adam: "
          f"{peaks['scale_fused'] / peaks['adam']:.4f} "
          f"({peaks['scale_fused'] / 2**20:.1f} / "
          f"{peaks['adam'] / 2**20:.1f} MiB)")
    return {"launches": launches}


# --------------------------------------------- fault-tolerant training

def _state_leaves(state, drop=()):
    """{leaf key: tensor} of a tree, keyed as the checkpointer keys it."""
    from repro_torch.checkpoint.checkpointer import named_leaves
    return {k: x for k, x in named_leaves(state) if k not in drop}


def _first_unequal(torch, a, b):
    """The first key whose tensors differ in dtype, device or bits, or
    None."""
    if list(a) != list(b):
        return f"the keys differ: {sorted(set(a) ^ set(b))}"
    for k, x in a.items():
        y = b[k]
        if x.dtype != y.dtype or x.device != y.device or not torch.equal(x, y):
            return k
    return None


def _dir_bytes(path):
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def _guard_phase(torch, cfg, batches, seed, power):
    """Phase 11 (a): the guard around the in-place kernels."""
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.models import init_params
    from repro_torch.training import (GuardPolicy, init_state,
                                      make_train_step, parse_faults)
    L = cfg.n_layers

    def build(plan=None):
        tx = make_optimizer("scale_fused", linear_warmup_cosine(1e-3, 5))
        params = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        return init_state(params, tx, guard=True), make_train_step(
            cfg, tx, clip_norm=1.0, guard=GuardPolicy(), faults=plan)

    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 8, "update_apply": 9, "momentum_sumsq": 1,
            "norm_apply": 0}
    want_r = {"mha_fwd": {"mma": 2 * L},
              **{k: {"mma": L} for k in BWD_KERNELS},
              "xent_fwd": {"wgmma": 1},
              "xent_bwd_dh": {"mma": 1}, "xent_bwd_dw": {"mma": 1},
              "update_apply": {"vec": 9}}
    # the main path: counts set to 0 just before it, read just after
    state, step = build(parse_faults("nan_grad@2"))
    torch.cuda.synchronize()
    zero_train_counts()
    zero_route_counts()
    bad = []
    for i, b in enumerate(batches):
        before, before_r = train_counts(), route_counts()
        state, m = step(state, b)
        got = {k: v - before[k] for k, v in train_counts().items()}
        if got != want:
            raise AssertionError(f"guarded step {i} launched {got}, not "
                                 f"{want}")
        check_routes({k: {r: n - before_r[k][r] for r, n in c.items()}
                      for k, c in route_counts().items()}, want_r,
                     f"guarded step {i}", show=False)
        bad.append(int(m["bad_step"]))
    torch.cuda.synchronize()
    launches = train_counts()
    print(f"  (a) guarded steps 0-4 with nan_grad@2: every step launched "
          f"{want}, the skipped one too (its update is computed in place, "
          f"then discarded); bad_step {bad}, skipped {int(m['skipped'])}")
    if bad != [0, 0, 1, 0, 0] or int(m["skipped"]) != 1:
        raise AssertionError("the guard did not skip exactly step 2")
    drop = (".step", ".guard/.skipped")
    faulted = {k: x.clone() for k, x in _state_leaves(state, drop).items()}
    del state, step
    state, step = build()
    for i in (0, 1, 3, 4):
        state, m = step(state, batches[i])
    diff = _first_unequal(torch, faulted, _state_leaves(state, drop))
    print(f"  against the clean guarded run over the batches of steps 0, 1, "
          f"3 and 4: {len(faulted)} leaves (params, optimizer state, guard) "
          + ("bitwise equal" if diff is None else f"differ at {diff}"))
    if diff is not None:
        raise AssertionError(f"the skipped step is not bitwise a dropped "
                             f"batch: {diff}")
    del faulted
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  guarded train step under set_sync_debug_mode('error'): no host "
          "synchronisation")

    # guard on against off in turns (on, off, off, on), 3 steps a turn; the
    # two step functions train the same parameters
    tx_off = make_optimizer("scale_fused", linear_warmup_cosine(1e-3, 5))
    step_off = make_train_step(cfg, tx_off, clip_norm=1.0)
    state_off = init_state(state.params, tx_off)
    times, peaks = {"on": [], "off": []}, {"on": 0, "off": 0}
    for turn in ("on", "off", "off", "on"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for b in batches[:3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if turn == "on":
                state, _ = step(state, b)
            else:
                state_off, _ = step_off(state_off, b)
            torch.cuda.synchronize()
            times[turn].append(time.perf_counter() - t0)
        peaks[turn] = max(peaks[turn], torch.cuda.max_memory_allocated())
    del state_off, step_off, tx_off
    on, off = min(times["on"]) * 1e3, min(times["off"]) * 1e3
    print(f"  [{power}] train step with the guard on {on:.3f} ms, off "
          f"{off:.3f} ms (best of 6 each, in turns on, off, off, on): "
          f"{on - off:+.3f} ms; peak memory on {peaks['on'] / 2**20:.1f} MiB, "
          f"off {peaks['off'] / 2**20:.1f} MiB "
          f"({(peaks['on'] - peaks['off']) / 2**20:+.1f} MiB)")
    return launches, state, {"on_ms": on, "off_ms": off,
                             "peak_on": peaks["on"], "peak_off": peaks["off"]}


def _checkpoint_phase(torch, state, root, power):
    """Phase 11 (b): save, save_async, restore_latest and the fallback past
    a corrupt shard, of the whole guarded TrainState."""
    from repro_torch import checkpoint as ckpt
    d = str(Path(root) / "b")
    n_bytes = sum(x.numel() * x.element_size()
                  for x in _state_leaves(state).values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save(d, 10, state)
    t_save = time.perf_counter() - t0
    on_disk = _dir_bytes(path)
    shard = [p for p in Path(path).iterdir() if p.name.startswith("shard_")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = ckpt.save_async(d, 11, state)
    t_block = time.perf_counter() - t0
    handle.wait()
    t_commit = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, n = ckpt.restore_latest(d, state)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    want = _state_leaves(state)
    diff = _first_unequal(torch, want, _state_leaves(got))
    del got
    print(f"  (b) [{power}] save of the TrainState ({len(want)} leaves, "
          f"{n_bytes / 1e9:.3f} GB of tensors; {shard[0].name}, "
          f"{on_disk / 1e9:.3f} GB on disk): {t_save:.3f} s "
          f"({on_disk / t_save / 1e9:.2f} GB/s); save_async blocked the "
          f"caller {t_block:.3f} s and committed after {t_commit:.3f} s; "
          f"restore_latest (step {n}) {t_restore:.3f} s "
          f"({on_disk / t_restore / 1e9:.2f} GB/s), "
          + ("bitwise equal" if diff is None else f"differs at {diff}"))
    if n != 11 or diff is not None:
        raise AssertionError(f"restore_latest gave step {n}, leaf {diff}")
    newest = [p for p in (Path(d) / "step_0000000011").iterdir()
              if p.name.startswith("shard_")][0]
    with open(newest, "r+b") as f:
        f.seek(newest.stat().st_size // 2)
        f.write(b"\xff\x00\xff\x00")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, n = ckpt.restore_latest(d, state)
        torch.cuda.synchronize()
        t_fall = time.perf_counter() - t0
    said = [str(w.message) for w in caught if "falling back" in str(w.message)]
    diff = _first_unequal(torch, want, _state_leaves(got))
    del got, want
    print(f"  [{power}] newest shard corrupted: restore_latest fell back to "
          f"step {n} in {t_fall:.3f} s, warning: {said[0][:160] if said else None!r}; "
          + ("bitwise equal" if diff is None else f"differs at {diff}"))
    if n != 10 or not said or diff is not None:
        raise AssertionError("restore_latest did not fall back to step 10")
    return {"state_bytes": n_bytes, "disk_bytes": on_disk, "save_s": t_save,
            "async_block_s": t_block, "async_commit_s": t_commit,
            "restore_s": t_restore, "fallback_s": t_fall}


def _resume_phase(torch, seed, root, power):
    """Phase 11 (c): six launcher steps with a checkpoint every 3, against
    the same run's committed step 3 resumed with --resume auto."""
    from repro_torch.checkpoint.checkpointer import _read_verified
    from repro_torch.launch import train as launcher
    a, b = Path(root) / "c_full", Path(root) / "c_resumed"
    argv = ["--arch", "llama-1b", "--optimizer", "scale_fused", "--batch",
            "16", "--seq", "256", "--steps", "6", "--ckpt-every", "3",
            "--log-every", "1", "--seed", str(seed)]
    print(f"  (c) python -m repro_torch.launch.train {' '.join(argv)} "
          "--ckpt-dir <full>:")
    t0 = time.perf_counter()
    launcher.main(argv + ["--ckpt-dir", str(a)])
    t_full = time.perf_counter() - t0
    b.mkdir()
    (a / "step_0000000003").rename(b / "step_0000000003")
    print("  the same flags with --ckpt-dir <resumed> (holding the full run's "
          "committed step 3) --resume auto:")
    t0 = time.perf_counter()
    launcher.main(argv + ["--ckpt-dir", str(b), "--resume", "auto"])
    t_resumed = time.perf_counter() - t0
    fa = _read_verified(str(a / "step_0000000006"), 0)
    fb = _read_verified(str(b / "step_0000000006"), 0)
    diff = _first_unequal(torch, fa, fb)
    worst = ""
    if diff is not None:
        errs = {k: ((x.float() - fb[k].float()).abs().max()
                    / x.float().abs().max().clamp_min(1e-30)).item()
                for k, x in fa.items() if k in fb and x.numel()}
        k = max(errs, key=errs.get)
        worst = f"; worst leaf {k}: max |diff| / max |ref| {errs[k]:.3e}"
    print(f"  [{power}] full run {t_full:.1f} s, resumed run {t_resumed:.1f} "
          f"s (init, steps and checkpoints); step 6 of the two: {len(fa)} "
          f"leaves " + ("bitwise equal" if diff is None
                        else f"differ at {diff}{worst}"))
    if diff is not None:
        raise AssertionError(f"the resumed run left the uninterrupted one: "
                             f"{diff}{worst}")


def _sigterm_phase(torch, seed, root, power):
    """Phase 11 (d): SIGTERM to the launcher in a subprocess, llama-130m at
    full width and depth."""
    import os
    import signal
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_arch
    from repro_torch.core import make_optimizer
    from repro_torch.models import init_params
    from repro_torch.training import init_state
    d = Path(root) / "d"
    argv = ["--arch", "llama-130m", "--optimizer", "scale_fused", "--batch",
            "16", "--seq", "256", "--steps", "100000", "--log-every", "1",
            "--seed", str(seed), "--ckpt-dir", str(d), "--ckpt-every",
            "100000", "--resume", "auto"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_FAULTS", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                             *argv], env=env, cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("step "):
                break
        t_first = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        lines.extend(ln.rstrip("\n") for ln in proc.stdout)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t_exit = time.perf_counter() - t0
    print(f"  (d) [{power}] python -m repro_torch.launch.train "
          f"{' '.join(argv)}, SIGTERM after its first loss line "
          f"({t_first:.1f} s in): exit {rc} after {t_exit:.1f} s; its "
          "output:")
    for line in lines:
        print(f"    | {line}")
    said = [ln for ln in lines if ln.startswith("sigterm: checkpointed step")]
    if rc != 0 or not said:
        raise AssertionError("the launcher did not checkpoint and exit "
                             "cleanly on SIGTERM")
    n = int(said[0].split()[3].rstrip(","))
    cfg = get_arch("llama-130m")
    tx = make_optimizer("scale_fused", 1e-3)
    like = init_state(init_params(cfg, torch.Generator(device="cuda")
                                  .manual_seed(seed), device="cuda"), tx,
                      guard=True)
    got, step = ckpt.restore_latest(str(d), like)
    finite = all(torch.isfinite(x).all().item()
                 for x in _state_leaves(got).values()
                 if x.is_floating_point())
    print(f"  COMMITTED step {ckpt.latest_step(str(d))}: restored step "
          f"{step} (its state's step {int(got.step)}), every leaf finite: "
          f"{finite}")
    if not (step == n == int(got.step) and finite):
        raise AssertionError(f"the SIGTERM checkpoint does not restore as "
                             f"step {n}")


def phase_resilience(torch, seed, power):
    """Phase 11: fault-tolerant training, llama-1b at full width and depth
    (SIGTERM at llama-130m's)."""
    import shutil as _shutil
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.data import make_dataset
    cfg = get_arch("llama-1b")
    B, S = 16, 256
    print(f"  {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, remat "
          f"{cfg.remat!r}; batch {B} x {S} from SyntheticLM (seed {seed}); "
          f"scale_fused, clip 1.0, linear_warmup_cosine(1e-3, 5), "
          f"GuardPolicy() (finite checks)")
    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(5)]
    root = tempfile.mkdtemp(prefix="repro_ckpt_")
    try:
        print(f"  checkpoints under {root} (free "
              f"{_shutil.disk_usage(root).free / 1e9:.1f} GB)")
        t0 = time.perf_counter()
        launches, state, guard = _guard_phase(torch, cfg, batches, seed,
                                              power)
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck = _checkpoint_phase(torch, state, root, power)
        t_b = time.perf_counter() - t0
        del state
        torch.cuda.empty_cache()
        _shutil.rmtree(Path(root) / "b")
        t0 = time.perf_counter()
        _resume_phase(torch, seed, root, power)
        t_c = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _sigterm_phase(torch, seed, root, power)
        t_d = time.perf_counter() - t0
    finally:
        _shutil.rmtree(root, ignore_errors=True)
    print(f"  [{power}] phase 11 parts: (a) {t_a:.1f} s, (b) {t_b:.1f} s, "
          f"(c) {t_c:.1f} s, (d) {t_d:.1f} s")
    return {"launches": launches, "guard": guard, "checkpoint": ck}


# ------------------------------------------- the tied head (phases 2, 4, 12)

TIED_MODELS = ("llama-1b", "gemma-2b")
TIED_STEPS = 8  # make_train_step steps of each tied model in phase 12
# the tied head's routes of the xent wrappers on the main path, and the
# names its rows take in the kernels line
TIED_ROUTES = {"xent_fwd": "wgmma_t", "xent_bwd_dh": "mma_t",
               "xent_bwd_dw": "mma_t"}
TIED_ROWS = {k: f"{k} transposed" for k in XENT_KERNELS}
# Phase 12 holds a tied model's loss-and-grad against the same call with
# the plain xent versions swapped into dispatch (attention on the same
# kernels both sides): the head's own dH and dW on a shared hidden per
# element at phase 2's tolerances (XENT_GRAD_*); every leaf of the whole
# gradient, the embedding's (the head's dW plus the lookup's) among them,
# at phase 8's TRAIN_GRAD_BF16 in bf16 at full depth (the heads' dH differ
# by a bf16 rounding here and there, which the backward through the bf16
# backbone carries into every leaf and into the lookup's part) and at
# TRAIN_GRAD_F32 in f32 at 4 layers (the ``fma_t`` route).


def tied_cases():
    # name -> (N, D, V, vocab_size, share of -1 labels, dtype, h's layout)
    return {
        "tied llama-1b N=4096": (4096, 2048, 32000, 32000, 0.0, "bfloat16",
                                 "rows"),
        "tied gemma-2b N=4096 V=256000": (4096, 2048, 256000, 256000, 0.05,
                                          "bfloat16", "rows"),
        # V not a multiple of 8, and padded rows of dW
        "tied V=32003 vocab_size=32000": (4096, 2048, 32003, 32000, 0.1,
                                          "bfloat16", "rows"),
        # the FMA kernels: f32, and an h whose D is not contiguous
        "tied f32 N=1024": (1024, 2048, 32000, 31990, 0.1, "float32", "rows"),
        "tied non-contiguous h N=1024": (1024, 2048, 32000, 32000, 0.1,
                                         "bfloat16", "h strided"),
        # two token chunks: the bf16 dW summed across them in (cols, D) f32
        "tied N=140000 D=16 V=128": (140000, 16, 128, 128, 0.1, "bfloat16",
                                     "rows"),
        # one row, a ragged K-tile and a ragged vocab tile
        "tied N=1 D=96 V=264 vocab_size=260": (1, 96, 264, 260, 0.0,
                                               "bfloat16", "rows"),
    }


def tied_inputs(torch, gen, N, D, V, masked, dtype, layout="rows"):
    """h (N, D), the tied head's w stored (V, D), labels, gl; with layout
    "h strided" h is every other column of an (N, 2 D) buffer."""
    h = torch.randn((N, D), generator=gen, device="cuda").to(dtype)
    if layout == "h strided":
        buf = torch.zeros((N, 2 * D), dtype=dtype, device="cuda")
        buf[:, ::2] = h
        h = buf[:, ::2]
    w = (torch.randn((V, D), generator=gen, device="cuda")
         / D ** 0.5).to(dtype)
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
    drop = torch.rand((N,), generator=gen, device="cuda") < masked
    labels = torch.where(drop, -1, labels)
    gl = torch.rand((N,), generator=gen, device="cuda")
    return h, w, labels, gl


def phase_xent_tied_kernels(torch, gen):
    """Phase 2: the three xent kernels with ``transposed=True`` (w the
    tied head as stored, (V, D)) against their plain versions, each run
    twice (bitwise equal), every call counted on the tied head's own route
    (``wgmma_t``/``mma_t`` on aligned bf16, ``fma_t`` else); dW (V, D)
    with zero padded rows. -> {(kernel, case): max abs error}."""
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    errs = {}
    for cname, (N, D, V, vs, masked, dt, layout) in tied_cases().items():
        dtype = getattr(torch, dt)
        h, w, labels, gl = tied_inputs(torch, gen, N, D, V, masked, dtype,
                                       layout)
        tc = X.mma_layout(h, w, transposed=True)
        if tc != (dt == "bfloat16" and layout == "rows" and D % 16 == 0):
            raise AssertionError(f"xent: unexpected route for {cname}")
        fwd_route, bwd_route = ("wgmma_t", "mma_t") if tc else ("fma_t",
                                                                "fma_t")

        def fwd():
            return torch.stack(X.xent_fwd(h, w, labels, vocab_size=vs,
                                          transposed=True))
        got = _on_route(X.xent_fwd, fwd_route, fwd)
        want_lse, want_ll = XR.xent_fwd_ref(h, w, labels, vocab_size=vs,
                                            transposed=True)
        e_f = 0.0
        for g, want in zip(got, (want_lse, want_ll)):
            d = (g - want).abs()
            if not (bool(torch.isfinite(g).all()) and bool(
                    (d <= XENT_LSE_ATOL + XENT_LSE_RTOL * want.abs()).all())):
                raise AssertionError(f"xent_fwd (transposed) disagrees with "
                                     f"the plain version: {cname}")
            e_f = max(e_f, d.max().item())
        bad = (labels < 0) | (labels >= vs)
        if not bool((got[1][bad] == 0).all()):
            raise AssertionError(f"xent_fwd: ll of a masked label is not 0: "
                                 f"{cname}")
        _bitwise_again(torch, "xent_fwd", got,
                       _on_route(X.xent_fwd, fwd_route, fwd), cname)
        errs[("xent_fwd", cname)] = e_f
        msg = [f"fwd {fwd_route} {e_f:.2e}"]
        for name, fn, ref in (("xent_bwd_dh", X.xent_bwd_dh,
                               XR.xent_bwd_dh_ref),
                              ("xent_bwd_dw", X.xent_bwd_dw,
                               XR.xent_bwd_dw_ref)):
            e, r = 0.0, {}
            for out_dtype in (dtype, torch.float32)[:1 + (
                    dtype != torch.float32)]:
                otag = str(out_dtype).replace("torch.", "")
                kw = {"vocab_size": vs, "out_dtype": out_dtype,
                      "transposed": True}

                def call(fn=fn, kw=kw):
                    return fn(h, w, labels, want_lse, gl, **kw)
                g = _on_route(fn, bwd_route, call)
                want = ref(h, w, labels, want_lse, gl, **kw)
                shape = h.shape if name == "xent_bwd_dh" else w.shape
                if g.dtype != out_dtype or g.shape != shape:
                    raise AssertionError(f"{name}: {g.dtype} "
                                         f"{tuple(g.shape)}: {cname}")
                e1, r[otag] = _grad_check(torch, f"{name} (transposed)", g,
                                          want, out_dtype, cname)
                e = max(e, e1)
                _bitwise_again(torch, name, g, _on_route(fn, bwd_route, call),
                               cname)
                if name == "xent_bwd_dw" and not bool((g[vs:] == 0).all()):
                    raise AssertionError(f"xent_bwd_dw: padded rows not 0: "
                                         f"{cname}")
                del g, want
            errs[(name, cname)] = e
            ratios = ", ".join(f"{k} out {v:.3f}" for k, v in r.items())
            msg.append(f"{name[5:]} {bwd_route} {e:.2e} (err/tol {ratios})")
        torch.cuda.synchronize()
        print(f"  xent {cname} {dt}: max err {'; '.join(msg)} (the untied "
              f"cases' tolerances); bitwise repeatable; dW (V, D)")
        del h, w, labels, gl, got, want_lse, want_ll
    return errs


def xent_tied_timing(torch, gen, power, errs):
    """Phase 4, the transposed kernels (bf16) at llama-1b's and gemma-2b's
    tied loss shapes: CUDA events and device time (every kernel of the
    call), the bound (the same work as the untied kernels'), the plain
    version, the untied kernel at the same shape on a (D, V) copy of w, and
    the library call: torch.matmul(h, w.T) + F.cross_entropy for the
    forward, that pair's autograd backward (dh and dw together, from saved
    logits) for the backward. -> one row per kernel, llama-1b's numbers on
    top and both shapes under "shapes"."""
    import torch.nn.functional as F
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    shapes = {"llama-1b tied": ((4096, 2048, 32000), "tied llama-1b N=4096"),
              "gemma-2b tied": ((4096, 2048, 256000),
                                "tied gemma-2b N=4096 V=256000")}
    notes = {"fwd": "torch.matmul(h, w.T) + F.cross_entropy",
             "bwd": ("autograd of matmul(h, w.T) + cross_entropy (dh and dw "
                     "together, from saved logits)")}
    bf = torch.bfloat16
    rows = {name: [] for name in XENT_KERNELS}
    for model, ((N, D, V), err_case) in shapes.items():
        h, w, labels, _ = tied_inputs(torch, gen, N, D, V, 0.0, bf)
        w_dv = w.T.contiguous()
        lse, _ = X.xent_fwd(h, w, labels, vocab_size=V, transposed=True)
        gl = torch.full((N,), 1.0 / N, device="cuda")
        hl, wl = h.detach().requires_grad_(), w.detach().requires_grad_()
        lib_loss = F.cross_entropy((hl @ wl.T).float(), labels.long(),
                                   reduction="mean")

        def lib_fwd():
            return F.cross_entropy((h @ w.T).float(), labels.long(),
                                   reduction="none")

        def lib_bwd():
            return torch.autograd.grad(lib_loss, [hl, wl], retain_graph=True)
        libs = {k: (time_ms(torch, f, 10), device_ms(torch, f, 3))
                for k, f in (("fwd", lib_fwd), ("bwd", lib_bwd))}
        del lib_loss
        for name in XENT_KERNELS:
            fn = getattr(X, name)
            ref = getattr(XR, f"{name}_ref")
            a = (h, w, labels) if name == "xent_fwd" else (h, w, labels, lse,
                                                           gl)
            kw = {} if name == "xent_fwd" else {"out_dtype": bf}

            def kern(a=a, kw=kw, fn=fn):
                return fn(*a, vocab_size=V, transposed=True, **kw)

            def untied(a=a, kw=kw, fn=fn):
                return fn(h, w_dv, *a[2:], vocab_size=V, **kw)
            ms = time_ms(torch, kern, 5)
            dev_ms = device_ms(torch, kern, 5)
            untied_ms = time_ms(torch, untied, 5)
            untied_dev = device_ms(torch, untied, 5)
            plain_ms = time_ms(torch, lambda: ref(*a, vocab_size=V,
                                                  transposed=True, **kw), 3)
            bound, by = xent_bound_ms(N, D, V, 2, name)
            lib = "fwd" if name == "xent_fwd" else "bwd"
            lib_ms, lib_dev = libs[lib]
            print(f"  [{power}] {name} transposed {model} N={N} D={D} V={V} "
                  f"bf16, {TIED_ROUTES[name]}: {ms:.4f} ms (device time "
                  f"{fmt_ms(dev_ms)}; bound {bound:.4f} ms by {by}, "
                  f"{bound / ms:.4f} of it; the untied kernel on a (D, V) "
                  f"copy {untied_ms:.4f} ms, device time {fmt_ms(untied_dev)};"
                  f" plain {plain_ms:.4f} ms; {notes[lib]} {lib_ms:.4f} ms, "
                  f"device time {fmt_ms(lib_dev)})")
            rows[name].append({
                "name": TIED_ROWS[name],
                "shape": f"{model}: N={N} D={D} V={V} bf16, w (V, D)",
                "route": "cuda", "kernel_route": TIED_ROUTES[name],
                "source": SRC_XENT,
                "sources": [SRC_XENT] + ([SRC_HOPPER]
                                         if name == "xent_fwd" else []),
                "replaces": TPU_KERNELS[name], "launches": None,
                "max_abs_err": errs[(name, err_case)],
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "library_device_ms": lib_dev, "library_note": notes[lib],
                "untied_ms": untied_ms, "untied_device_ms": untied_dev})
        del h, w, w_dv, labels, lse, gl, hl, wl
        torch.cuda.empty_cache()
    out = []
    for name in XENT_KERNELS:
        row = {k: v for k, v in rows[name][0].items() if k != "shape"}
        row["shapes"] = rows[name]
        out.append(row)
    return out


def train_tied_model(torch, seed, power, arch):
    """One model of phase 12, tied (``--tie-embeddings``), at full width
    and depth: the launcher for two steps; one loss-and-grad against the
    same call with the plain xent versions swapped into dispatch; then
    ``make_train_step`` (scale_fused under ``LabelRules.tied()``) for
    TIED_STEPS steps, the main path (counts from 0 just before, read just
    after, every step's launches by route checked); one step under
    ``set_sync_debug_mode("error")``; step time, tokens/s, device busy time
    by kernel family, idle share, peak memory; then the same steps with
    the plain xent versions from the same seeded weights (after the kernel
    route's state is freed), the loss curves held together."""
    import dataclasses
    import math
    from unittest import mock
    from repro_torch.configs import get_arch
    from repro_torch.core import (LabelRules, linear_warmup_cosine,
                                  make_optimizer)
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.launch import train as launcher
    from repro_torch.models import forward, init_params, lm_loss
    from repro_torch.models.model import count_params, param_shapes
    from repro_torch.training import (init_state, make_train_step,
                                      value_and_grad)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    cfg = dataclasses.replace(get_arch(arch), tie_embeddings=True)
    B, S = 16, 256
    L = cfg.n_layers
    n_params = count_params(param_shapes(cfg))
    print(f"  {arch} tied: {L} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, the LM head the (V, D) token embedding, "
          f"{n_params / 1e9:.3f} G params, {cfg.dtype}, remat "
          f"{cfg.remat!r}; batch {B} x {S} from SyntheticLM (seed {seed}); "
          f"scale_fused with LabelRules.tied(), clip 1.0, "
          f"linear_warmup_cosine(1e-3, steps)")
    argv = ["--arch", arch, "--tie-embeddings", "--optimizer", "scale_fused",
            "--batch", str(B), "--seq", str(S), "--steps", "2",
            "--log-every", "1", "--seed", str(seed)]
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}:")
    t0 = time.perf_counter()
    final = launcher.main(argv)
    print(f"  launcher: 2 steps in {time.perf_counter() - t0:.1f} s (init "
          f"and first-call costs included), final loss {final:.4f}")
    if not math.isfinite(final):
        raise AssertionError(f"{arch} tied: the launcher's loss is not "
                             "finite")
    torch.cuda.empty_cache()
    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(TIED_STEPS)]
    plain_xent = mock.patch.multiple(dispatch, xent_fwd=XR.xent_fwd_ref,
                                     xent_bwd_dh=XR.xent_bwd_dh_ref,
                                     xent_bwd_dw=XR.xent_bwd_dw_ref)

    def start():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tx = make_optimizer("scale_fused",
                            linear_warmup_cosine(1e-3, TIED_STEPS),
                            rules=LabelRules.tied())
        return (init_state(init_params(cfg, gen, device="cuda"), tx),
                make_train_step(cfg, tx, clip_norm=1.0))

    state, step = start()
    if "lm_head" in state.params:
        raise AssertionError(f"{arch} tied: the tree has an lm_head")
    batch = batches[0]
    # the head alone, on one hidden: its dH and the embedding's dW
    with torch.no_grad():
        hidden = forward(state.params, cfg, batch["tokens"])[0]

    def head_grads():
        w = state.params["tok_embed"]["w"].detach().requires_grad_()
        h = hidden.detach().requires_grad_()
        loss, _ = lm_loss({**state.params, "tok_embed": {"w": w}}, cfg, h,
                          batch["labels"])
        return torch.autograd.grad(loss, [h, w])
    got = head_grads()
    with plain_xent:
        want = head_grads()
    e_head = [_grad_check(torch, f"{arch} tied {n}", a, b, torch.bfloat16,
                          "phase 12")[1]
              for n, a, b in zip(("dH", "dW"), got, want)]
    del hidden, got, want
    # the whole gradient, bf16 at full depth and f32 at 4 layers
    loss_k, _, g = value_and_grad(state.params, cfg, batch)
    with plain_xent:
        loss_p, _, r = value_and_grad(state.params, cfg, batch)
    d_loss = abs(loss_k.item() - loss_p.item())
    rel = {k: ((x.float() - r[k].float()).norm()
               / r[k].float().norm().clamp_min(1e-30)).item()
           for k, x in g.items()}
    worst_k = max(rel, key=rel.get)
    del g, r
    cfg4 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    p4 = init_params(cfg4, torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda")
    zero_route_counts()
    _, _, g4 = value_and_grad(p4, cfg4, batch)
    f32_routes = {k: {r: n for r, n in c.items() if n}
                  for k, c in route_counts().items() if k in XENT_KERNELS}
    with plain_xent:
        _, _, r4 = value_and_grad(p4, cfg4, batch)
    rel4 = {k: ((x - r4[k]).abs().max()
                / r4[k].abs().max().clamp_min(1e-30)).item()
            for k, x in g4.items()}
    worst4 = max(rel4, key=rel4.get)
    del p4, g4, r4
    print(f"  {arch} tied loss-and-grad against the plain xent versions: "
          f"the head on one hidden, dH and dW err/tol {e_head[0]:.3f} and "
          f"{e_head[1]:.3f} (phase 2's tolerances); loss {loss_k.item():.6f}"
          f" vs {loss_p.item():.6f} (|diff| {d_loss:.2e}, tol "
          f"{LOSS_ATOL:g}); bf16 at full depth, relative in norm: "
          f"tok_embed (the lookup's plus the head's) {rel['tok_embed/w']:.3e},"
          f" worst of {len(rel)} leaves {rel[worst_k]:.3e} ({worst_k}; tol "
          f"{TRAIN_GRAD_BF16:g}); f32 at 4 layers (xent routes "
          f"{f32_routes}), max |diff| / max |ref|: tok_embed "
          f"{rel4['tok_embed/w']:.3e}, worst {rel4[worst4]:.3e} ({worst4}; "
          f"tol {TRAIN_GRAD_F32:g})")
    if not (d_loss <= LOSS_ATOL and rel[worst_k] <= TRAIN_GRAD_BF16
            and rel4[worst4] <= TRAIN_GRAD_F32
            and all(c == {"fma_t": 1} for c in f32_routes.values())):
        raise AssertionError(f"{arch} tied: the gradient disagrees with the "
                             "plain xent versions")
    torch.cuda.empty_cache()

    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    zero_route_counts()
    per_step, per_step_routes, losses = [], [], []
    for b in batches:
        before, before_r = train_counts(), route_counts()
        state, metrics = step(state, b)
        per_step.append({k: v - before[k] for k, v in train_counts().items()})
        per_step_routes.append({k: {r: n - before_r[k][r]
                                    for r, n in c.items()}
                                for k, c in route_counts().items()})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches, routes = train_counts(), route_counts()
    # the tied embedding takes the momentum branch: 7 hidden matrices
    # normalized, 8 updates, one momentum
    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 7, "update_apply": 8, "momentum_sumsq": 1,
            "norm_apply": 0}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"{arch} tied train step {i} launched {c}, "
                                 f"not {want}")
    attn = "mma" if cfg.head_dim in (64, 128) else "fma"
    want_r = {"mha_fwd": {attn: 2 * L}, **{k: {attn: L} for k in BWD_KERNELS},
              **{k: {r: 1} for k, r in TIED_ROUTES.items()},
              "update_apply": {"vec": 8}}
    for i, c in enumerate(per_step_routes):
        check_routes(c, want_r, f"{arch} tied train step {i}", show=False)
    print(f"  {arch} tied make_train_step: every one of {TIED_STEPS} steps "
          f"launched {want}, by route {want_r} (no launch on an untied xent "
          f"route)")
    losses = [float(x) for x in losses]

    # one step with any host synchronisation an error
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"  {arch} tied train step under set_sync_debug_mode('error'): no "
          f"host synchronisation")

    def one():
        nonlocal state
        state, _ = step(state, batches[0])

    t_step = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        t_step.append(time.perf_counter() - t0)
    step_s = min(t_step)
    print(f"  [{power}] {arch} tied train step {step_s * 1e3:.3f} ms (best of "
          f"3; {B * S / step_s:.0f} tokens/s); torch.cuda.max_memory_allocated "
          f"over its {TIED_STEPS} main-path steps {peak / 2**20:.1f} MiB")
    busy, kernels = profile_step(torch, power, one, step_s * 1e3, n=1,
                                 label=f"{arch} tied train step", top=8)
    fams = by_family(kernels)
    for fam, (ms, n) in sorted(fams.items(), key=lambda x: -x[1][0]):
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<5d} {fam}")
    del state, step
    torch.cuda.empty_cache()

    # the same steps with the plain xent versions, from the same weights
    state, step = start()
    with plain_xent:
        ref_losses = []
        for b in batches:
            state, m = step(state, b)
            ref_losses.append(float(m["loss"]))
    del state, step
    torch.cuda.empty_cache()
    gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
    print(f"  {arch} tied loss over {TIED_STEPS} steps: "
          f"{' '.join(f'{x:.4f}' for x in losses)}")
    print(f"  {arch} tied, plain xent versions:     "
          f"{' '.join(f'{x:.4f}' for x in ref_losses)} (max |diff| "
          f"{gap:.2e}, tol {LOSS_CURVE_ATOL:g})")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and gap <= LOSS_CURVE_ATOL):
        raise AssertionError(f"{arch} tied: the training loss does not fall, "
                             "or leaves the plain xent route's curve")
    return {"launches": launches, "routes_run": routes,
            "per_step": per_step[0], "routes": per_step_routes[0],
            "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
            "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / (step_s * 1e3),
            "peak_mib": peak / 2**20, "losses": losses,
            "ref_losses": ref_losses, "loss_gap": gap,
            "head_err_over_tol": e_head, "grad_rel": rel[worst_k],
            "tok_embed_grad_rel": rel["tok_embed/w"],
            "f32_grad_rel": rel4[worst4],
            "device_ms_by_family": {f: ms for f, (ms, _) in fams.items()}}


def phase_tied(torch, seed, power):
    """Phase 12: llama-1b and gemma-2b train tied at full width and
    depth."""
    return {arch: train_tied_model(torch, seed, power, arch)
            for arch in TIED_MODELS}


# ------------------------------------------------------ packed documents

SEG_ROWS = {k: f"{k} segments" for k in ("mha_fwd", *BWD_KERNELS)}
PACKED_STEPS = 8  # make_train_step steps of phase 13
# Phase 13 (d): the per-token losses of a document, packed against its
# offset-preserving unpacked row, run in chunks of the packed batch's shape.
# Both layouts do each token's arithmetic on the same lanes (attention
# masks the other documents to an exact 0 in both), and cuBLAS is handed
# the same shapes; were it to pick other kernels, a bf16 rounding of a
# hidden apart (2**-8 relative) would move a per-token loss by about that
# times the spread of the logits (about 1 at this init), through 24 layers.
PACKED_DOC_ATOL = 5e-2


def seg_cases():
    # name -> (B, S, T, H, K, hd, hdv, causal, ids): "packed" a real packed
    # SyntheticLM batch's segment_ids (the same for q and kv), "random"
    # unsorted ids in [0, 3], "separate" sorted q and kv ids of their own
    # with q rows 10-12 given an id no key has, "equal" all 1
    return {
        "packed llama-1b train": (16, 256, 256, 32, 32, 64, 64, True,
                                  "packed"),
        "packed llama-7b hd=128": (16, 256, 256, 32, 32, 128, 128, True,
                                   "packed"),
        "packed gqa qwen2-500m H=14 K=2": (8, 512, 512, 14, 2, 64, 64, True,
                                           "packed"),
        "packed gemma-2b H=8 K=1 hd=256": (16, 256, 256, 8, 1, 256, 256,
                                           True, "packed"),
        "packed ragged S=T=250": (8, 250, 250, 12, 12, 64, 64, True,
                                  "packed"),
        "packed hd=64 hdv=128 H=8 K=4 S=T=200": (4, 200, 200, 8, 4, 64, 128,
                                                 True, "packed"),
        "separate S=100 T=300 non-causal": (4, 100, 300, 8, 8, 64, 64, False,
                                            "separate"),
        "separate S=100 T=300 hd=128 gqa": (4, 100, 300, 8, 2, 128, 128,
                                            False, "separate"),
        "separate decode S=3 T=300": (8, 3, 300, 12, 12, 64, 64, False,
                                      "separate"),
        "unsorted S=T=256": (4, 256, 256, 8, 8, 64, 64, True, "random"),
        "unsorted S=T=200 hd=128": (2, 200, 200, 4, 4, 128, 128, True,
                                    "random"),
    }


# all-equal ids against no segments, bitwise, one case per route:
# name -> (B, S, T, H, K, hd, causal, dtype name)
SEG_EQUAL_CASES = {
    "mma hd=64": (16, 256, 256, 32, 32, 64, True, "bfloat16"),
    "mma hd=128 ragged": (4, 200, 200, 8, 8, 128, True, "bfloat16"),
    "fma f32": (4, 256, 256, 8, 4, 64, True, "float32"),
    "fma hd=256 H=8 K=1": (4, 256, 256, 8, 1, 256, True, "bfloat16"),
    "decode S=2 T=300": (8, 2, 300, 12, 12, 64, False, "bfloat16"),
}


def orphan_rows(S):
    """The q rows of a "separate" case whose id no key has."""
    return slice(10, 13) if S > 12 else slice(S - 1, S)


def packed_ids(torch, seed, B, S):
    """segment_ids (B, S) of a packed SyntheticLM batch of llama-1b's
    vocab, on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.data import make_dataset
    ds = make_dataset(get_arch("llama-1b"), S, B, seed=seed,
                      pack_documents=True, device="cuda")
    return ds.global_batch_at(0)["segment_ids"]


def seg_ids(torch, gen, kind, B, S, T, seed):
    """The (q_seg, kv_seg) pair of a seg_cases kind, int32 on the card."""
    if kind == "packed":
        ids = packed_ids(torch, seed, B, S)
        return ids, ids
    if kind == "equal":
        return (torch.ones((B, S), dtype=torch.int32, device="cuda"),
                torch.ones((B, T), dtype=torch.int32, device="cuda"))
    if kind == "random":
        ids = torch.randint(0, 4, (B, S), generator=gen, device="cuda",
                            dtype=torch.int32)
        return ids, ids
    qs = torch.randint(1, 5, (B, S), generator=gen, device="cuda",
                       dtype=torch.int32).sort(1).values
    ks = torch.randint(1, 5, (B, T), generator=gen, device="cuda",
                       dtype=torch.int32).sort(1).values
    qs[:, orphan_rows(S)] = 7
    return qs.contiguous(), ks


def seg_counts():
    """{wrapper: launches with segments} of the three attention wrappers."""
    from repro_torch.kernels.attention import attention as A
    return {k: getattr(A, k).segment_launches for k in SEG_ROWS}


def zero_seg_counts():
    from repro_torch.kernels.attention import attention as A
    for k in SEG_ROWS:
        getattr(A, k).segment_launches = 0


def _seg_bwd_inputs(torch, gen, B, S, T, H, K, hd, hdv, causal, segs, dtype):
    """(q, k, v, dout, lse, delta, None) with lse and delta from the plain
    forward under the segment clause."""
    from repro_torch.kernels.attention.ref import mha_fwd_ref

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v, do = rnd(B, S, H, hd), rnd(B, T, K, hd), rnd(B, T, K, hdv), \
        rnd(B, S, H, hdv)
    out, lse = mha_fwd_ref(q, k, v, scale=hd ** -0.5, causal=causal,
                           segments=segs)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, None


def phase_segment_kernels(torch, gen, seed):
    """Phase 2, the segment clause: the three attention kernels with
    segment ids against their plain versions under the dense mask, on the
    route their wrappers pick (counted, and counted in
    ``segment_launches``), bf16 and f32, each run twice (bitwise equal);
    at the packed train shape in bf16 also the fma kernels, which the mma
    route takes it from. A query whose id no key has gives 0 and an lse of
    about -1e30, a dQ of 0, and adds nothing to dK and dV (its dO changed,
    they are bitwise the same). All-equal ids give bitwise the
    no-segment result on every route. -> {(kernel, case, dtype[, forced
    route]): max abs error}."""
    from repro_torch.kernels.attention.attention import (
        _bwd_route, _fwd_route, _launch_fwd, mha_bwd_dkv, mha_bwd_dq,
        mha_fwd)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref,
                                                   mha_fwd_ref)
    errs = {}
    cases = [(name, shape, dtype, None) for name, shape in seg_cases().items()
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append(("packed llama-1b train", seg_cases()["packed llama-1b train"],
                  torch.bfloat16, "fma"))
    for name, (B, S, T, H, K, hd, hdv, causal, kind), dtype, forced in cases:
        tag = str(dtype).replace("torch.", "")
        key = f"{name} {tag}" + (f" (forced {forced})" if forced else "")
        segs = seg_ids(torch, gen, kind, B, S, T, seed)
        args = _seg_bwd_inputs(torch, gen, B, S, T, H, K, hd, hdv, causal,
                               segs, dtype)
        q, k, v = args[:3]
        kw = dict(scale=hd ** -0.5, causal=causal, segments=segs)
        froute = forced or _fwd_route(q, k, v)
        broute = forced or _bwd_route(q, k, v)

        def run():
            if forced:
                o, l = _launch_fwd(forced, q, k, v, None, kw["scale"], causal,
                                   segs)
                return (o, l, bwd_fma(torch, "mha_bwd_dq", args, kw),
                        *bwd_fma(torch, "mha_bwd_dkv", args, kw))
            o, l = mha_fwd(q, k, v, **kw)
            return (o, l, mha_bwd_dq(*args, **kw), *mha_bwd_dkv(*args, **kw))
        before, before_s = route_counts(), seg_counts()
        out, lse, dq, dk, dv = run()
        torch.cuda.synchronize()
        after, after_s = route_counts(), seg_counts()
        if not forced:
            want = {k_: dict(c) for k_, c in before.items()}
            want["mha_fwd"][froute] += 1
            for k_ in BWD_KERNELS:
                want[k_][broute] += 1
            if after != want or after_s != {k_: n + 1 for k_, n in
                                           before_s.items()}:
                raise AssertionError(f"segments {key}: routes {before} -> "
                                     f"{after}, segment launches {before_s} "
                                     f"-> {after_s}")
        ref, ref_lse = mha_fwd_ref(q, k, v, **kw)
        atol, rtol = ((F32_OUT_ATOL, 0.0) if dtype == torch.float32
                      else (BF16_OUT_ATOL, BF16_OUT_RTOL))
        d = (out.float() - ref.float()).abs()
        tol = atol + rtol * ref.float().abs()
        rows = ref_lse > -1e29  # rows with at least one valid key
        dl = (lse - ref_lse).abs()[rows]
        ltol = LSE_ATOL + LSE_RTOL * ref_lse[rows].abs()
        ok = (bool((d <= tol).all()) and bool((dl <= ltol).all())
              and bool(torch.isfinite(out.float()).all())
              and bool((lse[~rows] <= -1e29).all()))
        if not ok:
            raise AssertionError(f"mha_fwd with segments disagrees with the "
                                 f"plain version: {key}")
        e_out, r_out = d.max().item(), (d / tol).max().item()
        r_lse = (dl / ltol).max().item() if dl.numel() else 0.0
        e_q, r_q, _ = _bwd_check(torch, "mha_bwd_dq", dq,
                                 mha_bwd_dq_ref(*args, **kw), tag, key)
        want_k, want_v = mha_bwd_dkv_ref(*args, **kw)
        e_k, r_k, _ = _bwd_check(torch, "mha_bwd_dkv dK", dk, want_k, tag, key)
        e_v, r_v, _ = _bwd_check(torch, "mha_bwd_dkv dV", dv, want_v, tag, key)
        del want_k, want_v, ref
        again = run()
        for nm, a, b in zip(("out", "lse", "dQ", "dK", "dV"),
                            (out, lse, dq, dk, dv), again):
            _bitwise_again(torch, f"segments {nm}", a, b, key)
        orphan = ""
        if kind == "separate":
            orows = orphan_rows(S)
            if not (bool((out[:, orows] == 0).all())
                    and bool((lse[..., orows] <= -1e29).all())
                    and bool((dq[:, orows] == 0).all())):
                raise AssertionError(f"segments {key}: a row whose id no key "
                                     "has is not 0 (out, lse or dQ)")
            do2 = args[3].clone()
            do2[:, orows] = 3 * do2[:, orows] + 1
            args2 = (*args[:3], do2, *args[4:])
            dk2, dv2 = (bwd_fma(torch, "mha_bwd_dkv", args2, kw) if forced
                        else mha_bwd_dkv(*args2, **kw))
            if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                raise AssertionError(f"segments {key}: the orphan rows' dO "
                                     "moved dK or dV")
            orphan = "; orphan rows: out 0, lse -1e30, dQ 0, dK/dV unmoved"
        ek = (name, tag) if not forced else (name, tag, forced)
        errs[("mha_fwd", *ek)] = e_out
        errs[("mha_bwd_dq", *ek)] = e_q
        errs[("mha_bwd_dkv", *ek)] = max(e_k, e_v)
        print(f"  {key:44s} fwd {froute:6s} out err {e_out:.3e} (err/tol "
              f"{r_out:.3f}, lse {r_lse:.3f}); bwd {broute} dQ {e_q:.3e}, dK "
              f"{e_k:.3e}, dV {e_v:.3e} (err/tol {r_q:.3f}, {r_k:.3f}, "
              f"{r_v:.3f}); bitwise repeatable{orphan}")
        del args, q, k, v, out, lse, dq, dk, dv, again
    # all-equal ids: bitwise the kernels' no-segment result
    for name, (B, S, T, H, K, hd, causal, dt) in SEG_EQUAL_CASES.items():
        dtype = getattr(torch, dt)
        segs = seg_ids(torch, gen, "equal", B, S, T, seed)
        args = _seg_bwd_inputs(torch, gen, B, S, T, H, K, hd, hd, causal,
                               None, dtype)
        q, k, v = args[:3]
        outs = []
        for sg in (None, segs):
            kw = dict(scale=hd ** -0.5, causal=causal, segments=sg)
            outs.append((*mha_fwd(q, k, v, **kw), mha_bwd_dq(*args, **kw),
                         *mha_bwd_dkv(*args, **kw)))
        torch.cuda.synchronize()
        for nm, a, b in zip(("out", "lse", "dQ", "dK", "dV"), *outs):
            if not torch.equal(a, b):
                raise AssertionError(f"all-equal ids, {name}: {nm} differs "
                                     "from the no-segment result")
        print(f"  all-equal ids, {name} ({dt}; fwd {_fwd_route(q, k, v)}, bwd "
              f"{_bwd_route(q, k, v)}): out, lse, dQ, dK, dV bitwise the "
              "no-segment result")
        del args, outs
    print(f"  segment launches so far: {seg_counts()}")
    return errs


def seg_tile_share(torch, ids, causal=True, tile=64):
    """(tile pairs the segment skip removes, tile pairs the causal clause
    leaves) of the mma kernels' 64 x 64 tiling at ``ids`` (B, S), q and kv
    ids the same: a pair runs only if its id ranges overlap."""
    B, S = ids.shape
    n = (S + tile - 1) // tile
    pad = torch.nn.functional.pad(ids, (0, n * tile - S), value=0)
    valid = torch.arange(n * tile, device=ids.device) < S
    t = pad.view(B, n, tile)
    v = valid.view(n, tile)
    lo = torch.where(v, t, torch.iinfo(torch.int32).max).amin(-1)
    hi = torch.where(v, t, torch.iinfo(torch.int32).min).amax(-1)
    i = torch.arange(n, device=ids.device)
    live = (i[:, None] >= i[None, :]) if causal else torch.ones(
        n, n, dtype=torch.bool, device=ids.device)
    overlap = (lo[:, :, None] <= hi[:, None, :]) & (lo[:, None, :]
                                                    <= hi[:, :, None])
    total = int(live.sum()) * B
    return total - int((overlap & live).sum()), total


def seg_bound_ms(kernel, B, S, H, K, hd, pairs, el_bytes):
    """Least time of an attention kernel with segments over ``pairs``
    valid (query, key) pairs of every head (what this batch's ids leave):
    max(bytes once / HBM rate, FLOPs / bf16 peak). The forward reads q, k,
    v and both ids and writes out and lse (two products a pair); dQ reads
    q, k, v, dO, lse, delta and the ids and writes dQ (three); dK, dV the
    same, writing dK and dV (four)."""
    q_el, kv_el = B * S * H * hd, B * S * K * hd
    ids = 4 * 2 * B * S
    if kernel == "mha_fwd":
        flops = 4 * hd * pairs * H
        nbytes = el_bytes * (2 * q_el + 2 * kv_el) + 4 * B * H * S + ids
    else:
        flops = (3 if kernel == "mha_bwd_dq" else 4) * 2 * hd * pairs * H
        nbytes = (el_bytes * (2 * q_el + 2 * kv_el) + 2 * 4 * B * H * S
                  + ids + el_bytes * (q_el if kernel == "mha_bwd_dq"
                                      else 2 * kv_el))
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def seg_timing(torch, gen, power, errs, seed):
    """Phase 4, the segment clause at the packed train shape (llama-1b's
    packed batch: B=16, S=T=256, 32 heads of 64, causal, bf16, the mma
    route): each kernel with segments, in turns with the same kernel
    without them and the plain version (with them), by CUDA events and
    device time; the library call is F.scaled_dot_product_attention with
    the dense (B, 1, S, T) boolean mask (causal and same id), for the
    backward its autograd (dQ, dK, dV together). The bound counts the
    valid pairs this batch's ids leave; the skip share is that of the
    kernels' 64 x 64 tile pairs. -> one row per kernel ("... segments")."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention.attention import (mha_bwd_dkv,
                                                         mha_bwd_dq, mha_fwd)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref,
                                                   mha_fwd_ref)
    B, S, H, K, hd = 16, 256, 32, 32, 64
    ids = packed_ids(torch, seed, B, S)
    segs = (ids, ids)
    args = _seg_bwd_inputs(torch, gen, B, S, S, H, K, hd, hd, True, segs,
                           torch.bfloat16)
    q, k, v, do = args[:4]
    causal = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    mask = (causal & (ids[:, :, None] == ids[:, None, :]))[:, None]
    pairs = int(mask.sum())
    skipped, total = seg_tile_share(torch, ids)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    scale = hd ** -0.5

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=scale)
    with torch.no_grad():
        lib_fwd = (time_ms(torch, sdpa, 20), device_ms(torch, sdpa, 10))
    o = sdpa()

    def sdpa_bwd():
        return torch.autograd.grad(o, [qt, kt, vt], dot, retain_graph=True)
    lib_bwd = (time_ms(torch, sdpa_bwd, 20), device_ms(torch, sdpa_bwd, 10))
    kw = dict(scale=scale, causal=True)
    calls = {
        "mha_fwd": (lambda sg: mha_fwd(q, k, v, segments=sg, **kw),
                    lambda: mha_fwd_ref(q, k, v, segments=segs, **kw),
                    lib_fwd, "F.scaled_dot_product_attention, (B, 1, S, T) "
                    "boolean mask"),
        "mha_bwd_dq": (lambda sg: mha_bwd_dq(*args, segments=sg, **kw),
                       lambda: mha_bwd_dq_ref(*args, segments=segs, **kw),
                       lib_bwd, "backward of F.scaled_dot_product_attention "
                       "with the mask (dQ, dK, dV together)"),
        "mha_bwd_dkv": (lambda sg: mha_bwd_dkv(*args, segments=sg, **kw),
                        lambda: mha_bwd_dkv_ref(*args, segments=segs, **kw),
                        lib_bwd, "backward of "
                        "F.scaled_dot_product_attention with the mask (dQ, "
                        "dK, dV together)"),
    }
    rows = []
    for name, (call, plain, (lib_ms, lib_dev), note) in calls.items():
        # in turns: with, without, without, with
        t = {"seg": [], "none": []}
        d = {"seg": [], "none": []}
        for which in ("seg", "none", "none", "seg"):
            sg = segs if which == "seg" else None
            t[which].append(time_ms(torch, lambda: call(sg), 20))
            d[which].append(device_ms(torch, lambda: call(sg), 10, name))
        plain_ms = time_ms(torch, plain, 5)
        bound, by = seg_bound_ms(name, B, S, H, K, hd, pairs, 2)
        ms, dev = min(t["seg"]), min(x for x in d["seg"] if x) if any(
            d["seg"]) else None
        ms0, dev0 = min(t["none"]), min(x for x in d["none"] if x) if any(
            d["none"]) else None
        print(f"  [{power}] {name} with segments, packed train B={B} S={S} "
              f"H={H} hd={hd} causal bf16, mma route: {ms:.4f} ms (device "
              f"time {fmt_ms(dev)}; runs {', '.join(f'{x:.4f}' for x in t['seg'])}"
              f"); without segments {ms0:.4f} ms (device time {fmt_ms(dev0)};"
              f" runs {', '.join(f'{x:.4f}' for x in t['none'])}); bound "
              f"{bound:.4f} ms by {by} ({pairs} valid pairs a head, of "
              f"{B * S * (S + 1) // 2} causal); plain {plain_ms:.4f} ms; "
              f"{note} {lib_ms:.4f} ms, device time {fmt_ms(lib_dev)}; "
              f"tile pairs the skip removes {skipped} of {total} "
              f"({skipped / total:.3f})")
        rows.append({
            "name": SEG_ROWS[name], "route": "cuda", "kernel_route": "mma",
            "shape": f"packed train: B={B} S={S} T={S} H={H} K={K} hd={hd} "
                     "causal bf16, llama-1b's packed segment ids",
            "source": SRC_MHA if name == "mha_fwd" else SRC_MHA_BWD,
            "replaces": TPU_MHA if name == "mha_fwd" else TPU_KERNELS[name],
            "launches": None,
            "max_abs_err": errs[(name, "packed llama-1b train", "bfloat16")],
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "library_note": note,
            "no_segments_ms": ms0, "no_segments_device_ms": dev0,
            "valid_pairs_per_head": pairs,
            "tile_pairs_skipped": skipped, "tile_pairs_causal": total})
    del args, q, k, v, do, qt, kt, vt, o, dot, mask
    return rows



def _per_token_losses(torch, params, cfg, batch):
    """(B, S) per-token losses of ``batch`` (its loss weights applied),
    through the kernels, with no autograd."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import forward
    with torch.no_grad():
        h = forward(params, cfg, batch["tokens"],
                    positions=batch["positions"],
                    segment_ids=batch["segment_ids"])[0]
        return dispatch.xent_loss(h, params["lm_head"]["w"], batch["labels"],
                                  vocab_size=cfg.vocab_size,
                                  weights=batch["loss_weights"])


def phase_packed(torch, seed, power, unpacked):
    """Phase 13: packed-document training of llama-1b at full width and
    depth (``--pack-documents``; 16 x 256 packed batches): (a) the launcher
    for two steps; (b) one loss-and-grad against the same call with the
    plain attention swapped into dispatch, every leaf; (c) make_train_step
    for PACKED_STEPS steps, the main path (counts from 0 just before, read
    just after, every step's launches by route and with segments checked);
    (d) each document's per-token losses against its offset-preserving
    unpacked row; (e) document 1 of a row perturbed: every other
    document's per-token losses bitwise unchanged; (f) one step under
    set_sync_debug_mode("error"); (g) step time, tokens/s in real tokens,
    device busy time by kernel family, idle share, peak memory, beside
    phase 8's unpacked step; then the same steps through the plain
    attention from the same seeded weights, the loss curves held
    together."""
    import math
    from unittest import mock
    from repro_torch.configs import get_arch
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset, unpack_to_rows
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.launch import train as launcher
    from repro_torch.models import init_params
    from repro_torch.training import (init_state, make_train_step,
                                      value_and_grad)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    t_phase = time.perf_counter()
    cfg = get_arch("llama-1b")
    B, S = 16, 256
    L = cfg.n_layers
    ds = make_dataset(cfg, S, B, seed=seed, pack_documents=True,
                      device="cuda")
    batches = [ds.global_batch_at(i) for i in range(PACKED_STEPS)]
    real = [int(b["loss_weights"].sum()) for b in batches]
    docs = [int((b["segment_ids"].amax(1)).sum()) for b in batches]
    pad = [float((b["segment_ids"] == 0).float().mean()) for b in batches]
    print(f"  llama-1b packed: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, {cfg.dtype}, remat "
          f"{cfg.remat!r}; {B} x {S} packed SyntheticLM batches (seed {seed}; "
          f"documents uniform in [8, {S}], first-fit): per batch "
          f"{docs} documents, pad share {' '.join(f'{x:.3f}' for x in pad)}, "
          f"real tokens (the loss's weight) {real}; scale_fused, clip 1.0, "
          f"linear_warmup_cosine(1e-3, steps)")
    argv = ["--arch", "llama-1b", "--pack-documents", "--optimizer",
            "scale_fused", "--batch", str(B), "--seq", str(S), "--steps", "2",
            "--log-every", "1", "--seed", str(seed)]
    print(f"  (a) python -m repro_torch.launch.train {' '.join(argv)}:")
    t0 = time.perf_counter()
    final = launcher.main(argv)
    print(f"  launcher: 2 steps in {time.perf_counter() - t0:.1f} s (init "
          f"and first-call costs included), final loss {final:.4f}")
    if not math.isfinite(final):
        raise AssertionError("packed: the launcher's loss is not finite")
    torch.cuda.empty_cache()
    plain_attn = mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref)

    def start():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tx = make_optimizer("scale_fused",
                            linear_warmup_cosine(1e-3, PACKED_STEPS))
        return (init_state(init_params(cfg, gen, device="cuda"), tx),
                make_train_step(cfg, tx, clip_norm=1.0))

    state, step = start()
    batch = batches[0]
    # (b) one loss-and-grad against the plain attention, every leaf
    loss_k, _, g = value_and_grad(state.params, cfg, batch)
    with plain_attn:
        loss_p, _, r = value_and_grad(state.params, cfg, batch)
    rel = {k: ((x.float() - r[k].float()).norm()
               / r[k].float().norm().clamp_min(1e-30)).item()
           for k, x in g.items()}
    worst = max(rel, key=rel.get)
    d_loss = abs(loss_k.item() - loss_p.item())
    del g, r
    print(f"  (b) loss-and-grad against the plain attention (mha_fwd_ref "
          f"autograd): loss {loss_k.item():.6f} vs {loss_p.item():.6f} "
          f"(|diff| {d_loss:.2e}, tol {EVAL_REF_ATOL:g}); bf16 at full "
          f"depth, relative in norm, worst of {len(rel)} leaves "
          f"{rel[worst]:.3e} ({worst}; tol {TRAIN_GRAD_BF16:g})")
    if not (d_loss <= EVAL_REF_ATOL and rel[worst] <= TRAIN_GRAD_BF16):
        raise AssertionError("packed: the gradient disagrees with the plain "
                             "attention")
    torch.cuda.empty_cache()

    # (c) the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    zero_route_counts()
    zero_seg_counts()
    per_step, per_step_routes, per_step_seg, losses = [], [], [], []
    for b in batches:
        before, before_r, before_s = (train_counts(), route_counts(),
                                      seg_counts())
        state, metrics = step(state, b)
        per_step.append({k: v - before[k] for k, v in train_counts().items()})
        per_step_routes.append({k: {r_: n - before_r[k][r_]
                                    for r_, n in c.items()}
                                for k, c in route_counts().items()})
        per_step_seg.append({k: n - before_s[k]
                             for k, n in seg_counts().items()})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches, seg_launches = train_counts(), seg_counts()
    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 8, "update_apply": 9, "momentum_sumsq": 1,
            "norm_apply": 0}
    want_s = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L}
    for i, (c, s) in enumerate(zip(per_step, per_step_seg)):
        if c != want or s != want_s:
            raise AssertionError(f"packed train step {i} launched {c}, with "
                                 f"segments {s}; not {want}, {want_s}")
    want_r = {"mha_fwd": {"mma": 2 * L},
              **{k: {"mma": L} for k in BWD_KERNELS},
              "xent_fwd": {"wgmma": 1}, "xent_bwd_dh": {"mma": 1},
              "xent_bwd_dw": {"mma": 1}, "update_apply": {"vec": 9}}
    for i, c in enumerate(per_step_routes):
        check_routes(c, want_r, f"packed train step {i}", show=False)
    print(f"  (c) make_train_step: every one of {PACKED_STEPS} steps "
          f"launched {want}, by route {want_r}, with segments {want_s}")
    losses = [float(x) for x in losses]

    # (d) each document against its offset-preserving unpacked row, run in
    # chunks of the packed batch's shape
    params = state.params
    per_p = _per_token_losses(torch, params, cfg, batch)
    rows = unpack_to_rows(batch)
    n = rows["tokens"].shape[0]
    chunks = []
    for c0 in range(0, n, B):
        part = {k: x[c0:c0 + B] for k, x in rows.items()}
        if part["tokens"].shape[0] < B:  # all-pad rows to the batch shape
            fill = B - part["tokens"].shape[0]
            part = {k: torch.cat([x, torch.full(
                (fill, S), -1 if k == "labels" else 0, dtype=x.dtype,
                device=x.device)]) for k, x in part.items()}
        chunks.append(_per_token_losses(torch, params, cfg, part))
    per_u = torch.cat(chunks)[:n]
    segs = batch["segment_ids"]
    i, worst_d, same = 0, 0.0, 0
    for b in range(B):
        for s in segs[b].unique().tolist():
            if s == 0:
                continue
            m = segs[b] == s
            d = (per_p[b][m] - per_u[i][m]).abs().max().item()
            worst_d = max(worst_d, d)
            same += bool(torch.equal(per_p[b][m], per_u[i][m]))
            i += 1
    print(f"  (d) per-token losses of each of {n} documents against its "
          f"offset-preserving unpacked row: max |diff| {worst_d:.3e} (tol "
          f"{PACKED_DOC_ATOL:g}); {same} of {n} documents bitwise equal")
    if not worst_d <= PACKED_DOC_ATOL:
        raise AssertionError("packed: a document's losses differ from its "
                             "unpacked row's")
    # (e) document 1 of a row perturbed: the other documents bitwise
    # unchanged, and every other row
    rb = next(b for b in range(B) if segs[b].max() >= 2)
    m1 = segs[rb] == 1
    mutant = dict(batch, tokens=batch["tokens"].clone())
    mutant["tokens"][rb, m1] = (mutant["tokens"][rb, m1] + 7) % cfg.vocab_size
    pert = _per_token_losses(torch, params, cfg, mutant)
    other = segs[rb] >= 2
    rest = [x for x in range(B) if x != rb]
    if not (torch.equal(per_p[rb][other], pert[rb][other])
            and torch.equal(per_p[rest], pert[rest])
            and not torch.equal(per_p[rb][m1], pert[rb][m1])):
        raise AssertionError("packed: perturbing document 1 moved another "
                             "document's losses (or left its own)")
    print(f"  (e) row {rb}: document 1 perturbed ({int(m1.sum())} tokens); "
          f"the row's other {int(other.sum())} tokens' losses and the other "
          f"{B - 1} rows' are bitwise unchanged; document 1's moved")
    del per_p, per_u, pert, chunks, rows, mutant

    # (f) one step with any host synchronisation an error
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  (f) packed train step under set_sync_debug_mode('error'): no "
          "host synchronisation")

    # (g) times: host clock best of 3, the profile of one step
    def one():
        nonlocal state
        state, _ = step(state, batch)

    t_step = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        t_step.append(time.perf_counter() - t0)
    step_s = min(t_step)
    tps = real[0] / step_s
    print(f"  [{power}] (g) packed train step {step_s * 1e3:.3f} ms (best of "
          f"3: {', '.join(f'{x * 1e3:.3f}' for x in t_step)}; {tps:.0f} real "
          f"tokens/s, {B * S / step_s:.0f} slots/s) against phase 8's "
          f"unpacked {unpacked['step_ms']:.3f} ms "
          f"({B * S / unpacked['step_ms'] * 1e3:.0f} tokens/s); "
          f"torch.cuda.max_memory_allocated over its {PACKED_STEPS} "
          f"main-path steps {peak / 2**20:.1f} MiB")
    busy, kernels = profile_step(torch, power, one, step_s * 1e3, n=1,
                                 label="packed train step", top=8)
    fams = by_family(kernels)
    for fam, (ms, k_) in sorted(fams.items(), key=lambda x: -x[1][0]):
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{k_:<5d} {fam}")
    del state, step
    torch.cuda.empty_cache()

    # the same steps through the plain attention, from the same weights
    state, step = start()
    with plain_attn:
        ref_losses = []
        for b in batches:
            state, m = step(state, b)
            ref_losses.append(float(m["loss"]))
    del state, step
    torch.cuda.empty_cache()
    gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
    print(f"  packed loss over {PACKED_STEPS} steps: "
          f"{' '.join(f'{x:.4f}' for x in losses)}")
    print(f"  plain attention:              "
          f"{' '.join(f'{x:.4f}' for x in ref_losses)} (max |diff| "
          f"{gap:.2e}, tol {LOSS_CURVE_ATOL:g})")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and gap <= LOSS_CURVE_ATOL):
        raise AssertionError("packed: the training loss does not fall, or "
                             "leaves the plain attention's curve")
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "segment_launches": seg_launches,
            "per_step": per_step[0], "routes": per_step_routes[0],
            "per_step_segments": per_step_seg[0],
            "step_ms": step_s * 1e3, "real_tokens_per_s": tps,
            "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / (step_s * 1e3),
            "peak_mib": peak / 2**20, "losses": losses,
            "ref_losses": ref_losses, "loss_gap": gap, "grad_rel": rel[worst],
            "doc_max_diff": worst_d, "docs_bitwise": same, "docs": n,
            "device_ms_by_family": {f: ms for f, (ms, _) in fams.items()}}


# ------------------------------------------------------ the telemetry plane

# Phase 14 (c): the groups' squared norms against the step's own
# grad_norm and update_norm: the same per-leaf f32 norms (one
# torch._foreach_norm for the gradients on each side; the update's per-leaf
# differences are shared), summed as squares in other groupings: a few f32
# roundings of a sum of 291 positive terms.
STATS_SUM_RTOL = 1e-5
# Phase 14 (c): the column-norm max, median and dispersion against plain
# torch from value_and_grad's gradients on the same params and batch: the
# kernel sums each column's squares in f32 in its own order, plain torch
# in its own (1.5e-5 relative at most, phase 2); the backward kernels and
# cuBLAS are deterministic, so the gradients are the step's.
STATS_COL_RTOL = 1e-4
TELEMETRY_STEPS = 4
# the off-cadence step against the step without stats (gated): no
# reduction, one zero tensor and a dict
OFF_CADENCE_MAX = 0.02


def _fig_stats(metrics, groups):
    """The Fig. 4/10 stats of a step's metrics, one line a group."""
    names = ("grad_norm", "colnorm_max", "colnorm_med", "colnorm_disp",
             "update_norm", "param_norm", "update_ratio", "momentum_norm")
    out = {}
    for g in groups:
        out[g] = {n: float(metrics[f"stats/{g}/{n}"]) for n in names}
        print(f"    {g:9s} " + " ".join(f"{n} {v:.4g}"
                                        for n, v in out[g].items()))
    return out


def _ref_colnorms(torch, grads, tied):
    """{group: (max, median, max / median)} of the per-output-column
    gradient norms, in plain torch: f32 squares summed along the input
    axis (the storage rows for a tied (V, D) head), every stacked slice's
    columns, the median by torch.quantile (linear: the midpoint of an even
    count)."""
    from repro_torch.core.labels import LAYER_GROUPS, layer_group
    out = {}
    for grp in LAYER_GROUPS:
        cols = []
        for k, g in grads.items():
            if layer_group(k, tied=tied) != grp or g.ndim < 2:
                continue
            t = tied and "tok_embed" in k
            cols.append(g.float().pow(2).sum(dim=-1 if t else -2)
                        .sqrt().reshape(-1))
        if cols:
            cn = torch.cat(cols)
            mx, md = cn.max().item(), torch.quantile(cn, 0.5).item()
            out[grp] = (mx, md, mx / max(md, 1e-30))
    return out


def phase_telemetry(torch, seed, power):
    """Phase 14: the telemetry plane at llama-1b, full width and depth."""
    import math
    import shutil as _shutil
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.core.labels import LAYER_GROUPS
    from repro_torch.data import make_dataset
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.launch import train as launcher
    from repro_torch.models import init_params
    from repro_torch.models.model import flatten
    from repro_torch.obs import (MemorySink, MetricsLogger, StatsPolicy,
                                 validate_jsonl, validate_record)
    from repro_torch.training import (GuardPolicy, greedy_generate,
                                      init_state, make_train_step,
                                      value_and_grad)
    t_phase = time.perf_counter()
    cfg = get_arch("llama-1b")
    B, S = 16, 256
    L = cfg.n_layers
    print(f"  {cfg.name}: {L} layers, {cfg.dtype}; batch {B} x {S} from "
          f"SyntheticLM (seed {seed}); scale_fused, clip 1.0, "
          f"linear_warmup_cosine(1e-3, 8), GuardPolicy()")
    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(TELEMETRY_STEPS)]

    def build(stats):
        tx = make_optimizer("scale_fused", linear_warmup_cosine(1e-3, 8))
        params = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        return init_state(params, tx, guard=True), make_train_step(
            cfg, tx, clip_norm=1.0, guard=GuardPolicy(), stats=stats)

    # (a) bitwise inert; the stats run is the main path: counts set to 0
    # just before it, read just after
    state, step = build(None)
    for b in batches:
        state, _ = step(state, b)
    base = {k: x.clone() for k, x in _state_leaves(state, (".step",)).items()}
    del state, step
    torch.cuda.empty_cache()
    state, step = build(StatsPolicy(every_k=1))
    n_mat = sum(1 for p in flatten(state.params).values() if p.ndim >= 2)
    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 8 + n_mat, "update_apply": 9,
            "momentum_sumsq": 1, "norm_apply": 0}
    torch.cuda.synchronize()
    zero_train_counts()
    per_step = []
    for b in batches:
        before = train_counts()
        state, metrics = step(state, b)
        per_step.append({k: v - before[k] for k, v in train_counts().items()})
    torch.cuda.synchronize()
    launches = train_counts()
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"stats step {i} launched {c}, not {want}")
    diff = _first_unequal(torch, base,
                          _state_leaves(state, (".step",)))
    print(f"  (a) {TELEMETRY_STEPS} steps with StatsPolicy(every_k=1) "
          f"against {TELEMETRY_STEPS} without, same seed and batches, guard "
          f"on: {len(base)} leaves (params, optimizer state, guard) "
          + ("bitwise equal" if diff is None else f"differ at {diff}"))
    if diff is not None:
        raise AssertionError(f"the stats changed the training: {diff}")
    del base
    print(f"  every stats step launched {want}: norm_sumsq 8 for the "
          f"optimizer + {n_mat} for the column norms (one a leaf of two or "
          f"more dimensions)")
    print("  Fig. 4/10 stats per layer group at the 4th step:")
    fig = _fig_stats(metrics, LAYER_GROUPS)

    # (b) one stats step with any host synchronisation an error
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  (b) stats step under set_sync_debug_mode('error'): no host "
          "synchronisation")

    # (c) every stat against an independent computation
    batch = batches[1]
    _, _, grads = value_and_grad(state.params, cfg, batch)
    ref = _ref_colnorms(torch, grads, False)
    del grads
    torch.cuda.empty_cache()
    state, metrics = step(state, batch)
    worst = 0.0
    for name in ("grad_norm", "update_norm"):
        parts = sum(float(metrics[f"stats/{g}/{name}"]) ** 2
                    for g in LAYER_GROUPS)
        whole = float(metrics[name]) ** 2
        rel = abs(parts - whole) / whole
        worst = max(worst, rel / STATS_SUM_RTOL)
        print(f"  (c) sum over groups of {name}^2 {parts:.6e} against the "
              f"step's {whole:.6e}: rel {rel:.2e} (tol {STATS_SUM_RTOL:g})")
        if not rel <= STATS_SUM_RTOL:
            raise AssertionError(f"the groups' {name} do not add up")
    for grp, (mx, md, disp) in ref.items():
        got = [float(metrics[f"stats/{grp}/colnorm_{n}"])
               for n in ("max", "med", "disp")]
        rels = [abs(g - w) / abs(w) for g, w in zip(got, (mx, md, disp))]
        worst = max(worst, max(rels) / STATS_COL_RTOL)
        print(f"      {grp}: colnorm max {got[0]:.6g} / {mx:.6g}, median "
              f"{got[1]:.6g} / {md:.6g}, disp {got[2]:.6g} / {disp:.6g} "
              f"(stats / plain torch; worst rel {max(rels):.2e}, tol "
              f"{STATS_COL_RTOL:g})")
        if not max(rels) <= STATS_COL_RTOL:
            raise AssertionError(f"{grp} column-norm stats disagree with "
                                 "plain torch")

    # (d) cost: no stats, stats off the cadence, stats every step, in turns
    # the three step functions train the same state in turn
    def tx():
        return make_optimizer("scale_fused", linear_warmup_cosine(1e-3, 8))
    steps = {"none": make_train_step(cfg, tx(), clip_norm=1.0,
                                     guard=GuardPolicy()),
             "off-cadence": make_train_step(
                 cfg, tx(), clip_norm=1.0, guard=GuardPolicy(),
                 stats=StatsPolicy(every_k=10**9)),
             "every step": step}
    times = {k: [] for k in steps}
    peaks = {k: 0 for k in steps}
    for turn in ("none", "off-cadence", "every step", "every step",
                 "off-cadence", "none"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for b in batches[:3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = steps[turn](state, b)
            torch.cuda.synchronize()
            times[turn].append(time.perf_counter() - t0)
        peaks[turn] = max(peaks[turn], torch.cuda.max_memory_allocated())
    best = {k: min(v) * 1e3 for k, v in times.items()}
    for k in steps:
        print(f"  [{power}] (d) train step, stats {k}: {best[k]:.3f} ms "
              f"(best of 6, in turns none, off, every, every, off, none; "
              f"{best[k] - best['none']:+.3f} ms, "
              f"{best[k] / best['none'] - 1:+.2%}); peak "
              f"{peaks[k] / 2**20:.1f} MiB "
              f"({(peaks[k] - peaks['none']) / 2**20:+.1f} MiB)")
    print(f"  norm_sumsq launches per cadence step {want['norm_sumsq']} "
          f"({n_mat} of them the stats'); per step without stats 8")
    off_rel = best["off-cadence"] / best["none"] - 1
    if not off_rel <= OFF_CADENCE_MAX:
        raise AssertionError(f"the off-cadence step costs {off_rel:+.2%} "
                             f"over the step without stats")
    del state, step, steps
    torch.cuda.empty_cache()

    # (e) the launcher end to end, with its JSONL and trace window
    root = tempfile.mkdtemp(prefix="repro_obs_")
    try:
        argv = ["--arch", "llama-1b", "--optimizer", "scale_fused",
                "--batch", str(B), "--seq", str(S), "--steps", "6",
                "--log-every", "2", "--seed", str(seed), "--log-dir", root,
                "--metrics-every", "2", "--stats-every", "2",
                "--profile-steps", "2:3"]
        print(f"  (e) python -m repro_torch.launch.train "
              f"{' '.join(argv)}:")
        t0 = time.perf_counter()
        final = launcher.main(argv)
        t_e = time.perf_counter() - t0
        path = Path(root) / "metrics.0.jsonl"
        n = validate_jsonl(str(path))
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        kinds = [r["kind"] for r in recs]
        trs = [r for r in recs if r["kind"] == "train_step"]
        with_stats = [r["step"] for r in trs if "stats/valid" in r
                      or "stats/lm_head/grad_norm" in r]
        trace = Path(root) / "profile" / "trace_steps_2_3.json"
        text = trace.read_text() if trace.is_file() else ""
        print(f"      {n} records validate: {kinds}; train_step at "
              f"{[r['step'] for r in trs]}, stats at {with_stats}; "
              f"{t_e:.1f} s, final loss {final:.4f}; trace "
              f"{trace.name} {len(text) / 2**20:.1f} MiB")
        last = trs[-1]
        print(f"      step {last['step']}: "
              + ", ".join(f"{k} {last[k]:.6g}" for k in sorted(last)
                          if k.startswith(("mem/", "time/"))
                          or k == "tokens_per_s"))
        bad = [k for r in recs for k, v in r.items()
               if isinstance(v, str) and k not in ("schema", "kind", "arch",
                                                   "optimizer", "reason")]
        checks = {
            "kinds run from run_header to run_end":
                kinds[0] == "run_header" and kinds[-1] == "run_end"
                and set(kinds[1:-1]) == {"train_step"},
            "train_step records at 1, 2, 4, 6":
                [r["step"] for r in trs] == [1, 2, 4, 6],
            "stats on steps 2, 4, 6 only": with_stats == [2, 4, 6],
            "mem/dev0/* and time/* in every train_step record": all(
                "mem/dev0/bytes_in_use" in r and "mem/dev0/peak_bytes" in r
                and "time/step_s" in r and "time/data_s" in r for r in trs),
            "no metric written as a string": not bad,
            "the trace exists and names train_step and obs_stats":
                '"train_step"' in text and '"obs_stats"' in text,
            "a finite loss": math.isfinite(final),
        }
        for what, ok in checks.items():
            if not ok:
                raise AssertionError(f"launcher telemetry: {what} ({bad})")
        print(f"      checked: {'; '.join(checks)}")
    finally:
        _shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (f) serving with a logger, phase 3's llama-130m shape
    scfg = get_arch("llama-130m")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sp = init_params(scfg, gen, device="cuda")
    prompt = torch.randint(0, scfg.vocab_size, (8, 512), generator=gen,
                           device="cuda", dtype=torch.int32)
    sink = MemorySink()
    with MetricsLogger([sink]) as lg:
        out = greedy_generate(scfg, sp, prompt, 64, 576, logger=lg)
    serve = {r["phase"]: r for r in sink.records if r["kind"] == "serve"}
    for r in serve.values():
        validate_record(r)
    if set(serve) != {"prefill", "decode"} or out.shape != (8, 64):
        raise AssertionError(f"serving records {sorted(serve)}")
    p, d = serve["prefill"], serve["decode"]
    print(f"  [{power}] (f) greedy_generate(logger=...) llama-130m batch 8, "
          f"prompt 512, 64 new: prefill {p['latency_ms']:.3f} ms "
          f"({p['tokens_per_s']:.0f} tokens/s); decode first step "
          f"{d['compile_ms']:.3f} ms, then mean {d['mean_ms']:.3f}, p50 "
          f"{d['p50_ms']:.3f}, p99 {d['p99_ms']:.3f} ms "
          f"({d['tokens_per_s']:.1f} tokens/s); both records validate")
    del sp
    torch.cuda.empty_cache()
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "per_step": per_step[0], "fig": fig,
            "step_ms": best, "peak_mib": {k: v / 2**20
                                          for k, v in peaks.items()},
            "stats_launches_per_step": n_mat,
            "serve": {k: {kk: vv for kk, vv in v.items()
                          if kk.endswith(("_ms", "_per_s"))}
                      for k, v in serve.items()}}


# ------------------------------------------- phase 15: sharded training

SHARD_ROWS = {k: f"{k} col_offset" for k in XENT_KERNELS}
SHARDED_STEPS = 3  # make_train_step steps on the (1, 1) NCCL mesh
# Phase 15 (ii), two ranks against one: the sharded loss sums the
# vocabulary shards' statistics and the f32 dH partials across ranks, and
# the sharded optimizer the sums of squares, in another order than one
# rank's kernels do; the values are f32 sums that agree to a few f32 ulps,
# and what is written in bf16 (dH, dW, theta) then rounds apart by at
# most one bf16 ulp of the element's scale.
TWO_RANK_LOSS_ATOL = 1e-4
# seconds after which a rank of a two-rank job prints where it is and
# exits (phase 15 (ii), phase 22 (i))
TWO_RANK_LIMIT_S = {"sharded": 300, "moe": 420, "mamba": 420,
                    "vlm": 420, "serve": 300}


def offset_counts():
    from repro_torch.kernels.xent import xent as X
    return {SHARD_ROWS[k]: getattr(X, k).offset_launches
            for k in XENT_KERNELS}


def zero_offset_counts():
    from repro_torch.kernels.xent import xent as X
    for k in XENT_KERNELS:
        getattr(X, k).offset_launches = 0


def _uncounted(call):
    """call() with every kernel counter left as it was before it: the
    launches of a comparison, not of the path."""
    from repro_torch.kernels.attention import attention as A
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.scale_head import scale_head as H
    from repro_torch.kernels.xent import xent as X
    fns = (C.norm_sumsq, C.update_apply, C.norm_apply, H.momentum_sumsq,
           A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv, X.xent_fwd,
           X.xent_bwd_dh, X.xent_bwd_dw)
    saved = [(f, {k: dict(v) if isinstance(v, dict) else v
                  for k, v in vars(f).items() if k.endswith("launches")})
             for f in fns]
    try:
        return call()
    finally:
        for f, was in saved:
            for k, v in was.items():
                setattr(f, k, v)


def _route_of(fn, was):
    """The one route ``fn`` counted since ``was`` (its route_launches)."""
    got = [r for r, n in fn.route_launches.items() if n != was[r]]
    if len(got) != 1:
        raise AssertionError(f"{fn.__name__}: launches on routes {got}")
    return got[0]


def phase_sharded_kernels(torch, gen, power):
    """Phase 15 (i): the col_offset clause of the three xent kernels at
    llama-1b's head (N 4096, D 2048, V 32000, bf16), untied (shards are
    w's column slices, views with row stride V) and tied (row slices of
    the (V, D) embedding), cut into 2 and 4 vocabulary shards. Each shard
    against its plain version with its col_offset; the shards' combined
    (lse, ll), summed f32 dH and put-together f32 dW against the unsharded
    kernels on the whole head; per shard the kernel's time by CUDA events
    and by device time, the plain version's, the bound, and the library
    call for the same shard (matmul and a masked logsumexp with the
    label's logit; the backward from recomputed logits, dH and dW
    together). -> (kernels-line rows, {(kernel, case): max abs err})."""
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    N, D, V = 4096, 2048, 32000
    bf, f32 = torch.bfloat16, torch.float32
    h, w, labels, gl = xent_inputs(torch, gen, N, D, V, 0.1, bf)
    wt = w.T.contiguous()
    errs, rows = {}, {name: [] for name in XENT_KERNELS}
    fns = {"xent_fwd": X.xent_fwd, "xent_bwd_dh": X.xent_bwd_dh,
           "xent_bwd_dw": X.xent_bwd_dw}
    refs = {"xent_fwd": XR.xent_fwd_ref, "xent_bwd_dh": XR.xent_bwd_dh_ref,
            "xent_bwd_dw": XR.xent_bwd_dw_ref}
    for tied in (False, True):
        whole = wt if tied else w
        kw0 = {"vocab_size": V, "transposed": tied}
        lse_w, ll_w = X.xent_fwd(h, whole, labels, **kw0)
        args_w = (h, whole, labels, lse_w, gl)
        dh_w = X.xent_bwd_dh(*args_w, out_dtype=f32, **kw0)
        dw_w = X.xent_bwd_dw(*args_w, out_dtype=f32, **kw0)
        for k in (2, 4):
            v = V // k
            case = f"{'tied' if tied else 'untied'} {k} shards"
            parts, dhs, dws, routes = [], [], [], {}
            for i in range(k):
                off = i * v
                ws = whole[off:off + v] if tied else whole[:, off:off + v]
                kw = {**kw0, "col_offset": off}
                was = {n: dict(f.route_launches) for n, f in fns.items()}
                lse, ll = X.xent_fwd(h, ws, labels, **kw)
                want_lse, want_ll = XR.xent_fwd_ref(h, ws, labels, **kw)
                for got, want in ((lse, want_lse), (ll, want_ll)):
                    d = (got - want).abs()
                    if not bool((d <= XENT_LSE_ATOL + XENT_LSE_RTOL
                                 * want.abs()).all()):
                        raise AssertionError(f"xent_fwd {case} shard {i}: "
                                             f"max err {d.max().item():.3e}")
                    key = ("xent_fwd", case)
                    errs[key] = max(errs.get(key, 0.0), d.max().item())
                parts.append((lse, ll))
                a = (h, ws, labels, lse_w, gl)
                for name in ("xent_bwd_dh", "xent_bwd_dw"):
                    got = fns[name](*a, out_dtype=f32, **kw)
                    want = refs[name](*a, out_dtype=f32, **kw)
                    e, _ = _grad_check(torch, name, got, want, f32,
                                       f"{case} shard {i}")
                    key = (name, case)
                    errs[key] = max(errs.get(key, 0.0), e)
                    (dhs if name == "xent_bwd_dh" else dws).append(got)
                    del want
                for n, f in fns.items():
                    routes.setdefault(n, set()).add(_route_of(f, was[n]))
            # the shards together against the whole head
            lse_k = torch.stack([p[0] for p in parts])
            m = lse_k.max(0).values
            lse = m + torch.log(torch.exp(lse_k - m).sum(0))
            ll = torch.stack([p[1] for p in parts]).sum(0)
            worst = max((lse - lse_w).abs().max().item(),
                        (ll - ll_w).abs().max().item())
            if not (bool((lse - lse_w).abs().le(XENT_LSE_ATOL + XENT_LSE_RTOL
                                                 * lse_w.abs()).all())
                    and bool((ll - ll_w).abs().le(XENT_LSE_ATOL
                                                  + XENT_LSE_RTOL
                                                  * ll_w.abs()).all())):
                raise AssertionError(f"{case}: combined (lse, ll) off the "
                                     f"whole head's by {worst:.3e}")
            e_dh, _ = _grad_check(torch, "summed dH", sum(dhs), dh_w, f32,
                                  case)
            e_dw, _ = _grad_check(torch, "put-together dW",
                                  torch.cat(dws, 0 if tied else 1), dw_w,
                                  f32, case)
            print(f"  {case}: every shard against its plain version, on "
                  f"{ {n: sorted(r) for n, r in routes.items()} }; "
                  f"combined lse/ll {worst:.3e}, summed dH {e_dh:.3e}, "
                  f"dW {e_dw:.3e} off the whole head's kernels")
            del dhs, dws, parts
            # shard 1 (a non-zero col_offset): times beside bound, plain
            # and library
            off = v
            ws = whole[off:off + v] if tied else whole[:, off:off + v]
            wu = ws.T if tied else ws
            kw = {**kw0, "col_offset": off}
            local = (labels - off).long()
            mine = (local >= 0) & (local < v)

            def lib_fwd():
                x = (h @ wu).float()
                lab = torch.where(mine, x.gather(1, local.clamp(0, v - 1)[
                    :, None])[:, 0], 0.0)
                return torch.logsumexp(x, 1), lab

            def lib_bwd():
                g = torch.exp((h @ wu).float() - lse_w[:, None])
                g[mine, local[mine]] -= 1.0
                g = (g * gl[:, None]).to(bf)
                return g @ wu.T, h.T @ g
            lib = {"xent_fwd": lib_fwd, "xent_bwd_dh": lib_bwd,
                   "xent_bwd_dw": lib_bwd}
            lib_t = {id(f): (time_ms(torch, f, 5), device_ms(torch, f, 3))
                     for f in (lib_fwd, lib_bwd)}
            for name, fn in fns.items():
                a = ((h, ws, labels) if name == "xent_fwd"
                     else (h, ws, labels, lse_w, gl))
                okw = {} if name == "xent_fwd" else {"out_dtype": f32}

                def kern(fn=fn, a=a, okw=okw):
                    return fn(*a, **kw, **okw)
                ms = time_ms(torch, kern, 5)
                dev_ms = device_ms(torch, kern, 3)
                plain_ms = time_ms(torch, lambda: refs[name](
                    *a, **kw, **okw), 2, warm=1)
                bound, by = xent_bound_ms(N, D, v, 2, name)
                lib_ms, lib_dev = lib_t[id(lib[name])]
                route = sorted(routes[name])[0]
                print(f"  [{power}] {name} {case}, shard 1 (col_offset "
                      f"{off}, {v} columns), {route}: {ms:.4f} ms (device "
                      f"time {fmt_ms(dev_ms)}; bound {bound:.4f} ms by {by}, "
                      f"{bound / ms:.4f} of it; plain {plain_ms:.4f} ms; "
                      f"library {lib_ms:.4f} ms, device time "
                      f"{fmt_ms(lib_dev)})")
                rows[name].append({
                    "name": SHARD_ROWS[name],
                    "shape": f"llama-1b {case}: N={N} D={D} V={v} of {V} "
                             f"bf16" + (" tied" if tied else ""),
                    "route": "cuda", "kernel_route": route,
                    "source": SRC_XENT,
                    "replaces": TPU_KERNELS[name], "launches": None,
                    "max_abs_err": errs[(name, case)], "ms": ms,
                    "device_ms": dev_ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                    "library_device_ms": lib_dev,
                    "library_note": (
                        "matmul + logsumexp and the label's logit"
                        if name == "xent_fwd" else
                        "matmul, softmax - onehot, and the two products "
                        "(dH and dW together, logits recomputed)")})
    out = []
    for name in XENT_KERNELS:
        row = {k: v for k, v in rows[name][0].items() if k != "shape"}
        row["shapes"] = rows[name]
        out.append(row)
    return out, errs


def _two_rank_worker(rank, port, seed, q, task="sharded"):
    """Phase 15 (ii) (``task`` "sharded"), 22 (i) ("moe"), 23 (i)
    ("mamba"), 24 (i) ("vlm") or 25 (i) ("serve"), one of two ranks on
    cuda:0 under gloo."""
    import datetime
    import faulthandler
    import traceback
    # a rank that hangs prints where and exits
    faulthandler.dump_traceback_later(TWO_RANK_LIMIT_S[task], exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    print(f"  rank {rank}: started", flush=True)
    try:
        # a collective that cannot finish fails within two minutes
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=120))
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"  rank {rank}: process group up", flush=True)
        checks = {"sharded": _two_rank_checks,
                  "moe": _two_rank_moe_checks,
                  "mamba": _two_rank_mamba_checks,
                  "vlm": _two_rank_vlm_checks,
                  "serve": _two_rank_serve_checks}[task]
        q.put((rank, "ok", checks(torch, rank, seed)))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _two_rank_checks(torch, rank, seed):
    """Rank ``rank``'s part of phase 15 (ii). Every operand is placed in
    its plan's layout, so the only collective is the entry points' own
    eager ``all_reduce`` (DTensor's redistributions over gloo on CUDA
    tensors hung on the H100 this was measured on; PERF.md §6), and each
    rank holds its local results against its slice of one rank's
    unsharded results."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import NamedSharding, P, Rules, place
    bf = torch.bfloat16
    rules = Rules()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, S, D, V = 16, 256, 2048, 32000
    h = torch.randn((B, S, D), generator=gen, device="cuda").to(bf)
    w = (torch.randn((D, V), generator=gen, device="cuda")
         / D ** 0.5).to(bf)
    labels = torch.randint(0, V, (B, S), generator=gen, device="cuda",
                           dtype=torch.int32)
    cot = torch.rand((B, S), generator=gen, device="cuda")
    out = {"loss": {}, "opt": {}}
    m12 = make_host_mesh(1, 2, device_type="cuda")
    m21 = make_host_mesh(2, 1, device_type="cuda")
    print(f"  rank {rank}: meshes up", flush=True)
    zero_train_counts()
    zero_offset_counts()
    for tied in (False, True):
        ww = w.T.contiguous() if tied else w
        # tokens over data (one rank), the vocabulary over model: the
        # rules' layout with w's embed dim already whole (data is 1)
        h_sh = NamedSharding(m12, P("data", None, None))
        w_sh = NamedSharding(m12, P("model", None) if tied
                             else P(None, "model"))
        plan = dispatch.xent_route(h.shape, ww.shape, h_sh, w_sh, tied)[1]
        hd = place(h, h_sh).detach().requires_grad_()
        wd = place(ww, w_sh).detach().requires_grad_()
        losses = dispatch.xent_loss(hd, wd, labels, vocab_size=V,
                                    transposed=tied).to_local()
        gh, gw = (x.to_local() for x in torch.autograd.grad(
            (losses * cot).sum(), [hd, wd]))
        h1, w1 = (x.detach().requires_grad_() for x in (h, ww))

        def one_rank():
            want = dispatch.xent_loss(h1, w1, labels, vocab_size=V,
                                      transposed=tied)
            return (want,) + torch.autograd.grad((want * cot).sum(),
                                                 [h1, w1])
        want, wh, www = _uncounted(one_rank)
        www = place(www, w_sh).to_local()  # this rank's vocabulary slice
        res = {"plan": (plan.tok_axes, plan.voc_axes),
               "loss": (losses - want).abs().max().item()}
        for n, got, ref in (("dh", gh, wh), ("dw", gw, www)):
            res[n] = ((got.float() - ref.float()).abs()
                      / ulp(torch, ref.float().abs().max(), bf)).max().item()
        out["loss"]["tied" if tied else "untied"] = res
    torch.cuda.synchronize()
    print(f"  rank {rank}: the sharded loss done", flush=True)
    out["loss_launches"] = {**xent_counts(), **offset_counts()}
    # SCALE's entry points at llama-1b's full leaf shapes, col and row,
    # on (2, 1) (a col norm's sums cross ranks) and (1, 2) (a row norm's)
    leaves = {"lm_head/w": ((D, V), ("embed", "vocab")),
              "attn/wq": ((24, D, D), (None, "embed", "heads"))}
    for mname, mesh in (("2x1", m21), ("1x2", m12)):
        for leaf, (shape, axes) in leaves.items():
            sh = rules.sharding(axes, mesh, shape)
            g = torch.randn(shape, generator=gen, device="cuda").to(bf)
            th = (0.02 * torch.randn(shape, generator=gen,
                                     device="cuda")).to(bf)
            m = (0.01 * torch.randn(shape, generator=gen,
                                    device="cuda")).to(bf)
            for kind in ("col", "row"):
                got = _scale_ops(dispatch, g, th, m, kind,
                                 lambda x: place(x, sh, copy=True))
                want = _uncounted(lambda: _scale_ops(
                    dispatch, g, th, m, kind, lambda x: x.clone()))
                errs = {}
                for op, a, b in zip(("normalize", "norm_update",
                                     "momentum_norm", "theta'", "m'"),
                                    got, want):
                    a, b = a.to_local(), place(b, sh).to_local()
                    scale = b.float().abs().max()
                    # bf16: one ulp of the leaf's scale; f32 (the
                    # direction d): the sums' reordering, SS_RTOL of it
                    tol = (ulp(torch, scale, bf) if a.dtype == bf
                           else SS_RTOL * scale)
                    errs[op] = ((a.float() - b.float()).abs()
                                / tol).max().item()
                out["opt"][f"{mname} {leaf} {kind}"] = {
                    "spec": str(tuple(sh.spec)), "err_over_tol": errs}
    torch.cuda.synchronize()
    print(f"  rank {rank}: the sharded entry points done", flush=True)
    out["launches"] = {**train_counts(), **offset_counts()}
    return out


def _scale_ops(dispatch, g, th, m, kind, lay):
    """normalize, norm_update, momentum_norm and momentum_norm_update of
    one leaf, each on copies of its operands laid out by ``lay``."""
    kw = {"gscale": 0.5}
    d = dispatch.normalize(lay(g), kind, **kw)
    t = dispatch.norm_update(lay(th), lay(g), 0.01, kind, **kw)
    _, dm = dispatch.momentum_norm(lay(m), lay(g), 0.9, kind, **kw)
    t2, m2 = dispatch.momentum_norm_update(lay(th), lay(m), lay(g), 0.9,
                                           0.01, kind, **kw)
    return [d, t, dm, t2, m2]


def spawn_two_ranks(seed, task, wait_s):
    """Two ranks of ``_two_rank_worker(..., task)`` on the one card, both
    on cuda:0 under gloo. -> {rank: its result}, after both exited."""
    import multiprocessing as mp
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_two_rank_worker,
                         args=(r, port, seed, q, task)) for r in range(2)]
    atexit.register(_stop_procs, procs)
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    for _ in procs:
        rank, status, res = q.get(timeout=wait_s)
        if status != "ok":
            raise AssertionError(f"two ranks ({task}), rank {rank}:\n{res}")
        got[rank] = res
    for p in procs:
        p.join(timeout=60)
    print(f"  two ranks (gloo, both on cuda:0) in "
          f"{time.perf_counter() - t0:.1f} s, spawn and imports included")
    return got


def phase_two_ranks(torch, seed, power):
    """Phase 15 (ii): two ranks on the one card (gloo, both on cuda:0):
    the sharded ``dispatch.xent_loss`` forward and backward at llama-1b's
    head on a (1, 2) mesh (tokens over data, the vocabulary over model:
    rank 1's shard at col_offset 16000), untied and tied, and the sharded
    SCALE entry points at llama-1b's full leaf shapes on (2, 1) and
    (1, 2), each rank's shards held against its slice of the same call
    unsharded on the rank. -> the launches of both ranks on the sharded
    calls, summed (the unsharded calls they are held against count
    none)."""
    got = spawn_two_ranks(seed, "sharded", 400)
    for rank, res in sorted(got.items()):
        for tag, r in res["loss"].items():
            print(f"  rank {rank} xent_loss {tag} on (1, 2), plan tokens "
                  f"{r['plan'][0]} x vocab {r['plan'][1]}: losses "
                  f"{r['loss']:.3e} off one rank's, dH {r['dh']:.2f} and "
                  f"dW {r['dw']:.2f} bf16 ulps of the leaf's scale")
            if not (r["loss"] <= TWO_RANK_LOSS_ATOL and r["dh"] <= 1.0
                    and r["dw"] <= 1.0):
                raise AssertionError(f"rank {rank}: the sharded loss "
                                     f"({tag}) disagrees with one rank's")
        for case, r in res["opt"].items():
            worst = max(r["err_over_tol"].values())
            if rank == 0:
                each = {k: round(x, 3) for k, x in r["err_over_tol"].items()}
                print(f"  {case} laid out {r['spec']}: worst error over "
                      f"tolerance {worst:.3f} against one rank ({each})")
            if not worst <= 1.0:
                raise AssertionError(f"rank {rank} {case}: the sharded "
                                     f"entry points disagree with one rank")
        print(f"  rank {rank} launches: loss {res['loss_launches']}; all "
              f"{res['launches']}")
    if got[0]["loss_launches"][SHARD_ROWS["xent_fwd"]] or not got[1][
            "loss_launches"][SHARD_ROWS["xent_fwd"]]:
        raise AssertionError("rank 1 alone holds a shard at a non-zero "
                             "col_offset")
    return {k: got[0]["launches"][k] + got[1]["launches"][k]
            for k in got[0]["launches"]}


def _stop_procs(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def phase_sharded_train(torch, seed, power, train):
    """Phase 15 (iii): ``make_train_step(rules, mesh)`` on a (1, 1) NCCL
    mesh, llama-1b at full width and depth, phase 8's configuration and
    batches, parameters placed per the rules (DTensors): each step's
    launches as phase 8's, the losses against phase 8's unsharded steps
    from the same weights, and the step time beside phase 8's (the
    DTensor cost at one rank)."""
    import math
    import socket
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.models.model import place_params
    from repro_torch.models.sharding import Rules
    from repro_torch.training import init_state, make_train_step
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        cfg = get_arch("llama-1b")
        B, S, L = 16, 256, cfg.n_layers
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = place_params(init_params(cfg, gen, device="cuda"), cfg,
                              mesh)
        ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
        batches = [ds.global_batch_at(i) for i in range(SHARDED_STEPS)]
        tx = make_optimizer("scale_fused",
                            linear_warmup_cosine(1e-3, TRAIN_STEPS))
        step = make_train_step(cfg, tx, clip_norm=1.0, rules=Rules(),
                               mesh=mesh)
        state = init_state(params, tx)
        del params
        torch.cuda.synchronize()
        zero_train_counts()
        zero_offset_counts()
        want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
                "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
                "norm_sumsq": 8, "update_apply": 9, "momentum_sumsq": 1,
                "norm_apply": 0}
        losses, times = [], []
        for i, b in enumerate(batches):
            before = train_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            c = {k: v - before[k] for k, v in train_counts().items()}
            if c != want:
                raise AssertionError(f"sharded step {i} launched {c}, not "
                                     f"{want}")
            losses.append(float(metrics["loss"]))
        launches = {**train_counts(), **offset_counts()}
        ref = train["losses"][:SHARDED_STEPS]
        gap = max(abs(a - b) for a, b in zip(losses, ref))
        lay = str(tuple(state.params["lm_head"]["w"].placements))
        print(f"  (1, 1) NCCL mesh, parameters DTensors (lm_head {lay}): "
              f"every step launched {want}")
        print(f"  losses {' '.join(f'{x:.6f}' for x in losses)}; phase 8 "
              f"unsharded {' '.join(f'{x:.6f}' for x in ref)} (max |diff| "
              f"{gap:.3e}{', bitwise' if losses == ref else ''}; tol "
              f"{LOSS_CURVE_ATOL:g})")
        if not (all(map(math.isfinite, losses)) and gap <= LOSS_CURVE_ATOL):
            raise AssertionError("the sharded steps leave phase 8's curve")
        best = min(times[1:]) * 1e3
        print(f"  [{power}] sharded train step {best:.3f} ms (host clock, "
              f"best of steps 2-{SHARDED_STEPS}) against phase 8's "
              f"{train['step_ms']:.3f} ms unsharded: "
              f"{best - train['step_ms']:+.3f} ms at one rank")
        del state
        return {"launches": launches, "losses": losses, "step_ms": best}
    finally:
        dist.destroy_process_group()


def phase_sharded(torch, gen, seed, power, train):
    """Phase 15: (i) the col_offset clause at full width, (ii) two ranks
    on the one card, (iii) the sharded train step on a (1, 1) mesh. The
    sharded path's launches: (ii)'s and (iii)'s, each from counts set to
    0 just before it."""
    rows, errs = phase_sharded_kernels(torch, gen, power)
    two = phase_two_ranks(torch, seed, power)
    one = phase_sharded_train(torch, seed, power, train)
    launches = {k: two.get(k, 0) + one["launches"].get(k, 0)
                for k in {*two, *one["launches"]}}
    return {"rows": rows, "launches": launches, "errs": errs,
            "train": one}


# ------------------------------ phase 16: the MoE family and ARCH_IDS

MOE_ARCH = "dbrx-132b"
MOE_LAYERS = 2   # of dbrx-132b's 40: every width at full size
MOE_STEPS = 3
ARCH_DENSE = ("qwen2-7b", "granite-3-8b", "deepseek-67b",
              "mistral-large-123b")
ARCH_LAYERS = 2
ARCH_STEPS = 2
SERVE_MOE = (4, 256, 32)  # batch, prompt, new tokens (phases 16 and 17)
# Phase 16 holds dbrx's 3-step loss and aux, and each dense config's
# 2-step loss, against the same steps with every kernel through its
# plain version (LOSS_CURVE_ATOL, phase 8's reasons, at 2 layers);
# the aux is f32 E * sum_e f_e P_e from the same bf16 router logits on
# both routes, so it moves only where a rounding apart flips a top-k
# choice (each flip moves f_e by 1/T of one expert, 2.4e-4 at T 4096).


def moe_routing(torch, cfg, p, h):
    """(sorted top-k experts of each token (B, S, k), kept pairs, pairs)
    of ``apply_moe``'s routing of ``h``, the layer's own ``moe_route``;
    for the record only (phase 16 wraps ``layers.apply_moe`` with it)."""
    from repro_torch.models import layers as L
    B, S = h.shape[:2]
    G, Tg, _ = L.moe_groups(cfg, B * S)
    _, _, top_i, _, keep = L.moe_route(p, cfg, h.reshape(G, Tg, -1))
    return (top_i.reshape(B, S, -1).sort(-1).values, int(keep.sum()),
            keep.numel())


def moe_tap(torch, taps):
    """A patch of ``layers.apply_moe`` that appends each call's
    ``moe_routing`` to ``taps`` and then runs the layer."""
    from unittest import mock
    from repro_torch.models import layers as L
    real = L.apply_moe

    def tapped(p, cfg, h, **kw):
        taps.append(moe_routing(torch, cfg, p, h))
        return real(p, cfg, h, **kw)
    return mock.patch.object(L, "apply_moe", tapped)


MOE_SPANS = ("moe_router", "moe_dispatch", "moe_experts", "moe_combine")
OUTSIDE_MODEL = "outside the model: the optimizer and the step's own work " \
    "(timed apart)"


def _in_model(ev, serving):
    """Whether op ``ev`` runs the model: the trainer's ``fwd`` span or an
    autograd node holds it, or, ``serving``, no optimizer span does."""
    chain = []
    while ev is not None:
        chain.append(ev.name)
        ev = ev.cpu_parent
    if "fwd" in chain or any(n.startswith("autograd::engine")
                             for n in chain):
        return True
    return serving and "optimizer_update" not in chain


def _moe_span(ev, fwd_span):
    """The innermost MOE_SPANS or MLA_SPANS span op ``ev`` ran under: an
    enclosing
    span, or for an op of the backward the span of the forward op whose
    autograd node it runs ((thread, sequence_nr) -> span: ``fwd_span``)."""
    while ev is not None:
        if ev.name in MOE_SPANS + MLA_SPANS + MAMBA_SPANS + VLM_SPANS:
            return ev.name
        if ev.name.startswith("autograd::engine::evaluate_function"):
            return fwd_span.get((ev.fwd_thread, ev.sequence_nr))
        ev = ev.cpu_parent
    return None


def moe_profile(torch, power, step, untraced_ms, label, serving=False):
    """Device time by ``by_family`` of one call of ``step`` (torch.profiler),
    each model kernel keyed "span|kernel" under the MoE span it ran in:
    -> (busy ms, {family: (ms, launches)}). ``serving``: every op outside
    an optimizer span runs the model."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    # a span's own device range comes back as a device event and a
    # "kernel" of its name, and an op's own CUDA time as a "kernel" named
    # after the op: neither is a kernel
    spans = {ev.name for ev in events
             if getattr(ev, "is_user_annotation", False)} | {
                 "fwd", "optimizer_update", "guard", "obs_stats", *MOE_SPANS,
                 *MLA_SPANS, *MAMBA_SPANS, *VLM_SPANS}
    device = [ev for ev in events
              if ev.device_type.name == "CUDA" and ev.name not in spans]
    busy = sum((ev.time_range.end - ev.time_range.start) / 1e3
               for ev in device)
    fwd_span = {}
    for ev in events:
        if ev.device_type.name == "CPU" and ev.sequence_nr >= 0:
            span = _moe_span(ev, {})
            if span:
                fwd_span[(ev.thread, ev.sequence_nr)] = span
    # the model's kernels (the forward, its recompute and the backward),
    # each at the innermost op that lists it; the main thread's kernels
    # outside the model (the optimizer, the step's own norms and copies)
    # are listed under more ops than launched them, so they are one line
    # here, the device time left, and train_family times their parts apart
    kernels = []
    for ev in events:
        if (ev.device_type.name != "CPU" or not ev.kernels
                or not _in_model(ev, serving)):
            continue
        inner = {}
        for c in ev.cpu_children:
            for k in c.kernels:
                inner[k] = inner.get(k, 0) + 1
        span = _moe_span(ev, fwd_span)
        for k in ev.kernels:
            if inner.get(k):
                inner[k] -= 1
            elif k.name != ev.name and k.name not in spans:
                kernels.append((f"{span}|{k.name}" if span else k.name, 1,
                                k.duration / 1e3))
    # the sequence-split decode's ctypes launch of mha_fwd is under its
    # record_function span only, and no op lists it: each such span's one
    # unlisted mha_fwd kernel is the model's, keyed by its own name; any
    # other unlisted kernel stays outside the model
    n_split = sum(1 for ev in events if ev.device_type.name == "CPU"
                  and ev.name == "seq_split_decode")
    if n_split:
        listed = {}
        for name, _, _ in kernels:
            name = name.split("|")[-1]
            listed[name] = listed.get(name, 0) + 1
        for ev in device:
            if listed.get(ev.name):
                listed[ev.name] -= 1
            elif n_split and "mha_fwd" in ev.name:
                n_split -= 1
                kernels.append((ev.name, 1, (ev.time_range.end
                                             - ev.time_range.start) / 1e3))
    fams = by_family(kernels)
    model = sum(t for t, _ in fams.values())
    if busy - model > 0.005 * busy:
        fams[OUTSIDE_MODEL] = (busy - model, len(device) - len(kernels))
    if busy == 0:
        print(f"  {label}: the profiler recorded no device time (busy share "
              "not measured)")
        return None, {}
    print(f"  [{power}] {label}: device busy {busy:.3f} ms of "
          f"{untraced_ms:.3f} ms untraced (idle share "
          f"{1 - busy / untraced_ms:.3f}); {len(device)} kernel launches")
    for fam, (ms, n) in sorted(fams.items(), key=lambda x: -x[1][0]):
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<5d} {fam}")
    return busy, fams


def moe_outside_parts(torch, tx, state, cfg, batch):
    """CUDA-event ms of a train step's work outside the model, on one
    batch's gradients: the optimizer's update (whole, and on the 4-D
    expert leaves alone: the plain stage route), the clip's global norm,
    and update_norm's snapshot and f32 differences. Writes the params."""
    from repro_torch.core.types import global_norm
    from repro_torch.models.model import flatten
    from repro_torch.obs.stats import leaf_update_norms
    from repro_torch.training import value_and_grad

    def timed(fn):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    _, _, grads = value_and_grad(state.params, cfg, batch)
    params = flatten(state.params)
    four = {k: p for k, p in params.items() if p.ndim == 4}
    one = torch.ones((), device="cuda")
    out = {"clip norm": timed(lambda: global_norm(grads))}
    if four:
        sub_state = tx.init(four)
        out["stage4d"] = timed(lambda: tx.update_params(
            {k: grads[k] for k in four}, sub_state, four, grad_scale=one))
        del sub_state
    out["optimizer"] = timed(lambda: tx.update_params(
        grads, state.opt_state, state.params, grad_scale=one))
    del grads

    def book():
        old = {k: p.clone() for k, p in params.items()}
        norms = leaf_update_norms(params, old)
        torch.linalg.vector_norm(torch.stack(list(norms.values())))
    out["update_norm"] = timed(book)
    return out


def _step_counts(torch, step, state, batches):
    """The main path: counts set to 0 just before it, read just after;
    each step timed on the host clock between synchronisations. -> (state,
    per-step launches, per-step routes, step seconds, metrics, peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    zero_route_counts()
    per_step, per_route, secs, mets = [], [], [], []
    for b in batches:
        before, before_r = train_counts(), route_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append({k: v - before[k] for k, v in train_counts().items()})
        per_route.append({k: {r: n - before_r[k][r] for r, n in c.items()}
                          for k, c in route_counts().items()})
        mets.append({k: float(v) for k, v in m.items()})
    return (state, per_step, per_route, secs, mets,
            torch.cuda.max_memory_allocated())


def train_want(L, route, n_mat):
    """(launches, routes) of one train step of a model with ``L`` attention
    layers on ``route`` and ``n_mat`` matrices of two or three dims besides
    the head: a norm_sumsq and an update_apply each, the head's
    momentum_sumsq and update_apply, one of each xent kernel."""
    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": n_mat, "update_apply": n_mat + 1,
            "momentum_sumsq": 1, "norm_apply": 0}
    want_r = {"mha_fwd": {route: 2 * L},
              **{k: {route: L} for k in BWD_KERNELS},
              "xent_fwd": {"wgmma": 1}, "xent_bwd_dh": {"mma": 1},
              "xent_bwd_dw": {"mma": 1}, "update_apply": {"vec": n_mat + 1}}
    return want, want_r


def _check_steps(per_step, per_route, want, want_r, what):
    for i, (c, r) in enumerate(zip(per_step, per_route)):
        if c != want:
            raise AssertionError(f"{what} step {i} launched {c}, not {want}")
        check_routes(r, want_r, f"{what} step {i}", show=False)
    print(f"  {what}: every one of {len(per_step)} steps launched {want}, by "
          f"route {want_r}")


def plain_kernels():
    """A patch of ``dispatch`` that sends every kernel of the train and
    serving paths to its plain version: attention, the three xent kernels
    and the optimizer's four (the head's update through update_apply's);
    the plain-route twin of phases 16 and 17."""
    from unittest import mock
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head.ref import momentum_sumsq_ref
    from repro_torch.kernels.xent import ref as XR

    def head_update_apply_ref(theta, m_new, ss, lr, axis="col", eps=CR.EPS):
        return CR.update_apply_ref(theta, m_new, ss, lr, axis, eps=eps)
    return mock.patch.multiple(
        dispatch, mha_fwd=mha_fwd_ref, xent_fwd=XR.xent_fwd_ref,
        xent_bwd_dh=XR.xent_bwd_dh_ref, xent_bwd_dw=XR.xent_bwd_dw_ref,
        norm_sumsq=CR.norm_sumsq_ref, norm_apply=CR.norm_apply_ref,
        update_apply=CR.update_apply_ref, momentum_sumsq=momentum_sumsq_ref,
        head_update_apply=head_update_apply_ref)


def train_family(torch, seed, power, arch, cfg, reduced, steps, want, want_r,
                 widths, shape=(16, 256)):
    """Phase 16 (i), 17 (i), 18 (i), 19 (i-ii): ``arch`` at full width,
    cut to ``cfg`` (each cut listed in ``reduced``; ``widths`` names the
    config's widths): the launcher's --smoke run, then ``steps`` steps of
    the main path (bf16, batch ``shape`` from SyntheticLM, scale_fused,
    clip 1.0), each launching ``want`` by route ``want_r`` with a finite
    loss, aux and grad norm; one step's device time by family, the work
    outside the model timed apart, and the loss and aux against the same
    steps with every kernel through its plain version, from the same
    seeded weights."""
    import math
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.launch import train as launcher
    from repro_torch.models import init_params
    from repro_torch.models.layers import moe_groups
    from repro_torch.models.model import count_params, param_shapes
    from repro_torch.training import init_state, make_train_step
    torch.cuda.empty_cache()  # the earlier phases' cached blocks

    # the launcher with --smoke, as a user tries the config first
    argv = ["--arch", arch, "--smoke", "--optimizer", "scale_fused",
            "--batch", "4", "--seq", "32", "--steps", "2", "--log-every", "1",
            "--seed", str(seed)]
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}:")
    final = launcher.main(argv)
    if not math.isfinite(final):
        raise AssertionError("the --smoke launcher's loss is not finite")

    B, S = shape
    shapes = param_shapes(cfg)
    n_params = count_params(shapes)
    n_4d = sum(math.prod(s) for s in shapes.values() if len(s) == 4)
    groups = ""
    if cfg.n_experts:
        G, Tg, C = moe_groups(cfg, B * S)
        groups = (f": {G} groups of {Tg} tokens, capacity {C} (cf "
                  f"{cfg.capacity_factor})")
        if G < 2:
            raise AssertionError(f"the {arch} batch must dispatch over "
                                 "groups")
    print(f"  {arch}: reduced {reduced}; {widths}; {n_params / 1e9:.3f} G "
          f"params ({n_4d / 1e9:.3f} G in the 4-D expert leaves), "
          f"{cfg.dtype}, remat {cfg.remat!r}; batch {B} x {S} from "
          f"SyntheticLM (seed {seed}){groups}; scale_fused, clip 1.0, "
          f"linear_warmup_cosine(1e-3, {steps})")
    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(steps)]

    def start():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tx = make_optimizer("scale_fused", linear_warmup_cosine(1e-3, steps))
        return (init_state(init_params(cfg, gen, device="cuda"), tx),
                make_train_step(cfg, tx, clip_norm=1.0), tx)

    state, step, tx = start()
    state, per_step, per_route, secs, mets, peak = _step_counts(
        torch, step, state, batches)
    launches = train_counts()
    _check_steps(per_step, per_route, want, want_r, f"{arch} train")
    losses = [m["loss"] for m in mets]
    auxs = [m["aux"] for m in mets]
    gnorms = [m["grad_norm"] for m in mets]
    print(f"  {arch} grad norm over {steps} steps (before the clip): "
          f"{' '.join(f'{x:.5f}' for x in gnorms)}")
    if not all(map(math.isfinite, gnorms)):
        raise AssertionError(f"{arch}: a grad norm is not finite")
    step_s = min(secs[1:])
    print(f"  [{power}] {arch} train step {step_s * 1e3:.3f} ms (best of "
          f"steps 2-{steps}; {B * S / step_s:.0f} tokens/s; each "
          f"{' '.join(f'{s * 1e3:.1f}' for s in secs)} ms); "
          f"torch.cuda.max_memory_allocated over the {steps} steps "
          f"{peak / 2**20:.1f} MiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**20:.1f}")

    def one():
        nonlocal state
        state, _ = step(state, batches[0])

    busy, fams = moe_profile(torch, power, one, step_s * 1e3,
                             f"{arch} train step")
    parts = moe_outside_parts(torch, tx, state, cfg, batches[0])
    stage = (f", of it the plain stage route on the 4-D expert leaves "
             f"{parts['stage4d']:.3f} ms" if "stage4d" in parts else "")
    print(f"  [{power}] {arch} outside the model, timed apart (CUDA "
          f"events): the optimizer's update {parts['optimizer']:.3f} ms"
          f"{stage}; the clip's global norm {parts['clip norm']:.3f} ms; "
          f"update_norm's snapshot and f32 differences "
          f"{parts['update_norm']:.3f} ms")
    del state, step, tx
    torch.cuda.empty_cache()

    # the same steps with every kernel through its plain version, from the
    # same seeded weights
    state, step, _ = start()
    before = train_counts()
    with plain_kernels():
        ref = []
        for b in batches:
            state, m = step(state, b)
            ref.append((float(m["loss"]), float(m["aux"])))
    if train_counts() != before:
        raise AssertionError(f"{arch}: a kernel ran on the plain route")
    del state, step
    torch.cuda.empty_cache()
    gap = max(max(abs(a - r[0]), abs(x - r[1]))
              for a, x, r in zip(losses, auxs, ref))
    print(f"  {arch} loss (with 0.01 aux) over {steps} steps: "
          f"{' '.join(f'{x:.5f}' for x in losses)}; aux "
          f"{' '.join(f'{x:.5f}' for x in auxs)}")
    print(f"  every kernel through its plain version: loss "
          f"{' '.join(f'{r[0]:.5f}' for r in ref)}; aux "
          f"{' '.join(f'{r[1]:.5f}' for r in ref)} (max |diff| {gap:.2e}, "
          f"tol {LOSS_CURVE_ATOL:g})")
    if not (all(map(math.isfinite, losses + auxs)) and gap <= LOSS_CURVE_ATOL):
        raise AssertionError(f"{arch}: the loss or aux is not finite, or "
                             "leaves the plain versions' curve")
    return {"reduced": reduced, "launches": launches,
            "per_step": per_step[0], "routes": per_route[0],
            "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
            "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / (step_s * 1e3),
            "peak_mib": peak / 2**20, "losses": losses, "aux": auxs,
            "grad_norms": gnorms, "ref": ref, "loss_gap": gap,
            "device_ms_by_family": {f: ms for f, (ms, _) in fams.items()},
            "outside_ms": parts}


def no_drop(cfg):
    """``cfg`` at capacity factor E/k: no (token, choice) pair is dropped,
    so decode computes what a full forward does."""
    import dataclasses
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def next_tokens(torch, logits):
    """The greedy next tokens of decode ``logits``: (B, 1) of (B, 1, V);
    an audio model's (B, C, 1) of (B, C, 1, V), each codebook's own."""
    return logits[..., -1, :].argmax(-1).to(torch.int32)[..., None]


def serve_run(torch, c, p, prompt, tokens=None, n_new=SERVE_MOE[2],
              images=None):
    """prefill of ``prompt`` + N - 1 decode steps (greedy, N = ``n_new``,
    or fed ``tokens``, N - 1 of them), the VLM's with ``images`` -> (tokens
    fed, last logits (B, V); audio (B, C, V), each MoE layer call's
    ``moe_routing``)."""
    from repro_torch.training import make_decode_step, make_prefill_step
    P = prompt.shape[-1]
    N = n_new if tokens is None else tokens.shape[-1] + 1
    prefill, decode = make_prefill_step(c, max_seq=P + N), \
        make_decode_step(c)
    taps = []
    with moe_tap(torch, taps):
        state, logits = prefill(p, prompt, images)
        toks = []
        for i in range(N - 1):
            toks.append(next_tokens(torch, logits) if tokens is None
                        else tokens[..., i:i + 1])
            state, logits = decode(p, state, toks[-1], images)
    return torch.cat(toks, dim=-1), logits[..., -1, :].float(), taps


def full_logits(torch, c, p, prompt, toks, taps, images=None):
    """The last position's logits (B, vocab; audio (B, C, vocab)) of a
    full forward over the prompt and ``toks``; each MoE layer call's
    routing appended to ``taps``."""
    from repro_torch.models import forward, logits_from_hidden
    with torch.no_grad(), moe_tap(torch, taps):
        h, _, _ = forward(p, c, torch.cat([prompt, toks], dim=-1),
                          image_embeds=images)
    return logits_from_hidden(p, c, h[:, -1:])[..., -1, :c.vocab_size] \
        .float()


def serve_against_full(torch, c, p, prompt, toks, last, taps, images=None):
    """(max err, within SERVE tolerances, argmax agreement, tokens routed
    apart per MoE layer, max |ref|, ref) of the last decode logits ``last``
    against a full forward over the prompt and ``toks``; ``taps``: the
    decode run's routing."""
    full = []
    ref = full_logits(torch, c, p, prompt, toks, full, images)
    got = last[..., :c.vocab_size]
    err = (got - ref).abs()
    ok = bool((err <= SERVE_ATOL + SERVE_RTOL * ref.abs()).all()) and \
        bool(torch.isfinite(got).all())
    inc = [torch.cat([t[0] for t in taps[l::len(full)]], dim=1)
           for l in range(len(full))]
    apart = [int((a != f[0]).any(-1).sum()) for a, f in zip(inc, full)]
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    return err.max().item(), ok, agree, apart, ref.abs().max().item(), ref


def sub_calls(cfg, kind):
    """The sub-layers of ``kind`` (attn, moe, ...) one forward runs: each
    segment's super-blocks times those of its layout (a hybrid super-block
    has one attention and an MoE at each odd position)."""
    from repro_torch.models.transformer import superblock_layout
    return sum(n * sum(sub == kind for _, sub in superblock_layout(cfg, k))
               for k, n in cfg.segments)


def serve_family(torch, seed, power, arch, cfg, want_routes,
                 shape=SERVE_MOE):
    """Phase 16 (ii), 17 (ii), 19 (iii): ``arch`` serving at ``cfg`` (bf16)
    from seeded weights, batch, prompt and new tokens of ``shape``
    (SERVE_MOE unless given), at cf = E/k (``no_drop``) and at the
    config's cf: prefill and decode ms, the
    mha_fwd launches by route (``want_routes``), one decode step's device
    time, the share of the decode steps' pairs dropped, and the last
    decode logits against a full forward over the same tokens, with the
    tokens the two route apart (MoE routing is discrete: a rounding apart
    near a tie moves a token to another expert, and through attention
    every later token feels it). At cf E/k also the floor of that check
    with attention through its plain version. -> (results, prompt, the cf
    E/k run's tokens)."""
    from unittest import mock
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.models import init_params
    from repro_torch.training import make_decode_step, make_prefill_step
    B, P, N = shape
    n_moe = sub_calls(cfg, "moe")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda", dtype=torch.int32)
    out, cfs = {}, (no_drop(cfg), cfg)
    for c in cfs:
        tag = f"cf {c.capacity_factor:g}"
        prefill, decode = make_prefill_step(c, max_seq=P + N), \
            make_decode_step(c)
        prefill(params, prompt)  # warm-up, not counted
        torch.cuda.synchronize()
        # the main path: counts set to 0 just before it, read just after
        zero_route_counts()
        mha_fwd.launches = 0
        t0 = time.perf_counter()
        state, logits = prefill(params, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(N - 1):
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            state, logits = decode(params, state, tok)
        end.record()
        torch.cuda.synchronize()
        decode_ms = start.elapsed_time(end) / (N - 1)
        routes = route_counts()["mha_fwd"]
        launches = mha_fwd.launches
        check_routes({"mha_fwd": routes}, {"mha_fwd": want_routes},
                     f"{arch} serving {tag}")
        if launches != sum(want_routes.values()):
            raise AssertionError(f"{arch} serving {tag}: {launches} mha_fwd "
                                 "launches")
        # the same run with its routing recorded: drops, and the tokens
        # the decode path and a full forward route apart
        toks, last, taps = serve_run(torch, c, params, prompt, n_new=N)
        if not torch.equal(last, logits[:, -1].float()):
            raise AssertionError(f"{arch} serving {tag}: a rerun of the "
                                 "decode steps differs")
        dec = taps[n_moe:]
        kept, pairs = sum(t[1] for t in dec), sum(t[2] for t in dec)
        err, ok, agree, apart, top, _ = serve_against_full(
            torch, c, params, prompt, toks, last, taps)
        print(f"  [{power}] {arch} serving {tag}, batch {B}, prompt {P}, "
              f"{N} new tokens: prefill {prefill_s * 1e3:.3f} ms "
              f"({B * P / prefill_s:.0f} prompt tokens/s), decode "
              f"{decode_ms:.3f} ms/step ({B * 1e3 / decode_ms:.1f} tokens/s);"
              f" mha_fwd {launches} launches {routes}; dropped "
              f"{pairs - kept} of {pairs} decode (token, choice) pairs "
              f"({(pairs - kept) / pairs:.3f}); bf16 last decode logits vs "
              f"full forward over {P + N - 1} tokens: max err {err:.3e}, "
              f"|ref| max {top:.3f}, argmax agreement {agree:.3f}, "
              f"tokens routed apart per MoE layer {apart} of "
              f"{B * (P + N - 1)}")
        if c is cfs[0] and kept != pairs:
            raise AssertionError(f"{arch} serving {tag}: a pair was dropped "
                                 "at cf = E/k")
        state, _ = prefill(params, prompt)
        busy, fams = moe_profile(
            torch, power, lambda: decode(params, state, toks[:, :1]),
            decode_ms, f"{arch} decode step {tag}", serving=True)
        out[tag] = {"launches": launches, "routes": routes,
                    "prefill_ms": prefill_s * 1e3, "decode_ms": decode_ms,
                    "decode_busy_ms": busy,
                    "decode_idle_share": None if busy is None
                    else 1 - busy / decode_ms,
                    "decode_device_ms_by_family": {
                        f: ms for f, (ms, _) in fams.items()},
                    "dropped_share": (pairs - kept) / pairs,
                    "bf16_max_err": err, "bf16_within_serve_tol": ok,
                    "bf16_argmax_agreement": agree, "bf16_ref_max": top,
                    "bf16_routed_apart": apart}
        if c is cfs[0]:
            no_drop_toks = toks
        del state
    out["launches"] = sum(out[k]["launches"] for k in out)
    # the floor: the same check at cf = E/k with attention through its
    # plain version
    with mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref):
        out["bf16_floors"] = {"plain attention": serve_against_full(
            torch, cfs[0], params, prompt, *serve_run(
                torch, cfs[0], params, prompt, no_drop_toks))[0]}
    del params
    torch.cuda.empty_cache()
    return out, prompt, no_drop_toks


def held_to_floors(arch, out, cfg):
    """The bf16 decode at cf = E/k held to SERVE_BF16_FLOOR_X times the
    lowest of ``out["bf16_floors"]``."""
    tag = f"cf {no_drop(cfg).capacity_factor:g}"
    floors, got = out["bf16_floors"], out[tag]
    out["bf16_bound"] = SERVE_BF16_FLOOR_X * min(floors.values())
    print(f"  {arch} serving {tag}, bf16: last "
          f"decode logits vs full forward max err {got['bf16_max_err']:.3e}; "
          f"floors {', '.join(f'{k} {v:.3e}' for k, v in floors.items())}; "
          f"bound {SERVE_BF16_FLOOR_X:g} x {min(floors.values()):.3e} = "
          f"{out['bf16_bound']:.3e}; within SERVE_ATOL/RTOL (set on "
          f"llama-130m): {got['bf16_within_serve_tol']}")
    if not got["bf16_max_err"] <= out["bf16_bound"]:
        raise AssertionError(f"{arch} serving: bf16 decode leaves the full "
                             "forward by more than its floors allow")


def serve_f32(torch, arch, c32, p32, prompt, toks, images=None):
    """f32 decode, fed ``toks``, against a full forward within
    SERVE_ATOL/RTOL. -> (max err, last decode logits, full forward's)."""
    toks, last, taps = serve_run(torch, c32, p32, prompt, toks,
                                 images=images)
    err, ok, agree, apart, top, ref = serve_against_full(
        torch, c32, p32, prompt, toks, last, taps, images)
    moe = (f", {c32.n_experts} experts, cf {c32.capacity_factor:g}"
           if c32.n_experts else "")
    print(f"  {arch} serving f32, {c32.n_layers} layers{moe}: last decode "
          f"logits vs full forward max err {err:.3e} (tol {SERVE_ATOL:g} + "
          f"{SERVE_RTOL:g}|ref|), |ref| max {top:.3f}, argmax agreement "
          f"{agree:.3f}" + (f", tokens routed apart per MoE layer {apart}"
                            if c32.n_experts else ""))
    if not ok:
        raise AssertionError(f"{arch} serving: f32 decode disagrees with the "
                             "full forward")
    return err, last[..., :c32.vocab_size], ref


def serve_moe(torch, seed, power, cfg):
    """Phase 16 (ii): dbrx serving at full width (``serve_family``), its
    bf16 decode held to its floors (plain attention; dbrx's dense twin, the
    same widths with a dense SwiGLU of moe_d_ff: no MoE), and in f32 (the
    same seed, the bf16 run's tokens) within SERVE_ATOL/RTOL."""
    import dataclasses
    from repro_torch.models import init_params
    out, prompt, toks = serve_family(torch, seed, power, MOE_ARCH, cfg, {
        "mma": cfg.n_layers, "decode": (SERVE_MOE[2] - 1) * cfg.n_layers})
    twin = dataclasses.replace(no_drop(cfg), family="dense",
                               d_ff=cfg.moe_d_ff)
    p_twin = init_params(twin, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    out["bf16_floors"]["dense twin"] = serve_against_full(
        torch, twin, p_twin, prompt, *serve_run(torch, twin, p_twin, prompt,
                                                toks))[0]
    del p_twin
    torch.cuda.empty_cache()
    held_to_floors(MOE_ARCH, out, cfg)
    c32 = dataclasses.replace(no_drop(cfg), dtype="float32")
    p32 = init_params(c32, torch.Generator(device="cuda").manual_seed(seed),
                      device="cuda")
    out["f32_max_err"] = serve_f32(torch, MOE_ARCH, c32, p32, prompt,
                                   toks)[0]
    del p32
    torch.cuda.empty_cache()
    out["tokens"] = toks
    return out


def train_arch(torch, seed, power, arch):
    """Phase 16 (iii): one dense ARCH_IDS config at full width and
    ARCH_LAYERS layers: ARCH_STEPS steps of the main path, their losses
    against the same steps with every kernel through its plain version,
    from the same seeded weights."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.models import init_params
    from repro_torch.models.model import count_params, param_shapes
    from repro_torch.training import init_state, make_train_step
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=ARCH_LAYERS)
    B, S = 16, 256
    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(ARCH_STEPS)]

    def start():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tx = make_optimizer("scale_fused",
                            linear_warmup_cosine(1e-3, ARCH_STEPS))
        return (init_state(init_params(cfg, gen, device="cuda"), tx),
                make_train_step(cfg, tx, clip_norm=1.0))

    state, step = start()
    state, per_step, per_route, secs, mets, peak = _step_counts(
        torch, step, state, batches)
    launches = train_counts()
    del state, step
    torch.cuda.empty_cache()
    state, step = start()
    before = train_counts()
    with plain_kernels():
        ref = []
        for b in batches:
            state, m = step(state, b)
            ref.append(float(m["loss"]))
    if train_counts() != before:
        raise AssertionError(f"{arch}: a kernel ran on the plain route")
    del state, step
    torch.cuda.empty_cache()
    L = cfg.n_layers
    want_c, want_r = train_want(L, "mma", 8)
    losses = [m["loss"] for m in mets]
    gap = max(abs(a - r) for a, r in zip(losses, ref))
    print(f"  [{power}] {arch}: {L} of {full.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}), qkv_bias {cfg.qkv_bias}, rope_theta "
          f"{cfg.rope_theta:g}; {count_params(param_shapes(cfg)) / 1e9:.3f} G "
          f"params: train step {secs[-1] * 1e3:.3f} ms (step {ARCH_STEPS} of "
          f"{ARCH_STEPS}; {B * S / secs[-1]:.0f} tokens/s), losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}, every kernel plain "
          f"{' '.join(f'{x:.5f}' for x in ref)} (max |diff| {gap:.2e}, tol "
          f"{LOSS_CURVE_ATOL:g}), peak {peak / 2**20:.1f} MiB")
    _check_steps(per_step, per_route, want_c, want_r, f"{arch} train")
    if not (all(map(math.isfinite, losses)) and gap <= LOSS_CURVE_ATOL):
        raise AssertionError(f"{arch}: the loss is not finite or leaves the "
                             "plain versions' curve")
    return {"launches": launches, "per_step": per_step[0],
            "routes": per_route[0], "step_ms": secs[-1] * 1e3,
            "tokens_per_s": B * S / secs[-1], "peak_mib": peak / 2**20,
            "losses": losses, "plain_losses": ref, "loss_gap": gap}


def phase_moe(torch, seed, power):
    """Phase 16: dbrx-132b training and serving at full width, and the
    four dense ARCH_IDS configs at full width and ARCH_LAYERS layers."""
    import dataclasses
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    widths = (f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
              f"{cfg.n_kv_heads} kv heads of {cfg.head_dim}, {cfg.n_experts} "
              f"experts top-{cfg.top_k}, moe_d_ff {cfg.moe_d_ff}, vocab "
              f"{cfg.vocab_size}")
    # 6 matrices of two or three dims (tok_embed, wq, wk, wv, wo, router)
    # and the head; the 4-D expert leaves take the plain stage route
    train = train_family(torch, seed, power, MOE_ARCH, cfg,
                         [f"n_layers {full.n_layers} -> {MOE_LAYERS}"],
                         MOE_STEPS, *train_want(cfg.n_layers, "mma", 6),
                         widths)
    serve = serve_moe(torch, seed, power, cfg)
    arch = {a: train_arch(torch, seed, power, a) for a in ARCH_DENSE}
    launches = {}
    for r in arch.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
    return {"train": train, "serve": serve, "arch": arch,
            "arch_launches": launches}


# --------------------------------- MLA and deepseek-v3-671b (phases 2, 4, 17)

MLA_ARCH = "deepseek-v3-671b"
# Phase 17 trains the 3 first_dense_layers and 1 MoE layer of its 61, so
# both segments run at every width, with 64 of its 256 routed experts
# (top-8, the shared expert and cf 1.25 as configured): at 256 one MoE
# layer is 11.27 G parameters, and its bf16 params, grads and update_norm
# snapshot with the plain stage route's f32 temporaries pass the card's
# 80 GB. Serving needs no gradients and keeps all 256.
MLA_LAYERS = 4
MLA_TRAIN_EXPERTS = 64
MLA_STEPS = 3
# MLA's attention (queries and keys 128 + 64 wide, values 128, 128 heads
# over 128 kv heads): (B, S, T, H, K, hd, hdv), causal; phase 2 holds the
# three kernels at both batches, phase 4 times them at the train step's
MLA_ATTN = {"mla B=2 H=K=128 hd=192 hdv=128": (2, 256, 256, 128, 128, 192,
                                               128),
            "train deepseek-v3 H=K=128 hd=192 hdv=128": (16, 256, 256, 128,
                                                         128, 192, 128)}
MLA_TRAIN_ATTN = "train deepseek-v3 H=K=128 hd=192 hdv=128"
MLA_HEAD = "deepseek-v3 N=4096 D=7168 V=129280"
# the MLA layer's spans (``models.layers.apply_mla_attention``)
MLA_SPANS = ("mla_proj", "mla_decode")


def phase_mla_kernels(torch, gen):
    """Phase 2: mha_fwd, mha_bwd_dq and mha_bwd_dkv at MLA's widths (hd
    192 != hdv 128, H == K == 128, causal) against their plain versions,
    bf16 and f32, each on the ``fma`` route (counted), the backward pair
    with lse and delta from the plain forward, each kernel run twice
    (bitwise equal). -> {(kernel, case, dtype): max abs error}."""
    from repro_torch.kernels.attention.attention import (
        _bwd_route, _fwd_route, mha_bwd_dkv, mha_bwd_dq, mha_fwd)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref,
                                                   mha_fwd_ref)
    errs = {}
    for name, (B, S, T, H, K, hd, hdv) in MLA_ATTN.items():
        for dtype in (torch.bfloat16, torch.float32):
            tag = str(dtype).replace("torch.", "")
            key = f"{name} {tag}"
            q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, dtype, hdv)
            kw = dict(scale=hd ** -0.5, causal=True)
            if (_fwd_route(q, k, v), _bwd_route(q, k, v)) != ("fma", "fma"):
                raise AssertionError(f"MLA attention {key}: not on fma")
            before = route_counts()
            out, lse = mha_fwd(q, k, v, None, **kw)
            torch.cuda.synchronize()
            ref, ref_lse = mha_fwd_ref(q, k, v, None, **kw)
            atol, rtol = ((F32_OUT_ATOL, 0.0) if dtype == torch.float32
                          else (BF16_OUT_ATOL, BF16_OUT_RTOL))
            d = (out.float() - ref.float()).abs()
            dl = (lse - ref_lse).abs()
            if not (out.shape == (B, S, H, hdv)
                    and bool(torch.isfinite(out.float()).all())
                    and bool((d <= atol + rtol * ref.float().abs()).all())
                    and bool((dl <= LSE_ATOL + LSE_RTOL
                              * ref_lse.abs()).all())):
                raise AssertionError(f"mha_fwd disagrees with the plain "
                                     f"version: {key}")
            again = mha_fwd(q, k, v, None, **kw)
            _bitwise_again(torch, "mha_fwd", torch.cat(
                [out.float().flatten(), lse.flatten()]), torch.cat(
                [again[0].float().flatten(), again[1].flatten()]), key)
            do = torch.randn(out.shape, generator=gen,
                             device="cuda").to(dtype)
            delta = (do.float() * ref.float()).sum(-1).transpose(
                1, 2).contiguous()
            args = (q, k, v, do, ref_lse, delta, None)
            del out, again, ref
            dq = mha_bwd_dq(*args, **kw)
            dk, dv = mha_bwd_dkv(*args, **kw)
            torch.cuda.synchronize()
            after = route_counts()
            if after != {n: {**c, "fma": c["fma"] + (2 if n == "mha_fwd"
                                                     else 1)}
                         if n in ("mha_fwd", *BWD_KERNELS) else c
                         for n, c in before.items()}:
                raise AssertionError(f"MLA attention {key}: routes {before} "
                                     f"-> {after}, expected fma")
            e_q, r_q, _ = _bwd_check(torch, "mha_bwd_dq", dq,
                                     mha_bwd_dq_ref(*args, **kw), tag, key)
            want_k, want_v = mha_bwd_dkv_ref(*args, **kw)
            e_k, r_k, _ = _bwd_check(torch, "mha_bwd_dkv dK", dk, want_k,
                                     tag, key)
            e_v, r_v, _ = _bwd_check(torch, "mha_bwd_dkv dV", dv, want_v,
                                     tag, key)
            del want_k, want_v
            _bitwise_again(torch, "mha_bwd_dq", dq, mha_bwd_dq(*args, **kw),
                           key)
            dk2, dv2 = mha_bwd_dkv(*args, **kw)
            _bitwise_again(torch, "mha_bwd_dkv", torch.cat(
                [dk.flatten(), dv.flatten()]), torch.cat(
                [dk2.flatten(), dv2.flatten()]), key)
            e_f = d.max().item()
            errs[("mha_fwd", name, tag)] = e_f
            errs[("mha_bwd_dq", name, tag)] = e_q
            errs[("mha_bwd_dkv", name, tag)] = max(e_k, e_v)
            print(f"  {key:48s} fma out err {e_f:.3e} (tol {atol:g} + "
                  f"{rtol:g}|ref|), lse err {dl.max().item():.3e}; dQ err "
                  f"{e_q:.3e}, dK {e_k:.3e}, dV {e_v:.3e} (tol "
                  f"{BWD_SCALE_ATOL[tag]:g}max|ref| + {BWD_RTOL[tag]:g}|ref|;"
                  f" err/tol at most {r_q:.3f}, {r_k:.3f}, {r_v:.3f}); "
                  f"bitwise repeatable")
            del q, k, v, do, delta, args, dq, dk, dv, dk2, dv2
    return errs


def _sdpa_backend(torch, qt, kt, vt):
    """The SDPA backend that takes hdv != hd here, the memory-efficient one
    where it does, else the math one: (name, context manager factory)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        except RuntimeError:
            continue
        return backend.name, lambda b=backend: sdpa_kernel(b)
    raise AssertionError("no SDPA backend takes hdv != hd")


def attention_row_timing(torch, gen, power, errs, label, key, dtype, causal,
                         hdv=None):
    """Phase 4, the three attention kernels at a training step's attention
    ``attention_cases()[key]`` (MLA_ATTN's where ``hdv`` is given) in
    ``dtype``, on the route the step gives them: CUDA-event and device ms,
    the plain version, the bound (f32 operations at the f32 peak outside
    the tensor cores) and F.scaled_dot_product_attention on the same inputs
    (kv repeated to the query heads; forward, and its backward for the
    pair) on the backend ``_sdpa_backend`` names; in f32 also the forward
    in bf16 (the route bf16 inputs take) beside it. ``errs``: phase 2's,
    keyed (kernel, ``key``, dtype). -> {kernel: a "shapes" entry of the
    kernels line's row}."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention.attention import (
        _fwd_route, mha_bwd_dkv, mha_bwd_dq, mha_fwd)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref,
                                                   mha_fwd_ref)
    if hdv:
        B, S, T, H, K, hd, _ = MLA_ATTN[key]
    else:
        B, S, T, H, K, hd = attention_cases()[key][:6]
    q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, dtype, hdv)
    kw = dict(scale=hd ** -0.5, causal=causal)
    route = _fwd_route(q, k, v)
    out, lse = mha_fwd(q, k, v, None, **kw)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, None)
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // K, 1).contiguous()
              .requires_grad_() for x in (k, v))
    backend, ctx = _sdpa_backend(torch, qt, kt, vt)
    with ctx():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           scale=kw["scale"])

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=kw["scale"])

        def sdpa_bwd():
            return torch.autograd.grad(o, [qt, kt, vt],
                                       do.transpose(1, 2), retain_graph=True)
        lib = {"mha_fwd": (time_ms(torch, sdpa_fwd, 10),
                           device_ms(torch, sdpa_fwd, 5))}
        lib["bwd"] = (time_ms(torch, sdpa_bwd, 10),
                      device_ms(torch, sdpa_bwd, 5))
    tag = str(dtype).replace("torch.", "")
    el, f32 = (4, True) if dtype == torch.float32 else (2, False)
    peak = F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S
    shape = (f"{label}: B={B} S={S} T={T} H={H} K={K} hd={hd}"
             + (f" hdv={hdv}" if hdv else "")
             + f" {'causal' if causal else 'non-causal'} {tag}")
    out_rows = {}
    for name, kern, plain in (
            ("mha_fwd", lambda: mha_fwd(q, k, v, None, **kw),
             lambda: mha_fwd_ref(q, k, v, None, **kw)),
            ("mha_bwd_dq", lambda: mha_bwd_dq(*args, **kw),
             lambda: mha_bwd_dq_ref(*args, **kw)),
            ("mha_bwd_dkv", lambda: mha_bwd_dkv(*args, **kw),
             lambda: mha_bwd_dkv_ref(*args, **kw))):
        ms = time_ms(torch, kern, 5, warm=2)
        dev_ms = device_ms(torch, kern, 3, name)
        plain_ms = time_ms(torch, plain, 3, warm=1)
        bound, by = (attention_bound_ms(B, S, T, H, K, hd, causal, None, el,
                                        hdv, peak=peak)
                     if name == "mha_fwd" else bwd_bound_ms(
                         B, S, T, H, K, hd, causal, None, el, name, hdv,
                         peak=peak))
        lib_ms, lib_dev = lib["mha_fwd" if name == "mha_fwd" else "bwd"]
        note = (f"F.scaled_dot_product_attention, {backend} backend"
                + (f", kv repeated to {H} heads" if K < H else "")
                + ("" if name == "mha_fwd" else ", backward (dQ, dK, dV "
                   "together)"))
        print(f"  [{power}] {name} {shape}, {route} route: {ms:.4f} ms "
              f"(device time {fmt_ms(dev_ms)}; bound {bound:.4f} ms by {by}"
              f"{' at the f32 peak' if f32 else ''}, {bound / ms:.4f} of it; "
              f"plain {plain_ms:.4f} ms; {note} {lib_ms:.4f} ms, device time "
              f"{fmt_ms(lib_dev)})")
        out_rows[name] = {
            "name": name, "shape": shape, "route": "cuda",
            "kernel_route": route,
            "source": SRC_MHA if name == "mha_fwd" else SRC_MHA_BWD,
            "replaces": TPU_MHA if name == "mha_fwd" else TPU_KERNELS[name],
            "launches": None,
            "max_abs_err": errs[(name, key, tag)],
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "library_note": note}
    del q, k, v, out, lse, do, delta, args, qt, kt, vt, o
    if f32:
        qb, kb, vb = make_qkv(torch, gen, B, S, T, H, K, hd, torch.bfloat16,
                              hdv)
        mma_ms = time_ms(torch, lambda: mha_fwd(qb, kb, vb, None, **kw), 5,
                         warm=2)
        bound, by = attention_bound_ms(B, S, T, H, K, hd, causal, None, 2,
                                       hdv)
        print(f"  [{power}] mha_fwd at the same shape in bf16, "
              f"{_fwd_route(qb, kb, vb)} route: {mma_ms:.4f} ms (bound "
              f"{bound:.4f} ms by {by}, {bound / mma_ms:.4f} of it)")
        out_rows["mha_fwd"]["bf16_ms"] = mma_ms
        del qb, kb, vb
    torch.cuda.empty_cache()
    return out_rows


def f32_witness(torch, seed, arch, c16, prompt, toks, images=None):
    """A witness for the bf16 decode of ``c16`` (an MoE config at cf E/k)
    that runs no decode on its reference side: the same steps, fed
    ``toks``, computed in f32 from the same bf16 weights; the bf16
    decode's distance from them held to SERVE_BF16_FLOOR_X times the bf16
    full forward's distance from the f32 full forward (the bf16 roundings
    of a path without the decode: MLA's absorbed form, Mamba2's
    recurrence). The f32 decode against the f32 full forward within
    SERVE_ATOL/RTOL (``serve_f32``). The VLM's steps take ``images``.
    -> its record."""
    import dataclasses
    from repro_torch.models import init_params
    from repro_torch.models.model import Params, flatten
    V = c16.vocab_size
    p16 = init_params(c16, torch.Generator(device="cuda").manual_seed(seed),
                      device="cuda")
    c32 = dataclasses.replace(c16, dtype="float32")
    p32 = Params({k: v.float() for k, v in flatten(p16).items()})
    last16 = serve_run(torch, c16, p16, prompt, toks,
                       images=images)[1][..., :V]
    full16 = full_logits(torch, c16, p16, prompt, toks, [], images)
    del p16
    torch.cuda.empty_cache()
    f32_err, last32, full32 = serve_f32(torch, arch, c32, p32, prompt, toks,
                                        images)
    del p32
    torch.cuda.empty_cache()
    dec = (last16 - last32).abs().max().item()
    full = (full16 - full32).abs().max().item()
    rec = {"f32_max_err": f32_err, "bf16_decode_vs_f32_decode": dec,
           "bf16_full_vs_f32_full": full,
           "bound": SERVE_BF16_FLOOR_X * full,
           "argmax_agreement_decode": (last16.argmax(-1) == last32.argmax(
               -1)).float().mean().item(),
           "argmax_agreement_full": (full16.argmax(-1) == full32.argmax(
               -1)).float().mean().item(),
           "ref_max": full32.abs().max().item()}
    cf = f", cf {c16.capacity_factor:g}" if c16.n_experts else ""
    print(f"  {arch} witness, {c16.n_layers} layers, segments "
          f"{c16.segments}{cf}: bf16 decode vs the "
          f"same steps in f32 from the same bf16 weights max err {dec:.3e} "
          f"(argmax agreement {rec['argmax_agreement_decode']:.3f}); bf16 "
          f"full forward vs f32 full forward {full:.3e} (argmax agreement "
          f"{rec['argmax_agreement_full']:.3f}); f32 |ref| max "
          f"{rec['ref_max']:.3f}; bound {SERVE_BF16_FLOOR_X:g} x {full:.3e} "
          f"= {rec['bound']:.3e}")
    if not (math.isfinite(dec) and dec <= rec["bound"]):
        raise AssertionError(f"{arch}: the bf16 decode leaves its f32 "
                             "witness by more than the bf16 full forward")
    return rec


def serve_mla(torch, seed, power, train_cfg):
    """Phase 17 (ii): deepseek-v3 serving at full width, MLA_LAYERS layers
    and all its routed experts (``serve_family``: the prefill through the
    attention kernels on ``fma``, then decode steps of the absorbed form
    against the latent cache, which launch no kernel); its bf16 decode held
    to its floor (attention through its plain version, the same decode);
    then ``f32_witness`` at the training cut (``train_cfg``: 64 experts)
    and at its dense layers alone (no MoE routing)."""
    import dataclasses
    from repro_torch.configs import get_arch
    full = get_arch(MLA_ARCH)
    cfg = dataclasses.replace(train_cfg, n_experts=full.n_experts)
    out, prompt, toks = serve_family(torch, seed, power, MLA_ARCH, cfg,
                                     {"fma": cfg.n_layers})
    out["reduced"] = [f"n_layers {full.n_layers} -> {cfg.n_layers}: the "
                      f"training cut's; all {cfg.n_experts} experts"]
    held_to_floors(MLA_ARCH, out, cfg)
    dense = dataclasses.replace(train_cfg, family="dense",
                                n_layers=train_cfg.first_dense_layers)
    out["witness"] = {f"{c.n_layers} layers, {c.segments}": f32_witness(
        torch, seed, MLA_ARCH, no_drop(c), prompt, toks)
        for c in (train_cfg, dense)}
    return out


def phase_mla(torch, seed, power):
    """Phase 17: deepseek-v3-671b training (MLA_LAYERS layers, both
    segments, MLA_TRAIN_EXPERTS experts) and serving at full width."""
    import dataclasses
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    full = get_arch(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS,
                              n_experts=MLA_TRAIN_EXPERTS)
    if cfg.segments != (("dense", 3), ("moe", 1)):
        raise AssertionError(f"{MLA_ARCH}: segments {cfg.segments}")
    reduced = [f"n_layers {full.n_layers} -> {MLA_LAYERS} (the "
               f"{full.first_dense_layers} first_dense_layers and 1 MoE "
               "layer)", f"n_experts {full.n_experts} -> {MLA_TRAIN_EXPERTS}"]
    widths = (f"d_model {cfg.d_model}, {cfg.n_heads} heads, MLA q_lora "
              f"{cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank}, qk "
              f"{cfg.qk_nope_dim} + {cfg.qk_rope_dim} (rope), v "
              f"{cfg.v_head_dim}; d_ff {cfg.d_ff}, top-{cfg.top_k} of "
              f"{cfg.n_experts} experts, moe_d_ff {cfg.moe_d_ff}, "
              f"{cfg.n_shared_experts} shared; vocab {cfg.vocab_size}")
    # 18 matrices of two or three dims (tok_embed; wq_a, wq_b, wkv_a,
    # wkv_b, wo of each segment; the dense w_gate, w_up, w_down; the
    # router and the shared expert's three) and the head; the 4-D expert
    # leaves take the plain stage route
    train = train_family(torch, seed, power, MLA_ARCH, cfg, reduced,
                         MLA_STEPS, *train_want(cfg.n_layers, "fma", 18),
                         widths)
    serve = serve_mla(torch, seed, power, cfg)
    print(f"  phase 17 took {time.perf_counter() - t0:.1f} s")
    return {"train": train, "serve": serve}


# ---------------------------------------- Mamba2 and mamba2-370m (phase 18)

MAMBA_ARCH = "mamba2-370m"
MAMBA_STEPS = 3
# 4 rows of 1024: phase 8's 4096 tokens a step, and 4 chunks of 256 a row,
# so the SSD's recurrence over chunks runs
MAMBA_BATCH = (4, 1024)
SERVE_MAMBA = (8, 512, 64)  # batch, prompt (2 chunks), new tokens
MAMBA_HEAD = "mamba2-370m N=4096 D=1024 V=50304/50280"
# the Mamba2 layer's spans (``models.layers.apply_mamba``)
MAMBA_SPANS = ("mamba_proj", "mamba_ssd", "mamba_decode")


def serve_mamba(torch, seed, power, cfg):
    """Phase 18 (ii): mamba2-370m serving at full width and depth (bf16)
    from seeded weights, batch, prompt and new tokens of SERVE_MAMBA:
    prefill ms, decode ms a step, one decode step's device time and idle
    share. Serving launches none of the hand-written kernels (the SSD, the
    conv and the decode recurrence are plain products, as JAX's; the head
    of serving is a plain product too): checked. Then ``f32_witness``:
    the f32 decode against an f32 full forward within SERVE_ATOL/RTOL, the
    bf16 decode against the same steps in f32 from the same bf16
    weights."""
    from repro_torch.models import init_params
    from repro_torch.training import make_decode_step, make_prefill_step
    B, P, N = SERVE_MAMBA
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda", dtype=torch.int32)
    prefill, decode = make_prefill_step(cfg, max_seq=P + N), \
        make_decode_step(cfg)
    prefill(params, prompt)  # warm-up, not counted
    torch.cuda.synchronize()
    # the main path: counts read just before it and just after
    before = train_counts()
    t0 = time.perf_counter()
    state, logits = prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    toks = []
    start.record()
    for _ in range(N - 1):
        toks.append(logits[:, -1].argmax(-1).to(torch.int32)[:, None])
        state, logits = decode(params, state, toks[-1])
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / (N - 1)
    after = train_counts()
    launched = {k: n - before[k] for k, n in after.items() if n != before[k]}
    toks = torch.cat(toks, dim=1)
    if launched or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{MAMBA_ARCH} serving: launched {launched} "
                             "hand-written kernels, or its logits are not "
                             "finite")
    print(f"  [{power}] {MAMBA_ARCH} serving, batch {B}, prompt {P}, {N} "
          f"new tokens: prefill {prefill_s * 1e3:.3f} ms "
          f"({B * P / prefill_s:.0f} prompt tokens/s), decode {decode_ms:.3f} ms/step "
          f"({B * 1e3 / decode_ms:.1f} tokens/s); no hand-written kernel "
          "launched (the SSD, conv and decode recurrence are plain torch "
          "products, as JAX's)")
    state, _ = prefill(params, prompt)
    busy, fams = moe_profile(
        torch, power, lambda: decode(params, state, toks[:, :1]), decode_ms,
        f"{MAMBA_ARCH} decode step", serving=True)
    del params, state
    torch.cuda.empty_cache()
    witness = f32_witness(torch, seed, MAMBA_ARCH, cfg, prompt, toks)
    return {"prefill_ms": prefill_s * 1e3, "decode_ms": decode_ms,
            "decode_busy_ms": busy,
            "decode_idle_share": None if busy is None
            else 1 - busy / decode_ms,
            "decode_device_ms_by_family": {f: ms for f, (ms, _) in
                                           fams.items()},
            "witness": witness, "tokens": toks}


def phase_mamba(torch, seed, power):
    """Phase 18: mamba2-370m training and serving at full width and all
    48 layers."""
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    cfg = get_arch(MAMBA_ARCH)
    if cfg.segments != (("ssm", 48),):
        raise AssertionError(f"{MAMBA_ARCH}: segments {cfg.segments}")
    widths = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
              f"{cfg.d_inner}, {cfg.ssm_nheads} heads of {cfg.ssm_headdim} "
              f"over a state of {cfg.ssm_state}, {cfg.ssm_ngroups} group, "
              f"conv {cfg.ssm_dconv}, chunk {cfg.ssm_chunk}; vocab "
              f"{cfg.vocab_size} (padded {cfg.padded_vocab})")
    # 3 matrices of two or three dims (tok_embed, in_proj, out_proj) and
    # the head; conv_w, conv_b, A_log, D, dt_bias and the norms take Adam
    train = train_family(torch, seed, power, MAMBA_ARCH, cfg, [],
                         MAMBA_STEPS, *train_want(0, "mma", 3), widths,
                         shape=MAMBA_BATCH)
    serve = serve_mamba(torch, seed, power, cfg)
    print(f"  phase 18 took {time.perf_counter() - t0:.1f} s")
    return {"train": train, "serve": serve}


# ------------------------------ the hybrid jamba-1.5-large-398b (phase 19)

JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_STEPS = 3
# Phase 19 trains one super-block of period 2 at full width (attention +
# MLP, then Mamba2 + MoE: every sub-layer kind once) with 4 of its 16
# experts: a period-8 super-block is 45.1 G parameters with 16 experts
# and 11.3 G with 2, and at dbrx's 8,635 MiB of peak per G parameters (PR
# 28) none trains on one card. Top-2 of 4 keeps the routing real. Serving
# needs no gradients and keeps all 16 experts; the f32 witness runs at the
# training cut, whose f32 copy beside its bf16 weights fits.
JAMBA_LAYERS = 2
JAMBA_TRAIN_EXPERTS = 4
SERVE_JAMBA = (4, 512, 32)  # batch, prompt (2 chunks), new tokens
# the attention (64 heads over 8 of 128, causal) at the train batch, and
# the head; phase 2 holds the kernels at both
JAMBA_ATTN = "train jamba H=64 K=8 hd=128"
JAMBA_HEAD = "jamba N=4096 D=8192 V=65536"


def serve_jamba(torch, seed, power, train_cfg):
    """Phase 19 (iii): jamba serving at full width, the training cut's one
    super-block with all its experts (``serve_family``: the prefill's
    attention on ``mma``, each decode step's on ``decode``; Mamba2's conv
    and SSM states written in place beside the attention's k/v); its bf16
    decode held to its floor (attention through its plain version, the
    same decode); then ``f32_witness`` at the training cut (4 experts)."""
    import dataclasses
    from repro_torch.configs import get_arch
    full = get_arch(JAMBA_ARCH)
    cfg = dataclasses.replace(train_cfg, n_experts=full.n_experts)
    N = SERVE_JAMBA[2]
    out, prompt, toks = serve_family(
        torch, seed, power, JAMBA_ARCH, cfg,
        {"mma": sub_calls(cfg, "attn"),
         "decode": (N - 1) * sub_calls(cfg, "attn")},
        shape=SERVE_JAMBA)
    out["reduced"] = [f"n_layers {full.n_layers} -> {cfg.n_layers} and "
                      f"hybrid_period {full.hybrid_period} -> "
                      f"{cfg.hybrid_period}: the training cut's; all "
                      f"{cfg.n_experts} experts",
                      f"the f32 witness at the training cut's "
                      f"{train_cfg.n_experts} experts (an f32 copy of the "
                      f"{cfg.n_experts}-expert weights beside the bf16 ones "
                      "passes 70 GB)"]
    held_to_floors(JAMBA_ARCH, out, cfg)
    out["witness"] = f32_witness(torch, seed, JAMBA_ARCH, no_drop(train_cfg),
                                 prompt, toks)
    return out


def phase_jamba(torch, seed, power):
    """Phase 19: jamba-1.5-large-398b training (one super-block of period
    2, JAMBA_TRAIN_EXPERTS experts) and serving (all 16) at full
    width."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import superblock_layout
    t0 = time.perf_counter()
    full = get_arch(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS,
                              hybrid_period=JAMBA_LAYERS,
                              n_experts=JAMBA_TRAIN_EXPERTS)
    layout = superblock_layout(cfg, "hybrid")
    if cfg.segments != (("hybrid", 1),) or layout != (
            ("attn", "attn"), ("ffn0", "mlp"), ("mamba1", "mamba"),
            ("ffn1", "moe")):
        raise AssertionError(f"{JAMBA_ARCH}: segments {cfg.segments}, "
                             f"layout {layout}")
    reduced = [f"n_layers {full.n_layers} -> {JAMBA_LAYERS} and "
               f"hybrid_period {full.hybrid_period} -> {JAMBA_LAYERS} (one "
               "super-block: attention + MLP, then Mamba2 + MoE)",
               f"n_experts {full.n_experts} -> {JAMBA_TRAIN_EXPERTS}"]
    widths = (f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
              f"{cfg.n_kv_heads} kv heads of {cfg.head_dim}, d_ff "
              f"{cfg.d_ff}; top-{cfg.top_k} of {cfg.n_experts} experts, "
              f"moe_d_ff {cfg.moe_d_ff}; Mamba2 d_inner {cfg.d_inner}, "
              f"{cfg.ssm_nheads} heads of {cfg.ssm_headdim} over a state of "
              f"{cfg.ssm_state}, conv {cfg.ssm_dconv}, chunk "
              f"{cfg.ssm_chunk}; vocab {cfg.vocab_size}; layout {layout}")
    # 11 matrices of two or three dims (tok_embed; attn's wq, wk, wv, wo;
    # ffn0's w_gate, w_up, w_down; ffn1's router; mamba1's in_proj and
    # out_proj) and the head; the 4-D expert leaves take the plain stage
    # route, the norms and Mamba2's conv_w, conv_b, A_log, D, dt_bias Adam
    # phase 18's batch: 4 chunks of 256 a row, so the SSD's recurrence
    # over chunks runs
    train = train_family(torch, seed, power, JAMBA_ARCH, cfg, reduced,
                         JAMBA_STEPS, *train_want(1, "mma", 11), widths,
                         shape=MAMBA_BATCH)
    serve = serve_jamba(torch, seed, power, cfg)
    print(f"  phase 19 took {time.perf_counter() - t0:.1f} s")
    return {"train": train, "serve": serve}


# ------------------- the VLM llama-3.2-vision-11b (phases 2, 4 and 20)

VLM_ARCH = "llama-3.2-vision-11b"
VLM_STEPS = 3
# Phase 20 trains all 8 super-blocks of 5 (each cross-attention + MLP, then
# 4 x (self-attention + MLP): 2.141 G parameters, 9.775 G in all); no cut.
VLM_BLOCKS = 8
# 4 rows of 1024 text tokens (phase 8's 4096 a step), each row with the
# config's 4096 image tokens (f32, as the data pipeline gives them)
VLM_BATCH = (4, 1024)
SERVE_VLM = (4, 512, 32)  # batch, prompt, new tokens
# the attention of phase 20 (phase 2 holds the kernels at each, phase 4
# times the cross-attention's)
VLM_CROSS = "cross vlm S=1024 T=4096 H=32 K=8 hd=128"
VLM_CROSS_DECODE = "cross decode vlm S=1 T=4096 H=32 K=8 hd=128"
VLM_ATTN = "train vlm H=32 K=8 hd=128"
VLM_HEAD = "llama-3.2-vision N=4096 D=4096 V=128256"
# the cross sub-layer's spans (``models.layers.apply_attention``)
VLM_SPANS = ("cross_kv", "cross_attn")
# matrices of two or three dims besides the head: tok_embed; the cross
# sub-layer's wq, wk, wv, wo and cross_ffn's w_gate, w_up, w_down; the
# four self-attention sub-layers' 4 and their MLPs' 3 each
VLM_MATRICES = 36


def vlm_want(cfg, cross_route):
    """(launches, routes) of one VLM train step: ``train_want``'s, with
    the self-attention on mma and the cross-attention on ``cross_route``
    (fma with f32 images: its q promoted to their dtype; mma with images
    in the model's bf16)."""
    n_self, n_cross = sub_calls(cfg, "attn"), sub_calls(cfg, "cross")
    want, want_r = train_want(n_self + n_cross, "mma", VLM_MATRICES)

    def split(n):
        out = {"mma": n * n_self}
        out[cross_route] = out.get(cross_route, 0) + n * n_cross
        return out
    return want, {**want_r, "mha_fwd": split(2),
                  **{k: split(1) for k in BWD_KERNELS}}


def vlm_bf16_images_step(torch, seed, cfg, f32_loss):
    """Phase 20 (ii): one train step with the images in the model's bf16
    (as JAX's dry run feeds them): every attention launch on mma, the
    cross-attention's too; its loss against the f32 images' first step's
    from the same weights and tokens."""
    from repro_torch.core import make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.models import init_params
    from repro_torch.training import init_state, make_train_step
    torch.cuda.empty_cache()
    B, S = VLM_BATCH
    b = make_dataset(cfg, S, B, seed=seed, device="cuda").global_batch_at(0)
    b["image_embeds"] = b["image_embeds"].to(torch.bfloat16)
    tx = make_optimizer("scale_fused", 1e-3)
    state = init_state(init_params(cfg, torch.Generator(
        device="cuda").manual_seed(seed), device="cuda"), tx)
    step = make_train_step(cfg, tx, clip_norm=1.0)
    state, per_step, per_route, secs, mets, peak = _step_counts(
        torch, step, state, [b])
    launches = train_counts()
    _check_steps(per_step, per_route, *vlm_want(cfg, "mma"),
                 f"{VLM_ARCH} train, bf16 images")
    gap = abs(mets[0]["loss"] - f32_loss)
    print(f"  {VLM_ARCH} one step with bf16 images: loss "
          f"{mets[0]['loss']:.5f} (f32 images {f32_loss:.5f}, |diff| "
          f"{gap:.2e}, tol {LOSS_CURVE_ATOL:g}), {secs[0] * 1e3:.3f} ms "
          f"(first step)")
    if not (math.isfinite(mets[0]["loss"]) and gap <= LOSS_CURVE_ATOL):
        raise AssertionError(f"{VLM_ARCH}: the bf16-image step's loss")
    del state, step
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step[0],
            "routes": per_route[0], "loss": mets[0]["loss"],
            "loss_gap": gap}


def serve_dense(torch, seed, power, arch, cfg, want_routes, shape,
                check=None):
    """Phases 20 (iii) and 21 (ii): ``arch`` serving at full width (bf16)
    from seeded weights, batch, prompt and new tokens of ``shape`` (an
    audio model's prompt (B, C, P) frames; the VLM's with f32 images, as
    the data pipeline gives them): prefill ms, decode ms a step (the next
    tokens by ``next_tokens``), the mha_fwd launches by route against
    ``want_routes``, the logits' and tokens' shapes, one decode step's
    device time by family; ``check(params, prompt)`` if given; then
    ``f32_witness`` from the same seed. -> its record."""
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.models import init_params
    from repro_torch.training import make_decode_step, make_prefill_step
    B, P, N = shape
    lead = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (*lead, P), generator=gen,
                           device="cuda", dtype=torch.int32)
    images = None if not cfg.n_image_tokens else 0.02 * torch.randn(
        (B, cfg.n_image_tokens, cfg.d_model), generator=gen, device="cuda")
    prefill, decode = make_prefill_step(cfg, max_seq=P + N), \
        make_decode_step(cfg)
    prefill(params, prompt, images)  # warm-up, not counted
    torch.cuda.synchronize()
    # the main path: counts set to 0 just before it, read just after
    zero_route_counts()
    mha_fwd.launches = 0
    t0 = time.perf_counter()
    state, logits = prefill(params, prompt, images)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    toks = []
    start.record()
    for _ in range(N - 1):
        toks.append(next_tokens(torch, logits))
        state, logits = decode(params, state, toks[-1], images)
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / (N - 1)
    routes, launches = route_counts()["mha_fwd"], mha_fwd.launches
    check_routes({"mha_fwd": routes}, {"mha_fwd": want_routes},
                 f"{arch} serving")
    toks = torch.cat(toks, dim=-1)
    if (tuple(logits.shape) != (*lead, 1, cfg.padded_vocab)
            or tuple(toks.shape) != (*lead, N - 1)
            or launches != sum(want_routes.values())
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{arch} serving: logits {tuple(logits.shape)}, "
                             f"tokens {tuple(toks.shape)}, {launches} mha_fwd "
                             "launches, or the logits are not finite")
    unit = "frames" if cfg.n_codebooks else "tokens"
    print(f"  [{power}] {arch} serving, prompt {tuple(prompt.shape)}"
          + (f" with {cfg.n_image_tokens} f32 image tokens a row"
             if images is not None else "")
          + f", {N} new {unit}: prefill {prefill_s * 1e3:.3f} ms "
          f"({B * P / prefill_s:.0f} prompt {unit}/s), decode "
          f"{decode_ms:.3f} ms/step ({B * 1e3 / decode_ms:.1f} {unit}/s); "
          f"mha_fwd {launches} launches {routes}; logits "
          f"{tuple(logits.shape)}")
    state, _ = prefill(params, prompt, images)
    busy, fams = moe_profile(
        torch, power, lambda: decode(params, state, toks[..., :1], images),
        decode_ms, f"{arch} decode step", serving=True)
    if check is not None:
        check(params, prompt)
    del params, state
    torch.cuda.empty_cache()
    witness = f32_witness(torch, seed, arch, cfg, prompt, toks, images)
    return {"launches": launches, "routes": routes,
            "prefill_ms": prefill_s * 1e3, "decode_ms": decode_ms,
            "decode_busy_ms": busy,
            "decode_idle_share": None if busy is None
            else 1 - busy / decode_ms,
            "decode_device_ms_by_family": {f: ms for f, (ms, _) in
                                           fams.items()},
            "witness": witness, "tokens": toks}


def phase_vlm(torch, seed, power):
    """Phase 20: llama-3.2-vision-11b training (f32 images; one step with
    bf16 images) and serving with images, at full width and VLM_BLOCKS of
    its 8 super-blocks."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import superblock_layout
    t0 = time.perf_counter()
    full = get_arch(VLM_ARCH)
    cfg = dataclasses.replace(
        full, n_layers=VLM_BLOCKS * full.cross_attn_every)
    layout = superblock_layout(cfg, "vlm")
    if cfg.segments != (("vlm", VLM_BLOCKS),) or layout[:4] != (
            ("cross", "cross"), ("cross_ffn", "mlp"), ("attn1", "attn"),
            ("ffn1", "mlp")) or len(layout) != 10:
        raise AssertionError(f"{VLM_ARCH}: segments {cfg.segments}, layout "
                             f"{layout}")
    reduced = ([] if cfg.n_layers == full.n_layers else
               [f"n_layers {full.n_layers} -> {cfg.n_layers} ({VLM_BLOCKS} "
                f"of {full.n_layers // full.cross_attn_every} super-blocks)"])
    widths = (f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
              f"{cfg.n_kv_heads} kv heads of {cfg.head_dim}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}, rope_theta "
              f"{cfg.rope_theta:g}; cross-attention every "
              f"{cfg.cross_attn_every} layers over {cfg.n_image_tokens} "
              f"image tokens (f32); layout {tuple(n for n, _ in layout)}")
    train = train_family(torch, seed, power, VLM_ARCH, cfg, reduced,
                         VLM_STEPS, *vlm_want(cfg, "fma"), widths,
                         shape=VLM_BATCH)
    bf16 = vlm_bf16_images_step(torch, seed, cfg, train["losses"][0])
    # serving with images: the prefill's cross-attention on fma (its q
    # promoted to the f32 images' dtype) and self-attention on mma; each
    # decode step's cross sub-layers recompute their keys and values from
    # the images, as JAX's do, and attend on the decode route with no
    # kv_len, the self-attention over the cache
    N = SERVE_VLM[2]
    n_self, n_cross = sub_calls(cfg, "attn"), sub_calls(cfg, "cross")
    serve = serve_dense(torch, seed, power, VLM_ARCH, cfg, {
        "fma": n_cross, "mma": n_self, "decode": (N - 1) * (n_self + n_cross)},
        SERVE_VLM)
    print(f"  phase 20 took {time.perf_counter() - t0:.1f} s")
    return {"train": train, "bf16_images": bf16, "serve": serve}


# --------------------------- the audio musicgen-medium (phases 2 and 21)

MUSICGEN_ARCH = "musicgen-medium"
MUSICGEN_STEPS = 3
MUSICGEN_BATCH = (4, 1024)  # 4 rows of 1024 frames, each of 4 codebooks
SERVE_MUSICGEN = (4, 512, 32)  # batch, prompt frames, new frames
MUSICGEN_ATTN = "train musicgen H=K=24 hd=64"
MUSICGEN_HEAD = "musicgen N=4096 D=1536 V=2048"
# matrices of two or three dims besides the heads: the (4, 2048, 1536)
# codebook embedding, wq, wk, wv, wo, w_gate, w_up, w_down
MUSICGEN_MATRICES = 8


def musicgen_want(cfg):
    """(launches, routes) of one musicgen train step: ``train_want``'s,
    with each xent kernel once a codebook head; the (4, 1536, 2048) heads
    are one 3-D leaf, so one momentum_sumsq."""
    C = cfg.n_codebooks
    want, want_r = train_want(cfg.n_layers, "mma", MUSICGEN_MATRICES)
    want.update({k: C for k in XENT_KERNELS})
    want_r.update({"xent_fwd": {"wgmma": C}, "xent_bwd_dh": {"mma": C},
                   "xent_bwd_dw": {"mma": C}})
    return want, want_r


def musicgen_greedy(cfg, params, prompt):
    """Phase 21 (iii): ``greedy_generate`` on a (B, 4, 16) prompt keeps
    JAX's shape (B, n, 1): the last codebook's argmax fed back to every
    codebook (ROADMAP.md caveat 15)."""
    from repro_torch.training import greedy_generate
    out = greedy_generate(cfg, params, prompt[..., :16], 4, 32)
    if tuple(out.shape) != (prompt.shape[0], 4, 1):
        raise AssertionError(f"{MUSICGEN_ARCH} greedy_generate: "
                             f"{tuple(out.shape)}")
    print(f"  {MUSICGEN_ARCH} greedy_generate on a (B, 4, 16) prompt, 4 "
          f"steps: {tuple(out.shape)} (the last codebook's argmax fed back "
          "to every codebook, as JAX's)")


def phase_musicgen(torch, seed, power):
    """Phase 21: musicgen-medium training and serving at full width and
    all 48 layers."""
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    cfg = get_arch(MUSICGEN_ARCH)
    if cfg.segments != (("dense", 48),) or cfg.n_codebooks != 4:
        raise AssertionError(f"{MUSICGEN_ARCH}: segments {cfg.segments}")
    widths = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
              f"{cfg.n_codebooks} codebooks of {cfg.vocab_size}: a (4, "
              f"{cfg.padded_vocab}, {cfg.d_model}) embedding summed over "
              "the codebooks and 4 heads")
    train = train_family(torch, seed, power, MUSICGEN_ARCH, cfg, [],
                         MUSICGEN_STEPS, *musicgen_want(cfg), widths,
                         shape=MUSICGEN_BATCH)
    # (B, 4, 1) tokens in, each codebook's argmax of its (B, 4, 1, V)
    # logits out
    L, N = cfg.n_layers, SERVE_MUSICGEN[2]
    serve = serve_dense(torch, seed, power, MUSICGEN_ARCH, cfg,
                        {"mma": L, "decode": (N - 1) * L}, SERVE_MUSICGEN,
                        check=lambda p, prompt: musicgen_greedy(cfg, p,
                                                                prompt))
    print(f"  phase 21 took {time.perf_counter() - t0:.1f} s")
    return {"train": train, "serve": serve}


# ----------------------------------- phase 22: MoE and MLA on a mesh

MESH_TOKENS = (16, 256)  # the two-rank layers' batch: phases 16-17's
# Phase 22 (i) holds each rank's MoE layer (``layers.moe_local`` over its
# half of the experts, the combine's partial outputs and the dispatch's
# and combine's partial gradients summed by the eager all-reduce) against
# its slice of one rank's unsharded ``apply_moe`` on the same tensors. Both
# route alike (the same router product of the same tokens), so f32 differs
# only where a sum is split: the combine's two partials, the two partial
# d(x) and d(top_w), and the expert products batched over half the experts,
# which cuBLAS may sum in another order: MESH_F32_TOL of each tensor's
# largest |ref| + MESH_F32_TOL relative (tests/test_torch_moe.py's f32
# bound). In bf16 each tensor's distance from one rank's bf16 layer is
# held within SERVE_BF16_FLOOR_X times its floor, phase 16's rule: the
# distance of that layer from its f32 twin (the same bf16-rounded weights
# and tokens in f32).
MESH_F32_TOL = 1e-5
MESH_AUX_W = 1.0  # the aux's weight in the checked objective
MESH_TIMING_ITERS = 5
# MLA's attention at the train shape with its 128 heads over "model": each
# rank runs 64 through the sharded flash_attention (fma), against its slice
# of the unsharded call: the kernels run each head alone, so bitwise is
# expected; phase 2's bf16 attention bound (2e-2 + 2e-2 |ref|) is checked
MESH_ATTN_TOL = 2e-2


def _err_over_tol(got, want):
    """max |got - want| / (MESH_F32_TOL * (max |want| + |want|))."""
    want = want.float()
    tol = MESH_F32_TOL * (want.abs().max() + want.abs())
    return ((got.float() - want).abs() / tol).max().item()


def _in_turns(torch, rank, fn):
    """fn() on one of two ranks at a time (the other waits), its result on
    that rank: a peak of memory, or a time, of one rank alone."""
    import torch.distributed as dist
    res = None
    for turn in range(2):
        dist.barrier()
        if turn == rank:
            res = fn()
            torch.cuda.synchronize()
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def _moe_layer_two_ranks(torch, rank, seed, mesh, cfg):
    """Phase 22 (i), one rank's MoE layer of ``cfg`` at full width on a (1,
    2) mesh: f32 and bf16 against one rank's unsharded layer, and the
    per-rank times of the expert products and of the all-reduce."""
    import torch.distributed as dist
    from repro_torch.models import layers as L
    B, S = MESH_TOKENS
    D, E = cfg.d_model, cfg.n_experts
    G, Tg, C = L.moe_groups(cfg, B * S)
    El = E // 2
    e0, e1 = rank * El, (rank + 1) * El
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # one draw rounded to bf16: the f32 and the bf16 layers hold one value
    w = {n: ((0.006 if s.init == "small" else 0.02) * torch.randn(
        s.shape, generator=gen, device="cuda")).to(bf)
        for n, s in L.moe_spec(cfg).items()}
    x = torch.randn((B, S, D), generator=gen, device="cuda").to(bf)
    r = torch.randn((B, S, D), generator=gen, device="cuda")
    red = L.moe_reduce(mesh, ("model",), ())
    experts = ("w_gate", "w_up", "w_down")
    shared = [n for n in w if n.startswith("shared_")]

    def grads_of(y, aux, xt, leaves):
        g = torch.autograd.grad((y.float() * r).sum() + MESH_AUX_W * aux,
                                [xt, *leaves.values()])
        return {"y": y.detach(), "aux": aux.detach(),
                **dict(zip(["x", *leaves], g))}

    def sharded(dt):
        """This rank's layer: its experts through moe_local and the
        all-reduce; the shared expert whole on each rank."""
        leaves = {n: (w[n][e0:e1] if n in experts else w[n]).to(dt)
                  .detach().requires_grad_() for n in w}
        xt = x.to(dt).detach().requires_grad_()
        y, aux = L.moe_local(leaves, cfg, xt.reshape(G, Tg, D), (e0, e1),
                             red)
        y = y.reshape(B, S, D)
        if shared:
            y = y + L.shared_experts(leaves, xt)
        return grads_of(y, aux, xt, leaves)

    def whole(dt):
        """One rank's unsharded apply_moe; its experts' gradients cut to
        this rank's slice."""
        leaves = {n: v.to(dt).detach().requires_grad_()
                  for n, v in w.items()}
        xt = x.to(dt).detach().requires_grad_()
        out = grads_of(*L.apply_moe(leaves, cfg, xt), xt, leaves)
        for n in experts:
            out[n] = out[n][e0:e1].clone()
        return out

    def in_turns(fn):
        return _in_turns(torch, rank, fn)

    out = {"shape": {"G": G, "Tg": Tg, "C": C, "experts": (e0, e1)}}
    got = sharded(torch.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    f32 = in_turns(lambda: whole(torch.float32))
    out["f32_err_over_tol"] = {k: _err_over_tol(got[k], f32[k])
                               for k in f32}
    out["own_widths"] = {n: tuple(got[n].shape) for n in experts}
    del got
    torch.cuda.empty_cache()
    got = sharded(bf)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def bf16_errs():
        want = whole(bf)
        res = {}
        for k, ref in want.items():
            floor = (ref.float() - f32[k].float()).abs().max().item()
            err = (got[k].float() - ref.float()).abs().max().item()
            res[k] = {"err": err, "floor": floor,
                      "over_bound": err / (SERVE_BF16_FLOOR_X * floor)
                      if floor else (0.0 if err == 0 else math.inf)}
        return res
    out["bf16"] = in_turns(bf16_errs)
    del got, f32
    torch.cuda.empty_cache()

    # per-rank times, bf16: this rank's expert products on its (G, E/2, C,
    # D) buffer, forward and backward, each rank alone; then the combine's
    # all-reduce of a (G, Tg, D) partial, both ranks
    mine = {n: w[n][e0:e1].detach().requires_grad_() for n in experts}
    xe = torch.randn((G, El, C, D), generator=gen, device="cuda").to(
        bf).requires_grad_()

    def products():
        h = (torch.nn.functional.silu(torch.einsum(
            "gecd,edf->gecf", xe, mine["w_gate"]))
            * torch.einsum("gecd,edf->gecf", xe, mine["w_up"]))
        ye = torch.einsum("gecf,efd->gecd", h, mine["w_down"])
        torch.autograd.grad(ye, [xe, *mine.values()], ye)

    out["experts_ms"] = in_turns(lambda: time_ms(
        torch, products, MESH_TIMING_ITERS, warm=2))
    part = torch.randn((G, Tg, D), generator=gen, device="cuda").to(bf)
    group = mesh.get_group("model")
    ms = []
    for _ in range(MESH_TIMING_ITERS + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(part, group=group)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["all_reduce_ms"] = min(ms[1:])
    out["all_reduce_bytes"] = part.numel() * part.element_size()
    del w, mine, xe, part
    torch.cuda.empty_cache()
    return out


def _attn_plain_over_tol(torch, name, got, want, dtype):
    """A kernel's output against its plain version's on the same inputs,
    at phase 2's bounds: -> (max abs error, largest error over its
    element's tolerance). ``got``/``want``: (out, lse) for mha_fwd, (dK,
    dV) for mha_bwd_dkv, dQ for mha_bwd_dq."""
    tag = str(dtype).replace("torch.", "")
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = over = 0.0
    for i, (a, b) in enumerate(pairs):
        a, b = a.float(), b.float()
        if not bool(torch.isfinite(a).all()):
            return math.inf, math.inf
        if name == "mha_fwd" and i == 1:  # lse
            tol = LSE_ATOL + LSE_RTOL * b.abs()
        elif name == "mha_fwd":
            tol = (F32_OUT_ATOL if tag == "float32"
                   else BF16_OUT_ATOL + BF16_OUT_RTOL * b.abs())
        else:
            tol = (BWD_SCALE_ATOL[tag] * b.abs().max()
                   + BWD_RTOL[tag] * b.abs())
        d = (a - b).abs()
        err = max(err, d.max().item())
        over = max(over, (d / tol).max().item())
    return err, over


def _attention_two_ranks(torch, rank, seed, mesh, shape, dtypes, causal):
    """Phases 22 and 24 (i): an attention of ``shape`` (B, S, T, H, K, hd,
    hdv) with its heads over "model": this rank's H/2 query heads over
    K/2 kv heads through the sharded flash_attention, forward and backward
    (counted), in each of ``dtypes`` (one draw rounded to bf16, so every
    dtype holds one value), against its slice of the unsharded call on the
    same tensors. The kernels compute each head alone, so bitwise is
    expected; where not, f32 is held within MESH_F32_TOL (``_err_over_tol``)
    and bf16 within SERVE_BF16_FLOOR_X times its floor, the distance of the
    unsharded bf16 call from the unsharded f32 call, where f32 runs too,
    else within phase 2's bf16 bound (MESH_ATTN_TOL + MESH_ATTN_TOL |ref|).
    Then, each rank alone, the three kernels at the rank's heads against
    their plain versions on the same inputs (phase 2's bounds), timed
    beside the unsharded call, the plain version, SDPA on the same heads
    and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.attention import (_fwd_route,
                                                         mha_bwd_dkv,
                                                         mha_bwd_dq, mha_fwd)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref,
                                                   mha_fwd_ref)
    from repro_torch.models.sharding import NamedSharding, P, place
    B, S, T, H, K, hd, hdv = shape
    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, torch.bfloat16, hdv)
    do = torch.randn((B, S, H, hdv), generator=gen,
                     device="cuda").to(torch.bfloat16)
    kw = dict(scale=hd ** -0.5, causal=causal)
    sh = NamedSharding(mesh, P(None, None, "model", None))
    plan = dispatch.attn_route(q.shape, k.shape, sh, sh)[1]

    def tag(dt):
        return str(dt).replace("torch.", "")

    def run(dt, sharded):
        ts = [t.to(dt) for t in (q, k, v)]
        g = do.to(dt)
        if sharded:
            ts, g = [place(t, sh) for t in ts], place(g, sh)
        ts = [t.detach().requires_grad_() for t in ts]
        o = dispatch.flash_attention(
            *ts, **kw, **({"q_sharding": sh, "kv_sharding": sh}
                          if sharded else {}))
        res = [o, *torch.autograd.grad(o, ts, g)]
        # a rank's shard, or the same slice of the unsharded call
        return [t.to_local() if sharded else place(t, sh).to_local()
                for t in res]

    zero_train_counts()
    zero_route_counts()
    got = {dt: run(dt, True) for dt in dtypes}
    torch.cuda.synchronize()
    launches, routes = train_counts(), route_counts()
    want = _uncounted(lambda: {dt: run(dt, False) for dt in dtypes})
    errs = {}
    for dt in dtypes:
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            a, b = got[dt][i].float(), want[dt][i].float()
            err = (a - b).abs().max().item()
            e = errs[f"{name} {tag(dt)}"] = {
                "bitwise": bool(torch.equal(got[dt][i], want[dt][i])),
                "err": err}
            if dt == f32:
                e["over_bound"] = _err_over_tol(a, b)
            elif f32 in dtypes:
                floor = (b - want[f32][i].float()).abs().max().item()
                e["over_bound"] = (err / (SERVE_BF16_FLOOR_X * floor)
                                   if floor else
                                   (0.0 if err == 0 else math.inf))
            else:
                e["over_bound"] = ((a - b).abs() / (
                    MESH_ATTN_TOL * (1 + b.abs()))).max().item()
    Hl, Kl = got[dtypes[0]][0].shape[2], got[dtypes[0]][2].shape[2]
    local = {dt: [place(t.to(dt), sh).to_local().contiguous()
                  for t in (q, k, v, do)] for dt in dtypes}
    kernel_routes = {tag(dt): _fwd_route(*local[dt][:3]) for dt in dtypes}
    del got, want

    def timing():
        rows = []
        for dt in dtypes:
            ql, kl, vl, dol = local[dt]
            whole = [t.to(dt) for t in (q, k, v, do)]
            o_l, lse = mha_fwd(ql, kl, vl, None, **kw)
            delta = (dol.float() * o_l.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            args = (ql, kl, vl, dol, lse, delta, None)
            o_w, lse_w = mha_fwd(*whole[:3], None, **kw)
            delta_w = (whole[3].float() * o_w.float()).sum(-1) \
                .transpose(1, 2).contiguous()
            args_w = (*whole, lse_w, delta_w, None)
            qt = ql.transpose(1, 2).contiguous().requires_grad_()
            kt, vt = (t.transpose(1, 2).repeat_interleave(Hl // Kl, 1)
                      .contiguous().requires_grad_() for t in (kl, vl))
            backend, ctx = _sdpa_backend(torch, qt, kt, vt)
            with ctx():
                so = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=kw["scale"])
                sdpa = {"mha_fwd": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, scale=kw["scale"]),
                    5, warm=2),
                    "bwd": time_ms(torch, lambda: torch.autograd.grad(
                        so, [qt, kt, vt], dol.transpose(1, 2),
                        retain_graph=True), 5, warm=2)}
            el = 4 if dt == f32 else 2
            peak = F32_FLOPS_PER_S if dt == f32 else BF16_FLOPS_PER_S
            for name, fn, fn_w, plain in (
                    ("mha_fwd", lambda: mha_fwd(ql, kl, vl, None, **kw),
                     lambda: mha_fwd(*whole[:3], None, **kw),
                     lambda: mha_fwd_ref(ql, kl, vl, None, **kw)),
                    ("mha_bwd_dq", lambda: mha_bwd_dq(*args, **kw),
                     lambda: mha_bwd_dq(*args_w, **kw),
                     lambda: mha_bwd_dq_ref(*args, **kw)),
                    ("mha_bwd_dkv", lambda: mha_bwd_dkv(*args, **kw),
                     lambda: mha_bwd_dkv(*args_w, **kw),
                     lambda: mha_bwd_dkv_ref(*args, **kw))):
                err, over = _attn_plain_over_tol(torch, name, fn(), plain(),
                                                 dt)
                bound, by = (
                    attention_bound_ms(B, S, T, Hl, Kl, hd, causal, None, el,
                                       hdv, peak=peak) if name == "mha_fwd"
                    else bwd_bound_ms(B, S, T, Hl, Kl, hd, causal, None, el,
                                      name, hdv, peak=peak))
                rows.append({
                    "name": name, "dtype": tag(dt),
                    "route": kernel_routes[tag(dt)],
                    "plain_err": err, "plain_over_tol": over,
                    "ms": time_ms(torch, fn, 5, warm=2),
                    "unsharded_ms": time_ms(torch, fn_w, 5, warm=2),
                    "plain_ms": time_ms(torch, plain, 2, warm=1),
                    "bound_ms": bound, "bound_by": by,
                    "library_ms": sdpa["mha_fwd" if name == "mha_fwd"
                                       else "bwd"],
                    "library_note": "F.scaled_dot_product_attention, "
                                    f"{backend} backend" + (
                                        f", kv repeated to {Hl} heads"
                                        if Hl != Kl else "") + (
                                        "" if name == "mha_fwd" else
                                        ", backward (dQ, dK, dV together)")})
            del whole, o_w, lse_w, delta_w, args_w, qt, kt, vt, so
            torch.cuda.empty_cache()
        return rows
    rows = _in_turns(torch, rank, lambda: _uncounted(timing))
    return {"plan": (plan.batch_axes, plan.head_axes), "heads": (Hl, Kl),
            "routes": routes, "kernel_routes": kernel_routes,
            "launches": launches, "errs": errs, "times": rows}


def _attention_two_ranks_report(power, rank, label, c, want_routes):
    """Prints one rank's ``_attention_two_ranks`` result and checks it:
    every tensor within its bound of the unsharded slice, every kernel
    within phase 2's bound of its plain version, the heads over "model"
    and the kernels on ``want_routes`` ({dtype: route})."""
    worst = max(e["over_bound"] for e in c["errs"].values())
    plain = max(t["plain_over_tol"] for t in c["times"])
    print(f"  rank {rank} {label}, plan batch {c['plan'][0]} x heads "
          f"{c['plan'][1]}: {c['heads'][0]} query heads over "
          f"{c['heads'][1]} kv heads a rank, routes {c['kernel_routes']}; "
          f"out, dQ, dK, dV against one rank's slice: "
          + ", ".join(f"{k} {e['err']:.3e}"
                      + (" (bitwise)" if e["bitwise"] else "")
                      for k, e in c["errs"].items())
          + f"; worst over its bound {worst:.3f}; launches by route "
          f"{ {k: c['routes'][k] for k in ('mha_fwd', *BWD_KERNELS)} }")
    for t in c["times"]:
        print(f"  [{power}] rank {rank} {t['name']} {t['dtype']} on "
              f"{t['route']} at {c['heads'][0]} heads: {t['ms']:.4f} ms "
              f"(all heads {t['unsharded_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']}"
              f"{' at the f32 peak' if t['dtype'] == 'float32' else ''}"
              f", {t['bound_ms'] / t['ms']:.4f} of it; plain "
              f"{t['plain_ms']:.4f} ms, max abs error against it "
              f"{t['plain_err']:.3e}, {t['plain_over_tol']:.3f} of phase "
              f"2's bound; {t['library_note']} {t['library_ms']:.4f} ms)")
    if not (worst <= 1.0 and plain <= 1.0
            and c["plan"] == ((), ("model",))
            and c["kernel_routes"] == want_routes):
        raise AssertionError(f"rank {rank}: the sharded {label} disagrees "
                             "with one rank's or with the plain version, or "
                             "its plan or routes are not the expected ones")


def _two_rank_moe_checks(torch, rank, seed):
    """Rank ``rank``'s part of phase 22 (i) on a (1, 2) mesh: dbrx-132b's
    and deepseek-v3's MoE layers at full width (phase 17's 64 experts)
    through ``layers.moe_local`` with the eager all-reduce, and MLA's
    attention with its heads over "model"."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2, device_type="cuda")
    print(f"  rank {rank}: mesh up", flush=True)
    out = {}
    for arch, over in ((MOE_ARCH, {}),
                       (MLA_ARCH, {"n_experts": MLA_TRAIN_EXPERTS})):
        cfg = dataclasses.replace(get_arch(arch), **over)
        out[arch] = _moe_layer_two_ranks(torch, rank, seed, mesh, cfg)
        print(f"  rank {rank}: {arch}'s MoE layer done", flush=True)
    out["mla"] = _attention_two_ranks(torch, rank, seed + 22, mesh,
                                      MLA_ATTN[MLA_TRAIN_ATTN],
                                      (torch.bfloat16,), True)
    print(f"  rank {rank}: MLA's attention done", flush=True)
    return out


def phase_mesh_two_ranks(torch, seed, power):
    """Phase 22 (i): two ranks on the one card, each rank's results
    printed and checked. -> {"launches": the two ranks' launches on the
    sharded attention, summed}."""
    import dataclasses
    from repro_torch.configs import get_arch
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    got = spawn_two_ranks(seed, "moe", 900)
    for arch, over in ((MOE_ARCH, {}),
                       (MLA_ARCH, {"n_experts": MLA_TRAIN_EXPERTS})):
        cfg = dataclasses.replace(get_arch(arch), **over)
        for rank, res in sorted(got.items()):
            r = res[arch]
            sh = r["shape"]
            f32 = r["f32_err_over_tol"]
            worst16 = max(v["over_bound"] for v in r["bf16"].values())
            print(f"  rank {rank} {arch} MoE layer (d_model {cfg.d_model}, "
                  f"{cfg.n_experts} experts top-{cfg.top_k}, moe_d_ff "
                  f"{cfg.moe_d_ff}, {cfg.n_shared_experts} shared; "
                  f"{MESH_TOKENS[0]} x {MESH_TOKENS[1]} tokens: {sh['G']} "
                  f"groups of {sh['Tg']}, capacity {sh['C']}) experts "
                  f"{sh['experts']} (widths {r['own_widths']}): f32 error "
                  f"over tolerance ({MESH_F32_TOL:g} of max|ref| + "
                  f"{MESH_F32_TOL:g} relative) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in f32.items()))
            print(f"    bf16 error / floor: " + ", ".join(
                f"{k} {v['err']:.3e} / {v['floor']:.3e}"
                for k, v in r["bf16"].items())
                + f"; worst over {SERVE_BF16_FLOOR_X:g} x floor "
                f"{worst16:.3f}")
            print(f"  [{power}] rank {rank} {arch}: its expert products "
                  f"(forward and backward, bf16, {cfg.n_experts // 2} "
                  f"experts) {r['experts_ms']:.3f} ms alone; the combine's "
                  f"all-reduce of {r['all_reduce_bytes'] / 2**20:.1f} MiB "
                  f"over gloo {r['all_reduce_ms']:.3f} ms (host clock)")
            if not (max(f32.values()) <= 1.0 and worst16 <= 1.0):
                raise AssertionError(f"rank {rank}: {arch}'s sharded MoE "
                                     "layer disagrees with one rank's")
            if r["own_widths"]["w_gate"][0] != cfg.n_experts // 2:
                raise AssertionError(f"rank {rank}: {arch}'s experts are "
                                     "not half on each rank")
    launches = {}
    for rank, res in sorted(got.items()):
        m = res["mla"]
        _attention_two_ranks_report(power, rank,
                                    f"MLA attention {MLA_TRAIN_ATTN}", m,
                                    {"bfloat16": "fma"})
        for k, n in m["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return {"launches": launches}


def mesh_steps(torch, seed, power, label, cfg, steps, want, want_r, ref,
               ref_phase, leaf, bitwise=False):
    """``steps`` steps of ``make_train_step(rules, mesh)`` on a (1, 1) NCCL
    mesh (the process group already up) at the cut ``cfg`` of phase
    ``ref_phase``, from its weights and batches: each step's launches by
    route ``want``/``want_r`` (that phase's), the losses and aux against
    ``ref`` (its results; ``bitwise``: equal, else within LOSS_CURVE_ATOL),
    the step time, idle share and peak beside its; ``leaf``'s layout
    printed."""
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.models.model import flatten, place_params
    from repro_torch.models.sharding import Rules
    from repro_torch.training import init_state, make_train_step
    mesh = make_host_mesh(1, 1, device_type="cuda")
    torch.cuda.empty_cache()
    B, S = ref["shape"]
    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(steps)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tx = make_optimizer("scale_fused", linear_warmup_cosine(1e-3, steps))
    params = place_params(init_params(cfg, gen, device="cuda"), cfg, mesh)
    step = make_train_step(cfg, tx, clip_norm=1.0, rules=Rules(), mesh=mesh)
    state = init_state(params, tx)
    del params
    state, per_step, per_route, secs, mets, peak = _step_counts(
        torch, step, state, batches)
    launches = train_counts()
    _check_steps(per_step, per_route, want, want_r, label)
    losses = [m["loss"] for m in mets]
    auxs = [m["aux"] for m in mets]
    gap = max(max(abs(a - b), abs(x - y)) for a, b, x, y in
              zip(losses, ref["losses"], auxs, ref["aux"]))
    same = losses == ref["losses"] and auxs == ref["aux"]
    step_s = min(secs[1:])
    lay = str(tuple(flatten(state.params)[leaf].placements))
    print(f"  {label} (parameters DTensors; {leaf} {lay}): losses "
          f"{' '.join(f'{x:.6f}' for x in losses)}, aux "
          f"{' '.join(f'{x:.6f}' for x in auxs)}; unsharded (phase "
          f"{ref_phase}) {' '.join(f'{x:.6f}' for x in ref['losses'])}, aux "
          f"{' '.join(f'{x:.6f}' for x in ref['aux'])} (max |diff| "
          f"{gap:.3e}{', bitwise' if same else ''}; "
          f"{'bitwise required' if bitwise else f'tol {LOSS_CURVE_ATOL:g}'})")
    if not (all(map(math.isfinite, losses + auxs))
            and (same if bitwise else gap <= LOSS_CURVE_ATOL)):
        raise AssertionError(f"{label}: the steps leave the unsharded "
                             "curve")

    def one():
        nonlocal state
        state, _ = step(state, batches[0])
    busy, _ = moe_profile(torch, power, one, step_s * 1e3,
                          f"{label} train step")
    idle = None if busy is None else 1 - busy / (step_s * 1e3)
    print(f"  [{power}] {label}: train step {step_s * 1e3:.3f} ms (best of "
          f"steps 2-{steps}), idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}, peak "
          f"{peak / 2**20:.1f} MiB; unsharded {ref['step_ms']:.3f} ms, idle "
          f"share {ref['idle_share'] if ref['idle_share'] is None else round(ref['idle_share'], 3)}, "
          f"peak {ref['peak_mib']:.1f} MiB")
    del state, step, tx
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step[0],
            "routes": per_route[0], "losses": losses, "aux": auxs,
            "loss_gap": gap, "bitwise": same, "step_ms": step_s * 1e3,
            "idle_share": idle, "busy_ms": busy, "peak_mib": peak / 2**20}


def nccl_world():
    """A process group of one rank under NCCL (for a (1, 1) mesh); the
    caller destroys it."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)


def mesh_train(torch, seed, power, cuts, same):
    """(ii) of phases 22-24: ``make_train_step(rules, mesh)`` on a (1, 1)
    NCCL mesh at each of ``cuts``, (arch, cfg, steps, (want, want_r), ref,
    phase, leaf, (B, S)): the cut of phase ``phase`` whose results are
    ``ref``, from its weights and batches, through ``mesh_steps``.
    ``same``: the losses and aux bitwise theirs and each step's launches
    by route theirs. -> {arch: ``mesh_steps``' result}."""
    import torch.distributed as dist
    nccl_world()
    out = {}
    try:
        for arch, cfg, steps, want, ref, phase, leaf, shape in cuts:
            label = f"{arch} on a (1, 1) mesh"
            r = out[arch] = mesh_steps(
                torch, seed, power, label, cfg, steps, *want,
                {**ref, "shape": shape}, phase, leaf, bitwise=same)
            if same and (r["per_step"] != ref["per_step"]
                         or r["routes"] != ref["routes"]):
                raise AssertionError(f"{label}: launches by route "
                                     f"{r['per_step']} {r['routes']}, phase "
                                     f"{phase}'s {ref['per_step']} "
                                     f"{ref['routes']}")
        return out
    finally:
        dist.destroy_process_group()


def mesh_phase(torch, seed, power, phase, two_ranks, cuts, same):
    """Phases 22-24: (i) ``two_ranks()`` (two ranks on the one card: ->
    {"launches": ..., and what else the phase reports}), (ii)
    ``mesh_train`` at ``cuts``. The path's launches: (i)'s and (ii)'s
    steps', each from counts set to 0 just before it. -> (i)'s result
    with "launches" summed over both and "train" (ii)'s."""
    t0 = time.perf_counter()
    out = two_ranks(torch, seed, power)
    out["train"] = mesh_train(torch, seed, power, cuts, same)
    for r in out["train"].values():
        for k, n in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
    print(f"  phase {phase} took {time.perf_counter() - t0:.1f} s")
    return out


def phase_mesh(torch, seed, power, moe, mla):
    """Phase 22: MoE and MLA on a mesh: (i) two ranks on the one card, (ii)
    the sharded train steps of phases 16's and 17's cuts on a (1, 1) mesh,
    each step's launches by route as those phases', the losses and aux
    against theirs, the step time, idle share and peak beside theirs."""
    import dataclasses
    from repro_torch.configs import get_arch
    cuts = []
    for arch, cfg, steps, route, n_mat, ref, phase in (
            (MOE_ARCH, dataclasses.replace(get_arch(MOE_ARCH),
                                           n_layers=MOE_LAYERS),
             MOE_STEPS, "mma", 6, moe["train"], 16),
            (MLA_ARCH, dataclasses.replace(
                get_arch(MLA_ARCH), n_layers=MLA_LAYERS,
                n_experts=MLA_TRAIN_EXPERTS), MLA_STEPS, "fma", 18,
             mla["train"], 17)):
        seg = f"seg{len(cfg.segments) - 1}_moe"
        cuts.append((arch, cfg, steps, train_want(cfg.n_layers, route, n_mat),
                     ref, phase, f"segments/{seg}/ffn/w_gate", MESH_TOKENS))
    return mesh_phase(torch, seed, power, 22, phase_mesh_two_ranks, cuts,
                      same=False)


# --------------------------- phase 23: Mamba2 and the hybrid on a mesh

# Phase 23 (i) holds each rank's Mamba2 layer (``layers.mamba_local`` on
# its half of the heads: its z, x and dt columns and the one group's B
# and C, the gated norm's sum of squares, out_proj's partial output and
# x's partial gradient summed by the eager all-reduce, the whole leaves'
# partial gradients summed likewise) against one rank's unsharded
# ``apply_mamba`` on the same tensors, at phase 18's 4 x 1024 tokens. f32
# differs only where a sum is split (out_proj's and the norm's two halves,
# d(x), the B and C gradients) or cuBLAS picks another order for half the
# columns: each tensor within MESH_F32_TOL, phase 22's bound, or within
# SERVE_BF16_FLOOR_X times its f32 floor, the distance of the unsharded
# f32 layer from its float64 twin (``f64_casts``). The floor is there for
# the (nh,) leaves: A_log's, dt_bias's and D's gradients sum, per head,
# terms of both signs over every position and every pair of positions of
# a chunk (some 2^19 at 4 x 1024 tokens and chunk 256), so any change of
# order moves them by tens of f32 ulps of their size. bf16: within
# SERVE_BF16_FLOOR_X times its floor, phase 22's rule. jamba's layer (d_model 8192, 256 heads)
# keeps the 4096 tokens: its largest operands are the whole leaves and
# their f32 gradients (in_proj 1.09 GB, out_proj 0.54 GB, each twice) and
# the SSD's (4, 4, heads, 256, 256) f32 blocks, 0.54 GB a block at 128
# heads and 1.07 GB at 256, a few of them live at once: under 20 GB a
# rank, one rank's unsharded layer run at a time.
MAMBA_MESH_ARCHS = (MAMBA_ARCH, JAMBA_ARCH)
MAMBA_MESH_LEAVES = ("in_proj", "out_proj")  # timed alone; the rest as one


def f64_casts(torch):
    """A patch of ``torch.Tensor.float`` that leaves a float64 tensor as it
    is: under it the model's f32 steps (JAX's casts) stay float64, so a
    layer on float64 operands is its float64 twin."""
    from unittest import mock
    real = torch.Tensor.float

    def float_(self, *args, **kw):
        return self if self.dtype == torch.float64 else real(self, *args,
                                                               **kw)
    return mock.patch.object(torch.Tensor, "float", float_)


def _allreduce_ms(torch, mesh, t):
    """The host-clock ms of one eager all-reduce of ``t`` over "model"
    (best of MESH_TIMING_ITERS after one), both ranks in step."""
    import torch.distributed as dist
    group = mesh.get_group("model")
    ms = []
    for _ in range(MESH_TIMING_ITERS + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return min(ms[1:])


def _mamba_layer_two_ranks(torch, rank, seed, mesh, cfg):
    """Phase 23 (i), one rank's Mamba2 layer of ``cfg`` at full width on a
    (1, 2) mesh: its half of the heads in f32 and bf16 against one rank's
    unsharded layer, the widths its SSD saw, the SSD's per-rank time and
    each collective's bytes and host-clock time."""
    from unittest import mock
    from repro_torch.models import layers as L
    from repro_torch.models.model import _init_leaf
    from repro_torch.models.sharding import grad_psum
    B, S = MAMBA_BATCH
    D, nh, hd = cfg.d_model, cfg.ssm_nheads, cfg.ssm_headdim
    heads = (rank * nh // 2, (rank + 1) * nh // 2)
    axes = ("model",)
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # one draw by init_params' rules, rounded to bf16: the f32 and the bf16
    # layers hold one value
    w = {n: _init_leaf(s, gen).to(device="cuda", dtype=bf)
         for n, s in L.mamba_spec(cfg).items()}
    x = torch.randn((B, S, D), generator=gen, device="cuda").to(bf)
    r = torch.randn((B, S, D), generator=gen, device="cuda")
    seen = []
    real_ssd = L._ssd_chunked

    def ssd(xh, *args):
        seen.append(tuple(xh.shape))
        return real_ssd(xh, *args)

    def grads_of(y, xt, leaves):
        g = torch.autograd.grad((y.float() * r).sum(), [xt, *leaves.values()])
        return {"y": y.detach(), **dict(zip(["x", *leaves], g))}

    def sharded(dt):
        """This rank's heads through mamba_local and the all-reduces; the
        whole leaves' partial gradients summed (the gather's backward of
        the DTensor route)."""
        leaves = {n: v.to(dt).detach().requires_grad_() for n, v in w.items()}
        xt = x.to(dt).detach().requires_grad_()
        whole = {n: grad_psum(v, mesh, axes) for n, v in leaves.items()}
        with mock.patch.object(L, "_ssd_chunked", ssd):
            y, _ = L.mamba_local(L.mamba_slices(whole, cfg, heads), cfg, xt,
                                 heads=heads,
                                 reduce=L.mamba_reduce(mesh, axes))
        return grads_of(y, xt, leaves)

    def whole(dt):
        """One rank's unsharded apply_mamba."""
        leaves = {n: v.to(dt).detach().requires_grad_() for n, v in w.items()}
        xt = x.to(dt).detach().requires_grad_()
        return grads_of(L.apply_mamba(leaves, cfg, xt)[0], xt, leaves)

    def in_turns(fn):
        return _in_turns(torch, rank, fn)

    out = {"heads": heads}
    got = sharded(torch.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    f32 = in_turns(lambda: whole(torch.float32))
    out["f32_err_over_tol"] = {k: _err_over_tol(got[k], f32[k]) for k in f32}
    out["f32_err"] = {k: (got[k] - f32[k]).abs().max().item() for k in f32}
    out["ssd_widths"] = sorted(set(seen))
    del got
    torch.cuda.empty_cache()

    def f32_floor():
        with f64_casts(torch):
            want = whole(torch.float64)
        return {k: (f32[k].double() - ref).abs().max().item()
                for k, ref in want.items()}
    out["f32_floor"] = in_turns(f32_floor)
    got = sharded(bf)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def bf16_errs():
        want = whole(bf)
        res = {}
        for k, ref in want.items():
            floor = (ref.float() - f32[k].float()).abs().max().item()
            err = (got[k].float() - ref.float()).abs().max().item()
            res[k] = {"err": err, "floor": floor,
                      "over_bound": err / (SERVE_BF16_FLOOR_X * floor)
                      if floor else (0.0 if err == 0 else math.inf)}
        return res
    out["bf16"] = in_turns(bf16_errs)
    del got, f32
    torch.cuda.empty_cache()

    # per-rank times, bf16: the SSD forward and backward on this rank's
    # heads, and on all of them, each rank alone
    G, N = cfg.ssm_ngroups, cfg.ssm_state

    def ssd_inputs(n):
        xh = torch.randn((B, S, n, hd), generator=gen, device="cuda").to(bf)
        dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(
            (B, S, n), generator=gen, device="cuda"))
        A = -torch.exp(math.log(16.0) * torch.rand((n,), generator=gen,
                                                   device="cuda"))
        Bm, Cm = (torch.randn((B, S, G, N), generator=gen, device="cuda")
                  .to(bf) for _ in range(2))
        return [t.requires_grad_() for t in (xh, dt, A, Bm, Cm)]

    def ssd_ms(n):
        args = ssd_inputs(n)

        def fwd_bwd():
            y = real_ssd(*args, cfg.ssm_chunk)
            torch.autograd.grad(y, args, y)
        return time_ms(torch, fwd_bwd, MESH_TIMING_ITERS, warm=2)
    out["ssd_ms"] = in_turns(lambda: ssd_ms(nh // 2))
    out["ssd_all_heads_ms"] = in_turns(lambda: ssd_ms(nh))
    # each collective of a step at its size and dtype, both ranks
    rest = sum(math.prod(s.shape) for n, s in L.mamba_spec(cfg).items()
               if n not in MAMBA_MESH_LEAVES)
    sizes = {"out_proj's partial y (head_sum)": ((B, S, D), bf),
             "x's partial gradient (head_grad_sum)": ((B, S, D), bf),
             "the norm's sums of squares (norm_sum, forward; backward the "
             "same)": ((B, S, 1), torch.float32),
             **{f"{n}'s gradient": (tuple(L.mamba_spec(cfg)[n].shape), bf)
                for n in MAMBA_MESH_LEAVES},
             "the other leaves' gradients (6 leaves, as one)": ((rest,), bf)}
    out["collectives"] = {}
    for name, (shape, dt) in sizes.items():
        t = torch.randn(shape, generator=gen, device="cuda").to(dt)
        out["collectives"][name] = {
            "bytes": t.numel() * t.element_size(),
            "ms": _allreduce_ms(torch, mesh, t)}
        del t
    del w, x, r
    torch.cuda.empty_cache()
    return out


def _two_rank_mamba_checks(torch, rank, seed):
    """Rank ``rank``'s part of phase 23 (i) on a (1, 2) mesh: mamba2-370m's
    and jamba's Mamba2 layers at full width, half the heads a rank."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2, device_type="cuda")
    print(f"  rank {rank}: mesh up", flush=True)
    out = {}
    for arch in MAMBA_MESH_ARCHS:
        out[arch] = _mamba_layer_two_ranks(torch, rank, seed, mesh,
                                           get_arch(arch))
        print(f"  rank {rank}: {arch}'s Mamba2 layer done", flush=True)
    return out


def phase_mamba_mesh_two_ranks(torch, seed, power):
    """Phase 23 (i): two ranks on the one card, each rank's results
    printed and checked. -> {"launches": none (the Mamba2 layers launch
    no kernel), "layers": each rank's results}."""
    from repro_torch.configs import get_arch
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    got = spawn_two_ranks(seed, "mamba", 900)
    B, S = MAMBA_BATCH
    for arch in MAMBA_MESH_ARCHS:
        cfg = get_arch(arch)
        nh = cfg.ssm_nheads
        for rank, res in sorted(got.items()):
            r = res[arch]
            f32 = r["f32_err_over_tol"]
            # within MESH_F32_TOL, or within twice the f32 floor
            worst32 = max(min(f32[k], r["f32_err"][k] / (
                SERVE_BF16_FLOOR_X * r["f32_floor"][k])
                if r["f32_floor"][k] else math.inf) for k in f32)
            worst16 = max(v["over_bound"] for v in r["bf16"].values())
            h0, h1 = r["heads"]
            print(f"  rank {rank} {arch} Mamba2 layer (d_model {cfg.d_model}, "
                  f"d_inner {cfg.d_inner}, {nh} heads of {cfg.ssm_headdim} "
                  f"over a state of {cfg.ssm_state}, {cfg.ssm_ngroups} group, "
                  f"chunk {cfg.ssm_chunk}; {B} x {S} tokens) heads "
                  f"[{h0}, {h1}), its SSD on {r['ssd_widths']} (B, S, heads, "
                  f"hd): f32 error over tolerance ({MESH_F32_TOL:g} of "
                  f"max|ref| + {MESH_F32_TOL:g} relative) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in f32.items()))
            print("    f32 error / floor (the unsharded f32 layer's distance "
                  "from its float64 twin): " + ", ".join(
                      f"{k} {r['f32_err'][k]:.3e} / {r['f32_floor'][k]:.3e}"
                      for k in f32)
                  + f"; worst over the bound (either) {worst32:.3f}")
            print("    bf16 error / floor: " + ", ".join(
                f"{k} {v['err']:.3e} / {v['floor']:.3e}"
                for k, v in r["bf16"].items())
                + f"; worst over {SERVE_BF16_FLOOR_X:g} x floor "
                f"{worst16:.3f}")
            print(f"  [{power}] rank {rank} {arch}: the SSD (forward and "
                  f"backward, bf16) at its {h1 - h0} heads {r['ssd_ms']:.3f} "
                  f"ms alone, at all {nh} {r['ssd_all_heads_ms']:.3f} ms")
            for name, c in r["collectives"].items():
                print(f"  [{power}] rank {rank} {arch}: all-reduce of {name}, "
                      f"{c['bytes'] / 2**20:.3f} MiB over gloo: "
                      f"{c['ms']:.3f} ms (host clock)")
            if not (worst32 <= 1.0 and worst16 <= 1.0):
                raise AssertionError(f"rank {rank}: {arch}'s sharded Mamba2 "
                                     "layer disagrees with one rank's")
            if (r["ssd_widths"] != [(B, S, nh // 2, cfg.ssm_headdim)]
                    or (h0, h1) != (rank * nh // 2, (rank + 1) * nh // 2)):
                raise AssertionError(f"rank {rank}: {arch}'s SSD did not run "
                                     "on its own half of the heads")
    return {"launches": {}, "layers": got}


def phase_mamba_mesh(torch, seed, power, mamba, jamba):
    """Phase 23: Mamba2 and the hybrid on a mesh: (i) two ranks on the one
    card, (ii) the sharded train steps of phase 18's mamba2-370m (all 48
    layers) and phase 19's jamba cut on a (1, 1) mesh: the losses and aux
    bitwise theirs, each step's launches by route as theirs, the step
    time, idle share and peak beside theirs."""
    import dataclasses
    from repro_torch.configs import get_arch
    jamba_cut = dataclasses.replace(get_arch(JAMBA_ARCH),
                                    n_layers=JAMBA_LAYERS,
                                    hybrid_period=JAMBA_LAYERS,
                                    n_experts=JAMBA_TRAIN_EXPERTS)
    cuts = ((MAMBA_ARCH, get_arch(MAMBA_ARCH), MAMBA_STEPS,
             train_want(0, "mma", 3), mamba["train"], 18,
             "segments/seg0_ssm/mamba/in_proj", MAMBA_BATCH),
            (JAMBA_ARCH, jamba_cut, JAMBA_STEPS, train_want(1, "mma", 11),
             jamba["train"], 19, "segments/seg0_hybrid/mamba1/in_proj",
             MAMBA_BATCH))
    return mesh_phase(torch, seed, power, 23, phase_mamba_mesh_two_ranks,
                      cuts, same=True)


# ------------------------------ phase 24: the VLM and audio on a mesh

# Phase 24 (i) holds each rank's share of the VLM's cross-attention (phase
# 20's shape: 4 x 1024 text queries over 4 x 4096 image keys, 32 query
# heads over 8 kv heads of 128, non-causal) against its slice of one
# rank's unsharded call on the same tensors: the kernels compute each head
# alone, so the slice is expected bitwise. Where it is not, f32 is held
# within MESH_F32_TOL of each tensor's largest |ref| + MESH_F32_TOL
# relative (phase 22's bound) and bf16 within SERVE_BF16_FLOOR_X times its
# floor, the distance of the unsharded bf16 call from the unsharded f32
# call on the same bf16-rounded inputs. musicgen-medium's four codebook
# heads run in vocabulary shards, rank 1's at col_offset V/2, with the
# xent plan's eager all-reduces; against one rank's whole-vocabulary loss
# they are held to phase 15 (ii)'s bounds (the losses within
# TWO_RANK_LOSS_ATOL, dH and dW within one bf16 ulp of the tensor's
# scale), and so is the codebook embedding's lookup and its gradient.
# Each rank's kernels are held, besides, against their plain versions at
# the rank's shapes, at phase 2's bounds.
VLM_MESH_ATTN = (4, 1024, 4096, 32, 8, 128, 128)  # B, S, T, H, K, hd, hdv
VLM_MESH_LEAF = "segments/seg0_vlm/cross/wk"


def _codebook_heads_two_ranks(torch, rank, seed, mesh):
    """Phase 24 (i), musicgen-medium's four codebook heads (N = 4 x 1024
    tokens, D 1536, V 2048) with the vocabulary over "model": each head
    through the sharded ``dispatch.xent_loss`` (rank 1's 1024 columns at
    col_offset 1024; the plan's eager all-reduces combine the shards),
    forward and backward, counted, against one rank's whole-vocabulary
    loss; the codebook embedding's lookup through the port's mesh route
    (``model._embed``) on this rank's (C, V/2, D) shard gathered whole (an
    eager all-reduce of the zero-padded shards: gloo takes CUDA tensors
    only in all-reduce and broadcast) and its gradient cut to the shard,
    against the unsharded route; then, each rank alone, the three xent
    kernels on its shard of one head against their plain versions (phase
    2's bounds), timed beside the whole head, the plain version, the
    library call and the bound."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    from repro_torch.models.model import _embed
    from repro_torch.models.sharding import (NamedSharding, P, Rules, place,
                                             psum)
    cfg = get_arch(MUSICGEN_ARCH)
    C, D, V = cfg.n_codebooks, cfg.d_model, cfg.padded_vocab
    B, S = MUSICGEN_BATCH
    N, bf = B * S, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 24)
    h = torch.randn((B, S, D), generator=gen, device="cuda").to(bf)
    w = (torch.randn((C, D, V), generator=gen, device="cuda")
         / D ** 0.5).to(bf)
    labels = torch.randint(0, cfg.vocab_size, (B, C, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels[..., -1] = -1  # the data pipeline's last position
    cot = torch.rand((B, C, S), generator=gen, device="cuda")
    h_sh = NamedSharding(mesh, P("data", None, None))
    w_sh = NamedSharding(mesh, P(None, "model"))
    plan = dispatch.xent_route(h.shape, w.shape[1:], h_sh, w_sh)[1]

    def heads(sharded):
        hl = (place(h, h_sh) if sharded else h).detach().requires_grad_()
        ws = [(place(w[c].contiguous(), w_sh) if sharded else w[c])
              .detach().requires_grad_() for c in range(C)]
        losses = [dispatch.xent_loss(hl, ws[c], labels[:, c],
                                     vocab_size=cfg.vocab_size)
                  for c in range(C)]
        if sharded:
            losses = [ls.to_local() for ls in losses]
        total = sum((ls * cot[:, c]).sum() for c, ls in enumerate(losses))
        gh, *gw = torch.autograd.grad(total, [hl, *ws])
        if sharded:
            return losses, gh.to_local(), [g.to_local() for g in gw]
        return losses, gh, [place(g, w_sh).to_local() for g in gw]

    zero_train_counts()
    zero_offset_counts()
    losses, gh, gw = heads(True)
    torch.cuda.synchronize()
    launches = {**train_counts(), **offset_counts()}
    want = _uncounted(lambda: heads(False))
    res = {"plan": (plan.tok_axes, plan.voc_axes),
           "cols": (rank * V // 2, (rank + 1) * V // 2),
           "loss": max((a - b).abs().max().item()
                       for a, b in zip(losses, want[0])),
           "dh": ((gh.float() - want[1].float()).abs()
                  / ulp(torch, want[1].float().abs().max(), bf)).max().item(),
           "dw": max(((a.float() - b.float()).abs()
                      / ulp(torch, b.float().abs().max(), bf)).max().item()
                     for a, b in zip(gw, want[2])),
           "abs_err": {"xent_fwd": max((a - b).abs().max().item()
                                       for a, b in zip(losses, want[0])),
                       "xent_bwd_dh": (gh.float() - want[1].float()).abs()
                       .max().item(),
                       "xent_bwd_dw": max((a.float() - b.float()).abs()
                                          .max().item()
                                          for a, b in zip(gw, want[2]))},
           "dw_width": tuple(gw[0].shape)}
    del losses, gh, gw, want

    # the codebook embedding: its (C, V, D) table with V over "model",
    # through the port's audio lookup (``model._embed``: each codebook's
    # ``sharding.embed_lookup``, on the default rules' layout of the
    # tokens). embed_lookup gathers the table whole by a DTensor
    # redistribute, which never finishes over gloo on CUDA tensors; here
    # an eager all-reduce of the zero-padded shards gathers it, and its
    # gradient passes through to the rank's rows, as the redistribute's
    # backward cuts it
    ew = (0.02 * torch.randn((C, V, D), generator=gen, device="cuda")).to(bf)
    toks = torch.randint(0, cfg.vocab_size, (B, C, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    r = torch.randn((B, S, D), generator=gen, device="cuda")
    r0, r1 = res["cols"]
    own = place(ew, NamedSharding(mesh, P(None, "model", None))).to_local() \
        .detach().requires_grad_()
    whole = psum(torch.nn.functional.pad(own, (0, 0, r0, V - r1)), mesh,
                 ("model",))
    emb = _embed(whole, cfg, toks, Rules(), mesh)
    (g_own,) = torch.autograd.grad((emb.to_local().float() * r).sum(),
                                   [own])
    emb = emb.to_local()
    one = ew.detach().requires_grad_()
    emb_w = _embed(one, cfg, toks, None, None)
    (g_w,) = torch.autograd.grad((emb_w.float() * r).sum(), [one])
    g_w = g_w[:, r0:r1]
    res["embed"] = {
        "bitwise": bool(torch.equal(emb, emb_w) and torch.equal(g_own, g_w)),
        "emb": ((emb.float() - emb_w.float()).abs()
                / ulp(torch, emb_w.float().abs().max(), bf)).max().item(),
        "grad": ((g_own.float() - g_w.float()).abs()
                 / ulp(torch, g_w.float().abs().max(), bf)).max().item(),
        "grad_width": tuple(g_own.shape)}
    del ew, own, whole, emb, emb_w, one, g_own, g_w

    # times on one head's shard (bf16, the step's dtype)
    hf = h.reshape(N, D)
    lab = labels[:, 0].reshape(N)
    gl = cot[:, 0].reshape(N) * (lab >= 0)
    wl = place(w[0].contiguous(), w_sh).to_local().contiguous()
    off = r0
    kw = {"vocab_size": cfg.vocab_size, "col_offset": off}
    lse_w, _ = X.xent_fwd(hf, w[0], lab, vocab_size=cfg.vocab_size)
    v = wl.shape[1]
    local = (lab - off).long()
    mine = (local >= 0) & (local < v)

    def lib_fwd():
        x = (hf @ wl).float()
        got = torch.where(mine, x.gather(1, local.clamp(0, v - 1)[:, None])[
            :, 0], 0.0)
        return torch.logsumexp(x, 1), got

    def lib_bwd():
        g = torch.exp((hf @ wl).float() - lse_w[:, None])
        g[mine, local[mine]] -= 1.0
        g = (g * gl[:, None]).to(bf)
        return g @ wl.T, hf.T @ g

    fns = {"xent_fwd": X.xent_fwd, "xent_bwd_dh": X.xent_bwd_dh,
           "xent_bwd_dw": X.xent_bwd_dw}
    refs = {"xent_fwd": XR.xent_fwd_ref, "xent_bwd_dh": XR.xent_bwd_dh_ref,
            "xent_bwd_dw": XR.xent_bwd_dw_ref}

    def timing():
        lib = {"xent_fwd": time_ms(torch, lib_fwd, 5),
               "bwd": time_ms(torch, lib_bwd, 5)}
        rows = []
        for name, fn in fns.items():
            a = (hf, wl, lab) if name == "xent_fwd" else (hf, wl, lab,
                                                          lse_w, gl)
            aw = (hf, w[0], lab) if name == "xent_fwd" else (
                hf, w[0], lab, lse_w, gl)
            okw = {} if name == "xent_fwd" else {"out_dtype": torch.float32}
            was = dict(fn.route_launches)
            out = fn(*a, **kw, **okw)
            route = _route_of(fn, was)
            want = refs[name](*a, **kw, **okw)
            if name == "xent_fwd":
                d = [(x - y).abs() for x, y in zip(out, want)]
                err = max(x.max().item() for x in d)
                over = max((x / (XENT_LSE_ATOL + XENT_LSE_RTOL * y.abs()))
                           .max().item() for x, y in zip(d, want))
            else:
                err, over = _grad_check(torch, name, out, want,
                                        torch.float32, "a codebook head's "
                                        f"shard at col_offset {off}")
            bound, by = xent_bound_ms(N, D, v, 2, name)
            rows.append({
                "name": name, "route": route,
                "plain_err": err, "plain_over_tol": over,
                "ms": time_ms(torch, lambda: fn(*a, **kw, **okw), 5),
                "unsharded_ms": time_ms(torch, lambda: fn(
                    *aw, vocab_size=cfg.vocab_size, **okw), 5),
                "plain_ms": time_ms(torch, lambda: refs[name](
                    *a, **kw, **okw), 2, warm=1),
                "bound_ms": bound, "bound_by": by,
                "library_ms": lib["xent_fwd" if name == "xent_fwd"
                                  else "bwd"],
                "library_note": (
                    "matmul + logsumexp and the label's logit"
                    if name == "xent_fwd" else
                    "matmul, softmax - onehot, and the two products (dH "
                    "and dW together, logits recomputed)")})
        return rows
    res["times"] = _in_turns(torch, rank, lambda: _uncounted(timing))
    res["opt_times"] = _in_turns(torch, rank, lambda: _uncounted(
        lambda: _head_step_timing(torch, gen, (C, D, V // 2))))
    res["launches"] = launches
    return res


def _head_step_timing(torch, gen, shape):
    """SCALE's head step on one rank's (C, D, V/2) shard of musicgen's
    (C, D, V) heads, col (the norm over D): ``momentum_sumsq`` (f32 m,
    bf16 g) and the head's ``update_apply`` (bf16 theta, f32 m'), each
    against its plain version on copies (max abs error) and timed beside
    the bound by bytes and one library call."""
    from repro_torch.kernels.colnorm import colnorm as CN
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head import ref as HR
    from repro_torch.kernels.scale_head import scale_head as SH
    bf = torch.bfloat16
    g = torch.randn(shape, generator=gen, device="cuda").to(bf)
    theta = (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(bf)
    m = 1e-3 * torch.randn(shape, generator=gen, device="cuda")
    g32 = g.float()
    lr = torch.tensor(1e-6, device="cuda")
    m_k, ss = SH.momentum_sumsq(m.clone(), g, 0.9, "col")
    m_r, _ = HR.momentum_sumsq_ref(m.clone(), g, 0.9, "col")
    th_k = CN.update_apply(theta.clone(), m_k, ss, lr, "col")
    th_r = CR.update_apply_ref(theta.clone(), m_k, ss, lr, "col")
    denom = torch.sqrt(ss) + 1e-8  # the library call's divisor, f32
    n, cols = g.numel(), shape[0] * shape[2]
    rows = []
    for name, nbytes, err, kern, plain, lib, note in (
            ("momentum_sumsq", (4 + 2 + 4) * n + 4 * cols,
             (m_k - m_r).abs().max().item(),
             lambda: SH.momentum_sumsq(m, g, 0.9, "col"),
             lambda: HR.momentum_sumsq_ref(m, g, 0.9, "col"),
             lambda: m.lerp_(g32, 0.1),
             "m.lerp_(g, 1-beta), EMA only, g in f32"),
            ("update_apply", (2 + 4 + 2) * n + 4 * cols,
             (th_k.float() - th_r.float()).abs().max().item(),
             lambda: CN.update_apply(theta, m_k, ss, lr, "col"),
             lambda: CR.update_apply_ref(theta, m_k, ss, lr, "col"),
             lambda: theta.addcdiv_(m_k, denom, value=-1e-6),
             "theta.addcdiv_(m', sqrt(ss)+eps, value=-lr)")):
        rows.append({"name": name, "max_abs_err": err,
                     "ms": time_ms(torch, kern, 20),
                     "plain_ms": time_ms(torch, plain, 5, warm=1),
                     "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                     "bound_by": "bytes",
                     "library_ms": time_ms(torch, lib, 20),
                     "library_note": note})
    return rows


def _two_rank_vlm_checks(torch, rank, seed):
    """Rank ``rank``'s part of phase 24 (i) on a (1, 2) mesh: the VLM's
    cross-attention with its heads over "model", musicgen-medium's
    codebook heads with the vocabulary over "model" and its embedding."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2, device_type="cuda")
    print(f"  rank {rank}: mesh up", flush=True)
    out = {"cross": _attention_two_ranks(
        torch, rank, seed + 24, mesh, VLM_MESH_ATTN,
        (torch.float32, torch.bfloat16), False)}
    print(f"  rank {rank}: the VLM's cross-attention done", flush=True)
    out["heads"] = _codebook_heads_two_ranks(torch, rank, seed, mesh)
    print(f"  rank {rank}: musicgen's codebook heads done", flush=True)
    return out


def phase_vlm_mesh_two_ranks(torch, seed, power):
    """Phase 24 (i): two ranks on the one card, each rank's results
    printed and checked. -> {"launches": the two ranks' launches summed,
    "entries": per-rank "shapes" entries of the kernels line's rows}."""
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    got = spawn_two_ranks(seed, "vlm", 600)
    B, S, T, H, K, hd, _ = VLM_MESH_ATTN
    launches, entries = {}, {}
    for rank, res in sorted(got.items()):
        c = res["cross"]
        _attention_two_ranks_report(
            power, rank, f"the VLM's cross-attention (B={B} S={S} T={T} H={H}"
            f" K={K} hd={hd}, non-causal)", c,
            {"float32": "fma", "bfloat16": "mma"})
        if c["heads"] != (H // 2, K // 2):
            raise AssertionError(f"rank {rank}: the cross-attention ran on "
                                 f"{c['heads']} heads, not half of them")
        for t in c["times"]:
            entries.setdefault(t["name"], []).append({
                "name": t["name"], "route": "cuda",
                "kernel_route": t["route"],
                "shape": f"rank {rank} of 2, the VLM's cross-attention on "
                         f"a (1, 2) mesh: B={B} S={S} T={T} H={H // 2} of "
                         f"{H} K={K // 2} of {K} hd={hd} non-causal "
                         f"{t['dtype']}",
                "source": SRC_MHA if t["name"] == "mha_fwd" else SRC_MHA_BWD,
                "replaces": TPU_MHA if t["name"] == "mha_fwd"
                else TPU_KERNELS[t["name"]],
                # this rank's sharded call, forward and backward, on the
                # dtype's route
                "launches": c["routes"][t["name"]][t["route"]],
                # against the plain version at the rank's shape
                "max_abs_err": t["plain_err"],
                # against the unsharded call's slice
                "sharded_max_abs_err": max(
                    e["err"] for k, e in c["errs"].items()
                    if k.endswith(t["dtype"])),
                **{k: t[k] for k in ("ms", "unsharded_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "library_note")}})
        m = res["heads"]
        e = m["embed"]
        print(f"  rank {rank} musicgen's {MUSICGEN_HEAD.split(' ', 1)[1]} "
              f"codebook heads on (1, 2), plan tokens {m['plan'][0]} x vocab "
              f"{m['plan'][1]}: columns [{m['cols'][0]}, {m['cols'][1]}) "
              f"(dW {m['dw_width']}); losses {m['loss']:.3e} off one "
              f"rank's, dH {m['dh']:.2f} and dW {m['dw']:.2f} bf16 ulps of "
              f"the tensor's scale; the codebook embedding's lookup "
              f"{e['emb']:.2f} and its gradient {e['grad']:.2f} bf16 ulps "
              f"(rows {e['grad_width']}){', bitwise' if e['bitwise'] else ''}"
              f"; offset launches "
              f"{ {k: m['launches'][k] for k in SHARD_ROWS.values()} }")
        if not (m["loss"] <= TWO_RANK_LOSS_ATOL and m["dh"] <= 1.0
                and m["dw"] <= 1.0 and e["emb"] <= 1.0 and e["grad"] <= 1.0
                and m["plan"] == (("data",), ("model",))):
            raise AssertionError(f"rank {rank}: musicgen's sharded heads or "
                                 "embedding disagree with one rank's")
        want_off = 4 if rank else 0
        if any(m["launches"][k] != want_off for k in SHARD_ROWS.values()):
            raise AssertionError(f"rank {rank}: launches at a non-zero "
                                 f"col_offset {m['launches']}")
        for t in m["times"]:
            print(f"  [{power}] rank {rank} {t['name']} on {t['route']} at "
                  f"its 1024 of 2048 columns (col_offset {m['cols'][0]}): "
                  f"{t['ms']:.4f} ms (the whole head {t['unsharded_ms']:.4f}"
                  f" ms; bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
                  f"{t['bound_ms'] / t['ms']:.4f} of it; plain "
                  f"{t['plain_ms']:.4f} ms, max abs error against it "
                  f"{t['plain_err']:.3e}, {t['plain_over_tol']:.3f} of phase "
                  f"2's bound; library ({t['library_note']}) "
                  f"{t['library_ms']:.4f} ms)")
            if not t["plain_over_tol"] <= 1.0:
                raise AssertionError(f"rank {rank}: {t['name']} on its shard "
                                     "disagrees with the plain version")
            if rank:
                entries.setdefault(SHARD_ROWS[t["name"]], []).append({
                    "name": SHARD_ROWS[t["name"]], "route": "cuda",
                    "kernel_route": t["route"],
                    "shape": f"rank 1 of 2, a musicgen codebook head on a "
                             f"(1, 2) mesh: N=4096 D=1536 V=1024 of 2048 "
                             f"(col_offset 1024) bf16",
                    "source": SRC_XENT, "replaces": TPU_KERNELS[t["name"]],
                    "launches": m["launches"][SHARD_ROWS[t["name"]]],
                    # against the plain version at the shard's shape
                    "max_abs_err": t["plain_err"],
                    # the sharded losses', dH's and dW's against one
                    # rank's whole-vocabulary loss
                    "sharded_max_abs_err": m["abs_err"][t["name"]],
                    **{k: t[k] for k in ("ms", "unsharded_ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "library_note")}})
        for t in m["opt_times"]:
            print(f"  [{power}] rank {rank} {t['name']} on its (4, 1536, "
                  f"1024) shard of musicgen's heads, col: {t['ms']:.4f} ms "
                  f"(bound {t['bound_ms']:.4f} ms by bytes, "
                  f"{t['bound_ms'] / t['ms']:.4f} of it; plain "
                  f"{t['plain_ms']:.4f} ms; {t['library_note']} "
                  f"{t['library_ms']:.4f} ms; max abs error against the "
                  f"plain version {t['max_abs_err']:.3e})")
            if rank:
                entries.setdefault(t["name"], []).append({
                    "name": t["name"], "route": "cuda",
                    "shape": "rank 1 of 2, musicgen's heads on a (1, 2) "
                             "mesh: (4, 1536, 1024) of (4, 1536, 2048), "
                             "col, f32 m, bf16 g and theta",
                    "source": SRC_MOMENTUM if t["name"] == "momentum_sumsq"
                    else SRC_COLNORM, "replaces": TPU_KERNELS[t["name"]],
                    "launches": None,
                    **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "library_note")}})
        for part in (c["launches"], m["launches"]):
            for k, n in part.items():
                launches[k] = launches.get(k, 0) + n
    return {"launches": launches, "entries": entries}


def musicgen_host_parts(torch, seed, power, step_gap):
    """The (1, 1) mesh's extra host time in musicgen-medium's step, in
    part: its four codebook lookups (``model._embed``, one
    ``embed_lookup`` each) and its four heads' loss (``model.lm_loss``,
    one sharded ``xent_loss`` plan each), forward and backward, each on
    the host clock (the best of 5 calls, synchronized) with DTensor leaves
    and batch on a (1, 1) NCCL mesh against plain tensors, on the step's
    shapes and layouts. ``step_gap``: the step's ms on the mesh less
    phase 21's; what the two parts do not take of it is the 48 layers'
    and the optimizer's. -> {part: (mesh ms, plain ms)}."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.sharding import Rules, place, shard_batch
    cfg = get_arch(MUSICGEN_ARCH)
    C, D, V = cfg.n_codebooks, cfg.d_model, cfg.padded_vocab
    B, S = MUSICGEN_BATCH
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ew = (0.02 * torch.randn((C, V, D), generator=gen, device="cuda")).to(dt)
    w = (torch.randn((C, D, V), generator=gen, device="cuda")
         / D ** 0.5).to(dt)
    h = torch.randn((B, S, D), generator=gen, device="cuda").to(dt)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, C, S), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    rules = Rules(cfg.rule_overrides)
    nccl_world()
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        axes = {"ew": M._embed_spec(cfg)["w"].axes,
                "w": M._head_spec(cfg)["w"].axes,
                "h": ("act_batch", "act_seq", "act_embed")}

        def on(mesh_):
            if mesh_ is None:
                return {"ew": ew, "w": w, "h": h, **batch}
            return {**{k: place(t, rules.sharding(axes[k], mesh_, t.shape),
                                copy=True) for k, t in
                       (("ew", ew), ("w", w), ("h", h))},
                    **shard_batch(batch, mesh_, rules)}

        def embed(t, mesh_):
            leaf = t["ew"].detach().requires_grad_()
            x = M._embed(leaf, cfg, t["tokens"], rules, mesh_)
            x.sum().backward()

        def heads(t, mesh_):
            leaf = t["w"].detach().requires_grad_()
            hid = t["h"].detach().requires_grad_()
            loss, _ = M.lm_loss({"lm_head": {"w": leaf}}, cfg, hid,
                                t["labels"], rules=rules, mesh=mesh_)
            loss.backward()

        def host_ms(fn, t, mesh_):
            times = []
            for i in range(7):
                t0 = time.perf_counter()
                fn(t, mesh_)
                torch.cuda.synchronize()
                if i >= 2:
                    times.append(1e3 * (time.perf_counter() - t0))
            return min(times)
        parts = {}
        for name, fn in (("the four codebook lookups", embed),
                         ("the four heads' loss", heads)):
            parts[name] = (host_ms(fn, on(mesh), mesh),
                           host_ms(fn, on(None), None))
    finally:
        dist.destroy_process_group()
    extra = sum(a - b for a, b in parts.values())
    print(f"  [{power}] musicgen-medium's step on the (1, 1) mesh, "
          f"{step_gap:+.3f} ms over phase 21's; forward and backward, host "
          f"clock, on the mesh against plain tensors: "
          + "; ".join(f"{k} {a:.3f} against {b:.3f} ms ({a - b:+.3f})"
                      for k, (a, b) in parts.items())
          + f"; the rest (the 48 layers and the optimizer) "
          f"{step_gap - extra:+.3f} ms")
    return parts


def phase_vlm_mesh(torch, seed, power, vlm, musicgen):
    """Phase 24: the VLM and audio on a mesh: (i) two ranks on the one
    card, (ii) the sharded train steps of phase 20's VLM (uncut: all 8
    super-blocks, f32 images) and phase 21's musicgen-medium on a (1, 1)
    mesh: the losses and aux bitwise theirs, each step's launches by route
    as theirs, the step time, idle share and peak beside theirs; then how
    much of musicgen's extra host time its lookups and heads take."""
    import dataclasses
    from repro_torch.configs import get_arch
    full = get_arch(VLM_ARCH)
    cut = dataclasses.replace(full, n_layers=VLM_BLOCKS * full.cross_attn_every)
    music = get_arch(MUSICGEN_ARCH)
    cuts = ((VLM_ARCH, cut, VLM_STEPS, vlm_want(cut, "fma"), vlm["train"],
             20, VLM_MESH_LEAF, VLM_BATCH),
            (MUSICGEN_ARCH, music, MUSICGEN_STEPS, musicgen_want(music),
             musicgen["train"], 21, "lm_head/w", MUSICGEN_BATCH))
    out = mesh_phase(torch, seed, power, 24, phase_vlm_mesh_two_ranks, cuts,
                     same=True)
    gap = (out["train"][MUSICGEN_ARCH]["step_ms"]
           - musicgen["train"]["step_ms"])
    out["host_parts"] = _uncounted(
        lambda: musicgen_host_parts(torch, seed, power, gap))
    return out


# ----------------------------- phase 25: sharded serving, the GQA families

# Phase 25 (i): the sequence-split decode plan on two ranks, at the decode
# shapes of phase 3 (llama-130m) and phase 20 (the VLM's self-attention):
# (B, T, H, K, hd), T the cache, split in two halves over "model"
SERVE_MESH_ATTN = {"llama-130m": (8, 576, 12, 12, 64),
                   "the VLM's self-attention": (4, 544, 32, 8, 128)}
# the three fills of the cache: inside rank 0's half (rank 1 attends over
# no valid key), on the boundary of the halves, past it
SERVE_MESH_FILLS = ("inside", "on", "past")
# Against the unsharded call, f32 within MESH_F32_TOL (``_err_over_tol``:
# the combine rescales each half's partial sum, a few f32 ulps). bf16:
# SERVE_BF16_FLOOR_X times its floor, the distance of the unsharded bf16
# call from the unsharded f32 one (phases 22-24's rule, printed as
# "of twice it"), plus one bf16 rounding of the largest partial output:
# each rank's output leaves the kernel rounded to bf16 before the f32
# combine, a rounding the unsharded call does not make (it moved the
# combined output one bf16 ulp, 1.30 times twice the floor alone, at the
# fill past the boundary; PERF.md §6). Where one rank holds every
# valid key the combine returns its output exactly.
SERVE_MESH_BF16_ROUNDING = 2.0 ** -8
SERVE_MESH_TIMING_ITERS = 20


def _fill(T, fill):
    half = T // 2
    return {"inside": half // 2 + 3, "on": half, "past": half + half // 2
            + 7}[fill]


def _seq_split_two_ranks(torch, rank, seed, mesh, label, shape):
    """Phase 25 (i), one shape: this rank's half of the cache through
    ``dispatch.seq_split_decode`` (counted) in f32 and bf16 at each fill,
    against the unsharded ``mha_fwd`` call on the same tensors; then, the
    rank alone, its kernel at its local fill against its plain version,
    timed (CUDA events, device time) beside the bound, the plain version
    and SDPA over its filled keys; the combine's all-reduce on the host
    clock, both ranks in step."""
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    B, T, H, K, hd = shape
    T_l = T // 2
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = make_qkv(torch, gen, B, 1, T, H, K, hd, bf16)  # one value
    ops = {dt: [t.to(dt) for t in base] for dt in (f32, bf16)}
    mine = {dt: [ops[dt][0]] + [t[:, rank * T_l:(rank + 1) * T_l]
                                .contiguous() for t in ops[dt][1:]]
            for dt in ops}
    fills = {f: _fill(T, f) for f in SERVE_MESH_FILLS}
    kw = dict(scale=hd ** -0.5)

    def kv(n):
        return torch.tensor(n, dtype=torch.int32, device="cuda")
    zero_train_counts()
    zero_route_counts()
    got, each = {}, {}
    for dt in ops:
        for f, n in fills.items():
            was = mha_fwd.route_launches["decode"]
            got[(dt, f)] = dispatch.seq_split_decode(
                *mine[dt], kv(n), mesh=mesh, seq_axes=("model",), **kw)
            each[(str(dt).replace("torch.", ""), f)] = \
                mha_fwd.route_launches["decode"] - was
    torch.cuda.synchronize()
    launches, routes = train_counts(), route_counts()["mha_fwd"]
    want = _uncounted(lambda: {
        (dt, f): mha_fwd(*ops[dt], kv(n), causal=False, **kw)[0]
        for dt in ops for f, n in fills.items()})
    errs = {}
    for f, n in fills.items():
        a32, b32 = got[(f32, f)].float(), want[(f32, f)].float()
        a16, b16 = got[(bf16, f)].float(), want[(bf16, f)].float()
        floor = (b16 - b32).abs().max().item()
        e16 = (a16 - b16).abs().max().item()
        # the largest |partial output| of the two ranks (their bf16 outs
        # before the combine)
        part = _uncounted(lambda: mha_fwd(*mine[bf16], kv(max(
            0, min(n - rank * T_l, T_l))), causal=False, **kw)[0])
        part = part.float().abs().max().reshape(1)
        dist.all_reduce(part, op=dist.ReduceOp.MAX,
                        group=mesh.get_group("model"))
        bound = (SERVE_BF16_FLOOR_X * floor
                 + SERVE_MESH_BF16_ROUNDING * part.item())
        errs[f] = {"float32": {"err": (a32 - b32).abs().max().item(),
                               "over_bound": _err_over_tol(a32, b32)},
                   "bfloat16": {"err": e16, "floor": floor,
                                "over_floor": e16 / (SERVE_BF16_FLOOR_X
                                                     * floor)
                                if floor else (0.0 if e16 == 0
                                               else math.inf),
                                "partial_max": part.item(),
                                "over_bound": e16 / bound if bound
                                else (0.0 if e16 == 0 else math.inf),
                                "bitwise": bool(torch.equal(
                                    got[(bf16, f)], want[(bf16, f)]))}}
    parts = torch.zeros((2, B * H * (hd + 1)), device="cuda")
    allreduce_ms = _allreduce_ms(torch, mesh, parts)

    def timing():
        rows = []
        for dt in ops:
            q, k, v = mine[dt]
            el = 4 if dt == f32 else 2
            peak = F32_FLOPS_PER_S if dt == f32 else BF16_FLOPS_PER_S
            for f, n in fills.items():
                local = max(0, min(n - rank * T_l, T_l))
                lk = kv(local)

                def fn():
                    return mha_fwd(q, k, v, lk, causal=False, **kw)

                def plain():
                    return mha_fwd_ref(q, k, v, lk, causal=False, **kw)
                err, over = _attn_plain_over_tol(torch, "mha_fwd", fn(),
                                                 plain(), dt)
                bound, by = attention_bound_ms(B, 1, T_l, H, K, hd, False,
                                               local, el, peak=peak)
                lib = None
                if local:
                    qt = q.transpose(1, 2).contiguous()
                    kt, vt = (t[:, :local].transpose(1, 2)
                              .repeat_interleave(H // K, 1).contiguous()
                              for t in (k, v))
                    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, scale=kw["scale"]),
                        SERVE_MESH_TIMING_ITERS, warm=3)
                rows.append({
                    "dtype": str(dt).replace("torch.", ""), "fill": f,
                    "kv_len": n, "local": local, "plain_err": err,
                    "plain_over_tol": over,
                    "ms": time_ms(torch, fn, SERVE_MESH_TIMING_ITERS,
                                  warm=3),
                    "device_ms": device_ms(torch, fn, 10),
                    "plain_ms": time_ms(torch, plain, 3, warm=1),
                    "bound_ms": bound, "bound_by": by, "library_ms": lib})
        return rows
    rows = _in_turns(torch, rank, lambda: _uncounted(timing))
    return {"label": label, "shape": shape, "fills": fills, "errs": errs,
            "launches": launches, "routes": routes, "each": each,
            "times": rows,
            "allreduce_ms": allreduce_ms,
            "allreduce_bytes": parts.numel() * 4}


def _two_rank_serve_checks(torch, rank, seed):
    """Rank ``rank``'s part of phase 25 (i) on a (1, 2) mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2, device_type="cuda")
    print(f"  rank {rank}: mesh up", flush=True)
    out = []
    for i, (label, shape) in enumerate(SERVE_MESH_ATTN.items()):
        out.append(_seq_split_two_ranks(torch, rank, seed + 25 + i, mesh,
                                        label, shape))
        print(f"  rank {rank}: {label} done", flush=True)
    return out


def phase_serve_mesh_two_ranks(torch, seed, power):
    """Phase 25 (i): two ranks on the one card, each rank's results printed
    and checked. -> {"launches": the two ranks' launches summed,
    "entries": per-rank "shapes" entries of the kernels line's rows}."""
    torch.cuda.empty_cache()
    got = spawn_two_ranks(seed, "serve", 300)
    launches, entries = {}, {}
    for rank, res in sorted(got.items()):
        for c in res:
            B, T, H, K, hd = c["shape"]
            worst = max(e["over_bound"] for d in c["errs"].values()
                        for e in d.values())
            print(f"  rank {rank} {c['label']} decode (B={B} T={T}, "
                  f"{T // 2} a rank, H={H} K={K} hd={hd}) at kv_len "
                  f"{c['fills']}: combined against the unsharded call "
                  + "; ".join(
                      f"{f} f32 {e['float32']['err']:.3e} "
                      f"({e['float32']['over_bound']:.3f} of its bound), "
                      f"bf16 {e['bfloat16']['err']:.3e} (floor "
                      f"{e['bfloat16']['floor']:.3e}, "
                      f"{e['bfloat16']['over_floor']:.3f} of twice it; "
                      f"{e['bfloat16']['over_bound']:.3f} of that plus one "
                      f"bf16 rounding of the largest partial "
                      f"{e['bfloat16']['partial_max']:.3f}"
                      f"{', bitwise' if e['bfloat16']['bitwise'] else ''})"
                      for f, e in c["errs"].items())
                  + f"; mha_fwd by route {c['routes']}; the combine's "
                  f"all-reduce of {c['allreduce_bytes']} bytes "
                  f"{c['allreduce_ms']:.3f} ms (host clock, gloo)")
            if not (worst <= 1.0 and c["routes"] == {
                    "mma": 0, "fma": 0, "decode": 2 * len(c["fills"])}
                    and not any(n for k, n in c["launches"].items()
                                if k != "mha_fwd")):
                raise AssertionError(f"rank {rank} {c['label']}: the "
                                     "sequence-split decode disagrees with "
                                     "the unsharded call, or ran off the "
                                     "decode route")
            for t in c["times"]:
                print(f"  [{power}] rank {rank} {c['label']} mha_fwd "
                      f"{t['dtype']} on decode, kv_len {t['kv_len']} "
                      f"({t['local']} of its {T // 2} keys): "
                      f"{t['ms']:.4f} ms (device {fmt_ms(t['device_ms'])};"
                      f" bound {t['bound_ms']:.4f} ms by {t['bound_by']}; "
                      f"plain {t['plain_ms']:.4f} ms, max abs error "
                      f"{t['plain_err']:.3e}, {t['plain_over_tol']:.3f} of "
                      f"phase 2's bound; SDPA over its filled keys "
                      f"{fmt_ms(t['library_ms'])})")
                if not t["plain_over_tol"] <= 1.0:
                    raise AssertionError(f"rank {rank}: mha_fwd on its shard"
                                         " disagrees with the plain version")
                entries.setdefault("mha_fwd", []).append({
                    "name": "mha_fwd", "route": "cuda",
                    "kernel_route": "decode",
                    "shape": f"rank {rank} of 2, the sequence-split decode "
                             f"on a (1, 2) mesh ({c['label']}): B={B} S=1 "
                             f"T={T // 2} of {T} H={H} K={K} hd={hd} "
                             f"kv_len {t['kv_len']} (local {t['local']}) "
                             f"{t['dtype']}",
                    "source": SRC_MHA, "replaces": TPU_MHA,
                    # this case's launches on the rank's sharded path
                    "launches": c["each"][(t["dtype"], t["fill"])],
                    "max_abs_err": t["plain_err"],
                    "sharded_max_abs_err": c["errs"][t["fill"]][
                        t["dtype"]]["err"],
                    "allreduce_ms": c["allreduce_ms"],
                    **{k: t[k] for k in ("ms", "device_ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
                    "library_note": "F.scaled_dot_product_attention over "
                                    "the shard's filled keys"
                                    + (f", kv repeated to {H} heads"
                                       if H != K else "")})
            # the decode plan launches mha_fwd alone (checked above)
            launches["mha_fwd"] = (launches.get("mha_fwd", 0)
                                   + c["launches"]["mha_fwd"])
    return {"launches": launches, "entries": entries}


def _serve_pass(torch, power, label, c, params, prompt, images, N,
                rules=None, mesh=None):
    """One serving run of ``c`` (prefill, then N - 1 greedy decode steps,
    fed ``next_tokens`` of the full logits), counted from 0 after an
    untimed prefill and decode step: -> its
    tokens, every step's full logits, prefill ms, decode ms a step, mha_fwd
    launches by route, the peak above what was allocated before it, and
    one decode step's busy time and idle share (``moe_profile``)."""
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.models.sharding import full_value
    from repro_torch.training import make_decode_step, make_prefill_step
    P = prompt.shape[-1]
    prefill = make_prefill_step(c, P + N, rules, mesh)
    decode = make_decode_step(c, rules, mesh)
    # warm-up, not counted: a prefill and one decode step (on a mesh, the
    # first collectives and DTensor's first sharding propagation at S = 1)
    state, logits = prefill(params, prompt, images)
    decode(params, state, next_tokens(torch, full_value(logits)), images)
    del state, logits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_route_counts()
    mha_fwd.launches = 0
    t0 = time.perf_counter()
    state, logits = prefill(params, prompt, images)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    steps, toks = [full_value(logits)], []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(N - 1):
        toks.append(next_tokens(torch, steps[-1]))
        state, logits = decode(params, state, toks[-1], images)
        steps.append(full_value(logits))
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / (N - 1)
    routes, launches = route_counts()["mha_fwd"], mha_fwd.launches
    peak = torch.cuda.max_memory_allocated() - before
    toks.append(next_tokens(torch, steps[-1]))
    del state
    state, _ = prefill(params, prompt, images)
    busy, _ = moe_profile(torch, power, lambda: decode(
        params, state, toks[0], images), decode_ms, f"{label} decode step",
        serving=True)
    return {"tokens": torch.cat(toks, dim=-1), "logits": steps,
            "prefill_ms": prefill_s * 1e3, "decode_ms": decode_ms,
            "routes": routes, "launches": launches,
            "peak_mib": peak / 2**20, "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / decode_ms}


def serve_on_mesh(torch, seed, power, arch, cfg, serve_cfg, shape, ref,
                  phase, mesh):
    """Phase 25 (ii), one model: phase ``phase``'s serving (``cfg``'s
    seeded weights, prompt and images, as that phase draws them; served
    at ``serve_cfg``) without a mesh and on the (1, 1) NCCL ``mesh``
    (``place_params``' DTensors, ``rules`` and ``mesh`` through the
    serving factories): tokens equal, every step's logits bitwise, the
    launches by route equal, the tokens phase ``phase`` chose (``ref``'s)
    as these (``ref`` None: not compared). -> {"plain": ..., "mesh": ...}
    of ``_serve_pass``."""
    from repro_torch.models import init_params
    from repro_torch.models.model import place_params
    from repro_torch.models.sharding import Rules
    B, P, N = shape
    lead = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (*lead, P), generator=gen,
                           device="cuda", dtype=torch.int32)
    images = None if not cfg.n_image_tokens else 0.02 * torch.randn(
        (B, cfg.n_image_tokens, cfg.d_model), generator=gen, device="cuda")
    plain = _serve_pass(torch, power, f"{arch} unsharded", serve_cfg, params,
                        prompt, images, N)
    placed = place_params(params, serve_cfg, mesh)
    del params
    torch.cuda.empty_cache()
    sharded = _serve_pass(torch, power, f"{arch} on a (1, 1) mesh",
                          serve_cfg, placed, prompt, images, N,
                          Rules(serve_cfg.rule_overrides), mesh)
    lay = str(tuple(placed["tok_embed"]["w"].placements))
    del placed
    torch.cuda.empty_cache()
    same_toks = torch.equal(plain["tokens"], sharded["tokens"])
    same_logits = all(torch.equal(a, b) for a, b in
                      zip(plain["logits"], sharded["logits"]))
    as_phase = ref is None or torch.equal(
        plain["tokens"][..., :ref["tokens"].shape[-1]], ref["tokens"])
    print(f"  {arch} on a (1, 1) mesh (tok_embed {lay}), {N} new tokens: "
          f"tokens equal the unsharded run's {same_toks}, every step's "
          f"logits bitwise {same_logits}, the unsharded tokens phase "
          f"{phase}'s {'not compared' if ref is None else as_phase}; "
          f"mha_fwd by route {sharded['routes']} "
          f"(unsharded {plain['routes']})")
    for tag, r in (("mesh", sharded), ("unsharded", plain)):
        print(f"  [{power}] {arch} serving {tag}: prefill "
              f"{r['prefill_ms']:.3f} ms, decode {r['decode_ms']:.3f} ms a "
              f"step, busy {fmt_ms(r['busy_ms'])} (idle share "
              f"{'not measured' if r['idle_share'] is None else round(r['idle_share'], 3)}"
              f"), peak {r['peak_mib']:.1f} MiB above the weights")
    if not (same_toks and same_logits and as_phase
            and sharded["routes"] == plain["routes"]
            and sharded["launches"] == plain["launches"]):
        raise AssertionError(f"{arch}: serving on the (1, 1) mesh differs "
                             f"from the unsharded serving")
    for r in (plain, sharded):
        del r["logits"]
    return {"plain": plain, "mesh": sharded}


def phase_serve_mesh(torch, seed, power, serve, moe, vlm, musicgen):
    """Phase 25: sharded serving of the GQA families: (i) two ranks on the
    one card, (ii) phases 3's, 16's (cf E/k), 20's and 21's serving on a
    (1, 1) NCCL mesh beside the same serving unsharded. ``serve``,
    ``moe``, ``vlm``, ``musicgen``: those phases' results (their
    tokens; None to run phase 25 alone). -> {"launches": (i)'s and the
    mesh runs' summed, "entries", "serve": {arch: ``serve_on_mesh``'
    result}}."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    out = phase_serve_mesh_two_ranks(torch, seed, power)
    dbrx = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    full = get_arch(VLM_ARCH)
    vlm_cfg = dataclasses.replace(
        full, n_layers=VLM_BLOCKS * full.cross_attn_every)
    music = get_arch(MUSICGEN_ARCH)
    models = (("llama-130m", get_arch("llama-130m"), None, (8, 512, 64),
               serve, 3),
              (MOE_ARCH, dbrx, no_drop(dbrx), SERVE_MOE,
               moe and moe["serve"], 16),
              (VLM_ARCH, vlm_cfg, None, SERVE_VLM, vlm and vlm["serve"], 20),
              (MUSICGEN_ARCH, music, None, SERVE_MUSICGEN,
               musicgen and musicgen["serve"], 21))
    nccl_world()
    out["serve"] = {}
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        for arch, cfg, serve_cfg, shape, ref, phase in models:
            r = out["serve"][arch] = _uncounted(lambda: serve_on_mesh(
                torch, seed, power, arch, cfg, serve_cfg or cfg, shape, ref,
                phase, mesh))
            out["launches"]["mha_fwd"] = (out["launches"].get("mha_fwd", 0)
                                          + r["mesh"]["launches"])
    finally:
        dist.destroy_process_group()
    print(f"  phase 25 took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 2

    from repro_torch.kernels import _build
    t_start = time.perf_counter()

    def say(header):
        """A phase's header, with the seconds the run has taken so far."""
        print(f"{header} [{time.perf_counter() - t_start:.1f} s into the "
              "run]", flush=True)
    power = card()
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1: device {kind} (nvidia-smi: {power}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    variants = {**start_variants(XENT_VARIANTS, (SRC_XENT, SRC_HOPPER)),
                **start_variants(COLNORM_VARIANTS, (SRC_COLNORM,))}
    libs = _build.build_all()
    print(f"  built {len(libs)} kernel libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s: {sorted(libs)}")
    for name in sorted(libs):
        for line in ptxas_report(_build.build_log(name)):
            print(f"  ptxas {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    say("phase 2: kernels against their plain versions on the card")
    errs = phase_kernels(torch, gen)
    bwd_errs = phase_bwd_kernels(torch, gen)
    opt_errs = phase_optimizer_kernels(torch, gen)
    opt_errs.update(phase_update_routes(torch, gen))
    xent_errs = phase_xent_kernels(torch, gen)
    tied_errs = phase_xent_tied_kernels(torch, gen)
    seg_errs = phase_segment_kernels(torch, gen, args.seed)
    mla_errs = phase_mla_kernels(torch, gen)
    say("phase 3: greedy serving, llama-130m, full width and depth")
    serve = phase_serving(torch, args.seed, power)
    say("phase 4: kernel times (CUDA events; attention and xent also "
        "device time)")
    mha_rows = phase_timing(torch, gen, power, serve, errs)
    bwd_rows = bwd_timing(torch, gen, power, bwd_errs)
    # deepseek-v3's training attention (hd 192, hdv 128: fma) and the VLM's
    # f32 cross-attention (fma)
    mla_rows = attention_row_timing(torch, gen, power, mla_errs,
                                    "deepseek-v3 train", MLA_TRAIN_ATTN,
                                    torch.bfloat16, True,
                                    hdv=MLA_ATTN[MLA_TRAIN_ATTN][-1])
    cross_rows = attention_row_timing(torch, gen, power, {
        ("mha_fwd", VLM_CROSS, "float32"): errs[(VLM_CROSS, "float32")],
        **bwd_errs}, "llama-3.2-vision cross", VLM_CROSS, torch.float32,
        False)
    seg_rows = seg_timing(torch, gen, power, seg_errs, args.seed)
    opt_rows = optimizer_timing(torch, gen, power, opt_errs, variants)
    xent_rows = xent_timing(torch, gen, power, xent_errs)
    xent_variant_timing(torch, gen, power, variants, xent_rows)
    tied_rows = xent_tied_timing(torch, gen, power, tied_errs)
    say("phase 5: where the serving time goes (torch.profiler)")
    phase_profile(torch, args.seed, power, serve)
    say("phase 6: SCALE optimizer steps, llama-1b, full width and depth")
    opt = phase_optimizer(torch, args.seed, power)
    say("phase 7: the loss path, llama-1b, full width and depth")
    loss = phase_loss(torch, args.seed, power)
    say("phase 8: the training step, llama-1b, full width and depth")
    train = phase_train(torch, args.seed, power)
    say("phase 9: the training step, llama-7b and gemma-2b, full width and "
        "depth")
    paper = phase_paper_models(torch, args.seed, power)
    say("phase 10: the optimizer zoo, llama-1b at full width; the memory "
        "axis at full depth")
    zoo = phase_zoo(torch, args.seed, power)
    say("phase 11: fault-tolerant training, llama-1b at full width and "
        "depth: the guard, the checkpoint, resume and SIGTERM")
    res = phase_resilience(torch, args.seed, power)
    say("phase 12: tied-embedding training, llama-1b and gemma-2b, full "
        "width and depth")
    tied = phase_tied(torch, args.seed, power)
    say("phase 13: packed-document training, llama-1b, full width and "
        "depth")
    packed = phase_packed(torch, args.seed, power, train)
    say("phase 14: the telemetry plane, llama-1b, full width and depth")
    telemetry = phase_telemetry(torch, args.seed, power)
    say("phase 15: sharded training: the col_offset clause at llama-1b's "
        "head, two ranks on the card, the sharded train step")
    sharded = phase_sharded(torch, gen, args.seed, power, train)
    say("phase 16: the MoE family and the ARCH_IDS configs: dbrx-132b "
        "training and serving at full width, the four dense configs at "
        "full width")
    moe = phase_moe(torch, args.seed, power)
    say("phase 17: MLA and deepseek-v3-671b: training (4 layers, 64 "
        "experts) and serving (4 layers, 256 experts) at full width")
    mla = phase_mla(torch, args.seed, power)
    say("phase 18: Mamba2 and mamba2-370m: training and serving at full "
        "width and all 48 layers")
    mamba = phase_mamba(torch, args.seed, power)
    say("phase 19: the hybrid jamba-1.5-large-398b: training (one "
        "super-block of period 2, 4 experts) and serving (16 experts) at "
        "full width")
    jamba = phase_jamba(torch, args.seed, power)
    say("phase 20: the VLM llama-3.2-vision-11b: training (f32 images; one "
        "step with bf16 images) and serving with images at full width and "
        "depth")
    vlm = phase_vlm(torch, args.seed, power)
    say("phase 21: the audio musicgen-medium: training and serving at full "
        "width and all 48 layers")
    musicgen = phase_musicgen(torch, args.seed, power)
    say("phase 22: MoE and MLA on a mesh: two ranks on the card (dbrx-132b's "
        "and deepseek-v3's MoE layers at full width, MLA's attention with "
        "its heads over model), the sharded train steps of phases 16's and "
        "17's cuts")
    mesh = phase_mesh(torch, args.seed, power, moe, mla)
    say("phase 23: Mamba2 and the hybrid on a mesh: two ranks on the card "
        "(mamba2-370m's and jamba's Mamba2 layers at full width, half the "
        "heads a rank), the sharded train steps of phases 18's and 19's "
        "models")
    mamba_mesh = phase_mamba_mesh(torch, args.seed, power, mamba, jamba)
    say("phase 24: the VLM and audio on a mesh: two ranks on the card (the "
        "VLM's cross-attention with its heads over model, musicgen's "
        "codebook heads and embedding with the vocabulary over model), the "
        "sharded train steps of phases 20's and 21's models")
    vlm_mesh = phase_vlm_mesh(torch, args.seed, power, vlm, musicgen)
    say("phase 25: sharded serving of the GQA families: two ranks on the "
        "card (the sequence-split decode at llama-130m's and the VLM's "
        "decode shapes), phases 3's, 16's, 20's and 21's serving on a "
        "(1, 1) mesh")
    serve_mesh = phase_serve_mesh(torch, args.seed, power, serve, moe, vlm,
                                  musicgen)
    # one row per kernel; launches summed over the main paths that run it,
    # each counted from 0 just before its path and read just after
    by_path = {"serving": {"mha_fwd": serve["launches"]},
               "optimizer": opt["launches"], "loss": loss["launches"],
               "train": train["launches"],
               **{f"train {a}": r["launches"] for a, r in paper.items()},
               "train zoo": zoo["launches"],
               "train guarded": res["launches"],
               # the tied runs' xent launches under the transposed rows'
               # names (every one on a tied route: checked per step)
               **{f"train tied {a}": {
                   **{k: n for k, n in r["launches"].items()
                      if k not in XENT_KERNELS},
                   **{TIED_ROWS[k]: r["routes_run"][k][route]
                      for k, route in TIED_ROUTES.items()}}
                  for a, r in tied.items()},
               # the packed run's attention launches with segments under
               # the segment rows' names (every one: checked per step)
               "train packed": {**packed["launches"],
                                **{SEG_ROWS[k]: n for k, n in
                                   packed["segment_launches"].items()}},
               # the stats steps: norm_sumsq also takes the column norms
               "train stats": telemetry["launches"],
               # two ranks on the card and the (1, 1) mesh's train step;
               # the col_offset rows count the launches at a non-zero
               # col_offset (rank 1's shard)
               "sharded": sharded["launches"],
               # dbrx-132b's training, its serving (both capacity factors)
               # and the four dense ARCH_IDS configs' training
               "train moe": moe["train"]["launches"],
               "serve moe": {"mha_fwd": moe["serve"]["launches"]},
               "train arch": moe["arch_launches"],
               # deepseek-v3-671b's training and its serving (the prefill's
               # attention; the absorbed decode launches no kernel)
               "train mla": mla["train"]["launches"],
               "serve mla": {"mha_fwd": mla["serve"]["launches"]},
               # mamba2-370m's training (attention-free: no attention
               # kernel; its serving launches no hand-written kernel)
               "train mamba2": {k: n for k, n in
                                mamba["train"]["launches"].items()
                                if k not in ("mha_fwd", *BWD_KERNELS)},
               # jamba-1.5-large-398b's training and its serving (both
               # capacity factors: the prefill on mma, each decode step on
               # decode)
               "train jamba": jamba["train"]["launches"],
               "serve jamba": {"mha_fwd": jamba["serve"]["launches"]},
               # llama-3.2-vision-11b's training (f32 images: the
               # cross-attention on fma), its one step with bf16 images
               # (all mma) and its serving with images (the prefill's
               # cross on fma, self on mma; each decode step's on decode)
               "train vlm": vlm["train"]["launches"],
               "train vlm bf16 images": vlm["bf16_images"]["launches"],
               "serve vlm": {"mha_fwd": vlm["serve"]["launches"]},
               # musicgen-medium's training (4 codebook heads: each xent
               # kernel 4 times a step) and serving
               "train musicgen": musicgen["train"]["launches"],
               "serve musicgen": {"mha_fwd": musicgen["serve"]["launches"]},
               # two ranks on the card (MLA's attention, its heads over
               # model, forward and backward; the MoE layers launch no
               # kernel) and the sharded train steps of dbrx-132b's and
               # deepseek-v3's cuts
               "train sharded moe": mesh["launches"],
               # the sharded train steps of mamba2-370m and of jamba's cut
               # (the two ranks' Mamba2 layers launch no kernel)
               "train sharded mamba": mamba_mesh["launches"],
               # two ranks on the card (the VLM's cross-attention, its
               # heads over model, f32 and bf16; musicgen's four codebook
               # heads in vocabulary shards, rank 1's launches at
               # col_offset 1024 under the col_offset rows) and the
               # sharded train steps of the VLM and musicgen
               "train sharded vlm": vlm_mesh["launches"],
               # two ranks on the card (the sequence-split decode, each
               # rank's half of the cache on decode) and the serving runs
               # on the (1, 1) mesh: llama-130m, dbrx's cut, the VLM with
               # images, musicgen
               "serve sharded": serve_mesh["launches"]}
    # mha_fwd's prefill numbers, with both serving shapes and the eval and
    # training steps' shape beside them
    mha = {k: v for k, v in mha_rows[0].items() if k != "shape"}
    mha_rows[2]["launches"] = loss["launches"]["mha_fwd"]
    for entry, arch in zip(mha_rows[3:], PAPER_MODELS):
        entry["launches"] = paper[arch]["launches"]["mha_fwd"]
    mha_rows.append({**mha_rows[2], "shape": "train",
                     "launches": train["launches"]["mha_fwd"]})
    # MLA's attention (fma, hd 192 / hdv 128) and head at phase 17's
    # training step
    for name, entry in mla_rows.items():
        entry["launches"] = mla["train"]["launches"][name]
    mha_rows.append(mla_rows["mha_fwd"])
    # the VLM's cross-attention (fma, f32) at phase 20's training step:
    # its launches there on that route
    for name, entry in cross_rows.items():
        entry["launches"] = vlm["train"]["routes"][name]["fma"] * VLM_STEPS
    mha_rows.append(cross_rows["mha_fwd"])
    mha["shapes"] = mha_rows
    for row in bwd_rows:
        row["shapes"][0]["launches"] = train["launches"][row["name"]]
        for entry, arch in zip(row["shapes"][2:], PAPER_MODELS):
            entry["launches"] = paper[arch]["launches"][row["name"]]
        row["shapes"].append(mla_rows[row["name"]])
        row["shapes"].append(cross_rows[row["name"]])
    for row in xent_rows:
        for entry, path in zip(row["shapes"], (train, *paper.values(),
                                               mla["train"])):
            entry["launches"] = path["launches"][row["name"]]
    for row in tied_rows:
        for entry, arch in zip(row["shapes"], TIED_MODELS):
            entry["launches"] = tied[arch]["routes_run"][row["name"].split()[
                0]][row["kernel_route"]]
    rows = ([mha] + bwd_rows + opt_rows + xent_rows + tied_rows + seg_rows
            + sharded["rows"])
    # phase 24's per-rank shapes: the cross-attention's and rank 1's
    # codebook-head shard; phase 25's: each rank's half of the cache
    for row in rows:
        for phase in (vlm_mesh, serve_mesh):
            if row["name"] in phase["entries"]:
                row.setdefault("shapes", []).extend(
                    phase["entries"][row["name"]])
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in by_path.items()
                                   if c.get(row["name"])}
        row["launches"] = sum(row["launches_by_path"].values())
        row["launches_per_train_step"] = train["per_step"].get(row["name"])
        if row["name"] in train["routes"]:
            row["launches_per_train_step_by_route"] = train["routes"][
                row["name"]]
        row["launches_per_train_step_by_model"] = {
            a: {"launches": r["per_step"].get(row["name"]),
                "by_route": r["routes"].get(row["name"])}
            for a, r in (("llama-1b", train), *paper.items(),
                         (f"{MOE_ARCH} {MOE_LAYERS} layers", moe["train"]),
                         (f"{MLA_ARCH} {MLA_LAYERS} layers, "
                          f"{MLA_TRAIN_EXPERTS} experts", mla["train"]),
                         (MAMBA_ARCH, mamba["train"]),
                         (f"{JAMBA_ARCH} {JAMBA_LAYERS} layers, "
                          f"{JAMBA_TRAIN_EXPERTS} experts", jamba["train"]),
                         (f"{VLM_ARCH} {VLM_BLOCKS * 5} layers, f32 images",
                          vlm["train"]),
                         (f"{VLM_ARCH} {VLM_BLOCKS * 5} layers, bf16 images",
                          vlm["bf16_images"]),
                         (MUSICGEN_ARCH, musicgen["train"]),
                         *((f"{a} cut on a (1, 1) mesh", r)
                           for a, r in mesh["train"].items()),
                         *((f"{a} {'cut ' if a == JAMBA_ARCH else ''}on a "
                            "(1, 1) mesh", r)
                           for a, r in mamba_mesh["train"].items()),
                         *((f"{a} on a (1, 1) mesh", r)
                           for a, r in vlm_mesh["train"].items()),
                         *((f"{a} {ARCH_LAYERS} layers", r)
                           for a, r in moe["arch"].items()))}
        if row["name"] in SEG_ROWS.values():
            base = row["name"].split()[0]
            row["launches_per_train_step_by_model"] = {
                "llama-1b packed": {
                    "launches": packed["per_step_segments"][base],
                    "by_route": packed["routes"][base]}}
        if row["name"] in TIED_ROWS.values():
            base = row["name"].split()[0]
            row["launches_per_train_step_by_model"] = {
                f"{a} tied": {"launches": r["per_step"][base],
                              "by_route": r["routes"][base]}
                for a, r in tied.items()}
    for path, c in by_path.items():
        for name, n in c.items():
            # norm_apply serves only the update entry point (phase 6)
            if not n and not (path.startswith("train")
                              and name == "norm_apply"):
                raise AssertionError(f"{name} was not launched on the "
                                     f"{path} path")
    say("all twenty-five phases passed")
    print(power)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
