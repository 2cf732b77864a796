#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. the card (``nvidia-smi`` name and power limit) and the kernel build
     (``nvcc`` for sm_90a, one process per source, all started together);
  2. every CUDA kernel against its plain PyTorch version on the same card
     tensors, with ms per call: bfp_encode / bfp_decode on 2^24 elements
     and at the main path's shapes; ring_rs_update (SGD) and ring_ag at n=8
     for a small payload (4 MiB a rank) and at full width, all bit for
     bit, one launch a call, repeat launches bit-equal, GB/s beside each
     bound; both timed at the Llama path's shape (n=2, 1,923,125,248
     elements, the reduce-scatter without an optimizer) and held bit for
     bit at whole tiles of each chunk (first, last, middle, and the two
     beside flat offset 2^31) against the plain versions on those tiles;
     paged_attend at decode (R=16, H=32, T=1: keys split over blocks) and
     prefill (R=1, T=256: wgmma) shapes, GQA and MHA, page sizes 16 and
     128, within 5e-5, repeat launches bit-equal, HGMMA counted in the
     prefill kernel's SASS;
     flash_fwd, flash_dq and flash_dkv at the training path's shape (B=1,
     H=32, Hkv=8, S=4096, hd=128, causal, bf16) and a non-causal MHA
     shape (S=1024), within a bf16 limit that two fault controls (the
     causal mask shifted by one key; the backward at lse + 0.05) exceed,
     with repeat launches of all three bit-equal and HGMMA (wgmma)
     instructions counted in their SASS, timed beside PyTorch's
     scaled_dot_product_attention as a yardstick;
     int8_encode / int8_decode (sublane layout, block 16) at 10,240 and at
     the int8 path's 41,963,520 elements, both roundings and seeds 0 and
     7, bit for bit, with a control (seed 1 against seed 0 must differ);
     then the encode's division over every pair of an f32 significand and
     a bf16 scale significand (2^30 pairs) and over exponent extremes
     (subnormal x, scales from 0 to 2^121, underflowing quotients, NaN
     and +-inf blocks), bit for bit, with a flipped-bit control; the
     codec kernels' ``ms`` is their device time (torch.profiler),
     ``call_ms`` whole calls (CUDA events), and the encode's SASS counts
     its conversion, MUFU and call instructions;
     ring_rs with its checksum pair (the integrity launch) at 4 MiB a rank
     and at the MLP width, with SGD and without an optimizer: the pair
     bit-equal to the plain version's, g and w to the launch without it,
     device time with and without, in turns; row_checksums
     (csrc/checksum.cu) against its plain version on u8, bf16 and f32
     rows of odd lengths, on the serving pool (64 x [2049, 8, 16, 128]
     bf16, with a flipped-bit control) and on the MLP replicas, device
     time beside the bytes bound;
  3. a small reference: a 3-layer MLP, 4 ranks, 3 steps on the card against
     the same steps on the CPU (plain versions);
  4. the training path: ``DPTrainer`` on the canonical MLP (10 x 2048x2048,
     f32), global batch 5376, dp=8 virtual ranks, BFP ring with fused
     kernel and fused SGD — 1 warm-up and 5 timed steps, launch counts
     checked (one ring_rs_update and one ring_ag a step) — then one more
     step whose gradients also go through the plain collectives, whose
     masters must be bit-equal to the kernels', and through the codec
     route (fused_kernel=False: the unfused rings on the bfp_encode /
     bfp_decode kernels), launches counted, masters and replicas
     bit-equal;
  5. two more training steps under torch.profiler: device time by group
     (the port's kernels, GEMMs, the rest) and the device's idle share;
     then ``integrity_path``: the same trainer with
     ``integrity_check=True``, 1 warm-up and 5 timed steps (both verdicts
     true every step; one ring_rs_update with its pair, one ring_ag and
     one row_checksums launch a step), masters and replicas bit-equal to
     an integrity-off trainer's on the same batch, ms/step of both; the
     codec route with a ``wirebit`` fault on the wire (WireIntegrityError,
     the update gated, finite outputs) and a ``scale`` fault at the
     collective tap (IntegrityError), each after a clean step; the int8
     path (dp=2) with integrity, bit-equal to off;
  5b. ``fsdp_path``: ZeRO-3 (``FSDPTrainer``) on the canonical MLP, fsdp=8,
     the same batch, the BFP ring kernels (the gather's forward ``ring_ag``,
     its backward the reduce-scatter kernel without an optimizer) and the
     fused SGD formula: 1 warm-up and 5 timed steps, one launch of each a
     step, peak memory; two steps' masters bit-equal to the plain route's
     (``plain_collectives``); the reduce-scatter kernel at this shape by
     device time beside its bound;
  5c. ``hier_path``: ``DPTrainer`` at dp=8 with ``topology="hier"`` at
     intra_size 2 and 4 (the sublane BFP codec on the slow hop only, the
     ``bfp_codec.cu`` kernels, fused SGD): 3 timed steps each, the codec
     launches against the phase program, the wire bytes by phase, two
     steps' masters bit-equal to the plain route's; the flat separate-op
     codec route timed beside;
  5d. ``ring_cost_stages``: the ablate=None reduce-scatter's SASS and output
     digests against the kernel from before the stage parameter
     (``RING_RS_SASS``, ``RING_RS_DIGESTS``), then ``ring_cost.decompose``
     fed by every ablate= stage's device time, at the MLP's shape
     (streaming stages, SGD) and at 4 MiB a rank (resident stages), each
     stage measured (a stage error fails the phase);
  5e. the tuner on the MLP cell (dp=8, batch 5376, SGD):
     ``live_calibrate`` (the uncompressed ring and every registered
     codec timed by CUDA events on the card's virtual ranks, at 65,536
     elements and at the MLP's payload: live-tier rates, not dryrun);
     ``auto_dp_path`` (``DPTrainer`` with ``codec="auto"`` and live
     calibration: the resolved plan, its modeled collective beside the
     measured ring, two steps' masters bit-equal to a ``DPTrainer`` built
     by hand with the resolved config); ``adaptive_path``
     (``AdaptiveTrainer`` with 3 candidates: prewarm, steps, one
     ``inject_shift``, the switch event, ``recompiles_across_switch`` 0
     (by construction), the switching step's ms, wall ms, reserved bytes
     and allocated segments beside a steady step's,
     the masters one step after the switch bit-equal to the target
     plan's trainer stepped from the migrated state, ms/step before and
     after);
  6. the int8 codec path: ``DPTrainer`` on the canonical MLP at dp=2 (each
     rank's chunk of 20,981,760 elements is whole (16, 128) tiles without
     padding) with ``codec="int8"`` on the sublane kernels and fused SGD
     — 1 warm-up and 5 timed steps, launch counts checked; one more step's
     gradients through ``Int8Codec(plain=True)``, whose masters and
     replicas must be bit-equal; a profile of two steps; then the codec
     convergence eval (baseline, top-k with error feedback, int8) on the
     eval MLP at dp=8 for 40 steps, which reports loss ratios;
  7. the serving path: ``ServeEngine`` on Llama-3-8B (all 32 layers, bf16,
     random weights from a seed) answers 24 requests (prompts of 128-1024
     tokens, 32 new tokens each) over a 2049-page pool with 16 slots,
     page checksums on (row_checksums, two launches a step); launch counts
     and zero faults checked, then a profile of one decode and one
     prefill step and of one page-checksum pass;
  8. serving parity: one decode step's and one prefill chunk's operands,
     snapshotted during the run, through ``forward_paged`` with the kernel
     and with the gathered-view reference (logit error within a stated
     limit that three fault controls exceed); and the first 4 streams
     against the port's contiguous-cache ``generate()``, counted;
  9. the Llama training path: ``ShardedTrainer`` as the ``train_llama``
     driver builds it, Llama-3-8B width with 4 layers (random weights from
     a seed), attn_block 512 on the flash kernels, sequence 4096, global
     batch 2 over dp=2 virtual ranks, BFP ring kernels, SGD — 1 warm-up
     and 5 timed steps, launch counts, equal replicas in the model dtype
     and peak memory;
 10. two more training steps under torch.profiler (flash kernels, ring and
     BFP kernels, GEMMs, the rest);
 11. training parity: loss_fn's gradients on one rank's batch through the
     kernels and through the checkpointed plain route, within a stated
     limit that a fault control (one layer's mask shifted) exceeds;
 12. ``auto_route``: the tiny f32 Llama config (head_dim 16) with
     attn_impl="auto", which takes the flash kernels as JAX's route takes
     Pallas on a TPU, here the second family (csrc/flash_generic.cu):
     its forward, dq and dk/dv against their plain versions at the
     model's attention shape (f32 limits, repeat launches bit-equal, a
     shifted-mask control), then one step whose launches are counted
     (the second family only), and the step's gradients against the
     torch route's on the same weights;
 12b. ``flash_offset_checks``: the flash kernels' q/k offsets (the sp
     ring's past hop and diagonal, the gathered shape, a shift of 100 that
     cuts through the tiles, a chunk wholly in the future) against the
     plain versions: the tensor-core forward, dq and dk/dv at a ring hop's
     width (B=1, H=32, Hkv=8, 2048 rows, hd=128, bf16) and the second
     family in f32 (H=8, Hkv=2, hd=64, 512 rows), after the zero-offset
     launches' output digests against the pinned ones; within the limits, a
     second launch bit-equal, zeros where nothing is seen, the lse + 0.05
     and the offsets-dropped controls above the limit; the offset
     instantiations' SASS; the tensor-core kernels timed by device time at
     the past hop and the diagonal beside the bound, the plain version and
     the library's attention;
 12c. ``llama_sp_train_path``: ``ShardedTrainer`` at Llama-3-8B width, 4
     layers, sequence 8192, global batch 2 over dp=2 x sp=4 virtual ranks
     (ring attention over the sp shards of each dp rank), the BFP ring
     kernels, SGD — 1 warm-up and 3 timed steps on one batch, launches
     counted (32 a step of the flash kernels without offsets and 48 of
     their offset instantiations, one ring_rs_update and one ring_ag, no
     second-family launch), replicas bit-equal, the loss falling; then a
     profile of two steps (flash, ring, the K/V rotations, GEMMs, the
     rest);
 12d. ``llama_sp_parity``: at that width, sequence 8192 and 2 layers,
     one row: the sp=4 kernel ring's loss and gradients against sp=1 (the
     unsharded flash path) and against the sp=4 plain ring, within the
     Llama parity limits, and the kernel ring with its hops merged
     without their lse weights (the fault control) above them;
 13. ``bert_flash_checks``: the flash kernels' key-bias channel (BERT's
     padding mask, 0 / -1e30 a key) against the plain versions with the
     same bias: at BERT-base's attention shape (B=8, H=12, S=512, hd=64,
     bf16, non-causal, valid lengths 256-512) the second family's three
     kernels, and the tensor-core forward, dq and dk/dv (their
     head_dim-64 instantiations, with and without the bias, HGMMA and no
     spills in their SASS), all timed by device time beside the bound,
     the plain version and the library's masked attention; the
     tensor-core kernels at B=2, H=8, S=1024,
     hd=128, non-causal and causal with the mask, timed with and without
     the bias in turns, their bias instantiations' SASS counted; each
     within the flash limits, a second launch bit-equal, and the same
     kernels with a zero bias (the mask dropped) above the limit (without
     a bias: the plain backward at lse + 0.05);
 14. ``bert_train_path``: BERT-base masked-LM training as the
     ``train_bert`` driver builds it (12 layers at full width, random
     weights from a seed, sequence 512, global batch 64 over dp=8 virtual
     ranks, valid lengths 256-512, 15% masked, the bucketed
     ``DDPTrainer`` with the fused BFP ring kernels on every bucket,
     AdamW lr 1e-4 on the replicated f32 masters) — 2 warm-up and 5 timed
     steps, launch counts (96 a step of the tensor-core forward, dq and
     dk/dv, one ring reduce-scatter and one all-gather a bucket, nothing
     else), every
     rank's replica bit-identical after every step, a falling loss, then
     a profile of one step (flash, ring, GEMMs, the rest);
 15. ``bert_train_parity``: loss_fn's gradients on one rank's padded batch
     at BERT-base width and 2 layers through the kernels and through the
     plain softmax route, within the Llama parity limits, and the kernels
     with a zero key bias (the fault control) above them;
 16. ``resnet_train_path``: ResNet-50 data-parallel training as the
     ``train_resnet`` driver builds it (bf16, random weights from a seed,
     224x224 images of train_resnet's stream, global batch 256 over dp=8
     virtual ranks, ``DPTrainer`` with sync-BN over the ranks in one
     autograd graph, the fused BFP ring kernels with the fused momentum
     SGD, lr 0.1, momentum 0.9, weight decay 1e-4) — 2 warm-up and 5
     timed steps on one batch already on the card, launch counts (one
     ring_rs_update and one ring_ag a step, no other port kernel), every
     rank's replica bit-equal after every step, the loss on the repeated
     batch falling, peak memory; one more step whose gradients also go
     through the plain collectives (masters and momentum shards
     bit-equal); ring_rs_update (momentum) and ring_ag timed at this
     shape (n=8, 3,194,880 f32 a rank); a profile of one step (ring,
     convolutions, the fc GEMM, the BN/elementwise rest, idle share);
     then ``train_resnet.main`` with its loader drawing the stream on
     the host;
 17. ``resnet_train_parity``: at ResNet-50 width, 64 images (8 a rank),
     the joint graph's gradients summed over the ranks over n against
     ``loss_fn`` on the whole batch through one replica, in f32 within a
     limit that per-rank moments (the control) exceed; the floor (the
     batch permuted) and the bf16 model's numbers reported beside;
 18. ``moe_train_path``: Mixtral-8x7B width (dim 4096, 32/8 heads, ffn
     14336, vocab 32000, 8 experts top-2, capacity factor 2, aux weight
     0.01, bf16, random weights from a seed), 1 layer, sequence 4096,
     global batch 4 over dp=2 x ep=2 virtual ranks as ``train_llama``
     builds it (``ShardedTrainer`` on JAX's (ep, dp) master layout, the
     MoE loss over all ranks in one graph, the flash kernels, the BFP
     ring kernels within each ep group, SGD) — 1 warm-up (its expert
     stats) and 5 timed steps on one batch, launches counted (4 a step of
     each tensor-core flash kernel, one ring_rs_update and one ring_ag an
     ep group), replicas bit-equal within each ep group and their
     replicated leaves across the groups, the f32 router held apart, the
     loss falling; the ring kernels timed at this shape; a profile of two
     steps (flash, ring, expert GEMMs, dense GEMMs, dispatch/combine, the
     rest);
 19. ``moe_train_parity``: at that width, 1 layer, one sequence on each
     of ep=2 ranks: the kernel route's loss and gradients against the
     plain attention route (expert choices pinned to the kernel route's)
     and against dp=2 x ep=1, within the Llama parity limits, the ep
     exchange with its destinations swapped (the control) above them,
     the flip share reported;
 20. ``moe_serving_path``: ``ServeEngine`` at Mixtral-8x7B width with 8
     layers, the serving path's config and requests, its parity (routing
     pinned to the kernel route's, the unpinned error reported) and its
     first 4 streams against ``generate()``, counted;
 21. ``moe_sp_hop_checks``, ``moe_sp_train_path`` and
     ``moe_sp_train_parity``: sp with MoE over dp=2 x sp=2 x ep=2 at
     Mixtral-8x7B width, remat and a clip (the hop's flash kernels, the
     path, its parity);
 22. ``llama_pp_train_path``: ``ShardedTrainer`` at Llama-3-8B width, 4
     layers, sequence 4096, global batch 8 over dp=2 x pp=2 virtual
     ranks (one flat row a (pp, dp) rank: a stage's 2 layers and its
     copy of the embedding, final norm and head), 4 microbatches of one
     sequence, remat, the flash kernels, the BFP ring kernels within
     each stage group, SGD lr 0.1 — under ``gpipe``, ``1f1b`` and
     ``1f1b-interleaved`` (v=2, a layer a chunk) in turn: 1 warm-up and
     3 timed steps on one batch, launches counted (a (dp rank,
     microbatch, layer): 2 flash forwards under GPipe, 3 under 1F1B,
     one dq and one dk/dv; one ring_rs_update and one ring_ag a stage
     group), replicas bit-equal within each stage group and the
     replicated leaves across the groups, the loss falling, peak memory,
     ``pipeline_cost``; under GPipe the ring kernels timed at the stage
     row's shape; a profile of two steps (flash, ring, GEMMs, the rest;
     idle share); ``llama_pp_memory`` sets the schedules' peaks side by
     side (the 1F1B run at 8 microbatches is cut to make room for the tp
     phases);
 23. ``llama_pp_train_parity``: at that width, sequence 1024, batch 4
     over dp=2 x pp=2, 2 microbatches, two steps each: GPipe on the plain
     attention route, 1F1B, interleaved 1F1B and the dp=2 path at pp=1
     against GPipe on the kernels, the losses within 2e-3 and the
     updated masters (every stage's layers, every stage's copy of the
     replicated leaves, by model layer) within 0.05 of the reference's
     update, bit-equality reported; the interleaved masters read without
     their layer permutation (the control) above the limit;
 24. ``llama_pp_sp_train_path``: the pipeline with sp, at Llama-3-8B
     width, 4 layers, sequence 8192, global batch 4 over dp=2 x pp=2 x
     sp=2, 2 microbatches of one sequence, remat, the BFP ring kernels
     within each stage group, SGD lr 0.1, under each schedule (GPipe on
     the ring attention, the 1F1B schedules on the gathered attention):
     1 warm-up and 3 timed steps (GPipe and 1F1B; the interleaved
     schedule's run is cut for the tp phases), launches counted by
     instantiation
     (``pp_axes_per_step``), the replicas and the replicated leaves
     checked, the loss falling, the step's and the backward's peaks,
     ``pipeline_cost``, a profile of two steps;
 25. ``moe_pp_train_path``: the pipeline with ep, sp and MoE layers, at
     Mixtral-8x7B width, 2 layers (one a stage), sequence 8192, global
     batch 4 over dp=1 x pp=2 x ep=2 x sp=2, 2 microbatches, remat, clip
     1.0, under GPipe and 1F1B: as 24, plus ``drop_frac`` (at dp=1 the
     reduce-scatter is the identity: no ring_rs_update launches);
 26. ``llama_pp_sp_train_parity``: 23 at sequence 1024 over dp=2 x pp=2 x
     sp=2 (GPipe on the plain attention, 1F1B, interleaved 1F1B and the
     dp=2 x sp=2 path at pp=1 against GPipe on the kernels);
 27. ``moe_pp_train_parity``: at Mixtral-8x7B width, 2 layers, sequence
     1024, batch 4 over dp=1 x pp=2 x ep=2 x sp=2, capacity factor 4
     (nothing drops): the whole tree's gradient under 1F1B, GPipe on the
     plain attention and the sp x ep path at pp=1 against GPipe on the
     kernels, the experts pinned to the reference's a token at a time,
     within the Llama parity limits (the unpinned errors and flip shares
     beside), the ep exchange swapped (the control) above them;
 29. ``tp_flash_checks``: the tensor-core flash kernels at the tp
     path's launch (B=2, H=32, Hkv=8, S=4096: a dp rank's batch, both tp
     ranks' heads) and at one tp rank's heads (H=16, Hkv=4), against
     their plain versions, timed beside plain, library and bound;
 30. ``llama_tp_train_path``: 9-11's path at global batch 4 over dp=2 x
     tp=2 (Megatron's split: a flat row a (tp, dp) rank, one flash launch
     a layer and dp rank for both tp ranks' heads, one ring
     reduce-scatter and all-gather a tp group), launches counted, the
     replicas and the replicated leaves checked, the ring kernels timed
     on a tp group's rows, peak memory and the flat rows' share, a
     profile; ``llama_tp_train_parity``: two steps at dp=2 x tp=2
     against dp=2 x tp=1 from the same weights and batch (masters within
     0.05 of the update, losses within 2e-3), the loss differentiated
     once a tp rank (the control) above the limit;
 31. ``moe_tp_train_path``: 18's MoE path over dp=2 x tp=2 x ep=2 (each
     expert's hidden split over tp), and ``moe_tp_train_parity``: the
     gradients at tp=2 against tp=1, experts pinned, the ep exchange
     swapped (the control) above the limit;
 32. ``tp_serving_path``: Llama-3-8B, 32 layers, the serving cell's
     ``ServeConfig`` (page ledger off: a tp tick refuses it) with
     ``tp_mesh`` of tp=2, 8 requests, then the tp=1 engine on the same
     requests: ms/tick, TPOT, tokens/s, paged launches a tick, the token
     agreement share; the tp step's logits against the tp=1 step's on the
     same pool snapshots within 0.1875, the tp ranks' heads out of rank
     order (the control) above it; the paged kernel timed on the
     snapshot's pool;
 33. ``pp_tp_flash_checks`` (the flash kernels at the pp x tp launch:
     B=1, H=32, Hkv=8, S=4096, a microbatch with both tp ranks' heads),
     ``llama_pp_tp_train_path`` (Llama-3-8B width, 4 layers, sequence
     4096, batch 4 over dp=1 x pp=2 x tp=2, 4 microbatches, remat, GPipe,
     1F1B and interleaved 1F1B (v=2): launches counted, replicas and the leaves that replicate
     over tp checked, ``ring_ag`` checked bit for bit on sampled tiles
     and timed on a (tp, pp) row, peak memory, a profile) and
     ``llama_pp_tp_train_parity`` (at sequence 2048, the path's
     microbatches and 2 layers, under GPipe and 1F1B: two steps' masters at pp=2 x
     tp=2 against pp=2 x tp=1 within 0.05 of the update, losses within
     2e-3, the loss backwarded once a tp rank above the limit);
 36. ``accum_path``: the MLP main path at ``accum_steps=4`` against 1
     (both trainers' gradient rows at the same weights within rtol 2e-5
     / atol 2e-6 at each of two steps; step 1's decoded ring sums apart
     by at most one grid step of each element's BFP block; two steps'
     masters following the decoded sums, and within JAX's tolerance plus
     one such grid step a step; losses within 1e-5; one ring_rs_update
     and one ring_ag launch a step at both),
     then the Llama cell (batch 4 over dp=2) at ``accum_steps=2`` beside
     1: ms/step, peak memory (not above), flash launches a step;
 37. ``llama_data_path``: ``train_llama --data=SURVEY.md
     --accum_steps=2`` at the Llama cell (tokens/s, losses, the -100
     share, the seconds to the first batch) and ``llama_data_parity``:
     two such steps on the flash kernels against the plain attention
     route (the update within 0.05, losses within 2e-3);
 38. ``codec_auto_path``: ``BFPConfig(codec="auto")`` and
     ``Int8Codec(backend="auto")`` on the MLP: bit-equal to "pallas" at
     tiling rank payloads (dp=8 fused, dp=2), to "xla" at one that does
     not (dp=8 separate-op), each route's kernel launches counted;
 39. ``queued_path``: ``QueuedDDPTrainer`` (``--queue=explicit``) on the
     MLP cell and on the BERT cell against the fused ``DDPTrainer``:
     masters bit-equal after two and five steps, at most 8 in flight,
     none abandoned, ms/step of both and the queue's counters;
 40. ``staging_check`` (right after the build): the port's
     ``csrc/staging.cpp`` built with g++ and one native epoch equal to
     the numpy path;
 41. the serving fleet (after 8, on its random weights and serving
     config: Llama-3-8B, 32 layers, replicas as slots on the card sharing
     the weights, a pool each; seeded tick-domain traffic, 12 requests,
     prompts of 128-1024 tokens, 16-32 new): ``fleet_path`` (1 prefill +
     2 decode replicas: every stream equal to the single engine's, one
     handoff a request, no replay, each role only its step, paged_attend
     and row_checksums launches against the steps; one 64-page handoff
     bit for bit, bystanders and source unchanged, timed beside its
     bound; the walls of fleet, single engine, fleet, single engine in
     that order), ``fleet_kill`` (a decode replica preempted at tick 11: its
     live requests migrate, streams byte-identical to ``fleet_path``'s,
     no replay, MTTR), ``fleet_handoff_integrity`` (a ``wirebit`` on the
     first handoff's wire: the landed-page check trips, one retry, no
     replay, streams unchanged), ``fleet_autoscale`` (the herd on a
     1 + 1 fleet with 4 slots a replica and one spare slot: the
     autoscaler scales out, no token lost, every stream not replayed
     equal to the single engine's; its decisions and SLO snapshot);
     then ``generate_llama``'s default run;
 42. ``elastic_path`` (after the MLP phases): JAX's seven fault cells on
     ``ElasticTrainer`` over the main path's trainer with integrity on
     (4 steps a cell, mirrored checkpoints every 2 steps, ``keep_last=2``,
     the fault at step 3; the collective cell on the codec route, the
     others on the fused kernels): each spec fires once, the masters end
     bit-equal to the fault-free steps, ``slowdown@staging`` recovers
     nothing; MTTR, save seconds by part, every watchdog thread joined;
 43. ``durability_path``: the same state, ``shards=8``, mirrored: audit,
     peer repair bit-exact, a double corruption refused, a stale
     manifest walked back, kill and diskfull at ``ckpt.save``, an
     emergency dump, a BFP-compressed save (ratio, error bound), the
     restored step bit-equal at dp=8 and finite at dp=4;
 44. ``serve_chaos_path`` (after 41, on the serving weights): 8 requests
     fault-free, then under a hang past ``step_timeout_s``, an exception,
     a preemption, a ``wirebit`` and a ``nan`` corruption of the pool
     (the page ledger trips), then a ``nan`` with the ledger off (the
     logit guard trips); streams equal to the fault-free ones or apart
     at a top-2 margin under 0.1;
 45. ``ckpt_driver_path`` (after ``auto_route``): ``train_llama --save=``
     at the tiny config, then ``generate_llama --ckpt=``, equal to
     ``generate()`` on the restored parameters;
 46. ``reshard_path`` (after 43, MLP full width): the main trainer (dp=8,
     fused BFP ring kernels, SGD lr 0.1) two steps, moved to dp=4 by
     ``parallel.reshard`` and held against the same state built at dp=4
     by the restore path (masters and replicas bit-equal), a third step
     on each (masters and loss bit-equal); fused AdamW (three leaves) and
     int8 with error feedback (the residual against the numpy golden)
     moved 8 -> 4; the dp=4 state shrunk to 2 and grown to 8 (value-
     exact); each move's transfer timed by CUDA events against its bytes
     bound with integrity off and on in turns, a one-word wirebit at
     ``reshard.transfer`` tripping the checked transfer, peak memory, the
     wire and seed counters equal to the plan's bytes, and the plans'
     bytes at the JAX package's layout checked against its numbers;
 47. ``elastic_reshard_path``: ``ElasticTrainer`` with
     ``ReshardPolicy(shrink_to=(4, 2))``, prewarmed, integrity on: two
     preemptions recovered by reshard (dp=8 -> 4 -> 2, no checkpoint
     read), the masters bit-equal to a run stepping natively at those
     widths; the same preemption under the reshard and the restore tier
     in turns (MTTR of both); a wirebit on the reshard wire falling
     through to the restore tier;
 48. ``obs_path``: the main path with ``obs_metrics`` off and on in turns
     (ms/step, launches off equal to the main path's, masters bit-equal),
     ``codec_obs_rel_err`` within the declared bound (BFP; int8 at dp=2),
     the on steps under ``torch.profiler`` in a ``torch_profile`` span and
     the timeline written and parsed back (events a lane),
     ``train_mlp --trace-dir`` on the fused route and on
     ``--queue=explicit`` (the trace summaries), ``obs_demo`` on the card;
 49. ``helpers_path`` (after 48): ``fused_update.all_reduce_mean`` of the
     MLP's gradient tree at dp=8 on the ring kernels, bit-equal to the
     plain route and, at 4 MiB a rank, to the numpy ring golden;
     ``bucketed.all_reduce_bucketed`` of BERT-base's bf16 gradients, each
     leaf bit-equal to its flat segment; ``bfp.bfp_ste`` forward and
     gradient bit-equal; each item's ms and launches;
 50. ``llama_data_axes_path`` (after ``llama_data_path``): ``train_llama
     --data=SURVEY.md`` at Llama-3-8B width over dp=2 x sp=2 and at
     Mixtral-8x7B width over dp=2 x ep=2, 1 layer and 2 steps each,
     finite losses, the flash kernels every step, the rings once a step;
 51. ``explicit_grads_path``: ``ShardedTrainer(loss_and_grads_fn=)`` at
     pp = 1 (Llama-3-8B width, 1 layer, dp=2, 2 steps), masters and
     replicas bit-equal to the autograd route's;
 52. ``eval_bfp_path`` (after the codec convergence eval): ``eval_bfp
     --models=mlp_fsdp`` at 20 steps and 2 seeds into a temporary
     directory, finite losses;
 53. ``hop_kernel_checks`` and ``procs_ring_path`` (after 49): the
     cross-process hop kernels (``csrc/ring_hop.cu``) against their plain
     versions at the MLP row's chunk over 4 ranks, BFP and raw f32
     frames, ms beside the bytes bound; 4 worker processes on the card
     (gloo group, CUDA IPC peer buffers, killed on a timeout): the ring
     on ``MLPConfig()``'s flat row under SGD and AdamW, BFP and f32
     frames, bit-equal to the one-process route, then 4
     steps of ``DPTrainer`` across them bit-equal to ``DPTrainer(dp=4)``
     in this process, the median step ms of both after the first;
 34. the ``kernels`` line (the offset instantiations' rows among them,
     the ablated ring_rs instantiations' rows from ``ring_cost_stages``,
     their launches from ``llama_sp_train_path``; the MoE paths'
     launches and ring times as ``moe_*`` keys, the pipeline's as
     ``pp_*`` keys, the pipeline with sp and ep's as ``pp_sp_*`` and
     ``moe_pp_*``, the tp paths' as ``tp_*`` and ``moe_tp_*``, the pp x tp
     path's as ``pp_tp_*``, the new phases' launches as ``accum_*``,
     ``data_path_*``, ``codec_auto_*`` and ``queued_*``, the fleet's as
     ``fleet_*``, the restore tier's as ``elastic_*``, ``durability_*``,
     ``serve_chaos_*`` and ``ckpt_driver_*``, the reshard tier's and
     observability's as ``reshard_*``, ``elastic_reshard_*`` and
     ``obs_*``, the helpers' as ``helpers_*``, the ``--data=`` axes' as
     ``data_axes_*``; the hop kernels' launches are rank 0's of
     ``procs_ring_path``), then the
     last line ``{"ok": true, "device":
     {...}}``.

TF32 is off for matmuls and cuDNN, so the f32 GEMMs run in full float32.
Any failed phase raises and the script exits nonzero; without CUDA, or
without the rest of the repository beside it, it exits nonzero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores


_T0 = time.perf_counter()


def emit(**kw) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps(dict(kw, elapsed_s=time.perf_counter() - _T0)),
          flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, names) -> float:
    """Device time per call of the kernels whose names hold one of
    ``names``, from torch.profiler over windows of ``reps`` calls after a
    warm-up: the kernel's own time where a call's host work (checks,
    allocation, the launch) takes longer than the kernel, so events around
    the calls would time the host.  Each call launches one such kernel.  A
    trace may miss some of them (on an H100 one held 9 of 10, another 9 of
    20), so the time is the mean over the kernels the traces hold, pooled
    over up to three windows until they hold half as many as one window
    launched.  Where the traces hold fewer than three in all, the time is
    the calls' own, from CUDA events (host gaps included), and a note says
    so on standard error."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        window = [ev.device_time_total for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA
                  and any(n in ev.name for n in names)]
        if len(window) > reps:
            raise AssertionError(f"device_ms: more than one kernel of "
                                 f"{names} a call")
        evs += window
        if 2 * len(evs) >= reps:
            return sum(evs) / 1e3 / len(evs)
    if len(evs) >= 3:
        return sum(evs) / 1e3 / len(evs)
    print(f"device_ms: the traces held {len(evs)} kernel events of {names} "
          f"in {3 * reps} calls; timing the calls with CUDA events",
          file=sys.stderr)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    b, o = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(b, o), ("bytes" if b >= o else "operations")


def max_err(pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def require_equal(name: str, pairs) -> None:
    for a, b in pairs:
        if a.shape != b.shape or not bool((a == b).all()):
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"(max abs err {max_err([(a, b)])})")


PORT = "fpga_ai_nic_tpu_torch"
REF = PORT.removesuffix("_torch")     # the JAX package's directory
RING_KERNELS = ("bfp_encode_kernel", "bfp_decode_kernel",
                "ring_rs_kernel", "ring_ag_kernel")
FLASH_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                 "flash_fwd_generic_kernel", "flash_dq_generic_kernel",
                 "flash_dkv_generic_kernel")
INT8_KERNELS = ("int8_encode_kernel", "int8_decode_kernel")
PAGED_KERNELS = ("paged_prefill_kernel", "paged_decode_kernel")
PORT_KERNELS = RING_KERNELS + PAGED_KERNELS + FLASH_KERNELS + INT8_KERNELS
GEMM_NAMES = ("gemm", "cutlass", "xmma", "sm90_", "nvjet")


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# steps profiled on the BERT and ResNet-50 paths (cut from 2 on a slow
# host: reading back their traces, tens of thousands of kernels a step,
# took 21 and 29 s of host time)
HOST_HEAVY_PROFILE_STEPS = 1


def profile_run(phase: str, run, steps: int, groups=None, op_groups=None,
                **extra) -> dict:
    """Device time of ``steps`` calls of ``run`` by group (``groups``:
    name -> kernel-name substrings, by default the port's kernels; then
    GEMMs and the rest) and the device's idle share, from torch.profiler;
    emits one line and returns the groups.  ``op_groups`` (name -> aten op
    name substrings) takes every kernel an op of the group launched (the
    innermost op the trace links it to) out of its name's group: cuDNN's
    convolutions run GEMM-named kernels too."""
    kernel_groups = groups or {"port_kernels": PORT_KERNELS}
    op_groups = op_groups or {}
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def name_group(name):
        group = next((g for g, keys in kernel_groups.items()
                      if any(k in name for k in keys)), None)
        if group is not None:
            return group
        return "gemm" if any(k in name.lower() for k in GEMM_NAMES) \
            else "other"

    groups = {g: 0.0 for g in list(kernel_groups) + list(op_groups)
              + ["gemm", "other"]}
    group_top = {g: [] for g in groups}
    by_name = {}
    for ev in prof.events():                  # device-side events only:
        if ev.device_type != DeviceType.CUDA:  # CPU ops would count their
            continue                           # kernels a second time
        ms, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.device_time_total / 1e3, cnt + 1)
    taken = {g: {} for g in op_groups}    # op group -> name -> (ms, n)
    for ev in prof.events():
        group = next((g for g, keys in op_groups.items()
                      if any(k in ev.name for k in keys)), None)
        if ev.device_type != DeviceType.CPU or group is None:
            continue
        for k in ev.kernels:
            ms, cnt = taken[group].get(k.name, (0.0, 0))
            taken[group][k.name] = (ms + k.duration / 1e3, cnt + 1)
    top = []
    for name, (ms, cnt) in by_name.items():
        top.append((ms, name[:80], cnt))
        for group in op_groups:
            t_ms, t_cnt = taken[group].get(name, (0.0, 0))
            if t_cnt:
                groups[group] += t_ms
                group_top[group].append((t_ms, name[:100], t_cnt))
                ms, cnt = ms - t_ms, cnt - t_cnt
        if cnt:
            group = name_group(name)
            groups[group] += ms
            group_top[group].append((ms, name[:100], cnt))
    busy = sum(groups.values())
    n_kernels = sum(cnt for _, cnt in by_name.values())
    top.sort(reverse=True)
    emit(phase=phase, steps=steps, wall_ms=wall_ms,
         device_ms=busy if busy else "not measured",
         device_ms_by_group=groups, kernels_traced=n_kernels,
         idle_share=(1 - busy / wall_ms) if busy else "not measured",
         top=[{"ms": t, "name": nm, "count": c} for t, nm, c in top[:12]],
         top_by_group={g: [{"ms": t, "name": nm, "count": c}
                           for t, nm, c in sorted(v, reverse=True)[:3]]
                       for g, v in group_top.items()}, **extra)
    return {"wall_ms": wall_ms, "device_ms": busy,
            "kernels_traced": n_kernels, **groups}


# -- ring collectives: one launch a call, against plain, at the paths' shapes -

LLAMA_RING = (2, 1_923_125_248)   # Llama path: dp=2, padded flat length


def ring_bytes(n, L, C, opt_shards=0):
    """Bytes the whole reduce-scatter (+ update) and the whole gather must
    move: x read once and g written (and each optimizer shard read and
    written); the owned chunks read once and n replicas written."""
    return 4 * (n * L + n * C + 2 * opt_shards * n * C), 4 * (n * C + n * L)


def tile_sample(t, n_chunks, tile, picks):
    """[rows, n_chunks * C] -> [rows, n_chunks * len(picks) * tile]: the
    tiles ``picks`` of each chunk, in order.  Every output of either ring
    depends only on the inputs at its own offset of each chunk
    (tests/test_torch_ring.py -k offset), so the rings of the sampled
    inputs give the full rings' outputs at the sampled tiles."""
    import torch
    C = t.shape[1] // n_chunks
    return torch.cat([t[:, c * C + p * tile:c * C + (p + 1) * tile]
                      for c in range(n_chunks) for p in picks], dim=1)


def ring_checks(dev, cfg, sgd, n, L_full) -> dict:
    """ring_rs_update (SGD) and ring_ag against their plain versions, bit
    for bit, at a small payload (4 MiB a rank) and at the MLP path's
    width: one launch a call, repeat launches bit-equal, ms beside the
    bound and the achieved GB/s.  Then the Llama path's shape (n=2,
    reduce-scatter without an optimizer, then the gather), timed; the
    plain versions do not fit beside the kernels there, so ``tile_sample``
    takes whole tiles of each chunk, and the kernels' outputs at those
    tiles must equal the plain versions' on the sampled inputs."""
    import torch
    from fpga_ai_nic_tpu_torch import optim
    from fpga_ai_nic_tpu_torch.ops import ring_cuda
    hyper = optim.fused_hyperparams(sgd, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}

    def rs(x, w):
        return ring_cuda.ring_reduce_scatter_update_fused(
            x, w, {}, hyper, opt_kind="sgd", compression=cfg)

    def ag(owned):
        return ring_cuda.ring_all_gather_fused(owned, compression=cfg)

    def one_launch(fn, kernel):
        before = kernel.launches
        out = fn()
        if kernel.launches != before + 1:
            raise AssertionError(f"{kernel.name}: {kernel.launches - before}"
                                 " launches in one call, expected 1")
        return out

    for label, L in (("small", n * 2048 * 64), ("full", L_full)):
        C = L // n
        x = torch.randn((n, L), generator=gen, device=dev)
        x[:, ::97] = 0
        x[:, 5::131] *= 1e-39              # subnormals
        w = torch.randn((n, C), generator=gen, device=dev) * 0.02
        g_k, w_k, _ = one_launch(lambda: rs(x, w), ring_cuda.RING_RS)
        g_p, w_p, _ = ring_cuda.ring_reduce_scatter_update_plain(
            x, w, {}, hyper, opt_kind="sgd", compression=cfg)
        require_equal("ring_rs_update", [(g_k, g_p), (w_k, w_p)])
        del g_p, w_p
        g_2, w_2, _ = rs(x, w)
        require_equal("ring_rs_update repeat", [(g_k, g_2), (w_k, w_2)])
        del g_2, w_2
        rs_ms = cuda_ms(lambda: rs(x, w), 10)
        rs_plain = cuda_ms(lambda: ring_cuda.ring_reduce_scatter_update_plain(
            x, w, {}, hyper, opt_kind="sgd", compression=cfg), 2)
        ag_k = one_launch(lambda: ag(w_k), ring_cuda.RING_AG)
        ag_p = ring_cuda.ring_all_gather_plain(w_k, cfg)
        require_equal("ring_ag", [(ag_k, ag_p)])
        del ag_p
        if not bool((ag_k == ag_k[0]).all()):
            raise AssertionError("ring_ag: replicas differ")
        require_equal("ring_ag repeat", [(ag_k, ag(w_k))])
        ag_ms = cuda_ms(lambda: ag(w_k), 10)
        ag_plain = cuda_ms(lambda: ring_cuda.ring_all_gather_plain(w_k, cfg),
                           2)
        # per element of x: decode, add, encode; per owned element: encode,
        # decode
        rs_b, ag_b = ring_bytes(n, L, C, opt_shards=1)
        rs_bound = bound(rs_b, 11 * n * L + 5 * n * C)
        ag_bound = bound(ag_b, 10 * n * C)
        emit(phase="kernel_check", kernel="ring_rs_update(sgd)/ring_ag",
             payload=label, n=n, L=L, payload_bytes_per_rank=4 * L,
             bitexact=True, repeat_bitequal=True, replicas_equal=True,
             launches_per_call=1, rs_ms=rs_ms, rs_plain_ms=rs_plain,
             rs_bound_ms=rs_bound[0], rs_bytes=rs_b,
             rs_gb_per_s=rs_b / rs_ms / 1e6, ag_ms=ag_ms,
             ag_plain_ms=ag_plain, ag_bound_ms=ag_bound[0], ag_bytes=ag_b,
             ag_gb_per_s=ag_b / ag_ms / 1e6)
        if label == "full":
            rows["ring_rs_update"] = {"max_abs_err": 0.0, "ms": rs_ms,
                                      "plain_ms": rs_plain, "bound": rs_bound}
            rows["ring_ag"] = {"max_abs_err": 0.0, "ms": ag_ms,
                               "plain_ms": ag_plain, "bound": ag_bound}
        else:   # a call's host work outlasts the kernel here
            small = {"rs": rs_ms, "ag": ag_ms,
                     "rs_device": device_ms(lambda: rs(x, w), 10,
                                            ("ring_rs_kernel",)),
                     "ag_device": device_ms(lambda: ag(w_k), 10,
                                            ("ring_ag_kernel",))}
            emit(phase="kernel_check", kernel="ring_rs_update(sgd)/ring_ag",
                 payload=label, rs_device_ms=small["rs_device"],
                 ag_device_ms=small["ag_device"])
        del x, w, g_k, w_k, ag_k
        torch.cuda.empty_cache()

    n2, L = LLAMA_RING
    C = L // n2
    tile = cfg.block_size * ring_cuda.LANES
    hi = 2 ** 31 % C // tile      # holds flat offset 2^31 of x and replicas
    picks = sorted({0, hi - 1, hi, C // tile // 2, C // tile - 1})
    x = torch.randn((n2, L), generator=gen, device=dev)
    x[:, ::97] = 0
    x[:, 5::131] *= 1e-39
    g = one_launch(lambda: ring_cuda.ring_reduce_scatter_fused(
        x, compression=cfg), ring_cuda.RING_RS)
    g_p = ring_cuda.ring_reduce_scatter_update_plain(
        tile_sample(x, n2, tile, picks), None, {}, None, opt_kind=None,
        compression=cfg)[0]
    require_equal("ring_rs at the Llama shape, sampled tiles",
                  [(tile_sample(g, 1, tile, picks), g_p)])
    rs_ms = cuda_ms(lambda: ring_cuda.ring_reduce_scatter_fused(
        x, compression=cfg), 3)
    del x
    torch.cuda.empty_cache()
    rep = one_launch(lambda: ag(g), ring_cuda.RING_AG)
    require_equal("ring_ag at the Llama shape, sampled tiles",
                  [(tile_sample(rep, n2, tile, picks),
                    ring_cuda.ring_all_gather_plain(
                        tile_sample(g, 1, tile, picks), cfg))])
    if not bool(torch.isfinite(rep[0]).all()) or not bool(
            (rep == rep[0]).all()):
        raise AssertionError("ring_ag at the Llama shape: replicas differ "
                             "or are not finite")
    del rep
    ag_ms = cuda_ms(lambda: ag(g), 3)
    rs_b, ag_b = ring_bytes(n2, L, C)
    rs_bound = bound(rs_b, 11 * n2 * L)
    ag_bound = bound(ag_b, 10 * n2 * C)
    emit(phase="kernel_check", kernel="ring_rs(no optimizer)/ring_ag",
         payload="llama", n=n2, L=L, bitexact_at_tiles=picks,
         tile_elems=tile, rs_ms=rs_ms,
         rs_bound_ms=rs_bound[0], rs_gb_per_s=rs_b / rs_ms / 1e6,
         ag_ms=ag_ms, ag_bound_ms=ag_bound[0],
         ag_gb_per_s=ag_b / ag_ms / 1e6)
    for name, key, ms, bnd in (("ring_rs_update", "rs", rs_ms, rs_bound),
                               ("ring_ag", "ag", ag_ms, ag_bound)):
        rows[name]["extra"] = {
            "shape": f"n={n}, L={L_full}" + (", SGD" if key == "rs" else ""),
            "small_ms": small[key], "small_device_ms": small[key + "_device"],
            "llama_shape": f"n={n2}, L={L}",
            "llama_ms": ms, "llama_bound_ms": bnd[0]}
    del g
    torch.cuda.empty_cache()
    return rows


def codec_route(dev, tr, state, g, new, kernels) -> dict:
    """The BFP codec route on the main path's gradients ``g``: the same
    step with ``fused_kernel=False``, entered where ``DPTrainer`` enters the
    collective (``fused_update.reduce_scatter_update``, ``all_gather_flat``),
    so the unfused ``ops.ring`` rings carry the wire and the sublane codec's
    encode and decode are the ``bfp_codec.cu`` kernels.  Launch counts are
    zeroed just before and read just after; the masters and replicas must
    be bit-equal to the fused kernels' step ``new``."""
    import dataclasses
    import torch
    from fpga_ai_nic_tpu_torch.ops import fused_update
    coll = dataclasses.replace(tr.cfg.collective, fused_kernel=False)
    n, L = g.shape
    C = L // n
    codec = fused_update.resolve_codec(coll)
    slices = C // coll.slice_elems if codec.sliceable(
        C, coll.slice_elems) else 1

    def run():
        _, w, _ = fused_update.reduce_scatter_update(
            g, state.w_own, state.opt_state, state.step, coll,
            tr.cfg.optimizer)
        return w, fused_update.all_gather_flat(w, coll)

    for k in kernels.values():
        k.launches = 0
    w, reps = run()
    sync(dev)
    launches = {name: k.launches for name, k in kernels.items()}
    # reduce-scatter: n-1 hops of one encode and one decode a slice;
    # gather: one encode, then the own slot and n-1 hops, one decode each
    expect = dict.fromkeys(kernels, 0)
    expect.update(bfp_encode=(n - 1) * slices + 1,
                  bfp_decode=(n - 1) * slices + n)
    if launches != expect:
        raise AssertionError(f"codec route: launches {launches}, expected "
                             f"{expect}")
    require_equal("codec route masters", [(w, new.w_own)])
    require_equal("codec route replicas", [(reps, new.replicas)])
    del w, reps
    ms = cuda_ms(run, 3)
    emit(phase="codec_route", collective=str(coll), n=n, L=L, ms=ms,
         launches=launches, masters_bitequal=True, replicas_bitequal=True)
    torch.cuda.empty_cache()
    return launches


# -- ZeRO-3, the hierarchical ring, the ring kernel's ablate= stages ----------

class plain_collectives:
    """Within it, the fused ring wrappers and the BFP codec kernels are
    their plain versions (on the same card tensors), so a trainer's step
    takes the plain route: no port kernel launches inside."""

    def __enter__(self):
        from fpga_ai_nic_tpu_torch.ops import bfp_cuda, ring_cuda
        self.saved = [(m, k, getattr(m, k)) for m, k in (
            (ring_cuda, "ring_reduce_scatter_fused"),
            (ring_cuda, "ring_reduce_scatter_update_fused"),
            (ring_cuda, "ring_all_gather_fused"),
            (bfp_cuda, "bfp_encode"), (bfp_cuda, "bfp_decode"))]

        def rs(x, *, compression=None, slice_elems=None, integrity=False):
            res = ring_cuda.ring_reduce_scatter_update_plain(
                x, None, {}, None, opt_kind=None, compression=compression,
                slice_elems=slice_elems, integrity=integrity)
            return (res[0], res[3]) if integrity else res[0]

        def ag(owned, *, compression=None):
            return ring_cuda.ring_all_gather_plain(owned, compression)

        ring_cuda.ring_reduce_scatter_fused = rs
        ring_cuda.ring_reduce_scatter_update_fused = \
            ring_cuda.ring_reduce_scatter_update_plain
        ring_cuda.ring_all_gather_fused = ag
        bfp_cuda.bfp_encode = bfp_cuda.bfp_encode_plain
        bfp_cuda.bfp_decode = bfp_cuda.bfp_decode_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def timed_steps(tr, state, batch, kernels, steps, plain=False):
    """1 warm-up and ``steps`` timed steps (CUDA events around each), the
    launch counts zeroed just before and read just after; ``plain`` runs
    them inside ``plain_collectives``."""
    import contextlib
    import torch
    for k in kernels.values():
        k.launches = 0
    with plain_collectives() if plain else contextlib.nullcontext():
        state, loss = tr.step(state, batch)
        losses = [float(loss)]
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks[0].record()
        for mark in marks[1:]:
            state, loss = tr.step(state, batch)
            mark.record()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses.append(float(loss))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return state, {"steps": steps, "wall_s": wall,
                   "ms_per_step": 1e3 * wall / steps, "step_ms": step_ms,
                   "median_step_ms": sorted(step_ms)[steps // 2],
                   "loss_first": losses[0], "loss_last": losses[-1],
                   "launches": {k: v.launches for k, v in kernels.items()}}


def two_step_masters(tr, state, batch, kernels, plain):
    """The masters after two steps from ``state``, on the kernels or the
    plain route; the plain route launches no port kernel."""
    import contextlib
    for k in kernels.values():
        k.launches = 0
    with plain_collectives() if plain else contextlib.nullcontext():
        for _ in range(2):
            state, _ = tr.step(state, batch)
    if plain and any(k.launches for k in kernels.values()):
        raise AssertionError("the plain route launched a port kernel")
    return state.w_own


def fsdp_path(dev, kernels, mcfg, sgd, bx, by) -> dict:
    """ZeRO-3 (``parallel.fsdp.FSDPTrainer``) on the canonical MLP, fsdp=8
    virtual ranks, global batch 5376, the BFP ring kernels (the gather's
    forward ``ring_ag``, its backward the reduce-scatter without an
    optimizer), the fused SGD formula after the reduce: 1 warm-up and 5
    timed steps, one launch of each ring kernel a step, peak memory; two
    steps' masters bit-equal to the plain route's; the RS kernel at this
    shape (no optimizer) by device time beside its bound."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.ops import ring_cuda
    from fpga_ai_nic_tpu_torch.parallel import FSDPTrainer
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.utils.config import (
        BFPConfig, CollectiveConfig, MeshConfig, TrainConfig)
    n = 8
    bcfg = BFPConfig(codec="pallas")
    cfg = TrainConfig(global_batch=bx.shape[0], mesh=MeshConfig(fsdp=n),
                      collective=CollectiveConfig(
                          impl="ring", compression=bcfg, fused_kernel=True,
                          fused_optimizer=True), optimizer=sgd)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = FSDPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                     make_ranks(cfg.mesh, dev), cfg)
    state0 = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg,
                                    dev))
    batch = tr.shard_batch((bx, by))
    steps = 5
    _, run = timed_steps(tr, state0, batch, kernels, steps)
    expect = dict.fromkeys(kernels, 0)
    expect.update(ring_rs_update=steps + 1, ring_ag=steps + 1)
    if run["launches"] != expect:
        raise AssertionError(f"fsdp_path: launches {run['launches']}, "
                             f"expected {expect}")
    if not run["loss_last"] < run["loss_first"]:
        raise AssertionError(f"fsdp_path: the loss did not fall {run}")
    L = tr._meta.padded_len
    emit(phase="fsdp_path", model="MLP 10x2048x2048 f32", fsdp=n,
         global_batch=cfg.global_batch, padded_len=L,
         samples_per_sec=steps * cfg.global_batch / run["wall_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         state_shapes={"w_own": list(state0.w_own.shape)},
         wire=tr.obs_static_metrics(), **run)
    w_k = two_step_masters(tr, state0, batch, kernels, False)
    w_p = two_step_masters(tr, state0, batch, kernels, True)
    require_equal("fsdp masters after two steps", [(w_k, w_p)])
    emit(phase="fsdp_parity", steps=2, masters_bitequal=True)
    del w_k, w_p
    held = [state0]

    def step():
        held[0], _ = tr.step(held[0], batch)

    groups = profile_run("fsdp_profile", step, 2, groups={
        "ring": ("ring_rs_kernel", "ring_ag_kernel")})
    del held, state0, batch, tr
    torch.cuda.empty_cache()
    # the backward's reduce-scatter kernel at this shape
    C = L // n
    x = torch.randn((n, L), generator=torch.Generator(device=dev)
                    .manual_seed(9), device=dev)
    before = ring_cuda.RING_RS.launches

    def rs():
        return ring_cuda.ring_reduce_scatter_fused(x, compression=bcfg)

    rs_dev = device_ms(rs, 10, ("ring_rs_kernel",))
    rs_call = cuda_ms(rs, 5)
    rs_plain = cuda_ms(lambda: ring_cuda.ring_reduce_scatter_update_plain(
        x, None, {}, None, opt_kind=None, compression=bcfg), 2)
    require_equal("ring_rs at the fsdp shape", [(rs(), ring_cuda.
                  ring_reduce_scatter_update_plain(
                      x, None, {}, None, opt_kind=None,
                      compression=bcfg)[0])])
    rs_bound = bound(ring_bytes(n, L, C)[0], 11 * n * L)
    del x
    torch.cuda.empty_cache()
    row = {"device_ms": rs_dev, "call_ms": rs_call, "plain_ms": rs_plain,
           "bound": rs_bound, "shape": f"n={n}, L={L}, no optimizer",
           "timing_launches": ring_cuda.RING_RS.launches - before}
    emit(phase="fsdp_ring_times", rs=row)
    return {"launches": run["launches"], "median_step_ms":
            run["median_step_ms"], "rs": row, "profile": groups}


def hier_path(dev, kernels, mcfg, sgd, bx, by) -> dict:
    """``DPTrainer`` on the canonical MLP, dp=8, with ``topology="hier"``
    at intra_size 2 and 4: phase A the raw f32 ring inside each group,
    phase B the BFP (sublane) codec ring across groups on the
    ``bfp_codec.cu`` kernels, the fused SGD formula after the reduce.  For
    each: 1 warm-up and 3 timed steps, the codec launches checked against
    the phase program, the wire bytes by phase (the plan), and two steps'
    masters bit-equal to the plain route's.  Then the flat separate-op
    codec route (fused_kernel=False) timed the same way, beside."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (
        BFPConfig, CollectiveConfig, MeshConfig, TrainConfig)
    n, steps = 8, 3
    params = mlp.init(torch.Generator().manual_seed(0), mcfg, dev)
    out = {}
    for ni in (2, 4, None):
        hier = dict(topology="hier", intra_size=ni) if ni else {}
        coll = CollectiveConfig(impl="ring", compression=BFPConfig(
            codec="pallas"), fused_optimizer=True, **hier)
        cfg = TrainConfig(global_batch=bx.shape[0], mesh=MeshConfig(dp=n),
                          collective=coll, optimizer=sgd)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                       VirtualRanks(n, dev), cfg)
        state0 = tr.init_state(params)
        batch = tr.shard_batch((bx, by))
        _, run = timed_steps(tr, state0, batch, kernels, steps)
        C = state0.w_own.shape[1]
        codec = fused_update.resolve_codec(coll)
        S = C // coll.slice_elems if codec.sliceable(
            C, coll.slice_elems) else 1
        ng = n // (ni or 1)
        # a step: phase B's ng-1 hops of S slices (an encode and a decode
        # each), then the gather's one encode and ng decodes (the own
        # slot and ng-1 hops)
        expect = dict.fromkeys(kernels, 0)
        expect.update(bfp_encode=(steps + 1) * ((ng - 1) * S + 1),
                      bfp_decode=(steps + 1) * ((ng - 1) * S + ng))
        if run["launches"] != expect:
            raise AssertionError(f"hier_path (intra {ni}): launches "
                                 f"{run['launches']}, expected {expect}")
        label = f"hier_intra{ni}" if ni else "flat_codec_route"
        stat = tr.obs_static_metrics()
        emit(phase="hier_path" if ni else "hier_flat_codec_route",
             model="MLP 10x2048x2048 f32", dp=n, intra_size=ni,
             collective=str(coll), slices_a_hop=S,
             samples_per_sec=steps * cfg.global_batch / run["wall_s"],
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             wire=stat, **run)
        if ni:
            w_k = two_step_masters(tr, state0, batch, kernels, False)
            w_p = two_step_masters(tr, state0, batch, kernels, True)
            require_equal(f"hier (intra {ni}) masters after two steps",
                          [(w_k, w_p)])
            emit(phase="hier_parity", intra_size=ni, steps=2,
                 masters_bitequal=True)
            del w_k, w_p
        held = [state0]

        def step():
            held[0], _ = tr.step(held[0], batch)

        profile_run("hier_profile", step, 2, groups={
            "bfp_codec": ("bfp_encode_kernel", "bfp_decode_kernel")},
            intra_size=ni)
        del held
        out[label] = {"median_step_ms": run["median_step_ms"],
                      "launches": run["launches"],
                      "wire_bytes_per_allreduce":
                          stat["wire_bytes_per_allreduce"],
                      "hier_plan": stat.get("hier_plan")}
        del tr, state0, batch
    torch.cuda.empty_cache()
    return out


# The ablate=None instantiation of csrc/ring_rs.cu before the stage
# parameter existed, as ``codec_probe.py --ring`` reads it from that tree's
# build on this card and toolkit: the SASS of the B=16 kernels without and
# with the checksum pair, and sha256 digests of ``ring_rs_digests``.
RING_RS_SASS = {"chk0": {"instructions": 5510, "registers": 128,
                         "local_bytes": 0},
                "chk1": {"instructions": 5882, "registers": 128,
                         "local_bytes": 0}}
RING_RS_DIGESTS = {
    "4MiB": "5fdc459c64f7ed55eae377bba9e24919593747c7f50a268ba5ba90cb36aabf6d",
    "mlp": "1daeba8d1c161cf76091f9fb52e6e498d468e98352fd67c9c76512036fc90e7a"}
ABLATE_OPS = {"enc": 8, "dec": 3}   # a hop's operations an element of x


def ring_rs_sass(this_tree=True) -> dict:
    """SASS stats of the B=16 ring_rs kernels without and with the pair:
    this tree's ablate=None instantiations (``...ELi127EE``), or a tree's
    from before the stage parameter (``...ELb0EEv``)."""
    stats = {}
    for chk in (0, 1):
        pat = (f"ring_rs_kernelILi16ELb{chk}ELi127EE" if this_tree
               else f"ring_rs_kernelILi16ELb{chk}EEv")
        st = sass_stats("ring_rs.cu", (pat,))[pat]
        stats[f"chk{chk}"] = {k: st[k] for k in ("instructions", "registers",
                                                 "local_bytes")}
    return stats


def ring_rs_digests(dev) -> dict:
    """sha256 of ``ring_reduce_scatter_update_fused``'s outputs (SGD, BFP
    sublane) on seeded inputs, at 4 MiB a rank and at the MLP's shape
    (n=8), so two trees' kernels compare bit for bit."""
    import hashlib
    import torch
    from fpga_ai_nic_tpu_torch import optim
    from fpga_ai_nic_tpu_torch.ops import ring_cuda
    from fpga_ai_nic_tpu_torch.utils.config import BFPConfig, OptimizerConfig
    hyper = optim.fused_hyperparams(
        OptimizerConfig(kind="sgd", learning_rate=0.1), 0, device=dev)
    out = {}
    for label, L in (("4MiB", 1 << 20), ("mlp", 41_975_808)):
        g = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn((8, L), generator=g, device=dev)
        w = torch.randn((8, L // 8), generator=g, device=dev) * 0.02
        gs, ws, _ = ring_cuda.ring_reduce_scatter_update_fused(
            x, w, {}, hyper, opt_kind="sgd",
            compression=BFPConfig(codec="pallas"))
        h = hashlib.sha256(gs.cpu().numpy().tobytes())
        h.update(ws.cpu().numpy().tobytes())
        out[label] = h.hexdigest()
        del x, w, gs, ws
    torch.cuda.empty_cache()
    return out


def stage_work(stage, streaming, n, L, opt_kind):
    """(bytes, operations) an ablate= stage must do at [n, L]: its x loads
    (hop 0's, and the n-1 later ranks'), the write of g (or one word a
    thread without it), the optimizer's shards; encode and decode
    operations a hop and element (``ABLATE_OPS``), the update's."""
    from fpga_ai_nic_tpu_torch.ops import ring_cost, ring_cuda as rc
    C = L // n
    mask = 127 if stage is None else rc.ABLATE_MASKS[streaming][stage]
    ld, enc, stld = mask & rc.ST_LD, mask & rc.ST_ENC, mask & rc.ST_STLD
    dec, wb, upd = mask & rc.ST_DEC, mask & rc.ST_WB, mask & rc.ST_UPD
    loads = (1 if ld else 0) + ((n - 1) if stld or (ld and not dec) else 0)
    nbytes = 4 * n * C * loads + (4 * n * C if wb else n * C // 16)
    ops = (n - 1) * n * C * ((ABLATE_OPS["enc"] if enc else 0)
                             + (ABLATE_OPS["dec"] if dec else 0))
    if upd and opt_kind:
        nbytes += 4 * n * C * 2 * (1 + ring_cost.OPT_N_STATE[opt_kind])
        ops += n * C * ring_cost.OPT_FLOPS_PER_ELEM[opt_kind]
    return nbytes, ops


def ring_cost_stages(dev) -> dict:
    """B.a: ``ops.ring_cost.decompose`` driven by the ring reduce-scatter
    kernel's ablate= instantiations, timed by device time: at the MLP's
    shape (n=8, 41,975,808 f32, streaming stages, the SGD update) and at 4
    MiB a rank (resident stages, no optimizer).  Every stage of
    ``stages_for`` is measured (a stage error fails the phase).  Before
    them: the ablate=None instantiation's SASS and output digests against
    the tree from before the stage parameter (``RING_RS_SASS``,
    ``RING_RS_DIGESTS``), and its bits against the plain version at both
    shapes."""
    import torch
    from fpga_ai_nic_tpu_torch import optim
    from fpga_ai_nic_tpu_torch.ops import ring_cost, ring_cuda
    from fpga_ai_nic_tpu_torch.utils.config import (
        BFPConfig, OptimizerConfig, OptimizerSpec)
    sass = ring_rs_sass()
    digests = ring_rs_digests(dev)
    emit(phase="ring_rs_unchanged", sass=sass, pinned_sass=RING_RS_SASS,
         digests=digests, pinned_digests=RING_RS_DIGESTS)
    if sass != RING_RS_SASS or digests != RING_RS_DIGESTS:
        raise AssertionError("the ablate=None ring_rs kernel changed: "
                             f"{sass} / {digests}")
    cfg = BFPConfig(codec="pallas")
    n = 8
    ring_cuda.ABLATE_LAUNCHES.clear()
    rows, decs = {}, {}
    for label, L, streaming, opt in (("mlp", 41_975_808, True, "sgd"),
                                     ("4MiB", 1 << 20, False, None)):
        C = L // n
        x = torch.randn((n, L), generator=torch.Generator(device=dev)
                        .manual_seed(13), device=dev)
        se = ring_cuda.pick_slice_elems(C, 8192, cfg.block_size)
        if opt:
            def run(ab):
                return ring_cuda.loopback_update_microbench(
                    x, n, opt_kind=opt, compression=cfg, slice_elems=se,
                    streaming=streaming, ablate=ab)
            zeros = torch.zeros((n, C), device=dev)
            plain = ring_cuda.ring_reduce_scatter_update_plain(
                x, zeros, {k: zeros for k in OptimizerSpec(
                    kind=opt).state_keys},
                optim.fused_hyperparams(OptimizerConfig(
                    kind=opt, learning_rate=1e-3), 0, device=dev),
                opt_kind=opt, compression=cfg)[1]
            del zeros
        else:
            def run(ab):
                return ring_cuda.loopback_microbench(
                    x, n, compression=cfg, slice_elems=se,
                    streaming=streaming, ablate=ab)
            plain = ring_cuda.ring_reduce_scatter_update_plain(
                x, None, {}, None, opt_kind=None, compression=cfg)[0]
        require_equal(f"ring_rs ablate=None at {label}", [(run(None),
                                                           plain)])
        del plain
        plain_ms = cuda_ms(lambda: ring_cuda.ring_reduce_scatter_update_plain(
            x, None, {}, None, opt_kind=None, compression=cfg), 2)
        times = {}

        def measure(ab):
            times[ab] = device_ms(lambda: run(ab), 10, ("ring_rs_kernel",))
            return times[ab] * 1e-3

        dec = ring_cost.decompose(measure, streaming, 4 * n * L,
                                  fused_opt=opt is not None)
        want = set(ring_cost.stages_for(streaming, opt is not None))
        if dec.get("stage_errors") or set(dec["stages"]) != want:
            raise AssertionError(f"ring_cost_stages ({label}): "
                                 f"{dec.get('stage_errors')}, measured "
                                 f"{sorted(dec['stages'])} of {sorted(want)}")
        for st in (None,) + tuple(ring_cost.stages_for(streaming,
                                                       opt is not None)):
            nb, ops = stage_work(st, streaming, n, L, opt)
            rows[(label, st)] = {"ms": times[st], "bound": bound(nb, ops),
                                 "plain_ms": plain_ms, "streaming": streaming,
                                 "opt_kind": opt, "shape": f"n={n}, L={L}"}
        emit(phase="ring_cost_stages", shape=label, n=n, L=L,
             streaming=streaming, opt_kind=opt,
             stage_ms={str(k): v for k, v in times.items()},
             stage_bound_ms={str(st): rows[(label, st)]["bound"][0]
                             for st in times},
             decompose=dec)
        decs[label] = dec
        del x
        torch.cuda.empty_cache()
    launches = {f"{'stream' if k[0] else 'resident'}:{k[1]}": v
                for k, v in ring_cuda.ABLATE_LAUNCHES.items()}
    return {"rows": rows, "decompose": decs, "launches": launches,
            "sass": sass}


# -- integrity: the ring's checksum pair and the row checksum kernel ----------

POOL_SHAPE = (2049, 8, 16, 128)   # the serving pool's blocks: pages x kv x
POOL_ARRAYS = 64                  # page x head_dim, 32 layers of K and V


def ring_integrity_checks(dev, cfg, sgd, n, L_full) -> dict:
    """ring_rs with its checksum pair at the small payload (4 MiB a rank)
    and at the MLP width, with SGD and without an optimizer: the pair
    bit-equal to the plain version's, g and w bit-equal to the launch
    without the pair, a repeat launch bit-equal, the pair conserving; the
    kernel's device time and the call's event time with the pair beside
    without it, in turns (off, on, on, off)."""
    import torch
    from fpga_ai_nic_tpu_torch import optim
    from fpga_ai_nic_tpu_torch.ops import integrity, ring_cuda
    hyper = optim.fused_hyperparams(sgd, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    for label, L in (("small", n * 2048 * 64), ("full", L_full)):
        C = L // n
        se = ring_cuda.pick_slice_elems(C, ring_cuda.DEFAULT_SLICE,
                                        cfg.block_size)
        x = torch.randn((n, L), generator=gen, device=dev)
        x[:, ::97] = 0
        x[:, 5::131] *= 1e-39
        w = torch.randn((n, C), generator=gen, device=dev) * 0.02
        for kind in ("sgd", None):
            def run(integ, kind=kind):
                if kind is None:
                    out = ring_cuda.ring_reduce_scatter_fused(
                        x, compression=cfg, slice_elems=se, integrity=integ)
                    return ((out[0], None, out[1]) if integ
                            else (out, None))
                out = ring_cuda.ring_reduce_scatter_update_fused(
                    x, w, {}, hyper, opt_kind="sgd", compression=cfg,
                    slice_elems=se, integrity=integ)
                return (out[0], out[1], out[3]) if integ else out[:2]

            before = ring_cuda.RING_RS.launches
            off, on, again = run(False), run(True), run(True)
            if ring_cuda.RING_RS.launches != before + 3:
                raise AssertionError("ring_rs with the pair: not one launch "
                                     "a call")
            t0 = time.perf_counter()
            plain = ring_cuda.ring_reduce_scatter_update_plain(
                x, w if kind else None, {}, hyper if kind else None,
                opt_kind=kind, compression=cfg, slice_elems=se,
                integrity=True)
            sync(dev)
            plain_ms = 1e3 * (time.perf_counter() - t0)
            name = f"ring_rs({kind or 'no optimizer'}) pair"
            require_equal(name, [(on[2], plain[3]), (again[2], on[2]),
                                 (on[0], off[0]), (on[0], plain[0]),
                                 (again[0], on[0])])
            if kind:
                require_equal(name + " masters", [(on[1], off[1]),
                                                  (on[1], plain[1])])
            if not bool(integrity.conservation_ok(on[2][:, 0], on[2][:, 1])):
                raise AssertionError(f"{name}: the pair does not conserve")
            del plain, off, again
            dev_off = device_ms(lambda: run(False), 10, ("ring_rs_kernel",))
            dev_on = device_ms(lambda: run(True), 10, ("ring_rs_kernel",))
            dev_on2 = device_ms(lambda: run(True), 10, ("ring_rs_kernel",))
            dev_off2 = device_ms(lambda: run(False), 10, ("ring_rs_kernel",))
            call_off = cuda_ms(lambda: run(False), 10)
            call_on = cuda_ms(lambda: run(True), 10)
            r = {"frame_elems": se, "frames_a_chunk": C // se,
                 "device_ms_off": [dev_off, dev_off2],
                 "device_ms_on": [dev_on, dev_on2], "call_ms_off": call_off,
                 "call_ms_on": call_on, "plain_ms": plain_ms,
                 "on_over_off": (dev_on + dev_on2) / (dev_off + dev_off2)}
            emit(phase="kernel_check", kernel=name, payload=label, n=n, L=L,
                 pair_bitexact=True, bits_unchanged=True,
                 repeat_bitequal=True, conserves=True, **r)
            rows[(label, kind)] = r
            del on
        del x, w
        torch.cuda.empty_cache()
    return rows


def checksum_checks(dev, n, L_full) -> dict:
    """row_checksums against its plain version: u8, bf16 and f32 rows of
    odd lengths (the word-by-word path) and whole 16-byte runs, several
    arrays in one launch; the serving pool (64 x [2049, 8, 16, 128] bf16,
    4.30 GB) against page_checksums_plain with a flipped-bit control; the
    MLP replicas ([8, 41,975,808] f32) and their agreement; device time
    beside the bytes bound."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import integrity
    k = integrity.ROW_CHECKSUMS
    gen = torch.Generator(device=dev).manual_seed(3)
    for dtype in (torch.uint8, torch.bfloat16, torch.float32):
        size = torch.empty((), dtype=dtype).element_size()
        for rows, cols in ((1, 7), (3, 6151), (5, 4096), (2049, 24)):
            x = torch.randint(0, 256, (rows, cols * size), dtype=torch.uint8,
                              generator=gen, device=dev).view(dtype)
            blocks = [x, x[:, :max(1, cols // 3)].contiguous()]
            before = k.launches
            got = [integrity.row_checksums(x), integrity.row_checksums(blocks)]
            if k.launches != before + 2:
                raise AssertionError("row_checksums: not one launch a call")
            require_equal(f"row_checksums {dtype} {rows}x{cols}", [
                (got[0], integrity.row_checksums_plain([x], [1])),
                (got[1], integrity.row_checksums_plain(blocks))])
    pool = [{key: torch.randint(-2 ** 15, 2 ** 15, POOL_SHAPE,
                                dtype=torch.int16, generator=gen,
                                device=dev).view(torch.bfloat16)
             for key in ("k", "v")} for _ in range(POOL_ARRAYS // 2)]
    pool_bytes = sum(t.numel() * t.element_size()
                     for lyr in pool for t in lyr.values())
    before = k.launches
    got = integrity.page_checksums(pool)
    if k.launches != before + 1:
        raise AssertionError("page_checksums: not one launch a pass")
    want = integrity.page_checksums_plain(pool)
    require_equal("row_checksums at the serving pool", [(got, want)])
    require_equal("row_checksums repeat", [(integrity.page_checksums(pool),
                                            got)])
    page = POOL_SHAPE[0] * 3 // 5
    flip = pool[17]["v"].view(torch.int16)
    flip[page, 1, 3, 7] ^= 1
    moved = integrity.page_checksums(pool) != got
    flip[page, 1, 3, 7] ^= 1
    if not bool(moved[page]) or int(moved.sum()) != 1:
        raise AssertionError("row_checksums: the flipped-bit control did "
                             "not change its page alone")
    pool_dev = device_ms(lambda: integrity.page_checksums(pool), 10,
                         ("row_checksums_kernel",))
    pool_call = cuda_ms(lambda: integrity.page_checksums(pool), 10, 2)
    pool_plain = cuda_ms(lambda: integrity.page_checksums_plain(pool), 2)
    words = pool_bytes // 2
    pool_bound = bound(pool_bytes, 3 * words)
    del pool, got, want, moved, flip
    torch.cuda.empty_cache()
    reps = torch.randn((1, L_full), generator=gen, device=dev).expand(
        n, L_full).contiguous()
    got = integrity.row_checksums(reps)
    require_equal("row_checksums at the MLP replicas",
                  [(got, integrity.row_checksums_plain([reps], [1]))])
    if not bool(integrity.replica_consistent(reps)):
        raise AssertionError("replica_consistent: equal replicas disagree")
    reps[5, 777] = torch.nextafter(reps[5, 777], reps[5, 777] + 1)
    if bool(integrity.replica_consistent(reps)):
        raise AssertionError("replica_consistent missed a changed replica")
    rep_dev = device_ms(lambda: integrity.row_checksums(reps), 10,
                        ("row_checksums_kernel",))
    rep_call = cuda_ms(lambda: integrity.replica_consistent(reps), 10, 2)
    rep_plain = cuda_ms(lambda: integrity.row_checksums_plain([reps], [1]),
                        2)
    rep_bytes = reps.numel() * 4
    rep_bound = bound(rep_bytes, 3 * reps.numel())
    del reps, got
    torch.cuda.empty_cache()
    row = {"max_abs_err": 0.0, "ms": pool_dev, "plain_ms": pool_plain,
           "bound": pool_bound, "library_ms": None,
           "extra": {"shape": (f"serving pool, {POOL_ARRAYS} x "
                               f"{list(POOL_SHAPE)} bf16, {pool_bytes} B"),
                     "call_ms": pool_call,
                     "replicas_shape": f"[{n}, {L_full}] f32",
                     "replicas_ms": rep_dev, "replicas_call_ms": rep_call,
                     "replicas_plain_ms": rep_plain,
                     "replicas_bound_ms": rep_bound[0]}}
    emit(phase="kernel_check", kernel="row_checksums", bitexact=True,
         flipped_bit_control=True, pool_bytes=pool_bytes,
         pool_device_ms=pool_dev, pool_call_ms=pool_call,
         pool_plain_ms=pool_plain, pool_bound_ms=pool_bound[0],
         pool_gb_per_s=pool_bytes / pool_dev / 1e6, replicas_bytes=rep_bytes,
         replicas_device_ms=rep_dev, replicas_call_ms=rep_call,
         replicas_plain_ms=rep_plain, replicas_bound_ms=rep_bound[0],
         replicas_gb_per_s=rep_bytes / rep_dev / 1e6)
    return row


def integrity_path(dev, kernels, mcfg, cfg_main, bx, by) -> dict:
    """``DPTrainer`` on the main path's configuration with
    ``integrity_check=True``: 1 warm-up and 5 timed steps (counts zeroed
    just before, read just after; both verdicts true every step), then an
    integrity-off trainer from the same weights on the same batch, whose
    masters and replicas must be bit-equal.  Then the codec route
    (``fused_kernel=False``) with a ``wirebit`` fault on the wire
    (WireIntegrityError, the step gated, finite outputs) and a ``scale``
    fault at the collective tap (IntegrityError), each after a clean step;
    then the int8 path (dp=2) with integrity on clean steps against off."""
    import dataclasses
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.runtime import chaos
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig)
    steps = 5

    def trainer(cfg):
        n = cfg.mesh.dp
        tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                       VirtualRanks(n, dev), cfg)
        st = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg,
                                    dev))
        return tr, st, tr.shard_batch((bx, by))

    def timed(tr, st, batch):
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        outs = []
        st, out = tr.step(st, batch)                  # warm-up
        outs.append(out)
        marks[0].record()
        for mark in marks[1:]:
            st, out = tr.step(st, batch)
            outs.append(out)
            mark.record()
        sync(dev)
        return st, outs, [a.elapsed_time(b) for a, b in zip(marks,
                                                            marks[1:])]

    coll_on = dataclasses.replace(cfg_main.collective, integrity_check=True)
    tr, st, batch = trainer(dataclasses.replace(cfg_main,
                                                collective=coll_on))
    for k in kernels.values():
        k.launches = 0
    st, diags, on_ms = timed(tr, st, batch)
    launches = {name: k.launches for name, k in kernels.items()}
    per_step = dict.fromkeys(kernels, 0)
    per_step.update(ring_rs_update=1, ring_ag=1, row_checksums=1)
    for name, count in launches.items():
        if count != (steps + 1) * per_step[name]:
            raise AssertionError(f"integrity path: {name} launched {count} "
                                 f"times, expected {steps + 1} x "
                                 f"{per_step[name]}")
    for i, d in enumerate(diags):
        chaos.check_step_diag(d, i)
        if not (bool(d["wire_ok"]) and bool(d["integrity_ok"])):
            raise AssertionError(f"integrity path: step {i} verdicts {d}")
    off_tr, off_st, off_batch = trainer(cfg_main)
    off_st, losses, off_ms = timed(off_tr, off_st, off_batch)
    require_equal("integrity on against off, masters",
                  [(st.w_own, off_st.w_own)])
    require_equal("integrity on against off, replicas",
                  [(st.replicas, off_st.replicas)])
    if [float(d["loss"]) for d in diags] != [float(v) for v in losses]:
        raise AssertionError("integrity path: losses differ from off")
    med = sorted(on_ms)[steps // 2], sorted(off_ms)[steps // 2]
    emit(phase="integrity_path", model="MLP 10x2048x2048 f32",
         dp=cfg_main.mesh.dp, global_batch=cfg_main.global_batch,
         collective=str(coll_on), steps=steps, step_ms_on=on_ms,
         step_ms_off=off_ms, median_step_ms_on=med[0],
         median_step_ms_off=med[1], launches=launches,
         launches_per_step={k: v for k, v in per_step.items() if v},
         verdicts_true_every_step=True, masters_bitequal_to_off=True,
         replicas_bitequal_to_off=True,
         grad_norm_last=float(diags[-1]["grad_norm"]),
         integrity_err_max=max(float(d["integrity_err"]) for d in diags))
    del tr, st, batch, off_tr, off_st, off_batch, diags
    torch.cuda.empty_cache()

    # the codec route: a wirebit on the wire, a scale fault at the tap.  On
    # the main path's layout, as codec_route takes it: a trainer built with
    # fused_kernel=False pads to whole BFP blocks only, which the sublane
    # codec's rings refuse, so the trainer is built for the fused route and
    # then switched to the codec route
    coll_codec = dataclasses.replace(coll_on, fused_kernel=False)
    tr, st, batch = trainer(dataclasses.replace(cfg_main,
                                                collective=coll_on))
    tr.cfg = dataclasses.replace(tr.cfg, collective=coll_codec)
    faults = {}
    for mode, install, uninstall, err in (
            ("wirebit", chaos.install_wire_tap, chaos.uninstall_wire_tap,
             chaos.WireIntegrityError),
            ("scale", chaos.install_collective_tap,
             chaos.uninstall_collective_tap, chaos.IntegrityError)):
        plan = chaos.FaultPlan([chaos.FaultSpec(
            "corruption", "collective", step=1, mode=mode)], seed=3)
        install()
        try:
            with chaos.activate(plan):
                plan.begin_step(0)
                st, d = tr.step(st, batch)              # a clean step
                chaos.check_step_diag(d, 0)
                plan.begin_step(1)
                for k in kernels.values():
                    k.launches = 0
                new, d = tr.step(st, batch)
                sync(dev)
                step_launches = {name: k.launches
                                 for name, k in kernels.items()}
        finally:
            uninstall()
        if len(plan.fired) != 1:
            raise AssertionError(f"codec route: the {mode} fault fired "
                                 f"{len(plan.fired)} times")
        try:
            chaos.check_step_diag(d, 1)
            raised = None
        except chaos.IntegrityError as e:
            raised = type(e)
        if raised is not err:
            raise AssertionError(f"codec route {mode}: raised {raised}, "
                                 f"expected {err.__name__}")
        require_equal(f"codec route {mode}: gated masters and state",
                      [(new.w_own, st.w_own)]
                      + [(new.opt_state[k], st.opt_state[k])
                         for k in st.opt_state])
        if (new.codec_state is None) != (st.codec_state is None) or (
                st.codec_state is not None
                and not torch.equal(new.codec_state, st.codec_state)):
            raise AssertionError(f"codec route {mode}: codec state moved")
        if not bool(torch.isfinite(new.replicas).all()):
            raise AssertionError(f"codec route {mode}: non-finite output")
        faults[mode] = {"raised": err.__name__,
                        "wire_ok": bool(d["wire_ok"]),
                        "integrity_ok": bool(d["integrity_ok"]),
                        "integrity_err": float(d["integrity_err"]),
                        "launches": step_launches}
    emit(phase="integrity_faults", collective=str(coll_codec),
         masters_gated=True, outputs_finite=True, clean_steps_passed=True,
         **faults)
    del tr, st, new, batch
    torch.cuda.empty_cache()

    # the int8 path with integrity, clean steps, against off
    int8 = {}
    for integ in (True, False):
        cfg = dataclasses.replace(
            cfg_main, mesh=MeshConfig(dp=INT8_DP),
            collective=CollectiveConfig(impl="ring", codec="int8",
                                        codec_opts=INT8_OPTS,
                                        fused_optimizer=True,
                                        integrity_check=integ))
        tr, st, batch = trainer(cfg)
        for i in range(2):
            st, d = tr.step(st, batch)
            if integ:
                chaos.check_step_diag(d, i)
        int8[integ] = st
    require_equal("int8 path integrity on against off",
                  [(int8[True].w_own, int8[False].w_own),
                   (int8[True].replicas, int8[False].replicas)])
    emit(phase="integrity_int8", dp=INT8_DP, steps=2, verdicts_true=True,
         masters_bitequal_to_off=True)
    del int8, tr, st, batch
    torch.cuda.empty_cache()
    return launches


# -- int8 codec: kernels against plain, at the int8 training path's shape ----

INT8_PATH_ELEMS = 41_963_520   # canonical MLP at dp=2: both ranks, one call
INT8_CASES = (("stochastic", 0), ("stochastic", 7), ("nearest", 0),
              ("nearest", 7))
# the B=16 instantiations (mangled names): the encode's, stochastic and
# nearest, and the decode's
INT8_SASS_KERNELS = ("int8_encode_kernelILi16ELb0E",
                     "int8_encode_kernelILi16ELb1E",
                     "int8_decode_kernelILi16E")


def int8_inputs(dev, N, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, generator=g, device=dev) * 3
    x *= torch.pow(10.0, torch.randint(-3, 3, (N,), generator=g,
                                       device=dev).float())
    x[:16 * 128] = 0                  # a tile of all-zero blocks
    x[5::131] *= 1e-39                # subnormals
    x[7::97] = -0.0
    return x


def int8_extreme_inputs(dev, n_tiles, seed):
    """Sublane tiles (block 16) whose blocks reach every branch of the
    encode's division: scales from 0 and bf16's subnormals up to the
    largest a finite block gives, x from the block max down past the
    subnormals (quotients that underflow), ties k + 1/2, values clipped at
    +-127, all-zero, all-subnormal, NaN and +-inf blocks: the card's
    version of tests/test_torch_int8.py's ``_extreme_tiles``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    def pow2(e):
        return torch.pow(2.0, e.double())

    shape, col = (n_tiles, 16, 128), (n_tiles, 1, 128)
    E, sig = ints(-142, 121, col), 128 + ints(0, 128, col)
    M = (127.0 * sig * pow2(E - 7)).float()     # scale sig * 2^(E - 7)
    expo = (E + 127 + ints(-180, 7, shape)).clamp(0, 254)
    bits = (ints(0, 2, shape) << 31) | (expo << 23) | ints(0, 1 << 23, shape)
    x = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32).view(torch.float32)
    sign = torch.where(ints(0, 2, (n_tiles, 2, 128)) == 1, -1.0, 1.0)
    k = ints(0, 127, col)
    x[:, 0:1] = M * sign[:, 0:1]                              # fixes the scale
    x[:, 1:2] = ((2 * k + 1) * sig * pow2(E - 8)).float() * sign[:, 1:2]
    x[:, 2:3] = -x[:, 0:1]                                    # clips
    x.view(-1)[::37] = -0.0
    x[0, :, 0] = 0.0                                          # all zero
    x[0, 3, 1] = math.nan
    x[0, 4, 2] = math.inf
    x[0, 5, 3] = -math.inf
    x[0, 6, 4], x[0, 7, 4] = math.nan, math.inf
    x[0, :, 5] = ints(1, 1 << 23, (16,)).to(torch.int32).view(
        torch.float32)                                        # subnormal
    x[0, :, 6] = 2.0 ** -149 * ints(0, 3, (16,)).float()     # scale 0
    return x.reshape(-1)


SWEEP_TILES = 4370          # 4370 * 128 blocks * 15 values >= 2^23 a scale
SWEEP_SCALES = 8            # scale significands a slice: 71,598,080 f32


def int8_sweep_slice(dev, j0):
    """x for the bf16 scale significands j0 .. j0 + SWEEP_SCALES - 1: for
    each, SWEEP_TILES tiles whose blocks hold 127 * s_j in row 0 (which
    makes s_j = (1 + j/128) 2^(j % 9 - 4) the block's scale) and, in rows
    1-15, every f32 significand m once (the first 1792 twice), at the
    exponent (m % 8) - 2 of s_j's binade and with m's bit 3 as sign, so
    each significand pair meets once and the quotients span 2^-3 .. 2^6.
    Returns x and the scales s_j as f32."""
    import torch
    j = torch.arange(j0, j0 + SWEEP_SCALES, device=dev).view(-1, 1, 1, 1)
    E = j % 9 - 4
    s_j = ((128 + j).double() * torch.pow(2.0, (E - 7).double())).float()
    blk = (torch.arange(SWEEP_TILES, device=dev).view(1, -1, 1, 1) * 128
           + torch.arange(128, device=dev).view(1, 1, 1, 128))
    m = (blk * 15 + torch.arange(15, device=dev).view(1, 1, 15, 1)) % (
        1 << 23)
    bits = ((m >> 3 & 1) << 31) | ((127 + E + (m & 7) - 2) << 23) | m
    rows = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32).view(torch.float32)
    top = (127 * s_j).expand(-1, SWEEP_TILES, 1, 128)
    return torch.cat([top, rows], dim=2).reshape(-1), s_j.view(-1)


def int8_encode_diffs(x, q, s, rounding, seed) -> int:
    """Elements of q and of the scales where the kernel's output differs
    from int8_encode_plain's on x."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import int8_cuda
    pq, ps = int8_cuda.int8_encode_plain(x, 16, rounding, seed)
    return int((q != pq).sum()) + int(
        (s.view(torch.int16) != ps.view(torch.int16)).sum())


def int8_exhaustive(dev) -> dict:
    """The encode's division over every pair of an f32 significand and a
    bf16 scale significand (``int8_sweep_slice``, 2^30 pairs, 1.15e9
    elements in 16 slices), then ``int8_extreme_inputs`` (exponent
    extremes), each for every INT8_CASES entry, q and scales bit for bit
    against int8_encode_plain; the sweep's scales must be the s_j it
    builds.  Control: one bit flipped in the kernel's q must count as one
    difference.  Raises on any difference; returns the phase's numbers."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import int8_cuda
    t0 = time.perf_counter()
    elems = flipped = 0
    for j0 in range(0, 128, SWEEP_SCALES):
        x, s_j = int8_sweep_slice(dev, j0)
        elems += x.numel()
        for rounding, seed in INT8_CASES:
            q, s = int8_cuda.int8_encode(x, 16, rounding, seed)
            got = s.float().view(SWEEP_SCALES, -1)
            if not bool((got == s_j.view(-1, 1)).all()):
                raise AssertionError(f"int8 sweep: scales at j0={j0} are "
                                     f"not the constructed s_j")
            diff = int8_encode_diffs(x, q, s, rounding, seed)
            if diff:
                raise AssertionError(f"int8_encode sweep j0={j0} {rounding} "
                                     f"seed {seed}: {diff} elements differ")
            if not flipped:
                q[x.numel() // 3] ^= 1
                flipped = int8_encode_diffs(x, q, s, rounding, seed)
                if flipped != 1:
                    raise AssertionError(f"int8 sweep control: a flipped bit "
                                         f"counted {flipped} differences")
            del q, s
        del x
    sweep_s = time.perf_counter() - t0
    x = int8_extreme_inputs(dev, 4096, 11)
    for rounding, seed in INT8_CASES:
        q, s = int8_cuda.int8_encode(x, 16, rounding, seed)
        diff = int8_encode_diffs(x, q, s, rounding, seed)
        if diff:
            raise AssertionError(f"int8_encode extremes {rounding} seed "
                                 f"{seed}: {diff} elements differ")
    del x, q, s
    torch.cuda.empty_cache()
    out = {"sweep_pairs": 128 << 23, "sweep_elems": elems,
           "extreme_elems": 4096 * 2048, "cases": [list(c) for c in
                                                   INT8_CASES],
           "bitexact": True, "control_flipped_bit_differences": flipped,
           "sweep_s": sweep_s, "seconds": time.perf_counter() - t0}
    emit(phase="int8_exhaustive", **out)
    return out


def int8_checks(dev) -> dict:
    """int8_encode / int8_decode against their plain versions, bit for bit,
    at a small shape and the path's, both roundings and two seeds; the
    control: seed 1 against seed 0 must differ.  Times at the path's
    shape: ``ms`` the kernel's device time, ``call_ms`` whole calls; the
    encode's SASS counts.  Then ``int8_exhaustive``.  Returns the two rows
    of the kernels line."""
    from fpga_ai_nic_tpu_torch.ops import int8_cuda
    import torch
    rows = {}
    for label, N in (("small", 5 * 16 * 128), ("path", INT8_PATH_ELEMS)):
        x = int8_inputs(dev, N, N % 1000)
        for rounding, seed in INT8_CASES:
            q, s = int8_cuda.int8_encode(x, 16, rounding, seed)
            pq, ps = int8_cuda.int8_encode_plain(x, 16, rounding, seed)
            require_equal(f"int8_encode {rounding} seed {seed}",
                          [(q, pq), (s.view(torch.int16),
                                     ps.view(torch.int16))])
            d = int8_cuda.int8_decode(q, s)
            require_equal(f"int8_decode {rounding} seed {seed}",
                          [(d, int8_cuda.int8_decode_plain(pq, ps))])
            del pq, ps, d
        q0, s0 = int8_cuda.int8_encode(x, 16, "stochastic", 0)
        q1, _ = int8_cuda.int8_encode(x, 16, "stochastic", 1)
        control_diff = int((q0 != q1).sum())
        if control_diff == 0:
            raise AssertionError("int8 control: seeds 0 and 1 gave equal "
                                 "bits, so the comparison cannot fail")
        # encode reads 4 B and writes 1 + 2/16 B per element, decode the
        # reverse; about 20 operations per element to encode (max, divide,
        # the hash's 12 integer steps, add, floor, clip, convert), 2 to
        # decode
        enc_bound = bound(N * (4 + 1 + 2 / 16), 20 * N)
        dec_bound = bound(N * (1 + 2 / 16 + 4), 2 * N)
        enc_ms = cuda_ms(lambda: int8_cuda.int8_encode(x), 20, 3)
        dec_ms = cuda_ms(lambda: int8_cuda.int8_decode(q0, s0), 20, 3)
        enc_plain = cuda_ms(lambda: int8_cuda.int8_encode_plain(x), 3)
        dec_plain = cuda_ms(lambda: int8_cuda.int8_decode_plain(q0, s0), 3)
        dev_ms = {}
        if label == "path":
            dev_ms = {
                "encode_device_ms": device_ms(
                    lambda: int8_cuda.int8_encode(x), 20,
                    ("int8_encode_kernel",)),
                "encode_nearest_device_ms": device_ms(
                    lambda: int8_cuda.int8_encode(x, 16, "nearest"), 20,
                    ("int8_encode_kernel",)),
                "decode_device_ms": device_ms(
                    lambda: int8_cuda.int8_decode(q0, s0), 20,
                    ("int8_decode_kernel",))}
        emit(phase="kernel_check", kernel="int8_encode/int8_decode",
             shape=label, elems=N, cases=[list(c) for c in INT8_CASES],
             bitexact=True, control_seed1_vs_seed0_differing=control_diff,
             encode_ms=enc_ms, decode_ms=dec_ms, encode_plain_ms=enc_plain,
             decode_plain_ms=dec_plain, encode_bound_ms=enc_bound[0],
             decode_bound_ms=dec_bound[0], **dev_ms)
        if label == "path":
            sass = sass_stats(int8_cuda.ENCODE.source, INT8_SASS_KERNELS,
                              CONVERT_OPS)
            emit(phase="int8_sass", sass=sass)
            rows = {"int8_encode": {
                        "max_abs_err": 0.0, "ms": dev_ms["encode_device_ms"],
                        "plain_ms": enc_plain, "bound": enc_bound,
                        "extra": {"call_ms": enc_ms,
                                  "nearest_ms": dev_ms[
                                      "encode_nearest_device_ms"],
                                  "sass": {k: sass[k] for k in
                                           INT8_SASS_KERNELS[:2]}}},
                    "int8_decode": {
                        "max_abs_err": 0.0, "ms": dev_ms["decode_device_ms"],
                        "plain_ms": dec_plain, "bound": dec_bound,
                        "extra": {"call_ms": dec_ms}}}
        del x, q0, s0, q1
        torch.cuda.empty_cache()
    rows["int8_encode"]["extra"]["exhaustive"] = int8_exhaustive(dev)
    return rows


INT8_DP = 2
INT8_OPTS = (("backend", "pallas"),)


def int8_train_path(dev, kernels, sgd, batch_x, batch_y) -> dict:
    """``DPTrainer`` on the canonical MLP at dp=2 with the int8 codec's
    sublane kernels on the ring: one warm-up and five timed steps (CUDA
    events), launch counts zeroed just before and read just after; then
    ``int8_plain_step``: the same gradients through ``Int8Codec(plain=True)``
    must give bit-equal masters and replicas; then a profile of two steps."""
    import torch
    from fpga_ai_nic_tpu_torch import compress
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (
        CollectiveConfig, MeshConfig, MLPConfig, TrainConfig)
    n, steps = INT8_DP, 5
    mcfg = MLPConfig()

    def trainer(opts):
        cfg = TrainConfig(global_batch=batch_x.shape[0],
                          mesh=MeshConfig(dp=n), optimizer=sgd,
                          collective=CollectiveConfig(
                              impl="ring", codec="int8", codec_opts=opts,
                              fused_optimizer=True))
        return DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                         VirtualRanks(n, dev), cfg)

    tr = trainer(INT8_OPTS)
    state = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg,
                                   dev))
    L = state.w_own.numel()
    if L != INT8_PATH_ELEMS or (L // n) % (16 * 128):
        raise AssertionError(f"int8 path: padded length {L}")
    batch = tr.shard_batch((batch_x, batch_y))
    for k in kernels.values():
        k.launches = 0
    state, loss = tr.step(state, batch)           # warm-up
    losses = [loss]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    sync(dev)
    t0 = time.perf_counter()
    marks[0].record()
    for mark in marks[1:]:
        state, loss = tr.step(state, batch)
        losses.append(loss)
        mark.record()
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [float(v) for v in losses]
    # one reduce-scatter hop (1 encode, 1 decode) and the gather's single
    # encode with n decodes
    per_step = {name: 0 for name in kernels}
    per_step.update(int8_encode=2, int8_decode=n + 1)
    for name, count in launches.items():
        if count != (steps + 1) * per_step[name]:
            raise AssertionError(f"int8 path: {name} launched {count} times, "
                                 f"expected {steps + 1} x {per_step[name]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"int8 path: non-finite loss {losses}")
    replicas_equal = bool((state.replicas == state.replicas[0]).all())
    if not replicas_equal:
        raise AssertionError("int8 path: replicas differ")
    emit(phase="int8_train_path", model="MLP 10x2048x2048 f32", dp=n,
         global_batch=batch_x.shape[0], collective=str(tr.cfg.collective),
         codec=compress.resolve(tr.cfg.collective).describe(), steps=steps,
         wall_s=wall,
         ms_per_step=1e3 * wall / steps, step_ms=step_ms,
         step_ms_mean=sum(step_ms) / steps,
         samples_per_sec=steps * batch_x.shape[0] / wall, losses=losses,
         padded_len=L, launches=launches,
         launches_per_step={k: v for k, v in per_step.items() if v},
         replicas_equal=replicas_equal)

    # int8_plain_step: the same gradients through both sublane routes
    g, _ = tr.grads(state, batch)
    g, codec_state = tr.error_feedback(state, g)
    new = tr.apply_grads(state, g, codec_state)
    plain = trainer(INT8_OPTS + (("plain", True),))
    plain.init_state(state.params)
    before = {name: k.launches for name, k in kernels.items()}
    new_p = plain.apply_grads(state, g, codec_state)
    sync(dev)
    if {name: k.launches for name, k in kernels.items()} != before:
        raise AssertionError("int8 plain step launched a kernel")
    require_equal("int8 path masters", [(new.w_own, new_p.w_own)])
    require_equal("int8 path replicas", [(new.replicas, new_p.replicas)])
    emit(phase="int8_plain_step", masters_bitequal=True,
         replicas_bitequal=True,
         masters_moved=bool((new.w_own != state.w_own).any()))
    del g, new, new_p, plain
    held = [state]
    del state

    def train_step():
        held[0], _ = tr.step(held[0], batch)

    profile_run("int8_profile", train_step, 2,
                groups={"int8": INT8_KERNELS})
    del tr, held, batch
    torch.cuda.empty_cache()
    return launches


def codec_convergence(dev) -> None:
    """The convergence eval on the card: baseline, top-k (error feedback)
    and int8 (flat layout) on the eval MLP at dp=8.  It reports; it holds
    only finiteness."""
    from fpga_ai_nic_tpu_torch.evals import codec_convergence as cc
    steps = 40
    t0 = time.perf_counter()
    out = cc.run_codec_comparison("mlp", steps, device=dev)
    wall = time.perf_counter() - t0
    arms = {arm: {k: out[arm][k] for k in ("losses", "final_loss")
                  + (("final_loss_ratio",) if arm != "baseline" else ())}
            for arm in ("baseline", "topk", "int8")}
    emit(phase="codec_convergence", model="mlp", dp=8, steps=steps,
         tail_k=out["tail_k"], wall_s=wall, arms=arms,
         codecs={arm: out[arm]["codec"] for arm in ("topk", "int8")})
    if not all(math.isfinite(v) for a in arms.values() for v in a["losses"]):
        raise AssertionError("codec convergence: non-finite loss")


# -- paged attend: kernel against plain, at the serving path's shapes --------

PAGED_TOL = 5e-5          # f32 sums over <= 2048 keys in another order
PAGED_SHAPES = (          # name, R, H, n_kv, T, hd, page_size, P
    ("decode GQA ps16", 16, 32, 8, 1, 128, 16, 128),
    ("decode MHA ps16", 16, 32, 32, 1, 128, 16, 128),
    ("decode GQA ps128", 16, 32, 8, 1, 128, 128, 16),
    ("prefill GQA ps16", 1, 32, 8, 256, 128, 16, 128),
    ("prefill MHA ps128", 1, 32, 32, 256, 128, 128, 16),
)
LIBRARY_ROUTE = ("two calls: the gathered [R, kv, P*page_size, hd] view in "
                 "f32, then F.scaled_dot_product_attention with the mask")


def paged_inputs(dev, R, H, n_kv, T, hd, ps, P, seed, q_dtype):
    """q in ``q_dtype``; a dirty bf16 pool whose live pages are O(1) and whose other
    pages hold 1e3-sized garbage; a shuffled table; ragged positions."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = R * P + 1
    pk = torch.randn((n_pages, n_kv, ps, hd), generator=g, device=dev) * 1e3
    pv = torch.randn((n_pages, n_kv, ps, hd), generator=g, device=dev) * 1e3
    table = (torch.randperm(n_pages - 1, generator=g, device=dev)[:R * P]
             + 1).to(torch.int32).reshape(R, P)
    pos = torch.randint(0, P * ps - T + 1, (R,), generator=g, device=dev,
                        dtype=torch.int32)
    live = torch.zeros(n_pages, dtype=torch.bool, device=dev)
    for r, p in enumerate(pos.tolist()):
        live[table[r, :min((p + T - 1) // ps + 1, P)].long()] = True
    pk[live] *= 1e-3
    pv[live] *= 1e-3
    q = torch.randn((R, H, T, hd), generator=g, device=dev).to(q_dtype)
    return q, pk.to(torch.bfloat16), pv.to(torch.bfloat16), table, pos


def paged_bound(pos, R, H, n_kv, T, hd, ps, P, ops_per_s=F32_OPS_PER_S,
                q_itemsize=4):
    """The bytes the function needs over the HBM rate — K and V (bf16) of
    the keys some row sees, min(pos + T, P*ps) per slot and KV head; q (in
    its dtype) and out (f32); the live table entries and pos — against 4*hd operations
    per visible (row, key) pair (its two products) over ``ops_per_s``: the
    f32 rate for decode, which the CUDA cores compute; the bf16 tensor
    cores' for prefill, whose products run there (as rows 9-11 state
    theirs)."""
    keys = sum(min(p + T, P * ps) for p in pos)
    live = sum(min((p + T - 1) // ps + 1, P) for p in pos)
    moved = (keys * n_kv * hd * 2 * 2 + R * H * T * hd * (q_itemsize + 4)
             + live * 4 + R * 4)
    visible = sum(min(p + t + 1, P * ps) for p in pos for t in range(T))
    return bound(moved, 4 * hd * H * visible, ops_per_s)


def library_attend(q, pk, pv, table, pos, ps):
    """The nearest library route: the gathered view, then PyTorch's fused
    attention (a yardstick only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    R, H, T, hd = q.shape
    n_kv, P = pk.shape[1], table.shape[1]
    idx = table.long()
    ck = pk[idx].transpose(1, 2).reshape(R, n_kv, P * ps, hd).float()
    cv = pv[idx].transpose(1, 2).reshape(R, n_kv, P * ps, hd).float()
    j = torch.arange(P * ps, device=q.device)
    t = torch.arange(T, device=q.device)
    mask = j[None, None, None, :] <= (pos[:, None, None, None]
                                      + t[None, None, :, None])
    return F.scaled_dot_product_attention(q.float(), ck, cv, attn_mask=mask,
                                          scale=hd ** -0.5,
                                          enable_gqa=H != n_kv)


def paged_checks(dev) -> dict:
    """Kernel against plain at every PAGED_SHAPES entry with q in bf16, the
    serving path's dtype (one bf16 term of q at prefill), and at the two
    GQA page-16 shapes also with q in f32 (the contract's, two terms); a
    second launch bit-equal to the first (both regimes); the prefill
    kernel's HGMMA count, registers and local bytes.  ``ms`` is the
    kernel's device time (``device_ms``), ``call_ms`` a whole call's
    (CUDA events, host work included).  Returns the rows by shape name,
    with " q f32" after the name for the f32 rows."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import paged_attend
    sass = sass_stats(paged_attend.PAGED_ATTEND.source, PAGED_KERNELS)
    if not (sass["paged_prefill_kernel"]["hgmma"] > 0
            and sass["paged_prefill_kernel"]["local_bytes"] == 0):
        raise AssertionError(f"paged prefill kernel SASS: {sass}")
    runs = [(name, torch.bfloat16, shape) for name, *shape in PAGED_SHAPES]
    runs += [(name + " q f32", torch.float32, shape)
             for name, *shape in PAGED_SHAPES if name.endswith("GQA ps16")]
    out = {}
    for i, (name, q_dtype, (R, H, n_kv, T, hd, ps, P)) in enumerate(runs):
        q, pk, pv, table, pos = paged_inputs(dev, R, H, n_kv, T, hd, ps, P,
                                             100 + i, q_dtype)

        def kern():
            return paged_attend.paged_gather_attend(q, pk, pv, table, pos,
                                                    page_size=ps)

        def plain():
            return paged_attend.paged_gather_attend_plain(
                q, pk, pv, table, pos, page_size=ps)

        got, again, want = kern(), kern(), plain()
        sync(dev)
        err = max_err([(got, want)])
        deterministic = torch.equal(got, again)
        if not (bool(got.isfinite().all()) and err <= PAGED_TOL
                and deterministic):
            raise AssertionError(f"paged_attend {name}: max abs err {err} "
                                 f"> {PAGED_TOL} or a second launch "
                                 f"differs ({deterministic})")
        lib_err = max_err([(library_attend(q, pk, pv, table, pos, ps),
                            want)])
        shape = (pos.tolist(), R, H, n_kv, T, hd, ps, P)
        qb = q.element_size()
        b = paged_bound(*shape, BF16_OPS_PER_S if T > 1 else F32_OPS_PER_S,
                        q_itemsize=qb)
        row = {"max_abs_err": err, "ms": device_ms(kern, 20, PAGED_KERNELS),
               "call_ms": cuda_ms(kern, 20, 3),
               "plain_ms": cuda_ms(plain, 10),
               "library_ms": cuda_ms(
                   lambda: library_attend(q, pk, pv, table, pos, ps), 5),
               "bound": b,
               "bound_f32_ms": paged_bound(*shape, q_itemsize=qb)[0]}
        out[name] = row
        emit(phase="kernel_check", kernel="paged_attend", shape=name, R=R,
             H=H, n_kv=n_kv, T=T, hd=hd, page_size=ps, P=P,
             q_dtype=str(q_dtype).removeprefix("torch."), tol=PAGED_TOL,
             regime="prefill (wgmma)" if paged_attend.decode_split(
                 T, H // n_kv, ps, P) == 0 else "decode (split keys)",
             max_abs_err=err, deterministic=deterministic, ms=row["ms"],
             call_ms=row["call_ms"], plain_ms=row["plain_ms"],
             bound_ms=b[0], bound_by=b[1], bound_f32_ms=row["bound_f32_ms"],
             library=LIBRARY_ROUTE,
             library_ms=row["library_ms"], library_max_abs_err=lib_err,
             sass=sass)
        del q, pk, pv, table, pos, got, again, want
    return out


# -- flash attention: kernels against plain, at the training path's shape -----

FLASH_SHAPES = (          # name, B, H, n_kv, S, causal
    ("path GQA causal S4096", 1, 32, 8, 4096, True),
    ("MHA non-causal S1024", 1, 32, 32, 1024, False),
)
FLASH_LSE_SHIFT = 0.05    # fault control: the plain backward at lse + 0.05
FLASH_LIBRARY = ("F.scaled_dot_product_attention(q, k, v, is_causal, "
                 "enable_gqa) in bf16; its autograd backward for dq and "
                 "dk/dv together")


def flash_bound(kind, B, H, n_kv, S, causal, split=False, hd=128,
                itemsize=2, ops_per_s=BF16_OPS_PER_S, key_bias=False,
                pairs=None):
    """Each input read once, each output written once (bf16 tensors, f32
    lse/delta, the f32 [B, S] key bias where ``key_bias``) over the HBM
    rate, against the multiply-adds the visible (row, key) pairs need over
    the bf16 tensor-core rate: 2, 3 and 4 products of depth hd per pair for
    the forward, dq and dk/dv.  ``pairs``: the pairs this run's data needs
    (those with a valid key under a padding mask) in place of the causal
    or full count.  ``split``: the tensor-core passes the kernels run
    instead, with p and ds as two bf16 terms (3, 4 and 6), a floor of their
    design.  The second family's f32 operands: ``itemsize`` 4 at the f32
    rate."""
    big = B * H * S * hd * itemsize
    small, rows = B * n_kv * S * hd * itemsize, B * H * S * 4
    if pairs is None:
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    moved, products, passes = {
        "flash_fwd": (2 * big + 2 * small + rows, 2, 3),
        "flash_dq": (3 * big + 2 * small + 2 * rows, 3, 4),
        "flash_dkv": (2 * big + 4 * small + 2 * rows, 4, 6),
    }[kind]
    moved += B * S * 4 if key_bias else 0
    return bound(moved, 2 * (passes if split else products) * hd * pairs,
                 ops_per_s)


SASS_LINE = r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)"
# the int8 encode's conversion, MUFU and division-check instructions (the
# conversion and MUFU units take 16 a clock on an SM, FP32 128)
CONVERT_OPS = ("MUFU", "I2F", "I2FP", "F2I", "F2IP", "FRND", "F2F", "FCHK",
               "CALL")


def sass_stats(source: str, kernels, ops=("HGMMA",), lib=None) -> dict:
    """For each kernel of ``source``'s built library (or of the library at
    ``lib``) (a substring of its mangled name: ``ILi16E`` picks the B=16
    instantiation of a template): how many of its SASS instructions
    (``cuobjdump -sass``) have each opcode of ``ops`` (lower-case keys)
    and how many it has in all, and its registers and local (spill) bytes
    a thread (``cuobjdump -res-usage``)."""
    import re
    from fpga_ai_nic_tpu_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    lib = str(lib or _build.build((source,))[source])
    stats = {k: dict({op.lower(): 0 for op in ops}, instructions=0,
                     registers=None, local_bytes=None) for k in kernels}
    for flag in ("-sass", "-res-usage"):
        out = subprocess.run([cuobjdump, flag, lib], check=True,
                             capture_output=True, text=True,
                             timeout=120).stdout
        cur = None
        for line in out.splitlines():
            if "Function" in line:
                cur = next((k for k in kernels if k in line), None)
            if cur is None:
                continue
            if flag == "-sass":
                m = re.match(SASS_LINE, line)
                if m and m.group(1) != "NOP":
                    stats[cur]["instructions"] += 1
                    if m.group(1) in ops:
                        stats[cur][m.group(1).lower()] += 1
                continue
            for key, field in (("registers", "REG"), ("local_bytes", "LOCAL")):
                m = re.search(rf"\b{field}:(\d+)", line)
                if m:
                    stats[cur][key] = int(m.group(1))
    return stats


def flash_sass(bias: bool, hd: int = 128, offsets: bool = False) -> dict:
    """SASS stats of the tensor-core flash kernels' instantiation with
    (``ILb1``) or without (``ILb0``) the key-bias channel at head dim
    ``hd``, each by its head-dim argument (``ELi128E``, ``ELi64E``), and
    with (``ELb1E``) or without (``ELb0E``) the q/k offsets."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    flag = "ILb1" if bias else "ILb0"
    dims = f"ELi{hd}ELb{int(offsets)}E"
    return dict(sass_stats(fa.FLASH_FWD.source,
                           ("flash_fwd_kernel" + flag + dims,)),
                **sass_stats(fa.FLASH_DQ.source,
                             ("flash_dq_kernel" + flag + dims,
                              "flash_dkv_kernel" + flag + dims)))


def sass_checks(sass) -> dict:
    """Every kernel of ``sass`` (``sass_stats``) runs wgmma (HGMMA) and
    spills nothing (no local bytes)."""
    return {"tensor_core_sass": all(st["hgmma"] > 0 for st in sass.values()),
            "no_local_bytes": all(st["local_bytes"] == 0
                                  for st in sass.values())}


def flash_checks(dev) -> dict:
    """Each flash kernel against its plain version at every FLASH_SHAPES
    entry, with the two fault controls that must exceed the limit; times
    of kernel, plain version and the library's attention.  Returns the
    rows by kernel, at the path's shape, with the largest errors over all
    shapes."""
    import torch
    import torch.nn.functional as F
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    sass = flash_sass(bias=False)
    rows = {}
    for si, (name, B, H, n_kv, S, causal) in enumerate(FLASH_SHAPES):
        g = torch.Generator(device=dev).manual_seed(300 + si)

        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)

        q, k, v = rand(B, H, S, 128), rand(B, n_kv, S, 128), rand(
            B, n_kv, S, 128)
        do = rand(B, H, S, 128)
        kw = dict(causal=causal, sm_scale=128 ** -0.5)
        out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        got = {"out": out, "dq": fa.flash_dq_cuda(*args, **kw)}
        got["dk"], got["dv"] = fa.flash_dkv_cuda(*args, **kw)
        again = dict(zip(("out", "lse"), fa.flash_fwd_cuda(q, k, v, **kw)))
        again["dq"] = fa.flash_dq_cuda(*args, **kw)
        again["dk"], again["dv"] = fa.flash_dkv_cuda(*args, **kw)
        p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
        want = {"out": p_out, "dq": fa.flash_dq_plain(*args, **kw)}
        want["dk"], want["dv"] = fa.flash_dkv_plain(*args, **kw)
        sync(dev)
        ratio = {t: fa.tol_ratio(got[t], want[t]) for t in got}
        err = {t: max_err([(got[t], want[t])]) for t in got}
        equal = {t: float((got[t] == want[t]).float().mean()) for t in got}
        lse_err = max_err([(lse, p_lse)])
        # fault controls on the same inputs: the causal mask shifted by
        # one key (forward), lse offset by a small constant (backward)
        ctrl = {"out_mask_shifted": fa.tol_ratio(out, fa.flash_fwd_plain(
            q, k, v, q_offset=1, **kw)[0]) if causal else None}
        bad = (q, k, v, do, lse + FLASH_LSE_SHIFT, delta)
        ctrl["dq_lse_offset"] = fa.tol_ratio(got["dq"],
                                             fa.flash_dq_plain(*bad, **kw))
        bdk, bdv = fa.flash_dkv_plain(*bad, **kw)
        ctrl["dk_lse_offset"] = fa.tol_ratio(got["dk"], bdk)
        ctrl["dv_lse_offset"] = fa.tol_ratio(got["dv"], bdv)
        checks = {"finite": all(bool(t.float().isfinite().all())
                                for t in got.values()),
                  "within_tol": max(ratio.values()) <= 1.0,
                  "lse_within_tol": lse_err <= fa.LSE_TOL,
                  "controls_above_tol": all(c > 1.0 for c in ctrl.values()
                                            if c is not None),
                  "deterministic": all(torch.equal(
                      dict(got, lse=lse)[t], again[t]) for t in again),
                  **sass_checks(sass)}
        del want, bdk, bdv, again
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=causal, enable_gqa=H != n_kv)
        times = {
            "flash_fwd": (cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, **kw),
                                  5),
                          cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, **kw),
                                  2),
                          cuda_ms(lambda: F.scaled_dot_product_attention(
                              q, k, v, is_causal=causal,
                              enable_gqa=H != n_kv), 10)),
            "flash_dq": (cuda_ms(lambda: fa.flash_dq_cuda(*args, **kw), 5),
                         cuda_ms(lambda: fa.flash_dq_plain(*args, **kw), 2),
                         None),
            "flash_dkv": (cuda_ms(lambda: fa.flash_dkv_cuda(*args, **kw), 5),
                          cuda_ms(lambda: fa.flash_dkv_plain(*args, **kw),
                                  2), None)}
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), do, retain_graph=True), 10)
        for kern, (ms, plain_ms, lib_ms) in times.items():
            b = flash_bound(kern, B, H, n_kv, S, causal)
            terms = {"flash_fwd": ("out",), "flash_dq": ("dq",),
                     "flash_dkv": ("dk", "dv")}[kern]
            row = {"max_abs_err": max(err[t] for t in terms), "ms": ms,
                   "plain_ms": plain_ms,
                   "library_ms": lib_bwd if lib_ms is None else lib_ms,
                   "bound": b, "split_floor_ms": flash_bound(
                       kern, B, H, n_kv, S, causal, split=True)[0]}
            prev = rows.get(kern)
            if prev is None:
                rows[kern] = row
            else:
                prev["max_abs_err"] = max(prev["max_abs_err"],
                                          row["max_abs_err"])
                prev.setdefault("other_shapes", {})[name] = row
        emit(phase="kernel_check", kernel="flash_fwd/flash_dq/flash_dkv",
             shape=name, B=B, H=H, n_kv=n_kv, S=S, hd=128, causal=causal,
             tol=(f"|got - want| <= {fa.REL_TOL} |want| + {fa.FLOOR_TOL} "
                  f"max|want|; lse within {fa.LSE_TOL}"),
             tol_ratio=ratio, max_abs_err=err, bitequal_share=equal,
             lse_max_abs_err=lse_err, control_tol_ratio=ctrl,
             sass=sass,
             ms={kk: t[0] for kk, t in times.items()},
             plain_ms={kk: t[1] for kk, t in times.items()},
             library=FLASH_LIBRARY, library_fwd_ms=times["flash_fwd"][2],
             library_bwd_ms=lib_bwd,
             bwd_over_library=(times["flash_dq"][0]
                               + times["flash_dkv"][0]) / lib_bwd,
             bound_ms={kk: flash_bound(kk, B, H, n_kv, S, causal)[0]
                       for kk in times},
             split_floor_ms={kk: flash_bound(kk, B, H, n_kv, S, causal,
                                             split=True)[0] for kk in times},
             bound_by={kk: flash_bound(kk, B, H, n_kv, S, causal)[1]
                       for kk in times}, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"flash kernels ({name}) failed: {checks}")
        del q, k, v, do, out, lse, delta, args, got, qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    return rows


# -- the serving path: Llama-3-8B through ServeEngine ----------------------------

SERVE_SEED = 0
N_REQUESTS, PROMPT_MIN, PROMPT_MAX, MAX_NEW = 24, 128, 1024, 32
SERVE_SHAPE = dict(max_reqs=16, page_size=16, max_pages_per_seq=128,
                   n_pages=2049, prefill_chunk=256, page_integrity=True)


def _clone_pool(pool):
    return [{k: v.clone() for k, v in lyr.items()} for lyr in pool]


def capture_steps(eng) -> dict:
    """Wrap the engine's two device steps so that each keeps its operands,
    the pool cloned before the step writes it: the decode step with the
    most active slots and the prefill chunk that starts latest."""
    snaps = {}
    decode_step, prefill_step = eng._decode_step, eng._prefill_step

    def decode(pool, tokens, table, pos, active, ledger):
        n = int(active.sum())
        if n > snaps.get("decode", {"key": 0})["key"]:
            snaps.pop("decode", None)
            snaps["decode"] = {"key": n, "pool": _clone_pool(pool),
                               "tokens": tokens.clone(),
                               "table": table.clone(), "pos": pos.clone(),
                               "active": active.clone()}
        return decode_step(pool, tokens, table, pos, active, ledger)

    def prefill(pool, tokens, row, pos0, last, ledger):
        p0 = int(pos0[0])
        if p0 > snaps.get("prefill", {"key": -1})["key"]:
            # the chunk's request is the oldest prefilling one; rows past
            # its true length are padding, whose logits the engine ignores
            req = min((r for r in eng.batcher.live if r.state == "prefill"),
                      key=lambda r: r.admit_seq)
            snaps.pop("prefill", None)
            snaps["prefill"] = {"key": p0, "pool": _clone_pool(pool),
                                "tokens": tokens.clone(),
                                "table": row.clone(), "pos": pos0.clone(),
                                "active": None, "rows": min(
                                    tokens.shape[1], req.replay_len - p0)}
        return prefill_step(pool, tokens, row, pos0, last, ledger)

    eng._decode_step, eng._prefill_step = decode, prefill
    return snaps


def tick_times(eng) -> dict:
    """Mean ms of the engine's decode-only and prefill+decode ticks, from
    its ``serve.tick`` spans."""
    out = {}
    spans = [e for e in eng.profiler.events.snapshot()
             if e["name"] == "serve.tick" and "dur_ns" in e]
    for label, keep in (
            ("decode_only", lambda a: not a["prefill"] and a["n_decode"]),
            ("prefill_only", lambda a: a["prefill"] and not a["n_decode"]),
            ("prefill_and_decode", lambda a: a["prefill"] and a["n_decode"])):
        durs = [e["dur_ns"] / 1e6 for e in spans if keep(e["attrs"])]
        out[label] = {"ticks": len(durs),
                      "mean_ms": sum(durs) / len(durs) if durs else None}
    dec = [e["attrs"]["n_decode"] for e in spans if e["attrs"]["n_decode"]]
    out["mean_decode_batch"] = sum(dec) / len(dec) if dec else None
    return out


def serving_path(dev, cfg, scfg, kernels, label="") -> dict:
    """``ServeEngine`` answers the seeded requests through the kernel; the
    launch counts are zeroed just before ``run()`` and read just after.
    ``label`` prefixes the phase's name."""
    import torch
    from fpga_ai_nic_tpu_torch import serve_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.serve import ServeEngine
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = serve_llama.random_params(cfg, SERVE_SEED, dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    prompts = serve_llama.make_prompts(SERVE_SEED + 1, N_REQUESTS,
                                       PROMPT_MIN, PROMPT_MAX, cfg.vocab)
    eng = ServeEngine(params, cfg, scfg, device=dev)
    snaps = capture_steps(eng)
    reqs = [eng.submit(p, MAX_NEW) for p in prompts]
    for k in kernels.values():
        k.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    s = eng.run()
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    calls = s["prefill_calls"] + s["decode_calls"]
    fresh = sum(1 for r in reqs if r.evictions == 0)
    if s["completed"] != N_REQUESTS or any(
            len(r.generated) != MAX_NEW
            or not all(0 <= t < cfg.vocab for t in r.generated)
            for r in reqs):
        raise AssertionError("serving: not every request got its tokens")
    if (s["recovery"]["faults"] or s["recovery"]["recoveries"]
            or s["page_trips"] or s["logit_trips"]):
        raise AssertionError(f"serving: faults or guard trips "
                             f"{s['recovery']}, page_trips="
                             f"{s['page_trips']}, logit_trips="
                             f"{s['logit_trips']}")
    if launches["paged_attend"] != cfg.n_layers * calls:
        raise AssertionError(
            f"paged_attend launched {launches['paged_attend']} times, "
            f"expected {cfg.n_layers} x {calls} forward_paged calls")
    req = s["requests"]
    ticks = tick_times(eng)
    moe = ("" if cfg.moe is None else
           f", {cfg.moe_experts} experts top-{cfg.moe_top_k}, capacity "
           f"factor {cfg.moe_capacity_factor}")
    emit(phase=label + "serving_path", model=(
        f"Llama (dim {cfg.dim}, {cfg.n_layers} layers, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, ffn {cfg.ffn_dim}, vocab {cfg.vocab}, "
        f"{cfg.dtype}{moe}), random weights"), requests=N_REQUESTS,
         prompt_lens=[int(p.shape[0]) for p in prompts], max_new=MAX_NEW,
         serve_config={f: getattr(scfg, f) for f in SERVE_SHAPE},
         weight_init_s=init_s, wall_s=wall,
         ticks=s["ticks"], prefill_calls=s["prefill_calls"],
         decode_calls=s["decode_calls"], prefill_tokens=s["prefill_tokens"],
         prefill_tok_s=s["prefill_tokens"] / wall,
         decode_tok_s=(s["tokens_out"] - fresh) / wall,
         output_tok_s=s["tokens_out"] / wall, tick_ms=ticks,
         ttft_mean_s=req["ttft_mean_s"], ttft_p95_s=req["ttft_p95_s"],
         tpot_mean_s=req["tpot_mean_s"], tpot_p95_s=req["tpot_p95_s"],
         queue_wait_mean_s=req["queue_wait_mean_s"],
         evictions=s["evictions"], pages_in_use_peak=s["pages_in_use_peak"],
         pool_bytes=s["serve"]["pool_bytes"],
         weight_bytes=llama.param_bytes(params),
         peak_mem_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                      if dev.type == "cuda" else None),
         launches=launches, recovery=s["recovery"],
         page_trips=s["page_trips"], logit_trips=s["logit_trips"])
    eng.pool = []                      # the pool is no longer needed
    return {"params": params, "prompts": prompts, "reqs": reqs,
            "snaps": snaps, "launches": launches, "summary": s,
            "ticks": ticks}


def _step(params, cfg, scfg, snap, pool, impl):
    from fpga_ai_nic_tpu_torch.models import llama_decode
    logits, _ = llama_decode.forward_paged(
        params, snap["tokens"], pool, snap["table"], snap["pos"], cfg,
        page_size=scfg.page_size, active=snap["active"], attend_impl=impl)
    return logits


def serving_profile(dev, cfg, scfg, run) -> dict:
    """Where a tick's time goes: one decode and one prefill step (kernel
    route, on the snapshotted operands) under torch.profiler, each step
    timed alone, and the page-checksum pass timed alone."""
    from fpga_ai_nic_tpu_torch.ops import integrity
    params, snaps = run["params"], run["snaps"]
    pool = snaps["decode"]["pool"]
    out = {"page_checksums_ms": cuda_ms(
        lambda: integrity.page_checksums(pool), 3),
        "page_checksums_device_ms": device_ms(
            lambda: integrity.page_checksums(pool), 10,
            ("row_checksums_kernel",))}
    for kind in ("decode", "prefill"):
        snap = snaps[kind]
        step = (lambda snap=snap: _step(params, cfg, scfg, snap,
                                        snap["pool"], "kernel"))
        out[f"{kind}_step_ms"] = cuda_ms(step, 3)
        out[f"{kind}_profile"] = profile_run(
            "serving_profile", step, 2, step_kind=kind,
            active_slots=(snap["key"] if kind == "decode" else 1),
            pos0=(snap["key"] if kind == "prefill" else None))
    # a decode-only tick runs the step plus two checksum passes (verify
    # the input pool, record the output pool's ledger)
    ticks = run["ticks"]
    emit(phase="serving_breakdown",
         page_checksums_ms=out["page_checksums_ms"],
         page_checksums_device_ms=out["page_checksums_device_ms"],
         decode_step_ms=out["decode_step_ms"],
         prefill_step_ms=out["prefill_step_ms"],
         decode_tick_device_model_ms=(out["decode_step_ms"]
                                      + 2 * out["page_checksums_ms"]),
         measured_decode_only_tick_ms=ticks.get("decode_only", {}).get(
             "mean_ms"))
    return out


# The kernel route's bf16 logits may differ from the reference's by the
# f32 sums' other order, carried through 32 bf16 layers; the fault controls
# below, attention with a known fault on the same operands, must differ by
# more than this limit, or the check could not see them.  On an H100 the
# sound route differed by 0.078 (decode) and 0.086 (prefill), the weakest
# control (last key dropped) by 0.59 and 0.36; the limit sits between, six
# bf16 steps at the logits' magnitude (4 to 8).
PARITY_LOGIT_TOL = 0.1875
# streams held against generate() after serving parity: the first 4 of
# the run's (cut from all 24 to make room for the restore tier's phases,
# then from 8 on a slow host: one generate a stream at 32 layers is the
# phase's whole cost)
VS_GENERATE_STREAMS = 4
PARITY_CONTROLS = ("last_key_dropped", "newest_page_hidden", "pages_rotated")


def _faulty_attend(attend, fault, page_size):
    """``_cached_attend`` with one deliberate fault: each row's last visible
    key hidden, its newest page_size keys hidden, or the gathered pages
    rotated by one (a table off by one)."""
    def run(q, ck, cv, pos, n_heads, n_kv, sm_scale):
        if fault == "last_key_dropped":
            pos = pos - 1
        elif fault == "newest_page_hidden":
            pos = pos - page_size
        else:
            ck, cv = ck.roll(page_size, 2), cv.roll(page_size, 2)
        return attend(q, ck, cv, pos, n_heads, n_kv, sm_scale)
    return run


def serving_parity(dev, cfg, scfg, run, label="") -> None:
    """Kernel against the gathered-view reference on the snapshotted
    operands: the largest logit error must stay within PARITY_LOGIT_TOL,
    every fault control must exceed it, most rows' top-2 margin must exceed
    the error, and there the argmax must agree.  Then the first
    ``VS_GENERATE_STREAMS`` served streams against the port's
    contiguous-cache ``generate()``, counted.  With MoE
    layers the reference and the controls take the kernel route's expert
    choices (``pinned_routing``): a near tie that the two attention
    routes' rounding decides differently moves a row's logits by more
    than any rounding, so the unpinned error and the share of flipped
    assignments are reported beside.  ``label`` prefixes the phases'
    names."""
    import torch
    from fpga_ai_nic_tpu_torch.models import llama_decode
    from fpga_ai_nic_tpu_torch.ops import moe
    params, snaps = run["params"], run["snaps"]
    for kind in ("decode", "prefill"):
        snap = snaps.pop(kind)

        def rows(logits):
            logits = logits.float().reshape(-1, cfg.vocab)
            if snap["active"] is not None:
                return logits[snap["active"].reshape(-1)]
            return logits[:snap["rows"]]

        kernel_routes, ref_routes = [], []
        with pinned_routing(moe, kernel_routes):
            lk = rows(_step(params, cfg, scfg, snap,
                            _clone_pool(snap["pool"]), "kernel"))
        pin = kernel_routes if cfg.moe is not None else None
        controls = {}
        attend = llama_decode._cached_attend
        for fault in PARITY_CONTROLS:
            llama_decode._cached_attend = _faulty_attend(attend, fault,
                                                         scfg.page_size)
            try:
                with pinned_routing(moe, [], pin):
                    controls[fault] = rows(_step(
                        params, cfg, scfg, snap, _clone_pool(snap["pool"]),
                        "reference"))
            finally:
                llama_decode._cached_attend = attend
        moe_extra = {}
        if pin is not None:
            with pinned_routing(moe, ref_routes):
                lu = rows(_step(params, cfg, scfg, snap,
                                _clone_pool(snap["pool"]), "reference"))
            live = (snap["active"] if snap["active"] is not None else
                    torch.arange(snap["tokens"].shape[1]) < snap["rows"])
            moe_extra = {"unpinned_max_logit_err": float(
                (lk - lu).abs().max()), "routing_flip_share": flip_share(
                    kernel_routes, ref_routes),
                "live_rows_flip_share": flip_share(
                    kernel_routes, ref_routes, live)}
            del lu
        with pinned_routing(moe, [], pin):
            lr = rows(_step(params, cfg, scfg, snap, snap["pool"],
                            "reference"))
        del snap["pool"]
        err = float((lk - lr).abs().max())
        control_err = {f: float((c - lr).abs().max())
                       for f, c in controls.items()}
        top2 = lr.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > err
        agree = lk.argmax(-1) == lr.argmax(-1)
        checks = {
            "finite": bool(lk.isfinite().all()),
            "err_within_tol": err <= PARITY_LOGIT_TOL,
            "controls_above_tol": all(e > PARITY_LOGIT_TOL
                                      for e in control_err.values()),
            "most_rows_decided": 2 * int(decided.sum()) > lr.shape[0],
            "argmax_equal_where_decided": bool(agree[decided].all()),
        }
        emit(phase=label + "serving_parity", step=kind,
             rows=int(lr.shape[0]), max_logit_err=err, tol=PARITY_LOGIT_TOL,
             **moe_extra,
             control_max_logit_err=control_err,
             ref_logit_absmax=float(lr.abs().max()),
             rows_with_margin_above_err=int(decided.sum()),
             argmax_equal_all_rows=int(agree.sum()), checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"serving parity ({kind}) failed: {checks}")
        del lk, lr, controls
    equal, diverged = 0, []
    for req, p in zip(run["reqs"][:VS_GENERATE_STREAMS],
                      run["prompts"]):
        prompt = torch.from_numpy(p).to(dev)
        ref = llama_decode.generate(params, prompt[None], MAX_NEW, cfg)[
            0, len(p):].tolist()
        if ref == req.generated:
            equal += 1
            continue
        k = next(i for i, (a, b) in enumerate(zip(ref, req.generated))
                 if a != b)
        ctx = torch.cat([prompt, torch.tensor(ref[:k], dtype=torch.int32,
                                              device=dev)])
        cache = llama_decode.init_cache(cfg, 1, len(ctx), device=dev)
        logits, _ = llama_decode.forward(params, ctx[None], cache, 0, cfg)
        top2 = logits[0, -1].float().topk(2).values
        diverged.append({"uid": req.uid, "prompt_len": len(p), "at": k,
                         "served": req.generated[k], "generate": ref[k],
                         "generate_margin": float(top2[0] - top2[1])})
    emit(phase=label + "serving_vs_generate",
         streams=min(VS_GENERATE_STREAMS, len(run["reqs"])),
         token_equal=equal, first_divergences=diverged)


# -- the serving fleet: Llama-3-8B replicas as slots on the card ---------------

FLEET_SEED = 17
FLEET_REQUESTS = 12
FLEET_LENGTHS = dict(prompt_lo=PROMPT_MIN, prompt_hi=PROMPT_MAX,
                     output_lo=16, output_hi=32)
# the traffic's schedule is in fleet ticks, the same on any machine: at
# tick 11 the loaded-most decode replica holds three live requests
FLEET_KILL_TICK = 11
FLEET_HANDOFF_PAGES = 64       # a 1024-token prompt's pages: the timed move


def _fleet_traffic(kind):
    from fpga_ai_nic_tpu_torch.serve import traffic
    if kind == "steady":
        cfg = traffic.steady_config(FLEET_REQUESTS, FLEET_SEED,
                                    base_interval_ticks=1.0, **FLEET_LENGTHS)
    else:
        cfg = traffic.thundering_herd_config(FLEET_REQUESTS, FLEET_SEED,
                                             **FLEET_LENGTHS)
    return traffic.generate(cfg)


def _fleet_run(dev, params, cfg, scfg, wl, kernels, *, fcfg=None, slots=3,
               plan=None, autoscale=False) -> dict:
    """A ``ServeFleet`` (``devices`` the card ``slots`` times) driven over
    ``wl`` by ``serve_fleet.drive``, the autoscaler closing the loop where
    asked; the launch counts are zeroed just before the drive and read just
    after.  Checks what every fleet run must give: every request its
    ``max_new`` tokens, paged_attend launched once a layer a step, no
    engine recovery and no guard trip."""
    import torch
    from fpga_ai_nic_tpu_torch import serve_fleet
    from fpga_ai_nic_tpu_torch.runtime import chaos
    from fpga_ai_nic_tpu_torch.serve import Autoscaler, FleetConfig, ServeFleet
    fleet = ServeFleet(params, cfg, scfg, fcfg or FleetConfig(1, 2),
                       chaos=plan, devices=[dev] * slots)
    scaler = (Autoscaler(fleet, fleet.slo, events=fleet.profiler.events)
              if autoscale else None)
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    with chaos.activate(plan):
        reqs = serve_fleet.drive(fleet, wl, cfg.vocab, autoscaler=scaler)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    s = fleet.summary()
    calls = sum(r["prefill_calls"] + r["decode_calls"]
                for r in s["replicas"])
    if s["completed"] != len(wl) or any(
            len(r.generated) != r.max_new
            or not all(0 <= t < cfg.vocab for t in r.generated)
            for r in reqs):
        raise AssertionError("fleet: not every request got its tokens")
    if launches["paged_attend"] != cfg.n_layers * calls:
        raise AssertionError(
            f"fleet: paged_attend launched {launches['paged_attend']} times, "
            f"expected {cfg.n_layers} x {calls} steps")
    if any(k for name, k in launches.items()
           if name not in ("paged_attend", "row_checksums")):
        raise AssertionError(f"fleet launched other kernels {launches}")
    faults = {k: s[k] for k in ("serve_recoveries", "page_trips",
                                "logit_trips")}
    if any(faults.values()):
        raise AssertionError(f"fleet: recoveries or guard trips {faults}")
    return {"fleet": fleet, "reqs": reqs, "summary": s, "wall": wall,
            "launches": launches, "calls": calls, "scaler": scaler,
            "streams": [list(r.generated) for r in reqs],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _fleet_numbers(r) -> dict:
    s = r["summary"]
    w = s["slo"]["windows"]
    return dict(
        ticks=s["ticks"], wall_s=r["wall"],
        output_tok_s=s["tokens_out"] / r["wall"],
        ttft_ticks={q: w["ttft"][q] for q in ("p50", "p99")},
        tpot_ticks={q: w["tpot"][q] for q in ("p50", "p99")},
        queue_wait_p95_ticks=w["queue_wait"]["p95"],
        ttft_p95_s=s["requests"]["ttft_p95_s"],
        tpot_p95_s=s["requests"]["tpot_p95_s"],
        handoffs=s["handoffs"], handoff_wire_bytes=s["handoff_wire_bytes"],
        handoff_host_bytes=s["handoff_host_bytes"],
        handoff_integrity_trips=s["handoff_integrity_trips"],
        fleet_replays=s["fleet_replays"], kills=s["kills"],
        grows=s["grows"], evictions=s["evictions"],
        mttr_mean_s=s["recovery"]["mttr_mean_s"],
        replicas=[{k: x[k] for k in ("replica", "role", "alive",
                                     "prefill_calls", "decode_calls")}
                  for x in s["replicas"]],
        launches=r["launches"], peak_mem_gb=r["peak_mem_gb"])


def handoff_check(dev, cfg, scfg, fleet) -> dict:
    """One ``FLEET_HANDOFF_PAGES``-page move between two replicas' pools
    after the run (their pages hold the run's KV): the moved pages bit for
    bit, the destination's other pages and the whole source unchanged (by
    page checksums); then the move timed by CUDA events, with and without
    the landed-page check, beside its bound (each moved byte read once and
    written once)."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import integrity
    from fpga_ai_nic_tpu_torch.serve import handoff
    src = fleet.replicas[0].engine.pool
    dst = fleet.replicas[1].engine.pool
    n = FLEET_HANDOFF_PAGES
    src_pages = list(range(1, n + 1))
    dst_pages = list(range(scfg.n_pages - 1, scfg.n_pages - 1 - n, -1))
    plan = handoff.plan_for(cfg, scfg, n)
    src_chk = integrity.page_checksums(src)
    dst_chk = integrity.page_checksums(dst)
    handoff.apply_handoff(plan, src, dst, src_pages, dst_pages)
    sync(dev)
    si = torch.tensor(src_pages, device=dev)
    di = torch.tensor(dst_pages, device=dev)
    for lyr_s, lyr_d in zip(src, dst):
        for key in ("k", "v"):
            if not torch.equal(lyr_d[key].index_select(0, di).view(
                    torch.int16), lyr_s[key].index_select(0, si).view(
                    torch.int16)):
                raise AssertionError("handoff: a moved page differs")
    after = integrity.page_checksums(dst)
    keep = torch.ones(scfg.n_pages, dtype=torch.bool, device=dev)
    keep[di] = False
    if not (torch.equal(after[keep], dst_chk[keep])
            and torch.equal(after[di], src_chk[si])
            and torch.equal(integrity.page_checksums(src), src_chk)):
        raise AssertionError("handoff: a bystander or source page changed")
    expect = src_chk[si].cpu().numpy().astype("uint32")
    ms = cuda_ms(lambda: handoff.apply_handoff(plan, src, dst, src_pages,
                                               dst_pages), 10, 2)
    ms_checked = cuda_ms(lambda: handoff.apply_handoff(
        plan, src, dst, src_pages, dst_pages, expect=expect), 10, 2)
    return {"pages": n, "wire_bytes": plan.wire_bytes(), "ms": ms,
            "checked_ms": ms_checked,
            "bound_ms": 1e3 * 2 * plan.wire_bytes() / HBM_BYTES_PER_S,
            "bound_by": "bytes", "bitexact": True, "bystanders_equal": True,
            "source_equal": True}


def _single_run(dev, params, cfg, scfg, wl) -> dict:
    """The single engine (role "both", ``scfg``) on ``wl``'s prompts, all
    submitted before its first tick; wall s of the run, synchronised."""
    import torch
    from fpga_ai_nic_tpu_torch.serve import ServeEngine
    eng = ServeEngine(params, cfg, scfg, device=dev)
    reqs = [eng.submit(p, t.max_new) for p, t in
            zip(wl.prompts(cfg.vocab), wl.requests)]
    sync(dev)
    t0 = time.perf_counter()
    eng.run()
    sync(dev)
    out = {"wall": time.perf_counter() - t0, "ticks": eng.ticks,
           "steps": eng.prefill_calls + eng.decode_calls,
           "streams": [list(r.generated) for r in reqs]}
    eng.pool = []
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _free_fleet(r) -> None:
    """Drop a fleet run's pools (the engines' closures hold cycles)."""
    import torch
    for rep in r.pop("fleet").replicas:
        rep.engine.pool = []
    r.pop("scaler", None)
    gc.collect()
    torch.cuda.empty_cache()


def fleet_path(dev, cfg, scfg, params, kernels, smi) -> dict:
    """The disaggregated fleet (1 prefill + 2 decode replicas) on the
    steady traffic, against the single engine (role "both", same config)
    on the same prompts.  The walls are taken in the order fleet, single,
    fleet, single: the first fleet run is the first on fresh pools, so
    only the later pair compares warm runs."""
    wl = _fleet_traffic("steady")
    r = _fleet_run(dev, params, cfg, scfg, wl, kernels)
    s = r["summary"]
    if s["handoffs"] != len(wl) or s["fleet_replays"] or s["kills"]:
        raise AssertionError(f"fleet_path: handoffs {s['handoffs']}, "
                             f"replays {s['fleet_replays']}")
    for x in s["replicas"]:
        if (x["role"] == "prefill" and x["decode_calls"]) or (
                x["role"] == "decode" and x["prefill_calls"]):
            raise AssertionError(f"fleet_path: a role ran the other step {x}")
    # the ledger: each step verifies its input pool and records its
    # output's (two launches), each handoff checks its landed pages (one)
    if r["launches"]["row_checksums"] != 2 * r["calls"] + s["handoffs"]:
        raise AssertionError(
            f"fleet_path: {r['launches']['row_checksums']} row_checksums "
            f"launches, expected 2 x {r['calls']} + {s['handoffs']}")
    moved = handoff_check(dev, cfg, scfg, r["fleet"])
    numbers = _fleet_numbers(r)
    _free_fleet(r)
    single = _single_run(dev, params, cfg, scfg, wl)
    again = _fleet_run(dev, params, cfg, scfg, wl, kernels)
    _free_fleet(again)
    single_again = _single_run(dev, params, cfg, scfg, wl)
    equal = sum(a == b for a, b in zip(r["streams"], single["streams"]))
    repeat_equal = (again["streams"] == r["streams"]
                    and single_again["streams"] == single["streams"])
    emit(phase="fleet_path", card=smi, model=(
        f"Llama-3-8B width, {cfg.n_layers} layers, {cfg.dtype}, random "
        "weights"), fleet="1 prefill + 2 decode, slots on one card",
         traffic=wl.summary(), serve_config={
             f: getattr(scfg, f) for f in SERVE_SHAPE},
         single_engine_equal=equal, single_engine_ticks=single["ticks"],
         steps={"fleet": r["calls"], "single": single["steps"]},
         walls_in_run_order={"fleet_1": r["wall"],
                             "single_1": single["wall"],
                             "fleet_2": again["wall"],
                             "single_2": single_again["wall"]},
         repeat_streams_equal=repeat_equal, handoff=moved, **numbers)
    if equal != len(wl):
        raise AssertionError(f"fleet_path: {len(wl) - equal} streams differ "
                             "from the single engine's")
    if not repeat_equal:
        raise AssertionError("fleet_path: a repeated run's streams differ")
    return {"streams": r["streams"], "summary": s, "launches": r["launches"],
            "first_handoff_tick": r["reqs"][0].first_tick + 1,
            "handoff": moved}


def fleet_kill(dev, cfg, scfg, params, kernels, path, smi) -> dict:
    """``fleet_path``'s traffic with the loaded-most decode replica
    preempted at ``FLEET_KILL_TICK``: its live requests migrate over the
    handoff; every stream byte-identical to ``fleet_path``'s."""
    import torch
    from fpga_ai_nic_tpu_torch.runtime import chaos
    plan = chaos.FaultPlan([chaos.FaultSpec(
        "preemption", "fleet.membership", step=FLEET_KILL_TICK)],
        seed=FLEET_SEED)
    r = _fleet_run(dev, params, cfg, scfg, _fleet_traffic("steady"),
                   kernels, plan=plan)
    s = r["summary"]
    kill = [e["attrs"] for e in r["fleet"].profiler.events.snapshot()
            if e["name"] == "fleet.membership"]
    equal = sum(a == b for a, b in zip(r["streams"], path["streams"]))
    emit(phase="fleet_kill", card=smi, kill_tick=FLEET_KILL_TICK,
         membership=kill, chaos_fired=len(plan.fired),
         streams_equal_fleet_path=equal,
         handoffs_fleet_path=path["summary"]["handoffs"],
         recovery=s["recovery"], **_fleet_numbers(r))
    if not (len(plan.fired) == 1 and s["kills"] == 1 and kill
            and kill[0]["migrated"] >= 1):
        raise AssertionError(f"fleet_kill: no kill with live work {kill}")
    if s["fleet_replays"] or s["serve_recoveries"]:
        raise AssertionError("fleet_kill: a request was replayed")
    if s["handoffs"] <= path["summary"]["handoffs"]:
        raise AssertionError("fleet_kill: no migration handoff")
    if equal != len(path["streams"]):
        raise AssertionError(f"fleet_kill: {len(path['streams']) - equal} "
                             "streams differ from fleet_path's")
    _free_fleet(r)
    return {"launches": r["launches"], "summary": s}


def fleet_handoff_integrity(dev, cfg, scfg, params, kernels, path,
                            smi) -> dict:
    """``fleet_path``'s run with a ``wirebit`` fault on the wire of its
    first handoff (the tick after request 1's prefill finished): the
    landed-page check (``row_checksums``) trips, the one bounded retry
    re-sends the intact pages; no replay, streams equal to
    ``fleet_path``'s."""
    import torch
    from fpga_ai_nic_tpu_torch.runtime import chaos
    if not scfg.page_integrity:
        raise AssertionError("fleet_handoff_integrity needs page_integrity")
    step = path["first_handoff_tick"]
    plan = chaos.FaultPlan([chaos.FaultSpec(
        "corruption", "serve.handoff", step=step, mode="wirebit",
        fraction=0.001)], seed=FLEET_SEED)
    chaos.install_wire_tap()
    try:
        r = _fleet_run(dev, params, cfg, scfg, _fleet_traffic("steady"),
                       kernels, plan=plan)
    finally:
        chaos.uninstall_wire_tap()
    s = r["summary"]
    equal = sum(a == b for a, b in zip(r["streams"], path["streams"]))
    want_chk = 2 * r["calls"] + s["handoffs"] + s["handoff_integrity_trips"]
    emit(phase="fleet_handoff_integrity", card=smi, wirebit_tick=step,
         chaos_fired=len(plan.fired), streams_equal_fleet_path=equal,
         row_checksums_expected=want_chk, **_fleet_numbers(r))
    if not (len(plan.fired) == 1 and s["handoff_integrity_trips"] >= 1):
        raise AssertionError("fleet_handoff_integrity: no trip")
    if s["fleet_replays"] or s["serve_recoveries"]:
        raise AssertionError("fleet_handoff_integrity: a request replayed")
    if r["launches"]["row_checksums"] != want_chk:
        raise AssertionError(
            f"fleet_handoff_integrity: {r['launches']['row_checksums']} "
            f"row_checksums launches, expected {want_chk}")
    if equal != len(path["streams"]):
        raise AssertionError("fleet_handoff_integrity: streams differ")
    _free_fleet(r)
    return {"launches": r["launches"], "summary": s}


def fleet_autoscale(dev, cfg, scfg, params, kernels, smi) -> dict:
    """The closed loop on thundering-herd traffic: a 1-prefill, 1-decode
    fleet with 4 slots a replica and ``serve_fleet.SPARE_SLOTS`` spare
    slot on the card, the autoscaler reading the fleet's windowed SLO
    metrics every tick.  Each stream is held against the single engine's
    (same config) for its prompt: a request that went through the fleet's
    replay tier re-prefills its generated tokens, where the single engine
    decoded them, so only the others must be equal; each replayed
    stream's first divergence is reported with the margin of the single
    engine's token there."""
    from fpga_ai_nic_tpu_torch import serve_fleet
    from fpga_ai_nic_tpu_torch.models import llama_decode
    from fpga_ai_nic_tpu_torch.serve import FleetConfig
    import torch
    scfg4 = dataclasses.replace(scfg, max_reqs=4)
    wl = _fleet_traffic("herd")
    r = _fleet_run(dev, params, cfg, scfg4, wl, kernels,
                   fcfg=FleetConfig(1, 1), slots=2 + serve_fleet.SPARE_SLOTS,
                   autoscale=True)
    s = r["summary"]
    block = serve_fleet.slo_block(s, r["reqs"], r["scaler"])
    replayed = sorted({e["attrs"]["uid"]
                       for e in r["fleet"].profiler.events.snapshot()
                       if e["name"] == "fleet.replay"})
    _free_fleet(r)
    single = _single_run(dev, params, cfg, scfg4, wl)
    prompts = wl.prompts(cfg.vocab)
    equal, diverged = [], []
    for req, ref in zip(r["reqs"], single["streams"]):
        if req.generated == ref:
            equal.append(req.uid)
            continue
        k = next(i for i, (a, b) in enumerate(zip(ref, req.generated))
                 if a != b)
        ctx = torch.cat([torch.from_numpy(prompts[req.uid - 1]).to(dev),
                         torch.tensor(ref[:k], dtype=torch.int32,
                                      device=dev)])
        cache = llama_decode.init_cache(cfg, 1, len(ctx), device=dev)
        logits, _ = llama_decode.forward(params, ctx[None], cache, 0, cfg)
        top2 = logits[0, -1].float().topk(2).values
        diverged.append({"uid": req.uid, "replayed": req.uid in replayed,
                         "at": k, "fleet": req.generated[k],
                         "single": ref[k],
                         "single_margin": float(top2[0] - top2[1])})
        del cache, logits
    emit(phase="fleet_autoscale", card=smi, max_reqs=4,
         spare_slots=serve_fleet.SPARE_SLOTS, slo_block=block, slo=s["slo"],
         replayed_uids=replayed, single_engine_equal=len(equal),
         single_engine_ticks=single["ticks"], first_divergences=diverged,
         **_fleet_numbers(r))
    if block["scale_outs"] < 1 or block["tokens_lost"]:
        raise AssertionError(f"fleet_autoscale: {block}")
    if any(not d["replayed"] for d in diverged):
        raise AssertionError("fleet_autoscale: a stream that was not "
                             f"replayed differs from the single engine's "
                             f"{diverged}")
    return {"launches": r["launches"], "summary": s, "slo_block": block}


def generate_llama_phase(dev, smi) -> None:
    """``generate_llama``'s default run on the card, as one line."""
    from fpga_ai_nic_tpu_torch import generate_llama
    t0 = time.perf_counter()
    out = generate_llama.main([])
    wall = time.perf_counter() - t0
    emit(phase="generate_llama", card=smi, wall_s=wall, **out)
    if out["tokens"] != 1 + len(out["prompt"]) + 16 or not all(
            0 <= t < 384 for t in out["continuation_ids"]):
        raise AssertionError(f"generate_llama: {out}")


def fleet_phases(dev, cfg, scfg, params, kernels, smi) -> dict:
    path = fleet_path(dev, cfg, scfg, params, kernels, smi)
    runs = {"path": path,
            "kill": fleet_kill(dev, cfg, scfg, params, kernels, path, smi),
            "integrity": fleet_handoff_integrity(dev, cfg, scfg, params,
                                                 kernels, path, smi),
            "autoscale": fleet_autoscale(dev, cfg, scfg, params, kernels,
                                         smi)}
    generate_llama_phase(dev, smi)
    return runs


# -- the Llama training path: ShardedTrainer at Llama-3-8B width ----------------

TRAIN_ARGV = ["--model=llama3_8b", "--model.n_layers=4",
              "--model.attn_block=512", "--model.attn_impl=auto",
              "--seq=4096", "--global_batch=2", "--mesh.dp=2", "--iters=5",
              "--collective.impl=ring",
              "--collective.compression.codec=pallas",
              "--collective.fused_kernel=true",
              "--optimizer.kind=sgd", "--optimizer.learning_rate=0.1"]
TRAIN_GROUPS = {"flash": FLASH_KERNELS, "ring_bfp": RING_KERNELS}


def llama_train_path(dev, kernels, argv=TRAIN_ARGV,
                     phase="llama_train_path") -> dict:
    """``ShardedTrainer`` built by the ``train_llama`` driver's own
    functions from ``argv`` (``TRAIN_ARGV``; ``TP_TRAIN_ARGV``, dp=2 x
    tp=2, the phase ``llama_tp_train_path``): one warm-up and ``--iters``
    timed steps on seeded batches, launch counts zeroed just before the
    first step and read after the last (a step: the flash kernels once a
    layer and dp rank, every tp rank's heads in one launch; one ring
    reduce-scatter and all-gather a (tp) group); the replicas bit-equal
    within each group and their replicated leaves across the groups;
    with tp the ring kernels timed on the path's own rows; then two more
    steps under the profiler."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import fused_update
    mcfg, cfg, seq, device = train_llama.parse(argv)
    n, tp = cfg.mesh.dp, cfg.mesh.tp
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr, state = train_llama.build(mcfg, cfg, device)
    sync(dev)
    init_s = time.perf_counter() - t0
    batches = [tr.shard_batch(b) for b in train_llama.batches(
        mcfg, cfg, seq, cfg.iters + 3)]
    for k in kernels.values():
        k.launches = 0
    state, loss = tr.step(state, batches[0])          # warm-up
    losses = [float(loss)]
    sync(dev)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(cfg.iters + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for b, mark in zip(batches[1:cfg.iters + 1], marks[1:]):
        state, loss = tr.step(state, b)
        losses.append(loss)
        mark.record()
    sync(dev)
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [float(v) for v in losses]
    launches = {name: k.launches for name, k in kernels.items()}
    steps = cfg.iters + 1
    groups = tr.n_shards
    per_step = {name: 0 for name in kernels}
    per_step.update(flash_fwd=mcfg.n_layers * n, flash_dq=mcfg.n_layers * n,
                    flash_dkv=mcfg.n_layers * n, ring_rs_update=groups,
                    ring_ag=groups)
    for name, count in launches.items():
        if count != steps * per_step[name]:
            raise AssertionError(f"{phase}: {name} launched {count} "
                                 f"times, expected {steps} x "
                                 f"{per_step[name]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    # no name but the state may hold its replicas: the profiled steps
    # below allocate the next ones while it lives
    reps = state.replicas.view(groups, n, -1)
    checks = {"replicas_equal_within_groups": bool((reps == reps[:, :1]).all()),
              "replicated_leaves_equal_across_groups": all(
                  bool((reps[:, :, a:b] == reps[:1, :, a:b]).all())
                  for a, b in tr._rep_spans),
              "replicas_in_model_dtype": (state.replicas.dtype
                                          == mcfg.torch_dtype)}
    del reps
    if not all(checks.values()):
        raise AssertionError(f"{phase}: {checks}")
    tokens = cfg.iters * cfg.global_batch * seq
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    L = int(state.replicas.shape[1])
    # the flat rows a step holds at its peak: the replicas, the f32
    # masters and the f32 gradient rows
    flat_gb = (state.replicas.numel() * state.replicas.element_size()
               + 4 * state.w_own.numel() + 4 * groups * n * L) / 1e9
    median = sorted(step_ms)[cfg.iters // 2]
    emit(phase=phase, model=(
        f"Llama-3-8B width (dim {mcfg.dim}, {mcfg.n_heads}/{mcfg.n_kv_heads} "
        f"heads, ffn {mcfg.ffn_dim}, vocab {mcfg.vocab}, {mcfg.dtype}), "
        f"{mcfg.n_layers} layers, attn_block {mcfg.attn_block}, "
        f"attn_impl {mcfg.attn_impl}, random weights"),
         params=llama.num_params(mcfg), seq=seq,
         global_batch=cfg.global_batch, dp=n, tp=tp,
         collective=str(cfg.collective),
         optimizer=str(cfg.optimizer), weight_init_s=init_s,
         steps=cfg.iters, wall_s=wall, ms_per_step=1e3 * wall / cfg.iters,
         step_ms=step_ms, median_step_ms=median,
         tokens_per_sec=tokens / wall, losses=losses,
         padded_len=int(state.w_own.numel()), padded_len_per_row=L,
         replicas_dtype=str(state.replicas.dtype).removeprefix("torch."),
         peak_mem_gb=peak, flat_rows_gb=flat_gb,
         flat_rows_share_of_peak=flat_gb / peak,
         launches=launches, launches_per_step=per_step,
         replicas_equal=True, checks=checks)
    out = {"launches": launches, "mcfg": mcfg, "cfg": cfg, "seq": seq,
           "steps": steps, "median_step_ms": median, "peak_mem_gb": peak,
           "tokens_per_sec": tokens / wall}
    if tp > 1:
        flat_g, _ = tr.grads(state, batches[-1])
        g, w = flat_g[:n], state.w_own[:n]
        C = L // n

        def rs():
            return fused_update.reduce_scatter(g, cfg.collective)

        def ag():
            return fused_update.all_gather_flat(w, cfg.collective)
        rs_b, ag_b = ring_bytes(n, L, C)
        out["ring"] = {
            "shape": f"n={n}, L={L} (one tp group's rows), no optimizer",
            "rs_device_ms": device_ms(rs, 5, ("ring_rs_kernel",)),
            "rs_bound": bound(rs_b, 11 * n * L),
            "ag_device_ms": device_ms(ag, 5, ("ring_ag_kernel",)),
            "ag_bound": bound(ag_b, 10 * n * C)}
        emit(phase=phase.replace("path", "ring_times"), **out["ring"])
        del flat_g, g, w
    held = [state]
    del state            # held[0] alone keeps the state each step replaces
    extra = iter(batches[cfg.iters + 1:])

    def train_step():
        held[0], _ = tr.step(held[0], next(extra))

    prof = profile_run(phase.replace("path", "profile"), train_step, 2,
                       groups=TRAIN_GROUPS)
    out["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
    out["profile"] = prof
    del tr, held, batches
    torch.cuda.empty_cache()
    return out


GENERIC_TOL = {"out": (2e-5, 2e-5), "dq": (5e-5, 5e-4),   # (atol, rtol):
               "dk": (5e-5, 5e-4), "dv": (5e-5, 5e-4)}    # the JAX tests'
AUTO_GRAD_REL_TOL = 1e-4  # kernel route against torch route, f32 model


def generic_checks(dev, B, H, n_kv, S, hd, causal) -> dict:
    """The second flash family (csrc/flash_generic.cu) against its plain
    versions at the tiny f32 model's attention shape: within the JAX
    tests' own f32 tolerances, a second launch bit-equal, the causal mask
    shifted by one key as the fault control; times of kernel, plain
    version and the library's attention.  Returns rows by kernel."""
    import torch
    import torch.nn.functional as F
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(400)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def ratio(a, b, t):
        atol, rtol = GENERIC_TOL[t]
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    q, k, v = rand(B, H, S, hd), rand(B, n_kv, S, hd), rand(B, n_kv, S, hd)
    do = rand(B, H, S, hd)
    kw = dict(causal=causal, sm_scale=hd ** -0.5)
    out, lse = fa.flash_fwd_generic_cuda(q, k, v, **kw)
    delta = (do * out).sum(-1)
    args = (q, k, v, do, lse, delta)
    got = {"out": out, "dq": fa.flash_dq_generic_cuda(*args, **kw)}
    got["dk"], got["dv"] = fa.flash_dkv_generic_cuda(*args, **kw)
    again = dict(zip(("out", "lse"), fa.flash_fwd_generic_cuda(q, k, v,
                                                               **kw)))
    again["dq"] = fa.flash_dq_generic_cuda(*args, **kw)
    again["dk"], again["dv"] = fa.flash_dkv_generic_cuda(*args, **kw)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
    want = {"out": p_out, "dq": fa.flash_dq_plain(*args, **kw)}
    want["dk"], want["dv"] = fa.flash_dkv_plain(*args, **kw)
    sync(dev)
    ratios = {t: ratio(got[t], want[t], t) for t in got}
    err = {t: max_err([(got[t], want[t])]) for t in got}
    lse_err = max_err([(lse, p_lse)])
    ctrl = ratio(out, fa.flash_fwd_plain(q, k, v, q_offset=1, **kw)[0],
                 "out") if causal else None
    checks = {"finite": all(bool(t.isfinite().all()) for t in got.values()),
              "within_tol": max(ratios.values()) <= 1.0,
              "lse_within_tol": lse_err <= fa.LSE_TOL,
              "control_above_tol": ctrl is None or ctrl > 1.0,
              "deterministic": all(torch.equal(dict(got, lse=lse)[t],
                                                again[t]) for t in again)}
    names = ("flash_fwd_generic", "flash_dq_generic", "flash_dkv_generic")
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                             enable_gqa=H != n_kv)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), do, retain_graph=True), 10)
    calls = {
        "flash_fwd_generic": (lambda: fa.flash_fwd_generic_cuda(q, k, v, **kw),
                              lambda: fa.flash_fwd_plain(q, k, v, **kw),
                              cuda_ms(lambda: F.scaled_dot_product_attention(
                                  q, k, v, is_causal=causal,
                                  enable_gqa=H != n_kv), 10), ("out",)),
        "flash_dq_generic": (lambda: fa.flash_dq_generic_cuda(*args, **kw),
                             lambda: fa.flash_dq_plain(*args, **kw),
                             lib_bwd, ("dq",)),
        "flash_dkv_generic": (lambda: fa.flash_dkv_generic_cuda(*args, **kw),
                              lambda: fa.flash_dkv_plain(*args, **kw),
                              lib_bwd, ("dk", "dv"))}
    rows = {}
    for name, (kern, plain, lib_ms, terms) in calls.items():
        b = flash_bound(name[:-len("_generic")], B, H, n_kv, S, causal,
                        hd=hd, itemsize=4, ops_per_s=F32_OPS_PER_S)
        rows[name] = {"max_abs_err": max(err[t] for t in terms),
                      "ms": device_ms(kern, 20, (name + "_kernel",)),
                      "call_ms": cuda_ms(kern, 20, 3),
                      "plain_ms": cuda_ms(plain, 10), "library_ms": lib_ms,
                      "bound": b}
    emit(phase="kernel_check", kernel="/".join(names), shape=(
        f"tiny f32 model: B={B}, H={H}, n_kv={n_kv}, S={S}, hd={hd}"),
         causal=causal, tol=("|got - want| <= atol + rtol |want|, "
                             f"(atol, rtol) {GENERIC_TOL}"),
         tol_ratio=ratios, max_abs_err=err, lse_max_abs_err=lse_err,
         control_tol_ratio=ctrl, library="F.scaled_dot_product_attention "
         "in f32; its autograd backward for dq and dk/dv together",
         rows={n: dict(r, bound_ms=r["bound"][0], bound_by=r["bound"][1])
               for n, r in rows.items()}, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"second flash family failed: {checks}")
    return rows


def auto_route(dev) -> dict:
    """The tiny f32 Llama config (head_dim 16) with ``attn_impl="auto"`` on
    the card: it takes the flash kernels, as the JAX route takes Pallas
    for it on a TPU, and they are the second family's.  Its kernels are
    held against their plain versions first; then one step runs with the
    launch counts zeroed just before and read just after; then the
    step's gradients are held against the torch route's on the same
    weights and batch.  Returns the launches and the kernel rows."""
    import dataclasses
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    from fpga_ai_nic_tpu_torch.ops import ring_attention as ra
    mcfg, cfg, seq, _ = train_llama.parse([
        "--model=tiny", "--model.attn_block=128", "--model.attn_impl=auto",
        "--seq=128", "--global_batch=4", "--mesh.dp=2", "--iters=1"])
    B = cfg.global_batch // cfg.mesh.dp
    rows = generic_checks(dev, B, mcfg.n_heads, mcfg.n_kv_heads, seq,
                          mcfg.head_dim, True)
    q = torch.zeros((B, mcfg.n_heads, seq, mcfg.head_dim), device=dev,
                    dtype=mcfg.torch_dtype)
    routed = ra.pallas_route("auto", q, kv_seq_len=seq)
    kernels = {"flash_fwd_generic": fa.FLASH_FWD_GENERIC,
               "flash_dq_generic": fa.FLASH_DQ_GENERIC,
               "flash_dkv_generic": fa.FLASH_DKV_GENERIC,
               "flash_fwd": fa.FLASH_FWD, "flash_dq": fa.FLASH_DQ,
               "flash_dkv": fa.FLASH_DKV}
    tr, state = train_llama.build(mcfg, cfg, "cuda")
    batch = tr.shard_batch(next(train_llama.batches(mcfg, cfg, seq, 1)))
    g_auto, loss_auto = tr.grads(state, batch)
    tr_x, state_x = train_llama.build(
        dataclasses.replace(mcfg, attn_impl="xla"), cfg, "cuda")
    g_xla, loss_xla = tr_x.grads(state_x, batch)
    for kern in kernels.values():
        kern.launches = 0
    state, loss = tr.step(state, batch)
    sync(dev)
    launches = {name: kern.launches for name, kern in kernels.items()}
    loss = float(loss)
    per_step = mcfg.n_layers * cfg.mesh.dp
    grad_rel = float((g_auto - g_xla).abs().max() / g_xla.abs().max())
    loss_rel = abs(float(loss_auto) - float(loss_xla)) / abs(float(loss_xla))
    checks = {"finite": math.isfinite(loss), "routed_to_kernels": routed,
              "second_family_launched": all(
                  launches[n] == per_step for n in rows),
              "no_tensor_core_launch": all(
                  launches[n] == 0 for n in ("flash_fwd", "flash_dq",
                                             "flash_dkv")),
              "grads_match_torch_route": grad_rel <= AUTO_GRAD_REL_TOL,
              "loss_matches_torch_route": loss_rel <= AUTO_GRAD_REL_TOL}
    emit(phase="auto_route", model=dataclasses.asdict(mcfg), seq=seq,
         dp=cfg.mesh.dp, loss=loss, launches=launches,
         grad_rel_err_vs_torch_route=grad_rel,
         loss_rel_err_vs_torch_route=loss_rel, tol=AUTO_GRAD_REL_TOL,
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"auto route failed: {checks}")
    del tr, state, tr_x, state_x, g_auto, g_xla
    return {"launches": launches, "rows": rows}


# The kernel route's gradients differ from the plain route's by the f32
# sums' other order inside attention, carried through four bf16 layers and
# rounded to bf16; the fault control (one layer's causal mask shifted by
# one key, on the plain route) must differ by more than the limit.
PARITY_GRAD_REL_TOL = 0.05
PARITY_LOSS_TOL = 2e-3


def _shifted_mask_attention(q, k, v, *, causal=True, sm_scale=None,
                            k_block=512, impl="xla"):
    """The plain blocked route with every query row seeing one key past
    itself (q positions shifted by one): a fault control."""
    from torch.utils.checkpoint import checkpoint
    from fpga_ai_nic_tpu_torch.ops import ring_attention as ra

    def run(q2, k2, v2):
        import torch
        B, H, S, dh = q2.shape
        m, l, o = ra._init_acc(B, H, S, dh, q2.device)
        pos = torch.arange(S, device=q2.device) + 1
        m, l, o = ra._attend_chunk(q2.float(), k2, v2, pos, 0, m, l, o,
                                   dh ** -0.5, True, k_block)
        return ra._finish(o, l, q2.dtype)
    return checkpoint(run, q, k, v, use_reentrant=False)


def llama_train_parity(dev, run) -> None:
    """``loss_fn``'s gradients on one rank's batch at the path's widths
    and sequence, through the kernels (attn_impl="pallas") and the
    checkpointed plain route ("xla"), compared as one flat vector; and the
    plain route with layer 0's mask shifted, which must exceed the
    limit."""
    import dataclasses
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import fused_update
    mcfg, cfg, seq = run["mcfg"], run["cfg"], run["seq"]
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = llama.init(gen, mcfg, dev)
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(params)]
    toks, labels = next(train_llama.batches(mcfg, cfg, seq, 1))
    batch = (toks[:1].to(dev), labels[:1].to(dev))

    def grads(impl, hook=None):
        c = dataclasses.replace(mcfg, attn_impl=impl)
        orig = llama.flash_attention_remat
        calls = [0]

        def layer_attention(*a, **kw):
            calls[0] += 1
            return (hook if calls[0] == 1 else orig)(*a, **kw)
        if hook is not None:
            llama.flash_attention_remat = layer_attention
        try:
            loss = llama.loss_fn(params, batch, c)
            return float(loss.detach()), torch.autograd.grad(loss, leaves)
        finally:
            llama.flash_attention_remat = orig

    def dist(ga, gb):
        return math.sqrt(sum(float((a.float() - b.float()).square().sum())
                             for a, b in zip(ga, gb)))

    l_k, g_k = grads("pallas")
    l_p, g_p = grads("xla")
    norm = math.sqrt(sum(float(g.float().square().sum()) for g in g_p))
    rel = dist(g_k, g_p) / norm
    del g_k
    l_c, g_c = grads("xla", hook=_shifted_mask_attention)
    rel_c = dist(g_c, g_p) / norm
    checks = {"finite": all(math.isfinite(v) for v in (l_k, l_p, rel)),
              "grad_within_tol": rel <= PARITY_GRAD_REL_TOL,
              "loss_within_tol": abs(l_k - l_p) <= PARITY_LOSS_TOL,
              "control_above_tol": rel_c > PARITY_GRAD_REL_TOL}
    emit(phase="llama_train_parity", seq=seq, batch_rows=1,
         loss_kernel=l_k, loss_plain=l_p, loss_diff=abs(l_k - l_p),
         loss_tol=PARITY_LOSS_TOL, grad_rel_err=rel,
         grad_tol=PARITY_GRAD_REL_TOL, grad_norm_plain=norm,
         control_loss=l_c, control_grad_rel_err=rel_c, checks=checks)
    del params, leaves, g_p, g_c
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"llama training parity failed: {checks}")


# -- sequence parallelism: the flash offsets, the dp x sp Llama path ---------

SP_HOP = (1, 32, 8, 2048)     # B, H, Hkv, S_local: one ring hop at Llama-3-8B
#                               width, sequence 8192 over sp=4
SP_OFFSET_CASES = (           # name, Sq, Sk, q_offset, k_offset at the hop
    ("past hop", 2048, 2048, 2048, 0),
    ("diagonal", 2048, 2048, 4096, 4096),
    ("gathered", 2048, 8192, 4096, 0),       # k tiles past 6143: unseen
    ("shift 100", 2048, 2048, 100, 0),       # cuts through the 64-row tiles
    ("future chunk", 2048, 2048, 0, 2048),   # out 0, lse -1e30, no grads
)
GENERIC_OFFSET_SHAPE = (1, 8, 2, 64, 4)      # B, H, Hkv, hd, length divisor
OFFSET_KERNELS = ("flash_fwd_offsets", "flash_dq_offsets",
                  "flash_dkv_offsets")


# sha256 of the zero-offset tensor-core kernels' out, lse, dq, dk and dv on
# ``codec_probe.flash_case``'s numpy-seeded inputs at FLASH_SHAPES: the bits
# the kernels computed before the offset channel and the key bias existed
# (tests/test_torch_cuda.py pins the same values as BIAS_FREE_DIGESTS).
ZERO_OFFSET_DIGESTS = {
    "path GQA causal S4096":
        "ef1beb15fd830d8bf2468895f5f7abbff24bae5cff32d65ddbbc7cb5a7b7e409",
    "MHA non-causal S1024":
        "53fbdbb78277b08fd41c63957b573717cf7d1f57f4efee4e6d64109545a0c7da",
}


def zero_offset_digests(dev) -> dict:
    """The digests ``codec_probe.flash_case`` computes at each FLASH_SHAPES
    entry with this script's kernels (offsets 0)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "codec_probe", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "codec_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    me = sys.modules[__name__]
    return {name: digest for name, digest, *_ in (
        probe.flash_case(me, dev, si) for si in range(len(FLASH_SHAPES)))}


def _offset_ratio(got, want, family, term):
    """The family's limit ratio for output ``term`` (``tol_ratio``; the
    JAX tests' f32 limits, GENERIC_TOL, for the second family); 0 where
    both are all zero."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    if not bool(want.any()) and not bool(got.any()):
        return 0.0
    if family == "tensor_cores":
        return fa.tol_ratio(got, want)
    atol, rtol = GENERIC_TOL[term]
    return float(((got.double() - want.double()).abs()
                  / (atol + rtol * want.double().abs())).max())


def flash_offset_checks(dev) -> dict:
    """The flash kernels' q/k offset channel against the plain versions on
    the card: the tensor-core forward, dq and dk/dv at a ring hop's width
    (B=1, H=32, Hkv=8, hd=128, bf16, causal) and the second family in f32
    (H=8, Hkv=2, hd=64, a quarter of the lengths), at SP_OFFSET_CASES:
    within the limits, lse within LSE_TOL, a second launch bit-equal,
    zeros where nothing is seen; two controls that must exceed the limit
    (the plain backward at lse + 0.05; the plain forward without the
    offsets).  The tensor-core kernels timed by device time at the past
    hop (their offset instantiations) and the diagonal beside the bound,
    the plain version and the library's attention at the same shape.
    Launches with zero offsets keep their bits (ZERO_OFFSET_DIGESTS).
    Returns the rows of the offset instantiations."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    digests = zero_offset_digests(dev)
    emit(phase="zero_offset_digests", digests=digests,
         equal=digests == ZERO_OFFSET_DIGESTS)
    if digests != ZERO_OFFSET_DIGESTS:
        raise AssertionError(f"zero-offset flash kernels changed bits: "
                             f"{digests} against {ZERO_OFFSET_DIGESTS}")
    B, H, n_kv, Sl = SP_HOP
    g = torch.Generator(device=dev).manual_seed(600)
    sass = flash_sass(bias=False, offsets=True)
    gB, gH, gkv, ghd, div = GENERIC_OFFSET_SHAPE
    families = {
        "tensor_cores": (torch.bfloat16, B, H, n_kv, 128, 1,
                         (fa.flash_fwd_cuda, fa.flash_dq_cuda,
                          fa.flash_dkv_cuda)),
        "second_family": (torch.float32, gB, gH, gkv, ghd, div,
                          (fa.flash_fwd_generic_cuda, fa.flash_dq_generic_cuda,
                           fa.flash_dkv_generic_cuda))}
    errs = {k: 0.0 for k in OFFSET_KERNELS}
    worst = {}
    for family, (dt, b, h, kv, hd, d, (fwd, dq, dkv)) in families.items():
        for name, Sq, Sk, qo, ko in SP_OFFSET_CASES:
            Sq, Sk, qo, ko = Sq // d, Sk // d, qo // d, ko // d

            def rand(*shape):
                return torch.randn(shape, generator=g, device=dev).to(dt)

            q, k, v = rand(b, h, Sq, hd), rand(b, kv, Sk, hd), rand(
                b, kv, Sk, hd)
            do = rand(b, h, Sq, hd)
            kw = dict(causal=True, sm_scale=hd ** -0.5, q_offset=qo,
                      k_offset=ko)
            out, lse = fwd(q, k, v, **kw)
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, do, lse, delta)
            got = {"out": out, "dq": dq(*args, **kw)}
            got["dk"], got["dv"] = dkv(*args, **kw)
            again = dict(zip(("out", "lse"), fwd(q, k, v, **kw)))
            again["dq"] = dq(*args, **kw)
            again["dk"], again["dv"] = dkv(*args, **kw)
            p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
            want = {"out": p_out, "dq": fa.flash_dq_plain(*args, **kw)}
            want["dk"], want["dv"] = fa.flash_dkv_plain(*args, **kw)
            sync(dev)
            ratio = {t: _offset_ratio(got[t], want[t], family, t)
                     for t in got}
            err = {t: max_err([(got[t], want[t])]) for t in got}
            lse_err = max_err([(lse, p_lse)])
            rows = qo + torch.arange(Sq, device=dev) < ko   # see no key
            keys = ko + torch.arange(Sk, device=dev) > qo + Sq - 1
            unseen = (bool((lse[..., rows] == -1e30).all())
                      and not any(got[t][..., rows, :].any()
                                  for t in ("out", "dq"))
                      and not any(got[t][..., keys, :].any()
                                  for t in ("dk", "dv")))
            ctrl = {}
            if qo != ko:      # the plain forward without the offsets
                ctrl["out_offsets_dropped"] = _offset_ratio(
                    out, fa.flash_fwd_plain(q, k, v, causal=True,
                                            sm_scale=hd ** -0.5)[0], family,
                    "out")
            if bool(want["dq"].any()):
                bad = (q, k, v, do, lse + FLASH_LSE_SHIFT, delta)
                ctrl["dq_lse_offset"] = _offset_ratio(
                    got["dq"], fa.flash_dq_plain(*bad, **kw), family, "dq")
            checks = {
                "finite": all(bool(t.float().isfinite().all())
                              for t in got.values()),
                "within_tol": max(ratio.values()) <= 1.0,
                "lse_within_tol": lse_err <= fa.LSE_TOL,
                "zeros_where_unseen": unseen,
                "controls_above_tol": all(c > 1.0 for c in ctrl.values()),
                "deterministic": all(torch.equal(dict(got, lse=lse)[t],
                                                 again[t]) for t in again)}
            if family == "tensor_cores":
                checks.update(sass_checks(sass))
                if qo != ko:
                    for kern, terms in zip(OFFSET_KERNELS, (
                            ("out",), ("dq",), ("dk", "dv"))):
                        errs[kern] = max(errs[kern],
                                         *(err[t] for t in terms))
                worst[name] = max(ratio.values())
            emit(phase="flash_offset_checks", family=family, case=name,
                 dtype=str(dt).removeprefix("torch."), B=b, H=h, n_kv=kv,
                 hd=hd, Sq=Sq, Sk=Sk, q_offset=qo, k_offset=ko,
                 tol=("tol_ratio <= 1" if family == "tensor_cores" else
                      f"|got - want| <= atol + rtol |want|, {GENERIC_TOL}"),
                 tol_ratio=ratio, max_abs_err=err, lse_max_abs_err=lse_err,
                 control_tol_ratio=ctrl, checks=checks)
            if not all(checks.values()):
                raise AssertionError(f"flash offsets ({family}, {name}) "
                                     f"failed: {checks}")
            del q, k, v, do, out, lse, delta, args, got, again, want
    times = hop_times(dev, g, B, H, n_kv, Sl)
    emit(phase="flash_offset_times", shape=(
        f"B={B}, H={H}, Hkv={n_kv}, Sq=Sk={Sl}, hd=128, bf16"),
         library=FLASH_LIBRARY + " (is_causal=False at the past hop)",
         sass_offsets=sass,
         times={c: {kk: dict(r, bound_ms=r["bound"][0],
                             bound_by=r["bound"][1])
                    for kk, r in t.items()} for c, t in times.items()},
         worst_tol_ratio=worst)
    torch.cuda.empty_cache()
    rows = {}
    for kern, off in zip(("flash_fwd", "flash_dq", "flash_dkv"),
                         OFFSET_KERNELS):
        past, diag = times["past hop"][kern], times["diagonal"][kern]
        rows[off] = {"max_abs_err": errs[off], "ms": past["ms"],
                     "plain_ms": past["plain_ms"],
                     "library_ms": past["library_ms"],
                     "bound": past["bound"],
                     "extra": {"call_ms": past["call_ms"],
                               "split_floor_ms": past["split_floor_ms"],
                               "diagonal_ms": diag["ms"],
                               "diagonal_plain_ms": diag["plain_ms"],
                               "diagonal_library_ms": diag["library_ms"],
                               "diagonal_bound_ms": diag["bound"][0],
                               "worst_tol_ratio": max(worst.values())}}
    return rows


def hop_times(dev, g, B, H, n_kv, Sl) -> dict:
    """The tensor-core kernels timed at a ring hop of B x H (Hkv) x Sl,
    hd=128, bf16: the past hop (q_offset Sl, every key seen, the OFF
    instantiations) and the diagonal (causal, the kernels without), each
    by device time beside a whole call's time, the plain version, the
    library's attention and the bound."""
    import torch
    import torch.nn.functional as F
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    times = {}
    for name, causal, qo in (("past hop", False, Sl), ("diagonal", True,
                                                       0)):
        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)

        q, k, v = rand(B, H, Sl, 128), rand(B, n_kv, Sl, 128), rand(
            B, n_kv, Sl, 128)
        do = rand(B, H, Sl, 128)
        kw = dict(causal=True, sm_scale=128 ** -0.5, q_offset=qo,
                  k_offset=0)
        out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qr, kr, vr,
                                                 is_causal=causal,
                                                 enable_gqa=True)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), do, retain_graph=True), 10)
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd_cuda(q, k, v, **kw),
                          lambda: fa.flash_fwd_plain(q, k, v, **kw),
                          cuda_ms(lambda: F.scaled_dot_product_attention(
                              q, k, v, is_causal=causal, enable_gqa=True),
                              10)),
            "flash_dq": (lambda: fa.flash_dq_cuda(*args, **kw),
                         lambda: fa.flash_dq_plain(*args, **kw), lib_bwd),
            "flash_dkv": (lambda: fa.flash_dkv_cuda(*args, **kw),
                          lambda: fa.flash_dkv_plain(*args, **kw), lib_bwd)}
        times[name] = {}
        for kern, (call, plain, lib_ms) in calls.items():
            times[name][kern] = {
                "ms": device_ms(call, 20, (kern + "_kernel",)),
                "call_ms": cuda_ms(call, 20, 3),
                "plain_ms": cuda_ms(plain, 2), "library_ms": lib_ms,
                "bound": flash_bound(kern, B, H, n_kv, Sl, causal),
                "split_floor_ms": flash_bound(kern, B, H, n_kv, Sl, causal,
                                              split=True)[0]}
        del q, k, v, do, out, lse, delta, args, qr, kr, vr, lib_out
    return times


MOE_SP_HOP = (1, 32, 8, 4096)  # B, H, Hkv, S_local: a ring hop of the MoE
#                               sp x ep path (sequence 8192 over sp=2)


def moe_sp_hop_checks(dev) -> dict:
    """The tensor-core kernels at the MoE sp x ep path's past hop (MOE_SP_HOP,
    q_offset S_local, k_offset 0, causal: every key seen) against the plain
    versions (``tol_ratio`` <= 1, lse within LSE_TOL, a second launch
    bit-equal), then ``hop_times`` at that shape.  Returns the rows the
    offset kernels' line entries take from it."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    B, H, n_kv, Sl = MOE_SP_HOP
    g = torch.Generator(device=dev).manual_seed(610)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rand(B, H, Sl, 128), rand(B, n_kv, Sl, 128), rand(
        B, n_kv, Sl, 128)
    do = rand(B, H, Sl, 128)
    kw = dict(causal=True, sm_scale=128 ** -0.5, q_offset=Sl, k_offset=0)
    out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    got = {"out": out, "dq": fa.flash_dq_cuda(*args, **kw)}
    got["dk"], got["dv"] = fa.flash_dkv_cuda(*args, **kw)
    again = {"out": fa.flash_fwd_cuda(q, k, v, **kw)[0],
             "dq": fa.flash_dq_cuda(*args, **kw)}
    again["dk"], again["dv"] = fa.flash_dkv_cuda(*args, **kw)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
    want = {"out": p_out, "dq": fa.flash_dq_plain(*args, **kw)}
    want["dk"], want["dv"] = fa.flash_dkv_plain(*args, **kw)
    sync(dev)
    ratio = {t: fa.tol_ratio(got[t], want[t]) for t in got}
    err = {t: max_err([(got[t], want[t])]) for t in got}
    lse_err = max_err([(lse, p_lse)])
    checks = {"finite": all(bool(t.float().isfinite().all())
                            for t in got.values()),
              "within_tol": max(ratio.values()) <= 1.0,
              "lse_within_tol": lse_err <= fa.LSE_TOL,
              "deterministic": all(torch.equal(got[t], again[t])
                                   for t in again)}
    del q, k, v, do, out, lse, delta, args, got, again, want, p_out, p_lse
    times = hop_times(dev, g, B, H, n_kv, Sl)
    emit(phase="moe_sp_hop_checks", shape=(
        f"B={B}, H={H}, Hkv={n_kv}, Sq=Sk={Sl}, hd=128, bf16, q_offset "
        f"{Sl}, k_offset 0"), tol="tol_ratio <= 1", tol_ratio=ratio,
         max_abs_err=err, lse_max_abs_err=lse_err, checks=checks,
         library=FLASH_LIBRARY + " (is_causal=False at the past hop)",
         times={c: {kk: dict(r, bound_ms=r["bound"][0],
                             bound_by=r["bound"][1])
                    for kk, r in t.items()} for c, t in times.items()})
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"flash kernels at the MoE sp hop: {checks}")
    rows = {}
    for kern, off, terms in zip(("flash_fwd", "flash_dq", "flash_dkv"),
                                OFFSET_KERNELS, (("out",), ("dq",),
                                                 ("dk", "dv"))):
        past = times["past hop"][kern]
        rows[off] = {"moe_sp_hop_ms": past["ms"],
                     "moe_sp_hop_call_ms": past["call_ms"],
                     "moe_sp_hop_plain_ms": past["plain_ms"],
                     "moe_sp_hop_library_ms": past["library_ms"],
                     "moe_sp_hop_bound_ms": past["bound"][0],
                     "moe_sp_hop_bound_by": past["bound"][1],
                     "moe_sp_hop_max_abs_err": max(err[t] for t in terms),
                     "moe_sp_hop_diagonal_ms": times["diagonal"][kern]["ms"],
                     "moe_sp_hop_diagonal_bound_ms": times["diagonal"][
                         kern]["bound"][0]}
    return rows


TRAIN_SP_ARGV = ["--model=llama3_8b", "--model.n_layers=4",
                 "--model.attn_block=512", "--model.attn_impl=auto",
                 "--seq=8192", "--global_batch=2", "--mesh.dp=2",
                 "--mesh.sp=4", "--iters=3", "--collective.impl=ring",
                 "--collective.compression.codec=pallas",
                 "--collective.fused_kernel=true",
                 "--optimizer.kind=sgd", "--optimizer.learning_rate=0.1"]
SP_GROUPS = {"flash": FLASH_KERNELS, "ring_bfp": RING_KERNELS,
             "rotation": ("roll_cuda_kernel",)}


def llama_sp_train_path(dev, kernels, remat=False) -> dict:
    """``ShardedTrainer`` at dp=2 x sp=4 as ``train_llama.build`` builds
    it (Llama-3-8B width, 4 layers, sequence 8192, global batch
    2): one warm-up and ``--iters`` timed steps on one batch, launch
    counts zeroed just before the first step and read after the last
    (a step: per dp rank and layer, sp diagonal hops on the flash kernels
    without offsets and sp (sp - 1) / 2 past hops on their offset
    instantiations, the forwards twice with ``remat``; one ring_rs_update
    and one ring_ag), replicas bit-equal, a finite loss that falls on the
    repeated batch; then two more steps under the profiler.  With
    ``remat`` (``--remat=true``, the phase ``llama_sp_remat_path``) the
    trainer's gradients at its final state are also taken with the loss
    without remat (``remat_grads``)."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    argv = TRAIN_SP_ARGV + (["--remat=true"] if remat else [])
    phase = "llama_sp_remat_path" if remat else "llama_sp_train_path"
    mcfg, cfg, seq, device = train_llama.parse(argv)
    n, sp = cfg.mesh.dp, cfg.mesh.sp
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr, state = train_llama.build(mcfg, cfg, device,
                                  train_llama.remat_flag(argv))
    sync(dev)
    init_s = time.perf_counter() - t0
    batch = tr.shard_batch(next(train_llama.batches(mcfg, cfg, seq, 1)))
    for kern in kernels.values():
        kern.launches = 0
    state, loss = tr.step(state, batch)               # warm-up
    losses = [float(loss)]
    sync(dev)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(cfg.iters + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for mark in marks[1:]:
        state, loss = tr.step(state, batch)
        losses.append(loss)
        mark.record()
    sync(dev)
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [float(v) for v in losses]
    launches = {name: kern.launches for name, kern in kernels.items()}
    steps = cfg.iters + 1
    diag, past = mcfg.n_layers * n * sp, mcfg.n_layers * n * sp * (sp - 1) // 2
    fwd = 2 if remat else 1              # the recomputation's forwards
    per_step = {name: 0 for name in kernels}
    per_step.update(flash_fwd=fwd * diag, flash_dq=diag, flash_dkv=diag,
                    flash_fwd_offsets=fwd * past, flash_dq_offsets=past,
                    flash_dkv_offsets=past, ring_rs_update=1, ring_ag=1)
    for name, count in launches.items():
        if count != steps * per_step[name]:
            raise AssertionError(f"{phase}: {name} launched "
                                 f"{count} times, expected {steps} x "
                                 f"{per_step[name]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss on the repeated "
                             f"batch did not fall {losses}")
    if not bool((state.replicas == state.replicas[0]).all()):
        raise AssertionError(f"{phase}: replicas differ")
    tokens = cfg.iters * cfg.global_batch * seq
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    median = sorted(step_ms)[cfg.iters // 2]
    emit(phase=phase, model=(
        f"Llama-3-8B width (dim {mcfg.dim}, {mcfg.n_heads}/{mcfg.n_kv_heads} "
        f"heads, ffn {mcfg.ffn_dim}, vocab {mcfg.vocab}, {mcfg.dtype}), "
        f"{mcfg.n_layers} layers, attn_impl {mcfg.attn_impl}, random "
        "weights"), params=llama.num_params(mcfg), seq=seq,
         global_batch=cfg.global_batch, dp=n, sp=sp, remat=remat,
         tokens_per_step=cfg.global_batch * seq,
         collective=str(cfg.collective),
         optimizer=str(cfg.optimizer), weight_init_s=init_s,
         steps=cfg.iters, wall_s=wall, ms_per_step=1e3 * wall / cfg.iters,
         step_ms=step_ms, median_step_ms=median,
         tokens_per_sec=tokens / wall, losses=losses,
         peak_mem_gb=peak, launches=launches, launches_per_step=per_step,
         replicas_equal=True)
    held = [state]
    del state

    def train_step():
        held[0], _ = tr.step(held[0], batch)

    prof = profile_run(phase.replace("path", "profile"), train_step, 2,
                       groups=SP_GROUPS)
    out = {"launches": launches, "mcfg": mcfg, "cfg": cfg, "seq": seq,
           "steps": steps, "step_ms": step_ms, "median_step_ms": median,
           "tokens_per_sec": tokens / wall, "peak_mem_gb": peak,
           "losses": losses, "profile": prof,
           "idle_share": 1 - prof["device_ms"] / prof["wall_ms"]}
    if remat:
        out["grads"] = remat_grads(dev, tr, held[0], batch, mcfg)
    del tr, held, batch
    torch.cuda.empty_cache()
    return out


def chunked_tol_ratio(got, want, chunk=1 << 27) -> tuple:
    """``(max |got - want|, flash_attention.tol_ratio(got, want))`` over
    flat gradient rows too large for the ratio's whole-tensor
    temporaries, a chunk at a time."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    top = float(want.abs().max())
    diff, ratio = 0.0, 0.0
    for a, b in zip(got.reshape(-1).split(chunk), want.reshape(-1).split(
            chunk)):
        d = (a - b).abs()
        diff = max(diff, float(d.max()))
        ratio = max(ratio, float((d / (fa.REL_TOL * b.abs()
                                       + fa.FLOOR_TOL * top)).max()))
    return diff, ratio


def remat_grads(dev, tr, state, batch, mcfg) -> dict:
    """The remat trainer's flat gradients at ``state`` against the same
    trainer's with the loss without remat (taken first: the larger
    activations before the second flat gradient exists): bit-equal or
    not, the largest difference and the flash kernels' limit ratio
    (REL_TOL, FLOOR_TOL), which must hold."""
    import torch
    from fpga_ai_nic_tpu_torch.models import llama
    remat_loss = tr.loss_fn
    tr.loss_fn = lambda p, b: llama.loss_fn(p, b, mcfg, sp_axis="sp")
    try:
        g_off, l_off = tr.grads(state, batch)
    finally:
        tr.loss_fn = remat_loss
    g_on, l_on = tr.grads(state, batch)
    diff, ratio = chunked_tol_ratio(g_on, g_off)
    res = {"loss_bitequal": bool(torch.equal(l_on, l_off)),
           "grad_bitequal": bool(torch.equal(g_on, g_off)),
           "grad_max_abs_diff": diff, "grad_tol_ratio": ratio,
           "grad_max_abs": float(g_off.abs().max()),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del g_on, g_off
    emit(phase="llama_sp_remat_grads", **res)
    if not (res["loss_bitequal"] and ratio <= 1.0):
        raise AssertionError(f"remat gradients: {res}")
    return res


def llama_sp_remat_compare(off, on) -> None:
    """Remat off against on over the same steps (same seed, batch and
    steps): the losses bit-equal at every step; each run's median step,
    tokens/s, peak memory and idle share side by side."""
    keys = ("median_step_ms", "tokens_per_sec", "peak_mem_gb", "idle_share")
    res = {k: {"remat_off": off[k], "remat_on": on[k]} for k in keys}
    equal = off["losses"] == on["losses"]
    emit(phase="llama_sp_remat_compare", losses_off=off["losses"],
         losses_on=on["losses"], losses_bitequal=equal,
         grads=on["grads"], **res)
    if not equal:
        raise AssertionError(f"remat changed the losses: {off['losses']} "
                             f"against {on['losses']}")


SP_PARITY_LAYERS = 2


def _unweighted_merge(out, lse, o_h, lse_h):
    """The fault control: the hops' partial outputs summed without their
    lse weights."""
    import torch
    return out + o_h.to(torch.float32), torch.logaddexp(lse, lse_h)


def llama_sp_parity(dev, run) -> None:
    """``loss_fn``'s gradients at Llama-3-8B width, sequence 8192,
    ``SP_PARITY_LAYERS`` layers, one row: the sp=4 kernel ring against
    sp=1 (the unsharded flash path, attn_block 512) and against the sp=4
    plain ring route, within the Llama parity limits; the kernel ring
    with its hops merged without the lse weights must exceed them."""
    import dataclasses
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    cfg, seq = run["cfg"], run["seq"]
    sp = cfg.mesh.sp
    mcfg = dataclasses.replace(run["mcfg"], n_layers=SP_PARITY_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = llama.init(gen, mcfg, dev)
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(params)]
    toks, labels = next(train_llama.batches(mcfg, cfg, seq, 1))
    whole = (toks[:1].to(dev), labels[:1].to(dev))
    shards = tuple(VirtualRanks(1, dev, sp).shard(t)[0] for t in whole)

    def grads(impl, sharded, merge=None):
        c = dataclasses.replace(mcfg, attn_impl=impl)
        orig = fa._lse_merge
        if merge is not None:
            fa._lse_merge = merge
        try:
            loss = llama.loss_fn(params, shards if sharded else whole, c,
                                 sp_axis="sp" if sharded else None)
            return float(loss.detach()), torch.autograd.grad(loss, leaves)
        finally:
            fa._lse_merge = orig

    def dist(ga, gb):
        return math.sqrt(sum(float((a.float() - b.float()).square().sum())
                             for a, b in zip(ga, gb)))

    l_k, g_k = grads("pallas", True)
    norm = math.sqrt(sum(float(g.float().square().sum()) for g in g_k))
    res = {}
    for name, args in (("sp1_flash", ("pallas", False)),
                       ("sp4_plain_ring", ("xla", True)),
                       ("control_unweighted_merge",
                        ("pallas", True, _unweighted_merge))):
        l_o, g_o = grads(*args)
        res[name] = {"loss": l_o, "loss_diff": abs(l_k - l_o),
                     "grad_rel_err": dist(g_k, g_o) / norm}
        del g_o
        torch.cuda.empty_cache()
    ctrl = res.pop("control_unweighted_merge")
    checks = {"finite": all(math.isfinite(v) for v in (l_k, norm)),
              **{f"{k}_grad_within_tol": r["grad_rel_err"]
                 <= PARITY_GRAD_REL_TOL for k, r in res.items()},
              **{f"{k}_loss_within_tol": r["loss_diff"] <= PARITY_LOSS_TOL
                 for k, r in res.items()},
              "control_above_tol": ctrl["grad_rel_err"] > PARITY_GRAD_REL_TOL}
    emit(phase="llama_sp_parity", seq=seq, sp=sp, layers=mcfg.n_layers,
         batch_rows=1, loss_kernel_ring=l_k, against=res, control=ctrl,
         grad_tol=PARITY_GRAD_REL_TOL, loss_tol=PARITY_LOSS_TOL,
         grad_norm=norm,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         checks=checks)
    del params, leaves, g_k
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"llama sp parity failed: {checks}")


# -- BERT-base training: the key-bias channel, the bucketed DDP trainer --------

BERT_SHAPE = (8, 12, 512, 64)     # B (a rank's batch), H, S, hd: BERT-base
BERT_PAD_MIN = 256                # valid lengths uniform in [256, 512]
TC_BIAS_SHAPE = (2, 8, 8, 1024)   # B, H, Hkv, S at head_dim 128
BERT_LIBRARY = ("F.scaled_dot_product_attention(q, k, v, attn_mask="
                "bias[:, None, None, :]) in bf16; its autograd backward for "
                "dq and dk/dv together")


def padding_bias(dev, B, S, pad_min, seed):
    """[B, S] f32 key bias (0 valid, -1e30 padding) of valid lengths drawn
    uniformly from [pad_min, S], and those lengths."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(pad_min, S + 1, (B,), generator=g, device=dev)
    pos = torch.arange(S, device=dev)
    bias = torch.where(pos[None, :] < lens[:, None], 0.0, -1e30)
    return bias.to(torch.float32).contiguous(), lens


def bias_case(dev, fwd, dq, dkv, q, k, v, do, bias, causal):
    """Three kernels of one family with ``bias`` (or none) against
    their plain versions: tol ratios, max errors, lse error, repeat-launch
    bits, and a fault control that must exceed the limit: with a bias the
    same kernels with a zero bias (the mask dropped), without one the
    plain backward at lse + FLASH_LSE_SHIFT."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    hd = q.shape[-1]
    kw = dict(causal=causal, sm_scale=hd ** -0.5)
    out, lse = fwd(q, k, v, key_bias=bias, **kw)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    got = {"out": out, "dq": dq(*args, key_bias=bias, **kw)}
    got["dk"], got["dv"] = dkv(*args, key_bias=bias, **kw)
    again = dict(zip(("out", "lse"), fwd(q, k, v, key_bias=bias, **kw)))
    again["dq"] = dq(*args, key_bias=bias, **kw)
    again["dk"], again["dv"] = dkv(*args, key_bias=bias, **kw)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, key_bias=bias, **kw)
    want = {"out": p_out, "dq": fa.flash_dq_plain(*args, key_bias=bias,
                                                  **kw)}
    want["dk"], want["dv"] = fa.flash_dkv_plain(*args, key_bias=bias, **kw)
    sync(dev)
    ratio = {t: fa.tol_ratio(got[t], want[t]) for t in got}
    if bias is None:
        bad = (q, k, v, do, lse + FLASH_LSE_SHIFT, delta)
        ctrl = {"dq_lse_offset": fa.tol_ratio(got["dq"],
                                              fa.flash_dq_plain(*bad, **kw)),
                "dv_lse_offset": fa.tol_ratio(got["dv"], fa.flash_dkv_plain(
                    *bad, **kw)[1])}
    else:
        z_out, z_lse = fwd(q, k, v, **kw)
        zdelta = (do.float() * z_out.float()).sum(-1)
        zargs = (q, k, v, do, z_lse, zdelta)
        ctrl = {"out_zero_bias": fa.tol_ratio(z_out, p_out),
                "dq_zero_bias": fa.tol_ratio(dq(*zargs, **kw), want["dq"]),
                "dv_zero_bias": fa.tol_ratio(dkv(*zargs, **kw)[1],
                                             want["dv"])}
    checks = {"finite": all(bool(t.float().isfinite().all())
                            for t in got.values()),
              "within_tol": max(ratio.values()) <= 1.0,
              "lse_within_tol": max_err([(lse, p_lse)]) <= fa.LSE_TOL,
              "controls_above_tol": min(ctrl.values()) > 1.0,
              "deterministic": all(torch.equal(dict(got, lse=lse)[t],
                                               again[t]) for t in again)}
    return {"tol_ratio": ratio, "control_tol_ratio": ctrl,
            "max_abs_err": {t: max_err([(got[t], want[t])]) for t in got},
            "lse_max_abs_err": max_err([(lse, p_lse)]), "checks": checks,
            "args": args, "kw": kw}


def bert_flash_checks(dev) -> dict:
    """The flash kernels at BERT-base's attention shape (bf16, head_dim
    64, non-causal, a padding mask as key bias) and the tensor-core
    kernels' key-bias channel at head_dim 128, against the plain versions.
    At BERT's shape: the second family's three kernels with the bias; the
    tensor-core forward, dq and dk/dv (head_dim 64) with and without the
    bias; each kernel timed by device time beside its bound, its plain
    version and the library's masked attention, the tensor-core ones also
    beside the second-family kernel they replace.
    Then the tensor-core kernels at B=2, H=8, S=1024, head_dim 128,
    non-causal and causal with the mask, timed with and without the bias.
    Returns the rows of both families at BERT's shape and the head_dim-128
    bias timings."""
    import torch
    import torch.nn.functional as F
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(500)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    B, H, S, hd = BERT_SHAPE
    bias, lens = padding_bias(dev, B, S, BERT_PAD_MIN, 501)
    q, k, v, do = (rand(B, H, S, hd) for _ in range(4))
    gen = bias_case(dev, fa.flash_fwd_generic_cuda, fa.flash_dq_generic_cuda,
                    fa.flash_dkv_generic_cuda, q, k, v, do, bias, False)
    args, kw = gen.pop("args"), gen.pop("kw")
    sass64 = dict(flash_sass(False, hd), **flash_sass(True, hd))
    tc64 = {}
    for name, b in (("bias", bias), ("no_bias", None)):
        res = bias_case(dev, fa.flash_fwd_cuda, fa.flash_dq_cuda,
                        fa.flash_dkv_cuda, q, k, v, do, b, False)
        res["checks"].update(sass_checks(sass64))
        tc64[name] = res
    args64 = tc64["bias"]["args"]
    # the work this data needs: every query row against its valid keys
    pairs_valid = H * S * int(lens.sum())
    mask = bias.to(torch.bfloat16)[:, None, None, :]
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), 10)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), do, retain_graph=True), 10)
    plain = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(
                 q, k, v, key_bias=bias, **kw), 3),
             "flash_dq": cuda_ms(lambda: fa.flash_dq_plain(
                 *args, key_bias=bias, **kw), 3),
             "flash_dkv": cuda_ms(lambda: fa.flash_dkv_plain(
                 *args, key_bias=bias, **kw), 3)}
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd_generic_cuda(
            q, k, v, key_bias=bias, **kw), lib_fwd, ("out",)),
        "flash_dq": (lambda: fa.flash_dq_generic_cuda(
            *args, key_bias=bias, **kw), lib_bwd, ("dq",)),
        "flash_dkv": (lambda: fa.flash_dkv_generic_cuda(
            *args, key_bias=bias, **kw), lib_bwd, ("dk", "dv"))}
    rows = {}
    for name, (kern, lib_ms, terms) in calls.items():
        rows[name + "_generic_bias"] = {
            "max_abs_err": max(gen["max_abs_err"][t] for t in terms),
            "ms": device_ms(kern, 10, (name + "_generic_kernel",)),
            "call_ms": cuda_ms(kern, 10, 2), "plain_ms": plain[name],
            "library_ms": lib_ms, "bound": flash_bound(
                name, B, H, H, S, False, hd=hd, key_bias=True,
                pairs=pairs_valid),
            "tol_ratio": max(gen["tol_ratio"][t] for t in terms)}
    tc_calls = {
        "flash_fwd": (lambda **b: fa.flash_fwd_cuda(q, k, v, **kw, **b),
                      lib_fwd, ("out",)),
        "flash_dq": (lambda **b: fa.flash_dq_cuda(*args64, **kw, **b),
                     lib_bwd, ("dq",)),
        "flash_dkv": (lambda **b: fa.flash_dkv_cuda(*args64, **kw, **b),
                      lib_bwd, ("dk", "dv"))}
    rows64 = {}
    for name, (kern, lib_ms, terms) in tc_calls.items():
        names = (name + "_kernel",)
        rows64[name + "_hd64"] = {
            "max_abs_err": max(tc64[c]["max_abs_err"][t] for c in tc64
                               for t in terms),
            "ms": device_ms(lambda: kern(key_bias=bias), 10, names),
            "no_bias_ms": device_ms(kern, 10, names),
            "call_ms": cuda_ms(lambda: kern(key_bias=bias), 10, 2),
            "plain_ms": plain[name], "library_ms": lib_ms,
            "replaced_generic_ms": rows[name + "_generic_bias"]["ms"],
            "bound": rows[name + "_generic_bias"]["bound"],
            "split_floor_ms": flash_bound(
                name, B, H, H, S, False, hd=hd, key_bias=True,
                pairs=pairs_valid, split=True)[0],
            "tol_ratio": max(tc64[c]["tol_ratio"][t] for c in tc64
                             for t in terms)}
    tol = (f"|got - want| <= {fa.REL_TOL} |want| + {fa.FLOOR_TOL} "
           f"max|want|; lse within {fa.LSE_TOL}")
    shape = f"B={B}, H={H}, S={S}, hd={hd}, bf16, non-causal"
    valid = dict(valid_lengths=lens.tolist(),
                 masked_key_share=1 - float(lens.sum()) / (B * S))
    emit(phase="bert_flash_checks", family="generic (csrc/flash_generic.cu)",
         shape=shape, **valid, tol=tol, library=BERT_LIBRARY,
         rows={n: dict(r, bound_ms=r["bound"][0], bound_by=r["bound"][1])
               for n, r in rows.items()}, **gen)
    for name, res in tc64.items():
        emit(phase="bert_flash_checks", family=(
            "tensor cores at head_dim 64 (csrc/flash_attn.cu, csrc/"
            "flash_bwd.cu)"),
             shape=shape, key_bias=name == "bias", **valid, tol=tol,
             sass=sass64, **{k_: v_ for k_, v_ in res.items()
                             if k_ not in ("args", "kw")})
    emit(phase="bert_flash_times", shape=shape, library=BERT_LIBRARY,
         rows={n: dict(r, bound_ms=r["bound"][0], bound_by=r["bound"][1])
               for n, r in rows64.items()})
    if not all(gen["checks"].values()):
        raise AssertionError(f"generic flash with a key bias failed: "
                             f"{gen['checks']}")
    for name, res in tc64.items():
        if not all(res["checks"].values()):
            raise AssertionError(f"tensor-core flash at head_dim 64 "
                                 f"({name}) failed: {res['checks']}")
    del q, k, v, do, args, args64, qr, kr, vr, lib_out, tc64

    Bt, Ht, Hkv, St = TC_BIAS_SHAPE
    sass = flash_sass(bias=True)
    tc = {}
    for causal in (False, True):
        bias_t, lens_t = padding_bias(dev, Bt, St, St // 2, 502 + causal)
        # the pairs this mask leaves: row r sees keys below min(r + 1, len)
        # causal, below len otherwise
        pairs_t = Ht * sum(
            sum(min(r + 1, n) for r in range(St)) if causal else St * n
            for n in lens_t.tolist())
        q, k, v, do = (rand(Bt, Ht, St, 128), rand(Bt, Hkv, St, 128),
                       rand(Bt, Hkv, St, 128), rand(Bt, Ht, St, 128))
        res = bias_case(dev, fa.flash_fwd_cuda, fa.flash_dq_cuda,
                        fa.flash_dkv_cuda, q, k, v, do, bias_t, causal)
        args, kw = res.pop("args"), res.pop("kw")
        res["checks"].update(sass_checks(sass))
        times = {}
        for name, fn in (("flash_fwd", lambda **b: fa.flash_fwd_cuda(
                              q, k, v, **kw, **b)),
                         ("flash_dq", lambda **b: fa.flash_dq_cuda(
                             *args, **kw, **b)),
                         ("flash_dkv", lambda **b: fa.flash_dkv_cuda(
                             *args, **kw, **b))):
            # in turns: without, with, with, without
            t = [cuda_ms(lambda: fn(), 10), cuda_ms(lambda: fn(
                key_bias=bias_t), 10), cuda_ms(lambda: fn(key_bias=bias_t),
                                                10), cuda_ms(lambda: fn(), 10)]
            times[name] = {"no_bias_ms": (t[0] + t[3]) / 2,
                           "bias_ms": (t[1] + t[2]) / 2,
                           "bias_over_no_bias": (t[1] + t[2]) / (t[0] + t[3]),
                           "bound_ms": flash_bound(name, Bt, Ht, Hkv, St,
                                                   causal)[0],
                           "bias_bound_ms": flash_bound(
                               name, Bt, Ht, Hkv, St, causal, key_bias=True,
                               pairs=pairs_t)[0]}
        tc["causal" if causal else "non_causal"] = dict(res, times=times)
        emit(phase="bert_flash_checks", family="tensor cores (csrc/"
             "flash_attn.cu, csrc/flash_bwd.cu)", shape=(
                 f"B={Bt}, H={Ht}, Hkv={Hkv}, S={St}, hd=128, bf16"),
             causal=causal, sass=sass, times=times, **res)
        if not all(res["checks"].values()):
            raise AssertionError(f"tensor-core flash with a key bias "
                                 f"(causal={causal}) failed: {res['checks']}")
        del q, k, v, do, args
    torch.cuda.empty_cache()
    return {"generic": rows, "tensor_cores_hd64": rows64,
            "tensor_cores": tc}


BERT_ARGV = ["--model=base", "--seq=512", f"--pad-min={BERT_PAD_MIN}",
             "--bfp=1", "--mesh.dp=8", "--iters=5"]
BERT_WARMUP = 2


def bert_train_path(dev, kernels) -> dict:
    """BERT-base masked-LM training as the ``train_bert`` driver builds it:
    bucketed ``DDPTrainer`` over 8 virtual ranks, 8 padded sequences of 512
    a rank, the fused BFP ring kernels on every bucket, AdamW on the
    replicated f32 masters; launch counts zeroed just before the first
    warm-up step and read after the last timed one; every rank's replica
    bit-identical after every step; then two more steps under the
    profiler."""
    import torch
    from fpga_ai_nic_tpu_torch import train_bert
    from fpga_ai_nic_tpu_torch.models import bert
    from fpga_ai_nic_tpu_torch.parallel.ddp import replicas_identical
    mcfg, cfg, run = train_bert.parse(BERT_ARGV)
    n = cfg.mesh.dp
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr, state = train_bert.build(mcfg, cfg, run)
    sync(dev)
    init_s = time.perf_counter() - t0
    steps = BERT_WARMUP + cfg.iters
    stream = [(tr.shard_batch(b), valid) for b, valid in
              train_bert.batches(mcfg, cfg, run, steps + 2)]
    n_buckets = len(tr.plan.buckets)
    for k in kernels.values():
        k.launches = 0
    losses, step_ms, identical = [], [], []
    for batch, _ in stream[:steps]:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, loss = tr.step(state, batch)
        end.record()
        identical.append(replicas_identical(state))   # synchronises
        losses.append(float(loss))
        step_ms.append(start.elapsed_time(end))
    launches = {name: k.launches for name, k in kernels.items()}
    # head_dim 64 in bf16: the tensor-core forward, dq and dk/dv, one
    # launch of each a layer and rank, none of the second family's
    per_step = dict({name: 0 for name in kernels},
                    flash_fwd=mcfg.n_layers * n,
                    flash_dq=mcfg.n_layers * n,
                    flash_dkv=mcfg.n_layers * n,
                    ring_rs_update=n_buckets, ring_ag=n_buckets)
    for name, count in launches.items():
        if count != steps * per_step[name]:
            raise AssertionError(f"bert training: {name} launched {count} "
                                 f"times, expected {steps} x "
                                 f"{per_step[name]}")
    timed = step_ms[BERT_WARMUP:]
    t_losses = losses[BERT_WARMUP:]
    checks = {"finite": all(math.isfinite(v) for v in losses),
              "loss_falls": t_losses[-1] < t_losses[0],
              "replicas_identical_every_step": all(identical)}
    valid = sum(v for _, v in stream[BERT_WARMUP:steps])
    tokens = cfg.iters * cfg.global_batch * run.seq
    wall = sum(timed) / 1e3
    emit(phase="bert_train_path", model=(
        f"BERT-base (vocab {mcfg.vocab}, dim {mcfg.dim}, {mcfg.n_layers} "
        f"layers, {mcfg.n_heads} heads, head_dim {mcfg.head_dim}, ffn "
        f"{mcfg.ffn_dim}, {mcfg.dtype}, attn_impl {mcfg.attn_impl}), "
        "random weights"), params=bert.num_params(mcfg), seq=run.seq,
         pad_min=run.pad_min, global_batch=cfg.global_batch, dp=n,
         trainer=run.trainer, collective=str(cfg.collective),
         optimizer=str(cfg.optimizer), n_buckets=n_buckets,
         bucket_padded_lens=[b.padded_len for b in tr.plan.buckets],
         weight_init_s=init_s, warmup_steps=BERT_WARMUP, steps=cfg.iters,
         step_ms=step_ms, median_step_ms=sorted(timed)[len(timed) // 2],
         tokens_per_sec=tokens / wall, valid_tokens_per_sec=valid / wall,
         valid_token_share=valid / tokens, losses=losses,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         launches=launches, launches_per_step=per_step, checks=checks,
         obs_static=tr.obs_static_metrics())
    if not all(checks.values()):
        raise AssertionError(f"bert training failed: {checks}")
    held = [state]
    del state
    extra = iter(stream[steps:])

    def train_step():
        held[0], _ = tr.step(held[0], next(extra)[0])

    profile_run("bert_train_profile", train_step, HOST_HEAVY_PROFILE_STEPS,
                groups=TRAIN_GROUPS)
    del tr, held, stream
    torch.cuda.empty_cache()
    return {"launches": launches, "mcfg": mcfg, "cfg": cfg, "run": run}


def bert_train_parity(dev, run) -> None:
    """``bert.loss_fn``'s gradients on one rank's padded batch at BERT-base
    width and 2 layers, through the flash kernels (attn_impl="pallas":
    the key-bias channel of the tensor-core forward, dq and dk/dv at
    head_dim 64) and the plain softmax route
    ("xla"), compared as one flat vector; and the kernels with a zero bias
    (the padding mask dropped), which must exceed the limit."""
    import dataclasses
    import torch
    from fpga_ai_nic_tpu_torch import train_bert
    from fpga_ai_nic_tpu_torch.models import bert
    from fpga_ai_nic_tpu_torch.ops import fused_update
    mcfg = dataclasses.replace(run["mcfg"], n_layers=2)
    cfg, r = run["cfg"], run["run"]
    params = bert.init(torch.Generator(device=dev).manual_seed(cfg.seed),
                       mcfg, dev)
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(params)]
    (toks, labels, _), _ = next(train_bert.batches(mcfg, cfg, r, 1))
    per = cfg.global_batch // cfg.mesh.dp
    batch = (toks[:per].to(dev), labels[:per].to(dev))

    def grads(impl, zero_bias=False):
        c = dataclasses.replace(mcfg, attn_impl=impl)
        orig = bert.flash_attention

        def unmasked(q, k, v, *, key_bias, **kw):
            return orig(q, k, v, key_bias=torch.zeros_like(key_bias), **kw)
        if zero_bias:
            bert.flash_attention = unmasked
        try:
            loss = bert.loss_fn(params, batch, c)
            return float(loss.detach()), torch.autograd.grad(loss, leaves)
        finally:
            bert.flash_attention = orig

    def dist(ga, gb):
        return math.sqrt(sum(float((a.float() - b.float()).square().sum())
                             for a, b in zip(ga, gb)))

    l_k, g_k = grads("pallas")
    l_p, g_p = grads("xla")
    norm = math.sqrt(sum(float(g.float().square().sum()) for g in g_p))
    rel = dist(g_k, g_p) / norm
    del g_k
    l_c, g_c = grads("pallas", zero_bias=True)
    rel_c = dist(g_c, g_p) / norm
    checks = {"finite": all(math.isfinite(v) for v in (l_k, l_p, rel)),
              "grad_within_tol": rel <= PARITY_GRAD_REL_TOL,
              "loss_within_tol": abs(l_k - l_p) <= PARITY_LOSS_TOL,
              "control_above_tol": rel_c > PARITY_GRAD_REL_TOL}
    emit(phase="bert_train_parity", layers=mcfg.n_layers, seq=r.seq,
         batch_rows=per, loss_kernel=l_k, loss_plain=l_p,
         loss_diff=abs(l_k - l_p), loss_tol=PARITY_LOSS_TOL,
         grad_rel_err=rel, grad_tol=PARITY_GRAD_REL_TOL,
         grad_norm_plain=norm, control="kernels with a zero key bias",
         control_loss=l_c, control_grad_rel_err=rel_c, checks=checks)
    del params, leaves, g_p, g_c
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"bert training parity failed: {checks}")


RESNET_ARGV = ["--model=resnet50", "--image-size=224", "--mesh.dp=8",
               "--global_batch=256", "--bfp=1",
               "--collective.fused_optimizer=true",
               "--optimizer.kind=momentum", "--optimizer.learning_rate=0.1",
               "--optimizer.momentum=0.9", "--optimizer.weight_decay=1e-4",
               "--iters=5"]
RESNET_WARMUP = 2          # cuDNN picks its algorithms on the first calls
RESNET_LOADER_ITERS = 3
RESNET_PARITY_BATCH = 64   # cut from 256: three graphs of it are held
RESNET_GROUPS = {"ring": ("ring_rs_kernel", "ring_ag_kernel"),
                 "port_other": tuple(k for k in PORT_KERNELS if k not in (
                     "ring_rs_kernel", "ring_ag_kernel"))}
# by the aten op that launched a kernel: cuDNN's convolutions (forward,
# data and weight gradients; their GEMM-named kernels too) and the fc GEMM
RESNET_OP_GROUPS = {"conv": ("convolution",), "fc_gemm": ("aten::mm",
                                                          "aten::addmm")}


def resnet_ring_times(dev, tr, state, g, new, ccfg) -> dict:
    """ring_rs_update (momentum) and ring_ag at the ResNet path's shape
    (n=8, 3,194,880 f32 a rank) on the path's own gradients and shards:
    device time, whole calls, the plain versions and the bounds.  These
    launches come after the path's counts were read."""
    from fpga_ai_nic_tpu_torch import optim
    from fpga_ai_nic_tpu_torch.ops import ring_cuda
    n, L = g.shape
    C = L // n
    h = optim.fused_hyperparams(tr.cfg.optimizer, state.step, device=dev)

    def rs():
        return ring_cuda.ring_reduce_scatter_update_fused(
            g, state.w_own, state.opt_state, h, opt_kind="momentum",
            compression=ccfg)

    def ag():
        return ring_cuda.ring_all_gather_fused(new.w_own, compression=ccfg)
    rs_b, ag_b = ring_bytes(n, L, C, opt_shards=2)     # w and m
    out = {"shape": f"n={n}, L={L} (C={C} f32 a rank), momentum + wd",
           "rs_device_ms": device_ms(rs, 10, ("ring_rs_kernel",)),
           "rs_call_ms": cuda_ms(rs, 10),
           "rs_plain_ms": cuda_ms(
               lambda: ring_cuda.ring_reduce_scatter_update_plain(
                   g, state.w_own, state.opt_state, h, opt_kind="momentum",
                   compression=ccfg), 2),
           "rs_bound": bound(rs_b, 11 * n * L + 7 * n * C),
           "ag_device_ms": device_ms(ag, 10, ("ring_ag_kernel",)),
           "ag_call_ms": cuda_ms(ag, 10),
           "ag_plain_ms": cuda_ms(lambda: ring_cuda.ring_all_gather_plain(
               new.w_own, ccfg), 2),
           "ag_bound": bound(ag_b, 10 * n * C)}
    emit(phase="resnet_ring_times", **out)
    return out


def resnet_train_path(dev, kernels) -> dict:
    """ResNet-50 data-parallel training as the ``train_resnet`` driver
    builds it: ``DPTrainer`` with sync-BN over 8 virtual ranks (one graph
    for all ranks), 32 images of 224x224 a rank, the fused BFP ring
    kernels with the fused momentum SGD; 2 warm-up and 5 timed steps on
    one batch of train_resnet's stream already on the card, launch counts
    zeroed just before the first and read after the last; every rank's
    replica bit-equal after every step and a falling loss; one more step
    whose gradients also go through the plain collectives (masters and
    momentum shards bit-equal); the ring kernels timed at this shape; a
    profile of two steps; then ``train_resnet.main``, its loader drawing the
    stream on the host."""
    import torch
    from fpga_ai_nic_tpu_torch import optim, train_resnet
    from fpga_ai_nic_tpu_torch.models import resnet
    from fpga_ai_nic_tpu_torch.ops import ring_cuda
    mcfg, cfg, size, device = train_resnet.parse(RESNET_ARGV)
    n = cfg.mesh.dp
    ccfg = cfg.collective.compression
    held_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr, state = train_resnet.build(mcfg, cfg, device)
    sync(dev)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (host,) = list(train_resnet.batches(mcfg, cfg, size, 1))
    host_batch_s = time.perf_counter() - t0
    batch = tr.shard_batch(host)
    del host
    steps = RESNET_WARMUP + cfg.iters
    for k in kernels.values():
        k.launches = 0
    losses, step_ms, identical = [], [], []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, loss = tr.step(state, batch)
        end.record()
        reps = state.replicas
        identical.append(bool((reps == reps[0]).all()))    # synchronises
        losses.append(float(loss))
        step_ms.append(start.elapsed_time(end))
    del reps
    launches = {name: k.launches for name, k in kernels.items()}
    per_step = dict({name: 0 for name in kernels}, ring_rs_update=1,
                    ring_ag=1)
    for name, count in launches.items():
        if count != steps * per_step[name]:
            raise AssertionError(f"resnet training: {name} launched {count} "
                                 f"times, expected {steps} x "
                                 f"{per_step[name]}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    timed = step_ms[RESNET_WARMUP:]
    checks = {"finite": all(math.isfinite(v) for v in losses),
              "loss_falls": losses[-1] < losses[0],
              "replicas_identical_every_step": all(identical)}
    emit(phase="resnet_train_path", model=(
        f"ResNet-50 (stages {list(mcfg.stage_sizes)}, width {mcfg.width}, "
        f"{mcfg.num_classes} classes, {mcfg.dtype}), random weights (seed "
        f"{cfg.seed})"), params=resnet.num_params(mcfg),
         padded_len=state.replicas.shape[1],
         chunk_per_rank=state.w_own.shape[1], image_size=size,
         global_batch=cfg.global_batch, dp=n, trainer="DPTrainer, sync-BN "
         "over the ranks (joint_grads)", collective=str(cfg.collective),
         optimizer=str(cfg.optimizer), weight_init_s=init_s,
         host_batch_s=host_batch_s, held_before_gb=held_before / 1e9,
         warmup_steps=RESNET_WARMUP, steps=cfg.iters, step_ms=step_ms,
         median_step_ms=sorted(timed)[len(timed) // 2],
         samples_per_sec=cfg.iters * cfg.global_batch / (sum(timed) / 1e3),
         losses=losses, peak_mem_gb=peak, launches=launches,
         launches_per_step=per_step, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"resnet training failed: {checks}")

    # one more step: the same gradients through the kernels and the plain
    # collectives
    g, _ = tr.grads(state, batch)
    new = tr.apply_grads(state, g)
    h = optim.fused_hyperparams(cfg.optimizer, state.step, device=dev)
    _, w_plain, st_plain = ring_cuda.ring_reduce_scatter_update_plain(
        g, state.w_own, state.opt_state, h, opt_kind="momentum",
        compression=ccfg)
    require_equal("resnet masters and momentum", [
        (new.w_own, w_plain), (new.opt_state["m"], st_plain["m"])])
    rep_plain = ring_cuda.ring_all_gather_plain(w_plain, ccfg)
    require_equal("resnet replicas", [
        (new.replicas, rep_plain.to(new.replicas.dtype))])
    emit(phase="resnet_plain_step", masters_bitequal=True,
         momentum_bitequal=True, replicas_bitequal=True)
    del w_plain, st_plain, rep_plain
    ring = resnet_ring_times(dev, tr, state, g, new, ccfg)
    del g, state
    held = [new]
    del new

    def train_step():
        held[0], _ = tr.step(held[0], batch)

    prof = profile_run("resnet_train_profile", train_step,
                       HOST_HEAVY_PROFILE_STEPS, groups=RESNET_GROUPS,
                       op_groups=RESNET_OP_GROUPS)
    del tr, held, batch
    torch.cuda.empty_cache()
    # train_resnet as a user runs it: the loader draws each batch on the
    # host and copies it from pinned memory
    out = train_resnet.main(
        [a for a in RESNET_ARGV if not a.startswith("--iters=")]
        + [f"--iters={RESNET_LOADER_ITERS}"])
    emit(phase="resnet_driver_loader", **out)
    torch.cuda.empty_cache()
    return {"launches": launches, "ring": ring, "profile": prof,
            "steps": steps}


# The parity phase runs in f32 (cuDNN's TF32 off): this random-init
# ResNet-50's gradient is ill-conditioned, so the same function summed in
# another order (the batch permuted: the phase's floor) moves it by a few
# percent in f32, and in bf16 by about as much as dropping sync-BN does
# (the phase reports the bf16 numbers beside).
RESNET_PARITY_GRAD_REL_TOL = 0.1
RESNET_PARITY_LOSS_TOL = PARITY_LOSS_TOL


def resnet_parity_case(dev, mcfg, reps, meta, x, y, n) -> dict:
    """One dtype's comparisons at ResNet-50 width: the joint graph's
    gradients summed over the ranks over n (``joint``), the one-replica
    gradient of the batch permuted (``floor``: the same function in
    another summation order) and the per-rank moments (``control``), each
    as ``|g - g_one| / |g_one|`` over the flat vector, with the losses."""
    import torch
    from fpga_ai_nic_tpu_torch.models import resnet
    from fpga_ai_nic_tpu_torch.parallel.train import (joint_grads,
                                                      per_rank_grads)
    B = x.shape[0]
    split = (x.reshape(n, B // n, *x.shape[1:]), y.reshape(n, B // n))

    def one_replica_loss(p, b):
        return resnet.loss_fn(p, b, mcfg)

    g_1, l_1 = per_rank_grads(one_replica_loss, reps[:1], meta,
                              (x[None], y[None]))
    g_1 = g_1[0]
    norm = float(g_1.norm())
    out = {"dtype": mcfg.dtype, "loss_one_replica": float(l_1),
           "grad_norm_one_replica": norm}
    perm = torch.arange(B - 1, -1, -1, device=x.device)
    for name, fn, batch, reduce in (
            ("joint", joint_grads, split, True),
            ("floor", per_rank_grads, (x[perm][None], y[perm][None]), False),
            ("control", per_rank_grads, split, True)):
        loss_fn = (resnet.dp_loss_fn(mcfg) if name == "joint"
                   else one_replica_loss)
        g, loss = fn(loss_fn, reps if reduce else reps[:1], meta, batch)
        g = g.sum(0) / n if reduce else g[0]
        out[name + "_grad_rel_err"] = float((g - g_1).norm()) / norm
        out[name + "_loss"] = float(loss)
        del g
    torch.cuda.empty_cache()
    return out


def resnet_train_parity(dev) -> None:
    """Sync-BN at ResNet-50 width on the card: the joint graph's
    gradients over 8 ranks of 8 images, summed over the ranks and divided
    by n, against ``loss_fn`` on the whole batch of 64 through one replica
    (JAX's ``test_sync_bn_matches_single_device`` invariant), compared as
    one flat vector, in f32 within RESNET_PARITY_GRAD_REL_TOL; the same
    split with every rank's own moments (nothing pooled) must exceed it.
    The floor (the batch permuted) and the bf16 model's numbers are
    reported beside them."""
    import dataclasses
    import numpy as np
    import torch
    from fpga_ai_nic_tpu_torch import train_resnet
    from fpga_ai_nic_tpu_torch.models import resnet
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig
    mcfg, cfg, size, _ = train_resnet.parse(RESNET_ARGV)
    n, B = cfg.mesh.dp, RESNET_PARITY_BATCH
    x, y = train_resnet.make_batch(np.random.default_rng(cfg.seed), mcfg,
                                   B, size)
    cases = {}
    for dt in ("float32", mcfg.dtype):
        c = dataclasses.replace(mcfg, dtype=dt)
        params = resnet.init(
            torch.Generator(device=dev).manual_seed(cfg.seed), c, dev)
        meta = fused_update.flat_meta(params, CollectiveConfig(), n)
        reps = fused_update.flatten_tree(params, meta).to(
            c.torch_dtype).reshape(1, -1).expand(n, -1)
        del params
        cases[dt] = resnet_parity_case(dev, c, reps, meta,
                                       x.to(dev, c.torch_dtype), y.to(dev), n)
        del reps
    f32 = cases["float32"]
    rel, rel_c = f32["joint_grad_rel_err"], f32["control_grad_rel_err"]
    l_diff = abs(f32["joint_loss"] - f32["loss_one_replica"])
    checks = {"finite": all(math.isfinite(v) for v in f32.values()
                            if isinstance(v, float)),
              "grad_within_tol": rel <= RESNET_PARITY_GRAD_REL_TOL,
              "loss_within_tol": l_diff <= RESNET_PARITY_LOSS_TOL,
              "control_above_tol": rel_c > RESNET_PARITY_GRAD_REL_TOL}
    emit(phase="resnet_train_parity", batch=B, dp=n, image_size=size,
         cut=f"global batch {cfg.global_batch} -> {B} ({B // n} a rank)",
         checked="float32 (cuDNN TF32 off)",
         grad_tol=RESNET_PARITY_GRAD_REL_TOL,
         loss_tol=RESNET_PARITY_LOSS_TOL, loss_diff=l_diff,
         control="per-rank moments (nothing pooled)",
         floor="one replica, the batch permuted", cases=cases,
         checks=checks)
    del x, y
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"resnet training parity failed: {checks}")


# -- Mixtral-8x7B width: MoE training over dp x ep, its parity, MoE serving ---

MOE_MODEL_ARGV = ["--model=llama3_8b", "--model.vocab=32000",
                  "--model.rope_theta=1000000", "--model.moe_experts=8"]
MOE_TRAIN_ARGV = MOE_MODEL_ARGV + [
    "--model.n_layers=1", "--model.attn_block=512", "--model.attn_impl=auto",
    "--seq=4096", "--global_batch=4", "--mesh.dp=2", "--mesh.ep=2",
    "--iters=5", "--collective.impl=ring",
    "--collective.compression.codec=pallas",
    "--collective.fused_kernel=true", "--optimizer.kind=sgd",
    "--optimizer.learning_rate=0.1"]
MOE_SP_TRAIN_ARGV = MOE_MODEL_ARGV + [
    "--model.n_layers=1", "--model.attn_block=512", "--model.attn_impl=auto",
    "--seq=8192", "--global_batch=4", "--mesh.dp=2", "--mesh.sp=2",
    "--mesh.ep=2", "--remat=true", "--optimizer.clip_norm=1.0",
    "--iters=5", "--collective.impl=ring",
    "--collective.compression.codec=pallas",
    "--collective.fused_kernel=true", "--optimizer.kind=sgd",
    "--optimizer.learning_rate=0.1"]
MOE_SERVE_LAYERS = 8
# the aten ops of routing, dispatch and combine (the token embedding's
# gather and its backward are aten::index ops too: about 4 x 16 MB a step)
MOE_DISPATCH_OPS = ("aten::index", "aten::sort", "aten::cumsum",
                    "aten::one_hot", "aten::repeat_interleave")
MOE_OP_GROUPS = {"expert_gemm": ("aten::bmm",),
                 "dispatch_combine": MOE_DISPATCH_OPS}


class pinned_routing:
    """Within the block, ``ops.moe._route`` appends each call's routing
    to ``record``; with ``pin`` (another run's records, in call order) it
    takes that run's experts instead, reshaped to this call's source
    devices (the same tokens in the same order: a run over sp shards
    takes a run without sp's, source (e, s) the shard s of source e), the
    capacity assignment redone at this call's capacity, and gates from
    this run's router probabilities at those experts."""

    def __init__(self, moe, record, pin=None):
        self.moe, self.record = moe, record
        self.pin = None if pin is None else iter(pin)

    def __enter__(self):
        moe, orig = self.moe, self.moe._route
        self.orig = orig

        def route(wr, xf, cfg, C):
            r = orig(wr, xf, cfg, C)
            if self.pin is not None:
                e_flat = next(self.pin).e_flat.reshape(r.e_flat.shape)
                g = r.probs.gather(-1, e_flat.reshape(r.gates.shape))
                r = moe.Routing(g / g.sum(-1, keepdim=True), e_flat,
                                *moe.assign(e_flat, cfg.num_experts, C),
                                r.probs)
            self.record.append(r._replace(gates=None, probs=None))
            return r
        moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig


def flip_share(a, b, tokens=None) -> float:
    """Share of (token, k) assignments whose expert differs between two
    runs' routing records (each run's calls in order, ranks in order);
    ``tokens`` (bool, a call's tokens) counts only those tokens'."""
    import torch

    def experts(run):
        out = []
        for r in run:
            e = r.e_flat
            if tokens is not None:
                e = e[:, tokens.reshape(-1).repeat_interleave(
                    e.shape[1] // tokens.numel()).to(e.device)]
            out.append(e.reshape(-1))
        return torch.cat(out)
    ea, eb = experts(a), experts(b)
    return int((ea != eb).sum()) / ea.numel()


def moe_train_path(dev, kernels, argv=MOE_TRAIN_ARGV,
                   phase="moe_train_path") -> dict:
    """``ShardedTrainer`` at Mixtral-8x7B width (1 layer) as
    ``train_llama.build`` builds it from ``argv``: over dp=2 x ep=2
    (``MOE_TRAIN_ARGV``), or dp=2 x sp=2 x ep=2 with remat and a clip
    (``MOE_SP_TRAIN_ARGV``, the phase ``moe_sp_train_path``).  One warm-up
    (its routing statistics kept, the recomputation's checked equal to
    the forward's, and the pre-clip global norm) and ``--iters`` timed
    steps on one batch, launch counts zeroed just before the first step
    and read after the last (a step: per (dp, ep) rank and layer, the
    flash kernels as ``llama_sp_train_path`` counts them at this sp, the
    forwards twice with remat; one ring reduce-scatter and one
    all-gather an ep group); the replicas bit-equal within each ep group
    and their replicated leaves across the groups, the router held apart
    in f32; without sp, the ring kernels timed at this shape on the
    path's own gradient rows; then two steps under the profiler."""
    import torch
    from fpga_ai_nic_tpu_torch import optim, train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import fused_update, moe
    mcfg, cfg, seq, device = train_llama.parse(argv)
    remat = train_llama.remat_flag(argv)
    n, ep, sp = cfg.mesh.dp, cfg.mesh.ep, cfg.mesh.sp
    clip = cfg.optimizer.clip_norm
    # an earlier phase's reference cycles (the serving engine and the
    # closures wrapping its steps) may still hold its weights
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr, state = train_llama.build(mcfg, cfg, device, remat)
    sync(dev)
    init_s = time.perf_counter() - t0
    batch = tr.shard_batch(next(train_llama.batches(mcfg, cfg, seq, 1)))
    parts, routes, norms = [], [], []
    ranks_fn, route_fn = moe.moe_ranks, moe._route
    clip_fn = optim.clip_by_global_norm

    def keep_parts(*a):
        y, p = ranks_fn(*a)
        parts.append(p._replace(psum_p=p.psum_p.detach()))
        return y, p

    def keep_route(*a):
        r = route_fn(*a)
        routes.append(r._replace(gates=None, probs=None))
        return r

    def keep_norm(c, g, weights=None):
        if c.clip_norm is not None:
            norms.append(float(optim.global_norm(g, weights)))
        return clip_fn(c, g, weights)
    for kern in kernels.values():
        kern.launches = 0
    moe.moe_ranks, moe._route = keep_parts, keep_route
    optim.clip_by_global_norm = keep_norm
    try:
        state, loss = tr.step(state, batch)           # warm-up
    finally:
        moe.moe_ranks, moe._route = ranks_fn, route_fn
        optim.clip_by_global_norm = clip_fn
    n_fwd = mcfg.n_layers * n         # one moe_ranks call a layer and group
    stats = moe._stats_from_routing(moe.pool(parts[:n_fwd]),
                                    mcfg.moe.top_k)
    # the backward recomputes the last layer first, its groups in order
    # (and stops once the saved tensors are back: after the last
    # group's routing, before its statistics)
    rec = [r for i in reversed(range(mcfg.n_layers))
           for r in routes[n_fwd + i * n:n_fwd + (i + 1) * n]]
    losses = [float(loss)]
    sync(dev)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(cfg.iters + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for mark in marks[1:]:
        state, loss = tr.step(state, batch)
        losses.append(loss)
        mark.record()
    sync(dev)
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [float(v) for v in losses]
    launches = {name: kern.launches for name, kern in kernels.items()}
    steps = cfg.iters + 1
    per_step = {name: 0 for name in kernels}
    ranks = mcfg.n_layers * n * ep
    diag, past = ranks * sp, ranks * sp * (sp - 1) // 2
    fwd = 2 if remat else 1
    per_step.update(flash_fwd=fwd * diag, flash_dq=diag, flash_dkv=diag,
                    ring_rs_update=tr.n_shards, ring_ag=tr.n_shards)
    if past:
        per_step.update(flash_fwd_offsets=fwd * past, flash_dq_offsets=past,
                        flash_dkv_offsets=past)
    for name, count in launches.items():
        if count != steps * per_step[name]:
            raise AssertionError(f"{phase}: {name} launched {count} "
                                 f"times, expected {steps} x "
                                 f"{per_step[name]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss on the repeated "
                             f"batch did not fall {losses}")
    reps = state.replicas.view(tr.n_shards, n, -1)
    masters = state.w_own.view(tr.n_shards, -1)
    checks = {
        "replicas_equal_within_ep_groups": bool((reps == reps[:, :1]).all()),
        "replicated_leaves_equal_across_ep_groups": all(
            bool((reps[:, :, a:b] == reps[:1, :, a:b]).all())
            and bool((masters[:, a:b] == masters[:1, a:b]).all())
            for a, b in tr._rep_spans),
        "expert_shards_differ": not bool((masters[0] == masters[1]).all()),
        "replicas_in_model_dtype": state.replicas.dtype == mcfg.torch_dtype,
        "router_held_apart_f32": (state.side is not None
                                  and state.side.dtype == torch.float32)}
    if remat:
        checks["recomputed_routing_equal"] = len(rec) == n_fwd and all(
            torch.equal(getattr(a, f), getattr(b, f))
            for a, b in zip(routes[:n_fwd], rec)
            for f in ("e_flat", "keep", "slot"))
    if clip is not None:
        checks["pre_clip_norm_finite"] = len(norms) == 1 and math.isfinite(
            norms[0])
    tokens = cfg.iters * cfg.global_batch * seq
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    median = sorted(step_ms)[cfg.iters // 2]
    emit(phase=phase, model=(
        f"Mixtral-8x7B width (dim {mcfg.dim}, {mcfg.n_heads}/"
        f"{mcfg.n_kv_heads} heads, ffn {mcfg.ffn_dim}, vocab {mcfg.vocab}, "
        f"rope_theta {mcfg.rope_theta}, {mcfg.moe_experts} experts top-"
        f"{mcfg.moe_top_k}, capacity factor {mcfg.moe_capacity_factor}, "
        f"aux weight {mcfg.moe_aux_weight}, {mcfg.dtype}), "
        f"{mcfg.n_layers} layer, attn_block {mcfg.attn_block}, random "
        "weights"), params=llama.num_params(mcfg),
         active_params=llama.active_params(mcfg), seq=seq,
         global_batch=cfg.global_batch, dp=n, sp=sp, ep=ep, tp=cfg.mesh.tp,
         remat=remat, held_at_start_gb=held_gb,
         tokens_per_step=cfg.global_batch * seq,
         tokens_per_device=cfg.global_batch * seq // (n * sp * ep),
         collective=str(cfg.collective), optimizer=str(cfg.optimizer),
         weight_init_s=init_s, steps=cfg.iters, wall_s=wall,
         ms_per_step=1e3 * wall / cfg.iters, step_ms=step_ms,
         median_step_ms=median, tokens_per_sec=tokens / wall, losses=losses,
         peak_mem_gb=peak, padded_len_per_row=int(state.replicas.shape[1]),
         launches=launches, launches_per_step=per_step,
         expert_stats_warmup={k: v.tolist() for k, v in stats.items()},
         pre_clip_norm_warmup=norms[0] if norms else None, clip_norm=clip,
         clip_bound_warmup=(norms[0] > clip) if norms else None,
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"{phase}: {checks}")
    flat_g, _ = tr.grads(state, batch)
    out = {"launches": launches, "mcfg": mcfg, "cfg": cfg, "seq": seq,
           "steps": steps, "median_step_ms": median, "peak_mem_gb": peak,
           "tokens_per_sec": tokens / wall, "stats": stats}
    if clip is not None:        # the norm the next step would clip
        norm = float(optim.global_norm(tr._reduce(flat_g),
                                       tr.norm_weight_tables()))
        out["pre_clip_norm"] = {"warmup": norms[0], "final_state": norm}
        emit(phase=phase + "_clip", clip_norm=clip,
             pre_clip_norm=out["pre_clip_norm"],
             bound={"warmup": norms[0] > clip, "final_state": norm > clip})
    if sp == 1:
        g, w = flat_g[:n], state.w_own[:n]
        L = g.shape[1]
        C = L // n

        def rs():
            return fused_update.reduce_scatter(g, cfg.collective)

        def ag():
            return fused_update.all_gather_flat(w, cfg.collective)
        rs_b, ag_b = ring_bytes(n, L, C)
        out["ring"] = {
            "shape": f"n={n}, L={L} (one (tp, ep) group's rows), no "
                     "optimizer",
            "rs_device_ms": device_ms(rs, 5, ("ring_rs_kernel",)),
            "rs_bound": bound(rs_b, 11 * n * L),
            "ag_device_ms": device_ms(ag, 5, ("ring_ag_kernel",)),
            "ag_bound": bound(ag_b, 10 * n * C)}
        emit(phase=phase.replace("path", "ring_times"), **out["ring"])
        del g, w
    del flat_g, reps, masters
    held = [state]
    del state

    def train_step():
        held[0], _ = tr.step(held[0], batch)

    prof = profile_run(phase.replace("path", "profile"), train_step, 2,
                       groups=SP_GROUPS if sp > 1 else TRAIN_GROUPS,
                       op_groups=MOE_OP_GROUPS)
    out["profile"] = prof
    out["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
    emit(phase=phase + "_summary", median_step_ms=median,
         tokens_per_sec=tokens / wall, peak_mem_gb=peak,
         idle_share=out["idle_share"],
         drop_frac=float(stats["drop_frac"]),
         load_frac=stats["load_frac"].tolist(),
         pre_clip_norm=out.get("pre_clip_norm"), launches=launches)
    del tr, held, batch
    torch.cuda.empty_cache()
    return out


def _moe_grads(params, leaves, batch, mcfg, seq, impl, n_dp, record,
               pin=None, swap=False, tp=1):
    """The MoE loss's gradients of the whole tree on ``batch`` (two
    sequences) over n_dp x n_ep ranks (``n_ep = 2 // n_dp``; with ``tp``,
    each (dp, ep) rank's tp ranks, the experts' hidden split over them):
    expert shards through views of ``params``' leaves, replicated leaves
    summed over the ranks by autograd; ``(mean loss, gradients / n_dp)``.
    Routing recorded in ``record``, taken from ``pin`` when given;
    ``swap``: the ep exchange's destination ranks swapped."""
    import dataclasses
    import torch
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import moe
    from fpga_ai_nic_tpu_torch.parallel.sharded import split_ep
    c = dataclasses.replace(mcfg, attn_impl=impl)
    n_ep = 2 // n_dp
    if tp > 1:
        shards = split_ep(params, llama.param_specs(c, "tp", "ep", tp),
                          {"tp": tp, "ep": n_ep})
        trees = [[shards[t * n_ep + e] for e in range(n_ep)
                  for _ in range(n_dp)] for t in range(tp)]
    else:
        trees = (split_ep(params, llama.param_specs(c), n_ep) if n_ep > 1
                 else [params] * n_dp)
    ranks_fn = llama.moe_ops.moe_ranks
    if swap:
        llama.moe_ops.moe_ranks = (
            lambda wr, shards, x, mc, *tp_: ranks_fn(
                wr, list(shards)[::-1], x, mc, *tp_))
    try:
        with pinned_routing(moe, record, pin):
            losses = llama.dp_loss_fn(
                c, n_dp, n_ep, tp_axis="tp" if tp > 1 else None)(
                trees, tuple(b.reshape(n_dp, n_ep, 1, seq) for b in batch))
            gs = torch.autograd.grad(losses.sum(), leaves)
    finally:
        llama.moe_ops.moe_ranks = ranks_fn
    return float(losses.detach().mean()), [g / n_dp for g in gs]


def _grad_dist(ga, gb) -> float:
    return math.sqrt(sum(float((a.float() - b.float()).square().sum())
                         for a, b in zip(ga, gb)))


def moe_train_parity(dev, run, phase="moe_train_parity") -> None:
    """The MoE loss's gradients at the path's widths, 1 layer, one
    sequence on each of ep=2 ranks (the whole tree's gradient: experts
    through their shards' views, replicated leaves summed over the
    ranks): the kernel route against the plain attention route (its
    expert choices pinned to the kernel route's, the unpinned error and
    the flip share reported) and against dp=2 x ep=1 (every rank all the
    experts, gradient over n_dp), within the Llama parity limits; the ep
    exchange with its destination ranks swapped (the fault control) must
    exceed them.  ``phase="moe_tp_train_parity"``: the same at tp=2 (each
    expert's hidden split over the tp ranks, on the kernels) against the
    tp=1 kernel route, its experts pinned to that route's, the unpinned
    error and flip share beside."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import fused_update
    mcfg, cfg, seq = run["mcfg"], run["cfg"], run["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = llama.init(gen, mcfg, dev)
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(params)]
    toks, labels = next(train_llama.batches(mcfg, cfg, seq, 1))
    batch = tuple(t[:2].to(dev) for t in (toks, labels))

    def grads(*args, **kw):
        return _moe_grads(params, leaves, batch, mcfg, seq, *args, **kw)

    rk = []
    l_k, g_k = grads("pallas", 1, rk)
    norm = math.sqrt(sum(float(g.float().square().sum()) for g in g_k))
    res = {}
    if phase == "moe_tp_train_parity":
        cases = (("tp2_pinned", ("pallas", 1, [], rk), {"tp": 2}),
                 ("tp2_unpinned", ("pallas", 1, []), {"tp": 2}),
                 ("control_exchange_swapped", ("pallas", 1, [], rk),
                  {"tp": 2, "swap": True}))
    else:
        cases = (("plain_attention_pinned", ("xla", 1, [], rk), {}),
                 ("plain_attention_unpinned", ("xla", 1, []), {}),
                 ("dp2_ep1", ("pallas", 2, []), {}),
                 ("control_exchange_swapped",
                  ("pallas", 1, [], None, True), {}))
    for name, args, kw in cases:
        l_o, g_o = grads(*args, **kw)
        res[name] = {"loss": l_o, "loss_diff": abs(l_k - l_o),
                     "grad_rel_err": _grad_dist(g_k, g_o) / norm,
                     "routing_flip_share": flip_share(rk, args[2])}
        del g_o
        torch.cuda.empty_cache()
    ctrl = res.pop("control_exchange_swapped")
    unpinned = res.pop(next(k for k in res if k.endswith("_unpinned")))
    checks = {"finite": all(math.isfinite(v) for v in (l_k, norm)),
              **{f"{k}_grad_within_tol": r["grad_rel_err"]
                 <= PARITY_GRAD_REL_TOL for k, r in res.items()},
              **{f"{k}_loss_within_tol": r["loss_diff"] <= PARITY_LOSS_TOL
                 for k, r in res.items()},
              "control_above_tol": ctrl["grad_rel_err"] > PARITY_GRAD_REL_TOL}
    emit(phase=phase, seq=seq, layers=mcfg.n_layers,
         ranks="ep=2, one sequence each", loss_kernel=l_k, against=res,
         unpinned=unpinned, control=ctrl, grad_tol=PARITY_GRAD_REL_TOL,
         loss_tol=PARITY_LOSS_TOL, grad_norm=norm,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         checks=checks)
    del params, leaves, g_k
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"{phase} failed: {checks}")


MOE_SP_PARITY_SEQ = 4096      # 2048 tokens a device at sp=2
MOE_SP_PARITY_CF = 4.0        # E / top_k: an expert can take every token
#                               of a device, so nothing drops at sp 1 or 2


def moe_sp_train_parity(dev, run) -> None:
    """The MoE loss's gradients at the sp x ep path's widths, 1 layer,
    sequence ``MOE_SP_PARITY_SEQ``, one sequence on each (dp, ep) rank of
    dp=2 x ep=2, capacity factor ``MOE_SP_PARITY_CF`` (nothing drops,
    ``drop_frac`` reported): dp=2 x sp=2 x ep=2 on the kernel route
    against the plain attention route (the expert choices pinned to the
    kernel route's) and against dp=2 x sp=1 x ep=2 on the same tokens
    (pinned likewise; capacity is per device, but nothing drops), within
    the Llama parity limits; the unpinned errors and flip shares beside
    them; the kernel ring with its hops merged without the lse weights
    (the fault control) must exceed the limit."""
    import dataclasses
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    from fpga_ai_nic_tpu_torch.ops import fused_update, moe
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.sharded import split_ep
    cfg, seq = run["cfg"], MOE_SP_PARITY_SEQ
    n_dp, n_ep = cfg.mesh.dp, cfg.mesh.ep
    mcfg = dataclasses.replace(run["mcfg"],
                               moe_capacity_factor=MOE_SP_PARITY_CF)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = llama.init(gen, mcfg, dev)
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(params)]
    trees = split_ep(params, llama.param_specs(mcfg), n_ep)
    per_rank = [trees[e] for e in range(n_ep) for _ in range(n_dp)]
    whole = tuple(t.to(dev) for t in next(train_llama.batches(
        mcfg, dataclasses.replace(cfg, global_batch=n_dp * n_ep), seq, 1)))

    def grads(impl, n_sp, record, pin=None, merge=None):
        c = dataclasses.replace(mcfg, attn_impl=impl)
        batch = VirtualRanks(n_dp, dev, n_sp, n_ep).shard_batch(whole)
        orig = fa._lse_merge
        if merge is not None:
            fa._lse_merge = merge
        try:
            with pinned_routing(moe, record, pin):
                losses = llama.dp_loss_fn(c, n_dp, n_ep, n_sp=n_sp)(
                    per_rank, batch)
                gs = torch.autograd.grad(losses.sum(), leaves)
        finally:
            fa._lse_merge = orig
        return float(losses.detach().mean()), [g / n_dp for g in gs]

    def dist(ga, gb):
        return math.sqrt(sum(float((a.float() - b.float()).square().sum())
                             for a, b in zip(ga, gb)))

    def drop_frac(record):
        return 1.0 - float(torch.cat([r.keep.reshape(-1) for r in record])
                           .float().mean())

    rk = []
    l_k, g_k = grads("pallas", 2, rk)
    norm = math.sqrt(sum(float(g.float().square().sum()) for g in g_k))
    res = {}
    for name, args in (("plain_attention_pinned", ("xla", 2, [], rk)),
                       ("plain_attention_unpinned", ("xla", 2, [])),
                       ("dp2_sp1_ep2_pinned", ("pallas", 1, [], rk)),
                       ("dp2_sp1_ep2_unpinned", ("pallas", 1, [])),
                       ("control_unweighted_merge",
                        ("pallas", 2, [], rk, _unweighted_merge))):
        l_o, g_o = grads(*args)
        res[name] = {"loss": l_o, "loss_diff": abs(l_k - l_o),
                     "grad_rel_err": dist(g_k, g_o) / norm,
                     "routing_flip_share": flip_share(rk, args[2]),
                     "drop_frac": drop_frac(args[2])}
        del g_o
        torch.cuda.empty_cache()
    ctrl = res.pop("control_unweighted_merge")
    unpinned = {k: res.pop(k) for k in ("plain_attention_unpinned",
                                        "dp2_sp1_ep2_unpinned")}
    checks = {"finite": all(math.isfinite(v) for v in (l_k, norm)),
              "nothing_dropped": drop_frac(rk) == 0.0 and all(
                  r["drop_frac"] == 0.0 for r in res.values()),
              **{f"{k}_grad_within_tol": r["grad_rel_err"]
                 <= PARITY_GRAD_REL_TOL for k, r in res.items()},
              **{f"{k}_loss_within_tol": r["loss_diff"] <= PARITY_LOSS_TOL
                 for k, r in res.items()},
              "control_above_tol": ctrl["grad_rel_err"] > PARITY_GRAD_REL_TOL}
    emit(phase="moe_sp_train_parity", seq=seq, layers=mcfg.n_layers,
         ranks="dp=2 x sp=2 x ep=2, one sequence each (dp, ep) rank",
         capacity_factor=MOE_SP_PARITY_CF, drop_frac=drop_frac(rk),
         loss_kernel=l_k, against=res, unpinned=unpinned, control=ctrl,
         grad_tol=PARITY_GRAD_REL_TOL, loss_tol=PARITY_LOSS_TOL,
         grad_norm=norm,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         checks=checks)
    del params, leaves, trees, per_rank, g_k
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"moe sp training parity failed: {checks}")


def moe_serving_path(dev, kernels) -> dict:
    """``ServeEngine`` at Mixtral-8x7B width, ``MOE_SERVE_LAYERS`` layers
    (random weights from a seed), the serving path's ServeConfig and
    requests; then its parity (routing pinned, see ``serving_parity``)."""
    import torch
    from fpga_ai_nic_tpu_torch import serve_llama
    from fpga_ai_nic_tpu_torch.serve import ServeConfig
    _, _, cfg = serve_llama.parse(MOE_MODEL_ARGV + [
        f"--model.n_layers={MOE_SERVE_LAYERS}"])
    srv = ServeConfig(**SERVE_SHAPE)
    run = serving_path(dev, cfg, srv, kernels, label="moe_")
    if any(k != 0 for name, k in run["launches"].items()
           if name not in ("paged_attend", "row_checksums")):
        raise AssertionError(f"moe serving launched training kernels "
                             f"{run['launches']}")
    calls = run["summary"]["prefill_calls"] + run["summary"]["decode_calls"]
    if run["launches"]["row_checksums"] != 2 * calls:
        raise AssertionError(
            f"moe serving: {run['launches']['row_checksums']} page-checksum "
            f"launches, expected 2 x {calls} steps")
    serving_parity(dev, cfg, srv, run, label="moe_")
    del run["params"], run["snaps"], run["reqs"]
    torch.cuda.empty_cache()
    return run


# -- pipeline parallelism: GPipe, 1F1B and interleaved 1F1B over dp x pp ------

PP_RING_ARGV = ["--collective.impl=ring",
                "--collective.compression.codec=pallas",
                "--collective.fused_kernel=true",
                "--optimizer.kind=sgd", "--optimizer.learning_rate=0.1"]
PP_MODEL_ARGV = ["--model=llama3_8b", "--model.n_layers=4",
                 "--model.attn_block=512", "--model.attn_impl=auto"]
PP_TRAIN_ARGV = PP_MODEL_ARGV + [
    "--seq=4096", "--global_batch=8", "--mesh.dp=2", "--mesh.pp=2",
    "--microbatches=4", "--iters=3"] + PP_RING_ARGV
PP_SCHEDULES = {"gpipe": ["--pp_schedule=gpipe"],
                "1f1b": ["--pp_schedule=1f1b"],
                "1f1b-interleaved": ["--pp_schedule=1f1b-interleaved",
                                     "--virtual_stages=2"]}
# flash forwards a (dp rank, microbatch, layer), remat on as in JAX's
# driver: GPipe's forward and the backward's recomputation of the layer;
# 1F1B's forward unit, its backward unit's stage forward, and that
# forward's layer recomputed in the backward
PP_FWD_PER_UNIT = {"gpipe": 2, "1f1b": 3, "1f1b-interleaved": 3}
PP_PARITY_ARGV = PP_MODEL_ARGV + [    # sequence cut from 2048 (a slow host)
    "--seq=1024", "--global_batch=4", "--mesh.dp=2", "--mesh.pp=2",
    "--microbatches=2", "--iters=2"] + PP_RING_ARGV


def _host(t):
    """A copy of ``t`` in page-locked host memory: a parity reference held
    off the card, copied at the link's rate both ways (``.cpu()`` into
    pageable memory ran at about 2.8 GB/s, 2.7 s a 7.6 GB master vector)."""
    import torch
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _diff(a, b, chunk=1 << 27) -> tuple:
    """``(squared L2 norm of a - b, a == b)`` over chunks (f64 sums), b's
    chunks brought to a's device (a reference held in host memory)."""
    import torch
    a, b = a.reshape(-1), b.reshape(-1)
    tot, equal = 0.0, True
    for i in range(0, a.numel(), chunk):
        d = a[i:i + chunk] - b[i:i + chunk].to(a.device)
        tot += float(d.square().sum(dtype=torch.float64))
        equal = equal and not bool(d.any())
    return tot, equal


def pp_master_leaves(tr, state, layer_of) -> dict:
    """The f32 masters a state holds, as ``{(leaf, model layer or None):
    [views]}``: one view a stage group's copy (views of the flat master
    rows); ``layer_of(s, j)``: the model layer of stage s's j-th stacked
    row (a pp=1 state's list of layers names its own)."""
    meta = tr._meta
    out = {}
    for s, row in enumerate(state.w_own.view(tr.n_shards, -1)):
        off = 0
        for path, shape, size in zip(meta.keys, meta.shapes, meta.sizes):
            leaf = row[off:off + size].view(shape)
            off += size
            if path[0] != "layers":
                out.setdefault((path[0], None), []).append(leaf)
            elif isinstance(path[1], int):             # pp = 1: a list
                out.setdefault((path[2], path[1]), []).append(leaf)
            else:
                for j in range(shape[0]):
                    out.setdefault((path[1], layer_of(s, j)), []).append(
                        leaf[j])
    return out


def llama_pp_train_parity(dev, argv=PP_PARITY_ARGV,
                          phase="llama_pp_train_parity",
                          pp1="pp1_dp2") -> None:
    """Two SGD steps at Llama-3-8B width, 4 layers, sequence 1024, batch 4
    over dp=2 x pp=2, 2 microbatches (``PP_PARITY_ARGV``; or ``argv``:
    ``PP_SP_PARITY_ARGV``, sequence 1024 over dp=2 x pp=2 x sp=2, the
    phase ``llama_pp_sp_train_parity``), each from the same seeded
    weights and batch: GPipe on the kernels is the reference; GPipe on
    the plain attention route (attn_impl xla), 1F1B and interleaved 1F1B
    (v=2) on the kernels (with sp, on the gathered attention), and the
    same mesh at pp=1 (``pp1``), are held against it.  Each compares the
    losses of both steps (within ``PARITY_LOSS_TOL``) and the updated f32 masters of every stage's
    layers and every stage's copy of the replicated leaves, layer by
    model layer (the pp=1 state's whole tree), as the L2 distance over
    the reference's two-step update (within ``PARITY_GRAD_REL_TOL``);
    bit-equality where it holds.  The control: the interleaved masters
    read in plain stage order (the layer permutation dropped) must
    exceed the limit.  The reference masters wait in host memory: on the
    card they would add 11.9 GB to a run's 65.5 GB reduce phase."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.parallel import pipeline

    def layers_of(pipe, pp, L):
        if pipe.schedule == "1f1b-interleaved":
            perm = pipeline._layer_perm(L, pp, pipe.virtual_stages)
            return lambda s, j: perm[s * (L // pp) + j]
        return lambda s, j: s * (L // pp) + j

    def run(extra, steps=2):
        flags = list(argv) + list(extra)
        mcfg, cfg, seq, device = train_llama.parse(flags)
        pipe = train_llama.pipeline_flags(flags)
        gc.collect()
        torch.cuda.empty_cache()
        tr, state = train_llama.build(mcfg, cfg, device, True, pipe)
        batch = tr.shard_batch(next(train_llama.batches(mcfg, cfg, seq, 1)))
        losses = []
        for _ in range(steps):
            state, loss = tr.step(state, batch)
            losses.append(float(loss))
        w_own, layer_of = state.w_own, layers_of(pipe, cfg.mesh.pp,
                                                 mcfg.n_layers)
        state = state._replace(replicas=None, params=None)
        del batch
        torch.cuda.empty_cache()
        return tr, state, losses, layer_of

    torch.cuda.reset_peak_memory_stats(dev)
    tr, ref_state, ref_losses, ref_layer = run(PP_SCHEDULES["gpipe"])
    ref_state = ref_state._replace(w_own=_host(ref_state.w_own))
    ref = pp_master_leaves(tr, ref_state, ref_layer)
    torch.cuda.empty_cache()
    tr0, init_state, _, _ = run(PP_SCHEDULES["gpipe"], steps=0)
    init = pp_master_leaves(tr0, init_state, ref_layer)
    upd_sq = {k: _diff(init[k][0], ref[k][0])[0] for k in ref}
    del tr0, init_state, init
    torch.cuda.empty_cache()

    def compare(tr_x, st_x, layer_of):
        got = pp_master_leaves(tr_x, st_x, layer_of)
        diffs = [_diff(c, ref[k][0]) for k, cs in got.items() for c in cs]
        den = sum(len(cs) * upd_sq[k] for k, cs in got.items())
        return (math.sqrt(sum(d for d, _ in diffs) / den),
                all(e for _, e in diffs))

    rows = {}
    for name, extra in (
            ("gpipe_plain_attention", PP_SCHEDULES["gpipe"]
             + ["--model.attn_impl=xla"]),
            ("1f1b", PP_SCHEDULES["1f1b"]),
            ("1f1b_interleaved", PP_SCHEDULES["1f1b-interleaved"]),
            (pp1, ["--mesh.pp=1"])):
        tr_x, st_x, losses, layer_of = run(extra)
        rel, equal = compare(tr_x, st_x, layer_of)
        rows[name] = {"master_update_rel_err": rel,
                      "limit": PARITY_GRAD_REL_TOL, "masters_bitequal": equal,
                      "losses": losses,
                      "loss_diffs": [abs(a - b) for a, b in
                                     zip(losses, ref_losses)],
                      "loss_tol": PARITY_LOSS_TOL,
                      "losses_bitequal": losses == ref_losses}
        if name == "1f1b_interleaved":
            plain_order, _ = compare(tr_x, st_x, ref_layer)
        del tr_x, st_x
        torch.cuda.empty_cache()
    checks = {f"{k}_within_tol": r["master_update_rel_err"]
              <= PARITY_GRAD_REL_TOL and max(r["loss_diffs"])
              <= PARITY_LOSS_TOL for k, r in rows.items()}
    checks["finite"] = all(math.isfinite(v) for v in ref_losses) and all(
        math.isfinite(r["master_update_rel_err"]) for r in rows.values())
    checks["control_above_tol"] = plain_order > PARITY_GRAD_REL_TOL
    emit(phase=phase, argv=list(argv),
         reference="gpipe, flash kernels", reference_losses=ref_losses,
         reference_update_norm=math.sqrt(sum(upd_sq.values())),
         against=rows, control_interleaved_order_dropped=plain_order,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         checks=checks)
    del tr, ref_state, ref
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"{phase} failed: {checks}")


# -- the pipeline with every batch axis: dp x pp x sp, pp x ep x sp (MoE) ----

PP_SP_TRAIN_ARGV = PP_MODEL_ARGV + [
    "--seq=8192", "--global_batch=4", "--mesh.dp=2", "--mesh.pp=2",
    "--mesh.sp=2", "--microbatches=2", "--iters=3"] + PP_RING_ARGV
MOE_PP_TRAIN_ARGV = MOE_MODEL_ARGV + [
    "--model.n_layers=2", "--model.attn_block=512", "--model.attn_impl=auto",
    "--seq=8192", "--global_batch=4", "--mesh.dp=1", "--mesh.pp=2",
    "--mesh.ep=2", "--mesh.sp=2", "--microbatches=2", "--iters=3"
] + PP_RING_ARGV + ["--optimizer.clip_norm=1.0"]
MOE_PP_SCHEDULES = ("gpipe", "1f1b")
# sequence 1024 (cut from 4096 to make room for the restore tier's
# phases, then from 2048 on a slow host; the interleaved run keeps the 4
# layers): 512 tokens an sp shard, one attention block
PP_SP_PARITY_ARGV = PP_MODEL_ARGV + [
    "--seq=1024", "--global_batch=4", "--mesh.dp=2", "--mesh.pp=2",
    "--mesh.sp=2", "--microbatches=2", "--iters=2"] + PP_RING_ARGV
MOE_PP_PARITY_SEQ = 1024      # cut from 4096, as PP_SP_PARITY_ARGV
MOE_PP_PARITY_CF = 4.0        # E / top_k: nothing drops at any cut


def pp_axes_per_step(mcfg, cfg, pipe, schedule) -> dict:
    """Port kernel launches a step of the pp path with sp and ep: per
    (dp, ep) rank, microbatch and layer, ``PP_FWD_PER_UNIT`` forwards of
    each flash call and one dq and dk/dv; GPipe's ring attention makes a
    call a visible hop (the sp diagonal ones without offsets, the past
    ones with), the 1F1B schedules' gathered attention one a shard (shard
    0's without offsets, the others at q_offset i S_local with); with tp
    every tp rank's heads go through one call; one ring_ag and, with dp
    > 1, one ring_rs_update a (tp, pp, ep) group (at dp = 1 the
    reduce-scatter is the identity and launches nothing)."""
    sp, groups = cfg.mesh.sp, cfg.mesh.tp * cfg.mesh.pp * cfg.mesh.ep
    units = cfg.mesh.dp * cfg.mesh.ep * pipe.microbatches * mcfg.n_layers
    diag, past = ((sp, sp * (sp - 1) // 2) if schedule == "gpipe"
                  else (1, sp - 1))
    fwd = PP_FWD_PER_UNIT[schedule]
    return {"flash_fwd": fwd * units * diag, "flash_dq": units * diag,
            "flash_dkv": units * diag,
            "flash_fwd_offsets": fwd * units * past,
            "flash_dq_offsets": units * past,
            "flash_dkv_offsets": units * past,
            "ring_rs_update": groups if cfg.mesh.dp > 1 else 0,
            "ring_ag": groups}


def pp_train_path(dev, kernels, argv, schedule, phase,
                  time_rings=False) -> dict:
    """``ShardedTrainer`` over pp (with dp, sp, ep and MoE layers) as
    ``train_llama.build`` builds it from ``argv`` under ``schedule``
    (``PP_TRAIN_ARGV``: Llama-3-8B width over dp=2 x pp=2, sequence 4096,
    4 microbatches; ``PP_SP_TRAIN_ARGV``: over
    dp=2 x pp=2 x sp=2, sequence 8192; ``MOE_PP_TRAIN_ARGV``: Mixtral-8x7B
    width over pp=2 x ep=2 x sp=2 at dp=1, a clip; ``PP_TP_TRAIN_ARGV``:
    Llama-3-8B width over dp=1 x pp=2 x tp=2): one warm-up (with MoE its
    routing statistics) and
    ``--iters`` timed steps on one batch, launch counts zeroed just
    before the first step and read after the last
    (``pp_axes_per_step``); the replicas bit-equal within each (pp, ep)
    group, the leaves every row holds equal across the groups (replicas
    and masters), a stage's slices that replicate over ep equal across
    its ep ranks (with tp, a stage's slices that replicate over tp equal
    across its tp ranks), the loss falling, peak memory and
    ``pipeline_cost``; the backward's own peak; with ``time_rings`` the
    ring kernels timed on a stage group's rows (at dp=1 the gather alone:
    the reduce-scatter is the identity); two steps under the profiler."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import fused_update, moe
    from fpga_ai_nic_tpu_torch.parallel import pipeline
    argv = list(argv) + PP_SCHEDULES[schedule]
    mcfg, cfg, seq, device = train_llama.parse(argv)
    pipe = train_llama.pipeline_flags(argv)
    n, pp, sp, ep = cfg.mesh.dp, cfg.mesh.pp, cfg.mesh.sp, cfg.mesh.ep
    tp = cfg.mesh.tp
    M, G = pipe.microbatches, tp * pp * ep
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr, state = train_llama.build(mcfg, cfg, device, True, pipe)
    sync(dev)
    init_s = time.perf_counter() - t0
    batch = tr.shard_batch(next(train_llama.batches(mcfg, cfg, seq, 1)))
    parts, ranks_fn = [], moe.moe_ranks

    def keep_parts(*a):
        y, p = ranks_fn(*a)
        parts.append(p._replace(psum_p=p.psum_p.detach()))
        return y, p
    for kern in kernels.values():
        kern.launches = 0
    moe.moe_ranks = keep_parts
    try:
        state, loss = tr.step(state, batch)               # warm-up
    finally:
        moe.moe_ranks = ranks_fn
    losses = [float(loss)]
    sync(dev)
    # the allocator's frees of its cache to satisfy a request (each one
    # synchronizes the card): what holds a step near the card's capacity
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(cfg.iters + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for mark in marks[1:]:
        state, loss = tr.step(state, batch)
        losses.append(loss)
        mark.record()
    sync(dev)
    wall = time.perf_counter() - t0
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries",
                                               0) - retries
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [float(v) for v in losses]
    launches = {name: kern.launches for name, kern in kernels.items()}
    steps = cfg.iters + 1
    per_step = {name: 0 for name in kernels}
    per_step.update(pp_axes_per_step(mcfg, cfg, pipe, schedule))
    for name, count in launches.items():
        if count != steps * per_step[name]:
            raise AssertionError(f"{phase} ({schedule}): {name} launched "
                                 f"{count} times, expected {steps} x "
                                 f"{per_step[name]}")
    reps = state.replicas.view(G, n, -1)
    masters = state.w_own.view(G, -1)
    by_stage = masters.view(tp * pp, ep, -1)
    by_tp = masters.view(tp, pp * ep, -1)
    checks = {
        "losses_finite": all(math.isfinite(v) for v in losses),
        "loss_falls": losses[-1] < losses[0],
        "replicas_equal_within_groups": bool((reps == reps[:, :1]).all()),
        "replicated_leaves_equal_across_groups": all(
            bool((reps[:, :, a:b] == reps[:1, :, a:b]).all())
            and bool((masters[:, a:b] == masters[:1, a:b]).all())
            for a, b in tr._rep_spans),
        "stage_slices_equal_across_ep": all(
            bool((by_stage[:, :, a:b] == by_stage[:, :1, a:b]).all())
            for a, b in tr._ep_rep_spans),
        "tp_replicated_slices_equal_across_tp": all(
            bool((by_tp[:, :, a:b] == by_tp[:1, :, a:b]).all())
            for a, b, axes in tr._shard_spans if "tp" in axes),
        "stage_slices_differ": not bool((masters[0] == masters[-1]).all()),
        "replicas_in_model_dtype": state.replicas.dtype == mcfg.torch_dtype}
    stats = None
    if mcfg.moe is not None:
        checks["router_held_apart_f32"] = (
            mcfg.torch_dtype == torch.float32 or (
                state.side is not None and state.side.dtype == torch.float32))
        # every routing call of the warm-up (the recomputations route the
        # same tokens alike)
        stats = moe._stats_from_routing(moe.pool(parts), mcfg.moe.top_k)
    tokens = cfg.iters * cfg.global_batch * seq
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    median = sorted(step_ms)[cfg.iters // 2]
    cost = pipeline.cost_model(M, pp, schedule, pipe.virtual_stages)
    emit(phase=phase, schedule=schedule, model=(
        f"dim {mcfg.dim}, {mcfg.n_heads}/{mcfg.n_kv_heads} heads, ffn "
        f"{mcfg.ffn_dim}, vocab {mcfg.vocab}, {mcfg.moe_experts} experts "
        f"(capacity factor {mcfg.moe_capacity_factor}), {mcfg.dtype}, "
        f"{mcfg.n_layers} layers, attn_impl {mcfg.attn_impl}, remat, random "
        "weights"), params=llama.num_params(mcfg),
         active_params=llama.active_params(mcfg), seq=seq,
         global_batch=cfg.global_batch, dp=n, pp=pp, sp=sp, ep=ep, tp=tp,
         microbatches=M, virtual_stages=pipe.virtual_stages,
         held_at_start_gb=held_gb, tokens_per_step=cfg.global_batch * seq,
         collective=str(cfg.collective), optimizer=str(cfg.optimizer),
         weight_init_s=init_s, steps=cfg.iters, wall_s=wall,
         ms_per_step=1e3 * wall / cfg.iters, step_ms=step_ms,
         median_step_ms=median, tokens_per_sec=tokens / wall, losses=losses,
         peak_mem_gb=peak, padded_len_per_row=int(state.replicas.shape[1]),
         rows=int(state.replicas.shape[0]), alloc_retries_timed=retries,
         launches=launches, launches_per_step=per_step, pipeline_cost=cost,
         expert_stats_warmup=None if stats is None else {
             k: v.tolist() for k, v in stats.items()}, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"{phase} ({schedule}): {checks}")
    del parts, reps, masters, by_stage, by_tp
    torch.cuda.reset_peak_memory_stats(dev)
    state_gb = torch.cuda.memory_allocated(dev) / 1e9
    flat_g, _ = tr.grads(state, batch)
    sync(dev)
    bwd_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    flat_gb = flat_g.numel() * 4 / 1e9
    emit(phase=phase + "_backward_peak", schedule=schedule, held_gb=state_gb,
         backward_peak_gb=bwd_gb, flat_grad_gb=flat_gb,
         activations_gb=bwd_gb - state_gb - flat_gb)
    row_len = int(state.replicas.shape[1])
    out = {"launches": None, "steps": steps, "row_len": row_len}
    if time_rings:
        from fpga_ai_nic_tpu_torch.ops import ring_cuda
        g, w = flat_g[:n], state.w_own[:n]
        C = row_len // n

        def rs():
            return fused_update.reduce_scatter(g, cfg.collective)

        def ag():
            return fused_update.all_gather_flat(w, cfg.collective)
        # the gather at this path's own shape against the plain version,
        # on whole tiles of each chunk (``tile_sample``), among them the
        # tiles that hold byte offset 2^31 and flat offset 2^31 mod C
        bfp = fused_update._fused_bfp_cfg(cfg.collective)
        tile = bfp.block_size * ring_cuda.LANES
        if C % tile:
            raise AssertionError(f"{phase}: chunk {C} is not whole tiles "
                                 f"of {tile}")
        picks = sorted({0, 2 ** 29 % C // tile, 2 ** 31 % C // tile,
                        C // tile // 2, C // tile - 1})
        before = ring_cuda.RING_AG.launches
        rep = ag()
        if ring_cuda.RING_AG.launches != before + 1:
            raise AssertionError(f"{phase}: ring_ag launched "
                                 f"{ring_cuda.RING_AG.launches - before} "
                                 "times in one call, expected 1")
        require_equal(f"{phase}: ring_ag at n={n}, L={row_len}, sampled "
                      "tiles", [(tile_sample(rep, n, tile, picks),
                                 ring_cuda.ring_all_gather_plain(
                                     tile_sample(w, 1, tile, picks), bfp))])
        if not all(bool(torch.isfinite(r).all()) and bool((r == rep[0]).all())
                   for r in rep):
            raise AssertionError(f"{phase}: ring_ag replicas differ or are "
                                 "not finite")
        del rep
        rs_b, ag_b = ring_bytes(n, row_len, C)
        out["ring"] = {
            "shape": (f"n={n}, L={row_len} (one "
                      f"{'(tp, pp)' if tp > 1 else 'stage'} group's rows: "
                      f"{mcfg.n_layers // pp} layers"
                      + (f" split over tp={tp}" if tp > 1 else "")
                      + " and the embedding, final norm and head), no "
                      "optimizer"),
            "rs_device_ms": (device_ms(rs, 5, ("ring_rs_kernel",))
                             if n > 1 else None),
            "rs_bound": bound(rs_b, 11 * n * row_len),
            "ag_device_ms": device_ms(ag, 5, ("ring_ag_kernel",)),
            "ag_bound": bound(ag_b, 10 * n * C),
            "ag_bitexact_at_tiles": picks, "tile_elems": tile}
        emit(phase=phase.replace("train_path", "ring_times"), **out["ring"])
        del g, w
    del flat_g
    held = [state]
    del state

    def train_step():
        held[0], _ = tr.step(held[0], batch)

    prof = profile_run(phase.replace("path", "profile"), train_step, 2,
                       groups=SP_GROUPS,
                       op_groups=MOE_OP_GROUPS if mcfg.moe else None,
                       schedule=schedule)
    idle = 1 - prof["device_ms"] / prof["wall_ms"]
    summary = dict(
        schedule=schedule, median_step_ms=median,
        tokens_per_sec=tokens / wall, peak_mem_gb=peak,
        backward_peak_gb=bwd_gb, idle_share=idle,
        alloc_retries_timed=retries,
        device_ms_by_group={k: v for k, v in prof.items()
                            if k not in ("wall_ms", "kernels_traced")},
        launches_per_step={k: v for k, v in per_step.items() if v},
        losses=losses, pipeline_cost=cost)
    if stats is not None:
        summary["drop_frac"] = float(stats["drop_frac"])
    emit(phase=phase + "_summary", **summary)
    del tr, held, batch
    torch.cuda.empty_cache()
    return {**out, **summary, "launches": launches}


class token_pinned_routing:
    """Within the block, ``ops.moe._route`` routes each token as a
    reference run routed it, whatever the calls that cut the tokens (a
    pipeline schedule's microbatches and units, or one call a layer):
    with ``ref`` None the run is recorded, each call's routed activations
    and experts under its layer (told by the router's weights, the same
    in every run from the same weights); otherwise each token takes the
    experts of the reference token of the same layer nearest to its
    activation (the same token: ``max_rel``, the largest such distance
    over the token's norm, stays small), with ``pin`` the capacity
    assignment redone and the gates from this run's probabilities at
    those experts, without it only the flips counted (``flips`` of
    ``assigned`` (token, k) assignments differ from the reference's)."""

    def __init__(self, moe, ref=None, pin=True):
        self.moe, self.ref, self.pin = moe, ref, pin
        self.table, self.cat = {}, {}
        self.flips = self.assigned = 0
        self.max_rel = 0.0
        self.keep = []

    @staticmethod
    def _key(wr):
        w = wr.reshape(-1, *wr.shape[-2:])[0]
        return tuple(w[:2].reshape(-1).tolist())

    def _reference(self, key):
        import torch
        if key not in self.cat:
            xs, es = zip(*self.table.pop(key))
            x = torch.cat(xs)
            self.cat[key] = (x, (x * x).sum(1), torch.cat(es))
        return self.cat[key]

    def _match(self, key, xf):
        import torch
        rx, rn, re = self.ref._reference(key)
        q = xf.reshape(-1, xf.shape[-1]).float()
        idx, best = [], []
        for c in q.split(2048):
            d = (c * c).sum(1, keepdim=True) - 2 * c @ rx.T + rn
            v, i = d.min(1)
            idx.append(i)
            best.append(v.clamp_min(0).sqrt() / c.norm(dim=1))
        self.max_rel = max(self.max_rel, float(torch.cat(best).max()))
        return re[torch.cat(idx)]

    def __enter__(self):
        moe, orig = self.moe, self.moe._route
        self.orig = orig

        def route(wr, xf, cfg, C):
            r = orig(wr, xf, cfg, C)
            key = self._key(wr)
            n, T = xf.shape[:2]
            k = cfg.top_k
            if self.ref is None:
                self.table.setdefault(key, []).append(
                    (xf.reshape(n * T, -1).detach().float(),
                     r.e_flat.reshape(n * T, k)))
            else:
                e = self._match(key, xf.detach())
                self.flips += int((e != r.e_flat.reshape(n * T, k)).sum())
                self.assigned += e.numel()
                if self.pin:
                    e_flat = e.reshape(r.e_flat.shape)
                    g = r.probs.gather(-1, e_flat.reshape(r.gates.shape))
                    r = moe.Routing(g / g.sum(-1, keepdim=True), e_flat,
                                    *moe.assign(e_flat, cfg.num_experts, C),
                                    r.probs)
            self.keep.append(r.keep.reshape(-1))
            return r
        moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig

    def drop_frac(self) -> float:
        import torch
        return 1.0 - float(torch.cat(self.keep).float().mean())


def moe_pp_train_parity(dev) -> None:
    """The MoE pipeline's gradients at Mixtral-8x7B width, 2 layers,
    sequence ``MOE_PP_PARITY_SEQ``, batch 4 over dp=1 x pp=2 x ep=2 x
    sp=2, 2 microbatches, remat, capacity factor ``MOE_PP_PARITY_CF``
    (nothing drops), from the same seeded weights and batch, as the
    whole tree's gradient: GPipe on the kernels (ring attention) is the
    reference; 1F1B (gathered attention), GPipe on the plain attention
    route and the sp x ep path at pp=1 (``llama.dp_loss_fn``) are held
    against it with their expert choices pinned to the reference's, a
    token at a time (``token_pinned_routing``: the schedules cut the
    tokens into other calls), within the Llama parity limits; the
    unpinned errors and flip shares beside them; GPipe with the ep
    exchange's destinations swapped (the fault control) must exceed the
    limit.  The reference gradient waits in host memory."""
    import dataclasses
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import fused_update, moe
    from fpga_ai_nic_tpu_torch.parallel import pipeline
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.sharded import split_ep
    argv = [a for a in MOE_PP_TRAIN_ARGV if not a.startswith("--seq=")] + [
        f"--seq={MOE_PP_PARITY_SEQ}",
        f"--model.moe_capacity_factor={MOE_PP_PARITY_CF}"]
    mcfg, cfg, seq, _ = train_llama.parse(argv)
    n_dp, pp, sp, ep = cfg.mesh.dp, cfg.mesh.pp, cfg.mesh.sp, cfg.mesh.ep
    M = train_llama.pipeline_flags(argv).microbatches
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    stacked = llama.stack_params(llama.init(gen, mcfg, dev))
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(stacked)]
    paths = [p for p, _ in fused_update._leaves(stacked)]
    grid = {"pp": pp, "ep": ep}
    specs = llama.stacked_param_specs(mcfg, ep_axis="ep")
    spec_leaves = fused_update.tree_leaves(specs)
    whole = tuple(t.to(dev) for t in next(train_llama.batches(
        mcfg, cfg, seq, 1)))
    batch = VirtualRanks(n_dp, dev, sp, ep, pp).shard_batch(whole)

    def rows_to_whole(rows):
        """1F1B's row gradients (the leaves every row holds already summed
        over the stages) as the whole tree's."""
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=dev)
               for t in leaves]
        views = split_ep(fused_update.tree_from_leaves(tuple(paths), acc),
                         specs, grid)
        for i, (v, g) in enumerate(zip(views, rows)):
            for vv, gg, spec in zip(fused_update.tree_leaves(v),
                                    fused_update.tree_leaves(g),
                                    spec_leaves):
                if spec is not None or i < ep:
                    vv.add_(gg)
        return acc

    def grads(kind, impl="pallas", swap=False):
        c = dataclasses.replace(mcfg, attn_impl=impl)
        ranks_fn = llama.moe_ops.moe_ranks
        if swap:
            llama.moe_ops.moe_ranks = (
                lambda wr, shards, x, mc, *tp: ranks_fn(
                    wr, list(shards)[::-1], x, mc, *tp))
        try:
            if kind == "pp1":
                tree = dict(stacked, layers=pipeline.unstack_layers(
                    stacked["layers"]))
                trees = split_ep(tree, llama.param_specs(c), ep)
                losses = llama.dp_loss_fn(c, n_dp, ep, n_sp=sp, remat=True)(
                    [trees[e] for e in range(ep) for _ in range(n_dp)],
                    batch)
                return float(losses.detach().mean()), torch.autograd.grad(
                    losses.sum(), leaves)
            rows = split_ep(stacked, specs, grid)
            stages = [rows[s * ep:(s + 1) * ep] for s in range(pp)]
            if kind == "gpipe":
                losses = llama.pp_dp_loss_fn(
                    c, n_dp, ep, n_sp=sp, num_microbatches=M, remat=True)(
                    stages, batch)
                return float(losses.detach().mean()), torch.autograd.grad(
                    losses.sum(), leaves)
            with torch.no_grad():
                loss, g = llama.pp_dp_loss_and_grads_fn(
                    c, n_dp, ep, n_sp=sp, num_microbatches=M, remat=True)(
                    stages, batch)
            return float(loss), rows_to_whole([t for st in g for t in st])
        finally:
            llama.moe_ops.moe_ranks = ranks_fn

    def dist(ga, gb):
        return math.sqrt(sum(_diff(a.float(), b)[0] for a, b in zip(ga, gb)))

    ref = token_pinned_routing(moe)
    with ref:
        l_ref, g_ref = grads("gpipe")
    norm = math.sqrt(sum(float(g.float().square().sum(dtype=torch.float64))
                         for g in g_ref))
    g_ref = [_host(g.float()) for g in g_ref]
    torch.cuda.empty_cache()
    res, unpinned = {}, {}
    for name, args in (("1f1b", ("1f1b",)),
                       ("gpipe_plain_attention", ("gpipe", "xla")),
                       ("pp1_sp_ep", ("pp1",)),
                       ("control_exchange_swapped",
                        ("gpipe", "pallas", True))):
        for pinned in (True, False):
            if not pinned and name.startswith("control"):
                continue
            pin = token_pinned_routing(moe, ref, pin=pinned)
            with pin:
                l_o, g_o = grads(*args)
            row = {"loss": l_o, "loss_diff": abs(l_o - l_ref),
                   "grad_rel_err": dist(g_o, g_ref) / norm,
                   "routing_flip_share": pin.flips / max(pin.assigned, 1),
                   "match_max_rel": pin.max_rel,
                   "drop_frac": pin.drop_frac()}
            (res if pinned else unpinned)[name] = row
            del g_o
            torch.cuda.empty_cache()
    ctrl = res.pop("control_exchange_swapped")
    checks = {"finite": all(math.isfinite(v) for v in (l_ref, norm)),
              "nothing_dropped": ref.drop_frac() == 0.0 and all(
                  r["drop_frac"] == 0.0 for r in res.values()),
              **{f"{k}_grad_within_tol": r["grad_rel_err"]
                 <= PARITY_GRAD_REL_TOL for k, r in res.items()},
              **{f"{k}_loss_within_tol": r["loss_diff"] <= PARITY_LOSS_TOL
                 for k, r in res.items()},
              "control_above_tol": ctrl["grad_rel_err"] > PARITY_GRAD_REL_TOL}
    emit(phase="moe_pp_train_parity", argv=argv,
         reference="gpipe, flash kernels (ring attention)",
         loss_reference=l_ref, grad_norm=norm, against=res,
         unpinned=unpinned, control=ctrl, grad_tol=PARITY_GRAD_REL_TOL,
         loss_tol=PARITY_LOSS_TOL, capacity_factor=MOE_PP_PARITY_CF,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         checks=checks)
    del stacked, leaves, g_ref
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"moe pp training parity failed: {checks}")


# -- tensor parallelism: Llama and MoE training over tp, tp serving ticks ----

TP_TRAIN_ARGV = [a for a in TRAIN_ARGV if not a.startswith(
    "--global_batch")] + ["--global_batch=4", "--mesh.tp=2"]
MOE_TP_TRAIN_ARGV = MOE_TRAIN_ARGV + ["--mesh.tp=2"]
TP_FLASH_SHAPES = (        # name, B, H, n_kv at S=4096, causal: a dp rank
    ("both tp ranks' heads, one launch", 2, 32, 8),
    ("one tp rank's heads", 2, 16, 4))
TP_SERVE_REQUESTS = 8


def tp_flash_checks(dev, shapes=TP_FLASH_SHAPES,
                    phase="tp_flash_checks") -> dict:
    """The tensor-core flash kernels at the tp path's shapes: a dp rank's
    two sequences with both tp ranks' heads in one launch (B=2, H=32,
    Hkv=8, S=4096, causal, bf16: the path's launch) and one tp rank's
    heads (H=16, Hkv=4: what a launch a tp rank would take, twice).  Each
    against its plain version (``tol_ratio`` within 1, lse within its
    limit), by device time beside the plain version, the library's
    attention and the bound."""
    import torch
    import torch.nn.functional as F
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    out = {}
    for si, (name, B, H, n_kv) in enumerate(shapes):
        S = 4096
        g = torch.Generator(device=dev).manual_seed(400 + si)

        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)

        q, k, v = rand(B, H, S, 128), rand(B, n_kv, S, 128), rand(
            B, n_kv, S, 128)
        do = rand(B, H, S, 128)
        kw = dict(causal=True, sm_scale=128 ** -0.5)
        o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        got = {"out": o, "dq": fa.flash_dq_cuda(*args, **kw)}
        got["dk"], got["dv"] = fa.flash_dkv_cuda(*args, **kw)
        p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
        want = {"out": p_out, "dq": fa.flash_dq_plain(*args, **kw)}
        want["dk"], want["dv"] = fa.flash_dkv_plain(*args, **kw)
        ratio = {t: fa.tol_ratio(got[t], want[t]) for t in got}
        err = {t: max_err([(got[t], want[t])]) for t in got}
        lse_err = max_err([(lse, p_lse)])
        del want, p_out, p_lse
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                                 enable_gqa=True)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), do, retain_graph=True), 10)
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd_cuda(q, k, v, **kw),
                          lambda: fa.flash_fwd_plain(q, k, v, **kw),
                          cuda_ms(lambda: F.scaled_dot_product_attention(
                              q, k, v, is_causal=True, enable_gqa=True),
                              10), ("out",)),
            "flash_dq": (lambda: fa.flash_dq_cuda(*args, **kw),
                         lambda: fa.flash_dq_plain(*args, **kw), lib_bwd,
                         ("dq",)),
            "flash_dkv": (lambda: fa.flash_dkv_cuda(*args, **kw),
                          lambda: fa.flash_dkv_plain(*args, **kw), lib_bwd,
                          ("dk", "dv"))}
        rows = {}
        for kern, (call, plain, lib_ms, terms) in calls.items():
            rows[kern] = {
                "max_abs_err": max(err[t] for t in terms),
                "tol_ratio": max(ratio[t] for t in terms),
                "ms": device_ms(call, 10, (kern + "_kernel",)),
                "call_ms": cuda_ms(call, 10, 2),
                "plain_ms": cuda_ms(plain, 2), "library_ms": lib_ms,
                "bound": flash_bound(kern, B, H, n_kv, S, True),
                "split_floor_ms": flash_bound(kern, B, H, n_kv, S, True,
                                              split=True)[0]}
        checks = {"finite": all(bool(t.float().isfinite().all())
                                for t in got.values()),
                  "within_tol": max(ratio.values()) <= 1.0,
                  "lse_within_tol": lse_err <= fa.LSE_TOL}
        emit(phase=phase, shape=name, B=B, H=H, n_kv=n_kv, S=S,
             hd=128, causal=True, tol_ratio=ratio, max_abs_err=err,
             lse_max_abs_err=lse_err, rows={
                 k: dict(r, bound_ms=r["bound"][0], bound_by=r["bound"][1])
                 for k, r in rows.items()}, library=FLASH_LIBRARY,
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"{phase} ({name}): {checks}")
        out[name] = rows
        del q, k, v, do, o, lse, delta, args, got, qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    return out


def _whole_masters(tr, state):
    """The f32 masters a state holds as one vector in tree order, the tp
    shards joined (views where there is one shard)."""
    import torch
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.parallel.sharded import join_ep
    rows = state.w_own.view(tr.n_shards, -1)
    if tr.n_shards == 1:
        tree = tr._grad_tree(rows[0])
    else:
        tree = join_ep([tr._grad_tree(r) for r in rows], tr.param_specs,
                       tr._grid())
    return torch.cat([t.reshape(-1) for t in fused_update.tree_leaves(tree)])


def llama_tp_train_parity(dev) -> None:
    """Two SGD steps from the same seeded weights on the same batch
    (``TP_TRAIN_ARGV``: Llama-3-8B width, 4 layers, sequence 4096, batch
    4, the BFP ring kernels) at dp=2 x tp=2 against dp=2 x tp=1: the
    losses within ``PARITY_LOSS_TOL`` and the f32 masters (the tp shards
    joined) within ``PARITY_GRAD_REL_TOL`` of the reference's two-step
    update, as an L2 distance over its norm.  The control: the tp run
    with its loss differentiated once a tp rank (each rank's copy of the
    loss backwarded: every gradient tp times too large) must exceed the
    limit."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama

    def run(flags, double_count=False):
        mcfg, cfg, seq, device = train_llama.parse(flags)
        gc.collect()
        torch.cuda.empty_cache()
        tr, state = train_llama.build(mcfg, cfg, device)
        init = _host(_whole_masters(tr, state)) if cfg.mesh.tp == 1 \
            else None
        if double_count:
            loss_fn = tr.loss_fn
            tr.loss_fn = lambda p, b: cfg.mesh.tp * loss_fn(p, b)
        batch = tr.shard_batch(next(train_llama.batches(mcfg, cfg, seq, 1)))
        losses = []
        for _ in range(2):
            state, loss = tr.step(state, batch)
            losses.append(float(loss))
        w = _whole_masters(tr, state).clone()
        del tr, state, batch
        torch.cuda.empty_cache()
        return w, losses, init

    torch.cuda.reset_peak_memory_stats(dev)
    tp1 = [a for a in TP_TRAIN_ARGV if a != "--mesh.tp=2"]
    ref, ref_losses, init = run(tp1)
    upd = math.sqrt(_diff(ref, init)[0])
    del init
    rows = {}
    for name, dc in (("dp2_tp2", False), ("control_loss_per_tp_rank", True)):
        w, losses, _ = run(TP_TRAIN_ARGV, dc)
        d, equal = _diff(w, ref)
        rows[name] = {"master_update_rel_err": math.sqrt(d) / upd,
                      "masters_bitequal": equal, "losses": losses,
                      "loss_diffs": [abs(a - b) for a, b in
                                     zip(losses, ref_losses)]}
        del w
        torch.cuda.empty_cache()
    ctrl = rows.pop("control_loss_per_tp_rank")
    r = rows["dp2_tp2"]
    checks = {"finite": math.isfinite(r["master_update_rel_err"]),
              "masters_within_tol": r["master_update_rel_err"]
              <= PARITY_GRAD_REL_TOL,
              "losses_within_tol": max(r["loss_diffs"]) <= PARITY_LOSS_TOL,
              "control_above_tol": ctrl["master_update_rel_err"]
              > PARITY_GRAD_REL_TOL}
    emit(phase="llama_tp_train_parity", argv=TP_TRAIN_ARGV,
         reference="dp=2 x tp=1, the same kernels", reference_losses=ref_losses,
         reference_update_norm=upd, against=rows, control=ctrl,
         grad_tol=PARITY_GRAD_REL_TOL, loss_tol=PARITY_LOSS_TOL,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         checks=checks)
    del ref
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"llama tp training parity failed: {checks}")


def tp_serving_path(dev, cfg, kernels) -> dict:
    """``ServeEngine`` with ``tp_mesh`` of tp=2 (the serving cell's
    ``ServeConfig`` with the page ledger off, which a tp tick refuses as
    JAX's does; a warm-up engine of one request first, at each tp)
    answers ``TP_SERVE_REQUESTS`` seeded requests, launch
    counts zeroed just before ``run()`` and read after (one paged_attend
    a layer and step, every tp rank's kv heads in one launch); then the
    tp=1 engine serves the same requests (streams compared, the token
    agreement share reported), and on the tp engine's snapshotted decode
    and prefill operands the tp step's logits are held against the tp=1
    step's on the same pool within ``PARITY_LOGIT_TOL``; the control, the
    tp ranks' heads concatenated out of rank order, must exceed it.  The
    paged kernel timed on the snapshotted decode pool and table (layer
    0, seeded q)."""
    import torch
    from fpga_ai_nic_tpu_torch import serve_llama
    from fpga_ai_nic_tpu_torch.models import llama, llama_decode
    from fpga_ai_nic_tpu_torch.ops import paged_attend
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.serve import ServeConfig, ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    scfg = ServeConfig(**dict(SERVE_SHAPE, page_integrity=False))
    params = serve_llama.random_params(cfg, SERVE_SEED, dev)
    prompts = serve_llama.make_prompts(SERVE_SEED + 1, TP_SERVE_REQUESTS,
                                       PROMPT_MIN, PROMPT_MAX, cfg.vocab)
    runs = {}
    for tp in (2, 1):
        mesh = VirtualRanks(1, dev, tp=tp) if tp > 1 else None
        # a warm-up engine first: the library picks its GEMMs on the first
        # calls of each shape, which would land in the timed ticks
        warm = ServeEngine(params, cfg, scfg, device=dev, tp_mesh=mesh)
        warm.submit(prompts[0], 2)
        warm.run()
        warm.pool = []
        del warm
        eng = ServeEngine(params, cfg, scfg, device=dev, tp_mesh=mesh)
        if tp > 1:
            snaps = capture_steps(eng)
        reqs = [eng.submit(p, MAX_NEW) for p in prompts]
        for k in kernels.values():
            k.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        s = eng.run()
        sync(dev)
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        calls = s["prefill_calls"] + s["decode_calls"]
        if s["completed"] != TP_SERVE_REQUESTS or any(
                len(r.generated) != MAX_NEW for r in reqs):
            raise AssertionError(f"tp serving (tp={tp}): not every request "
                                 "got its tokens")
        if s["recovery"]["recoveries"] or s["logit_trips"]:
            raise AssertionError(f"tp serving (tp={tp}): {s['recovery']}")
        if launches["paged_attend"] != cfg.n_layers * calls or any(
                n for name, n in launches.items() if name != "paged_attend"):
            raise AssertionError(f"tp serving (tp={tp}): launches "
                                 f"{launches}, expected {cfg.n_layers} x "
                                 f"{calls} paged_attend only")
        req = s["requests"]
        runs[tp] = {"reqs": reqs, "ticks": tick_times(eng), "wall_s": wall,
                    "output_tok_s": s["tokens_out"] / wall,
                    "tpot_mean_s": req["tpot_mean_s"],
                    "ttft_mean_s": req["ttft_mean_s"],
                    "ticks_run": s["ticks"], "calls": calls,
                    "paged_launches": launches["paged_attend"],
                    "paged_launches_per_tick": launches["paged_attend"]
                    / s["ticks"], "pool_bytes": s["serve"]["pool_bytes"]}
        if tp > 1:
            tp_params, tp_launches = eng.params, launches
        eng.pool = []
        del eng
    streams_equal = sum(a.generated == b.generated for a, b in zip(
        runs[2]["reqs"], runs[1]["reqs"]))
    tokens_equal = sum(x == y for a, b in zip(runs[2]["reqs"],
                                              runs[1]["reqs"])
                       for x, y in zip(a.generated, b.generated))
    agree = tokens_equal / (TP_SERVE_REQUESTS * MAX_NEW)
    parity = {}
    for kind in ("decode", "prefill"):
        snap = snaps.pop(kind)

        def rows(logits):
            logits = logits.float().reshape(-1, cfg.vocab)
            if snap["active"] is not None:
                return logits[snap["active"].reshape(-1)]
            return logits[:snap["rows"]]

        def step(p, tp_axis):
            logits, _ = llama_decode.forward_paged(
                p, snap["tokens"], _clone_pool(snap["pool"]), snap["table"],
                snap["pos"], cfg, page_size=scfg.page_size, tp_axis=tp_axis,
                active=snap["active"])
            return rows(logits)

        l2, l1 = step(tp_params, "tp"), step(params, None)
        col = llama._col
        llama._col = lambda h, ws: col(h, list(ws)[::-1])
        try:
            lc = step(tp_params, "tp")
        finally:
            llama._col = col
        err, ctrl = float((l2 - l1).abs().max()), float((lc - l1).abs().max())
        parity[kind] = {
            "rows": int(l1.shape[0]), "max_logit_err": err,
            "control_heads_out_of_rank_order": ctrl,
            "argmax_agree_share": float((l2.argmax(-1) == l1.argmax(-1))
                                        .float().mean())}
        if kind == "decode":
            q = torch.randn((scfg.max_reqs, cfg.n_heads, 1, cfg.head_dim),
                            generator=torch.Generator(device=dev).manual_seed(
                                5), device=dev).to(torch.bfloat16)
            pk, pv = snap["pool"][0]["k"], snap["pool"][0]["v"]
            table, pos, ps = snap["table"], snap["pos"], scfg.page_size

            def kern():
                return paged_attend.paged_gather_attend(
                    q, pk, pv, table, pos, page_size=ps)

            def plain():
                return paged_attend.paged_gather_attend_plain(
                    q, pk, pv, table, pos, page_size=ps)
            got, want = kern(), plain()
            paged_row = {
                "shape": (f"the tp decode snapshot: R={scfg.max_reqs}, H="
                          f"{cfg.n_heads}, kv={pk.shape[1]} (both tp ranks' "
                          f"kv heads), T=1, page_size {ps}, P="
                          f"{table.shape[1]}, positions {pos.tolist()}"),
                "max_abs_err": max_err([(got, want)]),
                "ms": device_ms(kern, 20, PAGED_KERNELS),
                "call_ms": cuda_ms(kern, 20, 3),
                "plain_ms": cuda_ms(plain, 10),
                "library_ms": cuda_ms(lambda: library_attend(
                    q, pk, pv, table, pos, ps), 5),
                "bound": paged_bound(pos.tolist(), scfg.max_reqs,
                                     cfg.n_heads, pk.shape[1], 1,
                                     cfg.head_dim, ps, table.shape[1],
                                     q_itemsize=2)}
            del q, got, want
        del snap["pool"], l2, l1, lc
    checks = {
        "streams_served": True,
        "logits_within_tol": all(p["max_logit_err"] <= PARITY_LOGIT_TOL
                                 for p in parity.values()),
        "controls_above_tol": all(p["control_heads_out_of_rank_order"]
                                  > PARITY_LOGIT_TOL for p in parity.values()),
        "paged_within_tol": paged_row["max_abs_err"] <= PAGED_TOL}
    tick = {tp: r["ticks"] for tp, r in runs.items()}
    emit(phase="tp_serving_path", model=(
        f"Llama-3-8B (dim {cfg.dim}, {cfg.n_layers} layers, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, {cfg.dtype}), random weights"),
         tp=2, requests=TP_SERVE_REQUESTS, max_new=MAX_NEW,
         serve_config={f: getattr(scfg, f) for f in SERVE_SHAPE},
         runs={tp: {k: v for k, v in r.items() if k != "reqs"}
               for tp, r in runs.items()}, tick_ms=tick,
         streams_equal_to_tp1=streams_equal,
         token_agreement_share=agree, parity=parity,
         logit_tol=PARITY_LOGIT_TOL, paged=dict(
             paged_row, bound_ms=paged_row["bound"][0],
             bound_by=paged_row["bound"][1]),
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         launches=tp_launches, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"tp serving failed: {checks}")
    del params, tp_params, snaps
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "launches": tp_launches, "paged": paged_row,
            "parity": parity, "token_agreement_share": agree}


PP_TP_TRAIN_ARGV = PP_MODEL_ARGV + [
    "--seq=4096", "--global_batch=4", "--mesh.pp=2", "--mesh.tp=2",
    "--microbatches=4", "--iters=3"] + PP_RING_ARGV
PP_TP_SCHEDULES = ("gpipe", "1f1b", "1f1b-interleaved")
PP_TP_FLASH_SHAPES = (     # name, B, H, n_kv at S=4096, causal
    ("a microbatch, both tp ranks' heads, one launch", 1, 32, 8),)
# 2 layers (cut from the timed path's 4 to make room for the restore
# tier's phases): one layer a stage under GPipe and 1F1B
PP_TP_PARITY_ARGV = PP_MODEL_ARGV + [    # sequence cut from 4096
    "--model.n_layers=2", "--seq=2048", "--global_batch=4", "--mesh.pp=2",
    "--mesh.tp=2", "--microbatches=4", "--iters=2"] + PP_RING_ARGV
PP_TP_PARITY_SCHEDULES = ("gpipe", "1f1b")


def llama_pp_tp_train_parity(dev) -> None:
    """Two SGD steps from the same seeded weights on the same batch
    (``PP_TP_PARITY_ARGV``: the timed path's Llama-3-8B width at 2 layers,
    sequence 2048, batch 4, 4 microbatches, remat, the BFP ring kernels)
    at dp=1 x pp=2 x tp=2 against pp=2 x tp=1 under the same schedule,
    for each of ``PP_TP_PARITY_SCHEDULES``: the losses within
    ``PARITY_LOSS_TOL`` and the f32 masters (the tp and pp shards joined,
    ``_whole_masters``) within ``PARITY_GRAD_REL_TOL`` of the reference's
    two-step update, as an L2 distance over its norm.  The control, under
    GPipe: the tp run with its loss backwarded once a tp rank (every
    gradient tp times too large) must exceed the limit.  The reference's
    masters are kept in host memory."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama

    def run(flags, double_count=False):
        mcfg, cfg, seq, device = train_llama.parse(flags)
        pipe = train_llama.pipeline_flags(flags)
        gc.collect()
        torch.cuda.empty_cache()
        tr, state = train_llama.build(mcfg, cfg, device, True, pipe)
        init = (_host(_whole_masters(tr, state)) if cfg.mesh.tp == 1
                else None)
        if double_count:
            loss_fn = tr.loss_fn
            tr.loss_fn = lambda p, b: cfg.mesh.tp * loss_fn(p, b)
        batch = tr.shard_batch(next(train_llama.batches(mcfg, cfg, seq, 1)))
        losses = []
        for _ in range(2):
            state, loss = tr.step(state, batch)
            losses.append(float(loss))
        w = _whole_masters(tr, state).clone()
        del tr, state, batch
        torch.cuda.empty_cache()
        return w, losses, init

    torch.cuda.reset_peak_memory_stats(dev)
    tp1 = [a for a in PP_TP_PARITY_ARGV if a != "--mesh.tp=2"]
    rows, refs, ctrl = {}, {}, None
    for sched in PP_TP_PARITY_SCHEDULES:
        flags = PP_SCHEDULES[sched]
        ref, ref_losses, init = run(tp1 + flags)
        upd = math.sqrt(_diff(ref, init)[0])   # on the card, init pinned
        ref = _host(ref)
        del init
        refs[sched] = {"losses": ref_losses, "update_norm": upd}
        runs = [("pp2_tp2", False)]
        if sched == "gpipe":
            runs.append(("control_loss_per_tp_rank", True))
        for name, dc in runs:
            w, losses, _ = run(PP_TP_PARITY_ARGV + flags, dc)
            d, equal = _diff(w, ref)
            row = {"master_update_rel_err": math.sqrt(d) / upd,
                   "masters_bitequal": equal, "losses": losses,
                   "loss_diffs": [abs(a - b) for a, b in
                                  zip(losses, ref_losses)]}
            if dc:
                ctrl = row
            else:
                rows[sched] = row
            del w
            torch.cuda.empty_cache()
        del ref
    checks = {"finite": all(math.isfinite(r["master_update_rel_err"])
                            for r in rows.values()),
              "masters_within_tol": all(
                  r["master_update_rel_err"] <= PARITY_GRAD_REL_TOL
                  for r in rows.values()),
              "losses_within_tol": all(
                  max(r["loss_diffs"]) <= PARITY_LOSS_TOL
                  for r in rows.values()),
              "control_above_tol": ctrl["master_update_rel_err"]
              > PARITY_GRAD_REL_TOL}
    emit(phase="llama_pp_tp_train_parity", argv=PP_TP_PARITY_ARGV,
         schedules=PP_TP_PARITY_SCHEDULES,
         reference="dp=1 x pp=2 x tp=1 under the same schedule, the same "
         "kernels", references=refs, against=rows, control=ctrl,
         control_schedule="gpipe", grad_tol=PARITY_GRAD_REL_TOL,
         loss_tol=PARITY_LOSS_TOL,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         checks=checks)
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"llama pp x tp training parity failed: "
                             f"{checks}")


# -- the tuner on the MLP cell ----------------------------------------------------

TUNE_STEPS = 3              # timed steps before and after the switch


def _mlp_cell(mcfg, sgd, bx, coll, **adapt_kw):
    from fpga_ai_nic_tpu_torch.utils.config import (AdaptConfig, MeshConfig,
                                                    TrainConfig)
    return TrainConfig(global_batch=bx.shape[0], mesh=MeshConfig(dp=8),
                       collective=coll, optimizer=sgd,
                       adapt=AdaptConfig(**adapt_kw))


def live_calibrate_phase(dev, smi) -> dict:
    """``tune.adapt.live_calibrate`` on 8 virtual ranks of the card: the
    uncompressed ring all-reduce (``ops.ring.ring_all_reduce``) and each
    registered codec's default encode and decode, timed by CUDA events
    (best of 2) at JAX's startup payload (65,536 elements) and at the
    MLP's (41,975,808): the rates at the live tier, ``dryrun`` false."""
    from fpga_ai_nic_tpu_torch import tune
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    out = {}
    for label, elems in (("startup", 1 << 16), ("mlp", 41_975_808)):
        cal = tune.adapt.live_calibrate(VirtualRanks(8, dev),
                                        payload_elems=elems)
        d = cal.describe()
        out[label] = cal
        emit(phase="live_calibrate", payload=label, payload_elems=elems,
             card=smi, inter_gbps=cal.inter_gbps,
             inter_source=cal.inter_source, dryrun=cal.dryrun,
             calibrated=cal.calibrated, codec_rates=d["codec_rates"])
        if cal.dryrun or not cal.inter_live or cal.inter_gbps <= 0:
            raise AssertionError(f"live_calibrate ({label}): {d}")
    return out


def auto_dp_phase(dev, mcfg, sgd, bx, by) -> dict:
    """``DPTrainer`` on the MLP cell (dp=8, batch 5376, SGD) with
    ``CollectiveConfig(codec="auto")`` and live calibration armed
    (``adapt.enabled``): the resolved plan; its modeled collective beside
    the measured ring (the step's reduce-scatter and gather by CUDA
    events on its own gradients); 1 warm-up and ``TUNE_STEPS`` timed
    steps; the masters after two steps bit-equal to a ``DPTrainer``
    built by hand with the resolved collective config."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig
    cfg = _mlp_cell(mcfg, sgd, bx, CollectiveConfig(impl="ring",
                                                    codec="auto"),
                    enabled=True, live_calibration=True)
    ranks = VirtualRanks(8, dev)

    def loss(p, b):
        return mlp.loss_fn(p, b, mcfg)

    def init():
        return mlp.init(torch.Generator().manual_seed(0), mcfg, dev)
    torch.cuda.empty_cache()
    tr = DPTrainer(loss, ranks, cfg)
    state0 = tr.init_state(init())
    plan = tr.obs_static_metrics()["tune"]
    batch = tr.shard_batch((bx, by))
    _, run = timed_steps(tr, state0, batch, {}, TUNE_STEPS)
    g, _ = tr.grads(state0, batch)
    coll = tr.cfg.collective
    rs_ms = cuda_ms(lambda: fused_update.reduce_scatter(g, coll), 3)
    ag_ms = cuda_ms(lambda: fused_update.all_gather_flat(state0.w_own,
                                                         coll), 3)
    del g
    hand = DPTrainer(loss, ranks, dataclasses.replace(
        cfg, collective=coll, adapt=dataclasses.replace(cfg.adapt,
                                                        enabled=False)))
    states = []
    for t in (tr, hand):
        st = state0 if t is tr else t.init_state(init())
        for _ in range(2):
            st, _ = t.step(st, batch)
        states.append(st.w_own)
    require_equal("codec='auto' masters against the hand-resolved "
                  "trainer's", [tuple(states)])
    emit(phase="auto_dp_path", model="MLP 10x2048x2048 f32", dp=8,
         global_batch=cfg.global_batch, resolved={
             "codec": coll.codec, "bucket_elems": coll.bucket_elems,
             "topology": coll.topology, "pipeline_depth":
                 coll.pipeline_depth, "intra_size": coll.intra_size},
         plan=plan, modeled_collective_ms=plan["modeled_collective_ms"],
         measured_ring_ms={"reduce_scatter": rs_ms, "all_gather": ag_ms,
                           "sum": rs_ms + ag_ms, "timed_by": "CUDA events"},
         masters_bitequal_to_hand_resolved=True, **run)
    del tr, hand, state0, states, batch
    torch.cuda.empty_cache()
    return {"plan": plan, "ring_ms": rs_ms + ag_ms, **run}


def adaptive_phase(dev, mcfg, sgd, bx, by, calibration) -> dict:
    """``tune.adapt.AdaptiveTrainer`` on the MLP cell with 3 candidates
    (``tune_topk`` under ``calibration``, the live rates measured at the
    MLP's payload: at the startup payload every rate is host-bound and
    one codec wins at every link rate, so a shift has nowhere to go):
    prewarm,
    ``TUNE_STEPS`` steps on the argmin plan, one ``inject_shift`` to a
    rate whose re-priced argmin is another candidate, the switching step
    and ``TUNE_STEPS`` more.  The switch event (from, to, step, bitwise),
    ``recompiles_across_switch`` 0, the masters one step after the
    switch bit-equal to the target plan's trainer stepped from the
    migrated state, ms/step (CUDA events) before and after.  The
    recompile count is 0 by construction (``prewarm`` steps every
    candidate); what a switch can really change is read on the switching
    step and the steps after it against the steady step before it
    (``probe``): ms, host wall ms, and the bytes reserved and segments
    allocated by the caching allocator.  The target's trainer steps once just before the switching
    step, for the bit-equality reference."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.tune import adapt
    from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig
    cfg = _mlp_cell(mcfg, sgd, bx, CollectiveConfig(impl="ring",
                                                    codec="auto"),
                    enabled=True, live_calibration=True, n_candidates=3)
    torch.cuda.empty_cache()
    at = adapt.AdaptiveTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                               VirtualRanks(8, dev), cfg,
                               calibration=calibration)
    state = at.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg,
                                   dev))
    batch = at.shard_batch((bx, by))
    t0 = time.perf_counter()
    at.prewarm(batch)
    prewarm_s = time.perf_counter() - t0

    def steps(state, k):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(k + 1)]
        marks[0].record()
        for m in marks[1:]:
            state, _ = at.step(state, batch)
            m.record()
        torch.cuda.synchronize()
        return state, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    def probe(state):
        """One step with what a switch could change: its CUDA-event and
        host wall ms, and the bytes the allocator reserved and the
        segments it allocated (cudaMalloc) during it."""
        torch.cuda.synchronize()
        r0 = torch.cuda.memory_reserved(dev)
        a0 = torch.cuda.memory_stats(dev).get("num_device_alloc", 0)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        state, _ = at.step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        return state, {
            "ms": e0.elapsed_time(e1),
            "wall_ms": 1e3 * (time.perf_counter() - t0),
            "reserved_added_bytes": torch.cuda.memory_reserved(dev) - r0,
            "segments_allocated": torch.cuda.memory_stats(dev).get(
                "num_device_alloc", 0) - a0}
    state, before = steps(state, TUNE_STEPS - 1)
    state, steady = probe(state)
    before.append(steady["ms"])
    frm = at.active
    rate = next((r for r in (1e-4, 1e4, 1.0, 100.0, 1e6)
                 if at.controller.retarget(r) != frm), None)
    if rate is None:
        raise AssertionError(
            "adaptive_path: no link rate moves the argmin off plan "
            f"{frm}: {[p.describe()['codec'] for p in at.plans]}")
    to = at.controller.retarget(rate)
    at.controller.inject_shift(rate, step=at._step_i)
    want, _ = at.trainers[to].step(at._migrate(state, frm, to), batch)
    want = want.w_own.clone()
    state, switching = probe(state)
    require_equal("adaptive masters one step after the switch",
                  [(state.w_own, want)])
    del want
    after_steps = []
    for _ in range(TUNE_STEPS):
        state, got = probe(state)
        after_steps.append(got)
    after = [p["ms"] for p in after_steps]
    ev = at.switch_events[0]
    checks = {"one_switch": at.switches == 1 and at.active == to,
              "recompiles_across_switch_zero":
                  at.recompiles_across_switch == 0,
              "masters_bitequal_after_switch": True}
    emit(phase="adaptive_path", model="MLP 10x2048x2048 f32", dp=8,
         candidates=[p.describe() | {"calibration": None}
                     for p in at.plans],
         calibration=at.calibration.describe(), prewarm_s=prewarm_s,
         injected_inter_gbps=rate,
         switch={k: ev[k] for k in ("step", "from_plan", "to_plan",
                                    "bitwise", "evidence")},
         recompiles_across_switch=at.recompiles_across_switch,
         recompiles_are="0 by construction: prewarm built every trainer "
         "and stepped every candidate, so no kernel library or trainer is "
         "left to a switch",
         switching_step=switching, steady_step=steady,
         steps_after_switch=after_steps,
         ms_per_step_before=before, ms_per_step_after=after,
         median_ms_before=sorted(before)[len(before) // 2],
         median_ms_after=sorted(after)[len(after) // 2], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"adaptive_path: {checks}")
    del at, state, batch
    torch.cuda.empty_cache()
    return {"switch": ev, "before": before, "after": after,
            "switching_step": switching, "steady_step": steady}


# -- accumulation, the text loader, the auto codecs, the queue (36-40) --------

ACCUM_TOL = (2e-5, 2e-6)       # rtol, atol: JAX's single-shot accumulation
ACCUM_LOSS_RTOL = 1e-5         # test (tests/test_accum_sched.py)
LLAMA_CELL_ARGV = [a for a in TRAIN_ARGV if not a.startswith(
    ("--global_batch=", "--iters="))] + ["--global_batch=4"]
# on text SGD at the cell's lr 0.1 diverges within a few steps (the
# uniform tokens of the synthetic batches carry no signal, real text
# does), so the text run steps at 0.001
DATA_ARGV = LLAMA_CELL_ARGV + [
    "--data=" + os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "SURVEY.md"), "--accum_steps=2",
                               "--iters=5", "--optimizer.learning_rate=0.001"]
QUEUE_MLP_ARGV = ["--bfp=1", "--mesh.dp=8",
                  "--collective.compression.codec=pallas",
                  "--collective.fused_kernel=true",
                  "--collective.fused_optimizer=true", "--global_batch=5376"]
MAX_INFLIGHT = 8               # CollectiveConfig.max_inflight


def _zero(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def _stepped(tr, state, batches, kernels):
    """``tr.step`` over ``batches`` with CUDA events around each, the
    launch counts zeroed just before: ``(state, losses, step_ms,
    launches)``."""
    import torch
    _zero(kernels)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(batches) + 1)]
    losses = []
    marks[0].record()
    for b, mark in zip(batches, marks[1:]):
        state, loss = tr.step(state, b)
        losses.append(loss)
        mark.record()
    torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    return (state, losses, [a.elapsed_time(b) for a, b in
                            zip(marks, marks[1:])],
            {name: k.launches for name, k in kernels.items()})


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _within(a, b, rtol, atol) -> tuple:
    """``(ok, max |a - b|, max |a - b| / (atol + rtol |b|))``."""
    d = (a.double() - b.double()).abs()
    lim = atol + rtol * b.double().abs()
    return bool((d <= lim).all()), float(d.max()), float((d / lim).max())


def _block_grid(x, block_size: int, mantissa_bits: int):
    """One grid step of each element's BFP block, elementwise, for the
    ``[n, C]`` rows ``x`` in the sublane layout (a block is ``block_size``
    elements 128 apart in a tile): ``2^(floor(log2 max|block|) -
    (mantissa_bits - 2))``, the step ``ops.bfp.encode_blocks`` rounds to."""
    import torch
    n, C = x.shape
    xb = x.abs().reshape(n, -1, block_size, 128)
    _, e = torch.frexp(xb.amax(dim=2, keepdim=True))
    q = torch.ldexp(torch.ones_like(xb[:, :, :1]), e - 1 - (mantissa_bits - 2))
    return q.expand_as(xb).reshape(n, C)


def accum_mlp_path(dev, kernels, mcfg, sgd, bx, by) -> dict:
    """The MLP main path (dp=8, batch 5376, the BFP ring kernels, fused
    SGD) at ``accum_steps=4`` (168 rows a rank a microbatch) against 1 on
    the same batch, from the same weights, two steps; the median of three
    steps' ms after a warm-up (from fresh weights, before the compared
    steps) and their peak memory; one ``ring_rs_update`` and one
    ``ring_ag`` launch a step at both; the losses within 1e-5 relative.

    The accumulation itself: at each step the accumulated gradient rows
    (before the codec) of both trainers at the same weights (run 1's)
    within JAX's tolerance (rtol 2e-5, atol 2e-6,
    ``tests/test_accum_sched.py``).

    The masters, on the BFP ring: each step's update reads the ring's
    decoded sum G (the ``ring_rs`` kernel's output on the step's rows),
    and the ring rounds every hop's partial sum to its block's grid, so a
    row value on a rounding boundary in one summation order and not the
    other moves G by a grid step of that element's block at that hop,
    at most the grid of the largest scale a partial sum of the block
    reaches (its max of ``sum_r |g_r|``, widened by 2^-4 for the hops'
    rounding).  Held: at step 1 (same weights) each element of G differs
    by at most that one grid step plus the rows' own difference; the two
    runs' masters differ by what their decoded sums' updates differ by,
    within JAX's tolerance; each master within JAX's tolerance plus
    ``lr / n`` times one such grid step a step.  Step 2's G also carries
    the gradients' response to step 1's masters, so it is read, not
    bounded.  The masters beyond the plain tolerance are counted."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.ops import ring_cuda
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (
        BFPConfig, CollectiveConfig, MeshConfig, TrainConfig)
    n = 8
    bcfg = BFPConfig(codec="pallas")
    rtol, atol = ACCUM_TOL
    lr, B, m = sgd.learning_rate, bcfg.block_size, bcfg.mantissa_bits

    def init(tr):
        return tr.init_state(mlp.init(torch.Generator().manual_seed(0),
                                      mcfg, dev))

    trs, states, runs = {}, {}, {}
    for a in (1, 4):
        cfg = TrainConfig(global_batch=bx.shape[0], accum_steps=a,
                          mesh=MeshConfig(dp=n), optimizer=sgd,
                          collective=CollectiveConfig(
                              impl="ring", compression=bcfg,
                              fused_kernel=True, fused_optimizer=True))
        gc.collect()
        torch.cuda.empty_cache()
        trs[a] = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                           make_ranks(cfg.mesh, dev), cfg)
        batch = trs[a].shard_batch((bx, by))
        torch.cuda.reset_peak_memory_stats(dev)
        _, _, ms, _ = _stepped(trs[a], init(trs[a]), [batch] * 4, kernels)
        runs[a] = {"step_ms": ms[1:], "G": [], "losses": [], "launches": {},
                   "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        states[a] = init(trs[a])

    def ring_sum(g):
        return ring_cuda.ring_reduce_scatter_fused(g, compression=bcfg)

    grads, grids = [], []
    for s in range(2):
        g1, _ = trs[1].grads(states[1], batch)
        g4, _ = trs[4].grads(states[1], batch)
        grads.append(_within(g4, g1, rtol, atol))
        grids.append(_block_grid(g1.abs().sum(0).reshape(n, -1)
                                 * (1 + 2.0 ** -4), B, m).double())
        runs[1]["G"].append(ring_sum(g1))
        if s == 0:      # the same weights: run 4's own rows
            runs[4]["G"].append(ring_sum(g4))
            rows_diff = (g4.double() - g1.double()).abs().sum(0) \
                .reshape(n, -1)
        del g1, g4
        if s == 1:
            g4, _ = trs[4].grads(states[4], batch)
            runs[4]["G"].append(ring_sum(g4))
            del g4
        for a in (1, 4):
            states[a], losses, _, launches = _stepped(
                trs[a], states[a], [batch], kernels)
            runs[a]["losses"] += losses
            for k, v in launches.items():
                runs[a]["launches"][k] = runs[a]["launches"].get(k, 0) + v
    r1, r4 = runs[1], runs[4]
    w1, w4 = states[1].w_own.double(), states[4].w_own.double()
    del trs, states
    d = (w4 - w1).abs()
    plain = atol + rtol * w1.abs()
    flips = lr / n * (grids[0] + grids[1])
    beyond = d > plain
    n_beyond = int(beyond.sum())
    dG = [G4.double() - G1.double() for G1, G4 in zip(r1["G"], r4["G"])]
    # step 1: one grid step of the block's top scale at most, besides the
    # rows' own difference
    flip1 = (dG[0].abs() - rows_diff) / grids[0]
    # the masters move by what the decoded sums' updates move them by
    follow = (w4 - w1 + lr / n * (dG[0] + dG[1])).abs()
    steps1 = (dG[0].abs() / grids[0])[beyond].round()
    hist1 = {str(k): int((steps1 == k).sum()) for k in range(2)}
    hist1["2+"] = int((steps1 >= 2).sum())
    fin = [float((g.abs() / _block_grid(G1, B, m).double())[beyond].max())
           if n_beyond else 0.0 for g, G1 in zip(dG, r1["G"])]
    top2 = float((dG[1].abs() / grids[1])[beyond].max()) if n_beyond \
        else 0.0
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(r4["losses"],
                                                       r1["losses"]))
    per_step = {a: {k: r["launches"][k] / 2 for k in ("ring_rs_update",
                                                      "ring_ag")}
                for a, r in runs.items()}
    checks = {"grads_within_tol": all(ok for ok, _, _ in grads),
              "ring_sums_one_grid_step_at_step_1": float(flip1.max())
              <= 1.0,
              "masters_follow_decoded_sums": bool((follow <= plain).all()),
              "masters_within_tol_and_own_block_flips": bool(
                  (d <= plain + flips).all()),
              "losses_within_tol": loss_rel <= ACCUM_LOSS_RTOL,
              "ring_launches_equal": per_step[1] == per_step[4] == {
                  "ring_rs_update": 1, "ring_ag": 1}}
    emit(phase="accum_path", cell="MLP 10x2048x2048 f32, dp=8, batch 5376, "
         "BFP ring kernels, fused SGD lr 0.1", steps=2,
         rows_a_rank_a_microbatch={a: bx.shape[0] // n // a for a in runs},
         median_step_ms={a: _median(r["step_ms"]) for a, r in runs.items()},
         step_ms={a: r["step_ms"] for a, r in runs.items()},
         peak_mem_gb={a: r["peak_mem_gb"] for a, r in runs.items()},
         losses={a: r["losses"] for a, r in runs.items()},
         ring_launches_per_step=per_step, tol=ACCUM_TOL,
         grad_max_abs_err=[e for _, e, _ in grads],
         grad_err_over_tol=[q for _, _, q in grads],
         ring_sum_step_1_max_excess_in_top_scale_steps=float(flip1.max()),
         master_max_abs_err=float(d.max()),
         masters_follow_err_over_tol=float((follow / plain).max()),
         master_err_over_tol_and_own_block_flips=float(
             (d / (plain + flips)).max()),
         masters_beyond_plain_tol=n_beyond, masters_elems=int(w1.numel()),
         beyond_step_1_ring_sum_diff_in_top_scale_steps=hist1,
         beyond_ring_sum_diff_max_final_block_steps=fin,
         beyond_step_2_ring_sum_diff_max_top_scale_steps=top2,
         loss_rel_err=loss_rel, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"accum_path (MLP): {checks}")
    out = {a: r["launches"] for a, r in runs.items()}
    del runs, r1, r4, dG, grids
    torch.cuda.empty_cache()
    return out


def _llama_run(dev, kernels, argv, timed=3):
    """The ``train_llama`` driver's trainer from ``argv``: one warm-up and
    ``timed`` steps on seeded batches; launches a step, the median ms,
    peak memory."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    mcfg, cfg, seq, device = train_llama.parse(argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr, state = train_llama.build(mcfg, cfg, device)
    batches = [tr.shard_batch(b) for b in train_llama.batches(
        mcfg, cfg, seq, timed + 1)]
    state, losses, step_ms, launches = _stepped(tr, state, batches, kernels)
    out = {"losses": losses, "step_ms": step_ms[1:],
           "median_step_ms": _median(step_ms[1:]),
           "launches_per_step": {k: v / (timed + 1)
                                 for k, v in launches.items()},
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "mcfg": mcfg, "cfg": cfg, "seq": seq,
           "launches": launches}
    del tr, state, batches
    torch.cuda.empty_cache()
    return out


def accum_llama_path(dev, kernels) -> dict:
    """The Llama cell (Llama-3-8B width, 4 layers, seq 4096, batch 4 over
    dp=2, the BFP ring kernels) at ``accum_steps=2`` beside 1: ms/step,
    peak memory (which must not rise: a microbatch's activations are
    half, the f32 rows shared), the flash launches a step (n_layers x dp
    x accum_steps) and one ring launch of each a step at both."""
    runs = {a: _llama_run(dev, kernels, LLAMA_CELL_ARGV
                          + [f"--accum_steps={a}"]) for a in (1, 2)}
    mcfg, n = runs[1]["mcfg"], runs[1]["cfg"].mesh.dp
    checks = {f"flash_fwd_a{a}": r["launches_per_step"]["flash_fwd"]
              == mcfg.n_layers * n * a for a, r in runs.items()}
    checks.update({f"rings_a{a}": (r["launches_per_step"]["ring_rs_update"],
                                   r["launches_per_step"]["ring_ag"])
                   == (1, 1) for a, r in runs.items()})
    checks["peak_not_above"] = runs[2]["peak_mem_gb"] <= runs[1][
        "peak_mem_gb"]
    emit(phase="accum_path", cell=(
        "Llama-3-8B width, 4 layers, seq 4096, batch 4 over dp=2, BFP "
        "ring kernels, SGD"), steps=3,
         median_step_ms={a: r["median_step_ms"] for a, r in runs.items()},
         step_ms={a: r["step_ms"] for a, r in runs.items()},
         peak_mem_gb={a: r["peak_mem_gb"] for a, r in runs.items()},
         losses={a: r["losses"] for a, r in runs.items()},
         launches_per_step={a: {k: v for k, v in r["launches_per_step"]
                                .items() if v} for a, r in runs.items()},
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"accum_path (Llama): {checks}")
    return {a: r["launches"] for a, r in runs.items()}


def llama_data_path(dev, kernels) -> dict:
    """``train_llama.main`` with ``--data=SURVEY.md --accum_steps=2`` at the
    Llama cell's width, SGD at lr 0.001 (byte tokens, boundary-masked
    labels, the global count a microbatch): tokens/s, the losses (finite
    and falling over six steps), the share of -100
    labels, the host seconds to the first batch (256 windows of 4097
    bytes fill the shuffle buffer first), launches; then two such steps
    through the flash kernels (attn_impl="pallas") and the plain
    attention route ("xla") from the same weights on the same batches:
    the masters' update within 0.05 of the plain route's, the losses
    within 2e-3."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(kernels)
    out = train_llama.main(DATA_ARGV)
    launches = {name: k.launches for name, k in kernels.items()}
    mcfg, cfg, seq, _ = train_llama.parse(DATA_ARGV)
    steps = cfg.iters + 1
    per_step = {k: v / steps for k, v in launches.items() if v}
    checks = {"finite": all(math.isfinite(v) for v in out["losses"]),
              "loss_falls": out["losses"][-1] < out["losses"][0],
              "masked_labels": out["data"]["masked_share"] > 0,
              "flash_per_step": per_step.get("flash_fwd") ==
              mcfg.n_layers * cfg.mesh.dp * cfg.accum_steps,
              "rings_per_step": (per_step.get("ring_rs_update"),
                                 per_step.get("ring_ag")) == (1, 1)}
    emit(phase="llama_data_path", argv=DATA_ARGV,
         tokens_per_sec=out["tokens_per_sec"], losses=out["losses"],
         masked_share=out["data"]["masked_share"],
         first_batch_s=out["data"]["first_batch_s"], wall_s=out["wall_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         launches=launches, launches_per_step=per_step, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"llama_data_path: {checks}")
    # parity: two microbatch-weighted steps, kernels against plain route
    res = {}
    for impl in ("pallas", "xla"):
        argv = DATA_ARGV + [f"--model.attn_impl={impl}"]
        m, c, s, device = train_llama.parse(argv)
        gc.collect()
        torch.cuda.empty_cache()
        tr, st = train_llama.build(m, c, device, dp_size=c.mesh.dp)
        w0 = st.w_own.to("cpu") if impl == "pallas" else None
        losses = []
        for b in train_llama.text_batches(train_llama.data_flag(argv), m, c,
                                          s, 2):
            st, loss = tr.step(st, tr.shard_batch(b))
            losses.append(float(loss))
        res[impl] = {"losses": losses, "w0": w0,
                     "w": st.w_own.to("cpu") if impl == "pallas"
                     else st.w_own}
        del tr, st
    w0 = res["pallas"]["w0"].view(-1)
    wk, wp = res["pallas"]["w"].view(-1), res["xla"]["w"].view(-1)
    num = den = 0.0
    chunk = 1 << 27
    for i in range(0, w0.numel(), chunk):
        d0 = w0[i:i + chunk].to(dev)
        dp_ = wp[i:i + chunk] - d0
        dk = wk[i:i + chunk].to(dev) - d0
        num += float((dk - dp_).double().square().sum())
        den += float(dp_.double().square().sum())
        del d0, dp_, dk
    rel = math.sqrt(num / den)
    loss_diff = max(abs(a - b) for a, b in zip(res["pallas"]["losses"],
                                               res["xla"]["losses"]))
    pchecks = {"update_within_tol": rel <= PARITY_GRAD_REL_TOL,
               "losses_within_tol": loss_diff <= PARITY_LOSS_TOL,
               "finite": math.isfinite(rel)}
    emit(phase="llama_data_parity", steps=2, accum_steps=cfg.accum_steps,
         losses_kernel=res["pallas"]["losses"],
         losses_plain=res["xla"]["losses"], loss_diff=loss_diff,
         loss_tol=PARITY_LOSS_TOL, update_rel_err=rel,
         update_tol=PARITY_GRAD_REL_TOL, checks=pchecks)
    del res, w0, wk, wp
    torch.cuda.empty_cache()
    if not all(pchecks.values()):
        raise AssertionError(f"llama_data_parity: {pchecks}")
    return {"launches": launches, "tokens_per_sec": out["tokens_per_sec"]}


def codec_auto_path(dev, kernels, mcfg, sgd, bx, by) -> dict:
    """The MLP main path with ``BFPConfig(codec="auto")`` and with
    ``Int8Codec(backend="auto")``, each against the codec it must pick,
    three steps from the same weights on the same batch, masters bit for
    bit: at a rank payload of whole (16, 128) tiles (dp=8 fused:
    5,246,976 elements a chunk; dp=2: 20,981,760) "pallas", at one that
    does not tile (dp=8 separate-op ring: 5,245,440) "xla"; each route's
    kernel launches counted (the sublane kernels launch where auto picks
    them, and only there)."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (
        BFPConfig, CollectiveConfig, MeshConfig, TrainConfig)

    def coll(codec, backend, **kw):
        if codec == "bfp":
            return CollectiveConfig(impl="ring", compression=BFPConfig(
                codec=backend), fused_optimizer=True, **kw)
        return CollectiveConfig(impl="ring", codec="int8", codec_opts=(
            ("backend", backend),), fused_optimizer=True, **kw)

    cases = (("bfp_fused_dp8", "bfp", 8, dict(fused_kernel=True), "pallas",
              ("ring_rs_update", "ring_ag")),
             ("bfp_ring_dp2", "bfp", 2, {}, "pallas",
              ("bfp_encode", "bfp_decode")),
             ("bfp_ring_dp8", "bfp", 8, {}, "xla",
              ("bfp_encode", "bfp_decode")),
             ("int8_ring_dp2", "int8", 2, {}, "pallas",
              ("int8_encode", "int8_decode")),
             ("int8_ring_dp8", "int8", 8, {}, "xla",
              ("int8_encode", "int8_decode")))
    rows, total = {}, dict.fromkeys(kernels, 0)
    for name, codec, n, kw, want, route in cases:
        got = {}
        for backend in ("auto", want):
            cfg = TrainConfig(global_batch=bx.shape[0], mesh=MeshConfig(dp=n),
                              collective=coll(codec, backend, **kw),
                              optimizer=sgd)
            gc.collect()
            torch.cuda.empty_cache()
            tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                           make_ranks(cfg.mesh, dev), cfg)
            state = tr.init_state(mlp.init(torch.Generator().manual_seed(0),
                                           mcfg, dev))
            batch = tr.shard_batch((bx, by))
            state, losses, step_ms, launches = _stepped(
                tr, state, [batch] * 3, kernels)
            got[backend] = {"w": state.w_own, "ms": step_ms,
                            "launches": launches,
                            "chunk": tr._meta.padded_len // n}
            del tr, state, batch
        require_equal(f"codec_auto_path {name} masters",
                      [(got["auto"]["w"], got[want]["w"])])
        la = got["auto"]["launches"]
        tiles = want == "pallas"
        checks = {"same_launches": la == got[want]["launches"],
                  "route_kernels": all((la[k] > 0) == tiles for k in route)}
        rows[name] = {"picks": want, "rank_payload": got["auto"]["chunk"],
                      "median_step_ms_auto": _median(got["auto"]["ms"][1:]),
                      "median_step_ms_pinned": _median(got[want]["ms"][1:]),
                      "launches": {k: v for k, v in la.items() if v},
                      "masters_bitequal": True, "checks": checks}
        for k, v in la.items():
            total[k] += v
        del got
        if not all(checks.values()):
            raise AssertionError(f"codec_auto_path {name}: {rows[name]}")
    emit(phase="codec_auto_path", model="MLP 10x2048x2048 f32, batch 5376, "
         "SGD lr 0.1 (fused formula), 3 steps a route", cases=rows)
    torch.cuda.empty_cache()
    return total


def queued_mlp_path(dev, kernels, mcfg, bx, by) -> dict:
    """``train_mlp --queue=explicit`` at the MLP cell (dp=8, batch 5376,
    the fused BFP ring kernels a bucket): ``QueuedDDPTrainer`` against
    the fused ``DDPTrainer`` on the same batch, masters bit-equal after
    two steps and after five, at most 8 collectives in flight, none
    abandoned; the median ms of steps 3-5 of both, the queue's counters;
    then the driver's own JSON."""
    import torch
    from fpga_ai_nic_tpu_torch import train_mlp
    from fpga_ai_nic_tpu_torch.parallel import DDPTrainer, QueuedDDPTrainer
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.models import mlp
    _, cfg, device = train_mlp.parse(QUEUE_MLP_ARGV)
    got = {}
    for cls in (DDPTrainer, QueuedDDPTrainer):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = cls(lambda p, b: mlp.loss_fn(p, b, mcfg),
                 make_ranks(cfg.mesh, device), cfg)
        state = tr.init_state(mlp.init(torch.Generator().manual_seed(0),
                                       mcfg, dev))
        batch = tr.shard_batch((bx, by))
        state, l2, _, _ = _stepped(tr, state, [batch, batch], kernels)
        w2 = state.w_master.clone()
        state, l4, ms, launches = _stepped(tr, state, [batch] * 3,
                                           kernels)
        got[cls.__name__] = {
            "w2": w2, "w5": state.w_master, "losses": l2 + l4, "ms": ms,
            "launches": launches, "buckets": len(tr.plan.buckets),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "identical": bool((state.w_master == state.w_master[0]).all())}
        if cls is QueuedDDPTrainer:
            got[cls.__name__].update(
                counters=tr.profiler.collectives.as_dict(),
                max_outstanding=tr.queue.max_outstanding)
        del tr, state, batch
    f, q = got["DDPTrainer"], got["QueuedDDPTrainer"]
    require_equal("queued_path MLP masters", [(q["w2"], f["w2"]),
                                              (q["w5"], f["w5"])])
    c = q["counters"]
    checks = {"max_inflight": q["max_outstanding"] <= MAX_INFLIGHT,
              "abandoned": c["abandoned"] == 0,
              "issued_completed": c["issued"] == c["completed"]
              == 5 * q["buckets"],
              "same_launches": q["launches"] == f["launches"],
              "replicas_identical": q["identical"] and f["identical"]}
    del got
    torch.cuda.empty_cache()
    drv = train_mlp.main(QUEUE_MLP_ARGV + ["--queue=explicit", "--iters=3"])
    emit(phase="queued_path", cell="MLP 10x2048x2048 f32, dp=8, batch 5376, "
         "fused BFP ring kernels a bucket", n_buckets=q["buckets"],
         median_step_ms_queued=_median(q["ms"]),
         median_step_ms_fused=_median(f["ms"]), step_ms_queued=q["ms"],
         step_ms_fused=f["ms"], losses=q["losses"],
         peak_mem_gb={"fused": f["peak_mem_gb"], "queued": q["peak_mem_gb"]},
         masters_bitequal_after=[2, 5], counters=c,
         max_outstanding=q["max_outstanding"],
         launches_per_step={k: v / 3 for k, v in q["launches"].items() if v},
         driver={k: drv[k] for k in ("loss", "samples_per_sec", "wall_s",
                                     "queue", "max_outstanding")},
         driver_collectives=drv["profile"]["collectives"], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"queued_path (MLP): {checks}")
    return q["launches"]


def queued_bert_path(dev, kernels) -> dict:
    """``train_bert --queue=explicit`` at the BERT cell (BERT-base, seq 512,
    batch 64 over dp=8, the fused BFP ring kernels a bucket, AdamW):
    rank 0's masters after two steps and after five bit-equal to the
    fused ``DDPTrainer``'s on the same batches, every rank's replica
    equal, at most 8 collectives in flight, none abandoned; the median ms
    of steps 3-5 of both and the queue's counters."""
    import torch
    from fpga_ai_nic_tpu_torch import train_bert
    from fpga_ai_nic_tpu_torch.parallel.ddp import replicas_identical
    mcfg, cfg, run = train_bert.parse(BERT_ARGV)
    got = {}
    for queue in ("fused", "explicit"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        r = dataclasses.replace(run, queue=queue)
        tr, state = train_bert.build(mcfg, cfg, r)
        stream = [tr.shard_batch(b) for b, _ in
                  train_bert.batches(mcfg, cfg, r, 5)]
        state, l2, _, _ = _stepped(tr, state, stream[:2], kernels)
        w2 = state.w_master[0].to("cpu")
        state, l4, ms, launches = _stepped(tr, state, stream[2:], kernels)
        got[queue] = {"w2": w2, "w5": state.w_master[0].to("cpu"),
                      "losses": l2 + l4, "ms": ms, "launches": launches,
                      "buckets": len(tr.plan.buckets),
                      "identical": replicas_identical(state),
                      "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                      / 1e9}
        if queue == "explicit":
            got[queue].update(counters=tr.profiler.collectives.as_dict(),
                              max_outstanding=tr.queue.max_outstanding)
        del tr, state, stream
    f, q = got["fused"], got["explicit"]
    require_equal("queued_path BERT masters", [(q["w2"], f["w2"]),
                                               (q["w5"], f["w5"])])
    c = q["counters"]
    checks = {"max_inflight": q["max_outstanding"] <= MAX_INFLIGHT,
              "abandoned": c["abandoned"] == 0,
              "issued_completed": c["issued"] == c["completed"]
              == 5 * q["buckets"],
              "same_launches": q["launches"] == f["launches"],
              "replicas_identical": q["identical"] and f["identical"],
              "losses_equal": q["losses"] == f["losses"]}
    emit(phase="queued_path", cell="BERT-base, seq 512, batch 64 over dp=8, "
         "fused BFP ring kernels a bucket, AdamW", n_buckets=q["buckets"],
         median_step_ms_queued=_median(q["ms"]),
         median_step_ms_fused=_median(f["ms"]), step_ms_queued=q["ms"],
         step_ms_fused=f["ms"], losses=q["losses"],
         peak_mem_gb={"fused": f["peak_mem_gb"], "queued": q["peak_mem_gb"]},
         masters_bitequal_after=[2, 5], counters=c,
         max_outstanding=q["max_outstanding"],
         launches_per_step={k: v / 3 for k, v in q["launches"].items() if v},
         checks=checks)
    del got
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"queued_path (BERT): {checks}")
    return q["launches"]


def staging_check() -> dict:
    """The port's ``csrc/staging.cpp`` built here (g++ -O3 -pthread) and one
    ``epochs_of(native=True)`` epoch against the numpy path, batch for
    batch, with the host seconds of each."""
    import numpy as np
    from fpga_ai_nic_tpu_torch import data
    from fpga_ai_nic_tpu_torch.runtime import native, staging
    t0 = time.perf_counter()
    staging.lib()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    arrays = {"x": rng.standard_normal((16384, 1024)).astype(np.float32),
              "y": rng.integers(0, 1000, 16384).astype(np.int32)}
    t0 = time.perf_counter()
    want = list(data.epochs_of(arrays, 512, seed=0, epochs=1))
    numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = list(data.epochs_of(arrays, 512, seed=0, epochs=1, native=True))
    native_s = time.perf_counter() - t0
    equal = len(got) == len(want) == 32 and all(
        np.array_equal(g[k], w[k]) for g, w in zip(got, want) for k in arrays)
    emit(phase="staging_check", library=native.lib_path("staging.cpp").name,
         build_s=build_s, batches=len(got), batch_rows=512,
         row_bytes=1024 * 4, numpy_s=numpy_s, native_s=native_s,
         equal=equal)
    if not equal:
        raise AssertionError("staging_check: the native epoch differs")
    return {"build_s": build_s}


# -- 42-45. A.8's restore tier: the elastic loop, the durability plane, the
# serving tick's faults, the checkpoint drivers ------------------------------

ELASTIC_STEPS = 4          # a cell's steps; the fault fires at step 3
ELASTIC_CKPT_EVERY = 2     # so a fault at step 3 rewinds to step 2
# step_timeout_s: this, or 20 warm steps.  A cell's first step is cold (its
# queue's new side stream has no cached blocks, and the step-0 save runs
# beside it): a floor of 1 s let a slow host's first step pass for a hang
ELASTIC_TIMEOUT_FLOOR_S = 5.0
ELASTIC_CELLS = [          # JAX's seven (tests/test_chaos.py:226-234)
    ("exception", "queue.issue", "nan"),
    ("preemption", "queue.issue", "nan"),
    ("hang", "queue.wait", "nan"),
    ("slowdown", "staging", "nan"),
    ("corruption", "staging", "nan"),
    ("corruption", "queue.wait", "nan"),
    ("corruption", "collective", "scale"),
]


def _disk_free_gb(path) -> float:
    import shutil
    return shutil.disk_usage(path).free / 1e9


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def _shard_file(c, step, j, mirror=False) -> str:
    """The file of shard ``j`` of step ``step``'s stored ``w_own``."""
    entry = next(e for e in c.read_manifest(step)["leaves"]
                 if e["path"] == ["w_own"])
    rec = entry["shards"][j]
    return os.path.join(c._path(step), rec["mirror" if mirror else "file"])


def _elastic_trainer(dev, mcfg, sgd, bx, by, fused):
    """The main path's MLP trainer (full width, dp=8, global batch 5376,
    SGD lr 0.1) with ``integrity_check=True``: on the fused BFP ring
    kernels, or with ``fused=False`` on the codec route (the unfused rings
    on the ``bfp_codec.cu`` kernels, the route the collective tap sees)."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (
        BFPConfig, CollectiveConfig, MeshConfig, TrainConfig)
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                            fused_kernel=fused, fused_optimizer=True,
                            integrity_check=True)
    cfg = TrainConfig(global_batch=5376, mesh=MeshConfig(dp=8),
                      collective=coll, optimizer=sgd)
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg), VirtualRanks(8, dev),
                   cfg)
    st = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg, dev))
    return tr, st, tr.shard_batch((bx, by))


def _plain_steps(tr, st, batch, n):
    """``n`` plain steps; returns the states after each."""
    out = []
    for _ in range(n):
        st, _ = tr.step(st, batch)
        out.append(st)
    return out


def elastic_path(dev, kernels, mcfg, sgd, bx, by, smi) -> dict:
    """JAX's seven fault cells on ``ElasticTrainer`` over the main path's
    trainer at full width (integrity on, mirrored checkpoints every 2
    steps, ``keep_last=2``, 4 steps a cell, the fault at step 3).  Each
    trainer takes a clean step first (the kernels are built; its second
    step times the warm step that sizes ``step_timeout_s``).  Six cells
    run on the fused BFP ring kernels, ``corruption@collective`` on the
    codec route.  A cell's launch counts are zeroed just before its run
    and read just after; its final masters must be bit-equal to the same
    route's fault-free steps, every spec fire once, ``slowdown@staging``
    recover nothing, and every watchdog thread be joined before the next
    cell."""
    import shutil
    import tempfile
    import torch
    from fpga_ai_nic_tpu_torch.parallel.elastic import (ElasticConfig,
                                                        ElasticTrainer)
    from fpga_ai_nic_tpu_torch.runtime import chaos
    t_phase = time.perf_counter()
    routes = {}
    for fused in (True, False):
        tr, st0, batch = _elastic_trainer(dev, mcfg, sgd, bx, by, fused)
        tr.step(st0, batch)                       # clean step: warm
        sync(dev)
        t0 = time.perf_counter()
        tr.step(st0, batch)
        sync(dev)
        warm_ms = 1e3 * (time.perf_counter() - t0)
        ref = _plain_steps(tr, st0, batch, ELASTIC_STEPS)[-1].w_own.clone()
        routes[fused] = (tr, st0, batch, warm_ms, ref)
    codec_equals_fused = bool(torch.equal(routes[True][4], routes[False][4]))
    warm_ms = max(r[3] for r in routes.values())
    timeout = max(ELASTIC_TIMEOUT_FLOOR_S, 20 * warm_ms / 1e3)
    root = tempfile.mkdtemp(prefix="elastic_")
    emit(phase="elastic_setup", card=smi, warm_step_ms={
        "fused": routes[True][3], "codec": routes[False][3]},
         step_timeout_s=timeout, hang_s=timeout + 1.0,
         codec_route_masters_equal_fused=codec_equals_fused,
         disk_free_gb=_disk_free_gb(root), ckpt_dir=root)
    ecfg = ElasticConfig(step_timeout_s=timeout, max_retries=3,
                         backoff_s=0.01, ckpt_every=ELASTIC_CKPT_EVERY,
                         ckpt_keep_last=2, ckpt_mirror=True)
    launches_all = {name: 0 for name in kernels}
    cells = {}
    chaos.install_collective_tap()
    try:
        for kind, site, mode in ELASTIC_CELLS:
            fused = site != "collective"
            tr, st0, batch, _, ref = routes[fused]
            plan = chaos.FaultPlan([chaos.FaultSpec(
                kind, site, step=3, mode=mode,
                duration_s=timeout + 1.0 if kind == "hang" else 0.2)],
                seed=11)
            d = os.path.join(root, f"{kind}@{site}")
            for k in kernels.values():
                k.launches = 0
            sync(dev)
            t0 = time.perf_counter()
            with chaos.activate(plan):
                et = ElasticTrainer(tr, d, ecfg, plan=plan,
                                    stage_fn=plan.stage)
                st, metrics = et.run(st0, lambda i: batch, ELASTIC_STEPS)
            sync(dev)
            wall = time.perf_counter() - t0
            launches = {name: k.launches for name, k in kernels.items()}
            t0 = time.perf_counter()
            alive = et.join(60.0)
            join_s = time.perf_counter() - t0
            rec = et.profiler.recovery.as_dict()
            equal = bool(torch.equal(st.w_own, ref))
            save = dict(et.ckpt.last_save)
            cell = {"fired": [(f.kind, f.site, f.step) for f in plan.fired],
                    "faults": rec["faults"], "recoveries": rec["recoveries"],
                    "restores": rec["checkpoint_restores"],
                    "mttr_mean_s": rec["mttr_mean_s"],
                    "mttr_max_s": rec["mttr_max_s"], "wall_s": wall,
                    "join_s": join_s, "threads_alive": alive,
                    "route": "fused" if fused else "codec",
                    "masters_bitequal": equal, "step": st.step,
                    "loss": float(metrics["loss"]), "last_save_s": save,
                    "ckpt_bytes": _dir_bytes(d), "launches": launches}
            cells[f"{kind}@{site}"] = cell
            emit(phase="elastic_path", cell=f"{kind}@{site}", card=smi,
                 **cell)
            for name, v in launches.items():
                launches_all[name] += v
            shutil.rmtree(d, ignore_errors=True)
            path_kernels = (("ring_rs_update", "ring_ag") if fused else
                            ("bfp_encode", "bfp_decode"))
            bad = [n for n in path_kernels if launches[n] == 0]
            if (len(plan.fired) != 1 or not equal or alive
                    or st.step != ELASTIC_STEPS or bad
                    or (rec["faults_total"] != 0) == (kind == "slowdown")
                    or (kind != "slowdown"
                        and rec["checkpoint_restores"] < 1)):
                raise AssertionError(f"elastic_path {kind}@{site}: {cell}")
    finally:
        chaos.uninstall_collective_tap()
        shutil.rmtree(root, ignore_errors=True)
    emit(phase="elastic_path_total", card=smi,
         wall_s=time.perf_counter() - t_phase, launches=launches_all)
    fused_tr, st0, batch, _, _ = routes[True]
    return {"launches": launches_all, "cells": cells,
            "trainer": (fused_tr, st0, batch), "timeout": timeout}


def durability_path(dev, kernels, trainer, mcfg, sgd, bx, by, smi) -> dict:
    """The durability plane on the main path's full-width state (dp=8:
    w_own 41,975,808 f32, 167.9 MB; a mirrored step 335.8 MB), with
    ``shards=8`` and ``mirror=True``: the audit clean; a flipped stored
    bit of a primary shard repaired bit-exact from its peer; primary and
    mirror both flipped refused; a stale manifest walked back; ``kill``
    and ``diskfull`` at ``ckpt.save`` leaving exactly the previous
    verified step; an emergency dump flagged; a ``BFPConfig()``-
    compressed save's size ratio and its roundtrip error within JAX's
    bound (``tests/test_checkpoint.py:18``); the state restored at dp=8
    takes a step bit-equal to the uninterrupted run's, and a restore at
    dp=4 (``repad_flat``) takes a finite step.  Each save's seconds split
    into host pull, encode, checksums and write."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.runtime import chaos
    from fpga_ai_nic_tpu_torch.utils import checkpoint as ckpt
    from fpga_ai_nic_tpu_torch.utils.config import (BFPConfig, MeshConfig,
                                                    TrainConfig)
    t_phase = time.perf_counter()
    tr, st0, batch = trainer
    for k in kernels.values():
        k.launches = 0
    s2, s3 = _plain_steps(tr, st0, batch, 3)[1:]
    sync(dev)
    want = s2.w_own.reshape(-1).cpu().numpy()
    root = tempfile.mkdtemp(prefix="durability_")
    out = {"disk_free_gb": _disk_free_gb(root)}
    checks = {}
    try:
        d = os.path.join(root, "mirrored")
        c = ckpt.Checkpointer(d, shards=8, mirror=True, keep_last=2)
        c.save(2, s2)
        out["save_s"] = dict(c.last_save)
        out["step_bytes"] = _dir_bytes(c._path(2))
        t0 = time.perf_counter()
        checks["audit_clean"] = c.audit_step(2).ok
        out["audit_s"] = time.perf_counter() - t0
        ckpt.flip_stored_bit(_shard_file(c, 2, 3), byte_off=4 * 12345)
        t0 = time.perf_counter()
        rep = c.audit_step(2, repair=True)
        out["repair_s"] = time.perf_counter() - t0
        checks["repaired_bitexact"] = (
            len(rep.repaired) == 1 and rep.repair_wire_bytes ==
            want.nbytes // 8
            and np.array_equal(c.restore(2)["w_own"], want))
        out["repair_wire_bytes"] = rep.repair_wire_bytes
        c.save(3, s3)
        shutil.copyfile(os.path.join(c._path(2), ckpt.MANIFEST_FILE),
                        os.path.join(c._path(3), ckpt.MANIFEST_FILE))
        step, tree = c.restore_latest_verified()
        checks["stale_manifest_walks_back"] = (
            step == 2 and np.array_equal(tree["w_own"], want))
        for mirror in (False, True):
            ckpt.flip_stored_bit(_shard_file(c, 2, 5, mirror))
        try:
            c.restore(2)
            checks["double_corruption_refused"] = False
        except ckpt.CheckpointIntegrityError:
            checks["double_corruption_refused"] = True
        shutil.rmtree(d)
        # save interrupts: the op stream cut at half its ops
        for kind in ("kill", "diskfull"):
            plan = chaos.FaultPlan([chaos.FaultSpec(kind, "ckpt.save", step=3,
                                                    fraction=0.5)])
            d = os.path.join(root, kind)
            c = ckpt.Checkpointer(d, shards=8, mirror=True, keep_last=2,
                                  chaos=plan)
            c.save(2, s2)
            plan.begin_step(3)
            try:
                c.save(3, s3)
                raised = None
            except (chaos.InjectedFault, OSError) as err:
                raised = type(err).__name__
            c2 = ckpt.Checkpointer(d, shards=8, mirror=True)
            checks[f"{kind}_leaves_previous_step"] = (
                raised is not None and len(plan.fired) == 1
                and c2.latest_step(verified=True) == 2
                and np.array_equal(c2.restore(2)["w_own"], want))
            out[f"{kind}_raised"] = raised
            if kind == "kill":
                # an emergency dump over the leftovers
                c2.save(3, s3, emergency=True)
                checks["emergency_flagged"] = (
                    c2.is_emergency(3) and c2.audit_step(3).ok
                    and c2.latest_step(verified=True) == 3)
            shutil.rmtree(d)
        # one compressed save
        d = os.path.join(root, "bfp")
        c = ckpt.Checkpointer(d, compress=BFPConfig())
        c.save(2, s2)
        out["compressed_save_s"] = dict(c.last_save)
        comp = _dir_bytes(c._path(2))
        got = c.restore(2)["w_own"]
        err = float(np.abs(got - want).max())
        lim = 2 ** -6 * max(float(np.abs(want).max()), 1e-9) * 2
        out.update(compressed_bytes=comp,
                   compressed_ratio=comp / want.nbytes,
                   compressed_max_abs_err=err, compressed_err_bound=lim)
        checks["compressed_within_bound"] = err <= lim
        shutil.rmtree(d)
        # restores that train: dp=8 bit-equal, dp=4 finite
        payload = {"w_own": want, "opt_state": {}, "step": np.int32(2)}
        t0 = time.perf_counter()
        back = tr.restore_state(payload)
        sync(dev)
        out["restore_state_s"] = time.perf_counter() - t0
        got3, _ = tr.step(back, batch)
        checks["restored_step_bitequal"] = bool(torch.equal(got3.w_own,
                                                            s3.w_own))
        del back, got3
        cfg4 = TrainConfig(global_batch=5376, mesh=MeshConfig(dp=4),
                           collective=tr.cfg.collective, optimizer=sgd)
        tr4 = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                        VirtualRanks(4, dev), cfg4)
        st4 = tr4.restore_state(payload, params_like=mlp.init(
            torch.Generator().manual_seed(0), mcfg, "cpu"))
        st4, diag = tr4.step(st4, tr4.shard_batch((bx, by)))
        out["dp4_padded_len"] = tr4._meta.padded_len
        out["dp4_loss"] = float(diag["loss"])
        checks["dp4_step_finite"] = bool(
            math.isfinite(out["dp4_loss"])
            and torch.isfinite(st4.w_own).all())
        del st4, tr4
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sync(dev)
    launches = {name: k.launches for name, k in kernels.items()}
    emit(phase="durability_path", card=smi, checks=checks,
         wall_s=time.perf_counter() - t_phase, launches=launches, **out)
    if not all(checks.values()) or launches["ring_rs_update"] == 0 \
            or launches["ring_ag"] == 0:
        raise AssertionError(f"durability_path: {checks} {launches}")
    return {"launches": launches, "checks": checks, **out}


SERVE_CHAOS_REQUESTS = 8


def _judge_streams(dev, cfg, params, prompts, want, got) -> dict:
    """Each stream against the fault-free engine's: equal, or diverging
    only at a token whose fault-free top-2 margin (the contiguous
    forward's logits at that point) is under ``PARITY_TIE_MARGIN``."""
    import torch
    from fpga_ai_nic_tpu_torch.models import llama_decode
    equal, diverged = 0, []
    for p, ref, gen in zip(prompts, want, got):
        if gen == ref:
            equal += 1
            continue
        k = next(i for i, (a, b) in enumerate(zip(ref, gen)) if a != b)
        ctx = torch.cat([torch.from_numpy(p).to(dev),
                         torch.tensor(ref[:k], dtype=torch.int32,
                                      device=dev)])
        cache = llama_decode.init_cache(cfg, 1, len(ctx), device=dev)
        logits, _ = llama_decode.forward(params, ctx[None], cache, 0, cfg)
        top2 = logits[0, -1].float().topk(2).values
        diverged.append({"at": k, "got": gen[k], "want": ref[k],
                         "margin": float(top2[0] - top2[1])})
        del cache, logits
    return {"equal": equal, "diverged": diverged,
            "ok": all(d["margin"] < PARITY_TIE_MARGIN for d in diverged)}


PARITY_TIE_MARGIN = 0.1


def serve_chaos_path(dev, cfg, scfg, params, kernels, smi) -> dict:
    """The serving phase's engine (Llama-3-8B, 32 layers, its config with
    ``page_integrity=True``, its weights) on 8 requests: fault-free, then
    under a plan at ``serve.step`` — a hang past ``step_timeout_s``, an
    exception, a preemption, a ``wirebit`` corruption of the pool (the
    page ledger trips) and a ``nan`` one (with the ledger on, the ledger
    trips first) — then a ``nan`` corruption with the ledger off (the
    logit guard trips).  ``step_timeout_s`` stands 10x above the slowest
    warm fault-free tick (2 s at least); tick 0 of each run is clean.  Streams are judged
    against the fault-free engine's (``_judge_streams``: a replayed
    request re-prefills its tokens in another GEMM shape, so a bf16 near
    tie may flip).  Every watchdog thread is joined before the phase
    ends."""
    import torch
    from fpga_ai_nic_tpu_torch import serve_llama
    from fpga_ai_nic_tpu_torch.runtime import chaos
    from fpga_ai_nic_tpu_torch.serve import ServeEngine
    t_phase = time.perf_counter()
    prompts = serve_llama.make_prompts(SERVE_SEED + 3, SERVE_CHAOS_REQUESTS,
                                       PROMPT_MIN, PROMPT_MAX, cfg.vocab)
    eng = ServeEngine(params, cfg, scfg, device=dev)
    ref = [eng.submit(p, MAX_NEW) for p in prompts]
    sync(dev)
    t0 = time.perf_counter()
    s0 = eng.run()
    sync(dev)
    free_wall = time.perf_counter() - t0
    ticks_ms = [e["dur_ns"] / 1e6 for e in eng.profiler.events.snapshot()
                if e["name"] == "serve.tick" and "dur_ns" in e]
    # the slowest warm tick (the first may still load a kernel library)
    tick_max_ms = max(ticks_ms[1:])
    want = [list(r.generated) for r in ref]
    eng.pool = []
    del eng
    timeout = max(2.0, 10 * tick_max_ms / 1e3)
    runs = {}
    for label, pi, specs in (
            ("ledger_on", True, [
                chaos.FaultSpec("hang", "serve.step", step=2,
                                duration_s=timeout + 1.5),
                chaos.FaultSpec("exception", "serve.step", step=4),
                chaos.FaultSpec("preemption", "serve.step", step=6),
                chaos.FaultSpec("corruption", "serve.step", step=8,
                                mode="wirebit"),
                chaos.FaultSpec("corruption", "serve.step", step=10,
                                mode="nan")]),
            ("ledger_off", False, [
                chaos.FaultSpec("corruption", "serve.step", step=3,
                                mode="nan")])):
        plan = chaos.FaultPlan(specs, seed=9)
        eng = ServeEngine(params, cfg, dataclasses.replace(
            scfg, page_integrity=pi, step_timeout_s=timeout, backoff_s=0.0),
            device=dev, chaos=plan)
        reqs = [eng.submit(p, MAX_NEW) for p in prompts]
        for k in kernels.values():
            k.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        with chaos.activate(plan):
            s = eng.run()
        sync(dev)
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        t0 = time.perf_counter()
        alive = eng.join_watchdog(60.0)
        join_s = time.perf_counter() - t0
        judged = _judge_streams(dev, cfg, params, prompts, want,
                                [list(r.generated) for r in reqs])
        run = {"fired": [(f.kind, f.step, f.mode) for f in plan.fired],
               "faults": s["recovery"]["faults"],
               "recoveries": s["serve_recoveries"],
               "mttr_mean_s": s["recovery"]["mttr_mean_s"],
               "page_trips": s["page_trips"],
               "logit_trips": s["logit_trips"], "ticks": s["ticks"],
               "wall_s": wall, "join_s": join_s, "threads_alive": alive,
               "streams_equal": judged["equal"],
               "streams_diverged_at_near_tie": judged["diverged"],
               "launches": launches}
        runs[label] = run
        emit(phase="serve_chaos_path", run=label, card=smi,
             page_integrity=pi, step_timeout_s=timeout,
             tick_max_fault_free_ms=tick_max_ms,
             fault_free_wall_s=free_wall, fault_free_ticks=s0["ticks"], **run)
        eng.pool = []
        del eng
        torch.cuda.empty_cache()
        trips_ok = ((s["page_trips"] >= 2 and s["logit_trips"] == 0) if pi
                    else (s["logit_trips"] >= 1 and s["page_trips"] == 0))
        if (len(plan.fired) != len(specs) or alive or not judged["ok"]
                or s["serve_recoveries"] != len(
                    [f for f in specs if f.kind != "slowdown"])
                or not trips_ok or launches["paged_attend"] == 0
                or (pi and launches["row_checksums"] == 0)):
            raise AssertionError(f"serve_chaos_path {label}: {run}")
    emit(phase="serve_chaos_total", wall_s=time.perf_counter() - t_phase)
    return {"launches": {k: sum(r["launches"][k] for r in runs.values())
                         for k in kernels}, "runs": runs}


CKPT_DRIVER_ARGV = ["--model=tiny", "--model.vocab=384",
                    "--model.attn_block=128", "--seq=128",
                    "--global_batch=4", "--mesh.dp=2", "--iters=2",
                    "--collective.impl=ring",
                    "--collective.compression.codec=pallas",
                    "--collective.fused_kernel=true"]


def ckpt_driver_path(dev, kernels, smi) -> dict:
    """``train_llama --save=`` at the tiny config on the card (f32, head
    dim 16: the second flash family; the BFP ring kernels), launches
    counted over the driver's run; the saved step's audit clean; then
    ``generate_llama --ckpt=`` on the card, whose continuation must equal
    ``generate()`` on the restored parameters in this process."""
    import shutil
    import tempfile
    import torch
    from fpga_ai_nic_tpu_torch import generate_llama, train_llama
    from fpga_ai_nic_tpu_torch.models import llama_decode
    from fpga_ai_nic_tpu_torch.utils import checkpoint as ckpt
    d = tempfile.mkdtemp(prefix="ckpt_driver_")
    try:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = train_llama.main(CKPT_DRIVER_ARGV + [f"--save={d}"])
        sync(dev)
        train_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        c = ckpt.Checkpointer(d)
        audit = c.audit_step(c.latest_step())
        t0 = time.perf_counter()
        gen = generate_llama.main([f"--ckpt={d}"])
        gen_s = time.perf_counter() - t0
        opts = generate_llama.parse([f"--ckpt={d}"])
        cfg = opts["cfg"]
        params = generate_llama.restore_params(d, cfg, dev)
        from fpga_ai_nic_tpu_torch import text
        tok = text.ByteTokenizer()
        ids = torch.tensor([[tok.bos_id] + tok.encode(opts["prompt"])],
                           dtype=torch.int32, device=dev)
        again = llama_decode.generate(params, ids, opts["new"], cfg)
        direct = again[0, ids.shape[1]:].tolist()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    checks = {"audit_clean": audit.ok,
              "continuation_equals_generate": direct == gen[
                  "continuation_ids"],
              "finite": math.isfinite(out["loss_last"]),
              "ring_kernels_launched": launches["ring_rs_update"] > 0
              and launches["ring_ag"] > 0,
              "flash_launched": any(launches[n] > 0 for n in launches
                                    if n.startswith("flash"))}
    emit(phase="ckpt_driver_path", card=smi, argv=CKPT_DRIVER_ARGV,
         train_s=train_s, generate_s=gen_s, loss_last=out["loss_last"],
         checkpoint=os.path.basename(out["checkpoint"]),
         process=out["process"], continuation_ids=gen["continuation_ids"],
         launches=launches, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"ckpt_driver_path: {checks}")
    return {"launches": launches}


# -- A.8's live reshard tier and A.9's observability (the MLP cell) ---------

RESHARD_LIVE = 41_963_520             # MLPConfig()'s live elements
RESHARD_JAX_PADDED = 41_963_520       # the JAX package's padded_len, n=8/4/2
RESHARD_JAX_BYTES = {                 # (wire, seed) of its plans there
    "main 8->4": (146_872_320, 0), "adamw 8->4": (440_616_960, 0),
    "shrink 4->2": (125_890_560, 0), "grow 4->8": (0, 146_872_320)}
RESHARD_REPS = 5                      # timed transfers a turn
# one flipped word: the odd word weights guarantee a single corrupted
# word is seen; several +-2 flips can cancel in the weighted sum (a
# 40-word flip of one AdamW segment did, on the CPU rehearsal)
RESHARD_FLIP = 1e-9


def _mlp_dp(dev, mcfg, n, coll, opt, bx, by, obs=False):
    """A DPTrainer on the MLP cell at dp=n (batch 5376) and its batch."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import MeshConfig, TrainConfig
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg), VirtualRanks(n, dev),
                   TrainConfig(global_batch=5376, mesh=MeshConfig(dp=n),
                               collective=coll, optimizer=opt,
                               obs_metrics=obs))
    st = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg, dev))
    return tr, st, tr.shard_batch((bx, by))


def _host_state(st) -> dict:
    """Copies of what a move reads (the move releases its sources)."""
    return {"w_own": st.w_own.clone(), "step": int(st.step),
            "opt_state": {k: v.clone() for k, v in st.opt_state.items()},
            "codec_state": (None if st.codec_state is None
                            else st.codec_state.clone())}


def _restored(tr_tgt, tr_src, host):
    """The same logical state built at the target width by the restore
    path (``repad_flat``), the native twin of a move."""
    from fpga_ai_nic_tpu_torch.ops import fused_update
    return tr_tgt.restore_state(
        {"w_own": host["w_own"].reshape(-1), "step": host["step"],
         "opt_state": {k: v.reshape(-1)
                       for k, v in host["opt_state"].items()}},
        params_like=fused_update.params_like_from_meta(tr_src._meta))


def _clone_state(tr, host):
    """A state of ``tr`` (the source) from copies of ``host``, to be moved
    (the move releases them; ``restore_state`` keeps a card tensor it is
    given)."""
    st = _restored(tr, tr, {
        "w_own": host["w_own"].clone(), "step": host["step"],
        "opt_state": {k: v.clone() for k, v in host["opt_state"].items()}})
    if host["codec_state"] is not None:
        st = st._replace(codec_state=host["codec_state"].clone())
    return st


def _move(dev, name, tr_s, tr_t, st, host, smi, native=None,
          golden_resid=None) -> dict:
    """One move at full width: the transfer timed against its bound with
    integrity off and on in turns, a wirebit at ``reshard.transfer``
    tripping the checked transfer, then the donated move itself (peak
    memory, the wire and seed counters against the plan), its leaves
    bit-equal to ``native``'s (the restore path's) and the residual to
    the host golden."""
    import numpy as np
    import torch
    from fpga_ai_nic_tpu_torch.parallel import reshard as rs
    from fpga_ai_nic_tpu_torch.runtime import chaos
    plan = rs.plan_for(tr_s, tr_t)
    names = list(tr_s.reshard_leaves(st))
    leaves = [dict(w_own=host["w_own"], **{
        f"opt.{k}": v for k, v in host["opt_state"].items()})[k]
        for k in names]
    resid = host["codec_state"]
    times = {False: [], True: []}
    for integ in (False, True, True, False):
        times[integ].append(cuda_ms(lambda: rs.transfer(
            plan, leaves, resid, integrity=integ), RESHARD_REPS))
    ms, ms_chk = (min(times[False]), min(times[True]))
    resid_bytes = 0 if plan.residual is None else 4 * RESHARD_LIVE * (
        plan.flat.n_src + plan.flat.n_tgt)
    b_ms, b_by = bound(plan.n_flat_leaves * 2 * 4 * RESHARD_LIVE
                       + resid_bytes, 0)
    # the exact tier: one flipped bit on a segment's wire trips it
    chaos.install_wire_tap()
    tripped = False
    try:
        fp = chaos.FaultPlan([chaos.FaultSpec(
            "corruption", "reshard.transfer", step=0, mode="wirebit",
            fraction=RESHARD_FLIP)], seed=5)
        with chaos.activate(fp):
            fp.begin_step(0)
            try:
                rs.reshard_state(tr_s, tr_t, _clone_state(tr_s, host),
                                 integrity=True)
            except chaos.WireIntegrityError:
                tripped = len(fp.fired) == 1
    finally:
        chaos.uninstall_wire_tap()
    gc.collect()
    sync(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rs.reset_wire_counters()
    moved = rs.reshard_state(tr_s, tr_t, st)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    wire = dict(rs.WIRE)
    jax_plan = rs.make_plan(RESHARD_LIVE, plan.flat.n_src,
                            RESHARD_JAX_PADDED, plan.flat.n_tgt,
                            RESHARD_JAX_PADDED,
                            n_flat_leaves=plan.n_flat_leaves,
                            residual=plan.residual is not None)
    checks = {"wire_counter": wire["bytes"] == plan.wire_bytes(),
              "seed_counter": wire["seed_bytes"] == plan.seed_bytes(),
              "tripped": tripped,
              "donated": not chaos.state_buffers_alive(st)}
    if name in RESHARD_JAX_BYTES:
        checks["jax_layout_bytes"] = (
            (jax_plan.wire_bytes(), jax_plan.seed_bytes())
            == RESHARD_JAX_BYTES[name])
    if native is not None:
        checks["masters_bitequal"] = bool(torch.equal(moved.w_own,
                                                      native.w_own))
        checks["moments_bitequal"] = all(
            torch.equal(moved.opt_state[k], native.opt_state[k])
            for k in native.opt_state)
        checks["replicas_bitequal"] = bool(torch.equal(moved.replicas,
                                                       native.replicas))
    if golden_resid is not None:
        checks["residual_equals_golden"] = bool(np.array_equal(
            moved.codec_state.cpu().numpy(), golden_resid))
    row = {"move": name, "n_src": plan.flat.n_src, "n_tgt": plan.flat.n_tgt,
           "leaves": names, "residual": plan.residual is not None,
           "padded_src": plan.flat.padded_src,
           "padded_tgt": plan.flat.padded_tgt,
           "wire_bytes": plan.wire_bytes(), "seed_bytes": plan.seed_bytes(),
           "counted": wire, "jax_layout_wire_bytes": jax_plan.wire_bytes(),
           "jax_layout_seed_bytes": jax_plan.seed_bytes(),
           "transfer_ms": ms, "transfer_ms_turns": times[False],
           "integrity_ms": ms_chk, "integrity_ms_turns": times[True],
           "integrity_overhead": ms_chk / ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_ms_per_leaf": bound(2 * 4 * RESHARD_LIVE,
                                                        0)[0],
           "peak_gb": peak / 1e9, "before_gb": before / 1e9,
           "peak_over_before_gb": (peak - before) / 1e9, "checks": checks}
    emit(phase="reshard_path", card=smi, **row)
    if not all(checks.values()):
        raise AssertionError(f"reshard_path {name}: {checks}")
    return moved


def reshard_path(dev, kernels, mcfg, sgd, bx, by, smi) -> dict:
    """A.8's live reshard at the MLP cell's full width, one card: the main
    trainer (dp=8, fused BFP ring kernels, SGD lr 0.1) two steps, moved to
    dp=4, held against the same state built at dp=4 by the restore path
    (masters and replicas bit-equal), a third step on each (masters and
    loss bit-equal); fused AdamW (three leaves) and int8 with error
    feedback (the residual against the golden on the host) moved 8 -> 4;
    the moved dp=4 state shrunk to 2 and grown to 8.  Each move: the
    transfer by CUDA events against its bytes bound, with integrity off
    and on in turns, a tripped wirebit, peak memory, and the wire counter
    equal to the plan's bytes.  The plans' bytes at the JAX package's
    layout (41,963,520 at n=8/4/2) are checked beside the port's (the
    fused kernels pad the chunks to whole (16, 128) tiles)."""
    import torch
    from fpga_ai_nic_tpu_torch.parallel import reshard as rs
    from fpga_ai_nic_tpu_torch.utils.config import (
        BFPConfig, CollectiveConfig, OptimizerConfig)
    t_phase = time.perf_counter()
    fused = CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                             fused_kernel=True, fused_optimizer=True)
    _zero(kernels)
    tr8, st, b8 = _mlp_dp(dev, mcfg, 8, fused, sgd, bx, by)
    for _ in range(2):
        st, _ = tr8.step(st, b8)
    tr4, _, b4 = _mlp_dp(dev, mcfg, 4, fused, sgd, bx, by)
    host = _host_state(st)
    native = _restored(tr4, tr8, host)
    moved = _move(dev, "main 8->4", tr8, tr4, st, host, smi, native=native)
    del st, host
    s_m, l_m = tr4.step(moved, b4)
    s_n, l_n = tr4.step(native, b4)
    third = {"masters_bitequal": bool(torch.equal(s_m.w_own, s_n.w_own)),
             "loss_bitequal": float(l_m) == float(l_n),
             "loss": float(l_m)}
    launches_main = {k: v.launches for k, v in kernels.items()}
    emit(phase="reshard_third_step", card=smi, **third,
         launches=launches_main)
    if not (third["masters_bitequal"] and third["loss_bitequal"]):
        raise AssertionError(f"reshard_path third step: {third}")
    del moved, native, s_n
    moves = {}
    # fused AdamW + BFP: three leaves
    adamw = OptimizerConfig(kind="adamw", learning_rate=1e-4)
    tra, sa, ba = _mlp_dp(dev, mcfg, 8, fused, adamw, bx, by)
    sa, _ = tra.step(sa, ba)
    tra4 = _mlp_dp(dev, mcfg, 4, fused, adamw, bx, by)[0]
    host = _host_state(sa)
    moves["adamw"] = _move(dev, "adamw 8->4", tra, tra4, sa, host, smi,
                           native=_restored(tra4, tra, host))
    del sa, host, moves["adamw"], tra, tra4, ba
    gc.collect()
    # int8 with error feedback (the sublane kernels, unfused ring): the
    # residual against the golden twin on the host
    i8 = CollectiveConfig(impl="ring", codec="int8", codec_opts=(
        ("error_feedback", True), ("backend", "pallas")))
    tri, si, bi = _mlp_dp(dev, mcfg, 8, i8, sgd, bx, by)
    for _ in range(2):
        si, _ = tri.step(si, bi)
    tri4 = _mlp_dp(dev, mcfg, 4, i8, sgd, bx, by)[0]
    host = _host_state(si)
    golden = rs.golden_redistribute_residual(
        host["codec_state"].cpu().numpy(), RESHARD_LIVE, 4,
        tri4._meta.padded_len)
    moves["int8"] = _move(dev, "int8-ef 8->4", tri, tri4, si, host, smi,
                          native=_restored(tri4, tri, host),
                          golden_resid=golden)
    del si, host, golden, moves["int8"], tri, tri4, bi
    gc.collect()
    # the stepped dp=4 state, shrunk to 2 and grown to 8
    host4 = _host_state(s_m)
    tr2 = _mlp_dp(dev, mcfg, 2, fused, sgd, bx, by)[0]
    _move(dev, "shrink 4->2", tr4, tr2, s_m, host4, smi,
          native=_restored(tr2, tr4, host4))
    tr8g = _mlp_dp(dev, mcfg, 8, fused, sgd, bx, by)[0]
    grown = _move(dev, "grow 4->8", tr4, tr8g, _clone_state(tr4, host4),
                  host4, smi, native=_restored(tr8g, tr4, host4))
    live = host4["w_own"].reshape(-1)[:RESHARD_LIVE]
    exact = bool(torch.equal(grown.w_own.reshape(-1)[:RESHARD_LIVE], live))
    launches = {k: v.launches for k, v in kernels.items()}
    emit(phase="reshard_path_total", card=smi, grow_value_exact=exact,
         wall_s=time.perf_counter() - t_phase, launches=launches)
    if not exact:
        raise AssertionError("reshard_path: the grow is not value-exact")
    del grown, s_m, host4
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


def _plain_widths(dev, mcfg, sgd, bx, by, factory, widths, steps):
    """Masters of a run that trains ``widths[i]`` ranks for ``steps[i]``
    steps, moving between them through the restore path."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    tr = factory(widths[0])
    st = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg, dev))
    for i, (n, k) in enumerate(zip(widths, steps)):
        if i:
            nxt = factory(n)
            st = _restored(nxt, tr, _host_state(st))
            tr = nxt
        batch = tr.shard_batch((bx, by))
        for _ in range(k):
            st, _ = tr.step(st, batch)
    return st.w_own


def elastic_reshard_path(dev, kernels, mcfg, sgd, bx, by, smi) -> dict:
    """The MLP cell under ``ElasticTrainer`` with ``ReshardPolicy(factory,
    shrink_to=(4, 2))``, prewarmed, integrity on (the main path's fused BFP
    ring kernels, SGD lr 0.1, checkpoints every 2 steps, mirrored): a
    preemption at step 2 recovers by reshard to dp=4 with no checkpoint
    read, a second at step 4 re-arms onto dp=2; the final masters
    bit-equal to a run stepping natively at the same widths.  Then the
    same seeded preemption under the reshard tier and under the restore
    tier, in turns (MTTR of both), and a wirebit at ``reshard.transfer``
    falling through to the restore tier (masters equal to the fault-free
    steps)."""
    import shutil
    import tempfile
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.elastic import (
        ElasticConfig, ElasticTrainer, ReshardPolicy)
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.runtime import chaos
    from fpga_ai_nic_tpu_torch.utils.config import (
        BFPConfig, CollectiveConfig, MeshConfig, TrainConfig)
    t_phase = time.perf_counter()
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                            fused_kernel=True, fused_optimizer=True,
                            integrity_check=True)

    def factory(n):
        return DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg),
                         VirtualRanks(n, dev),
                         TrainConfig(global_batch=5376, mesh=MeshConfig(dp=n),
                                     collective=coll, optimizer=sgd))

    tr8 = factory(8)
    st0 = tr8.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg, dev))
    batch = tr8.shard_batch((bx, by))
    tr8.step(st0, batch)                          # warm
    ecfg = ElasticConfig(step_timeout_s=ELASTIC_TIMEOUT_FLOOR_S * 2,
                         max_retries=3, backoff_s=0.01, ckpt_every=2,
                         ckpt_keep_last=2, ckpt_mirror=True)
    root = tempfile.mkdtemp(prefix="elastic_reshard_")
    launches_all = {name: 0 for name in kernels}

    def run(tag, specs, n_steps, shrink_to=None, taps=False):
        plan = chaos.FaultPlan(specs, seed=11)
        d = os.path.join(root, tag)
        pol = (ReshardPolicy(factory, shrink_to=shrink_to)
               if shrink_to is not None else None)
        if taps:
            chaos.install_wire_tap()
        try:
            with chaos.activate(plan):
                et = ElasticTrainer(tr8, d, ecfg, plan=plan, reshard=pol)
                t0 = time.perf_counter()
                et.prewarm_reshard(st0, batch)
                prewarm_s = time.perf_counter() - t0
                _zero(kernels)
                sync(dev)
                t0 = time.perf_counter()
                st, _ = et.run(st0, lambda i: batch, n_steps)
                sync(dev)
                wall = time.perf_counter() - t0
        finally:
            if taps:
                chaos.uninstall_wire_tap()
        launches = {k: v.launches for k, v in kernels.items()}
        for k, v in launches.items():
            launches_all[k] += v
        rec = et.profiler.recovery.as_dict()
        out = {"fired": [(f.kind, f.site, f.step) for f in plan.fired],
               "faults": rec["faults"], "reshards": rec["reshards"],
               "restores": rec["checkpoint_restores"],
               "mttr_reshard_s": rec["mttr_reshard_mean_s"],
               "mttr_restore_s": rec["mttr_restore_mean_s"],
               "width": et.trainer.n, "step": st.step, "wall_s": wall,
               "prewarm_s": prewarm_s, "launches": launches,
               "reshard_failed": sum(
                   e["name"] == "reshard.failed"
                   for e in et.profiler.events.snapshot()),
               "threads_alive": et.join(60.0)}
        shutil.rmtree(d, ignore_errors=True)
        return st, out

    try:
        pre = [chaos.FaultSpec("preemption", "queue.issue", step=2),
               chaos.FaultSpec("preemption", "queue.issue", step=4)]
        st, ladder = run("ladder", pre, 6, shrink_to=(4, 2))
        want = _plain_widths(dev, mcfg, sgd, bx, by, factory, (8, 4, 2),
                             (2, 2, 2))
        ladder["masters_bitequal_native"] = bool(torch.equal(st.w_own,
                                                             want))
        del st, want
        emit(phase="elastic_reshard_path", cell="ladder (4, 2)", card=smi,
             **ladder)
        turns = []
        for tier in ("reshard", "restore", "reshard", "restore"):
            _, r = run(f"mttr_{len(turns)}", pre[:1], 4,
                       shrink_to=4 if tier == "reshard" else None)
            turns.append(dict(r, tier=tier))
            emit(phase="elastic_reshard_mttr", card=smi, **turns[-1])
        clean = _plain_widths(dev, mcfg, sgd, bx, by, factory, (8,), (4,))
        st, fall = run("wirebit", pre[:1] + [chaos.FaultSpec(
            "corruption", "reshard.transfer", step=2, mode="wirebit",
            fraction=RESHARD_FLIP)], 4, shrink_to=4, taps=True)
        fall["masters_bitequal_clean"] = bool(torch.equal(st.w_own, clean))
        del st, clean
        emit(phase="elastic_reshard_path", cell="wirebit@reshard.transfer",
             card=smi, **fall)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mttr = {t: [r[f"mttr_{t}_s"] for r in turns if r["tier"] == t]
            for t in ("reshard", "restore")}
    checks = {
        "ladder": (ladder["faults"] == {"shrinkable": 2}
                   and ladder["reshards"] == 2 and ladder["restores"] == 0
                   and ladder["width"] == 2 and ladder["step"] == 6
                   and ladder["masters_bitequal_native"]),
        "turns": all((r["reshards"], r["restores"]) == (
            (1, 0) if r["tier"] == "reshard" else (0, 1)) for r in turns),
        "fall_through": (fall["reshards"] == 0 and fall["restores"] == 1
                         and fall["reshard_failed"] == 1
                         and len(fall["fired"]) == 2 and fall["width"] == 8
                         and fall["masters_bitequal_clean"]),
        "threads_joined": not any(r["threads_alive"]
                                  for r in [ladder, fall] + turns)}
    emit(phase="elastic_reshard_path_total", card=smi, mttr_s=mttr,
         checks=checks, wall_s=time.perf_counter() - t_phase,
         launches=launches_all)
    if not all(checks.values()):
        raise AssertionError(f"elastic_reshard_path: {checks}")
    return {"launches": launches_all, "mttr": mttr}


OBS_STEPS = 3               # steps a turn (off, on, on, off)
TRACE_ARGV = QUEUE_MLP_ARGV + ["--iters=3"]


def _lanes(tl) -> dict:
    """Complete events a timeline lane ("process / thread" names)."""
    names, counts = {}, {}
    for e in tl["traceEvents"]:
        if e["ph"] == "M":
            key = (e["pid"], e.get("tid"))
            names[key] = e["args"]["name"]
    for e in tl["traceEvents"]:
        if e["ph"] not in ("X", "C", "i"):
            continue
        proc = names.get((e["pid"], None), str(e["pid"]))
        thread = names.get((e["pid"], e.get("tid")), str(e.get("tid")))
        lane = f"{proc} / {thread}"
        counts[lane] = counts.get(lane, 0) + 1
    return counts


def obs_path(dev, kernels, mcfg, sgd, bx, by, smi) -> dict:
    """A.9 on the MLP main path (dp=8, fused BFP ring kernels, SGD): steps
    with ``obs_metrics`` off and on in turns (ms/step of both, the launches
    off equal to the main path's, the masters after both bit-equal), the
    BFP codec's observed error within its declared bound (and int8's at
    dp=2); the on steps captured under ``torch.profiler`` inside a
    ``torch_profile`` span, the timeline written and parsed back (events a
    lane); ``train_mlp --trace-dir`` on the fused route and on
    ``--queue=explicit`` (each trace's summary); ``obs_demo`` on the
    card."""
    import shutil
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fpga_ai_nic_tpu_torch import obs_demo, train_mlp
    from fpga_ai_nic_tpu_torch.obs import metrics as obs_metrics
    from fpga_ai_nic_tpu_torch.obs import timeline
    from fpga_ai_nic_tpu_torch.utils import trace_analysis as ta
    from fpga_ai_nic_tpu_torch.utils.config import (
        BFPConfig, CollectiveConfig)
    from fpga_ai_nic_tpu_torch.utils.observability import Profiler
    t_phase = time.perf_counter()
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                            fused_kernel=True, fused_optimizer=True)
    runs = {}
    for obs in (False, True):
        tr, st, batch = _mlp_dp(dev, mcfg, 8, coll, sgd, bx, by, obs=obs)
        st, _ = tr.step(st, batch)                 # warm
        runs[obs] = [tr, st, batch]
    prof = Profiler()
    sink = obs_metrics.MetricsSink(events=prof.events,
                                   static=runs[True][0].obs_static_metrics())
    ms = {False: [], True: []}
    launches = {}
    root = tempfile.mkdtemp(prefix="obs_path_")
    trace_dir = os.path.join(root, "torch_trace")
    try:
        with obs_metrics.use_sink(sink):
            for turn, obs in enumerate((False, True, True, False)):
                tr, st, batch = runs[obs]
                _zero(kernels)
                capture = obs and turn == 2
                cm = (profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
                      if capture else None)
                sync(dev)
                with (prof.events.span(timeline.DEFAULT_ANCHOR_SPAN)
                      if capture else contextlib.nullcontext()):
                    with (cm if capture else contextlib.nullcontext()):
                        t0 = time.perf_counter()
                        for _ in range(OBS_STEPS):
                            with prof.bucket("step"):
                                st, loss = tr.step(st, batch)
                                float(loss)
                        sync(dev)
                        ms[obs].append(1e3 * (time.perf_counter() - t0)
                                       / OBS_STEPS)
                runs[obs][1] = st
                launches.setdefault(obs, {k: v.launches
                                          for k, v in kernels.items()})
                if capture:
                    os.makedirs(trace_dir, exist_ok=True)
                    cm.export_chrome_trace(os.path.join(
                        trace_dir, "obs_path.pt.trace.json"))
        latest = dict(sink.latest)
        events_path = prof.dump_events(os.path.join(root, "events.jsonl"))
        tl_path = timeline.write(os.path.join(root, "timeline.json"),
                                 timeline.build(events_jsonl=events_path,
                                                trace_dir=trace_dir))
        with open(tl_path) as f:
            tl = json.load(f)
        lanes = _lanes(tl)
        same = bool(torch.equal(runs[True][1].w_own, runs[False][1].w_own))
        bound_bfp = sink.static["declared_error_bound"]
        del runs
        gc.collect()
        torch.cuda.empty_cache()
        # int8 at dp=2 (the int8 path's layout), one step with metrics on
        i8 = CollectiveConfig(impl="ring", codec="int8", codec_opts=(
            ("backend", "pallas"),), fused_optimizer=True)
        tri, si, bi = _mlp_dp(dev, mcfg, 2, i8, sgd, bx, by, obs=True)
        sink8 = obs_metrics.MetricsSink(static=tri.obs_static_metrics())
        with obs_metrics.use_sink(sink8):
            tri.step(si, bi)
        int8 = {"codec_obs_rel_err": sink8.latest["codec_obs_rel_err"],
                "declared_error_bound":
                    sink8.static["declared_error_bound"]}
        del tri, si, bi
        gc.collect()
        torch.cuda.empty_cache()
        drivers = {}
        for route, extra in (("fused", []), ("explicit",
                                             ["--queue=explicit"])):
            d = os.path.join(root, f"trace_{route}")
            out = train_mlp.main(TRACE_ARGV + extra + [f"--trace-dir={d}"])
            drivers[route] = {"loss": out["loss"],
                              "samples_per_sec": out["samples_per_sec"],
                              "wall_s": out["wall_s"],
                              "trace_analysis": out["trace_analysis"],
                              "streams": {
                                  plane: r["n_streams"] for plane, r in
                                  ta.analyze_trace(d)["devices"].items()}}
            gc.collect()
            torch.cuda.empty_cache()
        demo = obs_demo.run(steps=3, out_dir=os.path.join(root, "demo"),
                            trace=True, device="cuda")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    per_step = {"ring_rs_update": 1, "ring_ag": 1}
    off_ok = all(launches[False][k] == OBS_STEPS * per_step.get(k, 0)
                 for k in launches[False])
    checks = {
        "launches_off_equal_main_path": off_ok,
        "masters_bitequal_on_off": same,
        "metric_keys": set(latest) == {"codec_obs_rel_err", "grad_norm",
                                       "loss"},
        "bfp_within_bound": 0 < latest["codec_obs_rel_err"] <= bound_bfp,
        "int8_within_bound": 0 < int8["codec_obs_rel_err"]
        <= int8["declared_error_bound"],
        "timeline_device_lane": tl["otherData"]["n_device_intervals"] > 0
        and tl["otherData"]["device_alignment"] == "anchored",
        "traces_summarized": all("error" not in r["trace_analysis"]
                                 for r in drivers.values()),
        "demo_device_intervals": demo["timeline"]["n_device_intervals"] > 0}
    emit(phase="obs_path", card=smi, steps_a_turn=OBS_STEPS,
         ms_per_step_off=ms[False], ms_per_step_on=ms[True],
         launches_off=launches[False], launches_on=launches[True],
         latest=latest, declared_error_bound=bound_bfp, int8=int8,
         timeline_other=tl["otherData"], timeline_lanes=lanes,
         drivers=drivers, demo_timeline=demo["timeline"],
         demo_latest=demo["metrics"]["latest"], checks=checks,
         wall_s=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise AssertionError(f"obs_path: {checks}")
    return {"launches": launches[True], "drivers": drivers}


HELPERS_GOLDEN_ELEMS = 1 << 20      # 4 MiB of f32 a rank: the host golden
HELPERS_REPS = 3                    # timed calls of each helper
HELPERS_MLP = {}                    # MLPConfig fields: the canonical MLP
HELPERS_BERT_ARGV = BERT_ARGV       # train_bert's BERT-base, BFP, dp=8
HELPERS_STE_ELEMS = 41_963_520      # the canonical MLP's live elements


def helpers_path(dev, kernels, smi) -> dict:
    """The public helpers that run the ring kernels, at full width:
    ``fused_update.all_reduce_mean`` of the canonical MLP's gradient tree
    (10 x 2048 x 2048 f32 and biases, dp=8, the main path's BFP collective
    config: one ``ring_rs_update`` and one ``ring_ag`` launch), bit-equal
    to the same call on the plain route on the card, and at 4 MiB a rank
    bit-equal to the numpy ring golden (sublane layout) / 8 on the host;
    ``bucketed.all_reduce_bucketed`` of BERT-base's gradient tree (bf16,
    dp=8, ``train_bert``'s BFP config: one launch of each a bucket), each
    leaf bit-equal to its segment of ``all_reduce_bucketed_flat`` under the
    same plan cast to the leaf dtype; ``bfp.bfp_ste`` at the MLP's flat
    width, the forward bit-equal to ``bfp_roundtrip`` and the gradient the
    incoming one bit for bit.  Each item's launch counts are zeroed just
    before its call and read just after; its ms is the call's, CUDA
    events around ``HELPERS_REPS`` calls."""
    import numpy as np
    import torch
    from fpga_ai_nic_tpu_torch import train_bert
    from fpga_ai_nic_tpu_torch.models import bert, mlp
    from fpga_ai_nic_tpu_torch.ops import bfp, bucketed, fused_update
    from fpga_ai_nic_tpu_torch.ops import ring_golden
    from fpga_ai_nic_tpu_torch.utils.config import (BFPConfig,
                                                    CollectiveConfig,
                                                    MLPConfig)
    n = 8
    cfg = BFPConfig(codec="pallas")
    coll = CollectiveConfig(impl="ring", compression=cfg, fused_kernel=True,
                            fused_optimizer=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {"launches": {name: 0 for name in kernels}}

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        res = fn()
        sync(dev)
        got = {name: k.launches for name, k in kernels.items()}
        for name, v in got.items():
            out["launches"][name] += v
        return res, got

    def stacked(shape, dtype=torch.float32):
        return (torch.randn((n,) + tuple(shape), generator=gen, device=dev)
                * 1e-2).to(dtype)

    # all_reduce_mean at the MLP's width, kernels against the plain route
    params = mlp.init(torch.Generator().manual_seed(0),
                      MLPConfig(**HELPERS_MLP), dev)
    tree = fused_update.tree_map(lambda p: stacked(p.shape), params)
    del params
    red, got = counted(lambda: fused_update.all_reduce_mean(tree, coll))
    if (got["ring_rs_update"], got["ring_ag"]) != (1, 1) or any(
            v for k, v in got.items() if k not in ("ring_rs_update",
                                                  "ring_ag")):
        raise AssertionError(f"all_reduce_mean: launches {got}")
    with plain_collectives():
        plain = fused_update.all_reduce_mean(tree, coll)
    require_equal("all_reduce_mean", list(zip(
        fused_update.tree_leaves(red), fused_update.tree_leaves(plain))))
    ms = cuda_ms(lambda: fused_update.all_reduce_mean(tree, coll),
                 HELPERS_REPS)
    with plain_collectives():
        plain_ms = cuda_ms(lambda: fused_update.all_reduce_mean(tree, coll),
                           1)
    elems = sum(t[0].numel() for t in fused_update.tree_leaves(tree))
    del tree, red, plain
    small = {"w": stacked((HELPERS_GOLDEN_ELEMS,))}
    red_small, got_small = counted(
        lambda: fused_update.all_reduce_mean(small, coll))
    meta = fused_update.flat_meta(fused_update.per_rank_tree(small), coll, n)
    rows = fused_update.flatten_rows(small, meta).cpu().numpy()
    want = ring_golden.ring_all_reduce(rows, cfg, layout="sublane") / n
    golden_equal = bool(np.array_equal(
        red_small["w"].cpu().numpy(), want[:, :HELPERS_GOLDEN_ELEMS]))
    if not golden_equal:
        raise AssertionError("all_reduce_mean at 4 MiB a rank differs from "
                             "the numpy ring golden")
    emit(phase="helpers_path", item="all_reduce_mean",
         model="MLP 10x2048x2048 f32", dp=n, elems_per_rank=elems, ms=ms,
         plain_ms=plain_ms, launches=got, plain_bitequal=True,
         golden_elems_per_rank=HELPERS_GOLDEN_ELEMS,
         golden_launches=got_small, golden_bitequal=golden_equal)
    out["all_reduce_mean"] = {"ms": ms, "plain_ms": plain_ms,
                              "launches": got}
    del small, red_small

    # all_reduce_bucketed on BERT-base's gradient tree
    bcfg, tcfg, _run = train_bert.parse(HELPERS_BERT_ARGV)
    bcoll = tcfg.collective
    shapes = bert.init(torch.Generator(device=dev).manual_seed(0), bcfg,
                       dev)
    grads = fused_update.tree_map(lambda p: stacked(p.shape, p.dtype),
                                  shapes)
    plan = bucketed.plan_buckets(shapes, bcoll, n)
    del shapes
    red, got = counted(lambda: bucketed.all_reduce_bucketed(grads, bcoll,
                                                            plan))
    nb = len(plan.buckets)
    if (got["ring_rs_update"], got["ring_ag"]) != (nb, nb):
        raise AssertionError(f"all_reduce_bucketed: launches {got}, "
                             f"{nb} buckets")
    leaves = fused_update.tree_leaves(grads)
    rows = bucketed.bucket_rows(plan, n, dev)
    for r in range(n):
        bucketed.bucket_locals([leaf[r] for leaf in leaves], plan,
                               [row[r] for row in rows])
    flat = bucketed.all_reduce_bucketed_flat(rows, bcoll, plan)
    pairs, off = [], 0
    for g, x in zip(fused_update.tree_leaves(red), leaves):
        size = x[0].numel()
        pairs.append((g, flat[:, off:off + size].reshape(x.shape)
                      .to(x.dtype)))
        off += size
    require_equal("all_reduce_bucketed", pairs)
    del flat, pairs, red
    ms = cuda_ms(lambda: bucketed.all_reduce_bucketed(grads, bcoll, plan),
                 HELPERS_REPS)
    emit(phase="helpers_path", item="all_reduce_bucketed",
         model="BERT-base gradients, bf16", dp=n, buckets=nb,
         elems_per_rank=sum(x[0].numel() for x in leaves), ms=ms,
         launches=got, flat_segments_bitequal=True)
    out["all_reduce_bucketed"] = {"ms": ms, "launches": got, "buckets": nb}
    del grads, leaves, rows

    # bfp_ste at the MLP's flat width
    L = HELPERS_STE_ELEMS
    x = (torch.randn(L, generator=gen, device=dev) * 3).requires_grad_(True)
    g_in = torch.randn(L, generator=gen, device=dev)
    y, got = counted(lambda: bfp.bfp_ste(x))
    y.backward(g_in)
    require_equal("bfp_ste forward",
                  [(y.detach(), bfp.bfp_roundtrip(x.detach(), BFPConfig()))])
    require_equal("bfp_ste gradient", [(x.grad, g_in)])
    ms = cuda_ms(lambda: bfp.bfp_ste(x), HELPERS_REPS)
    emit(phase="helpers_path", item="bfp_ste", elems=L, ms=ms,
         launches=got, forward_bitequal=True, grad_bitequal=True)
    out["bfp_ste"] = {"ms": ms, "launches": got}
    del x, y, g_in
    torch.cuda.empty_cache()
    emit(phase="helpers_path", card=smi, launches=out["launches"])
    return out


# -- 50-53. --data= with sp and MoE, the explicit-gradient hook, the BFP
# convergence driver, the ring across processes -----------------------------

DATA_AXES_ARGV = {
    # Llama-3-8B width over dp=2 x sp=2: 1 layer, one 4096-token
    # sequence a dp rank (two 2048-token shards)
    "sp": ["--model=llama3_8b", "--model.n_layers=1",
           "--model.attn_block=512", "--model.attn_impl=auto", "--seq=4096",
           "--global_batch=2", "--mesh.dp=2", "--mesh.sp=2"],
    # Mixtral-8x7B width over dp=2 x ep=2: 1 layer, batch 4
    "moe": MOE_MODEL_ARGV + ["--model.n_layers=1", "--model.attn_block=512",
                             "--model.attn_impl=auto", "--seq=4096",
                             "--global_batch=4", "--mesh.dp=2",
                             "--mesh.ep=2"]}
DATA_AXES_TAIL = ["--iters=1", "--collective.impl=ring",
                  "--collective.compression.codec=pallas",
                  "--collective.fused_kernel=true", "--optimizer.kind=sgd",
                  "--optimizer.learning_rate=0.001",
                  "--data=" + os.path.join(os.path.dirname(
                      os.path.abspath(__file__)), "SURVEY.md")]
FLASH_PATH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def llama_data_axes_path(dev, kernels) -> dict:
    """``train_llama.main --data=SURVEY.md`` with sp (Llama-3-8B width, dp=2
    x sp=2) and with MoE layers (Mixtral-8x7B width, dp=2 x ep=2), 1
    layer and 2 steps each (the warm-up and one timed), SGD at lr 0.001:
    finite losses, masked labels, each tensor-core flash kernel launched
    every step, one launch of each ring kernel a step."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    out = {}
    for name, base in DATA_AXES_ARGV.items():
        argv = base + DATA_AXES_TAIL
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero(kernels)
        run = train_llama.main(argv)
        launches = {k: v.launches for k, v in kernels.items() if v.launches}
        steps = len(run["losses"])
        checks = {"finite": all(math.isfinite(v) for v in run["losses"]),
                  "steps": steps == 2,
                  "masked_labels": run["data"]["masked_share"] > 0,
                  "flash_every_step": all(
                      launches.get(k, 0) >= steps
                      for k in FLASH_PATH_KERNELS),
                  "rings_per_step": (launches.get("ring_rs_update", 0),
                                     launches.get("ring_ag", 0)) == (
                      steps * run["mesh"]["ep"], steps * run["mesh"]["ep"])}
        emit(phase="llama_data_axes_path", cell=name, argv=argv,
             losses=run["losses"], masked_share=run["data"]["masked_share"],
             tokens_per_sec=run["tokens_per_sec"], wall_s=run["wall_s"],
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             launches=launches, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"llama_data_axes_path ({name}): {checks}")
        out[name] = {"launches": launches, "steps": steps}
    gc.collect()
    torch.cuda.empty_cache()
    return out


EXPLICIT_ARGV = [a for a in TRAIN_ARGV if not a.startswith(
    ("--model.n_layers=", "--iters="))] + ["--model.n_layers=1",
                                           "--iters=2"]


def explicit_grads_path(dev, kernels) -> None:
    """``ShardedTrainer(loss_and_grads_fn=)`` at pp = 1: Llama-3-8B width,
    1 layer, dp=2, the BFP ring kernels, 2 steps through an explicit
    gradient function (autograd of ``llama.loss_fn`` written as a
    function, called a dp rank at a time) against the autograd route
    from the same weights on the same batches: masters and replicas
    bit-equal, the losses equal."""
    import torch
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
    mcfg, cfg, seq, device = train_llama.parse(EXPLICIT_ARGV)

    def loss_and_grads(params, batch):
        pairs = fused_update._leaves(params)
        leaves = [t.detach().requires_grad_() for _, t in pairs]
        keys = tuple(p for p, _ in pairs)
        loss = llama.loss_fn(fused_update.tree_from_leaves(keys, leaves),
                             batch, mcfg)
        gs = torch.autograd.grad(loss, leaves)
        return loss.detach(), fused_update.tree_from_leaves(keys, list(gs))

    ranks = make_ranks(cfg.mesh, device)
    res = {}
    for route in ("autograd", "explicit"):
        gc.collect()
        torch.cuda.empty_cache()
        tr = (ShardedTrainer(lambda p, b: llama.loss_fn(p, b, mcfg), ranks,
                             cfg) if route == "autograd" else
              ShardedTrainer(None, ranks, cfg,
                             loss_and_grads_fn=loss_and_grads))
        state = tr.init_state(llama.init(torch.Generator(
            device=dev).manual_seed(cfg.seed), mcfg, dev))
        batches = [tr.shard_batch(b) for b in train_llama.batches(
            mcfg, cfg, seq, cfg.iters)]
        state, losses, step_ms, launches = _stepped(tr, state, batches,
                                                    kernels)
        res[route] = {"losses": losses, "step_ms": step_ms,
                      "launches": {k: v for k, v in launches.items() if v},
                      "w_own": state.w_own if route == "explicit"
                      else _host(state.w_own),
                      "replicas": state.replicas if route == "explicit"
                      else _host(state.replicas)}
        del tr, state, batches
    _, w_eq = _diff(res["explicit"]["w_own"], res["autograd"]["w_own"])
    _, r_eq = _diff(res["explicit"]["replicas"], res["autograd"]["replicas"])
    checks = {"masters_bitequal": w_eq, "replicas_bitequal": r_eq,
              "losses_equal": res["explicit"]["losses"]
              == res["autograd"]["losses"],
              "same_launches": res["explicit"]["launches"]
              == res["autograd"]["launches"]}
    emit(phase="explicit_grads_path", argv=EXPLICIT_ARGV,
         losses={k: r["losses"] for k, r in res.items()},
         step_ms={k: r["step_ms"] for k, r in res.items()},
         launches={k: r["launches"] for k, r in res.items()}, checks=checks)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"explicit_grads_path: {checks}")


EVAL_BFP_ARGV = ["--models=mlp_fsdp", "--multiseed_steps=20", "--seeds=0,1"]


def eval_bfp_path(dev) -> None:
    """``python -m fpga_ai_nic_tpu_torch.eval_bfp --models=mlp_fsdp`` at 20
    steps and 2 seeds on the card, into a temporary directory: finite
    losses in every arm, JAX's report keys, the card in the provenance."""
    import shutil
    import tempfile
    from fpga_ai_nic_tpu_torch import eval_bfp
    tmp = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        eval_bfp.main(EVAL_BFP_ARGV + [f"--out={tmp}/r.json"])
        wall = time.perf_counter() - t0
        with open(f"{tmp}/r.json") as f:
            rep = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs = rep["mlp_fsdp"]["per_seed"]
    losses = [v for r in runs for arm in r.values() if isinstance(arm, dict)
              and "losses" in arm for v in arm["losses"]]
    checks = {"keys": {"steps", "n_devices", "codec_error", "mlp_fsdp",
                       "_provenance"} <= set(rep),
              "finite": all(math.isfinite(v) for v in losses),
              "card": "NVIDIA" in (rep["_provenance"]["nvidia_smi"] or "")}
    emit(phase="eval_bfp_path", argv=EVAL_BFP_ARGV, wall_s=wall,
         ratios={f"m{m}": rep["mlp_fsdp"][f"bfp_m{m}"]["paired_ratios"]
                 for m in (8, 6, 4)}, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"eval_bfp_path: {checks}")


PROCS_WORLD = 4
PROCS_STEPS = 4     # the first step is cold in both runs: medians skip it
PROCS_TIMEOUT_S = 600.0
PROCS_SPEC = {"device": "cuda", "seed": 0, "codec": "bfp",
              "opt_kinds": ("sgd", "adamw"), "layer_sizes": (2048,) * 11,
              "global_batch": 5376, "steps": PROCS_STEPS, "opt": "sgd",
              "lr": 0.1}
# each worker's allocator without growable segments: their buffers are
# shared through CUDA IPC handles
PROCS_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:False"}
HOP_OPS = {"rs": 11, "ag": 2}     # operations an element: enc + dec + add


def procs_row() -> int:
    """``MLPConfig()``'s flat row padded for the fused ring at dp=4."""
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.parallel import procs
    sizes = PROCS_SPEC["layer_sizes"]
    live = sum(a * b + b for a, b in zip(sizes, sizes[1:]))
    m = fused_update.pad_multiple(procs._coll(PROCS_SPEC), PROCS_WORLD)
    return -(-live // m) * m


def hop_kernel_checks(dev, L: int, world: int) -> dict:
    """``ring_hop_rs`` and ``ring_hop_ag`` (``csrc/ring_hop.cu``) against
    their plain versions on the same card tensors at the MLP row's chunk
    over ``world`` ranks, every launch form (the reduce-scatter's first,
    middle and last with SGD and AdamW; the all-gather's first and
    forwarding) on both wires (BFP frames and raw f32 frames), bit for
    bit, repeat launches bit-equal; a middle BFP hop's time (the step's
    n-2 of n) as device time (``device_ms``) and as whole launches (CUDA
    events), the plain version's, and the bytes bound (each input read
    once, each output written once)."""
    import torch
    from fpga_ai_nic_tpu_torch import optim
    from fpga_ai_nic_tpu_torch.ops import ring_procs
    from fpga_ai_nic_tpu_torch.utils.config import BFPConfig, OptimizerConfig
    C = L // world
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(C, generator=gen, device=dev) * 3
    x[::97] = 0
    w = torch.randn(C, generator=gen, device=dev) * 0.02
    st = {k: torch.rand(C, generator=gen, device=dev) * 0.01
          for k in ("m", "v")}
    peer = torch.randn(C, generator=gen, device=dev)
    out = {}

    def check_forms(wire, name):
        """Every launch form on ``wire``; the arrived frame it used."""
        F = wire.frame_bytes

        def frames():
            return (torch.empty(F, dtype=torch.uint8, device=dev),
                    torch.empty(F, dtype=torch.uint8, device=dev))

        recv = frames()[0]
        ring_procs.encode_frame(peer, wire, recv)
        # the reduce-scatter: first (x only), middle, last with each
        # optimizer
        for form, rv in (("first", None), ("middle", recv)):
            a, b = frames()
            ring_procs.rs_hop(x, rv, a, wire, n=world)
            ring_procs.rs_hop_plain(x, rv, b, wire, n=world)
            require_equal(f"ring_hop_rs ({name} {form})", [(a, b)])
            c = a.clone()
            ring_procs.rs_hop(x, rv, a, wire, n=world)
            require_equal(f"ring_hop_rs ({name} {form}, repeat)", [(a, c)])
        for kind in ("sgd", "adamw"):
            opt = OptimizerConfig(kind=kind, learning_rate=1e-2,
                                  weight_decay=0.01)
            keys = optim.OptimizerSpec.from_optimizer(opt).state_keys
            hyper = optim.fused_hyperparams(opt, 3, device=dev)
            s = {k: st[k] for k in keys}
            got = ring_procs.rs_hop(x, recv, None, wire, n=world, last=True,
                                    w=w, state=s, hyper=hyper, opt_kind=kind)
            want = ring_procs.rs_hop_plain(x, recv, None, wire, n=world,
                                           last=True, w=w, state=s,
                                           hyper=hyper, opt_kind=kind)
            require_equal(f"ring_hop_rs ({name} last, {kind})",
                          [(got[0], want[0]), (got[1], want[1])]
                          + [(got[2][k], want[2][k]) for k in keys])
        # the all-gather: the owned chunk's encode, a forwarded frame
        for form, rv in (("first", None), ("forward", recv)):
            (a, b), sa, sb = (frames(), torch.empty_like(x),
                              torch.empty_like(x))
            ring_procs.ag_hop(w, rv, a, sa, wire)
            ring_procs.ag_hop_plain(w, rv, b, sb, wire)
            require_equal(f"ring_hop_ag ({name} {form})", [(a, b), (sa, sb)])
        return recv

    check_forms(ring_procs.wire_for(C, None), "f32")
    wire = ring_procs.wire_for(C, BFPConfig(codec="pallas"))
    F = wire.frame_bytes
    recv = check_forms(wire, "bfp")
    opt = OptimizerConfig(kind="adamw", learning_rate=1e-2, weight_decay=0.01)
    hyper = optim.fused_hyperparams(opt, 3, device=dev)
    last_ms = cuda_ms(lambda: ring_procs.rs_hop(
        x, recv, None, wire, n=world, last=True, w=w, state=st,
        hyper=hyper, opt_kind="adamw"), 20, 3)
    last_plain = cuda_ms(lambda: ring_procs.rs_hop_plain(
        x, recv, None, wire, n=world, last=True, w=w, state=st,
        hyper=hyper, opt_kind="adamw"), 3)
    send = torch.empty(F, dtype=torch.uint8, device=dev)
    slot = torch.empty_like(x)
    rs_call = cuda_ms(lambda: ring_procs.rs_hop(x, recv, send, wire,
                                                n=world), 20, 3)
    rs_ms = device_ms(lambda: ring_procs.rs_hop(x, recv, send, wire,
                                                n=world), 20,
                      ("ring_hop_rs_kernel",))
    rs_plain = cuda_ms(lambda: ring_procs.rs_hop_plain(
        x, recv, send, wire, n=world), 3)
    ag_call = cuda_ms(lambda: ring_procs.ag_hop(w, recv, send, slot, wire),
                      20, 3)
    ag_ms = device_ms(lambda: ring_procs.ag_hop(w, recv, send, slot, wire),
                      20, ("ring_hop_ag_kernel",))
    ag_plain = cuda_ms(lambda: ring_procs.ag_hop_plain(w, recv, send, slot,
                                                       wire), 3)
    out["ring_hop_rs"] = {
        "max_abs_err": 0.0, "ms": rs_ms, "plain_ms": rs_plain,
        "bound": bound(4 * C + 2 * F, HOP_OPS["rs"] * C),
        "extra": {"shape": f"a middle hop: chunk C={C} of an [L={L}] row "
                           f"over W={world}, frame {F} bytes",
                  "ms_is": "device time", "call_ms": rs_call,
                  "last_adamw_ms": last_ms, "last_adamw_plain_ms": last_plain,
                  "last_adamw_bound_ms": bound(
                      4 * C + F + 3 * 4 * C + 4 * C + 3 * 4 * C,
                      (HOP_OPS["rs"] + 12) * C)[0]}}
    out["ring_hop_ag"] = {
        "max_abs_err": 0.0, "ms": ag_ms, "plain_ms": ag_plain,
        "bound": bound(2 * F + 4 * C, HOP_OPS["ag"] * C),
        "extra": {"shape": f"a forwarding hop: chunk C={C}, frame {F} "
                           "bytes", "ms_is": "device time",
                  "call_ms": ag_call}}
    emit(phase="hop_kernel_checks", C=C, frame_bytes=F, bitexact=True,
         wires=["f32", "bfp"],
         **{k: {kk: vv for kk, vv in r.items()} for k, r in out.items()})
    del x, recv, w, st, peer, send, slot
    torch.cuda.empty_cache()
    return out


def procs_ring_path(dev, smi) -> dict:
    """The data-parallel main path with its ranks as processes: first the
    one-process ``DPTrainer(dp=4)`` on ``MLPConfig()`` (global batch 5376,
    the BFP ring kernels, fused SGD) for ``PROCS_STEPS`` steps, each
    rank's master and replica rows hashed; then ``PROCS_WORLD`` worker
    processes on this card (``parallel.procs.spawn``, a gloo group, CUDA
    IPC peer buffers, killed after ``PROCS_TIMEOUT_S``): the cross-process
    reduce-scatter + update + all-gather on the full flat row under SGD
    and AdamW, with BFP frames and with raw f32 frames, each rank's owned
    chunk, masters, moments and replica bit-equal to the one-process route
    on the stacked rows (the loopback kernels under BFP); then the same
    steps of the cross-process ``DPTrainer``, every row's hash equal to
    the one-process trainer's, one ``ring_hop_rs`` and one ``ring_hop_ag``
    launch a hop (W of each a step in each process).  Step ms of both,
    the ring's ms a collective pair."""
    import torch
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel import procs
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (MeshConfig, MLPConfig,
                                                    TrainConfig)
    W = PROCS_WORLD
    spec = dict(PROCS_SPEC, L=procs_row(), device=dev.type)
    mcfg = MLPConfig(layer_sizes=spec["layer_sizes"])
    cfg = TrainConfig(global_batch=spec["global_batch"],
                      mesh=MeshConfig(dp=W), collective=procs._coll(spec),
                      optimizer=procs._opt(spec["opt"], spec["lr"]))
    gc.collect()
    torch.cuda.empty_cache()
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg), VirtualRanks(W, dev),
                   cfg)
    state = tr.init_state(mlp.init(torch.Generator().manual_seed(
        spec["seed"]), mcfg, dev))
    if state.replicas.shape[1] != spec["L"]:
        raise AssertionError(f"padded row {state.replicas.shape[1]} != "
                             f"{spec['L']}")
    batch = tr.shard_batch(procs.global_batch(spec, dev))
    ref = {"losses": [], "w_own": [], "replicas": [], "step_ms": []}
    for _ in range(PROCS_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, loss = tr.step(state, batch)
        end.record()
        torch.cuda.synchronize()
        ref["step_ms"].append(start.elapsed_time(end))
        ref["losses"].append(float(loss))
        ref["w_own"].append([procs.digest(state.w_own[r]) for r in range(W)])
        ref["replicas"].append([procs.digest(state.replicas[r])
                                for r in range(W)])
    del tr, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = procs.spawn(procs.ring_and_steps, W, (spec,),
                      timeout=PROCS_TIMEOUT_S, env=PROCS_ENV)
    wall = time.perf_counter() - t0
    per_step = {"ring_hop_rs": W * PROCS_STEPS, "ring_hop_ag": W * PROCS_STEPS}
    checks = {
        "ring_bitequal": all(all(r["ring"]["equal"].values()) for r in res),
        "masters_bitequal": all(r["w_own"] == [d[i] for d in ref["w_own"]]
                                for i, r in enumerate(res)),
        "replicas_bitequal": all(
            r["replica"] == [d[i] for d in ref["replicas"]]
            for i, r in enumerate(res)),
        "losses_equal": all(r["losses"] == ref["losses"] for r in res),
        "launches": all(r["launches"] == per_step for r in res),
        "devices": [r["device"] for r in res]}
    checks["devices"] = all(d.startswith("cuda") for d in checks["devices"])
    emit(phase="procs_ring_path", world=W, row=spec["L"],
         model="MLP 10x2048x2048 f32", global_batch=spec["global_batch"],
         steps=PROCS_STEPS, devices=[r["device"] for r in res],
         spawn_wall_s=wall, ring_ms={k: [r["ring"]["ms"][k] for r in res]
                                     for k in res[0]["ring"]["ms"]},
         step_ms=[r["step_ms"] for r in res], one_process_step_ms=ref[
             "step_ms"], median_step_ms=_median(res[0]["step_ms"][1:]),
         one_process_median_step_ms=_median(ref["step_ms"][1:]),
         losses=ref["losses"], launches=res[0]["launches"], checks=checks,
         card=smi)
    if not all(checks.values()):
        raise AssertionError(f"procs_ring_path: {checks}")
    return {"launches": res[0]["launches"], "steps": PROCS_STEPS,
            "median_step_ms": _median(res[0]["step_ms"][1:]),
            "one_process_median_step_ms": _median(ref["step_ms"][1:])}


def main() -> int:
    # the Llama training phase holds about 60 GB at its peak and frees and
    # reallocates 7-15 GB buffers every step; growable segments keep the
    # allocator from fragmenting the card's 80 GB (set before CUDA starts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from fpga_ai_nic_tpu_torch import optim
        from fpga_ai_nic_tpu_torch.models import mlp
        from fpga_ai_nic_tpu_torch.models.llama import LlamaConfig
        from fpga_ai_nic_tpu_torch.ops import (_build, bfp_cuda,
                                               flash_attention, int8_cuda,
                                               integrity, paged_attend,
                                               ring_cuda)
        from fpga_ai_nic_tpu_torch.serve import ServeConfig
        from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
        from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
        from fpga_ai_nic_tpu_torch.utils.config import (
            BFPConfig, CollectiveConfig, MeshConfig, MLPConfig,
            OptimizerConfig, TrainConfig)
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card and build ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="build", seconds=_build.timed_build(),
         sources=list(_build.SOURCES), flags=list(_build.NVCC_FLAGS))
    staging_check()

    cfg = BFPConfig(codec="pallas")
    B = cfg.block_size
    sgd = OptimizerConfig(kind="sgd", learning_rate=0.1)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 8
    L_full = 41_975_808                   # canonical MLP, padded for dp=8
    C_full = L_full // n
    results = {}

    def rec(name, **kw):
        results.setdefault(name, {"max_abs_err": 0.0})
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], kw.pop("max_abs_err"))
        r.update(kw)

    # -- 2. kernels against their plain versions --------------------------------
    for label, N in (("2^24", 1 << 24), ("main path encode", L_full),
                     ("main path decode", C_full)):
        x = torch.randn(N, generator=gen, device=dev) * 3
        x[::97] = 0
        x[5::131] *= 1e-39                # subnormals
        m, s = bfp_cuda.bfp_encode(x)
        pm, ps = bfp_cuda.bfp_encode_plain(x)
        require_equal("bfp_encode", [(m, pm), (s, ps)])
        d = bfp_cuda.bfp_decode(m, s)
        pd = bfp_cuda.bfp_decode_plain(pm, ps)
        require_equal("bfp_decode", [(d, pd)])
        # ms: the kernel's device time; call_ms: whole calls (CUDA events),
        # host work included, which at 5,246,976 elements outlasts the
        # decode kernel
        enc_ms = device_ms(lambda: bfp_cuda.bfp_encode(x), 20,
                           ("bfp_encode_kernel",))
        dec_ms = device_ms(lambda: bfp_cuda.bfp_decode(m, s), 20,
                           ("bfp_decode_kernel",))
        enc_call = cuda_ms(lambda: bfp_cuda.bfp_encode(x), 20, 3)
        dec_call = cuda_ms(lambda: bfp_cuda.bfp_decode(m, s), 20, 3)
        enc_plain = cuda_ms(lambda: bfp_cuda.bfp_encode_plain(x), 3)
        dec_plain = cuda_ms(lambda: bfp_cuda.bfp_decode_plain(m, s), 3)
        emit(phase="kernel_check", kernel="bfp_encode/bfp_decode", shape=label,
             elems=N, bitexact=True, encode_ms=enc_ms, decode_ms=dec_ms,
             encode_call_ms=enc_call, decode_call_ms=dec_call,
             encode_plain_ms=enc_plain, decode_plain_ms=dec_plain)
        if label == "main path encode":
            rec("bfp_encode", max_abs_err=0.0, ms=enc_ms, plain_ms=enc_plain,
                bound=bound(N * (4 + 1 + 1 / B), 8 * N),
                extra={"call_ms": enc_call})
        if label == "main path decode":
            rec("bfp_decode", max_abs_err=0.0, ms=dec_ms, plain_ms=dec_plain,
                bound=bound(N * (1 + 1 / B + 4), 2 * N),
                extra={"call_ms": dec_call})
        del x, m, s, pm, ps, d, pd

    results.update(ring_checks(dev, cfg, sgd, n, L_full))
    ring_pair = ring_integrity_checks(dev, cfg, sgd, n, L_full)
    results["row_checksums"] = checksum_checks(dev, n, L_full)
    results.update(int8_checks(dev))
    paged = paged_checks(dev)
    flash = flash_checks(dev)

    # -- 3. small reference: card against CPU -----------------------------------
    coll = CollectiveConfig(impl="ring", compression=cfg, fused_kernel=True,
                            fused_optimizer=True)
    small = MLPConfig(layer_sizes=(256,) * 4)
    scfg = TrainConfig(global_batch=64, mesh=MeshConfig(dp=4), collective=coll,
                       optimizer=sgd)
    p0 = mlp.init(torch.Generator().manual_seed(1), small, "cpu")
    xs = torch.randn((64, 256), generator=torch.Generator().manual_seed(2))
    ys = torch.randint(0, 256, (64,), generator=torch.Generator().manual_seed(3))
    runs = {}
    for d in ("cpu", "cuda"):
        tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, small),
                       VirtualRanks(4, torch.device(d)), scfg)
        st = tr.init_state(p0)
        b = tr.shard_batch((xs, ys))
        losses, gmax = [], 0.0
        for _ in range(3):
            g, loss = tr.grads(st, b)
            gmax = max(gmax, float(g.abs().max()))
            st = tr.apply_grads(st, g)
            losses.append(float(loss))
        runs[d] = (losses, st.w_own.cpu(), gmax)
    # one BFP grid step (2^-6 of a block max) may flip per step where the
    # GEMMs' summation order moves a value across a rounding boundary
    atol = 3 * 0.1 * 2.0 ** -6 * runs["cpu"][2]
    werr = float((runs["cpu"][1] - runs["cuda"][1]).abs().max())
    lerr = max(abs(a - b) / abs(a) for a, b in zip(runs["cpu"][0],
                                                   runs["cuda"][0]))
    emit(phase="small_reference", losses_cpu=runs["cpu"][0],
         losses_card=runs["cuda"][0], loss_rel_err=lerr,
         master_max_abs_err=werr, master_atol=atol)
    if not (lerr <= 1e-4 and werr <= atol):
        raise AssertionError("small reference: card and CPU disagree")

    # -- 4. the main path ---------------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)   # the checks' peaks are not its
    mcfg = MLPConfig()
    cfg_main = TrainConfig(global_batch=5376, mesh=MeshConfig(dp=n),
                           collective=coll, optimizer=sgd)
    ranks = VirtualRanks(n, dev)
    tr = DPTrainer(lambda p, b: mlp.loss_fn(p, b, mcfg), ranks, cfg_main)
    state = tr.init_state(mlp.init(torch.Generator().manual_seed(0), mcfg,
                                   dev))
    if state.w_own.shape != (n, C_full):
        raise AssertionError(f"unexpected padding {tuple(state.w_own.shape)}")
    gx = torch.Generator(device=dev).manual_seed(4)
    bx = torch.randn((cfg_main.global_batch, 2048), generator=gx, device=dev)
    by = torch.randint(0, 2048, (cfg_main.global_batch,), generator=gx,
                       device=dev)
    batch = tr.shard_batch((bx, by))
    kernels = {"bfp_encode": bfp_cuda.ENCODE, "bfp_decode": bfp_cuda.DECODE,
               "ring_rs_update": ring_cuda.RING_RS, "ring_ag": ring_cuda.RING_AG,
               "int8_encode": int8_cuda.ENCODE, "int8_decode": int8_cuda.DECODE,
               "row_checksums": integrity.ROW_CHECKSUMS}
    per_step = {"bfp_encode": 0, "bfp_decode": 0, "ring_rs_update": 1,
                "ring_ag": 1, "int8_encode": 0, "int8_decode": 0,
                "row_checksums": 0}
    for k in kernels.values():
        k.launches = 0
    state, loss = tr.step(state, batch)           # warm-up
    losses = [float(loss)]
    steps = 5
    # the first timed step still maps the second replica buffer (its
    # host time shows in the mean); the median is the steady step
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for mark in marks[1:]:
        state, loss = tr.step(state, batch)
        mark.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    launches = {name: k.launches for name, k in kernels.items()}
    losses.append(float(loss))
    for name, k in launches.items():
        if k != (steps + 1) * per_step[name]:
            raise AssertionError(f"{name}: {k} launches, expected "
                                 f"{(steps + 1) * per_step[name]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    reps = state.replicas
    if not bool((reps == reps[0]).all()):
        raise AssertionError("replicas differ after the main path")
    emit(phase="main_path", model="MLP 10x2048x2048 f32", dp=n,
         global_batch=cfg_main.global_batch, steps=steps, wall_s=wall,
         ms_per_step=1e3 * wall / steps, step_ms=step_ms,
         median_step_ms=sorted(step_ms)[steps // 2],
         samples_per_sec=steps * cfg_main.global_batch / wall,
         loss_first=losses[0], loss_last=losses[-1], launches=launches,
         padded_len=L_full, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # one more step: the same gradients through kernels and plain versions
    g, _ = tr.grads(state, batch)
    new = tr.apply_grads(state, g)
    h = optim.fused_hyperparams(sgd, state.step, device=dev)
    _, w_plain, _ = ring_cuda.ring_reduce_scatter_update_plain(
        g, state.w_own, state.opt_state, h, opt_kind="sgd", compression=cfg)
    require_equal("main path masters", [(new.w_own, w_plain)])
    rep_plain = ring_cuda.ring_all_gather_plain(w_plain, cfg)
    require_equal("main path replicas", [(new.replicas, rep_plain)])
    emit(phase="plain_step", masters_bitequal=True, replicas_bitequal=True)
    del w_plain, rep_plain
    codec_launches = codec_route(dev, tr, state, g, new, kernels)
    del g, new, reps
    held = [state]
    del state        # held[0] alone keeps the state each step replaces

    def train_step():
        held[0], _ = tr.step(held[0], batch)

    profile_run("profile", train_step, 2)
    del tr, held, batch, ranks
    torch.cuda.empty_cache()

    # -- 4b. the main path with integrity checks, and its fault controls ----------
    integ_launches = integrity_path(dev, kernels, mcfg, cfg_main, bx, by)

    # -- 4c-4e. ZeRO-3, the hierarchical ring, the ring kernel's stages -----------
    fsdp = fsdp_path(dev, kernels, mcfg, sgd, bx, by)
    hier = hier_path(dev, kernels, mcfg, sgd, bx, by)
    stages = ring_cost_stages(dev)

    # -- 4f. the tuner on the MLP cell: live rates, codec="auto", a switch ----
    live = live_calibrate_phase(dev, smi)
    auto_dp_phase(dev, mcfg, sgd, bx, by)
    adaptive_phase(dev, mcfg, sgd, bx, by, live["mlp"])

    # -- 36, 38, 39. accumulation, the auto codecs, the queue on the MLP cell
    accum_mlp = accum_mlp_path(dev, kernels, mcfg, sgd, bx, by)
    auto_codec_launches = codec_auto_path(dev, kernels, mcfg, sgd, bx, by)
    queued_mlp = queued_mlp_path(dev, kernels, mcfg, bx, by)

    # -- 42-43. the elastic loop's seven cells, the durability plane -------
    elastic = elastic_path(dev, kernels, mcfg, sgd, bx, by, smi)
    durability = durability_path(dev, kernels, elastic.pop("trainer"), mcfg,
                                 sgd, bx, by, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 46-48. the live reshard tier, under the elastic loop; observability
    reshard = reshard_path(dev, kernels, mcfg, sgd, bx, by, smi)
    elastic_rs = elastic_reshard_path(dev, kernels, mcfg, sgd, bx, by, smi)
    obs = obs_path(dev, kernels, mcfg, sgd, bx, by, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 49. the public helpers that run the ring kernels ------------------
    helpers = helpers_path(dev, kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 53. the ring across processes: the hop kernels, the MLP path ------
    hops = hop_kernel_checks(dev, procs_row(), PROCS_WORLD)
    procs_run = procs_ring_path(dev, smi)

    # -- 6. the int8 codec path and the convergence eval ---------------------------
    int8_launches = int8_train_path(dev, kernels, sgd, bx, by)
    del bx, by
    codec_convergence(dev)
    eval_bfp_path(dev)

    # -- 7-8. the serving path, its profile and its parity ------------------------
    flash_kernels = {"flash_fwd": flash_attention.FLASH_FWD,
                     "flash_dq": flash_attention.FLASH_DQ,
                     "flash_dkv": flash_attention.FLASH_DKV}
    serve_kernels = dict(kernels, paged_attend=paged_attend.PAGED_ATTEND,
                         **flash_kernels)
    lcfg = LlamaConfig.llama3_8b()
    srv = ServeConfig(**SERVE_SHAPE)
    run = serving_path(dev, lcfg, srv, serve_kernels)
    if any(k != 0 for name, k in run["launches"].items()
           if name not in ("paged_attend", "row_checksums")):
        raise AssertionError(f"serving launched training kernels "
                             f"{run['launches']}")
    calls = run["summary"]["prefill_calls"] + run["summary"]["decode_calls"]
    if run["launches"]["row_checksums"] != 2 * calls:
        raise AssertionError(   # verify the input pool, record the output's
            f"serving: {run['launches']['row_checksums']} page-checksum "
            f"launches, expected 2 x {calls} steps")
    serving_profile(dev, lcfg, srv, run)
    serving_parity(dev, lcfg, srv, run)

    # -- 41. the serving fleet on the same weights, then generate_llama -----
    fleet = fleet_phases(dev, lcfg, srv, run["params"], serve_kernels, smi)
    # -- 44. faults inside the serving tick, on the same weights -----------
    serve_chaos = serve_chaos_path(dev, lcfg, srv, run["params"],
                                   serve_kernels, smi)
    del run["params"], run["snaps"], run["reqs"]
    torch.cuda.empty_cache()

    # -- 9-11. the Llama training path, its profile and its parity ---------------
    train = llama_train_path(dev, serve_kernels)
    llama_train_parity(dev, train)
    auto = auto_route(dev)
    # -- 45. train_llama --save= and generate_llama --ckpt= on the card ----
    ckpt_driver = ckpt_driver_path(dev, dict(
        kernels, **{name: getattr(flash_attention, name.upper())
                    for name in ("flash_fwd", "flash_dq", "flash_dkv",
                                 "flash_fwd_generic", "flash_dq_generic",
                                 "flash_dkv_generic")}), smi)

    # -- 36-37. the Llama cell with accumulation, and on the repo's text -----
    accum_llama = accum_llama_path(dev, serve_kernels)
    data_run = llama_data_path(dev, serve_kernels)

    # -- 12b-12d. sequence parallelism: the offsets, the dp x sp Llama path -----
    offsets = flash_offset_checks(dev)
    sp_kernels = dict(
        serve_kernels, flash_fwd_offsets=flash_attention.FLASH_FWD_OFFSETS,
        flash_dq_offsets=flash_attention.FLASH_DQ_OFFSETS,
        flash_dkv_offsets=flash_attention.FLASH_DKV_OFFSETS,
        flash_fwd_generic=flash_attention.FLASH_FWD_GENERIC,
        flash_dq_generic=flash_attention.FLASH_DQ_GENERIC,
        flash_dkv_generic=flash_attention.FLASH_DKV_GENERIC)
    # -- 50-51. --data= with sp and MoE; the explicit-gradient hook --------
    data_axes = llama_data_axes_path(dev, sp_kernels)
    explicit_grads_path(dev, kernels)
    sp_run = llama_sp_train_path(dev, sp_kernels)
    llama_sp_parity(dev, sp_run)
    remat_run = llama_sp_train_path(dev, sp_kernels, remat=True)
    llama_sp_remat_compare(sp_run, remat_run)

    # -- 13-15. BERT-base: the key-bias channel, the DDP path, its parity ----------
    bert_flash = bert_flash_checks(dev)
    bert_kernels = dict(serve_kernels,        # the tensor-core flash kernels
                        flash_fwd_generic=flash_attention.FLASH_FWD_GENERIC,
                        flash_dq_generic=flash_attention.FLASH_DQ_GENERIC,
                        flash_dkv_generic=flash_attention.FLASH_DKV_GENERIC)
    bert_run = bert_train_path(dev, bert_kernels)
    bert_train_parity(dev, bert_run)
    queued_bert = queued_bert_path(dev, bert_kernels)

    # -- 16-17. ResNet-50: sync-BN DP with the fused momentum SGD -------------
    resnet_run = resnet_train_path(dev, bert_kernels)
    resnet_train_parity(dev)

    # -- 18-20. Mixtral-8x7B width: MoE over dp x ep, its parity, serving ------
    moe_run = moe_train_path(dev, bert_kernels)
    moe_train_parity(dev, moe_run)
    moe_serve = moe_serving_path(dev, bert_kernels)

    # -- 21. sp with MoE over dp x sp x ep: the hop, the path, its parity -----
    moe_sp_hop = moe_sp_hop_checks(dev)
    moe_sp_run = moe_train_path(dev, sp_kernels, MOE_SP_TRAIN_ARGV,
                                "moe_sp_train_path")
    moe_sp_train_parity(dev, moe_sp_run)

    # -- 22-23. the pipeline over dp x pp: three schedules, 1F1B at M=8, parity
    pp_runs = {sched: pp_train_path(dev, sp_kernels, PP_TRAIN_ARGV, sched,
                                    "llama_pp_train_path",
                                    time_rings=sched == "gpipe")
               for sched in PP_SCHEDULES}
    # 1F1B at 8 microbatches (the memory check in M) is cut: the tp
    # phases take its time (PERF.md section 4)
    emit(phase="llama_pp_memory", peak_mem_gb={
        f"{k}_m4": r["peak_mem_gb"] for k, r in pp_runs.items()},
         backward_peak_gb={f"{k}_m4": r["backward_peak_gb"]
                           for k, r in pp_runs.items()},
         median_step_ms={k: r["median_step_ms"] for k, r in pp_runs.items()})
    llama_pp_train_parity(dev)

    # -- 24-27. the pipeline with sp, ep and MoE layers: both paths, parity --
    # the interleaved schedule with sp is cut (its CPU test and card
    # numbers in PERF.md stand): the tp phases take its time
    pp_sp_runs = {sched: pp_train_path(dev, sp_kernels, PP_SP_TRAIN_ARGV,
                                       sched, "llama_pp_sp_train_path")
                  for sched in ("gpipe", "1f1b")}
    moe_pp_runs = {sched: pp_train_path(dev, sp_kernels, MOE_PP_TRAIN_ARGV,
                                        sched, "moe_pp_train_path")
                   for sched in MOE_PP_SCHEDULES}
    llama_pp_train_parity(dev, PP_SP_PARITY_ARGV, "llama_pp_sp_train_parity",
                          "pp1_dp2_sp2")
    moe_pp_train_parity(dev)

    # -- 29-32. tensor parallelism: Llama and MoE over tp, tp serving ticks --
    tp_flash = tp_flash_checks(dev)
    tp_run = llama_train_path(dev, serve_kernels, TP_TRAIN_ARGV,
                              "llama_tp_train_path")
    llama_tp_train_parity(dev)
    moe_tp_run = moe_train_path(dev, bert_kernels, MOE_TP_TRAIN_ARGV,
                                "moe_tp_train_path")
    moe_train_parity(dev, moe_tp_run, "moe_tp_train_parity")
    tp_serve = tp_serving_path(dev, lcfg, serve_kernels)

    # -- 33-35. pp with tp over dp=1 x pp=2 x tp=2: the launch, the path,
    # its parity --------------------------------------------------------------
    pp_tp_flash = tp_flash_checks(dev, PP_TP_FLASH_SHAPES,
                                  "pp_tp_flash_checks")
    pp_tp_runs = {sched: pp_train_path(dev, sp_kernels, PP_TP_TRAIN_ARGV,
                                       sched, "llama_pp_tp_train_path",
                                       time_rings=sched == "gpipe")
                  for sched in PP_TP_SCHEDULES}
    llama_pp_tp_train_parity(dev)

    # -- 28. the kernels line and the result ----------------------------------
    meta = {
        "bfp_encode": (PORT + "/csrc/bfp_codec.cu",
                       REF + "/ops/bfp_pallas.py:55"),
        "bfp_decode": (PORT + "/csrc/bfp_codec.cu",
                       REF + "/ops/bfp_pallas.py:76"),
        "ring_rs_update": (PORT + "/csrc/ring_rs.cu",
                           REF + "/ops/ring_pallas.py:777"),
        "ring_ag": (PORT + "/csrc/ring_ag.cu",
                    REF + "/ops/ring_pallas.py:1301"),
        "paged_attend": (PORT + "/csrc/paged_attend.cu",
                         REF + "/ops/paged_attend_pallas.py:112"),
        "flash_fwd": (PORT + "/csrc/flash_attn.cu",
                      REF + "/ops/flash_pallas.py:93"),
        "flash_dq": (PORT + "/csrc/flash_bwd.cu",
                     REF + "/ops/flash_pallas.py:222"),
        "flash_dkv": (PORT + "/csrc/flash_bwd.cu",
                      REF + "/ops/flash_pallas.py:267"),
        "flash_fwd_offsets": (PORT + "/csrc/flash_attn.cu",
                              REF + "/ops/flash_pallas.py:93"),
        "flash_dq_offsets": (PORT + "/csrc/flash_bwd.cu",
                             REF + "/ops/flash_pallas.py:222"),
        "flash_dkv_offsets": (PORT + "/csrc/flash_bwd.cu",
                              REF + "/ops/flash_pallas.py:267"),
        "flash_fwd_generic": (PORT + "/csrc/flash_generic.cu",
                              REF + "/ops/flash_pallas.py:93"),
        "flash_dq_generic": (PORT + "/csrc/flash_generic.cu",
                             REF + "/ops/flash_pallas.py:222"),
        "flash_dkv_generic": (PORT + "/csrc/flash_generic.cu",
                              REF + "/ops/flash_pallas.py:267"),
        "flash_fwd_generic_bias": (PORT + "/csrc/flash_generic.cu",
                                   REF + "/ops/flash_pallas.py:93"),
        "flash_dq_generic_bias": (PORT + "/csrc/flash_generic.cu",
                                  REF + "/ops/flash_pallas.py:222"),
        "flash_dkv_generic_bias": (PORT + "/csrc/flash_generic.cu",
                                   REF + "/ops/flash_pallas.py:267"),
        "flash_fwd_hd64": (PORT + "/csrc/flash_attn.cu",
                           REF + "/ops/flash_pallas.py:93"),
        "flash_dq_hd64": (PORT + "/csrc/flash_bwd.cu",
                          REF + "/ops/flash_pallas.py:222"),
        "flash_dkv_hd64": (PORT + "/csrc/flash_bwd.cu",
                           REF + "/ops/flash_pallas.py:267"),
        "int8_encode": (PORT + "/csrc/int8_codec.cu",
                        REF + "/compress/int8.py:129"),
        "int8_decode": (PORT + "/csrc/int8_codec.cu",
                        REF + "/compress/int8.py:148"),
        "row_checksums": (PORT + "/csrc/checksum.cu",
                          REF + "/ops/integrity.py:163"),
        "ring_hop_rs": (PORT + "/csrc/ring_hop.cu",
                        REF + "/ops/ring_pallas.py:777"),
        "ring_hop_ag": (PORT + "/csrc/ring_hop.cu",
                        REF + "/ops/ring_pallas.py:1301"),
    }
    procs_from = (f"procs_ring_path ({PROCS_WORLD} processes, "
                  f"{procs_run['steps']} steps of DPTrainer on MLPConfig(): "
                  f"{PROCS_WORLD} launches a step in each process; rank 0's "
                  "count)")
    for name in ("ring_hop_rs", "ring_hop_ag"):
        results[name] = hops[name]
        launches[name] = procs_run["launches"][name]
        results[name]["extra"].update(
            launches_from=procs_from, library=None,
            library_none=("no PyTorch call computes a BFP ring hop with "
                          "the fused update"),
            step_ms=procs_run["median_step_ms"],
            one_process_step_ms=procs_run["one_process_median_step_ms"])
    launches["paged_attend"] = run["launches"]["paged_attend"]
    for name in flash_kernels:
        launches[name] = train["launches"][name]
        results[name] = flash[name]
    for name in OFFSET_KERNELS:
        launches[name] = sp_run["launches"][name]
        results[name] = offsets[name]
        results[name]["extra"].update(moe_sp_hop[name])
    for name in ("int8_encode", "int8_decode"):
        launches[name] = int8_launches[name]
    for name in ("bfp_encode", "bfp_decode"):
        launches[name] = codec_launches[name]
    launches["row_checksums"] = integ_launches["row_checksums"]
    fsdp_from = ("fsdp_path (6 steps, MLP, fsdp=8: the gather's backward, "
                 "no optimizer)")
    results["ring_rs_update"]["extra"].update(
        fsdp_launches=fsdp["launches"]["ring_rs_update"],
        fsdp_launches_from=fsdp_from, fsdp_shape=fsdp["rs"]["shape"],
        fsdp_device_ms=fsdp["rs"]["device_ms"],
        fsdp_call_ms=fsdp["rs"]["call_ms"],
        fsdp_plain_ms=fsdp["rs"]["plain_ms"],
        fsdp_bound_ms=fsdp["rs"]["bound"][0],
        fsdp_bound_by=fsdp["rs"]["bound"][1],
        ablate_none_sass=stages["sass"])
    results["ring_ag"]["extra"].update(
        fsdp_launches=fsdp["launches"]["ring_ag"],
        fsdp_launches_from="fsdp_path (6 steps: the gather's forward)")
    for name in ("bfp_encode", "bfp_decode"):
        results[name].setdefault("extra", {}).update(
            hier_launches={k: r["launches"][name] for k, r in hier.items()},
            hier_launches_from="hier_path (4 steps each: phase B's hops)")
    pair = ring_pair[("full", "sgd")]
    results["ring_rs_update"]["extra"].update(
        integrity_launches=integ_launches["ring_rs_update"],
        integrity_launches_from="integrity_path",
        integrity_device_ms=pair["device_ms_on"],
        integrity_off_device_ms=pair["device_ms_off"],
        integrity_call_ms=pair["call_ms_on"],
        integrity_on_over_off=pair["on_over_off"],
        integrity_plain_ms=pair["plain_ms"],
        integrity_small_device_ms=ring_pair[("small", "sgd")][
            "device_ms_on"],
        integrity_no_optimizer_device_ms=ring_pair[("full", None)][
            "device_ms_on"])
    for name, r in auto["rows"].items():
        launches[name] = auto["launches"][name]
        results[name] = r
    for name, r in bert_flash["generic"].items():
        launches[name] = bert_run["launches"][name[:-len("_bias")]]
        results[name] = r
    for name, r in bert_flash["tensor_cores_hd64"].items():
        launches[name] = bert_run["launches"][name[:-len("_hd64")]]
        results[name] = r
    rr, mr, pr = resnet_run["ring"], moe_run["ring"], pp_runs["gpipe"]["ring"]
    pp_from = (f"llama_pp_train_path ({pp_runs['gpipe']['steps']} steps a "
               "schedule, Llama-3-8B width, dp=2 x pp=2, 4 microbatches)")
    for name, key in (("ring_rs_update", "rs"), ("ring_ag", "ag")):
        results[name]["extra"].update(
            pp_launches={k: r["launches"][name] for k, r in pp_runs.items()},
            pp_launches_from=pp_from + ", one a step for each of the 2 "
            "stage groups", pp_shape=pr["shape"],
            pp_device_ms=pr[key + "_device_ms"],
            pp_bound_ms=pr[key + "_bound"][0],
            pp_bound_by=pr[key + "_bound"][1])
        results[name]["extra"].update(
            moe_sp_launches=moe_sp_run["launches"][name],
            moe_sp_launches_from=(
                f"moe_sp_train_path ({moe_sp_run['steps']} steps, one a "
                "step for each of the 2 ep groups, unfused: the clip "
                "between the reduce-scatter and the update)"),
            moe_shape=mr["shape"],
            moe_launches=moe_run["launches"][name],
            moe_launches_from=(f"moe_train_path ({moe_run['steps']} steps, "
                               "one a step for each of the 2 ep groups)"),
            moe_device_ms=mr[key + "_device_ms"],
            moe_bound_ms=mr[key + "_bound"][0],
            moe_bound_by=mr[key + "_bound"][1])
        results[name]["extra"].update(
            resnet_shape=rr["shape"],
            resnet_launches=resnet_run["launches"][name],
            resnet_launches_from=(f"resnet_train_path ({resnet_run['steps']}"
                                  " steps)"),
            resnet_device_ms=rr[key + "_device_ms"],
            resnet_call_ms=rr[key + "_call_ms"],
            resnet_plain_ms=rr[key + "_plain_ms"],
            resnet_bound_ms=rr[key + "_bound"][0],
            resnet_bound_by=rr[key + "_bound"][1])
    dec_row, pre_row = paged["decode GQA ps16"], paged["prefill GQA ps16"]
    results["paged_attend"] = {
        "max_abs_err": max(r["max_abs_err"] for r in paged.values()),
        "ms": dec_row["ms"], "plain_ms": dec_row["plain_ms"],
        "bound": dec_row["bound"], "library_ms": dec_row["library_ms"]}
    also = {"ring_rs_update": REF + "/ops/ring_pallas.py:397",
            "ring_ag": REF + "/ops/ring_pallas.py:1144",
            "ring_hop_rs": REF + "/ops/ring_pallas.py:397",
            "ring_hop_ag": REF + "/ops/ring_pallas.py:1144"}
    out = []
    pp_axes_from = {
        "pp_sp": (f"llama_pp_sp_train_path ({pp_sp_runs['gpipe']['steps']} "
                  "steps a schedule, Llama-3-8B width, dp=2 x pp=2 x sp=2, "
                  "2 microbatches, remat; GPipe on the ring attention, the "
                  "1F1B schedules on the gathered attention)"),
        "moe_pp": (f"moe_pp_train_path ({moe_pp_runs['gpipe']['steps']} "
                   "steps a schedule, Mixtral-8x7B width, 2 layers, dp=1 x "
                   "pp=2 x ep=2 x sp=2, 2 microbatches, remat)")}
    for name in ("ring_rs_update", "ring_ag"):
        results[name]["extra"].update(
            pp_sp_launches={k: r["launches"][name]
                            for k, r in pp_sp_runs.items()},
            pp_sp_launches_from=pp_axes_from["pp_sp"] + ", one a step for "
            "each of the 2 (pp, ep) groups",
            moe_pp_launches={k: r["launches"][name]
                             for k, r in moe_pp_runs.items()},
            moe_pp_launches_from=pp_axes_from["moe_pp"] + (
                ": at dp=1 the reduce-scatter is the identity" if name ==
                "ring_rs_update" else ", one a step for each of the 4 (pp, "
                "ep) groups, the BFP roundtrip at n=1"))
    for name in list(flash_kernels) + list(OFFSET_KERNELS):
        results[name].setdefault("extra", {}).update(
            pp_sp_path_launches={k: r["launches"][name]
                                 for k, r in pp_sp_runs.items()},
            pp_sp_path_launches_from=pp_axes_from["pp_sp"],
            moe_pp_path_launches={k: r["launches"][name]
                                  for k, r in moe_pp_runs.items()},
            moe_pp_path_launches_from=pp_axes_from["moe_pp"])
    tp_from = (f"llama_tp_train_path ({tp_run['steps']} steps, Llama-3-8B "
               "width, 4 layers, dp=2 x tp=2)")
    moe_tp_from = (f"moe_tp_train_path ({moe_tp_run['steps']} steps, "
                   "Mixtral-8x7B width, dp=2 x tp=2 x ep=2)")
    one_launch, per_rank = (r[0] for r in TP_FLASH_SHAPES)
    for name in flash_kernels:
        t, h = tp_flash[one_launch][name], tp_flash[per_rank][name]
        results[name].setdefault("extra", {}).update(
            tp_shape=("B=2, H=32, Hkv=8, S=4096, hd=128, causal, bf16: a dp "
                      "rank's batch, both tp ranks' heads in one launch"),
            tp_launches=tp_run["launches"][name], tp_launches_from=tp_from,
            tp_ms=t["ms"], tp_call_ms=t["call_ms"],
            tp_max_abs_err=t["max_abs_err"], tp_tol_ratio=t["tol_ratio"],
            tp_plain_ms=t["plain_ms"], tp_library_ms=t["library_ms"],
            tp_bound_ms=t["bound"][0], tp_bound_by=t["bound"][1],
            tp_one_rank_shape="B=2, H=16, Hkv=4 (one tp rank's heads)",
            tp_one_rank_ms=h["ms"], tp_one_rank_bound_ms=h["bound"][0],
            tp_one_rank_tol_ratio=h["tol_ratio"],
            moe_tp_path_launches=moe_tp_run["launches"][name],
            moe_tp_path_launches_from=moe_tp_from)
    for name, key in (("ring_rs_update", "rs"), ("ring_ag", "ag")):
        tr_, mr_ = tp_run["ring"], moe_tp_run["ring"]
        results[name]["extra"].update(
            tp_launches=tp_run["launches"][name],
            tp_launches_from=tp_from + ", one a step for each of the 2 tp "
            "groups", tp_shape=tr_["shape"],
            tp_device_ms=tr_[key + "_device_ms"],
            tp_bound_ms=tr_[key + "_bound"][0],
            tp_bound_by=tr_[key + "_bound"][1],
            moe_tp_launches=moe_tp_run["launches"][name],
            moe_tp_launches_from=moe_tp_from + ", one a step for each of "
            "the 4 (tp, ep) groups", moe_tp_shape=mr_["shape"],
            moe_tp_device_ms=mr_[key + "_device_ms"],
            moe_tp_bound_ms=mr_[key + "_bound"][0],
            moe_tp_bound_by=mr_[key + "_bound"][1])
    pp_tp_from = (f"llama_pp_tp_train_path ({pp_tp_runs['gpipe']['steps']} "
                  "steps a schedule, Llama-3-8B width, 4 layers, dp=1 x "
                  "pp=2 x tp=2, 4 microbatches, remat)")
    for name in flash_kernels:
        t = pp_tp_flash[PP_TP_FLASH_SHAPES[0][0]][name]
        results[name]["extra"].update(
            pp_tp_shape=("B=1, H=32, Hkv=8, S=4096, hd=128, causal, bf16: a "
                         "microbatch, both tp ranks' heads in one launch"),
            pp_tp_launches={k: r["launches"][name]
                            for k, r in pp_tp_runs.items()},
            pp_tp_launches_from=pp_tp_from, pp_tp_ms=t["ms"],
            pp_tp_call_ms=t["call_ms"], pp_tp_max_abs_err=t["max_abs_err"],
            pp_tp_tol_ratio=t["tol_ratio"], pp_tp_plain_ms=t["plain_ms"],
            pp_tp_library_ms=t["library_ms"], pp_tp_bound_ms=t["bound"][0],
            pp_tp_bound_by=t["bound"][1])
    pr_ = pp_tp_runs["gpipe"]["ring"]
    results["ring_ag"]["extra"].update(
        pp_tp_launches={k: r["launches"]["ring_ag"]
                        for k, r in pp_tp_runs.items()},
        pp_tp_launches_from=pp_tp_from + ", one a step for each of the 4 "
        "(tp, pp) groups, the BFP roundtrip at n=1",
        pp_tp_shape=pr_["shape"], pp_tp_device_ms=pr_["ag_device_ms"],
        pp_tp_bound_ms=pr_["ag_bound"][0], pp_tp_bound_by=pr_["ag_bound"][1],
        pp_tp_max_abs_err=0.0,
        pp_tp_bitexact_at_tiles=pr_["ag_bitexact_at_tiles"],
        pp_tp_tile_elems=pr_["tile_elems"])
    results["ring_rs_update"]["extra"].update(
        pp_tp_launches={k: r["launches"]["ring_rs_update"]
                        for k, r in pp_tp_runs.items()},
        pp_tp_launches_from=pp_tp_from + ": at dp=1 the reduce-scatter is "
        "the identity")
    new_from = {
        "accum_mlp": ("accum_path (MLP, dp=8, 2 compared steps at "
                      "accum_steps 1 and 4)"),
        "accum_llama": ("accum_path (Llama cell, 4 steps at accum_steps 1 "
                        "and 2)"),
        "data": "llama_data_path (6 steps, accum_steps=2)",
        "codec_auto": ("codec_auto_path (5 cases, 3 steps each of auto and "
                       "the pinned codec)"),
        "queued_mlp": "queued_path (MLP, dp=8, 3 timed steps)",
        "queued_bert": "queued_path (BERT, dp=8, 3 timed steps)"}
    for name in ("ring_rs_update", "ring_ag"):
        results[name]["extra"].update(
            accum_launches={a: r[name] for a, r in accum_mlp.items()},
            accum_launches_from=new_from["accum_mlp"],
            accum_llama_launches={a: r[name]
                                  for a, r in accum_llama.items()},
            accum_llama_launches_from=new_from["accum_llama"],
            data_path_launches=data_run["launches"][name],
            data_path_launches_from=new_from["data"],
            codec_auto_launches=auto_codec_launches[name],
            codec_auto_launches_from=new_from["codec_auto"],
            queued_mlp_launches=queued_mlp[name],
            queued_mlp_launches_from=new_from["queued_mlp"],
            queued_bert_launches=queued_bert[name],
            queued_bert_launches_from=new_from["queued_bert"])
    for name in ("bfp_encode", "bfp_decode", "int8_encode", "int8_decode"):
        results[name].setdefault("extra", {}).update(
            codec_auto_launches=auto_codec_launches[name],
            codec_auto_launches_from=new_from["codec_auto"])
    for name in flash_kernels:
        results[name]["extra"].update(
            data_axes_launches={k: r["launches"].get(name, 0)
                                for k, r in data_axes.items()},
            data_axes_launches_from=("llama_data_axes_path (2 steps each: "
                                     "Llama-3-8B width dp=2 x sp=2, "
                                     "Mixtral-8x7B width dp=2 x ep=2)"),
            accum_llama_launches={a: r[name]
                                  for a, r in accum_llama.items()},
            accum_llama_launches_from=new_from["accum_llama"],
            data_path_launches=data_run["launches"][name],
            data_path_launches_from=new_from["data"])
    tp_paged = tp_serve["paged"]
    results["paged_attend"]["extra"] = dict(
        tp_serving_launches=tp_serve["launches"]["paged_attend"],
        tp_serving_launches_per_tick=tp_serve["runs"][2][
            "paged_launches_per_tick"],
        tp_serving_launches_from=(f"tp_serving_path (Llama-3-8B, tp=2, "
                                  f"{TP_SERVE_REQUESTS} requests)"),
        tp_shape=tp_paged["shape"], tp_ms=tp_paged["ms"],
        tp_call_ms=tp_paged["call_ms"],
        tp_max_abs_err=tp_paged["max_abs_err"],
        tp_plain_ms=tp_paged["plain_ms"],
        tp_library_ms=tp_paged["library_ms"],
        tp_bound_ms=tp_paged["bound"][0], tp_bound_by=tp_paged["bound"][1])
    fleet_from = {
        "path": "fleet_path (1 prefill + 2 decode replicas, 12 requests)",
        "kill": "fleet_kill (fleet_path's traffic, a replica killed)",
        "integrity": ("fleet_handoff_integrity (fleet_path's traffic, a "
                      "wirebit on a handoff)"),
        "autoscale": ("fleet_autoscale (herd traffic, 1 + 1 replicas of 4 "
                      "slots, a spare)")}
    for name in ("paged_attend", "row_checksums"):
        results[name].setdefault("extra", {}).update(
            fleet_launches={k: r["launches"][name] for k, r in fleet.items()},
            fleet_launches_from=fleet_from)
    results["paged_attend"]["extra"].update(
        fleet_handoff_pages=fleet["path"]["handoff"]["pages"],
        fleet_handoff_ms=fleet["path"]["handoff"]["ms"],
        fleet_handoff_checked_ms=fleet["path"]["handoff"]["checked_ms"],
        fleet_handoff_bound_ms=fleet["path"]["handoff"]["bound_ms"])
    a8_from = {
        "elastic": ("elastic_path (7 cells of 4 steps, MLP full width, dp=8, "
                    "integrity on; the collective cell on the codec route)"),
        "durability": ("durability_path (3 steps, 2 restores that train, "
                       "one at dp=4)"),
        "serve_chaos": ("serve_chaos_path (Llama-3-8B, 8 requests, two "
                        "runs under fault plans)"),
        "ckpt_driver": "ckpt_driver_path (train_llama --save=, tiny, dp=2)"}
    for name in ("ring_rs_update", "ring_ag", "bfp_encode", "bfp_decode",
                 "row_checksums"):
        results[name].setdefault("extra", {}).update(
            elastic_launches=elastic["launches"][name],
            elastic_launches_from=a8_from["elastic"],
            durability_launches=durability["launches"][name],
            durability_launches_from=a8_from["durability"])
    for name in ("ring_rs_update", "ring_ag", "flash_fwd_generic",
                 "flash_dq_generic", "flash_dkv_generic"):
        results[name].setdefault("extra", {}).update(
            ckpt_driver_launches=ckpt_driver["launches"][name],
            ckpt_driver_launches_from=a8_from["ckpt_driver"])
    for name in ("paged_attend", "row_checksums"):
        results[name].setdefault("extra", {}).update(
            serve_chaos_launches=serve_chaos["launches"][name],
            serve_chaos_launches_from=a8_from["serve_chaos"])
    a89_from = {
        "reshard": ("reshard_path (MLP full width: 2 + 1 steps at dp=8 -> "
                    "4, AdamW 1 step, int8-EF 2 steps; the transfers' "
                    "integrity launches)"),
        "elastic_reshard": ("elastic_reshard_path (6 runs: the (4, 2) "
                            "ladder, 4 MTTR turns, the wirebit "
                            "fall-through; integrity on)"),
        "obs": (f"obs_path (the first obs_metrics=True turn, {OBS_STEPS} "
                "steps: the BFP roundtrip of codec_obs_rel_err)")}
    for name in ("ring_rs_update", "ring_ag", "bfp_encode", "bfp_decode",
                 "int8_encode", "int8_decode", "row_checksums"):
        results[name].setdefault("extra", {}).update(
            reshard_launches=reshard["launches"][name],
            reshard_launches_from=a89_from["reshard"],
            elastic_reshard_launches=elastic_rs["launches"][name],
            elastic_reshard_launches_from=a89_from["elastic_reshard"],
            obs_launches=obs["launches"][name],
            obs_launches_from=a89_from["obs"])
    for name in ("ring_rs_update", "ring_ag", "bfp_encode", "bfp_decode"):
        results[name].setdefault("extra", {}).update(
            helpers_launches=helpers["launches"][name],
            helpers_launches_from=(
                "helpers_path (all_reduce_mean: MLP full width and 4 MiB a "
                "rank, dp=8; all_reduce_bucketed: BERT-base gradients, one "
                "launch of each a bucket; bfp_ste: plain torch)"))
    for name, (src, repl) in meta.items():
        r = results[name]
        bound_ms, bound_by = r["bound"]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": repl, "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": r.get("library_ms")}
        if name in also:
            row["also_replaces"] = also[name]
        row.update(r.get("extra", {}))
        if name == "paged_attend":
            row.update(shape="decode GQA ps16 (R=16, H=32, kv=8, T=1)",
                       library=LIBRARY_ROUTE, prefill_shape=(
                           "prefill GQA ps16 (R=1, H=32, kv=8, T=256)"),
                       q_dtype="bfloat16 (the serving path's)",
                       call_ms=dec_row["call_ms"],
                       prefill_ms=pre_row["ms"],
                       prefill_call_ms=pre_row["call_ms"],
                       prefill_q_f32_ms=paged["prefill GQA ps16 q f32"][
                           "ms"],
                       prefill_plain_ms=pre_row["plain_ms"],
                       prefill_bound_ms=pre_row["bound"][0],
                       prefill_bound_by=pre_row["bound"][1],
                       prefill_bound_f32_ms=pre_row["bound_f32_ms"],
                       prefill_library_ms=pre_row["library_ms"],
                       moe_serving_launches=moe_serve["launches"][
                           "paged_attend"],
                       moe_serving_launches_from=(
                           f"moe_serving_path (Mixtral-8x7B width, "
                           f"{MOE_SERVE_LAYERS} layers)"))
        if name in flash_kernels:
            row.update(shape=FLASH_SHAPES[0][0], library=FLASH_LIBRARY,
                       launches_from="llama_train_path",
                       split_floor_ms=r["split_floor_ms"],
                       sp_path_launches=sp_run["launches"][name],
                       moe_path_launches=moe_run["launches"][name],
                       moe_path_launches_from=(
                           f"moe_train_path ({moe_run['steps']} steps, "
                           "Mixtral-8x7B width, dp=2 x ep=2)"),
                       sp_path_launches_from=(
                           f"llama_sp_train_path ({sp_run['steps']} steps; "
                           "the diagonal hops)"),
                       sp_remat_path_launches=remat_run["launches"][name],
                       sp_remat_path_launches_from=(
                           f"llama_sp_remat_path ({remat_run['steps']} "
                           "steps; the diagonal hops, the forward twice)"),
                       moe_sp_path_launches=moe_sp_run["launches"][name],
                       moe_sp_path_launches_from=(
                           f"moe_sp_train_path ({moe_sp_run['steps']} "
                           "steps, dp=2 x sp=2 x ep=2, remat; the "
                           "diagonal hops)"),
                       pp_path_launches={k: r["launches"][name]
                                         for k, r in pp_runs.items()},
                       pp_path_launches_from=pp_from + ", remat")
        if name in OFFSET_KERNELS:
            B_, H_, kv_, Sl_ = SP_HOP
            row.update(shape=(f"past ring hop: B={B_}, H={H_}, Hkv={kv_}, "
                              f"Sq=Sk={Sl_}, hd=128, bf16, q_offset "
                              f"{Sl_}, k_offset 0 (every key seen)"),
                       instantiation="the offset one (ELb1E)",
                       library=FLASH_LIBRARY + " (is_causal=False)",
                       launches_from=(f"llama_sp_train_path ("
                                      f"{sp_run['steps']} steps; the past "
                                      "hops)"),
                       sp_remat_path_launches=remat_run["launches"][name],
                       moe_sp_path_launches=moe_sp_run["launches"][name],
                       moe_sp_path_launches_from=(
                           f"moe_sp_train_path ({moe_sp_run['steps']} "
                           "steps; the past hops, the forward twice)"),
                       moe_sp_hop_shape=(
                           "past ring hop: B={}, H={}, Hkv={}, Sq=Sk={}, "
                           "hd=128, bf16, q_offset {}, k_offset 0".format(
                               *MOE_SP_HOP, MOE_SP_HOP[3])),
                       max_abs_err_over=[c[0] for c in SP_OFFSET_CASES
                                         if c[3] != c[4]])
        if name in ("int8_encode", "int8_decode"):
            row.update(shape=f"{INT8_PATH_ELEMS} f32, block 16, stochastic",
                       launches_from="int8_train_path")
        if name in ("bfp_encode", "bfp_decode"):
            row.update(launches_from="codec_route")
        if name == "row_checksums":
            row.update(launches_from="integrity_path",
                       serving_launches=run["launches"]["row_checksums"],
                       replaces_kind=("an XLA-fused jnp function "
                                      "(gathered_page_checksums), no "
                                      "pallas_call"))
        if name in auto["rows"]:
            row.update(shape="tiny f32 Llama, head_dim 16, S=128",
                       launches_from="auto_route", call_ms=r["call_ms"])
        if name in bert_flash["generic"] or name in bert_flash[
                "tensor_cores_hd64"]:
            row.update(shape=("BERT-base attention: B=8, H=12, S=512, hd=64, "
                              "bf16, non-causal, padding mask as key bias"),
                       launches_from="bert_train_path", library=BERT_LIBRARY,
                       call_ms=r["call_ms"], tol_ratio=r["tol_ratio"])
        if name in bert_flash["generic"]:
            row.update(bert_path_kernel=name.replace("generic_bias",
                                                     "hd64"))
        if name in bert_flash["tensor_cores_hd64"]:
            row.update(instantiation="head_dim 64, key bias (ILb1ELi64E)",
                       no_bias_ms=r["no_bias_ms"],
                       replaced_generic_ms=r["replaced_generic_ms"],
                       split_floor_ms=r["split_floor_ms"])
        if name in flash_kernels:
            tcb = bert_flash["tensor_cores"]
            row.update(bias_shape=("B=2, H=8, Hkv=8, S=1024, hd=128, bf16, "
                                   "padding mask as key bias"),
                       **{f"bias_{c}_{key}": tcb[c]["times"][name][key]
                          for c in tcb for key in ("bias_ms", "no_bias_ms",
                                                   "bias_over_no_bias",
                                                   "bound_ms",
                                                   "bias_bound_ms")},
                       bias_tol_ratio=max(max(tcb[c]["tol_ratio"].values())
                                          for c in tcb))
        out.append(row)
    for (label, st), r in stages["rows"].items():
        if st is None:
            continue
        form = "stream" if r["streaming"] else "resident"
        bound_ms, bound_by = r["bound"]
        out.append({
            "name": f"ring_rs_ablate[{label}:{form}:{st}]", "route": "cuda",
            "source": PORT + "/csrc/ring_rs.cu",
            "replaces": REF + ("/ops/ring_pallas.py:777" if r["streaming"]
                               else "/ops/ring_pallas.py:397"),
            "launches": stages["launches"][f"{form}:{st}"],
            "launches_from": "ring_cost_stages",
            "max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": r["shape"], "opt_kind": r["opt_kind"],
            "ms_is": "device time", "full_kernel_ms": stages["rows"][
                (label, None)]["ms"],
            "max_abs_err_of": ("the ablate=None instantiation against the "
                               "plain version at this shape (an ablated "
                               "variant computes garbage by design)"),
            "plain_ms_of": "the plain reduce-scatter at this shape"})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
