#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py [--out FILE]        # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse          # control flow only, tiny, CPU

Phases (any failure raises and the exit code is non-zero):

1. Print the card's name and power limit, build the CUDA kernels from the
   sources under ``src/repro_torch/kernels`` (one nvcc each, in parallel)
   and time the build.
2. The detection path, once, through the port's entry points, with every
   kernel launch count set to 0 just before it and read just after: a
   seeded synthetic EM volume (uint8, 8192 x 8192 x 256 at level 0 —
   65,536 cuboids of 128 x 128 x 16, 16 GiB packed) made on the device
   slab by slab and ingested, the hierarchy built to level 5, and the
   paper's parallel synapse detection at level 2 (64 tiles of 512 x 512 x
   64, 20 workers, batches of 40, large-structure mask from level 5).
   `cutout_gather` must have launched.
3. Its results checked: 4 tiles re-run with cutouts through the plain
   gather give the stored annotations, one stored id per detected label
   and voxel for voxel; a stored level-1 box equals the downsampled level-0
   box; a small pipeline agrees between the card and the CPU reference
   path.  A torch.profiler window over 2 tiles gives the device's idle
   share.
4. `cutout_gather` against its plain version on the card (bit-exact) over
   dtypes, aligned, unaligned and volume-edge boxes, a 1024 x 1024 x 64 box
   of level 0 and a box whose cells lie past byte offset 2^31; timed with
   CUDA events (median of >= 20) beside the bound set by the memory rate.
5. The serving path, once, at smollm-135m's full width in bf16 (seeded
   weights), with the launch counts set to 0 just before it and read just
   after: 32 prompts of 2,048 tokens through `make_prefill_step` (cache of
   2,176), 128 greedy steps through `make_serve_step`, then a
   `ContinuousBatcher` of 16 slots draining 24 requests (prompts of 64-512
   tokens from a seed, 64 new tokens each).  `flash_attention` and
   `flash_decode` must have launched.  Prints time to first token, prefill
   and decode tokens/s, the batcher's tokens/s and occupancy, and peak
   memory (one run each); a torch.profiler window over decode steps gives
   the device's idle share.
6. Its results checked: a 2-layer fp32 smollm at the smoke widths serves
   the same greedy tokens on the card and on the CPU, through
   `make_serve_step` and through `ContinuousBatcher`; at full width, layer
   0's attention through the kernels agrees with the plain versions on the
   same card tensors, at the prefill of the whole batch and at a decode
   step over the whole cache with mixed lengths (split kv axes): in bf16
   within rtol 2e-2 and an atol of 5% of the outputs' mean magnitude, and
   with the tensors taken to fp32 within 2e-5; `flash_decode` at the
   batcher's shape (16 slots, lengths from 1 to the cache) within the
   small cases' tolerances.
7. `flash_attention` and `flash_decode` against their plain versions on
   the card over the shapes of tests/test_kernels.py (fp32 at 2e-5, bf16
   at 2e-2; causal, non-causal, window 48; per-sequence lengths), smollm's
   heads over 1,024-2,176 cached positions (split kv axes) and 10 and 16
   query heads per kv head (`flash_decode` takes any group), then
   timed at the serving path's shapes (CUDA events, median of >= 20)
   beside the bound, the plain version and one PyTorch call computing the
   same function (scaled_dot_product_attention, timed here only).
8. The ssm serving path, once, at mamba2-370m's full width in bf16
   (seeded weights), with the launch counts set to 0 just before it and
   read just after: 32 prompts of 2,048 tokens through `make_prefill_step`
   (the chunked forward builds the state cache), 128 greedy steps, then a
   `ContinuousBatcher` of 16 slots draining 32 requests (prompts of 64-256
   tokens, 32 new tokens each).  `ssd_scan` must have launched.  The same
   rates and profiles as the dense path.
9. Its results checked: a 2-layer fp32 mamba2 at the smoke widths (A and
   dt by Mamba-2's published init) serves the same greedy tokens on the
   card and on the CPU, batched and through the batcher; at full width,
   layer 0's mixer with the published A and dt, scan through the kernel
   and through the plain version on the same card tensors, in bf16 and in
   fp32 (the scan's outputs within rtol 1e-4 and 1e-4 of their max |out|,
   see SSD_REL), with the per-chunk decay and the carried state's share of
   |y| printed.
10. `ssd_scan` against its plain version over the shapes of
   tests/test_kernels.py, a chunk that is not a power of two, a ragged last
   chunk, mamba2-370m's heads and every instance of the bf16 body, fp32
   and bf16 (bf16 also against `ssd_scan_split_ref`, the tensor-core
   body's roundings emulated), the JAX tests' draws and the published
   ranges, all within SSD_REL; then timed at the prefill's shape beside the
   bound and the plain version (no single PyTorch call computes it), with
   the count of `HMMA` instructions in the built library's SASS (it fails
   if there are none) and the launch plan the built kernel reports.
11. The MoE serving path, once, at granite-moe-1b-a400m's full width in
   bf16 (seeded weights), with the launch counts set to 0 just before it
   and read just after: 32 prompts of 2,048 tokens (one global dispatch of
   65,536 tokens, capacity 20,480), 128 greedy steps, then a
   `ContinuousBatcher` of 16 slots draining 24 requests (prompts of 64-256
   tokens, 32 new tokens each).  `moe_gemm` must have launched once per
   layer of the prefill and of every decode step, and `flash_attention`
   and `flash_decode` (16 query heads over 8 kv heads) must have launched.
   The same rates and profiles as the other paths, and the share of
   dispatched picks dropped at the prefill and at one decode step.
12. Its results checked: a 2-layer fp32 granite at the smoke widths serves
   the same greedy tokens on the card and on the CPU, batched and through
   the batcher, with any top-k pick that differs between the two reported
   beside its router-probability gap; at full width, layer 0's MoE on the
   prefill's tokens, dispatched twice (the routing must be equal), through
   the kernel and through the plain version: fp32 within rtol 1e-4 and
   1e-4 of max |y|, bf16 within rtol 2e-2 and 5% of mean |y|; layer 0's
   attention (16 query heads over 8 kv heads) and the batcher's decode
   attention at this path's shapes, as in phase 6.
13. `moe_gemm` against its plain version over the shapes of
   tests/test_kernels.py, a ragged (3, 130, 24, 40) and granite's experts
   (C 640, and the decode step's C 10 and the batcher's C 8), fp32 and
   bf16, counts in [0, C] with 0, C and one past C, the buffer zero or
   random past the counts; then timed at the prefill's shape with layer
   0's own counts and at a decode step (C 10) beside the bound, the plain
   version and a yardstick of three bf16 `torch.bmm` over the whole
   buffer (no single PyTorch call computes this function), with the
   host's time to enqueue a decode-step call.
14. The tile-order path of `morton_matmul`, once, with the launch counts set
   to 0 just before it and read just after: the port's public
   `morton_matmul` in bf16 at its default blocks (256 x 256 x 256) on the
   study's shapes, M = N = K = 8192 and 6,000 x 10,000 x 4,000, in each
   order; the orders' outputs must be bit-identical and finite.  Then the
   kernel against its plain version (the fp32 product rounded to the dtype)
   over the shapes of tests/test_kernels.py at 128 x 128 x 64 (the clamped
   384 x 256 grid and the padding shape among them) and the study's shapes
   at 128 x 128 x 64 and 256 x 256 x 256, fp32 and bf16, each order, within
   the JAX test's |got - want| / (|want| + 1) < 1e-4 (fp32) and 3e-2 (bf16),
   the fp32 one grown as K / 512 past the test's K 512 (`mm_bench.rel_tol`);
   the orders bit-identical; a traced call per order showing that block b
   computed tile ``tile_order[b]`` and every tile exactly once.  Then the
   8192^3 bf16 product timed per order at both block sizes, in turns, beside
   the bound, the plain version and `torch.matmul` in bf16 (a yardstick).

15. The rest of the dense family, once each at full width in bf16 (seeded
   weights, drawn on the card and timed), with the launch counts set to 0
   just before and read just after: gemma-2b (8 query heads over 1 kv
   head, D 256, GeGLU) and minitron-8b (32 over 8, D 128, an untied
   256,000-word head), 32 prompts of 2,048 through `make_prefill_step`
   (cache 2,176) and 32 greedy steps.  `flash_attention` must have launched
   once a layer and `flash_decode` once a layer and step.  TTFT, decode
   tokens/s and peak memory, and profiles of decode steps and the prefill
   as in phase 5; layer 0's attention through the kernels
   against the plain versions (sliced over the batch) at the prefill and a
   decode step, bf16 and fp32, as in phase 6.  Then 2-layer fp32 models of
   gemma-2b, minitron-8b and llama3-405b (rope_theta 500,000) at the smoke
   widths serve the same greedy tokens on the card and on the CPU.
16. Dense training at smollm-135m's full width in bf16, through
   `launch.train`'s calls (`build_state`, `synthetic_corpus`, the Morton
   `DataPipeline`, `make_train_step`), every layer under the config's
   activation recompute (``remat="block"``): first the gradient check
   (phase 17), then, with the launch counts set to 0, 12 steps of 16 x
   2,048 tokens in 2 microbatches at lr 3e-3 (warm-up 5, cosine).  The loss
   must fall from the first step to the last; `flash_attention` must have
   launched exactly 30 layers x 2 passes (the forward, and the recompute
   of ``block``; `FlashAttention`'s backward differentiates the plain
   version) x 2 microbatches x 12 steps times and `cutout_gather` at least
   once a step (the pipeline's rows).  Median step time after 2 warm steps,
   tokens/s, peak memory, the device's idle share over 2 profiled steps
   and a step's split into forward, backward (and its attention recompute)
   and optimizer (the device time launched inside `make_train_step`'s
   profiler ranges), and model FLOP/s as a share of the bf16 peak
   (`train_flops`); then one step each with bf16 and int8 gradient
   compression, and 2 steps each under ``remat="none"`` and ``"dots"``
   (step time and peak memory beside ``block``'s).
17. Training checks: the pipeline's batches of the first and last
   counted steps, read through `cutout_gather` at the path's shapes,
   equal to a CPU token store's (the plain gather) bit for bit.  On the
   first batch's first 2 sequences every
   parameter's gradient through the kernel route against the same weights
   with attention through the plain version (`plain_kernels`), in bf16
   and with the weights taken to fp32, at the tolerances of
   `training_grad_check`; w_q, w_k and w_v nonzero.  A 2-layer fp32 smollm
   at the smoke widths trains 5 steps on the card and on the CPU from the
   same weights and batches: losses and grad norms within rtol 1e-4, the
   parameters within 2 x the sum of the steps' lr.
18. MoE training at granite-moe-1b-a400m's full width in bf16, as phases
   16-17 (the same calls and batch, 6 steps, no compressed steps): first
   the gradient check on one sequence, every leaf through the kernel route
   (`moe_gemm` inside `MoeGemm`, `flash_attention` inside
   `FlashAttention`) against the plain route, bf16 (phase 17's criteria)
   and fp32 (within rtol 1e-4 and 1e-4 of the leaf's max |g|), the plain
   route taking the kernel route's top-k picks and the flips it would have
   made counted; then `moe_gemm`'s bf16 backward kernel against its plain
   twin `moe_gemm_grad_ref` on layer 0's dispatched buffer of the counted
   run's first microbatch (each leaf within 2^-9 in norm and 2^-5 of its
   max |g|, no farther from the fp64 gradient than 1.01 x the twin); then
   the counted run: the
   loss must fall, every step's gradient norm be finite, `moe_gemm` and
   `flash_attention` launch exactly 24 layers x 2 passes x microbatches x
   steps times, the backward kernel 24 x microbatches x steps times and
   the plain recompute never,
   and `cutout_gather` at least once a step.  The split reads
   ``moe_gemm.recompute`` and ``flash_attention.recompute``.  Then a
   2-layer fp32 granite trains alike on card and CPU, with its routing
   flips reported.
19. ssm training at mamba2-370m's full width in bf16, at its published
   chunk of 256 and with `build_state`'s init, as phase 18: `ssd_scan`
   (inside `SsdScan`) launches exactly 48 x 2 passes x microbatches x
   steps times (6 steps);
   the bf16 gradients are held to the plain route's by their distance
   from the fp32 ones (`bf16_holds`);
   the split reads ``ssd_scan.recompute``; the 2-layer fp32 model trains
   alike on card and CPU at chunk 256 over 256 steps, where the plain
   scan's decay overflowed exp before its repair.
20. Checkpoint and restart on the card: each family's smoke model (and
   the patch frontend's, internvl2-76b) through
   `launch.train.main`, 10 steps with ``--ckpt-every 5
   --inject-failure-at 8`` against the same run without a failure: the
   recovery log shows the restore to step 5 and the replay, the replayed
   losses are equal, the final parameters and optimizer state are equal
   bit for bit, and the step-10 checkpoint restores on the CPU bit for bit.
21. The annotation service on the detection path's own state (run after
   phase 4, before that state is freed), with the launch counts set to 0
   just before it and read just after: index-only `bounding_box` of every
   detected id (each box holds every stored voxel of its id);
   `batch_read_objects` of 40 ids (each equal to the plain-gather cutout
   of its box, masked to the id); `objects_in_region` over the 4
   re-check tiles (the sorted unique stored ids); `distance` between two
   neighbouring synapses (equal to numpy's chunked norm); `propagate`
   (levels 3-5; `pending_propagation` true, then false; a level-3 box
   equals the stride-sampled level-2 box); `project` at level 0 (a full
   8,192 x 8,192 z-slice, and the max and mean over z of a 1,024 x 1,024
   x 256 box, each equal to numpy's reduction of the plain-gather
   cutout); `batch_cutout` of 40 boxes, unaligned and at the volume edge
   (each equal to its own `cutout`); the ``exception`` discipline (the
   re-check tiles' stored ids, half of them written first, then all
   shifted by a fixed offset under ``exception``: the primary labels
   equal where(old != 0, old, new) and every touched cuboid's exception
   list equals numpy's); and a one-rank NCCL world: `distributed_cutout`
   of a 1,024 x 1,024 x 64 box of level 0 equals `cutout`, and
   `distributed_write_cutout` (zeros included) equals its numpy oracle.
   `cutout_gather` must have launched; each step is timed (one run).
22. Time series and channels, after the detection state is freed, counted
   as phase 21: a seeded rank-4 uint8 dataset of 2,048 x 2,048 x 64 x 16
   (cuboids 128 x 128 x 16 x 16, 4 GiB) ingested, then aligned, unaligned
   and edge cutouts, each bit-exact against the plain version and the host
   slice; the 1,024 x 1,024 x 32 x 16 box timed with CUDA events (median
   of >= 20) beside its byte bound; and a 3-channel uint16 dataset of
   4,096 x 4,096 x 64 per channel (2 GiB each) written and read back per
   channel.
23. The device store over the host tiers, after phase 22's state is freed,
   counted as phase 21: a seeded uint8 image of 4,096 x 4,096 x 256 (16,384
   cuboids of 128 x 128 x 16, 4 GiB) made on the card with phase 2's
   generator and bulk-loaded, zlib on a thread per core, into a
   `DirectoryBackend` read tier (fsync off) under `tempfile.mkdtemp()`,
   opened with a `LogBackend` write tier (fsync on) by `tiered_store`; 64
   cold reads of 512 x 512 x 64 tiles (each bit-equal to the host volume and
   the plain gather; whole read, host fetch + decode and the copy to the
   card timed, `CutoutStats` and `read_stats` reported), the same tiles
   warm; one cold read's spans; 200 writes of an unaligned 96 x 96 x 12 box
   (p50 and p99 ms; each readable at once from the card and from the tiers
   by a host decode); a reopen whose log replay reads every write back
   cold; `compact_store` beside a thread reading the written boxes (all
   reads bit-equal, the log empty after); an annotation project with a log
   write path (40 objects in one batch, `migrate`, each `object_cutout`
   equal to its numpy oracle, resident and cold).  The free bytes of the
   disk and the tiers' stored bytes are printed.
24. The cluster and the front door, counted as phase 21: a seeded uint8
   image of 4,096 x 4,096 x 128 (8,192 cuboids, 2 GiB) made with phase 2's
   generator and bulk-loaded (zlib level 1, a thread a core) into a
   `ClusterStore` of 4 in-memory nodes, replication 2, a 64 MiB cache a
   node and write-behind on, under a `DeviceCuboidStore` registered with a
   `VolumeService` and served by `FrontDoor` on 127.0.0.1: 64 cold then 64
   warm GETs of 512 x 512 x 64 tiles (8 of them also zlib), beside the same
   read in-process (each bit-equal to the host volume and the plain
   gather; a cold read split into host fetch + decode, the copy, the
   gather, and encode + send); 200 unaligned 96 x 96 x 12 PUTs with
   ``sync`` (p50, p99), each read back at once over HTTP, then ``POST
   /flush``; a ``POST /batch/cutout`` of 40 boxes up to the tile; 16 client
   threads of 64 x 64 x 16 GETs for 10 s (requests/s, coalesced batches,
   deduped, shed); ``POST /em/nodes`` (4 -> 5) then ``DELETE /em/nodes/0``
   under 8 readers of 256 x 256 x 32 and a writer (``lost_reads`` must be
   0; the topology before and after); a fresh device store over the moved
   cluster reads the whole image and every acknowledged write; an
   annotation project of 40 objects on its own cluster behind the same
   service (``GET /objects/<id>/boundingbox`` equal to the index,
   ``/cutout`` to numpy); ``GET /em/stats`` and ``/metrics``.  Each stage's
   wall time is printed.
25. Storage faults, counted as phase 21: a seeded uint8 image of 4,096 x
   4,096 x 64 (4,096 cuboids, 1 GiB; phase 2's generator) on a
   `ClusterStore` of 4 in-memory nodes at replication 2 (phase 24's
   settings), every node a `FaultyNode` with a crash-only `FaultPlan`
   (seeds 0-3), under a `DeviceCuboidStore` served by `FrontDoor` on
   127.0.0.1, with the cluster's prober and a `StorageSupervisor`
   (`ClusterWatch(dead_ticks=2)`, ticks of 0.25 s) running.  (a) 32 cold
   GETs of 512 x 512 x 64 tiles and 100 synced PUTs of 96 x 96 x 12;
   (b) 8 readers of cuboids never read before (every GET a cold load that
   reaches the nodes) and a writer, node 1 crashed after 2 s, until the
   supervisor has removed it and replication is back at target (30 s at
   most); (c) node 0 crashed under the writer until it is seen dead, then
   restarted before the failover's second tick, the supervisor's resync
   draining its repair queue; (d) 32 cold and 32 warm GETs from a fresh
   device store over the healed cluster, and 100 PUTs.  A writer retries
   an unacknowledged PUT until it is acknowledged; each failed answer is
   a client-visible error.  Per stage GET and PUT p50 / p99 and the error
   count; the seconds from the crash to `dead`, to the failover and to
   replication back at target; the keys moved, the supervisor's log and
   each plan's counters.  Gates: every 200 equals the oracle (the host
   volume with the acknowledged writes applied) and the plain gather;
   `lost_reads` 0; replication healed with no operator call; no failover
   and `repair_pending` 0 after the blip; every acknowledged PUT read
   back over HTTP and a fresh device store's whole read equal to the
   oracle.
26. recurrentgemma-2b serving at full width in bf16 (26 layers, RRA, d
   2,560, window 2,048; seeded weights), counted as phase 5: 32 prompts of
   2,048 through `make_prefill_step` (one forward pass: windowed
   `flash_attention` in the A units, the RG-LRU doubling scan in the R
   units; cache 2,176, so the window holds 2,048) and 64 greedy steps,
   each rotating the window (`flash_decode` with lengths min(index + 1,
   2,048)).  `flash_attention` launches once an A unit, `flash_decode`
   once an A unit and step.  TTFT, decode tokens/s, peak memory, profiles
   of 8 decode steps and the prefill, and the RG-LRU scan alone at the
   prefill's shape (CUDA events).  Checks: the first A unit's
   `flash_attention` at 2 x 4,096 with window 2,048 and `flash_decode`
   over the path's window cache with per-sequence lengths around 2,048
   (the plan's splits and 8), bf16 and fp32, against the plain versions
   at phase 6's tolerances, then timed beside the bound, the plain
   version and SDPA with the band mask; 2 RRA units at the smoke widths
   in fp32: the one-pass prefill's cache equals stepping the prompt
   through `decode_step` on the card; a 4-layer fp32 model serves the
   same tokens on the card and on the CPU, batched and through the
   batcher.
27. seamless-m4t-medium serving at full width in bf16 (12 + 12 layers, d
   1,024, MHA 16), counted as phase 5: `make_prefill_step` encodes 32 x
   2,048 seeded frames (non-causal `flash_attention`) and builds the cross
   K/V beside a self cache of 2,176, then one BOS token and 64 greedy
   steps (`flash_decode` for the self-attention, lengths index + 1, and
   the cross-attention, lengths 2,048).  TTFT (encode, cross K/V and the
   first token), decode tokens/s, peak memory and a profile of 8 decode
   steps.  Checks: encoder layer 0's `flash_attention` on the path's
   frames, and with 4 times more queries than keys (unmasked attention
   reads no offset, so the wrapper takes Sq > Skv), decoder layer 0's two
   `flash_decode` calls, bf16 and fp32, against the plain versions, then
   timed beside the bound, the plain version and SDPA; a 2 + 2-layer fp32
   model gives the same tokens on the card and on the CPU, and
   teacher-forced logits within 1e-4.
28. recurrentgemma-2b training at full width in bf16 (26 layers, RRA, d
   2,560, window 2,048, 256,000 words), as phase 16 under ``block`` (each
   layer's input kept, one repeat R, R, A recomputed at a time): 6 steps of
   16 x 2,048 tokens in 16 microbatches of one sequence (the memory
   reckoning at `HYBRID_TRAIN_FULL`) at a peak lr of 3e-4 (at 3e-3 its
   loss rose), the profile over one step.  Before it, `flash_attention`'s
   gradient where the window binds (2 x 4,096, H 10, K 1, D 256, window
   2,048) and unmasked at Sq != Skv (2,048 over 512 and 512 over 2,048,
   H 16, D 64), bf16 and fp32: the forward within phase 6's tolerances,
   dq, dk and dv bit-equal to the plain route's.  The gradient check on one
   sequence: fp32 at the dense family's tolerance, bf16 by the dense
   family's criteria or the ssm family's (`bf16_holds`); the A units' w_q,
   w_k, w_v nonzero; `flash_attention` launches 8 A units x 2 passes x 16
   microbatches x steps times; the split reads ``flash_attention.recompute``;
   the smoke model (4 layers, RRA and R, window 32 over 64 positions)
   trains alike on card and CPU.
29. seamless-m4t-medium training at full width in bf16 (12 + 12 layers, d
   1,024, 256,206 words), as phase 28: each step's frames are the JAX
   driver's draws (`launch.train.frontend_inputs`); 6 steps of 16 x 2,048
   in 4 microbatches; `flash_attention` launches (12 encoder + 2 x 12
   decoder calls) x 2 passes x 4 microbatches x steps times.  Then
   internvl2-76b's smoke model with its patch embeddings trains alike on
   card and CPU.
30. arctic-480b serving at full width in bf16, its depth cut from 35 to 2
   layers (the whole model, 480B parameters, does not fit one card; 2
   layers are 27.7e9 parameters, 55.4 GB): d 7,168, 56 query heads over 8
   kv heads of 128, 128 experts top-2 with the dense residual MLP, d_ff
   4,864, 32,000 words untied; the expert leaves drawn on the card one
   (layer, expert) slice at a time.  Counted as phase 5: 32 prompts of
   2,048 through `make_prefill_step` (cache 2,176) and 32 greedy steps;
   `moe_gemm` launches once a layer for the prefill and each step,
   `flash_attention` once a layer, `flash_decode` once a layer a step.
   TTFT, decode tokens/s, peak memory, the shares of picks dropped at the
   prefill and at a decode step, profiles of the prefill and 8 decode
   steps.  Checks: layer 0's MoE on the prefill's tokens dispatched twice
   (equal routing), the kernel over all 128 experts against the plain
   version on a slice of 8 experts (the kernel computes each expert on its
   own, so the slice is exact; the plain version over all 128 in fp32
   would need 53.6 GB more), and kernel and plain on the slice with counts
   0 and C among them, at phase 12's tolerances; layer 0's attention at the
   prefill and at a decode step, the plain version sliced over the batch,
   at phase 6's; then B2, B3 and B5 timed at these shapes beside the bound,
   the plain version and the library call.  arctic's smoke model in fp32
   serves the same tokens and trains alike on card and CPU, and restarts
   bit-equal (phase 20).
31. The dry run (`python -m repro_torch.launch.dryrun`, a child process on
   the host: its fake process group of 512 ranks cannot share a process
   with phase 21's NCCL group): granite-moe-1b-a400m x decode_32k on the
   16 x 16 and 2 x 16 x 16 meshes, arctic-480b and llama3-405b x train_4k
   on 16 x 16.  Each cell's roofline row is printed, a cost model for H100
   SXM constants, not a measurement; a cell not ``ok`` fails the phase.

`flash_attention`, `morton_matmul` and `moe_gemm` have two bodies, a
tensor-core one for bf16 and an FMA one for fp32; `flash_decode` has one,
whose splits of the kv axis merge inside its launch; each phase prints
which body ran.

The last three lines are the card's name and power limit, the JSON kernel
report, and ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import base64
import bisect
import concurrent.futures as cf
import contextlib
import dataclasses
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib

from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

from repro_torch.carry import (lm_params_from_numpy, lm_params_to_numpy,  # noqa: E402
                               train_state_from_tree, train_state_to_tree)
from repro_torch.ckpt import restore_checkpoint  # noqa: E402
from repro_torch.configs import arctic_480b, get_config, get_smoke_config  # noqa: E402
from repro_torch.cluster import ClusterStore, VolumeService  # noqa: E402
from repro_torch.core import cutout as cut  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core import morton  # noqa: E402
from repro_torch.core.annotations import AnnotationProject  # noqa: E402
from repro_torch.core.cuboid import (CuboidGrid, DatasetSpec,  # noqa: E402
                                     downsample_block)
from repro_torch.core.compact import compact_store  # noqa: E402
from repro_torch.core.store import (CuboidStore, DeviceCuboidStore,  # noqa: E402
                                    DirectoryBackend)
from repro_torch.core.wal import LogBackend, TierPolicy, tiered_store  # noqa: E402
from repro_torch.device import h100_peaks  # noqa: E402
from repro_torch.kernels import _bench, _build  # noqa: E402
from repro_torch.kernels.cutout_gather import ops as gather_ops  # noqa: E402
from repro_torch.kernels.cutout_gather.ref import cutout_gather_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (GRAD_F64, GRAD_MAX,  # noqa: E402
                                                     GRAD_NORM, GRAD_VS_F64, LSE_ATOL,
                                                     flash_attention_grad_f64,
                                                     flash_attention_grad_ref,
                                                     flash_attention_lse_ref,
                                                     flash_attention_ref, grad_gaps,
                                                     outside_grad_limits)
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import bench as mg_bench  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as mg_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import (moe_gemm_grad_f64, moe_gemm_grad_ref,  # noqa: E402
                                             moe_gemm_ref)
from repro_torch.kernels.morton_matmul import bench as mm_bench  # noqa: E402
from repro_torch.kernels.morton_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.morton_matmul.ref import morton_matmul_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_split_ref  # noqa: E402,E501
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.registry import REGISTRY  # noqa: E402
from repro_torch.data import DataPipeline, PipelineConfig  # noqa: E402
from repro_torch.ft import (ClusterWatch, FaultPlan, StorageSupervisor,  # noqa: E402
                           faulty_factory)
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build_model, count_params, model_specs  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.lm import hybrid_layout  # noqa: E402
from repro_torch.models.params import (DTYPES, init_params, map_specs,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.models.rglru import rglru_scan  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import loss_and_grads, loss_fn, make_train_step  # noqa: E402
from repro_torch.models.attention import attention, qkv  # noqa: E402
from repro_torch.models.layers import rms_norm, rotary  # noqa: E402
from repro_torch.models.ssm import ssm_inputs, ssm_output  # noqa: E402
from repro_torch.serve import (ContinuousBatcher, FrontDoor, Request,  # noqa: E402
                               make_prefill_step, make_serve_step)
from repro_torch.vision import synapse_detector as sd  # noqa: E402

KERNELS = {
    "cutout_gather": dict(
        route="cuda",
        source="src/repro_torch/kernels/cutout_gather/kernel.cu",
        replaces="src/repro/kernels/cutout_gather/kernel.py:30",
        ops=gather_ops, paths=("detection", "training", "moe_training", "ssm_training",
                               "hybrid_training", "encdec_training", "annotation",
                               "timeseries", "tiered", "cluster", "faults")),
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/kernel.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:90",
        ops=fa_ops, paths=("serving", "moe_serving", "gemma_serving", "minitron_serving",
                           "training", "moe_training", "hybrid_serving", "encdec_serving",
                           "hybrid_training", "encdec_training", "arctic_serving")),
    "flash_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_decode/kernel.cu",
        replaces="src/repro/kernels/flash_decode/kernel.py:66",
        ops=fd_ops, paths=("serving", "moe_serving", "gemma_serving", "minitron_serving",
                           "hybrid_serving", "encdec_serving", "arctic_serving")),
    "ssd_scan": dict(
        route="cuda",
        source="src/repro_torch/kernels/ssd_scan/kernel.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:67",
        ops=ssd_ops, paths=("ssm_serving", "ssm_training")),
    "moe_gemm": dict(
        route="cuda",
        source="src/repro_torch/kernels/moe_gemm/kernel.cu",
        replaces="src/repro/kernels/moe_gemm/kernel.py:55",
        ops=mg_ops, paths=("moe_serving", "moe_training", "arctic_serving")),
    "morton_matmul": dict(
        route="cuda",
        source="src/repro_torch/kernels/morton_matmul/kernel.cu",
        replaces="src/repro/kernels/morton_matmul/kernel.py:49",
        ops=mm_ops, paths=("morton_matmul",)),
}

FULL = dict(volume=(8192, 8192, 256), n_resolutions=6, r=2,
            tile=(512, 512, 64), lowres=5, workers=20, n_blobs=49152,
            slab=128, reduce_box=((2048, 3072, 0), (3072, 4096, 256)),
            dist_box=((1024, 5120, 64), (2048, 6144, 128)), batch=40)
TINY = dict(volume=(256, 256, 32), n_resolutions=3, r=1,
            tile=(64, 64, 32), lowres=2, workers=3, n_blobs=48, slab=64,
            reduce_box=((64, 96, 0), (128, 160, 32)),
            dist_box=((32, 160, 8), (96, 224, 24)), batch=6)
# phase 22: a rank-4 time series (default cuboids 128 x 128 x 16 x 16) and
# a 3-channel uint16 dataset
TS_FULL = dict(volume=(2048, 2048, 64, 16), slab=256,
               box=((0, 0, 0, 0), (1024, 1024, 32, 16)),
               ch_volume=(4096, 4096, 64), channels=3)
TS_TINY = dict(volume=(64, 64, 32, 8), slab=16,
               box=((0, 0, 0, 0), (32, 32, 16, 8)),
               ch_volume=(64, 64, 32), channels=3)
# phase 23: a uint8 image on the host tiers (default cuboids 128 x 128 x 16),
# made with phase 2's generator (blobs at level ``r``'s density)
TIER_FULL = dict(volume=(4096, 4096, 256), r=2, n_blobs=12288, slab=256,
                 tile=(512, 512, 64), reads=64, writes=200, wbox=(96, 96, 12),
                 objects=40, obj=(8, 40))
TIER_TINY = dict(volume=(256, 256, 32), r=2, n_blobs=12, slab=128,
                 tile=(64, 64, 16), reads=4, writes=6, wbox=(24, 24, 6),
                 objects=6, obj=(4, 12))
# phase 24: a uint8 image on a cluster of in-memory nodes (cuboids 128 x 128
# x 16) served over HTTP: ``cache`` bytes a node, ``clients`` load threads
# for ``load_s`` seconds, ``readers`` threads during the moves; zlib on
# ``zlib_reads`` of the warm tiles (its encode runs at tens of MB/s a core)
CLUSTER_FULL = dict(volume=(4096, 4096, 128), r=2, n_blobs=6144, slab=256, nodes=4,
                    replication=2, cache=64 << 20, tile=(512, 512, 64), reads=64,
                    zlib_reads=8, writes=200,
                    wbox=(96, 96, 12), batch=40, small=(64, 64, 16), clients=16, load_s=10.0,
                    live_box=(256, 256, 32), readers=8, objects=40, obj=(8, 40))
CLUSTER_TINY = dict(volume=(256, 256, 32), r=2, n_blobs=12, slab=128, nodes=4, replication=2,
                    cache=1 << 20, tile=(64, 64, 16), reads=4, zlib_reads=2, writes=6,
                    wbox=(24, 24, 6),
                    batch=4, small=(16, 16, 8), clients=4, load_s=1.0, live_box=(32, 32, 8),
                    readers=2, objects=6, obj=(4, 12))

# phase 25: a uint8 image on 4 faulty in-memory nodes (cuboids 128 x 128 x
# 16), phase 24's cluster settings; ``readers`` cold readers and a writer
# while node 1 is crashed ``kill_after_s`` into stage (b); the supervisor
# ticks every ``interval`` s and fails a node over after ``dead_ticks``
# dead samples; stage (c) holds node 0 down until the supervisor's first
# sample that sees it dead (at most ``blip_max_s``)
FAULT_FULL = dict(volume=(4096, 4096, 64), r=2, n_blobs=3072, slab=256, nodes=4, replication=2,
                  cache=64 << 20, tile=(512, 512, 64), reads=32, writes=100,
                  wbox=(96, 96, 12), readers=8, kill_after_s=2.0, heal_limit_s=30.0,
                  interval=0.25, dead_ticks=2, blip_max_s=2.0)
FAULT_TINY = FAULT_FULL | dict(volume=(256, 256, 32), cuboid=(32, 32, 8), n_blobs=12, slab=128,
                               cache=1 << 20, tile=(64, 64, 32), reads=4, writes=6,
                               wbox=(24, 24, 6), readers=2, kill_after_s=0.5)
# phases 26-27: recurrentgemma-2b (a cache of 2,176, so the window is
# 2,048; the first A unit's kernels checked at ``check_B`` x ``check_S``
# with the window binding) and seamless-m4t-medium (``frames`` per
# sequence, a self cache of 2,176) at full width, bf16
HYBRID_FULL = dict(arch="recurrentgemma-2b", key="hybrid_serving", smoke=False, batch=32,
                   prompt=2048, cache=2176, steps=64, check_B=2, check_S=4096)
HYBRID_TINY = HYBRID_FULL | dict(smoke=True, batch=2, prompt=40, cache=48, steps=4, check_B=1,
                                 check_S=64)
ENCDEC_FULL = dict(arch="seamless-m4t-medium", key="encdec_serving", smoke=False, batch=32,
                   frames=2048, cache=2176, steps=64)
ENCDEC_TINY = ENCDEC_FULL | dict(smoke=True, batch=2, frames=24, cache=16, steps=4)

# the serving paths: smollm-135m and mamba2-370m at full width (bf16), and
# tiny rehearsals; ``key`` names the path's entry in the report
SERVE_FULL = dict(arch="smollm-135m", key="serving", smoke=False, batch=32,
                  prompt=2048, steps=128, slots=16, requests=24, plen=(64, 512),
                  max_new=64)
SERVE_TINY = dict(arch="smollm-135m", key="serving", smoke=True, batch=2,
                  prompt=16, steps=4, slots=2, requests=5, plen=(4, 12),
                  max_new=4)
SSM_FULL = dict(arch="mamba2-370m", key="ssm_serving", smoke=False, batch=32,
                prompt=2048, steps=128, slots=16, requests=32, plen=(64, 256),
                max_new=32)
SSM_TINY = SERVE_TINY | dict(arch="mamba2-370m", key="ssm_serving", prompt=40)
MOE_FULL = dict(arch="granite-moe-1b-a400m", key="moe_serving", smoke=False, batch=32,
                prompt=2048, steps=128, slots=16, requests=24, plen=(64, 256),
                max_new=32)
MOE_TINY = SERVE_TINY | dict(arch="granite-moe-1b-a400m", key="moe_serving")
# the rest of the dense family at full width (bf16): prefill and greedy
# decode, no batcher
DENSE_FULL = [dict(arch=a, key=k, smoke=False, batch=32, prompt=2048, steps=32)
              for a, k in (("gemma-2b", "gemma_serving"), ("minitron-8b", "minitron_serving"))]
DENSE_TINY = [d | dict(smoke=True, batch=2, prompt=16, steps=4) for d in DENSE_FULL]
# dense training at smollm-135m's full width (bf16): sequences of 2,048, a
# global batch of 16 in 2 microbatches, the JAX driver's learning rate
# (3e-3, warm-up 5, cosine to 0 at the last step) on its synthetic corpus;
# the gradient check takes the first batch's first ``check_seqs`` sequences
# (the plain route keeps every layer's fp32 scores for its backward).  Every
# training phase runs under the configs' ``remat`` of ``block``; smollm's
# also times 2 steps under ``none`` and ``dots`` (``remat_variants``).  12
# steps, so that the smoke with phases 28-29 stays inside its time limit
TRAIN_FULL = dict(arch="smollm-135m", key="training", smoke=False, seq_len=2048, batch=16,
                  microbatches=2, steps=12, warm=2, lr=3e-3, check_seqs=2, compressed=True,
                  remat_variants=("none", "dots"), profiled=2)
# the MoE and ssm families' training, the same batch and schedule over 6
# steps, so that the smoke stays inside its time limit (the ssm at its
# published chunk of 256
# and with `build_state`'s init); the MoE's gradient check takes one
# sequence: its plain route keeps 24 layers' (16, 2,048, 2,048) fp32
# attention scores, and two sequences ran out of memory on the H100
MOE_TRAIN_FULL = TRAIN_FULL | dict(arch="granite-moe-1b-a400m", key="moe_training",
                                   steps=6, compressed=False, check_seqs=1, remat_variants=())
SSM_TRAIN_FULL = TRAIN_FULL | dict(arch="mamba2-370m", key="ssm_training", steps=6,
                                   compressed=False, remat_variants=())
# phases 28-29: the hybrid and encoder-decoder families' training at full
# width, the same corpus, schedule and global batch of 16 x 2,048.  The
# microbatches are what the card holds (bf16 weights, fp32 masters and
# moments, bf16 gradients, an fp32 accumulator):
# - recurrentgemma-2b, 2.895e9 parameters: 5.8 GB of weights, 34.7 GB of
#   master and moments, 5.8 GB of gradients, 11.6 GB of accumulator (58
#   GB); the loss over one sequence holds (2,048, 256,000) logits, ~2 GB a
#   copy in fp32 and ~4 copies; under ``block`` a layer keeps its input
#   (10 MB a sequence) and one repeat (R, R, A) is recomputed at a time: 16
#   microbatches of one sequence;
# - seamless-m4t-medium, 7.15e8 parameters: ~14 GB of state; the logits of
#   4 sequences over 256,206 words are 2.1e9 elements (8.4 GB a copy in
#   fp32, ~4 copies): 4 microbatches of 4 sequences.
# One sequence for the gradient check (its plain route and the fp32 copy).
# The hybrid's profile takes one step: its steps launch ~2.2e5 device ops
# each, and the profiler's events of two took minutes of host time to
# read.
# recurrentgemma-2b at a peak lr of 3e-4: at the driver's 3e-3 its loss
# rose in the first run on the H100 ([12.96, 13.07, 13.03, 16.72, 14.68,
# 20.66]).  Adam's first steps move every weight by about the lr, which at
# width 2,560 moves a layer's output by about lr x 2,560 against the
# initial 0.02 x sqrt(2,560): 1.5 x its size already at the first step's
# 6e-4.
HYBRID_TRAIN_FULL = TRAIN_FULL | dict(arch="recurrentgemma-2b", key="hybrid_training",
                                      microbatches=16, steps=6, compressed=False,
                                      check_seqs=1, remat_variants=(), lr=3e-4, profiled=1)
ENCDEC_TRAIN_FULL = TRAIN_FULL | dict(arch="seamless-m4t-medium", key="encdec_training",
                                      microbatches=4, steps=6, compressed=False,
                                      check_seqs=1, remat_variants=())
TRAINS_FULL = (TRAIN_FULL, MOE_TRAIN_FULL, SSM_TRAIN_FULL, HYBRID_TRAIN_FULL,
               ENCDEC_TRAIN_FULL)
TRAINS_TINY = tuple(tc | dict(smoke=True, seq_len=32, batch=4, microbatches=2, steps=8, warm=1)
                    for tc in TRAINS_FULL)
# the tile-order study's products (M, N, K), and a tiny rehearsal of them
MM_FULL = mm_bench.SHAPES
MM_TINY = [(96, 80, 64), (60, 100, 40)]


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# which body of a kernel a dtype runs: flash_attention, morton_matmul,
# moe_gemm and ssd_scan have a tensor-core body for bf16 and an FMA body
# for fp32;
# flash_decode has one body for both, a shared-memory pipeline whose
# splits merge inside the launch
TC_BODIES = {"flash_attention": "tensor-core bf16 (mma.sync m16n8k16)",
             "morton_matmul": "tensor-core bf16 (wgmma m64nNk16 + TMA)",
             "moe_gemm": "tensor-core bf16 (wgmma m64nNk16 + 3-D TMA)",
             "ssd_scan": "tensor-core bf16 (mma.sync m16n8k16, split hi + lo operands)",
             "flash_decode": "FMA {dtype} from a 3-stage cp.async ring, splits merged "
                             "in one cluster"}


def body(kernel: str, dtype: torch.dtype) -> str:
    name = str(dtype)[6:]
    if kernel == "flash_decode":
        return TC_BODIES[kernel].format(dtype=name)
    if dtype == torch.bfloat16 and kernel in TC_BODIES:
        return TC_BODIES[kernel]
    return f"FMA {name} (CUDA cores)"


# --------------------------------------------------------------- volume ----

def make_blobs(cfg, gen, dev):
    """Synapse-sized blob centres, spread like examples/synapse_pipeline.py
    at the detection level: ~4.6e-5 blobs per level-r voxel."""
    X, Y, Z = cfg["volume"]
    f = 1 << cfg["r"]
    margin = 8 * f
    u = torch.rand((cfg["n_blobs"], 3), generator=gen, device=dev)
    lo = torch.tensor([margin, margin, 8], device=dev)
    hi = torch.tensor([X - margin, Y - margin, Z - 8], device=dev)
    return (lo + u * (hi - lo)).long()


def make_slab(cfg, x0, centres, gen, dev):
    """Level-0 EM slab [x0, x0 + slab): noise + blobs + a vessel, uint8.

    The level-r picture reads like the example volume: noise sd 4, blobs of
    amplitude 90 with exp(-d2 / 9) profiles (Z twice as steep), a bright
    vessel of +60.  Level 0 is 2^r finer in X and Y, so blobs are 2^r wider
    there and the noise is 2^r stronger (averaging 4^r voxels divides it).
    """
    X, Y, Z = cfg["volume"]
    f = 1 << cfg["r"]
    n = cfg["slab"]
    vol = torch.randn((n, Y, Z), generator=gen, device=dev).mul_(4.0 * f).add_(100.0)
    w_xy, w_z = 7 * f, 4
    near = centres[(centres[:, 0] >= x0 - w_xy) & (centres[:, 0] < x0 + n + w_xy)]
    if near.shape[0]:
        ax = torch.arange(-w_xy, w_xy, device=dev)
        az = torch.arange(-w_z, w_z, device=dev)
        dx, dy, dz = torch.meshgrid(ax, ax, az, indexing="ij")
        prof = 90.0 * torch.exp(-(((dx / f) ** 2 + (dy / f) ** 2
                                   + (2.0 * dz) ** 2) / 9.0))
        xs = near[:, 0, None] + dx.reshape(1, -1)
        keep = (xs >= x0) & (xs < x0 + n)
        ys = near[:, 1, None] + dy.reshape(1, -1)
        zs = near[:, 2, None] + dz.reshape(1, -1)
        flat = ((xs - x0) * Y + ys) * Z + zs
        vals = prof.reshape(1, -1).expand_as(flat)
        vol.view(-1).index_add_(0, flat[keep], vals[keep])
    vx0, vx1 = X * 40 // 128, X * 90 // 128
    a, b = max(vx0, x0), min(vx1, x0 + n)
    if a < b:
        vol[a - x0:b - x0, Y * 40 // 128:Y * 50 // 128, :] += 60.0
    return vol.clamp_(0, 255).to(torch.uint8)


def timed(dev, fn):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


# ------------------------------------------------------------ main path ----

def main_path(cfg, dev, report):
    spec = DatasetSpec("bock11-share", cfg["volume"],
                       n_resolutions=cfg["n_resolutions"], dtype="uint8")
    gen = torch.Generator(device=dev).manual_seed(11)
    store = DeviceCuboidStore(spec, device=dev)
    centres = make_blobs(cfg, gen, dev)

    def ingest_all():
        for x0 in range(0, cfg["volume"][0], cfg["slab"]):
            cut.ingest(store, 0, make_slab(cfg, x0, centres, gen, dev),
                       offset=(x0, 0, 0))

    _, t_ingest = timed(dev, ingest_all)
    _, t_hier = timed(dev, lambda: cut.build_hierarchy(store))
    proj = AnnotationProject("synapses", spec, device=dev)
    n_written, t_detect = timed(dev, lambda: sd.run_parallel_detection(
        store, proj, r=cfg["r"], tile=cfg["tile"], n_workers=cfg["workers"],
        threshold=2.0, min_voxels=4, batch_size=40,
        lowres_level=cfg["lowres"]))
    det_voxels = int(np.prod(spec.grid(cfg["r"]).volume_shape))
    report["phases"] = dict(ingest_s=t_ingest, hierarchy_s=t_hier,
                            detect_s=t_detect)
    report["detections"] = n_written
    report["detect_voxels_per_s"] = det_voxels / t_detect
    report["packed_bytes"] = store.nbytes
    log(f"main path: ingest {t_ingest:.3f} s, hierarchy {t_hier:.3f} s, "
        f"detection {t_detect:.3f} s -> {n_written} synapses, "
        f"{det_voxels / t_detect:.4g} voxels/s through cutout->detect->annotate")
    return spec, store, proj


def recheck_boxes(cfg, spec):
    """The 4 tiles that phase 3 re-runs and phase 21 queries."""
    tiles = sd.tiling(spec.grid(cfg["r"]).volume_shape, cfg["tile"])
    return [tiles[i] for i in sorted({0, len(tiles) // 3, 2 * len(tiles) // 3,
                                      len(tiles) - 1})]


def check_results(cfg, dev, spec, store, proj, report):
    r = cfg["r"]
    if report["detections"] <= 0:
        raise RuntimeError("the main path wrote no detections")
    for lev in range(spec.n_resolutions):
        packed = store.peek(lev)
        if packed is None or not bool(packed.any()):
            raise RuntimeError(f"level {lev} is empty after build_hierarchy")
    # level 1 holds the downsampled level 0 (a box away from the edges)
    v1 = spec.grid(1).volume_shape
    lo1 = (v1[0] // 4, v1[1] // 3, 1)
    hi1 = (v1[0] // 2 + 3, v1[1] // 2 + 5, v1[2] - 1)
    want = downsample_block(cut.cutout(store, 0, (2 * lo1[0], 2 * lo1[1], lo1[2]),
                                       (2 * hi1[0], 2 * hi1[1], hi1[2])), (0, 1))
    if not torch.equal(cut.cutout(store, 1, lo1, hi1), want):
        raise RuntimeError("level 1 is not the downsampled level 0")

    # 4 tiles again, with cutouts through the plain gather: the detections
    # must be the stored ones, label for label
    grid = spec.grid(r)
    low = cut.cutout(store, cfg["lowres"], (0, 0, 0),
                     spec.grid(cfg["lowres"]).volume_shape)
    excl_full = sd.large_structure_mask(low.to(torch.float32))
    boxes = recheck_boxes(cfg, spec)
    packed = store.peek(r)
    n_dets = 0
    for lo, hi in boxes:
        gshape, cells, alo = gather_ops.build_plan(grid, lo, hi)
        plan = torch.from_numpy(cells).to(dev)
        via_ref = cutout_gather_ref(packed, plan, gshape,
                                    [l - a for l, a in zip(lo, alo)],
                                    [h - l for l, h in zip(lo, hi)])
        via_kernel = cut.cutout(store, r, lo, hi)
        if not torch.equal(via_kernel, via_ref):
            raise RuntimeError(f"tile {lo}: kernel cutout != plain cutout")
        excl = sd.scale_mask(excl_full, cfg["lowres"] - r, lo, hi)
        dets, lab = sd.detect_synapses(via_ref, threshold=2.0, min_voxels=4,
                                       exclusion_mask=excl)
        stored = proj.read(r, lo, hi)
        fg = lab != 0
        if not torch.equal(stored != 0, fg):
            raise RuntimeError(f"tile {lo}: stored annotations != detections")
        # one stored id per detection label and one label per stored id
        pairs = torch.unique(torch.stack([stored[fg], lab[fg]]), dim=1)
        if not (pairs.shape[1] == len(dets)
                == int(torch.unique(pairs[0]).numel())
                == int(torch.unique(pairs[1]).numel())):
            raise RuntimeError(f"tile {lo}: stored ids != detections")
        n_dets += len(dets)
    report["recheck_tiles"] = dict(tiles=len(boxes), detections=n_dets)
    log(f"re-checked {len(boxes)} tiles through the plain gather: "
        f"{n_dets} detections, identical to the stored labels")


def profile_window(dev, fn, ranges=(), raw=False):
    """torch.profiler over one call of ``fn`` (after a warm-up call): the
    ops that take the host's and the device's time, the device's busy
    time over the window's wall time, and the device time launched inside
    each profiler range named in ``ranges`` (`range_device_ms`).  With
    ``raw`` the profiler's raw events are read instead (`raw_profile`: no
    host ops, the device's time and the ranges alike), for windows of
    ~1e6 events."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm the allocator and the kernels
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if raw:
        r = raw_profile(prof, ranges)
        return out, dict(wall_s=wall, device_busy_s=r["device_busy_s"],
                         device_idle_share=1 - r["device_busy_s"] / wall,
                         device_ops=r["device_ops"], top_device=[], top_host=[],
                         top_kernels=r["top_kernels"], ranges=r["ranges"])
    ops, kernels, busy = [], [], 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if str(e.device_type).endswith("CPU"):
            ops.append((e.key, e.count, e.self_cpu_time_total, dev_us))
        elif not getattr(e, "is_user_annotation", False):
            # kernels, copies and fills as the device ran them (not the
            # device-side spans of profiler ranges)
            busy += dev_us / 1e6
            kernels.append((e.key, e.count, 0, dev_us))
    top_dev = sorted(ops, key=lambda x: -x[3])[:8]
    top_cpu = sorted(ops, key=lambda x: -x[2])[:8]
    top_kernels = sorted(kernels, key=lambda x: -x[3])[:8]
    prof_report = dict(wall_s=wall, device_busy_s=busy,
                       device_idle_share=1 - busy / wall,
                       device_ops=sum(k[1] for k in kernels),
                       top_device=top_dev, top_host=top_cpu,
                       top_kernels=top_kernels)
    if ranges:
        prof_report["ranges"] = range_device_ms(prof, ranges)
    return out, prof_report


def raw_profile(prof, names):
    """The device's work in the profiler's raw events, read without the
    profiler's event tree (whose Python objects cost ~50 us an event to
    build: minutes for a train step of ~1e6 events): the time of every
    device op (kernels, copies and fills, not the device-side spans of
    profiler ranges), the top kernels by name, and for each range in
    ``names`` the device time of the ops launched inside it: an op goes to
    the range occurrence whose host interval holds the start of the host
    call that launched it (the two share a correlation id), so each op
    counts once in disjoint ranges."""
    spans = {n: [] for n in names}
    launched_at, device = {}, []
    for e in prof.profiler.kineto_results.events():
        on_device = not str(e.device_type()).endswith("CPU")
        if e.is_user_annotation():
            if not on_device and e.name() in spans:
                spans[e.name()].append((e.start_ns(), e.end_ns()))
        elif on_device:
            device.append((e.name(), e.duration_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):  # cudaLaunchKernel, cudaMemcpyAsync, ...
            launched_at[e.correlation_id()] = e.start_ns()
    by_name = {}
    for n, d, _ in device:
        c, t = by_name.get(n, (0, 0))
        by_name[n] = (c + 1, t + d)
    top = sorted(((n, c, 0, t / 1e3) for n, (c, t) in by_name.items()), key=lambda x: -x[3])
    ranges = {}
    for n, occ in spans.items():
        occ.sort()
        starts = [a for a, _ in occ]
        ns = 0
        for _, d, corr in device:
            t = launched_at.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= occ[i][1]:
                ns += d
        ranges[n] = dict(calls=len(occ), ms=ns / 1e6)
    return dict(device_busy_s=sum(d for _, d, _ in device) / 1e9, device_ops=len(device),
                top_kernels=top[:8], ranges=ranges)


def range_device_ms(prof, names):
    """The device time of the work launched inside each named profiler
    range, summed over the range's occurrences: each op's own kernels go
    to the ranges whose host interval holds the op's start, so the work
    that autograd's thread launches while the caller waits in a range
    counts in it."""
    cpu = [e for e in prof.events() if str(e.device_type).endswith("CPU")]
    launched = [(e.time_range.start, sum(k.duration for k in e.kernels)) for e in cpu
                if e.kernels]
    out = {}
    for n in names:
        # a range's occurrences do not overlap: each start finds the one
        # span that may hold it by bisection (a train step launches ~2e5 ops)
        spans = sorted((e.time_range.start, e.time_range.end) for e in cpu if e.name == n)
        starts = [a for a, _ in spans]
        us = 0.0
        for t, d in launched:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                us += d
        out[n] = dict(calls=len(spans), ms=us / 1e3)
    return out


def log_profile(label, p):
    log(f"profile of {label}: wall {p['wall_s']:.4f} s, device busy "
        f"{p['device_busy_s']:.4f} s (idle share {p['device_idle_share']:.3f}), "
        f"{p['device_ops']} kernels, copies and fills on the device")
    for kind, top, col in (("device", p["top_device"], 3), ("host", p["top_host"], 2),
                           ("kernels'", p["top_kernels"], 3)):
        if not top:
            continue
        log(f"  top {kind} ops: " + "; ".join(
            f"{t[0][:48]} x{t[1]} {t[col] / 1e3:.1f} ms" for t in top))


def where_time_goes(cfg, dev, spec, store, report, n_tiles=2):
    """`detect_tile` on a few tiles, one worker, under the profiler."""
    r = cfg["r"]
    low = cut.cutout(store, cfg["lowres"], (0, 0, 0),
                     spec.grid(cfg["lowres"]).volume_shape)
    excl_full = sd.large_structure_mask(low.to(torch.float32))
    proj = AnnotationProject("profile", spec, device=dev)
    tiles = sd.tiling(spec.grid(r).volume_shape, cfg["tile"])[-n_tiles:]

    def run():
        return sum(sd.detect_tile(store, proj, r, lo, hi,
                                  sd.scale_mask(excl_full, cfg["lowres"] - r,
                                                lo, hi), min_voxels=4)
                   for lo, hi in tiles)

    n, prof = profile_window(dev, run)
    report["profile"] = dict(tiles=len(tiles), detections=n, **prof)
    log_profile(f"{len(tiles)} tiles ({n} detections), one worker", prof)


def small_pipeline_vs_cpu(dev, report):
    """The example's 128 x 128 x 32 pipeline on the card and on the CPU."""
    rng = np.random.default_rng(7)
    shape = (128, 128, 32)
    vol = rng.normal(100, 4, size=shape).astype(np.float32)
    xx, yy, zz = np.ogrid[:shape[0], :shape[1], :shape[2]]
    for _ in range(24):
        c = [int(rng.integers(8, s - 8)) for s in shape]
        d2 = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 + ((zz - c[2]) * 2) ** 2
        vol += 90.0 * np.exp(-d2 / 9.0)
    vol[40:90, 40:50, :] += 60.0
    spec = DatasetSpec("cortex", shape, dtype="float32", n_resolutions=2,
                       base_cuboid=(32, 32, 16))
    out = {}
    for d in (dev, torch.device("cpu")):
        store = DeviceCuboidStore(spec, device=d)
        cut.ingest(store, 0, vol)
        cut.build_hierarchy(store)
        proj = AnnotationProject("det", spec, device=d)
        n = sd.run_parallel_detection(store, proj, r=0, tile=(64, 64, 32),
                                      n_workers=1, threshold=2.0,
                                      min_voxels=4, lowres_level=1)
        out[d.type] = (n, proj.read(0, (0, 0, 0), shape).cpu())
    if out[dev.type][0] != out["cpu"][0] or not torch.equal(
            out[dev.type][1], out["cpu"][1]):
        raise RuntimeError("small pipeline: card and CPU results differ")
    report["small_pipeline_detections"] = out["cpu"][0]
    log(f"small pipeline: {out['cpu'][0]} detections, card == CPU")


# -------------------------------------------------------------- kernels ----

def event_times(dev, fn, reps=25):
    """Per-call device time (ms) by CUDA events, median of ``reps``.  The
    calls queue behind a device-side sleep so host launch gaps do not
    count."""
    fn()
    torch.cuda.synchronize(dev)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for i in range(reps):
        starts[i].record()
        fn(i)
        ends[i].record()
    torch.cuda.synchronize(dev)
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def gather_case(packed, grid, lo, hi, dev):
    gshape, cells, alo = gather_ops.build_plan(grid, lo, hi)
    plan = torch.from_numpy(cells).to(dev)
    args = (packed, plan, gshape, [l - a for l, a in zip(lo, alo)],
            [h - l for l, h in zip(lo, hi)])
    return args


def compare_gather(packed, grid, lo, hi, dev, label, errs):
    """Kernel vs plain on one box: bit-exact, and the largest value error."""
    args = gather_case(packed, grid, lo, hi, dev)
    got = gather_ops.cutout_gather_cuda(*args)
    want = cutout_gather_ref(*args)
    torch.cuda.synchronize(dev)
    same = (got.shape == want.shape
            and torch.equal(got.view(torch.uint8), want.view(torch.uint8)))
    if not same:
        raise RuntimeError(f"cutout_gather {label}: kernel != plain")
    errs.append(float((got.double() - want.double()).abs().max()))
    return args


def kernel_checks(dev, store, spec, cfg, report, peak):
    errs = []
    # dtypes x box kinds on a small level-shaped array
    gen = torch.Generator(device=dev).manual_seed(5)
    for cs in [(128, 128, 16), (64, 64, 64)]:
        grid = CuboidGrid((3 * cs[0] - 37, 2 * cs[1] + 11, 5 * cs[2] - 3), cs)
        for dt in (torch.uint8, torch.uint16, torch.int32, torch.float32):
            shape = (grid.n_cells,) + cs
            packed = (torch.randn(shape, generator=gen, device=dev)
                      if dt.is_floating_point else
                      torch.randint(0, 256, shape[:-1] + (cs[2] * dt.itemsize,),
                                    generator=gen, device=dev,
                                    dtype=torch.uint8).view(dt))
            v = grid.volume_shape
            for label, lo, hi in [
                    ("aligned", (0, 0, 0), (cs[0], cs[1], 2 * cs[2])),
                    ("unaligned", (5, 3, 2), (v[0] - 9, v[1] - 4, v[2] - 7)),
                    ("edge", (v[0] - 40, v[1] - 33, v[2] - 5), v),
                    ("voxel", (v[0] - 1, 17, 3), (v[0], 18, 4))]:
                compare_gather(packed, grid, lo, hi, dev,
                               f"{dt} {cs} {label}", errs)
    log(f"cutout_gather: {len(errs)} small cases bit-exact vs plain")

    # at the main path's shapes
    cases = {}
    r = cfg["r"]
    g_r = spec.grid(r)
    tiles = sd.tiling(g_r.volume_shape, cfg["tile"])[:16]
    cases["tile"] = [compare_gather(store.peek(r), g_r, lo, hi, dev,
                                    f"tile {lo}", errs) for lo, hi in tiles]
    g0 = spec.grid(0)
    big = [((1024 * i, 1024 * j, 64 * k), (1024 * (i + 1), 1024 * (j + 1), 64 * (k + 1)))
           for i, j, k in [(0, 0, 0), (7, 7, 3), (3, 5, 1), (6, 2, 2)]]
    cases["l0_1024x1024x64"] = [compare_gather(store.peek(0), g0, lo, hi, dev,
                                               f"level0 {lo}", errs)
                                for lo, hi in big]
    # cells past byte offset 2^31 (Morton cells >= 8192 at level 0)
    lo, hi = (8192 - 300, 8192 - 277, 200), (8192 - 3, 8192 - 1, 255)
    args = compare_gather(store.peek(0), g0, lo, hi, dev, "past 2^31", errs)
    first = int(args[1].min()) * g0.cuboid_voxels
    if first < 2 ** 31:
        raise RuntimeError("the far box does not reach past byte 2^31")
    cases["past_2^31"] = [args]
    log(f"cutout_gather: {len(errs)} cases bit-exact incl. cells from byte "
        f"{first} on")

    timings = {}
    for name, arglist in cases.items():
        out_bytes = sum(int(np.prod(a[4])) * a[0].element_size() for a in arglist)
        plan_bytes = sum(a[1].numel() * 4 for a in arglist)
        k = len(arglist)
        ms = event_times(dev, lambda i=0: gather_ops.cutout_gather_cuda(*arglist[i % k]))
        plain = event_times(dev, lambda i=0: cutout_gather_ref(*arglist[i % k]))
        per_bytes = (2 * out_bytes + plan_bytes) / k
        bound = per_bytes / peak * 1e3
        timings[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                             bytes=per_bytes, gbps=per_bytes / ms / 1e6,
                             hbm_share=bound / ms, boxes=k)
        log(f"cutout_gather {name}: {ms:.4f} ms/box (plain {plain:.4f} ms), "
            f"{per_bytes / ms / 1e6:.1f} GB/s = {100 * bound / ms:.1f}% of the "
            f"{peak / 1e12:.2f} TB/s HBM peak (bound {bound:.4f} ms)")
    report["cutout_gather"] = timings
    return max(errs), timings["tile"]


# ------------------------------------------- annotation service, phase 21 ----

def drive(counts, dev, fn):
    """One driven call, timed, with the launch counts set to 0 just before
    it; what it launched is added to ``counts`` (checks launch outside)."""
    reset_launches()
    out, t = timed(dev, fn)
    for n, k in KERNELS.items():
        counts[n] = counts.get(n, 0) + k["ops"].launches
    return out, t


def plain_cutout(packed, grid, lo, hi, dev):
    """The box through the plain gather (`cutout_gather_ref`)."""
    return cutout_gather_ref(*gather_case(packed, grid, lo, hi, dev))


def uint_ids(t):
    return t.to(torch.int64) & 0xFFFFFFFF


def annotation_service(cfg, dev, spec, store, proj, report, counts):
    """Phase 21: the annotation API on the detection path's state, each
    call driven once and checked against the plain gather or numpy."""
    r = cfg["r"]
    grid = spec.grid(r)
    labels = proj.store.peek(r)
    times, out = {}, {}

    # index-only bounding boxes: each holds every stored voxel of its id
    ids = proj.index.ids()
    boxes, times["bounding_box"] = drive(counts, dev, lambda: [
        proj.bounding_box(i, r) for i in ids])
    nz = (labels != 0).nonzero()
    cs = np.asarray(grid.cuboid_shape)
    origins = torch.from_numpy(morton.morton_decode(np.arange(grid.n_cells), grid.bits)
                               * cs).to(dev)
    coords = origins[nz[:, 0]] + nz[:, 1:]
    vals = uint_ids(labels[tuple(nz.T)])
    id_t = torch.tensor(ids, device=dev)
    pos = torch.searchsorted(id_t, vals).clamp_(max=len(ids) - 1)
    lo_t = torch.tensor([b[0] for b in boxes], device=dev)[pos]
    hi_t = torch.tensor([b[1] for b in boxes], device=dev)[pos]
    if not (bool((id_t[pos] == vals).all()) and bool((coords >= lo_t).all())
            and bool((coords < hi_t).all())):
        raise RuntimeError("bounding_box: a stored voxel lies outside its id's box")
    out["bounding_boxes"] = len(ids)
    out["stored_voxels"] = int(nz.shape[0])
    box_of = dict(zip(ids, boxes))

    # the paper's batch of 40 object reads
    pick = ids[::max(1, len(ids) // cfg["batch"])][:cfg["batch"]]
    got, times["batch_read_objects"] = drive(counts, dev, lambda: proj.batch_read_objects(pick, r))
    for i in pick:
        lo, dense = got[i]
        ref = plain_cutout(labels, grid, *box_of[i], dev)
        if lo != box_of[i][0] or not torch.equal(dense, torch.where(ref == i, ref, 0)) \
                or not bool((dense != 0).any()):
            raise RuntimeError(f"batch_read_objects: object {i} != its masked box")
    out["batch_read_objects"] = len(pick)

    # the ids of the re-check tiles
    tiles = recheck_boxes(cfg, spec)
    regions, times["objects_in_region"] = drive(counts, dev, lambda: [
        proj.objects_in_region(r, lo, hi) for lo, hi in tiles])
    for (lo, hi), found in zip(tiles, regions):
        want = [i for i in torch.unique(uint_ids(plain_cutout(labels, grid, lo, hi, dev)))
                .tolist() if i]
        if found != want or not found:
            raise RuntimeError(f"objects_in_region {lo}: {len(found)} ids, want {len(want)}")
    out["objects_in_region"] = [len(f) for f in regions]

    # two neighbouring synapses: numpy's chunked norm, exactly
    near = next(f for f in regions if len(f) >= 2)
    a = near[0]
    centre = {i: np.add(*box_of[i]) / 2 for i in near}
    b = min(near[1:], key=lambda i: float(np.abs(centre[i] - centre[a]).sum()))
    d, times["distance"] = drive(counts, dev, lambda: proj.distance(a, b, r))
    va, vb = proj.voxel_list(a, r), proj.voxel_list(b, r)
    want = min(float(np.linalg.norm(va[i:i + 4096, None, :] - vb[None], axis=-1).min())
               for i in range(0, len(va), 4096))
    if d != want:
        raise RuntimeError(f"distance({a}, {b}) = {d!r}, numpy {want!r}")
    out["distance"] = dict(a=a, b=b, voxels=(len(va), len(vb)), value=d)

    # the label hierarchy: pending, propagated, stride-sampled
    pending = proj.pending_propagation
    _, times["propagate"] = drive(counts, dev, proj.propagate)
    if not pending or proj.pending_propagation:
        raise RuntimeError("pending_propagation did not go from true to false")
    v3 = spec.grid(r + 1).volume_shape
    lo3, hi3 = (v3[0] // 4, v3[1] // 4, 0), (3 * v3[0] // 4, 3 * v3[1] // 4, v3[2])
    up = proj.read(r, (2 * lo3[0], 2 * lo3[1], 0), (2 * hi3[0], 2 * hi3[1], v3[2]))
    if not torch.equal(proj.read(r + 1, lo3, hi3), up[::2, ::2]) or not bool(up.any()):
        raise RuntimeError("level r+1 is not the stride-sampled level r")
    out["propagated_levels"] = list(range(r + 1, spec.n_resolutions))

    # projections at level 0 (a tile, then MIP and mean renderings)
    g0 = spec.grid(0)
    v0 = g0.volume_shape
    z = v0[2] // 2 + 3
    tile, times["project_slice"] = drive(counts, dev, lambda: cut.project(
        store, 0, (0, 0, z), v0, 2, "slice"))
    if not torch.equal(tile, plain_cutout(store.peek(0), g0, (0, 0, z),
                                          (v0[0], v0[1], z + 1), dev)[..., 0]):
        raise RuntimeError("project slice != the plain-gather plane")
    lo, hi = cfg["reduce_box"]
    host = plain_cutout(store.peek(0), g0, lo, hi, dev).cpu().numpy()
    for red, want in (("max", host.max(axis=2)), ("mean", host.mean(axis=2).astype(np.uint8))):
        got, times[f"project_{red}"] = drive(counts, dev, lambda red=red: cut.project(
            store, 0, lo, hi, 2, red))
        if not np.array_equal(got.cpu().numpy(), want):
            raise RuntimeError(f"project {red} != numpy's")
    out["project"] = dict(slice=list(tile.shape), reduce_box=[list(lo), list(hi)])

    # a batch of 40 boxes, unaligned and at the volume edge
    rng = np.random.default_rng(21)
    bxs = []
    for k in range(cfg["batch"]):
        size = [int(rng.integers(1, t + 1)) for t in cfg["tile"]]
        lo = ([v - s for v, s in zip(v0, size)] if k % 4 == 3 else
              [int(rng.integers(0, v - s + 1)) for v, s in zip(v0, size)])
        bxs.append((lo, [l + s for l, s in zip(lo, size)]))
    got, times["batch_cutout"] = drive(counts, dev, lambda: cut.batch_cutout(store, 0, bxs))
    for (lo, hi), g in zip(bxs, got):
        if not torch.equal(g, cut.cutout(store, 0, lo, hi)):
            raise RuntimeError(f"batch_cutout box {lo}: != its own cutout")
    out["batch_cutout"] = dict(boxes=len(bxs), bytes=sum(g.numel() for g in got))

    exception_discipline(cfg, dev, spec, proj, tiles, counts, times, out)
    multi_rank(cfg, dev, spec, store, counts, times, out)
    report["annotation"] = dict(times_s=times, **out)
    log(f"annotation service: {len(ids)} bounding boxes, {len(pick)} objects, "
        f"{sum(out['objects_in_region'])} ids in {len(tiles)} regions, distance "
        f"{out['distance']['value']:.6g}, hierarchy to level {spec.n_resolutions - 1}, "
        f"projections, {len(bxs)} batch boxes, {out['exceptions']['entries']} exception "
        f"entries in {out['exceptions']['cuboids']} cuboids, one-rank "
        f"{out['multi_rank']['backend']} cutout and write: all as checked; times (s) "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))


EXC_SHIFT = 1_000_000  # the second labelling's ids: the stored ones + this


def exception_discipline(cfg, dev, spec, proj, tiles, counts, times, out):
    """The re-check tiles' stored ids, even ones written first, then all of
    them shifted under ``exception``: primary labels and every touched
    cuboid's list against numpy."""
    r = cfg["r"]
    grid = spec.grid(r)
    cs = grid.cuboid_shape
    exc = AnnotationProject("exceptions", spec, enable_exceptions=True, device=dev)
    pairs = []
    for lo, hi in tiles:
        stored = proj.read(r, lo, hi)
        old = torch.where(stored % 2 == 0, stored, 0)
        new = torch.where(stored != 0, stored + EXC_SHIFT, 0)
        exc.write(r, lo, old)
        pairs.append((lo, hi, old, new))
    _, times["exception_write"] = drive(counts, dev, lambda: [
        exc.write(r, lo, new, discipline="exception") for lo, hi, old, new in pairs])
    want_lists = {}
    for lo, hi, old, new in pairs:
        if not torch.equal(exc.read(r, lo, hi), torch.where(old != 0, old, new)):
            raise RuntimeError(f"exception tile {lo}: primary labels != where(old, old, new)")
        o, n = old.cpu().numpy(), new.cpu().numpy()
        conflict = (o != 0) & (n != 0) & (o != n)
        glo = [l // c for l, c in zip(lo, cs)]
        ghi = [-(-h // c) for h, c in zip(hi, cs)]
        for g in np.ndindex(*[b - a for a, b in zip(glo, ghi)]):
            origin = [(a + i) * c for a, i, c in zip(glo, g, cs)]
            a_ = [max(l, o_) for l, o_ in zip(lo, origin)]
            b_ = [min(h, o_ + c) for h, o_, c in zip(hi, origin, cs)]
            tsl = tuple(slice(x - l, y - l) for x, y, l in zip(a_, b_, lo))
            csl = tuple(slice(x - o_, y - o_) for x, y, o_ in zip(a_, b_, origin))
            cf, nf = np.zeros(cs, bool), np.zeros(cs, np.int64)
            cf[csl], nf[csl] = conflict[tsl], n[tsl]
            offs = np.flatnonzero(cf)
            if offs.size:
                m = grid.cuboid_of_voxel(origin)
                want_lists.setdefault(m, []).extend(zip(offs.tolist(),
                                                        nf.reshape(-1)[offs].tolist()))
    for m, want in want_lists.items():
        if exc.exceptions_at(r, m) != want:
            raise RuntimeError(f"exceptions_at({r}, {m}) != numpy's list")
    if not want_lists or set(m for _, m in exc._exceptions) != set(want_lists):
        raise RuntimeError("exception lists: touched cuboids differ from numpy's")
    out["exceptions"] = dict(cuboids=len(want_lists),
                             entries=sum(len(v) for v in want_lists.values()))


def multi_rank(cfg, dev, spec, store, counts, times, out):
    """A one-rank world (NCCL on the card, gloo on the CPU): the multi-rank
    cutout equals `cutout`, the multi-rank write (zeros included) equals
    its numpy oracle.  The write changes level 0, so this runs last."""
    import torch.distributed as tdist

    backend = "nccl" if dev.type == "cuda" else "gloo"
    rdv = HERE / "build" / "smoke_rendezvous"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    tdist.init_process_group(backend, init_method=f"file://{rdv}", rank=0, world_size=1)
    try:
        g0 = spec.grid(0)
        shard = dist_mod.shard_cuboids(store.peek(0), 0, 1)
        lo, hi = cfg["dist_box"]
        # the first collective sets up the communicator: timed apart
        _, times["distributed_cutout_first"] = drive(
            counts, dev, lambda: dist_mod.distributed_cutout(shard, g0, lo, [l + 1 for l in lo]))
        got, times["distributed_cutout"] = drive(counts, dev, lambda: dist_mod.distributed_cutout(
            shard, g0, lo, hi))
        if not torch.equal(got, cut.cutout(store, 0, lo, hi)):
            raise RuntimeError("distributed_cutout != cutout")
        wlo = [l + (h - l) // 8 + 3 for l, h in zip(lo, hi)]
        shape = [(h - l) // 4 for l, h in zip(lo, hi)]
        data = np.random.default_rng(22).integers(0, 3, size=shape).astype(np.uint8) * 100
        mlo, mhi = [l - 5 for l in wlo], [l + s + 5 for l, s in zip(wlo, shape)]
        expect = cut.cutout(store, 0, mlo, mhi).cpu().numpy()
        expect[tuple(slice(5, 5 + s) for s in shape)] = data
        _, times["distributed_write_cutout"] = drive(
            counts, dev, lambda: dist_mod.distributed_write_cutout(shard, g0, wlo, data))
        if not np.array_equal(cut.cutout(store, 0, mlo, mhi).cpu().numpy(), expect):
            raise RuntimeError("distributed_write_cutout != its numpy oracle")
    finally:
        tdist.destroy_process_group()
        rdv.unlink(missing_ok=True)
    out["multi_rank"] = dict(backend=backend, box=[list(lo), list(hi)],
                             write_shape=shape, zeros_written=int((data == 0).sum()))


# --------------------------------------- time series and channels, phase 22 ----

def timeseries_and_channels(tc, dev, report, peak, counts):
    """Phase 22: a rank-4 dataset's cutouts against the plain version and
    the host slice (the big box timed), then a 3-channel dataset written and
    read per channel."""
    t_phase = time.perf_counter()
    spec = DatasetSpec("timeseries", tc["volume"], dtype="uint8")
    grid = spec.grid(0)
    store = DeviceCuboidStore(spec, device=dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    host = np.empty(tc["volume"], np.uint8)
    v = tc["volume"]
    times = {"ingest": 0.0}
    for x0 in range(0, v[0], tc["slab"]):
        part = torch.randint(0, 256, (tc["slab"],) + tuple(v[1:]), generator=gen,
                             device=dev, dtype=torch.uint8)
        host[x0:x0 + tc["slab"]] = part.cpu().numpy()
        _, t = drive(counts, dev, lambda: cut.ingest(store, 0, part, offset=(x0, 0, 0, 0)))
        times["ingest"] += t
    del part
    boxes = {"box": tc["box"],
             "unaligned": ((v[0] // 8 + 5, v[1] // 16 + 3, 3, 1),
                           (v[0] * 3 // 4 + 3, v[1] * 5 // 8 + 1, v[2] - 5, v[3] - 2)),
             "edge": ((v[0] - v[0] // 16 - 3, v[1] - v[1] // 8, v[2] - 9, v[3] - 5), v),
             "voxel": ((v[0] - 1, 7, 2, 3), (v[0], 8, 3, 4))}
    packed = store.peek(0)
    for name, (lo, hi) in boxes.items():
        got, times[f"cutout_{name}"] = drive(counts, dev, lambda: cut.cutout(store, 0, lo, hi))
        want = plain_cutout(packed, grid, lo, hi, dev)
        if not torch.equal(got, want) or not np.array_equal(
                got.cpu().numpy(), host[tuple(slice(l, h) for l, h in zip(lo, hi))]):
            raise RuntimeError(f"rank-4 cutout {name}: kernel, plain and host slice differ")
    del host
    ts = dict(volume=list(v), cuboid=list(grid.cuboid_shape), packed_bytes=store.nbytes,
              boxes={k: [list(lo), list(hi)] for k, (lo, hi) in boxes.items()})
    if dev.type == "cuda":
        args = gather_case(packed, grid, *tc["box"], dev)
        ms = event_times(dev, lambda i=0: gather_ops.cutout_gather_cuda(*args))
        plain = event_times(dev, lambda i=0: cutout_gather_ref(*args))
        nbytes = 2 * int(np.prod(args[4])) + args[1].numel() * 4
        bound = nbytes / peak * 1e3
        ts["gather"] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bytes=nbytes,
                            gbps=nbytes / ms / 1e6, hbm_share=bound / ms)
        log(f"cutout_gather rank 4, {tuple(args[4])} uint8 box of {grid.cuboid_shape} "
            f"cuboids: {ms:.4f} ms (plain {plain:.4f} ms), {nbytes / ms / 1e6:.1f} GB/s = "
            f"{100 * bound / ms:.1f}% of the HBM peak (bound {bound:.4f} ms)")
    del store, packed
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    cv = tuple(tc["ch_volume"])
    cspec = DatasetSpec("channels", cv, n_channels=tc["channels"], dtype="uint16")
    cstore = DeviceCuboidStore(cspec, device=dev)
    box = ((5, 7, 3), (cv[0] // 8 + 5, cv[1] // 8 + 7, cv[2] // 2 + 3))
    samples = []
    for c in range(tc["channels"]):
        vol = torch.randint(0, 256, cv[:-1] + (2 * cv[-1],), generator=gen, device=dev,
                            dtype=torch.uint8).view(torch.uint16)
        _, times[f"write_channel{c}"] = drive(counts, dev, lambda: cut.ingest(
            cstore, 0, vol, channel=c))
        back, times[f"read_channel{c}"] = drive(counts, dev, lambda: cut.cutout(
            cstore, 0, (0, 0, 0), cv, channel=c))
        if not torch.equal(back.view(torch.int16), vol.view(torch.int16)):
            raise RuntimeError(f"channel {c}: read != written")
        samples.append(vol[tuple(slice(l, h) for l, h in zip(*box))].cpu())
        del vol, back
    for c, want in enumerate(samples):
        got = cut.cutout(cstore, 0, *box, channel=c).cpu()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise RuntimeError(f"channel {c}: a box differs after the other channels' writes")
    ts["channels"] = dict(volume=list(cv), channels=tc["channels"], packed_bytes=cstore.nbytes)
    del cstore
    ts["times_s"] = times
    ts["phase_s"] = time.perf_counter() - t_phase
    report["timeseries"] = ts
    log(f"time series {tuple(v)} uint8 ({ts['packed_bytes'] / 2 ** 30:.2f} GiB) and "
        f"{tc['channels']} channels of {cv} uint16: kernel == plain == host slice; times (s) "
        + ", ".join(f"{k} {t:.4f}" for k, t in times.items()))


# ------------------------------------------------ tiered storage, phase 23 ----

def dir_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def host_cutout(backing, grid, lo, hi):
    """The box decoded on the host from the backing `CuboidStore` alone."""
    gshape, cells, alo = gather_ops.build_plan(grid, lo, hi)
    cs = grid.cuboid_shape
    buf = np.zeros([g * c for g, c in zip(gshape, cs)], np.dtype(backing.spec.dtype))
    for pos, m in zip(np.ndindex(*gshape), cells.tolist()):
        buf[tuple(slice(p * c, (p + 1) * c) for p, c in zip(pos, cs))] = \
            backing.read_cuboid(0, m)
    return buf[tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, alo))]


def box_of(box):
    lo, hi = box
    return tuple(slice(l, h) for l, h in zip(lo, hi))


def load_tiers(tc, dev, spec, root, report):
    """Make the image on the device slab by slab (phase 2's generator),
    bring each slab to the host and bulk-load it into the read tier's
    directory through a `CuboidStore` over that path alone (zlib on a
    thread per core, fsync off, as a dump-and-restore would)."""
    grid = spec.grid(0)
    gen = torch.Generator(device=dev).manual_seed(23)
    centres = make_blobs(tc, gen, dev)
    host = np.empty(tc["volume"], np.uint8)
    loader = CuboidStore(spec, backend=DirectoryBackend(os.path.join(root, "read")))
    cs = grid.cuboid_shape
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for x0 in range(0, tc["volume"][0], tc["slab"]):
            slab = make_slab(tc, x0, centres, gen, dev)
            lo, hi = (x0, 0, 0), (x0 + slab.shape[0],) + tuple(tc["volume"][1:])
            gshape, cells, _ = gather_ops.build_plan(grid, lo, hi)
            blocks = dist_mod.split_blocks(slab, gshape, cs).cpu().numpy()
            host[x0:x0 + slab.shape[0]] = slab.cpu().numpy()
            step = 64
            list(pool.map(lambda i: loader.store_cuboids(0, {
                int(m): blocks[j] for j, m in enumerate(cells[i:i + step].tolist(), i)}),
                range(0, len(cells), step)))
    report["load_s"] = time.perf_counter() - t0
    report["raw_bytes"] = host.nbytes
    report["read_tier_bytes"] = dir_bytes(os.path.join(root, "read"))
    report["cuboids"] = loader.write_stats.writes
    return host


def check_objects(proj, ids, objs, dev, counts):
    """`object_cutout` of every object equals its numpy oracle: the
    objects painted in write order (the later wins, as ``overwrite``),
    other ids cleared, over the index's bounding box."""
    for ann_id in ids:
        (lo, dense), _ = drive(counts, dev, lambda: proj.object_cutout(ann_id, 0))
        want = np.zeros(dense.shape, np.uint32)
        for j, (olo, mask) in enumerate(objs):
            a = [max(l, o) for l, o in zip(lo, olo)]
            b = [min(l + s, o + m) for l, s, o, m in zip(lo, dense.shape, olo, mask.shape)]
            if any(x >= y for x, y in zip(a, b)):
                continue
            sub = mask[tuple(slice(x - o, y - o) for x, y, o in zip(a, b, olo))]
            dst = want[tuple(slice(x - l, y - l) for x, y, l in zip(a, b, lo))]
            dst[sub != 0] = ids[j]
        want[want != ann_id] = 0
        if not np.array_equal(uint_ids(dense).cpu().numpy().astype(np.uint32), want):
            raise RuntimeError(f"object {ann_id}: object_cutout != its numpy oracle")


def tiered_storage(tc, dev, report, counts):
    """Phase 23: the device store over the host tiers (a read tier of
    zlib cuboids in a directory, a log write tier with fsync on): cold and
    warm reads, small random writes acknowledged by the log, a reopen that
    replays it, compaction under readers, and an annotation project with a
    log write path."""
    t_phase = time.perf_counter()
    out = {}
    spec = DatasetSpec("tiered", tc["volume"], dtype="uint8")
    grid = spec.grid(0)
    root = tempfile.mkdtemp(prefix="ocp-tiers-")
    try:
        out["disk_free_bytes"] = shutil.disk_usage(root).free
        log(f"tiers under {root}: {out['disk_free_bytes'] / 2 ** 30:.1f} GiB free on that disk")
        host = load_tiers(tc, dev, spec, root, out)
        policy = TierPolicy(write_tier="log", fsync=True)
        backing = tiered_store(spec, root=root, policy=policy)
        log(f"bulk load of {out['cuboids']} cuboids ({out['raw_bytes'] / 2 ** 30:.2f} GiB raw) "
            f"in {out['load_s']:.2f} s; read tier {out['read_tier_bytes'] / 2 ** 30:.3f} GiB")

        # cold reads, then the same tiles warm
        store = DeviceCuboidStore(spec, device=dev, backing=backing)
        store.copy_events = []
        tiles = sd.tiling(grid.volume_shape, tc["tile"])
        pick = np.random.default_rng(23).permutation(len(tiles))[:tc["reads"]]
        tiles = [tiles[i] for i in sorted(pick)]
        stats = cut.CutoutStats()
        cold, host_ms, copy_ms = [], [], []
        for lo, hi in tiles:
            before = store.load_stats.host_s
            store.copy_events.clear()
            got, t = drive(counts, dev, lambda: cut.cutout(store, 0, lo, hi, stats=stats))
            cold.append(t * 1e3)
            host_ms.append((store.load_stats.host_s - before) * 1e3)
            if dev.type == "cuda":
                copy_ms.append(sum(a.elapsed_time(b) for a, b in store.copy_events))
            want = plain_cutout(store.peek(0), grid, lo, hi, dev)
            if not torch.equal(got, want) or not np.array_equal(got.cpu().numpy(),
                                                                host[box_of((lo, hi))]):
                raise RuntimeError(f"cold read {lo}: kernel, plain and host volume differ")
        store.copy_events = None
        warm = []
        for lo, hi in tiles:
            got, t = drive(counts, dev, lambda: cut.cutout(store, 0, lo, hi))
            warm.append(t * 1e3)
            if not np.array_equal(got.cpu().numpy(), host[box_of((lo, hi))]):
                raise RuntimeError(f"warm read {lo} differs from the host volume")
        gather_ms = None
        if dev.type == "cuda":  # the kernel alone on the first tile (not counted)
            args = gather_case(store.peek(0), grid, *tiles[0], dev)
            gather_ms = event_times(dev, lambda i=0: gather_ops.cutout_gather_cuda(*args))
        med = statistics.median
        out["cold_read"] = dict(
            tiles=len(tiles), tile=list(tc["tile"]), ms_median=med(cold), ms_max=max(cold),
            host_fetch_decode_ms_median=med(host_ms),
            h2d_copy_ms_median=med(copy_ms) if copy_ms else None,
            warm_ms_median=med(warm), gather_ms=gather_ms,
            decode_chunks_per_tile=-(-stats.cuboids_read // len(tiles)
                                     // backing.decode_policy.chunk),
            decode_workers=backing.decode_policy.workers,
            cutout_stats=dataclasses.asdict(stats),
            read_stats=dataclasses.asdict(backing.read_stats),
            load_stats=dataclasses.asdict(store.load_stats))
        log(f"{len(tiles)} cold reads of {tc['tile']}: median {med(cold):.2f} ms (host fetch + "
            f"decode {med(host_ms):.2f} ms, copy to the card "
            f"{med(copy_ms) if copy_ms else float('nan'):.3f} ms), warm {med(warm):.4f} ms "
            f"(the gather alone {gather_ms} ms, CUDA events, median of 25); "
            f"{dataclasses.asdict(stats)}; read_stats {dataclasses.asdict(backing.read_stats)}")

        # the spans of one cold read of a tile not yet resident
        fresh = DeviceCuboidStore(spec, device=dev, backing=backing)
        ring = obs_trace.SpanRing(1024)
        with obs_trace.activate(obs_trace.TraceContext("coldread", ring)):
            drive(counts, dev, lambda: cut.cutout(fresh, 0, *tiles[0]))
        spans = [(s["name"], round(s["dur_s"] * 1e3, 3))
                 for s in sorted(ring.spans_for("coldread"), key=lambda s: s["t0"])]
        out["cold_read_spans_ms"] = spans
        log(f"one cold read's spans (ms): {spans}")
        names = {n for n, _ in spans}
        if not {"plan", "assemble", "store.fetch", "decode"} <= names:
            raise RuntimeError(f"cold read spans {sorted(names)} miss the reference's")
        del fresh

        # small random writes (paper Fig. 13), each acknowledged by the log
        rng = np.random.default_rng(13)
        wb = tc["wbox"]
        writes, times = [], []
        for _ in range(tc["writes"]):
            lo = [int(rng.integers(0, v - w)) for v, w in zip(tc["volume"], wb)]
            hi = [l + w for l, w in zip(lo, wb)]
            data = rng.integers(1, 256, size=wb, dtype=np.uint8)
            _, t = drive(counts, dev, lambda: cut.write_cutout(store, 0, lo, data))
            times.append(t * 1e3)
            host[box_of((lo, hi))] = data
            got = cut.cutout(store, 0, lo, hi).cpu().numpy()
            if not np.array_equal(got, data) or not np.array_equal(
                    host_cutout(backing, grid, lo, hi), data):
                raise RuntimeError(f"write {lo}: not readable at once from the card and the tiers")
            writes.append((lo, hi))
        log_stats = backing.write_backend.stats()
        out["writes"] = dict(n=len(writes), box=list(wb), p50_ms=float(np.percentile(times, 50)),
                             p99_ms=float(np.percentile(times, 99)), max_ms=max(times),
                             log=log_stats, write_stats=dataclasses.asdict(backing.write_stats))
        log(f"{len(writes)} writes of {wb}: p50 {out['writes']['p50_ms']:.3f} ms, p99 "
            f"{out['writes']['p99_ms']:.3f} ms; log {log_stats}")
        del store

        # reopen: a new stack over the same directories replays the log
        t0 = time.perf_counter()
        reopened = tiered_store(spec, root=root, policy=policy)
        out["reopen_s"] = time.perf_counter() - t0
        again = DeviceCuboidStore(spec, device=dev, backing=reopened)
        for box in writes:
            got = drive(counts, dev, lambda: cut.cutout(again, 0, *box))[0]
            if not np.array_equal(got.cpu().numpy(), host[box_of(box)]):
                raise RuntimeError(f"after reopen, write {box[0]} reads otherwise")
        backing.close()
        del again
        log(f"reopened in {out['reopen_s']:.3f} s; all {len(writes)} writes read back cold")

        # compaction while a thread reads the written boxes
        errors, passes = [], [0]
        done = threading.Event()

        def reader():
            try:
                while not done.is_set() or passes[0] == 0:
                    reads = DeviceCuboidStore(spec, device=dev, backing=reopened)
                    for box in writes:
                        got = cut.cutout(reads, 0, *box).cpu().numpy()
                        if not np.array_equal(got, host[box_of(box)]):
                            raise RuntimeError(f"read of {box[0]} during compaction differs")
                    passes[0] += 1
            except Exception as e:  # surfaced on the main thread
                errors.append(e)

        th = threading.Thread(target=reader, name="compaction-reader")
        reset_launches()
        th.start()
        cstats = compact_store(reopened)
        done.set()
        th.join(timeout=600)
        counts["cutout_gather"] = counts.get("cutout_gather", 0) + gather_ops.launches
        if th.is_alive() or errors:
            raise RuntimeError(f"reads during compaction failed: {errors}")
        after = DeviceCuboidStore(spec, device=dev, backing=reopened)
        for box in writes:
            got = drive(counts, dev, lambda: cut.cutout(after, 0, *box))[0]
            if not np.array_equal(got.cpu().numpy(), host[box_of(box)]):
                raise RuntimeError(f"after compaction, write {box[0]} reads otherwise")
        lstats = reopened.write_backend.stats()
        if lstats["live_keys"] or lstats["tombstones"] or lstats["log_bytes"]:
            raise RuntimeError(f"the log is not empty after compaction: {lstats}")
        out["compaction"] = dict(cstats.asdict(), reader_passes=passes[0], log_after=lstats)
        comp_lines = [ln for ln in REGISTRY.prometheus_text().splitlines()
                      if "compaction" in ln and not ln.startswith("#")
                      and not ln.split("{")[0].endswith("_bucket")]
        out["compaction_metrics"] = comp_lines
        log(f"compaction {cstats.asdict()} beside {passes[0]} reader passes; log after {lstats}; "
            f"metrics {comp_lines}")
        del after
        reopened.close()
        out["tier_bytes"] = dict(read=dir_bytes(os.path.join(root, "read")),
                                 wal=dir_bytes(os.path.join(root, "wal")))
        log(f"tiers' stored bytes: {out['tier_bytes']}")
        del host
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # annotations with a log write path
        aroot = os.path.join(root, "anno")
        proj = AnnotationProject("synapses", spec, device=dev,
                                 backend=DirectoryBackend(os.path.join(aroot, "read")),
                                 write_path_backend=LogBackend(os.path.join(aroot, "wal")))
        rng = np.random.default_rng(17)
        objs = []
        for _ in range(tc["objects"]):
            size = [int(rng.integers(*tc["obj"])) for _ in range(3)]
            lo = [int(rng.integers(0, v - s)) for v, s in zip(tc["volume"], size)]
            objs.append((lo, (rng.random(size) < 0.5).astype(np.uint32)))
        ids, t_batch = drive(counts, dev, lambda: proj.batch_write_objects(
            0, [(None, lo, m) for lo, m in objs]))
        n_migrated, t_migrate = timed(dev, lambda: proj.store.backing.migrate())
        check_objects(proj, ids, objs, dev, counts)
        abacking, index = proj.store.backing, proj.index
        wstats = dataclasses.asdict(abacking.write_stats)
        del proj
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cold_proj = AnnotationProject("cold", spec, device=dev, store_factory=lambda s: (
            DeviceCuboidStore(s, device=dev, backing=abacking)))
        cold_proj.index = index
        check_objects(cold_proj, ids, objs, dev, counts)
        out["annotations"] = dict(objects=len(ids), batch_write_s=t_batch, migrate_s=t_migrate,
                                  migrated=n_migrated, write_stats=wstats)
        log(f"annotations: {len(ids)} objects written in {t_batch:.4f} s, migrate of "
            f"{n_migrated} cuboids {t_migrate:.4f} s, object_cutout == oracle (resident and cold)")
        del cold_proj
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    report["tiered"] = out
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------ cluster and front door, phase 24 ----

def http(method, url, body=None):
    """One HTTP round trip on loopback -> (status, headers, payload)."""
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def box_path(ds, lo, hi, verb="cutout"):
    return f"/{ds}/{verb}/0/" + "/".join(f"{a},{b}" for a, b in zip(lo, hi))


def wire_volume(status, headers, payload, what):
    """The volume of a 200 octet-stream answer (zlib decoded)."""
    if status != 200:
        raise RuntimeError(f"{what}: HTTP {status}: {payload[:200]!r}")
    if headers.get("X-Encode") == "zlib":
        payload = zlib.decompress(payload)
    shape = tuple(int(s) for s in headers["X-Shape"].split(","))
    return np.frombuffer(payload, dtype=headers["X-Dtype"]).reshape(shape)


def random_box(rng, volume, size, lo_max=None):
    hi_lim = [v - s for v, s in zip(lo_max or volume, size)]
    lo = [int(rng.integers(0, max(1, h + 1))) for h in hi_lim]
    return lo, [l + s for l, s in zip(lo, size)]


def load_cluster(cc, dev, spec, cluster, out):
    """Make the image on the card slab by slab (phase 2's generator), bring
    each slab to the host and bulk-load it into the cluster: chunks of 64
    cuboids through `ClusterStore.store_cuboids` from a thread a core, so
    each replica's zlib runs on the cluster's node pool in parallel; then
    flush."""
    grid = spec.grid(0)
    gen = torch.Generator(device=dev).manual_seed(24)
    centres = make_blobs(cc, gen, dev)
    host = np.empty(cc["volume"], np.uint8)
    cs = grid.cuboid_shape
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for x0 in range(0, cc["volume"][0], cc["slab"]):
            slab = make_slab(cc, x0, centres, gen, dev)
            lo, hi = (x0, 0, 0), (x0 + slab.shape[0],) + tuple(cc["volume"][1:])
            gshape, cells, _ = gather_ops.build_plan(grid, lo, hi)
            blocks = dist_mod.split_blocks(slab, gshape, cs).cpu().numpy()
            host[x0:x0 + slab.shape[0]] = slab.cpu().numpy()
            list(pool.map(lambda i: cluster.store_cuboids(0, {
                int(m): blocks[j] for j, m in enumerate(cells[i:i + 64].tolist(), i)}),
                range(0, len(cells), 64)))
    out["ingest_flushed"] = cluster.flush()
    out["ingest_s"] = time.perf_counter() - t0
    out["stored_bytes"] = cluster.storage_bytes()
    out["keys_per_node"] = cluster.keys_per_node()
    return host


def cluster_front_door(cc, dev, report, counts):
    """Phase 24: a dataset on a replicated 4-node cluster under the device
    store, served over HTTP on 127.0.0.1 by `FrontDoor`: cold and warm
    reads, acknowledged writes, a batch, load with shedding, a grow and a
    decommission under readers and a writer, a fresh device store over the
    moved cluster, an annotation project, and the stats routes."""
    t_phase = time.perf_counter()
    out, stages = {}, {}
    spec = DatasetSpec("em", cc["volume"], dtype="uint8")
    grid = spec.grid(0)
    cluster = ClusterStore(spec, n_nodes=cc["nodes"], replication=cc["replication"],
                           cache_bytes=cc["cache"] * cc["nodes"], write_behind=True,
                           max_workers=max(cc["nodes"], os.cpu_count() or 1))
    t0 = time.perf_counter()
    host = load_cluster(cc, dev, spec, cluster, out)
    stages["ingest_s"] = time.perf_counter() - t0
    log(f"cluster of {cc['nodes']} nodes, replication {cc['replication']}: ingest of "
        f"{grid.n_cells} cuboids ({host.nbytes / 2 ** 30:.2f} GiB raw) in {out['ingest_s']:.2f} s, "
        f"{out['stored_bytes'] / 2 ** 30:.3f} GiB stored, keys per node {out['keys_per_node']}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    store = DeviceCuboidStore(spec, device=dev, backing=cluster)
    service = VolumeService()
    service.add_dataset("em", store)
    door = FrontDoor(service)
    door.start()
    try:
        url = door.url

        # 1. cold, then warm reads of tiles, raw and zlib, beside in-process reads
        t0 = time.perf_counter()
        tiles = sd.tiling(grid.volume_shape, cc["tile"])
        pick = np.random.default_rng(24).permutation(len(tiles))[:cc["reads"]]
        tiles = [tiles[i] for i in sorted(pick)]
        store.copy_events = []
        cold, host_ms, copy_ms = [], [], []
        for lo, hi in tiles:
            before = store.load_stats.host_s
            store.copy_events.clear()
            (st, hd, pl), t = drive(counts, dev, lambda: http("GET", url + box_path("em", lo, hi)))
            got = wire_volume(st, hd, pl, f"cold GET {lo}")
            cold.append(t * 1e3)
            host_ms.append((store.load_stats.host_s - before) * 1e3)
            if dev.type == "cuda":
                copy_ms.append(sum(a.elapsed_time(b) for a, b in store.copy_events))
            want = host[box_of((lo, hi))]
            plain = plain_cutout(store.peek(0), grid, lo, hi, dev).cpu().numpy()
            if not np.array_equal(got, want) or not np.array_equal(plain, want):
                raise RuntimeError(f"cold GET {lo}: the wire, the plain gather and the host "
                                   f"volume differ")
        store.copy_events = None
        warm, warm_zlib, inproc = [], [], []
        for lo, hi in tiles:
            want = host[box_of((lo, hi))]
            (st, hd, pl), t = drive(counts, dev, lambda: http("GET", url + box_path("em", lo, hi)))
            warm.append(t * 1e3)
            if not np.array_equal(wire_volume(st, hd, pl, f"warm GET {lo}"), want):
                raise RuntimeError(f"warm GET {lo} differs from the host volume")
            if len(warm_zlib) < cc["zlib_reads"]:
                (st, hd, pl), t = drive(counts, dev, lambda: http(
                    "GET", url + box_path("em", lo, hi) + "?encode=zlib"))
                warm_zlib.append(t * 1e3)
                if not np.array_equal(wire_volume(st, hd, pl, f"zlib GET {lo}"), want):
                    raise RuntimeError(f"zlib GET {lo} differs from the host volume")
            got, t = drive(counts, dev, lambda: cut.cutout(store, 0, lo, hi).cpu())
            inproc.append(t * 1e3)
            if not np.array_equal(got.numpy(), want):
                raise RuntimeError(f"in-process read {lo} differs from the host volume")
        gather_ms = None
        if dev.type == "cuda":  # the kernel alone on the first tile (not counted)
            args = gather_case(store.peek(0), grid, *tiles[0], dev)
            gather_ms = event_times(dev, lambda i=0: gather_ops.cutout_gather_cuda(*args))
        med = statistics.median
        out["reads"] = dict(
            tiles=len(tiles), tile=list(cc["tile"]), cold_ms_median=med(cold),
            cold_ms_max=max(cold), host_fetch_decode_ms_median=med(host_ms),
            h2d_copy_ms_median=med(copy_ms) if copy_ms else None, gather_ms=gather_ms,
            warm_ms_median=med(warm), zlib_reads=len(warm_zlib),
            warm_zlib_ms_median=med(warm_zlib),
            in_process_ms_median=med(inproc),
            wire_ms_median=med(warm) - med(inproc),
            load_stats=dataclasses.asdict(store.load_stats))
        stages["reads_s"] = time.perf_counter() - t0
        log(f"{len(tiles)} cold GETs of {cc['tile']}: median {med(cold):.2f} ms (host fetch + "
            f"decode {med(host_ms):.2f} ms, copy to the card "
            f"{med(copy_ms) if copy_ms else float('nan'):.3f} ms, the gather {gather_ms} ms, "
            f"encode and send {med(cold) - med(host_ms) - (med(copy_ms) if copy_ms else 0):.2f} "
            f"ms); warm raw {med(warm):.3f} ms, warm zlib {med(warm_zlib):.3f} ms "
            f"({len(warm_zlib)} tiles), in-process "
            f"{med(inproc):.3f} ms (the wire {med(warm) - med(inproc):.3f} ms)")

        # 2. writes acknowledged with {"sync": true}, each read back at once
        t0 = time.perf_counter()
        rng = np.random.default_rng(124)
        wb, put_ms, writes = cc["wbox"], [], []
        for _ in range(cc["writes"]):
            lo, hi = random_box(rng, cc["volume"], wb)
            data = rng.integers(1, 256, size=wb, dtype=np.uint8)
            (st, _, pl), t = drive(counts, dev, lambda: http(
                "PUT", url + box_path("em", lo, hi) + "?sync=1", data.tobytes()))
            if st != 200:
                raise RuntimeError(f"PUT {lo}: HTTP {st}: {pl[:200]!r}")
            put_ms.append(t * 1e3)
            host[box_of((lo, hi))] = data
            got = wire_volume(*drive(counts, dev, lambda: http(
                "GET", url + box_path("em", lo, hi)))[0], f"read-back {lo}")
            if not np.array_equal(got, data):
                raise RuntimeError(f"PUT {lo} not read back at once over HTTP")
            writes.append((lo, hi))
        st, _, pl = http("POST", url + "/em/flush")
        if st != 200:
            raise RuntimeError(f"POST /flush: HTTP {st}")
        out["writes"] = dict(n=len(writes), box=list(wb), p50_ms=float(np.percentile(put_ms, 50)),
                             p99_ms=float(np.percentile(put_ms, 99)), max_ms=max(put_ms),
                             flush=json.loads(pl))
        stages["writes_s"] = time.perf_counter() - t0
        log(f"{len(writes)} PUTs of {wb} with sync: p50 {out['writes']['p50_ms']:.3f} ms, p99 "
            f"{out['writes']['p99_ms']:.3f} ms; each read back at once; POST /flush "
            f"{out['writes']['flush']}")

        # 3. a batch of boxes up to the tile
        t0 = time.perf_counter()
        boxes = [random_box(rng, cc["volume"], [int(rng.integers(1, t + 1)) for t in cc["tile"]])
                 for _ in range(cc["batch"])]
        body = json.dumps({"boxes": [[lo, hi] for lo, hi in boxes]}).encode()
        (st, _, pl), t_batch = drive(counts, dev, lambda: http(
            "POST", url + "/em/batch/cutout", body))
        env = json.loads(pl)
        if st != 200 or env["n"] != len(boxes):
            raise RuntimeError(f"POST /batch/cutout: HTTP {st}")
        for (lo, hi), res in zip(boxes, env["results"]):
            got = np.frombuffer(base64.b64decode(res["data"]), np.uint8).reshape(res["shape"])
            if not np.array_equal(got, host[box_of((lo, hi))]):
                raise RuntimeError(f"batch box {lo} differs from the host volume")
        out["batch"] = dict(boxes=len(boxes), s=t_batch,
                            voxels=int(sum(np.prod([h - l for l, h in zip(*b)]) for b in boxes)))
        stages["batch_s"] = time.perf_counter() - t0
        log(f"POST /batch/cutout of {len(boxes)} boxes ({out['batch']['voxels']} voxels) in "
            f"{t_batch:.3f} s, each equal to the host volume")

        # 4. load: small GETs from many client threads, shedding allowed
        t0 = time.perf_counter()
        before, loads = door.counters(), dataclasses.asdict(store.load_stats)
        answered, shed_seen, bad = [0] * cc["clients"], [0] * cc["clients"], []
        stop = threading.Event()

        def client(tid):
            crng = np.random.default_rng(1000 + tid)
            try:
                while not stop.is_set():
                    lo, hi = random_box(crng, cc["volume"], cc["small"])
                    st, hd, pl = http("GET", url + box_path("em", lo, hi))
                    if st == 503:
                        shed_seen[tid] += 1
                        continue
                    if not np.array_equal(wire_volume(st, hd, pl, f"load GET {lo}"),
                                          host[box_of((lo, hi))]):
                        raise RuntimeError(f"load GET {lo} differs from the host volume")
                    answered[tid] += 1
            except Exception as e:  # surfaced below
                bad.append(e)

        def load():
            threads = [threading.Thread(target=client, args=(t,)) for t in range(cc["clients"])]
            for th in threads:
                th.start()
            time.sleep(cc["load_s"])
            stop.set()
            for th in threads:
                th.join(timeout=120)

        _, t_load = drive(counts, dev, load)
        if bad:
            raise RuntimeError(f"load: {bad[:3]}")
        after = door.counters()
        delta = {k: after[k] - before.get(k, 0) for k in after}
        loads = {k: v - loads[k] for k, v in dataclasses.asdict(store.load_stats).items()}
        out["load"] = dict(clients=cc["clients"], box=list(cc["small"]), s=t_load,
                           answered=sum(answered), shed=sum(shed_seen),
                           requests_per_s=sum(answered) / t_load, front_door=delta,
                           admit_limit=door.admit_limit, cold_loads=loads)
        stages["load_s"] = time.perf_counter() - t0
        log(f"load: {cc['clients']} clients for {t_load:.2f} s: {sum(answered)} answered "
            f"({sum(answered) / t_load:.1f} requests/s), {sum(shed_seen)} shed (503, admit "
            f"limit {door.admit_limit}); front door {delta}; cold loads during it {loads}")

        # 5. grow and decommission under readers and a writer
        t0 = time.perf_counter()
        topo_before = json.loads(http("GET", url + "/em/topology")[2])
        lost, bad, acked = [], [], []
        stop = threading.Event()
        reserve = cc["volume"][0] - 2 * cc["wbox"][0]  # the writer's rows, no reader's

        def reader(tid):
            rrng = np.random.default_rng(2000 + tid)
            try:
                while not stop.is_set():
                    lo, hi = random_box(rrng, cc["volume"], cc["live_box"],
                                        lo_max=[reserve] + list(cc["volume"][1:]))
                    st, hd, pl = http("GET", url + box_path("em", lo, hi))
                    if st != 200 or not np.array_equal(
                            wire_volume(st, hd, pl, "live GET"), host[box_of((lo, hi))]):
                        lost.append((lo, st))
            except Exception as e:  # surfaced below
                bad.append(e)

        def writer():
            wrng = np.random.default_rng(3000)
            try:
                while not stop.is_set():
                    lo, hi = random_box(wrng, cc["volume"], wb)
                    lo[0] = reserve + int(wrng.integers(0, cc["volume"][0] - reserve - wb[0] + 1))
                    hi[0] = lo[0] + wb[0]
                    data = wrng.integers(1, 256, size=wb, dtype=np.uint8)
                    st, _, pl = http("PUT", url + box_path("em", lo, hi), data.tobytes())
                    if st != 200:
                        lost.append((lo, st))
                        continue
                    host[box_of((lo, hi))] = data
                    acked.append((lo, hi))
            except Exception as e:  # surfaced below
                bad.append(e)

        def moves():
            threads = [threading.Thread(target=reader, args=(t,)) for t in range(cc["readers"])]
            threads.append(threading.Thread(target=writer))
            for th in threads:
                th.start()
            try:
                time.sleep(0.5)
                grow = timed(dev, lambda: json.loads(http("POST", url + "/em/nodes")[2]))
                time.sleep(0.5)
                drop = timed(dev, lambda: json.loads(http("DELETE", url + "/em/nodes/0")[2]))
                time.sleep(0.5)
            finally:
                stop.set()
                for th in threads:
                    th.join(timeout=120)
            return grow, drop

        ((grow, t_grow), (drop, t_drop)), t_moves = drive(counts, dev, moves)
        topo_after = json.loads(http("GET", url + "/em/topology")[2])
        if bad or grow.get("status") != 200 or drop.get("status") != 200:
            raise RuntimeError(f"topology changes: {bad[:3]} {grow.get('error')} "
                               f"{drop.get('error')}")
        if lost:
            raise RuntimeError(f"lost_reads {len(lost)} during the moves: {lost[:5]}")
        if topo_after["n_nodes"] != cc["nodes"]:
            raise RuntimeError(f"{topo_after['n_nodes']} nodes after the grow and the drop")
        out["moves"] = dict(s=t_moves, lost_reads=0, writes_acked=len(acked),
                            grow_s=t_grow,
                            grow_new_node_keys=grow["topology"]["keys_per_node"][-1],
                            decommission_s=drop["seconds"], decommission_http_s=t_drop,
                            decommission_moved_keys=drop["moved_keys"],
                            topology_before=topo_summary(topo_before),
                            topology_after=topo_summary(topo_after))
        stages["moves_s"] = time.perf_counter() - t0
        log(f"grow {cc['nodes']} -> {cc['nodes'] + 1} and decommission of node 0 under "
            f"{cc['readers']} readers and a writer ({len(acked)} PUTs acknowledged): lost_reads 0; "
            f"topology before {out['moves']['topology_before']}, after "
            f"{out['moves']['topology_after']}; grow (POST /em/nodes) {t_grow:.3f} s, the new "
            f"node took {out['moves']['grow_new_node_keys']} keys; decommission "
            f"{drop['seconds']:.3f} s, {drop['moved_keys']} keys moved")

        # 6. a fresh device store over the moved cluster reads everything
        t0 = time.perf_counter()
        if http("POST", url + "/flush")[0] != 200:
            raise RuntimeError("POST /flush after the moves failed")
        after_store = DeviceCuboidStore(spec, device=dev, backing=cluster)
        step = cc["slab"]
        for x0 in range(0, cc["volume"][0], step):
            lo, hi = (x0, 0, 0), (min(x0 + step, cc["volume"][0]),) + tuple(cc["volume"][1:])
            got = drive(counts, dev, lambda: cut.cutout(after_store, 0, lo, hi))[0]
            if not np.array_equal(got.cpu().numpy(), host[box_of((lo, hi))]):
                raise RuntimeError(f"a fresh store over the moved cluster reads slab {x0} "
                                   f"otherwise")
        out["fresh_read_s"] = time.perf_counter() - t0
        stages["fresh_s"] = out["fresh_read_s"]
        log(f"a fresh device store read the whole image and all {len(writes) + len(acked)} "
            f"acknowledged writes bit-equal in {out['fresh_read_s']:.2f} s")
        del after_store
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # 7. an annotation project behind the same service
        t0 = time.perf_counter()
        proj = AnnotationProject("anno", spec, device=dev, store_factory=lambda s: (
            DeviceCuboidStore(s, device=dev, backing=ClusterStore(
                s, n_nodes=cc["nodes"], replication=cc["replication"]))))
        service.add_project("anno", proj)
        orng = np.random.default_rng(17)
        objs = []
        for _ in range(cc["objects"]):
            size = [int(orng.integers(*cc["obj"])) for _ in range(3)]
            lo = [int(orng.integers(0, v - s)) for v, s in zip(cc["volume"], size)]
            objs.append((lo, (orng.random(size) < 0.5).astype(np.uint32)))
        ids = drive(counts, dev, lambda: proj.batch_write_objects(
            0, [(None, lo, m) for lo, m in objs]))[0]
        for ann_id in ids:
            st, _, pl = http("GET", url + f"/anno/objects/{ann_id}/boundingbox")
            bbox = json.loads(pl)
            if st != 200 or (bbox["lo"], bbox["hi"]) != tuple(
                    list(b) for b in proj.bounding_box(ann_id, 0)):
                raise RuntimeError(f"object {ann_id}: boundingbox {bbox} != the index's")
            (st, hd, pl), _ = drive(counts, dev, lambda: http(
                "GET", url + f"/anno/objects/{ann_id}/cutout"))
            dense = wire_volume(st, hd, pl, f"object {ann_id}")
            olo = [int(v) for v in hd["X-Lo"].split(",")]
            if not np.array_equal(dense, object_oracle(olo, dense.shape, objs, ids, ann_id)):
                raise RuntimeError(f"object {ann_id}: GET cutout != its numpy oracle")
        out["annotations"] = dict(objects=len(ids))
        stages["annotations_s"] = time.perf_counter() - t0
        log(f"annotations: {len(ids)} objects; GET boundingbox == the index and GET cutout == "
            f"numpy for each")

        # 8. the stats routes
        for path in ("/em/stats", "/metrics"):
            st, _, pl = http("GET", url + path)
            if st != 200:
                raise RuntimeError(f"GET {path}: HTTP {st}")
        stats = json.loads(http("GET", url + "/em/stats")[2])
        out["stats"] = dict(cache=stats["cache"], queue=stats["queue"],
                            health=[h["state"] for h in stats["health"]])
        out["front_door"] = door.counters()
        log(f"GET /em/stats and /metrics 200; cache {stats['cache']}; front door "
            f"{out['front_door']}")
    finally:
        door.close()
        cluster.close()
    out["stages"] = stages
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 24 stages (s): {stages}")
    report["cluster"] = out
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def topo_summary(topo):
    return dict(n_nodes=topo["n_nodes"], replication=topo["replication"],
                keys_per_node=topo["keys_per_node"], health=topo["health"])


def object_oracle(lo, shape, objs, ids, ann_id):
    """The numpy oracle of one object's cutout (as `check_objects`)."""
    want = np.zeros(shape, np.uint32)
    for j, (olo, mask) in enumerate(objs):
        a = [max(l, o) for l, o in zip(lo, olo)]
        b = [min(l + s, o + m) for l, s, o, m in zip(lo, shape, olo, mask.shape)]
        if any(x >= y for x, y in zip(a, b)):
            continue
        sub = mask[tuple(slice(x - o, y - o) for x, y, o in zip(a, b, olo))]
        dst = want[tuple(slice(x - l, y - l) for x, y, l in zip(a, b, lo))]
        dst[sub != 0] = ids[j]
    want[want != ann_id] = 0
    return want


# ------------------------------------------------ storage faults, phase 25 ----

def pcts(ms):
    """(p50, p99) of a list of ms, or (None, None) for none."""
    if not ms:
        return None, None
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def stage_summary(gets, puts, errors):
    g50, g99 = pcts(gets)
    p50, p99 = pcts(puts)
    return dict(gets=len(gets), get_p50_ms=g50, get_p99_ms=g99, puts=len(puts),
                put_p50_ms=p50, put_p99_ms=p99, client_errors=errors)


def fmt_stage(name, s):
    def f(x):
        return "-" if x is None else f"{x:.3f}"
    return (f"{name}: {s['gets']} GETs p50 {f(s['get_p50_ms'])} / p99 {f(s['get_p99_ms'])} ms, "
            f"{s['puts']} PUTs p50 {f(s['put_p50_ms'])} / p99 {f(s['put_p99_ms'])} ms, "
            f"{s['client_errors']} client-visible errors")


class Oracle:
    """The host volume with every acknowledged write applied, under a lock
    (the writer thread applies, the checks read)."""

    def __init__(self, host):
        self.host = host
        self.lock = threading.Lock()
        self.acked = []

    def apply(self, lo, hi, data):
        with self.lock:
            self.host[box_of((lo, hi))] = data
            self.acked.append((list(lo), list(hi)))

    def box(self, lo, hi):
        with self.lock:
            return self.host[box_of((lo, hi))].copy()


def put_until_acked(url, ds, lo, hi, data, oracle, errors, put_ms, attempts=500):
    """PUT with ``sync`` until it answers 200 (a client retrying its
    unacknowledged write); each failed answer counts as a client-visible
    error, and the acknowledged data goes into the oracle."""
    for _ in range(attempts):
        t0 = time.perf_counter()
        st, _, pl = http("PUT", url + box_path(ds, lo, hi) + "?sync=1", data.tobytes())
        if st == 200:
            put_ms.append((time.perf_counter() - t0) * 1e3)
            oracle.apply(lo, hi, data)
            return
        errors.append((list(lo), st, pl[:120]))
        time.sleep(0.01)
    raise RuntimeError(f"PUT {lo} never acknowledged after {attempts} attempts: {errors[-1]}")


def get_checked(url, ds, lo, hi, oracle, errors, get_ms, what):
    """GET a box, retrying a 503 (shed); a 200 must equal the oracle.
    Returns whether it answered 200 (other answers count as errors)."""
    for _ in range(200):
        t0 = time.perf_counter()
        st, hd, pl = http("GET", url + box_path(ds, lo, hi))
        if st == 503:
            time.sleep(0.005)
            continue
        if st != 200:
            errors.append((list(lo), st, pl[:120]))
            return False
        get_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(wire_volume(st, hd, pl, what), oracle.box(lo, hi)):
            raise RuntimeError(f"{what} {lo}: differs from the oracle")
        return True
    raise RuntimeError(f"{what} {lo}: shed 200 times")


def fault_regions(fc, spec):
    """The stages' disjoint regions along x: stage (a)'s tiles and PUTs
    below X/2; the readers' never-read cuboids from X/2 up to the
    writer's rows; the writer's rows, the last 2 x wbox[0]."""
    X = fc["volume"][0]
    cs = spec.grid(0).cuboid_shape
    writer_lo = X - 2 * fc["wbox"][0]
    reader_hi = writer_lo // cs[0] * cs[0]
    if reader_hi <= X // 2:
        raise RuntimeError("phase 25's regions overlap")
    boxes = [((x, y, z), (x + cs[0], y + cs[1], z + cs[2]))
             for x in range(X // 2, reader_hi, cs[0])
             for y in range(0, fc["volume"][1], cs[1])
             for z in range(0, fc["volume"][2], cs[2])]
    order = np.random.default_rng(25).permutation(len(boxes))
    return X // 2, [boxes[i] for i in order], writer_lo


def storage_faults(fc, dev, report, counts):
    """Phase 25: the cluster under the device store and the front door,
    every node a `FaultyNode` with a crash-only plan, a `StorageSupervisor`
    and the cluster's prober running: (a) healthy cold GETs and synced
    PUTs; (b) a node crashed under 8 cold readers and a writer until the
    supervisor has removed it and replication is back at target; (c) a
    short crash of another node under the writer, healed by resync; (d)
    cold and warm GETs from a fresh device store over the healed cluster,
    and PUTs.  Every 200 equals the oracle (the host volume with the
    acknowledged writes applied) and the plain gather; afterwards every
    acknowledged write reads back over HTTP and from a fresh store."""
    t_phase = time.perf_counter()
    out, stages = {}, {}
    spec = DatasetSpec("em", fc["volume"], dtype="uint8", base_cuboid=fc.get("cuboid"))
    grid = spec.grid(0)
    fac = faulty_factory(plans={i: FaultPlan(seed=i) for i in range(fc["nodes"])})
    cluster = ClusterStore(spec, n_nodes=fc["nodes"], replication=fc["replication"],
                           node_factory=fac, cache_bytes=fc["cache"] * fc["nodes"],
                           write_behind=True,
                           max_workers=max(fc["nodes"], os.cpu_count() or 1))
    removals, rereplications = [], []
    remove_node, re_replicate = cluster.remove_node, cluster.re_replicate

    def recording_remove(*a, **kw):  # the supervisor's failover, with its report
        res = remove_node(*a, **kw)
        removals.append(res)
        return res

    def recording_re_replicate(*a, **kw):
        res = re_replicate(*a, **kw)
        rereplications.append(res)
        return res

    cluster.remove_node, cluster.re_replicate = recording_remove, recording_re_replicate
    t0 = time.perf_counter()
    oracle = Oracle(load_cluster(fc, dev, spec, cluster, out))
    stages["ingest_s"] = time.perf_counter() - t0
    log(f"phase 25: {fc['nodes']} faulty nodes (crash-only plans, seeds 0-{fc['nodes'] - 1}), "
        f"replication {fc['replication']}: ingest of {grid.n_cells} cuboids in "
        f"{out['ingest_s']:.2f} s, keys per node {out['keys_per_node']}")
    store = DeviceCuboidStore(spec, device=dev, backing=cluster)
    service = VolumeService()
    service.add_dataset("em", store)
    door = FrontDoor(service)
    door.start()
    sup = StorageSupervisor(cluster, watch=ClusterWatch(cluster, dead_ticks=fc["dead_ticks"]),
                            interval=fc["interval"])
    cluster.start_prober(interval=fc["interval"])
    sup.start()
    half, reader_pool, writer_lo = fault_regions(fc, spec)
    url, wb = door.url, fc["wbox"]
    rng = np.random.default_rng(125)
    read_boxes = []
    try:
        # (a) healthy: cold tile GETs below X/2, then synced PUTs there
        t0 = time.perf_counter()
        tiles = [t for t in sd.tiling(grid.volume_shape, fc["tile"]) if t[1][0] <= half]
        tiles = [tiles[i] for i in sorted(np.random.default_rng(26).permutation(
            len(tiles))[:fc["reads"]])]
        gets, puts, errors = [], [], []

        def healthy():
            for lo, hi in tiles:
                if not get_checked(url, "em", lo, hi, oracle, errors, gets, "cold GET"):
                    raise RuntimeError(f"healthy cold GET {lo}: {errors[-1]}")
                read_boxes.append((lo, hi))
            for _ in range(fc["writes"]):
                lo, hi = random_box(rng, fc["volume"], wb, lo_max=[half] + list(fc["volume"][1:]))
                data = rng.integers(1, 256, size=wb, dtype=np.uint8)
                put_until_acked(url, "em", lo, hi, data, oracle, errors, puts)

        drive(counts, dev, healthy)
        out["healthy"] = stage_summary(gets, puts, len(errors))
        stages["healthy_s"] = time.perf_counter() - t0
        log(fmt_stage("(a) healthy", out["healthy"]))

        # (b) kill node 1 under cold readers and a writer
        t0 = time.perf_counter()
        pool_lock, lost, bad = threading.Lock(), [], []
        gets, puts, errors, wr_errors = [], [], [], []
        stop = threading.Event()
        reader_boxes = list(reader_pool)

        def reader():
            try:
                while not stop.is_set():
                    with pool_lock:
                        if not reader_boxes:
                            return
                        lo, hi = reader_boxes.pop()
                    if get_checked(url, "em", lo, hi, oracle, errors, gets, "cold GET (b)"):
                        read_boxes.append((lo, hi))
                    else:
                        lost.append((lo, errors[-1]))
            except Exception as e:  # surfaced below
                bad.append(e)

        def writer(wrng, stop_ev, errs, put_list):
            try:
                while not stop_ev.is_set():
                    lo, hi = random_box(wrng, fc["volume"], wb)
                    lo[0] = writer_lo + int(wrng.integers(0, fc["volume"][0] - writer_lo - wb[0] + 1))
                    hi[0] = lo[0] + wb[0]
                    data = wrng.integers(1, 256, size=wb, dtype=np.uint8)
                    put_until_acked(url, "em", lo, hi, data, oracle, errs, put_list)
            except Exception as e:  # surfaced below
                bad.append(e)

        def kill():
            threads = [threading.Thread(target=reader) for _ in range(fc["readers"])]
            threads.append(threading.Thread(target=writer, args=(
                np.random.default_rng(3000), stop, wr_errors, puts)))
            for th in threads:
                th.start()
            marks = {}
            try:
                time.sleep(fc["kill_after_s"])
                victim = fac.built[1]
                t_crash = time.perf_counter()
                victim.crash()
                deadline_t = t_crash + fc["heal_limit_s"]
                while time.perf_counter() < deadline_t:
                    topo = cluster.topology()
                    now = time.perf_counter() - t_crash
                    if "dead" not in marks and topo["n_nodes"] == fc["nodes"] \
                            and topo["health"][1] == "dead":
                        marks["dead"] = now
                    if "failover_started" not in marks and topo["rebalancing"]:
                        marks["failover_started"] = now
                    if "failover" not in marks and topo["n_nodes"] == fc["nodes"] - 1:
                        marks["failover"] = now
                    if ("failover" in marks and not topo["rebalancing"]
                            and topo["replication"] == topo["replication_target"]):
                        marks["healed"] = now
                        break
                    time.sleep(0.005)
            finally:
                stop.set()
                for th in threads:
                    th.join(timeout=120)
            return marks

        marks, _ = drive(counts, dev, kill)
        if bad:
            raise RuntimeError(f"(b): {bad[:3]}")
        if lost:
            raise RuntimeError(f"lost_reads {len(lost)} during the crash: {lost[:5]}")
        if "healed" not in marks:
            raise RuntimeError(f"replication not back at target {fc['heal_limit_s']} s after "
                               f"the crash: {marks}, topology {topo_summary(cluster.topology())}")
        out["kill"] = stage_summary(gets, puts, len(errors) + len(wr_errors))
        out["kill"].update(lost_reads=0, reader_errors=len(errors), writer_errors=len(wr_errors),
                           crash_to_s=marks, removals=removals[:], keys_moved=sum(
                               r["moved_keys"] for r in removals),
                           topology=topo_summary(cluster.topology()),
                           readers_left_unread=len(reader_boxes))
        stages["kill_s"] = time.perf_counter() - t0
        log(fmt_stage("(b) kill node 1", out["kill"]) + f"; lost_reads 0; crash to dead "
            f"{marks.get('dead', float('nan')):.3f} s, to the failover (removal done) "
            f"{marks['failover']:.3f} s (started {marks.get('failover_started', float('nan')):.3f}"
            f" s), to replication back at target {marks['healed']:.3f} s; "
            f"{out['kill']['keys_moved']} keys moved; topology {out['kill']['topology']}")

        # (c) a blip of node 0, shorter than the failover's debounce
        t0 = time.perf_counter()
        gets, puts, errors = [], [], []
        stop_c = threading.Event()
        log_before = len(sup.log)

        def blip():
            th = threading.Thread(target=writer, args=(np.random.default_rng(3001), stop_c,
                                                       errors, puts))
            th.start()
            res = {}
            victim = fac.built[0]
            restarted = threading.Event()
            watch_sample = sup.watch.sample

            def sample():
                # the node comes back within the supervisor's tick that
                # first samples it dead, so the blip is one tick long
                # whatever the host's speed: shorter than the debounce
                snap = watch_sample()
                if not restarted.is_set() and snap["health"][:1] == ["dead"]:
                    res["state_reached"] = "dead"
                    victim.restart()
                    res["crashed_s"] = time.perf_counter() - t_c
                    restarted.set()
                return snap

            sup.watch.sample = sample
            try:
                time.sleep(0.3)
                t_c = time.perf_counter()
                victim.crash()
                if not restarted.wait(fc["blip_max_s"]):
                    sup.watch.sample = watch_sample
                    if not restarted.is_set():
                        res["state_reached"] = cluster.topology()["health"][0]
                        victim.restart()
                        res["crashed_s"] = time.perf_counter() - t_c
                peak = 0
                while time.perf_counter() - t_c < fc["heal_limit_s"]:
                    topo = cluster.topology()
                    peak = max(peak, topo["repair_pending"])
                    if topo["health"] == ["alive"] * topo["n_nodes"] and \
                            topo["repair_pending"] == 0 and time.perf_counter() - t_c > 0.5:
                        break
                    time.sleep(0.005)
                res["repair_peak"] = peak
                res["healed_s"] = time.perf_counter() - t_c
            finally:
                sup.watch.sample = watch_sample
                stop_c.set()
                th.join(timeout=120)
            return res

        blip_res, _ = drive(counts, dev, blip)
        if bad:
            raise RuntimeError(f"(c): {bad[:3]}")
        topo = cluster.topology()
        actions = [a["action"] for a in sup.log[log_before:]]
        if topo["n_nodes"] != fc["nodes"] - 1 or "failover" in actions:
            raise RuntimeError(f"the blip failed a node over: {topo_summary(topo)}, {actions}")
        if topo["repair_pending"] != 0 or topo["health"] != ["alive"] * topo["n_nodes"]:
            raise RuntimeError(f"repair_pending {topo['repair_pending']}, health "
                               f"{topo['health']} after the blip")
        out["blip"] = stage_summary(gets, puts, len(errors))
        out["blip"].update(blip_res, supervisor_actions=actions)
        stages["blip_s"] = time.perf_counter() - t0
        log(fmt_stage("(c) blip of node 0", out["blip"]) + f"; node 0 down "
            f"{blip_res['crashed_s']:.3f} s (reached {blip_res['state_reached']!r}), repair "
            f"queue peak {blip_res['repair_peak']}, healed {blip_res['healed_s']:.3f} s after the "
            f"crash; supervisor {actions}")

        # stage (a)'s and (b)'s answers against the plain gather of the first
        # store (its rows are current: every write so far went through it)
        packed = store.peek(0)
        for lo, hi in read_boxes:
            if not np.array_equal(plain_cutout(packed, grid, lo, hi, dev).cpu().numpy(),
                                  oracle.box(lo, hi)):
                raise RuntimeError(f"GET {lo}: the plain gather differs from the oracle")
        del packed

        # (d) after: a fresh device store over the healed cluster
        t0 = time.perf_counter()
        store2 = DeviceCuboidStore(spec, device=dev, backing=cluster)
        service.add_dataset("em2", store2)
        tiles = sd.tiling(grid.volume_shape, fc["tile"])
        tiles = [tiles[i] for i in sorted(np.random.default_rng(27).permutation(
            len(tiles))[:fc["reads"]])]
        gets, warm, puts, errors = [], [], [], []

        def after():
            for lo, hi in tiles:
                if not get_checked(url, "em2", lo, hi, oracle, errors, gets, "cold GET (d)"):
                    raise RuntimeError(f"cold GET (d) {lo}: {errors[-1]}")
                want = oracle.box(lo, hi)
                if not np.array_equal(plain_cutout(store2.peek(0), grid, lo, hi, dev)
                                      .cpu().numpy(), want):
                    raise RuntimeError(f"cold GET (d) {lo}: the plain gather differs")
            for lo, hi in tiles:
                if not get_checked(url, "em2", lo, hi, oracle, errors, warm, "warm GET (d)"):
                    raise RuntimeError(f"warm GET (d) {lo}: {errors[-1]}")
            for _ in range(fc["writes"]):
                lo, hi = random_box(rng, fc["volume"], wb)
                data = rng.integers(1, 256, size=wb, dtype=np.uint8)
                put_until_acked(url, "em2", lo, hi, data, oracle, errors, puts)

        drive(counts, dev, after)
        out["after"] = stage_summary(gets, puts, len(errors))
        out["after"].update(warm_gets=len(warm), warm_p50_ms=pcts(warm)[0],
                            warm_p99_ms=pcts(warm)[1])
        stages["after_s"] = time.perf_counter() - t0
        log(fmt_stage("(d) after, a fresh store", out["after"]) +
            f"; warm p50 {out['after']['warm_p50_ms']:.3f} / p99 "
            f"{out['after']['warm_p99_ms']:.3f} ms")

        # the gates after the heal: every acknowledged PUT over HTTP, and
        # the whole image from a fresh device store
        t0 = time.perf_counter()
        if http("POST", url + "/flush")[0] != 200:
            raise RuntimeError("POST /flush after the stages failed")
        readback, rb_err = [], []

        def read_back():
            for lo, hi in oracle.acked:
                if not get_checked(url, "em2", lo, hi, oracle, rb_err, readback, "read-back"):
                    raise RuntimeError(f"acknowledged PUT {lo} not read back: {rb_err[-1]}")
            fresh_store = DeviceCuboidStore(spec, device=dev, backing=cluster)
            step = fc["slab"]
            for x0 in range(0, fc["volume"][0], step):
                lo, hi = (x0, 0, 0), (min(x0 + step, fc["volume"][0]),) + tuple(fc["volume"][1:])
                got = cut.cutout(fresh_store, 0, lo, hi).cpu().numpy()
                if not np.array_equal(got, oracle.box(lo, hi)):
                    raise RuntimeError(f"a fresh store over the healed cluster reads slab {x0} "
                                       f"otherwise")

        drive(counts, dev, read_back)
        out["verify"] = dict(plain_checked=len(read_boxes), acked_puts=len(oracle.acked),
                             s=time.perf_counter() - t0)
        stages["verify_s"] = out["verify"]["s"]
        out["plans"] = {i: n.plan.counters() for i, n in fac.built.items()}
        out["supervisor_log"] = [{k: v for k, v in a.items() if k != "keys_per_node"}
                                 for a in sup.log]
        out["rereplications"] = rereplications
        log(f"after the heal: {len(read_boxes)} GETs equal to the plain gather, all "
            f"{len(oracle.acked)} acknowledged PUTs read back over HTTP, a fresh device store "
            f"read the whole image bit-equal ({out['verify']['s']:.2f} s)")
        log(f"supervisor log: {[(a['action'], a.get('node')) for a in sup.log]}")
        log(f"plans' counters: {out['plans']}")
    finally:
        sup.stop()
        door.close()
        cluster.close()
    out["stages"] = stages
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 25 stages (s): {stages}")
    report["faults"] = out
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# -------------------------------------------------------- serving path ----

def serving_model(sc, dev):
    """The path's arch (full width, or the smoke widths) with seeded weights."""
    cfg = get_smoke_config(sc["arch"]) if sc["smoke"] else get_config(sc["arch"])
    gen = torch.Generator(device=dev).manual_seed(12)
    return cfg, build_model(cfg, device=dev, generator=gen)


def make_requests(sc, vocab):
    rng = np.random.default_rng(48)
    lo, hi = sc["plen"]
    return [Request(rid, rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist(),
                    sc["max_new"]) for rid in range(sc["requests"])]


def serving_path(sc, dev, cfg, model, report):
    """Batched prefill + greedy decode, then continuous batching (where the
    path has slots), through the serving entry points.  One run each."""
    B, P, steps = sc["batch"], sc["prompt"], sc["steps"]
    gen = torch.Generator(device=dev).manual_seed(13)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev,
                            dtype=torch.int32)
    prefill, step = make_prefill_step(model, cfg), make_serve_step(model, cfg)

    def first_token():
        lg, cache = prefill(prompts, cache_len=sc.get("cache", P + steps))
        return torch.argmax(lg[:, -1:], dim=-1).to(torch.int32), cache

    (nxt, cache), t_prefill = timed(dev, first_token)

    def decode():
        tok, c, out = nxt, cache, []
        for i in range(steps):
            tok, _, c = step(c, tok, P + i)
            out.append(tok)
        return torch.cat(out, 1)

    generated, t_decode = timed(dev, decode)
    if generated.shape != (B, steps):
        raise RuntimeError("the serving path returned the wrong number of tokens")
    if not (0 <= int(generated.min()) and int(generated.max()) < cfg.vocab):
        raise RuntimeError("the serving path generated ids outside the vocabulary")
    report[sc["key"]] = out = dict(
        arch=cfg.name, batch=B, prompt=P, decode_steps=steps, time_to_first_token_s=t_prefill,
        prefill_tokens_per_s=B * P / t_prefill, decode_s=t_decode,
        decode_tokens_per_s=B * steps / t_decode)
    line = (f"{cfg.name} serving (one run each): prefill {B} x {P} tokens {t_prefill:.4f} s "
            f"(time to first token; {B * P / t_prefill:.6g} tokens/s), {steps} decode "
            f"steps {t_decode:.4f} s ({B * steps / t_decode:.6g} tokens/s)")
    if "slots" in sc:
        eng = ContinuousBatcher(model, cfg, n_slots=sc["slots"],
                                cache_len=sc["plen"][1] + sc["max_new"], device=dev)
        for req in make_requests(sc, cfg.vocab):
            eng.submit(req)
        done, t_cb = timed(dev, eng.run)
        n_gen = sum(len(v) for v in done.values())
        if len(done) != sc["requests"] or any(len(v) != sc["max_new"]
                                              for v in done.values()):
            raise RuntimeError("the batcher returned the wrong number of tokens")
        out.update(batcher_s=t_cb, batcher_generated_tokens=n_gen,
                   batcher_tokens_per_s=n_gen / t_cb, batcher_occupancy=eng.occupancy,
                   batcher_ticks=eng.ticks)
        line += (f"; batcher {sc['requests']} requests over {sc['slots']} slots "
                 f"{t_cb:.4f} s, {n_gen / t_cb:.6g} generated tokens/s, occupancy "
                 f"{eng.occupancy:.4f}")
    log(line)
    return prompts, generated, cache


def serving_profile(sc, dev, cfg, model, prompts, cache, generated, report,
                    n_steps=8):
    """The batched prefill and decode steps under the profiler."""
    step = make_serve_step(model, cfg)
    P = sc["prompt"]

    def decode():
        tok, c = generated[:, -1:], cache
        for i in range(n_steps):  # rewrites the last positions, in range
            tok, _, c = step(c, tok, P + sc["steps"] - n_steps + i)
        return tok

    _, prof = profile_window(dev, decode)
    prof["device_ops_per_step"] = prof["device_ops"] / n_steps
    report[sc["key"] + "_profile"] = dict(decode_steps=n_steps, decode=prof)
    log_profile(f"{cfg.name}: {n_steps} decode steps at batch {sc['batch']} "
                f"({prof['device_ops_per_step']:.0f} device ops per step)", prof)
    _, prof = profile_window(dev, lambda: make_prefill_step(model, cfg)(prompts)[0])
    report[sc["key"] + "_profile"]["prefill"] = prof
    log_profile(f"{cfg.name}: a prefill of {tuple(prompts.shape)} tokens", prof)


def published_ssm_init(tree, seed):
    """A_log and dt_bias of an ssm parameter tree by Mamba-2's published
    init: A in -[1, 16], dt log-uniform in [1e-3, 1e-1] through dt_bias =
    softplus^-1(dt).  (The repo's init, zeros, gives A = -1 and dt ~ 0.7,
    under which no state outlives a chunk.)"""
    rng = np.random.default_rng(seed)
    shape = np.shape(tree["A_log"])
    tree["A_log"] = np.log(rng.uniform(1, 16, size=shape)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=shape))
    tree["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    return tree


def serving_small_vs_cpu(dev, report, arch="smollm-135m"):
    """A 2-layer fp32 model at the smoke widths: the same greedy tokens on
    the card and on the CPU, batched and through the batcher."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    tree = lm_params_to_numpy(cpu)
    if cfg.family == "ssm":
        published_ssm_init(tree["blocks"]["ssm"], seed=17)
        cpu = lm_params_from_numpy(cfg, tree, "cpu")
    card = lm_params_from_numpy(cfg, tree, dev)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(4, 24)).astype(np.int32))
    served, routes = {}, {}
    for model in (card, cpu):
        routes[model.device.type] = calls = []
        with (moe_mod.observe(routing_of(calls)) if cfg.family == "moe"
              else contextlib.nullcontext()):
            lg, cache = make_prefill_step(model, cfg)(tok.to(model.device), cache_len=40)
            nxt = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
            step, out = make_serve_step(model, cfg), [nxt.cpu()]
            for i in range(15):
                nxt, _, cache = step(cache, nxt, 24 + i)
                out.append(nxt.cpu())
            eng = ContinuousBatcher(model, cfg, n_slots=2, cache_len=40, device=model.device)
            for rid, n in enumerate((5, 17, 3, 24)):
                eng.submit(Request(rid, tok[rid % 4, :n].tolist(), 12))
            served[model.device.type] = (torch.cat(out, 1), eng.run())
    if cfg.family == "moe":
        report[f"{arch}_routing"] = router_flips(f"{arch} smoke model", routes[dev.type],
                                                 routes["cpu"], cfg.top_k)
    if not torch.equal(served[dev.type][0], served["cpu"][0]):
        raise RuntimeError(f"{arch} smoke model: batched tokens differ between card and CPU")
    if served[dev.type][1] != served["cpu"][1]:
        raise RuntimeError(f"{arch} smoke model: batcher tokens differ between card and CPU")
    report[f"{arch}_small_vs_cpu"] = dict(batched_tokens=int(served["cpu"][0].numel()),
                                          batcher_requests=len(served["cpu"][1]))
    log(f"{arch} smoke model: {served['cpu'][0].numel()} batched tokens and "
        f"{len(served['cpu'][1])} batcher requests, card == CPU")


BF16_TOL = dict(atol=2e-2, rtol=2e-2)
FP32_TOL = dict(atol=2e-5, rtol=2e-5)
# At full width the attention outputs are small (the seeded weights give v
# of std ~0.5 and a near-uniform softmax, so |out| ~ 0.5 / sqrt(keys), about
# 0.01 at 2,048 keys): the bf16 check's absolute term is a share of the
# outputs' mean magnitude, not the 2e-2 of the randn cases.  Rounding p
# against a running max, as the kernels do, moves the outputs by a few
# percent of that mean at most (rows of few keys); dropping one of six
# decode splits moves most of them by far more.
FULL_WIDTH_BF16_ATOL_SHARE = 5e-2


def sliced(plain, n):
    """``plain`` over the batch in slices of ``n`` sequences (the plain
    attention's scores take O(Sq * Skv) memory per sequence), concatenated."""
    return lambda *args: torch.cat([plain(*(a[i:i + n] for a in args))
                                    for i in range(0, args[0].shape[0], n)])


def attention_pair_checks(label, cases, errs, checks):
    """Each case (name, kernel name, kernel, plain, args) in bf16 (atol a
    share of the outputs' mean magnitude) and with the tensors taken to
    fp32 (the fp32 tolerance)."""
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        for phase, kname, kernel, plain, args in cases:
            args = [t.to(dt) for t in args]
            got, want = kernel(*args), plain(*args)
            mean_abs = float(want.float().abs().mean())
            tol = (dict(atol=FULL_WIDTH_BF16_ATOL_SHARE * mean_abs, rtol=BF16_TOL["rtol"])
                   if dt == torch.bfloat16 else FP32_TOL)
            err = check_close(f"{label} {phase} {tag}", got, want, tol, errs[kname])
            checks[f"{phase}_{tag}"] = dict(max_abs_err=err, mean_abs_out=mean_abs, **tol)
            log(f"{label} {phase}, {tag} [{kname}: {body(kname, dt)}]: max |kernel - plain| "
                f"{err:.3g}, mean |out| {mean_abs:.3g}, within atol {tol['atol']:.3g} rtol "
                f"{tol['rtol']:.3g}")
            del got, want, args


def layer0_attention_vs_plain(sc, dev, cfg, model, prompts, cache, report, errs, slice_n=8):
    """Layer 0's attention at full width and at the path's own shapes:
    kernel vs plain version on the same card tensors, at the prefill of
    the whole batch and at one decode step over the whole cache with mixed
    lengths, at the plan's split count and at 8 splits (the in-launch merge
    of flash_decode, whether or not the plan splits this shape): in bf16
    with an absolute tolerance scaled to the outputs, and again with the
    same tensors taken to fp32 at the fp32 tolerance."""
    p = model.blocks[0]
    n = prompts.shape[0]
    x = rms_norm(model.embed_tokens(prompts), p.ln1, cfg.norm_eps)
    positions = torch.arange(prompts.shape[1], device=dev).expand(n, -1)
    q, k, v = qkv(p.attn, cfg, x, positions)
    del x
    scale = cfg.head_dim ** -0.5

    B, S = cache["blocks"]["k"].shape[1:3]
    gen = torch.Generator(device=dev).manual_seed(14)
    lens = torch.randint(S - sc["steps"], S + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=dev)
    xd = rms_norm(model.embed_tokens(tok), p.ln1, cfg.norm_eps)
    qd = rotary((xd @ p.attn.w_q).reshape(B, 1, cfg.n_heads, cfg.head_dim),
                (lens - 1).long()[:, None], cfg.rope_theta)
    ck, cv = cache["blocks"]["k"][0], cache["blocks"]["v"][0]
    splits = fd_ops.plan_for(qd, ck).nsplit
    most = fd_ops.MAX_SPLITS

    cases = (
        ("prefill", "flash_attention",
         lambda a, b, c: fa_ops.flash_attention(a, b, c, causal=True, scale=scale),
         sliced(lambda a, b, c: flash_attention_ref(a, b, c, causal=True, scale=scale),
                slice_n),
         (q, k, v)),
        ("decode", "flash_decode",
         lambda a, b, c: fd_ops.flash_decode(a, b, c, lens, scale=scale),
         lambda a, b, c: flash_decode_ref(a, b, c, lens, scale=scale),
         (qd, ck, cv)),
        (f"decode_{most}_splits", "flash_decode",
         lambda a, b, c: fd_ops.flash_decode_cuda(a, b, c, lens, scale=scale, nsplit=most),
         lambda a, b, c: flash_decode_ref(a, b, c, lens, scale=scale),
         (qd, ck, cv)))
    checks = {}
    attention_pair_checks(f"{cfg.name} layer-0 attention, full width,", cases, errs, checks)
    report[sc["key"]]["layer0_attention"] = dict(
        prefill_shape=list(q.shape), decode_cache=list(ck.shape),
        decode_lens=[int(lens.min()), int(lens.max())], decode_splits=splits, checks=checks)
    log(f"{cfg.name} layer-0 attention at full width: prefill {n} x {prompts.shape[1]} "
        f"({cfg.n_heads} query heads over {cfg.n_kv_heads} kv heads), decode over "
        f"{B} x {S} cached positions, lens {int(lens.min())}-{int(lens.max())}, "
        f"{splits} splits (the plan) and {most}")


def batcher_decode_checks(sc, dev, cfg, report, errs):
    """`flash_decode` at the batcher's shape of the path (its slots over its
    cache, the model's heads) against its plain version, with per-slot
    lengths from 1 (an idle slot) to the whole cache, fp32 and bf16 (the
    tolerances of the small cases)."""
    B, S = sc["slots"], sc["plen"][1] + sc["max_new"]
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(23)
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    lens[:2] = torch.tensor([1, S], dtype=torch.int32, device=dev)
    splits, err = {}, {}
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q, kc, vc = (torch.randn(s, generator=gen, device=dev).to(dt)
                     for s in ((B, 1, H, D), (B, S, K, D), (B, S, K, D)))
        splits[str(dt)[6:]] = fd_ops.plan_for(q, kc).nsplit
        got = fd_ops.flash_decode(q, kc, vc, lens, scale=D ** -0.5)
        want = flash_decode_ref(q, kc, vc, lens, scale=D ** -0.5)
        err[str(dt)[6:]] = check_close(f"{cfg.name} batcher flash_decode {dt} "
                                       f"{(B, S, H, K, D)}", got, want, tol, errs)
    report[sc["key"]]["batcher_decode_check"] = dict(shape=[B, S, H, K, D], splits=splits,
                                                     max_abs_err=err)
    log(f"{cfg.name} batcher decode attention ({B} slots x {S} cached positions, {H} "
        f"query heads over {K} kv heads, splits {splits}) [flash_decode: "
        f"{body('flash_decode', torch.bfloat16)}]: max |kernel - plain| {err}")


def check_close(label, got, want, tol, errs):
    torch.cuda.synchronize(got.device)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{label}: {tuple(got.shape)} {got.dtype} vs "
                           f"{tuple(want.shape)} {want.dtype}")
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{label}: non-finite kernel output")
    try:
        torch.testing.assert_close(got.float(), want.float(), **tol)
    except AssertionError as e:
        raise RuntimeError(f"{label}: kernel != plain\n{e}") from None
    err = float((got.float() - want.float()).abs().max())
    errs.append(err)
    return err


# ------------------------------------------------------ attention kernels ----

ATTN_SHAPES = [  # (B, Sq, Skv, H, K, D): tests/test_kernels.py:37-44
    (1, 64, 64, 4, 4, 64), (2, 128, 128, 8, 2, 64), (1, 96, 96, 4, 1, 128),
    (1, 32, 128, 4, 2, 64), (2, 64, 64, 4, 4, 256)]
FD_SHAPES = [  # (B, S, H, K, D, cache_len): tests/test_kernels.py:262-267
    (2, 128, 8, 2, 64, 128), (1, 256, 4, 4, 64, 100), (2, 96, 4, 1, 128, 50),
    (1, 64, 8, 8, 64, 1),
    (4, 2176, 9, 3, 64, 2100),  # smollm's heads: the kv axis split, then merged
    (2, 256, 10, 1, 64, 200), (1, 256, 16, 1, 128, 256),  # G 10 and 16
    (2, 2176, 16, 1, 64, 2100)]  # G 16 over a split kv axis


def attention_kernel_checks(dev, errs):
    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    n = split_cases = 0
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for B, Sq, Skv, H, K, D in ATTN_SHAPES:
            q, k, v = randn((B, Sq, H, D), dt), randn((B, Skv, K, D), dt), randn((B, Skv, K, D), dt)
            for causal, window in ((True, None), (False, None), (True, 48)):
                got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
                want = flash_attention_ref(q, k, v, causal=causal, scale=D ** -0.5,
                                           window=window)
                check_close(f"flash_attention {dt} {(B, Sq, Skv, H, K, D)} causal={causal} "
                            f"window={window}", got, want, tol, errs["flash_attention"])
                n += 1
        # tests/test_kernels.py:283: per-sequence lengths, then the same over splits
        for B, S, H, K, D, clen in FD_SHAPES + [(3, 64, 4, 2, 64, (5, 33, 64)),
                                                (3, 1024, 9, 3, 64, (300, 777, 1024))]:
            q, kc, vc = randn((B, 1, H, D), dt), randn((B, S, K, D), dt), randn((B, S, K, D), dt)
            lens = (torch.tensor(clen, dtype=torch.int32, device=dev)
                    if isinstance(clen, tuple) else clen)
            got = fd_ops.flash_decode(q, kc, vc, lens, scale=D ** -0.5)
            want = flash_decode_ref(q, kc, vc, lens, scale=D ** -0.5)
            check_close(f"flash_decode {dt} {(B, S, H, K, D)} lens={clen}", got, want, tol,
                        errs["flash_decode"])
            n += 1
            split_cases += fd_ops.plan_for(q, kc).nsplit > 1
    if split_cases < 4:
        raise RuntimeError("the flash_decode checks do not reach the split path in "
                           "both dtypes")
    log(f"flash_attention ({body('flash_attention', torch.bfloat16)} and "
        f"{body('flash_attention', torch.float32)}) / flash_decode "
        f"({body('flash_decode', torch.bfloat16)}): {n} small cases within tolerance of plain "
        f"({split_cases} of them over split kv axes)")


def attention_timings(sc, dev, cfg, name, report):
    """Each attention kernel at the serving path's shapes: kernel, plain
    version and one PyTorch call for the same function, CUDA events."""
    import torch.nn.functional as F

    B, S = sc["batch"], sc["prompt"]
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(16)
    bf = torch.bfloat16
    flops, hbm = h100_peaks(name).bf16_flops, h100_peaks(name).hbm_bytes_per_s
    scale = D ** -0.5
    out = {}

    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(bf)
    k = torch.randn((B, S, K, D), generator=gen, device=dev).to(bf)
    v = torch.randn((B, S, K, D), generator=gen, device=dev).to(bf)
    pairs = S * (S + 1) // 2  # live (query, key) pairs of a causal square
    ops_ = 4 * B * H * D * pairs
    bytes_ = 2 * (2 * q.numel() + k.numel() + v.numel())
    ms = event_times(dev, lambda i=0: fa_ops.flash_attention(q, k, v, causal=True, scale=scale))
    plain = event_times(dev, lambda i=0: flash_attention_ref(q, k, v, causal=True, scale=scale))
    lib = event_times(dev, lambda i=0: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
        scale=scale, enable_gqa=True))
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    out["flash_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                  body=body("flash_attention", bf),
                                  bound_by="operations" if ops_ / flops > bytes_ / hbm
                                  else "bytes", operations=ops_, bytes=bytes_,
                                  shape=[B, S, S, H, K, D], tflops=ops_ / ms / 1e9)
    del q, k, v
    torch.cuda.empty_cache()

    Sc = S + sc["steps"]
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(bf)
    kc = torch.randn((B, Sc, K, D), generator=gen, device=dev).to(bf)
    vc = torch.randn((B, Sc, K, D), generator=gen, device=dev).to(bf)
    lens = torch.randint(S, Sc, (B,), generator=gen, device=dev, dtype=torch.int32)
    live = int(lens.sum())
    bytes_ = 2 * (2 * live * K * D + 2 * q.numel()) + 4 * B
    ops_ = 4 * H * D * live
    mask = (torch.arange(Sc, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    ms = event_times(dev, lambda i=0: fd_ops.flash_decode(q, kc, vc, lens, scale=scale))
    plain = event_times(dev, lambda i=0: flash_decode_ref(q, kc, vc, lens, scale=scale))
    lib = event_times(dev, lambda i=0: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
        scale=scale, enable_gqa=True))
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    out["flash_decode"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                               bound_by="bytes" if bytes_ / hbm >= ops_ / flops
                               else "operations", operations=ops_, bytes=bytes_,
                               shape=[B, Sc, H, K, D], lens=[int(lens.min()), int(lens.max())],
                               gbps=bytes_ / ms / 1e6,
                               splits=fd_ops.plan_for(q, kc).nsplit,
                               body=body("flash_decode", bf))
    for kname, t in out.items():
        log(f"{kname} {t['shape']} [{body(kname, bf)}]: {t['ms']:.4f} ms (plain "
            f"{t['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention {t['library_ms']:.4f} ms), bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} = {100 * t['bound_ms'] / t['ms']:.2f}% "
            f"of the card's peak")
    report["attention_timings"] = out
    return out


# ------------------------------------------------------------ ssd scan ----

SSD_REL = 1e-4
# The scan's outputs are fp32 on both sides, from the same inputs (bf16
# ones too), so they are held at an fp32-level tolerance: rtol 1e-4 and an
# atol of 1e-4 of the largest |output|.  The two cumsums round differently;
# with the published ranges |cum| reaches ~400 within a chunk, where an
# fp32 ulp is 3.05e-5, and a few such ulps in exp(cum_i - cum_j) are ~1e-4
# of a term.  (A bf16 ulp is 3.9e-3.)
SSD_SHAPES = [  # (B, S, H, P, N, chunk): tests/test_kernels.py:171-177, then
    (1, 64, 2, 32, 32, 32), (2, 128, 4, 64, 64, 32), (1, 96, 2, 32, 64, 32),
    (1, 80, 3, 16, 32, 32), (2, 64, 2, 64, 128, 64),
    (2, 100, 3, 8, 16, 256),     # Q = S = 100, not a power of two; P = 8
    (2, 300, 3, 16, 16, 48),     # Q = 48, a ragged last chunk of 12
    (2, 77, 3, 24, 40, 24),      # P, N multiples of 8 only
    (2, 1000, 4, 64, 128, 256),  # mamba2-370m's heads: Q 256, N 128, P 64
    # one case for each instance of the bf16 body (P, N each up to 64 or
    # 128, exactly so or not) that the shapes above leave out
    (1, 300, 2, 128, 64, 256), (1, 300, 2, 96, 48, 256),
    (1, 300, 2, 96, 128, 256), (1, 300, 2, 48, 96, 256)]


def ssd_tol(want):
    return dict(rtol=SSD_REL, atol=SSD_REL * float(want.abs().max()))


def ssd_draw(gen, shape, dtype, dev, published):
    """x, dt, A, B, C: the JAX tests' draws, or the published ranges."""
    B, S, H, P, N = shape[:5]
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    Bm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    Cm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    if published:
        A = -(1 + 15 * torch.rand((H,), generator=gen, device=dev))
        dt = torch.exp(np.log(1e-3) + np.log(100.0) * torch.rand((B, S, H), generator=gen,
                                                                 device=dev))
    else:
        dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev))
        A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device=dev))
    return x, dt, A, Bm, Cm


def ssd_kernel_checks(dev, errs):
    """The kernel against its plain version over the test shapes, odd and
    ragged chunks, fp32 and bf16, the JAX tests' draws and the published
    ranges."""
    gen = torch.Generator(device=dev).manual_seed(19)
    n = 0
    for shape in SSD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for published in (False, True):
                args = ssd_draw(gen, shape, dt, dev, published)
                got = ssd_ops.ssd_scan(*args, chunk=shape[-1])
                wants = [("plain", ssd_scan_ref(*args, chunk=shape[-1]))]
                if dt == torch.bfloat16:  # and the bf16 body's roundings, emulated
                    wants.append(("split emulation",
                                  ssd_scan_split_ref(*args, chunk=shape[-1])))
                for label, want in wants:
                    for name, g, w in zip(("y", "state"), got, want):
                        check_close(f"ssd_scan {name} {dt} {shape} "
                                    f"{'published' if published else 'jax'} draws vs "
                                    f"{label}", g, w, ssd_tol(w),
                                    errs if label == "plain" else [])
                n += 1
    log(f"ssd_scan ({body('ssd_scan', torch.bfloat16)} and "
        f"{body('ssd_scan', torch.float32)}): {n} small cases within rtol {SSD_REL} and "
        f"{SSD_REL} of max |out| of plain (bf16 also of the split emulation)")


def layer0_ssm_vs_plain(sc, dev, cfg, model, prompts, report, errs):
    """Layer 0's mixer at full width with A and dt by Mamba-2's published
    init: the scan through the kernel and through the plain version on the
    same card tensors, then the mixer's output from each; in bf16, and with
    the tensors taken to fp32.  Prints how much weight the carried state
    has: the median per-chunk decay exp(sum a), and the share of |y| that
    comes across chunk boundaries."""
    blk = model.blocks[0]
    seeded_dt = F.softplus(blk.ssm.dt_bias)  # dt at x . w_dt = 0
    tree = dict(blk.ssm)
    pub = published_ssm_init({k: tree[k].cpu().numpy() for k in ("A_log", "dt_bias")}, 18)
    tree.update({k: torch.from_numpy(v).to(dev) for k, v in pub.items()})
    n = min(8, prompts.shape[0])  # a slice of the batch bounds the plain version's memory
    x = rms_norm(model.embed_tokens(prompts[:n]), blk.ln, cfg.norm_eps)
    S = x.shape[1]
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise RuntimeError("the layer-0 check wants whole chunks")
    checks = {}
    for dt in (torch.bfloat16, torch.float32):  # fp32 last: its tensors are reused below
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        p = SimpleNamespace(**{k: v.to(dt) if v.dtype == torch.bfloat16 else v
                               for k, v in tree.items()})
        z, _, xs, dtv, A, Bm, Cm = ssm_inputs(p, cfg, x.to(dt))
        got = ssd_ops.ssd_scan(xs, dtv, A, Bm, Cm, chunk=Q)
        want = ssd_scan_ref(xs, dtv, A, Bm, Cm, chunk=Q)
        for name, g, w in zip(("y", "state"), got, want):
            tol = ssd_tol(w)
            err = check_close(f"layer-0 scan {name} {tag}", g, w, tol, errs)
            checks[f"scan_{name}_{tag}"] = dict(max_abs_err=err, max_abs_out=float(w.abs().max()),
                                                **tol)
        out_k, out_p = ssm_output(p, cfg, z, xs, got[0]), ssm_output(p, cfg, z, xs, want[0])
        mean_abs = float(out_p.float().abs().mean())
        # bf16: as layer 0's attention (an atol of 5% of the mean |out|, the
        # rtol of 2e-2); the scan's y agrees to ~1e-5, so at most a bf16
        # rounding of the mixer's inputs flips.  fp32: the scan's tolerance.
        tol = (dict(atol=FULL_WIDTH_BF16_ATOL_SHARE * mean_abs, rtol=BF16_TOL["rtol"])
               if dt == torch.bfloat16 else ssd_tol(out_p))
        err = check_close(f"layer-0 mixer output {tag}", out_k, out_p, tol, [])
        checks[f"mixer_{tag}"] = dict(max_abs_err=err, mean_abs_out=mean_abs, **tol)
        log(f"layer-0 ssm {tag}, full width: max |kernel - plain| y "
            f"{checks[f'scan_y_{tag}']['max_abs_err']:.3g} (max |y| "
            f"{checks[f'scan_y_{tag}']['max_abs_out']:.3g}), state "
            f"{checks[f'scan_state_{tag}']['max_abs_err']:.3g}, mixer output {err:.3g} "
            f"(mean |out| {mean_abs:.3g})")
    # the carried state's weight, on the fp32 pass's tensors: y against the
    # same chunks scanned each from a zero state
    nc = S // Q
    decay = torch.exp((dtv * A).reshape(n, nc, Q, -1).sum(dim=2))
    seeded = torch.exp(-Q * seeded_dt.float().mean())
    alone = ssd_scan_ref(*(t.reshape((n * nc, Q) + t.shape[2:]) for t in (xs, dtv)), A,
                         *(t.reshape(n * nc, Q, -1) for t in (Bm, Cm)), chunk=Q)[0]
    carried = float((want[0] - alone.reshape(want[0].shape)).norm() / want[0].norm())
    report["layer0_ssm"] = dict(
        batch=n, prompt=S, chunk=Q, checks=checks,
        median_chunk_decay=float(decay.median()),
        chunk_decay_share_above_1pct=float((decay > 1e-2).float().mean()),
        carried_share_of_y=carried, seeded_init_chunk_decay=float(seeded))
    log(f"layer-0 ssm with the published A and dt: median per-chunk decay exp(sum a) "
        f"{float(decay.median()):.4g} ({100 * float((decay > 1e-2).float().mean()):.1f}% of "
        f"(sequence, chunk, head) above 1e-2); the carried state is "
        f"{100 * carried:.2f}% of |y| (seeded init: per-chunk decay ~{float(seeded):.3g})")


def ssd_timing(sc, dev, cfg, name, report):
    """`ssd_scan` at the prefill's shape (x, B and C sliced out of one bf16
    projection, published A and dt): kernel and plain version by CUDA
    events, beside the bound.  No single PyTorch call computes this."""
    B, S = sc["batch"], sc["prompt"]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    gen = torch.Generator(device=dev).manual_seed(20)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen, device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    _, dt, A, _, _ = ssd_draw(gen, (B, S, H, 8, 8), torch.bfloat16, dev, True)
    ms = event_times(dev, lambda i=0: ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q))
    plain = event_times(dev, lambda i=0: ssd_scan_ref(x, dt, A, Bm, Cm, chunk=Q))
    qs = [min(Q, S - c) for c in range(0, S, Q)]
    ops_ = B * H * sum(2 * (q * (q + 1) // 2 * (N + P) + 2 * q * N * P) for q in qs)
    bytes_ = (2 * x.numel() + 4 * B * S * H * P + 2 * 2 * B * S * N + 4 * dt.numel()
              + 4 * H + 4 * B * H * P * N)
    flops, hbm = h100_peaks(name).bf16_flops, h100_peaks(name).hbm_bytes_per_s
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    sass = _bench.sass_counts(_build._target("ssd_scan"), ("HMMA", "FFMA"))
    t = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
             bound_by="operations" if ops_ / flops > bytes_ / hbm else "bytes",
             operations=ops_, bytes=bytes_, shape=[B, S, H, P, N, Q],
             tflops=ops_ / ms / 1e9, body=body("ssd_scan", x.dtype), sass=sass,
             plan=dict(zip(("smem", "blocks_per_sm", "occupancy", "warps"),
                           ssd_ops.kernel_tc_plan(P, N))))
    report["ssd_timing"] = t
    log(f"ssd_scan {t['shape']} [{t['body']}]: {ms:.4f} ms (plain {plain:.4f} ms, no "
        f"library call), {t['tflops']:.2f} TFLOP/s; bound {bound:.4f} ms by "
        f"{t['bound_by']} = {100 * bound / ms:.2f}% of the card's peak; SASS {sass}; "
        f"plan {t['plan']}")
    if sass["HMMA"] == 0:
        raise RuntimeError("ssd_scan's library holds no HMMA: the bf16 body is not on "
                           "the tensor cores")
    return t


# -------------------------------------------------------------- the MoE ----

def routing_of(calls):
    """A `moe.observe` callback that appends each dispatch's router probabilities (fp32,
    on the CPU) and expert ids to ``calls``."""
    def record(p, xt, disp):
        probs = torch.softmax(xt.float() @ p.w_router.float(), dim=-1)
        calls.append((probs.cpu(), disp.expert_ids.cpu()))
    return record


def router_flips(arch, card_calls, cpu_calls, k, between="card and CPU"):
    """Top-k picks that differ between card and CPU (or the two runs named
    by ``between``), call by call, with the
    gap between the k-th and (k+1)-th router probability of each token
    (on the CPU): a near-tie that rounding can flip shows as a small gap."""
    flipped, gaps, min_gap = 0, [], float("inf")
    for (pc, ic, *_), (_, ih, *_) in zip(card_calls, cpu_calls):
        top = torch.topk(pc, k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]
        min_gap = min(min_gap, float(gap.min()))
        if ic.shape != ih.shape:
            break  # the two runs no longer serve the same tokens
        diff = (ic != ih).any(dim=-1)
        flipped += int(diff.sum())
        gaps += [float(g) for g in gap[diff]]
    out = dict(calls=len(cpu_calls), flipped_tokens=flipped, gaps_at_flips=gaps,
               min_gap=min_gap)
    log(f"{arch} routing: {len(cpu_calls)} dispatches, {flipped} tokens whose "
        f"top-{k} picks differ between {between} (gaps {gaps[:20]}); the smallest gap between "
        f"the {k}-th and {k + 1}-th router probability is {min_gap:.3g}")
    return out


def check_moe_launches(sc, cfg, report, counts):
    """One `moe_gemm` launch per layer of the prefill and of every decode
    step, the batcher's ticks included."""
    want = cfg.n_layers * (1 + sc["steps"] + report[sc["key"]]["batcher_ticks"])
    if counts["moe_gemm"] != want:
        raise RuntimeError(f"moe_gemm launched {counts['moe_gemm']} times on the "
                           f"{sc['key']} path, want {want} (one per layer and step)")


def moe_drop_shares(sc, dev, cfg, model, prompts, cache, generated, report):
    """The share of dispatched picks that found their expert full, over all
    layers of one prefill and of one decode step."""
    out, runs = {}, [("prefill", []), ("decode_step", [])]

    def drops_into(entries):
        return lambda p, xt, disp: entries.append((disp.keep.numel() - disp.keep.sum(),
                                                   disp.keep.numel()))

    with moe_mod.observe(drops_into(runs[0][1])):
        make_prefill_step(model, cfg)(prompts)
    with moe_mod.observe(drops_into(runs[1][1])):
        make_serve_step(model, cfg)(cache, generated[:, -1:], sc["prompt"] + sc["steps"] - 1)
    for label, entries in runs:
        dropped = [int(d) for d, _ in entries]
        picks = sum(n for _, n in entries)
        out[label] = dict(dropped=sum(dropped), picks=picks, share=sum(dropped) / picks,
                          max_layer_share=max(dropped) / entries[0][1])
        log(f"{cfg.name} {label}: {sum(dropped)} of {picks} dispatched picks dropped "
            f"({100 * sum(dropped) / picks:.4f}%; at most {100 * max(dropped) / entries[0][1]:.4f}% "
            f"in one layer)")
    report[sc["key"]]["drops"] = out


MOE_FP32_REL = 1e-4


def moe_tol(want):
    """fp32: rtol 1e-4 and 1e-4 of the largest |y| (sums in another order).
    bf16: as the attention checks (rtol 2e-2, an atol of 5% of the mean
    |y|): both sides round h and y to bf16 from fp32 sums, and a sum on
    the other side of a rounding boundary moves a value by one bf16 ulp."""
    if want.dtype == torch.float32:
        return dict(rtol=MOE_FP32_REL, atol=MOE_FP32_REL * float(want.abs().max()))
    return dict(rtol=BF16_TOL["rtol"],
                atol=FULL_WIDTH_BF16_ATOL_SHARE * float(want.float().abs().mean()))


def layer0_moe_vs_plain(sc, dev, cfg, model, prompts, report, errs):
    """Layer 0's MoE at full width on the prefill's tokens: one dispatch
    for the kernel and one for the plain version on the same card tensors
    (the routing must be equal), the expert GEMM through each, and the
    combined outputs; in fp32 and in bf16.  Returns the bf16 arguments of
    the GEMM, for timing at the path's own counts."""
    blk = model.blocks[0]
    x = model.embed_tokens(prompts)
    B, S, d = x.shape
    x = x + attention(blk.attn, cfg, rms_norm(x, blk.ln1, cfg.norm_eps),
                      torch.arange(S, device=dev).expand(B, S))
    xt = rms_norm(x, blk.ln2, cfg.norm_eps).reshape(B * S, d)
    del x
    checks, timing_args = {}, None
    for dt in (torch.float32, torch.bfloat16):  # bf16 last: its dispatch is timed
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        p = SimpleNamespace(**{k: v.to(dt) if v.dtype == torch.bfloat16 else v
                               for k, v in blk.moe.items()})
        dk = moe_mod.dispatch(p, cfg, xt.to(dt))
        dp = moe_mod.dispatch(p, cfg, xt.to(dt))
        for field in ("expert_ids", "keep", "slot", "counts", "grouped"):
            if not torch.equal(getattr(dk, field), getattr(dp, field)):
                raise RuntimeError(f"layer-0 MoE {tag}: two dispatches of the same tokens "
                                   f"differ in {field}")
        yk = mg_ops.moe_gemm(dk.grouped, p.w_gate, p.w_up, p.w_down, dk.counts)
        yp = moe_gemm_ref(dp.grouped, p.w_gate, p.w_up, p.w_down, dp.counts)
        tol = moe_tol(yp)
        err = check_close(f"layer-0 moe_gemm {tag}", yk, yp, tol, errs)
        ok, op = moe_mod.combine(yk, dk), moe_mod.combine(yp, dp)
        tol_out = moe_tol(op)
        err_out = check_close(f"layer-0 MoE output {tag}", ok, op, tol_out, [])
        C = dk.grouped.shape[1]
        checks[tag] = dict(max_abs_err=err, max_abs_y=float(yp.float().abs().max()),
                           mean_abs_y=float(yp.float().abs().mean()), **tol,
                           out_max_abs_err=err_out, out_tol=tol_out)
        log(f"layer-0 MoE {tag} [moe_gemm: {body('moe_gemm', dt)}], full width ({B * S} "
            f"tokens, C {C}): max |kernel - plain| "
            f"y {err:.3g} (max |y| {checks[tag]['max_abs_y']:.3g}, within atol "
            f"{tol['atol']:.3g} rtol {tol['rtol']:.3g}), combined output {err_out:.3g}")
        if dt == torch.bfloat16:
            timing_args = (dk.grouped, p.w_gate, p.w_up, p.w_down, dk.counts)
        del dk, dp, yk, yp, ok, op
        torch.cuda.empty_cache()
    counts = timing_args[-1]
    report["layer0_moe"] = dict(tokens=B * S, capacity=C, checks=checks,
                                live_rows=int(counts.clamp(0, C).sum()),
                                counts_min=int(counts.min()), counts_max=int(counts.max()))
    return timing_args


MG_SHAPES = [  # (E, C, d, f): tests/test_kernels.py:301-307, then granite's experts
    (4, 64, 32, 16), (8, 96, 64, 32), (2, 50, 32, 64), (32, 40, 64, 32),
    (3, 130, 24, 40),      # C over two 128-row tiles; d and f ragged against 64-wide boxes
    (32, 640, 1024, 512),
    (32, 10, 1024, 512),   # a decode step at batch 32
    (32, 8, 1024, 512)]    # a batcher tick over 16 slots


def moe_draw(gen, shape, dtype, dev, junk):
    """x (rows past the counts zero, or random: ``junk``), weights scaled by
    1/sqrt(fan-in) so that g, u and y are O(1), and counts in [0, C] with
    0, C and C + 7 among them."""
    E, C, d, f = shape
    x = torch.randn((E, C, d), generator=gen, device=dev)
    w = [torch.randn(s, generator=gen, device=dev) * s[1] ** -0.5
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    counts = torch.randint(0, C + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    n = min(3, E)
    counts[:n] = torch.tensor([0, C, C + 7][:n], dtype=torch.int32, device=dev)
    if not junk:
        x = x * (torch.arange(C, device=dev)[None, :] < counts[:, None])[..., None]
    return [t.to(dtype) for t in [x] + w] + [counts]


def moe_kernel_checks(dev, report, errs):
    """The kernel against its plain version over the test shapes and
    granite's width, fp32 and bf16, with the buffer zero past the counts
    and with random rows there (the kernel must mask them).  Cases where
    the two differ at all are listed in the report."""
    gen = torch.Generator(device=dev).manual_seed(22)
    n, differ = 0, []
    for shape in MG_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for junk in (False, True):
                args = moe_draw(gen, shape, dt, dev, junk)
                want = moe_gemm_ref(*args)
                got = mg_ops.moe_gemm(*args)
                label = f"moe_gemm {dt} {shape} {'junk' if junk else 'zeroed'} past the counts"
                err = check_close(label, got, want, moe_tol(want), errs)
                if err:
                    differ.append(dict(case=label, max_abs_err=err,
                                       max_abs_y=float(want.float().abs().max())))
                dead = torch.arange(shape[1], device=dev)[None, :] >= args[-1][:, None]
                if bool(got[dead].any()):
                    raise RuntimeError(f"{label}: rows past the counts are not 0")
                n += 1
    report["moe_kernel_checks"] = dict(cases=n, differ=differ)
    log(f"moe_gemm: differs from plain in {differ}")
    log(f"moe_gemm ({body('moe_gemm', torch.bfloat16)} and "
        f"{body('moe_gemm', torch.float32)}): {n} small and granite-width cases "
        f"(prefill-like, decode and batcher capacities) within tolerance of plain "
        f"(fp32 rtol {MOE_FP32_REL} and {MOE_FP32_REL} of max |y|; bf16 rtol "
        f"{BF16_TOL['rtol']} and {FULL_WIDTH_BF16_ATOL_SHARE} of mean |y|)")


def moe_timing(dev, name, report, x, wg, wu, wd, counts):
    """`moe_gemm` at the prefill's shape with layer 0's own counts, and at a
    decode step's (32 tokens routed top-8 uniformly: C 10, the bench's
    inputs): kernel and plain version by CUDA events, beside the bound and
    a library yardstick (three bf16 bmm over the whole buffer and the silu
    product: no single PyTorch call computes this function); and the
    host's time to enqueue one decode-step call (the decode path is
    host-bound)."""
    flops, hbm = h100_peaks(name).bf16_flops, h100_peaks(name).hbm_bytes_per_s
    out = {}
    for label, args in (("prefill", (x, wg, wu, wd, counts)),
                        ("decode_step", mg_bench.inputs(32, dev))):
        xa, ga, ua, da, ca = args
        E, C, d = xa.shape
        f = ga.shape[-1]
        rows = int(ca.clamp(0, C).sum())
        ms = event_times(dev, lambda i=0: mg_ops.moe_gemm(*args))
        plain = event_times(dev, lambda i=0: moe_gemm_ref(*args))
        lib = event_times(dev, lambda i=0: torch.bmm(
            F.silu(torch.bmm(xa, ga)) * torch.bmm(xa, ua), da))
        ops_ = 2 * 3 * d * f * rows
        bytes_ = xa.element_size() * (rows * d + E * C * d + 3 * E * d * f)
        bound = max(ops_ / flops, bytes_ / hbm) * 1e3
        t = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                 bound_by="operations" if ops_ / flops > bytes_ / hbm else "bytes",
                 library="3 x torch.bmm (bf16, whole buffer, no skipping) + silu product",
                 operations=ops_, bytes=bytes_, shape=[E, C, d, f], live_rows=rows,
                 tflops=ops_ / ms / 1e9, body=body("moe_gemm", xa.dtype))
        if label == "decode_step":
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(200):
                mg_ops.moe_gemm(*args)
            t["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
            sync(dev)
        out[label] = t
        log(f"moe_gemm {label} {t['shape']} ({rows} live rows) [{t['body']}]: {ms:.4f} ms "
            f"(plain {plain:.4f} ms; yardstick 3 x bmm {lib:.4f} ms), {t['tflops']:.2f} "
            f"TFLOP/s; bound {bound:.4f} ms by {t['bound_by']} = {100 * bound / ms:.2f}% of "
            f"the card's peak" + (f"; host {t['host_us_per_call']:.1f} us a call"
                                  if "host_us_per_call" in t else ""))
        del args, xa, ga, ua, da, ca
    report["moe_timing"] = out
    return out["prefill"]


MM_SHAPES = [  # (M, N, K): tests/test_kernels.py:78-80
    (256, 128, 256), (512, 256, 512), (128, 128, 128),
    (384, 256, 128),  # a 3 x 2 grid: clamped curve cells
    (256, 96, 200)]   # the padding path
MM_TEST_BLOCKS = (128, 128, 64)  # tests/test_kernels.py:90


def morton_path(shapes, dev, report):
    """The public `morton_matmul` in bf16 at its default blocks, in each
    order, on each shape: the orders' outputs must be bit-identical and
    finite.  Returns the launches it made."""
    runs = []
    for M, N, K in shapes:
        a, b = mm_bench.inputs(M, N, K, torch.bfloat16, dev)
        t0 = time.perf_counter()
        outs = [mm_ops.morton_matmul(a, b, order=o) for o in mm_ops.ORDERS]
        sync(dev)
        wall = time.perf_counter() - t0
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise RuntimeError(f"morton_matmul {(M, N, K)}: the orders' outputs differ")
        if tuple(outs[0].shape) != (M, N) or not bool(torch.isfinite(outs[0]).all()):
            raise RuntimeError(f"morton_matmul {(M, N, K)}: output not finite or misshapen")
        runs.append(dict(shape=[M, N, K], orders=list(mm_ops.ORDERS), wall_s=wall))
        log(f"morton_matmul path {M} x {N} x {K} bf16 [{body('morton_matmul', torch.bfloat16)}], "
            f"default blocks, "
            f"{len(mm_ops.ORDERS)} orders: bit-identical, finite, {wall:.3f} s")
        del a, b, outs
    report["morton_matmul"] = dict(path=runs)


def morton_kernel_checks(dev, report, errs):
    """The kernel against its plain version over the JAX test's shapes and
    the study's, fp32 and bf16, each order, with a traced call per order
    (`mm_bench.check_orders`: bit-identical orders, every tile once)."""
    cases = []
    for shapes, blocks_list in ((MM_SHAPES, [MM_TEST_BLOCKS]),
                                (MM_FULL, mm_bench.BLOCKS)):
        for M, N, K in shapes:
            for dt in (torch.float32, torch.bfloat16):
                a, b = mm_bench.inputs(M, N, K, dt, dev)
                want = morton_matmul_ref(a, b)
                for blocks in blocks_list:
                    c = mm_bench.check_orders(a, b, blocks, want)
                    errs.append(c["max_abs_err"])
                    cases.append(dict(shape=[M, N, K], dtype=str(dt), blocks=list(blocks),
                                      body=body("morton_matmul", dt),
                                      max_abs_err=c["max_abs_err"],
                                      max_rel_err=c["max_rel_err"], tol=c["tol"],
                                      tiles=c["traces"]["morton"]["tiles"],
                                      max_start_lag={o: t["max_start_lag"]
                                                     for o, t in c["traces"].items()}))
                del a, b, want
    report["morton_matmul"]["checks"] = cases
    worst = max(cases, key=lambda c: c["max_rel_err"] / c["tol"])
    log(f"morton_matmul ({body('morton_matmul', torch.bfloat16)} and "
        f"{body('morton_matmul', torch.float32)}): {len(cases)} cases x "
        f"{len(mm_ops.ORDERS)} orders within tolerance "
        f"of plain (|got - want| / (|want| + 1): 3e-2 bf16, 1e-4 fp32 at K <= 512 and "
        f"1e-4 K / 512 past it; worst {worst}), the orders bit-identical, every tile "
        f"computed once by the block tile_order gives it")


def morton_timing(dev, name, report):
    """The 8192^3 bf16 product per order at both block sizes, in turns, by
    CUDA events (median of 25), beside the bound, the plain version and
    `torch.matmul` in bf16 (a yardstick, never called by the port)."""
    M, N, K = MM_FULL[0]
    a, b = mm_bench.inputs(M, N, K, torch.bfloat16, dev)
    times = {}
    for blocks in reversed(mm_bench.BLOCKS):  # the default blocks first
        bm, bn, bk = blocks
        per = {o: [] for o in mm_ops.ORDERS}
        for order in mm_bench.TURNS:
            per[order].append(event_times(dev, lambda i=0: mm_ops.morton_matmul(
                a, b, block_m=bm, block_n=bn, block_k=bk, order=order)))
        times["x".join(map(str, blocks))] = per
    plain = event_times(dev, lambda i=0: morton_matmul_ref(a, b))
    lib = event_times(dev, lambda i=0: torch.matmul(a, b))
    ops_ = 2 * M * N * K
    bytes_ = a.element_size() * (M * K + K * N + M * N)
    flops, hbm = h100_peaks(name).bf16_flops, h100_peaks(name).hbm_bytes_per_s
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    ms = times["256x256x256"]["morton"][0]
    t = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
             bound_by="operations" if ops_ / flops > bytes_ / hbm else "bytes",
             library="torch.matmul (bf16)", body=body("morton_matmul", torch.bfloat16),
             operations=ops_, bytes=bytes_,
             shape=[M, N, K], orders_ms=times, tflops=ops_ / ms / 1e9)
    report["morton_matmul"]["timing"] = t
    for blk, per in times.items():
        log(f"morton_matmul {M}^3 bf16 blocks {blk}: " + "; ".join(
            f"{o} {' / '.join(f'{x:.4f}' for x in v)} ms" for o, v in per.items()))
    log(f"morton_matmul {M}^3 bf16 [{body('morton_matmul', torch.bfloat16)}] (morton, "
        f"default blocks): {ms:.4f} ms, "
        f"{t['tflops']:.2f} TFLOP/s (plain {plain:.4f} ms; torch.matmul {lib:.4f} ms); "
        f"bound {bound:.4f} ms by {t['bound_by']} = {100 * bound / ms:.2f}% of the card's peak")
    return t


# --------------------------------------------------- the dense family ----

def dense_family_path(sc, dev, report):
    """gemma-2b or minitron-8b at full width: weights drawn on the card
    (timed), a warm-up, then the counted run: 32 prompts of 2,048 through
    `make_prefill_step` (cache 2,176) and 32 greedy steps.  Returns what
    the checks need; the caller reads the launch counts."""
    t0 = time.perf_counter()
    cfg, model = serving_model(sc, dev)
    sync(dev)
    t_init = time.perf_counter() - t0
    serving_path(sc | dict(batch=2, prompt=64, steps=2), dev, cfg, model, {})  # warm-up
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(sc, dev, cfg, model, report)
    report[sc["key"]].update(init_s=t_init, params=count_params(model.specs()))
    log(f"{cfg.name}: {count_params(model.specs())} parameters drawn on the device in "
        f"{t_init:.3f} s")
    return cfg, model, prompts, generated, cache


def check_dense_launches(sc, cfg, counts):
    """One `flash_attention` launch a layer for the prefill, one
    `flash_decode` a layer and step."""
    want = dict(flash_attention=cfg.n_layers, flash_decode=cfg.n_layers * sc["steps"])
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"{cfg.name}: launches {counts}, want {want}")


# ------------------------------------- hybrid and encoder-decoder serving ----

def count_units(cfg, kind):
    """The hybrid units of ``kind`` ("R" or "A") in the whole model."""
    n_rep, n_left = hybrid_layout(cfg)
    return n_rep * cfg.hybrid_pattern.count(kind) + cfg.hybrid_pattern[:n_left].count(kind)


def hybrid_path(hc, dev, report):
    """Phase 26's run: recurrentgemma-2b (or its smoke widths) with seeded
    weights, a warm-up, then the counted run through the serving steps:
    32 prompts of 2,048 (cache 2,176, so the window is 2,048) and 64 greedy
    steps, each rotating the window.  The caller reads the launches."""
    t0 = time.perf_counter()
    cfg, model = serving_model(hc, dev)
    sync(dev)
    t_init = time.perf_counter() - t0
    serving_path(hc | dict(batch=2, prompt=64, cache=80, steps=2), dev, cfg, model, {})
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(hc, dev, cfg, model, report)
    wlen = min(cfg.local_window, hc["cache"])
    report[hc["key"]].update(init_s=t_init, params=count_params(model.specs()), window=wlen,
                             r_units=count_units(cfg, "R"), a_units=count_units(cfg, "A"))
    if cache["blocks"]["c"]["k"].shape[2] != wlen:
        raise RuntimeError(f"window cache of {cache['blocks']['c']['k'].shape[2]} positions")
    log(f"{cfg.name}: {count_params(model.specs())} parameters drawn on the device in "
        f"{t_init:.3f} s; {count_units(cfg, 'R')} RG-LRU and {count_units(cfg, 'A')} "
        f"local-attention units, window {wlen}")
    return cfg, model, prompts, generated, cache


def check_hybrid_launches(hc, cfg, counts):
    """One `flash_attention` launch an A unit for the prefill, one
    `flash_decode` an A unit and step."""
    n_a = count_units(cfg, "A")
    want = dict(flash_attention=n_a, flash_decode=n_a * hc["steps"])
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"{cfg.name}: launches {counts}, want {want}")


def hybrid_kernel_checks(hc, dev, cfg, model, cache, report, errs):
    """The first A unit's weights at full width: `flash_attention` with the
    window binding (S 4,096, window 2,048, D 256, 10 query heads over 1 kv
    head) and `flash_decode` over the serving path's own window cache with
    lengths min(index + 1, 2,048) for per-sequence positions around the
    window's length, at the plan's splits and at 8, against the plain
    versions on the same card tensors."""
    unit = model.blocks[0]["c"]
    W = min(cfg.local_window, hc["cache"])
    gen = torch.Generator(device=dev).manual_seed(26)
    Bc, S = hc["check_B"], hc["check_S"]
    tok = torch.randint(0, cfg.vocab, (Bc, S), generator=gen, device=dev)
    x = rms_norm(model.embed_tokens(tok), unit.ln1, cfg.norm_eps)
    q, k, v = qkv(unit.temporal, cfg, x, torch.arange(S, device=dev).expand(Bc, -1))
    del x
    scale = cfg.head_dim ** -0.5
    ck, cv = cache["blocks"]["c"]["k"][0], cache["blocks"]["c"]["v"][0]
    B = ck.shape[0]
    index = torch.randint(W - 64, W + 64, (B,), generator=gen, device=dev)
    lens = torch.clamp(index + 1, max=W).to(torch.int32)
    xd = rms_norm(model.embed_tokens(torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                                                   device=dev)), unit.ln1, cfg.norm_eps)
    qd = rotary((xd @ unit.temporal.w_q).reshape(B, 1, cfg.n_heads, cfg.head_dim),
                index[:, None], cfg.rope_theta)
    most = fd_ops.MAX_SPLITS
    cases = (
        ("window prefill", "flash_attention",
         lambda a, b, c: fa_ops.flash_attention(a, b, c, causal=True, scale=scale, window=W),
         sliced(lambda a, b, c: flash_attention_ref(a, b, c, causal=True, scale=scale,
                                                    window=W), 1), (q, k, v)),
        ("window decode", "flash_decode",
         lambda a, b, c: fd_ops.flash_decode(a, b, c, lens, scale=scale),
         lambda a, b, c: flash_decode_ref(a, b, c, lens, scale=scale), (qd, ck, cv)),
        (f"window decode {most} splits", "flash_decode",
         lambda a, b, c: fd_ops.flash_decode_cuda(a, b, c, lens, scale=scale, nsplit=most),
         lambda a, b, c: flash_decode_ref(a, b, c, lens, scale=scale), (qd, ck, cv)))
    checks = {}
    attention_pair_checks(f"{cfg.name} first A unit", cases, errs, checks)
    report[hc["key"]]["kernel_checks"] = dict(
        prefill_shape=list(q.shape), window=W, decode_cache=list(ck.shape),
        decode_lens=[int(lens.min()), int(lens.max())], splits=fd_ops.plan_for(qd, ck).nsplit,
        checks=checks)
    return (q, k, v), (qd, ck, cv, lens)


def attention_timing(dev, name, label, kernel, plain, library, ops_, bytes_, shape, **extra):
    """One attention kernel at one shape: kernel, plain version and one
    PyTorch call for the same function (CUDA events), beside the bound."""
    flops, hbm = h100_peaks(name).bf16_flops, h100_peaks(name).hbm_bytes_per_s
    ms = event_times(dev, lambda i=0: kernel())
    plain_ms = event_times(dev, lambda i=0: plain())
    lib = event_times(dev, lambda i=0: library())
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
             bound_by="operations" if ops_ / flops > bytes_ / hbm else "bytes",
             operations=ops_, bytes=bytes_, shape=shape, **extra)
    log(f"{label} {shape}: {ms:.4f} ms (plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{lib:.4f} ms), bound {bound:.4f} ms by {t['bound_by']} = {100 * bound / ms:.2f}% of "
        f"the card's peak")
    return t


def hybrid_timings(dev, cfg, name, prefill_args, decode_args, W):
    """B2 with the window binding and B3 at G 10, D 256 over the window
    cache, at phase 26's shapes."""
    q, k, v = (t.to(torch.bfloat16) for t in prefill_args)
    qd, ck, cv, lens = decode_args
    B, S, H, D = q.shape
    K = k.shape[2]
    scale = D ** -0.5
    pairs = sum(min(i + 1, W) for i in range(S))  # live (query, key) pairs
    band = (torch.arange(S, device=dev)[:, None] - torch.arange(S, device=dev)[None, :])
    band = (band >= 0) & (band < W)
    out = {"window_prefill": attention_timing(
        dev, name, "flash_attention, window", lambda: fa_ops.flash_attention(
            q, k, v, causal=True, scale=scale, window=W),
        lambda: sliced(lambda a, b, c: flash_attention_ref(a, b, c, causal=True, scale=scale,
                                                           window=W), 1)(q, k, v),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=band,
            scale=scale, enable_gqa=True),
        4 * B * H * D * pairs, 2 * (2 * q.numel() + k.numel() + v.numel()),
        [B, S, S, H, K, D], window=W)}
    B, Sc, K, D = ck.shape
    H = qd.shape[2]
    live = int(lens.sum())
    mask = (torch.arange(Sc, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    out["window_decode"] = attention_timing(
        dev, name, "flash_decode, window cache", lambda: fd_ops.flash_decode(
            qd, ck, cv, lens, scale=scale),
        lambda: flash_decode_ref(qd, ck, cv, lens, scale=scale),
        lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2), attn_mask=mask,
            scale=scale, enable_gqa=True),
        4 * H * D * live, 2 * (2 * live * K * D + 2 * qd.numel()) + 4 * B,
        [B, Sc, H, K, D], lens=[int(lens.min()), int(lens.max())],
        splits=fd_ops.plan_for(qd, ck).nsplit)
    return out


def scan_timing(hc, dev, cfg, report):
    """The RG-LRU scan alone at the prefill's shape (fp32 a and b of (B,
    S, d_rnn)), CUDA events."""
    gen = torch.Generator(device=dev).manual_seed(28)
    shape = (hc["batch"], hc["prompt"], cfg.d_rnn)
    a = torch.rand(shape, generator=gen, device=dev)
    b = torch.randn(shape, generator=gen, device=dev)
    ms = event_times(dev, lambda i=0: rglru_scan(a, b), reps=10)
    steps = max(1, (hc["prompt"] - 1).bit_length())
    report[hc["key"]]["rglru_scan"] = dict(ms=ms, shape=list(shape), doubling_steps=steps,
                                           per_prefill_ms=ms * count_units(cfg, "R"))
    log(f"RG-LRU scan at {shape} fp32 ({steps} doubling steps): {ms:.3f} ms a unit, "
        f"{ms * count_units(cfg, 'R'):.1f} ms over the prefill's {count_units(cfg, 'R')} units")
    del a, b


def hybrid_prefill_vs_stepping(dev, report):
    """Two RRA units (6 layers) at the smoke widths, fp32: the one-pass
    prefill's cache and last logits against stepping the same prompt
    through `decode_step`, on the same device (48 tokens over a window of
    32, so the window has rotated)."""
    cfg = get_smoke_config("recurrentgemma-2b").scaled(n_layers=6, dtype="float32")
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(3, 48)).astype(np.int32)).to(dev)
    lg, cache = make_prefill_step(model, cfg)(tok, cache_len=56)
    stepped = init_params(model.cache_specs(3, 56), None, device=dev)
    for i in range(tok.shape[1]):
        slg, stepped = model.decode_step(stepped, tok[:, i:i + 1], i)
    worst = 0.0
    for got, want in zip(tree_leaves(cache), tree_leaves(stepped)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        worst = max(worst, float((got - want).abs().max()))
    torch.testing.assert_close(lg, slg, atol=1e-4, rtol=1e-4)
    report["hybrid_prefill_vs_stepping"] = dict(leaves=len(tree_leaves(cache)),
                                                max_abs_diff=worst)
    log(f"recurrentgemma-2b, 2 RRA units fp32 on {dev.type}: the one-pass prefill's "
        f"{len(tree_leaves(cache))} cache leaves equal stepping the prompt (max |diff| "
        f"{worst:.3g}, within 1e-4), and its last logits")


def encdec_path(ec, dev, report):
    """Phase 27's run: seamless-m4t-medium (or its smoke widths), seeded
    weights and frames, a warm-up, then the counted run: `make_prefill_step`
    encodes 32 x 2,048 frames and builds the cross K/V beside a self cache
    of 2,176, then one BOS token and 64 greedy steps."""
    t0 = time.perf_counter()
    cfg, model = serving_model(ec, dev)
    sync(dev)
    t_init = time.perf_counter() - t0
    prefill, step = make_prefill_step(model, cfg), make_serve_step(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(27)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16

    def run(B, T, cache_len, steps):
        frames = torch.randn((B, T, cfg.d_model), generator=gen, device=dev).to(dtype)
        bos = torch.ones((B, 1), dtype=torch.int32, device=dev)

        def first_token():
            _, cache = prefill(frames, cache_len=cache_len)
            tok, _, cache = step(cache, bos, 0)
            return tok, cache

        (tok, cache), t_first = timed(dev, first_token)

        def decode():
            t, c, out = tok, cache, [tok]
            for i in range(steps):
                t, _, c = step(c, t, 1 + i)
                out.append(t)
            return torch.cat(out, 1)

        generated, t_decode = timed(dev, decode)
        return frames, generated, cache, t_first, t_decode

    run(2, 64, 16, 2)  # warm-up
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    B, T, steps = ec["batch"], ec["frames"], ec["steps"]
    frames, generated, cache, t_first, t_decode = run(B, T, ec["cache"], steps)
    if generated.shape != (B, steps + 1):
        raise RuntimeError("the encoder-decoder path returned the wrong number of tokens")
    if not (0 <= int(generated.min()) and int(generated.max()) < cfg.vocab):
        raise RuntimeError("the encoder-decoder path generated ids outside the vocabulary")
    report[ec["key"]] = dict(
        arch=cfg.name, batch=B, frames=T, self_cache=ec["cache"], decode_steps=steps,
        init_s=t_init, params=count_params(model.specs()), time_to_first_token_s=t_first,
        encoded_frames_per_s=B * T / t_first, decode_s=t_decode,
        decode_tokens_per_s=B * steps / t_decode)
    log(f"{cfg.name} serving (one run each): {count_params(model.specs())} parameters drawn "
        f"in {t_init:.3f} s; encode {B} x {T} frames, the cross K/V and the first token "
        f"{t_first:.4f} s (time to first token), {steps} decode steps {t_decode:.4f} s "
        f"({B * steps / t_decode:.6g} tokens/s)")
    return cfg, model, frames, generated, cache


def check_encdec_launches(ec, cfg, counts):
    """One `flash_attention` launch an encoder layer, two `flash_decode`
    (self and cross) a decoder layer and token."""
    want = dict(flash_attention=cfg.n_enc_layers,
                flash_decode=2 * cfg.n_dec_layers * (ec["steps"] + 1))
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"{cfg.name}: launches {counts}, want {want}")


def encdec_profile(ec, dev, cfg, model, cache, generated, report, n_steps=8):
    step = make_serve_step(model, cfg)

    def decode():
        tok, c = generated[:, -1:], cache
        for i in range(n_steps):  # rewrites the last positions, in range
            tok, _, c = step(c, tok, ec["steps"] - n_steps + 1 + i)
        return tok

    _, prof = profile_window(dev, decode)
    prof["device_ops_per_step"] = prof["device_ops"] / n_steps
    report[ec["key"] + "_profile"] = dict(decode_steps=n_steps, decode=prof)
    log_profile(f"{cfg.name}: {n_steps} decode steps at batch {ec['batch']} "
                f"({prof['device_ops_per_step']:.0f} device ops per step)", prof)


def encdec_kernel_checks(ec, dev, cfg, model, frames, cache, report, errs):
    """Encoder layer 0 on the path's frames: the non-causal
    `flash_attention` at 32 x 2,048, D 64, 16 heads, and with 4 times
    more queries than keys (unmasked attention reads no offset); decoder
    layer 0's `flash_decode` against the self cache with per-sequence
    lengths and against the cross K/V with the memory's length; each
    against the plain version on the same card tensors."""
    p = model.encoder[0]
    B, T, _ = frames.shape
    x = rms_norm(frames, p.ln1, cfg.norm_eps)
    q, k, v = qkv(p.attn, cfg, x, torch.arange(T, device=dev).expand(B, -1))
    del x
    scale = cfg.head_dim ** -0.5
    c = cache["decoder"]
    gen = torch.Generator(device=dev).manual_seed(29)
    lens = torch.randint(1, ec["steps"] + 2, (B,), generator=gen, device=dev, dtype=torch.int32)
    qd = torch.randn((B, 1, cfg.n_heads, cfg.head_dim), generator=gen, device=dev)
    kv_short = max(1, T // 4)
    cases = (
        ("encoder prefill", "flash_attention",
         lambda a, b, cc: fa_ops.flash_attention(a, b, cc, causal=False, scale=scale),
         sliced(lambda a, b, cc: flash_attention_ref(a, b, cc, causal=False, scale=scale), 4),
         (q, k, v)),
        (f"cross, {T} queries over {kv_short} keys", "flash_attention",
         lambda a, b, cc: fa_ops.flash_attention(a, b[:, :kv_short], cc[:, :kv_short],
                                                 causal=False, scale=scale),
         sliced(lambda a, b, cc: flash_attention_ref(a, b[:, :kv_short], cc[:, :kv_short],
                                                     causal=False, scale=scale), 4),
         (q, k, v)),
        ("self decode", "flash_decode",
         lambda a, b, cc: fd_ops.flash_decode(a, b, cc, lens, scale=scale),
         lambda a, b, cc: flash_decode_ref(a, b, cc, lens, scale=scale),
         (qd, c["k"][0], c["v"][0])),
        ("cross decode", "flash_decode",
         lambda a, b, cc: fd_ops.flash_decode(a, b, cc, T, scale=scale),
         lambda a, b, cc: flash_decode_ref(a, b, cc, T, scale=scale),
         (qd, c["xk"][0], c["xv"][0])))
    checks = {}
    attention_pair_checks(f"{cfg.name} layer 0", cases, errs, checks)
    report[ec["key"]]["kernel_checks"] = dict(
        prefill_shape=list(q.shape), self_cache=list(c["k"][0].shape),
        cross_cache=list(c["xk"][0].shape), self_lens=[int(lens.min()), int(lens.max())],
        checks=checks)
    return (q, k, v), (qd, c["xk"][0], c["xv"][0])


def encdec_timings(dev, name, prefill_args, cross_args):
    """The encoder's non-causal B2 and the cross-attention's B3 at phase
    27's shapes."""
    q, k, v = (t.to(torch.bfloat16) for t in prefill_args)
    B, S, H, D = q.shape
    scale = D ** -0.5
    out = {"encoder_prefill": attention_timing(
        dev, name, "flash_attention, non-causal", lambda: fa_ops.flash_attention(
            q, k, v, causal=False, scale=scale),
        lambda: sliced(lambda a, b, c: flash_attention_ref(a, b, c, causal=False,
                                                           scale=scale), 4)(q, k, v),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale),
        4 * B * H * D * S * S, 2 * (2 * q.numel() + k.numel() + v.numel()),
        [B, S, S, H, k.shape[2], D])}
    qd, xk, xv = (t.to(torch.bfloat16) for t in cross_args)
    B, Sc, K, D = xk.shape
    H = qd.shape[2]
    out["cross_decode"] = attention_timing(
        dev, name, "flash_decode, cross K/V", lambda: fd_ops.flash_decode(
            qd, xk, xv, Sc, scale=scale),
        lambda: flash_decode_ref(qd, xk, xv, Sc, scale=scale),
        lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), xk.transpose(1, 2), xv.transpose(1, 2), scale=scale),
        4 * H * D * B * Sc, 2 * (2 * B * Sc * K * D + 2 * qd.numel()) + 4 * B,
        [B, Sc, H, K, D], splits=fd_ops.plan_for(qd, xk).nsplit)
    return out


def encdec_small_vs_cpu(dev, report):
    """seamless-m4t-medium at the smoke widths (2 + 2 layers), fp32, one
    set of weights: the frames' prefill and 12 greedy steps from BOS give
    the same tokens on the card and on the CPU, and the teacher-forced
    logits (30 tokens over 24 frames: the cross-attention's queries
    outnumber its keys) agree within 1e-4."""
    cfg = get_smoke_config("seamless-m4t-medium").scaled(dtype="float32")
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    card = lm_params_from_numpy(cfg, lm_params_to_numpy(cpu), dev)
    rng = np.random.default_rng(4)
    fr = torch.from_numpy(rng.normal(size=(4, 24, cfg.d_model)).astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(4, 30)).astype(np.int32))
    served, logits = {}, {}
    for model in (card, cpu):
        _, cache = make_prefill_step(model, cfg)(fr.to(model.device), cache_len=16)
        nxt = torch.ones((4, 1), dtype=torch.int32, device=model.device)
        step, out = make_serve_step(model, cfg), []
        for i in range(12):
            nxt, _, cache = step(cache, nxt, i)
            out.append(nxt.cpu())
        served[model.device.type] = torch.cat(out, 1)
        logits[model.device.type] = model(tok.to(model.device), fr.to(model.device))[0].cpu()
    if not torch.equal(served[dev.type], served["cpu"]):
        raise RuntimeError("seamless smoke model: tokens differ between card and CPU")
    torch.testing.assert_close(logits[dev.type], logits["cpu"], atol=1e-4, rtol=1e-4)
    report["seamless-m4t-medium_small_vs_cpu"] = dict(
        tokens=int(served["cpu"].numel()),
        forward_max_abs_diff=float((logits[dev.type] - logits["cpu"]).abs().max()))
    log(f"seamless-m4t-medium smoke model: {served['cpu'].numel()} greedy tokens, card == "
        f"CPU; teacher-forced logits (30 tokens over 24 frames) within 1e-4")


# -------------------------------------------------------------- training ----

@contextlib.contextmanager
def plain_kernels():
    """The model's attention, expert GEMM and SSD scan through their plain
    versions (the reference route of the gradient checks), differentiated
    by autograd."""
    kernel_route = attn_mod.flash_attention, moe_mod.moe_gemm, ssd_ops.ssd_scan

    def plain(q, k, v, *, causal=True, scale=None, window=None):
        return flash_attention_ref(q, k, v, causal=causal,
                                   scale=q.shape[-1] ** -0.5 if scale is None else scale,
                                   window=window)

    attn_mod.flash_attention, moe_mod.moe_gemm, ssd_ops.ssd_scan = (
        plain, moe_gemm_ref, ssd_scan_ref)
    try:
        yield
    finally:
        attn_mod.flash_attention, moe_mod.moe_gemm, ssd_ops.ssd_scan = kernel_route


@contextlib.contextmanager
def routing(calls, replay=None):
    """Within the block each MoE dispatch appends its own top-k picks to
    ``calls`` as (router probabilities, ids sorted, ids as picked), the
    first two on the CPU for `router_flips`; with ``replay`` (another
    run's ``calls``) it then routes as that run did, taking that run's
    picks at its own probabilities (`models.moe.top_k`)."""
    own = moe_mod.top_k
    theirs = None if replay is None else iter(replay)

    def top_k(probs, k):
        gates, ids = own(probs, k)
        calls.append((probs.detach().cpu(), ids.sort(dim=-1).values.cpu(), ids))
        if theirs is not None:
            ids = next(theirs)[2]
            gates = probs.gather(-1, ids)
        return gates, ids

    moe_mod.top_k = top_k
    try:
        yield
    finally:
        moe_mod.top_k = own


def training_state(tc, dev):
    """The driver's state and data: `launch.train.build_state` and its
    synthetic corpus in the Morton token store on the device."""
    cfg = get_smoke_config(tc["arch"]) if tc["smoke"] else get_config(tc["arch"])
    (model, opt), t_init = timed(dev, lambda: train_mod.build_state(cfg, seed=0, device=dev))
    store, t_corpus = timed(dev, lambda: train_mod.synthetic_corpus(
        cfg, doc_len=tc["seq_len"] + 1 + 64, device=dev))
    pipe = DataPipeline(store, PipelineConfig(seq_len=tc["seq_len"],
                                              global_batch=tc["batch"]))
    log(f"{cfg.name} training state: {count_params(model.specs())} parameters in "
        f"{t_init:.3f} s, corpus of {store.n_docs} x {store.doc_len} tokens in "
        f"{t_corpus:.3f} s")
    return cfg, model, opt, pipe


def training_batches_vs_cpu(tc, cfg, pipe, report):
    """The pipeline's batches at the path's own shapes (rows of seq_len + 1
    tokens out of the store's cuboids: on the card through `cutout_gather`)
    against the same corpus in a CPU token store, read by the plain
    gather: bit for bit, at the first and the last step of the counted
    run."""
    cpu = DataPipeline(train_mod.synthetic_corpus(cfg, doc_len=pipe.store.doc_len,
                                                  device="cpu"), pipe.cfg)
    steps = (0, tc["steps"] - 1)
    for s in steps:
        got, want = pipe.get_batch(s), cpu.get_batch(s)
        for k in ("tokens", "labels"):
            if not torch.equal(got[k].cpu(), want[k]):
                n = int((got[k].cpu() != want[k]).sum())
                raise RuntimeError(f"training batch {s}: {k} differ from the plain gather's "
                                   f"in {n} of {want[k].numel()} places")
    report[f"{tc['key']}_batches_vs_cpu"] = dict(steps=list(steps),
                                                 shape=list(want["tokens"].shape),
                                                 cuboid=list(pipe.store.spec.base_cuboid))
    log(f"{cfg.name} training batches {list(steps)} ({tuple(want['tokens'].shape)} tokens "
        f"out of a {pipe.store.n_docs} x {pipe.store.doc_len} store in "
        f"{tuple(pipe.store.spec.base_cuboid)} cuboids): equal to the plain gather's bit "
        f"for bit")


def opt_config(tc, **kw):
    return AdamWConfig(lr_peak=tc["lr"], warmup_steps=5, total_steps=tc["steps"], **kw)


def step_batch(cfg, pipe, step):
    """The pipeline's batch of ``step`` with the driver's frontend inputs of
    that step (`launch.train.frontend_inputs`: the encoder-decoder's
    ``frames``, the patch frontend's ``embeds``) in the model's dtype."""
    batch = pipe.get_batch(step)
    dt = getattr(torch, cfg.dtype)
    batch.update({k: v.to(dt) for k, v in
                  train_mod.frontend_inputs(cfg, step, batch["tokens"]).items()})
    return batch


# The gradient check's tolerances.  fp32: phase 6's (atol and rtol 2e-5,
# element by element) for the dense family; for the MoE and ssm families
# rtol 1e-4 and 1e-4 of the leaf's max |g|, the fp32 tolerance of their
# kernels' own checks (MOE_FP32_REL, SSD_REL: the expert sums and the
# scan's cumsum round in another order than the plain versions').  bf16:
# the CPU tests' bf16 gradient tolerance, 2e-2
# of the leaf's max |g| (tests/test_torch_train.py), and 2e-2 in norm; the
# kernel route no farther from the fp32 gradients than 1.25 x the plain
# route's distance; and at most 1% of a leaf's elements outside phase 6's
# bf16 tolerance taken element by element (rtol 2e-2 and 5% of the leaf's
# mean |g|).  That tolerance does not hold for every element of gradients
# after 30 bf16 layers: in two runs on the H100 0.38-0.44% of the elements
# of w_q, w_k and embed fell outside it (and none of the other leaves'),
# with the kernel route 7e-3 from the plain one in norm and each route
# ~1e-2 from the fp32 gradients.  The 1% limit fails a fault confined to
# a few tiles, which the norms would not see.
# The MoE family is held to the same bf16 criteria.  The ssm, hybrid and
# encoder-decoder families' bf16 checks hold the kernel route to the plain
# route by their distances from
# the fp32 gradients: in norm, and in the share of elements outside phase
# 6's tolerance, the kernel route no farther than 1.25 x the plain route
# (or 1% of the elements, the dense family's limit, where the plain
# route's share is below that).  Its bf16 gradients are as far from each
# other as each is from the fp32 ones: in the first full-width run of
# mamba2-370m on the H100 every leaf's two bf16 routes were 1.3-4.0% apart
# in norm, with 2-8% of the elements outside phase 6's tolerance of each
# other, and each route 3-8% from the fp32 gradients (blocks/ln: kernel
# 7.77%, plain 7.71%), which the two fp32 routes matched to 2.3e-5.  In the
# first full-width runs on the H100 (one sequence) the dense bf16 criteria
# held for neither of the other two: recurrentgemma-2b's two bf16 routes
# were 2.7-4.3% apart in norm, each 4.7-6.8% from the fp32 gradients (the
# kernel route at most 1.03 x the plain route's distance), with 0.3-18.5%
# of the elements outside phase 6's tolerance of each other;
# seamless-m4t-medium's were 0.6-1.6% apart in norm but had up to 2.3% of
# the elements outside that tolerance, the kernel route nearer the fp32
# gradients than the plain route in 24 of 26 leaves.  Their fp32 routes
# matched to 7.7e-6 and 2.6e-6 in norm, at the dense family's fp32
# tolerance.  A leaf of theirs passes by either criterion: in that run
# the hybrid's tail conv_b (2,560 elements) met the dense one (its two bf16
# routes within phase 6's tolerance of each other everywhere) and missed
# the other by 9 elements.  A hole or a fault in a few tiles moves the
# kernel route away from the fp32 gradients and not the plain route.
GRAD_FP32_TOL = FP32_TOL
GRAD_FP32_REL = 1e-4  # the MoE and ssm families
# the families held to the dense family's criteria in fp32 (phase 6's
# tolerance): their kernel routes differ from the plain routes in the
# attention forward alone
DENSE_CRITERIA = ("dense", "hybrid", "encdec")
GRAD_BF16_SHARE = 2e-2
GRAD_BF16_VS_FP32 = 1.25
GRAD_BF16_PHASE6_OUTSIDE = 1e-2
# the leaves that reach the loss only, or in part, through a family's kernels:
# each must get a nonzero gradient through the kernel route
KERNEL_LEAVES = {
    "dense": ("blocks/attn/w_q", "blocks/attn/w_k", "blocks/attn/w_v"),
    "moe": ("blocks/attn/w_q", "blocks/attn/w_k", "blocks/attn/w_v", "blocks/moe/w_gate",
            "blocks/moe/w_up", "blocks/moe/w_down", "blocks/moe/w_router"),
    "ssm": ("blocks/ssm/w_dt", "blocks/ssm/dt_bias", "blocks/ssm/A_log",
            "blocks/ssm/w_xBC", "blocks/ssm/conv_w"),
    # the A unit is the pattern RRA's third (key "c"); the tail holds R units
    "hybrid": ("blocks/c/temporal/w_q", "blocks/c/temporal/w_k", "blocks/c/temporal/w_v"),
    "encdec": tuple(f"{part}/w_{w}" for part in ("encoder/attn", "decoder/self_attn",
                                                 "decoder/cross_attn") for w in "qkv")}


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bf16_holds(family, r):
    """The bf16 criteria above for one leaf's row of `training_grad_check`:
    the dense ones for the dense and MoE families, the distances from the
    fp32 gradients for the ssm family, and either for the hybrid and
    encoder-decoder families."""
    nearer = r["bf16_kernel_vs_fp32"] <= GRAD_BF16_VS_FP32 * r["bf16_plain_vs_fp32"]
    dense = (nearer and r["bf16_max_abs_err"] <= GRAD_BF16_SHARE * r["bf16_max_abs"]
             and r["bf16_rel_norm"] <= GRAD_BF16_SHARE
             and r["bf16_phase6_outside"] <= GRAD_BF16_PHASE6_OUTSIDE)
    if family in ("dense", "moe"):
        return dense
    relative = nearer and r["bf16_kernel_outside_fp32"] <= max(
        GRAD_BF16_VS_FP32 * r["bf16_plain_outside_fp32"], GRAD_BF16_PHASE6_OUTSIDE)
    return relative if family == "ssm" else dense or relative


def training_grad_check(tc, dev, cfg, model, pipe, report):
    """Every parameter's gradient through the kernel route against the same
    weights with attention, expert GEMM and scan through their plain
    versions (`plain_kernels`), on the first batch's first ``check_seqs``
    sequences: in the model's bf16 and with the weights taken to fp32, at
    the tolerances above; finite, and the kernels' leaves
    (`KERNEL_LEAVES`) nonzero through the kernel route.  A MoE's plain
    route takes the kernel route's top-k picks (`routing`): where the k-th
    and (k+1)-th router probabilities nearly tie, the two routes' rounding
    can pick different experts for a token (a flip), and that token's
    gradient would then go to other experts' weights; the flips the plain
    route would have made are counted and reported (`router_flips`), and
    the gradients are compared under one routing."""
    batch = {k: v[:tc["check_seqs"]] for k, v in step_batch(cfg, pipe, 0).items()}
    batch32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    cfg32 = cfg.scaled(dtype="float32")
    model32 = build_model(cfg32, tree_map(lambda t: t.detach().float(), model.param_tree()),
                          device=dev)
    paths = _paths(model.param_tree())
    grads, losses, flips = {}, {}, {}
    for tag, m, c, b in (("bf16", model, cfg, batch), ("fp32", model32, cfg32, batch32)):
        m.requires_grad_(True)
        calls = {}
        for route in ("kernel", "plain"):
            calls[route] = []
            with (plain_kernels() if route == "plain" else contextlib.nullcontext()), \
                    routing(calls[route], calls["kernel"] if route == "plain" else None):
                loss, _, g = loss_and_grads(m, b, c)
            grads[route, tag] = list(tree_leaves(g))  # bf16 leaves kept in bf16
            losses[f"{route}_{tag}"] = float(loss)
            del g
        if cfg.family == "moe":
            flips[tag] = router_flips(f"{cfg.name} gradient check ({tag})", calls["kernel"],
                                      calls["plain"], cfg.top_k,
                                      between="the kernel route and the plain route")
        del calls
        for name in KERNEL_LEAVES[cfg.family]:
            g = grads["kernel", tag][paths.index(name)]
            if not bool((g != 0).any()):
                raise RuntimeError(f"gradient of {name} ({tag}) is zero through the kernel "
                                   f"route")
    del model32
    fp32_tol = (lambda pf: GRAD_FP32_TOL) if cfg.family in DENSE_CRITERIA else (
        lambda pf: dict(rtol=GRAD_FP32_REL, atol=GRAD_FP32_REL * float(pf.abs().max())))
    rows, failed = {}, []
    for i, path in enumerate(paths):
        kb, pb, kf, pf = (grads[k][i].float() for k in (
            ("kernel", "bf16"), ("plain", "bf16"), ("kernel", "fp32"), ("plain", "fp32")))
        if not (bool(torch.isfinite(kb).all()) and bool(torch.isfinite(kf).all())):
            raise RuntimeError(f"gradient {path}: non-finite through the kernel route")
        phase6 = 2e-2 * pb.abs() + FULL_WIDTH_BF16_ATOL_SHARE * pb.abs().mean()
        phase6_fp32 = 2e-2 * pf.abs() + FULL_WIDTH_BF16_ATOL_SHARE * pf.abs().mean()
        r = dict(bf16_max_abs_err=float((kb - pb).abs().max()),
                 bf16_max_abs=float(pb.abs().max()), bf16_rel_norm=_rel(kb, pb),
                 bf16_kernel_vs_fp32=_rel(kb, pf), bf16_plain_vs_fp32=_rel(pb, pf),
                 bf16_phase6_outside=float(((kb - pb).abs() > phase6).float().mean()),
                 bf16_kernel_outside_fp32=float(((kb - pf).abs() > phase6_fp32).float().mean()),
                 bf16_plain_outside_fp32=float(((pb - pf).abs() > phase6_fp32).float().mean()),
                 fp32_max_abs_err=float((kf - pf).abs().max()),
                 fp32_max_abs=float(pf.abs().max()), fp32_rel_norm=_rel(kf, pf))
        rows[path] = r
        try:
            torch.testing.assert_close(kf, pf, **fp32_tol(pf))
        except AssertionError as e:
            failed.append(f"gradient {path} (fp32): kernel route != plain route\n{e}")
        if not bf16_holds(cfg.family, r):
            failed.append(f"gradient {path} (bf16): kernel route != plain route: {r}")
    report[f"{tc['key']}_grad_check"] = dict(seqs=tc["check_seqs"], losses=losses,
                                             leaves=rows, router_flips=flips)
    worst = max(rows.values(), key=lambda r: r["bf16_rel_norm"])
    fp32_desc = (f"atol and rtol {GRAD_FP32_TOL['rtol']}" if cfg.family in DENSE_CRITERIA
                 else f"rtol {GRAD_FP32_REL} and {GRAD_FP32_REL} of max |g|")
    if cfg.family in ("dense", "moe"):
        bf16_desc = (f"within {GRAD_BF16_SHARE} of max |g| and in norm (largest "
                     f"{worst['bf16_rel_norm']:.3g}), no farther from the fp32 gradients than "
                     f"{GRAD_BF16_VS_FP32} x the plain route, at most "
                     f"{GRAD_BF16_PHASE6_OUTSIDE} of the elements outside phase 6's tolerance "
                     f"(largest {max(r['bf16_phase6_outside'] for r in rows.values()):.3g})")
    else:
        bf16_desc = (f"no farther from the fp32 gradients than {GRAD_BF16_VS_FP32} x the "
                     f"plain route, in norm and in the share of elements outside phase 6's "
                     f"tolerance (or {GRAD_BF16_PHASE6_OUTSIDE} of them)"
                     + ("" if cfg.family == "ssm" else ", or within the dense family's "
                        "criteria of the plain route"))
    log(f"{cfg.name} gradients ({tc['check_seqs']} x {tc['seq_len']} tokens), kernel route "
        f"vs plain route, {len(rows)} leaves: fp32 within {fp32_desc} (largest |diff| / |g| "
        f"in norm {max(r['fp32_rel_norm'] for r in rows.values()):.3g}); bf16 {bf16_desc}; "
        f"{', '.join('/'.join(n.split('/')[-2:]) for n in KERNEL_LEAVES[cfg.family])} nonzero; "
        f"losses {losses}")
    for path, r in rows.items():
        log(f"  {path}: bf16 |diff| / |g| {r['bf16_rel_norm']:.3g} (max {r['bf16_max_abs_err']:.3g} "
            f"of max |g| {r['bf16_max_abs']:.3g}; vs fp32: kernel {r['bf16_kernel_vs_fp32']:.3g}, "
            f"plain {r['bf16_plain_vs_fp32']:.3g}; outside phase 6's bf16 tolerance "
            f"{r['bf16_phase6_outside']:.2e}, against fp32 kernel "
            f"{r['bf16_kernel_outside_fp32']:.2e}, plain {r['bf16_plain_outside_fp32']:.2e}); "
            f"fp32 max |diff| {r['fp32_max_abs_err']:.3g} of max |g| {r['fp32_max_abs']:.3g}")
    if failed:
        raise RuntimeError("\n".join(failed))


# The MoE backward kernel against its plain twin at the training path's own
# shape, at the card test's limits (tests/test_torch_cuda.py,
# `test_moe_gemm_backward_kernel_matches_its_plain_twin`): each leaf within
# 2^-9 of the twin in norm and every element within 2^-5 of the leaf's
# largest |g|, and no farther from the fp64 gradient than 1.01 x the twin.
# A backward that rounded dg and du to one bf16 each would miss the first
# and the last (~2.6e-3 from the twin, ~1.2 x its distance from fp64, on
# the CPU: tests/test_torch_train.py).
MOE_GRAD_NORM = 2 ** -9
MOE_GRAD_MAX = 2 ** -5
MOE_GRAD_VS_F64 = 1.01


def moe_backward_vs_twin(tc, dev, cfg, model, pipe, report):
    """`moe_gemm_grad_cuda` on layer 0's dispatched buffer of the first
    microbatch of the counted run's first batch (its x, expert weights and
    counts, and a seeded dy of the buffer's shape, junk past the counts)
    against `moe_gemm_grad_ref` and `moe_gemm_grad_f64` on the same
    tensors, at the limits above; rows past the counts must get zero dx."""
    seqs = tc["batch"] // tc["microbatches"]
    batch = {k: v[:seqs] for k, v in step_batch(cfg, pipe, 0).items()}
    seen = []

    def first(p, xt, disp):
        if not seen:
            seen.append((disp.grouped, p.w_gate, p.w_up, p.w_down, disp.counts))

    with torch.no_grad(), moe_mod.observe(first):
        loss_fn(model, batch, cfg)
    x, wg, wu, wd, counts = (t.detach() for t in seen[0])
    del seen, batch
    gen = torch.Generator(device=dev).manual_seed(30)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
    args = (x, wg, wu, wd, counts, dy)
    got = mg_ops.moe_gemm_grad_cuda(*args)
    want = moe_gemm_grad_ref(*args)
    exact = moe_gemm_grad_f64(*args)
    rows, failed = {}, []
    for name, g, w, ex in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, want, exact):
        gf, wf = g.float(), w.float()
        r = dict(rel_norm=_rel(gf, wf), max_share=float((gf - wf).abs().max() / wf.abs().max()),
                 kernel_vs_f64=_rel(g.double(), ex), twin_vs_f64=_rel(w.double(), ex))
        rows[name] = r
        if not (r["rel_norm"] <= MOE_GRAD_NORM and r["max_share"] <= MOE_GRAD_MAX
                and r["kernel_vs_f64"] <= MOE_GRAD_VS_F64 * r["twin_vs_f64"]):
            failed.append(f"{name}: {r}")
    E, C, d = x.shape
    dead = torch.arange(C, device=dev)[None, :] >= counts[:, None]
    if bool(got[0][dead].any()):
        failed.append("dx: nonzero on rows past the counts")
    live = int(counts.clamp(0, C).sum())
    report[f"{tc['key']}_backward_vs_twin"] = dict(shape=[E, C, d, wg.shape[-1]],
                                                   live_rows=live, leaves=rows)
    log(f"{cfg.name} MoE backward kernel vs moe_gemm_grad_ref, layer 0 of the first "
        f"microbatch (E {E}, C {C}, d {d}, f {wg.shape[-1]}, {live} live rows): " + "; ".join(
            f"{n} {r['rel_norm']:.3g} in norm (limit {MOE_GRAD_NORM:.3g}), "
            f"{r['max_share']:.3g} of max |g| (limit {MOE_GRAD_MAX:.3g}), vs fp64 kernel "
            f"{r['kernel_vs_f64']:.4g} twin {r['twin_vs_f64']:.4g}" for n, r in rows.items()))
    if failed:
        raise RuntimeError(f"{cfg.name} MoE backward kernel != moe_gemm_grad_ref:\n"
                           + "\n".join(failed))


def _paths(tree, prefix=""):
    return [p for k in sorted(tree) for p in (
        _paths(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict) else [prefix + k])]


def training_path(tc, dev, cfg, model, opt, pipe, report):
    """The counted run: ``steps`` train steps through `make_train_step`, each
    batch from the pipeline (its rows through `cutout`).  The loss must fall
    from the first step to the last, and every step's gradient norm (so
    every gradient) must be finite."""
    step_fn = make_train_step(model, cfg, opt_config(tc), n_microbatches=tc["microbatches"])
    losses, norms, times = [], [], []
    for s in range(tc["steps"]):
        t0 = time.perf_counter()
        opt, m = step_fn(opt, step_batch(cfg, pipe, s))
        losses.append(float(m["loss"]))  # waits for the step
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{cfg.name} training: the loss did not fall: {losses}")
    if not all(np.isfinite(norms)):
        raise RuntimeError(f"{cfg.name} training: a gradient was not finite (grad norms "
                           f"{norms})")
    tokens = tc["batch"] * tc["seq_len"]
    step_s = statistics.median(times[tc["warm"]:])
    report[tc["key"]] = dict(arch=cfg.name, seq_len=tc["seq_len"], batch=tc["batch"],
                             microbatches=tc["microbatches"], steps=tc["steps"], lr=tc["lr"],
                             losses=losses, grad_norms=norms, step_s=times,
                             median_step_s=step_s, tokens_per_s=tokens / step_s)
    log(f"{cfg.name} training ({tc['steps']} steps of {tc['batch']} x {tc['seq_len']} "
        f"tokens in {tc['microbatches']} microbatches, lr {tc['lr']}): loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}; median step {step_s:.4f} s after {tc['warm']} warm steps, "
        f"{tokens / step_s:.6g} tokens/s; every grad norm finite")
    log(f"  losses {[round(x, 4) for x in losses]}")
    return opt


# the kernels a family's training forward launches (the backward
# differentiates their plain versions, but for bf16 causal attention at D
# 64 and 128 and the MoE's bf16 expert GEMM, which have backward kernels)
TRAIN_KERNELS = {"dense": ("flash_attention",), "moe": ("flash_attention", "moe_gemm"),
                 "ssm": ("ssd_scan",), "hybrid": ("flash_attention",),
                 "encdec": ("flash_attention",)}
# how many times a policy runs a layer's forward in a train step: ``block``
# and ``dots`` again in the backward's recompute
REMAT_PASSES = {"none": 1, "block": 2, "dots": 2}


def kernel_calls(cfg):
    """Each training kernel's calls in one forward of a microbatch: one a
    layer; the hybrid's attention one an A unit, the encoder-decoder's one
    an encoder layer and two a decoder layer (self and cross)."""
    if cfg.family == "hybrid":
        return count_units(cfg, "A")
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers
    return cfg.n_layers


def check_training_launches(tc, cfg, counts):
    """Each of the family's kernels exactly `kernel_calls` x the policy's
    forward passes (2 under ``block``) per microbatch and step;
    `cutout_gather` at least once a step (the pipeline's rows).  The dense
    and MoE families' bf16 attention (causal, D 64) through
    `flash_attention`'s gradient kernels, and the MoE's bf16 expert GEMM
    through `moe_gemm`'s backward kernel, once a layer per microbatch and
    step, and never through the plain recompute."""
    want = kernel_calls(cfg) * REMAT_PASSES[cfg.remat] * tc["microbatches"] * tc["steps"]
    bad = {k: counts[k] for k in TRAIN_KERNELS[cfg.family] if counts[k] != want}
    if bad or counts["cutout_gather"] < tc["steps"]:
        raise RuntimeError(f"{cfg.name} training launches {counts}: want "
                           f"{' and '.join(TRAIN_KERNELS[cfg.family])} {want} each "
                           f"({kernel_calls(cfg)} calls x {REMAT_PASSES[cfg.remat]} passes "
                           f"under remat {cfg.remat!r} x microbatches x steps) and "
                           f"cutout_gather >= {tc['steps']}")
    backward_ops = {"dense": (fa_ops,), "moe": (fa_ops, mg_ops)}.get(cfg.family, ())
    for ops_ in backward_ops:
        backward = dict(backward_launches=ops_.backward_launches,
                        backward_plain=ops_.backward_plain)
        want_b = dict(backward_launches=cfg.n_layers * tc["microbatches"] * tc["steps"],
                      backward_plain=0)
        name = ops_.NAME
        if backward != want_b:
            raise RuntimeError(f"{cfg.name} training: {name} backward calls {backward}, "
                               f"want {want_b} (layers x microbatches x steps through the "
                               f"backward kernel)")
        counts.update({f"{name}.{k}": v for k, v in backward.items()})


def train_flops(cfg, seq_len, seqs):
    """Model FLOPs of one training step, the forward's and twice that in
    the backward (the backward's recomputes of the forward not counted):
    - 6 x the parameters a token uses x tokens: the tied embedding counted
      once, as the head's product; of a MoE's experts only the top k; the
      encoder-decoder's encoder over as many frames as tokens;
    - causal attention's products, 12 x layers x B x H x D x S(S+1)/2 (QK^T
      and PV); the hybrid's A units over the keys inside their window;
      the encoder's and the cross attention's over all S keys;
    - the ssm's SSD products as the chunked scan forms them, the
      intra-chunk ones causal like attention's: 6 x layers x B x (S(Q+1)/2
      x (N + H P) for C.B^T and its product with x dt, plus 2 S H P N for
      the chunk states and the carried state's share), Q the chunk.
    Returns {"dense", "attention", "ssd"}."""
    params = count_params(model_specs(cfg))
    if cfg.family == "moe":
        experts = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
        params -= experts - experts * cfg.top_k // cfg.n_experts
    out = dict(dense=6 * params * seq_len * seqs, attention=0, ssd=0)
    causal = seq_len * (seq_len + 1) // 2
    per_key = 12 * seqs * cfg.n_heads * cfg.head_dim  # a (query, key) pair's products
    if cfg.family in ("dense", "moe"):
        out["attention"] = per_key * cfg.n_layers * causal
    if cfg.family == "hybrid":
        window = sum(min(i + 1, cfg.local_window) for i in range(seq_len))
        out["attention"] = per_key * count_units(cfg, "A") * window
    if cfg.family == "encdec":
        out["attention"] = per_key * (cfg.n_enc_layers * seq_len * seq_len
                                      + cfg.n_dec_layers * (causal + seq_len * seq_len))
    if cfg.family == "ssm":
        Q, N = min(cfg.ssm_chunk, seq_len), cfg.ssm_state
        HP = cfg.ssm_heads * cfg.ssm_head_dim
        out["ssd"] = 6 * cfg.n_layers * seqs * (seq_len * (Q + 1) // 2 * (N + HP)
                                                + 2 * seq_len * HP * N)
    return out


TRAIN_RANGES = ("train_step.forward", "train_step.backward", "train_step.optimizer")


def training_profile(tc, dev, cfg, model, opt, pipe, name, report, first=100):
    """``profiled`` train steps under the profiler (after as many warm
    ones): the device's idle share of the steps' wall time, and a step's
    split into forward, backward (of it each kernel's recompute through
    its plain version) and optimizer, the device time launched inside
    `make_train_step`'s and the Functions' profiler ranges (a step's mean).
    Then the model FLOPs over the median step of the counted run as a share
    of the card's bf16 peak."""
    step_fn = make_train_step(model, cfg, opt_config(tc), n_microbatches=tc["microbatches"])
    n = tc["profiled"]
    steps = iter(range(first, first + 2 * n))
    recomputes = [f"{k}.recompute" for k in TRAIN_KERNELS[cfg.family]]

    def some_steps():
        st = opt
        for _ in range(n):
            st, m = step_fn(st, step_batch(cfg, pipe, next(steps)))
        return float(m["loss"])

    _, prof = profile_window(dev, some_steps, TRAIN_RANGES + tuple(recomputes), raw=True)
    report[tc["key"]]["profile"] = prof
    log_profile(f"{cfg.name}: {n} train steps", prof)
    r = prof["ranges"]
    split = dict(forward_ms=r["train_step.forward"]["ms"] / n,
                 backward_ms=r["train_step.backward"]["ms"] / n,
                 optimizer_ms=r["train_step.optimizer"]["ms"] / n,
                 recompute={k: dict(ms=r[k]["ms"] / n, calls=r[k]["calls"] / n)
                            for k in recomputes})
    want = kernel_calls(cfg) * tc["microbatches"]  # each Function's backward once a call
    parts = [split["forward_ms"], split["backward_ms"], split["optimizer_ms"]] + [
        v["ms"] for v in split["recompute"].values()]
    if any(v["calls"] != want for v in split["recompute"].values()) or min(parts) <= 0:
        raise RuntimeError(f"{cfg.name} train step split {split}: want every part's "
                           f"device time > 0 and {want} calls of each recompute a step")
    flops = train_flops(cfg, tc["seq_len"], tc["batch"])
    total = sum(flops.values())
    step_s = report[tc["key"]]["median_step_s"]
    peak = h100_peaks(name).bf16_flops
    split.update(model_flops=total, flops=flops, model_tflops=total / step_s / 1e12,
                 bf16_peak_share=total / step_s / peak)
    report[tc["key"]]["split"] = split
    log(f"{cfg.name} train step split (device time launched in each profiler range, "
        f"a step's mean over the profiled {n}): forward {split['forward_ms']:.1f} ms, "
        f"backward {split['backward_ms']:.1f} ms (of it " + ", ".join(
            f"{k} {v['ms']:.1f} ms over {v['calls']:.0f} calls"
            for k, v in split["recompute"].items()) +
        f"), optimizer {split['optimizer_ms']:.1f} ms")
    log(f"{cfg.name} model FLOPs a step {total:.4g} ({flops}; "
        f"{tc['batch'] * tc['seq_len']} tokens): {split['model_tflops']:.2f} TFLOP/s "
        f"over the median step = {100 * split['bf16_peak_share']:.2f}% of the "
        f"{peak / 1e12:.0f} TFLOP/s bf16 peak")


def training_compressed_steps(tc, dev, cfg, model, opt, pipe, report):
    """One step each with bf16 and int8 gradient compression."""
    out = {}
    for i, method in enumerate(("bf16", "int8")):
        step_fn = make_train_step(model, cfg, opt_config(tc, grad_compression=method),
                                  n_microbatches=tc["microbatches"])
        (opt, m), t = timed(dev, lambda: step_fn(opt, step_batch(cfg, pipe, 300 + i)))
        out[method] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), step_s=t)
        if not np.isfinite(out[method]["loss"]):
            raise RuntimeError(f"training with {method} compression: loss not finite")
    report[tc["key"]]["compressed_steps"] = out
    log(f"{cfg.name} one step each with gradient compression: " + "; ".join(
        f"{k} loss {v['loss']:.4f}, grad norm {v['grad_norm']:.4f}, {v['step_s']:.4f} s"
        for k, v in out.items()))


def remat_variants(tc, dev, cfg, model, opt, pipe, report):
    """Two steps under each policy of ``remat_variants`` from the counted
    run's state: the second step's time and the peak memory of the two,
    beside the counted run's median step and peak under the config's
    policy."""
    key = tc["key"]
    card = dev.type == "cuda"
    out = {cfg.remat: dict(step_s=report[key]["median_step_s"],
                           max_memory_allocated=report[key].get("max_memory_allocated", 0))}
    try:
        for i, policy in enumerate(tc["remat_variants"]):
            model.cfg = cfg.scaled(remat=policy)
            step_fn = make_train_step(model, model.cfg, opt_config(tc),
                                      n_microbatches=tc["microbatches"])
            if card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            times = []
            for j in range(2):
                (opt, m), t = timed(dev, lambda: step_fn(opt, step_batch(cfg, pipe,
                                                                         400 + 2 * i + j)))
                times.append(t)
                if not np.isfinite(float(m["loss"])):
                    raise RuntimeError(f"{cfg.name} under remat {policy!r}: loss not finite")
            out[policy] = dict(step_s=times[-1], first_step_s=times[0],
                               max_memory_allocated=torch.cuda.max_memory_allocated(dev)
                               if card else 0)
    finally:
        model.cfg = cfg
    report[key]["remat"] = out
    log(f"{cfg.name} train step by remat policy ({tc['batch']} x {tc['seq_len']} tokens, the "
        f"second of 2 steps; "
        f"{cfg.remat!r}: the counted run's median): " + "; ".join(
            f"{p} {v['step_s']:.4f} s, max memory allocated "
            f"{v['max_memory_allocated'] / 2 ** 30:.3f} GiB" for p, v in out.items()))


def training_phase(tc, dev, name, report, by_path):
    """A family's training at full width: the batch and gradient checks,
    then the counted run with the launch counts set to 0 just before it
    and read just after, the step's profile, and (``compressed``) a step
    each with compressed gradients."""
    t0 = time.perf_counter()
    parts = {}
    cfg, model, opt, pipe = training_state(tc, dev)
    del opt  # the checks take no step; the counted run gets the same state anew
    training_batches_vs_cpu(tc, cfg, pipe, report)
    parts["state_and_batches_s"] = time.perf_counter() - t0
    training_grad_check(tc, dev, cfg, model, pipe, report)
    if cfg.family == "moe":
        moe_backward_vs_twin(tc, dev, cfg, model, pipe, report)
    torch.cuda.empty_cache()
    parts["grad_check_s"] = time.perf_counter() - t0 - sum(parts.values())
    opt = adamw_init(model.param_tree())
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    opt = training_path(tc, dev, cfg, model, opt, pipe, report)
    by_path[tc["key"]] = counts = read_launches(tc["key"])
    check_training_launches(tc, cfg, counts)
    report[tc["key"]]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the {tc['key']} path: {counts} ({', '.join(TRAIN_KERNELS[cfg.family])} "
        f"= {kernel_calls(cfg)} calls x {REMAT_PASSES[cfg.remat]} passes (remat "
        f"{cfg.remat!r}: the forward and the recompute) x {tc['microbatches']} microbatches x "
        f"{tc['steps']} steps each); max memory allocated "
        f"{report[tc['key']]['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    parts["counted_run_s"] = time.perf_counter() - t0 - sum(parts.values())
    training_profile(tc, dev, cfg, model, opt, pipe, name, report)
    parts["profile_s"] = time.perf_counter() - t0 - sum(parts.values())
    if tc.get("compressed"):
        training_compressed_steps(tc, dev, cfg, model, opt, pipe, report)
    if tc["remat_variants"]:
        remat_variants(tc, dev, cfg, model, opt, pipe, report)
    pipe.stop()
    del model, opt, pipe
    torch.cuda.empty_cache()
    parts["extra_steps_s"] = time.perf_counter() - t0 - sum(parts.values())
    training_small_vs_cpu(dev, report, tc["arch"])
    parts["small_vs_cpu_s"] = time.perf_counter() - t0 - sum(parts.values())
    report[tc["key"]]["phase_s"] = time.perf_counter() - t0
    report[tc["key"]]["phase_parts"] = parts
    log(f"{tc['key']} phase {report[tc['key']]['phase_s']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))


# B2's gradient where the hybrid's window binds (Skv > window: at the
# training phase's 2,048 positions the window of 2,048 masks nothing) and
# the encoder-decoder's unmasked attention at Sq != Skv, which take the
# plain recompute; then the shapes the gradient kernels take in bf16: a
# train-2k microbatch (its fp64 gradient taken a sequence at a time),
# arctic's 56 over 8 at D 128, and a window that binds at D 64: (B, Sq, Skv,
# H, K, D, causal, window)
ATTN_GRAD_FULL = [(2, 4096, 4096, 10, 1, 256, True, 2048), (2, 2048, 512, 16, 16, 64, False, None),
                  (2, 512, 2048, 16, 16, 64, False, None), (8, 2048, 2048, 16, 8, 64, True, None),
                  (1, 2048, 2048, 56, 8, 128, True, None), (2, 2048, 2048, 16, 8, 64, True, 512)]
ATTN_GRAD_TINY = [(1, 64, 64, 10, 1, 256, True, 32), (1, 32, 16, 4, 4, 16, False, None),
                  (1, 16, 32, 4, 4, 16, False, None), (1, 64, 64, 4, 2, 64, True, None),
                  (1, 48, 48, 7, 1, 128, True, 16)]


def attention_grad_checks(shapes, dev, report, errs):
    """`flash_attention`'s differentiable route (the kernel inside
    `FlashAttention` on the card, one forward launch) against the plain
    version on the same tensors, bf16 and fp32: the forward within phase
    6's tolerances; where the call takes the plain recompute, dq, dk and dv
    equal bit for bit (the Function's backward differentiates the plain
    version from its saved inputs); where it takes the gradient kernels
    (bf16 causal self-attention at D 64 and 128, `grad_kernel_takes`),
    the logsumexp entry's out bit-equal to the route's and its lse within
    `LSE_ATOL` of `flash_attention_lse_ref`'s, and dq, dk, dv within the
    ``GRAD_*`` limits of `flash_attention_grad_ref` (`outside_grad_limits`:
    near the twin, and both near `flash_attention_grad_f64`); finite and
    nonzero, each backward counted on its route."""
    gen = torch.Generator(device=dev).manual_seed(28)
    rows = {}
    for B, Sq, Skv, H, K, D, causal, window in shapes:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, dout = (torch.randn(shape, generator=gen, device=dev).to(dt)
                             for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D),
                                           (B, Sq, H, D)))
            qkv = [t.requires_grad_() for t in (q, k, v)]
            attn = dict(causal=causal, window=window)
            kernel = dev.type == "cuda" and fa_ops.grad_kernel_takes(q, k, causal=causal)
            before = (fa_ops.launches, fa_ops.backward_launches, fa_ops.backward_plain)
            out = fa_ops.flash_attention(*qkv, **attn)
            with torch.set_grad_enabled(not kernel):  # the plain route's gradient only
                want = flash_attention_ref(*qkv, scale=D ** -0.5, **attn)
            got_g = torch.autograd.grad(out, qkv, dout)
            sync(dev)
            label = (f"flash_attention gradient {B} x {Sq} x {Skv}, H {H}, K {K}, D {D}, "
                     f"{'causal' if causal else 'unmasked'}, window {window}, {str(dt)[6:]}")
            counted = (fa_ops.launches - before[0], fa_ops.backward_launches - before[1],
                       fa_ops.backward_plain - before[2])
            if dev.type == "cuda" and counted != (1, int(kernel), int(not kernel)):
                raise RuntimeError(f"{label}: (launches, backward_launches, backward_plain) "
                                   f"{counted}, want (1, {int(kernel)}, {int(not kernel)})")
            mean_abs = float(want.float().abs().mean())
            tol = (dict(atol=FULL_WIDTH_BF16_ATOL_SHARE * mean_abs, rtol=BF16_TOL["rtol"])
                   if dt == torch.bfloat16 else FP32_TOL)
            try:
                torch.testing.assert_close(out.float(), want.float(), **tol)
            except AssertionError as e:
                raise RuntimeError(f"{label}: kernel != plain\n{e}") from None
            err = float((out.float() - want.float()).abs().max())
            errs.append(err)
            row = dict(max_abs_err=err, mean_abs_out=mean_abs, **tol)
            if kernel:
                plain = dict(scale=D ** -0.5, **attn)
                q, k, v, o = (t.detach() for t in (*qkv, out))
                o_lse, lse = fa_ops.flash_attention_cuda(q, k, v, lse=True, **plain)
                if not torch.equal(o_lse, o):
                    raise RuntimeError(f"{label}: the logsumexp entry's out is not the route's")
                row["lse_max_abs_err"] = lse_err = float(
                    (lse - flash_attention_lse_ref(q, k, **plain)).abs().max())
                if not lse_err <= LSE_ATOL:
                    raise RuntimeError(f"{label}: lse {lse_err:.3g} from flash_attention_lse_ref, "
                                       f"limit {LSE_ATOL:.3g}")
                twin = flash_attention_grad_ref(q, k, v, o, lse, dout, **plain)
                exact = flash_attention_grad_f64(q, k, v, dout, **plain)
                row["grads"] = grads = grad_gaps(got_g, twin, exact)
                del twin, exact, lse, o_lse
                if outside := outside_grad_limits(grads):
                    raise RuntimeError(f"{label}: {outside} outside the limits of "
                                       f"flash_attention_grad_ref: {grads}")
                how = f"lse {lse_err:.3g} from the plain logsumexp (limit {LSE_ATOL:.3g}); " + (
                    "; ".join(
                        f"{n} {r['rel_norm']:.3g} of the twin in norm (limit {GRAD_NORM:.3g}), "
                        f"{r['max_share']:.3g} of max |g| (limit {GRAD_MAX:.3g}), vs fp64 "
                        f"kernel {r['kernel_vs_f64']:.4g} twin {r['twin_vs_f64']:.4g} (limits "
                        f"{GRAD_VS_F64:.3g} x the twin, {GRAD_F64:.3g})" for n, r in grads.items()))
            else:
                want_g = torch.autograd.grad(want, qkv, dout)
                if not all(torch.equal(g, w) for g, w in zip(got_g, want_g)):
                    raise RuntimeError(f"{label}: a gradient differs from the plain route's")
                del want_g
                how = "dq, dk, dv bit-equal to the plain route's"
            for name, g in zip("qkv", got_g):
                if not (bool(torch.isfinite(g.float()).all()) and bool((g != 0).any())):
                    raise RuntimeError(f"{label}: d{name} is not finite, or is zero")
            if window is not None and Skv <= window:
                raise RuntimeError(f"{label}: the window does not bind")
            rows[label] = row
            log(f"{label}: forward max |kernel - plain| {err:.3g} (mean |out| {mean_abs:.3g}); "
                f"{'gradient kernels' if kernel else 'plain recompute'}: {how}; finite, nonzero")
            del q, k, v, dout, qkv, out, want, got_g
    report["attention_grad_checks"] = rows


# the 2-layer fp32 models trained on the card and the CPU; the ssm's at the
# published chunk of 256 over 256 steps with `build_state`'s init, whose
# decay overflowed exp above the chunk's diagonal before the plain scan's
# repair (`kernels/ssd_scan/ref.py` `causal_decay`)
SMALL_TRAIN = dict(smoke=True, seq_len=32, batch=4, microbatches=2, steps=5, lr=3e-3)
SMALL_TRAIN_ARCH = {"mamba2-370m": (dict(seq_len=256), dict(ssm_chunk=256)),
                    # the smoke window of 32 over 64 positions: the window binds
                    "recurrentgemma-2b": (dict(seq_len=64), {})}
SMALL_TRAIN_RTOL = 1e-4  # losses and grad norms, fp32 card (kernel) vs CPU (plain)


def training_small_vs_cpu(dev, report, arch="smollm-135m"):
    """The arch's smoke model in fp32 (2 layers; the hybrid's 4, RRA and
    R; the encoder-decoder's 2 + 2; the patch frontend's with its
    embeddings) trains 5 steps from the same weights and batches (the
    driver's frontend inputs) on the card and on the CPU: losses and grad
    norms within rtol 1e-4, the parameters within 2 x the sum of the steps'
    lr (AdamW moves an element whose gradient is ~0 by about +-lr a step,
    whichever way its rounding falls); a MoE's routing flips between the
    two are reported."""
    run, scale = SMALL_TRAIN_ARCH.get(arch, ({}, {}))
    tc = SMALL_TRAIN | run
    cfg = get_smoke_config(arch).scaled(dtype="float32", **scale)
    cpu, _ = train_mod.build_state(cfg, seed=1, device="cpu")
    card = lm_params_from_numpy(cfg, lm_params_to_numpy(cpu), dev)
    runs, routes = {}, {}
    for model in (card, cpu):
        d = model.device
        pipe = DataPipeline(train_mod.synthetic_corpus(cfg, doc_len=tc["seq_len"] + 65,
                                                       device=d),
                            PipelineConfig(seq_len=tc["seq_len"], global_batch=tc["batch"]))
        opt = adamw_init(model.param_tree())
        step_fn = make_train_step(model, cfg, opt_config(tc),
                                  n_microbatches=tc["microbatches"])
        runs[d.type] = rows = []
        routes[d.type] = calls = []
        with routing(calls):
            for s in range(tc["steps"]):
                batch = step_batch(cfg, pipe, s)
                opt, m = step_fn(opt, batch)
                rows.append((batch["tokens"].cpu(), float(m["loss"]), float(m["grad_norm"]),
                             float(m["lr"])))
        pipe.stop()
    flips = (router_flips(f"{arch} training", routes[dev.type], routes["cpu"], cfg.top_k)
             if cfg.family == "moe" else None)
    lrs = 0.0
    for (tk, lk, nk, _), (tp, lp, np_, lr) in zip(runs[dev.type], runs["cpu"]):
        if not torch.equal(tk, tp):
            raise RuntimeError(f"training small {arch}: card and CPU batches differ")
        for what, a, b in (("loss", lk, lp), ("grad norm", nk, np_)):
            if not (np.isfinite(a) and abs(a - b) <= SMALL_TRAIN_RTOL * abs(b)):
                raise RuntimeError(f"training small {arch}: {what} {a} on the card, "
                                   f"{b} on the CPU")
        lrs += lr
    diffs = [float(np.abs(a - b).max()) for a, b in zip(
        tree_leaves(lm_params_to_numpy(card)), tree_leaves(lm_params_to_numpy(cpu)))]
    if max(diffs) > 2 * lrs:
        raise RuntimeError(f"training small {arch}: parameters {max(diffs)} apart, "
                           f"tolerance {2 * lrs}")
    key = "training_small_vs_cpu" if arch == "smollm-135m" else f"{arch}_training_small_vs_cpu"
    report[key] = dict(
        seq_len=tc["seq_len"], scale=scale, losses=[r[1] for r in runs["cpu"]],
        card_losses=[r[1] for r in runs[dev.type]], grad_norms=[r[2] for r in runs["cpu"]],
        max_param_diff=max(diffs), param_tol=2 * lrs, router_flips=flips)
    log(f"training small {arch} (fp32, {tc['steps']} steps of {tc['batch']} x {tc['seq_len']}"
        f"{', ' + str(scale) if scale else ''}, card vs CPU): losses "
        f"{[round(r[1], 6) for r in runs[dev.type]]} vs {[round(r[1], 6) for r in runs['cpu']]} "
        f"within rtol {SMALL_TRAIN_RTOL}, grad norms too; parameters at most "
        f"{max(diffs):.3g} apart (tolerance 2 x sum of lr = {2 * lrs:.3g})")


# ------------------------------------------------ checkpoint and restart ----

RESTART_RUN = ["--smoke", "--steps", "10", "--seq-len", "64", "--batch", "4"]
RESTART_ARCHS = ("smollm-135m", "granite-moe-1b-a400m", "mamba2-370m", "recurrentgemma-2b",
                 "seamless-m4t-medium", "internvl2-76b", "arctic-480b")


def _state_bits(tree):
    """The leaves of a train-state tree as (path, CPU tensor)."""
    return [(p, t.detach().cpu()) for p, t in zip(_paths(tree), tree_leaves(tree))]


def restart_vs_uninterrupted(dev, report, arch):
    """`launch.train.main` at the smoke widths, 10 steps with ``--ckpt-every
    5 --inject-failure-at 8`` against the same run without a failure: the
    recovery log must show the restore to step 5 and the replay of steps
    5-7, the replayed losses must equal the first run's, and the final
    parameters and optimizer state must be equal bit for bit (the largest
    difference is printed where they are not).  Then the step-10 checkpoint
    the card wrote restores on the CPU (`ckpt.restore_checkpoint`, into a
    CPU model's live tensors) bit for bit."""
    root = HERE / "build" / "smoke_ckpt" / arch
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", arch] + RESTART_RUN + (["--device", "cpu"] if dev.type == "cpu" else [])
    plain = train_mod.main(argv)
    out = train_mod.main(argv + ["--ckpt-dir", str(root), "--ckpt-every", "5",
                                 "--inject-failure-at", "8"])
    want_log = [dict(failed_step=8, worker=0, restored_to=5, lost_steps=3)]
    if out["recoveries"] != want_log:
        raise RuntimeError(f"{arch} restart: recovery log {out['recoveries']}, want {want_log}")
    if out["losses"][:8] != plain["losses"][:8] or out["losses"][8:] != plain["losses"][5:]:
        raise RuntimeError(f"{arch} restart: losses {out['losses']} against the "
                           f"uninterrupted run's {plain['losses']}")
    got, want = _state_bits(out["state"]), _state_bits(plain["state"])
    diffs = {p: float((g.double() - w.double()).abs().max()) for (p, g), (_, w) in
             zip(got, want) if not torch.equal(g, w)}
    if diffs:
        worst = max(diffs, key=diffs.get)
        raise RuntimeError(f"{arch} restart: {len(diffs)} of {len(got)} leaves differ from "
                           f"the uninterrupted run, the largest {worst} by {diffs[worst]}")
    step, tree = restore_checkpoint(str(root))
    cfg = get_smoke_config(arch)
    cpu_model, cpu_opt = train_mod.build_state(cfg, seed=1, device="cpu")
    restored = _state_bits(train_state_to_tree(
        cpu_model, train_state_from_tree(tree, cpu_model, cpu_opt)))
    if step != 10 or any(not torch.equal(r, g) for (_, r), (_, g) in zip(restored, got)):
        raise RuntimeError(f"{arch} restart: the step-{step} checkpoint does not restore on "
                           f"the CPU to the card's final state")
    shutil.rmtree(root, ignore_errors=True)
    report.setdefault("restart", {})[arch] = dict(
        recoveries=out["recoveries"], losses=out["losses"], leaves=len(got),
        bit_equal=True, restored_step=step)
    log(f"{arch} restart on {dev.type}: recovered {out['recoveries']}; replayed losses equal; "
        f"final parameters and optimizer state ({len(got)} leaves) bit-equal to the "
        f"uninterrupted run; the step-{step} checkpoint restores on the CPU bit for bit")


# ------------------------------------- arctic-480b and the dry run ----

ARCTIC_FULL = dict(arch="arctic-480b", key="arctic_serving", smoke=False, layers=2, batch=32,
                   prompt=2048, cache=2176, steps=32, expert_slice=8, reps=10)
ARCTIC_TINY = ARCTIC_FULL | dict(smoke=True, batch=2, prompt=16, cache=24, steps=4,
                                 expert_slice=4)


def arctic_model(ac, dev):
    """arctic-480b at full width cut to ``layers`` layers (or its smoke
    config), weights drawn on the device from a seed into their own dtype
    a matrix at a time: `init_params` draws each leaf whole in fp32, and
    the stacked experts alone would take 35.7 GB so beside the bf16
    weights."""
    cfg = (get_smoke_config(ac["arch"]) if ac["smoke"]
           else arctic_480b.CONFIG.scaled(n_layers=ac["layers"]))
    gen = torch.Generator(device=dev).manual_seed(30)

    def draw(s):
        dt = DTYPES[s.dtype]
        if s.init != "normal":
            return (torch.zeros if s.init == "zeros" else torch.ones)(s.shape, dtype=dt,
                                                                      device=dev)
        t = torch.empty(s.shape, dtype=dt, device=dev)
        for m in t.view(-1, *s.shape[-2:]) if t.dim() > 2 else [t]:
            m.copy_(torch.randn(m.shape, generator=gen, device=dev) * s.scale)
        return t

    return cfg, build_model(cfg, map_specs(draw, model_specs(cfg)), device=dev)


def arctic_moe_checks(ac, dev, cfg, model, prompts, report, errs):
    """Layer 0's MoE on the prefill's tokens: two dispatches of the same
    tokens route alike; the kernel over all experts against the plain
    version on a slice of ``expert_slice`` experts (the least and the most
    loaded among them) with their own counts, in bf16; and kernel and plain
    on that slice with its counts set to 0 and C at its two ends, in bf16
    and in fp32.  Returns the bf16 GEMM arguments of the prefill."""
    blk = model.blocks[0]
    x = model.embed_tokens(prompts)
    B, S, d = x.shape
    x = x + attention(blk.attn, cfg, rms_norm(x, blk.ln1, cfg.norm_eps),
                      torch.arange(S, device=dev).expand(B, S))
    xt = rms_norm(x, blk.ln2, cfg.norm_eps).reshape(B * S, d)
    del x
    p = SimpleNamespace(**blk.moe)
    dk, dp = moe_mod.dispatch(p, cfg, xt), moe_mod.dispatch(p, cfg, xt)
    for field in ("expert_ids", "keep", "slot", "counts", "grouped"):
        if not torch.equal(getattr(dk, field), getattr(dp, field)):
            raise RuntimeError(f"arctic layer-0 MoE: two dispatches differ in {field}")
    del dp, xt
    E, C = dk.grouped.shape[:2]
    counts = dk.counts
    idx = torch.argsort(counts)[torch.linspace(0, E - 1, ac["expert_slice"],
                                               device=dev).round().long()]
    sl = [t.index_select(0, idx) for t in (dk.grouped, p.w_gate, p.w_up, p.w_down)]
    yk = mg_ops.moe_gemm(dk.grouped, p.w_gate, p.w_up, p.w_down, counts)
    yp = moe_gemm_ref(*sl, counts.index_select(0, idx))
    checks = {"all_experts_bf16": dict(max_abs_err=check_close(
        "arctic layer-0 moe_gemm bf16, all experts vs a slice", yk.index_select(0, idx), yp,
        moe_tol(yp), errs), **moe_tol(yp))}
    del yk, yp
    ends = counts.index_select(0, idx).clone()
    ends[0], ends[-1] = 0, C
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        args = [t.to(dt) for t in sl]
        if dt == torch.float32:  # rows past the new counts zero, as a dispatch leaves them
            live = torch.arange(C, device=dev)[None, :] < ends[:, None]
            args[0] = args[0] * live[..., None]
        got, want = mg_ops.moe_gemm(*args, ends), moe_gemm_ref(*args, ends)
        checks[f"slice_ends_{tag}"] = dict(max_abs_err=check_close(
            f"arctic layer-0 moe_gemm {tag}, slice with counts 0 and C", got, want,
            moe_tol(want), errs), **moe_tol(want))
        del got, want, args
    report[ac["key"]]["layer0_moe"] = dict(
        tokens=B * S, capacity=C, experts=E, slice=idx.tolist(),
        slice_counts=counts.index_select(0, idx).tolist(),
        counts_min=int(counts.min()), counts_max=int(counts.max()), checks=checks)
    log(f"arctic layer-0 MoE [moe_gemm: {body('moe_gemm', torch.bfloat16)}], full width "
        f"({B * S} tokens, E {E}, C {C}, counts {int(counts.min())}-{int(counts.max())}): "
        + ", ".join(f"{k} max |kernel - plain| {v['max_abs_err']:.3g} (atol {v['atol']:.3g})"
                    for k, v in checks.items()))
    return (dk.grouped, p.w_gate, p.w_up, p.w_down, counts), idx


def decode_dispatch(model, cfg, cache, tok, index):
    """Layer 0's dispatch at one decode step: (buffer, counts)."""
    seen = []
    with moe_mod.observe(lambda p, xt, disp: seen.append((disp.grouped.clone(),
                                                          disp.counts.clone()))):
        make_serve_step(model, cfg)(cache, tok, index)
    return seen[0]


def moe_gemm_timing(dev, name, label, args, idx, reps):
    """`moe_gemm` over the whole buffer beside the plain version on the
    expert slice ``idx`` (all experts in fp32 do not fit beside the
    weights), 3 bf16 bmm over the whole buffer (no skipping) and the bound:
    the live rows' products, and the bytes of the rows, the output and the
    weights of the experts with a nonzero count."""
    flops, hbm = h100_peaks(name).bf16_flops, h100_peaks(name).hbm_bytes_per_s
    x, wg, wu, wd, counts = args
    E, C, d = x.shape
    f = wg.shape[-1]
    rows = int(counts.clamp(0, C).sum())
    active = int((counts > 0).sum())
    sl = [t.index_select(0, idx) for t in (x, wg, wu, wd, counts)]
    ms = event_times(dev, lambda i=0: mg_ops.moe_gemm(*args), reps)
    plain = event_times(dev, lambda i=0: moe_gemm_ref(*sl), reps)
    lib = event_times(dev, lambda i=0: torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu),
                                                 wd), reps)
    ops_ = 6 * d * f * rows
    bytes_ = x.element_size() * (rows * d + E * C * d + 3 * active * d * f)
    bound = max(ops_ / flops, bytes_ / hbm) * 1e3
    t = dict(ms=ms, plain_ms=plain, plain_experts=len(idx), library_ms=lib, bound_ms=bound,
             bound_by="operations" if ops_ / flops > bytes_ / hbm else "bytes",
             library="3 x torch.bmm (bf16, whole buffer, no skipping) + silu product",
             operations=ops_, bytes=bytes_, shape=[E, C, d, f], live_rows=rows,
             active_experts=active, body=body("moe_gemm", x.dtype))
    log(f"moe_gemm {label} {t['shape']} ({rows} live rows, {active} experts with picks): "
        f"{ms:.4f} ms (plain on {len(idx)} experts {plain:.4f} ms; 3 x bmm {lib:.4f} ms); "
        f"bound {bound:.4f} ms by {t['bound_by']} = {100 * bound / ms:.2f}% of the card's peak")
    return t


def arctic_timings(ac, dev, cfg, name, model, prompts, cache, gemm_args, idx):
    """B2 at the prefill, B3 at a decode step over the path's cache, B5 at
    the prefill (layer 0's buffer) and at a decode step."""
    p = model.blocks[0]
    x = rms_norm(model.embed_tokens(prompts), p.ln1, cfg.norm_eps)
    B, S = prompts.shape
    q, k, v = qkv(p.attn, cfg, x, torch.arange(S, device=dev).expand(B, S))
    del x
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale, reps = D ** -0.5, ac["reps"]
    out = {"arctic_prefill": attention_timing(
        dev, name, "flash_attention, arctic prefill",
        lambda: fa_ops.flash_attention(q, k, v, causal=True, scale=scale),
        lambda: sliced(lambda a, b, c: flash_attention_ref(a, b, c, causal=True, scale=scale),
                       2)(q, k, v),
        lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2), is_causal=True, scale=scale,
                                               enable_gqa=True),
        4 * B * H * D * S * (S + 1) // 2, 2 * (2 * q.numel() + k.numel() + v.numel()),
        [B, S, S, H, K, D])}
    del q, k, v
    ck, cv = cache["blocks"]["k"][0], cache["blocks"]["v"][0]
    Sc = ck.shape[1]
    gen = torch.Generator(device=dev).manual_seed(31)
    lens = torch.randint(Sc - ac["steps"], Sc + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    qd = torch.randn((B, 1, H, D), generator=gen, device=dev).to(ck.dtype)
    live = int(lens.sum())
    mask = (torch.arange(Sc, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    out["arctic_decode"] = attention_timing(
        dev, name, "flash_decode, arctic decode", lambda: fd_ops.flash_decode(
            qd, ck, cv, lens, scale=scale),
        lambda: flash_decode_ref(qd, ck, cv, lens, scale=scale),
        lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2), attn_mask=mask,
            scale=scale, enable_gqa=True),
        4 * H * D * live, 2 * (2 * live * K * D + 2 * qd.numel()) + 4 * B,
        [B, Sc, H, K, D], lens=[int(lens.min()), int(lens.max())],
        splits=fd_ops.plan_for(qd, ck).nsplit)
    out["moe_prefill"] = moe_gemm_timing(dev, name, "arctic prefill", gemm_args, idx, reps)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    grouped, counts = decode_dispatch(model, cfg, cache, tok, ac["prompt"] + ac["steps"] - 1)
    dec_args = (grouped, p.moe.w_gate, p.moe.w_up, p.moe.w_down, counts)
    out["moe_decode"] = moe_gemm_timing(dev, name, "arctic decode step", dec_args,
                                        torch.argsort(counts, descending=True)[:len(idx)], reps)
    return out


def check_arctic_launches(ac, cfg, counts):
    """`flash_attention` once a layer (the prefill), `flash_decode` once a
    layer and step, `moe_gemm` once a layer for the prefill and each step."""
    L, n = cfg.n_layers, ac["steps"]
    want = dict(flash_attention=L, flash_decode=L * n, moe_gemm=L * (1 + n))
    if counts != want:
        raise RuntimeError(f"{cfg.name}: launches {counts}, want {want}")


def arctic_path(ac, dev, report, errs):
    """Phase 30's run and checks (see the module's docstring).  Returns
    the launch counts and the kernels' timings."""
    t0 = time.perf_counter()
    cfg, model = arctic_model(ac, dev)
    sync(dev)
    t_init = time.perf_counter() - t0
    serving_path(ac | dict(batch=2, prompt=64, cache=72, steps=2), dev, cfg, model, {})
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(ac, dev, cfg, model, report)
    counts = read_launches(ac["key"]) if dev.type == "cuda" else {}
    if dev.type == "cuda":
        check_arctic_launches(ac, cfg, counts)
    n_params = count_params(model.specs())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    cut = "smoke widths" if ac["smoke"] else f"full width, {cfg.n_layers} of 35 layers"
    report[ac["key"]].update(init_s=t_init, params=n_params, layers=cfg.n_layers,
                             depth_cut=cut, max_memory_allocated=peak)
    log(f"{cfg.name} ({cut}): {n_params} parameters drawn on the device in {t_init:.3f} s; "
        f"launches {counts}; max memory allocated {peak / 2 ** 30:.3f} GiB")
    moe_drop_shares(ac, dev, cfg, model, prompts, cache, generated, report)
    timings = {}
    if dev.type == "cuda":
        serving_profile(ac, dev, cfg, model, prompts, cache, generated, report)
        layer0_attention_vs_plain(ac, dev, cfg, model, prompts, cache, report, errs,
                                  slice_n=2)
        torch.cuda.empty_cache()
        gemm_args, idx = arctic_moe_checks(ac, dev, cfg, model, prompts, report,
                                           errs["moe_gemm"])
        timings = arctic_timings(ac, dev, cfg, torch.cuda.get_device_name(dev), model,
                                 prompts, cache, gemm_args, idx)
        del gemm_args
    del model, prompts, generated, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    serving_small_vs_cpu(dev, report, ac["arch"])
    training_small_vs_cpu(dev, report, ac["arch"])
    report[ac["key"]]["phase_s"] = time.perf_counter() - t0
    log(f"phase 30 {report[ac['key']]['phase_s']:.1f} s")
    return counts, timings


DRYRUN_FULL = dict(cells=["granite-moe-1b-a400m:decode_32k:16x16",
                          "granite-moe-1b-a400m:decode_32k:2x16x16",
                          "arctic-480b:train_4k:16x16", "llama3-405b:train_4k:16x16"],
                   smoke=False, timeout=600)
DRYRUN_TINY = dict(cells=["smollm-135m:train_4k:2x2", "granite-moe-1b-a400m:decode_32k:2x2"],
                   smoke=True, timeout=300)


def dry_run_phase(dc, report):
    """Phase 31: the dry run's cells in a child process; each cell's row
    printed; the phase fails if the child fails or a cell is not ``ok``."""
    t0 = time.perf_counter()
    out = HERE / "build" / "dryrun_cells.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(out)]
    for cell in dc["cells"]:
        argv += ["--cell", cell]
    if dc["smoke"]:
        argv.append("--smoke")
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    r = subprocess.run(argv, cwd=HERE, env=env, capture_output=True, text=True,
                       timeout=dc["timeout"])
    cells = json.loads(out.read_text()) if out.exists() else []
    for c in cells:
        row = {k: v for k, v in c.get("roofline", {}).items()}
        log(f"dry run {c['arch']} x {c['shape']} x {c['mesh']}: {c['status']} "
            f"(a cost model for H100 SXM constants, not a measurement) "
            + json.dumps(dict(row, coll_breakdown=c.get("coll_breakdown"),
                              trace_s=c.get("lower_s"), error=c.get("error"))))
    if r.returncode != 0 or len(cells) != len(dc["cells"]) or \
            any(c["status"] != "ok" for c in cells):
        raise RuntimeError(f"the dry run failed (exit {r.returncode}): {r.stdout[-3000:]}"
                           f"\n{r.stderr[-3000:]}")
    report["dryrun"] = dict(
        cells={f"{c['arch']} x {c['shape']} x {c['mesh']}": {
            k: c[k] for k in ("roofline", "coll_breakdown", "memory_analysis", "lower_s",
                              "cost_extrapolated")} for c in cells},
        phase_s=time.perf_counter() - t0,
        note="a cost model for H100 SXM constants, not a measurement")
    log(f"phase 31 {report['dryrun']['phase_s']:.1f} s ({len(cells)} cells)")


def rehearse():
    """Every path at a tiny size on the CPU: control flow only, no kernels,
    no timing claims and no result line.  One intra-op thread: at these
    sizes more threads add only their overhead, and beside other busy
    processes on the same cores they stall the run many times over."""
    torch.set_num_threads(1)
    dev = torch.device("cpu")
    report = {}
    spec, store, proj = main_path(TINY, dev, report)
    check_results(TINY, dev, spec, store, proj, report)
    annotation_service(TINY, dev, spec, store, proj, report, {})
    del spec, store, proj
    timeseries_and_channels(TS_TINY, dev, report, None, {})
    tiered_storage(TIER_TINY, dev, report, {})
    cluster_front_door(CLUSTER_TINY, dev, report, {})
    storage_faults(FAULT_TINY, dev, report, {})
    for sc in (SERVE_TINY, SSM_TINY, MOE_TINY):
        cfg, model = serving_model(sc, dev)
        serving_path(sc, dev, cfg, model, report)
    morton_path(MM_TINY, dev, report)
    for sc in DENSE_TINY:
        dense_family_path(sc, dev, report)
    hybrid_path(HYBRID_TINY, dev, report)
    hybrid_prefill_vs_stepping(dev, report)
    encdec_path(ENCDEC_TINY, dev, report)
    attention_grad_checks(ATTN_GRAD_TINY, dev, report, [])
    for tc in TRAINS_TINY:
        cfg, model, opt, pipe = training_state(tc, dev)
        training_batches_vs_cpu(tc, cfg, pipe, report)
        training_grad_check(tc, dev, cfg, model, pipe, report)
        opt = training_path(tc, dev, cfg, model, opt, pipe, report)
        if tc["remat_variants"]:
            remat_variants(tc, dev, cfg, model, opt, pipe, report)
        pipe.stop()
        training_small_vs_cpu(dev, report, tc["arch"])
    training_small_vs_cpu(dev, report, "internvl2-76b")
    for arch in RESTART_ARCHS:
        restart_vs_uninterrupted(dev, report, arch)
    arctic_path(ARCTIC_TINY, dev, report, {"flash_attention": [], "flash_decode": [],
                                            "moe_gemm": []})
    dry_run_phase(DRYRUN_TINY, report)
    log(json.dumps({"rehearsal": report}, default=str))
    return 0


def reset_launches():
    for k in KERNELS.values():
        k["ops"].reset_launches()


def read_launches(path, driven=None):
    """Launch counts of the kernels of ``path`` (now, or summed over the
    driven calls of ``driven``); each must be > 0."""
    counts = {n: driven.get(n, 0) if driven is not None else k["ops"].launches
              for n, k in KERNELS.items() if path in k["paths"]}
    for n, c in counts.items():
        if c <= 0:
            raise RuntimeError(f"kernel {n} was not launched on the {path} path")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny CPU run of the control flow (no result line)")
    args = ap.parse_args(argv)
    if args.rehearse:
        return rehearse()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    peak = h100_peaks(name).hbm_bytes_per_s
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    report = {"card": smi}

    t_start = t0 = time.perf_counter()
    _build.build(KERNELS)
    report["build_s"] = time.perf_counter() - t0
    log(f"built {list(KERNELS)} in {report['build_s']:.2f} s")

    # the detection path
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    spec, store, proj = main_path(FULL, dev, report)
    by_path = {"detection": read_launches("detection")}
    report["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the detection path: {by_path['detection']}; max memory allocated "
        f"{report['max_memory_allocated'] / 2 ** 30:.2f} GiB")
    check_results(FULL, dev, spec, store, proj, report)
    where_time_goes(FULL, dev, spec, store, report)
    small_pipeline_vs_cpu(dev, report)
    gather_err, tile = kernel_checks(dev, store, spec, FULL, report, peak)

    # the annotation service on the detection path's state (phase 21)
    t0 = time.perf_counter()
    counts = {}
    annotation_service(FULL, dev, spec, store, proj, report, counts)
    by_path["annotation"] = read_launches("annotation", counts)
    report["annotation"]["phase_s"] = time.perf_counter() - t0
    log(f"launches on the annotation path: {by_path['annotation']}; phase "
        f"{report['annotation']['phase_s']:.1f} s")
    del spec, store, proj
    torch.cuda.empty_cache()

    # time series and channels (phase 22)
    counts = {}
    timeseries_and_channels(TS_FULL, dev, report, peak, counts)
    by_path["timeseries"] = read_launches("timeseries", counts)
    log(f"launches on the timeseries path: {by_path['timeseries']}; phase "
        f"{report['timeseries']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # the device store over the host tiers (phase 23)
    counts = {}
    tiered_storage(TIER_FULL, dev, report, counts)
    by_path["tiered"] = read_launches("tiered", counts)
    log(f"launches on the tiered path: {by_path['tiered']}; phase "
        f"{report['tiered']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # the cluster under the device store, served over HTTP (phase 24)
    counts = {}
    cluster_front_door(CLUSTER_FULL, dev, report, counts)
    by_path["cluster"] = read_launches("cluster", counts)
    log(f"launches on the cluster path: {by_path['cluster']}; phase "
        f"{report['cluster']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # storage faults under the device store and the front door (phase 25)
    counts = {}
    storage_faults(FAULT_FULL, dev, report, counts)
    by_path["faults"] = read_launches("faults", counts)
    log(f"launches on the faults path: {by_path['faults']}; phase "
        f"{report['faults']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # the serving path
    cfg, model = serving_model(SERVE_FULL, dev)
    serving_path(SERVE_TINY | dict(smoke=False), dev, cfg, model, {})  # warm-up
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(SERVE_FULL, dev, cfg, model, report)
    by_path["serving"] = serve_launches = read_launches("serving")
    report["serving"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the serving path: {serve_launches}; max memory allocated "
        f"{report['serving']['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    serving_profile(SERVE_FULL, dev, cfg, model, prompts, cache, generated, report)
    errs = {"flash_attention": [], "flash_decode": []}
    layer0_attention_vs_plain(SERVE_FULL, dev, cfg, model, prompts, cache, report, errs)
    batcher_decode_checks(SERVE_FULL, dev, cfg, report, errs["flash_decode"])
    del prompts, generated, cache
    torch.cuda.empty_cache()
    serving_small_vs_cpu(dev, report)
    attention_kernel_checks(dev, errs)
    timings = attention_timings(SERVE_FULL, dev, cfg, name, report)
    del model
    torch.cuda.empty_cache()

    # the ssm serving path
    cfg, model = serving_model(SSM_FULL, dev)
    serving_path(SSM_TINY | dict(smoke=False), dev, cfg, model, {})  # warm-up
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(SSM_FULL, dev, cfg, model, report)
    by_path["ssm_serving"] = ssm_launches = read_launches("ssm_serving")
    report["ssm_serving"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the ssm_serving path: {ssm_launches}; max memory allocated "
        f"{report['ssm_serving']['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    serving_profile(SSM_FULL, dev, cfg, model, prompts, cache, generated, report)
    errs["ssd_scan"] = []
    layer0_ssm_vs_plain(SSM_FULL, dev, cfg, model, prompts, report, errs["ssd_scan"])
    del prompts, generated, cache
    torch.cuda.empty_cache()
    serving_small_vs_cpu(dev, report, "mamba2-370m")
    ssd_kernel_checks(dev, errs["ssd_scan"])
    timings["ssd_scan"] = ssd_timing(SSM_FULL, dev, cfg, name, report)
    del model
    torch.cuda.empty_cache()

    # the MoE serving path
    cfg, model = serving_model(MOE_FULL, dev)
    serving_path(MOE_TINY | dict(smoke=False), dev, cfg, model, {})  # warm-up
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts, generated, cache = serving_path(MOE_FULL, dev, cfg, model, report)
    by_path["moe_serving"] = moe_launches = read_launches("moe_serving")
    check_moe_launches(MOE_FULL, cfg, report, moe_launches)
    report["moe_serving"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the moe_serving path: {moe_launches}; max memory allocated "
        f"{report['moe_serving']['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    serving_profile(MOE_FULL, dev, cfg, model, prompts, cache, generated, report)
    moe_drop_shares(MOE_FULL, dev, cfg, model, prompts, cache, generated, report)
    layer0_attention_vs_plain(MOE_FULL, dev, cfg, model, prompts, cache, report, errs)
    batcher_decode_checks(MOE_FULL, dev, cfg, report, errs["flash_decode"])
    del generated, cache
    torch.cuda.empty_cache()
    errs["moe_gemm"] = []
    gemm_args = layer0_moe_vs_plain(MOE_FULL, dev, cfg, model, prompts, report,
                                    errs["moe_gemm"])
    del prompts
    serving_small_vs_cpu(dev, report, "granite-moe-1b-a400m")
    moe_kernel_checks(dev, report, errs["moe_gemm"])
    timings["moe_gemm"] = moe_timing(dev, name, report, *gemm_args)
    del gemm_args, model
    torch.cuda.empty_cache()

    # the tile-order path of morton_matmul
    t0 = time.perf_counter()
    reset_launches()
    morton_path(MM_FULL, dev, report)
    by_path["morton_matmul"] = read_launches("morton_matmul")
    report["morton_matmul"]["padded_copies"] = mm_ops.padded_copies
    log(f"launches on the morton_matmul path: {by_path['morton_matmul']}; bf16 operands "
        f"copied for TMA: {mm_ops.padded_copies}")
    errs["morton_matmul"] = []
    morton_kernel_checks(dev, report, errs["morton_matmul"])
    timings["morton_matmul"] = morton_timing(dev, name, report)
    report["morton_matmul"]["phase_s"] = time.perf_counter() - t0
    log(f"morton_matmul phase {report['morton_matmul']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # the rest of the dense family at full width
    for sc in DENSE_FULL:
        cfg, model, prompts, generated, cache = dense_family_path(sc, dev, report)
        by_path[sc["key"]] = counts = read_launches(sc["key"])
        check_dense_launches(sc, cfg, counts)
        report[sc["key"]]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        log(f"launches on the {sc['key']} path: {counts}; max memory allocated "
            f"{report[sc['key']]['max_memory_allocated'] / 2 ** 30:.3f} GiB")
        serving_profile(sc, dev, cfg, model, prompts, cache, generated, report)
        layer0_attention_vs_plain(sc, dev, cfg, model, prompts, cache, report, errs)
        del model, prompts, generated, cache
        torch.cuda.empty_cache()
    for arch in ("gemma-2b", "minitron-8b", "llama3-405b"):
        serving_small_vs_cpu(dev, report, arch)

    # the hybrid family at full width (phase 26)
    t0 = time.perf_counter()
    cfg, model, prompts, generated, cache = hybrid_path(HYBRID_FULL, dev, report)
    by_path["hybrid_serving"] = counts = read_launches("hybrid_serving")
    check_hybrid_launches(HYBRID_FULL, cfg, counts)
    report["hybrid_serving"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the hybrid_serving path: {counts}; max memory allocated "
        f"{report['hybrid_serving']['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    serving_profile(HYBRID_FULL, dev, cfg, model, prompts, cache, generated, report)
    del prompts, generated
    pre_args, dec_args = hybrid_kernel_checks(HYBRID_FULL, dev, cfg, model, cache, report, errs)
    timings["hybrid"] = hybrid_timings(dev, cfg, name, pre_args, dec_args,
                                       report["hybrid_serving"]["window"])
    del pre_args, dec_args, cache
    torch.cuda.empty_cache()
    scan_timing(HYBRID_FULL, dev, cfg, report)
    del model
    torch.cuda.empty_cache()
    hybrid_prefill_vs_stepping(dev, report)
    serving_small_vs_cpu(dev, report, "recurrentgemma-2b")
    report["hybrid_serving"]["phase_s"] = time.perf_counter() - t0
    log(f"phase 26 {report['hybrid_serving']['phase_s']:.1f} s")

    # the encoder-decoder family at full width (phase 27)
    t0 = time.perf_counter()
    cfg, model, frames, generated, cache = encdec_path(ENCDEC_FULL, dev, report)
    by_path["encdec_serving"] = counts = read_launches("encdec_serving")
    check_encdec_launches(ENCDEC_FULL, cfg, counts)
    report["encdec_serving"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log(f"launches on the encdec_serving path: {counts}; max memory allocated "
        f"{report['encdec_serving']['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    encdec_profile(ENCDEC_FULL, dev, cfg, model, cache, generated, report)
    pre_args, cross_args = encdec_kernel_checks(ENCDEC_FULL, dev, cfg, model, frames, cache,
                                                report, errs)
    timings["encdec"] = encdec_timings(dev, name, pre_args, cross_args)
    del model, frames, generated, cache, pre_args, cross_args
    torch.cuda.empty_cache()
    encdec_small_vs_cpu(dev, report)
    report["encdec_serving"]["phase_s"] = time.perf_counter() - t0
    log(f"phase 27 {report['encdec_serving']['phase_s']:.1f} s")

    # training at full width: the dense, MoE and ssm families (phases 16-19),
    # B2's gradient where the window binds and at Sq != Skv, the hybrid and
    # encoder-decoder families (phases 28-29)
    for tc in TRAINS_FULL:
        if tc is HYBRID_TRAIN_FULL:
            t0 = time.perf_counter()
            attention_grad_checks(ATTN_GRAD_FULL, dev, report, errs["flash_attention"])
            torch.cuda.empty_cache()
            log(f"flash_attention gradient checks {time.perf_counter() - t0:.1f} s")
        training_phase(tc, dev, name, report, by_path)
    # the patch frontend's smoke model with its embeddings, card against CPU
    training_small_vs_cpu(dev, report, "internvl2-76b")

    # checkpoint and restart of each family's smoke model on the card
    t0 = time.perf_counter()
    for arch in RESTART_ARCHS:
        restart_vs_uninterrupted(dev, report, arch)
    report["restart"]["phase_s"] = time.perf_counter() - t0
    log(f"restart phase {report['restart']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # arctic-480b serving at full width, 2 of 35 layers (phase 30)
    by_path["arctic_serving"], timings["arctic"] = arctic_path(ARCTIC_FULL, dev, report, errs)
    # the dry run on the production meshes, in a child process (phase 31)
    dry_run_phase(DRYRUN_FULL, report)

    rank4 = report["timeseries"]["gather"]
    rows = [dict(name="cutout_gather", max_abs_err=gather_err, ms=tile["ms"],
                 plain_ms=tile["plain_ms"], bound_ms=tile["bound_ms"],
                 bound_by="bytes", library_ms=None, rank4_ms=rank4["ms"],
                 rank4_plain_ms=rank4["plain_ms"], rank4_bound_ms=rank4["bound_ms"])]
    arctic = timings["arctic"]
    new_shapes = {"flash_attention": {"window_prefill": timings["hybrid"]["window_prefill"],
                                      "encoder_prefill": timings["encdec"]["encoder_prefill"],
                                      "arctic_prefill": arctic["arctic_prefill"]},
                  "flash_decode": {"window_decode": timings["hybrid"]["window_decode"],
                                   "cross_decode": timings["encdec"]["cross_decode"],
                                   "arctic_decode": arctic["arctic_decode"]},
                  "moe_gemm": {"arctic_prefill": arctic["moe_prefill"],
                               "arctic_decode": arctic["moe_decode"]}}
    for n in ("flash_attention", "flash_decode", "ssd_scan", "moe_gemm", "morton_matmul"):
        t = timings[n]
        extra = {}
        if n in new_shapes:
            extra["new_shapes"] = {k: {f: v[f] for f in ("shape", "ms", "plain_ms", "bound_ms",
                                                         "bound_by", "library_ms")}
                                   for k, v in new_shapes[n].items()}
        rows.append(dict(name=n, max_abs_err=max(errs[n]), ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"], library_ms=t["library_ms"], **extra))
    rows = [dict(name=r["name"], route=KERNELS[r["name"]]["route"],
                 source=KERNELS[r["name"]]["source"],
                 replaces=KERNELS[r["name"]]["replaces"],
                 launches=sum(c[r["name"]] for c in by_path.values() if r["name"] in c),
                 **{k: v for k, v in r.items() if k != "name"},
                 launches_by_path={pth: c[r["name"]] for pth, c in by_path.items()
                                   if r["name"] in c}) for r in rows]
    report["kernels"] = rows
    report["wall_s"] = time.perf_counter() - t_start
    log(f"smoke wall time {report['wall_s']:.1f} s (from the build on)")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
