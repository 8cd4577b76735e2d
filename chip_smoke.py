#!/usr/bin/env python3
"""Drive harmony_tpu_torch on one NVIDIA GPU and hold its CUDA kernels to their
plain PyTorch versions.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code.
As each phase ends a ``phase <name>: <s> s`` line gives its host seconds
(since the previous such line):

1. Build: compile every ``harmony_tpu_torch/csrc/*.cu`` (one ``nvcc`` per
   source, all at once) and print the card's name and power limit. Print the
   registers and shared memory of the tensor-core flash kernels, and fail if
   ``ptxas`` reports spills for one of them at D = 64 or D = 128.
2. Kernels: run gather_rows (K1), segment_sum_rows (K2) and
   weighted_histogram (K3) on the card at the shapes of the Wide&Deep job
   below and at edge cases. K1 must be byte-identical to its plain version
   (16-, 8-, 4- and 2-byte units, aligned and not; f32, bf16, f16 and int32
   tables); K2 and K3 must give the
   same bits as their plain version on the CPU (``index_add_``, index order)
   and as themselves run twice, on every case (the slice, out-of-range ids,
   64 heavy rows, one row, Zipf-skewed ids, W = 1, W = 300, 4.5M rows,
   300,000 ids, bf16 and f16 weights, and for K3 the trio's fold: NMF's init,
   [4096, 256] f32 into 4096 rows). Time each kernel, its plain version
   and one PyTorch library call (a yardstick that the port never calls): call
   ms by CUDA events (the host's enqueue included), device ms by
   torch.profiler (every kernel a call launches), and the wrapper's host us
   per call; and the fold on the skewed cases.
2b. Flash attention: K4 (forward), K5a (dK/dV) and K5b (dQ) against their
   plain versions at the LM's shape ([32, 8, 1024, 64] bf16, causal, blocks
   128) and at edge cases (f32 operands, not causal, D = 16 and 128, one
   block, a nonzero LSE cotangent, block_k 64 with D = 32, Sq != Sk, block_k
   32 with D = 16, block_k 16, the bf16 tiles the tensor cores do not
   take: 100 keys and 256, and bench-vit's attention, [128, 12, 197, 64]
   bf16 and [8, 12, 197, 64] f32, not causal, blocks 197: a partial last q
   tile and key chunk; phase 3u's: the ring's chunk [2, 8, 1024, 64] f32 at
   block 256, causal and not, with an LSE cotangent, and a2a's [2, 4, 2048,
   64] bf16 at block 256, causal); in each case all three must take the route its
   table row names (``mma``, the tensor cores, for bf16 at block_k 16, 32, 64
   or 128; ``simt`` for f32 and the other bf16 tiles), and each run twice must
   agree bit for bit. Timed (call ms by CUDA events, device ms by
   torch.profiler) beside their plain versions, their first (scalar) versions
   and ``scaled_dot_product_attention``'s forward and backward, at the LM's
   shape, at bench-vit's and at phase 3u's (on ``simt``).
2c. The hash table (``table/hashtable.py``): its ops on the card against the
   port's CPU route on the same inputs, byte for byte (slot keys, values,
   returned values, overflow counts): same-slot races, overflow, an exhausted
   probe budget, each update mode on float deltas, put of -0.0, and
   bench-fm-hash's table at full width.
2d. The push-route autotune at bench-widedeep's push: the device ms of the
   ``mxu`` (K3) and ``sparse`` (K2) arms and the route chosen (``mxu``
   unless ``sparse`` is faster by more than the autotune's margin), first
   while another tenant keeps the card busy on its own stream, then on an
   idle card; the second choice is cached for the jobs below that leave
   ``HARMONY_PUSH_VIA`` unset (3g, 5).
3. The slice: ``python -m harmony_tpu_torch.cli run widedeep`` at the
   ``bench-widedeep`` size of ``benchmarks/apps.py`` (vocab 100,000, 16 slots,
   emb 16, hidden 128, 32,768 examples in 8 mini-batches) for 2 epochs on the
   card on the ``mxu`` route (``HARMONY_PUSH_VIA=mxu``), with the launch
   counts set to 0 just before and read just after (K1 and K3 once a step,
   plus the comm probe's: one warm-up and three timed calls each of PULL,
   K1, and PULL+PUSH, K1 and the fold); then the same job on the CPU (plain
   versions), step for step.
3b. The LM at full width: ``cli run lm`` at the size of ``benchmarks/lm.py``
   (vocab 8192, d_model 512, 8 heads, 8 layers, d_ff 2048, max_seq 1024, bf16,
   batch 32 x 1024 tokens) for 2 epochs of 4 steps, launch counts (K4, K5a
   and K5b on the ``mma`` route) read around it; then the same run with
   ``--set attn=blockwise``, step for step.
3c. The ``lm`` preset as shipped (f32, head dim 16, 64 tokens) on the card, on
   the ``simt`` route, and on the CPU, step for step.
3n. ViT: the ``vit`` preset (f32) on the card against the CPU, step for
   step; ``bench-vit``, ViT-B/16 (12 layers, d_model 768, 12 heads, MLP
   3,072, 224 x 224 x 3 images in 16 x 16 patches, 1,000 classes, bf16) on
   1,024 synthetic images in 8 mini-batches for 2 epochs through ``cli run
   vit``, launch counts read around it (K4, K5a and K5b 12 times a step, all
   on ``simt``), the loss finite and falling, then with ``attn=blockwise``
   step for step; samples/s.
3o. The MoE LM: the ``lm`` preset with 4 experts every 2nd block (f32) on
   the card against the CPU; ``bench-lm-moe``, phase 3b's run with 8
   experts in blocks 1, 3, 5 and 7 (capacity factor 1.5, aux weight 0.01),
   launch counts read around it (K4, K5a and K5b on ``mma``), a second run
   bit for bit with each block's dropped share and aux loss recorded, and
   the run with blockwise attention; tokens/s.
3p. Generation: bench-lm trained as phase 3b trains it (the same losses,
   bit for bit), then ``make_generate_fn`` from its weights, batch 32, a
   512-token prompt, 512 new tokens: greedy twice and at temperature 1.0
   twice with one key give the same tokens; prefill ms, decode ms a token,
   tokens/s. The model's f32 copy (blockwise attention): every decode step's
   logits within GEN_F32_REL of the full forward's at that position, and the
   greedy tokens the full forward's argmax except at near-ties (counted).
3d. The BASELINE config-4 trio through ``harmony_tpu_torch.bench``'s
   ``run_concurrent``: MLR, NMF and LDA submitted together to one JobServer on
   the card at ``bench.py``'s full size, a 1-epoch warm-up, then 12 measured
   epochs with the launch counts read around them (K3 once, NMF's init; no
   other kernel); the three must overlap (every job starts before any
   finishes). Then the CPU baseline (scale 0.125, best of two), the trio at
   scale 0.125 for 2 epochs on the card and on the CPU, batch for batch, and
   LDA's assignments on both (its first batch, then after 2 epochs), with an
   int32 ``multi_get`` of LDA's local table (K1) byte-identical to
   ``pull_array``. The measured pass must call no ``data_fn`` and miss
   neither data cache (host arrays, device stacks), and each job must run
   the reference's windows (8 then 4 epochs after the epoch-0 comm probe);
   then each job alone with CUDA's sync debug mode set to raise while each
   window is enqueued: no blocking host copy and no other sync inside a
   window, one drain after it.
3e. The unfused step (``HARMONY_FUSED_STEP=0``) on the Wide&Deep job of
   phase 3, on the mxu and the sparse push routes: losses
   bit-identical to the fused runs of phases 3 and 4, K1 and the route's
   fold once a step each, and the mean PULL, COMP and PUSH seconds.
3f. The async step on ``bench.py``'s MLR job at full size, through the
   JobServer: staleness bound 0 bit-identical to the fused step, bound 1
   with finite losses and a lag of at most 1; samples/s of each.
3g. The prefetch pipeline on the Wide&Deep job with a shuffling provider:
   losses bit-identical with ``input_prefetch`` on and off; under
   torch.profiler the staged batches are ``Memcpy HtoD (Pinned -> Device)``
   copies on a stream that runs none of the steps' kernels; the ring's stall
   and idle seconds.
3h. ``bench-fm-hash`` (``benchmarks/apps.py:68-81``) at full width: an FM
   over a DeviceHashTable of 524,288 slots x 17 f32, ids from the whole
   int32 domain, through the JobServer on the card for 2 epochs, launch
   counts read around it (K1 and K2 once a step, and the comm probe's); the
   loss falls and the overflow count is printed. Then the JobServer's set-up
   of the same job on the card, with CUDA's sync debug mode raising inside
   each fused window (no host sync: the refused-key counts stay on the
   device until the drain), bit-identical to the first card run, and on the
   CPU: slot keys byte-identical, losses within LOSS_ATOL.
3i. Sparse LDA at the trio's width (V 8,192, K 64, 2,048 documents of 128
   tokens): the same, for 2 epochs; the counts, slot keys and assignments
   identical on the card and the CPU.
3j. The ModelAccessor path: FusedSparseStep at bench-widedeep's width
   (PULL K1, PUSH K3) bit-identical to the accessor's unfused loop, and
   accessor_async_step at staleness bound 0 bit-identical to the
   synchronous cycle.
2e. The kernels at this slice's shapes: K3 at bench-gbt's deepest level
   (1,900,544 ids of width 3 into 229,408 rows), K2 at bench-pagerank's add
   fold (~67.9M ids of width 1 into 4,847,571 rows) and K1 at its edge
   gather (8-byte rows), and at shortest path's and connected components'
   (4-byte rows, ~67.9M and ~135.7M ids): the CPU's bits, the same bits run
   twice; timed
   beside the plain versions, ``index_select`` and atomic and deterministic
   ``index_add_``, with the fold's scratch bytes.
3k. GBT: the ``gbt`` preset on the card and on the CPU (trees equal in
   structure, leaf values within GBT_LEAF_ATOL), and in ``hist_mode``
   ``scatter`` on the card (K2 once a level, the same trees bit for bit);
   bench-gbt (XGBoost's hist defaults at HIGGS's shape, 524,288 rows, 16
   rounds) through the JobServer with the launch counts read around it (K3
   once a level, nothing else), the loss falling, a second run bit-identical
   with each step held to the CPU on the card's own inputs (each K3 call
   the plain version's bits, gradients within GBT_GRAD_ATOL, each tree
   equal in structure, leaf values within GBT_LEAF_ATOL), and the same job
   run through on the CPU for GBT_CPU_EPOCHS, reported; samples/s and
   rounds/s.
3l. The Pregel engine: the ``pagerank``, ``shortest-path`` and
   ``connected-components`` presets on the card and on the CPU (distances
   and labels exact, ranks within PR_RTOL); each at bench-pagerank's scale
   (random_graph(4,847,571, 14), SNAP LiveJournal's size) through the
   JobServer, launch counts read around it (K1 once a superstep, K2 once a
   superstep for PageRank), PageRank's rank mass, a second run of each
   bit-identical, each against the same job on the CPU (the same supersteps,
   distances and labels exact, ranks within PR_RTOL; PageRank's comparison
   at PR_CPU_ITERATIONS iterations, shortest path's and components' at
   GRAPH_CPU_SUPERSTEPS supersteps, each cut through its job's config, on
   the card and the CPU); edges/s a superstep.
3m. The ``lasso``, ``addvector`` and ``addinteger`` presets on the card and
   on the CPU: Lasso's losses within LOSS_ATOL, the AddVector and
   AddInteger tables at ``expected_value`` exactly.
3r. Checkpoint chains through the JobServer with a ``chkp_root``: (a)
   bench-fm-hash with a chain entry every epoch and the deferred offline
   evaluation: the evaluations finite and falling, the chain consumed, one
   K1 an entry at the evaluation, and the same chain files restored on the
   CPU bit for bit with evaluations within CHAIN_EVAL_ATOL; (b) bench-widedeep
   (dense), 1 epoch then resumed from its chain to 2: the losses and the
   table the bits of the uninterrupted 2-epoch run; (c) a flipped byte in a
   block of the newest entry (quarantined, the resume falls back one entry to
   the same table) and a torn manifest (quarantined by the scan); (d) bench-lm
   with a chain entry every epoch for LM_CHAIN_EPOCHS epochs and the deferred
   evaluation (K4 on mma, no K5): the snapshot's time on the training thread,
   the background write's MB/s, the synchronous write and restore MB/s at
   CHAIN_IO_THREADS I/O threads, and the epoch seconds with the chain beside
   phase 3b's. The codec that wrote the blocks
   (``blk``, or ``npy`` without the native build) is printed.
3s. Online serving: (a) an in-process JobServer on the card with
   ``serve_tcp(0)`` and a ``chkp_root``; bench-widedeep submitted through
   the CLI's ``submit`` (a chain entry every epoch, SERVE_EPOCHS epochs),
   ``status`` showing it running, ``shutdown`` ending the server; once,
   ``start-jobserver --port 0`` as a process of its own, its ready line
   read and ``shutdown`` over TCP ending it with exit code 0. (b) The read
   storm through ``ServingClient`` while the job trains (8 readers x 20
   reads of 16 keys, 12 from a hot head of 64, seed 20), in four arms
   (batch window 0 or 2 ms x cache 0 or 64 MB): p50/p99 ms, lookups/s,
   batch occupancy, cache hit rate, the gathers (one K1 launch each) and
   K1's device ms a gather; no error frame, every row finite; the job's
   losses the bits of the same job run without readers, and the epoch
   seconds of both. (c) Quiescent tables behind a ServingEndpoint of their
   own, bench-widedeep's dense table and bench-fm-hash's hash table (65,537
   keys over int32), filled from the seed: every row of every arm
   byte-identical to the CPU copy's ``multi_get``, K1 once a gather and no
   other kernel; a 65,536-key lookup byte-identical (round trip ms beside
   K1's device ms), 65,537 keys refused, and a layout announcement and a
   ``multi_update`` (on a side stream behind a spin) each retiring the
   cached rows. (d) Pinned reads of the job's chain bit-identical to the
   entry's ``.blk`` bytes decoded on the CPU, with its epoch and chkp id,
   rolling forward past the pin's 1 s TTL; a pinned read of a hash table's
   chain refused. (e) The bulk loader: a libsvm file at HIGGS's width
   (28 features, 65,536 rows) into a dense table and a value file into
   bench-fm-hash's hash table (generated keys from MIN_KEY), on card and
   CPU byte-identical, records/s; both then served as in (c).
3t. Tables and Dolphin jobs over a mesh of slots (``parallel/mesh.py``): a
   pool of 4 virtual slots on cuda:0, and the real cards where there are two
   or more (else it prints ``"real_mesh": "not run: one card"``). (a) The
   card count and the pools. (b) bench-widedeep's dense table (102,144 x
   17 f32, 256 blocks) on meshes (data 1, model 4) and (2, 2), a replicated
   10-block table of the same rows on (1, 4), and bench-fm-hash's hash table
   (524,288 x 17 slots, 65,537 keys over int32) on (1, 4): pull, the ``mxu``
   and ``sparse`` pushes, pull_all, push_all, multi_get and export_blocks
   byte-identical on the card's mesh, the same mesh of CPU slots and one slot
   of the card, with K1 once on each shard a read touches and the fold once
   on each slot a push writes. (c) A JobServer over the slots: bench-widedeep
   at data_axis 1 (``HARMONY_PUSH_VIA=mxu``, one worker) the bits of phase
   3's run, K1 and K3 once a shard a step and a probe call; at data_axis 2
   the same bits twice and within LOSS_ATOL of phase 3; the config-4 trio
   and bench-fm-hash the bits of phases 3d and 3h; samples/s, and on the
   fused step phase 5's figures (step ms, device busy ms, idle share) for one
   slot and for 4. (d) bench-widedeep's chain on 4 slots: its newest entry's
   ``.blk`` files those of a one-slot run, restored on one slot to the same
   table, and resumed there at epoch 1 to the uninterrupted run's bits. (e)
   On two or more cards, every kernel wrapper called with operands on cuda:1
   while cuda:0 is current gives the bytes it gives on cuda:0. Its
   ``sharded:`` line holds the numbers. ``python3 chip_smoke.py --phase 3t``
   runs the build and this phase alone, held to one-slot runs of its own.
3u. Sequence- and tensor-parallel LM training over a slot mesh, at
   bench_sp's width (``benchmarks/lm.py:159-189``: vocab 8192, d_model 512,
   8 heads, d_ff 2048, bf16, 4 layers, 1024 tokens a sequence shard) on 4
   virtual slots of cuda:0. (a) Ring attention alone on meshes (data 2, seq
   2, model 1) and (1, 4, 1), f32 chunks [2, 8, 1024, 64], causal and not:
   the flash inner (K4/K5a/K5b on ``simt``, n(n+1)/2 launches a row causal,
   n^2 not) against the einsum inner and one-slot full attention, forward
   within FLASH_F32_REL and gradients within RING_GRAD_REL of the largest
   magnitude, the same bits run twice. (b) make_sp_train_step on (2, 2, 1),
   ring, SP_STEPS (2) steps of 4 x 2048 tokens: the losses within LM_BF16_REL of the
   one-slot LM step on the same tokens, and the first within it of the same
   step on 4 CPU slots (SP_CPU_STEPS),
   the same bits run twice, no host sync in a step (CUDA's sync debug mode),
   K4/K5a/K5b 24 a step each. (c) The same with sp_attn="a2a" (16 a step,
   bf16 ``simt`` at block 256). (d) make_parallel_train_step on (1, 2, 2),
   ring and a2a, within LM_BF16_REL of (b). Each with tokens/s, step ms,
   device busy ms, idle share and the top kernels. (e) On four or more
   cards, (b)-(d) on a mesh of four cards give the virtual slots' bits and
   the same launches (``"auto"`` is the flash inner there), and each ring
   hop's peer copy is timed. Its ``sp:`` line holds the numbers.
   ``python3 chip_smoke.py --phase 3u`` runs the build and this phase alone.
3v. Pipeline- and expert-parallel LM training and ViT's data-parallel step
   on 4 virtual slots of cuda:0, PV_STEPS (2) steps each. (a) make_pp_train_step at
   bench_pp's width (``benchmarks/lm.py:224-254`` at n = 4: the LM of 3u at 8
   layers in 4 stages of 2, batch 32 in 4 microbatches, 1025-token sequences
   so that 1024 tokens tile the flash block), within LM_BF16_REL of the
   one-slot TransformerLM step; K4 64 a step (each application again under
   remat), K5a and K5b 32, all ``mma``. (b) make_ep_train_step at bench_ep's
   width (``:257-291``: 8 experts every 2nd block, capacity 1.5, aux 0.01,
   data 4, batch 32 x 1024), within LM_BF16_REL of make_sp_train_step on
   (data 4, seq 1), which routes each slot's tokens at the same capacity; 32
   of each a step on ``mma``; each MoE block's dropped share. (c) ViT's
   make_train_step over data 4 at bench-vit's config (batch 128), within
   LM_BF16_REL of the one-slot step; 48 of each a step on ``simt``. Each path
   the same bits run twice and no host sync in a step, with tokens/s (samples/s),
   step ms, device busy ms, idle share, device operations a step and the top
   kernels; a PP activation hop's and the EP exchange's copy ms. (d) K4/K5a/K5b
   against their plain versions at the paths' shapes (``[8, 8, 1024, 64]``
   bf16 causal ``mma``, ``[32, 12, 197, 64]`` bf16 not causal ``simt``) and
   timed beside SDPA. (e) On four or more cards, (a)-(c) on the cards give the
   virtual slots' bits and launches, with the copies' ms and each path's step
   ms. Its ``pv:`` line holds the numbers. ``python3 chip_smoke.py --phase
   3v`` runs the build and this phase alone.
3w. The elastic table: tables that move between the slots of a 4-slot pool
   while their jobs train, on 4 virtual slots of the card. (a) bench-widedeep
   through a JobServer of 2 executors with ``optimizer="add_one_server"``
   (2 -> 3 owners at the job's start; 256 blocks over 3 replicate) and a
   scripted grow-then-shrink ETPlan through PlanExecutor, the worker held
   at steps 5 and 11 until each lands (3 -> 4 owners, then the first
   executor drained: 4 -> 3, the compute slot moves); (b) bench-fm-hash (K1
   and K2 on the hash table) through a JobServer of 3 with
   ``delete_one_server`` (3 -> 2) and the same plan; (c) during (a) a serving
   reader (the endpoint's cached live gathers, on a stream of its own), every
   read of which must be the rows of some committed step, in order (per-step
   snapshots of the unmoved run). Each moved job's 16 losses the bits of the
   unmoved run and within LOSS_ATOL of the same moved job on 4 CPU slots.
   For each move: blocks and bytes moved and copied on their slot, host ms
   of the reshard, device ms of its copies (events around them, behind a
   spin kernel so the host's enqueue is not timed), and the step ms (device
   intervals between steps) before and after it. (d) K1, K2 and K3 on
   bench-widedeep's and bench-fm-hash's tables resharded 2 -> 3 -> 4 -> 1 ->
   2 slots, byte-identical to the same on CPU slots. (e) On four or more
   cards, (a) and (b) on the cards give the virtual slots' bits. Its
   ``elastic:`` line holds the numbers; ``python3 chip_smoke.py --phase 3w``
   runs the build and this phase alone.
3x. The rest of the slot mesh, on 4 virtual slots of the card. (a)
   bench-pagerank, shortest path and connected components at LiveJournal's
   scale through a JobServer of 4 executors: the vertex and message tables
   sharded over the 4 slots, K1 once a shard a superstep and K2 once a shard
   for PageRank's add fold, each job's vertex values the bits of phase 3l's
   one-slot runs (``--phase 3x`` alone makes its own); supersteps, superstep
   ms, edges/s, and a profiled PageRank run's device busy ms and idle share a
   superstep and the all-gather's device ms. (b) The trio's NMF and LDA,
   sparse LDA at the trio's width, bench-gbt and the lasso preset at
   data_axis 2 on (2, 2) through a JobServer, twice (the same bits), against
   the same jobs on one slot: LDA's counts and assignments bit for bit,
   GBT's trees as partitions of their batches, NMF's and Lasso's losses
   within DX_LOSS_RTOL x max(1, |loss|); samples/s beside the one slot's;
   no step cuts a batch not staged for its rows. (c) On four or more cards,
   (a) and (b) on the cards give the virtual slots' bits, profiled
   data-axis runs of NMF and bench-widedeep copy no batch-sized array
   between cards, and bench-widedeep's data_axis 2 samples/s beside PR 14's
   88,410. Its ``dp:`` line holds the numbers; ``python3 chip_smoke.py
   --phase 3x`` runs the build and this phase alone.
3y. The multi-process pod: ``python -m harmony_tpu_torch.cli start-pod`` in
   two processes sharing cuda:0 over gloo (a leader and a follower, one slot
   each; on four or more cards four processes, one card each over NCCL),
   jobs submitted over TCP. (a) bench-widedeep (phase 3's job, EPOCHS
   epochs, ``HARMONY_PUSH_VIA=mxu``, one worker) with its table sharded over
   the processes: every process's batch losses phase 3's one-slot bits, and
   each process's own K1 and K3 launches (read around the job in that
   process) once a step plus its comm probe's; step ms, samples/s and the
   pull's all-gathers (calls and bytes) by process. (b) bench-fm-hash for one epoch on a DeviceHashTable sharded
   over the processes: phase 3h's first epoch's bits, K1 and K2 once a step
   plus the probe's. (c) (a) and (b) submitted together (share-all): the
   leader's dispatch walls overlap, each gives its solo bits, and the pod
   units each took are recorded. (d) bench-pagerank at LiveJournal's scale,
   POD_PR_ITERATIONS iterations: every process's vertex values phase 3l's
   one-slot run of as many iterations (a SHA-256 of their bytes), K1 and K2
   once a superstep; superstep ms and the all-gathers of the shards' states
   and votes; then (a) again in the warm processes, for its step ms and
   all-gathers (the first run pays each process's first kernel and library
   loads and the communicator's set-up). (e) The all-gather alone in fresh
   processes joined the same way,
   at (a)'s and (d)'s sizes: host ms a call, the card's tensor handed to
   the backend as the pod hands it. The processes are killed in a ``finally``; a failure prints the
   tail of their logs. Its ``pod:`` line holds the numbers; ``python3
   chip_smoke.py --phase 3y`` runs the build, the one-slot runs it is held
   to and this phase alone.
3z. Tables that move between the pod's processes, on a pod of two slots a
   process (two processes sharing cuda:0 over gloo, four slots; on four or
   more cards four processes over NCCL, two slots of its own card each).
   (a) bench-widedeep over MOVE_EPOCHS epochs, unmoved, then moved by four
   ``cli pod-reshard`` plans (run in this process), tier-1's: at epoch 9 the
   last executor drains onto executor-0, at 11 a block grows back onto it,
   at 13 it drains again, and a drain of the second last executor at 13,
   which would leave the last process owning nothing, is skipped. The first
   three change the table's owners, so blocks cross processes mid-training.
   Every process's batch losses are the unmoved run's and the one-slot run's
   bits, each applies and records the plans alike, its side of each
   exchange (``plan_moves``: blocks and bytes sent and received) is what
   the two layouts give, and K1 and K3 launch once to twice a step (one or
   two local shards) plus the probe's. The moved job sleeps
   MOVE_START_LAG_S on the host before its first epoch, so the plans reach
   it at epoch 0 (the smallest legal plan epoch is 9). (b) The same for
   bench-fm-hash (its DeviceHashTable; K1 and K2). (c) bench-widedeep's
   table (256 blocks of 399 x 17 f32) in fresh processes of a slot each:
   drained onto process 0's executor and grown back over every process,
   over tcp and then over files; each process's shards are the one-slot
   table's bytes (SHA-256) after each move, and its wire bytes its moved
   blocks times ``block_nbytes``. (d) A move-once optimizer of this
   script's own (``MoveOncePodOptimizer``) through the pod's plan channel on
   bench-widedeep over OPT_EPOCHS epochs: it drains the last executor,
   ``reconfigs`` 1, one plan applied in every process with the bytes it
   moved, the unmoved and one-slot bits. (e) A move's cost from (c): host
   ms, the transport's seconds, bytes and MB/s by leg, the copies' host
   seconds and device ms; (a)'s moves in training by process (seconds,
   bytes); and (a)'s step ms before and after the first plan beside 3y's
   warm step. Its ``pod moves:`` line holds the numbers; ``python3
   chip_smoke.py --phase 3z`` runs the build, its one-slot runs and this
   phase alone.
3pc. Checkpoint chains on the pod: two processes sharing cuda:0 over gloo
   (on four or more cards four processes over NCCL, a card each), a slot a
   process, their chains under one shared ``HARMONY_POD_CHKP_ROOT``. (a)
   bench-widedeep (PC_WD_EPOCHS epochs) and bench-fm-hash (PC_FM_EPOCHS)
   with an entry every epoch, after an unchained bench-widedeep run: every
   process's losses the one-slot run's bits, every entry's block files and
   checksums the one-slot chain entry's of its epoch byte for byte (their
   SHA-256 printed), and the blocks each process staged exactly its own by
   ``block_owners``, every block once; by entry and process the blocks and
   bytes staged, the synchronous snapshot's ms on the training thread, the
   write's ms and MB/s; step ms with and without the chain (the unchained
   run again once the chains have run: a process's first job is slow). (b)
   bench-widedeep chained for PC_RESUME_AT epochs, then resumed from its
   chain to PC_WD_EPOCHS: the losses and the last entry the uninterrupted
   run's, and a pod entry restored in this process on one slot the one-slot
   table's bits. (d) bench-widedeep with PC_EVAL_WORKERS workers, a chain
   and ``offline_model_eval``: at the pod's shutdown (every process exits 0,
   the pod not broken) one metric dict an entry, held to this process's
   one-slot evaluation of the same entries (the bits, else PC_EVAL_ATOL).
   (c) bench-widedeep's table in fresh processes of a slot each, a pod
   checkpoint with ``recovery_retain`` on, then ``restore_partial`` onto the
   same grant (each process reads nothing) and onto the grant rotated by one
   process (each reads exactly its new shard's blocks, ``bytes_read`` their
   count times 27,132): the shards byte-exact, the read MB/s. K1-K3 are read
   around each job in its own process. Its ``pod chains:`` line holds the
   numbers; ``python3 chip_smoke.py --phase 3pc`` runs the build and this
   phase alone.
3el. Elastic recovery on the pod: ``cli start-pod`` in two processes on
   cuda:0 over gloo (on four or more cards four over NCCL, a card each), a
   slot a process, chains under a shared root, the beacon every
   EL_HB_PERIOD s and confinement after EL_HB_TIMEOUT s (the only settings
   changed, with the epochs). bench-widedeep uncut (256 blocks of 27,132 B)
   with an entry every epoch and ``user.elastic_shrink``. (a) Kill, then
   shrink (``pod_carve:1``, fillers on the other processes): a
   ``HARMONY_FAULT_PLAN`` ``worker.step`` rule crashes the victim's process
   (exit code 86) at epoch EL_CRASH_EPOCH; the same submission finishes on a
   survivor (two attempts, one ``elastic_shrink``, nothing auto-resumed),
   its restore reading every block (6,945,792 B). (b) Silence, shrink,
   re-grow: after a warm-up job (a process's first job is slow; it gives the
   split epoch's cadence), the victim over the last two processes, a
   ``pod.heartbeat`` ``skip`` rule muting the last one until the shrunk
   attempt has begun (``el_end_mute`` spends the rule's count in its shared
   state file), the victim's epochs from the measured cadences
   (``el_split_plan``); the shrink's
   restore reads exactly the lost half (128 blocks, 3,472,896 B; the other
   128 from the survivor's recovery cache), the re-grow reads nothing on the
   survivor and 128 blocks on the returning process, three attempts, the
   pod's whole event arc. Both: the losses and the final chain entry the
   uninterrupted one-slot run's bits, and the clocks of each recovery
   (detection, the fence's lead, planning, ``restore_partial`` ms and MB/s,
   from the loss to the new attempt's first step, step ms before and
   after). K1-K3 are read around each attempt in its own process. Its ``pod
   elastic:`` line holds the numbers; ``python3 chip_smoke.py --phase 3el``
   runs the build and this phase alone.
3pd. A data axis whose rows lie in different processes: ``cli start-pod``
   in two processes on cuda:0 over gloo, two slots each (on four or more
   cards four over NCCL, a card each), and jobs at ``data_axis`` 2 on
   (data 2, model 2): on one card each data row in its own process, on four
   each row over two processes, which read its model shards across both.
   (a) (or (b) on four cards) phase 3x (b)'s LDA, sparse LDA, GBT and
   Lasso (its NMF and bench-widedeep are (d)'s, whose epochs before the
   first plan stand for these runs), DX_EPOCHS epochs each, on trainers
   that keep the SHA-256 of each block
   of the model and local tables each process owns: every process's
   per-batch losses and the blocks joined over the processes are the
   one-process data-2 run's on 4 virtual slots of cuda:0, bit for bit;
   each process computed its own rows (its report's ``data_rows``) and
   restaged no batch; the all-gathers' calls and bytes a step by process,
   in all and by caller (the comm probe, the row exchange, the rows'
   reads), the step ms by process, bench-widedeep's samples/s. (c) bench-widedeep at data 2
   chained every epoch for PD_RESUME_AT epochs, then resumed to
   PD_CHAIN_EPOCHS: every entry the one-process data-2 chain's byte for
   byte, and the losses the uninterrupted run's. K1-K3 are read around each
   job in its own process, and each must have run in every process. (d) On
   a pod of PD_MOVE_SLOTS (2) slots a process (on four cards a second pod),
   bench-widedeep, the trio's NMF and sparse LDA at data 2 over every
   executor, each moved by POD_RESHARD plans (``pd_plans``) at epochs 9
   (a block between the two slots of row 0: the rows kept), 11 (the last
   executor drained: data 1, one row over every process) and 13 (a block
   back: data 2 again): every process's per-batch losses, applied plans and
   joined blocks those of the one-process run on as many virtual slots of
   cuda:0 with the same plans at the same epochs, every replica of every
   block its owner's bytes, no batch restaged, the rows computed by epoch;
   by process each move's host ms, transport s and bytes, the all-gathers
   by caller and the step ms of every epoch. (e) Submitted with (d)'s
   jobs, bench-widedeep at data 2 with the script's
   ``MoveOncePodOptimizer`` (the last executor drained: data 1) through the
   pod's plan channel: one applied plan, alike in every process, and the
   bits of the one-process run that replays it. (f) The same pod's last
   job (its fault rule armed from the pod's start, ``pd_kill_env``):
   bench-widedeep at data 2 over every slot with a chain entry every epoch
   and ``elastic_shrink``, the last process crashed (exit code 86) at epoch
   PD_KILL_EPOCH; the same
   submission finishes on the survivors (their mesh keeps data 2) with the
   uninterrupted one-process run's bits, each survivor's restore reading
   exactly the blocks ``pd_kill_reads`` predicts (none on one card: process
   0 owned every block). K1-K3 are read around each of (d)-(f)'s jobs in its
   own process (the path pod-data-moves) and must have run in every
   process. Its ``pod data rows:`` line holds the numbers;
   ``python3 chip_smoke.py --phase 3pd`` runs the build and this phase alone.
3ha. The control plane's HA: two replicas, ``cli start-jobserver`` with
   ``HARMONY_HA_LOG_DIR`` (a HA_LEASE_S s lease) and a chain root shared, one
   executor each, on cuda:0 (on two or more cards the standby on card 1, so
   the chain written on one card resumes on another). Replica A takes the
   lease; B stands by, and the card's free memory must not drop by a CUDA
   context (HA_STANDBY_MB) while it does (nvidia-smi in a container may
   list none of its processes). bench-
   widedeep (HA_EPOCHS epochs, an entry every epoch, on a trainer that
   writes its run's kernel launches, ``chip_smoke:HaCountedWideDeep``) goes
   to ``CommandSender(addrs=[A, B])``; a ``worker.step`` ``crash`` rule,
   carried by ``HARMONY_FAULT_PLAN`` into A only, kills A at epoch
   HA_CRASH_EPOCH. B must win the lease, replay the log, re-arm the same
   submission with ``resume_from_chain`` and finish it, the client's WAIT
   following the failover: B's per-batch losses and its final entry the
   uninterrupted one-slot run's bits (``el_kill_one_slot``, 3el (a)'s
   yardstick too: the same job, an entry every epoch), its STATUS leader at epoch 2 with one ``leader_takeover`` of the
   job, and its launches K1 once a step and twice a probe call, K3 once each,
   nothing else (the kernels line's ``ha-takeover`` path). Its ``ha:`` line
   holds death to LEADER seconds, ``replay_ms``, the entries replayed, the
   jobs re-armed, the lease's epoch and stats, the epoch resumed from, the
   log's appends, fsyncs (``group_commits``) and append seconds, and B's
   step ms beside the uninterrupted run's; ``python3 chip_smoke.py --phase
   3ha`` runs the build and this phase alone.
4. The sparse push route (``HARMONY_PUSH_VIA=sparse``): the Wide&Deep job
   of phase 3, which folds its pushes with K2.
5. Where a step's time goes: a steady epoch of the Wide&Deep job on the host
   clock, and one under ``torch.profiler`` for the device's busy time by kernel
   (the port's own kernels summed over their launches: the fold is two).
5b. The same for the full-width LM.
5c. Phase 3d's measured pass again (``run_concurrent``, full size, 12 epochs)
   under torch.profiler: the device's busy time and idle share over the pass,
   within each job's training span and where MLR trains alone (if it
   does); the host-to-device copies' share of it, and their count and bytes
   by kind from the profile's Chrome trace; and the top kernels.
5d. The same for a bench-fm-hash step and a sparse LDA step, with the
   device's operations (kernels, copies, fills) a step.
5e. The same for a bench-gbt step, a bench-pagerank superstep and a step of
   the lasso preset.
5f. The same for a bench-vit step, a bench-lm-moe step and one decode step
   of bench-generate.
6. A ``kernels`` JSON line: ``launches`` sums each kernel's launches over
   the main paths, each read with the counts set to 0 just before it
   (``launches_by_path``: bench-widedeep, bench-lm, bench-vit, bench-lm-moe,
   bench-generate, bench-trio,
   bench-fm-hash, sparse-lda-hash, fused-sparse-step, bench-gbt,
   bench-pagerank, bench-shortest-path, bench-connected-components,
   bench-widedeep-2-workers, pagerank-beside-mlr, chain, serving: the
   reads of 3s (c) and (e), K1 only; sharded: phase 3t (c)'s bench-widedeep
   at data_axis 1, the trio and bench-fm-hash on 4 slots; sp-ring, sp-a2a
   and 3-axis: phase 3u (b)-(d), SP_STEPS steps each; pp, ep and vit-dp: phase 3v
   (a)-(c), PV_STEPS steps each; elastic: phase 3w (a)-(c) on the card, the moved
   jobs and the reader; pregel-sharded and dp-local: phase 3x (a) and the
   first data-axis run of each job of (b); pod: phase 3y (a), (b) and (d),
   summed over the processes, each process's counts read around its job;
   pod-moves: phase 3z's pod jobs, (a), (b) and (d) moved and unmoved, read
   the same way; pod-chains: phase 3pc's pod jobs, read the same way;
   pod-elastic: phase 3el's victims, each attempt in each process that
   reported it, read the same way; pod-data-rows: phase 3pd (a)-(c)'s pod
   jobs, read the same way; pod-data-moves: phase 3pd (d)-(f)'s, each
   attempt in each process that reported it;
   ha-takeover: phase 3ha's re-armed job in the successor, read around its
   training);
   K1-K3
   also carry ``device_ms``, ``library_device_ms``,
   ``library_deterministic_device_ms``, ``host_us`` and their timing at
   phase 2e's shapes, K4-K5b their timing at bench-vit's shape and phase
   3u's (``at_sp_shapes``: the ring's f32 chunk, causal and not, with an LSE
   cotangent, and a2a's bf16 attention, all ``simt``) and phase 3v's
   (``at_pv_shapes``); the card's
   name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import faulthandler
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks (NVIDIA data sheet), at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# The H100's L2 (50 MB): a profiled time below the bytes bound is a lost
# record where a call moves more than this (it cannot stay warm in L2).
L2_BYTES = 50e6
BF16_FLOPS = 989e12

# bench-widedeep (benchmarks/apps.py) through the CLI's widedeep preset.
SLICE_ARGS = [
    "run", "widedeep", "--batches", "8",
    "--set", "vocab_size=100000", "--set", "num_slots=16",
    "--set", "emb_dim=16", "--set", "hidden=128", "--set", "step_size=0.1",
    "--data", "n=32768", "--data", "vocab_size=100000", "--data", "num_slots=16",
]
EPOCHS = 2
BATCHES = 8
N_EXAMPLES = 32768

# torch.profiler on the card (an H100 80GB HBM3) drops a prefix of a
# profile's device records: once a process has run for a minute or so, the
# first few kernel records of a profile go missing, by count whatever the
# kernels' lengths, and now and then a whole profile comes back empty. So
# every profile starts with PROFILE_MARKERS tiny marker kernels, whose
# records that loss may take, and ends with one more. A profile is kept only
# if its first record and its last are markers: then nothing of the profiled
# work was dropped at either end. A profile that fails this is taken again,
# up to PROFILE_ATTEMPTS times in all, each retake printed, and then the run
# fails. PROFILE_LOG counts, over the run, the markers each kept profile
# lost, and the retakes. Losses come in runs: a full run has lost 4 profiles
# of one call in a row (three with no record at all), so 8 attempts. Full
# runs have lost all 64 leading markers in 8 profiles in a row, and kept a
# profile whose ends were markers with no record between them: so 256
# markers, and device_kernels takes a profile again when its records are not
# whole calls.
PROFILE_MARKERS = 256
PROFILE_ATTEMPTS = 8
MARKER_KERNEL = "spin_kernel"   # torch.cuda._sleep's kernel
PROFILE_LOG = {"markers_lost": {}, "retakes": 0}

# Per-step losses of two f32 runs of a job that differ only in where their sums
# are taken (cuBLAS against the CPU's matrix products, the card's reductions
# against the CPU's, the flash kernels against the plain blockwise route)
# agree to this, absolutely: f32 keeps ~7 digits, the losses are ~0.69
# (Wide&Deep) and ~4.8 (the lm preset), and 16 or 12 steps of SGD do not
# amplify a last-digit change this far.
LOSS_ATOL = 1e-4
# Unit roundoff of f32: a sum of n terms taken in any order lies within
# (n - 1) * U * sum(|x|) of the exact sum, so two orders lie within twice that.
U_F32 = 2.0 ** -24

# The LM of benchmarks/lm.py:63-66 at batch 32 (:121) through the CLI's lm preset.
LM_ARGS = [
    "run", "lm", "--epochs", "2", "--batches", "4",
    "--set", "vocab_size=8192", "--set", "d_model=512", "--set", "n_heads=8",
    "--set", "n_layers=8", "--set", "d_ff=2048", "--set", "max_seq=1024",
    "--set", "dtype=bfloat16", "--set", "step_size=0.1",
    "--data", "num_seqs=128", "--data", "seq_len=1025", "--data", "vocab_size=8192",
]
LM_LAYERS = 8
LM_STEPS = 8
LM_TOKENS_PER_STEP = 32 * 1024
# bench-vit: ViT-B/16 (Dosovitskiy et al. 2021, Table 1: 12 layers, d_model
# 768, 12 heads, MLP 3,072, patch 16, 224 x 224 x 3, 1,000 classes) in bf16
# through the CLI's vit preset; synthetic class templates at ImageNet's shape
# (ImageNet is not in the repo), 1,024 images in 8 mini-batches of 128, cut to
# 2 epochs. 197 tokens a sequence: K4/K5a/K5b non-causal on the simt route.
VIT_ARGS = [
    "run", "vit", "--epochs", "2", "--batches", "8",
    "--set", "image_size=224", "--set", "patch_size=16", "--set", "num_classes=1000",
    "--set", "channels=3", "--set", "d_model=768", "--set", "n_heads=12",
    "--set", "n_layers=12", "--set", "d_ff=3072", "--set", "dtype=bfloat16",
    "--set", "step_size=0.05", "--data", "n=1024",
]
VIT_LAYERS = 12
VIT_STEPS = 16
VIT_BATCH = 128
# bench-lm-moe: bench-lm with the expert-parallel section's MoE of
# benchmarks/lm.py:272-277 at the repo's four-device layout (moe_experts = 2n =
# 8, moe_every 2), every expert local on one card; capacity factor 1.5 (C =
# 6,144 of 32,768 tokens), aux weight 0.01. Blocks 1, 3, 5 and 7 are MoE.
MOE_ARGS = LM_ARGS + ["--set", "moe_experts=8", "--set", "moe_every=2",
                      "--set", "moe_capacity_factor=1.5", "--set", "moe_aux_weight=0.01"]
MOE_BLOCKS = 4
# bench-generate: bench-lm's model (bf16) as phase 3b trains it, batch 32, a
# 512-token prompt from make_lm_data, 512 new tokens, greedy and at temperature
# 1.0; the cache 2 x [8, 32, 8, 1024, 64] bf16.
GEN_BATCH = 32
GEN_PROMPT = 512
GEN_NEW = 512
# The f32 copy of the model: each decode step's logits against the full
# forward's at that position. Both are f32 sums of the same products in
# another order (the cache's masked softmax against blockwise attention), over
# 8 layers of d 512: 1e-4 of the largest logit (or of 1), ~800 f32 ulps.
GEN_F32_REL = 1e-4
# Flash kernels against their plain versions. bf16 operands: both sides take
# exact products and round p where the TPU does, so their f32 sums differ in
# order only; the outputs are then rounded to bf16, where that difference can
# become one ulp (2**-8 relative), and a p or ds rounded differently moves a
# sum by about as much: allow two ulps at the largest magnitude. f32 operands:
# reordering alone, over at most 1024 terms: 2 * 1024 * 2**-24 = 2**-12 of the
# largest magnitude.
FLASH_BF16_REL = 2.0 ** -7
FLASH_F32_REL = 2.0 ** -12
# Per-step losses of the full-width LM with flash attention against the same
# run with blockwise attention: both round activations to bf16 (8 significant
# bits), but flash rounds p to bf16 before PV where blockwise keeps it f32, so
# attention outputs differ by about one bf16 ulp and the step's later bf16
# roundings carry that on. Allowed: 2**-7 of the loss (two bf16 ulps).
LM_BF16_REL = 2.0 ** -7


# The per-phase clock: ``clock(name)`` prints ``phase <name>: <s> s``, the
# host seconds since the previous phase ended (the script's start for the
# first). Measurement only.
_PHASE_T = [time.perf_counter()]


def clock(name: str) -> None:
    now = time.perf_counter()
    print(f"phase {name}: {now - _PHASE_T[0]:.1f} s", flush=True)
    _PHASE_T[0] = now


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, samples: int = 25, inner: int = 10) -> float:
    """Call time: the median over ``samples`` of the mean time of ``inner``
    back-to-back calls, by CUDA events, the host's enqueue included (a kernel
    of a few microseconds ends before the host has enqueued the next call, so
    this is then mostly the wrapper's host cost). The table stays warm in L2,
    as it does between the job's steps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def profiled(run, cpu: bool = False):
    """torch.profiler (CUDA activity, and the host's with ``cpu``) over one
    ``run()``, between the marker kernels; returns the profile and its
    device events in start order, the markers taken out. A profile whose
    first or last device record is not a marker is taken again (see
    PROFILE_MARKERS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(PROFILE_MARKERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [MARKER_KERNEL in e.name for e in events]
        if marks.count(True) >= 2 and marks[0] and marks[-1]:
            lost = PROFILE_MARKERS + 1 - marks.count(True)
            PROFILE_LOG["markers_lost"][lost] = PROFILE_LOG["markers_lost"].get(lost, 0) + 1
            return prof, [e for e, m in zip(events, marks) if not m]
        PROFILE_LOG["retakes"] += 1
        ends = [events[i].name[:40] for i in (0, -1)] if events else []
        print(f"chip_smoke: profile {attempt} of {PROFILE_ATTEMPTS} lost device records "
              f"at an end ({len(events)} records, {marks.count(True)} of "
              f"{PROFILE_MARKERS + 1} markers, first and last {ends})",
              file=sys.stderr, flush=True)
    fail(f"the profiler lost device records in {PROFILE_ATTEMPTS} profiles")


def device_kernels(fn, calls: int = 100) -> dict:
    """Device time of one call by kernel name: the durations of the kernels
    that torch.profiler records over ``calls`` back-to-back calls, summed
    per name and divided by ``calls``. Every call launches the same kernels,
    so each name's record count must be a multiple of ``calls``."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(calls):
            fn()

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        _, events = profiled(run)
        by_name, count = {}, {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / calls
            count[e.name] = count.get(e.name, 0) + 1
        if by_name and all(n % calls == 0 for n in count.values()):
            return by_name
        PROFILE_LOG["retakes"] += 1
        print(f"chip_smoke: profile {attempt} of {PROFILE_ATTEMPTS} lost records between its "
              f"markers: counts {count} over {calls} calls", file=sys.stderr, flush=True)
    fail(f"the profiler's record counts {count} over {calls} calls: records lost")


def device_ms(fn, calls: int = 100, floor_ms: float = 0.0) -> float:
    """Device time of one call: every kernel it launches, summed (the keyed
    fold launches two). A profile under ``floor_ms`` (a call's bound: the
    time the card needs at least) has lost records between its markers and
    is taken again, up to PROFILE_ATTEMPTS times; the caller checks the
    last against the bound."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        ms = sum(device_kernels(fn, calls).values())
        if ms >= floor_ms:
            return ms
        PROFILE_LOG["retakes"] += 1
        print(f"chip_smoke: profile {attempt} of {PROFILE_ATTEMPTS} gave {ms} ms a call, under "
              f"the bound of {floor_ms} ms: records lost", file=sys.stderr, flush=True)
    return ms


def host_us(fn, calls: int = 1000, batch: int = 100) -> float:
    """The host's microseconds per call: a perf_counter over ``calls``
    enqueues, taken ``batch`` at a time between two synchronises, so that the
    card's queue of launches (about a thousand) never fills and holds the host
    back: the fold launches two kernels a call."""
    fn()
    seconds = 0.0
    for _ in range(calls // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        seconds += time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / (calls // batch * batch) * 1e6


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, type and bytes (so -0.0 differs from 0.0 and NaNs compare)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(as_int), b.view(as_int))


def run_cli(argv):
    """``python -m harmony_tpu_torch.cli`` in this process; returns the one
    worker's result from the printed JSON line."""
    from harmony_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"cli {' '.join(argv)} returned {rc}")
    line = buf.getvalue().strip().splitlines()[-1]
    (worker,) = json.loads(line)["result"]["workers"].values()
    return worker


def reset_counts(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0
        for route in getattr(w, "launches_by_route", {}):
            w.launches_by_route[route] = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# -- phase 2: the kernels against their plain versions ------------------------


def slice_operands(dev, batch: int = N_EXAMPLES // BATCHES):
    """The table and the flat row ids of one step of the slice: the keys the
    first mini-batch (of ``batch`` examples) pulls and pushes, located as
    TableSpec.pull locates them."""
    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer, make_synthetic
    from harmony_tpu_torch.table.table import TableSpec

    trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16,
                              hidden=128, step_size=0.1)
    spec = TableSpec(trainer.model_table_config())
    ids, _ = make_synthetic(N_EXAMPLES, 100000, 16)
    batch_ids = torch.as_tensor(ids[:batch], device=dev)
    keys = trainer.pull_keys((batch_ids, None))
    b, o = spec.partitioner.locate(keys)
    idx = (b * spec.block_size + o).to(torch.int32).contiguous()
    rng = np.random.default_rng(0)
    width = spec.value_shape[0]
    table = torch.as_tensor(
        rng.standard_normal((spec.num_rows, width), dtype=np.float32), device=dev)
    return table, idx


def fold_tolerance(x: torch.Tensor, idx: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Elementwise bound on the gap between two f32 keyed folds of ``x`` taken
    in different orders: 2 * (n - 1) * U * sum(|x|) per destination row."""
    from harmony_tpu_torch.ops.sparse import segment_sum_rows_plain

    abs_sum = segment_sum_rows_plain(x.abs().double(), idx, num_rows)
    ones = torch.ones((idx.shape[0], 1), dtype=torch.float64, device=x.device)
    count = segment_sum_rows_plain(ones, idx, num_rows)
    return 2.0 * (count - 1).clamp_min(0) * U_F32 * abs_sum


def fold_cases(dev, idx, R, W):
    """The keyed fold's cases, each (name, x, ids, rows, exact against the
    card's atomic index_add_), and the cases only K3 takes (bf16 and f16
    weights). Two cases take the kernels' paths for large inputs: a table of
    more rows than the bucket kernel keeps cursors for in shared memory
    (8,192 tiles of 512), and more chunks of ids than a rows block has
    threads (512 chunks of 512)."""
    N = idx.shape[0]
    g = torch.Generator(device=dev).manual_seed(3)
    ints = torch.randint(-8, 9, (N, W), generator=g, device=dev).float()
    floats = torch.randn((N, W), generator=g, device=dev)
    wild = torch.randint(-5000, R + 5000, (N,), generator=g, device=dev, dtype=torch.int32)
    dup = torch.randint(0, 64, (N,), generator=g, device=dev, dtype=torch.int32)
    one_row = torch.zeros((N,), dtype=torch.int32, device=dev)
    zipf = torch.as_tensor(np.random.default_rng(5).zipf(1.1, N) % R, dtype=torch.int32,
                           device=dev)
    wide = torch.randn((min(N, 4096), 300), generator=g, device=dev)
    tall = 4_500_000
    many = 300_000
    both = [
        ("slice, integer-valued", ints, idx, R, True),
        ("slice, float", floats, idx, R, False),
        ("negative and out-of-range ids", ints, wild, R, True),
        ("heavy duplicates (64 rows), integer-valued", ints, dup, R, True),
        ("heavy duplicates (64 rows), float", floats, dup, R, False),
        ("one row (all ids on row 0), float", floats, one_row, R, False),
        ("Zipf(1.1) ids, float", floats, zipf, R, False),
        ("N=0", floats[:0], idx[:0], R, True),
        ("W=1", floats[:, :1].contiguous(), idx, R, False),
        ("W=300", wide, idx[: wide.shape[0]] % 5000, R, False),
        (f"{tall:,} rows (cursors in device memory)", floats[:, :2].contiguous(),
         torch.randint(-10, tall + 10, (N,), generator=g, device=dev, dtype=torch.int32),
         tall, False),
        (f"{many:,} ids (586 chunks)", torch.randn((many, 3), generator=g, device=dev),
         torch.randint(0, R, (many,), generator=g, device=dev, dtype=torch.int32), R, False),
    ]
    # the trio's one fold: NMF's init multi_update, bench.py's full size
    nmf_init = np.random.default_rng(0).uniform(0, 0.1, (4096, 256)).astype(np.float32)
    k3_only = [
        ("bf16 weights, integer-valued", ints.to(torch.bfloat16), idx, R, True),
        ("bf16 weights, float", floats.to(torch.bfloat16), idx, R, False),
        ("f16 weights, float", floats.to(torch.float16), idx, R, False),
        ("NMF's init: [4096, 256] f32, ids 0..4095 into 4096 rows",
         torch.as_tensor(nmf_init, device=dev),
         torch.arange(4096, dtype=torch.int32, device=dev), 4096, True),
    ]
    return both, k3_only


def check_kernels(dev):
    """Each kernel against its plain version on the card at the slice's shape
    and at edge cases: K1 byte-identical; K2 and K3 the same bits as the plain
    version on the CPU (index_add_ in index order), the same bits when run
    twice, and within the f32 reordering bound of the card's atomic
    index_add_ (exact for integer values). Returns the table, the slice's ids
    and per-kernel max |kernel - plain on the card| over the cases."""
    from harmony_tpu_torch.ops.histogram import (
        weighted_histogram,
        weighted_histogram_plain,
    )
    from harmony_tpu_torch.ops.sparse import (
        gather_rows,
        gather_rows_plain,
        segment_sum_rows,
        segment_sum_rows_plain,
    )

    table, idx = slice_operands(dev)
    R, W = table.shape
    N = idx.shape[0]
    g = torch.Generator(device=dev).manual_seed(1)
    err = {"gather_rows": 0.0, "segment_sum_rows": 0.0, "weighted_histogram": 0.0}

    # K1: byte-identical to table[clamp(idx)]
    wild = torch.randint(-5000, R + 5000, (N,), generator=g, device=dev,
                         dtype=torch.int32)
    bf16_64 = torch.randn((R, 64), generator=g, device=dev).to(torch.bfloat16)
    k1_cases = [
        ("slice f32", table, idx),
        ("negative and out-of-range ids", table, wild),
        ("slice bf16", table.to(torch.bfloat16), idx),
        ("N=0", table, idx[:0]),
        ("W=1", table[:, :1].contiguous(), idx),
        ("W=128 (16-byte units, a warp a row)", torch.randn((4096, 128), generator=g,
                                                            device=dev), wild % 5000 - 400),
        ("bf16 W=64 (16-byte units)", bf16_64, idx),
        ("a view one row in, W=17 (4-byte units)", table[1:], wild),
        ("bf16 W=64, a view one element in (2-byte units)",
         bf16_64.view(-1)[1:1 + (R - 1) * 64].view(R - 1, 64), idx),
        ("int32 W=128 (LDA's local table)",
         torch.randint(-1, 64, (R, 128), generator=g, device=dev, dtype=torch.int32), wild),
        ("f16 W=17 (2-byte units)", table.to(torch.float16), idx),
    ]
    for name, t, i in k1_cases:
        got = gather_rows(t, i)
        torch.cuda.synchronize()
        check(same_bits(got, gather_rows_plain(t, i)),
              f"gather_rows {name}: not byte-identical to the plain version")
    print(f"phase 2: gather_rows byte-identical on {len(k1_cases)} cases", flush=True)

    both, k3_only = fold_cases(dev, idx, R, W)
    for kname, kernel, plain, args, cases in (
        ("segment_sum_rows", segment_sum_rows, segment_sum_rows_plain,
         lambda x, i, rows: (x, i, rows), both),
        ("weighted_histogram", weighted_histogram, weighted_histogram_plain,
         lambda x, i, rows: (i, x, rows), both + k3_only),
    ):
        for name, x, i, rows, exact in cases:
            got = kernel(*args(x, i, rows))
            again = kernel(*args(x, i, rows))
            torch.cuda.synchronize()
            check(got.shape == (rows, x.shape[1]) and got.dtype == torch.float32,
                  f"{kname} {name}: {tuple(got.shape)} {got.dtype}")
            check(same_bits(got, again), f"{kname} {name}: two runs differ")
            check(same_bits(got.cpu(), plain(*args(x.cpu(), i.cpu(), rows))),
                  f"{kname} {name}: not the same bits as the CPU's index_add_")
            want = plain(*args(x, i, rows))
            gap = (got - want).abs()
            err[kname] = max(err[kname], float(gap.max()) if gap.numel() else 0.0)
            if exact:
                check(torch.equal(got, want), f"{kname} {name}: not exact")
            else:
                tol = fold_tolerance(x.float(), i, rows).float()
                check(bool((gap <= tol).all()),
                      f"{kname} {name}: |kernel - plain| {float(gap.max())} "
                      "over the f32 reordering bound")
        print(f"phase 2: {kname} the same bits as the CPU's index_add_ and as itself "
              f"run twice on {len(cases)} cases", flush=True)
    launches = weighted_histogram.launches
    try:  # the library owns the fold's limits: a width past 2**21 is refused unlaunched
        weighted_histogram(idx[:1], torch.zeros((1, 2 ** 21 + 1), device=dev), R)
    except ValueError:
        check(weighted_histogram.launches == launches, "a refused fold counted a launch")
    else:
        fail("weighted_histogram took a width past 2**21")
    return table, idx, err


def time_kernels(dev, table, idx):
    """Per kernel at the slice's shape: call ms (CUDA events, the host's
    enqueue included), device ms (torch.profiler, every kernel of a call), the
    plain version's and one library call's, the wrapper's host us per call,
    and the bound: the larger of bytes moved over HBM bandwidth and f32
    operations over the f32 peak, for this input (each input read once, each
    output written once). The folds have two library calls: ``index_add_`` as
    it runs by default (atomic adds, whose order changes from run to run) and
    under ``torch.use_deterministic_algorithms(True)``, which computes the
    folds' function, a fixed-order sum. Then the fold's call and device ms on
    the skewed cases of phase 2."""
    from harmony_tpu_torch.ops.histogram import (
        weighted_histogram,
        weighted_histogram_plain,
    )
    from harmony_tpu_torch.ops.sparse import (
        gather_rows,
        gather_rows_plain,
        segment_sum_rows,
        segment_sum_rows_plain,
    )

    R, W = table.shape
    N = idx.shape[0]
    g = torch.Generator(device=dev).manual_seed(2)
    deltas = torch.randn((N, W), generator=g, device=dev)
    idx64 = idx.long()

    def bound(nbytes, nops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def timed(kernel, plain, library):
        return dict(ms=time_ms(kernel), device_ms=device_ms(kernel), plain_ms=time_ms(plain),
                    library_ms=time_ms(library), library_device_ms=device_ms(library),
                    host_us=host_us(kernel))

    rows_read = int(torch.unique(idx).numel())
    out = {}
    b, by = bound(N * 4 + rows_read * W * 4 + N * W * 4, 0)
    out["gather_rows"] = dict(
        timed(lambda: gather_rows(table, idx), lambda: gather_rows_plain(table, idx),
              lambda: torch.index_select(table, 0, idx64)),
        bound_ms=b, bound_by=by)

    def index_add():
        return torch.zeros((R, W), device=dev).index_add_(0, idx64, deltas)

    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        deterministic = dict(library_deterministic_ms=time_ms(index_add),
                             library_deterministic_device_ms=device_ms(index_add))
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    b, by = bound(N * W * 4 + N * 4 + R * W * 4, N * W)
    for name, kernel, plain in (
        ("segment_sum_rows", lambda: segment_sum_rows(deltas, idx, R),
         lambda: segment_sum_rows_plain(deltas, idx, R)),
        ("weighted_histogram", lambda: weighted_histogram(idx, deltas, R),
         lambda: weighted_histogram_plain(idx, deltas, R)),
    ):
        out[name] = dict(timed(kernel, plain, index_add), **deterministic, bound_ms=b,
                         bound_by=by)

    skew = {}
    for name, x, i, _, _ in fold_cases(dev, idx, R, W)[0]:
        if x.shape == deltas.shape and name.endswith("float"):
            skew[name] = dict(ms=time_ms(lambda: weighted_histogram(i, x, R)),
                              device_ms=device_ms(lambda: weighted_histogram(i, x, R)))
    return out, skew


# -- phase 2b: flash attention against its plain versions ----------------------

FLASH_KERNELS = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")


# (name, (B, H, Sq, D), Sk, dtype, causal, block, nonzero LSE cotangent, the route
# K4, K5a and K5b must take: ops/attention.py::flash_route)
FLASH_CASES = [
    ("the LM's shape, bf16, causal", (32, 8, 1024, 64), 1024, torch.bfloat16, True, 128,
     False, "mma"),
    ("f32 operands", (4, 8, 1024, 64), 1024, torch.float32, True, 128, False, "simt"),
    ("causal=False", (4, 8, 1024, 64), 1024, torch.bfloat16, False, 128, False, "mma"),
    ("D=16, the lm preset's shape, f32", (16, 4, 64, 16), 64, torch.float32, True, 64, False,
     "simt"),
    ("D=128", (4, 4, 512, 128), 512, torch.bfloat16, True, 128, False, "mma"),
    ("one block (S=128)", (8, 8, 128, 64), 128, torch.bfloat16, True, 128, False, "mma"),
    ("nonzero LSE cotangent", (4, 8, 256, 64), 256, torch.bfloat16, True, 128, True, "mma"),
    ("block_k=64, D=32", (4, 8, 512, 32), 512, torch.bfloat16, True, 64, False, "mma"),
    ("Sq != Sk, causal=False", (4, 8, 512, 64), 1024, torch.bfloat16, False, 128, False,
     "mma"),
    ("block_k=32, D=16, bf16", (8, 4, 256, 16), 256, torch.bfloat16, True, 32, False, "mma"),
    ("block_k=16, bf16", (4, 8, 256, 64), 256, torch.bfloat16, True, 16, False, "mma"),
    ("an odd tile, bf16 (the LM at S=100)", (4, 8, 100, 64), 100, torch.bfloat16, True, 100,
     False, "simt"),
    ("the default block_k=256, bf16", (2, 8, 1024, 64), 1024, torch.bfloat16, True, 256,
     False, "simt"),
    # bench-vit's attention: ViT-B/16's 197 tokens, the default blocks clamped to 197
    # (a partial last q tile and key chunk, 84.7 KB of shared memory for K4)
    ("bench-vit's shape, bf16, not causal", (128, 12, 197, 64), 197, torch.bfloat16, False,
     197, False, "simt"),
    ("bench-vit's tiles at f32", (8, 12, 197, 64), 197, torch.float32, False, 197, False,
     "simt"),
    # phase 3u's routes: the ring's flash inner (bench_sp's chunk, q pre-scaled and k/v
    # in f32, the default blocks clamped to the chunk, a nonzero LSE cotangent from the
    # merge) and a2a's attention (4 of 8 heads over the whole 2048-token sequence)
    ("the ring's chunk, f32, causal", (2, 8, 1024, 64), 1024, torch.float32, True, 256,
     True, "simt"),
    ("the ring's chunk, f32, not causal", (2, 8, 1024, 64), 1024, torch.float32, False, 256,
     True, "simt"),
    ("a2a's attention, bf16, causal", (2, 4, 2048, 64), 2048, torch.bfloat16, True, 256,
     False, "simt"),
]
VIT_FLASH_CASE = FLASH_CASES[-5]
SP_FLASH_CASES = FLASH_CASES[-3:]


def flash_operands(dev, shape, dtype, seed, g_lse=False, sk=None):
    """q, dO [B, H, Sq, D], k, v [B, H, Sk, D], the LSE cotangent (zero unless
    asked) and the scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kv_shape = shape[:2] + (sk or shape[2],) + shape[3:]
    q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in (shape, kv_shape, kv_shape, shape))
    glse = (torch.randn(shape[:-1], generator=g, device=dev) if g_lse
            else torch.zeros(shape[:-1], device=dev))
    return q, k, v, do, glse, shape[-1] ** -0.5


def mma_build_report(report: str):
    """Registers, spills and dynamic shared memory of each tensor-core flash
    kernel (by its template's head dim and key tile) from nvcc's -Xptxas -v
    report of csrc/flash_attention_mma.cu."""
    import re

    from harmony_tpu_torch.ops import cuda_lib

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?:\s|$)",
                      line)
        if m:
            k = re.search(r"(flash_(?:forward|backward_dkv|backward_dq)_mma_kernel)ILi(\d+)E"
                          r"(?:Li(\d+)E)?",
                          m.group(1))
            name = (k.group(1), int(k.group(2)), int(k.group(3) or 0)) if k else None
            continue
        if name is None:
            continue
        entry = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    codes = {"flash_forward_mma_kernel": 0, "flash_backward_dkv_mma_kernel": 1,
             "flash_backward_dq_mma_kernel": 2}
    for (kernel, d, bk), entry in out.items():
        entry["shared_bytes"] = cuda_lib.call(
            "harmony_flash_mma_shared_bytes", codes[kernel], d, bk)
    return out


def check_flash_kernels(dev, cases=FLASH_CASES):
    """K4, K5a and K5b against their plain versions on every case of
    ``cases`` (FLASH_CASES unless given), each on the route the case names and
    the same bit for bit when run again. Returns each kernel's max |kernel -
    plain| over the cases."""
    from harmony_tpu_torch.ops import attention as A

    err = {"flash_forward": 0.0, "flash_backward_dkv": 0.0, "flash_backward_dq": 0.0}

    def same_bits(a, b):
        return torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))

    def compare(kernel, name, case, got, want, dtype):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{kernel} {case}: {name} {tuple(got.shape)} {got.dtype}")
        gap = float((got.float() - want.float()).abs().max())
        rel = FLASH_BF16_REL if dtype == torch.bfloat16 and name != "lse" else FLASH_F32_REL
        tol = rel * float(want.float().abs().max())
        check(math.isfinite(gap) and gap <= tol,
              f"{kernel} {case}: {name} |kernel - plain| {gap} > {tol}")
        err[kernel] = max(err[kernel], gap)

    for i, (case, shape, sk, dtype, causal, block, g_lse, route) in enumerate(cases):
        q, k, v, do, glse, scale = flash_operands(dev, shape, dtype, 10 + i, g_lse, sk)
        args = (causal, block, block, scale)
        check(A.flash_route(dtype, shape[-1], block) == route,
              f"{case}: flash_route gives {A.flash_route(dtype, shape[-1], block)}, "
              f"expected {route}")
        wrappers = (A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)
        before = [w.launches_by_route[route] for w in wrappers]
        out, lse = A.flash_forward(q, k, v, *args)
        out2, lse2 = A.flash_forward(q, k, v, *args)
        torch.cuda.synchronize()
        out_p, lse_p = A.flash_forward_plain(q, k, v, *args)
        compare("flash_forward", "out", case, out, out_p, dtype)
        compare("flash_forward", "lse", case, lse, lse_p, dtype)
        delta = (do.float() * out_p.float()).sum(dim=-1) - glse
        dk, dv = A.flash_backward_dkv(q, k, v, do, lse_p, delta, *args)
        dk2, dv2 = A.flash_backward_dkv(q, k, v, do, lse_p, delta, *args)
        dq = A.flash_backward_dq(q, k, v, do, lse_p, delta, *args)
        dq2 = A.flash_backward_dq(q, k, v, do, lse_p, delta, *args)
        torch.cuda.synchronize()
        check([w.launches_by_route[route] for w in wrappers] == [n + 2 for n in before],
              f"{case}: K4/K5a/K5b did not launch on the {route} route")
        check(all(same_bits(a, b) for a, b in
                  ((out, out2), (lse, lse2), (dk, dk2), (dv, dv2), (dq, dq2))),
              f"{case}: K4/K5a/K5b run twice on the same inputs differ")
        dk_p, dv_p = A.flash_backward_dkv_plain(q, k, v, do, lse_p, delta, *args)
        dq_p = A.flash_backward_dq_plain(q, k, v, do, lse_p, delta, *args)
        compare("flash_backward_dkv", "dk", case, dk, dk_p, dtype)
        compare("flash_backward_dkv", "dv", case, dv, dv_p, dtype)
        compare("flash_backward_dq", "dq", case, dq, dq_p, dtype)
        print(f"phase 2b: flash kernels within tolerance on {case} {list(shape)} "
              f"Sk={sk} {str(dtype)[6:]} causal={causal} block={block}, K4/K5a/K5b on "
              f"route {route}, bit-identical when run twice", flush=True)
    return err


def time_flash_kernels(dev, case=FLASH_CASES[0]):
    """ms of each flash kernel, its plain version and the SDPA yardstick at the
    shape of ``case`` (the LM's, unless another is given), and the bound: the
    larger of the bytes over HBM bandwidth and the matrix products' operations
    over the peak of the operands' type (bf16 tensor cores, or f32 outside
    them), counting only the (row, col) pairs the
    causal mask keeps. On the ``mma`` route also the first (scalar) kernels on
    the same operands; on ``simt`` they are the kernels timed."""
    import torch.nn.functional as F

    from harmony_tpu_torch.ops import attention as A
    from harmony_tpu_torch.ops import cuda_lib

    _, shape, sk, dtype, causal, block, g_lse, route = case
    B, H, S, D = shape
    check(sk == S, "the timed flash cases have Sq == Sk")
    q, k, v, do, glse, scale = flash_operands(dev, shape, dtype, 3, g_lse)
    args = (causal, block, block, scale)
    out, lse = A.flash_forward(q, k, v, *args)
    delta = (do.float() * out.float()).sum(dim=-1) - glse
    stream = torch.cuda.current_stream().cuda_stream
    o1, lse1, dk1, dv1, dq1 = (torch.empty_like(t) for t in (out, lse, k, v, q))

    def first_forward():  # the first, scalar kernel on the same bf16 operands
        cuda_lib.launch("harmony_flash_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o1.data_ptr(), lse1.data_ptr(), 1, B * H, S, S, D, block,
                        float(scale), int(causal), stream)

    def first_dkv():
        cuda_lib.launch("harmony_flash_backward_dkv", q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk1.data_ptr(), dv1.data_ptr(), 1, B * H, S, S, D, float(scale),
                        int(causal), stream)

    def first_dq():
        cuda_lib.launch("harmony_flash_backward_dq", q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq1.data_ptr(), 1, B * H, S, S, D, float(scale), int(causal), stream)
    bh, e = B * H, q.element_size()
    pairs = bh * S * (S + 1) // 2 if causal else bh * S * S
    io = bh * S * D * e      # one of q, k, v, dO, O, dQ, dK, dV
    rows = bh * S * 4        # one of lse, delta

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / (F32_FLOPS if dtype == torch.float32 else BF16_FLOPS) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def sdpa_forward():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_forward_backward():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal).backward(do)

    t = dict(samples=10, inner=3)
    sdpa_fwd = time_ms(sdpa_forward, **t)
    sdpa_bwd = time_ms(sdpa_forward_backward, **t) - sdpa_fwd
    # device time (torch.profiler, every kernel of a call): SDPA's backward is
    # its forward + backward less its forward
    sdpa_fwd_dev = device_ms(sdpa_forward, calls=20)
    sdpa_bwd_dev = device_ms(sdpa_forward_backward, calls=20) - sdpa_fwd_dev
    out = {}
    b, by = bound(4 * io + rows, 4 * D * pairs)
    kernel = lambda: A.flash_forward(q, k, v, *args)  # noqa: E731
    out["flash_forward"] = dict(
        ms=time_ms(kernel, **t), device_ms=device_ms(kernel, calls=20),
        plain_ms=time_ms(lambda: A.flash_forward_plain(q, k, v, *args), **t),
        **({"first_version_ms": time_ms(first_forward, **t)} if route == "mma" else {}),
        library_ms=sdpa_fwd, library_device_ms=sdpa_fwd_dev, bound_ms=b, bound_by=by)
    b, by = bound(6 * io + 2 * rows, 8 * D * pairs)
    kernel = lambda: A.flash_backward_dkv(q, k, v, do, lse, delta, *args)  # noqa: E731
    out["flash_backward_dkv"] = dict(
        ms=time_ms(kernel, **t), device_ms=device_ms(kernel, calls=20),
        plain_ms=time_ms(lambda: A.flash_backward_dkv_plain(q, k, v, do, lse, delta, *args),
                         **t),
        **({"first_version_ms": time_ms(first_dkv, **t)} if route == "mma" else {}),
        library_ms=sdpa_bwd, library_device_ms=sdpa_bwd_dev, bound_ms=b, bound_by=by)
    b, by = bound(5 * io + 2 * rows, 6 * D * pairs)
    kernel = lambda: A.flash_backward_dq(q, k, v, do, lse, delta, *args)  # noqa: E731
    out["flash_backward_dq"] = dict(
        ms=time_ms(kernel, **t), device_ms=device_ms(kernel, calls=20),
        plain_ms=time_ms(lambda: A.flash_backward_dq_plain(q, k, v, do, lse, delta, *args),
                         **t),
        **({"first_version_ms": time_ms(first_dq, **t)} if route == "mma" else {}),
        library_ms=sdpa_bwd, library_device_ms=sdpa_bwd_dev, bound_ms=b, bound_by=by)
    return out


# -- phases 3 and 4: the slice --------------------------------------------------


def run_slice():
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    steps = EPOCHS * BATCHES
    # K3 held against the CPU on the job where it does its main work; phase 4
    # takes the sparse route (K2), phase 2d the autotune's choice
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        reset_counts(*wrappers)
        gpu = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS)])
        launches = {w.__name__: w.launches for w in wrappers}
        reset_counts(*wrappers)
        t0 = time.perf_counter()
        cpu = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS), "--device", "cpu"])
        cpu_seconds = time.perf_counter() - t0
        cpu_launches = [w.launches for w in wrappers]
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    losses = gpu["batch_losses"]
    check(len(losses) == steps, f"{len(losses)} step losses, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(gpu["losses"][1] < gpu["losses"][0]
          and sum(losses[BATCHES:]) < sum(losses[:BATCHES]),
          f"loss is not falling: {losses}")
    k1, fold = probe_launches(gpu)
    route = gpu["push_route"]
    check(route == "mxu", f"push route {route}, expected mxu")
    expected = {"gather_rows": steps + k1, "segment_sum_rows": 0,
                "weighted_histogram": steps + fold}
    check(launches == expected,
          f"launches on the card {launches}, expected K1 and K3 once a step and "
          f"{k1} and {fold} in the comm probe")
    print(f"phase 3: card losses {losses}, push route {route}, launches "
          f"{launches} ({k1} of K1 and {fold} of the fold in "
          f"{gpu['comm_probe']['probes']} comm probe), windows {gpu['windows']}",
          flush=True)

    check(not any(cpu_launches), "a kernel launched on the CPU run")
    gap = max(abs(a - b) for a, b in zip(losses, cpu["batch_losses"]))
    check(gap <= LOSS_ATOL, f"card and CPU step losses differ by {gap} > {LOSS_ATOL}")
    print(f"phase 3: CPU losses {cpu['batch_losses']}, max |card - CPU| {gap}",
          flush=True)

    os.environ["HARMONY_PUSH_VIA"] = "sparse"
    try:
        reset_counts(*wrappers)
        sparse = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS)])
        sparse_launches = {w.__name__: w.launches for w in wrappers}
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    k1, fold = probe_launches(sparse)
    check(sparse_launches == {"gather_rows": steps + k1, "segment_sum_rows": steps + fold,
                              "weighted_histogram": 0},
          f"launches on the sparse route {sparse_launches}")
    sgap = max(abs(a - b) for a, b in zip(sparse["batch_losses"], losses))
    check(sgap <= LOSS_ATOL, f"sparse and {route} routes differ by {sgap} > {LOSS_ATOL}")
    print(f"phase 4: sparse-route losses {sparse['batch_losses']}, "
          f"max |sparse - {route}| {sgap}, launches {sparse_launches}", flush=True)

    summary = {
        "steps": steps,
        "examples_per_step": N_EXAMPLES // BATCHES,
        "epoch_seconds": gpu["epoch_seconds"],
        "samples_per_sec": N_EXAMPLES / gpu["epoch_seconds"][-1],
        "cpu_epoch_seconds": cpu["epoch_seconds"],
        "cpu_samples_per_sec": N_EXAMPLES / cpu["epoch_seconds"][-1],
        "cpu_run_seconds": cpu_seconds,
        "max_abs_loss_gap_card_vs_cpu": gap,
        "max_abs_loss_gap_sparse_vs_mxu": sgap,
        "final_loss": losses[-1],
        "push_route": route,
    }
    launches["segment_sum_rows"] += sparse_launches["segment_sum_rows"]
    return launches, summary, gpu, sparse


def probe_launches(result):
    """K1 and fold (K3, or K2 on the sparse route) launches of a keyed job's
    comm probes: each probe calls PULL (K1) and PULL+PUSH (K1, then the fold)
    once to warm up and PROBE_SAMPLES times to time."""
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet

    calls = result["comm_probe"]["probes"] * (1 + WorkerTasklet.PROBE_SAMPLES)
    return 2 * calls, calls


def run_unfused_slice(fused, fused_sparse):
    """Phase 3e: the Wide&Deep job of phase 3 on the unfused step
    (HARMONY_FUSED_STEP=0), on the mxu and the sparse push routes: its losses
    bit-identical to the fused runs of phases 3 and 4, K1 and the route's
    fold launched once a step each (no comm probe on the unfused path), and
    the mean phase seconds."""
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    steps = EPOCHS * BATCHES
    out = {}
    for route, reference, fold in (("mxu", fused, "weighted_histogram"),
                                   ("sparse", fused_sparse, "segment_sum_rows")):
        os.environ["HARMONY_FUSED_STEP"] = "0"
        os.environ["HARMONY_PUSH_VIA"] = route
        try:
            reset_counts(*wrappers)
            unfused = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS)])
            launches = {w.__name__: w.launches for w in wrappers}
        finally:
            os.environ.pop("HARMONY_FUSED_STEP")
            os.environ.pop("HARMONY_PUSH_VIA")
        expected = dict.fromkeys(launches, 0)
        expected.update({"gather_rows": steps, fold: steps})
        check(unfused["step_mode"] == "unfused", f"step mode {unfused['step_mode']}")
        check(launches == expected,
              f"unfused launches on the {route} route {launches}, expected {expected}")
        check(unfused["batch_losses"] == reference["batch_losses"],
              f"unfused losses on the {route} route {unfused['batch_losses']} are not "
              f"bit-identical to the fused {reference['batch_losses']}")
        out[route] = {"launches": launches, "phase_seconds": unfused["phase_seconds"],
                      "epoch_seconds": unfused["epoch_seconds"],
                      "fused_epoch_seconds": reference["epoch_seconds"]}
        print(f"phase 3e: unfused Wide&Deep on the {route} route bit-identical to the "
              f"fused step, launches {launches}, mean phase seconds "
              f"{unfused['phase_seconds']}", flush=True)
    return out


def path_launches(run):
    """``run()`` with every kernel's launch count set to 0 just before it; returns
    its result, the counts just after, and the flash kernels' counts by route."""
    from harmony_tpu_torch.ops import attention as A

    wrappers = all_wrappers()
    reset_counts(*wrappers)
    out = run()
    launches = {w.__name__: w.launches for w in wrappers}
    routes = {w.__name__: dict(w.launches_by_route)
              for w in (A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)}
    return out, launches, routes


def card_against_cpu(argv, phase):
    """A small f32 preset on the card and on the CPU, step for step, within
    LOSS_ATOL; returns the largest gap and the card run's flash launches."""
    card, launches, routes = path_launches(lambda: run_cli(argv))
    cpu, cpu_launches, _ = path_launches(lambda: run_cli(argv + ["--device", "cpu"]))
    check(not any(cpu_launches.values()), f"phase {phase}: a kernel launched on the CPU run")
    gap = max(abs(a - b) for a, b in zip(card["batch_losses"], cpu["batch_losses"]))
    check(all(math.isfinite(v) for v in card["batch_losses"]) and gap <= LOSS_ATOL,
          f"phase {phase}: {argv[1]} card and CPU step losses differ by {gap} > {LOSS_ATOL}")
    check(all(launches[k] > 0 and routes[k]["mma"] == 0 for k in FLASH_KERNELS),
          f"phase {phase}: the f32 preset's flash launches {routes}, expected all on simt")
    return gap, launches


def flash_against_blockwise(argv, losses, phase):
    """The same run with attn=blockwise (no kernel launches), step for step within
    LM_BF16_REL of the loss; returns the blockwise result and the largest gap."""
    blockwise, launches, _ = path_launches(lambda: run_cli(argv + ["--set", "attn=blockwise"]))
    check(not any(launches.values()), f"phase {phase}: a kernel launched on the blockwise run")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, blockwise["batch_losses"]))
    check(rel <= LM_BF16_REL,
          f"phase {phase}: flash and blockwise losses differ by {rel} (relative) > {LM_BF16_REL}")
    return blockwise, rel


def finite_and_falling(losses, steps, what):
    half = steps // 2
    check(len(losses) == steps, f"{what}: {len(losses)} step losses, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"{what}: non-finite loss {losses}")
    check(sum(losses[half:]) < sum(losses[:half]), f"{what}: the loss is not falling {losses}")


def run_lm():
    """Phase 3b: the full-width LM through the CLI with flash attention, launch
    counts read around it, then the same run with blockwise attention."""
    gpu, launches, routes = path_launches(lambda: run_cli(LM_ARGS))
    losses = gpu["batch_losses"]
    finite_and_falling(losses, LM_STEPS, "LM")
    per_path = LM_STEPS * LM_LAYERS
    expected = {"gather_rows": 0, "segment_sum_rows": 0, "weighted_histogram": 0,
                **dict.fromkeys(FLASH_KERNELS, per_path)}
    check(launches == expected, f"LM launches {launches}, expected {expected}")
    check(all(r == {"mma": per_path, "simt": 0} for r in routes.values()),
          f"LM launches by route {routes}, expected all {per_path} on mma")
    print(f"phase 3b: LM losses {losses}, launches {launches}, by route {routes}",
          flush=True)
    blockwise, rel = flash_against_blockwise(LM_ARGS, losses, "3b")
    print(f"phase 3b: blockwise losses {blockwise['batch_losses']}, "
          f"max |flash - blockwise| / |blockwise| {rel}", flush=True)
    half = LM_STEPS // 2
    steady = gpu["epoch_seconds"][-1]
    return launches, {
        "steps": LM_STEPS,
        "tokens_per_step": LM_TOKENS_PER_STEP,
        "epoch_seconds": gpu["epoch_seconds"],
        "tokens_per_sec": half * LM_TOKENS_PER_STEP / steady,
        "step_ms": steady * 1e3 / half,
        "blockwise_epoch_seconds": blockwise["epoch_seconds"],
        "blockwise_tokens_per_sec":
            half * LM_TOKENS_PER_STEP / blockwise["epoch_seconds"][-1],
        "losses": losses,
        "max_rel_loss_gap_flash_vs_blockwise": rel,
    }


def run_lm_preset():
    """Phase 3c: the lm preset as shipped on the card, then on the CPU."""
    from harmony_tpu_torch.ops import attention as A

    flash = (A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)
    reset_counts(*flash)
    card = run_cli(["run", "lm"])
    launches = {w.__name__: w.launches for w in flash}
    steps = len(card["batch_losses"])  # the preset: 3 epochs of 4 steps, 2 layers
    check(steps == 12 and all(n == steps * 2 for n in launches.values()),
          f"lm preset: {steps} steps, launches {launches}")
    check(all(w.launches_by_route == {"mma": 0, "simt": steps * 2} for w in flash),
          "lm preset: K4/K5a/K5b did not take the simt route on f32 operands")
    reset_counts(*flash)
    cpu = run_cli(["run", "lm", "--device", "cpu"])
    check(all(w.launches == 0 for w in flash), "a kernel launched on the CPU run")
    gap = max(abs(a - b) for a, b in zip(card["batch_losses"], cpu["batch_losses"]))
    check(all(math.isfinite(v) for v in card["batch_losses"]) and gap <= LOSS_ATOL,
          f"lm preset: card and CPU step losses differ by {gap} > {LOSS_ATOL}")
    print(f"phase 3c: lm preset card losses {card['batch_losses']}, "
          f"max |card - CPU| {gap}, launches {launches}", flush=True)
    return {"max_abs_loss_gap_card_vs_cpu": gap, "launches": launches}


# -- phases 3n, 3o and 3p: ViT, the MoE LM and generation ------------------------

def run_vit():
    """Phase 3n: the vit preset (f32) on the card against the CPU; bench-vit
    through the CLI with its launch counts read around it (K4, K5a and K5b 12
    times a step on simt), then with blockwise attention, step for step."""
    gap, preset_launches = card_against_cpu(["run", "vit"], "3n")
    gpu, launches, routes = path_launches(lambda: run_cli(VIT_ARGS))
    finite_and_falling(gpu["batch_losses"], VIT_STEPS, "bench-vit")
    per_path = VIT_STEPS * VIT_LAYERS
    expected = {"gather_rows": 0, "segment_sum_rows": 0, "weighted_histogram": 0,
                **dict.fromkeys(FLASH_KERNELS, per_path)}
    check(launches == expected, f"bench-vit launches {launches}, expected {expected}")
    check(all(r == {"mma": 0, "simt": per_path} for r in routes.values()),
          f"bench-vit launches by route {routes}, expected all {per_path} on simt")
    print(f"phase 3n: vit preset card against CPU within {gap}; bench-vit losses "
          f"{gpu['batch_losses']}, launches {launches}, by route {routes}", flush=True)
    blockwise, rel = flash_against_blockwise(VIT_ARGS, gpu["batch_losses"], "3n")
    steady = gpu["epoch_seconds"][-1]
    per_epoch = VIT_STEPS // 2 * VIT_BATCH
    out = {
        "preset_max_abs_loss_gap_card_vs_cpu": gap, "preset_launches": preset_launches,
        "losses": gpu["batch_losses"], "epoch_seconds": gpu["epoch_seconds"],
        "samples_per_sec": per_epoch / steady, "step_ms": steady * 1e3 / (VIT_STEPS // 2),
        "blockwise_epoch_seconds": blockwise["epoch_seconds"],
        "blockwise_samples_per_sec": per_epoch / blockwise["epoch_seconds"][-1],
        "max_rel_loss_gap_flash_vs_blockwise": rel,
    }
    print(f"phase 3n: bench-vit {out['samples_per_sec']:.1f} samples/s (blockwise "
          f"{out['blockwise_samples_per_sec']:.1f}), flash against blockwise within {rel}",
          flush=True)
    return launches, out


def run_moe():
    """Phase 3o: the lm preset with 4 experts (f32) on the card against the CPU;
    bench-lm-moe through the CLI with its launch counts read around it, a second
    run bit for bit with each MoE block's routing recorded (the share of tokens
    dropped, the aux loss), and the run with blockwise attention."""
    from harmony_tpu_torch.models import moe

    preset = ["run", "lm", "--set", "moe_experts=4", "--set", "moe_every=2"]
    gap, preset_launches = card_against_cpu(preset, "3o")
    gpu, launches, routes = path_launches(lambda: run_cli(MOE_ARGS))
    finite_and_falling(gpu["batch_losses"], LM_STEPS, "bench-lm-moe")
    per_path = LM_STEPS * LM_LAYERS
    expected = {"gather_rows": 0, "segment_sum_rows": 0, "weighted_histogram": 0,
                **dict.fromkeys(FLASH_KERNELS, per_path)}
    check(launches == expected, f"bench-lm-moe launches {launches}, expected {expected}")
    check(all(r == {"mma": per_path, "simt": 0} for r in routes.values()),
          f"bench-lm-moe launches by route {routes}, expected all {per_path} on mma")

    route, stats = moe.route, []

    def recorded(x, router, num_experts, capacity):
        r = route(x, router, num_experts, capacity)
        stats.append(torch.stack([(~r.keep).float().mean(), r.aux.detach()]))
        return r

    moe.route = recorded
    try:
        again = run_cli(MOE_ARGS)
    finally:
        moe.route = route
    check(again["batch_losses"] == gpu["batch_losses"],
          f"bench-lm-moe: two runs differ: {gpu['batch_losses']} and {again['batch_losses']}")
    check(len(stats) == LM_STEPS * MOE_BLOCKS,
          f"bench-lm-moe: {len(stats)} routings recorded, expected {LM_STEPS * MOE_BLOCKS}")
    per_step = torch.stack(stats).view(LM_STEPS, MOE_BLOCKS, 2).cpu()
    print(f"phase 3o: moe lm preset card against CPU within {gap}; bench-lm-moe losses "
          f"{gpu['batch_losses']}, the same bits run again; launches {launches}, by route "
          f"{routes}", flush=True)
    blockwise, rel = flash_against_blockwise(MOE_ARGS, gpu["batch_losses"], "3o")
    steady = gpu["epoch_seconds"][-1]
    half = LM_STEPS // 2
    out = {
        "preset_max_abs_loss_gap_card_vs_cpu": gap, "preset_launches": preset_launches,
        "losses": gpu["batch_losses"], "epoch_seconds": gpu["epoch_seconds"],
        "tokens_per_sec": half * LM_TOKENS_PER_STEP / steady, "step_ms": steady * 1e3 / half,
        "dropped_share_by_step_and_block": per_step[:, :, 0].tolist(),
        "aux_by_step_and_block": per_step[:, :, 1].tolist(),
        "blockwise_tokens_per_sec": half * LM_TOKENS_PER_STEP / blockwise["epoch_seconds"][-1],
        "max_rel_loss_gap_flash_vs_blockwise": rel,
    }
    print(f"phase 3o: bench-lm-moe {out['tokens_per_sec']:.0f} tokens/s, dropped share by "
          f"block at the first and last step {per_step[0, :, 0].tolist()} "
          f"{per_step[-1, :, 0].tolist()}, aux {per_step[0, :, 1].tolist()} "
          f"{per_step[-1, :, 1].tolist()}; flash against blockwise within {rel}", flush=True)
    return launches, out


def run_generate(lm_losses):
    """Phase 3p: bench-lm trained as phase 3b trains it (the JobServer's set-up of
    the same job; its losses must be phase 3b's bits), then generation from its
    weights: greedy twice and at temperature 1.0 twice with one key, the same
    tokens each time; prefill ms, decode ms a token, tokens/s. Then the f32 copy
    of the model (blockwise attention): every decode step's logits against the
    full forward's at that position, and the greedy tokens against the full
    forward's stepwise argmax, except at near-ties. Returns the launch counts
    around the generation, the summary, and one decode step for phase 5f."""
    import dataclasses

    from harmony_tpu_torch import cli
    from harmony_tpu_torch.models.generate import (
        cast_params,
        decode_step,
        init_kv_cache,
        make_generate_fn,
        prefill,
    )
    from harmony_tpu_torch.models.pytree_trainer import unravel
    from harmony_tpu_torch.models.transformer import TransformerLM, make_lm_data
    from harmony_tpu_torch.utils import prng

    args = cli.build_parser().parse_args(LM_ARGS)
    entity, worker = job_worker(cli.build_config(args.app, args), "cuda")
    try:
        trained = worker.run()
        trainer = worker.trainer
        flat = trainer._section(worker.ctx.model_table.pull_array(), 0)
    finally:
        entity.cleanup()
    same = trained["batch_losses"] == lm_losses
    check(same, f"phase 3p: the trained LM's losses {trained['batch_losses']} are not "
                f"phase 3b's {lm_losses}")
    params = unravel(flat, trainer._shapes)
    model = trainer.model
    dev = torch.device("cuda")
    prompt = torch.as_tensor(make_lm_data(GEN_BATCH, GEN_PROMPT, 8192, seed=1), device=dev)
    key = prng.PRNGKey(torch.tensor(1, device=dev))
    greedy = make_generate_fn(model, GEN_PROMPT, GEN_NEW)
    sample = make_generate_fn(model, GEN_PROMPT, GEN_NEW, temperature=1.0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def run():
        return [timed(lambda: greedy(params, prompt)) for _ in range(2)] + [
            timed(lambda: sample(params, prompt, key)) for _ in range(2)]

    runs, launches, _ = path_launches(run)
    (g1, _), (g2, greedy_s), (s1, _), (s2, sample_s) = runs
    check(torch.equal(g1, g2), "phase 3p: two greedy generations differ")
    check(torch.equal(s1, s2), "phase 3p: two generations at temperature 1.0 with one key differ")
    check(g1.shape == (GEN_BATCH, GEN_PROMPT + GEN_NEW) and torch.equal(g1[:, :GEN_PROMPT],
                                                                        prompt.int()),
          f"phase 3p: generated {tuple(g1.shape)}, the prompt not kept")
    prefill_s = []
    for _ in range(3):
        cache = init_kv_cache(model.config, GEN_BATCH, dev)
        prefill_s.append(timed(lambda: prefill(model, params, cache, prompt))[1])
    prefill_ms = min(prefill_s) * 1e3
    decode_ms = (greedy_s * 1e3 - prefill_ms) / GEN_NEW

    # the f32 copy: each step's logits against the full forward's
    model32 = TransformerLM(dataclasses.replace(model.config, dtype=torch.float32,
                                                attn="blockwise"))
    with torch.no_grad():
        cache = init_kv_cache(model32.config, GEN_BATCH, dev)
        logits, cache = prefill(model32, params, cache, prompt)
        steps, toks = [logits], []
        positions = torch.arange(GEN_PROMPT, GEN_PROMPT + GEN_NEW, device=dev)
        for j in range(GEN_NEW):
            toks.append(torch.argmax(logits, dim=-1))
            logits, cache = decode_step(model32, params, cache, toks[-1], positions[j:j + 1])
            steps.append(logits)
        seq = torch.cat([prompt.long(), torch.stack(toks, dim=1)], dim=1)
        full = model32.apply(params, seq)[:, GEN_PROMPT - 1:]        # [B, 513, V]
        steps = torch.stack(steps, dim=1)
        gen32 = make_generate_fn(model32, GEN_PROMPT, GEN_NEW)(params, prompt)
        check(torch.equal(gen32, seq.int()),
              "phase 3p: make_generate_fn's f32 tokens differ from its own steps")
        tol = GEN_F32_REL * max(1.0, float(full.abs().max()))
        gap = float((steps - full).abs().max())
        check(math.isfinite(gap) and gap <= tol,
              f"phase 3p: f32 decode logits differ from the full forward's by {gap} > {tol}")
        top2 = torch.topk(full[:, :-1], 2, dim=-1).values
        near_tie = (top2[..., 0] - top2[..., 1]) <= tol
        differ = torch.argmax(full[:, :-1], dim=-1) != seq[:, GEN_PROMPT:]
        check(not bool((differ & ~near_tie).any()),
              "phase 3p: a greedy token differs from the full forward's argmax off a near-tie")
    out = {
        "trained_losses_bit_identical_to_phase_3b": same,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "greedy_tokens_per_sec": GEN_BATCH * GEN_NEW / greedy_s,
        "sampled_tokens_per_sec": GEN_BATCH * GEN_NEW / sample_s,
        "f32_max_abs_logit_gap": gap, "f32_tolerance": tol,
        "f32_near_ties": int(near_tie.sum()), "f32_tokens_off_argmax_at_near_ties":
            int((differ & near_tie).sum()),
    }
    print(f"phase 3p: generation deterministic (greedy, temperature 1.0); f32 decode within "
          f"{gap} of the full forward (limit {tol}), near-ties {out['f32_near_ties']}; "
          f"{json.dumps(out)}", flush=True)

    # one decode step as generate runs it: the weights cast once, position 512
    cast = cast_params(model.config, params)
    cache = init_kv_cache(model.config, GEN_BATCH, dev)
    with torch.no_grad():
        prefill(model, cast, cache, prompt)
    tok, pos = g1[:, GEN_PROMPT], positions[:1]

    def decode_once():
        with torch.no_grad():
            decode_step(model, cast, cache, tok, pos)

    return launches, out, decode_once


# -- phase 3d: the BASELINE config-4 trio ----------------------------------------

TRIO_SCALE = 1.0
BASELINE_SCALE = 0.125
AGREE_EPOCHS = 2
# The trio's per-batch primary metrics, card against CPU at BASELINE_SCALE for
# AGREE_EPOCHS epochs: MLR and NMF within 1e-4 * max(1, |value|) (f32 sums in
# another order: cuBLAS against the CPU's products, the card's reductions
# against the CPU's; the losses are ~5 and ~100-250).
TRIO_REL = 1e-4
# LDA: the card's and the CPU's logs differ in the last bit, so a near-tie can
# flip a draw, and a flip moves later counts. Its first batch's assignments
# must agree on at least 99.99% of tokens, and each epoch's mean
# log-likelihood within 1% of the CPU's.
LDA_FIRST_BATCH_SHARE = 0.9999
LDA_LL_REL = 0.01
# The reference's windows for a 12-epoch job with comm_probe_period 6: the
# epoch-0 probe, then windows of 8 and 4 epochs (the next probe is due at 48).
TRIO_WINDOWS = [8, 4]


def all_wrappers():
    from harmony_tpu_torch.ops import attention as A
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    return (gather_rows, segment_sum_rows, weighted_histogram,
            A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)


def run_trio():
    """Phase 3d: MLR, NMF and LDA submitted together to one JobServer on the
    card through harmony_tpu_torch.bench.run_concurrent, at full size: a
    1-epoch warm-up, then the measured pass with the launch counts read around
    it; then the CPU baseline. Under the JobServer each job runs per-batch
    epochs under TaskUnit admission (the reference's schedule); the fused
    windows are held by trio_windows_without_syncs, outside it. Returns the
    launches, the summary and run_concurrent's jobs."""
    from harmony_tpu_torch import bench

    from harmony_tpu_torch.data import devcache

    wrappers = all_wrappers()
    dev = torch.device("cuda")
    epochs = bench.EPOCHS
    with counted_data_fns() as calls:
        bench.run_concurrent([dev], TRIO_SCALE, job_timeout=600.0, epochs=1)
        warmup_calls = dict(calls)
        calls.clear()
        before = {"device": devcache.stats(), "host": devcache.host_data.stats()}
        reset_counts(*wrappers)
        rate, walls, jobs = bench.run_concurrent([dev], TRIO_SCALE, job_timeout=600.0,
                                                 epochs=epochs)
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in wrappers}
        measured_calls = dict(calls)
    caches = {name: {k: stats[k] - before[name][k] for k in ("hits", "misses")}
              for name, stats in (("device", devcache.stats()),
                                  ("host", devcache.host_data.stats()))}
    windows = {k: j["worker"]["windows"] for k, j in jobs.items()}
    # under the JobServer every job runs per-batch epochs under TaskUnit
    # admission (its windows are batched epochs with one drain)
    fused = {k: j["worker"]["fused_epochs"] for k, j in jobs.items()}
    check(not any(fused.values()), f"fused windows under the JobServer: {fused}")
    check(sum(measured_calls.values()) == 0,
          f"the measured pass called data_fn {measured_calls}")
    check(caches["device"]["misses"] == 0 and caches["host"]["misses"] == 0,
          f"the measured pass missed a data cache: {caches}")
    check(all(w == TRIO_WINDOWS for w in windows.values()),
          f"windows {windows}, expected {TRIO_WINDOWS} for every job")
    print(f"phase 3d: data_fn calls: warm-up {warmup_calls}, measured pass "
          f"{measured_calls}; cache hits and misses over the measured pass {caches}; "
          f"per-batch epochs under TaskUnit admission in windows {windows}; grants "
          f"{json.dumps({k: j['grants'] for k, j in jobs.items()})}", flush=True)
    expected = dict.fromkeys(launches, 0)
    expected["weighted_histogram"] = 1   # NMF's init multi_update
    check(launches == expected, f"trio launches {launches}, expected {expected}")
    batch = {job_id: j["worker"]["batch_losses"] for job_id, j in jobs.items()}
    per_epoch = {job_id: j["worker"]["losses"] for job_id, j in jobs.items()}
    # NMF at these settings (bench.py's) diverges from its second epoch in both
    # packages (tests/test_torch_apps.py::
    # test_nmf_at_the_bench_settings_collapses_in_both_packages): only its
    # first epoch is held finite and falling
    nmf_first = batch["bench-nmf"][:bench.BATCHES]
    for job_id, losses in {**batch, "bench-nmf": nmf_first}.items():
        check(len(losses) == (bench.BATCHES if losses is nmf_first else epochs * bench.BATCHES)
              and all(math.isfinite(v) for v in losses),
              f"{job_id}: {len(losses)} batch metrics, or not finite: {losses}")
    check(per_epoch["bench-mlr"][-1] < per_epoch["bench-mlr"][0] and nmf_first[-1] < nmf_first[0],
          f"MLR's or NMF's first-epoch loss is not falling: {per_epoch}")
    check(per_epoch["bench-lda"][-1] > per_epoch["bench-lda"][0],
          f"LDA log-likelihood is not rising: {per_epoch['bench-lda']}")
    starts = [j["setup_start_s"] for j in jobs.values()]
    ends = [j["end_s"] for j in jobs.values()]
    check(max(starts) < min(ends), f"the jobs did not overlap: starts {starts}, ends {ends}")
    train_overlap = (max(j["train_start_s"] for j in jobs.values())
                     < min(j["train_end_s"] for j in jobs.values()))
    train_spans = {k: [j["train_start_s"], j["train_end_s"]] for k, j in jobs.items()}
    print(f"phase 3d: trio on the card {rate:.1f} samples/s, walls {walls}, "
          f"launches {launches}, every job started before any finished; training "
          f"spans (s from the first submission) {train_spans}, all overlap: "
          f"{train_overlap}", flush=True)
    t0 = time.perf_counter()
    cpu_rate = bench.cpu_baseline_rate(BASELINE_SCALE, epochs)
    summary = {
        "samples_per_sec": rate,
        "data_fn_calls": {"warm_up": warmup_calls, "measured": measured_calls},
        "cache_hits_misses": caches,
        "windows": windows,
        "fused_epochs": fused,
        "grants": {k: j["grants"] for k, j in jobs.items()},
        "comm_probe": {k: j["worker"]["comm_probe"] for k, j in jobs.items()},
        "cpu_rate": cpu_rate,
        "vs_baseline": rate / cpu_rate,
        "cpu_baseline_seconds": time.perf_counter() - t0,
        "epochs": epochs,
        "job_walls_s": walls,
        "steady_epoch_s": bench.steady_epoch_seconds(jobs),
        "epoch_seconds": {k: j["worker"]["epoch_seconds"] for k, j in jobs.items()},
        "spans_s": {k: [j["setup_start_s"], j["train_start_s"], j["train_end_s"], j["end_s"]]
                    for k, j in jobs.items()},
        "training_spans_overlap": train_overlap,
        "per_epoch_metric": per_epoch,
    }
    return launches, summary, jobs


@contextlib.contextmanager
def counted_data_fns():
    """Count the calls of the trio's data generators (resolved by name at
    each job's set-up, so the wrappers are what the entity calls)."""
    from harmony_tpu_torch.apps import lda, mlr, nmf

    calls = {}
    saved = {m: m.make_synthetic for m in (mlr, nmf, lda)}

    def counted(module, fn):
        def wrapper(*args, **kw):
            name = module.__name__.rsplit(".", 1)[-1]
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapper

    for m, fn in saved.items():
        m.make_synthetic = counted(m, fn)
    try:
        yield calls
    finally:
        for m, fn in saved.items():
            m.make_synthetic = fn


def trio_windows_without_syncs():
    """Phase 3d: each trio job alone at full size (its data and stack from the
    caches), outside a JobServer so that it runs the fused windows, with CUDA's
    sync debug mode set to raise while each window is enqueued and cleared for
    its one drain: a window makes no blocking host copy and no other sync. The
    jobs run one after another, on this thread alone, because the mode is
    process-wide. Returns each job's windows, epoch seconds and per-batch
    losses."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    out = {}
    for config in bench.job_configs(TRIO_SCALE, bench.EPOCHS)[0]:
        master = ETMaster(DevicePool([torch.device("cuda")]))
        entity = DolphinJobEntity(config)
        entity.setup(master, [e.id for e in master.add_executors(1)])
        worker = entity.make_worker()
        enqueue = worker._enqueue_fused_window
        drains = []

        def checked(first_epoch, k, enqueue=enqueue, drains=drains):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return enqueue(first_epoch, k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                drains.append(k)

        worker._enqueue_fused_window = checked
        try:
            result = worker.run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            entity.cleanup()
        check(drains == result["windows"] == TRIO_WINDOWS and result["fused_epochs"],
              f"{config.job_id}: windows {drains}, {result['windows']}, fused "
              f"{result['fused_epochs']}")
        out[config.job_id] = {"windows": drains, "epoch_seconds": result["epoch_seconds"],
                              "batch_losses": result["batch_losses"]}
    print(f"phase 3d: every window of each trio job enqueued with no host sync "
          f"(sync debug mode 'error'): {json.dumps(out)}", flush=True)
    return out


def run_async_mlr():
    """Phase 3f: bench.py's MLR job (full size, 12 epochs) alone through the
    JobServer on the fused step, then on the async step at staleness bound 0
    (bit-identical to the fused step) and bound 1 (finite losses, lag at most
    1)."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    config = bench.job_configs(TRIO_SCALE, bench.EPOCHS)[0][0]
    examples = bench.job_configs(TRIO_SCALE, bench.EPOCHS)[1][config.job_id]
    runs = {}
    for name, changes in (("fused", {}),
                          ("bound0", {"async_step": True, "staleness_bound": 0}),
                          ("bound1", {"async_step": True, "staleness_bound": 1})):
        cfg = config.replace(job_id=f"async-{name}",
                             params=config.params.replace(**changes))
        server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
        server.start()
        try:
            (worker,) = server.submit(cfg).result(timeout=600)["workers"].values()
        finally:
            server.shutdown()
        runs[name] = worker
    b0, b1 = runs["bound0"], runs["bound1"]
    check(b0["step_mode"] == b1["step_mode"] == "async", "the async step did not run")
    check(b0["batch_losses"] == runs["fused"]["batch_losses"],
          f"async bound 0 losses {b0['batch_losses']} are not bit-identical to the "
          f"fused step's {runs['fused']['batch_losses']}")
    check(all(math.isfinite(v) for v in b1["batch_losses"])
          and b1["staleness"]["max_lag"] <= 1,
          f"async bound 1: losses {b1['batch_losses']}, {b1['staleness']}")

    def rate(w):
        return examples / (w["train_span"][1] - w["train_span"][0])

    out = {name: {"samples_per_sec": rate(w), "epoch_seconds": w["epoch_seconds"],
                  "phase_seconds": w.get("phase_seconds"),
                  "staleness": w.get("staleness"), "final_loss": w["losses"][-1]}
           for name, w in runs.items()}
    print(f"phase 3f: async MLR bound 0 bit-identical to the fused step; samples/s "
          f"fused {out['fused']['samples_per_sec']:.0f}, bound 0 "
          f"{out['bound0']['samples_per_sec']:.0f}, bound 1 "
          f"{out['bound1']['samples_per_sec']:.0f}; bound 1 staleness "
          f"{b1['staleness']}", flush=True)
    return out


def chrome_trace(prof, name: str) -> list:
    """The profile's trace events, through a Chrome trace written into the
    kernels' build directory (git-ignored) and removed after reading."""
    out_dir = os.path.join(REPO, "harmony_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def event_stream(e: dict):
    args = e.get("args", {})
    return args.get("stream", e.get("tid"))


def run_prefetch():
    """Phase 3g: the Wide&Deep job of phase 3 (full width, 2 epochs) on a
    shuffling provider, through WorkerTasklet with input_prefetch on and off:
    bit-identical losses; under torch.profiler the staged batches are
    `Memcpy HtoD (Pinned -> Device)` copies on a stream that runs none of the
    steps' kernels; the ring's stall and idle seconds."""
    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer, make_synthetic
    from harmony_tpu_torch.config.params import TrainerParams
    from harmony_tpu_torch.dolphin.data import TrainingDataProvider
    from harmony_tpu_torch.dolphin.trainer import TrainerContext
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    arrays = list(make_synthetic(N_EXAMPLES, 100000, 16))

    def run(prefetch):
        trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16,
                                  hidden=128, step_size=0.1)
        table = DenseTable(TableSpec(trainer.model_table_config()), "cuda")
        params = TrainerParams(num_epochs=EPOCHS, num_mini_batches=BATCHES,
                               input_prefetch=prefetch)
        data = TrainingDataProvider(arrays, BATCHES, shuffle_each_epoch=True, seed=5)
        worker = WorkerTasklet("prefetch", TrainerContext(params=params, model_table=table),
                               trainer, data)
        return worker.run()

    off = run(False)
    got = {}
    prof, _ = profiled(lambda: got.update(on=run(True)), cpu=True)
    on = got["on"]
    check(on["batch_losses"] == off["batch_losses"],
          f"losses with prefetch {on['batch_losses']} are not bit-identical to "
          f"those without {off['batch_losses']}")
    events = [e for e in chrome_trace(prof, "prefetch") if e.get("ph") == "X"]
    pinned = [e for e in events if e.get("name") == "Memcpy HtoD (Pinned -> Device)"]
    copy_streams = {event_stream(e) for e in pinned}
    step_streams = {event_stream(e) for e in events
                    if e.get("cat") == "kernel" and "gather_rows" in e.get("name", "")}
    staged = on["input"]["staged"]
    check(staged == EPOCHS * BATCHES and on["input"]["prefetch_hits"] == staged,
          f"prefetch input stats {on['input']}")
    check(len(pinned) >= staged * len(arrays),
          f"{len(pinned)} pinned host-to-device copies for {staged} staged batches")
    check(step_streams and not copy_streams & step_streams,
          f"pinned copies on streams {copy_streams}, the steps' K1 on {step_streams}")
    out = {"input": on["input"], "pinned_copies": len(pinned),
           "copy_streams": sorted(map(str, copy_streams)),
           "step_streams": sorted(map(str, step_streams)),
           "epoch_seconds_on": on["epoch_seconds"], "epoch_seconds_off": off["epoch_seconds"]}
    print(f"phase 3g: prefetch on and off bit-identical; {len(pinned)} pinned copies on "
          f"streams {out['copy_streams']}, the steps on {out['step_streams']}; ring "
          f"stall {on['input']['consumer_stall_sec']} s, producer idle "
          f"{on['input']['producer_idle_sec']} s", flush=True)
    return out


def trio_agreement():
    """Phase 3d: the trio at BASELINE_SCALE for AGREE_EPOCHS epochs on the card
    and on the CPU, per-batch primary metrics compared."""
    from harmony_tpu_torch import bench

    runs = [bench.run_concurrent([torch.device(d)], BASELINE_SCALE, epochs=AGREE_EPOCHS)[2]
            for d in ("cuda", "cpu")]
    card, cpu = ({k: np.array(j["worker"]["batch_losses"]) for k, j in r.items()}
                 for r in runs)
    out = {}
    for job_id in ("bench-mlr", "bench-nmf"):
        rel = float(np.max(np.abs(card[job_id] - cpu[job_id])
                           / np.maximum(1.0, np.abs(cpu[job_id]))))
        check(rel <= TRIO_REL, f"{job_id}: card and CPU batch metrics differ by {rel} "
              f"(relative to max(1, |value|)) > {TRIO_REL}")
        out[f"{job_id}_max_rel_gap"] = rel
    lda_card, lda_cpu = (x["bench-lda"].reshape(AGREE_EPOCHS, -1).mean(axis=1)
                         for x in (card, cpu))
    gap = np.abs(lda_card - lda_cpu)
    check(bool(np.all(gap <= LDA_LL_REL * np.abs(lda_cpu))),
          f"LDA per-epoch log-likelihood: card {lda_card}, CPU {lda_cpu}")
    out.update(lda_epoch_ll_card=lda_card.tolist(), lda_epoch_ll_cpu=lda_cpu.tolist(),
               lda_max_epoch_ll_gap=float(gap.max()),
               lda_max_batch_ll_gap=float(np.max(np.abs(card["bench-lda"]
                                                        - cpu["bench-lda"]))))
    print(f"phase 3d: card against CPU at scale {BASELINE_SCALE}, {AGREE_EPOCHS} epochs: "
          f"{json.dumps(out)}", flush=True)
    return out


def lda_assignments():
    """Phase 3d: LDA's assignments on the card against the CPU at
    BASELINE_SCALE (its first batch, then after AGREE_EPOCHS epochs), and the
    int32 read-back of the card's local table through multi_get (K1)."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.ops.sparse import gather_rows
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    config = bench.job_configs(BASELINE_SCALE, AGREE_EPOCHS)[0][2]
    entities, workers = [], {}
    for d in ("cuda", "cpu"):   # the JobServer's set-up of the job, on each device
        master = ETMaster(DevicePool([torch.device(d)]))
        entity = DolphinJobEntity(config)
        entity.setup(master, [e.id for e in master.add_executors(1)])
        entities.append(entity)
        workers[d] = entity.make_worker()
    first = {}
    for d, w in workers.items():
        w.trainer.init_global_settings(w.ctx)
        w.trainer.on_training_start(w.ctx, 0)
        batch = w._to_device(next(iter(w.data.epoch_batches())))
        with torch.no_grad():
            _, new_local, _ = w.trainer.compute_with_local(
                w.ctx.model_table.pull_array(), w.ctx.local_table.pull_array(), batch,
                w._hyper())
        first[d] = new_local[batch[0].long()].cpu()
    first_share = float((first["cuda"] == first["cpu"]).float().mean())
    check(first_share >= LDA_FIRST_BATCH_SHARE,
          f"LDA's first batch: {first_share} of assignments identical < {LDA_FIRST_BATCH_SHARE}")
    results = {d: w.run() for d, w in workers.items()}
    local_card = workers["cuda"].ctx.local_table
    final = local_card.pull_array().cpu()
    final_share = float((final == workers["cpu"].ctx.local_table.pull_array()).float().mean())
    before = gather_rows.launches
    got = local_card.multi_get(np.arange(config.params.app_params["num_docs"]))
    check(gather_rows.launches == before + 1, "multi_get of the int32 table did not launch K1")
    check(got.dtype == np.int32 and got.tobytes() == final.numpy().tobytes(),
          "multi_get of LDA's int32 local table is not byte-identical to pull_array")
    for entity in entities:
        entity.cleanup()
    out = {"first_batch_identical_share": first_share,
           "final_identical_share": final_share,
           "epoch_ll_card": results["cuda"]["losses"],
           "epoch_ll_cpu": results["cpu"]["losses"]}
    print(f"phase 3d: LDA assignments {json.dumps(out)}; int32 multi_get of "
          f"{got.shape} byte-identical to pull_array (K1)", flush=True)
    return out


# -- the sparse path: hash tables, bench-fm-hash, sparse LDA, the accessor ----

# bench-fm-hash (benchmarks/apps.py:68-81, BASELINE config 5's true shape) at
# full width: the model in a DeviceHashTable of 256 blocks of 2,048 slots x 17
# f32, ids from the whole int32 domain; cut to EPOCHS epochs.
FM_HASH_APP = {"vocab_size": 100_000, "num_slots": 16, "emb_dim": 16,
               "step_size": 0.1, "sparse": True}
FM_HASH_DATA = {"n": N_EXAMPLES, "vocab_size": 100_000, "num_slots": 16}
# sparse LDA at the trio's width (bench.py's LDA with sparse=True): 64 blocks
# of 1,024 slots x 64 f32; cut to AGREE_EPOCHS epochs.
SPARSE_LDA_APP = {"vocab_size": 8192, "num_topics": 64, "num_docs": 2048,
                  "max_doc_len": 128, "sparse": True}
SPARSE_LDA_DATA = {"num_docs": 2048, "vocab_size": 8192, "num_topics": 64,
                   "doc_len": 128}
# bench-fm-hash's table values, card against CPU, after EPOCHS epochs. The
# push folds in the same order on both (K2 against its plain version); the
# deltas differ only where the FM's gradient sums are taken in another order
# (last bits, like the losses under LOSS_ATOL). The values stay below 1 in
# magnitude, where one f32 rounding is at most 6e-8, and 16 steps of such
# deltas stay within 1e-6. Measured: 3.7e-9 on an H100 80GB HBM3 at 700 W.
HASH_VALUE_ATOL = 1e-6


def hash_job(kind: str, epochs: int, **params):
    """The JobConfig of bench-fm-hash (kind "fm") or sparse LDA ("lda");
    ``params`` override its TrainerParams (comm_probe_period 6, as bench's)."""
    from harmony_tpu_torch.config.params import JobConfig, TrainerParams

    app, trainer, app_params, data = {
        "fm": ("widedeep", "FMTrainer", FM_HASH_APP, FM_HASH_DATA),
        "lda": ("lda", "LDATrainer", SPARSE_LDA_APP, SPARSE_LDA_DATA)}[kind]
    return JobConfig(
        job_id=f"bench-{kind}-hash", app_type="dolphin",
        trainer=f"harmony_tpu_torch.apps.{app}:{trainer}",
        params=TrainerParams(**{"num_epochs": epochs, "num_mini_batches": BATCHES,
                                "comm_probe_period": 6, "app_params": app_params,
                                **params}),
        num_workers=1,
        user={"data_fn": f"harmony_tpu_torch.apps.{app}:make_synthetic_sparse",
              "data_args": data})


def job_worker(config, device):
    """The JobServer's set-up of ``config`` (DolphinJobEntity) on ``device``:
    returns the entity (for cleanup) and its worker."""
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    master = ETMaster(DevicePool([torch.device(device)]))
    entity = DolphinJobEntity(config)
    entity.setup(master, [e.id for e in master.add_executors(1)])
    return entity, entity.make_worker()


def windows_without_syncs(worker):
    """Set CUDA's sync debug mode to raise while each fused window of
    ``worker`` is enqueued (cleared for its drain); returns the windows seen."""
    enqueue = worker._enqueue_fused_window
    seen = []

    def checked(first_epoch, k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return enqueue(first_epoch, k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            seen.append(k)

    worker._enqueue_fused_window = checked
    return seen


def check_hash_ops(dev):
    """Phase 2c: the hash table's ops on the card against the port's CPU route
    on the same inputs, byte for byte (slot keys, values, every returned value
    and overflow count): same-slot races between distinct keys and duplicates,
    overflow, an exhausted probe budget, each update mode (add, add_nonneg's
    post, min, max, assign) on float deltas with refused keys, put of -0.0,
    and bench-fm-hash's table at full width (two steps' pulls and pushes of
    65,537 keys). The push folds duplicates with K2 (no float atomics), so
    float deltas give the same bits on both."""
    from harmony_tpu_torch.apps.widedeep import FMTrainer, SPARSE_EXTRA_BASE, make_synthetic_sparse
    from harmony_tpu_torch.config.params import TableConfig
    from harmony_tpu_torch.table.hashtable import MAX_KEY, DeviceHashTable, HashTableSpec

    rng = np.random.default_rng(7)

    def keys_of(n):
        return rng.choice(MAX_KEY, size=n, replace=False).astype(np.int32) + 1

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def run_case(name, ops, max_probes=16, **cfg):
        config = TableConfig(table_id="h", is_ordered=False, sparse=True, **cfg)
        tables = [DeviceHashTable(HashTableSpec(config, max_probes=max_probes), d)
                  for d in (dev, torch.device("cpu"))]
        for op, *args in ops:
            card, cpu = (getattr(t, op)(*args) for t in tables)
            torch.cuda.synchronize()
            same = (card.tobytes() == cpu.tobytes() if isinstance(card, np.ndarray)
                    else card == cpu)
            check(same, f"hash ops {name}: {op} differs on the card and the CPU")
        for a, b in zip(tables[0].state, tables[1].state):
            check(same_bits(a.cpu(), b), f"hash ops {name}: state not byte-identical")
        check(tables[0].overflow_count == tables[1].overflow_count,
              f"hash ops {name}: overflow {tables[0].overflow_count} != "
              f"{tables[1].overflow_count}")
        return {"present": tables[0].num_present(), "overflow": tables[0].overflow_count}

    out = {}
    race = np.arange(24, dtype=np.int32) * 7919 + 13
    race = np.concatenate([race, race[::3], race[5:9]])
    out["races"] = run_case("races", [("multi_update", race, normal(len(race), 4)),
                                      ("multi_get_or_init", race[::-1].copy())],
                            max_probes=32, capacity=32, value_shape=(4,), num_blocks=1)
    over = keys_of(40)
    out["overflow"] = run_case("overflow", [("multi_update", over, normal(40, 4)),
                                            ("multi_get_or_init", over),
                                            ("multi_get", over)],
                               capacity=16, value_shape=(4,), num_blocks=1)
    out["probe budget"] = run_case("probe budget", [("multi_update", keys_of(60), normal(60, 4))],
                                   max_probes=2, capacity=64, value_shape=(4,), num_blocks=2)
    universe = np.concatenate([keys_of(40), [0, -3, 2**31 - 1]]).astype(np.int32)
    for mode in ("add", "add_nonneg", "min", "max", "assign"):
        ops = []
        for _ in range(4):
            k = universe[rng.integers(0, len(universe), 30)]
            ops.append(("multi_update", k, normal(30, 4)))
        ops.append(("multi_get", universe))
        out[mode] = run_case(mode, ops, capacity=64, value_shape=(4,), num_blocks=2,
                             update_fn=mode)
    zeros = np.asarray([[-0.0, 1.5], [0.0, -0.0]], np.float32)
    out["put -0.0"] = run_case("put -0.0", [("multi_put", keys_of(2), zeros)],
                               capacity=64, value_shape=(2,), num_blocks=2, update_fn="assign")
    trainer = FMTrainer(**FM_HASH_APP)
    ids, _ = make_synthetic_sparse(**FM_HASH_DATA)
    steps = []
    per_step = N_EXAMPLES // BATCHES
    for b in range(2):
        k = np.concatenate([ids[b * per_step:(b + 1) * per_step].reshape(-1),
                            [SPARSE_EXTRA_BASE]]).astype(np.int32)
        steps += [("multi_get_or_init", k), ("multi_update", k, normal(len(k), 17) * 0.1)]
    cfg = trainer.model_table_config()
    out["bench-fm-hash"] = run_case(
        "bench-fm-hash", steps, capacity=cfg.capacity, value_shape=cfg.value_shape,
        num_blocks=cfg.num_blocks, update_fn=cfg.update_fn)
    print(f"phase 2c: hash ops byte-identical on the card and the CPU on {len(out)} "
          f"cases: {json.dumps(out)}", flush=True)
    return out


def run_autotune(dev):
    """Phase 2d: the push-route autotune at bench-widedeep's push (67,480 keys
    into 102,144 rows of 17 f32): each arm's device ms and the route chosen,
    first beside a tenant (a thread running 4096 x 4096 f32 products on the
    default stream, as another job of the JobServer does), then on an idle
    card. The idle card's choice is cached for the process, so the jobs that
    leave HARMONY_PUSH_VIA unset find it and make no measurement launches."""
    import threading

    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer
    from harmony_tpu_torch.table import autotune
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16, hidden=128,
                              step_size=0.1)
    table = DenseTable(TableSpec(trainer.model_table_config()), dev)
    nkeys = N_EXAMPLES // BATCHES * 16 + trainer.num_extra_rows
    stop = threading.Event()
    products = [0]

    def tenant():
        a = torch.randn(4096, 4096, device=dev)
        while not stop.is_set():
            for _ in range(4):
                a = a @ a
                a /= a.norm()
            torch.cuda.current_stream(dev).synchronize()
            products[0] += 4

    out = {"keys": nkeys}
    thread = threading.Thread(target=tenant, daemon=True)
    thread.start()
    try:
        while products[0] == 0 and thread.is_alive():
            time.sleep(0.001)
        for when in ("beside_a_tenant", "idle"):
            if when == "idle":
                stop.set()
                thread.join()
            autotune.reset()
            route = autotune.choose_push_route(table.spec, dev, nkeys, table=table)
            (meas,) = autotune.measurements().values()
            check(all(v is not None and math.isfinite(v) and v > 0 for v in meas.values()),
                  f"autotune {when}: an arm was not measured: {meas}")
            check(route == autotune.pick(meas), f"autotune {when} chose {route} over {meas}")
            out[when] = {"route": route, **meas}
            print(f"phase 2d: push-route autotune at bench-widedeep's push ({nkeys} keys), "
                  f"{when.replace('_', ' ')}: {json.dumps(out[when])}", flush=True)
    finally:
        stop.set()
        thread.join()
    check(products[0] > 0, "the tenant ran no product")
    out["tenant_products"] = products[0]
    return out


def hash_path_launches(result, steps):
    """K1 and K2 launches of a hash job: one pull (K1) and one push (K2) a
    step; each comm probe calls PULL (K1) and PULL+PUSH (K1, then K2) once to
    warm up and PROBE_SAMPLES times to time."""
    k1, fold = probe_launches(result)
    return {"gather_rows": steps + k1, "segment_sum_rows": steps + fold,
            "weighted_histogram": 0}


def run_hash_job(kind: str, epochs: int):
    """Phases 3h (bench-fm-hash) and 3i (sparse LDA): the job through the
    JobServer on the card with the launch counts read around it; then the
    JobServer's set-up of the same job on the card (CUDA's sync debug mode
    raising inside each fused window) and on the CPU, compared: the card's
    two runs bit for bit, the slot keys byte for byte, the overflow counts,
    and for LDA the counts and assignments exactly, for FM the losses within
    LOSS_ATOL."""
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
    from harmony_tpu_torch.parallel.mesh import DevicePool

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    phase = {"fm": "3h", "lda": "3i"}[kind]
    config = hash_job(kind, epochs)
    steps = epochs * BATCHES
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        reset_counts(*wrappers)
        t0 = time.perf_counter()
        (card,) = server.submit(config).result(timeout=600)["workers"].values()
        seconds = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
    finally:
        server.shutdown()
    losses = card["batch_losses"]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"{config.job_id}: step metrics {losses}")
    if kind == "fm":
        check(card["losses"][-1] < card["losses"][0]
              and sum(losses[BATCHES:]) < sum(losses[:BATCHES]),
              f"{config.job_id}: loss is not falling: {losses}")
    else:
        check(card["losses"][-1] > card["losses"][0],
              f"{config.job_id}: log-likelihood is not rising: {card['losses']}")
    expected = hash_path_launches(card, steps)
    check(launches == expected, f"{config.job_id} launches {launches}, expected {expected}")
    print(f"phase {phase}: {config.job_id} through the JobServer on the card: losses "
          f"{card['losses']}, overflow_count {card['overflow_count']}, launches "
          f"{launches} (K1 and K2 once a step, {steps} steps, and the comm probe's), "
          f"windows {card['windows']}, {seconds:.2f} s", flush=True)

    runs = {}
    for d in ("cuda", "cpu"):
        entity, worker = job_worker(config, d)
        seen = windows_without_syncs(worker) if d == "cuda" else None
        try:
            result = worker.run()
            model, local = worker.ctx.model_table, worker.ctx.local_table
            runs[d] = (result, [t.cpu() for t in model.state],
                       None if local is None else local.pull_array().cpu())
        finally:
            torch.cuda.set_sync_debug_mode(0)
            entity.cleanup()
        if seen is not None:
            check(seen == result["windows"], f"windows {seen}, {result['windows']}")
    (rc, (kc, vc), lc), (rp, (kp, vp), lp) = runs["cuda"], runs["cpu"]
    check(rc["batch_losses"] == losses,
          f"{config.job_id}: two card runs differ: {rc['batch_losses']} and {losses}")
    check(same_bits(kc, kp), f"{config.job_id}: slot keys differ on the card and the CPU")
    check(rc["overflow_count"] == rp["overflow_count"] == card["overflow_count"],
          f"{config.job_id}: overflow counts {rc['overflow_count']}, {rp['overflow_count']}")
    gap = max(abs(a - b) for a, b in zip(rc["batch_losses"], rp["batch_losses"]))
    out = {"steps": steps, "losses": card["losses"], "batch_losses": losses,
           "cpu_batch_losses": rp["batch_losses"], "max_abs_gap_card_vs_cpu": gap,
           "overflow_count": card["overflow_count"], "launches": launches,
           "windows": card["windows"], "comm_probe": card["comm_probe"],
           "epoch_seconds": card["epoch_seconds"], "run_seconds": seconds,
           "present_slots": int((kc < 0).sum())}
    if kind == "lda":
        check(same_bits(vc, vp), f"{config.job_id}: counts differ on the card and the CPU")
        check(torch.equal(lc, lp), f"{config.job_id}: assignments differ")
        out["counts_identical"] = out["assignments_identical"] = True
    else:
        check(gap <= LOSS_ATOL, f"{config.job_id}: card and CPU losses differ by {gap}")
        vgap = float((vc - vp).abs().max())
        vmax = float(vc.abs().max())
        check(vmax < 1.0,
              f"{config.job_id}: |values| reach {vmax}, past HASH_VALUE_ATOL's premise")
        out["max_abs_value"] = vmax
        check(vgap <= HASH_VALUE_ATOL,
              f"{config.job_id}: card and CPU table values differ by {vgap} > "
              f"{HASH_VALUE_ATOL}")
        out["max_abs_value_gap_card_vs_cpu"] = vgap
    out["samples_per_sec"] = (N_EXAMPLES if kind == "fm" else SPARSE_LDA_DATA["num_docs"]) \
        / card["epoch_seconds"][-1]
    print(f"phase {phase}: the card against the CPU after {epochs} epochs: slot keys "
          f"byte-identical ({out['present_slots']} present), overflow "
          f"{card['overflow_count']} on both, max |loss gap| {gap}"
          + (", counts and assignments identical" if kind == "lda" else "")
          + "; no sync inside any window of the card run", flush=True)
    return out


def run_host_driven_steps():
    """Phase 3j: the ModelAccessor path on the card. FusedSparseStep at
    bench-widedeep's width (102,144 rows of 17 f32, 8 batches of 65,536 keys:
    PULL K1, PUSH K3 on the table's mxu_auto route) against the accessor's
    unfused pull -> compute -> push, and accessor_async_step at bound 0
    against the synchronous pull_all -> compute -> push_all cycle, bit for
    bit; the launch counts of the fused run."""
    from harmony_tpu_torch.config.params import TableConfig
    from harmony_tpu_torch.dolphin.accessor import ModelAccessor
    from harmony_tpu_torch.dolphin.worker import accessor_async_step
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    cfg = TableConfig(table_id="emb", capacity=102_144, value_shape=(17,), num_blocks=256,
                      is_ordered=False)
    # 65,536 keys a batch over 102,144 rows: duplicates fold in the push
    batches = [(rng.integers(0, 102_144, 65_536).astype(np.int32),
                rng.standard_normal((65_536, 17)).astype(np.float32)) for _ in range(BATCHES)]

    def sgd(rows, targets):
        err = rows - targets
        return -0.05 * err, {"loss": torch.mean(torch.sum(err * err, -1))}

    def table():
        t = DenseTable(TableSpec(cfg), dev)
        t.write_all(np.random.default_rng(12).standard_normal((102_144, 17)).astype(np.float32))
        return t

    fused_t = table()
    fs = ModelAccessor(fused_t).fused_step(sgd)
    reset_counts(*wrappers)
    t0 = time.perf_counter()
    auxes = fs.run_batches(batches)
    fused_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    check(fs.push_route == "mxu_auto" and launches == {
        "gather_rows": BATCHES, "segment_sum_rows": 0, "weighted_histogram": BATCHES},
        f"FusedSparseStep launches {launches} on {fs.push_route}")
    unfused_t = table()
    acc = ModelAccessor(unfused_t)
    t0 = time.perf_counter()
    unfused = []
    for keys, tgt in batches:
        delta, aux = sgd(torch.as_tensor(acc.pull(keys), device=dev),
                         torch.as_tensor(tgt, device=dev))
        acc.push(keys, delta.cpu().numpy())
        unfused.append(float(aux["loss"]))
    unfused_s = time.perf_counter() - t0
    fused = [float(a["loss"]) for a in auxes]
    check(fused == unfused and all(math.isfinite(v) for v in fused) and fused[-1] < fused[0],
          f"FusedSparseStep losses {fused}, unfused {unfused}: not bit-identical, finite "
          "and falling")
    check(same_bits(fused_t.pull_array(), unfused_t.pull_array()),
          "FusedSparseStep's table differs from the unfused loop's")

    acfg = TableConfig(table_id="dense", capacity=4096, value_shape=(256,), num_blocks=64)
    targets = [torch.as_tensor(rng.standard_normal((4096, 256)).astype(np.float32),
                               device=dev) for _ in range(BATCHES)]

    def compute(model, target):
        return -0.3 * (model - target), {"gap": torch.mean(torch.abs(model - target))}

    tables = [DenseTable(TableSpec(acfg), dev) for _ in range(2)]
    drv = accessor_async_step(tables[0], compute, staleness_bound=0)
    try:
        gaps = [drv.submit(t)["gap"] for t in targets]
        drv.drain()
    finally:
        drv.shutdown()
    spec = tables[1].spec
    sync_gaps = []
    for t in targets:
        def cycle(arr, t=t):
            delta, m = compute(spec.pull_all(arr).clone(), t)
            sync_gaps.append(m["gap"])
            return spec.push_all(arr, delta), None
        tables[1].apply_step(cycle)
    check(torch.equal(torch.stack(gaps), torch.stack(sync_gaps))
          and same_bits(tables[0].pull_array(), tables[1].pull_array()),
          "accessor_async_step at bound 0 is not bit-identical to the synchronous cycle")
    out = {"fused_sparse_step": {"launches": launches, "seconds": fused_s,
                                 "unfused_seconds": unfused_s, "losses": fused},
           "accessor_async_step": {"staleness": drv.staleness_stats(),
                                   "phase_seconds": drv.mean_phase_seconds()}}
    print(f"phase 3j: FusedSparseStep bit-identical to the accessor's unfused loop "
          f"({fused_s:.3f} s against {unfused_s:.3f} s for {BATCHES} batches), launches "
          f"{launches}; accessor_async_step at bound 0 bit-identical to the synchronous "
          f"cycle", flush=True)
    return launches, out


# -- phases 2e, 3k, 3l and 3m: GBT, the Pregel engine, Lasso and AddVector -----

# bench-gbt: XGBoost's documented defaults for tree_method="hist" (max_depth 6,
# max_bin 256, eta 0.3, lambda 1) at HIGGS's shape (28 features, binary
# logistic loss). 524,288 synthetic rows (HIGGS has 11M and is not in the repo)
# in 8 mini-batches of 65,536 for 2 epochs: 16 rounds.
GBT_APP = {"num_features": 28, "num_examples": 524_288, "num_rounds": 16,
           "loss": "logistic", "num_bins": 256, "max_depth": 6, "lam": 1.0,
           "step_size": 0.3}
GBT_DATA = {"n": 524_288, "num_features": 28, "num_bins": 256, "task": "binary"}
GBT_BATCH = GBT_DATA["n"] // BATCHES
GBT_N_NODES = 2 ** (GBT_APP["max_depth"] + 1) - 1
# K3 calls a step: one a level, the histograms and the node totals together
GBT_FOLDS_PER_STEP = GBT_APP["max_depth"] + 1
# The gbt preset's leaf values, card against CPU: the folds add in index order
# on both and the prefix sums are sequential f32 on both, and the squared loss's
# gradients are one f32 subtraction, so they agree exactly; allowed: 1e-5, the
# tier-1 limit against the JAX package.
GBT_LEAF_ATOL = 1e-5
# bench-gbt's free run on the CPU, reported beside the card's (no check):
# its first epoch's rounds (both epochs took 18.0 s of CPU beside an NVIDIA
# H100 80GB HBM3; cut to one when phase 3pd came)
GBT_CPU_EPOCHS = 1
# bench-gbt's gradients p - y and hessians p (1 - p), card against CPU at the
# same margins: p = sigmoid(m) lies within a few f32 ulps of the true value on
# each device (CUDA's expf is within 2 ulps, the CPU's within 1, then two
# roundings), and an ulp of a p in [0.5, 1) is 2**-24; p - y subtracts
# exactly and p (1 - p) adds one rounding at most a quarter that size.
# Allowed: 8 ulps at 1, absolutely. Their step losses: LOSS_ATOL.
GBT_GRAD_ATOL = 8 * 2.0 ** -24
# bench-pagerank: SNAP soc-LiveJournal1's scale (4,847,571 vertices, 68,993,773
# edges) as random_graph(V, 14): uniform out-degree 14, ~67.9M edges once the
# self-loops are dropped (LiveJournal's file is not in the repo). 10 PageRank
# iterations, 11 supersteps.
PR_VERTICES = 4_847_571
PR_DEGREE = 14
PR_ITERATIONS = 10
# PageRank's card-against-CPU comparison at full width runs this many
# iterations on both (the JobServer's job above runs PR_ITERATIONS): its CPU
# run was the phase's largest part (55 s of 134-160 s beside an NVIDIA H100
# 80GB HBM3 at 10 iterations), the slowest phase of the script, so its depth
# was cut from 10 when phase 3w came, from 5 (24.2 s of CPU on the same
# host) when phase 3pd came, and from 2 (9.4 s) when 3pd's moves came.
PR_CPU_ITERATIONS = 1
# Shortest path's and components' card-against-CPU comparisons at full width
# run this many supersteps on both (the JobServer's jobs above run to
# convergence, 13 and 8): their CPU runs to convergence took 48.8 s and 51.6
# s of phase 3l's 180.6 s beside an NVIDIA H100 80GB HBM3 at 700.00 W, and
# phase 3pc needed the room; from 2 to 1 (5.0 and 8.0 s of CPU on the same
# host) when phase 3pd came.
GRAPH_CPU_SUPERSTEPS = 1
# PageRank's ranks, card against CPU: 1e-6 relative, the tier-1 limit against
# the JAX package (the add fold gives the CPU's bits, so they may agree exactly).
PR_RTOL = 1e-6
# Rank mass after 10 iterations: 1 less the mass that dangling vertices hold
# (their rank leaves along no edge), within f32 summation error of 4.8M ranks.
RANK_MASS_ATOL = 1e-3


def preset_config(app: str, epochs: int = 3, batches: int = 4, **params):
    """The CLI's JobConfig of ``app`` (``cli.build_config``, no overrides);
    ``params`` override its TrainerParams."""
    import argparse

    from harmony_tpu_torch import cli

    ns = argparse.Namespace(set=[], data=[], job_id=None, epochs=epochs, batches=batches,
                            graph_file=None, max_supersteps=100)
    config = cli.build_config(app, ns)
    return config.replace(params=config.params.replace(**params)) if params else config


def gbt_job(epochs: int, **params):
    from harmony_tpu_torch.config.params import JobConfig, TrainerParams

    return JobConfig(
        job_id="bench-gbt", app_type="dolphin",
        trainer="harmony_tpu_torch.apps.gbt:GBTTrainer",
        params=TrainerParams(num_epochs=epochs, num_mini_batches=BATCHES,
                             app_params=GBT_APP, **params),
        num_workers=1,
        user={"data_fn": "harmony_tpu_torch.apps.gbt:make_binned_synthetic",
              "data_args": GBT_DATA})


def graph_job(app: str, num_vertices: int):
    """bench-pagerank's graph (random_graph(V, 14), seed 0) under ``app``'s
    preset: pagerank (10 iterations), shortest-path (weighted, source 0) or
    connected-components."""
    config = preset_config(app)
    args = {**config.user["graph_args"], "num_vertices": num_vertices,
            "avg_degree": PR_DEGREE}
    return config.replace(job_id=f"bench-{app}", user={**config.user, "graph_args": args})


def gbt_level_operands(dev):
    """K3's operands at bench-gbt's deepest histogram level (depth 5, 32 nodes):
    a mini-batch of 65,536 rows binned as the job bins them, each row at a node
    of that level or settled (node -1, about 1 in 33), the rows [g | h | live]
    of the logistic loss at margins drawn from N(0, 1), ids (node * 28 + f) *
    256 + bin and then the node totals: 1,900,544 ids of width 3 into 229,408
    rows."""
    from harmony_tpu_torch.apps.gbt import make_binned_synthetic

    bins, y = make_binned_synthetic(GBT_BATCH, GBT_DATA["num_features"],
                                    num_bins=GBT_DATA["num_bins"], task="binary")
    rng = np.random.default_rng(6)
    E, F = bins.shape
    B = GBT_DATA["num_bins"]
    n_level = 2 ** (GBT_APP["max_depth"] - 1)
    node = rng.integers(-1, n_level, E).astype(np.int32)
    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(E).astype(np.float32)))
    live = (node >= 0).astype(np.float32)
    stats = np.stack([(p - y) * live, p * (1 - p) * live, live], axis=1).astype(np.float32)
    flat = ((node[:, None] * F + np.arange(F)) * B + bins).reshape(-1)
    nb = n_level * F * B
    ids = np.concatenate([flat, np.where(node >= 0, node + nb, -1)]).astype(np.int32)
    w = np.concatenate([np.repeat(stats, F, axis=0), stats])
    return (torch.as_tensor(ids, device=dev), torch.as_tensor(w, device=dev),
            nb + n_level)


def pagerank_graph():
    """bench-pagerank's graph on the host (the reference's draws)."""
    from harmony_tpu_torch.pregel.graph import random_graph

    return random_graph(PR_VERTICES, PR_DEGREE)


def check_slice_kernels(dev, graph):
    """Phase 2e: K3 at bench-gbt's deepest level, K2 at bench-pagerank's add
    fold (the edge messages of its first superstep, [E, 1] f32 into 4.85M
    rows) and K1 at its edge gather (PageRank's state, [V, 2] f32, 8-byte
    rows, at the edges' sources), and at shortest path's ([V, 1] f32,
    4-byte rows, the same sources) and connected components' (the ~135.7M
    sources of the symmetrised edges). Each must give the same bits as its plain
    version on the CPU and as itself run twice; K1 also as its plain version
    on the card, K2 and K3 within the f32 reordering bound of it (the card's
    atomic index_add_). Timed (fewer samples than phase 2: one fold of 68M
    ids takes milliseconds) beside the plain version and the library calls:
    ``index_select`` for K1, atomic and deterministic ``index_add_`` for the
    folds. A profiled time under the bytes bound of a call that cannot stay
    in L2 fails the run. Returns per-case timing and max |kernel - plain on
    the card|."""
    from harmony_tpu_torch.ops.histogram import (
        weighted_histogram,
        weighted_histogram_plain,
    )
    from harmony_tpu_torch.ops.sparse import (
        fold_scratch_ints,
        gather_rows,
        gather_rows_plain,
        segment_sum_rows,
        segment_sum_rows_plain,
    )

    V = graph.num_vertices
    src = torch.as_tensor(graph.src, device=dev)
    dst = torch.as_tensor(graph.dst, device=dev)
    deg = torch.as_tensor(np.maximum(graph.out_degree, 1.0), device=dev)
    state = torch.stack([torch.full((V,), 1.0 / V, device=dev), deg], dim=1)
    sent = gather_rows_plain(state, src)
    msgs = (sent[:, 0] / sent[:, 1])[:, None].contiguous()
    ids, w, rows = gbt_level_operands(dev)
    cases = {
        "weighted_histogram": (weighted_histogram, weighted_histogram_plain,
                               (ids, w, rows), ids, w, rows),
        "segment_sum_rows": (segment_sum_rows, segment_sum_rows_plain,
                             (msgs, dst, V), dst, msgs, V),
    }
    err, timing = {}, {}
    for name, (kernel, plain, args, i, x, R) in cases.items():
        got, again = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        check(same_bits(got, again), f"phase 2e {name}: two runs differ")
        check(same_bits(got.cpu(), plain(*(a.cpu() if torch.is_tensor(a) else a
                                            for a in args))),
              f"phase 2e {name}: not the same bits as the CPU's index_add_")
        gap = (got - plain(*args)).abs()
        check(bool((gap <= fold_tolerance(x.float(), i, R).float()).all()),
              f"phase 2e {name}: |kernel - plain| {float(gap.max())} over the bound")
        err[name] = float(gap.max())
        N, W = x.shape
        nbytes = N * 4 + N * W * 4 + R * W * 4
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, N * W / F32_FLOPS * 1e3
        i64, xf = i.long().clamp(0, R - 1), torch.where((i >= 0)[:, None], x.float(), 0.0)

        def index_add():
            return torch.zeros((R, W), device=dev).index_add_(0, i64, xf)

        mode = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True)
        try:
            det = dict(library_deterministic_ms=time_ms(index_add, samples=5, inner=3),
                       library_deterministic_device_ms=device_ms(index_add, calls=5))
        finally:
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
        timing[name] = dict(
            ids=N, width=W, rows=R,
            scratch_bytes=4 * fold_scratch_ints(N, W, R),
            ms=time_ms(lambda: kernel(*args), samples=5, inner=3),
            device_ms=device_ms(lambda: kernel(*args), calls=10,
                                floor_ms=max(t_b, t_o) if nbytes > L2_BYTES else 0.0),
            plain_ms=time_ms(lambda: plain(*args), samples=5, inner=3),
            library_ms=time_ms(index_add, samples=5, inner=3),
            library_device_ms=device_ms(index_add, calls=10), **det, bytes=nbytes,
            bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")
    # K1 at PageRank's gather (state [V, 2], 8-byte rows) and at shortest
    # path's and connected components' (distances and labels [V, 1], 4-byte
    # rows: another instance of the kernel), the latter on the symmetrised
    # edges' ~135.7M sources
    sym_src = torch.cat([src, dst])
    gathers = {
        "gather_rows": (state, src),
        "gather_rows [V, 1], shortest path": (
            torch.rand((V, 1), generator=torch.Generator(device=dev).manual_seed(7),
                       device=dev) * 1e3, src),
        "gather_rows [V, 1], connected components": (
            torch.arange(V, dtype=torch.float32, device=dev)[:, None], sym_src),
    }
    for name, (table, i) in gathers.items():
        got = gather_rows(table, i)
        torch.cuda.synchronize()
        check(same_bits(got, gather_rows(table, i)), f"phase 2e {name}: two runs differ")
        check(same_bits(got, gather_rows_plain(table, i)),
              f"phase 2e {name}: not byte-identical to the plain version")
        check(same_bits(got.cpu(), gather_rows_plain(table.cpu(), i.cpu())),
              f"phase 2e {name}: not byte-identical to the CPU's")
        del got
        N, W = i.shape[0], table.shape[1]
        nbytes = N * 4 + int(torch.unique(i).numel()) * W * 4 + N * W * 4
        i64 = i.long()
        timing[name] = dict(
            ids=N, width=W, rows=V,
            ms=time_ms(lambda: gather_rows(table, i), samples=5, inner=3),
            device_ms=device_ms(lambda: gather_rows(table, i), calls=10,
                                floor_ms=(nbytes / HBM_BYTES_PER_S * 1e3
                                          if nbytes > L2_BYTES else 0.0)),
            plain_ms=time_ms(lambda: gather_rows_plain(table, i), samples=5, inner=3),
            library_ms=time_ms(lambda: torch.index_select(table, 0, i64), samples=5, inner=3),
            library_device_ms=device_ms(lambda: torch.index_select(table, 0, i64), calls=10),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        del i64
    err["gather_rows"] = 0.0
    for name, t in timing.items():
        if t.get("bytes", 0) > L2_BYTES:
            check(t["device_ms"] >= t["bound_ms"],
                  f"phase 2e {name}: profiled {t['device_ms']} ms, under its bound of "
                  f"{t['bound_ms']} ms for {t['bytes']} bytes: records lost")
    print(f"phase 2e: K3 at bench-gbt's deepest level, K2 at bench-pagerank's fold, K1 "
          f"at its edge gather and at shortest path's and connected components': the CPU's "
          f"bits, the same bits run twice; "
          f"{json.dumps(timing)}", flush=True)
    return timing, err


def run_gbt():
    """Phase 3k. The gbt preset on the card and on the CPU (the JobServer's
    set-up of the job): the trees equal in structure, leaf values within
    GBT_LEAF_ATOL; with hist_mode="scatter" on the card, K2 once a level and
    the same trees bit for bit. Then bench-gbt through the JobServer on the
    card, launch counts read around it (K3 once a level, GBT_FOLDS_PER_STEP a
    step, and no other kernel); the loss falls; a second run (the entity's
    worker, the same job) bit-identical to it, each of its steps held to the
    CPU on the card's own inputs: every K3 call (every level's shape) the
    plain version's bits, the gradients within GBT_GRAD_ATOL, the tree grown
    from the card's gradients equal in structure to the CPU's, leaf values
    within GBT_LEAF_ATOL; the same job run through on the CPU for
    GBT_CPU_EPOCHS, reported; samples/s and rounds/s."""
    from harmony_tpu_torch.apps import gbt as gbt_app
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.ops.histogram import weighted_histogram_plain
    from harmony_tpu_torch.parallel.mesh import DevicePool

    wrappers = all_wrappers()
    preset = preset_config("gbt")
    runs = {}
    for d in ("cuda", "cpu"):
        entity, worker = job_worker(preset, d)
        try:
            runs[d] = (worker.run(), worker.ctx.model_table.pull_array().cpu(), worker.trainer)
        finally:
            entity.cleanup()
    (rc, tc, trainer), (rp, tp, _) = runs["cuda"], runs["cpu"]
    n = trainer.num_nodes
    check(trainer.resolved_hist_mode(torch.zeros(1, device="cuda")) == "matmul",
          "hist_mode auto did not resolve to matmul on the card")
    check(torch.equal(tc[:, :3 * n], tp[:, :3 * n]),
          "gbt preset: the card's trees differ in structure from the CPU's")
    leaf_gap = float((tc - tp).abs().max())
    check(leaf_gap <= GBT_LEAF_ATOL, f"gbt preset: leaf values differ by {leaf_gap}")
    loss_gap = max(abs(a - b) for a, b in zip(rc["batch_losses"], rp["batch_losses"]))
    check(loss_gap <= LOSS_ATOL, f"gbt preset: losses differ by {loss_gap}")
    # hist_mode="scatter" on the card: one K2 call a level, the same
    # index-order fold, so the same trees bit for bit
    app_params = {**preset.params.app_params, "hist_mode": "scatter"}
    entity, worker = job_worker(
        preset.replace(params=preset.params.replace(app_params=app_params)), "cuda")
    try:
        reset_counts(*wrappers)
        worker.run()
        scatter_launches = {w.__name__: w.launches for w in wrappers}
        ts = worker.ctx.model_table.pull_array().cpu()
    finally:
        entity.cleanup()
    folds = (app_params["max_depth"] + 1) * len(rc["batch_losses"])
    check(scatter_launches["segment_sum_rows"] == folds
          and sum(scatter_launches.values()) == folds,
          f"gbt preset, scatter mode: launches {scatter_launches}, expected {folds} of K2")
    check(same_bits(ts, tc), "gbt preset: the scatter mode's trees differ from matmul's")
    print(f"phase 3k: gbt preset on the card and the CPU: trees equal in structure, "
          f"max |leaf value gap| {leaf_gap} (bit-identical: {same_bits(tc, tp)}), max "
          f"|loss gap| {loss_gap}; hist_mode=scatter on the card: {folds} K2 launches, "
          f"the matmul mode's trees bit for bit", flush=True)

    steps = EPOCHS * BATCHES
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        reset_counts(*wrappers)
        t0 = time.perf_counter()
        (card,) = server.submit(gbt_job(EPOCHS)).result(timeout=900)["workers"].values()
        seconds = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
    finally:
        server.shutdown()
    losses = card["batch_losses"]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"bench-gbt: step losses {losses}")
    check(card["losses"][-1] < card["losses"][0] and losses[-1] < losses[0],
          f"bench-gbt: the loss is not falling: {losses}")
    expected = {name: 0 for name in launches}
    expected["weighted_histogram"] = steps * GBT_FOLDS_PER_STEP
    check(launches == expected, f"bench-gbt launches {launches}, expected {expected}")
    # the second run, each step held to the CPU on the card's own inputs:
    # every K3 call to its plain version (bits), the gradients to the CPU's
    # at the same margins (GBT_GRAD_ATOL), the tree grown from the card's
    # gradients to the CPU's from the same (structure exact, leaf values and
    # predictions within GBT_LEAF_ATOL)
    levels, grads, grown = [], [], []
    real_hist = gbt_app.weighted_histogram

    def hist_held(ids, w, rows):
        out = real_hist(ids, w, rows)
        want = weighted_histogram_plain(ids.cpu(), w.cpu(), rows)
        levels.append((ids.shape[0], rows, same_bits(out.cpu(), want)))
        return out

    def grad_hess_held(m, y):
        out = real_grad_hess(m, y)
        want = real_grad_hess(m.cpu(), y.cpu())
        grads.append([float((a.cpu() - b).abs().max()) for a, b in zip(out, want)])
        return out

    def grow_held(bins, g, h):
        out = real_grow(bins, g, h)
        want = real_grow(bins.cpu(), g.cpu(), h.cpu())
        grown.append((all(torch.equal(a.cpu(), b) for a, b in zip(out[:3], want[:3])),
                      max(float((a.cpu() - b).abs().max()) for a, b in zip(out[3:], want[3:]))))
        return out

    gbt_app.weighted_histogram = hist_held
    entity, worker = job_worker(gbt_job(EPOCHS), "cuda")
    trainer = worker.trainer
    real_grad_hess, real_grow = trainer._grad_hess, trainer._grow_tree
    trainer._grad_hess, trainer._grow_tree = grad_hess_held, grow_held
    try:
        again = worker.run()
        trees = worker.ctx.model_table.pull_array().cpu()
    finally:
        gbt_app.weighted_histogram = real_hist
        entity.cleanup()
    check(again["batch_losses"] == losses,
          f"bench-gbt: a second run differs: {again['batch_losses']} and {losses}")
    shapes = sorted({(n, r) for n, r, _ in levels})
    check(len(levels) == steps * GBT_FOLDS_PER_STEP and all(ok for _, _, ok in levels),
          f"bench-gbt: K3 against the CPU's plain version, (ids, rows, same bits): "
          f"{sorted(set(levels))}")
    grad_gap = [max(col) for col in zip(*grads)]   # gradients, hessians, loss
    check(len(grads) == steps and max(grad_gap[:2]) <= GBT_GRAD_ATOL
          and grad_gap[2] <= LOSS_ATOL,
          f"bench-gbt: |gradient, hessian, loss gap| against the CPU's at the same "
          f"margins, each step: {grads}")
    grow_gap = max(gap for _, gap in grown)
    check(len(grown) == steps and all(same for same, _ in grown) and grow_gap <= GBT_LEAF_ATOL,
          f"bench-gbt: trees against the CPU's from the same gradients: {grown}")
    # the same job run through on the CPU, for the record: its gradients
    # round apart from the card's in a last bit from round 1 on, and an
    # exact tie between splits can then go either way. GBT_CPU_EPOCHS of
    # the card's EPOCHS (its rounds are the card run's first)
    entity, worker = job_worker(gbt_job(GBT_CPU_EPOCHS), "cpu")
    try:
        cpu = worker.run()
        cpu_trees = worker.ctx.model_table.pull_array()
    finally:
        entity.cleanup()
    apart = [r for r in range(GBT_CPU_EPOCHS * BATCHES)
             if not torch.equal(trees[r, :3 * GBT_N_NODES], cpu_trees[r, :3 * GBT_N_NODES])]
    free_run = {"rounds_apart_in_structure": apart,
                "max_abs_loss_gap": max(abs(a - b) for a, b in zip(losses, cpu["batch_losses"])),
                "cpu_epoch_seconds": cpu["epoch_seconds"]}
    leaves = (trees[:, 2 * GBT_N_NODES:3 * GBT_N_NODES] > 0.5).sum(dim=1).tolist()
    epoch_s = card["epoch_seconds"][-1]
    out = {"steps": steps, "losses": card["losses"], "batch_losses": losses,
           "launches": launches, "windows": card["windows"],
           "epoch_seconds": card["epoch_seconds"], "run_seconds": seconds,
           "samples_per_sec": GBT_DATA["n"] / epoch_s, "rounds_per_sec": BATCHES / epoch_s,
           "leaves_per_tree": leaves, "preset_leaf_gap_card_vs_cpu": leaf_gap,
           "preset_bit_identical_card_vs_cpu": same_bits(tc, tp),
           "k3_calls_held_to_cpu": len(levels), "k3_shapes_ids_rows": shapes,
           "trees_held_to_cpu": len(grown), "max_leaf_or_pred_gap_held": grow_gap,
           "max_grad_hess_loss_gap_held": grad_gap,
           "cpu_free_run": free_run}
    print(f"phase 3k: bench-gbt through the JobServer: losses {card['losses']}, launches "
          f"{launches} (K3 {GBT_FOLDS_PER_STEP} a step, {steps} steps), "
          f"{out['samples_per_sec']:.1f} samples/s, {out['rounds_per_sec']:.2f} rounds/s; "
          f"a second run bit-identical, its {len(levels)} K3 calls ({len(shapes)} shapes) "
          f"the CPU's bits, its {len(grown)} trees the CPU's from the same gradients "
          f"(max |leaf or prediction gap| {grow_gap}); the CPU's own run: "
          f"{json.dumps(free_run)}", flush=True)
    return out


def graph_entity_run(config, device):
    """A Pregel job's result through the JobServer's set-up (build_entity) on
    ``device``, its tables dropped afterwards."""
    from harmony_tpu_torch.jobserver.entity import build_entity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    master = ETMaster(DevicePool([torch.device(device)]))
    entity = build_entity(config)
    try:
        entity.setup(master, [e.id for e in master.add_executors(1)])
        return entity.run()
    finally:
        entity.cleanup()


def same_vertex_values(app: str, a: np.ndarray, b: np.ndarray) -> bool:
    """Exact for distances and labels, PR_RTOL for ranks."""
    if app == "pagerank":
        return bool(np.allclose(a, b, rtol=PR_RTOL, atol=0))
    return bool(np.array_equal(a, b))


def run_pregel(graph):
    """Phase 3l. The three graph presets on the card and on the CPU (the
    JobServer's set-up): the same supersteps, distances and labels exactly,
    ranks within PR_RTOL. Then bench-pagerank, shortest path and connected
    components at full width through the JobServer, the launch counts read
    around each (K1 once a superstep; K2 once a superstep for PageRank's add
    fold); the rank mass; a second run of each bit-identical (PageRank's on
    ``graph``, built for phase 2e); then each on the CPU: the same
    supersteps, distances and labels exactly, ranks within PR_RTOL."""
    from harmony_tpu_torch.apps.pagerank import PageRankComputation
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.pregel import PregelMaster

    apps = ("pagerank", "shortest-path", "connected-components")
    out = {"presets": {}, "full": {}}
    card_values = {}
    for app in apps:
        card = graph_entity_run(preset_config(app), "cuda")
        cpu = graph_entity_run(preset_config(app), "cpu")
        check(card["supersteps"] == cpu["supersteps"]
              and same_vertex_values(app, card["vertex_values"], cpu["vertex_values"]),
              f"{app} preset: card and CPU differ")
        out["presets"][app] = {
            "supersteps": card["supersteps"],
            "bit_identical": bool(np.array_equal(card["vertex_values"], cpu["vertex_values"]))}
    print(f"phase 3l: the graph presets on the card and the CPU agree: "
          f"{json.dumps(out['presets'])}", flush=True)

    wrappers = all_wrappers()
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        for app in apps:
            reset_counts(*wrappers)
            t0 = time.perf_counter()
            res = server.submit(graph_job(app, PR_VERTICES)).result(timeout=900)
            seconds = time.perf_counter() - t0
            launches = {w.__name__: w.launches for w in wrappers}
            s = res["supersteps"]
            expected = {name: 0 for name in launches}
            expected["gather_rows"] = s
            expected["segment_sum_rows"] = s if app == "pagerank" else 0
            check(launches == expected, f"bench-{app} launches {launches}, expected {expected}")
            values = res["vertex_values"][:, 0]
            check(bool(np.isfinite(values).all()), f"bench-{app}: non-finite values")
            edges = graph.num_edges * (2 if app == "connected-components" else 1)
            entry = {"supersteps": s, "launches": launches, "wall_sec": res["wall_sec"],
                     "run_seconds": seconds, "edges": edges,
                     "edges_per_sec_per_superstep": edges * s / res["wall_sec"]}
            if app == "pagerank":
                check(s == PR_ITERATIONS + 1, f"bench-pagerank: {s} supersteps")
                dangling = float(values[graph.out_degree == 0].astype(np.float64).sum())
                mass = float(values.astype(np.float64).sum())
                check(abs(mass - (1.0 - dangling)) <= RANK_MASS_ATOL,
                      f"bench-pagerank: rank mass {mass}, dangling {dangling}")
                master = PregelMaster(graph, PageRankComputation(graph, PR_ITERATIONS), "cuda")
                try:
                    again = master.run()
                finally:
                    master.close()
                check(np.array_equal(again["vertex_values"][:, 0], values),
                      "bench-pagerank: a second run differs")
                entry.update(rank_mass=mass, dangling_mass=dangling)
            else:
                if app == "shortest-path":
                    check(values[0] == 0.0 and bool((values >= 0).all()),
                          "bench-shortest-path: bad distances")
                    entry["reached"] = int((values < 1e9).sum())
                else:
                    check(bool((values <= np.arange(len(values))).all()),
                          "bench-connected-components: a label above its vertex id")
                    entry["components"] = int(np.unique(values).size)
                again = graph_entity_run(graph_job(app, PR_VERTICES), "cuda")
                check(np.array_equal(again["vertex_values"][:, 0], values),
                      f"bench-{app}: a second run differs")
            out["full"][app] = entry
            card_values[app] = res
            print(f"phase 3l: bench-{app} through the JobServer: {json.dumps(entry)}",
                  flush=True)
    finally:
        server.shutdown()

    for app in apps:
        job = graph_job(app, PR_VERTICES)
        if app == "pagerank":
            job = job.replace(params=job.params.replace(app_params={
                **job.params.app_params, "num_iterations": PR_CPU_ITERATIONS}))
            card = graph_entity_run(job, "cuda")
            out["full"][app]["cpu_comparison_iterations"] = PR_CPU_ITERATIONS
            # phase 3y's reference (POD_PR_ITERATIONS is this run's count)
            out["full"][app]["pod_reference"] = {
                "digest": vertex_digest(card["vertex_values"]), "supersteps": card["supersteps"]}
            cpu = graph_entity_run(job, "cpu")
        else:
            job = job.replace(user={**job.user, "max_supersteps": GRAPH_CPU_SUPERSTEPS})
            card = graph_entity_run(job, "cuda")
            cpu = graph_entity_run(job, "cpu")
            check(card["supersteps"] == GRAPH_CPU_SUPERSTEPS,
                  f"bench-{app}: {card['supersteps']} supersteps, not {GRAPH_CPU_SUPERSTEPS}")
            out["full"][app]["cpu_comparison_supersteps"] = GRAPH_CPU_SUPERSTEPS
        check(card["supersteps"] == cpu["supersteps"]
              and same_vertex_values(app, card["vertex_values"], cpu["vertex_values"]),
              f"bench-{app}: card and CPU differ")
        out["full"][app].update(
            max_abs_gap_card_vs_cpu=float(
                np.abs(card["vertex_values"] - cpu["vertex_values"]).max()),
            bit_identical_card_vs_cpu=bool(
                np.array_equal(card["vertex_values"], cpu["vertex_values"])),
            cpu_wall_sec=cpu["wall_sec"])
    agreement = {app: {k: v for k, v in e.items() if "cpu" in k}
                 for app, e in out["full"].items()}
    print(f"phase 3l: at full width the card agrees with the CPU: {json.dumps(agreement)}",
          flush=True)
    return out, {app: card_values[app] for app in apps}


def run_linear_apps():
    """Phase 3m: the lasso, addvector and addinteger presets on the card and on
    the CPU (the JobServer's set-up): Lasso's losses within LOSS_ATOL, the
    AddVector and AddInteger tables at expected_value exactly on both."""
    out = {}
    for app in ("lasso", "addvector", "addinteger"):
        runs = {}
        for d in ("cuda", "cpu"):
            entity, worker = job_worker(preset_config(app), d)
            try:
                runs[d] = (worker.run(), worker.ctx.model_table.pull_array().cpu(),
                           worker.trainer)
            finally:
                entity.cleanup()
        (rc, tc, trainer), (rp, tp, _) = runs["cuda"], runs["cpu"]
        gap = max(abs(a - b) for a, b in zip(rc["batch_losses"], rp["batch_losses"]))
        check(gap <= LOSS_ATOL, f"{app}: card and CPU losses differ by {gap}")
        entry = {"batch_losses": rc["batch_losses"], "max_abs_loss_gap": gap}
        if app == "lasso":
            check(rc["losses"][-1] < rc["batch_losses"][0], "lasso: the loss is not falling")
            entry["nnz"] = int((tc.abs() > 1e-6).sum())
            entry["max_abs_weight_gap"] = float((tc - tp).abs().max())
        else:
            n = preset_config(app).user["data_args"]["n"]
            want = torch.full_like(tc, trainer.expected_value(3 * n))
            check(torch.equal(tc, want) and torch.equal(tp, want),
                  f"{app}: totals {tc.unique().tolist()}, {tp.unique().tolist()}, "
                  f"expected {trainer.expected_value(3 * n)}")
            entry["total"] = float(tc.reshape(-1)[0])
        out[app] = entry
    print(f"phase 3m: lasso, addvector and addinteger on the card and the CPU: "
          f"{json.dumps(out)}", flush=True)
    return out

# -- phase 3q: TaskUnit admission, multi-worker SSP jobs and shared tables ----

# bench-widedeep with two workers on one model table (the CLI's --workers 2
# --slack 1): each worker on half the examples, 8 mini-batches of 2,048.
WD2_ARGS = SLICE_ARGS + ["--epochs", str(EPOCHS), "--workers", "2", "--slack", "1"]
WD2_WORKERS = 2
# AddVector with two workers on a table made before the job (a shared table):
# every key ends at examples x epochs, an integer below 2**24, so exact in f32.
ADDV2 = {"num_keys": 1024, "vector_dim": 16, "n": 65536}
# PageRank beside bench MLR: a random graph of 262,144 vertices and ~3.7M edges
# (a 1/18 cut of bench-pagerank's, built in well under a second).
PR2_GRAPH = {"num_vertices": 262144, "avg_degree": 14}


def serve(configs, device):
    """Submit ``configs`` together to one JobServer on ``device``; returns the
    results in order and the TaskUnit grants by job and kind."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    server = JobServer(1, device_pool=DevicePool([torch.device(device)]))
    server.start()
    try:
        futures = [server.submit(c) for c in configs]
        results = [f.result(timeout=600) for f in futures]
    finally:
        server.shutdown(timeout=120)
    check(server.master.table_ids() == [],
          f"tables left after the jobs: {server.master.table_ids()}")
    return results, bench.grants_by_job(server.global_taskunit.grant_order())


def wd2_config(lockstep: bool):
    from harmony_tpu_torch import cli

    config = cli.build_config("widedeep", cli.build_parser().parse_args(WD2_ARGS))
    if lockstep:
        config = config.replace(user={**config.user, "force_lockstep": True})
    return config


def check_wd2_kernels(dev):
    """K1 and K3 at the 2-worker step's shape (one worker's first batch of
    2,048 examples) against their plain versions: K1 byte-identical, K3 the
    CPU's index_add_ bits and its own run twice. Returns max |kernel - plain|."""
    from harmony_tpu_torch.ops.histogram import (
        weighted_histogram,
        weighted_histogram_plain,
    )
    from harmony_tpu_torch.ops.sparse import gather_rows, gather_rows_plain

    table, idx = slice_operands(dev, batch=N_EXAMPLES // WD2_WORKERS // BATCHES)
    got = gather_rows(table, idx)
    check(same_bits(got, gather_rows_plain(table, idx)),
          "phase 3q: gather_rows at the 2-worker shape is not byte-identical")
    x = torch.randn((idx.shape[0], table.shape[1]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    fold = weighted_histogram(idx, x, table.shape[0])
    again = weighted_histogram(idx, x, table.shape[0])
    torch.cuda.synchronize()
    check(same_bits(fold, again), "phase 3q: weighted_histogram run twice differs")
    check(same_bits(fold.cpu(), weighted_histogram_plain(idx.cpu(), x.cpu(), table.shape[0])),
          "phase 3q: weighted_histogram at the 2-worker shape is not the CPU's bits")
    err = float((fold - weighted_histogram_plain(idx, x, table.shape[0])).abs().max())
    print(f"phase 3q: K1 byte-identical and K3 the CPU's bits at the 2-worker step's "
          f"{idx.shape[0]} ids", flush=True)
    return {"gather_rows": 0.0, "weighted_histogram": err}


def run_multiworker(trio_jobs, fused_trio):
    """Phase 3q: the paths of TaskUnit admission, multi-worker SSP jobs and
    shared tables on the card. bench-widedeep with two workers on one table
    under SSP slack 1 (K1 and K3 from two threads); the same job in lockstep
    twice (the same bits) and on the CPU (within LOSS_ATOL a step); AddVector
    with two workers on a shared table (exact); PageRank beside bench MLR
    under one JobServer (K1 and K2; values bit-identical to a solo run); and
    the trio of phase 3d, whose per-batch losses under the JobServer must be
    the bits of its fused windows outside it."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.apps.pagerank import PageRankComputation
    from harmony_tpu_torch.config.params import JobConfig, TableConfig, TrainerParams
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.pregel.graph import random_graph
    from harmony_tpu_torch.pregel.master import PregelMaster

    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    out, launches = {}, {}
    steps = WD2_WORKERS * EPOCHS * BATCHES

    # the trio: per-batch under the JobServer, the bits of the fused windows
    for job_id, job in trio_jobs.items():
        worker = job["worker"]
        check(not worker["fused_epochs"], f"{job_id} ran fused windows under the JobServer")
        check(float_bits(worker["batch_losses"]) == float_bits(fused_trio[job_id]),
              f"{job_id}: the per-batch losses under the JobServer are not the bits "
              f"of its fused windows")
    out["trio_grants"] = {k: j["grants"] for k, j in trio_jobs.items()}
    print(f"phase 3q: the trio's per-batch losses under the JobServer are the bits of "
          f"its fused windows; grants by job {json.dumps(out['trio_grants'])}", flush=True)

    # bench-widedeep, two workers, SSP slack 1
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        reset_counts(*wrappers)
        t0 = time.perf_counter()
        (ssp,), grants = serve([wd2_config(False)], "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["bench-widedeep-2-workers"] = {w.__name__: w.launches for w in wrappers}
        lock = []
        for _ in range(2):
            (r,), _ = serve([wd2_config(True)], "cuda")
            lock.append(r)
        (lock_cpu,), _ = serve([wd2_config(True)], "cpu")
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    workers = ssp["workers"]
    chief = workers[f"{ssp['job_id']}/w0"]
    k1, fold = probe_launches(chief)
    expected = {"gather_rows": steps + k1, "segment_sum_rows": 0,
                "weighted_histogram": steps + fold}
    got = launches["bench-widedeep-2-workers"]
    check(got == expected, f"phase 3q: 2-worker Wide&Deep launches {got}, expected {expected}")
    for wid, w in workers.items():
        finite_and_falling(w["batch_losses"], EPOCHS * BATCHES, f"phase 3q {wid}")
        check(not w["fused_epochs"] and w["windows"] == [1] * EPOCHS,
              f"phase 3q {wid}: fused {w['fused_epochs']}, windows {w['windows']}")
    job_grants = grants[ssp["job_id"]]
    want = {"CPU": 1 + EPOCHS * BATCHES, "NET": EPOCHS}
    check(job_grants == want, f"phase 3q: 2-worker grants {job_grants}, expected {want}")
    lock_losses = [{w: r["batch_losses"] for w, r in run["workers"].items()}
                   for run in (*lock, lock_cpu)]
    check(lock_losses[0] == lock_losses[1],
          "phase 3q: the lockstep 2-worker Wide&Deep differs run to run")
    lock_gap = max(abs(a - b) for w in lock_losses[0]
                   for a, b in zip(lock_losses[0][w], lock_losses[2][w]))
    check(lock_gap <= LOSS_ATOL,
          f"phase 3q: lockstep card and CPU losses differ by {lock_gap} > {LOSS_ATOL}")
    out["bench-widedeep-2-workers"] = {
        "launches": got, "grants": job_grants, "wall_s": wall,
        "samples_per_sec": EPOCHS * N_EXAMPLES / wall,
        "batch_losses": {w: r["batch_losses"] for w, r in workers.items()},
        "lockstep_batch_losses": lock_losses[0],
        "lockstep_max_abs_gap_card_vs_cpu": lock_gap,
    }
    print(f"phase 3q: bench-widedeep, 2 workers, slack 1: launches {got}, grants "
          f"{job_grants}, {EPOCHS * N_EXAMPLES / wall:.1f} samples/s over the job; "
          f"losses {json.dumps(out['bench-widedeep-2-workers']['batch_losses'])}; "
          f"lockstep bit-identical twice, max |card - CPU| {lock_gap}", flush=True)

    # AddVector, two workers, a shared table made before the job
    shared = TableConfig(table_id="shared-addvector", capacity=ADDV2["num_keys"],
                         value_shape=(ADDV2["vector_dim"],), num_blocks=64)
    config = JobConfig(
        job_id="addvector-2-workers", app_type="dolphin",
        trainer="harmony_tpu_torch.apps.addvector:AddVectorTrainer", tables=[shared],
        params=TrainerParams(num_epochs=EPOCHS, num_mini_batches=BATCHES, clock_slack=1,
                             app_params={"num_keys": ADDV2["num_keys"],
                                         "vector_dim": ADDV2["vector_dim"]}),
        num_workers=2,
        user={"data_fn": "harmony_tpu_torch.apps.addvector:make_marks",
              "data_args": {"n": ADDV2["n"]}})
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        table = server.master.create_table(shared, server.master.executor_ids())
        server.submit(config).result(timeout=600)
        values = table.pull_array().cpu()
        check(server.master.table_ids() == ["shared-addvector"],
              "phase 3q: the job's cleanup freed the caller's shared table")
        server.master.drop_table("shared-addvector")
    finally:
        server.shutdown(timeout=120)
    total = float(EPOCHS * ADDV2["n"])
    check(torch.equal(values, torch.full_like(values, total)),
          f"phase 3q: AddVector values {values.unique().tolist()}, expected {total}")
    out["addvector-2-workers"] = {"shape": list(values.shape), "value": total,
                                  "unique_values": values.unique().tolist()}
    print(f"phase 3q: AddVector, 2 workers on a shared {list(values.shape)} table: every "
          f"value {values.unique().tolist()} (expected {total})", flush=True)

    # PageRank beside bench MLR under one JobServer
    pregel = JobConfig(
        job_id="pagerank-beside-mlr", app_type="pregel",
        trainer="harmony_tpu_torch.apps.pagerank:PageRankComputation",
        params=TrainerParams(app_params={"num_iterations": PR_ITERATIONS}),
        user={"graph_fn": "harmony_tpu_torch.pregel.graph:random_graph",
              "graph_args": PR2_GRAPH, "max_supersteps": 100})
    mlr = bench.job_configs(TRIO_SCALE, EPOCHS)[0][0]
    reset_counts(*wrappers)
    (pr, mlr_result), grants = serve([pregel, mlr], "cuda")
    torch.cuda.synchronize()
    launches["pagerank-beside-mlr"] = {w.__name__: w.launches for w in wrappers}
    graph = random_graph(**PR2_GRAPH)
    solo = PregelMaster(graph, PageRankComputation(graph, PR_ITERATIONS), "cuda")
    try:
        alone = solo.run()
    finally:
        solo.close()
    check(np.array_equal(pr["vertex_values"], alone["vertex_values"]),
          "phase 3q: PageRank beside MLR is not bit-identical to its solo run")
    n = pr["supersteps"]
    want = {"gather_rows": n, "segment_sum_rows": n, "weighted_histogram": 0}
    check(launches["pagerank-beside-mlr"] == want,
          f"phase 3q: PageRank beside MLR launches {launches['pagerank-beside-mlr']}, "
          f"expected {want}")
    check(grants.get("pagerank-beside-mlr") == {"CPU": n} and "bench-mlr" in grants,
          f"phase 3q: grants {grants}")
    (mlr_worker,) = mlr_result["workers"].values()
    check(all(math.isfinite(v) for v in mlr_worker["batch_losses"]),
          "phase 3q: MLR beside PageRank has a non-finite loss")
    out["pagerank-beside-mlr"] = {
        "supersteps": n, "launches": launches["pagerank-beside-mlr"], "grants": grants,
        "wall_s": pr["wall_sec"], "solo_wall_s": alone["wall_sec"],
        "values_sum": float(pr["vertex_values"].sum()),
    }
    print(f"phase 3q: PageRank ({PR2_GRAPH}) beside bench MLR: {n} supersteps, launches "
          f"{launches['pagerank-beside-mlr']}, values bit-identical to the solo run, "
          f"grants {json.dumps(grants)}", flush=True)
    return launches, out


# -- phase 3r: checkpoint chains -----------------------------------------------

# bench-lm's deferred evaluation runs on one batch of its corpus (32 sequences
# of 1,024 tokens, the training batch's shape) rather than all 128 sequences.
LM_EVAL_DATA = {"num_seqs": 32, "seq_len": 1025, "vocab_size": 8192}
# bench-lm's chain in (d) is LM_CHAIN_EPOCHS epochs deep (an entry of 134.5 MB
# takes ~17 s to write on the chip host's filesystem), and its synchronous
# write and restore are timed at CHAIN_IO_THREADS I/O threads (the default)
LM_CHAIN_EPOCHS = 1
CHAIN_IO_THREADS = 4
# The hash chain's evaluations, card against CPU over the same chain files:
# the same table bits on both, and the metrics are f32 sums over 32,768
# examples taken in another order (CUDA's reductions against the CPU's).
CHAIN_EVAL_ATOL = 1e-5


def chain_server(root):
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]), chkp_root=root)
    server.start()
    return server


def chain_codec(mgr, chkp_id):
    """The codec that wrote the entry's blocks ("blk", the native CRC codec, or
    "npy" where it did not build) and the bytes of its files on disk."""
    d = mgr._dir_of(chkp_id)
    names = os.listdir(d)
    codecs = {n.rsplit(".", 1)[1] for n in names if n != "manifest.json"}
    check(len(codecs) == 1, f"{chkp_id}: mixed block files {sorted(codecs)}")
    return codecs.pop(), sum(os.path.getsize(os.path.join(d, n)) for n in names)


def chain_entries_left(root, job_id):
    return [d for sub in ("temp", "commit")
            for d in os.listdir(os.path.join(root, job_id, sub))]


def newest_entry(mgr):
    infos = [mgr.info(c) for c in mgr.list_checkpoints()]
    return max(infos, key=lambda i: (i.app_meta["epoch"], i.created_at))


def restored_bits(mgr, master, chkp_id, executors):
    """The entry restored on the card: its storage (dense) or (slot keys,
    values) (hash), on the host."""
    h = mgr.restore(master, chkp_id, executors, table_id=f"check:{chkp_id}")
    try:
        state = h.table.state if h.table.spec.config.sparse else (h.table.array,)
        return [t.cpu() for t in state]
    finally:
        h.drop()


def launch_counts(wrappers):
    return {w.__name__: w.launches for w in wrappers}


def run_chain_fm(root, wrappers):
    """Phase 3r (a): bench-fm-hash with a chain entry every epoch and the
    deferred evaluation; the same files restored on the CPU. Returns the
    result and the launches of the training and of the evaluation."""
    from harmony_tpu_torch.checkpoint import CheckpointManager
    from harmony_tpu_torch.dolphin.evaluator import resolve_eval_inputs
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    config = hash_job("fm", EPOCHS, model_chkp_period=1, offline_model_eval=True)
    server = chain_server(root)
    try:
        reset_counts(*wrappers)
        res = server.submit(config).result(timeout=600)
        train = launch_counts(wrappers)
        ids = res["model_chkp_ids"]
        check(len(ids) == EPOCHS and "model_chkp_warning" not in res,
              f"bench-fm-hash chain {ids} {res.get('model_chkp_warning')}")
        mgr = CheckpointManager.for_job(root, config.job_id)
        codec, disk = zip(*(chain_codec(mgr, c) for c in ids))
        cpu = ETMaster(DevicePool([torch.device("cpu")]))
        cpu_ex = [e.id for e in cpu.add_executors(1)]
        trainer, batch = resolve_eval_inputs(config)
        cpu_metrics = []
        for cid in ids:
            card_sk, card_v = restored_bits(mgr, server.master, cid, server.master.executor_ids())
            h = mgr.restore(cpu, cid, cpu_ex)
            check(same_bits(card_sk, h.table.state[0]) and same_bits(card_v, h.table.state[1]),
                  f"{cid}: the card's and the CPU's restores differ")
            with torch.no_grad():
                cpu_metrics.append({k: float(v) for k, v in
                                    trainer.evaluate_sparse(h.table, batch).items()})
            h.drop()
        check(launch_counts(wrappers) == train, "a kernel launched in the restores' comparison")
        reset_counts(*wrappers)
        t0 = time.perf_counter()
    finally:
        server.shutdown(timeout=600)
    eval_s = time.perf_counter() - t0
    launches = launch_counts(wrappers)
    evals = server.eval_results[config.job_id]
    check(isinstance(evals, list) and len(evals) == EPOCHS, f"bench-fm-hash evals {evals}")
    check(all(math.isfinite(m["loss"]) for m in evals) and evals[-1]["loss"] < evals[0]["loss"],
          f"bench-fm-hash evals not finite and falling: {evals}")
    gap = max(abs(a[k] - b[k]) for a, b in zip(evals, cpu_metrics) for k in a)
    check(gap <= CHAIN_EVAL_ATOL, f"hash chain evals, card against CPU, differ by {gap}")
    check(launches.get("gather_rows") == EPOCHS
          and not any(v for k, v in launches.items() if k != "gather_rows"),
          f"bench-fm-hash evaluation launches {launches}, expected one K1 an entry")
    check(chain_entries_left(root, config.job_id) == [], "the evaluation left chain entries")
    stats = res["model_chkp_stats"]
    out = {"entries": len(ids), "codec": codec[0], "entry_bytes": [s["bytes"] for s in stats],
           "entry_disk_bytes": list(disk), "evals": evals, "cpu_evals": cpu_metrics,
           "max_abs_eval_gap_card_vs_cpu": gap, "evaluation_launches": launches,
           "evaluation_seconds": eval_s, "snapshot_ms": [1e3 * s["snapshot_seconds"] for s in stats],
           "write_mb_per_s": [s["bytes"] / s["write_seconds"] / 1e6 for s in stats],
           "epoch_seconds": res["workers"][f"{config.job_id}/w0"]["epoch_seconds"]}
    print(f"phase 3r (a): bench-fm-hash chain of {len(ids)} entries ({codec[0]} blocks, "
          f"{out['entry_bytes']} bytes, {list(disk)} on disk), evaluated at shutdown "
          f"{evals}, CPU restores bit-identical, CPU evals {cpu_metrics} (max gap {gap}), "
          f"evaluation launches {launches}, chain consumed; {gpu_identity()}", flush=True)
    return out, {"fm_train": train, "fm_eval": launches}


def wd_chain_config(job_id, epochs, **user):
    from harmony_tpu_torch import cli

    config = cli.build_config("widedeep", cli.build_parser().parse_args(
        SLICE_ARGS + ["--epochs", str(epochs), "--model-chkp-period", "1",
                      "--job-id", job_id]))
    return config.replace(user={**config.user, **user})


def run_chain_widedeep(root, wrappers):
    """Phase 3r (b) and (c): bench-widedeep resumed from its chain bit for bit,
    then past a corrupt newest entry and a torn manifest. Returns the result
    and the launches of the five runs."""
    from harmony_tpu_torch.checkpoint import CheckpointManager

    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    server = chain_server(root)
    reset_counts(*wrappers)
    try:
        def run(job_id, epochs, **user):
            res = server.submit(wd_chain_config(job_id, epochs, **user)).result(timeout=600)
            (w,) = res["workers"].values()
            return res, w

        ex = server.master.executor_ids()
        _, whole = run("wd-whole", EPOCHS)
        _, first = run("wd-resumed", 1)
        resumed_res, resumed = run("wd-resumed", EPOCHS, resume_from_chain=True)
        check(resumed["starting_epoch"] == 1 and resumed["epochs_run"] == EPOCHS - 1,
              f"resumed run {resumed['starting_epoch']}, {resumed['epochs_run']}")
        check(first["batch_losses"] + resumed["batch_losses"] == whole["batch_losses"],
              "the resumed run's losses are not the uninterrupted run's bits")
        mgr_whole = CheckpointManager.for_job(root, "wd-whole")
        mgr_res = CheckpointManager.for_job(root, "wd-resumed")
        want = restored_bits(mgr_whole, server.master, newest_entry(mgr_whole).chkp_id, ex)
        got = restored_bits(mgr_res, server.master, newest_entry(mgr_res).chkp_id, ex)
        check(same_bits(want[0], got[0]), "the resumed table differs from the uninterrupted one")
        codec, disk = chain_codec(mgr_whole, newest_entry(mgr_whole).chkp_id)
        entry_bytes = resumed_res["model_chkp_stats"][0]["bytes"]
        print(f"phase 3r (b): bench-widedeep resumed at epoch 1 from its chain: table "
              f"bit-identical to the uninterrupted run's ({entry_bytes} bytes an entry, "
              f"{disk} on disk, {codec} blocks), losses the same bits", flush=True)

        # (c) a flipped byte in the newest entry of wd-whole
        newest = newest_entry(mgr_whole).chkp_id
        d = mgr_whole._dir_of(newest)
        victim = os.path.join(d, sorted(n for n in os.listdir(d) if n != "manifest.json")[7])
        raw = bytearray(open(victim, "rb").read())
        raw[len(raw) // 2] ^= 0x01
        open(victim, "wb").write(bytes(raw))
        _, again = run("wd-whole", EPOCHS, resume_from_chain=True)
        check(again["starting_epoch"] == 1, f"fallback resumed at {again['starting_epoch']}")
        check(os.path.isdir(d + ".quarantined") and newest not in mgr_whole.list_checkpoints(),
              f"{newest} was not quarantined")
        got = restored_bits(mgr_whole, server.master, newest_entry(mgr_whole).chkp_id, ex)
        check(same_bits(want[0], got[0]), "the fallback resume's table differs")
        # a torn manifest: the scan quarantines it, the resume takes the entry before
        torn = newest_entry(mgr_whole).chkp_id
        with open(os.path.join(mgr_whole._dir_of(torn), "manifest.json"), "r+") as f:
            f.truncate(30)
        _, third = run("wd-whole", EPOCHS, resume_from_chain=True)
        check(third["starting_epoch"] == 1 and torn not in mgr_whole.list_checkpoints()
              and os.path.isdir(os.path.join(mgr_whole.commit_root, torn + ".quarantined")),
              f"torn manifest {torn}: resumed at {third['starting_epoch']}")
        print(f"phase 3r (c): a flipped byte in {os.path.basename(victim)} of {newest}: "
              f"quarantined, resumed from the entry before at epoch 1 to the same table; "
              f"a torn manifest ({torn}) quarantined by the scan", flush=True)
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
        server.shutdown(timeout=600)
    return {"entry_bytes": entry_bytes, "entry_disk_bytes": disk, "codec": codec,
            "resume_bit_identical": True, "corrupt_entry_quarantined": True,
            "torn_manifest_quarantined": True}, {"wd_runs": launch_counts(wrappers)}


def file_yardstick(entry_dir, scratch):
    """The filesystem under the chain root, for the entry's file count and
    sizes: one thread writes a copy of each of the entry's files with plain
    open/write (no codec, no checksum, no commit), then reads them back."""
    blobs = [open(os.path.join(entry_dir, n), "rb").read() for n in sorted(os.listdir(entry_dir))]
    os.makedirs(scratch)
    t0 = time.perf_counter()
    for i, blob in enumerate(blobs):
        with open(os.path.join(scratch, f"{i}.bin"), "wb") as f:
            f.write(blob)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(len(blobs)):
        with open(os.path.join(scratch, f"{i}.bin"), "rb") as f:
            f.read()
    read_s = time.perf_counter() - t0
    shutil.rmtree(scratch)
    nbytes = sum(len(b) for b in blobs)
    return {"files": len(blobs), "bytes": nbytes, "write_s": write_s, "read_s": read_s,
            "write_files_per_s": len(blobs) / write_s, "read_files_per_s": len(blobs) / read_s,
            "write_mb_per_s": nbytes / write_s / 1e6}


def run_chain_lm(root, wrappers, lm_summary):
    """Phase 3r (d): bench-lm with a chain entry every epoch for
    LM_CHAIN_EPOCHS epochs and the deferred evaluation (K4 on mma, forward
    only); the snapshot's time on the training thread, the background
    write's MB/s, the synchronous write and restore MB/s at CHAIN_IO_THREADS
    I/O threads, and the epoch seconds beside phase 3b's run without a
    chain."""
    from harmony_tpu_torch import cli
    from harmony_tpu_torch.checkpoint import CheckpointManager
    from harmony_tpu_torch.ops import attention as A

    config = cli.build_config("lm", cli.build_parser().parse_args(
        LM_ARGS + ["--epochs", str(LM_CHAIN_EPOCHS), "--model-chkp-period", "1",
                   "--offline-eval"]))
    config = config.replace(user={**config.user, "test_data_args": LM_EVAL_DATA})
    server = chain_server(root)
    io = {}
    try:
        reset_counts(*wrappers)
        res = server.submit(config).result(timeout=900)
        train = launch_counts(wrappers)
        ids = res["model_chkp_ids"]
        check(len(ids) == LM_CHAIN_EPOCHS and "model_chkp_warning" not in res,
              f"bench-lm chain {ids} {res.get('model_chkp_warning')}")
        mgr = CheckpointManager.for_job(root, config.job_id)
        codec, disk = chain_codec(mgr, ids[-1])
        ex = server.master.executor_ids()
        nbytes = res["model_chkp_stats"][-1]["bytes"]
        fs = file_yardstick(mgr._dir_of(ids[-1]), os.path.join(root, "fs"))
        for threads in (CHAIN_IO_THREADS,):
            os.environ["HARMONY_CHKP_IO_THREADS"] = str(threads)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h = mgr.restore(server.master, ids[-1], ex, table_id=f"io-{threads}")
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                side = CheckpointManager(os.path.join(root, f"io{threads}", "temp"),
                                         os.path.join(root, f"io{threads}", "commit"))
                t0 = time.perf_counter()
                cid = side.checkpoint(h)
                stage_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                side.commit(cid)
                commit_s = time.perf_counter() - t0
                h.drop()
            finally:
                os.environ.pop("HARMONY_CHKP_IO_THREADS")
            check(launch_counts(wrappers) == train, "a kernel launched in the I/O timing")
            io[threads] = {"restore_mb_per_s": nbytes / restore_s / 1e6,
                           "stage_mb_per_s": nbytes / stage_s / 1e6,
                           "write_mb_per_s": nbytes / (stage_s + commit_s) / 1e6,
                           "restore_s": restore_s, "stage_s": stage_s, "commit_s": commit_s}
        reset_counts(*wrappers)
        t0 = time.perf_counter()
    finally:
        server.shutdown(timeout=900)
    eval_s = time.perf_counter() - t0
    launches = launch_counts(wrappers)
    routes = dict(A.flash_forward.launches_by_route)
    evals = server.eval_results[config.job_id]
    check(isinstance(evals, list) and len(evals) == LM_CHAIN_EPOCHS
          and all(math.isfinite(m["loss"]) for m in evals), f"bench-lm evals {evals}")
    expected = dict.fromkeys(launches, 0)
    expected["flash_forward"] = LM_CHAIN_EPOCHS * LM_LAYERS
    check(launches == expected and routes == {"mma": LM_CHAIN_EPOCHS * LM_LAYERS, "simt": 0},
          f"bench-lm evaluation launches {launches} by route {routes}, expected {expected}")
    (w,) = res["workers"].values()
    stats = res["model_chkp_stats"]
    out = {"entries": len(ids), "codec": codec, "entry_bytes": [s["bytes"] for s in stats],
           "entry_disk_bytes": disk, "evals": evals, "evaluation_launches": launches,
           "evaluation_seconds": eval_s,
           "snapshot_ms": [1e3 * s["snapshot_seconds"] for s in stats],
           "background_write_mb_per_s": [s["bytes"] / s["write_seconds"] / 1e6 for s in stats],
           "io_threads": io, "filesystem_yardstick": fs, "epoch_seconds": w["epoch_seconds"],
           "epoch_seconds_without_chain": lm_summary["epoch_seconds"],
           "card": gpu_identity()}
    print(f"phase 3r (d): bench-lm chain of {len(ids)} entries of {out['entry_bytes']} bytes "
          f"({codec} blocks, {disk} on disk): snapshot {out['snapshot_ms']} ms on the "
          f"training thread, background write {out['background_write_mb_per_s']} MB/s "
          f"(4 threads), sync write and restore by I/O threads {json.dumps(io)}, the "
          f"filesystem's plain writes and reads of the entry's files {json.dumps(fs)}, epoch "
          f"seconds {w['epoch_seconds']} with the chain and {lm_summary['epoch_seconds']} "
          f"without (phase 3b); deferred evaluation {evals} in {eval_s:.2f} s, launches "
          f"{launches} (K4 on mma, no K5); {out['card']}", flush=True)
    return out, {"lm_train": train, "lm_eval": launches}


def run_chains(lm_summary):
    """Phase 3r: checkpoint chains through the JobServer on the card, under a
    temporary chkp_root. Returns the ``chain`` path's launches (every job and
    evaluation of the phase, each stage read with the counts set to 0 just
    before it) and the phase's results."""
    import tempfile

    wrappers = all_wrappers()
    root = tempfile.mkdtemp(prefix="chip-smoke-chains-")
    stages = {}
    try:
        fm, s = run_chain_fm(os.path.join(root, "fm"), wrappers)
        stages.update(s)
        wd, s = run_chain_widedeep(os.path.join(root, "wd"), wrappers)
        stages.update(s)
        lm, s = run_chain_lm(os.path.join(root, "lm"), wrappers, lm_summary)
        stages.update(s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {w.__name__: sum(s[w.__name__] for s in stages.values()) for w in wrappers}
    return launches, {"fm_hash": fm, "widedeep": wd, "lm": lm, "launches_by_stage": stages}


def float_bits(values):
    """The f32 bit patterns of a list of floats (NaN payloads included)."""
    return np.asarray(values, dtype=np.float32).view(np.uint32).tolist()


def top_kernels(by_name: dict, top_n: int) -> dict:
    """The ``top_n`` largest device times by kernel name cut to 90
    characters, the names that share a cut summed (template instances of one
    kernel), largest first."""
    short = {}
    for name, ms in by_name.items():
        short[name[:90]] = short.get(name[:90], 0.0) + ms
    return dict(sorted(short.items(), key=lambda kv: -kv[1])[:top_n])


def busy_ms(intervals, lo: float, hi: float) -> float:
    """Milliseconds of [lo, hi] (seconds) that the union of ``intervals``
    covers."""
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy * 1e3


def profile_trio(top_n: int = 12):
    """Phase 5c: phase 3d's measured pass again, bench.run_concurrent at full
    size for 12 epochs (its schedule and nothing else), under torch.profiler.
    The device's busy time (the union of its kernels' and copies' intervals)
    over the pass, within each job's training span and where MLR trains
    alone (the other two have ended); the host-to-device copies' share of
    each; the kernels that fill it. A marker read on the host clock inside
    the profile puts the device's intervals on the jobs' clock."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from harmony_tpu_torch import bench

    marker = "chip_smoke: host clock"
    got = {}

    def run():
        with record_function(marker):   # its end stamp, then the host clock
            pass
        got["clock"] = time.perf_counter()
        got["pass"] = bench.run_concurrent([torch.device("cuda")], TRIO_SCALE,
                                           job_timeout=600.0, epochs=bench.EPOCHS)

    prof, device_events = profiled(run, cpu=True)
    clock, (rate, _, jobs) = got["clock"], got["pass"]
    htod = {}
    for e in chrome_trace(prof, "trio"):
        if e.get("ph") == "X" and e.get("name", "").startswith("Memcpy HtoD"):
            entry = htod.setdefault(e["name"], {"copies": 0, "bytes": 0})
            entry["copies"] += 1
            entry["bytes"] += int(e.get("args", {}).get("bytes", 0))
    (mark_us,) = [e.time_range.end for e in prof.events()
                  if e.name == marker and e.device_type == DeviceType.CPU]
    # run_concurrent's spans count from its own start, `origin` on perf_counter
    some = next(iter(jobs.values()))
    origin = some["worker"]["train_span"][0] - some["train_start_s"]
    shift = clock - origin
    intervals, copies, by_name = [], [], {}
    for e in device_events:
        span = ((e.time_range.start - mark_us) / 1e6 + shift,
                (e.time_range.end - mark_us) / 1e6 + shift)
        intervals.append(span)
        if e.name.startswith("Memcpy HtoD"):
            copies.append(span)
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    check(intervals, "the profiler saw no device time")

    def window(lo, hi):
        busy = busy_ms(intervals, lo, hi)
        copy = busy_ms(copies, lo, hi)
        return {"from_s": lo, "to_s": hi, "device_busy_ms": busy,
                "device_idle_share": max(0.0, 1.0 - busy / ((hi - lo) * 1e3)),
                "htod_copy_ms": copy, "htod_copy_share_of_busy": copy / busy if busy else 0.0}

    wall = max(j["end_s"] for j in jobs.values())
    steps = sum(len(j["worker"]["batch_losses"]) for j in jobs.values())
    mlr = jobs["bench-mlr"]
    others_end = max(j["train_end_s"] for k, j in jobs.items() if k != "bench-mlr")
    alone = (max(mlr["train_start_s"], others_end), mlr["train_end_s"])
    return {
        "samples_per_sec": rate,
        "htod_copies": htod,
        "htod_bytes": sum(v["bytes"] for v in htod.values()),
        "pass": window(0.0, wall),
        # device operations (kernels, copies, fills) over the pass's steps
        "steps": steps,
        "device_operations_per_step": len(device_events) / steps,
        "grants": {k: j["grants"] for k, j in jobs.items()},
        "fused_epochs": {k: j["worker"]["fused_epochs"] for k, j in jobs.items()},
        "training_spans_overlap": (max(j["train_start_s"] for j in jobs.values())
                                   < min(j["train_end_s"] for j in jobs.values())),
        "training": {k: window(j["train_start_s"], j["train_end_s"])
                     for k, j in jobs.items()},
        "mlr_trains_alone": window(*alone) if alone[1] > alone[0] else None,
        "steady_epoch_s": bench.steady_epoch_seconds(jobs),
        "top_device_ms": top_kernels(by_name, top_n),
        "ours_device_ms": {
            kernel: sum(ms for name, ms in by_name.items() if kernel in name)
            for kernel in ("gather_rows", "keyed_fold", "flash_")},
    }


def profile_worker(worker, steps: int, top_n: int):
    """Where a step's time goes, on the card: ``profile_run`` over the
    worker's epochs (the first seeds the table)."""

    def run():
        worker.run()
        worker.global_init = False

    return profile_run(run, steps, top_n)


def profile_run(run, steps: int, top_n: int):
    """Where a step's time goes, on the card: the host clock over one steady
    ``run()`` of ``steps`` steps (after a first that warms up), then a third
    under torch.profiler for the device's busy time and the kernels that fill
    it. One stream, so device intervals do not overlap."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    _, events = profiled(run, cpu=True)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / steps
    busy, ops = sum(by_name.values()), len(events)
    return {
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / step_ms),
        # the device's kernels, copies and fills a step, each one launch
        "device_ops_per_step": ops / steps,
        "top_device_ms_per_step": top_kernels(by_name, top_n),
        # the port's own kernels, every launch of each summed (the fold is two)
        "ours_device_ms_per_step": {
            kernel: sum(ms for name, ms in by_name.items() if kernel in name)
            for kernel in ("gather_rows", "keyed_fold", "flash_")},
    }


def profile_new_paths(graph):
    """Phase 5e: a bench-gbt step, a bench-pagerank superstep (on ``graph``)
    and a step of the lasso preset (its sequential sweep), each as phase 5d
    measures a step."""
    from harmony_tpu_torch.apps.pagerank import PageRankComputation
    from harmony_tpu_torch.pregel import PregelMaster

    out = {}
    for name, config, steps, per_step in (
            ("bench-gbt", gbt_job(1, comm_probe_period=0), BATCHES, GBT_BATCH),
            ("lasso", preset_config("lasso", epochs=1, comm_probe_period=0), 4, 512)):
        entity, worker = job_worker(config, "cuda")
        try:
            out[name] = profile_worker(worker, steps, top_n=10)
        finally:
            entity.cleanup()
        out[name]["samples_per_sec"] = per_step / out[name]["step_ms"] * 1e3
    master = PregelMaster(graph, PageRankComputation(graph, PR_ITERATIONS), "cuda")
    try:
        out["bench-pagerank"] = profile_run(master.run, PR_ITERATIONS + 1, top_n=10)
    finally:
        master.close()
    out["bench-pagerank"]["edges_per_sec"] = (graph.num_edges
                                              / out["bench-pagerank"]["step_ms"] * 1e3)
    return out

def _worker(trainer, arrays, batches: int):
    from harmony_tpu_torch.config.params import TrainerParams
    from harmony_tpu_torch.dolphin.data import TrainingDataProvider
    from harmony_tpu_torch.dolphin.trainer import TrainerContext
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    table = DenseTable(TableSpec(trainer.model_table_config()), "cuda")
    ctx = TrainerContext(params=TrainerParams(num_epochs=1, num_mini_batches=batches),
                         model_table=table)
    return WorkerTasklet("profile", ctx, trainer, TrainingDataProvider(arrays, batches))


def profile_slice():
    """Phase 5: the Wide&Deep job's step."""
    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer, make_synthetic

    trainer = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16,
                              hidden=128, step_size=0.1)
    worker = _worker(trainer, list(make_synthetic(N_EXAMPLES, 100000, 16)), BATCHES)
    return profile_worker(worker, BATCHES, top_n=6)


def profile_hash():
    """Phase 5d: a bench-fm-hash step and a sparse LDA step (the JobServer's
    set-up of each, one epoch a run, no comm probe): step ms, device busy ms,
    idle share and the device operations a step."""
    out = {}
    for kind in ("fm", "lda"):
        entity, worker = job_worker(hash_job(kind, 1, comm_probe_period=0), "cuda")
        try:
            out[kind] = profile_worker(worker, BATCHES, top_n=8)
        finally:
            entity.cleanup()
    return out


def profile_lm():
    """Phase 5b: the full-width LM's step, and its tokens/s."""
    from harmony_tpu_torch.models.transformer import TransformerTrainer, make_lm_data

    trainer = TransformerTrainer(vocab_size=8192, d_model=512, n_heads=8, n_layers=8,
                                 d_ff=2048, max_seq=1024, dtype="bfloat16", step_size=0.1)
    worker = _worker(trainer, [make_lm_data(128, 1025, 8192)], LM_STEPS // 2)
    out = profile_worker(worker, LM_STEPS // 2, top_n=12)
    out["tokens_per_sec"] = LM_TOKENS_PER_STEP / out["step_ms"] * 1e3
    return out


def profile_models(decode_once):
    """Phase 5f: a bench-vit step and a bench-lm-moe step (each on a worker
    over the job's trainer), and one decode step of bench-generate
    (``decode_once``, phase 3p's bf16 model at position 512 of its cache):
    step ms, device busy ms, idle share, device operations and top kernels."""
    from harmony_tpu_torch.models.transformer import TransformerTrainer, make_lm_data
    from harmony_tpu_torch.models.vit import ViTTrainer, make_synthetic

    vit = dict(image_size=224, patch_size=16, num_classes=1000, channels=3)
    trainer = ViTTrainer(**vit, d_model=768, n_heads=12, n_layers=12, d_ff=3072,
                         dtype="bfloat16", step_size=0.05, row_width=512)
    out = {"bench-vit": profile_worker(
        _worker(trainer, list(make_synthetic(2 * VIT_BATCH, **vit)), 2), 2, top_n=12)}
    out["bench-vit"]["samples_per_sec"] = VIT_BATCH / out["bench-vit"]["step_ms"] * 1e3
    trainer = TransformerTrainer(vocab_size=8192, d_model=512, n_heads=8, n_layers=8,
                                 d_ff=2048, max_seq=1024, dtype="bfloat16", step_size=0.1,
                                 moe_experts=8, moe_every=2, moe_capacity_factor=1.5,
                                 moe_aux_weight=0.01)
    worker = _worker(trainer, [make_lm_data(128, 1025, 8192)], LM_STEPS // 2)
    out["bench-lm-moe"] = profile_worker(worker, LM_STEPS // 2, top_n=12)
    out["bench-lm-moe"]["tokens_per_sec"] = (LM_TOKENS_PER_STEP
                                             / out["bench-lm-moe"]["step_ms"] * 1e3)
    out["bench-generate decode step"] = profile_run(decode_once, 1, top_n=10)
    out["bench-generate decode step"]["tokens_per_sec"] = (
        GEN_BATCH / out["bench-generate decode step"]["step_ms"] * 1e3)
    return out


# -- phase 3s: online serving through the TCP command plane ------------------

# The reference bench's read storm (benchmarks/serving_bench.py:58-79), scaled
# to bench-widedeep's table: 8 readers x 20 reads of 16 keys (the reference's
# 50 reads a reader, cut for the run's time), 12 of each read from a hot head
# of 64 keys and 4 uniform over the table, seed 20; four arms, batch window 0
# or 2 ms x hot-row cache 0 or 64 MB.
SERVE_READERS, SERVE_READS, SERVE_KEYS, SERVE_HOT, SERVE_HOT_KEYS = 8, 20, 16, 64, 12
SERVE_SEED = 20
SERVE_ARMS = [(0.0, 0), (0.0, 64), (2.0, 0), (2.0, 64)]
# bench-widedeep submitted through the CLI with a chain entry every epoch:
# enough epochs that it still trains when the storm and the pinned reads end
SERVE_EPOCHS = 24
SERVE_ROWS = 102_144          # bench-widedeep's storage rows (101,944 keys, padded)
SERVE_WIDTH = 17
# bench-fm-hash's table: 524,288 slots x 17 f32, 65,537 keys over int32
SERVE_HASH_KEYS = 65_537
# the bulk loads (A.7b): HIGGS's width, 28 features and its label
BULK_ROWS = 65_536
BULK_FEATURES = 28
SERVE_TIMEOUT = 120.0


def serve_key_lists(universe, seed=SERVE_SEED):
    """SERVE_READERS lists of SERVE_READS reads of SERVE_KEYS int32 keys: 12
    from the hot head (the first SERVE_HOT of ``universe``), 4 uniform."""
    rng = np.random.default_rng(seed)
    universe = np.asarray(universe)
    hot = universe[:SERVE_HOT]
    return [[np.concatenate([rng.choice(hot, SERVE_HOT_KEYS),
                             rng.choice(universe, SERVE_KEYS - SERVE_HOT_KEYS)]
                            ).astype(np.int32)
             for _ in range(SERVE_READS)] for _ in range(SERVE_READERS)]


def counted_gathers():
    """Wrap the endpoint's one call into the table (``_bucketed_multi_get``,
    one ``multi_get`` and so one K1 launch a call) to count its gathers and
    the sizes of the key arrays it hands ``multi_get``; returns the list and
    the restore function."""
    from harmony_tpu_torch.serving import service

    orig, sizes = service._bucketed_multi_get, []

    class Sized:
        def __init__(self, table):
            self.table = table

        def multi_get(self, keys):
            sizes.append(int(keys.shape[0]))
            return self.table.multi_get(keys)

    def counted(table, keys):
        return orig(Sized(table), keys)

    service._bucketed_multi_get = counted

    def restore():
        service._bucketed_multi_get = orig

    return sizes, restore


def run_storm(read):
    """SERVE_READERS threads, each calling ``read(reader, i)`` for its reads;
    returns the wall seconds and the round-trip ms of every read. A reader's
    exception fails the phase."""
    import threading

    lat, errors = [], []
    lock = threading.Lock()

    def reader(r):
        try:
            mine = []
            for i in range(SERVE_READS):
                t0 = time.perf_counter()
                read(r, i)
                mine.append((time.perf_counter() - t0) * 1e3)
            with lock:
                lat.extend(mine)
        except Exception as e:  # noqa: BLE001 - failed below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=reader, args=(r,), daemon=True)
               for r in range(SERVE_READERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_TIMEOUT)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a reader did not finish")
    check(not errors, f"readers failed: {errors[:3]}")
    return wall, lat


def arm_figures(stats, job, wall, lat, gathers):
    """One arm's numbers from the endpoint's stats and the readers' clocks."""
    tenant = stats["tenants"][job]
    cache = stats["cache"]
    hits = cache["hits"] if cache else 0
    lookups = (cache["hits"] + cache["misses"]) if cache else 0
    return {"p50_ms": tenant["p50_ms"], "p99_ms": tenant["p99_ms"],
            "client_p50_ms": float(np.percentile(lat, 50)),
            "client_p99_ms": float(np.percentile(lat, 99)),
            "lookups_per_s": len(lat) / wall,
            "batch_occupancy": stats["batch_occupancy"],
            "cache_hit_rate": hits / lookups if lookups else None,
            "gathers": len(gathers),
            "mean_gather_keys": float(np.mean(gathers)) if gathers else 0.0}


def k1_gather_ms(keys_per_gather):
    """K1's device ms a gather at a bench-widedeep-shaped table and the given
    (padded) key count, random rows (torch.profiler, phase 2's way)."""
    from harmony_tpu_torch.ops.sparse import gather_rows

    g = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
    flat = torch.randn(SERVE_ROWS, SERVE_WIDTH, device="cuda", generator=g)
    idx = torch.randint(0, SERVE_ROWS, (int(keys_per_gather),), device="cuda",
                        dtype=torch.int32, generator=g)
    return sum(ms for name, ms in device_kernels(lambda: gather_rows(flat, idx), 50).items()
               if "gather_rows" in name)


def cli_out(argv):
    """``cli.main(argv)`` in this process; returns its exit code and the JSON
    reply it printed."""
    from harmony_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def serve_command_plane_subprocess(root):
    """Phase 3s (a), once: ``start-jobserver --port 0`` as a process of its
    own; its ready line read, then ``shutdown`` over TCP, exit code 0."""
    import select

    proc = subprocess.Popen(
        [sys.executable, "-m", "harmony_tpu_torch.cli", "start-jobserver", "--port", "0",
         "--chkp-root", root], cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], SERVE_TIMEOUT)
        check(ready, "start-jobserver printed no ready line")
        line = proc.stdout.readline().strip()
        check(line.startswith("jobserver ready on port "), f"start-jobserver said {line!r}")
        port = int(line.split()[-1])
        rc, status = cli_out(["status", "--port", str(port)])
        check(rc == 0 and status["state"] == "INIT", f"status of the process: {status}")
        rc, reply = cli_out(["shutdown", "--port", str(port)])
        check(rc == 0 and reply == {"ok": True}, f"shutdown of the process: {reply}")
        code = proc.wait(timeout=SERVE_TIMEOUT)
        check(code == 0, f"start-jobserver exited {code}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return {"ready_line": line, "exit_code": code}


def serve_training(root, wrappers, out):
    """Phase 3s (a), (b) and (d): bench-widedeep submitted through the CLI to
    an in-process JobServer on the card, read live by the storm in each arm,
    then pinned; the same job again without readers, bit for bit."""
    from harmony_tpu_torch.checkpoint import CheckpointManager
    from harmony_tpu_torch.jobserver.client import CommandSender
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.serving import ServingClient

    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]), chkp_root=root)
    server.start()
    port = server.serve_tcp(0)
    sender = CommandSender(port, timeout=SERVE_TIMEOUT)
    job = "serve-wd"
    base = ["submit", "widedeep", "--port", str(port), "--epochs", str(SERVE_EPOCHS),
            "--model-chkp-period", "1"] + SLICE_ARGS[2:]
    gathers, restore = counted_gathers()
    try:
        rc, reply = cli_out(base + ["--job-id", job])
        check(rc == 0 and reply == {"ok": True, "job_id": job}, f"submit: {reply}")
        deadline = time.monotonic() + SERVE_TIMEOUT
        while True:   # the table exists once the entity's set-up has run
            entity = server._entities.get(job)
            if entity is not None and entity.table_handle is not None:
                break
            check(time.monotonic() < deadline and job in server.running_jobs(),
                  "the submitted job never set up its table")
            time.sleep(0.01)
        rc, status = cli_out(["status", "--port", str(port)])
        check(rc == 0 and job in status["running"], f"status: {status}")
        # the storm reads a job in its steady epochs: after its first entry
        mgr = CheckpointManager.for_job(root, job)
        while not any(mgr.info(c).committed for c in mgr.list_checkpoints()):
            check(time.monotonic() < deadline and job in server.running_jobs(),
                  "the submitted job committed no chain entry")
            time.sleep(0.01)
        universe = np.arange(entity.table_handle.table.spec.config.capacity)
        keys = serve_key_lists(universe)
        arms = {}
        for window_ms, cache_mb in SERVE_ARMS:
            os.environ["HARMONY_SERVE_BATCH_WINDOW_MS"] = str(window_ms)
            os.environ["HARMONY_SERVE_CACHE_MB"] = str(cache_mb)
            server._stop_serving()           # the next SERVING starts this arm's
            clients = [ServingClient(port=port, timeout=SERVE_TIMEOUT)
                       for _ in range(SERVE_READERS)]
            del gathers[:]
            k1_before = wrappers[0].launches

            def read(r, i):
                rows, meta = clients[r].lookup(job, keys[r][i])
                if meta != {"mode": "live", "layout_version": 0}:
                    raise AssertionError(f"meta {meta}")
                if rows.shape != (SERVE_KEYS, SERVE_WIDTH) or not np.isfinite(rows).all():
                    raise AssertionError(f"rows {rows.shape} not finite")

            try:
                wall, lat = run_storm(read)
            finally:
                for c in clients:
                    c.close()
            check(job in server.running_jobs(),
                  f"bench-widedeep ended before the storm's arm {window_ms}/{cache_mb}: "
                  "raise SERVE_EPOCHS")
            stats = server.serving.stats()
            check(stats["errors"] == 0, f"arm {window_ms}/{cache_mb}: {stats['errors']} errors")
            name = f"window_{window_ms:g}ms_cache_{cache_mb}mb"
            arms[name] = arm_figures(stats, job, wall, lat, gathers)
            arms[name]["k1_launches_job_and_reads"] = wrappers[0].launches - k1_before
            check(arms[name]["gathers"] > 0, f"arm {name}: no gather reached the table")
            print(f"phase 3s (b): {name}: {json.dumps(arms[name])}", flush=True)
        out["live_arms"] = arms

        # (d) pinned reads of the chain the job is writing
        client = ServingClient(port=port, timeout=SERVE_TIMEOUT)
        pinned = []
        try:
            pkeys = np.concatenate(keys[0][:4])
            for _ in range(2):
                rows, meta = client.lookup(job, pkeys, mode="pinned")
                info = mgr.info(meta["chkp"])
                check(info.committed and meta["mode"] == "pinned"
                      and meta["epoch"] == int(info.app_meta["epoch"]),
                      f"pinned meta {meta} against the manifest {info.app_meta}")
                d = mgr._dir_of(meta["chkp"])
                nb = info.table_config.num_blocks
                want = np.stack([decoded_block(d, int(k) % nb)
                                 .reshape(-1, SERVE_WIDTH)[int(k) // nb] for k in pkeys])
                check(rows.tobytes() == want.tobytes(),
                      f"pinned rows differ from {meta['chkp']}'s .blk bytes")
                pinned.append({"epoch": meta["epoch"], "chkp": meta["chkp"]})
                time.sleep(1.1)   # past the pin's 1 s TTL: the next read rolls forward
            check(job in server.running_jobs(), "bench-widedeep ended before the pinned reads")
            check(pinned[1]["epoch"] > pinned[0]["epoch"],
                  f"the pin did not roll forward: {pinned}")
        finally:
            client.close()
        out["pinned"] = pinned
        print(f"phase 3s (d): pinned reads bit-identical to the entries' .blk bytes, "
              f"rolled forward {pinned}", flush=True)

        read_res = sender.wait_result(job, timeout=SERVE_TIMEOUT * 3, poll=15.0)
        server._stop_serving()
        # K1's device time a gather, profiled only now that the job is done:
        # the profiler records every kernel of the process, the job's too
        for name, arm in arms.items():
            arm["k1_device_ms_a_gather"] = k1_gather_ms(arm["mean_gather_keys"] or 16)
            print(f"phase 3s (b): {name}: K1 device ms a gather "
                  f"{arm['k1_device_ms_a_gather']}", flush=True)
        rc, reply = cli_out(base + ["--job-id", job + "-unread"])
        check(rc == 0 and reply["ok"], f"submit: {reply}")
        unread_res = sender.wait_result(job + "-unread", timeout=SERVE_TIMEOUT * 3, poll=15.0)
        (w_read,) = read_res["workers"].values()
        (w_unread,) = unread_res["workers"].values()
        check(len(w_read["batch_losses"]) == SERVE_EPOCHS * BATCHES
              and all(math.isfinite(v) for v in w_read["batch_losses"]),
              "bench-widedeep's losses with readers")
        check(float_bits(w_read["batch_losses"]) == float_bits(w_unread["batch_losses"]),
              "the read job's losses are not the bits of the unread run's")
        out["losses_bit_identical_with_and_without_readers"] = True
        out["epoch_seconds_with_readers"] = w_read["epoch_seconds"]
        out["epoch_seconds_without_readers"] = w_unread["epoch_seconds"]
        print(f"phase 3s (b): the job's losses with readers the bits of the unread "
              f"run's; median epoch seconds with readers "
              f"{statistics.median(w_read['epoch_seconds'])}, without "
              f"{statistics.median(w_unread['epoch_seconds'])}", flush=True)
        return server, port
    except BaseException:
        server.shutdown(timeout=60)
        raise
    finally:
        restore()
        os.environ.pop("HARMONY_SERVE_BATCH_WINDOW_MS", None)
        os.environ.pop("HARMONY_SERVE_CACHE_MB", None)


def decoded_block(d, bid):
    """Block ``bid`` of the entry in ``d``, decoded on the CPU from its file: a
    ``.blk`` through the codec, or an ``.npy`` where the codec was not built."""
    from harmony_tpu_torch import native

    blk = os.path.join(d, f"{bid}.blk")
    if os.path.exists(blk):
        return native.blk_read(blk)
    return np.load(os.path.join(d, f"{bid}.npy"))


def serve_raw(port, job, keys, mode="live"):
    """One framed lookup on a connection of its own: the reply frame."""
    from harmony_tpu_torch.serving import protocol

    sock = protocol.connect(("127.0.0.1", port), timeout=SERVE_TIMEOUT)
    sock.settimeout(SERVE_TIMEOUT)
    try:
        protocol.send_arrays(sock, {"op": "lookup", "r": 1, "job": job, "mode": mode},
                             (np.asarray(keys, np.int32),))
        return protocol.recv_frame(sock)
    finally:
        sock.close()


def serve_quiescent(tables, cpu_tables, universes, wrappers, tag):
    """Phase 3s (c) (and (e)'s tables): each table behind a ServingEndpoint of
    its own (``table_fn`` direct) in every arm; every row byte-identical to
    the CPU copy's ``multi_get`` of the same keys. Each arm's launches are
    read with the counts set to 0 just before it: K1 once a gather, no other
    kernel. Returns the arms' figures and the summed launches."""
    from harmony_tpu_torch.serving import ServingEndpoint, protocol

    gathers, restore = counted_gathers()
    launches = dict.fromkeys((w.__name__ for w in wrappers), 0)
    arms = {}
    try:
        for job, table in tables.items():
            keys = serve_key_lists(universes[job])
            want = [[cpu_tables[job].multi_get(k) for k in ks] for ks in keys]
            for window_ms, cache_mb in SERVE_ARMS:
                ep = ServingEndpoint(table_fn=lambda j, t=table, n=job: t if j == n else None,
                                     cache_mb=cache_mb, window_ms=window_ms)
                ep.start()
                socks = []
                try:
                    for _ in range(SERVE_READERS):
                        s = protocol.connect(("127.0.0.1", ep.port), timeout=SERVE_TIMEOUT)
                        s.settimeout(SERVE_TIMEOUT)
                        socks.append(s)
                    del gathers[:]
                    reset_counts(*wrappers)

                    def read(r, i):
                        protocol.send_arrays(socks[r], {"op": "lookup", "r": i, "job": job,
                                                        "mode": "live"}, (keys[r][i],))
                        frame = protocol.recv_frame(socks[r])
                        if frame is None or frame.get("op") != "rows":
                            raise AssertionError(f"frame {frame}")
                        if frame["data"][0].tobytes() != want[r][i].tobytes():
                            raise AssertionError(f"{job}: rows differ from the CPU copy's")

                    wall, lat = run_storm(read)
                    counts = launch_counts(wrappers)
                    stats = ep.stats()
                finally:
                    for s in socks:
                        s.close()
                    ep.stop()
                check(stats["errors"] == 0, f"{job}: {stats['errors']} error frames")
                check(counts["gather_rows"] == len(gathers) > 0
                      and not any(v for k, v in counts.items() if k != "gather_rows"),
                      f"{job} arm {window_ms}/{cache_mb}: launches {counts} for "
                      f"{len(gathers)} gathers (expected K1 once a gather, nothing else)")
                for k, v in counts.items():
                    launches[k] += v
                name = f"{job} window_{window_ms:g}ms_cache_{cache_mb}mb"
                arms[name] = arm_figures(stats, job, wall, lat, gathers)
                arms[name]["k1_launches"] = counts["gather_rows"]
                print(f"phase 3s ({tag}): {name}: rows byte-identical to the CPU's, "
                      f"{json.dumps(arms[name])}", flush=True)
    finally:
        restore()
    return arms, launches


def serve_exact_checks(table, cpu_table, job, universe):
    """Phase 3s (c)'s edges, on one table: a 65,536-key lookup byte-identical
    (its round trip ms and K1's device ms), 65,537 keys refused, and a layout
    announcement and a ``multi_update`` (on a side stream behind a spin, so a
    read that did not wait for the write's stream would see the old bytes)
    each retiring the cached rows."""
    from harmony_tpu_torch.serving import ServingEndpoint, protocol, service

    def endpoint(cache_mb):
        ep = ServingEndpoint(table_fn=lambda j: table if j == job else None,
                             cache_mb=cache_mb, window_ms=0.0)
        ep.start()
        return ep

    ep = endpoint(0)   # no cache: every big lookup is one K1 gather
    try:
        rng = np.random.default_rng(SERVE_SEED)
        big = rng.choice(universe, service._MAX_KEYS).astype(np.int32)
        serve_raw(ep.port, job, big)   # warm
        t0 = time.perf_counter()
        frame = serve_raw(ep.port, job, big)
        rt_ms = (time.perf_counter() - t0) * 1e3
        check(frame["op"] == "rows"
              and frame["data"][0].tobytes() == cpu_table.multi_get(big).tobytes(),
              f"{job}: the 65,536-key lookup differs from the CPU's")
        k1 = sum(ms for name, ms in device_kernels(lambda: table.multi_get(big), 20).items()
                 if "gather_rows" in name)
        # one reader alone: a 16-key read's round trip beside the table's
        # multi_get of the same keys (the rest is the endpoint and the wire)
        one = np.asarray(universe[:SERVE_KEYS], np.int32)
        sock = protocol.connect(("127.0.0.1", ep.port), timeout=SERVE_TIMEOUT)
        sock.settimeout(SERVE_TIMEOUT)
        try:
            rt = []
            for i in range(200):
                t0 = time.perf_counter()
                protocol.send_arrays(sock, {"op": "lookup", "r": i, "job": job,
                                            "mode": "live"}, (one,))
                protocol.recv_frame(sock)
                rt.append((time.perf_counter() - t0) * 1e3)
        finally:
            sock.close()
        mg = []
        for _ in range(200):
            t0 = time.perf_counter()
            table.multi_get(one)
            mg.append((time.perf_counter() - t0) * 1e3)
        over = serve_raw(ep.port, job, np.zeros(service._MAX_KEYS + 1, np.int32))
        check(over["op"] == "error" and "request bound" in over["error"],
              f"{job}: 65,537 keys not refused: {over}")
        check(ep.stats()["errors"] == 1, f"{job}: errors {ep.stats()['errors']}, expected "
              "the one refusal")
    finally:
        ep.stop()
    ep = endpoint(64)
    try:
        hot = np.asarray(universe[:SERVE_KEYS], np.int32)
        serve_raw(ep.port, job, hot)
        cached = ep.cache.stats()["entries"]
        check(cached == SERVE_KEYS, f"{job}: {cached} rows cached")
        layout = table.layout_version
        table.announce_reshard(None)
        check(ep.cache.stats()["entries"] == 0, f"{job}: the announcement kept the rows")
        frame = serve_raw(ep.port, job, hot)
        check(frame["layout_version"] == table.layout_version == layout + 1
              and frame["data"][0].tobytes() == cpu_table.multi_get(hot).tobytes(),
              f"{job}: the read after the announcement")
        ones = np.ones((SERVE_KEYS, SERVE_WIDTH), np.float32)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            torch.cuda._sleep(200_000_000)     # 2e8 clock cycles of spinning on the side stream
            table.multi_update(hot, ones)
        cpu_table.multi_update(hot, ones)
        frame = serve_raw(ep.port, job, hot)
        check(frame["data"][0].tobytes() == cpu_table.multi_get(hot).tobytes(),
              f"{job}: the read after a multi_update on another stream shows old bytes")
        check(ep.stats()["errors"] == 0, f"{job}: {ep.stats()['errors']} error frames")
    finally:
        ep.stop()
    return {"max_keys_round_trip_ms": rt_ms, "max_keys_k1_device_ms": k1,
            "one_reader_round_trip_ms_p50": float(np.percentile(rt, 50)),
            "one_reader_round_trip_ms_p99": float(np.percentile(rt, 99)),
            "multi_get_16_keys_ms_p50": float(np.percentile(mg, 50))}


def serve_tables():
    """Phase 3s (c)'s two tables on the card, filled from the seed, and their
    CPU copies: bench-widedeep's dense table and bench-fm-hash's hash table."""
    from harmony_tpu_torch.apps.widedeep import FMTrainer, WideDeepTrainer
    from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    rng = np.random.default_rng(SERVE_SEED)
    dcfg = WideDeepTrainer(**{k: v for k, v in (("vocab_size", 100_000), ("num_slots", 16),
                                                ("emb_dim", 16), ("hidden", 128))}
                           ).model_table_config()
    check(TableSpec(dcfg).num_rows == SERVE_ROWS and dcfg.value_shape == (SERVE_WIDTH,),
          f"bench-widedeep's table is {dcfg}")
    arr = torch.from_numpy(rng.standard_normal(TableSpec(dcfg).storage_shape)
                           .astype(np.float32))
    dense = DenseTable(TableSpec(dcfg), "cuda", arr=arr)
    dense_cpu = DenseTable(TableSpec(dcfg), "cpu", arr=arr.clone())
    hcfg = FMTrainer(**FM_HASH_APP).model_table_config()
    spec = HashTableSpec(hcfg)
    check(spec.num_slots == 524_288, f"bench-fm-hash's table has {spec.num_slots} slots")
    keys = (rng.choice(2**31 - 4, size=SERVE_HASH_KEYS, replace=False) + 1).astype(np.int32)
    hashed = DeviceHashTable(spec, "cuda")
    dropped = hashed.multi_put(keys, rng.standard_normal((SERVE_HASH_KEYS, SERVE_WIDTH))
                               .astype(np.float32))
    check(dropped == 0, f"{dropped} keys refused by the hash table")
    sk, v = hashed.state
    hashed_cpu = DeviceHashTable(spec, "cpu", state=(sk.cpu(), v.cpu()))
    # absent keys read as init: a tenth of the universe is never inserted
    absent = (rng.choice(2**31 - 4, size=SERVE_HASH_KEYS // 10) + 1).astype(np.int32)
    universe = np.concatenate([keys[:SERVE_HASH_KEYS - len(absent)], absent])
    return ({"wd-dense": dense, "fm-hash": hashed},
            {"wd-dense": dense_cpu, "fm-hash": hashed_cpu},
            {"wd-dense": np.arange(dcfg.capacity), "fm-hash": universe})


class LabeledRows:
    """A values-only parser over libsvm records: [label, features] a row (the
    bulk loader's generated keys need values only)."""

    def __init__(self, num_features):
        from harmony_tpu_torch.data import LibSvmParser

        self.inner = LibSvmParser(num_features)

    def parse(self, records):
        x, y = self.inner.parse(records)
        return np.concatenate([y[:, None], x], axis=1)


def serve_bulk_loads(root):
    """Phase 3s (e): a libsvm file at HIGGS's width into a dense table and a
    value file into bench-fm-hash's hash table, with generated keys, on the
    card and on the CPU; the tables byte-identical; records/s of each."""
    from harmony_tpu_torch.apps.widedeep import FMTrainer
    from harmony_tpu_torch.config.params import TableConfig
    from harmony_tpu_torch.data import CsvParser
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster, TableHandle
    from harmony_tpu_torch.table.hashtable import MIN_KEY

    rng = np.random.default_rng(SERVE_SEED)
    svm = os.path.join(root, "higgs.libsvm")
    x = rng.standard_normal((BULK_ROWS, BULK_FEATURES)).astype(np.float32)
    y = rng.integers(0, 2, BULK_ROWS)
    with open(svm, "w") as f:
        for i in range(BULK_ROWS):
            f.write(f"{y[i]} " + " ".join(f"{j + 1}:{x[i, j]:.7g}"
                                          for j in range(BULK_FEATURES)) + "\n")
    csv = os.path.join(root, "rows.csv")
    vals = rng.standard_normal((BULK_ROWS, SERVE_WIDTH)).astype(np.float32)
    np.savetxt(csv, vals, fmt="%.7g", delimiter=",")
    dcfg = TableConfig(table_id="bulk-higgs", capacity=BULK_ROWS,
                       value_shape=(BULK_FEATURES + 1,), num_blocks=256)
    hcfg = FMTrainer(**FM_HASH_APP).model_table_config().replace(table_id="bulk-kv")
    out, tables = {}, {}
    for device in ("cuda", "cpu"):
        master = ETMaster(DevicePool([torch.device(device)]))
        ex = [e.id for e in master.add_executors(1)]
        for name, cfg, path, parser in (("higgs", dcfg, svm, LabeledRows(BULK_FEATURES)),
                                        ("kv", hcfg, csv, CsvParser())):
            handle = TableHandle(master, master.create_table(cfg, ex), ex)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = handle.load([path], parser, generate_keys=True)
            if device == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(n == BULK_ROWS, f"{name} on {device}: {n} records loaded")
            out[f"{name}_{device}_records_per_s"] = BULK_ROWS / secs
            tables[(name, device)] = handle.table
    for name in ("higgs", "kv"):
        card, cpu = tables[(name, "cuda")], tables[(name, "cpu")]
        state = (card.state if name == "kv" else (card.array,))
        cpu_state = (cpu.state if name == "kv" else (cpu.array,))
        check(all(a.cpu().numpy().tobytes() == b.numpy().tobytes()
                  for a, b in zip(state, cpu_state)),
              f"the {name} load on the card differs from the CPU's")
    kv = tables[("kv", "cuda")]
    with open(csv) as f:
        lines = f.read().splitlines()
    ends = CsvParser().parse([lines[0], lines[-1]])
    check(kv.num_present() == BULK_ROWS
          and kv.multi_get([MIN_KEY, MIN_KEY + BULK_ROWS - 1]).tobytes() == ends.tobytes(),
          "the hash table's generated keys do not run from MIN_KEY")
    print(f"phase 3s (e): libsvm (HIGGS width, {BULK_ROWS} rows) and value-file loads "
          f"byte-identical on card and CPU, generated hash keys from MIN_KEY; "
          f"{json.dumps(out)}", flush=True)
    return out, ({"bulk-higgs": tables[("higgs", "cuda")], "bulk-kv": kv},
                 {"bulk-higgs": tables[("higgs", "cpu")], "bulk-kv": tables[("kv", "cpu")]},
                 {"bulk-higgs": np.arange(BULK_ROWS),
                  "bulk-kv": np.arange(MIN_KEY, MIN_KEY + BULK_ROWS)})


def serve_sparse_refusal(server, port, root):
    """Phase 3s (d)'s hash case: bench-fm-hash's table chained under the
    server's root; a pinned read is refused with an error frame that names
    the reason."""
    from harmony_tpu_torch.apps.widedeep import FMTrainer
    from harmony_tpu_torch.checkpoint import CheckpointManager
    from harmony_tpu_torch.runtime.master import TableHandle
    from harmony_tpu_torch.serving import ServingClient
    from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec

    cfg = FMTrainer(**FM_HASH_APP).model_table_config().replace(table_id="fm-hash:fm-model")
    table = DeviceHashTable(HashTableSpec(cfg), "cuda")
    table.multi_put(np.arange(1, 1025), np.ones((1024, SERVE_WIDTH), np.float32))
    CheckpointManager.for_job(root, "fm-hash").checkpoint(
        TableHandle(None, table, ["executor-0"]), commit=True, app_meta={"epoch": 0.0})
    client = ServingClient(port=port, timeout=SERVE_TIMEOUT)
    errors = server.serving.stats()["errors"] if server.serving is not None else 0
    try:
        client.lookup("fm-hash", [1, 2, 3], mode="pinned")
        fail("a pinned read of a hash table's chain was served")
    except RuntimeError as e:
        msg = str(e)
    finally:
        client.close()
    check("hash table" in msg and "refused" in msg, f"the refusal says {msg!r}")
    check(server.serving.stats()["errors"] == errors + 1, "the refusal was not one error frame")
    print(f"phase 3s (d): a pinned read of bench-fm-hash's chain refused: {msg}", flush=True)
    return msg


def run_serving():
    """Phase 3s: online serving on the card (see the module docstring).
    Returns the ``serving`` path's launches (the reads of (c) and (e)) and
    the phase's results."""
    import tempfile

    wrappers = all_wrappers()
    root = tempfile.mkdtemp(prefix="chip-smoke-serving-")
    out = {"card": gpu_identity()}
    t_phase = time.perf_counter()
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        out["start_jobserver"] = serve_command_plane_subprocess(os.path.join(root, "proc"))
        print(f"phase 3s (a): start-jobserver as a process: {out['start_jobserver']}",
              flush=True)
        server, port = serve_training(os.path.join(root, "chains"), wrappers, out)
        try:
            out["sparse_pinned_refusal"] = serve_sparse_refusal(
                server, port, os.path.join(root, "chains"))
            rc, reply = cli_out(["shutdown", "--port", str(port)])
            check(rc == 0 and reply == {"ok": True}, f"shutdown: {reply}")
            deadline = time.monotonic() + SERVE_TIMEOUT
            while server.state != "CLOSED" and time.monotonic() < deadline:
                time.sleep(0.05)
            check(server.state == "CLOSED" and server.serving is None,
                  f"the server did not close: {server.state}")
        finally:
            server.shutdown(timeout=60)
        tables, cpu_tables, universes = serve_tables()
        out["quiescent_arms"], launches = serve_quiescent(
            tables, cpu_tables, universes, wrappers, "c")
        for job in tables:
            out[f"{job}_exact"] = serve_exact_checks(
                tables[job], cpu_tables[job], job, universes[job])
            print(f"phase 3s (c): {job}: {json.dumps(out[f'{job}_exact'])}", flush=True)
        del tables, cpu_tables
        out["bulk"], (btables, bcpu, buni) = serve_bulk_loads(root)
        arms, more = serve_quiescent(btables, bcpu, buni, wrappers, "e")
        out["bulk_arms"] = arms
        for k, v in more.items():
            launches[k] += v
    finally:
        os.environ.pop("HARMONY_PUSH_VIA", None)
        shutil.rmtree(root, ignore_errors=True)
    out["phase_seconds"] = time.perf_counter() - t_phase
    out["serving_launches"] = launches
    return launches, out


# -- phase 3t: tables and Dolphin jobs over a device mesh ------------------------

# Slots of the virtual pool on cuda:0 (the port's counterpart of the
# reference's virtual devices): meshes (data 1, model 4) and (2, 2).
MESH_SLOTS = 4
MESH_SHAPES = ((1, 4), (2, 2))
# bench-widedeep's push key count: 4,096 examples x 16 slots and 1,944 tail rows.
WD_BATCH = N_EXAMPLES // BATCHES


def wd_trainer(**extra):
    from harmony_tpu_torch.apps.widedeep import WideDeepTrainer

    return WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16, hidden=128,
                           step_size=0.1, **extra)


def mesh_pools(cards: int):
    """(name, card slots, CPU slots) of each pool phase 3t drives: the
    virtual pool on cuda:0, and the real cards where there are two or more."""
    from harmony_tpu_torch.parallel.mesh import DevicePool

    pools = [("virtual", DevicePool.virtual("cuda:0", MESH_SLOTS).slots,
              DevicePool.virtual("cpu", MESH_SLOTS).slots)]
    if cards >= 2:
        n = 4 if cards >= 4 else 2
        pools.append(("cards", DevicePool().slots[:n], DevicePool.virtual("cpu", n).slots))
    return pools


def counted(wrappers, fn):
    """``fn()``'s result and the launches it made."""
    reset_counts(*wrappers)
    out = fn()
    return out, {w.__name__: w.launches for w in wrappers}


def table_op_bytes(table, keys, deltas, wrappers):
    """Phase 3t (b)'s sequence on one dense table: the outputs of each op as
    host bytes, and each op's launches."""
    spec = table.spec
    outs, launches = {}, {}

    def op(name, fn):
        out, launches[name] = counted(wrappers, fn)
        torch.cuda.synchronize()
        if out is not None:
            outs[name] = np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)

    k = keys.to(table.device)
    d = deltas.to(table.device)
    op("pull", lambda: table.apply_step(lambda a: (a, spec.pull(a, k))))
    for via in ("mxu", "sparse"):
        op(f"push_{via}", lambda via=via: table.apply_step(
            lambda a: (spec.push(a, k, d, via=via), None)))
        op(f"pull_after_{via}", lambda: table.apply_step(lambda a: (a, spec.pull(a, k))))
    op("pull_all", lambda: table.pull_array())
    op("push_all", lambda: table.apply_step(lambda a: (spec.push_all(
        a, torch.full((spec.config.capacity, *spec.value_shape), 0.5,
                      device=table.device)), None)))
    op("multi_get", lambda: table.multi_get(keys[:4096].numpy()))
    exp, launches["export_blocks"] = counted(wrappers, table.export_blocks)
    outs["export_blocks"] = np.stack([exp[b] for b in sorted(exp)])
    return outs, launches


def hash_op_bytes(table, keys, deltas, wrappers):
    spec = table.spec
    outs, launches = {}, {}
    k, d = keys.to(table.device), deltas.to(table.device)

    def step(state):
        state, rows, tok = spec.pull(state, k)
        return spec.push(state, tok, d), rows

    rows, launches["pull_push"] = counted(wrappers, lambda: table.apply_step(step))
    outs["pull"] = rows.cpu().numpy()
    got, launches["multi_get"] = counted(wrappers, lambda: table.multi_get(keys[:4096].numpy()))
    outs["multi_get"] = got
    exp, launches["export_blocks"] = counted(wrappers, table.export_blocks)
    outs["slot_keys"] = np.stack([exp[b][0] for b in sorted(exp)])
    outs["values"] = np.stack([exp[b][1] for b in sorted(exp)])
    return outs, launches


def same_outputs(a, b):
    return sorted(a) == sorted(b) and all(
        a[n].dtype == b[n].dtype and a[n].shape == b[n].shape and a[n].tobytes() == b[n].tobytes()
        for n in a)


def sharded_table_ops(pool_name, slots, cpu_slots, wrappers):
    """Phase 3t (b): bench-widedeep's dense table on (1, 4) and (2, 2), a
    replicated 10-block table on (1, 4), bench-fm-hash's hash table on (1, 4):
    every op's bytes equal on the card's mesh, the CPU's mesh and one slot of
    the card; K1 once on each shard a read touches, the fold once a slot."""
    from harmony_tpu_torch.apps.widedeep import FMTrainer, make_synthetic, make_synthetic_sparse
    from harmony_tpu_torch.parallel.mesh import build_mesh
    from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    n = len(slots)
    rng = np.random.default_rng(31)
    trainer = wd_trainer()
    ids, _ = make_synthetic(WD_BATCH, 100000, 16, seed=31)
    keys = trainer.pull_keys((torch.as_tensor(ids),)).to(torch.int32)
    spec = TableSpec(trainer.model_table_config())
    storage = torch.as_tensor(rng.standard_normal(spec.storage_shape).astype(np.float32))
    deltas = torch.as_tensor(rng.standard_normal((len(keys), *spec.value_shape))
                             .astype(np.float32))
    out = {}
    cases = [(f"bench-widedeep ({d}, {m})", spec, (d, m)) for d, m in
             ((1, n), (2, n // 2))]
    rep_cfg = trainer.model_table_config().replace(table_id="rep", num_blocks=10)
    cases.append((f"replicated 10 blocks (1, {n})", TableSpec(rep_cfg), (1, n)))
    for name, sp, (d, m) in cases:
        st = storage if sp is spec else torch.as_tensor(
            rng.standard_normal(sp.storage_shape).astype(np.float32))
        card = DenseTable(sp, build_mesh(slots, data=d, model=m), arr=st)
        results = [table_op_bytes(t, keys, deltas, wrappers) for t in (
            card, DenseTable(sp, build_mesh(cpu_slots, data=d, model=m), arr=st),
            DenseTable(sp, slots[0].device, arr=st))]
        (c_out, c_l), (p_out, p_l), (o_out, _) = results
        check(same_outputs(c_out, p_out) and same_outputs(c_out, o_out),
              f"phase 3t (b) {pool_name} {name}: the card's mesh, the CPU's mesh and one "
              f"slot disagree on {[k for k in c_out if c_out[k].tobytes() != o_out[k].tobytes()]}")
        sh = card.sharding
        reads, slots_n = sh.num_shards, n
        want = {"pull": {"gather_rows": reads}, "push_mxu": {"weighted_histogram": slots_n},
                "push_sparse": {"segment_sum_rows": slots_n},
                "multi_get": {"gather_rows": reads},
                "pull_all": {"gather_rows": reads}}
        for op, counts in want.items():
            got = {k: v for k, v in c_l[op].items() if v}
            check(got == counts, f"phase 3t (b) {pool_name} {name} {op}: launches {got}, "
                                 f"expected {counts} (one a shard the read touches, one a "
                                 f"slot a push writes)")
        check(not any(p_l[op][w] for op in p_l for w in p_l[op]),
              f"phase 3t (b): a kernel launched on the CPU mesh ({p_l})")
        out[name] = {"sharding": list(sh.spec), "launches": {op: {k: v for k, v in c.items() if v}
                                                             for op, c in c_l.items()}}
        print(f"phase 3t (b) {pool_name}: {name} P{tuple(sh.spec)}: pull, the mxu and "
              f"sparse pushes, pull_all, push_all, multi_get and export_blocks byte-identical "
              f"on the card's mesh, the CPU's mesh and one slot; launches {out[name]['launches']}",
              flush=True)

    fm = FMTrainer(vocab_size=100000, num_slots=16, emb_dim=16, step_size=0.1, sparse=True)
    hspec = HashTableSpec(fm.model_table_config())
    sids, _ = make_synthetic_sparse(WD_BATCH, 100000, 16, seed=31)
    hkeys = fm.pull_keys((torch.as_tensor(sids),)).to(torch.int32)
    hd = torch.as_tensor(rng.standard_normal((len(hkeys), *hspec.value_shape)).astype(np.float32))
    tables = [DeviceHashTable(hspec, build_mesh(slots, data=1, model=n)),
              DeviceHashTable(hspec, build_mesh(cpu_slots, data=1, model=n)),
              DeviceHashTable(hspec, slots[0].device)]
    (c_out, c_l), (p_out, _), (o_out, _) = [hash_op_bytes(t, hkeys, hd, wrappers)
                                             for t in tables]
    name = f"bench-fm-hash (1, {n})"
    check(same_outputs(c_out, p_out) and same_outputs(c_out, o_out),
          f"phase 3t (b) {pool_name} {name}: card mesh, CPU mesh and one slot disagree")
    want = {"pull_push": {"gather_rows": n, "segment_sum_rows": n},
            "multi_get": {"gather_rows": n}}
    for op, counts in want.items():
        got = {k: v for k, v in c_l[op].items() if v}
        check(got == counts, f"phase 3t (b) {pool_name} {name} {op}: launches {got}, "
                             f"expected {counts}")
    present = int((c_out["slot_keys"] < 0).sum())
    out[name] = {"keys": len(hkeys), "present": present,
                 "launches": {op: {k: v for k, v in c.items() if v} for op, c in c_l.items()}}
    print(f"phase 3t (b) {pool_name}: {name}: {len(hkeys)} keys ({present} slots taken), "
          f"pull, push, multi_get and export_blocks byte-identical on the card's mesh, the "
          f"CPU's mesh and one slot; launches {out[name]['launches']}", flush=True)
    return out


def pool_server(slots, root=None):
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    server = JobServer(len(slots), device_pool=DevicePool(slots), chkp_root=root)
    server.start()
    return server


def wd_mesh_config(job_id, epochs, data_axis=1, period=0, **user):
    from harmony_tpu_torch import cli

    argv = SLICE_ARGS + ["--epochs", str(epochs), "--workers", "1", "--job-id", job_id]
    if period:
        argv += ["--model-chkp-period", str(period)]
    if data_axis > 1:
        argv += ["--set", f"data_axis={data_axis}"]
    config = cli.build_config("widedeep", cli.build_parser().parse_args(argv))
    return config.replace(user={**config.user, **user})


def submit_one(server, config):
    res = server.submit(config).result(timeout=600)
    (w,) = res["workers"].values()
    return w, res


def entry_blk(mgr, chkp_id):
    d = mgr._dir_of(chkp_id)
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n != "manifest.json"}


def mesh_profile(slots, config):
    """Phase 3t (c)'s step figures: bench-widedeep's fused step on a table
    over ``slots`` (one worker, outside the JobServer), as phase 5 measures a
    step."""
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    master = ETMaster(DevicePool(slots))
    entity = DolphinJobEntity(config)
    entity.setup(master, [e.id for e in master.add_executors(len(slots))])
    try:
        prof = profile_worker(entity.make_worker(), BATCHES, top_n=6)
    finally:
        entity.cleanup()
    prof["samples_per_sec"] = WD_BATCH / prof["step_ms"] * 1e3
    return prof


def sharded_jobs(pool_name, slots, wrappers, refs, root):
    """Phase 3t (c) and (d): jobs through a JobServer over ``slots``."""
    from harmony_tpu_torch import bench
    from harmony_tpu_torch.checkpoint import CheckpointManager

    n = len(slots)
    steps = EPOCHS * BATCHES
    out = {}
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        one = pool_server(slots[:1], root)
        try:
            w1, _ = submit_one(one, wd_mesh_config("wd-one", EPOCHS, period=1))
        finally:
            one.shutdown(timeout=600)
        if refs.get("wd_losses") is not None:
            check(w1["batch_losses"] == refs["wd_losses"],
                  "phase 3t: the one-slot chained bench-widedeep differs from phase 3's run")
        server = pool_server(slots, root)
        try:
            (w4, _), launches = counted(wrappers, lambda: submit_one(
                server, wd_mesh_config("wd-mesh", EPOCHS, period=1)))
            k1, fold = probe_launches(w4)
            want = {"gather_rows": n * (steps + k1), "segment_sum_rows": 0,
                    "weighted_histogram": n * (steps + fold)}
            check(w4["mesh"] == {"data": 1, "model": n} and launches == want,
                  f"phase 3t (c) {pool_name}: bench-widedeep on {w4['mesh']}: launches "
                  f"{launches}, expected {want} (K1 and K3 once a shard a step and a probe call)")
            check(w4["batch_losses"] == w1["batch_losses"],
                  f"phase 3t (c) {pool_name}: bench-widedeep at data_axis 1 is not the bits "
                  f"of the one-slot run")
            out["widedeep_data_axis_1"] = {"launches": dict(launches), "launches_per_step": {
                k: v / steps for k, v in launches.items()}, "mesh": w4["mesh"],
                "samples_per_sec": N_EXAMPLES / w4["epoch_seconds"][-1],
                "one_slot_samples_per_sec": N_EXAMPLES / w1["epoch_seconds"][-1]}
            # (d): the chain across meshes
            m1 = CheckpointManager.for_job(root, "wd-one")
            m4 = CheckpointManager.for_job(root, "wd-mesh")
            e1, e4 = newest_entry(m1), newest_entry(m4)
            b1, b4 = entry_blk(m1, e1.chkp_id), entry_blk(m4, e4.chkp_id)
            check(b1 and b1 == b4, f"phase 3t (d) {pool_name}: the {n}-slot chain's newest "
                                   f"entry's blocks differ from the one-slot run's")
            check(e4.ownership == [b % n for b in range(len(e4.ownership))],
                  f"phase 3t (d): the manifest's ownership {e4.ownership[:8]}...")
            ex1 = [server.master.executor_ids()[0]]
            got = restored_bits(m4, server.master, e4.chkp_id, ex1)
            want_t = restored_bits(m1, server.master, e1.chkp_id, ex1)
            check(same_bits(got[0], want_t[0]), f"phase 3t (d) {pool_name}: the {n}-slot "
                  "entry restored on one slot differs from the one-slot table")

            d2 = [submit_one(server, wd_mesh_config(f"wd-d2-{i}", EPOCHS, data_axis=2))[0]
                  for i in range(2)]
            check(d2[0]["batch_losses"] == d2[1]["batch_losses"]
                  and d2[0]["mesh"] == {"data": 2, "model": n // 2}
                  and d2[0]["step_mode"] == "data_parallel",
                  f"phase 3t (c) {pool_name}: data_axis 2 is not the same bits twice")
            gap = max(abs(a - b) for a, b in zip(d2[0]["batch_losses"], w1["batch_losses"]))
            check(gap <= LOSS_ATOL, f"phase 3t (c) {pool_name}: data_axis 2 differs from the "
                                    f"one-slot run by {gap} > {LOSS_ATOL}")
            out["widedeep_data_axis_2"] = {"max_abs_gap_vs_one_slot": gap,
                                           "batch_losses": d2[0]["batch_losses"],
                                           "mesh": d2[0]["mesh"],
                                           "samples_per_sec": N_EXAMPLES
                                           / d2[0]["epoch_seconds"][-1]}
        finally:
            server.shutdown(timeout=600)

        # the chain restores onto one slot and the resumed run continues
        m4.delete(e4.chkp_id)
        one = pool_server(slots[:1], root)
        try:
            resumed, _ = submit_one(one, wd_mesh_config("wd-mesh", EPOCHS, period=1,
                                                        resume_from_chain=True))
        finally:
            one.shutdown(timeout=600)
        check(resumed["starting_epoch"] == 1
              and resumed["batch_losses"] == w1["batch_losses"][BATCHES:],
              f"phase 3t (d) {pool_name}: the resume on one slot from the {n}-slot chain "
              f"is not the uninterrupted run's bits")
        check(entry_blk(m4, newest_entry(m4).chkp_id) == b1,
              f"phase 3t (d) {pool_name}: the resumed run's table differs")
        print(f"phase 3t (d) {pool_name}: the {n}-slot chain's newest entry byte-identical "
              f"to the one-slot run's ({len(b1)} block files), restored on one slot to the "
              f"same table, resumed there at epoch 1 to the uninterrupted run's bits", flush=True)
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")

    if pool_name != "virtual":
        return out, launches
    # the trio and bench-fm-hash on the mesh (counted with the main path)
    server = pool_server(slots)
    try:
        configs, _ = bench.job_configs(TRIO_SCALE, bench.EPOCHS)
        reset_counts(*wrappers)
        futures = [server.submit(c) for c in configs]
        trio = {f.result(timeout=600)["job_id"]: f.result()["workers"] for f in futures}
        fm4, _ = submit_one(server, hash_job("fm", EPOCHS))
        for w in wrappers:
            launches[w.__name__] += w.launches
    finally:
        server.shutdown(timeout=600)
    for job_id, workers in trio.items():
        (w,) = workers.values()
        check(w["batch_losses"] == refs["trio"][job_id],
              f"phase 3t (c): {job_id} on {n} slots is not the bits of phase 3d's run")
    check(fm4["batch_losses"] == refs["fm_hash"],
          f"phase 3t (c): bench-fm-hash on {n} slots is not the bits of phase 3h's run")
    out["trio_bits_of_one_slot"] = out["fm_hash_bits_of_one_slot"] = True
    out["fm_hash_samples_per_sec"] = N_EXAMPLES / fm4["epoch_seconds"][-1]

    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        base = wd_mesh_config("wd-profile", 1)
        base = base.replace(params=base.params.replace(comm_probe_period=0))
        out["profile"] = {"one_slot": mesh_profile(slots[:1], base),
                          f"{n}_slots": mesh_profile(slots, base)}
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    return out, launches


def device_guard_check(cards):
    """Phase 3t (e): every kernel wrapper called with operands on cuda:1 while
    cuda:0 is current gives the bytes it gives on cuda:0."""
    if cards < 2:
        return "not run: one card"
    from harmony_tpu_torch.ops import attention as A
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    rng = np.random.default_rng(5)
    table = torch.as_tensor(rng.standard_normal((4096, 17)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 4096, 20000).astype(np.int32))
    w = torch.as_tensor(rng.standard_normal((20000, 17)).astype(np.float32))
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 4, 256, 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    calls = {
        "gather_rows": lambda d: gather_rows(table.to(d), idx.to(d)),
        "segment_sum_rows": lambda d: segment_sum_rows(w.to(d), idx.to(d), 4096),
        "weighted_histogram": lambda d: weighted_histogram(idx.to(d), w.to(d), 4096),
        "flash": lambda d: A.flash_attention_lse(q.to(d), k.to(d), v.to(d), causal=True),
    }
    out = {}
    with torch.cuda.device(0):
        for name, fn in calls.items():
            a, b = fn(torch.device("cuda", 0)), fn(torch.device("cuda", 1))
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            check(all(x.device.index == 1 for x in b)
                  and all(same_bits(x, y.to(x.device)) for x, y in zip(a, b)),
                  f"phase 3t (e): {name} on cuda:1 with cuda:0 current differs")
            out[name] = "same bytes"
    return out


def run_sharded(refs):
    """Phase 3t: tables and Dolphin jobs over a mesh of slots."""
    import tempfile

    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows

    t0 = time.perf_counter()
    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    cards = torch.cuda.device_count()
    pools = mesh_pools(cards)
    out = {"cards": cards, "pools": {name: [str(s) for s in slots]
                                     for name, slots, _ in pools}}
    if cards < 2:
        out["real_mesh"] = "not run: one card"
    print(f"phase 3t (a): {json.dumps(out)}", flush=True)
    launches = None
    for name, slots, cpu_slots in pools:
        out[f"table_ops_{name}"] = sharded_table_ops(name, slots, cpu_slots, wrappers)
        root = tempfile.mkdtemp(prefix="harmony-3t-")
        try:
            jobs, counts = sharded_jobs(name, slots, wrappers, refs, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out[f"jobs_{name}"] = jobs
        if name == "virtual":
            launches = counts
    out["device_guard"] = device_guard_check(cards)
    out["seconds"] = time.perf_counter() - t0
    return launches, out


def one_slot_refs():
    """The one-slot runs phase 3t holds its mesh runs to, when phases 3, 3d
    and 3h did not run before it (``--phase 3t``): the trio and
    bench-fm-hash through a JobServer on one slot of the card."""
    from harmony_tpu_torch import bench

    server = pool_server(mesh_pools(1)[0][1][:1])
    try:
        configs, _ = bench.job_configs(TRIO_SCALE, bench.EPOCHS)
        futures = [server.submit(c) for c in configs]
        trio = {}
        for f in futures:
            res = f.result(timeout=600)
            (w,) = res["workers"].values()
            trio[res["job_id"]] = w["batch_losses"]
        fm, _ = submit_one(server, hash_job("fm", EPOCHS))
    finally:
        server.shutdown(timeout=600)
    return {"wd_losses": None, "trio": trio, "fm_hash": fm["batch_losses"]}


# -- phase 3u: sequence- and tensor-parallel LM training over a slot mesh -------

# bench_sp (benchmarks/lm.py:159-189): the LM of benchmarks/lm.py's
# _model(on_tpu=True) (vocab 8192, d_model 512, 8 heads, d_ff 2048, bf16) at 4
# layers with 1024 tokens a sequence shard, on a mesh of data 2 x seq n/2 with
# a batch of 2 * data: on 4 slots, 4 sequences of 2048 tokens a step.
SP_CONFIG = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
                 max_seq=2048, dtype="bfloat16")
SP_BATCH = 4
# steps of each path (from 3 to 2 when phase 3pd's moves and recovery came:
# every comparison and its second run kept)
SP_STEPS = 2
# (b)'s comparison with 4 CPU slots: the first step only (each CPU step
# runs the LM's plain attention and bf16 products on the host)
SP_CPU_STEPS = 1
SP_LR = 0.1
SP_SLOTS = 4
# (a): the ring's chunk [B, H, S, D] on each slot, f32 (the flash inner's
# operands), on meshes (data, seq) = (2, 2) and (1, 4)
RING_CHUNK = (2, 8, 1024, 64)
RING_MESHES = ((2, 2), (1, 4))
# Gradients of the flash inner against the einsum inner and full attention:
# f32 sums over other chunks' contributions in another order, 1e-4 of the
# largest magnitude (the reference's own limit for its flash inner).
RING_GRAD_REL = 1e-4


def flash_launches(sp_attn: str, rows: int, n: int, layers: int = 1) -> int:
    """K4 (and K5a, K5b) launches of a causal sequence split over rings of n
    slots: a ring n(n+1)/2 a row and layer (the chunks above the diagonal
    skipped), a2a n."""
    return rows * layers * (n * (n + 1) // 2 if sp_attn == "ring" else n)


def flat_params(tree):
    """Every parameter of a tree (a ModelShards joined) as one f32 vector on the CPU."""
    from harmony_tpu_torch.models.pytree_trainer import tree_leaves
    from harmony_tpu_torch.models.transformer import ModelShards

    leaves = [x.whole() if isinstance(x, ModelShards) else x for x in tree_leaves(tree)]
    return torch.cat([x.detach().reshape(-1).float().cpu() for x in leaves])


def plain_attention(q, k, v, causal):
    """Full attention on one slot in plain f32 tensor ops (TF32 off)."""
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        S = q.shape[2]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    return torch.softmax(s, dim=-1) @ v


def ring_alone(slots, dev):
    """Phase 3u (a): ring attention alone on virtual meshes (2, 2, 1) and
    (1, 4, 1) at RING_CHUNK, causal and not: the flash inner against the
    einsum inner and one-slot full attention, forward and gradients, the same
    bits run twice, K4/K5a/K5b launched n(n+1)/2 (n^2) times a row on simt."""
    from harmony_tpu_torch.ops import attention as A
    from harmony_tpu_torch.ops.ring import ring_self_attention
    from harmony_tpu_torch.parallel.mesh import build_mesh

    flash = (A.flash_forward, A.flash_backward_dkv, A.flash_backward_dq)
    out = {}
    for data, seq in RING_MESHES:
        mesh = build_mesh(slots, data=data, seq=seq, model=1)
        B, H, S, D = RING_CHUNK
        g = torch.Generator(device=dev).manual_seed(31 + seq)
        q, k, v, do = (torch.randn((B * data, H, S * seq, D), generator=g, device=dev)
                       for _ in range(4))
        for causal in (True, False):
            def run(inner):
                qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
                if inner == "full":
                    o = plain_attention(qg, kg, vg, causal)
                else:
                    o = ring_self_attention(qg, kg, vg, mesh, "seq", batch_axis="data",
                                            causal=causal, inner=inner)
                return (o.detach(), *torch.autograd.grad(o, (qg, kg, vg), do))

            tag = f"({data}, {seq}, 1) causal={causal}"
            reset_counts(*flash)
            got = run("flash")
            counts = {w.__name__: dict(w.launches_by_route) for w in flash}
            n = (seq * (seq + 1) // 2 if causal else seq * seq) * data
            check(all(c == {"mma": 0, "simt": n} for c in counts.values()),
                  f"phase 3u (a) {tag}: flash launches {counts}, expected {n} each on simt")
            again = run("flash")
            check(all(same_bits(a, b) for a, b in zip(got, again)),
                  f"phase 3u (a) {tag}: the flash ring run twice differs")
            gaps = {}
            for ref in ("einsum", "full"):
                want = run(ref)
                for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                    rel = FLASH_F32_REL if name == "out" else RING_GRAD_REL
                    gap = float((a - b).abs().max())
                    tol = rel * float(b.abs().max())
                    check(math.isfinite(gap) and gap <= tol,
                          f"phase 3u (a) {tag}: flash ring {name} against {ref}: {gap} > {tol}")
                    gaps[f"{name}_vs_{ref}"] = gap
            timing = ({inner: time_ms(lambda inner=inner: run(inner), samples=5, inner=2)
                       for inner in ("flash", "einsum", "full")} if dev.type == "cuda" else None)
            out[tag] = {"launches_each": n, "max_abs": gaps, "fwd_bwd_ms": timing}
            print(f"phase 3u (a): ring {tag} chunk {list(RING_CHUNK)} f32 within limits, "
                  f"bit-identical twice: {json.dumps(out[tag])}", flush=True)
    return out


def sp_model(sp_attn: str):
    from harmony_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    return TransformerLM(TransformerConfig(**SP_CONFIG, sp_attn=sp_attn))


def sp_inputs(model, dev):
    """bench_sp's weights (init seed 0) and tokens (make_lm_data seed 0) on ``dev``."""
    from harmony_tpu_torch.convert import pytree_params_from_numpy
    from harmony_tpu_torch.models.transformer import make_lm_data

    params = pytree_params_from_numpy(model.init(seed=0), device=dev)
    tokens = torch.as_tensor(make_lm_data(SP_BATCH, SP_CONFIG["max_seq"],
                                          SP_CONFIG["vocab_size"], seed=0)).to(dev)
    return params, tokens


def one_slot_lm_step(model, learning_rate):
    """The one-slot TransformerLM step on the SP step's objective: the masked
    mean next-token cross-entropy of ``model.apply`` (flash on ``mma`` at
    blocks 128) and SGD."""
    from harmony_tpu_torch.models import transformer as T
    from harmony_tpu_torch.models.pytree_trainer import tree_leaves, tree_unflatten

    def step(params, tokens):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        targets, mask = T._lm_targets_and_mask(tokens)
        loss = T._masked_ce([model.apply(tree_unflatten(params, leaves), tokens)],
                            [targets], [mask], tokens.device)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new = [p - learning_rate * g for p, g in zip(leaves, grads)]
        return tree_unflatten(params, new), loss.detach()

    return step


def sp_step(kind, sp_attn, slots, dev):
    """A step of ``kind`` ("sp": make_sp_train_step on (2, 2, 1); "3-axis":
    make_parallel_train_step on (1, 2, 2); "one-slot") over ``slots``, with
    bench_sp's weights (placed for it) and tokens."""
    from harmony_tpu_torch.models import transformer as T
    from harmony_tpu_torch.parallel.mesh import build_mesh

    model = sp_model(sp_attn)
    params, tokens = sp_inputs(model, dev)
    if kind == "sp":
        step = T.make_sp_train_step(model, build_mesh(slots, data=2, seq=2, model=1), SP_LR)
    elif kind == "3-axis":
        step, shard = T.make_parallel_train_step(
            model, build_mesh(slots, data=1, seq=2, model=2), SP_LR)
        params = shard(params)
    else:
        step = one_slot_lm_step(model, SP_LR)
    return step, params, tokens


def sp_steps(kind, sp_attn, slots, dev, steps=SP_STEPS):
    """``steps`` steps of :func:`sp_step`; returns the losses and the final
    parameters (on the CPU)."""
    step, params, tokens = sp_step(kind, sp_attn, slots, dev)
    losses = []
    for _ in range(steps):
        params, loss = step(params, tokens)
        losses.append(loss)
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"{kind} {sp_attn}: non-finite losses {losses}")
    return losses.tolist(), flat_params(params)


def close_losses(got, want, what):
    """Step for step within LM_BF16_REL of ``want``; returns the largest relative gap."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    check(rel <= LM_BF16_REL, f"phase 3u {what}: losses {got} against {want}: "
                              f"{rel} (relative) > {LM_BF16_REL}")
    return rel


def sp_step_without_syncs(slots, dev):
    """One SP ring step enqueued under CUDA's sync debug mode set to raise: no
    host sync inside the step, and the loss on the home slot."""
    step, params, tokens = sp_step("sp", "ring", slots, dev)
    step(params, tokens)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, loss = step(params, tokens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(loss.device == slots[0].device, f"the SP loss lies on {loss.device}")


def sp_profile(kind, sp_attn, slots, dev):
    """Phase 5's figures for SP_STEPS steps: step ms, device busy ms, idle
    share, the top kernels; and tokens/s."""
    step, params, tokens = sp_step(kind, sp_attn, slots, dev)

    def run():
        for _ in range(SP_STEPS):
            step(params, tokens)

    prof = profile_run(run, SP_STEPS, top_n=8)
    prof["tokens_per_sec"] = SP_BATCH * SP_CONFIG["max_seq"] / prof["step_ms"] * 1e3
    return prof


def rotation_copies(cards):
    """Each hop of a 4-card ring: ms (CUDA events on the source card's stream,
    where PyTorch runs a peer copy) and GB/s for one k chunk of the SP step
    ([2, 8, 1024, 64] bf16)."""
    out = {}
    for i in range(cards):
        src, dst = torch.device("cuda", i), torch.device("cuda", (i + 1) % cards)
        chunk = torch.randn((2, 8, 1024, 64), device=src).to(torch.bfloat16)
        with torch.cuda.device(src):
            ms = time_ms(lambda: chunk.to(dst, non_blocking=True, copy=True))
        out[f"cuda:{i}->cuda:{(i + 1) % cards}"] = {
            "ms": ms, "GB_per_s": chunk.numel() * chunk.element_size() / ms / 1e6}
    return out


def sp_paths(slots, dev, wrappers):
    """Phase 3u (b)-(d)'s runs on ``slots``: the losses and final parameters
    of each, and the launches of each path with the counts set to 0 just
    before it (the flash kernels' also by route)."""
    runs, launches = {}, {}
    for path, kind, sp_attn in (("sp-ring", "sp", "ring"), ("sp-a2a", "sp", "a2a"),
                                ("3-axis", "3-axis", "ring"), ("3-axis", "3-axis", "a2a")):
        reset_counts(*wrappers)
        runs[kind, sp_attn] = sp_steps(kind, sp_attn, slots, dev)
        counts = launches.setdefault(path, {w.__name__: 0 for w in wrappers})
        for w in wrappers:
            counts[w.__name__] += w.launches
            for route, n in getattr(w, "launches_by_route", {}).items():
                key = f"{w.__name__}_{route}"
                counts[key] = counts.get(key, 0) + n
    return runs, launches


def run_sp():
    """Phase 3u: sequence- and tensor-parallel LM training over a slot mesh."""
    from harmony_tpu_torch.ops.ring import _resolve_inner
    from harmony_tpu_torch.parallel.mesh import DevicePool

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    wrappers = all_wrappers()
    slots = DevicePool.virtual(dev, SP_SLOTS).slots
    out = {"config": {**SP_CONFIG, "batch": SP_BATCH, "steps": SP_STEPS}}
    out["ring_alone"] = ring_alone(slots, dev)

    runs, launches = sp_paths(slots, dev, wrappers)
    layers = SP_CONFIG["n_layers"]
    ring, a2a = flash_launches("ring", 2, 2, layers), flash_launches("a2a", 2, 2, layers)
    # the 3-axis path: its ring and a2a runs, each over rings of (data 1, model 2)
    expected = {"sp-ring": ring, "sp-a2a": a2a, "3-axis": ring + a2a}
    for path, counts in launches.items():
        want = {w.__name__: 0 for w in wrappers}
        for name in FLASH_KERNELS:
            want.update({name: expected[path] * SP_STEPS, f"{name}_mma": 0,
                         f"{name}_simt": expected[path] * SP_STEPS})
        check(counts == want, f"phase 3u {path}: launches {counts}, expected {want}")
    ring_losses = runs["sp", "ring"][0]
    ref_losses, _ = sp_steps("one-slot", "ring", slots[:1], dev)
    out["losses"] = {f"{k}-{a}": v[0] for (k, a), v in runs.items()}
    out["losses"]["one-slot"] = ref_losses
    gaps = {"sp-ring_vs_one-slot": close_losses(ring_losses, ref_losses,
                                                "(b) ring against one slot")}
    for (kind, sp_attn), (losses, _) in runs.items():
        if (kind, sp_attn) != ("sp", "ring"):
            gaps[f"{kind}-{sp_attn}_vs_sp-ring"] = close_losses(
                losses, ring_losses, f"{kind} {sp_attn} against the SP ring")
    for kind, sp_attn in (("sp", "ring"), ("sp", "a2a")):
        losses, params = sp_steps(kind, sp_attn, slots, dev)
        check(float_bits(losses) == float_bits(runs[kind, sp_attn][0])
              and same_bits(params, runs[kind, sp_attn][1]),
              f"phase 3u {kind} {sp_attn}: two runs differ")
    print(f"phase 3u (b)-(d): losses {json.dumps(out['losses'])}, max relative gaps "
          f"{json.dumps(gaps)}, launches {json.dumps(launches)}; the SP steps bit-identical "
          f"twice", flush=True)
    t1 = time.perf_counter()
    cpu_losses, _ = sp_steps("sp", "ring", DevicePool.virtual("cpu", SP_SLOTS).slots,
                             torch.device("cpu"), steps=SP_CPU_STEPS)
    gaps["sp-ring_card_vs_cpu"] = close_losses(ring_losses, cpu_losses, "(b) card against CPU")
    out["cpu"] = {"losses": cpu_losses, "seconds": time.perf_counter() - t1}
    out["gaps"] = gaps
    sp_step_without_syncs(slots, dev)
    out["launches_per_step"] = {p: {k: v // SP_STEPS for k, v in c.items() if v}
                                for p, c in launches.items()}
    out["profile"] = {f"{kind}-{sp_attn}": sp_profile(kind, sp_attn, slots, dev)
                      for kind, sp_attn in (("sp", "ring"), ("sp", "a2a"),
                                            ("3-axis", "ring"), ("3-axis", "a2a"))}
    for name, prof in out["profile"].items():
        print(f"phase 3u: {name}: {prof['tokens_per_sec']:.1f} tokens/s, step "
              f"{prof['step_ms']:.3f} ms, device busy {prof['device_busy_ms_per_step']:.3f} "
              f"ms, idle share {prof['device_idle_share']:.4f}, top "
              f"{json.dumps(prof['top_device_ms_per_step'])}", flush=True)

    cards = torch.cuda.device_count()
    if cards >= SP_SLOTS:
        real = DevicePool().slots[:SP_SLOTS]
        check(_resolve_inner("auto", on_card=True) == "flash", "auto does not pick flash")
        real_runs, real_launches = sp_paths(real, dev, wrappers)
        check(real_launches == launches,
              f"phase 3u (e): launches on the cards {real_launches}, virtual {launches}")
        for key, (losses, params) in real_runs.items():
            check(float_bits(losses) == float_bits(runs[key][0])
                  and same_bits(params, runs[key][1]),
                  f"phase 3u (e) {key}: the cards' bits differ from the virtual slots'")
        out["real_mesh"] = {"cards": [str(s.device) for s in real],
                            "bits": "the virtual slots' bits on every path",
                            "rotations": rotation_copies(SP_SLOTS)}
        print(f"phase 3u (e): on {SP_SLOTS} cards the virtual slots' bits; rotation copies "
              f"{json.dumps(out['real_mesh']['rotations'])}", flush=True)
    else:
        out["real_mesh"] = f"not run: {cards} card(s)"
    out["seconds"] = time.perf_counter() - t0
    return launches, out


# -- phase 3v: pipeline- and expert-parallel LM training, ViT's data-parallel step --

# bench_pp (benchmarks/lm.py:224-254) at n = 4: the LM of _model(on_tpu=True,
# layers=2n) (vocab 8192, d_model 512, 8 heads, d_ff 2048, bf16), 8 layers in 4
# stages of 2, batch 8n = 32 in M = S = 4 microbatches. bench_pp's sequences
# are max_seq = 1024 tokens, whose trimmed 1023 would not tile the flash block
# of 128 (blockwise, no kernel): the phase feeds 1025, as phase 3b feeds
# bench-lm, so the pipeline runs 1024 tokens a sequence.
PP_CONFIG = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=8, d_ff=2048,
                 max_seq=1024, dtype="bfloat16")
PP_BATCH, PP_SEQ = 32, 1025
# bench_ep (:257-291) at n = 4: the same LM with moe_experts 2n = 8 every 2nd
# block (capacity 1.5, aux 0.01) on mesh data 4, batch 32 of bench_ep's own
# 1024-token sequences (the masked CE keeps all 1024); 2 experts a slot.
EP_CONFIG = dict(PP_CONFIG, moe_experts=8, moe_every=2, moe_capacity_factor=1.5,
                 moe_aux_weight=0.01)
EP_BATCH, EP_SEQ = 32, 1024
EP_BLOCKS = 4
# bench-vit (VIT_ARGS: ViT-B/16, bf16, batch 128, step size 0.05) over 4 data
# slots, 32 images a slot.
VIT_DP_CONFIG = dict(image_size=224, patch_size=16, num_classes=1000, channels=3,
                     d_model=768, n_heads=12, n_layers=12, d_ff=3072, dtype="bfloat16")
VIT_DP_LR = 0.05
PV_SLOTS = 4
# steps of each path (from 3 to 2 when phase 3pd's moves and recovery came:
# every comparison and its second run kept)
PV_STEPS = 2
PV_LR = 0.1
# K4, K5a and K5b launches a step and their route: PP 4 stages x 2 layers x 4
# microbatches, K4 twice (each application's forward again under remat); EP 4
# slots x 8 layers; ViT-DP 4 slots x 12 layers.
PV_LAUNCHES = {"pp": ((64, 32, 32), "mma"), "ep": ((32, 32, 32), "mma"),
               "vit-dp": ((48, 48, 48), "simt")}
# phase 2b's rows at the paths' shapes: a PP microbatch or an EP slot's attention,
# and a ViT-DP slot's
PV_FLASH_CASES = [
    ("pp and ep: a microbatch or a slot, bf16, causal", (8, 8, 1024, 64), 1024,
     torch.bfloat16, True, 128, False, "mma"),
    ("vit-dp: a slot, bf16, not causal", (32, 12, 197, 64), 197, torch.bfloat16, False,
     197, False, "simt"),
]
PV_INIT = {}


def pv_init(kind: str):
    """The numpy initial weights of a path's model (seed 0), drawn once."""
    if kind not in PV_INIT:
        PV_INIT[kind] = pv_model(kind).init(seed=0)
    return PV_INIT[kind]


def pv_model(kind: str):
    from harmony_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from harmony_tpu_torch.models.vit import ViT, ViTConfig

    if kind.startswith("vit"):
        return ViT(ViTConfig(**VIT_DP_CONFIG))
    return TransformerLM(TransformerConfig(**(EP_CONFIG if kind.startswith("ep")
                                              else PP_CONFIG)))


def pv_step(kind: str, slots, dev):
    """``(step, state, args)`` of a path over ``slots``: ``step(state, *args)
    -> (state, loss)``. "pp": make_pp_train_step on 4 stages; "ep":
    make_ep_train_step on data 4; "vit-dp": ViT's make_train_step on data 4;
    their counterparts "pp-one-slot" (TransformerLM.loss and SGD),
    "ep-sp" (make_sp_train_step on (data 4, seq 1)) and "vit-one-slot"."""
    from harmony_tpu_torch.convert import pytree_params_from_numpy
    from harmony_tpu_torch.models import transformer as T
    from harmony_tpu_torch.models import vit
    from harmony_tpu_torch.parallel.mesh import Mesh, build_mesh

    model = pv_model(kind)
    params = pytree_params_from_numpy(pv_init(kind.split("-")[0]), device=dev)
    if kind.startswith("vit"):
        images, labels = vit.make_synthetic(VIT_BATCH, model.cfg, seed=0)
        args = (torch.as_tensor(images).to(dev), torch.as_tensor(labels).to(dev))
        mesh = build_mesh(slots, data=PV_SLOTS, model=1) if kind == "vit-dp" else None
        return vit.make_train_step(model, mesh, VIT_DP_LR), params, args
    batch, seq = (PP_BATCH, PP_SEQ) if kind.startswith("pp") else (EP_BATCH, EP_SEQ)
    tokens = torch.as_tensor(T.make_lm_data(batch, seq, model.config.vocab_size,
                                            seed=0)).to(dev)
    if kind == "pp":
        mesh = Mesh(np.asarray(slots, dtype=object).reshape(PV_SLOTS), ("stage",))
        step, shard = T.make_pp_train_step(model, mesh, PV_LR)
        return step, shard(params), (tokens,)
    if kind == "ep":
        step, shard = T.make_ep_train_step(model, build_mesh(slots, data=PV_SLOTS, model=1),
                                           PV_LR)
        return step, shard(params), (tokens,)
    if kind == "ep-sp":
        return (T.make_sp_train_step(model, build_mesh(slots, data=PV_SLOTS, seq=1, model=1),
                                     PV_LR), params, (tokens,))
    return one_slot_loss_step(model, PV_LR), params, (tokens,)


def one_slot_loss_step(model, learning_rate):
    """The one-slot TransformerLM SGD step: ``model.loss`` (the mean next-token
    cross-entropy of tokens[:, :-1] against tokens[:, 1:]) and SGD."""
    from harmony_tpu_torch.models.pytree_trainer import tree_leaves, tree_unflatten

    def step(params, tokens):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = model.loss(tree_unflatten(params, leaves), tokens)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new = [p - learning_rate * g for p, g in zip(leaves, grads)]
        return tree_unflatten(params, new), loss.detach()

    return step


def pv_steps(kind: str, slots, dev):
    """PV_STEPS steps of :func:`pv_step`; the losses and the final parameters
    (one f32 vector on the CPU)."""
    step, state, args = pv_step(kind, slots, dev)
    losses = []
    for _ in range(PV_STEPS):
        state, loss = step(state, *args)
        losses.append(loss)
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"phase 3v {kind}: non-finite losses {losses}")
    return losses.tolist(), flat_params(state)


def pv_paths(slots, dev, wrappers):
    """Phase 3v (a)-(c)'s runs over ``slots``: each path's losses and final
    parameters, and its launches with the counts set to 0 just before it."""
    runs, launches = {}, {}
    for path in PV_LAUNCHES:
        reset_counts(*wrappers)
        runs[path] = pv_steps(path, slots, dev)
        counts = launches[path] = {}
        for w in wrappers:
            counts[w.__name__] = w.launches
            for route, n in getattr(w, "launches_by_route", {}).items():
                counts[f"{w.__name__}_{route}"] = n
    return runs, launches


def pv_without_syncs(kind: str, slots, dev):
    """One step of a path enqueued under CUDA's sync debug mode set to raise:
    no host sync inside the step, and the loss on the home slot."""
    step, state, args = pv_step(kind, slots, dev)
    state, _ = step(state, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, loss = step(state, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(loss.device == slots[0].device, f"phase 3v {kind}: the loss lies on {loss.device}")


def pv_profile(kind: str, slots, dev):
    """Phase 5's figures for PV_STEPS steps of a path (step ms, device busy ms,
    idle share, device operations and top kernels), and tokens/s or samples/s."""
    step, state, args = pv_step(kind, slots, dev)

    def run():
        nonlocal state
        for _ in range(PV_STEPS):
            state, _ = step(state, *args)

    prof = profile_run(run, PV_STEPS, top_n=8)
    if kind.startswith("vit"):
        prof["samples_per_sec"] = VIT_BATCH / prof["step_ms"] * 1e3
    else:
        tokens = PP_BATCH * (PP_SEQ - 1) if kind == "pp" else EP_BATCH * EP_SEQ
        prof["tokens_per_sec"] = tokens / prof["step_ms"] * 1e3
    return prof


def wall_ms(fn, devices, calls: int) -> float:
    """ms a call on the host clock over ``calls`` calls after a first, every
    device of ``devices`` synchronised before and after (work on several cards,
    which one card's CUDA events do not see)."""
    fn()
    for _ in range(2):
        for d in set(devices):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        for d in set(devices):
            torch.cuda.synchronize(d)
    return (time.perf_counter() - t0) * 1e3 / calls


def pv_step_ms(kind: str, slots, dev):
    """A path's step ms on the host clock over PV_STEPS steps after a first."""
    step, state, args = pv_step(kind, slots, dev)

    def one():
        nonlocal state
        state, _ = step(state, *args)

    return wall_ms(one, [s.device for s in slots], PV_STEPS)


def ep_dropped_shares(slots, dev):
    """The share of tokens each MoE block drops in the EP path's first step,
    the mean of its slots' shares (each routes its own 8,192 tokens)."""
    from harmony_tpu_torch.models import moe

    route, shares = moe.route, []

    def recorded(x, router, num_experts, capacity):
        r = route(x, router, num_experts, capacity)
        shares.append((~r.keep).float().mean())
        return r

    step, state, args = pv_step("ep", slots, dev)
    moe.route = recorded
    try:
        step(state, *args)
    finally:
        moe.route = route
    check(len(shares) == EP_BLOCKS * PV_SLOTS,
          f"phase 3v (b): {len(shares)} routings, expected {EP_BLOCKS * PV_SLOTS}")
    return torch.stack(shares).view(EP_BLOCKS, PV_SLOTS).mean(dim=1).cpu().tolist()


def pv_copies(slots):
    """ms (host clock, every slot's device synchronised) of an activation hop of the PP path (a microbatch's
    [8, 1024, 512] bf16 from stage 0's slot to stage 1's) and of the EP path's
    exchange, out and back (each slot's [8, 1536, 512] f32 buckets)."""
    from harmony_tpu_torch.models import moe
    from harmony_tpu_torch.models.transformer import TransformerConfig
    from harmony_tpu_torch.parallel.collectives import send

    devices = [s.device for s in slots]
    act = torch.randn((PP_BATCH // PV_SLOTS, PP_SEQ - 1, PP_CONFIG["d_model"]),
                      device=devices[0]).to(torch.bfloat16)
    C = TransformerConfig(**EP_CONFIG).moe_cfg.capacity(EP_BATCH // PV_SLOTS * EP_SEQ)
    buckets = [torch.randn((EP_CONFIG["moe_experts"], C, EP_CONFIG["d_model"]), device=d)
               for d in devices]
    rows = moe.to_experts(buckets, devices)
    return {"pp_hop_ms": wall_ms(lambda: send(act, devices[1]), devices[:2], 50),
            "pp_hop_bytes": act.numel() * act.element_size(),
            "ep_exchange_out_ms": wall_ms(lambda: moe.to_experts(buckets, devices), devices, 20),
            "ep_exchange_back_ms": wall_ms(lambda: moe.from_experts(rows, devices), devices, 20),
            "ep_exchange_bytes_a_slot": buckets[0].numel() * 4}


def run_pv():
    """Phase 3v: pipeline- and expert-parallel LM training and ViT's
    data-parallel step over 4 virtual slots of one card (and 4 cards)."""
    from harmony_tpu_torch.parallel.mesh import DevicePool

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    wrappers = all_wrappers()
    slots = DevicePool.virtual(dev, PV_SLOTS).slots
    out = {"config": {"pp": {**PP_CONFIG, "stages": PV_SLOTS, "microbatches": PV_SLOTS,
                             "batch": PP_BATCH, "seq_len": PP_SEQ,
                             "note": "1025-token sequences: 1024 after the shift"},
                      "ep": {**EP_CONFIG, "data": PV_SLOTS, "batch": EP_BATCH,
                             "seq_len": EP_SEQ},
                      "vit-dp": {**VIT_DP_CONFIG, "data": PV_SLOTS, "batch": VIT_BATCH},
                      "steps": PV_STEPS}}
    err = check_flash_kernels(dev, PV_FLASH_CASES)
    out["flash_at_path_shapes"] = {case[0]: time_flash_kernels(dev, case)
                                   for case in PV_FLASH_CASES}
    print(f"phase 3v (d): max |kernel - plain| {json.dumps(err)}; timing "
          f"{json.dumps(out['flash_at_path_shapes'])}", flush=True)

    runs, launches = pv_paths(slots, dev, wrappers)
    for path, ((k4, k5a, k5b), route) in PV_LAUNCHES.items():
        want = {w.__name__: 0 for w in wrappers}
        for name, n in zip(FLASH_KERNELS, (k4, k5a, k5b)):
            want.update({name: n * PV_STEPS, f"{name}_mma": 0, f"{name}_simt": 0})
            want[f"{name}_{route}"] = n * PV_STEPS
        check(launches[path] == want,
              f"phase 3v {path}: launches {launches[path]}, expected {want}")
    refs = {"pp": "pp-one-slot", "ep": "ep-sp", "vit-dp": "vit-one-slot"}
    out["losses"], gaps = {}, {}
    for path, ref in refs.items():
        want, _ = pv_steps(ref, slots if ref == "ep-sp" else slots[:1], dev)
        got = runs[path][0]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        check(rel <= LM_BF16_REL, f"phase 3v {path}: losses {got} against {ref}'s {want}: "
                                  f"{rel} (relative) > {LM_BF16_REL}")
        out["losses"][path], out["losses"][ref], gaps[f"{path}_vs_{ref}"] = got, want, rel
        losses, params = pv_steps(path, slots, dev)
        check(float_bits(losses) == float_bits(got) and same_bits(params, runs[path][1]),
              f"phase 3v {path}: two runs differ")
        pv_without_syncs(path, slots, dev)
    out["gaps"] = gaps
    out["launches_per_step"] = {p: {k: v // PV_STEPS for k, v in c.items() if v}
                                for p, c in launches.items()}
    out["ep_dropped_share_by_block"] = ep_dropped_shares(slots, dev)
    out["copies"] = pv_copies(slots)
    print(f"phase 3v (a)-(c): losses {json.dumps(out['losses'])}, max relative gaps "
          f"{json.dumps(gaps)}, launches a step {json.dumps(out['launches_per_step'])}; each "
          f"path bit-identical twice, no host sync in a step; EP dropped share by block "
          f"{out['ep_dropped_share_by_block']}; copies {json.dumps(out['copies'])}", flush=True)
    out["profile"] = {path: pv_profile(path, slots, dev) for path in PV_LAUNCHES}
    for path, prof in out["profile"].items():
        rate = (f"{prof['samples_per_sec']:.1f} samples/s" if "samples_per_sec" in prof
                else f"{prof['tokens_per_sec']:.1f} tokens/s")
        print(f"phase 3v: {path}: {rate}, step {prof['step_ms']:.3f} ms, device busy "
              f"{prof['device_busy_ms_per_step']:.3f} ms, idle share "
              f"{prof['device_idle_share']:.4f}, {prof['device_ops_per_step']:.1f} device "
              f"operations a step, flash launches a step "
              f"{json.dumps(out['launches_per_step'][path])}, top "
              f"{json.dumps(prof['top_device_ms_per_step'])}", flush=True)

    cards = torch.cuda.device_count()
    if cards >= PV_SLOTS:
        real = DevicePool().slots[:PV_SLOTS]
        real_runs, real_launches = pv_paths(real, dev, wrappers)
        check(real_launches == launches,
              f"phase 3v (e): launches on the cards {real_launches}, virtual {launches}")
        for path, (losses, params) in real_runs.items():
            check(float_bits(losses) == float_bits(runs[path][0])
                  and same_bits(params, runs[path][1]),
                  f"phase 3v (e) {path}: the cards' bits differ from the virtual slots'")
        out["real_mesh"] = {"cards": [str(s.device) for s in real],
                            "bits": "the virtual slots' bits on every path",
                            "copies": pv_copies(real),
                            "step_ms": {p: pv_step_ms(p, real, dev) for p in PV_LAUNCHES}}
        print(f"phase 3v (e): on {PV_SLOTS} cards the virtual slots' bits and launches; "
              f"copies {json.dumps(out['real_mesh']['copies'])}, step ms "
              f"{json.dumps(out['real_mesh']['step_ms'])}", flush=True)
    else:
        out["real_mesh"] = f"not run: {cards} card(s)"
    out["seconds"] = time.perf_counter() - t0
    return launches, out


# -- phase 3w: the elastic table, live block moves while jobs train ------------

# A pool of 4 slots: bench-widedeep starts on 2 executors (its 256 blocks 128
# to a slot), add_one_server grows it to 3 (256 is no multiple of 3: every
# slot holds every block), the scripted plan to 4 (64 to a slot), then drains
# the job's first executor (3 owners, replicated again; the compute slot
# moves). bench-fm-hash starts on 3 (replicated), delete_one_server drains one
# (2 owners, 128 to a slot), the scripted plan grows it to 3 and drains its
# first executor (2 owners).
ELASTIC_SLOTS = 4
# One optimization round, at the job's start (the loop's first round runs at
# once; the next would come after the job).
ELASTIC_PERIOD = 3600.0
# The scripted plan's grow and shrink fire once the job has committed this
# many steps (of its 16).
ELASTIC_GROW_AT, ELASTIC_SHRINK_AT = 5, 11
# The serving reader's keys: 16 ids of bench-widedeep's vocabulary.
ELASTIC_READ_KEYS = 16
# A job of phase 3w that has not ended after this many seconds is stuck: the
# stacks of every thread go to stderr and the script ends (each job takes
# seconds).
ELASTIC_JOB_WATCHDOG_S = 240
# Before a move, a spin kernel of this many cycles (~25 ms at the H100's 1.98
# GHz) on each card's stream, so that the move's copies are all enqueued
# before the card reaches them: the events around them then time the copies,
# not the host's enqueue (on an idle card they would time the enqueue).
MOVE_SPIN_CYCLES = 50_000_000


def stream_event(device):
    """An event recorded on ``device``'s current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class MoveLog:
    """Instruments one job's table: an event on the compute slot's stream
    after each step (the steps' device intervals), and for each reshard that
    changes the layout its wait for the table lock, its host ms under the
    lock (``migrate_host_ms``: the rebuild of the storage alone), the device
    ms of its copies (events on every card of the two meshes, around it),
    its blocks and bytes, and the steps before it. ``gates[n]``, where set, holds the worker after its n-th
    step until the event is set (a scripted move lands there)."""

    def __init__(self, gates=None):
        self.table = None
        self.steps = []    # (device, event) after each committed step
        self.moves = []
        self.gates = gates or {}

    def attach(self, table):
        from harmony_tpu_torch.table import blockmove

        self.table = table
        step, reshard = table.apply_step, table.reshard

        def apply_step(*args, **kw):
            out = step(*args, **kw)
            self.steps.append((table.device, stream_event(table.device)))
            gate = self.gates.get(len(self.steps))
            if gate is not None:
                check(gate.wait(timeout=120), f"phase 3w: the move due after step "
                                               f"{len(self.steps)} did not land")
            return out

        def timed_reshard(mesh):
            t0 = time.perf_counter()
            with table._lock:   # reentrant: the reshard takes it again
                wait_ms = (time.perf_counter() - t0) * 1e3
                was = table.sharding
                cards = sorted({s.device for s in table.mesh.slots + mesh.slots}, key=str)
                owners_before, n = table.mesh.size, len(self.steps)
                spin = {}
                for d in cards:
                    if d.type == "cuda":
                        spin[d] = stream_event(d)
                        with torch.cuda.device(d):
                            torch.cuda._sleep(MOVE_SPIN_CYCLES)
                before = {d: stream_event(d) for d in cards}
                t1 = time.perf_counter()
                reshard(mesh)
                host_ms = (time.perf_counter() - t1) * 1e3
                after = {d: stream_event(d) for d in cards}
            if table.sharding == was:
                return   # the same layout: nothing moved
            self.moves.append({"after_step": n, "slots": [owners_before, mesh.size],
                               "spec": list(table.sharding.spec), "host_ms": host_ms,
                               "lock_wait_ms": wait_ms,
                               "migrate_host_ms": blockmove.last_move_stats["seconds"] * 1e3,
                               **{k: blockmove.last_move_stats[k] for k in (
                                   "blocks_moved", "bytes_moved", "blocks_copied_locally",
                                   "shards_reused")},
                               "_events": (spin, before, after)})

        table.apply_step, table.reshard = apply_step, timed_reshard

    def report(self):
        """Each move's figures, the device ms of its copies and the mean step
        ms (device intervals between consecutive steps on one card) before
        and after it, up to the neighbouring moves; None on the CPU."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        gaps = [None] + [a[1].elapsed_time(b[1]) if a[0] == b[0] and a[1] is not None
                         else None for a, b in zip(self.steps, self.steps[1:])]
        bounds = [m["after_step"] for m in self.moves]
        out = []
        for i, m in enumerate(self.moves):
            spin, before, after = m.pop("_events")
            if spin:
                m["device_ms"] = max(before[d].elapsed_time(after[d]) for d in spin)
                # the spin outlasted the host's enqueue: the events time the copies
                m["spin_covered_host"] = all(
                    spin[d].elapsed_time(before[d]) > m["host_ms"] for d in spin)
            else:
                m["device_ms"] = m["spin_covered_host"] = None
            lo = bounds[i - 1] + 1 if i else 1
            hi = bounds[i + 1] if i + 1 < len(bounds) else len(self.steps)
            pre = [g for g in gaps[lo:m["after_step"]] if g is not None]
            post = [g for g in gaps[m["after_step"] + 1:hi] if g is not None]
            m["step_ms_before"] = statistics.mean(pre) if pre else None
            m["step_ms_after"] = statistics.mean(post) if post else None
            out.append(m)
        return out


def elastic_server(slots, executors):
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    server = JobServer(executors, device_pool=DevicePool(slots))
    server.start()
    return server


def elastic_job(kind, job_id, optimizer=None):
    """bench-widedeep (``wd``, one worker) or bench-fm-hash (``fm``), with
    the optimizer loop when ``optimizer`` is given."""
    base = wd_mesh_config(job_id, EPOCHS) if kind == "wd" else hash_job("fm", EPOCHS)
    return base.replace(job_id=job_id, optimizer=optimizer, optimizer_period=ELASTIC_PERIOD)


def scripted_plan(server, log, done, errors, owners):
    """Phase 3w (a)'s grow-then-shrink ETPlan (the analogue of the reference's
    tests/test_migration.py grow_then_shrink), through PlanExecutor while the
    job trains: once the table has ``owners`` owners (after the optimizer's
    round) and ELASTIC_GROW_AT steps, a new executor takes 32 of the first
    one's blocks; at ELASTIC_SHRINK_AT steps the first executor is drained
    into it and unassociated (the server keeps the executor), so the job's
    compute slot moves. The worker waits at each of those steps (the log's
    gates) until its move has landed."""
    from harmony_tpu_torch.plan import AllocateOp, AssociateOp, ETPlan, MoveOp, PlanExecutor
    from harmony_tpu_torch.plan import UnassociateOp

    def wait(cond):
        while not cond():
            if done.is_set():
                raise RuntimeError("the job ended before the scripted plan could fire")
            time.sleep(0.0005)

    try:
        wait(lambda: log.table is not None)
        tid = log.table.spec.table_id
        handle = server.master.table_handle(tid)
        wait(lambda: len(handle.owning_executors()) == owners
             and len(log.steps) >= ELASTIC_GROW_AT)
        first = handle.owning_executors()[0]
        plan = ETPlan()
        alloc = plan.add_op(AllocateOp("grow"))
        assoc = plan.add_op(AssociateOp(tid, "grow"), depends_on=[alloc])
        plan.add_op(MoveOp(tid, first, "grow", 32), depends_on=[assoc])
        res = PlanExecutor(server.master).execute(plan)
        if not res.success:
            raise res.error
        log.gates[ELASTIC_GROW_AT].set()
        wait(lambda: len(log.steps) >= ELASTIC_SHRINK_AT)
        new = handle.owning_executors()[-1]
        plan = ETPlan()
        mv = plan.add_op(MoveOp(tid, first, new, handle.block_manager.block_counts()[first]))
        plan.add_op(UnassociateOp(tid, first), depends_on=[mv])
        res = PlanExecutor(server.master).execute(plan)
        if not res.success:
            raise res.error
        log.gates[ELASTIC_SHRINK_AT].set()
    except BaseException as e:  # noqa: BLE001 - reported by the phase
        errors.append(e)


def elastic_read_keys():
    return np.random.default_rng(7).choice(100000, ELASTIC_READ_KEYS, replace=False)


def serving_reader(log, done, reads, errors):
    """A serving reader of the live table, on a stream of its own: the
    endpoint's cached live gathers (K1) of ELASTIC_READ_KEYS keys, in a loop
    until the job's table is about to be dropped."""
    from harmony_tpu_torch.serving.service import ServingEndpoint

    keys = elastic_read_keys()
    ep = ServingEndpoint(cache_mb=16)
    try:
        while log.table is None and not done.is_set():
            time.sleep(0.0005)
        dev = log.table.device
        with (torch.cuda.stream(torch.cuda.Stream(dev)) if dev.type == "cuda"
              else contextlib.nullcontext()):
            while not done.is_set():
                gen = ep._watch_layout("elastic", log.table)
                reads.append(ep._live_gather("elastic", gen, log.table, keys))
                time.sleep(0.0005)
    except BaseException as e:  # noqa: BLE001 - reported by the phase
        errors.append(e)
    finally:
        ep.stop()


def run_elastic_job(slots, kind, executors, optimizer=None, scripted=0, reader=False):
    """One job through a JobServer of ``executors`` executors on ``slots``,
    with the scripted plan once the table has ``scripted`` owners (0: none):
    (the worker's result, the job's result, its MoveLog, the reader's reads,
    the owning executors at the end)."""
    server = elastic_server(slots, executors)
    log = MoveLog({ELASTIC_GROW_AT: threading.Event(), ELASTIC_SHRINK_AT: threading.Event()}
                  if scripted else None)
    create = server.master.create_table

    def created(*args, **kw):
        table = create(*args, **kw)
        log.attach(table)
        return table

    server.master.create_table = created
    owners = {}
    drop = server.master.drop_table
    done, errors, reads = threading.Event(), [], []
    threads = []

    def dropped(tid):
        # the job is over: the reader and the plan stop before the table goes
        done.set()
        for t in threads:
            t.join(timeout=60)
        if tid in server.master.table_ids():
            owners[tid] = len(server.master.table_handle(tid).owning_executors())
        drop(tid)

    server.master.drop_table = dropped
    if scripted:
        threads.append(threading.Thread(target=scripted_plan,
                                        args=(server, log, done, errors, scripted)))
    if reader:
        threads.append(threading.Thread(target=serving_reader, args=(log, done, reads, errors)))
    faulthandler.dump_traceback_later(ELASTIC_JOB_WATCHDOG_S, exit=True)
    try:
        for t in threads:
            t.start()
        res = server.submit(elastic_job(kind, f"elastic-{kind}", optimizer)).result(timeout=600)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=60)
        server.shutdown(timeout=600)
        faulthandler.cancel_dump_traceback_later()
    check(not errors, f"phase 3w {kind}: {errors}")
    check(not res.get("optimizer_errors"), f"phase 3w {kind}: {res.get('optimizer_errors')}")
    (w,) = res["workers"].values()
    return w, res, log, reads, list(owners.values())


def step_snapshots(slots, keys):
    """The rows of ``keys`` after each committed step of bench-widedeep,
    unmoved on ``slots`` (a lone worker), and at the table's creation."""
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    master = ETMaster(DevicePool(slots))
    entity = DolphinJobEntity(elastic_job("wd", "elastic-snapshots"))
    entity.setup(master, [e.id for e in master.add_executors(2)])
    table = entity._table
    snaps = [table.multi_get(keys)]
    try:
        worker = entity.make_worker()
        dispatch = worker._dispatch

        def dispatched(*args):
            snaps.append(table.multi_get(keys))   # the global init's writes
            out = dispatch(*args)
            snaps.append(table.multi_get(keys))
            return out

        worker._dispatch = dispatched
        result = worker.run()
    finally:
        entity.cleanup()
    return snaps, result["batch_losses"]


def reads_follow_the_steps(reads, snaps):
    """Each read is the rows after some committed step, never earlier than
    the read before it: a read of a dropped layout, or a torn one, matches no
    snapshot or goes back in time."""
    at = 0
    blobs = [s.tobytes() for s in snaps]
    for r in reads:
        b = r.tobytes()
        while at < len(blobs) and blobs[at] != b:
            at += 1
        if at == len(blobs):
            return False
    return True


def elastic_table_ops(slots, cpu_slots, wrappers):
    """Phase 3w (d): K1 and the folds on storage a move just rebuilt:
    bench-widedeep's table and bench-fm-hash's, each on 2 slots of the card
    and of the CPU, resharded to 3, 4, 1 and 2 slots; after each move a pull
    (K1), the mxu (K3) and sparse (K2) pushes and pull_all (dense), a pull and
    push (K1, K2, hash), multi_get and export_blocks, the card's bytes equal
    to the CPU plain versions'."""
    from harmony_tpu_torch.apps.widedeep import FMTrainer, make_synthetic, make_synthetic_sparse
    from harmony_tpu_torch.parallel.mesh import build_mesh
    from harmony_tpu_torch.table.hashtable import DeviceHashTable, HashTableSpec
    from harmony_tpu_torch.table.table import DenseTable, TableSpec

    rng = np.random.default_rng(37)
    trainer = wd_trainer()
    ids, _ = make_synthetic(WD_BATCH, 100000, 16, seed=37)
    keys = trainer.pull_keys((torch.as_tensor(ids),)).to(torch.int32)
    spec = TableSpec(trainer.model_table_config())
    storage = torch.as_tensor(rng.standard_normal(spec.storage_shape).astype(np.float32))
    deltas = torch.as_tensor(rng.standard_normal((len(keys), *spec.value_shape))
                             .astype(np.float32))
    fm = FMTrainer(vocab_size=100000, num_slots=16, emb_dim=16, step_size=0.1, sparse=True)
    hspec = HashTableSpec(fm.model_table_config())
    sids, _ = make_synthetic_sparse(WD_BATCH, 100000, 16, seed=37)
    hkeys = fm.pull_keys((torch.as_tensor(sids),)).to(torch.int32)
    hd = torch.as_tensor(rng.standard_normal((len(hkeys), *hspec.value_shape)).astype(np.float32))
    pairs = {"dense": [DenseTable(spec, build_mesh(s[:2], data=1), arr=storage)
                       for s in (slots, cpu_slots)],
             "hash": [DeviceHashTable(hspec, build_mesh(s[:2], data=1))
                      for s in (slots, cpu_slots)]}
    out = {}
    for n in (3, 4, 1, 2):
        for kind, (card, cpu) in pairs.items():
            for t, s in ((card, slots), (cpu, cpu_slots)):
                t.reshard(build_mesh(s[:n], data=1))
            run = table_op_bytes if kind == "dense" else hash_op_bytes
            args = (keys, deltas) if kind == "dense" else (hkeys, hd)
            (c_out, c_l), (p_out, _) = [run(t, *args, wrappers) for t in (card, cpu)]
            check(same_outputs(c_out, p_out),
                  f"phase 3w (d) {kind} on {n} slots after a move: the card and the CPU "
                  f"disagree on {[k for k in c_out if c_out[k].tobytes() != p_out[k].tobytes()]}")
            out[f"{kind} on {n} slots P{tuple(card.sharding.spec)}"] = {
                op: {k: v for k, v in c.items() if v} for op, c in c_l.items()}
    return out


def run_elastic():
    """Phase 3w: jobs whose tables move between the slots of a 4-slot pool
    while they train (see the module doc)."""
    from harmony_tpu_torch.ops.histogram import weighted_histogram
    from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
    from harmony_tpu_torch.parallel.mesh import DevicePool

    t0 = time.perf_counter()
    wrappers = (gather_rows, segment_sum_rows, weighted_histogram)
    dev = torch.device("cuda", 0)
    slots = DevicePool.virtual(dev, ELASTIC_SLOTS).slots
    cpu_slots = DevicePool.virtual("cpu", ELASTIC_SLOTS).slots
    out = {}
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        snaps, wd_ref = step_snapshots(slots, elastic_read_keys())
        fm_ref, _, _, _, _ = run_elastic_job(slots, "fm", 3)
        # the main path: (a) with the reader of (c), and (b), on the card
        reset_counts(*wrappers)
        wd, wd_res, wd_log, reads, wd_owners = run_elastic_job(
            slots, "wd", 2, optimizer="add_one_server", scripted=3, reader=True)
        fm, fm_res, fm_log, _, fm_owners = run_elastic_job(
            slots, "fm", 3, optimizer="delete_one_server", scripted=2)
        launches = {w.__name__: w.launches for w in wrappers}
        wd_cpu = run_elastic_job(cpu_slots, "wd", 2, optimizer="add_one_server",
                                 scripted=3)[0]
        fm_cpu = run_elastic_job(cpu_slots, "fm", 3, optimizer="delete_one_server",
                                 scripted=2)[0]
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    check(wd_res["reconfigs"] == fm_res["reconfigs"] == 1,
          f"phase 3w: optimizer rounds {wd_res['reconfigs']}, {fm_res['reconfigs']}")
    check(wd_owners == [3] and fm_owners == [2],
          f"phase 3w: owning executors at the end {wd_owners}, {fm_owners} (expected 3, 2)")
    check(len(wd_log.moves) == len(fm_log.moves) == 3,
          f"phase 3w: moves {len(wd_log.moves)} and {len(fm_log.moves)} (expected 3 each)")
    for name, got, want in (("(a) bench-widedeep", wd["batch_losses"], wd_ref),
                            ("(b) bench-fm-hash", fm["batch_losses"], fm_ref["batch_losses"])):
        check(got == want, f"phase 3w {name}: the moved job's losses are not the unmoved "
                           f"run's bits")
    for name, got, want in (("(a)", wd["batch_losses"], wd_cpu["batch_losses"]),
                            ("(b)", fm["batch_losses"], fm_cpu["batch_losses"])):
        gap = max(abs(a - b) for a, b in zip(got, want))
        check(len(got) == len(want) == EPOCHS * BATCHES and gap <= LOSS_ATOL,
              f"phase 3w {name}: card against the CPU's moved run: {gap} > {LOSS_ATOL}")
        out[f"{name}_max_abs_gap_vs_cpu"] = gap
    check(len(reads) > 1 and reads_follow_the_steps(reads, snaps),
          f"phase 3w (c): {len(reads)} reads; a read matches no committed step in order")
    check(all(launches[w] > 0 for w in launches),
          f"phase 3w: launches on the path {launches}: a kernel never ran")
    out["launches"] = launches
    out["moves"] = {"(a) bench-widedeep": wd_log.report(), "(b) bench-fm-hash": fm_log.report()}
    out["reader"] = {"reads": len(reads), "keys": ELASTIC_READ_KEYS,
                     "steps_matched": "every read is a committed step's rows, in order"}
    out["losses"] = {"(a)": wd["batch_losses"], "(b)": fm["batch_losses"]}
    for name, moves in out["moves"].items():
        for m in moves:
            print(f"phase 3w {name}: move after step {m['after_step']} from {m['slots'][0]} "
                  f"to {m['slots'][1]} slots P{tuple(m['spec'])}: {m['blocks_moved']} blocks "
                  f"({m['bytes_moved']} bytes) moved, {m['blocks_copied_locally']} copied "
                  f"on their slot, {m['shards_reused']} shards kept; the lock after "
                  f"{m['lock_wait_ms']:.3f} ms, then host {m['host_ms']:.3f} ms (the "
                  f"rebuild {m['migrate_host_ms']:.3f}), device "
                  f"{m['device_ms']:.4f} ms (spin covered the "
                  f"host: {m['spin_covered_host']}); step ms before {m['step_ms_before']}, "
                  f"after {m['step_ms_after']}", flush=True)
    print(f"phase 3w (a)-(c): the moved jobs' losses are the unmoved runs' bits and within "
          f"{LOSS_ATOL} of the CPU's; {len(reads)} serving reads, each a committed step's "
          f"rows; launches {json.dumps(launches)}", flush=True)
    out["table_ops"] = elastic_table_ops(slots, cpu_slots, wrappers)
    print(f"phase 3w (d): K1, K2 and K3 on moved storage byte-identical to the CPU's: "
          f"{json.dumps(out['table_ops'])}", flush=True)

    cards = torch.cuda.device_count()
    if cards >= ELASTIC_SLOTS:
        real = DevicePool().slots[:ELASTIC_SLOTS]
        os.environ["HARMONY_PUSH_VIA"] = "mxu"
        try:
            rwd, _, rwd_log, _, rwd_owners = run_elastic_job(
                real, "wd", 2, optimizer="add_one_server", scripted=3)
            rfm, _, rfm_log, _, _ = run_elastic_job(real, "fm", 3, optimizer="delete_one_server",
                                                    scripted=2)
        finally:
            os.environ.pop("HARMONY_PUSH_VIA")
        check(rwd["batch_losses"] == wd["batch_losses"]
              and rfm["batch_losses"] == fm["batch_losses"] and rwd_owners == [3],
              "phase 3w (e): the moved jobs' bits on the cards differ from the virtual slots'")
        out["real_mesh"] = {"cards": [str(s.device) for s in real],
                            "bits": "the virtual slots' bits on both jobs",
                            "moves": {"(a)": rwd_log.report(), "(b)": rfm_log.report()}}
        print(f"phase 3w (e): on {ELASTIC_SLOTS} cards the virtual slots' bits; moves "
              f"{json.dumps(out['real_mesh']['moves'])}", flush=True)
    else:
        out["real_mesh"] = f"not run: {cards} card(s)"
    out["seconds"] = time.perf_counter() - t0
    return launches, out


# -- phase 3x: the rest of the slot mesh ----------------------------------------

DX_SLOTS = 4
# (b)'s jobs run this many epochs of BATCHES-or-fewer mini-batches each: the
# phase's budget is 60 s of command for (a) and (b)
DX_EPOCHS = 2
# NMF's and Lasso's per-batch losses at data_axis 2 against one slot: the
# rows' sums add in another order (relative to max(1, |loss|))
DX_LOSS_RTOL = 1e-4
# bench-gbt's per-batch losses at data_axis 2 against one slot. A split's
# gain is a difference of three G^2 / (H + lam) terms, which cancel; the
# rows' histograms add in another order, so where two of a node's 7,140
# candidate splits nearly tie the data axis may take the other one (my CPU
# run of bench-gbt's width took another split in 10 of 16 rounds after round
# 0, the same partition in round 0, and its losses came within 2.7e-5): the
# trees are held as partitions in round 0, whose inputs are the same bits,
# and by their losses after it
DX_GBT_LOSS_RTOL = 1e-3
_DX_GRAPHS = {}


def dx_graph(num_vertices, avg_degree=4, seed=0, weighted=False):
    """bench-pagerank's graph (``random_graph``'s draws), built once a phase
    for the three graph jobs: the unweighted graph is the weighted one's
    edges with unit weights, as ``random_graph`` draws the weights after the
    edges. The jobs name it as their ``graph_fn`` (``__main__:dx_graph``)."""
    from harmony_tpu_torch.pregel.graph import Graph, random_graph

    key = (num_vertices, avg_degree, seed)
    if key not in _DX_GRAPHS:
        _DX_GRAPHS[key] = random_graph(num_vertices, avg_degree, seed=seed, weighted=True)
    g = _DX_GRAPHS[key]
    if weighted:
        return g
    plain = Graph.__new__(Graph)
    plain.num_vertices, plain.src, plain.dst = g.num_vertices, g.src, g.dst
    plain.weight = np.ones(len(g.src), np.float32)
    plain.out_degree = g.out_degree
    return plain


def dx_graph_job(app):
    config = graph_job(app, PR_VERTICES)
    return config.replace(user={**config.user, "graph_fn": "__main__:dx_graph"})


def dx_pregel(slots, one_slot, wrappers):
    """Phase 3x (a): the three graph jobs through a JobServer of 4 executors
    on ``slots``, each job's values the bits of its one-slot run."""
    apps = ("pagerank", "shortest-path", "connected-components")
    out, launches = {}, {w.__name__: 0 for w in wrappers}
    server = pool_server(slots)
    try:
        for app in apps:
            reset_counts(*wrappers)
            t0 = time.perf_counter()
            res = server.submit(dx_graph_job(app)).result(timeout=900)
            seconds = time.perf_counter() - t0
            got = {w.__name__: w.launches for w in wrappers}
            for k, v in got.items():
                launches[k] += v
            s, n = res["supersteps"], len(slots)
            want = {name: 0 for name in got}
            want["gather_rows"] = n * s
            want["segment_sum_rows"] = n * s if app == "pagerank" else 0
            check(got == want, f"phase 3x (a) bench-{app}: launches {got}, expected {want} "
                               f"(K1 once a shard a superstep, K2 for the add fold)")
            ref = one_slot[app]
            check(s == ref["supersteps"]
                  and np.array_equal(res["vertex_values"], ref["vertex_values"]),
                  f"phase 3x (a) bench-{app}: {n} shards are not the one-slot run's bits")
            edges = dx_graph(PR_VERTICES, PR_DEGREE).num_edges * (
                2 if app == "connected-components" else 1)
            out[app] = {"supersteps": s, "superstep_ms": res["wall_sec"] * 1e3 / s,
                        "edges_per_sec": edges * s / res["wall_sec"],
                        "run_seconds": seconds, "launches": got,
                        "per_superstep_per_shard": {k: v / s / n for k, v in got.items()},
                        "bits": "the one-slot run's"}
            print(f"phase 3x (a) bench-{app} on {n} shards: {json.dumps(out[app])}",
                  flush=True)
    finally:
        server.shutdown(timeout=600)
    return out, launches


def dx_pregel_profile(slots):
    """A bench-pagerank run on the 4-slot mesh under torch.profiler (busy
    ms and idle share a superstep), and the all-gather's device ms."""
    from harmony_tpu_torch.apps.pagerank import PageRankComputation
    from harmony_tpu_torch.parallel.mesh import build_mesh
    from harmony_tpu_torch.pregel import PregelMaster

    g = dx_graph(PR_VERTICES, PR_DEGREE)
    master = PregelMaster(g, PageRankComputation(g, PR_ITERATIONS),
                          build_mesh(slots, data=1))
    try:
        prof = profile_run(master.run, PR_ITERATIONS + 1, top_n=8)
        arr = master.vertex_table.array
        parts = [arr.shards[s.slot].view(-1, 2)[:s.n] for s in master._shards]
        prof["all_gather_device_ms"] = device_ms(lambda: master._all_gather(parts), calls=20)
        prof["all_gather_mb"] = sum(p.numel() * 4 for p in parts) / 1e6
    finally:
        master.close()
    return prof


def dx_configs():
    """(b)'s jobs: the trio's NMF and LDA (bench.py's widths), sparse LDA at
    the trio's width, bench-gbt and the lasso preset."""
    from harmony_tpu_torch import bench

    trio, _ = bench.job_configs(TRIO_SCALE, DX_EPOCHS)
    by_id = {c.job_id: c for c in trio}
    return {"bench-nmf": by_id["bench-nmf"], "bench-lda": by_id["bench-lda"],
            "sparse-lda": hash_job("lda", DX_EPOCHS),
            "bench-gbt": gbt_job(DX_EPOCHS),
            "lasso": preset_config("lasso", epochs=DX_EPOCHS).replace(num_workers=1)}


class dx_tables:
    """Keep each Dolphin job's final tables (host copies) as the entity drops
    them: ``saved[job_id] = (model, local)``; a hash model is read at the
    keys its data holds."""

    def __init__(self):
        self.saved = {}

    def __enter__(self):
        from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
        from harmony_tpu_torch.table.hashtable import DeviceHashTable

        self._cls, self._real = DolphinJobEntity, DolphinJobEntity.cleanup
        saved = self.saved

        def cleanup(entity):
            table, local = entity._table, entity._local
            if table is not None:
                if isinstance(table, DeviceHashTable):
                    from harmony_tpu_torch.apps.lda import LDA_MAX_WORD_KEY, LDA_SUMMARY_KEY

                    tokens = entity._data_arrays[1]
                    keys = np.unique(tokens[(tokens >= 1) & (tokens <= LDA_MAX_WORD_KEY)])
                    model = table.multi_get(np.append(keys, LDA_SUMMARY_KEY))
                else:
                    model = table.pull_array().cpu().numpy()
                saved[entity.config.job_id] = (
                    model, None if local is None else local.pull_array().cpu().numpy(),
                    entity._data_arrays)
            self._real(entity)

        DolphinJobEntity.cleanup = cleanup
        return self

    def __exit__(self, *exc):
        self._cls.cleanup = self._real


def gbt_settled_at(tree, bins, n):
    """The node at which each example of ``bins`` settles in ``tree``."""
    feat, thr = tree[:n].astype(np.int64), tree[n:2 * n].astype(np.int64)
    leaf = tree[2 * n:3 * n] > 0.5
    pos = np.zeros(len(bins), np.int64)
    while not leaf[pos].all():
        right = bins[np.arange(len(bins)), feat[pos]] > thr[pos]
        pos = np.where(leaf[pos], pos, 2 * pos + 1 + right)
    return pos


def dx_agree(name, one, two, t1, t2, batches):
    """(b)'s limits of one job at data_axis 2 against its one-slot run
    (``t1``, ``t2``: the runs' tables and data; ``batches`` a epoch)."""
    got, want = two["batch_losses"], one["batch_losses"]
    check(len(got) == len(want), f"phase 3x (b) {name}: {len(got)} and {len(want)} batches")
    gap = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got, want))
    if name in ("bench-lda", "sparse-lda"):
        check(np.array_equal(t2[0], t1[0]) and np.array_equal(t2[1], t1[1]),
              f"phase 3x (b) {name}: counts or assignments differ from one slot")
        return {"counts_and_assignments": "the one-slot bits", "max_rel_gap": gap}
    if name == "bench-gbt":
        n = 2 ** (GBT_APP["max_depth"] + 1) - 1
        trees1, trees2 = t1[0], t2[0]
        bins = t1[2][0]
        nb = len(bins) // batches
        same = [np.array_equal(gbt_settled_at(trees2[r], bins[(r % batches) * nb:
                                                              (r % batches + 1) * nb], n),
                               gbt_settled_at(trees1[r], bins[(r % batches) * nb:
                                                              (r % batches + 1) * nb], n))
                for r in range(trees1.shape[0])]
        check(same[0], f"phase 3x (b) {name}: round 0's tree parts its batch otherwise")
        check(gap <= DX_GBT_LOSS_RTOL, f"phase 3x (b) {name}: losses {gap} > "
                                       f"{DX_GBT_LOSS_RTOL} x max(1, |loss|) from one slot")
        return {"trees": "round 0 the one-slot tree as a partition of its batch",
                "rounds_with_the_one_slot_partition": int(sum(same)),
                "rounds": len(same), "max_rel_gap": gap}
    check(gap <= DX_LOSS_RTOL, f"phase 3x (b) {name}: losses {gap} > {DX_LOSS_RTOL} "
                               f"x max(1, |loss|) from one slot")
    return {"max_rel_gap": gap}


def dx_jobs(slots, wrappers, one_slot=None):
    """Phase 3x (b): each of dx_configs() at data_axis 2 on (2, 2) of
    ``slots``, twice, through a JobServer, against one slot of the card
    (``one_slot``: the runs to hold to; made here when None). Returns the
    numbers, the launches of the first data-axis runs, the one-slot runs and
    the data-axis runs' results and tables."""
    configs = dx_configs()
    out, launches = {}, {w.__name__: 0 for w in wrappers}
    ones = {} if one_slot is None else one_slot
    runs = {}
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        with dx_tables() as kept:
            if one_slot is None:
                server = pool_server(slots[:1])
                try:
                    for name, config in configs.items():
                        w, _ = submit_one(server, config)
                        ones[name] = (w, kept.saved.pop(config.job_id))
                finally:
                    server.shutdown(timeout=600)
            server = pool_server(slots)
            try:
                for name, config in configs.items():
                    dp = config.replace(user={**config.user, "data_axis": 2})
                    reset_counts(*wrappers)
                    w2, _ = submit_one(server, dp)
                    for w in wrappers:
                        launches[w.__name__] += w.launches
                    t2 = kept.saved.pop(config.job_id)
                    again, _ = submit_one(server, dp)
                    kept.saved.pop(config.job_id)
                    check(w2["mesh"] == {"data": 2, "model": len(slots) // 2}
                          and w2["step_mode"] == "data_parallel",
                          f"phase 3x (b) {name}: mesh {w2['mesh']}, {w2['step_mode']}")
                    check(w2["batch_losses"] == again["batch_losses"],
                          f"phase 3x (b) {name}: data_axis 2 is not the same bits twice")
                    check(w2["input"]["restaged_batches"] == 0,
                          f"phase 3x (b) {name}: {w2['input']['restaged_batches']} steps "
                          "cut a batch not staged for their rows")
                    w1, t1 = ones[name]
                    n = len(t1[2][0]) if t1[2] else 0
                    entry = dx_agree(name, w1, w2, t1, t2, config.params.num_mini_batches)
                    entry.update(
                        samples_per_sec=n / w2["epoch_seconds"][-1],
                        one_slot_samples_per_sec=n / w1["epoch_seconds"][-1],
                        batch_losses=w2["batch_losses"])
                    out[name] = entry
                    runs[name] = (w2, t2)
                    print(f"phase 3x (b) {name} on (2, 2): {json.dumps(entry)}", flush=True)
            finally:
                server.shutdown(timeout=600)
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    return out, launches, ones, runs


def peer_copies(prof):
    """Device-to-device copies in a profile: (count, bytes)."""
    events = [e for e in chrome_trace(prof, "dx") if e.get("cat") == "gpu_memcpy"
              and ("PtoP" in e.get("name", "") or "DtoD" in e.get("name", ""))]
    return len(events), sum(max(0, int(e.get("args", {}).get("bytes", 0))) for e in events)


class CopyWatch:
    """Every copy between two cards made while it is entered, by the storage
    it reads (``sources``: data pointer -> bytes): a dispatch mode over the
    calling thread's operations."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        sources = self.sources = {}

        def note(src, dst_device):
            if src.device.type == "cuda" and torch.device(dst_device).type == "cuda" \
                    and src.device != torch.device(dst_device):
                ptr = src.untyped_storage().data_ptr()
                sources[ptr] = sources.get(ptr, 0) + src.numel() * src.element_size()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func is torch.ops.aten._to_copy.default and kwargs.get("device"):
                    note(args[0], kwargs["device"])
                elif func is torch.ops.aten.copy_.default:
                    note(args[1], args[0].device)
                return func(*args, **kwargs)

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def dx_copies(config, slots):
    """A data-axis run of ``config`` on (2, 2) of the cards' ``slots`` by a
    lone worker (fused windows over the stack staged by row) under
    torch.profiler and a CopyWatch: no copy between cards reads a batch
    array, but for the keys of a keyed pull, which every shard's gather and
    fold needs (the table's traffic); and the trace's peer copies a step."""
    from torch.profiler import ProfilerActivity, profile

    from harmony_tpu_torch.dolphin.rows import RowBatch
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    config = config.replace(user={**config.user, "data_axis": 2})
    master = ETMaster(DevicePool(slots))
    entity = DolphinJobEntity(config)
    entity.setup(master, [e.id for e in master.add_executors(len(slots))])
    try:
        worker = entity.make_worker()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, CopyWatch() as watch:
            res = worker.run()
            torch.cuda.synchronize()
        stack = worker._stacked_cache
        check(isinstance(stack, RowBatch) and stack.devices == tuple(
            slots[2 * r].device for r in range(2)),
              f"phase 3x (c) {config.job_id}: the stack is not staged by row")
        part = stack.index(0).parts[0]
        keys = (worker.trainer.pull_keys(part).untyped_storage().data_ptr()
                if worker.trainer.pull_mode == "keys" else None)
        read, key_bytes = [], 0
        for p in stack.parts:
            for i, a in enumerate(p):
                ptr = a.untyped_storage().data_ptr()
                if ptr not in watch.sources:
                    continue
                if keys is not None and part[i].untyped_storage().data_ptr() == keys:
                    key_bytes += watch.sources[ptr]
                else:
                    read.append((i, watch.sources[ptr]))
        check(not read, f"phase 3x (c) {config.job_id}: copies between cards read batch "
                        f"arrays (array, bytes) {read}")
        check(res["input"]["restaged_batches"] == 0,
              f"phase 3x (c) {config.job_id}: a step cut a batch not staged for its rows")
        steps = len(res["batch_losses"])
        count, nbytes = peer_copies(prof)
        return {"batch_arrays_copied_between_cards": 0,
                "key_bytes_between_cards_per_step": key_bytes / steps,
                "peer_copies_per_step": count / steps,
                "peer_bytes_per_step": nbytes / steps, "steps": steps}
    finally:
        entity.cleanup()


def dx_cards(cards_slots, one_slot_graph, virtual_runs):
    """Phase 3x (c): (a) and (b) on the cards give the virtual slots' bits;
    profiled data-axis runs copy no batch array between cards
    (:func:`dx_copies`); bench-widedeep at data_axis 2 on the cards in
    samples/s."""
    out = {"cards": [str(s.device) for s in cards_slots]}
    g_out, _ = dx_pregel(cards_slots, one_slot_graph, all_wrappers())
    out["pregel"] = {app: {k: e[k] for k in ("supersteps", "superstep_ms", "edges_per_sec")}
                     for app, e in g_out.items()}
    runs = {}
    configs = dx_configs()
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        with dx_tables() as kept:
            server = pool_server(cards_slots)
            try:
                for name, config in configs.items():
                    dp = config.replace(user={**config.user, "data_axis": 2})
                    w2, _ = submit_one(server, dp)
                    t2 = kept.saved.pop(config.job_id)
                    vw, vt = virtual_runs[name]
                    check(w2["batch_losses"] == vw["batch_losses"]
                          and all(np.array_equal(a, b) for a, b in zip(t2[:2], vt[:2])
                                  if a is not None),
                          f"phase 3x (c) {name}: the cards' bits differ from the virtual "
                          "slots'")
                    runs[name] = len(t2[2][0]) / w2["epoch_seconds"][-1]
                out["dp_samples_per_sec"] = runs
                w, _ = submit_one(server, wd_mesh_config("wd-dx", EPOCHS, data_axis=2))
                out["widedeep_data_axis_2_samples_per_sec"] = N_EXAMPLES / w["epoch_seconds"][-1]
            finally:
                server.shutdown(timeout=600)
            out["copies"] = {name: dx_copies(config, cards_slots) for name, config in (
                ("bench-nmf", configs["bench-nmf"]),
                ("bench-widedeep", wd_mesh_config("wd-dx", EPOCHS)))}
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    # PR 14's figure of the same job on four cards (PERF.md, its chip run)
    out["widedeep_data_axis_2_pr14_samples_per_sec"] = 88410
    return out


def dx_one_slot_graphs(slot):
    """The graph jobs on one slot of the card (``--phase 3x`` alone; the full
    run holds (a) to phase 3l's runs)."""
    server = pool_server([slot])
    try:
        return {app: server.submit(dx_graph_job(app)).result(timeout=900)
                for app in ("pagerank", "shortest-path", "connected-components")}
    finally:
        server.shutdown(timeout=600)


def run_dx(one_slot_graph=None):
    """Phase 3x: Pregel's sharded tables, a data axis of 2 beside
    worker-local tables and for the trainers whose delta is not linear in
    the batch, each data row's batch staged on its own slot (see the module
    doc)."""
    from harmony_tpu_torch.parallel.mesh import DevicePool

    t0 = time.perf_counter()
    wrappers = all_wrappers()
    slots = DevicePool.virtual("cuda:0", DX_SLOTS).slots
    if one_slot_graph is None:
        one_slot_graph = dx_one_slot_graphs(slots[0])
    t_ab = time.perf_counter()
    pregel, pregel_launches = dx_pregel(slots, one_slot_graph, wrappers)
    dp, dp_launches, _, runs = dx_jobs(slots, wrappers)
    out = {"pregel_sharded": pregel, "dp": dp,
           "a_and_b_seconds": time.perf_counter() - t_ab}
    check(all(pregel_launches[k] > 0 for k in ("gather_rows", "segment_sum_rows"))
          and dp_launches["gather_rows"] > 0 and dp_launches["segment_sum_rows"] > 0
          and dp_launches["weighted_histogram"] > 0,
          f"phase 3x: launches {pregel_launches}, {dp_launches}: a kernel never ran")
    out["launches"] = {"pregel-sharded": pregel_launches, "dp-local": dp_launches}
    out["pregel_profile"] = dx_pregel_profile(slots)
    print(f"phase 3x (a) profile: {json.dumps(out['pregel_profile'])}", flush=True)
    cards = torch.cuda.device_count()
    if cards >= DX_SLOTS:
        out["real_mesh"] = dx_cards(DevicePool().slots[:DX_SLOTS], one_slot_graph, runs)
        print(f"phase 3x (c): {json.dumps(out['real_mesh'])}", flush=True)
    else:
        out["real_mesh"] = f"not run: {cards} card(s)"
    out["seconds"] = time.perf_counter() - t0
    return out["launches"], out


# -- phase 3y: the multi-process pod ------------------------------------------

# Seconds a pod process may take to join and report ready, and a pod job to
# finish (each job of 3y takes a few seconds; bench-pagerank's graph is built
# in every process first).
POD_READY_S = 120
POD_JOB_S = 300
POD_PR_ITERATIONS = PR_CPU_ITERATIONS


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ChipPod:
    """``python -m harmony_tpu_torch.cli start-pod`` in ``n`` processes: one a
    card (``CUDA_VISIBLE_DEVICES``, NCCL) when ``own_cards``, else all on
    cuda:0 (gloo), each logging into a temporary directory; ``slots`` slots
    of its card a process. Killed in ``close`` whatever happened."""

    def __init__(self, n: int, own_cards: bool, phase: str = "3y", slots: int = 1,
                 env: dict = None, scheduler: str = "share_all") -> None:
        import tempfile

        from harmony_tpu_torch.jobserver.client import CommandSender

        self.phase = phase
        self.port, pod_port, store = free_port(), free_port(), free_port()
        self.procs, self.logs = [], []
        self.log_dir = tempfile.mkdtemp(prefix="harmony-pod-")
        for p in range(n):
            # a wedged collective raises well inside the phase's waits
            penv = dict(os.environ, OMP_NUM_THREADS="4", HARMONY_PUSH_VIA="mxu",
                        HARMONY_POD_HB_PERIOD="1", HARMONY_POD_UNIT_TIMEOUT="120")
            penv.update(env or {})
            if own_cards:
                penv["CUDA_VISIBLE_DEVICES"] = str(p)
            err = open(os.path.join(self.log_dir, f"pod-process{p}.log"), "w")
            self.logs.append(err)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "harmony_tpu_torch.cli", "start-pod",
                 "--device", ",".join(["cuda:0"] * slots),
                 "--coordinator", f"127.0.0.1:{store}", "--num-processes", str(n),
                 "--process-id", str(p), "--pod-port", str(pod_port), "--port", str(self.port),
                 "--scheduler", scheduler],
                cwd=REPO, env=penv, stdout=err, stderr=subprocess.STDOUT, text=True))
        self.sender = CommandSender(self.port)
        deadline = time.monotonic() + POD_READY_S
        while True:
            text = self.log(0)
            if "pod jobserver ready" in text:
                self.ready_line = next(ln for ln in text.splitlines() if "pod jobserver ready" in ln)
                self.backend = next(ln for ln in text.splitlines() if "backend" in ln)
                break
            dead = [p for p, proc in enumerate(self.procs) if proc.poll() is not None]
            check(not dead and time.monotonic() < deadline,
                  f"phase {phase}: the pod never became ready (exited: {dead}): "
                  f"{self.log(0)[-3000:]}")
            time.sleep(0.5)

    def log(self, p: int) -> str:
        self.logs[p].flush()
        with open(os.path.join(self.log_dir, f"pod-process{p}.log")) as f:
            return f.read()

    def run(self, *configs, between=None):
        """Submit ``configs`` together, call ``between()`` (if given), wait for
        each; returns {job id: {pid: report}} and the leader's walls."""
        for cfg in configs:
            reply = self.sender.send_job_submit_command(cfg)
            check(reply.get("ok"), f"phase {self.phase}: submit {cfg.job_id}: {reply}")
        if between is not None:
            between()
        for cfg in configs:
            try:
                self.sender.wait_result(cfg.job_id, timeout=POD_JOB_S, poll=5.0)
            except Exception as e:  # noqa: BLE001 - the phase fails
                fail(f"phase {self.phase}: {cfg.job_id} failed on the pod: {e}\n"
                     + "\n".join(self.log(p)[-2000:] for p in range(len(self.procs))))
        ids = [c.job_id for c in configs]
        deadline = time.monotonic() + 60
        while True:
            pod = self.sender.send_status_command()["pod"]
            if all(j in pod["reports"] for j in ids) and not set(ids) & set(pod["active"]):
                return {j: pod["reports"][j] for j in ids}, pod
            check(time.monotonic() < deadline, f"phase {self.phase}: no reports for {ids}")
            time.sleep(0.2)

    def shutdown(self, dead=()) -> dict:
        """SHUTDOWN: every process (but the ``dead`` ones) must exit 0 within
        the deadline; returns what the leader prints as it closes (its
        deferred evaluations' results, whether the pod was broken, and its
        recovery events)."""
        check(self.sender.send_shutdown_command().get("ok"),
              f"phase {self.phase}: the pod refused SHUTDOWN")
        for p, proc in enumerate(self.procs):
            if p in dead:
                continue
            try:
                proc.wait(timeout=POD_JOB_S)
            except subprocess.TimeoutExpired:
                fail(f"phase {self.phase}: process {p} did not exit: {self.log(p)[-3000:]}")
            check(proc.returncode == 0, f"phase {self.phase}: process {p} exited "
                                        f"{proc.returncode}: {self.log(p)[-3000:]}")
        prefix = "pod jobserver closed: "
        lines = [ln for ln in self.log(0).splitlines() if ln.startswith(prefix)]
        check(len(lines) == 1, f"phase {self.phase}: no closing line: {self.log(0)[-3000:]}")
        return json.loads(lines[0][len(prefix):])

    def close(self) -> None:
        try:
            if all(p.poll() is None for p in self.procs):
                self.sender.send_shutdown_command()
                for p in self.procs:
                    p.wait(timeout=60)
        except Exception:  # noqa: BLE001 - killed below
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            for f in self.logs:
                f.close()
            shutil.rmtree(self.log_dir, ignore_errors=True)


def pod_wd_config(job_id: str, epochs: int = EPOCHS):
    """bench-widedeep (phase 3's job: SLICE_ARGS, EPOCHS epochs unless
    given) with one worker, as a config to submit."""
    from harmony_tpu_torch import cli

    args = cli.build_parser().parse_args(
        SLICE_ARGS + ["--epochs", str(epochs), "--workers", "1", "--job-id", job_id])
    return cli.build_config("widedeep", args)


def pod_pr_config(job_id: str):
    """bench-pagerank at POD_PR_ITERATIONS iterations (phase 3l's run of that
    many, on one slot, is its reference)."""
    job = graph_job("pagerank", PR_VERTICES)
    return job.replace(job_id=job_id, params=job.params.replace(app_params={
        **job.params.app_params, "num_iterations": POD_PR_ITERATIONS}))


def vertex_digest(values) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(values).tobytes()).hexdigest()


def pod_one_slot_refs():
    """The one-slot runs phase 3y is held to, made here when 3y runs alone:
    bench-widedeep on the mxu route (phase 3's), bench-fm-hash's first epoch
    (phase 3h's) and bench-pagerank at POD_PR_ITERATIONS (phase 3l's)."""
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        # one executor: on a host of several cards `cli run` would take them all
        wd = run_cli(SLICE_ARGS + ["--epochs", str(EPOCHS), "--num-executors", "1"])["batch_losses"]
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        (fm,) = server.submit(hash_job("fm", 1)).result(timeout=600)["workers"].values()
    finally:
        server.shutdown()
    pr = graph_entity_run(pod_pr_config("bench-pagerank"), "cuda")
    return {"wd": wd, "fm": fm["batch_losses"][:BATCHES],
            "pagerank": vertex_digest(pr["vertex_values"]), "pagerank_supersteps": pr["supersteps"]}


# Phase 3y (e): the all-gather alone, in fresh processes joined as the pod's
# are, at (a)'s and (d)'s sizes: CALLS timed calls after WARM, each process's
# mean host ms a call (the CALLS collectives between two device syncs).
POD_COMBINE_SCRIPT = r"""
import json, sys, time, torch
from harmony_tpu_torch.parallel import collectives, multihost
store, n, p, own = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4] == "1"
multihost.initialize_distributed(store, n, p, devices=["cuda" if own else "cuda:0"])
dev = multihost.local_devices()[0]
WARM, CALLS = 3, 20
out = {"process": p, "backend": multihost.backend()}
per = -(-4847571 // 64) * (64 // n)
for name, shape in (("widedeep_pull", (67480, 17)), ("pagerank_states", (1, per, 2))):
    t = torch.randn(shape, device=dev)
    for _ in range(WARM):
        collectives.process_all_gather(t, range(n))
    torch.cuda.synchronize(dev)
    multihost.mesh_barrier(multihost.global_mesh())
    t0 = time.perf_counter()
    for _ in range(CALLS):
        collectives.process_all_gather(t, range(n))
    torch.cuda.synchronize(dev)
    out[name] = {"bytes_out": t.numel() * 4, "bytes_in": t.numel() * 4 * n,
                 "ms_per_call": 1e3 * (time.perf_counter() - t0) / CALLS}
multihost.shutdown_distributed()
print("RESULT " + json.dumps(out), flush=True)
"""


def pod_combine_alone(n: int, own: bool):
    """Phase 3y (e): POD_COMBINE_SCRIPT in n fresh processes; their results."""
    return pod_script(POD_COMBINE_SCRIPT, n, own, "3y (e)")


def run_pod(refs):
    """Phase 3y: the pod (see the module doc). ``refs``: the one-slot runs'
    bench-widedeep batch losses, bench-fm-hash's first epoch's and
    bench-pagerank's vertex digest and supersteps."""
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    own = cards >= 4
    n = 4 if own else 2
    torch.cuda.empty_cache()
    out = {"processes": n, "cards": cards if own else 1}
    pod = ChipPod(n, own)
    launches = {name: 0 for name in ("gather_rows", "segment_sum_rows", "weighted_histogram",
                                     "flash_forward", "flash_backward_dkv", "flash_backward_dq")}
    try:
        out["ready"] = pod.ready_line
        out["backend"] = pod.backend.split(": ", 1)[-1]
        out["start_seconds"] = time.perf_counter() - t0
        print(f"phase 3y: {out['ready']}; {out['backend']}", flush=True)
        calls = 1 + WorkerTasklet.PROBE_SAMPLES
        steps = EPOCHS * BATCHES

        def each(reps, what):
            check(sorted(reps) == [str(p) for p in range(n)] and all(r["ok"] for r in reps.values()),
                  f"phase 3y {what}: reports {json.dumps(reps)[:3000]}")
            return [reps[str(p)] for p in range(n)]

        def losses(rep):
            (w,) = rep["workers"].values()
            return w

        def combine(rep):
            """The job's all-gathers in this process: calls and bytes, and
            the bytes of one call."""
            c = rep["combine"]
            return {"calls": c["calls"], "bytes_out": c["bytes_out"], "bytes_in": c["bytes_in"],
                    "bytes_in_per_call": c["bytes_in"] / max(c["calls"], 1)}

        def widedeep(job_id, what):
            """bench-widedeep over the n processes: the one-slot bits and
            each process's launches checked; its numbers by process."""
            reps, _ = pod.run(pod_wd_config(job_id))
            rows = []
            for p, rep in enumerate(each(reps[job_id], what)):
                w = losses(rep)
                check(w["batch_losses"] == refs["wd"],
                      f"phase 3y {what}: process {p}'s losses {w['batch_losses']} are not "
                      f"the one-slot run's {refs['wd']}")
                k = w["probes"] * calls
                want = {"gather_rows": steps + 2 * k, "weighted_histogram": steps + k,
                        "segment_sum_rows": 0}
                got = {name: rep["launches"][name] for name in want}
                check(got == want, f"phase 3y {what}: process {p} launched {got}, expected {want}")
                rows.append({"process": p, "launches": got, "all_launches": rep["launches"],
                             "probes": w["probes"], "epoch_seconds": w["epoch_seconds"],
                             "step_ms": 1e3 * w["epoch_seconds"][-1] / BATCHES,
                             "samples_per_sec": N_EXAMPLES / w["epoch_seconds"][-1],
                             "units": rep.get("units"), "combine": combine(rep)})
            return rows

        # (a) bench-widedeep at full width, its table over the n processes: the
        # first job of each process, so its first steps load the kernels and
        # libraries and its first all-gather makes the backend's communicator
        a = widedeep("pod-widedeep", "(a)")
        for row in a:
            for name, v in row.pop("all_launches").items():
                launches[name] += v
        out["widedeep"] = a
        print(f"phase 3y (a): bench-widedeep over {n} processes gives the one-slot bits: "
              f"{json.dumps(a)}", flush=True)

        # (b) bench-fm-hash on a DeviceHashTable over the n processes
        reps, _ = pod.run(hash_job("fm", 1).replace(job_id="pod-fm-hash"))
        reps = each(reps["pod-fm-hash"], "(b)")
        b = []
        for p, rep in enumerate(reps):
            w = losses(rep)
            check(w["batch_losses"] == refs["fm"],
                  f"phase 3y (b): process {p}'s losses {w['batch_losses']} are not the "
                  f"one-slot run's {refs['fm']}")
            k = w["probes"] * calls
            want = {"gather_rows": BATCHES + 2 * k, "segment_sum_rows": BATCHES + k,
                    "weighted_histogram": 0}
            got = {name: rep["launches"][name] for name in want}
            check(got == want, f"phase 3y (b): process {p} launched {got}, expected {want}")
            for name, v in rep["launches"].items():
                launches[name] += v
            b.append({"process": p, "launches": got,
                      "step_ms": 1e3 * w["epoch_seconds"][-1] / BATCHES,
                      "combine": combine(rep)})
        out["fm_hash"] = b
        print(f"phase 3y (b): bench-fm-hash over {n} processes gives the one-slot bits: "
              f"{json.dumps(b)}", flush=True)

        # (c) both at once (share-all): they overlap, each with its solo bits
        reps, status = pod.run(pod_wd_config("pod-widedeep-beside"),
                               hash_job("fm", 1).replace(job_id="pod-fm-hash-beside"))
        (a0, a1), (b0, b1) = status["walls"]["pod-widedeep-beside"], status["walls"]["pod-fm-hash-beside"]
        check(a0 < b1 and b0 < a1, f"phase 3y (c): the tenants did not overlap: {status['walls']}")
        c = {"walls_s": {"widedeep": [0.0, a1 - a0], "fm_hash": [b0 - a0, b1 - a0]},
             "units_by_job": {}}
        for jid, want, key in (("pod-widedeep-beside", refs["wd"], "widedeep"),
                               ("pod-fm-hash-beside", refs["fm"], "fm_hash")):
            for p, rep in enumerate(each(reps[jid], "(c)")):
                check(losses(rep)["batch_losses"] == want,
                      f"phase 3y (c): {jid} on process {p} is not its solo run")
            c["units_by_job"][key] = reps[jid]["0"].get("units")
        c["units_granted_total"] = status["units_granted"]
        out["share_all"] = c
        print(f"phase 3y (c): the two tenants overlapped with their solo bits: {json.dumps(c)}",
              flush=True)

        # (d) bench-pagerank at LiveJournal's scale over the n processes
        reps, _ = pod.run(pod_pr_config("pod-pagerank"))
        reps = each(reps["pod-pagerank"], "(d)")
        d = []
        for p, rep in enumerate(reps):
            check(rep["vertex_digest"] == refs["pagerank"]
                  and rep["supersteps"] == refs["pagerank_supersteps"],
                  f"phase 3y (d): process {p}'s vertex values are not the one-slot run's")
            s = rep["supersteps"]
            want = {"gather_rows": s, "segment_sum_rows": s, "weighted_histogram": 0}
            got = {name: rep["launches"][name] for name in want}
            check(got == want, f"phase 3y (d): process {p} launched {got}, expected {want}")
            for name, v in rep["launches"].items():
                launches[name] += v
            d.append({"process": p, "supersteps": s, "launches": got,
                      "superstep_ms": 1e3 * rep["wall_sec"] / s,
                      "combine": combine(rep)})
        out["pagerank"] = d
        print(f"phase 3y (d): bench-pagerank over {n} processes gives the one-slot values: "
              f"{json.dumps(d)}", flush=True)

        # (a) again, in warm processes: its step ms and all-gathers
        warm = widedeep("pod-widedeep-warm", "(a), warm")
        for row in warm:
            del row["all_launches"]
        out["widedeep_warm"] = warm
        print(f"phase 3y (a), warm: {json.dumps(warm)}", flush=True)
    finally:
        pod.close()
    out["combine_alone"] = pod_combine_alone(n, own)
    print(f"phase 3y (e): the all-gather alone: {json.dumps(out['combine_alone'])}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    check(all(launches[k] > 0 for k in ("gather_rows", "segment_sum_rows", "weighted_histogram")),
          f"phase 3y: launches {launches}: a kernel never ran on the pod")
    return launches, out


# -- phase 3z: tables that move between the pod's processes -------------------

# bench-widedeep and bench-fm-hash over MOVE_EPOCHS epochs (a plan needs
# EPOCH_WINDOW + 1 epochs of lead: the plans land at 9, 11, 13 and 13), and the
# optimizer's run over OPT_EPOCHS (its one plan lands near epoch 10). A moved
# job sleeps MOVE_START_LAG_S on the host before its first epoch (in every
# process), so the plans, sent right after the submit, reach it at observed
# epoch 0 (they take milliseconds in this process).
MOVE_EPOCHS = 14
OPT_EPOCHS = 24
MOVE_START_LAG_S = 2.0
MOVE_PLAN_EPOCHS = (9, 11, 13, 13)
# slots a process of 3z's training pod: a drain of one executor changes the
# table's owners while its process stays an owner
MOVE_SLOTS = 2
_POD_MOVE_SYMBOLS: dict = {}


def _pod_move_symbols() -> dict:
    """Phase 3z's trainers and optimizer, built at first use (importing this
    script needs nothing of the repo): ``SlowStartWideDeepTrainer`` and
    ``SlowStartFMTrainer`` (the apps' trainers with a host sleep of
    ``start_lag_sec`` before the first epoch) and ``MoveOncePodOptimizer``
    (the reference's ``tests/helpers.py:54-75`` in port form: one move-only
    plan once worker metrics exist, here every block of the last executor
    onto executor-0: the table's owners change, and on a pod of two slots a
    process every process stays an owner); and phase 3el's
    ``ElasticLagWideDeep``, whose sleep comes only before a run that starts
    at epoch 0 (not before a recovery attempt's)."""
    if _POD_MOVE_SYMBOLS:
        return _POD_MOVE_SYMBOLS
    from harmony_tpu_torch.apps.widedeep import FMTrainer, WideDeepTrainer
    from harmony_tpu_torch.optimizer.api import DolphinPlan, TransferStep

    def slow_start(base, first_run_only=False):
        class SlowStart(base):
            def __init__(self, start_lag_sec: float = 0.0, **kw) -> None:
                super().__init__(**kw)
                self._start_lag_sec = start_lag_sec

            def on_training_start(self, ctx, starting_epoch: int) -> None:
                if starting_epoch == 0 or not first_run_only:
                    time.sleep(self._start_lag_sec)
                super().on_training_start(ctx, starting_epoch)

        return SlowStart

    class MoveOncePodOptimizer:
        def __init__(self) -> None:
            self.fired = False

        def optimize(self, params, num_available_evaluators):
            if self.fired or not params.worker_metrics:
                return DolphinPlan()
            src = max(params.block_counts, key=lambda e: int(e.rsplit("-", 1)[1]))
            n = params.block_counts.get(src, 0)
            if not n:
                return DolphinPlan()
            self.fired = True
            return DolphinPlan(transfer_steps=[TransferStep(params.table_id, src, "executor-0", n)])

    _POD_MOVE_SYMBOLS.update(SlowStartWideDeepTrainer=slow_start(WideDeepTrainer),
                             SlowStartFMTrainer=slow_start(FMTrainer),
                             MoveOncePodOptimizer=MoveOncePodOptimizer,
                             ElasticLagWideDeep=slow_start(WideDeepTrainer, True))
    return _POD_MOVE_SYMBOLS


def __getattr__(name: str):
    """``chip_smoke:SlowStartWideDeepTrainer`` and the others of
    :func:`_pod_move_symbols`, and phase 3pd's ``chip_smoke:Kept<class>``
    trainers (:func:`pod_trainers`), as the pod's processes resolve them."""
    if name in ("SlowStartWideDeepTrainer", "SlowStartFMTrainer", "MoveOncePodOptimizer",
                "ElasticLagWideDeep"):
        return _pod_move_symbols()[name]
    if name.startswith("Kept"):
        return getattr(pod_trainers(), name)
    if name == "HaCountedWideDeep":
        return ha_counted_trainer()
    raise AttributeError(name)


def pod_move_config(kind: str, job_id: str, epochs: int, lag: float = 0.0):
    """bench-widedeep (``kind`` "wd", mxu route) or bench-fm-hash ("fm") over
    ``epochs``, one worker; with ``lag``, on the slow-start trainer."""
    cfg = (pod_wd_config(job_id, epochs) if kind == "wd"
           else hash_job("fm", epochs).replace(job_id=job_id))
    if lag:
        name = {"wd": "SlowStartWideDeepTrainer", "fm": "SlowStartFMTrainer"}[kind]
        cfg = cfg.replace(trainer=f"chip_smoke:{name}", params=cfg.params.replace(
            app_params={**cfg.params.app_params, "start_lag_sec": lag}))
    return cfg


def pod_move_one_slot_refs():
    """Phase 3z's one-slot runs: bench-widedeep (mxu) over MOVE_EPOCHS and
    OPT_EPOCHS, bench-fm-hash over MOVE_EPOCHS; batch losses."""
    from harmony_tpu_torch.jobserver.server import JobServer
    from harmony_tpu_torch.parallel.mesh import DevicePool

    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    try:
        wd = {e: run_cli(SLICE_ARGS + ["--epochs", str(e), "--num-executors", "1"])["batch_losses"]
              for e in (MOVE_EPOCHS, OPT_EPOCHS)}
    finally:
        os.environ.pop("HARMONY_PUSH_VIA")
    server = JobServer(1, device_pool=DevicePool([torch.device("cuda")]))
    server.start()
    try:
        (fm,) = server.submit(hash_job("fm", MOVE_EPOCHS)).result(timeout=600)["workers"].values()
    finally:
        server.shutdown()
    return {"wd": wd[MOVE_EPOCHS], "wd_opt": wd[OPT_EPOCHS], "fm": fm["batch_losses"]}


def cli_pod_reshard(port: int, job: str, src: str, dst: str, blocks: int, epoch: int):
    """``python -m harmony_tpu_torch.cli pod-reshard`` in this process: its
    exit code and the reply it printed."""
    from harmony_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["pod-reshard", "--port", str(port), "--job", job, "--src", src,
                       "--dst", dst, "--blocks", str(blocks), "--epoch", str(epoch)])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


# Phase 3z (c): bench-widedeep's table (256 blocks of 399 x 17 f32) drains
# onto process 0's executor and grows back over every process, over tcp and
# then over files, in fresh processes joined as the pod's are. Each process
# prints its shards' SHA-256 against the one-slot table's blocks, the move's
# stats, its host seconds and its copies' device ms.
POD_MOVE_SCRIPT = r"""
import faulthandler, hashlib, json, os, sys, time, torch
faulthandler.dump_traceback_later(240, exit=True)   # a wedged process shows where
from harmony_tpu_torch.apps.widedeep import WideDeepTrainer
from harmony_tpu_torch.parallel import multihost
from harmony_tpu_torch.parallel.mesh import DevicePool, is_local
from harmony_tpu_torch.runtime.master import ETMaster
from harmony_tpu_torch.table import blockmove
from harmony_tpu_torch.table.table import DenseTable, ShardedArray, TableSpec
store, n, p, own = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4] == "1"
multihost.initialize_distributed(store, n, p, devices=["cuda" if own else "cuda:0"])
dev = multihost.local_devices()[0]
cfg = WideDeepTrainer(vocab_size=100000, num_slots=16, emb_dim=16, hidden=128,
                      step_size=0.1).model_table_config()
values = torch.randn((cfg.capacity, 17), generator=torch.Generator().manual_seed(7))
one = DenseTable(TableSpec(cfg), dev)
one.write_all(values)
ref = one.array


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def shards(table):
    st = table.array
    if isinstance(st, ShardedArray):
        return st.shards
    (s,) = table.mesh.slots
    return {s: st} if is_local(s) else {}


def held(table):
    # blocks this process holds, and whether every shard is the one-slot bytes
    blocks, exact = [], True
    for s, t in shards(table).items():
        r = table.sharding.slot_blocks(s)
        exact = exact and digest(t) == digest(ref[r.start:r.stop])
        blocks += list(r)
    return {"blocks": len(blocks), "exact": exact}


def move(handle, owners):
    torch.cuda.synchronize(dev)
    multihost.sync_global_devices()
    t0 = time.perf_counter()
    handle.rebalance(owners)
    host_ms = 1e3 * (time.perf_counter() - t0)
    st = dict(blockmove.last_move_stats)
    st.update(blockmove.last_move_device_ms(), host_ms=host_ms)
    st["held"] = held(handle.table)
    return st


master = ETMaster(DevicePool(multihost.global_slots()))
execs = [e.id for e in master.add_executors(n)]
out = {"process": p, "backend": multihost.backend(), "num_blocks": cfg.num_blocks,
       "table_bytes": ref.numel() * 4}
for transport in ("tcp", "file"):
    os.environ["HARMONY_POD_BLOCKMOVE"] = transport
    table = master.create_table(cfg.replace(table_id=f"bench-widedeep-{transport}"), execs)
    table.write_all(values)
    handle = master.table_handle(table.spec.table_id)
    print(f"process {p}: {transport} table made", flush=True)
    before = held(table)
    drain = move(handle, execs[:1])
    print(f"process {p}: {transport} drained", flush=True)
    out[transport] = {"before": before, "drain": drain, "grow": move(handle, execs)}
    print(f"process {p}: {transport} grown", flush=True)
    master.drop_table(table.spec.table_id)
multihost.sync_global_devices()
multihost.shutdown_distributed()
print("RESULT " + json.dumps(out), flush=True)
"""


def pod_script(script: str, n: int, own: bool, what: str, *args: str):
    """``script`` in n fresh processes joined as a pod's are (one card each
    when ``own``, else all on cuda:0), each given the store, n, its id, own
    and ``args``; their ``RESULT`` lines. A failure prints every process's
    output."""
    store = free_port()
    procs = []
    try:
        for p in range(n):
            env = dict(os.environ, OMP_NUM_THREADS="4", HARMONY_POD_UNIT_TIMEOUT="120")
            if own:
                env["CUDA_VISIBLE_DEVICES"] = str(p)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, f"127.0.0.1:{store}", str(n), str(p),
                 "1" if own else "0", *args],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        texts = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            texts.append(out)
        outs = []
        for p, (proc, out) in enumerate(zip(procs, texts)):
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            check(proc.returncode == 0 and lines, f"phase {what}: a process failed:\n" + "\n".join(
                f"--- process {q}\n{t[-4000:]}" for q, t in enumerate(texts)))
            outs.append(json.loads(lines[-1][len("RESULT "):]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def pod_moves_alone(n: int, own: bool):
    """Phase 3z (c): POD_MOVE_SCRIPT in n fresh processes; their results."""
    return pod_script(POD_MOVE_SCRIPT, n, own, "3z (c)")


def check_table_moves(rows, n: int):
    """Phase 3z (c)'s checks: every shard byte-exact after each move; the
    drain leaves every block on process 0 and the grow 1/n of them on each;
    each process's wire bytes are its moved blocks times block_nbytes, and
    none sends or receives the whole table. Returns (e)'s cost by move."""
    nb = rows[0]["num_blocks"]
    cost = {}
    for transport in ("tcp", "file"):
        for move in ("drain", "grow"):
            for r in rows:
                st = r[transport][move]
                p, bnb = r["process"], st["block_nbytes"]
                held = st["held"]
                check(held["exact"], f"phase 3z (c) {transport} {move}: process {p}'s shards "
                                     "are not the one-slot table's bytes")
                want_held = (nb if p == 0 else 0) if move == "drain" else nb // n
                check(held["blocks"] == want_held,
                      f"phase 3z (c) {transport} {move}: process {p} holds {held['blocks']} "
                      f"blocks, not {want_held}")
                # drain: each follower sends its nb/n; process 0 receives the
                # rest. grow: the reverse
                share = nb // n
                sent = (0 if p == 0 else share) if move == "drain" else ((nb - share) if p == 0 else 0)
                recv = ((nb - share) if p == 0 else 0) if move == "drain" else (0 if p == 0 else share)
                check(st["transport"] == transport and st["blocks_sent"] == sent
                      and st["blocks_received"] == recv
                      and st["bytes_sent"] == sent * bnb and st["bytes_received"] == recv * bnb
                      and st["bytes_sent"] + st["bytes_received"] == (sent + recv) * bnb
                      and max(st["bytes_sent"], st["bytes_received"]) < r["table_bytes"],
                      f"phase 3z (c) {transport} {move}: process {p}'s stats {st} are not the "
                      f"plan's ({sent} blocks out, {recv} in)")
            cost[f"{transport}_{move}"] = [{
                "process": r["process"],
                "host_ms": r[transport][move]["host_ms"],
                "transport_s": r[transport][move]["exchange_s"],
                "copy_off_host_s": r[transport][move]["copy_off_s"],
                "copy_on_host_s": r[transport][move]["copy_on_s"],
                "copy_off_device_ms": r[transport][move]["copy_off_ms"],
                "copy_on_device_ms": r[transport][move]["copy_on_ms"],
                "bytes_sent": r[transport][move]["bytes_sent"],
                "bytes_received": r[transport][move]["bytes_received"],
                "legs": [{**leg, "mb_per_s": leg["bytes"] / 1e6 / leg["seconds"]}
                         for leg in r[transport][move]["legs"]],
                "transport_retries": r[transport][move]["transport_retries"]} for r in rows]
    return cost


def exchange_by_process(before, after, nb: int, per: int):
    """Blocks each process receives when a table's owners go from ``before``
    to ``after`` (executor indices in mesh order, ``per`` a process): the
    blocks its new slots hold that its old ones did not, under the even
    layout (contiguous runs when the blocks divide over the owners, else
    every owner holds every block)."""
    def held(owners):
        m, out = len(owners), {}
        for i, e in enumerate(owners):
            blocks = range(i * nb // m, (i + 1) * nb // m) if nb % m == 0 else range(nb)
            out.setdefault(e // per, set()).update(blocks)
        return out

    old, new = held(before), held(after)
    return {p: len(new.get(p, set()) - old.get(p, set())) for p in sorted(set(old) | set(new))}


def check_plan_moves(rows, layouts, nb: int, what: str):
    """Each process's side of each exchange (its ``plan_moves``, one for
    each plan that changed the owners) against ``exchange_by_process`` of
    ``layouts`` [(owners before, owners after), ...]: blocks received, the
    wire bytes as blocks times ``block_nbytes``, and the sends summing to
    the receives over the processes. The first move must cross processes."""
    for row in rows:
        check(len(row["plan_moves"]) == len(layouts),
              f"phase 3z {what}: process {row['process']} moved {len(row['plan_moves'])} "
              f"times, not {len(layouts)}: {row['plan_moves']}")
    for k, (before, after) in enumerate(layouts):
        want = exchange_by_process(before, after, nb, MOVE_SLOTS)
        stats = [row["plan_moves"][k] for row in rows]
        for p, st in enumerate(stats):
            bnb = st["block_nbytes"]
            check(st["transport"] == "tcp" and st["blocks_received"] == want.get(p, 0)
                  and st["bytes_received"] == want.get(p, 0) * bnb
                  and st["bytes_sent"] == st["blocks_sent"] * bnb,
                  f"phase 3z {what}: move {k} ({len(before)} -> {len(after)} owners): process "
                  f"{p}'s side {st} is not the layouts' ({want.get(p, 0)} blocks in)")
        check(sum(st["blocks_sent"] for st in stats) == sum(want.values())
              == stats[0]["total_moves"],
              f"phase 3z {what}: move {k}: {[st['blocks_sent'] for st in stats]} blocks sent "
              f"for {want} received")
    check(sum(row["plan_moves"][0]["bytes_received"] for row in rows) > 0,
          f"phase 3z {what}: the first move crossed no process")


def run_pod_moves(warm_step_ms=None):
    """Phase 3z: tables that move between the pod's processes (see the
    module doc). ``warm_step_ms``: phase 3y's warm bench-widedeep step ms by
    process, printed beside (e)'s, or None when 3z runs alone."""
    from harmony_tpu_torch.apps.widedeep import FMTrainer, WideDeepTrainer
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    own = cards >= 4
    n = 4 if own else 2
    execs = n * MOVE_SLOTS
    refs = pod_move_one_slot_refs()
    torch.cuda.empty_cache()
    out = {"processes": n, "slots_a_process": MOVE_SLOTS, "cards": cards if own else 1,
           "plan_epochs": list(MOVE_PLAN_EPOCHS)}
    wd_blocks = WideDeepTrainer(vocab_size=100_000, num_slots=16, emb_dim=16,
                                hidden=128).model_table_config().num_blocks
    fm_blocks = FMTrainer(**FM_HASH_APP).model_table_config().num_blocks
    launches = {name: 0 for name in ("gather_rows", "segment_sum_rows", "weighted_histogram",
                                     "flash_forward", "flash_backward_dkv", "flash_backward_dq")}
    calls = 1 + WorkerTasklet.PROBE_SAMPLES
    every = list(range(execs))
    # the owners around (a)'s three applied plans: the last executor drains,
    # grows back and drains again (the fourth plan is skipped)
    layouts = [(every, every[:-1]), (every[:-1], every), (every, every[:-1])]
    pod = ChipPod(n, own, phase="3z", slots=MOVE_SLOTS)
    try:
        out["ready"] = pod.ready_line
        out["backend"] = pod.backend.split(": ", 1)[-1]
        print(f"phase 3z: {out['ready']}; {out['backend']}", flush=True)
        last, second = f"executor-{execs - 1}", f"executor-{execs - 2}"

        def each(reps, what):
            check(sorted(reps) == [str(p) for p in range(n)] and all(r["ok"] for r in reps.values()),
                  f"phase 3z {what}: reports {json.dumps(reps)[:3000]}")
            return [reps[str(p)] for p in range(n)]

        def job_checks(reps, what, want, kind, epochs, moved_run):
            """Every process's batch losses ``want`` and its launches of K1
            and K3 (wd) or K1 and K2 (fm): once a local shard a step plus the
            probe's, so MOVE_SLOTS times that on the unmoved layout, and
            between once and MOVE_SLOTS times that while the owners change
            (a process then holds one or MOVE_SLOTS shards or replicas)."""
            rows = []
            for p, rep in enumerate(each(reps, what)):
                (w,) = rep["workers"].values()
                check(w["batch_losses"] == want,
                      f"phase 3z {what}: process {p}'s losses are not the one-slot run's")
                k = w["probes"] * calls
                steps = epochs * BATCHES
                fold = "weighted_histogram" if kind == "wd" else "segment_sum_rows"
                one = {"gather_rows": steps + 2 * k, fold: steps + k}
                got = {name: rep["launches"][name] for name in
                       ("gather_rows", "segment_sum_rows", "weighted_histogram")}
                if moved_run:
                    ok = all(one[name] <= got[name] <= MOVE_SLOTS * one[name] for name in one)
                    expect = f"between {one} and {MOVE_SLOTS} times it"
                else:
                    ok = all(got[name] == MOVE_SLOTS * one[name] for name in one)
                    expect = f"{MOVE_SLOTS} times {one}"
                ok = ok and all(v == 0 for name, v in got.items() if name not in one)
                check(ok, f"phase 3z {what}: process {p} launched {got}, expected {expect}")
                for name, v in rep["launches"].items():
                    launches[name] += v
                rows.append({"process": p, "launches": got, "epoch_seconds": w["epoch_seconds"],
                             "applied_plans": rep.get("applied_plans", []),
                             "plan_moves": rep.get("plan_moves", []),
                             "combine": rep["combine"]})
            return rows

        def moved(kind, blocks):
            """(a) or (b): the unmoved run, then the moved one with tier-1's
            four POD_RESHARDs by ``cli pod-reshard``."""
            what = "(a)" if kind == "wd" else "(b)"
            want = refs[kind]
            reps, _ = pod.run(pod_move_config(kind, f"pod-{kind}-unmoved", MOVE_EPOCHS))
            unmoved = job_checks(reps[f"pod-{kind}-unmoved"], f"{what} unmoved", want, kind,
                                 MOVE_EPOCHS, False)
            jid = f"pod-{kind}-moved"
            e1, e2, e3, e4 = MOVE_PLAN_EPOCHS
            plans = [(last, "executor-0", 1 << 20, e1), ("executor-0", last, 1, e2),
                     (last, "executor-0", 1 << 20, e3), (second, "executor-0", 1 << 20, e4)]
            replies = []

            def send_plans():
                deadline = time.monotonic() + 60
                for i, plan in enumerate(plans):
                    while True:
                        rc, reply = cli_pod_reshard(pod.port, jid, *plan)
                        if rc == 0 or i or "unknown" not in reply.get("error", ""):
                            break
                        check(time.monotonic() < deadline, f"phase 3z {what}: {jid} never dispatched")
                        time.sleep(0.02)
                    check(rc == 0 and reply.get("ok"), f"phase 3z {what}: pod-reshard {plan}: {reply}")
                    replies.append(reply)

            reps, _ = pod.run(pod_move_config(kind, jid, MOVE_EPOCHS, MOVE_START_LAG_S),
                              between=send_plans)
            rows = job_checks(reps[jid], what, want, kind, MOVE_EPOCHS, True)
            # the even split gives the last executor blocks // execs blocks
            expect = [{"epoch": e1, "src": last, "dst": "executor-0",
                       "moved": blocks // execs, "owners_after": execs - 1},
                      {"epoch": e2, "src": "executor-0", "dst": last,
                       "moved": 1, "owners_after": execs},
                      {"epoch": e3, "src": last, "dst": "executor-0",
                       "moved": 1, "owners_after": execs - 1},
                      {"epoch": e4, "src": second, "dst": "executor-0",
                       "moved": 0, "owners_after": execs - 1,
                       "skipped": "process-set change mid-training"}]
            for row in rows:
                check(row["applied_plans"] == expect,
                      f"phase 3z {what}: process {row['process']} applied {row['applied_plans']}, "
                      f"expected {expect}")
            check_plan_moves(rows, layouts, blocks, what)
            for u, m in zip(unmoved, rows):
                check(u["epoch_seconds"] and m["epoch_seconds"], f"phase 3z {what}: no epochs")

            def step_ms(row, lo, hi):
                secs = row["epoch_seconds"][lo:hi]
                return 1e3 * sum(secs) / len(secs) / BATCHES

            return {"applied_plans": expect, "replies": replies,
                    "by_process": [{"process": r["process"], "launches": r["launches"],
                                    "step_ms_before_first_plan": step_ms(r, 1, e1),
                                    "step_ms_after_first_plan": step_ms(r, e1 + 1, MOVE_EPOCHS),
                                    "unmoved_step_ms": step_ms(u, 1, MOVE_EPOCHS),
                                    "plan_moves": r["plan_moves"],
                                    "combine": r["combine"]} for u, r in zip(unmoved, rows)]}

        # (a) bench-widedeep and (b) bench-fm-hash, moved mid-training
        out["widedeep"] = moved("wd", wd_blocks)
        print(f"phase 3z (a): bench-widedeep's plans applied alike, blocks across processes, "
              f"the one-slot bits: {json.dumps(out['widedeep'])}", flush=True)
        out["fm_hash"] = moved("fm", fm_blocks)
        print(f"phase 3z (b): bench-fm-hash's plans applied alike, blocks across processes, "
              f"the one-slot bits: {json.dumps(out['fm_hash'])}", flush=True)

        # (d) the optimizer loop through the pod's plan channel
        reps, _ = pod.run(pod_move_config("wd", "pod-wd-opt-unmoved", OPT_EPOCHS))
        job_checks(reps["pod-wd-opt-unmoved"], "(d) unmoved", refs["wd_opt"], "wd", OPT_EPOCHS,
                   False)
        opt = pod_move_config("wd", "pod-wd-opt", OPT_EPOCHS).replace(
            optimizer="chip_smoke:MoveOncePodOptimizer", optimizer_period=0.2)
        reps, _ = pod.run(opt)
        rows = job_checks(reps["pod-wd-opt"], "(d)", refs["wd_opt"], "wd", OPT_EPOCHS, True)
        result = pod.sender.wait_result("pod-wd-opt", timeout=60)
        applied = result.get("applied_plans", [])
        check(result.get("reconfigs") == 1 and "optimizer_errors" not in result
              and len(applied) == 1 and applied[0]["moved"] == wd_blocks // execs
              and applied[0]["owners_after"] == execs - 1,
              f"phase 3z (d): reconfigs {result.get('reconfigs')}, plans {applied}, "
              f"errors {result.get('optimizer_errors')}")
        check(all(r["applied_plans"] == applied for r in rows),
              f"phase 3z (d): the processes applied {[r['applied_plans'] for r in rows]}")
        check_plan_moves(rows, layouts[:1], wd_blocks, "(d)")
        out["optimizer"] = {"reconfigs": result["reconfigs"], "applied_plans": applied,
                            "plan_moves": [r["plan_moves"] for r in rows]}
        print(f"phase 3z (d): the optimizer's plan went through the plan channel and moved "
              f"blocks across processes: {json.dumps(out['optimizer'])}", flush=True)
    finally:
        pod.close()

    # (c) table-level moves outside training, over tcp and files, a slot a
    # process (four processes on four cards)
    rows = pod_moves_alone(n, own)
    cost = check_table_moves(rows, n)
    print(f"phase 3z (c): bench-widedeep's table drained onto process 0 and grew back, "
          f"byte-exact over tcp and files", flush=True)
    # (e) a move's cost: (c)'s moves, (a)'s moves in training, and (a)'s
    # step around its first plan
    out["move_cost"] = {
        "table_moves": cost,
        "training_moves_widedeep": [
            [{k: m[k] for k in ("epoch", "owners_after", "blocks_sent", "blocks_received",
                                "bytes_sent", "bytes_received", "seconds")}
             for m in r["plan_moves"]] for r in out["widedeep"]["by_process"]],
        "phase_3y_warm_step_ms": warm_step_ms}
    print(f"phase 3z (e): a move's cost: {json.dumps(out['move_cost'])}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = dict(launches)
    check(all(launches[k] > 0 for k in ("gather_rows", "segment_sum_rows", "weighted_histogram")),
          f"phase 3z: launches {launches}: a kernel never ran on the moved pod jobs")
    return launches, out


# -- phase 3pc: checkpoint chains on the pod ----------------------------------

# (a) bench-widedeep chains PC_WD_EPOCHS epochs and bench-fm-hash PC_FM_EPOCHS,
# an entry every epoch; (b) the resume splits bench-widedeep's run after
# PC_RESUME_AT epochs; (d) the evaluated chain runs PC_EVAL_EPOCHS epochs
# with PC_EVAL_WORKERS workers. Its evaluation on the pod is held to the
# one-slot evaluation of the same entries: the bits, else PC_EVAL_ATOL (the
# tier-1 limit against the reference's evaluator).
PC_WD_EPOCHS = 4
PC_FM_EPOCHS = 2
PC_RESUME_AT = 2
PC_EVAL_EPOCHS = 2
PC_EVAL_WORKERS = 2
PC_EVAL_ATOL = 1e-5

# Phase 3pc (c): bench-widedeep's table (256 blocks of 399 x 17 f32, seeded
# values, the same in every process) in fresh processes of a slot each,
# checkpointed by the pod with recovery_retain on, then restore_partial onto
# the same grant and onto the grant rotated by one process: each process's
# stats, its shards against the values (byte-exact), and the seconds.
POD_PARTIAL_SCRIPT = r"""
import json, os, sys, time
import numpy as np, torch
from harmony_tpu_torch.parallel import multihost
store, n, p, own, root = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4] == "1", sys.argv[5]
multihost.initialize_distributed(store, n, p, devices=["cuda" if own else "cuda:0"])
from harmony_tpu_torch.checkpoint.manager import CheckpointManager
from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.parallel.mesh import DevicePool
from harmony_tpu_torch.runtime.master import ETMaster, TableHandle
master = ETMaster(DevicePool(multihost.global_slots()))
ids = [e.id for e in master.add_executors(n)]
cfg = TableConfig(table_id="pc-partial", capacity=102144, value_shape=(17,), num_blocks=256)
values = np.random.default_rng(0).standard_normal((256, 399, 17), dtype=np.float32)
table = master.create_table(cfg, ids)
table.import_blocks({b: values[b] for b in range(256)})
mgr = CheckpointManager(os.path.join(root, "temp"), os.path.join(root, "commit"))
mgr.recovery_retain = True
t0 = time.perf_counter()
cid = mgr.checkpoint(TableHandle(master, table, ids), commit=True)
out = {"process": p, "chkp_id": cid, "checkpoint_s": time.perf_counter() - t0,
       "staged": mgr.last_staged["block_ids"], "staged_bytes": mgr.last_staged["bytes"],
       "block_nbytes": int(values[0].nbytes)}
for name, grant in (("same", ids), ("rotated", ids[1:] + ids[:1])):
    multihost.mesh_barrier(multihost.global_mesh())
    t0 = time.perf_counter()
    h, stats = mgr.restore_partial(master, cid, grant, table_id=f"pc-partial-{name}")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sh, held, exact = h.table.sharding, [], True
    for slot, t in h.table.array.shards.items():
        blocks = sh.slot_blocks(slot)
        held += list(blocks)
        exact = exact and t.cpu().numpy().tobytes() == values[blocks.start:blocks.stop].tobytes()
    out[name] = {"stats": stats, "seconds": secs, "held": sorted(held), "exact": exact}
    h.drop()
multihost.shutdown_distributed()
print("RESULT " + json.dumps(out), flush=True)
"""


def pc_chain_configs():
    """Phase 3pc's jobs by name: bench-widedeep with and without a chain, its
    two resume legs, bench-fm-hash with a chain, and the evaluated
    bench-widedeep chain."""
    def wd(job_id, epochs, **params):
        cfg = pod_wd_config(job_id, epochs)
        return cfg.replace(params=cfg.params.replace(**params))

    resumed = wd("pc-wd-resume", PC_WD_EPOCHS, model_chkp_period=1)
    return {
        "plain": wd("pc-wd-plain", PC_WD_EPOCHS),
        "wd": wd("pc-wd", PC_WD_EPOCHS, model_chkp_period=1),
        "fm": hash_job("fm", PC_FM_EPOCHS, model_chkp_period=1).replace(job_id="pc-fm"),
        "first": wd("pc-wd-resume", PC_RESUME_AT, model_chkp_period=1),
        "resumed": resumed.replace(user={**resumed.user, "resume_from_chain": True}),
        "eval": wd("pc-wd-eval", PC_EVAL_EPOCHS, model_chkp_period=1,
                   offline_model_eval=True).replace(num_workers=PC_EVAL_WORKERS),
    }


def pc_entries(root: str, job_id: str) -> dict:
    """epoch -> {"id", "files" (name -> SHA-256 of its bytes), "checksums",
    "ownership"} of a job's committed chain under ``root`` (a commit a
    crashed process left half done, with no manifest, is no entry)."""
    import hashlib

    commit = os.path.join(root, job_id, "commit")
    out = {}
    for cid in sorted(os.listdir(commit)):
        d = os.path.join(commit, cid)
        if not os.path.isfile(os.path.join(d, "manifest.json")):
            continue
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        files = {}
        for name in sorted(os.listdir(d)):
            if name != "manifest.json":
                with open(os.path.join(d, name), "rb") as f:
                    files[name] = hashlib.sha256(f.read()).hexdigest()
        out[int(manifest["app_meta"]["epoch"])] = {
            "id": cid, "files": files, "checksums": manifest["block_checksums"],
            "ownership": manifest["ownership"]}
    return out


def pc_one_slot_refs(root: str, configs: dict) -> dict:
    """Phase 3pc's one-slot runs on cuda:0 (``HARMONY_PUSH_VIA=mxu``, as the
    pod's processes): bench-widedeep's and bench-fm-hash's chains under
    ``root``, and their batch losses."""
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    server = chain_server(root)
    try:
        out = {}
        for key in ("wd", "fm"):
            res = server.submit(configs[key]).result(timeout=POD_JOB_S)
            (w,) = res["workers"].values()
            out[key] = w["batch_losses"]
        return out
    finally:
        server.shutdown()
        os.environ.pop("HARMONY_PUSH_VIA")


def pc_restored_bits(root: str, job_id: str, chkp_id: str) -> bytes:
    """An entry restored in this process on one slot of the card: its table's
    bytes in key order."""
    from harmony_tpu_torch.checkpoint.manager import CheckpointManager
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    master = ETMaster(DevicePool([torch.device("cuda")]))
    h = CheckpointManager.for_job(root, job_id).restore(
        master, chkp_id, [e.id for e in master.add_executors(1)])
    try:
        return h.table.pull_array().cpu().numpy().tobytes()
    finally:
        h.drop()


def pc_one_slot_eval(copy: str, config, chkp_ids) -> list:
    """The evaluation of a chain's entries (a copy of its files) in this
    process on one slot of the card."""
    from harmony_tpu_torch.checkpoint.manager import CheckpointManager
    from harmony_tpu_torch.dolphin.evaluator import ModelEvaluator, resolve_eval_inputs
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    master = ETMaster(DevicePool([torch.device("cuda")]))
    mgr = CheckpointManager(os.path.join(copy, "temp"), os.path.join(copy, "commit"))
    trainer, batch = resolve_eval_inputs(config)
    return ModelEvaluator(master, mgr).evaluate_checkpoints(
        list(chkp_ids), trainer, batch, [e.id for e in master.add_executors(1)])


def run_pod_chains():
    """Phase 3pc: checkpoint chains on the pod (see the module doc)."""
    import tempfile

    from harmony_tpu_torch.parallel.mesh import Slot, build_mesh
    from harmony_tpu_torch.table.blockmove import block_owners
    from harmony_tpu_torch.table.table import BlockSharding

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    own = cards >= 4
    n = 4 if own else 2
    configs = pc_chain_configs()
    scratch = tempfile.mkdtemp(prefix="harmony-pc-")
    pod_root, one_root = os.path.join(scratch, "pod"), os.path.join(scratch, "one")
    out = {"processes": n, "cards": cards if own else 1}
    launches = {name: 0 for name in ("gather_rows", "segment_sum_rows", "weighted_histogram",
                                     "flash_forward", "flash_backward_dkv", "flash_backward_dq")}
    try:
        refs = pc_one_slot_refs(one_root, configs)
        torch.cuda.empty_cache()
        pod = ChipPod(n, own, phase="3pc", env={"HARMONY_POD_CHKP_ROOT": pod_root})
        try:
            out["ready"] = pod.ready_line
            out["backend"] = pod.backend.split(": ", 1)[-1]
            print(f"phase 3pc: {out['ready']}; {out['backend']}", flush=True)

            def run(key):
                cfg = configs[key]
                reps, _ = pod.run(cfg)
                reps = reps[cfg.job_id]
                check(sorted(reps) == [str(p) for p in range(n)]
                      and all(r["ok"] for r in reps.values()),
                      f"phase 3pc {key}: reports {json.dumps(reps)[:3000]}")
                for rep in reps.values():
                    for name, v in rep["launches"].items():
                        launches[name] += v
                return [reps[str(p)] for p in range(n)]

            def worker(rep):
                (w,) = rep["workers"].values()
                return w

            def step_ms(rep):
                secs = [s for w in rep["workers"].values() for s in w["epoch_seconds"][1:]]
                return 1e3 * statistics.mean(secs) / BATCHES

            # (a) the chains, after an unchained run that loads each process's
            # kernels and libraries (a process's first job is slow throughout);
            # the unchained step is timed again once the chains have run
            run("plain")
            a = {}
            for key in ("wd", "fm"):
                reps = run(key)
                job_id = configs[key].job_id
                for p, rep in enumerate(reps):
                    check(worker(rep)["batch_losses"] == refs[key],
                          f"phase 3pc (a) {job_id}: process {p}'s losses are not the one-slot bits")
                got, want = pc_entries(pod_root, job_id), pc_entries(one_root, job_id)
                check(sorted(got) == sorted(want) == list(range(configs[key].params.num_epochs)),
                      f"phase 3pc (a) {job_id}: entries {sorted(got)} against {sorted(want)}")
                nb = len(want[0]["files"])
                mesh = build_mesh([Slot(i, torch.device("cpu"), i) for i in range(n)], data=1)
                owners = block_owners(BlockSharding(mesh, nb), (nb,))
                rows = []
                for i, epoch in enumerate(sorted(got)):
                    e = got[epoch]
                    check(e["id"].endswith("-pod") and e["files"] == want[epoch]["files"]
                          and e["checksums"] == want[epoch]["checksums"],
                          f"phase 3pc (a) {job_id}: entry {e['id']} is not the one-slot entry "
                          f"of epoch {epoch} byte for byte")
                    staged = [rep["model_chkp_stats"][i] for rep in reps]
                    flat = sorted(b for st in staged for b in st["block_ids"])
                    check(flat == list(range(nb)) and all(
                        st["chkp_id"] == e["id"]
                        and st["block_ids"] == [b for b in range(nb) if owners[b] == p]
                        for p, st in enumerate(staged)),
                        f"phase 3pc (a) {job_id}: the staged blocks are not block_owners'")
                    rows.append({"epoch": epoch, "id": e["id"], "by_process": [{
                        "process": p, "blocks": st["blocks"], "bytes": st["bytes"],
                        "snapshot_ms": 1e3 * st["snapshot_seconds"],
                        "write_ms": 1e3 * st["write_seconds"],
                        "write_mb_per_s": st["bytes"] / 1e6 / st["write_seconds"]}
                        for p, st in enumerate(staged)],
                        "files_sha256": files_digest(e["files"])})
                a[key] = {"blocks": nb, "entries": rows,
                          "step_ms": [step_ms(rep) for rep in reps]}
            plain = run("plain")
            for p, rep in enumerate(plain):
                check(worker(rep)["batch_losses"] == refs["wd"],
                      f"phase 3pc (a): process {p}'s unchained losses differ")
            a["wd"]["step_ms_unchained"] = [step_ms(rep) for rep in plain]
            out["chains"] = a
            print(f"phase 3pc (a): the pod's chains are the one-slot chains byte for byte: "
                  f"{json.dumps(a)}", flush=True)

            # (b) the resume: the uninterrupted run's losses and table
            first, resumed = run("first"), run("resumed")
            for p in range(n):
                check(worker(first[p])["batch_losses"] + worker(resumed[p])["batch_losses"]
                      == refs["wd"], f"phase 3pc (b): process {p}'s resumed losses differ")
            got, whole = pc_entries(pod_root, "pc-wd-resume"), pc_entries(pod_root, "pc-wd")
            last = PC_WD_EPOCHS - 1
            check(got[last]["files"] == whole[last]["files"],
                  "phase 3pc (b): the resumed table is not the uninterrupted one")
            one_slot = pc_entries(one_root, "pc-wd")[last]["id"]
            same = (pc_restored_bits(pod_root, "pc-wd", whole[last]["id"])
                    == pc_restored_bits(one_root, "pc-wd", one_slot))
            check(same, "phase 3pc (b): the pod entry restored on one slot is not the one-slot table")
            out["resume"] = {"at_epoch": PC_RESUME_AT, "ids": [got[e]["id"] for e in sorted(got)],
                             "restored_in_one_process": same}
            print(f"phase 3pc (b): the resume gives the uninterrupted bits: "
                  f"{json.dumps(out['resume'])}", flush=True)

            # (d) the collective deferred evaluation at the pod's shutdown
            ev = run("eval")
            ids = ev[0]["model_chkp_ids"]
            copy = os.path.join(scratch, "eval-copy")
            shutil.copytree(os.path.join(pod_root, "pc-wd-eval"), copy)
            t1 = time.perf_counter()
            closed = pod.shutdown()
            shutdown_s = time.perf_counter() - t1
        finally:
            pod.close()
        evals = closed["eval_results"].get("pc-wd-eval")
        check(isinstance(evals, list) and len(evals) == len(ids) == PC_EVAL_EPOCHS,
              f"phase 3pc (d): eval_results {json.dumps(closed)[:2000]}")
        check(closed["broken"] is None, f"phase 3pc (d): the pod broke: {closed['broken']}")
        alone = pc_one_slot_eval(copy, configs["eval"], ids)
        gap = max(abs(m[k] - r[k]) for m, r in zip(evals, alone) for k in r)
        check(all(m.keys() == r.keys() for m, r in zip(evals, alone)) and gap <= PC_EVAL_ATOL,
              f"phase 3pc (d): the pod's evaluation {evals} against one slot's {alone}")
        out["eval"] = {"workers": PC_EVAL_WORKERS, "entries": len(ids), "pod": evals,
                       "bit_identical_to_one_slot": evals == alone, "max_abs_gap": gap,
                       "shutdown_s": shutdown_s}
        print(f"phase 3pc (d): the collective evaluation: {json.dumps(out['eval'])}", flush=True)

        # (c) restore_partial in fresh processes
        rows = pod_script(POD_PARTIAL_SCRIPT, n, own, "3pc (c)", os.path.join(scratch, "partial"))
        per = 256 // n
        c = []
        for r in rows:
            p, bnb = r["process"], r["block_nbytes"]
            check(r["staged"] == list(range(p * per, (p + 1) * per)),
                  f"phase 3pc (c): process {p} staged {r['staged'][:4]}...")
            same, rot = r["same"], r["rotated"]
            check(same["exact"] and rot["exact"], f"phase 3pc (c): process {p}'s shards differ")
            check(same["stats"] == {"partial": 1, "blocks_total": 256, "blocks_needed": per,
                                    "blocks_local": per, "blocks_read": 0, "bytes_read": 0}
                  and same["held"] == r["staged"],
                  f"phase 3pc (c): process {p} on the same grant: {same['stats']}")
            q = (p - 1) % n
            check(rot["held"] == list(range(q * per, (q + 1) * per))
                  and rot["stats"] == {"partial": 1, "blocks_total": 256, "blocks_needed": per,
                                       "blocks_local": 0, "blocks_read": per,
                                       "bytes_read": per * bnb},
                  f"phase 3pc (c): process {p} on the rotated grant: {rot['stats']}")
            c.append({"process": p, "checkpoint_s": r["checkpoint_s"],
                      "same_grant": {**same["stats"], "seconds": same["seconds"]},
                      "rotated_grant": {**rot["stats"], "seconds": rot["seconds"],
                                        "read_mb_per_s": rot["stats"]["bytes_read"] / 1e6
                                        / rot["seconds"]}})
        out["restore_partial"] = c
        print(f"phase 3pc (c): restore_partial reads only what each process lacks: "
              f"{json.dumps(c)}", flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    out["launches"] = {k: v for k, v in launches.items() if v}
    check(all(launches[k] > 0 for k in ("gather_rows", "segment_sum_rows", "weighted_histogram")),
          f"phase 3pc: launches {launches}: a kernel never ran on the pod")
    out["seconds"] = time.perf_counter() - t0
    return launches, out


# -- phase 3el: elastic recovery on the pod -----------------------------------

# The only settings 3el changes: the pod's beacon every EL_HB_PERIOD s and a
# follower confined after EL_HB_TIMEOUT s of silence; the jobs' epochs.
EL_HB_TIMEOUT = "3"
EL_HB_PERIOD = "0.5"
# (a) the victim trains EL_KILL_EPOCHS epochs; its process is crashed (exit
# code 86) at its first step of epoch EL_CRASH_EPOCH, after at least two
# committed chain entries; it waits EL_START_LAG s before its first epoch
# (not in a recovery attempt), the time the fillers on the other processes
# take to finish, so the shrink finds the survivor free
EL_KILL_EPOCHS = 6
EL_CRASH_EPOCH = 3
EL_START_LAG = 4.0
# (b) a warm-up job of EL_WARM_EPOCHS over the same processes first (a
# process's first job is slow) gives the split epoch's cadence; then the last
# process's beacon is mute from its EL_MUTE_AFTER-th beat in its second job
# until EL_MUTE_TAIL_S after the shrunk attempt has begun (el_end_mute); the
# victim's epochs (el_split_plan) cover the shrink fence, the shrunk attempt
# until the beats resume, the re-grow fence's lead and EL_TAIL_EPOCHS, at the
# cadences measured (the split one by the warm-up, the shrunk one in (a))
# divided by EL_PACE_MARGIN; the shrunk one no faster than EL_SHRUNK_FLOOR
# times the split one so divided ((b)'s shrunk attempt has run 1.5-1.6 s an
# epoch on one card, an NVIDIA H100 80GB HBM3 at 700 W, 4-5 times (a)'s, and
# the epochs planned past that ran after the re-grow: 15 and 18 where
# EL_TAIL_EPOCHS were planned)
EL_MUTE_AFTER = 4
EL_MUTE_COUNT = 10 ** 6
EL_MUTE_TAIL_S = 1.0
EL_WARM_EPOCHS = 4
EL_TAIL_EPOCHS = 2
EL_PACE_MARGIN = 1.5
EL_SHRUNK_FLOOR = 0.5
# bench-widedeep's table: 256 blocks of 399 rows x 17 f32
WD_BLOCKS = 256
WD_BLOCK_BYTES = 399 * 17 * 4


def el_victim(job_id: str, epochs: int, lag: float = 0.0):
    """bench-widedeep with an entry every epoch and ``user.elastic_shrink``."""
    cfg = pod_wd_config(job_id, epochs)
    params = cfg.params.replace(model_chkp_period=1)
    if lag:
        params = params.replace(app_params={**params.app_params, "start_lag_sec": lag})
        cfg = cfg.replace(trainer="chip_smoke:ElasticLagWideDeep")
    return cfg.replace(params=params, user={**cfg.user, "elastic_shrink": True})


def el_filler(job_id: str):
    """A short job: the ``mlr`` preset, one epoch of two batches."""
    from harmony_tpu_torch import cli

    return cli.build_config("mlr", cli.build_parser().parse_args(
        ["run", "mlr", "--epochs", "1", "--batches", "2", "--workers", "1",
         "--job-id", job_id]))


def el_one_slot(root: str, job_id: str, epochs: int):
    """The uninterrupted run on one slot of the card (``HARMONY_PUSH_VIA=mxu``,
    as the pod's processes), with a chain entry every epoch as the victims
    and 3ha's job write them: its batch losses, its last epoch's chain
    entry, and its epoch seconds."""
    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    server = chain_server(root)
    try:
        cfg = pod_wd_config(job_id, epochs)
        cfg = cfg.replace(params=cfg.params.replace(model_chkp_period=1))
        (w,) = server.submit(cfg).result(timeout=POD_JOB_S)["workers"].values()
    finally:
        server.shutdown()
        os.environ.pop("HARMONY_PUSH_VIA")
    return (w["batch_losses"], pc_entries(root, job_id)[epochs - 1]["files"],
            w["epoch_seconds"])


def el_pod_env(root: str, rule) -> dict:
    from harmony_tpu_torch import faults

    return {"HARMONY_POD_CHKP_ROOT": root, "HARMONY_POD_HB_TIMEOUT": EL_HB_TIMEOUT,
            "HARMONY_POD_HB_PERIOD": EL_HB_PERIOD,
            faults.ENV_VAR: faults.FaultPlan([rule]).to_json()}


def el_wait(pod, job_id: str, timeout: float = POD_JOB_S):
    try:
        return pod.sender.wait_result(job_id, timeout=timeout, poll=1.0)
    except Exception as e:  # noqa: BLE001 - the phase fails
        fail(f"phase 3el: {job_id} failed on the pod: {e}\n"
             + "\n".join(pod.log(p)[-3000:] for p in range(len(pod.procs))))


def el_attempts(reports: dict, job_id: str, attempts: int) -> list:
    """Each attempt's reports by process (``job``, ``job@a1``, ...)."""
    from harmony_tpu_torch.jobserver.elastic import attempt_key

    return [reports.get(attempt_key(job_id, a), {}) for a in range(attempts)]


def el_step_ms(rep: dict):
    """A report's mean step ms past its first epoch, or None."""
    secs = [s for w in rep.get("workers", {}).values() for s in w["epoch_seconds"][1:]]
    return 1e3 * statistics.mean(secs) / BATCHES if secs else None


def el_event(events: list, kind: str, job_id=None) -> dict:
    found = [e for e in events if e["kind"] == kind and (job_id is None
                                                          or e.get("job_id") == job_id)]
    check(found, f"phase 3el: no {kind} event in {json.dumps(events)[:3000]}")
    return found[0]


def el_restore_clock(rst: dict) -> dict:
    return {"blocks_local": rst["blocks_local"], "blocks_read": rst["blocks_read"],
            "bytes_read": rst["bytes_read"], "restore_partial_ms": 1e3 * rst["seconds"],
            "read_mb_per_s": (rst["bytes_read"] / 1e6 / rst["seconds"]
                              if rst["bytes_read"] else None)}


def el_add_launches(launches: dict, attempts: list) -> None:
    for reps in attempts:
        for rep in reps.values():
            for name, v in rep.get("launches", {}).items():
                launches[name] += v


def el_kill(n: int, own: bool, root: str, one: tuple, launches: dict) -> dict:
    """Phase 3el (a): the victim wholly on the last process (fillers take the
    others under ``pod_carve:1``), which a ``worker.step`` crash rule kills;
    the same submission completes on a survivor."""
    from harmony_tpu_torch import faults

    job, victim = "el-kill", n - 1
    rule = faults.FaultRule("worker.step", match={"job": job, "proc": victim},
                            after=EL_CRASH_EPOCH * BATCHES, count=1, action="crash",
                            exit_code=86)
    pod = ChipPod(n, own, phase="3el", scheduler="pod_carve:1", env=el_pod_env(root, rule))
    exited = {}
    try:
        print(f"phase 3el (a): {pod.ready_line}; {pod.backend.split(': ', 1)[-1]}", flush=True)

        def watch():
            while pod.procs[victim].poll() is None:
                time.sleep(0.005)
            exited["wall"] = time.time()

        threading.Thread(target=watch, daemon=True).start()
        for c in [el_filler(f"el-filler-{p}") for p in range(n - 1)] + [
                el_victim(job, EL_KILL_EPOCHS, EL_START_LAG)]:
            reply = pod.sender.send_job_submit_command(c)
            check(reply.get("ok"), f"phase 3el (a): submit {c.job_id}: {reply}")
        for p in range(n - 1):
            el_wait(pod, f"el-filler-{p}")
        res = el_wait(pod, job)
        rc = pod.procs[victim].wait(timeout=60)
        status = pod.sender.send_status_command()
        closed = pod.shutdown(dead=(victim,))
    finally:
        pod.close()
    check(rc == 86, f"phase 3el (a): the victim's process exited {rc}, not 86")
    meta, rst = res.get("elastic", {}), res.get("elastic_restore", {})
    check(closed["auto_resumed"] == [] and meta.get("attempts") == 2
          and [e["kind"] for e in meta.get("events", [])] == ["elastic_shrink"],
          f"phase 3el (a): {json.dumps(meta)[:2000]}, auto_resumed {closed['auto_resumed']}")
    survivor = meta["events"][0]["procs"]
    check(len(survivor) == 1 and survivor[0] != victim, f"phase 3el (a): survivor {survivor}")
    check(rst.get("partial") == 1 and rst["blocks_local"] == 0
          and rst["blocks_read"] == rst["blocks_needed"] == rst["lost_block_count"] == WD_BLOCKS
          and rst["bytes_read"] == WD_BLOCKS * WD_BLOCK_BYTES,
          f"phase 3el (a): restore {json.dumps(rst)}")
    (w,) = res["workers"].values()
    start = w["starting_epoch"]
    check(start == rst["resumed_epoch"] >= 2 and w["epochs_run"] == EL_KILL_EPOCHS - start,
          f"phase 3el (a): the final attempt ran epochs {start}+{w['epochs_run']}")
    losses, files, _ = one
    check(w["batch_losses"] == losses[BATCHES * start:EL_KILL_EPOCHS * BATCHES],
          "phase 3el (a): the resumed losses are not the uninterrupted run's bits")
    check(pc_entries(root, job)[EL_KILL_EPOCHS - 1]["files"] == files,
          "phase 3el (a): the final table is not the uninterrupted run's")
    attempts = el_attempts(status["pod"]["reports"], job, 2)
    el_add_launches(launches, attempts)
    events = closed["elastic_events"]
    death = el_event(events, "follower_death")
    shrink = el_event(events, "elastic_shrink", job)
    (a1,) = attempts[1].values()
    out = {"victim_process": victim, "survivor_process": survivor[0], "exit_code": rc,
           "shrunk_epoch_s": a1["workers"][f"{job}/w0"]["train_seconds"] / w["epochs_run"],
           "resumed_epoch": start, "restore": el_restore_clock(rst),
           "detection": {"by": "the reader's EOF",
                         "s_after_exit": death["ts"] - exited["wall"]},
           "planning_s": shrink["planning_s"],
           "exit_to_first_step_s": a1["train_wall"] - exited["wall"],
           "detection_to_first_step_s": a1["train_wall"] - death["ts"],
           "step_ms_before": None, "step_ms_after": el_step_ms(a1),
           "losses_bit_identical": True, "final_table_bit_identical": True}
    print(f"phase 3el (a): kill, then shrink: the same submission finished on process "
          f"{survivor[0]}: {json.dumps(out)} (the killed process's report, and its step "
          f"ms, died with it)", flush=True)
    return out


def el_split_plan(split_epoch_s: float, shrunk_epoch_s: float) -> dict:
    """The victim's epochs in (b), at the fast end of the measured cadences:
    the shrink fence (the confinement, then its lead), the shrunk attempt
    until its re-grow fence is scheduled (the beats resume EL_MUTE_TAIL_S
    after it begins; a beat and a monitor period later the follower is
    rehabilitated), that fence's lead, and EL_TAIL_EPOCHS."""
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet

    period, hb = float(EL_HB_PERIOD), float(EL_HB_TIMEOUT)
    lead = WorkerTasklet.EPOCH_WINDOW + 2
    fast = split_epoch_s / EL_PACE_MARGIN
    shrunk = max(min(shrunk_epoch_s, split_epoch_s) / EL_PACE_MARGIN, EL_SHRUNK_FLOOR * fast,
                 0.05)
    confined = EL_MUTE_AFTER * period + hb + 2 * period + 0.75
    shrink_fence = math.ceil(confined / fast) + lead
    rehabilitated = EL_MUTE_TAIL_S + 2 * period + 0.75 + 0.5
    regrow_fence = shrink_fence + 1 + math.ceil(rehabilitated / shrunk) + lead
    return {"epochs": int(regrow_fence + 1 + EL_TAIL_EPOCHS), "split_epoch_s": split_epoch_s,
            "shrunk_epoch_s": shrunk_epoch_s}


def el_end_mute(pod, job_id: str, state: str) -> dict:
    """Once the shrunk attempt of ``job_id`` has begun (STATUS's ``elastic``
    block) and EL_MUTE_TAIL_S more have passed, spend the mute rule's count
    in the state file the pod's processes share (under its lock, as they
    update it): the beacon beats again. Returns the beats dropped and the
    seconds from the attempt's start."""
    import fcntl

    deadline = time.monotonic() + POD_JOB_S
    while pod.sender.send_status_command()["elastic"]["active"].get(
            job_id, {}).get("attempt", 0) < 1:
        check(time.monotonic() < deadline, "phase 3el (b): the job never shrank")
        time.sleep(0.05)
    time.sleep(EL_MUTE_TAIL_S)
    with open(state + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        with open(state) as f:
            fired = json.load(f)["fired"][0]
        with open(state, "w") as f:
            json.dump({"hits": [EL_MUTE_COUNT + EL_MUTE_AFTER], "fired": [EL_MUTE_COUNT]}, f)
    return {"beats_dropped": fired, "mute_s": fired * float(EL_HB_PERIOD)}


def el_submit(pod, *configs) -> None:
    for c in configs:
        reply = pod.sender.send_job_submit_command(c)
        check(reply.get("ok"), f"phase 3el: submit {c.job_id}: {reply}")


def el_split(n: int, own: bool, root: str, one_slot, launches: dict,
             shrunk_epoch_s: float) -> dict:
    """Phase 3el (b): a warm-up over the last two processes, then the victim
    there, the last one's beacon muted for a bounded window: shrink onto the
    other, then re-grow onto both once the beats resume."""
    from harmony_tpu_torch import faults
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet

    job, mute, keep = "el-split", n - 1, n - 2
    # the warm-up is the muted process's first job, the victim its second. The
    # rule mutes with no end, its counters in a state file the pod's processes
    # share (faults/plan.py), and this script spends its count once the job
    # has shrunk (el_end_mute)
    rule = faults.FaultRule("pod.heartbeat", match={"pid": mute, "jobs_started": 2},
                            after=EL_MUTE_AFTER, count=EL_MUTE_COUNT, action="skip")
    os.makedirs(root, exist_ok=True)
    state = os.path.join(root, "fault-state.json")
    env = el_pod_env(root, rule)
    env[faults.ENV_VAR] = faults.FaultPlan([rule], state_path=state).to_json()
    pod = ChipPod(n, own, phase="3el", scheduler="share_all" if n == 2 else "pod_carve:2",
                  env=env)
    try:
        print(f"phase 3el (b): {pod.ready_line}; {pod.backend.split(': ', 1)[-1]}", flush=True)
        # pod_carve:2 on four processes: a filler takes processes 0 and 1 each time
        fill = (lambda tag: [el_filler(f"el-filler-{tag}")]) if n > 2 else (lambda tag: [])
        el_submit(pod, *fill("warm"), el_victim("el-warm", EL_WARM_EPOCHS))
        for c in fill("warm"):   # its processes must be free for the next filler
            el_wait(pod, c.job_id)
        warm = el_wait(pod, "el-warm")
        (ww,) = warm["workers"].values()
        split_epoch_s = (ww["train_span"][1] - ww["train_span"][0]) / ww["epochs_run"]
        plan = el_split_plan(split_epoch_s, shrunk_epoch_s)
        epochs = plan["epochs"]
        print(f"phase 3el (b): plan {json.dumps(plan)}", flush=True)
        losses, files, _ = one_slot(epochs)
        el_submit(pod, *fill("split"), el_victim(job, epochs))
        plan.update(el_end_mute(pod, job, state))
        res = el_wait(pod, job)
        status = pod.sender.send_status_command()
        closed = pod.shutdown()
    finally:
        pod.close()
    meta = res.get("elastic", {})
    kinds = [e["kind"] for e in meta.get("events", [])]
    check(kinds == ["elastic_shrink", "elastic_regrow"] and meta["attempts"] == 3,
          f"phase 3el (b): {json.dumps(meta)[:3000]}; pod events "
          f"{json.dumps(closed.get('elastic_events'))[:4000]}")
    shrink, regrow = meta["events"]
    original = [f"executor-{keep}", f"executor-{mute}"]
    check(shrink["procs"] == [keep] and regrow["procs"] == [keep, mute]
          and regrow["executors"] == original,
          f"phase 3el (b): shrink {shrink}, re-grow {regrow}")
    events = closed["elastic_events"]
    pod_kinds = [e["kind"] for e in events]
    for k in ("follower_silenced", "elastic_shrink_fence", "follower_rehabilitated",
              "elastic_regrow_fence", "elastic_shrink", "elastic_regrow"):
        check(k in pod_kinds, f"phase 3el (b): no {k} among {pod_kinds}")
    attempts = el_attempts(status["pod"]["reports"], job, 3)
    el_add_launches(launches, attempts)
    half = WD_BLOCKS // 2
    srst = attempts[1][str(keep)]["elastic_restore"]
    check(srst["blocks_needed"] == WD_BLOCKS and srst["blocks_local"] == half
          and srst["blocks_read"] == half == srst["lost_block_count"]
          and srst["bytes_read"] == half * WD_BLOCK_BYTES,
          f"phase 3el (b): the shrink's restore {json.dumps(srst)}")
    r_keep = attempts[2][str(keep)]["elastic_restore"]
    r_back = attempts[2][str(mute)]["elastic_restore"]
    check(r_keep["chkp_id"] == r_back["chkp_id"]
          and (r_keep["blocks_local"], r_keep["blocks_read"]) == (half, 0)
          and (r_back["blocks_local"], r_back["blocks_read"], r_back["bytes_read"])
          == (0, half, half * WD_BLOCK_BYTES),
          f"phase 3el (b): the re-grow's restores {json.dumps([r_keep, r_back])}")
    s_fence = el_event(events, "elastic_shrink_fence", job)
    r_fence = el_event(events, "elastic_regrow_fence", job)
    (w,) = res["workers"].values()
    start = w["starting_epoch"]
    check(start == res["elastic_restore"]["resumed_epoch"] == r_fence["epoch"] + 1
          and srst["resumed_epoch"] == s_fence["epoch"] + 1
          and w["epochs_run"] == epochs - start,
          f"phase 3el (b): epochs: final attempt {start}+{w['epochs_run']}, fences "
          f"{s_fence['epoch']} and {r_fence['epoch']}, shrink resumed {srst['resumed_epoch']}")
    mid = attempts[1][str(keep)]["workers"][f"{job}/w0"]["batch_losses"]
    first = [rep["workers"][f"{job}/w0"]["batch_losses"] for rep in attempts[0].values()]
    check(w["batch_losses"] == losses[BATCHES * start:BATCHES * epochs]
          and mid == losses[BATCHES * srst["resumed_epoch"]:BATCHES * start]
          and all(b == losses[:len(b)] for b in first),
          "phase 3el (b): the losses are not the uninterrupted run's bits")
    check(pc_entries(root, job)[epochs - 1]["files"] == files,
          "phase 3el (b): the final table is not the uninterrupted run's")
    silenced = el_event(events, "follower_silenced")
    rehab = el_event(events, "follower_rehabilitated")
    s_ev, r_ev = el_event(events, "elastic_shrink", job), el_event(events, "elastic_regrow", job)
    a0 = attempts[0][str(keep)]
    a1 = attempts[1][str(keep)]
    a2 = attempts[2][str(keep)]
    window = WorkerTasklet.EPOCH_WINDOW + 2
    out = {"processes": [keep, mute], "fence_epochs": [s_fence["epoch"], r_fence["epoch"]],
           "warm_up_split_epoch_s": split_epoch_s,
           "shrink": {"detection": {"by": "hb_timeout", "silent_for_s": silenced["silent_for"]},
                      "fence_lead_epochs": s_fence["epoch"] - s_fence["observed_epoch"],
                      "fence_lead_s": s_ev["ts"] - s_ev["planning_s"] - s_fence["ts"],
                      "planning_s": s_ev["planning_s"], "restore": el_restore_clock(srst),
                      "confinement_to_first_step_s": a1["train_wall"] - silenced["ts"],
                      "step_ms_before": el_step_ms(a0), "step_ms_after": el_step_ms(a1)},
           "regrow": {"rehabilitated_after_s": rehab["ts"] - silenced["ts"],
                      "fence_lead_epochs": r_fence["epoch"] - r_fence["observed_epoch"],
                      "fence_lead_s": r_ev["ts"] - r_ev["planning_s"] - r_fence["ts"],
                      "planning_s": r_ev["planning_s"],
                      "restore": {"survivor": el_restore_clock(r_keep),
                                  "returning": el_restore_clock(r_back)},
                      "rehabilitation_to_first_step_s": a2["train_wall"] - rehab["ts"],
                      "step_ms_before": el_step_ms(a1), "step_ms_after": el_step_ms(a2)},
           "plan": plan, "epochs_left_at_regrow_fence": epochs - r_fence["epoch"],
           "epoch_window_plus_2": window,
           "losses_bit_identical": True, "final_table_bit_identical": True}
    print(f"phase 3el (b): silence, shrink, re-grow: {json.dumps(out)}", flush=True)
    return out


def el_kill_one_slot():
    """(a)'s job uninterrupted on one slot (:func:`el_one_slot`): the
    yardstick of 3el (a) and of 3ha."""
    scratch = tempfile.mkdtemp(prefix="harmony-el-one-")
    try:
        return el_one_slot(scratch, "el-kill", EL_KILL_EPOCHS)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def run_pod_elastic(kill_one):
    """Phase 3el: elastic recovery on the pod (see the module doc).
    ``kill_one``: :func:`el_kill_one_slot`'s run."""
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    own = cards >= 4
    n = 4 if own else 2
    scratch = tempfile.mkdtemp(prefix="harmony-el-")
    launches = {name: 0 for name in ("gather_rows", "segment_sum_rows", "weighted_histogram",
                                     "flash_forward", "flash_backward_dkv", "flash_backward_dq")}
    out = {"processes": n, "cards": cards if own else 1, "card": gpu_identity(),
           "settings": {"HARMONY_POD_HB_TIMEOUT": EL_HB_TIMEOUT,
                        "HARMONY_POD_HB_PERIOD": EL_HB_PERIOD,
                        "epochs": {"kill": EL_KILL_EPOCHS}}}
    try:
        torch.cuda.empty_cache()
        out["kill"] = el_kill(n, own, os.path.join(scratch, "kill"), kill_one, launches)

        def split_one(epochs):
            # the uninterrupted run, made while the pod's warm-up has ended
            return el_one_slot(os.path.join(scratch, "one-split"), "el-split", epochs)

        out["split"] = el_split(n, own, os.path.join(scratch, "split"), split_one, launches,
                                out["kill"]["shrunk_epoch_s"])
        out["settings"]["epochs"]["split"] = out["split"]["plan"]["epochs"]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    out["launches"] = {k: v for k, v in launches.items() if v}
    check(launches["gather_rows"] > 0 and launches["weighted_histogram"] > 0,
          f"phase 3el: launches {launches}: K1 or K3 never ran on the pod")
    out["seconds"] = time.perf_counter() - t0
    return launches, out


# -- phase 3pd: a data axis whose rows lie in different processes -----------

# (c): bench-widedeep at data_axis 2 chained for PD_RESUME_AT epochs, then
# resumed to PD_CHAIN_EPOCHS, against the one-process chain of as many epochs
PD_CHAIN_EPOCHS = 3
PD_RESUME_AT = 2


def pod_trainers():
    """``tests/torch_pod_trainers.py`` of this checkout, loaded once by its
    path: the ``Kept*`` trainers and :func:`kept_tables` that the CPU tests
    of a data axis over processes use too."""
    import importlib.util

    mod = sys.modules.get("torch_pod_trainers")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "torch_pod_trainers", os.path.join(REPO, "tests", "torch_pod_trainers.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["torch_pod_trainers"] = mod
        spec.loader.exec_module(mod)
    return mod


def pd_kept(config, keep_dir: str):
    """``config`` on the Kept form of its trainer (``chip_smoke:Kept<class>``,
    as the pod's processes resolve it), keeping under ``keep_dir``."""
    cls = config.trainer.rsplit(":", 1)[-1]
    return config.replace(trainer=f"chip_smoke:Kept{cls}", params=config.params.replace(
        app_params={**config.params.app_params, "keep_dir": keep_dir}))


# the jobs (d) moves whose unmoved epochs (every epoch before its first plan)
# stand for (a)'s runs of them (sparse LDA stays in (a) too: its push is the
# pod-data-rows path's K2)
PD_MOVED = ("bench-widedeep", "bench-nmf")


def pd_configs() -> dict:
    """(a)'s jobs by name: those of phase 3x (b)'s five that (d) does not
    move (PD_MOVED), at data_axis 2, DX_EPOCHS epochs each."""
    return {k: c.replace(user={**c.user, "data_axis": 2}) for k, c in dx_configs().items()
            if k not in PD_MOVED}


def pd_one_process(configs: dict, keep: str, root: str) -> tuple:
    """The one-process runs 3pd holds the pod to, on (2, 2) of 4 virtual
    slots of cuda:0 (``HARMONY_PUSH_VIA=mxu``, as the pod's processes): each
    of ``configs``' batch losses and block digests, and bench-widedeep's
    data-2 chain of PD_CHAIN_EPOCHS under ``root`` (its losses and entries)."""
    from harmony_tpu_torch.parallel.mesh import DevicePool

    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    server = pool_server(DevicePool.virtual("cuda:0", DX_SLOTS).slots, root=root)
    try:
        refs = {}
        for name, config in configs.items():
            w, _ = submit_one(server, pd_kept(config, os.path.join(keep, name)))
            check(w["mesh"] == {"data": 2, "model": 2} and w["step_mode"] == "data_parallel",
                  f"phase 3pd {name}: the one-process run's mesh {w['mesh']}")
            refs[name] = (w["batch_losses"],
                          pod_trainers().kept_tables(os.path.join(keep, name), config.job_id))
        w, _ = submit_one(server, wd_mesh_config("pd-wd-chain", PD_CHAIN_EPOCHS, data_axis=2,
                                                 period=1))
        return refs, (w["batch_losses"], pc_entries(root, "pd-wd-chain"))
    finally:
        server.shutdown(timeout=600)
        os.environ.pop("HARMONY_PUSH_VIA")


def run_pod_data():
    """Phase 3pd: a data axis whose rows lie in different processes (see the
    module doc)."""
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    own = cards >= 4
    n, slots = (4, 1) if own else (2, 2)
    configs = pd_configs()
    scratch = tempfile.mkdtemp(prefix="harmony-pd-")
    pod_root, one_root = os.path.join(scratch, "pod"), os.path.join(scratch, "one")
    out = {"processes": n, "slots_per_process": slots, "cards": cards if own else 1,
           "mesh": {"data": 2, "model": 2}, "card": gpu_identity()}
    names = ("gather_rows", "segment_sum_rows", "weighted_histogram")
    launches = {name: 0 for name in names + (
        "flash_forward", "flash_backward_dkv", "flash_backward_dq")}
    by_process = [{name: 0 for name in names} for _ in range(n)]
    # (d)-(f)'s, the path pod-data-moves
    moves_launches = dict.fromkeys(launches, 0)
    moves_by_process = [{name: 0 for name in names} for _ in range(n)]
    # the data rows each process computes: its own on one card, the row of
    # its pair of processes on four
    rows_of = [[p] if n == 2 else [p // 2] for p in range(n)]
    try:
        t1 = time.perf_counter()
        refs, (chain_losses, chain_entries) = pd_one_process(
            configs, os.path.join(scratch, "keep-one"), one_root)
        out["one_process_seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        env = {"HARMONY_POD_CHKP_ROOT": pod_root}
        if slots == PD_MOVE_SLOTS:
            env.update(pd_kill_env(n, own))
        pod = ChipPod(n, own, phase="3pd", slots=slots, env=env)
        try:
            out["ready"] = pod.ready_line
            out["backend"] = pod.backend.split(": ", 1)[-1]
            print(f"phase 3pd: {out['ready']}; {out['backend']}", flush=True)

            def run(cfg):
                reps, _ = pod.run(cfg)
                reps = reps[cfg.job_id]
                check(sorted(reps) == [str(p) for p in range(n)]
                      and all(r["ok"] for r in reps.values()),
                      f"phase 3pd {cfg.job_id}: reports {json.dumps(reps)[:3000]}")
                for p in range(n):
                    for name, v in reps[str(p)]["launches"].items():
                        launches[name] += v
                        if name in by_process[p]:
                            by_process[p][name] += v
                return [reps[str(p)] for p in range(n)]

            def worker(rep):
                (w,) = rep["workers"].values()
                return w

            # (a) or (b): each job's bits and tables the one process's
            from harmony_tpu_torch.parallel.collectives import POD_CALLERS

            stat_keys = ("calls", "bytes_out", "bytes_in")
            a = {}
            for name, config in configs.items():
                keep = os.path.join(scratch, "keep-pod", name)
                reps = run(pd_kept(config, keep))
                losses, tables = refs[name]
                steps = len(losses)
                for p, rep in enumerate(reps):
                    w = worker(rep)
                    check(w["batch_losses"] == losses,
                          f"phase 3pd {name}: process {p}'s losses are not the one-process "
                          "data-2 bits")
                    check(w["data_rows"] == rows_of[p],
                          f"phase 3pd {name}: process {p} computed rows {w['data_rows']}")
                    check(w["restaged_batches"] == 0,
                          f"phase 3pd {name}: process {p} restaged {w['restaged_batches']}")
                check(pod_trainers().kept_tables(keep, config.job_id) == tables,
                      f"phase 3pd {name}: the pod's final tables are not the one-process "
                      "data-2 tables block for block")
                per_epoch = steps // len(worker(reps[0])["epoch_seconds"])
                a[name] = {
                    "steps": steps, "batch_losses": "the one-process data-2 bits",
                    "tables": "the one-process data-2 blocks",
                    "all_gathers_per_step": [{
                        "process": p, **{k: rep["combine"][k] / steps for k in stat_keys},
                        "by_caller": {c: {k: rep["combine"][f"{c}.{k}"] / steps
                                          for k in stat_keys} for c in POD_CALLERS}}
                        for p, rep in enumerate(reps)],
                    "step_ms": [1e3 * worker(rep)["epoch_seconds"][-1] / per_epoch
                                for rep in reps]}
                print(f"phase 3pd {name}: {json.dumps(a[name])}", flush=True)
            out["jobs"] = a

            # (c) a chain, then a resume: the one-process chain's entries
            first = run(wd_mesh_config("pd-wd-chain", PD_RESUME_AT, data_axis=2, period=1))
            resumed = run(wd_mesh_config("pd-wd-chain", PD_CHAIN_EPOCHS, data_axis=2, period=1,
                                         resume_from_chain=True))
            for p in range(n):
                check(worker(first[p])["batch_losses"] + worker(resumed[p])["batch_losses"]
                      == chain_losses,
                      f"phase 3pd (c): process {p}'s chained and resumed losses are not the "
                      "one-process run's")
            got = pc_entries(pod_root, "pd-wd-chain")
            check(sorted(got) == sorted(chain_entries) == list(range(PD_CHAIN_EPOCHS)),
                  f"phase 3pd (c): entries {sorted(got)} against {sorted(chain_entries)}")
            for epoch, e in got.items():
                want = chain_entries[epoch]
                check(e["id"].endswith("-pod") and e["files"] == want["files"]
                      and e["checksums"] == want["checksums"],
                      f"phase 3pd (c): entry {e['id']} is not the one-process data-2 entry of "
                      f"epoch {epoch} byte for byte")
            out["chain"] = {"epochs": PD_CHAIN_EPOCHS, "resumed_at": PD_RESUME_AT,
                            "ids": [got[e]["id"] for e in sorted(got)],
                            "entries": "the one-process data-2 entries byte for byte",
                            "files_sha256": [files_digest(got[e]["files"]) for e in sorted(got)],
                            "staged_by_process": [
                                [st["blocks"] for st in rep["model_chkp_stats"]]
                                for rep in first]}
            print(f"phase 3pd (c): {json.dumps(out['chain'])}", flush=True)
            if slots == PD_MOVE_SLOTS:
                out["moves"] = pd_moves(pod, n, scratch, moves_launches, moves_by_process)
                out["kill"] = pd_kill(pod, n, own, moves_launches, moves_by_process)
        finally:
            pod.close()
        if slots != PD_MOVE_SLOTS:
            # four cards: a pod of two slots a process, so a drain keeps
            # every process an owner
            root = os.path.join(scratch, "moves-chains")
            mpod = ChipPod(n, own, phase="3pd", slots=PD_MOVE_SLOTS,
                           env={"HARMONY_POD_CHKP_ROOT": root, **pd_kill_env(n, own)})
            try:
                print(f"phase 3pd (d): {mpod.ready_line}; "
                      f"{mpod.backend.split(': ', 1)[-1]}", flush=True)
                out["moves"] = pd_moves(mpod, n, scratch, moves_launches, moves_by_process)
                out["kill"] = pd_kill(mpod, n, own, moves_launches, moves_by_process)
            finally:
                mpod.close()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for p, counts in enumerate(by_process):
        check(all(counts[k] > 0 for k in names),
              f"phase 3pd: process {p}'s launches {counts}: a kernel never ran there")
    for p, counts in enumerate(moves_by_process):
        check(all(counts[k] > 0 for k in names),
              f"phase 3pd (d)-(f): process {p}'s launches {counts}: a kernel never ran there")
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["launches_by_process"] = by_process
    out["moves_launches"] = {k: v for k, v in moves_launches.items() if v}
    out["moves_launches_by_process"] = moves_by_process
    out["seconds"] = time.perf_counter() - t0
    return launches, moves_launches, out


# (d)-(f): moves, an optimizer plan and elastic recovery of a data-2 job whose
# rows lie in different processes, on a pod of PD_MOVE_SLOTS slots a process
# (on one card 3pd's own pod; on four cards a pod of its own, so a drain keeps
# every process an owner). (d) each job waits PD_MOVE_LAG s before its first
# epoch (the plans reach it at epoch 0, so they land at 9, 11 and 13) and runs
# PD_MOVE_EPOCHS; (e) the optimizer's job sleeps PD_OPT_LAG s after each of
# PD_OPT_EPOCHS epochs; (f) bench-widedeep with an entry every epoch and
# ``elastic_shrink``, the last process crashed (exit code 86) at its first step
# of epoch PD_KILL_EPOCH of PD_KILL_EPOCHS
PD_MOVE_SLOTS = 2
PD_MOVE_EPOCHS = 16
PD_MOVE_LAG = 2.0
PD_OPT_EPOCHS = 20
PD_OPT_LAG = 0.1
PD_KILL_EPOCHS = 5
PD_KILL_EPOCH = 3
# (f) on four cards over NCCL: the survivors' collectives with the killed
# process wait on it; a group timeout of this many seconds and NCCL's
# clean-up-only error handling end those waits with an error in each
# survivor, which then reports for the attempt (PyTorch's default handling
# tears a process down on such an error)
PD_KILL_NCCL_TIMEOUT = "30"


def pd_plans(executors: int) -> list:
    """(d)'s POD_RESHARD plans over ``executors`` (in mesh order, two a
    process): a block from executor-1 to executor-0 (the rows kept), the
    last executor drained onto the one before (an odd count: data 1), a
    block back onto it (data 2 again)."""
    last = executors - 1
    return [{"epoch": 9, "src": "executor-1", "dst": "executor-0", "num_blocks": 1},
            {"epoch": 11, "src": f"executor-{last}", "dst": f"executor-{last - 1}",
             "num_blocks": 1 << 20},
            {"epoch": 13, "src": f"executor-{last - 1}", "dst": f"executor-{last}",
             "num_blocks": 1}]


def pd_move_configs(keep: str) -> dict:
    """(d)'s jobs at data_axis 2 over PD_MOVE_EPOCHS, kept under ``keep``:
    bench-widedeep, the trio's NMF and sparse LDA."""
    dx = dx_configs()
    configs = {"bench-widedeep": wd_mesh_config("pd-wd-moved", PD_MOVE_EPOCHS),
               "bench-nmf": dx["bench-nmf"].replace(job_id="pd-nmf-moved"),
               "sparse-lda": dx["sparse-lda"].replace(job_id="pd-lda-moved")}
    out = {}
    for name, c in configs.items():
        c = c.replace(params=c.params.replace(num_epochs=PD_MOVE_EPOCHS),
                      user={**c.user, "data_axis": 2})
        out[name] = pd_kept(c, os.path.join(keep, name))
    return out


def pd_with(config, **app_params):
    return config.replace(params=config.params.replace(
        app_params={**config.params.app_params, **app_params}))


def pd_replay(config, plans: list, slots: int) -> tuple:
    """``config`` in this process on ``slots`` virtual slots of cuda:0
    (``HARMONY_PUSH_VIA=mxu``, as the pod's processes), ``plans`` applied at
    its chief hook as the pod applies them, per-batch epochs as under a
    JobServer: (worker result, applied plans)."""
    from harmony_tpu_torch.jobserver import podplan
    from harmony_tpu_torch.jobserver.entity import DolphinJobEntity
    from harmony_tpu_torch.parallel.mesh import DevicePool
    from harmony_tpu_torch.runtime.master import ETMaster

    os.environ["HARMONY_PUSH_VIA"] = "mxu"
    lags = {k: 0.0 for k in ("start_lag_sec", "epoch_lag_sec") if k in config.params.app_params}
    config = pd_with(config, **lags)
    master = ETMaster(DevicePool.virtual("cuda:0", slots))
    ent = DolphinJobEntity(config)
    try:
        ent.setup(master, [e.id for e in master.add_executors(slots)])
        for p in plans:
            podplan.schedule(config.job_id, dict(p))
        res = ent.make_worker(epoch_callback=ent._make_pod_plan_hook(),
                              batch_barrier=lambda i: False).run()
    finally:
        ent.cleanup()
        podplan.clear(config.job_id)
        os.environ.pop("HARMONY_PUSH_VIA")
    return res, list(ent._applied_plans)


def pd_step_ms(w: dict) -> list:
    """A worker report's ms a step of each epoch."""
    return [1e3 * s / (len(w["batch_losses"]) // max(len(w["epoch_seconds"]), 1))
            for s in w["epoch_seconds"]]


def pd_rows_by_epoch(p: int, n: int, plans: list, epochs: int) -> list:
    """The rows process ``p`` of ``n`` computes in each epoch under (d)'s
    plans: its row of (data 2, ...) (the first half of the processes row 0),
    row 0 of the data-1 mesh between the drain and the refill."""
    drain, refill = plans[1]["epoch"], plans[2]["epoch"]
    own = [0 if p < n // 2 else 1]
    by_epoch = [[0] if drain < e <= refill else own for e in range(epochs)]
    return own if all(r == own for r in by_epoch) else by_epoch


def pd_digest(obj) -> str:
    """One SHA-256 of a JSON value (losses, a table's block digests), to hold
    one host's run against another's."""
    import hashlib

    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def pd_add_launches(reps: dict, launches: dict, by_process: list) -> None:
    """Each process's kernel launches of a job's reports (``{pid: report}``)."""
    for pid, rep in reps.items():
        for name, v in rep.get("launches", {}).items():
            launches[name] += v
            if name in by_process[int(pid)]:
                by_process[int(pid)][name] += v


def pd_moves(pod, n: int, scratch: str, launches: dict, by_process: list) -> dict:
    """Phase 3pd (d) and (e) on ``pod`` (``n`` processes of PD_MOVE_SLOTS
    slots), submitted together: (d)'s jobs moved by POD_RESHARD and (e) the
    optimizer's plan, each process held to the one-process run on as many
    virtual slots of cuda:0 with the same plans at the same epochs."""
    from harmony_tpu_torch.parallel.collectives import POD_CALLERS

    executors = n * PD_MOVE_SLOTS
    plans = pd_plans(executors)
    keep_pod, keep_one = os.path.join(scratch, "moves-pod"), os.path.join(scratch, "moves-one")
    configs = pd_move_configs(keep_pod)
    optimized = pd_with(pd_kept(wd_mesh_config("pd-wd-optimized", PD_OPT_EPOCHS, data_axis=2),
                                os.path.join(keep_pod, "opt")),
                        epoch_lag_sec=PD_OPT_LAG).replace(
        optimizer="chip_smoke:MoveOncePodOptimizer", optimizer_period=0.2)
    stat_keys = ("calls", "bytes_out", "bytes_in")

    def send_plans():
        for name, c in configs.items():
            for i, p in enumerate(plans):
                deadline = time.monotonic() + POD_JOB_S
                while True:
                    reply = pod.sender.send_pod_reshard_command(
                        c.job_id, p["src"], p["dst"], p["num_blocks"], p["epoch"])
                    if reply.get("ok") or i or "unknown" not in reply.get("error", ""):
                        break
                    check(time.monotonic() < deadline, f"phase 3pd (d): {c.job_id} never ran")
                    time.sleep(0.05)
                check(reply.get("ok"), f"phase 3pd (d): {c.job_id} plan {p}: {reply}")

    t0 = time.perf_counter()
    reps_by_job, _ = pod.run(*[pd_with(c, start_lag_sec=PD_MOVE_LAG) for c in configs.values()],
                             optimized, between=send_plans)
    out = {"plans": plans, "executors": executors, "pod_seconds": time.perf_counter() - t0,
           "jobs": {}}
    for reps in reps_by_job.values():
        check(sorted(reps) == [str(p) for p in range(n)] and all(r["ok"] for r in reps.values()),
              f"phase 3pd (d)/(e): reports {json.dumps(reps)[:3000]}")
        pd_add_launches(reps, launches, by_process)
    keep = pod_trainers()
    for name, c in configs.items():
        reps = reps_by_job[c.job_id]
        res, applied = pd_replay(pd_with(c, keep_dir=os.path.join(keep_one, name)), plans,
                                 executors)
        check([(a["epoch"], a["moved"] > 0, a["owners_after"]) for a in applied]
              == [(9, True, executors), (11, True, executors - 1), (13, True, executors)],
              f"phase 3pd (d) {name}: the one-process applied plans {applied}")
        rows = []
        for p in range(n):
            r = reps[str(p)]
            (w,) = r["workers"].values()
            check(w["batch_losses"] == res["batch_losses"],
                  f"phase 3pd (d) {name}: process {p}'s losses are not the one-process run's "
                  "with the same plans")
            check(r["applied_plans"] == applied,
                  f"phase 3pd (d) {name}: process {p} applied {r['applied_plans']}")
            check(w["restaged_batches"] == 0,
                  f"phase 3pd (d) {name}: process {p} restaged {w['restaged_batches']}")
            check(w["data_rows"] == pd_rows_by_epoch(p, n, plans, PD_MOVE_EPOCHS),
                  f"phase 3pd (d) {name}: process {p} computed rows {w['data_rows']}")
            steps = len(w["batch_losses"])
            rows.append({
                "process": p,
                "moves": [{"epoch": m["epoch"], "host_ms": 1e3 * m["seconds"],
                           "transport": m["transport"], "transport_s": m.get("exchange_s"),
                           "bytes_sent": m["bytes_sent"], "bytes_received": m["bytes_received"],
                           "blocks_received": m["blocks_received"]}
                          for m in r["plan_moves"]],
                "restaged_batches": w["restaged_batches"],
                "all_gathers_per_step": {c2: {k: r["combine"][f"{c2}.{k}"] / steps
                                              for k in stat_keys} for c2 in POD_CALLERS},
                "step_ms_by_epoch": pd_step_ms(w)})
        check(keep.kept_tables(os.path.join(keep_pod, name), c.job_id)
              == keep.kept_tables(os.path.join(keep_one, name), c.job_id),
              f"phase 3pd (d) {name}: the pod's final tables are not the one-process run's "
              "block for block")
        replicas, owned = (keep.kept_replicas(os.path.join(keep_pod, name), c.job_id),
                           keep.kept_tables(os.path.join(keep_pod, name), c.job_id))
        check(all(set(d) == {owned[k]} for k, d in replicas.items()),
              f"phase 3pd (d) {name}: a replica of a block differs from its owner's copy")
        entry = {"batch_losses": "the one-process bits with the same plans",
                 "tables": "the one-process blocks, every replica alike",
                 "losses_sha256": pd_digest(res["batch_losses"]),
                 "tables_sha256": pd_digest(owned),
                 "applied_plans": applied, "by_process": rows}
        if name == "bench-widedeep":
            # the last epoch before the first plan, in the slowest process
            # (PERF.md holds it beside phase 3x (c)'s one process over four cards)
            before = plans[0]["epoch"]
            entry["samples_per_sec_before_the_plans"] = N_EXAMPLES / max(
                row["step_ms_by_epoch"][before] * BATCHES / 1e3 for row in rows)
        out["jobs"][name] = entry
        print(f"phase 3pd (d) {name}: {json.dumps(entry)}", flush=True)

    # (e) the optimizer's move-once plan through the pod's plan channel
    reps = reps_by_job[optimized.job_id]
    plans_seen = [reps[str(p)]["applied_plans"] for p in range(n)]
    check(all(len(a) == 1 and a == plans_seen[0] for a in plans_seen),
          f"phase 3pd (e): applied plans by process {plans_seen}")
    (applied,) = plans_seen[0]
    res, replayed = pd_replay(optimized.replace(optimizer=None, params=optimized.params.replace(
        app_params={**optimized.params.app_params, "keep_dir": os.path.join(keep_one, "opt")})),
        [{"epoch": applied["epoch"], "src": applied["src"], "dst": applied["dst"],
          "num_blocks": applied["moved"]}], executors)
    check(replayed == [applied], f"phase 3pd (e): replayed {replayed} against {applied}")
    for p in range(n):
        (w,) = reps[str(p)]["workers"].values()
        check(w["batch_losses"] == res["batch_losses"],
              f"phase 3pd (e): process {p}'s losses are not the one-process replay's")
    check(keep.kept_tables(os.path.join(keep_pod, "opt"), optimized.job_id)
          == keep.kept_tables(os.path.join(keep_one, "opt"), optimized.job_id),
          "phase 3pd (e): the pod's final tables are not the one-process replay's")
    out["optimizer"] = {"applied": applied, "batch_losses": "the one-process replay's bits",
                        "moves": [reps[str(p)].get("plan_moves") for p in range(n)]}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 3pd (e): {json.dumps(out['optimizer'])}", flush=True)
    return out


def pd_kill_env(n: int, own: bool) -> dict:
    """The env of the pod (f) runs on: its fault rule (the last process
    crashed, exit code 86, at its first step of epoch PD_KILL_EPOCH of the
    job ``pd-wd-killed`` only) and, on four cards over NCCL, the group
    timeout and error handling of PD_KILL_NCCL_TIMEOUT's comment."""
    from harmony_tpu_torch import faults

    rule = faults.FaultRule("worker.step", match={"job": "pd-wd-killed", "proc": n - 1},
                            after=PD_KILL_EPOCH * BATCHES, count=1, action="crash",
                            exit_code=86)
    env = {faults.ENV_VAR: faults.FaultPlan([rule]).to_json()}
    if own:
        env.update(HARMONY_POD_UNIT_TIMEOUT=PD_KILL_NCCL_TIMEOUT,
                   TORCH_NCCL_ASYNC_ERROR_HANDLING="2")
    return env


def pd_kill(pod, n: int, own: bool, launches: dict, by_process: list) -> dict:
    """Phase 3pd (f), the pod's last job (its fault rule, ``pd_kill_env``,
    ends the last process): bench-widedeep at data 2 over every slot with a
    chain entry every epoch and ``elastic_shrink``; the same submission
    finishes on the survivors. Where their mesh keeps data 2 (it does: one
    card keeps process 0's two slots, four cards six slots), the losses are
    the uninterrupted one-process data-2 run's bits; each survivor's restore
    reads from storage exactly the blocks ``pd_kill_reads`` predicts."""
    job, victim = "pd-wd-killed", n - 1
    t0 = time.perf_counter()
    cfg = wd_mesh_config(job, PD_KILL_EPOCHS, data_axis=2, period=1, elastic_shrink=True)
    # the uninterrupted run: the same job in this process, unchained
    one, _ = pd_replay(cfg.replace(params=cfg.params.replace(model_chkp_period=0), user={
        k: v for k, v in cfg.user.items() if k != "elastic_shrink"}), [], n * PD_MOVE_SLOTS)
    check(pod.sender.send_job_submit_command(cfg).get("ok"), "phase 3pd (f): submit")
    try:
        res = pod.sender.wait_result(job, timeout=POD_JOB_S, poll=1.0)
    except Exception as e:  # noqa: BLE001 - the phase fails
        fail(f"phase 3pd (f): {e}\n" + "\n".join(pod.log(p)[-3000:] for p in range(n)))
    rc = pod.procs[victim].wait(timeout=60)
    status = pod.sender.send_status_command()
    events = status["elastic"]["events"]
    check(rc == 86, f"phase 3pd (f): the victim's process exited {rc}, not 86")
    meta, rst = res.get("elastic", {}), res.get("elastic_restore", {})
    check(meta.get("attempts") == 2
          and [e["kind"] for e in meta.get("events", [])] == ["elastic_shrink"],
          f"phase 3pd (f): {json.dumps(meta)[:2000]}")
    survivors = meta["events"][0]["procs"]
    check(survivors == list(range(n - 1)), f"phase 3pd (f): survivors {survivors}")
    (w,) = res["workers"].values()
    start = w["starting_epoch"]
    check(start == rst.get("resumed_epoch") and start >= 2
          and w["epochs_run"] == PD_KILL_EPOCHS - start,
          f"phase 3pd (f): the final attempt ran epochs {start}+{w['epochs_run']}")
    check(w["mesh"]["data"] == 2, f"phase 3pd (f): the survivors' mesh {w['mesh']}")
    check(w["batch_losses"] == one["batch_losses"][BATCHES * start:],
          "phase 3pd (f): the resumed losses are not the uninterrupted run's bits")
    attempts = el_attempts(status["pod"]["reports"], job, 2)
    for reps in attempts:
        pd_add_launches(reps, launches, by_process)
    # the prediction: each survivor reads what its slots hold on the
    # survivors' mesh that it did not own on the killed one
    restores = {pid: rep["elastic_restore"] for pid, rep in attempts[1].items()}
    predicted = pd_kill_reads(n, rst["blocks_total"])
    for pid, r in restores.items():
        check(r["blocks_read"] == predicted[int(pid)] and
              r["blocks_local"] + r["blocks_read"] == r["blocks_needed"],
              f"phase 3pd (f): process {pid} read {r['blocks_read']} blocks, predicted "
              f"{predicted[int(pid)]}: {json.dumps(r)}")
    death, shrink = el_event(events, "follower_death"), el_event(events, "elastic_shrink", job)
    if own:
        # NCCL: a survivor whose communicator the watchdog aborted may hang
        # in the process group's teardown (ROADMAP C); the pod is ended after
        # a bounded wait, each survivor's exit recorded
        pod.sender.send_shutdown_command()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and any(
                proc.poll() is None for p, proc in enumerate(pod.procs) if p != victim):
            time.sleep(0.5)
        exits = {p: proc.poll() for p, proc in enumerate(pod.procs) if p != victim}
    else:
        pod.shutdown(dead=(victim,))
        exits = {p: 0 for p in range(n) if p != victim}
    out = {"victim_process": victim, "survivors": survivors, "exit_code": rc,
           "survivors_exit_codes": exits,
           "death_to_shrink_s": shrink["ts"] - death["ts"],
           "mesh_after": w["mesh"], "resumed_epoch": start,
           "restores": {pid: el_restore_clock(r) for pid, r in restores.items()},
           "blocks_read_predicted": predicted,
           # the killed attempt's reports carry no worker result: its step ms
           # before the kill is (d)'s bench-widedeep before its first plan
           "step_ms_after": [el_step_ms(rep) for rep in attempts[1].values()],
           "losses_bit_identical": True, "losses_sha256": pd_digest(w["batch_losses"]),
           "seconds": time.perf_counter() - t0}
    print(f"phase 3pd (f): kill, then shrink: {json.dumps(out)}", flush=True)
    return out


def pd_kill_reads(n: int, nb: int) -> dict:
    """Blocks each survivor of (f) reads from storage: those its slots hold
    on the survivors' mesh that it did not own (the lowest-owner rule) on
    the killed one. Executors in mesh order, PD_MOVE_SLOTS a process; a
    (data, model) mesh row-major, each model coordinate a contiguous run
    when the blocks divide over the model axis, else every block."""
    def held(count, data):
        m = count // data
        out = {}
        for i in range(count):
            k = i % m
            blocks = range(k * nb // m, (k + 1) * nb // m) if nb % m == 0 else range(nb)
            out.setdefault(i // PD_MOVE_SLOTS, []).append(set(blocks))
        return out

    total = n * PD_MOVE_SLOTS
    owned, left = {}, set(range(nb))
    for p, sets in sorted(held(total, 2).items()):
        mine = set().union(*sets) & left
        owned[p], left = mine, left - mine
    after_count = total - PD_MOVE_SLOTS
    after_data = 2 if after_count % 2 == 0 else 1
    return {p: len(set().union(*sets) - owned.get(p, set()))
            for p, sets in held(after_count, after_data).items()}


# -- phase 3ha: the control plane's HA --------------------------------------

# bench-widedeep chained every epoch over HA_EPOCHS epochs (3el (a)'s job, so
# el_kill_one_slot's uninterrupted run is 3ha's yardstick too);
# the leader's process crashes (HA_EXIT_CODE) at the first step of epoch
# HA_CRASH_EPOCH; the replicas' lease is HA_LEASE_S seconds
HA_EPOCHS = EL_KILL_EPOCHS
HA_CRASH_EPOCH = 3
HA_EXIT_CODE = 87
HA_LEASE_S = "1.5"
HA_JOB = "ha-wd"
# a CUDA context takes hundreds of MB of the card: a standby may take none
HA_STANDBY_MB = 64

_HA_TRAINER: list = []


def ha_counted_trainer():
    """Phase 3ha's ``chip_smoke:HaCountedWideDeep``: bench-widedeep's
    trainer, which writes the kernel launches of the run it trains (the
    wrappers' counts at its cleanup less those at its training's start) and
    its process id into ``count_dir`` as ``<pid>.json``. Built at first use
    (importing this script needs nothing of the repo)."""
    if not _HA_TRAINER:
        from harmony_tpu_torch.apps.widedeep import WideDeepTrainer

        class HaCountedWideDeep(WideDeepTrainer):
            def __init__(self, count_dir: str = "", **kw) -> None:
                super().__init__(**kw)
                self._count_dir = count_dir
                self._before = None

            def on_training_start(self, ctx, starting_epoch: int) -> None:
                self._before = launch_counts(all_wrappers())
                self._start = starting_epoch
                super().on_training_start(ctx, starting_epoch)

            def cleanup(self, ctx) -> None:
                super().cleanup(ctx)
                if self._count_dir and self._before is not None:
                    after = launch_counts(all_wrappers())
                    with open(os.path.join(self._count_dir, f"{os.getpid()}.json"), "w") as f:
                        json.dump({"pid": os.getpid(), "starting_epoch": self._start,
                                   "launches": {k: v - self._before[k]
                                                for k, v in after.items()}}, f)

        _HA_TRAINER.append(HaCountedWideDeep)
    return _HA_TRAINER[0]


def ha_config(count_dir: str):
    """The HA phase's submission: bench-widedeep, one worker, HA_EPOCHS
    epochs, a chain entry every epoch, on the counting trainer."""
    cfg = pod_wd_config(HA_JOB, HA_EPOCHS)
    return cfg.replace(trainer="chip_smoke:HaCountedWideDeep", params=cfg.params.replace(
        model_chkp_period=1, app_params={**cfg.params.app_params, "count_dir": count_dir}))


class HaReplica:
    """``python -m harmony_tpu_torch.cli start-jobserver`` as one HA replica:
    HARMONY_HA_LOG_DIR, the lease and the chain root shared, one executor,
    ``card`` (its CUDA_VISIBLE_DEVICES) or cuda:0, logging into ``log_dir``.
    Killed in ``close`` whatever happened."""

    def __init__(self, name: str, port: int, ha_dir: str, root: str, log_dir: str,
                 card=None, env: dict = None) -> None:
        self.name, self.port = name, port
        self.path = os.path.join(log_dir, f"{name}.log")
        penv = dict(os.environ, OMP_NUM_THREADS="4", HARMONY_PUSH_VIA="mxu",
                    HARMONY_HA_LOG_DIR=ha_dir, HARMONY_HA_LEASE_S=HA_LEASE_S)
        penv.pop("HARMONY_FAULT_PLAN", None)
        penv.update(env or {})
        if card is not None:
            penv["CUDA_VISIBLE_DEVICES"] = str(card)
        self.log = open(self.path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "harmony_tpu_torch.cli", "start-jobserver", "--port",
             str(port), "--num-executors", "1", "--chkp-root", root, "--ha-replica-id", name],
            cwd=REPO, env=penv, stdout=self.log, stderr=subprocess.STDOUT, text=True)

    def text(self) -> str:
        self.log.flush()
        with open(self.path) as f:
            return f.read()

    def wait_line(self, needle: str, timeout: float = POD_READY_S) -> str:
        """The first line holding ``needle``, polled every 10 ms."""
        deadline = time.monotonic() + timeout
        while True:
            found = [ln for ln in self.text().splitlines() if needle in ln]
            if found:
                return found[0]
            check(self.proc.poll() is None and time.monotonic() < deadline,
                  f"phase 3ha: replica {self.name} printed no {needle!r} "
                  f"(exit {self.proc.poll()}): {self.text()[-3000:]}")
            time.sleep(0.01)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.log.close()


def ha_free_mb(card: int) -> float:
    torch.cuda.synchronize(card)
    return torch.cuda.mem_get_info(card)[0] / 2 ** 20


def run_ha(one):
    """Phase 3ha: a leader replica killed mid-epoch, the standby takes over
    (see the module doc). ``one``: :func:`el_kill_one_slot`'s run."""
    from harmony_tpu_torch import faults
    from harmony_tpu_torch.dolphin.worker import WorkerTasklet
    from harmony_tpu_torch.jobserver.client import CommandSender

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    a_card, b_card = (0, 1) if cards >= 2 else (None, None)
    scratch = tempfile.mkdtemp(prefix="harmony-ha-")
    ha_dir, root, counts, logs = (os.path.join(scratch, d)
                                  for d in ("ha", "chains", "counts", "logs"))
    for d in (ha_dir, root, counts, logs):
        os.makedirs(d)
    out = {"cards": 2 if cards >= 2 else 1, "card": gpu_identity(), "lease_s": float(HA_LEASE_S),
           "epochs": HA_EPOCHS, "crash_epoch": HA_CRASH_EPOCH}
    replicas = []
    try:
        losses, files, one_epoch_s = one
        torch.cuda.empty_cache()
        rule = faults.FaultRule("worker.step", match={"job": HA_JOB},
                                after=HA_CRASH_EPOCH * BATCHES, count=1, action="crash",
                                exit_code=HA_EXIT_CODE)
        ports = [free_port(), free_port()]
        addrs = [f"127.0.0.1:{p}" for p in ports]
        a = HaReplica("ha-a", ports[0], ha_dir, root, logs, a_card,
                      {faults.ENV_VAR: faults.FaultPlan([rule]).to_json()})
        replicas.append(a)
        a.wait_line("standing by")
        out["a_leader_line"] = a.wait_line("is LEADER")
        # the standby's CUDA context: the card's free memory before and after
        # it stands by (the leader idle, nothing else on the card moving)
        card = b_card or 0
        ha_free_mb(card)
        free_before = ha_free_mb(card)
        b = HaReplica("ha-b", ports[1], ha_dir, root, logs, b_card)
        replicas.append(b)
        out["b_standby_line"] = b.wait_line("standing by")
        time.sleep(1.0)
        free_standby = ha_free_mb(card)
        standby_status = CommandSender(ports[1]).send_status_command()
        check(standby_status["state"] == "STANDBY"
              and standby_status["ha"]["role"] == "standby"
              and standby_status["ha"]["leader"] == addrs[0],
              f"phase 3ha: the standby's STATUS {standby_status}")
        out["standby"] = {"free_mb_before": free_before, "free_mb_standing_by": free_standby,
                          "context_mb": free_before - free_standby}
        check(free_before - free_standby < HA_STANDBY_MB,
              f"phase 3ha: the standby holds a CUDA context: {out['standby']}")
        exited = {}

        def watch():
            while a.proc.poll() is None:
                time.sleep(0.005)
            exited["wall"] = time.time()

        threading.Thread(target=watch, daemon=True).start()
        sender = CommandSender(addrs=addrs)
        reply = sender.send_job_submit_command(ha_config(counts))
        check(reply.get("ok"), f"phase 3ha: submit {reply}")
        rc = a.proc.wait(timeout=POD_JOB_S)
        check(rc == HA_EXIT_CODE, f"phase 3ha: the leader exited {rc}, not {HA_EXIT_CODE}: "
                                  f"{a.text()[-3000:]}")
        out["b_leader_line"] = b.wait_line("is LEADER")
        try:
            res = sender.wait_result(HA_JOB, timeout=POD_JOB_S, poll=1.0)
        except Exception as e:  # noqa: BLE001 - the phase fails
            fail(f"phase 3ha: {HA_JOB} did not finish through failover: {e}\n{b.text()[-3000:]}")
        status = CommandSender(addrs=addrs).send_status_command()
        check(CommandSender(addrs=addrs).send_shutdown_command().get("ok"),
              "phase 3ha: the successor refused SHUTDOWN")
        b_rc = b.proc.wait(timeout=POD_JOB_S)
        check(b_rc == 0, f"phase 3ha: the successor exited {b_rc}: {b.text()[-3000:]}")
        (w,) = res["workers"].values()
        start = w["starting_epoch"]
        check(1 <= start <= HA_CRASH_EPOCH and w["epochs_run"] == HA_EPOCHS - start,
              f"phase 3ha: the successor ran epochs {start}+{w['epochs_run']}")
        check(w["batch_losses"] == losses[BATCHES * start:BATCHES * HA_EPOCHS],
              "phase 3ha: the successor's losses are not the uninterrupted run's bits")
        check(pc_entries(root, HA_JOB)[HA_EPOCHS - 1]["files"] == files,
              "phase 3ha: the final table is not the uninterrupted run's")
        ha = status["ha"]
        tk = ha["takeovers"][-1]
        check(ha["role"] == "leader" and ha["leader_epoch"] == 2 and ha["replica"] == "ha-b"
              and (tk["old_leader"], tk["new_leader"], tk["rearmed"]) == ("ha-a", "ha-b", [HA_JOB])
              and tk["rejected_stale"] == 0,
              f"phase 3ha: the successor's ha {json.dumps(ha)[:3000]}")
        (count_file,) = os.listdir(counts)
        with open(os.path.join(counts, count_file)) as f:
            counted = json.load(f)
        check(counted["pid"] == b.proc.pid and counted["starting_epoch"] == start,
              f"phase 3ha: launches counted in {counted}, not in the successor ({b.proc.pid})")
        k = w["comm_probe"]["probes"] * (1 + WorkerTasklet.PROBE_SAMPLES)
        steps = w["epochs_run"] * BATCHES
        want = {"gather_rows": steps + 2 * k, "weighted_histogram": steps + k}
        launches = counted["launches"]
        check(all(launches[n] == want.get(n, 0) for n in launches),
              f"phase 3ha: the successor launched {launches}, expected {want} (K1 once a step "
              "and twice a probe call, K3 once each, nothing else)")

        def step_ms(epoch_s):
            return 1e3 * statistics.mean(epoch_s[1:]) / BATCHES

        out.update({
            "leader_exit_code": rc, "resumed_epoch": start,
            "death_to_leader_s": tk["ts"] - exited["wall"], "replay_ms": tk["replay_ms"],
            "replayed_entries": tk["replayed_entries"], "rearmed": tk["rearmed"],
            "lease_epoch": ha["leader_epoch"], "lease": ha["lease"],
            "log": {k: ha["log"][k] for k in ("appends", "group_commits", "append_seconds",
                                              "append_bytes", "last_seq")},
            "step_ms_successor": step_ms(w["epoch_seconds"]),
            "step_ms_uninterrupted": step_ms(one_epoch_s),
            "launches": {n: v for n, v in launches.items() if v},
            "losses_bit_identical": True, "final_table_bit_identical": True})
        print(f"phase 3ha: the leader killed at epoch {HA_CRASH_EPOCH}, the standby took over "
              f"and finished the same submission: {json.dumps(out)}", flush=True)
    finally:
        for r in replicas:
            r.close()
        shutil.rmtree(scratch, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return {name: launches.get(name, 0) for name in launch_counts(all_wrappers())}, out


def files_digest(files: dict) -> str:
    """One SHA-256 over an entry's files' digests, in name order."""
    import hashlib

    return hashlib.sha256("".join(f"{k}:{v};" for k, v in sorted(files.items())).encode()
                          ).hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        import harmony_tpu_torch
        from harmony_tpu_torch.ops import cuda_lib
    except ImportError as e:
        fail(f"harmony_tpu_torch is not importable beside this script: {e}")
    package_dir = os.path.dirname(os.path.abspath(harmony_tpu_torch.__file__))
    check(package_dir == os.path.join(REPO, "harmony_tpu_torch"),
          f"harmony_tpu_torch came from {package_dir}, not from beside this script")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    libs = cuda_lib.build()
    build_s = time.perf_counter() - t0
    ident = gpu_identity()
    print(f"phase 1: built {sorted(libs)} in {build_s:.1f} s on {ident}", flush=True)
    reports = cuda_lib.build_reports()
    for stem, report in sorted(reports.items()):
        if stem == "flash_attention_mma":
            continue
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")
    mma = mma_build_report(reports.get("flash_attention_mma", ""))
    check(mma, "no ptxas report for the tensor-core flash kernels")
    for (kernel, d, bk), entry in sorted(mma.items()):
        print(f"  ptxas {kernel} D={d}" + (f" block_k={bk}" if bk else "") + f": "
              f"{entry.get('registers')} registers, {entry.get('spill_bytes')} bytes "
              f"spilled, {entry['shared_bytes']} bytes dynamic shared memory", flush=True)
        check(d not in (64, 128) or entry.get("spill_bytes") == 0,
              f"{kernel} D={d} block_k={bk}: ptxas reports spills ({entry})")
    clock("1")

    alone = ("3t", "3u", "3v", "3w", "3x", "3y", "3z", "3pc", "3el", "3pd", "3ha")
    if len(sys.argv) == 3 and sys.argv[1] == "--phase" and sys.argv[2] in alone:
        # one phase alone (a host of several cards: the real mesh; 3t also
        # the device guard), 3t held to one-slot runs of its own
        name = sys.argv[2]
        if name == "3t":
            _, sharded = run_sharded(one_slot_refs())
            print("sharded: " + json.dumps(sharded), flush=True)
        elif name == "3u":
            _, sp = run_sp()
            print("sp: " + json.dumps(sp), flush=True)
        elif name == "3v":
            _, pv = run_pv()
            print("pv: " + json.dumps(pv), flush=True)
        elif name == "3x":
            _, dx = run_dx()
            print("dp: " + json.dumps(dx), flush=True)
        elif name == "3y":
            _, pod = run_pod(pod_one_slot_refs())
            print("pod: " + json.dumps(pod), flush=True)
        elif name == "3z":
            _, moves = run_pod_moves()
            print("pod moves: " + json.dumps(moves), flush=True)
        elif name == "3pc":
            _, chains = run_pod_chains()
            print("pod chains: " + json.dumps(chains), flush=True)
        elif name == "3el":
            _, pod_elastic = run_pod_elastic(el_kill_one_slot())
            print("pod elastic: " + json.dumps(pod_elastic), flush=True)
        elif name == "3pd":
            _, _, pod_data = run_pod_data()
            print("pod data rows: " + json.dumps(pod_data), flush=True)
        elif name == "3ha":
            _, ha = run_ha(el_kill_one_slot())
            print("ha: " + json.dumps(ha), flush=True)
        else:
            _, elastic = run_elastic()
            print("elastic: " + json.dumps(elastic), flush=True)
        clock(name)
        print(gpu_identity())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    check(not sys.argv[1:],
          f"unknown arguments {sys.argv[1:]} (only --phase 3t, 3u, 3v, 3w, 3x, 3y, 3z, 3pc, "
          "3el, 3pd or 3ha)")

    table, idx, err = check_kernels(dev)
    timing, skew = time_kernels(dev, table, idx)
    print(f"phase 2: timing {json.dumps(timing)}", flush=True)
    print(f"phase 2: fold (K3) timing on the skewed cases {json.dumps(skew)}", flush=True)
    del table, idx
    clock("2")
    err.update(check_flash_kernels(dev))
    timing.update(time_flash_kernels(dev))
    print(f"phase 2b: timing {json.dumps({k: timing[k] for k in FLASH_KERNELS})}",
          flush=True)
    vit_timing = time_flash_kernels(dev, VIT_FLASH_CASE)
    print(f"phase 2b: timing at bench-vit's shape {json.dumps(vit_timing)}", flush=True)
    sp_timing = {case[0]: time_flash_kernels(dev, case) for case in SP_FLASH_CASES}
    print(f"phase 2b: timing at phase 3u's shapes {json.dumps(sp_timing)}", flush=True)
    clock("2b")

    hash_ops = check_hash_ops(dev)
    clock("2c")
    tune = run_autotune(dev)
    clock("2d")
    launches, summary, fused, fused_sparse = run_slice()
    print("slice: " + json.dumps(summary), flush=True)
    clock("3 and 4")
    print("unfused: " + json.dumps(run_unfused_slice(fused, fused_sparse)), flush=True)
    clock("3e")
    lm_launches, lm_summary = run_lm()
    print("lm: " + json.dumps(lm_summary), flush=True)
    clock("3b")
    print("lm preset: " + json.dumps(run_lm_preset()), flush=True)
    clock("3c")
    vit_launches, vit = run_vit()
    print("vit: " + json.dumps(vit), flush=True)
    clock("3n")
    moe_launches, moe = run_moe()
    print("moe: " + json.dumps(moe), flush=True)
    clock("3o")
    gen_launches, generation, decode_once = run_generate(lm_summary["losses"])
    print("generate: " + json.dumps(generation), flush=True)
    clock("3p")
    trio_launches, trio, trio_jobs = run_trio()
    print("trio: " + json.dumps(trio), flush=True)
    fused_trio = trio_windows_without_syncs()
    print("trio windows: " + json.dumps(fused_trio), flush=True)
    print("trio agreement: " + json.dumps(trio_agreement()), flush=True)
    print("lda assignments: " + json.dumps(lda_assignments()), flush=True)
    clock("3d")
    print("async: " + json.dumps(run_async_mlr()), flush=True)
    clock("3f")
    print("prefetch: " + json.dumps(run_prefetch()), flush=True)
    clock("3g")
    fm_hash = run_hash_job("fm", EPOCHS)
    print("fm hash: " + json.dumps(fm_hash), flush=True)
    clock("3h")
    lda_hash = run_hash_job("lda", AGREE_EPOCHS)
    print("sparse lda: " + json.dumps(lda_hash), flush=True)
    clock("3i")
    host_launches, host_steps = run_host_driven_steps()
    print("host-driven steps: " + json.dumps(host_steps), flush=True)
    clock("3j")
    graph = pagerank_graph()
    slice_timing, slice_err = check_slice_kernels(dev, graph)
    for name, e in slice_err.items():
        err[name] = max(err[name], e)
    clock("2e")
    gbt = run_gbt()
    print("gbt: " + json.dumps(gbt), flush=True)
    clock("3k")
    pregel, pregel_one_slot = run_pregel(graph)
    print("pregel: " + json.dumps(pregel), flush=True)
    clock("3l")
    print("linear apps: " + json.dumps(run_linear_apps()), flush=True)
    clock("3m")
    for name, e in check_wd2_kernels(dev).items():
        err[name] = max(err[name], e)
    mw_launches, multiworker = run_multiworker(
        trio_jobs, {k: v["batch_losses"] for k, v in fused_trio.items()})
    print("multi-worker: " + json.dumps(multiworker), flush=True)
    clock("3q")
    chain_launches, chains = run_chains(lm_summary)
    print("chains: " + json.dumps(chains), flush=True)
    clock("3r")
    serving_launches, serving = run_serving()
    print("serving: " + json.dumps(serving), flush=True)
    clock("3s")
    sharded_launches, sharded = run_sharded({
        "wd_losses": fused["batch_losses"], "fm_hash": fm_hash["batch_losses"],
        "trio": {k: j["worker"]["batch_losses"] for k, j in trio_jobs.items()}})
    clock("3t")
    sp_launches, sp = run_sp()
    clock("3u")
    pv_launches, pv = run_pv()
    clock("3v")
    el_launches, elastic = run_elastic()
    clock("3w")
    dx_launches, dx = run_dx(pregel_one_slot)
    clock("3x")
    pr_ref = pregel["full"]["pagerank"]["pod_reference"]
    pod_launches, pod = run_pod({"wd": fused["batch_losses"],
                                 "fm": fm_hash["batch_losses"][:BATCHES],
                                 "pagerank": pr_ref["digest"],
                                 "pagerank_supersteps": pr_ref["supersteps"]})
    clock("3y")
    by_path = {name: {"bench-widedeep": launches.get(name, 0),
                      "bench-lm": lm_launches[name],
                      "bench-vit": vit_launches[name],
                      "bench-lm-moe": moe_launches[name],
                      "bench-generate": gen_launches[name],
                      "bench-trio": trio_launches[name],
                      "bench-fm-hash": fm_hash["launches"].get(name, 0),
                      "sparse-lda-hash": lda_hash["launches"].get(name, 0),
                      "fused-sparse-step": host_launches.get(name, 0),
                      "bench-gbt": gbt["launches"].get(name, 0),
                      **{f"bench-{app}": entry["launches"].get(name, 0)
                         for app, entry in pregel["full"].items()},
                      **{path: counts.get(name, 0) for path, counts in mw_launches.items()},
                      "chain": chain_launches[name],
                      "serving": serving_launches[name],
                      "sharded": sharded_launches.get(name, 0),
                      **{path: counts[name] for path, counts in sp_launches.items()},
                      **{path: counts[name] for path, counts in pv_launches.items()},
                      "elastic": el_launches.get(name, 0),
                      **{path: counts[name] for path, counts in dx_launches.items()},
                      "pod": pod_launches[name]}
               for name in lm_launches}
    print("profile: " + json.dumps(profile_slice()), flush=True)
    clock("5")
    print("lm profile: " + json.dumps(profile_lm()), flush=True)
    clock("5b")
    print("models profile: " + json.dumps(profile_models(decode_once)), flush=True)
    clock("5f")
    trio_profile = profile_trio()
    print("trio profile: " + json.dumps(trio_profile), flush=True)
    clock("5c")
    print(f"phase 3q: the trio on the per-batch TaskUnit path: {trio['samples_per_sec']:.1f} "
          f"samples/s (phase 3d), device idle share {trio_profile['pass']['device_idle_share']:.4f} "
          f"and {trio_profile['device_operations_per_step']:.1f} device operations a step "
          f"(phase 5c, {trio_profile['samples_per_sec']:.1f} samples/s), grants by job "
          f"{json.dumps(trio['grants'])}", flush=True)
    print("hash profile: " + json.dumps(profile_hash()), flush=True)
    clock("5d")
    print("new paths profile: " + json.dumps(profile_new_paths(graph)), flush=True)
    clock("5e")
    # phase 3z after the profiles: they keep the process history of earlier
    # runs (torch.profiler's lost records grow with it)
    moves_launches, moves = run_pod_moves(
        [row["step_ms"] for row in pod["widedeep_warm"]])
    for name, counts in by_path.items():
        counts["pod-moves"] = moves_launches[name]
    clock("3z")
    chains_launches, pod_chains = run_pod_chains()
    for name, counts in by_path.items():
        counts["pod-chains"] = chains_launches[name]
    clock("3pc")
    kill_one = el_kill_one_slot()
    elastic_launches, pod_elastic = run_pod_elastic(kill_one)
    for name, counts in by_path.items():
        counts["pod-elastic"] = elastic_launches[name]
    clock("3el")
    ha_launches, ha = run_ha(kill_one)
    for name, counts in by_path.items():
        counts["ha-takeover"] = ha_launches[name]
    clock("3ha")
    data_launches, data_moves_launches, pod_data = run_pod_data()
    for name, counts in by_path.items():
        counts["pod-data-rows"] = data_launches[name]
        counts["pod-data-moves"] = data_moves_launches[name]
    clock("3pd")
    print("hash ops: " + json.dumps(hash_ops) + "; autotune: " + json.dumps(tune), flush=True)
    print("profiler: markers lost by the kept profiles (lost: profiles), retakes: "
          + json.dumps(PROFILE_LOG), flush=True)

    mma_source = "harmony_tpu_torch/csrc/flash_attention_mma.cu"
    sources = {
        "gather_rows": ("harmony_tpu_torch/csrc/gather_rows.cu",
                        "harmony_tpu/ops/sparse.py:71"),
        "segment_sum_rows": ("harmony_tpu_torch/csrc/keyed_fold.cu",
                             "harmony_tpu/ops/sparse.py:146"),
        "weighted_histogram": ("harmony_tpu_torch/csrc/keyed_fold.cu",
                               "harmony_tpu/ops/histogram.py:94"),
        "flash_forward": (mma_source, "harmony_tpu/ops/attention.py:191"),
        "flash_backward_dkv": (mma_source, "harmony_tpu/ops/attention.py:345"),
        "flash_backward_dq": (mma_source, "harmony_tpu/ops/attention.py:367"),
    }
    # which kernel of each flash entry the LM's bf16 path runs and this line times
    variants = dict.fromkeys(FLASH_KERNELS, "mma: bf16 mma.sync, cp.async double-buffered")
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timing[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
            "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }
        if name in variants:
            entry["variant"] = variants[name]
        if name in slice_timing:
            entry["at_gbt_and_pagerank_shapes"] = slice_timing[name]
        if name in vit_timing:
            entry["at_bench_vit_shape"] = {"route": "simt", **vit_timing[name]}
            entry["at_sp_shapes"] = {case: {"route": "simt", **sp_timing[case][name]}
                                     for case in sp_timing}
            entry["at_pv_shapes"] = {
                case[0]: {"route": case[-1], **pv["flash_at_path_shapes"][case[0]][name]}
                for case in PV_FLASH_CASES}
        if name == "gather_rows":
            entry["at_sssp_and_cc_shapes"] = {
                k: t for k, t in slice_timing.items() if k.startswith("gather_rows [")}
        for key in ("device_ms", "library_device_ms", "library_deterministic_ms",
                    "library_deterministic_device_ms", "host_us"):
            if key in t:
                entry[key] = t[key]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print("sharded: " + json.dumps(sharded), flush=True)
    print("sp: " + json.dumps(sp), flush=True)
    print("pv: " + json.dumps(pv), flush=True)
    print("elastic: " + json.dumps(elastic), flush=True)
    print("dp: " + json.dumps(dx), flush=True)
    print("pod: " + json.dumps(pod), flush=True)
    print("pod moves: " + json.dumps(moves), flush=True)
    print("pod chains: " + json.dumps(pod_chains), flush=True)
    print("pod elastic: " + json.dumps(pod_elastic), flush=True)
    print("pod data rows: " + json.dumps(pod_data), flush=True)
    print("ha: " + json.dumps(ha), flush=True)
    print(gpu_identity())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
