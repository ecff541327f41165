#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase's error is
caught:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   exits non-zero when ``torch.cuda.is_available()`` is false.
2. build: nvcc builds every ``src/repro_torch/kernels/csrc/*.cu`` for
   sm_90a into ``build/`` (one nvcc per source, all started together;
   flash_attention, flash_attention_bwd and paged_decode link libcuda for
   their TMA maps); the ptxas report of K6's wgmma kernel, of K7's two
   (dK/dV and dQ) and of K8's TMA-route kernel at head dims 64, 128, 256
   (registers, spills, stack) beside their dynamic shared memory, and of
   K9's kernel for each dtype and threads a channel; K7's and K8's must
   show no spills and no stack, K9's falcon-mamba instantiation (bf16 and
   f32 at 4 threads a channel) no spills; the ``ptxas K1`` and ``ptxas
   K2`` lines (the binned route's kernels: registers, spills, stack,
   shared memory; none may spill); the ``ptxas K4`` line (both
   instantiations of the chunk-table gather; no spill, no stack); the
   ``ptxas K9-bwd`` line (every dtype and threads a channel, and the
   reduce kernel; falcon-mamba's, bf16 at 4 threads a channel (N = 16),
   must not spill).
3. parity: K1–K3 against their plain PyTorch versions on the card,
   bit-exact (tolerance 0: the results are packed words and integer
   counts), K1 and K2 through their wrappers and on each route
   (``binned``, ``atomic``), out of place and in place — edge cases at
   small widths and at W = T − 1, T, T + 1, 2T + 1 (T = 4096 words, the
   binned route's tile) with targets on the first and last field of every
   tile, misaligned words and targets; three planted faults of the binned
   route (copies of its source with one line changed, built here), each
   of which must break bit-exactness: one bin's last target dropped, one
   offset sent to the neighbouring tile, the tail tile's count skipped;
   then W = 29,937,600 words (12! states) with the real level-6 targets
   of pancake n = 12, K1 in place vs out of place.
4. times: CUDA events, median of 20 launches, at those n = 12 shapes, beside
   the byte bound at 3.35 TB/s and the plain version's time; then K1 and
   K2 on each route at every level of n = 12 (``phase_k12_levels``), each
   held bit for bit to the plain version (the targets in chunks, the
   widest level's 1.86e9 included) and timed beside its byte bound (8W +
   4M) and the bytes its design moves, with the sums over a fused BFS, an
   unfused one and a publish.
5. main path: pancake n = 12 through ``repro_torch.apps.pancake_bits.run``,
   fused (the default: 15 levels summing to 12!, diameter 14, K1 launched
   15 times, K2 once, K3 never), then unfused (K2 16 times, K3 15 times;
   the same levels and bit-identical words); every K1 and K2 launch on
   the route ``bitpack.route`` names for its (W, M) (by
   ``ROUTE_LAUNCHES``); wall, states/s and peak of each.  Launch counts
   are set to 0 just before each run and read just after; the
   ``kernels`` line adds the two runs up.
6. fused ≡ unfused at n = 11 (bit-identical words), kernels ≡ plain
   versions at n = 9, both on the card.
6b. the sorted-list BFS (``phase_sorted_bfs``; no kernel of its own:
   torch sorts): first pancake n = 8 on the card == on the CPU (levels
   and ``all.data``), which also loads the sort kernels before the timed
   runs; pancake n = 11 through ``apps.pancake_bfs.run``, fused and
   unfused, with the level sizes of ``apps.pancake_bits.run(11)``,
   diameter 13, 11! rows in ``all``, each once, and the unfused ``all``
   == the fused one bit for bit; Cayley n = 11 through
   ``apps.cayley_bfs.run`` (the Mahonian profile, also from the implicit
   engine over the same graph, diameter 55).  Each timed run starts from
   an empty allocator cache and prints its wall, states/s beside the
   implicit engine's, peak device memory (reset just before), its
   lexsorts and scatters a level (1 and 1 fused, 2 and 2 unfused, checked
   for every level), the ``bfs.level`` / ``bfs.expand`` span totals, the
   widest level's ms and the allocator's device allocations and retries;
   one ``{"sorted_bfs": …}`` line.
6c. Tier D (``phase_disk_tier``), in temporary directories on the
   machine's disk: first pancake n = 8 in chunks of 1,000 fields (250
   bytes: every chunk ends inside a word), fused and unfused, on the card
   and on the CPU, the two workdirs the same bytes; then the in-memory
   engine at n = 11 (its wall and peak) and a plain distance table built
   on the card, which gives the level sizes and the marks each level
   sends to each chunk; then the main path, ``apps.pancake_bits.run_disk``
   at n = 11 (39 chunks of 2^20 fields, the reference's ``log_buf_rows``
   and ``expand_batch``), every count set to 0 just before each run and
   read just after: fused (K1 39 x 14 = 546, each on the route
   ``K.route`` names for its chunk's log; no K2, K3); then at n = 10
   (``DISK_SIDE_N``; n = 11 before ``phase_mesh_train`` came, cut for its
   time), against its own distance table and in-memory engine, unfused
   (K3 a chunk a level, K2 one per (chunk, pass) with a log, by route),
   and with rle2 chunks stopped after level 6 with checkpoints every 3
   levels, then resumed (K1 a chunk a level over the two); each with the
   level sizes of the in-memory engine, and fused with one read-write
   array traversal a
   level to the byte, 16 B of op log a mark, its peak device memory
   within the printed bound (one chunk, its largest log, one expansion
   batch measured on the card) and below the in-memory engine's; the
   level-6 checkpoint's chunks == the in-memory words after 6 levels;
   K1 and K2 on that checkpoint's chunks and logs (the largest log, an
   empty one, the last chunk) on both routes against their plain
   versions, K1's count over the chunk's own fields; level 7's pass from
   that checkpoint through the kernels == through their plain versions
   on the card (chunks and logs byte for byte); wall, states/s, the bytes
   of the array and the log read and written, the time in ``pass.rw``,
   K1 (CUDA events), K2, K3 and the log writes and reads of each run;
   then the sorted disk BFS at n = 9 on the host against the Tier J
   sorted engine's level sizes, ``quickstart.tier_d_tour`` and
   ``apps.outofcore_setops``; one ``{"disk_tier": …}`` line.
6d. Tier D, sharded (``phase_disk_sharded``): ``core.disk.implicit_bfs``
   over a ``ShardRuntime`` built by the script, each shard's block of the
   2-bit array on the card, every count set to 0 just before each run and read
   just after (the spawn workers' counts come home through the runtime's
   counter deltas): (a) pancake n = 11 over 4 spawned shards, fs wire,
   barrier exchange, chunks of 2^20 — the in-memory level sizes, every
   state DONE, K1 4 x 10 x 14 = 560 times and nothing else, per shard one
   pass a level and no sort, the op log 16 B a mark (6,386,688,016 B, the
   single-process run's), each mark at its owner once (local + remote =
   the marks), the wire's bytes out == in, no drop; the wall, states/s,
   each worker's peak device memory, K1's CUDA-event ms in the workers,
   their log and bucket I/O seconds; (b) the same at n = 10 over 2 shards
   (n = 11 until PR 30: cut for ``phase_mesh``'s time); (c) at n = 10: 4
   shards with the pipelined exchange, the
   TCP wire (spawn) under a trace whose JSONL reads back through
   ``trace.report_json`` with one row a level, each with spans of every
   shard, the loopback wire (inline), and ``worker_level:kill:shard=1:
   level=4`` with checkpoints every level and one recovery, healed to the
   exact level sizes; (d) at n = 9 over 2 shards (chunks of 2^16), K1
   against its plain version on the card: every shard's chunks, op logs
   and pending bucket files the same bytes at level 5 and at the end, and
   the final words the single-process search's; (e) the sorted engine on
   (a)'s 4 spawned workers at n = 9 (10 until PR 30), on the host, against
   the Tier J sorted engine; one ``{"disk_sharded": …}`` line.
7. K4 (the 2-bit gather over a chunk table) and the distance oracle
   (``phase_oracle``):
   a. K4's flat form bit-exact against its plain version at the JAX tests'
      (W, M) (indices in [-50, 16W + 50)), misaligned, and empty (no
      launch), all-negative and all-past-the-end batches; its chunked form
      at the same shapes, in chunks of 16W fields, of whole words, of
      words shared between chunks and of 100 fields, ranks at every chunk
      boundary, misaligned, with null entries (their bytes kept), and the
      divide at chunks of 2^40 + 7 fields; the chunked plain version ==
      the flat one over the joined words;
   b. main path of the serving tier, every count set to 0 just before
      and read just after: ``apps.pancake_bits.publish`` (n = 12, 16
      chunks; ``label_distances_mod3`` on the card, K1 15, K2 16, K3 4
      times, each K1 and K2 launch on the route ``bitpack.route`` names:
      level sizes == the BFS's, diameter 14, the per-code counts
      hold), a ``DistanceOracle`` that holds the artifact,
      ``codes`` (one K4 launch over the chunks the batch touches),
      ``paths`` and ``distance`` of 4096 ranks (at most diameter + 1 = 15
      launches a batch), every path held structurally (length d + 1,
      neighbours, ends at the start); what each K4 call of the run wrote
      held bit for bit to the plain version on its table, and the codes
      to the plain gather over the label words joined from the chunks;
   c. K4 over those 16 chunks at M = 4096 and 1,048,576 random ranks (and
      every chunk boundary), bit-exact against its plain version and the
      flat plain gather over the joined words, a planted fault (one field
      of one chunk flipped) caught, a null chunk's bytes kept, and its
      device time (a fresh batch each repetition) over a prebuilt device
      table and through the wrapper, beside its bound (bytes: 9M plus 32 B
      for each distinct sector the batch touches), the flat form's time
      over the joined words and the plain version's;
   d. queries/s and K4 launches a batch of ``codes`` (M = 4096 and
      1,048,576: one launch a batch), ``distance`` and ``paths`` (M =
      4096); at 20% of the artifact the codes held again and K4 launched
      once per ascending group of chunks within the budget (6 for 16
      chunks), with the ``oracle`` counters and resident_peak <= budget;
      the rle2 publish (identical chunk_sha256 and codes);
   e. n = 10: the labels through the kernels == through their plain
      versions on the card (``impl="ref"``: levels and words) == the
      published chunks; ``distance`` of all 3,628,800 ranks == a plain
      BFS distance table made on the card.
8. K5 (the segment scatter-add) and the Roomy delayed-update structures
   (``phase_roomy``):
   a. K5 against its plain version on the card, atol = rtol = 1e-4
      (``tests/test_kernels.py:150-151``): the JAX tests' (N, M, D),
      sorted and unsorted, idx in [-N-3, N+3); one run of 100,000 ops and
      of 257 (sixteenths of small integers: bit-exact in any order); one
      op an index, negatives included (bit-exact); M = 0 (no launch); every
      index dropped; D = 1 and 2304; a table and a payload as strided
      views; a planted fault (a payload row left out) the limit rejects;
   b. main path: gemma2-2b's embedding gradient as a RoomyArray (256,000 x
      2304 float32 from the seed), a queue of 131,072 token rows (a 32 x
      4096 batch) with Zipf ids (s = 1.1) and N(0, 1) payloads, through
      ``array.update`` then ``array.sync(add, add, pred)`` with every count
      set to 0 just before: K5 launched exactly once; per row within 1e-4
      of the same sync with ``impl="ref"`` (two float32 sums of a
      17,000-op run differ by ~1e-3 elementwise; rows of runs <= 256 ops
      are held to 1e-4 elementwise), pcount equal; wall, ops/s, peak; K5
      on that sorted queue against its plain version, ``index_add`` and a
      float64 sum per row, with a planted fault (a row left out); its time
      (CUDA events, median of 20) beside the byte bound, the plain version
      and ``torch.index_add``;
   c. ``parallel_prefix(add)`` over 2^27 float32: 27 K5 launches,
      bit-identical to ``impl="ref"``, within 2e-6 relative of a float64
      cumsum; ``chain_reduce(add)``: 1 launch, exact;
   d. ``hashtable`` with 4,194,304 width-2 keys (insert, sync with the
      benchmark's add combine, remove, insert, sync, lookup): keys, values,
      count and lookups identical to the same calls on the CPU;
   e. the sharded path on a one-rank NCCL group from a FileStore:
      ``bucket_sync_update`` with a K5 owner apply (the local row as int32
      bits in an extra column) == the unsharded sync per row within 1e-4,
      ``dropped`` exact at half capacity; ``sharded_mark_sync`` with K2 ==
      ``mark_packed`` bit for bit.
9. K6 (flash attention) parity against its plain version on the card,
   each case's route asserted (``flash_attention.route``: the wgmma
   kernel, TMA + warp specialisation, for bfloat16 at head dims 64, 128
   and 256; the classic mma.sync / FMA kernels for float32 and the other
   head dims),
   float32 (atol = rtol = 2e-5, never TF32) and bfloat16 (2e-2), the
   tolerances of ``tests/test_kernels.py:41-42,57-58``, and per (batch,
   head) ‖got − want‖ ≤ 1e-2 ‖want‖; K6 with its LSE output gives the
   same output bit for bit and an LSE within 2e-5 (f32) / 1e-3 (bf16)
   absolute of ``attention_lse_ref``: every case of
   ``tests/test_kernels.py:16-26``, head_dim 256 with window 4096 and
   softcap 50 at Sq = Skv = 4100 with GQA 1, 2 and 4, Sq = 1, head_dim 12
   and 100, rows that see no key; the wgmma route's edges: head dims 64
   and 128 at groups 1, 6 and 48, Sq 1, 127, 129 and 4100, Sq != Skv with
   rows that see no key, windows of 37, 45, 100 and 203 keys (a multiple
   of no tile); contiguous and as strided views.
10. gemma2-2b FULL in bfloat16, params from ``lm.init_params`` on a seeded
   generator (``phase_lm``):
   a. main path: ``lm.prefill`` over 1 × 32768 tokens (``prefill_32k``
      with its global batch of 32 cut to 1), nothing wrapped around it,
      launch counts set to 0 just before and read just after: K6 launched
      26 times, once a layer, every launch on the wgmma route (its route
      counter); tokens/s, wall, peak memory;
   b. the same prefill again, with q/k/v of layer 0 (local) and layer 1
      (global) captured and K6 timed by CUDA events (its share of a.'s
      wall); K6 parity on the captured layers by both checks, and two
      planted faults the per-(b, h) check must reject (the local window
      one 32-key tile short; the global output zeroed past row 4096);
   c. K6 times at those two shapes (CUDA events, median of 20; the wgmma
      route) beside the bound (max of flops at 989 TFLOP/s and bytes at
      3.35 TB/s) and the plain version's time; at the global shape the
      library call (``library_ms``): ``flex_attention``, compiled, with the
      softcap as its score_mod, held to K6's per-(b, h) limit against K6,
      and K6 must be the faster; SDPA with the softcap off, against K6
      with the softcap off;
   d. the same prefill with the plain attention: last logits agree (per
      row ‖a − b‖ ≤ 3.5e-2 ‖b‖); K6 prefills with planted attention faults
      (every local window a tile short; a global layer given the local
      window) must break that limit;
   e. K8 on the decode's first step, its global layers 1 and 25 captured
      and held to the plain version, and timed at layer 1 beside its
      bound and its plain version (softcap 50: no library call computes
      it); 16 ``decode_step``s from the prefill's caches (decode tokens/s;
      K8 launched 13 times a step, once a global layer, all on the TMA
      route, counted after every step; the 13 local layers gather
      their cache for the plain windowed decode), then one prefill and 4
      decode steps under ``torch.profiler``: device time by kernel group
      and the device's idle share;
   f. prefill-then-decode ≡ stepwise decode on a 64-token prefix, in
      bfloat16 and in float32;
   g. ``python -m repro_torch.launch.serve --arch gemma2-2b`` with its
      defaults: 4 requests, 8-token prompts, 12 new tokens each (43 decode
      steps, 13 K8 launches each).
11. K7 (flash-attention backward) parity against its plain version:
   every case of ``tests/test_kernels.py:332-339``, head_dim 256 with
   window 4096 and softcap 50 at 8192 rows with GQA 1, 2 and 4, the train
   shape, Sq != Skv, rows that see no key, head_dims 12 and 100, and the
   dense configs' layouts (head 128 at groups 6 and 48, head 64 at group
   1); float32
   elementwise 3e-4, bfloat16 per (batch, head) 1e-2 for each of dq, dk,
   dv; contiguous and strided; each call on the route its dtype and head
   dim call for (by ``BWD_ROUTE_LAUNCHES``: bf16 at head dims 64, 128,
   256 on the wgmma route, the rest classic); two runs give the same bits;
   the bf16 check also holds at logits of std 16 and 4; three planted
   faults, each with finite output, must break the bf16 limit 2x: the
   backward without the softcap at logits of std 4, without the term D =
   rowsum(dO ∘ O), and with the window one 32-key tile short.
12. K7 and K6-with-LSE times (K6 on the wgmma route) at the train shape
   and at 8192 rows with the window cutting, beside the bound, the plain
   version and the library call (``flex_attention``, compiled: its
   backward alone, and its forward with the LSE; each held to the
   kernel's limits against the kernel; at the train shape K6-with-LSE
   and K7 must each be the faster); K7's route and its TFLOP/s under 10·D
   and 14·D flops a visible pair; with the softcap off,
   scaled_dot_product_attention's backward and forward beside K7 and
   K6-with-LSE; K7 beside SDPA's backward at the nemotron-4-15b,
   granite-34b and minicpm-2b layouts (1 × 4096).
13. gemma2-2b training (``phase_training``):
   a. main path: ``runtime.train_loop.train`` on FULL, float32 master
      params and bfloat16 compute, remat on, 1 × 4096 tokens a step
      (``train_4k`` with its global batch of 256 cut to 1), 6 steps,
      nothing wrapped around the loop, launch counts set to 0 just before
      and read just after: each step (its ``train.step`` span) launches
      K6-with-LSE 52 times, all on the wgmma route, K7 26 times, all on
      the wgmma route, and K6 without LSE never; losses,
      median step time of steps 1-5, tokens/s, peak memory;
   b. one call of the step function (``make_train_step``: gradient, then
      the AdamW update) under ``torch.profiler``: device time by group
      (the update's kernels as the optimizer group) and the idle share;
   c. one step's gradient through the kernels and through the plain
      versions from the same params and batch: each leaf's ‖Δ‖/‖g‖ within
      ``GRAD_REL_TOL``, their median within ``GRAD_MEDIAN_TOL``; planted
      faults in the backward read the same way, and two (every local
      window halved; D = rowsum(dO ∘ O) dropped) must break the limit;
   d. SMOKE (float32, head_dim 12: K6 on the classic route) on the card:
      the loss decreases over 15 steps, and a crash at step 7 with a
      checkpoint every 3 steps replays to the uninterrupted final loss
      within rtol 1e-5.
14. K9 (selective scan) and falcon-mamba-7b (``phase_falcon_mamba``):
   a. K9 parity against its plain version (the sequential form, with the
      final state) on the card: the cases of ``tests/test_kernels.py:
      85-90`` (L = 100 unaligned) and ``:112-127``, SMOKE's Di 64 / N 4,
      the model's Di 8192 / N 16, one step, ragged Di and N; float32
      (atol = rtol = 1e-4) and bfloat16 (5e-2), contiguous and strided,
      with and without the state (y the same bits); y and h also per
      (batch, 32-channel tile) ‖got − want‖ ≤ 1e-2 ‖want‖, which three
      planted faults with finite output must break (the state reset every
      128 steps, D·x dropped, A's decay off by one state); every case also
      against the mirror of the kernel's own order of sums
      (``ref.mamba_scan_segmented``), per tile within 1e-5 (h, and y for
      float32 inputs); h is no longer the plain version's bits (time is
      summed in segments), which the run reports;
   b. FULL in bfloat16, params from ``lm.init_params`` on a seeded
      generator; main path: ``lm.prefill`` over 1 × 32768 tokens
      (``prefill_32k``, global batch 32 cut to 1), nothing wrapped around
      it, launch counts set to 0 just before and read just after: K9
      launched 64 times; tokens/s, wall, peak memory;
   c. the same prefill again with layer 0's and layer 63's scan inputs
      captured and K9 timed by CUDA events (its share of b.'s wall); K9
      against the plain version over all 32768 steps of both layers, with
      the state, by both checks, and the planted faults there;
   d. K9 at that shape (median of 20) beside its bound (the largest of
      the exponentials at 16 a clock per SM, the f32 FMAs at 67 TFLOP/s
      and the bytes at 3.35 TB/s) and the plain version (median of 3); no
      library call computes a selective scan;
   e. 16 ``decode_step``s from b.'s states (K9 launched 0 times), then one
      prefill and 4 decode steps under ``torch.profiler``;
   f. ``forward_hidden`` + ``logits_fn`` over 1 × 4096 tokens (K9 launched
      64 times);
   g. the same prefill through K9 and through the plain scan at full
      width and depth over 1024 tokens: the last logits agree per row
      (1e-2); K9 prefills with planted faults in every layer are read the
      same way, and D dropped must break the limit;
   h. stepwise decode ≡ the forward column by column on a 64-token
      prefix, and prefill-then-decode ≡ stepwise decode, in bfloat16 and
      in float32;
   i. ``python -m repro_torch.launch.serve --arch falcon-mamba-7b`` with
      its defaults.
15. K8 (paged decode attention) and the dense configs (``phase_dense``):
   a. K8 parity against its plain version on the card: the cases of
      ``tests/test_kernels.py:402-406``, groups 1, 2, 6 and 48 at head
      dims 64, 128 and 256, pages of 8, 16, 64, 128 and 256, the four
      models' layouts, a whole 32k table, head_dim 12; shuffled tables
      with spare pages; lengths 1, a page, a page and one, the whole table
      and 0; float32 (atol = rtol = 2e-5) and bfloat16 (2e-2, and per
      (batch, query head) 1e-2 of the output's norm); each call on the
      route its dtype, head dim and page size call for (by
      ``paged_decode.ROUTE_LAUNCHES``: bf16 at head dims 64, 128, 256 with
      pages of a multiple of 64 tokens on the TMA route, the rest
      classic); the same bits twice, and with garbage table entries past
      each length; on each route four planted faults that must break the
      per-(b, h) limit (the table ignored, the mask off by one, the
      softcap dropped, one split's partials dropped in the merge), and
      the two stages launched apart give the one launch's bits; two TMA
      launches at once on two streams, ten times over, each == the call
      alone and held to the plain version, with a ticket buffer a stream
      and every ticket back at 0;
   b. nemotron-4-15b FULL in bfloat16, params from ``lm.init_params`` on a
      seeded generator: ``lm.prefill`` over 1 × 32768 tokens (32 K6
      launches, all on the wgmma route, no K8); the prefill again with
      layer 0's q, k, v captured and K6's share of the wall; K6 there
      (1 × 48 × 32768 × 128, 8 kv heads) held to its plain version and
      timed beside its bound, the plain version and
      scaled_dot_product_attention(is_causal=True, enable_gqa=True), the
      same function; one decode step with layers 0 and 31 captured,
      K8 held to the plain version there and timed at layer 0 beside its
      bound (the live K/V bytes at 3.35 TB/s), the plain version and
      scaled_dot_product_attention(enable_gqa=True) with and without the
      gather through the table; the main path of K8: 16 ``decode_step``s
      at batch 1 with every count set to 0 just before, exactly 32 K8
      launches after each step, every one on the TMA route; 4 decode
      steps under the profiler; the
      last logits of a 2048-token prefill with K6 and with the plain
      attention (per row 3.5e-2), and K6 prefills with planted faults
      (every window cut to 16 keys must break it); prefill-then-decode ≡
      stepwise in bfloat16; a batched decode at batch 8 (``decode_32k``'s
      global batch of 128 cut to what the card holds beside 31.3 GB of
      params) over 32k-token caches of seeded random K/V under shuffled
      tables with ragged lengths, donated to each step (K8 on layer 0
      there against the plain version and timed beside SDPA with a mask
      past each length, with and without the gather; 16 steps, 32 K8
      launches a step, all on the TMA route, step time and tokens/s); the
      same equivalence in
      float32 (the params converted in place); ``launch/serve.py --arch
      nemotron-4-15b`` with its defaults;
   c. minicpm-2b FULL in bfloat16 (MHA, head_dim 64): a 4096-token
      prefill (40 K6 launches, all on the wgmma route), K8 on a captured
      decode layer and its time, 16 decode steps (40 K8 launches a step,
      all on the TMA route), the Server.
16. the MoE and hybrid families (``phase_moe_hybrid``), bf16, params from
   ``lm.init_params`` on a seeded generator:
   a. granite-moe-3b-a800m FULL (40 experts padded to 48, top-8; K6 and
      K8 at head dim 64, group 3): the 1 × 32768 prefill with exactly 32
      K6 launches, all wgmma; K6 on captured layer 0 against its plain
      version, timed beside its bound and SDPA(enable_gqa); the MoE
      layer's share of the prefill wall by CUDA events and the count of
      (token, choice) pairs dropped at the reference's capacity; K8 on a
      captured decode layer against its plain version and timed; 16
      decode steps with exactly 32 K8 launches a step, all tma; the
      profile of a prefill and of 4 decode steps; ``launch/serve.py
      --arch granite-moe-3b-a800m``;
   b. zamba2-1.2b FULL (38 mamba2 layers, the shared block 6 times; K6
      and K8 at MHA 32 x 64): the 1 × 32768 prefill with exactly 6 K6
      launches and no K9 (the SSD form), K6 on a captured application,
      K8 likewise, 16 decode steps with exactly 6 K8 launches a step, the
      profile; one ``forward_hidden`` over 1 × 4096 with
      ``mamba2_use_ssd=False``: exactly 38 K9 launches at N = 64, K9 on
      the captured layer 0 against its plain version (under K9_TOL and
      the per-tile limit, and the mirror of its order of sums) and timed
      beside its bound, with the ptxas line of its N = 64 instantiation;
      prefill-then-decode ≡ stepwise in float32 (the params converted in
      place) within 2e-3; the Server;
   c. phi3.5-moe-42b-a6.6b at full width and 8 of its 32 layers (83.7 GB
      whole; 8 layers are 21.3 GB; K6 and K8 at head dim 128, group 4):
      a 1 × 4096 prefill with exactly 8 K6 launches, K6 on a captured
      layer and its times, the MoE share and drops, K8 on a captured
      decode layer and its time, 16 decode steps with exactly 8 K8
      launches a step, the profile.
17. training the ssm, MoE and hybrid families
   (``phase_training_families``):
   a. K9-bwd (the selective scan's backward) against its plain version
      from the same chunk states (per output ‖Δ‖/‖want‖ ≤ 1e-5) and
      against autograd of the mirror of K9's order of sums (1e-4 float32,
      1e-2 bfloat16) and against the mirror of its own order of sums
      (``ref.mamba_scan_bwd_segmented``, the plain version's limits),
      K9's y the same bits with and without its chunk states, two
      launches the same bits: one step, 31, 32, 33, 37 and 4101 steps, N
      of 1, 4, 16 and 64, channels no multiple of the block's, channel
      tiles no multiple of the cluster, batch 3, strided inputs, the
      decay near 1 and a large dt, the model's Di, each in float32 and
      bfloat16; six planted faults (copies of its source with one text
      changed, built here) must break the limit: the adjoint carried
      across a chunk boundary dropped, exp(dt_t·a) where exp(dt_{t+1}·a)
      belongs, db's sum over the clusters without the last cluster, the
      second segment's w_in dropped, a chunk walked on the other stage,
      rank 0's part left out of the cluster's sum;
   b. K9-bwd's time at falcon-mamba's train layer (1 × 4096 × 8192, N 16)
      and zamba2's K9-form layer (1 × 4096 × 4096, N 64), beside the
      bound (the largest of the exponentials, 10 f32 FMAs a (t, i, j) and
      the bytes) and the plain version;
   c. main path of each family: ``runtime.train_loop.train`` (float32
      master params, bfloat16 compute, remat on, 1 × 4096 tokens a step,
      6 steps), every count set to 0 just before and read just after, the
      launches of each ``train.step`` span exact: falcon-mamba-7b at 32 of
      64 layers (K9 64 and K9-bwd 32 a step), zamba2-1.2b FULL (the SSD
      form: K6-with-LSE 6 and K7 6 a step, no K9), granite-moe-3b FULL
      (K6-with-LSE 64, K7 32 a step), every K6-with-LSE and K7 launch on
      the wgmma route; losses, median step of steps 1-5, tokens/s, peak;
      a step under the profiler (device time by group, idle share);
      granite's (token, choice) pairs dropped on the train batch;
   d. one step's gradient through the kernels against the plain versions
      (``kernels="ref"``), the loss and per leaf ‖Δ‖/‖g‖, the largest within
      5e-2 (zamba2 0.2, granite-moe 1.0, musicgen-medium 0.5:
      ``FAMILY_GRAD_TOL``) and the median
      within 0.1: falcon-mamba at full width, 2 layers and 1 × 512 (the
      plain scan walks time in Python), with K9-bwd's planted faults in
      every layer read the same way (the dropped carry must break the
      limit); zamba2 and granite at the main path's depth and batch, with
      K7 without D = rowsum(dO ∘ O) in every layer, which must break it;
      zamba2's and granite's witnesses (``grad_witnesses``: the kernels'
      gradient no farther from the float32 plain gradient than 1.5 times
      the plain bf16 one is, worst leaf and median, granite's read only;
      K7 alone in the chain, the forward plain, within 5e-2, which the
      drop-D fault must break);
      one zamba2 block in the K9 form (N = 64, one K9 and one K9-bwd
      launch) against the same block through the plain versions.
18. the frontend-stub families (``phase_frontend``): musicgen-medium
   (audio: MHA 24 x 64, non-gated GELU) and qwen2-vl-2b (vision: 12 query
   heads over 2 kv heads at head dim 128, M-RoPE) FULL, every input the
   codebook rows (``data.pipeline.codebook``) of seeded token ids:
   a. served in bfloat16: the 1 × 32768 prefill with exactly 48 / 28 K6
      launches, all wgmma; K6 on captured layer 0 against its plain
      version and timed beside its bound and SDPA(enable_gqa); a 2048-token
      prefill with K6 and with the plain attention (per row 3.5e-2; every
      window cut to 16 keys must break it); for qwen, a prefill over 512
      text tokens and a 64 × 64 patch grid (t fixed, h and w running: the
      streams differ) held to the plain prefill on the same positions,
      the same inputs at text positions and a wrong band split (24, 24,
      16) must break the rule; K8 on a captured decode layer and its
      times; 16 greedy decode steps, each fed the codebook row of the last
      token, with exactly 48 / 28 K8 launches a step, all tma; 4 steps
      held to the plain paged decode per row; the profile (prefill and 4
      decode steps: the idle share);
   b. trained through ``runtime.train_loop.train`` (float32 master params,
      bfloat16 compute, remat, 1 × 4096, 6 steps): K6-with-LSE 96 / 56 and
      K7 48 / 28 a ``train.step`` span, all wgmma; a profiled step; the
      gradient through the kernels against the plain versions (5e-2 a
      leaf; musicgen's wq and wk 0.5, ``FAMILY_GRAD_TOL``), with K7
      without D in every layer, which must break it, and the witnesses as
      zamba2's (17d); the host's CPU seconds beside the wall of a train
      step and of the decode steps, and the kernel launch calls the
      profiled ones made;
      K6-with-LSE and K7 at the train layout held to their plain versions
      and timed beside their bounds, plain versions and SDPA;
   c. ``DiskTokenStream`` on the host: six chunks of 256 × 4097 uint32
      tokens written into a ``ChunkStore`` in a temporary directory and
      read back bit for bit against ``synth_tokens``, MB/s each way.
18b. serving on a device mesh (``phase_mesh``): a one-rank NCCL world as
   the (1, 1) ("data", "model") mesh of ``launch.mesh.make_host_mesh``,
   granite-moe-3b FULL in bfloat16 with the roomy embedding and the
   roomy MoE: the 1 × 4096 prefill at capacity factor 8 on the mesh and
   with none (0 pairs dropped either side, counted; K6 32 a side, all
   wgmma; the last logits within the limit); the roomy embedding of a
   1 × 32768 prompt == the take, bit for bit; 16 decode steps at batch 8
   (``_paged_decode_batched``: K8 32 a step, all tma) and at batch 1
   (``_paged_decode_cp``: no K8) after 8 tokens, each greedy step of the
   run with no mesh again on the mesh from the same cache: the logits of
   every step within the limit, the same tokens (a tie within the two
   runs' difference excused, counted), and the mesh's own decode,
   teacher-forced, its drift read; three planted faults that must break the
   limit (the MoE combine without its weights, the batched append one
   position late, the context-parallel mask one position short); the
   1 × 32768 prefill at the config's capacity factor on and off the mesh
   (tokens/s, drops, the MoE share), the decodes' tokens/s.  On one rank
   the exchanges are identities: their faults show only in the CPU
   worlds of ``tests/test_torch_mesh.py``.  A float32 witness of the CP
   gate: the model in float32 at 2 layers, each step of the plain run
   with no mesh again through ``_paged_decode_cp``, within CP_F32_TOL a
   row, the planted CP-mask fault at least 10x it.
18c. training on a device mesh (``phase_mesh_train``): (a) a one-rank NCCL
   world as the (1, 1) mesh, granite-moe-3b at its published widths and
   16 of 32 layers, roomy MoE and roomy embedding at capacity factor 8:
   three train steps of 1 × 4096 (``runtime.train_loop.make_train_step``
   with the mesh: params and AdamW state as ShardingRules shards) against
   the same config with no mesh, step 0's loss bit for bit, the gradient
   at the seed's params within MESH_TRAIN_GRAD_TOL a leaf, the launches a
   ``train.step`` span (K6-LSE 32, K7 16 each side, K5 once on the mesh:
   the roomy embedding's gradient fold, none off it), the reverse
   all-to-all's backward zeroed as a planted fault; readings: the step
   times and peaks, the MoE's share of a step by CUDA events, a profiled
   step's idle share, and K5's fold against its plain version and
   ``torch.index_add`` at the step's shape; (b) a two-rank gloo world of
   spawned processes on the one card (the only exchange this machine can
   make that is not an identity): 2 layers at full width on (1, 2) and
   (2, 1), loss and per-leaf gradient against the one-device run, K6-LSE,
   K7 and K5 on each rank, ``tp`` left out of the loss share and the
   local mask count as planted faults.
19. the ``to_port`` line (an empty list: every kernel is ported), the
   ``kernels`` JSON line (K1–K9, K6-with-LSE, K9-bwd; K1's, K2's and
   K3's launches, routes and summed times on the disk route; K6's and
   K6-with-LSE's entries name the kernel that ran, their launches by
   route and the ptxas report; K6's, K8's and K9's launches on the MoE,
   hybrid, frontend and mesh paths; K6-with-LSE's, K7's and K9's on the
   training paths, and with K5's a mesh train step; K5's fold times; the
   frontend layouts' times), the card line, and last
   ``{"ok": true, "device": {...}}``.
"""
import contextlib
import ctypes
import itertools
import json
import math
import os
import resource
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.apps import cayley_bfs as CB  # noqa: E402
from repro_torch.apps import pancake_bfs as PB  # noqa: E402
from repro_torch.apps import pancake_bits as P  # noqa: E402
from repro_torch.core import array as RA  # noqa: E402
from repro_torch.core import bitarray as BA  # noqa: E402
from repro_torch.core import constructs as C  # noqa: E402
from repro_torch.core import delayed as DL  # noqa: E402
from repro_torch.core import hashtable as HT  # noqa: E402
from repro_torch.core import obs  # noqa: E402
from repro_torch.core import types as TY  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bitpack as K  # noqa: E402
from repro_torch.kernels import bucket_scatter as BS  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as FAB  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels import paged_decode as PD  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.data.pipeline import (DiskTokenStream,  # noqa: E402
                                       batch_to_torch, codebook, make_batch,
                                       synth_tokens)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.core import paged  # noqa: E402
from repro_torch.core.disk import oracle as O  # noqa: E402
from repro_torch.core.disk import bfs as TDD  # noqa: E402
from repro_torch.core.disk import bitarray as TDB  # noqa: E402
from repro_torch.core.disk import checkpoint as TDCK  # noqa: E402
from repro_torch.core.disk import codec as TDC  # noqa: E402
from repro_torch.core.disk import config as TDCF  # noqa: E402
from repro_torch.core.disk import extsort as TDX  # noqa: E402
from repro_torch.core.disk import buckets as TDBK  # noqa: E402
from repro_torch.core.disk import cluster as TDCL  # noqa: E402
from repro_torch.core.disk import faults as TDF  # noqa: E402
from repro_torch.core.disk import trace as TDTR  # noqa: E402
from repro_torch.core.disk import transport as TDTP  # noqa: E402
from repro_torch.apps import outofcore_setops as SO  # noqa: E402
from repro_torch.apps import quickstart as Q  # noqa: E402
from repro_torch.models import blocks as BL  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import layers as LAY  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.core import sharding as SHD  # noqa: E402
from repro_torch.runtime import (FaultInjector, TrainSettings,  # noqa: E402
                                 make_train_step, train)
from repro_torch.runtime import train_loop as TL  # noqa: E402
from repro_torch.runtime.train_loop import loss_and_grads  # noqa: E402
from repro_torch.distributed import sharding_rules as SR  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
REPS = 20
LEVEL = 6                     # the n = 12 level whose targets set M
ROTATE = BA.ROTATE_LUT
LUTS = [(ROTATE, BA.CUR), (K.make_lut([0, 0, 2, 1]), 0),
        (K.make_lut([3, 2, 1, 0]), 3), (K.make_lut([1, 1, 1, 1]), 1)]
MARKS = [(2, 0), (1, 0), (3, 1), (0, 2), (2, 2)]
SOURCE = "src/repro_torch/kernels/csrc/bitpack.cu"
TILE = K.TILE_WORDS           # the binned route's tile of words
K12_ROUTES = ("binned", "atomic")
KERNELS = [  # (launch-counter name, TPU wrapper that reaches pallas_call)
    ("mark_rotate_count", "src/repro/kernels/bitpack.py:268"),
    ("scatter_mark", "src/repro/kernels/bitpack.py:184"),
    ("lut_count", "src/repro/kernels/bitpack.py:90"),
]
MAX_ERR = {name: 0 for name, _ in KERNELS}
MAX_ERR.update(gather2=0, flash_attention=0.0, flash_attention_lse=0.0,
               flash_attention_bwd=0.0, mamba_scan=0.0, mamba_scan_bwd=0.0,
               paged_decode_attention=0.0, bucket_scatter_add=0.0)
MAX_REL = {"flash_attention": 0.0, "flash_attention_bwd": 0.0,
           "mamba_scan": 0.0, "mamba_scan_bwd": 0.0,
           "paged_decode_attention": 0.0}
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
K6_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py:41-42,57-58
# The elementwise tolerances above are about as large as a bfloat16 output
# of a row that sees thousands of keys (about 1/sqrt(keys)), so K6 is also
# held per (batch, head) to ‖got − want‖ ≤ K6_REL_TOL · ‖want‖, a bound
# scaled to the output; planted faults (a window one 32-key tile short,
# rows past 4096 zeroed) must break it.
K6_REL_TOL = 1e-2
# K6's row log-sum-exp, absolute (|lse| is up to ~60 with the softcap; a
# row that sees no key has -1e30 in both).
K6_LSE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-3}
# The size of the planted window faults (a window this many keys short):
# 32 keys, the classic kernel's kv tile at head dim 256 when the faults were
# set; kept so that the faults keep their size under either route.
K6_TILE = 32
K6_CASES = [  # b, hq, hkv, sq, skv, d, causal, window, softcap
    # tests/test_kernels.py:16-26
    (1, 4, 4, 64, 64, 32, True, None, None),
    (2, 8, 2, 128, 128, 64, True, None, None),
    (1, 4, 1, 96, 96, 32, True, None, None),
    (1, 4, 2, 96, 96, 32, True, 32, None),
    (1, 2, 2, 64, 64, 32, True, None, 50.0),
    (1, 4, 2, 64, 64, 32, True, 16, 30.0),
    (1, 4, 1, 48, 80, 32, False, None, None),
    (2, 2, 2, 33, 65, 16, True, None, None),
    # gemma2-2b: head_dim 256, window 4096, softcap 50, just over one
    # window, GQA 2 (the model's), 1 and 4; one query row
    (1, 8, 4, 4100, 4100, 256, True, 4096, 50.0),
    (1, 8, 8, 4100, 4100, 256, True, 4096, 50.0),
    (1, 8, 2, 4100, 4100, 256, True, 4096, 50.0),
    (1, 8, 4, 1, 1, 256, True, 4096, 50.0),
    (1, 8, 4, 1, 4100, 256, True, 4096, 50.0),
    # the smoke config's head_dim 12, a head_dim that is no multiple of 8,
    # rows that see no key at all (window, Sq > Skv)
    (2, 4, 2, 70, 70, 12, True, 8, 50.0),
    (1, 3, 1, 130, 150, 100, False, 20, None),
    (1, 2, 1, 100, 10, 64, True, 5, None),
    # the wgmma route's edges (bf16 at head dims 64, 128, 256): groups 1, 6
    # and 48 (minicpm-2b, nemotron-4-15b, granite-34b); Sq 1, 127, 129 and
    # 4100 around its 128-row q tile; Sq != Skv with rows that see no key;
    # windows that are a multiple of no tile
    (1, 4, 4, 129, 129, 64, True, None, None),
    (1, 12, 2, 4100, 4100, 64, True, None, None),
    (1, 48, 1, 1, 1, 64, True, None, None),
    (1, 4, 4, 200, 90, 64, False, 45, 30.0),
    (1, 6, 6, 127, 127, 128, True, None, None),
    (1, 6, 1, 129, 129, 128, True, None, None),
    (1, 48, 1, 127, 127, 128, True, None, None),
    (1, 48, 1, 4100, 4100, 128, True, None, None),
    (1, 6, 1, 1, 4100, 128, True, None, None),
    (2, 6, 1, 300, 70, 128, True, 37, None),
    (1, 12, 2, 700, 700, 128, True, 203, None),
    (1, 8, 4, 129, 129, 256, True, 4096, 50.0),
    (1, 8, 4, 1000, 1000, 256, True, 100, 50.0),
    # the MoE and hybrid layouts: group 3 at head dim 64 (granite-moe), MHA
    # 32 x 64 (zamba2's shared block), group 4 at head dim 128 (phi3.5-moe)
    (1, 24, 8, 1000, 1000, 64, True, None, None),
    (1, 32, 32, 129, 129, 64, True, None, None),
    (1, 32, 8, 1000, 1000, 128, True, None, None),
]


def expect(ok: bool, what) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    line = card_line()
    print(f"card: {line}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    return line


def ptxas_report(source, kernel, smem) -> dict:
    """The ptxas report of ``kernel``'s instantiation at each head dim in
    this process's build of ``source`` (registers at launch, spills,
    stack), beside the dynamic shared memory ``smem(d)`` it asks for."""
    lines = _build.BUILD_LOGS.get(source, "").splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or \
                f"{kernel}ILi" not in line:
            continue
        d = int(line.split(f"{kernel}ILi")[1].split("E")[0])
        rec = {"smem_dynamic_bytes": smem(d)}
        for nxt in lines[i + 1:i + 5]:
            if "spill stores" in nxt:
                n = [int(w) for w in nxt.replace(",", " ").split()
                     if w.isdigit()]
                rec.update(stack_bytes=n[0], spill_store_bytes=n[1],
                           spill_load_bytes=n[2])
            if "Used" in nxt and "registers" in nxt:
                rec["registers"] = int(nxt.split("Used")[1].split()[0])
        out[d] = rec
    return out


def k6_ptxas() -> dict:
    """The ptxas report of K6's wgmma kernel at each head dim.  The
    consumers' 240 registers a thread come from setmaxnreg at run time;
    ptxas reports the launch's 168 (384 threads) and warns (C7508) if it
    had to ignore setmaxnreg."""
    lines = _build.BUILD_LOGS.get("flash_attention", "").splitlines()
    out = ptxas_report("flash_attention", "fa_hopper_kernel",
                       FA._lib().roomy_flash_attention_tma_smem)
    rec = {"setmaxnreg_ignored": any("C7508" in x for x in lines)}
    print(f"ptxas K6 wgmma kernel (fa_hopper_kernel<D>): {out} {rec}")
    return {**{str(d): r for d, r in out.items()}, **rec}


def k7_ptxas() -> dict:
    """The ptxas report of K7's two wgmma kernels at head dims 64, 128 and
    256: every one built, with no spills and no stack; ptxas warned
    neither that it ignored setmaxnreg (C7508) nor that it serialised
    wgmma (C7520)."""
    lines = _build.BUILD_LOGS.get("flash_attention_bwd", "").splitlines()
    smem = FAB._lib().roomy_flash_attention_bwd_tma_smem
    out = {name: ptxas_report("flash_attention_bwd", name,
                              lambda d, w=which: smem(d, w))
           for which, name in ((0, "dkdv_hopper_kernel"),
                               (1, "dq_hopper_kernel"))}
    rec = {"setmaxnreg_ignored": any("C7508" in x for x in lines),
           "wgmma_serialised": any("C7520" in x for x in lines)}
    print(f"ptxas K7 wgmma kernels (dkdv_hopper_kernel<D>, "
          f"dq_hopper_kernel<D>): {out} {rec}")
    for name, by_d in out.items():
        expect(sorted(by_d) == [64, 128, 256], f"ptxas K7 {name}: {by_d}")
        for d, r in by_d.items():
            expect(r.get("spill_store_bytes") == 0 and
                   r.get("spill_load_bytes") == 0 and
                   r.get("stack_bytes") == 0, f"ptxas K7 {name}<{d}>: {r}")
    expect(not any(rec.values()), f"ptxas K7: {rec}")
    return {**{name: {str(d): r for d, r in by_d.items()}
               for name, by_d in out.items()}, **rec}


def k8_ptxas() -> dict:
    """The ptxas report of K8's TMA-route kernel at head dims 64, 128 and
    256: every one built, with no spills and no stack."""
    out = ptxas_report("paged_decode", "pd_hopper_kernel",
                       PD._lib().roomy_pd_tma_smem)
    print(f"ptxas K8 TMA kernel (pd_hopper_kernel<HD>): {out}")
    expect(sorted(out) == [64, 128, 256], f"ptxas K8: {out}")
    for d, r in out.items():
        expect(r.get("spill_store_bytes") == 0 and
               r.get("spill_load_bytes") == 0 and r.get("stack_bytes") == 0,
               f"ptxas K8 pd_hopper_kernel<{d}>: {r}")
    return {str(d): r for d, r in out.items()}


def k9_ptxas() -> dict:
    """The ptxas report of K9's kernel for each dtype and threads a channel
    (registers, spills, stack), serving's instantiation and, keyed
    ``chunks``, training's (it also writes the state after each chunk);
    serving's falcon-mamba instantiation (bf16, 4 threads a channel) and
    its float32 twin must not spill."""
    lines = _build.BUILD_LOGS.get("mamba_scan", "").splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or \
                "scan_seg_kernelI" not in line:
            continue
        tail = line.split("scan_seg_kernelI")[1]
        dtype = "bf16" if tail.startswith("13__nv_bfloat16") else "f32"
        tpc = int(tail.split("Li")[1].split("E")[0])
        chunks = " chunks" if "Lb1E" in tail else ""
        rec = {}
        for nxt in lines[i + 1:i + 5]:
            if "spill stores" in nxt:
                n = [int(w) for w in nxt.replace(",", " ").split()
                     if w.isdigit()]
                rec.update(stack_bytes=n[0], spill_store_bytes=n[1],
                           spill_load_bytes=n[2])
            if "Used" in nxt and "registers" in nxt:
                rec["registers"] = int(nxt.split("Used")[1].split()[0])
        out[f"{dtype} tpc {tpc}{chunks}"] = rec
    print(f"ptxas K9 kernel (scan_seg_kernel<T, TPC, chunks>): {out}")
    expect(len(out) == 20, f"ptxas K9: {out}")
    for key in ("bf16 tpc 4", "f32 tpc 4"):
        r = out[key]
        expect(r.get("spill_store_bytes") == 0 and
               r.get("spill_load_bytes") == 0, f"ptxas K9 {key}: {r}")
    return out


def k9_bwd_ptxas() -> dict:
    """The ptxas report of K9-bwd's kernel for each dtype and threads a
    channel (registers, spills, stack), and of its reduce kernel; the
    falcon-mamba instantiation (bf16, 4 threads a channel: N = 16) must not
    spill."""
    lines = _build.BUILD_LOGS.get("mamba_scan_bwd", "").splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or "scan_bwd_" not in line:
            continue
        if "scan_bwd_kernelI" in line:
            tail = line.split("scan_bwd_kernelI")[1]
            dtype = "bf16" if tail.startswith("13__nv_bfloat16") else "f32"
            key = f"{dtype} tpc {int(tail.split('Li')[1].split('E')[0])}"
        else:
            key = "scan_bwd_reduce_kernel"
        rec = {}
        for nxt in lines[i + 1:i + 5]:
            if "spill stores" in nxt:
                n = [int(w) for w in nxt.replace(",", " ").split()
                     if w.isdigit()]
                rec.update(stack_bytes=n[0], spill_store_bytes=n[1],
                           spill_load_bytes=n[2])
            if "Used" in nxt and "registers" in nxt:
                rec["registers"] = int(nxt.split("Used")[1].split()[0])
        out[key] = rec
    geo = {n: MS.bwd_geometry(1, 1, 1, n)["smem_bytes"] for n in (16, 64)}
    smem = {n: MS._bwd_lib().roomy_mamba_scan_bwd_smem(n)
            for n in (1, 2, 4, 8, 16, 32, 64)}
    expect(all(s == MS.bwd_geometry(1, 1, 1, n)["smem_bytes"]
               for n, s in smem.items()),
           f"K9-bwd's shared memory: the kernel's {smem}, bwd_geometry's")
    print(f"ptxas K9-bwd (scan_bwd_kernel<T, TPC>, scan_bwd_reduce_kernel; "
          f"dynamic shared memory {geo[16]} B at TPC 4, {geo[64]} B at TPC "
          f"16): {out}")
    expect(len(out) == 11, f"ptxas K9-bwd: {out}")
    r = out["bf16 tpc 4"]
    expect(r.get("spill_store_bytes") == 0 and r.get("spill_load_bytes") == 0,
           f"ptxas K9-bwd bf16 tpc 4: {r}")
    return out


def entry_ptxas(source, marker) -> dict:
    """Registers, static shared memory, spills and stack of the one entry
    function of ``source``'s build in this process whose mangled name holds
    ``marker``."""
    lines = _build.BUILD_LOGS.get(source, "").splitlines()
    found = [i for i, line in enumerate(lines)
             if "Compiling entry function" in line and marker in line]
    expect(len(found) == 1, f"ptxas: {len(found)} entries match {marker}")
    rec = {}
    for nxt in lines[found[0] + 1:found[0] + 5]:
        if "spill stores" in nxt:
            n = [int(w) for w in nxt.replace(",", " ").split() if w.isdigit()]
            rec.update(stack_bytes=n[0], spill_store_bytes=n[1],
                       spill_load_bytes=n[2])
        if "Used" in nxt and "registers" in nxt:
            rec["registers"] = int(nxt.split("Used")[1].split()[0])
            if "bytes smem" in nxt:
                rec["smem_static_bytes"] = int(
                    nxt.split("bytes smem")[0].split()[-1])
    return rec


def k12_ptxas() -> dict:
    """The ptxas report of the binned route's kernels: the three binning
    kernels K1 and K2 share (their dynamic shared memory is 4 bytes a
    tile: 29,236 at n = 12) and each one's tile pass (its dynamic shared
    memory beside it); none may spill."""
    smem = K._lib().roomy_bin_tile_smem()
    out = {}
    for name, marker in (("bin_count_kernel", "bin_count_kernel"),
                         ("bin_scan_kernel", "bin_scan_kernel"),
                         ("bin_scatter_kernel", "bin_scatter_kernel"),
                         ("tile_pass_kernel<true>", "tile_pass_kernelILb1E"),
                         ("tile_pass_kernel<false>", "tile_pass_kernelILb0E")):
        out[name] = entry_ptxas("bitpack", marker)
        expect(out[name].get("spill_store_bytes") == 0 and
               out[name].get("spill_load_bytes") == 0,
               f"ptxas {name}: {out[name]}")
    for name in ("tile_pass_kernel<true>", "tile_pass_kernel<false>"):
        out[name]["smem_dynamic_bytes"] = smem
    bins = {k: out[k] for k in ("bin_count_kernel", "bin_scan_kernel",
                                "bin_scatter_kernel")}
    print(f"ptxas K1 (binned: {', '.join(bins)}, tile_pass_kernel<true>): "
          f"{bins} {{'tile_pass_kernel<true>': "
          f"{out['tile_pass_kernel<true>']}}}")
    print(f"ptxas K2 (binned: the same binning kernels, "
          f"tile_pass_kernel<false>): {{'tile_pass_kernel<false>': "
          f"{out['tile_pass_kernel<false>']}}}")
    return out


def k4_ptxas() -> dict:
    """The ptxas report of K4's two instantiations: int64 ranks to uint8
    codes over a chunk table (the oracle's) and int32 to int32 (the flat
    form); neither may spill or use a stack (a thread keeps its 8 word
    addresses live)."""
    out = {}
    for name, marker in (("gather2_kernel<long long, uint8_t>",
                          "gather2_kernelIxhE"),
                         ("gather2_kernel<int32_t, int32_t>",
                          "gather2_kernelIiiE")):
        out[name] = entry_ptxas("bitpack", marker)
        expect(out[name].get("spill_store_bytes") == 0
               and out[name].get("spill_load_bytes") == 0
               and out[name].get("stack_bytes") == 0,
               f"ptxas {name}: {out[name]}")
    print(f"ptxas K4 (the chunk-table gather): {out}")
    return out


def phase_build() -> dict:
    names = _build.sources()
    secs = _build.build(names)
    print(f"build: {secs:.3f} s for {names} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)}; "
          f"{', '.join(sorted(_build.LINK))} also "
          f"{' '.join(_build.LINK['flash_attention'])})")
    for name, log in _build.BUILD_LOGS.items():
        print(f"[{name}] {log.strip()}")
    K._lib()
    BS._lib()
    FA._lib()
    FAB._lib()
    MS._lib()
    MS._bwd_lib()
    PD._lib()
    return (k6_ptxas(), k7_ptxas(), k8_ptxas(), k9_ptxas(), k12_ptxas(),
            k4_ptxas(), k9_bwd_ptxas())


# ------------------------------------------------------------------ parity

def _err(got, want) -> int:
    """Max |difference| of two word tensors read as uint32."""
    if got.numel() == 0:
        return 0
    return int(((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF))
               .abs().max())


def check(name, got, want, gcnt=None, wcnt=None, what="") -> None:
    torch.cuda.synchronize()
    err = _err(got, want)
    if gcnt is not None:
        err = max(err, abs(int(gcnt) - int(wcnt)))
    MAX_ERR[name] = max(MAX_ERR[name], err)
    if err:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({what}): max abs err {err}")


def check_all(words, idx, what, luts=LUTS, marks=MARKS,
              routes=K12_ROUTES) -> None:
    """K3, K1 and K2 against their plain versions on ``words``: K1 and K2
    through their wrappers (the route ``K.route`` names) and on each of
    ``routes``, out of place and in place."""
    for lut, cval in luts:
        got, gc = K.bitpack_lut_count(words, lut, cval)
        want, wc = R.bitpack_lut_count_ref(words, lut, cval)
        check("lut_count", got, want, gc, wc, what)
        for mark, only_if in marks:
            want, wc = R.bitpack_mark_rotate_count_ref(words, idx, lut, cval,
                                                       mark, only_if)
            got, gc = K.bitpack_mark_rotate_count(words, idx, lut, cval,
                                                  mark=mark, only_if=only_if)
            check("mark_rotate_count", got, want, gc, wc, what)
            work = words.clone()
            got, gc = K.bitpack_mark_rotate_count(work, idx, lut, cval,
                                                  mark=mark, only_if=only_if,
                                                  inplace=True)
            check("mark_rotate_count", work, want, gc, wc, what + " inplace")
            for path in routes:
                out = torch.empty_like(words)
                gc = K._mark(words, idx, out, mark, only_if, lut, cval,
                             path=path)
                check("mark_rotate_count", out, want, gc, wc,
                      f"{what} {path}")
                work = words.clone()
                gc = K._mark(work, idx, work, mark, only_if, lut, cval,
                             path=path)
                check("mark_rotate_count", work, want, gc, wc,
                      f"{what} {path} inplace")
    for mark, only_if in marks:
        got = K.bitpack_scatter_mark(words, idx, mark=mark, only_if=only_if)
        want = R.bitpack_scatter_mark_ref(words, idx, mark, only_if)
        check("scatter_mark", got, want, what=what)
        for path in routes:
            out = torch.empty_like(words)
            K._mark(words, idx, out, mark, only_if, path=path)
            check("scatter_mark", out, want, what=f"{what} {path}")


def random_words(rng, w, dev):
    raw = rng.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(raw.view(np.int32)).to(dev)


def tile_edges(w) -> list:
    """The first and last field of every binned tile of ``w`` words."""
    cap, tf = 16 * w, 16 * TILE
    return [f for t in range(-(-w // TILE))
            for f in (t * tf, min(cap, (t + 1) * tf) - 1)]


def phase_parity_edges(dev) -> None:
    rng = np.random.default_rng(0)
    for w in (1, 3, 37, 129, 1000, 4099, TILE - 1, TILE, TILE + 1,
              2 * TILE + 1):
        cap = 16 * w
        idx = np.concatenate([rng.integers(-20, cap + 20, 4 * w + 5),
                              [0, 0, cap - 1, cap - 1, cap, cap + 1,
                               cap + 1000, -1, -cap], tile_edges(w)])
        idx = torch.from_numpy(rng.permutation(idx).astype(np.int32)).to(dev)
        words = random_words(rng, w + 1, dev)
        check_all(words[:w], idx, f"W={w}")
        check_all(words[1:], idx, f"W={w} misaligned")   # scalar path
        check_all(words[:w], idx[:0], f"W={w} no targets")
        check_all(words[:w], idx[1:], f"W={w} misaligned targets",
                  luts=LUTS[:1], marks=MARKS[:2])
    print(f"parity: edge cases bit-exact on the routes {K12_ROUTES} and "
          f"through the wrappers (widths 1..4099 and {TILE} +- 1, "
          f"{2 * TILE + 1}: the first and last field of every {TILE}-word "
          "tile, duplicate, == cap, > cap and negative indices, only_if != "
          "0, lut[0] == count_val, misaligned words and targets, no "
          "targets)")


# The planted faults of the binned route: copies of csrc/bitpack.cu with one
# text substitution each, built here; each must break K1's bit-exactness
# (and K2's where it marks) on FAULT_W zeroed words with distinct targets.
BIN_FAULTS = {
    "one bin's last target dropped": (
        "const long long b1 = tile_start[t + 1];",
        "const long long b1 = tile_start[t + 1] - (t == 0);", True),
    "one offset sent to the neighbouring tile": (
        "return e >> kTileShift;", "return (e >> kTileShift) + (e == 65535);",
        True),
    "the tail tile's count skipped": (
        "cnt += __popc(match);",
        "cnt += t == n_tiles - 1 ? 0u : __popc(match);", False),
}
FAULT_W = 2 * TILE + 1


def build_variant(stem, text) -> ctypes.CDLL:
    """``text`` (a variant of csrc/bitpack.cu) built with nvcc into
    build/variants/``stem``.so and loaded with the wrapper's signatures."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{stem}.cu"
    src.write_text(text)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(src.with_suffix(".so")),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"variant {stem} failed to build:\n{r.stderr}")
    lib = ctypes.CDLL(str(src.with_suffix(".so")))
    base = K._lib()
    for name in list(K._SIGNATURES) + ["roomy_error_string",
                                       "roomy_bin_tile_words"]:
        getattr(lib, name).argtypes = getattr(base, name).argtypes
        getattr(lib, name).restype = getattr(base, name).restype
    return lib


def fault_libs() -> dict:
    """Build every planted fault's variant, one nvcc each, all at once."""
    text = (_build.CSRC / "bitpack.cu").read_text()
    jobs = {}
    for i, (name, (old, new, _)) in enumerate(BIN_FAULTS.items()):
        if text.count(old) != 1:
            raise SystemExit(f"fault {name!r}: csrc/bitpack.cu no longer "
                             f"holds {old!r} once")
        jobs[name] = (f"bitpack_fault{i}", text.replace(old, new))
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(build_variant, *job)
                for name, job in jobs.items()}
        return {name: f.result() for name, f in futs.items()}


def phase_bin_faults(dev) -> dict:
    """Each planted fault breaks bit-exactness: K1 (rotate, count CUR) and
    K2 on the binned route against the plain versions, on zeroed words
    with distinct targets (so every target marks a field of its own) that
    include the first and last field of each tile."""
    libs = fault_libs()
    rng = np.random.default_rng(3)
    cap = 16 * FAULT_W
    idx = np.unique(np.concatenate([rng.integers(0, cap, 20000),
                                    tile_edges(FAULT_W)]))
    idx = torch.from_numpy(rng.permutation(idx).astype(np.int32)).to(dev)
    words = torch.zeros(FAULT_W, dtype=torch.int32, device=dev)
    want1, wc = R.bitpack_mark_rotate_count_ref(words, idx, ROTATE, BA.CUR,
                                                2, 0)
    want2 = R.bitpack_scatter_mark_ref(words, idx, 2, 0)
    good = K._LIB
    out = {}
    try:
        for name, lib in libs.items():
            K._LIB = lib
            got = torch.empty_like(words)
            gc = K._mark(words, idx, got, 2, 0, ROTATE, BA.CUR, path="binned")
            torch.cuda.synchronize()
            err1 = max(_err(got, want1), abs(int(gc) - int(wc)))
            K._mark(words, idx, got, 2, 0, path="binned")
            torch.cuda.synchronize()
            err2 = _err(got, want2)
            out[name] = {"k1_err": err1, "k2_err": err2}
            expect(err1 > 0 and (err2 > 0 or not BIN_FAULTS[name][2]),
                   f"planted fault {name!r} kept bit-exactness: {out[name]}")
    finally:
        K._LIB = good
    print(f"parity: every planted fault of the binned route breaks "
          f"bit-exactness: {out}")
    return out


def phase_parity_full(dev):
    """Real n = 12 state at LEVEL and its targets; returns (data, tgt)."""
    n, total = 12, math.factorial(12)
    sizes, bits = C.implicit_bfs(total, [P.start_rank(n)], P.neighbors(n),
                                 max_levels=LEVEL, device=dev)
    data = bits.data
    tgt = C.frontier_targets(data, total, sizes[-1], P.neighbors(n))
    torch.cuda.synchronize()
    print(f"parity: n=12 W={data.shape[0]} words, level {LEVEL} has "
          f"{sizes[-1]} states -> M={tgt.shape[0]} targets")
    rot = [(ROTATE, BA.CUR)]
    check_all(data, tgt, "n=12 level state", luts=rot, marks=[(2, 0)])
    rng = np.random.default_rng(1)
    check_all(random_words(rng, data.shape[0], dev), tgt,
              "n=12 random words", luts=rot + [LUTS[1]],
              marks=[(2, 0), (3, 1)])
    print("parity: n=12 shapes bit-exact on both routes (K1 in place == out "
          "of place == plain; K2, K3 == plain)")
    return data, tgt


def k6_inputs(case, dtype, dev, seed, strided=False):
    """q, k, v of one K6 case from a numpy seed; ``strided`` gives them as
    the model does, (B, S, H, D) activations viewed as (B, H, S, D)."""
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.default_rng(seed)
    out = []
    for h, s in ((hq, sq), (hkv, skv), (hkv, skv)):
        x = torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
        x = x.to(dev, dtype)
        out.append(x.transpose(1, 2) if strided else
                   x.transpose(1, 2).contiguous())
    return out


def k6_errors(got, want) -> dict:
    """Max abs err, the worst per-(batch, head) ‖got − want‖ / ‖want‖ (0/0
    reads 0, x/0 reads inf), mean |want|, and whether each check holds."""
    g, w = got.float(), want.float()
    if not g.numel():
        return {"max_abs": 0.0, "rel": 0.0, "mean_want": 0.0,
                "elementwise_ok": True, "rel_ok": True}
    tol = K6_TOL[got.dtype]
    rel = ((g - w).flatten(2).norm(dim=-1) / w.flatten(2).norm(dim=-1))
    rel = float(rel.nan_to_num(nan=0.0, posinf=math.inf).max())
    return {"max_abs": float((g - w).abs().max()), "rel": rel,
            "mean_want": float(w.abs().mean()),
            "elementwise_ok": bool(torch.isfinite(g).all()) and bool(
                ((g - w).abs() <= tol + tol * w.abs()).all()),
            "rel_ok": rel <= K6_REL_TOL}


def k6_route(dtype, d) -> str:
    """The route a K6 case's fresh inputs must take: the wgmma kernel for
    bfloat16 at head dims 64, 128 and 256 (their strides are multiples of 8
    and their bases aligned), the classic kernels otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and d in FA.TMA_TILES else \
        "classic"


def check_k6(q, k, v, causal, window, softcap, what) -> dict:
    """K6 against its plain version on the same inputs, by both checks;
    then K6 with its LSE output: the same output bit for bit, and the LSE
    within ``K6_LSE_TOL`` of the plain version's.  Both launches must take
    the route ``k6_route`` names."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = dict(FA.ROUTE_LAUNCHES)
    got = FA.flash_attention(q, k, v, **kw)
    got_l, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    want, want_lse = R.attention_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    path = k6_route(q.dtype, q.shape[-1])
    routed = {n: FA.ROUTE_LAUNCHES[n] - before[n] for n in before}
    expect(routed == {**{n: 0 for n in before}, path: 2},
           f"K6 routes {routed}, want 2 launches on {path}: {what}")
    expect(got.dtype == q.dtype and got.shape == q.shape, what)
    expect(lse.dtype == torch.float32 and lse.shape == q.shape[:3], what)
    expect(torch.equal(got_l, got), f"K6 with LSE changes the output: {what}")
    e = k6_errors(got, want)
    e["lse_abs"] = float((lse - want_lse).abs().max()) if lse.numel() else 0.0
    e["route"] = path
    MAX_ERR["flash_attention"] = max(MAX_ERR["flash_attention"], e["max_abs"])
    MAX_REL["flash_attention"] = max(MAX_REL["flash_attention"], e["rel"])
    MAX_ERR["flash_attention_lse"] = max(MAX_ERR["flash_attention_lse"],
                                         e["lse_abs"])
    if not (e["elementwise_ok"] and e["rel_ok"]):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version ({what}): {e}")
    if not e["lse_abs"] <= K6_LSE_TOL[q.dtype]:
        raise AssertionError(f"flash_attention's LSE disagrees with its "
                             f"plain version ({what}): {e}")
    return e


def k6_summary(errs) -> str:
    return (f"max abs err {max(e['max_abs'] for e in errs):.3e} (mean |want| "
            f"{max(e['mean_want'] for e in errs):.3e}), per-(b, h) rel err "
            f"{max(e['rel'] for e in errs):.3e}, LSE max abs err "
            f"{max(e.get('lse_abs', 0.0) for e in errs):.3e}")


def phase_k6_parity_edges(dev) -> None:
    for i, case in enumerate(K6_CASES):
        causal, window, softcap = case[6:]
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            for strided in (False, True):
                q, k, v = k6_inputs(case, dtype, dev, i, strided)
                errs.append(check_k6(q, k, v, causal, window, softcap,
                                     f"{case} {dtype} strided={strided}"))
        print(f"parity K6 {case}: f32 ({errs[0]['route']}) "
              f"{k6_summary(errs[:2])}; bf16 ({errs[2]['route']}) "
              f"{k6_summary(errs[2:])} (tol elementwise 2e-5 / 2e-2, rel "
              f"{K6_REL_TOL}, LSE 2e-5 / 1e-3)")


def visible_pairs(sq, skv, causal, window) -> int:
    """(q, k) pairs the mask lets through, q and k positions from 0."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(q - window, 0) if window is not None else np.zeros(sq)
    return int(np.maximum(hi - lo + 1, 0).sum())


def k6_bound(q, k, causal, window):
    """(bound ms, bound_by, flops, bytes): flops 4·B·Hq·D per visible pair
    at the bf16 peak, bytes = q, k, v read once and o written once."""
    b, hq, sq, d = q.shape
    flops = 4 * b * hq * d * visible_pairs(sq, k.shape[2], causal, window)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


# ------------------------------------------------------------------- times

def median_ms(fn, setup=None, reps=REPS) -> float:
    fn()                                   # warm-up
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_times(data, tgt):
    w, m = data.shape[0], tgt.shape[0]
    work = torch.empty_like(data)
    restore = lambda: work.copy_(data)     # noqa: E731 — in-place K1 input
    bytes_ = {"mark_rotate_count": 8 * w + 4 * m,
              "scatter_mark": 8 * w + 4 * m, "lut_count": 8 * w}
    kernel = {
        "mark_rotate_count": lambda: K.bitpack_mark_rotate_count(
            work, tgt, ROTATE, BA.CUR, inplace=True),
        "scatter_mark": lambda: K.bitpack_scatter_mark(data, tgt),
        "lut_count": lambda: K.bitpack_lut_count(data, ROTATE, BA.CUR),
    }
    plain = {
        "mark_rotate_count": lambda: R.bitpack_mark_rotate_count_ref(
            data, tgt, ROTATE, BA.CUR, 2, 0),
        "scatter_mark": lambda: R.bitpack_scatter_mark_ref(data, tgt, 2, 0),
        "lut_count": lambda: R.bitpack_lut_count_ref(data, ROTATE, BA.CUR),
    }
    out = {"route": K.route(w, m)}
    for name, _ in KERNELS:
        setup = restore if name == "mark_rotate_count" else None
        out[name] = {
            "ms": median_ms(kernel[name], setup),
            "plain_ms": median_ms(plain[name]),
            "bound_ms": bytes_[name] / HBM_BYTES_PER_S * 1e3,
        }
        print(f"time: {name}: {out[name]['ms']:.4f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms ({bytes_[name]} bytes at "
              f"3.35 TB/s), plain {out[name]['plain_ms']:.4f} ms, "
              f"library n/a")
    return out


# ------------------------------------------------- K1 and K2 at every level

K12_REPS = 10
PLAIN_CHUNK = 1 << 27         # targets a plain-version call takes at once


def plain_marked(words, tgt, mark, only_if):
    """The plain version of K2 applied to the targets PLAIN_CHUNK at a
    time: exact, since a field is marked iff it held ``only_if`` before
    (so a later chunk never marks a field an earlier one marked), and it
    keeps the plain version's int64 temporaries in bounds at the widest
    level."""
    out = words.clone()
    for c in range(0, tgt.shape[0], PLAIN_CHUNK):
        out = R.bitpack_scatter_mark_ref(out, tgt[c:c + PLAIN_CHUNK], mark,
                                         only_if)
    return out


def design_bytes(path, w, m, sms) -> int:
    """The bytes a K1 or K2 call moves by its route's design: binned, the
    words read and written once, the targets read twice, the uint16 bins
    written and read, 16 bytes a (tile, block) count; atomic, the words'
    rotate pass, the targets once and a 32-byte sector read and written a
    mark (the words are more than twice L2)."""
    if path == "binned":
        plan = K.bin_plan(w, m, sms)
        return 8 * w + 12 * m + 16 * plan.n_tiles * plan.blocks
    return 8 * w + 4 * m + 64 * m


def bfs_levels(dev, n=12):
    """Walk the pancake BFS level by level, as the fused main path does:
    yields (level, n_cur, words, targets); once the caller is done with
    them, K1 (in place, through its wrapper) makes the next level."""
    total = math.factorial(n)
    nbr = P.neighbors(n)
    data = BA.mark_packed(BA.make(total, device=dev).data,
                          torch.tensor([P.start_rank(n)], device=dev),
                          mark=BA.CUR)
    n_cur, level = 1, 0
    while n_cur:
        tgt = C.frontier_targets(data, total, n_cur, nbr)
        yield level, n_cur, data, tgt
        data, cnt = K.bitpack_mark_rotate_count(data, tgt, ROTATE, BA.CUR,
                                                inplace=True)
        n_cur, level = int(cnt), level + 1
        del tgt


def level_sums(k1, k2) -> dict:
    """Sums of per-level readings of K1 and K2: a fused BFS runs K1 at
    every level, an unfused one K2; a publish runs K1 at every level and
    K2 at every level that has a next one."""
    return {"fused_bfs_k1": sum(k1), "unfused_bfs_k2": sum(k2),
            "publish_k1_k2": sum(k1) + sum(k2[:-1])}


def phase_k12_levels(dev, n=12) -> dict:
    """K1 (rotate, count CUR, in place) and K2 (out of place) on each route
    at every level of pancake n = 12, on the level's words and targets:
    each held bit for bit to the plain version (the targets in chunks),
    timed by CUDA events (median of K12_REPS, a spin kernel ahead) beside
    the byte bound (8W + 4M at 3.35 TB/s) and the bytes its design moves;
    the sums over a fused BFS (K1), an unfused one (K2) and a publish."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    levels = []
    for level, n_cur, data, tgt in bfs_levels(dev, n):
        w, m = data.shape[0], tgt.shape[0]
        want2 = plain_marked(data, tgt, 2, 0)
        want1, wc = R.bitpack_lut_count_ref(want2, ROTATE, BA.CUR)
        work, out = torch.empty_like(data), torch.empty_like(data)
        rec = {"level": level, "n_cur": n_cur, "M": m,
               "route": K.route(w, m),
               "bound_ms": (8 * w + 4 * m) / HBM_BYTES_PER_S * 1e3,
               "design_bytes": {p: design_bytes(p, w, m, sms)
                                for p in K12_ROUTES},
               "k1_ms": {}, "k2_ms": {}}
        for path in K12_ROUTES:
            work.copy_(data)
            gc = K._mark(work, tgt, work, 2, 0, ROTATE, BA.CUR, path=path)
            check("mark_rotate_count", work, want1, gc, wc,
                  f"n={n} level {level} {path}")
            K._mark(data, tgt, out, 2, 0, path=path)
            check("scatter_mark", out, want2, what=f"n={n} level {level} "
                  f"{path}")
            rec["k1_ms"][path] = device_ms(
                lambda p=path: K._mark(work, tgt, work, 2, 0, ROTATE, BA.CUR,
                                       path=p),
                reps=K12_REPS, setup=lambda: work.copy_(data))
            rec["k2_ms"][path] = device_ms(
                lambda p=path: K._mark(data, tgt, out, 2, 0, path=p),
                reps=K12_REPS)
        rec["k1_ms"]["routed"] = rec["k1_ms"][rec["route"]]
        rec["k2_ms"]["routed"] = rec["k2_ms"][rec["route"]]
        print(f"time: n={n} level {level}: M={m}, route {rec['route']}; K1 "
              + ", ".join(f"{p} {rec['k1_ms'][p]:.4f}" for p in K12_ROUTES)
              + " ms; K2 " + ", ".join(f"{p} {rec['k2_ms'][p]:.4f}"
                                       for p in K12_ROUTES)
              + f" ms; bound {rec['bound_ms']:.4f} ms; design bytes "
              f"{rec['design_bytes']}", flush=True)
        levels.append(rec)
        del want1, want2, work, out
    sizes = [r["n_cur"] for r in levels]
    expect(len(sizes) == P.DIAMETERS[n] + 1 and
           sum(sizes) == math.factorial(n), sizes)
    widest = max(levels, key=lambda r: r["M"])
    sums = {p: level_sums([r["k1_ms"][p] for r in levels],
                          [r["k2_ms"][p] for r in levels])
            for p in K12_ROUTES + ("routed",)}
    sums["bound"] = level_sums(*[[r["bound_ms"] for r in levels]] * 2)
    sums["design_bytes"] = {p: level_sums(
        *[[r["design_bytes"][p] for r in levels]] * 2) for p in K12_ROUTES}
    print(f"time: K1/K2 summed over n={n} (ms; fused BFS K1, unfused BFS K2, "
          f"publish K1 + K2): {sums}; widest level {widest['level']} "
          f"(M={widest['M']}) held to the plain version in chunks of "
          f"{PLAIN_CHUNK}", flush=True)
    return {"levels": levels, "sums": sums, "widest": widest["level"]}


def level_routes(w, ms) -> dict:
    """The launches by route that calls over ``w`` words with the target
    counts ``ms`` make, by ``K.route``."""
    out = {p: 0 for p in K.ROUTE_LAUNCHES}
    for m in ms:
        out[K.route(w, m)] += 1
    return out


# --------------------------------------------------------------- main path

def drive(n, fused, dev, spans=None):
    """One run of the user's entry point with every launch count set to 0
    just before it; returns (sizes, bits, secs, launches); K1's and K2's
    launches by route must be those ``K.route`` names for each call (the
    start mark, then one a level)."""
    K.reset_launches()
    if spans is not None:
        obs.enable(sink=spans.append)
    sizes, bits, secs = P.run(n, fused=fused, device=dev)
    obs.disable()
    w = -(-math.factorial(n) // 16)
    want = level_routes(w, [1] + [s * (n - 1) for s in sizes])
    expect(dict(K.ROUTE_LAUNCHES) == want,
           f"K1/K2 routes {dict(K.ROUTE_LAUNCHES)}, want {want}")
    return sizes, bits, secs, dict(K.LAUNCHES)


def phase_main_path(dev):
    """Pancake n = 12 fused (the default path: K1 per level, K2 for the
    start mark), then unfused (K2 then K3 per level); returns the launches
    of both runs added up."""
    n, total = 12, math.factorial(12)
    spans = []
    torch.cuda.reset_peak_memory_stats(dev)
    sizes, bits, secs, fused = drive(n, True, dev, spans)
    peak = torch.cuda.max_memory_allocated(dev)
    routes_f = dict(K.ROUTE_LAUNCHES)
    expect(len(sizes) == 15 and sum(sizes) == total, sizes)
    expect(len(sizes) - 1 == P.DIAMETERS[n] == 14, sizes)
    expect(fused == {"mark_rotate_count": 15, "scatter_mark": 1,
                     "lut_count": 0, "gather2": 0}, fused)
    expect(BA.count_value(bits, BA.DONE, total) == total, "unreached states")
    levels = []
    expands = [s for s in spans if s["sid"] == "bfs.expand"]
    for s, e in zip([s for s in spans if s["sid"] == "bfs.level"], expands):
        n_cur = e["attrs"]["n_cur"]
        levels.append({"level": s["attrs"]["level"], "n_cur": n_cur,
                       "M": n_cur * (n - 1), "level_ms": s["dur_us"] / 1e3,
                       "expand_ms": e["dur_us"] / 1e3,
                       "launches": s.get("metrics", {})})
    print(f"main path: pancake n=12 fused, {secs:.3f} s wall, "
          f"{total / secs:.0f} states/s, peak {peak} bytes, launches {fused}, "
          f"K1/K2 by route {dict(K.ROUTE_LAUNCHES)} (each the route "
          f"K.route names)")
    torch.cuda.reset_peak_memory_stats(dev)
    sizes_u, bits_u, secs_u, unfused = drive(n, False, dev)
    peak_u = torch.cuda.max_memory_allocated(dev)
    expect(sizes_u == sizes, (sizes_u, sizes))
    expect(torch.equal(bits_u.data, bits.data), "fused and unfused differ")
    expect(unfused == {"mark_rotate_count": 0, "scatter_mark": 16,
                       "lut_count": 15, "gather2": 0}, unfused)
    routes_u = dict(K.ROUTE_LAUNCHES)
    print(f"main path: pancake n=12 unfused, {secs_u:.3f} s wall, "
          f"{total / secs_u:.0f} states/s, peak {peak_u} bytes, launches "
          f"{unfused}, K1/K2 by route {dict(K.ROUTE_LAUNCHES)}; levels and "
          "words == fused")
    print(json.dumps({"main_path": {
        "n": n, "level_sizes": sizes, "wall_s": secs,
        "states_per_s": total / secs, "peak_bytes": peak,
        "launches": fused, "unfused_wall_s": secs_u,
        "unfused_peak_bytes": peak_u,
        "unfused_launches": unfused, "routes": routes_f,
        "unfused_routes": routes_u, "levels": levels}}))
    return ({k: fused[k] + unfused[k] for k in fused}, sizes,
            {k: routes_f[k] + routes_u[k] for k in routes_f})


def phase_equivalence(dev) -> None:
    sf, bf, _ = P.run(11, fused=True, device=dev)
    su, bu, _ = P.run(11, fused=False, device=dev)
    expect(sf == su, (sf, su))
    expect(len(sf) - 1 == 13 and sum(sf) == math.factorial(11), sf)
    expect(torch.equal(bf.data, bu.data), "fused and unfused words differ")
    n, total = 9, math.factorial(9)
    sk, bk = C.implicit_bfs(total, [P.start_rank(n)], P.neighbors(n),
                            device=dev)
    sr, br = C.implicit_bfs(total, [P.start_rank(n)], P.neighbors(n),
                            impl="ref", device=dev)
    expect(sk == sr and len(sk) - 1 == 10, (sk, sr))
    expect(torch.equal(bk.data, br.data), "kernel and plain words differ")
    print("equivalence: n=11 fused == unfused (levels and words), "
          "n=9 kernels == plain versions on the card")


# ------------------------------------------------ the sorted-list BFS

SORTED_N = 11          # the largest n whose sorted BFS fits one card
SORTED_CPU_N = 8       # the card against the CPU, bit for bit


def sorted_run(run, n, fused, dev):
    """One sorted-list BFS through ``run()``, an app's ``run`` at n, with
    the sort counters set to 0 just before it and the spans recorded: the
    wall, peak device memory (reset in ``pancake_bfs.search`` just before
    the search), the lexsorts and scatters of every level (each must be
    the fused or unfused budget), the span totals, the widest level's ms
    and the caching allocator's device allocations and retries (a retry
    frees the whole cache and synchronises).  Returns (BFSResult,
    record)."""
    spans = []
    TY.reset_sort_stats()
    before = torch.cuda.memory_stats(dev)
    obs.enable(sink=spans.append)
    try:
        sizes, res, secs = run()
    finally:
        obs.disable()
    peak = torch.cuda.max_memory_allocated(dev)
    after = torch.cuda.memory_stats(dev)
    levels = [s for s in spans if s["sid"] == "bfs.level"]
    expands = [s for s in spans if s["sid"] == "bfs.expand"]
    expect(len(levels) == len(expands) == res.levels_run, "spans")
    budget = 1 if fused else 2
    per_level = [(s["metrics"].get("tierj.lexsorts", 0),
                  s["metrics"].get("tierj.scatters", 0)) for s in levels]
    expect(all(p == (budget, budget) for p in per_level),
           f"lexsorts, scatters per level {per_level}, want {budget} each")
    widest = max(levels, key=lambda s: s["attrs"]["frontier"])
    return res, {
        "n": n, "fused": fused, "level_sizes": sizes, "wall_s": secs,
        "states_per_s": math.factorial(n) / secs, "peak_bytes": peak,
        "lexsorts_scatters_per_level": [budget, budget],
        "levels": len(levels), "sort_stats": dict(TY.SORT_STATS),
        "level_span_ms": sum(s["dur_us"] for s in levels) / 1e3,
        "expand_span_ms": sum(s["dur_us"] for s in expands) / 1e3,
        "widest_frontier": widest["attrs"]["frontier"],
        "widest_level_ms": widest["dur_us"] / 1e3,
        **{k: after.get(k, 0) - before.get(k, 0)
           for k in ("num_device_alloc", "num_alloc_retries")}}


def all_unique(res) -> bool:
    """Every visited row occurs once: one more lexsort and first_of_run,
    outside the timed wall."""
    rows = res.all.data[:int(res.all.count)]
    return bool(TY.first_of_run(rows[TY.lexsort_columns(rows)]).all())


def cayley_implicit(n, dev):
    """The implicit engine over the bubble-sort graph: the rank
    neighbour function (unrank, permute, rank) over the adjacent swaps'
    table.  Returns (level sizes, wall seconds)."""
    nb = P.RankNeighbors(n, CB.adjacent_swaps(n).table)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    sizes, _ = C.implicit_bfs(math.factorial(n), [P.start_rank(n)], nb,
                              device=dev)
    torch.cuda.synchronize(dev)
    return sizes, time.perf_counter() - t0


def sorted_line(what, rec, implicit_secs) -> None:
    total = math.factorial(rec["n"])
    print(f"sorted_bfs: {what} n={rec['n']} "
          f"{'fused' if rec['fused'] else 'unfused'}, "
          f"{rec['wall_s']:.3f} s wall, {rec['states_per_s']:.0f} states/s "
          f"(implicit engine {total / implicit_secs:.0f}), peak "
          f"{rec['peak_bytes']} bytes, {rec['levels']} levels at "
          f"{rec['lexsorts_scatters_per_level']} lexsorts/scatters each, "
          f"spans bfs.level {rec['level_span_ms']:.1f} ms / bfs.expand "
          f"{rec['expand_span_ms']:.1f} ms, widest level (frontier "
          f"{rec['widest_frontier']}) {rec['widest_level_ms']:.1f} ms, "
          f"{rec['num_device_alloc']} device allocations, "
          f"{rec['num_alloc_retries']} allocator retries")


def phase_sorted_bfs(dev, n=SORTED_N, m=SORTED_CPU_N) -> dict:
    """The Tier J sorted-list engine on the card: pancake n = 8 on the card
    against the CPU bit for bit (first, so that the timed runs find the
    sort kernels loaded), pancake n = 11 fused and unfused against the
    implicit engine's level sizes (diameter 13, 11! unique rows), and
    Cayley n = 11 (the Mahonian profile, diameter 55).  Each timed run
    starts from an empty allocator cache."""
    t0 = time.perf_counter()
    total = math.factorial(n)
    on_card, _, _ = PB.search(m, PB.prefix_flips(m), device=dev)
    on_cpu, _, _ = PB.search(m, PB.prefix_flips(m), device="cpu")
    expect(on_card.level_sizes == on_cpu.level_sizes, f"n={m} levels")
    expect(torch.equal(on_card.all.data.cpu(), on_cpu.all.data),
           f"n={m} all.data differs between the card and the CPU")
    expect(int(on_card.all.count) == math.factorial(m), f"n={m} count")
    print(f"sorted_bfs: n={m} on the card == on the CPU (levels, all.data "
          "bit for bit)")
    del on_card, on_cpu
    want, _, imp_secs = P.run(n, device=dev)
    torch.cuda.empty_cache()
    res_f, fused = sorted_run(lambda: PB.run(n, device=dev), n, True, dev)
    expect(fused["level_sizes"] == want, (fused["level_sizes"], want))
    expect(len(want) - 1 == P.DIAMETERS[n], want)
    expect(int(res_f.all.count) == total, f"all.count != {n}!")
    expect(all_unique(res_f), "a row of all occurs twice")
    sorted_line("pancake", fused, imp_secs)
    # kept off the card, so that the unfused peak counts its own run only
    all_f = res_f.all.data.cpu()
    del res_f
    torch.cuda.empty_cache()
    res_u, unfused = sorted_run(lambda: PB.run(n, fused=False, device=dev),
                                n, False, dev)
    expect(unfused["level_sizes"] == want, (unfused["level_sizes"], want))
    expect(torch.equal(res_u.all.data.cpu(), all_f),
           "unfused all differs from fused")
    sorted_line("pancake", unfused, imp_secs)
    del res_u, all_f
    cay_imp, cay_imp_secs = cayley_implicit(n, dev)
    torch.cuda.empty_cache()
    res_c, cayley = sorted_run(lambda: CB.run(n, device=dev), n, True, dev)
    mahonian = CB.mahonian(n)
    expect(cayley["level_sizes"] == mahonian == cay_imp, "Mahonian")
    expect(len(mahonian) - 1 == n * (n - 1) // 2, mahonian)
    expect(all_unique(res_c), "a Cayley row occurs twice")
    sorted_line("cayley", cayley, cay_imp_secs)
    del res_c
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"sorted_bfs: phase {secs:.1f} s")
    out = {"pancake_fused": fused, "pancake_unfused": unfused,
           "cayley": cayley, "implicit_pancake_wall_s": imp_secs,
           "implicit_pancake_states_per_s": total / imp_secs,
           "implicit_cayley_wall_s": cay_imp_secs,
           "implicit_cayley_states_per_s": total / cay_imp_secs,
           "phase_s": secs}
    print(json.dumps({"sorted_bfs": out}))
    return out


# ------------------------------------------------ distance oracle (K4)

K4_REPLACES = "src/repro/kernels/bitpack.py:389"
# (W, M) of the JAX tests, tests/test_kernels.py:240-244
K4_TEST_SHAPES = [(1000, 4096), (64, 7), (4096, 20000)]
ORACLE_N = 12
ORACLE_BATCHES = (4096, 1 << 20)     # a serving batch, and a bulk one
ORACLE_SMALL_BUDGET = 0.2            # of the artifact, as benchmarks/serve.py
ORACLE_REPS = 5
ORACLE_EXACT_N = 10                  # every rank against a BFS table


def k4_check(words, idx, what, got=None) -> None:
    """K4's flat form (or ``got``, a result it gave) against its plain
    version on the same inputs, bit for bit."""
    if got is None:
        got = K.bitpack_gather2(words, idx)
    want = R.bitpack_gather2_ref(words, idx)
    torch.cuda.synchronize()
    expect(got.dtype == torch.int32 and got.shape == idx.shape, what)
    err = int((got - want).abs().max()) if got.numel() else 0
    MAX_ERR["gather2"] = max(MAX_ERR["gather2"], err)
    if err:
        raise AssertionError(f"gather2 disagrees with its plain version "
                             f"({what}): max abs err {err}")


def k4c_check(table, ce, ranks, before, what, got=None) -> torch.Tensor:
    """K4's chunked form (or ``got``, what it wrote over a copy of
    ``before``) against its plain version over another copy, bit for bit;
    returns the plain version's codes."""
    if got is None:
        got = K.bitpack_gather2_chunked(table, ce, ranks, before.clone())
    want = R.bitpack_gather2_chunked_ref(table, ce, ranks, before.clone())
    torch.cuda.synchronize()
    expect(got.dtype == torch.uint8 and got.shape == ranks.shape, what)
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    MAX_ERR["gather2"] = max(MAX_ERR["gather2"], err)
    if err:
        raise AssertionError(f"gather2 (chunked) disagrees with its plain "
                             f"version ({what}): max abs err {err}")
    return want


def chunked_inputs(rng, w, ce, dev):
    """Random words of 16·w fields cut into chunks of ``ce`` fields, each
    packed into words of its own; returns (the joined words, the chunks'
    words)."""
    words = random_words(rng, w, dev)
    fields = R.unpack_fields(words).reshape(-1)
    chunks = []
    for lo in range(0, fields.numel(), ce):
        f = fields[lo:lo + ce]
        pad = torch.zeros((-f.numel()) % 16, dtype=f.dtype, device=dev)
        chunks.append(R.pack_fields(torch.cat([f, pad]).view(-1, 16)))
    return words, chunks


def chunk_edges(n_chunks, ce, dev) -> torch.Tensor:
    return torch.tensor([e for c in range(n_chunks + 1)
                         for e in (c * ce - 1, c * ce, c * ce + 1)],
                        dtype=torch.int64, device=dev)


def phase_k4_parity_edges(dev) -> None:
    rng = np.random.default_rng(4)
    for w, m in K4_TEST_SHAPES:
        words = random_words(rng, w + 1, dev)
        idx = torch.from_numpy(rng.integers(-50, 16 * w + 50, m + 1)
                               .astype(np.int32)).to(dev)
        k4_check(words[:w], idx[:m], f"W={w} M={m}")
        k4_check(words[1:], idx[1:], f"W={w} M={m} misaligned")
    words = random_words(rng, 10, dev)
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    for idx, what in ((empty, "empty"),
                      (torch.full((5,), -3, dtype=torch.int32, device=dev),
                       "all negative"),
                      (torch.full((3,), 16 * 10 + 7, dtype=torch.int32,
                                  device=dev), "all past the end")):
        k4_check(words, idx, what)
    before = K.LAUNCHES["gather2"]
    K.bitpack_gather2(words, empty)
    expect(K.LAUNCHES["gather2"] == before, "an empty batch launched K4")
    # the chunked form at the same shapes: one chunk, chunks of whole
    # words, of words shared between chunks, of 100 fields, of one word
    # (at W = 4096 a table past the shared-memory cap, read through
    # __ldg); ranks in [-50, 16W + 50) and at every boundary; out bytes
    # random; a table with null entries; misaligned ranks and out (the
    # one-at-a-time path)
    expect(4096 > K._lib().roomy_gather2_smem_chunks(), "no table past the "
           "shared-memory cap")
    for w, m in K4_TEST_SHAPES:
        for ce in (16 * w, 16 * (w // 3) + 16, 4 * (w // 3) + 4, 100, 16):
            joined, chunks = chunked_inputs(rng, w, ce, dev)
            ranks = torch.cat([
                torch.from_numpy(rng.integers(-50, 16 * w + 50, m)).to(dev),
                chunk_edges(len(chunks), ce, dev)])
            out = torch.from_numpy(rng.integers(0, 256, ranks.numel() + 1)
                                   .astype(np.uint8)).to(dev)
            want = k4c_check(chunks, ce, ranks, out[:-1],
                             f"W={w} M={m} chunks of {ce}")
            inside = (ranks >= 0) & (ranks < 16 * w)
            expect(torch.equal(want.int(), torch.where(
                inside, R.bitpack_gather2_ref(
                    joined, ranks.clamp(-1, 16 * w).int()), 0)),
                f"the chunked plain version != the flat one, W={w} ce={ce}")
            for lo in (0, 1):      # ranks and out misaligned
                buf = out.clone()
                got = K.bitpack_gather2_chunked(chunks, ce, ranks[1:],
                                                buf[1 + lo:-1 + lo or None])
                k4c_check(chunks, ce, ranks[1:], out[1 + lo:-1 + lo or None],
                          f"W={w} M={m} chunks of {ce}, misaligned", got=got)
            nulls = [None if c % 3 == 1 else t for c, t in enumerate(chunks)]
            got = K.bitpack_gather2_chunked(nulls, ce, ranks, out[:-1].clone())
            k4c_check(nulls, ce, ranks, out[:-1], f"W={w} nulls", got=got)
            chunk = torch.div(ranks, ce, rounding_mode="floor")
            kept = (ranks >= 0) & (chunk < len(chunks)) & (chunk % 3 == 1)
            expect((len(chunks) < 2 or bool(kept.any()))
                   and torch.equal(got[kept], out[:-1][kept]),
                   f"a null entry's bytes changed, W={w} ce={ce}")
    # the divide at large ranks: chunks of 2^40 + 7 fields, the first null
    ce = (1 << 40) + 7
    small = random_words(rng, 4, dev)
    ranks = torch.tensor([ce - 1, ce, ce + 1, ce + 63, ce + 64, 2 * ce - 1,
                          2 * ce, (1 << 62) + 5, -1, 0], device=dev)
    out = torch.full((ranks.numel(),), 0xAB, dtype=torch.uint8, device=dev)
    got = K.bitpack_gather2_chunked([None, small], ce, ranks, out.clone())
    k4c_check([None, small], ce, ranks, out, "chunks of 2^40 + 7", got=got)
    expect(got[[0, -1]].tolist() == [0xAB, 0xAB] and got[4:8].tolist()
           == [0, 0, 0, 0] and torch.equal(got[1:4].int(),
           R.bitpack_gather2_ref(small, torch.tensor([0, 1, 63],
                                                     dtype=torch.int32,
                                                     device=dev))),
           f"the divide at 2^40 + 7: {got.tolist()}")
    before = K.LAUNCHES["gather2"]
    e64 = torch.empty(0, dtype=torch.int64, device=dev)
    K.bitpack_gather2_chunked([small], 64, e64,
                              torch.empty(0, dtype=torch.uint8, device=dev))
    expect(K.LAUNCHES["gather2"] == before,
           "an empty batch launched K4 (chunked)")
    print("parity: K4 bit-exact at the JAX test shapes (indices in [-50, "
          "16W + 50)), misaligned, empty (no launch), all negative, all "
          "past the end; chunked: chunks of 16W, of whole words, of shared "
          "words, of 100 fields and of one word (4096 chunks, past the "
          "shared-memory cap), ranks at every chunk boundary, "
          "misaligned ranks and out, null entries (bytes kept), the divide "
          "at chunks of 2^40 + 7, empty (no launch)")


@contextlib.contextmanager
def k4_held_to_plain(calls):
    """Wraps ``ops.bitpack_gather2_chunked`` (the call the oracle makes)
    for one run: what each call writes is held bit for bit against the
    plain version on the same table, ranks and prior bytes, and its batch
    size and non-null chunks are appended to ``calls``.  The launch count
    stays in the kernel's wrapper, and the plain version launches nothing
    that it counts."""
    orig = OPS.bitpack_gather2_chunked

    def held(table, ce, ranks, out, **kw):
        before = out.clone()
        got = orig(table, ce, ranks, out, **kw)
        k4c_check(table, ce, ranks, before,
                  f"oracle call {len(calls)}, M={ranks.numel()}", got=got)
        calls.append((ranks.numel(),
                      [c for c, w in enumerate(table) if w is not None]))
        return got
    OPS.bitpack_gather2_chunked = held
    try:
        yield calls
    finally:
        OPS.bitpack_gather2_chunked = orig


def published_words(orc) -> torch.Tensor:
    """The label words of an open oracle whose chunks hold a whole number
    of words, joined from its cache's chunk words (each chunk of pancake
    n = 10 and 12 holds exactly n!/16 fields)."""
    expect(orc.chunk_elems % 16 == 0, "chunks that share a word")
    return torch.cat([orc.cache.get(c).words for c in range(orc.n_chunks)])


def random_ranks(rng, total, m, dev) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, total, m)).to(dev)


def k4_bound(words, idx) -> dict:
    """K4's flat form: bytes at 3.35 TB/s, the M int32 indices read and the
    M int32 fields written once, and each distinct 32-byte sector of the
    words that the valid indices touch read once (a sector is 8 words,
    128 fields)."""
    i = idx.long()
    i = i[(i >= 0) & (i < 16 * words.shape[0])]
    sectors = int(torch.unique(i >> 7).numel())
    nbytes = 8 * idx.numel() + 32 * sectors
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "sectors": sectors}


def k4c_bound(table, ce, ranks) -> dict:
    """K4's chunked form: bytes at 3.35 TB/s, the M int64 ranks read and
    the M uint8 codes written once, and each distinct 32-byte sector of
    the chunks' words that the ranks touch read once (one sector: a
    chunk's words 8 at a time from its first)."""
    chunk = torch.div(ranks, ce, rounding_mode="floor")
    local = ranks - chunk * ce
    words = torch.tensor([-1 if w is None else w.shape[0] for w in table],
                         device=ranks.device)
    ok = ((ranks >= 0) & (chunk < len(table))
          & (local < 16 * words[chunk.clamp(0, len(table) - 1)]))
    key = chunk[ok] * (1 << 40) + (local[ok] >> 7)
    sectors = int(torch.unique(key).numel())
    nbytes = 9 * ranks.numel() + 32 * sectors
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "sectors": sectors}


def k4_groups(chunk_bytes, budget) -> int:
    """The K4 launches of a ``codes`` batch that touches every chunk: the
    chunks in ascending runs whose bytes fit ``budget``, a chunk larger
    than it a run of its own."""
    runs, size = 0, None
    for b in chunk_bytes:
        if size is None or size + b > budget:
            runs, size = runs + 1, 0
        size += b
    return runs


def phase_k4_serving(orc, words, total, dev) -> dict:
    """K4 on the n = 12 oracle's 16 chunks (``orc``'s cache) at M = 4096
    and M = 1,048,576 random ranks: the chunked form bit-exact against its
    plain version and, over the joined label words, against the flat plain
    gather; ranks at every chunk boundary (the divide); a planted fault
    (one field of one chunk's words flipped) caught; a null entry's bytes
    kept.  Device times (a fresh batch each repetition, so the words come
    cold from memory as a new query's do) of the kernel over a prebuilt
    device table, of the wrapper (which stages the table), and of the flat
    form over the joined words, beside their bounds and the plain
    version's."""
    rng = np.random.default_rng(12)
    ce = orc.chunk_elems
    table = [orc.cache.get(c).words for c in range(orc.n_chunks)]
    edges = chunk_edges(orc.n_chunks, ce, dev)
    out = {}
    for m in ORACLE_BATCHES:
        batches = [random_ranks(rng, total, m, dev) for _ in range(REPS + 1)]
        ranks = torch.cat([batches[0][:m - edges.numel()], edges])
        before = torch.full((m,), 0xAB, dtype=torch.uint8, device=dev)
        want = k4c_check(table, ce, ranks, before, f"n=12 chunks, M={m}")
        flat = R.bitpack_gather2_ref(words, ranks.clamp(-1, total).int())
        expect(torch.equal(want.int(), flat),
               f"K4 over the chunks != the flat plain gather (M={m})")
        e = int(ranks[0])
        c, loc = e // ce, e % ce
        faulted = list(table)
        faulted[c] = table[c].clone()
        faulted[c][loc >> 4] ^= 1 << (2 * (loc & 15))
        got = K.bitpack_gather2_chunked(faulted, ce, ranks, before.clone())
        caught = int((got.int() - want.int()).abs().max())
        expect(caught > 0, f"the K4 check misses a flipped field (M={m})")
        del faulted
        nulls = list(table)
        nulls[c] = None
        got = K.bitpack_gather2_chunked(nulls, ce, ranks, before.clone())
        k4c_check(nulls, ce, ranks, before, f"n=12, chunk {c} null", got=got)
        mine = torch.div(ranks, ce, rounding_mode="floor") == c
        expect(bool((got[mine] == 0xAB).all())
               and torch.equal(got[~mine], want[~mine]),
               f"a null entry's bytes changed (M={m})")
        codes = torch.empty(m, dtype=torch.uint8, device=dev)
        fresh = itertools.cycle(batches)
        dev_table = K.chunk_table(table, dev)
        ms = device_ms(lambda: K.launch_gather2_chunked(
            dev_table, ce, next(fresh), codes))
        wrapper_ms = device_ms(lambda: K.bitpack_gather2_chunked(
            table, ce, next(fresh), codes))
        idx32 = [b.int() for b in batches]
        fresh32 = itertools.cycle(idx32)
        flat_ms = device_ms(lambda: K.bitpack_gather2(words, next(fresh32)))
        plain = device_ms(lambda: R.bitpack_gather2_chunked_ref(
            table, ce, batches[0], codes), reps=PLAIN_REPS)
        res = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain,
               **k4c_bound(table, ce, batches[0]), "flat_ms": flat_ms,
               "flat_bound_ms": k4_bound(words, idx32[0])["bound_ms"],
               "planted_fault_err": caught}
        out[m] = res
        print(f"time: K4 over the n={ORACLE_N} oracle's {len(table)} chunks "
              f"(chunks of {ce} fields), M={m}: {ms:.4f} ms on the device "
              f"(through the wrapper, which stages the table: "
              f"{wrapper_ms:.4f}), bound {res['bound_ms']:.4f} ms (bytes: "
              f"{res['bytes']} = 9M + 32 x {res['sectors']} sectors at 3.35 "
              f"TB/s), {res['bound_ms'] / ms:.1%} of the bound, "
              f"{m / ms * 1e3:.3e} codes/s; the flat form over the joined "
              f"words {flat_ms:.4f} ms (bound {res['flat_bound_ms']:.4f}); "
              f"plain {plain:.4f} ms (median of {PLAIN_REPS}); library none;"
              f" planted fault (one field flipped) read {caught}")
    return out


def check_paths(dist, chains, ranks, start, gen) -> None:
    """Each chain: length d + 1, begins at its rank, ends at the start
    rank, and each step goes to a neighbour."""
    lens = [ch.numel() for ch in chains]
    expect(lens == [max(d, 0) + 1 for d in dist.tolist()], "path lengths")
    expect(torch.equal(torch.stack([ch[0] for ch in chains]), ranks),
           "paths begin at their ranks")
    reached = [ch for ch, d in zip(chains, dist.tolist()) if d >= 0]
    expect(all(int(ch[-1]) == start for ch in reached),
           "paths end at the start rank")
    a = torch.cat([ch[:-1] for ch in reached])
    b = torch.cat([ch[1:] for ch in reached])
    expect(bool((gen(a) == b[:, None]).any(dim=1).all()),
           "a path steps to a non-neighbour")


def serve_batches(fn, rng, total, m, dev, reps=ORACLE_REPS) -> dict:
    """Median wall (host clock, synchronised) of ``fn`` over ``reps`` fresh
    batches of m random ranks, and its K4 launches per batch."""
    fn(random_ranks(rng, total, m, dev))                   # warm-up
    torch.cuda.synchronize()
    before, walls = K.LAUNCHES["gather2"], []
    for _ in range(reps):
        ranks = random_ranks(rng, total, m, dev)
        t0 = time.perf_counter()
        fn(ranks)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    return {"m": m, "wall_s": wall, "queries_per_s": m / wall,
            "k4_launches_per_batch": (K.LAUNCHES["gather2"] - before) / reps}


def phase_oracle_serve(root, n, sizes, dev):
    """The main path of the serving tier: pancake n = 12 labelled and
    published through the app's ``publish`` (level sizes == the BFS's, the
    per-code counts hold) and served by ``DistanceOracle``, with every
    count set to 0 just before and read just after, and every K4 call of
    the run held to the plain version; then K4 on the published words
    (``phase_k4_serving``), the readings at a budget that holds the
    artifact and at 20% of it, and the compressed artifact.  Returns the
    readings and K4's."""
    total, start = math.factorial(n), P.start_rank(n)
    gen = P.neighbors(n)
    rng = np.random.default_rng(7)
    art = os.path.join(root, f"pancake{n}")
    reset_all_launches()
    O.reset_stats()
    t0 = time.perf_counter()
    meta = P.publish(n, sizes, art, device=dev)
    publish_s = time.perf_counter() - t0
    expect(meta["level_sizes"] == sizes and meta["n_chunks"] == 16
           and len(sizes) - 1 == P.DIAMETERS[n] == 14, meta)
    label_launches = dict(K.LAUNCHES)
    expect(label_launches == {"mark_rotate_count": len(sizes),
                              "scatter_mark": len(sizes) + 1,
                              "lut_count": 4, "gather2": 0}, label_launches)
    # K2 marks the start twice, then K1 and K2 take each level's targets
    # (K2 only where the level has a next one)
    ms = [s * (n - 1) for s in sizes]
    want = level_routes(-(-total // 16), [1, 1] + ms + ms[:-1])
    expect(dict(K.ROUTE_LAUNCHES) == want,
           f"publish K1/K2 routes {dict(K.ROUTE_LAUNCHES)}, want {want}")
    label_routes = dict(K.ROUTE_LAUNCHES)
    full = O.DistanceOracle(art, cache_bytes=1 << 30, gen_neighbors=gen,
                            device=dev)
    probe = random_ranks(rng, total, ORACLE_BATCHES[0], dev)
    touched_chunks = torch.unique(probe // full.chunk_elems).tolist()
    touched = len(touched_chunks)
    diameter = P.DIAMETERS[n]
    with k4_held_to_plain([]) as calls:
        before = K.LAUNCHES["gather2"]
        codes = full.codes(probe)
        expect(K.LAUNCHES["gather2"] - before == 1 == len(calls)
               and len(calls[0][1]) == touched,
               f"codes at a budget holding the artifact launched K4 "
               f"{K.LAUNCHES['gather2'] - before} times over {calls}, want "
               f"once over the {touched} chunks it touches")
        dist, chains = full.paths(probe)
        check_paths(dist, chains, probe, start, gen)
        before = K.LAUNCHES["gather2"]
        expect(torch.equal(full.distance(probe), dist), "distance != paths")
        dist_launches = K.LAUNCHES["gather2"] - before
        expect(0 < dist_launches <= diameter + 1,
               f"a distance batch launched K4 {dist_launches} times, more "
               f"than the diameter + 1 ({diameter + 1})")
    expect(bool(((dist % 3 + 1) == codes.long()).all()),
           "a distance disagrees with its code")
    launches = dict(K.LAUNCHES)
    expect(launches["gather2"] > 0 and launches["gather2"] == len(calls),
           (launches, len(calls)))
    words = published_words(full)
    expect(words.numel() == -(-total // 16), words.shape)
    expect(torch.equal(codes.int(), R.bitpack_gather2_ref(
        words, probe.int())), "codes != the plain gather over the label words")
    art_bytes = full.artifact_bytes
    print(f"oracle: labelled and published pancake n={n} in {publish_s:.3f} "
          f"s ({total / publish_s:.0f} states/s; {art_bytes} bytes in "
          f"{meta['n_chunks']} chunks), level sizes == the BFS's, diameter "
          f"{P.DIAMETERS[n]}, per-code counts hold; launches {launches} (the "
          f"publish alone {label_launches}, K1/K2 by route {label_routes}, "
          f"each the route K.route names); one K4 launch for "
          f"{probe.numel()} codes over the {touched} chunks they touch, "
          f"{dist_launches} for a distance batch (diameter + 1 = "
          f"{diameter + 1} at most); each of the run's {len(calls)} K4 calls "
          f"(M {min(c[0] for c in calls)}..{max(c[0] for c in calls)}) == "
          f"the plain version, and the "
          f"codes == the plain gather over the joined label words; every "
          f"path of the sample holds (length d + 1, neighbours, ending at "
          f"the start; longest {int(dist.max())})")
    res = {"publish_s": publish_s, "artifact_bytes": art_bytes,
           "launches": launches, "label_routes": label_routes,
           "k4_launches_first_codes": 1, "k4_touched_first_codes": touched,
           "k4_launches_first_distance": dist_launches,
           "k4_calls_held": len(calls)}
    k4 = phase_k4_serving(full, words, total, dev)
    del words
    m = ORACLE_BATCHES[0]
    for b in ORACLE_BATCHES:
        res[f"codes_{b}"] = serve_batches(full.codes, rng, total, b, dev)
        expect(res[f"codes_{b}"]["k4_launches_per_batch"] == 1,
               f"codes batches of {b}: {res[f'codes_{b}']}")
    res[f"distance_{m}"] = serve_batches(full.distance, rng, total, m, dev,
                                         reps=3)
    res[f"paths_{m}"] = serve_batches(full.paths, rng, total, m, dev,
                                      reps=3)
    for key in (f"distance_{m}", f"paths_{m}"):
        expect(res[key]["k4_launches_per_batch"] <= diameter + 1, res[key])
    chunk_bytes = [full._chunk_bytes(c) for c in range(full.n_chunks)]
    full.close()
    for key, r in list(res.items()):
        if isinstance(r, dict) and "queries_per_s" in r:
            print(f"oracle: {key} at a budget holding the artifact: "
                  f"{r['queries_per_s']:.1f} queries/s ({r['wall_s']:.4f} s "
                  f"a batch of {r['m']}), {r['k4_launches_per_batch']:.1f} "
                  f"K4 launches a batch")
    budget = int(ORACLE_SMALL_BUDGET * art_bytes)
    groups = k4_groups(chunk_bytes, budget)
    O.reset_stats()
    with O.DistanceOracle(art, cache_bytes=budget, gen_neighbors=gen,
                          device=dev) as small:
        with k4_held_to_plain([]) as small_calls:
            expect(torch.equal(small.codes(probe), codes), "codes at 20%")
        expect([c for _, cs in small_calls for c in cs] == touched_chunks
               and len(small_calls) == k4_groups(
                   [chunk_bytes[c] for c in touched_chunks], budget) and all(
            sum(chunk_bytes[c] for c in cs) <= budget or len(cs) == 1
            for _, cs in small_calls),
            f"codes at 20%: K4 over {[cs for _, cs in small_calls]}, want "
            f"{groups} ascending groups within {budget} bytes")
        small_codes = serve_batches(small.codes, rng, total, m, dev)
        expect(small_codes["k4_launches_per_batch"] == groups, small_codes)
        small_dist = serve_batches(small.distance, rng, total, m, dev,
                                   reps=1)
        stats = dict(O.STATS)
    expect(stats["resident_peak"] <= budget and stats["evictions"] > 0
           and O.STATS["resident_bytes"] == 0, (stats, budget))
    print(f"oracle: budget {budget} bytes (20% of the artifact): codes "
          f"{small_codes['queries_per_s']:.1f} queries/s, "
          f"{small_codes['k4_launches_per_batch']:.1f} K4 launches a batch "
          f"({groups} groups of chunks within the budget), distance "
          f"{small_dist['queries_per_s']:.1f} queries/s, "
          f"{small_dist['k4_launches_per_batch']:.1f} K4 launches a batch "
          f"(batches of {m}); counters {stats}; resident_peak <= budget")
    t0 = time.perf_counter()
    packed = P.publish(n, sizes, art + "_rle2", compress=True, device=dev)
    compress_s = time.perf_counter() - t0
    expect(packed["chunk_sha256"] == meta["chunk_sha256"]
           and packed["format"] == 2, "the compressed publish differs")
    stored = sum(os.path.getsize(os.path.join(art + "_rle2", "v000001",
                                              f"b{c:06d}.rmz"))
                 for c in range(packed["n_chunks"]))
    with O.DistanceOracle(art + "_rle2", cache_bytes=1 << 30,
                          device=dev) as rle:
        expect(torch.equal(rle.codes(probe), codes), "rle2 codes differ")
    print(f"oracle: compressed publish in {compress_s:.3f} s, {stored} "
          f"bytes stored for {art_bytes}; identical chunk_sha256 and codes")
    res.update(small_budget=budget, small_groups=groups,
               small_codes=small_codes,
               small_distance=small_dist, small_stats=stats,
               compressed_publish_s=compress_s, compressed_bytes=stored)
    return res, k4


def phase_oracle_exact(root, dev, n=ORACLE_EXACT_N) -> dict:
    """Every rank of pancake n = 10 through the oracle's ``distance`` on the
    card, against a plain BFS distance table made there; and the labelling
    through the kernels (K1 + K2, K3) against the same labelling through
    their plain versions on the card (``impl="ref"``): the same level sizes
    and bit-identical label words, which are the published chunks'."""
    total, start = math.factorial(n), [P.start_rank(n)]
    art = os.path.join(root, f"pancake{n}")
    P.publish(n, None, art, device=dev)
    ref = P.ram_distances(n, dev)
    sk, wk = O.label_distances_mod3(total, start, P.neighbors(n), device=dev)
    sr, wr = O.label_distances_mod3(total, start, P.neighbors(n),
                                    impl="ref", device=dev)
    expect(sk == sr and torch.equal(wk, wr),
           f"n={n}: kernel and plain labels differ")
    with O.DistanceOracle(art, cache_bytes=1 << 30,
                          gen_neighbors=P.neighbors(n), device=dev) as orc:
        expect(torch.equal(published_words(orc), wk),
               f"n={n}: published chunks != the label words")
        t0 = time.perf_counter()
        dist = orc.distance(torch.arange(total, device=dev))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        sizes = orc.level_sizes
    expect(torch.equal(dist, ref), f"n={n}: oracle distances != BFS table")
    expect(sizes == torch.bincount(ref).tolist() == sk
           and len(sizes) - 1 == P.DIAMETERS[n], sizes)
    print(f"oracle: n={n}, labels through the kernels == through the plain "
          f"versions on the card (levels and words) == the published chunks;"
          f" all {total} distances == the plain BFS table on the card "
          f"({secs:.3f} s, {total / secs:.0f} queries/s in one batch)")
    return {"n": n, "states": total, "wall_s": secs,
            "queries_per_s": total / secs}


def phase_oracle(dev, sizes) -> dict:
    """K4 parity, then the serving tier at n = 12 (labels, publish, K4 on
    the published words, serving), and exactness at n = 10."""
    phase_k4_parity_edges(dev)
    root = tempfile.mkdtemp(prefix="oracle_")
    try:
        serve, k4 = phase_oracle_serve(root, ORACLE_N, sizes, dev)
        exact = phase_oracle_exact(root, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"k4": {str(m): r for m, r in k4.items()}, "serve": serve,
           "exact": exact}
    print(json.dumps({"oracle": out}))
    return out


# ------------------------------ Roomy delayed-update structures (K5)

K5_SOURCE = "src/repro_torch/kernels/csrc/bucket_scatter.cu"
K5_REPLACES = "src/repro/kernels/bucket_scatter.py:65"
# The shapes of K5's JAX tests, (N, M, D) at tests/test_kernels.py:129-134.
K5_TEST_SHAPES = [(16, 100, 8), (64, 37, 4), (8, 256, 16), (32, 5, 8)]
K5_TOL = 1e-4                 # atol = rtol, tests/test_kernels.py:150-151
# The JAX tests' elementwise limit holds for their runs of at most 256 ops.
# A Zipf head token's run of ~17,000 N(0, 1) payloads sums to ~130, and two
# float32 sums of it in different orders differ by ~1e-3 from rounding
# alone, so where runs are that long the sync is held per row to
# ||got - want|| <= K5_ROW_REL_TOL * ||want|| (a payload row left out is
# ~1e-2 of a hot row and more of any other).
K5_ROW_REL_TOL = 1e-4
K5_SPLIT = 256                # the longest run K5 never cuts (its .cu)
EMB_BATCH = 32 * 4096         # the queue: a 32 x 4096-token batch of gradients
ZIPF_S = 1.1                  # token frequencies, rank^-s over the vocabulary
PREFIX_LOG2 = 27              # parallel_prefix over 2^27 float32 (512 MB)
# A prefix of positive terms summed through a tree of depth <= 27 is off by
# at most 27 * 2^-24 = 1.61e-6 of itself (to first order); the limit adds
# a margin over that.
PREFIX_REL_TOL = 2e-6
HT_KEYS = 1 << 22             # the hash table's queue: 4,194,304 keys
HT_WIDTH = 2
SHARD_SHAPE = (65536, 512, 1 << 18)   # the sharded path's rows, width, ops
SHARD_WORDS = 1 << 20                 # its bit array (16.8M elements)


def k5_check(table, idx, pay, what, exact=False, got=None):
    """K5 (or ``got``, a result K5 gave) against its plain version on the
    same inputs: atol = rtol = K5_TOL, or bit for bit when ``exact``.
    Returns the max abs error."""
    if got is None:
        got = BS.bucket_scatter_add(table, idx, pay)
    want = R.bucket_scatter_add_ref(table, idx, pay)
    torch.cuda.synchronize()
    expect(got.shape == want.shape and got.dtype == torch.float32, what)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    MAX_ERR["bucket_scatter_add"] = max(MAX_ERR["bucket_scatter_add"], err)
    ok = (torch.equal(got, want) if exact else
          torch.allclose(got, want, atol=K5_TOL, rtol=K5_TOL))
    if not ok:
        raise AssertionError(f"bucket_scatter_add disagrees with its plain "
                             f"version ({what}): max abs err {err}")
    return err


def k5_inputs(rng, n, m, d, lo, hi, dev, sort=False):
    table = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    idx = rng.integers(lo, hi, m).astype(np.int32)
    if sort:
        idx = np.sort(idx)
    pay = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    return table.to(dev), torch.from_numpy(idx).to(dev), pay.to(dev)


def phase_k5_parity_edges(dev) -> dict:
    """K5 against its plain version on the card at its edge cases, and a
    planted fault the limit must reject."""
    rng = np.random.default_rng(5)
    for n, m, d in K5_TEST_SHAPES:
        for sort in (False, True):
            k5_check(*k5_inputs(rng, n, m, d, -n - 3, n + 3, dev, sort),
                     f"N={n} M={m} D={d} sorted={sort}")
    # one run of all M ops, cut into segments of K5_SPLIT..2*K5_SPLIT-1:
    # sixteenths of small integers, so every order of the sums is exact
    for m, d in ((100_000, 8), (K5_SPLIT + 1, 64)):
        table = torch.zeros(4, d, device=dev)
        pay = torch.from_numpy(rng.integers(-8, 9, (m, d)).astype(np.float32)
                               / 16).to(dev)
        idx = torch.full((m,), 2, dtype=torch.int32, device=dev)
        k5_check(table, idx, pay, f"one run of M={m}", exact=True)
        k5_check(table, idx - 4, pay, f"one run of M={m} at -2", exact=True)
    k5_check(*k5_inputs(rng, 8, 256, 16, 3, 4, dev), "one run, N(0,1)")
    # each index at most once (negatives included): table + payload exactly
    n = 5000
    uniq = rng.permutation(np.arange(-n, n))[:3000]
    _, first = np.unique(uniq % n, return_index=True)
    idx = torch.from_numpy(uniq[np.sort(first)].astype(np.int32)).to(dev)
    table, _, pay = k5_inputs(rng, n, idx.shape[0], 96, 0, 1, dev)
    k5_check(table, idx, pay, "one op an index", exact=True)
    # M = 0 launches nothing and copies the table
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    before = BS.LAUNCHES["bucket_scatter_add"]
    got = BS.bucket_scatter_add(table, empty, pay[:0])
    expect(BS.LAUNCHES["bucket_scatter_add"] == before, "M = 0 launched K5")
    expect(torch.equal(got, table), "M = 0 changed the table")
    # every index dropped
    drop = torch.from_numpy(np.concatenate([
        rng.integers(n, 3 * n, 500), rng.integers(-3 * n, -n, 500)]).astype(
            np.int32)).to(dev)
    k5_check(table, drop, pay[:1000], "every index dropped", exact=True)
    expect(torch.equal(BS.bucket_scatter_add(table, drop, pay[:1000]), table),
           "dropped ops changed the table")
    # D = 1 and D = 2304 (the main path's width), unsorted and sorted
    k5_check(*k5_inputs(rng, 1000, 5000, 1, -1003, 1003, dev), "D=1")
    k5_check(*k5_inputs(rng, 512, 4096, 2304, -515, 515, dev, True),
             "D=2304 sorted")
    k5_check(*k5_inputs(rng, 512, 4096, 2304, -515, 515, dev), "D=2304")
    # a table and a payload given as strided views (read in place)
    wide, idx, wpay = k5_inputs(rng, 300, 2000, 40, -303, 303, dev)
    k5_check(wide[:, 5:29], idx, wpay[:, 3:27], "strided table and payload")
    k5_check(wide[::2, :17], idx % 150, wpay[:, :17], "every other row")
    # the planted fault: one payload row left out must break the limit
    table, idx, pay = k5_inputs(rng, 64, 256, 16, 0, 64, dev)
    idx[1] = idx[0]
    faulty = BS.bucket_scatter_add(table, idx[1:], pay[1:])
    want = R.bucket_scatter_add_ref(table, idx, pay)
    torch.cuda.synchronize()
    fault_err = float((faulty - want).abs().max())
    expect(not torch.allclose(faulty, want, atol=K5_TOL, rtol=K5_TOL),
           f"a payload row left out passed the limit ({fault_err})")
    print(f"parity: K5 within {K5_TOL} of its plain version at the JAX "
          f"test shapes (sorted, unsorted, idx in [-N-3, N+3)), one run of "
          f"100000 ops (bit-exact), one op an index (bit-exact), M = 0 (no "
          f"launch), every index dropped, D = 1 and 2304, strided views; "
          f"max abs err {MAX_ERR['bucket_scatter_add']:.3e}; a payload row "
          f"left out reads {fault_err:.3e} and is rejected")
    return {"max_abs_err": MAX_ERR["bucket_scatter_add"],
            "planted_fault_err": fault_err}


def row_rel(got, want) -> float:
    """max over rows of ||got - want|| / ||want||."""
    num = torch.linalg.vector_norm(got - want, dim=1)
    return float((num / torch.linalg.vector_norm(want, dim=1)).max())


def zipf_tokens(rng, vocab, m):
    """m token ids with rank frequencies ∝ rank^-ZIPF_S over the whole
    vocabulary (inverse CDF), ranks mapped to ids by a seeded permutation."""
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -ZIPF_S
    cdf = np.cumsum(w / w.sum())
    ranks = np.minimum(np.searchsorted(cdf, rng.random(m)), vocab - 1)
    return rng.permutation(vocab)[ranks].astype(np.int32)


def phase_embedding_sync(dev) -> dict:
    """The main path of K5: gemma2-2b's embedding gradient as a RoomyArray
    (256,000 x 2304 float32) and a queue of 131,072 token rows with Zipf
    ids, through ``array.update`` then ``array.sync(add, add, pred)``, with
    every count set to 0 just before: K5 launched exactly once, the result
    within K5_TOL of the same sync with ``impl="ref"`` on the card, the
    predicate counts equal.  Then K5 at that shape beside its bound, the
    plain version and ``torch.index_add``."""
    cfg = get_config(ARCH)
    vocab, dim, m = cfg.vocab_size, cfg.d_model, EMB_BATCH
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.randn(vocab, dim, generator=gen, device=dev)
    pay = torch.randn(m, dim, generator=gen, device=dev)
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(zipf_tokens(rng, vocab, m)).to(dev)
    pred = lambda rows: rows[..., 0] > 0          # noqa: E731
    ra = RA.make(data, m, payload_shape=(dim,), payload_dtype=torch.float32,
                 pred=pred)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    t0 = time.perf_counter()
    queued, overflow = RA.update(ra, ids, pay)
    out = RA.sync(queued, RA.add, RA.add, pred=pred)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(BS.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    expect(launches == {"bucket_scatter_add": 1}, launches)
    expect(not bool(overflow) and int(queued.q_n) == m, "queue overflow")
    ref = RA.sync(queued, RA.add, RA.add, pred=pred, impl="ref")
    sync(dev)
    err = float((out.data - ref.data).abs().max())
    rel = row_rel(out.data, ref.data)
    expect(rel <= K5_ROW_REL_TOL, f"the K5 sync is {rel} off the plain one "
           f"per row (max abs err {err})")
    short = torch.bincount(ids.long(), minlength=vocab) <= K5_SPLIT
    expect(torch.allclose(out.data[short], ref.data[short], atol=K5_TOL,
                          rtol=K5_TOL), "rows of runs <= 256 ops off 1e-4")
    pc, pr = int(out.pcount), int(ref.pcount)
    expect(pc == pr == int(pred(out.data).sum()), (pc, pr))
    expect(bool(torch.isfinite(out.data).all()), "non-finite rows")
    MAX_ERR["bucket_scatter_add"] = max(MAX_ERR["bucket_scatter_add"], err)
    del out, ref
    # the same update + sync again, with the allocator's blocks in place
    t1 = time.perf_counter()
    RA.sync(RA.update(ra, ids, pay)[0], RA.add, RA.add, pred=pred)
    sync(dev)
    wall_again = time.perf_counter() - t1
    counts = torch.bincount(ids.long(), minlength=vocab)
    touched, longest = int((counts > 0).sum()), int(counts.max())
    print(f"main path: RoomyArray {vocab}x{dim} float32 (gemma2-2b's "
          f"embedding gradient), update + sync(add, add, pred) of {m} Zipf "
          f"rows (s = {ZIPF_S}, {touched} distinct ids, the longest run "
          f"{longest}): {wall * 1e3:.3f} ms wall, {m / wall:.1f} ops/s "
          f"(again: {wall_again * 1e3:.3f} ms, {m / wall_again:.1f} ops/s), "
          f"peak {peak} bytes, launches {launches}; == impl='ref' per row "
          f"within {rel:.3e} (limit {K5_ROW_REL_TOL}; max abs err {err:.3e}; "
          f"rows of runs <= {K5_SPLIT} ops within {K5_TOL} elementwise), "
          f"pcount {pc} == plain {pr}")
    # K5 alone on the sorted queue that the sync hands it
    idx_s, order = torch.sort(ids, stable=True)
    pay_s = pay[order]
    del queued, ra
    torch.cuda.empty_cache()
    got = BS.bucket_scatter_add(data, idx_s, pay_s)
    lib = torch.index_add(data, 0, idx_s, pay_s)
    want = R.bucket_scatter_add_ref(data, idx_s, pay_s)
    exact = data.double().index_add_(0, idx_s, pay_s.double())
    sync(dev)
    rels = {"plain": row_rel(got, want), "index_add": row_rel(lib, got),
            "k5_f64": row_rel(got.double(), exact),
            "plain_f64": row_rel(want.double(), exact)}
    expect(max(rels.values()) <= K5_ROW_REL_TOL, rels)
    faulty = BS.bucket_scatter_add(data, idx_s[1:], pay_s[1:])
    rels["fault_row_left_out"] = row_rel(faulty, want)
    expect(rels["fault_row_left_out"] > K5_ROW_REL_TOL, rels)
    print(f"parity: K5 at the main-path shape, per-row relative error: "
          f"{json.dumps(rels)}")
    del got, lib, want, exact, faulty
    nbytes = 2 * 4 * vocab * dim + 4 * m + 4 * m * dim
    times = {
        "ms": median_ms(lambda: BS.bucket_scatter_add(data, idx_s, pay_s)),
        "plain_ms": median_ms(lambda: R.bucket_scatter_add_ref(data, idx_s,
                                                               pay_s)),
        "library_ms": median_ms(lambda: torch.index_add(data, 0, idx_s,
                                                        pay_s)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": nbytes}
    print(f"time: K5 at {vocab}x{dim}, M={m} sorted: {times['ms']:.4f} ms, "
          f"bound {times['bound_ms']:.4f} ms ({nbytes} bytes at 3.35 TB/s: "
          f"the table read and written, the indices and the payload read), "
          f"plain {times['plain_ms']:.4f} ms, index_add "
          f"{times['library_ms']:.4f} ms")
    return {"wall_s": wall, "ops_per_s": m / wall, "wall_again_s": wall_again,
            "peak_bytes": peak,
            "launches": launches["bucket_scatter_add"], "max_abs_err": err,
            "max_row_rel_err": rel,
            "pcount": pc, "distinct_ids": touched, "longest_run": longest,
            "times": times,
            "shape": f"gemma2-2b embedding gradient, table {vocab}x{dim} "
                     f"float32, M = {m} sorted Zipf ids (s = {ZIPF_S})"}


def phase_prefix(dev) -> dict:
    """``parallel_prefix(add)`` over 2^27 float32 elements: 27 K5 launches,
    bit-identical to ``impl="ref"`` on the card (each index gets one op a
    round, a single addition), within PREFIX_REL_TOL of a float64 cumsum;
    ``chain_reduce(add)`` at the same size: 1 launch, exact."""
    n = 1 << PREFIX_LOG2
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.rand(n, generator=gen, device=dev)
    ra = RA.make(x, n, payload_dtype=torch.float32)
    sync(dev)
    reset_all_launches()
    t0 = time.perf_counter()
    out = C.parallel_prefix(ra, RA.add)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = BS.LAUNCHES["bucket_scatter_add"]
    expect(launches == PREFIX_LOG2, f"{launches} K5 launches, not 27")
    ref = C.parallel_prefix(ra, RA.add, impl="ref")
    expect(torch.equal(out.data, ref.data), "prefix != impl='ref'")
    del ref
    want = torch.cumsum(x.double(), 0)
    rel = float(((out.data.double() - want).abs() / want).max())
    expect(rel <= PREFIX_REL_TOL, f"prefix {rel} off the float64 cumsum")
    del out, want
    reset_all_launches()
    t1 = time.perf_counter()
    chain = C.chain_reduce(ra, RA.add)
    sync(dev)
    chain_wall = time.perf_counter() - t1
    expect(BS.LAUNCHES["bucket_scatter_add"] == 1, dict(BS.LAUNCHES))
    expect(torch.equal(chain.data[1:], x[1:] + x[:-1])
           and bool(chain.data[0] == x[0]), "chain reduction wrong")
    expect(torch.equal(chain.data, C.chain_reduce(ra, RA.add,
                                                  impl="ref").data),
           "chain != impl='ref'")
    print(f"main path: parallel_prefix(add) over 2^{PREFIX_LOG2} float32: "
          f"{wall:.3f} s, {launches} K5 launches, == impl='ref' bit for bit, "
          f"max rel err vs float64 cumsum {rel:.3e} (limit "
          f"{PREFIX_REL_TOL}); chain_reduce {chain_wall:.3f} s, 1 launch, "
          f"exact")
    return {"wall_s": wall, "launches": launches, "max_rel_err": rel,
            "chain_wall_s": chain_wall}


def ht_round(dev, keys, vals, rm, keys2, vals2, queries):
    """Insert, sync (the benchmark's add combine), remove + insert, sync,
    lookup: the same calls on ``dev``."""
    add = lambda a, b: a + b                             # noqa: E731
    app = lambda o, g, p: torch.where(p, o + g, g)       # noqa: E731
    t = lambda a: a.to(dev)                              # noqa: E731
    n = keys.shape[0]
    ht = HT.make(2 * n, HT_WIDTH, n, device=dev)
    t0 = time.perf_counter()
    ht, ov1 = HT.insert(ht, t(keys), t(vals))
    ht, ov2 = HT.sync(ht, add, app)
    ht, ov3 = HT.remove(ht, t(rm))
    ht, ov4 = HT.insert(ht, t(keys2), t(vals2))
    ht, ov5 = HT.sync(ht, add, app)
    got, found = HT.lookup(ht, t(queries))
    if dev.type == "cuda":
        sync(dev)
    wall = time.perf_counter() - t0
    expect(not any(bool(o) for o in (ov1, ov2, ov3, ov4, ov5)), "overflow")
    return ht, got, found, wall


def phase_hashtable(dev) -> dict:
    """RoomyHashTable with 4,194,304 width-2 keys on the card: the keys,
    values, count and lookups identical to the same calls on the CPU."""
    rng = np.random.default_rng(SEED + 2)
    n = HT_KEYS
    pool = rng.integers(0, 1 << 32, (n // 2, HT_WIDTH), dtype=np.uint64
                        ).astype(np.uint32).view(np.int32)
    keys = torch.from_numpy(pool[rng.integers(0, n // 2, n)])
    vals = torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32))
    rm = torch.from_numpy(pool[rng.integers(0, n // 2, n // 8)])
    keys2 = torch.from_numpy(pool[rng.integers(0, n // 2, n // 2)])
    vals2 = torch.from_numpy(rng.integers(0, 1000, n // 2).astype(np.int32))
    queries = torch.cat([keys[: n // 2], torch.from_numpy(rng.integers(
        0, 1 << 32, (n // 2, HT_WIDTH), dtype=np.uint64).astype(np.uint32)
        .view(np.int32))])
    args = (keys, vals, rm, keys2, vals2, queries)
    ht, got, found, wall = ht_round(dev, *args)
    cpu = torch.device("cpu")
    hc, gc, fc, cpu_wall = ht_round(cpu, *args)
    expect(int(ht.count) == int(hc.count), (int(ht.count), int(hc.count)))
    expect(torch.equal(ht.keys.cpu(), hc.keys), "keys differ from the CPU's")
    expect(torch.equal(ht.vals.cpu(), hc.vals), "values differ")
    expect(torch.equal(found.cpu(), fc) and torch.equal(got.cpu(), gc),
           "lookups differ")
    nfound = int(found.sum())
    print(f"main path: RoomyHashTable {n} width-{HT_WIDTH} keys (insert, "
          f"sync(add), remove {n // 8}, insert {n // 2}, sync, lookup {n}): "
          f"{wall:.3f} s on the card, {cpu_wall:.3f} s on the CPU; count "
          f"{int(ht.count)}, {nfound} found, keys/values/lookups == CPU's")
    return {"wall_s": wall, "cpu_wall_s": cpu_wall, "count": int(ht.count),
            "found": nfound}


def phase_sharded(dev) -> dict:
    """The sharded path on one card, over a one-rank NCCL group made from a
    FileStore: ``bucket_sync_update`` with a K5 owner apply (each op's local
    row rides as int32 bits in one extra float32 column, read back with
    ``Tensor.view``) == the unsharded ``array.sync``; with a capacity of
    half the ops, ``dropped`` is exactly the other half; and
    ``sharded_mark_sync`` with K2 == ``mark_packed``."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    root = tempfile.mkdtemp(prefix="roomy_store_")
    tdist.init_process_group("nccl", store=tdist.FileStore(
        os.path.join(root, "store"), 1), rank=0, world_size=1)
    try:
        rng = np.random.default_rng(SEED + 3)
        n, d, m = SHARD_SHAPE
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        table = torch.randn(n, d, generator=gen, device=dev)
        pay = torch.randn(m, d, generator=gen, device=dev)
        local = torch.from_numpy(zipf_tokens(rng, n, m)).to(dev)
        wire = torch.cat([pay, local.view(torch.float32)[:, None]], 1)
        dest = torch.zeros(m, dtype=torch.int32, device=dev)
        valid = torch.ones(m, dtype=torch.bool, device=dev)

        def owner_apply(state, flat, fvalid):
            idx = flat[:, d].contiguous().view(torch.int32)
            idx = torch.where(fvalid, idx, state.shape[0])
            idx, order = torch.sort(idx, stable=True)
            return OPS.bucket_scatter_add(state, idx, flat[order, :d])

        reset_all_launches()
        got, dropped = DL.bucket_sync_update(dest, wire, valid, None, 1, m,
                                            owner_apply, table)
        sync(dev)
        expect(BS.LAUNCHES["bucket_scatter_add"] == 1, dict(BS.LAUNCHES))
        expect(int(dropped) == 0, int(dropped))
        ra, _ = RA.update(RA.make(table, m, payload_shape=(d,),
                                  payload_dtype=torch.float32), local, pay)
        want = RA.sync(ra, RA.add, RA.add).data
        sync(dev)
        err = row_rel(got, want)
        expect(err <= K5_ROW_REL_TOL,
               f"sharded update {err} off the unsharded sync per row")
        half, dropped_half = DL.bucket_sync_update(
            dest, wire, valid, None, 1, m // 2, owner_apply, table)
        expect(int(dropped_half) == m - m // 2, int(dropped_half))
        ra, _ = RA.update(RA.make(table, m // 2, payload_shape=(d,),
                                  payload_dtype=torch.float32),
                          local[: m // 2], pay[: m // 2])
        expect(row_rel(half, RA.sync(ra, RA.add, RA.add).data)
               <= K5_ROW_REL_TOL, "the kept half differs from its sync")
        words = random_words(rng, SHARD_WORDS, dev)
        idx = torch.from_numpy(rng.integers(-100, 16 * SHARD_WORDS + 100, m)
                               .astype(np.int32)).to(dev)
        mvalid = torch.from_numpy(rng.random(m) < 0.9).to(dev)
        reset_all_launches()
        marked, mdropped = BA.sharded_mark_sync(words, idx, mvalid, None, 1,
                                                m)
        sync(dev)
        expect(K.LAUNCHES["scatter_mark"] == 1, dict(K.LAUNCHES))
        expect(int(mdropped) == 0, int(mdropped))
        expect(torch.equal(marked, BA.mark_packed(words, idx, mvalid)),
               "sharded mark != mark_packed")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    print(f"sharded: one-rank NCCL group; bucket_sync_update with a K5 "
          f"owner apply ({n}x{d}, {m} Zipf ops) == array.sync per row "
          f"within {err:.3e} (limit {K5_ROW_REL_TOL}), capacity {m // 2} "
          f"dropped "
          f"{int(dropped_half)}; sharded_mark_sync (K2) == mark_packed "
          f"bit for bit")
    return {"max_row_rel_err": err, "dropped_at_half": int(dropped_half)}


def phase_roomy(dev) -> dict:
    """K5 parity, then the Roomy structures on the card: the embedding
    gradient sync (K5's main path) and K5's times, the 2^27 prefix, the
    hash table, the sharded path."""
    parity = phase_k5_parity_edges(dev)
    emb = phase_embedding_sync(dev)
    torch.cuda.empty_cache()
    prefix = phase_prefix(dev)
    torch.cuda.empty_cache()
    ht = phase_hashtable(dev)
    torch.cuda.empty_cache()
    sharded = phase_sharded(dev)
    torch.cuda.empty_cache()
    out = {"k5_parity": parity, "embedding": emb, "prefix": prefix,
           "hashtable": ht, "sharded": sharded}
    print(json.dumps({"roomy": out}))
    return out


# ------------------------------------------------- LM serving (gemma2-2b)

ARCH = "gemma2-2b"
PREFILL_LEN = 32768      # prefill_32k (repro/configs/shapes.py:24); batch 32 cut to 1
DECODE_STEPS = 16
EQUIV_PREFIX = 64
PLAIN_REPS = 3           # the plain attention at 32k takes about a second a call
SEED = 0
K6_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
K6_REPLACES = "src/repro/kernels/flash_attention.py:114"
# bfloat16 logits of two paths that round at different places (K6 rounds
# P to bfloat16 before P·V where the plain version keeps it in float32;
# prefill and decode run different matmul shapes) drift apart over 26
# layers, and an elementwise relative bound means nothing for a logit near
# 0.  So each row of bfloat16 logits is held to ‖a − b‖ ≤ BF16_LOGIT_REL_TOL
# · ‖b‖ over the real vocab.  The limit lies between the readings of sound
# runs on an H100 (K6 vs plain prefill 1.78e-2, prefill vs stepwise decode
# 2.04e-2) and those of planted attention faults (every local window a
# tile short 6.92e-2, a global layer given the local window 0.862), which
# phase_prefill_plain re-reads every run and requires to exceed it.
# float32 is held elementwise to 2e-3 (abs + rel), as
# tests/test_models.py:199-200 holds the reference.
BF16_LOGIT_REL_TOL = 3.5e-2
F32_TOL = 2e-3


def sync(dev) -> None:
    torch.cuda.synchronize(dev)


def reset_all_launches() -> None:
    K.reset_launches()
    BS.reset_launches()
    FA.reset_launches()
    MS.reset_launches()
    PD.reset_launches()


def attention_layers(cfg) -> int:
    """K6 launches a prefill: one per attention layer (none in the ssm
    family; one per application of the hybrid's shared block)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return lm.n_shared_applications(cfg)
    return cfg.n_layers


def unwindowed_layers(cfg) -> int:
    """The attention layers that read their cache with K8 in decode (every
    layer without a window; none in the ssm family; each application of
    the hybrid's shared block)."""
    if cfg.family in ("ssm", "hybrid"):
        return attention_layers(cfg)
    return sum(w is None for w in lm.layer_windows(cfg))


def logit_errors(got, want, what, rel_tol=BF16_LOGIT_REL_TOL) -> dict:
    """Print and return how far two logit tensors (..., V) lie apart, and
    whether they agree by the rule above (bfloat16 rows within
    ``rel_tol``)."""
    a, w = got.float(), want.float()
    diff = (a - w).abs()
    rel = float(((a - w).norm(dim=-1) / w.norm(dim=-1)).max())
    if got.dtype == torch.float32:
        ok = bool((diff <= F32_TOL + F32_TOL * w.abs()).all())
        rule = f"{F32_TOL} abs + rel"
    else:
        ok, rule = rel <= rel_tol, f"rel {rel_tol}"
    res = {"max_abs_err": float(diff.max()), "mean_abs_err": float(
        diff.mean()), "rel_err": rel, "max_abs_logit": float(w.abs().max()),
        "same_argmax": bool((a.argmax(-1) == w.argmax(-1)).all()), "ok": ok}
    print(f"{what}: per-row rel err {rel:.4e}, max abs err "
          f"{res['max_abs_err']:.4e}, mean abs err {res['mean_abs_err']:.4e},"
          f" max |logits| {res['max_abs_logit']:.4f} (tol {rule}: "
          f"{'agree' if ok else 'differ'}), same argmax {res['same_argmax']}")
    return res


def logits_agree(got, want, what, rel_tol=BF16_LOGIT_REL_TOL) -> dict:
    res = logit_errors(got, want, what, rel_tol)
    expect(res["ok"], f"{what}: {res}")
    return res


_SERVED_BOOK = {}


@contextlib.contextmanager
def served_codebook(cfg, dev):
    """The stub frontend's codebook (``data.pipeline.codebook``: the
    reference's bits) on the card while ``cfg`` is served, so a decode
    step gathers its input row there; freed on exit, so training's peak
    does not count it (qwen2-vl's is 933 MB)."""
    _SERVED_BOOK[cfg.name] = torch.from_numpy(
        codebook(cfg.vocab_size, cfg.d_model).copy()).to(dev)
    try:
        yield
    finally:
        _SERVED_BOOK.pop(cfg.name)


def text_positions(cfg, b, s, dev):
    """Positions 0..s-1, (b, s); under M-RoPE (b, s, 3) with every stream
    equal, as ``data.pipeline`` makes them for text."""
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    return pos[..., None].expand(b, s, 3) if cfg.mrope else pos


def lm_inputs(cfg, b, s, dev, seed):
    """Random token ids from a numpy seed as the model's inputs: the ids,
    or for a frontend stub their codebook rows (float32, as
    ``make_batch`` gives them), with text positions."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    return {**token_inputs(cfg, toks), "positions": text_positions(
        cfg, b, s, dev)}


def token_inputs(cfg, toks) -> dict:
    """{"tokens": toks}, or for a frontend stub {"embeds": the codebook
    rows of toks}: a decode step's input is the last token's row."""
    if cfg.frontend_stub:
        return {"embeds": _SERVED_BOOK[cfg.name][toks]}
    return {"tokens": toks}


def step_inputs(cfg, tok) -> dict:
    """A decode step's inputs for the (b, 1) token ids ``tok`` (the step
    rotates with the caches' lengths, not with these positions)."""
    return {**token_inputs(cfg, tok), "positions": torch.zeros_like(tok)}


class Capture:
    """Wraps ``ops.<name>`` (the op the model calls: ``flash_attention`` or
    ``mamba_scan``) for one run: keeps copies of the tensor arguments
    (strides and all) and the keyword arguments of the calls (layers) in
    ``keep``, and times every call with CUDA events.  ``fault(i, orig,
    args, kw)``, if given, computes call i instead: a planted fault.  The
    launch count stays in the kernel's own wrapper."""

    def __init__(self, name, keep=(), fault=None):
        self.name, self.keep, self.fault = name, keep, fault
        self.calls, self.events = {}, []

    def __enter__(self):
        self.orig = getattr(OPS, self.name)

        def wrapped(*args, **kw):
            i = len(self.events)
            if i in self.keep:
                self.calls[i] = (tuple(t.clone() for t in args), kw)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = (self.orig(*args, **kw) if self.fault is None
                   else self.fault(i, self.orig, args, kw))
            b.record()
            self.events.append((a, b))
            return out
        setattr(OPS, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(OPS, self.name, self.orig)
        return False

    def kernel_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


def phase_prefill(cfg, params, dev, seq=PREFILL_LEN):
    """The main path's prefill: 1 × ``seq`` tokens through ``lm.prefill``
    with every launch count set to 0 just before it, and nothing wrapped
    around it, so wall and peak memory are the prefill's own."""
    lm.prefill(params, lm_inputs(cfg, 1, 256, dev, SEED + 1), cfg)  # warm-up
    inputs = lm_inputs(cfg, 1, seq, dev, SEED)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    t0 = time.perf_counter()
    logits, caches = lm.prefill(params, inputs, cfg,
                                max_len=seq + DECODE_STEPS)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(FA.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    routes = dict(FA.ROUTE_LAUNCHES)
    n_attn = attention_layers(cfg)
    expect(launches == {"flash_attention": n_attn,
                        "flash_attention_lse": 0, "flash_attention_bwd": 0},
           launches)
    expect(routes == {"wgmma": n_attn, "classic": 0},
           f"K6 routes of the prefill: {routes}")
    expect(not any(K.LAUNCHES.values()) and not any(PD.LAUNCHES.values())
           and not any(MS.LAUNCHES.values()),
           (dict(K.LAUNCHES), dict(PD.LAUNCHES), dict(MS.LAUNCHES)))
    expect(logits.shape == (1, 1, cfg.vocab_padded), logits.shape)
    expect(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    expect(len(caches["kv"]) == n_attn and all(
        int(c.lengths[0]) == seq for c in caches["kv"]), "cache lengths")
    if cfg.family == "hybrid":
        di, n = cfg.d_inner, cfg.ssm_state
        expect(len(caches["ssm"]) == cfg.n_layers and all(
            st.conv.shape == (1, cfg.ssm_conv - 1, di + 2 * n) and
            st.h.shape == (1, di, n) and bool(torch.isfinite(st.h).all())
            for st in caches["ssm"]), "prefill states")
    res = {"tokens": seq, "wall_s": wall, "tokens_per_s": seq / wall,
           "peak_bytes": peak, "launches": launches, "k6_routes": routes}
    print(f"prefill: {cfg.name} bf16 1 x {seq} tokens, {wall:.3f} s wall, "
          f"{seq / wall:.0f} tokens/s, peak {peak} bytes, K6 launches "
          f"{launches['flash_attention']} (routes {routes}), K8 launches 0")
    return inputs, logits, caches, res


def phase_capture(cfg, params, inputs, wall, dev, keep=(0, 1)):
    """A second prefill of the main path's inputs through ``Capture``: the
    q, k, v of the layers in ``keep`` (gemma2-2b: layer 0, local, and layer
    1, global), and K6's time by CUDA events as a share of the main path's
    wall."""
    FA.reset_launches()
    n_attn = attention_layers(cfg)
    with Capture("flash_attention", keep=keep) as cap:
        lm.prefill(params, inputs, cfg)
        sync(dev)
    expect(FA.LAUNCHES["flash_attention"] == n_attn, dict(FA.LAUNCHES))
    expect(dict(FA.ROUTE_LAUNCHES) == {"wgmma": n_attn, "classic": 0},
           dict(FA.ROUTE_LAUNCHES))
    k6_ms = cap.kernel_ms()
    res = {"k6_ms": k6_ms, "k6_share": k6_ms / 1e3 / wall}
    print(f"prefill K6 time: {cfg.name}, {n_attn} launches on the "
          f"wgmma route taking {k6_ms:.1f} ms by CUDA events "
          f"({100 * res['k6_share']:.1f}% of the main path's wall)")
    return [(*cap.calls[i][0], cap.calls[i][1]) for i in keep], res


def phase_k6_parity_real(calls) -> dict:
    """K6 on the captured layers by both checks, then planted faults that
    the per-(b, h) check must reject: K6 with the local layer's window one
    kv tile short, and K6's global-layer output with rows past one window
    zeroed."""
    for (q, k, v, kw), name in zip(calls, ("layer 0 (local)",
                                           "layer 1 (global)")):
        e = check_k6(q, k, v, kw["causal"], kw["window"], kw["softcap"],
                     f"prefill {name}")
        print(f"parity K6 prefill {name} q {tuple(q.shape)} k "
              f"{tuple(k.shape)} window {kw['window']} softcap "
              f"{kw['softcap']}: {k6_summary([e])} (tol elementwise 2e-2, "
              f"rel {K6_REL_TOL})")
    (ql, kl, vl, kwl), (qg, kg, vg, kwg) = calls
    w = kwl["window"]
    want = R.attention_ref(ql, kl, vl, window=w, softcap=kwl["softcap"])
    short = FA.flash_attention(ql, kl, vl, window=w - K6_TILE,
                               softcap=kwl["softcap"])
    faults = {f"local window {w} - {K6_TILE}": k6_errors(short, want)}
    want = R.attention_ref(qg, kg, vg, softcap=kwg["softcap"])
    zeroed = FA.flash_attention(qg, kg, vg, softcap=kwg["softcap"])
    zeroed[:, :, w:] = 0
    faults[f"global rows past {w} zeroed"] = k6_errors(zeroed, want)
    del want, short, zeroed
    for name, e in faults.items():
        print(f"planted K6 fault, {name}: {k6_summary([e])}; elementwise "
              f"check {'passes' if e['elementwise_ok'] else 'fails'}, "
              f"per-(b, h) check {'passes' if e['rel_ok'] else 'fails'}")
        expect(not e["rel_ok"], f"the per-(b, h) check misses {name}")
    return faults


_FLEX = []


def flex_attention(q, k, v, *, causal=True, window=None, softcap=None,
                   scale=None, lse=False):
    """One library call that computes K6's function on (q, k, v): PyTorch's
    ``flex_attention``, compiled as its documentation has it used, with the
    softcap as the score_mod, causal and window as the block mask (built
    here, outside any timing) and ``enable_gqa``.  Returns a closure of
    (q, k, v) giving the output, or (output, natural-log LSE) with
    ``lse``.  torch.compile (and with it triton) is brought in on first
    use."""
    from torch.nn.attention import flex_attention as FX
    expect(causal, "the library call is built for causal attention")
    if not _FLEX:
        _FLEX.append(torch.compile(FX.flex_attention, dynamic=False))

    def visible(b, h, qi, ki):
        m = ki <= qi
        return m if window is None else m & (qi - ki <= window)

    def cap(s, b, h, qi, ki):
        return softcap * torch.tanh(s / softcap)
    mask = FX.create_block_mask(visible, None, None, q.shape[2], k.shape[2],
                                device=q.device)
    extra = ({} if not lse else {"return_aux": FX.AuxRequest(lse=True)}
             if hasattr(FX, "AuxRequest") else {"return_lse": True})

    def call(q, k, v):
        out = _FLEX[0](q, k, v, score_mod=None if softcap is None else cap,
                       block_mask=mask, scale=scale, enable_gqa=True,
                       **extra)
        if not lse:
            return out
        return (out[0], out[1].lse) if "return_aux" in extra else out
    return call


def bh_rel(got, want) -> float:
    """Worst per-(batch, head) ‖got − want‖ / ‖want‖."""
    g, w = got.float().flatten(2), want.float().flatten(2)
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def phase_k6_times(calls):
    """K6 at the prefill's local and global shapes, beside its bound and
    its plain version; at the global shape the library call
    (``flex_attention``, softcap 50: ``library_ms``), held to K6's
    per-(b, h) limit against K6, and SDPA with the softcap off beside K6
    with the softcap off."""
    out = {}
    for (q, k, v, kw), name in zip(calls, ("local", "global")):
        w, sc = kw["window"], kw["softcap"]
        ms = median_ms(lambda: FA.flash_attention(q, k, v, window=w,
                                                  softcap=sc))
        plain = median_ms(lambda: R.attention_ref(q, k, v, window=w,
                                                  softcap=sc),
                          reps=PLAIN_REPS)
        bound, by, flops, nbytes = k6_bound(q, k, True, w)
        out[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": by, "flops": flops, "bytes": nbytes}
        print(f"time: K6 ({FA.route(q, k, v, q)} route) {name} "
              f"{tuple(q.shape)} window {w} softcap {sc}: "
              f"{ms:.3f} ms, bound {bound:.3f} ms ({by}: {flops:.3e} flops "
              f"at 989 TFLOP/s, {nbytes} bytes at 3.35 TB/s), "
              f"{flops / ms / 1e9:.1f} TFLOP/s, plain {plain:.3f} ms "
              f"(median of {PLAIN_REPS})")
    q, k, v, kw = calls[1]
    kw = {n: kw[n] for n in ("causal", "window", "softcap", "scale")
          if n in kw}
    lib = flex_attention(q, k, v, **kw)
    agree = bh_rel(lib(q, k, v), FA.flash_attention(q, k, v, **kw))
    expect(agree <= K6_REL_TOL, f"flex_attention vs K6: {agree}")
    lib_ms = median_ms(lambda: lib(q, k, v))
    out["global"].update(library_ms=lib_ms, library_rel_vs_kernel=agree)
    print(f"time: K6 global, library flex_attention (compiled, softcap "
          f"score_mod, causal block mask, GQA) {lib_ms:.3f} ms; per-(b, h) "
          f"rel to K6 {agree:.3e}")
    expect(out["global"]["ms"] < lib_ms, f"K6 at the global layer "
           f"({out['global']['ms']:.3f} ms) is not faster than "
           f"flex_attention ({lib_ms:.3f} ms)")
    off = median_ms(lambda: FA.flash_attention(q, k, v))
    sdpa = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    out["global"].update(ms_softcap_off=off, library_ms_softcap_off=sdpa)
    print(f"time: K6 global, softcap off: {off:.3f} ms; library "
          f"scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
          f"{sdpa:.3f} ms")
    return out


def logit_faults(cfg) -> dict:
    """Planted attention faults: each maps (layer, kwargs) to the kwargs
    that layer's K6 call runs with."""
    tile, win = K6_TILE, cfg.local_window
    return {
        f"every local layer's window one {tile}-key tile short":
            lambda i, kw: ({**kw, "window": kw["window"] - tile}
                           if kw["window"] is not None else kw),
        f"layer 1 (global) given the local window {win}":
            lambda i, kw: {**kw, "window": win} if i == 1 else kw,
    }


def phase_prefill_plain(cfg, params, inputs, logits, dev):
    """The same prefill with the plain attention: the logits agree.  Then
    K6 prefills with planted attention faults, whose logits must differ
    from the plain prefill's by more than the limit."""
    FA.reset_launches()
    t0 = time.perf_counter()
    ref_logits, _ = lm.prefill(params, inputs, cfg.replace(kernels="ref"))
    sync(dev)
    wall = time.perf_counter() - t0
    expect(FA.LAUNCHES["flash_attention"] == 0, dict(FA.LAUNCHES))
    print(f"prefill plain attention: {wall:.3f} s wall")
    v = cfg.vocab_size                         # pad rows are -1e30 in both
    ref_logits = ref_logits[..., :v]
    errs = logit_errors(logits[..., :v], ref_logits,
                        "prefill K6 vs plain attention, last-position logits")
    controls = {}
    for name, fault in logit_faults(cfg).items():
        with Capture("flash_attention", fault=lambda i, orig, a, kw, f=fault:
                     orig(*a, **f(i, dict(kw)))):
            bad, _ = lm.prefill(params, inputs, cfg)
        controls[name] = logit_errors(bad[..., :v], ref_logits,
                                      f"planted fault, {name}, vs plain")
        del bad
    expect(errs["ok"], f"prefill logits: {errs}")
    for name, e in controls.items():
        expect(not e["ok"], f"the logits check misses {name}: {e}")
    return {"plain_wall_s": wall, "logits_vs_plain": errs,
            "planted_faults": controls}


def phase_decode(cfg, params, logits, caches, dev, steps=DECODE_STEPS):
    """``steps`` greedy decode steps from the prefill's caches, with every
    launch count set to 0 just before and read after each step: K8 once
    for every layer without a window (gemma2's 13 global layers, every
    dense layer of the other archs), no other kernel (the ssm family's
    decode step is plain PyTorch, as the reference's).  A frontend stub's
    step takes the codebook row of the last token."""
    tok = logits[:, -1].argmax(-1, keepdim=True)
    seq = int(caches["kv"][0].lengths[0]) if "kv" in caches else None
    per_step = unwindowed_layers(cfg)
    reset_all_launches()
    sync(dev)
    h0 = host_counters()
    k8_steps = []
    for _ in range(steps):
        lg, caches = lm.decode_step(params, step_inputs(cfg, tok), caches,
                                    cfg)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        k8_steps.append(PD.LAUNCHES["paged_decode_attention"])
    sync(dev)
    host = host_delta(h0, host_counters())
    wall = host["wall_s"]
    k9, k8 = MS.LAUNCHES["mamba_scan"], PD.LAUNCHES["paged_decode_attention"]
    expect(k9 == 0, dict(MS.LAUNCHES))
    expect(k8_steps == [per_step * (i + 1) for i in range(steps)],
           f"K8 launches after each step {k8_steps}, want {per_step} a step")
    # every decode config here is bf16 at head dim 64, 128 or 256 with
    # lm.PAGE_SIZE pages: all of K8's launches take the TMA route
    expect(dict(PD.ROUTE_LAUNCHES) == {"tma": k8, "classic": 0},
           dict(PD.ROUTE_LAUNCHES))
    expect(not any(FA.LAUNCHES.values()) and not any(K.LAUNCHES.values()),
           (dict(FA.LAUNCHES), dict(K.LAUNCHES)))
    expect(bool(torch.isfinite(lg).all()), "decode logits not finite")
    if seq is not None:
        expect(all(int(c.lengths[0]) == seq + steps for c in caches["kv"]),
               "decode cache lengths")
    print(f"decode: {cfg.name} {steps} steps after the prefill, {wall:.3f} "
          f"s, {steps / wall:.2f} tokens/s (batch 1), K8 launches {k8} "
          f"({per_step} a step; by route {dict(PD.ROUTE_LAUNCHES)}), K9 "
          f"launches {k9}; {host_line(host)}")
    return {"steps": steps, "wall_s": wall, "tokens_per_s": steps / wall,
            "k8_launches": k8, "k8_launches_per_step": per_step,
            "k8_routes": dict(PD.ROUTE_LAUNCHES), "k9_launches": k9,
            "host": host}


def prefill_vs_stepwise(cfg, params, dev, s=EQUIV_PREFIX, b=2,
                        rel_tol=BF16_LOGIT_REL_TOL) -> dict:
    """prefill(s tokens) then one decode step == s + 1 decode steps from
    an empty cache (tests/test_models.py:171-200); returns the errors."""
    inputs = lm_inputs(cfg, b, s + 1, dev, SEED + 2)
    toks, pos = inputs["tokens"], inputs["positions"]
    _, caches = lm.prefill(params, {"tokens": toks[:, :s],
                                    "positions": pos[:, :s]}, cfg,
                           max_len=s + 1)
    lg_a, _ = lm.decode_step(params, {"tokens": toks[:, s:],
                                      "positions": pos[:, :1]}, caches, cfg)
    caches = lm.make_cache(cfg, b, s + 1, device=dev)
    for t in range(s + 1):
        lg_b, caches = lm.decode_step(params, {"tokens": toks[:, t:t + 1],
                                               "positions": pos[:, :1]},
                                      caches, cfg)
    sync(dev)
    v = cfg.vocab_size
    return logits_agree(lg_a[..., :v], lg_b[..., :v],
                        f"equivalence: {cfg.name} {cfg.dtype} prefill({s}) "
                        f"+ decode == {s + 1} decode steps", rel_tol)


def phase_serve(argv=("--arch", ARCH)):
    """``python -m repro_torch.launch.serve --arch <arch>`` with its
    defaults: 4 requests of 8 tokens, 12 new tokens each.  Every decode
    step (32 prompt tokens fed one a step, then 11 waves) launches K8 once
    for every layer without a window."""
    reset_all_launches()
    outs, server, wall = serve.main(list(argv))
    toks = sum(len(v) for v in outs.values())
    expect(sorted(outs) == [0, 1, 2, 3], sorted(outs))
    expect(all(len(v) == 12 and all(0 <= t < server.cfg.vocab_size
                                    for t in v) for v in outs.values()),
           outs)
    expect(server.stats == {"prefills": 4, "decode_steps": 11,
                            "tokens_out": 44}, server.stats)
    k8 = PD.LAUNCHES["paged_decode_attention"]
    expect(k8 == (4 * 8 + 11) * unwindowed_layers(server.cfg),
           f"Server K8 launches {k8}")
    print(f"serve: {server.cfg.name} {toks} tokens in {wall:.3f} s, "
          f"{toks / wall:.2f} tokens/s, stats {server.stats}, K8 launches "
          f"{k8}")
    return {"tokens": toks, "wall_s": wall, "tokens_per_s": toks / wall,
            "stats": server.stats, "k8_launches": k8}


def kernel_group(name: str) -> str:
    low = name.lower()
    if any(w in low for w in ("fa_hopper_kernel", "fa_bf16_kernel",
                              "fa_f32_kernel")):
        return "flash_attention (K6)"
    if "scan_seg_kernel<" in low:
        return "mamba_scan (K9)"
    if "scan_bwd_kernel<" in low or "scan_bwd_reduce_kernel" in low:
        return "mamba_scan_bwd (K9-bwd)"
    if any(w in low for w in ("pd_hopper_kernel<", "merge_tma_kernel<",
                              "partial_kernel<", "merge_kernel<")):
        return "paged_decode_attention (K8)"
    if any(w in low for w in ("dkdv_hopper_kernel", "dq_hopper_kernel",
                              "bwd_rows_kernel",
                              "dkdv_bf16_kernel", "dq_bf16_kernel",
                              "dkdv_f32_kernel", "dq_f32_kernel",
                              "dvec_kernel")):
        return "flash_attention_bwd (K7)"
    if any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copy/memset"
    return "elementwise and other"


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def host_counters() -> dict:
    """The host's clocks now: the wall, and the CPU seconds of this thread
    and of the whole process (autograd's backward runs on a thread of its
    own)."""
    th = resource.getrusage(resource.RUSAGE_THREAD)
    pr = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "thread_cpu": th.ru_utime + th.ru_stime,
            "process_cpu": pr.ru_utime + pr.ru_stime}


def host_delta(a, b) -> dict:
    """What the host did between two ``host_counters`` readings: the wall,
    the CPU seconds of the calling thread and of the process, each with
    its share of the wall (a share near 1: the host worked the whole
    time, so the wall is the host's)."""
    wall = b["t"] - a["t"]
    th = b["thread_cpu"] - a["thread_cpu"]
    pr = b["process_cpu"] - a["process_cpu"]
    return {"wall_s": wall, "thread_cpu_s": th, "thread_busy_share": th / wall,
            "process_cpu_s": pr, "process_busy_share": pr / wall}


def host_line(h) -> str:
    return (f"host CPU: this thread {h['thread_cpu_s']:.3f} s "
            f"({100 * h['thread_busy_share']:.1f}% of the "
            f"{h['wall_s']:.3f} s wall), the process {h['process_cpu_s']:.3f}"
            f" s ({100 * h['process_busy_share']:.1f}%)")


def device_profile(fn, dev, what, tail=None) -> dict:
    """One run of ``fn`` under ``torch.profiler``: device time by kernel
    group, and the share of the wall with no kernel running (kernels run
    one at a time on the one stream, so their durations add up).  With
    ``tail`` = (marker kernel, group), every kernel that starts after the
    marker goes to that group, and the marker to none."""
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = host_counters()
        fn()
        sync(dev)
        host = host_delta(h0, host_counters())
    wall = host["wall_s"]
    calls = [ev for ev in prof.events() if ev.name in LAUNCH_CALLS]
    host["launch_calls"] = len(calls)
    host["launch_call_ms"] = sum(ev.time_range.elapsed_us()
                                 for ev in calls) / 1e3
    groups, kernels, after = {}, {}, False
    for ev in sorted((ev for ev in prof.events() if ev.device_type ==
                      torch.autograd.DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start):
        if tail and tail[0] in ev.name:
            after = True
            continue
        us = ev.time_range.elapsed_us()
        g = tail[1] if after else kernel_group(ev.name)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        kernels[ev.name] = kernels.get(ev.name, 0.0) + us / 1e3
    busy_ms = sum(groups.values())
    res = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": (1 - busy_ms / (wall * 1e3)) if busy_ms else None,
           "groups_ms": groups, "tail_marker_seen": after, "host": host,
           "top_kernels_ms": dict(sorted(kernels.items(),
                                         key=lambda kv: -kv[1])[:6])}
    if not busy_ms:
        print(f"profile {what}: the profiler saw no device time; idle "
              f"share not measured")
        return res
    print(f"profile {what}: wall {wall * 1e3:.1f} ms (profiled), kernels "
          f"{busy_ms:.1f} ms, device idle {100 * res['idle_share']:.1f}%; "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
          + f"; {host['launch_calls']} kernel launch calls on the host, "
          f"{host['launch_call_ms']:.1f} ms in them; {host_line(host)}")
    return res


def phase_profile(cfg, params, inputs, caches, dev, steps=4,
                  prefill=True) -> dict:
    """Where the time goes: one prefill of the main path's inputs (unless
    ``prefill`` is False) and ``steps`` decode steps from its caches,
    under the profiler."""
    tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)

    def decode():
        c = caches
        for _ in range(steps):
            _, c = lm.decode_step(params, step_inputs(cfg, tok), c, cfg)
    out = {}
    if prefill:
        out["prefill"] = device_profile(
            lambda: lm.prefill(params, inputs, cfg), dev,
            f"prefill 1 x {inputs['positions'].shape[1]}")
    out[f"decode_{steps}_steps"] = device_profile(
        decode, dev, f"{cfg.name} {steps} decode steps")
    return out


def phase_lm(dev):
    """gemma2-2b FULL in bfloat16, params from the port's init_params on a
    seeded generator: prefill (the main path), K6 on its real inputs and
    at its shapes, the plain prefill, decode, equivalence, the Server."""
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
    sync(dev)
    print(f"init: {cfg.name}, {cfg.param_count()} params in bfloat16, "
          f"{time.perf_counter() - t0:.3f} s")
    inputs, logits, caches, prefill = phase_prefill(cfg, params, dev)
    calls, k6_share = phase_capture(cfg, params, inputs, prefill["wall_s"],
                                    dev)
    prefill.update(k6_share)
    prefill["k6_planted_faults"] = phase_k6_parity_real(calls)
    k6_times = phase_k6_times(calls)
    del calls
    prefill.update(phase_prefill_plain(cfg, params, inputs, logits, dev))
    k8_calls, _ = k8_capture(cfg, params, caches, dev, keep=(0, 12))
    k8_captured = k8_on_captured(cfg, k8_calls, f"{cfg.name} decode "
                                 f"(global layers 1 and 25)")
    k8_times = phase_k8_times(*k8_calls[0], f"{cfg.name} decode global "
                              f"layer 1, batch 1", library=False)
    del k8_calls
    decode = phase_decode(cfg, params, logits, caches, dev)
    decode["k8_captured"] = k8_captured
    decode["k8_times"] = k8_times
    profile = phase_profile(cfg, params, inputs, caches, dev)
    del caches
    torch.cuda.empty_cache()
    equiv = {"bfloat16": prefill_vs_stepwise(cfg, params, dev)}
    cfg32 = cfg.replace(dtype="float32")
    equiv["float32"] = prefill_vs_stepwise(
        cfg32, T.tree_map(lambda x: x.float(), params), dev)
    del params
    torch.cuda.empty_cache()
    served = phase_serve()
    print(json.dumps({"lm": {"arch": ARCH, "prefill": prefill,
                             "decode": decode, "serve": served,
                             "profile": profile,
                             "equivalence": equiv,
                             "k6_times": k6_times}}))
    return prefill["launches"]["flash_attention"], {
        **k6_times, "routes": prefill["k6_routes"], "k8_times": k8_times}


# ------------------------------------------- K7 and training (gemma2-2b)

K7_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
K7_REPLACES = "src/repro/kernels/flash_attention_bwd.py:149"
K6_LSE_REPLACES = "src/repro/kernels/flash_attention.py:100"
# f32 elementwise (abs + rel), the reference's own backward tolerance
# (tests/test_kernels.py:371-372); bf16 per (batch, head) of each of dq, dk
# and dv, ‖got − want‖ ≤ K7_REL_TOL ‖want‖, as K6 is held.  Planted faults
# must break K7_REL_TOL by K7_FAULT_FACTOR or more.
K7_F32_TOL = 3e-4
K7_REL_TOL = 1e-2
K7_FAULT_FACTOR = 2.0
K7_CASES = [  # b, hq, hkv, sq, skv, d, causal, window, softcap
    # tests/test_kernels.py:332-339
    (1, 2, 2, 64, 64, 32, True, None, None),
    (1, 4, 2, 64, 64, 32, True, None, None),
    (1, 2, 2, 96, 96, 16, True, 32, None),
    (1, 2, 2, 64, 64, 32, True, None, 30.0),
    (1, 2, 1, 48, 80, 32, False, None, None),
    # gemma2-2b: head_dim 256, softcap 50, window 4096 where it cuts (8192
    # rows), GQA 2 (the model's), 1 and 4; the train shape (4096 rows)
    (1, 8, 4, 8192, 8192, 256, True, 4096, 50.0),
    (1, 8, 8, 8192, 8192, 256, True, 4096, 50.0),
    (1, 8, 2, 8192, 8192, 256, True, 4096, 50.0),
    (1, 8, 4, 4096, 4096, 256, True, None, 50.0),
    # Sq != Skv, rows that see no key, one row over 300 keys (one row over
    # one key has dq = dk = 0 exactly: no relative bound applies), head_dims
    # 12 and 100
    (1, 8, 4, 100, 4100, 256, True, 4096, 50.0),
    (1, 2, 1, 100, 10, 64, True, 5, None),
    (1, 8, 4, 1, 300, 256, False, None, 50.0),
    (2, 4, 2, 70, 70, 12, True, 8, 50.0),
    (1, 3, 1, 130, 150, 100, False, 20, None),
    # the dense configs' layouts: nemotron-4-15b (head 128, group 6),
    # granite-34b (head 128, MQA: group 48), minicpm-2b (head 64, MHA)
    (1, 12, 2, 512, 512, 128, True, None, None),
    (1, 48, 1, 512, 512, 128, True, None, None),
    (1, 4, 4, 512, 512, 64, True, None, None),
]
K7_MODEL_CASE = K7_CASES[5]
# q and k drawn with this σ give logits of std σ² = 16, where the softcap
# of 50 bends them hard (with σ = 1 it is nearly the identity).  The
# softcap fault is planted at σ = 2 (logits of std 4): there the backward
# without the softcap stays finite, off by a factor of up to ~1.5 on the
# largest probabilities, where at σ = 4 it overflows.
K7_CAP_SIGMA = 4.0
K7_FAULT_SIGMA = 2.0
TRAIN_SEQ = 4096        # train_4k (repro/configs/shapes.py:22); batch 256 cut to 1
TRAIN_STEPS = 6
# K7 at the dense configs' layouts, 1 × 4096, causal, timed beside SDPA's
# backward: b, hq, hkv, sq, skv, d
K7_DENSE_TIMES = {"nemotron-4-15b": (1, 48, 8, 4096, 4096, 128),
                  "granite-34b": (1, 48, 1, 4096, 4096, 128),
                  "minicpm-2b": (1, 36, 36, 4096, 4096, 64)}


def k7_inputs(case, dtype, dev, seed, strided=False, qk_sigma=1.0):
    """q, k, v, dO of one K7 case from a numpy seed."""
    q, k, v = k6_inputs(case, dtype, dev, seed, strided)
    if qk_sigma != 1.0:
        q, k = q * qk_sigma, k * qk_sigma
    b, hq, _, sq, _, d = case[:6]
    rng = np.random.default_rng(seed + 1000)
    do = torch.from_numpy(rng.standard_normal((b, sq, hq, d), np.float32))
    do = do.to(dev, dtype).transpose(1, 2)
    return q, k, v, do if strided else do.contiguous()


def k7_errors(got, want) -> dict:
    """Per gradient: max abs err, worst per-(b, h) ‖Δ‖/‖want‖; and whether
    the dtype's check holds for all three."""
    out, ok = {}, True
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        rel = ((g - w).flatten(2).norm(dim=-1) / w.flatten(2).norm(dim=-1))
        rel = float(rel.nan_to_num(nan=0.0, posinf=math.inf).max()) \
            if g.numel() else 0.0
        out[name] = {"max_abs": float((g - w).abs().max()) if g.numel()
                     else 0.0, "rel": rel}
        ok = ok and bool(torch.isfinite(g).all())
        if got[0].dtype == torch.float32:
            ok = ok and bool(((g - w).abs() <= K7_F32_TOL
                              + K7_F32_TOL * w.abs()).all())
        else:
            ok = ok and rel <= K7_REL_TOL
    out["max_abs"] = max(out[n]["max_abs"] for n in ("dq", "dk", "dv"))
    out["rel"] = max(out[n]["rel"] for n in ("dq", "dk", "dv"))
    out["ok"] = ok
    return out


def k7_route(dtype, d) -> str:
    """The route a K7 case's fresh inputs must take, as ``k6_route``'s: the
    wgmma kernels for bfloat16 at head dims 64, 128 and 256, the classic
    kernels otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and d in FAB.DQ_TILES else \
        "classic"


def run_k7(q, k, v, do, kw, bwd_kw=None, drop_d=False):
    """K6 with LSE forward, then K7 and its plain version on the same
    (q, k, v, o, lse, dO); K7 must take the route ``k7_route`` names.  A
    planted fault, if asked for: K7 run with ``bwd_kw``, or (``drop_d``)
    given o = 0, which drops the term D = rowsum(dO ∘ O) (K7 reads o for
    D alone) and nothing else."""
    o, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    before = dict(FA.BWD_ROUTE_LAUNCHES)
    got = FAB.flash_attention_bwd(q, k, v, torch.zeros_like(o) if drop_d
                                  else o, lse, do, **(bwd_kw or kw))
    path = k7_route(q.dtype, q.shape[-1])
    routed = {n: FA.BWD_ROUTE_LAUNCHES[n] - before[n] for n in before}
    expect(routed == {**{n: 0 for n in before}, path: 1},
           f"K7 routes {routed}, want 1 launch on {path}: {tuple(q.shape)} "
           f"{q.dtype}")
    want = R.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, x in zip(got, (q, k, v)):
        expect(g.shape == x.shape and g.dtype == x.dtype, "K7 output")
    return k7_errors(got, want)


def phase_k7_parity(dev) -> dict:
    """K7 against its plain version on the card: every case in float32
    (elementwise 3e-4) and bfloat16 (per (b, h) 1e-2), contiguous and as
    strided views; the same twice gives the same bits (no atomics); then
    two planted faults that must break the bf16 limit by 2x or more."""
    for i, case in enumerate(K7_CASES):
        kw = dict(zip(("causal", "window", "softcap"), case[6:]))
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            for strided in (False, True):
                e = run_k7(*k7_inputs(case, dtype, dev, i, strided), kw)
                MAX_ERR["flash_attention_bwd"] = max(
                    MAX_ERR["flash_attention_bwd"], e["max_abs"])
                if dtype == torch.bfloat16:
                    MAX_REL["flash_attention_bwd"] = max(
                        MAX_REL["flash_attention_bwd"], e["rel"])
                errs[(dtype, strided)] = e
                expect(e["ok"], f"K7 disagrees with its plain version "
                       f"({case} {dtype} strided={strided}): {e}")
        f32 = max(e["max_abs"] for (dt, _), e in errs.items()
                  if dt == torch.float32)
        bf = [e for (dt, _), e in errs.items() if dt == torch.bfloat16]
        print(f"parity K7 {case}: f32 (classic) max abs err {f32:.3e} (tol "
              f"{K7_F32_TOL} abs + rel); bf16 "
              f"({k7_route(torch.bfloat16, case[5])}) per-(b, h) rel err dq "
              f"{max(e['dq']['rel'] for e in bf):.3e} dk "
              f"{max(e['dk']['rel'] for e in bf):.3e} dv "
              f"{max(e['dv']['rel'] for e in bf):.3e} (limit {K7_REL_TOL})")
    case = K7_MODEL_CASE
    kw = dict(zip(("causal", "window", "softcap"), case[6:]))
    q, k, v, do = k7_inputs(case, torch.bfloat16, dev, 99, True)
    o, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    runs = [FAB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            for _ in range(2)]
    expect(all(torch.equal(a, b) for a, b in zip(*runs)),
           "K7 differs between two runs on the same inputs")
    del runs, o, lse
    sound = {}
    for sigma in (K7_CAP_SIGMA, K7_FAULT_SIGMA):
        sound[sigma] = run_k7(*k7_inputs(case, torch.bfloat16, dev, 98, True,
                                         sigma), kw)
        expect(sound[sigma]["ok"], f"K7 at q, k of sigma {sigma}: "
               f"{sound[sigma]}")
    faults = {
        f"softcap off in the backward (q, k at sigma {K7_FAULT_SIGMA})":
            run_k7(*k7_inputs(case, torch.bfloat16, dev, 98, True,
                              K7_FAULT_SIGMA), kw, {**kw, "softcap": None}),
        "D = rowsum(dO o O) dropped": run_k7(q, k, v, do, kw, drop_d=True),
        f"window {kw['window']} - {K6_TILE} in the backward":
            run_k7(q, k, v, do, kw, {**kw, "window": kw["window"] - K6_TILE}),
    }
    for sigma, e in sound.items():
        print(f"parity K7 {case} bf16, q and k at sigma {sigma} (logits std "
              f"{sigma ** 2:g}): per-(b, h) rel err {e['rel']:.3e}")
    print("parity K7: two runs give the same bits")
    for name, e in faults.items():
        print(f"planted K7 fault, {name}: per-(b, h) rel err dq "
              f"{e['dq']['rel']:.3e} dk {e['dk']['rel']:.3e} dv "
              f"{e['dv']['rel']:.3e}, max abs err {e['max_abs']:.3e} (must "
              f"stay finite and exceed {K7_FAULT_FACTOR} x {K7_REL_TOL})")
        expect(math.isfinite(e["max_abs"]) and e["rel"] >= K7_FAULT_FACTOR
               * K7_REL_TOL, f"the K7 check misses {name}: {e}")
    return {"sound_by_sigma": {str(k): v for k, v in sound.items()},
            "planted_faults": faults}


def bwd_bound(q, k, causal, window):
    """(bound ms, bound_by, flops, bytes) of K7: 10·B·Hq·D flops per
    visible pair at the bf16 peak; q, k, v, o, dO and lse read once, dq,
    dk and dv written once."""
    b, hq, sq, d = q.shape
    flops = 10 * b * hq * d * visible_pairs(sq, k.shape[2], causal, window)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + \
        4 * b * hq * sq
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def library_k7(q, k, v, do, kw, o, lse, grads) -> dict:
    """The library call at one K7 shape: ``flex_attention``'s forward with
    its LSE (no grad) and its backward alone (the forward run untimed
    before each backward), each held against K6-with-LSE's (o, lse) and
    K7's ``grads`` by their per-(b, h) limits and LSE tolerance."""
    lib = flex_attention(q, k, v, lse=True, **kw)
    with torch.no_grad():
        lo, llse = lib(q, k, v)
        fwd_ms = median_ms(lambda: lib(q, k, v))
    fwd_rel, lse_abs = bh_rel(lo, o), float((llse - lse).abs().max())
    expect(fwd_rel <= K6_REL_TOL and lse_abs <= K6_LSE_TOL[q.dtype],
           f"flex_attention forward vs K6 with LSE: {fwd_rel}, {lse_abs}")
    lib = flex_attention(q, k, v, **kw)
    qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
    held = {}

    def forward():
        held["o"] = lib(*qkv)

    def backward():
        return torch.autograd.grad(held["o"], qkv, do)
    forward()
    bwd_rel = max(bh_rel(a, b) for a, b in zip(backward(), grads))
    expect(bwd_rel <= K7_REL_TOL, f"flex_attention backward vs K7: {bwd_rel}")
    forward()
    bwd_ms = median_ms(backward, setup=forward)
    del held["o"]
    return {"fwd_lse_ms": fwd_ms, "fwd_rel_vs_kernel": fwd_rel,
            "lse_abs_vs_kernel": lse_abs, "bwd_ms": bwd_ms,
            "bwd_rel_vs_kernel": bwd_rel}


def k7_rates(ms, flops) -> str:
    """Achieved TFLOP/s of K7 under the least work (10·D flops a visible
    pair, ``bwd_bound``'s count) and under what the two-kernel design does
    (14·D: S and dP in both kernels)."""
    return (f"{flops / ms / 1e9:.1f} TFLOP/s at 10·D, "
            f"{1.4 * flops / ms / 1e9:.1f} at 14·D")


def sdpa_bwd_ms(q, k, v, do) -> float:
    """The backward of scaled_dot_product_attention(is_causal=True,
    enable_gqa=True) alone, its forward run once before."""
    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                         enable_gqa=True)
    return median_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                                 retain_graph=True))


def phase_k7_times(dev) -> dict:
    """K7 and K6 with its LSE at the train shape (1 × 8 × 4096 × 256, GQA 2,
    softcap 50, causal: a local layer's window 4096 sees every earlier
    position at this length) and at 8192 rows with the window cutting:
    CUDA events, median of 20, beside the bound, the plain version (median
    of 3) and the library call (``flex_attention``, compiled: forward with
    LSE, and backward alone); K7 on the wgmma route, and at the train
    shape faster than the library's backward.  At the train shape with the
    softcap off, the backward of scaled_dot_product_attention(is_causal=
    True, enable_gqa=True) alone and its forward, beside K7 and
    K6-with-LSE with the softcap off; then K7 beside SDPA's backward at the
    dense configs' layouts (``K7_DENSE_TIMES``)."""
    out = {}
    for name, case in (("train", (1, 8, 4, TRAIN_SEQ, TRAIN_SEQ, 256, True,
                                  None, 50.0)),
                       ("window", K7_MODEL_CASE)):
        kw = dict(zip(("causal", "window", "softcap"), case[6:]))
        q, k, v, do = k7_inputs(case, torch.bfloat16, dev, 7, True)
        o, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
        ms = median_ms(lambda: FAB.flash_attention_bwd(q, k, v, o, lse, do,
                                                       **kw))
        plain = median_ms(lambda: R.flash_attention_bwd_ref(
            q, k, v, o, lse, do, **kw), reps=PLAIN_REPS)
        bound, by, flops, nbytes = bwd_bound(q, k, True, kw["window"])
        fms = median_ms(lambda: FA.flash_attention(q, k, v, return_lse=True,
                                                   **kw))
        fplain = median_ms(lambda: R.attention_lse_ref(q, k, v, **kw),
                           reps=PLAIN_REPS)
        fbound, fby, fflops, fbytes = k6_bound(q, k, True, kw["window"])
        fbytes += 4 * q.shape[0] * q.shape[1] * q.shape[2]     # lse written
        fbound = max(fflops / BF16_FLOPS, fbytes / HBM_BYTES_PER_S) * 1e3
        lib = library_k7(q, k, v, do, kw, o, lse,
                         FAB.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        path = FAB.route(q, k, v, o, do)
        expect(path == "wgmma", f"K7 at the {name} shape takes {path}")
        expect(name != "train" or fms < lib["fwd_lse_ms"],
               f"K6 with LSE at the {name} shape "
               f"({fms:.3f} ms) is not faster than flex_attention's forward "
               f"with its LSE ({lib['fwd_lse_ms']:.3f} ms)")
        expect(name != "train" or ms < lib["bwd_ms"],
               f"K7 at the {name} shape ({ms:.3f} ms) is not faster than "
               f"flex_attention's backward ({lib['bwd_ms']:.3f} ms)")
        out[name] = {
            "shape": f"{tuple(q.shape)} kv {tuple(k.shape)} window "
                     f"{kw['window']} softcap {kw['softcap']}",
            "bwd": {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                    "bound_by": by, "flops": flops, "bytes": nbytes,
                    "route": path, "tflops_10d": flops / ms / 1e9,
                    "tflops_14d": 1.4 * flops / ms / 1e9,
                    "library_ms": lib["bwd_ms"],
                    "library_rel_vs_kernel": lib["bwd_rel_vs_kernel"]},
            "fwd_lse": {"ms": fms, "plain_ms": fplain, "bound_ms": fbound,
                        "bound_by": fby, "flops": fflops, "bytes": fbytes,
                        "library_ms": lib["fwd_lse_ms"],
                        "library_rel_vs_kernel": lib["fwd_rel_vs_kernel"],
                        "library_lse_abs_vs_kernel": lib["lse_abs_vs_kernel"]}}
        print(f"time: K7 {out[name]['shape']} ({path} route): {ms:.3f} ms, "
              f"bound {bound:.3f} ms ({by}: {flops:.3e} flops at 989 "
              f"TFLOP/s, {nbytes} bytes at 3.35 TB/s), "
              f"{k7_rates(ms, flops)}, "
              f"plain {plain:.3f} ms (median of {PLAIN_REPS}), library "
              f"flex_attention backward {lib['bwd_ms']:.3f} ms (per-(b, h) "
              f"rel to K7 {lib['bwd_rel_vs_kernel']:.3e}); K6 with LSE "
              f"({FA.route(q, k, v, q)} route) "
              f"{fms:.3f} ms, bound {fbound:.3f} ms, plain {fplain:.3f} ms, "
              f"library flex_attention forward with LSE "
              f"{lib['fwd_lse_ms']:.3f} ms (per-(b, h) rel to K6 "
              f"{lib['fwd_rel_vs_kernel']:.3e}, LSE max abs "
              f"{lib['lse_abs_vs_kernel']:.3e})")
        del q, k, v, do, o, lse
    q, k, v, do = k7_inputs((1, 8, 4, TRAIN_SEQ, TRAIN_SEQ, 256), torch.bfloat16,
                            dev, 8, True)
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    k7_off = median_ms(lambda: FAB.flash_attention_bwd(q, k, v, o, lse, do))
    k6_off = median_ms(lambda: FA.flash_attention(q, k, v, return_lse=True))
    sdpa_bwd = sdpa_bwd_ms(q, k, v, do)
    with torch.no_grad():
        sdpa_fwd = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    out["train"]["bwd"].update(ms_softcap_off=k7_off,
                               library_ms_softcap_off=sdpa_bwd)
    out["train"]["fwd_lse"].update(ms_softcap_off=k6_off,
                                   library_ms_softcap_off=sdpa_fwd)
    flops = bwd_bound(q, k, True, None)[2]
    print(f"time: train shape, softcap off: K7 {k7_off:.3f} ms "
          f"({k7_rates(k7_off, flops)}), library "
          f"scaled_dot_product_attention backward {sdpa_bwd:.3f} ms; K6 with "
          f"LSE {k6_off:.3f} ms, library forward {sdpa_fwd:.3f} ms")
    del q, k, v, do, o, lse
    out["dense"] = {}
    for arch, case in K7_DENSE_TIMES.items():
        q, k, v, do = k7_inputs(case, torch.bfloat16, dev, 9, True)
        o, lse = FA.flash_attention(q, k, v, return_lse=True)
        path = FAB.route(q, k, v, o, do)
        expect(path == "wgmma", f"K7 at {arch}'s layout takes {path}")
        ms = median_ms(lambda: FAB.flash_attention_bwd(q, k, v, o, lse, do))
        bound, by, flops, _ = bwd_bound(q, k, True, None)
        sdpa = sdpa_bwd_ms(q, k, v, do)
        out["dense"][arch] = {"shape": f"{tuple(q.shape)} kv "
                                       f"{tuple(k.shape)}, causal",
                              "ms": ms, "bound_ms": bound, "bound_by": by,
                              "route": path, "library_ms": sdpa,
                              "tflops_10d": flops / ms / 1e9,
                              "tflops_14d": 1.4 * flops / ms / 1e9}
        print(f"time: K7 at {arch}'s layout {out['dense'][arch]['shape']} "
              f"({path} route): {ms:.3f} ms, bound {bound:.3f} ms ({by}), "
              f"{k7_rates(ms, flops)}; library scaled_dot_product_attention "
              f"backward {sdpa:.3f} ms")
        del q, k, v, do, o, lse
    return out


def step_launches(spans, namespace="attention") -> list:
    """Each ``train.step`` span's counts in ``namespace``: the attention
    launches, or with ``attention_route`` K6's launches by route."""
    return [{k.split(".", 1)[1]: v for k, v in sp.get("metrics", {}).items()
             if k.startswith(namespace + ".")}
            for sp in spans if sp["sid"] == "train.step"]


def train_expected(cfg) -> dict:
    """The launches of one training step with remat on: a rematted
    block's forward runs twice (K6-with-LSE 2 a layer, K9 2 a mamba
    layer), the hybrid's shared block once; one backward each."""
    n = cfg.n_layers
    if cfg.family == "ssm":
        return {"ssm": {"mamba_scan": 2 * n, "mamba_scan_bwd": n},
                "attention": {}}
    if cfg.family == "hybrid":
        a = lm.n_shared_applications(cfg)
        k9 = {} if cfg.mamba2_use_ssd else {"mamba_scan": 2 * n,
                                            "mamba_scan_bwd": n}
        return {"ssm": k9, "attention": {"flash_attention_lse": a,
                                         "flash_attention_bwd": a}}
    return {"ssm": {}, "attention": {"flash_attention_lse": 2 * n,
                                     "flash_attention_bwd": n}}


def phase_train(cfg, dev) -> tuple:
    """A training main path: ``runtime.train_loop.train`` on ``cfg``
    (float32 master params, bfloat16 compute, remat on), 1 × 4096 tokens a
    step, 6 steps, nothing wrapped around the loop, every count set to 0
    just before and read just after; each step's launches from its
    ``train.step`` span, exact (``train_expected``), every K6-with-LSE and
    K7 launch on the wgmma route."""
    s = TrainSettings(batch=1, seq=TRAIN_SEQ, steps=TRAIN_STEPS, log_every=1)
    spans = []
    torch.cuda.empty_cache()
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    obs.enable(sink=spans.append)
    t0 = time.perf_counter()
    out = train(cfg, s, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    obs.disable()
    peak = torch.cuda.max_memory_allocated(dev)
    want = train_expected(cfg)
    steps = {ns: step_launches(spans, ns) for ns in ("ssm", "attention")}
    for ns in ("ssm", "attention"):
        expect(steps[ns] == [want[ns]] * TRAIN_STEPS,
               f"{cfg.name} {ns} launches a step: {steps[ns]}")
    launches = {**dict(MS.LAUNCHES), **dict(FA.LAUNCHES)}
    total = {k: v * TRAIN_STEPS for ns in want.values() for k, v in
             ns.items()}
    expect({k: v for k, v in launches.items() if v} == total, launches)
    a = want["attention"]
    routes = (dict(FA.ROUTE_LAUNCHES), dict(FA.BWD_ROUTE_LAUNCHES))
    expect(routes == ({"wgmma": a.get("flash_attention_lse", 0) * TRAIN_STEPS,
                       "classic": 0},
                      {"wgmma": a.get("flash_attention_bwd", 0) * TRAIN_STEPS,
                       "classic": 0}), routes)
    expect(not any(K.LAUNCHES.values()) and not any(PD.LAUNCHES.values()),
           (dict(K.LAUNCHES), dict(PD.LAUNCHES)))
    losses = out["losses"]
    expect(len(losses) == TRAIN_STEPS and out["restarts"] == 0, losses)
    expect(all(math.isfinite(x) for x in losses), f"losses {losses}")
    med = statistics.median(out["step_seconds"][1:TRAIN_STEPS])
    n_params = sum(t.numel() for t in T.leaves(out["final_params"]))
    res = {"layers": cfg.n_layers, "params": n_params,
           "state_bytes": 16 * n_params, "tokens_per_step": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "losses": losses,
           "step_seconds": out["step_seconds"], "median_step_s_1_5": med,
           "tokens_per_s": TRAIN_SEQ / med, "wall_s": wall,
           "peak_bytes": peak, "launches": launches,
           "launches_per_step": {**want["ssm"], **want["attention"]},
           "k6_routes": routes[0], "k7_routes": routes[1]}
    print(f"train: {cfg.name} ({cfg.n_layers} layers, {n_params} params, "
          f"{16 * n_params} B of state at 16 B a param) 1 x {TRAIN_SEQ} "
          f"tokens a step, {TRAIN_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]}; median step of steps 1-5 "
          f"{med:.3f} s, {TRAIN_SEQ / med:.0f} tokens/s; steps "
          f"{[round(x, 3) for x in out['step_seconds']]} s; peak {peak} "
          f"bytes; launches per step {res['launches_per_step']}, in all "
          f"{ {k: v for k, v in launches.items() if v} }; K6-with-LSE "
          f"routes {routes[0]}; K7 routes {routes[1]}")
    return out["final_params"], s, res


OPT_MARK = "spin_kernel"      # torch.cuda._sleep's kernel


def phase_train_profile(cfg, s, params, batch, dev) -> dict:
    """One call of the main path's step function (``make_train_step``:
    the gradient, then the AdamW update) under ``torch.profiler``, after
    one call to warm up and one timed without the profiler: device time by
    kernel group, the share of the wall with no kernel running, and what
    the host did (``host_delta``) in both calls.  The update's kernels run
    after the gradient's on the one stream; a marker kernel
    (``torch.cuda._sleep``) launched as ``optim.update`` is entered tells
    them apart."""
    step_fn = make_train_step(cfg, s)
    held = {"opt": optim.init(params)}
    update = optim.update

    def marked(*a, **kw):
        torch.cuda._sleep(1)
        return update(*a, **kw)

    def step():
        _, held["opt"], _, _ = step_fn(params, held["opt"], None, batch, 0)
    step()                                           # warm-up
    sync(dev)
    h0 = host_counters()
    step()
    sync(dev)
    plain_host = host_delta(h0, host_counters())
    print(f"unprofiled train step 1 x {TRAIN_SEQ}: {host_line(plain_host)}")
    optim.update = marked
    try:
        res = device_profile(step, dev, f"train step 1 x {TRAIN_SEQ}",
                             tail=(OPT_MARK, "optimizer (AdamW update)"))
    finally:
        optim.update = update
    res["unprofiled_host"] = plain_host
    expect(res["tail_marker_seen"] or not res["device_busy_ms"],
           f"the profile shows no {OPT_MARK} before the update")
    del held
    return res


# Per leaf, ‖g_kernels − g_plain‖ ≤ GRAD_REL_TOL · ‖g_plain‖ for one step's
# gradient of gemma2-2b FULL in bfloat16 (and falcon-mamba's), and the
# median over the leaves ≤ GRAD_MEDIAN_TOL.  Set between the sound readings
# and a planted fault's (PERF.md §6).  Three families take a limit of their
# own on the largest leaf, set the same way: zamba2's dt_bias gradients are
# sums that cancel to a few percent of their terms, so the bf16 rounding of
# 38 layers moves them 7-8% (a planted K7 fault: 62%); granite-moe's
# router gradients follow the top-k, which flips for tokens near a tie when
# bf16 hidden states differ in the last bit (15-22%; the fault: 1868%);
# musicgen-medium's worst leaves are wq and wk of its deep layers (15.7%;
# the median leaf 0.63%; the fault: 16570%), moved by K6-with-LSE's bf16
# rounding of the forward (K7 alone in the chain reads 0.95%), where bf16
# moves them most: the plain path in bf16 is 34% from its own float32
# gradient there.  ``grad_witnesses`` holds what a wide limit leaves open
# (musicgen, qwen2-vl, zamba2, granite-moe).
GRAD_REL_TOL = 5e-2
GRAD_MEDIAN_TOL = 0.1
FAMILY_GRAD_TOL = {"zamba2-1.2b": 0.2, "granite-moe-3b-a800m": 1.0,
                   "musicgen-medium": 0.5}
# The kernels' bf16 gradient is no farther from the float32 plain gradient
# than F32_WITNESS_RATIO times the plain bf16 gradient is, on the worst
# leaf and on the median (musicgen 1.08 and 1.00, qwen2-vl 1.04 and 1.01,
# zamba2 0.98 and 1.00; granite-moe's 1.61 and 0.99 on its router, which
# is read, not held).
F32_WITNESS_RATIO = 1.5


def leaf_errors(grads, want, params) -> dict:
    return rel_summary({"__".join(p): float((g - w).norm() / w.norm())
                        for (p, _), g, w in zip(T.flatten_with_path(params),
                                                grads, want)})


def rel_summary(rels) -> dict:
    """The worst, the median and the five worst of {leaf: rel err}."""
    worst = sorted(rels, key=rels.get, reverse=True)
    return {"max_rel": rels[worst[0]], "worst_leaf": worst[0],
            "median_rel": statistics.median(rels.values()),
            "worst_5": {k: rels[k] for k in worst[:5]}}


class BwdFault:
    """Wraps K7's wrapper as the autograd Function calls it: every call
    runs with ``edit(args, kwargs)`` instead, the forward unchanged."""

    def __init__(self, edit):
        self.edit = edit

    def __enter__(self):
        self.orig = FAB.flash_attention_bwd

        def wrapped(*a, **kw):
            a, kw = self.edit(a, kw)
            return self.orig(*a, **kw)
        OPS._fab.flash_attention_bwd = wrapped
        return self

    def __exit__(self, *exc):
        OPS._fab.flash_attention_bwd = self.orig
        return False


class FwdPlain:
    """K6's wrapper, which the autograd Function calls for its forward
    (with the LSE), replaced by the plain versions, so every activation
    is the plain path's bits and K7 runs alone in the backward."""

    def __enter__(self):
        self.orig = FA.flash_attention

        def plain(q, k, v, return_lse=False, **kw):
            if return_lse:
                return R.attention_lse_ref(q, k, v, **kw)
            return R.attention_ref(q, k, v, **kw)
        OPS._fa.flash_attention = plain
        return self

    def __exit__(self, *exc):
        OPS._fa.flash_attention = self.orig
        return False


def grad_witnesses(cfg, params, batch, want, got, faults, must_break) -> dict:
    """What a family's own wide limit (FAMILY_GRAD_TOL) leaves open, read
    and gated: (1) the gradient in float32 through the plain versions
    (TF32 off), from which the kernels' bf16 gradient is no farther than
    F32_WITNESS_RATIO times the plain bf16 gradient is, on the worst leaf
    and on the median (a MoE's ratio is read, not held: its router
    follows the top-k, which the two bf16 forwards flip for different
    tokens); (2) K7 alone in the chain (``FwdPlain``) against the plain
    versions at GRAD_REL_TOL and GRAD_MEDIAN_TOL, which the planted faults
    in ``must_break`` must break."""
    _, exact = loss_and_grads(params, batch, cfg.replace(kernels="ref",
                                                         dtype="float32"))
    res = {"plain_vs_f32": leaf_errors(want, exact, params),
           "kernels_vs_f32": leaf_errors(got, exact, params)}
    del exact
    with FwdPlain():
        _, g = loss_and_grads(params, batch, cfg)
    res["k7_alone"] = leaf_errors(g, want, params)
    del g
    res["k7_alone_faults"] = {}
    for name in must_break:
        with FwdPlain(), faults[name]():
            _, bad = loss_and_grads(params, batch, cfg)
        res["k7_alone_faults"][name] = leaf_errors(bad, want, params)
        del bad
    p, k = res["plain_vs_f32"], res["kernels_vs_f32"]
    ratio = {m: k[m] / p[m] for m in ("max_rel", "median_rel")}
    res["ratio_to_plain"] = ratio
    a = res["k7_alone"]
    broken = {n: round(e["max_rel"], 4)
              for n, e in res["k7_alone_faults"].items()}
    print(f"grad witness: {cfg.name}, distance from the float32 plain "
          f"gradient: plain bf16 max {p['max_rel']:.4e} ({p['worst_leaf']}),"
          f" median {p['median_rel']:.4e}; kernels max {k['max_rel']:.4e} "
          f"({k['worst_leaf']}), median {k['median_rel']:.4e}; ratios "
          f"{ratio['max_rel']:.3f} / {ratio['median_rel']:.3f} (limit "
          f"{F32_WITNESS_RATIO}). K7 alone in the chain (the plain forward) "
          f"vs plain: max {a['max_rel']:.4e} ({a['worst_leaf']}), median "
          f"{a['median_rel']:.4e} (limits {GRAD_REL_TOL}, median "
          f"{GRAD_MEDIAN_TOL}); with planted faults {broken}")
    expect(max(ratio.values()) <= F32_WITNESS_RATIO or cfg.family == "moe",
           f"the kernels' gradient is farther from float32 than the plain "
           f"path's: {ratio}")
    expect(a["max_rel"] <= GRAD_REL_TOL
           and a["median_rel"] <= GRAD_MEDIAN_TOL,
           f"K7 alone in the chain differs: {a}")
    for name, e in res["k7_alone_faults"].items():
        expect(e["max_rel"] > GRAD_REL_TOL,
               f"K7 alone in the chain misses {name}: {e}")
    return res


def phase_grad_parity(cfg, params, batch, what, faults=None,
                      must_break=(), witness=False) -> dict:
    """One step's gradient through the kernels and through the plain
    versions (``kernels="ref"``, the same autograd Functions) from the
    same params and batch: the loss and each leaf's ‖Δ‖/‖g‖, the largest
    within GRAD_REL_TOL (or the family's FAMILY_GRAD_TOL) and the median
    within GRAD_MEDIAN_TOL, with the kernels' launches exact and on the
    wgmma route.
    ``faults`` ({name: a context manager that plants the fault in the
    kernels' backward, the forward unchanged}) are read the same way;
    those in ``must_break`` must break the limit.  With ``witness``,
    ``grad_witnesses`` too."""
    reset_all_launches()
    loss_r, want = loss_and_grads(params, batch, cfg.replace(kernels="ref"))
    expect(not any(MS.LAUNCHES.values()) and not any(FA.LAUNCHES.values()),
           (dict(MS.LAUNCHES), dict(FA.LAUNCHES)))
    loss_k, got = loss_and_grads(params, batch, cfg)
    steps = train_expected(cfg)
    expect({k: v for k, v in {**dict(MS.LAUNCHES), **dict(
        FA.LAUNCHES)}.items() if v} == {**steps["ssm"], **steps["attention"]},
           (dict(MS.LAUNCHES), dict(FA.LAUNCHES)))
    a = steps["attention"]
    routes = (dict(FA.ROUTE_LAUNCHES), dict(FA.BWD_ROUTE_LAUNCHES))
    expect(routes == ({"wgmma": a.get("flash_attention_lse", 0),
                       "classic": 0},
                      {"wgmma": a.get("flash_attention_bwd", 0),
                       "classic": 0}), routes)
    tol = FAMILY_GRAD_TOL.get(cfg.name, GRAD_REL_TOL)
    sound = leaf_errors(got, want, params)
    loss_k, loss_r = float(loss_k), float(loss_r)
    sound["loss_rel"] = abs(loss_k - loss_r) / abs(loss_r)
    sound["limit"] = tol
    if witness:
        sound["witnesses"] = grad_witnesses(cfg, params, batch, want, got,
                                            faults, must_break)
    del got
    read = {}
    for name, plant in (faults or {}).items():
        with plant():
            loss_f, bad = loss_and_grads(params, batch, cfg)
        read[name] = leaf_errors(bad, want, params)
        read[name]["loss_rel"] = abs(float(loss_f) - loss_r) / abs(loss_r)
        del bad
    print(f"grad parity: {what}, kernels vs plain versions: loss "
          f"{loss_k:.6f} vs {loss_r:.6f} (rel {sound['loss_rel']:.3e}); "
          f"per-leaf rel: max {sound['max_rel']:.4e} ({sound['worst_leaf']}),"
          f" median {sound['median_rel']:.4e} (limits {tol}, median "
          f"{GRAD_MEDIAN_TOL}); the worst five "
          f"{ {k: round(v, 4) for k, v in sound['worst_5'].items()} }")
    for name, e in read.items():
        print(f"planted fault, {name}: per-leaf rel max {e['max_rel']:.4e} "
              f"({e['worst_leaf']}), median {e['median_rel']:.4e}")
    expect(sound["max_rel"] <= tol and sound["median_rel"] <= GRAD_MEDIAN_TOL,
           f"gradients differ: {sound}")
    for name in must_break:
        expect(read[name]["max_rel"] > tol,
               f"the gradient check misses {name}: {read[name]}")
    return {"what": what, "loss_kernels": loss_k, "loss_plain": loss_r,
            **sound, "planted_faults": read}


def bwd_window_faults() -> dict:
    """K7's planted faults, each wrapping its wrapper as the autograd
    Function calls it: every local layer's backward window one K6_TILE
    short, or halved; every layer's backward without D = rowsum(dO ∘ O)
    (o given as 0)."""
    def window(fn):
        return lambda a, kw: (a, kw if kw["window"] is None else
                              {**kw, "window": fn(kw["window"])})

    def drop_d(a, kw):
        return a[:3] + (torch.zeros_like(a[3]),) + a[4:], kw
    return {f"every local layer's backward window one {K6_TILE}-key tile "
            f"short": lambda: BwdFault(window(lambda w: w - K6_TILE)),
            "every local layer's backward window halved":
                lambda: BwdFault(window(lambda w: w // 2)),
            "every layer's backward without D = rowsum(dO o O)":
                lambda: BwdFault(drop_d)}


def phase_train_smoke(dev) -> dict:
    """The runtime on the card at gemma2-2b SMOKE (float32, head_dim 12:
    K6's and K7's float32 kernels): the loss decreases over 15 steps, and a
    crash at step 7 with a checkpoint every 3 steps (in a temporary
    directory) replays to the uninterrupted run's final loss."""
    cfg = get_config(ARCH, smoke=True)
    FA.reset_launches()
    out = train(cfg, TrainSettings(batch=4, seq=32, steps=15, lr=1e-2,
                                   warmup_steps=3, log_every=100),
                verbose=False, device=dev)
    n = cfg.n_layers
    expect(dict(FA.LAUNCHES) == {"flash_attention": 0,
                                 "flash_attention_lse": 2 * n * 15,
                                 "flash_attention_bwd": n * 15},
           dict(FA.LAUNCHES))
    expect(dict(FA.ROUTE_LAUNCHES) == {"wgmma": 0, "classic": 2 * n * 15},
           dict(FA.ROUTE_LAUNCHES))
    expect(dict(FA.BWD_ROUTE_LAUNCHES) == {"wgmma": 0, "classic": n * 15},
           dict(FA.BWD_ROUTE_LAUNCHES))
    expect(out["losses"][-1] < out["losses"][0], out["losses"])
    base = dict(batch=2, seq=16, steps=10, lr=1e-3, warmup_steps=2,
                log_every=100)
    with tempfile.TemporaryDirectory() as d:
        crashed = train(cfg, TrainSettings(**base, ckpt_every=3,
                                           ckpt_dir=os.path.join(d, "a")),
                        fault=FaultInjector(fault_step=7), verbose=False,
                        device=dev)
    plain = train(cfg, TrainSettings(**base), verbose=False, device=dev)
    a, b = crashed["losses"][-1], plain["losses"][-1]
    expect(crashed["restarts"] == 1, crashed["restarts"])
    expect(abs(a - b) <= 1e-5 * abs(b), (a, b))
    res = {"losses": out["losses"], "replay_final_loss": a,
           "uninterrupted_final_loss": b,
           "replay_identical": crashed["losses"] == plain["losses"]}
    print(f"train smoke: {cfg.name} SMOKE float32 on the card, loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} over 15 steps; "
          f"crash at 7 + restore: final loss {a:.7f} vs uninterrupted "
          f"{b:.7f}, every loss identical: {res['replay_identical']}")
    return res


def phase_training(dev) -> dict:
    """gemma2-2b training: the main path, its profile, and the gradient
    parity at full width; then the runtime at SMOKE size."""
    cfg = get_config(ARCH)
    params, s, main_path = phase_train(cfg, dev)
    batch = batch_to_torch(make_batch(cfg, s.seed, 0, s.batch, s.seq), dev)
    profile = phase_train_profile(cfg, s, params, batch, dev)
    torch.cuda.empty_cache()
    parity = phase_grad_parity(
        cfg, params, batch, f"{cfg.name} 1 x {TRAIN_SEQ}",
        faults=bwd_window_faults(),
        must_break=("every local layer's backward window halved",
                    "every layer's backward without D = rowsum(dO o O)"))
    del params, batch
    torch.cuda.empty_cache()
    smoke = phase_train_smoke(dev)
    print(json.dumps({"train": {"arch": ARCH, "main_path": main_path,
                                "profile": profile, "grad_parity": parity,
                                "smoke": smoke}}))
    return main_path

# --------------------------------- falcon-mamba-7b serving and forward (K9)

FM_ARCH = "falcon-mamba-7b"
K9_SOURCE = "src/repro_torch/kernels/csrc/mamba_scan.cu"
K9_REPLACES = "src/repro/kernels/mamba_scan.py:61"
K9_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}   # tests/test_kernels.py:108-127
# Besides the elementwise tolerances, y is held per (batch, tile of K9_TILE
# channels, the kernel's block at N = 16) to ‖got − want‖ ≤ K9_REL_TOL ·
# ‖want‖ over all steps, and the final state h likewise over the tile's
# channels and states; planted faults (the state reset every K9_CHUNK
# steps, D·x dropped, A's decay off by one state) must break it.
K9_TILE = 32
K9_REL_TOL = 1e-2
K9_CHUNK = 128                # the TPU kernel's time chunk (mamba_scan.py:33)
K9_CASES = [  # b, l, di, n
    # tests/test_kernels.py:85-90 (L = 100 unaligned) and the bf16 case of
    # :112-127 (run in both dtypes, as all of these)
    (2, 64, 32, 16), (1, 100, 16, 8), (1, 128, 64, 4), (3, 32, 8, 16),
    (1, 64, 16, 8),
    # SMOKE's Di 64 and N 4 over several chunks; the model's Di 8192 and
    # N 16; one step; Di and N no multiple of the kernel's tiles
    (2, 300, 64, 4), (1, 2048, 8192, 16), (1, 1, 8192, 16), (2, 37, 100, 3),
]
K9_FAULT_CASE = (1, 2048, 8192, 16)
SFU_PER_CLOCK_SM = 16         # exponentials a clock per SM (CUDA guide, cc 9.0)
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
FM_PLAIN_LEN = 512            # the plain scan's Python loop over 64 layers
#                               (1024 before phase_mesh_train: cut for it)
                              # (2048 until PR 25: 23.8 s of the run)
FM_PLAIN_LEN_F32 = 256
FM_FORWARD_LEN = 4096
# Per row of bfloat16 logits of falcon-mamba-7b: ‖a − b‖ ≤ FM_LOGIT_REL_TOL
# · ‖b‖ for K9 against the plain scan over the same prefill and for the
# equivalences.  K9 sums in another order than the plain sequential scan
# (time in segments folded from a carried prefix), so its state agrees with
# the plain version's within float32 rounding and its bfloat16 y differs in
# one-ulp roundings; each bfloat16 residual add of 64 layers can turn such
# a difference into a one-ulp step of the residual, so the last logits
# drift apart by a few percent; in float32 the same comparison holds
# elementwise to F32_TOL.  The limit lies between the sound readings and a
# planted fault's (K9 with D dropped in every layer), which every run
# re-reads and requires to exceed it.
FM_LOGIT_REL_TOL = 0.1
# K9 against the mirror of its own order of sums (ref.mamba_scan_segmented,
# the same expf on the card), per (batch, tile of K9_TILE channels): what
# differs is the FMA contraction and the order in which the state groups'
# parts of y add up, a few float32 ulps, so the limit is a thousandth of
# the plain version's K9_REL_TOL.  Held on h, and on y for float32 inputs
# (a bfloat16 y can round the other way on a tie of the last bit).
K9_MIRROR_REL_TOL = 1e-5


def k9_inputs(case, dtype, dev, seed, strided=False):
    """x, dt, a, b, c, d of one K9 case from a numpy seed, drawn as
    tests/test_kernels.py draws them (dt = 0.1·|N|, a = -|N|).  With
    ``strided``, x and dt are column slices of one (B, L, 2·Di) tensor and
    b, c of one (B, L, 3·N), as the model's splits give them."""
    b, l, di, n = case
    rng = np.random.default_rng(seed)

    def nrm(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
    x, dt = nrm(b, l, di), nrm(b, l, di).abs() * 0.1
    a, bb, cc, d = -nrm(di, n).abs(), nrm(b, l, n), nrm(b, l, n), nrm(di)
    if strided:
        x, dt = torch.cat([x, dt], -1).split(di, -1)
        bb, cc = torch.cat([bb, cc, nrm(b, l, n)], -1)[..., :2 * n].split(n,
                                                                         -1)
    x, dt, bb, cc = (t.to(dtype) for t in (x, dt, bb, cc))
    return x, dt, a, bb, cc, d


def tile_rel(got, want, dim) -> float:
    """Worst ‖got − want‖ / ‖want‖ over (batch, tile of K9_TILE channels),
    the channels on ``dim`` and the tile taking every other dim but the
    batch; 0/0 reads 0, x/0 inf."""
    def tiles(t):
        t = t.float().movedim(dim, -1)
        t = F.pad(t, (0, (-t.shape[-1]) % K9_TILE))
        return t.reshape(*t.shape[:-1], -1, K9_TILE).movedim(-2, 1).flatten(2)
    g, w = tiles(got), tiles(want)
    rel = (g - w).norm(dim=-1) / w.norm(dim=-1)
    return float(rel.nan_to_num(nan=0.0, posinf=math.inf).max())


def k9_errors(got, want) -> dict:
    """(y, h) against (y, h): max abs errs, per-tile rel of each, and
    whether the elementwise and per-tile checks hold."""
    (gy, gh), (wy, wh) = got, want
    tol = K9_TOL[gy.dtype]
    dy, dh = (gy.float() - wy.float()).abs(), (gh - wh).abs()
    res = {"max_abs_y": float(dy.max()) if dy.numel() else 0.0,
           "max_abs_h": float(dh.max()) if dh.numel() else 0.0,
           "h_same_bits": bool(torch.equal(gh, wh)),
           "rel_y": tile_rel(gy, wy, 2), "rel_h": tile_rel(gh, wh, 1)}
    res["elementwise_ok"] = bool(torch.isfinite(gy).all()) and bool(
        torch.isfinite(gh).all()) and bool(
        (dy <= tol + tol * wy.float().abs()).all()) and bool(
        (dh <= K9_TOL[torch.float32]
         + K9_TOL[torch.float32] * wh.abs()).all())
    res["rel"] = max(res["rel_y"], res["rel_h"])
    res["rel_ok"] = res["rel"] <= K9_REL_TOL
    return res


def check_k9(args, what, mirror=True):
    """K9 with and without its final state against the plain sequential
    form on the same inputs, by both checks; y is the same bits either
    way.  With ``mirror``, also against the mirror of its own order of sums
    (``ref.mamba_scan_segmented``) within K9_MIRROR_REL_TOL per tile.
    Returns (errors, the plain version's (y, h))."""
    y = MS.mamba_scan(*args)
    got = MS.mamba_scan(*args, return_state=True)
    want = R.mamba_scan_seq_stateful(*args)
    sync(args[0].device)
    x, _, a = args[:3]
    expect(y.dtype == x.dtype and y.shape == x.shape, what)
    expect(got[1].dtype == torch.float32 and got[1].shape ==
           (x.shape[0], x.shape[2], a.shape[1]), what)
    expect(torch.equal(y, got[0]), f"K9 with its state changes y: {what}")
    e = k9_errors(got, want)
    MAX_ERR["mamba_scan"] = max(MAX_ERR["mamba_scan"], e["max_abs_y"],
                                e["max_abs_h"])
    MAX_REL["mamba_scan"] = max(MAX_REL["mamba_scan"], e["rel"])
    expect(e["elementwise_ok"] and e["rel_ok"],
           f"K9 disagrees with its plain version ({what}): {e}")
    if mirror:
        my, mh = R.mamba_scan_segmented(*args, seg_len=MS.SEG_LEN)
        e["mirror_rel_h"] = tile_rel(got[1], mh, 1)
        e["mirror_rel_y"] = (tile_rel(got[0], my, 2)
                             if x.dtype == torch.float32 else None)
        e["mirror_max_abs_h"] = float((got[1] - mh).abs().max())
        worst = max(e["mirror_rel_h"], e["mirror_rel_y"] or 0.0)
        MAX_REL["mamba_scan_mirror"] = max(
            MAX_REL.get("mamba_scan_mirror", 0.0), worst)
        expect(worst <= K9_MIRROR_REL_TOL,
               f"K9 disagrees with the mirror of its order of sums "
               f"({what}): {e}")
        del my, mh
    return e, want


def k9_faults(args, want) -> dict:
    """Planted faults, each through the kernel, read against the plain
    version's (y, h): the state reset every K9_CHUNK steps (K9 run chunk by
    chunk), D·x dropped (D = 0), A's decay off by one state (A rolled by
    one along N).  Each must keep finite output and break the per-tile
    limit."""
    x, dt, a, b, c, d = args
    parts = [MS.mamba_scan(x[:, t:t + K9_CHUNK], dt[:, t:t + K9_CHUNK], a,
                           b[:, t:t + K9_CHUNK], c[:, t:t + K9_CHUNK], d,
                           return_state=True)
             for t in range(0, x.shape[1], K9_CHUNK)]
    runs = {f"state reset every {K9_CHUNK} steps":
            (torch.cat([p[0] for p in parts], 1), parts[-1][1]),
            "D.x dropped (D = 0)": MS.mamba_scan(
                x, dt, a, b, c, torch.zeros_like(d), return_state=True),
            "A's decay off by one state": MS.mamba_scan(
                x, dt, a.roll(1, dims=1), b, c, d, return_state=True)}
    out = {}
    for name, got in runs.items():
        e = k9_errors(got, want)
        finite = bool(torch.isfinite(got[0]).all() and
                      torch.isfinite(got[1]).all())
        out[name] = {k: e[k] for k in ("max_abs_y", "rel_y", "rel_h", "rel")}
        out[name]["finite"] = finite
        print(f"planted K9 fault, {name}: per-tile rel err y "
              f"{e['rel_y']:.3e}, h {e['rel_h']:.3e}; elementwise check "
              f"{'passes' if e['elementwise_ok'] else 'fails'}, per-tile "
              f"check {'passes' if e['rel_ok'] else 'fails'}")
        expect(finite and not e["rel_ok"],
               f"the per-tile check misses {name}: {e}")
    return out


def phase_k9_parity_edges(dev) -> dict:
    """K9 against its plain version on the card: every case in float32
    and bfloat16, contiguous and strided, with and without the state; then
    the planted faults at the model's Di and N."""
    for i, case in enumerate(K9_CASES):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            for strided in (False, True):
                errs[(dtype, strided)], _ = check_k9(
                    k9_inputs(case, dtype, dev, i, strided),
                    f"{case} {dtype} strided={strided}")
        f32 = max(max(e["max_abs_y"], e["max_abs_h"])
                  for (dt, _), e in errs.items() if dt == torch.float32)
        bf = max(e["max_abs_y"] for (dt, _), e in errs.items()
                 if dt == torch.bfloat16)
        rel = max(e["rel"] for e in errs.values())
        same = all(e["h_same_bits"] for e in errs.values())
        mir = max(max(e["mirror_rel_h"], e["mirror_rel_y"] or 0.0)
                  for e in errs.values())
        print(f"parity K9 {case}: f32 max abs err {f32:.3e} (tol 1e-4 abs + "
              f"rel), bf16 y max abs err {bf:.3e} (tol 5e-2), per-tile rel "
              f"err {rel:.3e} (limit {K9_REL_TOL}); against the mirror of "
              f"its order of sums per-tile rel {mir:.3e} (limit "
              f"{K9_MIRROR_REL_TOL}); contiguous and strided, y the same "
              f"bits with and without the state; h the plain version's "
              f"bits: {same} (another order of sums)")
    args = k9_inputs(K9_FAULT_CASE, torch.bfloat16, dev, 50, True)
    sound, want = check_k9(args, f"{K9_FAULT_CASE} fault case")
    print(f"parity K9 {K9_FAULT_CASE} bf16 strided, fault case: per-tile "
          f"rel err y {sound['rel_y']:.3e}, h {sound['rel_h']:.3e}")
    return {"fault_case": K9_FAULT_CASE, "sound": sound,
            "planted_faults": k9_faults(args, want)}


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], check=True, capture_output=True, text=True,
        timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def k9_bound(x, a, return_state) -> dict:
    """The least time for K9 on these inputs, the largest of: the bytes
    (x, dt read and y written, b, c, a, d read, h written) at 3.35 TB/s;
    4 float32 FMAs per (t, i, j) at 67 TFLOP/s; one exponential per
    (t, i, j) at SFU_PER_CLOCK_SM a clock on each SM at the card's maximum
    SM clock."""
    bsz, seq, di = x.shape
    n = a.shape[1]
    es = x.element_size()
    nbytes = (3 * bsz * seq * di + 2 * bsz * seq * n) * es \
        + 4 * (di * n + di) + (4 * bsz * di * n if return_state else 0)
    steps = bsz * seq * di * n
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    clock = sm_clock_hz()
    ms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
          "fma": 8 * steps / F32_FLOPS * 1e3,
          "exp": steps / (SFU_PER_CLOCK_SM * sms * clock) * 1e3}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": "bytes" if by == "bytes"
            else "operations", "binds": by, "bytes": nbytes,
            "exps": steps, "fmas": 4 * steps, "sms": sms,
            "sm_clock_mhz": clock / 1e6,
            **{f"bound_{k}_ms": v for k, v in ms.items()}}


def fm_prefill(cfg, params, dev, seq=PREFILL_LEN):
    """The main path: 1 × ``seq`` tokens through ``lm.prefill`` with every
    launch count set to 0 just before it and nothing wrapped around it."""
    lm.prefill(params, lm_inputs(cfg, 1, 256, dev, SEED + 1), cfg)  # warm-up
    inputs = lm_inputs(cfg, 1, seq, dev, SEED)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    t0 = time.perf_counter()
    logits, caches = lm.prefill(params, inputs, cfg)
    sync(dev)
    wall = time.perf_counter() - t0
    launches, peak = dict(MS.LAUNCHES), torch.cuda.max_memory_allocated(dev)
    expect(launches == {"mamba_scan": cfg.n_layers, "mamba_scan_bwd": 0},
           launches)
    expect(not any(FA.LAUNCHES.values()) and not any(K.LAUNCHES.values()),
           (dict(FA.LAUNCHES), dict(K.LAUNCHES)))
    expect(logits.shape == (1, 1, cfg.vocab_padded), logits.shape)
    expect(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    di, n = cfg.d_inner, cfg.ssm_state
    expect(len(caches["ssm"]) == cfg.n_layers and all(
        st.conv.shape == (1, cfg.ssm_conv - 1, di) and st.h.shape ==
        (1, di, n) and bool(torch.isfinite(st.h).all())
        for st in caches["ssm"]), "prefill states")
    res = {"tokens": seq, "wall_s": wall, "tokens_per_s": seq / wall,
           "peak_bytes": peak, "launches": launches}
    print(f"prefill: {cfg.name} bf16 1 x {seq} tokens, {wall:.3f} s wall, "
          f"{seq / wall:.0f} tokens/s, peak {peak} bytes, K9 launches "
          f"{launches['mamba_scan']}")
    return inputs, logits, caches, res


def fm_capture(cfg, params, inputs, wall, dev):
    """A second prefill of the main path's inputs through ``Capture``:
    the scan inputs of the first and last layers, K9's time by CUDA events
    as a share of the main path's wall; then K9 against the plain version
    over all the steps of those two layers, by both checks, and the
    planted faults there."""
    last = cfg.n_layers - 1
    MS.reset_launches()
    with Capture("mamba_scan", keep=(0, last)) as cap:
        lm.prefill(params, inputs, cfg)
        sync(dev)
    expect(MS.LAUNCHES["mamba_scan"] == cfg.n_layers, dict(MS.LAUNCHES))
    k9_ms = cap.kernel_ms()
    res = {"k9_ms": k9_ms, "k9_share": k9_ms / 1e3 / wall}
    print(f"prefill K9 time: {cfg.n_layers} launches taking {k9_ms:.1f} ms "
          f"by CUDA events ({100 * res['k9_share']:.1f}% of the main path's "
          f"wall)")
    res["layers"] = {}
    for i in (0, last):
        args = cap.calls[i][0]
        # the mirror of 32768 steps would hold (L, Di, N) weights: 17 GB
        e, want = check_k9(args, f"prefill layer {i}", mirror=False)
        print(f"parity K9 prefill layer {i} x {tuple(args[0].shape)} "
              f"{args[0].dtype}: y max abs err {e['max_abs_y']:.3e}, h max "
              f"abs err {e['max_abs_h']:.3e} (h the plain version's bits: "
              f"{e['h_same_bits']}; another order of sums), per-tile rel err "
              f"y {e['rel_y']:.3e}, h "
              f"{e['rel_h']:.3e} (tol elementwise 5e-2 on y, 1e-4 on h; per "
              f"tile {K9_REL_TOL})")
        res["layers"][i] = {"sound": e, "planted_faults": k9_faults(args,
                                                                    want)}
        del want
    return cap.calls[0][0], res


def phase_k9_times(args) -> dict:
    """K9 at the prefill's shape (layer 0's captured inputs, with its final
    state, as the prefill calls it): CUDA events, median of 20, beside the
    bound and the plain version (median of 3).  No library call: PyTorch
    has none that computes a selective scan."""
    ms = median_ms(lambda: MS.mamba_scan(*args, return_state=True))
    plain = median_ms(lambda: R.mamba_scan_seq_stateful(*args),
                      reps=PLAIN_REPS)
    b = k9_bound(args[0], args[2], True)
    res = {"ms": ms, "plain_ms": plain, **b, "library_ms": None,
           "shape": f"x {tuple(args[0].shape)} {args[0].dtype}, N "
                    f"{args[2].shape[1]}, with the final state"}
    print(f"time: K9 {res['shape']}: {ms:.3f} ms, bound {b['bound_ms']:.3f} "
          f"ms ({b['binds']} binds: {b['exps']:.3e} exponentials at "
          f"{SFU_PER_CLOCK_SM}/clock/SM x {b['sms']} SMs x "
          f"{b['sm_clock_mhz']:.0f} MHz = {b['bound_exp_ms']:.3f} ms; "
          f"{b['fmas']:.3e} f32 FMAs at 67 TFLOP/s = {b['bound_fma_ms']:.3f} "
          f"ms; {b['bytes']} bytes at 3.35 TB/s = {b['bound_bytes_ms']:.3f} "
          f"ms), {b['bound_ms'] / ms:.1%} of the bound, plain {plain:.3f} ms "
          f"(median of {PLAIN_REPS}); library: none (no PyTorch call "
          f"computes a selective scan)")
    return res


def fm_forward(cfg, params, dev, seq=FM_FORWARD_LEN) -> dict:
    """``lm.forward_hidden`` + ``logits_fn`` over 1 × ``seq`` tokens: K9
    launched once a layer."""
    inputs = lm_inputs(cfg, 1, seq, dev, SEED + 3)
    reset_all_launches()
    t0 = time.perf_counter()
    logits = lm.logits_fn(params, lm.forward_hidden(params, inputs, cfg), cfg)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(MS.LAUNCHES)
    expect(launches == {"mamba_scan": cfg.n_layers, "mamba_scan_bwd": 0},
           launches)
    expect(logits.shape == (1, seq, cfg.vocab_padded), logits.shape)
    expect(bool(torch.isfinite(logits).all()), "forward logits not finite")
    print(f"forward: {cfg.name} forward_hidden + logits_fn over 1 x {seq} "
          f"tokens, {wall:.3f} s, K9 launches {launches['mamba_scan']}")
    return {"tokens": seq, "wall_s": wall, "launches": launches}


def stepwise_vs_forward(cfg, params, dev, s=EQUIV_PREFIX, b=2,
                        rel_tol=BF16_LOGIT_REL_TOL) -> dict:
    """s decode steps from empty caches give the forward's logits column
    by column (tests/test_models.py:61-96)."""
    inputs = lm_inputs(cfg, b, s, dev, SEED + 4)
    full = lm.logits_fn(params, lm.forward_hidden(params, inputs, cfg), cfg)
    caches = lm.make_cache(cfg, b, s, device=dev)
    cols = []
    for t in range(s):
        lg, caches = lm.decode_step(
            params, {"tokens": inputs["tokens"][:, t:t + 1],
                     "positions": inputs["positions"][:, t:t + 1]}, caches,
            cfg)
        cols.append(lg[:, 0])
    sync(dev)
    v = cfg.vocab_size
    return logits_agree(torch.stack(cols, 1)[..., :v], full[..., :v],
                        f"equivalence: {cfg.name} {cfg.dtype} {s} decode "
                        f"steps == forward, column by column", rel_tol)


def fm_prefill_plain(cfg, params, dev, seq=FM_PLAIN_LEN) -> dict:
    """The same prefill (``seq`` tokens) through K9 and through the plain
    scan: the last logits agree (bfloat16 per row within FM_LOGIT_REL_TOL,
    float32 elementwise).  Then K9 prefills with planted faults in every
    layer, read the same way: D dropped must break the limit, and in
    float32 so must the state faults (in bfloat16 they hide in the
    rounding drift; K9's own checks catch them)."""
    inputs = lm_inputs(cfg, 1, seq, dev, SEED + 5)
    logits, _ = lm.prefill(params, inputs, cfg)
    MS.reset_launches()
    t0 = time.perf_counter()
    ref_logits, _ = lm.prefill(params, inputs, cfg.replace(kernels="ref"))
    sync(dev)
    wall = time.perf_counter() - t0
    expect(MS.LAUNCHES["mamba_scan"] == 0, dict(MS.LAUNCHES))
    print(f"prefill plain scan: {cfg.dtype} 1 x {seq} tokens, {wall:.3f} s "
          f"wall")
    v = cfg.vocab_size
    ref_logits = ref_logits[..., :v]
    errs = logit_errors(logits[..., :v], ref_logits,
                        f"{cfg.dtype} prefill({seq}) K9 vs plain scan, last "
                        f"logits", FM_LOGIT_REL_TOL)

    def chunked(i, orig, args, kw):
        x, dt, a, b, c, d = args
        parts = [orig(x[:, t:t + K9_CHUNK], dt[:, t:t + K9_CHUNK], a,
                      b[:, t:t + K9_CHUNK], c[:, t:t + K9_CHUNK], d, **kw)
                 for t in range(0, x.shape[1], K9_CHUNK)]
        return (torch.cat([p[0] for p in parts], 1), parts[-1][1])
    faults = {
        "K9 with D dropped in every layer": lambda i, orig, args, kw: orig(
            *args[:5], torch.zeros_like(args[5]), **kw),
        "K9 with A's decay off by one state in every layer":
            lambda i, orig, args, kw: orig(*args[:2], args[2].roll(1, dims=1),
                                           *args[3:], **kw),
        f"K9 with the state reset every {K9_CHUNK} steps in every layer":
            chunked,
    }
    controls = {}
    for name, fault in faults.items():
        with Capture("mamba_scan", fault=fault):
            bad, _ = lm.prefill(params, inputs, cfg)
        controls[name] = logit_errors(bad[..., :v], ref_logits,
                                      f"planted fault, {name}, vs plain",
                                      FM_LOGIT_REL_TOL)
        del bad
    expect(errs["ok"], f"prefill logits: {errs}")
    must = (controls if cfg.dtype == "float32"
            else ["K9 with D dropped in every layer"])
    for name in must:
        expect(not controls[name]["ok"],
               f"the logits check misses {name}: {controls[name]}")
    return {"tokens": seq, "plain_wall_s": wall, "logits_vs_plain": errs,
            "planted_faults": controls}


def phase_falcon_mamba(dev) -> dict:
    """falcon-mamba-7b FULL in bfloat16, params from the port's
    init_params on a seeded generator: K9's edge cases, the 32k prefill
    (the main path), K9 on its captured layers and at its shape, decode
    and its profile, the forward, the plain-scan prefill, the
    equivalences in bf16 and f32, the Server."""
    parity = phase_k9_parity_edges(dev)
    cfg = get_config(FM_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
    sync(dev)
    print(f"init: {cfg.name}, {cfg.param_count()} params in bfloat16, "
          f"{time.perf_counter() - t0:.3f} s")
    inputs, logits, caches, prefill = fm_prefill(cfg, params, dev)
    args, captured = fm_capture(cfg, params, inputs, prefill["wall_s"], dev)
    prefill.update(k9_ms=captured["k9_ms"], k9_share=captured["k9_share"])
    times = phase_k9_times(args)
    del args
    decode = phase_decode(cfg, params, logits, caches, dev)
    profile = phase_profile(cfg, params, inputs, caches, dev)
    del caches, inputs
    torch.cuda.empty_cache()
    forward = fm_forward(cfg, params, dev)
    plain = fm_prefill_plain(cfg, params, dev)
    tol = dict(rel_tol=FM_LOGIT_REL_TOL)
    equiv = {"bfloat16": {
        "stepwise_vs_forward": stepwise_vs_forward(cfg, params, dev, **tol),
        "prefill_vs_stepwise": prefill_vs_stepwise(cfg, params, dev, **tol)}}
    cfg32 = cfg.replace(dtype="float32")
    params = T.tree_map(lambda x: x.float(), params)
    plain32 = fm_prefill_plain(cfg32, params, dev, FM_PLAIN_LEN_F32)
    equiv["float32"] = {
        "stepwise_vs_forward": stepwise_vs_forward(cfg32, params, dev),
        "prefill_vs_stepwise": prefill_vs_stepwise(cfg32, params, dev)}
    del params
    torch.cuda.empty_cache()
    served = phase_serve(("--arch", FM_ARCH))
    print(json.dumps({"falcon_mamba": {
        "arch": FM_ARCH, "k9_parity": parity, "prefill": prefill,
        "captured_layers": captured["layers"], "k9_times": times,
        "decode": decode, "profile": profile, "forward": forward,
        "prefill_plain": plain, "prefill_plain_f32": plain32,
        "equivalence": equiv, "serve": served}},
        default=str))
    return {"launches": prefill["launches"]["mamba_scan"],
            "forward_launches": forward["launches"]["mamba_scan"],
            "decode_launches_per_step": decode["k9_launches"] / decode[
                "steps"], "times": times}


# ------------------------ K8 and the dense configs (nemotron, minicpm)

DENSE_ARCH = "nemotron-4-15b"
MINICPM_ARCH = "minicpm-2b"
MINICPM_PREFILL_LEN = 4096
K8_SOURCE = "src/repro_torch/kernels/csrc/paged_decode.cu"
K8_REPLACES = "src/repro/kernels/paged_decode.py:78"
# float32 elementwise (abs + rel), the reference's own tolerance
# (tests/test_kernels.py:426-427); bfloat16 elementwise as K6's (2e-2),
# and per (batch, query head) ‖got − want‖ ≤ K8_REL_TOL ‖want‖, as K6 is
# held; four planted faults must break the per-(b, h) limit.
K8_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
K8_REL_TOL = 1e-2
K8_CASES = [  # b, hq, kvh, ps, pps, hd, softcap
    # tests/test_kernels.py:402-406
    (2, 4, 2, 16, 4, 32, None), (3, 6, 2, 8, 5, 16, 30.0),
    (1, 4, 4, 16, 3, 32, None),
    # groups 1 (minicpm), 2 (gemma2), 6 (nemotron) and 48 (granite) at head
    # dims 64, 128 and 256; pages of 8, 16 and 128 (lm.PAGE_SIZE); the
    # models' own layouts (minicpm 36 x 64, gemma2 8/4 x 256 softcap 50,
    # nemotron 48/8 x 128, granite 48/1 x 128)
    (5, 4, 4, 8, 4, 64, None), (5, 36, 36, 128, 3, 64, None),
    (5, 4, 2, 16, 3, 128, 50.0), (5, 8, 4, 128, 3, 256, 50.0),
    (5, 12, 2, 8, 4, 128, None), (5, 48, 8, 128, 3, 128, None),
    (5, 6, 1, 16, 3, 256, 30.0), (5, 48, 1, 8, 4, 128, 50.0),
    (5, 48, 1, 128, 3, 128, None), (5, 48, 1, 16, 2, 64, None),
    (5, 48, 1, 8, 3, 256, None),
    # a whole 32k table (257 pages of 128) at nemotron's layout; the SMOKE
    # configs' head_dim 12
    (2, 48, 8, 128, 257, 128, None), (2, 4, 2, 8, 4, 12, 50.0),
    # the TMA route's edges (bf16 at head dims 64, 128, 256, pages of a
    # multiple of its 64-token tile): pages of 64 (a tile each) and 256
    # (four), group 6 at head dim 256, group 48 (three m-tiles) at head dim
    # 64; lengths 1, ps, ps + 1, the whole table and 0 cut tiles at every
    # edge
    (5, 12, 2, 64, 4, 128, 20.0), (5, 6, 1, 256, 3, 256, 30.0),
    (5, 48, 1, 64, 5, 64, None),
    # the MoE and hybrid layouts: group 3 at head dim 64 (granite-moe, with
    # pages of 64 too), MHA 32 x 64 (zamba2), group 4 at head dim 128
    # (phi3.5-moe)
    (5, 24, 8, 128, 3, 64, None), (5, 24, 8, 64, 5, 64, None),
    (5, 32, 32, 128, 3, 64, None), (5, 32, 8, 128, 3, 128, None),
]
# The planted faults run on each route: the classic kernels (pages of 16)
# and the TMA route (pages of 128).
K8_FAULT_CASES = {"classic": (5, 12, 2, 16, 4, 128, 20.0),
                  "tma": (5, 12, 2, 128, 4, 128, 20.0)}
K8_CAP_SIGMA = 30.0           # q at this σ: logits of std ~30, capped at 20
# The dense prefill's last logits against a plain-attention prefill, per
# row, bfloat16 (the rule of BF16_LOGIT_REL_TOL), over DENSE_PLAIN_LEN
# tokens; planted K6 faults in the same prefill must break the limit.
DENSE_PLAIN_LEN = 2048
DENSE_FAULT_WINDOW = 16
BATCH_DECODE = 8              # decode_32k's global batch 128, cut to one card


def k8_lengths(b, ps, pps):
    """1, a whole page, a page and one, the whole table and 0, in turn."""
    fixed = [1, ps, ps + 1, pps * ps, 0]
    if b < len(fixed):
        fixed = [pps * ps, 1, ps + 1, ps][:b]
    return fixed


def k8_route(dtype, ps, hd) -> str:
    """The route K8 must take (``paged_decode.route``): the TMA kernel for
    bfloat16 at head dims 64, 128 and 256 with pages of a whole number of
    its tiles; the classic kernels otherwise."""
    return "tma" if (dtype == torch.bfloat16 and hd in PD.TMA_HEAD_DIMS and
                     ps % PD.TMA_TILE == 0) else "classic"


def k8_inputs(case, dtype, dev, seed, q_sigma=1.0):
    """q, k_pages, v_pages, page_table, lengths of one K8 case from a seeded
    generator on the card: pages in a shuffled order with three spare, so
    the table is honoured and not assumed to be the identity."""
    b, hq, kvh, ps, pps, hd, _ = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_pages = b * pps + 3
    kp = torch.randn((num_pages, ps, kvh, hd), generator=gen, device=dev)
    vp = torch.randn((num_pages, ps, kvh, hd), generator=gen, device=dev)
    q = torch.randn((b, hq, hd), generator=gen, device=dev) * q_sigma
    table = torch.randperm(num_pages, generator=gen, device=dev)[
        :b * pps].reshape(b, pps).to(torch.int32)
    lengths = torch.tensor(k8_lengths(b, ps, pps), dtype=torch.int32,
                           device=dev)
    return q.to(dtype), kp.to(dtype), vp.to(dtype), table, lengths


def k8_errors(got, want) -> dict:
    """Max abs err, the worst per-(batch, query head) ‖got − want‖ /
    ‖want‖ (0/0 reads 0, x/0 reads inf), and whether each check holds."""
    g, w = got.float(), want.float()
    tol = K8_TOL[got.dtype]
    rel = ((g - w).norm(dim=-1) / w.norm(dim=-1))
    rel = float(rel.nan_to_num(nan=0.0, posinf=math.inf).max())
    return {"max_abs": float((g - w).abs().max()), "rel": rel,
            "mean_want": float(w.abs().mean()),
            "elementwise_ok": bool(torch.isfinite(g).all()) and bool(
                ((g - w).abs() <= tol + tol * w.abs()).all()),
            "rel_ok": rel <= K8_REL_TOL}


def check_k8(q, kp, vp, table, lengths, softcap, what) -> dict:
    """K8 against its plain version on the same inputs, by both checks; a
    second launch gives the same bits (the splits merge in a fixed
    order); both launches take the route the dtype, head dim and page size
    call for (``k8_route``)."""
    before = dict(PD.ROUTE_LAUNCHES)
    got = PD.paged_decode_attention(q, kp, vp, table, lengths,
                                    softcap=softcap)
    again = PD.paged_decode_attention(q, kp, vp, table, lengths,
                                      softcap=softcap)
    want = R.paged_decode_attention_ref(q, kp, vp, table, lengths,
                                        softcap=softcap)
    torch.cuda.synchronize()
    route = k8_route(q.dtype, kp.shape[1], q.shape[-1])
    routed = {n: PD.ROUTE_LAUNCHES[n] - before[n] for n in before}
    expect(routed == {"tma": 0, "classic": 0, route: 2},
           f"K8 took {routed}, want 2 on {route}: {what}")
    expect(got.dtype == q.dtype and got.shape == q.shape, what)
    expect(torch.equal(got, again), f"K8 changes from run to run: {what}")
    e = k8_errors(got, want)
    e["route"] = route
    MAX_ERR["paged_decode_attention"] = max(
        MAX_ERR["paged_decode_attention"], e["max_abs"])
    MAX_REL["paged_decode_attention"] = max(
        MAX_REL["paged_decode_attention"], e["rel"])
    if not (e["elementwise_ok"] and e["rel_ok"]):
        raise AssertionError(f"paged_decode_attention disagrees with its "
                             f"plain version ({what}): {e}")
    return e


def k8_garbage_table(table, lengths, ps):
    """``table`` with every entry at or past a row's last live page
    replaced by ids outside the pool (never to be read)."""
    bad = table.clone()
    live = (lengths.long().clamp(0, table.shape[1] * ps) + ps - 1) // ps
    col = torch.arange(table.shape[1], device=table.device)[None, :]
    junk = torch.tensor([-7, 10 ** 6, 2 ** 31 - 1, -2 ** 31],
                        dtype=torch.int32, device=table.device)
    return torch.where(col >= live[:, None], junk[col % 4], bad)


def k8_faults(dev, route) -> dict:
    """Planted faults at K8_FAULT_CASES[route] (bf16), each run through the
    kernel of that route and read against the plain version by the
    per-(b, h) check, which each must break: the page table ignored
    (identity pages), the mask off by one (pos <= length), the softcap
    dropped (at logits of std ~30), and split 0's partials dropped in the
    merge (the two stages launched apart, the merge on the route's own
    merge code: the TMA route's is the one its kernel runs in the same
    launch, and its two stages apart give the one launch's bits)."""
    case = K8_FAULT_CASES[route]
    b, hq, kvh, ps, pps, hd, cap = case
    expect(k8_route(torch.bfloat16, ps, hd) == route, (case, route))
    q, kp, vp, table, lengths = k8_inputs(case, torch.bfloat16, dev, 70)
    want = R.paged_decode_attention_ref(q, kp, vp, table, lengths,
                                        softcap=cap)
    check_k8(q, kp, vp, table, lengths, cap, f"{route} fault case")
    runs = {
        "page table ignored (identity pages)": PD.paged_decode_attention(
            q, kp, vp, paged.identity_table(b, pps, dev), lengths,
            softcap=cap),
        "mask off by one (pos <= length)": PD.paged_decode_attention(
            q, kp, vp, table, lengths + 1, softcap=cap)}
    qs, kps, vps, ts, ls = k8_inputs(case, torch.bfloat16, dev, 71,
                                     K8_CAP_SIGMA)
    want_cap = R.paged_decode_attention_ref(qs, kps, vps, ts, ls,
                                            softcap=cap)
    check_k8(qs, kps, vps, ts, ls, cap, f"{route} fault case, q at sigma "
             f"{K8_CAP_SIGMA}")
    runs["softcap dropped"] = PD.paged_decode_attention(qs, kps, vps, ts, ls)
    scale = 1 / math.sqrt(hd)
    out, parts = PD._launch(q, kp, vp, table, lengths, cap, scale, stage=1,
                            path=route)
    expect(parts.acc.shape[2] > 1, f"one split only: {parts.acc.shape}")
    whole = PD.paged_decode_attention(q, kp, vp, table, lengths, softcap=cap)
    apart = PD._launch(q, kp, vp, table, lengths, cap, scale, stage=2,
                       parts=parts, path=route)[0]
    expect(torch.equal(apart, whole), f"K8's {route} stages apart differ "
           "from its one launch")
    parts.ml[:, :, 0, :, 0] = R.NEG_INF
    parts.ml[:, :, 0, :, 1] = 0.0
    parts.acc[:, :, 0] = 0.0
    runs["split 0's partials dropped in the merge"] = PD._launch(
        q, kp, vp, table, lengths, cap, scale, stage=2, parts=parts, out=out,
        path=route)[0]
    out = {}
    for name, got in runs.items():
        e = k8_errors(got, want_cap if name == "softcap dropped" else want)
        out[name] = {k: e[k] for k in ("max_abs", "rel")}
        print(f"planted K8 fault ({route} route), {name}: max abs err "
              f"{e['max_abs']:.3e}, per-(b, h) rel err {e['rel']:.3e}; "
              f"per-(b, h) check {'passes' if e['rel_ok'] else 'fails'}")
        expect(not e["rel_ok"], f"the per-(b, h) check misses {name} on "
               f"the {route} route: {e}")
    return out


def phase_k8_parity_edges(dev) -> dict:
    """K8 against its plain version on the card: every case in float32 and
    bfloat16, then the same with garbage table entries past each length
    (the same bits: they are never read), then the planted faults."""
    for i, case in enumerate(K8_CASES):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, lengths = k8_inputs(case, dtype, dev, i)
            errs[dtype] = check_k8(q, kp, vp, table, lengths, case[6],
                                   f"{case} {dtype}")
            got = PD.paged_decode_attention(q, kp, vp, table, lengths,
                                            softcap=case[6])
            bad = PD.paged_decode_attention(
                q, kp, vp, k8_garbage_table(table, lengths, case[3]),
                lengths, softcap=case[6])
            expect(torch.equal(got, bad),
                   f"K8 reads table entries past the length: {case}")
        f32, bf = errs[torch.float32], errs[torch.bfloat16]
        lens = k8_lengths(case[0], case[3], case[4])
        print(f"parity K8 {case} lengths {lens}: f32 ({f32['route']} route) "
              f"max abs err {f32['max_abs']:.3e} (tol 2e-5 abs + rel), "
              f"bf16 ({bf['route']} route) max abs err {bf['max_abs']:.3e} "
              f"(tol 2e-2), per-(b, h) rel err "
              f"{max(f32['rel'], bf['rel']):.3e} (limit {K8_REL_TOL}); same "
              f"bits twice and with garbage past the lengths")
    return {"planted_faults": {route: k8_faults(dev, route)
                               for route in K8_FAULT_CASES},
            "two_streams": k8_two_streams(dev)}


# A whole 32k table at nemotron's layout: the TMA route, with many splits
# and so many tickets in use in each launch.
K8_STREAM_CASE = (2, 48, 8, 128, 257, 128, None)
K8_STREAM_ROUNDS = 10


def k8_two_streams(dev) -> dict:
    """Two TMA-route K8 launches at once on two streams of the card, each
    queued behind a spin kernel on its own stream so that they overlap,
    K8_STREAM_ROUNDS times over: each output equals the same call's bits
    on one stream alone and is held to its plain version; each stream
    counts into its own ticket buffer, and every ticket is back at 0."""
    args = [k8_inputs(K8_STREAM_CASE, torch.bfloat16, dev, seed)
            for seed in (41, 42)]
    alone = [PD.paged_decode_attention(*a) for a in args]
    wants = [R.paged_decode_attention_ref(*a) for a in args]
    streams = [torch.cuda.Stream(dev) for _ in args]
    torch.cuda.synchronize()
    before = dict(PD.ROUTE_LAUNCHES)
    outs = []
    for _ in range(K8_STREAM_ROUNDS):
        for st, a in zip(streams, args):
            with torch.cuda.stream(st):
                torch.cuda._sleep(SPIN_CYCLES // 20)
                outs.append(PD.paged_decode_attention(*a))
    torch.cuda.synchronize()
    routed = {n: PD.ROUTE_LAUNCHES[n] - before[n] for n in before}
    expect(routed == {"tma": 2 * K8_STREAM_ROUNDS, "classic": 0},
           f"K8 on two streams took {routed}")
    worst = 0.0
    for i, got in enumerate(outs):
        expect(torch.equal(got, alone[i % 2]),
               f"K8 on two streams differs from K8 alone (launch {i})")
        e = k8_errors(got, wants[i % 2])
        expect(e["elementwise_ok"] and e["rel_ok"],
               f"K8 on two streams disagrees with its plain version: {e}")
        worst = max(worst, e["rel"])
    bufs = [PD._COUNTERS[(torch.device(dev), st.cuda_stream)]
            for st in streams]
    expect(bufs[0].data_ptr() != bufs[1].data_ptr(),
           "two streams share K8's ticket buffer")
    left = sum(int(b.count_nonzero()) for b in PD._COUNTERS.values())
    expect(left == 0, f"{left} K8 tickets left non-zero")
    print(f"parity K8 on two streams at once: {2 * K8_STREAM_ROUNDS} TMA "
          f"launches, each == the call alone, per-(b, h) rel err {worst:.3e} "
          f"(limit {K8_REL_TOL}); a ticket buffer per stream, every ticket "
          "back at 0")
    return {"launches": 2 * K8_STREAM_ROUNDS, "max_rel": worst,
            "tickets_left": left}


def k8_capture(cfg, params, caches, dev, keep, donate=False):
    """One decode step from ``caches`` through ``Capture``: the K8 calls in
    ``keep`` (call i is the i-th layer without a window) with their
    arguments.  Returns ({i: (args, kw)}, the new caches)."""
    b = caches["kv"][0].lengths.shape[0]
    tok = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    with Capture("paged_decode_attention", keep=keep) as cap:
        _, caches = lm.decode_step(params, step_inputs(cfg, tok), caches,
                                   cfg, donate=donate)
        sync(dev)
    expect(len(cap.events) == unwindowed_layers(cfg), len(cap.events))
    return cap.calls, caches


def k8_on_captured(cfg, calls, what) -> dict:
    """K8 on captured decode layers by both checks."""
    out = {}
    for i, (args, kw) in sorted(calls.items()):
        q, kp, _, _, lengths = args
        e = check_k8(*args, kw["softcap"], f"{what} call {i}")
        out[i] = e
        print(f"parity K8 {what} call {i}: q {tuple(q.shape)} pages "
              f"{tuple(kp.shape)} {q.dtype} lengths "
              f"{lengths.tolist()[:8]} softcap {kw['softcap']}: max abs err "
              f"{e['max_abs']:.3e}, per-(b, h) rel err {e['rel']:.3e} (tol "
              f"elementwise 2e-2, rel {K8_REL_TOL})")
    return out


def k8_bound(q, kp, table, lengths) -> dict:
    """The least time for K8 on these inputs: the live K and V rows, q and
    the output, the live table entries and the lengths, each moved once,
    at 3.35 TB/s; the products (4·hd per query head and live position) at
    the bf16 tensor-core peak.  The bytes bind."""
    b, hq, hd = q.shape
    ps, kvh = kp.shape[1], kp.shape[2]
    live = lengths.long().clamp(0, table.shape[1] * ps)
    n = int(live.sum())
    pages = int(((live + ps - 1) // ps).sum())
    es = q.element_size()
    nbytes = 2 * n * kvh * hd * es + 2 * q.numel() * es + 4 * pages + 4 * b
    flops = 4 * hq * hd * n
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bytes": nbytes, "flops": flops, "live_positions": n}


SPIN_CYCLES = 2_000_000       # ~1 ms of torch.cuda._sleep at ~2 GHz


def device_ms(fn, reps=REPS, setup=None) -> float:
    """Median device time of ``fn`` by CUDA events, with a spin kernel
    queued before each start event: while it runs the host enqueues the
    event, ``fn``'s launches and the end event, so the reading is the
    device's time for ``fn`` and not the host's time to launch it (a K8
    call takes less time on the card than its Python wrapper takes).
    ``setup`` runs before each spin, untimed."""
    fn()                                   # warm-up
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_k8_times(args, kw, what, library=True) -> dict:
    """K8 on captured inputs (device time by CUDA events behind a spin
    kernel, median of 20; ``ms_host`` without the spin, as the earlier
    kernels are timed, which adds the wrapper's launch time) beside its
    bound and its plain version (median of 3).  With ``library`` (no
    softcap), scaled_dot_product_attention(enable_gqa=True) over the live
    cache, which computes the same function there: once with the gather
    through the table inside the timing, once over a gathered cache; each
    held to K8's per-(b, h) limit against K8.  At batch 1 the gather takes
    the row's live positions; at a larger batch every row's whole table,
    with a mask past each length."""
    q, kp, vp, table, lengths = args
    sc = kw["softcap"]
    def run():
        return PD.paged_decode_attention(q, kp, vp, table, lengths,
                                         softcap=sc)
    ms = device_ms(run)
    ms_host = median_ms(run)
    plain = device_ms(lambda: R.paged_decode_attention_ref(
        q, kp, vp, table, lengths, softcap=sc), reps=PLAIN_REPS)
    res = {"ms": ms, "ms_host": ms_host, "plain_ms": plain,
           "route": PD.route(q, kp, vp),
           **k8_bound(q, kp, table, lengths),
           "library_ms": None, "library_ms_no_gather": None,
           "shape": f"{what}: q {tuple(q.shape)}, pages {tuple(kp.shape)} "
                    f"{q.dtype}, lengths {lengths.tolist()[:8]}"}
    line = (f"time: K8 ({res['route']} route) {res['shape']}: {ms:.4f} ms "
            f"on the device ({ms_host:.4f} ms with the wrapper's launch), "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}: "
            f"{res['bytes']} bytes at 3.35 TB/s, {res['flops']:.3e} flops at "
            f"989 TFLOP/s), {res['bound_ms'] / ms:.1%} of the bound, "
            f"{res['bytes'] / ms / 1e6:.1f} GB/s, plain {plain:.4f} ms "
            f"(median of {PLAIN_REPS})")
    if library:
        expect(sc is None, "the library call is timed without a softcap")
        b, hd, kvh = q.shape[0], q.shape[2], kp.shape[2]
        ps, pps = kp.shape[1], table.shape[1]
        mask = None
        if b == 1:
            n = int(lengths[0])

            def gathered():
                k = kp[table[0].long()].reshape(-1, kvh, hd)[:n]
                v = vp[table[0].long()].reshape(-1, kvh, hd)[:n]
                return k.transpose(0, 1)[None], v.transpose(0, 1)[None]
        else:
            n = lengths.long().clamp(0, pps * ps)
            live = (torch.arange(pps, device=q.device)[None] * ps) < n[:, None]
            rows = torch.where(live, table.long(), 0)
            mask = (torch.arange(pps * ps, device=q.device)[None]
                    < n[:, None])[:, None, None, :]

            def gathered():
                k = kp[rows].reshape(b, pps * ps, kvh, hd)
                v = vp[rows].reshape(b, pps * ps, kvh, hd)
                return k.transpose(1, 2), v.transpose(1, 2)

        def sdpa(k, v):
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]
        k4, v4 = (t.contiguous() for t in gathered())
        agree = bh_rel(sdpa(k4, v4)[:, :, None], run()[:, :, None])
        expect(agree <= K8_REL_TOL, f"SDPA vs K8: {agree}")
        res["library_ms"] = device_ms(lambda: sdpa(*gathered()))
        res["library_ms_no_gather"] = device_ms(lambda: sdpa(k4, v4))
        res["library_rel_vs_kernel"] = agree
        del k4, v4
        line += (f"; library scaled_dot_product_attention(enable_gqa=True"
                 f"{'' if mask is None else ', a mask past each length'}) "
                 f"{res['library_ms']:.4f} ms with the gather through the "
                 f"table, {res['library_ms_no_gather']:.4f} ms over a "
                 f"gathered cache; per-(b, h) rel to K8 {agree:.3e}")
    print(line)
    return res


def dense_prefill_plain(cfg, params, dev, seq=DENSE_PLAIN_LEN) -> dict:
    """The same prefill (``seq`` tokens) with K6 and with the plain
    attention: the last logits agree per row.  Then K6 prefills with
    planted attention faults, read the same way: every layer's K6 with a
    window of DENSE_FAULT_WINDOW keys must break the limit; layer 0 without
    its causal mask is read and printed."""
    inputs = lm_inputs(cfg, 1, seq, dev, SEED + 6)
    logits, _ = lm.prefill(params, inputs, cfg)
    FA.reset_launches()
    t0 = time.perf_counter()
    ref_logits, _ = lm.prefill(params, inputs, cfg.replace(kernels="ref"))
    sync(dev)
    wall = time.perf_counter() - t0
    expect(FA.LAUNCHES["flash_attention"] == 0, dict(FA.LAUNCHES))
    v = cfg.vocab_size
    ref_logits = ref_logits[..., :v]
    errs = logit_errors(logits[..., :v], ref_logits,
                        f"{cfg.name} prefill({seq}) K6 vs plain attention, "
                        f"last logits")
    window = f"every layer's K6 with a window of {DENSE_FAULT_WINDOW} keys"
    faults = {
        window: lambda i, orig, a, kw: orig(
            *a, **{**kw, "window": DENSE_FAULT_WINDOW}),
        "layer 0's K6 without its causal mask": lambda i, orig, a, kw: orig(
            *a, **{**kw, "causal": kw["causal"] and i != 0}),
    }
    controls = {}
    for name, fault in faults.items():
        with Capture("flash_attention", fault=fault):
            bad, _ = lm.prefill(params, inputs, cfg)
        controls[name] = logit_errors(bad[..., :v], ref_logits,
                                      f"planted fault, {name}, vs plain")
        del bad
    expect(errs["ok"], f"prefill logits: {errs}")
    expect(not controls[window]["ok"],
           f"the logits check misses {window}: {controls[window]}")
    return {"tokens": seq, "plain_wall_s": wall, "logits_vs_plain": errs,
            "planted_faults": controls}


def random_caches(cfg, dev, batch, seq, steps, seed) -> dict:
    """Decode caches of every layer holding seeded random K/V in the
    config's dtype: room
    for ``seq`` + ``steps`` tokens a sequence, pages in a shuffled order
    (a table of its own per layer), ragged lengths up to ``seq`` (the
    first exactly ``seq``)."""
    ps = lm.PAGE_SIZE
    pps = -(-(seq + steps) // ps)
    num_pages = batch * pps
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    lengths = torch.from_numpy(np.concatenate(
        [[seq], rng.integers(seq // 2, seq + 1, batch - 1)]).astype(
            np.int32)).to(dev)
    shape = (num_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    dtype = getattr(torch, cfg.dtype)
    kv = []
    for _ in range(cfg.n_layers):
        table = torch.randperm(num_pages, generator=gen, device=dev).reshape(
            batch, pps).to(torch.int32)
        kv.append(paged.PagedKV(
            torch.randn(shape, generator=gen, device=dev, dtype=dtype),
            torch.randn(shape, generator=gen, device=dev, dtype=dtype),
            table, lengths))
    return {"kv": kv}


def phase_batched_decode(cfg, params, dev, batch=BATCH_DECODE,
                         seq=PREFILL_LEN, steps=DECODE_STEPS) -> dict:
    """Decode at batch ``batch`` over caches of ``seq`` tokens (random K/V
    from a seed, shuffled tables, ragged lengths), the caches donated to
    each step (written in place, as the reference's decode_32k step
    donates them).  A first step through ``Capture`` gives layer 0's K8
    inputs: K8 against its plain version and its time there.  Then
    ``steps`` greedy steps with every launch count set to 0 just before:
    32 K8 launches a step; step time and tokens/s."""
    caches = random_caches(cfg, dev, batch, seq, steps + 1, SEED + 7)
    nbytes = sum(2 * c.k_pages.numel() * c.k_pages.element_size()
                 for c in caches["kv"])
    lengths0 = caches["kv"][0].lengths.clone()
    sync(dev)
    calls, caches = k8_capture(cfg, params, caches, dev, keep=(0,),
                               donate=True)
    parity = k8_on_captured(cfg, calls, f"{cfg.name} batch {batch}")
    times = phase_k8_times(*calls[0], f"{cfg.name} decode layer 0, batch "
                           f"{batch}")
    del calls
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 8)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, 1))).to(
        dev)
    zeros = torch.zeros_like(tok)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, caches = lm.decode_step(params, {"tokens": tok,
                                             "positions": zeros}, caches,
                                    cfg, donate=True)
        tok = lg[:, -1].argmax(-1, keepdim=True)
    sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    k8 = PD.LAUNCHES["paged_decode_attention"]
    expect(k8 == cfg.n_layers * steps, dict(PD.LAUNCHES))
    expect(dict(PD.ROUTE_LAUNCHES) == {"tma": k8, "classic": 0},
           dict(PD.ROUTE_LAUNCHES))
    expect(not any(FA.LAUNCHES.values()), dict(FA.LAUNCHES))
    expect(all(torch.equal(c.lengths, lengths0 + 1 + steps)
               for c in caches["kv"]), "batched decode lengths")
    expect(bool(torch.isfinite(lg).all()), "batched decode logits")
    res = {"batch": batch, "steps": steps, "wall_s": wall,
           "step_ms": wall / steps * 1e3,
           "tokens_per_s": batch * steps / wall, "cache_bytes": nbytes,
           "peak_bytes": peak, "k8_launches": k8,
           "lengths": lengths0.tolist(), "k8": times, "k8_parity": parity}
    print(f"decode batch {batch}: {cfg.name} {steps} steps over caches of "
          f"{nbytes} bytes (lengths {lengths0.tolist()}), {wall:.3f} s, "
          f"{res['step_ms']:.2f} ms a step, {res['tokens_per_s']:.1f} "
          f"tokens/s, peak {peak} bytes, K8 launches {k8} (all on the TMA "
          f"route)")
    return res


def to_float_in_place(tree):
    """Every tensor of a params tree as float32, replaced one at a time so
    the bfloat16 copy of each goes as its float32 one comes."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in list(items):
        if isinstance(val, torch.Tensor):
            tree[key] = val.float()
        else:
            to_float_in_place(val)
    return tree


def phase_k6_dense_times(cfg, call) -> dict:
    """K6 on the dense prefill's captured layer 0 (nemotron-4-15b: 1 × 48 ×
    32768 × 128, 8 kv heads, causal, no softcap, no window): held to its
    plain version by both checks, then timed (CUDA events, median of 20)
    beside its bound, the plain version (median of 3) and the library call
    that computes exactly this function, scaled_dot_product_attention(
    is_causal=True, enable_gqa=True), held to K6's per-(b, h) limit
    against K6."""
    q, k, v, kw = call
    expect(kw["causal"] and kw["window"] is None and not kw["softcap"], kw)
    e = check_k6(q, k, v, True, None, None, f"{cfg.name} prefill layer 0")
    ms = median_ms(lambda: FA.flash_attention(q, k, v))

    def lib():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    agree = bh_rel(lib(), FA.flash_attention(q, k, v))
    expect(agree <= K6_REL_TOL, f"SDPA vs K6 at {cfg.name}: {agree}")
    lib_ms = median_ms(lib)
    plain = median_ms(lambda: R.attention_ref(q, k, v), reps=PLAIN_REPS)
    bound, by, flops, nbytes = k6_bound(q, k, True, None)
    res = {"shape": f"{tuple(q.shape)} kv {tuple(k.shape)}",
           "route": e["route"], "ms": ms, "plain_ms": plain,
           "bound_ms": bound, "bound_by": by, "flops": flops,
           "bytes": nbytes, "library_ms": lib_ms,
           "library_rel_vs_kernel": agree, "max_abs_err": e["max_abs"],
           "rel_err": e["rel"], "lse_abs_err": e["lse_abs"]}
    print(f"time: K6 ({e['route']} route) {cfg.name} prefill layer 0 "
          f"{res['shape']}: {ms:.3f} ms, bound {bound:.3f} ms ({by}: "
          f"{flops:.3e} flops at 989 TFLOP/s), {flops / ms / 1e9:.1f} "
          f"TFLOP/s, plain {plain:.3f} ms (median of {PLAIN_REPS}), library "
          f"scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
          f"{lib_ms:.3f} ms (per-(b, h) rel to K6 {agree:.3e})")
    return res


def phase_nemotron(dev) -> dict:
    """nemotron-4-15b FULL in bfloat16, params from the port's init_params
    on a seeded generator: the 32k prefill, the decode at batch 1 (the main
    path of K8: 32 launches a step) with K8 on two captured layers and its
    times and profile, the plain-attention prefill, the equivalences, the
    batched decode, the Server."""
    cfg = get_config(DENSE_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
    sync(dev)
    print(f"init: {cfg.name}, {cfg.param_count()} params in bfloat16, "
          f"{time.perf_counter() - t0:.3f} s")
    inputs, logits, caches, prefill = phase_prefill(cfg, params, dev)
    k6_calls, k6_share = phase_capture(cfg, params, inputs,
                                       prefill["wall_s"], dev, keep=(0,))
    prefill.update(k6_share)
    k6_times = phase_k6_dense_times(cfg, k6_calls[0])
    del k6_calls
    last = cfg.n_layers - 1
    calls, _ = k8_capture(cfg, params, caches, dev, keep=(0, last))
    captured = k8_on_captured(cfg, calls, f"{cfg.name} decode")
    times = phase_k8_times(*calls[0], f"{cfg.name} decode layer 0, batch 1")
    del calls
    decode = phase_decode(cfg, params, logits, caches, dev)
    profile = phase_profile(cfg, params, inputs, caches, dev, prefill=False)
    del caches, inputs
    torch.cuda.empty_cache()
    plain = dense_prefill_plain(cfg, params, dev)
    equiv = {"bfloat16": prefill_vs_stepwise(cfg, params, dev)}
    torch.cuda.empty_cache()
    batched = phase_batched_decode(cfg, params, dev)
    torch.cuda.empty_cache()
    params = to_float_in_place(params)
    equiv["float32"] = prefill_vs_stepwise(cfg.replace(dtype="float32"),
                                           params, dev)
    del params
    torch.cuda.empty_cache()
    served = phase_serve(("--arch", DENSE_ARCH))
    return {"arch": DENSE_ARCH, "prefill": prefill, "k8_captured": captured,
            "k6_times": k6_times, "k8_times": times, "decode": decode, "profile": profile,
            "prefill_plain": plain, "equivalence": equiv,
            "batched_decode": batched, "serve": served}


def phase_minicpm(dev) -> dict:
    """minicpm-2b FULL in bfloat16 (MHA, head 64): a prefill of
    MINICPM_PREFILL_LEN tokens (40 K6 launches), K8 on a captured decode
    layer, 16 decode steps (40 K8 launches a step), the Server."""
    cfg = get_config(MINICPM_ARCH)
    params = lm.init_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
    inputs, logits, caches, prefill = phase_prefill(cfg, params, dev,
                                                    MINICPM_PREFILL_LEN)
    calls, _ = k8_capture(cfg, params, caches, dev, keep=(0,))
    captured = k8_on_captured(cfg, calls, f"{cfg.name} decode")
    times = phase_k8_times(*calls[0], f"{cfg.name} decode layer 0, batch 1",
                           library=False)
    del calls
    decode = phase_decode(cfg, params, logits, caches, dev)
    del params, caches, inputs
    torch.cuda.empty_cache()
    served = phase_serve(("--arch", MINICPM_ARCH))
    return {"arch": MINICPM_ARCH, "prefill": prefill, "k8_captured": captured,
            "k8_times": times, "decode": decode, "serve": served}


def phase_dense(dev) -> dict:
    """K8's edge cases, then nemotron-4-15b and minicpm-2b."""
    parity = phase_k8_parity_edges(dev)
    torch.cuda.empty_cache()
    nemotron = phase_nemotron(dev)
    torch.cuda.empty_cache()
    minicpm = phase_minicpm(dev)
    print(json.dumps({"dense": {"k8_parity": parity, "nemotron": nemotron,
                                "minicpm": minicpm}}, default=str))
    return {"nemotron": nemotron, "minicpm": minicpm}


# ------------------- the MoE and hybrid families (granite-moe, zamba2, phi)

GRANITE_MOE_ARCH = "granite-moe-3b-a800m"
ZAMBA_ARCH = "zamba2-1.2b"
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
PHI_LAYERS = 8                # of 32: 83.7 GB whole, 21.3 GB at 8 layers
PHI_PREFILL_LEN = 4096
ZAMBA_FORWARD_LEN = 4096      # the K9 form's forward (mamba2_use_ssd=False)


def phase_moe_share(cfg, params, inputs, wall, dev) -> dict:
    """A prefill of the main path's inputs with the MoE layer wrapped: its
    time by CUDA events as a share of the main path's wall, and, outside
    the timed span, the (token, choice) pairs each layer drops at the
    config's capacity (its router and slots run again on the same input)."""
    events, dropped = [], []
    orig = BL.moe

    def wrapped(p, x, cfg_, mesh=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(p, x, cfg_, mesh)
        b.record()
        events.append((a, b))
        _, keep, _ = MOE.dispatch_slots(MOE._route(p, x, cfg_)[1], cfg_)
        dropped.append((~keep).sum())
        return out
    BL.moe = wrapped
    try:
        lm.prefill(params, inputs, cfg)
        sync(dev)
    finally:
        BL.moe = orig
    expect(len(events) == cfg.n_layers, len(events))
    seq = inputs["tokens"].shape[1]
    moe_ms = sum(a.elapsed_time(b) for a, b in events)
    drops = [int(d) for d in dropped]
    pairs = seq * cfg.top_k
    res = {"moe_ms": moe_ms, "moe_share": moe_ms / 1e3 / wall,
           "capacity": MOE.capacity(seq, cfg),
           "dropped_pairs": sum(drops), "pairs": pairs * cfg.n_layers,
           "dropped_by_layer": drops}
    print(f"prefill MoE time: {cfg.name}, {cfg.n_layers} MoE layers taking "
          f"{moe_ms:.1f} ms by CUDA events ({100 * res['moe_share']:.1f}% of "
          f"the main path's wall); dropped {sum(drops)} of "
          f"{pairs * cfg.n_layers} (token, choice) pairs at capacity "
          f"{res['capacity']} a row ({min(drops)}-{max(drops)} a layer of "
          f"{pairs})")
    return res


def moe_model_phase(cfg, dev, seq) -> dict:
    """A MoE config's serving path in bfloat16: the prefill (the main
    path of K6), K6 on captured layer 0 and its times, the MoE share and
    drops, K8 on a captured decode layer and its times, 16 decode steps
    (the main path of K8), the profile of a prefill and of decode steps."""
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
    sync(dev)
    print(f"init: {cfg.name} ({cfg.n_layers} layers), "
          f"{sum(t.numel() for t in T.leaves(params))} params in bfloat16 "
          f"(param_count {cfg.param_count()}: {cfg.n_experts} of "
          f"{cfg.experts_padded} experts), {time.perf_counter() - t0:.3f} s")
    inputs, logits, caches, prefill = phase_prefill(cfg, params, dev, seq)
    k6_calls, k6_share = phase_capture(cfg, params, inputs,
                                       prefill["wall_s"], dev, keep=(0,))
    prefill.update(k6_share)
    k6_times = phase_k6_dense_times(cfg, k6_calls[0])
    del k6_calls
    prefill.update(phase_moe_share(cfg, params, inputs, prefill["wall_s"],
                                   dev))
    calls, _ = k8_capture(cfg, params, caches, dev, keep=(0,))
    captured = k8_on_captured(cfg, calls, f"{cfg.name} decode")
    times = phase_k8_times(*calls[0], f"{cfg.name} decode layer 0, batch 1")
    del calls
    decode = phase_decode(cfg, params, logits, caches, dev)
    profile = phase_profile(cfg, params, inputs, caches, dev)
    del params, caches, inputs
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "prefill": prefill,
            "k6_times": k6_times, "k8_captured": captured, "k8_times": times,
            "decode": decode, "profile": profile}


def k9_ptxas_at(k9_ptx, n) -> dict:
    """K9's ptxas report for the instantiation a state of ``n`` launches
    (``mamba_scan.geometry``'s threads a channel), both dtypes."""
    tpc = MS.geometry(1, 1, 1, n)["tpc"]
    rec = {key: k9_ptx[key] for key in (f"bf16 tpc {tpc}", f"f32 tpc {tpc}")}
    print(f"ptxas K9 at N = {n} (scan_seg_kernel<T, {tpc}>): {rec}")
    return rec


def zamba_k9_forward(cfg, params, dev, k9_ptx, seq=ZAMBA_FORWARD_LEN):
    """``lm.forward_hidden`` + ``logits_fn`` over 1 × ``seq`` tokens with
    ``mamba2_use_ssd=False``: mamba2's head scalars broadcast into K9's
    form, exactly one K9 launch a layer, at N = 64.  Layer 0's scan inputs
    captured: K9 against its plain version (and the mirror of its order of
    sums) and timed beside its bound; K9's ptxas line at N = 64."""
    cfg_k9 = cfg.replace(mamba2_use_ssd=False)
    inputs = lm_inputs(cfg, 1, seq, dev, SEED + 3)
    reset_all_launches()
    t0 = time.perf_counter()
    logits = lm.logits_fn(params, lm.forward_hidden(params, inputs, cfg_k9),
                          cfg_k9)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(MS.LAUNCHES)
    expect(launches == {"mamba_scan": cfg.n_layers, "mamba_scan_bwd": 0},
           launches)
    expect(FA.LAUNCHES["flash_attention"] == attention_layers(cfg),
           dict(FA.LAUNCHES))
    expect(logits.shape == (1, seq, cfg.vocab_padded), logits.shape)
    expect(bool(torch.isfinite(logits).all()), "forward logits not finite")
    print(f"forward: {cfg.name} forward_hidden + logits_fn over 1 x {seq} "
          f"tokens with mamba2_use_ssd=False, {wall:.3f} s, K9 launches "
          f"{launches['mamba_scan']} (N = {cfg.ssm_state})")
    MS.reset_launches()
    with Capture("mamba_scan", keep=(0,)) as cap:
        lm.forward_hidden(params, inputs, cfg_k9)
        sync(dev)
    expect(MS.LAUNCHES["mamba_scan"] == cfg.n_layers, dict(MS.LAUNCHES))
    args = cap.calls[0][0]
    expect(args[2].shape == (cfg.d_inner, cfg.ssm_state), args[2].shape)
    e, _ = check_k9(args, f"{cfg.name} forward layer 0 (N = "
                          f"{cfg.ssm_state})")
    print(f"parity K9 {cfg.name} forward layer 0 x {tuple(args[0].shape)} "
          f"{args[0].dtype} N {args[2].shape[1]}: y max abs err "
          f"{e['max_abs_y']:.3e}, h max abs err {e['max_abs_h']:.3e}, "
          f"per-tile rel err y {e['rel_y']:.3e}, h {e['rel_h']:.3e} (tol "
          f"elementwise {K9_TOL[args[0].dtype]} on y, 1e-4 on h; per tile "
          f"{K9_REL_TOL}); against the mirror of its order of sums per tile "
          f"h {e['mirror_rel_h']:.3e} (limit {K9_MIRROR_REL_TOL})")
    times = phase_k9_times(args)
    del args, cap
    return {"tokens": seq, "wall_s": wall, "launches": launches,
            "k9_parity": e, "k9_times": times,
            "k9_ptxas": k9_ptxas_at(k9_ptx, cfg.ssm_state)}


def phase_zamba2(dev, k9_ptx) -> dict:
    """zamba2-1.2b FULL in bfloat16: the 32k prefill (SSD mamba2, the
    shared block's 6 K6 launches), K6 on a captured application and its
    times, K8 on a captured decode application and its times, 16 decode
    steps (6 K8 launches a step) and their profile, the K9 form's forward
    at N = 64, prefill ≡ stepwise in float32, the Server."""
    cfg = get_config(ZAMBA_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
    sync(dev)
    print(f"init: {cfg.name}, {cfg.param_count()} params in bfloat16, "
          f"{time.perf_counter() - t0:.3f} s; the shared block after "
          f"segments {lm._hybrid_segments(cfg)}")
    inputs, logits, caches, prefill = phase_prefill(cfg, params, dev)
    k6_calls, k6_share = phase_capture(cfg, params, inputs,
                                       prefill["wall_s"], dev, keep=(0,))
    prefill.update(k6_share)
    k6_times = phase_k6_dense_times(cfg, k6_calls[0])
    del k6_calls
    calls, _ = k8_capture(cfg, params, caches, dev, keep=(0,))
    captured = k8_on_captured(cfg, calls, f"{cfg.name} decode")
    times = phase_k8_times(*calls[0], f"{cfg.name} decode application 0, "
                           f"batch 1")
    del calls
    decode = phase_decode(cfg, params, logits, caches, dev)
    profile = phase_profile(cfg, params, inputs, caches, dev)
    del caches, inputs
    torch.cuda.empty_cache()
    forward = zamba_k9_forward(cfg, params, dev, k9_ptx)
    torch.cuda.empty_cache()
    params = to_float_in_place(params)
    equiv = {"float32": prefill_vs_stepwise(cfg.replace(dtype="float32"),
                                            params, dev)}
    del params
    torch.cuda.empty_cache()
    served = phase_serve(("--arch", ZAMBA_ARCH))
    return {"arch": ZAMBA_ARCH, "prefill": prefill, "k6_times": k6_times,
            "k8_captured": captured, "k8_times": times, "decode": decode,
            "profile": profile, "forward_k9": forward, "equivalence": equiv,
            "serve": served}


def phase_moe_hybrid(dev, k9_ptx) -> dict:
    """granite-moe-3b FULL, zamba2-1.2b FULL, phi3.5-moe at full width and
    PHI_LAYERS layers."""
    granite = moe_model_phase(get_config(GRANITE_MOE_ARCH), dev, PREFILL_LEN)
    granite["serve"] = phase_serve(("--arch", GRANITE_MOE_ARCH))
    torch.cuda.empty_cache()
    zamba = phase_zamba2(dev, k9_ptx)
    torch.cuda.empty_cache()
    phi_cfg = get_config(PHI_ARCH).replace(n_layers=PHI_LAYERS)
    print(f"phi3.5-moe: {PHI_LAYERS} of {get_config(PHI_ARCH).n_layers} "
          f"layers at full width ({get_config(PHI_ARCH).param_count()} "
          f"params whole, {phi_cfg.param_count()} at {PHI_LAYERS} layers)")
    phi = moe_model_phase(phi_cfg, dev, PHI_PREFILL_LEN)
    torch.cuda.empty_cache()
    print(json.dumps({"moe_hybrid": {"granite_moe": granite, "zamba2": zamba,
                                     "phi35_moe": phi}}, default=str))
    return {"granite_moe": granite, "zamba2": zamba, "phi35_moe": phi}


# ------------ training the ssm, MoE and hybrid families (K9, K9-bwd, K6, K7)

K9B_SOURCE = "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu"
FM_TRAIN_LAYERS = 32          # of 64: 112 GB of training state whole, 58.2 GB at 32
FM_GRAD_LAYERS = 2            # the plain scan walks time in Python, twice
FM_GRAD_SEQ = 512             # ... a layer in the backward: its comparison's cut
GRANITE_TRAIN_LAYERS = 16     # of 32 (FULL before phase_mesh_train: cut
#                               for its time; it trains granite-moe at 16
#                               layers too)
ZAMBA_K9_SEQ = 1024            # the plain block walks time in Python
# K9-bwd against its plain version from the same chunk states
# (ref.mamba_scan_bwd_plain: the same float32 walk, the sums over states
# and channels in another order), per output ‖got − want‖ ≤ K9B_REL_TOL ·
# ‖want‖, and for dx and ddt of bfloat16 inputs K9B_BF16_TOL (both sides
# round the same float32 value to bfloat16, and a sum a few ulps off a
# rounding tie lands one bfloat16 ulp, 3.9e-3 of the element, away: a
# quarter of that in norm); against autograd of ref.mamba_scan_segmented
# (the gradient of K9's own order of sums, from its own forward)
# K9B_SEG_TOL[dtype] (with bfloat16 inputs autograd rounds dx and ddt at
# other places); against ref.mamba_scan_bwd_segmented (the mirror of
# K9-bwd's own order of sums: its segment folds of h and of the adjoint)
# the limits of the plain version.  Set between the sound readings and the
# planted faults' (PERF.md §6).
K9B_REL_TOL = 1e-5
K9B_BF16_TOL = 1e-3
K9B_SEG_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
K9B_CASES = [  # b, l, di, n, inputs
    # one step; a chunk less one, one chunk, a chunk and one; 4101 steps
    # (a ragged tail) with the decay near 1 and at N = 64; N of 1, 4, 16
    # and 64; channels no multiple of the block's (64 / (N padded / 4));
    # 19 channel tiles (no multiple of the cluster of 8) over 37 steps (L
    # ends mid-segment); batch 3; b and c (and x, dt) as column slices; a
    # large dt; the model's Di
    (2, 1, 37, 16, "plain"), (1, 31, 100, 4, "plain"), (3, 32, 8, 1, "plain"),
    (3, 33, 300, 16, "strided"), (1, 4101, 20, 16, "slow"),
    (1, 4101, 37, 64, "strided"), (2, 300, 100, 64, "strided"),
    (2, 37, 300, 16, "strided"), (2, 70, 5, 4, "fast"),
    (1, 129, 8192, 16, "strided"),
]
K9B_FAULT_CASE = (2, 300, 100, 16)
K9B_FAULTS = {  # a copy of csrc/mamba_scan_bwd.cu with one text changed
    "the adjoint carried across a chunk boundary dropped": (
        "to_array(sm.W[lane], w);",
        "to_array(make_float4(0.f, 0.f, 0.f, 0.f), w);"),
    "exp(dt_t a) where exp(dt_{t+1} a) belongs": (
        "else g[s] = fmaf(e[r + 1][s], g[s], dyc);",
        "else g[s] = fmaf(e[r][s], g[s], dyc);"),
    "db's sum over the clusters without the last cluster": (
        "src = p.db_part + e; n = p.clusters; step = bln; dst = p.db + e;",
        "src = p.db_part + e; n = p.clusters - 1; step = bln; "
        "dst = p.db + e;"),
    "the second segment's w_in dropped": (
        "sm.G[q][lane] = make_float4(w[0], w[1], w[2], w[3]);",
        "sm.G[q][lane] = q == 1 ? make_float4(0.f, 0.f, 0.f, 0.f) : "
        "make_float4(w[0], w[1], w[2], w[3]);"),
    "a chunk walked on the other stage": (
        "const typename S::Stage& cur = sm.stage[k & 1];",
        "const typename S::Stage& cur = sm.stage[(k + 1) & 1];"),
    "rank 0's part left out of the cluster's sum": (
        "float acc = v[0];", "float acc = 0.f;"),
}
K9B_OUTPUTS = ("dx", "ddt", "da", "db", "dc", "dd")


def k9b_inputs(case, dtype, dev, seed):
    """A K9-bwd case: K9's inputs drawn as ``k9_inputs`` (``slow``: dt a
    hundredth, each step's decay near 1; ``fast``: dt 30 times, near 3;
    ``strided``: column slices), and dy ~ N(0, 1) in the inputs' dtype."""
    b, l, di, n, kind = case
    args = list(k9_inputs((b, l, di, n), dtype, dev, seed,
                          strided=kind == "strided"))
    if kind in ("slow", "fast"):
        args[1] = (args[1].float() * (0.01 if kind == "slow" else 30.0)
                   ).to(dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dy = torch.randn((b, l, di), generator=gen, device=dev).to(dtype)
    return tuple(args), dy


def k9b_rels(got, want) -> dict:
    return {k: float((g.float() - w.float()).norm()
                     / max(float(w.float().norm()), 1e-30))
            for k, g, w in zip(K9B_OUTPUTS, got, want)}


def k9b_limits(dtype) -> dict:
    """Each output's limit against the plain version."""
    return {k: K9B_BF16_TOL if dtype == torch.bfloat16 and k in ("dx", "ddt")
            else K9B_REL_TOL for k in K9B_OUTPUTS}


def k9b_over(rels, dtype) -> float:
    """The largest ratio of an output's error to its limit (> 1 fails)."""
    lim = k9b_limits(dtype)
    return max(rels[k] / lim[k] for k in K9B_OUTPUTS)


def check_k9b(args, dy, what) -> dict:
    """K9 with its chunk states (y the same bits as without), then K9-bwd
    against its plain version from those states and against autograd of
    the mirror of K9's order of sums; two launches give the same bits."""
    y, hc = MS.mamba_scan(*args, return_chunks=True)
    expect(torch.equal(y, MS.mamba_scan(*args)),
           f"K9's chunk states change y: {what}")
    _, want_hc = R.mamba_scan_chunks_plain(*args)
    got = MS.mamba_scan_bwd(*args, dy, hc)
    again = MS.mamba_scan_bwd(*args, dy, hc)
    want = R.mamba_scan_bwd_plain(*args, dy, hc)
    mirror = R.mamba_scan_bwd_segmented(*args, dy, hc, MS.CHUNK, MS.SEG_LEN)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    sy, _ = R.mamba_scan_segmented(*leaves, seg_len=MS.SEG_LEN)
    seg = torch.autograd.grad(sy, leaves, dy)
    sync(dy.device)
    x = args[0]
    expect([(g.shape, g.dtype) for g in got] ==
           [(x.shape, x.dtype), (x.shape, x.dtype)]
           + [(t.shape, torch.float32) for t in (args[2], args[3], args[4],
                                                 args[5])], what)
    e = {"vs_plain": k9b_rels(got, want), "vs_segmented": k9b_rels(got, seg),
         "vs_mirror": k9b_rels(got, mirror),
         "same_bits_twice": all(torch.equal(a, b) for a, b in zip(got, again)),
         "h_chunks_rel": float((hc - want_hc).norm() / want_hc.norm()),
         "finite": all(bool(torch.isfinite(g).all()) for g in got)}
    e["max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                           for g, w in zip(got, want))
    e["rel"] = max(e["vs_plain"].values())
    e["over_limit"] = k9b_over(e["vs_plain"], x.dtype)
    e["rel_seg"] = max(e["vs_segmented"].values())
    e["rel_mirror"] = max(e["vs_mirror"].values())
    e["over_limit_mirror"] = k9b_over(e["vs_mirror"], x.dtype)
    MAX_ERR["mamba_scan_bwd"] = max(MAX_ERR["mamba_scan_bwd"],
                                    e["max_abs_err"])
    MAX_REL["mamba_scan_bwd"] = max(MAX_REL["mamba_scan_bwd"], e["rel"])
    MAX_REL["mamba_scan_bwd_seg"] = max(MAX_REL.get("mamba_scan_bwd_seg",
                                                    0.0), e["rel_seg"])
    MAX_REL["mamba_scan_bwd_mirror"] = max(
        MAX_REL.get("mamba_scan_bwd_mirror", 0.0), e["rel_mirror"])
    expect(e["finite"] and e["same_bits_twice"] and e["over_limit"] <= 1
           and e["rel_seg"] <= K9B_SEG_TOL[x.dtype]
           and e["over_limit_mirror"] <= 1,
           f"K9-bwd disagrees with its plain versions ({what}): {e}")
    return e


def bwd_variant(stem, text) -> ctypes.CDLL:
    """``text`` (a variant of csrc/mamba_scan_bwd.cu) built with nvcc into
    build/variants/``stem``.so and loaded with the wrapper's signatures."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{stem}.cu"
    src.write_text(text)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(src.with_suffix(".so")), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"variant {stem} failed to build:\n{r.stderr}")
    lib = ctypes.CDLL(str(src.with_suffix(".so")))
    base = MS._bwd_lib()
    for name in ("roomy_mamba_scan_bwd", "roomy_mamba_scan_bwd_work",
                 "roomy_msb_error_string"):
        getattr(lib, name).argtypes = getattr(base, name).argtypes
        getattr(lib, name).restype = getattr(base, name).restype
    return lib


def k9b_fault_libs() -> dict:
    """Every planted fault of K9-bwd built, one nvcc each, all at once."""
    text = (_build.CSRC / "mamba_scan_bwd.cu").read_text()
    jobs = {}
    for i, (name, (old, new)) in enumerate(K9B_FAULTS.items()):
        if text.count(old) != 1:
            raise SystemExit(f"fault {name!r}: csrc/mamba_scan_bwd.cu no "
                             f"longer holds {old!r} once")
        jobs[name] = (f"mamba_scan_bwd_fault{i}", text.replace(old, new))
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(bwd_variant, *job)
                for name, job in jobs.items()}
        return {name: f.result() for name, f in futs.items()}


@contextlib.contextmanager
def k9b_lib(lib):
    """K9-bwd's wrapper launches ``lib``'s kernels inside the block."""
    good = MS._bwd_lib()
    MS._BWD_LIB = lib
    try:
        yield
    finally:
        MS._BWD_LIB = good


def phase_k9b_parity_edges(dev, libs) -> dict:
    """K9-bwd against its plain versions on the card, every case in
    float32 and bfloat16; then the planted faults at K9B_FAULT_CASE, each
    of which must break the limit against the plain version."""
    out = {}
    for i, case in enumerate(K9B_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            args, dy = k9b_inputs(case, dtype, dev, 60 + i)
            e = check_k9b(args, dy, f"{case} {dtype}")
            out[f"{case} {dtype}"] = e
            print(f"parity K9-bwd {case} {dtype}: per output rel err vs "
                  f"plain {e['rel']:.3e} ({e['over_limit']:.3f} of the limit: "
                  f"{K9B_REL_TOL}, bf16 dx and ddt {K9B_BF16_TOL}), vs autograd "
                  f"of the segmented mirror {e['rel_seg']:.3e} (limit "
                  f"{K9B_SEG_TOL[dtype]}), vs the mirror of its order "
                  f"{e['rel_mirror']:.3e} ({e['over_limit_mirror']:.3f} of "
                  f"the limit), max abs err {e['max_abs_err']:.3e}"
                  f"; chunk states vs the plain forward's {e['h_chunks_rel']:.2e};"
                  f" the same bits twice: {e['same_bits_twice']}")
    faults = {}
    for dtype in (torch.float32, torch.bfloat16):
        args, dy = k9b_inputs((*K9B_FAULT_CASE, "strided"), dtype, dev, 59)
        _, hc = MS.mamba_scan(*args, return_chunks=True)
        want = R.mamba_scan_bwd_plain(*args, dy, hc)
        for name, lib in libs.items():
            with k9b_lib(lib):
                got = MS.mamba_scan_bwd(*args, dy, hc)
            rels = k9b_rels(got, want)
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            over = k9b_over(rels, dtype)
            faults[f"{name}, {dtype}"] = {**rels, "finite": finite,
                                          "over_limit": over}
            print(f"planted K9-bwd fault, {name} ({K9B_FAULT_CASE} {dtype}):"
                  f" {over:.3g} times the limit; per output rel err {rels}")
            expect(finite and over > 1,
                   f"the K9-bwd check misses {name}: {rels}")
    return {"cases": out, "planted_faults": faults}


def k9b_bound(x, a, hc) -> dict:
    """The least time for K9-bwd on these inputs, the largest of: the bytes
    (x, dt, dy, b, c, a, d and the chunk states read once; dx, ddt, da, db,
    dc, dd written once) at 3.35 TB/s; 10 float32 FMAs per (t, i, j) (the
    state's recomputation, the adjoint and the five gradient terms) at
    67 TFLOP/s; one exponential per (t, i, j) at SFU_PER_CLOCK_SM a clock
    on each SM at the card's maximum SM clock."""
    bsz, seq, di = x.shape
    n = a.shape[1]
    es = x.element_size()
    nbytes = (5 * bsz * seq * di + 2 * bsz * seq * n) * es \
        + 4 * hc.numel() + 8 * (di * n + di) + 4 * 2 * bsz * seq * n
    steps = bsz * seq * di * n
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    clock = sm_clock_hz()
    ms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
          "fma": 20 * steps / F32_FLOPS * 1e3,
          "exp": steps / (SFU_PER_CLOCK_SM * sms * clock) * 1e3}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": "bytes" if by == "bytes"
            else "operations", "binds": by, "bytes": nbytes, "exps": steps,
            "fmas": 10 * steps, **{f"bound_{k}_ms": v for k, v in ms.items()}}


def phase_k9b_times(shape, dev, what) -> dict:
    """K9-bwd at a layer's shape (bfloat16, x, dt, b, c as the model's
    column slices): CUDA events, median of 20, beside its bound and its
    plain version (one call after one to warm up: ~2 s each).  No library
    call computes it."""
    args, dy = k9b_inputs((*shape, "strided"), torch.bfloat16, dev, 70)
    _, hc = MS.mamba_scan(*args, return_chunks=True)
    ms = median_ms(lambda: MS.mamba_scan_bwd(*args, dy, hc))
    fwd = median_ms(lambda: MS.mamba_scan(*args, return_chunks=True))
    plain = median_ms(lambda: R.mamba_scan_bwd_plain(*args, dy, hc), reps=1)
    b = k9b_bound(args[0], args[2], hc)
    geo = MS.bwd_geometry(*shape)
    res = {"ms": ms, "plain_ms": plain, **b, "library_ms": None,
           "k9_with_chunks_ms": fwd, "scratch_bytes": geo["part_bytes"],
           "cluster": geo["cluster"], "grid": geo["grid"],
           "shape": f"{what}: x {tuple(args[0].shape)} bf16, N {shape[3]}"}
    print(f"time: K9-bwd {res['shape']}: {ms:.3f} ms, bound "
          f"{b['bound_ms']:.3f} ms ({b['binds']} binds: {b['exps']:.3e} "
          f"exponentials = {b['bound_exp_ms']:.3f} ms; {b['fmas']:.3e} f32 "
          f"FMAs at 67 TFLOP/s = {b['bound_fma_ms']:.3f} ms; {b['bytes']} "
          f"bytes at 3.35 TB/s = {b['bound_bytes_ms']:.3f} ms), "
          f"{b['bound_ms'] / ms:.1%} of the bound; plain {plain:.3f} ms; "
          f"K9 with its chunk states {fwd:.3f} ms;"
          f" scratch {geo['part_bytes']} B (clusters of {geo['cluster']} "
          f"blocks, {geo['clusters']} a batch row, grid {geo['grid']}); "
          f"library: none (no PyTorch call "
          f"computes a selective scan's backward)")
    return res


def train_drops(cfg, params, batch) -> dict:
    """The (token, choice) pairs each MoE layer drops at the config's
    capacity on the train batch: one forward without a gradient, its
    router and slots run again on each layer's input."""
    dropped = []
    orig = BL.moe

    def wrapped(p, x, cfg_, group=None):
        _, keep, _ = MOE.dispatch_slots(MOE._route(p, x, cfg_)[1], cfg_)
        dropped.append(int((~keep).sum()))
        return orig(p, x, cfg_, group)
    BL.moe = wrapped
    try:
        with torch.no_grad():
            lm.forward_hidden(params, batch["inputs"], cfg)
    finally:
        BL.moe = orig
    pairs = TRAIN_SEQ * cfg.top_k
    res = {"capacity": MOE.capacity(TRAIN_SEQ, cfg),
           "dropped_pairs": sum(dropped), "pairs": pairs * cfg.n_layers,
           "dropped_by_layer": dropped}
    print(f"train batch drops: {cfg.name} dropped {sum(dropped)} of "
          f"{pairs * cfg.n_layers} (token, choice) pairs at capacity "
          f"{res['capacity']} a row ({min(dropped)}-{max(dropped)} a layer "
          f"of {pairs})")
    return res


def family_phase(cfg, dev, faults, must_break, grad_cfg=None,
                 grad_seq=TRAIN_SEQ, witness=False):
    """A family's training: the main path, its profile, the drops (MoE),
    and the gradient parity with ``faults`` planted (and ``witness``), at
    ``grad_cfg``'s depth and ``grad_seq`` tokens (default the main
    path's)."""
    params, s, main_path = phase_train(cfg, dev)
    batch = batch_to_torch(make_batch(cfg, s.seed, 0, s.batch, s.seq), dev)
    profile = phase_train_profile(cfg, s, params, batch, dev)
    torch.cuda.empty_cache()
    res = {"arch": cfg.name, "main_path": main_path, "profile": profile}
    if cfg.family == "moe":
        res["drops"] = train_drops(cfg, params, batch)
    if grad_cfg is not None:
        del params, batch
        torch.cuda.empty_cache()
        params = T.tree_map(lambda p: p.requires_grad_(True), lm.init_params(
            grad_cfg, SEED, device=dev, dtype=torch.float32))
        batch = batch_to_torch(make_batch(grad_cfg, 1, 0, 1, grad_seq), dev)
    gcfg = grad_cfg or cfg
    res["grad_parity"] = phase_grad_parity(
        gcfg, params, batch, f"{gcfg.name} {gcfg.n_layers} layers, 1 x "
        f"{grad_seq}", faults=faults, must_break=must_break, witness=witness)
    del params, batch
    torch.cuda.empty_cache()
    return res


def zamba_k9_layer(cfg, dev) -> dict:
    """One full-width zamba2 mamba2 block in the K9 form
    (``mamba2_use_ssd=False``, N = 64) forward and backward under autograd
    on 1 × ZAMBA_K9_SEQ tokens: exactly one K9 and one K9-bwd launch; the
    gradients of the input and the block's params against the same block
    through the plain versions (GRAD_REL_TOL per leaf)."""
    cfg_k9 = cfg.replace(mamba2_use_ssd=False, n_layers=1)
    p = T.tree_map(lambda t: t.requires_grad_(True), lm.init_params(
        cfg_k9, SEED, device=dev, dtype=torch.float32)["blocks"][0])
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x0 = torch.randn((1, ZAMBA_K9_SEQ, cfg.d_model), generator=gen,
                     device=dev).to(getattr(torch, cfg.dtype))
    w = torch.randn((1, ZAMBA_K9_SEQ, cfg.d_model), generator=gen,
                    device=dev)
    grads = {}
    for name, c in (("kernels", cfg_k9), ("plain", cfg_k9.replace(
            kernels="ref"))):
        x = x0.clone().requires_grad_(True)
        reset_all_launches()
        out = BL.mamba_block(p, x, c, version=2)
        leaves = [x] + T.leaves(p)
        grads[name] = torch.autograd.grad((out.float() * w).sum(), leaves)
        sync(dev)
        launches = dict(MS.LAUNCHES)
        expect(launches == ({"mamba_scan": 1, "mamba_scan_bwd": 1}
                            if name == "kernels" else
                            {"mamba_scan": 0, "mamba_scan_bwd": 0}), launches)
    rels = {path: float((g - wnt).float().norm() / wnt.float().norm())
            for path, g, wnt in zip(["x"] + ["__".join(q) for q, _ in
                                             T.flatten_with_path(p)],
                                    grads["kernels"], grads["plain"])}
    worst = max(rels, key=rels.get)
    print(f"grad parity: {cfg.name} one mamba2 block in the K9 form (N = "
          f"{cfg.ssm_state}), 1 x {ZAMBA_K9_SEQ}, kernels vs plain: per-leaf "
          f"rel max {rels[worst]:.4e} ({worst}) (limit {GRAD_REL_TOL}); K9 1, "
          f"K9-bwd 1 launch")
    expect(rels[worst] <= GRAD_REL_TOL, rels)
    return {"per_leaf_rel": rels, "max_rel": rels[worst], "worst_leaf": worst}


def phase_training_families(dev, k9b_ptx, libs) -> dict:
    """K9-bwd on its edge cases and its planted faults (``libs``, from
    ``k9b_fault_libs``), its times at falcon-mamba's and zamba2's layers;
    then falcon-mamba-7b at FM_TRAIN_LAYERS layers, zamba2-1.2b FULL (the
    SSD form, and one block in the K9 form) and granite-moe-3b at
    GRANITE_TRAIN_LAYERS trained."""
    t0 = time.perf_counter()
    parity = phase_k9b_parity_edges(dev, libs)
    print(f"[K9-bwd parity done at {time.perf_counter() - t0:.1f} s of the "
          f"phase]")
    fm_cfg = get_config(FM_ARCH)
    times = phase_k9b_times((1, TRAIN_SEQ, fm_cfg.d_inner, fm_cfg.ssm_state),
                            dev, "falcon-mamba-7b train layer")
    zcfg = get_config(ZAMBA_ARCH)
    ztimes = phase_k9b_times((1, TRAIN_SEQ, zcfg.d_inner, zcfg.ssm_state),
                             dev, "zamba2-1.2b K9-form layer")
    torch.cuda.empty_cache()
    fm_train = fm_cfg.replace(n_layers=FM_TRAIN_LAYERS)
    print(f"falcon-mamba-7b training: {FM_TRAIN_LAYERS} of {fm_cfg.n_layers} "
          f"layers at full width ({16 * fm_cfg.param_count()} B of state "
          f"whole; the gradient parity at {FM_GRAD_LAYERS} layers, 1 x "
          f"{FM_GRAD_SEQ})")
    k9b_faults = {f"K9-bwd in every layer: {name}":
                  (lambda lib=lib: k9b_lib(lib)) for name, lib in libs.items()}
    fm = family_phase(
        fm_train, dev, k9b_faults, ("K9-bwd in every layer: the adjoint "
                                    "carried across a chunk boundary "
                                    "dropped",),
        grad_cfg=fm_cfg.replace(n_layers=FM_GRAD_LAYERS),
        grad_seq=FM_GRAD_SEQ)
    print(f"[falcon-mamba training done at {time.perf_counter() - t0:.1f} s "
          f"of the phase]")
    drop_d = "every layer's backward without D = rowsum(dO o O)"
    k7_fault = {drop_d: bwd_window_faults()[drop_d]}
    zamba = family_phase(zcfg, dev, k7_fault, (drop_d,), witness=True)
    zamba["k9_form_layer"] = zamba_k9_layer(zcfg, dev)
    print(f"[zamba2 training done at {time.perf_counter() - t0:.1f} s of the "
          f"phase]")
    torch.cuda.empty_cache()
    gcfg = get_config(GRANITE_MOE_ARCH)
    if GRANITE_TRAIN_LAYERS:
        gcfg = gcfg.replace(n_layers=GRANITE_TRAIN_LAYERS)
    granite = family_phase(gcfg, dev, k7_fault, (drop_d,), witness=True)
    res = {"k9_bwd_parity": parity, "k9_bwd_times": times,
           "k9_bwd_times_zamba2": ztimes, "k9_bwd_ptxas": k9b_ptx,
           "falcon_mamba": fm, "zamba2": zamba, "granite_moe": granite}
    print(json.dumps({"train_families": res}, default=str))
    return res


# ------------ the frontend-stub families (musicgen-medium, qwen2-vl-2b)

FRONTEND_ARCHS = ("musicgen-medium", "qwen2-vl-2b")
FRONTEND_PLAIN_LEN = 2048     # the plain attention's prefill (as DENSE_PLAIN_LEN)
MROPE_PREFIX = 512            # text tokens before qwen's patch grid
MROPE_GRID = 64               # ... of 64 x 64 patches
MROPE_WRONG_SECTIONS = (24, 24, 16)   # a planted band-to-stream split
FRONTEND_PLAIN_DECODE = 4     # decode steps held to the plain path
CORPUS_BATCH = 256            # train_4k's global batch: 256 x 4097 tokens a chunk
CORPUS_STEPS = 6


def grid_positions(b, prefix, grid, dev) -> torch.Tensor:
    """(b, prefix + grid², 3) M-RoPE positions of a text prefix (one
    position in every stream) then a grid × grid patch grid, as qwen2-vl
    lays out an image after text: temporal position ``prefix`` for every
    patch, height prefix + i // grid, width prefix + i % grid."""
    text = torch.arange(prefix, device=dev)[:, None].expand(prefix, 3)
    i = torch.arange(grid * grid, device=dev)
    patch = torch.stack([torch.full_like(i, prefix), prefix + i // grid,
                         prefix + i % grid], dim=1)
    return torch.cat([text, patch])[None].expand(b, -1, -1)


def mrope_prefill(cfg, params, dev) -> dict:
    """qwen2-vl's prefill over a text prefix and a 64 × 64 patch grid,
    whose three position streams differ (text positions repeat one value
    in all three, and there M-RoPE equals RoPE): K6 launched once a layer,
    all wgmma; the last logits held to the plain attention's prefill on
    the same positions by the per-row rule.  Two readings must break the
    rule: the same inputs at text positions (the streams matter) and the
    kernels' prefill with the bands split across the streams the other way
    round (``MROPE_WRONG_SECTIONS``)."""
    seq = MROPE_PREFIX + MROPE_GRID ** 2
    rng = np.random.default_rng(SEED + 9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, seq))).to(dev)
    pos = grid_positions(1, MROPE_PREFIX, MROPE_GRID, dev)
    expect(bool((pos[..., 1] != pos[..., 2]).any()), "streams equal")
    inputs = {**token_inputs(cfg, toks), "positions": pos}
    reset_all_launches()
    logits, _ = lm.prefill(params, inputs, cfg)
    sync(dev)
    expect(dict(FA.ROUTE_LAUNCHES) == {"wgmma": cfg.n_layers, "classic": 0},
           dict(FA.ROUTE_LAUNCHES))
    ref_logits, _ = lm.prefill(params, inputs, cfg.replace(kernels="ref"))
    v = cfg.vocab_size
    ref_logits = ref_logits[..., :v]
    errs = logits_agree(logits[..., :v], ref_logits,
                        f"{cfg.name} prefill over {MROPE_PREFIX} text tokens "
                        f"and a {MROPE_GRID} x {MROPE_GRID} patch grid "
                        f"(M-RoPE streams differ), K6 vs plain attention")
    text, _ = lm.prefill(params, {**inputs, "positions": text_positions(
        cfg, 1, seq, dev)}, cfg)
    wrong, _ = lm.prefill(params, inputs, cfg.replace(
        mrope_sections=MROPE_WRONG_SECTIONS))
    controls = {
        "the same inputs at text positions": logit_errors(
            text[..., :v], ref_logits, "control, text positions, vs the "
            "grid's plain prefill"),
        f"the bands split {MROPE_WRONG_SECTIONS}": logit_errors(
            wrong[..., :v], ref_logits, f"planted fault, M-RoPE sections "
            f"{MROPE_WRONG_SECTIONS}, vs plain")}
    for name, e in controls.items():
        expect(not e["ok"], f"the logits check misses {name}: {e}")
    return {"tokens": seq, "logits_vs_plain": errs, "controls": controls}


def decode_vs_plain(cfg, params, logits, caches, dev,
                    steps=FRONTEND_PLAIN_DECODE) -> dict:
    """``steps`` greedy decode steps from the prefill's caches through K8
    and, fed the same tokens, through the plain paged decode: each step's
    logits held by the per-row rule."""
    tok = logits[:, -1].argmax(-1, keepdim=True)
    ck, cr, worst = caches, caches, None
    v = cfg.vocab_size
    for i in range(steps):
        lk, ck = lm.decode_step(params, step_inputs(cfg, tok), ck, cfg)
        lr, cr = lm.decode_step(params, step_inputs(cfg, tok), cr,
                                cfg.replace(kernels="ref"))
        e = logits_agree(lk[..., :v], lr[..., :v], f"{cfg.name} decode step "
                         f"{i} K8 vs the plain paged decode")
        worst = e if worst is None or e["rel_err"] > worst["rel_err"] else \
            worst
        tok = lk[:, -1].argmax(-1, keepdim=True)
    return worst


def frontend_train_layout(cfg, dev) -> dict:
    """K6-with-LSE and K7 at the family's train layout (1 × Hq × 4096 × D,
    Hkv kv heads, causal, as the model hands them over: strided views):
    both held to their plain versions (``check_k6``, ``run_k7``), on the
    wgmma route, and timed beside their bounds, their plain versions
    (median of 3) and the library call that computes the same function,
    scaled_dot_product_attention(is_causal=True, enable_gqa=True): its
    forward (which returns no LSE) and its backward alone."""
    case = (1, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
            cfg.head_dim, True, None, None)
    q, k, v, do = k7_inputs(case, torch.bfloat16, dev, 11, True)
    e6 = check_k6(q, k, v, True, None, None, f"{cfg.name} train layout")
    e7 = run_k7(q, k, v, do, dict(causal=True, window=None, softcap=None))
    MAX_ERR["flash_attention_bwd"] = max(MAX_ERR["flash_attention_bwd"],
                                         e7["max_abs"])
    MAX_REL["flash_attention_bwd"] = max(MAX_REL["flash_attention_bwd"],
                                         e7["rel"])
    expect(e7["ok"], f"K7 at {cfg.name}'s layout: {e7}")
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    expect(FAB.route(q, k, v, o, do) == "wgmma", "K7's route")
    ms = median_ms(lambda: FAB.flash_attention_bwd(q, k, v, o, lse, do))
    plain = median_ms(lambda: R.flash_attention_bwd_ref(q, k, v, o, lse, do),
                      reps=PLAIN_REPS)
    bound, by, flops, nbytes = bwd_bound(q, k, True, None)
    lib = sdpa_bwd_ms(q, k, v, do)
    fms = median_ms(lambda: FA.flash_attention(q, k, v, return_lse=True))
    fplain = median_ms(lambda: R.attention_lse_ref(q, k, v),
                       reps=PLAIN_REPS)
    _, _, fflops, fbytes = k6_bound(q, k, True, None)
    fbytes += 4 * q.shape[0] * q.shape[1] * q.shape[2]     # lse written
    ft_ops, ft_bytes = fflops / BF16_FLOPS, fbytes / HBM_BYTES_PER_S
    with torch.no_grad():
        flib = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    shape = f"{tuple(q.shape)} kv {tuple(k.shape)}, causal"
    res = {"shape": shape,
           "bwd": {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                   "bound_by": by, "flops": flops, "bytes": nbytes,
                   "library_ms": lib, "rel_err": e7["rel"],
                   "max_abs_err": e7["max_abs"]},
           "fwd_lse": {"ms": fms, "plain_ms": fplain,
                       "bound_ms": max(ft_ops, ft_bytes) * 1e3,
                       "bound_by": "operations" if ft_ops >= ft_bytes
                       else "bytes", "flops": fflops, "bytes": fbytes,
                       "library_ms": flib, "rel_err": e6["rel"],
                       "lse_abs_err": e6["lse_abs"]}}
    print(f"time: K7 at {cfg.name}'s train layout {shape} (wgmma route): "
          f"{ms:.3f} ms, bound {bound:.3f} ms ({by}), {k7_rates(ms, flops)}, "
          f"plain {plain:.3f} ms, library scaled_dot_product_attention "
          f"backward {lib:.3f} ms; per-(b, h) rel err {e7['rel']:.3e}; K6 "
          f"with LSE {fms:.3f} ms, bound {res['fwd_lse']['bound_ms']:.3f} "
          f"ms, plain {fplain:.3f} ms, library forward (no LSE) "
          f"{flib:.3f} ms; LSE max abs err {e6['lse_abs']:.3e}")
    del q, k, v, do, o, lse
    return res


def frontend_serving(cfg, dev) -> dict:
    """One frontend-stub family served in bfloat16 at full width and depth,
    params from ``lm.init_params`` on a seeded generator, every input the
    codebook rows of seeded token ids: the 1 × 32768 prefill (the main
    path of K6), K6 on captured layer 0 and its times, the plain-attention
    prefill at FRONTEND_PLAIN_LEN with planted faults, qwen's M-RoPE grid
    prefill, K8 on a captured decode layer and its times, 16 decode steps
    (the main path of K8), decode held to the plain path, the profile."""
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
    sync(dev)
    print(f"init: {cfg.name}, {cfg.param_count()} params in bfloat16, "
          f"{time.perf_counter() - t0:.3f} s; inputs are codebook rows "
          f"({cfg.vocab_size} x {cfg.d_model})"
          + (f", M-RoPE sections {cfg.mrope_sections}" if cfg.mrope else ""))
    with served_codebook(cfg, dev):
        res = frontend_served(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    return res


def frontend_served(cfg, params, dev) -> dict:
    """``frontend_serving``'s phases, with the codebook on the card."""
    inputs, logits, caches, prefill = phase_prefill(cfg, params, dev)
    k6_calls, k6_share = phase_capture(cfg, params, inputs,
                                       prefill["wall_s"], dev, keep=(0,))
    prefill.update(k6_share)
    k6_times = phase_k6_dense_times(cfg, k6_calls[0])
    del k6_calls
    plain = dense_prefill_plain(cfg, params, dev, FRONTEND_PLAIN_LEN)
    mrope = mrope_prefill(cfg, params, dev) if cfg.mrope else None
    calls, _ = k8_capture(cfg, params, caches, dev, keep=(0,))
    captured = k8_on_captured(cfg, calls, f"{cfg.name} decode")
    times = phase_k8_times(*calls[0], f"{cfg.name} decode layer 0, batch 1")
    del calls
    decode = phase_decode(cfg, params, logits, caches, dev)
    decode["vs_plain_worst"] = decode_vs_plain(cfg, params, logits, caches,
                                               dev)
    profile = phase_profile(cfg, params, inputs, caches, dev)
    del caches, inputs, logits
    return {"arch": cfg.name, "prefill": prefill, "k6_times": k6_times,
            "prefill_plain": plain, "mrope_grid": mrope,
            "k8_captured": captured, "k8_times": times, "decode": decode,
            "profile": profile}


def phase_disk_corpus(cfg) -> dict:
    """``DiskTokenStream`` on the host: ``write_corpus`` of CORPUS_STEPS
    chunks of train_4k's real batch (256 × 4097 uint32 tokens each) into a
    temporary directory, read back through the stream, every batch bit for
    bit against ``synth_tokens`` (one more read wraps to chunk 0)."""
    nb = CORPUS_BATCH * (TRAIN_SEQ + 1) * 4 * CORPUS_STEPS
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        DiskTokenStream.write_corpus(d, cfg, CORPUS_BATCH, TRAIN_SEQ,
                                     CORPUS_STEPS, seed=SEED)
        wt = time.perf_counter() - t0
        stream = DiskTokenStream(d, cfg, CORPUS_BATCH, TRAIN_SEQ)
        t0 = time.perf_counter()
        batches = [next(stream) for _ in range(CORPUS_STEPS + 1)]
        rt = time.perf_counter() - t0
        stored = sum(os.path.getsize(os.path.join(d, fn))
                     for fn in os.listdir(d))
    for step, b in enumerate(batches):
        toks = synth_tokens(SEED, step % CORPUS_STEPS, CORPUS_BATCH,
                            TRAIN_SEQ + 1, cfg.vocab_size)
        expect(np.array_equal(b["inputs"]["tokens"], toks[:, :TRAIN_SEQ])
               and np.array_equal(b["labels"], toks[:, 1:]),
               f"DiskTokenStream batch {step} differs from synth_tokens")
    res = {"chunks": CORPUS_STEPS, "token_bytes": nb, "stored_bytes": stored,
           "write_s": wt, "write_mb_per_s": nb / wt / 1e6,
           "read_s": rt, "read_batches": CORPUS_STEPS + 1,
           "read_mb_per_s": nb * (CORPUS_STEPS + 1) / CORPUS_STEPS / rt / 1e6}
    print(f"disk corpus: DiskTokenStream over a ChunkStore of "
          f"{CORPUS_STEPS} chunks of {CORPUS_BATCH} x {TRAIN_SEQ + 1} uint32 "
          f"tokens ({nb} bytes, {stored} on disk with the manifest and .npy "
          f"headers): write_corpus {wt:.3f} s ({res['write_mb_per_s']:.1f} "
          f"MB/s, token synthesis included), {CORPUS_STEPS + 1} batches read "
          f"in {rt:.3f} s ({res['read_mb_per_s']:.1f} MB/s), every batch "
          f"== synth_tokens bit for bit")
    return res


def phase_frontend(dev) -> dict:
    """musicgen-medium and qwen2-vl-2b FULL: served (``frontend_serving``)
    and trained (the main path through ``runtime.train_loop.train``, the
    profile, the gradient parity with K7's drop-D fault, and K6-with-LSE
    and K7 at the train layout); then the disk corpus."""
    drop_d = "every layer's backward without D = rowsum(dO o O)"
    k7_fault = {drop_d: bwd_window_faults()[drop_d]}
    out = {}
    for arch in FRONTEND_ARCHS:
        cfg = get_config(arch)
        served = frontend_serving(cfg, dev)
        torch.cuda.empty_cache()
        trained = family_phase(cfg, dev, k7_fault, (drop_d,), witness=True)
        trained["train_layout"] = frontend_train_layout(cfg, dev)
        torch.cuda.empty_cache()
        out[arch] = {"serve": served, "train": trained}
    out["disk_corpus"] = phase_disk_corpus(get_config(FRONTEND_ARCHS[1]))
    print(json.dumps({"frontend": out}, default=str))
    return out


# ------------------------------------------------------------- Tier D

DISK_N = 11                   # 39,916,800 states, 9,979,200 packed bytes
DISK_SIDE_N = 10              # the unfused and the stopped-and-resumed runs
#                               (11 before phase_mesh_train: cut for its
#                               time; n = 11's op log is 6.4 GB a run)
DISK_CHUNK = 1 << 20          # 39 chunks of 65,536 words (the last 4,432)
DISK_STOP = 6                 # the stopped run's last level
DISK_CKPT_EVERY = 3           # its checkpoints: levels 0, 3, 6
DISK_SMALL = (8, 1000)        # n, chunk_elems: every chunk ends inside a word
DISK_SORTED_N = 9             # the sorted disk BFS on the host (10, 22 s,
#                               until PR 30: cut for phase_mesh's time)
DISK_LOG_REC = 16             # bytes of an (idx, val) int64 op-log record


def disk_expected(n, ce, dev, batch=1 << 20):
    """Level sizes and, for each level d, the marks its expansion sends to
    each chunk (``marks[d][c]``), from a plain distance table on the card
    (int8 levels), independent of the disk engine: pass d + 1 reads chunk
    c's log of ``marks[d][c]`` records."""
    total = math.factorial(n)
    gen = P.neighbors(n)
    n_chunks = -(-total // ce)
    dist = torch.full((total,), -1, dtype=torch.int8, device=dev)
    dist[P.start_rank(n)] = 0
    sizes, marks = [], []
    for d in itertools.count():
        states = torch.nonzero(dist == d).flatten()
        if not states.numel():
            break
        sizes.append(states.numel())
        per = torch.zeros(n_chunks, dtype=torch.int64, device=dev)
        for lo in range(0, states.numel(), batch):
            nb = gen(states[lo:lo + batch]).reshape(-1)
            per += torch.bincount(nb // ce, minlength=n_chunks)
            dist[nb[dist[nb] < 0]] = d + 1
        marks.append(per.tolist())
    del dist
    return sizes, marks


def disk_chunk_words(total, ce) -> list:
    return [-(-min(ce, total - c * ce) // 16) for c in range(-(-total // ce))]


def disk_routes(total, ce, marks, fused) -> dict:
    """K1's (fused: every chunk of every level pass) or K2's (unfused: the
    chunks with a log) launches by the route ``K.route`` names."""
    out = {p: 0 for p in K.ROUTE_LAUNCHES}
    words = disk_chunk_words(total, ce)
    for per in marks:
        for w, m in zip(words, per):
            if fused or m:
                out[K.route(w, m)] += 1
    return out


@contextlib.contextmanager
def disk_timers():
    """CUDA-event times of every K1 / K2 / K3 launch, host seconds of the
    op-log spills and reads, and the ``pass.rw`` / ``pass.read`` spans, of
    the block; every wrapper is put back after it."""
    got = {"k1": [], "k2": [], "k3": [], "log_write_s": 0.0,
           "log_read_s": 0.0, "spans": []}
    wrapped = {"bitpack_mark_rotate_count": "k1",
               "bitpack_scatter_mark": "k2", "bitpack_lut_count": "k3"}
    orig = {name: getattr(K, name) for name in wrapped}

    def timed(name):
        fn = orig[name]

        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            got[wrapped[name]].append(ev)
            return out
        return run

    flush, read = TDB.DiskBitArray._flush_logs, TDB.DiskBitArray._read_log

    def flush_t(self):
        t0 = time.perf_counter()
        flush(self)
        got["log_write_s"] += time.perf_counter() - t0

    def read_t(path):
        t0 = time.perf_counter()
        out = read(path)
        got["log_read_s"] += time.perf_counter() - t0
        return out

    for name in wrapped:
        setattr(K, name, timed(name))
    TDB.DiskBitArray._flush_logs = flush_t
    TDB.DiskBitArray._read_log = staticmethod(read_t)
    obs.enable(sink=got["spans"].append)
    try:
        yield got
    finally:
        obs.disable()
        for name, fn in orig.items():
            setattr(K, name, fn)
        TDB.DiskBitArray._flush_logs = flush
        TDB.DiskBitArray._read_log = staticmethod(read)
        torch.cuda.synchronize()
        for key in ("k1", "k2", "k3"):
            got[f"{key}_ms"] = sum(s.elapsed_time(e) for s, e in got[key])
            got[key] = len(got[key])
        got["pass_s"] = sum(s["dur_us"] for s in got.pop("spans")
                            if s["sid"] in ("pass.rw", "pass.read")) / 1e6


def disk_drive(dev, n=DISK_N, **kw) -> dict:
    """One run of ``apps.pancake_bits.run_disk`` (the user's entry point)
    at ``n``, every launch and Tier D count set to 0 just before it and
    read just after, with its timers and peak device memory."""
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    K.reset_launches()
    TDB.reset_stats()
    TDX.reset_stats()
    TDC.reset_stats()
    with disk_timers() as tm:
        sizes, secs = P.run_disk(n, DISK_CHUNK, device=dev, **kw)
    sync(dev)
    bits = dict(TDB.STATS)
    return {"sizes": sizes, "wall_s": secs,
            "states_per_s": math.factorial(n) / secs,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "base_bytes": base, "launches": dict(K.LAUNCHES),
            "routes": dict(K.ROUTE_LAUNCHES), "bits": bits,
            "array_read": bits["bytes_read"] - bits["log_bytes_read"],
            "array_written": bits["bytes_written"]
            - bits["log_bytes_written"],
            "ledger": {k: TDX.STATS[k] for k in
                       ("rw_passes", "read_passes", "piggybacked_stages",
                        "ckpt_snapshots", "ckpt_restores", "io_retries")},
            "times": tm}


def disk_line(what, r) -> None:
    t, b = r["times"], r["bits"]
    print(f"disk tier: {what}: {r['wall_s']:.3f} s wall, "
          f"{r['states_per_s']:.0f} states/s, peak {r['peak_bytes']} B; "
          f"array {r['array_read']} B read, {r['array_written']} B written; "
          f"op log {b['log_bytes_written']} B written, "
          f"{b['log_bytes_read']} B read; pass.rw/read {t['pass_s']:.3f} s, "
          f"K1 {t['k1']} launches {t['k1_ms']:.3f} ms, K2 {t['k2']} "
          f"{t['k2_ms']:.3f} ms, K3 {t['k3']} {t['k3_ms']:.3f} ms, log "
          f"writes {t['log_write_s']:.3f} s, log reads "
          f"{t['log_read_s']:.3f} s; launches by route {r['routes']}")


def tree(path) -> dict:
    out = {}
    for root, _, names in os.walk(path):
        for fn in names:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def disk_small_on_card(dev) -> None:
    """Pancake n = 8 in chunks of 1,000 fields (250 bytes: every chunk
    ends inside a word), fused and unfused, on the card and on the CPU
    (the kernels' plain versions): the workdirs the same bytes after the
    search, the counters equal."""
    n, ce = DISK_SMALL
    total = math.factorial(n)
    for fused in (True, False):
        out = {}
        with tempfile.TemporaryDirectory() as wd:
            for where in (dev, "cpu"):
                TDB.reset_stats()
                K.reset_launches()
                sizes, bits = TDD.implicit_bfs(
                    os.path.join(wd, str(where)), total, [P.start_rank(n)],
                    P.neighbors(n), chunk_elems=ce, log_buf_rows=1 << 12,
                    fused=fused, device=where)
                out[str(where)] = (sizes, tree(bits.path), dict(TDB.STATS),
                                   dict(K.LAUNCHES))
        (s_d, t_d, st_d, l_d), (s_c, t_c, st_c, l_c) = out.values()
        expect(s_d == s_c and sum(s_d) == total, (s_d, s_c))
        expect(t_d == t_c, f"n={n} chunks of {ce}: the card's workdir "
                           f"differs from the CPU's (fused={fused})")
        expect(st_d == st_c, (st_d, st_c))
        passes = len(s_d) * (-(-total // ce))
        want = ({"mark_rotate_count": passes} if fused else
                {"lut_count": passes})
        expect(all(l_d[k] == v for k, v in want.items())
               and not any(l_c.values()), (l_d, l_c))
    print(f"disk tier: n={n} in chunks of {ce} fields (each ending inside "
          "a word), fused and unfused: the card's workdir == the CPU's, "
          "byte for byte, counters equal")


def snapshot_chunk(snap, c) -> np.ndarray:
    """Chunk ``c``'s bytes in an implicit-engine snapshot, either format."""
    bits = os.path.join(snap, "bits")
    rmz = os.path.join(bits, f"b{c:06d}.rmz")
    if os.path.exists(rmz):
        with open(rmz, "rb") as f:
            return TDC.decode_rle2(f.read(), tag="bits")
    return np.load(os.path.join(bits, f"b{c:06d}.npy"))


def disk_chunk_routes(snap, total, ce, dev) -> int:
    """K1 and K2 on real chunks of the stopped run's level-6 snapshot (the
    chunk with the largest log, a chunk with none if any, the last chunk)
    on both routes, out of place and in place, against their plain
    versions; K1's count taken over the chunk's own fields.  Returns the
    largest log's records."""
    bits = os.path.join(snap, "bits")
    n_chunks = -(-total // ce)
    logs = {c: os.path.join(bits, f"log{c:06d}.bin") for c in range(n_chunks)}
    size = {c: os.path.getsize(p) // DISK_LOG_REC if os.path.exists(p) else 0
            for c, p in logs.items()}
    big = max(size, key=size.get)
    picks = [big, n_chunks - 1] + [c for c in size if not size[c]][:1]
    for c in dict.fromkeys(picks):
        rows = min(ce, total - c * ce)
        words = TDB.bytes_to_words(snapshot_chunk(snap, c), dev)
        rec = (np.fromfile(logs[c], np.int64).reshape(-1, 2) if size[c]
               else np.zeros((0, 2), np.int64))
        idx = torch.from_numpy(rec[:, 0] - c * ce).to(dev).to(torch.int32)
        want, wc = R.bitpack_mark_rotate_count_ref(words, idx, ROTATE,
                                                   BA.CUR, BA.NEXT, BA.UNSEEN)
        got, gc = BA.mark_rotate_count(words, idx, rows)
        check("mark_rotate_count", got, want, gc, wc, f"disk chunk {c}")
        for path in K12_ROUTES:
            out = torch.empty_like(words)
            gc = K._mark(words, idx, out, BA.NEXT, BA.UNSEEN, ROTATE, BA.CUR,
                         path=path)
            check("mark_rotate_count", out, want, gc, wc,
                  f"disk chunk {c} {path}")
            work = words.clone()
            K._mark(work, idx, work, BA.NEXT, BA.UNSEEN, path=path)
            check("scatter_mark", work,
                  R.bitpack_scatter_mark_ref(words, idx, BA.NEXT, BA.UNSEEN),
                  what=f"disk chunk {c} {path} inplace")
        unpacked = BA.unpack_values(want)
        expect(int(gc) == int((unpacked[:rows] == BA.CUR).sum())
               and not bool(unpacked[rows:].any()),
               f"disk chunk {c}: K1's count or padding")
    return size[big]


def disk_plain_pass(ck, n, ce, dev) -> None:
    """Level 7's pass from the level-6 checkpoint, through the kernels and
    through their plain versions on the card (``impl="ref"``): the same
    chunk bytes, the same op logs of level 8's marks, the same count."""
    out = {}
    with tempfile.TemporaryDirectory() as wd:
        for impl in ("auto", "ref"):
            ck_i = os.path.join(wd, f"ck_{impl}")
            shutil.copytree(ck, ck_i)
            sizes, bits = TDD.implicit_bfs(
                os.path.join(wd, impl), math.factorial(n),
                [P.start_rank(n)], P.neighbors(n), chunk_elems=ce,
                max_levels=DISK_STOP + 1, impl=impl, device=dev,
                checkpoint=TDCF.CheckpointConfig(dir=ck_i, resume=True))
            bits._flush_logs()
            out[impl] = (sizes, tree(bits.path))
    expect(out["auto"][0] == out["ref"][0]
           and len(out["auto"][0]) == DISK_STOP + 2, out["auto"][0])
    expect(out["auto"][1] == out["ref"][1],
           "level 7's pass through the kernels != through the plain versions")
    print(f"disk tier: level {DISK_STOP + 1}'s pass from the level-"
          f"{DISK_STOP} checkpoint through the kernels == through their "
          f"plain versions on the card ({len(out['ref'][1])} files, "
          "chunks and logs, byte for byte)")


def disk_batch_peak(n, ce, dev) -> int:
    """Device bytes one expansion batch (``expand_batch`` states through
    ``gen_neighbors`` and ``DiskBitArray.update``'s binning) adds."""
    total = math.factorial(n)
    with tempfile.TemporaryDirectory() as wd:
        bits = TDB.DiskBitArray(wd, total, chunk_elems=ce, device=dev,
                                log_buf_rows=1 << 40, init_chunks=False)
        idx = torch.arange(1 << 16, device=dev) * (total // (1 << 16))
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        nb = P.neighbors(n)(idx).reshape(-1)
        bits.update(nb, torch.full(nb.shape, BA.NEXT, dtype=torch.uint8,
                                   device=dev))
        del nb
        sync(dev)
        return torch.cuda.max_memory_allocated(dev) - base


def phase_disk_tier(dev) -> dict:
    """Tier D's implicit BFS at pancake n = 11 (fused, K1) and
    DISK_SIDE_N (unfused, K2 + K3; rle2 chunks stopped and resumed), each
    chunk pass on the card, held to the in-memory engine; the sorted disk
    BFS at DISK_SORTED_N on the host; the tour and the set operations."""
    n, ce = DISK_N, DISK_CHUNK
    total = math.factorial(n)
    n_chunks = -(-total // ce)
    tmp = tempfile.gettempdir()
    du = shutil.disk_usage(tmp)
    print(f"disk tier: {tmp} holds {du.free} B free of {du.total}")
    disk_small_on_card(dev)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sizes_mem, _ = C.implicit_bfs(total, [P.start_rank(n)], P.neighbors(n),
                                  device=dev)
    sync(dev)
    mem_secs = time.perf_counter() - t0
    mem_peak = torch.cuda.max_memory_allocated(dev)
    sizes_d, marks = disk_expected(n, ce, dev)
    expect(sizes_mem == sizes_d and len(sizes_mem) - 1 == 13
           and sum(sizes_mem) == total, (sizes_mem, sizes_d))
    levels = len(sizes_mem)
    n_marks = sum(map(sum, marks))
    expect(n_marks == (n - 1) * total, n_marks)
    m_max = max(map(max, marks))
    k2_want = sum(m > 0 for per in marks for m in per)
    print(f"disk tier: in-memory engine n={n} {mem_secs:.3f} s, peak "
          f"{mem_peak} B; {n_marks} marks over the search "
          f"({n_marks * DISK_LOG_REC} B of op log), at most {m_max} in one "
          f"chunk's log; {k2_want} (chunk, pass) pairs with a log")

    fused = disk_drive(dev)
    disk_line("fused", fused)
    seed_chunk = P.start_rank(n) // ce
    seed_bytes = -(-min(ce, total - seed_chunk * ce) // 4)
    nbytes = -(-total // 4)
    batch_b = disk_batch_peak(n, ce, dev)
    chunk_b = 228 * (ce // 16)         # words, unpacked int32 and uint8
    log_b = 48 * m_max                 # fields, CUR positions; records on
    bound = fused["base_bytes"] + chunk_b + log_b + batch_b   # the card
    print(f"disk tier: peak bound {bound} B = {fused['base_bytes']} before "
          f"+ {chunk_b} (one chunk) + {log_b} (its largest log, {m_max} "
          f"records) + {batch_b} (one expansion batch, measured)")
    expect(fused["sizes"] == sizes_mem, (fused["sizes"], sizes_mem))
    expect(fused["launches"] == {"mark_rotate_count": levels * n_chunks,
                                 "scatter_mark": 0, "lut_count": 0,
                                 "gather2": 0}, fused["launches"])
    expect(fused["launches"]["mark_rotate_count"] == 546, "K1 != 39 x 14")
    want_routes = disk_routes(total, ce, marks, True)
    expect(fused["routes"] == want_routes, (fused["routes"], want_routes))
    # one traversal a level pass, the seed pass's chunk, and the final
    # histogram's read (``count_values``)
    expect(fused["array_written"] == levels * nbytes + seed_bytes
           and fused["array_read"] == fused["array_written"] + nbytes,
           ("one array traversal a level", fused["array_read"],
            fused["array_written"], levels * nbytes + seed_bytes))
    expect(fused["bits"]["log_bytes_written"]
           == fused["bits"]["log_bytes_read"]
           == (n_marks + 1) * DISK_LOG_REC, fused["bits"])
    expect(fused["bits"]["ops_applied"] == n_marks + 1, fused["bits"])
    expect(fused["ledger"]["rw_passes"] == levels + 1, fused["ledger"])
    expect(fused["peak_bytes"] <= bound, (fused["peak_bytes"], bound))
    expect(fused["peak_bytes"] < mem_peak, (fused["peak_bytes"], mem_peak))

    # the unfused and the stopped-and-resumed runs at DISK_SIDE_N
    n2 = DISK_SIDE_N
    total2 = math.factorial(n2)
    n_chunks2 = -(-total2 // ce)
    nbytes2 = -(-total2 // 4)
    sizes2, marks2 = disk_expected(n2, ce, dev)
    mem2, _ = C.implicit_bfs(total2, [P.start_rank(n2)], P.neighbors(n2),
                             device=dev)
    expect(sizes2 == mem2 and sum(sizes2) == total2, (sizes2, mem2))
    levels2 = len(sizes2)
    unfused = disk_drive(dev, n=n2, fused=False)
    disk_line(f"unfused, n={n2}", unfused)
    expect(unfused["sizes"] == sizes2, unfused["sizes"])
    expect(unfused["launches"] == {
        "mark_rotate_count": 0,
        "scatter_mark": sum(m > 0 for per in marks2 for m in per),
        "lut_count": levels2 * n_chunks2, "gather2": 0}, unfused["launches"])
    want_u = disk_routes(total2, ce, marks2, False)
    expect(unfused["routes"] == want_u, (unfused["routes"], want_u))

    # rle2 chunks, stopped after level 6 and resumed: one search in two runs
    with tempfile.TemporaryDirectory() as ckroot:
        ck = os.path.join(ckroot, "ck")
        stop = disk_drive(dev, n=n2, checkpoint_dir=ck, stop_after=DISK_STOP,
                          checkpoint_every=DISK_CKPT_EVERY, compress=True)
        disk_line(f"rle2 chunks, n={n2}, stopped after level {DISK_STOP}",
                  stop)
        expect(stop["sizes"] == sizes2[:DISK_STOP + 1], stop["sizes"])
        snap = TDCK.SearchCheckpoint(ck)
        meta = snap.latest()
        expect(meta["level_sizes"] == sizes2[:DISK_STOP + 1], meta)
        sdir = snap.snapshot_dir(meta)
        got = b"".join(snapshot_chunk(sdir, c).tobytes()
                       for c in range(n_chunks2))
        _, ba6 = C.implicit_bfs(total2, [P.start_rank(n2)], P.neighbors(n2),
                                max_levels=DISK_STOP, device=dev)
        want = ba6.data.cpu().numpy().tobytes()[:nbytes2]
        del ba6
        expect(got == want, f"level {DISK_STOP}: the chunk bytes differ "
                            "from the in-memory words")
        print(f"disk tier: at level {DISK_STOP} the {n_chunks2} chunks == the "
              f"in-memory engine's words ({nbytes2} bytes)")
        m6 = disk_chunk_routes(sdir, total2, ce, dev)
        disk_plain_pass(ck, n2, ce, dev)
        res = disk_drive(dev, n=n2, checkpoint_dir=ck, resume=True,
                         checkpoint_every=DISK_CKPT_EVERY, compress=True)
        disk_line(f"rle2 chunks, n={n2}, resumed from level {DISK_STOP}", res)
    expect(res["sizes"] == sizes2, res["sizes"])
    print(f"disk tier: rle2 chunks at n={n2}, stopped and resumed: "
          f"{stop['wall_s'] + res['wall_s']:.3f} s in all, chunk bytes "
          f"{stop['array_written'] + res['array_written']} written (raw: "
          f"{levels2 * nbytes2} a pass a level)")
    expect(stop["launches"]["mark_rotate_count"]
           + res["launches"]["mark_rotate_count"] == levels2 * n_chunks2,
           (stop["launches"], res["launches"]))

    sorted_d, sorted_secs = PB.run_disk(DISK_SORTED_N)
    res_j, _, _ = PB.search(DISK_SORTED_N, PB.prefix_flips(DISK_SORTED_N),
                            device=dev)
    expect(sorted_d == res_j.level_sizes, (sorted_d, res_j.level_sizes))
    print(f"disk tier: sorted disk BFS n={DISK_SORTED_N} on the host "
          f"{sorted_secs:.3f} s == the Tier J sorted engine's level sizes")
    del res_j
    t0 = time.perf_counter()
    Q.tier_d_tour()
    tour_s = time.perf_counter() - t0
    setops = SO.run()
    rec = {"n": n, "side_n": n2, "chunk_elems": ce, "chunks": n_chunks,
           "level_sizes": sizes_mem, "in_memory_s": mem_secs,
           "in_memory_peak_bytes": mem_peak, "marks": n_marks,
           "max_log_records": m_max, "level6_max_log_records": m6,
           "peak_bound_bytes": bound, "expansion_batch_bytes": batch_b,
           f"sorted_n{DISK_SORTED_N}_s": sorted_secs, "tour_s": tour_s,
           "setops": setops, "disk_free_bytes": du.free}
    for key, r in (("fused", fused), ("unfused", unfused),
                   ("stopped", stop), ("resumed", res)):
        rec[key] = {k: r[k] for k in ("wall_s", "states_per_s", "peak_bytes",
                                      "launches", "routes", "bits",
                                      "array_read", "array_written",
                                      "ledger", "times")}
    print(json.dumps({"disk_tier": rec}))
    return rec


# ----------------------------------------------------- Tier D, sharded

SHARD_N = DISK_N              # the gated runs: n = 11, chunks of 2^20
SHARD_SMALL_N = 10            # the wire, recovery and trace runs
SHARD_SORTED_N = 9            # the sorted engine on the 4 shards (10 until
#                               PR 30: cut for phase_mesh's time)
SHARD_PARITY_N = 9            # K1 against its plain version, shard by shard
SHARD_PARITY_CHUNK = 1 << 16  # 3 chunks a shard at n = 9, 2 shards
SHARD_KILL = "worker_level:kill:shard=1:level=4"
SHARD_TIMEOUT = 600.0         # seconds a collective may take

_SHARD_T: dict = {}           # a spawn worker's timers (``_w_shard_timers``)


def _w_shard_timers(ctx, on: bool):
    """In a spawn shard worker.  With ``on``: wrap K1's wrapper (CUDA
    events around each launch), the op log's spills and reads, and the
    fs wire's bucket spills, seals and (barrier) reads (host seconds), and
    reset the worker's peak device memory.  Without: put every wrapper
    back and return the readings."""
    cls, bw = TDB.DiskBitArray, TDBK.BucketWriter
    if on:
        got = {"k1": [], "log_write_s": 0.0, "log_read_s": 0.0,
               "bucket_write_s": 0.0, "bucket_read_s": 0.0}
        orig = {"k1": K.bitpack_mark_rotate_count,
                "flush": cls._flush_logs, "read": cls._read_log,
                "append": bw._append, "publish": bw._publish,
                "iter": TDTP.iter_incoming}

        def k1(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = orig["k1"](*a, **kw)
            ev[1].record()
            got["k1"].append(ev)
            return out

        def timed(key, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    got[key] += time.perf_counter() - t0
            return run

        def timed_iter(*a, **kw):
            it = orig["iter"](*a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    got["bucket_read_s"] += time.perf_counter() - t0
                yield item

        K.bitpack_mark_rotate_count = k1
        cls._flush_logs = timed("log_write_s", orig["flush"])
        cls._read_log = staticmethod(timed("log_read_s", orig["read"]))
        bw._append = timed("bucket_write_s", orig["append"])
        bw._publish = timed("bucket_write_s", orig["publish"])
        TDTP.iter_incoming = timed_iter
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _SHARD_T.update(got=got, orig=orig)
        return None
    got, orig = _SHARD_T.pop("got"), _SHARD_T.pop("orig")
    K.bitpack_mark_rotate_count = orig["k1"]
    cls._flush_logs = orig["flush"]
    cls._read_log = staticmethod(orig["read"])
    bw._append, bw._publish = orig["append"], orig["publish"]
    TDTP.iter_incoming = orig["iter"]
    torch.cuda.synchronize()
    out = {k: v for k, v in got.items() if k != "k1"}
    out.update(k1=len(got["k1"]),
               k1_ms=sum(a.elapsed_time(b) for a, b in got["k1"]),
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def shard_counts_zero() -> None:
    """Every launch count and Tier D counter of this process set to 0."""
    K.reset_launches()
    TDB.reset_stats()
    TDX.reset_stats()
    TDC.reset_stats()
    for k in TDBK.TRANSPORT_STATS:
        TDBK.TRANSPORT_STATS[k] = 0


def shard_drive(dev, n, nshards, *, transport="fs", exchange=None,
                mode="spawn", chunk_elems=DISK_CHUNK, impl="auto",
                ckpt=None, max_recoveries=0, max_levels=10_000,
                timers=None, keep=False, after=None) -> dict:
    """One sharded implicit search of pancake ``n`` through
    ``core.disk.implicit_bfs`` on a ``ShardRuntime`` of ``nshards``
    built here (so the spawn workers' timers go in before the search),
    every count set to 0 just before and read just after: the spawn
    workers' launches and Tier D counters come home through the
    runtime's counter deltas at each level barrier.  ``keep`` also
    returns the whole cluster directory (every shard's chunks and op
    logs, the pending buckets) and the final values; ``after(rt)`` runs
    on the same runtime once the readings are taken (``rec["after"]``)."""
    total = math.factorial(n)
    timers = mode == "spawn" if timers is None else timers
    wd = tempfile.mkdtemp(prefix="shards_")
    try:
        t_rt = time.perf_counter()
        rt = TDCL.ShardRuntime(os.path.join(wd, "cluster"), nshards,
                               mode=mode, transport=transport,
                               exchange=exchange, timeout=SHARD_TIMEOUT)
        rt.barrier()                   # every worker up
        start_s = time.perf_counter() - t_rt
        try:
            if timers:
                rt.bcast(_w_shard_timers, True)
            sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            shard_counts_zero()
            t0 = time.perf_counter()
            sizes, bits = TDD.implicit_bfs(
                wd, total, [P.start_rank(n)], P.neighbors(n),
                chunk_elems=chunk_elems, max_levels=max_levels, impl=impl,
                device=dev, cluster=TDCF.ClusterConfig(runtime=rt),
                checkpoint=TDCF.CheckpointConfig(dir=ckpt),
                recovery=TDCF.RecoveryConfig(max_recoveries=max_recoveries))
            hist = bits.count_values().tolist()
            sync(dev)
            secs = time.perf_counter() - t0
            b = dict(TDB.STATS)
            rec = {"n": n, "nshards": nshards, "mode": mode,
                   "transport": transport, "exchange": exchange or "barrier",
                   "sizes": sizes, "hist": hist, "wall_s": secs,
                   "start_s": start_s,
                   "states_per_s": total / secs, "dropped": bits.dropped,
                   "launches": dict(K.LAUNCHES),
                   "routes": dict(K.ROUTE_LAUNCHES), "bits": b,
                   "wire": {k: v for k, v in TDBK.TRANSPORT_STATS.items()
                            if v},
                   "ledger": {k: TDX.STATS[k] for k in
                              ("rw_passes", "read_passes", "sort_passes",
                               "recoveries", "replayed_levels",
                               "io_retries")},
                   "coordinator_peak_bytes":
                       torch.cuda.max_memory_allocated(dev),
                   "workers": rt.bcast(TDCL._w_get_stats),
                   "per_shard_chunks": [
                       -(-max(0, min(bits.per, total - s * bits.per))
                         // chunk_elems) for s in range(nshards)]}
            if timers:
                rec["timers"] = rt.bcast(_w_shard_timers, False)
            if keep:
                rec["tree"] = tree(rt.root)
                rec["values"] = bits.read_all()
            bits.destroy()
            if after is not None:
                rec["after"] = after(rt)
        finally:
            rt.destroy()
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return rec


def shard_check(r, want_sizes, what, gated=True) -> None:
    """The sharded search's gates: the in-memory level sizes, every state
    DONE, no drop; K1 once a chunk a level pass on every shard (each on
    the route ``K.route`` names) and nothing else; per shard one pass a
    level and no sort; with ``gated`` also 16 B of op log a mark, each
    mark at its owner once, and the wire's bytes out == in."""
    n, total = r["n"], math.factorial(r["n"])
    levels = len(want_sizes)
    expect(r["sizes"] == want_sizes, (what, r["sizes"], want_sizes))
    expect(r["hist"] == [0, 0, 0, total] and r["dropped"] == 0,
           (what, r["hist"], r["dropped"]))
    k1 = levels * sum(r["per_shard_chunks"])
    expect(r["launches"] == {"mark_rotate_count": k1, "scatter_mark": 0,
                             "lut_count": 0, "gather2": 0},
           (what, r["launches"], k1))
    expect(sum(r["routes"].values()) == k1, (what, r["routes"]))
    # a spawn worker's ledger is its own; inline shards share this
    # process's, which then holds every shard's passes
    per = levels + 1 if r["mode"] == "spawn" else r["nshards"] * (levels + 1)
    for s, w in enumerate(r["workers"]):
        led = w["extsort"]
        expect(led["rw_passes"] + led["read_passes"] == per
               and led["sort_passes"] == 0 and w["bits"]["scan_passes"] == 0,
               (what, s, led))
    if not gated:
        return
    n_marks = (n - 1) * total
    b, wire = r["bits"], r["wire"]
    expect(b["log_bytes_written"] == b["log_bytes_read"]
           == (n_marks + 1) * DISK_LOG_REC, (what, b))
    expect(b["ops_applied"] == n_marks + 1, (what, b))
    kind = r["transport"]
    out_b, in_b = wire.get(f"{kind}_bytes_out", 0), wire.get(
        f"{kind}_bytes_in", 0)
    expect(out_b == in_b and out_b % DISK_LOG_REC == 0, (what, wire))
    remote = out_b // DISK_LOG_REC - 1          # the seed rides the wire
    local = b["log_bytes_written"] // DISK_LOG_REC - out_b // DISK_LOG_REC
    expect(local + remote == n_marks and remote > 0, (what, local, remote))
    r["marks_local"], r["marks_remote"] = local, remote


def shard_line(what, r) -> None:
    t = r.get("timers")
    k1 = r["launches"]["mark_rotate_count"]
    line = (f"disk sharded: {what}: {r['wall_s']:.3f} s wall "
            f"({r['start_s']:.3f} s to start the workers before it), "
            f"{r['states_per_s']:.0f} states/s, K1 {k1} launches "
            f"{r['routes']}; op log {r['bits']['log_bytes_written']} B, "
            f"wire {r['wire']}")
    if "marks_local" in r:
        line += (f"; marks local {r['marks_local']}, remote "
                 f"{r['marks_remote']}")
    if t:
        line += (f"; K1 {sum(x['k1_ms'] for x in t):.3f} ms over "
                 f"{sum(x['k1'] for x in t)} launches in the workers "
                 f"({[round(x['k1_ms'], 3) for x in t]}); worker peaks "
                 f"{[x['peak_bytes'] for x in t]} B; log writes "
                 f"{[round(x['log_write_s'], 3) for x in t]} s, reads "
                 f"{[round(x['log_read_s'], 3) for x in t]} s; bucket "
                 f"writes {[round(x['bucket_write_s'], 3) for x in t]} s, "
                 f"reads {[round(x['bucket_read_s'], 3) for x in t]} s")
    print(line)


def shard_summary(r) -> dict:
    keep = ("n", "nshards", "mode", "transport", "exchange", "wall_s",
            "start_s",
            "states_per_s", "launches", "routes", "wire", "ledger",
            "coordinator_peak_bytes", "per_shard_chunks", "marks_local",
            "marks_remote", "timers")
    out = {k: r[k] for k in keep if k in r}
    out["log_bytes"] = r["bits"]["log_bytes_written"]
    return out


def phase_disk_sharded(dev, disk) -> dict:
    """Tier D's sharded implicit BFS (``cluster.sharded_implicit_bfs``):
    each shard a spawned worker process with its block of the 2-bit array
    on the card, one K1 launch a chunk a level pass on every shard, the
    marks for other shards on the bucket wire.  (a) pancake n = 11 over
    4 shards, fs wire, barrier exchange, chunks of 2^20: the in-memory
    level sizes, K1 560 times, one pass a level a shard, the op log of
    the single-process run to the byte, the wire's bytes out == in; (b)
    the same at SHARD_SMALL_N over 2 shards; (c) at SHARD_SMALL_N: 4 shards
    with the pipelined exchange, the TCP wire (spawn) under a trace read back through
    ``trace.report_json``, the loopback wire (inline), and a worker killed
    at level 4 and healed from the level checkpoints; (d) at n = 9 over 2
    shards, K1 against its plain version on the card (``impl="ref"``):
    every shard's chunks, op logs and pending buckets the same bytes
    mid-search, and the final array the single-process search's; (e) the
    sorted engine on (a)'s 4 spawned workers at n = 9 on the host
    against the Tier J sorted engine."""
    sizes11 = disk["level_sizes"]
    out = {}

    n_small = SHARD_SMALL_N
    total_small = math.factorial(n_small)
    sizes_small, _ = C.implicit_bfs(total_small, [P.start_rank(n_small)],
                                    P.neighbors(n_small), device=dev)
    ns = SHARD_SORTED_N
    res_j, _, _ = PB.search(ns, PB.prefix_flips(ns), device=dev)
    sorted_want = res_j.level_sizes
    del res_j

    def sorted_on(rt):
        """(e) on (a)'s 4 spawned workers: the sorted engine at n = 9."""
        with tempfile.TemporaryDirectory() as wd:
            t0 = time.perf_counter()
            got, vis = TDD.breadth_first_search(
                wd, PB.start_code(ns)[None],
                PB.HostMoves(ns, P.prefix_flip_table(ns)),
                width=PB.words(ns), chunk_rows=1 << 14,
                cluster=TDCF.ClusterConfig(runtime=rt))
            secs = time.perf_counter() - t0
            rows = vis.size()
            vis.destroy()
        return {"sizes": got, "wall_s": secs, "rows": rows}

    a = shard_drive(dev, SHARD_N, 4, after=sorted_on)
    shard_check(a, sizes11, f"n={SHARD_N} 4 shards")
    shard_line(f"n={SHARD_N}, 4 shards, spawn, fs, barrier", a)
    if SHARD_N == 11:       # the single-process run's figures
        expect(a["launches"]["mark_rotate_count"] == 560,
               "K1 != 4 x 10 x 14")
        expect(a["bits"]["log_bytes_written"] == 6_386_688_016, a["bits"])
    out["n11_4"] = shard_summary(a)
    srt = a["after"]
    expect(srt["sizes"] == sorted_want
           and srt["rows"] == math.factorial(ns), (srt, sorted_want))
    print(f"disk sharded: sorted engine n={ns} on the same 4 spawned "
          f"shards, on the host: {srt['wall_s']:.3f} s, "
          f"{math.factorial(ns) / srt['wall_s']:.0f} states/s == the Tier "
          "J sorted engine's level sizes")
    out[f"sorted_n{ns}_4_s"] = srt["wall_s"]

    b2 = shard_drive(dev, n_small, 2)
    shard_check(b2, sizes_small, f"n={n_small} 2 shards")
    shard_line(f"n={n_small}, 2 shards, spawn, fs, barrier", b2)
    out[f"n{n_small}_2"] = shard_summary(b2)

    pipe = shard_drive(dev, n_small, 4, exchange="pipelined")
    shard_check(pipe, sizes_small, f"n={n_small} 4 shards pipelined")
    shard_line(f"n={n_small}, 4 shards, spawn, fs, pipelined", pipe)
    out[f"n{n_small}_4_pipelined"] = shard_summary(pipe)

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "run.jsonl")
        TDTR.start(path, meta={"example": "chip_smoke", "n": n_small,
                               "nshards": 4, "transport": "tcp"})
        try:
            tcp = shard_drive(dev, n_small, 4, transport="tcp")
        finally:
            TDTR.stop()
        rep = TDTR.report_json(path)
    shard_check(tcp, sizes_small, f"n={n_small} tcp traced")
    shard_line(f"n={n_small}, 4 shards, spawn, tcp, barrier, traced", tcp)
    rows = rep["levels"]
    expect([r["level"] for r in rows] == list(range(len(sizes_small) + 1))
           and all(sorted(r["shard_us"]) == [0, 1, 2, 3] for r in rows)
           and all(r["passes"] > 0 for r in rows), rows)
    print(f"disk sharded: the tcp run's trace: {len(rows)} level rows, "
          f"each with spans of shards 0-3, {rep['totals']['passes']} "
          f"passes, {rep['totals']['bytes']} B")
    out[f"n{n_small}_tcp"] = shard_summary(tcp)
    out[f"n{n_small}_tcp"]["trace"] = {"rows": len(rows), "totals": rep["totals"]}
    loop = shard_drive(dev, n_small, 4, transport="loopback", mode="inline")
    shard_check(loop, sizes_small, f"n={n_small} loopback inline")
    shard_line(f"n={n_small}, 4 shards, inline, loopback, barrier", loop)
    out[f"n{n_small}_loopback_inline"] = shard_summary(loop)

    with tempfile.TemporaryDirectory() as ck:
        os.environ[TDF.ENV_VAR] = SHARD_KILL
        try:
            kill = shard_drive(dev, n_small, 4, ckpt=ck, max_recoveries=1,
                               timers=False)
        finally:
            os.environ.pop(TDF.ENV_VAR, None)
            TDF.uninstall()
    expect(kill["sizes"] == sizes_small and kill["hist"][3] == total_small,
           (kill["sizes"], sizes_small))
    expect(kill["ledger"]["recoveries"] == 1
           and kill["ledger"]["replayed_levels"] >= 1, kill["ledger"])
    # recover() tears the pool down without its telemetry: the launches,
    # passes and wire bytes the workers booked since the last level
    # barrier go with them, so this run's counts are not reported
    print(f"disk sharded: n={n_small}, 4 shards, {SHARD_KILL}, checkpoints "
          f"every level: healed to the exact level sizes in "
          f"{kill['wall_s']:.3f} s (recoveries "
          f"{kill['ledger']['recoveries']}, replayed levels "
          f"{kill['ledger']['replayed_levels']})")
    out[f"n{n_small}_kill"] = {"wall_s": kill["wall_s"], "start_s": kill["start_s"],
                       "recoveries": kill["ledger"]["recoveries"],
                       "replayed_levels": kill["ledger"]["replayed_levels"]}

    total9 = math.factorial(SHARD_PARITY_N)
    sizes9, _ = C.implicit_bfs(total9, [P.start_rank(SHARD_PARITY_N)],
                               P.neighbors(SHARD_PARITY_N), device=dev)
    got = {}
    for impl in ("auto", "ref"):
        mid = shard_drive(dev, SHARD_PARITY_N, 2, mode="inline", impl=impl,
                          chunk_elems=SHARD_PARITY_CHUNK, max_levels=5,
                          keep=True)
        full = shard_drive(dev, SHARD_PARITY_N, 2, mode="inline", impl=impl,
                           chunk_elems=SHARD_PARITY_CHUNK, keep=True)
        got[impl] = (mid, full)
    (mid_k, full_k), (mid_r, full_r) = got["auto"], got["ref"]
    expect(mid_k["launches"]["mark_rotate_count"] > 0
           and not any(mid_r["launches"].values()),
           (mid_k["launches"], mid_r["launches"]))
    pending = [f for f in mid_k["tree"] if f.startswith("exchange/")]
    expect(mid_k["tree"] == mid_r["tree"] and pending,
           f"n={SHARD_PARITY_N}, 2 shards, level 5: K1's shard workdirs != "
           "the plain versions'")
    expect(full_k["sizes"] == full_r["sizes"] == sizes9
           and full_k["tree"] == full_r["tree"], full_k["sizes"])
    with tempfile.TemporaryDirectory() as wd:
        _, single = TDD.implicit_bfs(
            wd, total9, [P.start_rank(SHARD_PARITY_N)],
            P.neighbors(SHARD_PARITY_N), device=dev,
            chunk_elems=SHARD_PARITY_CHUNK)
        words = BA.pack_values(single.read_all())
        single.destroy()
    expect(torch.equal(BA.pack_values(full_k["values"]), words)
           and torch.equal(full_k["values"], full_r["values"]),
           "the sharded array's words != the single-process array's")
    print(f"disk sharded: n={SHARD_PARITY_N}, 2 shards in chunks of "
          f"{SHARD_PARITY_CHUNK}: "
          f"through K1 ({mid_k['launches']['mark_rotate_count']} + "
          f"{full_k['launches']['mark_rotate_count']} launches) == through "
          f"its plain version on the card, every shard's chunks, op logs and "
          f"{len(pending)} pending bucket files byte for byte at level 5 "
          f"({len(mid_k['tree'])} files) and at the end; the final words == "
          "the single-process array's")
    out["n9_parity"] = {"files_mid": len(mid_k["tree"]),
                        "pending_buckets": len(pending),
                        "k1": full_k["launches"]["mark_rotate_count"]}

    print(json.dumps({"disk_sharded": out}, default=str))
    return out


# ------------------------- serving on a device mesh (launch/mesh.py, PR 30)

MESH_ARCH = GRANITE_MOE_ARCH
MESH_GATE_LEN = 4096          # the gated prefill, at MESH_GATE_CF
MESH_GATE_CF = 8.0            # no (token, choice) pair drops on either side
MESH_PROMPT = 8               # the decode prompts: short, so that the
#                               planted decode faults move the logits
MESH_STEPS = DECODE_STEPS
MESH_FAULT_STEPS = 4          # the planted decode faults' steps
MESH_RUN_STEPS = 4            # the mesh's own decode, prefill and all
MESH_BATCH = BATCH_DECODE


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` = value for the block (a planted fault or a
    counting wrapper)."""
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def moe_counters():
    """Every MoE layer's time by CUDA events and the (token, choice) pairs
    it drops: ``moe_roomy``'s own count on a mesh (both bucket levels),
    else ``dispatch_slots`` over the layer's routing, run again outside
    the timed span."""
    rec = {"events": [], "dropped": []}
    orig, orig_roomy = BL.moe, MOE.moe_roomy

    def wrapped(p, x, cfg_, mesh=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        roomy = []

        def counted(*args):
            roomy.append(orig_roomy(*args))
            return roomy[-1]
        a.record()
        with patched(MOE, "moe_roomy", counted):
            out = orig(p, x, cfg_, mesh)
        b.record()
        rec["events"].append((a, b))
        if roomy:
            rec["dropped"].append(roomy[0][1].sum())
        else:
            _, keep, _ = MOE.dispatch_slots(MOE._route(p, x, cfg_)[1], cfg_)
            rec["dropped"].append((~keep).sum())
        return out
    BL.moe = wrapped
    try:
        yield rec
    finally:
        BL.moe = orig
    rec["moe_ms"] = sum(a.elapsed_time(b) for a, b in rec["events"])
    rec["dropped_pairs"] = int(sum(int(d) for d in rec["dropped"]))


def mesh_prefill(cfg, params, inputs, dev, mesh, what, timed=True):
    """``lm.prefill`` of ``inputs`` on ``mesh`` (None: one device) with
    every count set to 0 just before: K6 launches by route (one a layer,
    all wgmma), the last logits, and under ``moe_counters`` the MoE's
    time and the pairs it drops.  ``timed``: that run is a second one,
    after a first with nothing wrapped, whose wall it reads (tokens/s,
    the MoE share of the wall)."""
    seq = inputs["tokens"].numel()
    res = {"tokens": seq, "pairs": seq * cfg.top_k * cfg.n_layers}
    if timed:
        sync(dev)
        t0 = time.perf_counter()
        lm.prefill(params, inputs, cfg, mesh)
        sync(dev)
        res["wall_s"] = time.perf_counter() - t0
        res["tokens_per_s"] = seq / res["wall_s"]
    sync(dev)
    reset_all_launches()
    with moe_counters() as rec:
        logits, _ = lm.prefill(params, inputs, cfg, mesh)
        sync(dev)
    routes, launches = dict(FA.ROUTE_LAUNCHES), FA.LAUNCHES["flash_attention"]
    expect(launches == cfg.n_layers and routes == {
        "wgmma": cfg.n_layers, "classic": 0}, (what, launches, routes))
    expect(not any(PD.LAUNCHES.values()), dict(PD.LAUNCHES))
    expect(bool(torch.isfinite(logits).all()), f"{what}: logits not finite")
    res.update({"k6_launches": launches, "k6_routes": routes,
                "moe_ms": rec["moe_ms"],
                "dropped_pairs": rec["dropped_pairs"]})
    line = (f"mesh prefill: {what}, {cfg.name} bf16 1 x {seq} at capacity "
            f"factor {cfg.capacity_factor}, K6 {launches} ({routes}); MoE "
            f"{rec['moe_ms']:.1f} ms by CUDA events")
    if timed:
        res["moe_share"] = rec["moe_ms"] / 1e3 / res["wall_s"]
        line += (f" ({100 * res['moe_share']:.1f}% of the wall of "
                 f"{res['wall_s']:.3f} s, {res['tokens_per_s']:.0f} "
                 f"tokens/s)")
    print(f"{line}; dropped {res['dropped_pairs']} of {res['pairs']} "
          f"(token, choice) pairs")
    return logits, res


def mesh_decode(cfg, params, prompt, dev, mesh, steps, feed=None):
    """``steps`` decode steps after a prefill of ``prompt`` on ``mesh``:
    greedy, or teacher-forced on ``feed`` (the tokens another run chose).
    Counts set to 0 just before the steps; K8 launches after each step.
    Returns (the tokens fed after the prefill, the logits of each step
    (steps, B, V), K8 launches a step, tokens/s of the steps, the caches
    before each step)."""
    b = prompt["tokens"].shape[0]
    logits, caches = lm.prefill(params, prompt, cfg, mesh,
                                max_len=prompt["tokens"].shape[1] + steps)
    tok = logits[:, -1].argmax(-1, keepdim=True) if feed is None else feed[0]
    toks, outs, k8, before = [tok], [], [], []
    sync(dev)
    reset_all_launches()
    t0 = time.perf_counter()
    for t in range(steps):
        before.append(caches)
        lg, caches = lm.decode_step(params, step_inputs(cfg, tok), caches,
                                    cfg, mesh)
        outs.append(lg[:, -1])
        k8.append(PD.LAUNCHES["paged_decode_attention"])
        if t + 1 < steps:
            tok = (lg[:, -1].argmax(-1, keepdim=True) if feed is None
                   else feed[t + 1])
            toks.append(tok)
    sync(dev)
    wall = time.perf_counter() - t0
    expect(dict(PD.ROUTE_LAUNCHES) == {"tma": k8[-1], "classic": 0},
           dict(PD.ROUTE_LAUNCHES))
    expect(not any(FA.LAUNCHES.values()), dict(FA.LAUNCHES))
    return (toks, torch.stack(outs), [k8[0]] + [
        y - x for x, y in zip(k8, k8[1:])], b * steps / wall, before)


def mesh_steps(cfg, params, dev, mesh, before, toks):
    """Each step on ``mesh`` from the cache the run with no mesh had
    before it (this rank's shard of it) and with its token: the logits of
    each step (steps, B, V), K8 launches a step and tokens/s over the
    steps (each timed from a synchronised start to a synchronised end).
    ``mesh`` None: the steps with no mesh (``cfg.kernels="ref"``: the
    plain versions)."""
    dp = SHD.data_axes(mesh)
    i, n = (SHD.axis_index(mesh, dp), SHD.axis_size(mesh, dp)) if dp else (
        0, 1)
    outs, k8, wall = [], [], 0.0
    for caches, tok in zip(before, toks):
        mine = {"kv": [paged.shard(c, i, n) for c in caches["kv"]]}
        sync(dev)
        reset_all_launches()
        t0 = time.perf_counter()
        lg, _ = lm.decode_step(params, step_inputs(cfg, tok), mine, cfg,
                               mesh)
        sync(dev)
        wall += time.perf_counter() - t0
        outs.append(lg[:, -1])
        k8.append(PD.LAUNCHES["paged_decode_attention"])
        expect(dict(PD.ROUTE_LAUNCHES) == {"tma": k8[-1], "classic": 0},
               dict(PD.ROUTE_LAUNCHES))
    return torch.stack(outs), k8, tok.shape[0] * len(outs) / wall


def same_greedy(got, want, what) -> dict:
    """Teacher-forced on ``want``'s greedy tokens: each step's argmax of
    ``got`` is ``want``'s, or ``want``'s logit there lies within twice
    the row's largest difference between the two runs of ``want``'s
    largest (a tie the rounding of either may break); counted."""
    v = want.shape[-1]
    a, w = got.float(), want.float()
    diff = (a - w).abs().amax(-1)
    chosen = a.argmax(-1)
    equal = chosen == w.argmax(-1)
    tie = (w.amax(-1) - w.gather(-1, chosen[..., None])[..., 0]
           <= 2 * diff)
    expect(bool((equal | tie).all()), f"{what}: greedy tokens differ "
           f"beyond ties at {(~(equal | tie)).nonzero().tolist()}")
    res = {"tokens": int(equal.numel()), "same": int(equal.sum()),
           "ties": int((~equal & tie).sum()), "vocab": v}
    print(f"{what}: the same greedy token at {res['same']} of "
          f"{res['tokens']} (step, row) positions, {res['ties']} ties "
          f"excused")
    return res


def mesh_decode_pair(cfg, params, dev, mesh, batch, path) -> dict:
    """The run with no mesh, greedy; then each of its steps again on the
    mesh, from the cache it had before the step (the mesh's tokens/s are
    these steps'); K8 launches a step (the
    batched path: one a layer on the tma route; the context-parallel path
    reads its pages in float32: none).  The gate: every step's logits
    within the limit of the same step with no mesh, the same greedy
    tokens.  The batched path is held to the run with no mesh itself
    (K8); the context-parallel path, whose attention is the reference's
    float32 merge, to the same steps with no mesh through the plain
    versions (K8's plain version is float32 too), and its distance from
    the K8 steps is read.  A reading: the mesh's own run, prefill and
    all, teacher-forced on the same tokens for MESH_RUN_STEPS steps, its
    drift from the run with no mesh."""
    prompt = lm_inputs(cfg, batch, MESH_PROMPT, dev, SEED + 7 + batch)
    toks, want, k8_one, rate_one, before = mesh_decode(
        cfg, params, prompt, dev, None, MESH_STEPS)
    expect(k8_one == [cfg.n_layers] * MESH_STEPS, k8_one)
    got, k8_mesh, rate_mesh = mesh_steps(cfg, params, dev, mesh, before,
                                         toks)
    per_step = cfg.n_layers if path == "batched" else 0
    expect(k8_mesh == [per_step] * MESH_STEPS, (path, k8_mesh))
    v = cfg.vocab_size
    held, vs_k8 = want, None
    if path == "cp":
        held, _, _ = mesh_steps(cfg.replace(kernels="ref"), params, dev,
                                None, before, toks)
        vs_k8 = logit_errors(got[..., :v], want[..., :v],
                             f"mesh decode batch 1 (cp) vs no mesh with K8, "
                             f"each step from the same cache (a reading)")
    errs = logits_agree(got[..., :v], held[..., :v],
                        f"mesh decode batch {batch} ({path}) vs no mesh"
                        f"{' (plain versions)' if path == 'cp' else ''}, "
                        f"each of {MESH_STEPS} steps from the same cache")
    greedy = same_greedy(got[..., :v], held[..., :v],
                         f"mesh decode batch {batch} ({path})")
    _, run, _, _, _ = mesh_decode(cfg, params, prompt, dev, mesh,
                                  MESH_RUN_STEPS, feed=toks)
    drift = [logit_errors(run[t:t + 1, :, :v], want[t:t + 1, :, :v],
                          f"mesh decode batch {batch} ({path}), its own "
                          f"run teacher-forced, step {t}")["rel_err"]
             for t in range(MESH_RUN_STEPS)]
    profile = device_profile(
        lambda: mesh_steps(cfg, params, dev, mesh, before[:2], toks[:2]),
        dev, f"mesh decode batch {batch} ({path}), 2 steps")
    print(f"mesh decode: batch {batch} through _paged_decode_{path}, "
          f"{MESH_STEPS} steps after {MESH_PROMPT} tokens: "
          f"{rate_mesh:.2f} tokens/s on the mesh, {rate_one:.2f} with no "
          f"mesh; K8 a step {k8_mesh[0]} on the mesh, {k8_one[0]} with "
          f"none; its own run's per-row rel drift from the K8 run at steps "
          f"1-{MESH_RUN_STEPS}: {drift}")
    return {"batch": batch, "path": path, "tokens_per_s_mesh": rate_mesh,
            "tokens_per_s_no_mesh": rate_one, "k8_per_step_mesh": per_step,
            "k8_per_step_no_mesh": cfg.n_layers, "logits": errs,
            "logits_vs_k8": vs_k8, "greedy": greedy, "own_run_drift": drift,
            "profile": profile,
            "before": before[:MESH_FAULT_STEPS], "feed": toks,
            "held": held[:MESH_FAULT_STEPS]}


def mesh_faults(cfg, params, dev, mesh, gate_inputs, gate_want, dec) -> dict:
    """Planted faults, one a new path, each of whose logits must break the
    limit against what the clean path is held to: the MoE combine with
    its router weights left out (the gated prefill); the batched append
    written one position late; the context-parallel mask one position
    short (the decodes: the worst of the first MESH_FAULT_STEPS steps,
    each from the cache the run with no mesh had before it).  On one rank
    the exchanges are identities: their faults show only in the CPU
    worlds of ``tests/test_torch_mesh.py``."""
    v = cfg.vocab_size
    out = {}
    orig_combine = MOE._combine
    with patched(MOE, "_combine", lambda y, w, dt: orig_combine(
            y, torch.ones_like(w), dt)):
        bad, _ = lm.prefill(params, gate_inputs, cfg, mesh)
    out["moe combine without the router weights"] = logit_errors(
        bad[:, -1, :v], gate_want[:, -1, :v], "planted fault, the MoE "
        "combine without its weights, vs no mesh")
    orig_append = paged.append

    def late(cache, k, v_, inplace=False):
        moved = orig_append(cache._replace(lengths=cache.lengths + 1), k, v_,
                            inplace=inplace)
        return moved._replace(lengths=cache.lengths + 1)
    orig_logits = ATT._cp_logits
    plants = {
        "batched append one position late": (
            dec["batched"], patched(paged, "append", late)),
        "context-parallel mask one position short": (
            dec["cp"], patched(ATT, "_cp_logits", lambda q, kp, p0, n, *a:
                               orig_logits(q, kp, p0, n - 1, *a)))}
    for name, (rec, plant) in plants.items():
        with plant:
            got, _, _ = mesh_steps(cfg, params, dev, mesh, rec["before"],
                                   rec["feed"])
        out[name] = logit_errors(got[..., :v], rec["held"][..., :v],
                                 f"planted fault, {name}, vs no mesh")
    for name, e in out.items():
        expect(not e["ok"], f"the mesh checks miss {name}: {e}")
    return out


CP_F32_LAYERS = 2             # the CP witness's depth: float32, 2 layers
# The witness's limit (at most 1e-3), set from its first reading on an
# H100 (3.95e-7 per row: the two float32 paths sum in other orders); the
# planted CP-mask fault must read 10x it (it read 0.326).
CP_F32_TOL = 1e-5


def cp_f32_witness(cfg, dev, mesh) -> dict:
    """The CP decode gate free of the bfloat16 model's chaos: the model in
    float32 at CP_F32_LAYERS layers, batch 1, each greedy step of the run
    with no mesh (the plain versions) again on the mesh through
    ``_paged_decode_cp`` from the same cache, held per row within
    CP_F32_TOL of the plain steps; the planted CP-mask fault (one position
    short) must read at least 10x the limit."""
    cfg32 = cfg.replace(n_layers=CP_F32_LAYERS, dtype="float32")
    plain = cfg32.replace(kernels="ref")
    params = lm.init_params(cfg32, SEED + 3, device=dev, dtype=torch.float32)
    prompt = lm_inputs(cfg32, 1, MESH_PROMPT, dev, SEED + 8)
    toks, want, _, _, before = mesh_decode(plain, params, prompt, dev, None,
                                           MESH_STEPS)
    v = cfg32.vocab_size
    got, k8, _ = mesh_steps(cfg32, params, dev, mesh, before, toks)
    expect(k8 == [0] * MESH_STEPS, k8)
    errs = logit_errors(got[..., :v], want[..., :v],
                        f"mesh decode batch 1 (cp) in float32, "
                        f"{CP_F32_LAYERS} layers, vs no mesh (plain "
                        f"versions), each of {MESH_STEPS} steps from the "
                        f"same cache")
    expect(errs["rel_err"] <= CP_F32_TOL, ("cp float32 witness", errs))
    orig = ATT._cp_logits
    with patched(ATT, "_cp_logits", lambda q, kp, p0, n, *a: orig(
            q, kp, p0, n - 1, *a)):
        bad, _, _ = mesh_steps(cfg32, params, dev, mesh, before[
            :MESH_FAULT_STEPS], toks[:MESH_FAULT_STEPS])
    fault = logit_errors(bad[..., :v], want[:MESH_FAULT_STEPS, :, :v],
                         "planted fault, the float32 CP mask one position "
                         "short, vs no mesh")
    expect(fault["rel_err"] >= 10 * CP_F32_TOL, ("cp float32 fault", fault))
    return {"layers": CP_F32_LAYERS, "limit": CP_F32_TOL, "logits": errs,
            "planted_fault": fault,
            "fault_over_limit": fault["rel_err"] / CP_F32_TOL}


def phase_mesh(dev) -> dict:
    """Serving on a device mesh: a one-rank NCCL world (FileStore in a
    temp dir) as the (1, 1) ("data", "model") mesh of
    ``launch.mesh.make_host_mesh``, granite-moe-3b FULL in bfloat16
    (params from seed 0) with the roomy embedding and the roomy MoE.
    Gates: the prefill at MESH_GATE_LEN and capacity factor 8 (no pair
    dropped either side) on the mesh within the limit of no mesh, K6 once
    a layer on each side; the roomy embedding of a 1 × 32768 prompt ==
    the plain take; decode at batch 8 (``_paged_decode_batched``, K8 once
    a layer a step) and batch 1 (``_paged_decode_cp``): each greedy step
    of the run with no mesh again on the mesh from the same cache, logits
    within the limit, the same tokens; the planted faults.  Readings: the
    1 × 32768 prefill at the config's capacity factor on and off the
    mesh, with the drops and the MoE share; the decodes' tokens/s and how
    far the mesh's own decode drifts."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    root = tempfile.mkdtemp(prefix="roomy_mesh_")
    tdist.init_process_group("nccl", store=tdist.FileStore(
        os.path.join(root, "store"), 1), rank=0, world_size=1)
    t0 = time.perf_counter()
    try:
        mesh = MESH.make_host_mesh(tp=1)
        expect(SHD.mesh_axes(mesh) == {"data": 1, "model": 1},
               SHD.mesh_axes(mesh))
        base = get_config(MESH_ARCH).replace(embedding_dispatch="roomy")
        expect(base.moe_dispatch == "roomy", base.moe_dispatch)
        params = lm.init_params(base, SEED, device=dev, dtype=torch.bfloat16)
        cfg8 = base.replace(capacity_factor=MESH_GATE_CF)
        gate_inputs = lm_inputs(base, 1, MESH_GATE_LEN, dev, SEED + 5)
        lm.prefill(params, lm_inputs(base, 1, 256, dev, SEED + 1), cfg8,
                   mesh)                                       # warm-up
        want, one = mesh_prefill(cfg8, params, gate_inputs, dev, None,
                                 "no mesh", timed=False)
        got, on = mesh_prefill(cfg8, params, gate_inputs, dev, mesh,
                               "mesh (1, 1)", timed=False)
        expect(one["dropped_pairs"] == 0 and on["dropped_pairs"] == 0,
               (one["dropped_pairs"], on["dropped_pairs"]))
        v = base.vocab_size
        gate = logits_agree(got[:, -1, :v], want[:, -1, :v],
                            f"mesh prefill 1 x {MESH_GATE_LEN} vs no mesh, "
                            f"last-position logits")
        ids = lm_inputs(base, 1, PREFILL_LEN, dev, SEED)["tokens"]
        emb = LAY.embed_tokens(params["embed"], ids, base, mesh)
        expect(torch.equal(emb, params["embed"]["table"][ids]),
               "the roomy embedding differs from the take")
        print(f"mesh embedding: the roomy embedding of 1 x {PREFILL_LEN} "
              f"tokens == the plain take, bit for bit")
        dec = {"batched": mesh_decode_pair(cfg8, params, dev, mesh,
                                           MESH_BATCH, "batched"),
               "cp": mesh_decode_pair(cfg8, params, dev, mesh, 1, "cp")}
        faults = mesh_faults(cfg8, params, dev, mesh, gate_inputs, want, dec)
        cp32 = cp_f32_witness(cfg8, dev, mesh)
        del got, want, emb
        torch.cuda.empty_cache()
        read_inputs = lm_inputs(base, 1, PREFILL_LEN, dev, SEED)
        _, read_one = mesh_prefill(base, params, read_inputs, dev, None,
                                   "no mesh (reading)")
        _, read_on = mesh_prefill(base, params, read_inputs, dev, mesh,
                                  "mesh (1, 1) (reading)")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    for rec in dec.values():
        for key in ("before", "feed", "held"):
            rec.pop(key)
    wall = time.perf_counter() - t0
    print(f"mesh: granite-moe-3b FULL on a (1, 1) mesh of one NCCL rank, "
          f"{wall:.1f} s; on one rank every exchange and merge is an "
          f"identity, so their planted faults show only in the CPU worlds "
          f"of tests/test_torch_mesh.py, and what they cost needs two cards")
    out = {"arch": MESH_ARCH, "gate": {"no_mesh": one, "mesh": on,
                                       "logits": gate},
           "decode": dec, "planted_faults": faults, "cp_f32_witness": cp32,
           "reading_32k": {"no_mesh": read_one, "mesh": read_on},
           "k6_launches_prefill": on["k6_launches"],
           "k8_launches_per_step": {"batch 8 (batched)": dec["batched"][
               "k8_per_step_mesh"], "batch 1 (cp)": 0}, "wall_s": wall}
    print(json.dumps({"mesh": out}, default=str))
    return out


MESH_TRAIN_LAYERS = 16        # of 32: 62.5 GB of float32 state whole, 31.7 GB
#                               at 16, beside the capacity-8 exchange's
#                               backward (several GB a layer)
MESH_TRAIN_STEPS = 3
MESH_GLOO_LAYERS = 2          # the two-rank gloo world: full width, 2 layers
MESH_GLOO_LEN = 1024
MESH_GLOO_SHAPES = ((1, 2), (2, 1))
MESH_GLOO_TIMEOUT = 300.0     # seconds the two-rank world may take
# Limits of the mesh train step against no mesh, each set from a first
# reading on an H100 (PERF.md §6): on one rank the roomy MoE's and
# the K5 fold's sums run in other orders than the einsum MoE's and the
# take's (worst leaf 1.08e-2); in the two-rank world the bfloat16 model
# also splits the MoE's rows over two ranks (9.5e-3 on (1, 2), 8.9e-3 on
# (2, 1); its loss read the one-device loss's bits).  Each planted fault
# must read 3x its limit (they read 1.0, 1.0 and 1.33).
MESH_TRAIN_GRAD_TOL = 0.05
MESH_GLOO_GRAD_TOL = 0.05
MESH_GLOO_LOSS_TOL = 1e-5


def mesh_train_cfg(layers):
    """granite-moe-3b at its published widths, roomy MoE and roomy
    embedding, capacity factor 8 (no pair drops), ``layers`` deep."""
    cfg = get_config(MESH_ARCH).replace(
        embedding_dispatch="roomy", capacity_factor=MESH_GATE_CF,
        n_layers=layers)
    expect(cfg.moe_dispatch == "roomy", cfg.moe_dispatch)
    return cfg


def gloo_cfg():
    """The two-rank world's config: MESH_GLOO_LAYERS, remat off (gloo
    moves ~0.35 GB/s on this machine, and a rematted block gathers its
    float32 params again in the backward; the one-rank mesh runs remat)."""
    return mesh_train_cfg(MESH_GLOO_LAYERS).replace(remat=False)


class _Stamp(torch.autograd.Function):
    """The identity; its backward records a CUDA event as the gradient
    passes (where an op's backward starts or ends)."""

    @staticmethod
    def forward(ctx, x, sink):
        ctx.sink = sink
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ctx.sink.append(e)
        return g, None


@contextlib.contextmanager
def moe_train_events():
    """Every MoE layer's forward (the remat recompute too) and backward
    time by CUDA events: the forward between events around the call, the
    backward from its output's gradient to its input's."""
    rec = {"fwd": [], "bwd_start": [], "bwd_end": []}
    orig = BL.moe

    def wrapped(p, x, cfg_, mesh=None):
        x = _Stamp.apply(x, rec["bwd_end"]) if x.requires_grad else x
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        y = orig(p, x, cfg_, mesh)
        b.record()
        rec["fwd"].append((a, b))
        return _Stamp.apply(y, rec["bwd_start"]) if y.requires_grad else y
    BL.moe = wrapped
    try:
        yield rec
    finally:
        BL.moe = orig
    torch.cuda.synchronize()
    fwd = sum(a.elapsed_time(b) for a, b in rec["fwd"])
    bwd = sum(a.elapsed_time(b) for a, b in zip(rec["bwd_start"],
                                               rec["bwd_end"]))
    rec.update({"fwd_ms": fwd, "bwd_ms": bwd, "ms": fwd + bwd})


def mesh_train_run(cfg, dev, mesh, what, steps=MESH_TRAIN_STEPS):
    """``steps`` train steps from the seed's params (the rank's shards on
    a mesh), 1 x TRAIN_SEQ a step, every count set to 0 just before and
    read just after, each step in a ``train.step`` span: the losses, the
    step times, the launches a step by namespace, the peak (the state is
    freed on return)."""
    s = TrainSettings(batch=1, seq=TRAIN_SEQ, steps=steps, log_every=1)
    params, opt, res = TL.init_state(cfg, s, dev, mesh)
    step_fn = make_train_step(cfg, s, mesh)
    batches = [batch_to_torch(TL.data_rows(make_batch(
        cfg, s.seed, i, s.batch, s.seq), mesh), dev) for i in range(steps)]
    spans, losses, secs = [], [], []
    torch.cuda.empty_cache()
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    obs.enable(sink=spans.append)
    for i, batch in enumerate(batches):
        with obs.span("train.step", step=i):
            t0 = time.perf_counter()
            params, opt, res, m = step_fn(params, opt, res, batch, i)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
    obs.disable()
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = [{**a, **k5} for a, k5 in zip(
        step_launches(spans, "attention"), step_launches(spans, "scatter"))]
    expect(all(math.isfinite(x) for x in losses), (what, losses))
    rec = {"losses": losses, "step_seconds": secs, "peak_bytes": peak,
           "launches_per_step": per_step,
           "k6_routes": dict(FA.ROUTE_LAUNCHES),
           "k7_routes": dict(FA.BWD_ROUTE_LAUNCHES)}
    print(f"mesh train: {what}, {cfg.name} {cfg.n_layers} layers, 1 x "
          f"{TRAIN_SEQ} a step: losses {losses}, steps "
          f"{[round(x, 3) for x in secs]} s, peak {peak} B, launches a step "
          f"{per_step}")
    return rec


def mesh_grads(cfg, dev, mesh, batch):
    """(loss, grads as a list) at the seed's params (the rank's shards on
    a mesh), counts set to 0 just before and read just after."""
    s = TrainSettings(batch=1, seq=TRAIN_SEQ)
    params, _, _ = TL.init_state(cfg, s, dev, mesh)
    reset_all_launches()
    loss, grads = loss_and_grads(params, batch, cfg, mesh)
    sync(dev)
    launches = {**dict(FA.LAUNCHES), **dict(BS.LAUNCHES)}
    return params, loss, grads, launches


def k5_fold_times(caught, dev) -> dict:
    """The roomy embedding's gradient fold at the train step's shape: K5
    against its plain version and ``torch.index_add`` on the inputs caught
    from one backward (``fold_catcher``), over the rows the ids touch, and
    its bound."""
    expect(len(caught) == 1, len(caught))
    table, idx, pay = caught[0]
    rows, d = table.shape
    keep = (idx >= 0) & (idx < rows)
    trash = torch.zeros((rows + 1, d), dtype=table.dtype, device=dev)
    got = BS.bucket_scatter_add(table, idx, pay)
    want = R.bucket_scatter_add_ref(table, idx, pay)
    lib = torch.index_add(trash, 0, torch.where(keep, idx, rows).long(),
                          pay)[:rows]
    hit = torch.unique(idx[keep]).long()           # untouched rows stay 0
    expect(not got[~torch.isin(torch.arange(rows, device=dev), hit)].any(),
           "K5 wrote a row no id names")
    rels = {"plain": row_rel(got[hit], want[hit]),
            "index_add": row_rel(lib[hit], got[hit])}
    expect(max(rels.values()) <= K5_ROW_REL_TOL, rels)
    m = idx.numel()
    nbytes = 2 * 4 * rows * d + 4 * m + 4 * m * d
    res = {"shape": f"a zero ({rows}, {d}) float32 table, {m} int32 ids "
                    f"({int(keep.sum())} valid), ({m}, {d}) float32 rows",
           "ms": median_ms(lambda: BS.bucket_scatter_add(table, idx, pay)),
           "plain_ms": median_ms(lambda: R.bucket_scatter_add_ref(
               table, idx, pay)),
           "library_ms": median_ms(lambda: torch.index_add(
               trash, 0, torch.where(keep, idx, rows).long(), pay)),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bytes": nbytes, "row_rel": rels}
    print(f"mesh train: the roomy embedding's gradient fold, {res['shape']}:"
          f" K5 {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
          f"index_add {res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f}"
          f" ms ({nbytes} bytes at 3.35 TB/s); per-row rel {rels}")
    return res


def fold_catcher(caught):
    """A stand-in for ``ops.bucket_scatter_add`` that keeps a copy of its
    inputs in ``caught`` and calls it."""
    orig = OPS.bucket_scatter_add

    def catch(table, idx, pay, *, impl="auto"):
        caught.append((table.clone(), idx.clone(), pay.clone()))
        return orig(table, idx, pay, impl=impl)
    return patched(OPS, "bucket_scatter_add", catch)


def mesh_leaf_errors(grads, want, params, mesh) -> dict:
    """``leaf_errors`` of this rank's gradient shards against the whole
    gradient ``want``: each leaf's squared norms summed over the mesh, a
    logical element counted once (on coordinate 0 of each axis its spec
    replicates, the global norm's rule), by one all-reduce."""
    specs = []
    T.tree_map(lambda p, spec: specs.append(spec), params,
               SR.config_specs(gloo_cfg(), mesh))
    coord = dict(zip(SHD.mesh_axes(mesh), mesh.get_coordinate()))
    sums = torch.stack([
        torch.stack([(g.float() - w).square().sum(), w.square().sum()])
        * optim.adamw._counted(spec, coord) for g, w, spec in zip(
            grads, (SHD.shard_param(w, spec, mesh) for w, spec in zip(
                want, specs)), specs)])
    tdist.all_reduce(sums)
    rels = (sums[:, 0] / sums[:, 1]).sqrt().tolist()
    return rel_summary({"__".join(p): r for (p, _), r in zip(
        T.flatten_with_path(params), rels)})


def _w_mesh_train(rank, world, root):
    """One rank of the two-rank gloo world on the card: on each mesh of
    MESH_GLOO_SHAPES, the loss and gradient of ``gloo_cfg`` held per leaf
    to the one-device run the parent saved, with the launches; then the
    mesh's planted fault's loss (a forward: both faults scale the loss);
    results to ``root/rank<rank>.json``."""
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    denominator = lm._loss_denominator
    faults = {(1, 2): ("tp left out of the loss share",
                       lambda m, me: denominator(m, me) // 2),
              (2, 1): ("the local mask count", lambda m, me:
                       m.sum() * SHD.mesh_axes(me)["model"])}
    tdist.init_process_group("gloo", store=tdist.FileStore(
        os.path.join(root, "store"), world), rank=rank, world_size=world)
    out = {}
    try:
        cfg = gloo_cfg()
        for shape in MESH_GLOO_SHAPES:
            mesh = MESH.make_host_mesh(tp=shape[1], device="cuda")
            ref = torch.load(os.path.join(root, f"ref_{shape[0]}.pt"),
                             map_location=dev)
            batch = TL.data_rows(ref["batch"], mesh)
            params, loss, grads, launches = mesh_grads(cfg, dev, mesh, batch)
            name, bad = faults[shape]
            with patched(lm, "_loss_denominator", bad), torch.no_grad():
                bad_loss = float(lm.loss_fn(params, batch, cfg, mesh))
            out[f"({shape[0]}, {shape[1]})"] = {
                "loss": float(loss), "loss_rel": abs(float(loss) / ref[
                    "loss"] - 1), "launches": launches,
                "grads": mesh_leaf_errors(grads, ref["grads"], params, mesh),
                "fault": name, "fault_loss_rel": abs(bad_loss / ref["loss"]
                                                     - 1)}
            del params, grads, ref
            torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mesh_gloo_world(dev) -> dict:
    """The two-rank gloo world on the one card, the only exchange this
    machine can make that is not an identity: granite-moe at full width,
    MESH_GLOO_LAYERS layers (``gloo_cfg``), on (1, 2) at 1 x MESH_GLOO_LEN
    and on (2, 1) at 2 x MESH_GLOO_LEN with uneven label masks, in one
    spawn of two ranks.  Each held to the one-device run here (loss within
    MESH_GLOO_LOSS_TOL, every gradient leaf within MESH_GLOO_GRAD_TOL);
    the planted faults (``tp`` left out on (1, 2), the local mask count on
    (2, 1)) must move the loss 3x past its limit; K6-LSE, K7 and K5 launch
    on each rank."""
    cfg = gloo_cfg()
    root = tempfile.mkdtemp(prefix="roomy_mesh_train_")
    res = {}
    try:
        for b in (1, 2):
            batch = batch_to_torch(make_batch(cfg, SEED + 9, 0, b,
                                              MESH_GLOO_LEN), dev)
            if b == 2:                 # uneven masks over the data ranks
                batch["labels"][0, :MESH_GLOO_LEN // 2] = -1
            _, loss, grads, _ = mesh_grads(cfg, dev, None, batch)
            torch.save({"batch": batch, "loss": float(loss),
                        "grads": [g.detach() for g in grads]},
                       os.path.join(root, f"ref_{b}.pt"))
            del grads
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(
            _w_mesh_train, args=(2, root), nprocs=2, join=False,
            start_method="spawn")
        deadline = time.monotonic() + MESH_GLOO_TIMEOUT
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"the gloo world did not finish in "
                                   f"{MESH_GLOO_TIMEOUT} s")
        res["world_seconds"] = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for shape in MESH_GLOO_SHAPES:
        key = f"({shape[0]}, {shape[1]})"
        rec = ranks[0][key]
        for r in ranks:
            expect(r[key] == rec, (key, r[key], rec))
        lz = rec["launches"]
        expect(lz["flash_attention_lse"] == MESH_GLOO_LAYERS
               and lz["flash_attention_bwd"] == MESH_GLOO_LAYERS
               and lz["bucket_scatter_add"] == 1, (key, lz))
        expect(rec["loss_rel"] <= MESH_GLOO_LOSS_TOL, (key, rec))
        expect(rec["grads"]["max_rel"] <= MESH_GLOO_GRAD_TOL,
               (key, rec["grads"]))
        expect(rec["fault_loss_rel"] >= 3 * MESH_GLOO_LOSS_TOL, (key, rec))
        res[key] = {**rec, "fault_over_limit": rec["fault_loss_rel"]
                    / MESH_GLOO_LOSS_TOL}
        print(f"mesh train gloo world {key} on the card, {cfg.name} "
              f"{MESH_GLOO_LAYERS} layers, {2 // shape[1]} x "
              f"{MESH_GLOO_LEN}: loss rel {rec['loss_rel']:.3e} (limit "
              f"{MESH_GLOO_LOSS_TOL}), worst leaf "
              f"{rec['grads']['max_rel']:.4e} at {rec['grads']['worst_leaf']}"
              f" (limit {MESH_GLOO_GRAD_TOL}), median "
              f"{rec['grads']['median_rel']:.4e}; launches a rank "
              f"{rec['launches']}; planted fault ({rec['fault']}): loss rel "
              f"{rec['fault_loss_rel']:.4e} "
              f"({res[key]['fault_over_limit']:.3g}x the limit)")
    print(f"mesh train gloo world: one spawn of 2 ranks, "
          f"{res['world_seconds']:.1f} s")
    return res


def phase_mesh_train(dev) -> dict:
    """Training on a device mesh.  (1) A one-rank NCCL world as the (1, 1)
    mesh: granite-moe-3b at its published widths, MESH_TRAIN_LAYERS of 32
    layers, roomy MoE and roomy embedding at capacity factor 8,
    MESH_TRAIN_STEPS train steps of 1 x TRAIN_SEQ against the same config
    with no mesh in this process.  Gates: step 0's loss bit for bit; the
    gradient at the seed's params within MESH_TRAIN_GRAD_TOL a leaf; K6-LSE
    and K7 launches a step equal to no mesh's, K5 once a step on the mesh
    (the roomy embedding's fold), none off it; the planted fault (the
    reverse all-to-all's backward zeroed) 3x the limit.  Readings: step
    time on and off the mesh, the peak, the idle share, the MoE's share of
    the step, K5's fold against its plain version.  (2) The two-rank gloo
    world (``mesh_gloo_world``)."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    cfg = mesh_train_cfg(MESH_TRAIN_LAYERS)
    batch = batch_to_torch(make_batch(cfg, 0, 0, 1, TRAIN_SEQ), dev)
    # no mesh: the gradient at the seed's params, then the steps
    p0, loss0, want, one_grad = mesh_grads(cfg, dev, None, batch)
    del p0
    one = mesh_train_run(cfg, dev, None, "no mesh")
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="roomy_mesh_train_")
    tdist.init_process_group("nccl", store=tdist.FileStore(
        os.path.join(root, "store"), 1), rank=0, world_size=1)
    try:
        mesh = MESH.make_host_mesh(tp=1)
        expect(SHD.mesh_axes(mesh) == {"data": 1, "model": 1},
               SHD.mesh_axes(mesh))
        params, loss, grads, mesh_grad = mesh_grads(cfg, dev, mesh, batch)
        expect(float(loss) == float(loss0), (float(loss), float(loss0)))
        grad = leaf_errors(grads, want, params)
        del grads
        with patched(DL._Exchange, "backward", staticmethod(
                lambda ctx, g: (torch.zeros_like(g), None))):
            _, bad = loss_and_grads(params, batch, cfg, mesh)
        fault = leaf_errors(bad, want, params)
        del bad, want, params
        torch.cuda.empty_cache()
        print(f"mesh train: the gradient at the seed's params on the (1, 1) "
              f"mesh vs no mesh, loss {float(loss)} == {float(loss0)}, "
              f"worst leaf {grad['max_rel']:.4e} at {grad['worst_leaf']} "
              f"(limit {MESH_TRAIN_GRAD_TOL}), median "
              f"{grad['median_rel']:.4e}; planted fault (the reverse "
              f"all-to-all's backward zeroed) {fault['max_rel']:.4e} at "
              f"{fault['worst_leaf']}; launches {mesh_grad} (no mesh "
              f"{one_grad})")
        expect(grad["max_rel"] <= MESH_TRAIN_GRAD_TOL, grad)
        expect(fault["max_rel"] >= 3 * MESH_TRAIN_GRAD_TOL, fault)
        print(f"[gradients done at {time.perf_counter() - t0:.1f} s of the "
              f"phase]")
        on = mesh_train_run(cfg, dev, mesh, "mesh (1, 1)")
        expect(on["losses"][0] == one["losses"][0],
               (on["losses"], one["losses"]))
        n = cfg.n_layers
        expect(one["launches_per_step"] == [{
            "flash_attention_lse": 2 * n, "flash_attention_bwd": n}]
            * MESH_TRAIN_STEPS, one["launches_per_step"])
        expect(on["launches_per_step"] == [{
            "flash_attention_lse": 2 * n, "flash_attention_bwd": n,
            "bucket_scatter_add": 1}] * MESH_TRAIN_STEPS,
            on["launches_per_step"])
        expect(on["k6_routes"]["classic"] == 0
               and on["k7_routes"]["classic"] == 0,
               (on["k6_routes"], on["k7_routes"]))
        # readings: the MoE's share of one more step (the fold's inputs
        # caught from it), the idle share of another
        s = TrainSettings(batch=1, seq=TRAIN_SEQ)
        params, opt, res = TL.init_state(cfg, s, dev, mesh)
        step_fn = make_train_step(cfg, s, mesh)
        caught = []
        sync(dev)
        t1 = time.perf_counter()
        with moe_train_events() as moe_rec, fold_catcher(caught):
            step_fn(params, opt, res, batch, 0)
            sync(dev)
        wall = time.perf_counter() - t1
        profile = device_profile(lambda: step_fn(params, opt, res, batch, 1),
                                 dev, f"mesh train step, {cfg.name} "
                                 f"{n} layers on (1, 1)")
        del params, opt, res
        torch.cuda.empty_cache()
        fold = k5_fold_times(caught, dev)
        del caught
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    moe = {"fwd_ms": moe_rec["fwd_ms"], "bwd_ms": moe_rec["bwd_ms"],
           "step_wall_s": wall, "share": moe_rec["ms"] / 1e3 / wall}
    print(f"mesh train: the MoE in one mesh step: forward (its remat "
          f"recompute too) {moe['fwd_ms']:.1f} ms, backward "
          f"{moe['bwd_ms']:.1f} ms by CUDA events, {100 * moe['share']:.1f}% "
          f"of the step's {wall:.3f} s")
    torch.cuda.empty_cache()
    print(f"[the (1, 1) mesh done at {time.perf_counter() - t0:.1f} s of the "
          f"phase]")
    gloo = mesh_gloo_world(dev)
    wall_phase = time.perf_counter() - t0
    med = {k: statistics.median(r["step_seconds"][1:]) for k, r in
           (("mesh", on), ("no_mesh", one))}
    out = {"arch": MESH_ARCH, "layers": MESH_TRAIN_LAYERS,
           "tokens_per_step": TRAIN_SEQ, "steps": MESH_TRAIN_STEPS,
           "no_mesh": one, "mesh": on, "median_step_s": med,
           "grad": grad, "grad_limit": MESH_TRAIN_GRAD_TOL,
           "planted_fault": fault,
           "fault_over_limit": fault["max_rel"] / MESH_TRAIN_GRAD_TOL,
           "moe": moe, "profile": profile, "k5_fold": fold,
           "launches_per_step_mesh": on["launches_per_step"][0],
           "gloo": gloo, "wall_s": wall_phase}
    print(f"mesh train: {cfg.name} {n} of 32 layers on a (1, 1) mesh of one "
          f"NCCL rank against no mesh, median step (steps 1-"
          f"{MESH_TRAIN_STEPS - 1}) {med['mesh']:.3f} s against "
          f"{med['no_mesh']:.3f} s, peak {on['peak_bytes']} B against "
          f"{one['peak_bytes']} B; phase {wall_phase:.1f} s")
    print(json.dumps({"mesh_train": out}, default=str))
    return out


def to_port_bounds() -> list:
    """The bounds of the TPU kernels still to port: none.  K5, the last,
    is ported (``phase_roomy``; its bound is in the ``kernels`` line), so
    the ``to_port`` line prints an empty list."""
    return []


def main() -> None:
    t0 = time.perf_counter()
    phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ptxas, k7_ptx, k8_ptx, k9_ptx, k12_ptx, k4_ptx, k9b_ptx = phase_build()
    print(f"[phase_build done at {time.perf_counter() - t0:.1f} s]")
    # K9-bwd's planted-fault variants build (nvcc) while the phases before
    # phase_training_families run
    variants = ThreadPoolExecutor(1)
    k9b_libs = variants.submit(k9b_fault_libs)
    phase_parity_edges(dev)
    bin_faults = phase_bin_faults(dev)
    print(f"[phase_bin_faults done at {time.perf_counter() - t0:.1f} s]")
    data, tgt = phase_parity_full(dev)
    times = phase_times(data, tgt)
    del data, tgt
    torch.cuda.empty_cache()
    k12 = phase_k12_levels(dev)
    print(f"[phase_k12_levels done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    launches, sizes, k12_routes = phase_main_path(dev)
    phase_equivalence(dev)
    print(f"[phase_equivalence done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    phase_sorted_bfs(dev)
    print(f"[phase_sorted_bfs done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    disk = phase_disk_tier(dev)
    print(f"[phase_disk_tier done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    sharded = phase_disk_sharded(dev, disk)
    print(f"[phase_disk_sharded done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    oracle = phase_oracle(dev, sizes)
    print(f"[phase_oracle done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    roomy = phase_roomy(dev)
    print(f"[phase_roomy done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    phase_k6_parity_edges(dev)
    k6_launches, k6 = phase_lm(dev)
    print(f"[phase_lm done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    k7_parity = phase_k7_parity(dev)
    k7 = phase_k7_times(dev)
    print(f"[phase_k7_times done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    trained = phase_training(dev)
    print(f"[phase_training done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    fm = phase_falcon_mamba(dev)
    print(f"[phase_falcon_mamba done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    dense = phase_dense(dev)
    print(f"[phase_dense done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    mh = phase_moe_hybrid(dev, k9_ptx)
    print(f"[phase_moe_hybrid done at {time.perf_counter() - t0:.1f} s]")
    gm, zb, ph = mh["granite_moe"], mh["zamba2"], mh["phi35_moe"]
    torch.cuda.empty_cache()
    tf = phase_training_families(dev, k9b_ptx, k9b_libs.result())
    variants.shutdown()
    print(f"[phase_training_families done at {time.perf_counter() - t0:.1f} s]")
    tfm, tz, tg = tf["falcon_mamba"], tf["zamba2"], tf["granite_moe"]
    torch.cuda.empty_cache()
    fe = phase_frontend(dev)
    print(f"[phase_frontend done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    mesh = phase_mesh(dev)
    print(f"[phase_mesh done at {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    mtrain = phase_mesh_train(dev)
    print(f"[phase_mesh_train done at {time.perf_counter() - t0:.1f} s]")
    mt_steps = {"launches_per_mesh_train_step": mtrain[
        "launches_per_step_mesh"], "mesh_train_shape": f"{MESH_ARCH} "
        f"{MESH_TRAIN_LAYERS} layers on a (1, 1) mesh, 1 x {TRAIN_SEQ}",
        "launches_per_mesh_train_step_gloo_rank": {
            k: v["launches"] for k, v in mtrain["gloo"].items()
            if k.startswith("(")}}
    fe_short = {"musicgen-medium": "musicgen", "qwen2-vl-2b": "qwen"}

    def fe_keys(rec_of, fields=("ms", "plain_ms", "bound_ms", "library_ms")):
        """{musicgen_ms: …, qwen_ms: …}: one record of each frontend arch."""
        return {f"{fe_short[a]}_{f}": rec_of(fe[a])[f]
                for a in FRONTEND_ARCHS for f in fields}
    kernels = [{"name": f"bitpack_{name}", "route": "cuda", "source": SOURCE,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": MAX_ERR[name], "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
                "library_ms": None}
               for name, replaces in KERNELS]
    for rec, key, tile in ((kernels[0], "fused_bfs_k1", "true"),
                           (kernels[1], "unfused_bfs_k2", "false")):
        sums = k12["sums"]
        rec.update({
            "kernel": f"bin_count_kernel, bin_scan_kernel, "
                      f"bin_scatter_kernel, tile_pass_kernel<{tile}> (the "
                      f"binned route, from half as many targets as words); "
                      f"the atomic route below",
            "shape": f"pancake n = 12 level {LEVEL} (on the "
                     f"{times['route']} route); the sums over every level "
                     f"of n = 12 beside",
            "launches_by_route": k12_routes,
            "ptxas": {k: v for k, v in k12_ptx.items()
                      if not k.startswith("tile_pass") or tile in k},
            "bfs_ms": sums["routed"][key], "bfs_bound_ms": sums["bound"][key],
            "bfs_ms_binned": sums["binned"][key],
            "bfs_ms_atomic": sums["atomic"][key],
            "publish_ms": sums["routed"]["publish_k1_k2"],
            "publish_bound_ms": sums["bound"]["publish_k1_k2"],
            "publish_ms_atomic": sums["atomic"]["publish_k1_k2"],
            "planted_faults": {k: v["k1_err" if tile == "true" else "k2_err"]
                               for k, v in bin_faults.items()}})
    for rec, (name, _) in zip(kernels, KERNELS):
        rec.update({
            "disk_launches": {r: disk[r]["launches"][name]
                              for r in ("fused", "unfused")},
            "disk_launches_rle2_stop_resume": disk["stopped"]["launches"][name]
            + disk["resumed"]["launches"][name],
            "disk_launches_by_route": {r: disk[r]["routes"]
                                       for r in ("fused", "unfused")},
            "disk_ms": disk["fused" if name == "mark_rotate_count" else
                            "unfused"]["times"][
                {"mark_rotate_count": "k1_ms", "scatter_mark": "k2_ms",
                 "lut_count": "k3_ms"}[name]],
            "disk_sharded_launches": {
                key: sharded[key]["launches"][name]
                for key in ("n11_4", *(f"n{SHARD_SMALL_N}_{k}" for k in (
                    "2", "4_pipelined", "tcp", "loopback_inline")))},
            "disk_sharded_ms": (sum(x["k1_ms"] for x in
                                    sharded["n11_4"]["timers"])
                                if name == "mark_rotate_count" else None),
            "disk_sharded_shape": f"pancake n = {SHARD_N} over 4 "
                                  f"shards (n = {SHARD_SMALL_N} over 2): 10 "
                                  "(2) chunks "
                                  f"of {DISK_CHUNK} fields a shard, one "
                                  "launch a chunk a level pass on every "
                                  "shard; disk_sharded_ms sums the 4 "
                                  "workers' launches",
            "disk_shape": f"pancake n = {DISK_N} on disk, fused (the "
                          f"unfused and rle2 runs at n = {DISK_SIDE_N}): "
                          f"{disk['chunks']} chunks of {DISK_CHUNK} fields, "
                          "one launch a chunk a level pass (K2: a chunk "
                          "with a log); disk_ms sums the run's launches"})
    t4 = oracle["k4"]
    big, small = (t4[str(m)] for m in reversed(ORACLE_BATCHES))
    serve_ = oracle["serve"]
    kernels.append({
        "name": "bitpack_gather2", "route": "cuda", "source": SOURCE,
        "replaces": K4_REPLACES, "launches": serve_["launches"]["gather2"],
        "kernel": "gather2_kernel<long long, uint8_t> (the chunk-table "
                  "gather: one launch a codes batch; the flat form is "
                  "gather2_kernel<int32_t, int32_t>)", "ptxas": k4_ptx,
        "max_abs_err": MAX_ERR["gather2"], "ms": big["ms"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "library_ms": None,
        "library": "none: no one PyTorch call gathers 2-bit fields",
        "shape": f"the pancake n = 12 oracle's 16 chunks (29937600 fields "
                 f"each), M = {ORACLE_BATCHES[1]} random int64 ranks",
        "wrapper_ms": big["wrapper_ms"], "flat_ms": big["flat_ms"],
        "flat_bound_ms": big["flat_bound_ms"],
        "ms_4096": small["ms"], "wrapper_ms_4096": small["wrapper_ms"],
        "plain_ms_4096": small["plain_ms"],
        "bound_ms_4096": small["bound_ms"],
        "launches_per_codes_batch": serve_[f"codes_{ORACLE_BATCHES[0]}"][
            "k4_launches_per_batch"],
        "launches_per_distance_batch": serve_[
            f"distance_{ORACLE_BATCHES[0]}"]["k4_launches_per_batch"],
        "launches_per_codes_batch_20pct": serve_["small_codes"][
            "k4_launches_per_batch"]})
    emb = roomy["embedding"]
    kernels.append({
        "name": "bucket_scatter_add", "route": "cuda", "source": K5_SOURCE,
        "replaces": K5_REPLACES, "launches": emb["launches"],
        "max_abs_err": MAX_ERR["bucket_scatter_add"],
        "ms": emb["times"]["ms"], "plain_ms": emb["times"]["plain_ms"],
        "bound_ms": emb["times"]["bound_ms"],
        "bound_by": emb["times"]["bound_by"],
        "library_ms": emb["times"]["library_ms"],
        "library": "torch.index_add (out of place)", "shape": emb["shape"],
        "launches_per_prefix": roomy["prefix"]["launches"], **mt_steps,
        **{f"mesh_train_fold_{k}": mtrain["k5_fold"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "shape")}})
    g, loc = k6["global"], k6["local"]
    nem6 = dense["nemotron"]["k6_times"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": K6_SOURCE,
        "replaces": K6_REPLACES, "launches": k6_launches,
        "kernel": "fa_hopper_kernel (the wgmma route: TMA ring, warp "
                  "specialisation, wgmma)",
        "launches_by_route": k6["routes"], "ptxas": ptxas,
        "max_abs_err": MAX_ERR["flash_attention"],
        "max_rel_err_per_bh": MAX_REL["flash_attention"], "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "library": "flex_attention (compiled)",
        "shape": "gemma2-2b global layer, 1x8x32768x256, softcap 50",
        "ms_softcap_off": g["ms_softcap_off"],
        "library_ms_softcap_off": g["library_ms_softcap_off"],
        "local_ms": loc["ms"], "local_plain_ms": loc["plain_ms"],
        "local_bound_ms": loc["bound_ms"],
        "nemotron_ms": nem6["ms"], "nemotron_plain_ms": nem6["plain_ms"],
        "nemotron_bound_ms": nem6["bound_ms"],
        "nemotron_library_ms": nem6["library_ms"],
        "nemotron_library": "scaled_dot_product_attention(is_causal=True, "
                            "enable_gqa=True)",
        "nemotron_prefill_share": dense["nemotron"]["prefill"]["k6_share"],
        "nemotron_launches_by_route": dense["nemotron"]["prefill"][
            "k6_routes"],
        **{f"{key}_{f}": rec["k6_times"][f] for key, rec in (
            ("granite_moe", gm), ("zamba2", zb), ("phi35_moe", ph))
           for f in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "launches_by_route_moe_hybrid": {
            "granite-moe-3b-a800m": gm["prefill"]["k6_routes"],
            "zamba2-1.2b": zb["prefill"]["k6_routes"],
            "phi3.5-moe-42b-a6.6b (8 layers)": ph["prefill"]["k6_routes"]},
        **fe_keys(lambda r: r["serve"]["k6_times"]),
        "launches_by_route_frontend": {
            a: fe[a]["serve"]["prefill"]["k6_routes"]
            for a in FRONTEND_ARCHS},
        "launches_by_route_mesh": {
            f"{MESH_ARCH} on a (1, 1) mesh, prefill 1 x {MESH_GATE_LEN}":
                mesh["gate"]["mesh"]["k6_routes"],
            f"the same, 1 x {PREFILL_LEN}":
                mesh["reading_32k"]["mesh"]["k6_routes"]}})
    tr, win = k7["train"], k7["window"]
    kernels.append({
        "name": "flash_attention_lse", "route": "cuda", "source": K6_SOURCE,
        "replaces": K6_LSE_REPLACES,
        "kernel": "fa_hopper_kernel (the wgmma route), with the LSE pointer",
        "launches_by_route": trained["k6_routes"],
        "launches": trained["launches"]["flash_attention_lse"],
        "max_abs_err": MAX_ERR["flash_attention_lse"],
        "ms": tr["fwd_lse"]["ms"], "plain_ms": tr["fwd_lse"]["plain_ms"],
        "bound_ms": tr["fwd_lse"]["bound_ms"],
        "bound_by": tr["fwd_lse"]["bound_by"],
        "library_ms": tr["fwd_lse"]["library_ms"],
        "library": "flex_attention (compiled) with its LSE",
        "shape": "gemma2-2b train step, 1x8x4096x256, GQA 2, softcap 50, "
                 "causal", "launches_per_step":
            trained["launches_per_step"]["flash_attention_lse"],
        "launches_train_moe_hybrid": {
            rec["arch"]: rec["main_path"]["launches"]["flash_attention_lse"]
            for rec in (tz, tg)},
        "launches_by_route_train_moe_hybrid": {
            rec["arch"]: rec["main_path"]["k6_routes"] for rec in (tz, tg)},
        "ms_softcap_off": tr["fwd_lse"]["ms_softcap_off"],
        "library_ms_softcap_off": tr["fwd_lse"]["library_ms_softcap_off"],
        "window_ms": win["fwd_lse"]["ms"],
        "window_bound_ms": win["fwd_lse"]["bound_ms"],
        "window_library_ms": win["fwd_lse"]["library_ms"],
        **fe_keys(lambda r: r["train"]["train_layout"]["fwd_lse"]),
        "frontend_library": "scaled_dot_product_attention(is_causal=True, "
                            "enable_gqa=True) forward (no LSE)",
        "launches_train_frontend": {
            a: fe[a]["train"]["main_path"]["launches"]["flash_attention_lse"]
            for a in FRONTEND_ARCHS},
        "launches_by_route_train_frontend": {
            a: fe[a]["train"]["main_path"]["k6_routes"]
            for a in FRONTEND_ARCHS}, **mt_steps})
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": K7_SOURCE,
        "replaces": K7_REPLACES,
        "kernel": "bwd_rows_kernel, dkdv_hopper_kernel, dq_hopper_kernel "
                  "(the wgmma route: TMA rings, warp specialisation, wgmma)",
        "launches_by_route": trained["k7_routes"], "ptxas": k7_ptx,
        "launches": trained["launches"]["flash_attention_bwd"],
        "max_abs_err": MAX_ERR["flash_attention_bwd"],
        "max_rel_err_per_bh": MAX_REL["flash_attention_bwd"],
        "ms": tr["bwd"]["ms"], "plain_ms": tr["bwd"]["plain_ms"],
        "bound_ms": tr["bwd"]["bound_ms"], "bound_by": tr["bwd"]["bound_by"],
        "library_ms": tr["bwd"]["library_ms"],
        "library": "flex_attention (compiled), backward alone",
        "shape": "gemma2-2b train step, 1x8x4096x256, GQA 2, softcap 50, "
                 "causal", "launches_per_step":
            trained["launches_per_step"]["flash_attention_bwd"],
        "ms_softcap_off": tr["bwd"]["ms_softcap_off"],
        "library_ms_softcap_off": tr["bwd"]["library_ms_softcap_off"],
        "window_ms": win["bwd"]["ms"], "window_plain_ms": win["bwd"][
            "plain_ms"], "window_bound_ms": win["bwd"]["bound_ms"],
        "window_library_ms": win["bwd"]["library_ms"],
        "tflops_10d": tr["bwd"]["tflops_10d"],
        "tflops_14d": tr["bwd"]["tflops_14d"],
        "dense_layouts": k7["dense"],
        "launches_train_moe_hybrid": {
            rec["arch"]: rec["main_path"]["launches"]["flash_attention_bwd"]
            for rec in (tz, tg)},
        "launches_by_route_train_moe_hybrid": {
            rec["arch"]: rec["main_path"]["k7_routes"] for rec in (tz, tg)},
        **fe_keys(lambda r: r["train"]["train_layout"]["bwd"]),
        "frontend_library": "scaled_dot_product_attention(is_causal=True, "
                            "enable_gqa=True) backward alone",
        "launches_train_frontend": {
            a: fe[a]["train"]["main_path"]["launches"]["flash_attention_bwd"]
            for a in FRONTEND_ARCHS},
        "launches_by_route_train_frontend": {
            a: fe[a]["train"]["main_path"]["k7_routes"]
            for a in FRONTEND_ARCHS},
        "planted_faults_rel": {k: v["rel"] for k, v in
                               k7_parity["planted_faults"].items()},
        **mt_steps})
    t9 = fm["times"]
    kernels.append({
        "name": "mamba_scan", "route": "cuda", "source": K9_SOURCE,
        "replaces": K9_REPLACES, "launches": fm["launches"],
        "kernel": "scan_seg_kernel (time in segments of a block's threads, "
                  "folded from a carried prefix)", "ptxas": k9_ptx,
        "max_abs_err": MAX_ERR["mamba_scan"],
        "max_rel_err_per_tile": MAX_REL["mamba_scan"],
        "max_rel_err_per_tile_vs_mirror": MAX_REL["mamba_scan_mirror"],
        "ms": t9["ms"],
        "plain_ms": t9["plain_ms"], "bound_ms": t9["bound_ms"],
        "bound_by": t9["bound_by"], "library_ms": None,
        "library": "none: PyTorch has no call that computes a selective "
                   "scan, and no package of one (mamba_ssm) is installed",
        "shape": "falcon-mamba-7b prefill layer 0, x 1x32768x8192 bf16, "
                 "N 16, with the final state",
        "bound_binds": t9["binds"], "bound_exp_ms": t9["bound_exp_ms"],
        "bound_fma_ms": t9["bound_fma_ms"],
        "bound_bytes_ms": t9["bound_bytes_ms"],
        "launches_per_forward": fm["forward_launches"],
        "launches_per_decode_step": fm["decode_launches_per_step"],
        "zamba2_launches_per_forward": zb["forward_k9"]["launches"][
            "mamba_scan"],
        "zamba2_ms": zb["forward_k9"]["k9_times"]["ms"],
        "zamba2_plain_ms": zb["forward_k9"]["k9_times"]["plain_ms"],
        "zamba2_bound_ms": zb["forward_k9"]["k9_times"]["bound_ms"],
        "zamba2_bound_binds": zb["forward_k9"]["k9_times"]["binds"],
        "zamba2_shape": zb["forward_k9"]["k9_times"]["shape"],
        "zamba2_ptxas": zb["forward_k9"]["k9_ptxas"],
        "train_launches": tfm["main_path"]["launches"]["mamba_scan"],
        "train_launches_per_step": tfm["main_path"]["launches_per_step"][
            "mamba_scan"],
        "train_k9_with_chunks_ms": tf["k9_bwd_times"]["k9_with_chunks_ms"]})
    t9b, z9b = tf["k9_bwd_times"], tf["k9_bwd_times_zamba2"]
    kernels.append({
        "name": "mamba_scan_bwd", "route": "cuda", "source": K9B_SOURCE,
        "replaces": K9_REPLACES,
        "replaces_note": "the backward of that kernel, which the reference "
                         "lacks (it trains SSMs through its plain scan)",
        "launches": tfm["main_path"]["launches"]["mamba_scan_bwd"],
        "launches_per_step": tfm["main_path"]["launches_per_step"][
            "mamba_scan_bwd"],
        "kernel": "scan_bwd_kernel<T, TPC> (time split as K9's: staged "
                  "chunks walked in reverse, segment folds of h and of the "
                  "adjoint, db and dc summed over a cluster of blocks) and "
                  "scan_bwd_reduce_kernel (the clusters' parts of db, dc in "
                  "order)", "ptxas": tf["k9_bwd_ptxas"],
        "max_abs_err": MAX_ERR["mamba_scan_bwd"],
        "max_rel_err": MAX_REL["mamba_scan_bwd"],
        "max_rel_err_vs_segmented": MAX_REL["mamba_scan_bwd_seg"],
        "ms": t9b["ms"], "plain_ms": t9b["plain_ms"],
        "bound_ms": t9b["bound_ms"], "bound_by": t9b["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes a selective scan's "
                   "backward", "shape": t9b["shape"],
        "bound_binds": t9b["binds"], "bound_exp_ms": t9b["bound_exp_ms"],
        "bound_fma_ms": t9b["bound_fma_ms"],
        "bound_bytes_ms": t9b["bound_bytes_ms"],
        "scratch_bytes": t9b["scratch_bytes"], "cluster": t9b["cluster"],
        "zamba2_scratch_bytes": z9b["scratch_bytes"],
        "max_rel_err_vs_mirror": MAX_REL["mamba_scan_bwd_mirror"],
        "zamba2_ms": z9b["ms"], "zamba2_plain_ms": z9b["plain_ms"],
        "zamba2_bound_ms": z9b["bound_ms"], "zamba2_shape": z9b["shape"],
        "planted_faults_over_limit": {
            k: v["over_limit"] for k, v in
            tf["k9_bwd_parity"]["planted_faults"].items()}
        })
    nem = dense["nemotron"]
    t8, b8 = nem["k8_times"], nem["batched_decode"]["k8"]
    g8 = k6["k8_times"]
    kernels.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": K8_SOURCE, "replaces": K8_REPLACES,
        "launches": nem["decode"]["k8_launches"],
        "kernel": "pd_hopper_kernel (the TMA route: a TMA ring of K/V tiles "
                  "through the page table, mma.sync, the split merge in the "
                  "same launch)",
        "launches_by_route": nem["decode"]["k8_routes"], "ptxas": k8_ptx,
        "max_abs_err": MAX_ERR["paged_decode_attention"],
        "max_rel_err_per_bh": MAX_REL["paged_decode_attention"],
        "ms": t8["ms"], "ms_host": t8["ms_host"], "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
        "library_ms": t8["library_ms"],
        "library": "scaled_dot_product_attention(enable_gqa=True) with the "
                   "gather through the page table",
        "library_ms_no_gather": t8["library_ms_no_gather"],
        "shape": "nemotron-4-15b decode layer 0, batch 1 after 32768 "
                 "tokens, q 1x48x128 bf16, pages 257x128x8x128",
        "launches_per_step": nem["decode"]["k8_launches_per_step"],
        "batch8_ms": b8["ms"], "batch8_plain_ms": b8["plain_ms"],
        "batch8_bound_ms": b8["bound_ms"],
        "batch8_library_ms": b8["library_ms"],
        "batch8_library_ms_no_gather": b8["library_ms_no_gather"],
        "gemma2_ms": g8["ms"], "gemma2_plain_ms": g8["plain_ms"],
        "gemma2_bound_ms": g8["bound_ms"],
        "minicpm_ms": dense["minicpm"]["k8_times"]["ms"],
        "minicpm_bound_ms": dense["minicpm"]["k8_times"]["bound_ms"],
        **{f"{key}_{f}": rec["k8_times"][f] for key, rec in (
            ("granite_moe", gm), ("zamba2", zb), ("phi35_moe", ph))
           for f in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "launches_by_route_moe_hybrid": {
            "granite-moe-3b-a800m": gm["decode"]["k8_routes"],
            "zamba2-1.2b": zb["decode"]["k8_routes"],
            "phi3.5-moe-42b-a6.6b (8 layers)": ph["decode"]["k8_routes"]},
        "launches_per_step_moe_hybrid": {
            "granite-moe-3b-a800m": gm["decode"]["k8_launches_per_step"],
            "zamba2-1.2b": zb["decode"]["k8_launches_per_step"],
            "phi3.5-moe-42b-a6.6b (8 layers)": ph["decode"][
                "k8_launches_per_step"]},
        **fe_keys(lambda r: r["serve"]["k8_times"]),
        "launches_by_route_frontend": {
            a: fe[a]["serve"]["decode"]["k8_routes"] for a in FRONTEND_ARCHS},
        "launches_per_step_frontend": {
            a: fe[a]["serve"]["decode"]["k8_launches_per_step"]
            for a in FRONTEND_ARCHS},
        "launches_per_step_mesh": {
            f"{MESH_ARCH} on a (1, 1) mesh, {k}": n
            for k, n in mesh["k8_launches_per_step"].items()}})
    print(json.dumps({"to_port": to_port_bounds()}))
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
