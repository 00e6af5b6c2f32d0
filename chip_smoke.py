#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA.  It needs one card
and no network, builds the kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (into the git-ignored ``build/``), and imports nothing of
JAX or of the JAX reference package.  Phases, one JSON line each:

1. device    — name, capability (must be 9.0), nvidia-smi name and power
               limit (also printed raw on a line of its own);
2. build     — the seven libraries, one nvcc each, started together:
               seconds and ptxas's resource report;
3. kernels   — the per-step pair (B1, B2) against their plain PyTorch
               versions on the card, bit for bit: B1 at every
               (Q, C) of tests/_torch_cases.py::STEP_SHAPES (C = 1, 3,
               6, 33, (32, 768), (224, 3072), rows wider than one pass),
               on planes 1-3 words past a 16-byte boundary, and on empty
               rows under clocks at and past BIG_NS; B2 at (Q, C) in
               {(4, 7), (32, 768), (224, 3072)} and K in {1, 4}, with
               every edge case of the contract; then each timed at the
               ring-16 full-width shape, beside its plain version, its
               bound, the card's launch floor (a one-element fill_) and
               a load-then-store floor (one copy_ of B2's 32 lanes'
               int32 words);
4. multistep — the multi-step kernel (B3) against its plain version on
               packed carries of real plans (tests/_torch_cases.py):
               the three cells' specs plus ring-16 at a binding capacity
               under credit, drop and on/off, ring-32 with per-link
               timing and max_burst 2 under on/off, the 2x4 mesh
               multicast (K = 2) under credit, a 14x14 mesh multicast
               (K = 3, 1,092 lanes) under credit, ring-3 with clocks near
               and past BIG_NS, ring-16 hot spots whose q_time plane just
               fits shared memory and does not, and ring-40 (two warps of
               links), 300 steps each at chunk 1, 16 and/or 128
               (launches with base > 0, max_steps binding mid-chunk),
               every shared-memory tier among them, the kernel's and the
               wrapper's layouts held equal; and one B = 3 launch (the
               three binding ring-16 cases) against their solo plain
               runs; then one launch timed at full width with CUDA events
               and the profiler, beside its bound and its plain version;
5. anchor    — the paper's Fig. 8 cell (ring-2 ping-pong, 1024 events a
               side, max_burst 1) through the per-step kernel engine:
               28.6 MEv/s within 0.1 %, and equal to
               ``protocol_sim.simulate``;
6. full      — ring-16 hot-spot (48 events a chip, mean gap 300 ns,
               hot_frac 0.65, capacity 64, credit flow): the per-step
               kernel engine, replayed from the CUDA graph that compile
               captured for its bucket (runners are shared by bucket),
               every event delivered, no drops, and exactly max_steps
               launches of each kernel; then an 8-chip in-fabric
               multicast run with K > 1; each against
               ``engine="reference"`` (the eager loop of the plain
               step) field for field, run on the host in a process of
               its own while the card phases go on and compared before
               the card's last line (``<cell>_reference``); each
               with its graph's replays, capture and instantiate seconds,
               the replays' span on the card (CUDA events) beside the
               host time that issued them, and peak memory; then the
               ring-16 cell cut to 34, 66, 100 and 130 steps, on either
               side of network.GRAPH_MIN_REPLAYS, each equal to
               ``engine="reference"`` and timed end to end;
7. multistep path — each of those three cells again through
               ``EngineSpec("pallas", kernel="multistep")`` at chunk 128:
               equal to its per-step result field for field, exactly
               ceil(max_steps / 128) B3 launches and no B1/B2 launch;
7a. ring     — each cell through ``engine="ring"`` (and ``"auto"``,
               which must resolve to it): compile captures the chunk's
               CUDA graph on a zero-event plan, two runs replay it
               without capturing again, each equal field for field to
               the per-step and multi-step results, no port kernel
               launched; steps until drain against the default bound,
               chunks, host syncs, capture and instantiate seconds, µs
               per executed step, ms per run beside the step-graph and
               multi-step runs, host operator calls a step and (ring-16)
               kernels a step from a profiled run;
7b. batch    — eight full_ring16_credit instances (seeds 2..9) through
               ``run_batch`` on the ring engine, the per-step kernel
               engine and the multi-step kernel, and four 2x4-mesh
               multicast instances on the ring engine: each instance
               equal to its solo run, the counts zeroed before each
               batch and read after it (B1 and B2 max_steps each, once a
               step for the whole batch; B3 ceil(max_steps / 128); the
               ring none), ms per batch beside B times the solo ms;
               then B1, B2 and B3 on the batch's operands against their
               plain versions and solo launches, and timed;
7c. verify_quarantine — the static verifier on the card: ring-4 with
               routes (0,1) and (3,1) looping, credit flow at capacity
               8, admitted ("acyclic-cdg") with those pairs quarantined;
               clean traffic on the ring, per-step and multi-step
               engines equal to ``engine="reference"``; traffic 0 -> 1
               refused at plan time and by ``verify(spec)``; the
               all-clockwise ring-4 at capacity 2, whose saturable cycle
               ``verify`` names, stalled for good (the same deliveries
               at 400 and 800 steps, no drops) on the ring and per-step
               engines; ``verify`` host ms on the two full cells;
7d. adaptive_ring16 — the reference benchmark's ADAPTIVE_RING (ring-16
               hot spot, 768 events, capacity 48, min_backlog over 4
               epochs, alpha 4, ema 0.5; traffic from the port's
               generator): static ``run_epochs`` and adaptive ``run``
               on the ring engine and the multi-step kernel; events
               conserved, tables rebuilt, no new runner after epoch 0,
               one ring graph for every epoch and run, B3 launched
               4 x ceil(bound / 128) times a run, the two engines'
               merged results equal; ms a run, drops and p99 both ways;
7e. adaptive_ring8_step — adaptive ring-8 (192 events, capacity 24)
               on the per-step kernel engine: equal to the ring's merged
               result, one step graph captured for all four epochs and
               none in a second run, B1 and B2 once a step;
7f. sweep    — ``Fabric.sweep`` on the ring (full_ring16_credit,
               seeds 2-4) and ``sweep_batch`` of eight seeds on the
               multi-step kernel: nothing captured or built while cells
               are timed, each result equal to its solo run;
8. profile   — torch.profiler windows of the full-width cell on both
               paths: device-busy share and time by kernel; for the
               per-step path also over its graph replays alone, where
               the profiler must record exactly GRAPH_STEPS B1 and B2
               calls a replay and the wrappers must count 2 + 8 *
               GRAPH_STEPS launches each; the run profiled is the
               profiler schedule's second step, after a warm-up step
               that starts the device tracing, and is followed in the
               recorded step by TAIL_KERNELS spin kernels, so its own
               records are neither the first nor the last of the
               window (the tail's records, and B1's and B2's over the
               whole profile, are reported);
9. lif       — the LIF kernel (B4) against its plain version on the card
               (tests/_torch_cases.py::lif_cases at the test shapes,
               (32, 128), (65536, 128), (33, 127) and a view 1 word past
               a 16-byte boundary, with the threshold and rounding edge
               inputs; every route of the kernel taken: vectors, vectors
               with a scalar tail, the scalar loop), bit for bit except
               where the plain version's float64 route rounds twice,
               each such element confirmed with exact rational
               arithmetic; then device ms per launch at (16, 128),
               (32, 128) and (65536, 128) beside the bound, the plain
               version and torch.add(v, i_syn, out=o) at that shape;
10. cosim    — the co-simulation cell COSIM_RING (ring-16 recurrent SNN,
               128 neurons a chip, 24 ticks): open loop equal to
               ``reference_rollout`` bit for bit with 24 B4 launches; the
               closed loop over ``kernel="multistep"`` and credit flow at
               capacity 96: conservation every tick, no drops, delivered
               > 0, divergence from the open loop >= 16, 24 B4 launches
               and sum(ceil(max_steps_t / 128)) B3 launches, no B1/B2;
               the three busiest ticks replayed through
               ``engine="reference"`` on the host, as phase 6's cells
               are (``cosim_tick<n>_reference``), field for field; ms
               per tick;
11. snn_fig6 — the Fig. 6 chip array (4x4 chips of 256 neurons, 50
               ticks): 50 B4 launches, finite bus figures, ms per tick;
12. profile_cosim — torch.profiler windows of the closed loop and of
               the Fig. 6 array: device-busy share and time by kernel;
12a. examples — the eight fabric and co-simulation examples
               (examples/torch_*.py: multi_chip_fabric,
               heterogeneous_links, multicast_fanout, lossless_hotspot,
               adaptive_hotspot, monte_carlo_sweep with its 64 seeds,
               closed_loop_snn, snn_chip_array), each through its
               ``main(["--device", "cuda"])`` with every assert of the
               script live, from an empty runner cache: a line a script
               with its wall seconds, the port kernels' launches (one B4
               launch a membrane update in the two co-simulations, 160
               and 24; none in the six fabric scripts, which take the
               ring engine) and the numbers it printed (its report in
               build/examples_torch/); then each fabric script's first
               scenario (the Monte-Carlo script's first seed) again under
               ``engine="pallas"``: max_steps launches of B1 and of B2,
               equal to the ring run field for field; then the two LM
               examples through their ``main``, asserts live:
               torch_train_lm_100m at TRAIN_EXAMPLE_ARGV (one restart
               from its checkpoint, no port kernel) and
               torch_sparse_allreduce_demo with no flag, on the card:
               its 8 ranks share the card over gloo (NCCL with 8
               cards), rank 0's B5 and B6 one a reference leaf a step
               under aer_topk and none under psum and bidir_ring, the
               ring's final loss within DEMO_RING_TOL of psum's;
13. aer      — the AER encoder (B5) and decoder (B6) against their plain
               versions on the card, bit for bit with NaN where NaN, on
               every case of tests/_torch_cases.py::aer_cases (float32
               and bfloat16, budget overflow, zero / NaN / infinite
               thresholds, -0.0 rows, rows with infinities and NaNs, the
               budget-th entry inside a 16-byte vector, exactly budget
               selected, non-finite entries past the budget, duplicate,
               rising and out-of-range decode addresses, one address
               across a 32-slot chunk's edge, blocks of 384, 1020, 1023,
               3072 and 4999, 65536-entry rows whose decode row leaves
               shared memory, the full-width (16384, 1024) weight and
               the 8-peer decode (131072, 128) -> (131072, 1024)) and of
               AER_ROUTE_CASES (x at odd storage offsets), with the
               route each call took; it fails if a route of either
               kernel was never taken.  Then B5 and B6 timed at
               (16384, 1024), budget 128, and B6 at the 8-peer decode,
               by profiler device time and by CUDA events, beside their
               bounds, registers and shared memory, plain versions and,
               for B6, scatter_add_, which B6 is also timed against in
               five rounds of B6, library, library, B6 (median and
               spread).  (``phase_aer_turns``, run by hand, times B5 and
               B6 in turns with another checkout's, e.g. a parent's);
14. aer_granite3_2b_layer — the slice's main path: five
               ``reduce_gradients(mode="aer_topk")`` steps over one
               granite-3.0-2b decoder layer's gradients (60.8 M float32
               entries, 9 leaves, fresh seeded draws each step) in a
               world of one over NCCL (an in-process HashStore, no
               network): exact conservation ``y == residual' + decoded``
               for every leaf, decoded values equal to y, the reduced
               value and residual' of every leaf equal bit for bit to
               the plain encoder and decoder's on the same tiles and
               thresholds, wire words equal to the events decoded, to
               the plain encoder's count and to min(mask total, budget)
               summed over blocks, exactly one B5 and one B6
               launch per leaf per step and no other kernel; ms per step
               and a profiled step's device-busy share and device time
               by group (B5, B6, the tau sort, copies, NCCL);
15. aer_compress_feedback — ``compress_with_feedback`` at its defaults
               on the ffn.wg.w gradient: exact mass conservation, one B5
               and one B6 launch;
16. scan     — the selective scan (B7) against its plain version on the
               card on every case of tests/_torch_cases.py::scan_cases(
               card=True) (the reference test's shapes, one-step
               sequences, widths that are not multiples of 32, 1 to 32
               states, subnormal and zero exp(dt·A), zero inputs, and
               falcon-mamba-7b's prefill shape (4, 2048, 8192, 16) and
               jamba-v0.1-52b's (2, 4096, 8192, 16), each with the
               model's real A and a softplus dt, and shapes at the
               kernel's tile edges): max abs and relative error of y and
               h_final, each within its stated tolerance, and whether
               each is bit-equal; then B7 timed at the serve shape with
               the profiler and with CUDA events, beside its bound and
               its plain version, and at jamba's shape beside its bound;
17. serve_falcon_mamba_7b — the slice's main path, through
               ``repro_torch.launch.serve``: falcon-mamba-7b at its full
               published widths and depth (64 layers, 7.27 B float32
               parameters drawn on the card from a seeded generator,
               bf16 compute), 4 SyntheticLM prompts of 2048 tokens
               prefilled, then 32 greedy tokens each: finite logits,
               tokens in the vocabulary, exactly 64 B7 launches in the
               run (a second prefill alone: 64, its last logits bit-equal
               to the first's; a decode step alone: 0) and no other
               kernel of the port; prefill ms, ms per decode step,
               tokens/s, peak memory, and a profiled decode step's
               device-busy share;
18. serve_consistency — the same weights in float32 compute: prefill's
               last logits and 8 teacher-forced decode steps' logits
               equal ``forward`` over the prompt and those tokens, to the
               stated tolerance (the reference's serving contract,
               tests/test_archs.py:88-114);
19. serve_granite_3_2b — the dense family through
               ``repro_torch.launch.serve``: granite-3-2b at its full
               published widths and depth (40 layers, d_model 2048, 32
               heads / 8 kv heads, d_ff 8192, vocab 49155 padded to
               49280; 2.63 B float32 parameters drawn on the card from a
               seeded generator, bf16 compute), 4 prompts of 2048 tokens
               and 32 greedy tokens: finite logits, tokens in the
               vocabulary, no launch of any port kernel (attention, the
               FFN and the MoE are PyTorch ops, as the reference's are
               jnp); prefill ms (first and again: the second prefill's
               last logits bit-equal to the first's, in every serving
               cell), ms per decode step,
               tokens/s, peak memory, a profiled decode step's busy
               share and time by group, and, timed apart with CUDA
               events, the step's attention core and its weight casts;
20. serve_consistency_dense — phase 18's check on granite's weights;
21. serve_mixtral_8x22b_l2 — the MoE family: mixtral-8x22b at its full
               widths (d_model 6144, 48 / 8 heads, 8 experts of d_ff
               16384, top-2, window 4096) with the depth cut from 56
               layers to 2 (``--layers 2``; stated in the line as
               ``reduced``), 2 prompts of 6144 tokens, past the window,
               so prefill builds the ring cache, then 32 greedy tokens;
               the same fields as phase 19 and the MoE's drop_frac;
22. serve_consistency_moe — phase 18's check on mixtral's weights with
               ``capacity_factor = num_experts / top_k``, which drops no
               token (checked: drop_frac == 0), on one 6144-token prompt,
               so the decode steps run on the ring cache;
23. serve_jamba_v01_52b_l8 — the hybrid family: jamba-v0.1-52b at its
               full widths (d_model 4096, 32 / 8 heads, 16 experts of
               d_ff 14336, top-2, Mamba d_inner 8192, N = 16, vocab
               65536) with the depth cut from 32 layers to one 8-layer
               period (every block kind; ``reduced`` in the line; ~13.3
               B float32 parameters), 2 prompts of 4096 tokens, 32
               greedy tokens: phase 19's fields, the MoE's drop_frac,
               exactly 7 B7 launches a prefill (one a Mamba layer) and 0
               a decode step, no other port kernel;
24. serve_consistency_hybrid — phase 18's check on jamba's weights, one
               prompt cut to its first 1024 tokens (stated in the line),
               ``capacity_factor = num_experts / top_k``: the forced
               decode steps run through the Mamba caches and the
               attention cache;
25. serve_llama32_vision_11b — the vision family: llama-3.2-11b-vision
               at its full widths and depth (40 layers, 8 of them gated
               cross-attention; d_model 4096, 32 / 8 heads, d_ff 14336,
               vocab 128256; ~9.8 B float32 parameters), every xgate set
               to 1.0 after the seeded init (stated in the line: at the
               reference's 0 the image changes nothing), 4 prompts of
               2048 tokens with 1600 stub image tokens of width 1280
               each, 32 greedy tokens: phase 19's fields, no port
               kernel, every cross-attention cache handed back unchanged
               by a decode step, and the last prefill logits moved by
               another seed's image;
26. serve_consistency_vision — phase 18's check on llama's weights with
               the gates at 1.0, on the first prompt and its image;
26a. serve_minitron_8b, serve_qwen3_14b — the dense family's other two
               at their full published widths and depth: minitron-8b
               (32 layers, d_model 4096, 32 / 8 heads, a squared-ReLU
               FFN of 16384, an untied 256,000-token head; 7.73 B
               float32 parameters) and qwen3-14b (40 layers, d_model
               5120, 40 / 8 heads of 128 with qk-norm in prefill and
               decode, d_ff 17408, vocab 151,936; 14.77 B), 4 prompts of
               2048 tokens and 32 greedy tokens each: phase 19's fields,
               no port kernel; each followed by phase 18's check on its
               first prompt (serve_consistency_minitron, _qwen3);
26b. serve_moonshot_v1_16b_a3b_l16 — fine-grained MoE: moonshot-v1-16b-
               a3b at its full widths (d_model 2048, 16 / 16 heads, 64
               experts of d_ff 1408, top-6, vocab 163,840) with the
               depth cut from 48 layers to 16 (``reduced``; all 48 are
               112.2 GB of float32 weights), 4 prompts of 2048 tokens,
               32 greedy tokens: phase 21's fields, and ``serve.generate``
               run a second time, its tokens and logits equal to the
               first run's (``moe._combine``: a fixed order, no
               atomics); then its first MoE
               layer on the first prompt row, on the card and on the
               host in float32 compute on the same input
               (``_dispatch_vs_host``: both drop the same share unless
               a top-6 choice differs); then phase 22's check
               (serve_consistency_moonshot);
27. score_hubert_xlarge — the encoder family through ``LM.score``:
               hubert-xlarge at its full widths and depth (48 layers,
               d_model 1280, 16 heads, GELU MLP 5120, vocab 504 padded
               to 512, bidirectional; ~0.95 B parameters), 8 utterances
               of 1024 stub frames of width 1280: finite (8, 1024, 512)
               logits, no padded id winning an argmax, no port kernel;
               in float32 compute, the last frame of utterance 0 moving
               its first frame's logits, and utterance 0 alone equal to
               its batch row within 2e-4 scaled; ms a scored batch (first
               and again), frames/s, peak memory, a profiled call's busy
               share and time by group.  Each phase from 23 on reports
               its seconds (``phase_s``).
28. scan_bwd_vs_plain — B7's backward kernel (csrc/selective_scan_bwd.cu,
               kernel work from a module: no TPU kernel) against
               ``ref.selective_scan_bwd`` on every ``scan_cases(card=
               True)`` case (subnormal and zero exp(dt·A), N = 1..32,
               widths off the tile edges, falcon's (4, 2048, 8192, 16)
               and jamba's shape), dh_final zero and random, each of the
               five gradients within its tolerance x max|plain|, and each
               run twice, bit-equal; then ``SelectiveScanFn`` on CUDA
               against autograd through the plain scan on CUDA at two
               small shapes (which cotangent goes where, dh_final's
               seeding), and scan_bwd_kernel_time: the kernel timed at
               the training shape with the profiler and CUDA events,
               beside its bound and its plain version;
29. train_falcon_mamba_7b_l16 — training through
               ``repro_torch.launch.train`` (``setup``, ``run``):
               falcon-mamba-7b at its full widths with the depth cut
               from 64 layers to 16 (``reduced``: its full state of
               float32 parameters, gradients and two moments is ~116
               GB), 4 x 2048 SyntheticLM tokens a step, bf16 products,
               "full" remat, 8 steps under deterministic algorithms:
               every metric finite each step, exactly 32 B7 launches a
               step (16 forward, 16 in the recompute) and 16 of its
               backward, no other port kernel; ms a step (first, median
               of the rest), tokens/s, peak memory, mfu (6 x params x
               tokens / (step s x 989e12)); a profiled step's busy share
               and time by group, the AdamW update and the chunked
               cross-entropy timed alone, two steps without
               deterministic algorithms;
30. train_granite_3_2b — the same for granite-3-2b at full widths and
               depth (40 layers, ~42 GB of state): no port kernel;
31. train_restart_drill — falcon-mamba's and granite's smoke configs on
               the card, 30 steps with a checkpoint every 5, clean and
               with failures at steps 7, 13 and 18: 3 restarts, the
               parameters and moments bit-equal to the clean run's, the
               last 5 steps' mean loss below the first 5's, and falcon's
               clean run exactly 60 B7 and 30 backward launches a Mamba
               layer;
32. train_dp_world1_equal — the data-parallel step
               (``make_train_step(..., rules)`` over
               ``make_host_mesh(data=1)`` and ``make_rules(fsdp=False)``)
               in a world of one over NCCL (an in-process HashStore; the
               machine has one card and NCCL refuses two ranks on one
               device; several ranks are held against the reference on
               the CPU): falcon-mamba-7b at full width with the depth cut
               to 2 layers, 4 x 2048 tokens, 3 steps under deterministic
               algorithms; ``psum``, ``ring`` and ``bidir_ring``
               parameters, moments and metrics bit-equal to
               ``rules=None``;
33. train_falcon_mamba_7b_l16_aer — the same data-parallel step on
               falcon-mamba-7b at full width, 16 of its 64 layers, 4 x
               2048 tokens, bf16 products, "full" remat, ``aer_topk``
               (frac 0.05, budget 128), 8 steps: finite metrics, each
               step exactly one B5 and one B6 launch a reference leaf
               (13), 32 B7 and 16 of its backward; ms a step (median of
               the last 6), ``aer_reduce`` ms by CUDA events, wire words
               against the 2.22 G dense words, peak memory; the
               embedding leaf's step-1 reduced gradient and residual
               bit-equal to the plain encoder and decoder's; a ninth
               step profiled (busy share, device time by group: B5,
               B6, the thresholds' sort, B7, products, copies,
               elementwise, NCCL); then the same cell under ``psum``, 4
               steps, for comparison;
34. dryrun_vs_card — the FLOP / byte counter (``launch.cost``) held
               against the card: phases 29 and 30's cells and one
               prefill and one decode step of phase 17's, each traced on
               ``meta`` (``launch.dryrun.trace_step``, no weight
               allocated) and then counted in one real step on the card:
               flops and bytes equal, B7 32 and its backward 16 a
               training step on both, the predicted peak (argument bytes
               plus the counter's peak of live bytes) beside
               ``max_memory_allocated``, ``mfu_counted`` (counted flops /
               (the uncounted phase's median step s x 989e12)) beside
               the 6·N·D mfu, and the step's roofline fraction
               (max(flops / 989e12, bytes / 3.35e12) / its time);
35. train_tp_2x2_one_card — training past data parallelism (A.11d):
               4 processes on cuda:0 over gloo (a FileStore in a
               temporary directory; 4 ranks time-share the one card, so
               its times are not multi-card figures), a (2, 2) mesh with
               FSDP, 3 steps at full width on 2 layers, 4 x 2048 tokens,
               float32 compute: falcon-mamba-7b under ``psum`` and
               ``aer_topk``, granite-3-2b under ``psum``; every rank's
               losses within 1e-4 of the whole run's (the world of one,
               freed before the spawn; for ``aer_topk`` the (2, 1)
               data-only mesh of 2 ranks, as the data-axis size changes
               its result), its gradient norm a step within 1e-4
               relative (1e-3 under ``aer_topk``), its gathered
               parameters within 2e-3 (6e-3, 2 lr a step, under
               ``aer_topk``) with at most a share of 1e-4 (2e-3) of them
               more than 1e-4 off, the largest gaps printed; two
               planted faults must fail that parameter check: the
               initial parameters (a step that updates nothing) and
               the world of one trained on data rank 0's rows alone (a
               step with the data reduction skipped); B7 4 and its
               backward 2 a falcon step on each rank, on 4096 of the
               8192 channels;
               B5 and B6 one a reference leaf; ms a step, peak memory
               and collectives a step a rank; then granite-3-2b and
               falcon-mamba-7b under ``psum`` with sequence parallelism
               (A.11e item 1: ``make_rules(seq_parallel=True)``, the
               residual stream between blocks each rank's 1024 of the
               2048 positions, checked), held against the same whole
               runs under the same limits, B7 still 4 and its backward
               2 a falcon rank a step, their ms, peak and collectives
               printed beside the plain cell's; last, one more step of
               the granite cell and of its SP cell on every rank under
               the cost counter (``launch.dryrun.trace_step``), whose
               flops, bytes and collectives by kind (counts and bytes)
               must equal the dry-run's ``meta`` trace of rank 0 of the
               same cell over an abstract (2, 2) mesh (same config,
               depth and batch), printed a line a cell beside the
               card's name and power limit;
36. serve_tp_2x2_one_card — serving a sharded model (A.11e): 4
               processes on cuda:0 over gloo (4 ranks time-share the
               card: not multi-card figures), a (2, 2) mesh without
               FSDP (two replicas of a model split in two), float32
               compute with TF32 off, a 4 x 2048 prompt and 16 decode
               steps: granite-34b (88 layers cut to 2, full width; one
               kv head, so its decode cache splits over its 2064
               slots, 1032 a rank) and falcon-mamba-7b (64 cut to 2;
               its state split over ``d_inner``); each held against
               the world of one (run first, freed before the spawn):
               every rank's prefill and teacher-forced decode logits
               within 1e-4 of max |logit|, greedy tokens equal where
               the margin allows, B7 2 a rank a falcon prefill on 4096
               of the 8192 channels; prefill ms, ms a decode step, peak
               memory and the collectives of a prefill and a decode
               step a rank, beside the card's name and power limit;
               then granite-34b again with sequence parallelism (A.11e
               item 1): each prefill block's residual stream 1024 of
               the 2048 positions a rank, checked, its decode steps
               whole on every rank with the plain cell's collectives,
               held against the same world of one and printed beside
               the plain cell; last, one more prefill and one decode
               step of each granite-34b cell (plain and SP; its cache
               split over the slots, so the decode counts the softmax
               combine) on every rank under the cost counter, equal to
               the dry-run's ``meta`` trace of rank 0, a line a cell
               beside the card's name and power limit;
36a. card_phases_done — the seconds from the start to the end of the
               card's last phase, before the pod dry-run is collected;
37. dryrun_pod — ``python -m repro_torch.launch.dryrun`` on every cell
               of ``--all`` (each arch x shape its ``shapes_for``
               lists, full width, the production shapes) on the 16 x 16
               pod mesh, on the ``meta`` device (no card, no weights),
               one process a cell, ``POD_WORKERS`` at a time, started
               after the build on the host's spare cores while the card
               phases run: the roofline table (``launch.roofline``) on
               its own lines (each traced program is rank 0's, so no
               collective term is a lower bound), then each cell's
               flops, bytes, collective bytes by mesh axis, argument and
               temporary bytes a device and whether they fit the card's
               80 GB, the wall time, and when its last cell ended
               (``ended_at_s``, seconds since the start).  The 2 x 16 x 16
               multi-pod mesh is traced on a CPU host (it doubles the
               phase).

Then the ``{"kernels": [...]}`` summary (B1–B7 and B7's backward), the
nvidia-smi line again and,
last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero and the last line is never printed.  Without
CUDA (or outside a checkout of the repository) it exits non-zero before
printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the training phases run under PyTorch's deterministic algorithms, which
# need this cuBLAS workspace setting before the process's first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate (data sheet)
# H100 SXM int32 rate: 64 INT32 lanes per SM and clock x 132 SMs x
# 1.98 GHz boost (the data sheet's 67 TFLOP/s fp32 counts 128 fp32 lanes
# and an FMA as two operations); the kernels' operations are int32
INT32_OPS_S = 64 * 132 * 1.98e9
# H100 SXM fp32 rate outside the tensor cores (data sheet; an FMA is two)
FP32_OPS_S = 67e12
ANCHOR_MEV_S, ANCHOR_TOL = 28.6, 0.001
# the cosim gate's floor on |closed - open| spike counts
# (benchmarks/fabric_smoke.py:494, MIN_COSIM_DIVERGENCE)
MIN_COSIM_DIVERGENCE = 16


#: the script's start on the host clock (each phase line carries its
#: seconds since, ``at_s``)
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - T0,
                      **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# The inputs (numpy, seeded) are the tests' own, in tests/_torch_cases.py:
# the queue kernels' edge cases (all-BIG_NS rows, fully released rows,
# ties, values next to BIG_NS, clocks at / past it, lanes whose queue id
# is >= Q), the cells' traffic, and the multi-step kernel's cases.

# --- timing --------------------------------------------------------------

def time_ms(fn, n=2000, warm=200) -> float:
    """Mean ms per call over ``n`` calls, timed with CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0)) or 0)


def _device_rows(prof):
    """``(device us, name, count)`` of the profile's device-side rows
    (kernels and copies), largest first.  Operator rows (``aten::...``)
    also carry the device time of the kernels they launched, so summing
    every row would count that time twice; so do the schedule's
    ``ProfilerStep#`` range and the slot engine's graph-replay range,
    which span their window on the device."""
    from torch.autograd import DeviceType
    from repro_torch.core.network import REPLAY_RANGE
    return sorted(((_device_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and _device_us(e) > 0
                   and not e.key.startswith("ProfilerStep")
                   and e.key != REPLAY_RANGE),
                  reverse=True)


def _op_rows_us(prof) -> float:
    """Device us that operator rows carry (the double count above)."""
    from torch.autograd import DeviceType
    return sum(_device_us(e) for e in prof.key_averages()
               if e.device_type != DeviceType.CUDA)


def device_ms(fn, n=500):
    """Mean device (kernel) ms per call over ``n`` calls, summed over the
    kernels the call launches, from torch.profiler; None when the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(r[0] for r in _device_rows(prof))
    return total_us / n / 1e3 if total_us > 0 else None


# --- phases --------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    check(tuple(cap) == (9, 0), f"capability {cap}, expected (9, 0)")
    return name, smi


LIBRARIES = ("fabric_queue", "fabric_queue_multistep", "lif_step",
             "aer_encode", "aer_decode", "selective_scan",
             "selective_scan_bwd")


def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        built = list(ex.map(_build.build, LIBRARIES))
    wall = time.perf_counter() - t0
    libs = {}
    for name, (path, secs, log) in zip(LIBRARIES, built):
        _build.load(name)
        libs[name] = {"library": str(path.relative_to(ROOT)),
                      "nvcc_s": secs,
                      "ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln
                                or "Compiling entry" in ln]}
    emit("build", wall_s=wall, libraries=libs)


def phase_kernels():
    """Bit-exactness on the card, then times at the full-width shape."""
    import numpy as np
    import torch
    from repro_torch.kernels import fabric_queue as fq
    from repro_torch.kernels import ref
    from _torch_cases import (STEP_OFFSETS, STEP_SHAPES, offset_tensor,
                              planes, scan_case, sentinel_scan_case,
                              update_case)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)

    def t(a):
        return torch.tensor(a, device=dev)

    def err_of(got, want):
        torch.cuda.synchronize()
        return max(int((g.long() - w.long()).abs().max()) for g, w in
                   zip(got, want))

    worst = {"fabric_queue_step": 0, "fabric_queue_update": 0}
    # B1: every shape; rows 1-3 words past a 16-byte boundary; empty
    # rows and values next to BIG_NS under clocks at and past it
    step_cases = []
    for nq, nc in STEP_SHAPES:
        q, qd, tq = scan_case(rng, nq, nc)
        want = ref.fabric_queue_scan(t(q), t(qd), t(tq))
        step_cases.append({"Q": nq, "C": nc, "err": {"wrapper": err_of(
            fq.fabric_queue_step(t(q), t(qd), t(tq)), want)}})
    for nq, nc in ((4, 3), (5, 33), (32, 768)):
        q, qd, tq = scan_case(rng, nq, nc)
        want = ref.fabric_queue_scan(t(q), t(qd), t(tq))
        for oq, od in STEP_OFFSETS:
            got = fq.fabric_queue_step(offset_tensor(q, dev, oq),
                                       offset_tensor(qd, dev, od), t(tq))
            step_cases.append({"Q": nq, "C": nc, "offsets_words": [oq, od],
                               "err": {"wrapper": err_of(got, want)}})
    for nq, nc in ((8, 1), (8, 33), (8, 768)):
        q, qd, tq = sentinel_scan_case(nq, nc)
        got = fq.fabric_queue_step(t(q), t(qd), t(tq))
        step_cases.append({"Q": nq, "C": nc, "sentinel_rows": True,
                           "err": {"wrapper": err_of(
                               got, ref.fabric_queue_scan(t(q), t(qd),
                                                          t(tq)))}})
    worst["fabric_queue_step"] = max(max(c["err"].values())
                                     for c in step_cases)
    cases = []
    for nq, nc in ((4, 7), (32, 768), (224, 3072)):
        for k in (1, 4):
            pl = planes(rng, nq, nc)
            lanes = update_case(rng, nq, nc, k)
            got = fq.fabric_queue_update(*map(t, pl), *map(t, lanes))
            want = ref.fabric_queue_update(*map(t, pl), *map(t, lanes))
            e2 = err_of(got, want)
            worst["fabric_queue_update"] = max(
                worst["fabric_queue_update"], e2)
            cases.append({"Q": nq, "C": nc, "K": k, "update_err": e2})
    emit("kernels_vs_plain", step_cases=step_cases, update_cases=cases,
         max_abs_err=worst, equal=all(v == 0 for v in worst.values()))
    check(all(v == 0 for v in worst.values()),
          f"kernels disagree with their plain versions: {worst}")

    # times at the ring-16 full-width shape: Q = 32, C = 768, 16 pop
    # lanes and 16 append lanes (K = 1)
    nq, nc, k = 32, 768, 1
    q, qd, tq = (t(a) for a in scan_case(rng, nq, nc))
    lanes = [t(a) for a in update_case(rng, nq, nc, k)]
    qplanes = [t(a) for a in planes(rng, nq, nc)]
    calls = {
        "fabric_queue_step": (
            lambda: fq.fabric_queue_step(q, qd, tq),
            lambda: ref.fabric_queue_scan(q, qd, tq)),
        "fabric_queue_update": (
            lambda: fq.fabric_queue_update(*qplanes, *lanes),
            lambda: ref.fabric_queue_update(*qplanes, *lanes)),
    }
    # device time per call (profiler) and per-call time of back-to-back
    # calls (CUDA events: bounded by the host's dispatch rate)
    timing = {name: {"device_ms": device_ms(kern),
                     "call_ms": time_ms(kern),
                     "plain_device_ms": device_ms(plain),
                     "plain_call_ms": time_ms(plain)}
              for name, (kern, plain) in calls.items()}
    # the card's launch floor: device time of a one-element fill_; and a
    # load-then-store floor: one copy_ of as many int32 words as B2 has
    # lanes (one load round trip, then a store, as B2's lanes take)
    one = torch.empty(1, dtype=torch.int32, device=dev)
    floor_ms = device_ms(lambda: one.fill_(1))
    words = lanes[0].numel() + lanes[2].numel()
    copy_ms = copy_floor_ms(words, dev)
    copy_kernel_ms = copy_floor_ms(words, dev, strided=True)
    # bounds from these inputs: each input read once, each output
    # written once (the update writes only its valid lanes)
    pop_q, pop_slot, app_q = (a.cpu().numpy() for a in lanes[:3])
    lp, la = len(pop_q), len(app_q)
    n_pop_w = int((pop_q < nq).sum())
    n_app_w = int((app_q < nq).sum())
    step_bytes = 4 * (nq * nc + nq + 6 * nq + nq)   # q_time, t_q, outs,
    step_ops = 4 * nq * nc                          # + head_route reads
    upd_bytes = 4 * (2 * lp + 5 * la + n_pop_w + 3 * n_app_w)
    upd_ops = lp + la
    bounds = {
        "fabric_queue_step": (step_bytes, step_ops),
        "fabric_queue_update": (upd_bytes, upd_ops),
    }
    out = {}
    for name, (b, o) in bounds.items():
        tb, to = b / HBM_BYTES_S * 1e3, o / INT32_OPS_S * 1e3
        tm = timing[name]
        seen = tm["device_ms"] is not None and \
            tm["plain_device_ms"] is not None
        out[name] = {"ms": tm["device_ms"] if seen else tm["call_ms"],
                     "plain_ms": (tm["plain_device_ms"] if seen
                                  else tm["plain_call_ms"]),
                     "ms_source": ("profiler device time per call" if seen
                                   else "CUDA events, back-to-back calls"),
                     **tm,
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "bytes": b, "ops": o,
                     "launch_floor_ms": floor_ms,
                     "copy_floor_ms": copy_ms,
                     "copy_kernel_floor_ms": copy_kernel_ms,
                     "above_copy_floor_us": (
                         None if tm["device_ms"] is None or copy_ms is None
                         else (tm["device_ms"] - copy_ms) * 1e3),
                     "max_abs_err": worst[name]}
    src = torch.arange(2 * words, dtype=torch.int32, device=dev)
    dst = torch.empty(words, dtype=torch.int32, device=dev)
    emit("kernel_times", shape={"Q": nq, "C": nc, "Lp": lp, "La": la},
         launch_floor_ms=floor_ms, copy_floor_ms=copy_ms,
         copy_kernel_floor_ms=copy_kernel_ms, copy_floor_words=words,
         copy_floor_rows={
             "contiguous": device_row_names(
                 lambda: dst.copy_(src[:words])),
             "stride 2": device_row_names(lambda: dst.copy_(src[::2]))},
         kernels=out)
    return out


def copy_floor_ms(words: int, dev, strided: bool = False):
    """Device ms of one ``copy_`` of ``words`` int32 words: a launch that
    loads and then stores, B2's floor at that many lanes.  PyTorch runs
    a contiguous copy as a device-to-device ``cudaMemcpyAsync``; from a
    stride-2 view (``strided``), as its elementwise copy kernel."""
    import torch
    src = torch.arange(2 * words, dtype=torch.int32, device=dev)
    src = src[::2] if strided else src[:words]
    dst = torch.empty(words, dtype=torch.int32, device=dev)
    return device_ms(lambda: dst.copy_(src))


def device_row_names(fn, n: int = 50) -> dict:
    """The device rows (kernels, copies) of ``n`` calls of ``fn`` in the
    profiler: each row's name and count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {r[1][:120]: r[2] for r in _device_rows(prof)}


def phase_multistep_kernel():
    """B3 against its plain version on the card, bit for bit, on packed
    carries of real plans; then one launch timed at full width."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.kernels import fabric_queue as fq
    from repro_torch.kernels import ref
    from _torch_cases import (BIG, MS_BATCH, MS_STEPS, carry_err, clone,
                              multistep_cases, multistep_operands,
                              run_schedule)
    dev = torch.device("cuda", 0)

    def plain(carry, consts, step_fn, steps=MS_STEPS, chunk=128):
        return run_schedule(
            lambda c, b, ch: ref.fabric_queue_multistep(
                c, consts, b, step_fn=step_fn, chunk=ch, max_steps=steps),
            clone(carry), steps, chunk)

    def kernel(carry, consts, chunk, max_burst, steps=MS_STEPS):
        return run_schedule(
            lambda c, b, ch: fq.fabric_queue_multistep(
                c, consts, b, chunk=ch, max_steps=steps,
                max_burst=max_burst),
            clone(carry), steps, chunk)

    def err_of(want, got, n_log):
        torch.cuda.synchronize()
        err = carry_err(want, got, n_log)
        check(err is not None, "multistep carry changed shape or dtype")
        return err

    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load("fabric_queue_multistep")
    limit = ctypes.c_int()
    _build.check(lib, lib.fabric_queue_multistep_smem_limit(limit),
                 "fabric_queue_multistep")
    check(limit.value == fq.H100_SMEM_OPTIN,
          f"shared memory a block may opt in to: {limit.value} bytes, "
          f"the tiers assume {fq.H100_SMEM_OPTIN}")
    t_ch = net._MS_LANES.index("t")
    cases, solo, worst = [], {}, 0
    for name, kw, arrays, chunks in multistep_cases():
        carry, consts, step_fn, plan = multistep_operands(kw, arrays,
                                                          MS_STEPS, dev)
        t0 = time.perf_counter()
        want = plain(carry, consts, step_fn)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        solo[name] = (carry, consts, want, plan)
        n_chips, n_routes, k = consts[1].shape
        shape = (plan.bucket[1], k, plan.C, n_chips, n_routes)
        for tier in range(len(fq.MS_TIERS)):
            check(lib.fabric_queue_multistep_layout_bytes(*shape, tier)
                  == min(fq.multistep_layout_bytes(*shape, tier), 2**31 - 1),
                  f"{name}: the kernel's and the wrapper's shared-memory "
                  f"layouts differ at tier {tier}")
        tier = fq.multistep_tier(*shape, limit.value)
        for chunk in chunks:
            err = err_of(want, kernel(carry, consts, chunk, plan.bucket[5]),
                         plan.E)
            worst = max(worst, err)
            cases.append({"case": name, "chunk": chunk,
                          "launches": -(-MS_STEPS // chunk),
                          "L": plan.bucket[1], "K": plan.bucket[7],
                          "C": plan.C, "tier": fq.MS_TIERS[tier],
                          "smem_bytes": fq.multistep_layout_bytes(*shape,
                                                                  tier),
                          "max_burst": plan.bucket[5], "flow": plan.fc,
                          "cap": plan.cap, "max_abs_err": err,
                          "delivered": int(want[6][0]),
                          "drops": int(want[6][1]),
                          "stall_steps": int(want[4][5].sum()),
                          "t_end_minus_big_ns":
                              int(want[3][t_ch].max()) - BIG,
                          "plain_s": plain_s})
    parts = [solo[n] for n in MS_BATCH]
    carry = tuple(torch.stack([p[0][j] for p in parts]) for j in range(7))
    consts = tuple(torch.stack([p[1][j] for p in parts]) for j in range(6))
    got = kernel(carry, consts, 128, parts[0][3].bucket[5])
    batch_err = max(err_of(p[2], tuple(g[i] for g in got), p[3].E)
                    for i, p in enumerate(parts))
    worst = max(worst, batch_err)
    emit("multistep_vs_plain", steps=MS_STEPS, cases=cases,
         batch={"instances": list(MS_BATCH), "chunk": 128,
                "max_abs_err": batch_err},
         max_abs_err=worst, equal=worst == 0)
    check(worst == 0, f"multistep kernel disagrees with its plain version "
                      f"(max abs err {worst})")
    by = {c["case"]: c for c in cases}
    check(by["ring16_drop"]["drops"] > 0, "drop case dropped nothing")
    check(by["ring16_credit_tight"]["stall_steps"] > 0
          and by["ring16_onoff"]["stall_steps"] > 0,
          "credit / on-off cases never stalled")
    check(by["mesh2x4_multicast"]["K"] == 2, "multicast case has K != 2")
    ring32, credit2, wide = (by[n] for n in (
        "ring32_perlink_burst_onoff", "mesh2x4_multicast_credit",
        "mesh14x14_multicast_credit"))
    check(ring32["L"] == 32 and ring32["max_burst"] == 2
          and ring32["stall_steps"] > 0,
          "ring-32 case: expected 32 links, max_burst 2 and on/off stalls")
    check(credit2["K"] == 2 and credit2["stall_steps"] > 0,
          "K = 2 credit case never stalled")
    check(wide["K"] == 3 and wide["L"] * wide["K"] > 1024
          and wide["stall_steps"] > 0,
          "14x14 case: expected K = 3, over 1024 lanes and credit stalls")
    check({c["tier"] for c in cases} == set(fq.MS_TIERS),
          f"the cases reach tiers {sorted({c['tier'] for c in cases})}, "
          f"not all of {fq.MS_TIERS}")
    tiers = {n: by[n]["tier"] for n in (
        "ring16_credit", "ring16_plane_just_fits", "ring16_plane_spills")}
    check(tiers == {"ring16_credit": "q_dest",
                    "ring16_plane_just_fits": "q_time",
                    "ring16_plane_spills": "tables"},
          f"ring-16 cases at tiers {tiers}")
    near = by["ring3_near_sentinel"]["t_end_minus_big_ns"]
    past = by["ring3_past_sentinel"]["t_end_minus_big_ns"]
    check(-512 < near < 0 and past >= 0,
          f"sentinel cases end {near} and {past} ns from BIG_NS")

    # one launch (base 0, chunk 128) at the full-width shape: the
    # ring-16 credit cell's reset-time carry, a fresh copy per launch
    kw, arrays = next((k, a) for n, k, a, _ in multistep_cases()
                      if n == "ring16_credit")
    carry, consts, step_fn, plan = multistep_operands(kw, arrays, None, dev)
    steps, chunk = plan.max_steps, 128
    base = torch.zeros(1, dtype=torch.int32, device=dev)
    n_steps = min(chunk, steps)

    def launch(c):
        return fq.fabric_queue_multistep(c, consts, base, chunk=chunk,
                                         max_steps=steps, max_burst=0)

    got = launch(clone(carry))
    want = plain(carry, consts, step_fn, steps=n_steps, chunk=chunk)
    timing_err = err_of(want, got, plan.E)
    check(timing_err == 0, "timed launch disagrees with its plain version")
    n = 50
    copies = [clone(carry) for _ in range(n)]
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for (a, b), c in zip(ev, copies):
        a.record()
        launch(c)
        b.record()
    torch.cuda.synchronize()
    event_ms = sum(a.elapsed_time(b) for a, b in ev) / n
    from torch.profiler import ProfilerActivity, profile
    copies = [clone(carry) for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in copies:
            launch(c)
        torch.cuda.synchronize()
    dev_us = sum(_device_us(e) for e in prof.key_averages()
                 if "fabric_queue_multistep" in e.key)
    device_ms = dev_us / n / 1e3 if dev_us > 0 else None
    reps = 2
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        plain(carry, consts, step_fn, steps=n_steps, chunk=chunk)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b) / reps
    # bounds from this launch's inputs: the carry read once and written
    # once plus the constants read once; the operations are the scan's
    # compare / select / min / count over every slot, every step (the
    # per-link and per-lane work is far smaller)
    L, q, c = plan.sizes.shape[0], 2 * plan.sizes.shape[0], plan.C
    byts = 2 * net.slot_carry_bytes(L, plan.E, c) + 4 + sum(
        4 * t.numel() for t in consts)
    ops = n_steps * 4 * q * c
    tb, to = byts / HBM_BYTES_S * 1e3, ops / INT32_OPS_S * 1e3
    out = {"ms": device_ms if device_ms is not None else event_ms,
           "ms_source": ("profiler device time per launch"
                         if device_ms is not None
                         else "CUDA events around each launch"),
           "device_ms": device_ms, "event_ms": event_ms,
           "us_per_step_event": event_ms / n_steps * 1e3,
           "plain_ms": plain_ms, "bound_ms": max(tb, to),
           "bound_by": "bytes" if tb >= to else "operations",
           "bytes": byts, "ops": ops,
           "scan_traffic_bound_ms": n_steps * q * c * 4 / HBM_BYTES_S * 1e3,
           "steps_per_launch": n_steps, "max_abs_err": worst}
    n_chips, n_routes, k = consts[1].shape
    emit("multistep_kernel_time",
         shape={"L": L, "Q": q, "C": c, "E": plan.E, "chunk": chunk,
                "carry_bytes": net.slot_carry_bytes(L, plan.E, c),
                "tier": fq.MS_TIERS[fq.multistep_tier(L, k, c, n_chips,
                                                      n_routes)]},
         **out)
    return out


def phase_anchor():
    import numpy as np
    import torch
    from repro_torch.core import network as net
    from repro_torch.core import protocol_sim as ps
    from repro_torch.core.fabric import Fabric, QueuePolicy
    from repro_torch.core.router import ring_topology
    from repro_torch.kernels import fabric_queue as fq
    from _torch_cases import anchor_arrays, spec_of
    n = 1024
    spec = spec_of(*anchor_arrays(n))
    fab = Fabric(ring_topology(2), queues=QueuePolicy(max_burst=1),
                 engine="pallas")
    cf = fab.compile(spec)
    check(cf.bucket == ("pallas", 1, 2048, 2048, 12480, 1, 2, 1, "step",
                        0), f"anchor bucket {cf.bucket}")
    torch.cuda.reset_peak_memory_stats()
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    t0 = time.perf_counter()
    res = cf.run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fq.fabric_queue_step.launches,
                fq.fabric_queue_update.launches)
    peak = torch.cuda.max_memory_allocated()
    thr = float(net.fabric_throughput_mev_s(res))
    err = abs(thr - ANCHOR_MEV_S) / ANCHOR_MEV_S
    sim = ps.simulate(np.zeros(n, np.int32), np.zeros(n, np.int32),
                      initial_tx=1, max_burst=1)
    torch.cuda.synchronize()
    act, t_tr = sim.trace.action.cpu().numpy(), sim.trace.t.cpu().numpy()
    d = int(res.delivered)
    dlv = res.log_del[:d].cpu().numpy()
    dst = res.log_dest[:d].cpu().numpy()
    same = (int(res.t_end) == int(sim.t_end)
            and res.sent.cpu().tolist() == [[int(sim.sent_l),
                                             int(sim.sent_r)]]
            and int(res.n_switches[0]) == int(sim.n_switches)
            and np.array_equal(np.sort(t_tr[act == ps.A_TX_L]),
                               np.sort(dlv[dst == 1]))
            and np.array_equal(np.sort(t_tr[act == ps.A_TX_R]),
                               np.sort(dlv[dst == 0])))
    RUN_WALL_S["step", "anchor"] = wall
    emit("anchor", thr_mev_s=thr, paper_mev_s=ANCHOR_MEV_S, rel_err=err,
         delivered=d, t_end=int(res.t_end), bucket=list(cf.bucket),
         launches=list(launches), wall_s=wall,
         us_per_step=wall / cf.bucket[4] * 1e6, graph=_per_step(cf.graph),
         peak_memory_bytes=peak, equals_simulate=same)
    check(err <= ANCHOR_TOL, f"anchor {thr} MEv/s off 28.6 by {err:.3%}")
    check(launches == (cf.bucket[4],) * 2 and cf.graph["replays"] > 0,
          f"anchor: launches {launches} over {cf.bucket[4]} steps, graph "
          f"{cf.graph}")
    check(same, "ring-2 fabric differs from protocol_sim.simulate")
    check(d == 2 * n, "anchor did not deliver every event")
    return ("anchor", dict(topo=ring_topology(2),
                           queues=QueuePolicy(max_burst=1)), spec, res)


#: wall seconds of one run by (path, cell), for the ring and batch
#: phases' comparisons
RUN_WALL_S: dict = {}
#: each cell's kernel="multistep" result (held against the ring engine)
MS_RESULTS: dict = {}


def _per_step(graph):
    """A run's graph report with the replays' span on the card (CUDA
    events) and the host time that issued them, per replayed step, and
    the host time of the first replay (issued to an idle card) per step
    of the graph."""
    g = dict(graph)
    if g["replays"]:
        n = g["replays"] * g["graph_steps"]
        g["replay_device_us_per_step"] = g["replay_device_s"] / n * 1e6
        g["replay_host_us_per_step"] = g["replay_host_s"] / n * 1e6
        g["first_replay_host_us_per_step"] = (g["first_replay_host_s"]
                                              / g["graph_steps"] * 1e6)
    return g


def _host_reference(fab_kw, spec):
    """``spec`` through ``engine="reference"`` (the eager loop of the
    plain step) on the host, one intra-op thread: ``(result, s)``.  Run
    in a process of its own by ``HostReference``."""
    import torch
    from repro_torch.core.fabric import Fabric
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    res = Fabric(**fab_kw, engine="reference", device="cpu").run(spec)
    return res, time.perf_counter() - t0


class HostReference:
    """Reference runs (``engine="reference"``) of card results, each in
    a process of its own on the host while the card phases go on: on
    the card the eager plain step is bound by the host's operator
    dispatch (4–9 ms a step on an H100's host, minutes for the full
    cells), and one host core runs it faster without holding up the
    card.  ``check`` waits for each and holds the card's result to it
    field for field; ``stop`` ends any still running."""

    def __init__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        self.pool = ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn"))
        self.runs: dict = {}

    def submit(self, label, fab_kw, spec):
        self.runs[label] = self.pool.submit(_host_reference, fab_kw, spec)

    def check(self, results: dict) -> None:
        from repro_torch.core import network as net
        for label, fut in self.runs.items():
            ref, secs = fut.result()
            res = results[label]
            net.assert_results_equal(res, ref,
                                     f"{label} against the host's reference")
            emit(f"{label}_reference", device="cpu", wall_s=secs,
                 equals_card=True, delivered=int(ref.delivered))
        self.pool.shutdown()

    def stop(self):
        self.pool.shutdown(wait=False, cancel_futures=True)


def _run_pair(fab_kw, spec, label, host_ref):
    """One spec through the kernel engine on the card, with its
    reference run handed to ``host_ref`` first; returns (kernel result,
    bucket, launches, wall seconds)."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import Fabric
    from repro_torch.kernels import fabric_queue as fq
    host_ref.submit(label, fab_kw, spec)
    fab = Fabric(**fab_kw, engine="pallas")
    cf = fab.compile(spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    t0 = time.perf_counter()
    res = cf.run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fabric_queue_step": fq.fabric_queue_step.launches,
                "fabric_queue_update": fq.fabric_queue_update.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = cf.bucket[4]
    RUN_WALL_S["step", label] = wall
    emit(label, bucket=list(cf.bucket), steps=steps,
         delivered=int(res.delivered), injected=res.injected,
         drops=int(res.drops), launches=launches, wall_s=wall,
         us_per_step=wall / steps * 1e6, graph=_per_step(cf.graph),
         peak_memory_bytes=peak,
         thr_mev_s=float(net.fabric_throughput_mev_s(res)),
         latency=net.latency_stats(res))
    check(all(v == steps for v in launches.values()),
          f"{label}: launches {launches}, expected {steps} each "
          f"(2·max_steps in all)")
    check(cf.graph["replays"] > 0, f"{label}: no graph replay "
          f"({cf.graph})")
    return res, cf, launches, wall


def phase_full(host_ref: HostReference):
    from repro_torch.core.fabric import MulticastPolicy, QueuePolicy
    from repro_torch.core.router import (AddressSpec, MulticastTable,
                                         mesh2d_topology, ring_topology)
    from _torch_cases import hot_spot_arrays, mesh_multicast_case, spec_of
    spec = spec_of(*hot_spot_arrays(16, 48, 300.0, 0.65, seed=2))
    kw = dict(topo=ring_topology(16),
              queues=QueuePolicy(capacity=64, flow="credit"))
    res, cf, launches, _ = _run_pair(kw, spec, "full_ring16_credit",
                                     host_ref)
    bucket = cf.bucket
    check(int(res.delivered) == res.injected and int(res.drops) == 0,
          "credit flow lost events")

    # in-fabric multicast on 8 chips with a branching tree (K = 2): on a
    # ring every tree node past the source has one way onward (K = 1), so
    # the 8-chip fabric here is the 2x4 mesh
    members, arrays = mesh_multicast_case(8 * 24)
    mspec = spec_of(*arrays)
    mkw = dict(topo=mesh2d_topology(2, 4), addr=AddressSpec(),
               mcast=MulticastPolicy("in_fabric", MulticastTable(members)))
    mres, mcf, _, _ = _run_pair(mkw, mspec, "multicast_mesh2x4", host_ref)
    mbucket = mcf.bucket
    check(mbucket[7] > 1, f"multicast K = {mbucket[7]}, expected > 1")
    check(int(mres.delivered) == mres.injected, "multicast lost events")
    cells = [("full_ring16_credit", kw, spec, res),
             ("multicast_mesh2x4", mkw, mspec, mres)]
    phase_short_runs(spec, kw)
    return spec, kw, bucket, launches, cells


#: step counts of the short runs: 34 leaves room for one graph replay
#: and stays eager, 66, 100 and 130 replay 2-4 times (GRAPH_STEPS = 32,
#: GRAPH_MIN_REPLAYS = 2)
SHORT_RUN_STEPS = (34, 66, 100, 130)


def phase_short_runs(spec, kw):
    """The ring-16 cell cut to SHORT_RUN_STEPS through the per-step
    kernel engine, in turns (up, then down): seconds of ``compile``
    (which captures each bucket's graph, once: the up pass) and of
    ``run``, and its plan, each result equal to ``engine="reference"``
    field for field.  Where a short run stops paying for its graph."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import Fabric
    fab = Fabric(**kw, engine="pallas")
    fab.run(spec, max_steps=SHORT_RUN_STEPS[-1])     # warm up
    runs, last = [], {}
    for n in SHORT_RUN_STEPS + SHORT_RUN_STEPS[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cf = fab.compile(spec, max_steps=n)     # captures a bucket's graph
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        last[n] = cf.run(spec, max_steps=n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g = getattr(cf, "graph", None) or {}
        runs.append({"steps": n, "wall_s": wall, "compile_s": compile_s,
                     "replays": g.get("replays"),
                     "captured_in_run": g.get("captured"),
                     "runner_captures": g.get("captures")})
    ref = Fabric(**kw, engine="reference")
    for n, res in last.items():
        net.assert_results_equal(res, ref.run(spec, max_steps=n),
                                 f"short run of {n} steps")
    emit("short_runs", graph_min_replays=getattr(net, "GRAPH_MIN_REPLAYS",
                                                 None),
         runs=runs, equals_reference=True)


def phase_multistep_path(cells):
    """Each cell through ``kernel="multistep"`` at chunk 128, held field
    for field against its per-step result (itself held against
    ``engine="reference"``); returns the launch counts by cell."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import EngineSpec, Fabric
    from repro_torch.kernels import fabric_queue as fq
    counted = {}
    for label, kw, spec, step_res in cells:
        cf = Fabric(**kw, engine=EngineSpec("pallas", kernel="multistep")
                    ).compile(spec)
        torch.cuda.synchronize()
        fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
        fq.fabric_queue_multistep.launches = 0
        t0 = time.perf_counter()
        res = cf.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(fq, k).launches for k in (
            "fabric_queue_step", "fabric_queue_update",
            "fabric_queue_multistep")}
        net.assert_results_equal(res, step_res, f"{label} multistep")
        MS_RESULTS[label] = res
        RUN_WALL_S["multistep", label] = wall
        steps, chunk = cf.bucket[4], cf.bucket[9]
        thr = float(net.fabric_throughput_mev_s(res))
        emit(f"{label}_multistep", bucket=list(cf.bucket), steps=steps,
             launches=launches, wall_s=wall, us_per_step=wall / steps * 1e6,
             equals_step=True, thr_mev_s=thr,
             delivered=int(res.delivered), drops=int(res.drops))
        check(chunk == 128, f"{label}: chunk {chunk}, expected 128")
        check(launches == {"fabric_queue_step": 0, "fabric_queue_update": 0,
                           "fabric_queue_multistep": -(-steps // chunk)},
              f"{label}: launches {launches}, expected ceil({steps} / "
              f"{chunk}) of fabric_queue_multistep and no other")
        if label == "anchor":
            check(abs(thr - ANCHOR_MEV_S) / ANCHOR_MEV_S <= ANCHOR_TOL,
                  f"multistep anchor reads {thr} MEv/s")
        counted[label] = launches
    return counted


def _ring_ops_per_step(cf) -> int:
    """PyTorch operator calls on the host of one ring step (the static
    step the graph captures: body plus copy-back), counted by the
    dispatcher on an extra step of the bucket's last runner (a drained
    carry: a no-op step; every run resets the carry)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        cf._last_runner._step_static()
    return Count.n


def phase_ring_engine(cells):
    """Each cell through ``engine="ring"`` and ``"auto"``: compile (step
    0 and the capture of the chunk's CUDA graph on a zero-event plan),
    then two runs that replay that graph without capturing again, each
    equal field for field to the cell's per-step result (itself equal to
    ``engine="reference"``) and its multi-step result; no kernel of the
    port launches.  Steps until drain against the default bound, chunks,
    host syncs, capture and instantiate seconds, µs per executed step,
    ms per run beside the step-graph and multi-step runs, host operator
    calls a step and, for the ring-16 cell, kernels a step from a
    profiled run of step 0 and two chunks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import network as net
    from repro_torch.core.fabric import Fabric
    out = {}
    t_phase = time.perf_counter()
    for label, kw, spec, step_res in cells:
        fab = Fabric(**kw, engine="ring")
        _counts_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cf = fab.compile(spec)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        warm = cf.graph
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cf.run(spec)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            g = cf.graph
            runs.append(dict(g, wall_s=wall))
            net.assert_results_equal(res, step_res, f"{label}: ring vs "
                                     f"step (= reference)")
            net.assert_results_equal(res, MS_RESULTS[label],
                                     f"{label}: ring vs multistep")
        launches = _counts()
        auto = Fabric(**kw)
        check(auto.engine.resolved == "ring", "auto is not the ring engine")
        net.assert_results_equal(auto.run(spec), step_res, f"{label} auto")
        ops = _ring_ops_per_step(cf)
        bound = fab._plan(spec, None).max_steps
        last = runs[-1]
        steps = last["steps"]
        RUN_WALL_S["ring", label] = last["wall_s"]
        prof_out = {}
        if label == "full_ring16_credit":
            # step 0 and two chunks: eight replays (a whole run's
            # ~900,000 kernel records take the profiler a minute)
            n_prof = 1 + 2 * cf.bucket[9]
            cf.run(spec, max_steps=n_prof)    # warm the allocator
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                cf.run(spec, max_steps=n_prof)
                torch.cuda.synchronize()
            g = cf.graph
            prof_out = _replay_window(prof,
                                      g["replays"] * g["graph_steps"])
            prof_out.pop("calls", None)
        out[label] = {"steps": steps, "wall_s": last["wall_s"],
                      "kernels_per_step": prof_out.get("kernels_per_step")}
        emit(f"{label}_ring", bucket=list(cf.bucket), default_bound=bound,
             steps=steps, steps_share_of_bound=steps / bound,
             chunk=last["chunk"], graph_steps=last["graph_steps"],
             chunks=last["chunks"],
             replays=last["replays"], host_syncs=last["host_syncs"],
             warm={k: warm.get(k) for k in ("captured", "capture_s",
                                            "instantiate_s", "captures")},
             compile_s=compile_s, runs=runs,
             us_per_executed_step=last["wall_s"] / steps * 1e6,
             replay_device_us_per_step=(
                 last["replay_device_s"] / (last["replays"]
                                            * last["graph_steps"]) * 1e6
                 if last["replays"] else None),
             ms_per_run={"ring": last["wall_s"] * 1e3,
                         "step_graph": RUN_WALL_S["step", label] * 1e3,
                         "multistep": RUN_WALL_S["multistep", label] * 1e3},
             host_ops_per_step=ops, profiled=prof_out,
             launches=launches, equals_step_and_multistep=True,
             delivered=int(res.delivered), injected=res.injected)
        check(warm["captured"] and warm["captures"] == 1,
              f"{label}: compile did not capture the ring graph ({warm})")
        check(all(not r["captured"] and r["captures"] == 1
                  and r["replays"] > 0 for r in runs),
              f"{label}: a run captured again or replayed nothing ({runs})")
        check(all(v == 0 for v in launches.values()),
              f"{label}: the ring engine launched port kernels {launches}")
        check(steps < bound, f"{label}: the ring ran its whole bound")
    emit("ring_engine", phase_s=time.perf_counter() - t_phase)
    return out


#: the batch phase's instances: ring-16 hot spots (full_ring16_credit's
#: traffic), seeds 2..9, and four 2x4-mesh multicast instances
BATCH_SEEDS = tuple(range(2, 10))
MESH_BATCH_SEEDS = (8, 9, 10, 11)


def phase_batch(ring_out):
    """B = 8 full_ring16_credit instances (seeds 2..9) through
    ``run_batch`` on the ring engine, the per-step kernel engine and
    the multi-step kernel, and B = 4 2x4-mesh in-fabric multicast
    instances on the ring engine: every instance equal field for field
    to its solo run (the multi-step path, the ring engine for the mesh),
    seed 2's also to the cell's per-step result; with the counts zeroed
    just before each batch and read just after, B1 and B2 launched once
    a step for the whole batch (max_steps each), B3 once a chunk
    (ceil(max_steps / 128)), the ring nothing; ms per batch beside B
    times the solo ms."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import (EngineSpec, Fabric, MulticastPolicy,
                                         QueuePolicy)
    from repro_torch.core.router import (AddressSpec, MulticastTable,
                                         mesh2d_topology, ring_topology)
    from _torch_cases import hot_spot_arrays, mesh_multicast_case, spec_of
    t_phase = time.perf_counter()
    kw = dict(topo=ring_topology(16),
              queues=QueuePolicy(capacity=64, flow="credit"))
    specs = [spec_of(*hot_spot_arrays(16, 48, 300.0, 0.65, seed=s))
             for s in BATCH_SEEDS]
    B = len(specs)
    ms_engine = EngineSpec("pallas", kernel="multistep")
    ms_fab = Fabric(**kw, engine=ms_engine)
    shared = max(ms_fab._plan(s, None).max_steps for s in specs)
    solo = [ms_fab.run(s, max_steps=shared) for s in specs]
    torch.cuda.synchronize()
    rows = {}
    for name, eng, reps in (("ring", "ring", 2), ("step", "pallas", 1),
                            ("multistep", ms_engine, 2)):
        fab = Fabric(**kw, engine=eng)
        walls = []
        for _ in range(reps):
            _counts_zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = fab.run_batch(specs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = _counts()
        cf = fab._compiled[fab.compiled_buckets[0]]
        g = cf.graph or {}
        for i, want in enumerate(solo):
            net.assert_results_equal(batch.instance(i), want,
                                     f"batch {name}/{i} vs solo")
        solo_ms = RUN_WALL_S[name, "full_ring16_credit"] * 1e3
        ms = walls[-1] * 1e3
        want_l = {"fabric_queue_step": shared if name == "step" else 0,
                  "fabric_queue_update": shared if name == "step" else 0,
                  "fabric_queue_multistep": (-(-shared // 128)
                                             if name == "multistep" else 0)}
        got_l = {k: launches[k] for k in want_l}
        rows[name] = {"instances": B, "max_steps": shared,
                      "ms_per_batch": ms, "walls_s": walls,
                      "solo_ms_seed2": solo_ms, "b_times_solo_ms": B * solo_ms,
                      "ms_per_instance": ms / B,
                      "launches": got_l, "expected_launches": want_l,
                      "graph": {k: v for k, v in g.items()
                                if k != "replay_events"}}
        check(got_l == want_l, f"batch {name}: launches {got_l}, expected "
                               f"{want_l}")
        check(all(v == 0 for k, v in launches.items() if k not in want_l),
              f"batch {name}: other kernels launched {launches}")
        if name == "ring":
            check(g["steps"] < shared and not g["captured"]
                  and g["captures"] == 1,
                  f"batch ring: graph {g}, bound {shared}")
    # B = 4 in-fabric multicast instances on the 2x4 mesh, ring engine
    mspecs, members = [], None
    for s in MESH_BATCH_SEEDS:
        members, arrays = mesh_multicast_case(8 * 24, seed=s)
        mspecs.append(spec_of(*arrays))
    mkw = dict(topo=mesh2d_topology(2, 4), addr=AddressSpec(),
               mcast=MulticastPolicy("in_fabric", MulticastTable(members)))
    mfab = Fabric(**mkw, engine="ring")
    solo_fab = Fabric(**mkw, engine="ring")     # one graph, four runs
    msolo = [solo_fab.run(s) for s in mspecs]
    walls = []
    for _ in range(2):
        _counts_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mbatch = mfab.run_batch(mspecs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    mlaunch = _counts()
    for i, want in enumerate(msolo):
        net.assert_results_equal(mbatch.instance(i), want,
                                 f"mesh batch/{i} vs solo ring")
        check(int(want.delivered) == want.injected,
              f"mesh instance {i} lost events")
    check(all(v == 0 for v in mlaunch.values()),
          f"mesh ring batch launched port kernels {mlaunch}")
    rows["ring_mesh2x4_multicast"] = {
        "instances": len(mspecs), "ms_per_batch": walls[-1] * 1e3,
        "walls_s": walls, "solo_ring_ms_mesh_cell": RUN_WALL_S.get(
            ("ring", "multicast_mesh2x4"), 0) * 1e3,
        "graph": {k: v for k, v in (mfab._compiled[
            mfab.compiled_buckets[0]].graph or {}).items()
            if k != "replay_events"}}
    emit("batch", engines=rows, equals_solo=True, ring_solo=ring_out,
         phase_s=time.perf_counter() - t_phase)
    return rows


def update_batch(rng, B, nq, nc, dev) -> tuple:
    """B2's operands for ``B`` instances of (nq, nc) planes: the planes
    stacked to (B·nq, nc) and each instance's pop and append lanes
    (``update_case``, K = 1) with its queue ids offset by b·nq (ids past
    an instance's queues stay past all of them), as int32 on ``dev``."""
    import numpy as np
    import torch
    from _torch_cases import planes, update_case

    def t(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    pls = [planes(rng, nq, nc) for _ in range(B)]
    lanes = [update_case(rng, nq, nc, 1) for _ in range(B)]
    glob = []
    for i in range(len(lanes[0])):
        parts = [np.where(np.asarray(ln[i]) < nq, np.asarray(ln[i]) + b * nq,
                          B * nq) if i in (0, 2) else np.asarray(ln[i])
                 for b, ln in enumerate(lanes)]
        glob.append(t(np.concatenate(parts)))
    big = [t(np.concatenate([p[i] for p in pls])) for i in range(3)]
    return big, glob


def phase_batch_kernels():
    """B1, B2 and B3 timed on a batch of eight ring-16 instances, each
    against its plain version on the same operands first: B1 on the
    (8·32, 768) rows, B2 on (8·32, 768) planes with 8·16 pop and 8·16
    append lanes at instance-offset ids, B3 one 128-step launch of the
    eight full_ring16_credit carries (seeds 2..9).  Returns ms per
    launch by kernel: profiler device time for B1 and B2, CUDA events
    for B3 (and the profiler's reading beside it)."""
    import numpy as np
    import torch
    from repro_torch.core.fabric import QueuePolicy
    from repro_torch.core.router import ring_topology
    from repro_torch.kernels import fabric_queue as fq
    from repro_torch.kernels import ref
    from _torch_cases import (carry_err, clone, hot_spot_arrays,
                              multistep_operands, scan_case)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(19)
    B, nq, nc = 8, 32, 768

    def t(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    cases = [scan_case(rng, nq, nc) for _ in range(B)]
    q, qd, tq = (t(np.concatenate([c[i] for c in cases])) for i in range(3))
    got = fq.fabric_queue_step(q, qd, tq)
    want = ref.fabric_queue_scan(q, qd, tq)
    torch.cuda.synchronize()
    err = {"fabric_queue_step": max(int((g.long() - w.long()).abs().max())
                                    for g, w in zip(got, want))}
    big, glob = update_batch(rng, B, nq, nc, dev)
    got = fq.fabric_queue_update(*[x.clone() for x in big], *glob)
    want = ref.fabric_queue_update(*[x.clone() for x in big], *glob)
    torch.cuda.synchronize()
    err["fabric_queue_update"] = max(int((g.long() - w.long()).abs().max())
                                     for g, w in zip(got, want))
    kw = dict(topo=ring_topology(16),
              queues=QueuePolicy(capacity=64, flow="credit"))
    ops8 = [multistep_operands(kw, hot_spot_arrays(16, 48, 300.0, 0.65,
                                                   seed=s), None, dev)
            for s in BATCH_SEEDS]
    carry = tuple(torch.stack([o[0][j] for o in ops8]) for j in range(7))
    consts = tuple(torch.stack([o[1][j] for o in ops8]) for j in range(6))
    steps = max(o[3].max_steps for o in ops8)
    base = torch.zeros(1, dtype=torch.int32, device=dev)

    def launch(c):
        return fq.fabric_queue_multistep(c, consts, base, chunk=128,
                                         max_steps=steps, max_burst=0)

    got = launch(clone(carry))
    worst = 0
    for i, (c, k, _, plan) in enumerate(ops8):
        one = fq.fabric_queue_multistep(tuple(x[None].clone() for x in c),
                                        tuple(x[None] for x in k), base,
                                        chunk=128, max_steps=steps,
                                        max_burst=0)
        torch.cuda.synchronize()
        e = carry_err(tuple(x[0] for x in one), tuple(g[i] for g in got),
                      plan.E)
        check(e is not None, "B3 batch carry changed shape")
        worst = max(worst, e)
    err["fabric_queue_multistep"] = worst
    check(all(v == 0 for v in err.values()),
          f"batched kernels disagree with their plain versions or solo "
          f"launches: {err}")
    n = 50
    copies = [clone(carry) for _ in range(n)]
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for c in copies:
        launch(c)
    b.record()
    torch.cuda.synchronize()
    b3_event = a.elapsed_time(b) / n
    from torch.profiler import ProfilerActivity, profile
    copies = [clone(carry) for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in copies:
            launch(c)
        torch.cuda.synchronize()
    dev_us = sum(_device_us(e) for e in prof.key_averages()
                 if "fabric_queue_multistep" in e.key)
    upd = [x.clone() for x in big]
    one = torch.empty(1, dtype=torch.int32, device=dev)
    times = {
        "fabric_queue_step": {
            "shape": f"({B}·{nq}, {nc})",
            "device_ms": device_ms(lambda: fq.fabric_queue_step(q, qd, tq)),
            "call_ms": time_ms(lambda: fq.fabric_queue_step(q, qd, tq))},
        "fabric_queue_update": {
            "shape": f"({B}·{nq}, {nc}), {B}·16 + {B}·16 lanes",
            "device_ms": device_ms(lambda: fq.fabric_queue_update(*upd,
                                                                  *glob)),
            "call_ms": time_ms(lambda: fq.fabric_queue_update(*upd, *glob)),
            "copy_floor_ms": copy_floor_ms(
                glob[0].numel() + glob[2].numel(), dev),
            "copy_kernel_floor_ms": copy_floor_ms(
                glob[0].numel() + glob[2].numel(), dev, strided=True),
            "launch_floor_ms": device_ms(lambda: one.fill_(1))},
        "fabric_queue_multistep": {
            "shape": f"B = {B}, ring-16 full width, 128 steps",
            "device_ms": dev_us / n / 1e3 if dev_us > 0 else None,
            "event_ms": b3_event}}
    for k, v in times.items():
        # B3's launch by CUDA events around back-to-back launches: the
        # profiler has dropped multi-step launches' records (PERF.md §7)
        v["ms"] = (v["event_ms"] if k == "fabric_queue_multistep"
                   else v["device_ms"] if v["device_ms"] is not None
                   else v["call_ms"])
        v["ms_source"] = ("CUDA events, back-to-back launches"
                          if k == "fabric_queue_multistep"
                          or v["device_ms"] is None
                          else "profiler device time per call")
        v["max_abs_err"] = err[k]
    emit("batch_kernel_times", kernels=times)
    return times


# --- the rest of the fabric API: verifier, adaptive routing, sweeps ------

def _all_captures() -> int:
    """CUDA graphs captured so far by every runner of the process."""
    from repro_torch.core import network as net
    return sum(getattr(r, "captures", 0) for r in net._RUNNERS.values())


def _loads() -> int:
    """Kernel libraries built or loaded so far."""
    from repro_torch.kernels import _build
    return _build.load.cache_info().misses


def _bent(topo, rt):
    """Ring(4) dest-1 bend: routes (0,1) and (3,1) loop 0 <-> 3 forever;
    the terminating routes' channel-dependency graph is acyclic."""
    from repro_torch.core.router import RoutingTable
    nl, os_ = rt.next_link.copy(), rt.out_side.copy()
    nl[0, 1], os_[0, 1] = 3, 1
    nl[3, 1], os_[3, 1] = 3, 0
    return RoutingTable(next_link=nl, out_side=os_, hops=rt.hops)


def _clockwise(topo, rt):
    """All-clockwise ring table: its channel-dependency graph is one
    cycle."""
    from repro_torch.core.router import RoutingTable
    n = rt.next_link.shape[0]
    nl, os_, hops = rt.next_link.copy(), rt.out_side.copy(), rt.hops.copy()
    for c in range(n):
        for d in range(n):
            if c != d:
                nl[c, d], os_[c, d], hops[c, d] = c, 0, (d - c) % n
    return RoutingTable(next_link=nl, out_side=os_, hops=hops)


def phase_verify_quarantine(cells):
    """The static verifier and the quarantine on the card.  Ring-4 with
    the bent table under credit flow at capacity 8 (the reference test's
    ``_bent_override``): admitted with certificate "acyclic-cdg" and
    route cycles {(0, 1), (3, 1)}; the clean six-event spec lossless on
    the ring, the per-step kernel engine and the multi-step kernel, each
    equal field for field to ``engine="reference"``; traffic 0 -> 1
    refused at plan time and by ``verify(spec)``.  The deadlock
    prediction: the all-clockwise ring-4 at capacity 2, whose saturable
    cycle ``verify(spec)`` names, delivers the same at 400 and 800 steps
    with no drops on the ring and the per-step engine.  Then
    ``verify(spec)``'s certificate and host ms on the two full cells."""
    import numpy as np
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import (EngineSpec, Fabric, QueuePolicy,
                                         StaticShortestPath)
    from repro_torch.core.router import ring_topology
    from _torch_cases import spec_of
    t_phase = time.perf_counter()
    kw = dict(topo=ring_topology(4),
              routing=StaticShortestPath(table_override=_bent),
              queues=QueuePolicy(capacity=8, flow="credit"))
    rep = Fabric(**kw).verify()
    cycles = sorted(map(tuple, rep.route_cycles.tolist()))
    check(rep.ok and rep.deadlock_free and rep.certificate == "acyclic-cdg"
          and cycles == [(0, 1), (3, 1)],
          f"bent ring-4: {rep.summary()} {cycles}")
    clean = spec_of([0, 1, 2, 3, 0, 2], [0, 0, 0, 0, 40, 40],
                    [2, 3, 0, 2, 3, 1])
    want = Fabric(**kw, engine="reference").run(clean)
    check(int(want.delivered) == want.injected and int(want.drops) == 0,
          "bent ring-4 lost events on engine='reference'")
    engines = {}
    for name, eng in (("ring", "ring"), ("step", "pallas"),
                      ("multistep", EngineSpec("pallas",
                                               kernel="multistep"))):
        _counts_zero()
        got = Fabric(**kw, engine=eng).run(clean)
        torch.cuda.synchronize()
        net.assert_results_equal(got, want, f"bent ring-4 on {name}")
        engines[name] = _counts()
    refused = {}
    bad = spec_of([0], [0], [1])
    try:
        Fabric(**kw).run(bad)
    except ValueError as err:
        refused["plan"] = str(err)
    check("quarantined" in refused.get("plan", ""),
          f"traffic 0 -> 1 was not refused at plan time ({refused})")
    bad_rep = Fabric(**kw).verify(bad)
    check(not bad_rep.ok and any(f.check == "route-termination"
                                 and f.severity == "error"
                                 for f in bad_rep.findings),
          f"verify(0 -> 1): {bad_rep.summary()}")
    # the deadlock prediction
    dkw = dict(topo=ring_topology(4),
               routing=StaticShortestPath(table_override=_clockwise),
               queues=QueuePolicy(capacity=2, flow="credit"))
    src = np.repeat(np.arange(4), 8)
    dspec = spec_of(src, np.arange(32) * 5, (src + 3) % 4)
    drep = Fabric(**dkw).verify(dspec)
    err = [f for f in drep.findings
           if f.severity == "error" and f.check == "cdg-cycle"]
    check(not drep.ok and err and all(
        ch in err[0].message
        for ch in ("L0:0->1", "L1:1->2", "L2:2->3", "L3:3->0")),
        f"clockwise ring-4: {drep.summary()}")
    stalls = {}
    for name, eng in (("ring", "ring"), ("step", "pallas")):
        a, b = (Fabric(**dkw, engine=eng).run(dspec, max_steps=m)
                for m in (400, 800))
        stalls[name] = [int(a.delivered), int(b.delivered), a.injected]
        check(int(a.delivered) == int(b.delivered) < a.injected
              and int(a.drops) == int(b.drops) == 0,
              f"clockwise ring-4 on {name}: {stalls[name]}, drops "
              f"{int(a.drops)}, {int(b.drops)}")
    host = {}
    for label, ckw, spec, _res in cells:
        fab = Fabric(**ckw)
        t0 = time.perf_counter()
        crep = fab.verify(spec)
        host[label] = {"certificate": crep.certificate, "ok": crep.ok,
                       "host_ms": (time.perf_counter() - t0) * 1e3,
                       "cdg_edges": crep.cdg_edges,
                       "clock_headroom_ns": crep.clock_headroom_ns}
        check(crep.ok, f"{label}: {crep.summary()}")
    emit("verify_quarantine", certificate=rep.certificate,
         route_cycles=cycles, clean_launches=engines,
         equals_reference=True, refused_at_plan=refused["plan"],
         deadlock={"error": err[0].message, "delivered_400_800_of": stalls},
         verify_cells=host, phase_s=time.perf_counter() - t_phase)


#: the reference benchmark's ADAPTIVE_RING (benchmarks/fabric_sweep.py):
#: ring-16 hot spot, 48 events a chip, capacity 48 (drop flow),
#: min_backlog over 4 epochs, alpha 4.0, ema 0.5; traffic from the
#: port's generator with this seed
ADAPTIVE_RING = dict(n_chips=16, seed=3, epc=48, capacity=48,
                     policy="min_backlog", epochs=4, alpha=4.0, ema=0.5)


def _adaptive_runs(fab_kw, engine, policy, spec, epochs, reps):
    """Static ``run_epochs`` then ``reps`` adaptive runs of ``spec`` on
    ``engine``; each timed to its end on the card, with the launch counts
    and the graph captures of the adaptive runs."""
    import torch
    from repro_torch.core.adaptive import AdaptiveRouting
    from repro_torch.core.fabric import Fabric
    out = {}
    fab = Fabric(**fab_kw, engine=engine)
    torch.cuda.synchronize()
    c0 = _all_captures()
    t0 = time.perf_counter()
    out["static"] = fab.run_epochs(spec, epochs=epochs)
    torch.cuda.synchronize()
    out["static_s"] = time.perf_counter() - t0
    out["static_captures"] = _all_captures() - c0
    out["capture"] = getattr(fab._get_compiled(
        fab.last_report.buckets[0])._last_runner, "capture_stats", {})
    afab = Fabric(**fab_kw, engine=engine, routing=AdaptiveRouting(**policy))
    out["adaptive_s"], out["adaptive_launches"] = [], []
    out["adaptive_captures"] = []
    for _ in range(reps):
        _counts_zero()
        c0 = _all_captures()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = afab.run(spec)
        torch.cuda.synchronize()
        out["adaptive_s"].append(time.perf_counter() - t0)
        out["adaptive_launches"].append(_counts())
        out["adaptive_captures"].append(_all_captures() - c0)
    out["adaptive"], out["report"], out["fabric"] = res, afab.last_report, afab
    out["epoch_steps"] = _epoch_steps(afab, spec)
    return out


def _epoch_steps(fab, spec) -> list:
    """Steps each epoch of an (untimed) epoched run of ``spec`` ran, as
    its engine reports them (None where it reports none)."""
    from repro_torch.core.fabric import Fabric
    steps, real = [], Fabric._run_single

    def counted(self, part, *, max_steps=None):
        res = real(self, part, max_steps=max_steps)
        g = self._get_compiled(self._plan(part, max_steps).bucket).graph
        steps.append((g or {}).get("steps"))
        return res

    Fabric._run_single = counted
    try:
        fab.run(spec)
    finally:
        Fabric._run_single = real
    return steps


def phase_adaptive_ring16():
    """ADAPTIVE_RING on the ring engine and ``kernel="multistep"``:
    static ``run_epochs`` and the adaptive ``run`` (twice).  Per engine:
    delivered + drops == injected, the tables changed after epoch 0, no
    new runner after epoch 0 (``recompiled`` False), on the ring one
    graph capture at most in all (none in the adaptive runs after the
    static one bound the runner) and the runner's ``captures`` 1, B3
    launched sum(ceil(bound / 128)) times an adaptive run; the merged
    adaptive results of the two engines equal field for field.  Not a
    gate: adaptive beating static (the reference's strict-win test
    fails)."""
    import numpy as np
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.adaptive import partition_epochs, shared_max_steps
    from repro_torch.core.fabric import EngineSpec, Fabric, QueuePolicy
    from repro_torch.core.router import ring_topology
    from repro_torch.core.traffic import hot_spot
    t_phase = time.perf_counter()
    cfg = ADAPTIVE_RING
    gen = torch.Generator().manual_seed(cfg["seed"])
    spec = hot_spot(gen, cfg["n_chips"], cfg["epc"])
    fab_kw = dict(topo=ring_topology(cfg["n_chips"]),
                  queues=QueuePolicy(capacity=cfg["capacity"]))
    policy = {k: cfg[k] for k in ("policy", "epochs", "alpha", "ema")}
    parts = partition_epochs(spec, cfg["epochs"])
    bound = shared_max_steps(Fabric(**fab_kw), parts,
                             detour_factor=1.0 + cfg["alpha"])
    rows, merged = {}, {}
    for name, eng in (("ring", "ring"),
                      ("multistep", EngineSpec("pallas",
                                               kernel="multistep"))):
        out = _adaptive_runs(fab_kw, eng, policy, spec, cfg["epochs"], 2)
        res, rep = out["adaptive"], out["report"]
        static = out["static"]
        cf = out["fabric"]._get_compiled(rep.buckets[0])
        for label, r in (("adaptive", res), ("static", static)):
            check(int(r.delivered) + int(r.drops) == r.injected,
                  f"{name} {label}: {int(r.delivered)} + {int(r.drops)} "
                  f"!= {r.injected}")
        check(not rep.recompiled and len(rep.buckets) == 1,
              f"{name}: recompiled {[r.cache_size for r in rep.records]}")
        check(any(not np.array_equal(rep.records[0].table.next_link,
                                     r.table.next_link)
                  for r in rep.records[1:]),
              f"{name}: the tables never changed")
        stats = cf.graph or {}
        lat = {k: net.latency_stats(r)["p99_ns"]
               for k, r in (("static", static), ("adaptive", res))}
        want_b3 = cfg["epochs"] * -(-bound // 128)
        rows[name] = {
            "bucket": list(rep.buckets[0]), "epoch_bound": bound,
            "static_ms": out["static_s"] * 1e3,
            "adaptive_ms": [s * 1e3 for s in out["adaptive_s"]],
            "drops": {"static": int(static.drops),
                      "adaptive": int(res.drops)},
            "p99_ns": lat, "delivered": int(res.delivered),
            "injected": res.injected,
            "cache_sizes": [r.cache_size for r in rep.records],
            "static_captures": out["static_captures"],
            "adaptive_captures": out["adaptive_captures"],
            "runner_captures": stats.get("captures"),
            "runner_capture": out["capture"],
            "epoch_steps": out["epoch_steps"],
            "launches": out["adaptive_launches"][-1],
            "expected_b3_launches": want_b3 if name == "multistep" else 0}
        if name == "ring":
            check(out["static_captures"] <= 1
                  and out["adaptive_captures"] == [0, 0]
                  and stats.get("captures") == 1,
                  f"ring: captures static {out['static_captures']}, "
                  f"adaptive {out['adaptive_captures']}, runner "
                  f"{stats.get('captures')}")
            check(all(v == 0 for v in out["adaptive_launches"][-1].values()),
                  f"ring launched port kernels "
                  f"{out['adaptive_launches'][-1]}")
        else:
            got = out["adaptive_launches"][-1]
            check(got["fabric_queue_multistep"] == want_b3
                  and got["fabric_queue_step"] == 0
                  and got["fabric_queue_update"] == 0,
                  f"multistep launches {got}, expected {want_b3} of B3")
        merged[name] = res
    net.assert_results_equal(merged["ring"], merged["multistep"],
                             "adaptive ring vs multistep")
    emit("adaptive_ring16", config=cfg, events=spec.n_events,
         slices=[p.n_events for p in parts], engines=rows,
         ring_equals_multistep=True, phase_s=time.perf_counter() - t_phase)
    return rows


def phase_adaptive_ring8_step():
    """The per-step kernel engine under adaptive routing: ring-8, 24
    hot-spot events a chip, capacity 24, 4 epochs, alpha 4.0, equal
    field for field to the ring engine's merged result; one step-graph
    capture for all four epochs (the clones share the bucket's runner);
    a second adaptive run captures nothing; B1 and B2 launched once a
    step (4 x the shared bound each)."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.adaptive import (AdaptiveRouting, partition_epochs,
                                           shared_max_steps)
    from repro_torch.core.fabric import Fabric, QueuePolicy
    from repro_torch.core.router import ring_topology
    from repro_torch.core.traffic import hot_spot
    t_phase = time.perf_counter()
    spec = hot_spot(torch.Generator().manual_seed(4), 8, 24)
    kw = dict(topo=ring_topology(8), queues=QueuePolicy(capacity=24),
              routing=AdaptiveRouting(policy="min_backlog", epochs=4,
                                      alpha=4.0))
    ring = Fabric(**kw, engine="ring").run(spec)
    bound = shared_max_steps(Fabric(**kw), partition_epochs(spec, 4),
                             detour_factor=5.0)
    fab = Fabric(**kw, engine="pallas")
    runs = []
    for i in range(2):
        _counts_zero()
        c0 = _all_captures()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fab.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        net.assert_results_equal(res, ring, f"adaptive step run {i} vs ring")
        rep = fab.last_report
        g = fab._get_compiled(rep.buckets[0]).graph or {}
        runner = fab._get_compiled(rep.buckets[0])._last_runner
        runs.append({"ms": wall * 1e3, "captures": _all_captures() - c0,
                     "runner_captures": g.get("captures"),
                     "runner_capture": dict(runner.capture_stats),
                     "replays_last_epoch": g.get("replays"),
                     "launches": _counts(),
                     "cache_sizes": [r.cache_size for r in rep.records]})
        check(not rep.recompiled, f"step run {i}: recompiled")
    want = 4 * bound
    check(runs[0]["captures"] == 1 and runs[1]["captures"] == 0
          and runs[1]["runner_captures"] == 1,
          f"step graph captures {[r['captures'] for r in runs]}, runner "
          f"{runs[1]['runner_captures']}")
    for r in runs:
        check(r["launches"]["fabric_queue_step"] == want
              and r["launches"]["fabric_queue_update"] == want
              and r["launches"]["fabric_queue_multistep"] == 0,
              f"step launches {r['launches']}, expected {want} of B1, B2")
    emit("adaptive_ring8_step", epoch_bound=bound, runs=runs,
         equals_ring=True, delivered=int(res.delivered),
         drops=int(res.drops), injected=res.injected,
         phase_s=time.perf_counter() - t_phase)
    return runs


def phase_sweep(batch_rows):
    """``Fabric.sweep`` on the ring engine over full_ring16_credit's
    traffic at seeds 2-4, each cell equal to its solo run and no graph
    captured or kernel built while cells are timed; then ``sweep_batch``
    of those eight seeds (2-9) on ``kernel="multistep"``, warm, then
    timed again with nothing captured or built, each instance equal to
    its solo multi-step run.  ``us_per_call`` and ``us_per_instance``
    beside the solo ring run of phase ring_engine and the batch phase's
    ms per instance."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import EngineSpec, Fabric, QueuePolicy
    from repro_torch.core.router import ring_topology
    from _torch_cases import hot_spot_arrays, spec_of
    t_phase = time.perf_counter()
    kw = dict(topo=ring_topology(16),
              queues=QueuePolicy(capacity=64, flow="credit"))
    specs = [spec_of(*hot_spot_arrays(16, 48, 300.0, 0.65, seed=s))
             for s in BATCH_SEEDS]
    fab = Fabric(**kw, engine="ring")
    for s in specs[:3]:
        fab.compile(s)
    c0, l0 = _all_captures(), _loads()
    cells = fab.sweep(specs[:3])
    c1, l1 = _all_captures(), _loads()
    check(c1 == c0 and l1 == l0, f"sweep: captures {c0} -> {c1}, loads "
                                 f"{l0} -> {l1} while cells were timed")
    for s, c in zip(specs[:3], cells):
        net.assert_results_equal(c.result, Fabric(**kw, engine="ring")
                                 .run(s), "sweep cell vs solo")
    ms_engine = EngineSpec("pallas", kernel="multistep")
    mfab = Fabric(**kw, engine=ms_engine)
    first = mfab.sweep_batch(specs)
    torch.cuda.synchronize()
    c0, l0 = _all_captures(), _loads()
    cell = mfab.sweep_batch(specs)
    c1, l1 = _all_captures(), _loads()
    check(c1 == c0 and l1 == l0, f"sweep_batch: captures {c0} -> {c1}, "
                                 f"loads {l0} -> {l1}")
    shared = cell.bucket[4]
    for i, s in enumerate(specs):
        net.assert_results_equal(cell.result.instance(i),
                                 mfab.run(s, max_steps=shared),
                                 f"sweep_batch instance {i} vs solo")
    emit("sweep", ring_us_per_call=[c.us_per_call for c in cells],
         ring_solo_ms=RUN_WALL_S["ring", "full_ring16_credit"] * 1e3,
         multistep_batch={"instances": len(specs),
                          "first_us_per_call": first.us_per_call,
                          "us_per_call": cell.us_per_call,
                          "us_per_instance": cell.us_per_instance,
                          "batch_phase_ms_per_instance":
                              batch_rows["multistep"]["ms_per_instance"]},
         captures_while_timed=0, builds_while_timed=0, equals_solo=True,
         phase_s=time.perf_counter() - t_phase)


def aten_ops_per_step(fab, spec, steps=None) -> float:
    """PyTorch operator calls on the host per micro-transaction
    (dispatcher count over a ``steps``-step run of the fabric's engine;
    None: the whole run).  For the captured per-step engine this counts
    the whole run, capture included (replays call no operator), divided
    by its steps: the run goes to a fresh runner (an empty runner cache
    for its duration), which captures its graph inside the count."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core import network as net

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    n_steps = fab.compile(spec, max_steps=steps, warm=False).bucket[4]
    saved, net._RUNNERS = net._RUNNERS, {}
    try:
        with Count():
            fab.run(spec, max_steps=steps)
    finally:
        net._RUNNERS = saved
    return Count.n / n_steps


def _replay_window(prof, steps: int) -> dict:
    """The graph replays of a profiled per-step run: the device span of
    the runner's replay range (from its first kernel to its last: the
    capture before it ran nothing on the card, and the run has no eager
    tail), the kernels' device time in it, a step, and the per-step
    kernels' calls there, and, to say where any records went missing,
    those kernels' calls over the whole profile (the eager steps too),
    the first kernel's distance from the replay range's opening and the
    tail's records (``_profiled_run``)."""
    from torch.autograd import DeviceType
    from repro_torch.core.network import REPLAY_RANGE
    evs = prof.events()
    opened = min(e.time_range.start for e in evs
                 if e.name == REPLAY_RANGE)
    cuda = [e for e in evs if e.device_type == DeviceType.CUDA
            and e.name != REPLAY_RANGE]
    tail = sum(TAIL_KERNEL in e.name for e in cuda)
    cuda = [e for e in cuda if TAIL_KERNEL not in e.name]
    rows = [e for e in cuda if e.time_range.start >= opened]
    if not rows:
        return {"device_busy": "not measured"}
    t0 = min(e.time_range.start for e in rows)
    t1 = max(e.time_range.end for e in rows)
    busy = sum(e.time_range.elapsed_us() for e in rows)
    names = ("fabric_queue_step", "fabric_queue_update")
    return {"steps": steps, "window_us": t1 - t0,
            "device_us_per_step": busy / steps,
            "profiled_busy_share": busy / (t1 - t0),
            "kernels_per_step": len(rows) / steps,
            "calls": {k: sum(k + "_kernel" in e.name for e in rows)
                      for k in names},
            "calls_whole_profile": {k: sum(k + "_kernel" in e.name
                                           for e in cuda) for k in names},
            "first_kernel_after_open_us": t0 - opened,
            "tail_records": tail}


#: kernels launched after the profiled run, inside the recorded window:
#: the last records of a window can go undelivered when the tracing
#: stops (one run's window once lacked 18 B1 and 19 B2 records of 256,
#: a count only the end of its replays explains), so the run's own
#: must never be the last
TAIL_KERNELS = 8192
TAIL_KERNEL = "spin_kernel"        # torch.cuda._sleep's


def _profiled_run(cf, spec, steps):
    """``cf.run`` under torch.profiler, as the schedule's second step:
    after a warm-up step that starts the device tracing (kernels
    launched as the tracing starts can go unrecorded), and followed
    inside the recorded step by TAIL_KERNELS one-cycle spin kernels
    (the last records before the tracing stops can go undelivered).
    ``(profile, wall s of the run alone)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        cf.run(spec, max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for _ in range(TAIL_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        prof.step()
    return prof, wall


def phase_profile(spec, kw, engine="pallas", steps=None, label="profile"):
    """Device-busy share and kernel time by name over a profiled run of
    ``steps`` micro-transactions (None: the whole run) of the cell
    through ``engine``.  The per-step engine runs 2 + 8·GRAPH_STEPS
    steps (two eager, eight replays, no eager tail), read over the
    replays alone, where the profiler must record GRAPH_STEPS calls of
    B1 and of B2 a replay: the replays' launches, which the wrappers do
    not see.  The profiler slows replays down, so this window's busy
    share is the profiled one only; the full cells' phases give the
    replays' unprofiled span (CUDA events).  The run is padded on both
    sides inside the recorded window (``_profiled_run``); the device
    time by kernel leaves the tail's spin kernels out."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import Fabric
    from repro_torch.kernels import fabric_queue as fq
    fab = Fabric(**kw, engine=engine)
    per_step = fab.engine.kernel == "step"
    if per_step:
        steps = 2 + 8 * net.GRAPH_STEPS
    cf = fab.compile(spec, max_steps=steps)
    cf.run(spec, max_steps=steps)            # warm the allocator
    torch.cuda.synchronize()
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    prof, wall = _profiled_run(cf, spec, steps)
    counted = {"fabric_queue_step": fq.fabric_queue_step.launches,
               "fabric_queue_update": fq.fabric_queue_update.launches}
    steps = cf.bucket[4]
    rows = [r for r in _device_rows(prof) if TAIL_KERNEL not in r[1]]
    busy_us = sum(r[0] for r in rows)
    extra = {}
    if per_step:
        replayed = net.GRAPH_STEPS * cf.graph["replays"]
        rep = _replay_window(prof, replayed)
        extra = {"graph": _per_step(cf.graph), "wrapper_launches": counted,
                 "replays": rep, "tail_kernels": TAIL_KERNELS,
                 "host_ops_per_step_whole_run": aten_ops_per_step(fab,
                                                                  spec)}
    ops = aten_ops_per_step(fab, spec, steps=steps)
    if busy_us == 0:
        emit(label, steps=steps, wall_s=wall, aten_ops_per_step=ops,
             device_busy="not measured", **extra)
    else:
        emit(label, steps=steps, wall_s=wall,
             us_per_step=wall / steps * 1e6,
             device_busy_us_per_step=busy_us / steps,
             device_busy_share=busy_us / (wall * 1e6),
             aten_ops_per_step=ops,
             kernels_per_step=sum(r[2] for r in rows) / steps,
             op_rows_device_us_per_step=_op_rows_us(prof) / steps,
             top=[{"kernel": k[:80], "us_per_step": us / steps,
                   "calls_per_step": c / steps}
                  for us, k, c in rows[:12]],
             **extra)
    if per_step:
        want = 8 * net.GRAPH_STEPS
        check(rep.get("calls") == {"fabric_queue_step": want,
                                   "fabric_queue_update": want},
              f"{label}: the profiler saw {rep.get('calls')} B1/B2 calls "
              f"in 8 replays, expected {want} each")
        check(all(v == 2 + want for v in counted.values()),
              f"{label}: wrappers counted {counted}, expected {2 + want}")


def _wrappers():
    from repro_torch.kernels import aer_decode as adk
    from repro_torch.kernels import aer_encode as aek
    from repro_torch.kernels import fabric_queue as fq
    from repro_torch.kernels import lif_step as lk
    from repro_torch.kernels import selective_scan as ssk
    return (fq.fabric_queue_step, fq.fabric_queue_update,
            fq.fabric_queue_multistep, lk.lif_step, aek.aer_encode,
            adk.aer_decode, ssk.selective_scan, ssk.selective_scan_bwd)


def _counts_zero():
    for f in _wrappers():
        f.launches = 0


def _counts() -> dict:
    return {f.__name__: f.launches for f in _wrappers()}


#: rows of 128 lanes at which B4 is timed: the cosim ring-16 state, the
#: SNN Fig. 6 state (tests/_torch_cases.py::SNN_FIG6) and a large one
LIF_TIMED_ROWS = (16, 32, 65536)


def phase_lif_kernel():
    """B4 against its plain version on the card, then its times."""
    import numpy as np
    import torch
    from repro_torch.kernels import lif_step as lk
    from repro_torch.kernels import ref
    from _torch_cases import (LIF_CARD_SHAPES, LIF_PARAMS, lif_cases,
                              lif_double_roundings, lif_on_card)
    dev = torch.device("cuda", 0)
    cases, confirmed, unexplained, worst = [], 0, 0, 0.0
    shapes = [s for s in LIF_CARD_SHAPES for _ in LIF_PARAMS]
    for shape, (name, v, i, d, th, rst) in zip(shapes,
                                               lif_cases(LIF_CARD_SHAPES)):
        vt, it = (lif_on_card(a, dev, shape) for a in (v, i))
        got = lk.lif_step(vt, it, decay=d, v_th=th, v_reset=rst)
        plain = ref.lif_step(vt, it, d, th, rst)
        got = tuple(t.cpu().numpy() for t in got)
        plain = tuple(t.cpu().numpy() for t in plain)
        ok, bad = lif_double_roundings(v, i, d, th, rst, got, plain)
        differ = (got[0].view(np.int32) != plain[0].view(np.int32)) | \
            (got[1].view(np.int32) != plain[1].view(np.int32))
        err = float(np.abs(got[0][differ].astype(np.float64)
                           - plain[0][differ]).max(initial=0.0))
        confirmed, unexplained = confirmed + ok, unexplained + bad
        worst = max(worst, err)
        cases.append({"case": name, "n": int(v.size),
                      "route": ("vector" if int(v.size) % 4 == 0
                                and vt.data_ptr() % 16 == 0 else
                                "vector + scalar tail"
                                if vt.data_ptr() % 16 == 0 else "scalar"),
                      "spikes": int(got[1].sum()),
                      "double_roundings": ok, "unexplained": bad,
                      "max_abs_err": err})
    routes = sorted({c["route"] for c in cases})
    emit("lif_vs_plain", cases=cases, double_roundings=confirmed,
         unexplained=unexplained, max_abs_err=worst, routes=routes,
         equal=confirmed + unexplained == 0)
    check(len(routes) == 3, f"LIF cases took the routes {routes}, not "
                            f"all three (vector, tail, scalar)")
    check(unexplained == 0, f"LIF kernel disagrees with its plain version "
                            f"on {unexplained} element(s) that are not "
                            f"double roundings of the plain route")

    # times: the cosim ring-16 state (16, 128), the SNN Fig. 6 state
    # (32, 128) and a large (65536, 128), each beside one launch that
    # moves comparable bytes (torch.add(v, i_syn, out=o): two reads, one
    # write) and the one-element fill_ floor
    out = {}
    rng = np.random.default_rng(7)
    one = torch.empty(1, dtype=torch.float32, device=dev)
    fill_ms = device_ms(lambda: one.fill_(1.0))
    for rows in LIF_TIMED_ROWS:
        v = torch.from_numpy(rng.uniform(-0.5, 1.2, (rows, 128))
                             .astype(np.float32)).to(dev)
        i = torch.from_numpy(rng.uniform(-0.2, 0.6, (rows, 128))
                             .astype(np.float32)).to(dev)
        o = torch.empty_like(v)

        def kern():
            return lk.lif_step(v, i, decay=0.9, v_th=1.0, v_reset=0.0)

        def plain():
            return ref.lif_step(v, i, 0.9, 1.0, 0.0)

        n = v.numel()
        byts, ops = 16 * n, 3 * n        # 2 reads + 2 writes; FMA + compare
        tb, to = byts / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        dms, pdms = device_ms(kern), device_ms(plain)
        add_ms = device_ms(lambda: torch.add(v, i, out=o))
        seen = dms is not None and pdms is not None
        ms = dms if seen else time_ms(kern)
        out[f"{rows}x128"] = {
            "ms": ms,
            "plain_ms": pdms if seen else time_ms(plain),
            "ms_source": ("profiler device time per call" if seen
                          else "CUDA events, back-to-back calls"),
            "device_ms": dms, "plain_device_ms": pdms,
            "call_ms": time_ms(kern), "plain_call_ms": time_ms(plain),
            "event_ms": time_ms(kern, n=200 if rows > 1024 else 2000),
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_share": max(tb, to) / ms,
            "bytes": byts, "ops": ops, "library_ms": None,
            "add_floor_ms": add_ms, "fill_floor_ms": fill_ms,
            "above_add_floor_us": (None if add_ms is None or dms is None
                                   else (dms - add_ms) * 1e3)}
    emit("lif_kernel_time", shapes=out,
         library="none: no single PyTorch call computes the LIF update")
    return {**out["16x128"], "max_abs_err": worst,
            **{f"at_{k}": v for k, v in out.items() if k != "16x128"}}


def _cosim_cell():
    from repro_torch.core.router import AddressSpec
    from repro_torch.cosim.traffic_bridge import _ring_placement
    from _torch_cases import COSIM_RING
    return COSIM_RING, _ring_placement(COSIM_RING["n_chips"], "recurrent",
                                       addr=AddressSpec())


def phase_cosim(host_ref: HostReference):
    """COSIM_RING open and closed loop on the card (the closed loop is the
    main path of B4 and of the cosim's transport), then three ticks
    handed to ``host_ref`` for the plain engine: the launches, the ms a
    tick closed and open, and the three ticks' card results by label."""
    import numpy as np
    import torch
    from repro_torch.core.fabric import (EngineSpec, MulticastPolicy,
                                         QueuePolicy)
    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.cosim import CosimConfig, CosimEngine, reference_rollout
    cfg, pl = _cosim_cell()
    T = cfg["ticks"]
    ccfg = CosimConfig(input_rate=cfg["input_rate"], feedback="none")

    def gen():
        return torch.Generator().manual_seed(cfg["seed"])

    eng = CosimEngine(pl, ccfg, generator=gen())
    eng.run(1)                               # warm the allocator and cuBLAS
    torch.cuda.synchronize()
    _counts_zero()
    t0 = time.perf_counter()
    opn = eng.run(T)
    torch.cuda.synchronize()
    open_wall = time.perf_counter() - t0
    open_launches = _counts()
    # untimed second pass: the membranes and rasters of every tick, held
    # against reference_rollout bit for bit (each run redraws one drive)
    rec = eng.run(T, record_state=True)
    roll = reference_rollout(eng, T, record_state=True)
    same = (np.array_equal(rec.v.view(np.int32), roll.v.view(np.int32))
            and np.array_equal(rec.raster, roll.raster)
            and np.array_equal(rec.spikes, roll.spikes)
            and np.array_equal(opn.spikes, rec.spikes))
    emit("cosim_open", ticks=T, spikes=opn.total_spikes,
         launches=open_launches, wall_s=open_wall,
         ms_per_tick=open_wall / T * 1e3, equals_reference_rollout=same)
    check(same, "open loop differs from reference_rollout")
    check(open_launches["lif_step"] == T, f"open loop: {open_launches}, "
                                          f"expected {T} lif_step launches")
    check(opn.total_spikes > 0, "open loop never spiked")

    queues = QueuePolicy(capacity=cfg["capacity"], flow="credit")
    fab = pl.fabric(engine=EngineSpec("pallas", kernel="multistep"),
                    queues=queues)
    eng = CosimEngine(pl, ccfg._replace(feedback="next_tick"), fabric=fab,
                      generator=gen())
    torch.cuda.synchronize()
    _counts_zero()
    t0 = time.perf_counter()
    cls = eng.run(T, record_fabric=True, collect_events=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    buckets = [fab._plan(e.spec, None).bucket for e in cls.events]
    want_b3 = sum(-(-b[4] // b[9]) for b in buckets)
    divergence = int(np.abs(cls.spikes - opn.spikes).sum())
    steps = sum(b[4] for b in buckets)
    # the three ticks with the most events through the plain engine, on
    # the host (``HostReference``), held to the card's before its end
    busiest = sorted(cls.events, key=lambda e: -e.n_events)[:3]
    by_tick = dict(cls.fabric_results)
    ref_kw = dict(topo=pl.topo, addr=pl.addr, queues=queues)
    if pl.mcast is not None:
        ref_kw["mcast"] = MulticastPolicy("in_fabric", pl.mcast)
    replays = {}
    for e in busiest:
        host_ref.submit(f"cosim_tick{e.tick}", ref_kw,
                        TrafficSpec(*(a.cpu() for a in e.spec)))
        replays[f"cosim_tick{e.tick}"] = by_tick[e.tick]
    emit("cosim_closed", ticks=T, spikes=cls.total_spikes,
         offered=int(cls.offered.sum()), injected=int(cls.injected.sum()),
         delivered=int(cls.delivered.sum()), drops=int(cls.drops.sum()),
         conservation_exact=cls.conservation_exact, divergence=divergence,
         min_divergence=MIN_COSIM_DIVERGENCE, launches=launches,
         expected_multistep_launches=want_b3, fabric_steps=steps,
         wall_s=wall, ms_per_tick=wall / T * 1e3,
         us_per_fabric_step=wall / steps * 1e6,
         replayed_ticks=[e.tick for e in busiest],
         replayed_events=[e.n_events for e in busiest],
         latency=({"p50_ns": float(np.percentile(cls.latency_ns, 50)),
                   "p99_ns": float(np.percentile(cls.latency_ns, 99)),
                   "max_ns": int(cls.latency_ns.max())}
                  if cls.latency_ns.size else None))
    check(cls.conservation_exact, "cosim: delivered + drops != injected")
    check(int(cls.drops.sum()) == 0
          and int(cls.delivered.sum()) == int(cls.injected.sum()),
          "cosim: the credit fabric was not lossless")
    check(int(cls.delivered.sum()) > 0, "cosim: no spike crossed chips")
    check(divergence >= MIN_COSIM_DIVERGENCE,
          f"cosim: closed loop diverged from open by {divergence} "
          f"(< {MIN_COSIM_DIVERGENCE})")
    check(launches == {"fabric_queue_step": 0, "fabric_queue_update": 0,
                       "fabric_queue_multistep": want_b3, "lif_step": T,
                       "aer_encode": 0, "aer_decode": 0,
                       "selective_scan": 0, "selective_scan_bwd": 0},
          f"cosim: launches {launches}, expected {T} lif_step and "
          f"{want_b3} fabric_queue_multistep, no other kernel")
    return launches, wall / T * 1e3, open_wall / T * 1e3, replays


def phase_snn_fig6():
    import numpy as np
    import torch
    from repro_torch.models import snn
    from _torch_cases import SNN_FIG6 as cell
    cfg = snn.SnnConfig(grid=cell["grid"], neurons=cell["neurons"])
    params, st = snn.init_snn(cfg, torch.Generator().manual_seed(
        cell["seed"]))
    snn.run_snn(params, cfg, st, 1)          # warm the allocator and cuBLAS
    torch.cuda.synchronize()
    T = cell["ticks"]
    _counts_zero()
    t0 = time.perf_counter()
    st2, ticks = snn.run_snn(params, cfg, st, T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    rep = snn.link_report(ticks)
    finite = all(np.isfinite(v) for v in rep.values())
    emit("snn_fig6", grid=list(cfg.grid), neurons=cfg.neurons, ticks=T,
         launches=launches, wall_s=wall, ms_per_tick=wall / T * 1e3,
         spikes=float(ticks["spikes"].sum()),
         rate=float(ticks["rate"].mean()), link_report=rep,
         finite=finite, v_finite=bool(torch.isfinite(st2.v).all()))
    check(launches["lif_step"] == T, f"snn_fig6: {launches}, expected {T} "
                                     f"lif_step launches")
    check(finite and bool(torch.isfinite(st2.v).all()),
          "snn_fig6: non-finite figures")
    check(float(ticks["spikes"].sum()) > 0, "snn_fig6 never spiked")
    return launches["lif_step"], wall / T * 1e3


#: the port's fabric and co-simulation examples (``examples/torch_*.py``),
#: each run by its ``main`` on the card; the last two launch B4 a tick
EXAMPLES = ("multi_chip_fabric", "heterogeneous_links", "multicast_fanout",
            "lossless_hotspot", "adaptive_hotspot", "monte_carlo_sweep",
            "closed_loop_snn", "snn_chip_array")
COSIM_EXAMPLES = ("closed_loop_snn", "snn_chip_array")
EXAMPLES_OUT = ROOT / "build" / "examples_torch"


def _example(name: str):
    """``examples/torch_<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scalars(d: dict, depth: int = 2) -> dict:
    """The numbers and words of an example's returned dict (nested dicts
    to ``depth``), for its JSON line."""
    import numpy as np
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.integer, np.floating, np.bool_)):
            v = v.item()
        if isinstance(v, (bool, int, float, str)):
            out[k] = v
        elif isinstance(v, dict) and depth > 1:
            sub = _scalars(v, depth - 1)
            if sub:
                out[k] = sub
    return out


def phase_examples():
    """Each of the eight examples' ``main(["--device", "cuda"])`` on the
    card, every assert of the script live, from an empty runner cache as
    in a fresh process (the Monte-Carlo script counts its batched
    runners): wall seconds and the port kernels' launches of each run
    (B4 once a membrane update in the two co-simulations, no port kernel
    in the six fabric scripts, which take the ring engine); then each
    fabric script's first scenario (the Monte-Carlo script's first seed)
    again under ``engine="pallas"``, B1 and B2 once a step from the step
    graph, equal to the script's ring run field for field.  Each script's
    printed report goes to ``build/examples_torch/<name>.txt``."""
    import contextlib
    import io
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import Fabric
    dev = torch.device("cuda", torch.cuda.current_device())
    EXAMPLES_OUT.mkdir(parents=True, exist_ok=True)
    saved, net._RUNNERS = net._RUNNERS, {}
    t_phase = time.perf_counter()
    rows = {}
    try:
        for name in EXAMPLES:
            mod = _example(name)
            buf = io.StringIO()
            torch.cuda.synchronize()
            _counts_zero()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = mod.main(["--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
            text = buf.getvalue()
            (EXAMPLES_OUT / f"{name}.txt").write_text(text)
            want = {k: 0 for k in launches}
            if name in COSIM_EXAMPLES:
                want["lif_step"] = out["ticks_run"]
            row = {"wall_s": wall, "launches": launches,
                   "last_line": text.strip().splitlines()[-1],
                   "report": str(EXAMPLES_OUT / f"{name}.txt"),
                   "summary": _scalars(out)}
            check(launches == want,
                  f"examples/{name}: launches {launches}, expected {want}")
            if name not in COSIM_EXAMPLES:
                r = out["replay"]
                fab = Fabric(**r["fabric"], engine="pallas", device=dev)
                steps = fab._plan(r["spec"], None).max_steps
                torch.cuda.synchronize()
                _counts_zero()
                t1 = time.perf_counter()
                got = fab.run(r["spec"])
                torch.cuda.synchronize()
                replay = _counts()
                net.assert_results_equal(r["result"], got,
                                         f"examples/{name}: pallas replay")
                row.update(replay_wall_s=time.perf_counter() - t1,
                           replay_steps=steps, replay_launches=replay,
                           replay_equal=True)
                check(replay == {**{k: 0 for k in replay},
                                 "fabric_queue_step": steps,
                                 "fabric_queue_update": steps},
                      f"examples/{name}: pallas replay launches {replay}, "
                      f"expected {steps} of B1 and of B2")
            emit(f"examples_{name}", **row)
            rows[name] = row
    finally:
        net._RUNNERS = saved
    rows.update(_lm_examples())
    emit("examples", phase_s=time.perf_counter() - t_phase,
         wall_s={n: r["wall_s"] for n, r in rows.items()},
         lif_step={n: rows[n]["launches"]["lif_step"]
                   for n in COSIM_EXAMPLES})
    return rows


#: the LM examples' flags on the card: their tiny sizes.  At their
#: defaults the training example (a ~100 M-parameter model, 300 steps of
#: 16 x 256 tokens) took 98.8 s and the demo (40 steps a mode) 184.2 s
#: on one H100 (700 W), past the script's time limit with the rest
TRAIN_EXAMPLE_ARGV = ["--tiny"]
DEMO_STEPS = 4
DEMO_ARGV = ["--steps", str(DEMO_STEPS)]
#: |bidir_ring - psum| final loss of the demo: the same sums in another
#: order (the script's own words: "must be ~float noise"), grown over
#: 40 AdamW steps to 0.00146 on 8 gloo ranks on the CPU (aer_topk's:
#: 0.0227) and 0.00024 on 8 sharing one H100
DEMO_RING_TOL = 5e-3


def _lm_examples() -> dict:
    """The two LM examples on the card, each through its ``main`` with
    its asserts live: ``torch_train_lm_100m`` (training with a
    checkpoint, an injected failure and a restart; no port kernel) and
    ``torch_sparse_allreduce_demo`` with no device, so on the card: its
    8 ranks share this card over gloo (NCCL where 8 cards are),
    DEMO_STEPS steps a mode; rank 0's B5 and B6 launches one a
    reference leaf a step under ``aer_topk`` and none under ``psum`` and
    ``bidir_ring``, and the ring's final loss within DEMO_RING_TOL of
    ``psum``'s.  The demo's ranks run in their own processes, so this
    process counts no launch of theirs."""
    import contextlib
    import importlib
    import io
    import math
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_loop import ReferenceLeaves
    rows = {}
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        for name, argv in (("train_lm_100m", TRAIN_EXAMPLE_ARGV),
                           ("sparse_allreduce_demo", DEMO_ARGV)):
            mod = importlib.import_module(f"torch_{name}")
            buf = io.StringIO()
            torch.cuda.synchronize()
            _counts_zero()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
            text = buf.getvalue()
            (EXAMPLES_OUT / f"{name}.txt").write_text(text)
            check(all(v == 0 for v in launches.values()),
                  f"examples/{name}: launches {launches} in this process, "
                  f"expected none")
            row = {"wall_s": wall, "argv": argv, "launches": launches,
                   "last_line": text.strip().splitlines()[-1],
                   "report": str(EXAMPLES_OUT / f"{name}.txt")}
            if name == "train_lm_100m":
                state, info = out
                row.update(steps=int(state.step),
                           restarts=info["restarts"],
                           checkpoints=info["checkpoints"],
                           last_loss=info["last_loss"],
                           stragglers=len(info["straggler_events"]))
            else:
                modes = out["modes"]
                want = "nccl" if torch.cuda.device_count() >= mod.WORLD \
                    else "gloo"
                check(out["device"] == "cuda" and out["backend"] == want,
                      f"examples/{name}: ran on {out['device']} over "
                      f"{out['backend']}, expected cuda over {want}")
                leaves = len(ReferenceLeaves(build_model(
                    get_smoke_config("granite_3_2b"), device="meta"))
                    .members)
                steps = DEMO_STEPS
                for mode, r in modes.items():
                    n = leaves * steps if mode == "aer_topk" else 0
                    check(r["launches"] == {"aer_encode": n,
                                            "aer_decode": n},
                          f"examples/{name}: {mode} launched "
                          f"{r['launches']} on rank 0, expected {n} of "
                          f"B5 and of B6")
                    check(len(r["losses"]) == steps
                          and all(math.isfinite(v) for v in r["losses"]),
                          f"examples/{name}: {mode} losses not finite")
                gap = abs(modes["bidir_ring"]["losses"][-1]
                          - modes["psum"]["losses"][-1])
                check(gap <= DEMO_RING_TOL,
                      f"examples/{name}: bidir_ring is {gap} from psum")
                row.update(backend=out["backend"],
                           cards=torch.cuda.device_count(),
                           ranks=mod.WORLD, leaves=leaves,
                           rank0_launches={m: r["launches"]
                                           for m, r in modes.items()},
                           final_loss={m: r["losses"][-1]
                                       for m, r in modes.items()},
                           ring_psum_gap=gap, steps=steps,
                           rank0_mode_s={m: r["seconds"]
                                         for m, r in modes.items()},
                           wire_words_per_step={
                               m: r["wire_words"] / steps
                               for m, r in modes.items()})
            emit(f"examples_{name}", **row)
            rows[name] = row
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return rows


COSIM_GROUPS = {"lif_step (B4)": ("lif_step",),
                "fabric_queue_multistep (B3)": ("fabric_queue_multistep",),
                "matvec": ("gemv", "gemm", "dot_kernel", "cublas"),
                "copies": ("Memcpy", "memcpy", "copy")}


def _profile_ticks(label: str, run, T: int, groups=None,
                   unit: str = "tick") -> dict:
    """Device-busy share and device time by kernel (and by group) over a
    profiled ``run()`` of ``T`` ticks (or steps: ``unit``).

    The recorded window is the second step of the profiler's schedule:
    the first, a one-element add, only warms it up, because kernels
    launched right after the profiler starts can go unrecorded (a
    one-step window of the AER layer once showed 7 of its 9 B5
    launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    u = unit
    if busy_us == 0:
        emit(label, **{f"{u}s": T}, wall_s=wall, device_busy="not measured")
        return {"device_busy_share": None}
    groups = groups or COSIM_GROUPS
    by_group = {g: sum(us for us, k, _ in rows
                       if any(p in k for p in pats)) / T
                for g, pats in groups.items()}
    calls_by_group = {g: sum(c for _, k, c in rows
                             if any(p in k for p in pats)) / T
                      for g, pats in groups.items()}
    out = {f"{u}s": T, "wall_s": wall, f"ms_per_{u}": wall / T * 1e3,
           f"device_busy_us_per_{u}": busy_us / T,
           "device_busy_share": busy_us / (wall * 1e6),
           f"us_per_{u}_by_group": by_group,
           f"calls_per_{u}_by_group": calls_by_group,
           f"kernels_per_{u}": sum(r[2] for r in rows) / T,
           f"op_rows_device_us_per_{u}": _op_rows_us(prof) / T,
           "top": [{"kernel": k[:80], f"us_per_{u}": us / T,
                    f"calls_per_{u}": c / T} for us, k, c in rows[:12]]}
    emit(label, **out)
    return out


def phase_profile_cosim():
    """Profiles of the closed loop and of the Fig. 6 array."""
    import torch
    from repro_torch.core.fabric import EngineSpec, QueuePolicy
    from repro_torch.cosim import CosimConfig, CosimEngine
    from repro_torch.models import snn
    from _torch_cases import SNN_FIG6
    cfg, pl = _cosim_cell()
    T = cfg["ticks"]
    fab = pl.fabric(engine=EngineSpec("pallas", kernel="multistep"),
                    queues=QueuePolicy(capacity=cfg["capacity"],
                                       flow="credit"))
    eng = CosimEngine(pl, CosimConfig(input_rate=cfg["input_rate"]),
                      fabric=fab, generator=torch.Generator().manual_seed(
                          cfg["seed"]))
    eng.run(2)
    torch.cuda.synchronize()
    _profile_ticks("profile_cosim", lambda: eng.run(T), T)

    scfg = snn.SnnConfig(grid=SNN_FIG6["grid"], neurons=SNN_FIG6["neurons"])
    params, st = snn.init_snn(scfg, torch.Generator().manual_seed(
        SNN_FIG6["seed"]))
    snn.run_snn(params, scfg, st, 2)
    torch.cuda.synchronize()
    T = SNN_FIG6["ticks"]
    _profile_ticks("profile_snn_fig6",
                   lambda: snn.run_snn(params, scfg, st, T), T)


# --- the AER payload path (B5, B6) -----------------------------------------

AER_NB, AER_BLOCK, AER_BUDGET = 16384, 1024, 128   # one granite MLP weight
AER_FRAC = 0.02                                    # RunConfig.aer_frac
AER_STEPS = 5


def _host(t):
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _abs_err(want, got) -> float:
    """Largest |want - got| over the elements both hold as numbers."""
    import numpy as np
    w, g = _host(want).astype(np.float64), _host(got).astype(np.float64)
    both = np.isfinite(w) & np.isfinite(g)
    return float(np.abs(w[both] - g[both]).max(initial=0.0))


def _raw_encode(lib, x, tau, budget):
    """A callable that launches B5 from ``lib`` (a library's ctypes
    handle) on float32 ``x`` into outputs allocated once, and the
    outputs: for timing without the wrapper's allocations and checks,
    whose host time can exceed the kernel's."""
    import torch
    nb, blk = x.shape
    i32 = dict(dtype=torch.int32, device=x.device)
    outs = (torch.empty((nb, budget), **i32),
            torch.empty((nb, budget), device=x.device),
            torch.empty((nb,), **i32), torch.empty((nb,), **i32))
    ptrs = [t.data_ptr() for t in outs]
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run():
        check(lib.aer_encode_launch(x.data_ptr(), tau.data_ptr(), nb, blk,
                                    budget, 0, *ptrs, stream) == 0,
              "aer_encode launch")
    return run, outs


def _raw_decode(lib, idx, val, block):
    """``_raw_encode``'s counterpart for B6 (float32 val)."""
    import torch
    nb, budget = idx.shape
    out = torch.empty((nb, block), device=idx.device)
    stream = torch.cuda.current_stream(idx.device).cuda_stream

    def run():
        check(lib.aer_decode_launch(idx.data_ptr(), val.data_ptr(), nb,
                                    budget, block, 0, out.data_ptr(), None,
                                    stream) == 0, "aer_decode launch")
    return run, (out,)


def _aer_routes_check(seen: dict) -> None:
    """Fail unless the cases reached every route of B5 and B6."""
    from repro_torch.kernels import aer_decode as adk
    from repro_torch.kernels import aer_encode as aek
    for kname, routes in (("aer_encode", aek.ROUTES),
                          ("aer_decode", adk.ROUTES)):
        missed = [r for r in routes if not seen[kname].get(r)]
        check(not missed, f"{kname}: no case took route(s) {missed}")


def phase_aer_kernels():
    """B5 and B6 against their plain versions on the card, bit for bit
    (NaN where NaN), on every ``aer_cases`` shape and every
    ``AER_ROUTE_CASES`` entry, with the route each call took; then both
    timed at (16384, 1024), budget 128, and B6 at the 8-peer decode,
    by profiler device time and by CUDA events."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import aer_decode as adk
    from repro_torch.kernels import aer_encode as aek
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref
    from _torch_cases import (AER_PEERS, AER_ROUTE_CASES, aer_arrays,
                              aer_mismatches, aer_offset_copy,
                              aer_peer_case, aer_specs)
    dev = torch.device("cuda", 0)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases, bad = [], 0
    worst = {"aer_encode": 0.0, "aer_decode": 0.0}
    seen = {"nan_slots": 0, "overflow_rows": 0, "zero_tau_rows": 0,
            "bf16_cases": 0, "nan_dense": 0}
    routes = {"aer_encode": {}, "aer_decode": {}}
    specs = [(*spec, 0, None) for spec in aer_specs(card=True)]
    specs += AER_ROUTE_CASES
    for spec in specs:
        name, kind, nb, block, budget, dtype, offset, want_route = spec
        a, b, n = aer_arrays(spec[:6])
        dt = dts[dtype]
        took = {}
        if kind == "encode":
            x = aer_offset_copy(a, dt, offset, dev)
            tau = torch.from_numpy(b).to(dev).to(dt)
            took["aer_encode"] = aek.plan(x)["route"]
            took["aer_decode"] = adk.plan(block, dt)["route"]
            got = aek.aer_encode(x, tau, n)
            want = ref.aer_encode(x, tau, n)
            dec = (ref.aer_decode(want[0], want[1], block),
                   adk.aer_decode(got[0], got[1], block))
            pairs = {"aer_encode": list(zip(want, got)),
                     "aer_decode": [dec]}
            seen["nan_slots"] += int(torch.isnan(want[1].float()).sum())
            seen["overflow_rows"] += int((want[3] > want[2]).sum())
            seen["zero_tau_rows"] += int((tau == 0).sum())
        else:
            idx = torch.from_numpy(a).to(dev)
            val = torch.from_numpy(b).to(dev).to(dt)
            took["aer_decode"] = adk.plan(n, dt)["route"]
            pairs = {"aer_decode": [(ref.aer_decode(idx, val, n),
                                     adk.aer_decode(idx, val, n))]}
        torch.cuda.synchronize()
        mism = 0
        for kname, ps in pairs.items():
            for w, g in ps:
                check(w.dtype == g.dtype and w.shape == g.shape,
                      f"{name}: {kname} dtype or shape differs")
                mism += aer_mismatches(_host(w), _host(g))
                worst[kname] = max(worst[kname], _abs_err(w, g))
        for kname, r in took.items():
            routes[kname][r] = routes[kname].get(r, 0) + 1
        if want_route is not None:
            k0 = "aer_encode" if kind == "encode" else "aer_decode"
            check(took[k0] == want_route,
                  f"{name}: {k0} took route {took[k0]}, not {want_route}")
        dense = pairs["aer_decode"][-1][0]
        seen["nan_dense"] += int(torch.isnan(dense.float()).sum())
        seen["bf16_cases"] += dtype == "bfloat16"
        bad += mism
        cases.append({"case": name, "nb": nb, "block": block,
                      "budget": budget, "offset": offset, "routes": took,
                      "mismatches": mism})
    emit("aer_vs_plain", cases=cases, mismatches=bad, edges=seen,
         routes=routes, max_abs_err=worst, equal=bad == 0)
    check(bad == 0, f"AER kernels disagree with their plain versions on "
                    f"{bad} element(s)")
    check(all(v > 0 for v in seen.values()),
          f"an AER edge case never occurred: {seen}")
    _aer_routes_check(routes)

    # times at one full-width weight, the main path's frac and budget,
    # and B6 at the 8-peer decode of that weight
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((AER_NB, AER_BLOCK), generator=g, device=dev)
    tau = K.tau_from_fraction(x, AER_FRAC)
    idx, val, count, _ = aek.aer_encode(x, tau, AER_BUDGET)
    col = torch.where(idx < 0, AER_BLOCK, idx).long()
    pi, pv = (torch.from_numpy(v).to(dev) for v in aer_peer_case(
        2014, AER_PEERS, AER_NB, AER_BUDGET, AER_BLOCK))
    pcol = torch.where(pi < 0, AER_BLOCK, pi).long()
    nb, blk, bud = AER_NB, AER_BLOCK, AER_BUDGET
    npb = AER_PEERS * nb

    def scatter(c, v, rows):
        # the nearest library call: a scatter-add into zeroed rows with
        # one spare column for the voids
        return lambda: torch.zeros((rows, blk + 1), device=dev).scatter_add_(
            1, c, v)
    enc_lib, dec_lib = _build.load("aer_encode"), _build.load("aer_decode")
    calls = {
        "aer_encode": (lambda: aek.aer_encode(x, tau, bud),
                       _raw_encode(enc_lib, x, tau, bud)[0],
                       lambda: ref.aer_encode(x, tau, bud), None,
                       nb * blk * 4 + nb * 4 + nb * bud * 8 + nb * 8,
                       aek.plan(x)),
        "aer_decode": (lambda: adk.aer_decode(idx, val, blk),
                       _raw_decode(dec_lib, idx, val, blk)[0],
                       lambda: ref.aer_decode(idx, val, blk),
                       scatter(col, val, nb), nb * bud * 8 + nb * blk * 4,
                       adk.plan(blk)),
        "aer_decode_peers": (lambda: adk.aer_decode(pi, pv, blk),
                             _raw_decode(dec_lib, pi, pv, blk)[0], None,
                             scatter(pcol, pv, npb),
                             npb * bud * 8 + npb * blk * 4, adk.plan(blk)),
    }
    out = {}
    for kname, (kern, raw, plain, lib, byts, pl) in calls.items():
        # device time of the wrapper's launches by the profiler; by CUDA
        # events over back-to-back launches of the C entry, which the
        # host issues faster than the card runs them
        prof = device_ms(kern, n=200)
        events = time_ms(raw, n=200, warm=20)
        pdms = device_ms(plain, n=5) if plain is not None else None
        lms = device_ms(lib, n=200) if lib is not None else None
        out[kname] = {
            "ms": prof if prof is not None else events,
            "ms_source": ("profiler device time per call" if prof is not
                          None else "CUDA events, back-to-back calls"),
            "profiler_ms": prof, "events_ms": events,
            "plain_ms": (None if plain is None else pdms if pdms is not None
                         else time_ms(plain, n=5, warm=1)),
            "library_ms": (None if lib is None else lms if lms is not None
                           else time_ms(lib, n=200, warm=20)),
            "bound_ms": byts / HBM_BYTES_S * 1e3, "bound_by": "bytes",
            "bytes": byts, "route": pl["route"],
            "registers": pl["registers"],
            "smem_static": pl["static_smem"],
            "smem_dynamic": pl["dynamic_smem"], "threads": pl["threads"],
            "local_bytes": pl["local_bytes"],
            "max_abs_err": worst[kname.removesuffix("_peers")]}
    # B6 against its library call in turns: five rounds of B6, library,
    # library, B6, each a CUDA-event mean over back-to-back calls
    dec, lib = calls["aer_decode"][1], calls["aer_decode"][3]
    rounds = {"aer_decode": [], "library": []}
    for _ in range(5):
        for key, fn in (("aer_decode", dec), ("library", lib),
                        ("library", lib), ("aer_decode", dec)):
            rounds[key].append(time_ms(fn, n=200, warm=20))
    turns = {}
    for key, v in rounds.items():
        v = sorted(v)
        turns[key] = {"median_ms": (v[4] + v[5]) / 2, "min_ms": v[0],
                      "max_ms": v[-1], "all_ms": rounds[key]}
    turns["decode_slower"] = (turns["aer_decode"]["median_ms"]
                              > turns["library"]["median_ms"])
    out["aer_decode"]["in_turns"] = turns
    emit("aer_kernel_time",
         shape={"nb": nb, "block": blk, "budget": bud, "frac": AER_FRAC,
                "events": int(count.sum()), "peers": AER_PEERS,
                "peer_rows": npb},
         kernels=out,
         library={"aer_encode": "none: no single PyTorch call compacts "
                                "a thresholded row into slots",
                  "aer_decode": "torch.zeros + scatter_add_ into "
                                "(nb, block + 1)"})
    return {k: out[k] for k in ("aer_encode", "aer_decode")}


def _tree_libs(others, names) -> tuple:
    """This checkout's kernel libraries ``names`` and those built from
    the ``csrc/`` of other checkouts (``others``: their roots), with
    their C entries' argument types: ``({"this" or root: {name: lib}},
    {"root:name": ptxas lines})``."""
    import ctypes
    from repro_torch.kernels import _build
    libs = {"this": {n: _build.load(n) for n in names}}
    ptxas = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for root in others:
        libs[str(root)] = {}
        for n in names:
            src = Path(root) / "src/repro_torch/kernels/csrc" / f"{n}.cu"
            so = _build.BUILD_DIR / f"turns-{abs(hash(str(src)))}-{n}.so"
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                   str(so), str(src)], check=True,
                                  capture_output=True, text=True)
            ptxas[f"{root}:{n}"] = [
                ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                if "registers" in ln or "spill" in ln]
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in _build.SIGNATURES[n].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            libs[str(root)][n] = lib
    return libs, ptxas


def phase_aer_turns(others, rounds: int = 5):
    """B5 and B6 of this checkout timed in turns with those built from the
    ``csrc/`` of other checkouts (``others``: their roots, e.g. a parent
    commit unpacked with ``git archive``), at (16384, 1024), budget 128,
    float32: per round each other tree, this tree, this tree, each other
    tree, reversed, by CUDA events over back-to-back launches through the
    same plain C entry points on the same operands; then each once by
    profiler device time.  Run by hand, not by ``main``:

        python -c "import sys; sys.path[:0] = ['src', 'tests'];
        import chip_smoke as cs; cs.phase_device(); cs.phase_build();
        cs.phase_aer_turns(['build/parent'])"
    """
    import torch
    from repro_torch.kernels import ops as K
    dev = torch.device("cuda", 0)
    libs, ptxas = _tree_libs(others, ("aer_encode", "aer_decode"))
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((AER_NB, AER_BLOCK), generator=g, device=dev)
    tau = K.tau_from_fraction(x, AER_FRAC)
    nb, blk, bud = AER_NB, AER_BLOCK, AER_BUDGET
    # every tree decodes the same slots (this tree's encoding)
    slots = _raw_encode(libs["this"]["aer_encode"], x, tau, bud)
    slots[0]()
    runs = {key: {"aer_encode": _raw_encode(ls["aer_encode"], x, tau, bud),
                  "aer_decode": _raw_decode(ls["aer_decode"], slots[1][0],
                                            slots[1][1], blk)}
            for key, ls in libs.items()}
    # every tree's outputs equal this tree's on these operands
    for key, r in runs.items():
        for kname, (run, outs) in r.items():
            run()
            torch.cuda.synchronize()
            check(all(map(torch.equal, runs["this"][kname][1], outs)),
                  f"aer_turns: {key}'s {kname} differs from this tree's")
    keys = list(libs)
    order = keys[1:] + ["this", "this"] + keys[1:][::-1]
    times = {k: {"aer_encode": [], "aer_decode": []} for k in keys}
    for _ in range(rounds):
        for key in order:
            for kname in ("aer_encode", "aer_decode"):
                times[key][kname].append(
                    time_ms(runs[key][kname][0], n=200, warm=20))
    res = {}
    for key in keys:
        res[key] = {}
        for kname in ("aer_encode", "aer_decode"):
            v = times[key][kname]
            res[key][kname] = {
                "median_ms": statistics.median(v), "min_ms": min(v),
                "max_ms": max(v), "all_ms": v,
                "profiler_ms": device_ms(runs[key][kname][0], n=200)}
    emit("aer_turns", order=order, rounds=rounds,
         shape={"nb": nb, "block": blk, "budget": bud}, trees=res,
         ptxas=ptxas)
    return res


def phase_queue_lif_turns(others, rounds: int = 5):
    """B2 and B4 of this checkout timed in turns with those built from
    the ``csrc/`` of other checkouts (``others``: their roots, e.g. a
    parent commit unpacked with ``git archive``), through the same plain
    C entry points on the same operands: B2 on the ring-16 planes (32,
    768) with 16 + 16 lanes and on the B = 8 batch's (8·32, 768) with
    8·16 + 8·16, B4 at (16, 128), (32, 128) and (65536, 128).  Per round
    each other tree, this tree, this tree, each other tree, reversed, by
    CUDA events over back-to-back launches; then each once by profiler
    device time, beside the floors (a one-element ``fill_``, a ``copy_``
    of B2's lanes, ``torch.add`` of B4's two inputs).  Every tree's
    outputs must equal this tree's.  Run by hand, not by ``main``:

        python -c "import sys; sys.path[:0] = ['src', 'tests'];
        import chip_smoke as cs; cs.phase_device(); cs.phase_build();
        cs.phase_queue_lif_turns(['build/parent'])"
    """
    import ctypes
    import numpy as np
    import torch
    dev = torch.device("cuda", 0)
    libs, ptxas = _tree_libs(others, ("fabric_queue", "lif_step"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(32)

    def b2_call(lib, big, glob):
        def run():
            rc = lib.fabric_queue_update_launch(
                *(x.data_ptr() for x in big), big[0].shape[0],
                big[0].shape[1], glob[0].data_ptr(), glob[1].data_ptr(),
                glob[0].numel(), *(x.data_ptr() for x in glob[2:]),
                glob[2].numel(), stream)
            check(rc == 0, f"B2 launch failed: {rc}")
        return run

    def b4_call(lib, v, i, out):
        def run():
            rc = lib.lif_step_launch(
                v.data_ptr(), i.data_ptr(), v.numel(), ctypes.c_float(0.9),
                ctypes.c_float(1.0), ctypes.c_float(0.0),
                out[0].data_ptr(), out[1].data_ptr(), stream)
            check(rc == 0, f"B4 launch failed: {rc}")
        return run

    cells, floors = {}, {}
    one = torch.empty(1, dtype=torch.int32, device=dev)
    fill_ms = device_ms(lambda: one.fill_(1))
    for B in (1, 8):
        big, glob = update_batch(rng, B, 32, 768, dev)
        key = f"B2 ({B}·32, 768)"
        runs, outs = {}, {}
        for tree, ls in libs.items():
            mine = [x.clone() for x in big]
            runs[tree] = b2_call(ls["fabric_queue"], mine, glob)
            outs[tree] = mine
        cells[key] = (runs, outs)
        words = glob[0].numel() + glob[2].numel()
        floors[key] = {"copy_floor_ms": copy_floor_ms(words, dev),
                       "copy_kernel_floor_ms": copy_floor_ms(
                           words, dev, strided=True),
                       "fill_floor_ms": fill_ms}
    for rows in LIF_TIMED_ROWS:
        v = torch.from_numpy(rng.uniform(-0.5, 1.2, (rows, 128))
                             .astype(np.float32)).to(dev)
        i = torch.from_numpy(rng.uniform(-0.2, 0.6, (rows, 128))
                             .astype(np.float32)).to(dev)
        key = f"B4 ({rows}, 128)"
        runs, outs = {}, {}
        for tree, ls in libs.items():
            out = (torch.empty_like(v), torch.empty_like(v))
            runs[tree] = b4_call(ls["lif_step"], v, i, out)
            outs[tree] = out
        cells[key] = (runs, outs)
        o = torch.empty_like(v)
        floors[key] = {"add_floor_ms": device_ms(
            lambda: torch.add(v, i, out=o)), "fill_floor_ms": fill_ms,
            "bound_ms": 16 * v.numel() / HBM_BYTES_S * 1e3}
    for key, (runs, outs) in cells.items():
        for tree, run in runs.items():
            run()
        torch.cuda.synchronize()
        for tree in runs:
            check(all(torch.equal(a, b) for a, b in
                      zip(outs["this"], outs[tree])),
                  f"turns: {tree}'s {key} differs from this tree's")
    keys = list(libs)
    order = keys[1:] + ["this", "this"] + keys[1:][::-1]
    times = {k: {c: [] for c in cells} for k in keys}
    for _ in range(rounds):
        for tree in order:
            for key, (runs, _) in cells.items():
                n = 200 if "65536" in key else 2000
                times[tree][key].append(time_ms(runs[tree], n=n,
                                                warm=n // 10))
    res = {}
    for tree in keys:
        res[tree] = {}
        for key, (runs, _) in cells.items():
            v = times[tree][key]
            res[tree][key] = {
                "median_ms": statistics.median(v), "min_ms": min(v),
                "max_ms": max(v), "profiler_ms": device_ms(runs[tree])}
    emit("queue_lif_turns", order=order, rounds=rounds, trees=res,
         floors=floors, ptxas=ptxas)
    return res


def _layer_grads(step: int):
    """Seeded float32 gradients of one granite-3.0-2b decoder layer, made
    on the card (a fresh draw each step)."""
    import torch
    from _torch_cases import GRANITE_3_2B_LAYER
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1000 + step)

    def make(tree):
        if isinstance(tree, dict):
            return {k: make(tree[k]) for k in sorted(tree)}
        return torch.randn(tree, generator=g, device=dev) * 1e-3
    return make(GRANITE_3_2B_LAYER)


def _leaf_vs_plain(g, residual, red, new_residual, frac=AER_FRAC,
                   budget=AER_BUDGET):
    """One leaf of one ``aer_topk`` step in a world of one, held against
    the plain encoder and decoder on the same tiles and thresholds:
    ``(reduced equal, residual' equal, events, events wanted)``.  The
    reduced value and the new residual must equal, bit for bit, what
    ``ref.aer_decode(ref.aer_encode(...))`` gives; ``wanted`` is also
    counted straight from the mask, apart from either encoder."""
    import torch
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as R
    y = g + residual
    tiles, size = K.pad_to_blocks(y, AER_BLOCK)
    tau = K.tau_from_fraction(tiles, frac)
    idx, val, count, wanted = R.aer_encode(tiles, tau, budget)
    mask_total = ((tiles.abs() >= tau[:, None]) & (tiles != 0)).sum(
        1, dtype=torch.int32)
    check(torch.equal(wanted, mask_total),
          "plain encoder's wanted != the mask's row totals")
    dec = R.aer_decode(idx, val, AER_BLOCK)
    return (torch.equal(red, K.unpad_from_blocks(dec, size, g.shape)),
            torch.equal(new_residual,
                        K.unpad_from_blocks(tiles - dec, size, g.shape)),
            int(count.sum()), int(torch.clamp(mask_total,
                                              max=budget).sum()))


def phase_aer_layer():
    """The slice's main path: ``reduce_gradients(mode="aer_topk")`` over
    one granite-3.0-2b decoder layer, five steps in a world of one
    (NCCL, an in-process HashStore), then one profiled step."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import sparse_collectives as sc
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        grads = [_layer_grads(t) for t in range(AER_STEPS + 1)]
        n_leaves = len(sc.tree_leaves(grads[0]))
        n_entries = sum(t.numel() for t in sc.tree_leaves(grads[0]))
        states = sc.init_aer_states(grads[0])
        torch.cuda.synchronize()
        _counts_zero()
        steps = []
        for t in range(AER_STEPS):
            t0 = time.perf_counter()
            red, new, words = sc.reduce_gradients(
                grads[t], states, mode="aer_topk", frac=AER_FRAC,
                budget=AER_BUDGET)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            exact = shipped_ok = plain_ok = True
            nonzero = plain_events = mask_events = 0
            for g, st, r, ns in zip(*(sc.tree_leaves(v) for v in (
                    grads[t], states, red, new))):
                y = g + st.residual
                exact &= bool(torch.equal(ns.residual + r, y))
                on = r != 0
                shipped_ok &= bool(torch.equal(r[on], y[on]))
                nonzero += int(on.sum())
                # the selection itself: what B5 shipped and B6 decoded
                # equals the plain encoder and decoder on the same input
                red_eq, res_eq, ev_, ev_mask = _leaf_vs_plain(
                    g, st.residual, r, ns.residual)
                plain_ok &= red_eq and res_eq
                plain_events += ev_
                mask_events += ev_mask
            steps.append({"step": t, "ms": wall * 1e3,
                          "wire_words": int(words), "decoded": nonzero,
                          "plain_events": plain_events,
                          "mask_events": mask_events,
                          "conserved": exact, "shipped_equal_y": shipped_ok,
                          "equal_plain": plain_ok})
            check(exact, f"step {t}: residual' + decoded != y")
            check(shipped_ok, f"step {t}: a decoded value differs from y")
            check(plain_ok, f"step {t}: reduced or residual differs from "
                            f"the plain encoder and decoder's")
            check(int(words) == nonzero == plain_events == mask_events,
                  f"step {t}: wire words {int(words)}, events decoded "
                  f"{nonzero}, plain {plain_events}, from the mask "
                  f"{mask_events} differ")
            states = new
        launches = _counts()
        res_abs = float(sum(st.residual.abs().sum() for st in
                            sc.tree_leaves(states)))
        _profile_ticks("profile_aer_layer", lambda: sc.reduce_gradients(
            grads[AER_STEPS], states, mode="aer_topk", frac=AER_FRAC,
            budget=AER_BUDGET), 1, groups={
                "aer_encode (B5)": ("aer_encode",),
                "aer_decode (B6)": ("aer_decode",),
                "sort (tau)": ("sort", "Sort", "radix"),
                "copies": ("Memcpy", "memcpy", "copy"),
                "nccl": ("nccl",)}, unit="step")
        # the profiled step launched n_leaves B5 and B6 (its calls per
        # step above say how many the profiler recorded)
    finally:
        dist.destroy_process_group()
    ms = [s["ms"] for s in steps]
    emit("aer_granite3_2b_layer", leaves=n_leaves, entries=n_entries,
         blocks=sum(-(-t.numel() // AER_BLOCK)
                    for t in sc.tree_leaves(grads[0])),
         frac=AER_FRAC, budget=AER_BUDGET, world=1, steps=steps,
         ms_per_step=sum(ms) / len(ms), ms_per_step_after_first=(
             sum(ms[1:]) / len(ms[1:])), launches=launches,
         residual_abs_sum=res_abs)
    want = {"aer_encode": AER_STEPS * n_leaves,
            "aer_decode": AER_STEPS * n_leaves}
    check(all(launches[k] == v for k, v in want.items())
          and all(v == 0 for k, v in launches.items() if k not in want),
          f"launches {launches}, expected {want} and nothing else")
    return launches, sum(ms[1:]) / len(ms[1:])


def phase_aer_compress_feedback():
    """``compress_with_feedback`` at its defaults (frac 0.05, budget
    128, block 1024) on the ffn.wg.w gradient: exact conservation."""
    import torch
    from repro_torch.kernels import ops as K
    x = _layer_grads(0)["ffn"]["wg"]["w"]
    res = _layer_grads(1)["ffn"]["wg"]["w"] * 0.5
    _counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev, new_res, n = K.compress_with_feedback(x, res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    dec = K.unpad_from_blocks(K.aer_decompress(ev), n, x.shape)
    conserved = bool(torch.equal(dec + new_res, x + res))
    emit("aer_compress_feedback", shape=list(x.shape), frac=0.05,
         events=int(ev.count.sum()), wanted=int(ev.wanted.sum()),
         wire_bytes=int(ev.wire_bytes()), dense_bytes=4 * x.numel(),
         ms=wall * 1e3, launches=launches, conserved=conserved)
    check(conserved, "compress_with_feedback: decoded + residual' != "
                     "x + residual")
    check(launches["aer_encode"] == 1 and launches["aer_decode"] == 1,
          f"compress_with_feedback launches {launches}")


# --- the LM serve path (B7) -------------------------------------------------

SERVE_ARGV = ["--arch", "falcon_mamba_7b", "--batch", "4", "--prompt-len",
              "2048", "--gen", "32", "--seed", "0"]
#: teacher-forced decode steps held against forward in float32 compute
SERVE_FORCED = 8
#: |decode or prefill logits - forward logits| <= tol + tol·|forward|,
#: float32 compute, 64 layers (stated before the first run; PERF.md §6)
SERVE_CONSISTENCY_TOL = 2e-4
SERVE_GROUPS = {"selective_scan (B7)": ("selective_scan",),
                "matmul": ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                           "splitK", "cublas"),
                "copies and casts": ("copy", "Memcpy", "memcpy")}


def phase_scan_kernel():
    """B7 against its plain version on every ``scan_cases(card=True)``
    case, then timed at the serve shape."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ssk
    from _torch_cases import (SCAN_JAMBA_SHAPE, SCAN_SERVE_SHAPE,
                              scan_arrays, scan_errors, scan_specs)
    dev = torch.device("cuda", 0)
    cases, worst_abs, worst_rel, serve_args = [], 0.0, 0.0, None
    jamba_args = None
    underflow, unequal = 0, {"y": [], "h_final": []}

    def held(name, tol, want, got, errs):
        nonlocal worst_abs, worst_rel
        for label, w, g in zip(("y", "h_final"), want, got):
            check(g.shape == w.shape and g.dtype == torch.float32,
                  f"{name}: {label} shape or dtype differs")
            check(bool(torch.isfinite(g).all()), f"{name}: {label} "
                                                 f"not finite")
            ab, rel, scaled = scan_errors(w.cpu().numpy(), g.cpu().numpy())
            bits = bool(torch.equal(w.view(torch.int32),
                                    g.view(torch.int32)))
            errs[label] = {"max_abs_err": ab, "max_rel_err": rel,
                           "scaled_err": scaled, "bit_equal": bits}
            if not bits:
                unequal[label].append(name)
            check(scaled <= tol, f"{name}: {label} off by {scaled} "
                                 f"(|d| / (1 + |plain|)) > {tol}")
            worst_abs, worst_rel = max(worst_abs, ab), max(worst_rel, rel)

    for spec in scan_specs(card=True):
        name, shape, _opts, tol = spec
        args = [torch.from_numpy(v).to(dev) for v in scan_arrays(spec)]
        got = ssk.selective_scan(*args)
        want = ref.selective_scan(*args)
        torch.cuda.synchronize()
        errs = {}
        held(name, tol, want, got, errs)
        x, dt, b, c, a = args
        if x.numel() < 2**22:
            abar = torch.exp(dt[..., None] * a)
            underflow += int((abar < torch.finfo(torch.float32).tiny).sum())
        cases.append({"case": name, "shape": list(shape), "tol": tol,
                      **errs})
        if tuple(shape) == SCAN_SERVE_SHAPE:
            serve_args = args
        elif tuple(shape) == SCAN_JAMBA_SHAPE:
            jamba_args = args
        del got, want
    emit("scan_vs_plain", cases=cases, max_abs_err=worst_abs,
         max_rel_err=worst_rel, subnormal_or_zero_abar=underflow,
         not_bit_equal=unequal)
    check(underflow > 0, "no scan case had a subnormal or zero exp(dt·A)")

    x, dt, b, c, a = serve_args

    def kern():
        return ssk.selective_scan(x, dt, b, c, a)

    def plain():
        return ref.selective_scan(x, dt, b, c, a)

    dms, pdms = device_ms(kern, n=20), device_ms(plain, n=2)
    seen = dms is not None and pdms is not None
    bound = ssk.scan_bound(*SCAN_SERVE_SHAPE)
    jms = device_ms(lambda: ssk.selective_scan(*jamba_args), n=20)
    out = {"ms": dms if seen else time_ms(kern, n=20, warm=3),
           "plain_ms": pdms if seen else time_ms(plain, n=2, warm=1),
           "ms_source": ("profiler device time per call" if seen
                         else "CUDA events, back-to-back calls"),
           "call_ms": time_ms(kern, n=20, warm=3), **bound,
           "library_ms": None,
           "max_abs_err": worst_abs, "max_rel_err": worst_rel,
           "jamba_shape": list(SCAN_JAMBA_SHAPE),
           "jamba_ms": jms if jms is not None else time_ms(
               lambda: ssk.selective_scan(*jamba_args), n=20, warm=3),
           "jamba_bound_ms": ssk.scan_bound(*SCAN_JAMBA_SHAPE)["bound_ms"]}
    emit("scan_kernel_time", shape=list(SCAN_SERVE_SHAPE), **out,
         library="none: no PyTorch call computes the selective scan")
    return out


def phase_serve():
    """The slice's main path: falcon-mamba-7b served through
    ``repro_torch.launch.serve`` at full width and depth."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.model import param_count
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args, cfg, model, batch = serve.setup(SERVE_ARGV)
    tokens = batch["tokens"]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(not torch.backends.cuda.matmul
          .allow_bf16_reduced_precision_reduction,
          "bf16 products must accumulate in float32")
    n_params = param_count(model)
    _counts_zero()
    res = serve.generate(model, batch, args.gen)
    launches = _counts()
    live = res.logits[..., :cfg.vocab].float()
    check(bool(torch.isfinite(live).all()), "serve: logits not finite")
    check(tuple(res.tokens.shape) == (args.batch, args.gen)
          and int(res.tokens.max()) < cfg.vocab
          and int(res.tokens.min()) >= 0, "serve: tokens out of range")
    check(launches["selective_scan"] == cfg.n_layers
          and all(v == 0 for k, v in launches.items()
                  if k != "selective_scan"),
          f"serve: launches {launches}, expected {cfg.n_layers} "
          f"selective_scan (one a layer, in prefill) and no other")
    # the split of those launches: a prefill alone, a decode step alone
    _counts_zero()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": tokens})
    torch.cuda.synchronize()
    prefill2_s = time.perf_counter() - t0
    prefill_launches = _counts()["selective_scan"]
    same = bool(torch.equal(logits[:, -1], res.logits[:, 0]))
    check(same, "serve: a second prefill's last logits differ from the "
                "first's (not bit-repeatable)")
    _counts_zero()
    tok = res.tokens[:, :1]
    with torch.no_grad():
        model.decode_step(cache, tok, None)
    torch.cuda.synchronize()
    decode_launches = _counts()["selective_scan"]
    check(prefill_launches == cfg.n_layers and decode_launches == 0,
          f"serve: {prefill_launches} B7 launches a prefill and "
          f"{decode_launches} a decode step, expected {cfg.n_layers} "
          f"and 0")
    with torch.no_grad():
        prof = _profile_ticks("profile_serve_decode",
                              lambda: model.decode_step(cache, tok, None),
                              1, groups=SERVE_GROUPS, unit="step")
    steps = args.gen - 1
    out = {"params": n_params, "layers": cfg.n_layers,
           "batch": args.batch, "prompt_len": args.prompt_len,
           "gen": args.gen, "init_s": init_s,
           "prefill_ms": res.prefill_s * 1e3,
           "prefill_again_ms": prefill2_s * 1e3,
           "prefill_again_equal": same,
           "decode_ms_per_step": res.decode_s / steps * 1e3,
           "decode_tok_s": steps * args.batch / res.decode_s,
           "generated_tok_s": args.gen * args.batch / (res.prefill_s
                                                       + res.decode_s),
           "launches": launches, "prefill_launches": prefill_launches,
           "decode_step_launches": decode_launches,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "decode_device_busy_share": prof["device_busy_share"],
           "seq0": res.tokens[0, :12].tolist()}
    emit("serve_falcon_mamba_7b", **out)
    del cache, logits
    return model, batch, res.tokens, out


def phase_serve_consistency(model, batch, gen_tokens,
                            label="serve_consistency", max_prompt=None):
    """Float32 compute on the same weights: prefill and teacher-forced
    decode against ``forward`` over the prompt and the forced tokens.
    ``batch`` is the prompt batch (``"tokens"`` and, for an image model,
    ``"img_embed"``); ``max_prompt`` cuts the prompt to its first
    tokens.  An MoE runs with ``capacity_factor = num_experts / top_k``,
    which gives every expert a slot for every token: the capacity
    follows the sequence length, so a forward over S + 8 tokens and a
    prefill over S would otherwise drop other tokens by design."""
    import copy
    import dataclasses
    import torch
    t_phase = time.perf_counter()
    cfg32 = model.cfg.with_(compute_dtype=torch.float32)
    if cfg32.moe is not None:
        m = cfg32.moe
        cfg32 = cfg32.with_(moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    # the same parameters under another compute dtype: the model's methods
    # read their config from the model, the blocks hold none
    m32 = copy.copy(model)
    m32.cfg = cfg32
    prompt = batch["tokens"][:, :max_prompt]
    B, S = prompt.shape
    seq = torch.cat([prompt, gen_tokens[:, :SERVE_FORCED].to(prompt.dtype)],
                    1)
    errs = []

    def err(want, got):
        d = (got.float() - want.float()).abs()
        return (float(d.max()), float((d / (1 + want.abs())).max()))

    t0 = time.perf_counter()
    with torch.no_grad():
        full, aux = m32.forward(dict(batch, tokens=seq))
        check(full.dtype == torch.float32, "float32 compute gave "
                                           f"{full.dtype} logits")
        drop = float(aux["drop_frac"])
        check(drop == 0.0, f"{label}: forward dropped {drop} of the MoE "
                           f"choices at a capacity that keeps them all")
        # room for the forced tokens: a full cache of depth S would clamp
        # their slots to S - 1, as the reference's dynamic_update_slice does
        logits, cache = m32.prefill(dict(batch, tokens=prompt),
                                    max_len=S + SERVE_FORCED)
        errs.append(err(full[:, S - 1], logits[:, 0]))
        for i in range(SERVE_FORCED):
            pos = torch.full((B,), S + i, dtype=torch.int32,
                             device=prompt.device)
            logits, cache = m32.decode_step(cache, seq[:, S + i:S + i + 1],
                                            pos)
            errs.append(err(full[:, S + i], logits[:, 0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    worst = max(e[1] for e in errs)
    extra = {}
    if cfg32.moe is not None:
        extra = {"capacity_factor": cfg32.moe.capacity_factor,
                 "drop_frac": drop}
    if max_prompt is not None:
        extra["prompt_cut"] = [batch["tokens"].shape[1], S]
    if "img_embed" in batch:
        extra["img_tokens"] = list(batch["img_embed"].shape)
    ring = [c for c in cache if "slot_pos" in c]
    emit(label, tokens=list(seq.shape), forced=SERVE_FORCED,
         tol=SERVE_CONSISTENCY_TOL, layers=model.cfg.n_layers,
         ring_cache=bool(ring),
         prefill_max_abs_err=errs[0][0], prefill_scaled_err=errs[0][1],
         decode_max_abs_err=[e[0] for e in errs[1:]],
         decode_scaled_err=[e[1] for e in errs[1:]], worst_scaled_err=worst,
         max_abs_logit=float(full[..., :cfg32.vocab].abs().max()),
         wall_s=wall, phase_s=time.perf_counter() - t_phase, **extra)
    check(worst <= SERVE_CONSISTENCY_TOL,
          f"{label}: {worst} > {SERVE_CONSISTENCY_TOL}")
    return worst


# --- the dense, MoE, hybrid and vision serve paths, the encoder ------------

#: granite-3-2b at its published widths and depth (40 layers)
GRANITE_ARGV = ["--arch", "granite_3_2b", "--batch", "4", "--prompt-len",
                "2048", "--gen", "32", "--seed", "0"]
#: mixtral-8x22b at its published widths, the depth cut from 56 layers
#: to 2 (one card holds ~22 GB of its float32 weights, not ~564 GB);
#: 6144-token prompts run past the 4096-token window: a ring cache
MIXTRAL_LAYERS = 2
MIXTRAL_ARGV = ["--arch", "mixtral_8x22b", "--layers", str(MIXTRAL_LAYERS),
                "--batch", "2", "--prompt-len", "6144", "--gen", "32",
                "--seed", "0"]
#: jamba-v0.1-52b at its published widths, the depth cut from 32 layers
#: to one 8-layer period (every block kind: 3 mamba_ffn, 4 mamba_moe, 1
#: attn_ffn; ~13.3 B float32 parameters, ~53 GB; all 32 ~206 GB)
JAMBA_LAYERS = 8
JAMBA_ARGV = ["--arch", "jamba_v01_52b", "--layers", str(JAMBA_LAYERS),
              "--batch", "2", "--prompt-len", "4096", "--gen", "32",
              "--seed", "0"]
#: llama-3.2-11b-vision at its published widths and depth (40 layers, 8
#: of them gated cross-attention over 1600 stub image tokens of width
#: 1280)
LLAMA_ARGV = ["--arch", "llama32_vision_11b", "--batch", "4",
              "--prompt-len", "2048", "--gen", "32", "--seed", "0"]
#: the cross-attention gates' value in the vision phases: the reference
#: initialises them to 0, where the image cannot change a token
XGATE = 1.0
#: the hybrid's float32 check cuts its prompt to this many tokens: at
#: 4096 its all-slot float32 MoE buffers (16 experts x 4104 slots x
#: 14336, ~3.8 GB each, several live at once in the SiLU) would sit
#: beside ~53 GB of weights
HYBRID_CHECK_PROMPT = 1024
#: minitron-8b at its published widths and depth (32 layers, d_model
#: 4096, 32 / 8 heads, a squared-ReLU FFN of 16384, an untied 256,000-
#: token head; 7.73 B float32 parameters, 30.9 GB)
MINITRON_ARGV = ["--arch", "minitron_8b", "--batch", "4", "--prompt-len",
                 "2048", "--gen", "32", "--seed", "0"]
#: qwen3-14b at its published widths and depth (40 layers, d_model
#: 5120, 40 / 8 heads of 128 with qk-norm, d_ff 17408, vocab 151,936;
#: 14.77 B float32 parameters, 59.1 GB)
QWEN3_ARGV = ["--arch", "qwen3_14b", "--batch", "4", "--prompt-len",
              "2048", "--gen", "32", "--seed", "0"]
#: moonshot-v1-16b-a3b at its published widths (d_model 2048, 16 / 16
#: heads, 64 experts of d_ff 1408, top-6, vocab 163,840) with the depth
#: cut from 48 layers to 16: all 48 are 112.2 GB of float32 weights, 16
#: are 9.80 B parameters, 39.2 GB
MOONSHOT_LAYERS = 16
MOONSHOT_ARGV = ["--arch", "moonshot_v1_16b_a3b", "--layers",
                 str(MOONSHOT_LAYERS), "--batch", "4", "--prompt-len",
                 "2048", "--gen", "32", "--seed", "0"]
#: (phase, argv, depth cut, B7 launches a prefill, xgate, consistency
#: phase, rows it checks, prompt tokens it keeps)
LM_CELLS = (("serve_granite_3_2b", GRANITE_ARGV, None, 0, None,
             "serve_consistency_dense", 4, None),
            ("serve_mixtral_8x22b_l2", MIXTRAL_ARGV,
             {"n_layers": [56, MIXTRAL_LAYERS]}, 0, None,
             "serve_consistency_moe", 1, None),
            ("serve_jamba_v01_52b_l8", JAMBA_ARGV,
             {"n_layers": [32, JAMBA_LAYERS]}, 7, None,
             "serve_consistency_hybrid", 1, HYBRID_CHECK_PROMPT),
            ("serve_llama32_vision_11b", LLAMA_ARGV, None, 0, XGATE,
             "serve_consistency_vision", 1, None),
            ("serve_minitron_8b", MINITRON_ARGV, None, 0, None,
             "serve_consistency_minitron", 1, None),
            ("serve_qwen3_14b", QWEN3_ARGV, None, 0, None,
             "serve_consistency_qwen3", 1, None),
            ("serve_moonshot_v1_16b_a3b_l16", MOONSHOT_ARGV,
             {"n_layers": [48, MOONSHOT_LAYERS]}, 0, None,
             "serve_consistency_moonshot", 1, None))
LM_GROUPS = {"matmul": SERVE_GROUPS["matmul"],
             "copies and casts": SERVE_GROUPS["copies and casts"],
             "reductions and softmax": ("reduce", "softmax", "Reduce"),
             "elementwise": ("elementwise", "vectorized", "unrolled"),
             "selective_scan (B7)": ("selective_scan",)}
#: float32 parameters that the products read as they are (the Mamba
#: block's float32 products, the router) or outside a decode step (the
#: image frontend): no bf16 cast a step
UNCAST = ("router", "conv_w", "x_proj", "dt_proj", "A_log", "frontend.w")


def _decode_breakdown(model, cache, tok, pos) -> dict:
    """CUDA-event ms of one decode step beside two of its parts, timed
    apart: the attention core (``decode_attention``, float32 products,
    on every attention layer's cache, cross-attention's included) and
    the per-call bf16 casts of the float32 weights that the products
    read."""
    import torch
    from repro_torch.models import layers as L
    cfg = model.cfg
    cd = cfg.compute_dtype
    B, K, dh = tok.shape[0], cfg.n_kv_heads, cfg.d_head
    G = cfg.n_heads // K
    gen = torch.Generator(device=tok.device).manual_seed(0)
    q = torch.randn((B, 1, K, G, dh), generator=gen, device=tok.device
                    ).to(cd)
    attn = [c for c in cache if "k" in c]
    valid = [(c["slot_pos"] >= 0) if "slot_pos" in c else
             torch.arange(c["k"].shape[1], device=tok.device)[None, :]
             <= pos[:, None] for c in attn]

    def attn_core():
        for c, ok in zip(attn, valid):
            L.decode_attention(q, c["k"], c["v"], ok)

    weights = [w for name, w in model.named_parameters()
               if w.dim() >= 2 and (name != "embed.table"
                                    or cfg.tie_embeddings)
               and not name.endswith(UNCAST)]

    def casts():
        for w in weights:
            w.to(cd)

    with torch.no_grad():
        step = time_ms(lambda: model.decode_step(cache, tok, pos), n=5,
                       warm=1)
        core = time_ms(attn_core, n=5, warm=1)
        cast = time_ms(casts, n=5, warm=1)
    cast_bytes = sum(w.numel() * (w.element_size() + 2) for w in weights)
    return {"decode_step_event_ms": step, "attn_core_ms": core,
            "attn_core_share": core / step, "weight_cast_ms": cast,
            "weight_cast_share": cast / step,
            "weight_cast_bytes": cast_bytes,
            "weight_cast_bound_ms": cast_bytes / HBM_BYTES_S * 1e3}


def _set_xgates(model, value: float) -> int:
    """Every cross-attention gate of ``model`` set to ``value``; the
    number of gates."""
    import torch
    gates = [b.xgate for b in model.stack.blocks if hasattr(b, "xgate")]
    with torch.no_grad():
        for g in gates:
            g.fill_(value)
    return len(gates)


def _vision_checks(label, model, cfg, args, batch, cache, tok, pos,
                   logits) -> dict:
    """A decode step hands every cross-attention layer's cache back
    unchanged (the same tensors, the same values), and the last prefill
    logits move when the image is another seed's."""
    import torch
    from repro_torch.data import SyntheticLM
    cross = [i for i, b in enumerate(model.stack.blocks)
             if hasattr(b, "xgate")]
    kept = {i: cache[i]["k"].clone() for i in cross}
    with torch.no_grad():
        _, new = model.decode_step(cache, tok, pos)
    same = all(new[i] is cache[i] and torch.equal(new[i]["k"], kept[i])
               for i in cross)
    check(same, f"{label}: a decode step changed a cross-attention cache")
    other = SyntheticLM(cfg.vocab, args.prompt_len, args.batch,
                        seed=args.seed + 1, modality=cfg.modality,
                        d_frontend=cfg.d_frontend,
                        n_img_tokens=cfg.n_img_tokens).batch(0)
    img = torch.from_numpy(other["img_embed"]).to(tok.device)
    with torch.no_grad():
        moved, _ = model.prefill(dict(batch, img_embed=img))
    delta = float((moved[:, -1].float() - logits[:, -1].float()).abs().max())
    check(delta > 0, f"{label}: another image left the logits unchanged")
    del new, moved
    return {"cross_layers": len(cross), "cross_cache_unchanged": same,
            "other_image_max_logit_change": delta,
            "cross_cache": list(cache[cross[0]]["k"].shape)}


#: the cells whose ``serve.generate`` runs twice, tokens and logits
#: held equal (the top-6 MoE's combine, ``moe._combine``, in fixed order)
GENERATE_AGAIN = ("serve_moonshot_v1_16b_a3b_l16",)


def phase_serve_lm(label, argv, reduced=None, scans=0, xgate=None):
    """A model served through ``repro_torch.launch.serve``:
    ``serve.setup`` seeds it on the card, ``serve.generate`` prefills the
    prompts (with their stub image embeddings for a vision model) and
    decodes greedily.  ``scans`` is the number of B7 launches a prefill
    must make (one a Mamba layer) and a decode step none; no other port
    kernel runs.  ``xgate`` sets every cross-attention gate after the
    seeded init."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.model import param_count
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    args, cfg, model, batch = serve.setup(argv)
    tokens = batch["tokens"]
    n_gates = 0 if xgate is None else _set_xgates(model, xgate)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)

    def held(launches, want, what):
        check(launches.get("selective_scan", 0) == want
              and all(v == 0 for k, v in launches.items()
                      if k != "selective_scan"),
              f"{label}: {what} launched {launches}, expected {want} "
              f"selective_scan and no other port kernel")

    _counts_zero()
    res = serve.generate(model, batch, args.gen)
    launches = _counts()
    live = res.logits[..., :cfg.vocab].float()
    check(bool(torch.isfinite(live).all()), f"{label}: logits not finite")
    check(tuple(res.tokens.shape) == (args.batch, args.gen)
          and int(res.tokens.max()) < cfg.vocab
          and int(res.tokens.min()) >= 0, f"{label}: tokens out of range")
    held(launches, scans, "the run")
    _counts_zero()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(batch,
                                      max_len=args.prompt_len + args.gen)
    torch.cuda.synchronize()
    prefill2_s = time.perf_counter() - t0
    prefill_launches = _counts()
    held(prefill_launches, scans, "a prefill")
    same = bool(torch.equal(logits[:, -1], res.logits[:, 0]))
    check(same, f"{label}: a second prefill's last logits differ from "
                f"the first's (not bit-repeatable)")
    tok = res.tokens[:, :1]
    pos = torch.full((args.batch,), args.prompt_len, dtype=torch.int32,
                     device=tokens.device)
    _counts_zero()
    with torch.no_grad():
        model.decode_step(cache, tok, pos)
    torch.cuda.synchronize()
    decode_launches = _counts()
    held(decode_launches, 0, "a decode step")
    ring = [c for c in cache if "slot_pos" in c]
    check(bool(ring) == bool(cfg.sliding_window
                             and cfg.sliding_window < args.prompt_len),
          f"{label}: ring cache {bool(ring)} for window "
          f"{cfg.sliding_window} and {args.prompt_len}-token prompts")
    vision = {}
    if n_gates:
        vision = _vision_checks(label, model, cfg, args, batch, cache, tok,
                                pos, logits)
        vision["xgate"] = {"value": xgate, "gates": n_gates,
                           "why": "the reference initialises every xgate "
                                  "to 0, where the image changes nothing"}
    with torch.no_grad():
        prof = _profile_ticks(f"profile_{label}_decode",
                              lambda: model.decode_step(cache, tok, pos),
                              1, groups=LM_GROUPS, unit="step")
    parts = _decode_breakdown(model, cache, tok, pos)
    again = {}
    if label in GENERATE_AGAIN:
        res2 = serve.generate(model, batch, args.gen)
        again = {"generate_again_equal": bool(torch.equal(res2.tokens,
                                                          res.tokens)),
                 "generate_again_logits_equal": bool(torch.equal(
                     res2.logits, res.logits)),
                 "generate_again_decode_ms_per_step":
                     res2.decode_s / (args.gen - 1) * 1e3}
        check(again["generate_again_equal"]
              and again["generate_again_logits_equal"],
              f"{label}: a second generate gave other tokens or logits "
              f"than the first")
        del res2
    steps = args.gen - 1
    out = {"params": n_params, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "batch": args.batch, "prompt_len": args.prompt_len,
           "gen": args.gen, "init_s": init_s,
           "prefill_ms": res.prefill_s * 1e3,
           "prefill_again_ms": prefill2_s * 1e3,
           "prefill_again_equal": same,
           "decode_ms_per_step": res.decode_s / steps * 1e3,
           "decode_tok_s": steps * args.batch / res.decode_s,
           "generated_tok_s": args.gen * args.batch / (res.prefill_s
                                                       + res.decode_s),
           "launches": launches,
           "prefill_launches": prefill_launches,
           "decode_step_launches": decode_launches,
           "ring_cache": [list(c["k"].shape) for c in ring[:1]],
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "decode_device_busy_share": prof["device_busy_share"],
           "decode_kernels_per_step": prof.get("kernels_per_step"),
           "decode_us_by_group": prof.get("us_per_step_by_group"),
           **parts, **vision, **again,
           "seq0": res.tokens[0, :12].tolist()}
    if cfg.moe is not None:
        with torch.no_grad():
            _, aux = model.forward(batch)
        n_moe = sum(hasattr(b, "moe") for b in model.stack.blocks)
        out["drop_frac"] = float(aux["drop_frac"]) / n_moe
        out["capacity_factor"] = cfg.moe.capacity_factor
    if reduced:
        out["reduced"] = reduced
    del cache, logits
    out["phase_s"] = time.perf_counter() - t_phase
    emit(label, **out)
    return model, batch, res.tokens, out


#: the cells whose first MoE layer is also run on the host on the same
#: input row (fine-grained dispatch: 64 experts, top-6)
DISPATCH_VS_HOST = ("serve_moonshot_v1_16b_a3b_l16",)


def phase_moe_dispatch_vs_host(label, model, batch) -> dict:
    """The first MoE layer's capacity dispatch on the card and on the
    host, on the same input: the layer's input on the first prompt row,
    caught in a prefill of that row, then ``moe_apply`` in float32
    compute on both devices (the router is float32 in any compute
    dtype, so both route the same bits up to the products' summation
    order): each side's dropped share of the choices, how many of the
    row's top-k choices differ, and the outputs' largest gap.  Where no
    choice differs the dispatch must drop the same share on both.  The
    prefill's dropped share at every MoE layer is reported beside it."""
    import copy
    import torch
    from repro_torch.models import moe as MOE
    blk = next(b for b in model.stack.blocks if hasattr(b, "moe"))
    seen = {}
    apply = MOE.moe_apply

    def spy(p, cfg, x, par=None):
        if p is blk.moe and "x" not in seen:
            seen["x"] = x.detach().clone()
        y, aux = apply(p, cfg, x, par)
        seen.setdefault("drops", []).append(float(aux["drop_frac"]))
        return y, aux

    MOE.moe_apply = spy
    try:
        with torch.no_grad():
            model.prefill({k: v[:1] for k, v in batch.items()})
    finally:
        MOE.moe_apply = apply
    x = seen["x"]
    cfg32 = model.cfg.with_(compute_dtype=torch.float32)
    host = copy.deepcopy(blk.moe).to("cpu")

    def choices(p, xx):
        """Each token's top-k experts, by a second router pass."""
        probs = torch.softmax(xx.float() @ p.router, -1)
        return MOE._top_k(probs, cfg32.moe.top_k)[1]

    with torch.no_grad():
        t0 = time.perf_counter()
        y_card, aux_card = apply(blk.moe, cfg32, x)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        y_host, aux_host = apply(host, cfg32, x.cpu())
        host_s = time.perf_counter() - t0
        choice_card = choices(blk.moe, x).cpu()
        choice_host = choices(host, x.cpu())
    # the dropped share is a float32 mean over the row's S·k choices,
    # summed in another order on each device: compare the counts
    n_choices = x.shape[0] * x.shape[1] * cfg32.moe.top_k
    out = {"tokens": list(x.shape[:2]),
           "experts": cfg32.moe.num_experts, "top_k": cfg32.moe.top_k,
           "capacity_factor": cfg32.moe.capacity_factor,
           "slots_an_expert": MOE._capacity(cfg32, x.shape[1]),
           "choices": n_choices,
           "drop_frac_card": float(aux_card["drop_frac"]),
           "drop_frac_host": float(aux_host["drop_frac"]),
           "dropped_card": round(float(aux_card["drop_frac"]) * n_choices),
           "dropped_host": round(float(aux_host["drop_frac"]) * n_choices),
           "choices_differ": int((choice_card != choice_host).sum()),
           "out_max_abs_gap": float((y_card.cpu() - y_host).abs().max()),
           "out_max_abs": float(y_host.abs().max()),
           "card_s": card_s, "host_s": host_s,
           "drop_frac_by_layer": seen["drops"]}
    emit(f"{label}_dispatch_vs_host", **out)
    check(out["dropped_card"] == out["dropped_host"]
          or out["choices_differ"] > 0,
          f"{label}: the card dropped {out['dropped_card']} and the host "
          f"{out['dropped_host']} of the same {n_choices} choices")
    del host, y_card, y_host
    return out


#: hubert-xlarge at its published widths and depth, 8 utterances of 1024
#: stub frames (20 s of audio each at 50 frames a second)
HUBERT_BATCH, HUBERT_FRAMES = 8, 1024
#: |float32 score of utterance 0 alone - its row of the batch| <=
#: tol + tol·|batch row| (the serving contract's 2e-4)
HUBERT_TOL = 2e-4


def phase_score_hubert():
    """The encoder family: hubert-xlarge scored through ``LM.score`` at
    full width and depth on ``SyntheticLM``'s audio frames; then, in
    float32 compute on the same weights, bidirectionality (the last
    frame of utterance 0 moves its first frame's logits) and batch
    independence (utterance 0 alone equals its row)."""
    import copy
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.model import build_model, param_count
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("hubert_xlarge")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    frames = torch.from_numpy(SyntheticLM(
        cfg.vocab, HUBERT_FRAMES, HUBERT_BATCH, seed=0,
        modality=cfg.modality, d_frontend=cfg.d_frontend).batch(0)
        ["frames"]).to(model.device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _counts_zero()
    times = []
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            logits = model.score({"frames": frames})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = _counts()
    check(all(v == 0 for v in launches.values()),
          f"score_hubert_xlarge: launches {launches}, expected no kernel "
          f"of the port")
    want = (HUBERT_BATCH, HUBERT_FRAMES, padded_vocab(cfg.vocab))
    check(tuple(logits.shape) == want
          and bool(torch.isfinite(logits[..., :cfg.vocab].float()).all()),
          f"score_hubert_xlarge: logits {tuple(logits.shape)} not finite "
          f"or not {want}")
    check(int(logits.argmax(-1).max()) < cfg.vocab,
          "score_hubert_xlarge: a padded id won an argmax")
    with torch.no_grad():
        prof = _profile_ticks("profile_score_hubert_xlarge",
                              lambda: model.score({"frames": frames}), 1,
                              groups=LM_GROUPS, unit="batch")
    m32 = copy.copy(model)
    m32.cfg = cfg.with_(compute_dtype=torch.float32)
    with torch.no_grad():
        full = m32.score({"frames": frames})
        alone = m32.score({"frames": frames[:1]})
        other = frames[:1].clone()
        other[0, -1] += 1.0
        moved = m32.score({"frames": other})
    first = float((moved[0, 0] - alone[0, 0]).abs().max())
    check(first > 0, "score_hubert_xlarge: the last frame did not reach "
                     "the first frame's logits (a causal mask?)")
    d = (alone[0] - full[0]).abs()
    indep = float((d / (1 + full[0].abs())).max())
    check(indep <= HUBERT_TOL, f"score_hubert_xlarge: utterance 0 alone "
                               f"differs from its batch row by {indep}")
    out = {"params": param_count(model), "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": cfg.n_heads, "d_ff": cfg.d_ff,
           "vocab": [cfg.vocab, logits.shape[-1]], "act": cfg.act,
           "causal": cfg.causal, "batch": HUBERT_BATCH,
           "frames": HUBERT_FRAMES, "init_s": init_s,
           "score_ms": times[0] * 1e3, "score_again_ms": times[1] * 1e3,
           "frames_per_s": HUBERT_BATCH * HUBERT_FRAMES / times[1],
           "launches": launches,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "device_busy_share": prof["device_busy_share"],
           "kernels_per_batch": prof.get("kernels_per_batch"),
           "us_by_group": prof.get("us_per_batch_by_group"),
           "first_frame_change_from_last": first,
           "batch_independence_scaled_err": indep, "tol": HUBERT_TOL,
           "phase_s": time.perf_counter() - t_phase}
    emit("score_hubert_xlarge", **out)
    del model, m32, logits, full
    return out


# --- training (A.11b): B7's backward, falcon-mamba and granite, drills ---

#: the gradients of the scan's backward, in its return order
SCAN_GRADS = ("dx", "ddt", "db", "dc", "da")


def phase_scan_bwd_kernel():
    """The scan's backward kernel against ``ref.selective_scan_bwd`` on
    every ``scan_specs(card=True)`` case, dh_final zero and random, each
    run twice (bit-equal); ``SelectiveScanFn`` on CUDA against autograd
    through the plain forward on CUDA; then timed at the training shape
    beside its bound and its plain version."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ssk
    from _torch_cases import (SCAN_TRAIN_SHAPE, scan_arrays, scan_bwd_tol,
                              scan_cotangents, scan_specs)
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cases, worst_abs, worst_scaled = [], 0.0, 0.0
    train_args = train_spec = None
    for spec in scan_specs(card=True):
        name, shape, _, _ = spec
        tol = scan_bwd_tol(spec)
        args = [torch.from_numpy(v).to(dev) for v in scan_arrays(spec)]
        for dh in (False, True):
            dy, dhf = (torch.from_numpy(v).to(dev)
                       for v in scan_cotangents(spec, dh))
            dhf = dhf if dh else None
            got = ssk.selective_scan_bwd(*args, dy, dhf)
            again = ssk.selective_scan_bwd(*args, dy, dhf)
            want = ref.selective_scan_bwd(*args, dy, dhf)
            torch.cuda.synchronize()
            errs = {}
            for label, w, g, g2 in zip(SCAN_GRADS, want, got, again):
                check(g.shape == w.shape and g.dtype == torch.float32,
                      f"{name}: {label} shape or dtype differs")
                check(bool(torch.isfinite(g).all()),
                      f"{name}: {label} not finite")
                check(torch.equal(g.view(torch.int32), g2.view(torch.int32)),
                      f"{name}: {label} differs between two runs")
                ab = float((g - w).abs().max()) if g.numel() else 0.0
                top = float(w.abs().max()) if w.numel() else 0.0
                scaled = ab / top if top > 0 else ab
                errs[label] = {"max_abs_err": ab, "scaled_err": scaled}
                check(ab <= tol * top + 1e-30,
                      f"{name} dh={dh}: {label} off by {ab} > {tol} x "
                      f"max |plain| {top}")
                worst_abs = max(worst_abs, ab)
                worst_scaled = max(worst_scaled, scaled)
            cases.append({"case": name, "shape": list(shape),
                          "dh_final": dh, "tol": tol, "bit_equal_rerun":
                          True, **errs})
            del got, again, want
        if tuple(shape) == SCAN_TRAIN_SHAPE and train_args is None:
            train_args, train_spec = args, spec
        else:
            del args
    emit("scan_bwd_vs_plain", cases=cases, max_abs_err=worst_abs,
         max_scaled_err=worst_scaled,
         tolerance="|kernel - plain| <= tol x max|plain| per gradient")
    # the autograd wiring on the card: which cotangent goes where
    wiring = []
    for shape in ((2, 40, 24, 16), (1, 33, 65, 5)):
        B, S, d, N = shape
        g = torch.Generator(device=dev).manual_seed(B * 100 + S)
        ins = [torch.randn((B, S, d), generator=g, device=dev),
               torch.rand((B, S, d), generator=g, device=dev) * 0.3,
               torch.randn((B, S, N), generator=g, device=dev),
               torch.randn((B, S, N), generator=g, device=dev),
               -torch.rand((d, N), generator=g, device=dev) - 0.1]
        dy = torch.randn((B, S, d), generator=g, device=dev)
        dh = torch.randn((B, d, N), generator=g, device=dev)
        for with_h in (False, True):
            a1 = [t.clone().requires_grad_() for t in ins]
            a2 = [t.clone().requires_grad_() for t in ins]
            before = ssk.selective_scan_bwd.launches
            y1, h1 = ssk.SelectiveScanFn.apply(*a1)
            y2, h2 = ref.selective_scan(*a2)
            outs1, outs2, cots = ((y1, h1), (y2, h2), (dy, dh)) if with_h \
                else ((y1,), (y2,), (dy,))
            g1 = torch.autograd.grad(outs1, a1, cots)
            g2 = torch.autograd.grad(outs2, a2, cots)
            check(ssk.selective_scan_bwd.launches == before + 1,
                  "SelectiveScanFn's backward did not launch the kernel")
            err = max(float((p - q).abs().max() / q.abs().max())
                      for p, q in zip(g1, g2))
            check(err <= 1e-5, f"SelectiveScanFn {shape} dh={with_h}: "
                               f"{err} from autograd through the plain scan")
            wiring.append({"shape": list(shape), "dh_final": with_h,
                           "scaled_err": err})
    x, dt, b, c, a = train_args
    dy = torch.from_numpy(scan_cotangents(train_spec, False)[0]).to(dev)

    def kern():
        return ssk.selective_scan_bwd(x, dt, b, c, a, dy)

    def plain():
        return ref.selective_scan_bwd(x, dt, b, c, a, dy)

    dms, pdms = device_ms(kern, n=10), device_ms(plain, n=1)
    seen = dms is not None and pdms is not None
    call_ms = time_ms(kern, n=10, warm=2)
    bound = ssk.scan_bwd_bound(*SCAN_TRAIN_SHAPE)
    out = {"ms": dms if seen else call_ms,
           "plain_ms": pdms if seen else time_ms(plain, n=1, warm=0),
           "ms_source": ("profiler device time per call (the scan kernel "
                         "and its reduction)" if seen
                         else "CUDA events, back-to-back calls"),
           "call_ms": call_ms, **bound, "library_ms": None,
           "max_abs_err": worst_abs, "max_scaled_err": worst_scaled,
           "plan": ssk.bwd_plan(SCAN_TRAIN_SHAPE[3]),
           "forward_ms": time_ms(lambda: ssk.selective_scan(x, dt, b, c, a),
                                 n=10, warm=2)}
    emit("scan_bwd_kernel_time", shape=list(SCAN_TRAIN_SHAPE), **out,
         wiring=wiring, phase_s=time.perf_counter() - t_phase,
         library="none: no PyTorch call computes the scan's gradient")
    del train_args, x, dt, b, c, a, dy
    return out


#: falcon-mamba-7b at its published widths, the depth cut from 64 layers
#: to 16: its full training state (float32 parameters, gradients and two
#: moments, 16 bytes a parameter) is ~116 GB, 16 layers ~36 GB
FALCON_TRAIN_LAYERS = 16
TRAIN_STEPS = 8
FALCON_TRAIN_ARGV = ["--arch", "falcon_mamba_7b", "--layers",
                     str(FALCON_TRAIN_LAYERS), "--batch", "4", "--seq",
                     "2048", "--steps", str(TRAIN_STEPS), "--seed", "0",
                     "--log-every", "0"]
#: granite-3-2b at its published widths and depth (~42 GB of state)
GRANITE_TRAIN_ARGV = ["--arch", "granite_3_2b", "--batch", "4", "--seq",
                      "2048", "--steps", str(TRAIN_STEPS), "--seed", "0",
                      "--log-every", "0"]
#: (phase, argv, depth cut, B7 forward and backward launches a step: with
#: per-period "full" remat a Mamba layer's scan runs in the forward and
#: again in the recompute, and its backward kernel once)
TRAIN_CELLS = (("train_falcon_mamba_7b_l16", FALCON_TRAIN_ARGV,
                {"n_layers": [64, FALCON_TRAIN_LAYERS]},
                (2 * FALCON_TRAIN_LAYERS, FALCON_TRAIN_LAYERS)),
               ("train_granite_3_2b", GRANITE_TRAIN_ARGV, None, (0, 0)))
TRAIN_GROUPS = {"B7 forward": ("selective_scan_kernel",),
                "B7 backward": ("selective_scan_bwd",),
                "matmul": SERVE_GROUPS["matmul"],
                "copies and casts": SERVE_GROUPS["copies and casts"],
                "reductions": ("reduce", "Reduce"),
                "elementwise": ("elementwise", "vectorized", "unrolled"),
                "index and scatter": ("index", "scatter", "gather",
                                      "sort", "Sort")}
#: the bf16 dense peak of the H100 SXM (data sheet), for mfu
BF16_PEAK_FLOPS = 989e12


def phase_train_lm(label, argv, reduced, b7):
    """A model trained through ``repro_torch.launch.train`` (``setup``
    then ``run``): ``TRAIN_STEPS`` steps of SyntheticLM batches, every
    metric finite each step and the B7 launches of each step exactly
    ``b7`` (forward, backward) with no other port kernel; ms a step (the
    first, the median of the rest), tokens/s, peak memory, mfu; then one
    more step profiled (busy share, time by group), the AdamW update and
    the cross-entropy timed alone, and two steps without deterministic
    algorithms, to price them."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import layers as L
    from repro_torch.models.model import param_count
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as tl
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    r = train.setup(argv)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(r.model)
    cfg, args = r.cfg, r.args
    tokens = args.batch * args.seq
    times, losses, per_step = [], [], []
    mark = [0.0]

    def on_metrics(step, m):
        vals = {k: float(v) for k, v in m.items()}   # syncs the step
        now = time.perf_counter()
        times.append(now - mark[0])
        mark[0] = now
        check(all(v == v and abs(v) != float("inf") for v in vals.values()),
              f"{label}: step {step} metrics not finite: {vals}")
        losses.append(vals["loss"])
        per_step.append(_counts())
        _counts_zero()

    _counts_zero()
    mark[0] = time.perf_counter()
    state, info = train.run(r, on_metrics=on_metrics)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"selective_scan": b7[0], "selective_scan_bwd": b7[1]}
    for i, c in enumerate(per_step):
        check(all(c.get(k, 0) == want.get(k, 0) for k in c),
              f"{label}: step {i + 1} launched {c}, expected {want} and "
              f"no other port kernel")
    step_s = statistics.median(times[1:])
    batch = r.data.batch(args.steps)
    _counts_zero()
    prof = _profile_ticks(f"profile_{label}",
                          lambda: r.step_fn(state, batch), 1,
                          groups=TRAIN_GROUPS, unit="step")
    prof_counts = _counts()
    # the AdamW update alone (CUDA events) on zero gradients at lr 0: the
    # step's update, leaving the parameters as they are
    zeros = {k: torch.zeros_like(p) for k, p in state.params.items()}
    opt = state.opt
    adamw_ms = time_ms(lambda: adamw.update(zeros, opt, state.params,
                                            lr=0.0), n=2, warm=1)
    del zeros
    # the cross-entropy alone: the final hidden states through the
    # chunked head and NLL, forward and backward
    g = torch.Generator(device=batch["labels"].device).manual_seed(5)
    h = torch.randn((args.batch, args.seq, cfg.d_model), generator=g,
                    device=batch["labels"].device).to(cfg.compute_dtype)
    h.requires_grad_()
    chunk = r.model._loss_chunk(args.seq) or args.seq

    def ce():
        nll = L.chunked_cross_entropy(r.model._head_raw, h,
                                      batch["labels"], None, chunk)
        nll.backward()
        h.grad = None

    ce_ms = time_ms(ce, n=3, warm=1)
    for p in r.model.parameters():
        p.grad = None
    del h
    loose = tl.make_train_step(r.model, r.run_cfg, deterministic=False)
    loose_times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = loose(state, batch)
        float(m["loss"])
        loose_times.append(time.perf_counter() - t1)
    flops = 6 * n_params * tokens
    out = {"params": n_params, "layers": cfg.n_layers, "batch": args.batch,
           "seq": args.seq, "tokens_per_step": tokens, "steps": args.steps,
           "reduced": reduced, "compute_dtype": str(cfg.compute_dtype),
           "remat": cfg.remat, "grad_accum": r.run_cfg.grad_accum,
           "init_s": init_s, "first_step_ms": times[0] * 1e3,
           "step_ms_median": step_s * 1e3,
           "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": tokens / step_s, "loss_first": losses[0],
           "loss_last": losses[-1], "max_memory_allocated_gb": peak_gb,
           "mfu": flops / (step_s * BF16_PEAK_FLOPS),
           "mfu_formula": "6 x params x tokens / (step s x 989e12)",
           "b7_launches_per_step": {"forward": b7[0], "backward": b7[1]},
           "launches": {k: sum(c.get(k, 0) for c in per_step)
                        for k in want},
           "profiled_step_launches": prof_counts,
           "device_busy_share": prof["device_busy_share"],
           "us_by_group": prof.get("us_per_step_by_group"),
           "adamw_ms": adamw_ms,
           "cross_entropy_ms": ce_ms, "loss_chunk": chunk,
           "nondeterministic_step_ms": [t * 1e3 for t in loose_times],
           "restarts": info["restarts"],
           "phase_s": time.perf_counter() - t_phase}
    emit(label, **out)
    del r, state, batch, loose
    return out


DRILL_ARGV = ["--smoke", "--steps", "30", "--batch", "8", "--seq", "64",
              "--lr", "3e-3", "--checkpoint-every", "5", "--log-every", "0",
              "--seed", "0"]
DRILL_FAILS = "7,13,18"


def phase_train_restart_drill():
    """The restart drill on the card: falcon-mamba's and granite's smoke
    configs, 30 steps with a checkpoint every 5, once clean and once with
    failures injected at steps 7, 13 and 18: 3 restarts, parameters and
    moments bit-equal to the clean run's, the mean loss of the last 5
    steps below that of the first 5; falcon's runs go through B7 and its
    backward kernel."""
    import tempfile
    import torch
    from repro_torch.launch import train
    t_phase = time.perf_counter()
    out = {}
    for arch in ("falcon_mamba_7b", "granite_3_2b"):
        runs = {}
        for fails in ("", DRILL_FAILS):
            losses = []
            _counts_zero()
            with tempfile.TemporaryDirectory() as d:
                argv = ["--arch", arch, *DRILL_ARGV, "--checkpoint-dir", d]
                if fails:
                    argv += ["--fail-at", fails]
                t0 = time.perf_counter()
                state, info = train.main(argv, on_metrics=lambda s, m:
                                         losses.append(float(m["loss"])))
                secs = time.perf_counter() - t0
            runs[fails] = (state, info, losses, _counts(), secs)
        (clean, cinfo, closs, ccount, csec), \
            (drill, dinfo, _, dcount, dsec) = runs[""], runs[DRILL_FAILS]
        check(cinfo["restarts"] == 0 and dinfo["restarts"] == 3,
              f"drill {arch}: restarts {cinfo['restarts']} and "
              f"{dinfo['restarts']}, expected 0 and 3")
        same = all(torch.equal(p, drill.params[k])
                   for k, p in clean.params.items()) and \
            all(torch.equal(clean.opt.mu[k], drill.opt.mu[k])
                and torch.equal(clean.opt.nu[k], drill.opt.nu[k])
                for k in clean.params)
        check(same, f"drill {arch}: the restarted run's state differs "
                    f"from the clean run's")
        first, last = statistics.mean(closs[:5]), statistics.mean(closs[-5:])
        check(last < first, f"drill {arch}: mean loss of the last 5 steps "
                            f"{last} not below the first 5's {first}")
        n_mamba = sum(b.kind.startswith("mamba")
                      for b in cinfo["model"].stack.blocks)
        check(ccount["selective_scan_bwd"] == 30 * n_mamba
              and ccount["selective_scan"] == 60 * n_mamba,
              f"drill {arch}: clean run launched {ccount}, expected "
              f"{60 * n_mamba} B7 and {30 * n_mamba} backward")
        out[arch] = {"restarts": dinfo["restarts"], "bit_equal": same,
                     "loss_first5": first, "loss_last5": last,
                     "clean_launches": ccount, "drill_launches": dcount,
                     "clean_s": csec, "drill_s": dsec}
        del runs, clean, drill
    emit("train_restart_drill", steps=30, checkpoint_every=5,
         fail_at=DRILL_FAILS, runs=out,
         phase_s=time.perf_counter() - t_phase)
    return out


#: the data-parallel phases run in a world of one over NCCL (the card's
#: machine has one card, and NCCL refuses two ranks on one device);
#: several ranks are held against the reference on the CPU
#: (tests/test_torch_train_dp*.py)
DP_BATCH, DP_SEQ = 4, 2048
DP_EQUAL_LAYERS, DP_EQUAL_STEPS = 2, 3
DP_AER_STEPS, DP_PSUM_STEPS = 8, 4
DP_AER_FRAC = 0.05            # launch.train's --aer-frac default
DP_AER_BUDGET = 128           # RunConfig.aer_budget


DP_GROUPS = {"aer_encode (B5)": ("aer_encode",),
             "aer_decode (B6)": ("aer_decode",),
             "sort (tau)": ("sort", "Sort", "radix"),
             "B7 forward": ("selective_scan_kernel",),
             "B7 backward": ("selective_scan_bwd",),
             "matmul": SERVE_GROUPS["matmul"],
             "copies and casts": SERVE_GROUPS["copies and casts"],
             "reductions": ("reduce", "Reduce"),
             "elementwise": ("elementwise", "vectorized", "unrolled"),
             "nccl": ("nccl",)}


@contextlib.contextmanager
def _world_of_one():
    """An NCCL process group of one rank (an in-process store)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dp_run(layers, mode, steps, dp=True):
    """falcon-mamba-7b at full width on ``layers`` layers, its state and
    its step: data-parallel (``make_host_mesh(data=1)``,
    ``make_rules(fsdp=False)``) unless ``dp`` is false; the launcher's
    run settings."""
    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.runtime import train_loop as tl
    cfg = get_config("falcon_mamba_7b").with_(n_layers=layers)
    run = RunConfig(dp_reduce=mode, learning_rate=1e-3,
                    warmup_steps=max(steps // 10, 1), total_steps=steps,
                    aer_frac=DP_AER_FRAC, aer_budget=DP_AER_BUDGET,
                    fsdp=False)
    model = build_model(cfg, seed=0, device=torch.device("cuda", 0))
    rules = make_rules(make_host_mesh(data=1), fsdp=False,
                       kv_heads=cfg.n_kv_heads,
                       d_head=cfg.d_head) if dp else None
    return (cfg, model, tl.init_state(model, run),
            tl.make_train_step(model, run, rules))


def _dp_batch(cfg, step: int) -> dict:
    import torch
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(cfg.vocab, DP_SEQ, DP_BATCH, seed=0)
    return {k: torch.from_numpy(v).to("cuda")
            for k, v in data.batch(step).items()}


def phase_train_dp_world1_equal():
    """The data-parallel step in a world of one: falcon-mamba-7b at full
    width on 2 layers, 4 x 2048 tokens, 3 steps under deterministic
    algorithms; ``psum``, ``ring`` and ``bidir_ring`` under the rules
    must give parameters, both moments and every metric bit-equal to
    the same steps with ``rules=None`` (a mean over one rank is
    exact)."""
    import torch
    from repro_torch.launch.serve import pin_precision
    t_phase = time.perf_counter()
    pin_precision()
    out, ref = {}, None
    with _world_of_one():
        for mode in (None, "psum", "ring", "bidir_ring"):
            cfg, model, state, step = _dp_run(
                DP_EQUAL_LAYERS, mode or "psum", DP_EQUAL_STEPS,
                dp=mode is not None)
            metrics, times, counts = [], [], []
            for s in range(DP_EQUAL_STEPS):
                batch = _dp_batch(cfg, s)
                torch.cuda.synchronize()
                _counts_zero()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                metrics.append({k: v.clone() for k, v in m.items()})
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                counts.append(_counts())
            snap = {"params": {k: p.detach().clone()
                               for k, p in state.params.items()},
                    "mu": {k: v.clone() for k, v in state.opt.mu.items()},
                    "nu": {k: v.clone() for k, v in state.opt.nu.items()},
                    "metrics": metrics}
            want = {"selective_scan": 2 * DP_EQUAL_LAYERS,
                    "selective_scan_bwd": DP_EQUAL_LAYERS}
            for i, c in enumerate(counts):
                check(all(c.get(k, 0) == want.get(k, 0) for k in c),
                      f"train_dp_world1_equal {mode}: step {i + 1} "
                      f"launched {c}, expected {want}")
            label = mode or "no_rules"
            row = {"step_ms": times, "loss": [float(m["loss"])
                                              for m in metrics]}
            if ref is None:
                ref = snap
            else:
                eq = {part: all(torch.equal(v, ref[part][k])
                                for k, v in snap[part].items())
                      for part in ("params", "mu", "nu")}
                eq["metrics"] = all(
                    torch.equal(a[k].cpu(), b[k].cpu())
                    for a, b in zip(snap["metrics"], ref["metrics"])
                    for k in a)
                row["bit_equal"] = eq
                check(all(eq.values()), f"train_dp_world1_equal: {mode} "
                      f"under rules differs from rules=None: {eq}")
            out[label] = row
            del model, state, step, snap
            _free()
    del ref
    _free()
    emit("train_dp_world1_equal", arch="falcon_mamba_7b",
         layers=DP_EQUAL_LAYERS, reduced={"n_layers": [64,
                                                      DP_EQUAL_LAYERS]},
         batch=DP_BATCH, seq=DP_SEQ, steps=DP_EQUAL_STEPS, world=1,
         backend="nccl", modes=out, phase_s=time.perf_counter() - t_phase)
    return out


def phase_train_dp_aer():
    """falcon-mamba-7b at full width on 16 layers, 4 x 2048 tokens,
    ``aer_topk`` (frac 0.05, budget 128) through the data-parallel step
    in a world of one, 8 steps; then ``psum``, 4 steps.  ms a step, the
    reduction's ms by CUDA events, wire words, peak memory, launches a
    step (B5 and B6 once a reference leaf, B7 32, its backward 16); the
    embedding leaf's step-1 reduction bit-equal to the plain encoder
    and decoder's."""
    import torch
    from repro_torch.core import sparse_collectives as sc
    from repro_torch.launch.serve import pin_precision
    from repro_torch.models.model import param_count
    from repro_torch.runtime import train_loop as tl
    t_phase = time.perf_counter()
    pin_precision()
    out, grab = {}, {}
    with _world_of_one():
        for mode, steps in (("aer_topk", DP_AER_STEPS),
                            ("psum", DP_PSUM_STEPS)):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cfg, model, state, step = _dp_run(FALCON_TRAIN_LAYERS, mode,
                                              steps)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            n_params = param_count(model)
            n_leaves = len(tl.ReferenceLeaves(model).members)
            emb_shape = tuple(model.embed.table.shape)
            events, at = [], [0]
            owner, name = ((tl.ReferenceLeaves, "aer_reduce")
                           if mode == "aer_topk" else
                           (sc, "reduce_gradients"))
            orig, orig_leaf = getattr(owner, name), sc.aer_allreduce

            def timed(*a, **k):
                e = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                e[0].record()
                r = orig(*a, **k)
                e[1].record()
                events.append(e)
                return r

            def leaf(x, st, group=None, **k):
                take = at[0] == 0 and tuple(x.shape) == emb_shape
                if take:
                    grab.update(g=x.clone(), res=st.residual.clone())
                r, new, w = orig_leaf(x, st, group, **k)
                if take:
                    grab.update(red=r.clone(), new=new.residual.clone())
                return r, new, w

            setattr(owner, name, timed)
            sc.aer_allreduce = leaf
            times, words, losses, counts = [], [], [], []
            try:
                for s in range(steps):
                    at[0] = s
                    batch = _dp_batch(cfg, s)
                    torch.cuda.synchronize()
                    _counts_zero()
                    t1 = time.perf_counter()
                    state, m = step(state, batch)
                    vals = {k: float(v) for k, v in m.items()}
                    times.append((time.perf_counter() - t1) * 1e3)
                    counts.append(_counts())
                    check(all(v == v and abs(v) != float("inf")
                              for v in vals.values()),
                          f"train dp {mode}: step {s + 1} metrics not "
                          f"finite: {vals}")
                    losses.append(vals["loss"])
                    words.append(int(vals["wire_words"]))
            finally:
                setattr(owner, name, orig)
                sc.aer_allreduce = orig_leaf
            torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            red_ms = [a.elapsed_time(b) for a, b in events]
            aer = mode == "aer_topk"
            prof = None
            if aer:            # one more step, profiled: time by group
                batch = _dp_batch(cfg, steps)
                prof = _profile_ticks(
                    "profile_train_falcon_mamba_7b_l16_aer",
                    lambda: step(state, batch), 1, groups=DP_GROUPS,
                    unit="step")
            want = {"selective_scan": 2 * FALCON_TRAIN_LAYERS,
                    "selective_scan_bwd": FALCON_TRAIN_LAYERS,
                    "aer_encode": n_leaves if aer else 0,
                    "aer_decode": n_leaves if aer else 0}
            for i, c in enumerate(counts):
                check(all(c.get(k, 0) == want.get(k, 0) for k in c),
                      f"train dp {mode}: step {i + 1} launched {c}, "
                      f"expected {want}")
            check(all(w > 0 for w in words) if aer else not any(words),
                  f"train dp {mode}: wire words {words}")
            tail = times[2:] if aer else times[1:]
            out[mode] = {
                "steps": steps, "init_s": init_s,
                "step_ms_all": times, "step_ms_median": statistics.median(
                    tail), "median_of": len(tail),
                "reduce_ms_all": red_ms,
                "reduce_ms_median": statistics.median(red_ms[len(red_ms)
                                                             - len(tail):]),
                "tokens_per_s": DP_BATCH * DP_SEQ / (
                    statistics.median(tail) / 1e3),
                "loss": losses, "wire_words": words,
                "launches_per_step": want,
                "max_memory_allocated_gb": peak_gb}
            if aer:
                out[mode].update(
                    reference_leaves=n_leaves,
                    wire_words_over_dense=statistics.mean(words) / n_params,
                    device_busy_share=prof["device_busy_share"],
                    us_by_group=prof.get("us_per_step_by_group"))
            del model, state, step
            _free()
        check(set(grab) == {"g", "res", "red", "new"},
              "the embedding leaf's step-1 reduction was not captured")
        red_eq, res_eq, ev, ev_mask = _leaf_vs_plain(
            grab["g"], grab["res"], grab["red"], grab["new"],
            frac=DP_AER_FRAC, budget=DP_AER_BUDGET)
    check(red_eq and res_eq and ev == ev_mask,
          f"train dp aer_topk: the embedding's step-1 reduced gradient "
          f"(equal {red_eq}) or residual (equal {res_eq}) differs from "
          f"the plain encoder and decoder's, or events {ev} != {ev_mask}")
    emb = list(grab["g"].shape)
    del grab
    _free()
    emit("train_falcon_mamba_7b_l16_aer", arch="falcon_mamba_7b",
         layers=FALCON_TRAIN_LAYERS,
         reduced={"n_layers": [64, FALCON_TRAIN_LAYERS]}, batch=DP_BATCH,
         seq=DP_SEQ, world=1, backend="nccl", frac=DP_AER_FRAC,
         budget=DP_AER_BUDGET, params=n_params, dense_words=n_params,
         embedding_leaf={"shape": emb, "reduced_equal_plain": red_eq,
                         "residual_equal_plain": res_eq, "events": ev},
         runs=out, phase_s=time.perf_counter() - t_phase)
    return out


# --- training past data parallelism (A.11d): a (2, 2) mesh on one card

#: the sharded training cells: (arch, dp_reduce), each 3 steps at full
#: width, depth cut to TP_LAYERS, 4 x 2048 tokens, float32 compute
TP_CELLS = (("falcon_mamba_7b", "psum"), ("falcon_mamba_7b", "aer_topk"),
            ("granite_3_2b", "psum"))
#: the same cells with sequence parallelism (``make_rules(...,
#: seq_parallel=True)``: the residual stream a rank's block of 1024 of
#: the 2048 positions), held against the same whole runs
TP_SP_CELLS = (("granite_3_2b", "psum"), ("falcon_mamba_7b", "psum"))
TP_LAYERS, TP_STEPS, TP_WORLD = 2, 3, 4
TP_LOSS_TOL = 1e-4
#: each step's gradient norm, relative to the whole run's: AdamW and the
#: clip ignore a constant scale on a leaf's gradient, the norm does not
TP_GNORM_RTOL = {"psum": 1e-4, "aer_topk": 1e-3}
#: the parameters after 3 steps, largest gap: a gradient near 0 whose
#: sign the sum order flips moves its parameter by up to 2 lr a step
#: under AdamW's first steps, and a threshold that flips under
#: ``aer_topk`` sends it or not (tests/_torch_dp.py::AER_PARAM_TOL);
#: ``psum`` read 7.1e-4 and 9.8e-4
TP_PARAM_TOL = {"psum": 2e-3, "aer_topk": 2 * 1e-3 * TP_STEPS}
#: the share of parameters more than 1e-4 off: ``psum`` read 4.3e-6
#: (falcon) and 6.2e-6 (granite), ``aer_topk`` 1.7e-4; a step that
#: updates nothing moves AdamW's every entry by about lr
TP_OVER_SHARE = {"psum": 1e-4, "aer_topk": 2e-3}
TP_NOTE = "4 ranks time-share one card; not a multi-card figure"
#: the training cells whose every rank runs one more step under the cost
#: counter, held to the dry-run's meta trace of rank 0 of the same cell
TP_COUNTED = ("granite_3_2b_psum", "granite_3_2b_psum_sp")


def _tp_run(mode, sp=False):
    """The training cells' ``RunConfig`` (FSDP on, sequence parallelism
    as ``sp``: the flags the dry-run builds its rules from)."""
    from repro_torch.configs.base import RunConfig
    return RunConfig(dp_reduce=mode, learning_rate=1e-3, warmup_steps=0,
                     total_steps=TP_STEPS, aer_frac=DP_AER_FRAC,
                     aer_budget=DP_AER_BUDGET, fsdp=True, seq_parallel=sp)


def _counted(model, kind, batch, run_cfg, **kw) -> tuple:
    """One step of ``kind`` under a fresh ``launch.cost.Counter``,
    through the dry-run's own ``trace_step`` (``kw``: its ``rules``,
    ``state``, ``cache``, ``seq_len``): ``({flops, bytes, collectives
    by kind}, what the step returned)``."""
    from repro_torch.launch import cost, dryrun
    c = cost.Counter()
    out = dryrun.trace_step(model, kind, batch, run_cfg, counter=c, **kw)
    res = c.result()
    return {"flops": res["flops"], "bytes": res["bytes_accessed"],
            "collectives": res["collectives"]}, out


def _meta_counted(arch, kind, seq, batch, run_cfg, layers) -> dict:
    """The dry-run's trace on ``meta`` of rank 0 of ``arch`` at full
    width on ``layers`` layers, float32 compute, over an abstract
    (2, 2) mesh, in ``_counted``'s keys, and its seconds."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.parallel.compat import Mesh
    t0 = time.perf_counter()
    res, _, _ = dryrun.trace_cell(
        arch, ShapeConfig(f"{kind}_tp", seq, batch, kind),
        Mesh({"data": 2, "model": 2}), run_cfg,
        {"n_layers": layers, "compute_dtype": torch.float32})
    return {"flops": res["flops"], "bytes": res["bytes_accessed"],
            "collectives": res["collectives"],
            "trace_s": time.perf_counter() - t0}


def _held_ranks(label, meta, ranks) -> None:
    """Every rank's counted step equal to the meta trace: flops, bytes,
    and each collective kind's count and bytes."""
    want = {k: meta[k] for k in ("flops", "bytes", "collectives")}
    for r, got in enumerate(ranks):
        check(got == want, f"{label}: rank {r} counted {got}, the dry-run's "
                           f"meta trace of rank 0 {want}")


def _tp_cfg(arch):
    import torch
    from repro_torch.configs.base import get_config
    return get_config(arch).with_(n_layers=TP_LAYERS,
                                  compute_dtype=torch.float32)


def _tp_train(arch, mode, rules, rows=None):
    """``arch`` at full width on TP_LAYERS layers, seed 0, on cuda:0: 3
    steps of ``make_train_step(..., rules)`` (``None``: one device) on
    ``_dp_batch``'s global batches (their first ``rows`` rows, if
    given).  Returns the model, its state, the losses, the gradient
    norms, ms a step, the launches of each step and its collectives by
    kind, and the lengths of the residual stream the blocks took
    (``_resid_lengths``); the peak memory stats restart once the state
    is made (the whole model drawn before it is cut to a rank's shards
    is not counted)."""
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.parallel.compat import CALLS
    from repro_torch.runtime import train_loop as tl
    cfg = _tp_cfg(arch)
    run = _tp_run(mode)
    model = build_model(cfg, seed=0, device=torch.device("cuda", 0))
    state = tl.init_state(model, run, rules)
    step = tl.make_train_step(model, run, rules)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, times, counts, calls = [], [], [], [], []
    with _resid_lengths() as lengths:
        for s in range(TP_STEPS):
            batch = _dp_batch(cfg, s)
            if rows is not None:
                batch = {k: v[:rows] for k, v in batch.items()}
            torch.cuda.synchronize()
            _counts_zero()
            CALLS.clear()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts.append(_counts())
            calls.append(dict(CALLS))
    return (model, state, losses, gnorms, times, counts, calls,
            sorted(lengths))


@contextlib.contextmanager
def _resid_lengths():
    """The lengths (dimension 1) of the residual stream every block's
    channel mix took while the ``with`` body ran: the whole sequence,
    or a rank's block of it under sequence parallelism."""
    from repro_torch.models import transformer as T
    seen, mix = set(), T._channel_mix

    def spy(blk, cfg, x, par=None):
        seen.add(int(x.shape[1]))
        return mix(blk, cfg, x, par)
    T._channel_mix = spy
    try:
        yield seen
    finally:
        T._channel_mix = mix


def _tp_cells() -> list:
    """``(arch, mode, sp, label)`` of every training cell on the mesh:
    TP_CELLS, then TP_SP_CELLS with sequence parallelism."""
    return [(a, m, False, f"{a}_{m}") for a, m in TP_CELLS] + \
        [(a, m, True, f"{a}_{m}_sp") for a, m in TP_SP_CELLS]


def _tp_gaps(pairs) -> tuple:
    """``(largest gap, entries more than 1e-4 off, entries)`` over the
    ``(got, want)`` tensor pairs."""
    gap, over, n = 0.0, 0, 0
    for got, want in pairs:
        d = (got - want.to(got.device)).abs()
        gap = max(gap, float(d.max()))
        over += int((d > 1e-4).sum())
        n += d.numel()
        del d
    return gap, over, n


def _tp_params_fail(mode, gap, over, n) -> list:
    """What keeps parameters ``gap`` / ``over`` of ``n`` off the whole
    run's from passing under ``mode`` (empty: they pass)."""
    out = []
    if gap > TP_PARAM_TOL[mode]:
        out.append(f"largest gap {gap} > {TP_PARAM_TOL[mode]}")
    if over > TP_OVER_SHARE[mode] * n:
        out.append(f"{over} of {n} entries more than 1e-4 off > share "
                   f"{TP_OVER_SHARE[mode]}")
    return out


def _tp_save_whole(path, model, losses, gnorms) -> None:
    import torch
    torch.save({"losses": losses, "gnorms": gnorms,
                "params": {k: p.detach().cpu()
                           for k, p in model.named_parameters()}}, path)


def _tp_controls(arch, whole_path) -> dict:
    """Two planted faults that the parameter check must fail, held
    against the world of one's ``psum`` run saved at ``whole_path``:
    ``no_update``, the initial parameters (a step that updates nothing),
    and ``reduction_skipped``, the world of one trained on data rank 0's
    rows alone (what a rank of the (2, 2) mesh that skipped the data
    reduction would step on).  Each one's gaps and what fails it under
    each mode's limits."""
    import torch
    from repro_torch.models.model import build_model
    want = torch.load(whole_path, mmap=True)["params"]
    model = build_model(_tp_cfg(arch), seed=0,
                        device=torch.device("cuda", 0))
    gaps = {"no_update": _tp_gaps((p.detach(), want[k])
                                  for k, p in model.named_parameters())}
    del model
    _free()
    model = _tp_train(arch, "psum", None, rows=DP_BATCH // 2)[0]
    gaps["reduction_skipped"] = _tp_gaps(
        (p.detach(), want[k]) for k, p in model.named_parameters())
    del model
    _free()
    out = {}
    for name, (gap, over, n) in gaps.items():
        fails = {mode: _tp_params_fail(mode, gap, over, n)
                 for mode in TP_PARAM_TOL}
        check(all(fails.values()),
              f"train_tp control {name}: the parameter check passed a "
              f"planted fault ({gap}, {over} of {n} off): {fails}")
        out[name] = {"param_gap": gap, "params_over_1e-4": over,
                     "params": n, "fails": fails}
    return out


def _tp_rank(rank, store, out_dir, kind="train"):
    """One of the 4 gloo ranks on cuda:0: the training cells
    (``_tp_train_cells``) or the serving cells (``_tp_serve_cells``) on
    the (2, 2) mesh, against the whole runs saved in ``out_dir``.
    Writes its JSON there."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.serve import pin_precision
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    pin_precision()
    dist.init_process_group("gloo", store=dist.FileStore(store, TP_WORLD),
                            rank=rank, world_size=TP_WORLD)
    out = {}
    try:
        cells = _tp_train_cells if kind == "train" else _tp_serve_cells
        cells(rank, out_dir, out)
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def _tp_spawn(tmp: str, kind: str) -> tuple:
    """``_tp_rank`` on ``TP_WORLD`` processes: ``(each rank's JSON,
    seconds)``."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.spawn(_tp_rank, args=(os.path.join(tmp, f"store_{kind}"), tmp, kind),
             nprocs=TP_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(TP_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, spawn_s


def _tp_train_cells(rank, out_dir, out):
    """Every TP_CELLS cell on the (2, 2) FSDP mesh, against the whole
    run saved in ``out_dir`` (the world of one, or for ``aer_topk`` the
    (2, 1) data-only mesh of ranks 0 and 1, run here first: the
    data-axis size changes ``aer_topk``'s result, the model axis and
    FSDP do not)."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.parallel.tensor_parallel import unshard_param
    from repro_torch.runtime import train_loop as tl
    for arch, mode, sp, label in _tp_cells():
        cfg = _tp_cfg(arch)
        whole_path = os.path.join(out_dir, f"{arch}_{mode}.pt")
        if mode == "aer_topk":
            mesh = make_host_mesh(data=2, model=1)
            if rank < mesh.size:
                model, _, losses, gnorms, *_ = _tp_train(
                    arch, mode, make_rules(mesh, fsdp=False,
                                           kv_heads=cfg.n_kv_heads,
                                           d_head=cfg.d_head))
                if rank == 0:
                    _tp_save_whole(whole_path, model, losses, gnorms)
                del model
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        mesh = make_host_mesh(data=2, model=2)
        rules = make_rules(mesh, fsdp=True, seq_parallel=sp,
                           kv_heads=cfg.n_kv_heads, d_head=cfg.d_head)
        model, state, losses, gnorms, times, counts, calls, resid = \
            _tp_train(arch, mode, rules)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = torch.load(whole_path, mmap=True)
        par = model.parallel
        gap, over, n = _tp_gaps(
            (unshard_param(p.detach(), par.splits[k].sharding,
                           par.splits[k].full), want["params"][k])
            for k, p in model.named_parameters())
        cell = {"losses": losses, "want_losses": want["losses"],
                "loss_gap": max(abs(a - b) for a, b in
                                zip(losses, want["losses"])),
                "gnorms": gnorms, "want_gnorms": want["gnorms"],
                "gnorm_rel_gap": max(abs(a - b) / b for a, b in
                                     zip(gnorms, want["gnorms"])),
                "param_gap": gap, "params_over_1e-4": over,
                "params": n, "step_ms": times, "launches": counts,
                "collectives": calls, "resid": resid,
                "peak_gb": peak_gb,
                "reference_leaves": len(tl.ReferenceLeaves(model)
                                        .members)}
        if hasattr(model.stack.blocks[0], "mamba"):
            cell["scan_channels"] = int(
                model.stack.blocks[0].mamba.D_skip.shape[0])
        if label in TP_COUNTED:       # one more step, counted
            cell["counted"] = _counted(
                model, "train", _dp_batch(cfg, TP_STEPS), _tp_run(mode, sp),
                rules=rules, state=state)[0]
        out[label] = cell
        del model, state, want
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()


def phase_train_tp_2x2_one_card():
    """Training past data parallelism on the card: 4 processes on
    cuda:0 over gloo (a FileStore in a temporary directory), a (2, 2)
    mesh with FSDP (``make_host_mesh(2, 2)``, ``make_rules(fsdp=True)``),
    3 steps of each ``TP_CELLS`` cell at full width on 2 layers, 4 x
    2048 tokens, float32 compute.  Each rank's losses within 1e-4 of the
    whole run's (the world of one under ``psum``, run here first and
    freed before the spawn; the (2, 1) data-only mesh under
    ``aer_topk``), its gradient norms within ``TP_GNORM_RTOL``, its
    gathered parameters within ``TP_PARAM_TOL`` with at most a share
    ``TP_OVER_SHARE`` more than 1e-4 off, a check that two planted
    faults must fail (``_tp_controls``); B7 4 and its backward 2 a step
    on each falcon rank, on 4096 of the 8192 channels; B5 and B6 one a
    reference leaf a step under ``aer_topk``; ms a step, peak memory
    and collectives a step a rank.  The ``TP_SP_CELLS`` run the same
    with sequence parallelism, held against the same whole runs under
    the same limits, each block's residual stream 1024 positions a
    rank, their ms, peak and collectives printed beside the plain
    cell's."""
    import shutil
    import tempfile
    from repro_torch.launch.serve import pin_precision
    t_phase = time.perf_counter()
    pin_precision()
    tmp = tempfile.mkdtemp(prefix="tp_one_card_")
    try:
        one = {}
        for arch, mode in TP_CELLS:
            if mode != "psum":
                continue
            model, _, losses, gnorms, times, *_ = _tp_train(arch, mode,
                                                            None)
            path = os.path.join(tmp, f"{arch}_{mode}.pt")
            _tp_save_whole(path, model, losses, gnorms)
            one[f"{arch}_{mode}"] = {"losses": losses, "step_ms": times}
            del model
            _free()
            if arch == TP_CELLS[0][0]:
                controls = _tp_controls(arch, path)
        ranks, spawn_s = _tp_spawn(tmp, "train")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cells = {}
    for arch, mode, sp, label in _tp_cells():
        per = [r[label] for r in ranks]
        falcon = arch.startswith("falcon")
        want = {"selective_scan": 2 * TP_LAYERS if falcon else 0,
                "selective_scan_bwd": TP_LAYERS if falcon else 0}
        if mode == "aer_topk":
            n = per[0]["reference_leaves"]
            want.update(aer_encode=n, aer_decode=n)
        for r, c in enumerate(per):
            check(c["loss_gap"] <= TP_LOSS_TOL,
                  f"train_tp {label}: rank {r} losses {c['losses']} vs "
                  f"{c['want_losses']}")
            check(c["gnorm_rel_gap"] <= TP_GNORM_RTOL[mode],
                  f"train_tp {label}: rank {r} gradient norms "
                  f"{c['gnorms']} vs {c['want_gnorms']}")
            fails = _tp_params_fail(mode, c["param_gap"],
                                    c["params_over_1e-4"], c["params"])
            check(not fails, f"train_tp {label}: rank {r} parameters off "
                             f"the whole run's: {fails}")
            for i, got in enumerate(c["launches"]):
                check(all(got.get(k, 0) == want.get(k, 0) for k in got),
                      f"train_tp {label}: rank {r} step {i + 1} launched "
                      f"{got}, expected {want}")
            if falcon:
                check(c["scan_channels"] == _tp_cfg(arch).mamba.expand *
                      _tp_cfg(arch).d_model // 2,
                      f"train_tp {label}: B7 ran on {c['scan_channels']} "
                      f"channels a rank")
            resid = [DP_SEQ // 2] if sp else [DP_SEQ]
            check(c["resid"] == resid,
                  f"train_tp {label}: rank {r}'s blocks took residual "
                  f"streams of {c['resid']} positions, expected {resid}")
        cells[label] = {
            "seq_parallel": sp,
            "residual_positions_per_rank": per[0]["resid"],
            "collectives_per_step_rank0": per[0]["collectives"][-1],
            "against": ("world of one" if mode == "psum"
                        else "(2, 1) data-only mesh, ranks 0-1"),
            "losses": per[0]["losses"], "want_losses": per[0]["want_losses"],
            "max_loss_gap": max(c["loss_gap"] for c in per),
            "max_gnorm_rel_gap": max(c["gnorm_rel_gap"] for c in per),
            "max_param_gap": max(c["param_gap"] for c in per),
            "params_over_1e-4": [c["params_over_1e-4"] for c in per],
            "params": per[0]["params"],
            "launches_per_rank_step": want,
            "scan_channels_per_rank": per[0].get("scan_channels"),
            "step_ms_by_rank": [c["step_ms"] for c in per],
            "step_ms_median": statistics.median(
                t for c in per for t in c["step_ms"][1:]),
            "peak_gb_by_rank": [c["peak_gb"] for c in per],
            "world_of_one_step_ms": one.get(f"{arch}_{mode}",
                                            {}).get("step_ms")}
        if sp:
            plain = cells[f"{arch}_{mode}"]
            cells[label]["beside_plain"] = {
                k: {"sp": cells[label][k], "plain": plain[k]} for k in
                ("step_ms_median", "peak_gb_by_rank",
                 "collectives_per_step_rank0")}
    for arch, mode, sp, label in _tp_cells():
        if label not in TP_COUNTED:
            continue
        meta = _meta_counted(arch, "train", DP_SEQ, DP_BATCH,
                             _tp_run(mode, sp), TP_LAYERS)
        per = [r[label]["counted"] for r in ranks]
        _held_ranks(f"train_tp {label} counted step", meta, per)
        cells[label]["counted_step"] = per[0]
        emit("train_tp_2x2_one_card", counted_cell=label,
             smi=nvidia_smi_line(), ranks_equal_meta=True, **per[0],
             meta_trace_s=meta["trace_s"])
    emit("train_tp_2x2_one_card", mesh={"data": 2, "model": 2}, fsdp=True,
         ranks=TP_WORLD, backend="gloo", device="cuda:0 (all ranks)",
         note=TP_NOTE, smi=nvidia_smi_line(), layers=TP_LAYERS,
         reduced={"n_layers": {"falcon_mamba_7b": [64, TP_LAYERS],
                               "granite_3_2b": [40, TP_LAYERS]}},
         batch=DP_BATCH, seq=DP_SEQ, steps=TP_STEPS,
         compute_dtype="float32", loss_tol=TP_LOSS_TOL,
         gnorm_rtol=TP_GNORM_RTOL, param_tol=TP_PARAM_TOL,
         over_share=TP_OVER_SHARE, controls=controls, cells=cells,
         spawn_s=spawn_s,
         phase_s=time.perf_counter() - t_phase)
    return cells


# --- serving a sharded model (A.11e): a (2, 2) mesh on one card

#: the sharded serving cells: (arch, published depth), each at full
#: width on SERVE_TP_LAYERS layers, float32 compute
SERVE_TP_CELLS = (("granite_34b", 88), ("falcon_mamba_7b", 64))
#: the cells also served with sequence parallelism (a prefill's residual
#: stream a rank's block of the prompt), against the same world of one
SERVE_TP_SP_CELLS = (("granite_34b", 88),)
SERVE_TP_LAYERS, SERVE_TP_BATCH, SERVE_TP_PROMPT, SERVE_TP_STEPS = \
    2, 4, 2048, 16
#: every rank's logits against the world of one's, relative to the
#: largest |logit| of the real vocabulary
SERVE_TP_TOL = 1e-4
#: the serving cells whose every rank runs one more prefill and decode
#: step under the cost counter, held to the dry-run's meta trace
SERVE_TP_COUNTED = ("granite_34b", "granite_34b_sp")


def _tp_serve_cfg(arch):
    import torch
    from repro_torch.configs.base import get_config
    return get_config(arch).with_(n_layers=SERVE_TP_LAYERS,
                                  compute_dtype=torch.float32)


def _tp_serve(arch, rules=None, forced=None, count=None) -> dict:
    """``arch`` at full width on SERVE_TP_LAYERS layers, seed 0, on
    cuda:0, cut by ``rules`` (``None``: whole): a warm-up prefill of the
    ``SyntheticLM`` prompts, a timed one, then SERVE_TP_STEPS decode
    steps fed ``forced`` (``None``: its own greedy tokens).  Returns the
    last position's logits of the prefill and of each step (float32 on
    the host), the tokens fed, prefill ms, ms a decode step, the kernel
    launches of the timed prefill, the collectives of the prefill and
    of each step, the lengths of the residual stream the prefill's
    blocks took, the peak memory after the model is cut, and the
    layer-0 cache's shapes.  With ``count`` (a ``RunConfig``), one more
    prefill of the prompt and a decode step from its cache run under the
    cost counter (``_counted``), their tallies under ``"counted"``."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.parallel.compat import CALLS
    from repro_torch.parallel.tensor_parallel import shard_model
    cfg = _tp_serve_cfg(arch)
    dev = torch.device("cuda", 0)
    model = build_model(cfg, seed=0, device=dev)
    if rules is not None:
        shard_model(model, rules)
    _free()
    torch.cuda.reset_peak_memory_stats()
    data = SyntheticLM(cfg.vocab, SERVE_TP_PROMPT, SERVE_TP_BATCH, seed=0)
    tokens = torch.from_numpy(data.batch(0)["tokens"]).to(dev)
    B, S = tokens.shape
    max_len = S + SERVE_TP_STEPS
    with torch.inference_mode():
        model.prefill({"tokens": tokens}, max_len=max_len)
        torch.cuda.synchronize()
        _counts_zero()
        CALLS.clear()
        t0 = time.perf_counter()
        with _resid_lengths() as resid:
            logits, cache = model.prefill({"tokens": tokens},
                                          max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = _counts()
        prefill_calls = dict(CALLS)
        out_logits, fed, step_ms, calls = [logits[:, -1].float().cpu()], \
            [], [], []
        for i in range(SERVE_TP_STEPS):
            tok = (logits[:, -1].argmax(-1)[:, None] if forced is None
                   else forced[i].to(dev))
            fed.append(tok.cpu())
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)  # torchlint: disable=TL002 (a fill, no copy)
            CALLS.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, tok, pos)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            calls.append(dict(CALLS))
            out_logits.append(logits[:, -1].float().cpu())
    counted = None
    if count is not None:
        pre, (_, c1) = _counted(model, "prefill", {"tokens": tokens}, count,
                                seq_len=S)
        step = {"tokens": torch.zeros((B, 1), dtype=torch.int32,
                                      device=dev),
                "pos": torch.full((B,), S, dtype=torch.int32, device=dev)}  # torchlint: disable=TL002 (a fill, no copy)
        dec, _ = _counted(model, "decode", step, count, cache=c1)
        counted = {"prefill": pre, "decode": dec}
        del c1
    res = {"logits": torch.stack(out_logits), "fed": torch.stack(fed),
           "prefill_ms": prefill_ms, "step_ms": step_ms,
           "launches": launches, "calls": calls,
           "prefill_calls": prefill_calls, "resid": sorted(resid),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "cache0": {k: list(t.shape) for k, t in cache[0].items()},
           "vocab": cfg.vocab, "counted": counted}
    if hasattr(model.stack.blocks[0], "mamba"):
        res["scan_channels"] = int(model.stack.blocks[0].mamba.D_skip
                                   .shape[0])
    del model, cache, logits
    _free()
    return res


def _tp_serve_gaps(got, want, vocab: int) -> dict:
    """``got``'s logits against ``want``'s (the world of one's) over the
    real vocabulary: the largest gap relative to want's largest |logit|,
    and the greedy tokens where want's top-2 margin allows a verdict
    (above twice the tolerance's absolute gap)."""
    g, w = got[..., :vocab], want[..., :vocab]
    scale = float(w.abs().max())
    top2 = w.topk(2, -1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * SERVE_TP_TOL * scale
    same = bool((g.argmax(-1)[sure] == w.argmax(-1)[sure]).all())
    return {"rel_gap": float((g - w).abs().max()) / scale,
            "max_abs_logit": scale, "tokens_compared": int(sure.sum()),
            "tokens_of": int(sure.numel()), "greedy_equal": same}


def _tp_serve_cells(rank, out_dir, out):
    """Every SERVE_TP_CELLS cell on the (2, 2) mesh without FSDP (the
    model axis splits the weights, the data axis the rows: two
    replicas), fed the world of one's greedy tokens saved in
    ``out_dir``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    for arch, sp, label in _tp_serve_labels():
        cfg = _tp_serve_cfg(arch)
        want = torch.load(os.path.join(out_dir, f"serve_{arch}.pt"))
        mesh = make_host_mesh(data=2, model=2)
        rules = make_rules(mesh, fsdp=False, seq_parallel=sp,
                           kv_heads=cfg.n_kv_heads, d_head=cfg.d_head)
        got = _tp_serve(arch, rules, forced=want["fed"],
                        count=_tp_serve_run(sp) if label in SERVE_TP_COUNTED
                        else None)
        cell = _tp_serve_gaps(got.pop("logits"), want["logits"],
                              cfg.vocab)
        got.pop("fed")
        cell.update(got, kv_cache=None if "k" not in got["cache0"] else
                    ("seq" if cfg.n_kv_heads % 2 else "heads"))
        out[label] = cell
        dist.barrier()


def _tp_serve_run(sp):
    """The serving cells' ``RunConfig``: no FSDP, sequence parallelism
    as ``sp`` (the flags the dry-run builds its rules from)."""
    from repro_torch.configs.base import RunConfig
    return RunConfig(fsdp=False, seq_parallel=sp)


def _tp_serve_labels() -> list:
    """``(arch, sp, label)`` of every serving cell on the mesh:
    SERVE_TP_CELLS, then SERVE_TP_SP_CELLS with sequence
    parallelism."""
    return [(a, False, a) for a, _ in SERVE_TP_CELLS] + \
        [(a, True, f"{a}_sp") for a, _ in SERVE_TP_SP_CELLS]


def phase_serve_tp_2x2_one_card():
    """Serving a sharded model on the card: 4 processes on cuda:0 over
    gloo, a (2, 2) mesh without FSDP, each SERVE_TP_CELLS cell at full
    width on 2 layers in float32 compute (TF32 off), a 4 x 2048 prompt,
    then 16 decode steps fed the world of one's greedy tokens (the
    world of one runs here first and is freed before the spawn).
    granite-34b has one kv head, so its cache splits over the sequence
    (1032 of 2064 slots a rank); falcon-mamba-7b's state over
    ``d_inner``.  Every rank's logits within SERVE_TP_TOL of the
    largest |logit| of the world of one's, its greedy tokens equal where
    the margin allows, 2 B7 launches a falcon prefill on 4096 of the
    8192 channels (none for granite); prefill ms, ms a decode step,
    peak memory and the collectives of a prefill and of a decode step a
    rank.  The ``SERVE_TP_SP_CELLS`` run the same with sequence
    parallelism (each prefill block's residual stream 1024 positions a
    rank, checked; a decode step runs the plain cell's collectives),
    against the same world of one, printed beside the plain cell."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.serve import pin_precision
    t_phase = time.perf_counter()
    pin_precision()
    tmp = tempfile.mkdtemp(prefix="serve_tp_one_card_")
    one = {}
    try:
        for arch, _ in SERVE_TP_CELLS:
            res = _tp_serve(arch)
            torch.save({"logits": res["logits"], "fed": res["fed"]},
                       os.path.join(tmp, f"serve_{arch}.pt"))
            one[arch] = {k: res[k] for k in ("prefill_ms", "step_ms",
                                             "launches", "peak_gb")}
        ranks, spawn_s = _tp_spawn(tmp, "serve")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cells = {}
    depths = dict(SERVE_TP_CELLS)
    for arch, sp, label in _tp_serve_labels():
        depth = depths[arch]
        per = [r[label] for r in ranks]
        falcon = arch.startswith("falcon")
        want = {"selective_scan": SERVE_TP_LAYERS if falcon else 0}
        check(one[arch]["launches"].get("selective_scan", 0) ==
              want["selective_scan"],
              f"serve_tp {arch}: the world of one's prefill launched "
              f"{one[arch]['launches']}")
        for r, c in enumerate(per):
            check(c["rel_gap"] <= SERVE_TP_TOL,
                  f"serve_tp {label}: rank {r} logits {c['rel_gap']} of "
                  f"max |logit| off the world of one's")
            check(c["greedy_equal"],
                  f"serve_tp {label}: rank {r} greedy tokens differ where "
                  f"the margin allows a verdict")
            got = c["launches"]
            check(all(got.get(k, 0) == want.get(k, 0) for k in got),
                  f"serve_tp {label}: rank {r} prefill launched {got}, "
                  f"expected {want}")
            if falcon:
                check(c["scan_channels"] == _tp_serve_cfg(arch).mamba
                      .expand * _tp_serve_cfg(arch).d_model // 2,
                      f"serve_tp {label}: B7 ran on {c['scan_channels']} "
                      f"channels a rank")
            steps = {json.dumps(x, sort_keys=True) for x in c["calls"]}
            check(len(steps) == 1, f"serve_tp {label}: rank {r} ran "
                                   f"different collectives a step: {steps}")
            resid = [-(-SERVE_TP_PROMPT // 2)] if sp else [SERVE_TP_PROMPT]
            check(c["resid"] == resid,
                  f"serve_tp {label}: rank {r}'s prefill blocks took "
                  f"residual streams of {c['resid']} positions, expected "
                  f"{resid}")
        cells[label] = {
            "seq_parallel": sp,
            "residual_positions_per_rank": per[0]["resid"],
            "collectives_per_prefill": per[0]["prefill_calls"],
            "reduced": {"n_layers": [depth, SERVE_TP_LAYERS]},
            "kv_cache": per[0]["kv_cache"], "cache0_shape_rank0":
                per[0]["cache0"],
            "max_rel_gap": max(c["rel_gap"] for c in per),
            "max_abs_logit": per[0]["max_abs_logit"],
            "tokens_compared": [c["tokens_compared"] for c in per],
            "tokens_of": per[0]["tokens_of"],
            "launches_per_rank_prefill": want,
            "scan_channels_per_rank": per[0].get("scan_channels"),
            "prefill_ms_by_rank": [c["prefill_ms"] for c in per],
            "decode_ms_per_step_by_rank": [
                statistics.median(c["step_ms"][1:]) for c in per],
            "collectives_per_decode_step": per[0]["calls"][0],
            "peak_gb_by_rank": [c["peak_gb"] for c in per],
            "world_of_one": {
                "prefill_ms": one[arch]["prefill_ms"],
                "decode_ms_per_step": statistics.median(
                    one[arch]["step_ms"][1:]),
                "peak_gb": one[arch]["peak_gb"]}}
        if sp:
            plain = cells[arch]
            check(per[0]["calls"][0] == plain["collectives_per_decode_step"],
                  f"serve_tp {label}: a decode step after the "
                  f"sequence-split prefill ran {per[0]['calls'][0]}, the "
                  f"plain one {plain['collectives_per_decode_step']}")
            cells[label]["beside_plain"] = {
                k: {"sp": cells[label][k], "plain": plain[k]} for k in
                ("prefill_ms_by_rank", "decode_ms_per_step_by_rank",
                 "peak_gb_by_rank", "collectives_per_prefill")}
    for arch, sp, label in _tp_serve_labels():
        if label not in SERVE_TP_COUNTED:
            continue
        line = {}
        for kind in ("prefill", "decode"):
            meta = _meta_counted(arch, kind, SERVE_TP_PROMPT, SERVE_TP_BATCH,
                                 _tp_serve_run(sp), SERVE_TP_LAYERS)
            per = [r[label]["counted"][kind] for r in ranks]
            _held_ranks(f"serve_tp {label} counted {kind}", meta, per)
            line[kind] = dict(per[0], meta_trace_s=meta["trace_s"])
        cells[label]["counted"] = line
        emit("serve_tp_2x2_one_card", counted_cell=label,
             smi=nvidia_smi_line(), ranks_equal_meta=True, **line)
    emit("serve_tp_2x2_one_card", mesh={"data": 2, "model": 2},
         fsdp=False, ranks=TP_WORLD, backend="gloo",
         device="cuda:0 (all ranks)", note=TP_NOTE, smi=nvidia_smi_line(),
         layers=SERVE_TP_LAYERS,
         reduced={"n_layers": {a: [d, SERVE_TP_LAYERS]
                               for a, d in SERVE_TP_CELLS}},
         batch=SERVE_TP_BATCH, prompt=SERVE_TP_PROMPT,
         steps=SERVE_TP_STEPS, compute_dtype="float32", tol=SERVE_TP_TOL,
         cells=cells, spawn_s=spawn_s,
         phase_s=time.perf_counter() - t_phase)
    return cells


# --- the pod-scale tools (A.11c): the counter against the card, the pod

#: the dry-run processes that run beside the card phases
POD_WORKERS = 4
POD_DIR = ROOT / "build" / "dryrun_torch"


class PodDryRun:
    """Every ``--all`` cell of the dry-run on the pod mesh, one
    ``python -m repro_torch.launch.dryrun --arch A --shape S --mesh pod``
    process a cell, ``POD_WORKERS`` at a time, longest cells first, with
    no card (``CUDA_VISIBLE_DEVICES`` empty) and one thread each.
    ``wait`` collects them; ``stop`` ends any still running."""

    def __init__(self, workers: int = POD_WORKERS):
        from concurrent.futures import ThreadPoolExecutor
        from repro_torch.configs.base import ARCH_IDS, get_config, shapes_for
        order = {"prefill": 0, "train": 1, "decode": 2}
        cells = [(a, s.name, order[s.kind], get_config(a).n_layers)
                 for a in ARCH_IDS for s in shapes_for(get_config(a))]
        self.cells = [(a, s) for a, s, k, n in
                      sorted(cells, key=lambda c: (c[2], -c[3]))]
        POD_DIR.mkdir(parents=True, exist_ok=True)
        self.env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
                    "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
        self.procs: list = []
        self.stopped = False
        #: when the last cell to end ended, in seconds since the start
        self.ended_at_s = 0.0
        self.t0 = time.perf_counter()
        self.pool = ThreadPoolExecutor(workers)
        self.futures = [self.pool.submit(self._one, a, sh)
                        for a, sh in self.cells]

    def _one(self, arch: str, shape: str):
        if self.stopped:
            return arch, shape, None, "stopped"
        log = POD_DIR / f"{arch}--{shape}--pod.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", "pod",
                 "--out-dir", str(POD_DIR)], cwd=ROOT, env=self.env,
                stdout=f, stderr=subprocess.STDOUT)
            self.procs.append(proc)
            rc = proc.wait()
        self.ended_at_s = max(self.ended_at_s, time.perf_counter() - T0)
        return arch, shape, time.perf_counter() - t0, rc

    def wait(self):
        out = [f.result() for f in self.futures]
        self.pool.shutdown()
        return out, time.perf_counter() - self.t0

    def stop(self):
        self.stopped = True
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self.pool.shutdown(wait=True, cancel_futures=True)


def _counted_step(model, kind, batch, run_cfg, *, state=None, cache=None,
                  seq_len=0):
    """One step of ``kind`` under a fresh counter (the dry-run's own
    calls), with the card's peak memory over it when on the card;
    returns ``(counter result, step output, max_memory_allocated or
    None)``."""
    import torch
    from repro_torch.launch import cost, dryrun
    on_card = model.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    c = cost.Counter()
    out = dryrun.trace_step(model, kind, batch, run_cfg, counter=c,
                            state=state, cache=cache, seq_len=seq_len)
    peak = None
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    return c.result(), out, peak


def _held(label, meta, card, kernels_want=None) -> dict:
    """The meta and card counts of one step: flops and bytes equal (the
    operator tallies named where they differ), the kernels' launches as
    ``kernels_want``."""
    diff = {k: (meta["op_counts"].get(k), card["op_counts"].get(k))
            for k in set(meta["op_counts"]) | set(card["op_counts"])
            if meta["op_counts"].get(k) != card["op_counts"].get(k)}
    check(meta["flops"] == card["flops"] and
          meta["bytes_accessed"] == card["bytes_accessed"] and not diff,
          f"{label}: meta counts {meta['flops']}, {meta['bytes_accessed']} "
          f"against the card's {card['flops']}, {card['bytes_accessed']}; "
          f"operators differing: {diff}")
    launches = {k: v["launches"] for k, v in card["kernels"].items()}
    check(launches == {k: v["launches"] for k, v in
                       meta["kernels"].items()},
          f"{label}: kernel records differ between meta and the card")
    if kernels_want is not None:
        check(launches == kernels_want, f"{label}: launches {launches}, "
                                        f"expected {kernels_want}")
    return launches


def _roofline(flops, nbytes, step_s) -> dict:
    from repro_torch.device import H100
    tc, tm = flops / H100["bf16_flops_s"], nbytes / H100["hbm_bytes_s"]
    return {"t_compute_ms": tc * 1e3, "t_memory_ms": tm * 1e3,
            "bound_by": "compute" if tc >= tm else "memory",
            "mfu_counted": flops / (step_s * H100["bf16_flops_s"]),
            "roofline_fraction": max(tc, tm) / step_s}


def phase_dryrun_vs_card(train_out: dict, serve_out: dict):
    """The counter on the card against the dry-run on ``meta``, for the
    training cells (phases 29, 30) and one prefill and one decode step
    of the falcon-mamba-7b serve cell (phase 17).  Step times come from
    those phases' uncounted runs: counting slows a step."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import dryrun, serve, train
    from repro_torch.models.model import build_model, param_count
    from repro_torch.parallel.compat import Mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.runtime import train_loop as tl
    t_phase = time.perf_counter()
    one = Mesh({"data": 1, "model": 1})
    rows = {}
    for label, argv, _, b7 in TRAIN_CELLS:
        r = train.setup(argv)
        cfg, run_cfg = r.cfg, r.run_cfg
        batch = r.data.batch(0)
        meta_model = build_model(cfg, device="meta")
        meta_state = tl.init_state(meta_model, run_cfg)
        meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                      for k, v in batch.items()}
        t0 = time.perf_counter()
        meta, _, _ = _counted_step(meta_model, "train", meta_batch,
                                   run_cfg, state=meta_state)
        trace_s = time.perf_counter() - t0
        rules = make_rules(one, fsdp=False, kv_heads=cfg.n_kv_heads,
                           d_head=cfg.d_head)
        args = sum(dryrun.device_bytes(t, s, one) for t, s in
                   dryrun.argument_specs(meta_model, rules, one, meta_batch,
                                         state=meta_state))
        _counts_zero()
        card, _, peak = _counted_step(r.model, "train", batch, run_cfg,
                                      state=r.state)
        want = {k: n for k, n in zip(("selective_scan",
                                      "selective_scan_bwd"), b7) if n}
        launches = _held(label, meta, card, want)
        wrappers = _counts()
        check(all(wrappers.get(k, 0) == n for k, n in want.items()),
              f"{label}: the wrappers counted {wrappers}, expected {want}")
        step_s = train_out[label]["step_ms_median"] / 1e3
        rows[label] = {
            "flops": card["flops"], "bytes_accessed": card["bytes_accessed"],
            "flops_6nd": 6 * param_count(r.model) * batch["labels"].numel(),
            "launches": launches, "meta_trace_s": trace_s,
            "argument_bytes": args,
            "predicted_peak_bytes": args + meta["peak_live_bytes"],
            "max_memory_allocated": peak,
            "step_ms_median": step_s * 1e3, "mfu": train_out[label]["mfu"],
            **_roofline(card["flops"], card["bytes_accessed"], step_s)}
        del r, batch, meta_model, meta_state
        _free()
    args_, cfg, model, batch = serve.setup(SERVE_ARGV)
    s, gen = batch["tokens"].shape[1], args_.gen
    meta_model = build_model(cfg, device="meta")
    run_cfg = RunConfig()
    for label, dev_model, dev_batch in (
            ("meta", meta_model, {k: torch.empty(v.shape, dtype=v.dtype,
                                                 device="meta")
                                  for k, v in batch.items()}),
            ("card", model, batch)):
        pre, (logits, cache), ppeak = _counted_step(
            dev_model, "prefill", dev_batch, run_cfg, seq_len=s + gen)
        tok = logits[:, -1].argmax(-1)[:, None]
        pos = torch.full((tok.shape[0],), s, dtype=torch.int32,
                         device=tok.device)
        dec, _, dpeak = _counted_step(dev_model, "decode",
                                      {"tokens": tok, "pos": pos}, run_cfg,
                                      cache=cache)
        rows.setdefault("serve_falcon_mamba_7b", {})[label] = (
            pre, dec, ppeak, dpeak)
        del logits, cache
    (mp, md, _, _), (cp, cd, ppeak, dpeak) = (
        rows["serve_falcon_mamba_7b"]["meta"],
        rows["serve_falcon_mamba_7b"]["card"])
    _held("serve_falcon_mamba_7b prefill", mp, cp,
          {"selective_scan": cfg.n_layers})
    _held("serve_falcon_mamba_7b decode", md, cd, {})
    rows["serve_falcon_mamba_7b"] = {
        f"{kind}_{k}": v for kind, res, peak, ms in (
            ("prefill", cp, ppeak, serve_out["prefill_again_ms"]),
            ("decode", cd, dpeak, serve_out["decode_ms_per_step"]))
        for k, v in {"flops": res["flops"],
                     "bytes_accessed": res["bytes_accessed"],
                     "peak_live_bytes": res["peak_live_bytes"],
                     "max_memory_allocated": peak, "ms": ms,
                     **_roofline(res["flops"], res["bytes_accessed"],
                                 ms / 1e3)}.items()}
    del model, batch, meta_model
    emit("dryrun_vs_card", cells=rows, equal=True,
         mfu_counted_formula="counted flops / (median step s x 989e12)",
         roofline_fraction_formula="max(flops / 989e12, bytes / 3.35e12) "
                                   "/ measured step s",
         phase_s=time.perf_counter() - t_phase)
    return rows


def phase_dryrun_pod(pod: PodDryRun):
    """Collect the pod dry-run started after the build: every cell's
    record, the roofline table, and whether each cell fits a card."""
    from repro_torch.device import H100
    from repro_torch.launch import roofline
    results, wall = pod.wait()
    failed = [(a, sh, rc) for a, sh, _, rc in results if rc != 0]
    check(not failed, f"dryrun_pod: cells failed: {failed} (logs in "
                      f"{POD_DIR.relative_to(ROOT)})")
    cells = roofline.load_cells("pod", dryrun_dir=str(POD_DIR))
    check(len(cells) == len(pod.cells),
          f"dryrun_pod: {len(cells)} records for {len(pod.cells)} cells")
    table = roofline.table(cells)
    print(table, flush=True)
    check("≥" not in table, "dryrun_pod: a collective term is a lower "
                            "bound")
    out = []
    for c in cells:
        mem = c["memory"]
        need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        out.append({"arch": c["arch"], "shape": c["shape"],
                    "flops": c["flops"], "bytes": c["bytes_accessed"],
                    "collective_bytes": c["collective_bytes_total"],
                    "collective_bytes_by_axis": {
                        a: v["bytes"] for a, v in
                        c["collectives_by_axis"].items()},
                    "t_collective_ms": c["t_collective_s"] * 1e3,
                    "argument_bytes": mem["argument_size_in_bytes"],
                    "temp_bytes": mem["temp_size_in_bytes"],
                    "fits_80GB": need <= H100["hbm_bytes"],
                    "dominant": c["dominant"],
                    "trace_s": c["lower_s"]})
    emit("dryrun_pod", mesh={"data": 16, "model": 16}, cells=out,
         wall_s=wall, workers=POD_WORKERS, ended_at_s=pod.ended_at_s,
         cell_s={f"{a}--{sh}": t for a, sh, t, _ in results},
         multipod="traced on a CPU host, not here (it doubles the phase)")
    return out


def _free() -> None:
    """Give a finished phase's model back to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures "
              "the port on the GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch under {ROOT}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matrix products must run in full float32 (no TF32)")
    t_start = time.perf_counter()

    name, smi = phase_device()
    torch.cuda.synchronize()
    phase_build()
    torch.cuda.synchronize()
    pod = PodDryRun()
    host_ref = HostReference()
    try:
        return _main_phases(name, smi, t_start, pod, host_ref)
    finally:
        host_ref.stop()
        pod.stop()


def _main_phases(name, smi, t_start, pod, host_ref) -> int:
    import torch
    ktimes = phase_kernels()
    torch.cuda.synchronize()
    ktimes["fabric_queue_multistep"] = phase_multistep_kernel()
    torch.cuda.synchronize()
    ktimes["lif_step"] = phase_lif_kernel()
    torch.cuda.synchronize()
    anchor = phase_anchor()
    torch.cuda.synchronize()
    spec, kw, bucket, launches, cells = phase_full(host_ref)
    torch.cuda.synchronize()
    ms_launches = phase_multistep_path([anchor] + cells)
    torch.cuda.synchronize()
    ring_out = phase_ring_engine([anchor] + cells)
    torch.cuda.synchronize()
    batch_rows = phase_batch(ring_out)
    torch.cuda.synchronize()
    batch_times = phase_batch_kernels()
    torch.cuda.synchronize()
    phase_verify_quarantine(cells)
    torch.cuda.synchronize()
    adaptive_rows = phase_adaptive_ring16()
    torch.cuda.synchronize()
    step_runs = phase_adaptive_ring8_step()
    torch.cuda.synchronize()
    phase_sweep(batch_rows)
    torch.cuda.synchronize()
    phase_profile(spec, kw)
    torch.cuda.synchronize()
    from repro_torch.core.fabric import EngineSpec
    ms_engine = EngineSpec("pallas", kernel="multistep")
    phase_profile(spec, kw, engine=ms_engine, steps=None,
                  label="profile_multistep")
    torch.cuda.synchronize()
    cosim_launches, closed_ms, open_ms, cosim_ticks = phase_cosim(host_ref)
    torch.cuda.synchronize()
    snn_launches, snn_ms = phase_snn_fig6()
    torch.cuda.synchronize()
    phase_profile_cosim()
    torch.cuda.synchronize()
    examples = phase_examples()
    torch.cuda.synchronize()
    ktimes.update(phase_aer_kernels())
    torch.cuda.synchronize()
    aer_launches, aer_ms = phase_aer_layer()
    torch.cuda.synchronize()
    phase_aer_compress_feedback()
    torch.cuda.synchronize()
    ktimes["selective_scan"] = phase_scan_kernel()
    torch.cuda.synchronize()
    model, batch, gen_tokens, serve_out = phase_serve()
    torch.cuda.synchronize()
    consistency = phase_serve_consistency(model, batch, gen_tokens)
    del model
    _free()
    # each cell's model is checked in float32 compute on its first rows
    # (an MoE's all-slot capacity holds (rows, E, S + 8, d_ff) float32
    # buffers), then freed before the next cell's
    lm_out = {}
    for (label, argv, reduced, scans, xgate, check_label, rows,
         keep) in LM_CELLS:
        model, batch, gen_tokens, lm_out[label] = phase_serve_lm(
            label, argv, reduced, scans=scans, xgate=xgate)
        torch.cuda.synchronize()
        if label in DISPATCH_VS_HOST:
            lm_out[label]["dispatch_vs_host"] = phase_moe_dispatch_vs_host(
                label, model, batch)
        phase_serve_consistency(model, {k: v[:rows] for k, v in
                                        batch.items()},
                                gen_tokens[:rows], label=check_label,
                                max_prompt=keep)
        del model, batch, gen_tokens
        _free()
    phase_score_hubert()
    _free()
    ktimes["selective_scan_bwd"] = phase_scan_bwd_kernel()
    _free()
    train_out = {}
    for label, argv, reduced, b7 in TRAIN_CELLS:
        train_out[label] = phase_train_lm(label, argv, reduced, b7)
        _free()
    drill = phase_train_restart_drill()
    _free()
    phase_train_dp_world1_equal()
    _free()
    dp = phase_train_dp_aer()
    _free()
    phase_dryrun_vs_card(train_out, serve_out)
    _free()
    tp = phase_train_tp_2x2_one_card()
    _free()
    serve_tp = phase_serve_tp_2x2_one_card()
    _free()
    host_ref.check({**{label: res for label, _, _, res in cells},
                    **cosim_ticks})
    # the card's work ends here; the pod dry-run may still be running
    emit("card_phases_done", card_s=time.perf_counter() - t_start)
    phase_dryrun_pod(pod)

    csrc = "src/repro_torch/kernels/csrc/"
    main = {"fabric_queue_step": (launches["fabric_queue_step"], bucket),
            "fabric_queue_update": (launches["fabric_queue_update"], bucket),
            "fabric_queue_multistep": (
                ms_launches["full_ring16_credit"]["fabric_queue_multistep"],
                bucket[:8] + ("multistep", 128)),
            "lif_step": (cosim_launches["lif_step"], ("cosim_closed",)),
            "aer_encode": (aer_launches["aer_encode"],
                           ("aer_granite3_2b_layer",)),
            "aer_decode": (aer_launches["aer_decode"],
                           ("aer_granite3_2b_layer",)),
            "selective_scan": (serve_out["launches"]["selective_scan"],
                               ("serve_falcon_mamba_7b",)),
            "selective_scan_bwd": (
                train_out[TRAIN_CELLS[0][0]]["launches"]["selective_scan_bwd"],
                (TRAIN_CELLS[0][0],))}
    source = {"fabric_queue_step": csrc + "fabric_queue.cu",
              "fabric_queue_update": csrc + "fabric_queue.cu",
              "fabric_queue_multistep": csrc + "fabric_queue_multistep.cu",
              "lif_step": csrc + "lif_step.cu",
              "aer_encode": csrc + "aer_encode.cu",
              "aer_decode": csrc + "aer_decode.cu",
              "selective_scan": csrc + "selective_scan.cu",
              "selective_scan_bwd": csrc + "selective_scan_bwd.cu"}
    replaces = {"fabric_queue_step":
                "src/repro/kernels/fabric_queue.py:109",
                "fabric_queue_update":
                "src/repro/kernels/fabric_queue.py:195",
                "fabric_queue_multistep":
                "src/repro/kernels/fabric_queue.py:238",
                "lif_step": "src/repro/kernels/lif_step.py:29",
                "aer_encode": "src/repro/kernels/aer_encode.py:67",
                "aer_decode": "src/repro/kernels/aer_decode.py:39",
                "selective_scan": "src/repro/kernels/selective_scan.py:51",
                # no TPU kernel: the reference differentiates its chunked
                # jnp scan; this kernel is B7's gradient
                "selective_scan_bwd": "src/repro/models/mamba.py:76"}
    kernels = []
    for kname, k in ktimes.items():
        n_launch, path_bucket = main[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source[kname],
            "replaces": replaces[kname], "launches": n_launch,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            "equal": k["max_abs_err"] == 0, "us": k["ms"] * 1e3,
            "main_path_bucket": list(path_bucket)})
    by_name = {k["name"]: k for k in kernels}
    # each per-step kernel's time a launch on a batch of eight ring-16
    # instances, and its launches in the B = 8 batch of the cell
    batch_path = {"fabric_queue_step": "step", "fabric_queue_update": "step",
                  "fabric_queue_multistep": "multistep"}
    for kname, path in batch_path.items():
        bt = batch_times[kname]
        by_name[kname].update(
            batch8_ms=bt["ms"], batch8_shape=bt["shape"],
            batch8_max_abs_err=bt["max_abs_err"],
            batch8_launches=batch_rows[path]["launches"][kname])
    for kname in ("fabric_queue_step", "fabric_queue_update"):
        by_name[kname]["launch_floor_ms"] = ktimes[kname]["launch_floor_ms"]
        by_name[kname]["copy_floor_ms"] = ktimes[kname]["copy_floor_ms"]
        # launches of one adaptive ring-8 run on the per-step engine
        by_name[kname]["adaptive_ring8_launches"] = \
            step_runs[-1]["launches"][kname]
    by_name["fabric_queue_update"]["batch8_copy_floor_ms"] = \
        batch_times["fabric_queue_update"]["copy_floor_ms"]
    by_name["fabric_queue_multistep"]["adaptive_ring16_launches"] = \
        adaptive_rows["multistep"]["launches"]["fabric_queue_multistep"]
    by_name["aer_decode"]["aer_layer_ms_per_step"] = aer_ms
    # the data-parallel falcon-mamba-7b cell (16 layers, aer_topk): one
    # B5 and one B6 launch a reference leaf a step
    for kname in ("aer_encode", "aer_decode"):
        by_name[kname].update(
            train_launches_per_step={
                "train_falcon_mamba_7b_l16_aer":
                    dp["aer_topk"]["launches_per_step"][kname]},
            train_reduce_ms_per_step=dp["aer_topk"]["reduce_ms_median"])
    # the (2, 2) FSDP mesh on one card: launches a rank a step
    for kname in ("aer_encode", "aer_decode"):
        by_name[kname]["train_tp_2x2_launches_per_rank_step"] = \
            tp["falcon_mamba_7b_aer_topk"]["launches_per_rank_step"][kname]
    for kname in ("selective_scan", "selective_scan_bwd"):
        by_name[kname]["train_tp_2x2_launches_per_rank_step"] = \
            tp["falcon_mamba_7b_psum"]["launches_per_rank_step"][kname]
        by_name[kname]["train_tp_2x2_channels_per_rank"] = \
            tp["falcon_mamba_7b_psum"]["scan_channels_per_rank"]
    # the (2, 2) serving mesh on one card: launches a rank a prefill
    by_name["selective_scan"].update(
        serve_tp_2x2_launches_per_rank_prefill=serve_tp["falcon_mamba_7b"][
            "launches_per_rank_prefill"]["selective_scan"],
        serve_tp_2x2_channels_per_rank=serve_tp["falcon_mamba_7b"][
            "scan_channels_per_rank"])
    # launches in the examples phase: B4 in the two co-simulations, B1
    # and B2 in each fabric script's engine="pallas" replay
    by_name["lif_step"]["examples_launches"] = {
        n: examples[n]["launches"]["lif_step"] for n in COSIM_EXAMPLES}
    for kname in ("fabric_queue_step", "fabric_queue_update"):
        by_name[kname]["examples_replay_launches"] = {
            n: r["replay_launches"][kname] for n, r in examples.items()
            if "replay_launches" in r}
    by_name["lif_step"].update(launches_snn_fig6=snn_launches,
                       at_32x128=ktimes["lif_step"]["at_32x128"],
                       at_65536x128=ktimes["lif_step"]["at_65536x128"],
                       add_floor_ms=ktimes["lif_step"]["add_floor_ms"],
                       cosim_closed_ms_per_tick=closed_ms,
                       cosim_open_ms_per_tick=open_ms,
                       snn_fig6_ms_per_tick=snn_ms)
    jamba = lm_out["serve_jamba_v01_52b_l8"]
    by_name["selective_scan"].update(
        max_rel_err=ktimes["selective_scan"]["max_rel_err"],
        serve_prefill_ms=serve_out["prefill_again_ms"],
        serve_decode_ms_per_step=serve_out["decode_ms_per_step"],
        serve_consistency_scaled_err=consistency,
        serve_jamba_launches=jamba["launches"]["selective_scan"],
        serve_jamba_prefill_ms=jamba["prefill_again_ms"],
        serve_jamba_decode_ms_per_step=jamba["decode_ms_per_step"],
        jamba_shape=ktimes["selective_scan"]["jamba_shape"],
        jamba_shape_ms=ktimes["selective_scan"]["jamba_ms"],
        jamba_shape_bound_ms=ktimes["selective_scan"]["jamba_bound_ms"],
        train_launches={label: o["launches"]["selective_scan"]
                        for label, o in train_out.items()},
        train_launches_per_step={
            **{label: o["b7_launches_per_step"]["forward"]
               for label, o in train_out.items()},
            "train_falcon_mamba_7b_l16_aer":
                dp["aer_topk"]["launches_per_step"]["selective_scan"]})
    falcon_train = train_out[TRAIN_CELLS[0][0]]
    by_name["selective_scan_bwd"].update(
        replaces_note="no TPU kernel: kernel work from a module (the "
                      "gradient of B7, which the reference gets by "
                      "differentiating its jnp scan)",
        max_scaled_err=ktimes["selective_scan_bwd"]["max_scaled_err"],
        launches_per_step=falcon_train["b7_launches_per_step"]["backward"],
        train_step_ms=falcon_train["step_ms_median"],
        aer_cell_launches_per_step=dp["aer_topk"]["launches_per_step"][
            "selective_scan_bwd"],
        aer_cell_step_ms=dp["aer_topk"]["step_ms_median"],
        drill_launches=drill["falcon_mamba_7b"]["clean_launches"][
            "selective_scan_bwd"])
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
